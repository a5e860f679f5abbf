"""CUDA graphs of the trace's bounces.

A bounce (render.wavefront's closest-hit sweep, hit attributes and light
contribution with its shadow sweeps) is some 450-560 small torch ops and
kernels, and on the card the host's dispatch of them one at a time, not
the device, sets a frame's time (PERF.md section 5). So on the card, with
gradients off and no prims axis (`applies`), a bounce runs as the replay
of a CUDA graph:

  - its signature is all the eager code branches on: the ray count,
    shared_origin, the Features and RenderParams, whether ray ids are
    given, the scene's host fields, and the (address, shape, stride, dtype)
    of every tensor the bounce reads (the scene's, the accel's, the
    attribute rows and the brute-force table). A value changed in place is
    read by the next replay, as eager code reads it; a new tensor gives a
    new signature. The level's key is not in it: a bounce that draws light
    samples (render.lights.draws_samples) draws them from keys that are
    inputs of its graph (render.lights.draw_keys, written on the device
    before each replay), so the levels and frames of every key share one
    graph;
  - the first sight of a signature runs eagerly (the warm-up: the kernel
    library's build, the kernels' attributes, the sort's scratch); the
    second captures the bounce into a graph and replays it; every later one
    copies the rays (o, d, alive, ray ids) and the draw keys into the
    graph's static inputs and replays it;
  - the cache keeps the graphs of one context, the scene, accel and tables
    of the most recent bounce, and drops them and their memory pool when a
    bounce over another context comes or when one of those objects dies
    (so no address of a signature is reused while its graph lives). The
    graphs of a context share one pool. Within a context it keeps the
    MAX_ENTRIES signatures used last (a graph, or the mark of a first
    sight) and drops the least recently used beyond that;
  - the launch counters (ops.cluster_sweep, ops.sweep, ops.stream_probe
    LAUNCHES) advance by what the captured bounce launched at each replay,
    and not at the capture, which runs nothing.

A replay writes the same output tensors each time, and the graphs of a
context share their pool, so a later capture may place its outputs in
memory another graph uses for its intermediates: a caller consumes a
bounce's outputs (with eager ops, queued on the same stream) before the
next bounce, or clones what it keeps (render.wavefront.trace_glossy). The
state is per thread: each thread has its own cache.

The CPU path, the autograd path and the prims-sharded sweeps run eagerly,
and so does every bounce inside `_eager_bounces()` (for checks that hold
the graphs to the eager path, and for code that swaps the trace's
functions to spy on them). A failed capture or replay raises; nothing
falls back to the eager path.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import NamedTuple

import torch

from cge_tpu_torch.ops import cluster_sweep, stream_probe, sweep
from cge_tpu_torch.render.lights import DrawKeys, draw_keys, draws_samples

# the launch counters a bounce can advance
COUNTERS = (cluster_sweep.LAUNCHES, sweep.LAUNCHES, stream_probe.LAUNCHES)
# the signatures a context keeps, each a graph or the mark of a first
# sight: above the most a frame of the repo's cells and phases uses (6,
# the TRANS+REC tree's at 512x512); a frame using more runs eagerly
MAX_ENTRIES = 32


class _Graph(NamedTuple):
    """One captured bounce."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple       # static o, d, alive and ray ids (None if not given)
    keys: object        # static [M, 2] int64 draw keys (None: no draws)
    outputs: object     # what the bounce returned: static tensors
    launches: tuple     # how far each of COUNTERS moved in the bounce


class _Cache:
    """The graphs of one context, and the signatures seen once, in the
    order of their last use: `entries` maps a signature to its _Graph, or
    to None after its first sight. They go when one of the context's
    objects (refs) dies, or at drop()."""

    def __init__(self, key, refs):
        self.key = key
        self.pool = None
        self.entries = collections.OrderedDict()
        self._finalizers = [weakref.finalize(r, self.drop)
                            for r in refs if r is not None]

    @property
    def graphs(self) -> dict:
        """The captured entries."""
        return {s: g for s, g in self.entries.items() if g is not None}

    def use(self, sig):
        """(entry, seen): sig's entry, now the most recent, and whether sig
        was seen before; a first sight is marked with None, and the least
        recent entries beyond MAX_ENTRIES go."""
        if sig in self.entries:
            self.entries.move_to_end(sig)
            return self.entries[sig], True
        self.entries[sig] = None
        while len(self.entries) > MAX_ENTRIES:
            self.entries.popitem(last=False)
        return None, False

    def drop(self) -> None:
        for f in self._finalizers:
            f.detach()
        self._finalizers = []
        self.key = None             # matches no context
        self.entries, self.pool = collections.OrderedDict(), None


_LOCAL = threading.local()


def _eager_depth() -> int:
    return getattr(_LOCAL, "eager", 0)


@contextlib.contextmanager
def _eager_bounces():
    """While open, every bounce on this thread runs eagerly."""
    _LOCAL.eager = _eager_depth() + 1
    try:
        yield
    finally:
        _LOCAL.eager -= 1


def applies(o, params) -> bool:
    """Whether a bounce over rays o runs as a graph replay: on the card,
    gradients off, no prims axis, outside _eager_bounces."""
    return (o.device.type == "cuda" and not torch.is_grad_enabled()
            and params.prims_axis is None and _eager_depth() == 0)


def _tensor_key(t):
    if t is None:
        return None
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def context_key(scene, accel, tables, tri_table) -> tuple:
    """The context part of a bounce's signature: the scene's tensors by
    _tensor_key and its host fields by value, the accel's tensors and
    layout, the attribute rows and the brute-force table."""
    parts = tuple(_tensor_key(v) if isinstance(v, torch.Tensor) else v
                  for v in (getattr(scene, f.name)
                            for f in dataclasses.fields(scene)))
    acc = None if accel is None else (
        accel.layout, _tensor_key(accel.perm), _tensor_key(accel.aabbs),
        _tensor_key(accel.tiles))
    return parts, acc, _tensor_key(tables), _tensor_key(tri_table)


def call_key(o, features, params, shared_origin, ray_ids) -> tuple:
    """The call part of a bounce's signature."""
    return (o.shape[0], bool(shared_origin), features, params,
            ray_ids is not None)


def launch_counts() -> tuple:
    """A copy of every counter of COUNTERS."""
    return tuple(dict(c) for c in COUNTERS)


def launches_between(before, after) -> tuple:
    """How far each counter moved from `before` to `after` (launch_counts
    snapshots): per counter, the names that moved."""
    return tuple({k: n - b[k] for k, n in a.items() if n != b[k]}
                 for b, a in zip(before, after))


def add_launches(moved, times: int = 1) -> None:
    """Advance the counters by `moved` (launches_between's form), `times`
    over: a replay adds what its capture launched once."""
    for counts, m in zip(COUNTERS, moved):
        for k, n in m.items():
            counts[k] += times * n


def counted(run):
    """(run(), how far run moved the counters), the counters put back: a
    capture records the launches of the bounce it captures, which runs
    nothing until a replay adds them (add_launches)."""
    before = launch_counts()
    out = run()
    moved = launches_between(before, launch_counts())
    add_launches(moved, -1)
    return out, moved


def _cache_for(key, refs) -> _Cache:
    cache = getattr(_LOCAL, "cache", None)
    if cache is None or cache.key != key:
        if cache is not None:
            cache.drop()            # the old graphs go before new ones
        cache = _LOCAL.cache = _Cache(key, refs)
    return cache


def _write_keys(static, keys) -> None:
    """Write host draw keys into their static [M, 2] tensor, a fill a word
    queued on the stream (a copy from pageable host memory may wait for
    the stream; one from a reused pinned buffer may race the host)."""
    for row, key in zip(static, keys):
        for word, v in zip(row, key):
            word.fill_(v)


def _record(cache, run):
    """(graph, outputs, moved): run() captured into a CUDA graph in the
    context's pool, and how far it moved the counters."""
    if cache.pool is None:
        cache.pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=cache.pool,
                          capture_error_mode="thread_local"):
        outputs, moved = counted(run)
    return graph, outputs, moved


def _capture(cache, fn, scene, o, d, features, params, alive, accel,
             tri_table, shared_origin, tables, key, keys,
             ray_ids) -> _Graph:
    """The bounce captured over static copies of its rays and, where it
    draws samples (keys: draw_keys' host keys), a static [M, 2] tensor of
    draw keys, passed to it for the level's key."""
    inputs = (o.clone(), d.clone(), alive.clone(),
              None if ray_ids is None else ray_ids.clone())
    static_keys = None
    if keys is not None:
        static_keys = torch.empty((len(keys), 2), dtype=torch.int64,
                                  device=o.device)
        key = DrawKeys((row[0], row[1]) for row in static_keys)
    graph, outputs, moved = _record(cache, lambda: fn(
        scene, inputs[0], inputs[1], features, params, inputs[2], accel,
        tri_table, shared_origin, tables, key, inputs[3]))
    return _Graph(graph, inputs, static_keys, outputs, moved)


def bounce(fn, scene, o, d, features, params, alive, accel, tri_table,
           shared_origin, tables, key, ray_ids):
    """fn(scene, o, d, ..., ray_ids), the eager bounce, through the cache:
    eagerly on the first sight of its signature, as a graph replay after
    that. Call it only where applies(o, params) holds."""
    cache = _cache_for(context_key(scene, accel, tables, tri_table),
                       (scene, accel, tables, tri_table))
    sig = call_key(o, features, params, shared_origin, ray_ids)
    entry, seen = cache.use(sig)
    if not seen:
        return fn(scene, o, d, features, params, alive, accel, tri_table,
                  shared_origin, tables, key, ray_ids)
    keys = draw_keys(scene, key) if draws_samples(scene, features) else None
    if entry is None:
        entry = cache.entries[sig] = _capture(
            cache, fn, scene, o, d, features, params, alive, accel,
            tri_table, shared_origin, tables, key, keys, ray_ids)
    for static, x in zip(entry.inputs, (o, d, alive, ray_ids)):
        if static is not None:
            static.copy_(x)
    if keys is not None:
        _write_keys(entry.keys, keys)
    entry.graph.replay()
    add_launches(entry.launches)
    return entry.outputs
