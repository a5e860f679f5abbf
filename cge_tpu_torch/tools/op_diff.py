"""Where two runs of the same PyTorch code part: every aten op's outputs,
recorded in order in each run, compared bit for bit. A diagnostic of the
port (the JAX package has none): it finds the first op at which the card
and the CPU twins compute different bits, over all elements and for one
ray's row.

    with op_diff.Recorder(pause=[(sweep, "closest_tris")]) as rec:
        trace(scene, o, d, feats, params, key)
    first = op_diff.first_parting(rec_card.entries, rec_cpu.entries)

A Recorder is a TorchDispatchMode: each op's name and a CPU copy of its
tensor outputs become one entry, except ops whose outputs are not yet
written (`empty*`) or copy or alias their input (`clone`, `_to_copy`,
`detach`, ...): a copy that one device makes and the other does not (a
`.contiguous()` of another stride order) leaves the runs aligned. Each
(module, name) of `pause` is wrapped while the
recorder is active: its own ops are not recorded (a sweep's CPU twin and
its CUDA kernel run different ops) and its outputs become one entry named
`name`. A CUDA graph's replay dispatches no op, so while a recorder is
active every bounce of a trace runs eagerly (render.graphs).

chip_smoke.py phase 7 runs it on the small train step's forward trace.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from cge_tpu_torch.render import graphs


# op names (without leading underscores) that start so are not recorded
_SKIP = ("empty", "new_empty", "clone", "contiguous", "to_copy", "copy_",
         "detach", "alias", "lift_fresh")


def _tensors(out) -> list:
    return [t.detach().to("cpu", copy=True) for t in tree_flatten(out)[0]
            if isinstance(t, torch.Tensor)]


class Recorder(TorchDispatchMode):
    """Records (op name, [output tensors on the CPU]) for every op run
    while it is active."""

    def __init__(self, pause=()):
        super().__init__()
        self.entries: list[tuple[str, list]] = []
        self._pause = tuple(pause)
        self._paused = 0
        self._saved: list = []
        self._eager = contextlib.ExitStack()

    def __enter__(self):
        self._eager.enter_context(graphs._eager_bounces())
        for module, name in self._pause:
            fn = getattr(module, name)
            self._saved.append((module, name, fn))
            setattr(module, name, self._wrap(name, fn))
        return super().__enter__()

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        self._saved = []
        self._eager.close()
        return super().__exit__(*exc)

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            outer = not self._paused
            self._paused += 1
            try:
                out = fn(*args, **kwargs)
                if outer:
                    self.entries.append((name, _tensors(out)))
            finally:
                self._paused -= 1
            return out
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not self._paused and not name.lstrip("_").startswith(_SKIP):
            self.entries.append((name, _tensors(out)))
        return out


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: the bits differ (any NaN equals any NaN)."""
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        same = (a.view(bits) == b.view(bits)) | (a.isnan() & b.isnan())
        return ~same
    return a != b


def entry_differs(ea, eb, row: int | None = None, rows: int | None = None):
    """(number of differing elements, first (a, b) values) of two entries'
    outputs; row / rows: only outputs whose leading dimension is `rows`,
    at `row`. None where nothing differs."""
    n, first = 0, None
    for a, b in zip(ea[1], eb[1]):
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1, (tuple(a.shape), tuple(b.shape))
        if row is not None:
            if a.dim() == 0 or a.shape[0] != rows:
                continue
            a, b = a[row], b[row]
        diff = bits_differ(a, b)
        k = int(diff.sum())
        if k and first is None:
            idx = tuple(int(i) for i in diff.nonzero()[0]) if a.dim() else ()
            first = (a[idx].item(), b[idx].item())
        n += k
    return (n, first) if n else None


def partings(a, b, row: int | None = None, rows: int | None = None):
    """The entries at which the runs a and b part, in order: (index, op
    name, differing elements, first (a, b) values). Op names that differ
    end the comparison as a parting with -1 elements, as does the end of
    the shorter run. row / rows as in entry_differs."""
    for i, (ea, eb) in enumerate(zip(a, b)):
        if ea[0] != eb[0]:
            yield i, f"{ea[0]} / {eb[0]}", -1, None
            return
        d = entry_differs(ea, eb, row, rows)
        if d is not None:
            yield i, ea[0], d[0], d[1]
    if len(a) != len(b):
        yield min(len(a), len(b)), "end of one run", -1, None


def first_parting(a, b, row: int | None = None, rows: int | None = None):
    """The first of partings(a, b, row, rows), None if the runs agree
    everywhere they were compared."""
    return next(partings(a, b, row, rows), None)


def named(entries, name: str) -> list:
    """The entries of one name, in order, with their indices."""
    return [(i, e) for i, e in enumerate(entries) if e[0] == name]
