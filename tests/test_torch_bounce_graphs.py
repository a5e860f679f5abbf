"""The trace's bounces as CUDA graph replays (cge_tpu_torch/render/graphs.py).

On the card, with gradients off and no prims axis, a bounce replays a CUDA
graph captured once per signature; everywhere else it runs eagerly. Here,
on the CPU: the frame and the train step take the eager path and still
match the JAX package (the 9x8 dragon stand-in with two spheres, as in
test_torch_gradients.py; images under test_golden_images.py's rule,
gradients to rtol 2e-3 and atol 1e-4 x max |g|, as there); the predicate
that picks the graphs; the signature; the cache's warm-up, capture and
replay steps, its bound and its launch bookkeeping, with a stand-in for
the capture, and render_images over several seeds through that stand-in;
and the accel's padded stack, built once per context and not once per
sweep. The graphs themselves run only on the card (the `cuda` test below,
and chip_smoke.py's graphs-against-eager phase).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.camera import pixel_grid as jpixel_grid
from cge_tpu.diff import gradients as jgrad
from cge_tpu.ops import intersect as jint
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import cluster_sweep, intersect, rng, sweep
from cge_tpu_torch.render import graphs, lights, wavefront
from cge_tpu_torch.scene.scene import ParallelogramLight
from cge_tpu_torch.tools import op_diff
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
HEADLINE = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True)
# soft shadows from a 5x5 parallelogram light (bench_torch/cells.py's)
SOFT = dict(enable_shading=True, enable_soft_shadow=True,
            enable_normal_interp=True)
PAR_LIGHT = ((-1.2, 1.0, -1.2), (0.4, 0.0, 0.0), (0.0, 0.0, 0.4),
             (1.0, 0.2, 0.2), (0.2, 1.0, 0.2), (0.2, 0.2, 1.0),
             (1.0, 1.0, 0.2))
SIDE = 24
CHUNK = 256          # SIDE * SIDE rays in 3 chunks, the last padded


def _build(path):
    spheres = [
        SphereDef((0.0, 0.1, 0.0), 0.3,
                  Material(kd=np.float32([0.9, 0.3, 0.2]),
                           ks=np.float32([0.4, 0.4, 0.4]), shininess=12.0)),
        SphereDef((0.55, 0.45, -0.7), 0.2,
                  Material(kd=np.float32([0.2, 0.3, 0.9]))),
    ]
    js = build_scene_arrays(load_mesh(path), spheres, [JPointLight(*LIGHT)])
    ps = scene_from_numpy({k: np.asarray(getattr(js, k))
                           for k in TENSOR_FIELDS},
                          all_opaque=js.all_opaque,
                          all_diffuse=js.all_diffuse, device="cpu")
    return js, ps


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The 9x8 stand-in with two spheres (JAX, port), and the port's 41x32
    stand-in, whose 20 clusters 3 a visit do not divide."""
    tmp = tmp_path_factory.mktemp("graphs")
    tiny, small = str(tmp / "tiny.obj"), str(tmp / "small.obj")
    write_obj(tiny, 9, 8)
    write_obj(small, 41, 32)
    return {"tiny": _build(tiny),
            "small": ct.load_scene_from_file(
                small, [ct.PointLight(*LIGHT)], device="cpu"),
            "soft": ct.load_scene_from_file(
                small, [ParallelogramLight(*PAR_LIGHT)], device="cpu")}


@pytest.fixture
def no_graphs(monkeypatch):
    """Fails a test whose bounce goes to the graph cache."""
    def refuse(*args, **kw):
        raise AssertionError("a bounce went to the graph cache")

    monkeypatch.setattr(graphs, "bounce", refuse)


def _same(a, b) -> bool:
    """Equal bit for bit but where both are NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _compare(img, ref):
    ref_nan, img_nan = ~np.isfinite(ref), ~np.isfinite(img)
    assert (ref_nan == img_nan).mean() > 0.999
    both = ~ref_nan & ~img_nan
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    assert close.all(axis=-1).mean() >= 0.995


@pytest.mark.parametrize("accel", [False, True])
def test_cpu_frame_is_eager_and_matches_jax(scenes, no_graphs, monkeypatch,
                                            accel):
    """A frame on the CPU, under render_image's no_grad, never reaches the
    graph cache and matches JAX's render_image (its cluster path in
    interpret mode)."""
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
    js, ps = scenes["tiny"]
    feats = dict(HEADLINE, enable_accel_structure=accel)
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(), cge_tpu.Features(**feats),
        cge_tpu.RenderParams(trace_chunk=CHUNK), SIDE, SIDE))
    img = ct.render_image(ps, ct.Camera(), ct.Features(**feats),
                          ct.RenderParams(trace_chunk=CHUNK), SIDE, SIDE)
    assert np.nanmax(ref) > 0.05
    _compare(img.numpy(), ref)


def test_train_step_is_eager_and_matches_jax(scenes, no_graphs):
    """loss_and_grads, under autograd with leaves that need a gradient,
    never reaches the graph cache, and its loss and gradients match
    jax.value_and_grad of render_loss."""
    js, ps = scenes["tiny"]
    o, d = cge_tpu.Camera().generate_rays(jpixel_grid(12, 12).reshape(-1, 2))
    o, d = np.array(o), np.array(d)
    target = np.random.default_rng(5).uniform(
        0.0, 0.5, (o.shape[0], 3)).astype(np.float32)
    jv, jg = jax.value_and_grad(jgrad.render_loss)(
        jgrad.scene_params(js), js, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(target), features=cge_tpu.Features(**HEADLINE),
        render_params=cge_tpu.RenderParams(), key=jax.random.PRNGKey(0))
    pv, pg = ct.loss_and_grads(ps, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(target),
                               ct.Features(**HEADLINE), ct.RenderParams())
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-5)
    for k in ct.DIFF_FIELDS:
        want, got = np.asarray(jg[k]), pg[k].numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=k)


def test_graphs_apply_on_the_card_without_gradients():
    """The graphs take a bounce only on a CUDA tensor, with gradients off,
    no prims axis and outside _eager_bounces (nested too) and the op
    recorder of tools/op_diff.py, which sees no op of a replay."""
    card = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = torch.zeros(1, 3)
    p = ct.RenderParams()
    with torch.no_grad():
        assert graphs.applies(card, p)
        assert not graphs.applies(cpu, p)
        assert not graphs.applies(card, p.replace(prims_axis="prims"))
        with graphs._eager_bounces():
            with graphs._eager_bounces():
                assert not graphs.applies(card, p)
            assert not graphs.applies(card, p)
        assert graphs.applies(card, p)
        with op_diff.Recorder():
            assert not graphs.applies(card, p)
        assert graphs.applies(card, p)
    with torch.enable_grad():
        assert not graphs.applies(card, p)


def _keys(scene, ctx, o, d, feats, params, shared_origin, ray_ids):
    return (graphs.context_key(scene, ctx.accel, ctx.tables, ctx.tri_table),
            graphs.call_key(o, feats, params, shared_origin, ray_ids))


def test_signature_follows_what_the_bounce_reads(scenes):
    """The signature changes with a replaced scene, accel or table tensor,
    the scene's host flags, Features, RenderParams, N, shared_origin or the
    presence of ray ids; a value changed in place leaves it as it is. The
    level key is no part of it (a graph reads its draw keys as inputs)."""
    scene = dataclasses.replace(scenes["small"],
                                mat_kd=scenes["small"].mat_kd.clone())
    feats = ct.Features(**HEADLINE, enable_accel_structure=True)
    params = ct.RenderParams()
    ctx = ct.prepare_render(scene, feats, params)
    o, d = torch.zeros(64, 3), torch.ones(64, 3)
    base = (scene, ctx, o, d, feats, params, True, None)
    ref = _keys(*base)
    assert _keys(*base) == ref

    def with_(**kw):
        args = dict(zip(("scene", "ctx", "o", "d", "feats", "params",
                         "shared_origin", "ray_ids"), base))
        args.update(kw)
        return _keys(*args.values())

    scene.mat_kd.mul_(0.5)                  # in place: the same signature
    ctx.tables.add_(1.0)
    assert _keys(*base) == ref
    changed = [
        with_(scene=dataclasses.replace(scene,
                                        mat_kd=scene.mat_kd.clone())),
        with_(scene=dataclasses.replace(scene, all_diffuse=True)),
        with_(ctx=dataclasses.replace(ctx, tables=ctx.tables.clone())),
        with_(ctx=dataclasses.replace(ctx, accel=dataclasses.replace(
            ctx.accel, tiles=ctx.accel.tiles.clone()))),
        with_(ctx=dataclasses.replace(ctx, accel=None)),
        with_(feats=feats.replace(enable_hard_shadow=False)),
        with_(params=params.replace(sweep_br=256)),
        with_(o=torch.zeros(32, 3), d=torch.ones(32, 3)),
        with_(shared_origin=False),
        with_(ray_ids=torch.arange(64))]
    assert all(c != ref for c in changed)
    assert len({c for c in changed}) == len(changed)


def test_draw_keys_on_the_device_draw_the_host_keys_samples(scenes):
    """draw_keys derives the level's light keys on the host, in the order
    light_contribution draws; passed as 0-d tensors (a graph's static
    inputs) they give a bounce the radiance of the host key bit for bit,
    and another key gives another."""
    scene = scenes["soft"]
    feats = ct.Features(**SOFT)
    assert lights.draws_samples(scene, feats)
    assert not lights.draws_samples(scenes["small"], feats)
    assert not lights.draws_samples(scene, feats.replace(
        enable_soft_shadow=False))
    key = rng.fold_in(rng.prng_key(3), 1)
    keys = lights.draw_keys(scene, key)
    k = rng.fold_in(key, 2000)
    assert keys == (rng.fold_in(k, 0), rng.fold_in(k, 1))
    static = torch.empty((len(keys), 2), dtype=torch.int64)
    graphs._write_keys(static, keys)
    params = ct.RenderParams()
    ctx = ct.prepare_render(scene, feats, params)
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(16, 16, device="cpu").reshape(-1, 2))

    def local(k):
        return wavefront._bounce(
            scene, o, d, feats, params, torch.ones(o.shape[0], dtype=bool),
            ctx.accel, ctx.tri_table, True, ctx.tables, k, None)[1]

    want = local(key)
    got = local(lights.DrawKeys((row[0], row[1]) for row in static))
    assert want.abs().max() > 0 and _same(got, want)
    assert not _same(local(rng.fold_in(key, 5)), want)


def test_add_launches_applies_the_captured_amount():
    """counted records how far a run moved the counters and puts them
    back; add_launches adds that amount once a replay."""
    before = graphs.launch_counts()

    def run():
        cluster_sweep.LAUNCHES["keys"] += 2
        cluster_sweep.LAUNCHES["walk"] += 2
        sweep.LAUNCHES["sweep"] += 1
        return "out"

    out, moved = graphs.counted(run)
    assert out == "out" and graphs.launch_counts() == before
    assert moved == ({"keys": 2, "walk": 2}, {"sweep": 1}, {})
    for n in (1, 2, 3):
        graphs.add_launches(moved)
        now = graphs.launch_counts()
        assert now[0]["keys"] == before[0]["keys"] + 2 * n
        assert now[0]["walk_mxu"] == before[0]["walk_mxu"]
        assert now[1]["sweep"] == before[1]["sweep"] + n
    graphs.add_launches(moved, -3)
    assert graphs.launch_counts() == before


class _FakeGraph:
    """Stands in for a captured CUDA graph: a replay bumps a count."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_cache_warms_up_captures_and_replays(scenes, monkeypatch):
    """The first sight of a signature runs eagerly, the second captures
    and replays, later ones copy the rays and the draw keys into the static
    inputs and replay; each replay adds the captured launches; another key
    replays the same graph under its own draw keys; another context drops
    the graphs, and so does the death of a tensor they read."""
    scene = scenes["soft"]
    feats, params = ct.Features(**SOFT), ct.RenderParams()
    ctx = ct.prepare_render(scene, feats, params)
    calls, captured = [], []

    def eager(*args):
        calls.append(args[1])           # o
        return "eager"

    def record(cache, run):
        captured.append(_FakeGraph())
        return captured[-1], "replayed", ({"walk": 3}, {}, {})

    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(graphs, "_LOCAL", type(graphs._LOCAL)())
    before = cluster_sweep.LAUNCHES["walk"]

    def go(o, key=(0, 1), tables=ctx.tables):
        return graphs.bounce(eager, scene, o, o + 1, feats, params,
                             torch.ones(o.shape[0], dtype=torch.bool), None,
                             ctx.tri_table, False, tables, key, None)

    o = [torch.full((8, 3), float(i)) for i in range(4)]
    assert go(o[0]) == "eager" and len(calls) == 1 and not captured
    assert go(o[1]) == "replayed" and len(captured) == 1
    assert captured[0].replays == 1
    assert go(o[2]) == "replayed" and len(captured) == 1
    assert captured[0].replays == 2
    (entry,) = graphs._LOCAL.cache.graphs.values()
    assert torch.equal(entry.inputs[0], o[2])
    assert torch.equal(entry.inputs[1], o[2] + 1)
    assert entry.keys.tolist() == [list(k) for k in lights.draw_keys(
        scene, (0, 1))]
    assert cluster_sweep.LAUNCHES["walk"] == before + 6
    assert go(o[3], key=(0, 2)) == "replayed" and len(captured) == 1
    assert captured[0].replays == 3 and len(calls) == 1
    assert entry.keys.tolist() == [list(k) for k in lights.draw_keys(
        scene, (0, 2))]
    cache = graphs._LOCAL.cache
    tables = ctx.tables.clone()
    assert go(o[3], tables=tables) == "eager"
    assert graphs._LOCAL.cache is not cache and cache.graphs == {}
    assert graphs._LOCAL.cache.graphs == {} and len(calls) == 2
    assert go(o[0], tables=tables) == "replayed" and len(captured) == 2
    cache = graphs._LOCAL.cache
    del tables                  # a tensor the graphs read dies: they go
    assert cache.key is None and cache.graphs == {}
    cluster_sweep.LAUNCHES["walk"] = before


def test_cache_keeps_the_signatures_used_last(monkeypatch):
    """A context keeps at most MAX_ENTRIES signatures, graphs and first
    sights alike; a use makes a signature the most recent, and the least
    recent goes first."""
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 3)
    cache = graphs._Cache("ctx", ())
    assert cache.use("a") == (None, False)
    assert cache.use("a") == (None, True)
    cache.entries["a"] = "graph a"
    for sig in "bc":
        assert cache.use(sig) == (None, False)
    assert cache.use("a") == ("graph a", True)      # a is the most recent
    assert cache.use("d") == (None, False)
    assert list(cache.entries) == ["c", "a", "d"]
    assert cache.graphs == {"a": "graph a"}
    assert cache.use("b") == (None, False)          # b went: seen anew
    assert list(cache.entries) == ["a", "d", "b"]


def _copy_into(dst, src):
    """Write a bounce's outputs (tensors, tuples and dataclasses of them)
    into the tensors of an earlier one, in place."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_into(a, b)


class _StandInGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    bounce on the static inputs and writes its static outputs in place."""

    def __init__(self, run, outputs):
        self.run, self.outputs, self.replays = run, outputs, 0

    def replay(self):
        self.replays += 1
        _copy_into(self.outputs, self.run())


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The graph cache on the CPU: bounces with gradients off go through
    graphs.bounce, whose recording is a _StandInGraph over the static
    inputs and draw keys; returns the recordings."""
    captured = []

    def record(cache, run):
        outputs, moved = graphs.counted(run)
        captured.append(_StandInGraph(run, outputs))
        return captured[-1], outputs, moved

    monkeypatch.setattr(graphs, "applies", lambda o, params: (
        not torch.is_grad_enabled() and params.prims_axis is None
        and graphs._eager_depth() == 0))
    monkeypatch.setattr(graphs, "_record", record)
    monkeypatch.setattr(graphs, "_LOCAL", type(graphs._LOCAL)())
    return captured


@pytest.mark.parametrize("sampled", [False, True])
def test_render_images_over_seeds_keeps_the_cache_bounded(scenes, cpu_graphs,
                                                          monkeypatch,
                                                          sampled):
    """render_images renders camera i with seed + i through one context:
    the cameras after the first capture nothing and add no entry, with
    the headline (every level after the first on one signature) and with
    soft shadows (each camera's samples from new keys, written into the
    graph's draw keys). Every frame equals the eager one bit for bit."""
    scene = scenes["soft" if sampled else "small"]
    feats = ct.Features(**(SOFT if sampled else HEADLINE),
                        enable_accel_structure=True)
    params = ct.RenderParams(trace_chunk=CHUNK)
    ctx = ct.prepare_render(scene, feats, params)
    cams = [ct.Camera(rotation=(20.0, 20.0 + 10.0 * i, 0.0))
            for i in range(4)]
    with graphs._eager_bounces():
        want = ct.render_images(scene, cams, feats, params, SIDE, SIDE,
                                seed=3, ctx=ctx)
    assert not cpu_graphs and graphs._eager_depth() == 0
    sizes = []
    use = graphs._Cache.use

    def use_and_count(cache, sig):
        out = use(cache, sig)
        sizes.append(len(cache.entries))
        return out

    monkeypatch.setattr(graphs._Cache, "use", use_and_count)
    first = ct.render_images(scene, cams[:1], feats, params, SIDE, SIDE,
                             seed=3, ctx=ctx)
    n_first, entries = len(cpu_graphs), len(graphs._LOCAL.cache.entries)
    got = ct.render_images(scene, cams, feats, params, SIDE, SIDE, seed=3,
                           ctx=ctx)
    assert _same(first[0], want[0]) and _same(got, want)
    assert n_first >= 1 and all(g.replays >= 2 for g in cpu_graphs)
    assert graphs._LOCAL.cache.graphs
    if sampled:
        (entry,) = graphs._LOCAL.cache.graphs.values()
        assert entry.keys is not None
    assert len(cpu_graphs) == n_first
    assert len(graphs._LOCAL.cache.entries) == entries == max(sizes)


def test_padded_stack_is_built_once_per_context(scenes, monkeypatch):
    """With 3 clusters a visit over the 41x32 stand-in's 20, every sweep
    of a frame (3 chunks, closest and any-hit, each level) takes the
    accel's padded stack, built on the first sweep and never again; the
    frame equals one whose every sweep pads the stack itself, as before."""
    scene = scenes["small"]
    feats = ct.Features(**HEADLINE, enable_accel_structure=True)
    params = ct.RenderParams(trace_chunk=CHUNK, sweep_sc_n=3,
                             sweep_anyhit_sc_n=3)
    ctx = ct.prepare_render(scene, feats, params)
    assert ctx.accel.tiles.shape[0] % 3
    pads, sweeps = [], []
    pad, tris = cluster_sweep.pad_cluster_stack, cluster_sweep.cluster_tris

    def count_pad(*args):
        pads.append(args[2])
        return pad(*args)

    def count_sweep(*args, **kw):
        sweeps.append(args[4].shape[0])
        return tris(*args, **kw)

    monkeypatch.setattr(cluster_sweep, "pad_cluster_stack", count_pad)
    monkeypatch.setattr(cluster_sweep, "cluster_tris", count_sweep)
    img = ct.render_image(scene, ct.Camera(), feats, params, SIDE, SIDE,
                          ctx=ctx)
    img2 = ct.render_image(scene, ct.Camera(), feats, params, SIDE, SIDE,
                           ctx=ctx)
    assert pads == [1] and len(sweeps) > 6
    assert set(sweeps) == {ctx.accel.tiles.shape[0] + 1}
    assert _same(img, img2)
    monkeypatch.setattr(intersect, "padded_stack",
                        lambda accel, sc_n: (accel.aabbs, accel.tiles, sc_n))
    old = ct.render_image(scene, ct.Camera(), feats, params, SIDE, SIDE,
                          ctx=ct.prepare_render(scene, feats, params))
    assert len(pads) > 6 and _same(img, old)


@pytest.mark.cuda
def test_graph_frames_equal_eager_frames_on_the_card(tmp_path):
    """On the card: the headline frame of the 41x32 stand-in (accel on
    and off, 3 chunks) replayed from graphs equals the eager frame bit for
    bit, with the same launches a frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = str(tmp_path / "small.obj")
    write_obj(path, 41, 32)
    scene = ct.load_scene_from_file(path, [ct.PointLight(*LIGHT)],
                                    device="cuda")
    for accel in (False, True):
        feats = ct.Features(**HEADLINE, enable_accel_structure=accel)
        params = ct.RenderParams(trace_chunk=4096)
        ctx = ct.prepare_render(scene, feats, params)

        def frame():
            before = graphs.launch_counts()
            img = ct.render_image(scene, ct.Camera(), feats, params, 128,
                                  128, ctx=ctx)
            torch.cuda.synchronize()
            return img, graphs.launches_between(before,
                                                graphs.launch_counts())

        with graphs._eager_bounces():
            want, want_n = frame()
        for _ in range(3):              # warm-up, capture, replay
            got, got_n = frame()
            assert _same(got, want) and got_n == want_n
        assert graphs._LOCAL.cache.graphs
