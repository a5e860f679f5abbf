"""The cluster sweep's opt-in modes and tuning knobs in the port against the
JAX package: K2's refine_members and mxu walk modes, the frustum key pass
(exact_keys=False), the coherence ray order (sort_rays) through the hit
queries and the render, and the tuning tools of cge_tpu_torch.tools.

The JAX side runs pallas_cluster_tris in interpret mode (which drops mxu,
cluster_sweep.py:558, so the mxu twin is held against the default kernel
there); the port runs its kernels' plain twins on the CPU. The scene is the
41x32 dragon stand-in (2,560 triangles, 20 clusters), built once by JAX and
carried across; rays are made with numpy from fixed seeds. The CUDA kernels
are held against the same twins by the `cuda`-marked cases, which skip
without a card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.camera import Camera as JCamera
from cge_tpu.camera import pixel_grid as jpixel_grid
from cge_tpu.ops import intersect as jint
from cge_tpu.ops.pallas.cluster_sweep import (_block_frustum_keys,
                                              pack_cluster_tiles,
                                              pallas_cluster_tris)
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops import intersect
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

BR = 128
SEED = 4321
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
HEADLINE = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True,
                enable_accel_structure=True)
ALL_KNOBS = dict(sweep_exact_keys=False, sweep_anyhit_exact_keys=False,
                 sweep_sort_bounce=True, sweep_sort_shadow=True)


@pytest.fixture(scope="module")
def dragon_obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("modes") / "dragon_small.obj")
    write_obj(path, 41, 32)
    return path


@pytest.fixture(scope="module")
def dragon(dragon_obj):
    return cge_tpu.load_scene_from_file(dragon_obj, [JPointLight(*LIGHT)])


@pytest.fixture(scope="module")
def port_dragon(dragon):
    leaves = {k: np.asarray(getattr(dragon, k)) for k in TENSOR_FIELDS}
    return scene_from_numpy(leaves, all_opaque=dragon.all_opaque,
                            all_diffuse=dragon.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def stacks(dragon):
    """JAX-packed stacks in both layouts, as numpy."""
    out = {}
    for layout, hbm in (("triangle", False), ("field", True)):
        a, t = pack_cluster_tiles(dragon.vertices, dragon.tris,
                                  dragon.cluster_perm, hbm=hbm)
        out[layout] = (np.asarray(a), np.asarray(t))
    return out


@pytest.fixture(scope="module")
def batches(dragon):
    """Tile-swizzled primary rays (shared origin; 32x16 tiles, so a block
    of 128 rays is a compact frustum) and, from their hits, a bounce-like
    batch (scattered directions, a third dead, a third with a finite
    budget) and reversed shadow rays toward the light."""
    grid = np.asarray(jpixel_grid(64, 64)).reshape(64 // 16, 16, 64 // 32,
                                                   32, 2)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(-1, 2)
    o, d = JCamera().generate_rays(jnp.asarray(grid))
    o, d = np.asarray(o), np.asarray(d)
    n = o.shape[0]
    aabbs, tiles = pack_cluster_tiles(dragon.vertices, dragon.tris,
                                      dragon.cluster_perm, hbm=False)
    t, _ = pallas_cluster_tris(jnp.asarray(o), jnp.asarray(d),
                               jnp.full(n, jnp.inf), aabbs, tiles,
                               dragon.cluster_perm, br=BR, interpret=True)
    t = np.asarray(t)
    hit = np.isfinite(t)
    p = o + np.where(hit, t - 1e-3, 0.0)[:, None] * d
    rng = np.random.default_rng(SEED)
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    third = np.arange(n) % 3
    budget = np.where(third == 0, -1.0,
                      np.where(third == 1, rng.uniform(0.05, 1.5, n), np.inf))
    light = np.broadcast_to(np.float32(LIGHT[0]), (n, 3))
    return {
        "primary": (o, d, np.full(n, np.inf, np.float32)),
        "bounce": (p.astype(np.float32), sd, budget.astype(np.float32)),
        "shadow": (np.ascontiguousarray(light),
                   (p - light).astype(np.float32),
                   np.where(hit, 1.0, -1.0).astype(np.float32)),
    }


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x)).to(dtype)


def _jax_sweep(dragon, batch, stack, sc_n, any_hit, **kw):
    o, d, tmax = (jnp.asarray(x) for x in batch)
    aabbs, tiles = (jnp.asarray(x) for x in stack)
    ref = pallas_cluster_tris(o, d, tmax, aabbs, tiles, dragon.cluster_perm,
                              br=BR, sc_n=sc_n, any_hit=any_hit,
                              interpret=True, with_stats=True, perm_ids=True,
                              **kw)
    return [np.asarray(x) for x in ref]


def _port_blocks(batch, stack, layout, sc_n, any_hit, **kw):
    o, d, tmax = (_t(x) for x in batch)
    aabbs, tiles = (_t(x) for x in stack)
    return cs.sweep_blocks(o, d, tmax, aabbs, tiles, layout, br=BR,
                           sc_n=sc_n, any_hit=any_hit, **kw)


def _flat(blocks, n):
    return [x.reshape(-1)[:n].numpy() for x in blocks[:2]]


# (batch, layout, clusters per visit, any-hit)
REFINE = {
    "triangle_sc1_primary": ("primary", "triangle", 1, False),
    "triangle_sc2_bounce": ("bounce", "triangle", 2, False),
    "field_sc2_primary": ("primary", "field", 2, False),
    "field_sc1_bounce": ("bounce", "field", 1, False),
    "field_sc2_shadow": ("shadow", "field", 2, True),
    "triangle_sc1_shadow": ("shadow", "triangle", 1, True),
}


@pytest.mark.parametrize("case", list(REFINE))
def test_refine_twin_matches_pallas(dragon, batches, stacks, case):
    """The refine twin against pallas_cluster_tris(refine_members=True,
    interpret=True): the same hits, perm-space ids and visit counts, t to
    rtol 1e-5 / atol 2e-6 (XLA contracts the tile's dot products into
    FMAs). Against the port's own walk without refine: t, ids and visits
    bit-equal, and never more dense tiles than visits x sc_n."""
    which, layout, sc_n, any_hit = REFINE[case]
    batch, stack = batches[which], stacks[layout]
    n = batch[0].shape[0]
    got = _port_blocks(batch, stack, layout, sc_n, any_hit,
                       refine_members=True)
    base = _port_blocks(batch, stack, layout, sc_n, any_hit)
    ref = _jax_sweep(dragon, batch, stack, sc_n, any_hit,
                     refine_members=True)
    t, ids = _flat(got, n)
    if any_hit:
        np.testing.assert_array_equal(ids > 0, ref[0])
    else:
        h = np.isfinite(ref[0])
        np.testing.assert_array_equal(np.isfinite(t), h)
        np.testing.assert_allclose(t[h], ref[0][h], rtol=1e-5, atol=2e-6)
        np.testing.assert_array_equal(ids, ref[1])
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    for x, y in zip(got[:3], base[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (got[3] <= got[2] * sc_n).all()
    assert torch.equal(base[3], base[2] * sc_n)


def test_refine_skips_tiles_and_a_dead_lane_never_skips(dragon, stacks):
    """128x128 tile-swizzled primary rays at 2 clusters per visit: blocks
    whose every ray has already hit skip members entered only behind those
    hits. The test keeps two such blocks and a copy of the first with one
    lane killed (tmax = -1: entry = best = +inf, and inf <= inf holds),
    which runs every member tile, as the JAX kernel does. On that batch
    the port's refine walk and JAX's agree on hits, ids and visits (t to
    rtol 1e-5 / atol 2e-6, XLA's FMAs)."""
    grid = np.asarray(jpixel_grid(128, 128)).reshape(8, 16, 4, 32, 2)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(-1, 2)
    o, d = (np.asarray(x) for x in JCamera().generate_rays(jnp.asarray(grid)))
    tmax = np.full(o.shape[0], np.inf, np.float32)
    stack = stacks["field"]
    scan = _port_blocks((o, d, tmax), stack, "field", 2, False,
                        refine_members=True)
    skipping = np.nonzero(scan[3].numpy() < 2 * scan[2].numpy())[0]
    assert skipping.size >= 2
    rows = np.concatenate([np.arange(b * BR, (b + 1) * BR)
                           for b in (skipping[0], skipping[1], skipping[0])])
    o, d, tmax = o[rows], d[rows], tmax[rows].copy()
    tmax[2 * BR + 5] = -1.0
    got = _port_blocks((o, d, tmax), stack, "field", 2, False,
                       refine_members=True)
    visits, dense = got[2].numpy(), got[3].numpy()
    assert dense[0] < 2 * visits[0] and dense[1] < 2 * visits[1]
    assert dense[2] == 2 * visits[2]
    ref = _jax_sweep(dragon, (o, d, tmax), stack, 2, False,
                     refine_members=True)
    t, ids = _flat(got, o.shape[0])
    h = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(t), h)
    np.testing.assert_allclose(t[h], ref[0][h], rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(ids, ref[1])
    np.testing.assert_array_equal(visits, ref[2])


MXU = {"primary": ("primary", False, True), "bounce": ("bounce", False, False),
       "shadow": ("shadow", True, False)}


@pytest.mark.parametrize("which", list(MXU))
def test_mxu_twin_matches_pallas_default(dragon, batches, stacks, which):
    """The mxu twin (triangle layout; a torch.matmul contraction in the
    two-dot form) against the default interpret-mode kernel, to which JAX
    drops mxu off the TPU: hit masks equal on >= 99.99% of rays, ids equal
    on >= 99.99% of rays that hit on both sides, and where the ids agree
    |dt| <= 1e-5 max(1, t). The two forms round differently, so a ray
    that grazes an edge may land on either side. shared_origin is asked
    for on the primary batch and, as in JAX, ignored."""
    key, any_hit, shared = MXU[which]
    batch, stack = batches[key], stacks["triangle"]
    n = batch[0].shape[0]
    got = _port_blocks(batch, stack, "triangle", 1, any_hit, mxu=True,
                       shared_origin=shared)
    ref = _jax_sweep(dragon, batch, stack, 1, any_hit, mxu=True,
                     shared_origin=shared)
    t, ids = _flat(got, n)
    if any_hit:
        assert ((ids > 0) == ref[0]).mean() >= 0.9999
        assert ref[0].any()
        return
    h, hr = np.isfinite(t), np.isfinite(ref[0])
    assert (h == hr).mean() >= 0.9999
    both = h & hr
    assert both.sum() > 100
    same = both & (ids == ref[1])
    assert same.sum() >= 0.9999 * both.sum()
    assert (np.abs(t[same] - ref[0][same])
            <= 1e-5 * np.maximum(1.0, ref[0][same])).all()


def test_mxu_repack_matches_jnp(stacks):
    """mxu_tiles against the JAX package's expression
    (cluster_sweep.py:641-643), bit for bit."""
    tiles = stacks["triangle"][1]
    Lp, C, _ = tiles.shape
    want = jnp.pad(jnp.asarray(tiles).reshape(Lp, C, 4, 4)
                   .transpose(0, 2, 1, 3).reshape(Lp, 4 * C, 4),
                   ((0, 0), (0, 0), (0, 4)))
    np.testing.assert_array_equal(cs.mxu_tiles(_t(tiles)).numpy(),
                                  np.asarray(want))


def test_mxu_on_field_layout_is_the_default(batches, stacks):
    """mxu acts on the triangle layout only (cluster_sweep.py:558): on the
    field layout the walk is the default one, bit for bit, and a refine
    request there is honoured."""
    assert cs.walk_mode("field", mxu=True) == "default"
    assert cs.walk_mode("field", refine_members=True, mxu=True) == "refine"
    assert cs.walk_mode("triangle", refine_members=True, mxu=True) == "mxu"
    batch, stack = batches["bounce"], stacks["field"]
    got = _port_blocks(batch, stack, "field", 4, False, mxu=True)
    base = _port_blocks(batch, stack, "field", 4, False)
    for x, y in zip(got, base):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _frustum_inputs(batches, stacks):
    """Packed ray blocks of the three batches plus a synthetic set: blocks
    whose direction hulls span 0 on an axis, a block with exactly zero
    direction components, a dead block; and boxes that include inverted
    ones (an empty cluster's +inf/-inf, a pad's FLT_MAX/-FLT_MAX)."""
    aabbs = _t(stacks["field"][0])
    boxes = cs.supercluster_boxes(cs.pad_cluster_stack(
        aabbs, _t(stacks["field"][1]), 4, "field")[0], 2)
    empty = torch.tensor([[np.inf] * 3 + [-np.inf] * 3 + [0, 0]],
                         dtype=torch.float32)
    boxes = torch.cat([boxes, empty]).contiguous()
    out = []
    for key in ("primary", "bounce", "shadow"):
        o, d, tmax = (_t(x) for x in batches[key])
        out.append(cs.sweep_setup(o, d, tmax, aabbs, _t(stacks["field"][1]),
                                  "field", BR, 2).rays)
    rng = np.random.default_rng(SEED + 1)
    n = 4 * BR
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[BR:2 * BR, 1] = 0.0                    # exact zeros on one axis
    d[2 * BR:3 * BR] = np.abs(d[2 * BR:3 * BR])   # one octant
    d[2 * BR:3 * BR, 2] = 0.0
    tmax = np.where(rng.uniform(size=n) < 0.2, -1.0, np.inf).astype(
        np.float32)
    tmax[3 * BR:] = -1.0                     # a dead block
    out.append(cs.sweep_setup(_t(o), _t(d), _t(tmax), aabbs,
                              _t(stacks["field"][1]), "field", BR, 2).rays)
    return torch.cat(out).contiguous(), boxes


def test_block_frustum_keys_match_jax(batches, stacks):
    """block_frustum_keys against _block_frustum_keys on the same packed
    rays and boxes: equal keys, +inf in the same places, over directions
    spanning 0, zero components, dead blocks and inverted boxes. The keys
    bound K1's exact keys from below up to rounding: a frustum key divides
    by d where K1 multiplies by 1/d, so both packages' frustum keys can
    sit an ulp above the exact key (a few per thousand here)."""
    rays, boxes = _frustum_inputs(batches, stacks)
    got = cs.block_frustum_keys(rays, boxes).numpy()
    ref = np.asarray(_block_frustum_keys(jnp.asarray(rays.numpy()),
                                         jnp.asarray(boxes.numpy())))
    np.testing.assert_array_equal(got, ref)
    exact = cs.block_entry_keys_plain(rays, boxes).numpy()
    assert (got <= np.nextafter(np.nextafter(exact, np.inf), np.inf)).all()
    assert np.isinf(got[:, -1]).all() and np.isinf(got[-1]).all()
    assert (got == 0).any() and np.isfinite(got).any()


def test_equal_keys_sort_like_lax_sort(batches, stacks):
    """The visit order of the frustum keys, many tied at 0 and at +inf:
    torch's stable sort gives lax.sort((keys, iota), num_keys=1)'s order,
    with no difference among equal keys."""
    rays, boxes = _frustum_inputs(batches, stacks)
    keys = cs.block_frustum_keys(rays, boxes)
    skeys, order = cs.sweep_order(rays, boxes, exact_keys=False)
    iota = jnp.broadcast_to(jnp.arange(keys.shape[1], dtype=jnp.int32)[None],
                            keys.shape)
    jk, jo = jax.lax.sort((jnp.asarray(keys.numpy()), iota), num_keys=1,
                          dimension=-1)
    k = keys.numpy()
    ties = sum(len(row) - len(np.unique(row)) for row in k)
    assert ties > keys.shape[0]
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(skeys.numpy(), np.asarray(jk))


# (batch, layout, clusters per visit, any-hit, shared origin)
FRUSTUM = {
    "primary_shared": ("primary", "triangle", 1, False, True),
    "bounce_field_sc4": ("bounce", "field", 4, False, False),
    "shadow_any_hit": ("shadow", "triangle", 1, True, False),
}


@pytest.mark.parametrize("case", list(FRUSTUM))
def test_frustum_walk_matches_pallas(dragon, batches, stacks, case):
    """The sweep ordered by the frustum keys against
    pallas_cluster_tris(exact_keys=False, interpret=True): the same hits,
    ids and visit counts; t to rtol 1e-5 / atol 2e-6 (XLA's FMAs)."""
    which, layout, sc_n, any_hit, shared = FRUSTUM[case]
    batch, stack = batches[which], stacks[layout]
    n = batch[0].shape[0]
    got = _port_blocks(batch, stack, layout, sc_n, any_hit, exact_keys=False,
                       shared_origin=shared)
    ref = _jax_sweep(dragon, batch, stack, sc_n, any_hit, exact_keys=False,
                     shared_origin=shared)
    t, ids = _flat(got, n)
    if any_hit:
        np.testing.assert_array_equal(ids > 0, ref[0])
    else:
        h = np.isfinite(ref[0])
        np.testing.assert_array_equal(np.isfinite(t), h)
        np.testing.assert_allclose(t[h], ref[0][h], rtol=1e-5, atol=2e-6)
        np.testing.assert_array_equal(ids, ref[1])
    np.testing.assert_array_equal(got[2].numpy(), ref[2])


def test_coherent_sweep_order_matches_jax(batches):
    """(order, inv) equal to the JAX package's counting permutation, with
    dead rays, exact-zero direction components and all octants."""
    o, d, tmax = batches["bounce"]
    d = d.copy()
    d[::7, 0] = 0.0
    d[::11, 2] = -0.0
    order, inv = intersect.coherent_sweep_order(_t(o), _t(d), _t(tmax))
    jo, ji = jint.coherent_sweep_order(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(tmax))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))
    assert torch.equal(order[inv], torch.arange(o.shape[0]))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)


@pytest.mark.parametrize("exact_keys", [True, False])
def test_sorted_hit_queries_match_jax(dragon, port_dragon, batches,
                                      exact_keys, interpret):
    """closest_hit(sort_rays=True) on the bounce batch and
    any_hit_occlusion(sort_rays=True) on the reversed shadow rays against
    the JAX package's (its cluster path in interpret mode): the same hits
    and perm-space ids, t to rtol 1e-5 / atol 2e-6; the same blocked set."""
    jacc = jint.build_accel(dragon)
    pacc = intersect.build_accel(port_dragon)
    o, d, tmax = batches["bounce"]
    got = intersect.closest_hit(port_dragon, _t(o), _t(d), _t(tmax), pacc,
                                exact_keys=exact_keys, sort_rays=True)
    ref = jint.closest_hit(dragon, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tmax), accel=jacc, perm_ids=True,
                           exact_keys=exact_keys, sort_rays=True)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    h = got.hit.numpy()
    assert h.any()
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h],
                               rtol=1e-5, atol=2e-6)
    lo, ld, ltm = batches["shadow"]
    p = lo + ld                                   # the forward segment
    fwd = (p, lo - p)
    blocked = intersect.any_hit_occlusion(
        port_dragon, _t(fwd[0]), _t(fwd[1]), _t(ltm), pacc,
        tri_rays=(_t(lo), _t(ld)), exact_keys=exact_keys, sort_rays=True)
    jref = jint.any_hit_occlusion(
        dragon, jnp.asarray(fwd[0]), jnp.asarray(fwd[1]), jnp.asarray(ltm),
        accel=jacc, tri_rays=(jnp.asarray(lo), jnp.asarray(ld)),
        exact_keys=exact_keys, sort_rays=True)
    np.testing.assert_array_equal(blocked.numpy(), np.asarray(jref))
    assert blocked.any() and not blocked[ltm >= 0].all()


def _compare(img, ref, min_frac=0.995):
    ref_nan, img_nan = ~np.isfinite(ref), ~np.isfinite(img)
    assert (ref_nan == img_nan).mean() > 0.999
    both = ~ref_nan & ~img_nan
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    frac = close.all(axis=-1).mean()
    assert frac >= min_frac, f"{frac:.4%} pixels close"


def test_render_with_all_sweep_knobs_matches_jax(dragon, port_dragon,
                                                 interpret):
    """The headline render with frustum keys for both sweeps and the
    coherence order for bounces and shadows, against JAX render_image with
    the same RenderParams, under the image rules of test_golden_images.py
    (NaN masks agree, >= 99.5% of pixels within rtol 1e-4 / atol 2e-4)."""
    params = dict(trace_chunk=1024, **ALL_KNOBS)
    ref = np.asarray(cge_tpu.render_image(
        dragon, cge_tpu.Camera(), cge_tpu.Features(**HEADLINE),
        cge_tpu.RenderParams(**params), 48, 32))
    img = ct.render_image(port_dragon, ct.Camera(), ct.Features(**HEADLINE),
                          ct.RenderParams(**params), 48, 32)
    assert np.nanmax(ref) > 0.05
    _compare(img.numpy(), ref)


def test_cpu_wrappers_run_the_twins_in_every_mode(batches, stacks):
    """On CPU tensors the refine and mxu modes run their twins and launch
    nothing."""
    inp = cs.sweep_setup(*(_t(x) for x in batches["primary"]),
                         *(_t(x) for x in stacks["triangle"]), "triangle",
                         BR, 2)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    before = dict(cs.LAUNCHES)
    for kw in (dict(refine_members=True), dict(mxu=True)):
        a = cs.cluster_walk(order, skeys, inp.rays, inp.tiles,
                            layout="triangle", sc_n=inp.sc_n,
                            aabbs=inp.aabbs, **kw)
        b = cs.cluster_walk_plain(order, skeys, inp.rays, inp.tiles,
                                  layout="triangle", sc_n=inp.sc_n,
                                  aabbs=inp.aabbs, **kw)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert cs.LAUNCHES == before
    with pytest.raises(ValueError, match="aabbs"):
        cs.cluster_walk(order, skeys, inp.rays, inp.tiles, layout="triangle",
                        sc_n=inp.sc_n, refine_members=True)


# ---------------------------------------------------------------------------
# the tuning tools at their tiny sizes
# ---------------------------------------------------------------------------

def _run_tool(module, argv, capsys):
    assert module.main(argv) == 0
    return capsys.readouterr().out


def test_sweep_grid_tool(capsys):
    from cge_tpu_torch.tools import sweep_grid
    out = _run_tool(sweep_grid, ["--device", "cpu", "--segments", "16",
                                 "--res", "32", "--cs", "32", "--brs",
                                 "128", "256"], capsys)
    rows = [ln for ln in out.splitlines() if ln.startswith("C=")]
    assert len(rows) == 8 and "not measured" in rows[0]
    assert "best by dense tiles" in out


def test_dragon_grid_tool(capsys):
    from cge_tpu_torch.tools import dragon_grid
    out = _run_tool(dragon_grid, ["--device", "cpu", "--rings", "41",
                                  "--segments", "16", "--res", "32",
                                  "--sub", "256"], capsys)
    assert len(re.findall(r"^sc_n=\d refine=\d: ", out, re.M)) == 4
    for hit, idm in re.findall(r"hit match ([\d.]+) .*id match ([\d.]+)",
                               out):
        assert float(hit) >= 0.99 and float(idm) >= 0.99


def test_mxu_grid_tool(capsys):
    from cge_tpu_torch.tools import mxu_grid
    out = _run_tool(mxu_grid, ["all", "--device", "cpu", "--segments", "16",
                               "--res", "32"], capsys)
    closest = re.findall(r"^closest mxu=(\d) .*hit_match=([\d.]+)", out,
                         re.M)
    assert len(closest) == 8
    assert all(float(h) >= 0.99 for _, h in closest)
    assert len(re.findall(r"^any_hit mxu=\d exact=\d", out, re.M)) == 4
    assert out.count("trace_chunk=") == 3


def test_kernel_bench_tool(capsys):
    """kernel_bench on the twins: K1 and every K2 and K3 batch equal to
    its twin, bounds computed, no device time claimed (the sort beside K1
    included); --shapes runs every split shape and split rule."""
    from cge_tpu_torch.tools import kernel_bench
    out = _run_tool(kernel_bench, ["--device", "cpu", "--dragon", "41", "32",
                                   "--standin", "41", "16", "--res", "64",
                                   "--rays", "1024", "--reps", "1",
                                   "--shapes"], capsys)
    rows = re.findall(r"^(K[23]) \w+: .*equal to the twin$", out, re.M)
    assert rows == ["K2"] * 5 + ["K3"] * 3
    bounds = re.findall(r"(K[123]) ms not measured \(twin ms not measured\)"
                        r" bound [\d.]+ ms \((?:operations|bytes)\) share "
                        r"not measured", out)
    assert bounds == ["K1", "K2"] * 5 + ["K3"] * 3
    assert len(re.findall(r"\| sort ms not measured \|", out)) == 5
    shapes = re.findall(r"^      (.*): ms not measured$", out, re.M)
    assert len(shapes) == 5 * len(cs.SPLIT_SHAPES) + 3 * 3


def _sass_pair(base: int) -> list:
    """One slab test's instructions in cuobjdump -sass form at `base`:
    per axis two FADDs, two FMULs and two FMNMX, then the entry test."""
    ops = (["FADD R1, R2, -R3", "FADD R4, R5, -R3", "FMUL R1, R1, R6",
            "FMUL R4, R4, R6", "FMNMX R7, R1, R4, PT",
            "FMNMX.NAN R8, R1, R4, !PT"] * 3
           + ["FSETP.GTU.AND P1, PT, R7, R8, PT", "@!P1 FMNMX R9, R9, R7, PT"])
    return [f"        /*{base + 16 * i:04x}*/  {op} ;  /* 0x0 */"
            for i, op in enumerate(ops)]


@pytest.mark.parametrize("pairs", [1, 2])
def test_sass_count_tool(pairs):
    """sass_count on a synthetic listing: the loop is found from its
    backward branch, its slab tests from the FMULs, and each kind is
    counted per pair (the load and the branch are shared by the pairs)."""
    from cge_tpu_torch.tools import sass_count
    body = ["        /*0100*/  LDS.128 R2, [R10] ;  /* 0x0 */"]
    for p in range(pairs):
        body += _sass_pair(0x110 + p * 20 * 16)
    end = 0x110 + pairs * 20 * 16
    body += [f"        /*{end:04x}*/  @P0 BRA 0x100 ;  /* 0x0 */",
             f"        /*{end + 16:04x}*/  EXIT ;  /* 0x0 */"]
    sass = "\n".join([
        "\t\tFunction : _Z23block_entry_keys_kernelILi2EEvPKfS1_Pfii",
        "        /*0000*/  MOV R1, c[0x0][0x28] ;  /* 0x0 */",
        "        /*0010*/  BRA 0x40 ;  /* 0x0 */", *body,
        "\t\tFunction : _Z9other_kernelv",
        "        /*0000*/  @P0 BRA 0x0 ;  /* 0x0 */"])
    lines = sass_count.report(sass)
    assert len(lines) == 1
    line = lines[0]
    assert f"{pairs:g} pairs an iteration" in line
    assert "FP32 12.00, FMNMX 7.00, compare/select 1.00" in line
    assert f"LDS {1 / pairs:.2f}, branch {1 / pairs:.2f}" in line
    assert sass_count.report(sass, "no_such_kernel") == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(REFINE))
def test_refine_kernel_matches_twin_on_card(batches, stacks, case,
                                            cuda_device):
    """K2 with refine_members on the card against its twin on the card:
    t, ids, visits and dense tiles bit-equal (--fmad=false)."""
    which, layout, sc_n, any_hit = REFINE[case]
    inp = cs.sweep_setup(*(_t(x).to(cuda_device) for x in batches[which]),
                         *(_t(x).to(cuda_device) for x in stacks[layout]),
                         layout, BR, sc_n)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout=layout, sc_n=sc_n, any_hit=any_hit, aabbs=inp.aabbs,
              refine_members=True)
    n = cs.LAUNCHES["walk_refine"]
    got = cs.cluster_walk(order, skeys, inp.rays, inp.tiles, **kw)
    assert cs.LAUNCHES["walk_refine"] == n + 1
    want = cs.cluster_walk_plain(order, skeys, inp.rays, inp.tiles, **kw)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(MXU))
def test_mxu_kernel_matches_twin_on_card(batches, stacks, which,
                                         cuda_device):
    """K2's tensor-core mode on the card against its twin on the card
    (torch.matmul, TF32 off): the rules of
    test_mxu_twin_matches_pallas_default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    key, any_hit, _ = MXU[which]
    inp = cs.sweep_setup(*(_t(x).to(cuda_device) for x in batches[key]),
                         *(_t(x).to(cuda_device) for x in stacks["triangle"]),
                         "triangle", BR, 1)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout="triangle", sc_n=1, any_hit=any_hit, mxu=True)
    got = cs.cluster_walk(order, skeys, inp.rays, inp.tiles, **kw)
    want = cs.cluster_walk_plain(order, skeys, inp.rays, inp.tiles, **kw)
    t, ids = got[0].cpu().numpy().ravel(), got[1].cpu().numpy().ravel()
    tr, idr = want[0].cpu().numpy().ravel(), want[1].cpu().numpy().ravel()
    h, hr = np.isfinite(t) & (t > -1e38), np.isfinite(tr) & (tr > -1e38)
    assert (h == hr).mean() >= 0.9999
    if not any_hit:
        same = h & hr & (ids == idr)
        assert same.sum() >= 0.9999 * (h & hr).sum()
        assert (np.abs(t[same] - tr[same])
                <= 1e-5 * np.maximum(1.0, tr[same])).all()
