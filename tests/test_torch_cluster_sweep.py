"""The port's cluster sweep (cge_tpu_torch.ops.cluster_sweep) against the JAX
package's Pallas kernels run in interpret mode, on the 41x32 dragon
stand-in (2,560 triangles, 20 clusters).

The kernels' plain twins run here (CPU tensors); the CUDA kernels are held
against the same twins by the `cuda`-marked cases, which skip without a
card. Inputs are made with numpy from a fixed seed and handed to both
sides; the scene and its packed tile stack are built once by JAX and
carried across, so the walk is compared on identical constants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cge_tpu.camera import Camera as JCamera
from cge_tpu.camera import pixel_grid as jpixel_grid
from cge_tpu.ops.bvh import build_clusters as jbuild_clusters
from cge_tpu.ops.pallas.cluster_sweep import (_block_entry_keys,
                                              pack_cluster_tiles,
                                              pallas_cluster_tris)
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import load_scene_from_file as jload
from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops.bvh import build_clusters
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

BR = 128
SEED = 1234


@pytest.fixture(scope="module")
def dragon(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sweep") / "dragon_small.obj")
    write_obj(path, 41, 32)
    return jload(path, [JPointLight((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))])


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
    """Primary rays (shared origin) and, from their hits, a bounce-like
    batch (scattered directions; a third dead, a third with a finite
    budget) and reversed shadow rays toward the light."""
    o, d = JCamera().generate_rays(jpixel_grid(32, 32).reshape(-1, 2))
    o, d = np.asarray(o), np.asarray(d)
    n = o.shape[0]
    aabbs, tiles = pack_cluster_tiles(dragon.vertices, dragon.tris,
                                      dragon.cluster_perm, hbm=False)
    t, _ = pallas_cluster_tris(jnp.asarray(o), jnp.asarray(d),
                               jnp.full(n, jnp.inf), aabbs, tiles,
                               dragon.cluster_perm, br=BR, interpret=True)
    t = np.asarray(t)
    hit = np.isfinite(t)
    # hit points pulled back toward the camera, as the renderer offsets its
    # secondary origins: a ray starting exactly on a surface meets it at
    # t ~ 0, where the t >= 0 test is a coin toss of rounding
    p = o + np.where(hit, t - 1e-3, 0.0)[:, None] * d
    rng = np.random.default_rng(SEED)
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    third = np.arange(n) % 3
    budget = np.where(third == 0, -1.0,
                      np.where(third == 1, rng.uniform(0.05, 1.5, n), np.inf))
    light = np.broadcast_to(np.float32([-1.0, 1.0, -1.0]), (n, 3))
    return {
        "primary": (o, d, np.full(n, np.inf, np.float32)),
        "bounce": (p.astype(np.float32), sd, budget.astype(np.float32)),
        "shadow": (np.ascontiguousarray(light),
                   (p - light).astype(np.float32),
                   np.where(hit, 1.0, -1.0).astype(np.float32)),
    }


def _t(x, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def test_build_clusters_same_sets_as_jax(dragon):
    """The port's numpy builder and the JAX package's (native) builder give
    the same clusters in the same order; member order inside a cluster may
    differ (argpartition vs nth_element)."""
    V, T, M = (np.asarray(x) for x in (dragon.vertices, dragon.tris,
                                       dragon.tri_mask))
    mine = build_clusters(V, T, M)
    ref = jbuild_clusters(V, T, M)
    assert mine.shape == ref.shape
    assert all(set(a) == set(b) for a, b in zip(mine, ref))
    assert sorted(mine[mine >= 0].tolist()) == np.nonzero(M)[0].tolist()


@pytest.mark.parametrize("layout", ["triangle", "field"])
def test_pack_cluster_tiles_matches(dragon, stacks, layout):
    """Tile constants agree to f32 rounding (rtol 1e-6: XLA contracts the
    cross products into FMAs, torch rounds each product); boxes exactly.
    The stand-in's tail tip has zero-area triangles (two equal corners):
    their exact-zero cross product gives NaN constants here, while XLA's
    FMA leaves a rounding residue and finite constants. Either way such a
    triangle has no interior to hit, so those rows are left out."""
    V, T, P = (np.asarray(x) for x in (dragon.vertices, dragon.tris,
                                       dragon.cluster_perm))
    aabbs, tiles, got_layout = cs.pack_cluster_tiles(
        _t(V), _t(T, torch.long), _t(P, torch.long), layout)
    ja, jt = stacks[layout]
    assert got_layout == layout and tuple(tiles.shape) == jt.shape
    np.testing.assert_array_equal(aabbs.numpy(), ja)
    tv = V[T[np.maximum(P, 0)]]
    zero_area = ((tv[:, :, 0] == tv[:, :, 1]).all(-1)
                 | (tv[:, :, 1] == tv[:, :, 2]).all(-1)
                 | (tv[:, :, 2] == tv[:, :, 0]).all(-1)) & (P >= 0)
    got, want = tiles.numpy(), jt
    if layout == "field":
        got, want = got.transpose(0, 2, 1), want.transpose(0, 2, 1)
    assert 0 < zero_area.sum() < 0.05 * zero_area.size
    keep = ~zero_area
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)
    assert np.isnan(got[zero_area]).all()


def _setup(batch, stack, layout, sc_n):
    o, d, tmax = (_t(x) for x in batch)
    aabbs, tiles = (_t(x) for x in stack)
    return cs.sweep_setup(o, d, tmax, aabbs, tiles, layout, BR, sc_n)


def keys_model(rays, boxes):
    """A plain model of K1's decomposition (csrc/cluster_sweep.cu,
    block_entry_keys_kernel): a thread per (ray block, box); the block's
    live rays staged as (o, tmax), (1/d, d != 0), grouped by direction
    octant (bit ax: d < 0); a box's lo <= hi test outside the loop; the
    zero-direction selects only where some live ray of the block has a
    zero component; otherwise each axis's near plane taken from the octant
    (lo where d > 0, hi where d < 0) in place of the min / max; each
    thread's running minimum over the staged rays in
    order, with the entry test folded to max(tnear, 0) <= min(tfar,
    tmax)."""
    NB, _, BR = rays.shape
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    ok = (lo <= hi).all(dim=-1)
    keys = torch.full((NB, boxes.shape[0]), torch.inf)
    for b in range(NB):
        d_all = rays[b, 3:6]
        oct_ = ((d_all < 0).int() * torch.tensor([[1], [2], [4]])).sum(dim=0)
        oct_ = torch.where(rays[b, 6] >= 0, oct_, 8)
        live = torch.argsort(oct_, stable=True)[:int((oct_ < 8).sum())]
        o, d, tm = rays[b, 0:3, live].T, rays[b, 3:6, live].T, rays[b, 6, live]
        nz = d != 0
        inv = torch.where(nz, 1.0 / torch.where(nz, d, 1.0), 0.0)
        zero = bool((~nz).any())                             # block-uniform
        key = torch.full(ok.shape, torch.inf)
        for r in range(live.numel()):
            tnear = tfar = None
            for ax in range(3):
                by_octant = not zero and bool(d[r, ax] < 0)
                near, far = (hi, lo) if by_octant else (lo, hi)
                t1 = (near[..., ax] - o[r, ax]) * inv[r, ax]
                t2 = (far[..., ax] - o[r, ax]) * inv[r, ax]
                if zero and not nz[r, ax]:
                    t1 = torch.full_like(t1, -cs.FLT_MAX)
                    t2 = torch.full_like(t2, cs.FLT_MAX)
                if not zero:
                    n0, f0 = t1, t2
                else:
                    n0, f0 = torch.minimum(t1, t2), torch.maximum(t1, t2)
                tnear = n0 if tnear is None else torch.maximum(tnear, n0)
                tfar = f0 if tfar is None else torch.minimum(tfar, f0)
            v = torch.maximum(tnear, torch.zeros(()))
            key = torch.where(v <= torch.minimum(tfar, tm[r]),
                              torch.minimum(key, v), key)
        keys[b] = torch.where(ok, key, torch.inf)
    return keys


# clusters per visit of K1's test boxes
KEYS_SC_N = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def keys_inputs(batches, stacks):
    """Packed ray blocks and boxes for K1: the three batches (dead rays,
    pad rays of a ragged last block) and a synthetic set with exact zero
    direction components in some blocks, a dead block and pad rays; by
    clusters per visit (KEYS_SC_N), the field stack's supercluster boxes
    with its pad superclusters (FLT_MAX / -FLT_MAX) and an empty box (+inf
    / -inf)."""
    aabbs, tiles = (_t(x) for x in stacks["field"])
    padded = cs.pad_cluster_stack(aabbs, tiles, 8 + (-aabbs.shape[0]) % 8,
                                  "field")[0]
    empty = torch.tensor([[np.inf] * 3 + [-np.inf] * 3 + [0, 0]],
                         dtype=torch.float32)
    boxes = {sc_n: torch.cat([cs.supercluster_boxes(padded, sc_n),
                              empty]).contiguous() for sc_n in KEYS_SC_N}
    out = {}
    for key in ("primary", "bounce", "shadow"):
        o, d, tmax = (_t(x) for x in batches[key])
        keep = o.shape[0] - BR // 2                          # pad rays
        out[key] = cs.sweep_setup(o[:keep], d[:keep], tmax[:keep], aabbs,
                                  tiles, "field", BR, 2).rays
    rng = np.random.default_rng(SEED + 7)
    n = 4 * BR - 40
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[BR:BR + 9, 1] = 0.0                    # a few exact zeros
    d[BR + 20, 0] = -0.0
    d[2 * BR:3 * BR, 2] = 0.0                # a whole block on one axis
    tmax = np.where(rng.uniform(size=n) < 0.25, -1.0,
                    rng.uniform(0.5, 4.0, n)).astype(np.float32)
    tmax[:BR] = -1.0                         # a dead block
    tmax[BR + 9] = -1.0                      # a dead ray with d = 0
    d[BR + 9, 2] = 0.0
    out["synthetic"] = cs.sweep_setup(_t(o), _t(d), _t(tmax), aabbs, tiles,
                                      "field", BR, 2).rays
    return out, boxes


@pytest.mark.parametrize("sc_n", KEYS_SC_N)
@pytest.mark.parametrize("which", ["primary", "bounce", "shadow",
                                   "synthetic"])
def test_keys_model_matches_twin_and_pallas(keys_inputs, which, sc_n):
    """K1's decomposition (keys_model) equals the twin bit for bit and
    _block_entry_keys(interpret=True) exactly, on blocks with dead rays,
    pad rays, zero direction components and a dead block, against the
    supercluster boxes at 1 to 8 clusters per visit, inverted ones
    included."""
    rays_by, boxes_by = keys_inputs
    rays, boxes = rays_by[which], boxes_by[sc_n]
    got = keys_model(rays, boxes)
    twin = cs.block_entry_keys_plain(rays, boxes)
    torch.testing.assert_close(got, twin, rtol=0, atol=0)
    ref = np.asarray(_block_entry_keys(jnp.asarray(rays.numpy()),
                                       jnp.asarray(boxes.numpy()),
                                       interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isinf(ref[:, -1]).all() and np.isfinite(ref).any()
    dead = (rays[:, 6] < 0).all(dim=1)
    assert np.isinf(ref[dead.numpy()]).all()
    if which == "synthetic":
        assert dead.any()
        live = rays[:, 6] >= 0
        zero = ((rays[:, 3:6] == 0).any(dim=1) & live).any(dim=1)
        assert zero.sum() >= 2 and (~zero & ~dead).any()


@pytest.mark.parametrize("which", ["primary", "bounce", "shadow"])
def test_block_entry_keys_twin_matches_pallas(batches, stacks, which):
    """K1's twin against _block_entry_keys(interpret=True) on the same
    packed rays and supercluster boxes: equal keys (the same f32 ops in
    the same order), +inf in the same places."""
    rays, boxes = _setup(batches[which], stacks["field"], "field", 4)[:2]
    keys = cs.block_entry_keys(rays, boxes)
    ref = np.asarray(_block_entry_keys(jnp.asarray(rays.numpy()),
                                       jnp.asarray(boxes.numpy()),
                                       interpret=True))
    np.testing.assert_array_equal(keys.numpy(), ref)
    assert np.isfinite(ref).any() and not np.isfinite(ref).all()


# (batch, layout, clusters per visit, any-hit, shared origin): the walk's
# modes (a) primary closest hit with a shared origin, (b) per-ray origins
# with budgets and dead rays, (c) any-hit shadow rays, (d) field-major
# tiles with 4 clusters per visit
MODES = {
    "a_shared_origin": ("primary", "triangle", 1, False, True),
    "b_per_ray_origin": ("bounce", "triangle", 1, False, False),
    "c_any_hit": ("shadow", "triangle", 1, True, False),
    "d_field_sc4": ("bounce", "field", 4, False, False),
    "d_field_sc4_primary": ("primary", "field", 4, False, True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cluster_walk_twin_matches_pallas(dragon, batches, stacks, mode):
    """The port's sweep (K1 twin, stable sort, K2 twin) against
    pallas_cluster_tris(interpret=True): same hit mask, same perm-space ids,
    the same per-block visit counts, and t to rtol 1e-5 / atol 2e-6: XLA
    contracts o.n and the edge sums into FMAs where torch rounds each op,
    and D - o.n cancels for hits close to a secondary ray's origin.
    Both walks visit in the same order over the same constants, so exact-t
    ties resolve alike and ids are compared everywhere."""
    which, layout, sc_n, any_hit, shared = MODES[mode]
    o, d, tmax = batches[which]
    aabbs, tiles = stacks[layout]
    got = cs.cluster_tris(_t(o), _t(d), _t(tmax), _t(aabbs), _t(tiles),
                          layout, br=BR, sc_n=sc_n, any_hit=any_hit,
                          shared_origin=shared)
    ref = pallas_cluster_tris(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(aabbs),
        jnp.asarray(tiles), dragon.cluster_perm, br=BR, sc_n=sc_n,
        any_hit=any_hit, shared_origin=shared, interpret=True,
        with_stats=True, perm_ids=True)
    ref = [np.asarray(x) for x in ref]
    if any_hit:
        hit, visits = got
        np.testing.assert_array_equal(hit.numpy(), ref[0])
        assert ref[0].any() and not ref[0].all()
    else:
        t, ids, visits = got
        np.testing.assert_array_equal(np.isfinite(t.numpy()),
                                      np.isfinite(ref[0]))
        h = np.isfinite(ref[0])
        assert h.any()
        np.testing.assert_allclose(t.numpy()[h], ref[0][h], rtol=1e-5,
                                   atol=2e-6)
        np.testing.assert_array_equal(ids.numpy(), ref[1])
    np.testing.assert_array_equal(visits.numpy(), ref[2])
    if which != "primary":
        # the dead third of each block is skipped; some blocks stop early
        assert (visits.numpy() < (aabbs.shape[0] + sc_n - 1) // sc_n).any()


@pytest.fixture(scope="module")
def tied_stacks(stacks, batches):
    """The stacks with forced exact-t ties: in the cluster the primary rays
    hit most, slots C-1-i repeat slots i (ties inside a tile, across
    lanes: the larger slot must win), and the next cluster repeats that
    whole tile with its box grown to cover it (ties across visits: the
    later visit must win)."""
    a, t = (x.copy() for x in stacks["triangle"])
    o, d, tmax = (_t(x) for x in batches["primary"])
    _, ids, _ = cs.cluster_tris(o, d, tmax, _t(a), _t(t), "triangle", br=BR)
    C = t.shape[1]
    hot = int(np.bincount(ids.numpy()[ids.numpy() >= 0] // C).argmax())
    other = (hot + 1) % t.shape[0]
    t[hot, C // 2:] = t[hot, :C // 2][::-1]
    t[other] = t[hot]
    a[other, 0:3] = np.minimum(a[other, 0:3], a[hot, 0:3])
    a[other, 3:6] = np.maximum(a[other, 3:6], a[hot, 3:6])
    return {"triangle": (a, t),
            "field": (a, np.ascontiguousarray(t.transpose(0, 2, 1)))}


def split_walk_model(order, skeys, rays, tiles, *, layout, sc_n,
                     any_hit=False, shared_origin=False,
                     shape=cs.SPLIT_SHAPES[0], tested=None, aabbs=None,
                     refine=False):
    """A plain model of the CUDA default and refine walks' decomposition
    (csrc/cluster_sweep.cu, cluster_walk_split_kernel): a ray block is CS
    CTAs of BR / CS rays, and the stop's max is the max of the CTAs'
    partials; L lanes a ray take slots l, l + L, ... in order, each keeping
    (smallest t, largest slot) and skipping a t that cannot be taken; the
    lanes merge under the same rule and a visit's members fold in order;
    visit k + 1 is tested before the stop after visit k is known and is
    committed only if the walk goes on. refine: each member runs only if
    some CTA's vote is true, a CTA voting true if one of its rays' slab
    entry into the member's box (aabbs) is at most the ray's tentative
    best (bt folded with the members run so far); the first visit's first
    member runs unvoted (every best is +inf, so the vote is true), and a
    member that does not run contributes nothing. The tile arithmetic is
    the twin's (_tile_vpu). tested, a list, gets the number of (ray, slot)
    pairs of rays that can still take a hit whose plane t passes the
    lanes' test and goes on to the edge tests, per tile run."""
    n_cta, L = shape
    NB, _, BR = rays.shape
    n_sc = order.shape[1]
    tri = tiles.transpose(1, 2) if layout == "field" else tiles
    C, rpc = tri.shape[1], BR // n_cta
    lane_ids = torch.arange(L, dtype=torch.int32)[:, None]
    best_t = torch.full((NB, BR), torch.inf)
    best_i = torch.full((NB, BR), -1, dtype=torch.int32)
    visits = torch.zeros(NB, dtype=torch.int32)
    dense = torch.zeros(NB, dtype=torch.int32)
    for b in range(NB):
        r = rays[b:b + 1]
        tm = r[0, 6]
        tm_eff = torch.minimum(tm, r[0, 7])
        live = tm >= 0
        bt = torch.full((BR,), torch.inf)
        bi = torch.full((BR,), -1, dtype=torch.int32)

        def cluster_need():
            v = torch.where(live, torch.minimum(bt, tm_eff), -torch.inf)
            return torch.stack([v[k * rpc:(k + 1) * rpc].amax()
                                for k in range(n_cta)]).amax()

        need = cluster_need()
        stop = bool(cs._past(skeys[b, 0], need))
        step = 0
        while not stop:
            active = live & ~(any_hit & (bi == 1))
            vt = torch.full((BR,), torch.inf)
            vi = torch.full((BR,), -1, dtype=torch.int32)
            vh = torch.zeros(BR, dtype=torch.bool)
            n_run = 0
            for m in range(sc_n):
                cl = int(order[b, step]) * sc_n + m
                if refine:
                    box = aabbs[cl]
                    entry = cs._entry_slab(
                        [r[0, k] for k in range(3)],
                        [r[0, 3 + k] for k in range(3)], r[0, 6],
                        [box[k] for k in range(3)],
                        [box[3 + k] for k in range(3)])
                    if any_hit:
                        tb = torch.where(vh, cs.DONE, bt)
                    else:
                        tb = torch.where((vi >= 0) & (vt <= bt), vt, bt)
                    votes = (entry <= tb).reshape(n_cta, rpc).any(dim=1)
                    run = bool(votes.any())
                    if step == 0 and m == 0:
                        assert run
                    if not run:
                        continue
                n_run += 1
                t, inside = (x[0] for x in cs._tile_vpu(tri[cl][None], r,
                                                        shared_origin))
                # lane l takes slots l, l + L, ...: [C / L, L, BR]
                tl, il = t.reshape(-1, L, BR), inside.reshape(-1, L, BR)
                lt = torch.full((L, BR), torch.inf)
                li = torch.full((L, BR), -1, dtype=torch.int32)
                lh = torch.zeros((L, BR), dtype=torch.bool)
                for j in range(C // L):
                    tc = tl[j]
                    pre = (tc >= 0) & (tc <= tm)
                    if not any_hit:
                        pre &= (tc < torch.inf) & (tc <= lt) & (tc <= bt)
                    if tested is not None:
                        tested.append(int((pre & active).sum()))
                    take = pre & il[j]
                    lh |= take
                    lt = torch.where(take, tc, lt)
                    li = torch.where(take, j * L + lane_ids, li)
                # the shuffle butterfly: smallest t, largest slot on a tie
                off = L // 2
                while off:
                    p = lane_ids[:, 0] ^ off
                    ot, oi = lt[p], li[p]
                    take = (ot < lt) | ((ot == lt) & (oi > li))
                    lt, li = torch.where(take, ot, lt), torch.where(take, oi,
                                                                    li)
                    lh = lh | lh[p]
                    off //= 2
                lt, li, lh = lt[0], li[0], lh[0]
                take = (li >= 0) & (lt <= vt)
                vt = torch.where(take, lt, vt)
                vi = torch.where(take, cl * C + li, vi)
                vh |= lh
            if step > 0:
                stop = bool(cs._past(skeys[b, step], need))
                if stop:
                    break
            if any_hit:
                hit = active & vh
                bt = torch.where(hit, cs.DONE, bt)
                bi = torch.where(hit, 1, bi).int()
            else:
                take = active & (vi >= 0) & (vt <= bt)
                bt, bi = torch.where(take, vt, bt), torch.where(take, vi, bi)
            dense[b] += n_run
            step += 1
            if step >= n_sc:
                break
            need = cluster_need()
        best_t[b], best_i[b], visits[b] = bt, bi, step
    return best_t, best_i, visits, dense


# (batch, any-hit, shared origin) of the split model's cases
MODEL_BATCHES = {"primary": (False, True), "bounce": (False, False),
                 "shadow": (True, False)}


@pytest.mark.parametrize("tied", [False, True], ids=["plain", "tied"])
@pytest.mark.parametrize("sc_n", [1, 4])
@pytest.mark.parametrize("layout", ["triangle", "field"])
@pytest.mark.parametrize("which", list(MODEL_BATCHES))
def test_split_walk_model_matches_twin_and_pallas(
        dragon, batches, stacks, tied_stacks, which, layout, sc_n, tied):
    """The CUDA default walk's decomposition (split_walk_model) equals the
    twin bit for bit (t, ids, visits, dense tiles) and matches
    pallas_cluster_tris(interpret=True): hits, perm-space ids and visits
    exactly, t to rtol 1e-5 / atol 2e-6 (XLA's FMAs). The tied stacks
    force exact-t ties inside a tile across lanes and across visits."""
    any_hit, shared = MODEL_BATCHES[which]
    aabbs, tiles = (tied_stacks if tied else stacks)[layout]
    inp = _setup(batches[which], (aabbs, tiles), layout, sc_n)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout=layout, sc_n=inp.sc_n, any_hit=any_hit,
              shared_origin=shared)
    got = split_walk_model(order, skeys, inp.rays, inp.tiles, **kw)
    for x, y in zip(got, cs.cluster_walk_plain(order, skeys, inp.rays,
                                               inp.tiles, **kw)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    o, d, tmax = batches[which]
    R = o.shape[0]
    ref = [np.asarray(x) for x in pallas_cluster_tris(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(aabbs),
        jnp.asarray(tiles), dragon.cluster_perm, br=BR, sc_n=sc_n,
        any_hit=any_hit, shared_origin=shared, interpret=True,
        with_stats=True, perm_ids=True)]
    t, ids = got[0].reshape(-1)[:R].numpy(), got[1].reshape(-1)[:R].numpy()
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    if any_hit:
        np.testing.assert_array_equal(ids > 0, ref[0])
        return
    np.testing.assert_array_equal(ids, ref[1])
    h = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(t), h)
    np.testing.assert_allclose(t[h], ref[0][h], rtol=1e-5, atol=2e-6)
    if tied and which == "primary":
        # the ties were taken: hits land on the later copies
        C = tiles.shape[2] if layout == "field" else tiles.shape[1]
        slots = ids[ids >= 0] % C
        assert (slots >= C // 2).any()


@pytest.mark.parametrize("shape", cs.SPLIT_SHAPES)
def test_split_walk_model_shapes_agree(batches, tied_stacks, shape):
    """Every compiled (CTAs, lanes) shape gives the same walk: the
    decomposition does not change t, ids or visits."""
    inp = _setup(batches["bounce"], tied_stacks["triangle"], "triangle", 1)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout="triangle", sc_n=1)
    got = split_walk_model(order, skeys, inp.rays, inp.tiles, shape=shape,
                           **kw)
    for x, y in zip(got, cs.cluster_walk_plain(order, skeys, inp.rays,
                                               inp.tiles, **kw)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("tied", [False, True], ids=["plain", "tied"])
@pytest.mark.parametrize("layout,sc_n", [("triangle", 1), ("field", 2)])
@pytest.mark.parametrize("which", list(MODEL_BATCHES))
def test_refine_model_matches_twin_and_pallas(
        dragon, batches, stacks, tied_stacks, which, layout, sc_n, tied):
    """The CUDA refine walk's decomposition (split_walk_model with refine:
    the cluster-wide per-member vote and the member fold) equals the
    refine twin bit for bit (t, ids, visits, dense tiles) and matches
    pallas_cluster_tris(refine_members=True, interpret=True): hits,
    perm-space ids and visits exactly, t to rtol 1e-5 / atol 2e-6 (XLA's
    FMAs)."""
    any_hit, shared = MODEL_BATCHES[which]
    aabbs, tiles = (tied_stacks if tied else stacks)[layout]
    inp = _setup(batches[which], (aabbs, tiles), layout, sc_n)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout=layout, sc_n=inp.sc_n, any_hit=any_hit,
              shared_origin=shared)
    got = split_walk_model(order, skeys, inp.rays, inp.tiles, refine=True,
                           aabbs=inp.aabbs, **kw)
    twin = cs.cluster_walk_plain(order, skeys, inp.rays, inp.tiles,
                                 aabbs=inp.aabbs, refine_members=True, **kw)
    for x, y in zip(got, twin):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    o, d, tmax = batches[which]
    R = o.shape[0]
    ref = [np.asarray(x) for x in pallas_cluster_tris(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(aabbs),
        jnp.asarray(tiles), dragon.cluster_perm, br=BR, sc_n=sc_n,
        any_hit=any_hit, shared_origin=shared, refine_members=True,
        interpret=True, with_stats=True, perm_ids=True)]
    t, ids = got[0].reshape(-1)[:R].numpy(), got[1].reshape(-1)[:R].numpy()
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    assert (got[3] <= got[2] * sc_n).all()
    if any_hit:
        np.testing.assert_array_equal(ids > 0, ref[0])
        return
    np.testing.assert_array_equal(ids, ref[1])
    h = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(t), h)
    np.testing.assert_allclose(t[h], ref[0][h], rtol=1e-5, atol=2e-6)


def _grid_plane(z, half, n=8):
    """n x n quads at depth z over [-half, half]^2: 2 n^2 triangles."""
    xs = np.linspace(-half, half, n + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    v = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z, np.float32)],
                 axis=1)
    i = (np.arange(n)[:, None] * (n + 1) + np.arange(n)).ravel()
    tris = np.concatenate([np.stack([i, i + 1, i + n + 2], axis=1),
                           np.stack([i, i + n + 2, i + n + 1], axis=1)])
    return v, tris


@pytest.fixture(scope="module")
def discard_scene():
    """Two planes of 128 triangles, one cluster each and one supercluster
    of both: member 0 the far plane (z = 3), member 1 the near one (z =
    2). The member boxes handed to the sweep move the near plane's box
    behind the far plane (z in [10, 10.1]). Two blocks of the same 128
    rays from the origin, every one hitting both planes: in the first all
    are live, so after member 0 every ray has a hit at the far plane, its
    entry into the moved box lies past it, and the vote skips member 1
    although its tile holds a nearer hit; in the second one lane is dead
    (entry = best = +inf), so member 1 runs."""
    vb, tb = _grid_plane(3.0, 2.0)
    va, ta = _grid_plane(2.0, 1.2)
    V = np.concatenate([vb, va])
    T = np.concatenate([tb, ta + len(vb)]).astype(np.int32)
    perm = np.arange(2 * 128, dtype=np.int32).reshape(2, 128)
    stacks_ = {}
    for layout, hbm in (("triangle", False), ("field", True)):
        a, t = pack_cluster_tiles(jnp.asarray(V), jnp.asarray(T),
                                  jnp.asarray(perm), hbm=hbm)
        a = np.array(a)
        a[1, 2], a[1, 5] = 10.0, 10.1
        stacks_[layout] = (a, np.asarray(t))
    rng = np.random.default_rng(SEED + 3)
    xy = rng.uniform(-0.45, 0.45, (BR, 2)).astype(np.float32)
    d = np.concatenate([xy, np.ones((BR, 1), np.float32)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = np.concatenate([d, d])
    o = np.zeros_like(d)
    tmax = np.full(2 * BR, np.inf, np.float32)
    tmax[BR + 5] = -1.0
    return stacks_, perm, (o, d, tmax)


@pytest.mark.parametrize("layout", ["triangle", "field"])
def test_refine_vote_discards_a_tile_hit(discard_scene, layout):
    """Where the vote says skip, the member's tile contributes nothing,
    even a hit with t <= best: the first block keeps the far plane (t =
    3 / d.z) and runs one dense tile a visit, the second (a dead lane)
    takes the near plane (t = 2 / d.z) and runs both. The refine model,
    the twin and pallas_cluster_tris(refine_members=True, interpret=True)
    agree (t to rtol 1e-5 / atol 2e-6, ids and visits exactly); without
    refine every ray takes the near plane."""
    stacks_, perm, batch = discard_scene
    aabbs, tiles = stacks_[layout]
    inp = _setup(batch, (aabbs, tiles), layout, 2)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout=layout, sc_n=2)
    twin = cs.cluster_walk_plain(order, skeys, inp.rays, inp.tiles,
                                 aabbs=inp.aabbs, refine_members=True, **kw)
    model = split_walk_model(order, skeys, inp.rays, inp.tiles, refine=True,
                             aabbs=inp.aabbs, **kw)
    for x, y in zip(model, twin):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    base = cs.cluster_walk_plain(order, skeys, inp.rays, inp.tiles, **kw)
    dz = torch.from_numpy(batch[1][:, 2]).reshape(2, BR)
    live = torch.from_numpy(batch[2]).reshape(2, BR) >= 0
    torch.testing.assert_close(twin[0][0], 3.0 / dz[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(twin[0][1][live[1]], 2.0 / dz[1][live[1]],
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(base[0][live], (2.0 / dz)[live], rtol=1e-5,
                               atol=0)
    assert twin[3].tolist() == [1, 2] and twin[2].tolist() == [1, 1]
    assert (twin[1][0] < 128).all() and (twin[1][1][live[1]] >= 128).all()
    o, d, tmax = batch
    ref = [np.asarray(x) for x in pallas_cluster_tris(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(aabbs),
        jnp.asarray(tiles), jnp.asarray(perm), br=BR, sc_n=2,
        refine_members=True, interpret=True, with_stats=True,
        perm_ids=True)]
    t, ids = twin[0].reshape(-1).numpy(), twin[1].reshape(-1).numpy()
    np.testing.assert_array_equal(ids, ref[1])
    np.testing.assert_array_equal(twin[2].numpy(), ref[2])
    h = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(t), h)
    np.testing.assert_allclose(t[h], ref[0][h], rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("which", list(MODEL_BATCHES))
def test_walk_bound_counts_no_more_than_the_model_tests(batches,
                                                        tied_stacks, which):
    """The bound's edge tests (roofline.walk_edge_pairs, from the final
    best t) are at most those the decomposition runs with its running best,
    and at least one a hit; the plane t's are counted for every live ray
    and slot of a visited tile, so the operations bound the kernel."""
    from cge_tpu_torch.tools import roofline
    any_hit, shared = MODEL_BATCHES[which]
    inp = _setup(batches[which], tied_stacks["field"], "field", 4)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    kw = dict(layout="field", sc_n=4, any_hit=any_hit, shared_origin=shared)
    tested = []
    out = split_walk_model(order, skeys, inp.rays, inp.tiles, tested=tested,
                           **kw)
    edges = roofline.walk_edge_pairs(order, inp.rays, inp.tiles, out, **kw)
    hits = int((out[1] == 1).sum() if any_hit else (out[1] >= 0).sum())
    assert 0 < hits <= edges <= sum(tested)
    ms, kind = roofline.walk_bound(order, inp.rays, inp.tiles, out, **kw)
    live = (inp.rays[:, 6] >= 0).sum(dim=1)
    C = inp.tiles.shape[2]
    plane = (roofline.WALK_PLANE_OPS_SHARED if shared
             else roofline.WALK_PLANE_OPS)
    ops = (int((out[3] * live).sum()) * C * plane
           + edges * roofline.WALK_EDGE_OPS)
    assert kind == "operations" or ops / roofline.FP32_PEAK * 1e3 < ms
    assert ms >= ops / roofline.FP32_PEAK * 1e3 * (1 - 1e-9)


def test_split_shape_fits_every_block_size():
    """split_shape picks the first of SPLIT_SHAPES whose CTAs fit, for
    every block size the wrapper accepts: the first at the default size."""
    assert cs.split_shape(cs.DEFAULT_BR) == cs.SPLIT_SHAPES[0]
    for br in range(32, 1025, 32):
        n_cta, lanes = cs.split_shape(br)
        threads = br // n_cta * lanes
        assert (n_cta, lanes) in cs.SPLIT_SHAPES
        assert br % n_cta == 0 and threads % 32 == 0
        assert threads <= cs.SPLIT_MAX_THREADS


def test_exit_bound_boundary_hit():
    """test_bvh.py:198-226's case: a triangle on the union box's far face
    is still hit (the exit bound is padded past slab rounding), and rays
    that provably miss the box make no hits."""
    V = np.float32([[-0.2, -0.2, 1.0], [0.2, -0.2, 1.0], [0.0, 0.25, 1.0],
                    [-2.0, -2.0, 4.0], [2.0, -2.0, 4.0], [0.0, 2.5, 4.0]])
    T = np.int64([[0, 1, 2], [3, 4, 5]])
    perm = build_clusters(V, T, np.ones(2, bool))
    aabbs, tiles, layout = cs.pack_cluster_tiles(_t(V), _t(T), _t(perm, torch.long))
    o = _t(np.float32([[0, 0, 0], [1, 0, 0], [0, 0, 5], [10, 0, 0]]))
    d = _t(np.float32([[0, 0, 1]] * 3 + [[0, 0, -1]]))
    t, ids, _ = cs.cluster_tris(o, d, torch.full((4,), torch.inf), aabbs,
                                tiles, layout, br=BR)
    t = t.numpy()
    np.testing.assert_allclose(t[0], 1.0, rtol=1e-6)
    np.testing.assert_allclose(t[1], 4.0, rtol=1e-6)
    assert not np.isfinite(t[2:]).any() and (ids.numpy()[2:] == -1).all()


def test_cpu_wrappers_run_the_twins(batches, stacks):
    """On CPU tensors the wrappers return the twins' results and launch
    nothing."""
    rays, boxes, tiles, sc_n, _ = _setup(batches["bounce"], stacks["field"],
                                         "field", 4)
    before = dict(cs.LAUNCHES)
    keys = cs.block_entry_keys(rays, boxes)
    torch.testing.assert_close(keys, cs.block_entry_keys_plain(rays, boxes),
                               rtol=0, atol=0)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    a = cs.cluster_walk(order.int(), skeys, rays, tiles, layout="field",
                        sc_n=sc_n)
    b = cs.cluster_walk_plain(order.int(), skeys, rays, tiles,
                              layout="field", sc_n=sc_n)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert cs.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_kernels_match_twins_on_card(batches, stacks, mode, cuda_device):
    """K1 and K2 on the card against their twins on the same inputs on the
    card: equal keys, ids, visit counts and t (the kernels are built with
    --fmad=false, so both sides round alike)."""
    which, layout, sc_n, any_hit, shared = MODES[mode]
    rays, boxes, tiles, sc_n, _ = _setup(batches[which], stacks[layout],
                                         layout, sc_n)
    rays, boxes, tiles = (x.to(cuda_device) for x in (rays, boxes, tiles))
    n_keys = cs.LAUNCHES["keys"]
    keys = cs.block_entry_keys(rays, boxes)
    assert cs.LAUNCHES["keys"] == n_keys + 1
    torch.testing.assert_close(keys, cs.block_entry_keys_plain(rays, boxes),
                               rtol=0, atol=0)
    skeys, order = torch.sort(keys, dim=-1, stable=True)
    kw = dict(layout=layout, sc_n=sc_n, any_hit=any_hit,
              shared_origin=shared)
    got = cs.cluster_walk(order.int(), skeys, rays, tiles, **kw)
    want = cs.cluster_walk_plain(order.int(), skeys, rays, tiles, **kw)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", cs.SPLIT_SHAPES)
@pytest.mark.parametrize("which", list(MODEL_BATCHES))
def test_split_walk_shapes_match_twin_on_card(batches, tied_stacks, which,
                                              shape, cuda_device):
    """The default walk in every compiled (CTAs, lanes) shape, on the
    tied stacks at 1 and 4 clusters per visit in both layouts: t, ids,
    visits and dense tiles equal to the twin's on the card, one launch a
    call."""
    any_hit, shared = MODEL_BATCHES[which]
    for layout in cs.LAYOUTS:
        for sc_n in (1, 4):
            inp = _setup(batches[which], tied_stacks[layout], layout, sc_n)
            rays, boxes, tiles = (x.to(cuda_device)
                                  for x in (inp.rays, inp.boxes, inp.tiles))
            skeys, order = cs.sweep_order(rays, boxes)
            kw = dict(layout=layout, sc_n=sc_n, any_hit=any_hit,
                      shared_origin=shared)
            n = cs.LAUNCHES["walk"]
            got = cs.cluster_walk(order, skeys, rays, tiles, _shape=shape,
                                  **kw)
            assert cs.LAUNCHES["walk"] == n + 1
            want = cs.cluster_walk_plain(order, skeys, rays, tiles, **kw)
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs_on_card(stacks, batches, cuda_device):
    rays, boxes, tiles = _setup(batches["primary"], stacks["field"],
                                "field", 4)[:3]
    with pytest.raises(ValueError):
        cs.block_entry_keys(rays.to(cuda_device).double(),
                            boxes.to(cuda_device))
    with pytest.raises(ValueError):
        cs.block_entry_keys(rays.to(cuda_device), boxes)   # wrong device



@pytest.mark.cuda
@pytest.mark.parametrize("sc_n", KEYS_SC_N)
def test_keys_kernel_matches_twin_on_card(keys_inputs, sc_n, cuda_device):
    """K1 on the card against the twin on the card, on the model's inputs
    (dead and pad rays, zero direction components, inverted boxes): keys
    equal, one launch a call."""
    rays_by, boxes_by = keys_inputs
    boxes = boxes_by[sc_n].to(cuda_device)
    for which, rays in rays_by.items():
        rays = rays.to(cuda_device)
        n = cs.LAUNCHES["keys"]
        got = cs.block_entry_keys(rays, boxes)
        assert cs.LAUNCHES["keys"] == n + 1
        assert torch.equal(got, cs.block_entry_keys_plain(rays, boxes)), which


@pytest.mark.cuda
@pytest.mark.parametrize("shape", cs.SPLIT_SHAPES)
def test_refine_walk_matches_twin_on_card(batches, tied_stacks, discard_scene,
                                          shape, cuda_device):
    """The refine walk (the split walk with its per-member vote) in every
    compiled shape on the card: t, ids, visits and dense tiles equal to
    the refine twin's on the card, on the tied dragon stacks at 1 and 2
    clusters per visit and on the discard fixture."""
    cases = [(batches[w], tied_stacks[lay], lay, sc_n, MODEL_BATCHES[w][0])
             for w in MODEL_BATCHES for lay, sc_n in (("triangle", 1),
                                                      ("field", 2))]
    stacks_, _, batch = discard_scene
    cases += [(batch, stacks_[lay], lay, 2, False) for lay in cs.LAYOUTS]
    for batch, stack, layout, sc_n, any_hit in cases:
        inp = _setup(batch, stack, layout, sc_n)
        rays, boxes, tiles, aabbs = (x.to(cuda_device) for x in (
            inp.rays, inp.boxes, inp.tiles, inp.aabbs))
        skeys, order = cs.sweep_order(rays, boxes)
        kw = dict(layout=layout, sc_n=sc_n, any_hit=any_hit, aabbs=aabbs,
                  refine_members=True)
        n = cs.LAUNCHES["walk_refine"]
        got = cs.cluster_walk(order, skeys, rays, tiles, _shape=shape, **kw)
        assert cs.LAUNCHES["walk_refine"] == n + 1
        want = cs.cluster_walk_plain(order, skeys, rays, tiles, **kw)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
