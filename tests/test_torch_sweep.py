"""The port's brute-force sweep (cge_tpu_torch.ops.sweep, K3) against the JAX
package's Pallas kernel run in interpret mode.

The kernel's plain twin runs here (CPU tensors); the CUDA kernel is held
against the same twin by the `cuda`-marked cases, which skip without a card.
Inputs are made with numpy from a fixed seed and handed to both sides; both
sweep the same JAX-packed triangle table, so the sweep is compared on
identical constants. Ids and hit flags must be equal. t agrees to rtol 1e-5
/ atol 2e-6: XLA:CPU may contract the dot products and edge sums into FMAs,
where torch rounds each operation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cge_tpu.camera import Camera as JCamera
from cge_tpu.camera import pixel_grid as jpixel_grid
from cge_tpu.ops.pallas.sweep import pack_tri_table as jpack_tri_table
from cge_tpu.ops.pallas.sweep import pallas_closest_tris
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import load_scene_from_file as jload
from cge_tpu_torch.ops import sweep
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

SEED = 2024


def _soup(rng, n_tris):
    """A triangle soup in front of the rays: [3T, 3] vertices, [T, 3]
    triangles, one masked row, one zero-area row and one duplicated row
    (an exact tie, which the larger id wins)."""
    V = (rng.normal(size=(3 * n_tris, 3)) * [0.6, 0.6, 0.3]).astype(np.float32)
    T = np.arange(3 * n_tris, dtype=np.int64).reshape(n_tris, 3)
    mask = np.ones(n_tris, bool)
    mask[3] = False
    V[3 * 7 + 2] = V[3 * 7]          # row 7: two equal corners
    T[n_tris - 2] = T[4]             # rows 4 and T-2: the same triangle
    V[3 * 4:3 * 4 + 3] = np.float32([[-3, -3, 0.5], [3, -3, 0.5], [0, 3, 0.5]])
    return V, T, mask


def _rays(rng, n):
    """Rays from z = -4 toward the soup; a quarter dead, a quarter with a
    finite budget."""
    o = (rng.normal(size=(n, 3)) * 0.2 - [0, 0, 4]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.25 + [0, 0, 1]).astype(np.float32)
    q = np.arange(n) % 4
    tmax = np.where(q == 0, -1.0, np.where(q == 1, rng.uniform(3, 5, n),
                                           np.inf)).astype(np.float32)
    return o, d, tmax


@pytest.fixture(scope="module")
def dragon(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("brute") / "dragon_small.obj")
    write_obj(path, 41, 32)
    return jload(path, [JPointLight((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))])


def _case(name, dragon):
    """(o, d, tmax, table) as numpy, the table packed by JAX."""
    rng = np.random.default_rng(SEED)
    if name == "dragon_primary":
        o, d = JCamera().generate_rays(jpixel_grid(24, 20).reshape(-1, 2))
        o, d = np.asarray(o), np.asarray(d)
        tmax = np.full(o.shape[0], np.inf, np.float32)
        V, T, M = dragon.vertices, dragon.tris, dragon.tri_mask
    else:
        # "soup": R and T multiples of nothing; "ragged": R one past a
        # 128-ray block, T one past two 128-row tiles
        R, n_tris = {"soup": (700, 333), "ragged": (129, 257)}[name]
        V, T, M = _soup(rng, n_tris)
        o, d, tmax = _rays(rng, R)
    table = np.asarray(jpack_tri_table(jnp.asarray(V), jnp.asarray(T),
                                       jnp.asarray(M)))
    return o, d, tmax, table


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ["soup", "ragged", "dragon_primary"])
def test_twin_matches_pallas(dragon, name):
    """closest_tris (the twin, on CPU tensors) against
    pallas_closest_tris(interpret=True) on the same table: equal ids and hit
    flags, t to rtol 1e-5 / atol 2e-6."""
    o, d, tmax, table = _case(name, dragon)
    t, i = sweep.closest_tris(_t(o), _t(d), _t(tmax), _t(table))
    rt, ri = (np.asarray(x) for x in pallas_closest_tris(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(table),
        interpret=True))
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(np.isfinite(t.numpy()), np.isfinite(rt))
    h = ri >= 0
    assert h.any() and not h.all()
    np.testing.assert_allclose(t.numpy()[h], rt[h], rtol=1e-5, atol=2e-6)
    if name != "dragon_primary":
        n = table.shape[0]
        assert (ri[tmax < 0] == -1).all()          # dead rays miss
        assert not np.isin(ri, [3, 7, 4]).any()    # masked, zero area, tied
        assert (ri == n - 2).any()                 # the tie goes to the later


def test_no_triangles():
    """T = 0 (the Spheres scene sweeps no rows): every ray misses. The Pallas
    kernel cannot take an empty table, so the expectation is stated."""
    rng = np.random.default_rng(SEED)
    o, d, tmax = _rays(rng, 50)
    t, i = sweep.closest_tris(_t(o), _t(d), _t(tmax), torch.zeros((0, 16)))
    assert torch.isinf(t).all() and (i == -1).all()


def test_pack_tri_table_matches_jax(dragon):
    """The [T, 16] table equals JAX's to f32 rounding (rtol 1e-6, XLA's
    FMAs); zero-area rows (the stand-in's tail tip) are NaN in both or
    finite FMA residue in JAX, and are never hit either way."""
    V, T, M = (np.asarray(x) for x in (dragon.vertices, dragon.tris,
                                       dragon.tri_mask))
    got = sweep.pack_tri_table(_t(V), _t(T), _t(M)).numpy()
    want = np.asarray(jpack_tri_table(dragon.vertices, dragon.tris,
                                      dragon.tri_mask))
    assert got.shape == want.shape == (T.shape[0], 16)
    tv = V[T]
    zero_area = ((tv[:, 0] == tv[:, 1]).all(-1) | (tv[:, 1] == tv[:, 2]).all(-1)
                 | (tv[:, 2] == tv[:, 0]).all(-1))
    assert 0 < zero_area.sum() < 0.05 * len(zero_area)
    np.testing.assert_allclose(got[~zero_area], want[~zero_area], rtol=1e-6,
                               atol=1e-6)
    assert np.isnan(got[zero_area, 9:13]).all()
    np.testing.assert_array_equal(got[:, 13], M.astype(np.float32))


def test_pack_tri_table_is_detached():
    """Hit selection is discrete: the table carries no graph."""
    rng = np.random.default_rng(SEED)
    V, T, M = _soup(rng, 20)
    v = _t(V).requires_grad_(True)
    table = sweep.pack_tri_table(v, _t(T), _t(M))
    assert not table.requires_grad


@pytest.mark.parametrize("ray_tile,tri_tile", [(64, 32), (1000, 1000)])
def test_twin_pieces_do_not_change_result(dragon, ray_tile, tri_tile):
    """The twin's ray and triangle pieces bound memory only: the result is
    bit for bit the same at any piece size."""
    o, d, tmax, table = (_t(x) for x in _case("soup", dragon))
    a = sweep.closest_tris_plain(o, d, tmax, table)
    b = sweep.closest_tris_plain(o, d, tmax, table, ray_tile=ray_tile,
                                 tri_tile=tri_tile)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cpu_wrapper_runs_the_twin(dragon):
    """On CPU tensors the wrapper returns the twin's result and launches
    nothing."""
    o, d, tmax, table = (_t(x) for x in _case("ragged", dragon))
    before = dict(sweep.LAUNCHES)
    a = sweep.closest_tris(o, d, tmax, table)
    b = sweep.closest_tris_plain(o, d, tmax, table)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert sweep.LAUNCHES == before


def split_sweep_model(o, d, tmax, table, tested=None):
    """A plain model of the CUDA sweep's decomposition (csrc/sweep.cu): the
    edge vectors b - a hoisted once per triangle; the triangle range cut
    into split_count(T) splits of whole TILE-row tiles; in each split every
    ray tests the triangles in id order, a t that cannot be taken skips
    the edge tests and an accepted t replaces the best on t <= best; the
    splits' partials then merge in split order under the same rule. The
    kernel's rays a thread only group the rays, so the model has no such
    knob. tested, a list, gets the number of rays whose plane t passes the
    test and goes on to the edge tests, per triangle."""
    R, T = o.shape[0], table.shape[0]
    v = [table[:, 3 * j:3 * j + 3] for j in range(3)]
    e = [v[(j + 1) % 3] - v[j] for j in range(3)]            # hoisted
    n, D, valid = table[:, 9:12], table[:, 12], table[:, 13]
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    n_tiles = -(-T // sweep.TILE)
    n_split = sweep.split_count(T)
    per = -(-n_tiles // n_split) * sweep.TILE if n_tiles else sweep.TILE
    best_t = torch.full((R,), torch.inf)
    best_i = torch.full((R,), -1, dtype=torch.int32)
    for s in range(n_split):
        bt = torch.full((R,), torch.inf)
        bi = torch.full((R,), -1, dtype=torch.int32)
        for c in range(s * per, min(T, (s + 1) * per)):
            nx, ny, nz = n[c]
            denom = (dx * nx + dy * ny) + dz * nz
            t = (D[c] - ((ox * nx + oy * ny) + oz * nz)) / denom
            take = ((t >= 0) & (t <= tmax) & (t < torch.inf) & (t <= bt)
                    & (valid[c] > 0))
            if tested is not None:
                tested.append(int(take.sum()))
            px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
            for j in range(3):
                (ax, ay, az), (ex, ey, ez) = v[j][c], e[j][c]
                wx, wy, wz = px - ax, py - ay, pz - az
                cx = ey * wz - ez * wy
                cy = ez * wx - ex * wz
                cz = ex * wy - ey * wx
                take &= (cx * nx + cy * ny) + cz * nz >= 0
            bt, bi = torch.where(take, t, bt), torch.where(take, c, bi)
        take = torch.isfinite(bt) & (bt <= best_t)
        best_t = torch.where(take, bt, best_t)
        best_i = torch.where(take, bi, best_i)
    return best_t, best_i


@pytest.mark.parametrize("tiles_per_split", [1, 2, 4])
@pytest.mark.parametrize("name", ["soup", "ragged", "dragon_primary"])
def test_split_sweep_model_matches_twin_and_pallas(dragon, name,
                                                   tiles_per_split,
                                                   monkeypatch):
    """The CUDA sweep's decomposition (split_sweep_model) equals the twin
    bit for bit and matches pallas_closest_tris(interpret=True): ids and
    hit flags exactly, t to rtol 1e-5 / atol 2e-6. The soup's duplicated
    rows 4 and T - 2 are an exact-t tie that lies in one split or spans
    two, by the split rule; the later row wins either way."""
    monkeypatch.setattr(sweep, "TILES_PER_SPLIT", tiles_per_split)
    o, d, tmax, table = _case(name, dragon)
    got = split_sweep_model(_t(o), _t(d), _t(tmax), _t(table))
    for x, y in zip(got, sweep.closest_tris_plain(_t(o), _t(d), _t(tmax),
                                                  _t(table))):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    rt, ri = (np.asarray(x) for x in pallas_closest_tris(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(table),
        interpret=True))
    t, i = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(i, ri)
    h = ri >= 0
    np.testing.assert_array_equal(np.isfinite(t), h)
    np.testing.assert_allclose(t[h], rt[h], rtol=1e-5, atol=2e-6)
    if name == "soup":
        assert (i == table.shape[0] - 2).any() and not (i == 4).any()


@pytest.mark.parametrize("name", ["soup", "ragged", "dragon_primary"])
def test_sweep_bound_counts_no_more_than_the_model_tests(dragon, name):
    """The bound's edge tests (roofline.sweep_edge_pairs, from the final
    best t) are at most those the decomposition runs with its running best,
    at least one a hit, and the same in any ray piece; the plane t's are
    counted for every live ray and valid row."""
    from cge_tpu_torch.tools import roofline
    o, d, tmax, table = (_t(x) for x in _case(name, dragon))
    tested = []
    best_t, best_i = split_sweep_model(o, d, tmax, table, tested=tested)
    edges = roofline.sweep_edge_pairs(o, d, tmax, table, best_t)
    assert edges == roofline.sweep_edge_pairs(o, d, tmax, table, best_t,
                                              ray_tile=37)
    assert 0 < int((best_i >= 0).sum()) <= edges <= sum(tested)
    ms, kind = roofline.sweep_bound(o, d, tmax, table, best_t)
    pairs = int((tmax >= 0).sum()) * int((table[:, 13] > 0).sum())
    ops = pairs * roofline.SWEEP_PLANE_OPS + edges * roofline.SWEEP_EDGE_OPS
    assert ms >= ops / roofline.FP32_PEAK * 1e3 * (1 - 1e-9)
    assert kind == "operations" or ops / roofline.FP32_PEAK * 1e3 < ms


@pytest.mark.parametrize("T,want", [
    (15360, 60),                # 120 tiles of 128 rows: a split every 2
    (614400, 64),               # at most MAX_SPLIT
    (257, 2), (513, 3), (0, 1)])
def test_split_count(T, want):
    assert sweep.split_count(T) == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["soup", "ragged", "dragon_primary"])
def test_kernel_matches_twin_on_card(dragon, name, cuda_device):
    """K3 on the card against its twin on the same inputs on the card: equal
    t and ids (the kernel is built with --fmad=false and follows the twin's
    operation order)."""
    o, d, tmax, table = (_t(x).to(cuda_device) for x in _case(name, dragon))
    n = sweep.LAUNCHES["sweep"]
    got = sweep.closest_tris(o, d, tmax, table)
    assert sweep.LAUNCHES["sweep"] == n + 1
    want = sweep.closest_tris_plain(o, d, tmax, table)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    t, i = sweep.closest_tris(o, d, tmax, torch.zeros((0, 16),
                                                      device=cuda_device))
    assert torch.isinf(t).all() and (i == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tiles_per_split", [1, 2, 4])
def test_kernel_split_rules_match_twin_on_card(dragon, tiles_per_split,
                                               cuda_device, monkeypatch):
    """K3 under three split rules equals its twin on the card on every
    case."""
    monkeypatch.setattr(sweep, "TILES_PER_SPLIT", tiles_per_split)
    for name in ("soup", "ragged", "dragon_primary"):
        o, d, tmax, table = (_t(x).to(cuda_device)
                             for x in _case(name, dragon))
        got = sweep.closest_tris(o, d, tmax, table)
        want = sweep.closest_tris_plain(o, d, tmax, table)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs_on_card(dragon, cuda_device):
    o, d, tmax, table = (_t(x).to(cuda_device) for x in _case("soup", dragon))
    with pytest.raises(ValueError):
        sweep.closest_tris(o.double(), d, tmax, table)
    with pytest.raises(ValueError):
        sweep.closest_tris(o, d, tmax, table.cpu())        # wrong device
    with pytest.raises(ValueError):
        sweep.closest_tris(o, d, tmax, table[:, :8])       # wrong width
