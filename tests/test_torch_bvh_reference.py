"""The port's reference-parity BVH and its traversal against the JAX
package.

build_reference_bvh's numpy twin (`use_native=False`; median split and
SAH binning, with and without the recorded SAH cuts) equals the JAX
package's pure-Python builder (`use_native=False`) node for node on the
41x32 dragon stand-in (tools/make_large_asset.py), on the Spheres scene
and on the stand-in with two spheres; so do the debug exports. bvh_closest_hit agrees with JAX's
bvh_closest_hit: hit masks and sphere flags equal, t to rtol 5e-6 / atol
1e-7 (tests/test_bvh_traverse.py's tolerance), ids equal except where both
hits lie at the same t within that tolerance (an exact-t tie under another
rounding order), also with the shadow rays' budget of 1.0. Shadow rays
from surface hit points, as the renderer sends them, keep equal hit masks
and ids (their t to SHADOW_T_ATOL), with the cases where a zero offset
makes the two packages come apart counted. Scenes are built once by JAX
and carried across as numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
from cge_tpu.ops import bvh as jbvh
from cge_tpu.ops import bvh_traverse as jtrav
from cge_tpu.ops import intersect as jint
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
import cge_tpu_torch as ct
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import bvh as pbvh
from cge_tpu_torch.ops import bvh_traverse as ptrav
from cge_tpu_torch.ops import intersect as pint
from tools.make_large_asset import write_obj

torch.set_num_threads(2)
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
RTOL, ATOL = 5e-6, 1e-7
SHADOW_T_ATOL = 2e-5


def _port(jscene):
    leaves = {k: np.asarray(getattr(jscene, k)) for k in TENSOR_FIELDS}
    return scene_from_numpy(leaves, all_opaque=jscene.all_opaque,
                            all_diffuse=jscene.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bvh") / "dragon.obj")
    write_obj(path, 41, 32)
    dragon = cge_tpu.load_scene_from_file(path, [JPointLight(*LIGHT)])
    mixed = build_scene_arrays(
        load_mesh(path),
        [SphereDef((0.0, 0.1, 0.0), 0.3, Material(kd=np.float32([1, 0, 0]))),
         SphereDef((0.55, 0.45, -0.7), 0.2,
                   Material(kd=np.float32([0, 0, 1])))],
        [JPointLight(*LIGHT)])
    spheres = cge_tpu.load_scene_prebuilt(cge_tpu.SceneType.Spheres)
    return {k: (v, _port(v)) for k, v in
            (("dragon", dragon), ("mixed", mixed), ("spheres", spheres))}


MODES = {"median": dict(sah_binning=False),
         "sah": dict(sah_binning=True),
         "sah_cuts": dict(sah_binning=True, record_sah_cuts=True),
         "median_cuts": dict(sah_binning=False, record_sah_cuts=True)}


def _builds(scenes, which, mode):
    js, ps = scenes[which]
    return (jbvh.build_reference_bvh(js, use_native=False, **MODES[mode]),
            pbvh.build_reference_bvh(ps, use_native=False, **MODES[mode]))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("which", ["dragon", "mixed", "spheres"])
def test_build_matches_jax(scenes, which, mode):
    j, p = _builds(scenes, which, mode)
    for k in ("node_lo", "node_hi", "node_meta", "perm_is_sphere",
              "perm_index"):
        a, b = getattr(j, k), getattr(p, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert (p.root, p.num_levels, p.num_leaves, p.max_per_leaf) == (
        j.root, j.num_levels, j.num_leaves, j.max_per_leaf)
    if j.sah_cuts_per_level is None:
        assert p.sah_cuts_per_level is None
        return
    # a median build with record_sah_cuts records an empty list
    assert len(p.sah_cuts_per_level) == len(j.sah_cuts_per_level)
    assert (len(j.sah_cuts_per_level) > 1) == MODES[mode]["sah_binning"]
    for lj, lp in zip(j.sah_cuts_per_level, p.sah_cuts_per_level):
        assert len(lj) == len(lp)
        for a, b in zip(lj, lp):
            assert (b.chosen_dim, b.chosen_ind) == (a.chosen_dim,
                                                    a.chosen_ind)
            for axis in range(3):
                assert len(a.cuts[axis]) == len(b.cuts[axis])
                for (alo, ahi), (blo, bhi) in zip(a.cuts[axis],
                                                  b.cuts[axis]):
                    np.testing.assert_array_equal(blo, alo)
                    np.testing.assert_array_equal(bhi, ahi)


@pytest.mark.parametrize("which", ["dragon", "mixed"])
def test_debug_exports_match_jax(scenes, which):
    j, p = _builds(scenes, which, "sah_cuts")
    for level in range(-1, j.num_levels + 1):
        for a, b in zip(j.debug_level_boxes(level),
                        p.debug_level_boxes(level)):
            np.testing.assert_array_equal(b, a)
        for axis in range(3):
            for a, b in zip(j.debug_sah_splits(level, axis),
                            p.debug_sah_splits(level, axis)):
                np.testing.assert_array_equal(b, a)
    # the root's one chosen plane, on one of the three axes
    assert sum(p.debug_sah_splits(0, a)[2].sum() for a in range(3)) == 1
    for leaf in (0, 1, 2, j.num_leaves // 2, j.num_leaves,
                 j.num_leaves + 1):
        a, b = j.debug_leaf(leaf), p.debug_leaf(leaf)
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
    plain = pbvh.build_reference_bvh(scenes[which][1], sah_binning=True)
    with pytest.raises(ValueError, match="record_sah_cuts"):
        plain.debug_sah_splits(0, 0)


def _rays(n_side=16, seed=5):
    """Primary rays, then rays from inside the scene in scattered
    directions, a third of them dead (tmax -1)."""
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(n_side, n_side, "cpu").reshape(-1, 2))
    n = o.shape[0]
    rng = np.random.default_rng(seed)
    so = torch.from_numpy(rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32))
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    tm = torch.where(torch.arange(n) % 3 == 0, -1.0, torch.inf)
    return [(o, d, torch.full((n,), torch.inf)),
            (so, torch.from_numpy(sd), tm)]


def _assert_agree(got, ref):
    """hit and sphere flags equal; t within RTOL / ATOL; ids equal unless
    the two hits share one t within that tolerance. Returns the count of
    such ties."""
    hit, t, sph, prim = (x.numpy() for x in got)
    rhit, rt, rsph, rprim = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(hit, rhit)
    np.testing.assert_array_equal(sph[hit], rsph[hit])
    np.testing.assert_allclose(t[hit], rt[hit], rtol=RTOL, atol=ATOL)
    assert np.isinf(t[~hit]).all() and np.isinf(rt[~rhit]).all()
    differ = hit & (prim != rprim)
    assert differ.sum() <= max(1, hit.sum() // 100)
    return int(differ.sum())


@pytest.mark.parametrize("sah", [False, True])
@pytest.mark.parametrize("which", ["dragon", "mixed", "spheres"])
def test_traversal_matches_jax(scenes, which, sah):
    js, ps = scenes[which]
    jb = jtrav.device_bvh(
        jbvh.build_reference_bvh(js, sah_binning=sah, use_native=False), js)
    pb = ptrav.device_bvh(pbvh.build_reference_bvh(ps, sah_binning=sah,
                                                   use_native=False), ps)
    for o, d, tm in _rays():
        got = ptrav.bvh_closest_hit(pb, o, d, tm)
        ref = jtrav.bvh_closest_hit(jb, jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy()),
                                    jnp.asarray(tm.numpy()))
        _assert_agree(got, ref)
        assert got[0].any()
    if which == "mixed":
        assert got[2].any() and (got[0] & ~got[2]).any()


def test_traversal_shadow_budget_matches_jax(scenes):
    """Shadow rays with the reference's budget of 1.0 (light.cpp:60): from
    points scattered through the mixed scene to the light, so a hit is a
    blocker on the segment; camera rays under a budget of 1 (the camera
    sits ~3 away) and dead rays never hit."""
    js, ps = scenes["mixed"]
    jb = jtrav.device_bvh(jbvh.build_reference_bvh(js, use_native=False), js)
    pb = ptrav.device_bvh(pbvh.build_reference_bvh(ps, use_native=False),
                          ps)
    rng = np.random.default_rng(11)
    p = torch.from_numpy(rng.uniform(-0.6, 0.6, (512, 3)).astype(np.float32))
    sdir = torch.tensor(LIGHT[0]) - p
    budget = torch.where(torch.arange(512) % 4 == 0, -1.0, 1.0)
    got = ptrav.bvh_closest_hit(pb, p, sdir, budget)
    ref = jtrav.bvh_closest_hit(jb, jnp.asarray(p.numpy()),
                                jnp.asarray(sdir.numpy()),
                                jnp.asarray(budget.numpy()))
    _assert_agree(got, ref)
    hit, t = got[0], got[1]
    assert hit.any() and not hit.all() and not hit[budget < 0].any()
    assert (t[hit] <= 1.0).all()
    o, d, inf = _rays()[0]
    for b in (1.0, -1.0):
        assert not ptrav.bvh_closest_hit(pb, o, d,
                                         torch.full_like(inf, b))[0].any()


def _witness(js, o, d):
    """The traversal's leaf tests (triangles 0 <= t <= 1, spheres 0 <= t <
    1) in float64 on the float32 rays, over every primitive: (hit, t)."""
    v = np.asarray(js.vertices, np.float64)
    tri = np.asarray(js.tris)[np.asarray(js.tri_mask)]
    v0, v1, v2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    with np.errstate(all="ignore"):
        n = np.cross(v1 - v0, v2 - v0)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
    o, d = o.astype(np.float64), d.astype(np.float64)
    best = np.full(len(o), np.inf)
    for i in range(0, len(o), 256):
        oo, dd = o[i:i + 256, None], d[i:i + 256, None]
        with np.errstate(all="ignore"):
            t = ((n * v0).sum(-1) - (n * oo).sum(-1)) / (n * dd).sum(-1)
            q = oo + t[..., None] * dd
            ok = (t >= 0) & (t <= 1) & np.isfinite(t)
            for a, b in ((v0, v1), (v1, v2), (v2, v0)):
                ok &= (np.cross(b - a, q - a) * n).sum(-1) >= 0
        best[i:i + 256] = np.where(ok, t, np.inf).min(1)
    mask = np.asarray(js.sph_mask)
    for c, r in zip(np.asarray(js.sph_center, np.float64)[mask],
                    np.asarray(js.sph_radius, np.float64)[mask]):
        oc = o - c
        b = 2.0 * (d * oc).sum(1)
        disc = b * b - 4.0 * ((oc * oc).sum(1) - r * r)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = np.where(-b - sq >= 0, (-b - sq) / 2.0, (-b + sq) / 2.0)
        best = np.where((disc >= 0) & (t >= 0) & (t < 1),
                        np.minimum(best, t), best)
    return np.isfinite(best), best


@pytest.mark.parametrize("offset", [1e-5, 0.0])
@pytest.mark.parametrize("which", ["dragon", "mixed"])
def test_traversal_surface_shadow_rays_match_jax(scenes, which, offset):
    """Shadow rays as the renderer sends them (lights.shadow_visibility):
    from each primary hit of two cameras at 64x64, pulled back `offset`
    along the unit direction (the reference's 1e-5), to the light under a
    budget of 1. A shadow ray's hit is read only through its mask and id
    (visibility, the blocker's transparency); its t comes from the plane
    equation's cancellation, which 1/|n.d| amplifies at grazing angles,
    so t is held to SHADOW_T_ATOL (twice the largest gap measured) and the
    rays beyond the primary rays' tolerance are counted and printed.

    At the reference's offset the port's hit masks, sphere flags and ids
    equal JAX's, t within SHADOW_T_ATOL, and on the triangle-only dragon
    the hit mask equals the float64 witness and t lies within
    SHADOW_T_ATOL of it. With no offset
    the origin lies on its own surface and a hit at t = -0 or +0 turns on
    rounding: the packages then come apart (a mask, an id, or a t beyond
    SHADOW_T_ATOL) only on rays where one side hits within 1e-6 of 0, and
    neither side's mask matches the witness there every time."""
    js, ps = scenes[which]
    jb = jtrav.device_bvh(jbvh.build_reference_bvh(js, use_native=False), js)
    pb = ptrav.device_bvh(pbvh.build_reference_bvh(ps, use_native=False),
                          ps)
    grid = ct.camera.pixel_grid(64, 64, "cpu").reshape(-1, 2)
    light = np.float32(LIGHT[0])
    ps_, ds_ = [], []
    for cam in (ct.Camera(), ct.Camera(rotation=(-20.0, 35.0, 0.0))):
        o, d = cam.generate_rays(grid)
        hit, t, _, _ = ptrav.bvh_closest_hit(
            pb, o, d, torch.full((o.shape[0],), torch.inf))
        o, d, t = o[hit].numpy(), d[hit].numpy(), t[hit].numpy()
        dlen = np.sqrt((d * d).sum(1, keepdims=True))
        p = o + d / dlen * (t[:, None] * dlen - np.float32(offset))
        ps_.append(p)
        ds_.append(light - p)
    p, sd = np.concatenate(ps_), np.concatenate(ds_)
    one = np.ones(len(p), np.float32)
    got = ptrav.bvh_closest_hit(pb, torch.from_numpy(p), torch.from_numpy(sd),
                                torch.from_numpy(one))
    ref = jtrav.bvh_closest_hit(jb, jnp.asarray(p), jnp.asarray(sd),
                                jnp.asarray(one))
    wit, wt = _witness(js, p, sd)
    gh, gt, gs, gp = (x.numpy() for x in got)
    rh, rt, rs, rp = (np.asarray(x) for x in ref)
    both = gh & rh
    gap = np.where(both, np.abs(np.where(both, gt - rt, 0.0)), 0.0)
    apart = (gh != rh) | (gap > SHADOW_T_ATOL) | (both & (gp != rp))
    wide = int((gap > ATOL + RTOL * np.abs(rt)).sum())
    print(f"{which} offset {offset}: {len(p)} shadow rays, hits port "
          f"{gh.sum()} JAX {rh.sum()} witness {wit.sum()}; apart on "
          f"{apart.sum()} (masks on {(gh != rh).sum()}; the port's mask "
          f"matching the witness on {(gh == wit)[apart].sum()}, JAX's on "
          f"{(rh == wit)[apart].sum()}); elsewhere t beyond rtol {RTOL} / "
          f"atol {ATOL} on {wide}, largest gap {gap[~apart].max():.3g}; "
          f"masks apart from the witness: the port's on "
          f"{(gh != wit).sum()}, JAX's on {(rh != wit).sum()}; largest t "
          f"gap to it on common hits: the port's "
          f"{np.abs(gt[gh & wit] - wt[gh & wit]).max():.3g}, JAX's "
          f"{np.abs(rt[rh & wit] - wt[rh & wit]).max():.3g}")
    assert gh.any() and not gh.all()
    np.testing.assert_array_equal(gs[both & ~apart], rs[both & ~apart])
    if offset:
        assert not apart.any()
        if which == "dragon":
            np.testing.assert_array_equal(gh, wit)
            assert (np.abs(gt[gh] - wt[gh]) <= SHADOW_T_ATOL).all()
        return
    assert apart.any()
    nearest = np.minimum(np.where(gh, gt, np.inf), np.where(rh, rt, np.inf))
    assert (np.abs(nearest[apart]) <= 1e-6).all()


@pytest.mark.parametrize("which", ["dragon", "mixed"])
def test_traversal_matches_brute_sweep(scenes, which, monkeypatch):
    """Against the port's closest hit without an accel (K3's twin): the
    same hits, t within the tolerance; and the result does not depend on
    how often the finished lanes are dropped."""
    _, ps = scenes[which]
    pb = ptrav.device_bvh(pbvh.build_reference_bvh(ps, sah_binning=True), ps)
    for o, d, tm in _rays(seed=9):
        got = ptrav.bvh_closest_hit(pb, o, d, tm)
        brute = pint.closest_hit(ps, o, d, tm)
        _assert_agree(got, (brute.hit, brute.t, brute.is_sphere,
                            brute.prim))
        monkeypatch.setattr(ptrav, "STEPS_PER_SYNC", 3)
        again = ptrav.bvh_closest_hit(pb, o, d, tm)
        monkeypatch.setattr(ptrav, "STEPS_PER_SYNC", 8)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
