"""The port's hit queries and renders against the JAX package.

The JAX side runs its cluster path in interpret mode
(`intersect.FORCE_CLUSTER_INTERPRET`, as its own tests do) and, with the
accel off, its brute-force XLA sweep; the port runs its kernels' plain
twins on the CPU. Scenes are built once by JAX and
carried across with `interop.scene_from_numpy`, so both trace the same
cluster permutation. Fixtures need nothing outside the repository: the
41x32 dragon stand-in (tools/make_large_asset.py), the same dragon with
two spheres, and the Spheres registry scene.

Image comparisons use test_golden_images.py's rules: NaN masks agree (the
reference's pow quirk makes NaN pixels), and >= 99.5% of pixels are close
(rtol 1e-4, atol 2e-4); a ray that grazes a triangle edge may land on
either side under another rounding order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.ops import intersect as jint
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import cluster_sweep, intersect, sweep
from cge_tpu_torch.render import wavefront
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
HEADLINE = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True,
                enable_accel_structure=True)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "images")
RES = 64


def _port(jscene):
    leaves = {k: np.asarray(getattr(jscene, k)) for k in TENSOR_FIELDS}
    return scene_from_numpy(leaves, all_opaque=jscene.all_opaque,
                            all_diffuse=jscene.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def dragon_obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("render") / "dragon_small.obj")
    write_obj(path, 41, 32)
    return path


@pytest.fixture(scope="module")
def scenes(dragon_obj):
    """(JAX scene, port scene) pairs: the dragon, and the dragon with two
    spheres (one a mirror) so hits mix sphere and triangle ids."""
    dragon = cge_tpu.load_scene_from_file(dragon_obj, [JPointLight(*LIGHT)])
    spheres = [
        SphereDef((0.0, 0.1, 0.0), 0.3,
                  Material(kd=np.float32([0.9, 0.3, 0.2]),
                           ks=np.float32([0.4, 0.4, 0.4]), shininess=12.0)),
        SphereDef((0.55, 0.45, -0.7), 0.2,
                  Material(kd=np.float32([0.2, 0.3, 0.9]))),
    ]
    mixed = build_scene_arrays(load_mesh(dragon_obj), spheres,
                               [JPointLight(*LIGHT)])
    glass = build_scene_arrays(
        load_mesh(dragon_obj),
        [SphereDef((0.0, 0.1, 0.0), 0.3,
                   Material(kd=np.float32([0.9, 0.3, 0.2]),
                            transparency=0.4))], [JPointLight(*LIGHT)])
    return {"dragon": (dragon, _port(dragon)),
            "mixed": (mixed, _port(mixed)),
            "glass": (glass, _port(glass))}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)


def _primary(n_side=32):
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(n_side, n_side, "cpu").reshape(-1, 2))
    return o, d


@pytest.mark.parametrize("which", ["dragon", "mixed"])
def test_closest_hit_matches_jax(scenes, which, interpret):
    """Primary rays (shared origin) and scattered rays from the hit points
    (a third dead): same hits, sphere flags and perm-space ids; t to
    rtol 1e-5 (XLA's FMAs)."""
    js, ps = scenes[which]
    jacc = jint.build_accel(js)
    pacc = intersect.build_accel(ps)
    assert pacc.layout == "triangle"
    o, d = _primary()
    n = o.shape[0]
    inf = torch.full((n,), torch.inf)
    first = intersect.closest_hit(ps, o, d, inf, pacc, shared_origin=True)
    p = o + torch.where(first.hit, first.t - 1e-3, 0.0)[:, None] * d
    rng = np.random.default_rng(7)
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    tm = torch.where(torch.arange(n) % 3 == 0, -1.0, torch.inf)
    for oo, dd, tt, shared in ((o, d, inf, True),
                               (p, torch.from_numpy(sd), tm, False)):
        got = intersect.closest_hit(ps, oo, dd, tt, pacc,
                                    shared_origin=shared, perm_ids=True)
        ref = jint.closest_hit(js, jnp.asarray(oo.numpy()),
                               jnp.asarray(dd.numpy()),
                               jnp.asarray(tt.numpy()), accel=jacc,
                               shared_origin=shared, perm_ids=True)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(got.is_sphere.numpy(),
                                      np.asarray(ref.is_sphere))
        np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
        h = got.hit.numpy()
        np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h],
                                   rtol=1e-5, atol=2e-6)
    if which == "mixed":
        assert first.is_sphere.any() and (first.hit & ~first.is_sphere).any()


@pytest.mark.parametrize("accel,perm_ids", [
    (True, False), (True, True), (False, False), (False, True)])
def test_hit_id_space_matches_jax(scenes, accel, perm_ids, interpret):
    """closest_hit and closest_hit_chunked (300-ray chunks) against JAX's
    on the mixed scene's primary rays, JAX's accel path in interpret
    mode: with an accel, scene-order triangle ids by default and
    perm-space slots under perm_ids; without one, scene-order ids either
    way. Hits, sphere flags and ids on hits equal; t to rtol 1e-5 / atol
    2e-6."""
    js, ps = scenes["mixed"]
    jacc = jint.build_accel(js) if accel else None
    pacc = intersect.build_accel(ps) if accel else None
    o, d = _primary()
    tm = torch.where(torch.arange(o.shape[0]) % 7 == 0, -1.0, torch.inf)
    jo, jd, jt = (jnp.asarray(x.numpy()) for x in (o, d, tm))
    ref = jint.closest_hit(js, jo, jd, jt, accel=jacc, perm_ids=perm_ids)
    ref_chunked = jint.closest_hit_chunked(js, jo, jd, jt, 300, accel=jacc,
                                           perm_ids=perm_ids)
    got = intersect.closest_hit(ps, o, d, tm, pacc, perm_ids=perm_ids)
    got_chunked = intersect.closest_hit_chunked(ps, o, d, tm, 300,
                                                accel=pacc, perm_ids=perm_ids)
    for mine, theirs in ((got, ref), (got_chunked, ref_chunked)):
        h = mine.hit.numpy()
        np.testing.assert_array_equal(h, np.asarray(theirs.hit))
        np.testing.assert_array_equal(mine.is_sphere.numpy(),
                                      np.asarray(theirs.is_sphere))
        np.testing.assert_array_equal(mine.prim.numpy()[h],
                                      np.asarray(theirs.prim)[h])
        np.testing.assert_allclose(mine.t.numpy()[h], np.asarray(theirs.t)[h],
                                   rtol=1e-5, atol=2e-6)
    tri = got.hit & ~got.is_sphere
    assert tri.any() and got.is_sphere.any()
    if accel and not perm_ids:
        slots = intersect.closest_hit(ps, o, d, tm, pacc, perm_ids=True)
        np.testing.assert_array_equal(
            got.prim[tri].numpy(),
            pacc.perm.reshape(-1)[slots.prim[tri]].numpy())
        assert (got.prim[tri] != slots.prim[tri]).any()


def test_shadow_query_keeps_spheres_forward(scenes, interpret):
    """test_bvh.py:293-329's case on the mixed scene: a sphere beyond the
    light blocks the forward budget-1 segment through the a == 1 quadratic
    quirk and clears it reversed. The reversed triangle query must still
    report it blocked, as the JAX package does."""
    js, ps = scenes["mixed"]
    js = js.__class__(**{**js.__dict__,
                         "sph_center": js.sph_center.at[1].set(
                             jnp.asarray([0.0, 5.0, 4.0])),
                         "sph_radius": js.sph_radius.at[1].set(1.5)})
    ps = _port(js)
    p = torch.tensor([[0.0, 5.0, 0.0]])
    light = torch.tensor([[0.0, 5.0, 2.0]])
    one = torch.ones(1)
    acc = intersect.build_accel(ps)
    fwd = intersect.closest_hit(ps, p, light - p, one, acc)
    assert bool(fwd.hit[0]) and bool(fwd.is_sphere[0])
    got = intersect.any_hit_occlusion(ps, p, light - p, one, acc,
                                      tri_rays=(light, p - light))
    ref = jint.any_hit_occlusion(
        js, jnp.asarray(p.numpy()), jnp.asarray((light - p).numpy()),
        jnp.ones(1), accel=jint.build_accel(js),
        tri_rays=(jnp.asarray(light.numpy()),
                  jnp.asarray((p - light).numpy())))
    assert bool(got[0]) and bool(np.asarray(ref)[0])


def test_shadow_rays_match_jax(scenes, interpret):
    """Reversed shadow rays from the dragon's hit points to the light, with
    the spheres tested forward: the same blocked set."""
    js, ps = scenes["mixed"]
    acc = intersect.build_accel(ps)
    o, d = _primary()
    ids = intersect.closest_hit(ps, o, d, torch.full((o.shape[0],),
                                                     torch.inf), acc)
    p = o + torch.where(ids.hit, ids.t - 1e-3, 0.0)[:, None] * d
    light = torch.tensor(LIGHT[0]).expand_as(p)
    tm = torch.where(ids.hit, 1.0, -1.0)
    got = intersect.any_hit_occlusion(ps, p, light - p, tm, acc,
                                      tri_rays=(light, p - light))
    ref = jint.any_hit_occlusion(
        js, jnp.asarray(p.numpy()), jnp.asarray((light - p).numpy()),
        jnp.asarray(tm.numpy()), accel=jint.build_accel(js),
        tri_rays=(jnp.asarray(light.numpy()),
                  jnp.asarray((p - light).numpy())))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got[ids.hit].all()


def test_hit_attributes_clamp_mixed_ids(scenes):
    """Triangle slots index past the sphere table and sphere ids into the
    row table: the gathers clamp like JAX's, and shading sees the right
    material either way."""
    _, ps = scenes["mixed"]
    acc = intersect.build_accel(ps)
    tables = wavefront.pack_attr_table(ps, tri_ids=acc.perm)
    o, d = _primary()
    ids = intersect.closest_hit(ps, o, d, torch.full((o.shape[0],),
                                                     torch.inf), acc,
                                perm_ids=True)
    assert int(ids.prim[~ids.is_sphere].max()) >= ps.sph_center.shape[0]
    attrs = wavefront.hit_attributes(ps, o, d, ids, ct.Features(**HEADLINE),
                                     tables)
    sph = ids.is_sphere
    np.testing.assert_array_equal(attrs.kd[sph].numpy(),
                                  ps.mat_kd[ps.sph_mat[ids.prim[sph]]].numpy())
    tri = ids.hit & ~sph
    np.testing.assert_array_equal(attrs.kd[tri].numpy(),
                                  tables[ids.prim[tri], 18:21].numpy())


def _compare(img, ref, min_frac=0.995):
    ref_nan, img_nan = ~np.isfinite(ref), ~np.isfinite(img)
    assert (ref_nan == img_nan).mean() > 0.999
    both = ~ref_nan & ~img_nan
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    frac = close.all(axis=-1).mean()
    assert frac >= min_frac, f"{frac:.4%} pixels close"


FLAT_MIRRORS = dict(enable_shading=True, enable_recursive=True,
                    enable_accel_structure=True)
SEE_THROUGH = dict(enable_shading=True, enable_transparency=True,
                   enable_accel_structure=True)


@pytest.mark.parametrize("which,w,h,features", [
    ("dragon", RES, RES, HEADLINE),
    ("mixed", RES, RES, HEADLINE),
    ("dragon", 40, 36, HEADLINE),
    ("mixed", RES, RES, FLAT_MIRRORS),
    ("glass", RES, RES, SEE_THROUGH)])
def test_render_image_matches_jax(scenes, which, w, h, features, interpret):
    """With trace_chunk=1024: the headline feature set at 64x64 is four
    chunks, each carrying its global ray ids, through the 32x16 tile
    swizzle; 40x36 takes the gather swizzle of ragged sizes and pads its
    last chunk. Geometric normals with mirrors, and the transparency
    continuation chain through a see-through sphere (no shadows: the
    transparency shadow is not ported), cover the chain's other
    branches."""
    js, ps = scenes[which]
    params = dict(trace_chunk=1024)
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(), cge_tpu.Features(**features),
        cge_tpu.RenderParams(**params), w, h))
    img = ct.render_image(ps, ct.Camera(), ct.Features(**features),
                          ct.RenderParams(**params), w, h)
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    assert np.nanmax(ref) > 0.05
    _compare(img.numpy(), ref)


def test_render_image_u8_matches_jax(scenes, interpret):
    """The quantized framebuffer: >= 99.5% of pixels within one level (a
    value that lands on a level boundary may round either way)."""
    js, ps = scenes["dragon"]
    ref = np.asarray(cge_tpu.render_image_u8(
        js, cge_tpu.Camera(), cge_tpu.Features(**HEADLINE),
        cge_tpu.RenderParams(trace_chunk=1024), RES, RES))
    img = ct.render_image_u8(ps, ct.Camera(), ct.Features(**HEADLINE),
                             ct.RenderParams(trace_chunk=1024), RES, RES)
    assert img.dtype == torch.uint8 and img.shape == ref.shape
    diff = np.abs(img.numpy().astype(int) - ref.astype(int)).max(axis=-1)
    assert (diff <= 1).mean() >= 0.995
    assert ref.max() > 10


def test_chunking_does_not_change_the_image(scenes):
    """1024-ray chunks and one chunk trace the same 512-ray blocks, so the
    images are equal."""
    _, ps = scenes["dragon"]
    f = ct.Features(**HEADLINE)
    a = ct.render_image(ps, ct.Camera(), f, ct.RenderParams(trace_chunk=1024),
                        RES, RES)
    b = ct.render_image(ps, ct.Camera(), f, ct.RenderParams(), RES, RES)
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("knob", [
    dict(sweep_shared_origin=False), dict(sweep_shadow_reverse=False),
    dict(sweep_sc_n=4, sweep_anyhit_sc_n=2), dict(sweep_br=128)])
def test_sweep_knobs_keep_the_image(scenes, knob):
    """Knobs that change how the sweep runs, not what it finds: the
    shared-origin hoist, the reversed shadow query, clusters per visit and
    rays per block give the default image under the image rules."""
    _, ps = scenes["mixed"]
    f = ct.Features(**HEADLINE)
    base = ct.render_image(ps, ct.Camera(), f, ct.RenderParams(), 32, 32)
    img = ct.render_image(ps, ct.Camera(), f, ct.RenderParams(**knob), 32, 32)
    _compare(img.numpy(), base.numpy())


def _golden(name):
    raw = np.fromfile(os.path.join(GOLDEN_DIR, f"{name}.raw"),
                      dtype=np.float32)
    w, h = raw[:2].view(np.int32)
    return raw[2:].reshape(int(h), int(w), 3)


@pytest.mark.parametrize("name,features,min_frac", [
    ("spheres_shading", dict(enable_shading=True), 0.995),
    # rays grazing a sphere silhouette flip shadow state on ulp-level
    # quadratic differences (test_golden_images.py's MIN_FRAC)
    ("spheres_shadow", dict(enable_shading=True, enable_hard_shadow=True),
     0.99)])
def test_spheres_goldens(name, features, min_frac):
    """The compiled reference's Spheres images with the feature sets they
    were made with (test_golden_images.py:45-46, accel off): the
    brute-force sweep over the scene's 8 masked pad rows, then the
    spheres."""
    ref = _golden(name)
    h, w = ref.shape[:2]
    scene = ct.load_scene_prebuilt(ct.SceneType.Spheres, device="cpu")
    before = sweep.LAUNCHES["sweep"]
    img = ct.render_image(scene, ct.Camera(aspect=w / h),
                          ct.Features(**features), ct.RenderParams(), w, h)
    assert sweep.LAUNCHES["sweep"] == before      # CPU: the twin ran
    _compare(img.numpy(), ref, min_frac)


# accel-off feature sets: the defaults' brute-force sweep (K3)
BRUTE = {k: v for k, v in HEADLINE.items() if k != "enable_accel_structure"}


@pytest.mark.parametrize("which", ["dragon", "mixed"])
def test_closest_hit_without_accel_matches_jax(scenes, which):
    """The brute-force branch (K3's twin, scene-order ids) against JAX's
    brute closest hit (jint.closest_hit(use_pallas=False)): primary rays
    and scattered rays from the hit points, a third dead. Hits, sphere
    flags and ids are equal; t to rtol 1e-5 / atol 2e-6 (JAX's brute path
    computes o.n and d.n as HIGHEST-precision matmuls)."""
    js, ps = scenes[which]
    o, d = _primary()
    n = o.shape[0]
    inf = torch.full((n,), torch.inf)
    first = intersect.closest_hit(ps, o, d, inf)
    p = o + torch.where(first.hit, first.t - 1e-3, 0.0)[:, None] * d
    rng = np.random.default_rng(11)
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    tm = torch.where(torch.arange(n) % 3 == 0, -1.0, torch.inf)
    for oo, dd, tt in ((o, d, inf), (p, torch.from_numpy(sd), tm)):
        got = intersect.closest_hit(ps, oo, dd, tt)
        ref = jint.closest_hit(js, jnp.asarray(oo.numpy()),
                               jnp.asarray(dd.numpy()),
                               jnp.asarray(tt.numpy()), use_pallas=False)
        np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
        np.testing.assert_array_equal(got.is_sphere.numpy(),
                                      np.asarray(ref.is_sphere))
        np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
        h = got.hit.numpy()
        np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h],
                                   rtol=1e-5, atol=2e-6)
    if which == "mixed":
        assert first.is_sphere.any() and (first.hit & ~first.is_sphere).any()


def test_shadow_rays_without_accel_match_jax(scenes):
    """Forward shadow rays from the hit points to the light, with no accel:
    the closest-hit fallback of both packages gives the same blocked set."""
    js, ps = scenes["mixed"]
    o, d = _primary()
    ids = intersect.closest_hit(ps, o, d, torch.full((o.shape[0],),
                                                     torch.inf))
    p = o + torch.where(ids.hit, ids.t - 1e-3, 0.0)[:, None] * d
    light = torch.tensor(LIGHT[0]).expand_as(p)
    tm = torch.where(ids.hit, 1.0, -1.0)
    got = intersect.any_hit_occlusion(ps, p, light - p, tm)
    ref = jint.any_hit_occlusion(js, jnp.asarray(p.numpy()),
                                 jnp.asarray((light - p).numpy()),
                                 jnp.asarray(tm.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got[ids.hit].all()


@pytest.mark.parametrize("which,w,h", [
    ("dragon", RES, RES), ("mixed", RES, RES), ("dragon", 40, 36)])
def test_render_without_accel_matches_jax(scenes, which, w, h):
    """The default accel-off render (K3's twin for closest hits and
    shadows, scene-ordered attribute rows) against JAX render_image with
    the accel off, under the image rules; 40x36 takes the gather swizzle
    and a padded last chunk."""
    js, ps = scenes[which]
    params = dict(trace_chunk=1024)
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(), cge_tpu.Features(**BRUTE),
        cge_tpu.RenderParams(**params), w, h))
    ctx = ct.prepare_render(ps, ct.Features(**BRUTE), ct.RenderParams())
    assert ctx.accel is None and ctx.tri_table.shape == (ps.tris.shape[0], 16)
    assert ctx.tables.shape[0] == ps.tris.shape[0]
    img = ct.render_image(ps, ct.Camera(), ct.Features(**BRUTE),
                          ct.RenderParams(**params), w, h, ctx=ctx)
    assert img.shape == (h, w, 3) and not img.requires_grad
    assert np.nanmax(ref) > 0.05
    _compare(img.numpy(), ref)


@pytest.mark.parametrize("which", ["dragon", "mixed"])
def test_accel_on_and_off_render_alike(scenes, which, interpret):
    """The same scene with the accel on (cluster sweep, perm-ordered rows)
    and off (brute sweep, scene-ordered rows): the same image under the
    image rules. Shading with rows of the other id space would not be."""
    _, ps = scenes[which]
    p = ct.RenderParams(trace_chunk=1024)
    on = ct.render_image(ps, ct.Camera(), ct.Features(**HEADLINE), p, 48, 32)
    off = ct.render_image(ps, ct.Camera(), ct.Features(**BRUTE), p, 48, 32)
    _compare(off.numpy(), on.numpy())


@pytest.mark.cuda
def test_render_on_card_matches_cpu(scenes):
    """The kernels on the card against the twins on the CPU: the same
    image up to the rounding of the surrounding torch ops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    _, ps = scenes["mixed"]
    gpu = scene_from_numpy(
        {k: getattr(ps, k).numpy() for k in TENSOR_FIELDS},
        all_opaque=ps.all_opaque, all_diffuse=ps.all_diffuse, device="cuda")
    f, p = ct.Features(**HEADLINE), ct.RenderParams(trace_chunk=1024)
    a = ct.render_image(gpu, ct.Camera(), f, p, RES, RES).cpu().numpy()
    b = ct.render_image(ps, ct.Camera(), f, p, RES, RES).numpy()
    _compare(a, b)


@pytest.mark.cuda
def test_render_without_accel_on_card_matches_cpu(scenes):
    """The accel-off render on the card runs K3 (and neither cluster
    kernel) and matches the twin's render on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    _, ps = scenes["mixed"]
    gpu = scene_from_numpy(
        {k: getattr(ps, k).numpy() for k in TENSOR_FIELDS},
        all_opaque=ps.all_opaque, all_diffuse=ps.all_diffuse, device="cuda")
    f, p = ct.Features(**BRUTE), ct.RenderParams(trace_chunk=1024)
    before = (sweep.LAUNCHES["sweep"], dict(cluster_sweep.LAUNCHES))
    a = ct.render_image(gpu, ct.Camera(), f, p, RES, RES).cpu().numpy()
    assert sweep.LAUNCHES["sweep"] > before[0]
    assert cluster_sweep.LAUNCHES == before[1]
    b = ct.render_image(ps, ct.Camera(), f, p, RES, RES).numpy()
    _compare(a, b)
