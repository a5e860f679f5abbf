"""The transparency shadow, the TRANS+REC tree, glossy reflections and
batched cameras of the port against the JAX package.

Scenes: the 41x32 stand-in (tools/make_large_asset.py) with its material
variants (cge_tpu_torch/tools/common.write_variant_obj): "glass" (the body
at d 0.45, Ks kept) with a transparent mirror sphere and a transparent
diffuse sphere; "diffuse_glass" (Ks 0 and d 0.45 everywhere, bench.py's
transrec shape), whose tree collapses to one child; "glossy" (the belly at
Ns 0) with a mirror sphere of shininess 20 and a ks == 0 sphere. Each is
built by JAX and carried across with `interop.scene_from_numpy`; the JAX
side runs its cluster path in interpret mode with the accel on and its
brute XLA sweep with it off.

Images compare under the image rules of test_torch_render.py: NaN masks
agree on > 99.9% of pixels and >= 99.5% of pixels are within rtol 1e-4 /
atol 2e-4. Both packages draw from the same threefry streams
(tests/test_torch_rng.py), so soft shadows and cone samples compare pixel
by pixel; a chunked render equals the unchunked one exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.ops import intersect as jint
from cge_tpu.render import lights as jlights
from cge_tpu.render import wavefront as jwf
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import ParallelogramLight as JParLight
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import intersect, rng
from cge_tpu_torch.render import lights, wavefront
from cge_tpu_torch.tools.common import write_variant_obj

torch.set_num_threads(2)

POINT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
PAR = ((-1.2, 1.0, -1.2), (0.4, 0.0, 0.0), (0.0, 0.0, 0.4), (1.0, 0.2, 0.2),
       (0.2, 1.0, 0.2), (0.2, 0.2, 1.0), (1.0, 1.0, 0.2))
SEED = 3
RES = 32
TREE = dict(enable_shading=True, enable_hard_shadow=True,
            enable_recursive=True, enable_transparency=True,
            enable_normal_interp=True)
TREE_PARAMS = dict(ray_depth=3, extra_transparency_unroll=2)
GLOSSY = dict(enable_shading=True, enable_hard_shadow=True,
              enable_recursive=True, enable_glossy_reflection=True,
              enable_normal_interp=True)
GLOSSY_PARAMS = dict(ray_depth=2, rays_per_reflection=4)


def _port(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k))
                             for k in TENSOR_FIELDS},
                            all_opaque=js.all_opaque,
                            all_diffuse=js.all_diffuse, device="cpu")


GLASS_SPHERES = [
    SphereDef((0.0, 0.1, 0.0), 0.3,
              Material(kd=np.float32([0.9, 0.3, 0.2]),
                       ks=np.float32([0.5, 0.5, 0.5]), shininess=12.0,
                       transparency=0.4)),
    SphereDef((-0.3, 0.55, -0.5), 0.15,
              Material(kd=np.float32([0.2, 0.3, 0.9]), transparency=0.7)),
]
GLOSSY_SPHERES = [
    SphereDef((0.0, 0.1, 0.0), 0.3,
              Material(kd=np.float32([0.9, 0.3, 0.2]),
                       ks=np.float32([0.6, 0.6, 0.6]), shininess=20.0)),
    # ks == 0: the zero mirror sentinel under a shininess that is not 0
    SphereDef((0.55, 0.45, -0.7), 0.2,
              Material(kd=np.float32([0.2, 0.3, 0.9]), shininess=8.0)),
]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for variant, spheres, lights_ in (
            ("glass", GLASS_SPHERES, [JPointLight(*POINT)]),
            ("diffuse_glass", (), [JPointLight(*POINT)]),
            ("glossy", GLOSSY_SPHERES, [JPointLight(*POINT)]),
            ("glass", GLASS_SPHERES, [JParLight(*PAR)])):
        path = str(tmp_path_factory.mktemp(variant) / "standin.obj")
        write_variant_obj(path, 41, 32, variant)
        js = build_scene_arrays(load_mesh(path), spheres, lights_)
        name = variant if variant not in out else "glass_soft"
        out[name] = (js, _port(js))
    assert not out["glass"][0].all_opaque and not out["glass"][0].all_diffuse
    assert out["diffuse_glass"][0].all_diffuse
    return out


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)


def _compare(img, ref, min_frac=0.995):
    ref_nan, img_nan = ~np.isfinite(ref), ~np.isfinite(img)
    assert (ref_nan == img_nan).mean() > 0.999
    both = ~ref_nan & ~img_nan
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    frac = close.all(axis=-1).mean()
    assert frac >= min_frac, f"{frac:.4%} pixels close"


def _both(scenes, which, feats, params, res=RES, seed=SEED):
    js, ps = scenes[which]
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(),
        cge_tpu.Features(**feats), cge_tpu.RenderParams(**params), res, res,
        seed))
    img = ct.render_image(ps, ct.Camera(), ct.Features(**feats),
                          ct.RenderParams(**params), res, res, seed)
    assert img.shape == (res, res, 3) and img.dtype == torch.float32
    return img.numpy(), ref


# ---------------------------------------------------------------------------
# transparency shadows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accel", [False, True])
def test_transparency_shadow_matches_jax(scenes, accel, interpret):
    """shadow_visibility with transparency on, from the primary hits to
    the point light: the closest blocker's transparency, triangle (0.45)
    and sphere (0.4) blockers among them, the same on both packages
    (the accel's perm-space hit ids go back to scene triangles before the
    material gather). Dead rays and misses see 1."""
    js, ps = scenes["glass"]
    feats = ct.Features(**TREE)
    params = ct.RenderParams()
    pacc = intersect.build_accel(ps) if accel else None
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(RES, RES, "cpu").reshape(-1, 2))
    ids = intersect.closest_hit(ps, o, d, torch.full((o.shape[0],),
                                                     torch.inf), pacc)
    t = torch.where(ids.hit, ids.t, 0.0)
    alive = ids.hit & (torch.arange(o.shape[0]) % 5 != 0)
    pos = torch.tensor(POINT[0]).expand_as(o)
    got = lights.shadow_visibility(
        ps, o, d, t, pos, feats, params, alive, pacc,
        None if accel else wavefront.scene_tri_table(ps, None)).numpy()
    want = np.asarray(jlights.shadow_visibility(
        js, *(jnp.asarray(x.numpy()) for x in (o, d, t, pos)),
        cge_tpu.Features(**TREE), cge_tpu.RenderParams(),
        jnp.asarray(alive.numpy()),
        jint.build_accel(js) if accel else None))
    assert (got == want).mean() >= 0.995
    for blocker in (np.float32(0.45), np.float32(0.4), 1.0):
        assert (got == blocker).any(), blocker
    assert (got[~alive.numpy()] == 1.0).all()


@pytest.mark.parametrize("accel", [False, True])
def test_transparency_chain_with_shadows_matches_jax(scenes, accel,
                                                     interpret):
    """The transparency-only chain (recursion off) with hard shadows: the
    depth-gated continuation, each level's shadow the closest blocker's
    transparency."""
    feats = dict(enable_shading=True, enable_hard_shadow=True,
                 enable_transparency=True, enable_normal_interp=True,
                 enable_accel_structure=accel)
    img, ref = _both(scenes, "glass", feats, dict(ray_depth=3))
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)


# ---------------------------------------------------------------------------
# the TRANS+REC tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accel", [False, True])
def test_trans_rec_tree_matches_jax(scenes, accel, interpret):
    """The two-child tree (mirror and continuation children folded into
    the ray axis) at ray_depth 3, then the t != 1 tail of 1 + 2 levels,
    against JAX render_image."""
    img, ref = _both(scenes, "glass", dict(TREE, enable_accel_structure=accel),
                     TREE_PARAMS)
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)


def test_all_diffuse_tree_collapses(scenes, interpret):
    """bench.py's transrec shape (Ks 0, d 0.45 everywhere): the collapsed
    single-child tree equals the port's generic two-child tree bit for bit
    (the dropped mirror children add exact zeros) and JAX's render under
    the image rules."""
    js, ps = scenes["diffuse_glass"]
    feats = dict(TREE, enable_accel_structure=True)
    img, ref = _both(scenes, "diffuse_glass", feats, TREE_PARAMS)
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)
    generic = ct.render_image(dataclasses.replace(ps, all_diffuse=False),
                              ct.Camera(), ct.Features(**feats),
                              ct.RenderParams(**TREE_PARAMS), RES, RES, SEED)
    torch.testing.assert_close(torch.from_numpy(img), generic, rtol=0,
                               atol=0, equal_nan=True)


def test_tree_soft_shadows_draw_jax_streams(scenes, interpret):
    """Soft shadows from a parallelogram light on the tree: the children's
    global ids 2i and 2i + 1 (the tail's rays, from level 1) key their
    samples as JAX's do, so the images agree; another seed gives another
    image."""
    feats = dict(TREE, enable_hard_shadow=False, enable_soft_shadow=True,
                 enable_accel_structure=True)
    params = dict(ray_depth=1, extra_transparency_unroll=1)
    img, ref = _both(scenes, "glass_soft", feats, params, res=16)
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)
    _, ps = scenes["glass_soft"]
    other = ct.render_image(ps, ct.Camera(), ct.Features(**feats),
                            ct.RenderParams(**params), 16, 16, SEED + 1)
    assert np.nanmax(np.abs(other.numpy() - img)) > 1e-3


# ---------------------------------------------------------------------------
# glossy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accel", [False, True])
def test_glossy_matches_jax(scenes, accel, interpret):
    """Four cone samples a reflection, two levels: the body's cone (Ns
    28), the belly's plain mirror (Ns 0), the mirror sphere's cone and the
    ks == 0 sphere's zero sentinel, against JAX render_image with the same
    seed; another seed gives another image."""
    feats = dict(GLOSSY, enable_accel_structure=accel)
    img, ref = _both(scenes, "glossy", feats, GLOSSY_PARAMS)
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)
    _, ps = scenes["glossy"]
    other = ct.render_image(ps, ct.Camera(), ct.Features(**feats),
                            ct.RenderParams(**GLOSSY_PARAMS), RES, RES,
                            SEED + 1)
    assert np.nanmax(np.abs(other.numpy() - img)) > 1e-3


def _sample_inputs():
    """Mirror directions with ties and zeros, normals and shininess."""
    g = np.random.default_rng(11)
    md = g.normal(size=(24, 3)).astype(np.float32)
    md[0] = (0.6, -0.4, -0.4)         # tied minimum: the first one counts
    md[1] = (-0.5, -0.5, 0.7)
    md[2] = (0.0, 0.0, 0.0)           # the ks == 0 sentinel
    md[3] = (0.3, 0.3, 0.3)           # all three tied
    n = g.normal(size=(24, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    sh = np.float32([0.0, 5.0, 30.0])[np.arange(24) % 3]
    return md, n, sh


def test_glossy_sample_dirs_match_jax():
    """_glossy_sample_dirs alone: 6 cone samples for 24 mirror directions,
    including tied minimum components (torch.argmin and jnp.argmin both
    take the first) and the zero sentinel (0 directions on both). Directions
    to atol 1e-6 (XLA's FMAs); `above` equal wherever |n . dir| > 1e-5."""
    md, n, sh = _sample_inputs()
    ids = np.arange(100, 124)
    params = ct.RenderParams(alpha_modifier=0.7)
    attrs = wavefront.HitAttrs(
        hit=None, t=None, normal=torch.from_numpy(n), kd=None, ks=None,
        shininess=torch.from_numpy(sh), transparency=None)
    got_d, got_a = wavefront._glossy_sample_dirs(
        attrs, torch.from_numpy(md), 6, params, rng.prng_key(9),
        torch.from_numpy(ids))
    jattrs = jwf.HitAttrs(hit=None, t=None, normal=jnp.asarray(n), kd=None,
                          ks=None, shininess=jnp.asarray(sh),
                          transparency=None)
    want_d, want_a = jwf._glossy_sample_dirs(
        jattrs, jnp.asarray(md), 6, cge_tpu.RenderParams(alpha_modifier=0.7),
        jax.random.PRNGKey(9), jnp.asarray(ids, jnp.int32))
    want_d, want_a = np.asarray(want_d), np.asarray(want_a)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-6)
    assert (got_d[2] == 0).all()
    clear = np.abs(np.einsum("nk,nsk->ns", n, want_d)) > 1e-5
    np.testing.assert_array_equal(got_a.numpy()[clear], want_a[clear])
    w = md[[0, 1, 3]] / np.linalg.norm(md[[0, 1, 3]], axis=1, keepdims=True)
    u, v, ok = wavefront._orthonormal_cone_basis(torch.from_numpy(w))
    ju, jv = jwf._orthonormal_cone_basis(jnp.asarray(w))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
    assert ok.all()


# ---------------------------------------------------------------------------
# chunking and batched cameras
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,feats,params,res,chunk", [
    ("glass_soft", dict(TREE, enable_hard_shadow=False,
                        enable_soft_shadow=True, enable_accel_structure=True),
     dict(ray_depth=2, extra_transparency_unroll=1), 16, 64),
    ("glass", dict(TREE), TREE_PARAMS, 16, 96),
    ("glossy", dict(GLOSSY, enable_accel_structure=True), GLOSSY_PARAMS, 16,
     64)])
def test_chunking_does_not_change_the_tree_or_glossy(scenes, which, feats,
                                                     params, res, chunk):
    """`chunk`-ray chunks (the last one padded where the chunk does not
    divide the frame) and one chunk: equal images, NaN equal to NaN."""
    assert res * res >= 2 * chunk
    _, ps = scenes[which]
    f = ct.Features(**feats)
    a = ct.render_image(ps, ct.Camera(), f,
                        ct.RenderParams(trace_chunk=chunk, **params), res,
                        res, SEED)
    b = ct.render_image(ps, ct.Camera(), f, ct.RenderParams(**params), res,
                        res, SEED)
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert float(torch.nan_to_num(b).max()) > 0.05


CAMERAS = (dict(), dict(distance=2.6, rotation=(0.5, -0.4, 0.0)))


def test_render_images_matches_jax(scenes, interpret):
    """Two cameras with soft shadows: camera i renders with seed + i, as
    JAX's lax.map over cameras does; the batch equals the port's own
    render_image calls bit for bit, and its u8 form render_image_u8's."""
    js, ps = scenes["glass_soft"]
    feats = dict(enable_shading=True, enable_soft_shadow=True,
                 enable_normal_interp=True, enable_accel_structure=True)
    res = 16
    jcams = cge_tpu.stack_cameras([cge_tpu.Camera(**c) for c in CAMERAS])
    ref = np.asarray(cge_tpu.render_images(
        js, jcams, cge_tpu.Features(**feats), cge_tpu.RenderParams(), res,
        res, SEED))
    cams = ct.stack_cameras(ct.Camera(**c) for c in CAMERAS)
    f, p = ct.Features(**feats), ct.RenderParams()
    imgs = ct.render_images(ps, cams, f, p, res, res, SEED)
    assert imgs.shape == (2, res, res, 3)
    for i, cam in enumerate(cams):
        _compare(imgs[i].numpy(), ref[i])
        one = ct.render_image(ps, cam, f, p, res, res, SEED + i)
        torch.testing.assert_close(imgs[i], one, rtol=0, atol=0,
                                   equal_nan=True)
        assert np.nanmax(ref[i]) > 0.05
    assert not torch.equal(torch.nan_to_num(imgs[0]),
                           torch.nan_to_num(imgs[1]))
    u8 = ct.render_images_u8(ps, cams, f, p, res, res, SEED)
    assert u8.dtype == torch.uint8
    assert torch.equal(u8[1], ct.render_image_u8(ps, cams[1], f, p, res, res,
                                                 SEED + 1))
