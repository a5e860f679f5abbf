"""Texture mapping in the port (cge_tpu_torch/ops/texture.py and the texture
branch of render/wavefront.hit_attributes) against the JAX package.

Texel lookups: nearest texels equal JAX's exactly, bilinear ones and
their gradients to textures and uv within rtol 1e-6 / atol 1e-6 (XLA:CPU
may contract the lerps into FMAs), on seeded uv with negative u, u > 1 and
NaN over a stack of two textures of different sizes. Hit attributes on the
textured stand-in's primary hits: nearest kd equal to JAX's, bilinear kd
within atol 1e-4 (the barycentrics, with JAX's FMAs, differ in the last
bits, and the seeded texture changes by up to 1 a texel, 96 texels a unit
of u). Renders:
the 41x32 stand-in (tools/make_large_asset.py) with its body textured
through `map_Kd` by a non-square PNG written in tmp_path
(tools/common.write_textured_obj), both filters, accel on (JAX in
interpret mode) and off, under the image rules of test_torch_render.py:
NaN masks agree and >= 99.5% of pixels are within rtol 1e-4 / atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.ops import intersect as jint
from cge_tpu.ops import texture as jtex
from cge_tpu.render import wavefront as jwave
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.ops import intersect, texture
from cge_tpu_torch.render import wavefront
from cge_tpu_torch.tools.common import write_textured_obj

torch.set_num_threads(2)

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
TEXTURED = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True,
                enable_texture_mapping=True)


@pytest.fixture(scope="module")
def stack():
    """Two textures, 5x7 and 4x3, padded into one [2, 5, 7, 3] stack."""
    rng = np.random.default_rng(1)
    tex = np.zeros((2, 5, 7, 3), np.float32)
    tex[0] = rng.uniform(size=(5, 7, 3))
    tex[1, :4, :3] = rng.uniform(size=(4, 3, 3))
    hw = np.array([[5, 7], [4, 3]], np.int32)
    n = 400
    uv = rng.uniform(-0.6, 1.6, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [-0.25, 0.5], [1.5, -0.3], [np.nan, 0.2],
              [0.3, np.nan], [np.nan, np.nan], [0.999999, 1e-7]]
    tex_id = rng.integers(-1, 2, n).astype(np.int32)
    return tex, hw, uv, tex_id


def _port_args(tex, hw, uv, tex_id):
    return (torch.from_numpy(tex), torch.from_numpy(hw.astype(np.int64)),
            torch.from_numpy(tex_id.astype(np.int64)), torch.from_numpy(uv))


@pytest.mark.parametrize("bilinear", [False, True])
def test_acquire_texel_matches_jax(stack, bilinear):
    tex, hw, uv, tex_id = stack
    want = np.asarray(jtex.acquire_texel(jnp.asarray(tex), jnp.asarray(hw),
                                         jnp.asarray(tex_id),
                                         jnp.asarray(uv), bilinear))
    got = texture.acquire_texel(*_port_args(tex, hw, uv, tex_id),
                                bilinear).numpy()
    if bilinear:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.isnan(got[4:7]).all() and np.isnan(want[4:7]).all()
    else:
        np.testing.assert_array_equal(got, want)
        # a NaN uv reads texel (0, 0), as JAX's clamped gather does
        np.testing.assert_array_equal(got[6], tex[max(tex_id[6], 0), 0, 0])


def test_bilinear_gradients_match_jax(stack):
    """d(sum w * texel) by the texels (index_add_ of the gathers) and by
    uv (through the fmod splits), on the rows with finite uv."""
    tex, hw, uv, tex_id = stack
    fin = np.isfinite(uv).all(axis=1)
    uv, tex_id = uv[fin], tex_id[fin]
    w = np.random.default_rng(2).normal(size=(uv.shape[0], 3)).astype(
        np.float32)

    def jloss(t, u):
        return jnp.sum(jnp.asarray(w) * jtex.acquire_texel(
            t, jnp.asarray(hw), jnp.asarray(tex_id), u, True))

    jg_t, jg_u = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tex),
                                                 jnp.asarray(uv))
    t, h, i, u = _port_args(tex, hw, uv, tex_id)
    t.requires_grad_(True)
    u.requires_grad_(True)
    (torch.from_numpy(w) * texture.acquire_texel(t, h, i, u, True)).sum() \
        .backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_t), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(jg_u), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(u.grad.numpy()).max() > 0


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX scene, port scene) of the textured 41x32 stand-in, the port's
    loaded from the files by its own loader (its PNG decoder)."""
    path = str(tmp_path_factory.mktemp("tex") / "dragon_tex.obj")
    write_textured_obj(path, 41, 32)
    js = cge_tpu.load_scene_from_file(path, [JPointLight(*LIGHT)])
    ps = ct.load_scene_from_file(path, [ct.PointLight(*LIGHT)], device="cpu")
    for k in TENSOR_FIELDS:
        if k != "cluster_perm":
            np.testing.assert_array_equal(
                getattr(ps, k).numpy(),
                np.asarray(getattr(js, k)).astype(getattr(ps, k).numpy()
                                                  .dtype), k)
    # the same cluster permutation on both sides
    ps = scene_from_numpy({k: np.asarray(getattr(js, k))
                           for k in TENSOR_FIELDS},
                          all_opaque=js.all_opaque,
                          all_diffuse=js.all_diffuse, device="cpu")
    return js, ps


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)


@pytest.mark.parametrize("bilinear", [False, True])
def test_hit_attributes_with_texture_match_jax(scenes, bilinear):
    """Primary hits of the textured stand-in through the perm-ordered rows
    of the accel: kd is the texel on the body, the material's kd on the
    belly, as JAX's."""
    js, ps = scenes
    f = dict(TEXTURED, enable_accel_structure=True,
             enable_bilinear_texture_filtering=bilinear)
    acc = intersect.build_accel(ps)
    tables = wavefront.pack_attr_table(ps, tri_ids=acc.perm)
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(32, 32, "cpu").reshape(-1, 2))
    ids = intersect.closest_hit(ps, o, d, torch.full((o.shape[0],),
                                                     torch.inf), acc,
                                perm_ids=True)
    got = wavefront.hit_attributes(ps, o, d, ids, ct.Features(**f), tables)
    jids = jint.HitIds(hit=jnp.asarray(ids.hit.numpy()),
                       t=jnp.asarray(ids.t.numpy()),
                       is_sphere=jnp.asarray(ids.is_sphere.numpy()),
                       prim=jnp.asarray(ids.prim.numpy().astype(np.int32)))
    want = jwave.hit_attributes(js, jnp.asarray(o.numpy()),
                                jnp.asarray(d.numpy()), jids,
                                cge_tpu.Features(**f),
                                attr_rows=jnp.asarray(tables.numpy()))
    h = ids.hit.numpy()
    tol = 1e-4 if bilinear else 0.0
    np.testing.assert_allclose(got.kd.numpy()[h], np.asarray(want.kd)[h],
                               rtol=0.0, atol=tol)
    textured = h & (tables[ids.prim, 32].numpy() >= 0)
    assert textured.sum() > 50 and (h & ~textured).sum() > 50
    plain = wavefront.hit_attributes(ps, o, d, ids, ct.Features(
        **{**f, "enable_texture_mapping": False}), tables)
    assert not np.allclose(got.kd.numpy()[textured],
                           plain.kd.numpy()[textured])


def _compare(img, ref, min_frac=0.995):
    ref_nan, img_nan = ~np.isfinite(ref), ~np.isfinite(img)
    assert (ref_nan == img_nan).mean() > 0.999
    both = ~ref_nan & ~img_nan
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-4) | ~both
    frac = close.all(axis=-1).mean()
    assert frac >= min_frac, f"{frac:.4%} pixels close"


@pytest.mark.parametrize("accel", [False, True])
@pytest.mark.parametrize("bilinear", [False, True])
def test_textured_render_matches_jax(scenes, accel, bilinear, interpret):
    """32x32 in 512-ray chunks: the textured image against JAX's, and not
    the untextured image."""
    js, ps = scenes
    f = dict(TEXTURED, enable_accel_structure=accel,
             enable_bilinear_texture_filtering=bilinear)
    params = dict(trace_chunk=512)
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(), cge_tpu.Features(**f),
        cge_tpu.RenderParams(**params), 32, 32))
    img = ct.render_image(ps, ct.Camera(), ct.Features(**f),
                          ct.RenderParams(**params), 32, 32).numpy()
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)
    plain = ct.render_image(ps, ct.Camera(), ct.Features(
        **{**f, "enable_texture_mapping": False}),
        ct.RenderParams(**params), 32, 32).numpy()
    assert np.nanmax(np.abs(plain - img)) > 0.05
