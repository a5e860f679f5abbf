"""The stochastic and image-space features of the port against the JAX
package: segment and parallelogram soft shadows (accel off and on), MSAA,
depth of field, both together, and bloom.

Both packages draw from the same threefry streams (the port's
ops/rng.py equals jax.random bit for bit, tests/test_torch_rng.py), so the
same seed gives the same samples and the images compare pixel by pixel
under the image rules of test_torch_render.py: NaN masks agree and >=
99.5% of pixels are within rtol 1e-4 / atol 2e-4. Bloom on a fixed buffer
is held to atol 1e-6. A render with `trace_chunk` smaller than the frame
equals the unchunked render exactly: each ray's samples are keyed by its
global id. Scenes: the 41x32 stand-in (tools/make_large_asset.py) with a
point light and a parallelogram or a segment light, built by JAX and
carried across with `interop.scene_from_numpy`; the JAX side runs its
cluster path in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.ops import intersect as jint
from cge_tpu.render import bloom as jbloom
from cge_tpu.scene.scene import ParallelogramLight as JParLight
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SegmentLight as JSegLight
from cge_tpu_torch.interop import TENSOR_FIELDS, scene_from_numpy
from cge_tpu_torch.render import bloom
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

POINT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
# near the point light, four distinct corner colours
PAR = ((-1.2, 1.0, -1.2), (0.4, 0.0, 0.0), (0.0, 0.0, 0.4), (1.0, 0.2, 0.2),
       (0.2, 1.0, 0.2), (0.2, 0.2, 1.0), (1.0, 1.0, 0.2))
SEG = ((-1.4, 1.0, -0.8), (-0.6, 1.2, -1.4), (1.0, 0.6, 0.2),
       (0.2, 0.6, 1.0))
SOFT = dict(enable_shading=True, enable_soft_shadow=True,
            enable_normal_interp=True)
HARD = dict(enable_shading=True, enable_hard_shadow=True,
            enable_normal_interp=True)
SEED = 7
RES = 32


def _port(js):
    return scene_from_numpy({k: np.asarray(getattr(js, k))
                             for k in TENSOR_FIELDS},
                            all_opaque=js.all_opaque,
                            all_diffuse=js.all_diffuse, device="cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stoch") / "dragon_small.obj")
    write_obj(path, 41, 32)
    out = {}
    for name, extra in (("par", JParLight(*PAR)), ("seg", JSegLight(*SEG))):
        js = cge_tpu.load_scene_from_file(path,
                                          [JPointLight(*POINT), extra])
        out[name] = (js, _port(js))
    js = cge_tpu.load_scene_from_file(path, [JPointLight(*POINT)])
    out["point"] = (js, _port(js))
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


def _both(scenes, which, feats, params=None, res=RES, seed=SEED):
    js, ps = scenes[which]
    params = params or {}
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(), cge_tpu.Features(**feats),
        cge_tpu.RenderParams(**params), res, res, seed))
    img = ct.render_image(ps, ct.Camera(), ct.Features(**feats),
                          ct.RenderParams(**params), res, res, seed)
    assert img.shape == (res, res, 3) and img.dtype == torch.float32
    return img.numpy(), ref


# mirrors, one bounce deep: level 1 draws from fold_in(key, 1)
MIRRORS = dict(enable_hard_shadow=True, enable_recursive=True)
SHALLOW = dict(ray_depth=1)


@pytest.mark.parametrize("which,feats,params", [
    ("par", SOFT, {}), ("seg", SOFT, {}),
    ("par", dict(SOFT, enable_accel_structure=True), {}),
    ("seg", dict(SOFT, enable_accel_structure=True), {}),
    ("par", dict(SOFT, **MIRRORS), SHALLOW)])
def test_soft_shadows_match_jax(scenes, which, feats, params, interpret):
    """The point light, then the soft light's 25 jittered samples a hit
    (a 5x5 parallelogram or a 25-sample segment), its dead slot of the
    other kind skipped; the samples are visible in the image (it differs
    from another seed's)."""
    img, ref = _both(scenes, which, feats, params)
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)
    _, ps = scenes[which]
    other = ct.render_image(ps, ct.Camera(), ct.Features(**feats),
                            ct.RenderParams(**params), RES, RES,
                            SEED + 1).numpy()
    assert np.nanmax(np.abs(other - img)) > 1e-3


@pytest.mark.parametrize("feats", [
    dict(HARD, enable_multiple_rays_per_pixel=True),
    dict(HARD, enable_depth_of_field=True),
    dict(HARD, enable_multiple_rays_per_pixel=True,
         enable_depth_of_field=True),
    dict(HARD, enable_multiple_rays_per_pixel=True,
         enable_accel_structure=True),
    dict(HARD, enable_depth_of_field=True, enable_recursive=True,
         enable_accel_structure=True)])
def test_msaa_and_dof_match_jax(scenes, feats, interpret):
    """MSAA's 3x3 jittered grid from fold_in(key, 101), DoF's 5 disk
    samples from fold_in(key, 202) (split into radius and angle), each
    traced under its own key, DoF weighted 3x beside MSAA; 40x32 takes the
    gather swizzle of ragged sizes."""
    img, ref = _both(scenes, "point", feats)
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)


def test_ragged_msaa_dof_match_jax(scenes):
    js, ps = scenes["point"]
    f = dict(HARD, enable_multiple_rays_per_pixel=True,
             enable_depth_of_field=True)
    ref = np.asarray(cge_tpu.render_image(
        js, cge_tpu.Camera(), cge_tpu.Features(**f),
        cge_tpu.RenderParams(trace_chunk=1024), 40, 24, 3))
    img = ct.render_image(ps, ct.Camera(), ct.Features(**f),
                          ct.RenderParams(trace_chunk=1024), 40, 24, 3)
    _compare(img.numpy(), ref)


@pytest.fixture(scope="module")
def buffer():
    rng = np.random.default_rng(4)
    buf = rng.uniform(0.0, 1.5, (13, 17, 3)).astype(np.float32)
    buf[rng.uniform(size=(13, 17)) < 0.3] = 0.1
    return buf


@pytest.mark.parametrize("option", [0, 1, 2])
def test_bloom_filter_matches_jax(buffer, option):
    """Threshold, the nine shifted adds, each debug option, and the write
    region (buffer row 0 and the last column keep the image)."""
    p = dict(bloom_debug_option=option, bloom_scalar=0.3,
             bloom_threshold=0.4)
    want = np.asarray(jbloom.render_bloom_filter(
        jnp.asarray(buffer), cge_tpu.RenderParams(**p)))
    got = bloom.render_bloom_filter(torch.from_numpy(buffer),
                                    ct.RenderParams(**p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0], buffer[0])
    np.testing.assert_array_equal(got[:, -1], buffer[:, -1])
    if option != 2:
        assert np.abs(got - buffer).max() > 0.01
    np.testing.assert_array_equal(bloom.weights_gaussian(),
                                  jbloom.weights_gaussian())


@pytest.mark.parametrize("feats,res", [
    # at 64x64: bloom spreads a pixel that differs before it (here a
    # grazing mirror ray) over its 3x3 neighbourhood, nine pixels, 0.9% of
    # a 32x32 frame
    (dict(HARD, enable_recursive=True, enable_bloom_effect=True), 64),
    (dict(HARD, enable_bloom_effect=True, enable_depth_of_field=True), RES)])
def test_bloom_render_matches_jax(scenes, feats, res):
    img, ref = _both(scenes, "point", feats, res=res)
    assert np.nanmax(ref) > 0.05
    _compare(img, ref)


# (scene, features, side, chunk): each chunked render splits into several
# chunks, the pixels times the rays a pixel (9 for MSAA, 5 for DoF) above
# the chunk
@pytest.mark.parametrize("which,feats,res,chunk", [
    ("par", SOFT, 16, 64),
    ("seg", dict(SOFT, enable_accel_structure=True), RES, 512),
    ("par", dict(SOFT, **MIRRORS), 16, 64),
    ("point", dict(HARD, enable_multiple_rays_per_pixel=True), 16, 512),
    ("point", dict(HARD, enable_depth_of_field=True), RES, 512),
    ("par", dict(SOFT, enable_multiple_rays_per_pixel=True,
                 enable_depth_of_field=True, enable_bloom_effect=True), 8,
     256)])
def test_chunking_does_not_change_stochastic_images(scenes, which, feats,
                                                    res, chunk):
    """`chunk`-ray chunks and one chunk: equal images (NaN equal to
    NaN)."""
    spp = (9 * feats.get("enable_multiple_rays_per_pixel", False)
           + 5 * feats.get("enable_depth_of_field", False))
    assert res * res * max(spp, 1) >= 2 * chunk
    _, ps = scenes[which]
    f = ct.Features(**feats)
    a = ct.render_image(ps, ct.Camera(), f,
                        ct.RenderParams(trace_chunk=chunk, **SHALLOW),
                        res, res, SEED)
    b = ct.render_image(ps, ct.Camera(), f, ct.RenderParams(**SHALLOW), res,
                        res, SEED)
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert float(torch.nan_to_num(b).max()) > 0.05


def test_render_loss_reads_its_seed(scenes):
    """render_loss(seed=s) traces under prng_key(s): soft shadows change
    with the seed, and equal JAX's render_loss(key=PRNGKey(s))."""
    import jax

    from cge_tpu.diff import gradients as jgrad

    js, ps = scenes["par"]
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(8, 8, "cpu").reshape(-1, 2))
    target = torch.full((o.shape[0], 3), 0.1)
    f = ct.Features(**SOFT)
    losses = [float(ct.render_loss(ct.scene_params(ps), ps, o, d, target, f,
                                   ct.RenderParams(), seed=s))
              for s in (0, 1)]
    want = float(jgrad.render_loss(
        jgrad.scene_params(js), js, jnp.asarray(o.numpy()),
        jnp.asarray(d.numpy()), jnp.asarray(target.numpy()),
        cge_tpu.Features(**SOFT), cge_tpu.RenderParams(),
        jax.random.PRNGKey(1)))
    assert losses[0] != losses[1]
    np.testing.assert_allclose(losses[1], want, rtol=1e-5)
