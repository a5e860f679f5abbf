"""The port's differentiable train step (cge_tpu_torch.diff.gradients)
against the JAX package's, on the same numpy leaves.

The scene is the 9x8 dragon stand-in (tools/make_large_asset.py, 128
triangles) with two spheres, one a mirror; 12x12 camera rays; shading, hard
shadows and recursive mirrors, with the accel off, so hit selection is the
brute-force sweep (K3's twin here, JAX's XLA sweep there). The scene is
built once by JAX and carried across with `interop.scene_from_numpy`; the
JAX side runs `jax.value_and_grad(render_loss)` under jit.

Gradients are compared per DIFF_FIELDS leaf with rtol 2e-3 and atol 1e-4 x
the leaf's max |g|: both sides differentiate the same ops, but XLA:CPU
contracts products into FMAs and sums in its own order, and a gradient
accumulates over every ray that sees a leaf.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from cge_tpu.camera import pixel_grid as jpixel_grid
from cge_tpu.diff import gradients as jgrad
from cge_tpu.scene.mesh_io import Material, load_mesh
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch.interop import (TENSOR_FIELDS, params_from_numpy,
                                   scene_from_numpy)
from cge_tpu_torch.ops import sweep
from tools.make_large_asset import write_obj

torch.set_num_threads(2)

LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
FEATURES = {
    # geometric normals: from this view the stand-in's faces shade black,
    # so its vertex gradients vanish and spheres and light carry the rest
    "geometric": dict(enable_shading=True, enable_hard_shadow=True,
                      enable_recursive=True),
    # interpolated normals light the stand-in itself: vertex and normal
    # gradients are nonzero
    "interp": dict(enable_shading=True, enable_hard_shadow=True,
                   enable_recursive=True, enable_normal_interp=True),
}
SIDE = 12
SEED = 5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grad") / "dragon_tiny.obj")
    write_obj(path, 9, 8)
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
    o, d = cge_tpu.Camera().generate_rays(
        jpixel_grid(SIDE, SIDE).reshape(-1, 2))
    o, d = np.array(o), np.array(d)
    rng = np.random.default_rng(SEED)
    target = rng.uniform(0.0, 0.5, (o.shape[0], 3)).astype(np.float32)
    return js, ps, o, d, target


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    return jax.jit(jax.value_and_grad(jgrad.render_loss),
                   static_argnames=("features", "render_params"))


def _jax(js, o, d, target, feats):
    v, g = _jax_value_and_grad()(
        jgrad.scene_params(js), js, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(target), features=cge_tpu.Features(**feats),
        render_params=cge_tpu.RenderParams(), key=jax.random.PRNGKey(0))
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _port(ps, o, d, target, feats):
    loss, g = ct.loss_and_grads(ps, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(target),
                                ct.Features(**feats), ct.RenderParams())
    return float(loss), {k: x.numpy() for k, x in g.items()}


@pytest.mark.parametrize("which", list(FEATURES))
def test_loss_and_grads_match_jax(setup, which):
    """The loss to rtol 1e-5 and every DIFF_FIELDS gradient to rtol 2e-3,
    atol 1e-4 x max |g|; every gradient finite (JAX's are, on this view,
    which has no pow-quirk rays)."""
    js, ps, o, d, target = setup
    jv, jg = _jax(js, o, d, target, FEATURES[which])
    before = sweep.LAUNCHES["sweep"]
    pv, pg = _port(ps, o, d, target, FEATURES[which])
    assert sweep.LAUNCHES["sweep"] == before          # CPU: the twin ran
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    assert set(pg) == set(ct.DIFF_FIELDS)
    for k in ct.DIFF_FIELDS:
        want, got = jg[k], pg[k]
        assert got.shape == want.shape and got.dtype == np.float32, k
        assert np.isfinite(want).all() and np.isfinite(got).all(), k
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4 * scale,
                                   err_msg=k)
    live = {"mat_kd", "sph_center", "sph_radius", "point_pos", "point_color"}
    if which == "interp":
        live |= {"vertices", "normals"}
    assert all(np.abs(pg[k]).max() > 0 for k in live)


def _fd(ps, o, d, target, feats, field, idx, eps):
    """Central difference of the port's loss in one entry of one leaf."""
    base = ct.scene_params(ps)

    def loss(sign):
        p = dict(base)
        p[field] = base[field].clone()
        p[field][idx] += sign * eps
        with torch.no_grad():
            return float(ct.render_loss(p, ps, torch.from_numpy(o),
                                        torch.from_numpy(d),
                                        torch.from_numpy(target), feats,
                                        ct.RenderParams()))
    return (loss(1.0) - loss(-1.0)) / (2 * eps)


@pytest.mark.parametrize("field,eps,rtol", [
    ("mat_kd", 1e-3, 0.06), ("point_pos", 1e-4, 0.06),
    ("point_color", 1e-3, 0.06), ("sph_center", 1e-4, 0.06),
    ("vertices", 1e-4, 0.15)])
def test_grads_match_central_differences(setup, field, eps, rtol):
    """The port alone, as tests/test_gradients.py checks the JAX package:
    reverse mode against central differences on the largest entries of a
    leaf, perturbed within the smooth region (rtol as there: 6%, 15% for
    vertices, whose steps move the hit points)."""
    _, ps, o, d, target = setup
    feats = ct.Features(**FEATURES["interp"])
    _, g = ct.loss_and_grads(ps, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(target), feats,
                             ct.RenderParams())
    flat = g[field].abs().reshape(-1)
    checked = 0
    for i in torch.argsort(flat, descending=True)[:3].tolist():
        idx = np.unravel_index(i, g[field].shape)
        ad = float(g[field][idx])
        if abs(ad) < 1e-7:
            continue
        fd = _fd(ps, o, d, target, feats, field, idx, eps)
        assert np.isclose(ad, fd, rtol=rtol, atol=1e-7), (field, idx, ad, fd)
        checked += 1
    assert checked > 0


def test_sgd_steps_match_jax(setup):
    """Three SGD steps on both sides: the same loss sequence to 1e-4
    relative, falling as JAX's does."""
    js, ps, o, d, target = setup
    feats = FEATURES["interp"]
    lr = 0.1
    jl, pl = [], []
    for _ in range(3):
        jv, jg = _jax(js, o, d, target, feats)
        js = jgrad.sgd_step(js, {k: jnp.asarray(v) for k, v in jg.items()},
                            lr)
        jl.append(jv)
        loss, g = ct.loss_and_grads(ps, torch.from_numpy(o),
                                    torch.from_numpy(d),
                                    torch.from_numpy(target),
                                    ct.Features(**feats), ct.RenderParams())
        ps = ct.sgd_step(ps, g, lr)
        pl.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[2] < pl[1] < pl[0]


def test_with_params_keeps_the_scene(setup):
    """with_params swaps the float leaves only: integer leaves and the host
    flags carry across unchanged, as dataclasses.replace does in JAX; the
    numpy interop gives the port the JAX package's scene_params."""
    js, ps, *_ = setup
    leaves = params_from_numpy({k: np.asarray(v) for k, v in
                                jgrad.scene_params(js).items()},
                               device="cpu")
    assert set(leaves) == set(ct.DIFF_FIELDS)
    for k, v in leaves.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), getattr(ps, k).numpy())
    bumped = {k: v + 1.0 for k, v in leaves.items()}
    s = ct.with_params(ps, bumped)
    assert s.point_mask_host == ps.point_mask_host
    assert (s.all_opaque, s.all_diffuse) == (ps.all_opaque, ps.all_diffuse)
    assert s.tris is ps.tris and s.cluster_perm is ps.cluster_perm
    assert torch.equal(s.mat_kd, ps.mat_kd + 1.0)
    with pytest.raises(KeyError):
        params_from_numpy({"vertices": np.zeros((1, 3))}, device="cpu")


def test_render_image_stays_off_the_graph(setup):
    """render_image is the serving path: no graph, even from leaves that
    require grad."""
    _, ps, *_ = setup
    p = {k: v.detach().requires_grad_(True)
         for k, v in ct.scene_params(ps).items()}
    img = ct.render_image(ct.with_params(ps, p), ct.Camera(),
                          ct.Features(**FEATURES["interp"]),
                          ct.RenderParams(), 16, 16)
    assert not img.requires_grad


@pytest.mark.cuda
def test_loss_and_grads_on_card_match_cpu(setup):
    """The train step on the card runs K3 and gives the CPU twins' loss and
    gradients, as chip_smoke.py holds them: loss to 1e-3 relative, each
    gradient within 1e-2 of its norm (the card sums in another order, with
    atomics in the gathers' backward, and a ray that grazes an edge may
    land on either side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    _, ps, o, d, target = setup
    gpu = scene_from_numpy({k: getattr(ps, k).numpy() for k in TENSOR_FIELDS},
                           all_opaque=ps.all_opaque,
                           all_diffuse=ps.all_diffuse, device="cuda")
    feats = ct.Features(**FEATURES["interp"])
    before = sweep.LAUNCHES["sweep"]
    gl, gg = ct.loss_and_grads(gpu, *(torch.from_numpy(x).cuda()
                                      for x in (o, d, target)), feats,
                               ct.RenderParams())
    assert sweep.LAUNCHES["sweep"] > before
    cl, cg = _port(ps, o, d, target, FEATURES["interp"])
    np.testing.assert_allclose(float(gl), cl, rtol=1e-3)
    for k in ct.DIFF_FIELDS:
        diff = np.linalg.norm(gg[k].cpu().numpy() - cg[k])
        assert diff <= 1e-2 * max(np.linalg.norm(cg[k]), 1e-12), k
