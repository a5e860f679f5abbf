"""The port's differentiable train step (cge_tpu_torch.diff.gradients)
against the JAX package's, on the same numpy leaves.

The scene is the 9x8 dragon stand-in (tools/make_large_asset.py, 128
triangles) with two spheres, one a mirror; 12x12 camera rays; shading, hard
shadows and recursive mirrors, with the accel off, so hit selection is the
brute-force sweep (K3's twin here, JAX's XLA sweep there). More cases of
the train step: the stand-in's body textured (bilinear), a parallelogram
light's soft shadows, whose samples both sides draw from key 0, the
TRANS+REC tree with the body at d 0.45 and glossy cones with the belly at
Ns 0 (cge_tpu_torch/tools/common.write_variant_obj); and sgd_step's
recomputed host flags. The scene is built once by JAX and carried across
with `interop.scene_from_numpy`; the JAX side runs
`jax.value_and_grad(render_loss)` under jit.

Gradients are compared per DIFF_FIELDS leaf with rtol 2e-3 and atol 1e-4 x
the leaf's max |g|: both sides differentiate the same ops, but XLA:CPU
contracts products into FMAs and sums in its own order, and a gradient
accumulates over every ray that sees a leaf.
"""

import dataclasses
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
from cge_tpu.scene.scene import ParallelogramLight as JParLight
from cge_tpu.scene.scene import PointLight as JPointLight
from cge_tpu.scene.scene import SphereDef, build_scene_arrays
from cge_tpu_torch.interop import (TENSOR_FIELDS, params_from_numpy,
                                   scene_from_numpy)
from cge_tpu_torch.ops import sweep
from cge_tpu_torch.tools.common import write_textured_obj, write_variant_obj
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
    # the stand-in's body textured (bilinear): gradients reach the texels
    # and the uvs
    "texture": dict(enable_shading=True, enable_hard_shadow=True,
                    enable_recursive=True, enable_normal_interp=True,
                    enable_texture_mapping=True,
                    enable_bilinear_texture_filtering=True),
    # a parallelogram light's 5x5 jittered samples, drawn from the same
    # threefry streams on both sides (bench.py's soft feature set with
    # interpolated normals): gradients reach its corner, edges and colours
    "soft": dict(enable_shading=True, enable_soft_shadow=True,
                 enable_normal_interp=True),
    # the TRANS+REC tree on the stand-in with its body at d 0.45
    # (write_variant_obj "glass"): gradients reach the transparencies
    # through the blends and the transparency shadows
    "transrec": dict(enable_shading=True, enable_hard_shadow=True,
                     enable_recursive=True, enable_transparency=True,
                     enable_normal_interp=True),
    # glossy cones on the stand-in with its belly at Ns 0 (write_variant_obj
    # "glossy"): gradients reach the shininess through the cone's spread
    "glossy": dict(enable_shading=True, enable_hard_shadow=True,
                   enable_recursive=True, enable_glossy_reflection=True,
                   enable_normal_interp=True),
}
# the RenderParams of each feature set beyond the defaults: the tree and
# the cone fan-out cut to a CPU test's size
PARAMS = {"transrec": dict(ray_depth=3, extra_transparency_unroll=2),
          "glossy": dict(ray_depth=2, rays_per_reflection=4)}
# the loss's rtol where it is not 1e-5: the tree sums one ray's radiance
# to ~6 through pow(., 28) specular terms, and JAX's jit-compiled loss
# moves 4.8e-5 from JAX's own eager trace of the same rays (XLA contracts
# FMAs differently), where the port's loss is within 1.5e-6 of the eager
LOSS_RTOL = {"transrec": 1e-4}
# the leaves each feature set must move, beyond those of every set
LIVE = {"geometric": set(), "interp": {"vertices", "normals"},
        "texture": {"vertices", "normals", "textures", "uvs"},
        "soft": {"vertices", "normals", "par_v0", "par_e01", "par_e02",
                 "par_c0", "par_c1", "par_c2", "par_c3"},
        "transrec": {"vertices", "normals", "mat_transparency"},
        "glossy": {"vertices", "normals", "mat_ks", "mat_shininess"}}
PAR = ((-1.2, 1.0, -1.2), (0.4, 0.0, 0.0), (0.0, 0.0, 0.4), (1.0, 0.2, 0.2),
       (0.2, 1.0, 0.2), (0.2, 0.2, 1.0), (1.0, 1.0, 0.2))
SIDE = 12
SEED = 5


def _build(path, lights):
    spheres = [
        SphereDef((0.0, 0.1, 0.0), 0.3,
                  Material(kd=np.float32([0.9, 0.3, 0.2]),
                           ks=np.float32([0.4, 0.4, 0.4]), shininess=12.0)),
        SphereDef((0.55, 0.45, -0.7), 0.2,
                  Material(kd=np.float32([0.2, 0.3, 0.9]))),
    ]
    js = build_scene_arrays(load_mesh(path), spheres, lights)
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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grad") / "dragon_tiny.obj")
    write_obj(path, 9, 8)
    return _build(path, [JPointLight(*LIGHT)])


@pytest.fixture(scope="module")
def setups(setup, tmp_path_factory):
    """The scene of each feature set: the textured stand-in
    (tools/common.write_textured_obj) for texture, a parallelogram light
    beside the point light for soft shadows, else `setup`'s."""
    path = str(tmp_path_factory.mktemp("grad_tex") / "dragon_tiny.obj")
    write_textured_obj(path, 9, 8)
    out = {"texture": _build(path, [JPointLight(*LIGHT)])}
    path = str(tmp_path_factory.mktemp("grad_par") / "dragon_tiny.obj")
    write_obj(path, 9, 8)
    out["soft"] = _build(path, [JPointLight(*LIGHT), JParLight(*PAR)])
    for variant, which in (("glass", "transrec"), ("glossy", "glossy")):
        path = str(tmp_path_factory.mktemp(f"grad_{variant}")
                   / "dragon_tiny.obj")
        write_variant_obj(path, 9, 8, variant)
        out[which] = _build(path, [JPointLight(*LIGHT)])
    return {k: out.get(k, setup) for k in FEATURES}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    return jax.jit(jax.value_and_grad(jgrad.render_loss),
                   static_argnames=("features", "render_params"))


def _jax(js, o, d, target, feats, params=None):
    v, g = _jax_value_and_grad()(
        jgrad.scene_params(js), js, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(target), features=cge_tpu.Features(**feats),
        render_params=cge_tpu.RenderParams(**(params or {})),
        key=jax.random.PRNGKey(0))
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _port(ps, o, d, target, feats, params=None):
    loss, g = ct.loss_and_grads(ps, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(target),
                                ct.Features(**feats),
                                ct.RenderParams(**(params or {})))
    return float(loss), {k: x.numpy() for k, x in g.items()}


@pytest.mark.parametrize("which", list(FEATURES))
def test_loss_and_grads_match_jax(setups, which):
    """The loss to rtol 1e-5 (LOSS_RTOL) and every DIFF_FIELDS gradient to
    rtol 2e-3, atol 1e-4 x max |g|; every gradient of the port finite, and
    JAX's too (this view has no pow-quirk rays) but for glossy's
    mat_shininess, where JAX's fault makes NaN. Both sides draw the soft
    shadows' samples from key 0 (the port's seed 0)."""
    js, ps, o, d, target = setups[which]
    jv, jg = _jax(js, o, d, target, FEATURES[which], PARAMS.get(which))
    before = sweep.LAUNCHES["sweep"]
    pv, pg = _port(ps, o, d, target, FEATURES[which], PARAMS.get(which))
    assert sweep.LAUNCHES["sweep"] == before          # CPU: the twin ran
    np.testing.assert_allclose(pv, jv, rtol=LOSS_RTOL.get(which, 1e-5))
    assert set(pg) == set(ct.DIFF_FIELDS)
    for k in ct.DIFF_FIELDS:
        want, got = jg[k], pg[k]
        assert got.shape == want.shape and got.dtype == np.float32, k
        assert np.isfinite(got).all(), k
        ok = np.isfinite(want)
        # JAX's one non-finite gradient: glossy's cone basis divides 0 by 0
        # (ROADMAP section 3); compared where JAX's is finite
        assert ok.all() or (which, k) == ("glossy", "mat_shininess"), k
        scale = float(np.abs(want[ok]).max())
        np.testing.assert_allclose(got[ok], want[ok], rtol=2e-3,
                                   atol=1e-4 * scale, err_msg=k)
    live = {"mat_kd", "sph_center", "sph_radius", "point_pos",
            "point_color"} | LIVE[which]
    assert [k for k in live if not np.abs(pg[k]).max() > 0] == []


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


def test_sgd_step_recomputes_the_host_flags(tmp_path):
    """A step that moves an all-diffuse scene's mat_ks off zero: the
    port's sgd_step recomputes all_diffuse (False) and all_opaque (still
    False: d 0.45), so its next TRANS+REC render runs the generic two-child
    tree and equals JAX's render of the stepped scene with all_diffuse
    set False by hand (image rules: NaN masks agree, >= 99.5% of pixels
    within rtol 1e-4 / atol 2e-4). JAX's sgd_step keeps the stale flag,
    and its collapsed tree drops the mirror children: another image."""
    path = str(tmp_path / "dragon_tiny.obj")
    write_variant_obj(path, 9, 8, "diffuse_glass")
    js = build_scene_arrays(load_mesh(path), (), [JPointLight(*LIGHT)])
    ps = scene_from_numpy({k: np.asarray(getattr(js, k))
                           for k in TENSOR_FIELDS},
                          all_opaque=js.all_opaque,
                          all_diffuse=js.all_diffuse, device="cpu")
    assert ps.all_diffuse and not ps.all_opaque
    step = {k: np.zeros_like(np.asarray(v))
            for k, v in jgrad.scene_params(js).items()}
    step["mat_ks"] = np.full_like(step["mat_ks"], -1.0)
    ps = ct.sgd_step(ps, {k: torch.from_numpy(v) for k, v in step.items()},
                     0.5)
    js = jgrad.sgd_step(js, {k: jnp.asarray(v) for k, v in step.items()},
                        0.5)
    assert not ps.all_diffuse and not ps.all_opaque
    assert js.all_diffuse                       # the JAX package's stale flag
    feats = dict(enable_shading=True, enable_hard_shadow=True,
                 enable_recursive=True, enable_transparency=True,
                 enable_normal_interp=True)
    params = dict(ray_depth=3, extra_transparency_unroll=2)
    img = ct.render_image(ps, ct.Camera(), ct.Features(**feats),
                          ct.RenderParams(**params), 16, 16).numpy()
    jimgs = [np.asarray(cge_tpu.render_image(
        s, cge_tpu.Camera(), cge_tpu.Features(**feats),
        cge_tpu.RenderParams(**params), 16, 16))
        for s in (dataclasses.replace(js, all_diffuse=False), js)]
    generic, stale = jimgs
    assert (np.isnan(img) == np.isnan(generic)).mean() > 0.999
    both = np.isfinite(img) & np.isfinite(generic)
    close = np.isclose(img, generic, rtol=1e-4, atol=2e-4) | ~both
    assert close.all(axis=-1).mean() >= 0.995
    assert np.nanmax(np.abs(stale - generic)) > 1e-2
