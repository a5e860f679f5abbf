"""The port's intersection primitives and the twins of K3 and K2 against
the reference's compiled intersection library, and the primitives against
the JAX package's.

tests/golden/golden_intersect.bin holds 4,096 cases of each kind, dumped
by tools/golden_intersect.cpp from the prebuilt library; they are replayed
through cge_tpu_torch/tools/golden_replay.py under
tests/test_intersect_golden.py's rules: >= 99.9% of decisions agree
(99.5% for point-in-triangle), t to rtol 2e-5 / atol 2e-6 for triangles,
boxes and planes, 2e-4 / 2e-5 for spheres, the sphere normal to 1e-3 /
2e-3, the plane's n and D to 1e-4 / 1e-5. K3's twin runs each triangle
case over a one-row table, K2's twin (with K1's and the sort) over a
one-triangle cluster: every case in the triangle layout, and in the field
layout a subset of FIELD_CASES cases drawn with FIELD_SEED (the field
walk takes about twice as long a case).

Against JAX's functions on the same inputs: >= 99.9% of decisions equal,
t (and n, D, the normal) to rtol 1e-5 / atol 2e-6; the port takes o.n and
d.n as dot3's products where JAX's intersect_triangles_t takes
HIGHEST-precision matmuls.

The card replays the walks of all cases in one sweep
(walk_cases_batched), which equals the per-case walks here on
BATCH_CASES cases. The `cuda` cases replay the triangle cases through K3
and through K1 + sort + K2 on the card against the twins there, and the
primitives on the card against the CPU, bit for bit; they skip without a
card and need no JAX (`python -m pytest --noconftest tests/test_torch_intersect_golden.py
-m cuda`).
"""

import numpy as np
import pytest
import torch

from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.tools import golden_replay as gr

torch.set_num_threads(2)

FIELD_CASES = 1024
FIELD_SEED = 11
BATCH_CASES = 256
JAX_RTOL, JAX_ATOL = 1e-5, 2e-6


@pytest.fixture(scope="module")
def golden():
    return gr.load()


@pytest.fixture(scope="module")
def ported(golden):
    return gr.primitives(golden)


@pytest.fixture(scope="module")
def jint():
    """The JAX package's intersect module, imported here so that the card's
    cases run where JAX is not installed."""
    return pytest.importorskip("cge_tpu.ops.intersect")


def _agree(ok, frac=0.999):
    share = float(ok.float().mean())
    assert share >= frac, f"agreement {share:.5f}"


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _decisions(hit, t, ref_hit, ref_t, rtol=2e-5, atol=2e-6):
    _agree(hit == ref_hit)
    both = hit & ref_hit
    assert both.sum() > 100
    _close(t[both], ref_t[both], rtol, atol)


def test_triangle_golden(golden, ported):
    g, t = golden["tri"], ported["tri_t"]
    _decisions(torch.isfinite(t), t, g["hit"], g["t"])


def test_sphere_golden(golden, ported):
    g, t = golden["sph"], ported["sph_t"]
    hit = torch.isfinite(t)
    _decisions(hit, t, g["hit"], g["t"], 2e-4, 2e-5)
    both = hit & g["hit"]
    _close(ported["sph_normal"][both], g["normal"][both], 1e-3, 2e-3)


def test_aabb_golden(golden, ported):
    g = golden["box"]
    _decisions(ported["box_hit"], ported["box_t"], g["hit"], g["t"])


def test_plane_and_point_in_triangle_golden(golden, ported):
    g = golden["pln"]
    _close(ported["pln_n"], g["n"], 1e-4, 1e-5)
    _close(ported["pln_D"], g["D"], 1e-4, 1e-5)
    _agree(ported["pln_inside"] == g["inside"], 0.995)
    t = ported["pln_t"]
    _decisions((t >= 0) & (t <= g["tmax"]), t, g["hit"], g["t"])


def test_k3_twin_golden(golden):
    g = golden["tri"]
    t, ids = gr.sweep_cases(g)
    hit = torch.isfinite(t)
    assert torch.equal(ids, torch.where(hit, 0, -1).int())
    _decisions(hit, t, g["hit"], g["t"])


@pytest.mark.parametrize("layout", cs.LAYOUTS)
def test_k2_twin_golden(golden, layout):
    g = golden["tri"]
    idx = None
    if layout == "field":
        rng = np.random.default_rng(FIELD_SEED)
        idx = np.sort(rng.choice(gr.N, FIELD_CASES, replace=False))
        g = {k: v[torch.from_numpy(idx)] for k, v in g.items()}
    t, slot = gr.walk_cases(g, layout)
    hit = torch.isfinite(t)
    assert torch.equal(slot, torch.where(hit, 0, -1).int())
    _decisions(hit, t, g["hit"], g["t"])


@pytest.mark.parametrize("layout", cs.LAYOUTS)
def test_k2_batched_replay_equals_per_case(golden, layout):
    """walk_cases_batched (one sweep, every block's keys masked to its own
    case's cluster: the card's replay) gives walk_cases's t and slots on
    BATCH_CASES cases drawn with FIELD_SEED."""
    rng = np.random.default_rng(FIELD_SEED)
    idx = torch.from_numpy(np.sort(rng.choice(gr.N, BATCH_CASES,
                                              replace=False)))
    g = {k: v[idx] for k, v in golden["tri"].items()}
    got, want = gr.walk_cases_batched(g, layout), gr.walk_cases(g, layout)
    assert torch.isfinite(want[0]).sum() > 50
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _jax_paired(fn, *cols):
    """JAX's batched [R, T] function on 512-case chunks, diagonals
    concatenated (tests/test_intersect_golden.py's _paired)."""
    import jax.numpy as jnp

    outs = []
    for s in range(0, gr.N, gr.CHUNK):
        res = fn(*(jnp.asarray(c[s:s + gr.CHUNK].numpy()) for c in cols))
        res = res if isinstance(res, tuple) else (res,)
        outs.append([np.diagonal(np.asarray(r)) for r in res])
    return [np.concatenate(x) for x in zip(*outs)]


def _jax(*cols):
    import jax.numpy as jnp

    return [jnp.asarray(c.numpy()) for c in cols]


def _match(hit, t, ref_hit, ref_t):
    """>= 99.9% of decisions equal, t to JAX_RTOL / JAX_ATOL on both."""
    ref_hit = torch.from_numpy(np.array(ref_hit))
    _agree(hit == ref_hit)
    both = (hit & ref_hit).numpy()
    _close(t.numpy()[both], np.asarray(ref_t)[both], JAX_RTOL, JAX_ATOL)


@pytest.mark.parametrize("kind", ["tri", "sph", "box", "pln"])
def test_primitives_match_jax(golden, ported, jint, kind):
    g = golden[kind]
    if kind == "tri":
        (t,) = _jax_paired(jint.intersect_triangles_t, g["o"], g["d"],
                           g["tmax"], g["v0"], g["v1"], g["v2"])
        _match(torch.isfinite(ported["tri_t"]), ported["tri_t"],
               np.isfinite(t), t)
    elif kind == "sph":
        (t,) = _jax_paired(jint.intersect_spheres_t, g["o"], g["d"],
                           g["tmax"], g["center"], g["radius"])
        _match(torch.isfinite(ported["sph_t"]), ported["sph_t"],
               np.isfinite(t), t)
        hit = torch.isfinite(ported["sph_t"])
        tf = torch.where(hit, ported["sph_t"], 0.0)
        v = g["o"] + tf[:, None] * g["d"] - g["center"]
        want = np.asarray(jint.normalize(*_jax(v)))
        _close(ported["sph_normal"][hit], want[hit.numpy()], JAX_RTOL,
               JAX_ATOL)
    elif kind == "box":
        hit, t = _jax_paired(jint.intersect_aabb, g["o"], g["d"], g["tmax"],
                             g["lo"], g["hi"])
        _match(ported["box_hit"], ported["box_t"], hit, t)
    else:
        n, D = jint.triangle_plane(*_jax(g["v0"], g["v1"], g["v2"]))
        _close(ported["pln_n"], n, JAX_RTOL, JAX_ATOL)
        _close(ported["pln_D"], D, JAX_RTOL, JAX_ATOL)
        inside = jint.point_in_triangle(*_jax(g["v0"], g["v1"], g["v2"],
                                              g["n"], g["p"]))
        _agree(ported["pln_inside"] == torch.from_numpy(np.array(inside)))
        t = np.asarray(jint.intersect_ray_plane_t(*_jax(g["o"], g["d"],
                                                        g["n"], g["D"])))
        tmax = g["tmax"].numpy()
        pt = ported["pln_t"]
        _match((pt >= 0) & (pt <= g["tmax"]), pt, (t >= 0) & (t <= tmax), t)


def test_constants_and_defaults_match_jax(jint):
    """FLT_MIN, FLT_MAX (the slab test's d == 0 constants) and the default
    Features and RenderParams: JAX's values."""
    import dataclasses

    from cge_tpu import types as jtypes
    from cge_tpu_torch import types
    from cge_tpu_torch.ops import intersect

    assert np.float32(intersect.FLT_MIN) == jint.FLT_MIN
    assert np.float32(intersect.FLT_MAX) == jint.FLT_MAX
    assert (dataclasses.asdict(types.DEFAULT_FEATURES)
            == dataclasses.asdict(jtypes.DEFAULT_FEATURES))
    assert (dataclasses.asdict(types.DEFAULT_PARAMS)
            == dataclasses.asdict(jtypes.DEFAULT_PARAMS))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _on(cols, device):
    return {k: v.to(device) for k, v in cols.items()}


@pytest.mark.cuda
def test_k3_on_card_matches_twin(golden, cuda_device):
    tri = _on(golden["tri"], cuda_device)
    got, want = gr.sweep_cases(tri), gr.sweep_cases(tri, plain=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", cs.LAYOUTS)
def test_k2_on_card_matches_twin(golden, layout, cuda_device):
    tri = _on(golden["tri"], cuda_device)
    got = gr.walk_cases_batched(tri, layout)
    want = gr.walk_cases_batched(tri, layout, plain=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_primitives_on_card_match_cpu(golden, ported, cuda_device):
    card = gr.primitives({k: _on(v, cuda_device) for k, v in golden.items()})
    for name, x in card.items():
        assert gr.same(x.cpu(), ported[name]), name
