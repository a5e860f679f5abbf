"""cge_tpu_torch/tools/op_diff.py on the CPU: the recorder that finds the
first op at which two runs of the same PyTorch code part (chip_smoke.py
runs it on the small train step, card against CPU). Here both runs are on
the CPU, one with an input nudged by an ulp, so the parting is known. And
the float32 forms the port takes so that both devices round alike
(cge_tpu_torch/ops/fp32.py), on the CPU and, where there is one, on the
card."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import cge_tpu_torch as ct
from cge_tpu_torch.ops import sweep
from cge_tpu_torch.ops.rng import prng_key
from cge_tpu_torch.render.wavefront import trace
from cge_tpu_torch.tools import op_diff
from tools.make_large_asset import write_obj

SEED = 7
LIGHT = ((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))
BRUTE = dict(enable_shading=True, enable_hard_shadow=True,
             enable_recursive=True, enable_normal_interp=True)


def _norms(x):
    n2 = (x * x).sum(dim=-1)
    return torch.sqrt(n2) + 1.0


def _record(fn, *args, **kw):
    with torch.no_grad(), op_diff.Recorder(**kw) as rec:
        fn(*args)
    return rec.entries


def test_first_parting_finds_the_op_and_the_row():
    """A nudge in row 5 of the input parts the runs at the first op that
    reads it (the multiply), in row 5 only; rows elsewhere never part."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32))
    y = x.clone()
    y[5, 1] = torch.nextafter(y[5, 1], torch.tensor(np.inf))
    a, b = _record(_norms, x), _record(_norms, y)
    assert [e[0] for e in a] == [e[0] for e in b] == ["mul", "sum", "sqrt",
                                                      "add"]
    first = op_diff.first_parting(a, b)
    assert first[:3] == (0, "mul", 1)
    assert op_diff.first_parting(a, b, row=5, rows=16)[:2] == (0, "mul")
    assert op_diff.first_parting(a, b, row=4, rows=16) is None
    assert op_diff.first_parting(a, a) is None
    assert [p[1] for p in op_diff.partings(a, b)][:1] == ["mul"]


def test_signed_zero_parts_and_nan_does_not():
    """Bits are compared: -0 parts from +0; any NaN equals any NaN."""
    nan2 = torch.tensor([1.0]).view(torch.int32) | 0x7FC00001
    a = [("x", [torch.tensor([0.0, np.nan, 1.0])])]
    b = [("x", [torch.tensor([-0.0, nan2.view(torch.float32).item(),
                              1.0])])]
    assert op_diff.first_parting(a, b)[2] == 1


def test_paused_function_records_one_entry():
    """A paused module function's own ops are not recorded; its outputs
    become one entry of its name, and the module is restored after."""
    mod = types.SimpleNamespace(step=lambda x: (x * 2.0 + 1.0, x.sum()))
    x = torch.arange(6, dtype=torch.float32)
    keep = mod.step

    def run(v):
        return mod.step(v)[0] - 1.0

    entries = _record(run, x, pause=[(mod, "step")])
    assert [e[0] for e in entries] == ["step", "sub"]
    torch.testing.assert_close(entries[0][1][0], x * 2.0 + 1.0)
    assert mod.step is keep


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("opdiff") / "dragon_small.obj")
    write_obj(path, 41, 12)
    return ct.load_scene_from_file(path, [ct.PointLight(*LIGHT)],
                                   device="cpu")


def test_train_trace_parts_where_a_vertex_moves(small_scene):
    """The accel-off train trace (K3's twin paused, its ids one entry a
    sweep) agrees with itself op for op; with one vertex nudged by an ulp,
    the first parting is a gather of the vertex table, and the sweeps'
    entries are compared like any other."""
    o, d = ct.Camera().generate_rays(
        ct.camera.pixel_grid(16, 16, "cpu").reshape(-1, 2))
    feats, params = ct.Features(**BRUTE), ct.RenderParams()
    pause = [(sweep, "closest_tris")]
    key = prng_key(SEED)
    a = _record(trace, small_scene, o, d, feats, params, key, pause=pause)
    b = _record(trace, small_scene, o, d, feats, params, key, pause=pause)
    assert op_diff.first_parting(a, b) is None
    calls = op_diff.named(a, "closest_tris")
    assert len(calls) >= 2 and calls[0][1][1][1].shape == (o.shape[0],)
    v = small_scene.vertices.clone()
    v[3, 0] = torch.nextafter(v[3, 0], torch.tensor(np.inf))
    moved = dataclasses.replace(small_scene, vertices=v)
    c = _record(trace, moved, o, d, feats, params, key, pause=pause)
    first = op_diff.first_parting(a, c)
    assert first is not None and first[1] in ("index", "index_select")
    assert all(name != "end of one run" for _, name, _, _ in
               op_diff.partings(a, c))


def test_sqrt_rn_is_the_nearest_float32():
    """fp32.sqrt_rn, the port's square root, equals the float64 root
    rounded to float32 (the nearest float32) bit for bit on a seeded sample
    over the whole exponent range, subnormals, +-0, inf and NaN included,
    and its gradient is torch.sqrt's."""
    from cge_tpu_torch.ops.fp32 import sqrt_rn
    rng = np.random.default_rng(SEED)
    n = 1 << 18
    x = (2.0 ** rng.uniform(-149, 127, n) * rng.uniform(1, 2, n))
    x = np.concatenate([x.astype(np.float32), np.float32(
        [0.0, -0.0, np.inf, np.nan, -1.0, 1e-45, 3.4028235e38])])
    x = torch.from_numpy(x)
    got = sqrt_rn(x)
    want = torch.sqrt(x.double()).float()
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    assert bool(same.all())
    y = x[:64].clone().requires_grad_(True)
    sqrt_rn(y).sum().backward()
    torch.testing.assert_close(y.grad, 0.5 / torch.sqrt(x[:64]))


def test_fp32_products_in_a_fixed_order():
    """fp32.dot3 adds (x + y) + z and fp32.cross is the textbook component
    form, each product and sum rounded once (chip_smoke.py phase 7 holds
    the card's to the same bits): on the CPU, dot3 equals the CPU build's
    .sum, while torch.linalg.cross, which contracts a multiply into its
    subtract there, parts from cross on many values."""
    from cge_tpu_torch.ops import fp32
    rng = np.random.default_rng(SEED)
    a, b = (torch.from_numpy(rng.normal(size=(4096, 3)).astype(np.float32))
            for _ in range(2))
    p = a * b
    assert torch.equal(fp32.dot3(a, b), (p[:, 0] + p[:, 1]) + p[:, 2])
    assert torch.equal(fp32.dot3(a[:, None], b[None, :8])[5, 3],
                       fp32.dot3(a[5], b[3]))
    c = fp32.cross(a, b)
    want = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    assert torch.equal(c, want)
    assert (c != torch.linalg.cross(a, b, dim=-1)).any()


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_fp32_forms_round_alike_on_every_device(device):
    """The forms that must give the card's and the CPU's bits (sqrt_rn, div
    by a number, dot3, cross) on each device, over a seeded sample, against
    their exact results taken on the CPU: the square root and the quotient
    in float64 rounded to float32 (the nearest float32, 53 bits >= 2 x 24 +
    2), the products summed (x + y) + z and in the textbook component
    form. NaN equals NaN."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's rounding is under test")
    from cge_tpu_torch.ops import fp32
    rng = np.random.default_rng(SEED)
    n = 1 << 18
    x = torch.from_numpy((2.0 ** rng.uniform(-40, 40, n)
                          * rng.uniform(1, 2, n)).astype(np.float32))
    a, b = (torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
            for _ in range(2))
    p = a * b
    want = {
        "sqrt_rn": torch.sqrt(x.double()).float(),
        "div by 3.0": (x.double() / 3.0).float(),
        "dot3": (p[:, 0] + p[:, 1]) + p[:, 2],
        "cross": torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                              a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                              a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)}
    xd, ad, bd = (v.to(device) for v in (x, a, b))
    got = {"sqrt_rn": fp32.sqrt_rn(xd), "div by 3.0": fp32.div(xd, 3.0),
           "dot3": fp32.dot3(ad, bd), "cross": fp32.cross(ad, bd)}
    differ = {k: int(op_diff.bits_differ(got[k].cpu(), want[k]).sum())
              for k in want}
    assert differ == dict.fromkeys(want, 0)
