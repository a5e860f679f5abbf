"""The per-op frame attribution (cge_tpu_torch/tools/frame_profile.py)
without a card: the interval union and the summary on synthetic events
(kernels, copies, a kernel launched outside every op, a device annotation
that is no work, host ops inside and outside record_function spans, a
runtime call whose correlation id equals an op's), the labelled parts read from a real CPU profile against
torch.profiler's own parse, and the tool's driver on a 32x32 frame of the
9x8 stand-in, which has no device events.
"""

import pytest
import torch

import cge_tpu_torch as ct
from cge_tpu_torch.tools import frame_profile as fp

torch.set_num_threads(2)


@pytest.mark.parametrize("intervals,want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),                   # overlap
    ([(0, 100), (10, 20), (30, 40)], 100),      # nested
    ([(20, 30), (0, 10)], 20),                  # a gap, out of order
    ([(0, 10), (10, 20), (0, 10)], 20),         # touching, repeated
    ([(0, 10), (5, 8), (9, 30), (40, 41)], 31),
])
def test_busy_ns(intervals, want):
    assert fp.busy_ns(intervals) == want


def _op(name, start, dur, corr, thread=1, linked=0):
    return fp.Event(name, False, name.startswith("lab."), start, dur, thread,
                    corr, linked, False)


def _dev(name, start, dur, linked):
    return fp.Event(name, True, name.startswith("lab."), start, dur, 0, 0,
                    linked, False)


LABELS = {"lab.draw": "draw", "lab.blur": "blur"}


def _trace():
    """Two frames: a draw span owning ops 2 and 3, a blur span on another
    thread owning op 6, a host op 4 outside every span; kernels linked to
    each op, a copy, a fill, a runtime call linked to op 2 whose own
    correlation id (6) equals op 6's, and a device annotation."""
    return [
        _op("lab.draw", 0, 100, 1),
        _op("aten::mul", 10, 5, 2),
        _op("aten::add", 50, 5, 3),
        _op("aten::sum", 200, 5, 4),
        _op("lab.blur", 300, 50, 5, thread=2),
        _op("aten::conv", 310, 5, 6, thread=2),
        _op("aten::conv", 90, 5, 7, thread=2),       # in draw's time, not
        _op("cudaLaunchKernel", 11, 2, 6, linked=2),
        _dev("mul_kernel", 1000, 40, 2),
        _dev("add_kernel", 1040, 10, 3),
        _dev("add_kernel", 1100, 10, 3),
        _dev("Memcpy HtoD", 1020, 30, 4),
        _dev("Memset", 1200, 10, 4),
        _dev("conv_kernel", 1300, 60, 6),
        _dev("conv_kernel", 1320, 5, 7),
        _dev("k1_kernel", 1355, 20, 0),              # launched outside ops
        _dev("lab.draw", 990, 200, 0),
    ]


def test_summarize_synthetic():
    s = fp.summarize(_trace(), wall_ns=1000, frames=2, labels=LABELS)
    names = [op["name"] for op in s["ops"]]
    assert names == ["conv_kernel", "mul_kernel", "Memcpy HtoD",
                     "add_kernel", "k1_kernel", "Memset"]
    assert [op["count"] for op in s["ops"]] == [2, 1, 1, 2, 1, 1]
    assert abs(sum(op["share"] for op in s["ops"]) - 1) < 1e-12
    assert s["ops"][0]["ms"] == pytest.approx(65 / 1e6 / 2)
    assert s["device_ms"] == pytest.approx(185 / 1e6 / 2)
    assert s["wall_ms"] == pytest.approx(1000 / 1e6 / 2)
    # union: [1000, 1050) + [1100, 1110) + [1200, 1210) + [1300, 1375)
    assert s["busy_share"] == pytest.approx(145 / 1000)
    assert s["busy_ms"] == pytest.approx(145 / 1e6 / 2)
    assert fp.kernel_count(s, "add_kernel") == 2
    # draw owns ops 2 and 3 (mul + 2 adds); blur owns op 6 (one conv)
    assert s["labels"]["draw"] == pytest.approx((0.5, 60 / 1e6 / 2, 1.5))
    assert s["labels"]["blur"] == pytest.approx((0.5, 60 / 1e6 / 2, 0.5))


def test_summarize_empty():
    s = fp.summarize([], wall_ns=5000)
    assert s["ops"] == [] and s["busy_share"] == 0 and s["device_ms"] == 0
    assert set(s["labels"]) == set(fp.LABELS.values())


def test_plain_ops_on_a_cpu_profile(tmp_path):
    """The labelled parts of a real CPU profile of a 16x16 textured frame
    with MSAA and bloom: each part's calls equal torch.profiler's own
    count of its spans (chip_smoke.py phase 11 holds the device ms and
    kernels to that parse on the card), with no device events here."""
    from torch.profiler import ProfilerActivity, profile

    from cge_tpu_torch.tools.common import write_textured_obj

    obj = str(tmp_path / "tex.obj")
    write_textured_obj(obj, 9, 8, tex_hw=(8, 12))
    scene = ct.load_scene_from_file(
        obj, [ct.PointLight((-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))],
        device="cpu")
    feats = ct.Features(enable_shading=True, enable_texture_mapping=True,
                        enable_bloom_effect=True,
                        enable_multiple_rays_per_pixel=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ct.render_image(scene, ct.Camera(), feats, ct.RenderParams(), 16, 16)
    got = fp.plain_ops(fp.read_events(prof), fp.LABELS)
    want = {name: 0 for name in fp.LABELS.values()}
    for e in prof.events():
        if e.name in fp.LABELS and e.device_type.name == "CPU":
            want[fp.LABELS[e.name]] += 1
    assert {k: v[0] for k, v in got.items()} == want
    assert want["texels"] and want["bloom"] and want["threefry"]
    assert all(ms == 0 and n == 0 for _, ms, n in got.values())


def test_driver_on_cpu(capsys):
    s = fp.run("brute", frames=1, size=32, device="cpu", grid=(9, 8))
    assert s["ops"] == [] and s["busy_share"] == 0 and s["device_ms"] == 0
    assert s["wall_ms"] > 0 and s["device"] == "cpu"
    assert s["launches"]["sweep"] == 0          # the twin ran
    lines = fp.report(s)
    assert any("not measured" in ln for ln in lines)
    assert fp.main(["--scene", "brute", "--device", "cpu", "--size", "16",
                    "--grid", "9", "8", "--frames", "1"]) == 0
    assert "labelled parts" in capsys.readouterr().out


def test_driver_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        fp.run("brute", frames=1, size=16, device="cuda", grid=(9, 8))
