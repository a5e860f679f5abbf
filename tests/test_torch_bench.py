"""The port's benchmark (bench_torch/) on the CPU: every cell of
BENCHMARK.json through the benchmark's own functions at a toy size (the
9x8 stand-in, a 2-frame window) with the kernels' plain twins, the JAX
cells against the JAX generator (jax_references/make_references.py; the
frame at 64x64, the
train step at 32x32), the compiled reference renderer (tools/oracle/oracle)
against the port's CPU frames under the benchmark's rule, the rule itself
on frames and train steps it must fail, the lower-precision controls, the
stored JAX references, the headline rates and the bounds, and the entry
points without a card.

The rule (bench_torch/check.py) is the golden rule in u8 levels: at least
99.5% of pixels within 1 level in every channel, and the 99.99th
percentile of |difference| at most 13 levels; a train step's loss to rtol
1e-5, each gradient and each leaf's step within 1e-3 of its norm.
"""

import concurrent.futures
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import cge_tpu_torch as ct
from bench_torch import bench, cells as bc, check
from cge_tpu_torch.tools import frame_profile
from jax_references import make_references as mr

REPO = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def _toy(cell):
    """The cell at its test size: the 9x8 stand-in at 32x32, or at 64x64
    for soft512, whose toy run is also the generator's test (JAX's train
    step, op by op, costs the same host time at any size)."""
    return dataclasses.replace(cell, grid=(9, 8),
                               side=64 if cell.name == "soft512" else 32)


@pytest.fixture(scope="module", autouse=True)
def _toy_jax_outputs(tmp_path_factory):
    """make_references' JAX outputs of the two JAX cells at their test
    size, started in a thread as the module's first test starts: the
    tests that do not need them (placed first) run meanwhile."""
    tmp = str(tmp_path_factory.mktemp("toy_refs"))

    def make():
        out = {}
        for cell in bc.CELLS:
            if cell.reference == "jax":
                small = _toy(cell)
                obj = bc.obj_path(small, tmp)
                bc.write_scene(small, obj)
                out[cell.name] = mr.outputs(small, obj)
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(make)


@pytest.fixture(scope="module")
def toy_references(_toy_jax_outputs):
    """The JAX outputs of the toy JAX cells: the references of their toy
    runs."""
    return _toy_jax_outputs.result()


def test_cells_are_the_benchmarks():
    """BENCHMARK.json's workloads are the five cells, in their order, one
    card each, each command naming its cell."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [w["name"] for w in spec["workloads"]]
    assert names == [c.name for c in bc.CELLS] == [
        "scale512", "soft512", "transrec512", "brute512", "train128"]
    for w, c in zip(spec["workloads"], bc.CELLS):
        assert w["chips"] == 1 and w["config"] == c.config
        assert w["frames"] == c.frames >= 15
        assert f"--cell {c.name}" in w["command"]
        assert set(w["metrics"]) == {"frame_ms", "rays_per_s"}
        assert len(w["source"]) <= 200 and w["reduced"] == []
        assert all(m["bound"] >= 0.05 for m in w["metrics"].values())
    assert all(c.params["trace_chunk"] for c in bc.CELLS)


@pytest.mark.parametrize("which", ["scale", "brute", "glass"])
def test_oracle_matches_the_port(which, tmp_path):
    """The compiled reference at 64x64 on the 41x32 stand-in (scale512's
    and brute512's features, and transrec512's glass tree) against the
    port's CPU frame, under the rule; the frames are lit."""
    name = {"scale": "scale512", "brute": "brute512",
            "glass": "transrec512"}[which]
    cell = dataclasses.replace(bc.BY_NAME[name], grid=(41, 32), side=64)
    obj = bc.obj_path(cell, str(tmp_path))
    bc.write_scene(cell, obj)
    raw = str(tmp_path / "oracle.raw")
    ref = check.finish_oracle(check.start_oracle(cell, obj, raw), raw, 64)
    run = bc.setup(cell, bc.load(cell, obj, "cpu"), "cpu")
    got = run.call().numpy()
    verdict = check.compare_frames(got, ref)
    assert verdict["ok"], verdict
    assert (ref.sum(-1) > 0).mean() > 0.1


def _frame(tmp_path):
    cell = dataclasses.replace(bc.BY_NAME["scale512"], grid=(41, 32),
                               side=64)
    obj = bc.obj_path(cell, str(tmp_path))
    bc.write_scene(cell, obj)
    return bc.setup(cell, bc.load(cell, obj, "cpu"), "cpu").call().numpy()


def test_comparator_fails_moved_and_flipped_frames(tmp_path):
    """A frame passes against itself and fails with 1% of its pixels
    moved by 20 levels, or flipped in y."""
    frame = _frame(tmp_path)
    assert check.compare_frames(frame, frame.copy())["ok"]
    moved = frame.astype(np.int16)
    pick = np.random.default_rng(0).choice(
        frame.shape[0] * frame.shape[1], frame.shape[0] * frame.shape[1]
        // 100, replace=False)
    flat = moved.reshape(-1, 3)
    flat[pick] = np.where(flat[pick] >= 128, flat[pick] - 20,
                          flat[pick] + 20)
    moved = moved.astype(np.uint8)
    bad = check.compare_frames(moved, frame)
    assert not bad["ok"] and bad["close_share"] < 0.995
    assert bad["tail_levels"] > check.TAIL_LEVELS
    assert not check.compare_frames(frame[::-1].copy(), frame)["ok"]
    with pytest.raises(ValueError):
        check.compare_frames(frame.astype(np.float32), frame)


def test_stored_references(tmp_path):
    """soft512's JAX frame is 512x512x3 u8 and lit; train128's loss is a
    finite f32, and its gradients and steps are every DIFF_FIELDS leaf in
    f32, at the shapes of the cell's scene on the port (the steps -lr x
    the gradient on TRAIN_LEAVES, 0 elsewhere); each file names its
    commit, command and cell."""
    soft = check.load_reference(bc.BY_NAME["soft512"])
    assert soft["frame"].shape == (512, 512, 3)
    assert soft["frame"].dtype == np.uint8
    assert (soft["frame"].sum(-1) > 0).mean() > 0.05
    cell = bc.BY_NAME["train128"]
    train = check.load_reference(cell)
    assert train["loss"].dtype == np.float32 and np.isfinite(train["loss"])
    obj = bc.obj_path(cell, str(tmp_path))
    bc.write_scene(cell, obj)
    with_shapes = ct.scene_params(bc.load(cell, obj, "cpu"))
    for k, v in with_shapes.items():
        g, step = train[f"grad_{k}"], train[f"step_{k}"]
        assert g.dtype == step.dtype == np.float32, k
        assert g.shape == step.shape == tuple(v.shape), k
        if k in bc.TRAIN_LEAVES:     # sgd_step's step: -lr x gradient
            assert np.linalg.norm(step + bc.TRAIN_LR * g) <= 1e-4 * (
                np.linalg.norm(step)) and np.linalg.norm(step) > 0, k
        else:
            assert not step.any(), k
    for ref in (soft, train):
        meta = ref["meta"]
        assert len(meta["commit"]) == 40 and "make_references" in meta[
            "command"] and meta["cge_tpu_unchanged_from_commit"]


def test_window_rates_see_a_stall():
    """frame_ms and rays_per_s are the window's: its time over its calls
    and all its rays over all its time, so a stalled call moves them
    where it leaves the calls' median where it was."""
    frame_ms, rays_per_s = bench.window([10.0, 10.0, 10.0, 70.0], 1000)
    assert frame_ms["window"] == 25.0 and frame_ms["median"] == 10.0
    assert rays_per_s["window"] == pytest.approx(4000 / 0.1)
    assert rays_per_s["median"] == pytest.approx(1000 / 0.01)
    assert frame_ms["n"] == rays_per_s["n"] == 4


def test_bounds_come_from_the_stored_runs():
    """BENCHMARK.json's bounds are what bench_torch/bounds.py computes from
    the runs in bench_torch/runs/ (three in each host setting) in the
    setting it chooses, and each command runs in that setting: twice the
    widest spread of the window values, between runs or across a run's
    sub-windows, rounded up to 0.01, at least 0.05."""
    from bench_torch import bounds

    runs = bounds.read_runs(sorted(str(p) for p in (
        REPO / "bench_torch" / "runs").glob("*.jsonl")))
    assert len(runs) == 2 and all(
        len(r) == 3 for cells in runs.values() for r in cells.values())
    found = {k: bounds.bounds(v) for k, v in runs.items()}
    chosen = bounds.choose(found)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        assert w["command"] == bounds.command(w["name"], chosen)
        for m, v in w["metrics"].items():
            s, bound = found[chosen][w["name"], m]
            assert v["bound"] == bound >= 2 * max(s["between"], s["within"])


def test_bound_rule_on_made_up_runs():
    """The rule on made-up runs: the floor, the rounding, the sub-windows
    and the choice of the setting with the lower bounds."""
    from bench_torch import bounds

    def run(times, pinned=None):
        times = list(map(float, times))
        fm, rs = bench.window(times, 1000)
        return dict(cell="c", correct=True, times_ms=times, frame_ms=fm,
                    rays_per_s=rs, rays_per_call=1000, pinned=pinned)

    flat = {"c": [run([10.0] * 10)] * 3}
    assert {b for _, b in bounds.bounds(flat).values()} == {0.05}
    # the third run's window is 12: between runs (12 - 10) / 2 / 10 = 0.1
    steps = {"c": [run([10] * 10), run([10] * 10), run([12] * 10)]}
    s, b = bounds.bounds(steps)["c", "frame_ms"]
    assert s["between"] == pytest.approx(0.1) and s["within"] == 0 and (
        b == 0.2)
    # two slow parts of five in a run: its sub-windows' quartiles are 10
    # and 20, though every run's window is the same
    slow = {"c": [run([10] * 6 + [20] * 4)] * 3}
    s, _ = bounds.bounds(slow)["c", "frame_ms"]
    assert s["within"] == pytest.approx(1.0) and s["between"] == 0
    found = {"unpinned": bounds.bounds(steps),
             "pin 2,3": bounds.bounds(flat)}
    assert bounds.choose(found) == "pin 2,3"
    assert bounds.command("c", "pin 2,3") == (
        "python3 bench_torch/bench.py --cell c --pin 2,3")
    assert bounds.setting_of([2, 3]) == "pin 2,3"


def test_round_significand():
    """The controls' rounding: to 7 stored bits it is bfloat16's cast, to
    10 bits float16's in float16's normal range (both to nearest even);
    infinities stay."""
    from bench_torch import control

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * torch.exp(
        torch.randn(4096, generator=g) * 3)
    halfway = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)])
    for v in (x, halfway):
        assert torch.equal(control.round_significand(v, 7),
                           v.to(torch.bfloat16).float())
    normal = x[(x.abs() > 2 ** -14) & (x.abs() < 60000)]
    assert torch.equal(control.round_significand(normal, 10),
                       normal.half().float())
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(control.round_significand(inf, 7), inf)


def _no_card(script: str):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(REPO / "bench_torch" / script),
                        "--cell", "brute512"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "FAIL: no CUDA device" in p.stdout
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_entry_point_needs_a_card():
    """The benchmark's entry point, with no card in sight, exits non-zero
    and prints no result line."""
    _no_card("bench.py")


def test_control_entry_point_needs_a_card():
    """So does the controls' entry point."""
    _no_card("control.py")


def _made_up_trace(k1_seen, launches):
    """A _trace reading of one call whose profile holds k1_seen K1 and
    launches["walk"] K2 kernels."""
    ops = [dict(name="block_entry_keys_kernel(float const*)", count=k1_seen),
           dict(name="void cluster_walk_split_kernel<8, 16, false>()",
                count=launches["walk"])]
    return dict(ops=ops, launches=dict(launches)), []


@pytest.mark.parametrize("k1_seen", [[74], [73, 74], [73, 73, 74],
                                     [73, 73, 73], [75, 0, 73]])
def test_trace_taken_again_when_it_misses_a_counter(k1_seen, monkeypatch):
    """On the card the traced run's kernel counts must equal the launch
    counters: a trace that misses one (the profiler lost a record) is
    taken again, its readings unused, up to TRACE_TAKES traces, and the
    run fails when every take misses; a cell that launched a kernel not
    its own fails at once."""
    launches = dict(keys=74, walk=74, walk_refine=0, walk_mxu=0, sweep=0,
                    stream_probe=0)
    takes = iter(k1_seen)
    monkeypatch.setattr(bench, "_trace", lambda call, calls, device:
                        _made_up_trace(next(takes), launches))
    cell = bc.BY_NAME["transrec512"]
    card = torch.device("cuda", 0)      # _trace is made up: no card used
    good = [i for i, n in enumerate(k1_seen) if n == 74]
    if not good or good[0] >= frame_profile.TRACE_TAKES:
        with pytest.raises(AssertionError, match=(
                r"transrec512: in each of 3 traces the profiler counted "
                r"\d+ keys kernels, the counter 74")):
            bench._counted_trace(cell, None, card, 1)
        return
    prof, _, misses = bench._counted_trace(cell, None, card, 1)
    assert prof["ops"][0]["count"] == 74
    assert misses == [f"the profiler counted {n} keys kernels, the counter "
                      f"74" for n in k1_seen[:good[0]]]
    lines = []
    bench.log_cell(_logged_with_misses(misses), lines.append)
    assert sum("a trace taken again, its readings unused" in line
               for line in lines) == len(misses)
    monkeypatch.setattr(bench, "_trace", lambda call, calls, device:
                        _made_up_trace(74, dict(launches, sweep=2)))
    with pytest.raises(AssertionError, match="launches .* want"):
        bench._counted_trace(cell, None, card, 1)


def _logged_with_misses(misses):
    """A minimal record of a frame cell for log_cell, its traced run with
    these misses."""
    metrics = dict.fromkeys(bench.LAYER_METRICS, 0.0)
    return dict(cell="transrec512", config="c", device="cuda",
                correct=True, check=dict(close_share=1.0, tail_levels=0),
                frame_ms=None, rays_per_call=1,
                setup=dict(write_s=0, load_s=0, oracle_wait_s=0),
                graphs=dict(after_setup=0, after_window=0),
                launches_per_call={}, layer_metrics=metrics,
                layers=dict(profiled_calls=1, busy_over_plain_wall=None,
                            trace_misses=misses, sort=None, top_ops=None,
                            idle_gaps=None))


@pytest.mark.parametrize("name", [c.name for c in bc.CELLS])
def test_cell_runs_at_toy_size(name, toy_references, tmp_path):
    """The cell at toy size (the 9x8 stand-in; a 2-call window) through
    run_cell on the CPU: its output correct against its reference (the
    oracle at 32x32; for soft512 and train128, make_references' JAX
    outputs, so the generator gives what the port gives under the
    benchmark's rule), the timed calls, the traced run, no kernel
    launched (the twins ran), and every per-layer metric BENCHMARK.json
    declares for the cell in its record (those of the device None)."""
    lines = []
    r = bench.run_cell(_toy(bc.BY_NAME[name]), "cpu", str(tmp_path),
                       frames=2, warmup=1, profile_frames=1,
                       reference=toy_references.get(name), log=lines.append)
    assert r["correct"], r["check"]
    assert r["frames"] == 2
    assert r["frame_ms"]["n"] == r["rays_per_s"]["n"] == 2
    assert r["rays_per_s"]["window"] == pytest.approx(
        r["rays_per_call"] / (r["frame_ms"]["window"] / 1e3))
    assert r["rays_per_call"] > 0 and r["trace_chunk"] > 0
    assert r["layer_metrics"]["busy_share"] is None     # no device on the CPU
    assert r["layers"]["profiled_calls"] == 1
    assert not any(r["layers"]["launches"].values())
    assert not any(r["launches_per_call"].values())
    # every per-layer metric BENCHMARK.json declares for the cell, the
    # device's None here; no graph on the CPU
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = [k for k, m in spec["layer_metrics"].items()
                if name in m["workloads"]]
    assert declared and set(declared) <= set(r["layer_metrics"])
    for k in declared:
        value = r["layer_metrics"][k]
        assert (value is None) == (k != "prepare_s"), (k, value)
    assert r["layer_metrics"]["prepare_s"] > 0
    assert r["graphs"] == dict(after_setup=0, after_window=0)
    assert r["layers"]["top_ops"] is r["layers"]["idle_gaps"] is None
    assert lines and lines[0].startswith(f"{name} (")
    json.dumps(r)


@pytest.fixture(scope="module")
def toy_train(tmp_path_factory):
    """train128 at its test size: the cell, its loaded scene and its Run
    (whose call looks up ct.sgd_step when it runs)."""
    cell = _toy(bc.BY_NAME["train128"])
    obj = bc.obj_path(cell, str(tmp_path_factory.mktemp("toy_train")))
    bc.write_scene(cell, obj)
    scene = bc.load(cell, obj, "cpu")
    return cell, scene, bc.setup(cell, scene, "cpu")


def _swapped(real):
    """sgd_step on the wrong leaf: point_pos's gradient stepped into
    point_color, point_pos left."""
    def step(scene, grads, lr):
        return real(scene, dict(grads, point_pos=torch.zeros_like(
            grads["point_pos"]), point_color=grads["point_pos"]), lr)
    return step


_REAL_STEP = ct.sgd_step
STEP_FAULTS = {
    "none": _REAL_STEP,
    "noop": lambda scene, grads, lr: scene,
    "half_rate": lambda scene, grads, lr: _REAL_STEP(scene, grads, lr / 2),
    "sign": lambda scene, grads, lr: _REAL_STEP(scene, grads, -lr),
    "other_leaf": _swapped(_REAL_STEP),
}


@pytest.mark.parametrize("fault", list(STEP_FAULTS))
def test_train_check_holds_the_step(fault, toy_train, toy_references,
                                    monkeypatch):
    """The train check holds what sgd_step made to JAX's step: the sound
    step passes, and a step left out, at half the rate, of the wrong sign
    or on the wrong leaf fails on the step alone (the loss and gradients
    still pass)."""
    cell, scene, run = toy_train
    monkeypatch.setattr(ct, "sgd_step", STEP_FAULTS[fault])
    v = bench.judge(cell, run.call(), toy_references["train128"], scene)
    assert v["loss_rel"] <= check.LOSS_RTOL
    assert v["worst_grad"] <= check.GRAD_NORM_REL
    if fault == "none":
        assert v["ok"] and v["worst_step"] <= check.GRAD_NORM_REL, v
    else:
        assert not v["ok"] and v["worst_step"] > check.GRAD_NORM_REL, v


def test_noop_step_is_not_correct(toy_references, tmp_path, monkeypatch):
    """run_cell with an sgd_step that returns the scene unchanged: the
    cell is not correct and reports no time."""
    monkeypatch.setattr(ct, "sgd_step", STEP_FAULTS["noop"])
    r = bench.run_cell(_toy(bc.BY_NAME["train128"]), "cpu", str(tmp_path),
                       frames=2, warmup=0, profile_frames=1,
                       reference=toy_references["train128"],
                       log=lambda m: None)
    assert not r["correct"] and r["check"]["worst_step"] == 1.0
    assert r["frame_ms"] is None and r["rays_per_s"] is None


@pytest.mark.parametrize("name", ["brute512", "train128"])
def test_control_cell_at_toy_size(name, toy_references, tmp_path):
    """control_cell at toy size on the CPU: the sound output passes its
    check; each control's readings stand beside it, and the bf16 control
    misses at least one limit."""
    from bench_torch import control

    r = control.control_cell(_toy(bc.BY_NAME[name]), "cpu", str(tmp_path),
                             reference=toy_references.get(name))
    assert list(r["rows"]) == ["sound", "bf16", "tf32"]
    assert r["rows"]["sound"]["ok"] and not r["rows"]["sound"]["missed"]
    assert r["rows"]["bf16"]["missed"]
    lines = control.report(r)
    assert lines[0].startswith(f"{name} (cpu)") and len(lines) == 1 + len(
        r["limits"])
    json.dumps(r)
