"""Streaming bandwidth of the cluster-tile layouts through K4 (counterpart
of tools/exp_dma_layout.py).

Streams three f32 stacks of the dragon's scale (L = 4800 clusters of
C = 128 triangles, normal values from a seeded torch.Generator on the
device) through stream_sum, SC_N = 4 rows per step:

  A  padded  [L, C, 128]  (each triangle's 16 fields padded to 128)
  B  compact [L, C, 16]
  C  flat    [L, C / 8, 128]  (B's bytes as 128-wide rows: [L, 16, 128])

Each line gives the device ms per call and GB/s of the bytes read, warm
(CUDA events around repeated calls on the same stack: B and C fit in the
card's 50 MB L2) and cold (each call timed alone after writing 256 MB, which
evicts the L2), the twin's warm ms, and K4's largest difference from its
twin, which must stay within 1e-6 of the column's sum of |x| (the two add
in different orders). A disagreement exits non-zero.

    python -m cge_tpu_torch.tools.stream_layout                 # on the card
    python -m cge_tpu_torch.tools.stream_layout --device cpu \\
        --clusters 10 --c 8                                     # tiny, twin
"""

from __future__ import annotations

import argparse

import torch

from cge_tpu_torch.ops import stream_probe
from cge_tpu_torch.tools import common


SEED = 0


def make_stacks(L: int, C: int, dev):
    """{name: stack} of the three layouts from one seeded compact stack."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    compact = torch.randn((L, C, 16), generator=g, device=dev)
    return {
        "A padded  [L,C,128]": torch.nn.functional.pad(compact, (0, 112)),
        "B compact [L,C,16] ": compact,
        "C flat    [L,16,128]": compact.reshape(L, C // 8, 128),
    }


def cold_ms(fn, dev, reps: int) -> float | None:
    """Mean device ms of fn called alone after 256 MB of writes, which
    evict the L2; None on the CPU."""
    if dev.type != "cuda":
        return None
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def measure(stack, dev, reps: int) -> dict:
    """K4 against its twin on one stack: ms (warm), cold_ms, plain_ms
    (None on the CPU), err = max |kernel - twin| and its bound."""
    got = stream_probe.stream_sum(stack)
    want = stream_probe.stream_sum_plain(stack)
    n = stack.shape[0] // stream_probe.SC_N * stream_probe.SC_N
    bound = 1e-6 * stack[:n].abs().sum(dim=(0, 1)).max() + 1e-6

    def run():
        return stream_probe.stream_sum(stack)

    return dict(ms=common.device_ms(run, dev, reps),
                cold_ms=cold_ms(run, dev, reps),
                plain_ms=common.device_ms(
                    lambda: stream_probe.stream_sum_plain(stack), dev, reps),
                err=float((got - want).abs().max()), bound=float(bound))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clusters", type=int, default=4800, help="L")
    ap.add_argument("--c", type=int, default=128,
                    help="triangles per cluster, a multiple of 8")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = common.device_from(args.device)
    print(common.card_line(dev), flush=True)
    ok = True
    for name, stack in make_stacks(args.clusters, args.c, dev).items():
        m = measure(stack, dev, args.reps)
        gb = stream_probe.stream_bytes(stack) / 1e9
        good = m["err"] <= m["bound"]
        ok &= good
        times = "ms not measured"
        if m["ms"] is not None:
            times = (f"warm {m['ms']:.4f} ms {gb / (m['ms'] / 1e3):7.1f} "
                     f"GB/s, cold {m['cold_ms']:.4f} ms "
                     f"{gb / (m['cold_ms'] / 1e3):7.1f} GB/s (twin warm "
                     f"{m['plain_ms']:.4f} ms)")
        print(f"{name}: {times}  {gb * 1e3:.1f} MB  max |K4 - twin| "
              f"{m['err']:.3g} (bound {m['bound']:.3g})"
              f"{'' if good else '  MISMATCH'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
