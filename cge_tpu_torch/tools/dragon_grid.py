"""Clusters per visit on the dragon stand-in (counterpart of
tools/exp_r5_dragon.py).

Runs the closest-hit sweep of the 614,400-triangle dragon stand-in's res x
res tile-swizzled primary rays (262,144 at 512) on its field-major stack
(39 MB) at sc_n in {4, 2, 1} clusters per visit, and with refine_members at
sc_n = 2. Each line gives the device ms per sweep and of K2 alone (CUDA
events), the visits and the dense tiles run. Every configuration is then
checked on a 2,048-ray subsample (numpy seed 0) against K3, the port's
brute-force sweep: hit match, t (allclose at rtol 5e-6 / atol 1e-7, and
the largest relative error), and triangle ids in scene space through the
cluster perm.

    python -m cge_tpu_torch.tools.dragon_grid                 # on the card
    python -m cge_tpu_torch.tools.dragon_grid --device cpu --rings 41 \\
        --segments 16 --res 32 --sub 256                      # tiny, twins
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops import sweep
from cge_tpu_torch.ops.intersect import build_accel
from cge_tpu_torch.tools import common

CONFIGS = ((4, False), (2, False), (1, False), (2, True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_args(ap)
    ap.add_argument("--rings", type=int, default=common.DRAGON_GRID[0])
    ap.add_argument("--segments", type=int, default=common.DRAGON_GRID[1])
    ap.add_argument("--sub", type=int, default=2048,
                    help="rays of the subsample checked against K3")
    args = ap.parse_args(argv)
    dev = common.device_from(args.device)
    print(common.card_line(dev), flush=True)
    scene = common.standin_scene((args.rings, args.segments), dev)
    accel = build_accel(scene, "field")
    o, d = common.primary_rays(args.res, dev)
    R = o.shape[0]
    tmax = torch.full((R,), torch.inf, device=dev)
    print(f"scene: {int(scene.tri_mask.sum())} triangles; tiles "
          f"{tuple(accel.tiles.shape)} ({accel.layout}, "
          f"{accel.tiles.numel() * 4 / 1e6:.1f} MB); rays: {R}", flush=True)

    sub = np.random.RandomState(0).choice(R, min(args.sub, R), replace=False)
    sub = torch.from_numpy(np.sort(sub)).to(dev)
    table = sweep.pack_tri_table(scene.vertices, scene.tris, scene.tri_mask)
    bt, bi = sweep.closest_tris(o[sub].contiguous(), d[sub].contiguous(),
                                tmax[sub].contiguous(), table)
    bt, bi = bt.cpu().numpy(), bi.cpu().numpy()
    perm = accel.perm.reshape(-1)
    timed = []
    for sc_n, refine in CONFIGS:
        def run(sc_n=sc_n, refine=refine):
            return cs.sweep_blocks(o, d, tmax, accel.aabbs, accel.tiles,
                                   accel.layout, sc_n=sc_n,
                                   refine_members=refine)

        t_b, i_b, visits, dense = run()
        ms = common.device_ms(run, dev, args.reps)
        walk = common.device_ms(common.walk_call(
            o, d, tmax, accel.aabbs, accel.tiles, accel.layout, sc_n=sc_n,
            refine_members=refine), dev, args.reps)
        timed.append((ms, sc_n, refine))
        t_new = t_b.reshape(-1)[:R][sub].cpu().numpy()
        flat = i_b.reshape(-1)[:R][sub]
        ids = torch.where(flat >= 0, perm[flat.clamp_min(0).long()],
                          -1).cpu().numpy()
        hb, hc = np.isfinite(bt), np.isfinite(t_new)
        ok = hb & hc
        rel = (float(np.abs((t_new[ok] - bt[ok]) / bt[ok]).max())
               if ok.any() else 0.0)
        print(f"sc_n={sc_n} refine={int(refine)}: sweep {common.fmt_ms(ms)}"
              f"  K2 {common.fmt_ms(walk)}  "
              f"visits sum={int(visits.sum())} mean="
              f"{float(visits.float().mean()):.2f}  dense tiles="
              f"{int(dense.sum())} (visits x sc_n "
              f"{int(visits.sum()) * sc_n})", flush=True)
        print(f"  vs K3 on {len(sub)} rays: hit match {(hb == hc).mean():.6f}"
              f"  t allclose "
              f"{np.allclose(t_new[ok], bt[ok], rtol=5e-6, atol=1e-7)}  "
              f"max rel err {rel:.3g}  id match "
              f"{(ids[ok] == bi[ok]).mean() if ok.any() else 1.0:.6f}",
              flush=True)
    if dev.type == "cuda":
        best = min(timed, key=lambda r: r[0])
        print(f"best: sc_n={best[1]} refine={int(best[2])} {best[0]:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
