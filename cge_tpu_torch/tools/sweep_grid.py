"""The cluster sweep's tuning grid (counterpart of tools/tune_sweep.py).

Runs one closest-hit sweep (K1 keys, the sort, K2) over res x res
tile-swizzled primary rays for every cluster size C in {32, 64, 128}, rays
per block BR in {256, 512, 1024}, the shared-origin hoist off and on, and
refine_members off and on. Each line gives the device ms per sweep and
of K2 alone (CUDA events), the mean supercluster visits per block, the
dense tiles run, and Gpairs/s: the ray x triangle pairs of the dense
tiles run (tiles x C x BR) per second of K2.

The JAX tool sweeps the reference teapot, which needs the reference data
directory; this one sweeps the 15,360-triangle dragon stand-in
(tools/make_large_asset.write_obj(path, 41, 192)).

    python -m cge_tpu_torch.tools.sweep_grid                 # on the card
    python -m cge_tpu_torch.tools.sweep_grid --device cpu \\
        --segments 16 --res 32 --cs 32 --brs 128             # tiny, twins
"""

from __future__ import annotations

import argparse
import itertools

import torch

from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops.bvh import build_clusters
from cge_tpu_torch.tools import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_args(ap)
    ap.add_argument("--segments", type=int, default=common.TEAPOT_GRID[1],
                    help="stand-in segments (41 rings): 192 = 15,360 tris")
    ap.add_argument("--cs", type=int, nargs="+", default=[32, 64, 128],
                    help="cluster sizes")
    ap.add_argument("--brs", type=int, nargs="+", default=[256, 512, 1024],
                    help="rays per block")
    args = ap.parse_args(argv)
    dev = common.device_from(args.device)
    print(common.card_line(dev), flush=True)
    scene = common.standin_scene((common.TEAPOT_GRID[0], args.segments), dev)
    o, d = common.primary_rays(args.res, dev)
    tmax = torch.full((o.shape[0],), torch.inf, device=dev)
    V, T, M = (x.cpu().numpy() for x in (scene.vertices, scene.tris,
                                         scene.tri_mask))
    print(f"scene: {int(M.sum())} triangles; rays: {o.shape[0]}", flush=True)
    results = []
    for C in args.cs:
        perm = torch.from_numpy(build_clusters(V, T, M, cluster_size=C))
        aabbs, tiles, layout = cs.pack_cluster_tiles(
            scene.vertices, scene.tris, perm.long().to(dev))
        for br, so, rm in itertools.product(args.brs, (False, True),
                                            (False, True)):
            def sweep(br=br, so=so, rm=rm):
                return cs.sweep_blocks(o, d, tmax, aabbs, tiles, layout,
                                       br=br, shared_origin=so,
                                       refine_members=rm)

            _, _, visits, dense = sweep()
            ms = common.device_ms(sweep, dev, args.reps)
            walk = common.device_ms(common.walk_call(
                o, d, tmax, aabbs, tiles, layout, br=br, shared_origin=so,
                refine_members=rm), dev, args.reps)
            tiles_run = int(dense.sum())
            pairs = float(tiles_run) * C * br
            rate = "" if walk is None else \
                f"  Gpairs/s={pairs / walk / 1e6:.1f}"
            print(f"C={C:4d} br={br:5d} shared={int(so)} refine={int(rm)}  "
                  f"sweep {common.fmt_ms(ms)}  K2 {common.fmt_ms(walk)}  "
                  f"visits/blk={float(visits.float().mean()):.2f}  dense "
                  f"tiles={tiles_run}  Gpairs={pairs / 1e9:.4f}{rate}",
                  flush=True)
            results.append((ms, tiles_run, C, br, so, rm))
    if dev.type == "cuda":
        best = min(results, key=lambda r: r[0])
        print(f"best by ms: C={best[2]} br={best[3]} shared={int(best[4])} "
              f"refine={int(best[5])} {best[0]:.4f} ms")
    else:
        best = min(results, key=lambda r: r[1])
        print(f"best by dense tiles (no times on the CPU): C={best[2]} "
              f"br={best[3]} shared={int(best[4])} refine={int(best[5])} "
              f"{best[1]} tiles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
