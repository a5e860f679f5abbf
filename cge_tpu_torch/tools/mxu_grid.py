"""K2's tensor-core mode against the default walk (counterpart of
tools/tune_mxu.py).

kernel: the 15,360-triangle dragon stand-in with the accel (triangle
layout) and res x res tile-swizzled primary rays. Closest hit for {default
walk, mxu} x {exact keys, frustum keys} x shared_origin, each with the
device ms (CUDA events) of the whole sweep and of K2 alone, and its parity
against the default walk with exact keys: hit_match, max_terr (largest
|dt| over rays that hit on both sides) and id_match (over the same rays).
Then any-hit shadow rays from the hits toward the light for {default,
mxu} x {exact, frustum}, with the share of rays that agree with the
first.

render: the stand-in's res x res u8 frame with shading, hard shadows,
recursive mirrors, interpolated normals and the accel, at trace_chunk in
{65536, 32768, 16384}: device ms per frame and the share of pixels
identical to the first.

    python -m cge_tpu_torch.tools.mxu_grid [kernel|render|all]   # card
    python -m cge_tpu_torch.tools.mxu_grid all --device cpu --segments 16 \\
        --res 32                                                 # tiny
"""

from __future__ import annotations

import argparse

import torch

import cge_tpu_torch as ct
from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops.intersect import build_accel
from cge_tpu_torch.tools import common

HEADLINE = dict(enable_shading=True, enable_hard_shadow=True,
                enable_recursive=True, enable_normal_interp=True,
                enable_accel_structure=True)
TRACE_CHUNKS = (65536, 32768, 16384)


def kernel_grid(scene, dev, res: int, reps: int) -> None:
    accel = build_accel(scene, "triangle")
    o, d = common.primary_rays(res, dev)
    R = o.shape[0]
    tmax = torch.full((R,), torch.inf, device=dev)

    def sweep(o, d, tmax, **kw):
        return cs.cluster_tris(o, d, tmax, accel.aabbs, accel.tiles,
                               accel.layout, **kw)

    t0, i0, _ = sweep(o, d, tmax)
    hit0 = torch.isfinite(t0)
    for mxu in (False, True):
        for exact in (True, False):
            for shared in (False, True):
                kw = dict(mxu=mxu, exact_keys=exact, shared_origin=shared)
                t1, i1, visits = sweep(o, d, tmax, **kw)
                hit1 = torch.isfinite(t1)
                both = hit0 & hit1
                terr = (float((t1 - t0)[both].abs().max()) if both.any()
                        else 0.0)
                idm = (float((i1 == i0)[both].float().mean()) if both.any()
                       else 1.0)
                ms = common.device_ms(lambda kw=kw: sweep(o, d, tmax, **kw),
                                      dev, reps)
                walk = common.device_ms(common.walk_call(
                    o, d, tmax, accel.aabbs, accel.tiles, accel.layout, **kw),
                    dev, reps)
                print(f"closest mxu={int(mxu)} exact={int(exact)} "
                      f"shared={int(shared)}: sweep {common.fmt_ms(ms)}  K2 "
                      f"{common.fmt_ms(walk)}  visits/blk="
                      f"{float(visits.float().mean()):.2f}  hit_match="
                      f"{float((hit0 == hit1).float().mean()):.6f} max_terr="
                      f"{terr:.2e} id_match={idm:.6f}", flush=True)

    # forward shadow rays from the hit points toward the light
    light = scene.point_pos[0]
    dlen = d.norm(dim=-1)
    tn = torch.where(hit0, t0, 0.0) * dlen
    p = o + (d / dlen[:, None]) * (tn - 1e-5)[:, None]
    sdir = (light[None, :] - p).contiguous()
    stm = torch.where(hit0, 1.0, -1.0)
    first = None
    for mxu in (False, True):
        for exact in (True, False):
            kw = dict(mxu=mxu, exact_keys=exact, any_hit=True)
            h1, visits = sweep(p, sdir, stm, **kw)
            first = h1 if first is None else first
            ms = common.device_ms(lambda kw=kw: sweep(p, sdir, stm, **kw),
                                  dev, reps)
            walk = common.device_ms(common.walk_call(
                p, sdir, stm, accel.aabbs, accel.tiles, accel.layout, **kw),
                dev, reps)
            print(f"any_hit mxu={int(mxu)} exact={int(exact)}: sweep "
                  f"{common.fmt_ms(ms)}  K2 {common.fmt_ms(walk)}  visits/blk="
                  f"{float(visits.float().mean()):.2f}  hit_match="
                  f"{float((h1 == first).float().mean()):.6f}", flush=True)


def render_grid(scene, dev, res: int, reps: int) -> None:
    feats = ct.Features(**HEADLINE)
    ref = None
    for tc in TRACE_CHUNKS:
        params = ct.RenderParams(trace_chunk=tc)
        ctx = ct.prepare_render(scene, feats, params)

        def frame(params=params, ctx=ctx):
            return ct.render_image_u8(scene, ct.Camera(), feats, params, res,
                                      res, ctx=ctx)

        img = frame()
        ref = img if ref is None else ref
        ms = common.device_ms(frame, dev, reps)
        print(f"trace_chunk={tc}: u8 frame {common.fmt_ms(ms)}  identical="
              f"{float((img == ref).all(dim=-1).float().mean()):.5f}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="kernel",
                    choices=("kernel", "render", "all"))
    common.add_device_args(ap)
    ap.add_argument("--segments", type=int, default=common.TEAPOT_GRID[1],
                    help="stand-in segments (41 rings): 192 = 15,360 tris")
    args = ap.parse_args(argv)
    dev = common.device_from(args.device)
    print(common.card_line(dev), flush=True)
    scene = common.standin_scene((common.TEAPOT_GRID[0], args.segments), dev)
    print(f"scene: {int(scene.tri_mask.sum())} triangles; rays: "
          f"{args.res * args.res}", flush=True)
    if args.which in ("kernel", "all"):
        kernel_grid(scene, dev, args.res, args.reps)
    if args.which in ("render", "all"):
        render_grid(scene, dev, args.res, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
