"""K1, K2's default walk and K3 on the main path's batches, each against
its plain twin, timed beside the twin and its bound; chip_smoke.py phases 2
and 5 report these rows. Beside K1 stands the rest of the key pass: the
stable torch.sort of each block's keys and the cast of the order to int32
(cluster_sweep.sort_keys). --shapes also times K2 in every compiled split
shape (CTAs per cluster, lanes per ray) and K3 under three split rules.

K1 and K2 run on the dragon stand-in (614,400 triangles, field-major tiles)
with the 16,384-ray batches of the 512x512 frame's middle chunk, the main
path's trace_chunk: primary rays with a shared origin, a bounce-like batch
(scattered directions from the hits, a dead third), any-hit shadow rays
toward them, and the first two again at 4 clusters per visit. K3 runs on
the stand-in at teapot size (15,360 triangles) with its primary,
bounce-like and shadow batches. K1's keys, K2's t, ids, visits and
dense tiles and K3's t and ids equal the twins' bit for bit. Times are
CUDA events (tools/common.py device_ms); bounds and
shares come from tools/roofline.py.

    python -m cge_tpu_torch.tools.kernel_bench             # on the card
    python -m cge_tpu_torch.tools.kernel_bench --shapes    # and the shapes
    python -m cge_tpu_torch.tools.kernel_bench --device cpu --dragon 41 32 \\
        --standin 41 16 --res 64 --rays 1024 --reps 1      # tiny, twins
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cge_tpu_torch.camera import Camera, pixel_grid
from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops import sweep
from cge_tpu_torch.ops.intersect import build_accel, closest_hit
from cge_tpu_torch.render.renderer import _swizzle_rows
from cge_tpu_torch.tools import common, roofline

SEED = 0
# K3's split rules of --shapes: (tiles per split, most splits)
SPLIT_RULES = ((1, 128), (2, 64), (4, 32))


def _middle_chunk(res: int, n: int, dev):
    """Camera rays of the res x res frame's middle n-ray chunk, in the
    renderer's tile-swizzled order: it sees the dragon."""
    grid = _swizzle_rows(pixel_grid(res, res, dev).reshape(-1, 2), res, res)
    mid = (res * res // n // 2) * n
    return Camera().generate_rays(grid[mid:mid + n])


def _scattered(n: int, dev):
    rng = np.random.default_rng(SEED)
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    dead = torch.from_numpy(np.arange(n) % 3 == 0).to(dev)
    return torch.from_numpy(sd).to(dev), dead


def walk_batches(scene, accel, dev, res: int = 512, n: int = 16384,
                 pullback: float = 0.0) -> dict:
    """The batches the main path hands K2, at its chunk size: name -> (o,
    d, tmax, shared origin, any-hit, clusters per visit). The secondary
    rays start (bounce) or end (shadow) at the primary hits, moved
    `pullback` back toward the camera."""
    o, d = _middle_chunk(res, n, dev)
    inf = torch.full((n,), torch.inf, device=dev)
    ids = closest_hit(scene, o, d, inf, accel, shared_origin=True)
    p = o + torch.where(ids.hit, ids.t - pullback, 0.0)[:, None] * d
    sd, dead = _scattered(n, dev)
    bounce_tmax = torch.where(ids.hit & ~dead, torch.inf, -1.0)
    light = torch.tensor(common.LIGHT[0], device=dev).expand(n, 3)
    shadow_tmax = torch.where(ids.hit, 1.0, -1.0)
    return {
        "a_primary": (o, d, inf, True, False, 1),
        "b_bounce": (p, sd, bounce_tmax, False, False, 1),
        "c_shadow": (light.contiguous(), (p - light).contiguous(),
                     shadow_tmax, False, True, 1),
        "d_sc4": (o, d, inf, True, False, 4),
        "d_sc4_bounce": (p, sd, bounce_tmax, False, False, 4),
    }


def brute_batches(table, dev, res: int = 512, n: int = 16384) -> dict:
    """K3's batches of the accel-off path: name -> (o, d, tmax): primary
    rays, a bounce-like batch (scattered directions, a dead third) and
    forward shadow rays from the hits to the light."""
    o, d = _middle_chunk(res, n, dev)
    inf = torch.full((n,), torch.inf, device=dev)
    t, i = sweep.closest_tris_plain(o, d, inf, table)
    hit = i >= 0
    p = (o + torch.where(hit, t - 1e-3, 0.0)[:, None] * d).contiguous()
    sd, dead = _scattered(n, dev)
    light = torch.tensor(common.LIGHT[0], device=dev).expand(n, 3)
    return {
        "a_primary": (o.contiguous(), d.contiguous(), inf),
        "b_bounce": (p, sd, torch.where(hit & ~dead, torch.inf, -1.0)),
        "c_shadow": (p, (light - p).contiguous(),
                     torch.where(hit, 1.0, -1.0)),
    }


def check_equal(got, want, what: str) -> None:
    for name, a, b in zip(("t", "ids", "visits", "dense tiles"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differ from the twin")


def check_keys(keys, keys_p, what: str) -> None:
    """K1's keys against the twin's, bit for bit (torch.equal: both round
    alike, and a +-0 key compares equal)."""
    if not torch.equal(keys, keys_p):
        fin = torch.isfinite(keys_p) & torch.isfinite(keys)
        err = float((keys - keys_p)[fin].abs().max()) if fin.any() else 0.0
        raise AssertionError(f"{what}: K1 keys differ from the twin "
                             f"(max |difference| over finite keys {err})")


def timed(ms, plain_ms, bound) -> str:
    """'ms (twin ms) bound ms (kind) share', with 'not measured' off the
    card."""
    share = ("share not measured" if ms is None
             else f"share {bound[0] / ms:.3f}")
    return (f"{common.fmt_ms(ms)} (twin {common.fmt_ms(plain_ms)}) bound "
            f"{bound[0]:.4f} ms ({bound[1]}) {share}")


def walk_rows(scene, accel, dev, res: int = 512, n: int = 16384,
              reps: int = 5, shapes: bool = False) -> list:
    """One row per batch of walk_batches: K1 against its twin, the sort of
    its keys, K2 on the twin's sorted keys against its twin, their times,
    the twins' times and the bounds; with shapes, K2's time in every
    split shape."""
    rows = []
    for name, batch in walk_batches(scene, accel, dev, res, n).items():
        o, d, tmax, shared, any_hit, sc_n = batch
        inp = cs.sweep_setup(o, d, tmax, accel.aabbs, accel.tiles,
                             accel.layout, cs.DEFAULT_BR, sc_n)
        rays, boxes = inp.rays, inp.boxes
        keys_p = cs.block_entry_keys_plain(rays, boxes)
        check_keys(cs.block_entry_keys(rays, boxes), keys_p, f"K1 {name}")
        skeys, order = cs.sort_keys(keys_p)
        call = (order, skeys, rays, inp.tiles)
        kw = dict(layout=accel.layout, sc_n=inp.sc_n, any_hit=any_hit,
                  shared_origin=shared)
        got = cs.cluster_walk(*call, **kw)
        check_equal(got, cs.cluster_walk_plain(*call, **kw), f"K2 {name}")
        row = dict(
            name=name, rays=o.shape[0], blocks=rays.shape[0],
            boxes=boxes.shape[0], live=int((tmax >= 0).sum()),
            hits=int((got[1] >= 0).sum()), sc_n=inp.sc_n,
            visits_mean=float(got[2].float().mean()),
            visits_max=int(got[2].max()),
            keys_ms=common.device_ms(lambda: cs.block_entry_keys(rays, boxes),
                                     dev, reps),
            keys_plain_ms=common.device_ms(
                lambda: cs.block_entry_keys_plain(rays, boxes), dev, 2),
            keys_bound=roofline.keys_bound(rays, boxes.shape[0]),
            sort_ms=common.device_ms(lambda: cs.sort_keys(keys_p), dev, reps),
            ms=common.device_ms(lambda: cs.cluster_walk(*call, **kw), dev,
                                reps),
            plain_ms=common.device_ms(
                lambda: cs.cluster_walk_plain(*call, **kw), dev, 1),
            bound=roofline.walk_bound(call[0], rays, inp.tiles, got, **kw))
        if shapes:
            row["shapes"] = walk_shapes(call, kw, got, dev, reps)
        rows.append(row)
    return rows


def walk_shapes(call, kw, got, dev, reps: int) -> list:
    """(label, ms) of K2 in every compiled split shape; each equal to
    got."""
    out = []
    for shape in cs.SPLIT_SHAPES:
        check_equal(cs.cluster_walk(*call, _shape=shape, **kw), got,
                    f"K2 shape {shape}")
        out.append((f"K2 {shape[0]} CTAs x {shape[1]} lanes",
                    common.device_ms(lambda: cs.cluster_walk(
                        *call, _shape=shape, **kw), dev, reps)))
    return out


def walk_line(row, earlier=None) -> str:
    """A walk row as two lines; earlier: K2's time in an earlier design."""
    ref = "" if earlier is None else f" | earlier {earlier} ms"
    k1 = timed(row["keys_ms"], row["keys_plain_ms"], row["keys_bound"])
    return (f"K2 {row['name']}: rays {row['rays']} blocks {row['blocks']} "
            f"boxes {row['boxes']} live {row['live']} hits {row['hits']} "
            f"sc_n {row['sc_n']} visits mean {row['visits_mean']:.2f} max "
            f"{row['visits_max']} | K1 keys, K2 t/ids/visits/dense equal to "
            f"the twin\n"
            f"    K1 {k1} | sort {common.fmt_ms(row['sort_ms'])} | K2 "
            f"{timed(row['ms'], row['plain_ms'], row['bound'])}{ref}")


def sweep_rows(table, dev, res: int = 512, n: int = 16384, reps: int = 5,
               shapes: bool = False) -> list:
    """One row per batch of brute_batches: K3 against its twin, its time,
    the twin's and the bound; with shapes, its time under each split rule
    of SPLIT_RULES."""
    rows = []
    for name, (o, d, tmax) in brute_batches(table, dev, res, n).items():
        got = sweep.closest_tris(o, d, tmax, table)
        check_equal(got, sweep.closest_tris_plain(o, d, tmax, table),
                    f"K3 {name}")
        row = dict(
            name=name, rays=o.shape[0], live=int((tmax >= 0).sum()),
            hits=int((got[1] >= 0).sum()), triangles=table.shape[0],
            splits=sweep.split_count(table.shape[0]),
            ms=common.device_ms(lambda: sweep.closest_tris(o, d, tmax, table),
                                dev, reps),
            plain_ms=common.device_ms(
                lambda: sweep.closest_tris_plain(o, d, tmax, table), dev, 1),
            bound=roofline.sweep_bound(o, d, tmax, table, got[0]))
        if shapes:
            row["shapes"] = sweep_shapes(o, d, tmax, table, got, dev, reps)
        rows.append(row)
    return rows


def sweep_shapes(o, d, tmax, table, got, dev, reps: int) -> list:
    """(label, ms) of K3 under each split rule; each equal to got."""
    out = []
    keep = sweep.TILES_PER_SPLIT, sweep.MAX_SPLIT
    try:
        for rule in SPLIT_RULES:
            sweep.TILES_PER_SPLIT, sweep.MAX_SPLIT = rule
            check_equal(sweep.closest_tris(o, d, tmax, table), got,
                        f"K3 split rule {rule}")
            out.append((f"a split every {rule[0]} tiles, at most {rule[1]} "
                        f"({sweep.split_count(table.shape[0])})",
                        common.device_ms(
                            lambda: sweep.closest_tris(o, d, tmax, table),
                            dev, reps)))
    finally:
        sweep.TILES_PER_SPLIT, sweep.MAX_SPLIT = keep
    return out


def sweep_line(row, earlier=None) -> str:
    ref = "" if earlier is None else f" | earlier {earlier} ms"
    return (f"K3 {row['name']}: rays {row['rays']} live {row['live']} hits "
            f"{row['hits']} triangles {row['triangles']} splits "
            f"{row['splits']} | t/ids equal to the twin\n"
            f"    K3 {timed(row['ms'], row['plain_ms'], row['bound'])}{ref}")


def print_rows(rows, line) -> None:
    for row in rows:
        print(line(row), flush=True)
        for label, ms in row.get("shapes", ()):
            print(f"      {label}: {common.fmt_ms(ms)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_args(ap)
    ap.add_argument("--dragon", type=int, nargs=2,
                    default=common.DRAGON_GRID, metavar=("RINGS", "SEGS"))
    ap.add_argument("--standin", type=int, nargs=2,
                    default=common.TEAPOT_GRID, metavar=("RINGS", "SEGS"))
    ap.add_argument("--rays", type=int, default=16384,
                    help="rays a batch (the main path's trace_chunk)")
    ap.add_argument("--shapes", action="store_true",
                    help="also time K2 in every split shape, K3 under each "
                         "split rule")
    args = ap.parse_args(argv)
    dev = common.device_from(args.device)
    print(common.card_line(dev), flush=True)
    scene = common.standin_scene(tuple(args.dragon), dev)
    print_rows(walk_rows(scene, build_accel(scene), dev, args.res, args.rays,
                         args.reps, args.shapes), walk_line)
    tscene = common.standin_scene(tuple(args.standin), dev)
    table = sweep.pack_tri_table(tscene.vertices, tscene.tris,
                                 tscene.tri_mask)
    print_rows(sweep_rows(table, dev, args.res, args.rays, args.reps,
                          args.shapes), sweep_line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
