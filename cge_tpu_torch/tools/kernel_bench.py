"""K1, K2's default walk, K2's tensor-core mxu mode and K3 on the main
path's batches, each against its plain twin, timed beside the twin and its
bound; chip_smoke.py phases 2, 5 and 8 report these rows. Beside K1 stands
the rest of the key pass: the stable torch.sort of each block's keys and
the cast of the order to int32 (cluster_sweep.sort_keys). --shapes also
times K2 in every compiled split shape (CTAs per cluster, lanes per ray),
the mxu mode in every compiled shape (CTAs per cluster, warps per M tile)
and K3 under three split rules.

K1 and K2 run on the dragon stand-in (614,400 triangles, field-major tiles)
with the 16,384-ray batches of the 512x512 frame's middle chunk, the main
path's trace_chunk: primary rays with a shared origin, a bounce-like batch
(scattered directions from the hits, a dead third), any-hit shadow rays
toward them, and the first two again at 4 clusters per visit. The mxu mode
(triangle layout only) and K3 run on the stand-in at teapot size (15,360
triangles) with its primary, bounce-like and shadow batches. K1's keys,
K2's t, ids, visits and dense tiles and K3's t and ids equal the twins'
bit for bit; the mxu mode agrees with its twin and with the default walk
within MXU_TOL, at 512 rays a block and, on primary rays, at
MXU_CHECK_BRS; on primary rays it also walks a copy of the stack with
exact-t ties and pad rows (tied_stack) at every block size, where the ids
of rays that hit the tied clusters equal the twin's. Times are
CUDA events (tools/common.py device_ms); bounds and
shares come from tools/roofline.py.

    python -m cge_tpu_torch.tools.kernel_bench             # on the card
    python -m cge_tpu_torch.tools.kernel_bench --shapes    # and the shapes
    python -m cge_tpu_torch.tools.kernel_bench --device cpu --dragon 41 32 \\
        --standin 41 16 --res 64 --rays 1024 --reps 1      # tiny, twins
"""

from __future__ import annotations

import argparse
import dataclasses

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
# the mxu mode against its twin (torch.matmul, TF32 off) or the default
# walk: the two-dot form on 3-piece TF32 products rounds differently, so a
# grazing ray may flip
MXU_TOL = dict(hit_frac=0.9999, id_frac=0.9999, t_rel=1e-5)
# the other block sizes the mxu rows check on primary rays: those the split
# walk's shapes take besides the default 512
MXU_CHECK_BRS = (128, 1024)


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


def mxu_agreement(got, want, any_hit: bool):
    """(hit fraction, id fraction over rays that hit on both sides, max
    |dt| / max(1, t) over rays with equal ids, max |dt| there)."""
    t, i = got[0].reshape(-1), got[1].reshape(-1)
    tw, iw = want[0].reshape(-1), want[1].reshape(-1)
    h = (i > 0) if any_hit else torch.isfinite(t)
    hw = (iw > 0) if any_hit else torch.isfinite(tw)
    hit_frac = float((h == hw).float().mean())
    if any_hit:
        return hit_frac, 1.0, 0.0, 0.0
    both = h & hw
    same = both & (i == iw)
    id_frac = float(same.sum()) / max(1, int(both.sum()))
    if not same.any():
        return hit_frac, id_frac, 0.0, 0.0
    err = (t - tw).abs()[same]
    rel = float((err / tw.abs()[same].clamp_min(1.0)).max())
    return hit_frac, id_frac, rel, float(err.max())


def check_mxu(got, want, any_hit: bool, what: str) -> tuple:
    """mxu_agreement of got against want; raises outside MXU_TOL."""
    agree = mxu_agreement(got, want, any_hit)
    hit, idf, rel, _ = agree
    if (hit < MXU_TOL["hit_frac"] or idf < MXU_TOL["id_frac"]
            or rel > MXU_TOL["t_rel"]):
        raise AssertionError(f"{what}: hits {hit:.6f} ids {idf:.6f} max "
                             f"|dt|/max(1,t) {rel:.3g} outside {MXU_TOL}")
    return agree


def tied_stack(aabbs, tiles, hot: int, pad: int):
    """A copy of the triangle stack ([Lp, 8] boxes, [Lp, C, 16] tiles)
    with exact-t ties and pad rows: in cluster hot, slots C-1-i repeat
    slots i (ties across a row's lanes and across warps: the larger slot
    must win); the next cluster repeats that tile with its box grown to
    cover it (ties across visits, or across members at 2 clusters a
    visit: the later must win); in cluster pad, slots 40-47 are pad rows
    (n = 0, b = 1: t = NaN, never accepted). Returns (aabbs, tiles, the
    two tied clusters)."""
    a, t = aabbs.clone(), tiles.clone()
    C = t.shape[1]
    other = (hot + 1) % t.shape[0]
    t[hot, C // 2:] = t[hot, :C // 2].flip(0)
    t[other] = t[hot]
    a[other, 0:3] = torch.minimum(a[other, 0:3], a[hot, 0:3])
    a[other, 3:6] = torch.maximum(a[other, 3:6], a[hot, 3:6])
    t[pad, 40:48] = torch.tensor(cs._INVALID_ROW, device=t.device)
    return a, t, (hot, other)


def check_ties(got, want, C: int, tied, what: str, least: int = 1) -> int:
    """The mxu walk on a tied_stack against its twin: every ray that hits
    the tied clusters on both sides has the twin's id, and its slot lies in
    the upper half (the larger of two tied slots won). Returns the number
    of those rays; raises if there are fewer than least or one breaks the
    rule."""
    i, iw = got[1].reshape(-1).long(), want[1].reshape(-1).long()
    cl = torch.tensor(tied, device=i.device)
    on = ((i >= 0) & (iw >= 0) & torch.isin(i // C, cl)
          & torch.isin(iw // C, cl))
    n = int(on.sum())
    if n < least:
        raise AssertionError(f"{what}: {n} rays hit the tied clusters")
    if not torch.equal(i[on], iw[on]):
        raise AssertionError(f"{what}: {int((i[on] != iw[on]).sum())} of {n}"
                             f" rays on the tied clusters differ from the twin")
    if bool((i[on] % C < C // 2).any()):
        raise AssertionError(f"{what}: a smaller tied slot won")
    return n


def _mxu_ties(o, d, tmax, accel, ids) -> list:
    """(block size, tied rays) of the mxu walk on a tied_stack of the
    accel (the cluster the ids hit most tied, the second pad rows) against
    its twin, at DEFAULT_BR and MXU_CHECK_BRS, within MXU_TOL and under
    check_ties."""
    L, C = accel.tiles.shape[0], accel.tiles.shape[1]
    flat = ids.reshape(-1)
    counts = torch.bincount((flat[flat >= 0] // C).long(), minlength=L)
    hot, second = (int(x) for x in torch.argsort(counts, descending=True,
                                                 stable=True)[:2])
    pad = second if second != (hot + 1) % L else int(
        torch.argsort(counts, descending=True, stable=True)[2])
    a, t, tied = tied_stack(accel.aabbs, accel.tiles, hot, pad)
    tacc = dataclasses.replace(accel, aabbs=a, tiles=t)
    out = []
    for br in (cs.DEFAULT_BR, *MXU_CHECK_BRS):
        call, kw = _mxu_call(o, d, tmax, tacc, False, br)
        got = cs.cluster_walk(*call, mxu=True, **kw)
        twin = cs.cluster_walk_plain(*call, mxu=True, **kw)
        what = f"mxu tied stack at {br} rays a block"
        check_mxu(got, twin, False, f"{what} vs twin")
        out.append((br, check_ties(got, twin, C, tied, what)))
    return out


def _mxu_call(o, d, tmax, accel, any_hit: bool, br: int):
    """K2's arguments for one batch on the triangle-layout accel, one
    cluster a visit, with K1's keys sorted."""
    inp = cs.sweep_setup(o, d, tmax, accel.aabbs, accel.tiles, accel.layout,
                         br, 1)
    skeys, order = cs.sweep_order(inp.rays, inp.boxes)
    return ((order, skeys, inp.rays, inp.tiles),
            dict(layout=accel.layout, sc_n=1, any_hit=any_hit))


def mxu_rows(scene, dev, res: int = 512, n: int = 16384, reps: int = 5,
             shapes: bool = False) -> list:
    """One row per primary, bounce-like and shadow batch of walk_batches on
    the scene's triangle-layout accel, the secondary rays 1e-3 off the
    surface (as the renderer's offsets put them: a ray that starts on a
    surface meets it at t ~ 0, where the t >= 0 test flips under any change
    of rounding): the default walk equal to its twin, the mxu mode within
    MXU_TOL of its twin and of the default walk, the primary batch also at
    MXU_CHECK_BRS rays a block and on a tied_stack at every block size
    (_mxu_ties); the mxu mode's time beside the default
    walk's and its twin's, and its bound; with shapes, its time in every
    compiled shape that fits, each equal to the default shape's result."""
    accel = build_accel(scene, "triangle")
    batches = walk_batches(scene, accel, dev, res, n, pullback=1e-3)
    rows = []
    for name in ("a_primary", "b_bounce", "c_shadow"):
        o, d, tmax, _, any_hit, _ = batches[name]
        call, kw = _mxu_call(o, d, tmax, accel, any_hit, cs.DEFAULT_BR)
        base = cs.cluster_walk(*call, **kw)
        check_equal(base, cs.cluster_walk_plain(*call, **kw), f"K2 {name}")
        got = cs.cluster_walk(*call, mxu=True, **kw)
        twin = cs.cluster_walk_plain(*call, mxu=True, **kw)
        agree = {"twin": check_mxu(got, twin, any_hit, f"mxu {name} vs twin"),
                 "default walk": check_mxu(got, base, any_hit,
                                           f"mxu {name} vs the default walk")}
        row = dict(
            name=name, rays=o.shape[0], blocks=call[2].shape[0],
            live=int((tmax >= 0).sum()),
            hits=int(((got[1] == 1) if any_hit else (got[1] >= 0)).sum()),
            visits_mean=float(got[2].float().mean()),
            visits_max=int(got[2].max()), agree=agree,
            err=agree["twin"][3],
            ms=common.device_ms(lambda: cs.cluster_walk(*call, mxu=True, **kw),
                                dev, reps),
            walk_ms=common.device_ms(lambda: cs.cluster_walk(*call, **kw), dev,
                                     reps),
            plain_ms=common.device_ms(lambda: cs.cluster_walk_plain(
                *call, mxu=True, **kw), dev, 1),
            bound=roofline.walk_bound(call[0], call[2], call[3], got, mxu=True,
                                      **kw))
        if name == "a_primary":
            row["brs"] = []
            for br in MXU_CHECK_BRS:
                c, k = _mxu_call(o, d, tmax, accel, any_hit, br)
                row["brs"].append((br, check_mxu(
                    cs.cluster_walk(*c, mxu=True, **k),
                    cs.cluster_walk_plain(*c, mxu=True, **k), any_hit,
                    f"mxu {name} at {br} rays a block vs twin")))
            row["ties"] = _mxu_ties(o, d, tmax, accel, base[1])
        if shapes:
            row["shapes"] = mxu_shapes(call, kw, got, dev, reps)
        rows.append(row)
    return rows


def mxu_shapes(call, kw, got, dev, reps: int) -> list:
    """(label, ms) of the mxu mode in every compiled shape that fits the
    block size; each equal to got."""
    out = []
    br = call[2].shape[2]
    for shape in cs.MXU_SHAPES:
        if br % shape[0] or cs.mxu_threads(br, shape) > cs.MXU_MAX_THREADS:
            continue
        check_equal(cs.cluster_walk(*call, mxu=True, _shape=shape, **kw), got,
                    f"K2 mxu shape {shape}")
        out.append((f"K2 mxu {shape[0]} CTAs x {shape[1]} warps an M tile",
                    common.device_ms(lambda: cs.cluster_walk(
                        *call, mxu=True, _shape=shape, **kw), dev, reps)))
    return out


def mxu_line(row, earlier=None) -> str:
    """An mxu row as lines; earlier: the mode's time in an earlier
    design."""
    ref = "" if earlier is None else f" | earlier {earlier} ms"
    ratio = ("not measured" if row["ms"] is None
             else f"{row['ms'] / row['walk_ms']:.2f}")
    agree = " | ".join(
        f"vs {k}: hits {h:.6f} ids {i:.6f} max |dt|/max(1,t) {r:.3g}"
        for k, (h, i, r, _) in row["agree"].items())
    lines = [f"K2 mxu {row['name']}: rays {row['rays']} blocks "
             f"{row['blocks']} live {row['live']} hits {row['hits']} visits "
             f"mean {row['visits_mean']:.2f} max {row['visits_max']} | "
             f"{agree}",
             f"    K2 mxu {timed(row['ms'], row['plain_ms'], row['bound'])} "
             f"| default walk {common.fmt_ms(row['walk_ms'])}, mxu / default "
             f"{ratio}{ref}"]
    for br, (h, i, r, _) in row.get("brs", ()):
        lines.append(f"    at {br} rays a block, vs twin: hits {h:.6f} ids "
                     f"{i:.6f} max |dt|/max(1,t) {r:.3g}")
    for br, n in row.get("ties", ()):
        lines.append(f"    tied stack at {br} rays a block: {n} rays on the "
                     f"tied clusters, ids equal to the twin, the larger slot "
                     f"won")
    return "\n".join(lines)


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
                    help="also time K2 in every split shape, its mxu mode "
                         "in every shape, K3 under each split rule")
    args = ap.parse_args(argv)
    dev = common.device_from(args.device)
    print(common.card_line(dev), flush=True)
    scene = common.standin_scene(tuple(args.dragon), dev)
    print_rows(walk_rows(scene, build_accel(scene), dev, args.res, args.rays,
                         args.reps, args.shapes), walk_line)
    tscene = common.standin_scene(tuple(args.standin), dev)
    print_rows(mxu_rows(tscene, dev, args.res, args.rays, args.reps,
                        args.shapes), mxu_line)
    table = sweep.pack_tri_table(tscene.vertices, tscene.tris,
                                 tscene.tri_mask)
    print_rows(sweep_rows(table, dev, args.res, args.rays, args.reps,
                          args.shapes), sweep_line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
