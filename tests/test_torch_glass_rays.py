"""transrec512's glass rays (bench_torch/cells.py: the 15,360-triangle
stand-in with its body at d 0.45, the TRANS+REC tree with transparency
shadows and the accel, ray depth 5 and 6 extra transparency levels): the
camera rays of the pixels where the port's frame parted from the JAX
package's, each traced through the port's CPU twins with the cell's
features against JAX's trace op by op (jax.disable_jit()), u8 equal.

The op that parts them is the cluster walk's dense tile. JAX's Pallas
kernel writes its plane t and edge tests as sums of products, and the
CPU's compiler runs the interpreted kernel with each a * b + c contracted
into a fused multiply-add; the port rounds every product and sum apart,
as the compiled reference renderer does. On continuation and mirror rays
whose origin lies on a triangle's plane to float32 precision, o.n - D
comes out 0 in the port (a t = +-0 hit, accepted) and -6e-8 in JAX
(rejected), so the tree goes on through another surface. The port's own
walk parts from JAX on every listed pixel; with the same multiply-adds
fused in its twin's tile (tests/torch_fused_tile.py, patched over
`cluster_sweep._tile_vpu`) the port's pixels are JAX's. The port does not
fuse: fused, transrec512's frame parts from the compiled reference on
more pixels, past the benchmark's rule (PERF.md).

- PALLAS: JAX through its Pallas cluster kernels in interpret mode
  (FORCE_CLUSTER_INTERPRET), the same algorithm as the port's accel path.
  On the parent these nine parted.
- XLA: JAX through its XLA brute sweep (no accel on the CPU); on the
  parent these two parted. They are the two of PALLAS where JAX's two
  paths agree: on the other seven, and on one more of the 198 pixels
  that part from the compiled reference, JAX's Pallas path and its XLA
  path part from each other (the brute sweep's matmuls and
  cross-product edge tests round otherwise), and the port's accel path
  follows the Pallas path.

The XLA path chunks its sweep by ray_tile and tri_tile, which change no
result; one triangle chunk keeps the op count down. The two JAX traces
run side by side in threads.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import cge_tpu
import cge_tpu_torch as ct
from bench_torch import cells as bc
from bench_torch.check import to_u8
from cge_tpu.camera import pixel_grid
from cge_tpu.ops import intersect as jint
from cge_tpu.render import wavefront as jw
from cge_tpu_torch.ops import cluster_sweep as cs
from cge_tpu_torch.ops import rng
from cge_tpu_torch.render import wavefront as tw
from jax_references.make_references import jax_scene
from torch_fused_tile import tile_vpu_fused

CELL = bc.BY_NAME["transrec512"]
KEY = 3                                    # render_image's pinhole key
# (row, column) of the frame, row 0 the top
PALLAS = ((266, 83), (272, 406), (284, 91), (285, 93), (286, 92),
          (315, 398), (324, 386), (342, 439), (380, 258))
XLA = ((286, 92), (380, 258))
XLA_CHUNKS = dict(ray_tile=64, tri_tile=16384)


def _ids(pixels):
    side = CELL.side
    return np.array([(side - 1 - r) * side + c for r, c in pixels])


def _jax_u8(js, idx, accel: bool, chunks: dict):
    with jax.disable_jit():
        o, d = cge_tpu.Camera().generate_rays(
            pixel_grid(CELL.side, CELL.side).reshape(-1, 2))
        rad = jw.trace(js, o[idx], d[idx], cge_tpu.Features(
            **dict(CELL.features, enable_accel_structure=accel)),
            cge_tpu.RenderParams(**dict(CELL.params, **chunks)),
            jax.random.fold_in(jax.random.PRNGKey(CELL.seed), KEY))
        return to_u8(np.asarray(rad))


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    obj = bc.obj_path(CELL, str(tmp_path_factory.mktemp("glass")))
    bc.write_scene(CELL, obj)
    js = jax_scene(CELL, obj)
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(2) as ex:
        # the accel trace takes the Pallas kernels; the accel-off trace
        # has no accel to take them with, so it sweeps through XLA
        mp.setattr(jint, "FORCE_CLUSTER_INTERPRET", True)
        jobs = {"pallas": ex.submit(_jax_u8, js, _ids(PALLAS), True, {}),
                "xla": ex.submit(_jax_u8, js, _ids(XLA), False,
                                 XLA_CHUNKS)}
        scene = bc.load(CELL, obj, "cpu")
        o, d = ct.Camera().generate_rays(
            ct.camera.pixel_grid(CELL.side, CELL.side, "cpu").reshape(-1, 2))
        port = {}
        for name, pixels in (("pallas", PALLAS), ("xla", XLA)):
            it = torch.from_numpy(_ids(pixels))
            for tile in ("unfused", "fused"):
                with pytest.MonkeyPatch.context() as tp, torch.no_grad():
                    if tile == "fused":
                        tp.setattr(cs, "_tile_vpu", tile_vpu_fused)
                    port[name, tile] = to_u8(tw.trace(
                        scene, o[it], d[it], ct.Features(**CELL.features),
                        ct.RenderParams(**CELL.params),
                        rng.fold_in(rng.prng_key(CELL.seed), KEY)).numpy())
        return port, {k: v.result() for k, v in jobs.items()}


def _parted(traces, path, tile, pixels):
    port, ref = traces
    assert CELL.features["enable_transparency"] and \
        CELL.features["enable_accel_structure"]
    assert port[path, tile].shape == (len(pixels), 3)
    # lit glass, not black misses
    assert port[path, tile].max() > 0
    return [p for p, a, b in zip(pixels, port[path, tile], ref[path])
            if (a != b).any()]


@pytest.mark.parametrize("path,pixels", [("pallas", PALLAS), ("xla", XLA)])
def test_glass_rays_match_jax(traces, path, pixels):
    """With the tile fused as XLA fuses JAX's, every pixel is JAX's."""
    assert _parted(traces, path, "fused", pixels) == []


@pytest.mark.parametrize("path,pixels", [("pallas", PALLAS), ("xla", XLA)])
def test_glass_rays_part_from_jax_unfused(traces, path, pixels):
    """The port's own walk rounds the tile unfused, as the compiled
    reference does, and parts from JAX on every listed pixel: the fault
    stands on the port's path, and the fused tile alone repairs it."""
    assert _parted(traces, path, "unfused", pixels) == list(pixels)
