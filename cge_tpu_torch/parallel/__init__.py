"""Multi-device render and train step on torch.distributed (counterpart of
cge_tpu/parallel): `init_distributed`, `make_mesh` and the sharded entry
points of parallel.sharding; the mesh-axis context and the collectives in
parallel.comm."""

from cge_tpu_torch.parallel.sharding import (init_distributed,
                                             loss_and_grads_sharded,
                                             make_mesh,
                                             render_image_sharded,
                                             trace_sharded,
                                             train_step_sharded)

__all__ = ["init_distributed", "loss_and_grads_sharded", "make_mesh",
           "render_image_sharded", "trace_sharded", "train_step_sharded"]
