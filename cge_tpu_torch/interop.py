"""Carry scenes and cameras across from the JAX package as numpy.

The JAX package's `SceneArrays` leaves and `Camera` fields, converted to
numpy by the caller, become the port's tensors. Tests build a scene once in
JAX and hand the same arrays to both renderers; this is the port's way of
loading the other side's "weights". Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np

import torch

from cge_tpu_torch.camera import Camera
from cge_tpu_torch.diff.gradients import DIFF_FIELDS
from cge_tpu_torch.scene.scene import (TENSOR_FIELDS, resolve_device,
                                       scene_from_numpy)


def camera_from_numpy(fovy, distance, look_at, rotation,
                      aspect) -> Camera:
    """Camera fields (numpy scalars or arrays) -> the port's Camera."""
    return Camera(fovy=float(np.asarray(fovy)),
                  distance=float(np.asarray(distance)),
                  look_at=tuple(float(x) for x in np.asarray(look_at)),
                  rotation=tuple(float(x) for x in np.asarray(rotation)),
                  aspect=float(np.asarray(aspect)))


def params_from_numpy(params: dict, device=None) -> dict:
    """The JAX package's `scene_params` (numpy leaves) -> the port's
    differentiable leaves, f32 tensors on `device` (the card by default),
    for `with_params`."""
    missing = [k for k in DIFF_FIELDS if k not in params]
    if missing:
        raise KeyError(f"differentiable leaves missing: {missing}")
    device = resolve_device(device)
    return {k: torch.from_numpy(np.asarray(params[k], np.float32).copy())
            .to(device) for k in DIFF_FIELDS}


__all__ = ["DIFF_FIELDS", "TENSOR_FIELDS", "camera_from_numpy",
           "params_from_numpy", "scene_from_numpy"]
