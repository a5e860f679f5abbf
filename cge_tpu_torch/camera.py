"""Trackball camera and primary rays (counterpart of cge_tpu/camera.py:25-162).

Replicates the reference Trackball (framework/src/trackball.cpp):
position = lookAt + quat(euler) * (0, 0, -dist); the camera-space direction
is normalize((-px.x * halfW, px.y * halfH, 1)) rotated by the quaternion,
with the reference's negated x.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cge_tpu_torch.scene.scene import resolve_device


def quat_from_euler(euler: torch.Tensor) -> torch.Tensor:
    """glm::quat(glm::vec3 eulerAngles): (..., 3) radians -> (w, x, y, z)."""
    c = torch.cos(euler * 0.5)
    s = torch.sin(euler * 0.5)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    return torch.stack([cx * cy * cz + sx * sy * sz,
                        sx * cy * cz - cx * sy * sz,
                        cx * sy * cz + sx * cy * sz,
                        cx * cy * sz - sx * sy * cz], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternion q (..., 4) = (w, x, y, z)."""
    w = q[..., :1]
    u = q[..., 1:].expand(v.shape)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


@dataclasses.dataclass(frozen=True)
class Camera:
    """CameraConfig (src/config.h:16-21) in radians."""

    fovy: float = float(np.radians(50.0))
    distance: float = 3.0
    look_at: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (float(np.radians(20.0)), float(np.radians(20.0)), 0.0)
    aspect: float = 1.0

    def _quat(self, device):
        return quat_from_euler(torch.tensor(self.rotation, dtype=torch.float32,
                                            device=device))

    def position(self, device=None) -> torch.Tensor:
        """trackball.cpp:71-74, on `device` (resolve_device: the card by
        default)."""
        device = resolve_device(device)
        back = torch.tensor([0.0, 0.0, -self.distance], dtype=torch.float32,
                            device=device)
        return (torch.tensor(self.look_at, dtype=torch.float32, device=device)
                + quat_rotate(self._quat(device), back))

    def generate_rays(self, pixels: torch.Tensor):
        """Trackball::generateRay (trackball.cpp:101-110), batched.
        pixels: (..., 2) NDC in [-1, 1] -> (origins, unit directions)."""
        dev = pixels.device
        half_h = torch.tan(torch.tensor(self.fovy, dtype=torch.float32,
                                        device=dev) / 2.0)
        half_w = self.aspect * half_h
        cam_dir = torch.stack([-pixels[..., 0] * half_w,      # negated x
                               pixels[..., 1] * half_h,
                               torch.ones_like(pixels[..., 0])], dim=-1)
        cam_dir = cam_dir / torch.sqrt((cam_dir * cam_dir).sum(-1,
                                                              keepdim=True))
        world_dir = quat_rotate(self._quat(dev), cam_dir)
        origin = self.position(dev).expand(world_dir.shape)
        return origin, world_dir


def pixel_grid(width: int, height: int, device=None) -> torch.Tensor:
    """NDC at each pixel's corner (render.cpp:286-289): (H, W, 2) f32 on
    `device` (resolve_device: the card by default), row iy = screen y
    (bottom first; the image writer flips)."""
    xs = (np.arange(width, dtype=np.float32) / width) * 2.0 - 1.0
    ys = (np.arange(height, dtype=np.float32) / height) * 2.0 - 1.0
    gx, gy = np.meshgrid(xs, ys)
    return torch.from_numpy(np.stack([gx, gy], axis=-1)).to(
        resolve_device(device))
