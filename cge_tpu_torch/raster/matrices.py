"""GL-convention camera matrices (counterpart of
cge_tpu/raster/matrices.py).

The matrices the reference hands the fixed-function pipeline (src/
main.cpp:540-554): view = glm::lookAt(position, lookAt, up) (framework/
src/trackball.cpp:81-84) and projection = glm::perspective(fovy, aspect,
0.01, 100) (trackball.cpp:86-89); glm's defaults: right-handed eye space,
clip z in [-1, 1]. Products are spelt out as multiplies and adds in a
fixed order (ops/fp32.py), so the card and the CPU give the same bits.
"""

from __future__ import annotations

import torch

from cge_tpu_torch.ops import fp32
from cge_tpu_torch.scene.scene import resolve_device

NEAR = 0.01   # trackball.cpp:88
FAR = 100.0


def _vec(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def _normalize(v):
    return v / fp32.sqrt_rn(fp32.dot3(v, v))


def look_at(eye, center, up, device=None):
    """glm::lookAtRH: [4, 4] f32, row-major, y = M @ [p, 1]. On eye's
    device when it is a tensor, else on `device` (the card by default)."""
    dev = eye.device if isinstance(eye, torch.Tensor) and device is None \
        else resolve_device(device)
    eye = _vec(eye, dev)
    f = _normalize(_vec(center, dev) - eye)
    s = _normalize(fp32.cross(f, _vec(up, dev)))
    u = fp32.cross(s, f)
    return torch.stack([
        torch.cat([s, -fp32.dot3(s, eye)[None]]),
        torch.cat([u, -fp32.dot3(u, eye)[None]]),
        torch.cat([-f, fp32.dot3(f, eye)[None]]),
        torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
    ])


def perspective(fovy, aspect, near=NEAR, far=FAR, device=None):
    """glm::perspectiveRH_NO (clip z in [-1, 1]): [4, 4] f32 on `device`
    (the card by default)."""
    dev = resolve_device(device)
    t = torch.tan(_vec(fovy, dev) / 2.0)
    z = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    a = _vec(-(far + near) / (far - near), dev)
    b = _vec(-(2.0 * far * near) / (far - near), dev)
    return torch.stack([
        torch.stack([one / (aspect * t), z, z, z]),
        torch.stack([z, one / t, z, z]),
        torch.stack([z, z, a, b]),
        torch.stack([z, z, -one, z]),
    ])


def camera_matrices(camera, width: int, height: int, device=None):
    """(view, proj) of a Camera with the window's aspect (main.cpp:
    542-553), on `device` (the card by default)."""
    dev = resolve_device(device)
    view = look_at(camera.position(dev), camera.look_at, camera.up(dev))
    proj = perspective(camera.fovy, width / height, device=dev)
    return view, proj


def _matmul(a, b):
    """a @ b for small float32 matrices, each entry summed over k in order
    (no device-dependent reduction or TF32)."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def project_vertices(vertices, view, proj, width: int, height: int):
    """World to window coordinates (the GL viewport transform): (xy [V, 2]
    with y up, z_ndc [V], w_clip [V]). w_clip <= 0 marks a vertex at or
    behind the eye plane: the rasterizer drops triangles that touch one
    (no near-plane clipping: a simplification of the preview)."""
    v = vertices.to(view.device, torch.float32)
    vh = torch.cat([v, torch.ones_like(v[:, :1])], dim=1)       # [V, 4]
    clip = _matmul(vh, _matmul(proj, view).T)                   # [V, 4]
    w = clip[:, 3]
    safe_w = torch.where(w != 0, w, 1.0)
    ndc = clip[:, :3] / safe_w[:, None]
    x = (ndc[:, 0] + 1.0) * 0.5 * width
    y = (ndc[:, 1] + 1.0) * 0.5 * height
    return torch.stack([x, y], dim=1), ndc[:, 2], w
