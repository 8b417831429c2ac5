"""Camera rays and the background (port of ``path_tracer_tpu/ops/camera.py``).

:func:`get_ray` and :func:`background_color` keep the JAX signatures, over
any number of rays at once: ``px``/``py`` are ``(N,)`` and a key is ``(N, 2)``.
They are built on the component forms :func:`get_rays_t` and
:func:`background_t` that the wavefront engine uses, so both engines start
and end every path with the same arithmetic.  The CUDA kernels carry it in
``csrc/camera.cuh``.
"""
from __future__ import annotations

import torch

from ..utils import rng
from ..utils.rng import TWO_PI
from ..utils.vec import sqrt32


def get_rays_t(cam, px, py, u5):
    """Primary rays (origin, direction, time) from 5 uniforms per lane."""
    sx = px + u5[0] - 0.5
    sy = py + u5[1] - 0.5
    smx = cam.pixel00[0] + sx * cam.du[0] + sy * cam.dv[0]
    smy = cam.pixel00[1] + sx * cam.du[1] + sy * cam.dv[1]
    smz = cam.pixel00[2] + sx * cam.du[2] + sy * cam.dv[2]
    r = sqrt32(u5[2])
    phi = TWO_PI * u5[3]
    kx = r * torch.cos(phi)
    ky = r * torch.sin(phi)
    no_dof = cam.defocus_angle <= 0.0
    o = [torch.where(no_dof, cam.origin[k],
                     cam.origin[k] + kx * cam.defocus_u[k] + ky * cam.defocus_v[k])
         for k in range(3)]
    return tuple(o), (smx - o[0], smy - o[1], smz - o[2]), u5[4]


def background_t(cam, dx, dy, dz):
    n = torch.clamp(sqrt32(dx * dx + dy * dy + dz * dz), min=1e-12)
    a = 0.5 * (dy / n + 1.0)
    is_grad = cam.bg_type == 1
    return tuple(torch.where(is_grad, (1.0 - a) + a * c, cam.bg_color[k])
                 for k, c in enumerate((0.5, 0.7, 1.0)))


def get_ray(cam, px, py, key):
    """Primary rays for pixels (px, py) → (origin (N,3), direction (N,3),
    time (N,)); the direction is not normalised, as in JAX."""
    u5 = rng.uniform(key, (5,)).unbind(-1)
    o, d, t = get_rays_t(cam, px, py, u5)
    n = px.shape[0]
    return (torch.stack([torch.broadcast_to(c, (n,)) for c in o], -1),
            torch.stack(d, -1), t)


def background_color(cam, rd):
    """Solid background or the gradient sky for directions ``rd`` (N, 3)."""
    return torch.stack(background_t(cam, *rd.unbind(-1)), -1)
