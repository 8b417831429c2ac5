"""Vector math over ``(..., 3)`` tensors (port of ``path_tracer_tpu/utils/vec.py``)."""
from __future__ import annotations

import torch

EPS = 1e-8


def sqrt32(x):
    """IEEE single-precision square root (correctly rounded).

    ``torch.sqrt`` on CPU float32 is not always correctly rounded (the
    vectorised path can land one ulp off near a rounding tie); the CUDA
    kernels (``sqrtf`` with ``-prec-sqrt=true``) and XLA are.  The square
    root of a float computed in float64 and rounded once is the correctly
    rounded float32 result, so the twins use this instead.
    """
    return torch.sqrt(x.double()).to(x.dtype) if x.dtype == torch.float32 \
        else torch.sqrt(x)


def rsqrt32(x):
    """``1 / sqrt(x)`` with two correctly rounded float32 operations."""
    return 1.0 / sqrt32(x)


def vdot(a, b):
    return torch.sum(a * b, dim=-1)


def vdot3(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v):
    return vdot(v, v)


def length(v):
    return sqrt32(vdot(v, v))


def normalize(v):
    return v * rsqrt32(torch.clamp(vdot3(v, v), min=EPS * EPS))


def near_zero(v):
    return torch.all(torch.abs(v) < EPS, dim=-1)


def reflect(v, n):
    return v - 2.0 * vdot3(v, n) * n


def refract(uv, n, etai_over_etat):
    cos_theta = torch.clamp(vdot3(-uv, n), max=1.0)
    eta = torch.as_tensor(etai_over_etat, dtype=uv.dtype, device=uv.device)
    if eta.ndim == uv.ndim - 1:
        eta = eta[..., None]
    r_out_perp = eta * (uv + cos_theta * n)
    r_out_parallel = -sqrt32(torch.clamp(
        1.0 - vdot3(r_out_perp, r_out_perp), min=1e-12)) * n
    return r_out_perp + r_out_parallel


def lerp(a, b, t):
    return a + (b - a) * t


def onb_from_w(w):
    """Orthonormal basis with ``w`` as the third axis (branch-free)."""
    w = normalize(w)
    use_y = (torch.abs(w[..., 0]) > 0.9).to(w.dtype)
    a = torch.stack([1.0 - use_y, use_y, torch.zeros_like(use_y)], dim=-1)
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v, w
