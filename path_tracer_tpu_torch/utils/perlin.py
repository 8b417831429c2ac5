"""Perlin noise: host-side table generation + batched tensor evaluation.

Port of ``path_tracer_tpu/utils/perlin.py``.  :func:`make_tables` is the
same numpy code with the same seed, so both packages hold identical tables;
:func:`turb_t` is the batched 7-octave turbulence with plain row gathers
(the JAX package's one-hot ``_rows_256`` is a TPU matrix-unit trick).
"""
from __future__ import annotations

import numpy as np
import torch

POINT_COUNT = 256


def make_tables(seed: int = 0):
    """``(ranvec (256, 4) f32, perm (3, 256) i32)`` numpy tables."""
    rng = np.random.default_rng(seed)
    ranvec = rng.uniform(-1.0, 1.0, size=(POINT_COUNT, 3)).astype(np.float32)
    ranvec /= np.maximum(np.linalg.norm(ranvec, axis=-1, keepdims=True), 1e-8)
    ranvec = np.concatenate(
        [ranvec, np.zeros((POINT_COUNT, 1), np.float32)], axis=1)
    perm = np.stack(
        [rng.permutation(POINT_COUNT).astype(np.int32) for _ in range(3)]
    )
    return ranvec, perm


def _noise_t(ranvec, perm, px, py, pz):
    """Gradient Perlin noise on tensors of any shape (same op order as JAX)."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    u, v, w = px - fx, py - fy, pz - fz
    ix = fx.to(torch.int64) & 255
    iy = fy.to(torch.int64) & 255
    iz = fz.to(torch.int64) & 255
    pl = perm.to(torch.int64)
    hx = (pl[0][ix], pl[0][(ix + 1) & 255])
    hy = (pl[1][iy], pl[1][(iy + 1) & 255])
    hz = (pl[2][iz], pl[2][(iz + 1) & 255])

    su = u * u * (3.0 - 2.0 * u)
    sv = v * v * (3.0 - 2.0 * v)
    sw = w * w * (3.0 - 2.0 * w)

    acc = None
    for di in (0, 1):
        wu = su if di else (1.0 - su)
        for dj in (0, 1):
            wv = sv if dj else (1.0 - sv)
            for dk in (0, 1):
                ww = sw if dk else (1.0 - sw)
                g = ranvec[hx[di] ^ hy[dj] ^ hz[dk]]
                dot = (g[..., 0] * (u - di) + g[..., 1] * (v - dj)
                       + g[..., 2] * (w - dk))
                term = wu * wv * ww * dot
                acc = term if acc is None else acc + term
    return acc


def turb_t(ranvec, perm, px, py, pz, depth: int = 7):
    """fBm turbulence ``|Σ 0.5^i noise(2^i p)|`` (perlin.py:74-83)."""
    acc = None
    weight = 1.0
    for _ in range(depth):
        n = _noise_t(ranvec, perm, px, py, pz)
        acc = n * weight if acc is None else acc + weight * n
        weight = weight * 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(acc)
