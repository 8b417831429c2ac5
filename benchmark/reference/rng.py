"""Threefry-2x32 counter RNG with ``jax.random``'s bit semantics
(``jax_threefry_partitionable=True``): ``key(seed)`` is
``[seed >> 32, seed & 0xFFFFFFFF]``, ``fold_in(k, d)`` is
``threefry2x32(k, (0, d))``, and ``uniform(k, shape)`` draws element ``i``
as ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``, keeps ``x0 ^ x1`` and
maps its top 23 bits to [0, 1).  Keys are int64 tensors ``(..., 2)``
holding uint32 words."""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """20 rounds on broadcastable int64 tensors of uint32 values."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    x0, x1 = (x.contiguous() for x in torch.broadcast_tensors(x0, x1))
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    kb = k.reshape(k.shape[:-1] + (1, 2))
    b0, b1 = threefry2x32(kb[..., 0], kb[..., 1], i >> 32, i & M32)
    return (b0 ^ b1).reshape(k.shape[:-1] + tuple(shape))


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape=()) -> torch.Tensor:
    return bits_to_unit_float(random_bits(k, shape))
