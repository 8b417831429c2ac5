"""Threefry-2x32 counter RNG bit-exact with ``jax.random`` + analytic samplers.

Port of ``path_tracer_tpu/utils/rng.py``.  The JAX engines draw every random
number from threefry2x32 ``fold_in`` chains (base → sample → pixel → iters →
stream); reproducing those bits exactly is what lets the port integrate the
same (sample, pixel, bounce) set as the JAX package.  Semantics pinned here
(JAX 0.9.0, ``jax_threefry_partitionable=True``, the default):

* ``key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``.
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))`` — both output words.
* ``uniform(k, shape)`` draws element ``i`` (flat index) as
  ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))`` and keeps ``x0 ^ x1``;
  the float is ``bitcast((bits >> 9) | 0x3F800000) - 1``.

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 values; all
arithmetic is uint32 arithmetic on masked int64 (torch has no full uint32
support on every backend).
"""
from __future__ import annotations

import math

import torch

from . import vec
from .vec import sqrt32

TWO_PI = 2.0 * math.pi
M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable int64 uint32-valued tensors.

    Six tensor ops a round, in place on the two words after they are
    broadcast to one shape: between key injections ``x0`` keeps the carries
    of its sums above bit 31 (below 2**35 after four rounds), and the one
    mask of ``x1 = (rotl(x1) ^ x0) & M32`` drops them together with the
    rotation's high bits, so every value read is the uint32 one."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    x0, x1 = (x.contiguous() for x in torch.broadcast_tensors(x0, x1))
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1)
            t = x1 << r
            x1 = t.bitwise_or_(t >> 32).bitwise_xor_(x0).bitwise_and_(M32)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(M32)
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)`` key data for a non-negative integer seed."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The (…, 2) uint32 words of a key, as int64."""
    return k


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` for a key (…, 2) and int data (scalar or (…,))."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """Partitionable 32-bit random bits: (…key batch) + shape, int64."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    kb = k.reshape(k.shape[:-1] + (1,) * 1 + (2,))
    b0, b1 = threefry2x32(kb[..., 0], kb[..., 1], i >> 32, i & M32)
    return (b0 ^ b1).reshape(k.shape[:-1] + tuple(shape))


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in [0, 1), batched over key dims."""
    return bits_to_unit_float(random_bits(k, shape))


# --- analytic samplers (fixed number of uniforms each; no rejection) ---

def random_unit_vector(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = sqrt32(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def random_on_hemisphere(u, normal):
    d = random_unit_vector(u)
    flip = torch.sign(vec.vdot3(d, normal))
    return d * torch.where(flip == 0.0, torch.ones_like(flip), flip)


def random_in_unit_disk(u):
    r = sqrt32(u[..., 0])
    phi = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)


def random_cosine_direction(u, normal):
    r = sqrt32(u[..., 0])
    phi = TWO_PI * u[..., 1]
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = sqrt32(torch.clamp(1.0 - u[..., 0], min=0.0))
    ub, vb, wb = vec.onb_from_w(normal)
    return x[..., None] * ub + y[..., None] * vb + z[..., None] * wb


def sample_henyey_greenstein(u, g):
    g = torch.as_tensor(g, dtype=u.dtype, device=u.device)
    small = torch.abs(g) < 1e-3
    safe_g = torch.where(small, torch.full_like(g, 1e-3), g)
    sq = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u)
    cos_hg = (1.0 + safe_g * safe_g - sq * sq) / (2.0 * safe_g)
    cos_iso = 1.0 - 2.0 * u
    return torch.clamp(torch.where(small, cos_iso, cos_hg), -1.0, 1.0)


def direction_from_cos(u_phi, cos_theta, axis):
    sin_theta = sqrt32(torch.clamp(1.0 - cos_theta * cos_theta, 1e-12, 1.0))
    phi = TWO_PI * u_phi
    ub, vb, wb = vec.onb_from_w(axis)
    return ((sin_theta * torch.cos(phi))[..., None] * ub
            + (sin_theta * torch.sin(phi))[..., None] * vb
            + cos_theta[..., None] * wb)
