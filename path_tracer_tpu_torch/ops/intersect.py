"""Primitive intersection math on tensors (branch-free, masked lanes).

Port of ``path_tracer_tpu/ops/intersect.py``: the slab test, the packed
16-float leaf-row test of the traversal hot path, and the full-record
sphere/quad/triangle tests used by the brute-force oracle.  Operation order
follows the JAX functions term for term so CPU results agree bit for bit
where the arithmetic is IEEE (+, −, ×, ÷, sqrt).  The CUDA kernels carry the
same math in ``csrc/intersect.cuh``.
"""
from __future__ import annotations

import math

import torch

from ..utils import vec
from ..utils.vec import sqrt32

INF = 1e30


def hit_aabb_s(bmnx, bmny, bmnz, bmxx, bmxy, bmxz,
               rox, roy, roz, ivx, ivy, ivz, t_min, t_max):
    """Slab test on scalar components → (hit, t_near)."""
    tx0 = (bmnx - rox) * ivx
    tx1 = (bmxx - rox) * ivx
    ty0 = (bmny - roy) * ivy
    ty1 = (bmxy - roy) * ivy
    tz0 = (bmnz - roz) * ivz
    tz1 = (bmxz - roz) * ivz
    mx, mn = torch.maximum, torch.minimum
    tn = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mx(mn(tz0, tz1), t_min))
    tf = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mn(mx(tz0, tz1), t_max))
    return tn <= tf, tn


def hit_prim_row_s(r, rox, roy, roz, rdx, rdy, rdz, rr, time, t_min, t_max,
                   mask=(True, True, True)):
    """Packed-row hit test → (hit, t); ``r`` is the row's 16 components."""
    ptype = r[0]
    a0, a1, a2 = r[2], r[3], r[4]
    b0, b1, b2 = r[5], r[6], r[7]
    c0, c1, c2 = r[8], r[9], r[10]
    results = []
    if mask[0]:
        cx = a0 + b0 * time
        cy = a1 + b1 * time
        cz = a2 + b2 * time
        ocx = cx - rox
        ocy = cy - roy
        ocz = cz - roz
        h = rdx * ocx + rdy * ocy + rdz * ocz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - c0
        disc = h * h - rr * cc
        sq = sqrt32(torch.clamp(disc, min=1e-12))
        root0 = (h - sq) / rr
        root1 = (h + sq) / rr
        in0 = (root0 > t_min) & (root0 < t_max)
        in1 = (root1 > t_min) & (root1 < t_max)
        t_s = torch.where(in0, root0, root1)
        hit_s = (disc > 0.0) & (in0 | in1)
        results.append((ptype < 0.5, hit_s, t_s))
    if mask[1]:
        denom = a0 * rdx + a1 * rdy + a2 * rdz
        parallel = denom * denom < 1e-16 * rr
        t_q = ((r[11] - (a0 * rox + a1 * roy + a2 * roz))
               / torch.where(parallel, torch.ones_like(denom), denom))
        alpha = ((b0 * rox + b1 * roy + b2 * roz) - r[12]) + \
            t_q * (b0 * rdx + b1 * rdy + b2 * rdz)
        beta = ((c0 * rox + c1 * roy + c2 * roz) - r[13]) + \
            t_q * (c0 * rdx + c1 * rdy + c2 * rdz)
        interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & \
            (beta <= 1.0)
        hit_q = (~parallel) & (t_q > t_min) & (t_q < t_max) & interior
        results.append(((ptype >= 0.5) & (ptype < 1.5), hit_q, t_q))
    if mask[2]:
        pvx = rdy * c2 - rdz * c1
        pvy = rdz * c0 - rdx * c2
        pvz = rdx * c1 - rdy * c0
        det = b0 * pvx + b1 * pvy + b2 * pvz
        par_t = torch.abs(det) < 1e-9
        inv_det = 1.0 / torch.where(par_t, torch.ones_like(det), det)
        tvx = rox - a0
        tvy = roy - a1
        tvz = roz - a2
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * b2 - tvz * b1
        qvy = tvz * b0 - tvx * b2
        qvz = tvx * b1 - tvy * b0
        vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
        t_t = (c0 * qvx + c1 * qvy + c2 * qvz) * inv_det
        hit_t = (~par_t) & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & \
            (t_t > t_min) & (t_t < t_max)
        results.append((ptype >= 1.5, hit_t, t_t))
    if not results:
        shape = torch.broadcast_shapes(ptype.shape, rox.shape)
        return (torch.zeros(shape, dtype=torch.bool, device=rox.device),
                torch.broadcast_to(torch.as_tensor(t_max, device=rox.device),
                                   shape))
    sel, hit, t = results[-1]
    for sel_i, hit_i, t_i in reversed(results[:-1]):
        hit = torch.where(sel_i, hit_i, hit)
        t = torch.where(sel_i, t_i, t)
    return hit, t


# --- full-record intersectors (brute-force oracle) ---

def hit_sphere(c0, c1, radius, ro, rd, time, t_min, t_max):
    center = vec.lerp(c0, c1, time[..., None] if torch.is_tensor(time)
                      and time.ndim else time)
    oc = center - ro
    a = vec.vdot(rd, rd)
    h = vec.vdot(rd, oc)
    c = vec.vdot(oc, oc) - radius * radius
    disc = h * h - a * c
    sq = sqrt32(torch.clamp(disc, min=1e-12))
    root0 = (h - sq) / a
    root1 = (h + sq) / a
    in0 = (root0 > t_min) & (root0 < t_max)
    in1 = (root1 > t_min) & (root1 < t_max)
    t = torch.where(in0, root0, root1)
    hit = (disc > 0.0) & (in0 | in1)
    p = ro + t[..., None] * rd
    safe_r = torch.where(torch.abs(radius) > 1e-12, radius, torch.ones_like(radius))
    n_out = (p - center) / safe_r[..., None]
    theta = torch.arccos(torch.clamp(-n_out[..., 1], -1.0 + 1e-7, 1.0 - 1e-7))
    phi = torch.atan2(-n_out[..., 2], n_out[..., 0]) + math.pi
    return hit, t, p, n_out, phi / (2.0 * math.pi), theta / math.pi


def hit_quad(q, edge_u, edge_v, normal, w, d, ro, rd, t_min, t_max):
    denom = vec.vdot(normal, rd)
    parallel = torch.abs(denom) < 1e-8
    t = (d - vec.vdot(normal, ro)) / torch.where(parallel, torch.ones_like(denom),
                                            denom)
    p = ro + t[..., None] * rd
    planar = p - q
    alpha = vec.vdot(w, vec.cross(planar, edge_v))
    beta = vec.vdot(w, vec.cross(edge_u, planar))
    interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    hit = (~parallel) & (t > t_min) & (t < t_max) & interior
    return hit, t, p, normal, alpha, beta


def hit_triangle(v0, e1, e2, normal, ro, rd, t_min, t_max):
    pvec = vec.cross(rd, e2)
    det = vec.vdot(e1, pvec)
    parallel = torch.abs(det) < 1e-9
    inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    tvec = ro - v0
    u = vec.vdot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.vdot(rd, qvec) * inv_det
    t = vec.vdot(e2, qvec) * inv_det
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    hit = (~parallel) & inside & (t > t_min) & (t < t_max)
    p = ro + t[..., None] * rd
    return hit, t, p, normal, u, v
