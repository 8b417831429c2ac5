"""The reference path tracer: every closest hit by testing every primitive,
the published integrator's bounce, one lane per (pixel, sample).

``render_pixels`` returns, for a list of frame pixels, the sum over a range
of samples of each path's radiance.  A path follows the published
integrator (RTiOW books, with constant media, subsurface scattering,
Russian roulette after depth 5): the camera ray from
``uniform(fold_in(key_p, 7), (5,))`` with ``key_p = fold_in(fold_in(key,
sample), pixel)``; at trip ``i`` the closest hit over (``t_min``,
``t_max``), for a hit on a medium boundary the next hit beyond it, and the
bounce's draws from ``fold_in(key_p, i)``.  All arithmetic is elementwise
in the order the published formulas give it, in ``dtype`` (float32 for the
reference; a lower precision for the control).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import rng
from .scene import RefScene

TWO_PI = 2.0 * math.pi
INF = 1e30
W = torch.where
# Elements of one (lanes x primitives) block of hit tests, and lanes traced
# at once: memory, not results, depends on them.
TEST_BLOCK = 1 << 24
LANES = 1 << 18


@dataclass(frozen=True)
class Integrator:
    width: int
    height: int
    max_depth: int
    t_min: float = 1e-3
    t_max: float = 1e9
    rr_min_depth: int = 5
    rr_max_prob: float = 0.95
    sss_max_steps: int = 32

    @property
    def iters(self) -> int:
        return self.max_depth + 8


def sqrt_r(x):
    """Correctly rounded square root (float64 then one rounding) in float32."""
    return torch.sqrt(x.double()).to(x.dtype) if x.dtype == torch.float32 \
        else torch.sqrt(x)


def rsqrt_r(x):
    return 1.0 / sqrt_r(x)


# --- camera -------------------------------------------------------------

def camera_arrays(cam, device, dtype):
    """Viewport basis of the thin-lens camera, worked out in float64."""
    import numpy as np

    w_px, h_px = cam.width, cam.height
    v3 = lambda x: np.asarray(x, np.float64).reshape(3)  # noqa: E731
    center = v3(cam.lookfrom)
    h = math.tan(math.radians(cam.vfov) / 2.0)
    viewport_h = 2.0 * h * cam.focus_distance
    viewport_w = viewport_h * (w_px / h_px)
    unit = lambda v: v / np.linalg.norm(v)  # noqa: E731
    w = unit(v3(cam.lookfrom) - v3(cam.lookat))
    u = unit(np.cross(v3(cam.vup), w))
    v = np.cross(w, u)
    vu, vv = viewport_w * u, viewport_h * -v
    du, dv = vu / w_px, vv / h_px
    upper_left = center - cam.focus_distance * w - vu / 2 - vv / 2
    radius = cam.focus_distance * math.tan(math.radians(cam.defocus_angle) / 2.0)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                  device=device).to(dtype)
    bg = cam.background
    return dict(origin=t(center), pixel00=t(upper_left + 0.5 * (du + dv)),
                du=t(du), dv=t(dv), defocus_u=t(radius * u),
                defocus_v=t(radius * v), defocus=cam.defocus_angle > 0.0,
                gradient=bg is None, bg=t(bg if bg is not None else (0, 0, 0)))


def primary_rays(cam, px, py, u5):
    sx = px + u5[0] - 0.5
    sy = py + u5[1] - 0.5
    sm = [cam["pixel00"][k] + sx * cam["du"][k] + sy * cam["dv"][k]
          for k in range(3)]
    r = sqrt_r(u5[2])
    phi = TWO_PI * u5[3]
    kx, ky = r * torch.cos(phi), r * torch.sin(phi)
    if cam["defocus"]:
        o = [cam["origin"][k] + kx * cam["defocus_u"][k]
             + ky * cam["defocus_v"][k] for k in range(3)]
    else:
        o = [cam["origin"][k].expand_as(px) for k in range(3)]
    return o, [sm[k] - o[k] for k in range(3)], u5[4]


def background(cam, dx, dy, dz):
    if not cam["gradient"]:
        return [cam["bg"][k].expand_as(dx) for k in range(3)]
    n = torch.clamp(sqrt_r(dx * dx + dy * dy + dz * dz), min=1e-12)
    a = 0.5 * (dy / n + 1.0)
    return [(1.0 - a) + a * c for c in (0.5, 0.7, 1.0)]


# --- closest hit by testing every primitive -----------------------------

def _sphere_hits(r, ox, oy, oz, dx, dy, dz, rr, time, t_min, t_max):
    cx = r[:, 0] + r[:, 3] * time
    cy = r[:, 1] + r[:, 4] * time
    cz = r[:, 2] + r[:, 5] * time
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r[:, 6]
    disc = h * h - rr * cc
    sq = sqrt_r(torch.clamp(disc, min=1e-12))
    r0 = (h - sq) / rr
    r1 = (h + sq) / rr
    in0 = (r0 > t_min) & (r0 < t_max)
    in1 = (r1 > t_min) & (r1 < t_max)
    return (disc > 0.0) & (in0 | in1), W(in0, r0, r1)


def _quad_hits(r, ox, oy, oz, dx, dy, dz, rr, time, t_min, t_max):
    a0, a1, a2 = r[:, 0], r[:, 1], r[:, 2]
    b0, b1, b2 = r[:, 3], r[:, 4], r[:, 5]
    c0, c1, c2 = r[:, 6], r[:, 7], r[:, 8]
    denom = a0 * dx + a1 * dy + a2 * dz
    parallel = denom * denom < 1e-16 * rr
    t = (r[:, 9] - (a0 * ox + a1 * oy + a2 * oz)) / W(parallel, 1.0, denom)
    alpha = ((b0 * ox + b1 * oy + b2 * oz) - r[:, 10]) + \
        t * (b0 * dx + b1 * dy + b2 * dz)
    beta = ((c0 * ox + c1 * oy + c2 * oz) - r[:, 11]) + \
        t * (c0 * dx + c1 * dy + c2 * dz)
    inside = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    return (~parallel) & (t > t_min) & (t < t_max) & inside, t


def _triangle_hits(r, ox, oy, oz, dx, dy, dz, rr, time, t_min, t_max):
    a0, a1, a2 = r[:, 0], r[:, 1], r[:, 2]
    b0, b1, b2 = r[:, 3], r[:, 4], r[:, 5]
    c0, c1, c2 = r[:, 6], r[:, 7], r[:, 8]
    pvx = dy * c2 - dz * c1
    pvy = dz * c0 - dx * c2
    pvz = dx * c1 - dy * c0
    det = b0 * pvx + b1 * pvy + b2 * pvz
    par = torch.abs(det) < 1e-9
    inv = 1.0 / W(par, 1.0, det)
    tvx, tvy, tvz = ox - a0, oy - a1, oz - a2
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * b2 - tvz * b1
    qvy = tvz * b0 - tvx * b2
    qvz = tvx * b1 - tvy * b0
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (c0 * qvx + c1 * qvy + c2 * qvz) * inv
    return ((~par) & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            & (t > t_min) & (t < t_max)), t


FAMILIES = (_sphere_hits, _quad_hits, _triangle_hits)


def closest_hit(sc: RefScene, o, d, time, t_min, t_max):
    """(found, prim type, prim index, t) of the nearest hit in (t_min,
    t_max) over every primitive; among equal distances the first in
    family order (spheres, quads, triangles), then in index order."""
    n = o.shape[0]
    dev, dt = o.device, o.dtype
    best_t = torch.full((n,), t_max, dtype=dt, device=dev)
    best_pt = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_pi = torch.full((n,), -1, dtype=torch.int32, device=dev)
    n_all = max(1, sum(rows.shape[0] for rows in sc.test))
    step = max(64, TEST_BLOCK // n_all)
    t_min = torch.as_tensor(t_min, dtype=dt, device=dev).expand(n)
    for s in range(0, n, step):
        e = min(n, s + step)
        ox, oy, oz = (o[s:e, k:k + 1] for k in range(3))
        dx, dy, dz = (d[s:e, k:k + 1] for k in range(3))
        rr = dx * dx + dy * dy + dz * dz
        tm, tmin = time[s:e, None], t_min[s:e, None]
        for f, (fn, rows) in enumerate(zip(FAMILIES, sc.test)):
            if rows.shape[0] == 0:
                continue
            hit, t = fn(rows, ox, oy, oz, dx, dy, dz, rr, tm, tmin, t_max)
            t = W(hit, t, INF)
            tk, k = t.min(dim=1)
            closer = tk < best_t[s:e]
            best_t[s:e] = W(closer, tk, best_t[s:e])
            best_pt[s:e] = W(closer, f, best_pt[s:e])
            best_pi[s:e] = W(closer, k.to(torch.int32), best_pi[s:e])
    return best_pt >= 0, best_pt, best_pi, best_t


# --- the hit record and the bounce ---------------------------------------

def _prim_rows(sc: RefScene, ptype, pidx):
    off = W(ptype == 0, 0, W(ptype == 1, sc.n_sph, sc.n_sph + sc.n_qd))
    uid = torch.clamp(pidx + off, 0, sc.shade.shape[0] - 1)
    uid = W(ptype >= 0, uid, 0)
    return sc.shade.index_select(0, uid.long()).unbind(-1)


def _rows(table, idx):
    return table.index_select(0, idx.long()).unbind(-1)


def refine_hit(sc, ptype, pidx, ox, oy, oz, dx, dy, dz, time, t_min):
    """Hit point, shading normal, front face, (u, v), material and medium
    of the known primitive (every family computed, one selected)."""
    row = _prim_rows(sc, ptype, pidx)
    a0, a1, a2 = row[2], row[3], row[4]
    b0, b1, b2 = row[5], row[6], row[7]
    c0, c1, c2 = row[8], row[9], row[10]
    sn0, sn1, sn2 = row[11], row[12], row[13]
    w0, w1, w2 = row[14], row[15], row[16]
    pd = row[17]

    cx = a0 + (b0 - a0) * time
    cy = a1 + (b1 - a1) * time
    cz = a2 + (b2 - a2) * time
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    ra = dx * dx + dy * dy + dz * dz
    h = dx * ocx + dy * ocy + dz * ocz
    radius = c0
    cc = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius
    disc = h * h - ra * cc
    sq = sqrt_r(torch.clamp(disc, min=1e-12))
    r0 = (h - sq) / ra
    r1 = (h + sq) / ra
    in0 = (r0 > t_min) & (r0 < INF)
    t_s = W(in0, r0, r1)
    spx, spy, spz = ox + t_s * dx, oy + t_s * dy, oz + t_s * dz
    safe_r = W(torch.abs(radius) > 1e-12, radius, 1.0)
    snx, sny, snz = (spx - cx) / safe_r, (spy - cy) / safe_r, (spz - cz) / safe_r
    theta = torch.arccos(torch.clamp(-sny, -1.0 + 1e-7, 1.0 - 1e-7))
    phi_s = torch.atan2(-snz, snx) + math.pi
    u_s = phi_s / (2.0 * math.pi)
    v_s = theta / math.pi

    denom = sn0 * dx + sn1 * dy + sn2 * dz
    parallel = torch.abs(denom) < 1e-8
    t_q = (pd - (sn0 * ox + sn1 * oy + sn2 * oz)) / W(parallel, 1.0, denom)
    qpx, qpy, qpz = ox + t_q * dx, oy + t_q * dy, oz + t_q * dz
    plx, ply, plz = qpx - a0, qpy - a1, qpz - a2
    cvx = ply * c2 - plz * c1
    cvy = plz * c0 - plx * c2
    cvz = plx * c1 - ply * c0
    alpha = w0 * cvx + w1 * cvy + w2 * cvz
    cux = b1 * plz - b2 * ply
    cuy = b2 * plx - b0 * plz
    cuz = b0 * ply - b1 * plx
    beta = w0 * cux + w1 * cuy + w2 * cuz

    pvx = dy * c2 - dz * c1
    pvy = dz * c0 - dx * c2
    pvz = dx * c1 - dy * c0
    det = b0 * pvx + b1 * pvy + b2 * pvz
    inv_det = 1.0 / W(torch.abs(det) < 1e-9, 1.0, det)
    tvx, tvy, tvz = ox - a0, oy - a1, oz - a2
    u_t = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * b2 - tvz * b1
    qvy = tvz * b0 - tvx * b2
    qvz = tvx * b1 - tvy * b0
    v_t = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t_t = (c0 * qvx + c1 * qvy + c2 * qvz) * inv_det

    is_s, is_q = ptype == 0, ptype == 1
    sel = lambda a, b, c: W(is_s, a, W(is_q, b, c))  # noqa: E731
    p = (sel(spx, qpx, ox + t_t * dx), sel(spy, qpy, oy + t_t * dy),
         sel(spz, qpz, oz + t_t * dz))
    no = (sel(snx, sn0, sn0), sel(sny, sn1, sn1), sel(snz, sn2, sn2))
    front = dx * no[0] + dy * no[1] + dz * no[2] < 0.0
    flip = W(front, 1.0, -1.0).to(dx.dtype)
    return dict(t=sel(t_s, t_q, t_t), p=p, n=tuple(flip * x for x in no),
                front=front, u=sel(u_s, alpha, u_t), v=sel(v_s, beta, v_t),
                mat=row[0].to(torch.int32),
                medium=W(ptype >= 0, row[1].to(torch.int32), -1))


def medium_of(sc, ptype, pidx):
    row = _prim_rows(sc, ptype, pidx)
    return W(ptype >= 0, row[1].to(torch.int32), -1)


def _unit_vector(u0, u1):
    z = 1.0 - 2.0 * u0
    r = sqrt_r(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u1
    return r * torch.cos(phi), r * torch.sin(phi), z


def _normalize(x, y, z):
    inv = rsqrt_r(torch.clamp(x * x + y * y + z * z, min=1e-16))
    return x * inv, y * inv, z * inv


def _onb(wx, wy, wz):
    wx, wy, wz = _normalize(wx, wy, wz)
    use_y = (torch.abs(wx) > 0.9).to(wx.dtype)
    ax, ay = 1.0 - use_y, use_y
    vx = wy * 0.0 - wz * ay
    vy = wz * ax - wx * 0.0
    vz = wx * ay - wy * ax
    vx, vy, vz = _normalize(vx, vy, vz)
    return ((wy * vz - wz * vy, wz * vx - wx * vz, wx * vy - wy * vx),
            (vx, vy, vz), (wx, wy, wz))


def _cosine_direction(u0, u1, nx, ny, nz):
    r = sqrt_r(u0)
    phi = TWO_PI * u1
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = sqrt_r(torch.clamp(1.0 - u0, min=0.0))
    (ux, uy, uz), (vx, vy, vz), (wx, wy, wz) = _onb(nx, ny, nz)
    return (x * ux + y * vx + z * wx, x * uy + y * vy + z * wy,
            x * uz + y * vz + z * wz)


def _near_zero(x, y, z):
    return (torch.abs(x) < 1e-8) & (torch.abs(y) < 1e-8) & (torch.abs(z) < 1e-8)


def _sample_hg(u, g):
    small = torch.abs(g) < 1e-3
    safe_g = W(small, 1e-3, g)
    sq = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u)
    cos_hg = (1.0 + safe_g * safe_g - sq * sq) / (2.0 * safe_g)
    return torch.clamp(W(small, 1.0 - 2.0 * u, cos_hg), -1.0, 1.0)


def _direction_from_cos(u_phi, cos_theta, ax, ay, az):
    sin_theta = sqrt_r(torch.clamp(1.0 - cos_theta * cos_theta, 1e-12, 1.0))
    phi = TWO_PI * u_phi
    (ux, uy, uz), (vx, vy, vz), (wx, wy, wz) = _onb(ax, ay, az)
    sc, ss = sin_theta * torch.cos(phi), sin_theta * torch.sin(phi)
    return (sc * ux + ss * vx + cos_theta * wx, sc * uy + ss * vy + cos_theta * wy,
            sc * uz + ss * vz + cos_theta * wz)


def sss_walk(keys, steps, h, n, ui, alb, sigma_t, sigma_a, g, dtype):
    """The volumetric subsurface random walk (Henyey-Greenstein phase);
    trip ``i`` reads uniforms ``[i, 0..5]`` of ``uniform(key, (steps, 6))``.
    Returns (throughput, status 1 exit / 2 absorbed, exit point, exit
    direction)."""
    us = rng.uniform(keys, (steps, 6)).to(dtype)
    hx, hy, hz = h
    nx, ny, nz = n
    pos = [hx - nx * 1e-3, hy - ny * 1e-3, hz - nz * 1e-3]
    wd = list(ui)
    th = [torch.ones_like(hx) for _ in range(3)]
    status = torch.zeros(hx.shape, dtype=torch.int32, device=hx.device)
    op, od = list(h), list(n)
    for i in range(steps):
        walking = status == 0
        if not bool(walking.any()):
            break
        uu = us[:, i].unbind(-1)
        t = -torch.log(torch.clamp(uu[0], min=1e-10)) / sigma_t
        p2 = [pos[k] + wd[k] * t for k in range(3)]
        ex, ey, ez = p2[0] - hx, p2[1] - hy, p2[2] - hz
        dist = sqrt_r(ex * ex + ey * ey + ez * ez)
        do_exit = walking & (uu[1] < 1.0 - torch.exp(-dist * 0.5))
        evx, evy, evz = _unit_vector(uu[2], uu[3])
        ed = [nx + evx, ny + evy, nz + evz]
        edeg = _near_zero(*ed)
        ed = [W(edeg, n[k], ed[k]) for k in range(3)]
        do_absorb = walking & ~do_exit & (uu[4] < sigma_a / sigma_t)
        nd = _direction_from_cos(uu[2], _sample_hg(uu[5], g), *wd)
        status = W(do_exit, 1, W(do_absorb, 2, status)).to(torch.int32)
        keep = walking & ~do_exit & ~do_absorb
        for k in range(3):
            op[k] = W(do_exit, p2[k], op[k])
            od[k] = W(do_exit, ed[k], od[k])
            wd[k] = W(keep, nd[k], wd[k])
            pos[k] = W(keep, p2[k], pos[k])
            th[k] = W(keep, th[k] * alb[k], th[k])
    return th, status, op, od


def _turb(sc, px, py, pz, depth=7):
    """|sum_i 0.5^i noise(2^i p)| over Perlin gradient noise."""
    ranvec, pl = sc.perlin_vec, sc.perlin_perm
    acc, weight = None, 1.0
    for _ in range(depth):
        fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
        u, v, w = px - fx, py - fy, pz - fz
        ix = fx.to(torch.int64) & 255
        iy = fy.to(torch.int64) & 255
        iz = fz.to(torch.int64) & 255
        hx = (pl[0][ix], pl[0][(ix + 1) & 255])
        hy = (pl[1][iy], pl[1][(iy + 1) & 255])
        hz = (pl[2][iz], pl[2][(iz + 1) & 255])
        su = u * u * (3.0 - 2.0 * u)
        sv = v * v * (3.0 - 2.0 * v)
        sw = w * w * (3.0 - 2.0 * w)
        nacc = None
        for di in (0, 1):
            wu = su if di else (1.0 - su)
            for dj in (0, 1):
                wv = sv if dj else (1.0 - sv)
                for dk in (0, 1):
                    ww = sw if dk else (1.0 - sw)
                    gr = ranvec[hx[di] ^ hy[dj] ^ hz[dk]]
                    dot = (gr[..., 0] * (u - di) + gr[..., 1] * (v - dj)
                           + gr[..., 2] * (w - dk))
                    term = wu * wv * ww * dot
                    nacc = term if nacc is None else nacc + term
        acc = nacc * weight if acc is None else acc + weight * nacc
        weight = weight * 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(acc)


def texture(sc, tex_idx, u, v, px, py, pz, allow_noise=True, allow_image=True):
    """Solid colour, image (nearest texel, clamped (u, v), v flipped) or
    Perlin marble ``0.5 (1 + sin(scale z + 10 turb(p)))``."""
    ti = torch.clamp(tex_idx, 0, sc.tex_type.shape[0] - 1).long()
    ttype = sc.tex_type[ti]
    out = [sc.tex_c1[ti, k] for k in range(3)]
    if sc.has_image and allow_image:
        ii = torch.clamp(sc.tex_img[ti], 0, sc.img_data.shape[0] - 1).long()
        hw = sc.img_hw.index_select(0, ii)
        h, w = hw[:, 0], hw[:, 1]
        x = torch.minimum(torch.clamp(
            (torch.clamp(u, 0.0, 1.0) * w).to(torch.int32), min=0), w - 1)
        y = torch.minimum(torch.clamp(
            ((1.0 - torch.clamp(v, 0.0, 1.0)) * h).to(torch.int32), min=0), h - 1)
        H, Wd = sc.img_data.shape[1], sc.img_data.shape[2]
        texel = sc.img_data.reshape(-1, 3).index_select(0, ((ii * H + y) * Wd + x).long())
        out = [W(ttype == 2, texel[:, k], out[k]) for k in range(3)]
    if sc.has_noise and allow_noise:
        scale = sc.tex_scale[ti]
        marble = 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * _turb(sc, px, py, pz)))
        out = [W(ttype == 3, marble, out[k]) for k in range(3)]
    return out


_BOUNCE_KEY = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2)
_BOUNCE_CTR = (0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 0)


def bounce_draws(key_it, dtype):
    """The bounce's uniforms from ``key_it = fold_in(key_p, trip)``: with
    ``ks, km, kr = fold_in(key_it, 0 / 1 / 2)``, ``u8 = uniform(ks, (8,))``,
    ``umed = uniform(km)``, ``uiso = uniform(fold_in(km, 1), (2,))``,
    ``urr = uniform(kr)`` and the walk key ``fold_in(ks, 1)``."""
    dev = key_it.device
    y0, y1 = rng.threefry2x32(key_it[..., :1], key_it[..., 1:], 0,
                              torch.arange(3, device=dev))
    col = torch.tensor(_BOUNCE_KEY, device=dev)
    z0, z1 = rng.threefry2x32(y0.index_select(-1, col), y1.index_select(-1, col),
                              0, torch.tensor(_BOUNCE_CTR, device=dev))
    u = rng.bits_to_unit_float(z0 ^ z1).to(dtype)
    kiso = torch.stack([z0[..., 9], z1[..., 9]], -1)
    return dict(u8=u[..., :8], umed=u[..., 8], urr=u[..., 10],
                uiso=rng.uniform(kiso, (2,)).to(dtype),
                sss_key=torch.stack([z0[..., 1], z1[..., 1]], -1))


def bounce(sc, cam, cfg: Integrator, st, found, ptype, pidx, exit_found,
           t_exit, exit_is_medium, draws):
    """One trip: emission or background, medium free flight, the seven
    material families' scatter, Russian roulette → the next state."""
    dt = st["o"][0].dtype
    ox, oy, oz = st["o"]
    dx, dy, dz = st["d"]
    col, thr = list(st["col"]), list(st["thr"])
    u8 = draws["u8"].unbind(-1)
    bg = background(cam, dx, dy, dz)
    miss = [col[k] + thr[k] * bg[k] for k in range(3)]
    rec = refine_hit(sc, ptype, pidx, ox, oy, oz, dx, dy, dz, st["time"],
                     cfg.t_min)
    t_hit = rec["t"]
    zeros = torch.zeros_like(ox)

    if sc.has_medium:
        in_medium = found & (rec["medium"] >= 0)
        entering = in_medium & rec["front"]
        exiting = in_medium & ~rec["front"]
        t1 = W(entering, t_hit, 0.0)
        t2 = W(entering, t_exit, t_hit)
        region_ok = W(entering, exit_found, exiting)
        mrow = _rows(sc.med, torch.clamp(rec["medium"], 0, sc.med.shape[0] - 1))
        t1c = torch.clamp(torch.clamp(t1, min=cfg.t_min), min=0.0)
        t2c = torch.clamp(t2, max=cfg.t_max)
        ray_len = sqrt_r(dx * dx + dy * dy + dz * dz)
        inside = (t2c - t1c) * ray_len
        hit_dist = -torch.log(torch.clamp(draws["umed"], min=1e-10)) / mrow[0]
        med_scatter = in_medium & region_ok & (t1c < t2c) & (hit_dist < inside)
        t_scatter = t1c + hit_dist / ray_len
        med_albedo = texture(sc, mrow[1].to(torch.int32), zeros, zeros,
                             ox + t_scatter * dx, oy + t_scatter * dy,
                             oz + t_scatter * dz, sc.noise_in_medium,
                             sc.image_in_medium)
        stop_short = entering & exit_found & ~exit_is_medium
        hop_t = W(exiting, t_hit, t_exit)
        cont_t = torch.clamp(W(stop_short, t2 - 2.0 * cfg.t_min, hop_t + 1e-3),
                             min=cfg.t_min)
        escape = entering & ~exit_found
        passthrough = in_medium & ~med_scatter & ~escape
        found = found & ~escape
    else:
        med_scatter = passthrough = torch.zeros_like(found)
        t_scatter = cont_t = zeros
        med_albedo = (zeros, zeros, zeros)
    surface = found & ~med_scatter & ~passthrough

    mi = torch.clamp(rec["mat"], 0, sc.mat.shape[0] - 1)
    mrow = _rows(sc.mat, mi)
    mtype = mrow[0].to(torch.int32)
    albedo = texture(sc, mrow[1].to(torch.int32), rec["u"], rec["v"], *rec["p"])
    nx, ny, nz = rec["n"]
    hpx, hpy, hpz = rec["p"]
    uix, uiy, uiz = _normalize(dx, dy, dz)
    lx, ly, lz = _cosine_direction(u8[0], u8[1], nx, ny, nz)
    deg = _near_zero(lx, ly, lz)
    lx, ly, lz = W(deg, nx, lx), W(deg, ny, ly), W(deg, nz, lz)
    fuzz = mrow[2]
    vdn = uix * nx + uiy * ny + uiz * nz
    rx, ry, rz = uix - 2.0 * vdn * nx, uiy - 2.0 * vdn * ny, uiz - 2.0 * vdn * nz
    fx, fy, fz = _unit_vector(u8[2], u8[3])
    mx, my, mz = rx + fuzz * fx, ry + fuzz * fy, rz + fuzz * fz
    ir = mrow[3]
    ratio = W(rec["front"], 1.0 / ir, ir)
    cos_t = torch.clamp(-uix * nx + -uiy * ny + -uiz * nz, max=1.0)
    sin_t = sqrt_r(torch.clamp(1.0 - cos_t * cos_t, 1e-12, 1.0))
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    reflect = (ratio * sin_t > 1.0) | (reflectance > u8[4])
    ppx, ppy, ppz = (ratio * (uix + cos_t * nx), ratio * (uiy + cos_t * ny),
                     ratio * (uiz + cos_t * nz))
    par = -sqrt_r(torch.clamp(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz), min=1e-12))
    gx, gy, gz = (W(reflect, rx, ppx + par * nx), W(reflect, ry, ppy + par * ny),
                  W(reflect, rz, ppz + par * nz))
    ix, iy, iz = _unit_vector(u8[5], u8[6])
    is_lam, is_met, is_die = mtype == 0, mtype == 1, mtype == 2
    sel = lambda a, b, c, d: W(is_lam, a, W(is_met, b, W(is_die, c, d)))  # noqa: E731
    dirs = [sel(lx, mx, gx, ix), sel(ly, my, gy, iy), sel(lz, mz, gz, iz)]
    att = [W(is_die, 1.0, albedo[k]) for k in range(3)]
    orig = [hpx, hpy, hpz]
    scat_ok = mtype != 3
    if sc.has_sss:
        n = (nx, ny, nz)
        is_ss, is_sv = mtype == 5, mtype == 6
        displace = u8[7] >= 0.5
        amp = mrow[7] * u8[4]
        sdir = [n[k] + f for k, f in enumerate((fx, fy, fz))]
        sdeg = _near_zero(*sdir)
        for k, ik in enumerate((ix, iy, iz)):
            orig[k] = W(is_ss, W(displace, orig[k] + ik * amp, orig[k]), orig[k])
            dirs[k] = W(is_ss, W(sdeg, n[k], sdir[k]), dirs[k])
        sigma_t = torch.clamp(mrow[5] + mrow[6], min=1e-6)
        th = [torch.ones_like(hpx) for _ in range(3)]
        status = torch.zeros_like(mtype)
        op, od = [hpx, hpy, hpz], list(n)
        idx = (is_sv & surface).nonzero()[:, 0]
        if idx.numel():
            sub = lambda xs: [x[idx] for x in xs]  # noqa: E731
            w_th, w_st, w_op, w_od = sss_walk(
                draws["sss_key"][idx], cfg.sss_max_steps, sub(rec["p"]), sub(n),
                sub((uix, uiy, uiz)), sub(albedo), sigma_t[idx], mrow[6][idx],
                mrow[4][idx], dt)
            status = status.index_put((idx,), w_st)
            for k in range(3):
                th[k] = th[k].index_put((idx,), w_th[k])
                op[k] = op[k].index_put((idx,), w_op[k])
                od[k] = od[k].index_put((idx,), w_od[k])
        for k in range(3):
            orig[k] = W(is_sv, op[k], orig[k])
            dirs[k] = W(is_sv, od[k], dirs[k])
            att[k] = W(is_sv, th[k] * albedo[k], att[k])
        scat_ok = W(is_sv, status == 1, scat_ok)
    is_em = mtype == 3
    emit = texture(sc, mrow[1].to(torch.int32), rec["u"], rec["v"], *rec["p"],
                   sc.noise_in_light, sc.image_in_light)
    emit = [W(is_em, e, 0.0) for e in emit]

    surf_f = W(surface, 1.0, 0.0).to(dt)
    color = [W(found, col[k] + surf_f * thr[k] * emit[k], miss[k]) for k in range(3)]
    iso = _unit_vector(*draws["uiso"].unbind(-1))
    medp = (ox + t_scatter * dx, oy + t_scatter * dy, oz + t_scatter * dz)
    scattered = W(med_scatter, True, W(surface, scat_ok, False))
    n_o = [W(med_scatter, medp[k], orig[k]) for k in range(3)]
    n_d = [W(med_scatter, iso[k], dirs[k]) for k in range(3)]
    at = [W(med_scatter, med_albedo[k], att[k]) for k in range(3)]
    o0, d0 = (ox, oy, oz), (dx, dy, dz)
    next_o = [W(passthrough, o0[k] + d0[k] * cont_t, W(scattered, n_o[k], o0[k]))
              for k in range(3)]
    keep_dir = passthrough | ~scattered
    next_d = [W(keep_dir, d0[k], n_d[k]) for k in range(3)]
    thr = [W(scattered, thr[k] * at[k], thr[k]) for k in range(3)]
    depth = (st["depth"] + W(scattered, 1, 0)).to(torch.int32)
    alive = st["alive"] & (passthrough | scattered) & (depth < cfg.max_depth)
    rr_on = scattered & (depth >= cfg.rr_min_depth)
    survival = torch.clamp(torch.maximum(torch.maximum(thr[0], thr[1]), thr[2]),
                           max=cfg.rr_max_prob)
    killed = rr_on & (draws["urr"] > survival)
    boost = W(rr_on & ~killed, 1.0 / torch.clamp(survival, min=1e-6), 1.0)
    return dict(o=tuple(next_o), d=tuple(next_d), time=st["time"],
                col=tuple(color), thr=tuple(t * boost for t in thr),
                depth=depth, iters=st["iters"] + 1, alive=alive & ~killed)


def _trace(sc, cam, cfg, key_p, px, py, dtype):
    """Radiance (3 tensors) of the paths with keys ``key_p`` from pixels
    (px, py)."""
    u5 = rng.uniform(rng.fold_in(key_p, 7), (5,)).to(dtype).unbind(-1)
    o, d, time = primary_rays(cam, px, py, u5)
    ninv = rsqrt_r(torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=1e-16))
    n = px.shape[0]
    dev = px.device
    st = dict(o=tuple(o), d=tuple(c * ninv for c in d), time=time,
              col=tuple(torch.zeros(n, dtype=dtype, device=dev) for _ in range(3)),
              thr=tuple(torch.ones(n, dtype=dtype, device=dev) for _ in range(3)),
              depth=torch.zeros(n, dtype=torch.int32, device=dev),
              iters=torch.zeros(n, dtype=torch.int32, device=dev),
              alive=torch.ones(n, dtype=torch.bool, device=dev))
    for _ in range(cfg.iters):
        idx = st["alive"].nonzero()[:, 0]
        if idx.numel() == 0:
            break
        sub = {k: (tuple(c[idx] for c in v) if isinstance(v, tuple) else v[idx])
               for k, v in st.items()}
        o3 = torch.stack(sub["o"], -1)
        d3 = torch.stack(sub["d"], -1)
        found, pt, pi, t_hit = closest_hit(sc, o3, d3, sub["time"], cfg.t_min,
                                           cfg.t_max)
        if sc.has_medium:
            need = (found & (medium_of(sc, pt, pi) >= 0)).nonzero()[:, 0]
            e_found = torch.zeros_like(found)
            e_t = torch.zeros_like(t_hit)
            e_med = torch.zeros_like(found)
            if need.numel():
                f2, pt2, pi2, t2 = closest_hit(sc, o3[need], d3[need],
                                               sub["time"][need],
                                               t_hit[need] + 1e-4, cfg.t_max)
                e_found[need], e_t[need] = f2, t2
                e_med[need] = medium_of(sc, pt2, pi2) >= 0
        else:
            e_found = e_med = torch.zeros_like(found)
            e_t = torch.zeros_like(t_hit)
        draws = bounce_draws(rng.fold_in(key_p[idx], sub["iters"]), dtype)
        nxt = bounce(sc, cam, cfg, sub, found, pt, pi, e_found, e_t, e_med, draws)
        for k, v in nxt.items():
            if isinstance(v, tuple):
                st[k] = tuple(a.index_put((idx,), b) for a, b in zip(st[k], v))
            else:
                st[k] = st[k].index_put((idx,), v)
        st["alive"] = st["alive"] & (st["iters"] < cfg.iters)
    return st["col"]


def render_pixels(sc: RefScene, cam_desc, cfg: Integrator, seed: int, pixels,
                  samples, dtype=torch.float32):
    """Sum over ``samples`` (an iterable of sample indices) of the radiance
    of each frame pixel in ``pixels`` (1-D int tensor) → (P, 3) float64."""
    dev = sc.shade.device
    cam = camera_arrays(cam_desc, dev, dtype)
    base = rng.key(seed, dev)
    pixels = pixels.to(dev, torch.int64)
    samples = torch.as_tensor(list(samples), dtype=torch.int64, device=dev)
    P = pixels.shape[0]
    out = torch.zeros((P, 3), dtype=torch.float64, device=dev)
    per = max(1, LANES // max(P, 1))
    for s0 in range(0, samples.shape[0], per):
        smp = samples[s0:s0 + per]
        pix = pixels.repeat(smp.shape[0])
        slot = torch.arange(P, device=dev).repeat(smp.shape[0])
        key_p = rng.fold_in(rng.fold_in(base, smp.repeat_interleave(P)), pix)
        col = _trace(sc, cam, cfg, key_p, (pix % cfg.width).to(dtype),
                     (pix // cfg.width).to(dtype), dtype)
        out.index_add_(0, slot, torch.stack(col, -1).double())
    return out
