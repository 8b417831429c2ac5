"""Batched wavefront shading: RNG draws, primary rays, one bounce, K3.

Port of ``path_tracer_tpu/ops/shade_tiled.py`` without its TPU layout
(the ``(R/128, 128)`` lane grid and component-major transposes): every
function works on flat ``(R,)`` tensors, with 3-vectors as component
triples, and follows the JAX function's operation order so the two packages
integrate the same sample set.  The SSS-volumetric random walk (B6) runs on
the SSS lanes only; the JAX rung ladder and compaction around it are TPU
cost workarounds and are not ported.  Every walking lane draws its own
``uniform(fold_in(k_scatter, 1), (steps, 6))`` stream, as both JAX walks do.

:func:`shade` is kernel K3 (``csrc/shade.cu``): the control step's volume
phase transition (B9), the bounce (B2 ``wave_rng``, B4, B5, B6) and the
restart of continuing paths, on every slot whose query finished.
:func:`shade_plain` is its plain-torch twin.  The megakernel's bounce
(``integrator.bounce_shade``) is :func:`bounce_shade_t` with the same draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import rng
from ..utils.rng import TWO_PI
from ..utils.vec import rsqrt32, sqrt32
from . import kernels
from . import shade as shade_mod
from .camera import background_t, get_rays_t
from .traverse import _DONE, traversal_init_batched
from .types import (C_DO_CTRL, C_WALK_STEPS, FL_FINISHED, MAT_DIELECTRIC,
                    MAT_EMISSIVE, MAT_LAMBERTIAN, MAT_METAL, MAT_SSS_SIMPLE,
                    MAT_SSS_VOLUMETRIC, PH_EXIT, PH_MAIN, PathState,
                    SceneArrays)

F32 = torch.float32


class ShadeTables(NamedTuple):
    prim: torch.Tensor  # (Ns+Nq+Nt, 18): [mat, medium, a(3), b(3), c(3), n(3), w(3), d]
    mat: torch.Tensor   # (M, 8): [type, tex, fuzz, ir, g, sigma_s, sigma_a, scatter_dist]
    med: torch.Tensor   # (Mv, 2): [density, tex]
    tex: torch.Tensor   # (T, 9): [type, c1(3), c2(3), scale, img]
    n_sph: int
    n_qd: int


def make_tables(scene: SceneArrays) -> ShadeTables:
    ns = scene.sph_rad.shape[0]
    nq = scene.qd_d.shape[0]
    nt = scene.tr_mat.shape[0]
    dev = scene.sph_rad.device
    z = lambda n, k: torch.zeros((n, k), dtype=F32, device=dev)  # noqa: E731
    col = lambda x: x.to(F32)[:, None]  # noqa: E731
    sph = torch.cat([col(scene.sph_mat), col(scene.sph_medium), scene.sph_c0,
                     scene.sph_c1, col(scene.sph_rad), z(ns, 2), z(ns, 7)], 1)
    qd = torch.cat([col(scene.qd_mat), col(scene.qd_medium), scene.qd_q,
                    scene.qd_u, scene.qd_v, scene.qd_n, scene.qd_w,
                    col(scene.qd_d)], 1)
    tr = torch.cat([col(scene.tr_mat), col(scene.tr_medium), scene.tr_v0,
                    scene.tr_e1, scene.tr_e2, scene.tr_n, z(nt, 4)], 1)
    tex = torch.cat([col(scene.tex_type), scene.tex_c1, scene.tex_c2,
                     col(scene.tex_scale), col(scene.tex_img)], 1)
    return ShadeTables(prim=torch.cat([sph, qd, tr], 0).contiguous(),
                       mat=mat_table(scene), med=med_table(scene),
                       tex=tex.contiguous(), n_sph=ns, n_qd=nq)


def mat_table(scene: SceneArrays) -> torch.Tensor:
    return torch.stack([scene.mat_type.to(F32), scene.mat_tex.to(F32),
                        scene.mat_fuzz, scene.mat_ir, scene.mat_g,
                        scene.mat_sigma_s, scene.mat_sigma_a,
                        scene.mat_scatter_dist], 1).contiguous()


def med_table(scene: SceneArrays) -> torch.Tensor:
    return torch.stack([scene.med_density, scene.med_tex.to(F32)],
                       1).contiguous()


def _prim_rows(tabs: ShadeTables, ptype, pidx):
    """The 18 shade-row components for (ptype, pidx) lanes."""
    off = torch.where(ptype == 0, 0,
                      torch.where(ptype == 1, tabs.n_sph, tabs.n_sph + tabs.n_qd))
    uid = torch.clamp(pidx + off, 0, tabs.prim.shape[0] - 1)
    uid = torch.where(ptype >= 0, uid, 0)
    return tabs.prim.index_select(0, uid).unbind(-1)


def _rows(table, idx):
    return table.index_select(0, idx).unbind(-1)


class HitT(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    p: tuple
    n: tuple
    front: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    mat: torch.Tensor
    medium: torch.Tensor


def _front_from_row(row, ptype, ox, oy, oz, dx, dy, dz, time, t):
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    cx = row[2] + (row[5] - row[2]) * time
    cy = row[3] + (row[6] - row[3]) * time
    cz = row[4] + (row[7] - row[4]) * time
    is_s = ptype == 0
    nx = torch.where(is_s, px - cx, row[11])
    ny = torch.where(is_s, py - cy, row[12])
    nz = torch.where(is_s, pz - cz, row[13])
    return dx * nx + dy * ny + dz * nz < 0.0


def prim_medium_t(tabs: ShadeTables, ptype, pidx):
    """Medium index of the (ptype, pidx) primitives, or -1 (B9)."""
    row = _prim_rows(tabs, ptype, pidx)
    return torch.where(ptype >= 0, row[1].to(torch.int32), -1)


def prim_medium_front_t(tabs: ShadeTables, ptype, pidx, ox, oy, oz,
                        dx, dy, dz, time, t):
    """(medium id or -1, front-face test) from one prim-row gather (B9)."""
    row = _prim_rows(tabs, ptype, pidx)
    med = torch.where(ptype >= 0, row[1].to(torch.int32), -1)
    return med, _front_from_row(row, ptype, ox, oy, oz, dx, dy, dz, time, t)


def refine_hit_t(tabs: ShadeTables, ptype, pidx, ox, oy, oz, dx, dy, dz,
                 time, t_min) -> HitT:
    """Full hit record from one row gather; all families, selected by type."""
    row = _prim_rows(tabs, ptype, pidx)
    a0, a1, a2 = row[2], row[3], row[4]
    b0, b1, b2 = row[5], row[6], row[7]
    c0, c1, c2 = row[8], row[9], row[10]
    sn0, sn1, sn2 = row[11], row[12], row[13]
    w0, w1, w2 = row[14], row[15], row[16]
    pd = row[17]
    INF = 1e30
    W = torch.where

    cx = a0 + (b0 - a0) * time
    cy = a1 + (b1 - a1) * time
    cz = a2 + (b2 - a2) * time
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    ra = dx * dx + dy * dy + dz * dz
    h = dx * ocx + dy * ocy + dz * ocz
    radius = c0
    cc = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius
    disc = h * h - ra * cc
    sq = sqrt32(torch.clamp(disc, min=1e-12))
    r0_ = (h - sq) / ra
    r1_ = (h + sq) / ra
    in0 = (r0_ > t_min) & (r0_ < INF)
    in1 = (r1_ > t_min) & (r1_ < INF)
    t_s = W(in0, r0_, r1_)
    hit_s = (disc > 0.0) & (in0 | in1)
    spx = ox + t_s * dx
    spy = oy + t_s * dy
    spz = oz + t_s * dz
    safe_r = W(torch.abs(radius) > 1e-12, radius, 1.0)
    snx = (spx - cx) / safe_r
    sny = (spy - cy) / safe_r
    snz = (spz - cz) / safe_r
    theta = torch.arccos(torch.clamp(-sny, -1.0 + 1e-7, 1.0 - 1e-7))
    phi_s = torch.atan2(-snz, snx) + math.pi
    u_s = phi_s / (2.0 * math.pi)
    v_s = theta / math.pi

    denom = sn0 * dx + sn1 * dy + sn2 * dz
    parallel = torch.abs(denom) < 1e-8
    t_q = (pd - (sn0 * ox + sn1 * oy + sn2 * oz)) / W(parallel, 1.0, denom)
    qpx = ox + t_q * dx
    qpy = oy + t_q * dy
    qpz = oz + t_q * dz
    plx, ply, plz = qpx - a0, qpy - a1, qpz - a2
    cvx = ply * c2 - plz * c1
    cvy = plz * c0 - plx * c2
    cvz = plx * c1 - ply * c0
    alpha = w0 * cvx + w1 * cvy + w2 * cvz
    cux = b1 * plz - b2 * ply
    cuy = b2 * plx - b0 * plz
    cuz = b0 * ply - b1 * plx
    beta = w0 * cux + w1 * cuy + w2 * cuz
    interior = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    hit_q = (~parallel) & (t_q > t_min) & (t_q < INF) & interior

    pvx = dy * c2 - dz * c1
    pvy = dz * c0 - dx * c2
    pvz = dx * c1 - dy * c0
    det = b0 * pvx + b1 * pvy + b2 * pvz
    par_t = torch.abs(det) < 1e-9
    inv_det = 1.0 / W(par_t, 1.0, det)
    tvx, tvy, tvz = ox - a0, oy - a1, oz - a2
    u_t = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * b2 - tvz * b1
    qvy = tvz * b0 - tvx * b2
    qvz = tvx * b1 - tvy * b0
    v_t = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t_t = (c0 * qvx + c1 * qvy + c2 * qvz) * inv_det
    inside = (u_t >= 0.0) & (v_t >= 0.0) & (u_t + v_t <= 1.0)
    hit_t = (~par_t) & inside & (t_t > t_min) & (t_t < INF)

    is_s = ptype == 0
    is_q = ptype == 1

    def sel(a, b, c):
        return W(is_s, a, W(is_q, b, c))

    hit = sel(hit_s, hit_q, hit_t) & (ptype >= 0)
    t = sel(t_s, t_q, t_t)
    px = sel(spx, qpx, ox + t_t * dx)
    py = sel(spy, qpy, oy + t_t * dy)
    pz = sel(spz, qpz, oz + t_t * dz)
    nox = sel(snx, sn0, sn0)
    noy = sel(sny, sn1, sn1)
    noz = sel(snz, sn2, sn2)
    uu = sel(u_s, alpha, u_t)
    vv = sel(v_s, beta, v_t)
    front = dx * nox + dy * noy + dz * noz < 0.0
    flip = W(front, 1.0, -1.0)
    return HitT(hit=hit, t=t, p=(px, py, pz),
                n=(flip * nox, flip * noy, flip * noz), front=front,
                u=uu, v=vv, mat=row[0].to(torch.int32),
                medium=W(ptype >= 0, row[1].to(torch.int32), -1))


# --- component sampling helpers (mirror utils/rng.py op for op) ---

def _unit_vector_t(u0, u1):
    z = 1.0 - 2.0 * u0
    r = sqrt32(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u1
    return r * torch.cos(phi), r * torch.sin(phi), z


def _normalize_t(x, y, z):
    inv = rsqrt32(torch.clamp(x * x + y * y + z * z, min=1e-16))
    return x * inv, y * inv, z * inv


def _onb_t(wx, wy, wz):
    wx, wy, wz = _normalize_t(wx, wy, wz)
    use_y = (torch.abs(wx) > 0.9).to(wx.dtype)
    ax = 1.0 - use_y
    ay = use_y
    vx = wy * 0.0 - wz * ay
    vy = wz * ax - wx * 0.0
    vz = wx * ay - wy * ax
    vx, vy, vz = _normalize_t(vx, vy, vz)
    ux = wy * vz - wz * vy
    uy = wz * vx - wx * vz
    uz = wx * vy - wy * vx
    return (ux, uy, uz), (vx, vy, vz), (wx, wy, wz)


def _cosine_direction_t(u0, u1, nx, ny, nz):
    r = sqrt32(u0)
    phi = TWO_PI * u1
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = sqrt32(torch.clamp(1.0 - u0, min=0.0))
    (ux, uy, uz), (vx, vy, vz), (wx, wy, wz) = _onb_t(nx, ny, nz)
    return (x * ux + y * vx + z * wx,
            x * uy + y * vy + z * wy,
            x * uz + y * vz + z * wz)


def _near_zero_t(x, y, z):
    return (torch.abs(x) < 1e-8) & (torch.abs(y) < 1e-8) & (torch.abs(z) < 1e-8)


def _sample_hg_t(u, g):
    small = torch.abs(g) < 1e-3
    safe_g = torch.where(small, 1e-3, g)
    sq = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u)
    cos_hg = (1.0 + safe_g * safe_g - sq * sq) / (2.0 * safe_g)
    cos_iso = 1.0 - 2.0 * u
    return torch.clamp(torch.where(small, cos_iso, cos_hg), -1.0, 1.0)


def _direction_from_cos_t(u_phi, cos_theta, ax, ay, az):
    sin_theta = sqrt32(torch.clamp(1.0 - cos_theta * cos_theta, 1e-12, 1.0))
    phi = TWO_PI * u_phi
    (ux, uy, uz), (vx, vy, vz), (wx, wy, wz) = _onb_t(ax, ay, az)
    sc = sin_theta * torch.cos(phi)
    ss = sin_theta * torch.sin(phi)
    return (sc * ux + ss * vx + cos_theta * wx,
            sc * uy + ss * vy + cos_theta * wy,
            sc * uz + ss * vz + cos_theta * wz)


def sss_walk(keys, steps: int, h, n, ui, alb, sigma_t, sigma_a, g):
    """The SSS-volumetric Henyey–Greenstein walk (B6) for N lanes.

    ``keys`` (N, 2) are the walk keys; ``h`` (hit point), ``n`` (shading
    normal), ``ui`` (unit incoming direction) and ``alb`` are component
    triples.  Trip ``i`` reads uniforms ``[i, 0..5]`` of
    ``uniform(key, (steps, 6))``.  A lane stops walking once it exits
    (status 1) or is absorbed (status 2); the loop ends when no lane walks,
    since the remaining trips of the JAX walk change nothing.  Returns
    ``(throughput, status, exit point, exit direction, walking trips)``.
    """
    W = torch.where
    us = rng.uniform(keys, (steps, 6))
    hx, hy, hz = h
    nx, ny, nz = n
    pos = [hx - nx * 1e-3, hy - ny * 1e-3, hz - nz * 1e-3]
    wd = list(ui)
    th = [torch.ones_like(hx) for _ in range(3)]
    status = torch.zeros(hx.shape, dtype=torch.int32, device=hx.device)
    op, od = list(h), list(n)
    nst = torch.zeros(hx.shape, dtype=torch.int32, device=hx.device)
    for i in range(steps):
        walking = status == 0
        if not bool(walking.any()):
            break
        uu = us[:, i].unbind(-1)
        t = -torch.log(torch.clamp(uu[0], min=1e-10)) / sigma_t
        p2 = [pos[k] + wd[k] * t for k in range(3)]
        ex, ey, ez = p2[0] - hx, p2[1] - hy, p2[2] - hz
        dist = sqrt32(ex * ex + ey * ey + ez * ez)
        exit_prob = 1.0 - torch.exp(-dist * 0.5)
        do_exit = walking & (uu[1] < exit_prob)
        evx, evy, evz = _unit_vector_t(uu[2], uu[3])
        ed = [nx + evx, ny + evy, nz + evz]
        edeg = _near_zero_t(*ed)
        ed = [W(edeg, n[k], ed[k]) for k in range(3)]
        do_absorb = walking & ~do_exit & (uu[4] < sigma_a / sigma_t)
        cos_hg = _sample_hg_t(uu[5], g)
        nd = _direction_from_cos_t(uu[2], cos_hg, *wd)
        status = W(do_exit, 1, W(do_absorb, 2, status)).to(torch.int32)
        keep = walking & ~do_exit & ~do_absorb
        for k in range(3):
            op[k] = W(do_exit, p2[k], op[k])
            od[k] = W(do_exit, ed[k], od[k])
            wd[k] = W(keep, nd[k], wd[k])
            pos[k] = W(keep, p2[k], pos[k])
            th[k] = W(keep, th[k] * alb[k], th[k])
        nst = nst + walking.to(torch.int32)
    return th, status, op, od, nst


def _eval_tex_t(scene, flags, tex_idx, u, v, px, py, pz, allow_noise,
                allow_image=True):
    out = shade_mod.eval_texture_batched(
        scene, flags, tex_idx, u, v, torch.stack([px, py, pz], dim=-1),
        allow_noise=allow_noise, allow_image=allow_image)
    return out[:, 0], out[:, 1], out[:, 2]


def scatter_t(scene, flags, sss_steps: int, tabs: ShadeTables, rec: HitT,
              dx, dy, dz, u8, sss_keys, albedo, live=None):
    """Scatter for every family: lambertian, metal, dielectric, isotropic,
    emissive, SSS-simple and the SSS-volumetric walk.

    ``sss_keys`` (R, 2) are the walk keys (used when ``flags.has_sss``);
    ``live`` marks the lanes the caller keeps: only they walk and count.
    Returns ``(scattered, origin, direction, attenuation, mat row,
    walk_steps)`` with vectors as component triples.
    """
    W = torch.where
    mi = torch.clamp(rec.mat, 0, tabs.mat.shape[0] - 1)
    mrow = _rows(tabs.mat, mi)
    mtype = mrow[0].to(torch.int32)
    nx, ny, nz = rec.n
    hpx, hpy, hpz = rec.p
    ax, ay, az = albedo
    uix, uiy, uiz = _normalize_t(dx, dy, dz)

    lx, ly, lz = _cosine_direction_t(u8[0], u8[1], nx, ny, nz)
    lam_deg = _near_zero_t(lx, ly, lz)
    lx, ly, lz = W(lam_deg, nx, lx), W(lam_deg, ny, ly), W(lam_deg, nz, lz)

    fuzz = mrow[2]
    vdn = uix * nx + uiy * ny + uiz * nz
    rx = uix - 2.0 * vdn * nx
    ry = uiy - 2.0 * vdn * ny
    rz = uiz - 2.0 * vdn * nz
    fx, fy, fz = _unit_vector_t(u8[2], u8[3])
    mx, my, mz = rx + fuzz * fx, ry + fuzz * fy, rz + fuzz * fz

    ir = mrow[3]
    ratio = W(rec.front, 1.0 / ir, ir)
    cos_theta = torch.clamp(-uix * nx + -uiy * ny + -uiz * nz, max=1.0)
    sin_theta = sqrt32(torch.clamp(1.0 - cos_theta * cos_theta, 1e-12, 1.0))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    choose_reflect = cannot_refract | (reflectance > u8[4])
    ppx = ratio * (uix + cos_theta * nx)
    ppy = ratio * (uiy + cos_theta * ny)
    ppz = ratio * (uiz + cos_theta * nz)
    par = -sqrt32(torch.clamp(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz),
                                  min=1e-12))
    gx = W(choose_reflect, rx, ppx + par * nx)
    gy = W(choose_reflect, ry, ppy + par * ny)
    gz = W(choose_reflect, rz, ppz + par * nz)

    ix, iy, iz = _unit_vector_t(u8[5], u8[6])

    is_lam = mtype == MAT_LAMBERTIAN
    is_met = mtype == MAT_METAL
    is_die = mtype == MAT_DIELECTRIC
    is_emit = mtype == MAT_EMISSIVE

    def sel(a, b, c, d):
        return W(is_lam, a, W(is_met, b, W(is_die, c, d)))

    dirs = [sel(lx, mx, gx, ix), sel(ly, my, gy, iy), sel(lz, mz, gz, iz)]
    att = [W(is_die, 1.0, ax), W(is_die, 1.0, ay), W(is_die, 1.0, az)]
    orig = [hpx, hpy, hpz]
    scattered = ~is_emit
    walk_steps = torch.zeros((), dtype=torch.int64, device=hpx.device)
    if flags.has_sss:
        n = (nx, ny, nz)
        is_ss = mtype == MAT_SSS_SIMPLE
        is_sv = mtype == MAT_SSS_VOLUMETRIC
        # SSS-simple: half the exits displaced by scatter_dist * u8[4].
        displace = u8[7] >= 0.5
        amp = mrow[7] * u8[4]
        sdir = [n[k] + f for k, f in enumerate((fx, fy, fz))]
        sdeg = _near_zero_t(*sdir)
        for k, ik in enumerate((ix, iy, iz)):
            orig[k] = W(is_ss, W(displace, orig[k] + ik * amp, orig[k]),
                        orig[k])
            dirs[k] = W(is_ss, W(sdeg, n[k], sdir[k]), dirs[k])
        # SSS-volumetric: the walk, on the kept volumetric lanes only.
        sigma_t = torch.clamp(mrow[5] + mrow[6], min=1e-6)
        walk = is_sv if live is None else is_sv & live
        th = [torch.ones_like(hpx) for _ in range(3)]
        status = torch.zeros_like(mtype)
        op, od = [hpx, hpy, hpz], list(n)
        idx = walk.nonzero()[:, 0]
        if idx.numel():
            sub = lambda xs: [x[idx] for x in xs]  # noqa: E731
            w_th, w_st, w_op, w_od, nst = sss_walk(
                sss_keys[idx], sss_steps, sub(rec.p), sub(n),
                sub((uix, uiy, uiz)), sub(albedo), sigma_t[idx],
                mrow[6][idx], mrow[4][idx])
            status = status.index_put((idx,), w_st)
            for k in range(3):
                th[k] = th[k].index_put((idx,), w_th[k])
                op[k] = op[k].index_put((idx,), w_op[k])
                od[k] = od[k].index_put((idx,), w_od[k])
            walk_steps = nst.sum(dtype=torch.int64)
        for k in range(3):
            orig[k] = W(is_sv, op[k], orig[k])
            dirs[k] = W(is_sv, od[k], dirs[k])
            att[k] = W(is_sv, th[k] * albedo[k], att[k])
        scattered = W(is_sv, status == 1, scattered)
    return scattered, tuple(orig), tuple(dirs), tuple(att), mrow, walk_steps


def emitted_t(scene, flags, mrow, u, v, px, py, pz):
    is_em = mrow[0].to(torch.int32) == MAT_EMISSIVE
    er, eg, eb = _eval_tex_t(scene, flags, mrow[1].to(torch.int32), u, v,
                             px, py, pz, allow_noise=flags.has_noise_emission,
                             allow_image=flags.has_image_emission)
    zero = torch.zeros_like(er)
    return (torch.where(is_em, er, zero), torch.where(is_em, eg, zero),
            torch.where(is_em, eb, zero))


# The second level of :func:`bounce_rng`: which of (ks, km, kr) each of its
# eleven blocks hashes, and the block's counter.
_BOUNCE_KEY = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2)
_BOUNCE_CTR = (0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 0)


def wave_rng(base_key, smp, pix, iters, has_sss: bool = False):
    """Per-lane bounce uniforms: fold base → sample → pixel → iters → stream."""
    key_it = rng.fold_in(rng.fold_in(rng.fold_in(base_key, smp), pix), iters)
    return bounce_rng(key_it, has_sss)


def bounce_rng(key_it, has_sss: bool = False):
    """The draws of one bounce from its key ``fold_in(key_p, iters)``:
    ``u8`` (scatter), ``umed``, ``uiso`` (medium), ``urr`` (roulette) and,
    for SSS scenes, the walk key ``fold_in(k_scatter, 1)``.

    The eleven draws of the second level run as one threefry pass: ``ks``
    on counters 0-7 (``u8``; counter 1's two words are ``fold_in(ks, 1)``),
    ``km`` on 0 (``umed``) and 1 (``fold_in(km, 1)``), ``kr`` on 0
    (``urr``).  ``uniform(k)`` and ``fold_in(k, d)`` hash the same block
    ``(0, counter)``, so the bits are those of the separate calls."""
    dev = key_it.device
    # ks, km, kr = fold_in(key_it, 0 / 1 / 2), as (…, 3) words.
    y0, y1 = rng.threefry2x32(key_it[..., :1], key_it[..., 1:], 0,
                              torch.arange(3, device=dev))
    col = torch.tensor(_BOUNCE_KEY, device=dev)
    z0, z1 = rng.threefry2x32(y0.index_select(-1, col),
                              y1.index_select(-1, col), 0,
                              torch.tensor(_BOUNCE_CTR, device=dev))
    u = rng.bits_to_unit_float(z0 ^ z1)
    kiso = torch.stack([z0[..., 9], z1[..., 9]], -1)
    out = {"u8": u[..., :8], "umed": u[..., 8],
           "uiso": rng.uniform(kiso, (2,)), "urr": u[..., 10]}
    if has_sss:
        out["sss_key"] = torch.stack([z0[..., 1], z1[..., 1]], -1)
    return out


def spawn_rng(base_key, smp, pix):
    """Camera uniforms ``uniform(fold_in(key_p, 7), (5,))`` per lane."""
    key_p = rng.fold_in(rng.fold_in(base_key, smp), pix)
    return rng.uniform(rng.fold_in(key_p, 7), (5,))


def spawn_paths(cam, cfg, base_key, smp, pix_g) -> PathState:
    """Primary rays for (sample, global pixel) lanes → fresh PathState."""
    R = pix_g.shape[0]
    dev = pix_g.device
    px = (pix_g % cfg.width).to(F32)
    py = (pix_g // cfg.width).to(F32)
    u5 = spawn_rng(base_key, smp, pix_g).unbind(-1)
    o_c, d_c, t_c = get_rays_t(cam, px, py, u5)
    ninv = rsqrt32(torch.clamp(
        d_c[0] * d_c[0] + d_c[1] * d_c[1] + d_c[2] * d_c[2], min=1e-16))
    return PathState(
        origin=torch.stack(o_c, -1).expand(R, 3).contiguous(),
        direction=torch.stack([d * ninv for d in d_c], -1),
        time=t_c, color=torch.zeros((R, 3), device=dev),
        throughput=torch.ones((R, 3), device=dev),
        depth=torch.zeros((R,), dtype=torch.int32, device=dev),
        iters=torch.zeros((R,), dtype=torch.int32, device=dev),
        alive=torch.ones((R,), dtype=torch.bool, device=dev))


def medium_sample_t(scene, flags, cfg, med_tab, ox, oy, oz, dx, dy, dz,
                    t1, t2, medium, region_ok, umed):
    """Constant-medium free flight over the chord [t1, t2]
    (``integrator._medium_sample``) → (scatter?, t_scatter, albedo)."""
    mi = torch.clamp(medium, 0, med_tab.shape[0] - 1)
    medrow = _rows(med_tab, mi)
    density = medrow[0]
    t1c = torch.clamp(torch.clamp(t1, min=cfg.t_min), min=0.0)
    t2c = torch.clamp(t2, max=cfg.t_max)
    ray_len = sqrt32(dx * dx + dy * dy + dz * dz)
    distance_inside = (t2c - t1c) * ray_len
    hit_distance = -torch.log(torch.clamp(umed, min=1e-10)) / density
    scatter_in = region_ok & (t1c < t2c) & (hit_distance < distance_inside)
    t_scatter = t1c + hit_distance / ray_len
    zeros = torch.zeros_like(ox)
    albedo = _eval_tex_t(scene, flags, medrow[1].to(torch.int32), zeros,
                         zeros, ox + t_scatter * dx, oy + t_scatter * dy,
                         oz + t_scatter * dz,
                         allow_noise=flags.has_noise_medium,
                         allow_image=flags.has_image_medium)
    return scatter_in, t_scatter, albedo


def bounce_shade_t(scene, flags, cam, cfg, tabs: ShadeTables, path: PathState,
                   found, ptype, pidx, exit_found, t_exit, exit_is_medium,
                   rngs, rec: HitT | None = None, live=None,
                   aux: bool = False):
    """One bounce for every lane (emission, medium free flight, scatter, RR).

    ``rngs`` is the :func:`bounce_rng` dict.  ``rec``, when given, is the
    (R,)-flat hit record to shade in place of refining ``(ptype, pidx)``
    against ``tabs`` (the pipeline mode refines it on the stage that holds
    the primitive; every table read here is replicated).  ``live`` marks the lanes the
    caller keeps (only they run the SSS walk; outputs elsewhere are
    unspecified).  With ``aux`` also returns ``{"walk_steps": n}``, the
    walking trips of kept SSS-volumetric lanes.
    """
    W = torch.where
    ox, oy, oz = path.origin.unbind(-1)
    dx, dy, dz = path.direction.unbind(-1)
    col = list(path.color.unbind(-1))
    thr = list(path.throughput.unbind(-1))
    time = path.time
    depth = path.depth
    alive = path.alive
    u8 = rngs["u8"].unbind(-1)
    umed = rngs["umed"]
    urr = rngs["urr"]
    uiso = rngs["uiso"].unbind(-1)

    bg = background_t(cam, dx, dy, dz)
    miss = [col[k] + thr[k] * bg[k] for k in range(3)]
    if rec is None:
        rec = refine_hit_t(tabs, ptype, pidx, ox, oy, oz, dx, dy, dz, time,
                           cfg.t_min)
    t_hit = rec.t.detach()          # JAX stop_gradient (shade_tiled.py:850)
    zeros = torch.zeros_like(ox)

    if flags.has_medium:
        in_medium = found & (rec.medium >= 0)
        entering = in_medium & rec.front
        exiting = in_medium & ~rec.front
        t1 = W(entering, t_hit, 0.0)
        t2 = W(entering, t_exit, t_hit)
        region_ok = W(entering, exit_found, exiting)
        med_scatter, t_scatter, med_albedo = medium_sample_t(
            scene, flags, cfg, tabs.med, ox, oy, oz, dx, dy, dz, t1, t2,
            rec.medium, region_ok, umed)
        med_scatter = in_medium & med_scatter
        stop_short = entering & exit_found & ~exit_is_medium
        hop_t = W(exiting, t_hit, t_exit)
        cont_t = torch.clamp(
            W(stop_short, t2 - 2.0 * cfg.t_min, hop_t + 1e-3), min=cfg.t_min)
        escape = entering & ~exit_found
        passthrough = in_medium & ~med_scatter & ~escape
        found = found & ~escape
    else:
        med_scatter = torch.zeros_like(found)
        passthrough = torch.zeros_like(found)
        t_scatter = zeros
        cont_t = zeros
        med_albedo = (zeros, zeros, zeros)

    surface = found & ~med_scatter & ~passthrough
    albedo = _eval_tex_t(
        scene, flags,
        _rows(tabs.mat, torch.clamp(rec.mat, 0, tabs.mat.shape[0] - 1))[1]
        .to(torch.int32),
        rec.u, rec.v, *rec.p, allow_noise=True)
    scat_ok, s_o, s_d, s_at, mrow, walk_steps = scatter_t(
        scene, flags, cfg.sss_max_steps, tabs, rec, dx, dy, dz, u8,
        rngs.get("sss_key"), albedo, live=live)
    emit = emitted_t(scene, flags, mrow, rec.u, rec.v, *rec.p)

    surf_f = W(surface, 1.0, 0.0)
    color = [W(found, col[k] + surf_f * thr[k] * emit[k], miss[k])
             for k in range(3)]
    iso = _unit_vector_t(uiso[0], uiso[1])
    medp = (ox + t_scatter * dx, oy + t_scatter * dy, oz + t_scatter * dz)
    scattered = W(med_scatter, True, W(surface, scat_ok, False))
    orig = [ox, oy, oz]
    dirc = [dx, dy, dz]
    n_o = [W(med_scatter, medp[k], s_o[k]) for k in range(3)]
    n_d = [W(med_scatter, iso[k], s_d[k]) for k in range(3)]
    at = [W(med_scatter, med_albedo[k], s_at[k]) for k in range(3)]
    pass_o = [orig[k] + dirc[k] * cont_t for k in range(3)]
    next_o = [W(passthrough, pass_o[k], W(scattered, n_o[k], orig[k]))
              for k in range(3)]
    keep_dir = passthrough | ~scattered
    next_d = [W(keep_dir, dirc[k], n_d[k]) for k in range(3)]
    thr = [W(scattered, thr[k] * at[k], thr[k]) for k in range(3)]
    depth = (depth + W(scattered, 1, 0)).to(torch.int32)
    alive = alive & (passthrough | scattered) & (depth < cfg.max_depth)

    if cfg.use_russian_roulette:
        rr_active = scattered & (depth >= cfg.rr_min_depth)
        survival = torch.clamp(torch.maximum(torch.maximum(thr[0], thr[1]),
                                             thr[2]), max=cfg.rr_max_prob)
        killed = rr_active & (urr > survival)
        boost = W(rr_active & ~killed,
                  1.0 / torch.clamp(survival, min=1e-6), 1.0).detach()
        thr = [t * boost for t in thr]
        alive = alive & ~killed

    out = PathState(origin=torch.stack(next_o, -1),
                    direction=torch.stack(next_d, -1), time=path.time,
                    color=torch.stack(color, -1),
                    throughput=torch.stack(thr, -1), depth=depth,
                    iters=(path.iters + 1).to(torch.int32), alive=alive)
    return (out, {"walk_steps": walk_steps}) if aux else out


# ---------------------------------------------------------------------------
# K3: the control step's shading half, for the wavefront slot pool.
# ---------------------------------------------------------------------------

def shade_plain(eng, ws) -> None:
    """Plain twin of K3 on a :class:`~.wavefront.WaveState` (in place).

    Runs only when the wave's ``do_ctrl`` flag is set.  For occupied slots
    whose query finished: a MAIN hit that enters a medium starts the EXIT
    query from ``best_t + 1e-4`` (``ops/wavefront.py:275-310``); every other
    finished slot is shaded (``bounce_shade_t``), and continuing paths start
    their next MAIN query.  Finished paths get ``FL_FINISHED`` for retire.
    """
    if int(ws.ctr[C_DO_CTRL]) == 0:
        return
    W = torch.where
    cfg, flags, tabs = eng.cfg, eng.flags, eng.tabs
    done = (ws.cur == _DONE) & ws.occupied
    ox, oy, oz = ws.origin.unbind(-1)
    dx, dy, dz = ws.direction.unbind(-1)
    trv_names = ("cur", "stack", "sp", "best_t", "best_pt", "best_pi")
    if flags.has_medium:
        main_done = done & (ws.phase == PH_MAIN)
        m_found = ws.best_pt >= 0
        medium, front = prim_medium_front_t(tabs, ws.best_pt, ws.best_pi,
                                            ox, oy, oz, dx, dy, dz, ws.time,
                                            ws.best_t)
        need_exit = main_done & m_found & (medium >= 0) & front
        exit_trv = traversal_init_batched(eng.bvh, ws.origin, ws.direction,
                                          ws.time, ws.best_t + 1e-4,
                                          cfg.t_max, eng.sd)
        ws.hit_found.copy_(W(main_done, m_found, ws.hit_found))
        ws.hit_pt.copy_(W(main_done, ws.best_pt, ws.hit_pt))
        ws.hit_pi.copy_(W(main_done, ws.best_pi, ws.hit_pi))
        ws.hit_t.copy_(W(main_done, ws.best_t, ws.hit_t))
        exit_done = done & (ws.phase == PH_EXIT)
        ready = (main_done & ~need_exit) | exit_done
        exit_found = exit_done & (ws.best_pt >= 0)
        t_exit = ws.best_t.clone()
        exit_is_medium = exit_done & (medium >= 0)
        ws.phase.copy_(W(need_exit, PH_EXIT, ws.phase))
        for name, v in zip(trv_names, exit_trv):
            cur = getattr(ws, name)
            m = need_exit[:, None] if cur.ndim == 2 else need_exit
            cur.copy_(W(m, v, cur))
        found, r_pt, r_pi = ws.hit_found, ws.hit_pt, ws.hit_pi
    else:
        ready = done
        found = ws.best_pt >= 0
        r_pt, r_pi = ws.best_pt, ws.best_pi
        exit_found = torch.zeros_like(ready)
        t_exit = torch.zeros_like(ws.best_t)
        exit_is_medium = torch.zeros_like(ready)

    rngs = wave_rng(eng.key, ws.sample, ws.pixel, ws.iters, flags.has_sss)
    path = PathState(ws.origin, ws.direction, ws.time, ws.color,
                     ws.throughput, ws.depth, ws.iters, ws.alive)
    shaded, sh_aux = bounce_shade_t(
        eng.scene, flags, eng.cam, cfg, tabs, path, found.clone(),
        r_pt.clone(), r_pi.clone(), exit_found, t_exit, exit_is_medium, rngs,
        live=ready, aux=True)
    ws.ctr[C_WALK_STEPS] += sh_aux["walk_steps"]
    for name, v in zip(PathState._fields, shaded):
        cur = getattr(ws, name)
        m = ready[:, None] if cur.ndim == 2 else ready
        cur.copy_(W(m, v, cur))
    cont = ready & ws.alive & (ws.iters < cfg.iters)
    fresh = traversal_init_batched(eng.bvh, ws.origin, ws.direction, ws.time,
                                   cfg.t_min, cfg.t_max, eng.sd)
    for name, v in zip(trv_names, fresh):
        cur = getattr(ws, name)
        m = cont[:, None] if cur.ndim == 2 else cont
        cur.copy_(W(m, v, cur))
    ws.phase.copy_(W(cont, PH_MAIN, ws.phase))
    ws.flag.copy_(W(ready & ~cont, FL_FINISHED, ws.flag))


def shade(eng, ws) -> None:
    """K3 wrapper: CUDA kernel for CUDA state, plain twin for CPU state."""
    if not ws.cur.is_cuda:
        return shade_plain(eng, ws)
    kernels.launch("shade", eng, ws)
