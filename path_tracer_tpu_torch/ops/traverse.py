"""BVH4 closest-hit traversal, hit refinement, brute-force oracle, K1.

Port of ``path_tracer_tpu/ops/traverse.py``: the batched suspended walk
(``traversal_init_batched`` :280, ``_step_tiled`` :334,
``traversal_steps_batched`` :408, ``traversal_done`` :508), the per-ray
walk to completion (``_traverse_impl`` :512, ``traverse_bvh`` :526; JAX's
per-ray ``traversal_init``/``traversal_step``/``traversal_steps`` are the
batched functions here, applied to a batch of rays), the full hit record
(``intersect_prim`` :73, ``refine_hit`` :558) and ``first_hit_brute``
(:584).  State is a :class:`TravState` of flat ``(R,)`` tensors plus an
``(R, SD)`` stack.  The walk runs without autograd (``_traverse_impl`` is
``no_grad``), which gives ``ro``/``rd`` the zero gradient of JAX's
``traverse_bvh`` custom VJP.

:func:`trace_step` is kernel K1 (``csrc/trace_step.cu``): one launch walks
every occupied wavefront slot up to ``steps_per_wave`` steps and evaluates
the wave's control predicate.  :func:`trace_step_plain` is its plain-torch
twin with the same signature; the wrapper takes the twin only for CPU
tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import intersect as isect
from . import kernels
from .types import (BVH_EMPTY_SLOT, C_CTRLS, C_DO_CTRL, C_EXEC_STEPS, C_N_OCC,
                    C_OCC_SUM, C_SPAWNED, C_TRAV_STEPS, C_WAVES, PH_EXIT,
                    PRIM_QUAD, PRIM_ROW, PRIM_SPHERE, PRIM_TRIANGLE, PackedBVH,
                    SceneArrays, bvh_layout)
from ..utils import vec

INF = isect.INF
_SORT_NET = {
    4: ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)),
    8: ((0, 1), (2, 3), (4, 5), (6, 7),
        (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6), (0, 4), (3, 7),
        (1, 5), (2, 6), (1, 4), (3, 6),
        (2, 4), (3, 5), (3, 4)),
}
_DONE = -(2 ** 30)
INNER_STEPS = 8   # steps per check of the per-ray walk (traverse.py:124)


class TravState(NamedTuple):
    cur: torch.Tensor      # (R,) int32 node ptr; _DONE when finished
    stack: torch.Tensor    # (R, SD) int32
    sp: torch.Tensor       # (R,) int32
    best_t: torch.Tensor   # (R,) f32
    best_pt: torch.Tensor  # (R,) int32 prim type (-1 none)
    best_pi: torch.Tensor  # (R,) int32 prim index


def _lanes(x, R, dtype, device):
    x = torch.as_tensor(x, dtype=dtype, device=device)
    return x.expand(R) if x.ndim == 0 else x


def traversal_init_batched(bvh: PackedBVH, ro, rd, time, t_min, t_max,
                           stack_depth: int) -> TravState:
    """Start R closest-hit queries (handles the single-prim root-leaf case)."""
    sd = min(stack_depth, bvh.max_stack)
    R = ro.shape[0]
    dev = ro.device
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    rr = rdx * rdx + rdy * rdy + rdz * rdz
    time = _lanes(time, R, torch.float32, dev)
    t_min = _lanes(t_min, R, torch.float32, dev)
    best_t = torch.full((R,), t_max, dtype=torch.float32, device=dev)
    root = bvh.root.to(dev)
    root_leaf = root < 0
    uid = torch.clamp(-root - 1, 0, bvh.prims.shape[0] - 1)
    row = bvh.prims[uid.long()]
    pr = [row[j] for j in range(14)]
    lhit, lt = isect.hit_prim_row_s(pr, rox, roy, roz, rdx, rdy, rdz, rr,
                                    time, t_min, best_t, mask=bvh.prim_mask)
    closer = root_leaf & lhit & (lt < best_t)
    best_t = torch.where(closer, lt, best_t)
    best_pt = torch.where(closer, pr[0].to(torch.int32), -1).to(torch.int32)
    best_pi = torch.where(closer, pr[1].to(torch.int32), -1).to(torch.int32)
    cur = torch.where(root_leaf, _DONE, root).to(torch.int32).expand(R)
    return TravState(cur=cur.clone(),
                     stack=torch.zeros((R, sd), dtype=torch.int32, device=dev),
                     sp=torch.zeros((R,), dtype=torch.int32, device=dev),
                     best_t=best_t, best_pt=best_pt, best_pi=best_pi)


def _step(bvh: PackedBVH, s: TravState, rox, roy, roz, ivx, ivy, ivz,
          rdx, rdy, rdz, rr, time, t_min, iota) -> TravState:
    """One masked BVH-K step (``_step_tiled``'s math, lane-major)."""
    K = bvh.branching
    ptr_off, payload, _ = bvh_layout(K)
    cur, stack, sp = s.cur, s.stack, s.sp
    best_t, best_pt, best_pi = s.best_t, s.best_pt, s.best_pi
    active = cur != _DONE
    rows = bvh.nodes[torch.where(active, cur, 0).long()]
    cand_t, cand_p = [], []
    for i in range(K):
        ptr = rows[:, ptr_off + i].to(torch.int32)
        b = 6 * i
        hi, ti = isect.hit_aabb_s(rows[:, b], rows[:, b + 1], rows[:, b + 2],
                                  rows[:, b + 3], rows[:, b + 4], rows[:, b + 5],
                                  rox, roy, roz, ivx, ivy, ivz, t_min, best_t)
        hi = hi & active & (ptr < BVH_EMPTY_SLOT)
        is_leaf = ptr < 0
        pr = [rows[:, payload + PRIM_ROW * i + j] for j in range(14)]
        lhit, lt = isect.hit_prim_row_s(pr, rox, roy, roz, rdx, rdy, rdz, rr,
                                        time, t_min, best_t,
                                        mask=bvh.prim_mask)
        closer = (hi & is_leaf) & lhit & (lt < best_t)
        best_t = torch.where(closer, lt, best_t)
        best_pt = torch.where(closer, pr[0].to(torch.int32), best_pt)
        best_pi = torch.where(closer, pr[1].to(torch.int32), best_pi)
        cand_t.append(torch.where(hi & ~is_leaf, ti, INF))
        cand_p.append(ptr)

    for a, b in _SORT_NET[K]:
        swap = cand_t[a] > cand_t[b]
        cand_t[a], cand_t[b] = (torch.where(swap, cand_t[b], cand_t[a]),
                                torch.where(swap, cand_t[a], cand_t[b]))
        cand_p[a], cand_p[b] = (torch.where(swap, cand_p[b], cand_p[a]),
                                torch.where(swap, cand_p[a], cand_p[b]))
    valid = [t < INF for t in cand_t]

    sd = stack.shape[1]
    for k in range(K - 1, 0, -1):
        push = (iota == sp[:, None]) & valid[k][:, None]
        stack = torch.where(push, cand_p[k][:, None], stack)
        sp = torch.clamp(sp + valid[k].to(torch.int32), max=sd)
    can_pop = sp > 0
    popped = torch.where(
        can_pop, stack.gather(1, torch.clamp(sp - 1, min=0).long()[:, None])[:, 0],
        0)
    nxt = torch.where(valid[0], cand_p[0],
                      torch.where(can_pop, popped, _DONE))
    cur = torch.where(active, nxt, _DONE).to(torch.int32)
    sp = (sp - (active & (~valid[0]) & can_pop).to(torch.int32)).to(torch.int32)
    return TravState(cur, stack, sp, best_t, best_pt, best_pi)


def traversal_steps_batched(bvh: PackedBVH, s: TravState, ro, rd, time,
                            t_min, n_steps: int, count_steps: bool = False):
    """Run ``n_steps`` masked steps on an (R,)-batched :class:`TravState`.

    A step on a finished lane is a no-op, so stopping once every lane is
    done gives the same state.  With ``count_steps`` also returns the
    walking-lane step count and the steps executed.
    """
    R = s.cur.shape[0]
    dev = s.cur.device
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    ivx, ivy, ivz = 1.0 / rdx, 1.0 / rdy, 1.0 / rdz
    rr = rdx * rdx + rdy * rdy + rdz * rdz
    time = _lanes(time, R, torch.float32, dev)
    t_min = _lanes(t_min, R, torch.float32, dev)
    iota = torch.arange(s.stack.shape[1], dtype=torch.int32, device=dev)[None]
    lane_steps = 0
    executed = 0
    for _ in range(n_steps):
        n_act = int((s.cur != _DONE).sum())
        if n_act == 0:
            break
        lane_steps += n_act
        executed += 1
        s = _step(bvh, s, rox, roy, roz, ivx, ivy, ivz, rdx, rdy, rdz, rr,
                  time, t_min, iota)
    return (s, lane_steps, executed) if count_steps else s


def traversal_done(s: TravState):
    return s.cur == _DONE


@torch.no_grad()
def _traverse_impl(bvh: PackedBVH, ro, rd, time, t_min, t_max,
                   stack_depth: int, active=None):
    """Walk every ray to completion → (hit, prim_type, prim_idx, t, steps).

    ``active`` (optional (R,) bool) starts only those queries; the others
    return no hit.  ``steps`` counts the walking-lane steps.  Runs without
    autograd: visibility is discrete, and JAX's ``traverse_bvh`` custom VJP
    gives every input a zero cotangent; shading recomputes the hit
    differentiably (``refine_hit``).
    """
    s = traversal_init_batched(bvh, ro, rd, time, t_min, t_max, stack_depth)
    if active is not None:
        s = s._replace(cur=torch.where(active, s.cur, _DONE),
                       best_pt=torch.where(active, s.best_pt, -1),
                       best_pi=torch.where(active, s.best_pi, -1))
    steps = 0
    while True:
        s, n, executed = traversal_steps_batched(bvh, s, ro, rd, time, t_min,
                                                 INNER_STEPS, count_steps=True)
        steps += n
        if executed < INNER_STEPS:
            break
    return s.best_pt >= 0, s.best_pt, s.best_pi, s.best_t, steps


@torch.no_grad()
def traverse_bvh(bvh: PackedBVH, ro, rd, time, t_min, t_max,
                 stack_depth: int = 48):
    """Closest-hit query per ray → ``(hit, prim_type, prim_idx, t)``."""
    return _traverse_impl(bvh, ro, rd, time, t_min, t_max, stack_depth)[:4]


class Hit(NamedTuple):
    """Hit record (``traverse.Hit``): vectors are (N, 3)."""

    hit: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    normal: torch.Tensor      # shading normal (flipped toward the ray)
    front_face: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    mat: torch.Tensor         # int32 material index
    medium: torch.Tensor      # int32 constant-medium index or -1
    prim_type: torch.Tensor
    prim_idx: torch.Tensor


def _prim_index(scene: SceneArrays, pidx):
    """Per-family clamped indices of ``pidx`` (sphere, quad, triangle)."""
    cl = lambda n: torch.clamp(pidx, 0, n - 1).long()  # noqa: E731
    return (cl(scene.sph_rad.shape[0]), cl(scene.qd_d.shape[0]),
            cl(scene.tr_mat.shape[0]))


def intersect_prim(scene: SceneArrays, ptype, pidx, ro, rd, time, t_min,
                   t_max):
    """Full-record intersection of primitive (type, index) per ray; all
    three families computed and selected by type → (hit, t, p, n, u, v)."""
    si, qi, ti = _prim_index(scene, pidx)
    hs = isect.hit_sphere(scene.sph_c0[si], scene.sph_c1[si],
                          scene.sph_rad[si], ro, rd, time, t_min, t_max)
    hq = isect.hit_quad(scene.qd_q[qi], scene.qd_u[qi], scene.qd_v[qi],
                        scene.qd_n[qi], scene.qd_w[qi], scene.qd_d[qi],
                        ro, rd, t_min, t_max)
    ht = isect.hit_triangle(scene.tr_v0[ti], scene.tr_e1[ti],
                            scene.tr_e2[ti], scene.tr_n[ti], ro, rd, t_min,
                            t_max)
    is_s, is_q = ptype == PRIM_SPHERE, ptype == PRIM_QUAD

    def sel(a, b, c):
        if a.ndim > is_s.ndim:
            return torch.where(is_s[:, None], a, torch.where(is_q[:, None], b, c))
        return torch.where(is_s, a, torch.where(is_q, b, c))

    hit = sel(hs[0], hq[0], ht[0]) & (ptype >= 0)
    return (hit,) + tuple(sel(hs[k], hq[k], ht[k]) for k in range(1, 6))


def refine_hit(scene: SceneArrays, ptype, pidx, ro, rd, time, t_min) -> Hit:
    """Full hit record for known primitives (the shading side of a hit)."""
    hit, t, p, n_out, u, v = intersect_prim(scene, ptype, pidx, ro, rd, time,
                                            t_min, INF)
    front = vec.vdot(rd, n_out) < 0.0
    normal = torch.where(front, 1.0, -1.0)[:, None] * n_out
    si, qi, ti = _prim_index(scene, pidx)
    is_s, is_q = ptype == PRIM_SPHERE, ptype == PRIM_QUAD
    mat = torch.where(is_s, scene.sph_mat[si],
                      torch.where(is_q, scene.qd_mat[qi], scene.tr_mat[ti]))
    medium = torch.where(is_s, scene.sph_medium[si],
                         torch.where(is_q, scene.qd_medium[qi],
                                     scene.tr_medium[ti]))
    return Hit(hit=hit & (ptype >= 0), t=t, p=p, normal=normal,
               front_face=front, u=u, v=v, mat=mat.to(torch.int32),
               medium=medium.to(torch.int32), prim_type=ptype, prim_idx=pidx)


# ---------------------------------------------------------------------------
# Brute-force oracle.
# ---------------------------------------------------------------------------

def first_hit_brute(scene: SceneArrays, ro, rd, time, t_min, t_max):
    """Closest hit over every valid primitive for rays ``ro``/``rd`` (N, 3).

    Returns ``(hit, prim_type, prim_idx, t)`` per ray, like the JAX oracle.
    """
    N = ro.shape[0]
    dev = ro.device
    time = _lanes(time, N, torch.float32, dev)
    o, d = ro[:, None, :], rd[:, None, :]
    hs, ts, *_ = isect.hit_sphere(scene.sph_c0[None], scene.sph_c1[None],
                                  scene.sph_rad[None], o, d, time[:, None],
                                  t_min, t_max)
    hs = hs & scene.sph_valid[None]
    hq, tq, *_ = isect.hit_quad(scene.qd_q[None], scene.qd_u[None],
                                scene.qd_v[None], scene.qd_n[None],
                                scene.qd_w[None], scene.qd_d[None], o, d,
                                t_min, t_max)
    hq = hq & scene.qd_valid[None]
    ht, tt, *_ = isect.hit_triangle(scene.tr_v0[None], scene.tr_e1[None],
                                    scene.tr_e2[None], scene.tr_n[None], o, d,
                                    t_min, t_max)
    ht = ht & scene.tr_valid[None]
    allh = torch.cat([hs, hq, ht], dim=1)
    allt = torch.where(allh, torch.cat([ts, tq, tt], dim=1),
                       torch.tensor(INF, dtype=torch.float32, device=dev))
    ns, nq, nt = hs.shape[1], hq.shape[1], ht.shape[1]
    pt = torch.cat([torch.full((ns,), PRIM_SPHERE), torch.full((nq,), PRIM_QUAD),
                    torch.full((nt,), PRIM_TRIANGLE)]).to(dev, torch.int32)
    pi = torch.cat([torch.arange(ns), torch.arange(nq),
                    torch.arange(nt)]).to(dev, torch.int32)
    k = torch.argmin(allt, dim=1)
    found = allh.gather(1, k[:, None])[:, 0]
    return (found, torch.where(found, pt[k], -1), torch.where(found, pi[k], -1),
            allt.gather(1, k[:, None])[:, 0])


# ---------------------------------------------------------------------------
# K1: one wave of suspended traversal for the wavefront slot pool.
# ---------------------------------------------------------------------------

def trace_step_plain(eng, ws) -> None:
    """Plain twin of K1 on a :class:`~.wavefront.WaveState` (in place).

    Walks every slot up to ``eng.steps`` steps (MAIN queries from
    ``t_min``, volume-exit queries from ``hit_t + 1e-4``), then evaluates the
    wave's control predicate into ``ws.ctr``: ``waves``/``ctrls``/
    ``occ_sum`` bookkeeping and the ``do_ctrl`` flag the control kernels
    read (``ops/wavefront.py:451-462``).
    """
    ctr = ws.ctr
    spawned = min(int(ctr[C_SPAWNED]), eng.items_total)
    n_occ = int(ctr[C_N_OCC])
    if not (spawned < eng.items_total or n_occ > 0):
        ctr[C_DO_CTRL] = 0
        return
    t_min_q = torch.where(ws.phase == PH_EXIT, ws.hit_t + 1e-4,
                          torch.tensor(eng.cfg.t_min, dtype=torch.float32,
                                       device=ws.hit_t.device))
    trv = TravState(ws.cur, ws.stack, ws.sp, ws.best_t, ws.best_pt, ws.best_pi)
    trv, lane_steps, executed = traversal_steps_batched(
        eng.bvh, trv, ws.origin, ws.direction, ws.time, t_min_q, eng.steps,
        count_steps=True)
    for name, v in zip(("cur", "stack", "sp", "best_t", "best_pt", "best_pi"),
                       trv):
        getattr(ws, name).copy_(v)
    done = (ws.cur == _DONE) & ws.occupied
    n_ready = int(done.sum())
    n_walk = int((ws.occupied & ~done).sum())
    n_empty = eng.R - n_occ
    can_spawn = spawned < eng.items_total and n_empty > 0
    do_ctrl = ((n_ready + (n_empty if can_spawn else 0)) * eng.ctrl_den
               >= eng.R) or n_walk == 0
    ctr[C_WAVES] += 1
    ctr[C_OCC_SUM] += n_occ
    ctr[C_TRAV_STEPS] += lane_steps
    ctr[C_EXEC_STEPS] += executed
    ctr[C_CTRLS] += int(do_ctrl)
    ctr[C_DO_CTRL] = int(do_ctrl)


def trace_step(eng, ws) -> None:
    """K1 wrapper: CUDA kernel for CUDA state, plain twin for CPU state."""
    if not ws.cur.is_cuda:
        return trace_step_plain(eng, ws)
    kernels.launch("trace_step", eng, ws)
