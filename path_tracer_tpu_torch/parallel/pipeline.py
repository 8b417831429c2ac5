"""Pipeline-parallel mode: scene-shard stages on a ring of ranks.

Port of ``path_tracer_tpu/parallel/pipeline.py``: ``_empty_rec`` (:53),
``_ring_closest_hit`` (:63), ``_trace_rays_pp`` (:108) and ``render_pp``
(:154).  Each stage owns 1/S of the geometry (its own BVH, from
:func:`~.scene_shard.shard_scene`) and a contiguous pixel block.  Per
query the block's rays travel the ring: at each hop the resident stage
walks its BVH and, where its hit is closer than the carried best, refines
the full hit record from its primitive rows (K9 ``ring_hop``), and the
bundle moves to the next stage (a point-to-point hop).  After S hops the
bundle is home with the global closest hit, and the home stage shades it
(K8's rec variant: every table the bounce reads is replicated).
"""
from __future__ import annotations

import torch

from ..ops import intersect as isect
from ..ops import kernels
from ..ops.integrator_tiled import (REC_FIELDS, TiledEngine,
                                    closest_hit_plain, new_counters,
                                    rec_to_rows, tiled_spawn, tiled_trip)
from ..ops.shade_tiled import refine_hit_t
from ..ops.types import PathState, RenderConfig
from .render_dist import Axis, Mesh, assemble
from .scene_shard import _check_shards, local_shard

N_REC = len(REC_FIELDS)


def _empty_rec(R: int, device) -> torch.Tensor:
    """The carried best-hit record before any stage has intersected:
    t = INF, medium -1, the rest 0 (rows of :data:`REC_FIELDS`)."""
    rec = torch.zeros((R, N_REC), device=device)
    rec[:, 0] = isect.INF
    rec[:, 11] = -1.0
    return rec


def ring_hop_plain(eng: TiledEngine, ro, rd, time, t_min, active, fnd, tbest,
                   rec, ctr=None) -> None:
    """Plain version of K9 (in place on the carried ``fnd``, ``tbest``,
    ``rec``): this stage's closest hit, its record refined from the local
    rows, merged where it is closer than the carried best.  Only a strictly
    closer hit is merged, so the walk ends at the carried best
    (``min(t_max, tbest)``; JAX walks to ``t_max``): the merged bundle is
    the same, in fewer traversal steps."""
    cfg = eng.cfg
    bound = torch.clamp(tbest, max=cfg.t_max)
    found, pt, pi, t = closest_hit_plain(eng.bvh, ro, rd, time, t_min, bound,
                                         cfg.stack_depth, active, ctr)
    loc = refine_hit_t(eng.tabs, pt, pi, *ro.unbind(-1), *rd.unbind(-1), time,
                       t_min)
    better = found & (t < tbest)
    fnd |= better
    tbest.copy_(torch.where(better, t, tbest))
    rec.copy_(torch.where(better[:, None], rec_to_rows(loc), rec))


def ring_hop(eng: TiledEngine, ro, rd, time, t_min, active, fnd, tbest, rec,
             ctr=None) -> None:
    """K9 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; both update ``fnd``, ``tbest`` and ``rec`` in place."""
    if not ro.is_cuda:
        return ring_hop_plain(eng, ro, rd, time, t_min, active, fnd, tbest,
                              rec, ctr)
    R, dev = ro.shape[0], ro.device
    a = eng.args()
    kernels.set_lanes(a, R, dev, ctr if ctr is not None else new_counters(dev),
                      origin=ro, direction=rd, time=time, q_tmin=t_min,
                      q_active=active, hit_found=fnd, hit_t=tbest, rec=rec)
    kernels.set_stack(a, R, dev)
    kernels.launch_args("ring_hop", a, dev)


def _ring_closest_hit(eng: TiledEngine, ax: Axis, ro, rd, time, t_min,
                      active):
    """The global closest hit by ``ax.size`` hops around the ring →
    ``(found, t, rec)``: the traversal's hit distance (INF on a miss) and
    the winner's (R, 12) record, back on the home stage."""
    R = ro.shape[0]
    f32 = torch.float32
    fnd = torch.zeros((R,), dtype=torch.bool, device=ro.device)
    tbest = torch.full((R,), isect.INF, device=ro.device)
    rec = _empty_rec(R, ro.device)
    for _ in range(ax.size):
        ring_hop(eng, ro, rd, time, t_min, active, fnd, tbest, rec)
        # The whole bundle moves one stage on (one message per hop).
        b = ax.ppermute_next(torch.cat(
            [ro, rd, time[:, None], t_min[:, None], active[:, None].to(f32),
             fnd[:, None].to(f32), tbest[:, None], rec], 1))
        ro, rd = b[:, 0:3].contiguous(), b[:, 3:6].contiguous()
        time, t_min = b[:, 6].contiguous(), b[:, 7].contiguous()
        active, fnd = b[:, 8] != 0.0, b[:, 9] != 0.0
        tbest, rec = b[:, 10].contiguous(), b[:, 11:].contiguous()
    return fnd, tbest, rec


def _trace_rays_pp(eng: TiledEngine, ax: Axis, path0: PathState, sample: int,
                   pix):
    """Trace the home block to completion with ring-pipelined queries →
    (R, 3); shading stays on the home stage."""
    cfg = eng.cfg
    R = path0.origin.shape[0]
    t_min_v = torch.full((R,), cfg.t_min, device=pix.device)
    zi = torch.zeros((R,), dtype=torch.int32, device=pix.device)
    s = path0
    for _ in range(cfg.iters):
        found, t_hit, rec = _ring_closest_hit(eng, ax, s.origin, s.direction,
                                              s.time, t_min_v, s.alive)
        ext = exit_med = None
        if eng.flags.has_medium:
            e_found, t_exit, e_rec = _ring_closest_hit(
                eng, ax, s.origin, s.direction, s.time, t_hit + 1e-4,
                s.alive & found)
            exit_med = e_found & (e_rec[:, 11] >= 0)
            ext = (e_found, zi, zi, t_exit)
        s = tiled_trip(eng, s, sample, pix, (found, zi, zi), ext,
                       exit_med=exit_med, rec=rec)
    return s.color


def render_pp(scene_pp, flags, bvh_pp, cam, cfg: RenderConfig, base_key,
              mesh: Mesh, spp: int = 1, axis: str = "p"):
    """Pipeline-parallel render over a 1-D stage ring → the (H, W, 3) mean
    on every rank.  ``scene_pp``/``bvh_pp`` come from ``shard_scene`` with
    one shard per stage; each stage also owns a contiguous pixel block (the
    last padded: its tail pixels are traced and dropped)."""
    ax = mesh.axis(axis)
    _check_shards(ax.size, scene_pp, axis)
    scene_l, bvh_l = local_shard(scene_pp, bvh_pp, ax.index)
    eng = TiledEngine(scene_l, flags, bvh_l, cam, cfg, base_key)
    npix = cfg.width * cfg.height
    per = -(-npix // ax.size)
    off = ax.index * per
    pix = torch.arange(off, off + per, dtype=torch.int32, device=eng.device)
    acc = torch.zeros((per, 3), device=eng.device)
    for s in range(spp):
        path0 = tiled_spawn(eng, s, pix)
        acc = acc + _trace_rays_pp(eng, ax, path0, s, pix)
    return assemble(acc / spp, ax, off, npix, cfg)
