"""Tensor-parallel mode: the scene sharded by primitive over a mesh axis.

Port of ``path_tracer_tpu/parallel/scene_shard.py``: ``shard_scene``
(:51), ``_traverse_tp`` (:121), ``_bcast`` (:145, :class:`~.render_dist.Axis`
``bcast``), ``_trace_rays_tp`` (:160), ``render_tp`` (:215) and
``render_dp_tp`` (:260).  Each rank of the axis holds 1/T of the geometry
and its own BVH, with the small material, texture, medium and Perlin
tables replicated, and traces every ray of its pixels against its shard
(K7).  The closest hit is a ``pmin`` of ``t`` and then of the candidate
rank (the lowest rank wins an exact tie); the winner shades the bounce
(K8 with its local primitive rows), rank 0 shades misses, and the new path
state is broadcast by a masked sum, so the rays stay replicated and in
lock-step.  In a medium scene the volume-exit query repeats the reduce,
and the exit hit's medium flag is broadcast from its owner.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import intersect as isect
from ..ops.bvh_build import build_from_scene
from ..ops.integrator_tiled import (TiledEngine, closest_hit_batched,
                                    tiled_spawn, tiled_trip)
from ..ops.shade_tiled import prim_medium_t
from ..ops.types import PackedBVH, PathState, RenderConfig, SceneArrays, bvh_layout
from .render_dist import Axis, Mesh, assemble

_GEOM_FIELDS = {
    "sphere": ["sph_c0", "sph_c1", "sph_rad", "sph_mat", "sph_valid",
               "sph_medium"],
    "quad": ["qd_q", "qd_u", "qd_v", "qd_n", "qd_w", "qd_d", "qd_mat",
             "qd_valid", "qd_medium"],
    "triangle": ["tr_v0", "tr_e1", "tr_e2", "tr_n", "tr_mat", "tr_valid",
                 "tr_medium"],
}
_VALID = {"sphere": "sph_valid", "quad": "qd_valid", "triangle": "tr_valid"}


def shard_scene(scene: SceneArrays, n_shards: int, branching: int = 4):
    """Partition a compiled scene into ``n_shards`` equal-shaped sub-scenes.

    Valid primitives are dealt round-robin per family; every other table is
    replicated.  A shard the deal leaves empty gets a duplicate of the first
    primitive of the first non-empty family (closest-hit visibility is
    unchanged by a duplicate).  Each family pads to the largest shard, with
    ``-1`` in the medium columns; each shard's BVH is built, and the BVH
    rows pad to the largest with never-hit inverted boxes and empty child
    pointers.  Returns ``(scene_tp, bvh_tp)``, every array with a leading
    shard axis, on the scene's device.
    """
    dev = scene.sph_c0.device
    host = {f.name: getattr(scene, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(scene)}
    fam_idx = {fam: np.nonzero(host[_VALID[fam]])[0] for fam in _GEOM_FIELDS}
    donor_fam = next(f for f in _GEOM_FIELDS if len(fam_idx[f]))
    shards = []
    for s in range(n_shards):
        repl = {}
        empty = all(len(fam_idx[f][s::n_shards]) == 0 for f in _GEOM_FIELDS)
        for fam, fields in _GEOM_FIELDS.items():
            idx = fam_idx[fam]
            mine = idx[s::n_shards]
            if empty and fam == donor_fam:
                mine = idx[:1]
            cap = max(1, -(-len(idx) // n_shards))
            for f in fields:
                a = host[f]
                pad = np.zeros((cap - len(mine),) + a.shape[1:], a.dtype)
                if f.endswith("_medium"):
                    pad = pad - 1
                repl[f] = np.concatenate([a[mine], pad], axis=0)
        shards.append(dict(host, **repl))

    bvhs = [build_from_scene(SceneArrays(**{k: torch.from_numpy(np.array(v))
                                            for k, v in sh.items()}),
                             branching=branching) for sh in shards]
    n_nodes = max(b.nodes.shape[0] for b in bvhs)
    n_prims = max(b.prims.shape[0] for b in bvhs)
    mask = tuple(any(b.prim_mask[i] for b in bvhs) for i in range(3))
    ptr_off, _, node_row = bvh_layout(branching)

    def padrows(a, n):
        a = a.numpy()
        if a.shape[0] == n:
            return a
        ext = np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)
        if a.ndim == 2 and a.shape[1] == node_row:
            ext[:, 0:6 * branching:6] = 1.0
            ext[:, 3:6 * branching:6] = -1.0
            ext[:, ptr_off:ptr_off + branching] = float(1 << 23)
        return np.concatenate([a, ext], axis=0)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    bvh_tp = PackedBVH(
        nodes=t(np.stack([padrows(b.nodes, n_nodes) for b in bvhs])),
        prims=t(np.stack([padrows(b.prims, n_prims) for b in bvhs])),
        root=t(np.stack([b.root.numpy() for b in bvhs])),
        prim_mask=mask, max_stack=max(b.max_stack for b in bvhs),
        branching=branching)
    scene_tp = SceneArrays(**{k: t(np.stack([sh[k] for sh in shards]))
                              for k in host})
    return scene_tp, bvh_tp


def local_shard(scene_tp, bvh_tp, r: int):
    """Shard ``r`` of a :func:`shard_scene` result as a scene and a BVH."""
    scene_l = SceneArrays(**{f.name: getattr(scene_tp, f.name)[r]
                             for f in dataclasses.fields(scene_tp)})
    bvh_l = PackedBVH(nodes=bvh_tp.nodes[r], prims=bvh_tp.prims[r],
                      root=bvh_tp.root[r], prim_mask=bvh_tp.prim_mask,
                      max_stack=bvh_tp.max_stack, branching=bvh_tp.branching)
    return scene_l, bvh_l


def _check_shards(n_axis: int, scene_tp, axis: str) -> None:
    n_sh = scene_tp.sph_c0.shape[0]
    if n_axis != n_sh:
        raise ValueError(
            f"scene is sharded {n_sh}-way but mesh axis {axis!r} has "
            f"{n_axis} devices; reshard with shard_scene(scene, {n_axis})")


def _traverse_tp(eng: TiledEngine, ax: Axis, ro, rd, time, t_min,
                 active=None):
    """This shard's closest hit (K7), reduced over the axis → ``(any_found,
    ptype, pidx, t_best, mine)``: ``ptype``/``pidx`` are the winner's local
    ids on the winning rank and -1 elsewhere, ``mine`` marks the winner
    (the lowest rank on an exact tie)."""
    cfg = eng.cfg
    found, pt, pi, t = closest_hit_batched(eng.bvh, ro, rd, time, t_min,
                                           cfg.t_max, cfg.stack_depth,
                                           active=active)
    t_eff = torch.where(found, t, torch.full_like(t, isect.INF))
    t_best = ax.pmin(t_eff.clone())
    is_cand = found & (t_eff <= t_best)
    winner = ax.pmin(torch.where(is_cand, ax.index, 1 << 30).to(torch.int32))
    mine = is_cand & (winner == ax.index)
    return (t_best < isect.INF, torch.where(mine, pt, -1),
            torch.where(mine, pi, -1), t_best, mine)


def _bcast_state(ax: Axis, owner, st: PathState) -> PathState:
    """The owner's path state on every rank, one masked sum of the packed
    fields (the integers and the flag are exact in float32)."""
    f32 = torch.float32
    packed = torch.cat([st.origin, st.direction, st.time[:, None], st.color,
                        st.throughput, st.depth[:, None].to(f32),
                        st.iters[:, None].to(f32), st.alive[:, None].to(f32)],
                       1)
    p = ax.bcast(owner, packed)
    i32 = torch.int32
    return PathState(origin=p[:, 0:3].contiguous(),
                     direction=p[:, 3:6].contiguous(),
                     time=p[:, 6].contiguous(), color=p[:, 7:10].contiguous(),
                     throughput=p[:, 10:13].contiguous(),
                     depth=p[:, 13].to(i32), iters=p[:, 14].to(i32),
                     alive=p[:, 15] != 0.0)


def _trace_rays_tp(eng: TiledEngine, ax: Axis, path0: PathState, sample: int,
                   pix):
    """``trace_rays_tiled`` with the scene sharded over ``ax`` → (R, 3):
    per trip the reduced query, the winner's bounce, the broadcast."""
    cfg = eng.cfg
    R = path0.origin.shape[0]
    t_min_v = torch.full((R,), cfg.t_min, device=pix.device)
    s = path0
    for _ in range(cfg.iters):
        found, pt, pi, t_hit, mine = _traverse_tp(
            eng, ax, s.origin, s.direction, s.time, t_min_v, s.alive)
        ext = exit_med = None
        if eng.flags.has_medium:
            e_found, e_pt, e_pi, t_exit, e_mine = _traverse_tp(
                eng, ax, s.origin, s.direction, s.time, t_hit + 1e-4,
                s.alive & found)
            e_med = prim_medium_t(eng.tabs, e_pt, e_pi) >= 0
            exit_med = ax.bcast(e_mine, e_med) & e_found
            ext = (e_found, e_pt, e_pi, t_exit)
        shaded = tiled_trip(eng, s, sample, pix, (found, pt, pi), ext,
                            exit_med=exit_med)
        # The winner owns the bounce; rank 0 owns misses (the background).
        owner = mine | ((ax.index == 0) & ~found)
        s = _bcast_state(ax, owner, shaded)
    return s.color


def _render_block(eng: TiledEngine, ax: Axis, pix, spp: int):
    acc = torch.zeros((pix.shape[0], 3), device=pix.device)
    for s in range(spp):
        path0 = tiled_spawn(eng, s, pix)
        acc = acc + _trace_rays_tp(eng, ax, path0, s, pix)
    return acc / spp


def render_tp(scene_tp, flags, bvh_tp, cam, cfg: RenderConfig, base_key,
              mesh: Mesh, spp: int = 1, axis: str = "t"):
    """Render with the scene sharded by primitive over ``mesh``'s ``axis``
    → the (H, W, 3) mean on every rank (each rank traces every pixel
    against its shard)."""
    ax = mesh.axis(axis)
    _check_shards(ax.size, scene_tp, axis)
    scene_l, bvh_l = local_shard(scene_tp, bvh_tp, ax.index)
    eng = TiledEngine(scene_l, flags, bvh_l, cam, cfg, base_key)
    npix = cfg.width * cfg.height
    pix = torch.arange(npix, dtype=torch.int32, device=eng.device)
    return _render_block(eng, ax, pix, spp).reshape(cfg.height, cfg.width, 3)


def render_dp_tp(scene_tp, flags, bvh_tp, cam, cfg: RenderConfig, base_key,
                 mesh: Mesh, spp: int = 1, dp_axis: str = "d",
                 tp_axis: str = "t"):
    """DP×TP render over a 2-D mesh → the (H, W, 3) mean on every rank:
    pixels shard over ``dp_axis`` (contiguous blocks, the last padded), the
    scene over ``tp_axis``; the collectives run over ``tp_axis`` only, and
    one sum over every rank assembles the frame."""
    tp, dp = mesh.axis(tp_axis), mesh.axis(dp_axis)
    _check_shards(tp.size, scene_tp, tp_axis)
    scene_l, bvh_l = local_shard(scene_tp, bvh_tp, tp.index)
    eng = TiledEngine(scene_l, flags, bvh_l, cam, cfg, base_key)
    npix = cfg.width * cfg.height
    per = -(-npix // dp.size)
    off = dp.index * per
    pix = torch.arange(off, off + per, dtype=torch.int32, device=eng.device)
    block = _render_block(eng, tp, pix, spp)
    if tp.index:
        block = torch.zeros_like(block)   # one rank of each row contributes
    return assemble(block, mesh.world(), off, npix, cfg)
