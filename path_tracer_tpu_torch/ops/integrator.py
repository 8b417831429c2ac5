"""Megakernel integrator: every path traced bounce after bounce, K5.

Port of ``path_tracer_tpu/ops/integrator.py``: ``prim_front_face`` (:46),
``prim_medium_of`` (:61), ``_medium_sample`` (:72), ``bounce_body`` (:99),
``bounce_shade`` (:123), ``_init_state`` (:245), ``trace_ray`` (:253),
``render_sample`` (:288) and ``render`` (:335), over whole batches of
pixels.  The bounce is the wavefront's :func:`~.shade_tiled.bounce_shade_t`
with the same draws (fold base → sample → pixel → iters → stream), so the
two engines integrate the same (sample, pixel, bounce) set.

:func:`megakernel` is kernel K5 (``csrc/megakernel.cu``): one thread per
pixel runs ``trace_ray``'s whole loop for one sample — the per-ray BVH walk
(B10), the volume-exit walk for medium hits, and the bounce (B11, with the
SSS walk B6) — and adds its colour into the frame.  :func:`megakernel_plain`
is its plain-torch twin.

The differentiable engine: :func:`trace_ray_scan` is ``trace_ray``'s
fixed-trip form (every lane runs ``cfg.iters`` trips, finished lanes
frozen), plain torch under autograd.  ``render(differentiable=True)`` and
``render_sample(differentiable=True)`` render with K5 on the card (the twin
on the CPU) and differentiate through :mod:`.adjoint`: on the CPU autograd
of the twin's replay for every leaf, on the card kernel K6 for the colour
leaves.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import rng
from ..utils import vec
from ..utils.vec import rsqrt32
from . import adjoint, kernels
from .camera import get_ray
from .shade_tiled import (bounce_rng, bounce_shade_t, make_tables, med_table,
                          medium_sample_t)
from .traverse import _traverse_impl
from .types import (C_DEPTH_SUM, C_DONE, C_RAYS, C_STACK_OVF, C_TRAV_STEPS,
                    C_WALK_STEPS, N_COUNTERS, PathState, RenderConfig)

MEGA_STACK = 64   # per-thread stack capacity of K5 (csrc/megakernel.cu)

def prim_front_face(scene, ptype, pidx, origin, direction, time, t):
    """Front-face test for known hits: sign of rd · outward normal."""
    p = origin + t[:, None] * direction
    si = torch.clamp(pidx, 0, scene.sph_rad.shape[0] - 1).long()
    qi = torch.clamp(pidx, 0, scene.qd_n.shape[0] - 1).long()
    ti = torch.clamp(pidx, 0, scene.tr_n.shape[0] - 1).long()
    center = vec.lerp(scene.sph_c0[si], scene.sph_c1[si], time[:, None])
    n = torch.where((ptype == 0)[:, None], p - center,
                    torch.where((ptype == 1)[:, None], scene.qd_n[qi],
                                scene.tr_n[ti]))
    return vec.vdot(direction, n) < 0.0


def prim_medium_of(scene, ptype, pidx):
    """Constant-medium index of primitives (or -1)."""
    si = torch.clamp(pidx, 0, scene.sph_medium.shape[0] - 1).long()
    qi = torch.clamp(pidx, 0, scene.qd_medium.shape[0] - 1).long()
    ti = torch.clamp(pidx, 0, scene.tr_medium.shape[0] - 1).long()
    med = torch.where(ptype == 0, scene.sph_medium[si],
                      torch.where(ptype == 1, scene.qd_medium[qi],
                                  scene.tr_medium[ti]))
    return torch.where(ptype >= 0, med, -1)


def _medium_sample(scene, flags, cfg, st, t1, t2, medium_idx, region_ok, key):
    """Constant-medium free flight over [t1, t2] with draws ``uniform(key)``
    → (scatter_in_medium, t_scatter, albedo (N, 3))."""
    scatter_in, t_scatter, albedo = medium_sample_t(
        scene, flags, cfg, med_table(scene), *st.origin.unbind(-1),
        *st.direction.unbind(-1), t1, t2, medium_idx, region_ok,
        rng.uniform(key))
    return scatter_in, t_scatter, torch.stack(albedo, -1)


def bounce_shade(scene, flags, cam, cfg, tabs, st: PathState, found, ptype,
                 pidx, exit_found, t_exit, exit_is_medium, ray_key):
    """The traversal-free half of a bounce, keys ``fold_in(ray_key, iters)``
    (emission, medium free flight, scatter, Russian roulette) → (next
    state, SSS walk steps).  ``tabs`` are the :func:`make_tables` rows."""
    rngs = bounce_rng(rng.fold_in(ray_key, st.iters), flags.has_sss)
    out, aux = bounce_shade_t(scene, flags, cam, cfg, tabs, st, found, ptype,
                              pidx, exit_found, t_exit, exit_is_medium, rngs,
                              aux=True)
    return out, aux["walk_steps"]


def bounce_body(scene, flags, bvh, cam, cfg, tabs, st: PathState, ray_key):
    """One loop trip: closest-hit walk, volume-exit walk for medium hits,
    then :func:`bounce_shade` → (next state, traversal steps, walk steps).

    JAX walks the exit query on every lane of a medium scene but reads it
    only where the hit has a medium; walking only there is exact.
    """
    sd = cfg.stack_depth
    found, ptype, pidx, t_hit, steps = _traverse_impl(
        bvh, st.origin, st.direction, st.time, cfg.t_min, cfg.t_max, sd)
    if flags.has_medium:
        need = found & (prim_medium_of(scene, ptype, pidx) >= 0)
        exit_found, e_pt, e_pi, t_exit, e_steps = _traverse_impl(
            bvh, st.origin, st.direction, st.time, t_hit + 1e-4, cfg.t_max,
            sd, active=need)
        exit_is_medium = prim_medium_of(scene, e_pt, e_pi) >= 0
        steps += e_steps
    else:
        exit_found = torch.zeros_like(found)
        t_exit = torch.zeros_like(t_hit)
        exit_is_medium = torch.zeros_like(found)
    out, walk = bounce_shade(scene, flags, cam, cfg, tabs, st, found, ptype,
                             pidx, exit_found, t_exit, exit_is_medium, ray_key)
    return out, steps, walk


def _init_state(origin, direction, time) -> PathState:
    n = origin.shape[0]
    dev = origin.device
    d = direction.unbind(-1)
    ninv = rsqrt32(torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                               min=1e-16))
    return PathState(
        origin=origin, direction=torch.stack([c * ninv for c in d], -1),
        time=time, color=torch.zeros((n, 3), device=dev),
        throughput=torch.ones((n, 3), device=dev),
        depth=torch.zeros((n,), dtype=torch.int32, device=dev),
        iters=torch.zeros((n,), dtype=torch.int32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev))


def _trace(scene, flags, bvh, cam, cfg, origin, direction, time, ray_key):
    """``trace_ray``'s loop for a batch of rays → (final state, traversal
    steps, SSS walk steps).  Each trip runs only the lanes still looping."""
    st = _init_state(origin, direction, time)
    tabs = make_tables(scene)
    trav = walk = 0
    while True:
        idx = (st.alive & (st.iters < cfg.iters)).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        sub = PathState(*(x[idx] for x in st))
        nxt, steps, walk_steps = bounce_body(scene, flags, bvh, cam, cfg, tabs,
                                             sub, ray_key[idx])
        st = PathState(*(x.index_put((idx,), y) for x, y in zip(st, nxt)))
        trav += int(steps)
        walk += int(walk_steps)
    return st, trav, walk


def trace_ray(scene, flags, bvh, cam, cfg: RenderConfig, origin, direction,
              time, ray_key, full_state: bool = False):
    """Forward megakernel trace of N rays with keys ``ray_key`` (N, 2)."""
    out = _trace(scene, flags, bvh, cam, cfg, origin, direction, time,
                 ray_key)[0]
    return out if full_state else out.color


def trace_ray_scan(scene, flags, bvh, cam, cfg: RenderConfig, origin,
                   direction, time, ray_key, full_state: bool = False):
    """Differentiable trace: the same bounce body for ``cfg.iters`` trips
    on every lane, finished lanes frozen by their ``alive`` mask.  With the
    same keys it gives exactly :func:`trace_ray`'s radiance."""
    st = _init_state(origin, direction, time)
    tabs = make_tables(scene)
    for _ in range(cfg.iters):
        nxt = bounce_body(scene, flags, bvh, cam, cfg, tabs, st, ray_key)[0]
        keep = st.alive
        st = PathState(*(torch.where(keep.view(-1, *(1,) * (x.ndim - 1)), y, x)
                         for x, y in zip(st, nxt)))
    return st if full_state else st.color


def trace_sample(scene, flags, bvh, cam, cfg: RenderConfig, base_key,
                 sample_idx):
    """Sample ``sample_idx`` of every pixel by the twin (``render_sample``'s
    keys: base → sample → pixel, camera ray from ``fold_in(key_p, 7)``) →
    (final state, traversal steps, SSS walk steps); differentiable."""
    dev = scene.sph_c0.device
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int32, device=dev)
    key_p = rng.fold_in(rng.fold_in(base_key.to(dev), sample_idx), pix)
    origin, direction, time = get_ray(
        cam, (pix % cfg.width).float(), (pix // cfg.width).float(),
        rng.fold_in(key_p, 7))
    return _trace(scene, flags, bvh, cam, cfg, origin, direction, time, key_p)


# ---------------------------------------------------------------------------
# K5: one sample of every pixel.
# ---------------------------------------------------------------------------

@dataclass
class MegaState:
    """Outputs of one K5 launch per pixel, the frame and the counters."""

    color: torch.Tensor       # (npix, 3) f32 this sample's radiance
    iters: torch.Tensor       # (npix,) i32 loop trips
    depth: torch.Tensor       # (npix,) i32 scatter depth
    accum: torch.Tensor       # (npix, 3) f32 radiance sums
    depth_hist: torch.Tensor  # (max_depth+1,) i32 of clipped depth
    ctr: torch.Tensor         # (N_COUNTERS,) i64, indices C_* in ops/types


class MegaEngine:
    """Static parameters of megakernel launches over one frame; carries
    the fields of the kernels' argument block that K5 reads."""

    def __init__(self, scene, flags, bvh, cam, cfg: RenderConfig, base_key):
        self.scene, self.flags, self.bvh, self.cam, self.cfg = (
            scene, flags, bvh, cam, cfg)
        self.device = scene.sph_c0.device
        self.key = base_key.to(self.device)
        self.npix = self.R = self.items_total = cfg.width * cfg.height
        self.sd = min(cfg.stack_depth, bvh.max_stack)
        self.root = int(bvh.root)
        self.tabs = make_tables(scene)
        self.steps = self.ctrl_den = 0
        self.stride, self.multi = 1, False
        self.start_sample, self.n_samples = 0, 1

    def init_state(self, accum) -> MegaState:
        n, dev = self.npix, self.device
        return MegaState(
            color=torch.zeros((n, 3), device=dev),
            iters=torch.zeros((n,), dtype=torch.int32, device=dev),
            depth=torch.zeros((n,), dtype=torch.int32, device=dev),
            accum=accum.reshape(n, 3).to(dev, torch.float32).clone(),
            depth_hist=torch.zeros((self.cfg.max_depth + 1,),
                                   dtype=torch.int32, device=dev),
            ctr=torch.zeros((N_COUNTERS,), dtype=torch.int64, device=dev))


def megakernel_plain(eng: MegaEngine, ms: MegaState, sample_idx: int) -> None:
    """Plain twin of K5: trace sample ``sample_idx`` of every pixel
    (``render_sample``), add it to the frame and count it (in place)."""
    cfg = eng.cfg
    st, trav, walk = trace_sample(eng.scene, eng.flags, eng.bvh, eng.cam, cfg,
                                  eng.key, sample_idx)
    ms.color.copy_(st.color)
    ms.iters.copy_(st.iters)
    ms.depth.copy_(st.depth)
    ms.accum.copy_(ms.accum + st.color)
    clip_d = torch.clamp(st.depth, 0, cfg.max_depth)
    ms.depth_hist.add_(torch.bincount(clip_d.long(),
                                      minlength=cfg.max_depth + 1)
                       .to(torch.int32))
    ms.ctr[C_DONE] += eng.npix
    ms.ctr[C_RAYS] += st.iters.sum()
    ms.ctr[C_DEPTH_SUM] += clip_d.sum()
    ms.ctr[C_TRAV_STEPS] += trav
    ms.ctr[C_WALK_STEPS] += walk


def megakernel(eng: MegaEngine, ms: MegaState, sample_idx: int) -> None:
    """K5 wrapper: CUDA kernel for CUDA state, plain twin for CPU state."""
    if not ms.ctr.is_cuda:
        return megakernel_plain(eng, ms, sample_idx)
    if eng.sd > MEGA_STACK:
        raise ValueError(f"stack depth {eng.sd} exceeds the megakernel's "
                         f"per-thread stack of {MEGA_STACK}")
    cache = getattr(ms, "_kernel_args", None)
    if cache is None or cache[0] is not eng:
        cache = (eng, kernels.make_args(eng, ms))
        ms._kernel_args = cache
    cache[1].start_sample = int(sample_idx)
    kernels.launch("megakernel", eng, ms, cache[1])


def _stats(ms: MegaState) -> dict:
    ctr = ms.ctr
    return {"rays": ctr[C_RAYS], "depth_sum": ctr[C_DEPTH_SUM],
            "depth_hist": ms.depth_hist, "paths": ctr[C_DONE],
            "walk_steps": ctr[C_WALK_STEPS], "trav_steps": ctr[C_TRAV_STEPS],
            "stack_overflows": ctr[C_STACK_OVF]}


def render_batch(scene, flags, bvh, cam, cfg: RenderConfig, accum,
                 start_sample: int, n_samples: int, base_key,
                 with_stats: bool = False, plain: bool = False):
    """Add samples ``start_sample ..`` ``+ n_samples`` to a copy of ``accum``
    (H, W, 3), one K5 launch per sample, in sample order (the JAX
    renderer's ``_mega_batch``).  ``plain=True`` runs the twin on whatever
    device the tensors are on.  Stats: ``rays``, ``depth_sum`` and
    ``depth_hist`` (of clipped depth) as JAX's, plus ``paths``,
    ``walk_steps``, ``trav_steps`` and ``stack_overflows``."""
    eng = MegaEngine(scene, flags, bvh, cam, cfg, base_key)
    ms = eng.init_state(accum)
    op = megakernel_plain if plain else megakernel
    for s in range(int(start_sample), int(start_sample) + int(n_samples)):
        op(eng, ms, s)
    image = ms.accum.reshape(cfg.height, cfg.width, 3)
    return (image, _stats(ms)) if with_stats else image


def _render_samples(scene, flags, bvh, cam, cfg, start, n, base_key,
                    differentiable, with_stats=False):
    """Sum of samples ``start ..`` ``+ n`` → (H, W, 3) (and stats); with
    ``differentiable`` through :func:`.adjoint.render_diff`."""
    def forward(sc):
        zero = torch.zeros((cfg.height, cfg.width, 3), device=sc.sph_c0.device)
        return render_batch(sc, flags, bvh, cam, cfg, zero, start, n,
                            base_key, with_stats=True)

    if not differentiable:
        image, stats = forward(scene)
    else:
        image, stats = adjoint.render_diff(scene, flags, bvh, cam, cfg,
                                           base_key, range(start, start + n),
                                           forward)
    return (image, stats) if with_stats else image


def render_sample(scene, flags, bvh, cam, cfg: RenderConfig, sample_idx,
                  base_key, differentiable: bool = False,
                  with_stats: bool = False):
    """Trace one sample for every pixel → (H, W, 3) radiance (and stats)."""
    return _render_samples(scene, flags, bvh, cam, cfg, int(sample_idx), 1,
                           base_key, differentiable, with_stats)


def render(scene, flags, bvh, cam, cfg: RenderConfig, base_key,
           differentiable: bool = False, spp: int | None = None):
    """Accumulate ``spp`` samples → (H, W, 3) mean radiance."""
    spp = spp if spp is not None else cfg.samples_per_pixel
    return _render_samples(scene, flags, bvh, cam, cfg, 0, spp, base_key,
                           differentiable) / spp
