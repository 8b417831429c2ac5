"""Wavefront engine: slot pool with path regeneration, suspended traversal,
volume-exit phase and in-slot multi-sample windows.

Port of ``render_batch`` (``path_tracer_tpu/ops/wavefront.py:485``) and the
wave machine of ``_make_engine`` (:135-467).  One wave is four kernels:

1. K1 ``trace_step`` (:mod:`.traverse`) — advance every suspended walk by
   up to ``steps_per_wave`` steps; evaluate the control predicate
   (:451-462) into the device flag ``do_ctrl``.
2. K3 ``shade`` (:mod:`.shade_tiled`) — volume phase transition, bounce,
   restart of continuing paths.
3. K4 :func:`retire` — counters, depth histogram, retire-or-resample,
   ``atomicAdd`` of finished radiance into the frame.
4. K2 :func:`spawn` — hand the next (pixel, sample-window) work items to
   empty slots and start their camera rays.

K3, K4 and K2 return at once when ``do_ctrl`` is 0.  The wave loop itself
(B8) is a host loop that reads the counters back once every
``CHECK_EVERY`` waves, through pinned memory; nothing per wave crosses to
the host.  On CPU tensors every kernel wrapper runs its plain-torch twin.

:func:`render_batch_diff` is the differentiable wavefront: the forward is
:func:`render_batch` (K1-K4 on the card), the backward replays each
(sample, pixel) path through :mod:`.adjoint` (K6 on the card), so no wave
state is stored.

Slot↔item assignment and per-pixel float add order depend on the schedule
(atomics on the card, a prefix-sum rank in the twin); the integrated
(sample, pixel) set does not — it is fixed by the RNG folds — so ``paths``
and ``spawned`` always match the JAX engine, and ``rays`` and
``depth_hist`` match wherever both round alike (ROADMAP.md C: XLA's CPU
backend fuses multiply-adds, which can flip a near-``t_min`` self-hit).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import torch

from . import adjoint, kernels
from .shade_tiled import make_tables, shade, shade_plain, spawn_paths
from .traverse import _DONE, trace_step, trace_step_plain, traversal_init_batched
from .types import (C_CTRLS, C_DEPTH_SUM, C_DO_CTRL, C_DONE, C_EXEC_STEPS,
                    C_N_OCC, C_OCC_SUM, C_RAYS, C_SPAWNED, C_STACK_OVF,
                    C_TRAV_STEPS, C_WALK_STEPS, C_WAVES, FL_FINISHED,
                    FL_NONE, FL_RESAMPLE, N_COUNTERS, PH_MAIN, RenderConfig)


@dataclass
class WaveState:
    """Per-slot SoA state of the pool plus the frame and device counters."""

    origin: torch.Tensor      # (R, 3) f32
    direction: torch.Tensor   # (R, 3) f32
    time: torch.Tensor        # (R,) f32
    color: torch.Tensor       # (R, 3) f32 radiance (window sum)
    throughput: torch.Tensor  # (R, 3) f32
    depth: torch.Tensor       # (R,) i32
    iters: torch.Tensor       # (R,) i32
    alive: torch.Tensor       # (R,) bool
    cur: torch.Tensor         # (R,) i32 traversal node pointer
    stack: torch.Tensor       # (R, SD) i32
    sp: torch.Tensor          # (R,) i32
    best_t: torch.Tensor      # (R,) f32
    best_pt: torch.Tensor     # (R,) i32
    best_pi: torch.Tensor     # (R,) i32
    phase: torch.Tensor       # (R,) i32 PH_*
    hit_found: torch.Tensor   # (R,) bool saved MAIN result during PH_EXIT
    hit_pt: torch.Tensor      # (R,) i32
    hit_pi: torch.Tensor      # (R,) i32
    hit_t: torch.Tensor       # (R,) f32
    pixel: torch.Tensor       # (R,) i32 local pixel index
    sample: torch.Tensor      # (R,) i32
    last: torch.Tensor        # (R,) i32 last sample of the slot's window
    occupied: torch.Tensor    # (R,) bool
    flag: torch.Tensor        # (R,) i32 FL_* hand-off between kernels
    accum: torch.Tensor       # (npix, 3) f32 radiance sums
    pix_paths: torch.Tensor   # (npix,) i32 finished paths per pixel
    depth_hist: torch.Tensor  # (max_depth+1,) i32
    ctr: torch.Tensor         # (N_COUNTERS,) i64, indices C_* in ops/types

    def clone(self) -> "WaveState":
        return WaveState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})


class WaveEngine:
    """Static parameters of one ``render_batch`` call (the JAX engine's
    closure): tables, sizes, the work-item rule and the tuning knobs."""

    def __init__(self, scene, flags, bvh, cam, cfg: RenderConfig,
                 start_sample: int, n_samples: int, base_key,
                 queue_size: int, steps_per_wave: int, ctrl_den: int,
                 sample_stride: int | None = None):
        self.scene, self.flags, self.bvh, self.cam, self.cfg = (
            scene, flags, bvh, cam, cfg)
        self.device = scene.sph_c0.device
        self.key = base_key.to(self.device)
        self.npix = cfg.width * cfg.height
        self.total = n_samples * self.npix
        self.R = min(queue_size, self.total)
        if sample_stride is not None:
            self.stride = max(1, min(n_samples, sample_stride))
        else:
            self.stride = min(n_samples, 4) if self.npix >= 8 * self.R else 1
        self.multi = self.stride > 1
        n_windows = -(-n_samples // self.stride)
        self.items_total = self.npix * n_windows if self.multi else self.total
        self.start_sample = int(start_sample)
        self.n_samples = int(n_samples)
        self.steps = int(steps_per_wave)
        self.ctrl_den = int(ctrl_den)
        self.sd = min(cfg.stack_depth, bvh.max_stack)
        self.root = int(bvh.root)
        self.tabs = make_tables(scene)

    def init_state(self, accum) -> WaveState:
        R, dev, cfg = self.R, self.device, self.cfg
        zi = torch.zeros((R,), dtype=torch.int32, device=dev)
        zf = torch.zeros((R,), dtype=torch.float32, device=dev)
        zb = torch.zeros((R,), dtype=torch.bool, device=dev)
        direction = torch.zeros((R, 3), device=dev)
        direction[:, 2] = 1.0
        return WaveState(
            origin=torch.zeros((R, 3), device=dev), direction=direction,
            time=zf.clone(), color=torch.zeros((R, 3), device=dev),
            throughput=torch.ones((R, 3), device=dev), depth=zi.clone(),
            iters=zi.clone(), alive=zb.clone(),
            cur=torch.full((R,), _DONE, dtype=torch.int32, device=dev),
            stack=torch.zeros((R, self.sd), dtype=torch.int32, device=dev),
            sp=zi.clone(),
            best_t=torch.full((R,), cfg.t_max, dtype=torch.float32, device=dev),
            best_pt=zi - 1, best_pi=zi - 1, phase=zi.clone(),
            hit_found=zb.clone(), hit_pt=zi - 1, hit_pi=zi - 1,
            hit_t=zf.clone(), pixel=zi.clone(), sample=zi.clone(),
            last=zi.clone(), occupied=zb.clone(), flag=zi.clone(),
            accum=accum.reshape(self.npix, 3).to(dev, torch.float32).clone(),
            pix_paths=torch.zeros((self.npix,), dtype=torch.int32, device=dev),
            depth_hist=torch.zeros((cfg.max_depth + 1,), dtype=torch.int32,
                                   device=dev),
            ctr=torch.zeros((N_COUNTERS,), dtype=torch.int64, device=dev))

    def live(self, ctr_host) -> bool:
        """The B8 loop predicate from a host copy of the counters."""
        spawned = min(int(ctr_host[C_SPAWNED]), self.items_total)
        return spawned < self.items_total or int(ctr_host[C_N_OCC]) > 0


# ---------------------------------------------------------------------------
# K4: retire.
# ---------------------------------------------------------------------------

def retire_plain(eng: WaveEngine, ws: WaveState) -> None:
    """Plain twin of K4 (``ops/wavefront.py:337-424``, in place).

    For slots that ``shade`` marked finished: count the path (``done``,
    ``rays``, ``depth_sum``, depth histogram, per-pixel path count); a path
    whose window still has samples resamples in place (``FL_RESAMPLE``),
    any other adds its radiance to the frame and frees the slot.
    """
    if int(ws.ctr[C_DO_CTRL]) == 0:
        return
    fin = ws.flag == FL_FINISHED
    if eng.multi:
        resample = fin & (ws.sample < ws.last)
    else:
        resample = torch.zeros_like(fin)
    retire_m = fin & ~resample
    px = ws.pixel.long()
    ws.accum.index_add_(0, px[retire_m], ws.color[retire_m])
    ws.pix_paths.index_add_(0, px[fin], torch.ones_like(ws.pixel[fin]))
    ctr = ws.ctr
    ctr[C_DONE] += fin.sum()
    ctr[C_RAYS] += ws.iters[fin].sum()
    ctr[C_DEPTH_SUM] += ws.depth[fin].sum()
    clip_d = torch.clamp(ws.depth[fin], 0, eng.cfg.max_depth).long()
    ws.depth_hist.add_(torch.bincount(clip_d, minlength=eng.cfg.max_depth + 1)
                       .to(torch.int32))
    ws.occupied &= ~retire_m
    ctr[C_N_OCC] -= retire_m.sum()
    ws.flag.copy_(torch.where(resample, FL_RESAMPLE,
                              torch.where(fin, FL_NONE, ws.flag)))


def retire(eng: WaveEngine, ws: WaveState) -> None:
    """K4 wrapper: CUDA kernel for CUDA state, plain twin for CPU state."""
    if not ws.cur.is_cuda:
        return retire_plain(eng, ws)
    kernels.launch("retire", eng, ws)


# ---------------------------------------------------------------------------
# K2: spawn.
# ---------------------------------------------------------------------------

def spawn_plain(eng: WaveEngine, ws: WaveState) -> None:
    """Plain twin of K2 (``ops/wavefront.py:216-266``, in place).

    Empty slots take the next work items in prefix-sum rank order; a work
    item is a (pixel, sample window) with ``stride`` samples, or one
    (pixel, sample) when ``stride`` is 1.  ``FL_RESAMPLE`` slots start the
    next sample of their window in place, carrying the radiance sum.
    """
    if int(ws.ctr[C_DO_CTRL]) == 0:
        return
    W = torch.where
    empty = ~ws.occupied
    resample = ws.flag == FL_RESAMPLE
    spawned = min(int(ws.ctr[C_SPAWNED]), eng.items_total)
    rank = torch.cumsum(empty.to(torch.int64), 0) - 1
    new_id = spawned + rank
    can = empty & (new_id < eng.items_total)
    npix = eng.npix
    if eng.multi:
        g = new_id // npix
        s_idx = eng.start_sample + g * eng.stride
        new_last = eng.start_sample + torch.clamp(
            (g + 1) * eng.stride, max=eng.n_samples) - 1
    else:
        s_idx = eng.start_sample + new_id // npix
        new_last = s_idx
    pix = W(can, new_id % npix, ws.pixel.long()).to(torch.int32)
    smp = W(can, s_idx, W(resample, ws.sample + 1, ws.sample).long()).to(
        torch.int32)
    renew = can | resample
    fresh = spawn_paths(eng.cam, eng.cfg, eng.key, smp, pix)
    fresh = fresh._replace(color=W(resample[:, None], ws.color, fresh.color))
    for name, v in zip(fresh._fields, fresh):
        cur = getattr(ws, name)
        cur.copy_(W(renew[:, None] if cur.ndim == 2 else renew, v, cur))
    trv = traversal_init_batched(eng.bvh, fresh.origin, fresh.direction,
                                 fresh.time, eng.cfg.t_min, eng.cfg.t_max,
                                 eng.sd)
    for name, v in zip(("cur", "stack", "sp", "best_t", "best_pt", "best_pi"),
                       trv):
        cur = getattr(ws, name)
        cur.copy_(W(renew[:, None] if cur.ndim == 2 else renew, v, cur))
    ws.phase.copy_(W(renew, PH_MAIN, ws.phase))
    ws.pixel.copy_(pix)
    ws.sample.copy_(smp)
    ws.last.copy_(W(can, new_last, ws.last.long()).to(torch.int32))
    ws.occupied |= can
    ws.flag.copy_(W(renew, FL_NONE, ws.flag))
    ws.ctr[C_N_OCC] += can.sum()
    ws.ctr[C_SPAWNED] = spawned + int(empty.sum())


def spawn(eng: WaveEngine, ws: WaveState) -> None:
    """K2 wrapper: CUDA kernel for CUDA state, plain twin for CPU state."""
    if not ws.cur.is_cuda:
        return spawn_plain(eng, ws)
    kernels.launch("spawn", eng, ws)


# ---------------------------------------------------------------------------
# The wave loop (B8) and render_batch.
# ---------------------------------------------------------------------------

KERNELS = (trace_step, shade, retire, spawn)
PLAIN = (trace_step_plain, shade_plain, retire_plain, spawn_plain)
CHECK_EVERY = 8          # waves between host reads of the counters
MAX_WAVES = 1_000_000    # a frame that has not drained by then is a bug


def run_waves(eng: WaveEngine, ws: WaveState, plain: bool = False) -> int:
    """Run waves until no work is left; returns the number of host reads.

    On the card the counters are copied to pinned memory every
    ``CHECK_EVERY`` waves and the copy is read one period later, so the host
    never waits on the wave it just queued.  Waves queued after the work ran
    out are no-ops (``trace_step`` leaves ``do_ctrl`` at 0 and counts no
    wave).
    """
    ops = PLAIN if plain else KERNELS
    on_card = ws.ctr.is_cuda
    if on_card:
        pinned = [torch.empty_like(ws.ctr, device="cpu").pin_memory()
                  for _ in range(2)]
        events = [None, None]
    reads = 0
    for wave in range(1, MAX_WAVES + 1):
        for op in ops:
            op(eng, ws)
        if not on_card:
            if not eng.live(ws.ctr):
                return reads
            continue
        if wave % CHECK_EVERY:
            continue
        slot = (wave // CHECK_EVERY) % 2
        prev = events[1 - slot]
        if prev is not None:
            prev.synchronize()
            reads += 1
            if not eng.live(pinned[1 - slot]):
                return reads
        pinned[slot].copy_(ws.ctr, non_blocking=True)
        events[slot] = torch.cuda.Event()
        events[slot].record()
    raise RuntimeError(f"wavefront did not drain within {MAX_WAVES} waves")


def _stats(ws: WaveState, eng: WaveEngine) -> dict:
    ctr = ws.ctr
    return {"paths": ctr[C_DONE], "rays": ctr[C_RAYS],
            "depth_sum": ctr[C_DEPTH_SUM], "waves": ctr[C_WAVES],
            "ctrls": ctr[C_CTRLS], "occ_sum": ctr[C_OCC_SUM],
            "trav_steps": ctr[C_TRAV_STEPS], "exec_steps": ctr[C_EXEC_STEPS],
            "walk_steps": ctr[C_WALK_STEPS],
            "depth_hist": ws.depth_hist, "slots": eng.R,
            "spawned": torch.clamp(ctr[C_SPAWNED], max=eng.items_total),
            "total": eng.total, "pixel_paths": ws.pix_paths,
            "stack_overflows": ctr[C_STACK_OVF]}


def render_batch(scene, flags, bvh, cam, cfg: RenderConfig, accum,
                 start_sample, n_samples: int, base_key,
                 queue_size: int = 4096, steps_per_wave: int = 12,
                 with_stats: bool = False, ctrl_den: int = 8,
                 sample_stride: int | None = None, plain: bool = False):
    """Accumulate ``n_samples`` samples into a copy of ``accum`` (H, W, 3).

    Same arguments and result as the JAX ``render_batch``; ``base_key`` is
    the (2,) key of :mod:`..utils.rng`.  ``plain=True`` runs the plain-torch
    twins on whatever device the tensors are on (the comparison path); the
    default runs the CUDA kernels for CUDA tensors.  With ``with_stats`` the
    stats dict adds ``pixel_paths`` (finished paths per pixel),
    ``stack_overflows`` (must be 0) and ``host_reads``.
    """
    eng = WaveEngine(scene, flags, bvh, cam, cfg, start_sample, n_samples,
                     base_key, queue_size, steps_per_wave, ctrl_den,
                     sample_stride)
    ws = eng.init_state(accum)
    reads = run_waves(eng, ws, plain=plain)
    image = ws.accum.reshape(cfg.height, cfg.width, 3)
    if with_stats:
        return image, dict(_stats(ws, eng), host_reads=reads)
    return image


def render_batch_diff(scene, flags, bvh, cam, cfg: RenderConfig, accum,
                      start_sample, n_samples: int, base_key,
                      queue_size: int = 4096, steps_per_wave: int = 12,
                      n_waves: int = 256, ctrl_den: int = 8,
                      ckpt_every: int = 1, save_trav: bool = True,
                      sample_stride: int | None = None):
    """Differentiable wavefront → ``(accum + image, stats)``, the arguments
    and result of the JAX ``render_batch_diff``; ``stats`` is
    :func:`render_batch`'s, with ``paths == total`` for a whole image.

    The forward is :func:`render_batch`; gradients with respect to the
    scene's floating fields that require grad come from replaying every
    (sample, pixel) path (:mod:`.adjoint`): on the card K6, for the colour
    leaves only (any other leaf raises ``NotImplementedError``), on the CPU
    autograd of the megakernel twin, for every leaf.  Both integrate the
    wavefront's sample set, which the RNG folds fix.

    ``n_waves`` keeps its JAX contract, the trip budget of the forward: a
    forward that needs more waves raises (size it with
    ``parallel.render_dist.calibrate_n_waves``) instead of returning a
    partial image.  ``ckpt_every`` and ``save_trav`` choose XLA's
    rematerialisation of the scanned waves; the replay stores no wave
    state, so they have no counterpart here and a value other than the
    default warns.  ``sample_stride`` is :func:`render_batch`'s knob; the
    gradient does not depend on it.
    """
    if ckpt_every != 1 or not save_trav:
        warnings.warn("render_batch_diff: ckpt_every and save_trav are XLA "
                      "rematerialisation knobs with no counterpart in the "
                      "port (the backward replays paths); ignored",
                      stacklevel=2)
    start, n = int(start_sample), int(n_samples)

    def forward(sc):
        zero = torch.zeros((cfg.height, cfg.width, 3), device=sc.sph_c0.device)
        image, stats = render_batch(sc, flags, bvh, cam, cfg, zero, start, n,
                                    base_key, queue_size=queue_size,
                                    steps_per_wave=steps_per_wave,
                                    with_stats=True, ctrl_den=ctrl_den,
                                    sample_stride=sample_stride)
        if int(stats["waves"]) > n_waves:
            raise RuntimeError(
                f"the forward took {int(stats['waves'])} waves, more than "
                f"n_waves={n_waves}; size n_waves with "
                f"parallel.render_dist.calibrate_n_waves")
        return image, stats

    image, stats = adjoint.render_diff(scene, flags, bvh, cam, cfg, base_key,
                                       range(start, start + n), forward)
    return accum.to(image.device) + image, stats
