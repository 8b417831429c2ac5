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

K3, K4 and K2 return at once when ``do_ctrl`` is 0.  On the card the wave
loop (B8', JAX's ``lax.while_loop(live, wave)``) runs on the device: one
CUDA graph per configuration, replayed per batch, which resets the wave
state and then runs a conditional WHILE node that repeats a wave until K1
finds no work left and clears the node's condition (``csrc/wave_loop.cu``,
:class:`WaveLoop`, kept by :func:`wave_loop`); the host launches it once a
batch and reads the counters and the depth histogram once.
:func:`run_waves` is the same loop driven from the host, a wave's launches
at a time, testing ``live`` after each (the loop of the plain-torch twins,
and the reference the device loop is held to on the card).  On CPU tensors
every kernel wrapper runs its plain-torch twin.

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

import ctypes
import dataclasses
import warnings
import weakref
from dataclasses import dataclass

import torch

from ..utils.spans import span
from . import adjoint, kernels
from .shade_tiled import make_tables, shade, shade_plain, spawn_paths
from .traverse import (_DONE, _unroll, trace_step, trace_step_plain,
                       traversal_init_batched)
from .types import (C_DEPTH_SUM, C_DO_CTRL, C_DONE, C_N_OCC, C_RAYS,
                    C_SPAWNED, C_WAVES, FL_FINISHED, FL_NONE, FL_RESAMPLE,
                    N_COUNTERS, PH_MAIN, RenderConfig, counter_stats)


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
    pixel: torch.Tensor       # (R,) i32 frame pixel index
    sample: torch.Tensor      # (R,) i32
    last: torch.Tensor        # (R,) i32 last sample of the slot's window
    occupied: torch.Tensor    # (R,) bool
    flag: torch.Tensor        # (R,) i32 FL_* hand-off between kernels
    accum: torch.Tensor       # (npix, 3) f32 radiance sums of the block
    pix_paths: torch.Tensor   # (npix,) i32 finished paths per block pixel
    depth_hist: torch.Tensor  # (max_depth+1,) i32
    ctr: torch.Tensor         # (N_COUNTERS,) i64, indices C_* in ops/types

    def clone(self) -> "WaveState":
        return WaveState(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})


class WaveEngine:
    """Static parameters of one ``render_batch`` call (the JAX engine's
    closure): tables, sizes, the work-item rule and the tuning knobs.  The
    pool renders the ``npix`` frame pixels from ``pix_offset`` (the whole
    frame by default; a data-parallel shard's block otherwise)."""

    def __init__(self, scene, flags, bvh, cam, cfg: RenderConfig,
                 start_sample: int, n_samples: int, base_key,
                 queue_size: int, steps_per_wave: int, ctrl_den: int,
                 sample_stride: int | None = None, pix_offset: int = 0,
                 n_pix: int | None = None, chunk: int | None = None,
                 spawn_order=None):
        self.scene, self.flags, self.bvh, self.cam, self.cfg = (
            scene, flags, bvh, cam, cfg)
        self.device = scene.sph_c0.device
        (self.chunk, self.npix, self.total, self.R, self.stride,
         self.items_total) = self.pool(cfg, self.device, n_samples,
                                       queue_size, sample_stride, n_pix,
                                       chunk)
        self.multi = self.stride > 1
        self.key = base_key.to(self.device)
        self.pix_offset = int(pix_offset)
        self.start_sample = int(start_sample)
        self.n_samples = int(n_samples)
        self.steps = int(steps_per_wave)
        self.ctrl_den = int(ctrl_den)
        self.sd = min(cfg.stack_depth, bvh.max_stack)
        self.root = int(bvh.root)
        self.tabs = make_tables(scene)
        # The block pixel a work item spawns (tile_spawn_order; None: its own)
        self.spawn_order = None
        if spawn_order is not None:
            order = torch.as_tensor(spawn_order).to(self.device, torch.int32)
            if tuple(order.shape) != (self.npix,):
                raise ValueError(f"spawn_order must have one entry per block "
                                 f"pixel ({self.npix},), not "
                                 f"{tuple(order.shape)}")
            if int(order.min()) < 0 or int(order.max()) >= self.npix:
                raise ValueError(f"spawn_order holds block pixels, in "
                                 f"[0, {self.npix})")
            self.spawn_order = order.contiguous()

    @staticmethod
    def pool(cfg: RenderConfig, device, n_samples: int, queue_size: int,
             sample_stride: int | None = None, n_pix: int | None = None,
             chunk: int | None = None) -> tuple:
        """The pool's sizes, from host values alone: ``(chunk, npix, total,
        R, stride, items_total)``.  ``chunk`` is the steps per chunk of the
        adaptive wave exit (JAX's ``_unroll()``)."""
        chunk = int(chunk) if chunk else _unroll(device)
        npix = int(n_pix) if n_pix is not None else cfg.width * cfg.height
        total = n_samples * npix
        R = min(queue_size, total)
        if sample_stride is not None:
            stride = max(1, min(n_samples, sample_stride))
        else:
            stride = min(n_samples, 4) if npix >= 8 * R else 1
        items_total = npix * -(-n_samples // stride) if stride > 1 else total
        return chunk, npix, total, R, stride, items_total

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


def tile_spawn_order(width: int, height: int, tile: int = 16,
                     device="cuda") -> torch.Tensor:
    """The ``(width * height,)`` int32 spawn order of JAX's
    ``tile_spawn_order`` (``ops/wavefront.py:115-127``): consecutive work
    items fill one ``tile`` x ``tile`` pixel block before the next, so the
    slots a control wave renews trace neighbouring pixels.  Pass it as
    ``render_batch(..., spawn_order=)``."""
    ys, xs = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    # np.lexsort's last key is the primary one: tile row, tile column, then
    # the row and column within the tile.
    key = (((ys // tile) * (-(-width // tile)) + xs // tile) * tile
           + ys % tile) * tile + xs % tile
    order = torch.argsort(key, stable=True)
    return (ys[order] * width + xs[order]).to(device, torch.int32)


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
    px = (ws.pixel - eng.pix_offset).long()      # index in the pixel block
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
    next sample of their window in place, carrying the radiance sum.  A
    slot holds its frame pixel (``pix_offset`` + its block index); with a
    spawn order, item ``id``'s block index is ``spawn_order[id % npix]``.
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
    local = new_id % npix
    if eng.spawn_order is not None:
        local = eng.spawn_order.long()[local]
    pix = W(can, local + eng.pix_offset, ws.pixel.long()).to(torch.int32)
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
WAVE_NAMES = ("trace_step", "shade", "retire", "spawn")   # one wave, in order
PLAIN = (trace_step_plain, shade_plain, retire_plain, spawn_plain)
MAX_WAVES = 1_000_000    # a frame that has not drained by then is a bug


def run_waves(eng: WaveEngine, ws: WaveState, plain: bool = False) -> int:
    """Run waves from the host, one wave's launches at a time, until no work
    is left (``eng.live`` of the counters after each wave); returns the
    host reads of device counters: one a wave on the card, none on the
    CPU.  ``plain`` runs the plain-torch twins (:data:`PLAIN`), else
    :data:`KERNELS`."""
    ops = PLAIN if plain else KERNELS
    for wave in range(1, MAX_WAVES + 1):
        for op in ops:
            op(eng, ws)
        if not eng.live(ws.ctr.cpu()):
            return wave if ws.ctr.is_cuda else 0
    raise RuntimeError(f"wavefront did not drain within {MAX_WAVES} waves")


def _wave_loop_lib():
    lib = kernels.library("wave_loop")
    if not hasattr(lib, "_typed"):
        P = ctypes.c_void_p
        lib.ptt_wave_loop_begin.argtypes = [
            ctypes.POINTER(P), ctypes.POINTER(kernels.WaveArgs),
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(P)]
        lib.ptt_wave_loop_end.argtypes = [P]
        lib.ptt_wave_loop_launch.argtypes = [P, P]
        lib.ptt_wave_loop_free.argtypes = [P]
        for f in ("begin", "end", "launch", "free"):
            getattr(lib, f"ptt_wave_loop_{f}").restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"the device wave loop: {what} failed with CUDA "
                           f"error {err}")


class WaveLoop:
    """The device wave loop of one configuration (B8',
    ``csrc/wave_loop.cu``): one CUDA graph, ``wave_reset`` and then a
    conditional WHILE node whose body is one wave (K1, K3, K4, K2),
    captured once over a wave state ``ws`` it keeps and replayed for every
    batch.

    The capture fixes the whole argument block but the batch's first
    sample, which K2 reads from :attr:`sample` (``WaveArgs.sample_dev``):
    the engine's tables, the scene, BVH, key and camera, the sizes and the
    state's pointers.  Each launch resets the state to
    :meth:`WaveEngine.init_state`'s values (slots, counters, depth
    histogram, per-pixel path counts; ``wave_reset``) and runs waves until
    K1 finds no work left (``live``) or the frame reaches ``MAX_WAVES``;
    :meth:`load` puts a batch's frame and first sample in before it.
    ``key`` is :func:`loop_key`'s (:func:`wave_loop` builds and keeps the
    loop); ``traced`` whether ``torch.profiler`` had recorded in this
    process before the capture (:func:`wave_loop` recaptures a loop that
    was not when a profiler records).  The capture is timed by the span
    ``wavefront.graph_build`` (arguments, capture, instantiation),
    :meth:`free` by ``wavefront.graph_free``.  A failed build or capture
    raises.
    """

    def __init__(self, eng: WaveEngine, ws: WaveState, key: tuple):
        global CAPTURES
        self.eng, self.ws, self.key = eng, ws, key
        self.traced = _PROFILED
        dev = ws.ctr.device
        lib = _wave_loop_lib()
        self._loop = ctypes.c_void_p()
        self._free = weakref.finalize(self, lib.ptt_wave_loop_free,
                                      self._loop)
        self.sample = torch.full((1,), eng.start_sample, dtype=torch.int32,
                                 device=dev)
        h_while, stream = ctypes.c_ulonglong(), ctypes.c_void_p()
        try:
            with span("wavefront.graph_build"):
                args = kernels.make_args(eng, ws)
                args.sample_dev, args._keep_sample = (
                    kernels._ptr(self.sample), self.sample)
                args.max_waves = MAX_WAVES
                _check(lib.ptt_wave_loop_begin(ctypes.byref(self._loop),
                                               ctypes.byref(args),
                                               ctypes.byref(h_while),
                                               ctypes.byref(stream)),
                       "building the graph")
                args.h_while, args.loop_graph = h_while.value, 1
                with kernels.captured_launches() as per_wave:
                    for name in WAVE_NAMES:
                        kernels.launch_args(name, args, dev,
                                            stream=stream.value)
                _check(lib.ptt_wave_loop_end(self._loop),
                       "capturing the wave")
        except BaseException:
            self.free()
            raise
        self.args, self.per_wave = args, dict(per_wave)
        CAPTURES += 1

    def load(self, accum, start_sample) -> None:
        """Copy a batch's frame ``accum`` into the state and write its first
        sample where K2 reads it."""
        self.eng.start_sample = int(start_sample)
        self.sample.fill_(self.eng.start_sample)
        self.ws.accum.copy_(accum.reshape(self.eng.npix, 3))

    def run(self) -> tuple:
        """Launch the graph on the current stream and copy the counters and
        the depth histogram to the host, one copy each (span
        ``wavefront.wait``: the launch and the copies, the first of which
        waits for the loop to drain) → ``(ctr, depth_hist)`` on the host.
        Counts the launches from that copy: ``wave_reset`` once, each wave
        kernel ``waves + 1`` (the last wave's K1 finds no work and K3, K4
        and K2 after it return at once), ``wave_loop`` none, as the loop
        has no kernel of its own.  Raises for a frame that has not drained
        within ``MAX_WAVES``."""
        dev = self.ws.ctr.device
        with span("wavefront.wait"):
            _check(_wave_loop_lib().ptt_wave_loop_launch(
                self._loop,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
                "launching the graph")
            host = self.ws.ctr.cpu()             # the one host read
            hist = self.ws.depth_hist.cpu()
        kernels.count({"wave_reset": 1})
        kernels.count(self.per_wave, int(host[C_WAVES]) + 1)
        if self.eng.live(host):
            raise RuntimeError(f"wavefront did not drain within {MAX_WAVES} "
                               f"waves")
        return host, hist

    def free(self) -> None:
        """Destroy the graph and its stream (once; span
        ``wavefront.graph_free``)."""
        if self._free.alive:
            with span("wavefront.graph_free"):
                self._free()


class _Same:
    """An entry of :func:`loop_key` for an object the capture reads through
    a pointer: equal to the same object only, and for a tensor at the same
    ``_version``, which every in-place write advances; comparing reads no
    device memory.  It holds the object, so its ``id`` is not reused while
    a key lives."""

    __slots__ = ("obj", "version")

    def __init__(self, obj):
        self.obj = obj
        self.version = obj._version if isinstance(obj, torch.Tensor) else None

    def __eq__(self, other):
        return (isinstance(other, _Same) and other.obj is self.obj
                and other.version == self.version)

    def __hash__(self):
        return id(self.obj)


def _tensor_fields(obj) -> tuple:
    return tuple(_Same(v) for v in vars(obj).values()
                 if isinstance(v, torch.Tensor))


def loop_key(scene, flags, bvh, cam, cfg: RenderConfig, n_samples: int,
             base_key, queue_size: int, steps_per_wave: int, ctrl_den: int,
             sample_stride: int | None = None, pix_offset: int = 0,
             n_pix: int | None = None, spawn_order=None) -> tuple:
    """Everything a :class:`WaveLoop` capture fixes, for the arguments of
    :func:`render_batch` (its first sample aside), from host values alone:
    no device read.  The device, the flags and the configuration; the
    argument block's by-value fields that the call sets (slots, steps,
    chunk, exit and control denominators, stride, pixel block, samples,
    work items); the BVH object, and every tensor of the BVH, scene, camera,
    base key and spawn order by identity and ``_version`` (a table
    modified in place, or a new scene object, is another key).  A spawn
    order that is not a tensor matches no key."""
    from .traverse import ADAPTIVE_EXIT_DEN, wave_chunk
    dev = scene.sph_c0.device
    chunk, npix, _, R, stride, items_total = WaveEngine.pool(
        cfg, dev, n_samples, queue_size, sample_stride, n_pix)
    steps = int(steps_per_wave)
    if spawn_order is not None:
        spawn_order = _Same(spawn_order if isinstance(spawn_order,
                                                      torch.Tensor)
                            else object())
    return (str(dev), flags, cfg, int(n_samples), R, steps,
            wave_chunk(steps, chunk) if steps > 0 else 1, ADAPTIVE_EXIT_DEN,
            int(ctrl_den), stride, npix, int(pix_offset), items_total,
            spawn_order, _Same(bvh), *_tensor_fields(bvh),
            *_tensor_fields(scene), *_tensor_fields(cam), _Same(base_key))


CAPTURES = 0         # WaveLoop captures made in this process
_KEPT: WaveLoop | None = None
_PROFILED = False    # wave_loop has run under torch.profiler in this process
_profiling = torch._C._autograd._profiler_enabled


def wave_loop(scene, flags, bvh, cam, cfg: RenderConfig, accum, start_sample,
              n_samples: int, base_key, queue_size: int, steps_per_wave: int,
              ctrl_den: int, sample_stride: int | None = None,
              pix_offset: int = 0, n_pix: int | None = None,
              spawn_order=None) -> WaveLoop:
    """The :class:`WaveLoop` of :func:`render_batch`'s arguments, loaded
    with the batch's frame ``accum`` and first sample: the one kept from an
    earlier batch where :func:`loop_key` matches, else a capture over a new
    engine and state (``init_state(accum)``), which replaces it, the old
    graph freed first.  The span ``wavefront.setup`` times the lookup and
    the copy-in, or the engine and state.

    A graph instantiated before the profiler's device tracer (CUPTI) first
    ran in the process shows it each kernel of the WHILE body once a
    launch, not once a wave (measured on the H100, PERF.md): so the first
    batch that runs under ``torch.profiler`` recaptures a loop captured
    before any did, and the trace sees every kernel run."""
    global _KEPT, _PROFILED
    with span("wavefront.setup"):
        _PROFILED = _PROFILED or _profiling()
        key = loop_key(scene, flags, bvh, cam, cfg, n_samples, base_key,
                       queue_size, steps_per_wave, ctrl_den, sample_stride,
                       pix_offset, n_pix, spawn_order)
        if (_KEPT is not None and _KEPT.key == key
                and (_KEPT.traced or not _PROFILED)):
            _KEPT.load(accum, start_sample)
            return _KEPT
        clear_wave_loops()
        eng = WaveEngine(scene, flags, bvh, cam, cfg, start_sample,
                         n_samples, base_key, queue_size, steps_per_wave,
                         ctrl_den, sample_stride, pix_offset, n_pix,
                         spawn_order=spawn_order)
        ws = eng.init_state(accum)
    _KEPT = WaveLoop(eng, ws, key)
    return _KEPT


def clear_wave_loops() -> None:
    """Free the kept :class:`WaveLoop`."""
    global _KEPT
    kept, _KEPT = _KEPT, None
    if kept is not None:
        kept.free()


def _stats(ws: WaveState, eng: WaveEngine) -> dict:
    return dict(counter_stats(ws.ctr, ws.depth_hist), slots=eng.R,
                spawned=torch.clamp(ws.ctr[C_SPAWNED], max=eng.items_total),
                total=eng.total, pixel_paths=ws.pix_paths)


def render_batch(scene, flags, bvh, cam, cfg: RenderConfig, accum,
                 start_sample, n_samples: int, base_key,
                 queue_size: int = 4096, steps_per_wave: int = 12,
                 with_stats: bool = False, ctrl_den: int = 8,
                 sample_stride: int | None = None, plain: bool = False,
                 pix_offset: int = 0, n_pix: int | None = None,
                 spawn_order=None):
    """Accumulate ``n_samples`` samples into a copy of ``accum`` (H, W, 3).

    Same arguments and result as the JAX ``render_batch``; ``base_key`` is
    the (2,) key of :mod:`..utils.rng`.  ``pix_offset``/``n_pix`` select
    the block of frame pixels ``pix_offset ..`` ``+ n_pix`` (a data-parallel
    shard): the camera and the RNG take the frame pixel, so a sharded render
    integrates the sample set of the whole-frame one, and ``accum`` and the
    result are the block's ``(n_pix, 3)``.  ``plain=True`` runs the plain-torch
    twins on whatever device the tensors are on (the comparison path, a
    host loop); the default runs the CUDA kernels in the device wave loop
    for CUDA tensors: the kept :class:`WaveLoop` of this configuration
    (:func:`wave_loop`), replayed, whose frame is copied out of the state it
    keeps and whose counters and depth histogram come from its one host
    read.  With ``with_stats`` the stats dict holds the counters of
    :data:`.types.STATS` (``stack_overflows`` must be 0), their vector
    ``ctr``, ``depth_hist``, ``slots``, ``spawned``, ``total``,
    ``pixel_paths`` (finished paths per pixel) and ``host_reads``.  ``spawn_order``
    (:func:`tile_spawn_order`, one entry per block pixel) permutes the
    order in which work items take pixels; the sample set stays the same.
    """
    if scene.sph_c0.device.type == "cuda" and not plain:
        loop = wave_loop(scene, flags, bvh, cam, cfg, accum, start_sample,
                         n_samples, base_key, queue_size, steps_per_wave,
                         ctrl_den, sample_stride, pix_offset, n_pix,
                         spawn_order)
        ctr, hist = loop.run()
        eng, reads = loop.eng, 1
        out = {"accum": loop.ws.accum.clone(), "ctr": ctr, "depth_hist": hist}
        if with_stats:
            out["pix_paths"] = loop.ws.pix_paths.clone()
        ws = dataclasses.replace(loop.ws, **out)
    else:
        with span("wavefront.setup"):
            eng = WaveEngine(scene, flags, bvh, cam, cfg, start_sample,
                             n_samples, base_key, queue_size, steps_per_wave,
                             ctrl_den, sample_stride, pix_offset, n_pix,
                             spawn_order=spawn_order)
            ws = eng.init_state(accum)
        reads = run_waves(eng, ws, plain=plain)
    image = (ws.accum if n_pix is not None
             else ws.accum.reshape(cfg.height, cfg.width, 3))
    if with_stats:
        return image, dict(_stats(ws, eng), host_reads=reads)
    return image


def render_batch_diff(scene, flags, bvh, cam, cfg: RenderConfig, accum,
                      start_sample, n_samples: int, base_key,
                      queue_size: int = 4096, steps_per_wave: int = 12,
                      n_waves: int = 256, ctrl_den: int = 8,
                      ckpt_every: int = 1, save_trav: bool = True,
                      sample_stride: int | None = None, pix_offset: int = 0,
                      n_pix: int | None = None):
    """Differentiable wavefront → ``(accum + image, stats)``, the arguments
    and result of the JAX ``render_batch_diff``; ``stats`` is
    :func:`render_batch`'s, with ``paths == total`` for a whole image.

    The forward is :func:`render_batch`; gradients with respect to the
    scene's floating fields that require grad come from replaying every
    (sample, pixel) path (:mod:`.adjoint`), for every floating leaf: on the
    card K6 (its colour instantiation when every leaf is a colour leaf, its
    full one otherwise), on the CPU autograd of the megakernel twin.  Both
    integrate the wavefront's sample set, which the RNG folds fix.
    ``pix_offset``/``n_pix`` render and differentiate a pixel block, as
    :func:`render_batch` does; ``accum`` and the image are then
    ``(n_pix, 3)``.

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

    shape = ((n_pix, 3) if n_pix is not None
             else (cfg.height, cfg.width, 3))

    def forward(sc):
        zero = torch.zeros(shape, device=sc.sph_c0.device)
        image, stats = render_batch(sc, flags, bvh, cam, cfg, zero, start, n,
                                    base_key, queue_size=queue_size,
                                    steps_per_wave=steps_per_wave,
                                    with_stats=True, ctrl_den=ctrl_den,
                                    sample_stride=sample_stride,
                                    pix_offset=pix_offset, n_pix=n_pix)
        if int(stats["waves"]) > n_waves:
            raise RuntimeError(
                f"the forward took {int(stats['waves'])} waves, more than "
                f"n_waves={n_waves}; size n_waves with "
                f"parallel.render_dist.calibrate_n_waves")
        return image, stats

    image, stats = adjoint.render_diff(scene, flags, bvh, cam, cfg, base_key,
                                       range(start, start + n), forward,
                                       pix_offset, n_pix)
    return accum.to(image.device) + image, stats
