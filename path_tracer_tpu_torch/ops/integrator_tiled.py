"""The tiled fixed-trip engine (B12): K7 ``closest_hit``, K8 ``tiled_trip``.

Port of ``path_tracer_tpu/ops/integrator_tiled.py``: ``closest_hit_batched``
(:46), ``trace_rays_tiled`` (:80), ``render_sample_tiled`` (:124) and
``render_tiled`` (:159).  A chunk of lanes, each one (sample, pixel) path,
runs exactly ``cfg.iters`` trips; a trip is the closest-hit query from
``t_min`` (K7), in a medium scene the volume-exit query from ``t_hit +
1e-4`` of the lanes whose hit has a medium (K7 again, :func:`exit_lanes`),
then one bounce of every live lane
(K8: ``prim_medium_t`` of the exit hit, ``wave_rng``, ``bounce_shade_t``),
and finished lanes keep their state.  The keys fold as the megakernel's
(base → sample → pixel → iters), so the engine integrates
``trace_ray_scan``'s sample set, lane for lane; that is why the replay of
:mod:`.adjoint` (K6) is its backward.

On the card one launch of K7 covers every lane of a chunk; K8, given live
lists (:func:`new_live_list`), runs only the lanes still alive, over a
fixed grid that strides over the list; the chunk's first state comes from
``tiled_spawn`` (``spawn_paths``, B3, with K2's camera code), which also
writes the first list.  :func:`render_tiled` replays a chunk's spawn and
trips captured once as a CUDA graph (:class:`TripGraph`) for every sample
and chunk, and keeps that graph for the next frame of the same BVH and
configuration, whatever its key and camera (:func:`trip_graph`; a train
step's renders replay one graph); :func:`render_sample_tiled` is the same
work queued launch by launch from the host.
On CPU tensors every wrapper runs its plain-torch version.  The
pipeline-parallel mode's K9 (``ring_hop``) and the rec variant of K8 live
beside K7 and K8 (``csrc/closest_hit.cu``, ``csrc/tiled_trip.cu``).
"""
from __future__ import annotations

import copy
import types

import torch

from . import adjoint, kernels
from .shade_tiled import (HitT, ShadeTables, bounce_shade_t, make_tables,
                          prim_medium_t, spawn_paths, wave_rng)
from .traverse import _traverse_impl
from .types import (C_TRAV_STEPS, C_WALK_STEPS, N_COUNTERS, PathState,
                    RenderConfig, counter_stats)

# The (R, 12) hit record of the pipeline mode (PTT_REC, csrc/common.cuh).
REC_FIELDS = ("t", "px", "py", "pz", "nx", "ny", "nz", "front", "u", "v",
              "mat", "medium")
CHUNK = 1 << 20      # lanes per chunk: on the card one launch covers a chunk
# The scene arrays the trip kernels read besides the shade tables.
SCENE_FIELDS = ("img_data", "img_hw", "perlin_vec", "perlin_perm")


class TiledEngine:
    """Static parameters of the lane kernels over one scene: the tables,
    sizes and keys of the argument block that K8 and K9 read (K7 reads
    only the BVH)."""

    def __init__(self, scene, flags, bvh, cam, cfg: RenderConfig, base_key):
        self.scene, self.flags, self.bvh, self.cam, self.cfg = (
            scene, flags, bvh, cam, cfg)
        self.device = scene.sph_c0.device
        self.key = base_key.to(self.device)
        self.tabs = make_tables(scene)
        self.sd = min(cfg.stack_depth, bvh.max_stack)
        self.root = int(bvh.root)
        self.npix = self.R = self.items_total = 0
        self.steps = self.ctrl_den = self.pix_offset = 0
        self.stride, self.multi = 1, False
        self.start_sample, self.n_samples = 0, 1
        self._args = None

    def args(self) -> kernels.WaveArgs:
        """The engine's argument block (built once)."""
        if self._args is None:
            self._args = kernels.fill_args(self)
        return self._args


def new_counters(device) -> torch.Tensor:
    return torch.zeros((N_COUNTERS,), dtype=torch.int64, device=device)


def _lanes(x, n, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(n).contiguous() if x.ndim == 0 else x.contiguous()


# ---------------------------------------------------------------------------
# K7: the closest-hit query.
# ---------------------------------------------------------------------------

def closest_hit_plain(bvh, ro, rd, time, t_min, t_max, stack_depth: int,
                      active=None, ctr=None):
    """Plain version of K7 → ``(found, prim_type, prim_idx, t)``, all (R,):
    the walk to completion from the per-lane ``t_min`` to ``t_max`` (a
    scalar, or per lane); a lane not ``active`` does not walk and reports no
    hit (pt = pi = -1, t = t_max).  Walking-lane steps are added to
    ``ctr[C_TRAV_STEPS]``."""
    found, pt, pi, t, steps = _traverse_impl(bvh, ro, rd, time, t_min, t_max,
                                             stack_depth, active)
    if active is not None:
        t = torch.where(active, t, torch.as_tensor(t_max, dtype=t.dtype,
                                                   device=t.device))
    if ctr is not None:
        ctr[C_TRAV_STEPS] += steps
    return found, pt, pi, t


def closest_hit_batched(bvh, ro, rd, time, t_min, t_max, stack_depth: int,
                        active=None, ctr=None, exit_of=None):
    """K7 wrapper: ``closest_hit_batched``'s query (the walk is
    zero-gradient, as JAX's stop-gradients make it); the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.

    ``exit_of`` makes it the volume-exit query of a trip: ``(eng, found,
    pt, pi)``, the tiled engine and the main query's hit; a lane walks only
    where :func:`exit_lanes` admits it (on the card the kernel reads the
    hit's medium itself)."""
    if not ro.is_cuda:
        if exit_of is not None:
            active = exit_lanes(exit_of[0], active, *exit_of[1:])
        return closest_hit_plain(bvh, ro, rd, time, t_min, t_max, stack_depth,
                                 active, ctr)
    R, dev = ro.shape[0], ro.device
    if bvh.nodes.device != dev:
        raise ValueError("the BVH and the rays are on different devices")
    sd = min(stack_depth, bvh.max_stack)
    found = torch.empty((R,), dtype=torch.bool, device=dev)
    pt = torch.empty((R,), dtype=torch.int32, device=dev)
    pi = torch.empty((R,), dtype=torch.int32, device=dev)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    a = kernels.query_args(bvh, t_max, sd)
    kernels.set_lanes(a, R, dev, ctr if ctr is not None else new_counters(dev),
                      origin=ro, direction=rd, time=_lanes(time, R, dev),
                      q_tmin=_lanes(t_min, R, dev), q_active=active,
                      hit_found=found, hit_pt=pt, hit_pi=pi, hit_t=t)
    kernels.set_gate(a, R, dev, *(() if exit_of is None else
                                  (exit_of[0].tabs, *exit_of[2:])))
    kernels.set_stack(a, R, dev)
    kernels.launch_args("closest_hit", a, dev)
    return found, pt, pi, t


# ---------------------------------------------------------------------------
# The tiled spawn (B3) and K8: one trip.
# ---------------------------------------------------------------------------

def _set_sample(a: kernels.WaveArgs, sample) -> None:
    """The lane kernels' sample: an int, or a (1,) int32 card tensor that a
    replayed graph reads (``sample_dev``)."""
    if isinstance(sample, torch.Tensor):
        a.sample_dev = kernels._ptr(sample)
        a._keep_sample = sample
    else:
        a.sample_dev = None
        a.start_sample = int(sample)


def new_live_list(n: int, device):
    """K8's live lists for ``n`` lanes: two lists of lane indices (2, n)
    and their counts and the launch ticket (3,), all int32 on ``device``;
    ``tiled_spawn`` fills list 0 with every lane."""
    return (torch.zeros((2, n), dtype=torch.int32, device=device),
            torch.zeros((3,), dtype=torch.int32, device=device))


def _set_live(a: kernels.WaveArgs, live, parity: int = 0) -> None:
    """Point K8's (or the spawn's) live-list fields at ``live`` (None: K8
    runs every lane), trip ``parity`` reading list ``parity``."""
    a.live = kernels._ptr(None if live is None else live[0])
    a.live_n = kernels._ptr(None if live is None else live[1])
    a.live_parity = int(parity)
    a._keep_live = live


def tiled_spawn(eng: TiledEngine, sample, pix, live=None,
                out: PathState | None = None) -> PathState:
    """The first trip's state of the lanes ``pix`` (frame pixels) for
    sample ``sample``: ``spawn_paths``; on the card ``tiled_spawn`` (the
    sample may then be a (1,) int32 card tensor), which also makes list 0
    of ``live`` (:func:`new_live_list`) every lane.  ``out``: the state's
    tensors to write into (contiguous; a row need not start 16-byte
    aligned), else new ones."""
    if not pix.is_cuda:
        smp = torch.full_like(pix, int(sample))
        st = spawn_paths(eng.cam, eng.cfg, eng.key, smp, pix)
        if out is None:
            return PathState(*(x.contiguous() for x in st))
        for dst, src in zip(out, st):
            dst.copy_(src)
        return out
    R, dev = pix.shape[0], pix.device
    st = out if out is not None else PathState(
        origin=torch.empty((R, 3), device=dev),
        direction=torch.empty((R, 3), device=dev),
        time=torch.empty((R,), device=dev),
        color=torch.empty((R, 3), device=dev),
        throughput=torch.empty((R, 3), device=dev),
        depth=torch.empty((R,), dtype=torch.int32, device=dev),
        iters=torch.empty((R,), dtype=torch.int32, device=dev),
        alive=torch.empty((R,), dtype=torch.bool, device=dev))
    a = eng.args()
    _set_sample(a, sample)
    _set_live(a, live)
    kernels.set_lanes(a, R, dev, new_counters(dev), pixel=pix.contiguous(),
                      **st._asdict())
    kernels.launch_args("tiled_spawn", a, dev)
    return st


def rec_to_rows(rec: HitT) -> torch.Tensor:
    """A hit record as (R, 12) rows in :data:`REC_FIELDS` order."""
    return torch.stack([rec.t, *rec.p, *rec.n, rec.front.to(torch.float32),
                        rec.u, rec.v, rec.mat.to(torch.float32),
                        rec.medium.to(torch.float32)], -1)


def rows_to_rec(rows: torch.Tensor, hit) -> HitT:
    """(R, 12) rows as a :class:`HitT` whose ``hit`` is ``hit``."""
    c = rows.unbind(-1)
    return HitT(hit=hit, t=c[0], p=c[1:4], n=c[4:7], front=c[7] != 0.0,
                u=c[8], v=c[9], mat=c[10].to(torch.int32),
                medium=c[11].to(torch.int32))


def tiled_trip_plain(eng: TiledEngine, st: PathState, sample: int, pix, hit,
                     ext=None, exit_med=None, rec=None, ctr=None) -> PathState:
    """Plain version of K8: one trip of every lane → the next state.

    ``hit`` is the main query's ``(found, pt, pi)``; ``ext`` the exit
    query's ``(found, pt, pi, t)`` (a medium scene); ``exit_med`` (R,) bool
    replaces the medium lookup of the exit hit; ``rec`` (R, 12) rows replace
    the refinement of ``(pt, pi)``.  Lanes that are not alive keep their
    state; the walk's trips of live lanes go to ``ctr[C_WALK_STEPS]``.
    """
    flags = eng.flags
    found, pt, pi = hit
    if flags.has_medium:
        e_found, e_pt, e_pi, t_exit = ext
        if exit_med is None:
            exit_med = prim_medium_t(eng.tabs, e_pt, e_pi) >= 0
    else:
        e_found = torch.zeros_like(found)
        t_exit = torch.zeros_like(st.time)
        exit_med = torch.zeros_like(found)
    rngs = wave_rng(eng.key, torch.full_like(pix, int(sample)), pix, st.iters,
                    flags.has_sss)
    record = None if rec is None else rows_to_rec(rec, found)
    nxt, aux = bounce_shade_t(eng.scene, flags, eng.cam, eng.cfg, eng.tabs, st,
                              found, pt, pi, e_found, t_exit, exit_med, rngs,
                              rec=record, live=st.alive, aux=True)
    if ctr is not None:
        ctr[C_WALK_STEPS] += aux["walk_steps"]
    keep = st.alive
    return PathState(*(torch.where(keep.view(-1, *(1,) * (x.ndim - 1)), y, x)
                       for x, y in zip(st, nxt)))


def tiled_trip(eng: TiledEngine, st: PathState, sample, pix, hit,
               ext=None, exit_med=None, rec=None, ctr=None, live=None,
               parity: int = 0) -> PathState:
    """K8 wrapper (``tiled_trip``, or ``tiled_trip_rec`` with ``rec``): on
    the card it updates ``st`` in place and returns it (the sample may be a
    (1,) int32 card tensor); on the CPU the plain version's new state.

    ``live`` (:func:`new_live_list`, card only, not with ``rec``): the trip
    runs the lanes of list ``parity`` and appends those that stay alive to
    the other list; every lane not in the list must be dead."""
    if not pix.is_cuda:
        return tiled_trip_plain(eng, st, sample, pix, hit, ext, exit_med, rec,
                                ctr)
    R, dev = pix.shape[0], pix.device
    found, pt, pi = hit
    lanes = dict(st._asdict(), pixel=pix, hit_found=found, hit_pt=pt,
                 hit_pi=pi, rec=rec)
    if eng.flags.has_medium:
        e_found, e_pt, e_pi, t_exit = ext
        lanes.update(exit_found=e_found, exit_pt=e_pt, exit_pi=e_pi,
                     exit_t=t_exit, exit_med=exit_med)
    if live is not None and rec is not None:
        raise ValueError("the rec variant of K8 runs every lane")
    a = eng.args()
    _set_sample(a, sample)
    _set_live(a, live, parity)
    kernels.set_lanes(a, R, dev, ctr if ctr is not None else new_counters(dev),
                      **lanes)
    kernels.launch_args("tiled_trip" if rec is None else "tiled_trip_rec", a,
                        dev)
    return st


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

def exit_lanes(eng: TiledEngine, alive, found, pt, pi):
    """The lanes whose volume-exit query a trip walks: alive, with a hit
    whose primitive has a medium (K5's rule, ``csrc/path.cuh``).  JAX walks
    it on every live lane that hit, but the bounce reads the exit hit only
    where the hit enters a medium (``bounce_shade_t``), so the images are
    the same; only the walks' steps fall."""
    return alive & found & (prim_medium_t(eng.tabs, pt, pi) >= 0)


def trace_rays_tiled(eng: TiledEngine, path0: PathState, sample: int, pix,
                     ctr=None, live=None):
    """Trace the lanes' paths ``cfg.iters`` trips → their radiance (R, 3).

    ``path0`` is the lanes' first state (it is updated in place on the
    card), ``pix`` their frame pixels and ``sample`` the sample index of
    every lane; ``live`` the live lists ``tiled_spawn`` filled (card
    only).  Same keys, same colours as ``trace_ray_scan``, lane for lane.
    """
    cfg, bvh = eng.cfg, eng.bvh
    R = path0.origin.shape[0]
    t_min_v = torch.full((R,), cfg.t_min, device=pix.device)
    s = path0
    for trip in range(cfg.iters):
        found, pt, pi, t_hit = closest_hit_batched(
            bvh, s.origin, s.direction, s.time, t_min_v, cfg.t_max,
            cfg.stack_depth, active=s.alive, ctr=ctr)
        ext = None
        if eng.flags.has_medium:
            ext = closest_hit_batched(
                bvh, s.origin, s.direction, s.time, t_hit + 1e-4, cfg.t_max,
                cfg.stack_depth, active=s.alive, ctr=ctr,
                exit_of=(eng, found, pt, pi))
        s = tiled_trip(eng, s, sample, pix, (found, pt, pi), ext, ctr=ctr,
                       live=live, parity=trip & 1)
    return s.color


class TripGraph:
    """One chunk of the tiled engine as a CUDA graph (the device form of
    JAX's ``lax.scan`` over trips, :91-118): ``tiled_spawn``, then
    ``cfg.iters`` trips of K7, K7 for the exit query in a medium scene, and
    K8 (on the live lists, :func:`new_live_list`).  The chunk's pixels and
    the sample are read from card memory, so one capture replays every
    (sample, chunk).  Launches count per replay.

    The graph reads the engine's tables and scene arrays from copies it
    owns, and the frame's base key and camera from card memory
    (``kernels.frame_words``); :meth:`load` copies a frame's values in.  It
    adds to ``ctr`` (default: counters it owns).  So it serves every frame
    of the same BVH and configuration, whatever its key, view or table
    values (:func:`trip_graph`).
    """

    def __init__(self, eng: TiledEngine, n_lanes: int, ctr=None):
        global CAPTURES
        dev = eng.device
        self.bvh = eng.bvh
        own = copy.copy(eng)          # the engine over tables the graph owns
        own.tabs = ShadeTables(*(t.clone() if torch.is_tensor(t) else t
                                 for t in eng.tabs))
        own.scene = types.SimpleNamespace(**{
            f: getattr(eng.scene, f).clone() for f in SCENE_FIELDS})
        own._args = None
        self.eng = own
        self.frame = kernels.frame_words(eng.args()).to(dev)
        self.ctr = new_counters(dev) if ctr is None else ctr
        self.key = self.config(eng, n_lanes)
        self.pix = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
        self.sample = torch.zeros((1,), dtype=torch.int32, device=dev)
        live = new_live_list(n_lanes, dev)
        kernels.build()     # host work before the capture: the libraries and
        a = own.args()      # the argument blocks
        a.frame_dev, a._keep_frame = kernels._ptr(self.frame), self.frame
        kernels.query_args(eng.bvh, eng.cfg.t_max,
                           min(eng.cfg.stack_depth, eng.bvh.max_stack))
        self.graph = torch.cuda.CUDAGraph()
        # Captured on a side stream, without torch.cuda.graph's garbage
        # collection and cache flush before every capture.
        side, main = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with kernels.captured_launches() as tally, torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                path0 = tiled_spawn(own, self.sample, self.pix, live)
                self.color = trace_rays_tiled(own, path0, self.sample,
                                              self.pix, self.ctr, live)
            finally:
                self.graph.capture_end()
        main.wait_stream(side)
        self.tally = dict(tally)
        CAPTURES += 1

    @staticmethod
    def config(eng: TiledEngine, n_lanes: int) -> tuple:
        """What a capture fixes besides the BVH: the argument block's
        by-value fields but the frame's key and camera, the chunk and the
        shapes of the tables."""
        shapes = tuple(tuple(t.shape) for t in eng.tabs if torch.is_tensor(t))
        shapes += tuple(tuple(getattr(eng.scene, f).shape)
                        for f in SCENE_FIELDS)
        return (int(n_lanes), str(eng.device), shapes,
                kernels.value_fields(eng.args()))

    @torch.no_grad()
    def load(self, eng: TiledEngine) -> None:
        """Copy ``eng``'s tables, scene arrays, key and camera into the
        graph's."""
        for dst, src in zip(self.eng.tabs, eng.tabs):
            if torch.is_tensor(dst):
                dst.copy_(src)
        for f in SCENE_FIELDS:
            getattr(self.eng.scene, f).copy_(getattr(eng.scene, f))
        self.frame.copy_(kernels.frame_words(eng.args()))

    def run(self, sample: int, pix) -> torch.Tensor:
        """The chunk's radiance (R, 3) for ``sample`` of the lanes ``pix``;
        the graph's output, overwritten by the next run."""
        self.sample.fill_(int(sample))
        self.pix.copy_(pix)
        self.graph.replay()
        kernels.count(self.tally)
        return self.color


CAPTURES = 0         # TripGraph captures made in this process
_CACHED: TripGraph | None = None


def trip_graph(eng: TiledEngine, n_lanes: int) -> TripGraph:
    """The :class:`TripGraph` of ``eng``'s BVH and configuration for chunks
    of ``n_lanes``, loaded with ``eng``'s tables, key and camera: the one
    kept from an earlier frame where BVH and configuration match (a train
    step's renders, a new view), else a new capture, which replaces it."""
    global _CACHED
    g = _CACHED
    if (g is None or g.bvh is not eng.bvh
            or g.key != TripGraph.config(eng, n_lanes)):
        _CACHED = None                 # the old graph's memory first
        g = _CACHED = TripGraph(eng, n_lanes)
    else:
        g.load(eng)
    return g


def clear_trip_graphs() -> None:
    """Drop the kept :class:`TripGraph`."""
    global _CACHED
    _CACHED = None


def _chunks(pix_idx, n: int, chunk_size: int, dev):
    """The lanes padded with pixel 0 to whole chunks → (idxs, chunk)."""
    chunk = min(int(chunk_size), max(n, 1))
    n_pad = -(-n // chunk) * chunk
    idxs = torch.cat([pix_idx.to(dev, torch.int32),
                      torch.zeros((n_pad - n,), dtype=torch.int32, device=dev)])
    return idxs, chunk


def render_sample_tiled(scene, flags, bvh, cam, cfg: RenderConfig,
                        sample_idx: int, base_key, pix_idx=None,
                        chunk_size: int = CHUNK, eng=None, ctr=None):
    """One sample for every pixel, or for the frame pixels ``pix_idx`` →
    (H, W, 3), or (len(pix_idx), 3).

    Lanes run in chunks of ``chunk_size`` (the last padded with pixel 0,
    traced and dropped); the result does not depend on the chunk size.
    Every launch is queued from the host (the eager loop; :func:`render_tiled`
    replays a :class:`TripGraph` on the card).
    """
    eng = eng or TiledEngine(scene, flags, bvh, cam, cfg, base_key)
    dev = eng.device
    full = pix_idx is None
    if full:
        pix_idx = _frame_pixels(cfg, dev)
    n = pix_idx.shape[0]
    idxs, chunk = _chunks(pix_idx, n, chunk_size, dev)
    out = []
    live = new_live_list(chunk, dev) if dev.type == "cuda" else None
    for c in range(0, idxs.shape[0], chunk):
        pix = idxs[c:c + chunk]
        path0 = tiled_spawn(eng, sample_idx, pix, live)
        out.append(trace_rays_tiled(eng, path0, sample_idx, pix, ctr, live))
    colors = torch.cat(out)[:n]
    return colors.reshape(cfg.height, cfg.width, 3) if full else colors


def _frame_pixels(cfg: RenderConfig, dev):
    return torch.arange(cfg.width * cfg.height, dtype=torch.int32, device=dev)


def _graphed_samples(eng: TiledEngine, spp: int, pix_idx, chunk_size: int,
                     ctr):
    """Sum of ``spp`` samples of :func:`render_sample_tiled` through one
    :class:`TripGraph` (:func:`trip_graph`) replayed per (sample, chunk);
    its counters are added to ``ctr``."""
    cfg, dev = eng.cfg, eng.device
    full = pix_idx is None
    pix_idx = _frame_pixels(cfg, dev) if full else pix_idx
    n = pix_idx.shape[0]
    idxs, chunk = _chunks(pix_idx, n, chunk_size, dev)
    graph = trip_graph(eng, chunk)
    graph.ctr.zero_()
    acc = torch.zeros((idxs.shape[0], 3), device=dev)
    for s in range(spp):
        for c in range(0, idxs.shape[0], chunk):
            acc[c:c + chunk] += graph.run(s, idxs[c:c + chunk])
    ctr += graph.ctr
    acc = acc[:n]
    return acc.reshape(cfg.height, cfg.width, 3) if full else acc


def render_tiled(scene, flags, bvh, cam, cfg: RenderConfig, base_key,
                 spp: int | None = None, pix_offset: int = 0,
                 n_pix: int | None = None, chunk_size: int = CHUNK,
                 with_stats: bool = False):
    """Accumulate ``spp`` samples → (H, W, 3) mean radiance; differentiable
    with respect to every floating scene field that requires grad.

    The forward is the tiled engine (K7 + K8 on the card); the backward
    replays each (sample, pixel) path through :mod:`.adjoint` (K6 on the
    card, its colour or full instantiation from the leaf set; autograd of
    the twins on the CPU).  ``pix_offset``/``n_pix`` render the block of
    frame pixels ``pix_offset ..`` ``+ n_pix`` → ``(n_pix, 3)`` (a
    data-parallel shard).  With ``with_stats`` also returns the counters
    of :data:`.types.STATS` (``trav_steps``, ``walk_steps`` and
    ``stack_overflows`` counted, the others 0) and their vector ``ctr``.
    """
    spp = spp if spp is not None else cfg.samples_per_pixel
    dev = scene.sph_c0.device
    pix = None
    if n_pix is not None:
        pix = torch.arange(pix_offset, pix_offset + n_pix, dtype=torch.int32,
                           device=dev)

    def forward(sc):
        eng = TiledEngine(sc, flags, bvh, cam, cfg, base_key)
        ctr = new_counters(dev)
        if dev.type != "cuda":
            acc = 0.0
            for s in range(spp):
                acc = acc + render_sample_tiled(sc, flags, bvh, cam, cfg, s,
                                                base_key, pix, chunk_size,
                                                eng, ctr)
        else:
            acc = _graphed_samples(eng, spp, pix, chunk_size, ctr)
        return acc, counter_stats(ctr)

    image, stats = adjoint.render_diff(scene, flags, bvh, cam, cfg, base_key,
                                       range(spp), forward, pix_offset, n_pix)
    image = image / spp
    return (image, stats) if with_stats else image
