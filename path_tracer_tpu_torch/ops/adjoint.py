"""The backward of the shading (B13, B13'): image gradients for the scene
leaves.

Port of what ``jax.grad`` computes through ``integrator.trace_ray_scan``
(``path_tracer_tpu/ops/integrator.py:268``) and the backward wavefront
(``ops/wavefront.py:520`` ``render_batch_diff``).  Both JAX engines
integrate one sample set, fixed by the RNG folds; traversal is
zero-gradient (visibility is discrete) and the Russian-roulette boost and
every coin are constants.  So the gradient of a rendered image is the
gradient of the megakernel twin's paths, whichever engine rendered the
image, and the backward here replays each (sample, pixel) path instead of
storing wave state.

:class:`SceneRender` is the ``torch.autograd.Function``: its forward runs
the caller's forward engine (K5, or K1-K4 for the wavefront, on the card;
the twins on the CPU) and its backward receives δ = dL/d(image):

* CPU tensors: autograd of the megakernel twin's replay, contracted with δ,
  for every floating scene leaf that requires grad (the plain path).
* CUDA tensors: kernel K6 :func:`adjoint` (``csrc/adjoint.cu``), one launch
  per sample (or per pixel block, :func:`run_adjoint`), for every floating
  leaf (:data:`FLOAT_LEAVES`).  A leaf set
  within :data:`COLOUR_LEAVES` runs its colour instantiation: those leaves
  enter a path linearly, so their adjoint is a replay and a reverse sweep of
  the path's colour events.  Any other set runs the full instantiation,
  which carries the adjoint of each trip's origin, direction and throughput
  back through the bounce (hit refinement, media, the seven scatter
  families, the SSS walk, textures).  Nothing falls back to the twin.

K6 writes into :class:`GradBuffers`, shaped like the tables it reads
(:class:`~.shade_tiled.ShadeTables` ``prim``, ``mat``, ``med``, ``tex``; the
atlas flattened to ``(texels, 3)``; the Perlin table); :func:`leaf_grads`
maps them to the leaves, the transpose of
:func:`~.shade_tiled.make_tables`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import kernels

COLOUR_LEAVES = ("tex_c1", "tex_c2", "img_data")
# Every floating field of SceneArrays: the leaves K6 differentiates.
FLOAT_LEAVES = (
    "sph_c0", "sph_c1", "sph_rad", "qd_q", "qd_u", "qd_v", "qd_n", "qd_w",
    "qd_d", "tr_v0", "tr_e1", "tr_e2", "tr_n", "mat_fuzz", "mat_ir", "mat_g",
    "mat_sigma_s", "mat_sigma_a", "mat_scatter_dist", "tex_c1", "tex_c2",
    "tex_scale", "img_data", "med_density", "perlin_vec")
# Tape entries and SSS walk trips K6 keeps in local memory (PTT_TAPE_MAX,
# PTT_WALK_MAX, csrc/common.cuh); beyond them, or beyond the local stack,
# its arrays live in per-pixel buffers (per_pixel_buffers).
TAPE_MAX = 64
WALK_MAX = 64
WALK_ENTRY_BYTES = 16   # one SSS walk trip: heading (3 floats) and length
# Share of the card's free memory K6's per-pixel buffers may take; a frame
# whose buffers need more runs in pixel blocks.
SCRATCH_SHARE = 4


class GradBuffers(NamedTuple):
    """K6's gradient buffers, in the layout of the tables they
    differentiate (``csrc/common.cuh`` ``WaveArgs.g_*``)."""

    tex: torch.Tensor     # (T, 9) as ShadeTables.tex
    img: torch.Tensor     # (texels, 3) as img_data
    prim: torch.Tensor    # (Ns+Nq+Nt, 18) as ShadeTables.prim
    mat: torch.Tensor     # (M, 8) as ShadeTables.mat
    med: torch.Tensor     # (Mv, 2) as ShadeTables.med
    perlin: torch.Tensor  # (256, 4) as perlin_vec


def grad_leaves(scene) -> tuple[list[str], list[torch.Tensor]]:
    """Names and tensors of the scene's floating fields that require grad."""
    names, leaves = [], []
    for f in dataclasses.fields(scene):
        x = getattr(scene, f.name)
        if isinstance(x, torch.Tensor) and x.requires_grad:
            names.append(f.name)
            leaves.append(x)
    return names, leaves


def plain_vjp(scene, flags, bvh, cam, cfg, base_key, samples, names, delta,
              pix_offset: int = 0, n_pix: int | None = None):
    """The plain path: autograd of the twin's replay of ``samples``,
    contracted with ``delta`` (npix, 3) per sample → one gradient per name
    (zero for a leaf that enters no path).  With ``n_pix``, the paths of the
    frame pixels ``pix_offset ..`` ``+ n_pix`` and ``delta`` (n_pix, 3)."""
    from .integrator import trace_sample

    xs = [getattr(scene, n).detach().requires_grad_() for n in names]
    sc = dataclasses.replace(scene, **dict(zip(names, xs)))
    grads = [torch.zeros_like(x) for x in xs]
    with torch.enable_grad():
        for s in samples:
            col = trace_sample(sc, flags, bvh, cam, cfg, base_key, s,
                               pix_offset, n_pix)[0].color
            gs = torch.autograd.grad(col, xs, delta, allow_unused=True)
            for g, gi in zip(grads, gs):
                if gi is not None:
                    g.add_(gi)
    return grads


# ---------------------------------------------------------------------------
# K6: the adjoint of one sample.
# ---------------------------------------------------------------------------

def _buffer_shapes(scene) -> GradBuffers:
    n_prim = (scene.sph_rad.shape[0] + scene.qd_d.shape[0]
              + scene.tr_mat.shape[0])
    return GradBuffers(
        tex=(scene.tex_c1.shape[0], 9), img=(scene.img_data[..., 0].numel(), 3),
        prim=(n_prim, 18), mat=(scene.mat_fuzz.shape[0], 8),
        med=(scene.med_density.shape[0], 2),
        perlin=tuple(scene.perlin_vec.shape))


def grad_buffers(scene) -> GradBuffers:
    """Zeroed K6 gradient buffers on the scene's device."""
    dev = scene.sph_c0.device
    return GradBuffers(*(torch.zeros(shape, device=dev)
                         for shape in _buffer_shapes(scene)))


def leaf_grads(scene, bufs: GradBuffers) -> dict:
    """The gradient buffers as gradients of every leaf of
    :data:`FLOAT_LEAVES`: views of ``bufs``, the transpose of
    :func:`~.shade_tiled.make_tables` (and of the atlas and Perlin table,
    which K6 reads as they are)."""
    ns, nq = scene.sph_rad.shape[0], scene.qd_d.shape[0]
    sph, qd, tr = bufs.prim[:ns], bufs.prim[ns:ns + nq], bufs.prim[ns + nq:]
    return {
        "sph_c0": sph[:, 2:5], "sph_c1": sph[:, 5:8], "sph_rad": sph[:, 8],
        "qd_q": qd[:, 2:5], "qd_u": qd[:, 5:8], "qd_v": qd[:, 8:11],
        "qd_n": qd[:, 11:14], "qd_w": qd[:, 14:17], "qd_d": qd[:, 17],
        "tr_v0": tr[:, 2:5], "tr_e1": tr[:, 5:8], "tr_e2": tr[:, 8:11],
        "tr_n": tr[:, 11:14],
        "mat_fuzz": bufs.mat[:, 2], "mat_ir": bufs.mat[:, 3],
        "mat_g": bufs.mat[:, 4], "mat_sigma_s": bufs.mat[:, 5],
        "mat_sigma_a": bufs.mat[:, 6], "mat_scatter_dist": bufs.mat[:, 7],
        "tex_c1": bufs.tex[:, 1:4], "tex_c2": bufs.tex[:, 4:7],
        "tex_scale": bufs.tex[:, 7],
        "img_data": bufs.img.view(scene.img_data.shape),
        "med_density": bufs.med[:, 0], "perlin_vec": bufs.perlin}


def _check_names(names) -> None:
    bad = [n for n in names if n not in FLOAT_LEAVES]
    if bad:
        raise ValueError(f"not a floating SceneArrays leaf: {bad}")


def adjoint_plain(eng, ms, sample_idx, delta, bufs: GradBuffers,
                  full: bool = False) -> None:
    """Plain version of K6: add the gradients of sample ``sample_idx`` of
    every pixel, contracted with ``delta`` (npix, 3), to ``bufs`` (in
    place): of the colour leaves, or with ``full`` of every leaf."""
    del ms
    names = FLOAT_LEAVES if full else COLOUR_LEAVES
    g = plain_vjp(eng.scene, eng.flags, eng.bvh, eng.cam, eng.cfg, eng.key,
                  (sample_idx,), names, delta, eng.pix_offset, eng.npix)
    views = leaf_grads(eng.scene, bufs)
    for n, gn in zip(names, g):
        views[n].add_(gn)


def per_pixel_buffers(sd: int, iters: int, sss_steps: int,
                      full: bool) -> bool:
    """Whether K6 takes its instantiation with per-pixel buffers: the
    stack (``sd``), the tape (``iters`` trips) or, for the ``full``
    instantiation, the SSS walk record (``sss_steps`` trips) exceeds its
    local array (the launcher's rule, ``csrc/adjoint.cu`` adjoint_global)."""
    return (sd > kernels.MEGA_STACK or iters > TAPE_MAX
            or (full and sss_steps > WALK_MAX))


def run_adjoint(eng, a, delta, full: bool, launch, entry_bytes: int,
                budget: int) -> None:
    """Launch K6 (``launch(a)``) over the engine's pixels with the argument
    block ``a`` (``delta`` (npix, 3) and the gradient buffers set).

    Where the arrays fit the kernel's local ones, one launch.  Otherwise
    the per-pixel buffers are allocated here, ``sd`` ints of stack,
    ``iters`` tape entries of ``entry_bytes`` and, for the ``full``
    instantiation, ``sss_steps`` walk trips per pixel, and the frame runs in
    blocks of as many pixels as fit ``budget`` bytes (at least one), each
    launch on the next block (``pix_offset``, ``npix`` and ``delta``
    shifted); the gradients add up over the blocks."""
    cfg = eng.cfg
    if not per_pixel_buffers(eng.sd, cfg.iters, cfg.sss_max_steps, full):
        a.stack = a.tape = a.walk = None
        launch(a)
        return
    walk = cfg.sss_max_steps if full else 0
    per_pix = 4 * eng.sd + entry_bytes * cfg.iters + WALK_ENTRY_BYTES * walk
    block = max(1, min(eng.npix, budget // per_pix))
    dev = delta.device
    stack = torch.empty((block, eng.sd), dtype=torch.int32, device=dev)
    tape = torch.empty((block * cfg.iters * entry_bytes,), dtype=torch.uint8,
                       device=dev)
    wrec = torch.empty((block, walk, 4), device=dev) if walk else None
    a.stack, a.tape = kernels._ptr(stack), kernels._ptr(tape)
    a.walk = kernels._ptr(wrec)
    a._keep_scratch = (stack, tape, wrec)
    npix, offset = a.npix, a.pix_offset
    try:
        for start in range(0, eng.npix, block):
            a.npix = min(block, eng.npix - start)
            a.pix_offset = offset + start
            a.delta = kernels._ptr(delta[start:start + a.npix])
            launch(a)
    finally:
        a.npix, a.pix_offset, a.delta = npix, offset, kernels._ptr(delta)


def adjoint(eng, ms, sample_idx, delta, bufs: GradBuffers,
            full: bool = False) -> None:
    """K6 wrapper: the CUDA kernel (``adjoint``, or ``adjoint_full`` with
    ``full``) for CUDA state, its plain version for CPU state.
    ``eng``/``ms`` are a :class:`~.integrator.MegaEngine` and its state (the
    argument block K5 takes).  Per-pixel buffers, where the kernel needs
    them, take at most a quarter of the card's free memory
    (:func:`run_adjoint`)."""
    if not ms.ctr.is_cuda:
        return adjoint_plain(eng, ms, sample_idx, delta, bufs, full)
    dev = ms.ctr.device
    for t, shape in ((delta, (eng.npix, 3)),
                     *zip(bufs, _buffer_shapes(eng.scene))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"adjoint buffer must be float32 {shape} on "
                             f"{dev}")
    cache = getattr(ms, "_adjoint_args", None)
    if cache is None or cache[0] is not eng:
        cache = (eng, kernels.make_args(eng, ms))
        ms._adjoint_args = cache
    a = cache[1]
    a.start_sample = int(sample_idx)
    kernels.set_grad_buffers(a, delta, bufs)
    name = "adjoint_full" if full else "adjoint"
    entry = kernels.library(name).ptt_adjoint_entry_bytes(int(full))
    run_adjoint(eng, a, delta, full,
                lambda args: kernels.launch(name, eng, ms, args), entry,
                torch.cuda.mem_get_info(dev)[0] // SCRATCH_SHARE)


def kernel_vjp(scene, flags, bvh, cam, cfg, base_key, samples, names, delta,
               pix_offset: int = 0, n_pix: int | None = None):
    """K6 over ``samples``, one launch per sample → the gradients of
    ``names`` (a list of :data:`FLOAT_LEAVES`), by the colour instantiation
    when every name is a colour leaf, else by the full one.  With ``n_pix``,
    the paths of the block of frame pixels from ``pix_offset``."""
    from .integrator import MegaEngine

    _check_names(names)
    full = not set(names) <= set(COLOUR_LEAVES)
    eng = MegaEngine(scene, flags, bvh, cam, cfg, base_key, pix_offset, n_pix)
    ms = eng.init_state(torch.zeros((eng.npix, 3), device=eng.device))
    bufs = grad_buffers(scene)
    delta = delta.contiguous()
    for s in samples:
        adjoint(eng, ms, s, delta, bufs, full)
    g = leaf_grads(scene, bufs)
    return [g[n] for n in names]


class SceneRender(torch.autograd.Function):
    """Image of a sample set as a function of the scene leaves.

    ``forward(ctx, spec, *leaves)``: ``spec`` carries the detached scene,
    flags, BVH, camera, config, key, sample range, the leaf names and the
    forward engine ``spec["forward"](scene) -> (image (H, W, 3), aux)``;
    ``aux`` lands in ``spec["aux"]``.  ``backward`` replays the samples.
    """

    @staticmethod
    def forward(ctx, spec, *leaves):
        image, spec["aux"] = spec["forward"](spec["scene"])
        ctx.spec = spec
        return image

    @staticmethod
    def backward(ctx, delta):
        sp = ctx.spec
        scene, cfg, n_pix = sp["scene"], sp["cfg"], sp["n_pix"]
        n = n_pix if n_pix is not None else cfg.width * cfg.height
        delta = delta.reshape(n, 3).to(torch.float32)
        args = (scene, sp["flags"], sp["bvh"], sp["cam"], cfg, sp["key"],
                sp["samples"], sp["names"], delta, sp["pix_offset"], n_pix)
        grads = kernel_vjp(*args) if delta.is_cuda else plain_vjp(*args)
        return (None, *grads)


def render_diff(scene, flags, bvh, cam, cfg, base_key, samples, forward,
                pix_offset: int = 0, n_pix: int | None = None):
    """Differentiable sum of ``samples`` over every pixel → (image, aux).

    ``forward(scene)`` renders the same sample set with a forward engine
    and returns ``(image, aux)``.  The leaves are the scene's floating
    fields that require grad.  With ``n_pix``, over the block of frame
    pixels ``pix_offset ..`` ``+ n_pix`` (the image is then the block's
    ``(n_pix, 3)``)."""
    names, leaves = grad_leaves(scene)
    detached = dataclasses.replace(scene, **{n: x.detach() for n, x in
                                             zip(names, leaves)})
    spec = {"scene": detached, "flags": flags, "bvh": bvh, "cam": cam,
            "cfg": cfg, "key": base_key, "samples": tuple(samples),
            "names": names, "forward": forward,
            "pix_offset": int(pix_offset), "n_pix": n_pix}
    image = SceneRender.apply(spec, *leaves)
    return image, spec["aux"]
