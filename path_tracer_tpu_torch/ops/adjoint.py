"""The backward of the shading (B13): image gradients for the scene leaves.

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
* CUDA tensors: kernel K6 :func:`adjoint` (``csrc/adjoint.cu``) for the
  colour leaves ``tex_c1``, ``tex_c2`` and ``img_data``.  They enter a path
  linearly — every attenuation is a texture colour, or colour^(n+1) after
  the SSS walk's n kept steps, and emission is ``throughput * colour`` — so
  their adjoint is a replay of the path and a reverse sweep over it.  Any
  other leaf that requires grad raises :class:`NotImplementedError` before
  anything runs (ROADMAP.md B13'); nothing falls back to the twin.

K6 writes into gradient buffers shaped like columns 1-6 of
:class:`~.shade_tiled.ShadeTables` ``tex`` (``[c1(3), c2(3)]`` per row) and
like ``img_data`` flattened to ``(texels, 3)``; :func:`leaf_grads` maps them
to the leaves.
"""
from __future__ import annotations

import dataclasses

import torch

from . import kernels

COLOUR_LEAVES = ("tex_c1", "tex_c2", "img_data")
TAPE_MAX = 64   # per-thread tape entries of K6 (PTT_TAPE_MAX, csrc/adjoint.cu)
_UNPORTED = ("the card's adjoint covers the colour leaves tex_c1, tex_c2 and "
             "img_data; gradients for {} need the direction- and "
             "position-dependent adjoint in K6 (ROADMAP.md B13')")


def grad_leaves(scene) -> tuple[list[str], list[torch.Tensor]]:
    """Names and tensors of the scene's floating fields that require grad."""
    names, leaves = [], []
    for f in dataclasses.fields(scene):
        x = getattr(scene, f.name)
        if isinstance(x, torch.Tensor) and x.requires_grad:
            names.append(f.name)
            leaves.append(x)
    return names, leaves


def check_leaves(names, on_card: bool) -> None:
    """Raise unless the backward that will run can differentiate ``names``:
    every leaf on the CPU, only :data:`COLOUR_LEAVES` on the card."""
    other = [n for n in names if n not in COLOUR_LEAVES]
    if on_card and other:
        raise NotImplementedError(_UNPORTED.format(", ".join(other)))


def plain_vjp(scene, flags, bvh, cam, cfg, base_key, samples, names, delta):
    """The plain path: autograd of the twin's replay of ``samples``,
    contracted with ``delta`` (npix, 3) per sample → one gradient per name
    (zero for a leaf that enters no path)."""
    from .integrator import trace_sample

    xs = [getattr(scene, n).detach().requires_grad_() for n in names]
    sc = dataclasses.replace(scene, **dict(zip(names, xs)))
    grads = [torch.zeros_like(x) for x in xs]
    with torch.enable_grad():
        for s in samples:
            col = trace_sample(sc, flags, bvh, cam, cfg, base_key, s)[0].color
            gs = torch.autograd.grad(col, xs, delta, allow_unused=True)
            for g, gi in zip(grads, gs):
                if gi is not None:
                    g.add_(gi)
    return grads


# ---------------------------------------------------------------------------
# K6: the adjoint of one sample for the colour leaves.
# ---------------------------------------------------------------------------

def grad_buffers(scene):
    """Zeroed K6 gradient buffers: ``g_tex`` (T, 6) and ``g_img``
    (texels, 3) on the scene's device."""
    dev = scene.tex_c1.device
    return (torch.zeros((scene.tex_c1.shape[0], 6), device=dev),
            torch.zeros((scene.img_data[..., 0].numel(), 3), device=dev))


def leaf_grads(scene, g_tex, g_img) -> dict:
    """The gradient buffers as gradients of the colour leaves."""
    return {"tex_c1": g_tex[:, :3], "tex_c2": g_tex[:, 3:],
            "img_data": g_img.reshape(scene.img_data.shape)}


def adjoint_plain(eng, ms, sample_idx, delta, g_tex, g_img) -> None:
    """Plain version of K6: add the colour-leaf gradients of sample
    ``sample_idx`` of every pixel, contracted with ``delta`` (npix, 3), to
    ``g_tex`` and ``g_img`` (in place)."""
    del ms
    g = plain_vjp(eng.scene, eng.flags, eng.bvh, eng.cam, eng.cfg, eng.key,
                  (sample_idx,), COLOUR_LEAVES, delta)
    g_tex[:, :3] += g[0]
    g_tex[:, 3:] += g[1]
    g_img += g[2].reshape(-1, 3)


def adjoint(eng, ms, sample_idx, delta, g_tex, g_img) -> None:
    """K6 wrapper: the CUDA kernel for CUDA state, its plain version for
    CPU state.  ``eng``/``ms`` are a :class:`~.integrator.MegaEngine` and
    its state (the argument block K5 takes)."""
    if not ms.ctr.is_cuda:
        return adjoint_plain(eng, ms, sample_idx, delta, g_tex, g_img)
    from .integrator import MEGA_STACK

    if eng.sd > MEGA_STACK:
        raise ValueError(f"stack depth {eng.sd} exceeds the adjoint's "
                         f"per-thread stack of {MEGA_STACK}")
    if eng.cfg.iters > TAPE_MAX:
        raise ValueError(f"{eng.cfg.iters} loop trips exceed the adjoint's "
                         f"tape of {TAPE_MAX} entries")
    for t, shape in ((delta, (eng.npix, 3)), (g_tex, (eng.tabs.tex.shape[0], 6)),
                     (g_img, (eng.scene.img_data[..., 0].numel(), 3))):
        if t.device != ms.ctr.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"adjoint buffer must be float32 {shape} on "
                             f"{ms.ctr.device}")
    cache = getattr(ms, "_adjoint_args", None)
    if cache is None or cache[0] is not eng:
        cache = (eng, kernels.make_args(eng, ms))
        ms._adjoint_args = cache
    a = cache[1]
    a.start_sample = int(sample_idx)
    kernels.set_grad_buffers(a, delta, g_tex, g_img)
    kernels.launch("adjoint", eng, ms, a)


def kernel_vjp(scene, flags, bvh, cam, cfg, base_key, samples, delta):
    """K6 over ``samples``, one launch per sample → colour-leaf gradients."""
    from .integrator import MegaEngine

    eng = MegaEngine(scene, flags, bvh, cam, cfg, base_key)
    ms = eng.init_state(torch.zeros((eng.npix, 3), device=eng.device))
    g_tex, g_img = grad_buffers(scene)
    delta = delta.contiguous()
    for s in samples:
        adjoint(eng, ms, s, delta, g_tex, g_img)
    return leaf_grads(scene, g_tex, g_img)


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
        scene, cfg = sp["scene"], sp["cfg"]
        delta = delta.reshape(cfg.width * cfg.height, 3).to(torch.float32)
        args = (scene, sp["flags"], sp["bvh"], sp["cam"], cfg, sp["key"],
                sp["samples"])
        if delta.is_cuda:
            g = kernel_vjp(*args, delta)
            grads = [g[n] for n in sp["names"]]
        else:
            grads = plain_vjp(*args, sp["names"], delta)
        return (None, *grads)


def render_diff(scene, flags, bvh, cam, cfg, base_key, samples, forward):
    """Differentiable sum of ``samples`` over every pixel → (image, aux).

    ``forward(scene)`` renders the same sample set with a forward engine
    and returns ``(image, aux)``.  The leaves are the scene's floating
    fields that require grad; on the card they must be colour leaves."""
    names, leaves = grad_leaves(scene)
    check_leaves(names, scene.sph_c0.is_cuda)
    detached = dataclasses.replace(scene, **{n: x.detach() for n, x in
                                             zip(names, leaves)})
    spec = {"scene": detached, "flags": flags, "bvh": bvh, "cam": cam,
            "cfg": cfg, "key": base_key, "samples": tuple(samples),
            "names": names, "forward": forward}
    image = SceneRender.apply(spec, *leaves)
    return image, spec["aux"]
