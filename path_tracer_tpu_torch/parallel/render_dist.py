"""The train step on scene parameters, and the wave budget it needs.

Port of ``calibrate_n_waves`` (``path_tracer_tpu/parallel/render_dist.py:284``)
and ``make_train_step`` (:300-425) for one device: the loss, its unbiased
two-render form and the SGD update are JAX's; the pixel blocks are those of
a one-device mesh.  More devices (the data-parallel step with an all-reduce
of the gradients) are ROADMAP.md A.11/B14.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import integrator, wavefront
from ..ops.types import RenderConfig
from ..utils import rng


def calibrate_n_waves(scene, flags, bvh, cam, cfg: RenderConfig, key,
                      spp: int = 1, queue_size: int = 4096,
                      steps_per_wave: int = 12, margin: float = 1.5) -> int:
    """Size ``render_batch_diff``'s wave budget: one stats forward, its wave
    count padded by ``margin`` plus 8."""
    accum = torch.zeros((cfg.height, cfg.width, 3), device=scene.sph_c0.device)
    _, stats = wavefront.render_batch(scene, flags, bvh, cam, cfg, accum, 0,
                                      spp, key, queue_size=queue_size,
                                      steps_per_wave=steps_per_wave,
                                      with_stats=True)
    return int(int(stats["waves"]) * margin) + 8


def _pixel_blocks(cfg: RenderConfig, n_dev: int, device):
    """Pixel indices per device (padded to equal blocks) and the pixel count."""
    npix = cfg.width * cfg.height
    per = -(-npix // n_dev)
    idx = torch.arange(per * n_dev, dtype=torch.int32, device=device)
    return idx.reshape(n_dev, per), npix


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    devices = getattr(mesh, "devices", mesh)
    return int(getattr(devices, "size", None) or len(devices))


def make_train_step(flags, cfg: RenderConfig, mesh=None, spp: int = 1,
                    lr: float = 1e-2, engine: str = "wavefront",
                    queue_size: int = 4096, steps_per_wave: int = 12,
                    n_waves: int = 192, unbiased: bool = False,
                    ckpt_every: int = 1):
    """Build an SGD step on scene parameters (one device).

    ``params`` is a dict of ``SceneArrays`` leaf overrides (``tex_c1``,
    ``img_data``, ...).  The loss is JAX's: the per-pixel weight of the
    device's pixel block, ``sum(wt * (img - target)^2) / (npix * 3)``; with
    ``unbiased=True`` two independent renders, keys ``fold_in(key, 1)`` and
    ``fold_in(key, 2)``, and the surrogate ``sum(2 * sg(X_a - t) * X_b)``,
    whose gradient is unbiased; the reported loss is the MSE of the two
    renders' mean.  Render ``a`` runs forward only: the backward replays
    render ``b``.  The update is ``p - lr * g``.

    ``engine="wavefront"`` renders with ``wavefront.render_batch_diff`` (K1-
    K4 forward, K6 backward on the card); size ``n_waves`` with
    :func:`calibrate_n_waves`, and ``aux["paths_done"] ==
    aux["paths_total"]`` certifies that every path was integrated.
    ``engine="megakernel"`` renders with ``integrator.render(differentiable
    =True)`` (K5 forward, K6 backward); JAX runs its tiled fixed-trip engine
    there (``integrator_tiled``, ROADMAP.md B12), which integrates the same
    sample set, and reports zero path counts, as here.

    ``mesh`` is None or a one-device mesh (an object with ``devices``, or a
    sequence of devices); more devices raise (ROADMAP.md A.11/B14).

    Returns ``step(params, scene, bvh, cam, key, target) -> (new_params,
    loss, grads, aux)``.
    """
    n_dev = _mesh_size(mesh)
    if n_dev != 1:
        raise NotImplementedError(
            f"make_train_step on {n_dev} devices: the data-parallel step "
            f"(gradient all-reduce) is not ported yet (ROADMAP.md A.11/B14)")
    if engine not in ("wavefront", "megakernel"):
        raise ValueError(f"unknown engine {engine!r}")

    def render_once(scene_p, bvh, cam, key):
        dev = scene_p.sph_c0.device
        if engine == "wavefront":
            zero = torch.zeros((cfg.height, cfg.width, 3), device=dev)
            img, stats = wavefront.render_batch_diff(
                scene_p, flags, bvh, cam, cfg, zero, 0, spp, key,
                queue_size=queue_size, steps_per_wave=steps_per_wave,
                n_waves=n_waves, ckpt_every=ckpt_every)
            aux = {"paths_done": int(stats["paths"]),
                   "paths_total": int(stats["total"])}
            return img / spp, aux
        img = integrator.render(scene_p, flags, bvh, cam, cfg, key,
                                differentiable=True, spp=spp)
        return img, {"paths_done": 0, "paths_total": 0}

    def step(params, scene, bvh, cam, key, target):
        dev = scene.sph_c0.device
        idxs, npix = _pixel_blocks(cfg, n_dev, dev)
        wt = (idxs[0] < npix).to(torch.float32)[:, None]
        tgt = target.reshape(-1, 3).to(dev)
        pad = idxs.numel() - tgt.shape[0]
        tgt = torch.cat([tgt, torch.zeros((pad, 3), device=dev)])
        names = list(params)
        xs = [params[n].detach().to(dev).requires_grad_() for n in names]
        scene_p = dataclasses.replace(scene, **dict(zip(names, xs)))

        def flat(img):
            img = img.reshape(-1, 3)
            return torch.cat([img, torch.zeros((pad, 3), device=dev)])

        if not unbiased:
            acc, aux = render_once(scene_p, bvh, cam, key)
            loss = torch.sum(wt * (flat(acc) - tgt) ** 2) / (npix * 3)
        else:
            with torch.no_grad():
                acc_a, aux_a = render_once(scene_p, bvh, cam,
                                           rng.fold_in(key, 1))
            acc_b, aux_b = render_once(scene_p, bvh, cam, rng.fold_in(key, 2))
            acc_a, acc_b = flat(acc_a), flat(acc_b)
            resid = acc_a - tgt
            surrogate = torch.sum(wt * 2.0 * resid * acc_b) / (npix * 3)
            mse = torch.sum(wt * (0.5 * (acc_a + acc_b.detach()) - tgt) ** 2
                            ) / (npix * 3)
            loss = surrogate - surrogate.detach() + mse
            aux = {k: aux_a[k] + aux_b[k] for k in aux_a}
        grads = torch.autograd.grad(loss, xs)
        grads = dict(zip(names, grads))
        new_params = {n: params[n].detach().to(dev) - lr * grads[n]
                      for n in names}
        return new_params, loss.detach(), grads, aux

    return step
