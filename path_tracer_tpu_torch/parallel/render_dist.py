"""Rendering and training over ranks: the mesh, data parallelism, the step.

Port of ``path_tracer_tpu/parallel/render_dist.py``: ``make_mesh`` (:31),
``init_distributed`` (:38), ``global_mesh`` (:61), ``_shard_map``'s role
(:186, here :class:`Mesh` and its axes), ``_pixel_blocks`` (:200),
``render_distributed`` (:68), ``render_sharded`` (:207),
``render_sharded_wavefront`` (:247), ``calibrate_n_waves`` (:284) and
``make_train_step`` (:300).

One rank of a ``torch.distributed`` job is one device of the JAX mesh.
NCCL is the backend with one card per rank; gloo serves CPU processes and
ranks that share one card (NCCL refuses two ranks on one device).  The data
parallel modes give each rank a contiguous block of frame pixels (the last
block padded: its tail pixels are traced and dropped) and replicate the
scene; the forward needs no collective, and the image is assembled by one
sum over the ranks.  The train step sums the loss, the gradients and the
path counts over the ranks, as JAX's ``psum`` does.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import integrator, integrator_tiled, wavefront
from ..ops.types import RenderConfig
from ..utils import rng


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str | None = None) -> None:
    """Join a ``num_processes``-rank job whose rank 0 listens on
    ``coordinator`` (``host:port``).  The backend defaults to NCCL when a
    card is present (each rank then takes card ``process_id`` modulo the
    card count), else gloo; pass ``backend="gloo"`` for ranks that share
    one card."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


class Axis:
    """One mesh axis as a process group, with the collectives the JAX
    package's ``shard_map`` programs run over an axis: ``pmin``, ``psum``,
    ``pmax``, the masked-sum broadcast and the ring ``ppermute``.

    ``index`` is this rank's place on the axis and ``size`` its length; an
    axis of one rank makes every collective the identity.  Under gloo a
    card tensor is copied to the host and back around each collective.
    """

    def __init__(self, group, ranks):
        self.group, self.ranks = group, list(ranks)
        self.size = len(self.ranks)
        self.index = (self.ranks.index(dist.get_rank()) if self.size > 1
                      else 0)

    def _via_host(self, x) -> bool:
        return x.is_cuda and dist.get_backend(self.group) == "gloo"

    def _reduce(self, x, op):
        if self.size == 1:
            return x
        y = x.cpu() if self._via_host(x) else x.contiguous()
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def pmin(self, x):
        return self._reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def psum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def bcast(self, owner, x):
        """The owning rank's values on every rank: a sum of ``x`` masked by
        ``owner`` (per lane, broadcast along trailing dims); bools ride as
        int32 (JAX's ``_bcast``, ``scene_shard.py:145-157``)."""
        own = owner.reshape(owner.shape + (1,) * (x.ndim - owner.ndim))
        if x.dtype == torch.bool:
            return self.psum(torch.where(own, x.to(torch.int32), 0)).bool()
        return self.psum(torch.where(own, x, torch.zeros_like(x)))

    def ppermute_next(self, x):
        """Send ``x`` to the next rank of the ring and receive the
        previous rank's (``ppermute`` with ``(i, i + 1 mod n)``)."""
        if self.size == 1:
            return x
        host = self._via_host(x)
        send = x.cpu() if host else x.contiguous()
        recv = torch.empty_like(send)
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        ops = [dist.P2POp(dist.isend, send, nxt, self.group),
               dist.P2POp(dist.irecv, recv, prv, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(x.device)


class Mesh:
    """The ranks of the job laid out row-major on named axes (``shape``:
    axis → size), one rank per device.  ``axis(name)`` is the process
    group of the ranks that differ only along that axis; ``world()`` spans
    every rank.  A mesh of one rank needs no initialised job."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.size = math.prod(self.shape.values())
        if self.size == 1 and not dist.is_initialized():
            self.rank = 0
        else:
            if not dist.is_initialized() or dist.get_world_size() != self.size:
                raise ValueError(
                    f"a mesh of {self.size} devices needs a torch.distributed "
                    f"job of {self.size} ranks (init_distributed)")
            self.rank = dist.get_rank()
        names, sizes = list(self.shape), list(self.shape.values())
        strides = [math.prod(sizes[k + 1:]) for k in range(len(sizes))]
        self.coords = {n: (self.rank // s) % z
                       for n, s, z in zip(names, strides, sizes)}
        self._axes = {}
        for k, name in enumerate(names):
            # Every rank creates every group, in the same order.
            for base in range(self.size):
                if (base // strides[k]) % sizes[k]:
                    continue
                ranks = [base + j * strides[k] for j in range(sizes[k])]
                group = self._group(ranks)
                if self.rank in ranks:
                    self._axes[name] = Axis(group, ranks)
        self._world = Axis(self._group(list(range(self.size))),
                           range(self.size))

    def _group(self, ranks):
        if len(ranks) == 1 or len(ranks) == self.size:
            return None if len(ranks) == 1 else dist.group.WORLD
        return dist.new_group(ranks)

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def world(self) -> Axis:
        return self._world


def make_mesh(n_devices=None, axis="d") -> Mesh:
    """A mesh over ``n_devices`` ranks (default: every rank of the job, or
    one without a job) on ``axis``; a tuple of sizes with a tuple of names
    lays the ranks out on several axes, e.g. ``make_mesh((2, 2), ("d",
    "t"))``."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if isinstance(n_devices, int):
        n_devices, axis = (n_devices,), (axis,)
    return Mesh(dict(zip(axis, n_devices)))


def global_mesh(axis: str = "d") -> Mesh:
    """1-D mesh over every rank of the job."""
    return make_mesh(None, axis)


def render_distributed(world, camera, *, engine_cfg: RenderConfig | None = None,
                       spp: int | None = None, seed: int = 0,
                       queue_size: int = 4096, steps_per_wave: int = 16,
                       checkpoint_path: str | None = None,
                       checkpoint_every: int = 0, batch: int = 0,
                       device="cuda") -> np.ndarray:
    """Render ``world`` seen by ``camera`` over every rank of the job → the
    (H, W, 3) mean as a numpy array, the same on every rank (rank 0 writes
    it).  Every rank must call it with the same arguments.

    Each rank compiles the scene and builds the BVH on ``device``, then the
    wavefront renders data-parallel over :func:`global_mesh`
    (:func:`render_sharded_wavefront`) in rounds of ``batch`` samples
    (default ``checkpoint_every``, else ``spp``) from the first sample not
    yet done.  With ``checkpoint_path`` rank 0 writes ``{accum,
    samples_done, fingerprint}`` (the sum of the samples done) through a
    ``.tmp.npz`` file and ``os.replace`` whenever a multiple of
    ``checkpoint_every`` samples is passed, at the end and on
    ``KeyboardInterrupt``; a job started on an existing checkpoint resumes
    from it, and refuses one whose fingerprint (scene, camera,
    configuration, ``seed``, ``queue_size``, ``steps_per_wave``) differs.
    Each (sample, pixel) radiance is fixed by the RNG folds, so a resumed
    run whose rounds start where the uninterrupted run's did gives that
    run's image bit for bit.  With a checkpoint, no rank returns before rank
    0 has written the last one.
    """
    from ..models.compile import compile_scene
    from ..ops.bvh_build import build_from_scene
    from ..ops.shade import SceneFlags
    from ..render.renderer import fingerprint, save_npz

    cfg = engine_cfg or RenderConfig(
        width=camera.img_width, height=camera.img_height,
        samples_per_pixel=camera.samples_per_pixel,
        max_depth=camera.max_depth)
    spp = spp if spp is not None else cfg.samples_per_pixel
    dev = torch.device(device)
    scene = compile_scene(world, device=dev)
    bvh = build_from_scene(scene)
    flags = SceneFlags.from_scene(scene)
    cam = camera.initialize(device=dev)
    mesh = global_mesh()
    digest = fingerprint(scene, cam, cfg, seed, queue_size, steps_per_wave)

    accum = np.zeros((cfg.height, cfg.width, 3), np.float32)
    done = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            saved = str(z["fingerprint"])
            if saved != digest:
                raise ValueError(
                    f"checkpoint {checkpoint_path!r} was written by a "
                    f"different scene/camera/config (fingerprint "
                    f"{saved[:12]}… != {digest[:12]}…)")
            accum = z["accum"].astype(np.float32)
            done = int(z["samples_done"])
        print(f"resuming at sample {done}/{spp}", flush=True)

    def save():
        if checkpoint_path and mesh.rank == 0:
            save_npz(checkpoint_path, accum=accum, samples_done=done,
                     fingerprint=digest)

    step = batch or checkpoint_every or spp
    key = rng.key(seed, device=dev)
    last_saved = done // checkpoint_every if checkpoint_every else 0
    try:
        while done < spp:
            n = min(step, spp - done)
            img = render_sharded_wavefront(
                scene, flags, bvh, cam, cfg, key, mesh, spp=n,
                queue_size=queue_size, steps_per_wave=steps_per_wave,
                start_sample=done)
            # One commit: an interrupt lands before or after both move.
            accum, done = accum + img.cpu().numpy() * n, done + n
            print(f"sample {done}/{spp}", flush=True)
            if (checkpoint_every and done // checkpoint_every > last_saved
                    and done < spp):
                last_saved = done // checkpoint_every
                save()
    except KeyboardInterrupt:
        save()
        raise
    save()
    if checkpoint_path and dist.is_initialized():
        dist.barrier()          # no rank returns before the file is written
    return accum / max(done, 1)


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, Mesh):
        return mesh.size
    raise TypeError(f"mesh must be None or a Mesh (make_mesh), not "
                    f"{type(mesh).__name__}")


def _pixel_blocks(cfg: RenderConfig, n_dev: int):
    """(pixels per block, frame pixels): block ``r`` is the frame pixels
    ``r * per ..`` ``+ per``; the padded tail pixels are traced and
    dropped."""
    npix = cfg.width * cfg.height
    return -(-npix // n_dev), npix


def _block(mesh: Mesh, cfg: RenderConfig):
    """(pixel offset, pixels per block, frame pixels) of this rank."""
    per, npix = _pixel_blocks(cfg, mesh.size)
    return mesh.rank * per, per, npix


class _Assemble(torch.autograd.Function):
    """This rank's block placed in the frame, summed over the ranks; the
    backward hands the block its slice of the frame's gradient."""

    @staticmethod
    def forward(ctx, block, axis, off, n_blocks, npix):
        per = block.shape[0]
        ctx.off, ctx.per, ctx.pad = off, per, n_blocks * per - npix
        full = torch.zeros((n_blocks * per, 3), device=block.device)
        full[off:off + per] = block
        return axis.psum(full)[:npix]

    @staticmethod
    def backward(ctx, g):
        g = torch.cat([g, g.new_zeros((ctx.pad, 3))])
        return g[ctx.off:ctx.off + ctx.per], None, None, None, None


def assemble(block, axis: Axis, off: int, npix: int, cfg: RenderConfig):
    """The (H, W, 3) frame from every rank's pixel block (one sum over
    ``axis``); differentiable with respect to this rank's block."""
    n_blocks = -(-npix // block.shape[0])
    full = _Assemble.apply(block, axis, off, n_blocks, npix)
    return full.reshape(cfg.height, cfg.width, 3)


def render_sharded(scene, flags, bvh, cam, cfg: RenderConfig, base_key,
                   mesh: Mesh, spp: int, differentiable: bool = False):
    """Render ``spp`` samples with pixels sharded over the ranks → the
    (H, W, 3) mean on every rank: each rank runs the megakernel (K5) over
    its block.  With ``differentiable`` the block differentiates as
    ``integrator.render(differentiable=True)`` does (K6 on the card); each
    rank's leaf gradients then cover its own block, so sum them over the
    ranks for the frame's (``make_train_step`` does)."""
    off, per, npix = _block(mesh, cfg)

    def forward(sc):
        zero = torch.zeros((per, 3), device=sc.sph_c0.device)
        return integrator.render_batch(sc, flags, bvh, cam, cfg, zero, 0, spp,
                                       base_key, with_stats=True,
                                       pix_offset=off, n_pix=per)

    if differentiable:
        from ..ops import adjoint
        block, _ = adjoint.render_diff(scene, flags, bvh, cam, cfg, base_key,
                                       range(spp), forward, off, per)
    else:
        block, _ = forward(scene)
    return assemble(block / spp, mesh.world(), off, npix, cfg)


def render_sharded_wavefront(scene, flags, bvh, cam, cfg: RenderConfig,
                             base_key, mesh: Mesh, spp: int = 1,
                             queue_size: int = 4096,
                             steps_per_wave: int = 24,
                             start_sample: int = 0, with_stats: bool = False):
    """Data-parallel wavefront render → the (H, W, 3) mean on every rank:
    each rank runs its own slot pool (K1-K4) over its pixel block.  The RNG
    folds frame pixels, so the image equals the one-rank render up to the
    per-pixel add order.  With ``with_stats`` also returns the counters
    (``SUMMED_STATS``, padded pixels' paths included) summed over the ranks
    and ``waves``, the most any rank ran."""
    off, per, npix = _block(mesh, cfg)
    zero = torch.zeros((per, 3), device=scene.sph_c0.device)
    block, st = wavefront.render_batch(scene, flags, bvh, cam, cfg, zero,
                                       start_sample, spp, base_key,
                                       queue_size=queue_size,
                                       steps_per_wave=steps_per_wave,
                                       pix_offset=off, n_pix=per,
                                       with_stats=True)
    image = assemble(block / spp, mesh.world(), off, npix, cfg)
    if not with_stats:
        return image
    # the engine's counters may be on the host; the collectives take the
    # block's device
    world, dev = mesh.world(), zero.device
    counts = world.psum(torch.cat([torch.stack([st[k] for k in SUMMED_STATS]),
                                   st["depth_hist"].to(torch.int64)]).to(dev))
    stats = {k: counts[i] for i, k in enumerate(SUMMED_STATS)}
    stats["depth_hist"] = counts[len(SUMMED_STATS):]
    stats["waves"] = world.pmax(st["waves"].reshape(1).to(dev))[0]
    return image, stats


SUMMED_STATS = ("paths", "rays", "depth_sum", "trav_steps", "walk_steps",
                "stack_overflows")


def calibrate_n_waves(scene, flags, bvh, cam, cfg: RenderConfig, key,
                      spp: int = 1, queue_size: int = 4096,
                      steps_per_wave: int = 12, margin: float = 1.5,
                      mesh: Mesh | None = None) -> int:
    """Size ``render_batch_diff``'s wave budget: one stats forward of the
    pixel block this rank renders in ``make_train_step`` (the whole frame
    on one rank), its wave count padded by ``margin`` plus 8, the largest
    over the ranks."""
    n_dev = _mesh_size(mesh)
    per, _ = _pixel_blocks(cfg, n_dev)
    off = mesh.rank * per if n_dev > 1 else 0
    accum = torch.zeros((per, 3), device=scene.sph_c0.device)
    _, stats = wavefront.render_batch(scene, flags, bvh, cam, cfg, accum, 0,
                                      spp, key, queue_size=queue_size,
                                      steps_per_wave=steps_per_wave,
                                      with_stats=True, pix_offset=off,
                                      n_pix=per)
    n = int(int(stats["waves"]) * margin) + 8
    if n_dev > 1:
        n = int(mesh.world().pmax(torch.tensor([n], device=accum.device)))
    return n


def make_train_step(flags, cfg: RenderConfig, mesh=None, spp: int = 1,
                    lr: float = 1e-2, engine: str = "wavefront",
                    queue_size: int = 4096, steps_per_wave: int = 12,
                    n_waves: int = 192, unbiased: bool = False,
                    ckpt_every: int = 1):
    """Build a data-parallel SGD step on scene parameters.

    ``params`` is a dict of ``SceneArrays`` leaf overrides (``tex_c1``,
    ``img_data``, ...).  Each rank renders its pixel block and
    differentiates its share of JAX's loss, ``sum(wt * (img - target)^2) /
    (npix * 3)`` with weight 0 on padded pixels; with ``unbiased=True`` two
    independent renders, keys ``fold_in(key, 1)`` and ``fold_in(key, 2)``,
    and the surrogate ``sum(2 * sg(X_a - t) * X_b)``, whose gradient is
    unbiased; the reported loss is the MSE of the two renders' mean.
    Render ``a`` runs forward only: the backward replays render ``b``.  The
    loss, the gradients and the path counts are summed over the ranks, and
    the update is ``p - lr * g``, the same on every rank.

    ``engine="wavefront"`` renders with ``wavefront.render_batch_diff``
    (K1-K4 forward, K6 backward on the card); size ``n_waves`` with
    :func:`calibrate_n_waves`, and ``aux["paths_done"] ==
    aux["paths_total"]`` certifies that every path was integrated.
    ``engine="megakernel"`` renders with the tiled fixed-trip engine
    (``integrator_tiled.render_tiled``: K7 + K8 forward, K6 backward), as
    JAX does, and reports zero path counts, as JAX does.

    ``mesh`` is None (one device) or a :class:`Mesh`.  Returns
    ``step(params, scene, bvh, cam, key, target) -> (new_params, loss,
    grads, aux)``.
    """
    n_dev = _mesh_size(mesh)
    if engine not in ("wavefront", "megakernel"):
        raise ValueError(f"unknown engine {engine!r}")
    per, npix = _pixel_blocks(cfg, n_dev)
    off = mesh.rank * per if n_dev > 1 else 0

    def render_once(scene_p, bvh, cam, key):
        dev = scene_p.sph_c0.device
        if engine == "wavefront":
            zero = torch.zeros((per, 3), device=dev)
            img, stats = wavefront.render_batch_diff(
                scene_p, flags, bvh, cam, cfg, zero, 0, spp, key,
                queue_size=queue_size, steps_per_wave=steps_per_wave,
                n_waves=n_waves, ckpt_every=ckpt_every, pix_offset=off,
                n_pix=per)
            aux = {"paths_done": int(stats["paths"]),
                   "paths_total": int(stats["total"])}
            return img / spp, aux
        img = integrator_tiled.render_tiled(scene_p, flags, bvh, cam, cfg, key,
                                            spp, pix_offset=off, n_pix=per)
        return img, {"paths_done": 0, "paths_total": 0}

    def step(params, scene, bvh, cam, key, target):
        dev = scene.sph_c0.device
        idx = torch.arange(off, off + per, device=dev)
        wt = (idx < npix).to(torch.float32)[:, None]
        tgt = target.reshape(-1, 3).to(dev)
        tgt = torch.cat([tgt, torch.zeros((per * n_dev - npix, 3), device=dev)])
        tgt = tgt[off:off + per]
        names = list(params)
        xs = [params[n].detach().to(dev).requires_grad_() for n in names]
        scene_p = dataclasses.replace(scene, **dict(zip(names, xs)))
        if not unbiased:
            acc, aux = render_once(scene_p, bvh, cam, key)
            loss = torch.sum(wt * (acc - tgt) ** 2) / (npix * 3)
        else:
            with torch.no_grad():
                acc_a, aux_a = render_once(scene_p, bvh, cam,
                                           rng.fold_in(key, 1))
            acc_b, aux_b = render_once(scene_p, bvh, cam, rng.fold_in(key, 2))
            resid = acc_a - tgt
            surrogate = torch.sum(wt * 2.0 * resid * acc_b) / (npix * 3)
            mse = torch.sum(wt * (0.5 * (acc_a + acc_b.detach()) - tgt) ** 2
                            ) / (npix * 3)
            loss = surrogate - surrogate.detach() + mse
            aux = {k: aux_a[k] + aux_b[k] for k in aux_a}
        grads = list(torch.autograd.grad(loss, xs))
        loss = loss.detach()
        if n_dev > 1:
            world = mesh.world()
            loss = world.psum(loss)
            grads = [world.psum(g) for g in grads]
            counts = world.psum(torch.tensor(
                [aux["paths_done"], aux["paths_total"]], device=dev))
            aux = {"paths_done": int(counts[0]), "paths_total": int(counts[1])}
        grads = dict(zip(names, grads))
        new_params = {n: params[n].detach().to(dev) - lr * grads[n]
                      for n in names}
        return new_params, loss, grads, aux

    return step
