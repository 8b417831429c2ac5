"""Inverse-rendering demos on one card: recover known scene parameters.

    python path_tracer_tpu_torch/scripts/train_demo.py [--steps N] [--cpu]
        [--texture] [--out DIR]

The port of ``tools/train_demo.py``.  :func:`run_demo` perturbs the Cornell
box's light emission (halved) and one wall albedo (repainted), renders a
target at the true parameters with a key no step sees, and optimises the
texture table back with the unbiased train step of
:func:`~..parallel.make_train_step` (the wavefront forward, K1-K4, and the
colour instantiation of K6 backward on the card), Adam under a cosine
decay (:func:`adam_cosine`, optax's ``adam(cosine_decay_schedule(...))``
in optax's arithmetic),
the parameters projected to >= 0 after each step and Polyak-averaged over
the tail.  :func:`run_texture_demo` recovers an 8x8 texture image through
the ``img_data`` leaf of ``scenes.texture_demo``.

``main`` writes ``train_demo.jsonl`` and ``train_demo.png`` (or
``train_texture.*`` with ``--texture``) under ``--out`` (default
``chiprun_out/``), prints RECOVERED or NOT, and exits 0 or 1 by JAX's
rules: both relative errors below 5%, or a texel mean |err| below 0.03.
``--cpu`` runs the plain-torch twins.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


class Adam(torch.optim.Optimizer):
    """Adam in optax's arithmetic (``optax.scale_by_adam``): ``mu = (1 -
    b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the update ``-lr (mu /
    c1) / (sqrt(nu / c2) + eps)`` with ``c = 1 - b^t`` rounded to float32
    as optax rounds it.  ``torch.optim.Adam`` computes ``c`` in float64 (at
    step 1, ``1 - 0.999`` differs by up to 6e-5 relative from optax's) and
    moves ``mu`` by ``lerp``; over 20 steps of ``tests/test_torch_demo.py``
    its parameters drift 6.9e-6 relative from optax's, this one's 1.05e-7
    (``tests/torch_golden_trace.py adam``)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            (b1, b2), eps, lr = group["betas"], group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(count=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
                g = p.grad
                st["count"] += 1
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                c1, c2 = (1 - torch.tensor(float(np.float32(b)) ** st["count"],
                                           dtype=p.dtype, device=p.device)
                          for b in (b1, b2))
                p.add_(-lr * ((st["mu"] / c1)
                              / (torch.sqrt(st["nu"] / c2) + eps)))


def adam_cosine(params, lr: float, steps: int, alpha: float):
    """:class:`Adam` (betas 0.9 / 0.999, eps 1e-8: optax's ``adam``) over
    ``params`` under a ``LambdaLR`` that gives step ``i`` the rate ``lr *
    ((1 - alpha) * 0.5 * (1 + cos(pi * min(i, steps) / steps)) + alpha)``:
    ``optax.adam(optax.cosine_decay_schedule(lr, steps, alpha))`` →
    (optimiser, scheduler); call ``opt.step()`` then ``sched.step()`` once a
    step."""
    opt = Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def factor(i):
        c = 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps))
        return (1.0 - alpha) * c + alpha

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def _setup(world, cam, width, height, spp, max_depth, device):
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.ops.shade import SceneFlags
    from path_tracer_tpu_torch.ops.types import RenderConfig

    cam.img_width = width
    cam.aspect_ratio = width / height
    cam.samples_per_pixel = spp
    cam.max_depth = max_depth
    scene = ptt.compile_scene(world, device=device)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=max_depth)
    return (scene, SceneFlags.from_scene(scene), ptt.build_from_scene(scene),
            cam.initialize(device=device), cfg)


def _target(scene, flags, bvh, cam_a, cfg, key, target_spp, queue_size,
            steps_per_wave):
    """The "measurement": ``target_spp`` samples at the true parameters in
    chunks of at most 64 (equal to one call: the pool regenerates)."""
    from path_tracer_tpu_torch.ops import wavefront

    target = torch.zeros((cfg.height, cfg.width, 3), device=key.device)
    done = 0
    while done < target_spp:
        nb = min(64, target_spp - done)
        target = wavefront.render_batch(
            scene, flags, bvh, cam_a, cfg, target, done, nb, key,
            queue_size=queue_size, steps_per_wave=steps_per_wave)
        done += nb
    return target / target_spp


def _step_fn(scene, flags, bvh, cam_a, cfg, mesh, seed, spp, queue_size,
             steps_per_wave):
    from path_tracer_tpu_torch.parallel import (calibrate_n_waves,
                                                make_train_step)
    from path_tracer_tpu_torch.utils import rng

    n_waves = calibrate_n_waves(scene, flags, bvh, cam_a, cfg,
                                rng.key(seed, device=scene.sph_c0.device),
                                spp=spp, queue_size=queue_size,
                                steps_per_wave=steps_per_wave, mesh=mesh)
    # unbiased=True: the single-render MSE gradient also descends the MC
    # noise's variance and drives albedos to black.
    return make_train_step(flags, cfg, mesh, spp=spp, queue_size=queue_size,
                           steps_per_wave=steps_per_wave, n_waves=n_waves,
                           unbiased=True)


def _optimise(params, name, step_of, steps, lr, decay_alpha, project,
              scene, bvh, cam_a, target, base_key, avg_start, record):
    """The shared loop: a step, Adam, the projection, the tail average."""
    from path_tracer_tpu_torch.utils import rng

    opt, sched = adam_cosine([params[name]], lr, steps, decay_alpha)
    avg_sum, avg_n, history = None, 0, []
    for i in range(steps):
        key_i = rng.fold_in(base_key, i)       # fresh MC noise every step
        _, loss, grads, aux = step_of(i)(params, scene, bvh, cam_a, key_i,
                                         target)
        assert aux["paths_done"] == aux["paths_total"], \
            "backward wavefront did not integrate every path"
        params[name].grad = grads[name].detach()
        opt.step()
        sched.step()
        with torch.no_grad():
            params[name].copy_(project(params[name]))
        cur = params[name].detach().cpu().numpy()
        if i >= avg_start:
            avg_sum = cur.copy() if avg_sum is None else avg_sum + cur
            avg_n += 1
        history.append(record(i, float(loss), cur))
    return avg_sum / avg_n, history


def run_demo(steps: int = 200, width: int = 48, height: int = 48,
             spp: int = 4, target_spp: int = 32, max_depth: int = 6,
             lr: float = 0.08, seed: int = 0, queue_size: int = 2048,
             steps_per_wave: int = 8, n_devices: int | None = None,
             log_every: int = 10, verbose: bool = True,
             decay_alpha: float = 0.1, avg_frac: float = 0.5,
             albedo_row: str = "red", polish_steps: int = 0,
             polish_spp: int = 0, device="cuda") -> dict:
    """Optimise the Cornell light emission and one wall albedo back to the
    truth → ``{"history", "true", "init", "recovered", "rel_err",
    "wall_s", "devices"}``: rows are (albedo, emission) of ``tex_c1``."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.parallel import make_mesh
    from path_tracer_tpu_torch.utils import rng

    world, cam = ptt.scenes.cornell_box()
    scene, flags, bvh, cam_a, cfg = _setup(world, cam, width, height, spp,
                                           max_depth, device)
    # Texture rows (compile order): 0 green wall, 1 red wall, 2 light
    # emission (15, 15, 15), 3 white walls.
    a_row = {"red": 1, "white": 3}[albedo_row]
    rows = [a_row, 2]
    true_tex = scene.tex_c1.cpu().numpy().copy()
    target = _target(scene, flags, bvh, cam_a, cfg,
                     rng.key(seed + 10_000, device=device), target_spp,
                     queue_size, steps_per_wave)

    init_tex = true_tex.copy()
    init_tex[a_row] = (np.array([0.4, 0.4, 0.4], np.float32) if a_row == 1
                       else np.array([0.30, 0.50, 0.60], np.float32))
    init_tex[2] = 0.5 * init_tex[2]                        # light x0.5
    params = {"tex_c1": torch.tensor(init_tex, device=device)}

    mesh = make_mesh(n_devices)
    step_fn = _step_fn(scene, flags, bvh, cam_a, cfg, mesh, seed, spp,
                       queue_size, steps_per_wave)
    # The polish phase: the last ``polish_steps`` at ``polish_spp`` with the
    # schedule's smallest rates, and only those iterates averaged.
    if polish_steps and polish_spp:
        polish_fn = _step_fn(scene, flags, bvh, cam_a, cfg, mesh, seed,
                             polish_spp, queue_size, steps_per_wave)
    else:
        polish_steps, polish_fn = 0, step_fn

    def rel_err(tex):
        return np.array([np.linalg.norm(tex[r] - true_tex[r])
                         / np.linalg.norm(true_tex[r]) for r in rows])

    def record(i, loss, cur):
        errs = rel_err(cur)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {loss:.3e}  albedo err "
                  f"{errs[0] * 100:5.1f}%  emission err {errs[1] * 100:5.1f}%",
                  flush=True)
        return {"step": i, "loss": loss, "err_albedo": float(errs[0]),
                "err_emission": float(errs[1])}

    avg_start = (steps - polish_steps if polish_steps
                 else int(steps * (1.0 - avg_frac)))
    t0 = time.perf_counter()
    rec, history = _optimise(
        params, "tex_c1",
        lambda i: polish_fn if i >= steps - polish_steps else step_fn,
        steps, lr, decay_alpha, lambda p: torch.clamp(p, min=0.0), scene, bvh,
        cam_a, target, rng.key(seed, device=device), avg_start, record)
    out = {
        "history": history,
        "true": true_tex[rows],
        "init": init_tex[rows],
        "recovered": rec[rows],
        "rel_err": rel_err(rec),
        "wall_s": time.perf_counter() - t0,
        "devices": mesh.size,
    }
    if verbose:
        print(f"\n{out['wall_s']:.1f}s on {out['devices']} device(s)")
        for name, r in ((f"{albedo_row}-wall albedo", 0),
                        ("light emission", 1)):
            print(f"{name}: true {np.round(out['true'][r], 4)} "
                  f"init {np.round(out['init'][r], 4)} "
                  f"recovered {np.round(out['recovered'][r], 4)} "
                  f"({out['rel_err'][r] * 100:.2f}% off)")
    return out


def run_texture_demo(steps: int = 260, width: int = 48, height: int = 48,
                     spp: int = 8, target_spp: int = 512, max_depth: int = 5,
                     lr: float = 0.02, seed: int = 0, tex_n: int = 8,
                     queue_size: int = 2048, steps_per_wave: int = 8,
                     n_devices: int | None = None, log_every: int = 20,
                     verbose: bool = True, decay_alpha: float = 0.05,
                     avg_frac: float = 0.3, device="cuda") -> dict:
    """Recover the ``tex_n`` x ``tex_n`` texture image of
    ``scenes.texture_demo`` through its ``img_data`` atlas, which starts
    flat at 0.5 and is clipped to [0, 1] after each step → ``{"history",
    "true", "recovered", "err", "wall_s", "devices"}``; ``err`` holds the
    texels' ``mean_abs``, ``max_abs`` and ``psnr``."""
    import path_tracer_tpu_torch as ptt
    from path_tracer_tpu_torch.parallel import make_mesh
    from path_tracer_tpu_torch.utils import rng

    true_img = ptt.scenes.texture_target(tex_n)
    world, cam = ptt.scenes.texture_demo(tex_n)
    scene, flags, bvh, cam_a, cfg = _setup(world, cam, width, height, spp,
                                           max_depth, device)
    target = _target(scene, flags, bvh, cam_a, cfg,
                     rng.key(seed + 10_000, device=device), target_spp,
                     queue_size, steps_per_wave)
    params = {"img_data": torch.full_like(scene.img_data, 0.5)}
    mesh = make_mesh(n_devices)
    step_fn = _step_fn(scene, flags, bvh, cam_a, cfg, mesh, seed, spp,
                       queue_size, steps_per_wave)

    def tex_err(img):
        rec = np.asarray(img)[0, :tex_n, :tex_n]
        mse = float(np.mean((rec - true_img) ** 2))
        d = np.abs(rec - true_img)
        return {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                "psnr": float(10 * np.log10(1.0 / max(mse, 1e-12)))}

    def record(i, loss, cur):
        e = tex_err(cur)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {loss:.3e}  texel mean|err| "
                  f"{e['mean_abs']:.4f}  PSNR {e['psnr']:.1f} dB", flush=True)
        return {"step": i, "loss": loss, **e}

    t0 = time.perf_counter()
    rec, history = _optimise(
        params, "img_data", lambda i: step_fn, steps, lr, decay_alpha,
        lambda p: torch.clamp(p, 0.0, 1.0), scene, bvh, cam_a, target,
        rng.key(seed, device=device), int(steps * (1.0 - avg_frac)), record)
    out = {
        "history": history,
        "true": true_img,
        "recovered": rec[0, :tex_n, :tex_n],
        "err": tex_err(rec),
        "wall_s": time.perf_counter() - t0,
        "devices": mesh.size,
    }
    if verbose:
        print(f"\n{out['wall_s']:.1f}s on {out['devices']} device(s); "
              f"recovered {tex_n}x{tex_n} texture: {out['err']}")
    return out


def write_texture_pair_png(true_img, rec_img, path, upscale: int = 40):
    """Side-by-side true | recovered texture, nearest-neighbour upscaled."""
    from path_tracer_tpu_torch.utils.image import write_png

    def up(im):
        return np.repeat(np.repeat(im, upscale, 0), upscale, 1)

    gap = np.ones((true_img.shape[0] * upscale, upscale // 2, 3), np.float32)
    pair = np.concatenate([up(true_img), gap, up(np.clip(rec_img, 0, 1))],
                          axis=1)
    # write_png applies gamma 2 for radiance; these are plain colours, so
    # pre-square them.
    write_png(path, pair.astype(np.float32) ** 2, 1)
    print(f"wrote {path}")


# Plot colours (RGB in [0, 1]): loss, albedo error, emission error, guides.
_BLUE, _RED, _ORANGE = (0.12, 0.47, 0.71), (0.84, 0.15, 0.16), (1.0, 0.5, 0.05)
_GRAY, _BLACK = (0.5, 0.5, 0.5), (0.0, 0.0, 0.0)


def _polyline(canvas, xs, ys, colour, dotted=False):
    """Draw the segments through pixel points (xs, ys), one pixel wide."""
    h, w = canvas.shape[:2]
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        px = np.rint(x0 + (x1 - x0) * t).astype(int)
        py = np.rint(y0 + (y1 - y0) * t).astype(int)
        keep = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        if dotted:
            keep &= (px // 3) % 2 == 0
        canvas[py[keep], px[keep]] = colour


def write_curve_png(history, path, size=(440, 770)):
    """The demo's curves drawn with numpy: log loss on the left scale
    (blue), albedo and emission error % on the right scale (red, orange),
    a dotted line at 5%, a frame around the plot."""
    from path_tracer_tpu_torch.utils.image import write_png

    h, w = size
    canvas = np.ones((h, w, 3), np.float32)
    x0, x1, y0, y1 = 50, w - 50, 20, h - 30          # plot box (pixels)
    steps = np.array([e["step"] for e in history], np.float64)
    span = max(steps.max() - steps.min(), 1.0)
    xs = x0 + (steps - steps.min()) / span * (x1 - x0)
    loss = np.log10(np.maximum([e["loss"] for e in history], 1e-30))
    lo, hi = loss.min(), max(loss.max(), loss.min() + 1e-6)
    _polyline(canvas, xs, y1 - (loss - lo) / (hi - lo) * (y1 - y0), _BLUE)
    errs = 100.0 * np.array([[e["err_albedo"], e["err_emission"]]
                             for e in history])
    top = max(float(errs.max()), 5.0) * 1.05

    def y_pct(p):
        return y1 - np.asarray(p) / top * (y1 - y0)

    _polyline(canvas, xs, y_pct(errs[:, 0]), _RED)
    _polyline(canvas, xs, y_pct(errs[:, 1]), _ORANGE)
    _polyline(canvas, np.array([x0, x1]), np.full(2, y_pct(5.0)), _GRAY,
              dotted=True)
    _polyline(canvas, np.array([x0, x1, x1, x0, x0]),
              np.array([y0, y0, y1, y1, y0]), _BLACK)
    write_png(path, canvas ** 2, 1)                  # pre-squared colours
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=48)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--target-spp", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decay-alpha", type=float, default=0.02)
    ap.add_argument("--polish-steps", type=int, default=60)
    ap.add_argument("--polish-spp", type=int, default=0,
                    help="spp for the final polish phase (default 3x --spp)")
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for train_demo.jsonl + train_demo.png")
    ap.add_argument("--texture", action="store_true",
                    help="run the texture-image recovery demo instead "
                         "(8x8 image through the img_data atlas leaf)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --cpu for the twins)", file=sys.stderr)
        return 2
    from path_tracer_tpu_torch.scripts.bench_ladder import card
    print(card(), flush=True)
    os.makedirs(args.out, exist_ok=True)

    if args.texture:
        # Only steps and seed ride the CLI: the other defaults belong to
        # the 2-row demo (JAX's main does the same).
        out = run_texture_demo(steps=args.steps, seed=args.seed,
                               device=device)
        with open(os.path.join(args.out, "train_texture.jsonl"), "w") as f:
            for e in out["history"]:
                f.write(json.dumps(e) + "\n")
        write_texture_pair_png(out["true"], out["recovered"],
                               os.path.join(args.out, "train_texture.png"))
        ok = out["err"]["mean_abs"] < 0.03
        print("RECOVERED" if ok else "NOT RECOVERED", out["err"])
        return 0 if ok else 1

    out = run_demo(steps=args.steps, width=args.width, height=args.height,
                   spp=args.spp, target_spp=args.target_spp, lr=args.lr,
                   seed=args.seed, decay_alpha=args.decay_alpha,
                   polish_steps=args.polish_steps,
                   polish_spp=args.polish_spp or 3 * args.spp, device=device)
    with open(os.path.join(args.out, "train_demo.jsonl"), "w") as f:
        for e in out["history"]:
            f.write(json.dumps(e) + "\n")
    write_curve_png(out["history"], os.path.join(args.out, "train_demo.png"))
    ok = bool((out["rel_err"] < 0.05).all())
    print("RECOVERED within 5%" if ok else "NOT within 5%", out["rel_err"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
