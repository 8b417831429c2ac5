"""Where the port's vol2_final images part from JAX's, path by path (CPU).

    JAX_PLATFORMS=cpu python tests/torch_golden_trace.py rates
    JAX_PLATFORMS=cpu python tests/torch_golden_trace.py trace small|frame32
    JAX_PLATFORMS=cpu python tests/torch_golden_trace.py rsqrt|hit|adam

The measurements behind ``scripts/golden.py``'s vol2_final rule and
ROADMAP.md C (it imports JAX and the port, as the tests do; nothing of it
runs on the card):

* ``rates``: the share of (sample, pixel) paths whose radiance differs from
  JAX's by more than 1e-4 (each sample rendered alone by both packages'
  wavefront, key 123, 2048 slots, 8 steps a wave) on vol2_final_small and
  on 32x32, 4-spp frames of vol2_final at depth 8 and 12 and 40, 300 and
  1,000 cluster spheres.
* ``trace``: every such path of ``small`` or ``frame32`` (32x32, 4 spp,
  depth 8, 300 spheres) traced once more by running JAX's megakernel
  bounce op by op (``jax.disable_jit``: no fusion, so no contracted
  multiply-adds), once with ``lax.rsqrt`` replaced by the port's ``1 /
  sqrt`` (two correctly rounded operations) and once with its own; one
  JSON line a path: JAX's compiled radiance, the port's, both op-by-op
  runs and which equal which.
* ``rsqrt``: how often XLA's CPU ``lax.rsqrt`` equals ``1 / sqrt`` rounded
  twice and the correctly rounded value, on 2,000,000 seeded inputs.
* ``hit``: vol2_final_small's grazing hit (pixel (10, 12), sample 0) in
  JAX, in the port and in float64.
* ``adam``: ``torch.optim.Adam`` and the demo's ``Adam`` against
  ``optax.adam`` over ``tests/test_torch_demo.py``'s 20 seeded steps.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FRAMES = {"small": (40, 24, 2, 6), "frame32": (300, 32, 4, 8),
          "frame32_depth12": (300, 32, 4, 12),
          "frame32_cluster40": (40, 32, 4, 8),
          "frame32_cluster1000": (1000, 32, 4, 8)}


class Frame:
    """One vol2_final frame in both packages (JAX's scene, BVH and camera,
    converted for the port), key 123."""

    def __init__(self, cluster, width, spp, depth):
        import jax

        import path_tracer_tpu as pt
        from path_tracer_tpu.ops.shade import SceneFlags as JFlags
        from path_tracer_tpu.ops.types import RenderConfig as JCfg
        from path_tracer_tpu_torch import interop
        from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
        from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg

        world, cam = pt.scenes.vol2_final_scene(sphere_cluster=cluster)
        cam.img_width = width
        self.W, self.H = width, max(1, int(width / cam.aspect_ratio))
        self.spp = spp
        kw = dict(width=width, height=self.H, samples_per_pixel=spp,
                  max_depth=depth)
        self.js = pt.compile_scene(world)
        self.jb = pt.build_from_scene(self.js)
        self.jf, self.jc = JFlags.from_scene(self.js), cam.initialize()
        self.jcfg, self.tcfg = JCfg(**kw), TCfg(**kw)
        self.jkey = jax.random.key(123)
        self.ts = interop.from_numpy_scene(self.js, "cpu")
        self.tb = interop.from_numpy_bvh(self.jb, "cpu")
        self.tf = TFlags.from_scene(self.ts)
        self.tc = interop.from_numpy_camera(self.jc, "cpu")
        self.tkey = interop.key_from_data(
            np.asarray(jax.random.key_data(self.jkey)), "cpu")

    def per_sample(self):
        """(spp, pixels, 3) radiance of every path in JAX and the port."""
        import jax.numpy as jnp
        import torch

        from path_tracer_tpu.ops import wavefront as jwf
        from path_tracer_tpu_torch.ops import wavefront as twf

        q = dict(queue_size=2048, steps_per_wave=8)
        n = self.W * self.H
        j = [np.asarray(jwf.render_batch(
            self.js, self.jf, self.jb, self.jc, self.jcfg,
            jnp.zeros((self.H, self.W, 3)), s, 1, self.jkey, **q))
            for s in range(self.spp)]
        t = [twf.render_batch(
            self.ts, self.tf, self.tb, self.tc, self.tcfg,
            torch.zeros((self.H, self.W, 3)), s, 1, self.tkey, **q).numpy()
            for s in range(self.spp)]
        return (np.stack(j).reshape(self.spp, n, 3),
                np.stack(t).reshape(self.spp, n, 3))

    def op_by_op(self, s, p, port_rsqrt):
        """JAX's megakernel path of (sample s, pixel p), op by op."""
        import jax
        import jax.numpy as jnp

        from path_tracer_tpu.ops import camera as jcam
        from path_tracer_tpu.ops import integrator as jint

        own = jax.lax.rsqrt
        if port_rsqrt:
            jax.lax.rsqrt = lambda x: jnp.asarray(
                np.float32(1.0) / np.sqrt(np.asarray(x, np.float64))
                .astype(np.float32))
        try:
            with jax.disable_jit():
                key_p = jax.random.fold_in(jax.random.fold_in(self.jkey, s),
                                           p)
                o, d, t = jcam.get_ray(self.jc, jnp.float32(p % self.W),
                                       jnp.float32(p // self.W),
                                       jax.random.fold_in(key_p, 7))
                st = jint._init_state(o, d, t)
                while bool(st.alive) and int(st.iters) < self.jcfg.iters:
                    st = jint.bounce_body(self.js, self.jf, self.jb, self.jc,
                                          self.jcfg, st, key_p)
                return np.asarray(st.color)
        finally:
            jax.lax.rsqrt = own


def rates():
    for name, spec in FRAMES.items():
        j, t = Frame(*spec).per_sample()
        d = np.abs(j - t).max(axis=-1)
        print(json.dumps({"frame": name, "paths": int(d.size),
                          "differing": int((d > 1e-4).sum()),
                          "rate": float((d > 1e-4).mean()),
                          "beyond_1e-2": int((d > 1e-2).sum())}), flush=True)


def trace(name):
    f = Frame(*FRAMES[name])
    j, t = f.per_sample()
    d = np.abs(j - t).max(axis=-1)
    for s, p in zip(*np.nonzero(d > 1e-4)):
        s, p = int(s), int(p)
        mine = f.op_by_op(s, p, port_rsqrt=True)
        own = f.op_by_op(s, p, port_rsqrt=False)
        print(json.dumps({
            "sample": s, "pixel": [p // f.W, p % f.W],
            "jax": j[s, p].tolist(), "port": t[s, p].tolist(),
            "op_by_op_port_rsqrt": mine.tolist(),
            "op_by_op_own_rsqrt": own.tolist(),
            "port_rsqrt_equals_port": bool(np.array_equal(mine, t[s, p])),
            "port_rsqrt_from_port": float(np.abs(mine - t[s, p]).max()),
            "own_rsqrt_equals_jax": bool(np.array_equal(own, j[s, p]))}),
            flush=True)


def rsqrt():
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(0).uniform(1e-3, 1e4, 2_000_000).astype(
        np.float32)
    xla = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    twice = np.float32(1.0) / np.sqrt(x.astype(np.float64)).astype(
        np.float32)
    once = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    print(json.dumps({"xla_equals_1/sqrt": float((xla == twice).mean()),
                      "xla_correctly_rounded": float((xla == once).mean()),
                      "1/sqrt_correctly_rounded": float((twice == once)
                                                        .mean())}))


def hit():
    """The first hit of small's (10, 12), sample 0: the marble sphere."""
    import jax
    import torch

    from path_tracer_tpu.ops import camera as jcam
    from path_tracer_tpu.ops import integrator as jint
    from path_tracer_tpu.ops.traverse import traverse_bvh
    from path_tracer_tpu_torch.ops import integrator as tint
    from path_tracer_tpu_torch.ops.camera import get_ray
    from path_tracer_tpu_torch.ops.traverse import _traverse_impl
    from path_tracer_tpu_torch.utils import rng as trng

    f = Frame(*FRAMES["small"])
    cfg = f.jcfg
    s, p = 0, 10 * f.W + 12
    key_p = jax.random.fold_in(jax.random.fold_in(f.jkey, s), p)
    st = jint._init_state(*jcam.get_ray(
        f.jc, np.float32(p % f.W), np.float32(p // f.W),
        jax.random.fold_in(key_p, 7)))
    _, _, jpi, jt = jax.jit(lambda o, d, t: traverse_bvh(
        f.jb, o, d, t, cfg.t_min, cfg.t_max, cfg.stack_depth))(
        st.origin, st.direction, st.time)
    pix = torch.tensor([p], dtype=torch.int32)
    tk = trng.fold_in(trng.fold_in(f.tkey, s), pix)
    tst = tint._init_state(*get_ray(f.tc, (pix % f.W).float(),
                                    (pix // f.W).float(), trng.fold_in(tk, 7)))
    _, _, tpi, th, _ = _traverse_impl(f.tb, tst.origin, tst.direction,
                                      tst.time, cfg.t_min, cfg.t_max,
                                      cfg.stack_depth)
    i = int(jpi)
    c = np.asarray(f.js.sph_c0)[i].astype(np.float64)
    r = float(np.asarray(f.js.sph_rad)[i])
    d64 = np.asarray(st.direction, np.float64)
    oc = c - np.asarray(st.origin, np.float64)
    a, h, cc = d64 @ d64, d64 @ oc, oc @ oc - r * r
    disc = h * h - a * cc
    print(json.dumps({"sphere": i, "port_sphere": int(tpi[0]),
                      "jax_t": float(jt), "port_t": float(th[0]),
                      "float64_t": float((h - np.sqrt(disc)) / a),
                      "disc_over_h2": float(disc / (h * h))}))


def adam():
    import jax.numpy as jnp
    import optax
    import torch

    from path_tracer_tpu_torch.scripts import train_demo

    rng = np.random.default_rng(5)
    p0 = rng.uniform(0.0, 1.0, (4, 3)).astype(np.float32)
    grads = rng.normal(0.0, 1.0, (20, 4, 3)).astype(np.float32)
    lr, steps, alpha = 0.08, 20, 0.1
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=alpha))
    params = jnp.asarray(p0)
    state = opt.init(params)
    ref = []
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        ref.append(np.asarray(params))
    out = {}
    for name in ("torch.optim.Adam", "train_demo.Adam"):
        x = torch.tensor(p0)
        if name == "torch.optim.Adam":
            o = torch.optim.Adam([x], lr=lr, foreach=False)
            sch = torch.optim.lr_scheduler.LambdaLR(o, lambda i: (
                (1 - alpha) * 0.5 * (1 + np.cos(np.pi * min(i, steps) / steps))
                + alpha))
        else:
            o, sch = train_demo.adam_cosine([x], lr, steps, alpha)
        worst = 0.0
        for g, want in zip(grads, ref):
            x.grad = torch.tensor(g)
            o.step()
            sch.step()
            worst = max(worst, float(np.max(np.abs(x.numpy() - want)
                                            / np.abs(want))))
        out[name] = worst
    print(json.dumps({"max_relative_drift_from_optax": out}))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    if cmd == "trace":
        trace(sys.argv[2])
    elif cmd in ("rates", "rsqrt", "hit", "adam"):
        globals()[cmd]()
    else:
        print(__doc__)
        sys.exit(2)
