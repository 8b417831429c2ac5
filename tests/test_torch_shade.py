"""Wavefront shading twins lane for lane against the JAX package.

Primary rays (``spawn_paths``), hit refinement (``refine_hit_t``), the
medium/front test of the volume-exit transition (``prim_medium_front_t``),
texture evaluation (checker, image atlas, Perlin marble) and one full bounce
(``bounce_shade_t``) over a scene with every family the port shades
(lambertian, metal, dielectric, emissive, isotropic medium; no SSS), as
``tests/test_shade_tiled.py`` holds the tiled JAX form against the per-lane
one.  Floats agree to 1e-5 (XLA's CPU backend fuses multiply-adds, the twin
rounds every operation); integers and booleans are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import integrator as jint
from path_tracer_tpu.ops import shade as jsh
from path_tracer_tpu.ops import shade_tiled as jst
from path_tracer_tpu.ops.types import RenderConfig as JCfg
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import shade as tsh
from path_tracer_tpu_torch.ops import shade_tiled as tst
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg

R = 256
TOL = dict(rtol=1e-5, atol=1e-5)


def _world():
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, -100.5, -1), 100, pt.Lambertian(
        pt.CheckerTexture(0.5, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))))
    w.add(pt.Sphere.stationary((0, 0, -1), 0.5, pt.Lambertian(pt.NoiseTexture(4.0))))
    w.add(pt.Sphere.moving((1, 0, -1), (1.1, 0, -1), 0.5,
                           pt.Metal((0.8, 0.6, 0.2), 0.3)))
    w.add(pt.Sphere.stationary((-1, 0, -1), 0.5, pt.Dielectric(1.5)))
    w.add(pt.Sphere.stationary((0.3, 0.9, -1.6), 0.4, pt.Lambertian(
        pt.ImageTexture("assets/images/earthmap.jpg"))))
    w.add(pt.Quad((-2, 2, -2), (4, 0, 0), (0, 0, 2), pt.DiffuseLight((4, 4, 4))))
    w.add(pt.Triangle((-2, -0.4, -2.6), (2, -0.4, -2.6), (0, 1.8, -3.0),
                      pt.Lambertian((0.7, 0.3, 0.3))))
    w.add(pt.ConstantMedium.from_color(
        pt.Sphere.stationary((0.2, 0.1, -1.2), 1.4, pt.Dielectric(1.5)),
        (0.6, 0.7, 0.9), 0.8))
    cam = pt.Camera()
    cam.aspect_ratio = 2.0
    cam.img_width = 64
    cam.max_depth = 8
    cam.defocus_angle = 0.5
    cam.focus_distance = 2.0
    return w, cam


@pytest.fixture(scope="module")
def setup():
    world, cam = _world()
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    flags = jsh.SceneFlags.from_scene(scene)
    assert flags.has_image and flags.has_noise and flags.has_medium
    cam_a = cam.initialize()
    jcfg = JCfg(width=64, height=32, max_depth=8)
    tcfg = TCfg(width=64, height=32, max_depth=8)
    ts = interop.from_numpy_scene(scene, "cpu")
    tb = interop.from_numpy_bvh(bvh, "cpu")
    tc = interop.from_numpy_camera(cam_a, "cpu")
    jk = jax.random.key(7)
    tk = interop.key_from_data(np.asarray(jax.random.key_data(jk)), "cpu")
    g = np.random.default_rng(99)
    pix = g.integers(0, 64 * 32, R).astype(np.int32)
    smp = g.integers(0, 4, R).astype(np.int32)
    return dict(scene=scene, bvh=bvh, flags=flags, cam=cam_a, jcfg=jcfg,
                tcfg=tcfg, ts=ts, tb=tb, tc=tc, tflags=tsh.SceneFlags.from_scene(ts),
                jk=jk, tk=tk, pix=pix, smp=smp)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x.numpy())


def test_spawn_paths_match(setup):
    s = setup
    want = jst.spawn_paths(s["cam"], s["jcfg"], s["jk"], jnp.asarray(s["smp"]),
                           jnp.asarray(s["pix"]))
    got = tst.spawn_paths(s["tc"], s["tcfg"], s["tk"], _t(s["smp"]), _t(s["pix"]))
    for name in tint.PathState._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)


def _hits(s):
    """Port-traversed primary hits + exit queries (the control-step inputs)."""
    path = tst.spawn_paths(s["tc"], s["tcfg"], s["tk"], _t(s["smp"]), _t(s["pix"]))
    tr = ttr.traversal_init_batched(s["tb"], path.origin, path.direction,
                                    path.time, 1e-3, 1e9, 48)
    tr = ttr.traversal_steps_batched(s["tb"], tr, path.origin, path.direction,
                                     path.time, 1e-3, 4096)
    ex = ttr.traversal_init_batched(s["tb"], path.origin, path.direction,
                                    path.time, tr.best_t + 1e-4, 1e9, 48)
    ex = ttr.traversal_steps_batched(s["tb"], ex, path.origin, path.direction,
                                     path.time, tr.best_t + 1e-4, 4096)
    return path, tr, ex


def test_refine_and_medium_front_match(setup):
    s = setup
    path, tr, _ = _hits(s)
    assert bool((tr.best_pt >= 0).any())
    jt, tt = jst.make_tables(s["scene"]), tst.make_tables(s["ts"])
    o = [path.origin[:, k] for k in range(3)]
    d = [path.direction[:, k] for k in range(3)]
    want = jst.refine_hit_t(jt, _j(tr.best_pt), _j(tr.best_pi), *map(_j, o),
                            *map(_j, d), _j(path.time), 1e-3)
    got = tst.refine_hit_t(tt, tr.best_pt, tr.best_pi, *o, *d, path.time, 1e-3)
    hit = (tr.best_pt >= 0).numpy()
    for name in ("hit", "front", "mat", "medium"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy()[hit],
                                   np.asarray(getattr(want, name))[hit], **TOL,
                                   err_msg=name)
    for name in ("p", "n"):
        for k in range(3):
            np.testing.assert_allclose(getattr(got, name)[k].numpy()[hit],
                                       np.asarray(getattr(want, name)[k])[hit],
                                       **TOL, err_msg=name)
    wm, wf = jst.prim_medium_front_t(jt, _j(tr.best_pt), _j(tr.best_pi),
                                     *map(_j, o), *map(_j, d), _j(path.time),
                                     _j(tr.best_t))
    gm, gf = tst.prim_medium_front_t(tt, tr.best_pt, tr.best_pi, *o, *d,
                                     path.time, tr.best_t)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))


@pytest.mark.parametrize("family", ["checker", "image", "marble", "mixed"])
def test_eval_texture_matches(setup, family):
    s = setup
    tex_type = np.asarray(s["scene"].tex_type)
    kind = {"checker": 1, "image": 2, "marble": 3}
    g = np.random.default_rng(len(family))
    ids = (np.nonzero(tex_type == kind[family])[0] if family in kind
           else np.arange(len(tex_type)))
    tex = g.choice(ids, 512).astype(np.int32)
    u = g.uniform(-0.1, 1.1, 512).astype(np.float32)
    v = g.uniform(-0.1, 1.1, 512).astype(np.float32)
    p = g.uniform(-3, 3, (512, 3)).astype(np.float32)
    want = jsh.eval_texture_batched(s["scene"], s["flags"], jnp.asarray(tex),
                                    jnp.asarray(u), jnp.asarray(v), jnp.asarray(p))
    got = tsh.eval_texture_batched(s["ts"], s["tflags"], _t(tex), _t(u), _t(v), _t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bounce_shade_matches(setup):
    s = setup
    path, tr, ex = _hits(s)
    tt = tst.make_tables(s["ts"])
    o = [path.origin[:, k] for k in range(3)]
    d = [path.direction[:, k] for k in range(3)]
    e_med, _ = tst.prim_medium_front_t(tt, ex.best_pt, ex.best_pi, *o, *d,
                                       path.time, ex.best_t)
    found = tr.best_pt >= 0
    ef = ex.best_pt >= 0
    e_is_med = ef & (e_med >= 0)
    iters = torch.from_numpy(np.random.default_rng(3).integers(0, 6, R)
                             .astype(np.int32))
    depth = torch.clamp(iters - 1, min=0).to(torch.int32)
    thr = torch.from_numpy(np.random.default_rng(4).uniform(0.2, 1.0, (R, 3))
                           .astype(np.float32))
    path = path._replace(iters=iters, depth=depth, throughput=thr,
                         color=thr * 0.1)
    rngs = tst.wave_rng(s["tk"], _t(s["smp"]), _t(s["pix"]), iters)
    got = tst.bounce_shade_t(s["ts"], s["tflags"], s["tc"], s["tcfg"], tt, path,
                             found, tr.best_pt, tr.best_pi, ef, ex.best_t,
                             e_is_med, rngs)
    jrngs = jst.wave_rng(s["jk"], jnp.asarray(s["smp"]), jnp.asarray(s["pix"]),
                         _j(iters), False, 32)
    jpath = jint.PathState(*[_j(x) for x in path])
    want = jst.bounce_shade_t(s["scene"], s["flags"], s["cam"], s["jcfg"],
                              jst.make_tables(s["scene"]), jpath, _j(found),
                              _j(tr.best_pt), _j(tr.best_pi), _j(ef),
                              _j(ex.best_t), _j(e_is_med), jrngs)
    assert found.any() and e_is_med.any()
    for name in ("depth", "iters", "alive"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("origin", "direction", "color", "throughput"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
