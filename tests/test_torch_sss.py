"""Subsurface scattering (B6) in the port against the JAX package.

The walk draws ``uniform(fold_in(k_scatter, 1), (32, 6))`` per lane, bit for
bit as JAX does; the per-lane ``scatter`` and the tiled ``bounce_shade_t``
match JAX lane for lane (exit/absorb outcomes equal, floats to 1e-5).  End
to end on ``subsurface_scattering`` and ``mesh_perlin_sss`` (32x18, 2 spp,
depth 12), both engines of the port against JAX ``render_batch`` and
``integrator.render``: ``paths``, ``spawned`` and per-pixel paths are exact
by construction; ``rays``, ``depth_hist`` and ``walk_steps`` were measured
equal to JAX's (ROADMAP.md C) and are held exactly; the image is held to
the graded rule (XLA's CPU FMA contraction moves the marble texture:
measured max 7.1e-4 per sample on subsurface_scattering, 0.5% of pixels
beyond 1e-3 on mesh_perlin_sss).  On mesh_perlin_sss, whose marble ground
fills most of the frame, the clean-pixel mean is held below 2e-5 instead of
1e-5: measured 1.34e-5 (wavefront) and 1.42e-5 (megakernel) against JAX,
where JAX's own two engines differ by 8.1e-6 and the port's two engines
not at all (ROADMAP.md C).  The JAX megakernel reports no walk
counter, so the port's megakernel counters are held to the JAX wavefront's,
which integrates the same sample set.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import integrator as jint
from path_tracer_tpu.ops import shade as jsh
from path_tracer_tpu.ops import shade_tiled as jst
from path_tracer_tpu.ops import wavefront as jwf
from path_tracer_tpu.ops.types import RenderConfig as JCfg
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops import shade as tsh
from path_tracer_tpu_torch.ops import shade_tiled as tst
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.types import (C_WALK_STEPS, MAT_SSS_SIMPLE,
                                             MAT_SSS_VOLUMETRIC)
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.utils import rng as trng

W, H, SPP, DEPTH = 32, 18, 2, 12
SCENES = ["subsurface_scattering", "mesh_perlin_sss"]
CLEAN_MEAN = {"subsurface_scattering": 1e-5, "mesh_perlin_sss": 2e-5}


def _build(name, w=W, h=H):
    world, cam = getattr(pt.scenes, name)()
    cam.img_width, cam.aspect_ratio = w, w / h
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    cam_a = cam.initialize()
    ts = interop.from_numpy_scene(scene, "cpu")
    key = jax.random.key(0)
    return dict(
        scene=scene, bvh=bvh, cam=cam_a, flags=jsh.SceneFlags.from_scene(scene),
        jcfg=JCfg(width=w, height=h, samples_per_pixel=SPP, max_depth=DEPTH),
        key=key, ts=ts, tflags=tsh.SceneFlags.from_scene(ts),
        tb=interop.from_numpy_bvh(bvh, "cpu"),
        tc=interop.from_numpy_camera(cam_a, "cpu"),
        tcfg=TCfg(width=w, height=h, samples_per_pixel=SPP, max_depth=DEPTH),
        tk=interop.key_from_data(np.asarray(jax.random.key_data(key)), "cpu"))


@pytest.fixture(scope="module")
def built():
    """Each SSS scene with its JAX wavefront and megakernel renders, once."""
    cache = {}

    def get(name):
        if name not in cache:
            s = _build(name)
            assert s["flags"].has_sss
            img, st = jwf.render_batch(
                s["scene"], s["flags"], s["bvh"], s["cam"], s["jcfg"],
                jnp.zeros((H, W, 3)), 0, SPP, s["key"], queue_size=256,
                steps_per_wave=8, with_stats=True)
            s["jwave"] = (np.asarray(img), {k: np.asarray(v)
                                            for k, v in st.items()})
            s["jmega"] = np.asarray(jint.render(s["scene"], s["flags"],
                                                s["bvh"], s["cam"], s["jcfg"],
                                                s["key"]))
            cache[name] = s
        return cache[name]
    return get


def _graded(a, b, clean_mean):
    per_pix = np.abs(a - b).max(-1)
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < clean_mean


def test_walk_uniforms_match_jax():
    key = jax.random.key(5)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.fold_in(key, i), 1))(jnp.arange(64))
    want = jax.vmap(lambda k: jax.random.uniform(k, (32, 6)))(keys)
    tk = torch.from_numpy(np.asarray(jax.random.key_data(keys))
                          .astype(np.int64))
    np.testing.assert_array_equal(trng.uniform(tk, (32, 6)).numpy(),
                                  np.asarray(want))


def test_scatter_sss_lanes_match_jax():
    """Per-lane ``scatter`` on the SSS materials of mesh_perlin_sss (the
    walk from random hits): same exit/absorb outcome on every lane."""
    s = _build("mesh_perlin_sss")
    mt = np.asarray(s["scene"].mat_type)
    g = np.random.default_rng(1)
    n = 1024
    mat = g.choice(np.nonzero((mt == MAT_SSS_SIMPLE)
                              | (mt == MAT_SSS_VOLUMETRIC))[0], n)
    mat = mat.astype(np.int32)
    p = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    front = g.random(n) < 0.5
    u, v = g.random(n).astype(np.float32), g.random(n).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(s["key"], i))(jnp.arange(n))
    J, T = jnp.asarray, torch.from_numpy
    want = jax.jit(jax.vmap(lambda m, a, b, f, uu, vv, r, k: jsh.scatter(
        s["scene"], s["flags"], 32, m, a, b, f, uu, vv, r, k)))(
        J(mat), J(p), J(nrm), J(front), J(u), J(v), J(rd), keys)
    got = tsh.scatter(s["ts"], s["tflags"], 32, T(mat), T(p), T(nrm),
                      T(front), T(u), T(v), T(rd),
                      T(np.asarray(jax.random.key_data(keys)).astype(np.int64)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0.1 < float(got[0].float().mean()) < 0.95
    for k in (1, 2, 3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


def test_bounce_shade_with_sss_matches_jax():
    """One tiled bounce of every primary ray of subsurface_scattering,
    walk counter included."""
    s = _build("subsurface_scattering", 48, 27)
    n = 48 * 27
    pix = np.arange(n, dtype=np.int32)
    smp = np.zeros(n, np.int32)
    path = tst.spawn_paths(s["tc"], s["tcfg"], s["tk"], torch.from_numpy(smp),
                           torch.from_numpy(pix))
    found, ptype, pidx, _t = ttr.traverse_bvh(s["tb"], path.origin,
                                              path.direction, path.time,
                                              1e-3, 1e9)
    tt = tst.make_tables(s["ts"])
    mtype = tt.mat[tst.refine_hit_t(tt, ptype, pidx, *path.origin.unbind(-1),
                                    *path.direction.unbind(-1), path.time,
                                    1e-3).mat.long(), 0]
    assert bool((found & (mtype == MAT_SSS_VOLUMETRIC)).any())
    zb = torch.zeros(n, dtype=torch.bool)
    rngs = tst.wave_rng(s["tk"], torch.from_numpy(smp), torch.from_numpy(pix),
                        path.iters, has_sss=True)
    got, aux = tst.bounce_shade_t(s["ts"], s["tflags"], s["tc"], s["tcfg"], tt,
                                  path, found, ptype, pidx, zb,
                                  torch.zeros(n), zb, rngs, aux=True)
    J = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jrngs = jst.wave_rng(s["key"], jnp.asarray(smp), jnp.asarray(pix),
                         J(path.iters), True, 32)
    want, jaux = jst.bounce_shade_t(
        s["scene"], s["flags"], s["cam"], s["jcfg"], jst.make_tables(s["scene"]),
        jint.PathState(*[J(x) for x in path]), J(found), J(ptype), J(pidx),
        J(zb), J(torch.zeros(n)), J(zb), jrngs, aux=True)
    assert int(aux["walk_steps"]) == int(jaux["walk_steps"]) > 0
    for f in ("depth", "iters", "alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("origin", "direction", "color", "throughput"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("name", SCENES)
def test_wavefront_sss_matches_jax(built, name):
    s = built(name)
    jimg, jstt = s["jwave"]
    img, st = twf.render_batch(s["ts"], s["tflags"], s["tb"], s["tc"],
                               s["tcfg"], torch.zeros((H, W, 3)), 0, SPP,
                               s["tk"], queue_size=256, steps_per_wave=8,
                               with_stats=True)
    assert int(st["paths"]) == int(jstt["paths"]) == W * H * SPP
    assert int(st["spawned"]) == int(jstt["spawned"])
    assert (st["pixel_paths"].numpy() == SPP).all()
    assert int(st["rays"]) == int(jstt["rays"])
    np.testing.assert_array_equal(st["depth_hist"].numpy(), jstt["depth_hist"])
    assert int(st["walk_steps"]) == int(jstt["walk_steps"]) > 0
    _graded(img.numpy() / SPP, jimg / SPP, CLEAN_MEAN[name])


@pytest.mark.parametrize("name", SCENES)
def test_megakernel_sss_matches_jax(built, name):
    s = built(name)
    jstt = s["jwave"][1]
    img, st = tint.render_batch(s["ts"], s["tflags"], s["tb"], s["tc"],
                                s["tcfg"], torch.zeros((H, W, 3)), 0, SPP,
                                s["tk"], with_stats=True)
    assert int(st["paths"]) == W * H * SPP
    assert int(st["rays"]) == int(jstt["rays"])
    np.testing.assert_array_equal(st["depth_hist"].numpy(), jstt["depth_hist"])
    assert int(st["walk_steps"]) == int(jstt["walk_steps"])
    _graded(img.numpy() / SPP, s["jmega"], CLEAN_MEAN[name])


@pytest.mark.parametrize("name", SCENES)
def test_kernel_sources_with_sss_on_cpu_match_twins(built, name):
    """K3 (in the wave loop) and K5, built for the CPU through
    ``csrc/host_emulation.cpp``, against their twins on SSS scenes: the
    host C library's logf/expf may flip a walk coin, so counters may differ
    by 1% (measured: equal)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    wave_ops, mega_op = kernels.host_emulation_ops()
    s = built(name)
    args = (s["ts"], s["tflags"], s["tb"], s["tc"], s["tcfg"])
    runs = {}
    for tag, ops in (("twin", None), ("emu", wave_ops)):
        eng = twf.WaveEngine(*args, 0, SPP, s["tk"], queue_size=256,
                             steps_per_wave=8, ctrl_den=8)
        ws = eng.init_state(torch.zeros((H, W, 3)))
        saved = twf.KERNELS
        twf.KERNELS = ops or saved
        try:
            twf.run_waves(eng, ws, plain=ops is None)
        finally:
            twf.KERNELS = saved
        runs[tag] = ws
    for tag, op in (("mega_twin", tint.megakernel_plain), ("mega_emu", mega_op)):
        eng = tint.MegaEngine(*args, s["tk"])
        ms = eng.init_state(torch.zeros((H, W, 3)))
        for i in range(SPP):
            op(eng, ms, i)
        runs[tag] = ms
    for a, b in (("twin", "emu"), ("mega_twin", "mega_emu")):
        a, b = runs[a], runs[b]
        assert int(a.ctr[1]) == int(b.ctr[1]) == W * H * SPP
        for i in (2, 3, C_WALK_STEPS):              # rays, depth_sum, walk
            assert abs(int(a.ctr[i]) - int(b.ctr[i])) <= 0.01 * int(a.ctr[i]), i
        assert int(a.ctr[C_WALK_STEPS]) > 0
        per_pix = (a.accum - b.accum).abs().max(-1).values.numpy() / SPP
        assert (per_pix > 1e-3).mean() <= 0.01
        assert per_pix[per_pix <= 1e-3].mean() < 1e-5
    assert torch.equal(runs["twin"].pix_paths, runs["emu"].pix_paths)


@pytest.mark.gpu
def test_sss_kernels_match_twins_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    dev = torch.device("cuda")
    world, cam = ptt.scenes.mesh_perlin_sss()
    cam.img_width, cam.aspect_ratio = 64, 64 / 36
    sc = ptt.compile_scene(world, device=dev)
    args = (sc, tsh.SceneFlags.from_scene(sc), ptt.build_from_scene(sc),
            cam.initialize(device=dev), TCfg(width=64, height=36, max_depth=DEPTH),
            torch.zeros((36, 64, 3), device=dev), 0, 2, trng.key(0, dev))
    kernels.reset_launches()
    out = {}
    for plain in (False, True):
        out["wave", plain] = twf.render_batch(*args, queue_size=1024,
                                              steps_per_wave=8,
                                              with_stats=True, plain=plain)
        out["mega", plain] = tint.render_batch(*args, with_stats=True,
                                               plain=plain)
    assert kernels.LAUNCHES["shade"] > 0 and kernels.LAUNCHES["megakernel"] == 2
    for eng in ("wave", "mega"):
        (a, sa), (b, sb) = out[eng, False], out[eng, True]
        for k in ("paths", "rays", "walk_steps"):
            assert int(sa[k]) == int(sb[k]), (eng, k)
        assert int(sa["walk_steps"]) > 0
        per_pix = (a - b).abs().max(-1).values.cpu().numpy() / 2
        assert (per_pix > 1e-3).mean() <= 0.01
        assert per_pix[per_pix <= 1e-3].mean() < 1e-5
