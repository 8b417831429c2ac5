"""The port's megakernel engine against the JAX package, end to end and by
module.

Same scene, camera, key and sample set on both sides (32x18, 2 spp, depth
10).  The port's ``integrator.render`` is held to JAX ``integrator.render``
within ``atol 2e-5`` (the JAX engine oracle's own limit,
``tests/test_integrator.py:88-90``) on the simple world and ``cornell_box``,
and ``rays``, ``depth_sum`` and ``depth_hist`` of ``render_sample(with_stats
=True)`` exactly on the Cornell scenes.  On ``cornell_smoke`` and
``vol2_final_scene`` the image is held to the graded rule of
``tools/bench_ab.py``: XLA's CPU backend contracts ``a*b+c`` into FMAs and
the port rounds every operation (ROADMAP.md C).  On vol2_final the ray
counters differ by the same few paths as the wavefront's (measured: rays
3884 vs 3893, depth_hist L1 12 of 1152, 4 of 576 pixels outliers); the
limits are those of ``tests/test_torch_wavefront.py``.  The port's two
engines integrate the same sample set: megakernel ≡ wavefront within
``atol 2e-5`` (measured: equal).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import camera as jcam
from path_tracer_tpu.ops import integrator as jint
from path_tracer_tpu.ops import shade as jsh
from path_tracer_tpu.ops import traverse as jtr
from path_tracer_tpu.ops.types import RenderConfig as JCfg
from path_tracer_tpu.render.renderer import _mega_batch
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import camera as tcam
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops import shade as tsh
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.utils import rng as trng

W, H, SPP, DEPTH = 32, 18, 2, 10
SCENES = ["simple", "cornell_box", "cornell_smoke", "vol2_final_scene"]


def _simple_world(pkg):
    w = pkg.HittableList()
    w.add(pkg.Sphere.stationary((0, 0, -1), 0.5, pkg.Lambertian((0.7, 0.3, 0.3))))
    w.add(pkg.Sphere.stationary((0, -100.5, -1), 100,
                                pkg.Lambertian((0.8, 0.8, 0.0))))
    w.add(pkg.Sphere.stationary((1, 0, -1), 0.5, pkg.Metal((0.8, 0.6, 0.2), 0.3)))
    w.add(pkg.Sphere.stationary((-1, 0, -1), 0.5, pkg.Dielectric(1.5)))
    return w, pkg.Camera()


def _build(name):
    if name == "simple":
        world, cam = _simple_world(pt)
    else:
        kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
        world, cam = getattr(pt.scenes, name)(**kw)
    cam.img_width, cam.aspect_ratio = W, W / H
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    cam_a = cam.initialize()
    flags = jsh.SceneFlags.from_scene(scene)
    ts = interop.from_numpy_scene(scene, "cpu")
    key = jax.random.key(0)
    return dict(
        scene=scene, bvh=bvh, cam=cam_a, flags=flags,
        jcfg=JCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH),
        key=key, ts=ts, tflags=tsh.SceneFlags.from_scene(ts),
        tb=interop.from_numpy_bvh(bvh, "cpu"),
        tc=interop.from_numpy_camera(cam_a, "cpu"),
        tcfg=TCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH),
        tk=interop.key_from_data(np.asarray(jax.random.key_data(key)), "cpu"))


@pytest.fixture(scope="module")
def built():
    """Each scene, with its JAX megakernel image and counters, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            s = _build(name)
            s["jimg"] = np.asarray(jint.render(s["scene"], s["flags"], s["bvh"],
                                               s["cam"], s["jcfg"], s["key"]))
            _acc, st = _mega_batch(s["scene"], s["flags"], s["bvh"], s["cam"],
                                   s["jcfg"], jnp.zeros((H, W, 3)), 0, SPP,
                                   s["key"])
            s["jst"] = {k: np.asarray(v) for k, v in st.items()}
            cache[name] = s
        return cache[name]
    return get


def _port(s, fn, *args, **kw):
    return fn(s["ts"], s["tflags"], s["tb"], s["tc"], s["tcfg"], *args, **kw)


@pytest.mark.parametrize("name", SCENES)
def test_render_matches_jax(built, name):
    s = built(name)
    img = _port(s, tint.render, s["tk"]).numpy()
    assert np.isfinite(img).all()
    st = [_port(s, tint.render_sample, i, s["tk"], with_stats=True)[1]
          for i in range(SPP)]
    rays = sum(int(x["rays"]) for x in st)
    dsum = sum(int(x["depth_sum"]) for x in st)
    hist = sum(x["depth_hist"].numpy() for x in st)
    jst = s["jst"]
    assert hist.sum() == W * H * SPP
    if name in ("simple", "cornell_box"):
        np.testing.assert_allclose(img, s["jimg"], atol=2e-5)
    else:
        per_pix = np.abs(img - s["jimg"]).max(-1)
        assert (per_pix > 1e-3).mean() <= 0.01
        assert per_pix[per_pix <= 1e-3].mean() < 1e-5
    if name == "vol2_final_scene":
        assert abs(rays - int(jst["rays"])) <= 0.003 * int(jst["rays"])
        assert np.abs(hist - jst["depth_hist"]).sum() <= 0.015 * W * H * SPP
    else:
        assert rays == int(jst["rays"]) and dsum == int(jst["depth_sum"])
        np.testing.assert_array_equal(hist, jst["depth_hist"])


@pytest.mark.parametrize("name", ["simple", "cornell_box"])
def test_megakernel_matches_wavefront(built, name):
    s = built(name)
    mega = _port(s, tint.render, s["tk"])
    wave = _port(s, twf.render_batch, torch.zeros((H, W, 3)), 0, SPP, s["tk"],
                 queue_size=512)
    np.testing.assert_allclose(mega.numpy(), wave.numpy() / SPP, atol=2e-5)


def _rays(n, seed, lo, hi):
    g = np.random.default_rng(seed)
    ro = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd, g.uniform(0, 1, n).astype(np.float32)


def test_traverse_bvh_matches_brute_force_and_jax(built):
    """Per-ray walk to completion: same closest hit as the brute-force
    oracle and as JAX ``traverse_bvh`` (``best_t`` to 1e-6 relative plus
    one ulp of the scene's extent, as ``test_torch_traverse.py``)."""
    s = built("vol2_final_scene")
    ro, rd, time = _rays(512, 3, -100.0, 600.0)
    o, d, t = map(torch.from_numpy, (ro, rd, time))
    hit, pt_, pi_, bt = ttr.traverse_bvh(s["tb"], o, d, t, 1e-3, 1e9)
    assert float(hit.float().mean()) > 0.3
    found, bpt, bpi, tt = ttr.first_hit_brute(s["ts"], o, d, t, 1e-3, 1e9)
    np.testing.assert_array_equal(hit.numpy(), found.numpy())
    np.testing.assert_allclose(bt[found].numpy(), tt[found].numpy(), rtol=1e-4)
    diff = found & ((pt_ != bpt) | (pi_ != bpi))
    assert float(diff.float().mean()) < 0.01
    jh, jpt, jpi, jt = jax.jit(jax.vmap(lambda a, b, c: jtr.traverse_bvh(
        s["bvh"], a, b, c, 1e-3, 1e9)))(jnp.asarray(ro), jnp.asarray(rd),
                                         jnp.asarray(time))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(pi_.numpy(), np.asarray(jpi))
    extent = np.float32(np.abs(np.asarray(s["bvh"].nodes)[:, :24]).max())
    np.testing.assert_allclose(bt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=np.spacing(extent))


def test_get_ray_and_refine_hit_match_jax(built):
    s = built("vol2_final_scene")
    n = 256
    g = np.random.default_rng(5)
    pix = g.integers(0, W * H, n).astype(np.int32)
    px, py = (pix % W).astype(np.float32), (pix // W).astype(np.float32)
    keys = jax.vmap(lambda p: jax.random.fold_in(s["key"], p))(jnp.asarray(pix))
    jo, jd, jt = jax.vmap(lambda a, b, k: jcam.get_ray(s["cam"], a, b, k))(
        jnp.asarray(px), jnp.asarray(py), keys)
    tkeys = torch.from_numpy(np.asarray(jax.random.key_data(keys))
                             .astype(np.int64))
    o, d, t = tcam.get_ray(s["tc"], torch.from_numpy(px), torch.from_numpy(py),
                           tkeys)
    for got, want in ((o, jo), (d, jd), (t, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    bg = tcam.background_color(s["tc"], d)
    np.testing.assert_allclose(bg.numpy(), np.asarray(
        jax.vmap(lambda r: jcam.background_color(s["cam"], r))(jd)),
        rtol=1e-6, atol=1e-6)
    hit, ptype, pidx, _t = ttr.traverse_bvh(s["tb"], o, d, t, 1e-3, 1e9)
    assert bool(hit.any())
    want = jax.vmap(lambda a, b, r, q, tm: jtr.refine_hit(
        s["scene"], a, b, r, q, tm, 1e-3))(
        jnp.asarray(ptype.numpy()), jnp.asarray(pidx.numpy()), jo, jd, jt)
    got = ttr.refine_hit(s["ts"], ptype, pidx, o, d, t, 1e-3)
    m = hit.numpy()
    for f in ("hit", "front_face", "mat", "medium"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("t", "p", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[m],
                                   np.asarray(getattr(want, f))[m], rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    front = tint.prim_front_face(s["ts"], ptype, pidx, o, d, t, _t)
    np.testing.assert_array_equal(front.numpy()[m], np.asarray(jax.vmap(
        lambda a, b, r, q, tm, th: jint.prim_front_face(
            s["scene"], a, b, r, q, tm, th))(
        jnp.asarray(ptype.numpy()), jnp.asarray(pidx.numpy()), jo, jd, jt,
        jnp.asarray(_t.numpy())))[m])
    np.testing.assert_array_equal(
        tint.prim_medium_of(s["ts"], ptype, pidx).numpy(),
        np.asarray(jint.prim_medium_of(s["scene"], jnp.asarray(ptype.numpy()),
                                       jnp.asarray(pidx.numpy()))))


def test_scatter_emitted_medium_match_jax(built):
    """Per-lane ``scatter``, ``emitted`` and ``_medium_sample`` lane for lane
    on vol2_final's materials (every family but SSS) with JAX's keys."""
    s = built("vol2_final_scene")
    n = 512
    g = np.random.default_rng(11)
    mat = g.integers(0, int(np.asarray(s["scene"].mat_type).shape[0]),
                     n).astype(np.int32)
    p = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    front = g.random(n) < 0.5
    u, v = g.random(n).astype(np.float32), g.random(n).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(s["key"], i))(jnp.arange(n))
    tkeys = torch.from_numpy(np.asarray(jax.random.key_data(keys))
                             .astype(np.int64))
    J = jnp.asarray
    want = jax.vmap(lambda m, a, b, f, uu, vv, r, k: jsh.scatter(
        s["scene"], s["flags"], 32, m, a, b, f, uu, vv, r, k))(
        J(mat), J(p), J(nrm), J(front), J(u), J(v), J(rd), keys)
    T = torch.from_numpy
    got = tsh.scatter(s["ts"], s["tflags"], 32, T(mat), T(p), T(nrm),
                      T(front), T(u), T(v), T(rd), tkeys)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for k in (1, 2, 3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    we = jax.vmap(lambda m, uu, vv, a: jsh.emitted(s["scene"], s["flags"], m,
                                                   uu, vv, a))(J(mat), J(u),
                                                               J(v), J(p))
    ge = tsh.emitted(s["ts"], s["tflags"], T(mat), T(u), T(v), T(p))
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=1e-5, atol=1e-5)
    # Medium free flight over random chords.
    t1 = g.uniform(0, 2, n).astype(np.float32)
    t2 = (t1 + g.uniform(0, 40, n)).astype(np.float32)
    med = g.integers(0, int(np.asarray(s["scene"].med_density).shape[0]),
                     n).astype(np.int32)
    ok = g.random(n) < 0.8
    zero = np.zeros(n, np.int32)
    jst = jint.PathState(J(p), J(rd), J(u), J(p), J(p), J(zero), J(zero),
                         J(ok))
    wm = jax.vmap(lambda st, a, b, m, r, k: jint._medium_sample(
        s["scene"], s["flags"], s["jcfg"], st, a, b, m, r, k))(
        jst, J(t1), J(t2), J(med), J(ok), keys)
    tst = tint.PathState(T(p), T(rd), T(u), T(p), T(p), T(zero), T(zero), T(ok))
    gm = tint._medium_sample(s["ts"], s["tflags"], s["tcfg"], tst, T(t1),
                             T(t2), T(med), T(ok), tkeys)
    np.testing.assert_array_equal(gm[0].numpy(), np.asarray(wm[0]))
    assert bool(gm[0].any()) and not bool(gm[0].all())
    for k in (1, 2):
        np.testing.assert_allclose(gm[k].numpy(), np.asarray(wm[k]),
                                   rtol=1e-5, atol=1e-5)


def _mega_frames(s, op):
    eng = tint.MegaEngine(s["ts"], s["tflags"], s["tb"], s["tc"], s["tcfg"],
                          s["tk"])
    ms = eng.init_state(torch.zeros((H, W, 3)))
    for i in range(SPP):
        op(eng, ms, i)
    return ms


@pytest.mark.parametrize("name", ["cornell_box", "vol2_final_scene"])
def test_kernel_source_on_cpu_matches_twin(built, name):
    """K5's per-pixel code (``csrc/megakernel.cu``) built for the CPU
    against its twin.  The host C library's sinf/cosf/logf and torch's
    differ in the last ulp, so counters may differ by 1% (measured: equal)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    _wave, emu = kernels.host_emulation_ops()
    s = built(name)
    a = _mega_frames(s, tint.megakernel_plain)
    b = _mega_frames(s, emu)
    for i in (1, 2, 3, 7):                      # paths, rays, depth_sum, steps
        assert abs(int(a.ctr[i]) - int(b.ctr[i])) <= 0.01 * int(a.ctr[i]), i
    assert int(a.ctr[1]) == int(b.ctr[1]) == W * H * SPP
    assert int(b.ctr[14]) == 0                  # no stack overflow
    assert (a.depth_hist - b.depth_hist).abs().sum() <= 0.01 * W * H * SPP
    per_pix = (a.accum - b.accum).abs().max(-1).values.numpy() / SPP
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5


def test_trace_ray_is_render_sample_per_pixel(built):
    """``trace_ray`` of each pixel's camera ray with its key ``key_p`` gives
    that pixel's ``render_sample`` radiance."""
    s = built("cornell_smoke")
    pix = torch.arange(W * H, dtype=torch.int32)
    key_p = trng.fold_in(trng.fold_in(s["tk"], 1), pix)
    o, d, t = tcam.get_ray(s["tc"], (pix % W).float(), (pix // W).float(),
                           trng.fold_in(key_p, 7))
    col = _port(s, tint.trace_ray, o, d, t, key_p)
    img = _port(s, tint.render_sample, 1, s["tk"])
    torch.testing.assert_close(col.reshape(H, W, 3), img, rtol=0, atol=0)


def test_default_engine_factory_and_refusals():
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 8
    r = ptt.Renderer(world, cam, device="cpu")
    assert r.engine == "megakernel"
    img = r.render(spp=1)
    assert np.isfinite(img).all() and r.stats.paths == 64
    assert r.stats.waves == 0 and r.stats.rays >= r.stats.paths
    assert not hasattr(r.stats, "pixel_paths")   # the Renderer reads none
    f = ptt.RendererFactory.create("cpu", world, cam, device="cpu")
    assert f.engine == "megakernel"
    np.testing.assert_array_equal(f.render(spp=1), img)
    np.testing.assert_array_equal(
        ptt.render_scene(world, cam, spp=1, device="cpu"), img)
    args = (r.scene, r.flags, r.bvh, r.cam_arrays, r.cfg)
    # The differentiable entry points render the forward image.
    torch.testing.assert_close(
        tint.render(*args, r.key, differentiable=True, spp=1),
        tint.render(*args, r.key, spp=1), rtol=0, atol=0)
    torch.testing.assert_close(
        tint.render_sample(*args, 0, r.key, differentiable=True),
        tint.render_sample(*args, 0, r.key), rtol=0, atol=0)
    pix = torch.arange(64, dtype=torch.int32)
    key_p = trng.fold_in(trng.fold_in(r.key, 0), pix)
    o, d, t = tcam.get_ray(r.cam_arrays, (pix % 8).float(),
                           (pix // 8).float(), trng.fold_in(key_p, 7))
    torch.testing.assert_close(tint.trace_ray_scan(*args, o, d, t, key_p),
                               tint.trace_ray(*args, o, d, t, key_p),
                               rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell_smoke", "vol2_final_scene"])
def test_megakernel_matches_twin_on_card(cuda_device, name):
    kw = {"sphere_cluster": 1000} if name == "vol2_final_scene" else {}
    world, cam = getattr(ptt.scenes, name)(**kw)
    cam.img_width, cam.aspect_ratio = 64, 64 / 36
    sc = ptt.compile_scene(world, device=cuda_device)
    args = (sc, tsh.SceneFlags.from_scene(sc), ptt.build_from_scene(sc),
            cam.initialize(device=cuda_device),
            TCfg(width=64, height=36, max_depth=DEPTH),
            torch.zeros((36, 64, 3), device=cuda_device), 0, 2,
            trng.key(0, cuda_device))
    kernels.reset_launches()
    a, sa = tint.render_batch(*args, with_stats=True)
    assert kernels.LAUNCHES["megakernel"] == 2
    b, sb = tint.render_batch(*args, with_stats=True, plain=True)
    for k in ("paths", "rays", "depth_sum", "trav_steps", "stack_overflows"):
        assert int(sa[k]) == int(sb[k]), k
    per_pix = (a - b).abs().max(-1).values.cpu().numpy() / 2
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5
