"""BVH8 rows (``build_from_scene(branching=8)``) through the port's engines
and walking kernels, against the JAX package and the twins.

* ``wavefront.render_batch``, ``integrator.render`` and ``render_tiled`` on
  cornell_box (32x18, 2 spp, depth 10) over JAX's BVH8 against the JAX
  engines over the same tree: images within atol 2e-5 (the JAX engine
  oracle's limit, ``tests/test_integrator.py:88-90``); ``paths``,
  ``spawned``, ``rays``, ``trav_steps``, the wave schedule and the depth
  histogram of the wavefront, and ``rays``, ``depth_sum`` and the depth
  histogram of the megakernel, exactly equal.  The BVH crosses over by
  ``interop.from_numpy_bvh``, which carries ``branching``.
* Gradients of two leaves (``sph_rad``, ``tex_c1``) of a render of 24
  spheres over a BVH8 against ``jax.grad`` over JAX's (atol 2e-5, rtol
  1e-3, ``tests/test_torch_grad.py``) and against the port's over a BVH4
  (bit for bit).
* The per-lane code of K5 (``mega_pixel``), K6 (``adj_begin`` /
  ``adj_trip`` and the sweeps, both instantiations), K7 (``closest_hit_lane``) and K9
  (``ring_hop_lane``) at K = 8, built by g++ (``csrc/host_emulation.cpp``),
  against their twins, with the tolerances of the BVH4 tests of the same
  code (``tests/test_torch_{megakernel,adjoint,tiled}.py``).  K1's wave
  at K = 8 is a case of
  ``test_torch_kernels.py::test_kernel_sources_on_cpu_match_twins`` and,
  exactly against the twin, of ``test_emulated_k1_matches_twin_at_k8``.
* On a CUDA card (marker ``gpu``): K1 at K = 8 exactly equal to its twin
  on a mid-flight pool, K5, K7 and K9 at K = 8 against theirs.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import integrator_tiled as jit_
from path_tracer_tpu.ops import wavefront as jwf
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
from path_tracer_tpu.render.renderer import _mega_batch
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import adjoint
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import integrator_tiled as it
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.parallel import pipeline
from path_tracer_tpu_torch.utils import rng as trng

from test_torch_grad import _both as _grad_both
from test_torch_grad import check_render_grad
from test_torch_wave_exit import check_emulated_k1

W, H, SPP, DEPTH = 32, 18, 2, 10
WAVE = dict(queue_size=256, steps_per_wave=8)
WAVE_COUNTERS = ("paths", "spawned", "rays", "trav_steps", "waves", "ctrls",
                 "occ_sum", "exec_steps")


@pytest.fixture(scope="module")
def cornell8():
    """cornell_box at W x H in both packages over JAX's BVH8."""
    world, cam = pt.scenes.cornell_box()
    cam.img_width, cam.aspect_ratio = W, W / H
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene, branching=8)
    cam_a = cam.initialize()
    key = jax.random.key(0)
    ts = interop.from_numpy_scene(scene, "cpu")
    tb = interop.from_numpy_bvh(bvh, "cpu")
    assert tb.branching == 8 and tb.nodes.shape[1] == 184
    kw = dict(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH)
    return dict(j=(scene, JFlags.from_scene(scene), bvh, cam_a, JCfg(**kw)),
                t=(ts, TFlags.from_scene(ts), tb,
                   interop.from_numpy_camera(cam_a, "cpu"), TCfg(**kw)),
                key=key,
                tk=interop.key_from_data(np.asarray(jax.random.key_data(key)),
                                         "cpu"))


@pytest.mark.parametrize("engine", ["wavefront", "megakernel", "tiled"])
def test_engine_matches_jax_at_k8(cornell8, engine):
    j, t, key, tk = cornell8["j"], cornell8["t"], cornell8["key"], \
        cornell8["tk"]
    if engine == "wavefront":
        jimg, jst = jwf.render_batch(*j, jnp.zeros((H, W, 3)), 0, SPP, key,
                                     with_stats=True, **WAVE)
        timg, tst = twf.render_batch(*t, torch.zeros((H, W, 3)), 0, SPP, tk,
                                     with_stats=True, **WAVE)
        for k in WAVE_COUNTERS:
            assert int(tst[k]) == int(jst[k]), k
        np.testing.assert_array_equal(tst["depth_hist"].numpy(),
                                      np.asarray(jst["depth_hist"]))
        assert int(tst["trav_steps"]) > 0 and int(tst["stack_overflows"]) == 0
        jimg, timg = np.asarray(jimg) / SPP, timg.numpy() / SPP
    elif engine == "megakernel":
        acc, jst = _mega_batch(*j, jnp.zeros((H, W, 3)), 0, SPP, key)
        jimg = np.asarray(acc) / SPP
        timg = tint.render(*t, tk).numpy()
        st = [tint.render_sample(*t, i, tk, with_stats=True)[1]
              for i in range(SPP)]
        assert sum(int(x["rays"]) for x in st) == int(jst["rays"])
        assert sum(int(x["depth_sum"]) for x in st) == int(jst["depth_sum"])
        np.testing.assert_array_equal(
            sum(x["depth_hist"].numpy() for x in st),
            np.asarray(jst["depth_hist"]))
        assert all(int(x["stack_overflows"]) == 0 for x in st)
    else:
        jimg = np.asarray(jit_.render_tiled(*j, key, spp=SPP))
        timg, tst = it.render_tiled(*t, tk, spp=SPP, with_stats=True)
        timg = timg.numpy()
        assert int(tst["trav_steps"]) > 0
    assert np.isfinite(timg).all() and float(timg.mean()) > 0
    np.testing.assert_allclose(timg, jimg, atol=2e-5)


def _sphere_field(pkg):
    """24 spheres, diffuse and fuzzed metal, under the gradient sky: enough
    primitives for interior BVH8 nodes, and leaves that move rays."""
    g = np.random.default_rng(5)
    w = pkg.HittableList()
    for i in range(24):
        mat = (pkg.Metal((0.8, 0.7, 0.6), 0.2) if i % 2
               else pkg.Lambertian((0.6, 0.5, 0.4)))
        w.add(pkg.Sphere.stationary(tuple(g.uniform(-3.0, 3.0, 3)),
                                    float(g.uniform(0.3, 0.8)), mat))
    cam = pkg.Camera()
    cam.aspect_ratio = 1.6
    cam.img_width = 16
    cam.lookfrom = np.array([0.0, 0.0, 8.0])
    cam.lookat = np.array([0.0, 0.0, 0.0])
    return w, cam


def test_render_grads_match_jax_at_k8():
    """``sph_rad`` and ``tex_c1`` through a render of 24 spheres over a BVH8
    against ``jax.grad`` over JAX's, with ``tests/test_torch_grad.py``'s
    check (atol 2e-5, rtol 1e-3), and against the port's own gradient over
    the BVH4, bit for bit.  Measured against ``jax.grad``: relative L2
    1.6e-3 (``sph_rad``) and 1.0e-5 (``tex_c1``), at K = 4 and K = 8 alike:
    XLA's fused multiply-adds on the CPU (ROADMAP.md C), not the tree."""
    setup = (_sphere_field, (16, 10, 2, 4), 7, ("sph_rad", "tex_c1"), ())
    got = check_render_grad(setup, branching=8)
    _, (ts, tb4, tc) = _grad_both(_sphere_field, 16, 10, 4)
    assert int(tb4.root) >= 0
    xs = {n: getattr(ts, n).clone().requires_grad_() for n in setup[3]}
    img = tint.render(dataclasses.replace(ts, **xs), TFlags.from_scene(ts),
                      tb4, tc, TCfg(width=16, height=10, samples_per_pixel=2,
                                    max_depth=4, use_russian_roulette=False),
                      interop.key_from_data(np.asarray(jax.random.key_data(
                          jax.random.key(7))), "cpu"), differentiable=True)
    (img.sum() / img.numel()).backward()
    for n in setup[3]:
        assert np.array_equal(xs[n].grad.numpy(), got[n][0]), n


# ---------------------------------------------------------------------------
# The walking kernels' per-lane code at K = 8, built for the CPU.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    return dict(lanes=kernels.host_emulation_lanes(),
                mega=kernels.host_emulation_ops()[1],
                full=kernels.host_emulation_adjoint(full=True),
                colour=kernels.host_emulation_adjoint(full=False))


def _port_scene(name, width=W, height=H, depth=DEPTH, branching=8, **cfg):
    kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
    world, cam = getattr(ptt.scenes, name)(**kw)
    cam.img_width, cam.aspect_ratio = width, width / height
    sc = ptt.compile_scene(world, device="cpu")
    return (sc, TFlags.from_scene(sc), ptt.build_from_scene(sc, branching),
            cam.initialize(device="cpu"),
            TCfg(width=width, height=height, samples_per_pixel=SPP,
                 max_depth=depth, **cfg))


def _mega_frames(eng, op):
    ms = eng.init_state(torch.zeros((eng.npix, 3)))
    for i in range(SPP):
        op(eng, ms, i)
    return ms


@pytest.mark.parametrize("name", ["cornell_box", "vol2_final_scene"])
def test_emulated_k1_matches_twin_at_k8(name):
    """K1's wave at K = 8 (g++ build) against the twin at chunk 4: lanes,
    stack and counters exact, on pools where leaf children clip later
    boxes on vol2_final (4 such lanes)."""
    events = check_emulated_k1(name, 8)
    assert events > 0 or name == "cornell_box"


@pytest.mark.parametrize("name", ["cornell_smoke", "vol2_final_scene"])
def test_emulated_megakernel_matches_twin_at_k8(emu, name):
    """K5 at K = 8 as ``test_torch_megakernel.py``'s K = 4 check: counters
    within 1% (host libm against torch's in the last ulp), the graded
    image rule, no dropped push."""
    eng = tint.MegaEngine(*_port_scene(name), trng.key(0))
    assert eng.bvh.branching == 8
    a = _mega_frames(eng, tint.megakernel_plain)
    b = _mega_frames(eng, emu["mega"])
    for i in (1, 2, 3, 7):                      # paths, rays, depth_sum, steps
        assert abs(int(a.ctr[i]) - int(b.ctr[i])) <= 0.01 * int(a.ctr[i]), i
    assert int(a.ctr[1]) == int(b.ctr[1]) == W * H * SPP
    assert int(b.ctr[14]) == 0
    per_pix = (a.accum - b.accum).abs().max(-1).values.numpy() / SPP
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5


def test_emulated_adjoint_matches_plain_at_k8(emu):
    """K6 at K = 8, both instantiations, on one sample, as
    ``test_torch_adjoint.py``'s check: per leaf rel L2 ≤ 1e-4 against the
    plain path, pixels whose emulated forward differs from the twin's left
    out (≤ 5%)."""
    eng = tint.MegaEngine(*_port_scene("vol2_final_scene"), trng.key(0))
    sc = eng.scene
    delta = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (W * H, 3)).astype(np.float32))
    gp, gf, gc, gpc = (adjoint.grad_buffers(sc) for _ in range(4))
    mk, mp = (eng.init_state(torch.zeros((W * H, 3))) for _ in range(2))
    emu["mega"](eng, mk, 0)
    tint.megakernel_plain(eng, mp, 0)
    same = (mk.color == mp.color).all(-1)
    assert int((~same).sum()) <= 0.05 * W * H
    d = delta * same[:, None]
    adjoint.adjoint(eng, mp, 0, d, gp, full=True)
    adjoint.adjoint(eng, mp, 0, d, gpc)
    emu["full"](eng, mp, 0, d, gf)
    emu["colour"](eng, mp, 0, d, gc)
    P, F = adjoint.leaf_grads(sc, gp), adjoint.leaf_grads(sc, gf)
    PC, C = adjoint.leaf_grads(sc, gpc), adjoint.leaf_grads(sc, gc)
    for n in adjoint.FLOAT_LEAVES:
        assert bool(torch.isfinite(F[n]).all()), n
        assert float((F[n] - P[n]).norm()) <= 1e-4 * float(P[n].norm()), n
    for n in adjoint.COLOUR_LEAVES:
        assert float((C[n] - PC[n]).norm()) <= 1e-4 * float(PC[n].norm()), n
    assert float(F["sph_c0"].abs().sum()) > 0
    assert float(C["img_data"].abs().sum()) > 0


def _lane_args(eng, R, ctr, **lanes):
    a = kernels.fill_args(eng)
    kernels.set_lanes(a, R, torch.device("cpu"), ctr, **lanes)
    return kernels.set_stack(a, R, "cpu")


def test_emulated_lane_queries_match_plain_at_k8(emu):
    """K7's and K9's lane code at K = 8 against their plain versions on
    the camera rays of a vol2_final frame: hits, ``t`` and the traversal
    steps exactly, K9's refined record as ``test_torch_tiled.py``'s."""
    eng = it.TiledEngine(*_port_scene("vol2_final_scene"),
                         torch.tensor([0, 3]))
    R = W * H
    st = it.tiled_spawn(eng, 0, torch.arange(R, dtype=torch.int32))
    t_min = torch.full((R,), eng.cfg.t_min)
    c_p, c_k = it.new_counters("cpu"), it.new_counters("cpu")
    hit = it.closest_hit_plain(eng.bvh, st.origin, st.direction, st.time,
                               t_min, eng.cfg.t_max, eng.cfg.stack_depth,
                               st.alive, c_p)
    out = [torch.empty_like(x) for x in hit]
    emu["lanes"]["closest_hit"](_lane_args(
        eng, R, c_k, origin=st.origin, direction=st.direction, time=st.time,
        q_tmin=t_min, q_active=st.alive, hit_found=out[0], hit_pt=out[1],
        hit_pi=out[2], hit_t=out[3]))
    for x, y in zip(hit, out):
        assert torch.equal(x, y)
    assert bool(hit[0].any())
    assert int(c_p[it.C_TRAV_STEPS]) == int(c_k[it.C_TRAV_STEPS]) > 0
    fnd = torch.zeros((R,), dtype=torch.bool)
    tb = torch.full((R,), 1e30)
    rec = pipeline._empty_rec(R, "cpu")
    pipeline.ring_hop_plain(eng, st.origin, st.direction, st.time, t_min,
                            st.alive, fnd, tb, rec)
    k_fnd, k_tb = torch.zeros_like(fnd), torch.full_like(tb, 1e30)
    k_rec = pipeline._empty_rec(R, "cpu")
    emu["lanes"]["ring_hop"](_lane_args(
        eng, R, it.new_counters("cpu"), origin=st.origin,
        direction=st.direction, time=st.time, q_tmin=t_min,
        q_active=st.alive, hit_found=k_fnd, hit_t=k_tb, rec=k_rec))
    assert torch.equal(fnd, k_fnd) and torch.equal(tb, k_tb)
    torch.testing.assert_close(k_rec, rec, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


def _card_scene(dev, name="vol2_final_scene", width=160, height=90):
    kw = {"sphere_cluster": 1000} if name == "vol2_final_scene" else {}
    world, cam = getattr(ptt.scenes, name)(**kw)
    cam.img_width, cam.aspect_ratio = width, width / height
    sc = ptt.compile_scene(world, device=dev)
    return (sc, TFlags.from_scene(sc), ptt.build_from_scene(sc, branching=8),
            cam.initialize(device=dev),
            TCfg(width=width, height=height, samples_per_pixel=SPP,
                 max_depth=DEPTH))


@pytest.mark.gpu
def test_trace_step_at_k8_equals_twin_on_card(cuda_device):
    """K1 at K = 8 on a mid-flight pool: lanes, stack and counters exactly
    equal to the twin's (the chip's gate at K = 4)."""
    sc, fl, bvh, cam, cfg = _card_scene(cuda_device)
    eng = twf.WaveEngine(sc, fl, bvh, cam, cfg, 0, SPP,
                         trng.key(0, cuda_device), queue_size=4096,
                         steps_per_wave=32, ctrl_den=8)
    ws = eng.init_state(torch.zeros((cfg.height, cfg.width, 3),
                                    device=cuda_device))
    for _ in range(12):
        for op in twf.KERNELS:
            op(eng, ws)
    k_ws, p_ws = ws.clone(), ws.clone()
    kernels.reset_launches()
    kernels.launch("trace_step", eng, k_ws)
    ttr.trace_step_plain(eng, p_ws)
    assert kernels.INSTANCES["trace_step_k8"] == 1
    for f in ("cur", "sp", "best_pt", "best_pi", "best_t", "stack", "ctr"):
        assert torch.equal(getattr(k_ws, f), getattr(p_ws, f)), f


@pytest.mark.gpu
def test_walking_kernels_at_k8_match_twins_on_card(cuda_device):
    """K5, K7 and K9 at K = 8 against their twins: K5's counters exactly
    and its image under the graded rule, K7's and K9's hits exactly."""
    sc, fl, bvh, cam, cfg = _card_scene(cuda_device)
    key = trng.key(0, cuda_device)
    zero = torch.zeros((cfg.height, cfg.width, 3), device=cuda_device)
    kernels.reset_launches()
    a, sa = tint.render_batch(sc, fl, bvh, cam, cfg, zero, 0, SPP, key,
                              with_stats=True)
    assert kernels.INSTANCES["megakernel_k8"] == SPP
    b, sb = tint.render_batch(sc, fl, bvh, cam, cfg, zero, 0, SPP, key,
                              with_stats=True, plain=True)
    for k in ("paths", "rays", "depth_sum", "trav_steps", "stack_overflows"):
        assert int(sa[k]) == int(sb[k]), k
    per_pix = (a - b).abs().max(-1).values.cpu().numpy() / SPP
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5
    eng = it.TiledEngine(sc, fl, bvh, cam, cfg, key)
    R = cfg.width * cfg.height
    st = it.tiled_spawn(eng, 0, torch.arange(R, dtype=torch.int32,
                                             device=cuda_device))
    t_min = torch.full((R,), cfg.t_min, device=cuda_device)
    q = (bvh, st.origin, st.direction, st.time, t_min, cfg.t_max,
         cfg.stack_depth)
    c_k, c_p = it.new_counters(cuda_device), it.new_counters(cuda_device)
    for x, y in zip(it.closest_hit_batched(*q, active=st.alive, ctr=c_k),
                    it.closest_hit_plain(*q, active=st.alive, ctr=c_p)):
        assert torch.equal(x, y)
    assert torch.equal(c_k, c_p)
    carry = (torch.zeros((R,), dtype=torch.bool, device=cuda_device),
             torch.full((R,), 1e30, device=cuda_device),
             pipeline._empty_rec(R, cuda_device))
    k = tuple(x.clone() for x in carry)
    p = tuple(x.clone() for x in carry)
    ray = (st.origin, st.direction, st.time, t_min, st.alive)
    pipeline.ring_hop(eng, *ray, *k)
    pipeline.ring_hop_plain(eng, *ray, *p)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    torch.testing.assert_close(k[2], p[2], rtol=1e-4, atol=1e-4)
    assert kernels.INSTANCES["closest_hit_k8"] == 1
    assert kernels.INSTANCES["ring_hop_k8"] == 1
