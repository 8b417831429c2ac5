"""The walking kernels' per-thread arrays beyond their local sizes: K5, K7
and K9 with a stack deeper than ``kernels.MEGA_STACK``, K6 with more loop
trips than ``adjoint.TAPE_MAX`` and more SSS walk steps than
``adjoint.WALK_MAX``.  Each is the instantiation that keeps the arrays in
per-lane buffers, chosen by shape; the per-lane code is built by g++
(``csrc/host_emulation.cpp``), as the kernels' launchers pick it.

* A stack of 70 entries (``max_stack`` and ``stack_depth`` raised; the walk
  never needs more than the tree's true depth) gives results bit-equal to
  the local stack, at K = 4 and K = 8.
* K6 at ``max_depth`` 60 (68 trips) with its tape in the per-pixel buffer,
  colour and full, and the full K6 with 80 SSS walk steps, against the
  plain path (autograd of the twin's replay) with ``test_torch_adjoint.py``'s
  rule; the same gradients, bit for bit, when a small budget splits the
  frame into pixel blocks.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.ops import adjoint
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import integrator_tiled as it
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.parallel import pipeline
from path_tracer_tpu_torch.utils import rng as trng

from test_torch_grad import _WAX

W, H, SPP = 24, 14, 2
DEEP = 70      # stack entries: above the kernels' local 64


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    return dict(lanes=kernels.host_emulation_lanes(),
                mega=kernels.host_emulation_ops()[1])


def _compiled(world, cam, depth, branching=4, **cfg):
    cam.img_width, cam.aspect_ratio = W, W / H
    sc = ptt.compile_scene(world, device="cpu")
    return (sc, TFlags.from_scene(sc), ptt.build_from_scene(sc, branching),
            cam.initialize(device="cpu"),
            TCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=depth,
                 **cfg))


def _deep(args):
    """The same scene with a 70-entry stack: max_stack and stack_depth
    raised."""
    sc, fl, bvh, cam, cfg = args
    return (sc, fl, dataclasses.replace(bvh, max_stack=DEEP), cam,
            dataclasses.replace(cfg, stack_depth=DEEP))


def _vol2(branching):
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=20)
    return _compiled(world, cam, 10, branching)


@pytest.mark.parametrize("branching", [4, 8])
def test_deep_stack_megakernel_equals_local(emu, branching):
    out = []
    for args in (_vol2(branching), _deep(_vol2(branching))):
        eng = tint.MegaEngine(*args, trng.key(0))
        ms = eng.init_state(torch.zeros((W * H, 3)))
        for s in range(SPP):
            emu["mega"](eng, ms, s)
        out.append((eng, ms))
    (e0, a), (e1, b) = out
    assert e0.sd <= kernels.MEGA_STACK < e1.sd == DEEP
    assert kernels.instance("megakernel", ms._emu_args[1]) == \
        f"megakernel_k{branching}_global"
    for f in ("accum", "color", "iters", "depth", "depth_hist", "ctr"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(b.ctr[7]) > 0 and int(b.ctr[14]) == 0


def _lane_args(eng, R, ctr, **lanes):
    a = kernels.fill_args(eng)
    kernels.set_lanes(a, R, torch.device("cpu"), ctr, **lanes)
    return kernels.set_stack(a, R, "cpu")


@pytest.mark.parametrize("branching", [4, 8])
def test_deep_stack_lane_queries_equal_local(emu, branching):
    """K7 and K9 on the camera rays of a vol2_final frame."""
    res = []
    for args in (_vol2(branching), _deep(_vol2(branching))):
        eng = it.TiledEngine(*args, torch.tensor([0, 3]))
        R = W * H
        st = it.tiled_spawn(eng, 0, torch.arange(R, dtype=torch.int32))
        t_min = torch.full((R,), eng.cfg.t_min)
        ctr = it.new_counters("cpu")
        hit = [torch.empty((R,), dtype=d) for d in (torch.bool, torch.int32,
                                                     torch.int32,
                                                     torch.float32)]
        a = _lane_args(eng, R, ctr, origin=st.origin, direction=st.direction,
                       time=st.time, q_tmin=t_min, q_active=st.alive,
                       hit_found=hit[0], hit_pt=hit[1], hit_pi=hit[2],
                       hit_t=hit[3])
        emu["lanes"]["closest_hit"](a)
        carry = (torch.zeros((R,), dtype=torch.bool), torch.full((R,), 1e30),
                 pipeline._empty_rec(R, "cpu"))
        emu["lanes"]["ring_hop"](_lane_args(
            eng, R, ctr, origin=st.origin, direction=st.direction,
            time=st.time, q_tmin=t_min, q_active=st.alive,
            hit_found=carry[0], hit_t=carry[1], rec=carry[2]))
        res.append((eng, a, hit, carry, ctr))
    (e0, _, h0, c0, n0), (e1, a1, h1, c1, n1) = res
    assert e0.sd <= kernels.MEGA_STACK < e1.sd == DEEP
    assert a1.stack is not None
    assert kernels.instance("closest_hit", a1) == \
        f"closest_hit_k{branching}_global"
    for x, y in zip((*h0, *c0, n0), (*h1, *c1, n1)):
        assert torch.equal(x, y)
    assert bool(h0[0].any()) and int(n0[7]) > 0


def _check_adjoint(eng, full, names, budget=None):
    """The emulated K6 (``full`` or colour) against the plain path over SPP
    samples (pixel-samples whose emulated forward differs from the twin's
    left out, as ``test_torch_adjoint.py``) → the emulated buffers."""
    mega = kernels.host_emulation_ops()[1]
    op = kernels.host_emulation_adjoint(full=full, budget=budget)
    delta = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (eng.npix, 3)).astype(np.float32))
    gp, ge = adjoint.grad_buffers(eng.scene), adjoint.grad_buffers(eng.scene)
    left_out = 0
    for s in range(SPP):
        mk, mp = (eng.init_state(torch.zeros((eng.npix, 3)))
                  for _ in range(2))
        mega(eng, mk, s)
        tint.megakernel_plain(eng, mp, s)
        same = (mk.color == mp.color).all(-1)
        left_out += int((~same).sum())
        d = delta * same[:, None]
        adjoint.adjoint(eng, mp, s, d, gp, full=full)
        op(eng, mp, s, d, ge)
    assert left_out <= 0.05 * eng.npix * SPP
    P, E = adjoint.leaf_grads(eng.scene, gp), adjoint.leaf_grads(eng.scene, ge)
    for n in names:
        assert float(P[n].abs().sum()) > 0, n
        assert bool(torch.isfinite(E[n]).all()), n
        assert float((E[n] - P[n]).norm()) <= 1e-4 * float(P[n].norm()), n
    return ge


@pytest.mark.parametrize("full", [False, True], ids=["colour", "full"])
def test_long_tape_adjoint_matches_plain(emu, full):
    """K6 at max_depth 60: 68 loop trips, above the local tape of 64."""
    world, cam = ptt.scenes.cornell_box()
    eng = tint.MegaEngine(*_compiled(world, cam, 60), trng.key(1))
    assert eng.cfg.iters == 68 > adjoint.TAPE_MAX
    assert adjoint.per_pixel_buffers(eng.sd, eng.cfg.iters,
                                     eng.cfg.sss_max_steps, full)
    whole = _check_adjoint(eng, full, ("tex_c1",))
    # per pixel: stack, 68 tape entries (and no walk on cornell_box)
    blocks = _check_adjoint(eng, full, ("tex_c1",), budget=4000 * 7)
    for x, y in zip(whole, blocks):
        assert torch.equal(x, y)


def test_long_walk_adjoint_matches_plain(emu):
    """The full K6 with 80 SSS walk steps (above the local record of 64) on
    tests/test_torch_grad.py's SSS-volumetric sphere."""
    world, cam = _WAX(ptt)
    eng = tint.MegaEngine(*_compiled(world, cam, 4, sss_max_steps=80),
                          trng.key(7))
    assert eng.cfg.sss_max_steps == 80 > adjoint.WALK_MAX
    assert eng.cfg.iters <= adjoint.TAPE_MAX
    assert adjoint.per_pixel_buffers(eng.sd, eng.cfg.iters, 80, True)
    _check_adjoint(eng, True, ("mat_g", "mat_sigma_s", "mat_sigma_a",
                               "tex_c1"))


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("branching", [4, 8])
def test_deep_stack_kernels_equal_local_on_card(cuda_device, branching):
    """K5 and K7 with a 70-entry stack in the per-lane buffer: bit-equal to
    the local stack's launch on a vol2_final frame."""
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.img_width, cam.aspect_ratio = 160, 160 / 90
    sc = ptt.compile_scene(world, device=cuda_device)
    args = (sc, TFlags.from_scene(sc), ptt.build_from_scene(sc, branching),
            cam.initialize(device=cuda_device),
            TCfg(width=160, height=90, samples_per_pixel=2, max_depth=10))
    key = trng.key(0, cuda_device)
    zero = torch.zeros((90, 160, 3), device=cuda_device)
    outs = []
    for a in (args, _deep(args)):
        kernels.reset_launches()
        img, st = tint.render_batch(*a, zero, 0, 2, key, with_stats=True)
        tiled = it.render_tiled(*a, key, spp=1)
        outs.append((img, tiled, {k: int(v) for k, v in st.items()
                                  if k not in ("depth_hist", "ctr")}, dict(
            kernels.INSTANCES)))
    (i0, t0, s0, n0), (i1, t1, s1, n1) = outs
    assert torch.equal(i0, i1) and torch.equal(t0, t1) and s0 == s1
    assert n0[f"megakernel_k{branching}"] == 2
    assert n1[f"megakernel_k{branching}_global"] == 2
    assert n1[f"closest_hit_k{branching}_global"] > 0


@pytest.mark.gpu
def test_long_tape_train_step_on_card(cuda_device):
    """A Cornell train step at max_depth 60 (68 trips) completes on the
    card; K6 (tape in the per-pixel buffer) within rel L2 1e-3 of the plain
    path."""
    world, cam = ptt.scenes.cornell_box()
    cam.img_width, cam.aspect_ratio = 64, 1.0
    sc = ptt.compile_scene(world, device=cuda_device)
    fl = TFlags.from_scene(sc)
    bvh = ptt.build_from_scene(sc)
    ca = cam.initialize(device=cuda_device)
    cfg = TCfg(width=64, height=64, samples_per_pixel=2, max_depth=60)
    key = trng.key(0, cuda_device)
    delta = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64 * 64, 3)).astype(np.float32)).to(cuda_device)
    kernels.reset_launches()
    g = adjoint.kernel_vjp(sc, fl, bvh, ca, cfg, key, (0, 1), ["tex_c1"],
                           delta)[0]
    assert kernels.INSTANCES["adjoint_k4_global"] == 2
    p = adjoint.plain_vjp(sc, fl, bvh, ca, cfg, key, (0, 1), ["tex_c1"],
                          delta)[0]
    assert float((g - p).norm()) <= 1e-3 * float(p.norm())
    step = ptt.make_train_step(fl, cfg, spp=2, lr=1e-3,
                               n_waves=ptt.calibrate_n_waves(
                                   sc, fl, bvh, ca, cfg, key, spp=2),
                               unbiased=True)
    params = {"tex_c1": sc.tex_c1.clone()}
    target = torch.zeros((64, 64, 3), device=cuda_device)
    _, loss, grads, aux = step(params, sc, bvh, ca, key, target)
    assert aux["paths_done"] == aux["paths_total"]
    assert bool(torch.isfinite(grads["tex_c1"]).all())
    assert np.isfinite(float(loss))
