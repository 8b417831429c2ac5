"""The port's wavefront engine against the JAX ``render_batch``, end to end.

Same scene, camera, key and sample set on both sides (32x18, 2 spp, a
256-slot pool so the pool regenerates, per-path spawning and 2-sample
windows).  The work-item set is fixed by the RNG folds, so ``paths``,
``spawned`` and the per-pixel path counts always match exactly.  On the
Cornell scenes every path takes the same bounces, so ``rays``, the depth
histogram and the image match too.  On vol2_final_scene the ray counters
may differ by a few paths: XLA's CPU backend fuses multiply-adds, the twin
rounds every operation, and on the radius-5000 fog boundary and the 1000
small spheres a continuation ray's self-hit root lands within rounding of
``t_min`` — a handful of paths take another branch (ROADMAP.md C).  There
the image is held to the graded rule of ``tools/bench_ab.py`` (at most 1%
of pixels off by > 1e-3 per sample, clean-pixel mean < 1e-5) and the
counters to just above the measured gaps: ``rays`` within 0.3% (measured
9 of 3893, 0.23%) and the depth histogram's L1 distance within 1.5% of the
paths (measured 12 of 1152, 1.04%); 4 of 576 pixels (0.69%) are outliers,
at stride 1 and 2 alike.

The wave schedule (``waves``, ``ctrls``, ``occ_sum``, ``trav_steps``,
``exec_steps``: K1's twin runs JAX's adaptive wave exit at JAX's CPU chunk
of 1) equals JAX's exactly on the Cornell scenes.  On vol2_final_scene the
9 segments that take another branch also move the schedule, each counter
by what those segments cost, and each is held to its own measured gap
with modest room (``SCHED_GAP``; measured at stride 1 / stride 2: waves
107 vs 106 / equal, exec_steps 216 vs 215 / equal, ctrls equal, trav_steps
21440 vs 21507 both, 0.31%, occ_sum 6830 vs 6939, 1.57% / 7582 vs 7681,
1.29%).  The gap is the FMA path divergence of ROADMAP.md C, not the exit
rule: the Cornell cases, held exactly, catch a wrong exit threshold (a
threshold of 3 or 5 in place of 4 moves their waves, ctrls, occ_sum and
exec_steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import wavefront as jwf
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg

W, H, SPP = 32, 18, 2
# Largest |port - JAX| allowed per schedule counter on vol2_final_scene,
# from the measured gaps above: whole waves and steps (chunk 1), a
# fraction of JAX's value for the sums over slots and lanes.
SCHED_GAP = {"waves": 1, "ctrls": 0, "exec_steps": 2, "trav_steps": 0.004,
             "occ_sum": 0.02}
CASES = [("cornell_box", None), ("cornell_box", 2), ("cornell_smoke", None),
         ("cornell_smoke", 2), ("vol2_final_scene", None),
         ("vol2_final_scene", 2)]


def _render_both(name, stride):
    kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
    world, cam = getattr(pt.scenes, name)(**kw)
    cam.img_width, cam.aspect_ratio = W, W / H
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    cam_a = cam.initialize()
    key = jax.random.key(0)
    jimg, jst = jwf.render_batch(
        scene, JFlags.from_scene(scene), bvh, cam_a,
        JCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=10),
        jnp.zeros((H, W, 3)), 0, SPP, key, queue_size=256, steps_per_wave=8,
        with_stats=True, sample_stride=stride)
    ts = interop.from_numpy_scene(scene, "cpu")
    timg, tst = twf.render_batch(
        ts, TFlags.from_scene(ts), interop.from_numpy_bvh(bvh, "cpu"),
        interop.from_numpy_camera(cam_a, "cpu"),
        TCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=10),
        torch.zeros((H, W, 3)), 0, SPP,
        interop.key_from_data(np.asarray(jax.random.key_data(key)), "cpu"),
        queue_size=256, steps_per_wave=8, with_stats=True,
        sample_stride=stride)
    return np.asarray(jimg), jst, timg.numpy(), tst


@pytest.mark.parametrize("name,stride", CASES,
                         ids=[f"{n}-stride{s or 1}" for n, s in CASES])
def test_render_batch_matches_jax(name, stride):
    jimg, jst, timg, tst = _render_both(name, stride)
    assert int(tst["paths"]) == int(jst["paths"]) == W * H * SPP
    assert int(tst["spawned"]) == int(jst["spawned"])
    assert int(tst["stack_overflows"]) == 0
    assert (tst["pixel_paths"].numpy() == SPP).all()
    assert np.isfinite(timg).all()
    jh, th = np.asarray(jst["depth_hist"]), tst["depth_hist"].numpy()
    sched = ("waves", "ctrls", "occ_sum", "trav_steps", "exec_steps")
    if name.startswith("cornell"):
        for k in sched:
            assert int(tst[k]) == int(jst[k]), k
        assert int(tst["rays"]) == int(jst["rays"])
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_allclose(timg, jimg, rtol=1e-5, atol=1e-5)
    else:
        assert abs(int(tst["rays"]) - int(jst["rays"])) <= 0.003 * int(jst["rays"])
        assert np.abs(th - jh).sum() <= 0.015 * jh.sum()
        for k, gap in SCHED_GAP.items():
            limit = gap * int(jst[k]) if isinstance(gap, float) else gap
            assert abs(int(tst[k]) - int(jst[k])) <= limit, k
        per_pix = np.abs(timg - jimg).max(-1) / SPP
        assert (per_pix > 1e-3).mean() <= 0.01
        clean = per_pix[per_pix <= 1e-3]
        assert clean.mean() < 1e-5


def test_default_stride_rule():
    """min(n, 4) on frames of ≥ 8 pool generations of pixels, else 1."""
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 16
    ts = ptt.compile_scene(world, device="cpu")
    args = (ts, TFlags.from_scene(ts), ptt.build_from_scene(ts),
            cam.initialize(device="cpu"), TCfg(width=16, height=16), 0, 6,
            ptt.utils.rng.key(0))
    assert twf.WaveEngine(*args, queue_size=32, steps_per_wave=8,
                          ctrl_den=8).stride == 4
    assert twf.WaveEngine(*args, queue_size=256, steps_per_wave=8,
                          ctrl_den=8).stride == 1
    assert twf.WaveEngine(*args, queue_size=32, steps_per_wave=8, ctrl_den=8,
                          sample_stride=3).stride == 3


def test_renderer_facade_and_png(tmp_path):
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 24
    r = ptt.Renderer(world, cam, engine="wavefront", device="cpu")
    img = r.render(spp=2, batch=1)
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert r.stats.paths == 24 * 24 * 2 and r.stats.rays > r.stats.paths
    # The per-pixel path count is the engine's, read where it is wanted.
    _, st = twf.render_batch(r.scene, r.flags, r.bvh, r.cam_arrays, r.cfg,
                             torch.zeros_like(r.accum), 0, 2, r.key,
                             queue_size=8192, steps_per_wave=12,
                             with_stats=True)
    assert (st["pixel_paths"] == 2).all()
    # Cornell box: the left wall is green, the right wall red.
    assert img[:, :4, 1].mean() > img[:, :4, 0].mean()
    assert img[:, -4:, 0].mean() > img[:, -4:, 1].mean()
    png = tmp_path / "cb.png"
    r.write_image(str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    ppm = tmp_path / "cb.ppm"
    r.write_image(str(ppm))
    assert ppm.read_text().startswith("P3\n24 24\n255\n")
    f = ptt.RendererFactory.create("gpu", world, cam, device="cpu")
    assert f.engine == "wavefront"


def test_unported_paths_raise():
    """Both engines and SSS scenes construct; an unknown engine, a
    backward leaf that is not a floating scene field, a train step given a
    device list in place of a mesh of ranks, and a mesh of several ranks
    without a torch.distributed job are refused."""
    from path_tracer_tpu_torch.ops import adjoint
    from path_tracer_tpu_torch.parallel import make_mesh, make_train_step
    world, cam = ptt.scenes.cornell_box()
    assert ptt.Renderer(world, cam, device="cpu").engine == "megakernel"
    assert ptt.RendererFactory.create("cpu", world, cam,
                                      device="cpu").engine == "megakernel"
    with pytest.raises(ValueError):
        ptt.Renderer(world, cam, engine="bogus", device="cpu")
    world, cam = ptt.scenes.subsurface_scattering()
    r = ptt.Renderer(world, cam, engine="wavefront", device="cpu")
    assert r.flags.has_sss
    with pytest.raises(ValueError, match="floating SceneArrays leaf"):
        adjoint.kernel_vjp(r.scene, r.flags, r.bvh, r.cam_arrays, r.cfg,
                           r.key, (0,), ["tex_c1", "mat_type"], None)
    with pytest.raises(TypeError, match="Mesh"):
        make_train_step(r.flags, r.cfg, [0, 1])
    with pytest.raises(ValueError, match="torch.distributed job"):
        make_mesh(2)


def test_kernel_wrappers_take_twins_only_for_cpu_tensors():
    """A CPU state runs the twins and launches no kernel (the tiled
    engine's too)."""
    from path_tracer_tpu_torch.ops import kernels
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 8
    kernels.reset_launches()
    for engine in ("wavefront", "megakernel"):
        r = ptt.Renderer(world, cam, engine=engine, device="cpu")
        r.render(spp=1)
    ptt.render_tiled(r.scene, r.flags, r.bvh, r.cam_arrays, r.cfg, r.key,
                     spp=1)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
