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
    if name.startswith("cornell"):
        assert int(tst["rays"]) == int(jst["rays"])
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_allclose(timg, jimg, rtol=1e-5, atol=1e-5)
    else:
        assert abs(int(tst["rays"]) - int(jst["rays"])) <= 0.003 * int(jst["rays"])
        assert np.abs(th - jh).sum() <= 0.015 * jh.sum()
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
    assert (r.stats.pixel_paths == 2).all()
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
    """Both engines and SSS scenes construct; what is still queued in
    ROADMAP.md raises (the card's adjoint for leaves other than the texture
    colours, B13', and the data-parallel train step, A.11), and an unknown
    engine is refused."""
    from path_tracer_tpu_torch.ops import adjoint
    from path_tracer_tpu_torch.parallel import make_train_step
    world, cam = ptt.scenes.cornell_box()
    assert ptt.Renderer(world, cam, device="cpu").engine == "megakernel"
    assert ptt.RendererFactory.create("cpu", world, cam,
                                      device="cpu").engine == "megakernel"
    with pytest.raises(ValueError):
        ptt.Renderer(world, cam, engine="bogus", device="cpu")
    world, cam = ptt.scenes.subsurface_scattering()
    r = ptt.Renderer(world, cam, engine="wavefront", device="cpu")
    assert r.flags.has_sss
    with pytest.raises(NotImplementedError, match="B13'"):
        adjoint.check_leaves(["tex_c1", "mat_g"], on_card=True)
    with pytest.raises(NotImplementedError, match="A.11"):
        make_train_step(r.flags, r.cfg, [0, 1])


def test_kernel_wrappers_take_twins_only_for_cpu_tensors():
    """A CPU state runs the twins and launches no kernel."""
    from path_tracer_tpu_torch.ops import kernels
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 8
    kernels.reset_launches()
    for engine in ("wavefront", "megakernel"):
        ptt.Renderer(world, cam, engine=engine, device="cpu").render(spp=1)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
