"""The port's data-parallel modes on gloo ranks against JAX's and the twin.

* ``render_sharded`` (K5's twin per pixel block) and
  ``render_sharded_wavefront`` (a slot pool per block) on 2 ranks equal the
  one-process render (the RNG folds frame pixels; per-pixel add order
  aside).
* The 2-rank ``make_train_step``, wavefront engine (``unbiased=False``) and
  tiled engine (``engine="megakernel"``, ``unbiased=True``), against JAX's
  on a 2-device virtual mesh: loss and gradients within rel 1e-5, the
  wavefront's ``paths_done == paths_total``.
* ``calibrate_n_waves`` on 2 ranks sizes each rank's pixel block (with the
  step's queue), not the frame, and takes the largest over the ranks.

The frame is 15x7: 105 pixels deal into blocks of 53, so the last block
carries a padded pixel that is traced and dropped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
from path_tracer_tpu.parallel import render_dist as jrd
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import integrator, wavefront
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg

import torch_ranks as tr

CFG = dict(width=15, height=7, samples_per_pixel=2, max_depth=4)
WAVE = dict(queue_size=64, steps_per_wave=8)
TRAIN = {"wavefront": dict(engine="wavefront", unbiased=False, lr=0.5,
                           n_waves=96, **WAVE),
         "tiled": dict(engine="megakernel", unbiased=True, lr=0.5)}


@pytest.fixture(scope="module")
def setup():
    """tests/test_sharding.py:_setup at 15x7, in both packages."""
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, 0, -1), 0.5, pt.Lambertian((0.7, 0.3, 0.3))))
    w.add(pt.Sphere.stationary((0, -100.5, -1), 100,
                               pt.Lambertian((0.8, 0.8, 0.0))))
    w.add(pt.Quad((-2, 1.5, -2), (1, 0, 0), (0, 0, 1),
                  pt.DiffuseLight((4, 4, 4))))
    cam = pt.Camera()
    cam.aspect_ratio = 2.0
    cam.img_width = CFG["width"]
    scene = pt.compile_scene(w)
    bvh = pt.build_from_scene(scene)
    cam_a = cam.initialize()
    target = np.random.default_rng(3).uniform(
        0.0, 0.5, (CFG["height"], CFG["width"], 3)).astype(np.float32)
    key = jax.random.key(4)
    b = tr.fields(bvh, ["nodes", "prims", "root"])
    b.update(prim_mask=np.array(bvh.prim_mask), max_stack=bvh.max_stack,
             branching=bvh.branching)
    base = dict(scene=tr.fields(scene), bvh=b, cam=tr.fields(cam_a),
                key=np.asarray(jax.random.key_data(key)), cfg=CFG, spp=2)
    params = {"tex_c1": np.asarray(scene.tex_c1)}
    jobs = [dict(base, name="sharded"),
            dict(base, name="sharded_wavefront", kw=WAVE)]
    jobs += [dict(base, name="train", spp=1, params=params, target=target,
                  kw=TRAIN[e]) for e in ("wavefront", "tiled")]
    jobs.append(dict(base, name="calibrate", kw=WAVE))
    res = tr.run_ranks(2, jobs)
    ts = interop.from_numpy_scene(scene, "cpu")
    port = (ts, TFlags.from_scene(ts), interop.from_numpy_bvh(bvh, "cpu"),
            interop.from_numpy_camera(cam_a, "cpu"), TCfg(**CFG),
            interop.key_from_data(base["key"], "cpu"))
    return dict(j=(scene, JFlags.from_scene(scene), bvh, cam_a, key),
                t=port, target=target, params=params, res=res)


def test_sharded_renders_equal_the_one_process_render(setup):
    ts, tf, tb, tc, tcfg, tk = setup["t"]
    res = setup["res"]
    mega = integrator.render(ts, tf, tb, tc, tcfg, tk, spp=2).numpy()
    zero = torch.zeros((CFG["height"], CFG["width"], 3))
    wave, st = wavefront.render_batch(ts, tf, tb, tc, tcfg, zero, 0, 2, tk,
                                      with_stats=True, **WAVE)
    wave = (wave / 2).numpy()
    for r in range(2):
        assert res[r][0]["image"].shape == mega.shape
        np.testing.assert_allclose(res[r][0]["image"], mega, atol=1e-6)
        np.testing.assert_allclose(res[r][1]["image"], wave, atol=1e-6)
        # summed over the ranks: the one-process counts plus the padded
        # pixel's two paths
        rs = res[r][1]["stats"]
        assert int(rs["paths"]) == int(st["paths"]) + 2
        assert int(rs["stack_overflows"]) == 0
        assert int(rs["rays"]) >= int(st["rays"]) + 2
    assert float(mega.mean()) > 0


@pytest.mark.parametrize("engine", ["wavefront", "tiled"])
def test_two_rank_train_step_matches_jax(setup, engine):
    scene, flags, bvh, cam, key = setup["j"]
    kw = TRAIN[engine]
    jstep = jrd.make_train_step(flags, JCfg(**CFG), jrd.make_mesh(2), spp=1,
                                **kw)
    jp, jl, jg, jaux = jstep({"tex_c1": scene.tex_c1}, scene, bvh, cam, key,
                             jnp.asarray(setup["target"]))
    job = 2 if engine == "wavefront" else 3
    for r in range(2):
        out = setup["res"][r][job]
        np.testing.assert_allclose(out["loss"], float(jl), rtol=1e-5)
        g, ref = out["grads"]["tex_c1"], np.asarray(jg["tex_c1"])
        assert np.abs(ref).max() > 0
        assert np.linalg.norm(g - ref) <= 1e-5 * np.linalg.norm(ref)
        np.testing.assert_allclose(out["params"]["tex_c1"],
                                   np.asarray(jp["tex_c1"]), rtol=1e-5,
                                   atol=1e-7)
        aux = out["aux"]
        assert aux["paths_done"] == aux["paths_total"]
        assert aux["paths_done"] == int(jaux["paths_done"])
        if engine == "wavefront":
            # two blocks of 53 pixels, one sample each (the padded one too)
            assert aux["paths_total"] == 2 * 53


def test_calibrate_sizes_the_shard(setup):
    ts, tf, tb, tc, tcfg, tk = setup["t"]
    per = -(-CFG["width"] * CFG["height"] // 2)
    want = 0
    for r in range(2):
        _, st = wavefront.render_batch(ts, tf, tb, tc, tcfg,
                                       torch.zeros((per, 3)), 0, 2, tk,
                                       with_stats=True, pix_offset=r * per,
                                       n_pix=per, **WAVE)
        want = max(want, int(int(st["waves"]) * 1.5) + 8)
    from path_tracer_tpu_torch.parallel import calibrate_n_waves
    whole = calibrate_n_waves(ts, tf, tb, tc, tcfg, tk, spp=2, **WAVE)
    got = [setup["res"][r][4]["n_waves"] for r in range(2)]
    assert got == [want, want]
    assert want < whole


def test_emulated_megakernel_renders_a_pixel_block(setup):
    """K5's per-pixel code built for the CPU (``csrc/host_emulation.cpp``)
    over a block of frame pixels equals that slice of its whole frame: the
    camera and the RNG take the frame pixel, the outputs the block index."""
    import shutil
    from path_tracer_tpu_torch.ops import kernels
    from path_tracer_tpu_torch.ops.types import C_DONE
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    _, emu = kernels.host_emulation_ops()
    ts, tf, tb, tc, tcfg, tk = setup["t"]

    def frame(off, n):
        eng = integrator.MegaEngine(ts, tf, tb, tc, tcfg, tk, off, n)
        ms = eng.init_state(torch.zeros((eng.npix, 3)))
        for s in range(2):
            emu(eng, ms, s)
        return ms

    full, block = frame(0, None), frame(40, 30)
    assert torch.equal(block.accum, full.accum[40:70])
    assert int(block.ctr[C_DONE]) == 2 * 30
    assert float(block.accum.abs().sum()) > 0


def test_launcher_kills_every_rank_when_one_fails(tmp_path):
    """``parallel.launch.run_ranks`` polls the ranks together: when rank 1
    fails while rank 0 would run for a minute, it kills rank 0 at once and
    reports rank 1's log, not a timeout."""
    import sys
    import time
    from path_tracer_tpu_torch.parallel.launch import run_ranks

    def command(rank, port):
        code = ("import time; time.sleep(60)" if rank == 0 else
                f"print('rank 1 on port {port} gives up'); raise SystemExit(3)")
        return [sys.executable, "-c", code]

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 exited 3") as err:
        run_ranks(2, command, str(tmp_path), timeout=120)
    assert time.perf_counter() - t0 < 30
    assert "gives up" in str(err.value)
    ok = run_ranks(2, lambda r, port: [sys.executable, "-c", "pass"],
                   str(tmp_path), timeout=60)
    assert ok < 30
