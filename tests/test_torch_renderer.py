"""The port's Renderer facade, orbit camera and spawn order against JAX's.

Mirrors ``tests/test_renderer.py:32-152, 227`` with the port on the CPU
(the plain-torch twins) beside ``path_tracer_tpu`` on the CPU: progressive
accumulation, checkpoint and resume (JAX's npz fields, dtypes and shapes;
the key bit for bit; accum within 1e-6, the engines' agreement on this
scene, and 1e-5 of the value where XLA contracts a multiply-add), refusal
of another scene, camera, configuration or resolution,
the metrics file, the save on ``KeyboardInterrupt``, autotune (its
prediction equal to JAX's from the same probe, its image within 1e-5 of
the preset's, pinned values kept), and the orbit camera (``lookfrom``
within 1e-12 of JAX's).  Then the wavefront's spawn order:
``tile_spawn_order`` equal to JAX's, ``render_batch(spawn_order=)``
against JAX's on a Cornell scene (image within 1e-5, counters exact), and
K2 built by g++ with and without an order against its twin (exact).
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import wavefront as jwf
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
from path_tracer_tpu.render.orbit import OrbitCamera as JOrbit
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import kernels, shade_tiled
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.render import renderer as trend
from path_tracer_tpu_torch.render.orbit import OrbitCamera, restart
from path_tracer_tpu_torch.utils import spans

from test_torch_control import (_assert_same_state, _control_waves, _engine,
                                _needs_cxx)


def _tiny_cam(pkg, w=32, h_ratio=2.0, spp=4, depth=6):
    cam = pkg.Camera()
    cam.aspect_ratio = h_ratio
    cam.img_width = w
    cam.samples_per_pixel = spp
    cam.max_depth = depth
    return cam


def _world(pkg):
    w = pkg.HittableList()
    w.add(pkg.Sphere.stationary((0, 0, -1), 0.5,
                                pkg.Lambertian((0.7, 0.3, 0.3))))
    w.add(pkg.Sphere.stationary((0, -100.5, -1), 100,
                                pkg.Lambertian((0.8, 0.8, 0.0))))
    return w


def _port(engine="megakernel", seed=2, **kw):
    return ptt.Renderer(_world(ptt), _tiny_cam(ptt, **kw), engine=engine,
                        seed=seed, device="cpu")


def test_progressive_equals_oneshot():
    """4 spp in two batches == 4 spp in one batch (same base key)."""
    img_a = _port(seed=1).render(spp=4, batch=4)
    b = _port(seed=1)
    b.render(spp=2, batch=2)
    img_b = b.render(spp=4, batch=2)
    np.testing.assert_allclose(img_a, img_b, atol=1e-6)


def test_checkpoint_resume(tmp_path):
    """2 spp checkpointed, then a fresh Renderer resumes to 4: the image of
    an uninterrupted render with the same batches, bit for bit."""
    ckpt = str(tmp_path / "accum.npz")
    a = _port()
    a.render(spp=2, batch=2, checkpoint_path=ckpt, checkpoint_every=1)
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp.npz")
    b = _port()
    img_b = b.render(spp=4, batch=2, checkpoint_path=ckpt)
    assert b.samples_done == 4
    img_c = _port().render(spp=4, batch=2)
    np.testing.assert_array_equal(img_b, img_c)
    with np.load(ckpt) as z:
        assert int(z["samples_done"]) == 4


def test_checkpoint_refuses_another_render(tmp_path):
    """Another scene, camera or configuration fails on the fingerprint;
    another resolution names both shapes."""
    ckpt = str(tmp_path / "accum.npz")
    _port().render(spp=2, batch=2, checkpoint_path=ckpt)
    other = ptt.HittableList()
    other.add(ptt.Sphere.stationary((0, 0, -1), 0.5, ptt.Metal((1, 1, 1), 0.0)))
    with pytest.raises(ValueError, match="fingerprint"):
        ptt.Renderer(other, _tiny_cam(ptt), seed=2,
                     device="cpu").load_checkpoint(ckpt)
    cam2 = _tiny_cam(ptt)
    cam2.vfov = 55
    with pytest.raises(ValueError, match="fingerprint"):
        ptt.Renderer(_world(ptt), cam2, seed=2,
                     device="cpu").load_checkpoint(ckpt)
    with pytest.raises(ValueError, match="fingerprint"):
        _port(depth=7).load_checkpoint(ckpt)
    with pytest.raises(ValueError, match=re.escape("(16, 32, 3)") + ".*"
                       + re.escape("(8, 16, 3)")):
        _port(w=16).load_checkpoint(ckpt)



def test_checkpoint_refuses_another_spp_as_jax(tmp_path):
    """The fingerprint holds the camera's sample count, as JAX's does: a
    checkpoint of a 4-spp camera is refused by an 8-spp camera in both
    packages, and render(spp=8) of the 4-spp renderer resumes it."""
    for pkg, kw in ((ptt, {"device": "cpu"}), (pt, {})):
        ckpt = str(tmp_path / f"{pkg.__name__}.npz")
        pkg.Renderer(_world(pkg), _tiny_cam(pkg, w=16, spp=4), seed=2,
                     **kw).render(spp=2, batch=2, checkpoint_path=ckpt)
        with pytest.raises(ValueError, match="fingerprint"):
            pkg.Renderer(_world(pkg), _tiny_cam(pkg, w=16, spp=8), seed=2,
                         **kw).load_checkpoint(ckpt)
        r = pkg.Renderer(_world(pkg), _tiny_cam(pkg, w=16, spp=4), seed=2,
                         **kw)
        r.render(spp=8, batch=2, checkpoint_path=ckpt)
        assert r.samples_done == 8, pkg.__name__
        with np.load(ckpt) as z:
            assert int(z["samples_done"]) == 8


def test_render_distributed_refuses_another_spp_as_jax(tmp_path):
    """The same for render_distributed: one gloo rank of the port, JAX's
    function in this process."""
    from torch_ranks import run_ranks
    from path_tracer_tpu.parallel.render_dist import (
        render_distributed as jax_render_distributed)

    job = {"name": "spp", "scene": "wavefront_comparison", "width": 16,
           "spp": 2, "split": 1, "seed": 3, "ckpt": str(tmp_path / "t.npz")}
    out = run_ranks(1, [job])[0][0]
    assert "fingerprint" in out["refused"]
    assert np.isfinite(out["resumed"]).all()
    with np.load(job["ckpt"]) as z:
        assert int(z["samples_done"]) == 4

    ckpt = str(tmp_path / "j.npz")

    def run(cam_spp, spp):
        world, cam = pt.scenes.SCENES[job["scene"]]()
        cam.img_width, cam.samples_per_pixel = job["width"], cam_spp
        return jax_render_distributed(world, cam, spp=spp, seed=3, batch=1,
                                      checkpoint_path=ckpt,
                                      checkpoint_every=1)

    run(2, 1)
    with pytest.raises(ValueError, match="fingerprint"):
        run(4, 4)
    assert np.isfinite(run(2, 4)).all()
    with np.load(ckpt) as z:
        assert int(z["samples_done"]) == 4

def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    _port(w=16).render(spp=2, batch=1, metrics_path=path)
    lines = [json.loads(x) for x in open(path)]
    assert len(lines) == 2
    assert set(lines[-1]) == {"ts", "samples_done", "batch", "batch_s",
                              "mpix_per_s"}
    assert lines[-1]["samples_done"] == 2 and lines[-1]["batch"] == 1
    assert lines[-1]["mpix_per_s"] > 0


def test_engines_agree_via_facade():
    m, w = _port("megakernel", seed=3), _port("wavefront", seed=3)
    np.testing.assert_allclose(m.render(spp=4), w.render(spp=4), atol=1e-5)
    assert m.stats.rays == w.stats.rays > 0
    assert m.stats.paths == w.stats.paths > 0
    assert m.stats.depth_sum == w.stats.depth_sum
    np.testing.assert_array_equal(m.stats.depth_hist, w.stats.depth_hist)


def test_keyboard_interrupt_saves_the_first_batch(tmp_path, monkeypatch):
    """An interrupt in the second batch leaves a checkpoint of the first
    (accum and samples_done committed together) and is re-raised."""
    ckpt = str(tmp_path / "accum.npz")
    calls = []
    real = trend._render_batch

    def second_raises(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a, **kw)

    monkeypatch.setattr(trend, "_render_batch", second_raises)
    r = _port()
    with pytest.raises(KeyboardInterrupt):
        r.render(spp=4, batch=2, checkpoint_path=ckpt)
    monkeypatch.undo()
    ref = _port()
    ref.render(spp=2, batch=2)
    with np.load(ckpt) as z:
        assert int(z["samples_done"]) == 2
        np.testing.assert_array_equal(z["accum"], ref.accum.numpy())


def test_checkpoint_file_matches_jax(tmp_path):
    """The same 2-spp render checkpointed by both packages: the same npz
    fields, dtypes and shapes, the key bit for bit, accum within 1e-6 plus
    1e-5 of its value.  Measured: every value within 1e-6 but two, one
    pixel's red and green, 4.4e-6 (4.7e-6 of 0.93) off, in both engines, with
    every counter equal: XLA's CPU backend contracts multiply-adds that the
    twins round apart (ROADMAP.md C)."""
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    pt.Renderer(_world(pt), _tiny_cam(pt), seed=2).render(
        spp=2, batch=2, checkpoint_path=jpath)
    _port().render(spp=2, batch=2, checkpoint_path=tpath)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        for f in j.files:
            assert (j[f].dtype, j[f].shape) == (t[f].dtype, t[f].shape), f
        np.testing.assert_array_equal(t["key"], j["key"])
        assert int(t["samples_done"]) == int(j["samples_done"]) == 2
        np.testing.assert_allclose(t["accum"], j["accum"], rtol=1e-5,
                                   atol=1e-6)


def test_autotune_picks_candidate_and_preserves_image():
    """autotune returns a candidate, and the tuned render integrates the
    preset's sample set (a pool size only reorders float adds)."""
    img_base = _port("wavefront", seed=5).render(spp=4, batch=4)
    tuned = _port("wavefront", seed=5)
    q, s, d, stride = tuned.autotune()
    assert q > 0 and s > 0 and d > 0
    assert stride is None or stride >= 1
    assert tuned._tuned == (q, s, d, stride)
    assert tuned.tuning["chosen"] in tuned.tuning["ms_per_sample"]
    assert set(tuned.tuning["ms_per_sample"]) == {
        tuned.tuning["predicted"], tuned.tuning["preset"]}
    np.testing.assert_allclose(tuned.render(spp=4, batch=4), img_base,
                               atol=1e-5)


def test_autotune_honours_pinned_values():
    cam = _tiny_cam(ptt)
    cfg = TCfg(width=cam.img_width, height=cam.img_height,
               samples_per_pixel=4, max_depth=cam.max_depth, queue_size=512,
               ctrl_den=4)
    r = ptt.Renderer(_world(ptt), cam, engine="wavefront", cfg=cfg, seed=5,
                     device="cpu")
    q, s, d, _stride = r.autotune()
    assert q == 512 and d == 4 and s > 0
    assert all(c[0] == 512 and c[2] == 4 for c in r.tuning["ms_per_sample"])


def test_autotune_prediction_matches_jax(capsys):
    """The prediction from the port's probe equals the one JAX's autotune
    prints for the same world and seed."""
    pt.Renderer(_world(pt), _tiny_cam(pt), engine="wavefront",
                seed=5).autotune(verbose=True)
    out = capsys.readouterr().out
    want = re.search(r"waves=(\d+) ctrls=(\d+) -> (predict q=\S+ s=\S+ "
                     r"den=\S+ stride=\S+)", out)
    r = _port("wavefront", seed=5)
    r.autotune()
    pq, ps, pd, pst = r.tuning["predicted"]
    assert (r.tuning["reading"]["waves"], r.tuning["reading"]["ctrls"]) == (
        int(want.group(1)), int(want.group(2)))
    assert f"predict q={pq} s={ps} den={pd} stride={pst}" == want.group(3)


@pytest.mark.parametrize("probe", [
    dict(waves=40, ctrls=36, rays=9000, slots=512, occ_sum=12000),
    dict(waves=40, ctrls=20, rays=9000, slots=128, occ_sum=4800),
    dict(waves=90, ctrls=30, rays=3000, slots=256, occ_sum=21000),
    dict(waves=50, ctrls=45, rays=400, slots=64, occ_sum=2000)])
def test_prediction_rule_is_jax_rule(probe, monkeypatch, capsys):
    """predict_tuning on given probe counters equals the prediction JAX's
    autotune prints when its probe returns those counters (JAX's
    ``render_batch`` replaced by a stub), at 32x16 and 64x64."""
    def stub(*a, with_stats=False, **kw):
        img = jnp.zeros((1,))
        return (img, dict(probe)) if with_stats else img

    monkeypatch.setattr(jwf, "render_batch", stub)
    for w, ratio in ((32, 2.0), (64, 1.0)):
        jr = pt.Renderer(_world(pt), _tiny_cam(pt, w=w, h_ratio=ratio),
                         engine="wavefront")
        jr.autotune(verbose=True)
        want = re.search(r"(predict q=\S+ s=\S+ den=\S+ stride=\S+)",
                         capsys.readouterr().out).group(1)
        cfg = TCfg(width=jr.cfg.width, height=jr.cfg.height)
        preset = trend.tuning_preset(cfg, jr.bvh.nodes.shape[0], None)
        (q, s, d, st), _ = trend.predict_tuning(cfg, preset, probe)
        assert f"predict q={q} s={s} den={d} stride={st}" == want


# The wavefront's pool where nothing pins it (wave_preset): (frame, BVH
# rows, the batch's samples, K1's resident lanes or None off a card) ->
# (queue, steps, ctrl_den).
RESIDENT = 396 * 128             # 3 blocks an SM on 132 SMs
POOL_CASES = {
    "card_small_bvh": ((400, 300), 8, 8, RESIDENT, (RESIDENT, 12, 8)),
    "card_big_bvh": ((800, 600), 3000, 8, RESIDENT, (RESIDENT, 32, 16)),
    "card_other_count": ((400, 300), 8, 8, 1000, (1000, 12, 8)),
    "card_capped_by_items": ((100, 100), 8, 1, RESIDENT, (10000, 12, 8)),
    "card_capped_by_pool_cap": ((100, 100), 300, 8, RESIDENT,
                                (16384, 32, 16)),
    "cpu_small_bvh": ((400, 300), 255, 8, None, (8192, 12, 8)),
    "cpu_big_bvh": ((400, 300), 256, 8, None, (32768, 32, 16)),
    "cpu_tiny_frame": ((16, 8), 8, 2, None, (8192, 12, 8)),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_wave_preset_pool_steps_and_ctrl_den(case):
    """The card's resident lanes give the pool, capped by the batch's items
    and _pool_cap; without a card, JAX's 8192 or 32768 by BVH rows; steps
    and ctrl_den follow the rows alone."""
    (w, h), rows, n, resident, want = POOL_CASES[case]
    cfg = TCfg(width=w, height=h)
    assert trend.wave_preset(cfg, rows, n * w * h, resident) == want


def _chosen_pool(monkeypatch, resident, rows=8, cfg=None, tuned=None, n=8):
    """(queue, steps, ctrl_den kwarg, pool_from_card count) that
    _render_batch hands the wavefront for one batch of ``n`` samples when
    K1 keeps ``resident`` lanes (None: no card)."""
    seen = {}

    def fake_batch(*a, queue_size, steps_per_wave, with_stats, **kw):
        seen.update(queue=queue_size, steps=steps_per_wave,
                    den=kw.get("ctrl_den"))
        return a[5], {}

    monkeypatch.setattr(trend.kernels, "resident_lanes",
                        lambda device, branching: resident)
    monkeypatch.setattr(trend.wavefront, "render_batch", fake_batch)
    cfg = cfg or TCfg(width=400, height=300)
    bvh = type("B", (), {"nodes": torch.zeros((rows, 1)), "branching": 4})
    spans.reset()
    trend._render_batch(None, None, bvh, None, cfg, torch.zeros(1), 0, n,
                        None, "wavefront", tuned=tuned)
    return (seen["queue"], seen["steps"], seen["den"],
            spans.counters().get("wavefront.pool_from_card", 0))


@pytest.mark.parametrize("case", [
    ("card", RESIDENT, {}, None, (RESIDENT, 12, None, 1)),
    ("card_pinned_queue", RESIDENT, dict(queue_size=8192), None,
     (8192, 12, None, 0)),
    ("card_pinned_steps", RESIDENT, dict(steps_per_wave=20), None,
     (RESIDENT, 20, None, 1)),
    ("card_tuned", RESIDENT, {}, (4096, 16, 16, 2), (4096, 16, 16, 0)),
    ("card_pinned_over_tuned", RESIDENT, dict(queue_size=2048, ctrl_den=8),
     (4096, 16, 16, 2), (2048, 16, 8, 0)),
    ("cpu", None, {}, None, (8192, 12, None, 0)),
    ("cpu_tuned", None, {}, (4096, 16, 16, 2), (4096, 16, 16, 0))],
    ids=lambda c: c[0])
def test_pinned_and_tuned_pools_win_over_the_card(case, monkeypatch):
    """cfg's pinned values, then autotune's, then the card's resident lanes
    (counted in wavefront.pool_from_card), then JAX's preset."""
    _, resident, pins, tuned, want = case
    cfg = TCfg(width=400, height=300, **pins)
    assert _chosen_pool(monkeypatch, resident, cfg=cfg, tuned=tuned) == want


@pytest.mark.parametrize("resident", [None, RESIDENT, 1000])
@pytest.mark.parametrize("rows", [8, 3000])
def test_tuning_preset_is_the_untuned_pool(resident, rows, monkeypatch):
    """Autotune's preset candidate runs the pool and steps the untuned
    batches run, on a card and off one."""
    cfg = TCfg(width=400, height=300)
    q, s, d, stride = trend.tuning_preset(cfg, rows, resident)
    assert stride is None
    assert d == (16 if rows >= 256 else 8)
    assert _chosen_pool(monkeypatch, resident, rows=rows)[:2] == (q, s)


def test_new_entry_points_default_to_cuda():
    import inspect
    from path_tracer_tpu_torch.parallel import render_distributed
    for fn in (render_distributed, twf.tile_spawn_order):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_megakernel_autotune_warns():
    r = _port("megakernel")
    with pytest.warns(UserWarning, match="autotune"):
        r.render(spp=1, batch=1, autotune=True)
    with pytest.warns(UserWarning, match="autotune"):
        assert r.autotune() is None


def test_orbit_camera_matches_jax_and_restart():
    """lookfrom after each rotate/zoom within 1e-12 of JAX's; restart then
    render equals a fresh Renderer at the moved camera, bit for bit."""
    jcam, tcam = _tiny_cam(pt), _tiny_cam(ptt)
    for cam in (jcam, tcam):
        cam.lookfrom = np.array([0.0, 0.0, 3.0])
        cam.lookat = np.array([0.0, 0.0, -1.0])
    r = ptt.Renderer(_world(ptt), tcam, engine="wavefront", seed=4,
                     device="cpu")
    img_a = r.render(spp=2, batch=2)
    jo, to = JOrbit(jcam), OrbitCamera(tcam)
    r0 = to.radius
    for op, arg in (("rotate", (120.0, -40.0)), ("rotate", (0.0, 10000.0)),
                    ("zoom", (0.5,)), ("rotate", (40.0, 0.0))):
        getattr(jo, op)(*arg)
        getattr(to, op)(*arg)
        np.testing.assert_allclose(tcam.lookfrom, jcam.lookfrom, rtol=0,
                                   atol=1e-12)
    off = tcam.lookfrom - tcam.lookat
    assert np.isclose(np.linalg.norm(off), r0 / 2)
    assert abs(np.degrees(np.arcsin(off[1] / np.linalg.norm(off)))) <= 89.0 + 1e-6
    restart(r)
    assert r.samples_done == 0 and float(r.accum.abs().max()) == 0.0
    img_b = r.render(spp=2, batch=2)
    assert r.samples_done == 2 and np.isfinite(img_b).all()
    assert float(np.abs(img_b - img_a).max()) > 1e-3          # the view moved
    fresh = ptt.Renderer(_world(ptt), tcam, engine="wavefront", seed=4,
                         device="cpu")
    np.testing.assert_array_equal(fresh.render(spp=2, batch=2), img_b)


# --- the wavefront's spawn order --------------------------------------------

@pytest.mark.parametrize("w,h,tile", [(32, 18, 16), (33, 17, 4), (800, 450, 16)])
def test_tile_spawn_order_matches_jax(w, h, tile):
    want = np.asarray(jwf.tile_spawn_order(w, h, tile))
    got = twf.tile_spawn_order(w, h, tile, device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_render_batch_spawn_order_matches_jax():
    """Cornell box, 32x18, 2 spp, a 256-slot pool, the 4x4-tile order:
    image within 1e-5 of JAX's, every counter exact."""
    W, H, SPP = 32, 18, 2
    world, cam = pt.scenes.cornell_box()
    cam.img_width, cam.aspect_ratio = W, W / H
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    cam_a = cam.initialize()
    key = jax.random.key(0)
    jimg, jst = jwf.render_batch(
        scene, JFlags.from_scene(scene), bvh, cam_a,
        JCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=10),
        jnp.zeros((H, W, 3)), 0, SPP, key, queue_size=256, steps_per_wave=8,
        with_stats=True, spawn_order=jwf.tile_spawn_order(W, H, 4))
    ts = interop.from_numpy_scene(scene, "cpu")
    timg, tst = twf.render_batch(
        ts, TFlags.from_scene(ts), interop.from_numpy_bvh(bvh, "cpu"),
        interop.from_numpy_camera(cam_a, "cpu"),
        TCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=10),
        torch.zeros((H, W, 3)), 0, SPP,
        interop.key_from_data(np.asarray(jax.random.key_data(key)), "cpu"),
        queue_size=256, steps_per_wave=8, with_stats=True,
        spawn_order=twf.tile_spawn_order(W, H, 4, device="cpu"))
    for k in ("paths", "spawned", "rays", "depth_sum", "waves", "ctrls",
              "occ_sum", "trav_steps", "exec_steps"):
        assert int(tst[k]) == int(jst[k]), k
    np.testing.assert_array_equal(tst["depth_hist"].numpy(),
                                  np.asarray(jst["depth_hist"]))
    assert (tst["pixel_paths"].numpy() == SPP).all()
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0,
                               atol=1e-5)


def test_spawn_order_is_checked():
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 8
    sc = ptt.compile_scene(world, device="cpu")
    args = (sc, TFlags.from_scene(sc), ptt.build_from_scene(sc),
            cam.initialize(device="cpu"), TCfg(width=8, height=8), 0, 1,
            ptt.utils.rng.key(0), 32, 8, 8)
    with pytest.raises(ValueError, match="one entry per block pixel"):
        twf.WaveEngine(*args, spawn_order=torch.arange(63))
    with pytest.raises(ValueError, match="block pixels"):
        twf.WaveEngine(*args, spawn_order=torch.arange(64) + 1)


@pytest.mark.parametrize("stride", [None, 2], ids=["stride1", "stride2"])
def test_emulated_spawn_with_order_matches_twin(stride):
    """K2 built by g++ with the identity (no order) and with the 4x4-tile
    order against ``spawn_plain`` on each control wave: exact."""
    _needs_cxx()
    ops, _ = kernels.host_emulation_ops()
    for order in (None, twf.tile_spawn_order(32, 18, 4, device="cpu")):
        eng, ws = _engine("vol2", stride)
        eng.spawn_order = order
        renewed = 0
        for state in _control_waves(eng, ws):
            shade_tiled.shade_plain(eng, state)
            twf.retire_plain(eng, state)
            emu, twin = state.clone(), state.clone()
            ops[3](eng, emu)
            twf.spawn_plain(eng, twin)
            _assert_same_state(eng, emu, twin, "spawn")
            renewed += int((emu.occupied & ~state.occupied).sum())
        assert renewed > 0
