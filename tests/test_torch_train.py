"""The port's train step against the JAX package's with a one-device mesh.

``parallel.make_train_step`` (the wavefront engine: ``render_batch_diff``,
autograd of the twin's replay on the CPU) against JAX's
``make_train_step(flags, cfg, make_mesh(1))`` on the scene of
``tests/test_sharding.py``, with ``tex_c1`` as the parameter: loss,
gradients and new parameters within atol 2e-5 / rtol 1e-3 (JAX's
engine-to-engine gradient limit, ``tests/test_integrator_tiled.py:111-112``),
for ``unbiased`` False and True; one step descends
(``tests/test_sharding.py:69-84``); ``calibrate_n_waves`` and the
``n_waves`` contract; the megakernel engine's step (the tiled engine, as
JAX's) equals the wavefront's.
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
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.parallel import render_dist as trd

ATOL, RTOL = 2e-5, 1e-3
CFG = dict(width=32, height=16, samples_per_pixel=2, max_depth=5)
KW = dict(spp=1, lr=0.5, queue_size=256, steps_per_wave=8, n_waves=192)


def _jax_setup():
    """tests/test_sharding.py:_setup."""
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, 0, -1), 0.5, pt.Lambertian((0.7, 0.3, 0.3))))
    w.add(pt.Sphere.stationary((0, -100.5, -1), 100,
                               pt.Lambertian((0.8, 0.8, 0.0))))
    w.add(pt.Quad((-2, 1.5, -2), (1, 0, 0), (0, 0, 1),
                  pt.DiffuseLight((4, 4, 4))))
    cam = pt.Camera()
    cam.aspect_ratio = 2.0
    cam.img_width = 32
    scene = pt.compile_scene(w)
    return scene, JFlags.from_scene(scene), pt.build_from_scene(scene), \
        cam.initialize()


@pytest.fixture(scope="module")
def setup():
    scene, flags, bvh, cam = _jax_setup()
    rs = np.random.default_rng(0)
    target = rs.uniform(0.0, 0.5, (CFG["height"], CFG["width"], 3)).astype(
        np.float32)
    port = (interop.from_numpy_scene(scene, "cpu"),
            interop.from_numpy_bvh(bvh, "cpu"),
            interop.from_numpy_camera(cam, "cpu"))
    return dict(j=(scene, flags, bvh, cam), t=port, target=target)


def _tkey(key):
    return interop.key_from_data(np.asarray(jax.random.key_data(key)), "cpu")


@pytest.mark.parametrize("unbiased", [False, True])
def test_train_step_matches_jax(setup, unbiased):
    scene, flags, bvh, cam = setup["j"]
    ts, tb, tc = setup["t"]
    key = jax.random.key(2)
    jstep = jrd.make_train_step(flags, JCfg(**CFG), jrd.make_mesh(1),
                                unbiased=unbiased, **KW)
    jp, jl, jg, jaux = jstep({"tex_c1": scene.tex_c1}, scene, bvh, cam, key,
                             jnp.asarray(setup["target"]))
    tstep = trd.make_train_step(TFlags.from_scene(ts), TCfg(**CFG), None,
                                unbiased=unbiased, **KW)
    params = interop.from_numpy_params({"tex_c1": np.asarray(scene.tex_c1)},
                                       "cpu")
    tp, tl, tg, taux = tstep(params, ts, tb, tc, _tkey(key),
                             torch.from_numpy(setup["target"]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    g = tg["tex_c1"].numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, np.asarray(jg["tex_c1"]), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tp["tex_c1"].numpy(), np.asarray(jp["tex_c1"]),
                               atol=ATOL, rtol=RTOL)
    assert taux["paths_done"] == taux["paths_total"] == int(
        jaux["paths_total"]) == int(jaux["paths_done"])


def test_train_step_descends_and_engines_agree(setup):
    """One SGD step on texture colours lowers the loss
    (tests/test_sharding.py:69-84), and the megakernel engine's step gives
    the wavefront's loss and gradients (one sample set)."""
    ts, tb, tc = setup["t"]
    fl = TFlags.from_scene(ts)
    target = torch.zeros((CFG["height"], CFG["width"], 3))
    key = torch.tensor([0, 2])
    step = trd.make_train_step(fl, TCfg(**CFG), None, **KW)
    p1, l1, g1, aux1 = step({"tex_c1": ts.tex_c1}, ts, tb, tc, key, target)
    assert aux1["paths_done"] == aux1["paths_total"] == 32 * 16
    p2, l2, _, _ = step(p1, ts, tb, tc, key, target)
    assert float(l2) < float(l1)
    mstep = trd.make_train_step(fl, TCfg(**CFG), trd.make_mesh(1),
                                engine="megakernel", **KW)
    _, ml, mg, maux = mstep({"tex_c1": ts.tex_c1}, ts, tb, tc, key, target)
    assert maux == {"paths_done": 0, "paths_total": 0}
    np.testing.assert_allclose(float(ml), float(l1), rtol=1e-5)
    np.testing.assert_allclose(mg["tex_c1"].numpy(), g1["tex_c1"].numpy(),
                               atol=ATOL, rtol=RTOL)


def test_calibrate_n_waves_matches_jax(setup):
    """The wave schedule follows JAX's adaptive exit, so the budget sized
    on the same setup is JAX's."""
    scene, flags, bvh, cam = setup["j"]
    ts, tb, tc = setup["t"]
    key = jax.random.key(3)
    want = jrd.calibrate_n_waves(scene, flags, bvh, cam, JCfg(**CFG), key,
                                 spp=2, queue_size=256, steps_per_wave=8)
    got = trd.calibrate_n_waves(ts, TFlags.from_scene(ts), tb, tc,
                                TCfg(**CFG), _tkey(key), spp=2,
                                queue_size=256, steps_per_wave=8)
    assert got == want


def test_calibrate_and_wave_budget(setup):
    scene, flags, bvh, cam = setup["j"]
    ts, tb, tc = setup["t"]
    fl = TFlags.from_scene(ts)
    key = torch.tensor([0, 1])
    n = trd.calibrate_n_waves(ts, fl, tb, tc, TCfg(**CFG), key, spp=1,
                              queue_size=256, steps_per_wave=8)
    _, st = twf.render_batch(ts, fl, tb, tc, TCfg(**CFG),
                             torch.zeros((16, 32, 3)), 0, 1, key,
                             queue_size=256, steps_per_wave=8,
                             with_stats=True)
    assert n == int(int(st["waves"]) * 1.5) + 8
    x = ts.tex_c1.clone().requires_grad_()
    sc = twf.dataclasses.replace(ts, tex_c1=x)
    args = (sc, fl, tb, tc, TCfg(**CFG), torch.zeros((16, 32, 3)), 0, 1, key)
    with pytest.raises(RuntimeError, match="calibrate_n_waves"):
        twf.render_batch_diff(*args, queue_size=256, steps_per_wave=8,
                              n_waves=int(st["waves"]) - 1)
    with pytest.warns(UserWarning, match="ckpt_every"):
        img, st2 = twf.render_batch_diff(*args, queue_size=256,
                                         steps_per_wave=8, n_waves=n,
                                         ckpt_every=4)
    assert int(st2["paths"]) == int(st2["total"])
    with pytest.raises(TypeError, match="Mesh"):
        trd.make_train_step(fl, TCfg(**CFG), [0, 1])
