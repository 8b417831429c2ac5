"""The port's tool scripts on the CPU: the engine A/B
(``scripts/bench_ab.py``), the render watcher (``scripts/watch_render.py``),
the pool sweep (``scripts/bench_queue_sweep.py``) and the demo's PNG writers.

* ``bench_ab.run`` at 32 wide, 2 spp, depth 4 returns the key set of JAX's
  ``tools/bench_ab.py:run`` on the same arguments (plus ``card``), and the
  two engines' images agree in both packages;
* ``graded_agreement`` gives what ``tools/bench_ab.py:74-89`` computes
  inline, on seeded pairs on both sides of its limits;
* the watcher, started as a process on a checkpoint the port's ``Renderer``
  saved, writes the PNG that ``write_png(accum, samples_done)`` writes, and
  is then terminated;
* the sweep's ``run`` at 32x18 on two pool shapes: finite images within a
  mean |Δ| of 1e-6 of each other (another pool reorders float adds only);
* ``write_texture_pair_png`` and ``write_curve_png`` write readable PNGs of
  the expected size.
"""
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from PIL import Image

import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.scripts import bench_ab, bench_queue_sweep
from path_tracer_tpu_torch.scripts import train_demo
from path_tracer_tpu_torch.utils.image import graded_agreement, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_bench_ab_matches_jax_keys():
    args = ("wavefront_comparison", 32, 2, 4)
    port = bench_ab.run(*args, device="cpu")
    jax_out = _jax_tool("bench_ab").run(*args)
    assert port.pop("card") == "cpu"
    assert _keys(port) == _keys(jax_out)
    assert port["images_agree"] and jax_out["images_agree"]
    assert port["image_clean_mean_diff"] < 1e-5


def _jax_graded(a, b, outlier_bound=0.01):
    """tools/bench_ab.py:74-89, inline there."""
    diff = np.abs(a - b)
    per_pix = diff.max(axis=-1)
    outliers = float((per_pix > 1e-3).mean())
    clean = per_pix[per_pix <= 1e-3]
    agree = bool(outliers <= outlier_bound
                 and (clean.size == 0 or clean.mean() < 1e-5))
    return agree, outliers, float(clean.mean()) if clean.size else 0.0


@pytest.mark.parametrize("case", ["agree", "too_many", "clean_drift",
                                  "bound_raised"])
def test_graded_agreement_is_jax_formula(case):
    rng = np.random.default_rng(11)
    a = rng.uniform(0.0, 1.0, (30, 40, 3)).astype(np.float32)
    b = a + rng.normal(0.0, 2e-6, a.shape).astype(np.float32)
    flat = b.reshape(-1, 3)
    idx = rng.permutation(flat.shape[0])
    bound = 0.01
    if case == "agree":
        flat[idx[:12], 0] += 0.3              # exactly 1% of 1,200 pixels
    elif case == "too_many":
        flat[idx[:13], 0] += 0.3
    elif case == "clean_drift":
        b += np.float32(2e-5)
    else:
        flat[idx[:40], 1] += 0.2
        bound = 0.05
    got = graded_agreement(a, b, bound)
    want = _jax_graded(a, b, bound)
    assert got[0] == want[0] == (case in ("agree", "bound_raised"))
    assert got[1] == pytest.approx(want[1])
    assert got[2] == pytest.approx(want[2])


def test_watch_render_writes_the_checkpoint_png(tmp_path):
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 16
    r = ptt.Renderer(world, cam, engine="wavefront", device="cpu")
    ckpt = str(tmp_path / "r.ckpt.npz")
    r.render(spp=2, batch=1, checkpoint_path=ckpt)
    out = str(tmp_path / "preview.png")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "path_tracer_tpu_torch",
                                      "scripts", "watch_render.py"),
         ckpt, out, "0.2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO)
    try:
        deadline = time.time() + 60
        while not os.path.exists(out) and time.time() < deadline:
            time.sleep(0.2)
        time.sleep(0.5)                      # let the write finish
    finally:
        proc.terminate()
        try:
            log, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
    assert os.path.exists(out), log
    with np.load(ckpt) as z:
        ref = str(tmp_path / "ref.png")
        write_png(ref, z["accum"], int(z["samples_done"]))
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  np.asarray(Image.open(ref)))
    assert "2 samples" in log


def test_queue_sweep_pools_agree():
    inputs = bench_queue_sweep.setup(width=32, height=18, spp=3, depth=4,
                                     device="cpu")
    imgs = []
    for queue, steps in ((128, 8), (512, 16)):
        mrays, s_sample, first_s, img, waves = bench_queue_sweep.run(
            *inputs, queue, steps)
        assert img.shape == (18, 32, 3) and np.isfinite(img).all()
        assert mrays > 0 and s_sample > 0 and first_s > 0 and waves > 0
        imgs.append(img)
    assert float(np.abs(imgs[1] - imgs[0]).mean()) <= 1e-6


def test_demo_pngs(tmp_path):
    true = ptt.scenes.texture_target(8)
    pair = str(tmp_path / "pair.png")
    train_demo.write_texture_pair_png(true, true * 0.9, pair)
    with Image.open(pair) as im:
        assert im.size == (8 * 40 * 2 + 20, 8 * 40) and im.mode == "RGB"
    hist = [{"step": i, "loss": 10.0 ** -i, "err_albedo": 0.5 / (i + 1),
             "err_emission": 0.3 / (i + 1)} for i in range(30)]
    curve = str(tmp_path / "curve.png")
    train_demo.write_curve_png(hist, curve)
    with Image.open(curve) as im:
        arr = np.asarray(im)
    assert arr.shape == (440, 770, 3)
    assert (arr != 255).any(axis=-1).sum() > 500       # the lines were drawn
