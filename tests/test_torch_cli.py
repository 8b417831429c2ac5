"""The port's CLI and ``render_distributed`` against JAX's, on the CPU.

* ``--list-scenes`` prints JAX's list.
* One ``--cpu`` render of cornell_box (24x24, 2 spp, the wavefront): the
  closing JSON line has JAX's keys and the port's ``spans`` (with no wave
  loop graph captured on the CPU), and the same
  ``samples`` and ``rays_traced`` (the Cornell scenes' counters match
  exactly); the ``.ppm`` is within 1 of JAX's in every channel (8-bit
  values).
* ``--local-devices 2`` exits 2 naming ``--backend``; without ``--cpu`` and
  without a card the CLI exits 2; ``--engine megakernel`` with a wavefront
  flag (``--queue-size``, ``--autotune``) warns.
* Two gloo ranks (``--cpu --coordinator``, started through
  ``parallel/launch.py:run_ranks``) render wavefront_comparison at width
  32, 4 spp, seed 3.  Against the port's one-process ``Renderer``: the rule
  of ``tests/test_multihost.py:81-82`` (mean |d| < 3e-5, at most 1% of
  pixels beyond 1e-4).  Against JAX's one-process ``Renderer``: the graded
  rule of ``tools/bench_ab.py:74-89`` (at most 1% of pixels beyond 1e-3,
  clean-pixel mean < 1e-5).  JAX's multi-process rule does not hold there:
  mean |d| 3.64e-5 (measured), 2 of 576 pixels beyond 1e-3, and the
  port's one-process render against JAX's fails it the same way: 5,028
  traced segments against JAX's 5,027 over the same 2,304 paths, as XLA's
  CPU backend contracts multiply-adds the twins round apart (ROADMAP.md C);
  JAX's own two engines differ in another pixel (0.0044).
* In one 2-rank job, ``render_distributed`` to 4 spp against 2 spp
  checkpointed then resumed to 4 (batches of one sample): bit-identical,
  the same on both ranks; another seed on that checkpoint is refused.
"""
import json
import os
import sys
import tempfile

import numpy as np
import pytest

import path_tracer_tpu as pt
from path_tracer_tpu.render import cli as jcli
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.parallel.launch import run_ranks
from path_tracer_tpu_torch.render import cli as tcli

import torch_ranks as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_ppm(path):
    with open(path) as f:
        toks = f.read().split()
    assert toks[0] == "P3"
    w, h = int(toks[1]), int(toks[2])
    return np.array(toks[4:], dtype=np.int64).reshape(h, w, 3)


def _last_json(out: str) -> dict:
    return json.loads([x for x in out.splitlines() if x.startswith("{")][-1])


def test_list_scenes_matches_jax(capsys):
    assert jcli.main(["--list-scenes"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["--list-scenes"]) == 0
    assert capsys.readouterr().out == want


def test_cpu_render_matches_jax_cli(tmp_path, capsys):
    args = ["--cpu", "--scene", "cornell_box", "--width", "24", "--spp", "2",
            "--batch", "1", "--max-depth", "8"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax.ppm")]) == 0
    want = _last_json(capsys.readouterr().out)
    assert tcli.main(args + ["--out", str(tmp_path / "port.ppm")]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want) | {"spans"}
    assert got["samples"] == want["samples"] == 2
    # The port's own host-time spans of this render: two batches, one frame.
    sp = got["spans"]
    # the CPU twins run no device wave loop: no graph captured
    assert sp.pop("wavefront.captures") == {"count": 0, "per_batch": 0.0}
    # the wave pool's counters (utils/spans.py counters()), summed
    for name in ("wavefront.waves", "wavefront.live_lanes",
                 "wavefront.slot_waves"):
        assert sp.pop(name)["count"] > 0, name
    assert sp["renderer.batch"]["count"] == 2
    assert sp["renderer.frame_return"]["count"] == 1
    assert sp["wavefront.setup"]["count"] == 2
    assert all(0 <= a["self_ms"] <= a["total_ms"] for a in sp.values())
    assert got["rays_traced"] == want["rays_traced"]
    assert got["depth_hist"] == want["depth_hist"]
    a, b = _read_ppm(tmp_path / "port.ppm"), _read_ppm(tmp_path / "jax.ppm")
    assert a.shape == b.shape == (24, 24, 3)
    assert int(np.abs(a - b).max()) <= 1


def test_local_devices_and_no_card_exit_2(capsys, monkeypatch):
    assert tcli.main(["--local-devices", "2"]) == 2
    assert "--backend" in capsys.readouterr().err
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["--scene", "cornell_box", "--width", "8"]) == 2
    assert "--cpu" in capsys.readouterr().err


def test_megakernel_warns_on_wavefront_flags(tmp_path, capsys):
    """--engine megakernel with a wavefront flag renders and warns."""
    args = ["--cpu", "--scene", "cornell_box", "--width", "8", "--spp", "1",
            "--engine", "megakernel", "--out", str(tmp_path / "m.ppm")]
    with pytest.warns(UserWarning, match="queue_size"):
        assert tcli.main(args + ["--queue-size", "64"]) == 0
    with pytest.warns(UserWarning, match="autotune"):
        assert tcli.main(args + ["--autotune"]) == 0
    assert _last_json(capsys.readouterr().out)["samples"] == 1


def test_two_rank_cli_matches_jax_renderer():
    scene, width, spp = "wavefront_comparison", 32, 4
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mh.npz")
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        run_ranks(2, lambda r, port: [
            sys.executable, "-m", "path_tracer_tpu_torch.render.cli", "--cpu",
            "--scene", scene, "--width", str(width), "--spp", str(spp),
            "--seed", "3", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(r), "--out", out],
            tmp, 240, env=env, cwd=REPO)
        with open(os.path.join(tmp, "rank2_0.log")) as f:
            log = f.read()
        with np.load(out) as z:
            mh = z["img"]
    assert "rank 0/2 up: backend gloo, device cpu" in log
    assert json.loads(log.splitlines()[-1])["processes"] == 2
    singles = []
    for pkg, kw in ((ptt, {"device": "cpu"}), (pt, {})):
        world, cam = pkg.scenes.SCENES[scene]()
        cam.img_width, cam.samples_per_pixel = width, spp
        singles.append(np.asarray(pkg.Renderer(
            world, cam, engine="wavefront", seed=3, **kw).render(
                spp=spp, batch=spp)))
    port, jax_img = singles
    assert mh.shape == port.shape == jax_img.shape
    d = np.abs(mh - port)
    assert float(d.mean()) < 3e-5
    assert float((d.max(axis=-1) > 1e-4).mean()) <= 0.01
    per_pix = np.abs(mh - jax_img).max(axis=-1)
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5


def test_render_distributed_resume_is_bit_identical(tmp_path):
    job = {"name": "resume", "scene": "wavefront_comparison", "width": 32,
           "spp": 4, "split": 2, "seed": 3, "ckpt": str(tmp_path / "c.npz")}
    res = tr.run_ranks(2, [job])
    for r in res:
        out = r[0]
        assert np.isfinite(out["whole"]).all()
        np.testing.assert_array_equal(out["resumed"], out["whole"])
        assert "fingerprint" in out["refused"]
    np.testing.assert_array_equal(res[0][0]["whole"], res[1][0]["whole"])
    with np.load(job["ckpt"]) as z:
        assert int(z["samples_done"]) == 4
        assert sorted(z.files) == ["accum", "fingerprint", "samples_done"]
