"""The port's scaling harness, ``scripts/bench_scaling.py``, on gloo ranks.

``bench_scaling.run`` on the CPU twins at ``tools/bench_scaling.py``'s
configuration cut to 32x18 (wavefront_comparison, 2 spp, depth 8, key 0,
the wavefront engine) over 1 and 2 ranks:

* the 2-rank frame equals the 1-rank frame within 1e-5 (the port's DP
  rule, ``tests/test_torch_dist.py``);
* it agrees with JAX's ``render_sharded_wavefront`` on a 2-device virtual
  mesh under ``utils/image.graded_agreement`` (JAX's own 1e-5 rule does not
  hold between the packages on this scene: XLA contracts multiply-adds);
* every path of the frame is integrated once (``paths == 32 * 18 * 2``),
  no kernel launches on the CPU, and each printed line has the format of
  JAX's tool, then the measured rate, ``backend=gloo`` and ``cpu``.
"""
import re

import jax
import numpy as np
import pytest

import path_tracer_tpu as pt
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
from path_tracer_tpu.parallel import render_dist as jrd
from path_tracer_tpu_torch.scripts import bench_scaling
from path_tracer_tpu_torch.utils.image import graded_agreement

W, H = 32, 18
# tools/bench_scaling.py:76-77's line, then the port's fields.
LINE = re.compile(r"devices= ?(\d+): +\d+\.\d ms +\d+\.\d\d Mrays/s\(ub\)  "
                  r"efficiency= ?\d+\.\d%  +\d+\.\d\d Mrays/s\(measured\)  "
                  r"backend=gloo  cpu$")


@pytest.fixture(scope="module")
def scaling():
    lines = []
    rows = bench_scaling.run(2, W, "wavefront", device="cpu",
                             out=lines.append)
    return rows, lines


def test_two_ranks_equal_one_rank(scaling):
    rows, _ = scaling
    assert [r["n"] for r in rows] == [1, 2]
    one, two = rows[0]["image"], rows[1]["image"]
    assert one.shape == two.shape == (H, W, 3)
    assert np.isfinite(two).all()
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-5)


def test_two_ranks_agree_with_jax_mesh(scaling):
    rows, _ = scaling
    world, cam = pt.scenes.wavefront_comparison()
    cam.img_width = W
    scene = pt.compile_scene(world)
    cfg = JCfg(width=W, height=H, samples_per_pixel=2, max_depth=8)
    img = jrd.render_sharded_wavefront(
        scene, JFlags.from_scene(scene), pt.build_from_scene(scene),
        cam.initialize(), cfg, jax.random.key(0), jrd.make_mesh(2), spp=2)
    agree, outliers, clean = graded_agreement(np.asarray(img),
                                              rows[1]["image"])
    assert agree, (outliers, clean)


def test_paths_launches_and_lines(scaling):
    rows, lines = scaling
    for r in rows:
        assert r["paths"] == W * H * 2
        assert r["mrays"] > 0
        assert all(v == 0 for d in r["launches"] for v in d.values())
        assert len(r["launches"]) == r["n"]
    assert rows[0]["efficiency"] == 1.0
    assert len(lines) == 2
    for r, text in zip(rows, lines):
        m = LINE.fullmatch(text)
        assert m, text
        assert int(m.group(1)) == r["n"]
