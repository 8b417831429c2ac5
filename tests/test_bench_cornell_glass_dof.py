"""The benchmark's configuration ``cornell_glass_dof`` and its cell
``cornell_glass_dof.wavefront`` on the CPU, at 40x30, 4 spp, depth 20.

* The port's plain path (the twins), on both engines, agrees with the
  benchmark's plain reference (``benchmark/reference/``) over every pixel,
  to ``benchmark/tests/test_bench_correctness.py``'s tolerances: rtol
  1e-6 and atol 1e-5 per pixel, and an L1 gap below 1e-6.  The seed was
  fixed before the first comparison; no path through the glass sphere
  turns another way on it.
* The cell's run (``run.run_cell`` with the frame resized) is ``correct``;
  each planted fault of ``benchmark/faults.py`` and the bfloat16 control
  of ``benchmark/control.py`` are not, against the cell's own limit.
* On the card (marked ``gpu``), at the published 400x300, 64 spp: the
  Renderer's wavefront runs the pool of K1's resident lanes
  (``kernels.resident_lanes``) unless ``cfg`` pins one, and its frame is
  ``correct`` against the cell's limit, at one seed with the card's pool
  and with a pinned 8,192-slot pool.
* The scene module's 12 quads (five walls, the light, the rotated box's
  six faces) and its glass sphere compile to the primitives of the port's
  ``scenes.cornell_glass_dof()``, the rotated box to 1e-9, and the
  configuration's camera is that scene's camera.

The benchmark's folder is put on ``sys.path`` as its own
``benchmark/tests/conftest.py`` does.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import control  # noqa: E402
import run  # noqa: E402
from faults import FAULTS  # noqa: E402
from harness import check, drivers, port_adapter, registry  # noqa: E402

import path_tracer_tpu_torch as ptt  # noqa: E402
from path_tracer_tpu_torch.models.compile import compile_scene  # noqa: E402
from path_tracer_tpu_torch.ops import kernels  # noqa: E402
from path_tracer_tpu_torch.ops.types import RenderConfig  # noqa: E402
from path_tracer_tpu_torch.utils import spans  # noqa: E402

CELL = "cornell_glass_dof.wavefront"
SIZE = dict(width=40, height=30, samples_per_pixel=4)
# Frames of two batches of 2 samples: the half-batch fault then drops a
# sample of each batch, and the warm-up renders one batch.
TRAFFIC = dict(batch=2)
SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def bench():
    return registry.Bench()


@pytest.fixture(scope="module")
def small(bench):
    """(configuration at 40x30, its description, the reference's sums over
    every pixel for 4 samples at ``SEED``)."""
    cfg = dict(bench.config("cornell_glass_dof"), **SIZE)
    desc = drivers.scene_description(bench, cfg)
    npix = cfg["width"] * cfg["height"]
    ref = check.reference_sums(desc, cfg, SEED, torch.arange(npix), 4, "cpu")
    return cfg, desc, ref


def test_the_configuration_is_the_published_one(bench):
    cfg = bench.config("cornell_glass_dof")
    assert (cfg["width"], cfg["height"], cfg["samples_per_pixel"],
            cfg["max_depth"]) == (400, 300, 64, 20)
    assert cfg["reduced"] == []
    assert bench.cell(CELL)["chips"] == 1
    assert bench.traffic(bench.cell(CELL)["traffic"])["engine"] == "wavefront"


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_reference_agrees_with_the_ports_plain_path(small, engine):
    cfg, desc, ref = small
    world, cam = port_adapter.port_world(desc)
    cam.samples_per_pixel, cam.max_depth = 4, cfg["max_depth"]
    r = ptt.Renderer(world, cam, engine=engine, seed=SEED, device="cpu")
    r.render(spp=4, batch=4)
    port = r.accum.reshape(-1, 3).double()
    assert torch.allclose(port, ref, rtol=1e-6, atol=1e-5)
    assert check.l1_gap(port, ref) < 1e-6
    assert float(ref.sum()) > 0


def test_a_sound_run_is_correct(bench):
    out = run.run_cell(bench, CELL, SEED, 0.01, False, "cpu", resize=SIZE,
                       traffic_resize=TRAFFIC)
    assert out["correct"] is True
    assert out["checks"]["frame_l1_gap"]["value"] <= \
        out["checks"]["frame_l1_gap"]["limit"]
    assert out["reference"]["samples"] == 4
    assert out["reference"]["pixels"] == 40 * 30


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(bench, fault):
    out = run.run_cell(bench, CELL, SEED + 1, 0.01, False, "cpu",
                       fault=FAULTS[fault], resize=SIZE,
                       traffic_resize=TRAFFIC)
    assert out["correct"] is False, out["checks"]


def test_the_bfloat16_control_is_not_correct(bench):
    output = control.control_output(bench, CELL, SEED, "cpu", resize=SIZE)
    correct, numbers, _ = check.check_frame(output, bench.limits(CELL), "cpu")
    assert correct is False
    assert numbers["frame_l1_gap"]["value"] > numbers["frame_l1_gap"]["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("pinned", [None, 8192], ids=["card_pool", "pinned"])
def test_card_pool_is_k1s_resident_lanes_and_correct(bench, pinned):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    config = bench.config("cornell_glass_dof")
    desc = drivers.scene_description(bench, config)
    world, cam = port_adapter.port_world(desc)
    cam.samples_per_pixel = spp = config["samples_per_pixel"]
    cam.max_depth = config["max_depth"]
    w, h = config["width"], config["height"]
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_depth=cam.max_depth, queue_size=pinned)
    r = ptt.Renderer(world, cam, engine="wavefront", cfg=cfg, seed=SEED,
                     device="cuda")
    spans.reset()
    r.render(spp=spp, batch=8)
    resident = kernels.resident_lanes("cuda", 4)
    lanes = kernels.library("trace_step").ptt_trace_step_resident_lanes(4)
    assert resident == lanes > 8192
    assert r.stats.slots == (pinned or min(resident, 8 * w * h))
    assert spans.counters().get("wavefront.pool_from_card", 0) == (
        0 if pinned else spp // 8)
    output = dict(desc=desc, config=config, seed=SEED,
                  frame=r.accum.reshape(-1, 3), samples=r.samples_done,
                  width=w, height=h)
    correct, numbers, _ = check.check_frame(output, bench.limits(CELL),
                                            "cuda")
    assert correct is True, numbers


QUAD_FIELDS = ("qd_q", "qd_u", "qd_v", "qd_n", "qd_w", "qd_d", "qd_mat")
SPHERE_FIELDS = ("sph_c0", "sph_c1", "sph_rad", "sph_mat")
MAT_FIELDS = ("mat_type", "mat_tex", "mat_ir", "tex_type", "tex_c1")


def test_the_scene_module_is_the_ports_scene(bench):
    desc = drivers.scene_description(bench, bench.config("cornell_glass_dof"))
    kinds = [p.kind for p in desc.prims]
    assert kinds == ["quad"] * 12 + ["sphere"]
    world, cam = port_adapter.port_world(desc)
    ref_world, ref_cam = ptt.scenes.cornell_glass_dof()
    mine = compile_scene(world, device="cpu")
    theirs = compile_scene(ref_world, device="cpu")
    for name in QUAD_FIELDS + SPHERE_FIELDS + MAT_FIELDS:
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.shape == b.shape, name
        assert torch.allclose(a.double(), b.double(), rtol=0, atol=1e-9), name
    # The rotated box's faces: corners and edges off the axes.
    box_u = mine.qd_u[6:12].double()
    assert (box_u[:, 0].abs() > 1).any() and (box_u[:, 2].abs() > 1).any()
    for field in ("img_width", "img_height", "vfov", "defocus_angle",
                  "focus_distance"):
        assert getattr(cam, field) == pytest.approx(getattr(ref_cam, field))
    for field in ("lookfrom", "lookat", "vup", "background"):
        np.testing.assert_allclose(getattr(cam, field),
                                   getattr(ref_cam, field))
    assert ref_cam.samples_per_pixel == 64 and ref_cam.max_depth == 20
