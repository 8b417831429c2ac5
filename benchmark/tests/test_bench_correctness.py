"""The correctness check: the reference against the port's plain path,
and the check failing for the control and for each planted fault (CPU,
tiny frames of the cells' own scenes)."""
import pytest
import torch

import control
import run
from faults import FAULTS
from harness import check, drivers, port_adapter, registry

SIZES = {"vol2_final": dict(width=24, height=18, samples_per_pixel=8),
         "mesh_perlin_sss": dict(width=24, height=14, samples_per_pixel=8)}
CELLS = ["vol2_final.wavefront", "mesh_perlin_sss.wavefront",
         "vol2_final.megakernel"]


@pytest.fixture(scope="module")
def bench():
    return registry.Bench()


@pytest.mark.parametrize("config", sorted(SIZES))
@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_reference_agrees_with_the_ports_plain_path(bench, config, engine):
    import path_tracer_tpu_torch as ptt
    cfg = dict(bench.config(config), **SIZES[config])
    desc = drivers.scene_description(bench, cfg)
    world, cam = port_adapter.port_world(desc)
    cam.samples_per_pixel, cam.max_depth = 3, cfg["max_depth"]
    seed = 2 ** 31 + 12345
    r = ptt.Renderer(world, cam, engine=engine, seed=seed, device="cpu")
    r.render(spp=3, batch=3)
    npix = cfg["width"] * cfg["height"]
    ref = check.reference_sums(desc, cfg, seed, torch.arange(npix), 3, "cpu")
    port = r.accum.reshape(-1, 3).double()
    assert torch.allclose(port, ref, rtol=1e-6, atol=1e-5)
    assert check.l1_gap(port, ref) < 1e-6


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(bench, cell):
    config = bench.cell(cell)["config"]
    out = run.run_cell(bench, cell, 77, 0.01, False, "cpu",
                       resize=SIZES[config])
    assert out["correct"] is True
    assert out["checks"]["frame_l1_gap"]["value"] <= \
        out["checks"]["frame_l1_gap"]["limit"]
    assert out["reference"]["samples"] == 8
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(bench, cell, fault):
    config = bench.cell(cell)["config"]
    out = run.run_cell(bench, cell, 91, 0.01, False, "cpu",
                       fault=FAULTS[fault], resize=SIZES[config])
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(bench, cell):
    """The reference in bfloat16 in the program's place fails the cell's
    own check (at a test's size; the chip readings are in PERF.md)."""
    resize = SIZES[bench.cell(cell)["config"]]
    output = control.control_output(bench, cell, 5, "cpu", resize=resize)
    correct, numbers, _ = check.check_frame(output, bench.limits(cell), "cpu")
    assert correct is False
    assert numbers["frame_l1_gap"]["value"] > numbers["frame_l1_gap"]["limit"]


def test_the_pixel_sample_is_drawn_from_the_seed():
    a = check.sample_pixels(2 ** 33 + 1, 1000, 50)
    assert torch.equal(a, check.sample_pixels(2 ** 33 + 1, 1000, 50))
    assert not torch.equal(a, check.sample_pixels(2 ** 33 + 2, 1000, 50))
    assert len(set(a.tolist())) == 50
