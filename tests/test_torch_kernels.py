"""The CUDA kernels of the wavefront engine (and the launch of all five).

* On any machine: the kernels' per-slot code (``csrc/*.cu``), compiled for
  the CPU through ``csrc/host_emulation.cpp``, drives the wave loop in place
  of the launches; its path counts must equal the plain-torch twins' (which
  ``test_torch_wavefront.py`` holds against the JAX package), its ray
  counters and frame agree within the graded rule.
* On a CUDA card (marker ``gpu``; skipped elsewhere): the built kernels
  against their twins on the same wave states, and a frame rendered through
  the kernels within the graded agreement of the twin path.
"""
import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.ops import integrator, kernels
from path_tracer_tpu_torch.ops import wavefront as wf
from path_tracer_tpu_torch.ops.shade import SceneFlags
from path_tracer_tpu_torch.ops.types import RenderConfig
from path_tracer_tpu_torch.utils import rng

CASES = [("cornell_box", None, 32), ("cornell_smoke", 2, 32),
         ("vol2_final_scene", None, 32), ("vol2_final_scene", 2, 48)]


def _setup(name, width, device):
    kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
    world, cam = getattr(ptt.scenes, name)(**kw)
    height = width * 9 // 16
    cam.img_width, cam.aspect_ratio = width, width / height
    scene = ptt.compile_scene(world, device=device)
    return (scene, SceneFlags.from_scene(scene), ptt.build_from_scene(scene),
            cam.initialize(device=device),
            RenderConfig(width=width, height=height, samples_per_pixel=2,
                         max_depth=10))


def _run(setup, stride, ops=None, plain=False):
    scene, flags, bvh, cam, cfg = setup
    dev = scene.sph_c0.device
    eng = wf.WaveEngine(scene, flags, bvh, cam, cfg, 0, 2, rng.key(0, dev),
                        queue_size=256, steps_per_wave=8, ctrl_den=8,
                        sample_stride=stride)
    ws = eng.init_state(torch.zeros((cfg.height, cfg.width, 3), device=dev))
    if ops is not None:
        saved = wf.KERNELS
        wf.KERNELS = ops
        try:
            wf.run_waves(eng, ws)
        finally:
            wf.KERNELS = saved
    else:
        wf.run_waves(eng, ws, plain=plain)
    return eng, ws


@pytest.mark.parametrize("name,stride,width", CASES,
                         ids=[f"{c[0]}-stride{c[1] or 1}-w{c[2]}" for c in CASES])
def test_kernel_sources_on_cpu_match_twins(name, stride, width):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    ops, _ = kernels.host_emulation_ops()
    setup = _setup(name, width, "cpu")
    eng, a = _run(setup, stride, plain=True)
    _, b = _run(setup, stride, ops=ops)
    total = eng.items_total
    assert min(int(a.ctr[0]), total) == min(int(b.ctr[0]), total) == total
    assert int(a.ctr[1]) == int(b.ctr[1])          # paths
    assert torch.equal(a.pix_paths, b.pix_paths)
    # sinf/cosf/logf/expf of the host C library and of torch's CPU kernels
    # differ in the last ulp, so a rare path may take another branch.
    for i in (2, 3, 7):                             # rays, depth_sum, steps
        assert abs(int(a.ctr[i]) - int(b.ctr[i])) <= 0.01 * int(a.ctr[i]), i
    assert (a.depth_hist - b.depth_hist).abs().sum() <= 0.01 * int(a.ctr[1])
    per_pix = (a.accum - b.accum).abs().max(-1).values.numpy() / 2
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5


@pytest.mark.parametrize("swap", [None, ("R", "sd"), ("origin", "direction"),
                                  ("t_min", "t_max")],
                         ids=["as-built", "ints", "pointers", "floats"])
def test_wave_args_mirror_checked_field_by_field(swap):
    """The ctypes mirror is checked against the compiled struct's offsets;
    two swapped fields of one type (same total size) must be refused."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    lib = kernels.host_emulation_lib()
    if swap is None:
        kernels.check_layout(lib)
        return
    fields = list(kernels.WaveArgs._fields_)
    names = [f for f, _t in fields]
    i, j = names.index(swap[0]), names.index(swap[1])
    fields[i], fields[j] = fields[j], fields[i]
    mirror = type("Swapped", (ctypes.Structure,), {"_fields_": fields})
    assert ctypes.sizeof(mirror) == ctypes.sizeof(kernels.WaveArgs)
    with pytest.raises(RuntimeError, match="layout mismatch"):
        kernels.check_layout(lib, mirror)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,stride", [("cornell_smoke", 2),
                                         ("vol2_final_scene", None)])
def test_kernels_match_twins_on_card(cuda_device, name, stride):
    setup = _setup(name, 64, cuda_device)
    kernels.reset_launches()
    _, a = _run(setup, stride)
    assert all(kernels.LAUNCHES[n] > 0
               for n in ("trace_step", "spawn", "shade", "retire"))
    _, b = _run(setup, stride, plain=True)
    assert torch.equal(a.pix_paths, b.pix_paths)
    assert int(a.ctr[1]) == int(b.ctr[1])
    per_pix = (a.accum - b.accum).abs().max(-1).values.cpu().numpy() / 2
    assert (per_pix > 1e-3).mean() <= 0.01
    assert per_pix[per_pix <= 1e-3].mean() < 1e-5


@pytest.mark.gpu
def test_kernel_wrappers_launch_on_card(cuda_device):
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 32
    kernels.reset_launches()
    for engine in ("wavefront", "megakernel"):
        r = ptt.Renderer(world, cam, engine=engine, device=cuda_device)
        img = r.render(spp=2)
        assert np.isfinite(img).all() and img.mean() > 0
    # the adjoint kernel: the backward of a differentiable render
    c1 = r.scene.tex_c1.clone().requires_grad_()
    img = integrator.render(dataclasses.replace(r.scene, tex_c1=c1), r.flags,
                            r.bvh, r.cam_arrays, r.cfg, r.key,
                            differentiable=True, spp=1)
    img.sum().backward()
    assert bool(torch.isfinite(c1.grad).all()) and float(c1.grad.abs().sum()) > 0
    assert all(v > 0 for v in kernels.LAUNCHES.values())
