"""The CUDA kernels of the wavefront engine (and the launch of all five).

* On any machine: the kernels' per-slot code (``csrc/*.cu``), compiled for
  the CPU through ``csrc/host_emulation.cpp``, drives the wave loop in place
  of the launches, over BVH4 and BVH8 rows (K1's two instantiations); its path counts must equal the plain-torch twins' (which
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

# (scene, sample stride, width, node width of the BVH)
CASES = [("cornell_box", None, 32, 4), ("cornell_smoke", 2, 32, 4),
         ("vol2_final_scene", None, 32, 4), ("vol2_final_scene", 2, 48, 4),
         ("cornell_smoke", 2, 32, 8), ("vol2_final_scene", None, 32, 8)]


def _setup(name, width, device, branching=4):
    kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
    world, cam = getattr(ptt.scenes, name)(**kw)
    height = width * 9 // 16
    cam.img_width, cam.aspect_ratio = width, width / height
    scene = ptt.compile_scene(world, device=device)
    return (scene, SceneFlags.from_scene(scene),
            ptt.build_from_scene(scene, branching),
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


@pytest.mark.parametrize("name,stride,width,branching", CASES,
                         ids=[f"{c[0]}-stride{c[1] or 1}-w{c[2]}"
                              + ("-k8" if c[3] == 8 else "") for c in CASES])
def test_kernel_sources_on_cpu_match_twins(name, stride, width, branching):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    ops, _ = kernels.host_emulation_ops()
    setup = _setup(name, width, "cpu", branching)
    assert setup[2].branching == branching
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


@pytest.mark.parametrize("stride", [None, 4], ids=["single", "window4"])
def test_emulated_retire_block_sums_match_twin(stride):
    """K4 built by g++ (its per-lane code and the block reducer, over
    blocks of the kernel's 256 slots) against the twin on control waves of
    a 1024-slot pool, where several blocks hold finished lanes of the same
    depth: counters, histogram, per-pixel paths, flags and occupancy exact,
    the frame allclose (float adds per pixel in another order)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")
    ops, _ = kernels.host_emulation_ops()
    scene, flags, bvh, cam, cfg = _setup("cornell_box", 32, "cpu")
    cfg = dataclasses.replace(cfg, samples_per_pixel=8)
    eng = wf.WaveEngine(scene, flags, bvh, cam, cfg, 0, 8, rng.key(0),
                        queue_size=1024, steps_per_wave=8, ctrl_den=8,
                        sample_stride=stride)
    assert eng.multi == (stride is not None)
    ws = eng.init_state(torch.zeros((cfg.height, cfg.width, 3)))
    checked = 0
    for _ in range(40):
        wf.trace_step_plain(eng, ws)
        wf.shade_plain(eng, ws)
        fin = ws.flag == wf.FL_FINISHED
        blocks = fin.view(-1, 256)
        deep = ws.depth.view(-1, 256)
        # blocks with two or more finished lanes of one depth
        shared = sum(int(torch.bincount(deep[b][blocks[b]]).max()) > 1
                     for b in range(blocks.shape[0]) if blocks[b].any())
        if int(ws.ctr[wf.C_DO_CTRL]) and shared >= 2:
            emu, twin = ws.clone(), ws.clone()
            ops[2](eng, emu)
            wf.retire_plain(eng, twin)
            for f in ("ctr", "depth_hist", "pix_paths", "flag", "occupied"):
                assert torch.equal(getattr(emu, f), getattr(twin, f)), f
            assert torch.allclose(emu.accum, twin.accum, rtol=1e-6, atol=1e-7)
            if eng.multi:
                assert bool((emu.flag == wf.FL_RESAMPLE).any())
            checked += 1
        wf.retire_plain(eng, ws)
        wf.spawn_plain(eng, ws)
    assert checked >= 2


def test_node_table_must_start_on_16_bytes():
    """K1 reads node rows in 16-byte loads: every kernel's argument fill
    refuses a node table whose base is not 16-byte aligned, and takes the
    same rows from an aligned copy."""
    scene, flags, bvh, cam, cfg = _setup("cornell_box", 32, "cpu")
    flat = torch.empty(bvh.nodes.numel() + 1)
    flat[1:] = bvh.nodes.flatten()
    shifted = flat[1:].view(bvh.nodes.shape)          # 4 bytes off
    assert torch.equal(shifted, bvh.nodes) and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        kernels.query_args(dataclasses.replace(bvh, nodes=shifted), 1e9, 8)
    a = kernels.query_args(dataclasses.replace(bvh, nodes=shifted.clone()),
                           1e9, 8)
    assert a.nodes % 16 == 0


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
    # and its full instantiation: a leaf that moves rays
    qd = r.scene.qd_d.clone().requires_grad_()
    img = integrator.render(dataclasses.replace(r.scene, qd_d=qd), r.flags,
                            r.bvh, r.cam_arrays, r.cfg, r.key,
                            differentiable=True, spp=1)
    img.sum().backward()
    assert bool(torch.isfinite(qd.grad).all())
    # the tiled engine, and the pipeline mode's kernels on a one-rank ring
    img = ptt.render_tiled(r.scene, r.flags, r.bvh, r.cam_arrays, r.cfg,
                           r.key, spp=1)
    assert bool(torch.isfinite(img).all())
    sc1, bv1 = ptt.shard_scene(r.scene, 1)
    img = ptt.render_pp(sc1, r.flags, bv1, r.cam_arrays, r.cfg, r.key,
                        ptt.make_mesh(1, "p"))
    assert bool(torch.isfinite(img).all())
    # the P0 row gather
    from path_tracer_tpu_torch.ops import gather
    rows = gather.gather_rows(r.bvh.nodes.contiguous(),
                              torch.zeros((4,), dtype=torch.int32,
                                          device=cuda_device))
    assert torch.equal(rows, r.bvh.nodes[[0, 0, 0, 0]])
    # every wrapper launched; the device wave loop has no kernel of its own
    # (K1 ends it), so it counts none
    assert kernels.LAUNCHES["wave_loop"] == 0, kernels.LAUNCHES
    assert all(v > 0 for n, v in kernels.LAUNCHES.items()
               if n != "wave_loop"), kernels.LAUNCHES
