"""K5's walk on the card under variants of the traversal step's code.

    python path_tracer_tpu_torch/scripts/walk_unroll.py

The shipped step (``csrc/traverse.cuh`` ``trav_step<K>``) unrolls its loop
over the K children, so K5 (``csrc/megakernel.cu``) holds K inline copies
of the leaf test in each of its two walks (the closest hit and the
volume-exit query).  This script builds ``megakernel.cu`` from copies of
``csrc/`` under the git-ignored ``build/walk_unroll/`` in four variants,
one ``nvcc`` each, all started together:

1. ``unrolled``: the shipped code;
2. ``rolled``: the child loop under ``#pragma unroll 1``;
3. ``unroll2``: the child loop under ``#pragma unroll 2``;
4. ``walk_noinline``: the shipped step, ``trav_full`` not inlined (one copy
   of the walk for both queries).

For node widths 4 and 8 it launches each variant on one sample of the
vol2_final frame (sphere_cluster=1000, 800x450, depth 10), holds its
colours bit-equal to the shipped kernel's, and prints per variant the
time of one launch (CUDA events, median of 25) and the ptxas registers and
stack frame, one JSON object per line, after the card's ``nvidia-smi``
name and power limit.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _REPO)

import path_tracer_tpu_torch as ptt  # noqa: E402
from path_tracer_tpu_torch.ops import integrator, kernels  # noqa: E402
from path_tracer_tpu_torch.ops.shade import SceneFlags  # noqa: E402
from path_tracer_tpu_torch.ops.types import RenderConfig  # noqa: E402
from path_tracer_tpu_torch.utils import rng  # noqa: E402

SRC = os.path.join(_REPO, "path_tracer_tpu_torch", "csrc")
OUT = os.path.join(_REPO, "build", "walk_unroll")
CHILD_LOOP = "#pragma unroll\n  for (int c = 0; c < K; ++c) {"
TRAV_FULL = "template <int K>\n__device__ __forceinline__ void trav_full("


def variants() -> dict:
    """{name: {file: text}}: the sources each variant replaces."""
    step = open(os.path.join(SRC, "traverse.cuh")).read()
    path = open(os.path.join(SRC, "path.cuh")).read()
    if CHILD_LOOP not in step or TRAV_FULL not in path:
        raise RuntimeError("traverse.cuh or path.cuh no longer has the code "
                           "the variants rewrite")
    return {
        "unrolled": {},
        "rolled": {"traverse.cuh": step.replace(
            CHILD_LOOP, CHILD_LOOP.replace("unroll", "unroll 1"))},
        "unroll2": {"traverse.cuh": step.replace(
            CHILD_LOOP, CHILD_LOOP.replace("unroll", "unroll 2"))},
        "walk_noinline": {"path.cuh": path.replace(
            TRAV_FULL, TRAV_FULL.replace("__forceinline__", "__noinline__"))},
    }


def build(names_files: dict) -> dict:
    """Compile ``megakernel.cu`` of each variant → {name: (lib, ptxas log)}."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, files in names_files.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        so = os.path.join(d, "megakernel.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-o", so,
             os.path.join(d, "megakernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        kernels.check_layout(lib)
        out[name] = (lib, log)
    return out


def ptxas(log: str, k: int) -> tuple:
    """(registers, stack frame bytes) of ``megakernel_kernel<k, false>``."""
    tag = f"megakernel_kernelILi{k}ELb0EE"
    regs = frame = None
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if tag not in line:
            continue
        if "Function properties" in line:
            frame = int(lines[i + 1].split("bytes stack frame")[0].split()[-1])
        if "Compiling entry function" in line:
            for nxt in lines[i + 1:]:
                if "Used" in nxt and "registers" in nxt:
                    regs = int(nxt.split("Used")[1].split("registers")[0])
                    break
    return regs, frame


def cuda_ms(fn, reps=25):
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("walk_unroll: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(variants())
    dev = torch.device("cuda")
    W, H = 800, 450
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = W / H, W
    scene = ptt.compile_scene(world, device=dev)
    flags = SceneFlags.from_scene(scene)
    cam_a = cam.initialize(device=dev)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=10, max_depth=10)
    key = rng.key(0, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for k in (4, 8):
        eng = integrator.MegaEngine(scene, flags,
                                    ptt.build_from_scene(scene, branching=k),
                                    cam_a, cfg, key)
        ref = None
        for name, (lib, log) in libs.items():
            fn = lib.ptt_launch_megakernel
            fn.argtypes = [ctypes.POINTER(kernels.WaveArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            ms = eng.init_state(torch.zeros((H, W, 3), device=dev))
            a = kernels.set_stack(kernels.make_args(eng, ms), eng.npix, dev)

            def launch():
                err = fn(ctypes.byref(a), stream)
                if err != 0:
                    raise RuntimeError(f"launch of {name} failed: {err}")

            launch()
            torch.cuda.synchronize()
            colour = ms.color.clone()
            ref = colour if ref is None else ref
            print(json.dumps({
                "variant": name, "branching": k, "ms": cuda_ms(launch),
                "colour_equal_to_shipped": bool(torch.equal(colour, ref)),
                "registers_stack": ptxas(log, k),
                "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
