"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each kernel source (``trace_step.cu``, ``spawn.cu``, ``shade.cu``,
``retire.cu``, ``megakernel.cu``, ``adjoint.cu``) is compiled by its own
``nvcc`` for ``sm_90a``, all six started together, into a shared library with a plain C interface under the
git-ignored ``build/torch_ext/`` (file names carry a hash of the sources, so
an edit rebuilds).  The libraries are opened with ``ctypes``; device
pointers come from ``tensor.data_ptr()`` and the stream from PyTorch's
current stream.  Nothing here runs at import time, and nothing falls back:
a failed build or launch raises.

``LAUNCHES`` counts kernel launches per name; only a launch increments it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import itertools
import os
import shutil
import subprocess
import time

import torch

NAMES = ("trace_step", "spawn", "shade", "retire", "megakernel", "adjoint")
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "torch_ext")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {n: 0 for n in NAMES}
BUILD_LOG: dict = {}
_LIBS: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class WaveArgs(ctypes.Structure):
    """ctypes mirror of ``struct WaveArgs`` in ``csrc/common.cuh``."""

    _fields_ = (
        [(n, _P) for n in (
            "origin", "direction", "time", "color", "throughput", "depth",
            "iters", "alive", "cur", "stack", "sp", "best_t", "best_pt",
            "best_pi", "phase", "hit_found", "hit_pt", "hit_pi", "hit_t",
            "pixel", "sample", "last", "occupied", "flag",
            "accum", "pix_paths", "depth_hist", "ctr",
            "nodes", "prims", "prim_tab", "mat_tab", "med_tab", "tex_tab",
            "img_data", "img_hw", "perlin_vec", "perlin_perm", "u5_out")]
        + [("items_total", ctypes.c_longlong)]
        + [(n, _I) for n in (
            "R", "sd", "steps", "ctrl_den", "root", "n_prims", "n_sph", "n_qd",
            "n_prim_rows", "n_mat", "n_med", "n_tex", "n_img", "img_h", "img_w",
            "prim_mask", "has_medium", "has_noise", "has_image",
            "has_noise_emission", "has_noise_medium", "has_image_emission",
            "has_image_medium", "width", "max_depth", "iters_cap",
            "rr_min_depth", "use_rr", "sss_steps", "npix", "stride", "multi",
            "start_sample", "n_samples")]
        + [("key0", ctypes.c_uint), ("key1", ctypes.c_uint)]
        + [(n, _F) for n in ("rr_max_prob", "t_min", "t_max")]
        + [(n, _F * 3) for n in ("cam_origin", "pixel00", "du", "dv",
                                 "defocus_u", "defocus_v")]
        + [("defocus_angle", _F), ("bg_color", _F * 3), ("bg_type", _I)]
        + [(n, _P) for n in ("delta", "g_tex", "g_img")])


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(_CSRC)):
        if f.endswith((".cu", ".cuh", ".cpp")):
            with open(os.path.join(_CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(verbose: bool = False) -> dict:
    """Compile every kernel (one nvcc per source, in parallel) and load them.

    Returns ``{name: seconds}`` of the compile wall time (0 when cached).
    """
    if len(_LIBS) == len(NAMES):
        return {n: 0.0 for n in NAMES}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _source_hash()
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in NAMES:
        so = os.path.join(BUILD_DIR, f"{n}-{tag}.so")
        if os.path.exists(so):
            continue
        cmd = [nvcc, *NVCC_FLAGS, "-o", so + ".tmp", os.path.join(_CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), so)
    secs = {n: 0.0 for n in NAMES}
    for n, (p, so) in procs.items():
        out, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        BUILD_LOG[n] = out
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{out}")
        os.replace(so + ".tmp", so)
        if verbose:
            print(out)
    for n in NAMES:
        lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"{n}-{tag}.so"))
        check_layout(lib)
        fn = getattr(lib, f"ptt_launch_{n}")
        fn.argtypes = [ctypes.POINTER(WaveArgs), _P]
        fn.restype = _I
        _LIBS[n] = (lib, fn)
    return secs


def check_layout(lib, mirror=WaveArgs) -> None:
    """Raise unless ``mirror`` matches the library's ``struct WaveArgs``.

    The library exports each field's name and ``offsetof`` in declaration
    order; every ctypes field must have the same name at the same offset,
    and the sizes must agree, so two swapped fields of one type are caught.
    """
    n = lib.ptt_wave_args_layout(None, None)
    names = (ctypes.c_char_p * n)()
    offsets = (ctypes.c_longlong * n)()
    lib.ptt_wave_args_layout(names, offsets)
    c_layout = [(nm.decode(), off) for nm, off in zip(names, offsets)]
    py_layout = [(f, getattr(mirror, f).offset) for f, _t in mirror._fields_]
    for c, p in itertools.zip_longest(c_layout, py_layout):
        if c != p:
            raise RuntimeError(f"WaveArgs layout mismatch: C (name, offset) "
                               f"{c}, ctypes {p}")
    size = lib.ptt_wave_args_size()
    if size != ctypes.sizeof(mirror):
        raise RuntimeError(f"WaveArgs layout mismatch: C {size} bytes, "
                           f"ctypes {ctypes.sizeof(mirror)}")


def _ptr(t: torch.Tensor | None) -> int | None:
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()


def set_grad_buffers(a: WaveArgs, delta, g_tex, g_img) -> None:
    """Point K6's fields of an argument block at delta and the gradient
    buffers (``csrc/common.cuh``), keeping the tensors alive with it."""
    a.delta, a.g_tex, a.g_img = _ptr(delta), _ptr(g_tex), _ptr(g_img)
    a._keep_grad = (delta, g_tex, g_img)


def make_args(eng, ws, u5_out: torch.Tensor | None = None) -> WaveArgs:
    """Fill the argument block for (engine, state); checks devices."""
    dev = ws.ctr.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors")
    for t in (*(getattr(ws, f.name) for f in dataclasses.fields(ws)),
              eng.bvh.nodes, eng.tabs.prim):
        if t.device != dev:
            raise ValueError("engine tables and state are on different devices")
    if eng.bvh.branching != 4:
        raise ValueError("the CUDA traversal kernel takes BVH4 rows")
    return fill_args(eng, ws, u5_out)


def fill_args(eng, ws, u5_out: torch.Tensor | None = None) -> WaveArgs:
    """The argument block from tensor pointers, without device checks."""
    a = WaveArgs()
    for f in dataclasses.fields(ws):
        setattr(a, f.name, _ptr(getattr(ws, f.name)))
    sc, tabs, cfg, cam, fl = eng.scene, eng.tabs, eng.cfg, eng.cam, eng.flags
    a.nodes = _ptr(eng.bvh.nodes)
    a.prims = _ptr(eng.bvh.prims)
    a.prim_tab, a.mat_tab = _ptr(tabs.prim), _ptr(tabs.mat)
    a.med_tab, a.tex_tab = _ptr(tabs.med), _ptr(tabs.tex)
    a.img_data = _ptr(sc.img_data)
    a.img_hw = _ptr(sc.img_hw)
    a.perlin_vec = _ptr(sc.perlin_vec)
    a.perlin_perm = _ptr(sc.perlin_perm)
    a.u5_out = _ptr(u5_out)
    a.items_total = eng.items_total
    a.R, a.sd, a.steps, a.ctrl_den = eng.R, eng.sd, eng.steps, eng.ctrl_den
    a.root = eng.root
    a.n_prims = eng.bvh.prims.shape[0]
    a.n_sph, a.n_qd = tabs.n_sph, tabs.n_qd
    a.n_prim_rows = tabs.prim.shape[0]
    a.n_mat, a.n_med, a.n_tex = (tabs.mat.shape[0], tabs.med.shape[0],
                                 tabs.tex.shape[0])
    a.n_img, a.img_h, a.img_w = (sc.img_data.shape[0], sc.img_data.shape[1],
                                 sc.img_data.shape[2])
    pm = eng.bvh.prim_mask
    a.prim_mask = int(pm[0]) | (int(pm[1]) << 1) | (int(pm[2]) << 2)
    for f in ("has_medium", "has_noise", "has_image", "has_noise_emission",
              "has_noise_medium", "has_image_emission", "has_image_medium"):
        setattr(a, f, int(getattr(fl, f)))
    a.width, a.max_depth, a.iters_cap = cfg.width, cfg.max_depth, cfg.iters
    a.rr_min_depth, a.use_rr = cfg.rr_min_depth, int(cfg.use_russian_roulette)
    a.sss_steps = cfg.sss_max_steps
    a.npix, a.stride, a.multi = eng.npix, eng.stride, int(eng.multi)
    a.start_sample, a.n_samples = eng.start_sample, eng.n_samples
    k = [int(x) for x in eng.key.cpu()]
    a.key0, a.key1 = k[0], k[1]
    a.rr_max_prob, a.t_min, a.t_max = cfg.rr_max_prob, cfg.t_min, cfg.t_max
    for f, v in (("cam_origin", cam.origin), ("pixel00", cam.pixel00),
                 ("du", cam.du), ("dv", cam.dv), ("defocus_u", cam.defocus_u),
                 ("defocus_v", cam.defocus_v), ("bg_color", cam.bg_color)):
        getattr(a, f)[:] = [float(x) for x in v.cpu()]
    a.defocus_angle = float(cam.defocus_angle)
    a.bg_type = int(cam.bg_type)
    a._keep = (ws, eng, u5_out)  # the pointers stay valid while a lives
    return a


def launch(name: str, eng, ws, args: WaveArgs | None = None) -> None:
    """Launch kernel ``name`` on PyTorch's current stream; count it."""
    if name not in _LIBS:
        build()
    if args is None:
        cache = getattr(ws, "_kernel_args", None)
        if cache is None or cache[0] is not eng:
            cache = (eng, make_args(eng, ws))
            ws._kernel_args = cache
        args = cache[1]
    stream = torch.cuda.current_stream(ws.ctr.device).cuda_stream
    err = _LIBS[name][1](ctypes.byref(args), _P(stream))
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {err}")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for n in NAMES:
        LAUNCHES[n] = 0


def host_emulation_lib():
    """``csrc/host_emulation.cpp`` built by the host C++ compiler and loaded
    (tests only; layout checked).  Raises if no compiler is found."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler for the kernel emulation")
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"host_emulation-{_source_hash()}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
                        "-shared", "-fPIC", "-o", tmp,
                        os.path.join(_CSRC, "host_emulation.cpp")],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    check_layout(lib)
    return lib


def host_emulation_ops():
    """The kernels' per-slot code compiled for the CPU (tests only).

    Returns ``(wave_ops, megakernel_op)``: four ops with the signature of
    the wave kernel wrappers (``op(engine, wave_state)``), in the order of
    :data:`~.wavefront.KERNELS`, and one with the signature of
    :func:`~.integrator.megakernel` (``op(engine, mega_state, sample)``),
    all running on CPU states.  :func:`host_emulation_adjoint` gives K6's.
    """
    lib = host_emulation_lib()

    def make(name):
        fn = getattr(lib, f"emu_{name}")
        fn.argtypes = [ctypes.POINTER(WaveArgs)]

        def op(eng, ws, sample=None):
            cache = getattr(ws, "_emu_args", None)
            if cache is None or cache[0] is not eng:
                cache = (eng, fill_args(eng, ws))
                ws._emu_args = cache
            if sample is not None:
                cache[1].start_sample = int(sample)
            fn(ctypes.byref(cache[1]))
        return op

    return (tuple(make(n) for n in ("trace_step", "shade", "retire", "spawn")),
            make("megakernel"))


def host_emulation_adjoint():
    """K6's per-pixel code compiled for the CPU (tests only): an op with the
    signature of :func:`~.adjoint.adjoint` (``op(engine, mega_state,
    sample, delta, g_tex, g_img)``) on CPU tensors."""
    fn = host_emulation_lib().emu_adjoint
    fn.argtypes = [ctypes.POINTER(WaveArgs)]

    def op(eng, ms, sample, delta, g_tex, g_img):
        a = fill_args(eng, ms)
        a.start_sample = int(sample)
        set_grad_buffers(a, delta, g_tex, g_img)
        fn(ctypes.byref(a))
    return op
