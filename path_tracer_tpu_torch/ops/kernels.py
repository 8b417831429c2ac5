"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each kernel source (``trace_step.cu``, ``spawn.cu``, ``shade.cu``,
``retire.cu``, ``megakernel.cu``, ``adjoint.cu``, ``closest_hit.cu``,
``tiled_trip.cu``, ``wave_loop.cu``, ``gather.cu``) is compiled by its own
``nvcc`` for ``sm_90a``, all ten started together, into a shared library
with a plain C interface under the git-ignored ``build/torch_ext/`` (file
names carry a hash of the sources,
so an edit rebuilds).  Three sources hold more than one kernel, each kernel
with its own launcher: ``adjoint.cu`` K6's colour and full instantiations
(``adjoint``, ``adjoint_full``), ``closest_hit.cu`` K7 and K9
(``closest_hit``, ``ring_hop``), ``tiled_trip.cu`` K8, its variant that
shades an injected hit record and the tiled engine's spawn (``tiled_trip``,
``tiled_trip_rec``, ``tiled_spawn``).  Those launchers take the argument
block ``WaveArgs``, as does ``wave_loop.cu``'s reset of the wave state
(``wave_reset``); the rest of ``wave_loop.cu`` (the device wave loop,
:class:`.wavefront.WaveLoop`) and ``gather.cu`` (the row gather,
:mod:`.gather`) have C interfaces of their own.  The libraries are opened
with ``ctypes``; device pointers come from ``tensor.data_ptr()`` and the
stream from PyTorch's current stream.  Nothing here runs at import time,
and nothing falls back: a failed build or launch raises.

The walking kernels (K1, K5, K6, K7, K9) take BVH4 and BVH8 rows: each is a
template on the node width, and its launcher picks the instantiation from
``WaveArgs.branching``.  K5, K6, K7 and K9 keep the walk's stack (and K6 its
tape and SSS walk record) in per-thread local arrays up to
:data:`MEGA_STACK` (:data:`.adjoint.TAPE_MAX`, :data:`.adjoint.WALK_MAX`)
entries; beyond them the launcher picks an instantiation that keeps them
in per-lane buffers which the wrapper allocates (:func:`set_stack`,
:func:`.adjoint.adjoint`), so no size the JAX package runs is refused.

``LAUNCHES`` counts kernel launches per name; only a launch increments it.
``INSTANCES`` counts the launches of the walking kernels per instantiation
(:func:`instance`).  A launch captured into a CUDA graph counts when the
graph runs it (:func:`captured_launches`, :func:`count`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import hashlib
import itertools
import os
import re
import shutil
import struct
import subprocess
import time

import torch

WAVE_SOURCES = ("trace_step", "spawn", "shade", "retire", "megakernel",
                "adjoint", "closest_hit", "tiled_trip")
SOURCES = WAVE_SOURCES + ("wave_loop", "gather")
SECOND = {"adjoint_full": "adjoint", "ring_hop": "closest_hit",
          "tiled_trip_rec": "tiled_trip", "tiled_spawn": "tiled_trip",
          "wave_reset": "wave_loop"}
NAMES = WAVE_SOURCES + tuple(SECOND)      # launchers taking WaveArgs
OWN_API = {"wave_loop": "wave_loop", "gather_rows": "gather"}
SOURCE_OF = {n: n for n in WAVE_SOURCES} | SECOND | OWN_API
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "torch_ext")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]

# Per-thread stack entries the walking kernels keep in local memory
# (PTT_MEGA_STACK, csrc/common.cuh); a deeper stack lives in a per-lane buffer.
MEGA_STACK = 64
BRANCHINGS = (4, 8)   # node widths the kernels take (bvh_build.pack_bvh)

LAUNCHES = {n: 0 for n in NAMES + tuple(OWN_API)}
INSTANCES: collections.Counter = collections.Counter()
BUILD_LOG: dict = {}
_LIBS: dict = {}
_TALLY: collections.Counter | None = None   # launches of a graph capture

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
            "R", "sd", "branching", "steps", "chunk", "exit_den", "ctrl_den",
            "root", "n_prims", "n_sph", "n_qd", "n_prim_rows", "n_mat", "n_med",
            "n_tex", "n_img", "img_h", "img_w",
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
        + [(n, _P) for n in ("delta", "g_tex", "g_img", "g_prim", "g_mat",
                             "g_med", "g_perlin", "q_tmin", "q_active",
                             "exit_found", "exit_pt", "exit_pi", "exit_t",
                             "exit_med", "rec")]
        + [("pix_offset", _I), ("sample_dev", _P), ("tape", _P),
           ("walk", _P), ("gate_pt", _P), ("gate_pi", _P),
           ("h_while", ctypes.c_ulonglong),
           ("max_waves", ctypes.c_longlong), ("loop_graph", _I),
           ("live", _P), ("live_n", _P), ("live_parity", _I),
           ("frame_dev", _P), ("spawn_order", _P)])


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

    Returns ``{source: seconds}`` of the compile wall time (0 when cached).
    """
    if len(_LIBS) == len(SOURCE_OF):
        return {n: 0.0 for n in SOURCES}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _source_hash()
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in SOURCES:
        so = os.path.join(BUILD_DIR, f"{n}-{tag}.so")
        if os.path.exists(so):
            continue
        cmd = [nvcc, *NVCC_FLAGS, "-o", so + ".tmp", os.path.join(_CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), so)
    secs = {n: 0.0 for n in SOURCES}
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
        lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"{SOURCE_OF[n]}-{tag}.so"))
        check_layout(lib)
        fn = getattr(lib, f"ptt_launch_{n}")
        fn.argtypes = [ctypes.POINTER(WaveArgs), _P]
        fn.restype = _I
        _LIBS[n] = (lib, fn)
    for n, src in OWN_API.items():
        _LIBS[n] = (ctypes.CDLL(os.path.join(BUILD_DIR, f"{src}-{tag}.so")),
                    None)
    return secs


def library_path(source: str) -> str:
    """The built library of ``source`` (e.g. ``"trace_step"``)."""
    return os.path.join(BUILD_DIR, f"{source}-{_source_hash()}.so")


def _sass(so: str, count) -> dict:
    """``{kernel: Counter}`` over the kernels of the library ``so``, from
    ``cuobjdump -sass``: ``count(text)`` gives the key an instruction line
    adds to, or None."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    tally: dict = {}
    fn = None
    for line in out.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            fn = text.split(":", 1)[1].strip()
            tally[fn] = collections.Counter()
            continue
        key = count(text) if fn is not None else None
        if key is not None:
            tally[fn][key] += 1
    return {f: dict(c) for f, c in tally.items()}


def _load_bits(text: str):
    m = re.search(r"\bLDG(?:\.[A-Z0-9]+)*\b", text)
    if m is None:
        return None
    parts = set(m.group(0).split(".")[1:])
    return (128 if "128" in parts else 64 if "64" in parts
            else 16 if {"U16", "S16"} & parts
            else 8 if {"U8", "S8"} & parts else 32)


def sass_global_loads(so: str) -> dict:
    """Global loads by width in the kernels of the library ``so``, from
    ``cuobjdump -sass``: ``{kernel: {bits: n}}`` with bits 8, 16, 32, 64
    or 128 per ``LDG`` instruction."""
    return _sass(so, _load_bits)


def _opcode(text: str):
    m = re.match(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_]*)",
                 text)
    return None if m is None else m.group(1)


def sass_opcodes(so: str) -> dict:
    """Instructions by opcode in the kernels of the library ``so``:
    ``{kernel: {opcode: n}}`` (the static count; in straight-line code,
    the count a thread issues)."""
    return _sass(so, _opcode)


# SASS opcodes by the pipe class they issue on (sass_classes).
_SASS_CLASSES = (
    ("integer", ("IADD", "IMAD", "IMUL", "ISETP", "IABS", "IMNMX", "LOP",
                 "SHF", "SHL", "SHR", "SEL", "LEA", "PRMT", "FLO", "POPC",
                 "BMSK", "BREV", "I2F", "F2I")),
    ("fp32", ("F", "MUFU")),
    ("memory", ("LD", "ST", "ATOM", "RED")),
    ("control", ("BRA", "EXIT", "BAR", "BSYNC", "BSSY", "RET", "CALL",
                 "WARPSYNC", "NOP")))


def sass_classes(mix: dict) -> dict:
    """A kernel's opcodes (:func:`sass_opcodes`) summed by class: integer
    (add, multiply-add, logic, shift, compare, select, lea, prmt), fp32 (F*
    and MUFU), memory, control and other."""
    out = dict.fromkeys([c for c, _ in _SASS_CLASSES] + ["other"], 0)
    for op, n in mix.items():
        cls = next((c for c, pre in _SASS_CLASSES if op.startswith(pre)),
                   "other")
        out[cls] += n
    return out


def library(name: str):
    """The built library of kernel ``name`` (builds on first use)."""
    if name not in _LIBS:
        build()
    return _LIBS[name][0]


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


# The frame's fields that the tiled kernels read from card memory where
# frame_dev is set (WaveArgs.frame_dev, csrc/common.cuh): the base key and
# the camera.
FRAME_FIELDS = ("key0", "key1", "cam_origin", "pixel00", "du", "dv",
                "defocus_u", "defocus_v", "defocus_angle")


def frame_words(a: WaveArgs) -> torch.Tensor:
    """``a``'s :data:`FRAME_FIELDS` as the (21,) int32 words that
    ``frame_dev`` points at: the two key words, then the floats' bits."""
    cam = [x for f in FRAME_FIELDS[2:-1] for x in getattr(a, f)]
    raw = struct.pack("<2I19f", a.key0, a.key1, *cam, a.defocus_angle)
    return torch.tensor(struct.unpack("<21i", raw), dtype=torch.int32)


def value_fields(a: WaveArgs, skip=("R", "start_sample", "live_parity")
                 + FRAME_FIELDS) -> tuple:
    """The by-value fields of an argument block (every field but the
    pointers, the per-launch ``skip`` and the frame's key and camera) as a
    hashable tuple."""
    out = []
    for f, t in WaveArgs._fields_:
        if t is _P or f in skip:
            continue
        v = getattr(a, f)
        out.append((f, tuple(v) if isinstance(v, ctypes.Array) else v))
    return tuple(out)


def _ptr(t: torch.Tensor | None) -> int | None:
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()


def set_grad_buffers(a: WaveArgs, delta, bufs) -> None:
    """Point K6's fields of an argument block at delta and the gradient
    buffers ``bufs`` (:class:`~.adjoint.GradBuffers`, ``csrc/common.cuh``),
    keeping the tensors alive with it."""
    a.delta = _ptr(delta)
    for f, t in zip(bufs._fields, bufs):
        setattr(a, f"g_{f}", _ptr(t))
    a._keep_grad = (delta, bufs)


def make_args(eng, ws, u5_out: torch.Tensor | None = None) -> WaveArgs:
    """Fill the argument block for (engine, state); checks devices."""
    dev = ws.ctr.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors")
    order = getattr(eng, "spawn_order", None)
    for t in (*(getattr(ws, f.name) for f in dataclasses.fields(ws)),
              eng.bvh.nodes, eng.tabs.prim,
              *(() if order is None else (order,))):
        if t.device != dev:
            raise ValueError("engine tables and state are on different devices")
    return fill_args(eng, ws, u5_out)


def _fill_bvh(a: WaveArgs, bvh, sd: int, root: int) -> None:
    if bvh.branching not in BRANCHINGS:
        raise ValueError(f"the CUDA traversal takes node widths {BRANCHINGS}, "
                         f"not {bvh.branching}")
    if bvh.nodes.data_ptr() % 16:
        raise ValueError("the node table must start on a 16-byte boundary: "
                         "K1 reads its rows in 16-byte loads")
    a.branching = bvh.branching
    a.nodes = _ptr(bvh.nodes)
    a.prims = _ptr(bvh.prims)
    a.n_prims = bvh.prims.shape[0]
    a.sd, a.root = sd, root
    pm = bvh.prim_mask
    a.prim_mask = int(pm[0]) | (int(pm[1]) << 1) | (int(pm[2]) << 2)


def fill_args(eng, ws=None, u5_out: torch.Tensor | None = None) -> WaveArgs:
    """The argument block from tensor pointers, without device checks; the
    per-slot fields from ``ws`` when given."""
    a = WaveArgs()
    if ws is not None:
        for f in dataclasses.fields(ws):
            setattr(a, f.name, _ptr(getattr(ws, f.name)))
    sc, tabs, cfg, cam, fl = eng.scene, eng.tabs, eng.cfg, eng.cam, eng.flags
    _fill_bvh(a, eng.bvh, eng.sd, eng.root)
    a.prim_tab, a.mat_tab = _ptr(tabs.prim), _ptr(tabs.mat)
    a.med_tab, a.tex_tab = _ptr(tabs.med), _ptr(tabs.tex)
    a.img_data = _ptr(sc.img_data)
    a.img_hw = _ptr(sc.img_hw)
    a.perlin_vec = _ptr(sc.perlin_vec)
    a.perlin_perm = _ptr(sc.perlin_perm)
    a.u5_out = _ptr(u5_out)
    a.spawn_order = _ptr(getattr(eng, "spawn_order", None))
    a.items_total = eng.items_total
    a.R, a.steps, a.ctrl_den = eng.R, eng.steps, eng.ctrl_den
    from .traverse import ADAPTIVE_EXIT_DEN, wave_chunk
    a.chunk = wave_chunk(eng.steps, eng.chunk) if eng.steps > 0 else 1
    a.exit_den = ADAPTIVE_EXIT_DEN
    a.n_sph, a.n_qd = tabs.n_sph, tabs.n_qd
    a.n_prim_rows = tabs.prim.shape[0]
    a.n_mat, a.n_med, a.n_tex = (tabs.mat.shape[0], tabs.med.shape[0],
                                 tabs.tex.shape[0])
    a.n_img, a.img_h, a.img_w = (sc.img_data.shape[0], sc.img_data.shape[1],
                                 sc.img_data.shape[2])
    for f in ("has_medium", "has_noise", "has_image", "has_noise_emission",
              "has_noise_medium", "has_image_emission", "has_image_medium"):
        setattr(a, f, int(getattr(fl, f)))
    a.width, a.max_depth, a.iters_cap = cfg.width, cfg.max_depth, cfg.iters
    a.rr_min_depth, a.use_rr = cfg.rr_min_depth, int(cfg.use_russian_roulette)
    a.sss_steps = cfg.sss_max_steps
    a.npix, a.stride, a.multi = eng.npix, eng.stride, int(eng.multi)
    a.pix_offset = eng.pix_offset
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


# Per-lane fields of the lane kernels K7-K9 (closest_hit, ring_hop,
# tiled_trip): (dtype, trailing shape); ctr is the counter vector.
LANE_FIELDS = {
    "origin": (torch.float32, (3,)), "direction": (torch.float32, (3,)),
    "time": (torch.float32, ()), "color": (torch.float32, (3,)),
    "throughput": (torch.float32, (3,)), "depth": (torch.int32, ()),
    "iters": (torch.int32, ()), "alive": (torch.bool, ()),
    "pixel": (torch.int32, ()), "hit_found": (torch.bool, ()),
    "hit_pt": (torch.int32, ()), "hit_pi": (torch.int32, ()),
    "hit_t": (torch.float32, ()), "q_tmin": (torch.float32, ()),
    "q_active": (torch.bool, ()), "exit_found": (torch.bool, ()),
    "exit_pt": (torch.int32, ()), "exit_pi": (torch.int32, ()),
    "exit_t": (torch.float32, ()), "exit_med": (torch.bool, ()),
    "rec": (torch.float32, (12,)),
}


def set_lanes(a: WaveArgs, n: int, device, ctr: torch.Tensor,
              **lanes) -> WaveArgs:
    """Point the per-lane fields of ``a`` at ``lanes`` (every other lane
    field null) for ``n`` lanes and the counters ``ctr``, keeping the tensors
    alive with ``a``; raises unless each tensor is contiguous, on ``device``,
    of its field's dtype and shape."""
    a._keep_lanes = (dict(lanes), ctr)
    for f, (dtype, tail) in LANE_FIELDS.items():
        t = lanes.pop(f, None)
        if t is not None and (t.device != device or t.dtype != dtype
                              or tuple(t.shape) != (n, *tail)):
            raise ValueError(f"lane field {f} must be {dtype} {(n, *tail)} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        setattr(a, f, _ptr(t))
    if lanes:
        raise ValueError(f"not a lane field: {sorted(lanes)}")
    if ctr.device != device or ctr.dtype != torch.int64:
        raise ValueError(f"ctr must be int64 on {device}")
    a.ctr = _ptr(ctr)
    a.R = n
    return a


def set_stack(a: WaveArgs, n: int, device) -> WaveArgs:
    """Give the walk of ``n`` lanes its stack: null where ``a.sd`` entries
    fit the kernels' local array (:data:`MEGA_STACK`), else a fresh ``(n,
    sd)`` int32 buffer on ``device``, kept alive with ``a``."""
    buf = None
    if a.sd > MEGA_STACK:
        buf = torch.empty((n, a.sd), dtype=torch.int32, device=device)
    a.stack = _ptr(buf)
    a._keep_stack = buf
    return a


def set_gate(a: WaveArgs, n: int, device, tabs=None, pt=None,
             pi=None) -> WaveArgs:
    """K7's volume-exit gate: the main query's hit ``(pt, pi)`` of ``n``
    lanes (int32 on ``device``) and the shade tables ``tabs`` whose rows
    give its medium, kept alive with ``a``; without them, no gate."""
    if tabs is None:
        a.gate_pt = a.gate_pi = None
        a._keep_gate = None
        return a
    for t in (pt, pi):
        if t.device != device or t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"the gate's hit must be int32 ({n},) on "
                             f"{device}")
    a.gate_pt, a.gate_pi = _ptr(pt), _ptr(pi)
    a.prim_tab = _ptr(tabs.prim)
    a.n_sph, a.n_qd = tabs.n_sph, tabs.n_qd
    a.n_prim_rows = tabs.prim.shape[0]
    a._keep_gate = (pt, pi, tabs)
    return a


def query_args(bvh, t_max: float, sd: int) -> WaveArgs:
    """K7's argument block for a BVH alone (K7 reads no other table),
    cached on the BVH."""
    cache = bvh.__dict__.setdefault("_query_args", {})
    key = (float(t_max), int(sd))
    if key not in cache:
        a = WaveArgs()
        _fill_bvh(a, bvh, int(sd), int(bvh.root))
        a.t_max = float(t_max)
        a._keep = bvh
        cache[key] = a
    return cache[key]


def launch(name: str, eng, ws, args: WaveArgs | None = None) -> None:
    """Launch kernel ``name`` on PyTorch's current stream; count it."""
    if args is None:
        cache = getattr(ws, "_kernel_args", None)
        if cache is None or cache[0] is not eng:
            cache = (eng, make_args(eng, ws))
            ws._kernel_args = cache
        args = cache[1]
    launch_args(name, args, ws.ctr.device)


def launch_args(name: str, args: WaveArgs, device, stream=None) -> None:
    """Launch kernel ``name`` with a filled argument block on ``stream`` (a
    raw CUDA stream handle; default ``device``'s current stream); count it."""
    if name not in _LIBS:
        build()
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    err = _LIBS[name][1](ctypes.byref(args), _P(stream))
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {err}")
    inst = instance(name, args)
    count({name: 1, **({inst: 1} if inst else {})})


def resident_lanes(device, branching: int) -> int | None:
    """The slots K1 keeps resident on the card at node width ``branching``
    (``ptt_trace_step_resident_lanes``: the blocks of its instantiation the
    card holds at once, times 128 threads; asked of the card once per
    width), or None on a ``device`` that is not a card (the CPU twins, the
    g++ build)."""
    if torch.device(device).type != "cuda":
        return None
    n = library("trace_step").ptt_trace_step_resident_lanes(int(branching))
    if n <= 0:
        raise RuntimeError(f"K1's resident lanes at K = {branching}: CUDA "
                           f"error {-n}")
    return n


def instance(name: str, a: WaveArgs) -> str | None:
    """The instantiation of walking kernel ``name`` that its launcher picks
    for ``a`` (``<name>_k<K>``, ``_global`` where its per-thread arrays live
    in per-lane buffers), None for a kernel that does not walk."""
    if name == "trace_step":
        glob = False
    elif name in ("megakernel", "closest_hit", "ring_hop"):
        glob = a.sd > MEGA_STACK
    elif name in ("adjoint", "adjoint_full"):
        from .adjoint import per_pixel_buffers
        glob = per_pixel_buffers(a.sd, a.iters_cap, a.sss_steps,
                                 name == "adjoint_full")
    else:
        return None
    return f"{name}_k{a.branching}" + ("_global" if glob else "")


def count(launches, times: int = 1) -> None:
    """Add ``launches`` ({name: n}, kernel or instantiation names) ``times``
    to :data:`LAUNCHES` and :data:`INSTANCES`, or to the tally of the
    capture in progress."""
    for n, k in launches.items():
        if _TALLY is not None:
            _TALLY[n] += k * times
        elif n in LAUNCHES:
            LAUNCHES[n] += k * times
        else:
            INSTANCES[n] += k * times


@contextlib.contextmanager
def captured_launches():
    """Within the block, launches go to the returned tally instead of
    :data:`LAUNCHES`: a graph capture records kernels without running them,
    and whoever replays the graph counts the tally per replay."""
    global _TALLY
    saved, _TALLY = _TALLY, collections.Counter()
    try:
        yield _TALLY
    finally:
        _TALLY = saved


def reset_launches() -> None:
    for n in LAUNCHES:
        LAUNCHES[n] = 0
    INSTANCES.clear()


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
        fn = _emu_fn(lib, name)

        def op(eng, ws, sample=None):
            cache = getattr(ws, "_emu_args", None)
            if cache is None or cache[0] is not eng:
                cache = (eng, fill_args(eng, ws))
                if name == "megakernel":
                    set_stack(cache[1], eng.npix, ws.ctr.device)
                ws._emu_args = cache
            if sample is not None:
                cache[1].start_sample = int(sample)
            fn(cache[1])
        return op

    return (tuple(make(n) for n in ("trace_step", "shade", "retire", "spawn")),
            make("megakernel"))


def host_emulation_lanes():
    """The lane code of K7, K9 and K8 compiled for the CPU (tests only):
    ``{name: op(args)}`` for ``closest_hit``, ``ring_hop``, ``tiled_trip``,
    ``tiled_trip_rec`` and ``tiled_spawn``, each taking an argument block filled as the
    kernel's wrapper fills it (CPU pointers)."""
    lib = host_emulation_lib()
    return {n: _emu_fn(lib, n) for n in ("closest_hit", "ring_hop",
                                         "tiled_trip", "tiled_trip_rec",
                                         "tiled_spawn")}


def host_emulation_walk_step():
    """One traversal step of every walking slot of a wave state, built for
    the CPU (tests only): ``op(eng, ws, step)`` runs ``traverse.cuh``'s
    ``trav_step`` (``step`` 0, the reference) or ``trav_step16`` (1: its
    child loop rolled, K5's and K6's; 2: unrolled, K7's and K9's) on the
    state in place,
    each slot's stack a row of ``ws.stack`` of ``eng.sd`` entries, steps
    and dropped pushes into ``ws.ctr``."""
    lib = host_emulation_lib()
    fn = lib.emu_walk_step
    fn.argtypes = [ctypes.POINTER(WaveArgs), _I]
    fn.restype = _I

    def op(eng, ws, step: int) -> None:
        if fn(ctypes.byref(fill_args(eng, ws)), int(step)) != 0:
            raise RuntimeError("the emulated walk step refused its arguments")
    return op


def _emu_fn(lib, name: str):
    """``emu_<name>`` of the emulation library as ``f(args)``; raises where
    the kernel's launcher would refuse the arguments."""
    fn = getattr(lib, f"emu_{name}")
    fn.argtypes = [ctypes.POINTER(WaveArgs)]
    fn.restype = _I

    def call(a: WaveArgs) -> None:
        if fn(ctypes.byref(a)) != 0:
            raise RuntimeError(f"the emulated {name} refused its arguments")
    return call


def host_emulation_adjoint(full: bool = False, budget: int | None = None):
    """K6's lane code compiled for the CPU (tests only), the colour or the
    ``full`` instantiation: an op with the signature of
    :func:`~.adjoint.adjoint` (``op(engine, mega_state, sample, delta,
    bufs)``) on CPU tensors, run as the wrapper runs the kernel (per-pixel
    buffers and pixel blocks within ``budget`` bytes).  A launch's pixels
    go through a simulated warp of lanes that take them from a counter as
    the kernel's lanes do, one unit of work a turn, so they finish out of
    order."""
    from .adjoint import run_adjoint
    lib = host_emulation_lib()
    fn = _emu_fn(lib, "adjoint_full" if full else "adjoint")
    entry = lib.ptt_adjoint_entry_bytes(int(full))

    def op(eng, ms, sample, delta, bufs):
        a = fill_args(eng, ms)
        a.start_sample = int(sample)
        set_grad_buffers(a, delta, bufs)
        run_adjoint(eng, a, delta, full, fn, entry,
                    budget if budget is not None else 1 << 30)
    return op
