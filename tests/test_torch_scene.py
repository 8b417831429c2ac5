"""Host side of the port: scene compiler, camera, flags, BVH, imports.

Both packages build the same scenes from the same builders; every compiled
array, the camera bases, the scene flags and the packed BVH rows must be
equal (numpy builder on both sides, and the native builder on both sides
when ``native/libbvh.so`` loads).  The texture table is compared through
the rows each material and medium resolves to: the JAX compiler
deduplicates textures by the ``id()`` of a temporary, so its row count
depends on whether the allocator reuses a freed address (ROADMAP.md C); the
port's compiler keeps those textures alive and is deterministic.  The port
must not import JAX or the JAX package.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import path_tracer_tpu as pt
from path_tracer_tpu.ops import bvh_build as jbvh
from path_tracer_tpu.ops import bvh_native as jnative
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.ops import bvh_build as tbvh
from path_tracer_tpu_torch.ops import bvh_native as tnative
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = [
    ("cornell_box", {}), ("cornell_smoke", {}), ("vol2_sec5", {}),
    ("vol2_sec4_6", {}), ("wavefront_comparison", {}),
    ("vol2_final_scene", {"sphere_cluster": 50}),
]


def _pair(name, kw):
    jw, jc = getattr(pt.scenes, name)(**kw)
    tw, tc = getattr(ptt.scenes, name)(**kw)
    return pt.compile_scene(jw), ptt.compile_scene(tw, device="cpu"), jc, tc


TEX_FIELDS = ("tex_type", "tex_c1", "tex_c2", "tex_scale", "tex_img")


def _tex_rows(scene, idx):
    """(type, c1, c2, scale, img) rows of texture indices ``idx``."""
    cols = [np.asarray(getattr(scene, f)).reshape(len(np.asarray(scene.tex_type)), -1)
            for f in TEX_FIELDS]
    return np.concatenate([c[np.asarray(idx)].astype(np.float64) for c in cols], 1)


@pytest.mark.parametrize("name,kw", SCENES, ids=[s[0] for s in SCENES])
def test_compile_camera_flags_equal(name, kw):
    js, ts, jc, tc = _pair(name, kw)
    for f in ts.__dataclass_fields__:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        if f in TEX_FIELDS + ("mat_tex", "med_tex"):
            continue
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("mat_tex", "med_tex"):
        np.testing.assert_array_equal(
            _tex_rows(ts, getattr(ts, f).numpy()),
            _tex_rows(js, np.asarray(getattr(js, f))), err_msg=f)
    jca, tca = jc.initialize(), tc.initialize(device="cpu")
    for f in tca.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tca, f).numpy(),
                                      np.asarray(getattr(jca, f)), err_msg=f)
    assert TFlags.from_scene(ts).__dict__ == JFlags.from_scene(js).__dict__


def _jax_numpy_bvh(scene):
    scene_np = {k: np.asarray(getattr(scene, k)) for k in (
        "sph_valid", "sph_c0", "sph_c1", "sph_rad", "qd_valid", "qd_q",
        "qd_u", "qd_v", "tr_valid", "tr_v0", "tr_e1", "tr_e2")}
    flat = jbvh.build_bvh(*jbvh.primitive_aabbs(scene_np), use_native=False,
                          leaf_cap=4, leaf_ratio=jbvh.LEAF_RATIO)
    return jbvh.pack_bvh(scene, flat)


def _assert_bvh_equal(jb, tb):
    np.testing.assert_array_equal(tb.nodes.numpy(), np.asarray(jb.nodes))
    np.testing.assert_array_equal(tb.prims.numpy(), np.asarray(jb.prims))
    assert int(tb.root) == int(jb.root)
    assert tb.max_stack == jb.max_stack
    assert tuple(tb.prim_mask) == tuple(jb.prim_mask)


@pytest.mark.parametrize("name,kw", SCENES[:3] + SCENES[5:],
                         ids=[s[0] for s in SCENES[:3] + SCENES[5:]])
def test_bvh_numpy_builder_equal(name, kw):
    js, ts, _, _ = _pair(name, kw)
    _assert_bvh_equal(_jax_numpy_bvh(js),
                      ptt.build_from_scene(ts, use_native=False))


@pytest.mark.parametrize("name,budget", [("triangles", 0.6),
                                         ("mesh_perlin_sss", 0.25),
                                         ("mesh_perlin_sss", 0.6)])
def test_presplit_refs_equal(name, budget):
    """``presplit_refs`` (SBVH pre-splitting, off by default) gives the JAX
    package's split references, and the BVH built from them is the same."""
    js, ts, _, _ = _pair(name, {})
    keys = ("sph_valid", "sph_c0", "sph_c1", "sph_rad", "qd_valid", "qd_q",
            "qd_u", "qd_v", "tr_valid", "tr_v0", "tr_e1", "tr_e2")
    j_refs = jbvh.primitive_aabbs({k: np.asarray(getattr(js, k)) for k in keys})
    t_refs = tbvh.primitive_aabbs({k: getattr(ts, k).numpy() for k in keys})
    j_split = jbvh.presplit_refs(*j_refs, budget_frac=budget)
    t_split = tbvh.presplit_refs(*t_refs, budget_frac=budget)
    assert len(t_split[0]) > len(t_refs[0])          # something was split
    for a, b in zip(t_split, j_split):
        np.testing.assert_array_equal(a, b)
    jb = jbvh.pack_bvh(js, jbvh.build_bvh(*j_split, use_native=False,
                                          leaf_cap=4,
                                          leaf_ratio=jbvh.LEAF_RATIO))
    tb = tbvh.pack_bvh(ts, tbvh.build_bvh(*t_split, use_native=False,
                                          leaf_cap=4,
                                          leaf_ratio=tbvh.LEAF_RATIO))
    _assert_bvh_equal(jb, tb)


@pytest.mark.parametrize("name,kw", SCENES[:1] + SCENES[5:],
                         ids=[s[0] for s in SCENES[:1] + SCENES[5:]])
def test_bvh_native_builder_equal(name, kw):
    if not (jnative.available() and tnative.available()):
        pytest.skip("native BVH builder not loadable here")
    js, ts, _, _ = _pair(name, kw)
    _assert_bvh_equal(pt.build_from_scene(js), ptt.build_from_scene(ts))


def test_native_library_is_not_rewritten():
    so = os.path.join(REPO, "native", "libbvh.so")
    before = os.stat(so).st_mtime_ns if os.path.exists(so) else None
    tnative.available()
    after = os.stat(so).st_mtime_ns if os.path.exists(so) else None
    assert before == after


def test_entry_points_default_to_cuda():
    import inspect
    for fn in (ptt.compile_scene, ptt.Camera.initialize, ptt.Renderer.__init__,
               ptt.render_scene):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_import_loads_no_jax():
    code = ("import sys, path_tracer_tpu_torch, path_tracer_tpu_torch.interop;"
            "import path_tracer_tpu_torch.ops.wavefront, path_tracer_tpu_torch.ops.kernels;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('jaxlib') or m == 'path_tracer_tpu'"
            " or m.startswith('path_tracer_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_source_scan_finds_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|path_tracer_tpu)\b(?!_torch)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "path_tracer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    hits = [f for f in files if pat.search(open(f).read())]
    assert not hits, hits


def test_port_texture_table_is_deterministic():
    """Repeated compiles give the same texture table (no id() reuse)."""
    tables = []
    for _ in range(6):
        world, _cam = ptt.scenes.vol2_final_scene(sphere_cluster=50)
        s = ptt.compile_scene(world, device="cpu")
        tables.append((s.tex_type.tolist(), s.mat_tex.tolist(),
                       s.med_tex.tolist()))
    assert all(t == tables[0] for t in tables)
