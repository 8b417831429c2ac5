"""The harness's arithmetic, registry and guards (no card, no program run)."""
import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT

import roofline
import run
from harness import registry, stats, trace


def test_rate_is_all_work_over_all_time():
    assert stats.rate(3_840_000 * 10, 0.5) == pytest.approx(76_800_000)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("n", [1, 2, 7, 20, 401])
def test_percentile_matches_numpy_over_every_value(n):
    v = list(np.random.default_rng(n).gamma(2.0, 10.0, size=n))
    assert stats.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert stats.percentile(v, 50) == pytest.approx(np.median(v))


def test_p95_counts_the_slow_tail():
    v = [0.030] * 95 + [0.300] * 5
    assert stats.percentile(v, 95) > 0.030
    assert stats.percentile(v, 94) == pytest.approx(0.030)


def test_end_to_end_metrics_over_a_record():
    from harness import endtoend
    from harness.drivers import Record
    rec = Record(setup_s=9.5, setup={}, window_s=2.0,
                 unit_s=[0.02] * 99 + [0.1], units=100, work=8e8,
                 counters={}, memory_peak_bytes=0)
    assert endtoend.msamples_per_s(rec) == pytest.approx(400.0)
    assert endtoend.batch_ms_p95(rec) == pytest.approx(
        1e3 * np.percentile(rec.unit_s, 95))
    assert endtoend.setup_s(rec) == 9.5


def test_roofline_bound_stays_below_a_measured_frame():
    # The ladder's config 5 (PERF.md, PR 14): 800x600x256 pixel-samples,
    # 431.1M segments, rendered in 0.989 s of wall on the H100.
    px, segs = 800 * 600 * 256, 431_100_000
    kw = dict(read_bytes=40_000_000, frame_pixels=800 * 600)
    t = roofline.bound_s(px, segs, 0, **kw)
    assert 0 < t < 0.989
    share = roofline.share_pct(px, segs, 0, device_s=0.989, **kw)
    assert 0 < share < 100
    ops, byts = roofline.work(px, segs, 0, **kw)
    assert byts == 40_000_000 + 800 * 600 * 12
    assert t == pytest.approx(max(ops / 67e12, byts / 3.35e12))
    assert roofline.side(px, segs, 0, **kw) == "operations"
    assert roofline.side(1, 0, 0, read_bytes=10 ** 9) == "bytes"
    assert roofline.share_pct(px, segs, 0, device_s=0.0) is None


def test_roofline_counts_grow_with_each_kind_of_work():
    base = roofline.bound_s(1000, 1000, 0)
    assert roofline.bound_s(2000, 1000, 0) > base
    assert roofline.bound_s(1000, 2000, 0) > base
    assert roofline.bound_s(1000, 1000, 1000) > base
    assert roofline.bound_s(1000, 1000, 0, read_bytes=10 ** 9) > base


def test_roofline_counts_no_intermediate_state():
    """A frame's bytes do not grow with its segments or samples: path state
    and radiance sums between samples can stay in registers."""
    assert roofline.work(10, 0, 0, 100, 5)[1] == \
        roofline.work(10 ** 6, 10 ** 7, 10, 100, 5)[1] == 100 + 5 * 12


def test_scene_bytes_count_every_array():
    from harness import drivers
    from reference import scene as rscene
    b = registry.Bench()
    desc = drivers.scene_description(b, b.config("mesh_perlin_sss"))
    sc = rscene.compile_desc(desc)
    n = roofline.tensor_bytes(sc)
    assert n >= sum(t.numel() * 4 for t in sc.test) + sc.shade.numel() * 4
    assert n > sc.img_data.numel() * 4


def test_union_and_idle_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (100, 110)]
    assert trace.union_s(iv) == 40
    host = [(0, 200, "outer"), (50, 90, "inner")]
    gaps = trace.idle_gaps(iv, host)
    assert gaps[0] == ["inner", 60 / 1e6]
    assert gaps[1] == ["outer", 10 / 1e6]


@pytest.mark.parametrize("key,name,hit", [
    ("void megakernel_kernel<4, false>(WaveArgs)", "megakernel", True),
    ("_Z17megakernel_kernelILi4ELb0EEv8WaveArgs", "megakernel", True),
    ("trace_step_kernel(WaveArgs)", "trace_step", True),
    ("void at::native::index_add_kernel(...)", "shade", False),
    ("adjoint_full_kernel<4>(WaveArgs)", "adjoint", False),
])
def test_kernel_names(key, name, hit):
    assert trace.is_kernel(key, name) is hit


def test_the_result_line_stays_strict_json():
    out = run.finite({"checks": {"gap": {"value": float("inf"), "limit": 5e-3}},
                      "v": [float("nan"), 1.5]})
    line = json.dumps(out, allow_nan=False)
    assert json.loads(line) == {"checks": {"gap": {"value": "inf",
                                                   "limit": 5e-3}},
                                "v": ["nan", 1.5]}


def test_forbidden_names_are_compared_whole(monkeypatch):
    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "path_tracer_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlibs.probe", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    monkeypatch.setitem(sys.modules, "path_tracer_tpu", sys)
    assert run.forbidden_modules() == ["jaxlib", "path_tracer_tpu"]


def test_benchmark_json_names_files_that_exist():
    b = registry.Bench()
    for c in b.spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b.spec["workloads"]:
        b.config(w["config"])
        b.traffic(w["traffic"])
        assert "frame_l1_gap" in b.limits(w["name"])
        for m in b.per_layer(w["name"]):
            assert hasattr(b.reader(m["name"]), "read")
        assert {m["name"] for m in b.end_to_end(w["name"])} >= {"setup_s"}


def test_each_cell_reports_what_its_per_layer_metrics_move():
    b = registry.Bench()
    for w in b.spec["workloads"]:
        e2e = {m["name"] for m in b.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert {m["moves"] for m in b.per_layer(w["name"])} <= e2e
    assert "batch_ms_p95" not in {
        m["name"] for m in b.end_to_end("mesh_perlin_sss.wavefront")}
    assert "batch_ms_p95" in {
        m["name"] for m in b.end_to_end("vol2_final.wavefront")}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ["__init__.py", "rng.py", "scene.py",
                                  "tracer.py"])
def test_reference_imports_nothing_of_the_program(name):
    mods = set(_imports(os.path.join(BENCH, "reference", name)))
    assert not mods & {"path_tracer_tpu_torch", "path_tracer_tpu", "jax",
                       "jaxlib", "harness"}


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r);"
            "import reference.tracer, reference.scene;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"path_tracer_tpu_torch", "path_tracer_tpu", "jax",
                         "jaxlib", "flax"}


def test_run_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "vol2_final.wavefront", "--seed", "3",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "CUDA" in p.stderr


def test_run_fails_in_a_folder_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "vol2_final.wavefront", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_new_files_and_entries_are_found_by_name(tmp_path):
    """A configuration, traffic mix, scene, limits and per-layer metric
    added as new files (and entries) are found without editing a file."""
    bdir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bdir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (bdir / "scenes" / "two_spheres.py").write_text(
        "from harness import describe as D\n"
        "def build(cam, r=1.0):\n"
        "    s = D.Scene(camera=cam)\n"
        "    s.sphere((0, -100, 0), 100, D.Mat('lambertian', D.solid((.5, .5, .5))))\n"
        "    s.sphere((0, r, 0), r, D.Mat('light', D.solid((4, 4, 4))))\n"
        "    return s\n")
    (bdir / "configs" / "two_spheres.json").write_text(json.dumps({
        "scene": "two_spheres", "scene_args": {"r": 0.5}, "width": 8,
        "height": 6, "samples_per_pixel": 4, "max_depth": 4,
        "camera": {"vfov": 40, "lookfrom": [0, 1, 6], "lookat": [0, 0.5, 0]},
        "reduced": []}))
    (bdir / "traffic" / "two_batches.json").write_text(json.dumps({
        "driver": "progressive", "engine": "megakernel", "batch": 2,
        "profile_batches": 1}))
    (bdir / "limits" / "two_spheres.two_batches.json").write_text(json.dumps({
        "frame_l1_gap": {"limit": 1e-3}, "paths_budget": 10000,
        "min_pixels": 8}))
    (bdir / "metrics" / "renderer.paths_per_sample.py").write_text(
        "def read(ctx):\n"
        "    c = ctx['record'].counters\n"
        "    return c['paths'] / c['samples'] if c.get('samples') else None\n")
    spec["configs"].append({"name": "two_spheres", "source": "test",
                            "file": "benchmark/configs/two_spheres.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "two_spheres.two_batches",
                              "config": "two_spheres",
                              "traffic": "two_batches", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "renderer.paths_per_sample",
                              "unit": "paths/sample", "better": "higher",
                              "source": "program_counter",
                              "layer": "renderer", "moves": "msamples_per_s",
                              "workloads": ["two_spheres.two_batches"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = registry.Bench(root=str(tmp_path), bench_dir=str(bdir))
    assert b.config("two_spheres")["width"] == 8
    assert b.traffic("two_batches")["batch"] == 2
    assert [m["name"] for m in b.per_layer("two_spheres.two_batches")] == [
        "renderer.paths_per_sample"]
    out = run.run_cell(b, "two_spheres.two_batches", 17, 0.05, True, "cpu")
    assert out["correct"] is True
    assert out["metrics"]["renderer.paths_per_sample"]["value"] == 48
    assert out["window"]["batches"] == 2 * out["window"]["frames"]
