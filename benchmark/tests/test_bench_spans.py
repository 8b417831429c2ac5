"""The per-layer metrics read from the port's host-time spans (CPU):
reported by a traced run of a tiny frame, and None, without an error,
where the program has no span registry (an older checkout)."""
import sys

import pytest

import run
from harness import drivers, registry

SPAN_METRICS = ("renderer.host_ms_per_batch", "wavefront.graph_ms_per_batch",
                "renderer.stats_read_ms_per_batch", "renderer.frame_return_ms")
# A frame of one batch and a traced slice of one frame: the CPU profiler
# records every op of the plain-torch twins, so more takes minutes.
TINY = dict(width=8, height=6, samples_per_pixel=2)
ONE_BATCH = dict(batch=2, profile_batches=1)


@pytest.fixture(scope="module")
def bench():
    return registry.Bench()


def test_a_traced_run_reports_the_span_metrics(bench):
    out = run.run_cell(bench, "vol2_final.wavefront", 2 ** 31 + 7, 0.01,
                       True, "cpu", resize=TINY, traffic_resize=ONE_BATCH)
    assert out["correct"] is True
    m = out["metrics"]
    for name in ("renderer.host_ms_per_batch",
                 "renderer.stats_read_ms_per_batch",
                 "renderer.frame_return_ms"):
        assert m[name]["value"] > 0, name
    assert m["renderer.host_ms_per_batch"]["unit"] == "ms/batch"
    assert m["renderer.frame_return_ms"]["unit"] == "ms/frame"
    # The CPU renders through the wavefront's host loop: no loop graph.
    assert "wavefront.graph_ms_per_batch" not in m


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_without_the_registry_reads_none(bench, monkeypatch, name):
    monkeypatch.delitem(sys.modules, "path_tracer_tpu_torch.utils.spans",
                        raising=False)
    rec = drivers.Record(setup_s=1.0, setup={}, window_s=1.0, unit_s=[0.1],
                         units=1, work=1.0, counters={}, memory_peak_bytes=0)
    assert bench.reader(name).read({"record": rec}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_span_metric_is_declared_as_a_program_span(bench, name):
    entry = next(m for m in bench.spec["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span"
    assert entry["workloads"]
