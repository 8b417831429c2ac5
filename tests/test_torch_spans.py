"""The port's host-time spans (``path_tracer_tpu_torch.utils.spans``), CPU.

* Nesting: counts, totals, self time (total minus the spans opened
  directly inside) and the enclosing span's name, on a fake clock.
* The stack of open spans is empty again after an exception inside a
  span, ``KeyboardInterrupt`` included, also from the Renderer's loop.
* A record function is opened only while a profiler records, and the
  Renderer's spans are then found in ``prof.events()`` as host ops, not
  as user annotations (which the profiler also draws on the device).
* On a 24x24 Cornell box, for both engines: one ``renderer.batch`` a
  batch, one ``renderer.render`` and one ``renderer.frame_return`` a
  ``render()`` call.
* Counters beside the spans: ``count`` adds, ``counters()`` is a copy,
  ``reset()`` clears them and ``snapshot()`` leaves them out; a wavefront
  render counts its pool (waves, live lanes, slot-waves) as its batches'
  ``RenderStats`` fields, the megakernel counts nothing, and the CLI's
  ``"spans"`` carries the counters.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.render import renderer as trend
from path_tracer_tpu_torch.utils import spans

ENGINES = ("megakernel", "wavefront")


@pytest.fixture(autouse=True)
def _fresh():
    spans.reset()
    yield
    spans.reset()


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(spans, "_now", c)
    return c


def _cornell(width):
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = width
    return world, cam


def test_nesting_counts_and_self_time(clock):
    with spans.span("outer") as outer:
        clock.advance(1.0)
        for _ in range(2):
            with spans.span("inner"):
                clock.advance(2.0)
                with spans.span("leaf"):
                    clock.advance(0.25)
        clock.advance(0.5)
    snap = spans.snapshot()
    assert outer.seconds == 6.0
    assert snap["outer"] == {"count": 1, "total_s": 6.0, "self_s": 1.5,
                             "parent": None}
    # Self time leaves out only the spans opened directly inside.
    assert snap["inner"] == {"count": 2, "total_s": 4.5, "self_s": 4.0,
                             "parent": "outer"}
    assert snap["leaf"] == {"count": 2, "total_s": 0.5, "self_s": 0.5,
                            "parent": "inner"}
    snap["outer"]["count"] = 99                 # a copy, not the registry
    assert spans.snapshot()["outer"]["count"] == 1
    spans.reset()
    assert spans.snapshot() == {}


@pytest.mark.parametrize("exc", [ValueError, KeyboardInterrupt])
def test_the_stack_is_clean_after_an_exception(exc):
    with pytest.raises(exc):
        with spans.span("a"):
            with spans.span("b"):
                raise exc("inside")
    assert spans._STACK == []
    snap = spans.snapshot()
    assert snap["a"]["count"] == snap["b"]["count"] == 1
    assert snap["b"]["parent"] == "a"
    with spans.span("c"):
        pass
    assert spans.snapshot()["c"]["parent"] is None


def test_an_interrupted_render_leaves_the_stack_clean(monkeypatch):
    """``Renderer.render`` re-raises ``KeyboardInterrupt`` from its loop."""
    world, cam = _cornell(8)
    r = ptt.Renderer(world, cam, device="cpu")
    real, calls = trend._render_batch, []

    def second_raises(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a, **kw)

    monkeypatch.setattr(trend, "_render_batch", second_raises)
    with pytest.raises(KeyboardInterrupt):
        r.render(spp=3, batch=1)
    assert spans._STACK == []
    snap = spans.snapshot()
    assert snap["renderer.batch"]["count"] == 2
    assert snap["renderer.stats_read"]["count"] == 1
    assert snap["renderer.render"]["count"] == 1
    assert "renderer.frame_return" not in snap
    assert r.samples_done == 1


def test_record_function_only_while_a_profiler_records(monkeypatch):
    entered = []

    def fake(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(spans, "_record", fake)
    with spans.span("off"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("on"):
            pass
    assert entered == ["on"]
    with spans.span("off"):
        pass
    assert entered == ["on"]


@pytest.mark.parametrize("engine", ENGINES)
def test_the_renderers_spans_are_in_the_profilers_trace(engine):
    world, cam = _cornell(8)
    r = ptt.Renderer(world, cam, engine=engine, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(spp=2, batch=1)
    ours = [e for e in prof.events() if e.name.split(".")[0] in
            ("renderer", engine)]
    assert {e.name for e in ours} >= {
        "renderer.render", "renderer.batch", "renderer.wait",
        "renderer.stats_read", "renderer.frame_return", f"{engine}.setup"}
    assert not any(e.is_user_annotation for e in ours)
    assert spans._STACK == []


@pytest.mark.parametrize("engine", ENGINES)
def test_one_batch_span_a_batch_one_frame_return_a_render(engine):
    world, cam = _cornell(24)
    r = ptt.Renderer(world, cam, engine=engine, device="cpu")
    img = r.render(spp=3, batch=2)                 # batches of 2 and 1
    img = r.render(spp=4, batch=2)                 # resumed: one more
    assert np.isfinite(img).all() and r.samples_done == 4
    snap = spans.snapshot()
    assert snap["renderer.batch"]["count"] == len(r.stats.sample_times) == 3
    assert snap["renderer.frame_return"]["count"] == 2
    assert snap["renderer.render"]["count"] == 2
    assert snap["renderer.batch"]["parent"] == "renderer.render"
    assert snap["renderer.frame_return"]["parent"] == "renderer.render"
    for name in ("renderer.wait", "renderer.stats_read", f"{engine}.setup"):
        assert snap[name]["count"] == 3
        assert snap[name]["parent"] == "renderer.batch"
    # The loop's batch times are the spans' durations.
    dts = [t * n for t, n in zip(r.stats.sample_times, (2, 1, 1))]
    assert sum(dts) == pytest.approx(snap["renderer.batch"]["total_s"])
    batch = snap["renderer.batch"]
    assert 0 < batch["self_s"] < batch["total_s"]
    # No loop graph on the CPU: the wavefront runs its host loop there.
    assert not {"wavefront.graph_build", "wavefront.wait",
                "wavefront.graph_free"} & set(snap)


# --- counters beside the spans ------------------------------------------

POOL = ("wavefront.waves", "wavefront.live_lanes", "wavefront.slot_waves")


def test_counters_add_up_and_reset_clears_them():
    spans.count("a", 3)
    spans.count("a", 4)
    spans.count("b", 0)
    with spans.span("s"):
        pass
    got = spans.counters()
    assert got == {"a": 7, "b": 0}
    got["a"] = 99                               # a copy, not the registry
    assert spans.counters()["a"] == 7
    assert set(spans.snapshot()) == {"s"}       # snapshot() holds spans only
    spans.reset()
    assert spans.counters() == {} and spans.snapshot() == {}


def test_a_wavefront_render_counts_its_pool(monkeypatch):
    """The counters are the batches' own ``occ_sum``, ``waves`` and
    ``slots`` x ``waves``, as ``RenderStats`` sums them."""
    world, cam = _cornell(16)
    r = ptt.Renderer(world, cam, engine="wavefront", device="cpu")
    real, batches = trend._render_batch, []

    def keep(*a, **kw):
        accum, st = real(*a, **kw)
        batches.append({k: int(st[k]) for k in ("occ_sum", "waves", "slots")})
        return accum, st

    monkeypatch.setattr(trend, "_render_batch", keep)
    r.render(spp=3, batch=2)
    assert len(batches) == 2
    got = spans.counters()
    assert got == {
        "wavefront.waves": r.stats.waves,
        "wavefront.live_lanes": r.stats.occ_sum,
        "wavefront.slot_waves": sum(b["slots"] * b["waves"] for b in batches)}
    assert r.stats.waves == sum(b["waves"] for b in batches) > 0
    assert 0 < got["wavefront.live_lanes"] <= got["wavefront.slot_waves"]


def test_the_megakernel_counts_no_pool():
    world, cam = _cornell(16)
    ptt.Renderer(world, cam, engine="megakernel", device="cpu").render(
        spp=2, batch=1)
    assert spans.counters() == {}
    assert spans.snapshot()["renderer.batch"]["count"] == 2


def test_the_clis_spans_hold_the_pool_counters(tmp_path, capsys):
    import json

    from path_tracer_tpu_torch.render import cli as tcli
    assert tcli.main(["--cpu", "--scene", "cornell_box", "--width", "16",
                      "--spp", "2", "--batch", "1", "--max-depth", "6",
                      "--out", str(tmp_path / "cb.ppm")]) == 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")][-1]
    sp = json.loads(line)["spans"]
    want = spans.counters()
    assert set(want) == set(POOL)
    for name in POOL:
        assert sp[name] == {"count": want[name],
                            "per_batch": want[name] / 2}, name
        assert want[name] > 0
