"""The counter table (``ops/types.py`` ``STATS``): every engine's stats and
the Renderer's sums.

* On the CPU twins of a 16x9 Cornell box, for the wavefront, the
  megakernel and the tiled engine: the stats carry the state's counter
  vector as ``ctr``, each stat is its entry (the layout's index, written
  out here), a counter the
  engine never writes reads 0, and ``depth_hist`` is the state's
  histogram; for both Renderer engines, ``RenderStats`` after ``render``
  is the sum of its batches' stats.
* On a CUDA card (marker ``gpu``): with the collector off, a finished
  megakernel batch's ``MegaState`` is freed (no reference cycle holds it).
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.ops import integrator as tint
from path_tracer_tpu_torch.ops import integrator_tiled as itl
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops import types as tty
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.render import renderer as trend

# Each stat's counter, written out against the layout.
LAYOUT = {"paths": tty.C_DONE, "rays": tty.C_RAYS,
          "depth_sum": tty.C_DEPTH_SUM, "waves": tty.C_WAVES,
          "ctrls": tty.C_CTRLS, "occ_sum": tty.C_OCC_SUM,
          "trav_steps": tty.C_TRAV_STEPS, "exec_steps": tty.C_EXEC_STEPS,
          "walk_steps": tty.C_WALK_STEPS,
          "stack_overflows": tty.C_STACK_OVF}
# The stats an engine never counts.
UNCOUNTED = {"wavefront": (),
             "megakernel": ("waves", "ctrls", "occ_sum", "exec_steps"),
             "tiled": ("paths", "rays", "depth_sum", "waves", "ctrls",
                       "occ_sum", "exec_steps")}
SPP = 2


def _renderer(engine, device="cpu"):
    world, cam = ptt.scenes.cornell_box()
    cam.img_width, cam.aspect_ratio = 16, 16 / 9
    engine = "megakernel" if engine == "tiled" else engine
    return ptt.Renderer(world, cam, engine=engine, device=device)


def _keep_states(monkeypatch, cls) -> list:
    """The states ``cls.init_state`` makes from now on, in order."""
    made, real = [], cls.init_state

    def init_state(self, accum):
        made.append(real(self, accum))
        return made[-1]
    monkeypatch.setattr(cls, "init_state", init_state)
    return made


def _batch_stats(engine, r, monkeypatch):
    """One batch of ``SPP`` samples through ``engine`` → (stats, the
    state's counter vector, its depth histogram or None)."""
    args = (r.scene, r.flags, r.bvh, r.cam_arrays, r.cfg)
    if engine == "tiled":
        made, real = [], itl.new_counters
        monkeypatch.setattr(itl, "new_counters",
                            lambda dev: made.append(real(dev)) or made[-1])
        _, st = itl.render_tiled(*args, r.key, spp=SPP, with_stats=True)
        return st, made[0], None
    zero = torch.zeros_like(r.accum)
    if engine == "wavefront":
        made = _keep_states(monkeypatch, twf.WaveEngine)
        _, st = twf.render_batch(*args, zero, 0, SPP, r.key, queue_size=64,
                                 steps_per_wave=8, with_stats=True)
    else:
        made = _keep_states(monkeypatch, tint.MegaEngine)
        _, st = tint.render_batch(*args, zero, 0, SPP, r.key,
                                  with_stats=True)
    return st, made[0].ctr, made[0].depth_hist


@pytest.mark.parametrize("engine", ("wavefront", "megakernel", "tiled"))
def test_stats_read_the_counter_table(engine, monkeypatch):
    assert tty.STATS == LAYOUT
    r = _renderer(engine)
    st, ctr, hist = _batch_stats(engine, r, monkeypatch)
    assert st["ctr"] is ctr
    for name, i in LAYOUT.items():
        assert int(st[name]) == int(ctr[i]), name
        if name in UNCOUNTED[engine]:
            assert int(st[name]) == 0, name
    assert int(st["trav_steps"]) > 0 and int(st["stack_overflows"]) == 0
    if engine == "tiled":
        return
    npix = r.cfg.width * r.cfg.height
    assert int(st["paths"]) == SPP * npix and int(st["rays"]) > 0
    assert torch.equal(st["depth_hist"], hist)
    assert int(st["host_reads"]) == 0

    # RenderStats after render() is the sum of its batches' stats
    monkeypatch.undo()
    r = _renderer(engine)
    batches, real = [], trend._render_batch

    def keep(*a, **kw):
        accum, b = real(*a, **kw)
        batches.append(b)
        return accum, b
    monkeypatch.setattr(trend, "_render_batch", keep)
    r.render(spp=3, batch=2)
    assert len(batches) == 2
    s = r.stats
    for f in ("paths", "rays", "depth_sum", "occ_sum", "waves", "ctrls",
              "walk_steps", "host_reads"):
        assert getattr(s, f) == sum(int(b[f]) for b in batches), f
    assert s.paths == 3 * npix and s.slots == int(batches[-1]["slots"])
    np.testing.assert_array_equal(
        s.depth_hist, sum(b["depth_hist"].numpy() for b in batches))


@pytest.mark.gpu
def test_megakernel_batch_frees_its_state_without_the_collector(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    r = _renderer("megakernel", device="cuda")
    made = _keep_states(monkeypatch, tint.MegaEngine)
    gc.collect()
    gc.disable()
    try:
        _, st = tint.render_batch(r.scene, r.flags, r.bvh, r.cam_arrays,
                                  r.cfg, torch.zeros_like(r.accum), 0, SPP,
                                  r.key, with_stats=True)
        torch.cuda.synchronize()
        state = weakref.ref(made.pop())
        assert state() is None
    finally:
        gc.enable()
    assert int(st["paths"]) == SPP * r.cfg.width * r.cfg.height
