"""The wavefront's control wave: K3 ``shade`` and K2 ``spawn``.

K3 draws every bounce from ``fold_in(fold_in(fold_in(base, sample), pixel),
iters)``.  On the CPU (no card):

* the twin's bounce key (``wave_rng``) is ``jax.random``'s fold, bit for
  bit, on every occupied slot of the control waves;
* K3 and K2 built by g++ (``csrc/host_emulation.cpp``: the slots in
  order, K2's taking tickets in slot order) against their twins on
  the control waves of mid-frame pools of vol2_final_scene
  (sphere_cluster=20) and mesh_perlin_sss (the SSS walk): every integer
  and boolean field, the live stack entries and the counters
  (``walk_steps`` included) exact; the float fields within two ulps at
  unit scale (|a - b| <= 2.4e-7 max(|b|, 1): the host C library's
  sinf/cosf/logf and torch's CPU kernels differ in the last bit, as
  ``test_torch_kernels.py`` notes).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch.ops import kernels, shade_tiled, traverse
from path_tracer_tpu_torch.ops import wavefront as wf
from path_tracer_tpu_torch.ops.shade import SceneFlags
from path_tracer_tpu_torch.ops.types import (C_DO_CTRL, C_N_OCC, C_SPAWNED,
                                             C_WALK_STEPS, RenderConfig)
from path_tracer_tpu_torch.utils import rng

W, H = 32, 18
SCENES = {"vol2": ("vol2_final_scene", {"sphere_cluster": 20}, 10),
          "sss": ("mesh_perlin_sss", {}, 12)}
FLOATS = ("origin", "direction", "time", "color", "throughput", "best_t",
          "hit_t", "accum")
N_WAVES = 10
ULP2 = 2.4e-7      # two f32 ulps at unit scale


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _engine(scene, stride, seed=0, spp=4):
    name, kw, depth = SCENES[scene]
    world, cam = getattr(ptt.scenes, name)(**kw)
    cam.img_width, cam.aspect_ratio = W, W / H
    sc = ptt.compile_scene(world, device="cpu")
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       max_depth=depth)
    eng = wf.WaveEngine(sc, SceneFlags.from_scene(sc),
                        ptt.build_from_scene(sc), cam.initialize(device="cpu"),
                        cfg, 0, spp, rng.key(seed), queue_size=256,
                        steps_per_wave=8, ctrl_den=8, sample_stride=stride)
    return eng, eng.init_state(torch.zeros((H, W, 3)))


def _control_waves(eng, ws):
    """The state at each of N_WAVES control waves of the twins' loop (K1
    run, the control flag set), the loop going on from each."""
    for _ in range(N_WAVES):
        traverse.trace_step_plain(eng, ws)
        ws.ctr[C_DO_CTRL] = 1
        yield ws.clone()
        for op in wf.PLAIN[1:]:
            op(eng, ws)


def _far(a, b) -> float:
    """Largest |a - b| / max(|b|, 1) of two f32 tensors (NaN equal to NaN)."""
    d = (a - b).abs() / b.abs().clamp(min=1.0)
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    return float(d.max()) if d.numel() else 0.0


def _assert_same_state(eng, got, want, what):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "stack":
            # entries at or above sp are dead: the twin's traversal init
            # rewrites the row, the kernel's writes the root push only
            live = (torch.arange(g.shape[1])[None, :]
                    < want.sp.clamp(min=0)[:, None])
            assert torch.equal(g[live], w[live]), (what, f.name)
        elif f.name == "ctr":
            # the twin counts every empty slot's ticket, the kernel stops
            # taking them once every item is handed out
            rest = torch.arange(g.shape[0]) != C_SPAWNED
            assert torch.equal(g[rest], w[rest]), what
            assert (min(int(g[C_SPAWNED]), eng.items_total)
                    == min(int(w[C_SPAWNED]), eng.items_total)), what
        elif f.name in FLOATS:
            assert _far(g, w) <= ULP2, (what, f.name, _far(g, w))
        else:
            assert torch.equal(g, w), (what, f.name)


@pytest.mark.parametrize("stride,seed", [(None, 0), (2, 7)],
                         ids=["stride1-seed0", "stride2-seed7"])
def test_wave_key_is_jax_fold(stride, seed):
    """Every occupied slot's bounce key ``fold_in(fold_in(fold_in(
    PRNGKey(seed), sample), pixel), iters)`` is ``jax.random``'s bit for
    bit (new items and in-place resamples alike), and ``wave_rng``'s
    draws are those of that key."""
    eng, ws = _engine("vol2", stride, seed)
    assert eng.multi == (stride is not None)
    jfold = jax.vmap(lambda s, p, i: jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), s), p), i))
    checked = 0
    for state in _control_waves(eng, ws):
        occ = state.occupied
        if not bool(occ.any()):
            continue
        smp, pix, it = state.sample[occ], state.pixel[occ], state.iters[occ]
        want = np.asarray(jfold(jnp.asarray(smp.numpy()),
                                jnp.asarray(pix.numpy()),
                                jnp.asarray(it.numpy()))).astype(np.int64)
        got = rng.fold_in(rng.fold_in(rng.fold_in(eng.key, smp), pix), it)
        np.testing.assert_array_equal(got.numpy(), want)
        ref = shade_tiled.bounce_rng(torch.from_numpy(want))
        draws = shade_tiled.wave_rng(eng.key, smp, pix, it)
        for k in ref:
            assert torch.equal(draws[k], ref[k]), k
        checked += 1
    assert checked >= N_WAVES - 1
    assert int(ws.ctr[C_SPAWNED]) > eng.R        # slots were renewed


@pytest.mark.parametrize("scene", ["vol2", "sss"])
def test_emulated_shade_matches_twin(scene):
    """K3 built by g++ against ``shade_plain`` on each control wave."""
    _needs_cxx()
    ops, _ = kernels.host_emulation_ops()
    eng, ws = _engine(scene, None)
    walked = shaded = 0
    for state in _control_waves(eng, ws):
        emu, twin = state.clone(), state.clone()
        ops[1](eng, emu)
        shade_tiled.shade_plain(eng, twin)
        _assert_same_state(eng, emu, twin, "shade")
        shaded += int((state.occupied & (state.cur == traverse._DONE)).sum())
        walked += int(twin.ctr[C_WALK_STEPS] - state.ctr[C_WALK_STEPS])
    assert shaded > 0
    assert (walked > 0) == (scene == "sss")


@pytest.mark.parametrize("scene,stride", [("vol2", None), ("vol2", 2),
                                          ("sss", None)],
                         ids=["vol2-stride1", "vol2-stride2", "sss-stride1"])
def test_emulated_spawn_matches_twin(scene, stride):
    """K2 built by g++ (the slots in order) against ``spawn_plain`` on the
    state after each control wave's K3 and K4: the same items in the same
    slots, rays and counters."""
    _needs_cxx()
    ops, _ = kernels.host_emulation_ops()
    eng, ws = _engine(scene, stride)
    renewed = 0
    for state in _control_waves(eng, ws):
        shade_tiled.shade_plain(eng, state)
        wf.retire_plain(eng, state)
        emu, twin = state.clone(), state.clone()
        ops[3](eng, emu)
        wf.spawn_plain(eng, twin)
        _assert_same_state(eng, emu, twin, "spawn")
        assert int(emu.ctr[C_N_OCC]) == int(emu.occupied.sum())
        renewed += int((emu.occupied & ~state.occupied).sum())
    assert renewed > 0
