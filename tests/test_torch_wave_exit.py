"""The adaptive wave exit, the wave loop's comparison paths and P0.

* The twin's ``traversal_steps_batched(adaptive=True)`` against JAX's on the
  same ``TravState``, rays and BVH, several waves in a row: the integer
  state, ``lane_steps`` and ``exec_steps`` exactly.  ``best_t`` is held
  within 2e-4 relative: XLA's CPU backend fuses multiply-adds, the twin
  rounds every operation, and a quad's ``t`` divides that rounding by the
  cosine of the hit (measured: at most 1.0e-4 relative, one grazing hit on
  a Cornell wall, 15 of 256 lanes off in the last bits; 1.4e-6 on
  vol2_final_scene).  Chunk 1 is JAX's ``_unroll()`` on the CPU; chunk 4,
  its accelerator value, is JAX's with ``_unroll`` patched to return 4.
* K1's per-slot code built by g++ (``csrc/host_emulation.cpp``) runs a wave
  chunk by chunk: on a mid-flight pool at chunk 4 it equals the twin's
  wave exactly (state and counters, its chunk counters cleared), also on
  vol2_final pools where a leaf child's hit clips a later child's box,
  and a whole Cornell frame at chunk 4 has the twin's wave counters.
* ``gather_rows_plain`` equals JAX's ``table[idx, :]`` and ``jnp.take``
  exactly, and the wrapper takes it for CPU tensors; indices outside
  ``[0, B)`` are clamped as JAX's clip-mode gather clamps them.
* ``Renderer(engine="megakernel")`` warns when the config sets a wavefront
  knob, and renders the same image.
* On a CUDA card (marker ``gpu``): the kept device wave loop
  (``render_batch``) against the host loop of the CUDA kernels
  (``run_waves``), the graphed tiled frame against the eager one,
  ``gather_rows`` against ``index_select``.
"""
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
import path_tracer_tpu.ops.traverse as jtr
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import gather, kernels
from path_tracer_tpu_torch.ops import intersect as isect
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import (BVH_EMPTY_SLOT, PH_EXIT,
                                             PRIM_ROW, bvh_layout)
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg
from path_tracer_tpu_torch.utils import rng

R = 256
N_STEPS = 10          # not a multiple of 4: the last chunk runs past it
T_MIN, T_MAX = 1e-3, 1e9
BOUNDS = {"cornell_box": (5.0, 550.0), "vol2_final_scene": (-100.0, 600.0)}


def _scene(name):
    kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
    world, _cam = getattr(pt.scenes, name)(**kw)
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    return bvh, interop.from_numpy_bvh(bvh, "cpu")


def _rays(seed, lo, hi):
    g = np.random.default_rng(seed)
    ro = g.uniform(lo, hi, (R, 3)).astype(np.float32)
    rd = g.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd, g.uniform(0, 1, R).astype(np.float32)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("name", ["cornell_box", "vol2_final_scene"])
def test_adaptive_twin_matches_jax(monkeypatch, name, chunk):
    monkeypatch.setattr(jtr, "_unroll", lambda: chunk)
    bvh, tbvh = _scene(name)
    ro, rd, time = _rays(3, *BOUNDS[name])
    tmin = np.full(R, T_MIN, np.float32)
    jargs = tuple(jnp.asarray(x) for x in (ro, rd, time, tmin))
    targs = tuple(torch.from_numpy(x) for x in (ro, rd, time, tmin))
    js = jtr.traversal_init_batched(bvh, *jargs, T_MAX, 48)
    ts = ttr.traversal_init_batched(tbvh, *targs, T_MAX, 48)
    # One trace per test (a function of its own, so that no trace of
    # another chunk is reused): the chunk is read when the walk is traced.
    @jax.jit
    def jsteps(s, ro, rd, t, tm):
        return jtr.traversal_steps_batched(bvh, s, ro, rd, t, tm, N_STEPS,
                                           adaptive=True, count_steps=True)

    exits = 0
    for wave in range(4):
        js, jls, jes = jsteps(js, *jargs)
        ts, tls, tes = ttr.traversal_steps_batched(
            tbvh, ts, *targs, N_STEPS, count_steps=True, adaptive=True,
            chunk=chunk)
        assert int(tes) == int(jes) and int(tes) % chunk == 0, wave
        assert int(tls) == int(jls), wave
        exits += int(tes) < N_STEPS
        for f in ("cur", "sp", "best_pt", "best_pi"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{f} wave {wave}")
        jst = np.asarray(js.stack)
        live = np.arange(jst.shape[1])[None, :] < np.asarray(js.sp)[:, None]
        np.testing.assert_array_equal(ts.stack.numpy()[live], jst[live])
        np.testing.assert_allclose(ts.best_t.numpy(), np.asarray(js.best_t),
                                   rtol=2e-4)
    assert exits > 0, "no wave took the early exit: the test does not test it"


def test_wave_chunk_rule():
    """JAX's fixed loop where the exit does not apply: one chunk of all the
    steps when n_steps <= chunk or ADAPTIVE_WAVE is off."""
    assert ttr.wave_chunk(32, 4) == 4
    assert ttr.wave_chunk(4, 4) == 4 and ttr.wave_chunk(3, 4) == 3
    assert ttr.wave_chunk(8, 1) == 1


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _setup(name, width, branching=4):
    kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
    world, cam = getattr(ptt.scenes, name)(**kw)
    height = width * 9 // 16
    cam.img_width, cam.aspect_ratio = width, width / height
    scene = ptt.compile_scene(world, device="cpu")
    return (scene, TFlags.from_scene(scene),
            ptt.build_from_scene(scene, branching),
            cam.initialize(device="cpu"),
            TCfg(width=width, height=height, samples_per_pixel=2,
                 max_depth=10))


def _engine(setup, chunk):
    scene, flags, bvh, cam, cfg = setup
    eng = twf.WaveEngine(scene, flags, bvh, cam, cfg, 0, 2, rng.key(0),
                         queue_size=256, steps_per_wave=16, ctrl_den=8,
                         chunk=chunk)
    return eng, eng.init_state(torch.zeros((cfg.height, cfg.width, 3)))


@pytest.mark.parametrize("name", ["cornell_box", "vol2_final_scene"])
def test_emulated_k1_chunk_exit_matches_twin(name):
    """One wave of K1, chunk by chunk (g++ build), against the twin's wave
    at chunk 4, on pools 3 and 6 waves into the frame."""
    _needs_cxx()
    wave_ops, _ = kernels.host_emulation_ops()
    eng, ws = _engine(_setup(name, 32), chunk=4)
    assert kernels.fill_args(eng, ws).chunk == 4
    for wave in range(6):
        for op in twf.PLAIN:
            op(eng, ws)
        if wave not in (2, 5):
            continue
        emu, twin = ws.clone(), ws.clone()
        wave_ops[0](eng, emu)
        ttr.trace_step_plain(eng, twin)
        for f in ("cur", "stack", "sp", "best_t", "best_pt", "best_pi"):
            assert torch.equal(getattr(emu, f), getattr(twin, f)), f
        assert emu.ctr.tolist() == twin.ctr.tolist()
        assert int(emu.ctr[ttr.C_EXEC_STEPS] - ws.ctr[ttr.C_EXEC_STEPS]) % 4 == 0


def _clip_events(eng, ws, n_steps):
    """Walking lanes, summed over the twin's first ``n_steps`` steps from
    ``ws``, at which a leaf child hit in the step lowers ``best_t`` so that
    a later interior child's box test fails which the step's starting
    ``best_t`` would have passed: K1's group step must resolve the row in
    child order there."""
    bvh = eng.bvh
    K = bvh.branching
    ptr_off, payload, _ = bvh_layout(K)
    ro, rd = ws.origin, ws.direction
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    ivx, ivy, ivz = 1.0 / rdx, 1.0 / rdy, 1.0 / rdz
    rr = rdx * rdx + rdy * rdy + rdz * rdz
    t_min = torch.where(ws.phase == PH_EXIT, ws.hit_t + 1e-4,
                        torch.tensor(eng.cfg.t_min, dtype=torch.float32))
    iota = torch.arange(ws.stack.shape[1], dtype=torch.int32)[None]
    s = ttr.TravState(ws.cur, ws.stack, ws.sp, ws.best_t, ws.best_pt,
                      ws.best_pi)
    events = 0
    for _ in range(n_steps):
        active = s.cur != ttr._DONE
        rows = bvh.nodes[torch.where(active, s.cur, 0).long()]
        best = s.best_t
        clipped = torch.zeros_like(active)
        for i in range(K):
            ptr = rows[:, ptr_off + i].to(torch.int32)
            box = [rows[:, 6 * i + k] for k in range(6)]
            ray = (rox, roy, roz, ivx, ivy, ivz, t_min)
            hi, _ = isect.hit_aabb_s(*box, *ray, best)
            hi0, _ = isect.hit_aabb_s(*box, *ray, s.best_t)
            real = active & (ptr < BVH_EMPTY_SLOT)
            clipped |= real & (ptr >= 0) & hi0 & ~hi
            pr = [rows[:, payload + PRIM_ROW * i + j] for j in range(14)]
            lhit, lt = isect.hit_prim_row_s(pr, rox, roy, roz, rdx, rdy, rdz,
                                            rr, ws.time, t_min, best,
                                            mask=bvh.prim_mask)
            best = torch.where(real & hi & (ptr < 0) & lhit & (lt < best),
                               lt, best)
        events += int(clipped.sum())
        s = ttr._step(bvh, s, rox, roy, roz, ivx, ivy, ivz, rdx, rdy, rdz,
                      rr, ws.time, t_min, iota)
    return events


def check_emulated_k1(name, branching):
    """K1's wave (g++ build: its step, its chunk counters and their
    clearing) against the twin's wave at
    chunk 4 on pools 3 and 6 waves into the frame, and a wave of one chunk
    on the same pools (a step more or less shows there): lanes, stack and
    every counter exact.  Returns the pools' leaf-clip events over the
    steps the waves ran (``_clip_events``)."""
    _needs_cxx()
    wave_ops, _ = kernels.host_emulation_ops()
    setup = _setup(name, 32, branching)
    eng, ws = _engine(setup, chunk=4)
    one = twf.WaveEngine(*setup, 0, 2, rng.key(0), queue_size=256,
                         steps_per_wave=4, ctrl_den=8, chunk=4)
    assert eng.bvh.branching == branching
    events = 0
    for wave in range(6):
        for op in twf.PLAIN:
            op(eng, ws)
        if wave not in (2, 5):
            continue
        for e in (one, eng):
            emu, twin = ws.clone(), ws.clone()
            wave_ops[0](e, emu)
            ttr.trace_step_plain(e, twin)
            for f in ("cur", "stack", "sp", "best_t", "best_pt", "best_pi"):
                assert torch.equal(getattr(emu, f), getattr(twin, f)), f
            assert emu.ctr.tolist() == twin.ctr.tolist()
        run = int(twin.ctr[ttr.C_EXEC_STEPS] - ws.ctr[ttr.C_EXEC_STEPS])
        events += _clip_events(eng, ws, run)   # the steps eng's wave ran
    return events


def test_emulated_k1_keeps_child_order():
    """The g++-built K1 equals the twin on vol2_final pools where a leaf
    child's hit clips a later child's box within one step (3 such lanes;
    the Cornell pools above hold none)."""
    assert check_emulated_k1("vol2_final_scene", 4) > 0


def test_emulated_frame_at_chunk_4_has_twin_wave_counters():
    """A Cornell frame through the g++-built kernels at chunk 4: the wave
    schedule (waves, ctrls, occupancy, traversal and executed steps) equals
    the twin's."""
    _needs_cxx()
    wave_ops, _ = kernels.host_emulation_ops()
    setup = _setup("cornell_box", 32)
    (eng_a, a), (eng_b, b) = _engine(setup, 4), _engine(setup, 4)
    twf.run_waves(eng_a, a, plain=True)
    saved = twf.KERNELS
    twf.KERNELS = wave_ops
    try:
        twf.run_waves(eng_b, b)
    finally:
        twf.KERNELS = saved
    sa, sb = twf._stats(a, eng_a), twf._stats(b, eng_b)
    for k in ("paths", "waves", "ctrls", "occ_sum", "trav_steps",
              "exec_steps"):
        assert int(sa[k]) == int(sb[k]), k


def test_gather_rows_plain_matches_jax():
    g = np.random.default_rng(5)
    table = g.normal(size=(512, 80)).astype(np.float32)
    idx = g.integers(0, 512, 4096).astype(np.int32)
    got = gather.gather_rows_plain(torch.from_numpy(table),
                                   torch.from_numpy(idx)).numpy()
    jt, ji = jnp.asarray(table), jnp.asarray(idx)
    np.testing.assert_array_equal(got, np.asarray(jt[ji, :]))
    np.testing.assert_array_equal(got, np.asarray(jnp.take(jt, ji, axis=0)))
    kernels.reset_launches()
    cpu = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert torch.equal(cpu, torch.from_numpy(got))
    assert kernels.LAUNCHES["gather_rows"] == 0


@pytest.mark.parametrize("where", ["above", "below", "wrapped"])
def test_gather_rows_plain_clamps_as_jax(where):
    """Indices outside ``[0, B)`` are clamped, as JAX's clip-mode gather
    does (``jnp.take(..., mode="clip")``, ``lax.gather``) and as
    ``table[idx, :]`` does past either end; ``table[idx, :]`` alone wraps
    an index in ``[-B, 0)`` first, which the port does not."""
    g = np.random.default_rng(7)
    B = 512
    table = g.normal(size=(B, 80)).astype(np.float32)
    idx = g.integers(0, B, 4096).astype(np.int32)
    lo, hi = {"above": (B, 3 * B), "below": (-4 * B, -B),
              "wrapped": (-B, 0)}[where]
    idx[::3] = g.integers(lo, hi, idx[::3].shape[0])
    got = gather.gather_rows_plain(torch.from_numpy(table),
                                   torch.from_numpy(idx)).numpy()
    jt, ji = jnp.asarray(table), jnp.asarray(idx)
    np.testing.assert_array_equal(
        got, np.asarray(jnp.take(jt, ji, axis=0, mode="clip")))
    np.testing.assert_array_equal(got, table[np.clip(idx, 0, B - 1)])
    if where != "wrapped":
        np.testing.assert_array_equal(got, np.asarray(jt[ji, :]))
    else:
        assert not np.array_equal(got, np.asarray(jt[ji, :]))


def test_megakernel_warns_on_wavefront_knobs():
    world, cam = ptt.scenes.cornell_box()
    cam.img_width = 8
    plain = ptt.Renderer(world, cam, device="cpu")
    cfg = TCfg(width=plain.cfg.width, height=plain.cfg.height,
               samples_per_pixel=1, max_depth=plain.cfg.max_depth,
               queue_size=64, sample_stride=2)
    with pytest.warns(UserWarning, match="queue_size, sample_stride|"
                      "sample_stride, queue_size"):
        knobbed = ptt.Renderer(world, cam, cfg=cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ptt.Renderer(world, cam, engine="wavefront", cfg=cfg, device="cpu")
        ptt.Renderer(world, cam, device="cpu")
    np.testing.assert_array_equal(knobbed.render(spp=1), plain.render(spp=1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build()
    return torch.device("cuda")


def _card_setup(dev, w=160, h=90, spp=2):
    world, cam = ptt.scenes.vol2_final_scene(sphere_cluster=1000)
    cam.aspect_ratio, cam.img_width = w / h, w
    scene = ptt.compile_scene(world, device=dev)
    return (scene, TFlags.from_scene(scene), ptt.build_from_scene(scene),
            cam.initialize(device=dev),
            TCfg(width=w, height=h, samples_per_pixel=spp, max_depth=10))


@pytest.mark.gpu
def test_device_wave_loop_matches_host_loop_on_card(cuda_device):
    scene, flags, bvh, cam, cfg = _card_setup(cuda_device)
    key, pool = rng.key(0, cuda_device), dict(queue_size=8192,
                                              steps_per_wave=32, ctrl_den=8)
    zero = torch.zeros((cfg.height, cfg.width, 3), device=cuda_device)
    eng = twf.WaveEngine(scene, flags, bvh, cam, cfg, 0, 2, key, **pool)
    h = eng.init_state(zero)
    twf.run_waves(eng, h)
    h_st = twf._stats(h, eng)
    kernels.reset_launches()
    img, st = twf.render_batch(scene, flags, bvh, cam, cfg, zero, 0, 2, key,
                               with_stats=True, **pool)
    launches = dict(kernels.LAUNCHES)
    twf.clear_wave_loops()
    assert st["host_reads"] == 1
    assert torch.equal(h.accum.reshape(img.shape), img)
    for k in ("paths", "rays", "waves", "ctrls", "occ_sum", "trav_steps",
              "exec_steps", "walk_steps", "spawned"):
        assert int(h_st[k]) == int(st[k]), k
    assert torch.equal(h.depth_hist.cpu(), st["depth_hist"])
    assert torch.equal(h.pix_paths, st["pixel_paths"])
    waves = int(st["waves"])
    assert (launches["trace_step"] == launches["shade"] == launches["retire"]
            == launches["spawn"] == waves + 1)
    assert launches["wave_loop"] == 0


@pytest.mark.gpu
def test_graphed_tiled_frame_matches_eager_on_card(cuda_device):
    from path_tracer_tpu_torch.ops import integrator_tiled as itl
    scene, flags, bvh, cam, cfg = _card_setup(cuda_device)
    key = rng.key(0, cuda_device)
    kernels.reset_launches()
    img = ptt.render_tiled(scene, flags, bvh, cam, cfg, key, spp=2)
    assert kernels.LAUNCHES["tiled_trip"] == 2 * cfg.iters
    eng = itl.TiledEngine(scene, flags, bvh, cam, cfg, key)
    acc = 0.0
    for s in range(2):
        acc = acc + itl.render_sample_tiled(scene, flags, bvh, cam, cfg, s,
                                            key, eng=eng)
    assert torch.equal(img, acc / 2)


@pytest.mark.gpu
def test_gather_rows_matches_index_select_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for W in (80, 96, 184, 7):
        table = torch.randn((512, W), device=cuda_device, generator=g)
        idx = torch.randint(0, 512, (4099,), device=cuda_device, generator=g,
                            dtype=torch.int32)
        assert torch.equal(gather.gather_rows(table, idx),
                           torch.index_select(table, 0, idx)), W
