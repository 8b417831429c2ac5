"""The device wave loop's shape and K8's live lists, on the CPU.

* The wavefront's loop on the card is ``WHILE { K1, K3, K4, K2 }``
  (``csrc/wave_loop.cu``), ended by the K1 that finds no work left: on
  every wave whose ``do_ctrl`` is 0 (the waves that are not control waves,
  and that last one) the twins of K3, K4 and K2 leave the wave state and
  counters unchanged, so that loop, and one that skips them there, give
  the image and every counter of ``run_waves(plain=True)`` bit for bit;
  its ``waves`` and ``ctrls`` equal JAX's ``render_batch`` stats (exactly
  on cornell_box, within ``test_torch_wavefront.SCHED_GAP`` on
  vol2_final_scene).
* K1 built by g++ (``csrc/host_emulation.cpp``) writes the loop's WHILE
  condition on every wave: work left and ``waves < max_waves``, equal to
  the twin's ``eng.live``, and where the wave runs sets ``ctr[C_DO_CTRL]``
  as the twin does; where it does not, it clears it.
* K8 built by g++, over every lane or over live lists (``tiled_spawn``
  writes list 0, every lane; each trip runs its list's lanes and leaves
  those still alive in the other list, clearing the count it read): every
  trip's list holds exactly the live lanes (``alive.nonzero()`` as a set),
  and the trip equals ``tiled_trip_plain`` (alive, depth and iters
  exactly, the floats within the g++ build's libm rounding,
  ``walk_steps`` exactly); the same trip over the live lanes listed in a
  shuffled order is bit-identical to it.
* The spawn and K8 built by g++ read the frame's key and camera from
  ``WaveArgs.frame_dev`` (``kernels.frame_words``) bit for bit as from the
  argument block's own fields, and ``TripGraph.config`` leaves the key and
  camera out, so a kept trip graph serves every frame of its
  configuration.
* The spawn built by g++, run block by block (each block stages the
  frame's camera and the key folded with the sample once), equals JAX's
  ``spawn_paths`` on a ragged lane count, a sample read from memory,
  ``frame_dev`` set to this frame's and to another frame's key and camera,
  and with the live list 0.
* The kept wave loop graph (``wavefront.WaveLoop``) replays every batch of
  its configuration: K2 built by g++ reads the batch's first sample from
  memory (``sample_dev``) bit for bit as from the argument block, on
  single-sample and multi-sample work items; the graph's reset built by
  g++ (``wave_reset``) puts a mid-flight pool back to ``init_state``'s
  values, ``accum`` untouched; ``wavefront.loop_key`` ignores the first
  sample and changes with everything else a capture fixes (every other
  by-value field of the argument block, the device, a new or modified
  scene tensor), without a device read; ``wavefront.wave_loop`` keeps one
  loop, reloads it on a hit and frees it on a miss.

32x18, 2 spp, on vol2_final_scene(sphere_cluster=20) and cornell_box.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import wavefront as jwf
from path_tracer_tpu.ops.shade import SceneFlags as JFlags
from path_tracer_tpu.ops.types import RenderConfig as JCfg
import path_tracer_tpu_torch as ptt
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import integrator_tiled as it
from path_tracer_tpu_torch.ops import kernels
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops import wavefront as twf
from path_tracer_tpu_torch.ops.shade import SceneFlags as TFlags
from path_tracer_tpu_torch.ops.types import (C_CTRLS, C_DO_CTRL, C_SPAWNED,
                                             C_WALK_STEPS, C_WAVES)
from path_tracer_tpu_torch.ops.types import RenderConfig as TCfg

from test_torch_wavefront import SCHED_GAP

W, H, SPP = 32, 18, 2
SCENES = ["cornell_box", "vol2_final_scene"]
CPU = torch.device("cpu")


def _needs_cxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler")


def _world(name):
    kw = {"sphere_cluster": 20} if name == "vol2_final_scene" else {}
    world, cam = getattr(pt.scenes, name)(**kw)
    cam.img_width, cam.aspect_ratio = W, W / H
    return world, cam


def _port(name):
    """(scene, flags, bvh, camera, config, key) of the port on the CPU."""
    world, cam = _world(name)
    scene = pt.compile_scene(world)
    ts = interop.from_numpy_scene(scene, "cpu")
    key = interop.key_from_data(np.asarray(jax.random.key_data(
        jax.random.key(0))), "cpu")
    return (ts, TFlags.from_scene(ts),
            interop.from_numpy_bvh(pt.build_from_scene(scene), "cpu"),
            interop.from_numpy_camera(cam.initialize(), "cpu"),
            TCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=10), key)


def _wave_engine(port, **kw):
    scene, flags, bvh, cam, cfg, key = port
    eng = twf.WaveEngine(scene, flags, bvh, cam, cfg, 0, SPP, key,
                         queue_size=256, steps_per_wave=8, ctrl_den=8, **kw)
    return eng, eng.init_state(torch.zeros((H, W, 3)))


def _same_state(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in a.__dataclass_fields__)


def _device_loop(eng, ws, skip: bool) -> int:
    """The device loop's shape with the twins: a wave (K1, then K3, K4, K2)
    until K1 finds no work left, that last wave included; with ``skip`` K3,
    K4 and K2 run only on control waves.  On every other wave they must
    change nothing.  Returns those waves."""
    idle = 0
    for _ in range(twf.MAX_WAVES):
        go = eng.live(ws.ctr)               # K1's start ends the loop
        ttr.trace_step_plain(eng, ws)
        if not go:
            assert int(ws.ctr[C_DO_CTRL]) == 0
        if int(ws.ctr[C_DO_CTRL]) == 0:
            probe = ws.clone()
            for op in twf.PLAIN[1:]:
                op(eng, probe)
            assert _same_state(probe, ws), "a step off a control wave acted"
            idle += 1
        if not (skip and int(ws.ctr[C_DO_CTRL]) == 0):
            for op in twf.PLAIN[1:]:
                op(eng, ws)
        if not go:
            return idle
    raise AssertionError("the frame did not drain")


@pytest.mark.parametrize("skip", [False, True], ids=["every_wave", "skip"])
@pytest.mark.parametrize("name", SCENES)
def test_device_loop_shape_matches_host_loop_and_jax(name, skip):
    port = _port(name)
    eng, ws = _wave_engine(port)
    idle = _device_loop(eng, ws, skip)
    ref_eng, ref = _wave_engine(port)
    twf.run_waves(ref_eng, ref, plain=True)
    # the loop's last K1 clears the control flag, which the host loop,
    # stopping before it, leaves at the last wave's value
    assert int(ws.ctr[C_DO_CTRL]) == 0
    ws.ctr[C_DO_CTRL] = ref.ctr[C_DO_CTRL]
    assert _same_state(ws, ref)
    waves, ctrls = int(ws.ctr[C_WAVES]), int(ws.ctr[C_CTRLS])
    assert idle == waves - ctrls + 1 > 1
    world, cam = _world(name)
    scene = pt.compile_scene(world)
    _, jst = jwf.render_batch(
        scene, JFlags.from_scene(scene), pt.build_from_scene(scene),
        cam.initialize(), JCfg(width=W, height=H, samples_per_pixel=SPP,
                               max_depth=10),
        jnp.zeros((H, W, 3)), 0, SPP, jax.random.key(0), queue_size=256,
        steps_per_wave=8, with_stats=True)
    for k, v in (("waves", waves), ("ctrls", ctrls)):
        gap = 0 if name == "cornell_box" else SCHED_GAP[k]
        assert abs(v - int(jst[k])) <= gap, k


@pytest.mark.parametrize("max_waves", [0, 5])
@pytest.mark.parametrize("name", SCENES)
def test_emulated_k1_sets_loop_condition(name, max_waves):
    """Every wave of a frame: the g++-built K1 against the twin's K1 on the
    same state, the loop's condition read from the argument block."""
    _needs_cxx()
    k1 = kernels._emu_fn(kernels.host_emulation_lib(), "trace_step")
    eng, ws = _wave_engine(_port(name))
    a = kernels.fill_args(eng, ws)
    a.max_waves = max_waves
    for wave in range(twf.MAX_WAVES):
        go = eng.live(ws.ctr) and (max_waves <= 0 or wave < max_waves)
        twin = ws.clone()
        ttr.trace_step_plain(eng, twin)
        a.h_while = 7                        # neither 0 nor 1
        ws.ctr[C_DO_CTRL] = 1
        k1(a)
        assert a.h_while == int(go), wave
        if not go:
            assert int(ws.ctr[C_DO_CTRL]) == 0
            break
        assert torch.equal(ws.ctr, twin.ctr)
        for op in twf.PLAIN[1:]:
            op(eng, ws)
    assert int(ws.ctr[C_WAVES]) == wave
    if max_waves <= 0:
        assert not eng.live(ws.ctr)


def _trip_args(eng, st, pix, hit, ext, ctr, live, parity):
    lanes = dict(st._asdict(), pixel=pix, hit_found=hit[0], hit_pt=hit[1],
                 hit_pi=hit[2])
    if eng.flags.has_medium:
        lanes.update(exit_found=ext[0], exit_pt=ext[1], exit_pi=ext[2],
                     exit_t=ext[3])
    a = kernels.set_lanes(kernels.fill_args(eng), pix.shape[0], CPU, ctr,
                          **lanes)
    a.start_sample = 1
    it._set_live(a, live, parity)
    return a


@pytest.mark.parametrize("lists", [False, True], ids=["lanes", "live_lists"])
@pytest.mark.parametrize("name", SCENES)
def test_emulated_k8_live_lists(name, lists):
    _needs_cxx()
    emu = kernels.host_emulation_lanes()
    scene, flags, bvh, cam, cfg, key = _port(name)
    eng = it.TiledEngine(scene, flags, bvh, cam, cfg, key)
    R = W * H
    pix = torch.arange(R, dtype=torch.int32)
    st = it.tiled_spawn(eng, 1, pix)
    live = it.new_live_list(R, CPU) if lists else None
    if lists:                                # the spawn writes list 0
        es = it.PathState(*(x.clone() for x in st))
        a = kernels.set_lanes(kernels.fill_args(eng), R, CPU,
                              it.new_counters(CPU), pixel=pix, **es._asdict())
        a.start_sample = 1
        it._set_live(a, live, 0)
        emu["tiled_spawn"](a)
        assert torch.equal(live[0][0], pix) and live[1].tolist() == [R, 0, 0]
    t_min = torch.full((R,), cfg.t_min)
    for trip in range(cfg.iters):
        hit = it.closest_hit_plain(bvh, st.origin, st.direction, st.time,
                                   t_min, cfg.t_max, cfg.stack_depth,
                                   st.alive)
        ext = it.closest_hit_plain(bvh, st.origin, st.direction, st.time,
                                   (hit[3] + 1e-4).contiguous(), cfg.t_max,
                                   cfg.stack_depth,
                                   it.exit_lanes(eng, st.alive, *hit[:3]))
        alive_now = st.alive.nonzero()[:, 0].to(torch.int32)
        if lists:                            # this trip's list: the live lanes
            n_in = int(live[1][trip & 1])
            assert torch.equal(torch.sort(live[0][trip & 1][:n_in]).values,
                               alive_now)
        c_p, c_k = it.new_counters(CPU), it.new_counters(CPU)
        ks = it.PathState(*(x.clone() for x in st))
        emu["tiled_trip"](_trip_args(eng, ks, pix, hit, ext, c_k, live,
                                     trip & 1))
        nxt = it.tiled_trip_plain(eng, st, 1, pix, hit[:3], ext, ctr=c_p)
        for f in ("alive", "depth", "iters"):
            assert torch.equal(getattr(ks, f), getattr(nxt, f)), (trip, f)
        for f in ("origin", "direction", "color", "throughput", "time"):
            torch.testing.assert_close(getattr(ks, f), getattr(nxt, f),
                                       rtol=1e-5, atol=1e-5)
        assert int(c_k[C_WALK_STEPS]) == int(c_p[C_WALK_STEPS])
        # the same trip over the live lanes listed in a shuffled order:
        # bit-identical
        shuf = alive_now[torch.randperm(
            alive_now.shape[0], generator=torch.Generator().manual_seed(trip))]
        other = (torch.zeros((2, R), dtype=torch.int32),
                 torch.tensor([shuf.shape[0], 0, 0], dtype=torch.int32))
        other[0][0][:shuf.shape[0]] = shuf
        ko, c_o = it.PathState(*(x.clone() for x in st)), it.new_counters(CPU)
        emu["tiled_trip"](_trip_args(eng, ko, pix, hit, ext, c_o, other, 0))
        assert all(torch.equal(x, y) for x, y in zip(ko, ks)), trip
        assert torch.equal(c_o, c_k)
        assert int(other[1][0]) == 0          # the count read, cleared
        assert torch.equal(torch.sort(other[0][1][:int(other[1][1])]).values,
                           nxt.alive.nonzero()[:, 0].to(torch.int32))
        if lists:
            out = 1 - (trip & 1)
            assert int(live[1][trip & 1]) == 0
            assert torch.equal(
                torch.sort(live[0][out][:int(live[1][out])]).values,
                nxt.alive.nonzero()[:, 0].to(torch.int32))
        st = nxt
    assert not bool(st.alive.any())          # every path ended


def _moved_port(name):
    """The port of ``name`` (as :func:`_port`) rendered with another key
    from a moved camera."""
    scene, flags, bvh, _, cfg, _ = _port(name)
    _, cam = _world(name)
    cam.lookfrom = np.asarray(cam.lookfrom, float) + np.array([1.0, 0.5, 0.0])
    key = interop.key_from_data(np.asarray(jax.random.key_data(
        jax.random.key(5))), "cpu")
    return (scene, flags, bvh, interop.from_numpy_camera(cam.initialize(),
                                                         "cpu"), cfg, key)


@pytest.mark.parametrize("name", SCENES)
def test_emulated_tiled_kernels_read_frame_from_memory(name):
    """The g++-built spawn and K8 on one frame's argument block whose
    ``frame_dev`` holds another frame's key and camera
    (``kernels.frame_words``, as a kept trip graph reads them) equal the
    two kernels on the other frame's own block, bit for bit."""
    _needs_cxx()
    emu = kernels.host_emulation_lanes()
    eng = it.TiledEngine(*_port(name))
    other = it.TiledEngine(*_moved_port(name))
    words = kernels.frame_words(other.args())
    raw = words.numpy().view(np.uint32)
    assert raw[:2].tolist() == [other.args().key0, other.args().key1]
    assert raw[2:].view(np.float32).tolist() == [
        x for f in kernels.FRAME_FIELDS[2:-1]
        for x in getattr(other.args(), f)] + [other.args().defocus_angle]
    R = W * H
    pix = torch.arange(R, dtype=torch.int32)

    def spawn(e, frame):
        st = it.tiled_spawn(e, 1, pix)
        a = kernels.set_lanes(kernels.fill_args(e), R, CPU,
                              it.new_counters(CPU), pixel=pix, **st._asdict())
        a.start_sample = 1
        a.frame_dev = kernels._ptr(frame)
        emu["tiled_spawn"](a)
        return st

    mine, theirs, read = spawn(eng, None), spawn(other, None), spawn(eng, words)
    assert all(torch.equal(x, y) for x, y in zip(read, theirs))
    assert not torch.equal(mine.direction, theirs.direction)
    hit = it.closest_hit_plain(other.bvh, theirs.origin, theirs.direction,
                               theirs.time, torch.full((R,), other.cfg.t_min),
                               other.cfg.t_max, other.cfg.stack_depth,
                               theirs.alive)
    ext = it.closest_hit_plain(other.bvh, theirs.origin, theirs.direction,
                               theirs.time, (hit[3] + 1e-4).contiguous(),
                               other.cfg.t_max, other.cfg.stack_depth,
                               it.exit_lanes(other, theirs.alive, *hit[:3]))
    out = []
    for e, frame in ((other, None), (eng, words)):
        st, ctr = it.PathState(*(x.clone() for x in theirs)), it.new_counters(CPU)
        a = _trip_args(e, st, pix, hit, ext, ctr, None, 0)
        a.frame_dev = kernels._ptr(frame)
        emu["tiled_trip"](a)
        out.append((st, ctr))
    assert all(torch.equal(x, y) for x, y in zip(out[0][0], out[1][0]))
    assert torch.equal(out[0][1], out[1][1])


def _jax_spawn(name, key_seed, cam_edit, smp, pix):
    """JAX's ``spawn_paths`` (``shade_tiled.py:741``) for the lanes ``pix``
    of sample ``smp``, the frame of ``name`` keyed by ``key_seed`` with its
    camera edited by ``cam_edit``."""
    from path_tracer_tpu.ops.shade_tiled import spawn_paths
    _, cam = _world(name)
    cam_edit(cam)
    cfg = JCfg(width=W, height=H, samples_per_pixel=SPP, max_depth=10)
    st = spawn_paths(cam.initialize(), cfg, jax.random.key(key_seed),
                     jnp.full(pix.shape, smp, jnp.int32), jnp.asarray(pix))
    return [np.asarray(x) for x in st]


def _other_camera(cam):
    """Another view with a lens: moved, and a defocus angle (the camera's
    defocus branch)."""
    cam.lookfrom = np.asarray(cam.lookfrom, float) + np.array([1.0, 0.5, 0.0])
    cam.defocus_angle = 2.0


SPAWN_CASES = ["ragged", "sample_dev", "frame_dev", "frame_dev_other",
               "live_list", "rows_unaligned"]


@pytest.mark.parametrize("case", SPAWN_CASES)
def test_emulated_spawn_blocks_match_jax(case):
    """The g++-built ``tiled_spawn`` run block by block
    (``csrc/host_emulation.cpp``: each block of ``PTT_SPAWN_THREADS`` lanes
    stages its ``SpawnFrame`` once, the sample's fold included, and each
    whole warp writes its three-float rows in 16-byte pieces; the last block
    and warp are partial ones) against JAX's ``spawn_paths``: rays within
    1e-6 (g++'s libm against XLA's), time and the fresh state exact.
    Cases: 300 lanes of scattered pixels (not a multiple of the block or of
    a warp); the sample read from memory (``sample_dev``); ``frame_dev``
    holding this frame's key and camera, and another frame's (a new key, a
    moved camera with a lens), which the spawn then renders; the live list
    0 (every lane) and its count; origins not 16-byte aligned (every lane
    in 4-byte stores)."""
    _needs_cxx()
    emu = kernels.host_emulation_lanes()
    name = "vol2_final_scene"
    eng = it.TiledEngine(*_port(name))
    g = np.random.default_rng(13)
    R = 300 if case == "ragged" else W * H
    pix_np = (np.sort(g.choice(W * H, R, replace=False)) if case == "ragged"
              else np.arange(R)).astype(np.int32)
    pix = torch.from_numpy(pix_np)
    smp = 3
    st = it.PathState(*(torch.full_like(x, 7) for x in
                        it.tiled_spawn(eng, 0, pix)))
    if case == "rows_unaligned":           # origins 4 bytes off 16
        st = st._replace(origin=torch.full((3 * R + 1,), 7.0)[1:].view(R, 3))
    a = kernels.set_lanes(kernels.fill_args(eng), R, CPU,
                          it.new_counters(CPU), pixel=pix, **st._asdict())
    it._set_sample(a, torch.tensor([smp], dtype=torch.int32)
                   if case == "sample_dev" else smp)
    key_seed, cam_edit = 0, (lambda c: None)
    if case.startswith("frame_dev"):
        src = eng
        if case == "frame_dev_other":
            scene, flags, bvh, _, cfg, _ = _port(name)
            _, cam_o = _world(name)
            _other_camera(cam_o)
            key_o = interop.key_from_data(np.asarray(jax.random.key_data(
                jax.random.key(5))), "cpu")
            src = it.TiledEngine(scene, flags, bvh, interop.from_numpy_camera(
                cam_o.initialize(), "cpu"), cfg, key_o)
            key_seed, cam_edit = 5, _other_camera
        words = kernels.frame_words(src.args())
        a.frame_dev, a._keep_frame = kernels._ptr(words), words
    live = it.new_live_list(R, CPU) if case == "live_list" else None
    it._set_live(a, live, 0)
    emu["tiled_spawn"](a)
    ref = _jax_spawn(name, key_seed, cam_edit, smp, pix_np)
    got = [x.numpy() for x in st]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
    for k in range(2, 8):                  # time and the fresh state exact
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    if case == "frame_dev_other":          # not this frame's rays
        mine = _jax_spawn(name, 0, lambda c: None, smp, pix_np)
        assert not np.allclose(got[1], mine[1])
    if live is not None:
        assert torch.equal(live[0][0], torch.arange(R, dtype=torch.int32))
        assert live[1].tolist() == [R, 0, 0]


def test_tiled_spawn_writes_into_given_rows():
    """``tiled_spawn(..., out=)`` on the CPU writes the state into the given
    tensors (rows 4 bytes off 16-byte alignment, as the card's check
    passes them) and returns them: JAX's ``spawn_paths`` on 300 scattered
    lanes of sample 3, rays within 1e-6, time and the fresh state exact."""
    name = "vol2_final_scene"
    eng = it.TiledEngine(*_port(name))
    pix_np = np.sort(np.random.default_rng(5).choice(W * H, 300,
                                                     replace=False))
    pix = torch.from_numpy(pix_np.astype(np.int32))
    R = pix.shape[0]

    def off4(*shape):
        n = int(np.prod(shape))
        return torch.full((n + 4,), 7.0)[1:n + 1].view(shape)
    out = it.PathState(
        origin=off4(R, 3), direction=off4(R, 3), time=off4(R),
        color=off4(R, 3), throughput=off4(R, 3),
        depth=torch.full((R,), 7, dtype=torch.int32),
        iters=torch.full((R,), 7, dtype=torch.int32),
        alive=torch.zeros((R,), dtype=torch.bool))
    st = it.tiled_spawn(eng, 3, pix, out=out)
    assert all(x is y for x, y in zip(st, out))
    ref = _jax_spawn(name, 0, lambda c: None, 3, pix_np.astype(np.int32))
    got = [x.numpy() for x in out]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
    for k in range(2, 8):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


@pytest.mark.parametrize("name", SCENES)
def test_trip_graph_config_ignores_key_and_camera(name):
    """A kept trip graph serves every frame of its configuration: the key
    and camera are not part of what a capture fixes; the depth is."""
    n = W * H
    base = it.TripGraph.config(it.TiledEngine(*_port(name)), n)
    assert it.TripGraph.config(it.TiledEngine(*_moved_port(name)), n) == base
    scene, flags, bvh, cam, cfg, key = _port(name)
    deeper = dataclasses.replace(cfg, max_depth=cfg.max_depth + 1)
    assert it.TripGraph.config(
        it.TiledEngine(scene, flags, bvh, cam, deeper, key), n) != base


@pytest.mark.parametrize("stride", [1, 2], ids=["single_sample",
                                                "multi_sample"])
def test_emulated_spawn_reads_first_sample_from_memory(stride):
    """K2 built by g++ on the waves of a pool whose batch starts at sample
    5: with ``sample_dev`` pointing at 5 (and ``start_sample`` 0 in the
    block) it leaves every slot, sample, window end and counter as with
    ``start_sample`` 5 by value, bit for bit."""
    _needs_cxx()
    k2 = kernels._emu_fn(kernels.host_emulation_lib(), "spawn")
    scene, flags, bvh, cam, cfg, key = _port("cornell_box")
    start, n = 5, 4
    eng = twf.WaveEngine(scene, flags, bvh, cam, cfg, start, n, key,
                         queue_size=256, steps_per_wave=8, ctrl_den=8,
                         sample_stride=stride)
    assert eng.multi == (stride > 1)
    ws = eng.init_state(torch.zeros((H, W, 3)))
    first = torch.tensor([start], dtype=torch.int32)
    acted = 0
    while eng.live(ws.ctr):                # the twins' waves, K2 emulated
        for op in twf.PLAIN[:3]:
            op(eng, ws)
        by_value, from_memory = ws.clone(), ws.clone()
        k2(kernels.fill_args(eng, by_value))
        b = kernels.fill_args(eng, from_memory)
        b.start_sample, b.sample_dev = 0, kernels._ptr(first)
        k2(b)
        assert _same_state(by_value, from_memory)
        acted += not _same_state(by_value, ws)
        ws = by_value
    assert int(ws.ctr[C_SPAWNED]) >= eng.items_total
    assert acted > eng.items_total // eng.R
    lo, hi = int(ws.sample.min()), int(ws.sample.max())
    assert start <= lo <= hi < start + n


@pytest.mark.parametrize("name", SCENES)
def test_emulated_wave_reset_restores_init_state(name):
    """The loop graph's reset built by g++ on a pool after a few waves of
    the twins (slots busy, counters, depth histogram and per-pixel path
    counts non-zero): every field equals ``init_state``'s, and ``accum``
    keeps the frame."""
    _needs_cxx()
    reset = kernels._emu_fn(kernels.host_emulation_lib(), "wave_reset")
    eng, ws = _wave_engine(_port(name))
    for _ in range(12):
        for op in twf.PLAIN:
            op(eng, ws)
    assert bool(ws.occupied.any()) and int(ws.pix_paths.sum()) > 0
    assert int(ws.depth_hist.sum()) > 0 and int(ws.ctr[C_WAVES]) > 0
    frame = ws.accum.clone()
    reset(kernels.fill_args(eng, ws))
    assert torch.equal(ws.accum, frame)
    assert _same_state(ws, eng.init_state(frame))


LOOP_KW = dict(queue_size=256, steps_per_wave=8, ctrl_den=8)
# A change to render_batch's arguments, or to the scene, and whether the
# kept loop graph still serves it.
KEY_CASES = {
    "repeat": ({}, True), "start_sample": ({"start_sample": 8}, True),
    "queue": ({"queue_size": 128}, False),
    "steps": ({"steps_per_wave": 12}, False),
    "ctrl_den": ({"ctrl_den": 4}, False),
    "stride": ({"sample_stride": 2}, False),
    "n_samples": ({"n_samples": 3}, False),
    "pix_block": ({"pix_offset": 64, "n_pix": 128}, False),
    "device": ("meta", False), "scene_in_place": ("in_place", False),
    "new_leaf": ("detached", False)}


def _key_args(port, start_sample=0, n_samples=SPP, **kw):
    scene, flags, bvh, cam, cfg, key = port
    return (scene, flags, bvh, cam, cfg, start_sample, n_samples, key,
            dict(LOOP_KW, **kw))


def _loop_key(port, **kw):
    scene, flags, bvh, cam, cfg, _, n, key, rest = _key_args(port, **kw)
    return twf.loop_key(scene, flags, bvh, cam, cfg, n, key, **rest)


def _block_fields(port, **kw):
    """Every by-value field of the argument block the capture would take."""
    *head, rest = _key_args(port, **kw)
    eng = twf.WaveEngine(*head, **rest)
    return dict(kernels.value_fields(kernels.fill_args(eng), skip=()))


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_wave_loop_key_fixes_what_a_capture_reads(case, monkeypatch):
    """``wavefront.loop_key``, the kept loop graph's key, against a base
    call: equal where the capture serves the call (the same arguments, or
    another first sample, the one by-value field of the argument block
    that may differ); different for any other by-value field of the block
    (queue, steps, control denominator, stride, samples, pixel block),
    another device, a scene tensor modified in place or replaced by a new
    one.  Computed without reading tensor data: every read raises here."""
    port = _port("vol2_final_scene")
    change, serves = KEY_CASES[case]
    base_fields = _block_fields(port)
    other = port
    if change == "meta":
        scene, flags, bvh, cam, cfg, key = port
        other = (scene.to("meta"), flags, bvh.to("meta"), cam.to("meta"),
                 cfg, key.to("meta"))
    elif change == "in_place":
        port[0].tex_c1[0, 0] += 0.25
    elif change == "detached":
        other = (dataclasses.replace(port[0], tex_c1=port[0].tex_c1.detach()),
                 *port[1:])
    kw = change if isinstance(change, dict) else {}
    if isinstance(change, dict):
        fields = _block_fields(other, **kw)
        moved = {f for f in fields if fields[f] != base_fields[f]}
        if serves:
            assert moved <= {"start_sample"}
        else:
            assert moved - {"start_sample"}
    base = _loop_key(_port("vol2_final_scene")) if change == "in_place" \
        else _loop_key(port)

    def no_read(*a, **k):
        raise AssertionError("loop_key read tensor data")
    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    got = _loop_key(other, **kw)
    monkeypatch.undo()
    assert (got == base) == serves


def test_wave_loop_keeps_one_loop(monkeypatch):
    """``wavefront.wave_loop`` with the capture replaced by a stand-in (no
    card here): the first call builds a loop over a new engine and state;
    a repeat with another first sample and frame reloads that loop, with
    no device read; a scene tensor modified in place frees it and builds
    another; the first batch under ``torch.profiler`` rebuilds a loop built
    before any, and the next reloads it; ``clear_wave_loops`` frees the
    kept one."""
    made = []

    class Loop:
        def __init__(self, eng, ws, key=None):
            self.eng, self.ws, self.key = eng, ws, key
            self.traced = twf._PROFILED
            self.loads, self.freed = [], False
            made.append(self)

        def load(self, accum, start_sample):
            self.loads.append((accum, start_sample))

        def free(self):
            self.freed = True

    monkeypatch.setattr(twf, "WaveLoop", Loop)
    monkeypatch.setattr(twf, "_KEPT", None)
    monkeypatch.setattr(twf, "_PROFILED", False)
    scene, flags, bvh, cam, cfg, key = _port("cornell_box")

    def call(start, accum):
        return twf.wave_loop(scene, flags, bvh, cam, cfg, accum, start, SPP,
                             key, **LOOP_KW)

    frame = torch.zeros((H, W, 3))
    first = call(0, frame)
    assert made == [first] and first.loads == []
    assert first.eng.start_sample == 0 and torch.equal(first.ws.accum,
                                                       frame.reshape(-1, 3))
    nxt = torch.ones((H, W, 3))
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__int__"):
            m.setattr(torch.Tensor, name, lambda *a, **k: 1 / 0)
        assert call(SPP, nxt) is first
    assert first.loads == [(nxt, SPP)] and len(made) == 1
    scene.tex_c1[0, 0] += 0.25
    second = call(2 * SPP, nxt)
    assert made == [first, second] and first.freed and not second.freed
    assert second.eng.start_sample == 2 * SPP
    monkeypatch.setattr(twf, "_profiling", lambda: True)
    third = call(0, frame)
    assert made == [first, second, third] and second.freed and third.traced
    assert call(SPP, nxt) is third and third.loads == [(nxt, SPP)]
    monkeypatch.setattr(twf, "_profiling", lambda: False)
    assert call(0, frame) is third
    twf.clear_wave_loops()
    assert third.freed and twf._KEPT is None
