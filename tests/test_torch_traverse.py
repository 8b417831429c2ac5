"""Suspended BVH traversal (BVH4 and BVH8 rows): the port's twin against the
JAX walk and the brute-force oracle.

``traversal_steps_batched`` is resumable state; after any number of steps
the port's integer state (node pointer, stack pointer, best prim) must equal
the JAX package's exactly.  ``best_t`` agrees to 1e-6 relative plus one ulp
of the scene's largest box coordinate absolute, not to the last bit: XLA's
CPU backend contracts ``a*b + c`` into fused multiply-adds, the twin rounds
every operation, and a quad's ``t = (d - n.o) / (n.d)`` cancels in its
numerator, so the error scales with the ulp of the coordinates, not with
``t``.  Measured beyond the 1e-6 relative part: 0.74 ulp on cornell_box
(extent 555, ulp 6.1e-5), 0.38 ulp on vol2_final_scene (extent 5000, ulp
4.9e-4).  Run to completion the walk must find the brute-force closest hit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracer_tpu as pt
from path_tracer_tpu.ops import traverse as jtr
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import traverse as ttr
from path_tracer_tpu_torch.ops.types import bvh_layout

R = 512
T_MIN, T_MAX = 1e-3, 1e9


def _scene(name, branching=4):
    kw = {"sphere_cluster": 50} if name == "vol2_final_scene" else {}
    world, _cam = getattr(pt.scenes, name)(**kw)
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene, branching=branching)
    return scene, bvh, interop.from_numpy_scene(scene, "cpu"), \
        interop.from_numpy_bvh(bvh, "cpu")


def _rays(seed, lo, hi):
    g = np.random.default_rng(seed)
    ro = g.uniform(lo, hi, (R, 3)).astype(np.float32)
    rd = g.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    time = g.uniform(0, 1, R).astype(np.float32)
    return ro, rd, time


BOUNDS = {"cornell_box": (5.0, 550.0), "vol2_final_scene": (-100.0, 600.0)}


@pytest.mark.parametrize("branching", [4, 8])
@pytest.mark.parametrize("name", ["cornell_box", "vol2_final_scene"])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_steps_match_jax(name, k, branching):
    scene, bvh, tscene, tbvh = _scene(name, branching)
    assert tbvh.branching == bvh.branching == branching
    ro, rd, time = _rays(k, *BOUNDS[name])
    tmin = np.full(R, T_MIN, np.float32)
    js = jtr.traversal_init_batched(bvh, jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.asarray(time), jnp.asarray(tmin),
                                    T_MAX, 48)
    ts = ttr.traversal_init_batched(tbvh, torch.from_numpy(ro),
                                    torch.from_numpy(rd),
                                    torch.from_numpy(time),
                                    torch.from_numpy(tmin), T_MAX, 48)
    for f in jtr.TravState._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    js = jtr.traversal_steps_batched(bvh, js, jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(time), jnp.asarray(tmin), k)
    ts = ttr.traversal_steps_batched(tbvh, ts, torch.from_numpy(ro),
                                     torch.from_numpy(rd),
                                     torch.from_numpy(time),
                                     torch.from_numpy(tmin), k)
    for f in ("cur", "sp", "best_pt", "best_pi"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    # Live stack entries (below sp) are equal; entries above are never read.
    jst = np.asarray(js.stack)
    live = np.arange(jst.shape[1])[None, :] < np.asarray(js.sp)[:, None]
    np.testing.assert_array_equal(ts.stack.numpy()[live], jst[live])
    boxes = bvh_layout(branching)[0]
    extent = np.float32(np.abs(np.asarray(bvh.nodes)[:, :boxes]).max())
    np.testing.assert_allclose(ts.best_t.numpy(), np.asarray(js.best_t),
                               rtol=1e-6, atol=np.spacing(extent))


@pytest.mark.parametrize("name", ["cornell_box", "vol2_final_scene"])
def test_closest_hit_matches_brute_force(name):
    scene, bvh, tscene, tbvh = _scene(name)
    ro, rd, time = _rays(7, *BOUNDS[name])
    o, d, t = torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(time)
    s = ttr.traversal_init_batched(tbvh, o, d, t, T_MIN, T_MAX, 48)
    s = ttr.traversal_steps_batched(tbvh, s, o, d, t, T_MIN, 4096)
    assert bool(ttr.traversal_done(s).all())
    found, bpt, bpi, bt = ttr.first_hit_brute(tscene, o, d, t, T_MIN, T_MAX)
    np.testing.assert_array_equal((s.best_pt >= 0).numpy(), found.numpy())
    assert found.float().mean() > 0.3, "rays mostly missed — test scene broken"
    np.testing.assert_allclose(s.best_t[found].numpy(), bt[found].numpy(),
                               rtol=1e-4)
    # Same primitive, except at exact ties (coincident box faces).
    diff = found & ((s.best_pt != bpt) | (s.best_pi != bpi))
    assert torch.allclose(s.best_t[diff], bt[diff], rtol=1e-5)
    assert float(diff.float().mean()) < 0.01
    # The JAX oracle agrees with the port's oracle.
    jf, jpt, jpi, jt = jax.vmap(lambda a, b, c: jtr.first_hit_brute(
        scene, a, b, c, T_MIN, T_MAX))(jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(time))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
    np.testing.assert_allclose(bt[found].numpy(), np.asarray(jt)[found.numpy()],
                               rtol=1e-4)


def test_single_prim_root_leaf():
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, 0, -3), 1.0, pt.Lambertian((0.5, 0.5, 0.5))))
    scene = pt.compile_scene(w)
    bvh = pt.build_from_scene(scene)
    tbvh = interop.from_numpy_bvh(bvh, "cpu")
    ro = np.zeros((4, 3), np.float32)
    rd = np.array([[0, 0, -1], [0, 0, 1], [0.1, 0, -1], [1, 0, 0]], np.float32)
    time = np.zeros(4, np.float32)
    js = jtr.traversal_init_batched(bvh, jnp.asarray(ro), jnp.asarray(rd),
                                    jnp.asarray(time), T_MIN, T_MAX, 48)
    ts = ttr.traversal_init_batched(tbvh, torch.from_numpy(ro),
                                    torch.from_numpy(rd),
                                    torch.from_numpy(time), T_MIN, T_MAX, 48)
    assert int(tbvh.root) < 0
    for f in jtr.TravState._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.best_pt.tolist() == [0, -1, 0, -1]


def test_bvh8_closest_hits_match_jax():
    """The twin's per-ray walk over a BVH8 against JAX ``traverse_bvh`` on
    ``tests/test_bvh.py``'s random scene and rays (``test_bvh8_matches_bvh4``):
    the same hit and primitive on every ray, ``t`` within that test's
    tolerance (rtol = atol = 1e-5).  The rays' directions are not unit
    vectors there, so XLA's fused multiply-adds move ``t`` by more than in
    the step test (measured: 29 of 512 rays beyond rtol 1e-6 + one ulp of
    the extent, at most 1.7e-5 absolute, 1.4e-5 relative)."""
    from test_bvh import _random_scene

    g = np.random.default_rng(42)
    scene = _random_scene(g)
    bvh = pt.build_from_scene(scene, branching=8)
    tbvh = interop.from_numpy_bvh(bvh, "cpu")
    assert tbvh.branching == 8 and tuple(tbvh.nodes.shape)[1] == 184
    ro = g.uniform(-20, 20, (R, 3)).astype(np.float32)
    rd = (g.uniform(-8, 8, (R, 3)) - ro).astype(np.float32)
    time = np.zeros(R, np.float32)
    jf, jpt, jpi, jt = jax.jit(jax.vmap(lambda o, d, t: jtr.traverse_bvh(
        bvh, o, d, t, T_MIN, T_MAX, 64)))(jnp.asarray(ro), jnp.asarray(rd),
                                          jnp.asarray(time))
    f, bpt, bpi, bt = ttr.traverse_bvh(tbvh, torch.from_numpy(ro),
                                       torch.from_numpy(rd),
                                       torch.from_numpy(time), T_MIN, T_MAX,
                                       64)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    assert f.sum() > 50
    np.testing.assert_array_equal(bpt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(bpi.numpy(), np.asarray(jpi))
    np.testing.assert_allclose(bt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-5)


def _step_every_slot(bvh, s, ro, rd, time, t_min, iota):
    """One walk step in the formulation without shortcuts: the node rows
    gathered by advanced indexing and every slot's primitive test run on
    every lane, hit leaf or not (``closer`` keeps only hit leaves)."""
    from path_tracer_tpu_torch.ops import intersect as isect
    from path_tracer_tpu_torch.ops.types import BVH_EMPTY_SLOT, PRIM_ROW

    K = bvh.branching
    ptr_off, payload, _ = bvh_layout(K)
    rox, roy, roz = ro.unbind(-1)
    rdx, rdy, rdz = rd.unbind(-1)
    ivx, ivy, ivz = 1.0 / rdx, 1.0 / rdy, 1.0 / rdz
    rr = rdx * rdx + rdy * rdy + rdz * rdz
    cur, stack, sp = s.cur, s.stack, s.sp
    best_t, best_pt, best_pi = s.best_t, s.best_pt, s.best_pi
    active = cur != ttr._DONE
    rows = bvh.nodes[torch.where(active, cur, 0).long()]
    cand_t, cand_p = [], []
    for i in range(K):
        ptr = rows[:, ptr_off + i].to(torch.int32)
        hi, ti = isect.hit_aabb_s(*(rows[:, 6 * i + j] for j in range(6)),
                                  rox, roy, roz, ivx, ivy, ivz, t_min, best_t)
        hi = hi & active & (ptr < BVH_EMPTY_SLOT)
        is_leaf = ptr < 0
        pr = [rows[:, payload + PRIM_ROW * i + j] for j in range(14)]
        lhit, lt = isect.hit_prim_row_s(pr, rox, roy, roz, rdx, rdy, rdz, rr,
                                        time, t_min, best_t,
                                        mask=bvh.prim_mask)
        closer = (hi & is_leaf) & lhit & (lt < best_t)
        best_t = torch.where(closer, lt, best_t)
        best_pt = torch.where(closer, pr[0].to(torch.int32), best_pt)
        best_pi = torch.where(closer, pr[1].to(torch.int32), best_pi)
        cand_t.append(torch.where(hi & ~is_leaf, ti, ttr.INF))
        cand_p.append(ptr)
    for a, b in ttr._SORT_NET[K]:
        swap = cand_t[a] > cand_t[b]
        cand_t[a], cand_t[b] = (torch.where(swap, cand_t[b], cand_t[a]),
                                torch.where(swap, cand_t[a], cand_t[b]))
        cand_p[a], cand_p[b] = (torch.where(swap, cand_p[b], cand_p[a]),
                                torch.where(swap, cand_p[a], cand_p[b]))
    valid = [t < ttr.INF for t in cand_t]
    sd = stack.shape[1]
    for k in range(K - 1, 0, -1):
        push = (iota == sp[:, None]) & valid[k][:, None]
        stack = torch.where(push, cand_p[k][:, None], stack)
        sp = torch.clamp(sp + valid[k].to(torch.int32), max=sd)
    can_pop = sp > 0
    popped = torch.where(can_pop, stack.gather(
        1, torch.clamp(sp - 1, min=0).long()[:, None])[:, 0], 0)
    nxt = torch.where(valid[0], cand_p[0],
                      torch.where(can_pop, popped, ttr._DONE))
    cur = torch.where(active, nxt, ttr._DONE).to(torch.int32)
    sp = (sp - (active & (~valid[0]) & can_pop).to(torch.int32)).to(
        torch.int32)
    return ttr.TravState(cur, stack, sp, best_t, best_pt, best_pi)


def _two_spheres():
    """tests/test_torch_renderer.py's scene: a BVH of one node row."""
    w = pt.HittableList()
    w.add(pt.Sphere.stationary((0, 0, -1), 0.5,
                               pt.Lambertian((0.7, 0.3, 0.3))))
    w.add(pt.Sphere.stationary((0, -100.5, -1), 100,
                               pt.Lambertian((0.8, 0.8, 0.0))))
    return w


@pytest.mark.parametrize("name", ["two_spheres", "vol2_final_scene"])
def test_walk_bit_equal_to_every_slot_walk_and_jax(name):
    """The twin's walk (node rows by ``index_select``, a slot's primitive
    test skipped where it is a hit leaf in no lane) step for step against
    the formulation without shortcuts: every ``TravState`` field bit-equal
    after 1, 2, 3, 5 and 8 steps and at the end; the per-ray hit record
    ``(hit, prim_type, prim_idx, t)`` of ``traverse_bvh`` bit-equal to the
    finished walk.  Against JAX's ``traversal_steps_batched`` and
    ``traverse_bvh``: the node pointer, stack, stack pointer and best
    primitive exact at every step count, ``best_t`` and ``t`` within this
    module's tolerance (XLA contracts multiply-adds; the header)."""
    if name == "two_spheres":
        world, lo, hi = _two_spheres(), -2.0, 2.0
    else:
        world, lo, hi = (pt.scenes.vol2_final_scene(sphere_cluster=20)[0],
                         -100.0, 600.0)
    scene = pt.compile_scene(world)
    bvh = pt.build_from_scene(scene)
    tbvh = interop.from_numpy_bvh(bvh, "cpu")
    assert (bvh.nodes.shape[0] == 1) == (name == "two_spheres")
    ro, rd, time = _rays(11, lo, hi)
    tmin = np.full(R, T_MIN, np.float32)
    o, d, t, tm = (torch.from_numpy(x) for x in (ro, rd, time, tmin))
    j_in = [jnp.asarray(x) for x in (ro, rd, time, tmin)]
    boxes = bvh_layout(4)[0]
    extent = np.float32(np.abs(np.asarray(bvh.nodes)[:, :boxes]).max())
    s = ref = ttr.traversal_init_batched(tbvh, o, d, t, tm, T_MAX, 48)
    js = jtr.traversal_init_batched(bvh, *j_in, T_MAX, 48)
    iota = torch.arange(s.stack.shape[1], dtype=torch.int32)[None]
    done = 0
    for k in (1, 1, 1, 2, 3, 4096):
        s = ttr.traversal_steps_batched(tbvh, s, o, d, t, tm, k)
        js = jtr.traversal_steps_batched(bvh, js, *j_in, k)
        for _ in range(k):
            if not bool((ref.cur != ttr._DONE).any()):
                break
            ref = _step_every_slot(tbvh, ref, o, d, t, tm, iota)
        done += k
        for f in ttr.TravState._fields:
            assert torch.equal(getattr(s, f), getattr(ref, f)), (done, f)
        for f in ("cur", "stack", "sp", "best_pt", "best_pi"):
            np.testing.assert_array_equal(getattr(s, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{f} after {done}")
        np.testing.assert_allclose(s.best_t.numpy(), np.asarray(js.best_t),
                                   rtol=1e-6, atol=np.spacing(extent))
    assert bool(ttr.traversal_done(s).all())
    hit, ptype, pidx, t_hit = ttr.traverse_bvh(tbvh, o, d, t, T_MIN, T_MAX,
                                               48)
    assert torch.equal(hit, ref.best_pt >= 0) and bool(hit.any())
    assert torch.equal(ptype, ref.best_pt) and torch.equal(pidx, ref.best_pi)
    assert torch.equal(t_hit, ref.best_t)
    jh = jax.vmap(lambda a, b, c: jtr.traverse_bvh(bvh, a, b, c, T_MIN, T_MAX,
                                                   48))(*j_in[:3])
    for got, want in zip((hit, ptype, pidx), jh[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(t_hit.numpy(), np.asarray(jh[3]), rtol=1e-6,
                               atol=np.spacing(extent))
