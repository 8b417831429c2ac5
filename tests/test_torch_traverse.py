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
