"""The port's threefry RNG is bit-exact with ``jax.random``.

The wavefront engines of both packages integrate the same (sample, pixel,
bounce) set only because every draw comes from the same threefry fold_in
chain; these tests pin the port's key, fold_in, uniform and key_data to the
JAX bits (JAX 0.9.0, ``jax_threefry_partitionable=True``), and the
per-lane draws of the wavefront (``wave_rng``, ``spawn_rng``) at R=4096.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.ops import shade_tiled as jst
from path_tracer_tpu_torch import interop
from path_tracer_tpu_torch.ops import shade_tiled as tst
from path_tracer_tpu_torch.utils import rng

SEEDS = [0, 1, 7, 42, 12345, 2**31 - 1]
FOLDS = [0, 1, 2, 7, 255, 65536, 123456789, 2**31 - 1]


def _jkey(k: torch.Tensor):
    return jax.random.wrap_key_data(jnp.asarray(k.numpy().astype(np.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    got = rng.key_data(rng.key(seed, device="cpu")).numpy()
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_chain_matches_jax(seed):
    k, jk = rng.key(seed, device="cpu"), jax.random.key(seed)
    for d in FOLDS:
        k, jk = rng.fold_in(k, d), jax.random.fold_in(jk, d)
        np.testing.assert_array_equal(rng.key_data(k).numpy(),
                                      np.asarray(jax.random.key_data(jk)))


@pytest.mark.parametrize("shape", [(), (1,), (2,), (5,), (8,), (3, 6), (32, 6)])
def test_uniform_matches_jax(shape):
    for seed in SEEDS[:3]:
        for d in FOLDS[:4]:
            k = rng.fold_in(rng.key(seed, device="cpu"), d)
            got = rng.uniform(k, shape).numpy()
            want = np.asarray(jax.random.uniform(_jkey(k), shape))
            np.testing.assert_array_equal(got, want)


def test_batched_fold_in_matches_vmap():
    base = rng.key(3, device="cpu")
    data = np.random.default_rng(0).integers(0, 2**31 - 1, 512).astype(np.int32)
    got = rng.fold_in(base, torch.from_numpy(data)).numpy()
    want = np.asarray(jax.vmap(lambda d: jax.random.key_data(
        jax.random.fold_in(jax.random.key(3), d)))(jnp.asarray(data)))
    np.testing.assert_array_equal(got, want)


def test_key_from_data_roundtrip():
    jk = jax.random.fold_in(jax.random.key(11), 99)
    k = interop.key_from_data(np.asarray(jax.random.key_data(jk)), "cpu")
    np.testing.assert_array_equal(rng.uniform(k, (16,)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (16,))))


def test_wave_and_spawn_rng_match_jax_at_4096_lanes():
    R = 4096
    g = np.random.default_rng(1)
    smp = g.integers(0, 64, R).astype(np.int32)
    pix = g.integers(0, 800 * 450, R).astype(np.int32)
    iters = g.integers(0, 18, R).astype(np.int32)
    jk = jax.random.key(0)
    tk = interop.key_from_data(np.asarray(jax.random.key_data(jk)), "cpu")
    want = jst.wave_rng(jk, jnp.asarray(smp), jnp.asarray(pix),
                        jnp.asarray(iters), False, 32)
    got = tst.wave_rng(tk, torch.from_numpy(smp), torch.from_numpy(pix),
                       torch.from_numpy(iters))
    for name in ("u8", "umed", "uiso", "urr"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    want5 = jst.spawn_rng(jk, jnp.asarray(smp), jnp.asarray(pix))
    got5 = tst.spawn_rng(tk, torch.from_numpy(smp), torch.from_numpy(pix))
    np.testing.assert_array_equal(got5.numpy(), np.asarray(want5))


def test_sss_walk_key_matches_jax():
    """``wave_rng``'s SSS walk key (kept for the B6 port) matches too."""
    jk = jax.random.key(5)
    tk = interop.key_from_data(np.asarray(jax.random.key_data(jk)), "cpu")
    a = np.arange(64, dtype=np.int32)
    want = jst.wave_rng(jk, jnp.asarray(a), jnp.asarray(a), jnp.asarray(a),
                        True, 4)["sss_key"]
    got = tst.wave_rng(tk, torch.from_numpy(a), torch.from_numpy(a),
                       torch.from_numpy(a), has_sss=True)["sss_key"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bounce_rng_matches_jax_on_a_key_batch():
    """``bounce_rng`` draws its bounce in three threefry passes; every draw
    and the SSS walk key equal JAX's separate fold_in and uniform calls
    bit for bit on a (3, 5) batch of keys."""
    jk = jax.vmap(jax.vmap(lambda a, b: jax.random.fold_in(
        jax.random.fold_in(jax.random.key(9), a), b)))(
        jnp.arange(15).reshape(3, 5), jnp.arange(15).reshape(3, 5) * 7919)

    def one(key_it):
        ks = jax.random.fold_in(key_it, 0)
        km = jax.random.fold_in(key_it, 1)
        kr = jax.random.fold_in(key_it, 2)
        return {"u8": jax.random.uniform(ks, (8,)),
                "umed": jax.random.uniform(km),
                "uiso": jax.random.uniform(jax.random.fold_in(km, 1), (2,)),
                "urr": jax.random.uniform(kr),
                "sss_key": jax.random.key_data(jax.random.fold_in(ks, 1))}

    want = jax.vmap(jax.vmap(one))(jk)
    tk = torch.from_numpy(np.asarray(jax.random.key_data(jk)).astype(np.int64))
    got = tst.bounce_rng(tk, has_sss=True)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_analytic_samplers_match_jax():
    from path_tracer_tpu.utils import rng as jrng
    u = np.random.default_rng(2).random((256, 2)).astype(np.float32)
    n = np.random.default_rng(3).normal(size=(256, 3)).astype(np.float32)
    tu, tn = torch.from_numpy(u), torch.from_numpy(n)
    for jf, tf, args in (
            (jrng.random_unit_vector, rng.random_unit_vector, (u,)),
            (jrng.random_in_unit_disk, rng.random_in_unit_disk, (u,)),
            (jrng.random_cosine_direction, rng.random_cosine_direction, (u, n)),
            (jrng.random_on_hemisphere, rng.random_on_hemisphere, (u, n))):
        want = np.asarray(jf(*[jnp.asarray(a) for a in args]))
        got = tf(*[torch.from_numpy(a) for a in args]).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    g = np.float32(0.4)
    want = np.asarray(jrng.sample_henyey_greenstein(jnp.asarray(u[:, 0]), g))
    got = rng.sample_henyey_greenstein(tu[:, 0], float(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want = np.asarray(jrng.direction_from_cos(jnp.asarray(u[:, 0]),
                                              jnp.asarray(u[:, 1]), jnp.asarray(n)))
    got = rng.direction_from_cos(tu[:, 0], tu[:, 1], tn).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
