"""The port's threefry stream against ``jax.random`` (CPU, x64).

Keys, ``fold_in``, ``split``, uniforms and Bernoulli draws are integer
arithmetic plus exact bit transforms: they must be bitwise equal. Normals
go through ``erf_inv``; the port restates XLA's polynomial and log1p, but
XLA contracts some multiply-adds into FMAs, so they agree to 3 ulp (most
of them bitwise). The deferred-split replay's plain version must equal the
reference's Pallas replay kernel (interpret mode) bitwise; the CUDA
kernel is held against the plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.ops.prng import replay_split_chain as jax_replay
from walnuts_tpu_torch.convert import key_data_numpy, key_data_torch
from walnuts_tpu_torch.ops import prng


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)


def _jkeys(kd):
    return jax.vmap(jax.random.wrap_key_data)(jnp.asarray(kd))


@pytest.mark.parametrize("seed", [0, 7, 2026, 2**31 + 5, 2**32 - 1])
def test_key_and_fold_in_bitwise(seed):
    k = prng.key(seed)
    jk = jax.random.key(seed)
    np.testing.assert_array_equal(key_data_numpy(k), np.asarray(jax.random.key_data(jk)))
    data = [0, 1, 5, 12345, 0xFFFFFFFF]
    got = key_data_numpy(prng.fold_in(k, torch.tensor(data)))
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(jk, d)))
                     for d in data])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [2, 3])
def test_split_bitwise(num):
    kd = _keys(64, 1)
    got = key_data_numpy(prng.split(key_data_torch(kd), num))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.key_data(jax.random.split(k, num)))(_jkeys(kd)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_bitwise(dtype):
    kd = _keys(32, 2)
    got = prng.uniform(key_data_torch(kd), (3, 17), getattr(torch, dtype)).numpy()
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (3, 17), dtype=dtype))(_jkeys(kd)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bernoulli_bitwise(dtype):
    """The comparison uniform has the dtype of ``p``: float64 is the
    reference's default under x64, float32 its default without."""
    kd = _keys(512, 3)
    got = prng.bernoulli_half(key_data_torch(kd), getattr(torch, dtype)).numpy()
    p = np.asarray(0.5, dtype)
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p))(_jkeys(kd)))
    np.testing.assert_array_equal(got, want)
    assert 0.3 < got.mean() < 0.7


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_normal_within_3_ulp(dtype):
    kd = _keys(8, 4)
    got = prng.normal(key_data_torch(kd), (4000,), getattr(torch, dtype)).numpy()
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (4000,), dtype=dtype))(_jkeys(kd)))
    ulp = np.abs(got - want) / np.spacing(np.abs(want).astype(dtype))
    assert ulp.max() <= 3.0
    assert (ulp == 0).mean() > 0.9


def test_normal_matrix_counter_layout():
    """An (n, d) draw counts its elements in row-major order, like jax."""
    k = prng.fold_in(prng.key(5), 0xFFFFFFFF)
    got = prng.normal(k, (6, 5), torch.float64).numpy()
    want = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(5), 0xFFFFFFFF), (6, 5), jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-15)


def _replay_inputs(c, seed):
    rng = np.random.default_rng(seed)
    kd, ku = _keys(c, seed), _keys(c, seed + 1)
    n_ends = rng.integers(0, 13, size=c).astype(np.int32)
    leaf_end_at = (rng.random(c) * (n_ends + 1)).astype(np.int32)
    return kd, ku, n_ends, leaf_end_at


def test_replay_plain_bitwise_vs_pallas_interpret():
    kd, ku, n_ends, lea = _replay_inputs(256, 10)
    jk, jku = jax_replay(jnp.asarray(kd), jnp.asarray(ku), jnp.asarray(n_ends),
                         jnp.asarray(lea), interpret=True)
    tk, tku = prng.replay_split_chain(
        key_data_torch(kd), key_data_torch(ku), torch.from_numpy(n_ends),
        torch.from_numpy(lea))
    np.testing.assert_array_equal(key_data_numpy(tk), np.asarray(jk))
    np.testing.assert_array_equal(key_data_numpy(tku), np.asarray(jku))


def test_replay_passes_idle_lanes_through():
    kd, ku, n_ends, lea = _replay_inputs(16, 11)
    n_ends[:] = 0
    lea[:] = 0
    tk, tku = prng.replay_split_chain(
        key_data_torch(kd), key_data_torch(ku), torch.from_numpy(n_ends),
        torch.from_numpy(lea))
    np.testing.assert_array_equal(key_data_numpy(tk), kd)
    np.testing.assert_array_equal(key_data_numpy(tku), ku)


def test_replay_refuses_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device raises instead of reaching the plain version."""
    meta = lambda *s, dt=torch.int32: torch.empty(*s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        prng.replay_split_chain(meta(4, 2), meta(4, 2), meta(4), meta(4))
