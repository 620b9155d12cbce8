"""The port's numpy threefry keys and draws against `jax.random` (CPU,
jax 0.9.0 at its defaults: jax_threefry_partitionable=True, 64-bit mode
off). Keys, uniform bits and randint are compared exactly; normal and
erfinv to 1 ulp (they reproduce XLA's CPU arithmetic bit for bit; the
bound leaves room for another float32 log1p).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yondx_torch.core import rng as R

UNPROCESS_BOUNDS = [(1e-8, 1e8), (1.4, 2.5), (1.5, 2.4)]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", [0, 1, 101, 303, 2 ** 31 - 1])
def test_prngkey_matches_jax(seed):
    np.testing.assert_array_equal(R.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [2, 4, 7])
def test_split_matches_jax_nested(n):
    jk, tk = jax.random.PRNGKey(303), R.PRNGKey(303)
    for depth in range(3):
        jkeys, tkeys = np.asarray(jax.random.split(jk, n)), R.split(tk, n)
        np.testing.assert_array_equal(tkeys, jkeys)
        assert tkeys.shape == (n, 2) and tkeys.dtype == np.uint32
        jk, tk = jnp.asarray(jkeys[depth % n]), tkeys[depth % n]


@pytest.mark.parametrize("bounds", UNPROCESS_BOUNDS,
                         ids=["ccm-weights", "red", "blue"])
@pytest.mark.parametrize("shape", [(), (4, 1, 1), (3, 5)],
                         ids=["scalar", "4x1x1", "3x5"])
def test_uniform_bits_match_jax(shape, bounds):
    lo, hi = bounds
    for seed in range(40):
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                            minval=lo, maxval=hi))
        got = R.uniform(R.PRNGKey(seed), shape, lo, hi)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))


@pytest.mark.parametrize("B", [1, 4, 9])
def test_randint_matches_jax(B):
    for seed in range(20):
        ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B,),
                                            0, 4))
        got = R.randint(R.PRNGKey(seed), (B,), 0, 4)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(), (1000,)], ids=["scalar", "1000"])
def test_normal_matches_jax_within_1ulp(shape):
    for seed in range(30 if shape == () else 5):
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = R.normal(R.PRNGKey(seed), shape)
        assert got.shape == ref.shape and got.dtype == np.float32
        assert _ulps(got, ref).max() <= 1, (seed, got, ref)


def test_erfinv_matches_xla_within_1ulp():
    """XLA's float32 erf_inv over the whole open interval, both of its
    branches (|w| < 5 and beyond) and log1p's two regimes."""
    u = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(5), (200_000,),
        minval=np.nextafter(np.float32(-1), np.float32(0)), maxval=1.0))
    u = np.concatenate([u, np.float32([0.0, 0.5, -0.9999999, 0.99999994])])
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    assert _ulps(R.erfinv_f32(u), ref).max() <= 1


def test_rng_seq_and_setup_seed():
    seq = R.rng_seq(7)
    key = jax.random.PRNGKey(7)
    for _ in range(3):
        key, sub = jax.random.split(key)
        np.testing.assert_array_equal(next(seq), np.asarray(sub))
    R.setup_seed(11)
    a = np.random.random()
    np.random.seed(11)
    assert a == np.random.random()
