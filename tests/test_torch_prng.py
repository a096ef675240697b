"""The port's threefry (gym_copter_tpu_torch/core/prng.py) against
`jax.random`, bit for bit: PRNGKey, fold_in, and uniform in float32 and
float64, over 1,000 (env id, episode) pairs as the env's reset draws them;
split, random bits and permutation as the PPO learner draws them; and
normal, whose erfinv differs from XLA's in the last bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu_torch.core import prng

N = 1000


@pytest.mark.parametrize('seed', [0, 7, 2 ** 31 + 5])
def test_key_and_fold_in_match_jax(seed):
    key_j = jax.random.PRNGKey(seed)
    key_t = prng.PRNGKey(seed, 'cpu')
    np.testing.assert_array_equal(key_t.numpy(),
                                  np.asarray(key_j).astype(np.int64))
    data = np.random.default_rng(seed % 97).integers(
        -2 ** 31, 2 ** 31, N).astype(np.int32)
    want = np.asarray(jax.vmap(lambda d: jax.random.fold_in(key_j, d))(
        jnp.asarray(data)))
    got = prng.fold_in(key_t, torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize('dtype_j,dtype_t', [(jnp.float32, torch.float32),
                                             (jnp.float64, torch.float64)])
@pytest.mark.parametrize('bound', [30.0, 0.1])
def test_uniform_matches_jax(dtype_j, dtype_t, bound):
    """`uniform(fold_in(fold_in(key, env_id), episode), 3, -F, F)`: XLA on
    the CPU computes the scale-and-shift as one FMA; the port's exact
    single-rounding form must give the same bits."""
    key_j = jax.random.PRNGKey(11)
    rng = np.random.default_rng(5)
    eid = rng.integers(0, 1 << 20, N).astype(np.int32)
    ep = rng.integers(0, 1000, N).astype(np.int32)

    def one(e, p):
        k = jax.random.fold_in(jax.random.fold_in(key_j, e), p)
        return jax.random.uniform(k, (3,), minval=-bound, maxval=bound,
                                  dtype=dtype_j)

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(eid),
                                             jnp.asarray(ep)))
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(11, 'cpu'),
                                     torch.from_numpy(eid)),
                        torch.from_numpy(ep))
    got = prng.uniform(keys, 3, -bound, bound, dtype_t).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_uniform_rejects_asymmetric_bounds():
    """Bounds other than [0, m) and [-m, m) raise."""
    with pytest.raises(ValueError, match='symmetric'):
        prng.uniform(prng.PRNGKey(0, 'cpu'), 3, 1.0, 2.0)


@pytest.mark.parametrize('seed', [0, 42, 2 ** 31 + 5])
def test_split_and_bits_match_jax(seed):
    """split(key, n) and 32-bit random bits: bit-equal."""
    key_j, key_t = jax.random.PRNGKey(seed), prng.PRNGKey(seed, 'cpu')
    np.testing.assert_array_equal(
        prng.split(key_t, 5).numpy(),
        np.asarray(jax.random.split(key_j, 5)).astype(np.int64))
    k, s = prng.split(key_t)
    np.testing.assert_array_equal(
        k.numpy(), np.asarray(jax.random.split(key_j)[0]).astype(np.int64))
    np.testing.assert_array_equal(
        prng.random_bits(s, (3, 700)).numpy(),
        np.asarray(jax.random.bits(jax.random.split(key_j)[1], (3, 700),
                                   jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize('n', [1, 2, 1000, 4096, 100_000])
def test_permutation_matches_jax(n):
    """permutation(key, n): bit-equal, 0-2 rounds of stable sorts by 32-bit
    keys (4096 blocks, the PPO update's, take 2).  At 100,000 elements the
    sort keys hold ties (about n^2 / 2^33 per round; the test checks there
    is one): both sorts are stable, so ties agree too."""
    for seed in (3, 4):
        key_j, key_t = jax.random.PRNGKey(seed), prng.PRNGKey(seed, 'cpu')
        np.testing.assert_array_equal(
            prng.permutation(key_t, n).numpy(),
            np.asarray(jax.random.permutation(key_j, n)))
    if n == 100_000:
        ties = 0
        for _ in range(2):
            key_t, sub = prng.split(key_t)
            bits = prng.random_bits(sub, (n,))
            ties += n - int(torch.unique(bits).numel())
        assert ties > 0


@pytest.mark.parametrize('dtype_j,dtype_t,ulp,rel', [
    (jnp.float32, torch.float32, 3, 3e-7),
    (jnp.float64, torch.float64, 32, 4e-15)])
def test_normal_matches_jax_within_erfinv_gap(dtype_j, dtype_t, ulp, rel):
    """normal(key, shape): the uniform u is bit-equal, and erf_inv is XLA's
    polynomial evaluated in XLA's order; what differs is torch's log1p and
    XLA's FMAs.  Measured over these 400,000 draws: equal at the median,
    4.7 % (float32) / 11 % (float64) of them differ, by at most 3 / 32 ULP
    (relative 2.4e-7 / 3.9e-15); held there.  (torch.erfinv differed by up
    to 91 / 682 ULP.)"""
    key_j, key_t = jax.random.PRNGKey(42), prng.PRNGKey(42, 'cpu')
    want = np.asarray(jax.random.normal(key_j, (4, 100_000), dtype_j))
    got = prng.normal(key_t, (4, 100_000), dtype_t).numpy()
    assert got.dtype == want.dtype
    itype = np.int32 if dtype_t == torch.float32 else np.int64
    gap = np.abs(got.view(itype).astype(np.int64)
                 - want.view(itype).astype(np.int64))
    assert np.median(gap) == 0 and gap.max() <= ulp
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


@pytest.mark.parametrize('cols', [(0, 700), (0, 350), (350, 700), (175, 525),
                                  (699, 700)])
def test_column_draws_are_columns_of_the_whole_draw(cols):
    """bits and normal with cols=(lo, hi) are the columns lo..hi-1 of the
    draw of the whole (3, 700), bit for bit: a rank's share of a sharded
    draw."""
    key = prng.split(prng.PRNGKey(9, 'cpu'))[1]
    lo, hi = cols
    assert torch.equal(prng.random_bits(key, (3, 700), cols),
                       prng.random_bits(key, (3, 700))[:, lo:hi])
    for dtype in (torch.float32, torch.float64):
        assert torch.equal(prng.normal(key, (3, 700), dtype, cols),
                           prng.normal(key, (3, 700), dtype)[:, lo:hi])
    with pytest.raises(ValueError, match='columns'):
        prng.random_bits(key, (3, 700), (600, 701))


@pytest.mark.parametrize('x64', [True, False], ids=['x64', 'x32'])
@pytest.mark.parametrize('shape', [(7,), (5, 13), (3, 4, 6)])
def test_learner_draws_match_jax(x64, shape):
    """The evolutionary learners' draws for one key over a shape: uniform
    on [0, 1), bernoulli and randint, bit-equal to `jax.random` with x64
    on (float64 uniforms, 64-bit randint words) and off (float32, 32-bit),
    for spans that are and are not powers of two, and spans above 2**16,
    where JAX's 32-bit multiplier (2**16 mod span)**2 wraps."""
    dtype = torch.float64 if x64 else torch.float32
    bits = 64 if x64 else 32
    with jax.enable_x64(x64):
        for seed in (0, 3, 2 ** 31 + 5):
            key_j, key_t = jax.random.PRNGKey(seed), prng.PRNGKey(seed, 'cpu')
            want = np.asarray(jax.random.uniform(key_j, shape))
            got = prng.uniform(key_t, shape, dtype=dtype).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            for p in (0.3, 0.75, 2.0 / 13):
                np.testing.assert_array_equal(
                    prng.bernoulli(key_t, p, shape, dtype).numpy(),
                    np.asarray(jax.random.bernoulli(key_j, p, shape)))
            for lo, hi in ((0, 3), (0, 4), (0, 960), (5, 100_000),
                           (0, 2 ** 30 + 3)):
                np.testing.assert_array_equal(
                    prng.randint(key_t, shape, lo, hi, bits).numpy(),
                    np.asarray(jax.random.randint(key_j, shape, lo, hi)),
                    err_msg=f'{bits}-bit randint [{lo}, {hi})')
