"""The port's learning-rate schedule (gym_copter_tpu_torch/learn/optim.py
`linear_schedule`) against optax's as the JAX package's train step runs
it, jitted: bit for bit at every count of every schedule the port's
tests, curves and recipe use, and of others with a floor; and the
float32 FMA it rounds with (`optim.fma32`) against exact rounding.  Eager
optax rounds differently (one float32 ULP at many counts), so the
reference is `jax.jit(jax.vmap(optax.linear_schedule(...)))`."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_copter_tpu.learn import ppo as jppo
from gym_copter_tpu_torch.learn import optim, ppo

JCFG = jppo.PPOConfig()
CFG = ppo.resolve_minibatches(ppo.PPOConfig(), 4096)
TRAIN_UPDATES = 500
TRAIN_T = TRAIN_UPDATES * CFG.epochs * CFG.minibatches


def _jitted(init, end, steps):
    counts = jnp.arange(steps + 2, dtype=jnp.int32)
    return np.asarray(jax.jit(jax.vmap(optax.linear_schedule(
        init, end, steps)))(counts))


@pytest.mark.parametrize('init,end,steps', [
    (1e-3, 1e-4, 20),       # tests/test_torch_checkpoint.py
    (3e-4, 0.0, 10),        # tests/test_torch_curve_ckpt.py
    (3e-4, 0.0, 600 * 64),  # the recipe, Lander3D's curve
    (3e-4, 0.0, 500 * 64),  # Hover3D's curve
    (1e-2, 1e-3, 4),        # test_optimizer_matches_optax
    (1e-3, 5e-5, 160 * 4 * 4),  # tests/test_mars.py's run
    # schedules no recipe uses, with a floor
    (3e-4, 1.5e-5, 7), (3e-4, 1.5e-5, 999), (1e-3, 1e-4, 12345),
    (2.5e-4, 1e-5, 3 * 64), (1.0, 0.3, 1 << 14),
], ids=['T20', 'T10', 'recipe', 'hover_curve', 'T4', 'mars', 'T7', 'T999',
        'T12345', 'T192', 'T16384'])
def test_schedule_equals_jitted_optax_at_every_count(init, end, steps):
    """Counts 0 to steps + 1 (the last past the clamp), float32, equal
    bits; and 1/steps in float32 is the constant XLA folds in."""
    assert np.float32(1.0 / steps) == np.asarray(
        jnp.float32(1) / jnp.float32(steps))
    got = optim.linear_schedule(init, end, steps)(
        torch.arange(steps + 2, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _jitted(init, end, steps))


def _exact_fma32(a, b, c):
    """a * b + c in exact rationals, rounded once to the nearest float32,
    ties to even."""
    v = Fraction(a) * Fraction(b) + Fraction(c)
    f = np.float32(float(v))
    near = [f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda x: (abs(Fraction(float(x)) - v),
                                    int(np.array(x).view(np.uint32)) & 1))


def test_fma32_rounds_once():
    """`optim.fma32` against the exact sum rounded once: random float32
    triples, and products that put the float64 sum on a float32 tie the
    exact sum is not on (c + 2^-24 (1 - i^2 2^-46), i < 256), where
    rounding the float64 sum to float32 is one ULP off for odd c."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 4).astype(np.float32)
    i = rng.integers(1, 256, 2000)
    sign = rng.choice([-1.0, 1.0], 2000)
    ta = np.concatenate([a, (2.0 ** -12 * (1 + i * 2.0 ** -23)
                             ).astype(np.float32)])
    tb = np.concatenate([b, (sign * 2.0 ** -12 * (1 - i * 2.0 ** -23)
                             ).astype(np.float32)])
    tc = np.concatenate([c, (sign * rng.uniform(1, 2, 2000)
                             ).astype(np.float32)])
    want = [_exact_fma32(float(x), float(y), float(z))
            for x, y, z in zip(ta, tb, tc)]
    got = [optim.fma32(torch.tensor(float(x), dtype=torch.float64),
                       float(y), float(z)).item()
           for x, y, z in zip(ta, tb, tc)]
    np.testing.assert_array_equal(np.float32(got), np.float32(want))
    double = np.float32(ta.astype(np.float64) * tb + tc)
    assert (double != np.float32(want)).sum() > 800


def test_train_schedule_equals_jitted_optax_at_every_count():
    """train()'s own schedule (`train_optimizer`: PPOConfig's 3e-4 down to
    the default floor of 0.05 of it, over 500 updates of 4096 envs) against
    the one the JAX package's `train` builds from its PPOConfig."""
    assert (CFG.learning_rate, CFG.anneal_lr_floor) == (
        JCFG.learning_rate, JCFG.anneal_lr_floor) == (3e-4, 0.05)
    sched = ppo.train_optimizer(CFG, TRAIN_UPDATES).learning_rate
    got = sched(torch.arange(TRAIN_T + 2, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), _jitted(
        JCFG.learning_rate, JCFG.learning_rate * JCFG.anneal_lr_floor,
        TRAIN_T))


def test_schedule_of_a_scalar_count():
    """The optimizer's 0-dim int32 count gives a 0-dim float32 rate, the
    same value as in a batch of counts, and clamps at both ends."""
    sched = optim.linear_schedule(1e-3, 1e-4, 20)
    batch = sched(torch.arange(-2, 23, dtype=torch.int32))
    for i, c in enumerate(range(-2, 23)):
        got = sched(torch.tensor(c, dtype=torch.int32))
        assert got.shape == () and got.dtype == torch.float32
        assert got.item() == batch[i].item()
    assert torch.equal(batch[:2], batch[2].expand(2))
    assert torch.equal(batch[-2:], batch[-3].expand(2))


def test_schedule_refuses_steps_past_exact_float32_counts():
    """Below 2^24 steps every clamped count is a float32 integer and the
    first sum exact in float64; the schedule refuses the rest."""
    for steps in (0, 1 << 24):
        with pytest.raises(ValueError, match='transition_steps'):
            optim.linear_schedule(1e-3, 0.0, steps)
    optim.linear_schedule(1e-3, 0.0, (1 << 24) - 1)
