"""The Mars presets on the port (blade-element lift, the Ingenuity vehicle):
the mirror of tests/test_mars.py's hover anchor, and one float64 PPO train
step on Lander3DMars-v0 against the JAX package's.  The Mars learning smoke
of test_mars.py runs on the card, graphed, in tests/test_torch_cuda.py
(`test_mars_ppo_smoke_on_the_card`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu.envs import tasks as jtasks
from gym_copter_tpu.learn import ppo as jppo
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.control.heuristics import hover_motor_value
from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.envs import base, tasks
from gym_copter_tpu_torch.learn import ppo

CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (see test_torch_neuroevolution.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_blade_element_hover_value_balances_gravity():
    """Mirror: 100 steps of Hover3D at the blade-element hover anchor, no
    reset kick, leave the Mars vehicle at 10 m and not sinking; the
    Bouabdallah formula on the same vehicle is a wrong anchor (> 10 %
    off)."""
    params = tasks.PRESET_PARAMS['Hover3DMars-v0']()
    hover = hover_motor_value(params)
    assert 0.0 < hover < 1.0
    b = 8
    p0 = params._replace(task=params.task._replace(initial_random_force=0.0))
    key = prng.PRNGKey(0, CPU)
    ids = torch.arange(b, dtype=torch.int32)
    state, _ = base.reset(key, ids, torch.zeros(b, dtype=torch.int32), p0,
                          tasks.HOVER_3D)
    action = torch.full((4, b), hover)
    for _ in range(100):
        state, ts = base.step(state, action, key, ids, p0, tasks.HOVER_3D)
    np.testing.assert_allclose(ts.x[C.STATE_Z].numpy(), -10.0, atol=0.05)
    np.testing.assert_allclose(ts.x[C.STATE_Z_DOT].numpy(), 0.0, atol=0.02)
    wrong = hover_motor_value(params._replace(lift_model='bouabdallah'))
    assert abs(wrong - hover) / hover > 0.10


def test_mars_train_step_matches_jax_float64():
    """One float64 PPO train step on Lander3DMars-v0 (8 rollout steps, 16
    envs, 4 epochs x 2 minibatches, the recipe of the Mars learning smoke's
    gamma and rate) from the same JAX init: params and Adam moments within
    rtol 1e-9 (measured 3.7e-13 of each tensor's largest value, metrics
    8.5e-14 relative), env state within 1e-12 (measured 5.6e-17), the
    discrete fields and the key equal."""
    kw = dict(rollout_steps=8, hidden=32, minibatches=2, epochs=4,
              gamma=0.995, learning_rate=1e-3, anneal_lr=False)
    jparams = jtasks.PRESET_PARAMS['Lander3DMars-v0']()
    params = tasks.PRESET_PARAMS['Lander3DMars-v0']()
    assert params.lift_model == jparams.lift_model == 'blade_element'
    jcfg = jppo.PPOConfig(**kw)
    jstep, jopt = jppo.make_train_step(jparams, jtasks.LANDER_3D, jcfg,
                                       jax.random.PRNGKey(0),
                                       jnp.arange(16, dtype=jnp.int32))
    jts = jppo.init_train_state(jax.random.PRNGKey(3), jparams,
                                jtasks.LANDER_3D, jcfg, 16, jopt,
                                dtype=jnp.float64)
    want_ts, want_m = jax.jit(jstep)(jts)
    step, _ = ppo.make_train_step(params, tasks.LANDER_3D,
                                  ppo.PPOConfig(**kw), prng.PRNGKey(0, CPU),
                                  torch.arange(16, dtype=torch.int32))
    got_ts, got_m = step(convert.train_state_from_numpy(jts, CPU))
    want = convert.train_state_from_numpy(want_ts, CPU)
    for a, b in zip(got_ts.params.leaves() + got_ts.opt_state.mu
                    + got_ts.opt_state.nu,
                    want.params.leaves() + want.opt_state.mu
                    + want.opt_state.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(b.abs().max()))
    np.testing.assert_allclose(got_ts.env_state.dyn.x.numpy(),
                               want.env_state.dyn.x.numpy(), rtol=0,
                               atol=1e-12)
    for a, b in ((got_ts.env_state.dyn.status, want.env_state.dyn.status),
                 (got_ts.env_state.steps, want.env_state.steps),
                 (got_ts.key, want.key)):
        assert torch.equal(a, b)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(got_m[k]), float(v), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
