"""The port's float64 numpy oracle (gym_copter_tpu_torch/compat/
numpy_oracle.py) against the JAX package's (gym_copter_tpu/compat/
numpy_oracle.py): bit for bit on the same inputs, for every variant and
both seeding modes; and the port's float64 CPU env against the port's
oracle, as tests/test_env_parity.py holds the JAX env against JAX's."""

import numpy as np
import pytest
import torch

from gym_copter_tpu.compat import numpy_oracle as joracle
from gym_copter_tpu.core import vehicles as jvehicles
from gym_copter_tpu.core.types import EnvParams as JEnvParams
from gym_copter_tpu.envs import tasks as jtasks
from gym_copter_tpu_torch.compat import numpy_oracle as oracle
from gym_copter_tpu_torch.core import prng, vehicles
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import base, tasks

CPU = torch.device('cpu')
PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
JPARAMS = JEnvParams(vehicle=jvehicles.DJI_PHANTOM)

# the motor maps of tests/test_env_parity.py, by action size
ORACLE_MOTOR_MAPS = {
    1: lambda m: [m[0]] * 4,
    2: lambda m: [m[0], m[1], m[1], m[0]],
    3: lambda m: [m[0] - m[1] - m[2], m[0] + m[1] + m[2],
                  m[0] + m[1] - m[2], m[0] - m[1] + m[2]],
    4: lambda m: m,
}

VARIANTS = ['Lander1D-v0', 'Lander2D-v0', 'Lander3D-v0', 'Hover1D-v0',
            'Hover2D-v0', 'Hover3D-v0', 'Lander3DMars-v0']


def _params(name):
    port = tasks.PRESET_PARAMS.get(name)
    jax_ = jtasks.PRESET_PARAMS.get(name)
    return (port() if port else PARAMS), (jax_() if jax_ else JPARAMS)


def make_oracle(module, params, spec):
    return module.OracleEnv(params, task_kind=spec.kind,
                            obs_indices=spec.obs_indices,
                            action_size=spec.action_size,
                            motor_map=ORACLE_MOTOR_MAPS[spec.action_size])


@pytest.mark.parametrize('legacy', [False, True])
@pytest.mark.parametrize('name', VARIANTS)
def test_port_oracle_equals_jax_oracle(name, legacy):
    """400 steps of scripted actions from the same reset: the global
    np.random draw (legacy, reset(seed=)) or an injected force; every
    observation, reward and done flag equal bit for bit, through a
    touchdown where one happens."""
    spec = tasks.ALL_TASKS[name]
    params, jparams = _params(name)
    ours = make_oracle(oracle, params, spec)
    ref = make_oracle(joracle, jparams, spec)
    rng = np.random.default_rng(len(name) + 10 * legacy)
    if legacy:
        kw = {'seed': len(name)}
    else:
        force = np.zeros(6)
        force[:3] = rng.uniform(-30, 30, 3)
        kw = {'perturb_force': force}
    o_obs, _ = ours.reset(**kw)
    r_obs, _ = ref.reset(**kw)
    np.testing.assert_array_equal(o_obs, r_obs)
    actions = rng.uniform(0, 0.05, (400, spec.action_size))
    for t in range(400):
        o = ours.step(actions[t])
        r = ref.step(actions[t])
        np.testing.assert_array_equal(o[0], r[0], err_msg=f'step {t}')
        assert o[1:4] == r[1:4], f'step {t}'
        assert ours.dyn.status == ref.dyn.status
        if o[2]:
            break


@pytest.mark.parametrize('name', VARIANTS[:6])
def test_port_env_matches_port_oracle(name):
    """The port's float64 CPU env from the same injected reset force,
    stepped with the same scripted actions: observations and rewards
    within 1e-9 (the CPU's 1-ULP sin/cos gap), done flags equal, until
    the episode ends."""
    spec = tasks.ALL_TASKS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    force = np.zeros(6)
    force[:3] = rng.uniform(-30, 30, 3)
    ours = make_oracle(oracle, PARAMS, spec)
    o_obs, _ = ours.reset(perturb_force=force)
    key = prng.PRNGKey(0, CPU)
    ids = torch.zeros(1, dtype=torch.int32)
    state, obs = base.reset(key, ids, torch.zeros(1, dtype=torch.int32),
                            PARAMS, spec, perturb_force=force[:, None],
                            dtype=torch.float64)
    np.testing.assert_allclose(obs[:, 0].numpy(), o_obs, rtol=1e-12,
                               atol=1e-12)
    actions = rng.uniform(0, 0.05, (400, spec.action_size))
    for t in range(400):
        o_obs, o_rew, o_done, _, _ = ours.step(actions[t])
        state, ts = base.step(state, torch.from_numpy(actions[t][:, None]),
                              key, ids, PARAMS, spec)
        assert bool(ts.done[0]) == o_done, f'{name} step {t}'
        np.testing.assert_allclose(float(ts.reward[0]), o_rew, rtol=1e-9,
                                   atol=1e-9, err_msg=f'{name} step {t}')
        if o_done:
            break
        np.testing.assert_allclose(ts.obs[:, 0].numpy(), o_obs, rtol=1e-9,
                                   atol=1e-9, err_msg=f'{name} step {t}')
