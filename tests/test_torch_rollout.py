"""The port's fused rollout (gym_copter_tpu_torch/ops/fused_rollout.py)
against the JAX package's Pallas kernel and against the port's own
step-by-step path.

On the CPU the port runs the kernel's plain version.  Against the JAX
kernel in interpret mode the discrete fields (steps, status, episode,
ticks, episodes) must be equal.  x, perturb, prev_shaping and reward_sum
get a tolerance, because torch's and XLA's CPU sin/cos differ by up to one
ULP in float32: RTOL = 1e-5, ATOL = 1e-4.  Against the port's own
step-by-step path (deterministic resets) the state is equal bit for bit
and the reward sums agree to the same tolerance (the step-by-step shaping
sums squares with a reduction, the kernel in sequence).

tests/test_torch_cuda.py holds the CUDA kernel against the plain version on
the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_copter_tpu as gj
from gym_copter_tpu.core import vehicles as vj
from gym_copter_tpu.core.types import EnvParams as EnvParamsJ
from gym_copter_tpu.core.types import TaskParams as TaskParamsJ
from gym_copter_tpu.envs import base as base_j
from gym_copter_tpu.envs import tasks as tasks_j
from gym_copter_tpu.ops import pallas_rollout as pr_j

import gym_copter_tpu_torch as gt
from gym_copter_tpu_torch.compat.convert import (env_state_from_numpy,
                                                 params_from_fields)
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.envs import base as base_t
from gym_copter_tpu_torch.envs import tasks as tasks_t
from gym_copter_tpu_torch.ops import fused_rollout as fr

B = 128
RTOL, ATOL = 1e-5, 1e-4


def _params(max_steps=60, force=0.0):
    return EnvParamsJ(vehicle=vj.DJI_PHANTOM,
                      task=TaskParamsJ(initial_random_force=force,
                                       max_steps=max_steps))


def _simple_params():
    p = tasks_j._simple_lander_params()
    return p._replace(task=p.task._replace(max_steps=120))


def _mars_params():
    p = tasks_j._mars_params()
    return p._replace(task=p.task._replace(initial_random_force=0.0,
                                           max_steps=60))


# (name, spec name, JAX params, action, num_steps, pose, seed), after the
# scenarios of tests/test_pallas_rollout.py plus a random-reset and a
# blade-element case
SCENARIOS = [
    ('lander3d-truncation', 'LANDER_3D', _params(60), [1.625e-2] * 4, 150,
     None, 0),
    ('hover3d-tilt', 'HOVER_3D', _params(400), [1.66e-2] * 4, 250,
     (0.0, 0.0, 10.0, 40.0, 0.0), 0),
    ('lander3d-soft-landing', 'LANDER_3D@0.5', _params(400), [1.625e-2] * 4,
     300, None, 0),
    ('lander3d-crash', 'LANDER_3D@0.5', _params(400), [0.0] * 4, 100, None,
     0),
    ('lander1d', 'LANDER_1D', _params(50), [1.625e-2], 120, None, 0),
    ('simple-descent', 'LANDER_3D_SIMPLE', _simple_params(),
     [0.48, 0.0, 0.0], 300, None, 0),
    ('simple-free-fall', 'LANDER_3D_SIMPLE', _simple_params(),
     [-1.0, 0.0, 0.0], 300, None, 0),
    ('althold', 'ALTHOLD', _params(80), [0.1], 200, None, 0),
    ('takeoff', 'TAKEOFF', _params(80), [0.02] * 4, 200, None, 0),
    ('distance', 'DISTANCE', _params(80), [0.02] * 4, 200, None, 0),
    ('target', 'TARGET', _params(80), [0.0] * 4, 200, None, 0),
    ('target-crash', 'TARGET', _params(900), [-1.0] * 4, 250,
     (0.0, 0.0, 8.0, 0.0, 0.0), 0),
    ('lander3d-mars-blade', 'LANDER_3D', _mars_params(), [0.2] * 4, 150,
     None, 0),
    ('lander3d-random-reset', 'LANDER_3D', _params(60, force=30.0),
     [1.625e-2] * 4, 150, None, 7),
]


def _spec(tasks, name):
    if name.endswith('@0.5'):
        return getattr(tasks, name[:-4])._replace(start_altitude=0.5)
    return getattr(tasks, name)


def _jax_reset(spec, params, pose):
    state, _ = base_j.reset(jax.random.PRNGKey(0),
                            jnp.arange(B, dtype=jnp.int32),
                            jnp.zeros(B, jnp.int32), params, spec, pose=pose,
                            dtype=jnp.float32)
    return state


def _action(action, spec, device='cpu'):
    return torch.tensor(action, dtype=torch.float32,
                        device=device)[:, None].expand(spec.action_size, B)


def _assert_state(a, b, what, exact_floats):
    for name, u, v in (('steps', a.steps, b.steps),
                       ('status', a.dyn.status, b.dyn.status),
                       ('episode', a.episode, b.episode),
                       ('ticks', a.dyn.ticks, b.dyn.ticks)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                      err_msg=f'{what}: {name}')
    for name, u, v in (('x', a.dyn.x, b.dyn.x),
                       ('perturb', a.dyn.perturb, b.dyn.perturb)):
        if exact_floats:
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                          err_msg=f'{what}: {name}')
        else:
            np.testing.assert_allclose(np.asarray(u), np.asarray(v),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f'{what}: {name}')
    np.testing.assert_allclose(np.asarray(a.prev_shaping),
                               np.asarray(b.prev_shaping), rtol=RTOL,
                               atol=ATOL, err_msg=f'{what}: prev_shaping')


def _assert_totals(a, b, what):
    np.testing.assert_array_equal(np.asarray(a['episodes']),
                                  np.asarray(b['episodes']),
                                  err_msg=f'{what}: episodes')
    np.testing.assert_allclose(np.asarray(a['reward_sum']),
                               np.asarray(b['reward_sum']), rtol=RTOL,
                               atol=ATOL, err_msg=f'{what}: reward_sum')


@pytest.mark.parametrize('scenario', SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_fused_rollout_parity(scenario):
    """One scenario three ways: the JAX kernel in interpret mode, the
    port's plain fused rollout, and (with deterministic resets) the port's
    step-by-step path."""
    what, spec_name, params_j, action, num_steps, pose, seed = scenario
    spec_j, spec_t = _spec(tasks_j, spec_name), _spec(tasks_t, spec_name)
    params_t = params_from_fields(params_j)
    state_j = _jax_reset(spec_j, params_j, pose)
    action_j = jnp.broadcast_to(jnp.asarray(action, jnp.float32)[:, None],
                                (spec_j.action_size, B))
    out_j, tot_j = pr_j.fused_rollout(state_j, action_j, num_steps, params_j,
                                      spec_j, seed=seed, interpret=True)

    state_t = env_state_from_numpy(state_j, device='cpu')
    out_t, tot_t = fr.fused_rollout(state_t, _action(action, spec_t),
                                    num_steps, params_t, spec_t, seed=seed)
    _assert_state(out_t, out_j, f'{what} vs JAX', exact_floats=False)
    _assert_totals(tot_t, tot_j, f'{what} vs JAX')
    assert int(tot_t['episodes'].min()) >= 1  # every scenario resets

    if seed == 0:
        key = prng.PRNGKey(0, 'cpu')
        env_ids = torch.arange(B, dtype=torch.int32)
        out_s, tot_s = fr.scan_rollout(state_t, _action(action, spec_t), key,
                                       env_ids, num_steps, params_t, spec_t)
        _assert_state(out_t, out_s, f'{what} vs scan', exact_floats=True)
        _assert_totals(tot_t, tot_s, f'{what} vs scan')


def test_random_reset_seed_changes_kicks():
    """The kick hash is live: another seed changes the trajectory, and the
    rollout still finishes episodes."""
    params = params_from_fields(_params(60, force=30.0))
    spec = tasks_t.LANDER_3D
    state, _ = base_t.reset(prng.PRNGKey(0, 'cpu'),
                            torch.arange(B, dtype=torch.int32),
                            torch.zeros(B, dtype=torch.int32), params, spec)
    action = _action([1.625e-2] * 4, spec)
    out7, tot7 = fr.fused_rollout(state, action, 150, params, spec, seed=7)
    out8, _ = fr.fused_rollout(state, action, 150, params, spec, seed=8)
    assert int(tot7['episodes'].min()) >= 1
    assert not torch.equal(out7.dyn.x, out8.dyn.x)


def test_kick_u01_matches_jax():
    n = 1 << 14
    eid = np.arange(n, dtype=np.int32)
    ep = np.random.default_rng(0).integers(0, 1 << 20, n).astype(np.int32)
    for salt in (0, 7, 123, -5):
        for ax in pr_j._KICK_AXIS:
            want = np.asarray(pr_j._kick_u01(jnp.asarray(eid), jnp.asarray(ep),
                                             jnp.int32(salt), ax,
                                             jnp.float32))
            got = fr._kick_u01(torch.from_numpy(eid), torch.from_numpy(ep),
                               salt, ax, torch.float32).numpy()
            np.testing.assert_array_equal(got, want)


def test_unsupported_spec_and_batch_raise():
    params = params_from_fields(_params())
    key = prng.PRNGKey(0, 'cpu')
    state, _ = base_t.reset(key, torch.arange(B, dtype=torch.int32),
                            torch.zeros(B, dtype=torch.int32), params,
                            tasks_t.TARGET)
    bogus = tasks_t.TARGET._replace(kind='nope')
    with pytest.raises(ValueError, match='fused-kernel family'):
        fr.fused_rollout(state, torch.zeros((4, B)), 10, params, bogus)
    state96, _ = base_t.reset(key, torch.arange(96, dtype=torch.int32),
                              torch.zeros(96, dtype=torch.int32), params,
                              tasks_t.LANDER_3D)
    with pytest.raises(ValueError, match='multiple of'):
        fr.fused_rollout(state96, torch.zeros((4, 96)), 10, params,
                         tasks_t.LANDER_3D)


def test_copter_env_fused_rollout_handle():
    """env.fused_rollout reports the path it took: the kernel for every
    task kind at a batch of 128, the step-by-step path otherwise; each
    agrees with the JAX handle."""
    params_j = _params(max_steps=30)
    params_t = params_from_fields(params_j)
    for name, b, action, num_steps, path in (
            ('Hover3D-v0', B, 1.66e-2, 90, 'fused'),
            ('Target-v0', B, 0.0, 40, 'fused'),
            ('Hover3D-v0', 16, 1.66e-2, 40, 'scan')):
        env_t = gt.make(name, num_envs=b, params=params_t, device='cpu')
        env_j = gj.make(name, num_envs=b, params=params_j)
        st_t, _ = env_t.reset()
        st_j, _ = env_j.reset()
        _, tot_t = env_t.fused_rollout(
            st_t, torch.full((4, b), action), num_steps)
        _, tot_j = env_j.fused_rollout(
            st_j, jnp.full((4, b), action, jnp.float32), num_steps)
        assert tot_t['path'] == tot_j['path'] == path
        assert tot_t['episodes'].shape == (b,)
        np.testing.assert_array_equal(tot_t['episodes'].numpy(),
                                      np.asarray(tot_j['episodes']))
    assert int(tot_t['episodes'].min()) >= 1


def test_make_defaults_to_the_card():
    """With no device, make() runs on the card, and without one it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert gt.make('Lander3D-v0').device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            gt.make('Lander3D-v0')


@pytest.mark.parametrize('sm_count', (1, 66, 114, 132))
def test_lanes_for_keeps_the_warps_per_scheduler_budget(sm_count):
    """lanes_for gives the most lanes per env whose threads make at most
    WARPS_PER_SCHEDULER warps per warp scheduler (4 per SM), and 1 when
    even that does not fit."""
    budget = fr.WARPS_PER_SCHEDULER * fr.SCHEDULERS_PER_SM * sm_count * 32
    for b in (1, 31, 128, 1000, 1024, 4096, 4099, budget // 4,
              budget // 4 + 1, budget // 2, budget, budget + 1, 65536):
        lanes = fr.lanes_for(b, sm_count)
        assert lanes in fr.LANES_PER_ENV
        if lanes > 1:
            assert lanes * b <= budget
        bigger = [n for n in fr.LANES_PER_ENV if n > lanes]
        assert all(n * b > budget for n in bigger)
    if sm_count == 132:
        assert [fr.lanes_for(b, 132) for b in (
            1024, 4096, 8192, 12288, 16384, 65536)] == [4, 4, 4, 4, 1, 1]
