"""The port's Gymnasium adapter (gym_copter_tpu_torch/compat/gym_adapter.py
over compat/single.py): the mirror of tests/test_gym_adapter.py on the
`GymCopterTorch/<Name>` ids with device='cpu', and, in place of the
reference replay (which needs the reference checkout), the port's adapter
held against the JAX package's (gym_copter_tpu/compat/gym_adapter.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium as gym

from gym_copter_tpu.compat.gym_adapter import GymCopterEnv as JGymCopterEnv
from gym_copter_tpu_torch.compat.gym_adapter import (GymCopterEnv,
                                                     GymCopterVisualEnv)
from gym_copter_tpu_torch.compat.single import SingleCopterEnv
from gym_copter_tpu_torch.envs import tasks

CPU = 'cpu'
ALL_IDS = sorted(tasks.ALL_TASKS)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('name', ALL_IDS)
def test_check_env_conformance(name):
    """gymnasium's env checker over every registered id."""
    from gymnasium.utils.env_checker import check_env
    env = gym.make(f'GymCopterTorch/{name}', device=CPU).unwrapped
    check_env(env, skip_render_check=True)
    env.close()


def test_gymnasium_make_random_agent_episode():
    """A random-agent loop through gymnasium.make, as the reference's
    external learners drive it (attic/drl/3dtest.py:62-105)."""
    env = gym.make('GymCopterTorch/Lander-v0', device=CPU)
    obs, info = env.reset(seed=7)
    assert obs.shape == (10,) and obs.dtype == np.float32
    steps, done = 0, False
    while not done and steps < 1200:
        obs, reward, terminated, truncated, info = env.step(
            env.action_space.sample())
        done = terminated or truncated
        steps += 1
    assert done, 'episode must terminate under the registry step cap'
    env.close()


def test_external_style_learner_loop():
    """Hill-climbing over a constant motor value for several episodes."""
    env = GymCopterEnv('Lander1D-v0', device=CPU)

    def run_episode(motor):
        env.reset()
        total = 0.0
        for _ in range(500):
            _, r, term, trunc, _ = env.step(np.array([motor], np.float32))
            total += r
            if term or trunc:
                break
        return total

    returns = {m: run_episode(m) for m in (0.0, 1.2e-2, 1.625e-2, 2.0e-2)}
    assert max(returns, key=returns.get) != 0.0
    env.close()


@pytest.mark.parametrize('seed', [3, 99])
def test_legacy_seeding_matches_jax_adapter(seed):
    """The float64 `legacy_seeding` adapters of both packages, from the
    same global np.random seed and action stream (the reference-replay
    test's): the same done step, observations and rewards within 1e-9
    (the CPU's 1-ULP sin/cos gap)."""
    ours = GymCopterEnv('Lander-v0', legacy_seeding=True,
                        dtype=torch.float64, device=CPU)
    ref = JGymCopterEnv('Lander-v0', legacy_seeding=True, dtype=jnp.float64)
    o_obs, _ = ours.reset(seed=seed)
    r_obs, _ = ref.reset(seed=seed)
    np.testing.assert_array_equal(o_obs, r_obs)
    rng = np.random.default_rng(seed)
    for t in range(1000):
        action = (np.full(4, 1.625e-2) if t % 2 == 0
                  else rng.uniform(0, 0.05, 4))
        o_obs, o_rew, o_done, _, _ = ours.step(action)
        r_obs, r_rew, r_done, _, _ = ref.step(action)
        assert o_done == r_done, f'step {t}'
        np.testing.assert_allclose(o_obs, r_obs, rtol=1e-9, atol=1e-9,
                                   err_msg=f'step {t}')
        np.testing.assert_allclose(o_rew, r_rew, rtol=1e-9, atol=1e-9,
                                   err_msg=f'step {t}')
        if o_done:
            break
    assert o_done, 'the episode must end within 1000 steps'
    # the next legacy reset draws the same kick from the shared stream
    np.random.seed(seed + 1)
    o_obs, _ = ours.reset()
    np.random.seed(seed + 1)
    r_obs, _ = ref.reset()
    np.testing.assert_array_equal(o_obs, r_obs)


@pytest.mark.parametrize('seed', [0, 5])
def test_default_seeding_gives_jax_perturbation(seed):
    """reset(seed=s) in default seeding rekeys the threefry stream: the
    same reset kick as the JAX adapter's, and a second episode's too."""
    ours = GymCopterEnv('Lander3D-v0', device=CPU)
    ref = JGymCopterEnv('Lander3D-v0')
    for kw in ({'seed': seed}, {}):
        ours.reset(**kw)
        ref.reset(**kw)
        np.testing.assert_array_equal(ours._state.dyn.perturb.numpy(),
                                      np.asarray(ref._state.dyn.perturb))


def test_set_altitude_changes_start_pose():
    env = GymCopterEnv('Lander-v0', device=CPU)
    obs, _ = env.reset(perturb=False)
    assert obs[4] == pytest.approx(-10.0)  # NED z at the default 10 m
    handle_before = env._env
    env.set_altitude(25.0)
    obs, _ = env.reset(perturb=False)
    assert obs[4] == pytest.approx(-25.0)
    assert env._env is handle_before


def test_visual_env_produces_images():
    env = GymCopterVisualEnv('Lander-v0', res=16, device=CPU)
    env.reset(perturb=False)
    frames = []
    for _ in range(5):
        _, _, term, _, _ = env.step(np.full(4, 1.625e-2, np.float32))
        assert env.image.shape == (16, 16)
        frames.append(env.image.copy())
        if term:
            break
    assert any(f.any() for f in frames), 'pad must be visible from 10 m'
    env.close()


def test_visual_env_dvs_events():
    env = GymCopterVisualEnv('Lander-v0', dvs=True, res=16, device=CPU)
    env.reset(perturb=False)
    env.step(np.zeros(4, np.float32))  # first frame: no events
    assert not env.image.any()
    for _ in range(30):  # free fall: the pad grows
        _, _, term, _, _ = env.step(np.zeros(4, np.float32))
        if term:
            break
    assert set(np.unique(env.image)).issubset({-1.0, 0.0, 1.0})
    env.close()


def test_registry_ids_all_resolve():
    for name in ALL_IDS:
        assert f'GymCopterTorch/{name}' in gym.registry
        assert f'GymCopterTpu/{name}' in gym.registry


def test_step_returns_terminal_observation():
    """On the done step, step() returns the TERMINAL observation
    (reference task.py:133), not the auto-reset episode's."""
    env = GymCopterEnv('Lander3DSimple-v0', device=CPU)
    obs, _ = env.reset(seed=0)
    start_z = float(obs[4])
    for _ in range(600):
        obs, _, done, _, _ = env.step(np.array([-1.0, 0.0, 0.0]))
        if done:
            break
    assert done, 'free fall should crash'
    np.testing.assert_allclose(float(obs[4]), float(env.pose[2]), rtol=1e-6)
    assert abs(float(obs[4]) - start_z) > 1.0
    env.close()


def test_single_env_needs_no_gymnasium_and_refuses_cpu_graphs():
    """SingleCopterEnv is the same env without the spaces; a graphed step
    needs the card."""
    env = SingleCopterEnv('Hover1D-v0', device=CPU)
    obs, _ = env.reset(seed=1)
    assert obs.shape == (2,) and env.STATE_NAMES == ['Z', 'dZ']
    assert env.FRAMES_PER_SECOND == 100
    with pytest.raises(ValueError, match='CUDA'):
        SingleCopterEnv('Hover1D-v0', device=CPU, graphed=True)
