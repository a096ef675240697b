"""The port's expert policies (gym_copter_tpu_torch/control/heuristics.py)
against the JAX package's (gym_copter_tpu/control/heuristics.py): each of
the eight PID_POLICIES from the same observations step for step, and the
Lander3D and Hover3D experts' closed loops with the env."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu.control import heuristics as jheur
from gym_copter_tpu.core import vehicles as jvehicles
from gym_copter_tpu.core.types import EnvParams as JEnvParams
from gym_copter_tpu.envs import base as jbase
from gym_copter_tpu.envs import tasks as jtasks
from gym_copter_tpu_torch.control import heuristics
from gym_copter_tpu_torch.core import vehicles
from gym_copter_tpu_torch.core.tree import tree_leaves
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import tasks

CPU = torch.device('cpu')
PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
JPARAMS = JEnvParams(vehicle=jvehicles.DJI_PHANTOM)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (see test_torch_neuroevolution.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_policy_table_and_constant_thrust():
    """The same env ids map to the same experts; constant_thrust returns
    MOTORVAL on every motor and keeps its (absent) state."""
    assert list(heuristics.PID_POLICIES) == list(jheur.PID_POLICIES)
    for name, fn in heuristics.PID_POLICIES.items():
        assert fn.__name__ == jheur.PID_POLICIES[name].__name__
    state, policy = heuristics.constant_thrust(4, 8, device=CPU)
    state, act = policy(state, torch.zeros((10, 8)))
    assert state is None and act.shape == (4, 8)
    assert bool((act == heuristics.MOTORVAL).all())
    assert heuristics._mixer_scale(PARAMS) == jheur._mixer_scale(JPARAMS)


@pytest.mark.parametrize('env_name', list(heuristics.PID_POLICIES))
def test_expert_matches_jax_step_for_step(env_name):
    """20 steps of the expert from the same float64 observations of 32
    lanes (some angular rates above the 40 deg/s reset), its state threaded
    on both sides: actions and states equal to 1e-15 (measured: bit-equal),
    with the mixer scaled for the default vehicle."""
    spec = tasks.ALL_TASKS[env_name]
    b = 32
    rng = np.random.default_rng(len(env_name))
    state, policy = heuristics.PID_POLICIES[env_name](
        b, torch.float64, params=PARAMS, device=CPU)
    jstate, jpolicy = jheur.PID_POLICIES[env_name](b, jnp.float64,
                                                   params=JPARAMS)
    for _ in range(20):
        obs = rng.normal(size=(spec.obs_size, b))
        state, act = policy(state, torch.from_numpy(obs))
        jstate, jact = jpolicy(jstate, jnp.asarray(obs))
        assert act.shape == (spec.action_size, b)
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=0,
                                   atol=1e-15)
    for a, c in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-15)


def _jax_closed_loop(env_name, b, steps, seed):
    """The JAX expert and env over `steps` float64 steps, as test_pid.py
    runs them: (first-episode totals, done flags, end states)."""
    spec = jtasks.ALL_TASKS[env_name]
    key = jax.random.PRNGKey(seed)
    ids = jnp.arange(b, dtype=jnp.int32)
    state, obs = jbase.reset(key, ids, jnp.zeros(b, jnp.int32), JPARAMS,
                             spec, dtype=jnp.float64)
    ps, policy = jheur.PID_POLICIES[env_name](b, jnp.float64, params=JPARAMS)

    def body(carry, _):
        st, ps, obs, total, done_seen, end_x = carry
        ps, action = policy(ps, obs)
        st, ts = jbase.step(st, action, key, ids, JPARAMS, spec)
        end_x = jnp.where(ts.done & ~done_seen, ts.x, end_x)
        total = total + jnp.where(done_seen, 0.0, ts.reward)
        return (st, ps, ts.obs, total, done_seen | ts.done, end_x), None

    init = (state, ps, obs, jnp.zeros(b, jnp.float64), jnp.zeros(b, bool),
            jnp.zeros((12, b), jnp.float64))
    out, _ = jax.lax.scan(body, init, None, length=steps)
    return out[3:]


# the simple lander's PD loop amplifies any difference: in JAX alone, a
# 1e-17 rad nudge of the start roll moves its return by 17; so the CPU's
# 1-ULP sin/cos gap between torch and XLA grows from 1e-13 at step 50 to
# 1e-9 at step 150 and to the measured end-of-episode gap below
# (seed 5, 4 envs: totals 1.454, end states 2.105, the touchdown dZ)
CLOSED_LOOP_ATOL = {'Lander3DSimple-v0': (1.5, 2.2)}


@pytest.mark.parametrize('env_name,seed', [
    ('Lander3D-v0', 0), ('Hover3D-v0', 1), ('Lander1D-v0', 2),
    ('Lander2D-v0', 3), ('Lander-v0', 4), ('Lander3DSimple-v0', 5),
    ('Hover1D-v0', 6), ('Hover2D-v0', 7)])
def test_closed_loop_matches_jax(env_name, seed):
    """`run_expert` (eager on the CPU) against the JAX expert and env over
    1000 float64 steps of 4 envs, through the end of every first episode
    (the Hover tasks end at their 1000-step cap): done flags equal, totals
    and end states within 1e-9 (Lander3DSimple: within its measured gap,
    and within 1e-9 over its first 100 steps)."""
    atol_total, atol_x = CLOSED_LOOP_ATOL.get(env_name, (1e-9, 1e-9))
    if env_name in CLOSED_LOOP_ATOL:
        run = heuristics.run_expert(env_name, 4, 100, params=PARAMS,
                                    seed=seed, dtype=torch.float64,
                                    device=CPU)
        jrun = _jax_closed_loop(env_name, 4, 100, seed)
        np.testing.assert_allclose(run.total.numpy(), np.asarray(jrun[0]),
                                   rtol=0, atol=1e-9)
    run = heuristics.run_expert(env_name, 4, 1000, params=PARAMS, seed=seed,
                                dtype=torch.float64, device=CPU)
    total, done_seen, end_x = _jax_closed_loop(env_name, 4, 1000, seed)
    assert run.done_seen.all(), 'every episode must end within 1000 steps'
    np.testing.assert_array_equal(run.done_seen.numpy(),
                                  np.asarray(done_seen))
    np.testing.assert_allclose(run.total.numpy(), np.asarray(total),
                               rtol=0, atol=atol_total)
    np.testing.assert_allclose(run.end_x.numpy(), np.asarray(end_x),
                               rtol=0, atol=atol_x)
