"""The plain reference against the measured package's plain paths at a
tiny size on the CPU: the same inputs give the same bits."""

import numpy as np
import torch

from port_bench import program
from port_bench.loops import fused as fused_loop
from port_bench.harness import Manifest
from port_bench.reference import env as E
from port_bench.reference import fused as F
from port_bench.reference import ppo as R
from port_bench.reference import prng
from port_bench.tests.tiny import CELLS, SEED

M = Manifest()
CPU = torch.device('cpu')


def _config(name, cell):
    config = M.config(name)
    for k, v in CELLS[cell]['config'].items():
        config[k] = {**config[k], **v} if isinstance(v, dict) else v
    return config


def test_draws_equal_the_package():
    from gym_copter_tpu_torch.core import prng as P

    key = prng.PRNGKey(SEED, CPU)
    assert torch.equal(key, P.PRNGKey(SEED, 'cpu'))
    assert torch.equal(prng.split(key, 3), P.split(key, 3))
    ids = torch.arange(5, dtype=torch.int32)
    assert torch.equal(prng.uniform(prng.fold_in(key, ids), 3, -30.0, 30.0),
                       P.uniform(P.fold_in(key, ids), 3, -30.0, 30.0))
    assert torch.equal(prng.normal(key, (4, 7)), P.normal(key, (4, 7)))
    assert torch.equal(prng.permutation(key, 3000),
                       P.permutation(key, 3000))


def test_env_steps_equal_the_package():
    from gym_copter_tpu_torch.envs import base

    for name in ('lander3d', 'hover3d'):
        config = M.config(name)
        task = E.params_from_config(config)
        params, spec = program.env_params(config), program.task_spec(config)
        key = prng.PRNGKey(SEED, CPU)
        ids = torch.arange(32, dtype=torch.int32)
        ep = torch.arange(32, dtype=torch.int32) * 7
        state, obs = E.reset(key, ids, ep, task)
        p_state, p_obs = base.reset(key, ids, ep, params, spec)
        assert torch.equal(obs, p_obs)
        gen = torch.Generator().manual_seed(SEED)
        for _ in range(300):
            action = torch.rand((4, 32), generator=gen) * 0.7
            state, obs, reward, done = E.step(state, action, key, ids, task)
            p_state, ts = base.step(p_state, action, key, ids, params, spec)
            assert torch.equal(obs, ts.obs) and torch.equal(reward,
                                                            ts.reward)
            assert torch.equal(done, ts.done)
            for a, b in zip(state.dyn + tuple(state[1:]),
                            p_state.dyn + tuple(p_state[1:])):
                assert torch.equal(a, b)


def test_train_steps_equal_the_package():
    from port_bench.loops import train

    config = _config('lander3d', 'lander3d.ppo')
    task, recipe = E.params_from_config(config), R.recipe_from_config(config)
    inputs = R.initial_state(task, recipe, SEED, config['num_envs'], CPU)
    leaves, env_state, obs, key, base_key, ids = inputs
    ctx = type('Ctx', (), {'config': config, 'device': CPU})()
    port = train.Port(ctx, task, recipe, inputs)
    ref = R.TrainStep(task, recipe, base_key, ids)
    s = R.State(leaves, R.adam_init(leaves), env_state, obs, key)
    for _ in range(3):
        s, rm = ref(s)
        assert port() == rm.tolist()
    for a, b in zip(port.leaves(), s.leaves):
        assert torch.equal(a, b)
    opt = port.ts.opt_state
    for a, b in zip(opt.mu + opt.nu, s.opt.mu + s.opt.nu):
        assert torch.equal(a, b)


def test_initial_state_repeats_from_the_seed():
    config = _config('hover3d', 'hover3d.ppo')
    task, recipe = E.params_from_config(config), R.recipe_from_config(config)
    a = R.initial_state(task, recipe, SEED, 16, CPU)
    b = R.initial_state(task, recipe, SEED, 16, CPU)
    c = R.initial_state(task, recipe, SEED + 1, 16, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert not torch.equal(a[0][0], c[0][0])
    w = a[0][2]  # the actor's hidden layer: orthogonal at gain sqrt 2
    assert torch.allclose(w @ w.T, 2 * torch.eye(w.shape[0]), atol=1e-5)


def test_fused_rollout_equals_the_package():
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    config = M.config('lander3d')
    task = E.params_from_config(config)
    state, ids, salt = fused_loop.start_state(task, SEED, 128, CPU)
    action = torch.full((4, 128), 0.01625)
    want = F.rollout(state, ids, action, 1200, salt, task)
    got_state, totals = fr.fused_rollout(
        program.env_state(state), action, 1200, program.env_params(config),
        program.task_spec(config), seed=salt, env_ids=ids)
    got = (got_state.dyn.x, got_state.dyn.perturb, got_state.dyn.status,
           got_state.dyn.ticks, got_state.steps, got_state.prev_shaping,
           got_state.episode, totals['reward_sum'], totals['episodes'])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[8].sum()) >= 128  # episodes end and reset


def test_single_env_equals_the_package():
    from gym_copter_tpu_torch.compat.single import SingleCopterEnv
    from port_bench.loops import single

    config = M.config('lander3d')
    task = E.params_from_config(config)
    env = SingleCopterEnv('Lander3D-v0', params=program.env_params(config),
                          seed=SEED, device='cpu')
    rng = np.random.default_rng(3)
    for episode in range(2):
        obs0, _ = env.reset()
        actions, steps = [], []
        while not steps or not steps[-1][2]:
            a = (0.01625 * rng.standard_normal(4)).astype(np.float32)
            obs, r, d, _, _ = env.step(a)
            actions.append(a)
            steps.append((obs, r, d))
        replayed = single.replay(task, SEED, episode, actions, CPU)
        assert single.gaps((obs0, steps), replayed) == (0.0, 0.0, 0)
