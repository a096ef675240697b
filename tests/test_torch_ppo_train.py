"""The port's PPO training loop (gym_copter_tpu_torch.learn.ppo.train) on
the CPU: the short-run and keep_best tests of tests/test_ppo.py mirrored on
the port, and the learning-curve script.  Each evaluation is 999 eager env
steps at 1024 envs (~5 s here), so the mirrors evaluate at fewer updates
than the JAX tests do; what they assert is the same."""

import json

import numpy as np
import pytest
import torch

from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.envs.registry import default_params
from gym_copter_tpu_torch.learn import curve, ppo

CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the driver runs several test workers at once, and
    torch's default of one thread per core makes them spin against each
    other on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hover3d_short_training_keeps_flying():
    """15 updates at 64 envs: losses finite, mostly surviving, the update
    count carried (evaluated at updates 0 and 14, where the JAX test
    evaluates every update)."""
    ts, hist = ppo.train('Hover3D-v0', num_envs=64, num_updates=15,
                         cfg=ppo.PPOConfig(rollout_steps=64),
                         log_every=14, callback=lambda i, m: None,
                         device=CPU)
    assert [i for i, _ in hist] == [0, 14]
    last = hist[-1][1]
    assert np.isfinite(last['pg_loss']) and np.isfinite(last['v_loss'])
    assert last['reward_per_step'] > 0.0
    assert int(ts.update_idx) == 15


def test_keep_best_returns_best_evaluated_policy():
    """train(keep_best=True) hands back the policy whose deterministic eval
    is the best of the curve: re-evaluated, the same return (rtol 1e-6; the
    eager CPU evaluation is deterministic).  Evaluated at updates 0, 4 and
    7 (the JAX test: every update)."""
    cfg = ppo.PPOConfig(rollout_steps=16, hidden=16, learning_rate=3e-3)
    ts, hist = ppo.train('Hover3D-v0', num_envs=32, num_updates=8, seed=2,
                         cfg=cfg, log_every=4, keep_best=True,
                         callback=lambda i, m: None, device=CPU)
    assert [i for i, _ in hist] == [0, 4, 7]
    best_curve = max(m['eval_return'] for _, m in hist)
    evaluate = ppo.make_eval_fn(default_params(), tasks.HOVER_3D, cfg,
                                num_envs=ppo.EVAL_NUM_ENVS, device=CPU)
    got = float(evaluate(ts.params)[0])
    np.testing.assert_allclose(got, best_curve, rtol=1e-6)


def test_curve_script_writes_the_schema(tmp_path):
    """learn/curve.py with scripts/train_curve.py's JSON schema, one update
    of one seed on the CPU."""
    out = tmp_path / 'curve.json'
    curve.main(['--env', 'Hover3D-v0', '--envs', '16', '--updates', '1',
                '--seeds', '0', '--rollout', '4', '--hidden', '8',
                '--log-every', '1', '--device', 'cpu', '--out', str(out)])
    summary = json.loads(out.read_text())
    assert {'env', 'seeds', 'env_steps_per_seed', 'config',
            'final_window_mean_across_seeds', 'final_window_spread',
            'runs', 'device'} <= set(summary)
    run = summary['runs'][0]
    assert [c['update'] for c in run['curve']] == [0]
    assert set(ppo.METRICS) | {'eval_return', 'update'} == set(
        run['curve'][0])
    assert summary['env_steps_per_seed'] == 64
    assert summary['config']['minibatches'] == 4
    assert summary['device'] == {'type': 'cpu', 'card': None,
                                 'torch': torch.__version__}
