"""The learning gate of tests/test_ppo.py on the port's PPO, on the CPU."""

import pytest
import torch

from gym_copter_tpu_torch.learn import ppo


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the driver runs several test workers at once, and
    torch's default of one thread per core makes them spin against each
    other on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lander1d_actually_learns():
    """On the densely shaped 1-D lander a short deterministic CPU run must
    raise the deterministic-eval return from the free-fall baseline (~ -200)
    past +100: the proof that the port's gradient path improves the policy.
    The JAX test's recipe (256 envs x 64 steps x 80 updates, seed 3, so
    the JAX test's own initial parameters), evaluated at updates 0, 40 and
    79 (the JAX test: every 20th); measured -202.8, 84.8, 157.1 here."""
    cfg = ppo.PPOConfig(rollout_steps=64, hidden=32, gamma=0.995)
    vals = []
    ppo.train('Lander1D-v0', num_envs=256, num_updates=80, seed=3, cfg=cfg,
              log_every=40, callback=lambda i, m: vals.append(m['eval_return']),
              device=torch.device('cpu'))
    first, best = vals[0], max(vals)
    assert len(vals) == 3
    assert first < -100, f'free-fall baseline should be ~-200, got {first}'
    assert best > 100, f'no learning: best eval {best:.1f} from {first:.1f}'
