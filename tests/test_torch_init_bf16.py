"""The port's PPO starts where the JAX package's starts: `init_params`,
`init_train_state` and a whole `train` run from the same seed against
gym_copter_tpu/learn/ppo.py, with no parameters carried across.  (The bf16
products are held against JAX's in tests/test_torch_ppo.py,
`test_bf16_matmul_close_to_f32`.)"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_copter_tpu.core import vehicles as jvehicles
from gym_copter_tpu.core.types import EnvParams as JEnvParams
from gym_copter_tpu.envs import tasks as jtasks
from gym_copter_tpu.learn import ppo as jppo
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.core import prng, vehicles
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.learn import optim, ppo

CPU = torch.device('cpu')
DTYPES = {'float32': (torch.float32, jnp.float32),
          'float64': (torch.float64, jnp.float64)}
# largest gap to JAX's initial parameters: the threefry normal is within a
# few ULP of JAX's and the QR is another LAPACK's; measured 4.7e-6 in
# float32 (on the square hidden x hidden layers at hidden 128; 1.2e-6 at
# hidden 16) and 6.0e-15 in float64
INIT_ATOL = {'float32': 1e-5, 'float64': 1e-13}
# the small recipe of tests/test_torch_ppo.py's converted-params steps
SMALL = dict(rollout_steps=8, hidden=16, minibatches=2, epochs=4,
             learning_rate=1e-2, anneal_lr=False, target_kl=1e9)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_params_close(got, jparams, atol):
    want = convert.ppo_params_from_numpy(jparams, CPU)
    for a, b in zip(got.leaves(), want.leaves(), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('hidden', [16, 128])
@pytest.mark.parametrize('obs_size', [10, 12])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_init_params_match_jax(seed, obs_size, hidden, dtype):
    """init_params(PRNGKey(s)) against JAX's init_params(PRNGKey(s)), leaf
    by leaf, to INIT_ATOL; the orthogonal layers stay orthogonal."""
    tdt, jdt = DTYPES[dtype]
    cfg = dict(hidden=hidden)
    got = ppo.init_params(prng.PRNGKey(seed, CPU), obs_size, 4,
                          ppo.PPOConfig(**cfg), tdt)
    want = jppo.init_params(jax.random.PRNGKey(seed), obs_size, 4,
                            jppo.PPOConfig(**cfg), jdt)
    _assert_params_close(got, want, INIT_ATOL[dtype])
    # contiguous, as collectives and checkpoints need them
    assert all(p.is_contiguous() for p in got.leaves())
    w = got.critic[1].w
    eye = torch.eye(hidden, dtype=tdt)
    torch.testing.assert_close(w @ w.T / 2, eye, rtol=0,
                               atol=1e-5 if tdt == torch.float32 else 1e-12)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_init_train_state_matches_jax(dtype):
    """init_train_state against JAX's from the same key: params to
    INIT_ATOL, the optimizer state, the float env state and obs to
    rounding, and the discrete env fields, the step key and update_idx
    exactly."""
    tdt, jdt = DTYPES[dtype]
    jcfg = jppo.PPOConfig(hidden=16)
    jopt = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                       optax.adam(jcfg.learning_rate))
    jts = jppo.init_train_state(
        jax.random.PRNGKey(5), JEnvParams(vehicle=jvehicles.DJI_PHANTOM),
        jtasks.LANDER_3D, jcfg, 16, jopt, env_id_offset=32, dtype=jdt)
    cfg = ppo.PPOConfig(hidden=16)
    opt = optim.ClipAdam(cfg.max_grad_norm, cfg.learning_rate)
    ts = ppo.init_train_state(
        prng.PRNGKey(5, CPU), EnvParams(vehicle=vehicles.DJI_PHANTOM),
        tasks.LANDER_3D, cfg, 16, opt, env_id_offset=32, dtype=tdt)
    want = convert.train_state_from_numpy(jts, CPU)
    _assert_params_close(ts.params, jts.params, INIT_ATOL[dtype])
    assert torch.equal(ts.key, want.key)
    assert int(ts.update_idx) == int(want.update_idx) == 0
    assert int(ts.opt_state.count) == int(want.opt_state.count)
    for xs, ys in ((ts.opt_state.mu, want.opt_state.mu),
                   (ts.opt_state.nu, want.opt_state.nu)):
        for a, b in zip(xs, ys, strict=True):
            assert torch.equal(a, b)
    np.testing.assert_allclose(ts.obs.numpy(), want.obs.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.env_state.dyn.x.numpy(),
                               want.env_state.dyn.x.numpy(), rtol=1e-6,
                               atol=1e-6)
    for name in ('status', 'ticks'):
        assert torch.equal(getattr(ts.env_state.dyn, name),
                           getattr(want.env_state.dyn, name))
    assert torch.equal(ts.env_state.steps, want.env_state.steps)
    assert torch.equal(ts.env_state.episode, want.env_state.episode)


def test_train_matches_jax_from_the_same_seed():
    """ppo.train('Hover3D-v0', 16 envs, 2 updates, seed 0) against JAX's
    train with the same arguments, each from its own initial parameters:
    every logged metric, eval_return included, to rtol 1e-4 / atol 1e-6
    (test_torch_ppo.py's float32 Hover3D step; measured 1.1e-5 relative on
    pg_loss, 0 on the rewards and returns), the final parameters to 1e-5
    (measured 1.3e-6), the key exactly."""
    jhist, hist = [], []
    jts, _ = jppo.train('Hover3D-v0', num_envs=16, num_updates=2, seed=0,
                        cfg=jppo.PPOConfig(**SMALL),
                        callback=lambda i, m: jhist.append((i, m)))
    ts, _ = ppo.train('Hover3D-v0', num_envs=16, num_updates=2, seed=0,
                      cfg=ppo.PPOConfig(**SMALL),
                      callback=lambda i, m: hist.append((i, m)), device=CPU)
    assert [i for i, _ in hist] == [i for i, _ in jhist] == [0, 1]
    for (_, m), (_, jm) in zip(hist, jhist):
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    want = convert.train_state_from_numpy(jts, CPU)
    for a, b in zip(ts.params.leaves(), want.params.leaves(), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert torch.equal(ts.key, want.key)
    assert int(ts.update_idx) == int(want.update_idx) == 2
