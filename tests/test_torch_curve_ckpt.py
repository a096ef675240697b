"""`learn/curve.py --ckpt` saves the whole PPO TrainState through
utils/checkpoint.py, as a .npz file or an orbax directory: either restores
in the port and, against a JAX template, in the JAX package
(gym_copter_tpu/utils/checkpoint.py), leaf for leaf; a path no format can
be written at raises before any training."""

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
from gym_copter_tpu.utils import checkpoint as jcheckpoint
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.core import prng, vehicles
from gym_copter_tpu_torch.core.tree import tree_leaves
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.learn import curve, ppo
from gym_copter_tpu_torch.utils import checkpoint

CPU = torch.device('cpu')
ENVS, UPDATES = 8, 2
KW = dict(rollout_steps=8, hidden=16, minibatches=2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ckpt_is_a_train_state_both_packages_restore(tmp_path):
    path = str(tmp_path / 'x.npz')
    curve.main(['--env', 'Hover3D-v0', '--envs', str(ENVS), '--updates',
                str(UPDATES), '--seeds', '0', '--rollout', '8', '--hidden',
                '16', '--minibatches', '2', '--log-every', '1', '--device',
                'cpu', '--out', str(tmp_path / 'c.json'), '--ckpt', path])

    # the port: a template of the run's structure, its optimizer scheduled
    cfg = ppo.resolve_minibatches(
        ppo.PPOConfig(**KW, entropy_coef=1e-2, learning_rate=3e-4,
                      gamma=0.995, anneal_lr_floor=0.0, target_kl=0.015),
        ENVS)
    opt = ppo.train_optimizer(cfg, UPDATES)
    assert callable(opt.learning_rate)
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    template = ppo.init_train_state(prng.PRNGKey(9, CPU), params,
                                    tasks.HOVER_3D, cfg, ENVS, opt)
    got = checkpoint.restore(path, template, opt)
    assert int(got.update_idx) == UPDATES
    for a, t in zip(tree_leaves(got), tree_leaves(template)):
        assert a.dtype == t.dtype and a.shape == t.shape

    # the JAX package: a float32 template with optax's scheduled chain
    jcfg = jppo.PPOConfig(**KW)
    jopt = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                       optax.adam(optax.linear_schedule(3e-4, 0.0, 10)))
    jtemplate = jppo.init_train_state(
        jax.random.PRNGKey(9), JEnvParams(vehicle=jvehicles.DJI_PHANTOM),
        jtasks.HOVER_3D, jcfg, ENVS, jopt, dtype=jnp.float32)
    jts = jcheckpoint.restore(path, jtemplate)
    jleaves, tleaves = jax.tree.leaves(jts), jax.tree.leaves(jtemplate)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        assert np.asarray(a).shape == np.asarray(t).shape
        assert np.asarray(a).dtype == np.asarray(t).dtype
    for a, b in zip(tree_leaves(convert.train_state_from_numpy(jts, CPU)),
                    tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ckpt_dir_is_an_orbax_checkpoint_jax_restores(tmp_path):
    """`--ckpt DIR` writes an orbax checkpoint directory (the plain zarr
    layout) that the JAX package restores against its template, leaf for
    leaf equal to what the port restores from it."""
    path = str(tmp_path / 'ckpt_dir')
    curve.main(['--env', 'Hover3D-v0', '--envs', str(ENVS), '--updates',
                str(UPDATES), '--seeds', '0', '--rollout', '8', '--hidden',
                '16', '--minibatches', '2', '--log-every', '1', '--device',
                'cpu', '--out', str(tmp_path / 'c.json'), '--ckpt', path])
    assert (tmp_path / 'ckpt_dir' / '_METADATA').is_file()
    cfg = ppo.resolve_minibatches(
        ppo.PPOConfig(**KW, entropy_coef=1e-2, learning_rate=3e-4,
                      gamma=0.995, anneal_lr_floor=0.0, target_kl=0.015),
        ENVS)
    opt = ppo.train_optimizer(cfg, UPDATES)
    template = ppo.init_train_state(
        prng.PRNGKey(9, CPU), EnvParams(vehicle=vehicles.DJI_PHANTOM),
        tasks.HOVER_3D, cfg, ENVS, opt)
    got = checkpoint.restore(path, template, opt)
    assert int(got.update_idx) == UPDATES
    jcfg = jppo.PPOConfig(**KW)
    jopt = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                       optax.adam(optax.linear_schedule(3e-4, 0.0, 10)))
    jtemplate = jppo.init_train_state(
        jax.random.PRNGKey(9), JEnvParams(vehicle=jvehicles.DJI_PHANTOM),
        jtasks.HOVER_3D, jcfg, ENVS, jopt, dtype=jnp.float32)
    jts = jcheckpoint.restore(path, jtemplate)
    for a, t in zip(jax.tree.leaves(jts), jax.tree.leaves(jtemplate)):
        assert np.asarray(a).shape == np.asarray(t).shape
        assert np.asarray(a).dtype == np.asarray(t).dtype
    for a, b in zip(tree_leaves(convert.train_state_from_numpy(jts, CPU)),
                    tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_unwritable_ckpt_raises_before_training(tmp_path):
    """A --ckpt no format can be written at (inside a file) raises before
    any training, and nothing is written."""
    (tmp_path / 'file').write_text('x')
    with pytest.raises(ValueError, match='not a writable directory'):
        curve.main(['--envs', '8', '--updates', '1', '--device', 'cpu',
                    '--out', str(tmp_path / 'c.json'),
                    '--ckpt', str(tmp_path / 'file' / 'ckpt_dir')])
    assert sorted(p.name for p in tmp_path.iterdir()) == ['file']
