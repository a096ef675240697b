"""The port's checkpoint (gym_copter_tpu_torch/utils/checkpoint.py) against
the JAX package's (gym_copter_tpu/utils/checkpoint.py), in both formats
(.npz files and orbax directories): a resumed step is bit-equal to an
uninterrupted one, checkpoints cross between the packages both ways, the
save is atomic, and a killed run resumes bit for bit in a new process (the
port's mirror of tests/test_kill_resume.py)."""

import json
import os
import subprocess
import sys
from pathlib import Path

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
from gym_copter_tpu_torch.learn import optim, ppo
from gym_copter_tpu_torch.utils import checkpoint, zstd

PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
JPARAMS = JEnvParams(vehicle=jvehicles.DJI_PHANTOM)
CPU = torch.device('cpu')
KW = dict(rollout_steps=8, minibatches=2, epochs=2, hidden=16)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(optimizer=None, num_envs=8):
    cfg = ppo.PPOConfig(**KW)
    step, opt = ppo.make_train_step(PARAMS, tasks.HOVER_3D, cfg,
                                    prng.PRNGKey(0, CPU),
                                    torch.arange(num_envs, dtype=torch.int32),
                                    optimizer=optimizer)
    ts = ppo.init_train_state(prng.PRNGKey(1, CPU), PARAMS, tasks.HOVER_3D,
                              cfg, num_envs, opt)
    return step, opt, ts


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_step_matches_jax(ts, opt, jts, jstep):
    """One port step from `ts` (restored from JAX's checkpoint `jts`)
    against JAX's jitted step from `jts`, to the float64 PPO tolerance of
    tests/test_torch_ppo.py (rtol 1e-9, atol 1e-12 of each leaf's largest
    element), with a constant rate or a schedule: the port rounds the
    schedule as JAX's jitted step does.  Returns JAX's next state."""
    step, _ = ppo.make_train_step(PARAMS, tasks.HOVER_3D, ppo.PPOConfig(**KW),
                                  prng.PRNGKey(0, CPU),
                                  torch.arange(8, dtype=torch.int32),
                                  optimizer=opt)
    port_next, m = step(ts)
    jnext, jm = jstep(jts)
    for a, b in zip(tree_leaves(port_next),
                    tree_leaves(convert.train_state_from_numpy(jnext, CPU))):
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                       atol=1e-12 * float(b.abs().max()))
        else:
            assert torch.equal(a, b)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    return jnext


@pytest.mark.parametrize('scheduled', [False, True])
def test_resumed_step_equals_uninterrupted(tmp_path, scheduled):
    """Two steps, save, restore: the restored state equals the saved one
    and the step after it equals the uninterrupted step, bit for bit, with
    a constant learning rate and a schedule (whose count is a leaf)."""
    opt = (optim.ClipAdam(0.5, optim.linear_schedule(1e-3, 1e-4, 20))
           if scheduled else None)
    step, opt, ts = _port(opt)
    for _ in range(2):
        ts, _ = step(ts)
    path = str(tmp_path / 'ckpt.npz')
    checkpoint.save(path, ts, opt)
    restored = checkpoint.restore(path, ts, opt)
    _assert_equal(restored, ts)
    assert int(restored.update_idx) == 2
    cont, m_cont = step(ts)
    res, m_res = step(restored)
    _assert_equal(res, cont)
    assert all(torch.equal(m_cont[k], m_res[k]) for k in m_cont)


@pytest.mark.parametrize('scheduled', [False, True])
def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path, scheduled):
    """A float64 JAX TrainState saved by the JAX package restores in the
    port equal to its conversion, and one port step from it matches JAX's
    step (`_assert_step_matches_jax`); saved by the port, it restores in
    the JAX package with JAX's dtypes and values, and a JAX step from it
    equals the step from the original."""
    jcfg = jppo.PPOConfig(**KW)
    jopt = None
    opt = optim.ClipAdam(jcfg.max_grad_norm, jcfg.learning_rate)
    if scheduled:
        jopt = optax.chain(optax.clip_by_global_norm(0.5),
                           optax.adam(optax.linear_schedule(1e-3, 1e-4, 20)))
        opt = optim.ClipAdam(0.5, optim.linear_schedule(1e-3, 1e-4, 20))
    jstep, jopt = jppo.make_train_step(JPARAMS, jtasks.HOVER_3D, jcfg,
                                       jax.random.PRNGKey(0),
                                       jnp.arange(8, dtype=jnp.int32),
                                       optimizer=jopt)
    jstep = jax.jit(jstep)
    jts = jppo.init_train_state(jax.random.PRNGKey(1), JPARAMS,
                                jtasks.HOVER_3D, jcfg, 8, jopt,
                                dtype=jnp.float64)
    jts, _ = jstep(jts)
    jpath = str(tmp_path / 'jax.npz')
    jcheckpoint.save(jpath, jts)
    want = convert.train_state_from_numpy(jts, CPU)
    got = checkpoint.restore(jpath, want, opt)
    _assert_equal(got, want)
    _assert_step_matches_jax(got, opt, jts, jstep)

    path = str(tmp_path / 'port.npz')
    checkpoint.save(path, got, opt)
    back = jcheckpoint.restore(path, jts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    next_a, _ = jstep(back)
    next_b, _ = jstep(jts)
    for a, b in zip(jax.tree.leaves(next_a), jax.tree.leaves(next_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_failed_save_leaves_the_old_file_whole(tmp_path, monkeypatch):
    """A save that fails while writing leaves the earlier checkpoint as it
    was and no temporary file; a path neither format can take (a file
    where an orbax directory would go) raises and is left as it was."""
    step, opt, ts = _port()
    path = tmp_path / 'ckpt.npz'
    checkpoint.save(str(path), ts, opt)
    before = path.read_bytes()
    ts2, _ = step(ts)

    def broken(f, **arrays):
        f.write(b'half a checkpoint')
        raise OSError('disk full')

    monkeypatch.setattr(np, 'savez', broken)
    with pytest.raises(OSError, match='disk full'):
        checkpoint.save(str(path), ts2, opt)
    assert path.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ['ckpt.npz']
    monkeypatch.undo()
    _assert_equal(checkpoint.restore(str(path), ts, opt), ts)
    taken = tmp_path / 'ckpt_dir'  # a file where a directory would go
    taken.write_text('not a checkpoint')
    with pytest.raises(ValueError, match='orbax'):
        checkpoint.save(str(taken), ts, opt)
    assert taken.read_text() == 'not a checkpoint'



@pytest.mark.parametrize('scheduled', [False, True])
def test_orbax_resumed_step_equals_uninterrupted(tmp_path, scheduled):
    """The same resume through an orbax directory: the restored state
    equals the saved one and the next step is bit-equal."""
    opt = (optim.ClipAdam(0.5, optim.linear_schedule(1e-3, 1e-4, 20))
           if scheduled else None)
    step, opt, ts = _port(opt)
    for _ in range(2):
        ts, _ = step(ts)
    path = str(tmp_path / 'ckpt')
    checkpoint.save(path, ts, opt)
    assert (tmp_path / 'ckpt' / '_METADATA').is_file()
    restored = checkpoint.restore(path, ts, opt)
    _assert_equal(restored, ts)
    cont, m_cont = step(ts)
    res, m_res = step(restored)
    _assert_equal(res, cont)
    assert all(torch.equal(m_cont[k], m_res[k]) for k in m_cont)


@pytest.mark.parametrize('scheduled', [False, True])
def test_jax_orbax_checkpoint_restores_in_the_port_and_back(tmp_path,
                                                            scheduled):
    """A float64 JAX TrainState saved by the JAX package as an orbax
    (OCDBT) directory restores in the port equal to its conversion, and
    one port step from it matches JAX's step from the same checkpoint
    (`_assert_step_matches_jax`); saved
    by the port as a directory, it restores in the JAX package with JAX's
    dtypes and values, and a JAX step from it equals the step from the
    original."""
    jcfg = jppo.PPOConfig(**KW)
    jopt = None
    opt = optim.ClipAdam(jcfg.max_grad_norm, jcfg.learning_rate)
    if scheduled:
        jopt = optax.chain(optax.clip_by_global_norm(0.5),
                           optax.adam(optax.linear_schedule(1e-3, 1e-4, 20)))
        opt = optim.ClipAdam(0.5, optim.linear_schedule(1e-3, 1e-4, 20))
    jstep, jopt = jppo.make_train_step(JPARAMS, jtasks.HOVER_3D, jcfg,
                                       jax.random.PRNGKey(0),
                                       jnp.arange(8, dtype=jnp.int32),
                                       optimizer=jopt)
    jstep = jax.jit(jstep)
    jts = jppo.init_train_state(jax.random.PRNGKey(1), JPARAMS,
                                jtasks.HOVER_3D, jcfg, 8, jopt,
                                dtype=jnp.float64)
    jts, _ = jstep(jts)
    jpath = str(tmp_path / 'jax_dir')
    jcheckpoint.save(jpath, jts)
    assert json.loads(Path(jpath, '_METADATA').read_text())['use_ocdbt']
    want = convert.train_state_from_numpy(jts, CPU)
    got = checkpoint.restore(jpath, want, opt)
    _assert_equal(got, want)

    jnext = _assert_step_matches_jax(got, opt, jts, jstep)

    path = str(tmp_path / 'port_dir')
    checkpoint.save(path, got, opt)
    back = jcheckpoint.restore(path, jts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    next_a, _ = jstep(back)
    for a, b in zip(jax.tree.leaves(next_a), jax.tree.leaves(jnext)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_failed_orbax_save_leaves_the_old_directory_whole(tmp_path,
                                                          monkeypatch):
    """An orbax save that fails while writing leaves the earlier
    checkpoint directory restorable as it was and no temporary directory;
    a later save replaces it."""
    step, opt, ts = _port()
    path = tmp_path / 'ckpt'
    checkpoint.save(str(path), ts, opt)
    ts2, _ = step(ts)

    def broken(data):
        raise OSError('disk full')

    monkeypatch.setattr(zstd, 'compress', broken)
    with pytest.raises(OSError, match='disk full'):
        checkpoint.save(str(path), ts2, opt)
    assert sorted(os.listdir(tmp_path)) == ['ckpt']
    monkeypatch.undo()
    _assert_equal(checkpoint.restore(str(path), ts, opt), ts)
    checkpoint.save(str(path), ts2, opt)
    _assert_equal(checkpoint.restore(str(path), ts2, opt), ts2)
    assert sorted(os.listdir(tmp_path)) == ['ckpt']

WORKER = r'''
import json, sys

import torch

from gym_copter_tpu_torch.core import prng, vehicles
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.learn import ppo
from gym_copter_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
mode, ckpt_path, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
cfg = ppo.PPOConfig(rollout_steps=8, minibatches=2, epochs=2, hidden=16)
step, opt = ppo.make_train_step(PARAMS, tasks.HOVER_3D, cfg,
                                prng.PRNGKey(0, 'cpu'),
                                torch.arange(16, dtype=torch.int32))
ts = ppo.init_train_state(prng.PRNGKey(1, 'cpu'), PARAMS, tasks.HOVER_3D,
                          cfg, 16, opt)
log = []
if mode == 'uninterrupted':
    for i in range(5):
        ts, m = step(ts)
        if i >= 3:
            log.append({k: float(v) for k, v in m.items()})
elif mode == 'train_and_die':
    for i in range(3):
        ts, m = step(ts)
    checkpoint.save(ckpt_path, ts, opt)
elif mode == 'resume':
    ts = checkpoint.restore(ckpt_path, ts, opt)
    assert int(ts.update_idx) == 3
    for i in range(2):
        ts, m = step(ts)
        log.append({k: float(v) for k, v in m.items()})
with open(out_path, 'w') as f:
    json.dump(log, f)
'''


def _run(mode, ckpt, out, tmp_path):
    worker = tmp_path / 'worker.py'
    worker.write_text(WORKER)
    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    r = subprocess.run([sys.executable, str(worker), mode, ckpt, out],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as f:
        return json.load(f)


def test_kill_and_resume_continues_identically(tmp_path):
    """Process U trains 5 updates; process A trains 3, checkpoints and
    exits; process B restores and trains 2: B's metrics equal U's last two
    bit for bit."""
    ckpt = str(tmp_path / 'ckpt.npz')
    expected = _run('uninterrupted', ckpt, str(tmp_path / 'u.json'),
                    tmp_path)
    _run('train_and_die', ckpt, str(tmp_path / 'a.json'), tmp_path)
    assert os.path.exists(ckpt)
    resumed = _run('resume', ckpt, str(tmp_path / 'b.json'), tmp_path)
    assert len(expected) == len(resumed) == 2
    assert expected == resumed
