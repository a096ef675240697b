"""The port's env-batch data parallelism (gym_copter_tpu_torch/parallel/,
learn/ppo.py with `group=`) on 1, 2 and 4 gloo ranks on the CPU, against
the one-rank layout, the unsharded port step and the JAX package's step on
its 8-device CPU mesh (as tests/test_sharding.py builds it), in float64.

One world per size runs every case (tests/torch_dist_cases.py): the sharded
fused rollout with and without random resets, the first rollout of a
sharded PPO step, and two sharded train steps with the `target_kl` guard
off and tripping at the first minibatch."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from gym_copter_tpu.core import vehicles as jvehicles
from gym_copter_tpu.core.types import EnvParams as JEnvParams
from gym_copter_tpu.envs import tasks as jtasks
from gym_copter_tpu.learn import ppo as jppo
from gym_copter_tpu.parallel import sharding as jsh
from gym_copter_tpu_torch.compat import convert
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.tree import tree_leaves
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.learn import ppo
from gym_copter_tpu_torch.ops.fused_rollout import fused_rollout
from gym_copter_tpu_torch.parallel import launch, sharding

JPARAMS = JEnvParams(vehicle=jvehicles.DJI_PHANTOM)
CPU = torch.device('cpu')
NUM_ENVS, STEPS = 16, 2
CONFIGS = [dict(rollout_steps=8, hidden=16, minibatches=2, epochs=2,
                learning_rate=1e-2, anneal_lr=False, target_kl=target_kl)
           for target_kl in (0.0, 1e-12)]
WORLDS = (1, 2, 4)
# largest difference, relative to each tensor's largest value, of the
# parameters and Adam moments after 2 steps, measured at W = 2 and 4: 2.1e-15
# against the unsharded port step (0 at W = 1), 2.7e-15 against the JAX mesh
REL = 1e-10


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def start():
    """The JAX package's float64 initial TrainState and the port's copy."""
    jcfg = jppo.PPOConfig(**CONFIGS[0])
    _, jopt = jppo.make_train_step(JPARAMS, jtasks.HOVER_3D, jcfg,
                                   jax.random.PRNGKey(0),
                                   jnp.arange(NUM_ENVS, dtype=jnp.int32))
    jts = jppo.init_train_state(jax.random.PRNGKey(7), JPARAMS,
                                jtasks.HOVER_3D, jcfg, NUM_ENVS, jopt,
                                dtype=jnp.float64)
    return jts, convert.train_state_from_numpy(jts, CPU)


@pytest.fixture(scope='module', params=WORLDS, ids=lambda w: f'W{w}')
def world(request, start):
    """(W, every rank's results)."""
    torch.set_num_threads(1)
    w = request.param
    return w, launch.spawn(cases.ppo_world, w, 'gloo', 'cpu',
                           (start[1], CONFIGS, STEPS), timeout_s=300)


@pytest.fixture(scope='module')
def unsharded(start):
    """For each config: the unsharded port's first rollout, and its state
    and metrics after STEPS steps."""
    ts0 = start[1]
    out = []
    for kw in CONFIGS:
        step, _ = ppo.make_train_step(
            cases.PARAMS, tasks.HOVER_3D, ppo.PPOConfig(**kw),
            prng.PRNGKey(0, CPU), torch.arange(NUM_ENVS, dtype=torch.int32))
        traj = step.rollout(ts0.params.leaves(), ts0.env_state, ts0.obs,
                            ts0.key, 8)[3]
        ts, metrics = ts0, []
        for _ in range(STEPS):
            ts, m = step(ts)
            metrics.append(m)
        out.append({'traj': traj, 'ts': ts, 'metrics': metrics})
    return out


@pytest.fixture(scope='module')
def jax_mesh(start):
    """For each config, the JAX package's TrainState after STEPS steps on
    the 8-device mesh, in the port's layout."""
    mesh = jsh.make_mesh(jax.devices()[:8])
    out = []
    for kw in CONFIGS:
        jstep, _ = jppo.make_train_step(
            JPARAMS, jtasks.HOVER_3D, jppo.PPOConfig(**kw),
            jax.random.PRNGKey(0), jnp.arange(NUM_ENVS, dtype=jnp.int32))
        jts = start[0]
        jts = jppo.TrainState(
            params=jsh.replicate(jts.params, mesh),
            opt_state=jsh.replicate(jts.opt_state, mesh),
            env_state=jsh.shard_env_state(jts.env_state, mesh),
            obs=jsh.shard_env_state(jts.obs, mesh), key=jts.key,
            update_idx=jts.update_idx)
        step = jax.jit(jstep)
        for _ in range(STEPS):
            jts, _ = step(jts)
        out.append(convert.train_state_from_numpy(jts, CPU))
    return out


def _learner(ts):
    return ts.params.leaves() + ts.opt_state.mu + ts.opt_state.nu


def _max_rel(got, want):
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(_learner(got), _learner(want)))


@pytest.mark.parametrize('case', [0, 1], ids=['random-resets',
                                              'deterministic'])
def test_sharded_fused_rollout_equals_one_rank(world, case):
    """Every rank's gathered fused rollout (512 Lander3D envs, 24-step
    episodes, 64 steps) equals the one-rank layout's bit for bit: state
    and totals, with random reset kicks and without."""
    w, results = world
    force = cases.FORCES[case]
    ids = torch.arange(cases.ROLLOUT_ENVS, dtype=torch.int32)
    want_state, want = fused_rollout(
        cases.fused_state(ids, force), cases.fused_action(len(ids)),
        cases.ROLLOUT_STEPS, cases.rollout_params(force), tasks.LANDER_3D,
        seed=7, env_ids=ids)
    assert int(want['episodes'].min()) >= 2
    for r in results:
        state, totals = r['fused'][case]
        for k in want:
            assert torch.equal(totals[k], want[k]), k
        for a, b in zip(tree_leaves(state),
                        tree_leaves(want_state)):
            assert torch.equal(a, b)


def test_first_rollout_is_columns_of_the_unsharded(world, unsharded):
    """The first rollout of a sharded PPO step (noise drawn over the global
    shape, resets keyed by global id) is bit-equal to the same columns of
    the unsharded rollout."""
    w, results = world
    want = unsharded[0]['traj']
    for r, res in enumerate(results):
        lo, hi = sharding.env_columns(NUM_ENVS, r, w)
        for a, b in zip(res['ppo'][0]['traj'], want):
            assert torch.equal(a, b[..., lo:hi])


@pytest.mark.parametrize('config', [0, 1], ids=['guard-off', 'guard-trips'])
def test_params_bit_identical_across_ranks(world, config):
    """After two steps every rank holds the same parameters, Adam state and
    metrics, bit for bit; with the guard tripping at the first minibatch,
    every rank took exactly that one optimizer step per update."""
    w, results = world
    first = results[0]['ppo'][config]
    for res in results[1:]:
        got = res['ppo'][config]
        for a, b in zip(_learner(got['ts']), _learner(first['ts'])):
            assert torch.equal(a, b)
        assert torch.equal(got['ts'].key, first['ts'].key)
        for m, n in zip(got['metrics'], first['metrics']):
            for k in m:
                assert torch.equal(m[k], n[k]), k
    count = int(first['ts'].opt_state.count)
    assert count == (2 if config == 1 else 2 * 2 * 2)


@pytest.mark.parametrize('config', [0, 1], ids=['guard-off', 'guard-trips'])
def test_sharded_step_matches_unsharded_and_jax_mesh(world, unsharded,
                                                     jax_mesh, config):
    """After two steps the sharded parameters and Adam moments are within
    1e-10 of each tensor's largest value of the unsharded port step (equal
    at W = 1) and of the JAX step on its 8-device mesh (measured: 2.1e-15
    and 2.7e-15); the
    metrics are the global ones; the shard's env state is its columns of
    the unsharded one."""
    w, results = world
    got = results[0]['ppo'][config]
    want = unsharded[config]
    assert _max_rel(got['ts'], want['ts']) <= (0.0 if w == 1 else REL)
    assert _max_rel(got['ts'], jax_mesh[config]) <= REL
    assert torch.equal(got['ts'].key, jax_mesh[config].key)
    for m, n in zip(got['metrics'], want['metrics']):
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(n[k]), rtol=1e-10,
                                       atol=1e-14, err_msg=k)
    for r, res in enumerate(results):
        lo, hi = sharding.env_columns(NUM_ENVS, r, w)
        es = res['ppo'][config]['ts'].env_state
        assert torch.equal(es.dyn.status, want['ts'].env_state.dyn.status[
            lo:hi])
        np.testing.assert_allclose(es.dyn.x.numpy(),
                                   want['ts'].env_state.dyn.x[:, lo:hi]
                                   .numpy(), rtol=1e-10, atol=1e-12)


def test_layout_checks():
    """A batch the world does not divide, a minibatch that does not split
    in equal shares, and global ids of the wrong length raise; a gloo step
    refuses to be graphed."""
    with pytest.raises(ValueError, match='multiple of the world'):
        sharding.env_columns(10, 0, 4)
    ids = torch.arange(128, dtype=torch.int32)
    state = cases.fused_state(ids, 0.0)
    with pytest.raises(ValueError, match='global id'):
        sharding.sharded_fused_rollout(state, cases.fused_action(128), 4,
                                       cases.rollout_params(0.0),
                                       tasks.LANDER_3D, env_ids=ids[:64])


def test_gloo_world_refuses_graphs_and_odd_shares(world):
    """A graphed step raises in a gloo world (a CUDA graph cannot capture
    gloo's collectives); minibatches of 3 transitions (16 envs x 3 steps /
    16) do not split in equal shares on 2 or 4 ranks and raise."""
    w, results = world
    for res in results:
        assert 'gloo' in res['errors'][0]
        assert len(res['errors']) == (1 if w == 1 else 2)
        if w > 1:
            assert 'equal shares' in res['errors'][1]


def test_train_on_two_ranks_matches_one():
    """`ppo.train(..., group=)` on 2 gloo ranks (float32, one update): both
    ranks end with the same parameters, within 1e-5 of each leaf's largest
    value of the unsharded `train`; rank 0 evaluates and its history
    (metrics and eval return) matches the unsharded one to 1e-4, rank 1's
    is empty."""
    kw = dict(CONFIGS[0], learning_rate=3e-4)
    (h0, p0), (h1, p1) = launch.spawn(cases.train_world, 2, 'gloo', 'cpu',
                                      (kw,), timeout_s=300)
    want_ts, want = ppo.train('Hover3D-v0', num_envs=16, num_updates=1,
                              cfg=ppo.PPOConfig(**kw),
                              callback=lambda i, m: None, device=CPU)
    assert h1 == [] and [i for i, _ in h0] == [i for i, _ in want] == [0]
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    for a, b in zip(p0, want_ts.params.leaves()):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    for (_, m), (_, n) in zip(h0, want):
        for k in n:
            np.testing.assert_allclose(m[k], n[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_launch_reports_a_two_rank_run(capsys):
    """`python -m gym_copter_tpu_torch.parallel.launch` on 2 gloo ranks of
    the CPU (a small PPO config): every shard stepped and finished
    episodes, the totals equal the one-rank layout, the ranks agree on the
    parameters, and rank 0's report is one JSON line."""
    report = launch.run(2, 'gloo', 'cpu', envs_per_rank=128, updates=1,
                        ppo_kw=CONFIGS[0])
    assert report['processes'] == 2 and report['global_envs'] == 256
    assert report['update_idx'] == 1 and not report['graphed']
    assert report['totals_equal_one_rank'] and \
        report['params_equal_across_ranks']
    for shard in report['per_shard']:
        assert shard['envs'] == 128 and shard['episodes'] >= 128
    assert report['env_steps_per_sec'] > 0
    json.dumps(report)
