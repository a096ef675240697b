"""The port on the card: its CUDA kernels against their plain PyTorch
versions, and every graphed, sharded or card-only path against its eager,
one-rank, CPU or recorded counterpart.

Every test here is marked `cuda` and skips where there is no CUDA device.
The file imports nothing of JAX, so it also runs on a machine without it;
there, skip the repo's conftest (which sets JAX up):

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The kernel cases are in tests/torch_cuda_cases.py (which `chip_smoke.py`
also uses): every task kind, with and without random resets, Lander3D at
4096 envs, and batches that are not a multiple of 128 or of 8, each at
every lanes-per-env choice (1, 4).
Kernel and plain version must agree bit for bit in every field; so must
the optimizer's kernel (ops/csrc/clip_adam.cu) and the env step's
(ops/csrc/env_step.cu) and their plain versions.  The PPO, sharding,
checkpoint, profiling, evolution, adaptive, expert, adapter, visual-env,
demo and launcher tests after them hold the graphed paths against their
eager, one-rank or CPU counterparts on the card, and the learners to the
thresholds and records of the JAX package's tests.
"""

import contextlib
import io
import json
import math
import signal
from pathlib import Path

import pytest
import torch

import gym_copter_tpu_torch as gt
from gym_copter_tpu_torch.control import heuristics
from gym_copter_tpu_torch.control.heuristics import MOTORVAL
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.core import vehicles
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.envs.registry import CopterEnv
from gym_copter_tpu_torch.ops import fused_rollout as fr
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.tree import tree_map
from gym_copter_tpu_torch.learn import optim, ppo
from torch_cuda_cases import (FIXTURE, FLOOR_SCHEDULE, MAIN_B,
                              RECIPE_SCHEDULE, clip_adam_case,
                              clip_adam_mismatches, compare, env_step_cases,
                              env_step_mismatches, env_step_setup,
                              env_step_shard_mismatches, fixture_mismatches,
                              fixture_record, fixture_template,
                              launch_hosts,
                              ppo_leaf_shapes, reset_state, run_kernel,
                              scenarios, schedule_mismatches, state_diff,
                              state_tensors, train_state_to)

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = scenarios()
ENV_STEP_CASES = env_step_cases()
GRAPHED_ENV_STEP_CASES = [c for c in ENV_STEP_CASES
                          if c[3] in (1, 4099) and c[4] == 'ends']
_plain = {}


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('lanes', fr.LANES_PER_ENV)
@pytest.mark.parametrize('scenario', SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_kernel_matches_plain(scenario, lanes):
    """The kernel at every lanes-per-env choice against the plain version
    (computed once per scenario); below 4096 envs every env finishes an
    episode."""
    device = _card()
    what, spec, params, action, num_steps, pose, seed, b = scenario
    state = reset_state(params, spec, b, device, pose=pose)
    act = torch.tensor(action, dtype=torch.float32,
                       device=device)[:, None].expand(-1, b)
    launches = fr.fused_rollout.launches
    kernel = run_kernel(state, act, num_steps, params, spec, seed, lanes)
    torch.cuda.synchronize()
    assert fr.fused_rollout.launches == launches + 1
    if what not in _plain:
        _plain[what] = fr.fused_rollout_reference(state, act, num_steps,
                                                  params, spec, seed=seed)
    assert compare(kernel, _plain[what], f'{what} L={lanes}') == 0.0
    if b < MAIN_B:
        assert int(kernel[1]['episodes'].min()) >= 1


@pytest.mark.cuda
def test_sincosf_equals_sinf_and_cosf_on_every_float():
    """The kernel's sincosf gives sinf's and cosf's bits on all 2**32
    float32 values."""
    assert fr.sincos_mismatches(_card()) == 0


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    device = _card()
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    spec = tasks.LANDER_3D
    action = torch.zeros((4, 128), device=device)
    state64 = reset_state(params, spec, 128, device)
    state64 = state64._replace(
        dyn=state64.dyn._replace(x=state64.dyn.x.double()))
    with pytest.raises(ValueError, match='float32'):
        fr.fused_rollout(state64, action, 10, params, spec)
    state = reset_state(params, spec, 128, device)
    strided = state._replace(dyn=state.dyn._replace(
        x=torch.cat([state.dyn.x, state.dyn.x], dim=1)[:, ::2]))
    with pytest.raises(ValueError, match='contiguous'):
        fr.fused_rollout(strided, action, 10, params, spec)
    launches = fr.fused_rollout.launches
    with pytest.raises(ValueError, match='same CUDA device'):
        fr.fused_rollout(state._replace(steps=state.steps.cpu()), action, 10,
                         params, spec)
    arrays, u, c = fr._prepare(state, action, params, spec, None)
    with pytest.raises(ValueError, match='lanes must be one of'):
        fr._rollout_cuda(arrays, u, 10, 0, c, lanes=8)
    assert fr.fused_rollout.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize('case', ENV_STEP_CASES,
                         ids=[c[0] for c in ENV_STEP_CASES])
def test_env_step_kernel_matches_plain(case):
    """`envs/base.step` on the card (one launch of ops/csrc/env_step.cu
    per step) against `step_reference` on the card, torch.equal in every
    field of the state and the TimeStep at every step: every registry id,
    float32 and float64, 1, 4096 and 4099 envs, under actions that end
    every episode, end none, or fly into the ground."""
    from gym_copter_tpu_torch.envs import base

    device = _card()
    _, name, dtype, b, regime = case
    launches = base.step_kernel.launches
    bad, dones, ended, _ = env_step_mismatches(name, dtype, b, regime,
                                               device, offset=1000)
    assert bad == []
    assert base.step_kernel.launches == launches + len(dones)
    if regime == 'ends':
        assert ended
    if regime == 'none':
        assert sum(dones) == 0


@pytest.mark.cuda
@pytest.mark.parametrize('case', GRAPHED_ENV_STEP_CASES,
                         ids=[c[0] for c in GRAPHED_ENV_STEP_CASES])
def test_graphed_env_step_kernel_matches_plain(case):
    """The kernel's step captured in a `core/graph.Graph` and replayed
    under a new action each step, against the plain version eagerly: 1 and
    4099 envs of every registry id, float32 and float64, every episode
    ending.  Only the warm-up and the capture count as launches."""
    from gym_copter_tpu_torch.envs import base

    device = _card()
    _, name, dtype, b, regime = case
    launches = base.step_kernel.launches
    bad, _, ended, _ = env_step_mismatches(name, dtype, b, regime, device,
                                           graphed=True)
    assert bad == [] and ended
    assert base.step_kernel.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize('graphed', [False, True], ids=['eager', 'graphed'])
def test_env_step_kernel_reads_the_key_at_each_launch(graphed):
    """The base key rewritten in place between two steps (between two
    replays of a captured step) changes the kernel's reset draws, to the
    plain version's under the new key."""
    device = _card()
    bad, _, ended, changed = env_step_mismatches(
        'Lander3D-v0', torch.float32, 4099, 'ends', device, graphed=graphed,
        rekey_at=8)
    assert bad == [] and ended and changed


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['float32', 'float64'])
def test_env_step_kernel_shard_equals_its_columns(dtype):
    """A shard's step (its columns, its global env ids) equals the same
    columns of the whole batch's step, resets and kicks included."""
    assert env_step_shard_mismatches('Lander3D-v0', dtype, _card()) == []


@pytest.mark.cuda
def test_env_step_kernel_refuses_what_it_does_not_take():
    """A non-contiguous field, a field or key on another device, an
    unsupported dtype or task raise before any launch."""
    from gym_copter_tpu_torch.envs import base

    device = _card()
    params, spec, key, ids, state, actions = env_step_setup(
        'Lander3D-v0', torch.float32, 128, 'ends', device)
    act = actions[0]
    launches = base.step_kernel.launches
    strided = state._replace(dyn=state.dyn._replace(
        x=torch.cat([state.dyn.x, state.dyn.x], dim=1)[:, ::2]))
    with pytest.raises(ValueError, match='contiguous'):
        base.step(strided, act, key, ids, params, spec)
    with pytest.raises(ValueError, match='is on cpu'):
        base.step(state._replace(steps=state.steps.cpu()), act, key, ids,
                  params, spec)
    with pytest.raises(ValueError, match='is on cpu'):
        base.step(state, act, key.cpu(), ids, params, spec)
    with pytest.raises(ValueError, match='action must be a tensor'):
        base.step(state, act.cpu(), key, ids, params, spec)
    half = tree_map(lambda t: t.half() if t.is_floating_point() else t,
                    state)
    with pytest.raises(ValueError, match='float32 or float64'):
        base.step(half, act, key, ids, params, spec)
    with pytest.raises(ValueError, match='no instantiation'):
        base.step(state, act, key, ids, params, spec._replace(kind='nope'))
    assert base.step_kernel.launches == launches


@pytest.mark.cuda
def test_handle_launches_the_kernel_for_any_batch():
    """On the card env.fused_rollout launches the kernel whatever the batch
    (here not a multiple of 128) and raises for a task outside its family;
    it never takes the step-by-step path."""
    device = _card()
    env = gt.make('Lander3D-v0', num_envs=1000)
    state, _ = env.reset()
    action = torch.full((4, 1000), 1.625e-2, device=env.device)
    launches = fr.fused_rollout.launches
    _, totals = env.fused_rollout(state, action, 50)
    assert totals['path'] == 'fused'
    assert fr.fused_rollout.launches == launches + 1
    bogus = CopterEnv(tasks.TARGET._replace(kind='nope'), num_envs=128)
    state = reset_state(bogus.params, tasks.TARGET, 128, device)
    with pytest.raises(ValueError, match='fused-kernel family'):
        bogus.fused_rollout(state, torch.zeros((4, 128), device=device), 10)
    assert fr.fused_rollout.launches == launches + 1


def _small_step(device, spec_name='Lander3D-v0', num_envs=256, **kw):
    cfg = ppo.PPOConfig(**{**dict(rollout_steps=16, hidden=16, minibatches=4,
                                  epochs=2, target_kl=0.015), **kw})
    env = gt.make(spec_name, num_envs=num_envs, device=device)
    step, opt = ppo.make_train_step(env.params, env.spec, cfg,
                                    prng.PRNGKey(1, device), env.env_ids)
    ts = ppo.init_train_state(prng.PRNGKey(0, device), env.params,
                              env.spec, cfg, num_envs, opt)
    return env, step, ts


# the recipe of the recorded 4096-env curves (scripts/train_curve.py's
# defaults; tests/make_jax_orbax_fixture.py's CFG), its learning rate
# annealed to 0 over a 600-update run; minibatches and shuffle_block
# resolve to 16 and 128
RECIPE = dict(rollout_steps=128, hidden=128, epochs=4, learning_rate=3e-4,
              gamma=0.995, entropy_coef=0.01, value_clip=0.0,
              target_kl=0.015, anneal_lr_floor=0.0)
RECIPE_UPDATES = 600


def _recipe_step(device, group=None, optimizer=None):
    """(env, train step, TrainState) of the recipe on 4096 Lander3D envs."""
    cfg = ppo.PPOConfig(**RECIPE)
    env = gt.make('Lander3D-v0', num_envs=MAIN_B, device=device)
    if optimizer is None:
        optimizer = optim.ClipAdam(cfg.max_grad_norm, optim.linear_schedule(
            cfg.learning_rate, 0.0, RECIPE_UPDATES * cfg.epochs * 16))
    step, opt = ppo.make_train_step(env.params, env.spec, cfg,
                                    prng.PRNGKey(1, device), env.env_ids,
                                    optimizer=optimizer, group=group)
    assert (step.cfg.minibatches, step.cfg.shuffle_block) == (16, 128)
    ts = ppo.init_train_state(prng.PRNGKey(0, device), env.params,
                              env.spec, cfg, MAIN_B, opt)
    return env, step, ts


def _step_of(size, device):
    """The train step of `size`: 'small' (_small_step: 256 envs, rollout
    16, hidden 16) or 'recipe' (_recipe_step)."""
    return _small_step(device) if size == 'small' else _recipe_step(device)


@pytest.mark.cuda
@pytest.mark.parametrize('size,steps', [('small', 2), ('recipe', 3)],
                         ids=['small', 'recipe'])
def test_graphed_train_step_equals_eager(size, steps):
    """Train steps through the CUDA graphs (the rollout as a 1-step graph
    replayed once per rollout step) against the eager path from the same
    state: every tensor of the train state and every metric equal, every
    metric finite; 2 small steps and 3 at the recipe."""
    device = _card()
    _, step, ts = _step_of(size, device)
    g, e = ts, ts
    for i in range(steps):
        g, mg = step(g)
        e, me = step.eager(e)
        assert state_diff(g, e, f'step {i}') == 0.0
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
            assert math.isfinite(float(mg[k])), k
    for graph in (step.rollout_graph, step.gae_graph, step.update_graph):
        assert graph.graph is not None
    assert int(g.update_idx) == steps


@pytest.mark.cuda
def test_train_at_the_recipe_takes_its_steps():
    """train('Lander3D-v0', 4096 envs, 3 updates) at the recipe, evaluated
    at updates 0 and 2: the train state has taken its 3 updates and every
    metric and evaluation is finite."""
    _card()
    evals = []
    ts, _ = ppo.train('Lander3D-v0', num_envs=MAIN_B, num_updates=3,
                      cfg=ppo.PPOConfig(**RECIPE), log_every=2,
                      callback=lambda i, m: evals.append((i, m)))
    assert int(ts.update_idx) == 3 and [i for i, _ in evals] == [0, 2]
    for i, m in evals:
        assert all(math.isfinite(v) for v in m.values()), (i, m)


@pytest.mark.cuda
def test_card_train_step_matches_cpu_float32():
    """One float32 train step (Hover3D, 16 envs, the configuration of
    test_ppo.py's _one_update_params) on the card against the CPU: every
    float tensor to rtol 1e-4 (atol 1e-6 of its largest element), every
    integer tensor equal."""
    device = _card()
    cpu = torch.device('cpu')
    kw = dict(rollout_steps=8, hidden=16, minibatches=2, epochs=4,
              learning_rate=1e-2, anneal_lr=False, target_kl=1e9)
    _, s_cpu, ts = _small_step(cpu, 'Hover3D-v0', 16, **kw)
    _, s_gpu, _ = _small_step(device, 'Hover3D-v0', 16, **kw)
    want, _ = s_cpu(ts)
    got, _ = s_gpu(train_state_to(ts, device))
    for a, b in zip(state_tensors(got), state_tensors(want)):
        a = a.cpu()
        if a.is_floating_point():
            scale = float(b.abs().max()) or 1.0
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('size', ['small', 'recipe'])
def test_graphed_eval_equals_eager(size):
    """The evaluation through its 1-step graph, twice, against the eager
    loop: per-env returns equal and finite; 64 envs x 200 steps, and
    train()'s own evaluation (1024 envs x 999 steps) at the recipe."""
    device = _card()
    if size == 'small':
        env, step, ts = _small_step(device, num_envs=64)
        evaluate = ppo.make_eval_fn(env.params, env.spec, step.cfg,
                                    num_envs=64, num_steps=200)
    else:
        env, step, ts = _recipe_step(device)
        evaluate = ppo.make_eval_fn(env.params, env.spec, step.cfg)
    want = evaluate(ts.params, graphed=False)[1]
    assert want.shape == ((64,) if size == 'small' else
                          (ppo.EVAL_NUM_ENVS,))
    assert torch.isfinite(want).all()
    for _ in range(2):
        assert torch.equal(evaluate(ts.params)[1], want)


@pytest.mark.cuda
@pytest.mark.parametrize('size', ['small', 'recipe'])
def test_sharded_graphed_step_equals_unsharded_nccl(tmp_path, size):
    """In a one-rank NCCL world, the sharded train step, graphed with its
    all-reduces and all-gather inside the graphs, equals the unsharded
    graphed step bit for bit (2 small steps, 3 at the recipe); so does the
    sharded fused rollout equal fused_rollout: 256 envs x 500 steps, and
    at the recipe the main path's 4096 x 10,000 from a reset, its totals
    gathered and its launches counted."""
    import torch.distributed as dist
    from gym_copter_tpu_torch.parallel import sharding

    device = _card()
    group, dev = sharding.init_world('nccl', 0, 1,
                                     f'file://{tmp_path}/store',
                                     local_rank=0)
    try:
        env, plain, ts = _step_of(size, dev)
        sharded, _ = ppo.make_train_step(env.params, env.spec, plain.cfg,
                                         prng.PRNGKey(1, device),
                                         env.env_ids,
                                         optimizer=plain.optimizer,
                                         group=group)
        a, b = ts, ts
        for i in range(2 if size == 'small' else 3):
            a, ma = plain(a)
            b, mb = sharded(b)
            assert state_diff(a, b, f'step {i}') == 0.0
            assert all(torch.equal(ma[k], mb[k]) for k in ma)
        if size == 'small':
            state = reset_state(env.params, env.spec, 256, dev)
            act = torch.full((4, 256), 1.625e-2, device=dev)
            got = sharding.sharded_fused_rollout(
                state, act, 500, env.params, env.spec, env_ids=env.env_ids)
            want = fr.fused_rollout(state, act, 500, env.params, env.spec)
        else:
            state, _ = env.reset()
            act = torch.full((4, MAIN_B), MOTORVAL, device=dev)
            launches = fr.fused_rollout.launches
            final, totals = sharding.sharded_fused_rollout(
                state, act, 10_000, env.params, env.spec, seed=0,
                env_ids=env.env_ids)
            got = final, sharding.gather_totals(totals, group)
            assert fr.fused_rollout.launches > launches
            want = fr.fused_rollout(state, act, 10_000, env.params, env.spec,
                                    seed=0, env_ids=env.env_ids)
        compare(got, want, 'sharded vs one rank')
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize('size', ['small', 'recipe'])
def test_gloo_ranks_share_the_card(size):
    """Two gloo ranks on the one card (parallel/launch.py, eager steps, one
    update; a small PPO config at 2 x 256 envs, or the recipe at 2 x 2048):
    the gathered fused rollout equals the one-rank layout and the ranks end
    with the same parameters."""
    from gym_copter_tpu_torch.parallel import launch

    _card()
    if size == 'small':
        kw = dict(envs_per_rank=256, timeout_s=300,
                  ppo_kw=dict(rollout_steps=16, hidden=16, minibatches=4,
                              epochs=2))
    else:
        kw = dict(envs_per_rank=MAIN_B // 2, timeout_s=600)
    report = launch.run(2, 'gloo', 'cuda', updates=1, **kw)
    assert report['totals_equal_one_rank']
    assert report['params_equal_across_ranks'] and not report['graphed']


@pytest.mark.cuda
@pytest.mark.parametrize('schedule,counts', [
    (RECIPE_SCHEDULE, 38_402), (FLOOR_SCHEDULE, 32_002)],
    ids=['recipe', 'floor'])
def test_schedule_on_the_card_equals_the_cpu(schedule, counts):
    """The recipe's learning-rate schedule (3e-4 to 0 over 600 x 64
    optimizer steps), and train()'s default one (to 0.05 of the rate, over
    500 x 64, through optim.fma32), on the card equal the CPU's at every
    count, bit for bit: eagerly, and as a 0-dim count in a captured
    graph."""
    eager, graphed, n = schedule_mismatches(_card(), schedule)
    assert (n, eager, graphed) == (counts, 0, 0)


@pytest.mark.cuda
def test_clip_adam_kernel_matches_plain():
    """The optimizer's kernel (ClipAdam.step on the card) against its plain
    version on the card, bit for bit in every parameter, moment and count:
    Lander3D's and Hover3D's leaf shapes, float32 and float64, the norm
    over and under the limit, no guard / not stopped / stopped, counts
    near 1, near 38,400 and saturated, constant rate and the recipe's
    schedule; eagerly and replayed in a captured graph."""
    bad, cases, launches = clip_adam_mismatches(_card())
    assert bad == []
    # per case: the eager call, the graph's warm-up and its capture
    assert (cases, launches) == (144, 3 * 144)


@pytest.mark.cuda
def test_clip_adam_wrapper_refuses_what_the_kernel_does_not_take():
    """A non-contiguous leaf, or leaves on different devices, raise before
    any launch."""
    device = _card()
    opt, params, grads, state, stop = clip_adam_case(
        ppo_leaf_shapes(10, hidden=16), torch.float32, device, clip=True,
        stop=False, count=0, schedule=False)
    launches = optim.step_kernel.launches
    strided = list(grads)
    strided[0] = grads[0].t().contiguous().t()
    with pytest.raises(ValueError, match='contiguous'):
        opt.step(params, strided, state, stop)
    on_cpu = list(grads)
    on_cpu[2] = grads[2].cpu()
    with pytest.raises(ValueError, match='is on cpu'):
        opt.step(params, on_cpu, state, stop)
    with pytest.raises(ValueError, match='is on cpu'):
        opt.step(params, grads, state._replace(count=state.count.cpu()),
                 stop)
    with pytest.raises(ValueError, match='float64'):
        opt.step(params, grads, state._replace(
            mu=[m.double() for m in state.mu]), stop)
    assert optim.step_kernel.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize('schedule', [False, True],
                         ids=['constant', 'recipe_schedule'])
def test_optimizer_region_is_a_few_nodes_per_minibatch(schedule):
    """The update graph's `ppo.optimizer` regions hold at most 40 nodes
    per minibatch: the sums of squares, the count's bias corrections, the
    rate (the recipe's schedule, annealed to 0), the target-KL flag and
    one launch."""
    from gym_copter_tpu_torch.utils import profiling

    device = _card()
    cfg = ppo.PPOConfig(rollout_steps=16, hidden=16, minibatches=4,
                        epochs=2, target_kl=0.015, anneal_lr_floor=0.0)
    env = gt.make('Lander3D-v0', num_envs=256, device=device)
    opt = ppo.train_optimizer(ppo.resolve_minibatches(cfg, 256), 10) \
        if schedule else None
    step, opt = ppo.make_train_step(env.params, env.spec, cfg,
                                    prng.PRNGKey(1, device), env.env_ids,
                                    optimizer=opt)
    assert callable(opt.learning_rate) == schedule
    ts = ppo.init_train_state(prng.PRNGKey(0, device), env.params, env.spec,
                              cfg, 256, opt)
    profiling.clear()
    launches = optim.step_kernel.launches
    step(ts)
    update = [c for c in profiling.snapshot()['captures']
              if c['graph'] == 'ppo.update'][-1]
    profiling.clear()
    minibatches = cfg.epochs * cfg.minibatches
    # the graph's 3 warm-ups and its capture
    assert optim.step_kernel.launches == launches + 4 * minibatches
    assert update['counted']
    assert update['regions']['ppo.optimizer'] <= 40 * minibatches


def _resumes(path, size):
    """A TrainState on the card after one graphed step, saved to `path` and
    restored (utils/checkpoint.py), comes back on the card, equal; two
    graphed steps from it equal the uninterrupted ones bit for bit."""
    from gym_copter_tpu_torch.utils import checkpoint

    _, step, ts = _step_of(size, _card())
    ts, _ = step(ts)
    checkpoint.save(str(path), ts, step.optimizer)
    restored = checkpoint.restore(str(path), ts, step.optimizer)
    assert restored.obs.is_cuda and state_diff(restored, ts, 'restore') == 0
    a, b = ts, restored
    for i in range(2):
        a, ma = step(a)
        b, mb = step(b)
        assert state_diff(a, b, f'resumed step {i}') == 0.0
        assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.cuda
@pytest.mark.parametrize('size', ['small', 'recipe'])
def test_checkpoint_resumes_graphed_steps(tmp_path, size):
    """_resumes through a .npz file."""
    _resumes(tmp_path / 'ts.npz', size)


@pytest.mark.cuda
@pytest.mark.parametrize('size', ['small', 'recipe'])
def test_checkpoint_resumes_graphed_steps_from_a_directory(tmp_path, size):
    """_resumes through an orbax checkpoint directory."""
    _resumes(tmp_path / 'ts', size)


@pytest.mark.cuda
def test_jax_orbax_fixture_restores_on_the_card():
    """The JAX package's orbax checkpoint of the recipe after one update
    (tests/data/jax_orbax_lander3d/: OCDBT, zstd frames without a content
    size) restores on the card, every leaf equal to its recorded SHA-256."""
    from gym_copter_tpu_torch.utils import checkpoint

    device = _card()
    record = fixture_record()
    template, opt = fixture_template(record, device)
    ts = checkpoint.restore(str(FIXTURE), template, opt)
    assert ts.obs.is_cuda and int(ts.update_idx) == 1
    assert fixture_mismatches(ts, opt, record) == []


# the gap allowed between each metric of the port's first update on the
# card from the committed JAX checkpoint and JAX's recorded one (CPU,
# float32): |port - jax| <= rtol * |jax| + atol.  Measured on an H100:
# approx_kl 1.30e-5 relative, the others at most 3.95e-6, done_rate
# exact; rtol 1e-4 is also what test_card_train_step_matches_cpu_float32
# holds a card step to
FIXTURE_METRIC_RTOL, FIXTURE_METRIC_ATOL = 1e-4, 1e-8


@pytest.mark.cuda
def test_update_from_the_jax_fixture_follows_jax():
    """One graphed update of the recipe from the JAX package's orbax
    checkpoint (the recipe's, checked against the record) restored on the
    card: every metric within FIXTURE_METRIC_RTOL of JAX's recorded next
    update, and the update count one past the saved one."""
    from gym_copter_tpu_torch.utils import checkpoint

    device = _card()
    record = fixture_record()
    assert (record['env'], record['envs'], record['config'],
            record['run_updates']) == ('Lander3D-v0', MAIN_B, RECIPE,
                                       RECIPE_UPDATES)
    template, opt = fixture_template(record, device)
    _, step, _ = _recipe_step(device, optimizer=opt)
    ts = checkpoint.restore(str(FIXTURE), template, opt)
    assert fixture_mismatches(ts, opt, record) == []
    nxt, metrics = step(ts)
    for k, want in record['next_update_metrics'].items():
        got = float(metrics[k])
        assert math.isfinite(got) and abs(got - want) <= (
            FIXTURE_METRIC_RTOL * abs(want) + FIXTURE_METRIC_ATOL), (
            k, got, want)
    assert int(nxt.update_idx) == record['updates_before_save'] + 1


@pytest.mark.cuda
def test_trace_of_a_graphed_step_holds_kernels(tmp_path):
    """torch.profiler (utils/profiling.py `trace`) sees the kernels that a
    graphed train step replays, and `device_busy` reads a busy share in
    (0, 1]."""
    from gym_copter_tpu_torch.utils import profiling

    device = _card()
    env, step, ts = _small_step(device)
    ts, _ = step(ts)
    with profiling.trace(str(tmp_path)):
        step(ts)
    out = profiling.device_busy(str(tmp_path / profiling.TRACE_FILE))
    assert out['kernels'] > 100 and 0 < out['busy_share'] <= 1


@pytest.mark.cuda
def test_graphed_fitness_equals_eager():
    """NEAT's fitness through its one-step graph (Lander3D, 8 genomes x 4
    episodes, 200 steps), twice with two episodes, against the eager loop:
    per-episode returns equal bit for bit."""
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    device = _card()
    cfg = ne.NeatConfig(pop_size=8, episode_reps=4, max_steps=200)
    genome = ne.init_population(prng.PRNGKey(0, device), 10, 4, cfg)
    fit = ne.make_fitness_fn('Lander3D-v0', cfg, return_episodes=True)
    for episode in (0, 5):
        want = fit(genome, episode, graphed=False)
        assert torch.equal(fit(genome, episode), want)
    assert fit.graph.graph is not None


@pytest.mark.cuda
def test_graphed_adaptive_run_equals_eager():
    """The adaptive controller through its one-step graph (the wind sweep,
    300 steps) against the eager loop: every history and the weights
    equal bit for bit."""
    from gym_copter_tpu_torch.learn import adaptive

    _card()
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    winds = [-4.0, -2.0, 0.0, 2.0, 4.0]
    want = adaptive.run(params, winds, 300, graphed=False)
    got = adaptive.run(params, winds, 300)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize('pop', [32, 960])
def test_evolve_on_card_matches_cpu(pop):
    """One float32 evolve from the same population, tied fitness and key on
    the card and on the CPU: tournament parents, crossover flags, elites
    and every mask equal; weights within 1e-5 (the card's and the CPU's
    `normal` differ in the last bits).  32 genomes with fitness 0-4, and
    the full-width 960 (10 episodes, hidden 16) with rounded normal
    fitness, many ties as early generations have."""
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    device = _card()
    cpu = torch.device('cpu')
    if pop == 32:
        cfg, key = ne.NeatConfig(pop_size=32), 7
        fit = torch.arange(32, dtype=torch.float32) % 5
    else:
        cfg, key = ne.NeatConfig(pop_size=960, episode_reps=10, hidden=16), 2
        fit = torch.round(prng.normal(prng.PRNGKey(1, cpu), (960,)) * 3)
    genome = ne.init_population(prng.PRNGKey(0, cpu), 10, 4, cfg)
    on_card = tree_map(lambda x: x.to(device), genome)
    for a, b in zip(ne.parents(cfg, fit, prng.PRNGKey(key, cpu),
                               torch.float32),
                    ne.parents(cfg, fit.to(device), prng.PRNGKey(key, device),
                               torch.float32)):
        assert torch.equal(a, b.cpu())
    want = ne.make_evolve_fn(cfg)(genome, fit, prng.PRNGKey(key, cpu))
    got = ne.make_evolve_fn(cfg)(on_card, fit.to(device),
                                 prng.PRNGKey(key, device))
    for name, a, b in zip(want._fields, want, got):
        if name.startswith('m'):
            assert torch.equal(a, b.cpu()), name
        else:
            torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)


# the recorded Lander3D champions (docs/*_lander3d_champion.npz) evaluated
# by the JAX package on the CPU in float32 (reps 100, seed 77, episode
# 10000), and the band each mean on the card is held to: one episode that
# ends differently moves a mean of 100 by up to ~4
CHAMPIONS = {'neat': (311.29, 8.0), 'hyperneat': (317.86, 3.0)}


@pytest.mark.cuda
@pytest.mark.parametrize('algo', sorted(CHAMPIONS))
def test_champion_scores_within_its_band(algo):
    """The recorded champion carried across (compat/convert.py) and
    evaluated on 100 fresh Lander3D episodes, twice through its graph and
    once eagerly: the per-episode returns equal bit for bit, and their mean
    within the band of the JAX package's CPU score."""
    from gym_copter_tpu_torch.compat import convert
    from gym_copter_tpu_torch.learn import hyperneat as hn
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    _card()
    load, mod, cfg = {
        'neat': (convert.genome_from_numpy, ne, ne.NeatConfig(hidden=16)),
        'hyperneat': (convert.cppn_from_numpy, hn, hn.HyperNeatConfig()),
    }[algo]
    champ = load(ROOT / 'docs' / f'{algo}_lander3d_champion.npz')
    mean, per = mod.evaluate_champion(champ, 'Lander3D-v0', cfg)
    again = mod.evaluate_champion(champ, 'Lander3D-v0', cfg)[1]
    eager = mod.evaluate_champion(champ, 'Lander3D-v0', cfg,
                                  graphed=False)[1]
    assert torch.equal(per, again) and torch.equal(per, eager)
    ref, band = CHAMPIONS[algo]
    assert abs(mean - ref) <= band, mean


@pytest.mark.cuda
@pytest.mark.parametrize('algo,generations', [('neat', 3), ('hyperneat', 2)])
def test_evolve_population_at_full_width(algo, generations):
    """evolve_population on Lander3D at full width (960 genomes x 10
    episodes x 999 steps) from seed 0: every generation's best, mean and
    holdout fitness finite."""
    from gym_copter_tpu_torch.learn import hyperneat as hn
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    _card()
    if algo == 'neat':
        mod, cfg = ne, ne.NeatConfig(pop_size=960, episode_reps=10, hidden=16)
    else:
        mod, cfg = hn, hn.HyperNeatConfig(pop_size=960, episode_reps=10)
    _, hist, _ = mod.evolve_population('Lander3D-v0', cfg,
                                       max_generations=generations, seed=0)
    assert len(hist) == generations
    for rec in hist:
        assert all(math.isfinite(rec[k]) for k in (
            'best_fitness', 'mean_fitness', 'holdout_best')), rec


@pytest.mark.cuda
@pytest.mark.parametrize('env_name', ['Lander3D-v0', 'Hover2D-v0',
                                      'Lander3DSimple-v0'])
def test_graphed_expert_rollout_equals_eager(env_name):
    """An expert's closed loop through its one-step graph (256 envs, 300
    steps) against the eager loop: totals, done flags and end states
    equal bit for bit."""
    from gym_copter_tpu_torch.control import heuristics

    _card()
    want = heuristics.run_expert(env_name, 256, 300, graphed=False)
    got = heuristics.run_expert(env_name, 256, 300)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(heuristics.PID_POLICIES))
def test_expert_closed_loop_at_full_width(name):
    """Every PID expert's closed loop at 4096 envs x 1000 steps, graphed:
    every return finite; Lander3D's median return over 150 with 3 in 4 of
    its envs ended on the pad, Hover3D's median over 900 (tests/
    test_pid.py's thresholds)."""
    from gym_copter_tpu_torch.core import constants as C

    _card()
    run = heuristics.run_expert(name, 4096, 1000)
    assert torch.isfinite(run.total).all()
    end = run.end_x
    on_pad = float(((end[C.STATE_Z].abs() < 1.0)
                    & (torch.sqrt(end[C.STATE_X] ** 2
                                  + end[C.STATE_Y] ** 2) < 2.0)
                    & run.done_seen).float().mean())
    median = float(torch.quantile(run.total, 0.5))
    if name == 'Lander3D-v0':
        assert median > 150 and on_pad >= 0.75, (median, on_pad)
    if name == 'Hover3D-v0':
        assert median > 900, median


@pytest.mark.cuda
def test_adaptive_controller_meets_its_thresholds():
    """adaptive.run over the wind sweep (-4 to 4 N) for 6000 steps, graphed,
    PD alone and adaptive (tests/test_adaptive.py's thresholds): PD's
    tracking error over 1 m at every wind, the adaptive one under 0.2 m and
    under a fifth of PD's; the learned extra thrust monotonic in the wind
    and, at no wind, within half of the hover value."""
    from gym_copter_tpu_torch.control.heuristics import hover_motor_value
    from gym_copter_tpu_torch.learn import adaptive

    _card()
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    cfg = adaptive.AdaptiveConfig()
    winds = (-4.0, -2.0, 0.0, 2.0, 4.0)
    pd = adaptive.run(params, winds, 6000, adapt=False)
    ad = adaptive.run(params, winds, 6000)
    pd_err = adaptive.tracking_error(pd, cfg).cpu()
    ad_err = adaptive.tracking_error(ad, cfg).cpu()
    u_final = ad['u_extra'][-200:].mean(0).cpu()
    hover = hover_motor_value(params)
    diffs = torch.diff(u_final)
    assert (pd_err > 1.0).all() and (ad_err < 0.2).all()
    assert (ad_err < pd_err / 5.0).all()
    assert (diffs < 0).all() or (diffs > 0).all()
    assert abs(float(u_final[2]) - hover) < 0.5 * hover


@pytest.mark.cuda
def test_mars_hover_anchor_holds_altitude():
    """The blade-element hover anchor (Hover3DMars-v0 without the reset
    kick, 8 envs at the hover motor value) holds 10 m for 100 steps: the
    altitude within 0.05 m and the climb rate within 0.02 m/s."""
    from gym_copter_tpu_torch.control.heuristics import hover_motor_value
    from gym_copter_tpu_torch.core import constants as C
    from gym_copter_tpu_torch.envs import base

    device = _card()
    params = tasks.PRESET_PARAMS['Hover3DMars-v0']()
    params = params._replace(task=params.task._replace(
        initial_random_force=0.0))
    ids = torch.arange(8, dtype=torch.int32, device=device)
    key = prng.PRNGKey(0, device)
    state, _ = base.reset(key, ids, torch.zeros_like(ids), params,
                          tasks.HOVER_3D)
    action = torch.full((4, 8), hover_motor_value(params), device=device)
    for _ in range(100):
        state, ts = base.step(state, action, key, ids, params, tasks.HOVER_3D)
    assert (ts.x[C.STATE_Z].cpu() + 10.0).abs().max() <= 0.05
    assert ts.x[C.STATE_Z_DOT].cpu().abs().max() <= 0.02


@contextlib.contextmanager
def _time_limit(seconds):
    """Raises TimeoutError in the block once it has run `seconds` (SIGALRM:
    the card's pytest runs its tests in the main thread)."""
    def expire(signum, frame):
        raise TimeoutError(f'past its limit of {seconds} s')

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# the Mars learning smoke of tests/test_mars.py:57-75, and the JAX
# package's float64 run of it (tests/make_jax_mars_curve.py); the card's
# float64 run is held to it (measured on an H100: evals 6.8e-7 relative,
# the evaluation's envs being float32; metrics 6.6e-9) and to the bar
MARS_PPO = dict(rollout_steps=64, hidden=32, gamma=0.995, learning_rate=1e-3)
MARS_UPDATES, MARS_ENVS, MARS_GAIN = 160, 256, 40.0
MARS_JAX_F64 = ROOT / 'tests' / 'data' / 'jax_lander3dmars_f64_seed3.json'
MARS_EVAL_RTOL, MARS_METRIC_RTOL, MARS_METRIC_ATOL = 1e-5, 1e-6, 1e-12
# each run takes 11-12.5 s on an NVIDIA H100 80GB HBM3 at 700 W
MARS_LIMIT_S = 300


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_mars_ppo_smoke_on_the_card(dtype):
    """The Mars PPO learning smoke (Lander3DMars-v0, 256 envs, 160 updates,
    seed 3), graphed, evaluated where the JAX package's float64 run was:
    every evaluation finite.  In float64 each evaluation and train metric
    follows JAX's float64 run (evals rtol 1e-5, metrics 1e-6) and the best
    evaluation beats the first by more than 40.  The bar is held in
    float64 because there it is the algorithm's: in float32 any two
    implementations part within 20 updates and one seed's gain is a draw
    (docs/mars_smoke_seeds/)."""
    _card()
    jax_run = json.loads(MARS_JAX_F64.read_text())
    hist = []
    with _time_limit(MARS_LIMIT_S):
        ppo.train('Lander3DMars-v0', num_envs=MARS_ENVS,
                  num_updates=MARS_UPDATES, seed=jax_run['seed'],
                  cfg=ppo.PPOConfig(**MARS_PPO),
                  log_every=jax_run['log_every'],
                  dtype=getattr(torch, dtype),
                  callback=lambda i, m: hist.append(dict(m, update=i)))
    evals = [h['eval_return'] for h in hist]
    assert len(evals) == len(jax_run['history'])
    assert all(math.isfinite(e) for e in evals), evals
    if dtype == 'float32':
        return
    for got, want in zip(hist, jax_run['history']):
        assert got['update'] == want['update']
        for k, w in want.items():
            if k == 'update':
                continue
            rtol = MARS_EVAL_RTOL if k == 'eval_return' else MARS_METRIC_RTOL
            atol = 0.0 if k == 'eval_return' else MARS_METRIC_ATOL
            assert abs(got[k] - w) <= rtol * abs(w) + atol, (
                k, want['update'], got[k], w)
    assert max(evals) - evals[0] > MARS_GAIN, evals


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['Lander-v0', 'Lander3D-v0', 'Hover3D-v0'])
def test_card_env_matches_numpy_oracle(name):
    """The float64 env on the card, 4 envs x 1000 steps of random actions
    through auto-resets, each env beside its numpy oracle: done flags and
    status equal, observations and rewards within 1e-9, some episodes
    ended; the fused kernel is not launched."""
    from torch_cuda_cases import oracle_gap

    device = _card()
    launches = fr.fused_rollout.launches
    gap, ended = oracle_gap(name, 4, 1000, device)
    assert ended > 0 and gap <= 1e-9
    assert fr.fused_rollout.launches == launches


@pytest.mark.cuda
def test_graphed_single_env_equals_eager():
    """The adapter's B = 1 core (compat/single.py): Lander-v0 episodes
    through its one-step graph equal the eager episodes bit for bit, also
    after reset(seed=) rekeys the captured env."""
    import numpy as np

    from gym_copter_tpu_torch.compat.single import SingleCopterEnv
    from torch_cuda_cases import same_episode, single_episode

    _card()
    action = np.full(4, 1.625e-2, np.float32)
    env = SingleCopterEnv('Lander-v0')
    for seed in (0, 5):
        graphed = single_episode(env, action, seed=seed)[0]
        eager = single_episode(SingleCopterEnv('Lander-v0', graphed=False),
                               action, seed=seed)[0]
        assert graphed[-1][2] and same_episode(graphed, eager)


@pytest.mark.cuda
def test_single_env_on_the_card_matches_the_cpu():
    """One Lander-v0 episode of the adapter's B = 1 core at MOTORVAL,
    graphed on the card, against the same on the CPU: as many steps and
    the return within 1e-5 of the CPU's; a float64 episode with the legacy
    seeding (the np.random kick) runs to its end; the fused kernel is not
    launched."""
    import numpy as np

    from gym_copter_tpu_torch.compat.single import SingleCopterEnv
    from torch_cuda_cases import single_episode

    _card()
    launches = fr.fused_rollout.launches
    action = np.full(4, MOTORVAL, np.float32)
    card = single_episode(SingleCopterEnv('Lander-v0'), action)[0]
    cpu = single_episode(SingleCopterEnv('Lander-v0', device='cpu'),
                         action)[0]
    total, cpu_total = (sum(r for _, r, _ in e) for e in (card, cpu))
    assert len(card) == len(cpu)
    assert abs(total - cpu_total) <= 1e-5 * abs(cpu_total)
    legacy = single_episode(
        SingleCopterEnv('Lander-v0', legacy_seeding=True,
                        dtype=torch.float64), action.astype(np.float64))[0]
    assert legacy[-1][2]
    assert fr.fused_rollout.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize('kind,res', [('vision', 16), ('vision', 64),
                                      ('dvs', 16)],
                         ids=['vision16', 'vision64', 'dvs16'])
def test_graphed_visual_step_equals_eager(kind, res):
    """VisualCopterEnv at 4096 Lander3D envs: 100 steps through a one-step
    graph give the eager steps' images bit for bit (vision at res 16 and
    64, DVS at 16); the fused kernel is not launched."""
    from torch_cuda_cases import visual_graphed_vs_eager

    device = _card()
    launches = fr.fused_rollout.launches
    assert visual_graphed_vs_eager('Lander3D-v0', 4096, res, kind == 'dvs',
                                   100, device)[0] == 0
    assert fr.fused_rollout.launches == launches


@pytest.mark.cuda
def test_camera_radians_round_as_on_the_cpu():
    """The camera's degree-to-radian multiply on 4096 random poses (the
    angles of the res-16 images compared with the CPU's) gives the CPU's
    bits on every angle: the pixels that differ between the card and the
    CPU come from CUDA's float32 sin/cos alone (chip_smoke.py's [traps])."""
    import numpy as np

    from gym_copter_tpu_torch.sensors.vision import RAD_PER_DEG

    device = _card()
    # the positions are drawn first, so the angles are the images' own
    rng = np.random.default_rng(0)
    poses = np.zeros((6, 4096), np.float32)
    poses[0:2] = rng.uniform(-3, 3, (2, 4096))
    poses[2] = rng.uniform(1, 10, 4096)
    poses[3:6] = rng.uniform(-30, 30, (3, 4096))
    host = torch.from_numpy(poses)
    rad_card = host[3:6].to(device) * RAD_PER_DEG
    assert torch.equal(rad_card.cpu(), host[3:6] * RAD_PER_DEG)


@pytest.mark.cuda
def test_demos_main_on_the_card(tmp_path):
    """The demos' main() on the card with --nodisplay: lander with
    --vision --res 16 --save (its CSV over 100 lines, its vision prints)
    returns within 1e-5 of lander on the CPU; lander with --dvs and with
    --freeze, and target, run to their end; hover returns over 900; the
    fused kernel is not launched."""
    from gym_copter_tpu_torch.demos import hover, lander, target

    _card()
    launches = fr.fused_rollout.launches

    def run(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(argv)
        return result, buf.getvalue()

    csv = tmp_path / 'lander.csv'
    total, text = run(lander.main, ['--nodisplay', '--vision', '--res', '16',
                                    '--save', str(csv)])
    cpu_total, _ = run(lander.main, ['--nodisplay', '--device', 'cpu'])
    run(lander.main, ['--nodisplay', '--dvs', '--res', '16'])
    run(lander.main, ['--nodisplay', '--freeze', '2,1,8,10,0'])
    hover_total, _ = run(hover.main, ['--nodisplay'])
    run(target.main, ['--nodisplay'])
    assert abs(total - cpu_total) <= 1e-5 * abs(cpu_total)
    assert len(csv.read_text().splitlines()) >= 100 and 'vision:' in text
    assert hover_total > 900
    assert fr.fused_rollout.launches == launches


# the first four weights of each layer's first row of the JAX package's
# init_params(PRNGKey(0), 10, 4, PPOConfig(hidden=128), float32), Lander3D's
# sizes, computed by gym_copter_tpu on the CPU; held to INIT_TOL, the CPU
# tests' float32 tolerance (tests/test_torch_init_bf16.py)
JAX_INIT_SEED0 = {
    'actor': ((-0.0788092092, 0.0914243534, -0.0307461880, 0.1668087393),
              (-0.1591252536, -0.0479176082, -0.1578520983, 0.1337676644),
              (-0.000885984045, 0.00107619248, -0.00172114489,
               0.000928333146)),
    'critic': ((0.0254833326, -0.0948290601, -0.1376647353, -0.0443230122),
               (-0.1695650220, -0.0726697370, 0.0390017331, -0.1521614194),
               (0.0866849422, 0.1029118001, -0.1179335490, -0.1084475145)),
}
INIT_TOL = 1e-5
# bf16 operands, float32 products: the card's products against the CPU's,
# per layer (float32 sums in another order) and through the whole MLP (a
# last-bit difference flips a bf16 rounding of the next layer's input;
# the CPU against JAX: 9.7e-4)
BF16_LAYER_TOL, BF16_MLP_TOL = 1e-5, 2e-3


@pytest.mark.cuda
def test_init_on_the_card_matches_jax():
    """init_params(PRNGKey(0), 10, 4, hidden 128) with the key on the card
    (drawn on the host): every leaf on the card and equal to the CPU's, and
    within INIT_TOL of JAX's recorded 24 values."""
    _card()
    cfg = ppo.PPOConfig(hidden=128)
    card = ppo.init_params(prng.PRNGKey(0, 'cuda'), 10, 4, cfg)
    host = ppo.init_params(prng.PRNGKey(0, 'cpu'), 10, 4, cfg)
    assert all(a.is_cuda and torch.equal(a.cpu(), b)
               for a, b in zip(card.leaves(), host.leaves()))
    gap = max(abs(float(layer.w[0, j]) - want)
              for net in ('actor', 'critic')
              for layer, row in zip(getattr(card, net), JAX_INIT_SEED0[net])
              for j, want in enumerate(row))
    assert gap <= INIT_TOL, gap


@pytest.mark.cuda
def test_bf16_products_on_the_card_match_the_cpu():
    """bf16 operands with float32 products on 4096 columns through the
    seed-0 actor and critic, card against CPU: each layer within
    BF16_LAYER_TOL, each whole MLP within BF16_MLP_TOL; with TF32 allowed,
    the float32 path raises."""
    _card()
    host = ppo.init_params(prng.PRNGKey(0, 'cpu'), 10, 4,
                           ppo.PPOConfig(hidden=128))
    x = torch.randn((10, 4096), generator=torch.Generator().manual_seed(1))
    for layers in ppo.unflatten(host.leaves())[:2]:
        dev = [(w.cuda(), b.cuda()) for w, b in layers]
        xs = x
        for (w, b), (wd, bd) in zip(layers, dev):
            want = ppo.mlp_apply([(w, b)], xs, 'bfloat16')
            got = ppo.mlp_apply([(wd, bd)], xs.cuda(), 'bfloat16').cpu()
            assert float((got - want).abs().max()) <= BF16_LAYER_TOL
            xs = torch.tanh(want)
        want = ppo.mlp_apply(layers, x, 'bfloat16')
        got = ppo.mlp_apply(dev, x.cuda(), 'bfloat16').cpu()
        assert float((got - want).abs().max()) <= BF16_MLP_TOL
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            ppo.mlp_apply(dev, x.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# the launcher's run at the recipe on Lander3D-v0; two gloo hosts'
# reward_per_step against one NCCL host's, whose gradients sum in another
# order
MULTIHOST_UPDATES, MULTIHOST_RTOL = 3, 1e-3


@pytest.mark.cuda
def test_multihost_launcher_over_loopback(tmp_path):
    """The multi-host launcher as separate OS processes over a TCP
    rendezvous on loopback, Lander3D-v0 at the recipe for 3 updates: (a)
    one host of one NCCL rank, graphed, and (b) two hosts of one gloo rank
    each sharing the card, eager, 2 x 2048 envs.  Each reports its hosts,
    ranks and cards, 4096 envs, 3 updates, totals equal to one rank's, and
    the fused kernel launched on every rank; (b)'s reward_per_step is
    within MULTIHOST_RTOL of (a)'s."""
    _card()
    runs = {}
    for hosts, backend in ((1, 'nccl'), (2, 'gloo')):
        report = runs[backend] = launch_hosts(
            tmp_path / f'{backend}.json', hosts, backend, MULTIHOST_UPDATES)
        assert (report['hosts'], report['ranks'], report['devices']) == (
            hosts, hosts, hosts)
        assert report['graphed'] == (backend == 'nccl')
        assert report['global_envs'] == MAIN_B
        assert report['update_idx'] == MULTIHOST_UPDATES
        assert report['totals_equal_one_rank']
        assert min(s['launches'] for s in report['per_shard']) >= 1
    a, b = runs['nccl']['reward_per_step'], runs['gloo']['reward_per_step']
    assert abs(b - a) <= MULTIHOST_RTOL * abs(a), (a, b)


@pytest.mark.cuda
def test_capture_survives_garbage_graphs():
    """Captured graphs that are garbage in reference cycles (fitness
    functions dropped by their caller) are not freed in the middle of
    another capture, which would invalidate it: Graph collects them before
    it captures.  Here the collector runs inside the captured function."""
    import gc

    from gym_copter_tpu_torch.core.graph import Graph
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    device = _card()
    cfg = ne.NeatConfig(pop_size=4, episode_reps=2, max_steps=3)
    genome = ne.init_population(prng.PRNGKey(0, device), 10, 4, cfg)

    def collecting(x):
        y = x * 2.0
        gc.collect()
        return y + 1.0

    enabled = gc.isenabled()
    gc.disable()  # the dropped graphs stay uncollected until the capture
    try:
        for _ in range(2):
            ne.make_fitness_fn('Lander3D-v0', cfg)(genome, 0)
        out = Graph(collecting, warmup=0)(torch.ones(4, device=device))
    finally:
        if enabled:
            gc.enable()
    assert torch.equal(out, torch.full((4,), 3.0, device=device))


@pytest.mark.cuda
def test_capture_failure_raises():
    """A phase that reads a value back to the host cannot be captured: the
    graphed step raises and does not fall back to the eager path.  (Last
    in the file: a failed capture leaves nothing that later tests use.)"""
    device = _card()
    env, step, ts = _small_step(device, num_envs=64)
    advantages = step.advantages

    def syncing(*args):
        flat, stats = advantages(*args)
        return flat, stats * float(stats[0])

    step.advantages = syncing
    with pytest.raises(RuntimeError):
        step(ts)


@pytest.mark.cuda
def test_graphed_scan_rollout_equals_eager():
    """The step-by-step reference path as a one-step graph replayed (the
    headline bench's sanity path) against its eager loop: bit-equal, with
    the env's threefry resets."""
    device = _card()
    env = gt.make('Lander3D-v0', num_envs=1000, device=device)
    state, _ = env.reset()
    action = torch.full((4, 1000), 1.625e-2, device=device)
    out = [fr.scan_rollout(state, action, env.base_key, env.env_ids, 1200,
                           env.params, env.spec, graphed=g)
           for g in (True, False)]
    assert state_diff(out[0][0], out[1][0], 'graphed scan') == 0
    for k in ('reward_sum', 'episodes'):
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    assert int(out[0][1]['episodes'].min()) >= 1


@pytest.mark.cuda
def test_headline_bench_on_the_card(tmp_path):
    """The headline entry point at a small size on the card: its line, its
    sanity check and one history entry naming the card."""
    from gym_copter_tpu_torch.bench import headline

    _card()
    launches = fr.fused_rollout.launches
    out = headline.run(1024, 1000, 21_000, 3, history=tmp_path / 'h.json',
                       sanity_steps=1200, warmup_s=0.2, min_marginal_s=0.0)
    assert out['value'] > 0 and out['card']['before']['smi'].startswith(
        torch.cuda.get_device_name(0))
    assert fr.fused_rollout.launches > launches


@pytest.mark.cuda
def test_node_latency_replays_its_graph():
    """The card's µs per graph node: positive, and its graph adds once per
    node per replay."""
    from gym_copter_tpu_torch.utils.profiling import NodeLatency

    _card()
    node = NodeLatency(nodes=100, size=16)
    readings = [node() for _ in range(3)]
    assert all(0 < r < 1000 for r in readings)
    assert torch.equal(node.x, torch.full((16,), 301.0, device='cuda'))
