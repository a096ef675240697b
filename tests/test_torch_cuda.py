"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here is marked `cuda` and skips where there is no CUDA device.
The file imports nothing of JAX, so it also runs on a machine without it;
there, skip the repo's conftest (which sets JAX up):

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The cases, shared with `chip_smoke.py`, are in tests/torch_cuda_cases.py:
every task kind, with and without random resets, Lander3D at 4096 envs,
and batches that are not a multiple of 128 or of 8, each at every
lanes-per-env choice (1, 4).  Kernel and plain version must agree bit
for bit in every field; so must the optimizer's kernel
(ops/csrc/clip_adam.cu) and the env step's (ops/csrc/env_step.cu) and
their plain versions.  The PPO, sharding,
checkpoint, profiling, evolution, adaptive and expert tests after them
hold the graphed paths against their eager, one-rank or CPU counterparts
on the card.
"""

import pytest
import torch

import gym_copter_tpu_torch as gt
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.core import vehicles
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.envs.registry import CopterEnv
from gym_copter_tpu_torch.ops import fused_rollout as fr
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.tree import tree_map
from gym_copter_tpu_torch.learn import ppo
from torch_cuda_cases import (FIXTURE, FLOOR_SCHEDULE, RECIPE_SCHEDULE,
                              clip_adam_case, clip_adam_mismatches, compare,
                              env_step_cases, env_step_mismatches,
                              env_step_setup, env_step_shard_mismatches,
                              fixture_mismatches, fixture_record,
                              fixture_template, ppo_leaf_shapes, reset_state,
                              run_kernel, scenarios, schedule_mismatches,
                              state_diff, state_tensors, train_state_to)

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
    (computed once per scenario)."""
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


@pytest.mark.cuda
def test_graphed_train_step_equals_eager():
    """Two train steps through the CUDA graphs (the rollout as a 1-step
    graph replayed 16 times) against the eager path from the same state:
    every tensor of the train state and every metric equal."""
    device = _card()
    env, step, ts = _small_step(device)
    g, e = ts, ts
    for i in range(2):
        g, mg = step(g)
        e, me = step.eager(e)
        assert state_diff(g, e, f'step {i}') == 0.0
        for k in mg:
            assert torch.equal(mg[k], me[k]), k
    for graph in (step.rollout_graph, step.gae_graph, step.update_graph):
        assert graph.graph is not None
    assert int(g.update_idx) == 2


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
def test_graphed_eval_equals_eager():
    """The evaluation through its 1-step graph, twice, against the eager
    loop: per-env returns equal."""
    device = _card()
    env, step, ts = _small_step(device, num_envs=64)
    evaluate = ppo.make_eval_fn(env.params, env.spec, step.cfg, num_envs=64,
                                num_steps=200)
    want = evaluate(ts.params, graphed=False)[1]
    for _ in range(2):
        assert torch.equal(evaluate(ts.params)[1], want)


@pytest.mark.cuda
def test_sharded_graphed_step_equals_unsharded_nccl(tmp_path):
    """In a one-rank NCCL world, the sharded train step, graphed with its
    all-reduces and all-gather inside the graphs, equals the unsharded
    graphed step bit for bit over two steps; so does the sharded fused
    rollout equal fused_rollout."""
    import torch.distributed as dist
    from gym_copter_tpu_torch.parallel import sharding

    device = _card()
    group, dev = sharding.init_world('nccl', 0, 1,
                                     f'file://{tmp_path}/store',
                                     local_rank=0)
    try:
        env, plain, ts = _small_step(dev)
        sharded, _ = ppo.make_train_step(env.params, env.spec, plain.cfg,
                                         prng.PRNGKey(1, device),
                                         env.env_ids, group=group)
        a, b = ts, ts
        for i in range(2):
            a, ma = plain(a)
            b, mb = sharded(b)
            assert state_diff(a, b, f'step {i}') == 0.0
            assert all(torch.equal(ma[k], mb[k]) for k in ma)
        state = reset_state(env.params, env.spec, 256, dev)
        act = torch.full((4, 256), 1.625e-2, device=dev)
        got = sharding.sharded_fused_rollout(state, act, 500, env.params,
                                             env.spec, env_ids=env.env_ids)
        want = fr.fused_rollout(state, act, 500, env.params, env.spec)
        compare(got, want, 'sharded vs one rank')
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gloo_ranks_share_the_card():
    """Two gloo ranks on the one card (parallel/launch.py, a small PPO
    config, eager steps): the gathered fused rollout equals the one-rank
    layout and the ranks end with the same parameters."""
    from gym_copter_tpu_torch.parallel import launch

    _card()
    report = launch.run(2, 'gloo', 'cuda', envs_per_rank=256, updates=1,
                        ppo_kw=dict(rollout_steps=16, hidden=16,
                                    minibatches=4, epochs=2),
                        timeout_s=300)
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
    from gym_copter_tpu_torch.learn import optim

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
    from gym_copter_tpu_torch.learn import optim
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


@pytest.mark.cuda
def test_checkpoint_resumes_graphed_steps(tmp_path):
    """A TrainState on the card saved and restored (utils/checkpoint.py)
    comes back on the card, equal; graphed steps from it equal the
    uninterrupted ones bit for bit."""
    from gym_copter_tpu_torch.utils import checkpoint

    device = _card()
    env, step, ts = _small_step(device)
    ts, _ = step(ts)
    path = str(tmp_path / 'ts.npz')
    checkpoint.save(path, ts, step.optimizer)
    restored = checkpoint.restore(path, ts, step.optimizer)
    assert restored.obs.is_cuda and state_diff(restored, ts, 'restore') == 0
    a, b = ts, restored
    for i in range(2):
        a, _ = step(a)
        b, _ = step(b)
        assert state_diff(a, b, f'resumed step {i}') == 0.0


@pytest.mark.cuda
def test_checkpoint_resumes_graphed_steps_from_a_directory(tmp_path):
    """The same through an orbax checkpoint directory."""
    from gym_copter_tpu_torch.utils import checkpoint

    device = _card()
    env, step, ts = _small_step(device)
    ts, _ = step(ts)
    path = str(tmp_path / 'ts')
    checkpoint.save(path, ts, step.optimizer)
    restored = checkpoint.restore(path, ts, step.optimizer)
    assert restored.obs.is_cuda and state_diff(restored, ts, 'restore') == 0
    a, b = ts, restored
    for i in range(2):
        a, _ = step(a)
        b, _ = step(b)
        assert state_diff(a, b, f'resumed step {i}') == 0.0


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
def test_evolve_on_card_matches_cpu():
    """One float32 evolve of 32 genomes from the same population, tied
    fitness and key on the card and on the CPU: tournament parents,
    crossover flags, elites and every mask equal; weights within 1e-5 (the
    card's and the CPU's `normal` differ in the last bits)."""
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    device = _card()
    cpu = torch.device('cpu')
    cfg = ne.NeatConfig(pop_size=32)
    genome = ne.init_population(prng.PRNGKey(0, cpu), 10, 4, cfg)
    fit = torch.arange(32, dtype=torch.float32) % 5
    on_card = tree_map(lambda x: x.to(device), genome)
    for a, b in zip(ne.parents(cfg, fit, prng.PRNGKey(7, cpu), torch.float32),
                    ne.parents(cfg, fit.to(device), prng.PRNGKey(7, device),
                               torch.float32)):
        assert torch.equal(a, b.cpu())
    want = ne.make_evolve_fn(cfg)(genome, fit, prng.PRNGKey(7, cpu))
    got = ne.make_evolve_fn(cfg)(on_card, fit.to(device),
                                 prng.PRNGKey(7, device))
    for name, a, b in zip(want._fields, want, got):
        if name.startswith('m'):
            assert torch.equal(a, b.cpu()), name
        else:
            torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)


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
def test_card_env_matches_numpy_oracle():
    """The float64 Lander3D env on the card, 4 envs x 300 steps of random
    actions through auto-resets, each env beside its numpy oracle: done
    flags and status equal, observations and rewards within 1e-9."""
    from torch_cuda_cases import oracle_gap

    gap, ended = oracle_gap('Lander3D-v0', 4, 300, _card())
    assert ended > 0 and gap <= 1e-9


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
@pytest.mark.parametrize('dvs', [False, True])
def test_graphed_visual_step_equals_eager(dvs):
    """VisualCopterEnv at 4096 Lander3D envs x res 16: 20 steps through a
    one-step graph give the eager steps' images bit for bit."""
    from torch_cuda_cases import visual_graphed_vs_eager

    assert visual_graphed_vs_eager('Lander3D-v0', 4096, 16, dvs, 20,
                                   _card())[0] == 0


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
