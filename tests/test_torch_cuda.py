"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here is marked `cuda` and skips where there is no CUDA device.
The file imports nothing of JAX, so it also runs on a machine without it;
there, skip the repo's conftest (which sets JAX up):

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The cases, shared with `chip_smoke.py`, are in tests/torch_cuda_cases.py:
every task kind, with and without random resets, Lander3D at 4096 envs,
and batches that are not a multiple of 128 or of 8, each at every
lanes-per-env choice (1, 4).  Kernel and plain version must agree bit
for bit in every field.
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
from gym_copter_tpu_torch.learn import ppo
from torch_cuda_cases import (compare, reset_state, run_kernel, scenarios,
                              state_diff, state_tensors, train_state_to)

SCENARIOS = scenarios()
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
