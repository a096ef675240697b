"""The harness driven on the CPU at a tiny size with the timed path broken
underneath, once for each fault a cell can have, sees `correct` come out
false; the sound program comes out true."""

import pytest
import torch

from port_bench import harness
from port_bench.tests.tiny import CELLS, SEED


def _run(cell):
    return harness.run(cell, SEED, 0.3, False, device='cpu',
                       overrides=CELLS[cell])


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_sound_program_is_correct(cell):
    result = _run(cell)
    assert result['correct'], result['checks']
    assert all(c['value'] == 0.0 for c in result['checks'].values())
    assert list(result)[-1] == 'checks'


def _state_unchanged(monkeypatch):
    from gym_copter_tpu_torch.learn import ppo

    run = ppo.TrainStep.run

    def broken(self, ts, graphed, marks=None):
        return ts, run(self, ts, graphed, marks)[1]

    monkeypatch.setattr(ppo.TrainStep, 'run', broken)


def _half_batch(monkeypatch):
    from gym_copter_tpu_torch.learn import ppo

    loss = ppo.TrainStep.loss

    def broken(self, leaves, *batch, share=None):
        h = batch[-1].shape[-1] // 2
        return loss(self, leaves, *(x[..., :h] for x in batch), share=share)

    monkeypatch.setattr(ppo.TrainStep, 'loss', broken)


def _reward_altered(monkeypatch):
    from gym_copter_tpu_torch.envs import base

    step = base.step

    def broken(*args):
        state, ts = step(*args)
        reward = ts.reward.clone()
        reward[0] += 1e-3
        return state, ts._replace(reward=reward)

    monkeypatch.setattr(base, 'step', broken)


@pytest.mark.parametrize('cell', ['lander3d.ppo', 'hover3d.ppo'])
@pytest.mark.parametrize('fault', [_state_unchanged, _half_batch,
                                   _reward_altered],
                         ids=lambda f: f.__name__[1:])
def test_training_faults_are_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(cell)['correct']


def _fused(monkeypatch, alter):
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    fused = fr.fused_rollout

    def broken(state, action, num_steps, params, spec, *, seed=0,
               env_ids=None):
        return alter(state, *fused(state, action, num_steps, params, spec,
                                   seed=seed, env_ids=env_ids))

    monkeypatch.setattr(fr, 'fused_rollout', broken)


def _fused_unchanged(start, state, totals):
    return start, {k: torch.zeros_like(v) for k, v in totals.items()}


def _fused_half_batch(start, state, totals):
    h = start.steps.shape[0] // 2

    def mix(a, b):
        return torch.cat([b[..., :h], a[..., h:]], dim=-1)

    state = type(state)(type(state.dyn)(*(mix(a, b) for a, b in zip(
        start.dyn, state.dyn))), *(mix(a, b) for a, b in zip(
            start[1:], state[1:])))
    totals = {k: torch.cat([v[:h], torch.zeros_like(v[h:])])
              for k, v in totals.items()}
    return state, totals


def _fused_answer_altered(start, state, totals):
    reward = totals['reward_sum'].clone()
    reward[0] += 1e-3
    return state, dict(totals, reward_sum=reward)


@pytest.mark.parametrize('alter', [_fused_unchanged, _fused_half_batch,
                                   _fused_answer_altered],
                         ids=lambda f: f.__name__[7:])
def test_fused_faults_are_caught(alter, monkeypatch):
    _fused(monkeypatch, alter)
    assert not _run('lander3d.fused')['correct']


def _single_unchanged(monkeypatch):
    from gym_copter_tpu_torch.compat.single import SingleCopterEnv

    step = SingleCopterEnv._step

    def broken(self, state, action):
        return state, step(self, state, action)[1]

    monkeypatch.setattr(SingleCopterEnv, '_step', broken)


def _single_answer_altered(monkeypatch):
    from gym_copter_tpu_torch.compat.single import SingleCopterEnv

    step = SingleCopterEnv.step

    def broken(self, action):
        obs, reward, terminated, truncated, info = step(self, action)
        return obs, reward + 1e-3, terminated, truncated, info

    monkeypatch.setattr(SingleCopterEnv, 'step', broken)


@pytest.mark.parametrize('fault', [_single_unchanged,
                                   _single_answer_altered],
                         ids=lambda f: f.__name__[8:])
def test_single_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    assert not _run('lander3d.single')['correct']
