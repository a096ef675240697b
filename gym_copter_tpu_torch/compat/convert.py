"""Carry parameters, env state, PPO train state and evolved genomes
across from the JAX package.

No function here imports JAX: a JAX `EnvParams` is read through its
NamedTuple fields, and arrays (EnvState leaves, PPO params pytrees, optax
states, genomes) through `np.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch

from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.dynamics import DynamicsState
from gym_copter_tpu_torch.core.types import (EnvParams, LanderRewardParams,
                                             TaskParams, VehicleParams,
                                             WorldParams)
from gym_copter_tpu_torch.envs.base import EnvState
from gym_copter_tpu_torch.learn import optim
from gym_copter_tpu_torch.learn.hyperneat import CPPNGenome
from gym_copter_tpu_torch.learn.neuroevolution import Genome
from gym_copter_tpu_torch.learn.ppo import ActorCritic, TrainState

_INT_FIELDS = ('status', 'ticks', 'steps', 'episode')


def params_from_fields(p) -> EnvParams:
    """The port's EnvParams from any NamedTuple with EnvParams' fields
    (e.g. a `gym_copter_tpu` EnvParams)."""
    return EnvParams(vehicle=VehicleParams(**p.vehicle._asdict()),
                     world=WorldParams(**p.world._asdict()),
                     task=TaskParams(**p.task._asdict()),
                     reward=LanderRewardParams(**p.reward._asdict()),
                     lift_model=p.lift_model)


def env_state_from_numpy(s, device=None, dtype=None) -> EnvState:
    """The port's EnvState from any object with EnvState's nested fields
    whose leaves convert with `np.asarray` (a JAX EnvState, or the result of
    `env_state_to_numpy`).  Floats keep their dtype unless `dtype` is
    given; the integer fields become int32.  device defaults to the card,
    as every entry point's does."""
    device = resolve_device(device)

    def t(name, a):
        a = np.asarray(a)
        out = torch.from_numpy(np.array(a, copy=True))
        if name in _INT_FIELDS:
            out = out.to(torch.int32)
        elif dtype is not None:
            out = out.to(dtype)
        return out.to(device)

    dyn = DynamicsState(x=t('x', s.dyn.x), status=t('status', s.dyn.status),
                        perturb=t('perturb', s.dyn.perturb),
                        ticks=t('ticks', s.dyn.ticks))
    return EnvState(dyn=dyn, prev_shaping=t('prev_shaping', s.prev_shaping),
                    steps=t('steps', s.steps), episode=t('episode', s.episode),
                    initial_random_x=t('initial_random_x', s.initial_random_x))


def env_state_to_numpy(s: EnvState) -> EnvState:
    """The same EnvState with numpy arrays for leaves."""
    def n(a):
        return a.detach().cpu().numpy()

    return EnvState(
        dyn=DynamicsState(x=n(s.dyn.x), status=n(s.dyn.status),
                          perturb=n(s.dyn.perturb), ticks=n(s.dyn.ticks)),
        prev_shaping=n(s.prev_shaping), steps=n(s.steps),
        episode=n(s.episode), initial_random_x=n(s.initial_random_x))


def _tensor(a, device, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.array(np.asarray(a), copy=True))
    return out.to(device=device, dtype=dtype or out.dtype)


def ppo_params_from_numpy(p, device=None, dtype=None) -> ActorCritic:
    """The port's ActorCritic from a JAX PPO params pytree
    ({'actor': [{'w', 'b'}, ...], 'critic': [...], 'log_std'}, leaves read
    with `np.asarray`).  Floats keep their dtype unless `dtype` is given;
    device defaults to the card."""
    device = resolve_device(device)

    def layers(ls):
        return [(_tensor(layer['w'], device, dtype),
                 _tensor(layer['b'], device, dtype)) for layer in ls]

    return ActorCritic(layers(p['actor']), layers(p['critic']),
                       _tensor(p['log_std'], device, dtype))


def ppo_params_to_numpy(params: ActorCritic) -> dict:
    """The JAX pytree layout of `params`, with numpy leaves."""
    def layers(ls):
        return [{'w': layer.w.detach().cpu().numpy(),
                 'b': layer.b.detach().cpu().numpy()} for layer in ls]

    return {'actor': layers(params.actor), 'critic': layers(params.critic),
            'log_std': params.log_std.detach().cpu().numpy()}


def _optax_states(state):
    """The optax states nested in a chain's state tuple, depth first."""
    if hasattr(state, '_fields'):
        return [state]
    if isinstance(state, tuple):
        return [s for sub in state for s in _optax_states(sub)]
    return []


def opt_state_from_numpy(state, device=None, dtype=None) -> optim.AdamState:
    """The port's AdamState from the state of the JAX package's optimizer,
    `optax.chain(clip_by_global_norm, adam(lr))`: Adam's count, mu and nu,
    and the count of `scale_by_schedule` when the rate is a schedule (else
    0)."""
    device = resolve_device(device)
    states = _optax_states(state)
    # fields, not attributes: every tuple has a `count` method
    adam = next(s for s in states if 'mu' in s._fields)
    sched = [s for s in states
             if 'count' in s._fields and 'mu' not in s._fields]

    def leaves(tree):
        return ppo_params_from_numpy(tree, device, dtype).leaves()

    def count(c):
        return _tensor(c, device, torch.int32)

    return optim.AdamState(
        count=count(adam.count), mu=leaves(adam.mu), nu=leaves(adam.nu),
        schedule_count=count(sched[0].count if sched else 0))


def train_state_from_numpy(ts, device=None, dtype=None) -> TrainState:
    """The port's TrainState from a JAX PPO TrainState: params, optimizer
    state, env state, obs, key (uint32 words as int64) and update_idx."""
    device = resolve_device(device)
    return TrainState(
        params=ppo_params_from_numpy(ts.params, device, dtype),
        opt_state=opt_state_from_numpy(ts.opt_state, device, dtype),
        env_state=env_state_from_numpy(ts.env_state, device, dtype),
        obs=_tensor(ts.obs, device, dtype),
        key=_tensor(np.asarray(ts.key).astype(np.int64), device),
        update_idx=_tensor(ts.update_idx, device, torch.int32))


def _fields(g, cls):
    """The fields of cls from g: a path to an `.npz`, a mapping (a dict, an
    NpzFile) or a NamedTuple (a JAX genome)."""
    if isinstance(g, str) or hasattr(g, '__fspath__'):
        with np.load(g) as f:
            return {k: np.array(f[k]) for k in cls._fields}
    if hasattr(g, '_asdict'):
        g = g._asdict()
    return {k: g[k] for k in cls._fields}


def genome_from_numpy(g, device=None, dtype=None) -> Genome:
    """The port's `neuroevolution.Genome` from a JAX genome, a dict of its
    fields or the `.npz` that `scripts/neat_evolve.py --save-genome`
    writes.  Floats keep their dtype unless `dtype` is given; device
    defaults to the card."""
    device = resolve_device(device)
    return Genome(**{k: _tensor(v, device, dtype)
                     for k, v in _fields(g, Genome).items()})


def cppn_from_numpy(g, device=None, dtype=None) -> CPPNGenome:
    """The port's `hyperneat.CPPNGenome` from a JAX CPPN genome, a dict of
    its fields or its `.npz`; `act_sel` becomes int32."""
    device = resolve_device(device)
    return CPPNGenome(**{
        k: _tensor(v, device, torch.int32 if k == 'act_sel' else dtype)
        for k, v in _fields(g, CPPNGenome).items()})


def genome_to_numpy(g) -> dict:
    """A genome (`Genome` or `CPPNGenome`) as the JAX layout's dict of numpy
    arrays, in field order, as `np.savez` stores it."""
    return {k: v.detach().cpu().numpy() for k, v in g._asdict().items()}


cppn_to_numpy = genome_to_numpy
