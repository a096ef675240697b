"""Environment registry and the user-facing batched environment handle.

`make('Lander3D-v0', num_envs=4096)` returns a `CopterEnv`: B environments
stepping in lockstep on one device, the card unless the caller names
another.  The counterpart of `gym_copter_tpu/envs/registry.py`; where the
JAX handle jits a `lax.scan`, this one loops in Python over eager steps,
and the constant-action rollout runs as one CUDA kernel.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from gym_copter_tpu_torch.core import prng, vehicles
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import base, tasks
from gym_copter_tpu_torch.envs.base import EnvState, TaskSpec, TimeStep
from gym_copter_tpu_torch.ops import fused_rollout as fr


def default_params(dtype=torch.float32) -> EnvParams:
    return EnvParams(vehicle=vehicles.DJI_PHANTOM)


def _stack(steps):
    """A list of TimeSteps -> one TimeStep with a leading T axis."""
    return TimeStep(*(torch.stack(field) for field in zip(*steps)))


class CopterEnv:
    """A batch of B identical copter environments stepping in lockstep.

    State is threaded explicitly through every method.  `env_id_offset`
    gives a shard its global env-id range, so its randomness matches the
    same envs in a bigger batch."""

    def __init__(self, spec: TaskSpec, params: Optional[EnvParams] = None,
                 num_envs: int = 1, seed: int = 0, env_id_offset: int = 0,
                 dtype=torch.float32, device=None):
        self.spec = spec
        self.params = params if params is not None else default_params(dtype)
        self.num_envs = num_envs
        self.dtype = dtype
        self.device = resolve_device(device)
        self.base_key = prng.PRNGKey(seed, self.device)
        self.env_ids = env_id_offset + torch.arange(
            num_envs, dtype=torch.int32, device=self.device)

    @property
    def observation_size(self) -> int:
        return self.spec.obs_size

    @property
    def action_size(self) -> int:
        return self.spec.action_size

    def reset(self, episode=0, pose=None, perturb_force=None):
        """Returns (EnvState, obs) with obs features-first (obs_dim, B)."""
        episode = torch.full((self.num_envs,), episode, dtype=torch.int32,
                             device=self.device)
        return base.reset(self.base_key, self.env_ids, episode, self.params,
                          self.spec, pose=pose, perturb_force=perturb_force,
                          dtype=self.dtype)

    def step(self, state: EnvState, action) -> tuple[EnvState, TimeStep]:
        """Auto-resetting batched step; action is (action_size, B)."""
        return base.step(state, action, self.base_key, self.env_ids,
                         self.params, self.spec)

    def rollout(self, state: EnvState, policy_fn, num_steps: int,
                policy_state=None, obs=None):
        """Run `num_steps` env steps.  policy_fn(policy_state, obs) ->
        (policy_state, action) with obs features-first.  Returns
        (final_state, final_policy_state, trajectory TimeStep stacked on a
        leading T axis)."""
        if obs is None:
            obs = base._get_obs(state.dyn.x, state.steps, self.params,
                                self.spec)
        traj = []
        for _ in range(num_steps):
            policy_state, action = policy_fn(policy_state, obs)
            state, ts = self.step(state, action)
            obs = ts.obs
            traj.append(ts)
        return state, policy_state, _stack(traj)

    def fused_rollout(self, state: EnvState, action, num_steps: int,
                      seed: int = 0):
        """Run `num_steps` auto-resetting steps with a constant action as
        ONE kernel launch (ops/fused_rollout.py).  On the card that is the
        only path: any batch launches the kernel, and a task outside its
        family raises.  On the CPU the choice is the JAX handle's: the
        plain fused version for a batch of whole 128-lane tiles, else, with
        a logged warning, the step-by-step path.  Returns (EnvState,
        totals) with totals = {'reward_sum': (B,), 'episodes': (B,),
        'path': 'fused'|'scan'}."""
        if state.dyn.x.is_cuda or (fr.supports(self.params, self.spec)
                                   and self.num_envs % fr.LANES == 0):
            state, totals = fr.fused_rollout(state, action, num_steps,
                                             self.params, self.spec,
                                             seed=seed, env_ids=self.env_ids)
            totals['path'] = 'fused'
            return state, totals
        logging.getLogger(__name__).warning(
            'fused_rollout: task %s with batch %d on the CPU took the '
            'step-by-step path; the fused version there needs a batch that '
            'is a multiple of %d', self.spec.name, self.num_envs, fr.LANES)
        state, totals = fr.scan_rollout(state, action, self.base_key,
                                        self.env_ids, num_steps, self.params,
                                        self.spec)
        totals['path'] = 'scan'
        return state, totals

    def run_episode(self, state: EnvState, actions):
        """Step through a scripted action sequence (T, A, B); returns
        (final_state, trajectory TimeStep with a leading T axis)."""
        traj = []
        for action in actions:
            state, ts = self.step(state, action)
            traj.append(ts)
        return state, _stack(traj)


def make(name: str, num_envs: int = 1, params: Optional[EnvParams] = None,
         seed: int = 0, env_id_offset: int = 0, dtype=torch.float32,
         device=None) -> CopterEnv:
    """Factory: `make('Lander3D-v0', num_envs=4096)` on the card, or
    `make(..., device='cpu')`."""
    spec, params = resolve_params(name, params)
    return CopterEnv(spec, params=params, num_envs=num_envs, seed=seed,
                     env_id_offset=env_id_offset, dtype=dtype, device=device)


def resolve_params(name: str, params: Optional[EnvParams] = None):
    """(TaskSpec, EnvParams) of env `name`: the given params, else the env's
    preset, else the default vehicle."""
    if name not in tasks.ALL_TASKS:
        raise KeyError(
            f'Unknown env {name!r}; available: {sorted(tasks.ALL_TASKS)}')
    if params is None:
        preset = tasks.PRESET_PARAMS.get(name)
        params = preset() if preset is not None else default_params()
    return tasks.ALL_TASKS[name], params


def list_envs():
    return sorted(tasks.ALL_TASKS)
