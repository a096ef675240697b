"""The system under test, as the benchmark hands it its inputs: the
measured package's env parameters, task spec and env state built from the
configuration file and from the tensors the benchmark made.  The only
module of the benchmark that imports the measured package; the reference
(port_bench/reference) imports none of it.
"""

from __future__ import annotations

import math


def env_params(cfg: dict):
    """The program's EnvParams for the configuration's `env` group."""
    from gym_copter_tpu_torch.core.types import (EnvParams, LanderRewardParams,
                                                 TaskParams, VehicleParams,
                                                 WorldParams)

    e = cfg['env']
    return EnvParams(
        vehicle=VehicleParams(**e['vehicle']),
        world=WorldParams(g=e['g']),
        task=TaskParams(dt=e['dt'],
                        initial_random_force=e['initial_random_force'],
                        out_of_bounds_penalty=e['out_of_bounds_penalty'],
                        max_steps=e['max_episode_steps'],
                        max_angle=math.radians(e['max_angle_deg']),
                        bounds=e['bounds'],
                        initial_altitude=e['initial_altitude']),
        reward=LanderRewardParams(**e['reward']),
        lift_model=e['lift_model'])


def task_spec(cfg: dict):
    """The program's TaskSpec of the configuration's task, checked against
    what the configuration states of it."""
    from gym_copter_tpu_torch.envs import tasks

    e = cfg['env']
    spec = tasks.ALL_TASKS[e['task']]
    stated = (e['kind'], tuple(e['obs_indices']), e['action_size'],
              e['action_mode'], e['termination'])
    found = (spec.kind, tuple(spec.obs_indices), spec.action_size,
             spec.action_mode, spec.termination)
    if stated != found:
        raise ValueError(f'{e["task"]}: the configuration states {stated}, '
                         f'the program has {found}')
    return spec


def env_state(state):
    """The program's EnvState holding copies of a reference EnvState's
    tensors (the same fields in the same order)."""
    from gym_copter_tpu_torch.core.dynamics import DynamicsState
    from gym_copter_tpu_torch.envs.base import EnvState

    return EnvState(DynamicsState(*(x.clone() for x in state.dyn)),
                    *(x.clone() for x in state[1:]))
