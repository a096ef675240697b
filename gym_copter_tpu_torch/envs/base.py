"""Batched, functional environment layer on torch tensors.

The counterpart of `gym_copter_tpu/envs/base.py` (the reference task layer,
gym_copter/envs/task.py:77-197): the whole state of B environments is a
NamedTuple of features-first (…, B) tensors, and episode boundaries are a
masked auto-reset inside the step.  Each env's reset randomness is keyed by
`fold_in(fold_in(base_key, global_env_id), episode)` with the port's
threefry (core/prng.py), so the kicks are the JAX package's bits and do
not depend on batch size or layout.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core import dynamics, prng
from gym_copter_tpu_torch.core.dynamics import DynamicsState
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.utils import profiling


class TaskSpec(NamedTuple):
    """Static task description; the fields and their meaning are those of
    the JAX package's `TaskSpec` (envs/base.py:35-92).

    kind: 'lander', 'lander_simple', 'hover', 'althold', 'takeoff',
    'distance' or 'target'.  action_mode: 'clip01', 'rescale01', 'raw' or
    'demand3'.  termination: 'standard', 'simple', 'crash_only' or 'none'.
    """

    name: str
    kind: str
    obs_indices: Tuple[int, ...]
    action_size: int
    mix_matrix: Tuple[Tuple[float, ...], ...]
    action_mode: str = 'clip01'
    termination: str = 'standard'
    skip_when_landed: bool = True
    start_altitude: Optional[float] = None
    negate_obs: bool = False
    perturb_on_reset: bool = True
    start_xy_offset: float = 0.0
    integrate_on_reset: bool = False

    @property
    def obs_size(self) -> int:
        return len(self.obs_indices) + (3 if self.kind == 'target' else 0)


class EnvState(NamedTuple):
    """Carried state for a batch of B environments (all tensors (…, B))."""

    dyn: DynamicsState              # x (12,B), status, perturb (6,B), ticks
    prev_shaping: torch.Tensor      # (B,) shaping value of the previous step
    steps: torch.Tensor             # (B,) int32, counts the initializing step
    episode: torch.Tensor           # (B,) int32 episode index (keys randomness)
    initial_random_x: torch.Tensor  # (B,) sign of the reset Y-force


class TimeStep(NamedTuple):
    """Step output.  obs (obs_dim, B) already belongs to the new episode on
    done steps; reward/done/status/x describe the finished step."""

    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    spinning: torch.Tensor
    x: torch.Tensor


def tree_where(cond, a, b):
    """Per-env select over matching NamedTuples; cond is (B,)."""
    if isinstance(a, tuple):
        return type(a)(*(tree_where(cond, u, v) for u, v in zip(a, b)))
    return torch.where(cond, a, b)


@functools.lru_cache(maxsize=None)
def _const(value, dtype, device):
    """A constant tensor made once per device, so that a step on the card
    does not copy it from the host each time."""
    return torch.tensor(value, dtype=dtype, device=device)


def _shaping(x, params: EnvParams, spec: TaskSpec):
    """Per-kind shaping potential (JAX base._shaping)."""
    if spec.kind == 'lander':
        rp = params.reward
        pos = x[0:6]
        yaw = x[10:12]
        s = -(rp.xyz_penalty_factor * torch.sqrt(torch.sum(pos * pos, dim=0))
              + rp.yaw_penalty_factor * torch.sqrt(torch.sum(yaw * yaw, dim=0)))
        return s - torch.where(torch.abs(x[C.STATE_Z_DOT]) > rp.dz_max,
                               rp.dz_penalty, 0.0).to(x.dtype)
    if spec.kind == 'lander_simple':
        rp = params.reward
        pos = x[0:6]
        ang = x[6:10]
        return -(rp.xyz_penalty_factor * torch.sqrt(torch.sum(pos * pos, dim=0))
                 + rp.pitch_roll_penalty_factor
                 * torch.sqrt(torch.sum(ang * ang, dim=0)))
    if spec.kind == 'takeoff':
        altitude = -x[C.STATE_Z]
        return -torch.abs(altitude - params.task.takeoff_target)
    if spec.kind == 'distance':
        return torch.sqrt(x[C.STATE_X] * x[C.STATE_X]
                          + x[C.STATE_Y] * x[C.STATE_Y])
    return x.new_zeros(x.shape[1:])


def _reward(entry_status, x, prev_shaping, params: EnvParams,
            spec: TaskSpec):
    """Returns (reward, new_shaping, done_from_reward) for the task kind."""
    zeros = x.new_zeros(x.shape[1:])
    no_done = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)

    if spec.kind == 'hover':
        return x.new_ones(x.shape[1:]), zeros, no_done
    if spec.kind == 'althold':
        altitude = -x[C.STATE_Z]
        on_target = (torch.abs(altitude - params.task.althold_target)
                     < params.task.althold_tolerance)
        return on_target.to(x.dtype), zeros, no_done
    if spec.kind == 'target':
        return zeros, zeros, no_done
    if spec.kind in ('takeoff', 'distance'):
        shaping = _shaping(x, params, spec)
        return shaping - prev_shaping, shaping, no_done
    if spec.kind == 'lander_simple':
        shaping = _shaping(x, params, spec)
        return (shaping - prev_shaping, shaping,
                entry_status == C.STATUS_LANDED)

    rp = params.reward
    shaping = _shaping(x, params, spec)
    reward = shaping - prev_shaping
    landed = entry_status == C.STATUS_LANDED
    inside = torch.sqrt(x[C.STATE_X] * x[C.STATE_X]
                        + x[C.STATE_Y] * x[C.STATE_Y]) < rp.target_radius
    reward = reward + torch.where(landed & inside, rp.inside_radius_bonus,
                                  0.0).to(x.dtype)
    return reward, shaping, landed


def _get_obs(x, steps, params: EnvParams, spec: TaskSpec):
    """Rows `obs_indices` of the state, negated into ENU where the task
    says so, plus the circling-target rows for the 'target' kind."""
    obs = x[_const(spec.obs_indices, torch.int64, x.device)]
    if spec.negate_obs:
        obs = -obs
    if spec.kind == 'target':
        t = params.task
        theta = t.target_dtheta * (steps - 1).to(x.dtype)
        tx = t.target_orbit_radius * torch.cos(theta)
        ty = t.target_orbit_radius * torch.sin(theta)
        talt = torch.full_like(tx, t.target_altitude)
        obs = torch.cat([obs, tx[None], ty[None], talt[None]], dim=0)
    return obs


def _initial_forces(base_key, env_ids, episode, params: EnvParams, dtype):
    """Per-env reset wind kick ~ U(-F, +F)^3 on (X, Y, Z), keyed by
    (global env id, episode index); returns (6, B)."""
    f = float(params.task.initial_random_force)
    keys = prng.fold_in(prng.fold_in(base_key, env_ids), episode)
    forces3 = prng.uniform(keys, 3, -f, f, dtype).T
    return torch.cat([forces3, torch.zeros_like(forces3)], dim=0)


def reset(base_key, env_ids, episode, params: EnvParams, spec: TaskSpec, *,
          pose=None, perturb_force=None,
          dtype=torch.float32) -> Tuple[EnvState, torch.Tensor]:
    """Fresh state for a batch of envs, including the reference's trailing
    zero-action initializing step (task.py:197): it seeds `prev_shaping`
    and advances the step counter to 1.

    env_ids, episode: (B,) integer tensors on the env's device.
    pose: optional (x, y, altitude, phi_deg, theta_deg) start pose.
    perturb_force: optional (6, B) force override.
    Returns (EnvState, obs (obs_dim, B))."""
    device = env_ids.device
    env_ids = env_ids.to(torch.int32)
    episode = episode.to(torch.int32)
    b = env_ids.shape[0]

    if pose is None:
        altitude = (spec.start_altitude if spec.start_altitude is not None
                    else params.task.initial_altitude)
        pose = (spec.start_xy_offset, spec.start_xy_offset, altitude,
                0.0, 0.0)

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=device)

    x = torch.zeros((12, b), dtype=dtype, device=device)
    x[C.STATE_X] = scalar(pose[0])
    x[C.STATE_Y] = scalar(pose[1])
    x[C.STATE_Z] = scalar(-pose[2])
    x[C.STATE_PHI] = scalar(pose[3]) * (math.pi / 180)
    x[C.STATE_THETA] = scalar(pose[4]) * (math.pi / 180)

    if perturb_force is not None:
        forces = torch.as_tensor(perturb_force, dtype=dtype, device=device)
    elif spec.perturb_on_reset:
        forces = _initial_forces(base_key, env_ids, episode, params, dtype)
    else:
        forces = torch.zeros((6, b), dtype=dtype, device=device)

    dyn = dynamics.perturb(dynamics.init_state(x), forces, params.vehicle)
    if spec.integrate_on_reset:
        # the attic simple task's reset is a real zero-demand step
        # (simple_lander3d.py:79)
        dyn = dynamics.step(dyn, x.new_zeros((4, b)), params.vehicle,
                            params.world, params.task.dt,
                            lift_model=params.lift_model)
        x = dyn.x

    steps = torch.ones((b,), dtype=torch.int32, device=device)
    state = EnvState(dyn=dyn, prev_shaping=_shaping(x, params, spec),
                     steps=steps, episode=episode,
                     initial_random_x=torch.sign(forces[1]))
    return state, _get_obs(x, steps, params, spec)


def motors_from_action(action, spec: TaskSpec):
    """The action -> motor values map of the task (clip, rescale or the
    demand mix), before the (4, A) mix matrix is applied."""
    if spec.action_mode == 'clip01':
        return torch.clamp(action, 0.0, 1.0)
    if spec.action_mode == 'rescale01':
        return (1.0 + action) / 2.0
    if spec.action_mode == 'demand3':
        # throttle clipped to [0,1] pre-mix; roll/pitch stay signed
        return torch.cat([torch.clamp(action[:1], 0.0, 1.0), action[1:]])
    return action


def mix_motors(motors, spec: TaskSpec):
    """(4, A) mix matrix times the (A, B) motor values, clipped after the
    mix for 'demand3' (simple_lander3d.py:99)."""
    m4 = _const(spec.mix_matrix, motors.dtype, motors.device) @ motors
    if spec.action_mode == 'demand3':
        m4 = torch.clamp(m4, 0.0, 1.0)
    return m4


def _raw_step(state: EnvState, action, params: EnvParams, spec: TaskSpec):
    """One transition without auto-reset (task.py:77-137), branchless."""
    x_dtype = state.dyn.x.dtype
    entry_status = state.dyn.status
    landed = entry_status == C.STATUS_LANDED

    motors = motors_from_action(action.to(x_dtype), spec)
    spinning = (~landed) & (torch.sum(motors, dim=0) > 0)
    stepped = dynamics.step(state.dyn, mix_motors(motors, spec),
                            params.vehicle, params.world, params.task.dt,
                            lift_model=params.lift_model)
    dyn = tree_where(landed, state.dyn, stepped) if spec.skip_when_landed \
        else stepped
    x = dyn.x

    reward, shaping, done_r = _reward(entry_status, x, state.prev_shaping,
                                      params, spec)
    t = params.task
    if spec.termination in ('standard', 'simple'):
        oob = ((torch.abs(x[C.STATE_X]) >= t.bounds)
               | (torch.abs(x[C.STATE_Y]) >= t.bounds))
        tilt = ((torch.abs(x[C.STATE_PHI]) >= t.max_angle)
                | (torch.abs(x[C.STATE_THETA]) >= t.max_angle))
        crashed = entry_status == C.STATUS_CRASHED
        penalty = t.out_of_bounds_penalty
        if spec.termination == 'standard':
            # out-of-bounds SUBTRACTS the penalty; tilt REPLACES the reward
            reward = torch.where(oob, reward - penalty,
                                 torch.where(tilt, -penalty, reward))
        else:
            # attic simple lander: both REPLACE the reward, and the
            # inside-radius bonus (squared compare) is added afterwards
            rp = params.reward
            reward = torch.where(oob | tilt, -penalty, reward)
            inside = (x[C.STATE_X] * x[C.STATE_X] + x[C.STATE_Y] * x[C.STATE_Y]
                      < rp.target_radius ** 2)
            reward = reward + torch.where(landed & inside,
                                          rp.inside_radius_bonus,
                                          0.0).to(x_dtype)
        done = done_r | oob | tilt | crashed
    elif spec.termination == 'crash_only':
        done = dyn.status == C.STATUS_CRASHED
    else:
        done = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
    done = done | (state.steps == t.max_steps)

    new_state = EnvState(dyn=dyn, prev_shaping=shaping,
                         steps=state.steps + 1, episode=state.episode,
                         initial_random_x=state.initial_random_x)
    # target-kind obs uses the entry step count (target.py:44-47)
    obs = _get_obs(x, state.steps, params, spec)
    return new_state, obs, reward, done, spinning


def step(state: EnvState, action, base_key, env_ids, params: EnvParams,
         spec: TaskSpec) -> Tuple[EnvState, TimeStep]:
    """Environment step with auto-reset: finished slots are replaced in
    place by freshly reset episodes.  Inside a `core/graph.Graph` capture
    the recorder (utils/profiling.py) counts the nodes of its three
    regions: the transition, the reset draw and the select."""
    profiling.region('env.transition')
    new_state, obs, reward, done, spinning = _raw_step(state, action, params,
                                                       spec)
    profiling.region('env.reset_draw')
    fresh_state, fresh_obs = reset(base_key, env_ids, state.episode + 1,
                                   params, spec, dtype=state.dyn.x.dtype)
    profiling.region('env.select')
    out_state = tree_where(done, fresh_state, new_state)
    out_obs = torch.where(done, fresh_obs, obs)
    profiling.region(None)
    ts = TimeStep(obs=out_obs, reward=reward, done=done,
                  status=new_state.dyn.status, spinning=spinning,
                  x=new_state.dyn.x)
    return out_state, ts
