"""Batched expert policies: the reference's heuristic demos as pure
functions of tensors, the counterpart of `gym_copter_tpu/control/
heuristics.py`.

Each factory returns (init_policy_state, policy_fn) where
policy_fn(policy_state, obs) -> (policy_state', action), obs features-first
(obs_dim, B) and action (action_size, B).  A policy runs no host code, so a
step of env plus policy can be captured in a CUDA graph (`run_expert`).

The experts, after the reference: constant thrust (lander.py:21,42);
Lander1D descent PID; Lander2D position + descent -> [h-p, h+p]; Lander3D
rate + position PIDs + descent -> the 4-motor mixer [t-r-p, t+r+p, t+r-p,
t-r+p]; Lander3DSimple's PD expert in (throttle, roll, pitch); Hover1D
altitude hold; Hover2D rate + position + altitude -> [h-phi, h+phi];
Hover3D adds yaw rate, mixer [t-r-p-y, t+r+p-y, t+r-p+y, t-r+p+y].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gym_copter_tpu_torch.control import pid
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.core.types import EnvParams

MOTORVAL = 1.625e-2  # reference lander.py:21


def hover_motor_value(params: EnvParams) -> float:
    """Motor value at which total thrust balances gravity under the
    vehicle's lift law: 4*B*omega^2 = M*g ('bouabdallah'), or
    4*0.5*rho*S*C_L*(omega*L/2)^2 = M*g with S = 0.05*L*4
    ('blade_element')."""
    vp, g = params.vehicle, params.world.g
    if params.lift_model == 'blade_element':
        s_area = 0.05 * vp.L * 4.0
        coef = 0.5 * params.world.rho * s_area * vp.C_L * (vp.L / 2.0) ** 2
        omega_hover = math.sqrt(vp.M * g / (4.0 * coef))
    else:
        omega_hover = math.sqrt(vp.M * g / (4.0 * vp.B))
    return omega_hover * 30.0 / (math.pi * vp.maxrpm)


def _mixer_scale(params: Optional[EnvParams]) -> float:
    """The attic experts were tuned for a hover throttle of ~0.5; scaling
    the mixer output by hover_throttle / 0.5 keeps their formulas on that
    vehicle and carries them to any other."""
    if params is None:
        return 1.0
    return hover_motor_value(params) / 0.5


def constant_thrust(action_size: int, batch: int, value: float = MOTORVAL,
                    dtype=torch.float32, device=None):
    """The shipped demo heuristic: the same constant on every motor."""
    act = torch.full((action_size, batch), value, dtype=dtype,
                     device=resolve_device(device))

    def policy_fn(state, obs):
        return state, act

    return None, policy_fn


def lander1d_pid(batch: int, dtype=torch.float32, params=None, device=None):
    s = _mixer_scale(params)

    def policy_fn(state, obs):
        z, dz = obs[0], obs[1]
        return state, pid.descent(z, dz)[None, :] * s

    return None, policy_fn


def lander2d_pid(batch: int, dtype=torch.float32, params=None, device=None):
    s = _mixer_scale(params)
    init = pid.setpoint_init(batch, dtype, resolve_device(device))

    def policy_fn(state, obs):
        y, dy, z, dz = obs[0], obs[1], obs[2], obs[3]
        state, pos_todo = pid.position_hold(state, y, dy)
        hover_todo = pid.descent(z, dz)
        return state, torch.stack([hover_todo - pos_todo,
                                   hover_todo + pos_todo]) * s

    return init, policy_fn


class Lander3DPidState(NamedTuple):
    phi_rate: pid.PidState
    theta_rate: pid.PidState
    x_pos: pid.SetPointState
    y_pos: pid.SetPointState


def lander3d_pid(batch: int, dtype=torch.float32, params=None, device=None):
    """The reference's expert policy."""
    s = _mixer_scale(params)
    device = resolve_device(device)
    init = Lander3DPidState(
        phi_rate=pid.pid_init(batch, dtype, device),
        theta_rate=pid.pid_init(batch, dtype, device),
        x_pos=pid.setpoint_init(batch, dtype, device),
        y_pos=pid.setpoint_init(batch, dtype, device))

    def policy_fn(state, obs):
        x, dx, y, dy, z, dz = obs[0], obs[1], obs[2], obs[3], obs[4], obs[5]
        dphi, dtheta = obs[7], obs[9]

        phi_rate, phi_rate_todo = pid.angular_velocity(state.phi_rate, dphi)
        x_pos, y_pos_todo = pid.position_hold(state.x_pos, y, dy)
        phi_todo = phi_rate_todo + y_pos_todo

        theta_rate, theta_rate_todo = pid.angular_velocity(
            state.theta_rate, -dtheta)
        y_pos, x_pos_todo = pid.position_hold(state.y_pos, x, dx)
        theta_todo = theta_rate_todo + x_pos_todo

        descent_todo = pid.descent(z, dz)

        t = (descent_todo + 1) / 2
        r, p = phi_todo, theta_todo
        action = torch.stack([t - r - p, t + r + p,
                              t + r - p, t - r + p]) * s
        return Lander3DPidState(phi_rate, theta_rate, x_pos, y_pos), action

    return init, policy_fn


def lander3d_simple_pid(batch: int, dtype=torch.float32, params=None,
                        device=None):
    """The attic simple lander's PD expert: angle targets proportional to
    horizontal position and velocity, PD on the angle error, vertical PD
    mapped to [0, 1] throttle through the +0.5 bias; stateless, in the
    (throttle, roll, pitch) demand space."""
    A, B = 0.05, 0.06           # angle target
    C, D, E = 0.025, 0.05, 0.4  # angle PD
    F, G = 1.15, 1.33           # vertical PD

    def policy_fn(state, obs):
        x, dx, y, dy, z, dz = (obs[i] for i in range(6))
        phi, dphi, theta, dtheta = obs[6], obs[7], obs[8], obs[9]
        phi_targ = y * A + dy * B
        phi_todo = (phi - phi_targ) * C + phi * D - dphi * E
        theta_targ = x * A + dx * B
        theta_todo = -(theta + theta_targ) * C - theta * D + dtheta * E
        hover_todo = z * F + dz * G
        return state, torch.stack([hover_todo + 0.5, phi_todo, theta_todo])

    return None, policy_fn


def hover1d_pid(batch: int, dtype=torch.float32,
                target=pid.ALTITUDE_HOLD_TARGET, params=None, device=None):
    s = _mixer_scale(params)
    init = pid.setpoint_init(batch, dtype, resolve_device(device))

    def policy_fn(state, obs):
        z, dz = obs[0], obs[1]
        state, demand = pid.altitude_hold(state, z, dz, target)
        return state, demand[None, :] * s

    return init, policy_fn


class Hover2DPidState(NamedTuple):
    rate: pid.PidState
    pos: pid.SetPointState
    alt: pid.SetPointState


def hover2d_pid(batch: int, dtype=torch.float32,
                target=pid.ALTITUDE_HOLD_TARGET, params=None, device=None):
    s = _mixer_scale(params)
    device = resolve_device(device)
    init = Hover2DPidState(rate=pid.pid_init(batch, dtype, device),
                           pos=pid.setpoint_init(batch, dtype, device),
                           alt=pid.setpoint_init(batch, dtype, device))

    def policy_fn(state, obs):
        y, dy, z, dz, _phi, dphi = (obs[i] for i in range(6))
        rate, rate_todo = pid.angular_velocity(state.rate, dphi)
        pos, pos_todo = pid.position_hold(state.pos, y, dy)
        phi_todo = rate_todo + pos_todo
        alt, hover_todo = pid.altitude_hold(state.alt, z, dz, target)
        action = torch.stack([hover_todo - phi_todo,
                              hover_todo + phi_todo]) * s
        return Hover2DPidState(rate, pos, alt), action

    return init, policy_fn


class Hover3DPidState(NamedTuple):
    roll_rate: pid.PidState
    pitch_rate: pid.PidState
    yaw_rate: pid.PidState
    x_pos: pid.SetPointState
    y_pos: pid.SetPointState
    alt: pid.SetPointState


def hover3d_pid(batch: int, dtype=torch.float32,
                target=pid.ALTITUDE_HOLD_TARGET, params=None, device=None):
    s = _mixer_scale(params)
    device = resolve_device(device)
    init = Hover3DPidState(roll_rate=pid.pid_init(batch, dtype, device),
                           pitch_rate=pid.pid_init(batch, dtype, device),
                           yaw_rate=pid.pid_init(batch, dtype, device),
                           x_pos=pid.setpoint_init(batch, dtype, device),
                           y_pos=pid.setpoint_init(batch, dtype, device),
                           alt=pid.setpoint_init(batch, dtype, device))

    def policy_fn(state, obs):
        x, dx, y, dy, z, dz = (obs[i] for i in range(6))
        dphi, dtheta, dpsi = obs[7], obs[9], obs[11]

        roll_rate, roll_rate_todo = pid.angular_velocity(state.roll_rate,
                                                         dphi)
        x_pos, y_pos_todo = pid.position_hold(state.x_pos, y, dy)

        pitch_rate, pitch_rate_todo = pid.angular_velocity(
            state.pitch_rate, -dtheta)
        y_pos, x_pos_todo = pid.position_hold(state.y_pos, x, dx)

        roll_todo = roll_rate_todo + y_pos_todo
        pitch_todo = pitch_rate_todo + x_pos_todo
        yaw_rate, yaw_todo = pid.angular_velocity(state.yaw_rate, -dpsi)

        alt, hover_todo = pid.altitude_hold(state.alt, z, dz, target)

        t = (hover_todo + 1) / 2
        r, p, yw = roll_todo, pitch_todo, yaw_todo
        action = torch.stack([t - r - p - yw, t + r + p - yw,
                              t + r - p + yw, t - r + p + yw]) * s
        return Hover3DPidState(roll_rate, pitch_rate, yaw_rate,
                               x_pos, y_pos, alt), action

    return init, policy_fn


PID_POLICIES = {
    'Lander1D-v0': lander1d_pid,
    'Lander2D-v0': lander2d_pid,
    'Lander3D-v0': lander3d_pid,
    'Lander-v0': lander3d_pid,
    'Lander3DSimple-v0': lander3d_simple_pid,
    'Hover1D-v0': hover1d_pid,
    'Hover2D-v0': hover2d_pid,
    'Hover3D-v0': hover3d_pid,
}


class ExpertRun(NamedTuple):
    """What `run_expert` returns, per env: the first episode's return,
    whether it ended, and the state x (12, B) at its end."""

    total: torch.Tensor
    done_seen: torch.Tensor
    end_x: torch.Tensor


def run_expert(env_name: str, num_envs: int, num_steps: int,
               params: Optional[EnvParams] = None, seed: int = 0,
               dtype=torch.float32, device=None,
               graphed: Optional[bool] = None) -> ExpertRun:
    """The expert `PID_POLICIES[env_name]` closed loop over `num_envs`
    fresh episodes (key PRNGKey(seed), episode 0) for `num_steps` steps,
    with the mixer scaled for `params` (default: the env's preset, else
    the default vehicle).  Graphed (the default on the card), one policy +
    env step is a CUDA graph replayed num_steps times; `graphed=False` runs
    the same steps eagerly."""
    from gym_copter_tpu_torch.envs import base
    from gym_copter_tpu_torch.envs.registry import resolve_params

    device = resolve_device(device)
    spec, params = resolve_params(env_name, params)
    key = prng.PRNGKey(seed, device)
    env_ids = torch.arange(num_envs, dtype=torch.int32, device=device)
    env_state, obs = base.reset(
        key, env_ids, torch.zeros(num_envs, dtype=torch.int32, device=device),
        params, spec, dtype=dtype)
    pol_state, policy = PID_POLICIES[env_name](num_envs, dtype,
                                               params=params, device=device)

    def steps(env_state, pol_state, obs, total, done_seen, end_x, n=1):
        for _ in range(n):
            pol_state, action = policy(pol_state, obs)
            env_state, ts = base.step(env_state, action, key, env_ids,
                                      params, spec)
            first = ts.done & ~done_seen
            end_x = torch.where(first, ts.x, end_x)
            total = total + torch.where(done_seen, 0.0, ts.reward)
            done_seen = done_seen | ts.done
            obs = ts.obs
        return env_state, pol_state, obs, total, done_seen, end_x

    carry = (env_state, pol_state, obs,
             torch.zeros(num_envs, dtype=dtype, device=device),
             torch.zeros(num_envs, dtype=torch.bool, device=device),
             torch.zeros((12, num_envs), dtype=dtype, device=device))
    if graphed is None:
        graphed = device.type == 'cuda'
    if graphed:
        graph = Graph(steps, warmup=1)
        for _ in range(num_steps):
            carry = graph(*carry)
    else:
        carry = steps(*carry, n=num_steps)
    return ExpertRun(*(x.clone() for x in carry[3:]))
