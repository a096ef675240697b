"""Batched, pure-functional PID controllers on torch tensors.

The counterpart of `gym_copter_tpu/control/pid.py` (the reference's
attic/mars/pidcontrollers/__init__.py): the accumulators (integral, last
error, the two-sample derivative smoothing window) are a `PidState` of (B,)
tensors threaded through the policy, so a batch of expert controllers runs
in lockstep, and a step can be captured in a CUDA graph.

Semantics kept from the reference: the windup clamp on the integral, the
3-sample derivative smoothing, the Ki > 0 / Kd > 0 branches (static: gains
are constants), the cascaded position -> velocity set-point controller with
a P-only outer loop, AltitudeHold's NED negation, Descent's stateless z/dz
blend, and AngularVelocity's reset on fast rotation, which zeroes the
integral and the last error but not the smoothing window.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PidState(NamedTuple):
    """Accumulated controller state, one lane per environment."""

    error_i: torch.Tensor
    last_error: torch.Tensor
    delta_error1: torch.Tensor
    delta_error2: torch.Tensor


def pid_init(batch: int, dtype=torch.float32, device=None) -> PidState:
    z = torch.zeros((batch,), dtype=dtype, device=device)
    return PidState(z, z, z, z)


class PidGains(NamedTuple):
    kp: float
    ki: float
    kd: float
    windup_max: float = 0.2


def pid_compute(state: PidState, gains: PidGains, target, actual):
    """One controller update; returns (new_state, demand)."""
    error = target - actual
    demand = error * gains.kp

    error_i = state.error_i
    if gains.ki > 0:
        error_i = torch.clamp(state.error_i + error, -gains.windup_max,
                              gains.windup_max)
        demand = demand + error_i * gains.ki

    last_error, d1, d2 = state.last_error, state.delta_error1, \
        state.delta_error2
    if gains.kd > 0:
        delta_error = error - state.last_error
        demand = demand + (d1 + d2 + delta_error) * gains.kd
        d2 = d1
        d1 = delta_error
        last_error = error

    return PidState(error_i, last_error, d1, d2), demand


class SetPointState(NamedTuple):
    vel: PidState


def setpoint_init(batch: int, dtype=torch.float32,
                  device=None) -> SetPointState:
    return SetPointState(pid_init(batch, dtype, device))


def setpoint_compute(state: SetPointState, gains: PidGains, target, x, dx):
    """Outer P-only position loop (Kp = 1) feeding a velocity PID."""
    target_velocity = target - x
    vel, demand = pid_compute(state.vel, gains, target_velocity, dx)
    return SetPointState(vel), demand


# -- the reference's controllers with its default gains ----------------------

ALTITUDE_HOLD_GAINS = PidGains(kp=0.2, ki=3.0, kd=0.0)
ALTITUDE_HOLD_TARGET = 5.0

POSITION_HOLD_GAINS = PidGains(kp=0.00001, ki=0.1, kd=4.0)
POSITION_HOLD_TARGET = 0.0

DESCENT_KP = 1.15
DESCENT_KD = 1.33

ANGULAR_VELOCITY_GAINS = PidGains(kp=1.0, ki=0.0, kd=1.0, windup_max=6.0)
ANGULAR_VELOCITY_BIG = math.radians(40.0)


def altitude_hold(state: SetPointState, z, dz, target=ALTITUDE_HOLD_TARGET):
    """NED negation, then the set-point cascade."""
    return setpoint_compute(state, ALTITUDE_HOLD_GAINS, target, -z, -dz)


def position_hold(state: SetPointState, x, dx):
    return setpoint_compute(state, POSITION_HOLD_GAINS,
                            POSITION_HOLD_TARGET, x, dx)


def descent(z, dz):
    """Stateless descent demand z * 1.15 + dz * 1.33."""
    return z * DESCENT_KP + dz * DESCENT_KD


def angular_velocity(state: PidState, angvel):
    """Rate damping toward zero; the integral and the last error (only) reset
    when the rotation rate exceeds 40 deg/s."""
    fast = torch.abs(angvel) > ANGULAR_VELOCITY_BIG
    zero = torch.zeros_like(state.error_i)
    state = state._replace(
        error_i=torch.where(fast, zero, state.error_i),
        last_error=torch.where(fast, zero, state.last_error))
    return pid_compute(state, ANGULAR_VELOCITY_GAINS,
                       torch.zeros_like(angvel), angvel)
