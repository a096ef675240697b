"""Bouabdallah-2004 quad-X rigid-body dynamics on torch tensors.

The counterpart of `gym_copter_tpu/core/dynamics.py`: one branchless
forward-Euler step over a batch held features-first, x of shape (12,) or
(12, B).  Every expression keeps the JAX package's operand order, so that
float64 trajectories agree with it to rounding, and it keeps the parity
traps of the reference dynamics (gym_copter/dynamics/__init__.py):

  * the perturbation double-count: perturb enters every velocity
    derivative, then is added to the six velocity slots again (:183);
  * the fully negated theta-ddot line and phi-ddot's precedence (:275-284);
  * the touchdown early return: no integration, no perturbation clearing,
    no clock tick (:177 precedes :194, :197);
  * the crash test reads Y_DOT as "velx" and Z_DOT as "vely" (:165-170).

Divisions by a vehicle constant go through `device.div`, so that they round
as IEEE division on the card as well as on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core.device import div
from gym_copter_tpu_torch.core.types import VehicleParams, WorldParams


class DynamicsState(NamedTuple):
    """x (12,)|(12,B) NED state; status ()|(B,) int32 (constants.STATUS_*);
    perturb (6,)|(6,B) pending acceleration (force / M); ticks ()|(B,)
    int32 clock."""

    x: torch.Tensor
    status: torch.Tensor
    perturb: torch.Tensor
    ticks: torch.Tensor


def init_state(x: torch.Tensor) -> DynamicsState:
    """`Dynamics.setState` (reference :210-217): airborne iff z < 0 (NED)."""
    status = torch.where(x[C.STATE_Z] < 0, C.STATUS_AIRBORNE,
                         C.STATUS_LANDED).to(torch.int32)
    zeros6 = x.new_zeros((6,) + tuple(x.shape[1:]))
    ticks = torch.zeros(x.shape[1:], dtype=torch.int32, device=x.device)
    return DynamicsState(x=x, status=status, perturb=zeros6, ticks=ticks)


def body_z_to_inertial(body_z, phi, theta, psi):
    """The body-Z column of the body-to-inertial rotation, scaled by
    body_z (reference :292-302)."""
    cph, sph = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cps, sps = torch.cos(psi), torch.sin(psi)
    rx = sph * sps + cph * cps * sth
    ry = cph * sps * sth - cps * sph
    rz = cph * cth
    return body_z * rx, body_z * ry, body_z * rz


def motor_mix_terms(motorvals: torch.Tensor, vp: VehicleParams,
                    world: WorldParams, lift_model: str = 'bouabdallah'):
    """Eq.6 motor values -> (bz, u2ix, u3iy, u4iz, omega) = (-U1/M, U2/Ix,
    U3/Iy, U4/Iz, rotor disturbance), each of the batch shape.  omega is
    zero under 'bouabdallah' (hardcoded in the reference, :134-135) and
    live under 'blade_element' (attic/mars/dynamics/__init__.py:135-164)."""
    # the reference's association ((m*maxrpm)*pi)/30
    omegas = div(motorvals * vp.maxrpm * math.pi, 30.0)
    o2 = omegas * omegas
    if lift_model == 'blade_element':
        velocity = omegas * (vp.L / 2.0)
        s_area = 0.05 * vp.L * 4.0
        lift = 0.5 * world.rho * s_area * vp.C_L * (velocity * velocity)
        U1 = lift[0] + lift[1] + lift[2] + lift[3]
        U2 = (lift[1] + lift[2]) - (lift[0] + lift[3])
        U3 = (lift[1] + lift[3]) - (lift[0] + lift[2])
        U4 = vp.D * ((o2[0] + o2[1]) - (o2[2] + o2[3]))
        omega = (omegas[0] + omegas[1]) - (omegas[2] + omegas[3])
    else:
        U1 = vp.B * (o2[0] + o2[1] + o2[2] + o2[3])
        U2 = vp.L * vp.B * ((o2[1] + o2[2]) - (o2[0] + o2[3]))
        U3 = vp.L * vp.B * ((o2[1] + o2[3]) - (o2[0] + o2[2]))
        U4 = vp.D * ((o2[0] + o2[1]) - (o2[2] + o2[3]))
        omega = torch.zeros_like(U1)
    return (div(-U1, vp.M), div(U2, vp.Ix), div(U3, vp.Iy), div(U4, vp.Iz),
            omega)


def step(state: DynamicsState, motorvals: torch.Tensor, vp: VehicleParams,
         world: WorldParams, dt: float,
         lift_model: str = 'bouabdallah') -> DynamicsState:
    """One `Dynamics.setMotors` call.  motorvals: (4,) or (4, B) in [0, 1];
    lift_model 'bouabdallah' or 'blade_element'."""
    x, status, perturb = state.x, state.status, state.perturb
    bz, u2ix, u3iy, u4iz, omega = motor_mix_terms(motorvals, vp, world,
                                                  lift_model)

    phi, theta, psi = x[C.STATE_PHI], x[C.STATE_THETA], x[C.STATE_PSI]
    ax, ay, az = body_z_to_inertial(bz, phi, theta, psi)
    netz = az + world.g

    # status machine, phase 1: LANDED -> AIRBORNE (reference :147-149)
    status1 = torch.where((status == C.STATUS_LANDED) & (netz < 0),
                          C.STATUS_AIRBORNE, status)
    leveling = status1 == C.STATUS_LEVELING
    airborne = status1 == C.STATUS_AIRBORNE

    z, dz = x[C.STATE_Z], x[C.STATE_Z_DOT]
    dy = x[C.STATE_Y_DOT]
    touchdown = airborne & (z > 0) & (dz > 0)
    crash = ((dz > C.LANDING_VEL_Y)
             | (torch.abs(dy) > C.LANDING_VEL_X)
             | (torch.abs(phi) > C.LANDING_ANGLE))
    integrate = airborne & ~touchdown

    phidot = x[C.STATE_PHI_DOT]
    thedot = x[C.STATE_THETA_DOT]
    psidot = x[C.STATE_PSI_DOT]
    if lift_model == 'blade_element':
        phi_ddot = (div(psidot * thedot * (vp.Iy - vp.Iz), vp.Ix)
                    - vp.Jr / vp.Ix * thedot * omega
                    + u2ix + perturb[3])
        theta_ddot = (-(div(psidot * phidot * (vp.Iz - vp.Ix), vp.Iy)
                        + vp.Jr / vp.Iy * phidot * omega
                        + u3iy) + perturb[4])
    else:
        # omega == 0: the Jr gyroscopic terms vanish (reference :275-290)
        phi_ddot = (div(psidot * thedot * (vp.Iy - vp.Iz), vp.Ix)
                    + u2ix + perturb[3])
        theta_ddot = (-(div(psidot * phidot * (vp.Iz - vp.Ix), vp.Iy)
                        + u3iy) + perturb[4])
    # the second application of the perturbation (reference :183,
    # `_dxdt[1::2] += perturb`) is the outer `+ perturb[k]` of each
    # velocity slot
    dxdt = torch.stack([
        x[C.STATE_X_DOT],
        (ax + perturb[0]) + perturb[0],
        x[C.STATE_Y_DOT],
        (ay + perturb[1]) + perturb[1],
        x[C.STATE_Z_DOT],
        (netz + perturb[2]) + perturb[2],
        phidot,
        phi_ddot + perturb[3],
        thedot,
        theta_ddot + perturb[4],
        psidot,
        (div(thedot * phidot * (vp.Ix - vp.Iy), vp.Iz) + u4iz
         + perturb[5]) + perturb[5],
    ])

    x_integrated = x + dt * dxdt

    # leveling zeroes roll/pitch then lands (reference :152-156)
    x_leveled = x.clone()
    x_leveled[C.STATE_PHI] = 0
    x_leveled[C.STATE_THETA] = 0

    x_out = torch.where(integrate, x_integrated,
                        torch.where(leveling, x_leveled, x))
    status_out = torch.where(
        leveling, C.STATUS_LANDED,
        torch.where(touchdown,
                    torch.where(crash, C.STATUS_CRASHED, C.STATUS_LEVELING),
                    status1)).to(torch.int32)
    # early return on touchdown: perturbation survives, clock does not tick
    perturb_out = torch.where(touchdown, perturb, torch.zeros_like(perturb))
    ticks_out = state.ticks + (~touchdown).to(torch.int32)
    return DynamicsState(x=x_out, status=status_out, perturb=perturb_out,
                         ticks=ticks_out)


def perturb(state: DynamicsState, force: torch.Tensor,
            vp: VehicleParams) -> DynamicsState:
    """Queue a force perturbation (reference :227-229), stored as force / M
    and consumed by the next step."""
    return state._replace(perturb=div(force.to(state.x.dtype), vp.M))


# The frame-conversion and accessor API of the reference's Dynamics class
# (:199-221, :304-337), which its own env flow never calls: batched, each
# angle () or (B,), each vector (3,) or (3, B).


def _sincos(phi, theta, psi):
    """cos and sin of the three Euler angles (reference `_sincos`,
    :339-350)."""
    return (torch.cos(phi), torch.cos(theta), torch.cos(psi),
            torch.sin(phi), torch.sin(theta), torch.sin(psi))


def inertial_to_body(inertial, phi, theta, psi):
    """An inertial-frame vector in the body frame (reference
    `_inertialToBody`, :304-312)."""
    cph, cth, cps, sph, sth, sps = _sincos(phi, theta, psi)
    ix, iy, iz = inertial[0], inertial[1], inertial[2]
    bx = cps * cth * ix + cth * sps * iy - sth * iz
    by = ((cps * sph * sth - cph * sps) * ix
          + (cph * cps + sph * sps * sth) * iy + cth * sph * iz)
    bz = ((sph * sps + cph * cps * sth) * ix
          + (cph * sps * sth - cps * sph) * iy + cph * cth * iz)
    return torch.stack([bx, by, bz])


def body_to_inertial(body, phi, theta, psi):
    """A body-frame vector in the inertial frame, the transpose of
    `inertial_to_body` (reference `_bodyToInertial`, :314-328)."""
    cph, cth, cps, sph, sth, sps = _sincos(phi, theta, psi)
    bx, by, bz = body[0], body[1], body[2]
    ix = (cps * cth * bx + (cps * sph * sth - cph * sps) * by
          + (sph * sps + cph * cps * sth) * bz)
    iy = (cth * sps * bx + (cph * cps + sph * sps * sth) * by
          + (cph * sps * sth - cps * sph) * bz)
    iz = -sth * bx + cth * sph * by + cph * cth * bz
    return torch.stack([ix, iy, iz])


def euler_to_quaternion(phi, theta, psi):
    """Euler angles as a quaternion (w, x, y, z), (4,) or (4, B), with the
    reference's half-angle expressions and signs, the third component
    negated (`_eulerToQuaternion`, :330-337)."""
    cph, cth, cps, sph, sth, sps = _sincos(phi / 2, theta / 2, psi / 2)
    return torch.stack([
        cph * cth * cps + sph * sth * sps,
        cph * sth * sps - sph * cth * cps,
        -cph * sth * cps - sph * cth * sps,
        cph * cth * sps - sph * sth * cps,
    ])


STATE_KEYS = ('x', 'dx', 'y', 'dy', 'z', 'dz',
              'phi', 'dphi', 'theta', 'dtheta', 'psi', 'dpsi')


def state_dict(state: DynamicsState):
    """The vehicle state as {name: () or (B,) tensor}, in the key order of
    `Dynamics.getState` (reference :199-207)."""
    return {key: state.x[i] for i, key in enumerate(STATE_KEYS)}


def get_time(state: DynamicsState, dt: float):
    """Simulated time ticks * dt in the state's float dtype
    (`Dynamics.getTime`, reference :219-221); a touchdown step does not
    tick (:177)."""
    return state.ticks.to(state.x.dtype) * dt
