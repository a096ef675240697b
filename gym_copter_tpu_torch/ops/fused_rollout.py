"""Fused constant-action rollout: T auto-resetting env steps in ONE kernel.

The counterpart of `gym_copter_tpu/ops/pallas_rollout.py`.  The batched env
step is about 150 flops per env; run step by step, every step reads and
writes the whole env state in device memory.  `fused_rollout` instead runs
the whole T-step rollout in one launch of `csrc/fused_rollout.cu`: a group
of L lanes (`lanes_for`) holds one env's state in registers for all T
steps and writes back only the final state, its reward sum and its count
of finished episodes.

The transition is that of `envs/base.step` under a constant action: the
Eq.6 thrust and torque terms are computed once, outside the kernel, by
`_motor_mix` (plain torch, the op order of core/dynamics.step).  The
auto-reset returns to the default pose; with reset randomness on, the wind
kick `(2u - 1) * F/M` takes u from a counter hash of (global env id,
episode + 1, seed, axis), `_kick_u01`, so that the kicks do not depend on
the batch layout.  The hash is not the env's threefry stream: the fused and
the step-by-step rollouts agree bit for bit only with
`initial_random_force == 0`, as in the JAX package.

`fused_rollout_reference` is the plain version of the kernel: the same
transition written on tensors and looped T times.  `fused_rollout` uses it
for tensors on the CPU; on the card it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core import dynamics
from gym_copter_tpu_torch.core.device import div
from gym_copter_tpu_torch.core.dynamics import DynamicsState
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.core.tree import tree_map
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import base
from gym_copter_tpu_torch.envs.base import EnvState, TaskSpec
from gym_copter_tpu_torch.ops import _build
from gym_copter_tpu_torch.utils import profiling

LANES = 128
# lanes per env the kernel is built for; the warp schedulers of an SM; and
# the warps per scheduler up to which 4 lanes per env beat 1 (PERF.md,
# the lanes sweep of chip_smoke.py)
LANES_PER_ENV = (1, 4)
SCHEDULERS_PER_SM = 4
WARPS_PER_SCHEDULER = 3

_KINDS = ('lander', 'lander_simple', 'hover', 'althold', 'takeoff',
          'distance', 'target')
_TERMINATIONS = ('standard', 'simple', 'crash_only', 'none')

# per-axis salts decorrelating the three kick components
_KICK_AXIS = (0x2545F491, 0x63173B93, 0x1B56C4E9)
_M32 = 0xFFFFFFFF


def supports(params: EnvParams, spec: TaskSpec) -> bool:
    """Whether the fused kernel covers this task: every kind in the
    registry.  (Target's moving target lives only in the observation,
    which the constant-action rollout never makes, so in the kernel it is
    crash-only termination and zero reward.)"""
    return (spec.kind in _KINDS
            and spec.termination in _TERMINATIONS
            and spec.action_mode in ('clip01', 'rescale01', 'raw',
                                     'demand3'))


def _motor_mix(action, params: EnvParams, spec: TaskSpec, dtype):
    """The action -> motors4 path of envs/base._raw_step, then Eq.6: the
    kernel's constant (bz, u2ix, u3iy, u4iz, omega), each (B,)."""
    motors = base.motors_from_action(action.to(dtype), spec)
    return dynamics.motor_mix_terms(base.mix_motors(motors, spec),
                                params.vehicle, params.world,
                                params.lift_model)


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 tensors a in [0, 2**32) and a constant
    c, split in 16-bit halves so that no product overflows int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _kick_u01(eid, ep, salt: int, axis_salt: int, dtype):
    """Counter-based uniform in [0, 1): the murmur3-fmix32-style hash of
    (global env id, episode index, salt, axis) of the JAX package's
    `_kick_u01`, in uint32 arithmetic emulated on int64 (torch's int32 `>>`
    is arithmetic).  The top 24 bits give a float32-exact uniform."""
    eid = eid.to(torch.int64) & _M32
    ep = ep.to(torch.int64) & _M32
    x = (_mul32(eid, 0x9E3779B9) + _mul32(ep, 0x85EBCA6B)) & _M32
    x = x ^ (((salt & _M32) * 0xC2B2AE35) & _M32) ^ axis_salt
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = _mul32(x ^ (x >> 16), 0x9E3779B1)
    x = x ^ (x >> 16)
    return (x >> 8).to(dtype) * (2.0 ** -24)


def _reset_constants(params: EnvParams, spec: TaskSpec):
    """The auto-reset target state with the default pose: (xy0, alt, dz0,
    ticks0, status0, s0) = start X/Y offset, start altitude, initial Z
    velocity, clock, status and prev_shaping, in float32 as envs/base.reset
    computes them.  With `integrate_on_reset` the one deterministic
    free-fall Euler step of the reset is folded in: dz0 = dt*g, ticks0 = 1,
    shaping from the integrated state."""
    alt = (spec.start_altitude if spec.start_altitude is not None
           else params.task.initial_altitude)
    alt = float(alt)
    xy0 = float(spec.start_xy_offset)
    status0 = C.STATUS_AIRBORNE if alt > 0 else C.STATUS_LANDED
    dz0, ticks0 = 0.0, 0
    if spec.integrate_on_reset:
        if spec.perturb_on_reset or not alt > 0:
            raise ValueError('integrate_on_reset constants assume a '
                             'deterministic airborne reset')
        dz0 = float(np.float32(params.task.dt) * np.float32(params.world.g))
        ticks0 = 1
    if spec.kind == 'lander':
        rp = params.reward
        z = np.float32(-alt)
        s0 = float(-(np.float32(rp.xyz_penalty_factor) * np.sqrt(z * z)
                     + np.float32(rp.yaw_penalty_factor) * np.float32(0.0)))
    elif spec.kind == 'lander_simple':
        rp = params.reward
        pos = np.array([xy0, 0.0, xy0, 0.0, -alt, dz0], np.float32)
        s0 = float(-(np.float32(rp.xyz_penalty_factor)
                     * np.float32(np.sqrt(np.sum(pos * pos)))
                     + np.float32(rp.pitch_roll_penalty_factor)
                     * np.float32(0.0)))
    elif spec.kind == 'takeoff':
        s0 = float(-np.abs(np.float32(alt)
                           - np.float32(params.task.takeoff_target)))
    else:  # hover / althold / distance / target carry zero initial shaping
        s0 = 0.0
    return xy0, alt, dz0, ticks0, status0, s0


class StepConstants(NamedTuple):
    """Everything the transition needs besides the carried state, as
    Python numbers combined in double precision, the way the JAX trace
    combines them; each float is rounded to float32 where it is used.  The
    kernel receives the floats and the ints as two arrays in field order
    (`csrc/fused_rollout.cu`, struct Consts)."""

    dt: float
    g: float
    Ix: float
    Iy: float
    Iz: float
    iy_iz: float
    iz_ix: float
    ix_iy: float
    jr_ix: float
    jr_iy: float
    landing_vel_x: float
    landing_vel_y: float
    landing_angle: float
    xyz_pen: float
    yaw_pen: float
    pr_pen: float
    dz_max: float
    dz_penalty: float
    target_radius: float
    target_radius_sq: float
    bonus: float
    bounds: float
    max_angle: float
    oob_penalty: float
    althold_target: float
    althold_tol: float
    takeoff_target: float
    kick_scale: float
    xy0: float
    z0: float
    dz0: float
    s0: float
    # ints from here on
    ticks0: int
    status0: int
    max_steps: int
    kind: int
    termination: int
    blade: int
    skip_when_landed: int
    random_reset: int


N_FLOAT_CONSTANTS = StepConstants._fields.index('ticks0')


def step_constants(params: EnvParams, spec: TaskSpec,
                   random_reset: bool) -> StepConstants:
    vp, t, rp = params.vehicle, params.task, params.reward
    xy0, alt0, dz0, ticks0, status0, s0 = _reset_constants(params, spec)
    return StepConstants(
        dt=t.dt, g=params.world.g, Ix=vp.Ix, Iy=vp.Iy, Iz=vp.Iz,
        iy_iz=vp.Iy - vp.Iz, iz_ix=vp.Iz - vp.Ix, ix_iy=vp.Ix - vp.Iy,
        jr_ix=vp.Jr / vp.Ix, jr_iy=vp.Jr / vp.Iy,
        landing_vel_x=C.LANDING_VEL_X, landing_vel_y=C.LANDING_VEL_Y,
        landing_angle=C.LANDING_ANGLE,
        xyz_pen=rp.xyz_penalty_factor, yaw_pen=rp.yaw_penalty_factor,
        pr_pen=rp.pitch_roll_penalty_factor, dz_max=rp.dz_max,
        dz_penalty=rp.dz_penalty, target_radius=rp.target_radius,
        target_radius_sq=rp.target_radius * rp.target_radius,
        bonus=rp.inside_radius_bonus, bounds=t.bounds,
        max_angle=t.max_angle, oob_penalty=t.out_of_bounds_penalty,
        althold_target=t.althold_target, althold_tol=t.althold_tolerance,
        takeoff_target=t.takeoff_target,
        # F/M divided host-side: (2u - 1) is exact, leaving one rounding
        kick_scale=float(t.initial_random_force) / float(vp.M),
        xy0=xy0, z0=0.0 + (-alt0), dz0=dz0, s0=s0,
        ticks0=ticks0, status0=status0, max_steps=int(t.max_steps),
        kind=_KINDS.index(spec.kind),
        termination=_TERMINATIONS.index(spec.termination),
        blade=int(params.lift_model == 'blade_element'),
        skip_when_landed=int(spec.skip_when_landed),
        random_reset=int(random_reset))


def _env_step(carry, u, eid, seed: int, c: StepConstants, spec: TaskSpec):
    """One transition of the plain version, each carried value a (B,)
    tensor, in the op order of the kernel.  Returns (carry', reward, done);
    carry' already holds the fresh episodes of done lanes."""
    xs, ps, status, ticks, steps, pshape, ep = carry
    bz, u2ix, u3iy, u4iz, om = u
    x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11 = xs
    p0, p1, p2, p3, p4, p5 = ps
    zero = torch.zeros_like(x0)
    entry_landed = status == C.STATUS_LANDED

    cph, sph = torch.cos(x6), torch.sin(x6)
    cth, sth = torch.cos(x8), torch.sin(x8)
    cps, sps = torch.cos(x10), torch.sin(x10)
    rx = sph * sps + cph * cps * sth
    ry = cph * sps * sth - cps * sph
    rz = cph * cth
    ax, ay, az = bz * rx, bz * ry, bz * rz
    netz = az + c.g

    status1 = torch.where(entry_landed & (netz < 0), C.STATUS_AIRBORNE,
                          status)
    leveling = status1 == C.STATUS_LEVELING
    airborne = status1 == C.STATUS_AIRBORNE
    touchdown = airborne & (x4 > 0) & (x5 > 0)
    crash = ((x5 > c.landing_vel_y) | (torch.abs(x3) > c.landing_vel_x)
             | (torch.abs(x6) > c.landing_angle))
    integrate = airborne & ~touchdown

    if c.blade:
        phi_dd = (div(x11 * x9 * c.iy_iz, c.Ix) - c.jr_ix * x9 * om
                  + u2ix + p3)
        the_dd = -(div(x11 * x7 * c.iz_ix, c.Iy) + c.jr_iy * x7 * om
                   + u3iy) + p4
    else:
        phi_dd = div(x11 * x9 * c.iy_iz, c.Ix) + u2ix + p3
        the_dd = -(div(x11 * x7 * c.iz_ix, c.Iy) + u3iy) + p4
    psi_dd = div(x9 * x7 * c.ix_iy, c.Iz) + u4iz + p5
    # the perturbation double-count of core/dynamics.step
    d = (x1, (ax + p0) + p0, x3, (ay + p1) + p1,
         x5, (netz + p2) + p2, x7, phi_dd + p3,
         x9, the_dd + p4, x11, psi_dd + p5)

    # landed envs skip the dynamics unless the task drives them from the
    # ground; the selects of dynamics.step and of the skip are disjoint
    skip = entry_landed if c.skip_when_landed else torch.zeros_like(
        entry_landed)
    eff_integ = integrate & ~skip
    eff_level = leveling & ~skip
    keep_p = skip | touchdown
    ys = [torch.where(eff_integ, xv + c.dt * dv, xv) for xv, dv in zip(xs, d)]
    ys[6] = torch.where(eff_level, zero, ys[6])
    ys[8] = torch.where(eff_level, zero, ys[8])
    ps_n = tuple(torch.where(keep_p, pv, zero) for pv in ps)
    status_n = torch.where(
        skip, status,
        torch.where(leveling, C.STATUS_LANDED,
                    torch.where(touchdown,
                                torch.where(crash, C.STATUS_CRASHED,
                                            C.STATUS_LEVELING),
                                status1))).to(torch.int32)
    ticks_n = ticks + (~keep_p).to(torch.int32)
    y0, y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11 = ys

    kind = spec.kind
    no_done = torch.zeros_like(entry_landed)
    if kind in ('lander', 'lander_simple'):
        pos_sq = (y0 * y0 + y1 * y1 + y2 * y2
                  + y3 * y3 + y4 * y4 + y5 * y5)
        if kind == 'lander':
            yaw_sq = y10 * y10 + y11 * y11
            shaping = -(c.xyz_pen * torch.sqrt(pos_sq)
                        + c.yaw_pen * torch.sqrt(yaw_sq))
            shaping = shaping - torch.where(torch.abs(y5) > c.dz_max,
                                            c.dz_penalty, 0.0).to(x0.dtype)
            reward = shaping - pshape
            inside = torch.sqrt(y0 * y0 + y2 * y2) < c.target_radius
            reward = reward + torch.where(entry_landed & inside, c.bonus,
                                          0.0).to(x0.dtype)
        else:
            # the bonus comes after the 'simple' termination below
            ang_sq = y6 * y6 + y7 * y7 + y8 * y8 + y9 * y9
            shaping = -(c.xyz_pen * torch.sqrt(pos_sq)
                        + c.pr_pen * torch.sqrt(ang_sq))
            reward = shaping - pshape
        done = entry_landed
    elif kind == 'althold':
        shaping = zero
        reward = (torch.abs(-y4 - c.althold_target)
                  < c.althold_tol).to(x0.dtype)
        done = no_done
    elif kind == 'takeoff':
        shaping = -torch.abs(-y4 - c.takeoff_target)
        reward = shaping - pshape
        done = no_done
    elif kind == 'distance':
        shaping = torch.sqrt(y0 * y0 + y2 * y2)
        reward = shaping - pshape
        done = no_done
    elif kind == 'target':
        shaping = zero
        reward = zero
        done = no_done
    else:  # hover: +1 per surviving step
        shaping = zero
        reward = torch.ones_like(x0)
        done = no_done

    if spec.termination == 'crash_only':
        done = done | (status_n == C.STATUS_CRASHED)
    elif spec.termination in ('standard', 'simple'):
        oob = (torch.abs(y0) >= c.bounds) | (torch.abs(y2) >= c.bounds)
        tilt = (torch.abs(y6) >= c.max_angle) | (torch.abs(y8) >= c.max_angle)
        crashed = status == C.STATUS_CRASHED
        if spec.termination == 'simple':
            reward = torch.where(oob | tilt, -c.oob_penalty, reward)
            inside = y0 * y0 + y2 * y2 < c.target_radius_sq
            reward = reward + torch.where(entry_landed & inside, c.bonus,
                                          0.0).to(x0.dtype)
        else:
            reward = torch.where(oob, reward - c.oob_penalty,
                                 torch.where(tilt, -c.oob_penalty, reward))
        done = done | oob | tilt | crashed
    done = done | (steps == c.max_steps)

    # auto-reset to the default pose
    ep1 = ep + 1
    if c.random_reset:
        kick = tuple((2.0 * _kick_u01(eid, ep1, seed, ax_salt, x0.dtype)
                      - 1.0) * c.kick_scale for ax_salt in _KICK_AXIS)
    else:
        kick = (zero, zero, zero)
    reset_x = (c.xy0, 0.0, c.xy0, 0.0, c.z0, c.dz0) + (0.0,) * 6
    xs_r = tuple(torch.where(done, rv, nv) for rv, nv in zip(reset_x, ys))
    ps_r = tuple(torch.where(done, rv, nv)
                 for rv, nv in zip(kick + (zero, zero, zero), ps_n))
    status_r = torch.where(done, c.status0, status_n)
    ticks_r = torch.where(done, c.ticks0, ticks_n)
    steps_r = torch.where(done, 1, steps + 1)
    pshape_r = torch.where(done, c.s0, shaping)
    ep_r = torch.where(done, ep1, ep)
    return ((xs_r, ps_r, status_r, ticks_r, steps_r, pshape_r, ep_r),
            reward, done)


def _rollout_plain(arrays, u, num_steps, seed, c: StepConstants,
                   spec: TaskSpec):
    x, perturb, status, ticks, steps, pshape, episode, env_ids = arrays
    carry = (tuple(x), tuple(perturb), status, ticks, steps, pshape, episode)
    u = tuple(u)
    acc = torch.zeros_like(pshape)
    eps = torch.zeros_like(status)
    for _ in range(num_steps):
        carry, reward, done = _env_step(carry, u, env_ids, seed, c, spec)
        acc = acc + reward
        eps = eps + done.to(torch.int32)
    xs, ps, status, ticks, steps, pshape, episode = carry
    return (torch.stack(xs), torch.stack(ps), status, ticks, steps, pshape,
            episode, acc, eps)


def lanes_for(b: int, sm_count: int) -> int:
    """Lanes per env for a batch of `b` envs on a card of `sm_count` SMs:
    the largest L in LANES_PER_ENV whose L * b threads make at most
    WARPS_PER_SCHEDULER warps per warp scheduler, else 1.  A group of L
    lanes splits the step's independent heavy work, which shortens the
    step where a scheduler has too few warps to hide its latency, and only
    replicates work once the schedulers are busy."""
    budget = WARPS_PER_SCHEDULER * SCHEDULERS_PER_SM * sm_count * 32
    fits = [n for n in LANES_PER_ENV if n * b <= budget]
    return max(fits) if fits else 1


def _kernel_library():
    """The built `csrc/fused_rollout.cu`, with its C signatures declared."""
    lib = _build.load('fused_rollout')
    fn = lib.gct_fused_rollout
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 22
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        check = lib.gct_check_sincos
        check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        check.restype = ctypes.c_int
    return lib


def sincos_mismatches(device) -> int:
    """How many of the 2**32 float32 values give other bits from the
    kernel's sincosf than from sinf and cosf (a NaN against a NaN counts
    as equal), counted on the card by `gct_check_sincos`."""
    lib = _kernel_library()
    differ = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(differ.device):
        err = lib.gct_check_sincos(
            differ.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'gct_check_sincos launch failed: '
                           f'{_build.error_string(lib, err)}')
    return int(differ)


def _rollout_cuda(arrays, u, num_steps, seed, c: StepConstants, *,
                  lanes=None):
    """Launch `csrc/fused_rollout.cu` on the current stream, with `lanes`
    lanes per env (default `lanes_for` the batch and the card)."""
    x, perturb = arrays[0], arrays[1]
    b = x.shape[-1]
    if 12 * b >= 2 ** 31:
        raise ValueError(f'fused_rollout: batch {b} overflows the kernel\'s '
                         f'int32 offsets')
    for a in arrays + tuple(u):
        if not a.is_cuda or a.device != x.device:
            raise ValueError('fused_rollout: every tensor must be on the '
                             'same CUDA device')
        if not a.is_contiguous():
            raise ValueError('fused_rollout: tensors must be contiguous')
    for name, a, dtype, shape in (
            ('x', x, torch.float32, (12, b)),
            ('perturb', perturb, torch.float32, (6, b)),
            ('status', arrays[2], torch.int32, (b,)),
            ('ticks', arrays[3], torch.int32, (b,)),
            ('steps', arrays[4], torch.int32, (b,)),
            ('prev_shaping', arrays[5], torch.float32, (b,)),
            ('episode', arrays[6], torch.int32, (b,)),
            ('env_ids', arrays[7], torch.int32, (b,))) + tuple(
                (f'u{i}', t, torch.float32, (b,)) for i, t in enumerate(u)):
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(
                f'fused_rollout: {name} must be {dtype} of shape {shape} on '
                f'the card, got {a.dtype} {tuple(a.shape)}')
    if lanes is None:
        lanes = lanes_for(b, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    if lanes not in LANES_PER_ENV:
        raise ValueError(f'fused_rollout: lanes must be one of '
                         f'{LANES_PER_ENV}, got {lanes}')
    outs = (torch.empty_like(x), torch.empty_like(perturb)) + tuple(
        torch.empty_like(a) for a in arrays[2:7]) + (
        torch.empty_like(arrays[5]), torch.empty_like(arrays[2]))
    fc = (ctypes.c_float * N_FLOAT_CONSTANTS)(*c[:N_FLOAT_CONSTANTS])
    ic = (ctypes.c_int * (len(c) - N_FLOAT_CONSTANTS))(
        *c[N_FLOAT_CONSTANTS:])
    lib = _kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gct_fused_rollout(
            *(a.data_ptr() for a in arrays + tuple(u) + outs),
            b, num_steps, seed, lanes, fc, len(fc), ic, len(ic), stream)
    if err != 0:
        raise RuntimeError(f'fused_rollout kernel launch failed: '
                           f'{_build.error_string(lib, err)}')
    fused_rollout.launches += 1
    return outs


def _prepare(state: EnvState, action, params: EnvParams, spec: TaskSpec,
             env_ids):
    if not supports(params, spec):
        raise ValueError(
            f'task {spec.name!r} (kind={spec.kind}, term={spec.termination}) '
            f'is outside the fused-kernel family; use scan_rollout')
    x = state.dyn.x
    b = x.shape[-1]
    # the CUDA kernel takes any batch; on the CPU the plain version keeps
    # the JAX kernel's contract of whole 128-lane tiles
    if x.device.type == 'cpu' and b % LANES != 0:
        raise ValueError(f'batch {b} must be a multiple of {LANES} on the '
                         f'CPU')
    if env_ids is None:
        env_ids = torch.arange(b, dtype=torch.int32, device=x.device)
    arrays = (x, state.dyn.perturb, state.dyn.status, state.dyn.ticks,
              state.steps, state.prev_shaping, state.episode,
              env_ids.to(torch.int32))
    u = _motor_mix(action, params, spec, x.dtype)
    random_reset = (spec.perturb_on_reset
                    and float(params.task.initial_random_force) != 0.0)
    return arrays, u, step_constants(params, spec, random_reset)


def _finish(state: EnvState, outs):
    x, perturb, status, ticks, steps, pshape, episode, acc, eps = outs
    new_state = EnvState(
        dyn=DynamicsState(x=x, status=status, perturb=perturb, ticks=ticks),
        prev_shaping=pshape, steps=steps, episode=episode,
        initial_random_x=state.initial_random_x)
    return new_state, {'reward_sum': acc, 'episodes': eps}


def fused_rollout(state: EnvState, action, num_steps: int,
                  params: EnvParams, spec: TaskSpec, *, seed: int = 0,
                  env_ids=None):
    """Run `num_steps` auto-resetting env steps with a constant action
    (A, B) as ONE kernel launch on the card, or with the plain version when
    the state lies on the CPU.

    Returns (EnvState, totals) with totals = {'reward_sum': (B,),
    'episodes': (B,) int32 episodes completed}.  Reset kicks are keyed by
    (env_ids, episode, seed): pass the envs' global ids (default arange(B))
    and the same seed everywhere for layout-independent results.
    `initial_random_x` is not re-derived on auto-reset.  On the card the
    state must be float32.  While the recorder of utils/profiling.py is
    on, the call is the span `fused.rollout`, with `fused.prepare` and
    `fused.launch` in it."""
    on = profiling.recording()
    with profiling.span('fused.rollout', on=on):
        with profiling.span('fused.prepare', on=on):
            arrays, u, c = _prepare(state, action, params, spec, env_ids)
        with profiling.span('fused.launch', on=on):
            if arrays[0].device.type == 'cpu':
                outs = _rollout_plain(arrays, u, num_steps, seed, c, spec)
            else:
                outs = _rollout_cuda(arrays, u, num_steps, seed, c)
        return _finish(state, outs)


fused_rollout.launches = 0  # kernel launches, counted where they happen


def fused_rollout_reference(state: EnvState, action, num_steps: int,
                            params: EnvParams, spec: TaskSpec, *,
                            seed: int = 0, env_ids=None):
    """The plain version of `fused_rollout` on any device: the kernel's
    transition written on tensors and looped `num_steps` times."""
    arrays, u, c = _prepare(state, action, params, spec, env_ids)
    return _finish(state, _rollout_plain(arrays, u, num_steps, seed, c,
                                         spec))


def scan_rollout(state: EnvState, action, base_key, env_ids, num_steps: int,
                 params: EnvParams, spec: TaskSpec, *, graphed: bool = False):
    """The step-by-step reference path: `num_steps` calls of
    `envs/base.step`, with the env's threefry reset draws.  Works for every
    task and batch size; the CPU takes it for a batch the plain fused
    version does not cover, and the card never falls back to it.  With
    `graphed` (state on the card) one step is a CUDA graph replayed
    `num_steps` times (core/graph.py), the same operations without the
    host's launches."""
    def one(state, acc, eps):
        state, ts = base.step(state, action, base_key, env_ids, params, spec)
        return state, acc + ts.reward, eps + ts.done.to(torch.int32)

    step = Graph(one, warmup=1) if graphed else one
    carry = (state, torch.zeros_like(state.prev_shaping),
             torch.zeros_like(state.steps))
    for _ in range(num_steps):
        carry = step(*carry)
    state, acc, eps = carry
    if graphed:
        # the graph's static outputs are overwritten by its next replay
        state, acc, eps = tree_map(torch.clone, (state, acc, eps))
    return state, {'reward_sum': acc, 'episodes': eps}
