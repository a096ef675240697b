"""The plain reference of the fused constant-action rollout: T
auto-resetting env steps of a batch under one constant action, the reward
summed and the finished episodes counted per env.

A frozen copy of the measured package's plain version of its CUDA kernel
for the lander and hover tasks (the same transition, operations and
operand order, so that on one card it gives the kernel's bits); it
imports nothing of the program.  The Eq. 6
terms of the constant action are computed once (`motor_mix`); an
auto-reset returns to the start pose with the wind kick (2u - 1) F / M, u
a counter hash of (global env id, episode, salt, axis).

`rollout(..., graphed=True)` replays the one-step transition as a CUDA
graph of plain torch operations: the same kernels, without the host's
launch of each.  `dtype=torch.bfloat16` computes the transition in
bfloat16, the benchmark's control.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from port_bench.reference import env as E

class Consts(NamedTuple):
    """What the transition needs besides the carried state, as Python
    numbers; each float is rounded to the state's dtype where it is
    used."""

    dt: float
    g: float
    Ix: float
    Iy: float
    Iz: float
    iy_iz: float
    iz_ix: float
    ix_iy: float
    xyz_pen: float
    yaw_pen: float
    dz_max: float
    dz_penalty: float
    target_radius: float
    bonus: float
    bounds: float
    max_angle: float
    oob_penalty: float
    kick_scale: float
    z0: float
    s0: float
    status0: int
    max_steps: int
    random_reset: bool


def constants(t: E.Task) -> Consts:
    """The constants of a lander or hover task that auto-resets to the
    start pose (X = Y = 0 at the start altitude, at rest, clock 0)."""
    vp = t.vehicle
    alt = float(t.initial_altitude)
    z = np.float32(-alt)
    s0 = (float(-(np.float32(t.xyz_penalty_factor) * np.sqrt(z * z)
                  + np.float32(t.yaw_penalty_factor) * np.float32(0.0)))
          if t.kind == 'lander' else 0.0)
    return Consts(
        dt=t.dt, g=t.g, Ix=vp.Ix, Iy=vp.Iy, Iz=vp.Iz, iy_iz=vp.Iy - vp.Iz,
        iz_ix=vp.Iz - vp.Ix, ix_iy=vp.Ix - vp.Iy,
        xyz_pen=t.xyz_penalty_factor, yaw_pen=t.yaw_penalty_factor,
        dz_max=t.dz_max, dz_penalty=t.dz_penalty,
        target_radius=t.target_radius, bonus=t.inside_radius_bonus,
        bounds=t.bounds, max_angle=t.max_angle,
        oob_penalty=t.out_of_bounds_penalty,
        # F/M divided host-side: (2u - 1) is exact, leaving one rounding
        kick_scale=float(t.initial_random_force) / float(vp.M),
        z0=0.0 + (-alt), s0=s0,
        status0=E.STATUS_AIRBORNE if alt > 0 else E.STATUS_LANDED,
        max_steps=int(t.max_steps),
        random_reset=float(t.initial_random_force) != 0.0)


def motor_mix(action, t: E.Task, dtype):
    """The constant action's (bz, u2ix, u3iy, u4iz), each (B,)."""
    motors = torch.clamp(action.to(dtype), 0.0, 1.0)
    eye = torch.eye(4, dtype=motors.dtype, device=motors.device)
    return E.motor_mix_terms(eye @ motors, t.vehicle)


# per-axis salts decorrelating the three kick components
_KICK_AXIS = (0x2545F491, 0x63173B93, 0x1B56C4E9)
_M32 = 0xFFFFFFFF


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


def _env_step(carry, u, eid, salt: int, c: Consts, kind: str):
    """One transition, each carried value a (B,) tensor.  Returns (carry',
    reward, done); carry' already holds the fresh episodes of done
    lanes."""
    xs, ps, status, ticks, steps, pshape, ep = carry
    bz, u2ix, u3iy, u4iz = u
    x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11 = xs
    p0, p1, p2, p3, p4, p5 = ps
    zero = torch.zeros_like(x0)
    entry_landed = status == E.STATUS_LANDED

    cph, sph = torch.cos(x6), torch.sin(x6)
    cth, sth = torch.cos(x8), torch.sin(x8)
    cps, sps = torch.cos(x10), torch.sin(x10)
    rx = sph * sps + cph * cps * sth
    ry = cph * sps * sth - cps * sph
    rz = cph * cth
    ax, ay, az = bz * rx, bz * ry, bz * rz
    netz = az + c.g

    status1 = torch.where(entry_landed & (netz < 0), E.STATUS_AIRBORNE,
                          status)
    leveling = status1 == E.STATUS_LEVELING
    airborne = status1 == E.STATUS_AIRBORNE
    touchdown = airborne & (x4 > 0) & (x5 > 0)
    crash = ((x5 > E.LANDING_VEL_Y) | (torch.abs(x3) > E.LANDING_VEL_X)
             | (torch.abs(x6) > E.LANDING_ANGLE))
    integrate = airborne & ~touchdown

    phi_dd = E.div(x11 * x9 * c.iy_iz, c.Ix) + u2ix + p3
    the_dd = -(E.div(x11 * x7 * c.iz_ix, c.Iy) + u3iy) + p4
    psi_dd = E.div(x9 * x7 * c.ix_iy, c.Iz) + u4iz + p5
    # the perturbation double-count of the dynamics
    d = (x1, (ax + p0) + p0, x3, (ay + p1) + p1,
         x5, (netz + p2) + p2, x7, phi_dd + p3,
         x9, the_dd + p4, x11, psi_dd + p5)

    # landed envs skip the dynamics; the selects of the dynamics and of
    # the skip are disjoint
    skip = entry_landed
    eff_integ = integrate & ~skip
    eff_level = leveling & ~skip
    keep_p = skip | touchdown
    ys = [torch.where(eff_integ, xv + c.dt * dv, xv) for xv, dv in zip(xs, d)]
    ys[6] = torch.where(eff_level, zero, ys[6])
    ys[8] = torch.where(eff_level, zero, ys[8])
    ps_n = tuple(torch.where(keep_p, pv, zero) for pv in ps)
    status_n = torch.where(
        skip, status,
        torch.where(leveling, E.STATUS_LANDED,
                    torch.where(touchdown,
                                torch.where(crash, E.STATUS_CRASHED,
                                            E.STATUS_LEVELING),
                                status1))).to(torch.int32)
    ticks_n = ticks + (~keep_p).to(torch.int32)
    y0, y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11 = ys

    if kind == 'lander':
        pos_sq = (y0 * y0 + y1 * y1 + y2 * y2
                  + y3 * y3 + y4 * y4 + y5 * y5)
        yaw_sq = y10 * y10 + y11 * y11
        shaping = -(c.xyz_pen * torch.sqrt(pos_sq)
                    + c.yaw_pen * torch.sqrt(yaw_sq))
        shaping = shaping - torch.where(torch.abs(y5) > c.dz_max,
                                        c.dz_penalty, 0.0).to(x0.dtype)
        reward = shaping - pshape
        inside = torch.sqrt(y0 * y0 + y2 * y2) < c.target_radius
        reward = reward + torch.where(entry_landed & inside, c.bonus,
                                      0.0).to(x0.dtype)
        done = entry_landed
    else:  # hover: +1 per surviving step
        shaping = zero
        reward = torch.ones_like(x0)
        done = torch.zeros_like(entry_landed)

    oob = (torch.abs(y0) >= c.bounds) | (torch.abs(y2) >= c.bounds)
    tilt = (torch.abs(y6) >= c.max_angle) | (torch.abs(y8) >= c.max_angle)
    crashed = status == E.STATUS_CRASHED
    reward = torch.where(oob, reward - c.oob_penalty,
                         torch.where(tilt, -c.oob_penalty, reward))
    done = done | oob | tilt | crashed
    done = done | (steps == c.max_steps)

    # auto-reset to the start pose
    ep1 = ep + 1
    if c.random_reset:
        kick = tuple((2.0 * _kick_u01(eid, ep1, salt, ax_salt, x0.dtype)
                      - 1.0) * c.kick_scale for ax_salt in _KICK_AXIS)
    else:
        kick = (zero, zero, zero)
    reset_x = (0.0, 0.0, 0.0, 0.0, c.z0, 0.0) + (0.0,) * 6
    xs_r = tuple(torch.where(done, rv, nv) for rv, nv in zip(reset_x, ys))
    ps_r = tuple(torch.where(done, rv, nv)
                 for rv, nv in zip(kick + (zero, zero, zero), ps_n))
    status_r = torch.where(done, c.status0, status_n)
    ticks_r = torch.where(done, 0, ticks_n)
    steps_r = torch.where(done, 1, steps + 1)
    pshape_r = torch.where(done, c.s0, shaping)
    ep_r = torch.where(done, ep1, ep)
    return ((xs_r, ps_r, status_r, ticks_r, steps_r, pshape_r, ep_r),
            reward, done)


def _rollout_plain(arrays, u, num_steps, salt, c: Consts, kind):
    x, perturb, status, ticks, steps, pshape, episode, env_ids = arrays
    carry = (tuple(x), tuple(perturb), status, ticks, steps, pshape, episode)
    u = tuple(u)
    acc = torch.zeros_like(pshape)
    eps = torch.zeros_like(status)
    for _ in range(num_steps):
        carry, reward, done = _env_step(carry, u, env_ids, salt, c, kind)
        acc = acc + reward
        eps = eps + done.to(torch.int32)
    xs, ps, status, ticks, steps, pshape, episode = carry
    return (torch.stack(xs), torch.stack(ps), status, ticks, steps, pshape,
            episode, acc, eps)



def rollout(state: E.EnvState, env_ids, action, num_steps: int, salt: int,
            t: E.Task, *, graphed: bool = False, dtype=torch.float32):
    """`num_steps` auto-resetting steps from `state` under the constant
    `action` (A, B): (x, perturb, status, ticks, steps, prev_shaping,
    episode, reward sum, episodes finished)."""
    c = constants(t)
    d = state.dyn
    arrays = (d.x.to(dtype), d.perturb.to(dtype), d.status, d.ticks,
              state.steps, state.prev_shaping.to(dtype), state.episode,
              env_ids.to(torch.int32))
    u = motor_mix(action, t, dtype)
    if not graphed:
        return _rollout_plain(arrays, u, num_steps, salt, c, t.kind)
    x, perturb, status, ticks, steps, pshape, episode, eids = arrays
    carry = [tuple(x.clone()), tuple(perturb.clone()), status.clone(),
             ticks.clone(), steps.clone(), pshape.clone(), episode.clone()]
    acc = torch.zeros_like(pshape)
    eps = torch.zeros_like(status)
    static = (carry, acc, eps)

    def one():
        carry, acc, eps = static
        new, reward, done = _env_step(tuple(carry), u, eids, salt, c,
                                     t.kind)
        return new, acc + reward, eps + done.to(torch.int32)

    def write(out):
        new, acc_n, eps_n = out
        xs, ps, rest = new[0], new[1], new[2:]
        for dst, src in zip(static[0][0] + static[0][1] + tuple(static[0][2:]),
                            xs + ps + tuple(rest)):
            dst.copy_(src)
        static[1].copy_(acc_n)
        static[2].copy_(eps_n)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # warm-up on copies: the static carry must hold the start state
        saved = [[v.clone() for v in carry[0]], [v.clone() for v in carry[1]],
                 [v.clone() for v in carry[2:]], acc.clone(), eps.clone()]
        write(one())
        for dst, src in zip(carry[0] + carry[1] + tuple(carry[2:]),
                            saved[0] + saved[1] + saved[2]):
            dst.copy_(src)
        acc.copy_(saved[3])
        eps.copy_(saved[4])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        write(one())
    for _ in range(num_steps):
        graph.replay()
    xs, ps, status, ticks, steps, pshape, episode = carry
    return (torch.stack(xs), torch.stack(ps), status, ticks, steps, pshape,
            episode, acc, eps)
