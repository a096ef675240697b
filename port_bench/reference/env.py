"""The plain reference of the copter env: one batched, auto-resetting step
of the Lander and Hover tasks on torch tensors, features-first (…, B).

A frozen copy of the measured package's env step, for the task family the
benchmark's configurations run (kinds 'lander' and 'hover', 'standard'
termination, 'clip01' actions, the Bouabdallah lift law), in the same
operations and operand order, so that on one device it gives the program's
numbers bit for bit.  It imports nothing of the program.  Every
configuration value comes from the benchmark's configuration file
(`params_from_config`).

The dynamics are the reference quad-X's (Bouabdallah 2004) forward Euler
step with its parity traps: the perturbation added twice to each velocity
derivative, the negated theta-ddot line, the touchdown early return, and
the crash test reading Y_DOT and Z_DOT.  Each env's reset wind kick is
U(-F, F)^3 keyed by fold_in(fold_in(base_key, env id), episode).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from port_bench.reference import prng

STATE_X, STATE_X_DOT, STATE_Y, STATE_Y_DOT, STATE_Z, STATE_Z_DOT = range(6)
STATE_PHI, STATE_PHI_DOT, STATE_THETA, STATE_THETA_DOT = range(6, 10)
STATE_PSI, STATE_PSI_DOT = 10, 11
STATUS_CRASHED, STATUS_LANDED, STATUS_LEVELING, STATUS_AIRBORNE = range(4)
LANDING_VEL_X = 2.0
LANDING_VEL_Y = 1.0
LANDING_ANGLE = 0.7853981633974483


class Vehicle(NamedTuple):
    B: float
    D: float
    M: float
    L: float
    Ix: float
    Iy: float
    Iz: float
    Jr: float
    maxrpm: float


class Task(NamedTuple):
    """What one configuration fixes: the task kind, the observed rows of
    the state, the vehicle, gravity, and the task's and reward's
    constants."""

    kind: str
    obs_indices: Tuple[int, ...]
    action_size: int
    vehicle: Vehicle
    g: float
    dt: float
    initial_random_force: float
    out_of_bounds_penalty: float
    max_steps: int
    max_angle: float
    bounds: float
    initial_altitude: float
    target_radius: float
    yaw_penalty_factor: float
    xyz_penalty_factor: float
    dz_max: float
    dz_penalty: float
    inside_radius_bonus: float


def params_from_config(cfg: dict) -> Task:
    """The `env` group of a configuration file as a `Task`."""
    e = cfg['env']
    if e['kind'] not in ('lander', 'hover') or e['action_mode'] != 'clip01' \
            or e['termination'] != 'standard' \
            or e['lift_model'] != 'bouabdallah':
        raise ValueError(f'the reference env covers lander and hover tasks '
                         f'with clip01 actions, standard termination and '
                         f'the bouabdallah lift law, not {e}')
    r = e['reward']
    return Task(kind=e['kind'], obs_indices=tuple(e['obs_indices']),
                action_size=int(e['action_size']),
                vehicle=Vehicle(**e['vehicle']), g=float(e['g']),
                dt=float(e['dt']),
                initial_random_force=float(e['initial_random_force']),
                out_of_bounds_penalty=float(e['out_of_bounds_penalty']),
                max_steps=int(e['max_episode_steps']),
                max_angle=math.radians(float(e['max_angle_deg'])),
                bounds=float(e['bounds']),
                initial_altitude=float(e['initial_altitude']),
                target_radius=float(r['target_radius']),
                yaw_penalty_factor=float(r['yaw_penalty_factor']),
                xyz_penalty_factor=float(r['xyz_penalty_factor']),
                dz_max=float(r['dz_max']), dz_penalty=float(r['dz_penalty']),
                inside_radius_bonus=float(r['inside_radius_bonus']))


def hover_motor_value(t: Task) -> float:
    """The motor value at which 4 B omega^2 = M g."""
    vp = t.vehicle
    omega_hover = math.sqrt(vp.M * t.g / (4.0 * vp.B))
    return omega_hover * 30.0 / (math.pi * vp.maxrpm)


def div(a: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE division by `c` rounded to a's dtype: a 0-dim tensor divisor,
    since CUDA multiplies by the reciprocal of a Python scalar."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


class Dyn(NamedTuple):
    x: torch.Tensor        # (12, B)
    status: torch.Tensor   # (B,) int32
    perturb: torch.Tensor  # (6, B)
    ticks: torch.Tensor    # (B,) int32


class EnvState(NamedTuple):
    dyn: Dyn
    prev_shaping: torch.Tensor
    steps: torch.Tensor
    episode: torch.Tensor
    initial_random_x: torch.Tensor


def tree_where(cond, a, b):
    if isinstance(a, tuple):
        return type(a)(*(tree_where(cond, u, v) for u, v in zip(a, b)))
    return torch.where(cond, a, b)


def motor_mix_terms(motorvals, vp: Vehicle):
    """Eq. 6: (-U1/M, U2/Ix, U3/Iy, U4/Iz) of (4, B) motor values."""
    omegas = div(motorvals * vp.maxrpm * math.pi, 30.0)
    o2 = omegas * omegas
    U1 = vp.B * (o2[0] + o2[1] + o2[2] + o2[3])
    U2 = vp.L * vp.B * ((o2[1] + o2[2]) - (o2[0] + o2[3]))
    U3 = vp.L * vp.B * ((o2[1] + o2[3]) - (o2[0] + o2[2]))
    U4 = vp.D * ((o2[0] + o2[1]) - (o2[2] + o2[3]))
    return div(-U1, vp.M), div(U2, vp.Ix), div(U3, vp.Iy), div(U4, vp.Iz)


def dynamics_step(state: Dyn, motorvals, t: Task) -> Dyn:
    vp = t.vehicle
    x, status, perturb = state.x, state.status, state.perturb
    bz, u2ix, u3iy, u4iz = motor_mix_terms(motorvals, vp)
    phi, theta, psi = x[STATE_PHI], x[STATE_THETA], x[STATE_PSI]
    cph, sph = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    cps, sps = torch.cos(psi), torch.sin(psi)
    rx = sph * sps + cph * cps * sth
    ry = cph * sps * sth - cps * sph
    rz = cph * cth
    ax, ay, az = bz * rx, bz * ry, bz * rz
    netz = az + t.g

    status1 = torch.where((status == STATUS_LANDED) & (netz < 0),
                          STATUS_AIRBORNE, status)
    leveling = status1 == STATUS_LEVELING
    airborne = status1 == STATUS_AIRBORNE
    z, dz = x[STATE_Z], x[STATE_Z_DOT]
    dy = x[STATE_Y_DOT]
    touchdown = airborne & (z > 0) & (dz > 0)
    crash = ((dz > LANDING_VEL_Y) | (torch.abs(dy) > LANDING_VEL_X)
             | (torch.abs(phi) > LANDING_ANGLE))
    integrate = airborne & ~touchdown

    phidot = x[STATE_PHI_DOT]
    thedot = x[STATE_THETA_DOT]
    psidot = x[STATE_PSI_DOT]
    phi_ddot = (div(psidot * thedot * (vp.Iy - vp.Iz), vp.Ix)
                + u2ix + perturb[3])
    theta_ddot = (-(div(psidot * phidot * (vp.Iz - vp.Ix), vp.Iy)
                    + u3iy) + perturb[4])
    dxdt = torch.stack([
        x[STATE_X_DOT],
        (ax + perturb[0]) + perturb[0],
        x[STATE_Y_DOT],
        (ay + perturb[1]) + perturb[1],
        x[STATE_Z_DOT],
        (netz + perturb[2]) + perturb[2],
        phidot,
        phi_ddot + perturb[3],
        thedot,
        theta_ddot + perturb[4],
        psidot,
        (div(thedot * phidot * (vp.Ix - vp.Iy), vp.Iz) + u4iz
         + perturb[5]) + perturb[5],
    ])
    x_integrated = x + t.dt * dxdt
    x_leveled = x.clone()
    x_leveled[STATE_PHI] = 0
    x_leveled[STATE_THETA] = 0
    x_out = torch.where(integrate, x_integrated,
                        torch.where(leveling, x_leveled, x))
    status_out = torch.where(
        leveling, STATUS_LANDED,
        torch.where(touchdown,
                    torch.where(crash, STATUS_CRASHED, STATUS_LEVELING),
                    status1)).to(torch.int32)
    perturb_out = torch.where(touchdown, perturb, torch.zeros_like(perturb))
    ticks_out = state.ticks + (~touchdown).to(torch.int32)
    return Dyn(x=x_out, status=status_out, perturb=perturb_out,
               ticks=ticks_out)


def _shaping(x, t: Task):
    if t.kind == 'lander':
        pos = x[0:6]
        yaw = x[10:12]
        s = -(t.xyz_penalty_factor * torch.sqrt(torch.sum(pos * pos, dim=0))
              + t.yaw_penalty_factor * torch.sqrt(torch.sum(yaw * yaw, dim=0)))
        return s - torch.where(torch.abs(x[STATE_Z_DOT]) > t.dz_max,
                               t.dz_penalty, 0.0).to(x.dtype)
    return x.new_zeros(x.shape[1:])


def _reward(entry_status, x, prev_shaping, t: Task):
    if t.kind == 'hover':
        no_done = torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
        return x.new_ones(x.shape[1:]), x.new_zeros(x.shape[1:]), no_done
    shaping = _shaping(x, t)
    reward = shaping - prev_shaping
    landed = entry_status == STATUS_LANDED
    inside = torch.sqrt(x[STATE_X] * x[STATE_X]
                        + x[STATE_Y] * x[STATE_Y]) < t.target_radius
    reward = reward + torch.where(landed & inside, t.inside_radius_bonus,
                                  0.0).to(x.dtype)
    return reward, shaping, landed


def get_obs(x, t: Task):
    return x[torch.tensor(t.obs_indices, dtype=torch.int64, device=x.device)]


def reset(base_key, env_ids, episode, t: Task, dtype=torch.float32):
    """Fresh episodes (the reference's reset with its trailing zero-action
    step: prev_shaping seeded, the step counter at 1).  The kick is drawn
    in float32 and held in `dtype`.  Returns (EnvState, obs)."""
    device = env_ids.device
    env_ids = env_ids.to(torch.int32)
    episode = episode.to(torch.int32)
    b = env_ids.shape[0]

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=device)

    x = torch.zeros((12, b), dtype=dtype, device=device)
    x[STATE_X] = scalar(0.0)
    x[STATE_Y] = scalar(0.0)
    x[STATE_Z] = scalar(-t.initial_altitude)
    x[STATE_PHI] = scalar(0.0) * (math.pi / 180)
    x[STATE_THETA] = scalar(0.0) * (math.pi / 180)

    f = float(t.initial_random_force)
    keys = prng.fold_in(prng.fold_in(base_key, env_ids), episode)
    forces3 = prng.uniform(keys, 3, -f, f, torch.float32).T.to(dtype)
    forces = torch.cat([forces3, torch.zeros_like(forces3)], dim=0)

    status = torch.where(x[STATE_Z] < 0, STATUS_AIRBORNE,
                         STATUS_LANDED).to(torch.int32)
    ticks = torch.zeros(x.shape[1:], dtype=torch.int32, device=device)
    dyn = Dyn(x=x, status=status, perturb=div(forces.to(dtype), t.vehicle.M),
              ticks=ticks)
    steps = torch.ones((b,), dtype=torch.int32, device=device)
    state = EnvState(dyn=dyn, prev_shaping=_shaping(x, t), steps=steps,
                     episode=episode, initial_random_x=torch.sign(forces[1]))
    return state, get_obs(x, t)


def raw_step(state: EnvState, action, t: Task):
    """One transition without the auto-reset: (state', obs, reward,
    done)."""
    x_dtype = state.dyn.x.dtype
    entry_status = state.dyn.status
    landed = entry_status == STATUS_LANDED
    motors = torch.clamp(action.to(x_dtype), 0.0, 1.0)
    eye = torch.eye(4, dtype=motors.dtype, device=motors.device)
    stepped = dynamics_step(state.dyn, eye @ motors, t)
    dyn = tree_where(landed, state.dyn, stepped)
    x = dyn.x
    reward, shaping, done_r = _reward(entry_status, x, state.prev_shaping, t)
    oob = ((torch.abs(x[STATE_X]) >= t.bounds)
           | (torch.abs(x[STATE_Y]) >= t.bounds))
    tilt = ((torch.abs(x[STATE_PHI]) >= t.max_angle)
            | (torch.abs(x[STATE_THETA]) >= t.max_angle))
    crashed = entry_status == STATUS_CRASHED
    penalty = t.out_of_bounds_penalty
    reward = torch.where(oob, reward - penalty,
                         torch.where(tilt, -penalty, reward))
    done = done_r | oob | tilt | crashed
    done = done | (state.steps == t.max_steps)
    new_state = EnvState(dyn=dyn, prev_shaping=shaping,
                         steps=state.steps + 1, episode=state.episode,
                         initial_random_x=state.initial_random_x)
    return new_state, get_obs(x, t), reward, done


def step(state: EnvState, action, base_key, env_ids, t: Task):
    """The auto-resetting step: (state', obs, reward, done), finished
    slots replaced by fresh episodes."""
    new_state, obs, reward, done = raw_step(state, action, t)
    fresh_state, fresh_obs = reset(base_key, env_ids, state.episode + 1, t,
                                   dtype=state.dyn.x.dtype)
    out_state = tree_where(done, fresh_state, new_state)
    out_obs = torch.where(done, fresh_obs, obs)
    return out_state, out_obs, reward, done
