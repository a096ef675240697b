"""Batched, functional environment layer on torch tensors.

The counterpart of `gym_copter_tpu/envs/base.py` (the reference task layer,
gym_copter/envs/task.py:77-197): the whole state of B environments is a
NamedTuple of features-first (…, B) tensors, and episode boundaries are a
masked auto-reset inside the step.  Each env's reset randomness is keyed by
`fold_in(fold_in(base_key, global_env_id), episode)` with the port's
threefry (core/prng.py), so the kicks are the JAX package's bits and do
not depend on batch size or layout.

`step` on CPU tensors is the plain version, `step_reference`; on the card
it is one launch of ops/csrc/env_step.cu (`step_kernel`), bit for bit equal
to the plain version there: one graph node where the plain version has
~770.
"""

from __future__ import annotations

import ctypes
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
    regions: the transition, the reset draw and the select.  The plain
    version (`step_reference`) on CPU tensors, one launch of the kernel on
    CUDA tensors (`step_kernel`)."""
    if state.dyn.x.is_cuda:
        return step_kernel(state, action, base_key, env_ids, params, spec)
    return step_reference(state, action, base_key, env_ids, params, spec)


def step_reference(state: EnvState, action, base_key, env_ids,
                   params: EnvParams,
                   spec: TaskSpec) -> Tuple[EnvState, TimeStep]:
    """`step` as torch operations: `_raw_step`, a `reset` of every env,
    and the select."""
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


# The kernel's instantiations (ops/csrc/env_step.cu), in its order: element
# types, task kinds and terminations.  The lift model is a run-time flag.
KERNEL_DTYPES = (torch.float32, torch.float64)
KERNEL_KINDS = ('lander', 'lander_simple', 'hover', 'althold', 'takeoff',
                'distance', 'target')
KERNEL_TERMINATIONS = ('standard', 'simple', 'crash_only', 'none')
KERNEL_LIFT_MODELS = ('bouabdallah', 'blade_element')
_OBS_FIELDS = tuple(f'obs{k}' for k in range(C.STATE_SIZE))


class KernelConstants(NamedTuple):
    """What the kernel's step needs besides the tensors, as Python numbers;
    the kernel rounds each float to the element type where it uses it, as
    torch rounds a Python scalar.  It receives the floats (as doubles) and
    the ints as two arrays in field order (`csrc/env_step.cu`, struct
    Consts)."""

    maxrpm: float
    half_l: float
    lift_k: float
    thrust_b: float
    lb: float
    drag_d: float
    mass: float
    ix: float
    iy: float
    iz: float
    iy_iz: float
    iz_ix: float
    ix_iy: float
    jr_ix: float
    jr_iy: float
    g: float
    dt: float
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
    althold_target: float
    althold_tol: float
    takeoff_target: float
    bounds: float
    max_angle: float
    oob_penalty: float
    force: float
    pose_x: float
    pose_y: float
    pose_z: float
    pose_phi: float
    pose_theta: float
    dtheta: float
    orbit_radius: float
    target_alt: float
    # ints from here on
    max_steps: int
    blade: int
    skip_when_landed: int
    perturb_on_reset: int
    integrate_on_reset: int
    negate_obs: int
    n_obs: int
    obs0: int
    obs1: int
    obs2: int
    obs3: int
    obs4: int
    obs5: int
    obs6: int
    obs7: int
    obs8: int
    obs9: int
    obs10: int
    obs11: int


N_KERNEL_FLOATS = KernelConstants._fields.index('max_steps')


def _f32(v: float) -> float:
    """v rounded to float32, as a torch.where of two Python scalars (a
    float32 tensor) rounds it before `.to(x.dtype)`."""
    return float(torch.tensor(v, dtype=torch.float32))


def kernel_constants(params: EnvParams, spec: TaskSpec) -> KernelConstants:
    """The constants of `step` for the task, combined in double precision
    as the plain version's Python expressions combine them; the reset's
    pose is the task's default one (`reset` with pose None)."""
    vp, w, t, rp = params.vehicle, params.world, params.task, params.reward
    altitude = (spec.start_altitude if spec.start_altitude is not None
                else t.initial_altitude)
    s_area = 0.05 * vp.L * 4.0
    rows = tuple(spec.obs_indices)
    if len(rows) > C.STATE_SIZE or any(not 0 <= r < C.STATE_SIZE
                                       for r in rows):
        raise ValueError(f'env_step kernel: observation rows {rows} outside '
                         f'the {C.STATE_SIZE} state rows')
    floats = dict(
        maxrpm=vp.maxrpm, half_l=vp.L / 2.0,
        lift_k=0.5 * w.rho * s_area * vp.C_L, thrust_b=vp.B, lb=vp.L * vp.B,
        drag_d=vp.D, mass=vp.M, ix=vp.Ix, iy=vp.Iy, iz=vp.Iz,
        iy_iz=vp.Iy - vp.Iz, iz_ix=vp.Iz - vp.Ix, ix_iy=vp.Ix - vp.Iy,
        jr_ix=vp.Jr / vp.Ix, jr_iy=vp.Jr / vp.Iy, g=w.g, dt=t.dt,
        landing_vel_x=C.LANDING_VEL_X, landing_vel_y=C.LANDING_VEL_Y,
        landing_angle=C.LANDING_ANGLE, xyz_pen=rp.xyz_penalty_factor,
        yaw_pen=rp.yaw_penalty_factor, pr_pen=rp.pitch_roll_penalty_factor,
        dz_max=rp.dz_max, dz_penalty=_f32(rp.dz_penalty),
        target_radius=rp.target_radius,
        target_radius_sq=rp.target_radius ** 2,
        bonus=_f32(rp.inside_radius_bonus), althold_target=t.althold_target,
        althold_tol=t.althold_tolerance, takeoff_target=t.takeoff_target,
        bounds=t.bounds, max_angle=t.max_angle,
        oob_penalty=t.out_of_bounds_penalty, force=t.initial_random_force,
        pose_x=spec.start_xy_offset, pose_y=spec.start_xy_offset,
        pose_z=-altitude, pose_phi=0.0, pose_theta=0.0,
        dtheta=t.target_dtheta, orbit_radius=t.target_orbit_radius,
        target_alt=t.target_altitude)
    ints = dict(
        max_steps=t.max_steps,
        blade=params.lift_model == 'blade_element',
        skip_when_landed=spec.skip_when_landed,
        perturb_on_reset=spec.perturb_on_reset,
        integrate_on_reset=spec.integrate_on_reset,
        negate_obs=spec.negate_obs, n_obs=len(rows),
        **dict(zip(_OBS_FIELDS, rows + (0,) * (C.STATE_SIZE - len(rows)))))
    return KernelConstants(**{k: float(v) for k, v in floats.items()},
                           **{k: int(v) for k, v in ints.items()})


def kernel_instantiation(params: EnvParams, spec: TaskSpec, dtype) -> int:
    """The index of the kernel's instantiation for the task and element
    type: (type, kind, termination) in `KERNEL_DTYPES`, `KERNEL_KINDS`,
    `KERNEL_TERMINATIONS` order.  Raises where there is none."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f'env_step kernel: the state must be float32 or '
                         f'float64, got {dtype}')
    if spec.kind not in KERNEL_KINDS or \
            spec.termination not in KERNEL_TERMINATIONS:
        raise ValueError(f'env_step kernel: no instantiation for task '
                         f'{spec.name!r} (kind={spec.kind}, '
                         f'termination={spec.termination})')
    if params.lift_model not in KERNEL_LIFT_MODELS:
        raise ValueError(f'env_step kernel: unknown lift model '
                         f'{params.lift_model!r}')
    return ((KERNEL_DTYPES.index(dtype) * len(KERNEL_KINDS)
             + KERNEL_KINDS.index(spec.kind)) * len(KERNEL_TERMINATIONS)
            + KERNEL_TERMINATIONS.index(spec.termination))


@functools.lru_cache(maxsize=None)
def _kernel_constants(params: EnvParams, spec: TaskSpec):
    """`kernel_constants` as the two ctypes arrays of the launch."""
    c = kernel_constants(params, spec)
    return ((ctypes.c_double * N_KERNEL_FLOATS)(*c[:N_KERNEL_FLOATS]),
            (ctypes.c_int * (len(c) - N_KERNEL_FLOATS))(
                *c[N_KERNEL_FLOATS:]))


def _kernel_library():
    """The built `ops/csrc/env_step.cu`, with its C signature declared."""
    from gym_copter_tpu_torch.ops import _build

    lib = _build.load('env_step')
    fn = lib.gct_env_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_longlong, ctypes.POINTER(ctypes.c_double),
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(what: str, t: torch.Tensor, dtype, device, shape):
    if not isinstance(t, torch.Tensor) or t.device != device:
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f'env_step kernel: {what} is on {where}, not on '
                         f'{device} with the state')
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f'env_step kernel: {what} must be {dtype} of shape '
                         f'{shape}, got {t.dtype} {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'env_step kernel: {what} must be contiguous')


def step_kernel(state: EnvState, action, base_key, env_ids,
                params: EnvParams,
                spec: TaskSpec) -> Tuple[EnvState, TimeStep]:
    """`step` on the card: the action -> motors map, their sum and the
    (4, A) mix as torch ops, then one launch of ops/csrc/env_step.cu on the
    current stream for the transition, the reset of the envs that finish,
    the select and the observation, into new tensors.  The state's tensors,
    the base key (int64 (2,)) and the env ids (int32 (B,)) must be
    contiguous and on the state's card, the state float32 or float64; the
    action a tensor on that card that broadcasts to (A, B).  The kernel reads
    the key and the ids from device memory at each launch, so a captured
    graph draws with the key as it is at its replay.  The nodes before the
    launch and the launch fall in the region `env.transition`; the reset
    draw and the select are inside the launch, so their regions hold
    none."""
    x = state.dyn.x
    device, dtype = x.device, x.dtype
    index = kernel_instantiation(params, spec, dtype)
    if not x.is_cuda or x.dim() != 2:
        raise ValueError(f'env_step kernel: the state must be (12, B) on '
                         f'the card, got {tuple(x.shape)} on {device}')
    b = x.shape[1]
    env_ids = env_ids.to(torch.int32)
    for what, t, dt, shape in (
            ('x', x, dtype, (C.STATE_SIZE, b)),
            ('perturb', state.dyn.perturb, dtype, (6, b)),
            ('status', state.dyn.status, torch.int32, (b,)),
            ('ticks', state.dyn.ticks, torch.int32, (b,)),
            ('steps', state.steps, torch.int32, (b,)),
            ('prev_shaping', state.prev_shaping, dtype, (b,)),
            ('episode', state.episode, torch.int32, (b,)),
            ('initial_random_x', state.initial_random_x, dtype, (b,)),
            ('base_key', base_key, torch.int64, (2,)),
            ('env_ids', env_ids, torch.int32, (b,))):
        _check(what, t, dt, device, shape)
    if not isinstance(action, torch.Tensor) or action.device != device:
        raise ValueError(f'env_step kernel: the action must be a tensor on '
                         f'{device} with the state')

    profiling.region('env.transition')
    motors = motors_from_action(action.to(dtype), spec)
    # an action of one column for B envs broadcasts as in the plain step
    motor_sum = torch.broadcast_to(torch.sum(motors, dim=0),
                                   (b,)).contiguous()
    mixed = torch.broadcast_to(mix_motors(motors, spec), (4, b)).contiguous()
    x_out, ts_x = torch.empty_like(x), torch.empty_like(x)
    status, ts_status = (torch.empty_like(state.dyn.status),
                         torch.empty_like(state.dyn.status))
    outs = (x_out, torch.empty_like(state.dyn.perturb), status,
            torch.empty_like(state.dyn.ticks), torch.empty_like(state.steps),
            torch.empty_like(state.prev_shaping),
            torch.empty_like(state.episode),
            torch.empty_like(state.initial_random_x),
            torch.empty((spec.obs_size, b), dtype=dtype, device=device),
            torch.empty((b,), dtype=dtype, device=device),
            torch.empty((b,), dtype=torch.bool, device=device), ts_status,
            torch.empty((b,), dtype=torch.bool, device=device), ts_x)
    tensors = (x, state.dyn.perturb, state.dyn.status, state.dyn.ticks,
               state.steps, state.prev_shaping, state.episode,
               state.initial_random_x, mixed, motor_sum, base_key,
               env_ids) + outs
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    fc, ic = _kernel_constants(params, spec)
    lib = _kernel_library()
    n_kinds, n_terms = len(KERNEL_KINDS), len(KERNEL_TERMINATIONS)
    with torch.cuda.device(device):
        err = lib.gct_env_step(
            index // (n_kinds * n_terms), index // n_terms % n_kinds,
            index % n_terms, ptrs, len(tensors), b, fc, len(fc), ic, len(ic),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        from gym_copter_tpu_torch.ops import _build
        raise RuntimeError(f'env_step kernel launch failed: '
                           f'{_build.error_string(lib, err)}')
    step_kernel.launches += 1
    profiling.region('env.reset_draw')
    profiling.region('env.select')
    profiling.region(None)
    (x_out, perturb, status, ticks, steps, shaping, episode, irx, obs,
     reward, done, ts_status, spinning, ts_x) = outs
    out_state = EnvState(
        dyn=DynamicsState(x=x_out, status=status, perturb=perturb,
                          ticks=ticks),
        prev_shaping=shaping, steps=steps, episode=episode,
        initial_random_x=irx)
    return out_state, TimeStep(obs=obs, reward=reward, done=done,
                               status=ts_status, spinning=spinning, x=ts_x)


step_kernel.launches = 0
