"""Float64 numpy oracle of the reference environment semantics.

This module is the *correctness fixture* for the JAX engine: a deliberately
boring, branchy, scalar reimplementation of the reference's update equations
(gym_copter/dynamics/__init__.py and gym_copter/envs/task.py) in float64
numpy, including every behavioral quirk catalogued in SURVEY.md §2.4.  The
golden tests run this oracle side by side with the branchless JAX step and
assert trajectory equality; a separate (optional) test validates the oracle
itself against the actual reference package when it is available on disk.

It also provides the legacy-seeding path: the reference draws its reset
perturbation from *global* `np.random` (gym_copter/envs/task.py:71-75,
199-202), so replaying a reference trajectory bit-exactly requires the same
`np.random.uniform` byte stream.  `OracleEnv.reset(seed=...)` reproduces it.
"""

from __future__ import annotations

import math

import numpy as np

from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core.types import EnvParams


class OracleDynamics:
    """Scalar float64 twin of the reference `Dynamics` class."""

    def __init__(self, params: EnvParams):
        self.p = params
        self.x = np.zeros(12)
        self.dxdt = np.zeros(12)
        self.status = C.STATUS_LANDED
        self.pending = np.zeros(6)  # perturbation as acceleration
        self.ticks = 0

    # -- reference Dynamics.setState (:210-217)
    def set_state(self, state):
        self.x = np.array(state, dtype=np.float64)
        self.status = (C.STATUS_AIRBORNE if self.x[C.STATE_Z] < 0
                       else C.STATUS_LANDED)

    # -- reference Dynamics.perturb (:227-229)
    def apply_force(self, force):
        self.pending = np.asarray(force, dtype=np.float64) / self.p.vehicle.M

    # -- reference Dynamics.setMotors (:114-197)
    def step(self, motorvals):
        vp = self.p.vehicle
        g = self.p.world.g
        dt = self.p.task.dt

        omegas = np.asarray(motorvals, dtype=np.float64) * vp.maxrpm * math.pi / 30.0
        o2 = omegas ** 2
        if self.p.lift_model == 'blade_element':
            # attic mars variant (attic/mars/dynamics/__init__.py:135-164)
            velocity = omegas * (vp.L / 2.0)
            s_area = 0.05 * vp.L * 4.0
            lift = 0.5 * self.p.world.rho * s_area * vp.C_L * velocity ** 2
            u1 = np.sum(lift)
            u2 = (lift[1] + lift[2]) - (lift[0] + lift[3])
            u3 = (lift[1] + lift[3]) - (lift[0] + lift[2])
            u4 = vp.D * ((o2[0] + o2[1]) - (o2[2] + o2[3]))
            omega_dist = (omegas[0] + omegas[1]) - (omegas[2] + omegas[3])
        else:
            u1 = vp.B * np.sum(o2)
            u2 = vp.L * vp.B * ((o2[1] + o2[2]) - (o2[0] + o2[3]))
            u3 = vp.L * vp.B * ((o2[1] + o2[3]) - (o2[0] + o2[2]))
            u4 = vp.D * ((o2[0] + o2[1]) - (o2[2] + o2[3]))
            omega_dist = 0.0

        phi, theta, psi = self.x[6], self.x[8], self.x[10]
        sph, cph = math.sin(phi), math.cos(phi)
        sth, cth = math.sin(theta), math.cos(theta)
        sps, cps = math.sin(psi), math.cos(psi)
        bz = -u1 / vp.M
        accel = np.array([
            bz * (sph * sps + cph * cps * sth),
            bz * (cph * sps * sth - cps * sph),
            bz * (cph * cth),
        ])
        netz = accel[2] + g

        if self.status == C.STATUS_LANDED and netz < 0:
            self.status = C.STATUS_AIRBORNE

        if self.status == C.STATUS_LEVELING:
            self.x[C.STATE_PHI] = 0.0
            self.x[C.STATE_THETA] = 0.0
            self.status = C.STATUS_LANDED

        elif self.status == C.STATUS_AIRBORNE:

            if self.x[C.STATE_Z] > 0 and self.x[C.STATE_Z_DOT] > 0:
                # touchdown: classify, then early-return (no integration, no
                # perturbation clear, no clock tick) — reference :162-177
                if (self.x[C.STATE_Z_DOT] > C.LANDING_VEL_Y
                        or abs(self.x[C.STATE_Y_DOT]) > C.LANDING_VEL_X
                        or abs(self.x[C.STATE_PHI]) > C.LANDING_ANGLE):
                    self.status = C.STATUS_CRASHED
                else:
                    self.status = C.STATUS_LEVELING
                return

            # Eq. 12 derivative (reference :249-290), perturbation added once
            # here and once more below (the double-count quirk, :183)
            p = self.pending
            phidot, thedot, psidot = self.x[7], self.x[9], self.x[11]
            self.dxdt = np.array([
                self.x[1],
                accel[0] + p[0],
                self.x[3],
                accel[1] + p[1],
                self.x[5],
                netz + p[2],
                phidot,
                psidot * thedot * (vp.Iy - vp.Iz) / vp.Ix
                - vp.Jr / vp.Ix * thedot * omega_dist + u2 / vp.Ix + p[3],
                thedot,
                -(psidot * phidot * (vp.Iz - vp.Ix) / vp.Iy
                  + vp.Jr / vp.Iy * phidot * omega_dist + u3 / vp.Iy) + p[4],
                psidot,
                thedot * phidot * (vp.Ix - vp.Iy) / vp.Iz + u4 / vp.Iz + p[5],
            ])
            self.dxdt[1::2] += self.pending
            self.x = self.x + dt * self.dxdt

        self.pending = np.zeros(6)
        self.ticks += 1


class OracleEnv:
    """Scalar float64 twin of the reference task layer (`_Task.step/_reset`,
    gym_copter/envs/task.py:77-197) parameterized by a task spec.

    task_kind: 'lander' (shaped reward + landing bonus,
    gym_copter/envs/lander.py:46-74) or 'hover' (+1 per step,
    attic/gym_copter/envs/hover.py:18-21).
    obs_indices / motor_map define the 1D/2D/3D variants (SURVEY.md §2.4).
    """

    def __init__(self, params: EnvParams, task_kind='lander',
                 obs_indices=tuple(range(10)), action_size=4,
                 motor_map=None):
        self.p = params
        self.task_kind = task_kind
        self.obs_indices = list(obs_indices)
        self.action_size = action_size
        self.motor_map = motor_map or (lambda m: m)
        self.dyn = None

    def reset(self, seed=None, pose=None, perturb_force=None):
        """Reference `_Task._reset` (:145-197).  If `perturb_force` is given
        it overrides the random draw (for cross-checking against the JAX
        engine with explicitly injected forces)."""
        t = self.p.task
        if seed is not None:
            np.random.seed(seed)
        if pose is None:
            pose = (0.0, 0.0, t.initial_altitude, 0.0, 0.0)

        self.prev_shaping = None
        self.done = False
        self.dyn = OracleDynamics(self.p)

        state = np.zeros(12)
        state[C.STATE_X] = pose[0]
        state[C.STATE_Y] = pose[1]
        state[C.STATE_Z] = -pose[2]  # NED
        state[C.STATE_PHI] = math.radians(pose[3])
        state[C.STATE_THETA] = math.radians(pose[4])
        self.dyn.set_state(state)

        if perturb_force is None:
            f = t.initial_random_force
            perturb_force = np.array([np.random.uniform(-f, f),
                                      np.random.uniform(-f, f),
                                      np.random.uniform(-f, f),
                                      0.0, 0.0, 0.0])
        else:
            perturb_force = np.asarray(perturb_force, dtype=np.float64)
        self.dyn.apply_force(perturb_force)
        self.initial_random_x = np.sign(perturb_force[1])

        self.steps = 0
        obs, _, _, _, _ = self.step(np.zeros(self.action_size),
                                    initializing=True)
        return obs, {}

    def _reward(self, entry_status, x):
        """Task reward with shaping state (lander: lander.py:46-74)."""
        if self.task_kind == 'hover':
            return 1.0
        rp = self.p.reward
        shaping = -(rp.xyz_penalty_factor * math.sqrt(np.sum(x[0:6] ** 2))
                    + rp.yaw_penalty_factor * math.sqrt(np.sum(x[10:12] ** 2)))
        if abs(x[C.STATE_Z_DOT]) > rp.dz_max:
            shaping -= rp.dz_penalty
        reward = (shaping - self.prev_shaping
                  if self.prev_shaping is not None else 0.0)
        self.prev_shaping = shaping
        if entry_status == C.STATUS_LANDED:
            self.done = True
            if math.sqrt(x[C.STATE_X] ** 2 + x[C.STATE_Y] ** 2) < rp.target_radius:
                reward += rp.inside_radius_bonus
        return reward

    def step(self, action, initializing=False):
        """Reference `_Task.step` (:77-137), including: action clipped to
        [0,1] despite the declared [-1,1] action space (:91); stale status
        read before the dynamics update (:81); out-of-bounds *subtracts*
        the penalty while excess tilt *replaces* the reward (:111-118);
        the truncated flag always False (:133-137)."""
        t = self.p.task
        d = self.dyn
        entry_status = d.status

        if entry_status != C.STATUS_LANDED:
            motors = np.clip(action, 0, 1)
            self.spinning = np.sum(motors) > 0
            if not initializing:
                d.step(self.motor_map(motors))
        else:
            self.spinning = False

        x = d.x
        self.done = False
        reward = self._reward(entry_status, x)

        if abs(x[C.STATE_X]) >= t.bounds or abs(x[C.STATE_Y]) >= t.bounds:
            self.done = True
            reward -= t.out_of_bounds_penalty
        elif (abs(x[C.STATE_PHI]) >= t.max_angle
              or abs(x[C.STATE_THETA]) >= t.max_angle):
            self.done = True
            reward = -t.out_of_bounds_penalty
        elif entry_status == C.STATUS_CRASHED:
            self.done = True
            self.spinning = False

        if self.steps == t.max_steps:
            self.done = True
        self.steps += 1

        obs = np.array([x[i] for i in self.obs_indices], dtype=np.float64)
        return obs, reward, self.done, False, {}
