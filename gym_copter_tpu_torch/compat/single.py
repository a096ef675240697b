"""One copter env with the reference's single-env API, on torch: the core of
the Gymnasium adapter (compat/gym_adapter.py), which adds the spaces and
the registration and is the only part that imports `gymnasium`.

The counterpart of `gym_copter_tpu/compat/gym_adapter.py`'s
`GymCopterEnv` and `GymCopterVisualEnv` less their Gymnasium parts: a
B = 1 slice of the lockstep step with numpy in and out, `step` returning
(obs, reward, terminated, False, {}) with the TERMINAL observation on a
done step, `set_altitude`, `seed`, `pose`, and two seeding modes:

  * default: perturbations from the env's threefry key (deterministic per
    (seed, episode)); `reset(seed=s)` rekeys it;
  * legacy_seeding=True: the reset wind kick drawn from *global*
    `np.random` exactly like the reference (task.py:71-75, 199-202), so a
    float64 env replays seeded reference trajectories.

On a CUDA device a step replays a one-step CUDA graph (core/graph.py) that
computes the next and the terminal observation together and packs what the
host reads into one tensor; on the CPU it runs eagerly.  Both give the same
numbers bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import base, registry
from gym_copter_tpu_torch.envs.base import EnvState
from gym_copter_tpu_torch.sensors.vision import DVS, VisionSensor
from gym_copter_tpu_torch.utils import profiling


def _state_names(spec):
    full = list(C.STATE_NAMES_12)
    names = [full[i] for i in spec.obs_indices]
    if spec.kind == 'target':
        names += ['TargetX', 'TargetY', 'TargetAlt']
    return names


class SingleCopterEnv:
    """One torch-stepped copter env with the reference `_Task` surface:
    `step` returns (obs, reward, terminated, False, {}) with terminated
    the reference's `done` (truncation folded in, task.py:128-137), plus
    `set_altitude` (task.py:67-69) and `pose` for renderers
    (task.py:102-103).  Observations are float32 numpy arrays.

    `graphed` defaults to True on a CUDA device and must be False on the
    CPU."""

    def __init__(self, name: str = 'Lander-v0',
                 params: Optional[EnvParams] = None,
                 seed: int = 0,
                 legacy_seeding: bool = False,
                 dtype=torch.float32,
                 device=None,
                 graphed: Optional[bool] = None):
        self._name = name
        self._env = registry.make(name, num_envs=1, params=params, seed=seed,
                                  dtype=dtype, device=device)
        self.device = self._env.device
        if graphed is None:
            graphed = self.device.type == 'cuda'
        if graphed and self.device.type != 'cuda':
            raise ValueError('a graphed step needs a CUDA device')
        self._graph = (Graph(self._step, warmup=1, name='single.step')
                       if graphed else None)
        self._legacy_seeding = legacy_seeding
        self._dtype = dtype
        self._state: Optional[EnvState] = None
        self._episode = 0
        self._initial_altitude: Optional[float] = None
        self.viewer = None
        self.pose = None
        self.done = False
        self.spinning = False

        spec = self._env.spec
        self.STATE_NAMES = _state_names(spec)
        self.FRAMES_PER_SECOND = int(round(1.0 / self._env.params.task.dt))

    def set_altitude(self, altitude):
        """Start altitude of later resets: a reset-time pose override, so
        calling it per episode rebuilds nothing."""
        self._initial_altitude = float(altitude)

    def seed(self, seed=None):
        """Reference `_Task.seed` (task.py:71-75): seeds global np.random
        (used by the legacy perturbation path)."""
        np.random.seed(seed)
        return [seed]

    def reset(self, seed=None, options=None, pose=None, perturb=True):
        if seed is not None:
            if self._legacy_seeding:
                np.random.seed(seed)
            else:
                # reset(seed=s) makes the episode reproducible: rekey the
                # perturbation stream in place (a captured step reads the
                # same tensor) and restart the episode index
                self._env.base_key.copy_(prng.PRNGKey(seed, self.device))
                self._episode = 0
        if pose is None and self._initial_altitude is not None:
            pose = (0.0, 0.0, self._initial_altitude, 0.0, 0.0)

        perturb_force = None
        if not perturb or not self._env.spec.perturb_on_reset:
            # tasks without the reset wind kick (AltHold/Takeoff/Distance/
            # Target/Lander3DSimple) must not consume the legacy np.random
            # stream either: their reference resets never draw from it
            perturb_force = np.zeros((6, 1))
        elif self._legacy_seeding:
            f = self._env.params.task.initial_random_force
            perturb_force = np.zeros((6, 1))
            perturb_force[0, 0] = np.random.uniform(-f, f)
            perturb_force[1, 0] = np.random.uniform(-f, f)
            perturb_force[2, 0] = np.random.uniform(-f, f)

        self._state, obs = self._env.reset(
            episode=self._episode, pose=pose, perturb_force=perturb_force)
        self._episode += 1
        self.done = False
        self._update_pose()
        return np.asarray(obs[:, 0].cpu(), np.float32), {}

    def _step(self, state: EnvState, action):
        """One env step and what the host reads of it, packed in one
        (2 * obs + 15,) tensor of the env's dtype: the next obs, the
        terminal obs (re-derived from the finished step's state and entry
        step count, as the batched TimeStep.obs already belongs to the
        auto-reset episode), x, reward, done and spinning."""
        env = self._env
        new_state, ts = base.step(state, action, env.base_key, env.env_ids,
                                  env.params, env.spec)
        term = base._get_obs(ts.x, state.steps, env.params, env.spec)
        packed = torch.cat([ts.obs[:, 0], term[:, 0], ts.x[:, 0],
                            ts.reward, ts.done.to(ts.x.dtype),
                            ts.spinning.to(ts.x.dtype)])
        return new_state, packed

    def step(self, action):
        """While the recorder of utils/profiling.py is on, the step is the
        span `single.step` (with the device time of the env step, by one
        CUDA event pair on the card), and in it `single.action_to_device`,
        `graph.replay` (`single.eager_step` off the card) and
        `single.obs_to_host`."""
        on = profiling.recording()
        timed = on and self.device.type == 'cuda'
        with profiling.span('single.step', on=on) as whole:
            with profiling.span('single.action_to_device', on=on):
                # keep full precision until the env-dtype cast (a float32
                # detour would break the float64 legacy bit-replay)
                action = torch.as_tensor(
                    np.asarray(action, np.float64)[:, None],
                    dtype=self._dtype).to(self.device)
            with profiling.span('graph.replay' if self._graph
                                else 'single.eager_step', on=on):
                start = profiling.event() if timed else None
                step = self._graph or self._step
                self._state, packed = step(self._state, action)
                end = profiling.event() if timed else None
            with profiling.span('single.obs_to_host', on=on):
                packed = packed.cpu().numpy()
            if timed:
                whole.device(start, end)
        n = self._env.spec.obs_size
        obs, term, x = packed[:n], packed[n:2 * n], packed[2 * n:2 * n + 12]
        reward, done, spinning = packed[2 * n + 12:]
        self.done = bool(done)
        self.spinning = bool(spinning)
        # pose reflects the step's own (terminal) state, not the auto-reset
        # state, matching the reference's post-step pose (task.py:102-103)
        self._update_pose(x)
        # Gymnasium semantics: the done step returns the TERMINAL
        # observation (the reference's task.py:133 returns the final
        # state; reset starts the next episode)
        obs = term if self.done else obs
        return np.asarray(obs, np.float32), float(reward), self.done, False, {}

    def _update_pose(self, x=None):
        if x is None:
            x = self._state.dyn.x[:, 0].cpu().numpy()
        self.pose = (x[C.STATE_X], x[C.STATE_Y], x[C.STATE_Z],
                     x[C.STATE_PHI], x[C.STATE_THETA], x[C.STATE_PSI])

    def render(self):
        return None if self.viewer is None else self.viewer.render()

    def close(self):
        if self.viewer is not None:
            self.viewer.close()


class SingleVisualEnv(SingleCopterEnv):
    """Single-env visual variant, after the reference's LanderVisual /
    HoverVisual / LanderDVS / HoverDVS wrappers (attic/gym_copter/envs/
    lander.py:101-138, hover3d.py:52-89): `self.image` holds the latest
    (res, res) camera frame (binary) or event frame ({-1,0,+1} when
    dvs=True), rendered on the env's device from the post-step pose."""

    RES = 16

    def __init__(self, name='Lander-v0', dvs=False, res=None, **kwargs):
        super().__init__(name, **kwargs)
        res = res or self.RES
        self._sensor = (DVS if dvs else VisionSensor)(res=res,
                                                      device=self.device)
        self._dvs = dvs
        self._prev = None
        self.image = None

    def reset(self, **kwargs):
        self._prev = None
        self.image = None
        return super().reset(**kwargs)

    def step(self, action):
        result = super().step(action)
        x, y, z, phi, theta, psi = self.pose
        curr = self._sensor.get_image(
            x, y, max(-z, 1e-6), np.degrees(phi), np.degrees(theta),
            np.degrees(psi)).cpu().numpy()
        if self._dvs:
            self.image = (np.zeros_like(curr) if self._prev is None
                          else np.sign(self._prev - curr))
            self._prev = curr
        else:
            self.image = curr
        return result
