"""Single-env Gymnasium drop-in wrapper on the port.

Gives users of the reference (`gym.make('gym_copter:Lander-v0')`,
gym_copter/__init__.py:9-13) the same 5-tuple API on the batched torch
engine: `compat/single.py`'s B = 1 env plus the Box observation and action
spaces, `metadata` and Gymnasium's `reset(seed=)`.  The counterpart of
`gym_copter_tpu/compat/gym_adapter.py`.

Registers `GymCopterTorch/<Name>` ids with the Gymnasium registry on
import (apart from the JAX package's `GymCopterTpu/<Name>`), so
`gymnasium.make('GymCopterTorch/Lander-v0')` works, on the card unless
`device='cpu'` is passed.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from gym_copter_tpu_torch.compat.single import (SingleCopterEnv,
                                                SingleVisualEnv)
from gym_copter_tpu_torch.envs import tasks


class GymCopterEnv(SingleCopterEnv, gym.Env):
    """Gymnasium Env facade over one torch-stepped copter env: Box obs
    space (±inf, float32) and Box action space ([-1, 1]^n)
    (task.py:46-55) over `SingleCopterEnv`."""

    metadata = {'render_modes': ['human', 'rgb_array'], 'render_fps': 100}

    def __init__(self, name: str = 'Lander-v0', **kwargs):
        super().__init__(name, **kwargs)
        spec = self._env.spec
        self.observation_space = spaces.Box(
            -np.inf, np.inf, shape=(spec.obs_size,), dtype=np.float32)
        self.action_space = spaces.Box(
            -1.0, 1.0, shape=(spec.action_size,), dtype=np.float32)

    def reset(self, seed=None, options=None, pose=None, perturb=True):
        gym.Env.reset(self, seed=seed)  # seeds gymnasium's np_random
        return super().reset(seed=seed, options=options, pose=pose,
                             perturb=perturb)

    def close(self):
        super().close()
        gym.Env.close(self)


class GymCopterVisualEnv(SingleVisualEnv, GymCopterEnv):
    """Single-env visual variant: `self.image` holds the latest (res, res)
    camera frame (binary) or event frame ({-1,0,+1} when dvs=True)."""


def _register_all():
    for name in tasks.ALL_TASKS:
        gym_id = f'GymCopterTorch/{name}'
        if gym_id not in gym.registry:
            gym.register(
                id=gym_id,
                entry_point='gym_copter_tpu_torch.compat.gym_adapter:'
                            'GymCopterEnv',
                max_episode_steps=1000,  # matches gym_copter/__init__.py:12
                kwargs={'name': name},
            )


_register_all()
