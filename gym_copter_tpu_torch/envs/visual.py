"""Vision / DVS environment wrappers: the counterpart of
`gym_copter_tpu/envs/visual.py`, after the reference's visual variants
(`LanderVisual` / `LanderDVS`, attic/gym_copter/envs/lander.py:101-138;
`HoverVisual` / `HoverDVS`, attic/gym_copter/envs/hover3d.py:52-89): each
step also returns a downward-camera image (binary, res 16 by default) or
an event image in {-1, 0, +1}.  Batched and functional: images are
(B, res, res), and the DVS previous frame and first-call flag are tensors
on the env's device, so one visual step can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gym_copter_tpu_torch.envs.base import EnvState
from gym_copter_tpu_torch.envs.registry import CopterEnv
from gym_copter_tpu_torch.sensors.vision import DVS, VisionSensor

RES = 16  # reference wrapper resolution (attic lander.py:103)


class VisualState(NamedTuple):
    env_state: EnvState
    prev: torch.Tensor   # (B, res, res) previous frame (DVS)
    first: torch.Tensor  # 0-dim bool: the reference returns a zero event
                         # image on the first call (dvs.py:37-44)


class VisualCopterEnv:
    """Wraps a CopterEnv; step returns (state, ts, image_batch)."""

    def __init__(self, env: CopterEnv, dvs: bool = False,
                 sensor: Optional[VisionSensor] = None):
        self.env = env
        self.dvs = dvs
        self.sensor = sensor or (DVS if dvs else VisionSensor)(
            res=RES, device=env.device)

    def reset(self, **kwargs):
        env_state, obs = self.env.reset(**kwargs)
        res = self.sensor.res
        prev = torch.zeros((self.env.num_envs, res, res), dtype=torch.float32,
                           device=self.env.device)
        state = VisualState(env_state=env_state, prev=prev,
                            first=torch.ones((), dtype=torch.bool,
                                             device=self.env.device))
        return state, obs

    def step(self, state: VisualState, action):
        env_state, ts = self.env.step(state.env_state, action)
        curr = self.sensor.get_images(self.sensor.pose_from_state(ts.x))
        if self.dvs:
            image = torch.where(state.first, torch.zeros_like(curr),
                                torch.sign(state.prev - curr))
        else:
            image = curr
        new_state = VisualState(env_state=env_state, prev=curr,
                                first=torch.zeros_like(state.first))
        return new_state, ts, image
