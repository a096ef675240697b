"""Batched adaptive disturbance rejection (PES-style learning) on torch:
the counterpart of `gym_copter_tpu/learn/adaptive.py` (the reference's
Nengo adaptive hover experiment, attic/nengo/adaptive.py).

A PD altitude controller plus an online-learned term w . phi(z) over
Gaussian RBF features of the altitude, with the PES rule dw = lr * u_pd *
phi: B Hover1D plants, each with its own sustained vertical wind force and
its own weights, step in lockstep.  On the card one step is a CUDA graph
replayed num_steps times, its (z, u_pd, u_extra) copied into preallocated
(T, B) histories on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gym_copter_tpu_torch.core import dynamics, prng
from gym_copter_tpu_torch.core.device import div, linspace, resolve_device
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import base, tasks


class AdaptiveConfig(NamedTuple):
    target: float = 5.0          # altitude setpoint (m)
    k_p: float = 5e-3            # PD gains in motor units / m, / (m/s)
    k_d: float = 8e-3
    learning_rate: float = 1e-3  # PES rate
    n_features: int = 16         # RBF centres over altitude
    feature_lo: float = 0.0
    feature_hi: float = 10.0
    feature_width: float = 1.0


def rbf_features(z, cfg: AdaptiveConfig):
    """(B,) altitude -> (n, B) Gaussian RBF activations."""
    centers = linspace(cfg.feature_lo, cfg.feature_hi, cfg.n_features,
                       z.dtype, z.device)
    d = div(z[None, :] - centers[:, None], cfg.feature_width)
    return torch.exp(-d * d)


def run(env_params: EnvParams, wind_forces, num_steps: int,
        cfg: AdaptiveConfig = AdaptiveConfig(), adapt: bool = True,
        start_altitude: Optional[float] = None, record_every: int = 1,
        device=None, graphed: Optional[bool] = None):
    """Run B = len(wind_forces) adaptive-hover plants for `num_steps` on
    the card (device='cpu' for the CPU).  wind_forces: (B,) sustained
    vertical force in newtons, applied before every step through the
    dynamics' perturbation input.

    Returns a dict of (T, B) histories z (altitude), u_pd and u_extra, and
    the final (n, B) weights.  Graphed (the default on the card), one step
    is a CUDA graph replayed num_steps times; `graphed=False` runs the same
    steps eagerly."""
    device = resolve_device(device)
    wind = torch.as_tensor(wind_forces, dtype=torch.float32, device=device)
    b = wind.shape[0]
    spec = tasks.HOVER_1D
    key = prng.PRNGKey(0, device)
    env_ids = torch.arange(b, dtype=torch.int32, device=device)
    alt0 = cfg.target if start_altitude is None else start_altitude
    state, obs = base.reset(key, env_ids,
                            torch.zeros(b, dtype=torch.int32, device=device),
                            env_params, spec, pose=(0.0, 0.0, alt0, 0.0, 0.0),
                            perturb_force=torch.zeros((6, b), device=device))
    # the sustained wind: a (6, B) force with only the Z slot set, queued
    # again before every step (the env consumes a perturbation once)
    wind6 = torch.zeros((6, b), dtype=torch.float32, device=device)
    wind6[2] = wind
    w0 = torch.zeros((cfg.n_features, b), dtype=torch.float32, device=device)

    def step(state, obs, w):
        z, dz = -obs[0], -obs[1]            # NED -> ENU
        u_pd = cfg.k_p * (cfg.target - z) + cfg.k_d * (0.0 - dz)
        phi = rbf_features(z, cfg)
        u_extra = torch.sum(w * phi, dim=0) if adapt else torch.zeros_like(z)
        u = torch.clamp(u_pd + u_extra, 0.0, 1.0)
        # PES: dw = lr * u_pd * phi grows the adaptive term until it
        # absorbs the steady-state load
        if adapt:
            w = w + cfg.learning_rate * u_pd[None, :] * phi
        state = state._replace(dyn=dynamics.perturb(state.dyn, wind6,
                                                    env_params.vehicle))
        state, ts = base.step(state, u[None, :], key, env_ids, env_params,
                              spec)
        return state, ts.obs, w, torch.stack([z, u_pd, u_extra])

    hist = torch.empty((num_steps, 3, b), dtype=torch.float32, device=device)
    carry = (state, obs, w0)
    if graphed is None:
        graphed = device.type == 'cuda'
    graph = Graph(step, warmup=1) if graphed else step
    for t in range(num_steps):
        *carry, hist[t] = graph(*carry)
    hist = hist[::record_every]
    return {'z': hist[:, 0], 'u_pd': hist[:, 1], 'u_extra': hist[:, 2],
            'weights': carry[2].clone()}


def tracking_error(history, cfg: AdaptiveConfig, window: int = 500):
    """Mean |altitude - target| over the last `window` recorded steps, per
    plant: the experiment's success metric."""
    z = history['z'][-window:]
    return torch.mean(torch.abs(z - cfg.target), dim=0)
