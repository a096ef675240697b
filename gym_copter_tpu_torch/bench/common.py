"""What the measurement entry points share: the card's record, the
Lander3D batch of the headline, the exploration rollout of the PPO
benches, and the JSON writer."""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import torch

from gym_copter_tpu_torch.control.heuristics import MOTORVAL, \
    hover_motor_value
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.envs import base, tasks
from gym_copter_tpu_torch.envs.registry import default_params
from gym_copter_tpu_torch.learn import ppo
from gym_copter_tpu_torch.utils import profiling

DOCS = Path(__file__).resolve().parents[2] / 'docs'
# least and most seconds of the warm-up of a graphed item (`warm_up`)
WARMUP = (10.0, 120.0)


def card_record(device: torch.device) -> dict:
    """`profiling.card()` of the device's card (name and power limit as
    nvidia-smi prints them, SM clock now and at most, power draw, throttle
    reasons); on the CPU {'device': 'cpu', 'name': 'cpu'}, which names no
    card."""
    if device.type != 'cuda':
        return {'device': 'cpu', 'name': 'cpu'}
    return profiling.card(device.index or 0)


class CardState:
    """The card's µs per graph node (`profiling.NodeLatency`) and its
    floor, the lowest reading so far, first read before the bench captures
    anything.  After a CUDA graph capture the per-node cost can stay ~30 %
    above the floor for seconds to a minute, with nvidia-smi's clocks
    unchanged (PERF.md, Findings); a reading within FAST_RATIO of the
    floor is the fast state."""

    FAST_RATIO = 1.15

    def __init__(self, device: torch.device, reads: int = 20):
        self.node = profiling.NodeLatency(device)
        self.floor = min(self.node() for _ in range(reads))

    def read(self) -> float:
        reading = self.node()
        self.floor = min(self.floor, reading)
        return reading

    def fast(self, reading: float) -> bool:
        return reading <= self.FAST_RATIO * self.floor


def card_state(device: torch.device):
    """A `CardState` on the card, None on the CPU."""
    return CardState(device) if device.type == 'cuda' else None


def probe_for(state):
    """The per-rep sampler for `profiling.timeit` with a `CardState`, None
    without one: a `profiling.card` reading taken during the rep, with the
    card's µs per graph node read right after it."""
    if state is None:
        return None
    index = state.node.x.device.index or 0

    def probe():
        read_card = profiling.card_probe(index)

        def read():
            reading = state.read()
            return dict(read_card(), node_us=reading,
                        fast=state.fast(reading))

        return read

    return probe


def warm_up(fn, min_s: float, max_s: float, state=None) -> dict:
    """Call `fn()` (one synchronized unit of the workload) back to back,
    so that the card is timed in the state it holds under this load: for
    `min_s` seconds, and with a `CardState` on until its last three
    readings are fast or `max_s` seconds have passed.  Returns the series
    of seconds per call and of µs per graph node after each."""
    calls, nodes = [], []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        fn()
        profiling.synchronize()
        calls.append(time.perf_counter() - t0)
        elapsed = time.perf_counter() - start
        if state is not None:
            nodes.append(state.read())
        settled = state is None or (
            len(nodes) >= 3 and all(state.fast(n) for n in nodes[-3:]))
        if elapsed >= max_s or (elapsed >= min_s and settled):
            break
    return {'min_s': min_s, 'max_s': max_s, 'seconds': elapsed,
            'calls': len(calls), 'call_s': calls, 'node_us': nodes or None,
            'floor_us': state.floor if state is not None else None,
            'settled': settled}


def lander_batch(b: int, device: torch.device):
    """bench.py's workload: Lander3D-v0 with DJI_PHANTOM, `b` envs reset
    under PRNGKey(0) at episode 0, and the demo's constant action
    MOTORVAL.  Returns (params, spec, key, env_ids, state, action)."""
    params, spec = default_params(), tasks.LANDER_3D
    key = prng.PRNGKey(0, device)
    env_ids = torch.arange(b, dtype=torch.int32, device=device)
    state, _ = base.reset(key, env_ids, torch.zeros_like(env_ids), params,
                          spec)
    action = torch.full((4, b), MOTORVAL, dtype=torch.float32, device=device)
    return params, spec, key, env_ids, state, action


class PolicyRollout:
    """`scripts/bench_train.py`'s exploration rollout: `steps` steps of
    `envs/base.step` under hover * (1 + a), a ~ N(mean, exp(log_std)) of
    the policy, the noise key split per step, the rewards summed.  On the
    card one step is a CUDA graph replayed `steps` times, as the train
    step's rollout runs; on the CPU the same step runs eagerly."""

    def __init__(self, params, spec, cfg: ppo.PPOConfig, base_key, env_ids,
                 steps: int):
        self.params, self.spec, self.cfg = params, spec, cfg
        self.base_key, self.env_ids, self.steps = base_key, env_ids, steps
        self.hover = hover_motor_value(params)
        self.graph = Graph(self.step, warmup=1) if env_ids.is_cuda else None

    def step(self, leaves, env_state, obs, key, acc):
        with torch.no_grad():
            key, sub = prng.split(key)
            mean, log_std, _ = ppo._policy(leaves, obs, self.cfg)
            action = mean + torch.exp(log_std) * prng.normal(
                sub, tuple(mean.shape), mean.dtype)
            env_state, ts = base.step(env_state, self.hover * (1.0 + action),
                                      self.base_key, self.env_ids,
                                      self.params, self.spec)
        return env_state, ts.obs, key, acc + ts.reward.sum()

    def __call__(self, leaves, env_state, key) -> torch.Tensor:
        """The summed reward of one rollout from `env_state` (0-dim)."""
        obs = base._get_obs(env_state.dyn.x, env_state.steps, self.params,
                            self.spec)
        carry = (env_state, obs, key, obs.new_zeros(()))
        step = self.graph or self.step
        for _ in range(self.steps):
            carry = step(leaves, *carry)
            if self.graph is not None:
                leaves = self.graph.inputs[0]
        return carry[-1]


def timed(run, state, *, reps: int, n_lo: int, n_hi: int,
          warmup: tuple) -> dict:
    """`run(n)` (n calls of the op, then a host read) warmed up with single
    calls (`warm_up(..., *warmup, state)`), then timed by
    `profiling.timeit` with the card sampled beside each rep
    (`probe_for(state)`); timeit's dict with the warm-up as 'warm_up'."""
    warm = warm_up(lambda: run(1), *warmup, state)
    res = profiling.timeit(run, reps, n_lo, n_hi, probe=probe_for(state))
    res['warm_up'] = warm
    return res


def write_json(path, obj) -> None:
    """`obj` as indented JSON at `path`, its directory made if missing."""
    path = Path(path)
    if path.parent:
        os.makedirs(path.parent, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)
