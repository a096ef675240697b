"""Batched-vision benchmark of the port on the card, the counterpart of
`scripts/bench_vision.py`.

    python -m gym_copter_tpu_torch.bench.vision \\
        [--out docs/torch_bench_vision.json] [--reps 6]

Env-steps/s of a whole `VisualCopterEnv` rollout over Lander3D-v0 (the
physics step and a camera image per env and step) under the demo's
constant action, with the images consumed on the card by a reduction (the
pixel sum is carried with the rewards), so the camera cannot be skipped:
at 1024 and 4096 envs with vision at res 16 (the reference wrapper's),
1024 envs at res 64, and DVS events at res 16.  Each step is a one-step
CUDA graph replayed, as the visual env runs on the card.

Each config first runs back to back in rollouts of WARMUP_STEPS, at least
10 and at most 120 s, until the card's µs per graph node is back within
15 % of its floor (`common.warm_up`, the series recorded): after a capture
the card can stay slow for seconds to a minute (PERF.md, Findings).
Windows: the JAX script sized them for a TPU's throughput; here they
follow the headline's rule, about TARGET_MARGINAL_S = 0.5 s of marginal
work per rep, from the step time measured on the card:
CALIBRATE_STEPS replays are timed, t_hi = ceil(0.5 s / step * 15 / 14)
and t_lo = t_hi // 15 (the JAX script's ratio).  Then the differential of
6 reps, those at or under 50 ms of marginal time rejected, the median.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from gym_copter_tpu_torch.bench import common
from gym_copter_tpu_torch.control.heuristics import MOTORVAL
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.envs import registry
from gym_copter_tpu_torch.envs.visual import VisualCopterEnv
from gym_copter_tpu_torch.sensors.vision import DVS, VisionSensor
from gym_copter_tpu_torch.utils import profiling

CONFIGS = ((1024, 16, False), (4096, 16, False), (1024, 64, False),
           (1024, 16, True))
TARGET_MARGINAL_S = 0.5
CALIBRATE_STEPS = 20
MIN_MARGINAL_S = 0.05
WARMUP_STEPS = 100


def methodology(target_marginal_s: float, min_marginal_s: float,
                warmup: tuple) -> str:
    return (f'torch:graph-1-step/warm{warmup[0]:g}-{warmup[1]:g}s-to-node-'
            f'floor/diff~{target_marginal_s:g}s-marginal '
            f'(t_hi = {target_marginal_s:g} s / step time of '
            f'{CALIBRATE_STEPS} timed replays x 15/14, t_lo = t_hi/15)/'
            f'median-mad/reject{min_marginal_s * 1e3:g}ms')


def bench_config(num_envs: int, res: int, dvs: bool, reps: int = 6, *,
                 device=None, target_marginal_s: float = TARGET_MARGINAL_S,
                 min_marginal_s: float = MIN_MARGINAL_S,
                 warmup: tuple = common.WARMUP, state=None) -> dict:
    device = resolve_device(device)
    env = registry.make('Lander3D-v0', num_envs=num_envs, seed=0,
                        device=device)
    sensor = (DVS if dvs else VisionSensor)(res=res, device=device)
    venv = VisualCopterEnv(env, dvs=dvs, sensor=sensor)
    action = torch.full((4, num_envs), MOTORVAL, dtype=torch.float32,
                        device=device)

    def step(state, acc):
        state, ts, img = venv.step(state, action)
        # consume the image on the card: the pixel sum keeps the camera live
        return state, acc + img.sum() + ts.reward.sum()

    one = Graph(step, warmup=1) if device.type == 'cuda' else step
    state0, _ = venv.reset()

    def run(n):
        carry = (state0, torch.zeros((), device=device))
        for _ in range(n):
            carry = one(*carry)
        return float(carry[1])                   # forced host sync

    warm = common.warm_up(lambda: run(WARMUP_STEPS), *warmup, state)
    t0 = time.perf_counter()
    run(CALIBRATE_STEPS)
    step_s = (time.perf_counter() - t0) / CALIBRATE_STEPS
    t_hi = max(2, math.ceil(target_marginal_s / step_s * 15 / 14))
    t_lo = max(1, t_hi // 15)
    res_ = profiling.differential_steps_per_sec(
        run, t_lo, t_hi, batch=num_envs, reps=reps,
        min_marginal_s=min_marginal_s)
    return {
        'env_steps_per_sec': res_['steps_per_sec'],
        'images_per_sec': res_['steps_per_sec'],  # one image per env-step
        'spread_pct': res_['spread_pct'],
        'rejected_samples': res_['rejected'],
        'us_per_batched_step': res_['ns_per_iter'] / 1e3,
        'calibration_us_per_step': step_s * 1e6,
        't_lo': t_lo, 't_hi': t_hi,
        'node_us_after': state.read() if state is not None else None,
        'warm_up': warm,
    }


def measure(configs=CONFIGS, reps: int = 6, *, device=None,
            target_marginal_s: float = TARGET_MARGINAL_S,
            min_marginal_s: float = MIN_MARGINAL_S,
            warmup: tuple = common.WARMUP) -> dict:
    """The benchmark's record; on the card unless device='cpu'."""
    device = resolve_device(device)
    state = common.card_state(device)  # its floor read before captures
    results = {'backend': device.type, 'env': 'Lander3D-v0',
               'card': common.card_record(device),
               'torch': torch.__version__,
               'methodology': methodology(target_marginal_s, min_marginal_s,
                                          warmup),
               'configs': []}
    for num_envs, res, dvs in configs:
        label = f'{num_envs}envs_res{res}' + ('_dvs' if dvs else '')
        print(f'benchmarking {label} ...', file=sys.stderr, flush=True)
        r = bench_config(num_envs, res, dvs, reps, device=device,
                         target_marginal_s=target_marginal_s,
                         min_marginal_s=min_marginal_s, warmup=warmup,
                         state=state)
        r.update({'num_envs': num_envs, 'res': res, 'dvs': dvs,
                  'label': label})
        results['configs'].append(r)
        print(json.dumps(r), flush=True)
    results['card_after'] = common.card_record(device)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out', default=str(common.DOCS
                                        / 'torch_bench_vision.json'))
    p.add_argument('--reps', type=int, default=6)
    args = p.parse_args(argv)
    results = measure(reps=args.reps)
    common.write_json(args.out, results)
    print('wrote', args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
