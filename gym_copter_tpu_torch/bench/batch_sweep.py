"""Fused-rollout throughput against the env batch on one card, the
counterpart of `scripts/bench_batch_sweep.py`.

    python -m gym_copter_tpu_torch.bench.batch_sweep \\
        [--out docs/torch_bench_batch_sweep.json] [--batches 1024 ...]

The headline pins B = 4096; this sweep records how the card's throughput
scales with the batch, the capacity-planning curve for choosing envs per
card.  Same methodology as the headline: the differential's marginal
workload is held at MARGINAL_ENV_STEPS = 4e9 env-steps for every batch by
scaling the step windows inversely with B (t_lo = max(1000, t_marg / 10)),
median of 8 samples, those at or under 50 ms of marginal time rejected.
Each record also names the lanes per env that `lanes_for` chose for the
batch on this card.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gym_copter_tpu_torch.bench import common
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.ops import fused_rollout as fr
from gym_copter_tpu_torch.utils import profiling

MARGINAL_ENV_STEPS = 4_000_000_000
BATCHES = (1024, 2048, 4096, 8192, 16384, 32768)
T_LO_FLOOR = 1000
MIN_MARGINAL_S = 0.05


def bench_batch(b: int, reps: int = 8, *, device=None,
                marginal_env_steps: int = MARGINAL_ENV_STEPS,
                t_lo_floor: int = T_LO_FLOOR,
                min_marginal_s: float = MIN_MARGINAL_S) -> dict:
    """One batch's record: env-steps/s of the fused rollout at `b` envs."""
    device = resolve_device(device)
    params, spec, _, _, state, action = common.lander_batch(b, device)

    def run(num_steps):
        _, tot = fr.fused_rollout(state, action, num_steps, params, spec,
                                  seed=0)
        return float(tot['reward_sum'][0])

    t_marg = marginal_env_steps // b
    t_lo = max(t_lo_floor, t_marg // 10)
    launches = fr.fused_rollout.launches
    res = profiling.differential_steps_per_sec(
        run, t_lo, t_lo + t_marg, batch=b, reps=reps,
        min_marginal_s=min_marginal_s)
    launches = fr.fused_rollout.launches - launches
    lanes = (fr.lanes_for(b, torch.cuda.get_device_properties(
        device).multi_processor_count) if device.type == 'cuda' else None)
    return {
        'num_envs': b,
        'env_steps_per_sec': res['steps_per_sec'],
        'spread_pct': res['spread_pct'],
        'rejected_samples': res['rejected'],
        'ns_per_env_step': res['ns_per_iter'] / b,
        'lanes_per_env': lanes,
        'kernel_launches': launches,
        't_lo': t_lo,
        't_hi': t_lo + t_marg,
    }


def sweep(batches=BATCHES, *, device=None,
          marginal_env_steps: int = MARGINAL_ENV_STEPS,
          t_lo_floor: int = T_LO_FLOOR,
          min_marginal_s: float = MIN_MARGINAL_S) -> dict:
    """The sweep's record: one row per batch, printed as it is measured."""
    device = resolve_device(device)
    card = common.card_record(device)
    rows = []
    for b in batches:
        rows.append(bench_batch(b, device=device,
                                marginal_env_steps=marginal_env_steps,
                                t_lo_floor=t_lo_floor,
                                min_marginal_s=min_marginal_s))
        print(json.dumps(rows[-1]), flush=True)
    return {'backend': device.type, 'env': 'Lander3D-v0',
            'metric': 'fused_rollout env-steps/s vs batch, one card',
            'methodology': (f'differential over {marginal_env_steps:g} '
                            f'marginal env-steps per batch, median of 8, '
                            f'reject <= {min_marginal_s:g} s'),
            'card': card, 'card_after': common.card_record(device),
            'torch': torch.__version__, 'rows': rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out', default=str(common.DOCS
                                        / 'torch_bench_batch_sweep.json'))
    p.add_argument('--batches', type=int, nargs='+', default=list(BATCHES))
    args = p.parse_args(argv)
    out = sweep(args.batches)
    common.write_json(args.out, out)
    print('wrote', args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
