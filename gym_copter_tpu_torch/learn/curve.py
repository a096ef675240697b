"""Multi-seed PPO learning curves on the port: the counterpart of
scripts/train_curve.py, with its flags, defaults and JSON schema.

    python3 -m gym_copter_tpu_torch.learn.curve --env Lander3D-v0 \\
        --envs 4096 --updates 600 --seeds 0 \\
        --out docs/torch_lander3d_curve_4096.json

Trains on the card (`--device cpu` for the CPU) for each seed and writes
the deterministic-eval curves, the cross-seed final-window statistics, the
wall seconds of each run, and the card's name and power limit as
`nvidia-smi` reports them.  `--ckpt PATH` saves the last seed's whole
TrainState through utils/checkpoint.py, as a .npz file or, for a path not
ending in .npz, an orbax checkpoint directory (the JAX package's two
formats), so that either package restores it; a path neither can be
written at raises before training.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.learn import ppo
from gym_copter_tpu_torch.utils import checkpoint


def card(device: torch.device):
    """nvidia-smi's name and power limit of the card, or None on the CPU."""
    if device.type != 'cuda':
        return None
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '-i', str(device.index or 0)],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def config(args) -> ppo.PPOConfig:
    # 0 = leave minibatches and shuffle_block at the library's auto rules
    return ppo.PPOConfig(rollout_steps=args.rollout,
                         entropy_coef=args.entropy,
                         learning_rate=args.lr,
                         gamma=args.gamma,
                         value_clip=args.value_clip,
                         log_std_max=args.log_std_max,
                         log_std_min=args.log_std_min,
                         anneal_lr_floor=args.anneal_floor,
                         anneal_lr=not args.no_anneal,
                         target_kl=args.target_kl,
                         hidden=args.hidden,
                         minibatches=args.minibatches or None,
                         shuffle_block=args.shuffle_block or None,
                         matmul_dtype=args.matmul_dtype or None)


def run_seed(args, seed, device):
    t0 = time.perf_counter()
    ts, history = ppo.train(args.env, num_envs=args.envs,
                            num_updates=args.updates, seed=seed,
                            cfg=config(args), log_every=args.log_every,
                            keep_best=args.keep_best, device=device)
    seconds = time.perf_counter() - t0
    return ts, [{'update': i, **m} for i, m in history], seconds


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--env', default='Hover3D-v0')
    p.add_argument('--updates', type=int, default=1500)
    p.add_argument('--envs', type=int, default=1024)
    p.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    p.add_argument('--rollout', type=int, default=128)
    # the validated recipe of scripts/train_curve.py: lr 3e-4 annealed to
    # zero, entropy bonus 1e-2, per-minibatch KL guard 0.015
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--entropy', type=float, default=1e-2)
    p.add_argument('--gamma', type=float, default=0.995)
    p.add_argument('--value-clip', type=float, default=0.0)
    p.add_argument('--log-std-max', type=float, default=0.5)
    p.add_argument('--log-std-min', type=float, default=-4.0)
    p.add_argument('--no-anneal', action='store_true')
    p.add_argument('--anneal-floor', type=float, default=0.0)
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--minibatches', type=int, default=0,
                   help='minibatches per epoch; 0 = scale with the env '
                        'batch (ppo.scaled_minibatches)')
    p.add_argument('--shuffle-block', type=int, default=0,
                   help='minibatch shuffle granularity; 0 = auto (128 at '
                        '>= 4096 envs, else 1)')
    p.add_argument('--target-kl', type=float, default=0.015,
                   help='per-minibatch approx-KL guard (0 disables)')
    p.add_argument('--matmul-dtype', default='',
                   help="'' = float32 products; 'bfloat16' = bf16 operands")
    p.add_argument('--keep-best', action='store_true',
                   help='returned/saved policy = best evaluated one')
    p.add_argument('--final-window', type=int, default=300,
                   help='updates at the tail over which "final" is averaged')
    p.add_argument('--out', default='curve.json')
    p.add_argument('--ckpt', default=None,
                   help='.npz file or orbax directory for the last seed\'s '
                        'whole TrainState (utils/checkpoint.py; restores in '
                        'either package)')
    p.add_argument('--log-every', type=int, default=50)
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if args.ckpt:
        checkpoint.check_path(args.ckpt)
    device = resolve_device(args.device)
    runs, ts = [], None
    for seed in args.seeds:
        ts, curve, seconds = run_seed(args, seed, device)
        tail = [c['eval_return'] for c in curve
                if c['update'] >= args.updates - args.final_window]
        runs.append({
            'seed': seed,
            'first_eval_return': curve[0]['eval_return'],
            'best_eval_return': max(c['eval_return'] for c in curve),
            'final_eval_return': curve[-1]['eval_return'],
            'final_window_mean': float(np.mean(tail)),
            'final_window_min': float(np.min(tail)),
            'seconds': seconds,
            'curve': curve,
        })
        print('seed %d: first %.1f  best %.1f  final-window mean %.1f '
              'min %.1f  (%.1f s)' % (seed, runs[-1]['first_eval_return'],
                                      runs[-1]['best_eval_return'],
                                      runs[-1]['final_window_mean'],
                                      runs[-1]['final_window_min'], seconds),
              flush=True)

    finals = [r['final_window_mean'] for r in runs]
    resolved = ppo.resolve_minibatches(config(args), args.envs)
    summary = {
        'env': args.env,
        'seeds': args.seeds,
        'env_steps_per_seed': args.updates * args.envs * args.rollout,
        'config': {'updates': args.updates, 'envs': args.envs,
                   'rollout': args.rollout, 'lr': args.lr,
                   'entropy': args.entropy, 'gamma': args.gamma,
                   'minibatches': resolved.minibatches,
                   'shuffle_block': resolved.shuffle_block,
                   'hidden': args.hidden,
                   'target_kl': args.target_kl,
                   'anneal_floor': args.anneal_floor,
                   'keep_best': args.keep_best,
                   'final_window': args.final_window},
        'final_window_mean_across_seeds': float(np.mean(finals)),
        'final_window_spread': [float(np.min(finals)), float(np.max(finals))],
        'device': {'type': device.type, 'card': card(device),
                   'torch': torch.__version__},
        'runs': runs,
    }
    with open(args.out, 'w') as f:
        json.dump(summary, f, indent=1)
    print('wrote %s   final-window mean across seeds: %.1f  spread '
          '[%.1f, %.1f]' % (args.out,
                            summary['final_window_mean_across_seeds'],
                            *summary['final_window_spread']))
    if args.ckpt and ts is not None:
        checkpoint.save(args.ckpt, ts, ppo.train_optimizer(resolved,
                                                           args.updates))
        print('checkpoint saved to', args.ckpt)
    return summary


if __name__ == '__main__':
    main()
