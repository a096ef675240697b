"""Hover3D PPO learning-curve validation on the port: the counterpart of
scripts/train_hover3d.py, with its flags and JSON.

Trains the actor-learner from a motors-off policy on the card (`--device
cpu` for the CPU) and records the deterministic-eval learning curve;
`--ckpt PATH` saves the final TrainState through utils/checkpoint.py: a
.npz file, or an orbax checkpoint directory for a path not ending in .npz
(the JAX package's two formats).

    python3 -m gym_copter_tpu_torch.learn.train_hover3d [--updates N]
        [--envs B] [--seed S] [--out curve.json] [--ckpt state.npz|DIR]
"""

import argparse
import json

from gym_copter_tpu_torch.learn import ppo
from gym_copter_tpu_torch.utils import checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--updates', type=int, default=1500)
    p.add_argument('--envs', type=int, default=1024)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--rollout', type=int, default=128)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--out', default='hover3d_curve.json')
    p.add_argument('--ckpt', default=None,
                   help='.npz file or orbax directory for the final '
                        'TrainState')
    p.add_argument('--log-every', type=int, default=50)
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)
    if args.ckpt:
        checkpoint.check_path(args.ckpt)

    cfg = ppo.PPOConfig(rollout_steps=args.rollout, entropy_coef=0.0,
                        learning_rate=args.lr)
    ts, history = ppo.train('Hover3D-v0', num_envs=args.envs,
                            num_updates=args.updates, seed=args.seed,
                            cfg=cfg, log_every=args.log_every,
                            device=args.device)

    curve = [{'update': i, **m} for i, m in history]
    summary = {
        'env': 'Hover3D-v0',
        'seed': args.seed,
        'env_steps': args.updates * args.envs * args.rollout,
        'first_eval_return': curve[0]['eval_return'],
        'best_eval_return': max(c['eval_return'] for c in curve),
        'final_eval_return': curve[-1]['eval_return'],
        'curve': curve,
    }
    with open(args.out, 'w') as f:
        json.dump(summary, f, indent=1)
    print('wrote', args.out)
    print('eval_return: first %.1f  best %.1f  final %.1f' % (
        summary['first_eval_return'], summary['best_eval_return'],
        summary['final_eval_return']))

    if args.ckpt:
        resolved = ppo.resolve_minibatches(cfg, args.envs)
        checkpoint.save(args.ckpt, ts,
                        ppo.train_optimizer(resolved, args.updates))
        print('checkpoint saved to', args.ckpt)
    return summary


if __name__ == '__main__':
    main()
