"""Evolve a NEAT-style or HyperNEAT controller on the port: the
counterpart of scripts/neat_evolve.py, with its flags, defaults and JSON
schema.

    python3 -m gym_copter_tpu_torch.learn.evolve --algo hyperneat \\
        --env Lander3D-v0 --pop 960 --seeds 0 \\
        --out docs/torch_hyperneat_lander3d.json

Evolves on the card (`--device cpu` for the CPU) for each seed, evaluates
each run's champion over `--eval-reps` fresh episodes, and writes the
learning record (per-generation best, mean and holdout fitness), plus the
card's name and power limit as `nvidia-smi` reports them; `--save-genome`
writes the best seed's champion as an `.npz` in the JAX layout, which
either package loads.
"""

import argparse
import json
import time

import numpy as np
import torch

from gym_copter_tpu_torch.compat.convert import genome_to_numpy
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.learn import hyperneat as hn
from gym_copter_tpu_torch.learn import neuroevolution as ne
from gym_copter_tpu_torch.learn.curve import card


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--env', default='Lander2D-v0')
    p.add_argument('--pop', type=int, default=96)
    p.add_argument('--reps', type=int, default=10)
    p.add_argument('--target', type=float, default=300.0)
    p.add_argument('--hidden', type=int, default=16)
    p.add_argument('--generations', type=int, default=1000)
    p.add_argument('--seeds', type=int, nargs='+', default=[0])
    p.add_argument('--eval-reps', type=int, default=100)
    p.add_argument('--anchor', default='hover', choices=['hover', 'direct'])
    p.add_argument('--algo', default='ga', choices=['ga', 'hyperneat'],
                   help="'ga' = direct-encoding masked-topology GA "
                        "(learn/neuroevolution.py); 'hyperneat' = "
                        "CPPN-generated substrate networks "
                        "(learn/hyperneat.py)")
    p.add_argument('--out', default=None, help='JSON record path')
    p.add_argument('--save-genome', default=None,
                   help='champion .npz path (best seed)')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.algo == 'hyperneat':
        cfg = hn.HyperNeatConfig(pop_size=args.pop, episode_reps=args.reps,
                                 fitness_threshold=args.target,
                                 action_anchor=args.anchor)
        evolve_population, evaluate_champion = (hn.evolve_population,
                                                hn.evaluate_champion)
    else:
        cfg = ne.NeatConfig(pop_size=args.pop, episode_reps=args.reps,
                            fitness_threshold=args.target,
                            hidden=args.hidden, action_anchor=args.anchor)
        evolve_population, evaluate_champion = (ne.evolve_population,
                                                ne.evaluate_champion)
    runs, best_champ, best_champ_score = [], None, -float('inf')
    for seed in args.seeds:
        t0 = time.perf_counter()
        champ, hist, _ = evolve_population(
            args.env, cfg, max_generations=args.generations, seed=seed,
            device=device)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        robust, _ = evaluate_champion(champ, args.env, cfg,
                                      reps=args.eval_reps)
        best = max(h['best_fitness'] for h in hist)
        train_gen = next((h['generation'] for h in hist
                          if h.get('train_threshold_reached')), None)
        print(f'{args.env} seed {seed}: best fitness {best:.1f} in '
              f'{len(hist)} generations ({wall:.0f}s, train threshold at '
              f'gen {train_gen}); champion over {args.eval_reps} fresh '
              f'episodes: {robust:.1f} (target {args.target})', flush=True)
        runs.append({
            'seed': seed,
            'generations_run': len(hist),
            'best_fitness': best,
            'reached_target': bool(best >= args.target),
            'train_threshold_generation': train_gen,
            'champion_eval_mean': robust,
            'champion_eval_reached_target': bool(robust >= args.target),
            'best_holdout': max(h['holdout_best'] for h in hist),
            'wall_seconds': wall,
            'generations_per_sec': len(hist) / wall,
            'curve': hist,
        })
        if robust > best_champ_score:
            best_champ_score, best_champ = robust, champ

    record = {
        'env': args.env,
        'algorithm': ('hyperneat (CPPN-generated substrate)'
                      if args.algo == 'hyperneat'
                      else 'neat-style GA (masked topology)'),
        'config': {'algo': args.algo, 'pop_size': args.pop,
                   'episode_reps': args.reps,
                   'fitness_threshold': args.target, 'hidden': args.hidden,
                   'seeds': args.seeds, 'action_anchor': args.anchor},
        'champion_eval_reps': args.eval_reps,
        'env_steps_per_generation': args.pop * args.reps * cfg.max_steps,
        'seeds_reaching_target': sum(r['reached_target'] for r in runs),
        'champion_eval_seeds_reaching_target':
            sum(r['champion_eval_reached_target'] for r in runs),
        'best_fitness_across_seeds': max(r['best_fitness'] for r in runs),
        'device': {'type': device.type, 'card': card(device),
                   'torch': torch.__version__},
        'runs': runs,
    }
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(record, f)
        print(f'wrote {args.out}')
    if args.save_genome and best_champ is not None:
        np.savez(args.save_genome, **genome_to_numpy(best_champ))
        print(f'wrote {args.save_genome}')
    return record


if __name__ == '__main__':
    main()
