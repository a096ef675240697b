"""PID hover demo on the port: the counterpart of the repo's hover_demo.py
(after the reference's attic hover demos, attic/heuristic/hover.py and
attic/mars/hover3d.py): the batched altitude + position PID expert
(control/heuristics.py) holds the copter at its start altitude on
Hover3D-v0, on the card unless `--device cpu` is given; the recorded
trajectory is then replayed by the renderer or written to CSV.

Usage:
  python -m gym_copter_tpu_torch.demos.hover                 # animate
  ... --save traj.csv        # CSV (copter-plot format)
  ... --movie --nodisplay    # headless movie
  ... --steps 500 --seed 3
"""

import argparse
from argparse import ArgumentDefaultsHelpFormatter

import numpy as np

import gym_copter_tpu_torch as gt
from gym_copter_tpu_torch.control import heuristics
from gym_copter_tpu_torch.demos.lander import POSE_ROWS
from gym_copter_tpu_torch.render.csvlog import write_csv


def main(argv=None):
    """Runs the demo; returns the episode's total reward."""
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=ArgumentDefaultsHelpFormatter)
    p.add_argument('--save', dest='csvfilename',
                   help='Save trajectory in CSV file')
    p.add_argument('--movie', action='store_true')
    p.add_argument('--view', default='30,120')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--steps', type=int, default=999)
    p.add_argument('--nodisplay', action='store_true')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    env = gt.make('Hover3D-v0', num_envs=1, seed=args.seed,
                  device=args.device)
    dt = env.params.task.dt
    state, obs = env.reset()

    policy_state, policy_fn = heuristics.hover3d_pid(
        batch=1, params=env.params, device=env.device)
    state, _, traj = env.rollout(state, policy_fn, args.steps,
                                 policy_state=policy_state, obs=obs)

    done = traj.done[:, 0].cpu().numpy()
    end = int(done.argmax()) + 1 if done.any() else args.steps
    total = float(traj.reward[:end, 0].sum())
    pose_log = traj.x[:end, POSE_ROWS, 0].cpu().numpy()
    alt = -pose_log[:, 2]
    print(f'steps = {end}   total_reward = {total:+.2f}   '
          f'altitude range [{alt.min():.2f}, {alt.max():.2f}] m')

    if args.csvfilename:
        write_csv(args.csvfilename, dt * np.arange(end),
                  np.zeros((end, 4)), traj.obs[:end, :, 0].cpu().numpy(),
                  ['X', 'dX', 'Y', 'dY', 'Z', 'dZ',
                   'Phi', 'dPhi', 'Theta', 'dTheta', 'Psi', 'dPsi'])
        print('saved', args.csvfilename)

    if not args.nodisplay or args.movie:
        from gym_copter_tpu_torch.render.threed import ThreeDHoverRenderer
        renderer = ThreeDHoverRenderer(
            viewangles=tuple(int(s) for s in args.view.split(',')))
        renderer.play(pose_log, fps=int(round(1 / dt)),
                      outfile='hover.mp4' if args.movie else None,
                      show=not args.nodisplay)
    return total


if __name__ == '__main__':
    main()
