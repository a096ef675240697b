"""Target-chase demo on the port: the counterpart of the repo's
target_demo.py.  A Target-v0 rollout feeds the dual-vehicle 3D view (the
reference's ThreeDTarget renderer, attic threed_target.py:11-24, fed from
the env's circling-target track, attic target.py:44-47), on the card
unless `--device cpu` is given.

The chaser flies the altitude-hold PID at the target's altitude while the
target circles at radius 10; both tracks come from one rollout of the env
(the target coordinates are rows 12-14 of the observation).

Usage:
  python -m gym_copter_tpu_torch.demos.target                 # animate
  ... --movie --nodisplay    # headless movie
"""

import argparse
from argparse import ArgumentDefaultsHelpFormatter

import numpy as np

import gym_copter_tpu_torch as gt
from gym_copter_tpu_torch.control import heuristics
from gym_copter_tpu_torch.demos.lander import POSE_ROWS


def main(argv=None):
    """Runs the demo; returns the chaser's final altitude."""
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=ArgumentDefaultsHelpFormatter)
    p.add_argument('--movie', action='store_true')
    p.add_argument('--view', default='30,120')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--steps', type=int, default=800)
    p.add_argument('--nodisplay', action='store_true')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    env = gt.make('Target-v0', num_envs=1, seed=args.seed,
                  device=args.device)
    dt = env.params.task.dt
    state, obs = env.reset()

    # Target actions are rescaled (1+a)/2 (attic target.py:38-40): map the
    # hover PID's [0,1] motor commands through the inverse, with the
    # altitude target at the orbit altitude
    pid_state, pid_fn = heuristics.hover3d_pid(
        batch=1, params=env.params,
        target=float(env.params.task.target_altitude), device=env.device)

    def policy_fn(pstate, obs):
        pstate, motors = pid_fn(pstate, obs[:12])
        return pstate, 2.0 * motors - 1.0

    state, _, traj = env.rollout(state, policy_fn, args.steps,
                                 policy_state=pid_state, obs=obs)

    done = traj.done[:, 0].cpu().numpy()
    end = int(done.argmax()) + 1 if done.any() else args.steps
    pose_log = traj.x[:end, POSE_ROWS, 0].cpu().numpy()
    target_xy = traj.obs[:end, 12:14, 0].cpu().numpy()
    target_alt = traj.obs[:end, 14, 0].cpu().numpy()
    target_xyz = np.column_stack([target_xy, -target_alt])  # NED z
    print(f'steps = {end}   chaser altitude '
          f'{-pose_log[-1, 2]:.2f} m   target at '
          f'({target_xyz[-1, 0]:+.2f}, {target_xyz[-1, 1]:+.2f})')

    if not args.nodisplay or args.movie:
        from gym_copter_tpu_torch.render.threed import ThreeDTargetRenderer
        renderer = ThreeDTargetRenderer(
            viewangles=tuple(int(s) for s in args.view.split(',')))
        renderer.play_pair(pose_log, target_xyz, fps=int(round(1 / dt)),
                           outfile='target.mp4' if args.movie else None,
                           show=not args.nodisplay)
    return float(-pose_log[-1, 2])


if __name__ == '__main__':
    main()
