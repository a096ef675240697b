"""Simple-lander PD-expert runner: the counterpart of
examples/simple_lander3d.py (the reference's attic/gym_copter/envs/
simple_lander3d.py:214-244 `heuristic_lander` loop): the PD expert
(control/heuristics.py) flies the 3-demand (throttle, roll, pitch) lander
from its fixed +2.5 m X/Y offset down to a centred landing, through the
port's single env (compat/single.py), on the card unless `--device cpu`
is given.

    python -m gym_copter_tpu_torch.examples.simple_lander3d [--steps 600]
        [--movie out.mp4]
"""

import argparse

import numpy as np
import torch

from gym_copter_tpu_torch.compat.single import SingleCopterEnv
from gym_copter_tpu_torch.control.heuristics import lander3d_simple_pid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--steps', type=int, default=600)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--movie', default=None,
                   help='save the replayed 3D view to this mp4/gif')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    env = SingleCopterEnv('Lander3DSimple-v0', device=args.device)
    obs, _ = env.reset(seed=args.seed)
    _, policy = lander3d_simple_pid(1, device=env.device)

    poses = []
    total = 0.0
    for step in range(args.steps):
        _, action = policy(None, torch.from_numpy(
            np.asarray(obs, np.float64)[:, None]))
        obs, reward, done, _, _ = env.step(action[:, 0].numpy())
        total += reward
        poses.append(env.pose)
        if step % 20 == 0 or done:
            print('observations:',
                  ' '.join('%+0.2f' % v for v in np.asarray(obs)))
            print('step {} total_reward {:+0.2f}'.format(step, total))
        if done:
            break
    x, y = env.pose[0], env.pose[1]
    print('landed at (%.2f, %.2f), total reward %+0.2f%s'
          % (x, y, total, '  [inside-radius bonus]' if total > 100 else ''))

    if args.movie:
        import matplotlib
        matplotlib.use('Agg')
        from gym_copter_tpu_torch.render.threed import ThreeDLanderRenderer
        r = ThreeDLanderRenderer()
        r.play(np.asarray(poses), fps=env.FRAMES_PER_SECOND,
               outfile=args.movie, show=False)
        print('wrote', args.movie)
    env.close()
    return total


if __name__ == '__main__':
    main()
