"""Climb-and-leap open-loop demo: the counterpart of examples/leap.py (the
reference's attic/examples/leap.py): full throttle until the target
altitude, then an asymmetric motor pattern pitches the copter into forward
flight until it crashes or leaves the arena.  Through the port's single
env (compat/single.py), on the card unless `--device cpu` is given.

    python -m gym_copter_tpu_torch.examples.leap [--altitude 10]
"""

import argparse

import numpy as np

from gym_copter_tpu_torch.compat.single import SingleCopterEnv
from gym_copter_tpu_torch.control.heuristics import hover_motor_value


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--altitude', type=float, default=10.0)
    p.add_argument('--steps', type=int, default=1200)
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    env = SingleCopterEnv('Distance-v0', device=args.device)  # no bounds
    hover = hover_motor_value(env._env.params)
    obs, _ = env.reset(seed=0)

    climb = np.full(4, 2.0 * hover, np.float32)               # full climb
    leap = np.asarray([0, 2.0, 0, 2.0], np.float32) * hover  # pitch forward
    u = climb
    leaping = False
    dist = peak = 0.0
    for step in range(args.steps):
        obs, reward, done, _, _ = env.step(u)
        if done:
            break
        z = -obs[4]
        dist = max(dist, float(np.hypot(obs[0], obs[2])))
        peak = max(peak, z)
        if not leaping and z > args.altitude:
            u = leap
            leaping = True
            print(f'leap! step {step}, altitude {z:.2f} m')
    print(f'steps = {step + 1}   distance = {dist:.2f} m   '
          f'peak altitude = {peak:.2f} m')
    env.close()
    return dist


if __name__ == '__main__':
    main()
