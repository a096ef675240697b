"""Takeoff heuristic runner: the counterpart of examples/takeoff.py (the
reference's attic/gym_copter/envs/takeoff.py:113-173 embedded heuristic):
a velocity PID climbs the copter from the ground to the 5 m target,
through the port's single env (compat/single.py), on the card unless
`--device cpu` is given.

    python -m gym_copter_tpu_torch.examples.takeoff [--steps 500]
"""

import argparse

import numpy as np

from gym_copter_tpu_torch.compat.single import SingleCopterEnv
from gym_copter_tpu_torch.control.heuristics import hover_motor_value


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--steps', type=int, default=500)
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    env = SingleCopterEnv('Takeoff-v0', device=args.device)
    target = env._env.params.task.takeoff_target
    hover = hover_motor_value(env._env.params)
    obs, _ = env.reset(seed=0)

    # the reference's heuristic: velocity setpoint proportional to the
    # altitude error, velocity P loop on top (takeoff.py:113-140)
    ALT_P, VEL_P = 1.0, 1.0
    total = 0.0
    for step in range(args.steps):
        z, dz = -obs[4], -obs[5]                  # NED -> ENU
        vel_error = (target - z) * ALT_P - dz
        u = hover * (1.0 + VEL_P * vel_error)     # scaled around hover
        obs, reward, done, _, _ = env.step(np.full(4, u, np.float32))
        total += reward
        if step % 20 == 0 or done:
            print('steps =  %04d    altitude = %5.2f    '
                  'total_reward = %+0.3f' % (step, -obs[4], total))
        if done:
            break
    final_alt = float(-obs[4])
    print(f'final altitude {final_alt:.2f} m (target {target:.0f})')
    env.close()
    return final_alt


if __name__ == '__main__':
    main()
