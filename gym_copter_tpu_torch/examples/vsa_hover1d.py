"""Multi-setpoint 1-D altitude-hold experiment: the counterpart of
examples/vsa_hover1d.py (the reference's VSA study, attic/vsa/
hover1d.py:18-90): a proportional controller with a neutral hover offset
steps through a schedule of altitude targets on Hover1D, logging
`time,target,z,dz,e,u` rows to CSV (the reference's columns), through the
port's single env (compat/single.py) with `set_altitude`, on the card
unless `--device cpu` is given.  The gains are rescaled to the active
DJI-Phantom thrust constant (the reference's K_NEUTRAL=0.524 was the hover
value of the attic B=5e-6 vehicle; the active one hovers at ~0.0163).

    python -m gym_copter_tpu_torch.examples.vsa_hover1d [--targets 1 3 5]
        [--duration 10]
"""

import argparse

import numpy as np

from gym_copter_tpu_torch.compat.single import SingleCopterEnv
from gym_copter_tpu_torch.control.heuristics import hover_motor_value


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--targets', type=float, nargs='+', default=[1, 3, 5])
    p.add_argument('--start', type=float, default=3.0)
    p.add_argument('--duration', type=float, default=10.0,
                   help='total experiment time (s)')
    p.add_argument('--kp-rel', type=float, default=0.2,
                   help='P gain relative to the reference experiment')
    p.add_argument('--save', default=None,
                   help='CSV path (default: derived from the parameters, '
                        'like the reference)')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    env = SingleCopterEnv('Hover1D-v0', device=args.device)
    k_neutral = hover_motor_value(env._env.params)
    # preserve the reference's gain ratio K_P / K_NEUTRAL = 0.2 / 0.524
    k_p = args.kp_rel / 0.524 * k_neutral

    path = args.save or (
        'targets=%s_start=%d_kp=%2.4f_kneut=%2.4f.csv'
        % ('_'.join('%d' % t for t in args.targets), args.start, k_p,
           k_neutral))
    env.set_altitude(args.start)
    state, _ = env.reset(seed=0, perturb=False)

    total_steps = int(args.duration * env.FRAMES_PER_SECOND)
    steps_per_target = max(1, total_steps // len(args.targets))
    target_index, total_reward = 0, 0.0

    with open(path, 'w') as csvfile:
        csvfile.write('time,target,z,dz,e,u\n')
        for step in range(total_steps):
            t = step / env.FRAMES_PER_SECOND
            z, dz = -state[0], -state[1]          # NED -> ENU
            target = args.targets[target_index]
            e = (target - z) - dz                 # vsa/hover1d.py:61
            u = e * k_p + k_neutral
            csvfile.write('%3.3f,%3.3f,%3.3f,%3.3f,%3.3f,%3.5f\n'
                          % (t, target, z, dz, e, u))
            state, reward, done, _, _ = env.step(np.array([u]))
            total_reward += reward
            if step % 20 == 0 or done:
                print('steps =  %04d    total_reward = %+0.2f'
                      % (step, total_reward))
            if step > 0 and step % steps_per_target == 0:
                target_index = min(target_index + 1, len(args.targets) - 1)
            if done:
                break
    print('saved', path)
    env.close()
    return total_reward


if __name__ == '__main__':
    main()
