"""Altitude-PID dynamics check with plots: the counterpart of
examples/pidctrl.py (the reference's attic/examples/pidctrl.py, "Run
simple altitude-hold PID controller to test dynamics"): the cascaded
altitude-hold PID (control/pid.py) drives AltHold-v0 through the port's
single env (compat/single.py), on the card unless `--device cpu` is given;
then reward / altitude / velocity / action traces are plotted
(matplotlib).

    python -m gym_copter_tpu_torch.examples.pidctrl [--duration 10]
        [--save pidctrl.png]
"""

import argparse

import numpy as np
import torch

from gym_copter_tpu_torch.compat.single import SingleCopterEnv
from gym_copter_tpu_torch.control import pid
from gym_copter_tpu_torch.core import vehicles
from gym_copter_tpu_torch.core.types import EnvParams


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--duration', type=float, default=10.0)
    p.add_argument('--save', default=None,
                   help='save the figure instead of showing it')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    # the attic examples ran on the attic vehicle (B=5e-6), whose hover
    # point sits at motor ~0.52, where the PID's (1+demand)/2 rescale is
    # centred; the active B=5e-3 vehicle hovers at 0.016
    env = SingleCopterEnv('AltHold-v0', device=args.device,
                          params=EnvParams(vehicle=vehicles.DJI_PHANTOM_ATTIC))
    obs, _ = env.reset(seed=0)
    pstate = pid.setpoint_init(1, device=env.device)
    target = env._env.params.task.althold_target

    tvals, zvals, vvals, uvals, rvals = [], [], [], [], []
    u = -1.0                                  # motors initially off
    total_steps = int(args.duration * env.FRAMES_PER_SECOND)
    for step in range(total_steps):
        obs, reward, done, _, _ = env.step(np.array([u], np.float32))
        alt, climb = float(obs[0]), float(obs[1])  # AltHold obs is ENU
        # the cascaded altitude-hold PID works on NED state
        pstate, demand = pid.altitude_hold(
            pstate, torch.tensor([-alt], device=env.device),
            torch.tensor([-climb], device=env.device), target=target)
        # the PID emits a [-1,1] demand; the AltHold env itself rescales
        # (1+a)/2 -> motors (althold.py:38-42)
        u = float(np.clip(float(demand[0]), -1.0, 1.0))
        tvals.append(step / env.FRAMES_PER_SECOND)
        zvals.append(alt)
        vvals.append(climb)
        uvals.append(u)
        rvals.append(float(reward))
        if done:
            break

    on_target = np.mean(np.abs(np.asarray(zvals[len(zvals) // 2:])
                               - target) < 1.0)
    print(f'steps = {len(tvals)}   on-target fraction (2nd half) = '
          f'{on_target:.2f}')
    env.close()

    import matplotlib
    if args.save:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for k, (series, label) in enumerate((
            (rvals, 'Reward'), (zvals, 'Altitude (m)'),
            (vvals, 'Velocity (m/s)'), (uvals, 'Action'))):
        plt.subplot(4, 1, k + 1)
        plt.plot(tvals, series)
        plt.ylabel(label)
    plt.ylim([-1.1, 1.1])
    plt.xlabel('time (s)')
    if args.save:
        plt.savefig(args.save, dpi=110)
        print('saved', args.save)
    else:
        plt.show()
    return on_target


if __name__ == '__main__':
    main()
