"""Constant-climb-rate PID dynamics check: the counterpart of
examples/velhold.py (the reference's attic/velhold.py, "Run simple
constant-climb-rate PID controller to test dynamics"): a velocity PI
controller (P=0.1, I=0.1, windup 10, attic/velhold.py:19-22,24-56) holds
dZ/dt at +1 m/s against the raw dynamics core (core/dynamics.py), then
altitude / velocity / motor traces are plotted in the reference's 3-panel
layout (attic/velhold.py:100-110).

The whole run is one loop over `dynamics.step` carrying (DynamicsState,
PI state, motor value) on the card (one step replayed as a CUDA graph)
unless `--device cpu` is given, with the traces written into preallocated
tensors.

    python -m gym_copter_tpu_torch.examples.velhold [--duration 10]
        [--save velhold.png]
"""

import argparse

import numpy as np
import torch

from gym_copter_tpu_torch.core import dynamics, vehicles
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.core.types import WorldParams

DT = 0.001         # attic CopterEnv dt (attic/gym_copter/envs/copter.py:40)
TARGET = 1.0       # m/s climb rate (attic/velhold.py:17)
KP, KI = 0.1, 0.1  # attic/velhold.py:20-21
WINDUP = 10.0      # attic/velhold.py:24 windupMax


def run(n, device, dtype=torch.float32):
    """n PI + dynamics steps from rest; returns the (n,) altitude,
    velocity and motor traces on `device`."""
    # the attic scripts fly the attic vehicle (B=5e-6); its hover motor
    # value is ~0.52, so a [0,1]-clipped PI can climb
    vp = vehicles.DJI_PHANTOM_ATTIC
    world = WorldParams()

    def step(state, error_i, u):
        state = dynamics.step(state, u.expand(4, 1), vp, world, DT)
        alt = -state.x[4, 0]    # NED -> altitude (attic/velhold.py:85)
        vel = -state.x[5, 0]
        # velocity PI with integral windup clamp (attic/velhold.py:44-53)
        error = TARGET - vel
        error_i = torch.clamp(error_i + error * DT, -WINDUP, WINDUP)
        u = torch.clamp(KP * error + KI * error_i, 0.0, 1.0)
        return state, error_i, u, torch.stack([alt, vel, u])

    carry = (dynamics.init_state(torch.zeros((12, 1), dtype=dtype,
                                             device=device)),
             torch.zeros((), dtype=dtype, device=device),
             torch.zeros((), dtype=dtype, device=device))
    trace = torch.empty((n, 3), dtype=dtype, device=device)
    fn = Graph(step, warmup=1) if device.type == 'cuda' else step
    for t in range(n):
        *carry, trace[t] = fn(*carry)
    return trace.T


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--duration', type=float, default=10.0)
    p.add_argument('--save', default=None,
                   help='save the figure instead of showing it')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    n = int(args.duration / DT)
    alts, vels, us = run(n, resolve_device(args.device)).cpu().numpy()
    tvals = np.linspace(0, args.duration, n)

    # dynamics check: the climb rate should settle at the setpoint
    settled = vels[n // 2:]
    print(f'steps = {n}   mean climb rate (2nd half) = {settled.mean():.3f} '
          f'm/s (target {TARGET})   final altitude = {alts[-1]:.2f} m')

    import matplotlib
    if args.save:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    for k, (series, label) in enumerate(((alts, 'Altitude (m)'),
                                         (vels, 'Velocity (m/s)'),
                                         (us, 'Motors'))):
        plt.subplot(3, 1, k + 1)
        plt.plot(tvals, series)
        plt.ylabel(label)
    plt.xlabel('Time (s)')
    if args.save:
        plt.savefig(args.save, dpi=110)
        print('saved', args.save)
    else:
        plt.show()
    return float(settled.mean())


if __name__ == '__main__':
    main()
