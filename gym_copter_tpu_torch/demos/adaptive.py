"""Adaptive disturbance-rejection demo on the port: the counterpart of
scripts/adaptive_demo.py (after the reference's Nengo PES hover
experiment, attic/nengo/adaptive.py).

Runs a sweep of wind forces as one batch (learn/adaptive.py), on the card
unless `--device cpu` is given: every plant has its own disturbance and
its own online-adapting weights.  Prints the final tracking error with and
without adaptation, and optionally saves a comparison plot (matplotlib) or
the altitude traces as CSV.

Usage:
  python -m gym_copter_tpu_torch.demos.adaptive [--winds -4 -2 0 2 4]
      [--steps 6000] [--plot adaptive.png] [--save adaptive.csv]
"""

import argparse

import numpy as np

from gym_copter_tpu_torch.core import vehicles
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.learn import adaptive


def main(argv=None):
    """Runs the demo; returns the (PD, adaptive) final errors per wind."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--winds', type=float, nargs='+',
                   default=[-4.0, -2.0, 0.0, 2.0, 4.0],
                   help='sustained vertical wind forces (N), one plant each')
    p.add_argument('--steps', type=int, default=6000)
    p.add_argument('--plot', default=None, help='save a comparison figure')
    p.add_argument('--save', default=None, help='save altitude traces CSV')
    p.add_argument('--device', default=None,
                   help='torch device; default the card')
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    cfg = adaptive.AdaptiveConfig()

    results = {}
    for flag in (False, True):
        h = adaptive.run(params, args.winds, args.steps, cfg, adapt=flag,
                         device=device)
        err = adaptive.tracking_error(h, cfg).cpu().numpy()
        results[flag] = (h['z'].cpu().numpy(), err)
        label = 'adaptive ' if flag else 'PD only  '
        print(f'{label} final |z - {cfg.target:.0f}m| per wind: '
              + np.array2string(err, precision=3))

    improvement = results[False][1] / np.maximum(results[True][1], 1e-9)
    print('improvement factor per wind:',
          np.array2string(improvement, precision=1))

    dt = params.task.dt
    t = dt * np.arange(args.steps)
    if args.save:
        z_off, z_on = results[False][0], results[True][0]
        with open(args.save, 'w') as f:
            cols = [f'z_pd_w{w:+.0f}' for w in args.winds] + \
                   [f'z_adapt_w{w:+.0f}' for w in args.winds]
            f.write('t,' + ','.join(cols) + '\n')
            for i in range(args.steps):
                row = [t[i]] + list(z_off[i]) + list(z_on[i])
                f.write(','.join(f'{v:.4f}' for v in row) + '\n')
        print('saved', args.save)

    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharey=True)
        for ax, flag, title in ((axes[0], False, 'PD only'),
                                (axes[1], True, 'PD + PES adaptation')):
            z = results[flag][0]
            for j, w in enumerate(args.winds):
                ax.plot(t, z[:, j], label=f'wind {w:+.0f} N', lw=0.9)
            ax.axhline(cfg.target, color='0.6', ls='--', lw=0.8)
            ax.set_title(title)
            ax.set_xlabel('time (s)')
        axes[0].set_ylabel('altitude (m)')
        axes[1].legend(fontsize=8)
        fig.savefig(args.plot, dpi=110, bbox_inches='tight')
        print('saved', args.plot)
    return results[False][1], results[True][1]


if __name__ == '__main__':
    main()
