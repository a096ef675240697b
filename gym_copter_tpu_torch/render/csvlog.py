"""Trajectory CSV logging, column-compatible with the reference.

Format matches lander.py:33-54 / attic/mars/task.py:150-169:
header `t,m1..m4,<STATE_NAMES>`, one row per step with time, the four motor
values, and the task observation — so files are directly readable by the
reference's utils/copter-plot.py (and this repo's utils/copter_plot.py).
"""

from __future__ import annotations

import numpy as np


def write_csv(path, times, motors, states, state_names):
    """times (T,), motors (T, 4), states (T, obs_dim)."""
    motors = np.asarray(motors, dtype=np.float64)
    states = np.asarray(states, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    with open(path, 'w') as f:
        f.write('t,' + ','.join('m%d' % k for k in range(1, 5)))
        f.write(',' + ','.join(state_names) + '\n')
        for t in range(len(times)):
            f.write('%f' % times[t])
            f.write((',%f' * motors.shape[1]) % tuple(motors[t]))
            f.write(((',%f' * states.shape[1]) + '\n') % tuple(states[t]))


def trajectory_to_csv(path, traj_obs, traj_actions, dt, state_names,
                      mix_matrix=None):
    """Save a rollout trajectory: traj_obs (T, obs_dim) or (T, obs_dim, 1),
    traj_actions (T, A) — the action is expanded to the 4 motor values via
    the task mix matrix, mirroring how the reference logs the raw 4-motor
    command."""
    obs = np.asarray(traj_obs)
    if obs.ndim == 3:
        obs = obs[..., 0]
    acts = np.asarray(traj_actions)
    if acts.ndim == 3:
        acts = acts[..., 0]
    if mix_matrix is not None:
        acts = acts @ np.asarray(mix_matrix, np.float64).T
    times = dt * np.arange(len(obs))
    write_csv(path, times, acts, obs, state_names)
