"""The port's PID stack (gym_copter_tpu_torch/control/pid.py) against the
JAX package's (gym_copter_tpu/control/pid.py) on the same float64 inputs,
and the mirrors of tests/test_pid.py: the scalar oracle, the angular
velocity reset, the altitude-hold sign, and the Lander3D and Hover3D
experts' closed loops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu.control import pid as jpid
from gym_copter_tpu_torch.control import heuristics, pid
from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core.tree import tree_leaves

CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread (see test_torch_neuroevolution.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ScalarPid:
    """The reference accumulator semantics (attic/mars/pidcontrollers/
    __init__.py:12-73), as tests/test_pid.py transcribes them."""

    def __init__(self, kp, ki, kd, windup_max=0.2):
        self.kp, self.ki, self.kd, self.windup = kp, ki, kd, windup_max
        self.error_i = self.last_error = self.d1 = self.d2 = 0.0

    def compute(self, target, actual):
        error = target - actual
        out = error * self.kp
        if self.ki > 0:
            self.error_i = min(max(self.error_i + error, -self.windup),
                               self.windup)
            out += self.error_i * self.ki
        if self.kd > 0:
            delta = error - self.last_error
            out += (self.d1 + self.d2 + delta) * self.kd
            self.d2, self.d1, self.last_error = self.d1, delta, error
        return out


def _t(x):
    return torch.tensor([x], dtype=torch.float64)


def test_pid_compute_matches_scalar_oracle():
    rng = np.random.default_rng(0)
    gains = pid.PidGains(kp=0.7, ki=1.3, kd=0.4, windup_max=0.2)
    oracle = ScalarPid(0.7, 1.3, 0.4)
    state = pid.pid_init(1, torch.float64, CPU)
    for _ in range(100):
        target, actual = rng.normal(size=2)
        state, demand = pid.pid_compute(state, gains, _t(target), _t(actual))
        np.testing.assert_allclose(float(demand[0]),
                                   oracle.compute(target, actual),
                                   rtol=1e-12)


def test_angular_velocity_reset_on_fast_rotation():
    """errorI and lastError reset above 40 deg/s; the smoothing window
    stays."""
    oracle = ScalarPid(1.0, 0.0, 1.0, windup_max=6.0)
    state = pid.pid_init(1, torch.float64, CPU)
    for v in (0.1, 0.3, 0.9, 0.2, 0.05):
        if abs(v) > np.radians(40):
            oracle.error_i = oracle.last_error = 0.0
        expected = oracle.compute(0.0, v)
        state, demand = pid.angular_velocity(state, _t(v))
        np.testing.assert_allclose(float(demand[0]), expected, rtol=1e-12)


def test_altitude_hold_demand_sign():
    """Below the target altitude the controller demands climb."""
    state = pid.setpoint_init(1, torch.float64, CPU)
    _, demand = pid.altitude_hold(state, _t(-2.0), _t(0.0))
    assert float(demand[0]) > 0


def test_controllers_match_jax_step_for_step():
    """Every controller of the module (the generic PID with and without its
    I and D terms, the set-point cascade, altitude and position hold,
    descent, the angular velocity with its reset) threaded for 50 steps
    over the same float64 inputs of 64 lanes, against JAX's: states and
    demands equal to 1e-15 (measured: bit-equal)."""
    rng = np.random.default_rng(1)
    b = 64
    gains = [pid.PidGains(0.7, 1.3, 0.4), pid.PidGains(0.5, 0.0, 0.2),
             pid.PidGains(0.3, 2.0, 0.0, 0.5)]
    t_states = [pid.pid_init(b, torch.float64, CPU) for _ in gains] + [
        pid.setpoint_init(b, torch.float64, CPU) for _ in range(2)] + [
        pid.pid_init(b, torch.float64, CPU)]
    j_states = [jpid.pid_init(b, jnp.float64) for _ in gains] + [
        jpid.setpoint_init(b, jnp.float64) for _ in range(2)] + [
        jpid.pid_init(b, jnp.float64)]
    for _ in range(50):
        x, dx, target = rng.normal(size=(3, b))
        ang = rng.normal(size=b)  # some lanes above 40 deg/s
        tx, tdx, tt, ta = (torch.from_numpy(v) for v in (x, dx, target, ang))
        jx, jdx, jt, ja = (jnp.asarray(v) for v in (x, dx, target, ang))
        outs_t, outs_j = [], []
        for i, g in enumerate(gains):
            t_states[i], d = pid.pid_compute(t_states[i], g, tt, tx)
            j_states[i], e = jpid.pid_compute(
                j_states[i], jpid.PidGains(*g), jt, jx)
            outs_t.append(d)
            outs_j.append(e)
        t_states[3], d = pid.altitude_hold(t_states[3], tx, tdx)
        j_states[3], e = jpid.altitude_hold(j_states[3], jx, jdx)
        outs_t.append(d)
        outs_j.append(e)
        t_states[4], d = pid.position_hold(t_states[4], tx, tdx)
        j_states[4], e = jpid.position_hold(j_states[4], jx, jdx)
        outs_t.append(d)
        outs_j.append(e)
        outs_t.append(pid.descent(tx, tdx))
        outs_j.append(jpid.descent(jx, jdx))
        t_states[5], d = pid.angular_velocity(t_states[5], ta)
        j_states[5], e = jpid.angular_velocity(j_states[5], ja)
        outs_t.append(d)
        outs_j.append(e)
        for d, e in zip(outs_t, outs_j):
            np.testing.assert_allclose(d.numpy(), np.asarray(e), rtol=0,
                                       atol=1e-15)
    for a, b_ in zip(tree_leaves(t_states), jax.tree.leaves(j_states)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=0,
                                   atol=1e-15)


def test_lander3d_pid_reaches_pad():
    """Mirror: the expert brings at least 6 of 8 float64 envs to the pad
    (|z| < 1 m within the 2 m radius) with a median return above 150."""
    run = heuristics.run_expert('Lander3D-v0', 8, 1000, dtype=torch.float64,
                                device=CPU)
    assert bool(run.done_seen.all())
    end = run.end_x
    on_pad = ((end[C.STATE_Z].abs() < 1.0)
              & (torch.sqrt(end[C.STATE_X] ** 2 + end[C.STATE_Y] ** 2) < 2.0))
    assert int(on_pad.sum()) >= 6, end
    assert float(run.total.median()) > 150, run.total


def test_hover3d_pid_survives_full_horizon():
    """Mirror: the hover expert (+1 per step) scores a median above 900
    over 999 steps (key 1, 4 float64 envs)."""
    run = heuristics.run_expert('Hover3D-v0', 4, 999, seed=1,
                                dtype=torch.float64, device=CPU)
    assert float(run.total.median()) > 900, run.total
