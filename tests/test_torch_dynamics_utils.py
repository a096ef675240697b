"""The port's frame utilities (gym_copter_tpu_torch/core/dynamics.py:
`inertial_to_body`, `body_to_inertial`, `euler_to_quaternion`, `state_dict`,
`get_time`) against the JAX package's (core/dynamics.py:246-305), a numpy
rotation matrix, and the numpy oracle's clock (compat/numpy_oracle.py), in
float64, batched (B,) and unbatched ()."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_copter_tpu.compat.numpy_oracle import OracleDynamics
from gym_copter_tpu.core import constants as JC
from gym_copter_tpu.core import dynamics as jdynamics
from gym_copter_tpu.core import vehicles as jvehicles
from gym_copter_tpu.core.types import EnvParams as JEnvParams
from gym_copter_tpu_torch.core import constants as C
from gym_copter_tpu_torch.core import dynamics, vehicles
from gym_copter_tpu_torch.core.types import EnvParams

PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
JPARAMS = JEnvParams(vehicle=jvehicles.DJI_PHANTOM)


def _inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, (3, n)), rng.uniform(-10, 10, (3, n))


def _rotation(phi, theta, psi):
    """Body-to-inertial rotation matrix (Z-Y-X Euler angles), numpy."""
    cph, sph = math.cos(phi), math.sin(phi)
    cth, sth = math.cos(theta), math.sin(theta)
    cps, sps = math.cos(psi), math.sin(psi)
    rz = np.array([[cps, -sps, 0], [sps, cps, 0], [0, 0, 1]])
    ry = np.array([[cth, 0, sth], [0, 1, 0], [-sth, 0, cth]])
    rx = np.array([[1, 0, 0], [0, cph, -sph], [0, sph, cph]])
    return rz @ ry @ rx


@pytest.mark.parametrize('name', ['inertial_to_body', 'body_to_inertial'])
@pytest.mark.parametrize('batched', [True, False])
def test_rotations_match_jax_and_the_rotation_matrix(name, batched):
    """Both rotations against the JAX functions (rtol 1e-12: torch's and
    XLA's sin/cos differ by an ULP) and against R or R^T of the numpy
    rotation matrix (1e-12)."""
    angles, vecs = _inputs(0 if batched else 1)
    if not batched:
        angles, vecs = angles[:, 0], vecs[:, 0]
    got = getattr(dynamics, name)(torch.from_numpy(vecs),
                                  *torch.from_numpy(angles)).numpy()
    want = np.asarray(getattr(jdynamics, name)(
        jnp.asarray(vecs), *jnp.asarray(angles)))
    assert got.shape == want.shape == vecs.shape
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    a2, v2 = angles.reshape(3, -1), vecs.reshape(3, -1)
    for i in range(a2.shape[1]):
        r = _rotation(*a2[:, i])
        oracle = r @ v2[:, i] if name == 'body_to_inertial' else \
            r.T @ v2[:, i]
        np.testing.assert_allclose(got.reshape(3, -1)[:, i], oracle,
                                   rtol=1e-12, atol=1e-12)


def test_rotation_round_trip_and_body_z_column():
    """body_to_inertial inverts inertial_to_body, and the physics step's
    body-Z column (`body_z_to_inertial`) is body_to_inertial of (0, 0, z)."""
    angles, vecs = (torch.from_numpy(a) for a in _inputs(5))
    back = dynamics.body_to_inertial(
        dynamics.inertial_to_body(vecs, *angles), *angles)
    np.testing.assert_allclose(back.numpy(), vecs.numpy(), rtol=1e-12,
                               atol=1e-12)
    z = vecs[2]
    col = torch.stack(dynamics.body_z_to_inertial(z, *angles))
    full = dynamics.body_to_inertial(
        torch.stack([torch.zeros_like(z), torch.zeros_like(z), z]), *angles)
    np.testing.assert_allclose(col.numpy(), full.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize('batched', [True, False])
def test_euler_to_quaternion_matches_jax(batched):
    """The quaternion with the reference's signs (third component negated)
    against JAX's, rtol 1e-12; unit norm; for a pure yaw psi it is
    (cos psi/2, 0, 0, sin psi/2)."""
    angles, _ = _inputs(2)
    if not batched:
        angles = angles[:, 0]
    got = dynamics.euler_to_quaternion(*torch.from_numpy(angles)).numpy()
    want = np.asarray(jdynamics.euler_to_quaternion(*jnp.asarray(angles)))
    assert got.shape == want.shape == (4,) + angles.shape[1:]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose((got * got).sum(0), 1.0, rtol=1e-12)
    yaw = dynamics.euler_to_quaternion(*torch.tensor([0.0, 0.0, 0.7],
                                                     dtype=torch.float64))
    np.testing.assert_allclose(yaw.numpy(), [math.cos(0.35), 0, 0,
                                             math.sin(0.35)], atol=1e-15)


def test_state_dict_and_clock_follow_the_oracle():
    """Over 5 steps of 3 airborne envs, `state_dict` (getState's key order)
    holds the oracle's state (rtol 1e-12) and `get_time` its ticks * dt;
    a touchdown step does not tick, as in the oracle and the JAX
    function."""
    dt = PARAMS.task.dt
    x0 = np.zeros((12, 3))
    x0[C.STATE_Z] = -10.0
    x0[C.STATE_PHI] = [0.0, 0.1, -0.2]
    st = dynamics.init_state(torch.from_numpy(x0))
    oracles = []
    for i in range(3):
        o = OracleDynamics(JPARAMS)
        o.set_state(x0[:, i])
        oracles.append(o)
    motors = np.full((4, 3), 0.6)
    for _ in range(5):
        st = dynamics.step(st, torch.from_numpy(motors), PARAMS.vehicle,
                           PARAMS.world, dt)
        for o in oracles:
            o.step(motors[:, 0])
    d = dynamics.state_dict(st)
    assert list(d) == ['x', 'dx', 'y', 'dy', 'z', 'dz', 'phi', 'dphi',
                       'theta', 'dtheta', 'psi', 'dpsi']
    for i, o in enumerate(oracles):
        np.testing.assert_allclose([float(v[i]) for v in d.values()], o.x,
                                   rtol=1e-12, atol=1e-15)
        assert float(dynamics.get_time(st, dt)[i]) == o.ticks * dt
    jst = jdynamics.init_state(jnp.asarray(x0))._replace(
        ticks=jnp.asarray(st.ticks.numpy()))
    np.testing.assert_array_equal(dynamics.get_time(st, dt).numpy(),
                                  np.asarray(jdynamics.get_time(jst, dt)))

    xt = np.zeros((12, 1))
    xt[C.STATE_Z], xt[C.STATE_Z_DOT] = 0.5, 0.5
    td = dynamics.init_state(torch.from_numpy(xt))._replace(
        status=torch.full((1,), C.STATUS_AIRBORNE, dtype=torch.int32))
    td = dynamics.step(td, torch.from_numpy(motors[:, :1]), PARAMS.vehicle,
                       PARAMS.world, dt)
    o = OracleDynamics(JPARAMS)
    o.set_state(xt[:, 0])
    o.status = JC.STATUS_AIRBORNE
    o.step(motors[:, 0])
    assert float(dynamics.get_time(td, dt)[0]) == o.ticks * dt == 0.0
    assert dynamics.get_time(td, dt).dtype == torch.float64
