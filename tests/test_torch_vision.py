"""The port's vision and DVS sensors (gym_copter_tpu_torch/sensors/
vision.py) and visual env (envs/visual.py): the mirror of
tests/test_vision.py, plus the same poses and the same env run through the
JAX package's sensors and env (gym_copter_tpu/sensors/vision.py,
envs/visual.py) on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import gym_copter_tpu as gct
import gym_copter_tpu_torch as gt
from gym_copter_tpu.envs.visual import VisualCopterEnv as JVisualCopterEnv
from gym_copter_tpu.sensors.vision import VisionSensor as JVisionSensor
from gym_copter_tpu_torch.envs.visual import VisualCopterEnv
from gym_copter_tpu_torch.sensors.vision import VisionSensor
from test_vision import REF_VS, load_reference_sensor

CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_poses(n, seed, angles=30.0):
    rng = np.random.default_rng(seed)
    poses = np.zeros((6, n), np.float32)
    poses[0:2] = rng.uniform(-3, 3, (2, n))
    poses[2] = rng.uniform(1, 10, n)
    poses[3:6] = rng.uniform(-angles, angles, (3, n))
    return poses


@pytest.mark.skipif(not os.path.exists(REF_VS),
                    reason='reference checkout not available')
@pytest.mark.parametrize('res', [16, 64])
def test_matches_reference_cv2_pipeline(res):
    """The analytic inverse warp agrees with the reference's
    cv2.warpPerspective pipeline except for rasterization edge pixels
    (>= 96 % pixel agreement across random poses)."""
    try:
        ref = load_reference_sensor()(res=res)
    except ImportError:
        pytest.skip('cv2 not available')
    ours = VisionSensor(res=res, device=CPU)
    rng = np.random.default_rng(0)
    for _ in range(8):
        x, y = rng.uniform(-3, 3, 2)
        z = rng.uniform(2, 10)
        phi, theta, psi = rng.uniform(-20, 20, 3)
        ri = ref.getImage(x, y, z, phi, theta, psi)
        oi = ours.get_image(x, y, z, phi, theta, psi).numpy()
        assert ri.shape == oi.shape
        assert (ri == oi).mean() >= 0.96


def test_basic_geometry():
    """Straight-down view: pad centred, radius shrinks with altitude."""
    s = VisionSensor(res=64, device=CPU)
    low = s.get_image(0, 0, 2, 0, 0, 0).numpy()
    high = s.get_image(0, 0, 8, 0, 0, 0).numpy()
    assert low.sum() > high.sum() > 0
    assert low[32, 32] == 1.0
    off = s.get_image(3, 0, 2, 0, 0, 0).numpy()
    assert off[32, 32] == 0.0 or off.sum() < low.sum()


def test_batched_images_match_single():
    s = VisionSensor(res=16, device=CPU)
    rng = np.random.default_rng(1)
    poses = np.zeros((6, 5))
    poses[0:2] = rng.uniform(-2, 2, (2, 5))
    poses[2] = rng.uniform(2, 8, 5)
    poses[3:6] = rng.uniform(-15, 15, (3, 5))
    batch = s.get_images(torch.from_numpy(poses)).numpy()
    assert batch.shape == (5, 16, 16)
    for i in range(5):
        np.testing.assert_array_equal(batch[i],
                                      s.get_image(*poses[:, i]).numpy())


@pytest.mark.parametrize('res,n', [(16, 4096), (64, 512)])
def test_images_and_homography_match_jax(res, n):
    """Random poses through both sensors: the homography within float32
    rtol 1e-5 (atol 1e-6 for the entries that cancel to near 0: the CPU's
    1-ULP sin/cos gap and XLA's FMAs change 8-9 % of the entries in the
    last bits), and every pixel equal (measured: 0 of 1,048,576 at res 16
    and of 2,097,152 at res 64 differ, so no boundary pixel flips)."""
    poses = _random_poses(n, res)
    s, js = VisionSensor(res=res, device=CPU), JVisionSensor(res=res)
    ours = s.get_images(torch.from_numpy(poses)).numpy()
    theirs = np.asarray(js.get_images(jnp.asarray(poses)))
    assert ours.any()
    np.testing.assert_array_equal(ours, theirs)

    h = s._warp_homography(*torch.from_numpy(poses[[5, 4, 3]]))
    h = np.stack([np.stack([m.numpy() for m in row]) for row in h])
    jh = jax.vmap(lambda p: js._warp_homography(p[5], p[4], p[3]),
                  in_axes=1)(jnp.asarray(poses))
    np.testing.assert_allclose(h, np.moveaxis(np.asarray(jh), 0, -1),
                               rtol=1e-5, atol=1e-6)


def test_degree_conversions_round_as_jax():
    """jnp.radians and jnp.degrees multiply by the constant rounded to
    float32; the sensor's multiply by the Python float does the same, bit
    for bit (torch.deg2rad would too, but the sensor does not rely on
    it)."""
    from gym_copter_tpu_torch.sensors.vision import DEG_PER_RAD, RAD_PER_DEG

    a = np.random.default_rng(3).uniform(-720, 720, 1 << 16)
    a = a.astype(np.float32)
    t = torch.from_numpy(a)
    np.testing.assert_array_equal((t * RAD_PER_DEG).numpy(),
                                  np.asarray(jnp.radians(a)))
    np.testing.assert_array_equal((t * DEG_PER_RAD).numpy(),
                                  np.asarray(jnp.degrees(a)))


def test_pose_from_state_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 64)).astype(np.float32)
    x[4, :8] = 0.0  # on the ground: the altitude clamps to 1e-6
    s, js = VisionSensor(res=16, device=CPU), JVisionSensor(res=16)
    np.testing.assert_array_equal(
        s.pose_from_state(torch.from_numpy(x)).numpy(),
        np.asarray(js.pose_from_state(jnp.asarray(x))))


def test_dvs_first_frame_zero_then_signed_diff():
    env = gt.make('Hover3D-v0', num_envs=3, seed=0, device=CPU)
    venv = VisualCopterEnv(env, dvs=True)
    state, obs = venv.reset()
    # motors off: the copter falls, the pad grows in view
    a = torch.zeros((4, 3))
    state, ts, ev0 = venv.step(state, a)
    assert not ev0.any()  # first call: zeros
    ev_any = 0.0
    for _ in range(120):
        state, ts, ev = venv.step(state, a)
        ev_any += float(ev.abs().sum())
    assert set(np.unique(ev.numpy())).issubset({-1.0, 0.0, 1.0})
    assert ev_any > 0


def test_visual_wrapper_shapes():
    env = gt.make('Lander3D-v0', num_envs=4, seed=0, device=CPU)
    venv = VisualCopterEnv(env)
    state, obs = venv.reset()
    state, ts, img = venv.step(state, torch.full((4, 4), 1.625e-2))
    assert img.shape == (4, 16, 16) and img.dtype == torch.float32
    assert set(np.unique(img.numpy())).issubset({0.0, 1.0})
    assert state.first.shape == () and not bool(state.first)


@pytest.mark.parametrize('dvs', [False, True])
def test_visual_env_matches_jax(dvs):
    """VisualCopterEnv over Lander3D at 64 envs x 200 float32 steps of
    the constant-thrust action beside the JAX package's: states within
    rtol 1e-5 / atol 1e-4 (the CPU sin/cos gap; measured 5.1e-7), and
    every image equal (measured: no pixel differs)."""
    env = gt.make('Lander3D-v0', num_envs=64, seed=0, device=CPU)
    jenv = gct.make('Lander3D-v0', num_envs=64, seed=0)
    venv, jvenv = VisualCopterEnv(env, dvs=dvs), JVisualCopterEnv(jenv,
                                                                  dvs=dvs)
    state, obs = venv.reset()
    jstate, jobs = jvenv.reset()
    a = torch.full((4, 64), 1.625e-2)
    ja = jnp.full((4, 64), 1.625e-2, jnp.float32)
    jstep = jax.jit(jvenv.step)
    lit = 0
    for t in range(200):
        state, ts, img = venv.step(state, a)
        jstate, jts, jimg = jstep(jstate, ja)
        np.testing.assert_array_equal(img.numpy(), np.asarray(jimg),
                                      err_msg=f'step {t}')
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(jts.x),
                                   rtol=1e-5, atol=1e-4)
        lit += int(img.abs().sum())
    assert lit > 0


def test_image_path_contains_no_linalg():
    """The batched image path is elementwise only: no linear-algebra
    operation (the 8x8 solve the closed form replaced serialized inside
    rollouts), and the pixel grid is not rebuilt once made."""
    seen = set()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(str(func))
            return func(*args, **(kwargs or {}))

    s = VisionSensor(res=16, device=CPU)
    poses = torch.zeros((6, 8))
    poses[2] = 5.0
    s.get_images(poses)  # builds the grid
    with Ops():
        s.get_images(poses)
    banned = ('linalg', 'solve', 'lu', 'inverse', 'triangular', 'arange')
    assert not [op for op in seen if any(b in op for b in banned)], seen
