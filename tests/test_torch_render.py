"""The port's renderers (gym_copter_tpu_torch/render/, copies of the JAX
package's): the mirror of tests/test_render.py, headless RGB output."""

import matplotlib

matplotlib.use('Agg')

import numpy as np


def test_threed_frame_rgb():
    from gym_copter_tpu_torch.render.threed import ThreeDLanderRenderer
    r = ThreeDLanderRenderer()
    frame = r.frame((1.0, 2.0, -5.0, 0.1, -0.1, 0.3))
    assert frame.ndim == 3 and frame.shape[2] == 3
    assert frame.std() > 0  # something was drawn
    r.close()


def test_threed_target_dual_vehicle():
    """Dual-vehicle Target view (attic threed_target.py:11-24): chaser +
    circling-target artists animate together and export headlessly."""
    import tempfile
    from gym_copter_tpu_torch.render.threed import ThreeDTargetRenderer
    r = ThreeDTargetRenderer()
    t = np.linspace(0, 1, 8)
    poses = np.stack([t, -t, -5 + 0 * t, 0 * t, 0 * t, 0 * t], axis=1)
    target = np.stack([10 * np.cos(t), 10 * np.sin(t), -10 + 0 * t], axis=1)
    with tempfile.TemporaryDirectory() as d:
        r.play_pair(poses, target, outfile=f'{d}/target.gif', show=False,
                    stride=1)
    r.close()


def test_twod_render_rgb_and_prop_blink():
    from gym_copter_tpu_torch.render.twod import TwoDLanderRenderer
    r = TwoDLanderRenderer(target_radius=2.0, initial_random_x=1.0)
    frames = [r.render((0.0, 1.0, -5.0, 0.2), spinning=True)
              for _ in range(3)]
    assert frames[0].shape == (400, 600, 3)
    # spinning props alternate visibility -> frames differ over the cycle
    diffs = [np.abs(frames[i].astype(int) - frames[i + 1].astype(int)).sum()
             for i in range(2)]
    assert max(diffs) > 0
    r.close()


def test_twod_one_d_mode_zeroes_lateral():
    from gym_copter_tpu_torch.render.twod import TwoDLanderRenderer
    r = TwoDLanderRenderer(one_d=True)
    f1 = r.render((0.0, 3.0, -5.0, 0.4), spinning=False)
    r2 = TwoDLanderRenderer(one_d=True)
    f2 = r2.render((0.0, -3.0, -5.0, -0.4), spinning=False)
    np.testing.assert_array_equal(f1, f2)  # y & phi ignored in 1D
    r.close()
    r2.close()


def test_hud_renders_state():
    from gym_copter_tpu_torch.render.hud import HUD
    h = HUD()
    state = np.array([1, 0.5, -2, 0.1, -7.0, -0.8, 0.15, 0, -0.05, 0,
                      0.7, 0])
    frame = h.render(state, t=3.21)
    assert frame.shape[2] == 3
    assert frame.std() > 0
    h.close()
