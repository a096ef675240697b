"""The port's demo entry points, headless on the CPU: the mirror of
tests/test_demos.py on `python -m gym_copter_tpu_torch.demos.*` and the
ported velhold example, plus the port's `--save` CSV against the JAX
demo's (lander_demo.py) and read by utils/copter_plot.py."""

import csv
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    env.pop('XLA_FLAGS', None)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    return env


def _run(module, *args, timeout=600):
    r = subprocess.run(
        [sys.executable, '-m', f'gym_copter_tpu_torch.{module}',
         '--device', 'cpu', *args],
        env=_env(), capture_output=True, text=True, timeout=timeout,
        cwd=REPO)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    return r.stdout


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], dtype=np.float64)


def test_lander_demo_freeze():
    out = _run('demos.lander', '--nodisplay', '--freeze', '2,1,8,10,0')
    assert 'frozen pose' in out


def test_lander_demo_vision_and_csv_match_jax(tmp_path):
    """The port's CSV has the JAX demo's columns and rows, every value
    within float32 tolerance (both print 6 decimals), and
    utils/copter_plot.py draws it."""
    ours = str(tmp_path / 'torch.csv')
    out = _run('demos.lander', '--nodisplay', '--vision', '--res', '16',
               '--save', ours)
    assert 'vision:' in out and os.path.exists(ours)

    theirs = str(tmp_path / 'jax.csv')
    env = _env()
    env['GCT_PLATFORM'] = 'cpu'
    r = subprocess.run([sys.executable, os.path.join(REPO, 'lander_demo.py'),
                        '--nodisplay', '--save', theirs],
                       env=env, capture_output=True, text=True, timeout=600,
                       cwd=REPO)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    head, vals = _read_csv(ours)
    jhead, jvals = _read_csv(theirs)
    assert head == jhead and vals.shape == jvals.shape
    np.testing.assert_allclose(vals, jvals, rtol=1e-5, atol=2e-6)

    png = str(tmp_path / 'x.png')
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, 'utils', 'copter_plot.py'), ours,
                        '--save', png],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert os.path.getsize(png) > 0


def test_lander_demo_dvs():
    out = _run('demos.lander', '--nodisplay', '--dvs', '--res', '16')
    assert 'DVS:' in out and 'events' in out


def test_hover_demo():
    out = _run('demos.hover', '--nodisplay', '--steps', '120')
    assert 'total_reward' in out


def test_target_demo():
    out = _run('demos.target', '--nodisplay', '--steps', '120')
    assert 'target at' in out


def test_velhold_example(tmp_path):
    """Constant-climb-rate dynamics check (attic/velhold.py analogue): the
    velocity PI holds the climb-rate setpoint."""
    png = str(tmp_path / 'velhold.png')
    out = _run('examples.velhold', '--duration', '10', '--save', png)
    assert os.path.exists(png)
    rate = float(out.split('mean climb rate (2nd half) = ')[1].split()[0])
    assert 0.7 < rate < 1.3, out
