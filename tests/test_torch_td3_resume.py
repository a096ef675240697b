"""TD3 state checkpoint and resume on the port (gym_copter_tpu_torch/learn/
td3.py --state-checkpoint / --resume), the mirror of tests/
test_td3_resume.py: a killed run continues with its learner state, curve
and best-so-far intact, across a replay-buffer resize."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp, extra):
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    base = [sys.executable, '-m', 'gym_copter_tpu_torch.learn.td3',
            '--env', 'Lander1D-v0', '--device', 'cpu',
            '--start-steps', '40', '--eval-every', '40',
            '--eval-episodes', '1',
            '--state-checkpoint', os.path.join(tmp, 'state.pt')]
    r = subprocess.run(base + extra, env=env, capture_output=True,
                       text=True, timeout=420, cwd=REPO)
    assert r.returncode == 0, r.stderr[-1500:]
    return r


def test_resume_continues_curve_and_best(tmp_path):
    tmp = str(tmp_path)
    out1, out2 = os.path.join(tmp, 'a.json'), os.path.join(tmp, 'b.json')
    _run(tmp, ['--max-steps', '80', '--out', out1])
    leg1 = json.load(open(out1))
    assert [c['step'] for c in leg1['curve']] == [40, 80]

    # resume with a LARGER cap (resized buffer): the curve continues
    r = _run(tmp, ['--max-steps', '160', '--resume', '--out', out2])
    assert 'resumed from' in r.stdout
    leg2 = json.load(open(out2))
    assert [c['step'] for c in leg2['curve']] == [40, 80, 120, 160]
    for a, b in zip(leg1['curve'], leg2['curve'][:2]):
        assert a == b
