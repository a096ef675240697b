"""TD3 state checkpoint and resume on the port (gym_copter_tpu_torch/learn/
td3.py --state-checkpoint / --resume), the mirror of tests/
test_td3_resume.py: a killed run continues with its learner state, curve
and best-so-far intact, across a replay-buffer resize.  On the port the
state save is atomic, and a resume whose --obs-norm disagrees with the
saved state is refused before anything is loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gym_copter_tpu_torch.learn import td3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp, extra, ok=True):
    env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    base = [sys.executable, '-m', 'gym_copter_tpu_torch.learn.td3',
            '--env', 'Lander1D-v0', '--device', 'cpu',
            '--start-steps', '40', '--eval-every', '40',
            '--eval-episodes', '1',
            '--state-checkpoint', os.path.join(tmp, 'state.pt')]
    r = subprocess.run(base + extra, env=env, capture_output=True,
                       text=True, timeout=420, cwd=REPO)
    assert (r.returncode == 0) == ok, r.stderr[-1500:]
    return r


@pytest.fixture(scope='module')
def first_leg(tmp_path_factory):
    """An 80-step run without --obs-norm: (its directory, its JSON)."""
    tmp = str(tmp_path_factory.mktemp('td3'))
    out = os.path.join(tmp, 'a.json')
    _run(tmp, ['--max-steps', '80', '--out', out])
    return tmp, json.load(open(out))


def test_resume_continues_curve_and_best(first_leg, tmp_path):
    tmp = str(tmp_path)
    shutil.copy(os.path.join(first_leg[0], 'state.pt'), tmp)
    leg1 = first_leg[1]
    assert [c['step'] for c in leg1['curve']] == [40, 80]

    # resume with a LARGER cap (resized buffer): the curve continues
    out2 = os.path.join(tmp, 'b.json')
    r = _run(tmp, ['--max-steps', '160', '--resume', '--out', out2])
    assert 'resumed from' in r.stdout
    leg2 = json.load(open(out2))
    assert [c['step'] for c in leg2['curve']] == [40, 80, 120, 160]
    for a, b in zip(leg1['curve'], leg2['curve'][:2]):
        assert a == b


def test_resume_refuses_a_state_of_the_other_obs_norm(first_leg, tmp_path):
    """--obs-norm against a raw-observation state file, and no --obs-norm
    against a file with normalizer statistics: both exit non-zero naming
    the flag, write no output and leave the file as it was."""
    tmp = str(tmp_path)
    state = os.path.join(tmp, 'state.pt')
    shutil.copy(os.path.join(first_leg[0], 'state.pt'), state)
    out = os.path.join(tmp, 'b.json')
    for flags in (['--obs-norm'], []):
        if not flags:
            ck = torch.load(state, weights_only=False)
            norm = td3.ObsNormalizer(ck['buffer']['s'].shape[1])
            norm.update(ck['buffer']['s'][0].astype('float64'))
            ck['norm'] = (norm.n, norm.mean, norm.m2)
            torch.save(ck, state)
        before = open(state, 'rb').read()
        r = _run(tmp, ['--max-steps', '160', '--resume', '--out', out]
                 + flags, ok=False)
        assert '--obs-norm is ' + ('on' if flags else 'off') in r.stderr
        assert ('holds no normalizer' if flags else
                'holds normalizer statistics') in r.stderr
        assert 'resumed from' not in r.stdout
        assert not os.path.exists(out)
        assert open(state, 'rb').read() == before


class _Unpicklable:
    def __reduce__(self):
        raise RuntimeError('cannot pickle this')


def test_failed_state_save_leaves_the_old_file_whole(tmp_path):
    """A save whose payload fails to pickle partway (after a tensor) leaves
    the earlier state file loadable and equal to what it was, and no
    temporary file beside it; a later save replaces it."""
    path = str(tmp_path / 'state.pt')
    old = {'step': 40, 'w': torch.arange(6.0)}
    td3.save_state_file(path, old)
    before = open(path, 'rb').read()
    with pytest.raises(RuntimeError, match='cannot pickle'):
        td3.save_state_file(path, {'step': 80, 'w': torch.ones(1000),
                                   'z': _Unpicklable()})
    assert open(path, 'rb').read() == before
    assert os.listdir(tmp_path) == ['state.pt']
    got = torch.load(path, weights_only=False)
    assert got['step'] == 40 and torch.equal(got['w'], old['w'])
    td3.save_state_file(path, {'step': 80})
    assert torch.load(path, weights_only=False) == {'step': 80}
    assert os.listdir(tmp_path) == ['state.pt']
