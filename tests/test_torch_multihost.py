"""The port's multi-host launcher (`python -m
gym_copter_tpu_torch.parallel.launch --coordinator ...`), the mirror of
tests/test_multihost.py: real host processes joined over a TCP rendezvous
on loopback (gloo on the CPU, the code path that several machines run over
their network), held to a one-process world on the same global batch;
and a failing or stranded host ends with a non-zero exit."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gym_copter_tpu_torch.parallel import launch, sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fused rollout's plain version needs a multiple of 128 envs per rank
ENVS_PER_HOST = 128
UPDATES = 2
SMALL = ['--env', 'Lander3D-v0', '--hidden', '8', '--rollout-steps', '16',
         '--updates', str(UPDATES), '--device', 'cpu', '--backend', 'gloo']
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start(num_processes, port, envs_per_host, out, extra=(), pids=None):
    """The host processes `pids` (default all) of a world."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    procs = []
    for pid in range(num_processes) if pids is None else pids:
        cmd = [sys.executable, '-m', 'gym_copter_tpu_torch.parallel.launch',
               '--coordinator', f'127.0.0.1:{port}',
               '--num-processes', str(num_processes),
               '--process-id', str(pid),
               '--envs-per-host', str(envs_per_host),
               '--timeout', str(TIMEOUT_S), *SMALL, *extra]
        if pid == 0:
            cmd += ['--out', str(out)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs):
    """(exit codes, outputs); a process that outlives its limit is
    killed."""
    rcs, outs = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S + 60)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        rcs.append(p.returncode)
        outs.append(out)
    return rcs, outs


def _in_use(outs) -> bool:
    return any('EADDRINUSE' in o or 'ddress already in use' in o
               for o in outs)


def _worlds(tmp_path, layouts):
    """Run the worlds of `layouts` ((num_processes, envs_per_host) pairs)
    at once, each on its own port; a world whose port was taken between
    the probe and the bind is run again once, on another.  Returns the
    reports of process 0."""
    reports = [None] * len(layouts)
    todo = list(range(len(layouts)))
    for attempt in range(2):
        started = {i: _start(layouts[i][0], _free_port(), layouts[i][1],
                             tmp_path / f'world{i}.json') for i in todo}
        retry = []
        for i, procs in started.items():
            rcs, outs = _finish(procs)
            if any(rcs) and attempt == 0 and _in_use(outs):
                retry.append(i)
                continue
            assert rcs == [0] * len(procs), '\n'.join(o[-3000:]
                                                      for o in outs)
            assert '[multihost] ' in outs[0]
            with open(tmp_path / f'world{i}.json') as f:
                reports[i] = json.load(f)
        todo = retry
        if not todo:
            break
    return reports


def test_two_hosts_match_one_host(tmp_path):
    """Two host processes of 128 envs each against one process of 256:
    the counts exact, every shard stepped and completed episodes on its
    own host, and the last update's metrics to rtol 1e-4, as the gloo
    worlds of tests/test_torch_sharding.py hold W = 2 to W = 1."""
    two, one = _worlds(tmp_path, [(2, ENVS_PER_HOST),
                                  (1, 2 * ENVS_PER_HOST)])
    for report, hosts in ((two, 2), (one, 1)):
        assert report['hosts'] == report['processes'] == hosts
        assert report['ranks'] == report['devices'] == hosts
        assert report['global_envs'] == 2 * ENVS_PER_HOST
        assert report['update_idx'] == report['updates'] == UPDATES
        assert report['totals_equal_one_rank']
        assert report['params_equal_across_ranks']
        assert not report['graphed'] and report['backend'] == 'gloo'
        assert report['env_steps_per_sec'] > 0
    assert [s['host'] for s in two['per_shard']] == [0, 1]
    for shard in two['per_shard']:
        assert shard['envs'] == ENVS_PER_HOST
        assert shard['episodes'] >= ENVS_PER_HOST
    np.testing.assert_allclose(two['reward_per_step'],
                               one['reward_per_step'], rtol=1e-4)
    for k, v in one['metrics'].items():
        np.testing.assert_allclose(two['metrics'][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize('fault', ['failing_rank', 'missing_host'])
def test_a_broken_world_ends_the_host(tmp_path, fault):
    """Host 1's rank raises (an unknown env) while host 0's waits for it
    in a collective: both hosts end at once with a non-zero exit, host 1
    with the traceback.  A host whose partner never comes ends non-zero at
    its timeout.  Neither prints a report."""
    port = _free_port()
    out = tmp_path / 'r.json'
    if fault == 'failing_rank':
        procs = (_start(2, port, ENVS_PER_HOST, out, pids=[0])
                 + _start(2, port, ENVS_PER_HOST, out,
                          ['--env', 'NoSuchEnv-v0'], pids=[1]))
    else:
        procs = _start(2, port, ENVS_PER_HOST, out, ['--timeout', '5'],
                       pids=[1])
    rcs, outs = _finish(procs)
    assert all(rc != 0 for rc in rcs), outs
    assert all('Error' in o and '[multihost] ' not in o for o in outs)
    if fault == 'failing_rank':
        assert 'NoSuchEnv-v0' in outs[1]


def test_global_rank_and_local_card():
    """Host I of N, with K ranks, runs global ranks I*K .. I*K + K - 1 on
    its cards 0 .. K - 1, and they hold the host's envs in global order;
    init_world needs the card or the local rank."""
    n, k, envs_per_host = 3, 2, 8
    ranks = [[launch.rank_of(i, local, k) for local in range(k)]
             for i in range(n)]
    assert ranks == [[0, 1], [2, 3], [4, 5]]
    for i in range(n):
        cols = [sharding.env_columns(n * envs_per_host, r, n * k)
                for r in ranks[i]]
        assert cols[0][0] == i * envs_per_host
        assert cols[-1][1] == (i + 1) * envs_per_host
        assert all(hi - lo == envs_per_host // k for lo, hi in cols)
    with pytest.raises(ValueError):
        launch.rank_of(0, k, k)
    with pytest.raises(ValueError, match='local rank'):
        sharding.init_world('gloo', 0, 1, 'file:///nonexistent')
