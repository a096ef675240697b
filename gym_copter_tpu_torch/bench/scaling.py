"""Scaling harness of the port, the counterpart of `scripts/bench_scaling.py`.

    python -m gym_copter_tpu_torch.bench.scaling \\
        [--out docs/torch_bench_scaling.json]

Measures what one card and its host can show, in one JSON report:

  1. card_mesh_overhead: the sharded fused rollout
     (`parallel/sharding.sharded_fused_rollout`, its totals gathered) in a
     one-rank NCCL world against the unsharded `fused_rollout`, at 4096
     Lander3D envs, differential over T = 100,000 -> 1,100,000 steps, 8
     samples: the cost of the sharded path on one card, everything but
     the collectives between cards;
  2. cpu_weak_scaling: the step-by-step path (`scan_rollout`) on the CPU at
     1024 envs per rank, on 1 and then 2 gloo ranks of one thread each
     (`parallel/launch.spawn`), every timed run ending in a barrier,
     differential over T = 200 -> 1200 steps, 4 samples; per-rank
     throughput against one rank's;
  3. multiprocess_loopback: the launcher's two-host run over TCP on
     loopback (`parallel/launch.py --coordinator`, gloo on the CPU, 512
     envs per host, 5 updates, hidden 64 as the JAX launcher's default
     network) against its one-host run: per-process efficiency.

Each runs in its own subprocess, as in the JAX script.  One card cannot
show NCCL between cards (W > 1) or a network between hosts; the report
says so and estimates neither.  The JAX script's control experiment of two
independent processes (cpu_concurrent_independent) is not repeated.
Runs only where there is a card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from gym_copter_tpu_torch.bench import common
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.ops import fused_rollout as fr
from gym_copter_tpu_torch.utils import profiling

REPO = str(common.DOCS.parent)
B_CARD = 4096
T_LO_CARD, T_HI_CARD = 100_000, 1_100_000
MIN_MARGINAL_CARD = 0.05
B_PER_RANK_CPU = 1024
T_LO_CPU, T_HI_CPU = 200, 1200
THREADS_PER_RANK = 1
LOOPBACK = dict(envs_per_host=512, updates=5, hidden=64)
SUB_TIMEOUT_S = 1800
NOTE = ('One card: NCCL between cards (W > 1) and a network between hosts '
        'are not measured and not estimated.  card_mesh_overhead is the '
        'sharded path on one card; cpu_weak_scaling and '
        'multiprocess_loopback run on the host\'s CPU cores, which the '
        'ranks and processes share.')


def mode_card() -> dict:
    """Sub-measurement 1 (in its own process): sharded W = 1 NCCL against
    unsharded, on the card."""
    from gym_copter_tpu_torch.parallel import sharding

    device = resolve_device(None)
    params, spec, _, env_ids, state, action = common.lander_batch(B_CARD,
                                                                  device)
    with tempfile.TemporaryDirectory() as tmp:
        group, device = sharding.init_world('nccl', 0, 1,
                                            f'file://{tmp}/store',
                                            local_rank=0)
        try:
            shard = sharding.shard_env_state((state, action), 0, 1)

            def run_plain(n):
                _, tot = fr.fused_rollout(state, action, n, params, spec)
                return float(tot['reward_sum'][0])

            def sharded(n):
                _, tot = sharding.sharded_fused_rollout(
                    *shard, n, params, spec, seed=0, env_ids=env_ids)
                return sharding.gather_totals(tot, group)

            def run_sharded(n):
                return float(sharded(n)['reward_sum'][0])

            launches = fr.fused_rollout.launches
            # identical episode counts through both paths
            _, tp = fr.fused_rollout(state, action, 5000, params, spec)
            if not torch.equal(tp['episodes'], sharded(5000)['episodes']):
                raise AssertionError('sharded and unsharded episodes differ')
            plain = profiling.differential_steps_per_sec(
                run_plain, T_LO_CARD, T_HI_CARD, batch=B_CARD, reps=8,
                min_marginal_s=MIN_MARGINAL_CARD)
            shd = profiling.differential_steps_per_sec(
                run_sharded, T_LO_CARD, T_HI_CARD, batch=B_CARD, reps=8,
                min_marginal_s=MIN_MARGINAL_CARD)
            launches = fr.fused_rollout.launches - launches
        finally:
            dist.destroy_process_group()
    return {'envs': B_CARD, 'windows': [T_LO_CARD, T_HI_CARD],
            'plain_steps_per_sec': plain['steps_per_sec'],
            'plain_spread_pct': plain['spread_pct'],
            'sharded_1rank_steps_per_sec': shd['steps_per_sec'],
            'sharded_spread_pct': shd['spread_pct'],
            'efficiency': shd['steps_per_sec'] / plain['steps_per_sec'],
            'kernel_launches': launches,
            'card': common.card_record(device)}


def _cpu_rank(rank, world, group, device, envs_per_rank: int, t_lo: int,
              t_hi: int, reps: int) -> dict:
    """A rank of sub-measurement 2: its columns of the batch through
    `scan_rollout`, every run ending in a barrier, timed on rank 0's clock
    over the same calls on every rank."""
    from gym_copter_tpu_torch.parallel import sharding

    torch.set_num_threads(THREADS_PER_RANK)
    b = envs_per_rank * world
    lo, hi = sharding.env_columns(b, rank, world)
    params, spec, key, env_ids, state, action = common.lander_batch(b, device)
    state, action, ids = sharding.shard_env_state(
        (state, action, env_ids), rank, world)

    def timed(n):
        t0 = time.perf_counter()
        fr.scan_rollout(state, action, key, ids, n, params, spec)
        dist.barrier(group)
        return time.perf_counter() - t0

    timed(t_lo)
    samples = [b * (t_hi - t_lo) / (timed(t_hi) - timed(t_lo))
               for _ in range(reps)]
    stats = profiling.robust_stats(samples)
    return {'ranks': world, 'envs_per_rank': hi - lo,
            'threads_per_rank': THREADS_PER_RANK,
            'steps_per_sec': stats['median'],
            'per_rank': stats['median'] / world,
            'spread_pct': stats['spread_pct'], 'samples': samples}


def cpu_weak_scaling(ranks: int, envs_per_rank: int = B_PER_RANK_CPU,
                     t_lo: int = T_LO_CPU, t_hi: int = T_HI_CPU,
                     reps: int = 4, timeout_s: float = SUB_TIMEOUT_S) -> dict:
    """Sub-measurement 2 at `ranks` gloo ranks on the CPU: rank 0's
    record."""
    from gym_copter_tpu_torch.parallel import launch

    return launch.spawn(_cpu_rank, ranks, 'gloo', 'cpu',
                        (envs_per_rank, t_lo, t_hi, reps), timeout_s)[0]


def _sub(args: list) -> dict:
    """This module with `args` in a subprocess; its last stdout line."""
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    out = subprocess.run(
        [sys.executable, '-m', 'gym_copter_tpu_torch.bench.scaling'] + args,
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=SUB_TIMEOUT_S)
    if out.returncode != 0:
        raise RuntimeError(f'{args}: {out.stderr[-2000:]}')
    return json.loads(out.stdout.strip().splitlines()[-1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def multiprocess_loopback(envs_per_host: int, updates: int,
                          hidden: int) -> dict:
    """Sub-measurement 3: the launcher's one-host run, then its two-host
    run over loopback, gloo on the CPU."""
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for hosts in (1, 2):
            port = _free_port()
            out = os.path.join(tmp, f'hosts{hosts}.json')
            procs = []
            for pid in range(hosts):
                cmd = [sys.executable, '-m', 'gym_copter_tpu_torch.parallel.'
                       'launch', '--coordinator', f'localhost:{port}',
                       '--num-processes', str(hosts), '--process-id',
                       str(pid), '--backend', 'gloo', '--device', 'cpu',
                       '--envs-per-host', str(envs_per_host), '--updates',
                       str(updates), '--hidden', str(hidden)]
                if pid == 0:
                    cmd += ['--out', out]
                procs.append(subprocess.Popen(
                    cmd, env=env, cwd=REPO, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True))
            try:
                for p in procs:
                    _, err = p.communicate(timeout=SUB_TIMEOUT_S)
                    if p.returncode != 0:
                        raise RuntimeError(f'launcher, {hosts} host(s): '
                                           f'{err[-2000:]}')
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait(30)
            with open(out) as f:
                runs[hosts] = json.load(f)
    solo, duo = runs[1], runs[2]
    return {'one_process': solo, 'two_process': duo,
            'per_process_efficiency': (
                duo['env_steps_per_sec'] / duo['hosts'])
            / solo['env_steps_per_sec'],
            'note': ('two loopback host processes share the host\'s CPU '
                     'cores; the ratio holds that contention and the gloo '
                     'gradient all-reduce through the host')}


def orchestrate(out_path) -> dict:
    device = resolve_device(None)  # raises without a card
    report = {'card': common.card_record(device),
              'host_cpu_count': os.cpu_count(),
              'torch': torch.__version__, 'note': NOTE}
    report['card_mesh_overhead'] = _sub(['--mode', 'card'])
    cpu = [_sub(['--mode', 'cpu', '--ranks', str(n)]) for n in (1, 2)]
    for row in cpu:
        row['efficiency'] = row['per_rank'] / cpu[0]['per_rank']
    report['cpu_weak_scaling'] = cpu
    report['multiprocess_loopback'] = multiprocess_loopback(**LOOPBACK)
    report['card_after'] = common.card_record(device)
    common.write_json(out_path, report)
    print(json.dumps(report, indent=1))
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--mode', default=None, choices=(None, 'card', 'cpu'))
    p.add_argument('--ranks', type=int, default=1)
    p.add_argument('--out', default=str(common.DOCS
                                        / 'torch_bench_scaling.json'))
    args = p.parse_args(argv)
    if args.mode == 'card':
        print(json.dumps(mode_card()))
    elif args.mode == 'cpu':
        print(json.dumps(cpu_weak_scaling(args.ranks)))
    else:
        orchestrate(args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
