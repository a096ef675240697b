"""Run the port on several ranks, on one host or several: the counterpart
of the JAX package's `__graft_entry__.dryrun_multichip` and
`scripts/launch_multihost.py`.

On one host:

    python -m gym_copter_tpu_torch.parallel.launch --nproc N \\
        --backend {nccl,gloo} --device {cuda,cpu} [--envs-per-rank 128] \\
        [--updates 2] [--env Hover3D-v0] [--seed 0] [--out report.json]

spawns N ranks on this host (local rank i on card i modulo the host's
cards, or the CPU),
joined through a file store in a temporary directory, and prints rank 0's
report after `[launch] `.  On several hosts, one command per host, with
`launch_multihost.py`'s flags and meanings:

    python -m gym_copter_tpu_torch.parallel.launch \\
        --coordinator HOST0:PORT --num-processes N --process-id I \\
        [--nproc-per-node K] [--envs-per-host 1024] [--updates 2] \\
        [--env Hover3D-v0] [--seed 0] [--out report.json] \\
        [--backend nccl] [--device cuda]

Host process I spawns its K ranks (K defaults to the host's card count, 1
on the CPU): global rank I·K + i on the host's card i (modulo its cards,
so that gloo ranks may share one), holding the global env
columns of that rank, so that each host's envs are split over its ranks.
The world of N·K ranks joins at tcp://HOST0:PORT, where global rank 0
(process 0's first rank) hosts the store; process 0 prints the report
after `[multihost] ` and writes it to --out.

Together the ranks run sharded PPO train steps at the recorded recipe
(--env; params from PRNGKey(seed), auto-resets keyed by PRNGKey(seed + 1),
as `train` and the JAX launcher key them) and the sharded fused rollout of
Lander3D-v0 with 24-step episodes, so that every shard completes episodes;
they check each shard's accounting, that the gathered rollout totals equal
the one-rank layout's bit for bit, and that every rank ends with the same
parameters.  Per-env randomness is keyed by the global env id, so N hosts
reproduce one host's run on the same global batch.  NCCL steps run as CUDA
graphs, gloo steps eagerly (a graph cannot capture gloo's collectives).
NCCL needs a card per rank.

The report carries every key of `launch_multihost.py`'s: `processes`
counts the OS processes that joined the world, one per rank as in JAX one
per process (`ranks` says the same), `hosts` counts the host processes
(--num-processes; 1 without --coordinator), and `devices` the distinct
(host, device) pairs.  A rank that fails, or a world that outlives its
timeout, ends every rank of the host and the host process with a non-zero
exit.

`spawn` is the multi-rank runner under it, which the tests use as well.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
from multiprocessing import connection

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gym_copter_tpu_torch.parallel import sharding

# the recipe of the recorded 4096-env curves (scripts/train_curve.py's
# defaults); minibatches and shuffle_block resolve from the global batch
RECIPE = dict(rollout_steps=128, hidden=128, epochs=4, learning_rate=3e-4,
              gamma=0.995, entropy_coef=0.01, value_clip=0.0,
              target_kl=0.015, anneal_lr_floor=0.0)
ROLLOUT_STEPS = 64
EPISODE_STEPS = 24


def _rank_main(fn, rank, local_rank, world, backend, device, init_method,
               out, args, timeout_s):
    """One rank: join the world, run fn, save its result to `out` (or the
    traceback to `out`.err), leave the world."""
    try:
        if device == 'cpu':
            # the ranks share this host's cores
            torch.set_num_threads(1)
        group, dev = sharding.init_world(
            backend, rank, world, init_method,
            device='cpu' if device == 'cpu' else None, timeout_s=timeout_s,
            local_rank=local_rank)
        torch.save(fn(rank, world, group, dev, *args), out)
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rank_of(process_id: int, local_rank: int, nproc_per_node: int) -> int:
    """The global rank of local rank `local_rank` of host process
    `process_id`, each host running `nproc_per_node` ranks."""
    if not 0 <= local_rank < nproc_per_node:
        raise ValueError(f'local rank {local_rank} outside the host\'s '
                         f'{nproc_per_node} ranks')
    return process_id * nproc_per_node + local_rank


def _wait(procs, outs, timeout_s: float):
    """Wait for every rank; raise at the first that fails, with the
    tracebacks written so far, or once the world outlives `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    running = list(procs)
    while running:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f'{len(running)} of {len(procs)} ranks still '
                               f'running after {timeout_s} s')
        connection.wait([p.sentinel for p in running], left)
        for p in [p for p in running if not p.is_alive()]:
            p.join()
            running.remove(p)
            if p.exitcode != 0:
                errors = []
                for o in outs:
                    if os.path.exists(o + '.err'):
                        with open(o + '.err') as f:
                            errors.append(f.read())
                raise RuntimeError(
                    f'rank {procs.index(p)} of this host failed (exit '
                    f'{p.exitcode}):\n' + '\n'.join(errors))


def spawn(fn, nproc: int, backend: str, device: str, args=(),
          timeout_s: float = 600.0, *, init_method: str = None,
          world: int = None, first_rank: int = 0) -> list:
    """`fn(rank, world, group, device, *args)` on `nproc` ranks spawned on
    this host, local rank i being global rank first_rank + i of a world of
    `world` ranks (default nproc) on this host's card i modulo its cards
    (or the CPU), joined
    through `init_method` (default a file store in a temporary directory);
    returns this host's results by local rank.  `fn` must be importable (a
    module-level function).  Raises as soon as a rank fails, with its
    traceback, or if the world outlives `timeout_s`; no rank outlives the
    call."""
    ctx = mp.get_context('spawn')
    world = nproc if world is None else world
    with tempfile.TemporaryDirectory() as tmp:
        init_method = init_method or 'file://' + os.path.join(tmp, 'store')
        outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(nproc)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, first_rank + r, r, world, backend, device, init_method,
            outs[r], tuple(args), timeout_s)) for r in range(nproc)]
        try:
            for p in procs:
                p.start()
            _wait(procs, outs, timeout_s)
            # written by the ranks above, in this call's own directory
            return [torch.load(o, weights_only=False) for o in outs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)


def _flat_params(ts) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in ts.params.leaves()])


def dryrun(rank, world, group, device, envs_per_rank: int, updates: int,
           ppo_kw: dict, env_name: str = 'Hover3D-v0', seed: int = 0,
           host: int = 0) -> dict:
    """A rank of the launcher's run (see the module docstring) on host
    process `host`; returns the report on rank 0, this rank's device name
    elsewhere."""
    from gym_copter_tpu_torch.control.heuristics import hover_motor_value
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.envs import base, tasks
    from gym_copter_tpu_torch.envs.registry import (default_params,
                                                     resolve_params)
    from gym_copter_tpu_torch.learn import ppo
    from gym_copter_tpu_torch.ops.fused_rollout import fused_rollout

    graphed = dist.get_backend(group) == 'nccl'
    num_envs = envs_per_rank * world
    lo, hi = sharding.env_columns(num_envs, rank, world)
    ids = torch.arange(lo, hi, dtype=torch.int32, device=device)

    # sharded PPO train steps, keyed as train() keys them
    spec, params = resolve_params(env_name)
    cfg = ppo.PPOConfig(**ppo_kw)
    step, opt = ppo.make_train_step(params, spec, cfg,
                                    prng.PRNGKey(seed + 1, device), ids,
                                    group=group)
    ts = ppo.init_train_state(prng.PRNGKey(seed, device), params, spec, cfg,
                              hi - lo, opt, env_id_offset=lo)
    ts = ts._replace(params=sharding.replicate(ts.params, group),
                     opt_state=sharding.replicate(ts.opt_state, group))
    times = []
    for _ in range(updates):
        t0 = time.perf_counter()
        ts, metrics = step.run(ts, graphed)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
    if bad or int(ts.update_idx) != updates:
        raise AssertionError(f'rank {rank}: metrics {bad} not finite or '
                             f'update_idx {int(ts.update_idx)}')
    flat = _flat_params(ts)
    every = sharding.gather_columns(flat[None], group).view(world, -1)
    params_equal = all(torch.equal(every[r], flat) for r in range(world))
    if not params_equal:
        raise AssertionError('ranks hold different parameters')
    reduce_ms = []
    probe = torch.zeros_like(flat)
    for _ in range(20):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dist.all_reduce(probe, group=group)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    # the sharded fused rollout, 24-step episodes with random resets
    spec = tasks.LANDER_3D
    fparams = default_params()
    fparams = fparams._replace(task=fparams.task._replace(
        max_steps=EPISODE_STEPS))
    key = prng.PRNGKey(0, device)

    def reset(env_ids):
        return base.reset(key, env_ids, torch.zeros_like(env_ids), fparams,
                          spec, dtype=torch.float32)[0]

    action = torch.full((spec.action_size, hi - lo),
                        float(hover_motor_value(fparams)), device=device)
    fused_rollout.launches = 0
    final, totals = sharding.sharded_fused_rollout(
        reset(ids), action, ROLLOUT_STEPS, fparams, spec, seed=0,
        env_ids=ids)
    shard = {'envs': int(final.steps.numel()),
             'total_steps': int(final.steps.sum()),
             'episodes': int(totals['episodes'].sum()),
             'launches': fused_rollout.launches}
    if shard['envs'] != envs_per_rank or int(final.steps.min()) < 1 \
            or shard['episodes'] < 1:
        raise AssertionError(f'rank {rank}: shard {shard}')
    gathered = sharding.gather_totals(totals, group)
    shards = [None] * world
    dist.all_gather_object(shards, dict(shard, host=host,
                                        device=str(device)), group=group)
    if rank != 0:
        return str(device)

    all_ids = torch.arange(num_envs, dtype=torch.int32, device=device)
    _, one_rank = fused_rollout(
        reset(all_ids), torch.full((spec.action_size, num_envs),
                                   float(hover_motor_value(fparams)),
                                   device=device),
        ROLLOUT_STEPS, fparams, spec, seed=0, env_ids=all_ids)
    for k in ('episodes', 'reward_sum'):
        if not torch.equal(gathered[k], one_rank[k]):
            raise AssertionError(f'sharded {k} differ from the one-rank '
                                 f'layout')
    timed = times[1:] or times
    step_s = statistics.median(timed)
    return {
        'processes': world,
        'ranks': world,
        'hosts': len({s['host'] for s in shards}),
        'devices': len({(s['host'], s['device']) for s in shards}),
        'env': env_name,
        'seed': seed,
        'backend': dist.get_backend(group),
        'graphed': graphed,
        'global_envs': num_envs,
        'updates': updates,
        'update_idx': int(ts.update_idx),
        'reward_per_step': float(metrics['reward_per_step']),
        'metrics': {k: float(v) for k, v in metrics.items()},
        'step_s': step_s,
        'env_steps_per_sec': num_envs * cfg.rollout_steps / step_s,
        'params_equal_across_ranks': params_equal,
        'allreduce_ms': statistics.median(reduce_ms),
        'allreduce_bytes': flat.numel() * flat.element_size(),
        'per_shard': shards,
        'totals_equal_one_rank': True,
        'episodes_per_env': float(gathered['episodes'].float().mean()),
    }


def _ppo_kw(ppo_kw: dict = None, **overrides) -> dict:
    return dict(ppo_kw or RECIPE, **{k: v for k, v in overrides.items()
                                     if v is not None})


def _build_kernels(device: str):
    if device == 'cuda':
        # one build in this process, not one per rank
        from gym_copter_tpu_torch.ops import _build
        _build.build_all()


def run(nproc: int, backend: str, device: str, envs_per_rank: int = 128,
        updates: int = 2, ppo_kw: dict = None, timeout_s: float = 600.0,
        env_name: str = 'Hover3D-v0', seed: int = 0) -> dict:
    """The launcher's run on `nproc` ranks of this host; returns rank 0's
    report."""
    _build_kernels(device)
    return spawn(dryrun, nproc, backend, device,
                 (envs_per_rank, updates, _ppo_kw(ppo_kw), env_name, seed),
                 timeout_s)[0]


def run_host(coordinator: str, num_processes: int, process_id: int,
             nproc_per_node: int, backend: str, device: str,
             envs_per_host: int = 1024, updates: int = 2,
             ppo_kw: dict = None, env_name: str = 'Hover3D-v0',
             seed: int = 0, timeout_s: float = 600.0):
    """This host's part of the launcher's run over `num_processes` hosts
    joined at `coordinator` (HOST:PORT): its `nproc_per_node` ranks, each
    holding envs_per_host / nproc_per_node envs.  Returns the report on
    process 0, None elsewhere."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f'process id {process_id} outside the '
                         f'{num_processes} processes')
    if envs_per_host % nproc_per_node != 0:
        raise ValueError(f'{envs_per_host} envs per host do not split over '
                         f'{nproc_per_node} ranks')
    _build_kernels(device)
    results = spawn(
        dryrun, nproc_per_node, backend, device,
        (envs_per_host // nproc_per_node, updates, _ppo_kw(ppo_kw),
         env_name, seed, process_id), timeout_s,
        init_method=f'tcp://{coordinator}',
        world=num_processes * nproc_per_node,
        first_rank=rank_of(process_id, 0, nproc_per_node))
    return results[0] if process_id == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--nproc', type=int, default=1,
                    help='ranks on this host, without --coordinator')
    ap.add_argument('--backend', choices=('nccl', 'gloo'), default='nccl')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--envs-per-rank', type=int, default=128,
                    help='without --coordinator')
    ap.add_argument('--coordinator', default=None,
                    help='HOST:PORT of process 0 (required for N > 1)')
    ap.add_argument('--num-processes', type=int, default=1,
                    help='host processes, one per host')
    ap.add_argument('--process-id', type=int, default=0)
    ap.add_argument('--nproc-per-node', type=int, default=None,
                    help='ranks on this host (default: its card count; 1 '
                         'on the CPU)')
    ap.add_argument('--envs-per-host', type=int, default=1024)
    ap.add_argument('--env', default='Hover3D-v0')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--updates', type=int, default=2)
    ap.add_argument('--hidden', type=int, default=None,
                    help='override the recipe\'s hidden width')
    ap.add_argument('--rollout-steps', type=int, default=None,
                    help='override the recipe\'s rollout length')
    ap.add_argument('--timeout', type=float, default=600.0,
                    help='seconds the world may take, and any collective')
    ap.add_argument('--out', default=None,
                    help='(process 0) also write the report to this JSON '
                         'file')
    args = ap.parse_args(argv)
    ppo_kw = _ppo_kw(hidden=args.hidden, rollout_steps=args.rollout_steps)
    if args.coordinator is None:
        if args.num_processes != 1:
            ap.error('--num-processes > 1 needs --coordinator')
        tag = 'launch'
        report = run(args.nproc, args.backend, args.device,
                     args.envs_per_rank, args.updates, ppo_kw, args.timeout,
                     args.env, args.seed)
    else:
        tag = 'multihost'
        k = args.nproc_per_node
        if k is None:
            k = torch.cuda.device_count() if args.device == 'cuda' else 1
        report = run_host(args.coordinator, args.num_processes,
                          args.process_id, k, args.backend, args.device,
                          args.envs_per_host, args.updates, ppo_kw,
                          args.env, args.seed, args.timeout)
    if report is not None:
        print(f'[{tag}] ' + json.dumps(report), flush=True)
        if args.out:
            with open(args.out, 'w') as f:
                json.dump(report, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
