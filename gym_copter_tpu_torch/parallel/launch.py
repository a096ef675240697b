"""Run the port on several ranks: the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip` and `scripts/launch_multihost.py`.

    python -m gym_copter_tpu_torch.parallel.launch --nproc N \\
        --backend {nccl,gloo} --device {cuda,cpu} [--envs-per-rank 128] \\
        [--updates 2] [--out report.json]

spawns N ranks on this host (rank r on `cuda:<r % cards>`, or the CPU),
joined through a file store in a temporary directory.  Together they run
sharded PPO train steps at the recorded recipe (Hover3D-v0) and the sharded
fused rollout of Lander3D-v0 with 24-step episodes, so that every shard
completes episodes; they check each shard's accounting, that the gathered
rollout totals equal the one-rank layout's bit for bit, and that every rank
ends with the same parameters; and rank 0 prints `launch_multihost.py`'s
report as one JSON line.  NCCL steps run as CUDA graphs, gloo steps
eagerly (a graph cannot capture gloo's collectives).  NCCL needs a card
per rank.

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


def _rank_main(fn, rank, world, backend, device, store, out, args,
               timeout_s):
    """One rank: join the world, run fn, save its result to `out` (or the
    traceback to `out`.err), leave the world."""
    try:
        if device == 'cpu':
            # the ranks share this host's cores
            torch.set_num_threads(1)
        group, dev = sharding.init_world(
            backend, rank, world, store,
            device='cpu' if device == 'cpu' else None, timeout_s=timeout_s)
        torch.save(fn(rank, world, group, dev, *args), out)
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nproc: int, backend: str, device: str, args=(),
          timeout_s: float = 600.0) -> list:
    """`fn(rank, world, group, device, *args)` on `nproc` spawned ranks;
    returns their results by rank.  `fn` must be importable (a module-level
    function).  Raises if a rank fails, with its traceback, or if the world
    outlives `timeout_s`; no rank outlives the call."""
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory() as tmp:
        store = 'file://' + os.path.join(tmp, 'store')
        outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(nproc)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, nproc, backend, device, store, outs[r], tuple(args),
            timeout_s)) for r in range(nproc)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            if any(p.is_alive() for p in procs):
                raise TimeoutError(f'{nproc} ranks still running after '
                                   f'{timeout_s} s')
            errors = [open(o + '.err').read() for o in outs
                      if os.path.exists(o + '.err')]
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed or errors:
                raise RuntimeError(f'ranks {failed} failed:\n'
                                   + '\n'.join(errors))
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
           ppo_kw: dict) -> dict:
    """A rank of the launcher's run (see the module docstring); returns the
    report on rank 0, this rank's device name elsewhere."""
    from gym_copter_tpu_torch.control.heuristics import hover_motor_value
    from gym_copter_tpu_torch.core import prng, vehicles
    from gym_copter_tpu_torch.core.types import EnvParams
    from gym_copter_tpu_torch.envs import base, tasks
    from gym_copter_tpu_torch.learn import ppo
    from gym_copter_tpu_torch.ops.fused_rollout import fused_rollout

    graphed = dist.get_backend(group) == 'nccl'
    num_envs = envs_per_rank * world
    lo, hi = sharding.env_columns(num_envs, rank, world)
    ids = torch.arange(lo, hi, dtype=torch.int32, device=device)

    # sharded PPO train steps
    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    cfg = ppo.PPOConfig(**ppo_kw)
    step, opt = ppo.make_train_step(params, tasks.HOVER_3D, cfg,
                                    prng.PRNGKey(0, device), ids,
                                    group=group)
    ts = ppo.init_train_state(prng.PRNGKey(2, device), params,
                              tasks.HOVER_3D, cfg, hi - lo, opt,
                              env_id_offset=lo)
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
    fparams = params._replace(task=params.task._replace(
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
    dist.all_gather_object(shards, dict(shard, device=str(device)),
                           group=group)
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
        'devices': len({s['device'] for s in shards}),
        'backend': dist.get_backend(group),
        'graphed': graphed,
        'global_envs': num_envs,
        'updates': updates,
        'update_idx': int(ts.update_idx),
        'reward_per_step': float(metrics['reward_per_step']),
        'step_s': step_s,
        'env_steps_per_sec': num_envs * cfg.rollout_steps / step_s,
        'params_equal_across_ranks': params_equal,
        'allreduce_ms': statistics.median(reduce_ms),
        'allreduce_bytes': flat.numel() * flat.element_size(),
        'per_shard': shards,
        'totals_equal_one_rank': True,
        'episodes_per_env': float(gathered['episodes'].float().mean()),
    }


def run(nproc: int, backend: str, device: str, envs_per_rank: int = 128,
        updates: int = 2, ppo_kw: dict = None,
        timeout_s: float = 600.0) -> dict:
    """The launcher's run on `nproc` ranks; returns rank 0's report."""
    if device == 'cuda':
        # one build in this process, not one per rank
        from gym_copter_tpu_torch.ops import _build
        _build.build_all()
    return spawn(dryrun, nproc, backend, device,
                 (envs_per_rank, updates, dict(ppo_kw or RECIPE)),
                 timeout_s)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--nproc', type=int, default=1)
    ap.add_argument('--backend', choices=('nccl', 'gloo'), default='nccl')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--envs-per-rank', type=int, default=128)
    ap.add_argument('--updates', type=int, default=2)
    ap.add_argument('--out', default=None,
                    help='also write the report to this JSON file')
    args = ap.parse_args(argv)
    report = run(args.nproc, args.backend, args.device, args.envs_per_rank,
                 args.updates)
    print('[launch] ' + json.dumps(report), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
