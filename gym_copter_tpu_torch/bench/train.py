"""Training-path benchmark of the port on the card, the counterpart of
`scripts/bench_train.py`.

    python -m gym_copter_tpu_torch.bench.train \\
        [--out docs/torch_bench_train.json]

Measures, at 4096 Lander3D envs, rollout 128, hidden 128, the network of
`ppo.init_params(PRNGKey(2))` (JAX's own initial parameters):

  * the exploration rollout alone: 128 steps of `envs/base.step` under the
    policy's action hover * (1 + a), a one-step CUDA graph replayed, as the
    train step's rollout runs (`common.PolicyRollout`);
  * the end-to-end graphed PPO train step (rollout, GAE, 4 epochs of
    minibatch steps) at minibatches = 4 with the block shuffle, at the
    production recipe (minibatches resolved to 16), and at minibatches = 4
    with the element shuffle (shuffle_block = 1): seconds per update,
    updates/s, env-steps/s;
  * block_vs_element_speedup and rollout_share_of_update.

Each config first runs back to back, at least 10 and at most 120 s, until
the card's µs per graph node is back within 15 % of its floor (read before
any capture; `common.warm_up`, the series recorded): after a capture it
can stay ~30 % high for seconds to a minute, with the SM clock unchanged
(PERF.md, Findings).  Timing is then the JAX script's per-call differential
(`profiling.timeit`: one warm call of 2, then 8 reps of 13 minus 3 calls,
each ending in a host read, the median).  Beside each rep the card's SM
clock, power draw, temperature and throttle reasons are sampled
(`profiling.card_probe`, started before the rep, read after it) with its
µs per graph node (`profiling.NodeLatency`); each train-step record also
holds, over 5 steps, the device ms of its phases by CUDA events and the
host ms of their calls, with the host's enqueue exposed and hidden behind
a spin kernel (`phase_ms`).

The JAX script's `speedup_vs_r3_baseline` is not computed: its baseline
is a time taken on a TPU.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from gym_copter_tpu_torch.bench import common
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.learn import ppo

B = 4096
ROLLOUT = 128
HIDDEN = 128
PHASE_STEPS = 5
# a spin of ~0.6 s at the H100's 1.98 GHz boost clock, longer than a
# step's host enqueue
HIDE_HOST_CYCLES = 1_200_000_000


def phase_ms(step: ppo.TrainStep, ts: ppo.TrainState, reps: int,
             state: common.CardState, hide_host_cycles: int = 0) -> dict:
    """The phases (rollout, GAE, update) of `reps` graphed steps from `ts`,
    as `TrainStep.run` runs them: median device ms of each by CUDA events
    and median host ms from its call to its return, with the samples.
    With `hide_host_cycles`, a spin kernel of that many cycles is queued
    before each step, so that the host enqueues while the card is busy and
    the events time the card alone, as far as the enqueue ends inside the
    spin (a phase whose host time exceeds its device time exposed is
    host-bound); and the card's µs per graph node after each step."""
    leaves = ts.params.leaves()
    device, host, nodes = [], [], []
    for _ in range(reps):
        if hide_host_cycles:
            torch.cuda._sleep(hide_host_cycles)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        times = []

        def mark(i, t0):
            if t0 is not None:
                times.append((time.perf_counter() - t0) * 1e3)
            events[i].record()
            return time.perf_counter()

        t0 = mark(0, None)
        env_state, obs, key, traj = step._graphed_rollout(
            leaves, ts.env_state, ts.obs, ts.key)
        t0 = mark(1, t0)
        flat, _ = step.gae_graph(leaves, traj, obs)
        t0 = mark(2, t0)
        step.update_graph(leaves, ts.opt_state, key, flat)
        mark(3, t0)
        events[3].synchronize()
        device.append([events[i].elapsed_time(events[i + 1])
                       for i in range(3)])
        host.append(times)
        nodes.append(state.read())
    names = ('rollout_ms', 'gae_ms', 'update_ms')
    out = {n: statistics.median(s[i] for s in device)
           for i, n in enumerate(names)}
    out['host_ms'] = {n: statistics.median(s[i] for s in host)
                      for i, n in enumerate(names)}
    out.update({'samples_ms': device, 'host_samples_ms': host,
                'node_us': nodes, 'hide_host_cycles': hide_host_cycles})
    return out


def bench_train_step(params, spec, cfg: ppo.PPOConfig, b: int, device,
                     state, timing: dict) -> dict:
    env_ids = torch.arange(b, dtype=torch.int32, device=device)
    step, opt = ppo.make_train_step(params, spec, cfg,
                                    prng.PRNGKey(1, device), env_ids)
    carry = {'ts': ppo.init_train_state(prng.PRNGKey(0, device), params,
                                        spec, cfg, b, opt)}

    def run(n):
        t = carry['ts']
        for _ in range(n):
            t, m = step(t)
        float(m['reward_per_step'])
        carry['ts'] = t

    res = common.timed(run, state, **timing)
    per_update = res['seconds']
    out = {
        'seconds_per_update': per_update,
        'updates_per_sec': 1.0 / per_update,
        'env_steps_per_sec': b * cfg.rollout_steps / per_update,
        'spread_pct': res['spread_pct'],
        'samples_s': res['samples'],
        'card_beside_reps': res['beside'],
        'warm_up': res['warm_up'],
        'minibatches': step.cfg.minibatches,
        'shuffle_block': step.cfg.shuffle_block,
    }
    if device.type == 'cuda':
        out['phases'] = phase_ms(step, carry['ts'], PHASE_STEPS, state)
        out['phases_host_hidden'] = phase_ms(step, carry['ts'], PHASE_STEPS,
                                             state, HIDE_HOST_CYCLES)
    return out


def bench_rollout(params, spec, cfg: ppo.PPOConfig, net, env_state, device,
                  state, timing: dict) -> dict:
    b = env_state.steps.shape[0]
    base_key = prng.PRNGKey(0, device)
    env_ids = torch.arange(b, dtype=torch.int32, device=device)
    rollout = common.PolicyRollout(params, spec, cfg, base_key, env_ids,
                                   cfg.rollout_steps)
    leaves = net.leaves()

    def run(n):
        for i in range(n):
            r = rollout(leaves, env_state, prng.fold_in(base_key, i))
        float(r)

    res = common.timed(run, state, **timing)
    per_rollout = res['seconds']
    return {
        'seconds_per_rollout': per_rollout,
        'env_steps_per_sec': b * cfg.rollout_steps / per_rollout,
        f'us_per_{b}env_step': 1e6 * per_rollout / cfg.rollout_steps,
        'spread_pct': res['spread_pct'],
        'samples_s': res['samples'],
        'card_beside_reps': res['beside'],
        'warm_up': res['warm_up'],
    }


def measure(b: int = B, rollout: int = ROLLOUT, hidden: int = HIDDEN, *,
            device=None, reps: int = 8, n_lo: int = 3, n_hi: int = 13,
            warmup: tuple = common.WARMUP) -> dict:
    """The benchmark's record (see the module docstring); on the card
    unless device='cpu'."""
    device = resolve_device(device)
    node_state = common.card_state(device)  # its floor read before captures
    timing = dict(reps=reps, n_lo=n_lo, n_hi=n_hi, warmup=warmup)
    params, spec, _, _, state, _ = common.lander_batch(b, device)
    results = {'backend': device.type, 'batch': b, 'rollout_steps': rollout,
               'hidden': hidden, 'card': common.card_record(device),
               'torch': torch.__version__,
               'timing': dict(timing, method=(
                   f'each config warmed up with single calls for '
                   f'{warmup[0]:g}-{warmup[1]:g} s, until the card\'s µs per '
                   f'graph node is within {common.CardState.FAST_RATIO:g} '
                   f'of its floor; then differential per call, median; the '
                   f'card and its µs per graph node sampled beside each '
                   f'rep'))}

    # minibatches pinned to 4 as in the JAX script; the production recipe
    # at 4096 envs resolves to 16 (ppo.scaled_minibatches)
    cfg_block = ppo.PPOConfig(rollout_steps=rollout, hidden=hidden,
                              minibatches=4)
    cfg_elem = cfg_block._replace(shuffle_block=1)
    cfg_prod = ppo.resolve_minibatches(cfg_block._replace(minibatches=None),
                                       b)
    net = ppo.init_params(prng.PRNGKey(2, device), spec.obs_size,
                          spec.action_size, cfg_block)

    for name, fn in (
            ('exploration_rollout', lambda: bench_rollout(
                params, spec, cfg_block, net, state, device, node_state,
                timing)),
            ('ppo_update', lambda: bench_train_step(
                params, spec, cfg_block, b, device, node_state, timing)),
            ('ppo_update_production', lambda: bench_train_step(
                params, spec, cfg_prod, b, device, node_state, timing)),
            ('ppo_update_element_shuffle', lambda: bench_train_step(
                params, spec, cfg_elem, b, device, node_state,
                timing))):
        print(f'benchmarking {name} ...', file=sys.stderr, flush=True)
        results[name] = fn()

    cur = results['ppo_update']['seconds_per_update']
    results['block_vs_element_speedup'] = (
        results['ppo_update_element_shuffle']['seconds_per_update'] / cur)
    results['rollout_share_of_update'] = (
        results['exploration_rollout']['seconds_per_rollout'] / cur)
    results['card_after'] = common.card_record(device)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out',
                   default=str(common.DOCS / 'torch_bench_train.json'))
    args = p.parse_args(argv)
    results = measure()
    print(json.dumps({k: results[k] for k in (
        'block_vs_element_speedup', 'rollout_share_of_update')}))
    common.write_json(args.out, results)
    print('wrote', args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
