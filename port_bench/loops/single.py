"""The single-env loop: the program's B = 1 env (`compat/single.py`
`SingleCopterEnv`, the Gymnasium adapter's core; one CUDA graph per step
on the card) stepped by a closed loop with random actions, `reset()` on
`terminated`.

Each action is `action_scale` times four standard normals from a numpy
generator seeded by the seed, as the reference demo's `--random` draws
them.  The window's metric is the 99th percentile of the latency of every
`step()` call, from the call to the numpy observation in hand; `reset()`
calls are outside it.  Set-up warms up, after the step's capture, until
the card's node time is back at its floor.

Once the window has closed, `checked_episodes` of the window's episodes
drawn from the seed, its longest among them, are replayed by the
reference env, one env per episode as the program steps it: its reset at
the episode's index, then the recorded actions, each step's observation,
reward and termination compared with what `step()` returned.

With `pin_host_thread` the loop's thread runs on the last core it may
use from set-up to the window's end, on the card (the threads the device's
runtime started before stay where they were).
A traced run profiles `trace_steps` more steps for the device's busy
seconds per step.  A substitute for the program (`ctx.substitute`) is
built and stepped as `SingleCopterEnv` is.
"""

from __future__ import annotations

import gc
import os
import random
import time

import numpy as np
import torch

from port_bench import card, compare, program, trace
from port_bench.reference import counts
from port_bench.reference import env as E
from port_bench.reference import prng


def replay(task, seed: int, episode: int, actions, device,
           dtype=torch.float32):
    """The reference's episode: (first obs, [(obs, reward, done)] per
    recorded action), stopping at its first termination."""
    key = prng.PRNGKey(seed, device)
    ids = torch.zeros(1, dtype=torch.int32, device=device)
    state, obs0 = E.reset(key, ids, torch.full((1,), episode,
                                               dtype=torch.int32,
                                               device=device), task,
                          dtype=dtype)
    out = []
    for a in actions:
        action = torch.as_tensor(np.asarray(a, np.float64)[:, None],
                                 dtype=dtype).to(device)
        state, obs, reward, done = E.raw_step(state, action, task)
        out.append((obs[:, 0].float().cpu(), float(reward[0]),
                     bool(done[0])))
        if out[-1][2]:
            break
    return obs0[:, 0].float().cpu(), out


def gaps(recorded, replayed):
    """(obs gap, reward gap, termination mismatches) of one episode: the
    program's first obs and steps against the reference's."""
    (obs0, steps), (r_obs0, r_steps) = recorded, replayed
    obs_gap = compare.max_gap(torch.as_tensor(obs0), r_obs0)
    reward_gap, mismatch = 0.0, abs(len(steps) - len(r_steps))
    for (o, r, d), (ro, rr, rd) in zip(steps, r_steps):
        obs_gap = max(obs_gap, compare.max_gap(torch.as_tensor(o), ro))
        reward_gap = max(reward_gap, compare.max_gap(
            torch.tensor([r], dtype=torch.float64),
            torch.tensor([rr], dtype=torch.float64)))
        mismatch += int(d != rd)
    return obs_gap, reward_gap, mismatch


def run(ctx) -> dict:
    from gym_copter_tpu_torch.compat.single import SingleCopterEnv

    tr = ctx.traffic
    task = E.params_from_config(ctx.config)
    on_card = ctx.device.type == 'cuda'
    state = (card.CardState(ctx.device, tr['warmup']['fast_ratio'])
             if on_card else None)
    env = (ctx.substitute or SingleCopterEnv)(
        ctx.config['env']['task'], params=program.env_params(ctx.config),
        seed=ctx.seed, device=ctx.device)
    cores = os.sched_getaffinity(0) if on_card else None
    if on_card and tr.get('pin_host_thread'):
        os.sched_setaffinity(0, {max(cores)})
    rng = np.random.default_rng(ctx.seed)
    scale = np.float32(tr['action_scale'])

    def action():
        return scale * rng.standard_normal(task.action_size).astype(
            np.float32)

    episode = {'index': -1}

    def reset():
        obs, _ = env.reset()
        episode['index'] += 1
        return obs

    reset()

    def unit():
        for _ in range(int(tr['warmup_steps_per_unit'])):
            if env.step(action())[2]:
                reset()

    w = tr['warmup']
    warm = card.warm_up(unit, state, w['min_s'], w['max_s'],
                        w['settled_reads'])

    episodes, latency = [], []
    current = {'index': episode['index'] + 1, 'obs0': reset(),
               'actions': [], 'steps': []}
    t0 = ctx.window_opens()
    while True:
        a = action()
        t = time.perf_counter()
        obs, reward, terminated, _, _ = env.step(a)
        latency.append(time.perf_counter() - t)
        current['actions'].append(a)
        current['steps'].append((obs, reward, terminated))
        if terminated:
            episodes.append(current)
            current = {'index': episode['index'] + 1, 'obs0': reset(),
                       'actions': [], 'steps': []}
        t_end = time.perf_counter()
        if t_end - t0 >= ctx.seconds:
            break
    ctx.window_closes()
    if cores is not None:
        os.sched_setaffinity(0, cores)
    if current['steps']:
        episodes.append(current)
    lat_us = [x * 1e6 for x in latency]
    end_to_end = {'single_step_us_p99': counts.percentile(lat_us, 99)}
    ctx.read_peak()

    layers = {'loop': 'single', 'step_us': lat_us, 'warm_up': warm,
              'window_s': t_end - t0, 'window_steps': len(latency)}
    if ctx.trace and on_card:
        def traced():
            for _ in range(int(tr['trace_steps'])):
                if env.step(action())[2]:
                    reset()

        layers['profile'] = trace.profile(traced)
        layers['traced_steps'] = int(tr['trace_steps'])

    del env
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    pick = random.Random(ctx.seed)
    longest = max(range(len(episodes)),
                  key=lambda i: len(episodes[i]['steps']))
    others = [i for i in range(len(episodes)) if i != longest]
    chosen = [longest] + pick.sample(
        others, min(len(others), int(tr['checked_episodes']) - 1))
    obs_gap, reward_gap, mismatch = 0.0, 0.0, 0
    for i in sorted(chosen):
        ep = episodes[i]
        replayed = replay(task, ctx.seed, ep['index'], ep['actions'],
                          ctx.device)
        o, r, m = gaps((ep['obs0'], ep['steps']), replayed)
        obs_gap, reward_gap, mismatch = (max(obs_gap, o),
                                         max(reward_gap, r), mismatch + m)
    checks = [('obs_gap', obs_gap, ctx.limit('obs_gap')),
              ('reward_gap', reward_gap, ctx.limit('reward_gap')),
              ('done_mismatch', float(mismatch), ctx.limit('done_mismatch'))]
    layers['checked_steps'] = sum(len(episodes[i]['steps']) for i in chosen)
    layers['check_s'] = time.perf_counter() - t_check
    return {'end_to_end': end_to_end, 'layers': layers, 'checks': checks,
            'attempted': len(latency), 'failed': 0}
