"""The fused-rollout loop: the program's `fused_rollout` (one CUDA kernel
launch of `steps_per_call` auto-resetting env steps under a constant
action) called back to back on a batch of `num_envs` envs, with at most
`in_flight` calls queued on the card.

Every call starts from the start state the benchmark made from the seed
(`num_envs` envs reset under a threefry key, each at an episode index
drawn from the seed), with the reset hash salted by the call's index, so
that every call's answer differs and can be checked alone.  The window's
metric is the env-steps of the calls completed by its final synchronize
over the seconds to it.

`checked_calls` of the window's calls are drawn from the seed as they
complete (a reservoir sample: every call of the window is as likely to be
drawn), their answers kept.  Once the window has closed, the reference
rollout (a CUDA graph of plain torch steps on the card) recomputes them,
and their final states, reward sums and episode counts are compared.

A traced run keeps the host's µs per call and profiles `trace_calls` more
calls.  A substitute for the program (`ctx.substitute`) is called as
`fused_rollout` is.
"""

from __future__ import annotations

import collections
import gc
import random
import time

import torch

from port_bench import compare, program, trace
from port_bench.reference import counts
from port_bench.reference import env as E
from port_bench.reference import fused as F
from port_bench.reference import prng


def start_state(task: E.Task, seed: int, num_envs: int, device):
    """(env_state, env_ids, salt) made from the seed: the envs reset under
    PRNGKey(seed) at episodes drawn from a torch.Generator on `device`,
    and the reset hash's salt."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    env_ids = torch.arange(num_envs, dtype=torch.int32, device=device)
    episode = torch.randint(0, 1 << 20, (num_envs,), generator=gen,
                            device=device, dtype=torch.int32)
    base_key = prng.PRNGKey(seed, device)
    state, _ = E.reset(base_key, env_ids, episode, task)
    salt = int(seed) % (1 << 31)
    return state, env_ids, salt


def _outputs(state, totals):
    """The program's answer in the order of `reference.fused.rollout`'s:
    x, perturb, status, ticks, steps, prev_shaping, episode, reward sum,
    episodes finished."""
    d = state.dyn
    return (d.x, d.perturb, d.status, d.ticks, state.steps,
            state.prev_shaping, state.episode, totals['reward_sum'],
            totals['episodes'])


def run(ctx) -> dict:
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    tr = ctx.traffic
    task = E.params_from_config(ctx.config)
    num_envs, steps = int(tr['num_envs']), int(tr['steps_per_call'])
    on_card = ctx.device.type == 'cuda'
    ref_state, env_ids, salt0 = start_state(task, ctx.seed, num_envs,
                                            ctx.device)
    action = torch.full((task.action_size, num_envs), float(tr['action']),
                        dtype=torch.float32, device=ctx.device)
    params = program.env_params(ctx.config)
    spec = program.task_spec(ctx.config)
    state = program.env_state(ref_state)

    def salt(i):
        return (salt0 + i) % (1 << 31)

    fused = ctx.substitute or fr.fused_rollout

    def call(i):
        return fused(state, action, steps, params, spec, seed=salt(i),
                     env_ids=env_ids)

    # set-up: the first call builds the kernel where it is not built yet
    for i in range(int(tr['warmup_calls'])):
        call(i)
    if on_card:
        torch.cuda.synchronize()

    rng = random.Random(ctx.seed)
    draws = int(tr['checked_calls'])
    kept = {}  # slot of the sample -> (call, answer)
    host_us = []
    queue = collections.deque()
    calls = 0
    t0 = ctx.window_opens()
    while True:
        h0 = time.perf_counter()
        out = call(calls)
        host_us.append((time.perf_counter() - h0) * 1e6)
        slot = calls if calls < draws else rng.randrange(calls + 1)
        if slot < draws:
            kept[slot] = (calls, out)
        calls += 1
        if on_card:
            done = torch.cuda.Event()
            done.record()
            queue.append(done)
            if len(queue) > int(tr['in_flight']):
                queue.popleft().synchronize()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    ctx.window_closes()
    end_to_end = {'rollout_env_steps_per_s': counts.rate(
        calls, num_envs * steps, t_end - t0)}
    ctx.read_peak()

    layers = {'loop': 'fused', 'host_us_per_call': host_us,
              'bound_s': counts.fused_bound_s(num_envs, steps),
              'env_steps_per_call': num_envs * steps,
              'window_s': t_end - t0, 'window_calls': calls}
    if ctx.trace and on_card:
        def traced():
            for i in range(int(tr['trace_calls'])):
                call(calls + i)

        profile = trace.profile(traced)
        layers['profile'] = profile
        layers['kernel_s'] = sum(t for n, t in profile['kernel_s'].items()
                                 if 'fused_rollout_kernel' in n)
        layers['kernel_calls'] = int(tr['trace_calls'])

    answers = {i: [x.clone() for x in _outputs(*out)]
               for i, out in kept.values()}
    del kept, out, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    state_gap, reward_gap, episode_mismatch = 0.0, 0.0, 0
    for i, got in sorted(answers.items()):
        want = F.rollout(ref_state, env_ids, action, steps, salt(i), task,
                         graphed=on_card)
        state_gap = max(state_gap, max(
            compare.max_gap(g, r) for g, r in zip(got[:7], want[:7])))
        reward_gap = max(reward_gap, compare.max_gap(got[7], want[7]))
        episode_mismatch += int((got[8] != want[8]).sum())
    checks = [('state_gap', state_gap, ctx.limit('state_gap')),
              ('reward_gap', reward_gap, ctx.limit('reward_gap')),
              ('episode_mismatch', float(episode_mismatch),
               ctx.limit('episode_mismatch'))]
    layers['checked_calls'] = sorted(answers)
    layers['check_s'] = time.perf_counter() - t_check
    return {'end_to_end': end_to_end, 'layers': layers, 'checks': checks,
            'attempted': calls, 'failed': 0}
