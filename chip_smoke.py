#!/usr/bin/env python3
"""The PyTorch/CUDA port's build report, its paths' launch counts and its
kernel timings on one GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc; imports nothing of JAX or gym_copter_tpu.
The full correctness checks on the card live in tests/test_torch_cuda.py
and the speed of every benchmarked path in port_bench/; this script holds
each kernel to its plain version once on the user's path, drives every
path once, and prints what neither of those does, each phase before the
last line:

  1. the device: name, count, nvidia-smi's name and power limit, and its
     SM clock now and at most;
  2. the build of every kernel from ops/csrc: seconds taken; per
     instantiation of the fused-rollout kernel (lanes per env, task kind,
     termination) ptxas's registers, stack frame and spills; and for the
     Lander/standard instantiations, counts from the SASS (ops/sass.py):
     the instructions of the step loop and of its straight path;
  3. the roundings the plain versions must avoid, counted on the card;
  4. the main path through the user's entry points: make('Lander3D-v0',
     num_envs=4096) on the card, reset, 3 steps, a 1000-step rollout and a
     10,000-step fused rollout, with every kernel's launch count set to 0
     just before and read just after, and the lanes per env the wrapper
     chose; the 3 steps are held against the env step's plain version
     (`step_reference`), the fused result against the fused rollout's,
     and one optimizer step at the recipe's Lander3D leaf shapes against
     `ClipAdam.step_reference`, each on the same inputs;
  5. [paths]: each other path that a user or a benchmark cell runs, driven
     once with no timing and every kernel's launch count set to 0 just
     before and read just after: [ppo] 2 graphed PPO train steps at the
     recipe on 4096 Lander3D and 4096 Hover3D envs (the `.ppo` cells),
     [gym] B = 1 steps of the Gymnasium adapter's core (`lander3d.single`),
     [dist] a one-rank NCCL world's sharded graphed train step and sharded
     fused rollout, [multihost] the multi-host launcher as one NCCL host
     over loopback, [bench] the headline entry point at a short size;
  6. [evo]: NEAT (3 generations) and HyperNEAT (2) at 960 genomes x 10
     episodes, seconds per generation beside the recorded curves (no
     benchmark cell covers this path yet);
  7. times with CUDA events after warm-up: the kernel's device time at the
     main path's shape, with the wrapper's host time apart; the kernel at
     1024, 4096, 8192, 12,288, 16,384 and 65,536 envs at every lanes-per-env
     choice (differential, 10k vs 110k steps); the SM clock under load; the
     plain eager step; the kernel's bound and its issue-limited time;
  8. one JSON line {"kernels": [...]}: per hand-written kernel its launches
     on each path and its largest difference from its plain version.

The last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without a CUDA device the script exits non-zero at once.

    python3 chip_smoke.py --sweep-only [--tree DIR]

runs only phase 1 and the timing sweep of phase 7, on the package found in
DIR if given (an unpacked older commit, to compare two versions in one
run).
"""

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

# published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# operations per env-step of the fused transition, after the JAX kernel's
# cost model (pallas_rollout.py CostEstimate): 150 flops + 8
# transcendentals, each transcendental counted as one operation
OPS_PER_ENV_STEP = 150 + 8
# kernel I/O per env: 29 words read (12 x, 6 perturb, status, ticks, steps,
# prev_shaping, episode, env id, 5 motor terms), 25 written (12 x, 6
# perturb, status, ticks, steps, prev_shaping, episode, reward sum,
# episode count)
BYTES_PER_ENV = (29 + 25) * 4

MAIN_B = 4096
MAIN_T = 10_000
SWEEP_B = (1024, 4096, 8192, 12_288, 16_384, 65_536)
# the instantiation whose SASS is counted: Lander3D's kind and termination
LANDER_STANDARD = (0, 0)
# cycles of the spin kernel that keeps the card busy while the host
# enqueues a timed call: about 5 ms at the H100's 1.98 GHz boost clock
BUSY_CYCLES = 10_000_000
# [evo]: the population, episodes per genome and generations timed
EVO_POP, EVO_REPS = 960, 10
EVO_GENERATIONS = {'neat': 3, 'hyperneat': 2}
# the recipe of the recorded 4096-env curves (scripts/train_curve.py's
# defaults), its learning rate annealed to 0 over a 600-update run, as the
# card tests run it; minibatches and shuffle_block resolve to 16 and 128
PPO_CFG = dict(rollout_steps=128, hidden=128, epochs=4, learning_rate=3e-4,
               gamma=0.995, entropy_coef=0.01, value_clip=0.0,
               target_kl=0.015, anneal_lr_floor=0.0)
PPO_RUN_UPDATES = 600
# [paths]: graphed train steps per path (the first captures the graphs),
# B = 1 steps, and the launcher's updates
PATH_PPO_STEPS = 2
PATH_SINGLE_STEPS = 300
PATH_MULTIHOST_UPDATES = 1
# the headline's keys (bench/headline.py)
BENCH_KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'spread_pct',
              'rejected_samples', 'card')


def log(*args):
    print(*args, flush=True)


def _smi(query):
    return subprocess.run(
        ['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def device_phase():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    clocks = _smi('clocks.sm,clocks.max.sm')
    log(f'[device] {name} x{count}; torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}; '
        f'{torch.cuda.get_device_properties(0).multi_processor_count} SMs')
    log(f'[device] SM clock now, max: {clocks}')
    smi = _smi('name,power.limit')
    log(smi)
    return name, count, smi, _mhz(clocks.split(',')[1])


def _mhz(field):
    return float(field.strip().split()[0])


def build_phase():
    """Builds every kernel; returns the straight-path instructions of one
    Lander/standard step per lanes-per-env choice."""
    from gym_copter_tpu_torch.ops import _build, sass
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f'[build] {len(_build.SOURCES)} kernel source(s) in '
        f'{time.perf_counter() - t0:.1f} s')
    rows, _ = sass.report(libs['fused_rollout'],
                          _build.ptxas_report('fused_rollout'))
    by_lanes, straight, spills = {}, {}, []
    for row in rows:
        if row['template'] is None:
            continue
        lanes, kind, term = row['template']
        tag = f'{fr._KINDS[kind]}/{fr._TERMINATIONS[term]}'
        by_lanes.setdefault(lanes, []).append(
            f'{tag} {row["registers"]} ({row["stack"]}, '
            f'{row["spill_stores"]}/{row["spill_loads"]})')
        if row['spill_stores'] or row['spill_loads']:
            spills.append(f'L={lanes} {tag}')
        if (kind, term) == LANDER_STANDARD:
            path = row['straight']
            straight[lanes] = path['instructions']
            loop = row['loop']
            log(f'[build] SASS L={lanes} lander/standard: step loop '
                f'{loop["instructions"]} instructions, {loop["BRA"]} BRA, '
                f'{loop["CALL"]} CALL, {loop["LDL"]} LDL, {loop["STL"]} STL, '
                f'{loop["SHFL"]} SHFL, {loop["inner_loops"]} inner loop(s); '
                f'straight path {path["instructions"]} instructions, '
                f'{path["BRA"]} BRA, {path["SHFL"]} SHFL, {path["MUFU"]} '
                f'MUFU; {row["registers"]} registers, {row["stack"]} B '
                f'stack')
    for lanes in sorted(by_lanes):
        log(f'[build] L={lanes}, registers (stack B, spill stores/loads B) '
            f'of {len(by_lanes[lanes])} instantiations: '
            + ', '.join(sorted(by_lanes[lanes])))
    log(f'[build] instantiations with spills: {spills or "none"}')
    return straight


def traps_phase(device):
    """The PyTorch roundings that the plain versions must avoid to match
    the kernels bit for bit, counted on the card."""
    from gym_copter_tpu_torch.core.device import div

    x = torch.linspace(0.1, 10.0, 1 << 20, device=device)
    n_div = int((x / 1.38 != div(x, 1.38)).sum())
    n_sin = int((torch.sin(x).cpu() != torch.sin(x.cpu())).sum())
    log(f'[traps] CUDA x / 1.38 (reciprocal multiply) differs from IEEE '
        f'division in {n_div} of {x.numel()} float32 values; CUDA and CPU '
        f'torch.sin differ in {n_sin}')


def _cases():
    """The kernel-vs-plain comparison, shared with tests/test_torch_cuda.py."""
    tests = str(Path(__file__).resolve().parent / 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_cuda_cases
    return torch_cuda_cases


def _event_ms(fn, reps, hide_host=False):
    """Milliseconds of fn() on the card, by CUDA events, over `reps` runs:
    (median, sorted samples, median host ms of the call).  With
    `hide_host`, a ~5 ms spin kernel is queued before the start event, so
    that the host enqueues fn's work while the card is busy and the events
    measure device time alone; otherwise an idle card waits for the host
    inside the measured window."""
    times, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    host.sort()
    return times[len(times) // 2], times, host[len(host) // 2]


def _counters():
    """Each hand-written kernel's launch counter, by the kernel's name."""
    from gym_copter_tpu_torch.envs import base
    from gym_copter_tpu_torch.learn import optim
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    return {'fused_rollout': fr.fused_rollout, 'env_step': base.step_kernel,
            'clip_adam': optim.step_kernel}


def _zero_launches():
    for counter in _counters().values():
        counter.launches = 0


def _launches():
    torch.cuda.synchronize()
    return {name: c.launches for name, c in _counters().items()}


def _max_abs(pairs):
    """The largest absolute difference over (got, want) float tensors."""
    return max((float((a.double() - b.double()).abs().max()) if a.numel()
                else 0.0 for a, b in pairs if a.is_floating_point()),
               default=0.0)


def _env_steps_against_plain(env, action, steps):
    """Each (state before, output) of `steps` against `step_reference` on
    the same state: the largest absolute difference (0: bit-equal)."""
    from gym_copter_tpu_torch.envs import base

    cases = _cases()
    err = 0.0
    for i, (before, got) in enumerate(steps):
        want = base.step_reference(before, action, env.base_key,
                                   env.env_ids, env.params, env.spec)
        diff = cases.step_differs(got, want)
        if diff:
            raise AssertionError(f'env step {i}: the kernel differs from '
                                 f'step_reference in {diff}')
        err = max(err, _max_abs(
            (a, b) for (_, a), (_, b) in zip(cases.step_fields(got),
                                             cases.step_fields(want))))
    return err


def _clip_adam_against_plain(device):
    """One optimizer step at the recipe's Lander3D leaf shapes (float32,
    the norm over the limit, the guard not stopped, the first count under
    the recipe's schedule) against `ClipAdam.step_reference`: the largest
    absolute difference (0: bit-equal)."""
    cases = _cases()
    opt, params, grads, state, stop = cases.clip_adam_case(
        cases.ppo_leaf_shapes(10), torch.float32, device, clip=True,
        stop=False, count=0, schedule=True)
    want = opt.step_reference(params, grads, state, stop)
    got = opt.step(params, grads, state, stop)
    diff = cases.step_mismatches(got, want)
    if diff:
        raise AssertionError(f'clip_adam differs from its plain version in '
                             f'{diff}')
    (gp, gs), (wp, ws) = got, want
    return _max_abs(list(zip(gp, wp)) + list(zip(gs.mu, ws.mu))
                    + list(zip(gs.nu, ws.nu)))


def main_path_phase():
    """The user's main path, with every kernel's launch count set to 0
    just before and read just after; each kernel held against its plain
    version on the same inputs."""
    import gym_copter_tpu_torch as gct
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    env = gct.make('Lander3D-v0', num_envs=MAIN_B)
    action = torch.full((4, MAIN_B), MOTORVAL, device=env.device)
    policy = lambda ps, obs: (ps, action)  # noqa: E731

    stages = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    steps = []

    def three_steps(state):
        for _ in range(3):
            before = state
            state, ts = env.step(state, action)
            steps.append((before, (state, ts)))
        return state

    _zero_launches()
    state, _ = timed('reset', env.reset)
    state = timed('3 steps', lambda: three_steps(state))
    state, _, traj = timed('rollout(1000)',
                           lambda: env.rollout(state, policy, 1000))
    before_fused = state
    state, totals = timed(f'fused_rollout({MAIN_T})',
                          lambda: env.fused_rollout(state, action, MAIN_T))
    launches = _launches()
    lanes = fr.lanes_for(MAIN_B, torch.cuda.get_device_properties(
        env.device).multi_processor_count)

    if env.device.type != 'cuda':
        raise AssertionError('make() did not default to the card')
    if totals['path'] != 'fused':
        raise AssertionError(f"main path took {totals['path']!r}")
    if launches['fused_rollout'] < 1 or launches['env_step'] < 1003 \
            or launches['clip_adam'] != 0:
        raise AssertionError(f'main path launches {launches}: want the '
                             f'fused kernel, the env step for each of '
                             f'1003 steps, no optimizer')
    if int(totals['episodes'].min()) < 1:
        raise AssertionError('an env finished no episode')
    if traj.obs.shape != (1000, 10, MAIN_B) or int(traj.done.sum()) < 1:
        raise AssertionError('rollout trajectory has the wrong shape or '
                             'no finished episode')
    for name, t in (('obs', traj.obs), ('reward', traj.reward),
                    ('x', state.dyn.x), ('reward_sum', totals['reward_sum'])):
        if not torch.isfinite(t).all():
            raise AssertionError(f'main path: {name} is not finite')
    log(f'[main] B={MAIN_B}: ' + ', '.join(
        f'{name} {sec:.4f} s' for name, sec in stages.items())
        + f'; path=fused; launches {json.dumps(launches)}; lanes per env '
        f'{lanes}; episodes/env '
        f'{float(totals["episodes"].float().mean()):.2f}; '
        f'{int(traj.done.sum())} episodes ended in the rollout')

    # each kernel against its plain version, on the same inputs
    errs = {'env_step': _env_steps_against_plain(env, action, steps)}
    log(f'[main] the 3 steps equal step_reference on the same states, every '
        f'field bit for bit (env_step.cu; max abs {errs["env_step"]})')
    plain = {}

    def run_plain():
        plain['out'] = fr.fused_rollout_reference(
            before_fused, action, MAIN_T, env.params, env.spec,
            env_ids=env.env_ids)

    plain_ms = _event_ms(run_plain, 1)[0]
    errs['fused_rollout'] = _cases().compare((state, totals), plain['out'],
                                             'main path vs plain')
    log(f'[main] fused rollout equals its plain version bit for bit '
        f'(plain version {plain_ms:.1f} ms)')
    errs['clip_adam'] = _clip_adam_against_plain(env.device)
    log(f'[main] one optimizer step at the recipe\'s Lander3D leaf shapes '
        f'equals ClipAdam.step_reference bit for bit (clip_adam.cu; max abs '
        f'{errs["clip_adam"]})')
    return launches, errs, plain_ms, (env, before_fused, action)


def _finite(what, metrics):
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f'{what}: {bad} not finite')


def _ppo_path():
    """[ppo]: PATH_PPO_STEPS graphed train steps at the recipe, 4096 envs
    of Lander3D and of Hover3D, as the `.ppo` cells run them."""
    import gym_copter_tpu_torch as gct
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.learn import ppo

    cfg = ppo.PPOConfig(**PPO_CFG)
    for name in ('Lander3D-v0', 'Hover3D-v0'):
        env = gct.make(name, num_envs=MAIN_B)
        opt = ppo.train_optimizer(ppo.resolve_minibatches(cfg, MAIN_B),
                                  PPO_RUN_UPDATES)
        step, opt = ppo.make_train_step(
            env.params, env.spec, cfg, prng.PRNGKey(1, env.device),
            env.env_ids, optimizer=opt)
        ts = ppo.init_train_state(prng.PRNGKey(0, env.device), env.params,
                                  env.spec, cfg, MAIN_B, opt)
        for _ in range(PATH_PPO_STEPS):
            ts, metrics = step(ts)
        _finite(f'[ppo] {name}', metrics)
        if int(ts.update_idx) != PATH_PPO_STEPS:
            raise AssertionError(f'[ppo] {name}: update_idx '
                                 f'{int(ts.update_idx)}')
        log(f'[ppo] {name}, {MAIN_B} envs, the recipe: {PATH_PPO_STEPS} '
            f'graphed train steps taken, every metric finite')


def _gym_path():
    """[gym]: PATH_SINGLE_STEPS graphed B = 1 steps of the Gymnasium
    adapter's core on Lander3D under random actions, reset at each end, as
    `lander3d.single` runs them."""
    import numpy as np

    from gym_copter_tpu_torch.compat.single import SingleCopterEnv

    env = SingleCopterEnv('Lander3D-v0')
    rng = np.random.default_rng(0)
    obs, _ = env.reset(seed=0)
    ended = 0
    for _ in range(PATH_SINGLE_STEPS):
        obs, reward, terminated, _, _ = env.step(
            rng.random(4, dtype=np.float32))
        if not (np.isfinite(obs).all() and math.isfinite(reward)):
            raise AssertionError(f'[gym] B = 1 step: obs {obs}, reward '
                                 f'{reward}')
        if terminated:
            ended += 1
            obs, _ = env.reset()
    log(f'[gym] SingleCopterEnv(Lander3D-v0) on the card, graphed: '
        f'{PATH_SINGLE_STEPS} steps, {ended} episodes ended, every '
        f'observation and reward finite')


def _dist_path():
    """[dist]: a one-rank NCCL world in this process: PATH_PPO_STEPS
    sharded graphed train steps at the recipe, and the sharded fused
    rollout at 4096 x 10,000 with its totals gathered."""
    import tempfile

    import torch.distributed as dist

    import gym_copter_tpu_torch as gct
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.learn import ppo
    from gym_copter_tpu_torch.parallel import sharding

    cfg = ppo.PPOConfig(**PPO_CFG)
    with tempfile.TemporaryDirectory() as tmp:
        group, device = sharding.init_world('nccl', 0, 1,
                                            f'file://{tmp}/store',
                                            local_rank=0)
        try:
            env = gct.make('Lander3D-v0', num_envs=MAIN_B, device=device)
            opt = ppo.train_optimizer(ppo.resolve_minibatches(cfg, MAIN_B),
                                      PPO_RUN_UPDATES)
            step, opt = ppo.make_train_step(
                env.params, env.spec, cfg, prng.PRNGKey(1, device),
                env.env_ids, optimizer=opt, group=group)
            ts = ppo.init_train_state(prng.PRNGKey(0, device), env.params,
                                      env.spec, cfg, MAIN_B, opt)
            for _ in range(PATH_PPO_STEPS):
                ts, metrics = step(ts)
            _finite('[dist] sharded step', metrics)
            state, _ = env.reset()
            action = torch.full((4, MAIN_B), MOTORVAL, device=device)
            _, totals = sharding.sharded_fused_rollout(
                state, action, MAIN_T, env.params, env.spec, seed=0,
                env_ids=env.env_ids)
            totals = sharding.gather_totals(totals, group)
            if int(totals['episodes'].min()) < 1 or not bool(
                    torch.isfinite(totals['reward_sum']).all()):
                raise AssertionError('[dist] sharded fused rollout: an env '
                                     'finished no episode or its reward is '
                                     'not finite')
        finally:
            dist.destroy_process_group()
    log(f'[dist] W = 1 NCCL, {MAIN_B} Lander3D envs: {PATH_PPO_STEPS} '
        f'sharded graphed train steps at the recipe, every metric finite; '
        f'sharded fused rollout of {MAIN_T} steps, totals gathered, every '
        f'env finished an episode')


def _multihost_path():
    """[multihost]: the multi-host launcher as one host of one NCCL rank
    over loopback, graphed, 4096 Lander3D envs at the recipe.  Its rank
    is another process, so only the fused kernel's launches, which the
    report holds, are counted."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        report = _cases().launch_hosts(f'{tmp}/report.json', 1, 'nccl',
                                       PATH_MULTIHOST_UPDATES)
    fused = sum(s['launches'] for s in report['per_shard'])
    if (report['hosts'], report['ranks'], report['devices']) != (1, 1, 1) \
            or not report['graphed'] or report['global_envs'] != MAIN_B \
            or report['update_idx'] != PATH_MULTIHOST_UPDATES \
            or not report['totals_equal_one_rank'] or fused < 1:
        raise AssertionError(f'[multihost] {report}')
    log(f'[multihost] one NCCL host over loopback, graphed, {MAIN_B} envs, '
        f'{PATH_MULTIHOST_UPDATES} update: totals equal one rank\'s; '
        f'fused_rollout launches {fused}')
    return {'fused_rollout': fused, 'env_step': None, 'clip_adam': None}


def _bench_path():
    """[bench]: the headline entry point (bench/headline.py) at 4096 envs
    and a short size, its history in a temporary directory: its keys and
    its sanity check; its value is not read."""
    import tempfile

    from gym_copter_tpu_torch.bench import headline

    with tempfile.TemporaryDirectory() as tmp:
        line = headline.run(MAIN_B, 1000, 11_000, 3,
                            history=f'{tmp}/history.json', warmup_s=0.0,
                            min_marginal_s=0.0)
    missing = [k for k in BENCH_KEYS if k not in line]
    if missing:
        raise AssertionError(f'[bench] the headline\'s line lacks {missing}')
    log(f'[bench] the headline entry point at {MAIN_B} envs: its line holds '
        f'every key, its sanity check passed')


def paths_phase():
    """[paths]: each path that a user or a benchmark cell runs and the main
    path does not, driven once with no timing, each kernel's launch count
    set to 0 just before and read just after.  Returns the launches by
    path and kernel."""
    out = {}
    for name, run, want, none in (
            ('ppo', _ppo_path, ('env_step', 'clip_adam'), ('fused_rollout',)),
            ('gym', _gym_path, ('env_step',), ('fused_rollout', 'clip_adam')),
            ('dist', _dist_path, ('fused_rollout', 'env_step', 'clip_adam'),
             ()),
            ('multihost', _multihost_path, ('fused_rollout',), ()),
            ('bench', _bench_path, ('fused_rollout', 'env_step'),
             ('clip_adam',))):
        _zero_launches()
        counted = run()
        out[name] = counted if counted is not None else _launches()
        wrong = ([k for k in want if not out[name][k]]
                 + [k for k in none if out[name][k]])
        if wrong:
            raise AssertionError(f'[{name}] launches {out[name]}: want '
                                 f'{want} launched, {none} not')
        log(f'[{name}] launches {json.dumps(out[name])}')
    return out


def _recorded_curve(algo):
    """Seed 0's recorded Lander3D learning curve (docs/{algo}_lander3d.json,
    the JAX package's run of scripts/neat_evolve.py)."""
    path = Path(__file__).resolve().parent / 'docs' / f'{algo}_lander3d.json'
    runs = json.loads(path.read_text())['runs']
    return next(r for r in runs if r['seed'] == 0)['curve']


def evo_phase():
    """[evo]: evolve_population at full width (960 genomes x 10 episodes x
    999 steps), each generation beside the recorded one, with its seconds
    (the first with its graphs' captures).  Returns the seconds per
    generation of each algorithm and each kernel's launches in the phase
    (the fused kernel's 0: fitness steps the env under a changing
    action)."""
    from gym_copter_tpu_torch.learn import hyperneat as hn
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    out = {}
    _zero_launches()
    for algo, mod, cfg in (
            ('neat', ne, ne.NeatConfig(pop_size=EVO_POP,
                                       episode_reps=EVO_REPS, hidden=16)),
            ('hyperneat', hn, hn.HyperNeatConfig(pop_size=EVO_POP,
                                                 episode_reps=EVO_REPS))):
        recorded = _recorded_curve(algo)
        marks = [time.perf_counter()]

        def callback(rec):
            marks.append(time.perf_counter())
            want = recorded[rec['generation']]
            log(f'[evo] {algo} gen {rec["generation"]}: best '
                f'{rec["best_fitness"]:.1f} mean {rec["mean_fitness"]:.1f} '
                f'holdout {rec["holdout_best"]:.1f} (the JAX package\'s '
                f'record: best {want["best_fitness"]:.1f} mean '
                f'{want["mean_fitness"]:.1f} holdout '
                f'{want["holdout_best"]:.1f}); {marks[-1] - marks[-2]:.2f} s')

        mod.evolve_population('Lander3D-v0', cfg,
                              max_generations=EVO_GENERATIONS[algo], seed=0,
                              callback=callback)
        out[algo] = [b - a for a, b in zip(marks, marks[1:])]
        log(f'[evo] {algo} at {EVO_POP} x {EVO_REPS} envs: seconds per '
            f'generation {out[algo]} (the first with its graphs\' captures)')
    out['launches'] = _launches()
    log(f'[evo] launches {json.dumps(out["launches"])}')
    return out


def _kernel_call(fr, env, state, action, lanes):
    """t -> one fused rollout of t steps: through the public entry point
    (the wrapper's own lanes per env) when `lanes` is None, else through
    the launch with `lanes` forced (the motor mix done once, outside)."""
    if lanes is None:
        return lambda t: fr.fused_rollout(state, action, t, env.params,
                                          env.spec)
    arrays, u, c = fr._prepare(state, action, env.params, env.spec, None)
    return lambda t: fr._rollout_cuda(arrays, u, t, 0, c, lanes=lanes)


def sweep_phase():
    """Differential kernel time, T = 110k minus T = 10k steps in one launch
    each (median of 5, CUDA events, host hidden), at each batch of SWEEP_B
    and each lanes-per-env choice; and one public 10k-step call at MAIN_B:
    its device time, its host time, and the two together behind an idle
    card.  Runs on whatever package is imported, so it also times an older
    tree that has no lanes choice."""
    import gym_copter_tpu_torch as gct
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    choices = getattr(fr, 'LANES_PER_ENV', (None,))
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for b in SWEEP_B:
        env = gct.make('Lander3D-v0', num_envs=b)
        state, _ = env.reset()
        action = torch.full((4, b), MOTORVAL, device=env.device)
        chosen = (fr.lanes_for(b, sm_count) if hasattr(fr, 'lanes_for')
                  else None)
        if b == MAIN_B:
            call = _kernel_call(fr, env, state, action, None)
            call(1000)
            out['ms'], out['ms_samples'], out['wrapper_host_ms'] = _event_ms(
                lambda: call(MAIN_T), 5, hide_host=True)
            # with an idle card in front of the call, the events also hold
            # the host's time to enqueue the work
            out['ms_host_exposed'], out['ms_host_exposed_samples'], _ = \
                _event_ms(lambda: call(MAIN_T), 5)
            log(f'[sweep] public call B={b} T={MAIN_T} L={chosen}: '
                f'{out["ms"]:.3f} ms of device time (samples '
                f'{out["ms_samples"]}); the wrapper takes '
                f'{out["wrapper_host_ms"]:.3f} ms of host time to enqueue '
                f'it; with that exposed on an idle card '
                f'{out["ms_host_exposed"]:.3f} ms (samples '
                f'{out["ms_host_exposed_samples"]})')
        for lanes in choices:
            call = _kernel_call(fr, env, state, action, lanes)
            call(1000)  # warm-up
            lo, lo_samples, _ = _event_ms(lambda: call(10_000), 5,
                                          hide_host=True)
            hi, hi_samples, _ = _event_ms(lambda: call(110_000), 5,
                                          hide_host=True)
            per_step = (hi - lo) / 100_000
            key = f'B{b}' if lanes is None else f'B{b}_L{lanes}'
            out[key] = {'lanes': lanes, 'chosen': lanes == chosen,
                        'ms_10k': lo, 'ms_110k': hi,
                        'ms_10k_samples': lo_samples,
                        'ms_110k_samples': hi_samples,
                        'us_per_step': per_step * 1e3,
                        'env_steps_per_s': b / (per_step * 1e-3)}
            mark = ' (chosen)' if lanes == chosen else ''
            log(f'[sweep] B={b} L={lanes}{mark}: '
                f'{lo:.3f} ms at T=10k, {hi:.3f} ms at T=110k -> '
                f'{per_step * 1e3:.4f} us/step, '
                f'{b / (per_step * 1e-3):.4g} env-steps/s')
    return out


def timing_phase(main, straight, max_mhz):
    """Kernel times with CUDA events after warm-up (the sweep), the SM clock
    under load, the plain eager step, and the bound and issue-limited
    time."""
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    env, state, action = main
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    lanes = fr.lanes_for(MAIN_B, sm_count)
    out = {'lanes': lanes, **sweep_phase()}

    # the SM clock while a ~2 s rollout runs
    _kernel_call(fr, env, state, action, None)(4_000_000)
    clock = _smi('clocks.sm')
    torch.cuda.synchronize()
    out['sm_mhz_under_load'] = _mhz(clock)
    log(f'[time] SM clock under load: {clock} (max {max_mhz:.0f} MHz)')

    # the plain eager env step (envs/base.step with its reset draw)
    st, _ = env.reset()
    for _ in range(5):
        st, _ = env.step(st, action)
    holder = {'st': st}

    def steps():
        for _ in range(100):
            holder['st'], _ = env.step(holder['st'], action)

    ms, samples, _ = _event_ms(steps, 5)
    out['plain_step_ms'] = ms / 100
    out['plain_step_ms_samples'] = [t / 100 for t in samples]
    log(f'[time] plain eager env.step at B={MAIN_B}: '
        f'{out["plain_step_ms"]:.4f} ms/step')

    ops = OPS_PER_ENV_STEP * MAIN_B * MAIN_T
    nbytes = BYTES_PER_ENV * MAIN_B
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    out['bound_ms'] = max(ops_ms, bytes_ms)
    out['bound_by'] = 'operations' if ops_ms >= bytes_ms else 'bytes'
    log(f'[time] bound at B={MAIN_B} T={MAIN_T}: {ops:.4g} ops / 67 TFLOP/s '
        f'= {ops_ms:.4f} ms, {nbytes} bytes / 3.35 TB/s = {bytes_ms:.6f} ms; '
        f'kernel {out["ms"]:.3f} ms of device time = '
        f'{out["bound_ms"] / out["ms"]:.2%} of the bound')
    # issue-limited time: the straight path's instructions for every lane
    # of every env-step, over one warp instruction per scheduler per cycle
    issue_rate = fr.SCHEDULERS_PER_SM * sm_count * 32 * max_mhz * 1e6
    out['issue'] = {}
    for b, n in ((MAIN_B, lanes), (65_536, fr.lanes_for(65_536, sm_count))):
        per_env_step = straight[n] * n
        us = per_env_step * b / issue_rate * 1e6
        measured = out[f'B{b}_L{n}']['us_per_step']
        out['issue'][f'B{b}'] = {'lanes': n,
                                 'instructions_per_env_step': per_env_step,
                                 'us_per_step': us}
        log(f'[time] issue-limited B={b} L={n}: {per_env_step} lane-'
            f'instructions per env-step (straight path {straight[n]} x {n}) '
            f'x {b} / ({fr.SCHEDULERS_PER_SM * sm_count} schedulers x 32 x '
            f'{max_mhz:.0f} MHz) = {us:.4f} us/step, {us * MAIN_T / 1e3:.4f} '
            f'ms per {MAIN_T} steps; measured {measured:.4f} us/step '
            f'({us / measured:.1%} of issue)')
    out['issue_ms'] = out['issue'][f'B{MAIN_B}']['us_per_step'] * MAIN_T / 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sweep-only', action='store_true',
                    help='run only the device phase and the timing sweep')
    ap.add_argument('--tree', type=Path, default=None,
                    help='import gym_copter_tpu_torch from this checkout '
                         '(with --sweep-only, to time another version)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    name, count, smi, max_mhz = device_phase()
    if args.sweep_only:
        import gym_copter_tpu_torch
        log(f'[sweep] package {Path(gym_copter_tpu_torch.__file__).parent}')
        log(json.dumps({'sweep': sweep_phase(), 'card': smi}))
        return 0
    straight = build_phase()
    traps_phase(torch.device('cuda'))
    launches, errs, plain_ms, main = main_path_phase()
    paths = paths_phase()
    evo_out = evo_phase()
    log(json.dumps({'evo': evo_out, 'card': smi}))
    times = timing_phase(main, straight, max_mhz)
    log(f'[time] card: {smi}')
    log(json.dumps({'timings': times, 'card': smi}))
    by_path = {'main': launches, **paths, 'evo': evo_out['launches']}
    sources = {
        'fused_rollout': 'gym_copter_tpu/ops/pallas_rollout.py:426',
        # the JAX package leaves these to XLA
        'env_step': None,
        'clip_adam': None,
    }
    kernels = []
    for kernel, replaces in sources.items():
        fused = kernel == 'fused_rollout'
        kernels.append({
            'name': kernel,
            'route': 'cuda',
            'source': f'gym_copter_tpu_torch/ops/csrc/{kernel}.cu',
            'replaces': replaces,
            'launches': launches[kernel],
            'launches_by_path': {path: counts[kernel]
                                 for path, counts in by_path.items()},
            'lanes': times['lanes'] if fused else None,
            'bit_exact': True,
            'max_abs_err': errs[kernel],
            'ms': times['ms'] if fused else None,
            'plain_ms': plain_ms if fused else None,
            'bound_ms': times['bound_ms'] if fused else None,
            'bound_by': times['bound_by'] if fused else None,
            'issue_ms': times['issue_ms'] if fused else None,
            'library_ms': None,
        })
    if not all(math.isfinite(kernels[0][f]) for f in ('ms', 'plain_ms',
                                                      'bound_ms')):
        raise AssertionError('non-finite time for fused_rollout')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
