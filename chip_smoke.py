#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc; imports nothing of JAX or gym_copter_tpu.
Phases, each printed before the last line:

  1. the device: name, count, nvidia-smi's name and power limit, and its
     SM clock now and at most;
  2. the build of every kernel from ops/csrc: seconds taken; per
     instantiation of the fused-rollout kernel (lanes per env, task kind,
     termination) ptxas's registers, stack frame and spills; and for the
     Lander/standard instantiations, counts from the SASS (ops/sass.py):
     the instructions of the step loop and of its straight path;
  3. the roundings the plain versions must avoid, and the exhaustive check
     that the kernel's sincosf gives sinf's and cosf's bits on all 2^32
     float32 values;
  4. every kernel against its plain PyTorch version on the card, bit for
     bit, at every lanes-per-env choice (1, 4): Lander3D at 4096 envs x
     2000 steps with deterministic and with random resets, at 1000 and 4099
     envs, then each task family at 128 envs on the scenarios of the CPU
     tests (tests/torch_cuda_cases.py);
  5. the main path through the user's entry points: make('Lander3D-v0',
     num_envs=4096) on the card, reset, 3 steps, a 1000-step rollout and a
     10,000-step fused rollout, with every launch count set to 0 just before
     and read just after, and the lanes per env the wrapper chose; the fused
     result is held against the plain version on the same inputs;
  5b. the PPO path ([ppo]): train('Lander3D-v0', num_envs=4096) for 3
     updates at the recorded recipe; 3 graphed train steps held bit for bit
     against the eager steps from the same state; the recipe's
     learning-rate schedule and train()'s default one on the card held bit
     for bit against the CPU's at every count, eagerly and graphed; the
     optimizer's kernel (ops/csrc/clip_adam.cu) held bit for bit against
     its plain version on the cases of tests/torch_cuda_cases.py, and so
     is the env step's (ops/csrc/env_step.cu) for every registry id; one
     small float32 step on the card against the CPU; device ms per phase
     (rollout, GAE, update), eager and graphed, and env-steps/s of
     training, with the card's SM clock, power draw, temperature and
     throttle reasons and its us per graph node (utils/profiling.
     NodeLatency) sampled beside each rep; operations and CUDA graph nodes
     per env step; the graphed
     evaluation's time, and a short one against its eager loop; one
     {"ppo": ...} JSON line;
  5c. the sharded path ([dist], parallel/): a one-rank NCCL world in this
     process, whose sharded graphed train step at the recipe is held bit for
     bit against the unsharded graphed step and timed beside it, and whose
     sharded fused rollout at 4096 envs x 10,000 steps (launch count set to
     0 just before) against fused_rollout; then two gloo ranks sharing the
     card through parallel/launch.py: totals equal to the one-rank layout,
     parameters equal across ranks after one eager step, the gloo
     all-reduce's time;
  5d. [ckpt]: the recipe's TrainState saved and restored (utils/
     checkpoint.py) as a .npz file and as an orbax directory, ms and bytes
     of each, and two graphed steps after each restore held bit for bit
     against uninterrupted ones; then the JAX package's orbax checkpoint
     of the recipe after one update (tests/data/jax_orbax_lander3d/,
     OCDBT) decoded and restored onto the card, every leaf held to its
     recorded SHA-256, and one graphed update from it held to JAX's
     recorded metrics (FIXTURE_METRIC_RTOL, FIXTURE_METRIC_ATOL), its
     largest relative gap printed;
  5e. [trace]: a torch.profiler trace of two graphed train steps: the
     device's busy and idle shares and its top kernels (utils/
     profiling.py); one {"dist": ..., "ckpt": ..., "trace": ...} line;
  5f. [evo]: the recorded NEAT and HyperNEAT Lander3D champions
     (docs/*_lander3d_champion.npz) carried across and evaluated on 100
     episodes, graphed and eagerly (bit-equal), each mean held to a band
     around the JAX package's CPU score; NEAT (3 generations) and HyperNEAT
     (2) at 960 genomes x 10 episodes beside the recorded curves, with
     seconds per generation and fitness, holdout and evolve timed apart,
     env-steps/s and graph nodes per env step; one evolve on the card
     against the CPU; every PID expert at 4096 envs x 1000 steps, graphed,
     Lander3D's and Hover3D's held to tests/test_pid.py's thresholds; the
     adaptive controller over the wind sweep for 6000 steps, held to
     tests/test_adaptive.py's; the Mars hover anchor, and the Mars PPO
     learning smoke of tests/test_mars.py graphed twice: in float64, held
     to the JAX package's float64 run of it (tests/data/
     jax_lander3dmars_f64_seed3.json) and to its bar, and in float32, the
     default, its gain printed; one {"evo": ...} line;
  5g. [gym]: the user-facing surface.  The float64 env on the card
     (Lander-v0, Lander3D-v0, Hover3D-v0, 4 envs x 1000 steps through
     auto-resets) against the numpy oracle (compat/numpy_oracle.py): done
     flags and status equal, the largest gap held to 1e-9; the Gymnasium
     adapter's B = 1 core (compat/single.py) over one Lander-v0 episode,
     graphed and eagerly (bit-equal), us per step of each, its return
     against the CPU's, and a float64 legacy-seeding episode;
     VisualCopterEnv at 4096 Lander3D envs (vision at res 16 and 64, DVS at
     16) as one-step graphs equal to the eager steps over 100 steps, with
     ms per step beside the env step alone, images/s and graph nodes, and
     the res-16 pixels that differ between the card and the CPU; the
     demos' main() (lander with --vision --save, --dvs, --freeze; hover;
     target) with their totals and seconds; the fused kernel's launches in
     the phase (0); one {"gym": ...} line;
  5h. [multihost]: the PPO init from PRNGKey(0) on the card held to the JAX
     package's recorded values, and the bf16-operand products on the card
     against the CPU's (TF32 float32 products raise); then the multi-host
     launcher (parallel/launch.py --coordinator, separate OS processes over
     a TCP rendezvous on loopback) on Lander3D-v0 at the recipe for 3
     updates, as (a) one host of one NCCL rank, graphed, 4096 envs, and
     (b) two hosts of one gloo rank each sharing the card, eager, 2 x 2048
     envs, (b)'s counts equal to (a)'s and its reward_per_step within
     rtol 1e-3; the fused kernel launched on every rank; one
     {"multihost": ...} line;
  6. times with CUDA events after warm-up: the kernel's device time at the
     main path's shape, with the wrapper's host time apart; the kernel at
     1024, 4096, 8192, 12,288, 16,384 and 65,536 envs at every lanes-per-env
     choice (differential, 10k vs 110k steps); the SM clock under load; the
     plain eager step; the kernel's bound and its issue-limited time;
  6b. [bench]: the headline entry point (python -m gym_copter_tpu_torch.
     bench) at 4096 envs, its history in a temporary directory: its JSON
     line parsed, its sanity check passed, its value held against phase
     6's differential figure at 4096 envs within the two spreads plus 1 %,
     the fused kernel's launches counted from 0; one {"bench": ...} line;
  7. one JSON line {"kernels": [...]}.

The last line is {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero; without a CUDA device the script exits non-zero at once.

    python3 chip_smoke.py --sweep-only [--tree DIR]

runs only phase 1 and the timing sweep of phase 6, on the package found in
DIR if given (an unpacked older commit, to compare two versions in one
run).

    python3 chip_smoke.py --ppo-only

runs only phase 1 and the PPO phase.

    python3 chip_smoke.py --dist-only

runs only phase 1 and phases 5b-5e.

    python3 chip_smoke.py --evo-only

runs only phase 1 and phase 5f.

    python3 chip_smoke.py --gym-only

runs only phase 1 and phase 5g.

    python3 chip_smoke.py --multihost-only

runs only phase 1 and phase 5h.
"""

import argparse
import dataclasses
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
    the kernels bit for bit, counted on the card; and the exhaustive proof
    that the kernel's sincosf is sinf and cosf."""
    from gym_copter_tpu_torch.core.device import div
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    x = torch.linspace(0.1, 10.0, 1 << 20, device=device)
    n_div = int((x / 1.38 != div(x, 1.38)).sum())
    n_sin = int((torch.sin(x).cpu() != torch.sin(x.cpu())).sum())
    log(f'[traps] CUDA x / 1.38 (reciprocal multiply) differs from IEEE '
        f'division in {n_div} of {x.numel()} float32 values; CUDA and CPU '
        f'torch.sin differ in {n_sin}')
    t0 = time.perf_counter()
    n = fr.sincos_mismatches(device)
    log(f'[traps] sincosf differs from sinf/cosf in {n} of 2^32 float32 '
        f'values ({time.perf_counter() - t0:.2f} s)')
    if n != 0:
        raise AssertionError('sincosf does not give sinf/cosf bits')


def _cases():
    """The kernel-vs-plain cases, shared with tests/test_torch_cuda.py."""
    tests = str(Path(__file__).resolve().parent / 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_cuda_cases
    return torch_cuda_cases


def parity_phase(device):
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    cases = _cases()
    worst = 0.0
    for what, spec, params, action, num_steps, pose, seed, b in \
            cases.scenarios():
        state = cases.reset_state(params, spec, b, device, pose=pose)
        act = torch.tensor(action, dtype=torch.float32,
                           device=device)[:, None].expand(-1, b)
        plain = fr.fused_rollout_reference(state, act, num_steps, params,
                                           spec, seed=seed)
        for lanes in fr.LANES_PER_ENV:
            kernel = cases.run_kernel(state, act, num_steps, params, spec,
                                      seed, lanes)
            torch.cuda.synchronize()
            err = cases.compare(kernel, plain, f'{what} L={lanes}')
            eps = kernel[1]['episodes']
            if int(eps.min()) < 1 and b < MAIN_B:
                raise AssertionError(f'{what}: an env finished no episode')
            worst = max(worst, err)
        log(f'[parity] {what}: B={b} T={num_steps} seed={seed} bit-exact '
            f'at L={fr.LANES_PER_ENV}, episodes/env '
            f'{float(eps.float().mean()):.2f}')
    return worst


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


def main_path_phase():
    """The user's main path, with the launch counts set to 0 just before
    and read just after."""
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

    def three_steps(state):
        for _ in range(3):
            state, _ = env.step(state, action)
        return state

    fr.fused_rollout.launches = 0
    state, _ = timed('reset', env.reset)
    state = timed('3 steps', lambda: three_steps(state))
    state, _, traj = timed('rollout(1000)',
                           lambda: env.rollout(state, policy, 1000))
    before_fused = state
    state, totals = timed(f'fused_rollout({MAIN_T})',
                          lambda: env.fused_rollout(state, action, MAIN_T))
    launches = {'fused_rollout': fr.fused_rollout.launches}
    lanes = fr.lanes_for(MAIN_B, torch.cuda.get_device_properties(
        env.device).multi_processor_count)

    if env.device.type != 'cuda':
        raise AssertionError('make() did not default to the card')
    if totals['path'] != 'fused':
        raise AssertionError(f"main path took {totals['path']!r}")
    if launches['fused_rollout'] < 1:
        raise AssertionError('the main path never launched fused_rollout')
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
        + f'; path=fused; launches {launches}; lanes per env {lanes}; '
        f'episodes/env '
        f'{float(totals["episodes"].float().mean()):.2f}; '
        f'{int(traj.done.sum())} episodes ended in the rollout')

    # the same fused rollout through the plain version, on the same inputs
    plain = {}

    def run_plain():
        plain['out'] = fr.fused_rollout_reference(
            before_fused, action, MAIN_T, env.params, env.spec,
            env_ids=env.env_ids)

    plain_ms = _event_ms(run_plain, 1)[0]
    err = _cases().compare((state, totals), plain['out'],
                           'main path vs plain')
    log(f'[main] fused rollout equals its plain version bit for bit '
        f'(plain version {plain_ms:.1f} ms)')
    return launches, err, plain_ms, (env, before_fused, action)


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


# [bench]: the headline's value agrees with phase 6's differential figure
# at the main batch within the sum of their spreads plus this floor, in
# percent: the two time other windows (1M against 100k steps) by other
# clocks (the host's against CUDA events)
BENCH_AGREE_FLOOR_PCT = 1.0
BENCH_KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'spread_pct',
              'rejected_samples', 'card')


def bench_phase(times):
    """[bench]: the headline entry point (`python -m gym_copter_tpu_torch.
    bench`, bench/headline.py) at full size with its history in a temporary
    directory; its line parsed and its value held against phase 6's
    differential figure at MAIN_B; the kernel's launches counted from 0."""
    import statistics
    import tempfile

    from gym_copter_tpu_torch.bench import headline
    from gym_copter_tpu_torch.ops import fused_rollout as fr
    from gym_copter_tpu_torch.utils import profiling

    fr.fused_rollout.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        line = json.loads(json.dumps(headline.run(
            history=f'{tmp}/history.json')))
        runs = json.loads(Path(f'{tmp}/history.json').read_text())['runs']
    out = {'seconds': time.perf_counter() - t0,
           'launches': fr.fused_rollout.launches, 'line': line}
    missing = [k for k in BENCH_KEYS if k not in line]
    if missing or len(runs) != 1 or out['launches'] < 1:
        raise AssertionError(f'headline: keys missing {missing}, '
                             f'{len(runs)} history entries, '
                             f'{out["launches"]} launches')
    sweep = times[f'B{MAIN_B}_L{times["lanes"]}']
    lo = statistics.median(sweep['ms_10k_samples'])
    rates = [MAIN_B * 100_000 / ((hi - lo) * 1e-3)
             for hi in sweep['ms_110k_samples']]
    sweep_spread = profiling.robust_stats(rates)['spread_pct']
    gap = abs(line['value'] / sweep['env_steps_per_s'] - 1) * 100
    tol = line['spread_pct'] + sweep_spread + BENCH_AGREE_FLOOR_PCT
    out.update({'phase6_env_steps_per_s': sweep['env_steps_per_s'],
                'phase6_spread_pct': sweep_spread, 'gap_pct': gap,
                'tolerance_pct': tol})
    log(f'[bench] python -m gym_copter_tpu_torch.bench at B={MAIN_B}: '
        f'{line["value"]:.6g} env-steps/s (spread {line["spread_pct"]}%, '
        f'{line["rejected_samples"]} rejected; sanity '
        f'{runs[0]["sanity"]["fused_episodes"]:.3f} fused / '
        f'{runs[0]["sanity"]["scan_episodes"]:.3f} step-by-step episodes '
        f'per env); phase 6: {sweep["env_steps_per_s"]:.6g} (spread '
        f'{sweep_spread:.2f}%); gap {gap:.3f}% (limit {tol:.3f}%); '
        f'{out["launches"]} fused launches counted from 0; '
        f'{out["seconds"]:.1f} s')
    if gap > tol:
        raise AssertionError(f'the headline ({line["value"]}) and phase 6 '
                             f'({sweep["env_steps_per_s"]}) disagree by '
                             f'{gap:.3f}% > {tol:.3f}%')
    return out


# the recipe of the recorded 4096-env curves (scripts/train_curve.py's
# defaults); minibatches and shuffle_block resolve to 16 and 128
PPO_CFG = dict(rollout_steps=128, hidden=128, epochs=4, learning_rate=3e-4,
               gamma=0.995, entropy_coef=0.01, value_clip=0.0,
               target_kl=0.015, anneal_lr_floor=0.0)
PPO_STEPS = 3
# largest absolute difference allowed between graphed and eager train
# steps from the same state
PPO_GRAPH_TOL = 0.0
# the LR schedule of a 600-update run, as train() would anneal it
PPO_RUN_UPDATES = 600


class _OpCounter:
    """Counts the ATen operations dispatched inside the block (on the card,
    each is about one kernel launch)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def _graph_nodes(fn, inputs, warmup):
    """(nodes, kernel nodes) of fn captured as a CUDA graph, counted with
    the driver's cuGraphGetNodes and cuGraphNodeGetType."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn(*inputs)
    cu = ctypes.CDLL('libcuda.so.1')
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError('cuGraphGetNodes failed')
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError('cuGraphGetNodes failed')
    kind = ctypes.c_int()
    kernels = 0
    for node in nodes:
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError('cuGraphNodeGetType failed')
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del g
    return n.value, kernels


def _ppo_times(step, ts, graphed, reps):
    """Median device ms of each phase (rollout, GAE, update) by CUDA events,
    median wall seconds of the whole step (host clock, synchronized), and
    the samples; beside each rep the card's SM clock, power draw,
    temperature and throttle reasons (nvidia-smi, started before the rep
    and read after it) and its µs per graph node read right after it."""
    from gym_copter_tpu_torch.utils import profiling

    node = profiling.NodeLatency()
    phases, walls, cards = [], [], []
    for _ in range(reps):
        marks = []
        read = profiling.card_probe()
        t0 = time.perf_counter()
        step.run(ts, graphed, marks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        cards.append(dict(_card_sample(read()), node_us=node()))
        phases.append([marks[i].elapsed_time(marks[i + 1])
                       for i in range(3)])
    med = [sorted(p[i] for p in phases)[reps // 2] for i in range(3)]
    return {'rollout_ms': med[0], 'gae_ms': med[1], 'update_ms': med[2],
            'step_s': sorted(walls)[reps // 2], 'samples_ms': phases,
            'step_s_samples': walls, 'card_samples': cards}


def _card_sample(card):
    """The fields of a `profiling.card` reading that change under load."""
    return {k: card[k] for k in ('sm_mhz', 'power_draw_w', 'temperature_c',
                                 'throttle_reasons')}


def _clocks(times):
    """The ranges of the card samples of a _ppo_times record."""
    cards = times['card_samples']

    def span(k, fmt):
        vals = [c[k] for c in cards if c[k] is not None]
        return (f'{min(vals):{fmt}}-{max(vals):{fmt}}' if vals else 'n/a')

    return (f'SM {span("sm_mhz", ".0f")} MHz, {span("power_draw_w", ".1f")} '
            f'W, {span("temperature_c", ".0f")} C, throttle '
            f'{sorted({c["throttle_reasons"] for c in cards})}, '
            f'{span("node_us", ".4f")} us per graph node')


def ppo_phase():
    """The PPO slice on the card: train() at the full-width recipe, graphed
    train steps held against the eager ones, one small step against the
    CPU, the graphed evaluation, times per phase, launches and graph
    nodes per env step."""
    import gym_copter_tpu_torch as gct
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.core.tree import tree_map
    from gym_copter_tpu_torch.envs import base
    from gym_copter_tpu_torch.learn import optim, ppo
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    cases = _cases()
    cfg = ppo.PPOConfig(**PPO_CFG)
    out = {'envs': MAIN_B, 'config': PPO_CFG}

    # 1. the user's entry point, launch counts set to 0 just before
    fr.fused_rollout.launches = 0
    optim.step_kernel.launches = 0
    base.step_kernel.launches = 0
    evals = []
    t0 = time.perf_counter()
    ts, _ = ppo.train('Lander3D-v0', num_envs=MAIN_B,
                         num_updates=PPO_STEPS, cfg=cfg, log_every=2,
                         callback=lambda i, m: evals.append((i, m)))
    torch.cuda.synchronize()
    out['train_s'] = time.perf_counter() - t0
    out['launches'] = {'fused_rollout': fr.fused_rollout.launches,
                       'clip_adam': optim.step_kernel.launches,
                       'env_step': base.step_kernel.launches}
    if int(ts.update_idx) != PPO_STEPS or [i for i, _ in evals] != [0, 2]:
        raise AssertionError('train() did not take its steps')
    for i, m in evals:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f'train() update {i}: {bad} not finite')
    out['train_metrics'] = evals
    log(f'[ppo] train(Lander3D-v0, {MAIN_B} envs, {PPO_STEPS} updates, '
        f'evaluated at 0 and 2): {out["train_s"]:.1f} s with the graphs\' '
        f'capture; eval_return {[round(m["eval_return"], 2) for _, m in evals]}'
        f'; launches {out["launches"]} (PPO rolls out with the per-step '
        f'env under a policy; clip_adam counts the update graph\'s warm-ups '
        f'and capture, 4 x 64, not its replays; env_step the rollout '
        f'graph\'s warm-up and capture and the evaluation\'s, not their '
        f'replays)')

    # 2. graphed train steps against the eager ones from the same state
    env = gct.make('Lander3D-v0', num_envs=MAIN_B)
    sched = optim.linear_schedule(
        cfg.learning_rate, 0.0, PPO_RUN_UPDATES * cfg.epochs * 16)
    step, opt = ppo.make_train_step(
        env.params, env.spec, cfg, prng.PRNGKey(1, env.device), env.env_ids,
        optimizer=optim.ClipAdam(cfg.max_grad_norm, sched))
    if (step.cfg.minibatches, step.cfg.shuffle_block) != (16, 128):
        raise AssertionError(f'recipe resolved to {step.cfg}')
    ts0 = ppo.init_train_state(prng.PRNGKey(0, env.device), env.params,
                               env.spec, cfg, MAIN_B, opt)
    t0 = time.perf_counter()
    g, _ = step(ts0)
    torch.cuda.synchronize()
    out['capture_s'] = time.perf_counter() - t0
    g, e = ts0, ts0
    errs, metric_errs = [], []
    for i in range(PPO_STEPS):
        g, mg = step(g)
        e, me = step.eager(e)
        errs.append(cases.state_diff(g, e, f'graphed vs eager step {i}'))
        metric_errs.append(max(abs(float(mg[k]) - float(me[k]))
                               for k in mg))
        for k, v in mg.items():
            if not math.isfinite(float(v)):
                raise AssertionError(f'graphed step {i}: {k} not finite')
    out['graphed_vs_eager_max_abs'] = errs
    out['graphed_vs_eager_metrics_max_abs'] = metric_errs
    if max(errs + metric_errs) > PPO_GRAPH_TOL:
        raise AssertionError(f'graphed and eager steps differ: {errs}, '
                             f'metrics {metric_errs}')
    log(f'[ppo] {PPO_STEPS} graphed train steps against the eager steps '
        f'from the same state (Lander3D-v0, {MAIN_B} envs, rollout 128, '
        f'hidden 128, 4 epochs x 16 minibatches, blocks of 128, target_kl '
        f'0.015): max abs difference of the train state per step {errs}, '
        f'of the metrics {metric_errs} (0 is bit-equal); the first call '
        f'captured the three graphs in {out["capture_s"]:.1f} s')

    # 2b. the recipe's learning-rate schedule, and train()'s default one
    # (annealed to a floor, through optim.fma32), on the card against the
    # CPU's
    out['schedule_mismatches'] = {}
    for name, sched in (('recipe', cases.RECIPE_SCHEDULE),
                        ('floor', cases.FLOOR_SCHEDULE)):
        eager, graphed, n = cases.schedule_mismatches(env.device, sched)
        out['schedule_mismatches'][name] = {'eager': eager,
                                            'graphed': graphed, 'counts': n}
        log(f'[ppo] the {name} learning-rate schedule ({sched[0]:g} to '
            f'{sched[1]:g} over {sched[2]} optimizer steps, rounded as '
            f'JAX\'s jitted step rounds it) on the card against the CPU at '
            f'all {n} counts: {eager} differ eagerly, {graphed} in a '
            f'captured graph of one 0-dim count (0 is bit-equal)')
        if eager or graphed:
            raise AssertionError(f'the {name} schedule on the card differs '
                                 f'from the CPU\'s at {eager} counts '
                                 f'eagerly, {graphed} graphed')

    # 2c. the optimizer's kernel against its plain version on the card
    bad, n, launches = cases.clip_adam_mismatches(env.device)
    out['clip_adam_mismatches'] = {'bad': bad, 'cases': n,
                                   'launches': launches}
    log(f'[ppo] the optimizer\'s kernel (ops/csrc/clip_adam.cu) against its '
        f'plain version on the card, {n} cases (Lander3D and Hover3D leaf '
        f'shapes, float32 and float64, clip on and off, no guard / go / '
        f'stop, counts near 1, near 38,400 and saturated, constant rate and '
        f'schedule), eagerly and replayed in a graph: {len(bad)} differ in '
        f'any bit')
    if bad:
        raise AssertionError(f'the clip_adam kernel differs from its plain '
                             f'version: {bad[:5]}')

    # 2d. the env step's kernel against its plain version on the card
    bad, runs = [], 0
    launches = base.step_kernel.launches
    for what, name, dtype, b, regime in cases.env_step_cases():
        if b != 4099 or regime != 'ends':
            continue
        for graphed in (False, True):
            diff, _, ended, _ = cases.env_step_mismatches(
                name, dtype, b, regime, env.device, graphed=graphed)
            runs += 1
            if diff or not ended:
                bad.append((what, graphed, diff[:3], ended))
    out['env_step_mismatches'] = {'bad': bad, 'runs': runs,
                                  'launches': base.step_kernel.launches
                                  - launches}
    log(f'[ppo] the env step\'s kernel (ops/csrc/env_step.cu) against its '
        f'plain version on the card: every registry id, float32 and '
        f'float64, 4099 envs, 16 steps that end every episode, eagerly and '
        f'replayed in a graph ({runs} runs, '
        f'{out["env_step_mismatches"]["launches"]} launches): {len(bad)} '
        f'differ in any field')
    if bad:
        raise AssertionError(f'the env step kernel differs from its plain '
                             f'version: {bad[:5]}')

    # 3. one small float32 step on the card against the same on the CPU
    small = ppo.PPOConfig(rollout_steps=8, hidden=16, minibatches=2,
                          epochs=4, learning_rate=1e-2, anneal_lr=False,
                          target_kl=1e9)
    cpu = torch.device('cpu')
    hover = gct.make('Hover3D-v0', num_envs=16, device=cpu)
    s_cpu, _ = ppo.make_train_step(hover.params, hover.spec, small,
                                   prng.PRNGKey(0, cpu), hover.env_ids)
    s_gpu, _ = ppo.make_train_step(
        hover.params, hover.spec, small, prng.PRNGKey(0, env.device),
        hover.env_ids.to(env.device))
    ts_cpu = ppo.init_train_state(prng.PRNGKey(7, cpu), hover.params,
                                  hover.spec, small, 16, s_cpu.optimizer)
    want, _ = s_cpu(ts_cpu)
    got, _ = s_gpu(cases.train_state_to(ts_cpu, env.device))
    worst = 0.0
    for a, b in zip(cases.state_tensors(got), cases.state_tensors(want)):
        a = a.cpu()
        if a.is_floating_point():
            scale = float(b.abs().max()) or 1.0
            worst = max(worst, float((a - b).abs().max()) / scale)
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale)
        elif not torch.equal(a, b):
            raise AssertionError('card and CPU steps differ in an integer '
                                 'field')
    out['card_vs_cpu_max_rel'] = worst
    log(f'[ppo] one float32 train step (Hover3D-v0, 16 envs, 8 steps, '
        f'hidden 16) on the card against the CPU: largest difference '
        f'{worst:.3g} of each tensor\'s scale (held to rtol 1e-4)')

    # 4. times per phase, eager and graphed, and env-steps/s of training
    out['graphed'] = _ppo_times(step, g, True, 5)
    out['eager'] = _ppo_times(step, g, False, 2)
    per_step = MAIN_B * cfg.rollout_steps
    out['env_steps_per_s'] = per_step / out['graphed']['step_s']
    out['env_steps_per_s_eager'] = per_step / out['eager']['step_s']
    for k in ('eager', 'graphed'):
        t = out[k]
        log(f'[ppo] {k}: rollout {t["rollout_ms"]:.2f} ms, GAE '
            f'{t["gae_ms"]:.2f} ms, update {t["update_ms"]:.2f} ms of '
            f'device time (CUDA events, median); {t["step_s"] * 1e3:.2f} ms '
            f'per train step on the host clock = '
            f'{per_step / t["step_s"]:.4g} env-steps/s of training; card '
            f'beside the reps: {_clocks(t)}')

    # 5. launches and graph nodes per env step
    leaves = g.params.leaves()
    r = tree_map(torch.clone, step._graphed_rollout(
        leaves, g.env_state, g.obs, g.key))
    es, obs, key = g.env_state, g.obs, g.key
    action = torch.full((4, MAIN_B), 1.625e-2, device=env.device)
    with _OpCounter() as c_env:
        env.step(es, action)
    with _OpCounter() as c_step:
        step.rollout(leaves, es, obs, key, 1)
    out['ops_per_env_step'] = c_env.n
    out['ops_per_policy_env_step'] = c_step.n
    out['nodes_per_policy_env_step'] = _graph_nodes(
        lambda *a: step.rollout(*a, 1), (leaves, es, obs, key), 1)
    out['nodes_per_env_step'] = _graph_nodes(
        lambda st: env.step(st, action), (es,), 1)
    flat, _ = step.advantages(leaves, r[3], r[1])
    out['nodes_gae'] = _graph_nodes(step.advantages, (leaves, r[3], r[1]), 1)
    out['nodes_update'] = _graph_nodes(
        step.update, (leaves, g.opt_state, key, flat), 3)
    log(f'[ppo] ATen operations per env.step {c_env.n}, per policy + env '
        f'step {c_step.n}; CUDA graph (nodes, kernel nodes) per env.step '
        f'{out["nodes_per_env_step"]}, per policy + env step '
        f'{out["nodes_per_policy_env_step"]}, GAE graph '
        f'{out["nodes_gae"]}, update graph {out["nodes_update"]} (4 epochs '
        f'x 16 minibatches: ~{out["nodes_update"][0] / 64:.1f} nodes per '
        f'optimizer step with its forward and backward)')

    # 6. the graphed evaluation at full size (1024 envs x 999 steps), and
    # a short one against its eager loop
    evaluate = ppo.make_eval_fn(env.params, env.spec, cfg)
    t0 = time.perf_counter()
    mean, total = evaluate(g.params)
    torch.cuda.synchronize()
    out['eval_capture_s'] = time.perf_counter() - t0
    out['eval_ms'] = _event_ms(lambda: evaluate(g.params), 3)[0]
    if total.shape != (ppo.EVAL_NUM_ENVS,) or not bool(
            torch.isfinite(total).all()):
        raise AssertionError(f'evaluation returns {total}')
    short = ppo.make_eval_fn(env.params, env.spec, cfg, num_envs=64,
                             num_steps=100)
    if not torch.equal(short(g.params)[1],
                       short(g.params, graphed=False)[1]):
        raise AssertionError('graphed and eager evaluations differ')
    log(f'[ppo] evaluation (1024 envs x 999 steps, a 1-step graph replayed '
        f'999 times): {out["eval_ms"]:.1f} ms graphed (the first call '
        f'captured it in {out["eval_capture_s"]:.1f} s); mean return '
        f'{float(mean):.3f}; 64 envs x 100 steps graphed = eager, bit-equal')
    return out, step, g


def dist_phase(plain):
    """The sharded path ([dist]): a W = 1 NCCL world in this process, whose
    sharded graphed train step at the recipe is held bit for bit against
    `plain`, the unsharded graphed step of [ppo] (times of both), and whose
    sharded fused rollout at 4096 x 10,000 against `fused_rollout`, its
    launches counted from 0; then two gloo ranks sharing the card
    (parallel/launch.py)."""
    import tempfile

    import torch.distributed as dist

    import gym_copter_tpu_torch as gct
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.learn import ppo
    from gym_copter_tpu_torch.ops import fused_rollout as fr
    from gym_copter_tpu_torch.parallel import launch, sharding

    cases = _cases()
    cfg = ppo.PPOConfig(**PPO_CFG)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        group, device = sharding.init_world('nccl', 0, 1,
                                            f'file://{tmp}/store',
                                            local_rank=0)
        try:
            env = gct.make('Lander3D-v0', num_envs=MAIN_B, device=device)
            sharded, _ = ppo.make_train_step(
                env.params, env.spec, cfg, prng.PRNGKey(1, device),
                env.env_ids, optimizer=plain.optimizer, group=group)
            ts0 = ppo.init_train_state(prng.PRNGKey(0, device), env.params,
                                       env.spec, cfg, MAIN_B,
                                       plain.optimizer)
            a, b = ts0, ts0
            errs = []
            for i in range(PPO_STEPS):
                a, ma = plain(a)
                b, mb = sharded(b)
                errs.append(max([cases.state_diff(a, b, f'step {i}')]
                                + [abs(float(ma[k]) - float(mb[k]))
                                   for k in ma]))
            out['sharded_vs_unsharded_max_abs'] = errs
            if max(errs) > PPO_GRAPH_TOL:
                raise AssertionError(f'sharded W = 1 and unsharded graphed '
                                     f'steps differ: {errs}')
            # in turns: unsharded, sharded, sharded, unsharded
            runs = [(name, _ppo_times(step, a, True, 3)) for name, step in (
                ('unsharded', plain), ('sharded', sharded),
                ('sharded', sharded), ('unsharded', plain))]
            for name in ('unsharded', 'sharded'):
                out[name] = [t for n, t in runs if n == name]
            log(f'[dist] W = 1 NCCL, graphed, the recipe at {MAIN_B} envs: '
                f'{PPO_STEPS} sharded steps equal the unsharded ones bit for '
                f'bit (max abs {errs}); step on the host clock '
                + ', '.join(f'{n} {t["step_s"] * 1e3:.2f} ms (rollout '
                            f'{t["rollout_ms"]:.2f}, GAE {t["gae_ms"]:.2f}, '
                            f'update {t["update_ms"]:.2f}; {_clocks(t)})'
                            for n, t in runs))

            state, _ = env.reset()
            action = torch.full((4, MAIN_B), MOTORVAL, device=device)
            fr.fused_rollout.launches = 0
            final, totals = sharding.sharded_fused_rollout(
                state, action, MAIN_T, env.params, env.spec, seed=0,
                env_ids=env.env_ids)
            totals = sharding.gather_totals(totals, group)
            torch.cuda.synchronize()
            out['launches'] = fr.fused_rollout.launches
            if out['launches'] < 1:
                raise AssertionError('the sharded path never launched '
                                     'fused_rollout')
            want = fr.fused_rollout(state, action, MAIN_T, env.params,
                                    env.spec, seed=0, env_ids=env.env_ids)
            cases.compare((final, totals), want, 'sharded vs one rank')
            out['fused_ms'] = _event_ms(lambda: sharding.sharded_fused_rollout(
                state, action, MAIN_T, env.params, env.spec, seed=0,
                env_ids=env.env_ids), 3, hide_host=True)[0]
            log(f'[dist] sharded fused rollout, W = 1, {MAIN_B} x {MAIN_T}: '
                f'bit-identical to fused_rollout; {out["launches"]} '
                f'launch(es) counted from 0; {out["fused_ms"]:.3f} ms of '
                f'device time')
        finally:
            dist.destroy_process_group()

    t0 = time.perf_counter()
    out['gloo'] = launch.run(2, 'gloo', 'cuda', envs_per_rank=MAIN_B // 2,
                             updates=1, timeout_s=600)
    out['gloo']['command_s'] = time.perf_counter() - t0
    g = out['gloo']
    log(f'[dist] W = 2 gloo ranks sharing the card ({g["global_envs"]} '
        f'envs, the recipe, one eager step): totals equal the one-rank '
        f'layout, parameters equal across ranks; step {g["step_s"]:.3f} s; '
        f'gloo all-reduce of the {g["allreduce_bytes"]} B gradient '
        f'{g["allreduce_ms"]:.3f} ms (through the host; not a scaling '
        f'figure); {g["command_s"]:.1f} s with the spawn')
    return out


# the gap allowed between each metric of the port's first update on the
# card from the committed JAX checkpoint and JAX's recorded one (CPU,
# float32): |port - jax| <= rtol * |jax| + atol.  Measured on an H100:
# approx_kl 1.30e-5 relative, the others at most 3.95e-6, done_rate
# exact; rtol 1e-4 is also what [ppo] holds a card step to the CPU's
FIXTURE_METRIC_RTOL, FIXTURE_METRIC_ATOL = 1e-4, 1e-8


def _dir_bytes(path):
    return (path.stat().st_size if path.is_file() else
            sum(f.stat().st_size for f in path.rglob('*') if f.is_file()))


def ckpt_phase(step, ts, smi):
    """[ckpt]: the recipe's TrainState saved and restored in both formats
    (utils/checkpoint.py: a .npz file and an orbax directory), with bytes
    and ms, graphed steps after each restore held bit for bit against
    uninterrupted ones; then the committed JAX-written orbax checkpoint
    (tests/data/jax_orbax_lander3d/) restored, every leaf held to its
    recorded SHA-256, and one graphed update from it held to JAX's
    recorded metrics."""
    import tempfile

    from gym_copter_tpu_torch.utils import checkpoint, orbax_format

    cases = _cases()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, name in (('npz', 'train_state.npz'),
                          ('orbax', 'train_state')):
            path = Path(tmp) / name
            t0 = time.perf_counter()
            checkpoint.save(str(path), ts, step.optimizer)
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            restored = checkpoint.restore(str(path), ts, step.optimizer)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            if cases.state_diff(restored, ts, f'restored {fmt}') != 0:
                raise AssertionError(f'the restored {fmt} state differs')
            a, b, errs = ts, restored, []
            for i in range(2):
                a, ma = step(a)
                b, mb = step(b)
                errs.append(max([cases.state_diff(a, b, f'resumed step {i}')]
                                + [abs(float(ma[k]) - float(mb[k]))
                                   for k in ma]))
            if max(errs) != 0:
                raise AssertionError(f'resumed {fmt} steps differ: {errs}')
            out[fmt] = {'bytes': _dir_bytes(path), 'save_ms': save_ms,
                        'restore_ms': restore_ms, 'resumed_max_abs': errs}
            log(f'[ckpt] recipe TrainState ({MAIN_B} envs, hidden 128) as '
                f'{"a .npz file" if fmt == "npz" else "an orbax directory"}'
                f': {out[fmt]["bytes"]} bytes, save {save_ms:.2f} ms, '
                f'restore {restore_ms:.2f} ms; 2 graphed steps after the '
                f'restore equal the uninterrupted ones bit for bit ({smi})')

    record = cases.fixture_record()
    recipe = (record['env'], record['envs'], record['config'],
              record['run_updates'])
    if recipe != ('Lander3D-v0', MAIN_B, PPO_CFG, PPO_RUN_UPDATES):
        raise AssertionError(f'the fixture is of another recipe: {recipe}')
    t0 = time.perf_counter()
    entries = orbax_format.read(str(cases.FIXTURE))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jts = checkpoint.restore(str(cases.FIXTURE), ts, step.optimizer)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    bad = cases.fixture_mismatches(jts, step.optimizer, record)
    if bad or len(entries) != len(record['leaves']):
        raise AssertionError(f'the JAX checkpoint restores wrong at {bad}')
    nxt, m = step(jts)
    torch.cuda.synchronize()
    gaps = {}
    for k, want in record['next_update_metrics'].items():
        got = float(m[k])
        gaps[k] = {'port': got, 'jax': want, 'abs': abs(got - want),
                   'rel': abs(got - want) / abs(want) if want else None}
    out['jax_fixture'] = {
        'bytes': _dir_bytes(cases.FIXTURE), 'decode_s': decode_s,
        'restore_ms': restore_ms, 'leaves': len(entries),
        'metric_gaps': gaps, 'rtol': FIXTURE_METRIC_RTOL,
        'atol': FIXTURE_METRIC_ATOL}
    log(f'[ckpt] the JAX package\'s orbax checkpoint of the recipe after '
        f'one update (tests/data/jax_orbax_lander3d/, OCDBT, '
        f'{out["jax_fixture"]["bytes"]} bytes): decoded on the host in '
        f'{decode_s:.3f} s, restored onto the card in {restore_ms:.1f} ms; '
        f'{len(entries)} entries, every leaf equal to its recorded SHA-256 '
        f'({smi})')
    log('[ckpt] one graphed update from it against JAX\'s recorded next '
        'update (|port - jax| <= '
        f'{FIXTURE_METRIC_RTOL} |jax| + {FIXTURE_METRIC_ATOL}): '
        + ', '.join(f'{k} {g["port"]:.6g} vs {g["jax"]:.6g} (rel '
                    f'{g["rel"] if g["rel"] is None else format(g["rel"], ".2e")})'
                    for k, g in gaps.items()))
    worst = max((k for k in gaps if gaps[k]['rel'] is not None),
                key=lambda k: gaps[k]['rel'])
    out['jax_fixture']['largest_rel'] = {worst: gaps[worst]['rel']}
    log(f'[ckpt] largest relative gap {worst} {gaps[worst]["rel"]:.3e}')
    outside = [k for k, g in gaps.items() if not (
        math.isfinite(g['port']) and g['abs'] <= FIXTURE_METRIC_RTOL
        * abs(g['jax']) + FIXTURE_METRIC_ATOL)]
    if outside or int(nxt.update_idx) != record['updates_before_save'] + 1:
        raise AssertionError(f'the update from the JAX checkpoint: '
                             f'{outside} outside the tolerance, update_idx '
                             f'{int(nxt.update_idx)}')
    return out


# the recorded Lander3D champions (docs/*_lander3d_champion.npz) evaluated
# by the JAX package on the CPU in float32 (reps 100, seed 77, episode
# 10000), and the band each mean on the card is held to: one episode that
# ends differently moves a mean of 100 by up to ~4
CHAMPIONS = {'neat': (311.29, 8.0), 'hyperneat': (317.86, 3.0)}
EVO_POP, EVO_REPS = 960, 10
EVO_GENERATIONS = {'neat': 3, 'hyperneat': 2}
EXPERT_ENVS, EXPERT_STEPS = 4096, 1000
ADAPTIVE_WINDS = (-4.0, -2.0, 0.0, 2.0, 4.0)
ADAPTIVE_STEPS = 6000
# the Mars learning smoke of tests/test_mars.py:57-75, and the JAX
# package's float64 run of it (tests/make_jax_mars_curve.py); the card's
# float64 run is held to it (measured on an H100: evals 6.8e-7 relative,
# the evaluation's envs being float32; metrics 6.6e-9)
MARS_PPO = dict(rollout_steps=64, hidden=32, gamma=0.995, learning_rate=1e-3)
MARS_UPDATES, MARS_ENVS, MARS_GAIN = 160, 256, 40.0
MARS_JAX_F64 = (Path(__file__).resolve().parent / 'tests' / 'data'
                / 'jax_lander3dmars_f64_seed3.json')
MARS_EVAL_RTOL, MARS_METRIC_RTOL, MARS_METRIC_ATOL = 1e-5, 1e-6, 1e-12


def _recorded_curve(algo):
    """Seed 0's recorded Lander3D learning curve (docs/{algo}_lander3d.json,
    the JAX package's run of scripts/neat_evolve.py)."""
    path = Path(__file__).resolve().parent / 'docs' / f'{algo}_lander3d.json'
    runs = json.loads(path.read_text())['runs']
    return next(r for r in runs if r['seed'] == 0)['curve']


def _champions(out):
    """Both recorded champions carried across and evaluated on the card,
    graphed and eagerly (bit-equal), each mean held to its band."""
    from gym_copter_tpu_torch.compat import convert
    from gym_copter_tpu_torch.learn import hyperneat as hn
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    docs = Path(__file__).resolve().parent / 'docs'
    for algo, load, mod, cfg in (
            ('neat', convert.genome_from_numpy, ne,
             ne.NeatConfig(hidden=16)),
            ('hyperneat', convert.cppn_from_numpy, hn,
             hn.HyperNeatConfig())):
        champ = load(docs / f'{algo}_lander3d_champion.npz')
        (mean, per), first_s = _timed(lambda: mod.evaluate_champion(
            champ, 'Lander3D-v0', cfg))
        (_, again), graphed_s = _timed(lambda: mod.evaluate_champion(
            champ, 'Lander3D-v0', cfg))
        (_, eager), eager_s = _timed(lambda: mod.evaluate_champion(
            champ, 'Lander3D-v0', cfg, graphed=False))
        if not (torch.equal(per, eager) and torch.equal(per, again)):
            raise AssertionError(f'{algo} champion: graphed and eager '
                                 f'evaluations differ')
        ref, band = CHAMPIONS[algo]
        out[f'{algo}_champion'] = {
            'mean': mean, 'std': float(per.std(correction=0)),
            'jax_cpu_float32': ref, 'band': band,
            'first_graphed_s': first_s, 'graphed_s': graphed_s,
            'eager_s': eager_s}
        log(f'[evo] {algo} champion (docs/{algo}_lander3d_champion.npz) on '
            f'100 fresh Lander3D episodes (seed 77, episode 10000): mean '
            f'{mean:.2f} (per-episode std {float(per.std(correction=0)):.1f})'
            f' against the JAX package\'s {ref} on the CPU in float32 '
            f'(band ±{band}); graphed = eager bit for bit; two graphed '
            f'calls, each with its capture, {first_s:.2f} s and '
            f'{graphed_s:.2f} s; eager {eager_s:.2f} s')
        if abs(mean - ref) > band:
            raise AssertionError(f'{algo} champion scores {mean:.2f}, '
                                 f'outside {ref} ± {band}')


def _timed(fn):
    """(fn(), seconds) on the host clock, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def _evolution(out, algo):
    """evolve_population at full width (960 genomes x 10 episodes x 999
    steps): each generation beside the recorded one, seconds per
    generation; then fitness, holdout and evolve timed apart on the last
    population, env-steps/s, and graph nodes per env step."""
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.learn import hyperneat as hn
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    if algo == 'neat':
        mod, cfg = ne, ne.NeatConfig(pop_size=EVO_POP, episode_reps=EVO_REPS,
                                     hidden=16)
        pheno_cfg = cfg
    else:
        mod = hn
        cfg = hn.HyperNeatConfig(pop_size=EVO_POP, episode_reps=EVO_REPS)
        pheno_cfg = cfg.as_neat()
    recorded = _recorded_curve(algo)
    marks = [time.perf_counter()]

    def callback(rec):
        marks.append(time.perf_counter())
        want = recorded[rec['generation']]
        log(f'[evo] {algo} gen {rec["generation"]}: best '
            f'{rec["best_fitness"]:.1f} mean {rec["mean_fitness"]:.1f} '
            f'holdout {rec["holdout_best"]:.1f} (the JAX package\'s record: '
            f'best {want["best_fitness"]:.1f} mean {want["mean_fitness"]:.1f} '
            f'holdout {want["holdout_best"]:.1f}); '
            f'{marks[-1] - marks[-2]:.2f} s')

    champ, hist, pop = mod.evolve_population(
        'Lander3D-v0', cfg, max_generations=EVO_GENERATIONS[algo], seed=0,
        callback=callback)
    gen_s = [b - a for a, b in zip(marks, marks[1:])]
    for rec in hist:
        if not all(math.isfinite(rec[k]) for k in ('best_fitness',
                                                    'mean_fitness',
                                                    'holdout_best')):
            raise AssertionError(f'{algo}: generation {rec} not finite')

    # the three parts of a generation, timed apart on the last population
    decode = None
    if algo == 'hyperneat':
        decode = hn.make_decoder(hn.make_substrate(10, 4,
                                                   cfg.substrate_hidden),
                                 cfg)
        pheno, decode_s = _timed(lambda: decode(pop))
    else:
        pheno, decode_s = pop, 0.0
    fitness = ne.make_fitness_fn('Lander3D-v0', pheno_cfg)
    holdout = ne.make_fitness_fn('Lander3D-v0', dataclasses.replace(
        pheno_cfg, pop_size=pheno_cfg.topk), reps=pheno_cfg.holdout_reps,
        seed=1001)
    fitness(pheno, 0)  # capture
    fit, fitness_s = _timed(lambda: fitness(pheno, len(hist)))
    cands = ne.take_genomes(pheno, torch.argsort(-fit, stable=True)[:4])
    holdout(cands, 2 ** 30)  # capture
    _, holdout_s = _timed(lambda: holdout(cands, 2 ** 30))
    evolve = mod.make_evolve_fn(cfg)
    _, evolve_s = _timed(lambda: evolve(pop, fit, prng.PRNGKey(9, 'cuda')))
    steps = EVO_POP * EVO_REPS * pheno_cfg.max_steps
    genome, carry = fitness.start(pheno, 0)
    nodes = _graph_nodes(lambda *a: fitness.steps(*a, n=1),
                         (genome, *carry), 1)
    with _OpCounter() as ops:
        fitness.steps(genome, *carry, n=1)
    out[algo] = {'history': hist, 'generation_s': gen_s,
                 'fitness_s': fitness_s, 'holdout_s': holdout_s,
                 'evolve_s': evolve_s, 'decode_s': decode_s,
                 'env_steps_per_s': steps / fitness_s,
                 'nodes_per_env_step': nodes, 'ops_per_env_step': ops.n,
                 'champion_pop': int(champ[0].shape[0])}
    log(f'[evo] {algo} at {EVO_POP} x {EVO_REPS} envs x '
        f'{pheno_cfg.max_steps} steps: seconds per generation {gen_s} (the '
        f'first with two graph captures); apart on the last population: '
        f'fitness {fitness_s:.3f} s ({steps / fitness_s:.4g} env-steps/s), '
        f'holdout ({pheno_cfg.topk} x {pheno_cfg.holdout_reps} envs) '
        f'{holdout_s:.3f} s, evolve {evolve_s * 1e3:.1f} ms'
        + (f', decode {decode_s * 1e3:.1f} ms' if decode else '')
        + f'; CUDA graph (nodes, kernel nodes) per network + env step '
        f'{nodes}, {ops.n} ATen operations')


def _evolve_card_vs_cpu(out):
    """One evolve step of the full-width NEAT population from the same
    genome, fitness and key on the card and on the CPU."""
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.core.tree import tree_map
    from gym_copter_tpu_torch.learn import neuroevolution as ne

    cfg = ne.NeatConfig(pop_size=EVO_POP, episode_reps=EVO_REPS, hidden=16)
    cpu = torch.device('cpu')
    genome = ne.init_population(prng.PRNGKey(0, cpu), 10, 4, cfg)
    # many ties, as early generations have
    fit = torch.round(prng.normal(prng.PRNGKey(1, cpu), (EVO_POP,)) * 3)
    card = tree_map(lambda x: x.cuda(), genome)
    for a, b in zip(ne.parents(cfg, fit, prng.PRNGKey(2, cpu),
                               torch.float32),
                    ne.parents(cfg, fit.cuda(), prng.PRNGKey(2, 'cuda'),
                               torch.float32)):
        if not torch.equal(a, b.cpu()):
            raise AssertionError('tournament or crossover draws differ')
    want = ne.make_evolve_fn(cfg)(genome, fit, prng.PRNGKey(2, cpu))
    got = ne.make_evolve_fn(cfg)(card, fit.cuda(), prng.PRNGKey(2, 'cuda'))
    worst = 0.0
    for name, a, b in zip(want._fields, want, got):
        if name.startswith('m'):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f'evolve on card and CPU: {name} '
                                     f'differs')
        else:
            worst = max(worst, float((a - b.cpu()).abs().max()))
    if worst > 1e-5:
        raise AssertionError(f'evolve weights differ by {worst}')
    out['evolve_card_vs_cpu_max_abs'] = worst
    log(f'[evo] one evolve of {EVO_POP} float32 genomes on the card and on '
        f'the CPU (same genome, tied fitness, key): tournament parents, '
        f'crossover flags, elites and masks equal; weights within {worst:.3g}'
        f' (held to 1e-5)')


def _experts(out):
    """Every PID_POLICIES expert at 4096 envs x 1000 steps, graphed."""
    from gym_copter_tpu_torch.control import heuristics
    from gym_copter_tpu_torch.core import constants as C

    out['experts'] = {}
    for name in heuristics.PID_POLICIES:
        run, sec = _timed(lambda: heuristics.run_expert(
            name, EXPERT_ENVS, EXPERT_STEPS))
        end = run.end_x
        on_pad = float(((end[C.STATE_Z].abs() < 1.0)
                        & (torch.sqrt(end[C.STATE_X] ** 2
                                      + end[C.STATE_Y] ** 2) < 2.0)
                        & run.done_seen).float().mean())
        rec = {'median_return': float(torch.quantile(run.total, 0.5)),
               'done_share': float(run.done_seen.float().mean()),
               'on_pad_share': on_pad, 'seconds': sec}
        out['experts'][name] = rec
        log(f'[evo] expert {name}: {EXPERT_ENVS} envs x {EXPERT_STEPS} '
            f'steps graphed in {sec:.2f} s; median return '
            f'{rec["median_return"]:.1f}, episodes ended '
            f'{rec["done_share"]:.3f}, on the pad {on_pad:.3f}')
        if not torch.isfinite(run.total).all():
            raise AssertionError(f'expert {name}: returns not finite')
    lander, hover = out['experts']['Lander3D-v0'], out['experts']['Hover3D-v0']
    # tests/test_pid.py: median > 150 and 6 of 8 on the pad; median > 900
    if lander['median_return'] <= 150 or lander['on_pad_share'] < 0.75:
        raise AssertionError(f'lander3d_pid: {lander}')
    if hover['median_return'] <= 900:
        raise AssertionError(f'hover3d_pid: {hover}')


def _adaptive(out):
    """adaptive.run over the wind sweep, PD and adaptive, held to
    tests/test_adaptive.py's thresholds."""
    from gym_copter_tpu_torch.control.heuristics import hover_motor_value
    from gym_copter_tpu_torch.core import vehicles
    from gym_copter_tpu_torch.core.types import EnvParams
    from gym_copter_tpu_torch.learn import adaptive

    params = EnvParams(vehicle=vehicles.DJI_PHANTOM)
    cfg = adaptive.AdaptiveConfig()
    pd, pd_s = _timed(lambda: adaptive.run(params, ADAPTIVE_WINDS,
                                           ADAPTIVE_STEPS, adapt=False))
    ad, ad_s = _timed(lambda: adaptive.run(params, ADAPTIVE_WINDS,
                                           ADAPTIVE_STEPS))
    pd_err = adaptive.tracking_error(pd, cfg).cpu()
    ad_err = adaptive.tracking_error(ad, cfg).cpu()
    u_final = ad['u_extra'][-200:].mean(0).cpu()
    hover = hover_motor_value(params)
    diffs = torch.diff(u_final)
    out['adaptive'] = {'pd_err': pd_err.tolist(), 'ad_err': ad_err.tolist(),
                       'u_extra_final': u_final.tolist(), 'pd_s': pd_s,
                       'adaptive_s': ad_s}
    log(f'[evo] adaptive, winds {list(ADAPTIVE_WINDS)} N, {ADAPTIVE_STEPS} '
        f'steps graphed: tracking error PD {pd_err.tolist()} m ({pd_s:.2f} '
        f's), adaptive {ad_err.tolist()} m ({ad_s:.2f} s); learned thrust '
        f'{u_final.tolist()} (hover {hover:.4f})')
    if not ((pd_err > 1.0).all() and (ad_err < 0.2).all()
            and (ad_err < pd_err / 5.0).all()
            and ((diffs < 0).all() or (diffs > 0).all())
            and abs(float(u_final[2]) - hover) < 0.5 * hover):
        raise AssertionError(f'adaptive thresholds: {out["adaptive"]}')


def _mars(out):
    """The blade-element hover anchor holds altitude for 100 steps; the
    Mars PPO learning smoke, graphed, in float64 follows the JAX package's
    float64 run of it and gains more than 40 over its first evaluation,
    and in float32 gives finite evaluations.

    The bar is held in float64 because there it is the algorithm's: the
    port and JAX follow one trajectory to rounding, where in float32 any
    two implementations part within 20 updates and one seed's gain is a
    draw (PERF.md, PR 11)."""
    from gym_copter_tpu_torch.control.heuristics import hover_motor_value
    from gym_copter_tpu_torch.core import constants as C
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.envs import base, tasks
    from gym_copter_tpu_torch.learn import ppo

    params = tasks.PRESET_PARAMS['Hover3DMars-v0']()
    params = params._replace(task=params.task._replace(
        initial_random_force=0.0))
    ids = torch.arange(8, dtype=torch.int32, device='cuda')
    key = prng.PRNGKey(0, 'cuda')
    state, _ = base.reset(key, ids, torch.zeros_like(ids), params,
                          tasks.HOVER_3D)
    action = torch.full((4, 8), hover_motor_value(params), device='cuda')
    for _ in range(100):
        state, ts = base.step(state, action, key, ids, params, tasks.HOVER_3D)
    z = ts.x[C.STATE_Z].cpu()
    dz = ts.x[C.STATE_Z_DOT].cpu()
    if (z + 10.0).abs().max() > 0.05 or dz.abs().max() > 0.02:
        raise AssertionError(f'Mars hover anchor drifts: z {z}, dz {dz}')
    out['mars'] = {'hover_z_err': float((z + 10.0).abs().max()),
                   'hover_dz': float(dz.abs().max())}
    log(f'[evo] Mars: the blade-element hover anchor holds 10 m for 100 '
        f'steps (|z err| {out["mars"]["hover_z_err"]:.4f} m, |dz| '
        f'{out["mars"]["hover_dz"]:.4f} m/s)')

    jax_run = json.loads(MARS_JAX_F64.read_text())
    hists = {}
    for dtype in (torch.float64, torch.float32):
        hist = []
        _, sec = _timed(lambda: ppo.train(
            'Lander3DMars-v0', num_envs=MARS_ENVS, num_updates=MARS_UPDATES,
            seed=jax_run['seed'], cfg=ppo.PPOConfig(**MARS_PPO),
            log_every=jax_run['log_every'], dtype=dtype,
            callback=lambda i, m: hist.append(dict(m, update=i))))
        evals = [h['eval_return'] for h in hist]
        name = str(dtype).split('.')[1]
        hists[name] = hist
        run = out['mars'][name] = {'evals': evals,
                                   'gain': max(evals) - evals[0],
                                   'train_s': sec}
        log(f'[evo] Mars PPO on Lander3DMars-v0 in {name} ({MARS_ENVS} '
            f'envs, {MARS_UPDATES} updates, seed {jax_run["seed"]}, '
            f'graphed) in {sec:.1f} s: eval returns '
            f'{[round(e, 2) for e in evals]}, best - first '
            f'{run["gain"]:.2f}')
        if len(evals) != len(jax_run['history']) or not all(
                math.isfinite(e) for e in evals):
            raise AssertionError(f'Mars {name} evals: {evals}')
    f64 = out['mars']['float64']
    worst = {}
    for got, want in zip(hists['float64'], jax_run['history']):
        if got['update'] != want['update']:
            raise AssertionError(f'Mars float64 evaluated at update '
                                 f'{got["update"]}, JAX at {want["update"]}')
        for k, w in want.items():
            if k == 'update':
                continue
            rtol = MARS_EVAL_RTOL if k == 'eval_return' else MARS_METRIC_RTOL
            atol = 0.0 if k == 'eval_return' else MARS_METRIC_ATOL
            gap = abs(got[k] - w)
            worst[k] = max(worst.get(k, 0.0), gap / max(abs(w), 1e-300))
            if not gap <= rtol * abs(w) + atol:
                raise AssertionError(
                    f'Mars float64 {k} at update {want["update"]}: '
                    f'{got[k]} against JAX\'s {w}')
    f64['largest_rel_to_jax'] = worst
    log(f'[evo] Mars float64 against the JAX package\'s float64 run '
        f'(gain {jax_run["gain"]:.2f}): largest relative gap per metric '
        + ', '.join(f'{k} {v:.2e}' for k, v in worst.items())
        + f' (evals held to {MARS_EVAL_RTOL}, metrics to '
        f'{MARS_METRIC_RTOL}); best - first {f64["gain"]:.2f} (must exceed '
        f'{MARS_GAIN}); float32 best - first '
        f'{out["mars"]["float32"]["gain"]:.2f} (printed, not held)')
    if not f64['gain'] > MARS_GAIN:
        raise AssertionError(f'no Mars learning: {f64["evals"]}')


def evo_phase():
    """[evo]: the evolutionary learners and the experts on the card (see
    the module docstring, phase 5f); returns its record, with the fused
    kernel's launches in the phase (0: every path here steps the env under
    a changing action)."""
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    out = {}
    fr.fused_rollout.launches = 0
    t0 = time.perf_counter()
    _champions(out)
    for algo in ('neat', 'hyperneat'):
        _evolution(out, algo)
    _evolve_card_vs_cpu(out)
    _experts(out)
    _adaptive(out)
    _mars(out)
    out['launches'] = fr.fused_rollout.launches
    out['phase_s'] = time.perf_counter() - t0
    log(f'[evo] {out["phase_s"]:.1f} s; fused_rollout launches in the phase '
        f'{out["launches"]}')
    return out


# the [gym] phase: the float64 card env against the numpy oracle, a few
# envs through auto-resets (largest gap allowed: the CPU contract's)
GYM_ORACLE_ENVS, GYM_ORACLE_STEPS = 4, 1000
GYM_ORACLE_TOL = 1e-9
GYM_VISUAL_B = 4096
GYM_VISUAL = (('vision', 16), ('vision', 64), ('dvs', 16))
GYM_VISUAL_CHECK, GYM_VISUAL_TIMED, GYM_VISUAL_ROUNDS = 100, 200, 3
# the B = 1 adapter's return on the card against the CPU's, float32
GYM_SINGLE_RTOL = 1e-5


def _gym_oracle(out):
    cases = _cases()
    device = torch.device('cuda')
    out['oracle'] = {}
    for name in ('Lander-v0', 'Lander3D-v0', 'Hover3D-v0'):
        (gap, ended), sec = _timed(lambda: cases.oracle_gap(
            name, GYM_ORACLE_ENVS, GYM_ORACLE_STEPS, device))
        out['oracle'][name] = {'max_gap': gap, 'episodes_ended': ended,
                               'seconds': sec}
        log(f'[gym] oracle: {name} float64 on the card, {GYM_ORACLE_ENVS} '
            f'envs x {GYM_ORACLE_STEPS} steps ({ended} episodes ended): '
            f'done and status equal, largest gap {gap:.3e} (limit '
            f'{GYM_ORACLE_TOL:g}); {sec:.1f} s')
        if not gap <= GYM_ORACLE_TOL or ended == 0:
            raise AssertionError(f'{name}: card env against the oracle: '
                                 f'gap {gap}, {ended} episodes ended')


def _gym_single(out):
    """The adapter's B = 1 core (compat/single.py) on the card."""
    import numpy as np

    from gym_copter_tpu_torch.compat.single import SingleCopterEnv
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL

    cases = _cases()
    action = np.full(4, MOTORVAL, np.float32)
    graphed, g_s = cases.single_episode(SingleCopterEnv('Lander-v0'), action)
    eager, e_s = cases.single_episode(
        SingleCopterEnv('Lander-v0', graphed=False), action)
    cpu, c_s = cases.single_episode(SingleCopterEnv('Lander-v0',
                                                    device='cpu'), action)
    total = sum(r for _, r, _ in graphed)
    cpu_total = sum(r for _, r, _ in cpu)
    equal = cases.same_episode(graphed, eager)
    legacy, l_s = cases.single_episode(
        SingleCopterEnv('Lander-v0', legacy_seeding=True,
                        dtype=torch.float64), action.astype(np.float64))
    out['single'] = {'steps': len(graphed), 'return': total,
                     'cpu_return': cpu_total, 'graphed_equals_eager': equal,
                     'graphed_us': g_s * 1e6, 'eager_us': e_s * 1e6,
                     'cpu_us': c_s * 1e6, 'legacy_f64_steps': len(legacy),
                     'legacy_f64_return': sum(r for _, r, _ in legacy),
                     'legacy_f64_us': l_s * 1e6}
    log(f'[gym] single env, Lander-v0 at {MOTORVAL}: {len(graphed)} steps, '
        f'return {total:.6f} (CPU {cpu_total:.6f}); graphed '
        f'{g_s * 1e6:.1f} us per step, eager {e_s * 1e6:.1f} (CPU '
        f'{c_s * 1e6:.1f}); graphed equals eager: {equal}')
    log(f'[gym] single env, float64 legacy seeding (np.random kick): '
        f'{len(legacy)} steps, return {out["single"]["legacy_f64_return"]:.6f}'
        f', {l_s * 1e6:.1f} us per step')
    if not equal:
        raise AssertionError('the graphed B = 1 step differs from the eager')
    if (abs(total - cpu_total) > GYM_SINGLE_RTOL * abs(cpu_total)
            or len(graphed) != len(cpu) or not legacy[-1][2]):
        raise AssertionError(f'B = 1 episode: {out["single"]}')


def _gym_visual(out):
    """VisualCopterEnv at 4096 Lander3D envs, graphed: equal to eager over
    GYM_VISUAL_CHECK steps; then, in GYM_VISUAL_ROUNDS turns over all
    configurations, ms per step (median of the rounds) against the env step
    alone in the same kind of graph; images/s and graph nodes per step."""
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL
    from gym_copter_tpu_torch.core.graph import Graph
    from gym_copter_tpu_torch.envs import registry

    cases = _cases()
    device = torch.device('cuda')
    b = GYM_VISUAL_B

    def replay_ms(graph, carry):
        n = len(carry)
        for _ in range(3):
            carry = graph(*carry)[:n]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GYM_VISUAL_TIMED):
            carry = graph(*carry)[:n]
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / GYM_VISUAL_TIMED, carry

    env = registry.make('Lander3D-v0', num_envs=b, seed=0)
    action = torch.full((4, b), MOTORVAL, device=device)

    def env_step(state, acc):
        state, ts = env.step(state, action)
        return state, acc + ts.reward.sum()

    carry = (env.reset()[0], torch.zeros((), device=device))
    runs = {'env': [Graph(env_step, warmup=1), carry,
                    _graph_nodes(env_step, carry, warmup=1)[0], []]}
    out['visual'] = {'envs': b}
    for kind, res in GYM_VISUAL:
        differ, graph, carry = cases.visual_graphed_vs_eager(
            'Lander3D-v0', b, res, kind == 'dvs', GYM_VISUAL_CHECK, device)
        log(f'[gym] visual: {kind} res {res}: graphed images equal the '
            f'eager ones in {GYM_VISUAL_CHECK - differ} of '
            f'{GYM_VISUAL_CHECK} steps')
        if differ:
            raise AssertionError(f'{kind} res {res}: graphed images differ')
        carry = tuple(carry)
        runs[f'{kind}{res}'] = [graph, carry,
                                _graph_nodes(graph.fn, carry, warmup=1)[0],
                                []]
    for _ in range(GYM_VISUAL_ROUNDS):
        for run in runs.values():
            ms, run[1] = replay_ms(run[0], run[1])
            run[3].append(ms)
    env_ms = sorted(runs['env'][3])[GYM_VISUAL_ROUNDS // 2]
    for name, (_, _, nodes, times) in runs.items():
        ms = sorted(times)[GYM_VISUAL_ROUNDS // 2]
        out['visual'][name] = {'ms': ms, 'ms_rounds': times,
                               'images_per_s': b / ms * 1e3, 'nodes': nodes}
        log(f'[gym] visual: {name} at {b} envs: {ms:.4f} ms per step '
            f'({ms - env_ms:+.4f} over the env step; rounds '
            f'{", ".join(f"{t:.4f}" for t in times)}), '
            f'{b / ms * 1e3:.4g} {"env steps" if name == "env" else "images"}'
            f'/s, {nodes} graph nodes')
    del runs
    _gym_pixels(out, device)


def _gym_pixels(out, device):
    """Res-16 images of 4096 random poses on the card and on the CPU: the
    pixels that differ, and why (CUDA's float32 sin/cos round some angles
    apart from the CPU's, which moves a homography entry)."""
    import numpy as np

    from gym_copter_tpu_torch.sensors.vision import RAD_PER_DEG, VisionSensor

    rng = np.random.default_rng(0)
    poses = np.zeros((6, GYM_VISUAL_B), np.float32)
    poses[0:2] = rng.uniform(-3, 3, (2, GYM_VISUAL_B))
    poses[2] = rng.uniform(1, 10, GYM_VISUAL_B)
    poses[3:6] = rng.uniform(-30, 30, (3, GYM_VISUAL_B))
    host = torch.from_numpy(poses)
    card = VisionSensor(res=16).get_images(host.to(device)).cpu()
    cpu = VisionSensor(res=16, device='cpu').get_images(host)
    pixels = int((card != cpu).sum())
    rad = host[3:6] * RAD_PER_DEG
    rad_card = host[3:6].to(device) * RAD_PER_DEG
    n_rad = int((rad_card.cpu() != rad).sum())
    trig = int((torch.sin(rad_card).cpu() != torch.sin(rad)).sum()
               + (torch.cos(rad_card).cpu() != torch.cos(rad)).sum())
    out['pixels_card_vs_cpu'] = {'pixels': pixels, 'of': card.numel(),
                                 'radians_differing': n_rad,
                                 'sin_cos_differing': trig,
                                 'of_angles': 2 * rad.numel()}
    log(f'[gym] res-16 images of {GYM_VISUAL_B} random poses, card against '
        f'CPU: {pixels} of {card.numel()} pixels differ; the degree-to-'
        f'radian multiply differs on {n_rad} of {rad.numel()} angles, CUDA '
        f'and CPU sin/cos on {trig} of the {2 * rad.numel()} values (the '
        f'[traps] rounding)')
    if n_rad:
        raise AssertionError('radians round differently on the card')


def _gym_demos(out):
    """The demos' main() in-process on the card, their prints kept."""
    import contextlib
    import io
    import tempfile

    from gym_copter_tpu_torch.demos import hover, lander, target

    def run(label, fn, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = fn(argv)
        sec = time.perf_counter() - t0
        last = [ln for ln in buf.getvalue().splitlines() if ln][-1]
        out['demos'][label] = {'result': result, 'seconds': sec,
                               'last_line': last}
        log(f'[gym] demo {label}: {sec:.2f} s; {last}')
        return result, buf.getvalue()

    out['demos'] = {}
    with tempfile.TemporaryDirectory() as d:
        csv = str(Path(d) / 'lander.csv')
        total, text = run('lander --vision --res 16 --save', lander.main,
                          ['--nodisplay', '--vision', '--res', '16',
                           '--save', csv])
        rows = len(Path(csv).read_text().splitlines())
    cpu_total, _ = run('lander on the CPU', lander.main,
                       ['--nodisplay', '--device', 'cpu'])
    run('lander --dvs --res 16', lander.main,
        ['--nodisplay', '--dvs', '--res', '16'])
    run('lander --freeze', lander.main,
        ['--nodisplay', '--freeze', '2,1,8,10,0'])
    hover_total, _ = run('hover', hover.main, ['--nodisplay'])
    run('target', target.main, ['--nodisplay'])
    log(f'[gym] demo lander: return {total:.6f} on the card, '
        f'{cpu_total:.6f} on the CPU; its CSV has {rows} lines')
    if (abs(total - cpu_total) > GYM_SINGLE_RTOL * abs(cpu_total)
            or rows < 100 or 'vision:' not in text
            or not hover_total > 900):
        raise AssertionError(f'demos: {out["demos"]}')


def gym_phase(smi):
    """[gym]: the user-facing surface on the card (the module docstring,
    phase 5g); returns its record, with the fused kernel's launches in the
    phase (0: every path here steps the env under a per-step action)."""
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    out = {}
    fr.fused_rollout.launches = 0
    t0 = time.perf_counter()
    _gym_oracle(out)
    _gym_single(out)
    _gym_visual(out)
    _gym_demos(out)
    out['launches'] = fr.fused_rollout.launches
    out['phase_s'] = time.perf_counter() - t0
    out['card'] = smi
    log(f'[gym] {out["phase_s"]:.1f} s; fused_rollout launches in the phase '
        f'{out["launches"]}')
    if out['launches'] != 0:
        raise AssertionError('the gym path launched the fused kernel')
    return out


# the first four weights of each layer's first row of the JAX package's
# init_params(PRNGKey(0), 10, 4, PPOConfig(hidden=128), float32), Lander3D's
# sizes, computed by gym_copter_tpu on the CPU; held to INIT_TOL, the CPU
# tests' float32 tolerance (tests/test_torch_init_bf16.py)
JAX_INIT_SEED0 = {
    'actor': ((-0.0788092092, 0.0914243534, -0.0307461880, 0.1668087393),
              (-0.1591252536, -0.0479176082, -0.1578520983, 0.1337676644),
              (-0.000885984045, 0.00107619248, -0.00172114489,
               0.000928333146)),
    'critic': ((0.0254833326, -0.0948290601, -0.1376647353, -0.0443230122),
               (-0.1695650220, -0.0726697370, 0.0390017331, -0.1521614194),
               (0.0866849422, 0.1029118001, -0.1179335490, -0.1084475145)),
}
INIT_TOL = 1e-5
# bf16 operands, float32 products: the card's products against the CPU's,
# per layer (float32 sums in another order) and through the whole MLP (a
# last-bit difference flips a bf16 rounding of the next layer's input;
# the CPU against JAX: 9.7e-4)
BF16_LAYER_TOL, BF16_MLP_TOL = 1e-5, 2e-3
# [multihost]: the launcher's run at the recipe on Lander3D-v0, 3 updates;
# two gloo hosts' reward_per_step against one NCCL host's, whose
# gradients sum in another order
MULTIHOST_UPDATES = 3
MULTIHOST_RTOL = 1e-3


def _init_bf16(out):
    """The PPO init from a key on the card (drawn on the host) against JAX's
    recorded values, and the bf16 products on the card against the CPU's;
    TF32 float32 products raise."""
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.learn import ppo

    cfg = ppo.PPOConfig(hidden=128)
    card = ppo.init_params(prng.PRNGKey(0, 'cuda'), 10, 4, cfg)
    host = ppo.init_params(prng.PRNGKey(0, 'cpu'), 10, 4, cfg)
    if not all(a.is_cuda and torch.equal(a.cpu(), b) for a, b in
               zip(card.leaves(), host.leaves())):
        raise AssertionError('the init on the card differs from the CPU\'s')
    gap = max(abs(float(layer.w[0, j]) - want)
              for net in ('actor', 'critic')
              for layer, row in zip(getattr(card, net), JAX_INIT_SEED0[net])
              for j, want in enumerate(row))
    out['init_vs_jax_max_abs'] = gap
    if gap > INIT_TOL:
        raise AssertionError(f'init_params(PRNGKey(0)) is {gap} from JAX\'s')
    log(f'[init] init_params(PRNGKey(0), 10, 4, hidden 128) float32 on the '
        f'card: drawn on the host, equal to the CPU\'s; actor w[0][0, :4] '
        f'{card.actor[0].w[0, :4].tolist()}; largest gap to JAX\'s recorded '
        f'24 values {gap:.3g} (held to {INIT_TOL})')

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((10, 4096), generator=gen)
    layer_gap = mlp_gap = f32_gap = 0.0
    for layers in ppo.unflatten(host.leaves())[:2]:
        dev = [(w.cuda(), b.cuda()) for w, b in layers]
        xs = x
        for (w, b), (wd, bd) in zip(layers, dev):
            want = ppo.mlp_apply([(w, b)], xs, 'bfloat16')
            got = ppo.mlp_apply([(wd, bd)], xs.cuda(), 'bfloat16').cpu()
            layer_gap = max(layer_gap, float((got - want).abs().max()))
            xs = torch.tanh(want)
        for dt in ('bfloat16', None):
            want = ppo.mlp_apply(layers, x, dt)
            got = ppo.mlp_apply(dev, x.cuda(), dt).cpu()
            g = float((got - want).abs().max())
            if dt is None:
                f32_gap = max(f32_gap, g)
            else:
                mlp_gap = max(mlp_gap, g)
    out.update(bf16_layer_max_abs=layer_gap, bf16_mlp_max_abs=mlp_gap,
               f32_mlp_max_abs=f32_gap)
    if layer_gap > BF16_LAYER_TOL or mlp_gap > BF16_MLP_TOL:
        raise AssertionError(f'bf16 products on the card: per layer '
                             f'{layer_gap}, whole MLP {mlp_gap}')
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ppo.mlp_apply(dev, x.cuda())
    except RuntimeError:
        pass
    else:
        raise AssertionError('mlp_apply computed with TF32 allowed')
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f'[init] bf16 operands, float32 products on 4096 columns, card '
        f'against CPU: per layer {layer_gap:.3g} (held to {BF16_LAYER_TOL}),'
        f' actor and critic {mlp_gap:.3g} (held to {BF16_MLP_TOL}); the '
        f'float32 path {f32_gap:.3g}; with TF32 allowed mlp_apply raises')


def _launcher(hosts, envs_per_host, backend, timeout_s=600):
    """`python -m gym_copter_tpu_torch.parallel.launch --coordinator` as
    `hosts` host processes of one rank each over loopback, the card's
    world; returns (process 0's report, seconds).  Any host that fails or
    outlives the timeout fails the phase; every host is ended."""
    import os
    import socket
    import tempfile

    root = Path(__file__).resolve().parent
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    with tempfile.TemporaryDirectory() as tmp:
        out = f'{tmp}/report.json'
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, '-m', 'gym_copter_tpu_torch.parallel.launch',
             '--coordinator', f'127.0.0.1:{port}', '--num-processes',
             str(hosts), '--process-id', str(i), '--nproc-per-node', '1',
             '--backend', backend, '--device', 'cuda', '--env',
             'Lander3D-v0', '--envs-per-host', str(envs_per_host),
             '--updates', str(MULTIHOST_UPDATES), '--timeout',
             str(timeout_s), '--out', out],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(hosts)]
        try:
            texts = [p.communicate(timeout=timeout_s + 60)[0]
                     for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t0
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f'launcher hosts {bad} failed:\n'
                               + '\n'.join(texts[i][-4000:] for i in bad))
        with open(out) as f:
            report = json.load(f)
    return report, seconds


def multihost_phase():
    """[multihost]: the JAX-keyed init and the bf16 products on the card;
    then the multi-host launcher as (a) one host, one rank, NCCL, graphed,
    4096 envs and (b) two hosts over loopback, gloo, sharing the card,
    2 x 2048 envs, eager; (b) held to (a).  Returns its record, with the
    fused kernel's launches on every rank of both."""
    out = {}
    _init_bf16(out)
    runs = {}
    for name, hosts, backend in (('nccl', 1, 'nccl'), ('gloo', 2, 'gloo')):
        report, seconds = _launcher(hosts, MAIN_B // hosts, backend)
        report['command_s'] = seconds
        runs[name] = report
        launches = [s['launches'] for s in report['per_shard']]
        graphed = backend == 'nccl'
        if (report['hosts'], report['ranks'], report['devices']) != (
                hosts, hosts, hosts) or report['graphed'] != graphed \
                or report['global_envs'] != MAIN_B \
                or report['update_idx'] != MULTIHOST_UPDATES \
                or not report['totals_equal_one_rank'] \
                or min(launches) < 1:
            raise AssertionError(f'[multihost] {name}: {report}')
        log(f'[multihost] {hosts} host(s) x 1 rank, {backend}, '
            f'{"graphed" if graphed else "eager"}, Lander3D-v0 at '
            f'{MAIN_B} envs, the recipe, {MULTIHOST_UPDATES} updates: step '
            f'{report["step_s"]:.4f} s = {report["env_steps_per_sec"]:.4g} '
            f'env-steps/s; all-reduce of {report["allreduce_bytes"]} B '
            f'{report["allreduce_ms"]:.3f} ms; reward_per_step '
            f'{report["reward_per_step"]!r}; fused_rollout launches per '
            f'rank {launches}; {seconds:.1f} s with the start-up')
        log('[multihost] ' + json.dumps(report))
    a, b = runs['nccl'], runs['gloo']
    gaps = {k: abs(b['metrics'][k] - v) / max(abs(v), 1e-12)
            for k, v in a['metrics'].items()}
    out.update(runs=runs, metrics_rel_gap=gaps, launches=sum(
        s['launches'] for r in runs.values() for s in r['per_shard']))
    if abs(b['reward_per_step'] - a['reward_per_step']) > \
            MULTIHOST_RTOL * abs(a['reward_per_step']):
        raise AssertionError(f'two hosts\' reward_per_step '
                             f'{b["reward_per_step"]} against one host\'s '
                             f'{a["reward_per_step"]}')
    log(f'[multihost] two gloo hosts against one NCCL host: global_envs and '
        f'update_idx equal; relative gaps of the last update\'s metrics '
        + ', '.join(f'{k} {v:.3g}' for k, v in gaps.items())
        + f' (reward_per_step held to {MULTIHOST_RTOL}); fused_rollout '
        f'launches {out["launches"]}')
    return out


def _kernel_label(name):
    """A CUDA kernel's name without its template boilerplate: the kernel,
    and for PyTorch's elementwise kernels the op (its `*_kernel_cuda` or
    its innermost functor)."""
    import re

    base = re.match(r'(?:void )?(?:at::native::)?(\w+)', name).group(1)
    op = re.search(r'(\w+_kernel_cuda\w*)', name)
    functors = re.findall(r'(\w+Functor\w*)', name)
    detail = op.group(1) if op else (functors[-1] if functors else '')
    return f'{base}[{detail}]' if detail else name[:80]


def trace_phase(step, ts):
    """[trace]: a torch.profiler trace of two graphed train steps: the
    device's busy and idle shares and the top kernels by device time;
    raises if the trace holds no CUDA kernel.  The profiler slows the
    host's enqueue, so the same two steps are also timed without it."""
    import tempfile

    from gym_copter_tpu_torch.utils import profiling

    def two_steps():
        nonlocal ts
        for _ in range(2):
            ts, _ = step(ts)
        torch.cuda.synchronize()

    two_steps()
    t0 = time.perf_counter()
    two_steps()
    out = {'unprofiled_ms': (time.perf_counter() - t0) * 1e3}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            two_steps()
        out['trace_s'] = time.perf_counter() - t0
        out.update(profiling.device_busy(f'{tmp}/{profiling.TRACE_FILE}',
                                         top=8))
    out['top'] = [[_kernel_label(n), t, c] for n, t, c in out['top']]
    out['busy_share_of_unprofiled'] = out['busy_us'] / 1e3 / out[
        'unprofiled_ms']
    log(f'[trace] 2 graphed train steps under torch.profiler: window '
        f'{out["window_us"] / 1e3:.2f} ms, device busy '
        f'{out["busy_us"] / 1e3:.2f} ms = {out["busy_share"]:.2%} of it, '
        f'idle {1 - out["busy_share"]:.2%}; the same steps take '
        f'{out["unprofiled_ms"]:.2f} ms without the profiler, of which the '
        f'traced busy time is {out["busy_share_of_unprofiled"]:.2%}; '
        f'{out["kernels"]} kernels; top by device time: '
        + '; '.join(f'{n} {t / 1e3:.2f} ms x{c}' for n, t, c in out['top'])
        + f' ({out["trace_s"]:.1f} s with the profiler)')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--sweep-only', action='store_true',
                    help='run only the device phase and the timing sweep')
    ap.add_argument('--ppo-only', action='store_true',
                    help='run only the device phase and the PPO phase')
    ap.add_argument('--dist-only', action='store_true',
                    help='run only the device, PPO, dist, ckpt and trace '
                         'phases')
    ap.add_argument('--evo-only', action='store_true',
                    help='run only the device phase and the evo phase')
    ap.add_argument('--gym-only', action='store_true',
                    help='run only the device phase and the gym phase')
    ap.add_argument('--multihost-only', action='store_true',
                    help='run only the device phase and the multihost '
                         'phase')
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
    if args.ppo_only:
        log(json.dumps({'ppo': ppo_phase()[0], 'card': smi}))
        return 0
    if args.evo_only:
        log(json.dumps({'evo': evo_phase(), 'card': smi}))
        return 0
    if args.gym_only:
        log(json.dumps({'gym': gym_phase(smi)}))
        return 0
    if args.multihost_only:
        log(json.dumps({'multihost': multihost_phase(), 'card': smi}))
        return 0
    if args.dist_only:
        _, step, ts = ppo_phase()
        log(json.dumps({'dist': dist_phase(step),
                        'ckpt': ckpt_phase(step, ts, smi),
                        'trace': trace_phase(step, ts), 'card': smi}))
        return 0
    device = torch.device('cuda')
    straight = build_phase()
    traps_phase(device)
    parity_err = parity_phase(device)
    launches, main_err, plain_ms, main = main_path_phase()
    ppo_out, step, ts = ppo_phase()
    log(json.dumps({'ppo': ppo_out, 'card': smi}))
    dist_out = dist_phase(step)
    ckpt_out = ckpt_phase(step, ts, smi)
    trace_out = trace_phase(step, ts)
    log(json.dumps({'dist': dist_out, 'ckpt': ckpt_out, 'trace': trace_out,
                    'card': smi}))
    evo_out = evo_phase()
    log(json.dumps({'evo': evo_out, 'card': smi}))
    gym_out = gym_phase(smi)
    log(json.dumps({'gym': gym_out}))
    multihost_out = multihost_phase()
    log(json.dumps({'multihost': multihost_out, 'card': smi}))
    times = timing_phase(main, straight, max_mhz)
    log(f'[time] card: {smi}')
    log(json.dumps({'timings': times, 'card': smi}))
    bench_out = bench_phase(times)
    log(json.dumps({'bench': bench_out}))
    kernels = [{
        'name': 'fused_rollout',
        'route': 'cuda',
        'source': 'gym_copter_tpu_torch/ops/csrc/fused_rollout.cu',
        'replaces': 'gym_copter_tpu/ops/pallas_rollout.py:426',
        'launches': launches['fused_rollout'],
        'launches_by_path': {'main': launches['fused_rollout'],
                             'ppo': ppo_out['launches']['fused_rollout'],
                             'dist': dist_out['launches'],
                             'evo': evo_out['launches'],
                             'gym': gym_out['launches'],
                             'multihost': multihost_out['launches'],
                             'bench': bench_out['launches']},
        'lanes': times['lanes'],
        'bit_exact': True,
        'max_abs_err': max(parity_err, main_err),
        'ms': times['ms'],
        'plain_ms': plain_ms,
        'bound_ms': times['bound_ms'],
        'bound_by': times['bound_by'],
        'issue_ms': times['issue_ms'],
        'library_ms': None,
    }]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ('ms', 'plain_ms',
                                                  'bound_ms')):
            raise AssertionError(f'non-finite time for {k["name"]}')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
