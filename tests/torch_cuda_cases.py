"""The cases on which the port's CUDA kernel is held against its plain
PyTorch version on the card, used by tests/test_torch_cuda.py and by
chip_smoke.py (its main path's `compare`, `step_differs` and
`clip_adam_case`, its launcher's `launch_hosts`).  Imports nothing of
JAX.

Each case is every task kind with and without random resets, Lander3D at
4096 envs, and batches that are not a multiple of 128 (1000 envs) or of
8 (4099).  Kernel and plain version must agree bit for bit in every field
(`compare`), at every lanes-per-env choice (`run_kernel`).

The learning-rate schedules of the PPO recipe and of `train()`'s default
floor are held against the CPU's at every count (`schedule_mismatches`).

The optimizer's kernel (ops/csrc/clip_adam.cu, `ClipAdam.step` on the
card) is held against its plain version on the card at Lander3D's and
Hover3D's leaf shapes (`clip_adam_cases`, `clip_adam_mismatches`); the
CPU test of `step` builds its inputs with `clip_adam_case` too.

The env step's kernel (ops/csrc/env_step.cu, `envs/base.step` on the
card) is held against its plain version on the card, `step_reference`,
for every registry id in float32 and float64 at 1, 4096 and 4099 envs,
eagerly and replayed in a captured graph, under actions that end every
episode, end none, or fly into the ground (`env_step_cases`,
`env_step_mismatches`, `env_step_shard_mismatches`).

The JAX package's orbax checkpoint of the PPO recipe after one update
(tests/data/jax_orbax_lander3d/, made by tests/make_jax_orbax_fixture.py)
and its record are read here too (`FIXTURE`, `fixture_record`,
`fixture_template`, `fixture_mismatches`).

The multi-host launcher runs over loopback on the card as separate host
processes (`launch_hosts`).
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

MAIN_B = 4096
ROOT = Path(__file__).resolve().parents[1]


def reset_state(params, spec, b, device, pose=None):
    """The EnvState of `b` envs reset with key 0 at episode 0."""
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.envs import base

    return base.reset(prng.PRNGKey(0, device),
                      torch.arange(b, dtype=torch.int32, device=device),
                      torch.zeros(b, dtype=torch.int32, device=device),
                      params, spec, pose=pose)[0]


def run_kernel(state, action, num_steps, params, spec, seed, lanes):
    """The fused rollout through the kernel with `lanes` lanes per env."""
    from gym_copter_tpu_torch.ops import fused_rollout as fr

    arrays, u, c = fr._prepare(state, action, params, spec, None)
    return fr._finish(state, fr._rollout_cuda(arrays, u, num_steps, seed, c,
                                              lanes=lanes))


def compare(kernel, plain, what):
    """Every output field equal; returns the largest absolute difference of
    the float fields (0.0 when bit-exact)."""
    (sk, tk), (sp, tp) = kernel, plain
    pairs = (('x', sk.dyn.x, sp.dyn.x), ('perturb', sk.dyn.perturb,
                                          sp.dyn.perturb),
             ('prev_shaping', sk.prev_shaping, sp.prev_shaping),
             ('reward_sum', tk['reward_sum'], tp['reward_sum']),
             ('status', sk.dyn.status, sp.dyn.status),
             ('ticks', sk.dyn.ticks, sp.dyn.ticks),
             ('steps', sk.steps, sp.steps),
             ('episode', sk.episode, sp.episode),
             ('episodes', tk['episodes'], tp['episodes']))
    err = 0.0
    for name, a, b in pairs:
        if a.is_floating_point():
            if not torch.isfinite(a).all():
                raise AssertionError(f'{what}: {name} is not finite')
            err = max(err, float((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(
                f'{what}: kernel and plain version differ in {name} '
                f'(max abs diff {float((a.double() - b.double()).abs().max())})')
    return err


def scenarios():
    """(what, spec, params, action, num_steps, pose, seed, batch), after the
    scenarios of the CPU tests."""
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL
    from gym_copter_tpu_torch.core import vehicles
    from gym_copter_tpu_torch.core.types import EnvParams, TaskParams
    from gym_copter_tpu_torch.envs import tasks

    def params(max_steps, force=0.0):
        return EnvParams(vehicle=vehicles.DJI_PHANTOM,
                         task=TaskParams(initial_random_force=force,
                                         max_steps=max_steps))

    simple = tasks._simple_lander_params()
    simple = simple._replace(task=simple.task._replace(max_steps=120))
    mars = tasks._mars_params()
    mars = mars._replace(task=mars.task._replace(max_steps=60))
    low = tasks.LANDER_3D._replace(start_altitude=0.5)
    return [
        ('lander3d-4096-deterministic', tasks.LANDER_3D, params(1000),
         [MOTORVAL] * 4, 2000, None, 0, MAIN_B),
        ('lander3d-4096-random-reset', tasks.LANDER_3D, params(1000, 30.0),
         [MOTORVAL] * 4, 2000, None, 7, MAIN_B),
        ('lander3d-1000-envs', tasks.LANDER_3D, params(200, 30.0),
         [MOTORVAL] * 4, 500, None, 7, 1000),
        ('lander3d-4099-envs', tasks.LANDER_3D, params(200, 30.0),
         [MOTORVAL] * 4, 500, None, 7, 4099),
        ('lander1d', tasks.LANDER_1D, params(50), [MOTORVAL], 120, None, 0,
         128),
        ('lander2d', tasks.LANDER_2D, params(60, 30.0), [MOTORVAL] * 2, 150,
         None, 7, 128),
        ('lander3d-soft-landing', low, params(400), [MOTORVAL] * 4, 300,
         None, 0, 128),
        ('lander3d-crash', low, params(400), [0.0] * 4, 100, None, 0, 128),
        ('hover3d-tilt', tasks.HOVER_3D, params(400), [1.66e-2] * 4, 250,
         (0.0, 0.0, 10.0, 40.0, 0.0), 0, 128),
        ('lander3dsimple-descent', tasks.LANDER_3D_SIMPLE, simple,
         [0.48, 0.0, 0.0], 300, None, 0, 128),
        ('lander3dsimple-free-fall', tasks.LANDER_3D_SIMPLE, simple,
         [-1.0, 0.0, 0.0], 300, None, 0, 128),
        ('althold', tasks.ALTHOLD, params(80), [0.1], 200, None, 0, 128),
        ('takeoff', tasks.TAKEOFF, params(80), [0.02] * 4, 200, None, 0, 128),
        ('distance', tasks.DISTANCE, params(80), [0.02] * 4, 200, None, 0,
         128),
        ('target', tasks.TARGET, params(80), [0.0] * 4, 200, None, 0, 128),
        ('target-crash', tasks.TARGET, params(900), [-1.0] * 4, 250,
         (0.0, 0.0, 8.0, 0.0, 0.0), 0, 128),
        ('lander3dmars-blade', tasks.LANDER_3D, mars, [0.2] * 4, 150, None,
         7, 128),
    ]


def train_state_to(ts, device):
    """A PPO TrainState with every tensor copied to `device`."""
    from gym_copter_tpu_torch.core.tree import tree_map

    return tree_map(lambda t: t.to(device), ts)


def state_tensors(ts):
    """Every tensor of a PPO TrainState, params first, in a fixed order."""
    from gym_copter_tpu_torch.core.tree import tree_leaves

    return tree_leaves(ts)


def state_diff(a, b, what):
    """The largest absolute difference between two PPO TrainStates' float
    tensors (0.0 when bit-equal); raises where an integer or bool tensor
    differs or a float is not finite."""
    err = 0.0
    for i, (x, y) in enumerate(zip(state_tensors(a), state_tensors(b))):
        x, y = x.cpu(), y.cpu()
        if x.is_floating_point():
            if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
                raise AssertionError(f'{what}: tensor {i} is not finite')
            err = max(err, float((x - y).abs().max()))
        elif not torch.equal(x, y):
            raise AssertionError(f'{what}: integer tensor {i} differs')
    return err


# the oracle's motor maps by action size, as tests/test_env_parity.py and
# tests/test_torch_oracle.py give them
ORACLE_MOTOR_MAPS = {
    1: lambda m: [m[0]] * 4,
    2: lambda m: [m[0], m[1], m[1], m[0]],
    3: lambda m: [m[0] - m[1] - m[2], m[0] + m[1] + m[2],
                  m[0] + m[1] - m[2], m[0] - m[1] + m[2]],
    4: lambda m: m,
}


def oracle_gap(name, b, num_steps, device, seed=0):
    """The float64 env `name` on `device`, `b` envs for `num_steps` steps of
    random actions through its auto-resets, each env beside its own
    numpy oracle (compat/numpy_oracle.py) reset with the env's own kick
    for each episode.  Raises where a done flag or status differs; returns
    (largest absolute gap of observations and rewards, episodes ended)."""
    import numpy as np

    from gym_copter_tpu_torch.compat.numpy_oracle import OracleEnv
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.envs import base, registry

    spec, params = registry.resolve_params(name)
    if spec.negate_obs or spec.kind == 'target':
        raise ValueError(f'{name}: the oracle reads the state rows as is')
    key = prng.PRNGKey(seed, device)
    ids = torch.arange(b, dtype=torch.int32, device=device)
    episode = torch.zeros(b, dtype=torch.int32, device=device)
    state, obs = base.reset(key, ids, episode, params, spec,
                            dtype=torch.float64)
    rows = list(spec.obs_indices)

    def kicks(ep):
        return base._initial_forces(key, ids, ep, params,
                                    torch.float64).cpu().numpy()

    oracles = [OracleEnv(params, task_kind=spec.kind,
                         obs_indices=spec.obs_indices,
                         action_size=spec.action_size,
                         motor_map=ORACLE_MOTOR_MAPS[spec.action_size])
               for _ in range(b)]
    force, obs = kicks(episode), obs.cpu().numpy()
    gap = 0.0
    for i, o in enumerate(oracles):
        gap = max(gap, float(np.abs(obs[:, i] - o.reset(
            perturb_force=force[:, i])[0]).max()))
    rng = np.random.default_rng(seed)
    ended = 0
    for t in range(num_steps):
        act = rng.uniform(0, 0.05, (spec.action_size, b))
        state, ts = base.step(state, torch.from_numpy(act).to(device), key,
                              ids, params, spec)
        obs, reward, done, status, x = (v.cpu().numpy() for v in (
            ts.obs, ts.reward, ts.done, ts.status, ts.x))
        force = kicks(state.episode) if done.any() else None
        for i, o in enumerate(oracles):
            o_obs, o_rew, o_done, _, _ = o.step(act[:, i])
            if bool(done[i]) != o_done or int(status[i]) != o.dyn.status:
                raise AssertionError(
                    f'{name} env {i} step {t}: done {bool(done[i])} status '
                    f'{int(status[i])}, oracle {o_done} {o.dyn.status}')
            gap = max(gap, abs(float(reward[i]) - o_rew),
                      float(np.abs(x[rows, i] - o_obs).max()))
            if o_done:
                ended += 1
                o_obs, _ = o.reset(perturb_force=force[:, i])
                gap = max(gap, float(np.abs(obs[:, i] - o_obs).max()))
    return gap, ended


def single_episode(env, action, max_steps=2000, seed=0):
    """One episode of `env` (compat/single.py) from reset(seed=seed) at a
    constant action: ([(obs, reward, done)], seconds per step after the
    first, which may capture a graph)."""
    import time

    env.reset(seed=seed)
    out = [env.step(action)[:3]]
    t0 = time.perf_counter()
    while not out[-1][2] and len(out) < max_steps:
        out.append(env.step(action)[:3])
    return out, (time.perf_counter() - t0) / max(len(out) - 1, 1)


def same_episode(a, b):
    """Two single_episode records equal bit for bit."""
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and x[1] == y[1] and x[2] == y[2]
        for x, y in zip(a, b))


def visual_graphed_vs_eager(name, b, res, dvs, num_steps, device):
    """VisualCopterEnv over `b` envs of `name` at a constant thrust: the
    same `num_steps` through a one-step CUDA graph and eagerly from one
    reset.  Returns (steps whose images differ, the graph, its carry): the
    graph's step consumes the images in a device-side sum."""
    from gym_copter_tpu_torch.control.heuristics import MOTORVAL
    from gym_copter_tpu_torch.core.graph import Graph
    from gym_copter_tpu_torch.envs import registry
    from gym_copter_tpu_torch.envs.visual import VisualCopterEnv
    from gym_copter_tpu_torch.sensors.vision import DVS, VisionSensor

    env = registry.make(name, num_envs=b, seed=0, device=device)
    venv = VisualCopterEnv(env, dvs=dvs, sensor=(DVS if dvs else
                                                 VisionSensor)(
        res=res, device=device))
    action = torch.full((env.action_size, b), MOTORVAL, device=device)

    def step(vstate, acc):
        vstate, ts, image = venv.step(vstate, action)
        return vstate, acc + image.sum(), image

    graph = Graph(step, warmup=1)
    start = venv.reset()[0]
    acc = torch.zeros((), device=device)
    eager, graphed = (start, acc), (start, acc)
    differ = 0
    for _ in range(num_steps):
        *eager, want = step(*eager)
        *graphed, got = graph(*graphed)
        differ += not torch.equal(want, got)
    return differ, graph, graphed


# the recipe's schedule: 3e-4 annealed to 0 over 600 updates x 4 epochs x
# 16 minibatches; and train()'s default, to 0.05 of the rate (the sum
# that takes optim.fma32), over 500 updates
RECIPE_SCHEDULE = (3e-4, 0.0, 600 * 4 * 16)
FLOOR_SCHEDULE = (3e-4, 3e-4 * 0.05, 500 * 4 * 16)


def schedule_mismatches(device, schedule=RECIPE_SCHEDULE):
    """The counts 0 to steps + 1 at which `optim.linear_schedule(*schedule)`
    on `device` differs in any bit from the same schedule on the CPU:
    (eagerly over the batch of counts, in a CUDA graph of one 0-dim count
    as the update graph runs it, replayed at each count; the number of
    counts)."""
    from gym_copter_tpu_torch.core.graph import Graph
    from gym_copter_tpu_torch.learn import optim

    steps = schedule[2]
    sched = optim.linear_schedule(*schedule)
    counts = torch.arange(steps + 2, dtype=torch.int32)
    want = sched(counts).view(torch.int32)
    eager = sched(counts.to(device)).cpu().view(torch.int32)
    graph = Graph(sched, warmup=1)
    on_card = counts.to(device)
    graphed = torch.empty(steps + 2, dtype=torch.float32, device=device)
    for i in range(steps + 2):
        graphed[i] = graph(on_card[i])
    graphed = graphed.cpu().view(torch.int32)
    return (int((eager != want).sum()), int((graphed != want).sum()),
            steps + 2)


def ppo_leaf_shapes(obs_size, hidden=128, action_size=4):
    """The PPO params' leaf shapes, in `ActorCritic.leaves()` order."""
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.learn import ppo

    params = ppo.init_params(prng.PRNGKey(0, 'cpu'), obs_size, action_size,
                             ppo.PPOConfig(hidden=hidden))
    return [tuple(t.shape) for t in params.leaves()]


def clip_adam_case(shapes, dtype, device, *, clip, stop, count, schedule,
                   seed=0):
    """(optimizer, params, grads, state, stop) for `ClipAdam.step`:
    max_grad_norm 0.5 and the gradients' global norm 4 times it (`clip`)
    or a quarter of it; random moments; a -0.0 parameter with a zero
    gradient and zero moments, and one with a nonzero gradient; both counts
    at `count` under the recipe's schedule (`schedule`), the Adam count
    alone under a constant 3e-4; stop None (no guard), False or True."""
    from gym_copter_tpu_torch.learn import optim

    gen = torch.Generator().manual_seed(seed)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen,
                           dtype=torch.float64) * scale

    grads = [rand(s) for s in shapes]
    norm = float(sum((g * g).sum() for g in grads).sqrt())
    grads = [(g * ((2.0 if clip else 0.125) / norm)).to(dtype)
             for g in grads]
    params = [rand(s).to(dtype) for s in shapes]
    mu = [rand(s, 1e-2).to(dtype) for s in shapes]
    nu = [rand(s, 1e-2).abs().to(dtype) for s in shapes]
    for t, v in ((params[0], -0.0), (grads[0], 0.0), (mu[0], 0.0),
                 (nu[0], 0.0), (params[1], -0.0)):
        t.view(-1)[0] = v
    lr = optim.linear_schedule(*RECIPE_SCHEDULE) if schedule else 3e-4
    opt = optim.ClipAdam(0.5, lr)
    state = optim.AdamState(
        count=torch.tensor(count, dtype=torch.int32), mu=mu, nu=nu,
        schedule_count=torch.tensor(count if schedule else 0,
                                    dtype=torch.int32))
    if stop is not None:
        stop = torch.tensor(stop)
    params, grads, state, stop = (
        tree_to(x, device) for x in (params, grads, state, stop))
    return opt, params, grads, state, stop


def tree_to(tree, device):
    from gym_copter_tpu_torch.core.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def same_bits(a, b) -> bool:
    """a and b hold the same bits (so -0.0 differs from 0.0)."""
    def bits(t):
        if t.dtype in (torch.float32, torch.float64):
            return t.view(torch.int32 if t.dtype == torch.float32
                          else torch.int64)
        return t

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        bits(a), bits(b))


def step_mismatches(got, want):
    """The names of the outputs of `ClipAdam.step`, (params, state), in
    which `got` and `want` differ in any bit."""
    (gp, gs), (wp, ws) = got, want
    pairs = ([(f'param {i}', a, b) for i, (a, b) in enumerate(zip(gp, wp))]
             + [(f'mu {i}', a, b) for i, (a, b) in enumerate(zip(gs.mu,
                                                                 ws.mu))]
             + [(f'nu {i}', a, b) for i, (a, b) in enumerate(zip(gs.nu,
                                                                 ws.nu))]
             + [('count', gs.count, ws.count),
                ('schedule_count', gs.schedule_count, ws.schedule_count)])
    return [name for name, a, b in pairs if not same_bits(a, b)]


def clip_adam_cases():
    """(name, obs_size, dtype, clip, stop, count, schedule) for every
    combination the card test runs: Lander3D's (10) and Hover3D's (12)
    observations at hidden 128, float32 and float64, the norm over and
    under the limit, no guard / not stopped / stopped, counts 0 and 38,399
    (the step makes them 1 and 38,400, the recipe's last) and the int32
    maximum (saturated), a constant rate and the recipe's schedule."""
    out = []
    for task, obs in (('lander3d', 10), ('hover3d', 12)):
        for dtype in (torch.float32, torch.float64):
            for clip in (True, False):
                for stop in (None, False, True):
                    for count in (0, 38_399, 2 ** 31 - 1):
                        for schedule in (False, True):
                            out.append((
                                f'{task} {str(dtype)[6:]} clip={clip} '
                                f'stop={stop} count={count} '
                                f'schedule={schedule}',
                                obs, dtype, clip, stop, count, schedule))
    return out


def clip_adam_mismatches(device):
    """Every case of `clip_adam_cases` on `device`: `ClipAdam.step` (the
    kernel) eagerly, and replayed twice in a captured `core/graph.Graph`,
    against `step_reference` on the card.  Returns ([(case, 'eager' or
    'graphed', outputs that differ)], the number of cases, the kernel's
    launches)."""
    from gym_copter_tpu_torch.core.graph import Graph
    from gym_copter_tpu_torch.learn import optim

    bad, shapes = [], {}
    launches = optim.step_kernel.launches
    cases = clip_adam_cases()
    for name, obs, dtype, clip, stop, count, schedule in cases:
        if obs not in shapes:
            shapes[obs] = ppo_leaf_shapes(obs)
        opt, params, grads, state, stop = clip_adam_case(
            shapes[obs], dtype, device, clip=clip, stop=stop, count=count,
            schedule=schedule)
        want = opt.step_reference(params, grads, state, stop)
        got = opt.step(params, grads, state, stop)
        diff = step_mismatches(got, want)
        if diff:
            bad.append((name, 'eager', diff))
        graph = Graph(lambda p, g, s: opt.step(p, g, s, stop), warmup=1,
                      name='clip_adam')
        for _ in range(2):
            diff = step_mismatches(graph(params, grads, state), want)
            if diff:
                bad.append((name, 'graphed', diff))
    torch.cuda.synchronize()
    return bad, len(cases), optim.step_kernel.launches - launches


FIXTURE = Path(__file__).resolve().parent / 'data' / 'jax_orbax_lander3d'


def fixture_record():
    """The fixture's record: the recipe, each leaf's path, dtype, shape and
    SHA-256, and JAX's metrics of the next update."""
    with open(FIXTURE.parent / 'jax_orbax_lander3d.json') as f:
        return json.load(f)


def fixture_template(record, device):
    """(TrainState template, optimizer) of the fixture's recipe on
    `device`: the structure `checkpoint.restore` fills."""
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.envs.registry import make
    from gym_copter_tpu_torch.learn import optim, ppo

    env = make(record['env'], num_envs=record['envs'], device=device)
    cfg = ppo.resolve_minibatches(ppo.PPOConfig(**record['config']),
                                  record['envs'])
    opt = optim.ClipAdam(cfg.max_grad_norm, optim.linear_schedule(
        cfg.learning_rate, 0.0,
        record['run_updates'] * cfg.epochs * cfg.minibatches))
    return ppo.init_train_state(prng.PRNGKey(0, device), env.params,
                                env.spec, cfg, record['envs'], opt), opt


def fixture_mismatches(ts, optimizer, record):
    """The tree paths at which `ts`, as JAX's leaves, differs from the
    record in dtype, shape or SHA-256 (an empty list where every leaf is
    the fixture's, bit for bit)."""
    from gym_copter_tpu_torch.utils import checkpoint

    got = checkpoint.leaves(ts, optimizer)
    want = {tuple(e['path']): e for e in record['leaves']}
    bad = sorted(set(got) ^ set(want))
    for path in set(got) & set(want):
        a, e = got[path], want[path]
        if (a is None) != (e['sha256'] is None) or a is not None and (
                (a.dtype.str, list(a.shape)) != (e['dtype'], e['shape'])
                or hashlib.sha256(a.tobytes()).hexdigest() != e['sha256']):
            bad.append(path)
    return bad


ENV_STEP_BATCHES = (1, 4096, 4099)
# 'ends': random motor values and max_steps 6 over 16 steps, so every env
# finishes, most of them more than once; 'none': equal motor values (no
# torque) for 8 steps from the start pose, so none finishes; 'ground':
# no thrust from 0.005-0.6 m, so the envs touch down, level, land or crash
ENV_STEP_REGIMES = ('ends', 'none', 'ground')


def env_step_cases():
    """(case name, env id, dtype, batch, regime) for every registry id,
    float32 and float64, every batch of ENV_STEP_BATCHES and every regime
    of ENV_STEP_REGIMES."""
    from gym_copter_tpu_torch.envs import tasks

    return [(f'{name} {str(dtype)[6:]} B={b} {regime}', name, dtype, b,
             regime)
            for name in tasks.ALL_TASKS
            for dtype in (torch.float32, torch.float64)
            for b in ENV_STEP_BATCHES for regime in ENV_STEP_REGIMES]


def env_step_setup(name, dtype, b, regime, device, offset=0, seed=7):
    """(params, spec, base key, env ids, start state, [action per step])
    of one case; the env ids are offset + arange(b), the actions float32
    (A, b) tensors drawn on the host from a generator seeded by the
    case."""
    import zlib

    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.envs import base, registry

    spec, params = registry.resolve_params(name)
    a = spec.action_size
    gen = torch.Generator().manual_seed(zlib.crc32(f'{name} {regime} {b}'
                                                   .encode()))
    if regime == 'ends':
        params = params._replace(task=params.task._replace(max_steps=6))
        actions = [torch.rand((a, b), generator=gen) * 1.5 - 0.25
                   for _ in range(16)]
    elif regime == 'none':
        actions = []
        for _ in range(8):
            v = (torch.rand((1, b), generator=gen) * 0.4 + 0.2).expand(a, b)
            if spec.action_mode == 'demand3':
                v = torch.cat([v[:1], torch.zeros((a - 1, b))])
            actions.append(v.contiguous())
    elif regime == 'ground':
        actions = [torch.zeros((a, b)) for _ in range(40)]
    else:
        raise ValueError(f'unknown regime {regime!r}')
    key = prng.PRNGKey(seed, device)
    ids = offset + torch.arange(b, dtype=torch.int32, device=device)
    state, _ = base.reset(key, ids, torch.zeros(b, dtype=torch.int32,
                                                device=device),
                          params, spec, dtype=dtype)
    if regime == 'ground':
        state.dyn.x[4] = -torch.linspace(0.005, 0.6, b, dtype=dtype,
                                         device=device)
    return (params, spec, key, ids, state,
            [act.to(device) for act in actions])


def step_fields(out):
    """(name, tensor) of every field of a step's (EnvState, TimeStep)."""
    state, ts = out
    return [('x', state.dyn.x), ('status', state.dyn.status),
            ('perturb', state.dyn.perturb), ('ticks', state.dyn.ticks),
            ('prev_shaping', state.prev_shaping), ('steps', state.steps),
            ('episode', state.episode),
            ('initial_random_x', state.initial_random_x),
            ('obs', ts.obs), ('reward', ts.reward), ('done', ts.done),
            ('ts.status', ts.status), ('spinning', ts.spinning),
            ('ts.x', ts.x)]


def step_differs(got, want):
    """The fields in which two step outputs differ: dtype, shape or value
    (torch.equal)."""
    return [name for (name, a), (_, b) in zip(step_fields(got),
                                              step_fields(want))
            if a.dtype != b.dtype or a.shape != b.shape
            or not torch.equal(a, b)]


def env_step_mismatches(name, dtype, b, regime, device, graphed=False,
                        offset=0, rekey_at=None):
    """`envs/base.step` on the card (the kernel; with `graphed`, one step
    captured in a `core/graph.Graph` and replayed) against
    `step_reference` on the card, from the same start state under the same
    actions, every output field compared at every step.  With `rekey_at`,
    the base key is rewritten in place before that step, as
    `SingleCopterEnv.reset(seed=)` rewrites it between replays.

    Returns ([(step, fields that differ)], [envs done at each step],
    whether every env finished at least once, whether the rewritten key
    changed the kernel's draws (None without `rekey_at`))."""
    from gym_copter_tpu_torch.core import prng
    from gym_copter_tpu_torch.core.graph import Graph
    from gym_copter_tpu_torch.envs import base

    params, spec, key, ids, state, actions = env_step_setup(
        name, dtype, b, regime, device, offset)
    old_key = key.clone()

    def kernel_step(st, act):
        return base.step(st, act, key, ids, params, spec)

    step = Graph(kernel_step, warmup=1, name='env_step') if graphed \
        else kernel_step
    got_state = want_state = stale_state = state
    bad, dones, ended = [], [], torch.zeros(b, dtype=torch.bool,
                                            device=device)
    changed = None if rekey_at is None else False
    for t, act in enumerate(actions):
        if t == rekey_at:
            key.copy_(prng.PRNGKey(987654321, device))
        got = step(got_state, act)
        want = base.step_reference(want_state, act, key, ids, params, spec)
        diff = step_differs(got, want)
        if diff:
            bad.append((t, diff))
        if rekey_at is not None and t >= rekey_at:
            stale = base.step_reference(stale_state, act, old_key, ids,
                                        params, spec)
            changed = changed or not torch.equal(got[0].dyn.perturb,
                                                 stale[0].dyn.perturb)
            stale_state = stale[0]
        elif rekey_at is not None:
            stale_state = want[0]
        done = want[1].done
        dones.append(int(done.sum()))
        ended |= done
        # a graph's outputs are overwritten by its next replay; the state
        # passed back is copied into its inputs first
        got_state, want_state = got[0], want[0]
    return bad, dones, bool(ended.all()), changed


def env_step_shard_mismatches(name, dtype, device, b=4096):
    """The kernel's step of the last b/2 columns with their global env ids
    (a rank's shard, parallel/sharding.py) against the same columns of the
    whole batch's step, over the 'ends' regime.  Returns the steps and
    fields that differ."""
    from gym_copter_tpu_torch.envs import base

    params, spec, key, ids, state, actions = env_step_setup(
        name, dtype, b, 'ends', device)
    lo = b // 2

    def cols(tree):
        from gym_copter_tpu_torch.core.tree import tree_map

        return tree_map(lambda t: t[..., lo:].contiguous(), tree)

    whole, shard, bad = state, cols(state), []
    shard_ids = ids[lo:].contiguous()
    for t, act in enumerate(actions):
        w = base.step(whole, act, key, ids, params, spec)
        s = base.step(shard, act[:, lo:].contiguous(), key, shard_ids,
                      params, spec)
        diff = step_differs(s, cols(w))
        if diff:
            bad.append((t, diff))
        whole, shard = w[0], s[0]
    return bad


def launch_hosts(out, hosts, backend, updates, timeout_s=600):
    """`python -m gym_copter_tpu_torch.parallel.launch --coordinator` as
    `hosts` host processes of one rank each over loopback on the card,
    Lander3D-v0 at the recipe, MAIN_B envs in all, `updates` updates:
    process 0's report, which it writes to `out`.  A host that fails, or
    outlives its timeout (the launcher's own, and a minute more here),
    raises; every host is ended."""
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'gym_copter_tpu_torch.parallel.launch',
         '--coordinator', f'127.0.0.1:{port}', '--num-processes',
         str(hosts), '--process-id', str(i), '--nproc-per-node', '1',
         '--backend', backend, '--device', 'cuda', '--env', 'Lander3D-v0',
         '--envs-per-host', str(MAIN_B // hosts), '--updates',
         str(updates), '--timeout', str(timeout_s), '--out', str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(hosts)]
    try:
        texts = [p.communicate(timeout=timeout_s + 60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f'launcher hosts {bad} failed:\n'
                             + '\n'.join(texts[i][-4000:] for i in bad))
    return json.loads(Path(out).read_text())
