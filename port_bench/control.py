"""The control of each cell and the planted faults, each run through the
harness in the program's place, at the cell's own size, on the card:

    python3 -m port_bench.control --workload lander3d.ppo --seeds 1 2 3

For each seed and variant it hands `harness.run` the plain reference as
the substitute for the program and prints the run's `correct` and the
numbers it compared, one JSON line each.  The variants: 'control', the
reference in the nearest precision below the configuration's that changes
the computation (TF32 products for the PPO networks; bfloat16 for the
env-only cells, whose one product is an identity motor mix that TF32
leaves exact); for the training cells the faults 'half_batch' and
'reward' (a state left unchanged reads 1 by the measure and needs no
run); and 'reference', the reference as configured, which has to come out
correct.  The window is short: the training cells need none, and the
single cell's has to hold as many episodes as its check compares.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import torch

from port_bench import harness
from port_bench.reference import env as E
from port_bench.reference import fused as F
from port_bench.reference import ppo as R
from port_bench.reference import prng

VARIANTS = {'train': ('control', 'half_batch', 'reward'),
            'fused': ('control',),
            'single': ('control',)}
SECONDS = {'train': 0.0, 'fused': 0.0, 'single': 10.0}
SHORT = {'train': {'warmup': {'min_s': 0.0, 'max_s': 0.0}},
         'fused': {'warmup_calls': 1},
         'single': {'warmup': {'min_s': 0.0, 'max_s': 0.0}}}


class ReferenceTrain:
    """The reference's train step in the place of the training loop's
    `Port`, with `reference.ppo.TrainStep`'s `matmul` and `fault`."""

    def __init__(self, ctx, task, recipe, inputs, **kw):
        leaves0, env_state0, obs0, key0, base_key, env_ids = inputs
        self.step = R.TrainStep(task, recipe, base_key, env_ids, **kw)
        self.s = R.State(leaves=leaves0, opt=R.adam_init(leaves0),
                         env_state=env_state0, obs=obs0, key=key0)

    def __call__(self, marks=None) -> list:
        self.s, m = self.step(self.s)
        return m.tolist()

    def leaves(self) -> list:
        return list(self.s.leaves)

    def first_moments(self) -> list:
        return list(self.s.opt.mu)


def reference_fused(task: E.Task, dtype):
    """The reference rollout, called as the program's `fused_rollout` is,
    its answer in the program's types."""
    def fused(state, action, num_steps, params, spec, *, seed, env_ids):
        out = F.rollout(state, env_ids, action, num_steps, seed, task,
                        graphed=action.is_cuda, dtype=dtype)
        x, perturb, status, ticks, steps, pshape, episode, acc, eps = out
        new = state._replace(
            dyn=state.dyn._replace(x=x, perturb=perturb, status=status,
                                   ticks=ticks),
            steps=steps, prev_shaping=pshape, episode=episode)
        return new, {'reward_sum': acc, 'episodes': eps}

    return fused


class ReferenceSingle:
    """The reference env at B = 1, built and stepped as the program's
    `SingleCopterEnv` is: episode i resets at index i under the seed's
    key; `step` returns the raw step's observation (the terminal one on
    the done step)."""

    def __init__(self, name, params=None, seed=0, device=None, *,
                 task: E.Task, dtype):
        self.task, self.dtype, self.device = task, dtype, device
        self.key = prng.PRNGKey(seed, device)
        self.ids = torch.zeros(1, dtype=torch.int32, device=device)
        self.episode = 0
        self.state = None

    def reset(self):
        episode = torch.full((1,), self.episode, dtype=torch.int32,
                             device=self.device)
        self.state, obs = E.reset(self.key, self.ids, episode, self.task,
                                  dtype=self.dtype)
        self.episode += 1
        return obs[:, 0].float().cpu().numpy(), {}

    def step(self, action):
        a = torch.as_tensor(np.asarray(action, np.float64)[:, None],
                            dtype=self.dtype).to(self.device)
        self.state, obs, reward, done = E.raw_step(self.state, a, self.task)
        return (obs[:, 0].float().cpu().numpy(), float(reward[0]),
                bool(done[0]), False, {})


def substitute(loop: str, variant: str, config: dict):
    """What runs in the program's place for `variant` of a `loop` cell."""
    if loop == 'train':
        kw = {'control': {'matmul': 'tf32'}, 'half_batch': {
            'fault': 'half_batch'}, 'reward': {'fault': 'reward'},
            'reference': {}}[variant]
        return functools.partial(ReferenceTrain, **kw)
    dtype = {'control': torch.bfloat16, 'reference': torch.float32}[variant]
    task = E.params_from_config(config)
    if loop == 'fused':
        return reference_fused(task, dtype)
    return functools.partial(ReferenceSingle, task=task, dtype=dtype)


def run(workload: str, seed: int, variant: str, device='cuda',
        overrides: dict = None, seconds: float = None) -> dict:
    """`harness.run` of the cell with `variant` in the program's place:
    {'correct', 'checks'}.  `overrides` are merged over the short
    window's."""
    manifest = harness.Manifest()
    cell = manifest.cell(workload)
    loop = manifest.traffic(cell['traffic'])['loop']
    config = manifest.config(cell['config'])
    for k, v in (overrides or {}).get('config', {}).items():
        config[k] = ({**config[k], **v} if isinstance(v, dict)
                     and isinstance(config.get(k), dict) else v)
    traffic = dict(SHORT[loop], **(overrides or {}).get('traffic', {}))
    result = harness.run(
        workload, seed, SECONDS[loop] if seconds is None else seconds,
        False, device=device, manifest=manifest,
        overrides={'config': (overrides or {}).get('config', {}),
                   'traffic': traffic},
        substitute=substitute(loop, variant, config))
    return {'correct': result['correct'], 'checks': result['checks']}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--variants', nargs='+', default=None,
                   help='default: the control and the cell\'s faults')
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('port_bench.control: no CUDA device', file=sys.stderr)
        return 2
    manifest = harness.Manifest()
    loop = manifest.traffic(manifest.cell(args.workload)['traffic'])['loop']
    for seed in args.seeds:
        for variant in args.variants or VARIANTS[loop]:
            out = run(args.workload, seed, variant, args.device)
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'variant': variant, **out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
