"""The training loop: the program's PPO train step (`learn/ppo.py`
`TrainStep`, graphed on the card) back to back from a fresh train state,
the host reading each update's metrics as the training loop does.

Set-up builds one train step and one train state from the inputs the
benchmark made from the seed (`reference.ppo.initial_state`), drives that
state through its first `checked_updates` updates by the step's own call,
keeping what the comparison needs, warms up until the card's node time is
back at its floor, and hands the same step and state to the window.  The
window's metric is the env-steps of the updates completed and read over
the seconds from its start to the last read.

Once the window has closed and the memory peak is read, the program is
freed and the reference follows the same first updates from the same
inputs: each update's loss, the Adam first moments after the first update
(the gradients as the optimizer got them) and each leaf's change over the
checked updates are compared leaf by leaf.

The window's updates' mean `done_rate` (resets per env-step) is printed
on standard error.  A traced run times each update's phases by the CUDA
events of `TrainStep.run(..., marks=)` beside the host's seconds of the
window, profiles `trace_updates` more updates for the breakdown, and
counts the nodes of the step's graphs.
"""

from __future__ import annotations

import gc
import time

import torch

from port_bench import card, compare, program, trace
from port_bench.reference import counts
from port_bench.reference import env as E
from port_bench.reference import ppo as R


def _program_step(ctx, task, recipe, base_key, env_ids):
    from gym_copter_tpu_torch.learn import optim, ppo

    fields = set(ppo.PPOConfig._fields)
    cfg = ppo.PPOConfig(**{k: v for k, v in ctx.config['ppo'].items()
                           if k in fields})
    cfg = ppo.resolve_minibatches(cfg, int(env_ids.shape[0]))
    if cfg.anneal_lr:
        optimizer = ppo.train_optimizer(cfg, recipe.anneal_updates)
    else:
        optimizer = optim.ClipAdam(cfg.max_grad_norm, cfg.learning_rate)
    step, _ = ppo.make_train_step(program.env_params(ctx.config),
                                  program.task_spec(ctx.config), cfg,
                                  base_key.clone(), env_ids.clone(),
                                  optimizer=optimizer)
    return step, optimizer


def _train_state(leaves, optimizer, env_state, obs, key):
    from gym_copter_tpu_torch.learn import ppo

    params = ppo.ActorCritic.from_leaves([x.clone() for x in leaves])
    return ppo.TrainState(params=params,
                          opt_state=optimizer.init(params.leaves()),
                          env_state=program.env_state(env_state),
                          obs=obs.clone(), key=key.clone(),
                          update_idx=torch.zeros((), dtype=torch.int32,
                                                 device=obs.device))


class Port:
    """The program's train step and train state, built from the inputs
    the benchmark made.  A substitute for it (`ctx.substitute`, called as
    `Port` is) has the same three methods."""

    def __init__(self, ctx, task, recipe, inputs):
        leaves0, env_state0, obs0, key0, base_key, env_ids = inputs
        self.graphed = ctx.device.type == 'cuda'
        self.step, optimizer = _program_step(ctx, task, recipe, base_key,
                                             env_ids)
        self.ts = _train_state(leaves0, optimizer, env_state0, obs0, key0)
        self.rollout_steps = recipe.rollout_steps

    def __call__(self, marks=None) -> list:
        """One update by the step's own call (graphed on the card), and the
        host's read of its metrics in the reference's order."""
        self.ts, m = self.step.run(self.ts, graphed=self.graphed,
                                   marks=marks)
        return torch.stack([m[k] for k in R.METRICS]).cpu().tolist()

    def leaves(self) -> list:
        return [x.clone() for x in self.ts.params.leaves()]

    def first_moments(self) -> list:
        return [x.clone() for x in self.ts.opt_state.mu]

    def graph_nodes(self) -> dict:
        """Nodes of the step's graphs captured anew from the state."""
        step, ts = self.step, self.ts
        pl = ts.params.leaves()
        r = step.rollout(pl, ts.env_state, ts.obs, ts.key,
                         self.rollout_steps)
        flat, _ = step.advantages(pl, r[3], r[1])
        return {
            'rollout_step': card.graph_nodes(
                lambda *a: step.rollout(*a, 1),
                (pl, ts.env_state, ts.obs, ts.key), 1),
            'gae': card.graph_nodes(step.advantages, (pl, r[3], r[1]), 1),
            'update': card.graph_nodes(
                step.update, (pl, ts.opt_state, ts.key, flat), 3),
            'rollout_steps': self.rollout_steps}


def run(ctx) -> dict:
    tr, cfg = ctx.traffic, ctx.config
    task = E.params_from_config(cfg)
    recipe = R.recipe_from_config(cfg)
    num_envs = int(cfg['num_envs'])
    on_card = ctx.device.type == 'cuda'
    inputs = R.initial_state(task, recipe, ctx.seed, num_envs, ctx.device)
    leaves0, env_state0, obs0, key0, base_key, env_ids = inputs

    state = (card.CardState(ctx.device, tr['warmup']['fast_ratio'])
             if on_card else None)
    prog = (ctx.substitute or Port)(ctx, task, recipe, inputs)

    # the checked updates: the window's own call and read
    checked = int(tr['checked_updates'])
    losses, mu1 = [], None
    for i in range(checked):
        losses.append(R.total_loss(prog(), recipe))
        if i == 0:
            mu1 = prog.first_moments()
    leaves_n = prog.leaves()

    w = tr['warmup']
    warm = card.warm_up(prog, state, w['min_s'], w['max_s'],
                        w['settled_reads'])

    marks = [] if (ctx.trace and on_card) else None
    updates, done_rate = 0, 0.0
    t0 = ctx.window_opens()
    while True:
        metrics = prog(marks)
        updates += 1
        done_rate += metrics[R.METRICS.index('done_rate')]
        t_last = time.perf_counter()
        if t_last - t0 >= ctx.seconds:
            break
    ctx.window_closes()
    steps_per_update = num_envs * recipe.rollout_steps
    end_to_end = {'train_env_steps_per_s': counts.rate(
        updates, steps_per_update, t_last - t0)}
    ctx.read_peak()

    layers = {'loop': 'train', 'warm_up': warm,
              'resets_per_env_step': done_rate / updates,
              'flops_per_update': counts.ppo_update_flops(
                  len(task.obs_indices), recipe.hidden, task.action_size,
                  num_envs, recipe.rollout_steps, recipe.epochs)}
    if marks is not None:
        torch.cuda.synchronize()
        layers['phase_ms'] = [
            [marks[i + k].elapsed_time(marks[i + k + 1]) for k in range(3)]
            for i in range(0, len(marks), 4)]
        layers['window_s'] = t_last - t0

        def traced():
            for _ in range(int(tr['trace_updates'])):
                prog()

        layers['profile'] = trace.profile(traced)
        layers['graph_nodes'] = prog.graph_nodes()

    # free the program before the reference runs
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = R.TrainStep(task, recipe, base_key, env_ids)
    s = R.State(leaves=leaves0, opt=R.adam_init(leaves0),
                env_state=env_state0, obs=obs0, key=key0)
    ref_losses, ref_mu1 = [], None
    for i in range(checked):
        s, rm = ref(s)
        ref_losses.append(R.total_loss(rm.tolist(), recipe))
        if i == 0:
            ref_mu1 = s.opt.mu
    grad_norms = [float(torch.linalg.vector_norm(x.double()))
                  for x in ref_mu1]
    still = compare.still_leaves(grad_norms)
    checks = [
        ('loss_gap', max(compare.rel(a, b)
                         for a, b in zip(losses, ref_losses)),
         ctx.limit('loss_gap')),
        ('grad_gap', compare.leaf_norm_gap(mu1, ref_mu1),
         ctx.limit('grad_gap')),
        ('change_gap', compare.leaf_norm_gap(
            [a - b for a, b in zip(leaves_n, leaves0)],
            [a - b for a, b in zip(s.leaves, leaves0)], skip=still),
         ctx.limit('change_gap')),
    ]
    layers['still_leaves'] = sorted(still)
    layers['check_s'] = time.perf_counter() - t_check
    return {'end_to_end': end_to_end, 'layers': layers, 'checks': checks,
            'attempted': updates, 'failed': 0}
