"""Rank functions for the port's multi-rank tests
(tests/test_torch_sharding.py), run by `parallel.launch.spawn` in spawned
processes.  Imports nothing of JAX, so that a rank starts quickly."""

import torch

from gym_copter_tpu_torch.control.heuristics import MOTORVAL
from gym_copter_tpu_torch.core import prng, vehicles
from gym_copter_tpu_torch.core.types import EnvParams, TaskParams
from gym_copter_tpu_torch.envs import base, tasks
from gym_copter_tpu_torch.learn import ppo
from gym_copter_tpu_torch.parallel import sharding

PARAMS = EnvParams(vehicle=vehicles.DJI_PHANTOM)
# the fused rollout's world: 512 Lander3D envs, 24-step episodes, 64 steps
ROLLOUT_ENVS, ROLLOUT_STEPS = 512, 64
FORCES = (30.0, 0.0)


def rollout_params(force):
    return PARAMS._replace(task=TaskParams(initial_random_force=force,
                                           max_steps=24))


def fused_state(env_ids, force):
    """Lander3D envs `env_ids` reset under key 0 at episode 0."""
    return base.reset(prng.PRNGKey(0, 'cpu'), env_ids,
                      torch.zeros_like(env_ids), rollout_params(force),
                      tasks.LANDER_3D, dtype=torch.float32)[0]


def fused_action(n):
    return torch.full((4, n), MOTORVAL)


def ppo_world(rank, world, group, device, ts0, configs, steps):
    """This rank's share of the global float64 TrainState `ts0` (Hover3D):
    for each PPO config kwargs, the first rollout of its columns and the
    state and metrics after `steps` sharded train steps; the sharded fused
    rollout of each reset force, gathered to global order; and the errors
    that a graphed gloo step and minibatches of 3 transitions raise."""
    lo, hi = sharding.env_columns(ts0.obs.shape[-1], rank, world)
    ids = torch.arange(lo, hi, dtype=torch.int32)
    shard = ts0._replace(
        env_state=sharding.shard_env_state(ts0.env_state, rank, world),
        obs=sharding.shard_env_state(ts0.obs, rank, world))
    shard = shard._replace(params=sharding.replicate(shard.params, group),
                           opt_state=sharding.replicate(shard.opt_state,
                                                        group))
    out = {'ppo': []}
    for kw in configs:
        step, _ = ppo.make_train_step(PARAMS, tasks.HOVER_3D,
                                      ppo.PPOConfig(**kw),
                                      prng.PRNGKey(0, device), ids,
                                      group=group)
        traj = step.rollout(shard.params.leaves(), shard.env_state,
                            shard.obs, shard.key, step.cfg.rollout_steps)[3]
        ts, metrics = shard, []
        for _ in range(steps):
            ts, m = step(ts)
            metrics.append(m)
        out['ppo'].append({'traj': traj, 'ts': ts, 'metrics': metrics})
    out['errors'] = []
    for run in (lambda: step.run(shard, graphed=True),
                lambda: ppo.make_train_step(
                    PARAMS, tasks.HOVER_3D,
                    ppo.PPOConfig(rollout_steps=3, minibatches=16),
                    prng.PRNGKey(0, device), ids, group=group)):
        try:
            run()
        except ValueError as e:
            out['errors'].append(str(e))
    out['fused'] = []
    n = ROLLOUT_ENVS // world
    ids = torch.arange(rank * n, (rank + 1) * n, dtype=torch.int32)
    for force in FORCES:
        state, totals = sharding.sharded_fused_rollout(
            fused_state(ids, force), fused_action(n), ROLLOUT_STEPS,
            rollout_params(force), tasks.LANDER_3D, seed=7, env_ids=ids)
        out['fused'].append((sharding.gather_env_state(state, group),
                             sharding.gather_totals(totals, group)))
    return out


def train_world(rank, world, group, device, kw):
    """`ppo.train` of Hover3D-v0 on this rank: (history, parameters)."""
    ts, history = ppo.train('Hover3D-v0', num_envs=16, num_updates=1,
                            cfg=ppo.PPOConfig(**kw),
                            callback=lambda i, m: None, device=device,
                            group=group)
    return history, ts.params.leaves()


def fitness_world(rank, world, group, device, genome, cfg_kw, episode):
    """The NEAT fitness of the float64 `genome` population on Lander2D-v0,
    sharded over the world: (every rank's (P,) fitness, the error that a
    population the world does not divide raises)."""
    import dataclasses

    from gym_copter_tpu_torch.learn import neuroevolution as ne

    cfg = ne.NeatConfig(**cfg_kw)
    fit = ne.make_fitness_fn('Lander2D-v0', cfg, group=group,
                             device=device)(genome, episode)
    try:
        ne.make_fitness_fn('Lander2D-v0', dataclasses.replace(
            cfg, pop_size=cfg.pop_size + 1), group=group, device=device)
        error = None
    except ValueError as e:
        error = str(e)
    return fit, error
