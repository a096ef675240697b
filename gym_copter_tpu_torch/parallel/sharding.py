"""Env-batch data parallelism over `torch.distributed`: the port's scaling
layer, the counterpart of `gym_copter_tpu/parallel/sharding.py`.

Environments never communicate, so the design is data parallelism over the
env batch, one process (rank) per device:

  * every (…, B) tensor of the env state is split along its trailing axis,
    rank r of W holding the contiguous columns [r·B/W, (r+1)·B/W), the
    layout of the JAX package's `P('env')`; stepping needs no collective;
  * learner parameters are replicated, and the PPO update all-reduces its
    gradients (learn/ppo.py with `group=`);
  * per-env randomness is keyed by the *global* env id (envs/base.py, the
    fused kernel's kick hash), and exploration noise is drawn over the
    global shape (core/prng.py `cols=`), so every layout gives the
    one-rank bits.

The functions take an explicit process group (None is the default group).
NCCL carries the collectives on the card, gloo on the CPU.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.tree import tree_map
from gym_copter_tpu_torch.ops.fused_rollout import fused_rollout


def init_world(backend: str, rank: int, world_size: int, init_method: str,
               device=None, timeout_s: float = 300.0,
               local_rank: Optional[int] = None):
    """Join the process group and return (group, device).  The device is
    the one the caller names ('cpu' for the CPU tests), else the card of
    the rank's `local_rank` on its own host, `cuda:<local_rank % this
    host's cards>` (a global rank says nothing of the host it runs on;
    ranks beyond the host's cards share them, as gloo ranks may, while
    NCCL needs a card per rank); it is made current.  `timeout_s` bounds
    the rendezvous and every collective."""
    if device is None:
        if local_rank is None:
            raise ValueError('name the device or the local rank: the '
                             'global rank does not say which card of its '
                             'host a rank owns')
        resolve_device(None)  # raises without a card
        device = torch.device('cuda',
                              local_rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD, device


def world_of(group) -> tuple:
    """(rank, world size) of this process in `group`; (0, 1) for None, the
    unsharded layout."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def env_columns(num_envs: int, rank: int, world: int) -> tuple:
    """The global columns (lo, hi) of the env batch that `rank` holds;
    raises unless `world` divides `num_envs`."""
    if num_envs % world != 0:
        raise ValueError(f'batch {num_envs} must be a multiple of the world '
                         f'size {world}')
    local = num_envs // world
    return rank * local, (rank + 1) * local


def shard_env_state(tree, rank: int, world: int):
    """The columns of `rank` of every (…, B) tensor of `tree` (an EnvState,
    obs, an action), each a contiguous copy."""
    def shard(x):
        lo, hi = env_columns(x.shape[-1], rank, world)
        return x[..., lo:hi].contiguous()

    return tree_map(shard, tree)


def replicate(tree, group=None):
    """Every tensor of `tree` broadcast from global rank 0, in place;
    returns `tree`."""
    def bcast(x):
        dist.broadcast(x, src=0, group=group)
        return x

    return tree_map(bcast, tree)


def gather_columns(x: torch.Tensor, group=None) -> torch.Tensor:
    """The (…, W·b) tensor whose columns are every rank's (…, b) `x` in
    global order (rank r's at [r·b, (r+1)·b)), on every rank: one
    all-gather, then the rank blocks moved next to the columns."""
    _, world = world_of(group)
    x = x.contiguous()
    out = x.new_empty((world,) + tuple(x.shape))
    dist.all_gather_into_tensor(out.view((world * x.shape[0],)
                                         + tuple(x.shape[1:])), x,
                                group=group)
    return torch.movedim(out, 0, -2).reshape(*x.shape[:-1], -1)


def gather_env_state(tree, group=None):
    """The global (…, B) tensors of a sharded `tree`, on every rank."""
    return tree_map(lambda x: gather_columns(x, group), tree)


def gather_totals(totals: dict, group=None) -> dict:
    """The global per-env totals of a sharded fused rollout."""
    return {k: gather_columns(v, group) for k, v in totals.items()}


def sharded_fused_rollout(state, action, num_steps: int, params, spec, *,
                          seed: int = 0, env_ids: torch.Tensor):
    """The fused rollout of this rank's shard (`ops.fused_rollout`), with
    zero collectives: `state` and `action` are the rank's columns and
    `env_ids` their GLOBAL ids.  Reset kicks hash (global env id, episode,
    seed), so with the same seed on every rank the gathered result is the
    one-rank layout's bit for bit, with random resets too.

    Returns the rank's (EnvState, totals), as `fused_rollout` does."""
    if env_ids.shape != state.dyn.x.shape[-1:]:
        raise ValueError(f'env_ids {tuple(env_ids.shape)} must hold the '
                         f'global id of each of the shard\'s '
                         f'{state.dyn.x.shape[-1]} envs')
    return fused_rollout(state, action, num_steps, params, spec, seed=seed,
                         env_ids=env_ids)
