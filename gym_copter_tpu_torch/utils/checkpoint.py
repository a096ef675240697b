"""Checkpoint and resume of the whole PPO training state, the counterpart of
`gym_copter_tpu/utils/checkpoint.py`'s `.npz` format.

A `learn.ppo.TrainState` (params, optimizer state, env state, obs, key,
update count) is one file: a killed run restored from it continues bit for
bit.  The leaves are stored as `leaf_{i}` in the order of `jax.tree.leaves`
of the JAX package's TrainState, with its dtypes (the key as two uint32
words, counts int32), so that a file written by either package restores in
the other:

  * params: actor then critic layers, each bias before its weight (JAX's
    dicts flatten by sorted key), then log_std;
  * optimizer state, as `optax.chain(clip_by_global_norm, adam(lr))` keeps
    it: Adam's count, mu and nu in the params' order, and the schedule's
    count only where the learning rate is a schedule (optax keeps no state
    for a constant rate), so `save` and `restore` take the optimizer;
  * env state in field order, obs, key, update_idx.

The save is atomic: a temporary file in the same directory, fsynced, then
renamed over the target.  The JAX package's orbax directory format is not
ported; a path that does not end in `.npz` raises.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from gym_copter_tpu_torch.core.tree import tree_leaves, tree_map
from gym_copter_tpu_torch.learn import optim
from gym_copter_tpu_torch.learn.ppo import ActorCritic, TrainState


def check_path(path: str) -> None:
    """Raises unless `path` names a .npz file."""
    if not path.endswith('.npz'):
        raise ValueError(f'{path!r}: the port writes .npz checkpoints only '
                         f'(the orbax directory format is not ported)')


def _jax_param_order(leaves):
    """ActorCritic.leaves() order (w, b per layer, log_std) in JAX's (b, w
    per layer, log_std)."""
    out = []
    for w, b in zip(leaves[0:-1:2], leaves[1:-1:2]):
        out += [b, w]
    return out + [leaves[-1]]


def _slots(ts: TrainState, optimizer: optim.ClipAdam):
    """The TrainState's tensors in JAX's leaf order, each with the numpy
    dtype JAX stores it in (None: its own)."""
    scheduled = callable(optimizer.learning_rate)
    opt = ts.opt_state
    slots = [(t, None) for t in _jax_param_order(ts.params.leaves())]
    slots.append((opt.count, np.int32))
    slots += [(t, None) for t in _jax_param_order(opt.mu)]
    slots += [(t, None) for t in _jax_param_order(opt.nu)]
    if scheduled:
        slots.append((opt.schedule_count, np.int32))
    slots += [(t, None) for t in tree_leaves(ts.env_state)]
    slots += [(ts.obs, None), (ts.key, np.uint32), (ts.update_idx, np.int32)]
    return slots


def save(path: str, ts: TrainState, optimizer: optim.ClipAdam) -> None:
    """Write `ts` to the .npz file `path` atomically; `optimizer` is the
    one whose state `ts.opt_state` is."""
    check_path(path)
    arrays = {}
    for i, (t, dtype) in enumerate(_slots(ts, optimizer)):
        a = t.detach().cpu().numpy()
        arrays[f'leaf_{i}'] = a if dtype is None else a.astype(dtype)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix='.tmp.npz',
                               prefix=os.path.basename(path) + '.')
    try:
        with os.fdopen(fd, 'wb') as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    dir_fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def restore(path: str, template: TrainState,
            optimizer: optim.ClipAdam) -> TrainState:
    """The TrainState saved in `path`, with the structure of `template` and
    every tensor on its template's device and dtype."""
    check_path(path)
    slots = _slots(template, optimizer)
    with np.load(path) as data:
        if len(data.files) != len(slots):
            raise ValueError(f'{path!r} holds {len(data.files)} leaves; the '
                             f'template has {len(slots)}')
        arrays = [data[f'leaf_{i}'] for i in range(len(slots))]
    leaves = iter([
        torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
        .to(device=t.device, dtype=t.dtype)
        for a, (t, _) in zip(arrays, slots)])

    def params():  # JAX's order back to ActorCritic.leaves() order
        jax_order = [next(leaves) for _ in template.params.leaves()]
        out = []
        for b, w in zip(jax_order[0:-1:2], jax_order[1:-1:2]):
            out += [w, b]
        return out + [jax_order[-1]]

    net = ActorCritic.from_leaves(params())
    count = next(leaves)
    mu, nu = params(), params()
    opt = template.opt_state
    sched = (next(leaves) if callable(optimizer.learning_rate)
             else torch.zeros_like(opt.schedule_count))
    env_state = tree_map(lambda _: next(leaves), template.env_state)
    obs, key, update_idx = next(leaves), next(leaves), next(leaves)
    return TrainState(params=net,
                      opt_state=optim.AdamState(count=count, mu=mu, nu=nu,
                                                schedule_count=sched),
                      env_state=env_state, obs=obs, key=key,
                      update_idx=update_idx)
