"""Checkpoint and resume of the whole PPO training state, the counterpart of
`gym_copter_tpu/utils/checkpoint.py`, in both of its formats.

A `learn.ppo.TrainState` (params, optimizer state, env state, obs, key,
update count) is saved whole: a killed run restored from it continues bit
for bit.  As in the JAX package, a path ending in `.npz` is one numpy file
and any other path is an orbax PyTree checkpoint directory
(`orbax_format.py`), and a checkpoint written by either package restores in
the other.  Both hold the leaves of the JAX package's TrainState, in the
order of `jax.tree.leaves` and with its dtypes (the key as two uint32
words, counts int32):

  * params: actor then critic layers, each bias before its weight (JAX's
    dicts flatten by sorted key), then log_std;
  * optimizer state, as `optax.chain(clip_by_global_norm, adam(lr))` keeps
    it: Adam's count, mu and nu in the params' order, and the schedule's
    count only where the learning rate is a schedule (optax keeps no state
    for a constant rate), so `save` and `restore` take the optimizer;
  * env state in field order, obs, key, update_idx.

The `.npz` file names them `leaf_{i}`; the orbax directory by their JAX
tree paths (`('params', 'actor', '0', 'b')`, ...), with optax's empty
states (the clip's, and a constant rate's) as the entries orbax keeps no
data for.

Either save is atomic: the `.npz` is written to a temporary file in the
same directory, fsynced, then renamed over the target; the directory is
written beside the target and renamed into its place (`orbax_format.write`).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from gym_copter_tpu_torch.core.tree import tree_map
from gym_copter_tpu_torch.learn import optim
from gym_copter_tpu_torch.learn.ppo import ActorCritic, TrainState
from gym_copter_tpu_torch.utils import orbax_format


def check_path(path: str) -> None:
    """Raises unless a checkpoint can be written at `path`: a .npz file or
    an orbax directory, inside an existing writable directory, where no
    entry of the other kind stands."""
    parent = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(parent) or not os.access(parent, os.W_OK | os.X_OK):
        raise ValueError(f'{path!r}: {parent!r} is not a writable directory')
    if path.endswith('.npz'):
        if os.path.isdir(path):
            raise ValueError(f'{path!r} is a directory, not a .npz file')
    elif os.path.lexists(path) and not os.path.isdir(path):
        raise ValueError(f'{path!r} is a file; a path that does not end in '
                         f'.npz names an orbax checkpoint directory')


def _jax_param_order(leaves):
    """ActorCritic.leaves() order (w, b per layer, log_std) in JAX's (b, w
    per layer, log_std)."""
    out = []
    for w, b in zip(leaves[0:-1:2], leaves[1:-1:2]):
        out += [b, w]
    return out + [leaves[-1]]


def _param_paths(n_leaves: int):
    """JAX's params tree paths in leaf order."""
    layers = (n_leaves - 1) // 4
    return [(net, str(i), k) for net in ('actor', 'critic')
            for i in range(layers) for k in ('b', 'w')] + [('log_std',)]


def _named(prefix, tree):
    """(path, tensor) of a NamedTuple of tensors, in field order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [x for name, sub in zip(tree._fields, tree)
            for x in _named(prefix + (name,), sub)]


def _slots(ts: TrainState, optimizer: optim.ClipAdam):
    """JAX's TrainState tree as (path, tensor, numpy dtype) in leaf order:
    the tensor None for the entries orbax keeps no data for, the dtype None
    for the tensor's own."""
    scheduled = callable(optimizer.learning_rate)
    opt = ts.opt_state
    params = _param_paths(len(ts.params.leaves()))

    def tree(prefix, leaves):
        return [(prefix + p, t, None)
                for p, t in zip(params, _jax_param_order(leaves))]

    adam = ('opt_state', '1', '0')
    slots = tree(('params',), ts.params.leaves())
    slots.append((('opt_state', '0'), None, None))
    slots.append((adam + ('count',), opt.count, np.int32))
    slots += tree(adam + ('mu',), opt.mu) + tree(adam + ('nu',), opt.nu)
    slots.append((('opt_state', '1', '1', 'count'), opt.schedule_count,
                  np.int32) if scheduled else
                 (('opt_state', '1', '1'), None, None))
    slots += [(p, t, None) for p, t in _named(('env_state',), ts.env_state)]
    slots += [(('obs',), ts.obs, None), (('key',), ts.key, np.uint32),
              (('update_idx',), ts.update_idx, np.int32)]
    return slots


def write_atomically(path: str, write) -> None:
    """Call `write(f)` on a temporary file in `path`'s directory, flush and
    fsync it, rename it over `path` and fsync the directory: a write that
    fails (or a kill) leaves the earlier file at `path` whole, and a failed
    write removes its temporary file."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix='.tmp',
                               prefix=os.path.basename(path) + '.')
    try:
        with os.fdopen(fd, 'wb') as f:
            write(f)
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


def _save_npz(path: str, arrays) -> None:
    write_atomically(path, lambda f: np.savez(
        f, **{f'leaf_{i}': a for i, a in enumerate(arrays)}))


def leaves(ts: TrainState, optimizer: optim.ClipAdam
           ) -> dict[tuple[str, ...], np.ndarray | None]:
    """JAX's TrainState leaves of `ts` by tree path, in leaf order and with
    JAX's dtypes, as a checkpoint holds them (None where orbax keeps no
    data); `optimizer` is the one whose state `ts.opt_state` is."""
    out = {}
    for p, t, dtype in _slots(ts, optimizer):
        a = None if t is None else t.detach().cpu().numpy()
        out[p] = a if dtype is None or a is None else a.astype(dtype)
    return out


def save(path: str, ts: TrainState, optimizer: optim.ClipAdam) -> None:
    """Write `ts` atomically to the .npz file or orbax directory `path`;
    `optimizer` is the one whose state `ts.opt_state` is."""
    check_path(path)
    entries = leaves(ts, optimizer)
    if path.endswith('.npz'):
        _save_npz(path, [a for a in entries.values() if a is not None])
    else:
        orbax_format.write(path, entries)


def _load(path: str, slots) -> list[np.ndarray]:
    """The arrays of the checkpoint at `path` in the order of `slots`'
    tensors."""
    if path.endswith('.npz'):
        n = sum(t is not None for _, t, _ in slots)
        with np.load(path) as data:
            if len(data.files) != n:
                raise ValueError(f'{path!r} holds {len(data.files)} leaves; '
                                 f'the template has {n}')
            return [data[f'leaf_{i}'] for i in range(n)]
    entries = orbax_format.read(path)
    want = [p for p, t, _ in slots if t is not None]
    have = {p for p, a in entries.items() if a is not None}
    if have != set(want):
        raise ValueError(f'{path!r}: leaves {sorted(have - set(want))} are '
                         f'not in the template, {sorted(set(want) - have)} '
                         f'are missing')
    return [entries[p] for p in want]


def restore(path: str, template: TrainState,
            optimizer: optim.ClipAdam) -> TrainState:
    """The TrainState saved at `path` (a .npz file or an orbax directory),
    with the structure of `template` and every tensor on its template's
    device and dtype."""
    slots = _slots(template, optimizer)
    arrays = _load(path, slots)
    tensors = [(p, t) for p, t, _ in slots if t is not None]
    for a, (p, t) in zip(arrays, tensors):
        if a.shape != tuple(t.shape):
            raise ValueError(f'{path!r}: {p} has shape {a.shape}, the '
                             f'template {tuple(t.shape)}')
    leaves = iter([
        torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
        .to(device=t.device, dtype=t.dtype)
        for a, (_, t) in zip(arrays, tensors)])

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
