"""`jax.tree.map` for the port's nested state: tensors inside NamedTuples,
tuples, lists and dicts, and modules that flatten to a list of tensors
(`leaves()`) and back (`from_leaves`), as `learn.ppo.ActorCritic` does."""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """fn over the tensors of matching nested structures; returns the same
    structure of its results.  None is an empty tree (a stateless policy's
    state)."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if t is None:
        return None
    if hasattr(t, 'from_leaves'):
        return type(t).from_leaves(tree_map(fn, *(x.leaves() for x in trees)))
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    parts = [tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t)(*parts) if hasattr(t, '_fields') else type(t)(parts)


def tree_leaves(tree) -> list:
    """The tensors of `tree` in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out
