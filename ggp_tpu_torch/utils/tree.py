"""Parameter trees: nested dicts and tuples whose leaves are tensors (or
numpy arrays), flattened in ``jax.flatten_util.ravel_pytree`` order: dict
keys sorted, tuple entries in order."""

from __future__ import annotations

import torch

__all__ = ["tree_map", "tree_leaves", "ravel", "unravel"]


def tree_map(fn, tree):
    """The tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in ravel order. (An insertion-order walk would put a
    Scale's ``log_outputscale`` before its ``base``, and permute the flat
    vector against the JAX package's.)"""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def ravel(tree) -> torch.Tensor:
    """The leaves, each flattened, concatenated in ravel order."""
    return torch.cat([torch.as_tensor(t).reshape(-1) for t in tree_leaves(tree)])


def unravel(flat: torch.Tensor, like):
    """The tree of ``like``'s structure and leaf shapes from ``flat`` (...,
    dim): every leaf keeps the leading dimensions of ``flat``."""
    lead = flat.shape[:-1]
    pos = 0

    def take(leaf):
        nonlocal pos
        shape = tuple(leaf.shape)
        size = 1
        for s in shape:
            size *= s
        out = flat[..., pos:pos + size].reshape(lead + shape)
        pos += size
        return out

    # walk in ravel order, rebuild with the tree's own structure
    def build(tree):
        if isinstance(tree, dict):
            vals = {k: build(tree[k]) for k in sorted(tree)}
            return {k: vals[k] for k in tree}
        if isinstance(tree, tuple):
            return tuple(build(v) for v in tree)
        return take(tree)

    out = build(like)
    if pos != flat.shape[-1]:
        raise ValueError(f"unravel: {flat.shape[-1]} values for a tree of {pos}")
    return out
