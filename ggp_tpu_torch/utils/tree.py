"""Nested-dict parameter trees: the leaves are tensors (or numpy arrays)."""

from __future__ import annotations

__all__ = ["tree_map"]


def tree_map(fn, tree):
    """The tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
