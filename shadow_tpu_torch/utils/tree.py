"""Dataclass-of-tensors helpers: the port's stand-in for jax.tree_util.

States are (nested) dataclasses whose leaves are tensors or None. Leaf
paths are spelled as jax.tree_util.keystr spells the reference's flax
pytree paths (".queue.time", ".model.tcp.st"), so a port state and a
reference state can be compared leaf by leaf by name.
"""

from __future__ import annotations

import dataclasses


def tree_map(fn, tree, *rest):
    """Apply fn to every tensor leaf (None leaves stay None)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(
                    fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
                )
                for f in dataclasses.fields(tree)
            },
        )
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: str = ""):
    """[(path, leaf)] for every non-None leaf, in field order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += tree_leaves_with_path(getattr(tree, f.name), f"{prefix}.{f.name}")
        return out
    if tree is None:
        return []
    return [(prefix, tree)]
