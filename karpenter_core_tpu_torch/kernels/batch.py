"""The tenant axis the kernel wrappers share.

The coalesced multi-tenant solve stacks B tenants' planes on a leading axis
and calls each kernel once for all of them.  Every wrapper takes its
operands with or without that axis: a solo call is the kernel at B = 1
(``add_axis`` before the launch, ``drop_axis`` after), and on CPU tensors a
batched call runs the plain twin tenant by tenant (``per_tenant``).  The
helpers walk nested tuples (``ReqTensor``, ``ExistingState``) and pass
anything that is not a tensor (a slot count, the per-key bounds flags,
``None``) through unchanged.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    """``fn`` applied to every tensor leaf of nested tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and any(_has_tensor(t) for t in tree):
        mapped = [tree_map(fn, t) for t in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    return tree


def _has_tensor(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return True
    return isinstance(tree, tuple) and any(_has_tensor(t) for t in tree)


def add_axis(tree):
    """Every tensor with a leading tenant axis of 1."""
    return tree_map(lambda t: t.unsqueeze(0), tree)


def drop_axis(tree):
    """Every tensor without its (size-1) leading tenant axis."""
    return tree_map(lambda t: t[0], tree)


def repeat(tree, n_batch: int):
    """Every tensor repeated over a new leading tenant axis of ``n_batch``,
    dense (the kernels take no stride-0 operand)."""
    return tree_map(lambda t: t.unsqueeze(0).expand((n_batch,) + t.shape).contiguous(), tree)


def stack(trees):
    """Per-tenant results stacked on a leading tenant axis, leaf for leaf."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, tuple):
        parts = [stack([t[i] for t in trees]) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return first


def per_tenant(fn, n_batch: int, args: tuple):
    """``fn`` (a solo twin) on each tenant's slice of ``args``, stacked."""
    return stack([fn(*tree_map(lambda t, b=b: t[b], args)) for b in range(n_batch)])


def _n_batch(args) -> int:
    leaves = []
    tree_map(leaves.append, args)
    return leaves[0].shape[0]


def tenantwise(plain, is_solo):
    """``plain`` (a solo twin) over an optional leading tenant axis: as it
    is when ``is_solo(*args)``, else tenant by tenant.  The CPU path of a
    wrapper, and the twin ``use_kernels=False`` runs."""
    def run(*args):
        if is_solo(*args):
            return plain(*args)
        return per_tenant(plain, _n_batch(args), args)

    run.__name__ = f"{plain.__name__}_tenantwise"
    return run
