"""Random weights made from the seed on the device, in the layout the
program's entry takes (plain torch: no code of the program).

A layout is a list of leaves ``(path, shape, init)`` in a fixed order:
``init`` is ``("normal", std)``, ``("zeros",)`` or ``("ones",)``. Each
leaf is drawn in one call from one generator on the device, so the same
seed gives the same weights.
"""
from __future__ import annotations

import torch


def leaves(layout: list, seed: int, device, dtype):
    """Yield ``(path, tensor)`` for every leaf of ``layout`` in order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, shape, init in layout:
        kind = init[0]
        if kind == "normal":
            x = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32).mul_(init[1])
        elif kind == "zeros":
            x = torch.zeros(shape, device=device)
        elif kind == "ones":
            x = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown init {init!r} at {path}")
        yield path, x.to(dtype)


def make(layout: list, seed: int, device, dtype) -> dict:
    """The nested dict of every leaf of ``layout``."""
    return nest(leaves(layout, seed, device, dtype))


def nest(items) -> dict:
    """The nested dict of ``(path, leaf)`` pairs."""
    tree: dict = {}
    for path, x in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree


def get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def flatten(tree: dict, path: tuple = ()) -> list:
    """``[(path, leaf)]`` of a nested dict in sorted-key order."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in flatten(tree[k], path + (k,))]
