"""The program under test, as the benchmark reaches it: the ``repro_torch``
package and nothing else. Its configuration is checked against the
published widths of the benchmark's configuration file (the fields the
family's file names), and its parameter template gives the layout the
benchmark's weights are made in. What differs by family lives in
``families/<family>.py``.
"""
from __future__ import annotations

import importlib


def family(spec: dict):
    """The module ``families/<family>.py`` of a configuration file."""
    return importlib.import_module(f"portbench.families.{spec['family']}")


def config(spec: dict, smoke: bool = False):
    """The program's config of ``spec["port"]``. At full size every
    published width must match; ``smoke`` takes the program's reduced
    config of the same family (for tests on the CPU)."""
    from repro_torch.configs import get_config, smoke_config
    arch = spec["port"]["arch"]
    if smoke:
        return smoke_config(arch)
    cfg = get_config(arch)
    wrong = {k: (getattr(cfg, v), spec[k])
             for k, v in family(spec).WIDTHS.items()
             if k in spec and getattr(cfg, v) != spec[k]}
    if wrong:
        raise ValueError(f"{arch}: the program's widths differ from the "
                         f"published ones (program, published): {wrong}")
    return cfg


def widths(spec: dict, cfg) -> dict:
    """``spec`` with its widths read from ``cfg`` (the same at full size;
    the reduced ones of a smoke config)."""
    return dict(spec, **{k: getattr(cfg, v)
                         for k, v in family(spec).WIDTHS.items()
                         if k in spec})


def model(cfg):
    from repro_torch.models import get_model
    return get_model(cfg)


def layout(cfg) -> list:
    """The leaves of the program's parameter template in sorted-key
    order: ``(path, shape, init)`` (see ``portbench.weights``)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
            return
        out.append((path, tuple(node.shape), tuple(node.init)))
    walk(model(cfg).template(), ())
    return out
