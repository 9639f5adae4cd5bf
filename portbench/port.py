"""The program under test, as the benchmark reaches it: the ``repro_torch``
package and nothing else. Its configuration is checked against the
published widths of the benchmark's configuration file, its parameter
template gives the layout the benchmark's weights are made in, and in a
traced run its attention entry is wrapped in a span.
"""
from __future__ import annotations

import contextlib

from portbench import tracing

# the program's config field of each published width in a configuration
# file
WIDTHS = {"n_layers": "n_layers", "d_model": "d_model",
          "n_heads": "n_heads", "n_kv_heads": "n_kv_heads",
          "head_dim": "resolved_head_dim",
          "d_ff": "d_ff", "coord_dim": "coord_dim",
          "compute_dtype": "dtype"}


def config(spec: dict, smoke: bool = False):
    """The program's config of ``spec["port"]``. At full size every
    published width must match; ``smoke`` takes the program's reduced
    config of the same family (for tests on the CPU)."""
    from repro_torch.configs import get_config, smoke_config
    arch = spec["port"]["arch"]
    if smoke:
        return smoke_config(arch)
    cfg = get_config(arch)
    wrong = {k: (getattr(cfg, v), spec[k]) for k, v in WIDTHS.items()
             if k in spec and getattr(cfg, v) != spec[k]}
    if wrong:
        raise ValueError(f"{arch}: the program's widths differ from the "
                         f"published ones (program, published): {wrong}")
    return cfg


def widths(spec: dict, cfg) -> dict:
    """``spec`` with its widths read from ``cfg`` (the same at full size;
    the reduced ones of a smoke config)."""
    return dict(spec, **{k: getattr(cfg, v) for k, v in WIDTHS.items()
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


@contextlib.contextmanager
def attention_spans(on: bool):
    """While ``on``, every call of ``ops.flash_attention`` runs inside a
    ``portbench.flash_attention`` range (the models look the function up
    in ``ops`` at each call)."""
    if not on:
        yield
        return
    from repro_torch.kernels import ops
    inner = ops.flash_attention

    def spanned(*args, **kwargs):
        with tracing.range_(tracing.ATTENTION):
            return inner(*args, **kwargs)
    ops.flash_attention = spanned
    try:
        yield
    finally:
        ops.flash_attention = inner


def forward(cfg):
    """The inference entry of a model that is not served: ``f(params,
    inputs) -> outputs`` (the PDE solver's ``pde.forward``)."""
    if cfg.family == "pde":
        from repro_torch.models import pde
        return lambda params, coords: pde.forward(params, coords, cfg)
    raise ValueError(f"no forward entry for the {cfg.family} family")
