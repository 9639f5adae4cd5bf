"""The program's spans (``repro_torch.spans``) on the CPU, at the PDE
solver's SMOKE config.

- With no profiler recording, no ``record_function`` is ever opened.
- Under kineto, enabled as a traced benchmark run enables it (user spans
  and the autograd engine's node ranges only), one forward and backward
  records one ``repro_torch.attn.fwd`` and one ``repro_torch.attn.bwd``
  per layer, and one ``repro_torch.pde.forward`` holding the forward
  spans; the ragged attention path opens ``repro_torch.attn.fwd`` too.
- The outputs and every gradient are bit-equal with and without the
  profiler.
- On the card (marked ``cuda``, skips without one): ``chip_smoke.py``'s
  device rows of a profiled forward and backward through
  ``ops.flash_attention`` hold the kernels and no span, whose device-side
  annotation would add the kernels' time again.
"""
import contextlib
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.models import pde
from repro_torch.models.common import init_params, tree_leaves, tree_map

N_PTS = 24
ROOT = Path(__file__).resolve().parents[1]


def _setup():
    cfg = smoke_config("pde_solver")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"coords": torch.rand(2, N_PTS, cfg.coord_dim, generator=g),
             "targets": torch.randn(2, N_PTS, 4, generator=g)}
    return cfg, params, batch


def _step(cfg, params, batch):
    """The loss (one forward) and its backward: the loss and every
    gradient."""
    tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = pde.regression_loss(tree, batch, cfg)
    loss.backward()
    return loss.detach(), [p.grad for p in tree_leaves(tree)]


@contextlib.contextmanager
def _kineto(events: list):
    """Kineto on the CPU with only user spans and the autograd engine's
    node ranges recorded; appends ``(name, start_ns, end_ns, tid, node)``
    of every host event to ``events`` on exit (``node``: an autograd
    node's range)."""
    from torch._C._profiler import RecordScope, _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    acts = {ProfilerActivity.CPU}
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE,
                                    RecordScope.BACKWARD_FUNCTION})
    try:
        yield
    finally:
        node = int(RecordScope.BACKWARD_FUNCTION)
        for ev in _disable_profiler().events():
            s = ev.start_ns()
            events.append((ev.name(), s, s + ev.duration_ns(),
                           ev.start_thread_id(), int(ev.scope()) == node))


def _named(events, name):
    return [e for e in events if e[0] == name]


def test_no_profiler_opens_no_range(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cfg, params, batch = _setup()
    with torch.no_grad():
        out = pde.forward(params, batch["coords"], cfg)
    assert torch.isfinite(out).all()
    loss, grads = _step(cfg, params, batch)
    assert torch.isfinite(loss)
    assert all(g is not None for g in grads)


def test_traced_step_records_each_boundary():
    cfg, params, batch = _setup()
    events = []
    with _kineto(events):
        _step(cfg, params, batch)
    fwd = _named(events, "repro_torch.pde.forward")
    attn = _named(events, "repro_torch.attn.fwd")
    bwd = _named(events, "repro_torch.attn.bwd")
    assert len(fwd) == 1
    assert len(attn) == cfg.n_layers
    assert len(bwd) == cfg.n_layers
    (_, fs, fe, ftid, _), = fwd
    assert all(fs <= s and e <= fe and t == ftid for _, s, e, t, _ in attn)
    # the attention backward runs after the forward, inside an autograd
    # node's range on that node's thread
    nodes = [ev for ev in events if ev[4]]
    for _, s, e, t, _ in bwd:
        assert s >= fe
        assert any(ns <= s and e <= ne and nt == t
                   for _, ns, ne, nt, _ in nodes)


def test_ragged_path_opens_the_forward_span():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 6, 2, 8, generator=g) for _ in range(3))
    events = []
    with _kineto(events):
        ops.flash_attention(q, k, v, lengths=torch.tensor([6, 3]),
                            impl="torch")
    assert len(_named(events, "repro_torch.attn.fwd")) == 1


def test_profiler_changes_no_output_bit():
    cfg, params, batch = _setup()
    with torch.no_grad():
        plain = pde.forward(params, batch["coords"], cfg)
        with _kineto([]):
            traced = pde.forward(params, batch["coords"], cfg)
    assert torch.equal(plain, traced)


def test_profiler_changes_no_gradient_bit():
    cfg, params, batch = _setup()
    loss, grads = _step(cfg, params, batch)
    with _kineto([]):
        t_loss, t_grads = _step(cfg, params, batch)
    assert torch.equal(loss, t_loss)
    assert len(grads) == len(t_grads)
    for a, b in zip(grads, t_grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_chip_smoke_device_rows_hold_no_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(1, 512, 4, 64, generator=g, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(True)
               for _ in range(3))

    def step():
        ops.flash_attention(q, k, v, impl="cuda").float().sum().backward()

    kernels = smoke.profiled(step, 4)
    assert kernels
    assert [e.key for e in kernels if e.key.startswith("repro_torch.")] == []
