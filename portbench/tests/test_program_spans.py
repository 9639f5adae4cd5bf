"""The metrics that read the program's own spans (``repro_torch.attn.bwd``,
``repro_torch.pde.forward``) on a hand-made timeline, their silence where
there is nothing to read (no trace, no device time, a program without the
spans), and the program's ``repro_torch.attn.fwd`` span inside the
benchmark's ``portbench.flash_attention`` on the CPU."""
import pytest
import torch

from portbench import harness, inputs, port, tracing, weights
from portbench.tests.small import SMALL
from portbench.tests.test_tracing import _Ev

BWD, FWD, ATTN_FWD = ("repro_torch.attn.bwd", "repro_torch.pde.forward",
                      "repro_torch.attn.fwd")
NEW = ["attn_bwd_share.train", "attn_bwd_roofline.train",
       "forward_idle_share.infer"]


def _timeline(program_spans=True, device=True):
    """Two units on thread 1; the attention backward on thread 2, one call
    a unit; a launch on thread 1 inside the first backward's interval
    (another thread's: not the backward's); forward spans on both
    threads, the idle gap [0, 3] straddling the first one's start."""
    evs = [
        _Ev(tracing.WINDOW, 0.0, 20.0),
        _Ev(tracing.UNIT, 0.0, 10.0),
        _Ev(tracing.UNIT, 10.0, 20.0),
        _Ev("cudaLaunchKernel", 2.5, 2.6, tid=2, corr=11),
        _Ev("cudaLaunchKernel", 3.5, 3.6, corr=14),
        _Ev("cudaLaunchKernel", 6.0, 6.1, corr=13),
        _Ev("cudaLaunchKernel", 12.5, 12.6, tid=2, corr=12),
    ]
    if program_spans:
        evs += [_Ev(BWD, 2.0, 4.0, tid=2), _Ev(BWD, 12.0, 13.0, tid=2),
                _Ev(FWD, 1.0, 4.0), _Ev(FWD, 15.0, 16.0),
                _Ev(FWD, 9.0, 10.0, tid=2)]
    if device:
        evs += [_Ev("bwd_kernel", 3.0, 5.0, dev="CUDA", corr=11),
                _Ev("fwd_kernel", 5.0, 6.0, dev="CUDA", corr=14),
                _Ev("gemm", 6.0, 8.0, dev="CUDA", corr=13),
                _Ev("bwd_kernel", 13.0, 14.0, dev="CUDA", corr=12)]
    return evs


def _run(trace):
    units = [{"tokens": 10, "model_flops": 0.0,
              "attn": {"flops": 0.25 * 989e12, "bytes": 0.0}},
             {"tokens": 10, "model_flops": 0.0,
              "attn": {"flops": 0.0, "bytes": 0.1 * 3.35e12}}]
    return type("R", (), {"trace": trace, "units": units,
                          "window": (0.0, 20.0)})


def _read(name, run):
    return harness.metric_reader(name).read(run)


def test_readers_on_the_timeline():
    run = _run(tracing.read_events(_timeline()))
    # busy [3, 8] and [13, 14]: 6 s; launched in the backward spans on
    # their thread: 2 s + 1 s
    assert _read("attn_bwd_share.train", run) == pytest.approx(50.0)
    # bounds: unit 1 2 x 0.25 s (FLOPs), unit 2 2 x 0.1 s (bytes), over 3 s
    assert _read("attn_bwd_roofline.train", run) == pytest.approx(
        100.0 * 0.7 / 3.0)
    # idle [0, 3], [8, 13], [14, 20]; main-thread forwards [1, 4] and
    # [15, 16] hold 2 s and 1 s of it (the thread-2 one's 1 s is not read)
    assert _read("forward_idle_share.infer", run) == pytest.approx(15.0)


def test_idle_gaps_are_named_by_the_program_span():
    gaps = dict(tracing.read_events(_timeline()).idle_gaps())
    assert gaps[FWD] == pytest.approx(3.0)           # [0, 3]
    # [8, 13] (a forward on thread 2 only) and [14, 20] (its middle after
    # the forward [15, 16])
    assert gaps["host, no recorded call"] == pytest.approx(11.0)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["no trace", "no device time",
                                  "no program span"])
def test_nothing_to_read_reads_none(name, case):
    if case == "no trace":
        trace = None
    else:
        trace = tracing.read_events(_timeline(
            program_spans=case != "no program span",
            device=case != "no device time"))
    assert _read(name, _run(trace)) is None


def test_each_benchmark_attention_span_holds_one_program_span():
    cell = "pde_solver.infer"
    ctx = harness.context(cell, 2 ** 31 + 7, 0.2, True, device="cpu",
                          smoke=True, traffic_overrides=SMALL[cell])
    params = weights.make(ctx.layout, ctx.seed_for("weights"), ctx.device,
                          torch.float32)
    coords = inputs.mesh_points(ctx.seed, 0, 1, SMALL[cell]["points"],
                                ctx.spec["coord_dim"], ctx.device)
    tracer = tracing.Tracer(True, cuda=False)
    with torch.no_grad(), port.attention_spans(True), tracer.window():
        port.forward(ctx.cfg)(params, coords)
    t = tracer.trace
    outer = t.ranges(tracing.ATTENTION)
    inner = t.ranges(ATTN_FWD)
    assert len(outer) == len(inner) == ctx.cfg.n_layers
    for s, e, tid in outer:
        held = [1 for s2, e2, t2 in inner if s <= s2 and e2 <= e
                and t2 == tid]
        assert len(held) == 1
    (fs, fe, ftid), = t.ranges(FWD)
    assert ftid == t.main_tid
    assert all(fs <= s and e <= fe for s, e, _ in outer)
