"""The metrics that read the program's own spans (``repro_torch.attn.fwd``,
``repro_torch.attn.bwd``, ``repro_torch.pde.forward``) on hand-made
timelines: the pairing of each attention call with its unit's work for it,
its refusal of a list of works that the calls do not match, and silence
where there is nothing to read (no trace, no device time, a program
without the spans); then, for every cell on the CPU, the program's spans
in a traced window, each paired with a work."""
import pytest

from portbench import harness, readers, tracing, yardstick
from portbench.tests import small
from portbench.tests.test_tracing import _Ev

BWD, FWD, ATTN_FWD = ("repro_torch.attn.bwd", "repro_torch.pde.forward",
                      "repro_torch.attn.fwd")
READERS = ["attn_bwd_share.train", "attn_bwd_roofline.train",
           "forward_idle_share.infer", "attn_fwd_roofline.train",
           "attn_fwd_roofline.infer"]
# works whose bound is 0.25 s of FLOPs and 0.1 s of bytes
W_FLOPS = {"flops": 0.25 * yardstick.PEAK_BF16_FLOPS, "bytes": 0.0}
W_BYTES = {"flops": 0.0, "bytes": 0.1 * yardstick.HBM_BYTES_PER_S}


def _timeline(program_spans=True, device=True):
    """Two units on thread 1; the attention backward on thread 2, one call
    a unit; a launch on thread 1 inside the first backward's interval
    (another thread's: not the backward's); forward spans on both
    threads, the idle gap [0, 3] straddling the first one's start; an
    attention forward in each unit, launching the 'fwd_kernel' and
    'gemm'."""
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
                _Ev(FWD, 9.0, 10.0, tid=2),
                _Ev(ATTN_FWD, 3.4, 6.5), _Ev(ATTN_FWD, 15.0, 15.5)]
    if device:
        evs += [_Ev("bwd_kernel", 3.0, 5.0, dev="CUDA", corr=11),
                _Ev("fwd_kernel", 5.0, 6.0, dev="CUDA", corr=14),
                _Ev("gemm", 6.0, 8.0, dev="CUDA", corr=13),
                _Ev("bwd_kernel", 13.0, 14.0, dev="CUDA", corr=12)]
    return evs


def _run(trace, works=(W_FLOPS, W_BYTES)):
    units = [{"tokens": 10, "model_flops": 0.0, "attn": w} for w in works]
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
    # the attention forwards launched 'fwd_kernel' and 'gemm': 3 s for
    # bounds of 0.25 s (unit 1) and 0.1 s (unit 2; no device time of its
    # own, the bound still counts against the calls' device time)
    for name in ("attn_fwd_roofline.train", "attn_fwd_roofline.infer"):
        assert _read(name, run) == pytest.approx(100.0 * 0.35 / 3.0)


def _one_unit(calls):
    """One unit [0, 10]; an attention forward at each ``(start, end)`` of
    ``calls``, the k-th launching a kernel of ``k + 1`` seconds."""
    evs = [_Ev(tracing.WINDOW, 0.0, 10.0), _Ev(tracing.UNIT, 0.0, 10.0)]
    for k, (s, e) in enumerate(calls):
        evs += [_Ev(ATTN_FWD, s, e),
                _Ev("cudaLaunchKernel", s + 0.1, s + 0.2, corr=20 + k),
                _Ev("attn_kernel", e, e + k + 1, dev="CUDA", corr=20 + k)]
    return tracing.read_events(evs)


def test_each_call_gets_its_own_work():
    """Two calls of different work in one unit: the bound is summed call
    by call, each its own work, in the order the calls start."""
    run = _run(_one_unit([(1.0, 2.0), (4.0, 5.0)]),
               works=[[W_FLOPS, W_BYTES]])
    assert [c[:2] + (c[3],) for c in readers.call_works(run, ATTN_FWD)] \
        == [(1.0, 2.0, W_FLOPS), (4.0, 5.0, W_BYTES)]
    assert [c[3] for c in readers.call_works(run, ATTN_FWD, reverse=True)] \
        == [W_BYTES, W_FLOPS]
    # device time 1 s + 2 s; bounds 0.25 s + 0.1 s, each once
    assert readers.attn_roofline(run, ATTN_FWD) == pytest.approx(
        100.0 * 0.35 / 3.0)
    assert readers.attn_roofline(run, ATTN_FWD, factor=2) == pytest.approx(
        100.0 * 0.7 / 3.0)
    # one work for the unit: every call has it
    run = _run(run.trace, works=[W_FLOPS])
    assert readers.attn_roofline(run, ATTN_FWD) == pytest.approx(
        100.0 * 0.5 / 3.0)


@pytest.mark.parametrize("works", [[W_FLOPS], [W_FLOPS, W_BYTES, W_FLOPS]],
                         ids=["fewer", "more"])
def test_a_list_that_misses_the_calls_raises(works):
    run = _run(_one_unit([(1.0, 2.0), (4.0, 5.0)]), works=[works])
    with pytest.raises(AssertionError, match="2 calls"):
        readers.attn_roofline(run, ATTN_FWD)


def test_a_wrong_number_of_unit_spans_raises():
    run = _run(_one_unit([(1.0, 2.0)]), works=[W_FLOPS, W_BYTES])
    with pytest.raises(AssertionError, match="1 unit spans for 2 units"):
        readers.attn_roofline(run, ATTN_FWD)


def test_idle_gaps_are_named_by_the_program_span():
    gaps = dict(tracing.read_events(_timeline()).idle_gaps())
    assert gaps[FWD] == pytest.approx(3.0)           # [0, 3]
    # [8, 13] (a forward on thread 2 only) and [14, 20] (its middle after
    # the forward [15, 16])
    assert gaps["host, no recorded call"] == pytest.approx(11.0)


@pytest.mark.parametrize("name", READERS)
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


@pytest.mark.parametrize("cell", small.CELLS)
def test_every_attention_span_pairs_with_a_work(cell):
    """A traced window of the cell on the CPU at the program's smoke size:
    the program opens its attention spans, every unit as many, and each
    call (forward, and backward where there is one) pairs with a work."""
    ctx = harness.context(cell, 2 ** 31 + 7, 0.2, True, device="cpu",
                          smoke=True, traffic_overrides=small.smoke(cell))
    driver = harness.driver_of(ctx)
    state = driver.setup(ctx)
    tracer = tracing.Tracer(True, cuda=False)
    with tracer.window():
        record = driver.window(ctx, state)
    t = tracer.trace
    run = harness.Run(units=record["units"], window=record["window"],
                      setup_s=0.0, peak_bytes=0, trace=t)
    # the benchmark's own spans are the window and the units alone
    assert {n for n, *_ in t.cpu if n.startswith("portbench.")} == {
        tracing.WINDOW, tracing.UNIT}
    for span, reverse in ((ATTN_FWD, False), (BWD, True)):
        paired = readers.call_works(run, span, reverse)
        assert len(paired) == len(t.ranges(span))
    fwd = readers.call_works(run, ATTN_FWD)
    assert fwd and len(fwd) % len(run.units) == 0
    assert all(w["flops"] > 0 and w["bytes"] > 0 for *_, w in fwd)
