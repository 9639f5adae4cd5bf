"""The trace's arithmetic on a hand-made timeline: busy time as the union
of device intervals inside the window, attribution of device operations
to the host range that launched them, and the naming of idle gaps."""
import dataclasses

import pytest

from portbench import readers, tracing

ATTN = "repro_torch.attn.fwd"


@dataclasses.dataclass
class _Ev:
    """The accessors of a kineto event that ``read_events`` uses."""
    n: str
    s: float
    e: float
    dev: str = "CPU"
    tid: int = 1
    corr: int = 0
    linked: int = 0
    annotation: bool = False
    node: bool = False

    def name(self):
        return self.n

    def start_ns(self):
        return int(self.s * 1e9)

    def duration_ns(self):
        return int((self.e - self.s) * 1e9)

    def device_type(self):
        return type("D", (), {"name": self.dev})

    def start_thread_id(self):
        return self.tid

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return self.annotation

    def scope(self):
        from torch._C._profiler import RecordScope
        return (RecordScope.BACKWARD_FUNCTION if self.node
                else RecordScope.FUNCTION)


def _timeline():
    return [
        _Ev(tracing.WINDOW, 0.0, 10.0),
        _Ev(tracing.UNIT, 0.0, 10.0),
        _Ev(ATTN, 1.0, 2.0),
        _Ev("cudaLaunchKernel", 1.5, 1.6, corr=7),
        _Ev("MmBackward0", 5.0, 6.0, tid=2, node=True),
        _Ev("cudaLaunchKernel", 5.5, 5.6, tid=2, corr=8),
        _Ev("cudaStreamSynchronize", 8.0, 9.5, corr=9),
        _Ev("attn_kernel", 2.0, 4.0, dev="CUDA", corr=7),
        _Ev("gemm", 3.0, 7.0, dev="CUDA", corr=8),
        _Ev("Stream Sync", 8.0, 9.0, dev="CUDA"),
        _Ev(ATTN, 1.0, 4.0, dev="CUDA", annotation=True),
    ]


def test_read_events_and_busy():
    t = tracing.read_events(_timeline())
    assert t.window == pytest.approx((0.0, 10.0))
    assert [op[0] for op in t.device] == ["attn_kernel", "gemm"]
    assert t.busy_s() == pytest.approx(5.0)          # [2, 7]
    assert t.window_s() == pytest.approx(10.0)


def test_launch_attribution():
    t = tracing.read_events(_timeline())
    attn = t.launched_in(t.ranges(ATTN))
    assert [op[0] for op in attn] == ["attn_kernel"]
    bwd = t.launched_in(t.ranges(tracing.BACKWARD))
    assert [op[0] for op in bwd] == ["gemm"]


def test_idle_gaps_named_by_innermost_host_event():
    t = tracing.read_events(_timeline())
    gaps = dict(t.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(3.0)   # [7, 10]
    assert gaps[ATTN] == pytest.approx(2.0)                       # [0, 2]
    assert sum(gaps.values()) == pytest.approx(5.0)


def test_readers_on_the_timeline():
    t = tracing.read_events(_timeline())
    unit = {"t0": 0.0, "t1": 10.0, "tokens": 100, "model_flops": 9.89e12,
            "attn": {"flops": 0.0, "bytes": 3.35e12}, "latency": 10.0}
    run = type("R", (), {"trace": t, "units": [unit], "window": (0, 10.0)})
    assert readers.idle_share(run) == pytest.approx(50.0)
    assert readers.backward_share(run) == pytest.approx(80.0)    # 4 of 5 s
    assert readers.attn_roofline(run, ATTN) == pytest.approx(50.0)  # 1 s of 2
    assert readers.mfu(run) == pytest.approx(0.1)
    assert readers.rate(run) == pytest.approx(10.0)
    assert readers.p95_ms(run) == pytest.approx(1e4)
