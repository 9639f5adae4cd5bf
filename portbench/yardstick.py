"""The benchmark's yardstick: the card's data-sheet peaks, the work a call
or a step needs (counted from the published shapes and the traffic, never
from what an implementation pads), and the statistics every metric uses.

Later changes to the program leave this file alone, so a metric reads the
same work whatever computes it. Nothing here imports the program.
"""
from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet, dense rates, at the card's full power limit
PEAK_BF16_FLOPS = 989e12          # FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12         # bytes/s
HBM_BYTES = 80e9                  # bytes of device memory

GIB = 2 ** 30


def attention_pairs(nq: int, nk: int, causal: bool) -> int:
    """Query-key pairs a head scores: the exact causal triangle (queries at
    the last ``nq`` of ``nk`` positions), or the full rectangle."""
    if not causal:
        return nq * nk
    first = nk - nq               # keys every query sees before its own
    return nq * first + nq * (nq + 1) // 2


def attention_call(*, batch: int, heads: int, nq: int, nk: int,
                   head_dim: int, rank: int, causal: bool,
                   act_bytes: int = 2, factor_bytes: int = 0) -> dict:
    """FLOPs and bytes of one FlashBias attention forward.

    FLOPs: the scores with the factored bias, ``2 (D + R)`` a pair and
    head, and the value product, ``2 D`` a pair and head. Bytes: q, k, v
    and o once each in the compute dtype (``act_bytes`` an element),
    plus ``factor_bytes`` for factors that depend on the data (ALiBi's are
    made in the kernel and add none)."""
    pairs = batch * heads * attention_pairs(nq, nk, causal)
    flops = 2 * pairs * (head_dim + rank) + 2 * pairs * head_dim
    nbytes = act_bytes * batch * heads * head_dim * (2 * nq + 2 * nk)
    return {"flops": float(flops), "bytes": float(nbytes + factor_bytes)}


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def pde_matmul_params(spec: dict) -> int:
    """Parameters of the PDE solver that multiply an activation: the input
    projection, per layer q k v, o, the alpha map of the coordinates and
    the GELU MLP, and the output head."""
    d, h, hd, f = (spec["d_model"], spec["n_heads"], spec["head_dim"],
                   spec["d_ff"])
    c, out = spec["coord_dim"], spec["out_channels"]
    per_layer = 3 * d * h * hd + h * hd * d + c * h + 2 * d * f
    return c * d + spec["n_layers"] * per_layer + d * out


def model_flops(spec: dict, tokens: int, attn_flops: float,
                train: bool) -> float:
    """Model FLOPs: ``2 N T`` plus the attention forward for inference,
    ``6 N T`` plus three times it for a training step (forward, and the
    backward's two products); recomputation is not counted. ``N`` is the
    family's ``matmul_params`` (``families/<family>.py``)."""
    from portbench import port
    n = port.family(spec).matmul_params(spec)
    if train:
        return 6.0 * n * tokens + 3.0 * attn_flops
    return 2.0 * n * tokens + attn_flops


def p95(values) -> float:
    """The 95th percentile (inclusive method of ``statistics.quantiles``)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def spread(values) -> float:
    """Distance between the first and third quartile over the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals) -> list:
    """Merged ``[(start, end)]`` of possibly overlapping intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def attention_work(spec: dict, batch: int, n: int) -> dict:
    """One attention call of the configuration at ``batch`` rows of ``n``
    positions: ``spec["attention"]`` gives the mask, the bias's rank and
    whether its float32 factors come from the data (then ``phi_q`` per
    query and head and ``phi_k`` per key, shared by the heads, count as
    bytes)."""
    att = spec["attention"]
    heads, rank = spec["n_heads"], att["rank"]
    factor_bytes = 4 * batch * n * rank * (heads + 1) \
        if att["data_factors"] else 0
    return attention_call(batch=batch, heads=heads, nq=n, nk=n,
                          head_dim=spec["head_dim"], rank=rank,
                          causal=att["causal"], factor_bytes=factor_bytes)
