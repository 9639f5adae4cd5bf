"""The yardstick's counts and statistics on hand-worked cases."""
import statistics

import pytest

from portbench import yardstick


def test_attention_pairs_exact_triangle():
    assert yardstick.attention_pairs(4, 4, causal=True) == 10
    assert yardstick.attention_pairs(4, 4, causal=False) == 16
    # two queries at the end of six keys see 5 and 6 keys
    assert yardstick.attention_pairs(2, 6, causal=True) == 11


def test_attention_call_flops_and_bytes():
    # B 1, H 2, N = M = 3 causal: 6 pairs a head, 12 in all;
    # 2 (D + R) + 2 D = 2 * 6 + 2 * 4 = 20 FLOPs a pair
    w = yardstick.attention_call(batch=1, heads=2, nq=3, nk=3, head_dim=4,
                                 rank=2, causal=True)
    assert w["flops"] == 12 * 20
    # q, k, v, o of 1 x 2 x 3 x 4 bf16 elements
    assert w["bytes"] == 4 * 24 * 2


def test_pde_call_counts_data_factors():
    spec = {"n_heads": 8, "head_dim": 16,
            "attention": {"causal": False, "rank": 9, "data_factors": True}}
    w = yardstick.attention_work(spec, 1, 32186)
    pairs = 8 * 32186 ** 2
    assert w["flops"] == pairs * (2 * 25 + 2 * 16)
    # phi_q per point and head, phi_k per point, float32
    assert w["bytes"] == 2 * 8 * 16 * 4 * 32186 + 4 * 32186 * 9 * 9
    assert yardstick.bound_seconds(w["flops"], w["bytes"]) == \
        pytest.approx(0.6871e-3, rel=1e-3)


def test_model_flops():
    small = {"family": "pde", "n_layers": 2, "d_model": 4, "n_heads": 2,
             "head_dim": 2, "d_ff": 8, "coord_dim": 3, "out_channels": 1}
    # in 3 x 4; per layer q k v 3 * 4 * 4, o 4 * 4, alpha 3 * 2, MLP
    # 2 * 4 * 8; head 4 x 1
    n = 12 + 2 * (48 + 16 + 6 + 64) + 4
    assert yardstick.pde_matmul_params(small) == n
    assert yardstick.model_flops(small, 5, 7.0, train=True) == \
        6 * n * 5 + 21
    assert yardstick.model_flops(small, 5, 7.0, train=False) == \
        2 * n * 5 + 7
    pde = {"family": "pde", "n_layers": 8, "d_model": 128, "n_heads": 8,
           "head_dim": 16, "d_ff": 256, "coord_dim": 3, "out_channels": 4}
    assert yardstick.pde_matmul_params(pde) == 1049664


def test_p95_and_spread():
    values = list(range(1, 101))
    assert yardstick.p95(values) == pytest.approx(95.05)
    assert yardstick.p95([3.0]) == 3.0
    q1, q2, q3 = statistics.quantiles([1, 2, 3, 4, 5], n=4)
    assert yardstick.spread([1, 2, 3, 4, 5]) == pytest.approx((q3 - q1) / q2)


def test_union():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.8)]
    assert yardstick.union(iv) == [(0, 3), (5, 6)]
