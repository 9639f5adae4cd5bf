"""Units for the port's statcheck (``repro_torch.statcheck``), the
counterpart of ``tests/test_statcheck.py``: a positive and a negative unit
for every rule, on op logs of small tensor programs and on inline source
snippets; the repository's own lint run; the contracts over all five
families with the tripwire, on the CPU; and the Eq. 3 fold of the port's
plain attentions against the reference's ``attention`` on the same numpy
inputs.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro_torch.core import attention as TA
from repro_torch.kernels.flashbias_attn import flashbias_attention_torch
from repro_torch.statcheck import contracts
from repro_torch.statcheck.hostlint import lint_cuda, lint_file, lint_tree
from repro_torch.statcheck.oplog_rules import (OpRecord, TensorMeta,
                                               count_op, eq3_fold_present,
                                               no_host_sync,
                                               no_pool_relayout,
                                               pool_threshold_for, record)

ROOT = Path(__file__).resolve().parents[1]
POOL = 64 * 64                  # a pool-sized threshold for the units


def _ops(fn, *args):
    return record(fn, *args)[1]


# ------------------------------------------------------------- op-log rules

class TestOpLog:
    def test_records_shapes_devices_and_kinds(self):
        x = torch.zeros(4, 8)
        ops = _ops(lambda t: t.t().contiguous().add_(1), x)
        names = [op.name for op in ops]
        assert names == ["t", "clone", "add_"]
        t, clone, add = ops
        assert t.view and not t.inplace and add.inplace
        assert clone.inputs[0].shape == (8, 4) \
            and not clone.inputs[0].contiguous
        assert clone.outputs[0].device == torch.device("cpu")

    def test_count_op_with_size_floor(self):
        ops = _ops(lambda a, b: (a.t().contiguous(), b.t().contiguous()),
                   torch.zeros(64, 64), torch.zeros(2, 2))
        assert count_op(ops, "clone") == 2
        assert count_op(ops, "clone", min_operand_size=1000) == 1


class TestNoPoolRelayout:
    def test_flags_pool_sized_permute_contiguous(self):
        ops = _ops(lambda x: x.permute(1, 0, 2).contiguous(),
                   torch.zeros(16, 16, 16))
        found = no_pool_relayout(ops, POOL, program="t")
        assert len(found) == 1 and found[0].rule == "no-pool-relayout"
        assert found[0].op.startswith("clone")

    def test_passes_token_sized_permute(self):
        ops = _ops(lambda x: x.permute(1, 0, 2).contiguous(),
                   torch.zeros(4, 2, 8))
        assert no_pool_relayout(ops, POOL, program="t") == []

    def test_flags_copy_back_broadcast_and_convert(self):
        def f(pool, other):
            pool.copy_(other.t())                    # transposed write-back
            pool.to(torch.bfloat16)                  # dtype conversion
            pool[None].expand(2, 64, 64)             # broadcast
            return pool.repeat(2, 1)
        ops = _ops(f, torch.zeros(64, 64), torch.zeros(64, 64))
        hit = sorted(f.op.split(" ")[0]
                     for f in no_pool_relayout(ops, POOL, program="t"))
        assert hit == ["_to_copy", "copy_", "expand", "repeat"]

    def test_gathers_and_row_writes_are_exempt(self):
        def f(pool, row, idx):
            pool[idx] = row                          # Θ(row) in place
            pool.copy_(pool * 2)                     # contiguous source
            return pool[torch.arange(64)], pool.gather(0, idx[:, None]
                                                       .expand(1, 64))
        ops = _ops(f, torch.zeros(64, 64), torch.zeros(64),
                   torch.tensor([3]))
        assert no_pool_relayout(ops, POOL, program="t") == []

    def test_threshold_must_be_positive(self):
        with pytest.raises(ValueError):
            no_pool_relayout([], 0, program="t")


class TestNoHostSync:
    def test_flags_item(self):
        ops = _ops(lambda x: x.sum().item(), torch.ones(4))
        found = no_host_sync(ops, program="t")
        assert [f.rule for f in found] == ["no-host-sync"]
        assert "_local_scalar_dense" in found[0].op

    def test_flags_a_copy_to_another_device(self):
        ops = _ops(lambda x: x.to("meta"), torch.ones(4))
        found = no_host_sync(ops, program="t")
        assert found and "moves data" in found[0].message

    def test_clean_program_passes(self):
        ops = _ops(lambda x: (x * 2).sum(), torch.ones(4))
        assert no_host_sync(ops, program="t") == []

    @staticmethod
    def _copy(src: str, dst: str) -> OpRecord:
        meta = lambda d: TensorMeta((2,), torch.int64, torch.device(d), True)
        return OpRecord("_to_copy", (meta(src),), (meta(dst),), False, False)

    def test_host_arguments_copied_in_pass_where_declared(self):
        """``copy_pages``' host-planned page ids: copied onto the card is
        the arguments' transfer, read back to the host is still a sync."""
        up, down = self._copy("cpu", "cuda"), self._copy("cuda", "cpu")
        assert [f.rule for f in no_host_sync([up], program="t")] == [
            "no-host-sync"]
        assert no_host_sync([up], program="t", args_from_host=True) == []
        found = no_host_sync([down], program="t", args_from_host=True)
        assert [f.rule for f in found] == ["no-host-sync"]

    def test_item_in_a_decode_step_is_flagged(self, monkeypatch):
        """A ``.item()`` slipped into ``model.decode`` shows in the
        contract's log of the backend's decode step."""
        cfg = contracts.FAMILIES["dense"]()
        (_, be), = contracts._token_backends(cfg, torch.device("cpu"),
                                             0)[:1]
        decode = be.model.decode

        def syncing(params, cache, tokens, max_pages=None):
            int(cache["length"].max())
            return decode(params, cache, tokens, max_pages=max_pages)
        be.model = dataclasses.replace(be.model, decode=syncing)
        found, _ = contracts.check_token_backend(be, "dense/decode")
        assert [f.rule for f in found] == ["no-host-sync"]


class TestEq3Fold:
    def test_fold_seen(self):
        ops = _ops(lambda q, p: torch.cat([q, p], -1),
                   torch.zeros(2, 4, 32), torch.zeros(2, 4, 8))
        assert eq3_fold_present(ops, 32, 8, program="t") == []

    def test_missing_fold_flagged(self):
        ops = _ops(lambda q: q @ q.T, torch.zeros(4, 32))
        found = eq3_fold_present(ops, 32, 8, program="t")
        assert found and found[0].rule == "eq3-fold"

    def test_wrong_width_cat_not_mistaken_for_fold(self):
        ops = _ops(lambda q, p: torch.cat([q, p], -1),
                   torch.zeros(2, 4, 32), torch.zeros(2, 4, 4))
        assert eq3_fold_present(ops, 32, 8, program="t")

    def test_pairformer_step_without_the_fold_is_flagged(self, monkeypatch):
        """With the fold switched off in the plain attention, the
        Pairformer family's contract misses it."""
        from repro_torch.kernels import flashbias_attn
        monkeypatch.setattr(flashbias_attn, "eq3_folds",
                            lambda *a: False)
        found = contracts.check_family("pairformer")
        assert [f.rule for f in found] == ["eq3-fold"]


class TestPoolThreshold:
    def test_kv_leaves_per_layer(self):
        cache = {"pages_k": torch.zeros(2, 2, 32, 4, 40),
                 "pages_v": torch.zeros(2, 2, 32, 4, 40),
                 "length": torch.zeros(4, dtype=torch.int32)}
        assert pool_threshold_for(cache, 2) == 2 * 32 * 4 * 40

    def test_ssm_fallback(self):
        cache = {"ssm_h": torch.zeros(2, 4, 8, 16),
                 "length": torch.zeros(4, dtype=torch.int32)}
        assert pool_threshold_for(cache, 2) == 4 * 8 * 16

    def test_none_when_nothing_pool_shaped(self):
        assert pool_threshold_for(
            {"length": torch.zeros(4, dtype=torch.int32)}, 2) is None


# ------------------------------------------------------------- contracts

def _paged_backend():
    cfg = contracts.FAMILIES["dense"]()
    return dict(contracts._token_backends(cfg, torch.device("cpu"),
                                          0))["paged"]


class TestShapeKeys:
    def test_keys_counted_within_the_bound(self):
        be = _paged_backend()
        be.ensure_state()
        keys = {be.page_cap({0: SimpleNamespace(length=n)})
                for n in range(be.pages_per_slot * be.page_size)}
        assert len(keys) == be.pages_per_slot.bit_length() == 6
        assert contracts.shape_key_bound(be, "dense") == []

    def test_unrounded_page_cap_is_flagged(self, monkeypatch):
        be = _paged_backend()
        monkeypatch.setattr(be, "page_cap", lambda live: max(
            1, -(-(max(st.length for st in live.values()) + 1)
                 // be.page_size)))
        found = contracts.shape_key_bound(be, "dense")
        assert [f.rule for f in found] == ["shape-key-bound"]
        assert "decode" in found[0].program

    def test_a_chunk_width_that_varies_is_flagged(self, monkeypatch):
        be = _paged_backend()
        monkeypatch.setattr(be, "_chunk_page_cap", lambda: 1 + max(
            p.done for p in be._pending.values()) // be.page_size)
        found = contracts.shape_key_bound(be, "dense")
        assert [f.program for f in found] == ["dense/prefill_chunk"]


def test_launches_are_read_from_the_counters():
    """On the CPU the wrappers run their plain versions: a decode step
    moves no counter; a counter that moves is a finding there."""
    assert contracts.check_launches({}, {}, program="t") == []
    found = contracts.check_launches({"flash_decode_fwd": 2}, {},
                                     program="t")
    assert found and found[0].rule == "kernel-launches"


def test_contracts_hold_for_every_family_with_the_tripwire():
    assert contracts.run_contracts(list(contracts.FAMILIES)) == []


def test_tripwire_fires_on_a_pool_transpose():
    """Under the legacy adapter both of the dense family's decode steps
    trip the relayout rule in every layer, for each cache; the contracts
    without it hold (``test_contracts_hold_...``)."""
    cfg = contracts.FAMILIES["dense"]()
    with contracts.legacy_adapter():
        for kind, be in contracts._token_backends(cfg, torch.device("cpu"),
                                                  0):
            found = contracts.check_token_backend(be, kind)[0]
            rules = {f.rule for f in found}
            assert rules == {"no-pool-relayout"}, found
            # at least a transposed copy and a write-back per cache, layer
            assert len(found) >= 2 * 2 * cfg.n_layers
    assert contracts.verify_tripwire() == []


def test_tripwire_without_teeth_is_a_finding(monkeypatch):
    """With the adapter made a no-op the relayout rule cannot fire: the
    self-test reports it."""
    import contextlib
    monkeypatch.setattr(contracts, "legacy_adapter", contextlib.nullcontext)
    found = contracts.verify_tripwire()
    assert [f.rule for f in found] == ["tripwire-self-test"]
    assert found[0].program == ("dense/decode[contiguous],"
                                "dense/decode[paged]")


def _script():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import run_statcheck_torch as script
    finally:
        sys.path.pop(0)
    return script


def test_script_fails_with_the_pool_transpose_wrapped_in(capsys):
    script = _script()
    assert script.main(["--families", "dense", "--no-lint", "--device",
                        "cpu", "--skip-negative"]) == 0
    assert script.main(["--families", "dense", "--no-lint", "--device",
                        "cpu", "--pool-transpose"]) == 1
    assert "[no-pool-relayout] dense/decode" in capsys.readouterr().err


def test_script_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """No ``--device``: the card, and an error where there is none (never
    a quiet run on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script().main(["--families", "dense", "--no-lint",
                        "--skip-negative"])


def test_lint_only_imports_no_torch():
    code = ("import runpy, sys; sys.argv = ['s', '--lint-only']\n"
            "try:\n    runpy.run_path(sys.argv0, run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "assert 'torch' not in sys.modules\n")
    code = code.replace("sys.argv0", repr(str(
        ROOT / "scripts" / "run_statcheck_torch.py")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "statcheck passed (lint)" in out.stdout


# -------------------------------------------------------------- hostlint

def _lint_src(tmp_path, source, **roles):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent(source))
    return lint_file(str(p), **roles)


class TestHostTorch:
    def test_flags_torch_import_and_use(self, tmp_path):
        found = _lint_src(tmp_path, """
            import torch
            def free(pages):
                return torch.tensor(pages).sum()
            """, host=True)
        assert [f.rule for f in found] == ["host-torch", "host-torch"]

    def test_flags_from_import(self, tmp_path):
        found = _lint_src(tmp_path, """
            from torch import tensor
            x = tensor([1])
            """, host=True)
        assert len(found) == 2 and {f.rule for f in found} == {"host-torch"}

    def test_suppression_comment(self, tmp_path):
        assert _lint_src(tmp_path, """
            import torch  # statcheck: allow(host-torch)
            """, host=True) == []

    def test_numpy_and_the_port_package_are_fine(self, tmp_path):
        assert _lint_src(tmp_path, """
            import numpy as np
            from repro_torch.serve.lifecycle import PoolError
            def free(pages):
                return np.sum(pages)
            """, host=True) == []


class TestHostAssert:
    def test_flags_bare_assert(self, tmp_path):
        found = _lint_src(tmp_path, """
            def free(pages, refs):
                assert refs[pages[0]] > 0, "double free"
            """, host=True)
        assert [f.rule for f in found] == ["host-assert"]
        assert "python -O" in found[0].message

    def test_suppression_comment(self, tmp_path):
        assert _lint_src(tmp_path, """
            def free(pages, refs):
                assert refs[pages[0]] > 0  # statcheck: allow(host-assert)
            """, host=True) == []

    def test_typed_raise_is_fine(self, tmp_path):
        assert _lint_src(tmp_path, """
            def free(pages, refs):
                if refs[pages[0]] <= 0:
                    raise PoolError("double free")
            """, host=True) == []

    def test_serve_only_module_exempt(self, tmp_path):
        assert _lint_src(tmp_path, """
            def validate(x):
                assert x.ndim == 2
            """, serve=True) == []


class TestHostSync:
    def test_flags_cuda_synchronize(self, tmp_path):
        found = _lint_src(tmp_path, """
            import torch
            def step(self):
                torch.cuda.synchronize()
            """, serve=True)
        assert [f.rule for f in found] == ["host-sync"]

    @pytest.mark.parametrize("call", ["cpu()", "numpy()", "item()",
                                      "tolist()"])
    def test_flags_read_back_of_device_state_in_loop(self, tmp_path, call):
        found = _lint_src(tmp_path, f"""
            def drain(self):
                out = []
                for _ in range(8):
                    out.append(self._cache["length"].{call})
                return out
            """, serve=True)
        assert [f.rule for f in found] == ["host-sync"]

    def test_read_back_outside_loop_passes(self, tmp_path):
        assert _lint_src(tmp_path, """
            def snapshot(self):
                return self._cache["length"].cpu().numpy()
            """, serve=True) == []

    def test_suppression_comment(self, tmp_path):
        assert _lint_src(tmp_path, """
            def drain(self):
                while True:
                    x = self.logits.item()  # statcheck: allow(host-sync)
            """, serve=True) == []


class TestPageTableClamp:
    def test_unclamped_read_flagged(self, tmp_path):
        found = _lint_src(tmp_path, """
            def pages(page_table, rows, blocks):
                return page_table[rows, blocks].long()
            """, kernel=True)
        assert [f.rule for f in found] == ["page-table-clamp"]

    def test_unclamped_gather_flagged(self, tmp_path):
        found = _lint_src(tmp_path, """
            def pages(page_table, blocks):
                return page_table.long().gather(1, blocks)
            """, kernel=True)
        assert [f.rule for f in found] == ["page-table-clamp"]

    def test_clamped_read_passes(self, tmp_path):
        assert _lint_src(tmp_path, """
            import torch
            def pages(page_table, blocks, n_pages, last):
                blocks = torch.minimum(blocks, last)
                return page_table.gather(1, blocks).clamp(0, n_pages - 1)
            """, kernel=True) == []

    def test_shape_reads_are_not_table_reads(self, tmp_path):
        assert _lint_src(tmp_path, """
            def width(page_table):
                return page_table.shape[1]
            """, kernel=True) == []

    def test_suppression_comment(self, tmp_path):
        assert _lint_src(tmp_path, """
            def pages(page_table, i):  # statcheck: allow(page-table-clamp)
                return page_table[i]
            """, kernel=True) == []


def _lint_cu(tmp_path, source):
    p = tmp_path / "k.cu"
    p.write_text(textwrap.dedent(source))
    return lint_cuda(str(p))


class TestCudaPageTableClamp:
    def test_unbounded_block_index_flagged(self, tmp_path):
        found = _lint_cu(tmp_path, """
            int page = a.page_table[b * a.P + key / a.ps];
            page = min(max(page, 0), a.n_pages - 1);
            """)
        assert len(found) == 1 and "block index" in found[0].message

    def test_unclamped_page_flagged(self, tmp_path):
        found = _lint_cu(tmp_path, """
            int page = a.page_table[b * a.P + min(key / a.ps, a.P - 1)];
            sRow[j] = page * a.ps;
            """)
        assert len(found) == 1 and "clamped" in found[0].message

    def test_clamped_reads_pass(self, tmp_path):
        assert _lint_cu(tmp_path, """
            // page_table[b, j] in a comment is not a read
            page0 = min(max(a.page_table[b * a.P + min(k / a.ps, a.P - 1)],
                            0), a.n_pages - 1);
            int page = split == 0
                           ? page0
                           : a.page_table[b * a.P + min(k / a.ps, a.P - 1)];
            page = min(max(page, 0), a.n_pages - 1);
            const int p = a.page_table[b * a.P + min(pos / a.ps, a.P - 1)];
            if (p >= 0 && p < a.n_pages) w_row = p * a.ps;
            """) == []

    def test_suppression_comment(self, tmp_path):
        assert _lint_cu(tmp_path, """
            int page = a.page_table[b];  // statcheck: allow(page-table-clamp)
            """) == []


def test_repo_port_is_lint_clean():
    """The port's serve modules, kernel wrappers and decode kernel source
    have zero findings."""
    assert lint_tree(str(ROOT)) == []
    assert (ROOT / "src/repro_torch/csrc/flash_decode.cu").exists()


# ------------------------------------------------- the Eq. 3 fold, ported

def _inputs(h, kvh, phi_heads, seed=0, b=2, n=40, d=16, r=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, x, d)).astype(np.float32)
               for x in (h, kvh, kvh))
    pq = rng.standard_normal((b, n, h, r)).astype(np.float32)
    pk = rng.standard_normal((b, n, phi_heads, r)).astype(np.float32)
    return q, k, v, pq, pk


def _reference(q, k, v, pq, pk, dtype=jnp.float32, **kw):
    return np.asarray(JA.attention(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
        phi_q=jnp.asarray(pq), phi_k=jnp.asarray(pk), **kw)
        .astype(jnp.float32))


@pytest.mark.parametrize("h,kvh,phi_heads,folds", [
    (4, 4, 1, True),      # shared key factor
    (4, 2, 2, True),      # per kv head (GQA)
    (4, 2, 4, False),     # per q head under GQA: two products
])
@pytest.mark.parametrize("mask", ["none", "causal"])
def test_plain_attention_folds_where_the_reference_does(h, kvh, phi_heads,
                                                        folds, mask):
    q, k, v, pq, pk = _inputs(h, kvh, phi_heads)
    want = _reference(q, k, v, pq, pk, mask=JA.MaskSpec(mask),
                      impl="chunked", chunk_size=16)
    t = [torch.from_numpy(x) for x in (q, k, v, pq, pk)]
    got, ops = record(lambda: TA.attention(
        *t[:3], phi_q=t[3], phi_k=t[4], mask=TA.MaskSpec(mask),
        impl="chunked", chunk_size=16))
    assert (eq3_fold_present(ops, 16, 8, program="t") == []) == folds
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_attention_keeps_two_products_for_bf16_q():
    """Mixed precision (float32 factors against a bf16 q): no fold, as in
    the reference; both round a float32 result to bf16 once, so they
    agree to one bf16 ulp at the output's scale."""
    q, k, v, pq, pk = _inputs(4, 4, 1)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    qb, kb, vb = (x.bfloat16() for x in t)
    got, ops = record(lambda: TA.attention(
        qb, kb, vb, phi_q=torch.from_numpy(pq), phi_k=torch.from_numpy(pk)))
    assert eq3_fold_present(ops, 16, 8, program="t")
    want = _reference(*(x.float().numpy() for x in (qb, kb, vb)), pq, pk,
                      dtype=jnp.bfloat16)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * scale)


def test_kernel_plain_version_folds_as_the_reference():
    """The kernels' plain version (the pair step's plain path) folds under
    the same condition, head-major in and out."""
    q, k, v, pq, pk = _inputs(4, 4, 1)
    want = _reference(q, k, v, pq, pk)
    hm = lambda x: torch.from_numpy(x).transpose(1, 2)
    got, ops = record(lambda: flashbias_attention_torch(
        hm(q), hm(k), hm(v), hm(pq), hm(pk), scale=16 ** -0.5))
    assert eq3_fold_present(ops, 16, 8, program="t") == []
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                               atol=1e-5, rtol=1e-5)
