"""Contract checker for the port's serve steps (port of
``repro.statcheck.contracts``).

``check_family`` builds the real serve backend for one cache family at
smoke scale, admits a wave of requests, logs one decode step of each cache
kind (``TokenDecodeBackend.decode_logits``: ``model.decode``, not the
sampler, whose two read-backs per step are by design) under
``oplog_rules.OpLog``, and runs the rules over the log:

- ``no-pool-relayout`` on the decode step and on the prefix cache's
  ``copy_pages`` (a page copy stays a gather and a scatter of pages);
- ``no-host-sync`` on the decode and refinement steps, and on
  ``copy_pages``, whose page ids come from the host by design: there only
  a read back to the host fails;
- ``eq3-fold`` on the Pairformer's plain-path refinement step
  (``attn_impl="torch"``) with float32 flashbias factors;
- ``shape-key-bound`` (the reference's ``recompile-bound``): the
  backend's own ``page_cap`` over every live length takes at most
  ``log2(pages_per_slot) + 1`` distinct ``max_pages`` keys, and the chunk
  step (``_chunk_page_cap``, the table's full width) one: the keys CUDA
  graphs would be captured under;
- ``kernel-launches``: the decode kernels' ``.launches`` counters move by
  one per attention layer where the step runs on the card (kernel 3 on a
  contiguous cache, kernel 4 on a paged pool, kernel 2 in the Pairformer's
  step), and not at all on the CPU, whose wrappers run their plain
  versions; the kernels themselves never reach the op log.

Families, at the reference's smoke sizes: ``dense`` (stablelm), ``moe``
(granite), ``ring`` (stablelm with window 8), ``ssm`` (mamba2) and
``pairformer`` (pairformer_lite). Dense and MoE log a contiguous and a
paged step (the paged one chunked, with the prefix cache, as the
reference traces it); ring and SSM caches are not paged.

``verify_tripwire`` is the reference's negative control. The port refuses
``cache_layout="legacy"`` (``models/lm.py``), so the control wraps the
decode op instead (``legacy_adapter``): every call transposes its
per-layer cache or pool to the canonical ``(.., S, KVH, hd)`` layout and
back, as the reference's legacy adapters did, and ``no-pool-relayout``
must fire. ``device`` says where the checks run: on the card
``no-host-sync`` also sees device-to-host copies, and the launch counters
move.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.statcheck.oplog_rules import (
    Finding,
    OpRecord,
    eq3_fold_present,
    no_host_sync,
    no_pool_relayout,
    pool_threshold_for,
    record,
)

__all__ = ["FAMILIES", "check_family", "check_token_backend",
           "check_pair_backend", "shape_key_bound", "launch_counts",
           "legacy_adapter", "verify_tripwire", "run_contracts", "fill"]

# smoke-scale serve dimensions shared by every family check
MAX_LEN = 32
N_SLOTS = 4
PAGE_SIZE = 4
CHUNK = 4
RING_WINDOW = 8        # 0 < window < MAX_LEN -> ring KV
PAIR_MAX_LEN = 16
PAIR_FEATS = 64        # pairformer stub residue-feature width
PROMPTS = (5, 9, 3, 12)          # prompt lengths of the admitted wave
PAIR_RESIDUES = (11, 16)         # n_res of the admitted complexes

# family -> smoke ArchConfig. "ring" is the dense arch with a sliding
# window (the ring cache is a cache mode, not a config family).
FAMILIES: Dict[str, Callable] = {
    "dense": lambda: smoke_config("stablelm_12b"),
    "moe": lambda: smoke_config("granite_moe_3b_a800m"),
    "ring": lambda: smoke_config("stablelm_12b").replace(window=RING_WINDOW),
    "ssm": lambda: smoke_config("mamba2_130m"),
    "pairformer": lambda: smoke_config("pairformer_lite"),
}

def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's ``.launches`` counter (read from its module
    at each call, where a caller may have swapped in a stand-in)."""
    from repro_torch.kernels import flash_decode, flashbias_attn, ssd_scan
    return {name: getattr(mod, name).launches for mod, names in (
        (flash_decode, ("flash_decode_fwd", "flash_decode_paged_fwd")),
        (flashbias_attn, ("flashbias_attention_fwd",
                          "flashbias_attention_ragged_fwd")),
        (ssd_scan, ("ssd_scan_fwd",))) for name in names}


def logged(fn, *args, **kwargs) -> Tuple[object, List[OpRecord],
                                           Dict[str, int]]:
    """``fn(*args, **kwargs)``, its op log and the kernel launches it made
    (the counters that moved)."""
    before = launch_counts()
    out, ops = record(fn, *args, **kwargs)
    after = launch_counts()
    return out, ops, {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}


def _on_card(be) -> bool:
    from repro_torch.kernels.ops import resolve_impl
    return resolve_impl(be.model.cfg.attn_impl, be.device) == "cuda"


def check_launches(launches: Dict[str, int], want: Dict[str, int], *,
                   program: str) -> List[Finding]:
    if launches == want:
        return []
    return [Finding(
        rule="kernel-launches", program=program,
        message=f"kernel launches {launches}, want {want} (one per "
                f"attention layer on the card, none on the CPU)")]


def fill(be, prompts: Sequence[int] = PROMPTS, seed: int = 0) -> dict:
    """Admit one wave of random prompts of lengths ``prompts`` into slots
    0.. of a token backend (a chunked backend lands every chunk) and
    return the engine's live map ``{slot: host state}`` for ``page_cap``:
    each slot's ``length`` the position the next decode step writes."""
    from repro_torch.serve.scheduler import Request
    be.ensure_state()
    rng = np.random.default_rng(seed)
    wave = [Request(i, rng.integers(0, be.model.cfg.vocab, (n,))
                    .astype(np.int32), 4) for i, n in enumerate(prompts)]
    slots = list(range(len(wave)))
    be.admit(wave, slots)
    while be.prefill_pending():
        be.prefill_step()
    return {s: SimpleNamespace(length=r.prompt_len)
            for s, r in zip(slots, wave)}


def shape_key_bound(be, program: str) -> List[Finding]:
    """The backend's static-shape keys, enumerated through its own
    ``page_cap`` over every live length and its ``_chunk_page_cap``: at
    most ``log2(pages_per_slot) + 1`` decode keys and one chunk key."""
    if not be.paged:
        return []
    bound = be.pages_per_slot.bit_length()
    findings = []
    decode_keys = {be.page_cap({0: SimpleNamespace(length=ln)})
                   for ln in range(be.pages_per_slot * be.page_size)}
    if len(decode_keys) > bound:
        findings.append(Finding(
            rule="shape-key-bound", program=f"{program}/decode",
            message=(f"decode max_pages takes {len(decode_keys)} distinct "
                     f"values {sorted(decode_keys)} > the bound {bound} "
                     f"(log2(pages_per_slot) + 1): the power-of-two "
                     f"rounding broke")))
    if be.chunk_size:
        saved = be._pending
        try:
            keys = set()
            for done in range(be.pages_per_slot * be.page_size + 1):
                be._pending = {0: SimpleNamespace(done=done)}
                keys.add(be._chunk_page_cap())
        finally:
            be._pending = saved
        if len(keys) > 1:
            findings.append(Finding(
                rule="shape-key-bound", program=f"{program}/prefill_chunk",
                message=(f"chunk max_pages takes {len(keys)} distinct "
                         f"values {sorted(keys)}: the chunk step's width "
                         f"is fixed")))
    return findings


def check_token_backend(be, program: str, *,
                        prompts: Sequence[int] = PROMPTS,
                        seed: int = 0) -> Tuple[List[Finding],
                                                Dict[str, int]]:
    """Fill ``be`` with a wave, log one decode step, and hold it to the
    rules; returns ``(findings, kernel launches of the step)``."""
    cfg = be.model.cfg
    live = fill(be, prompts, seed)
    _, ops, launches = logged(be.decode_logits, live)
    findings = no_host_sync(ops, program=program)
    thresh = pool_threshold_for(be._cache, cfg.n_layers)
    if thresh:
        findings += no_pool_relayout(ops, thresh, program=program)
    want = {}
    if _on_card(be) and cfg.family in ("dense", "moe", "hybrid") \
            and not be.ring:
        kernel = "flash_decode_paged_fwd" if be.paged else "flash_decode_fwd"
        want = {kernel: cfg.n_layers}
    findings += check_launches(launches, want, program=program)
    if getattr(be, "_prefix", None) is not None:
        # the prefix cache's copy-on-write, held to the decode step's
        # relayout rule and to no read back to the host, as the reference
        # holds it; its page ids are planned on the host and copied in
        # by design (its arguments' transfer)
        ids = np.arange(2, dtype=np.int64)
        _, ops = record(be.model.copy_pages, be._cache, ids, ids + 2)
        findings += no_host_sync(ops, program=f"{program}/copy_pages",
                                 args_from_host=True)
        findings += no_pool_relayout(ops, thresh,
                                     program=f"{program}/copy_pages")
    findings += shape_key_bound(be, program)
    return findings, launches


def _params(cfg, device, seed: int) -> dict:
    from repro_torch.models import init_params
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, device=device)


def _token_backends(cfg, device, seed: int):
    """``[(kind, backend)]``: contiguous, and paged (chunked, with the
    prefix cache for the dense and MoE families, as the reference traces
    it) where the family pages."""
    from repro_torch.models import get_model
    from repro_torch.serve.backend import TokenDecodeBackend
    model = get_model(cfg)
    params = _params(cfg, device, seed)
    out = [("contiguous", TokenDecodeBackend(
        model, params, max_len=MAX_LEN, n_slots=N_SLOTS, device=device))]
    ring = bool(cfg.window) and cfg.window < MAX_LEN
    if cfg.family in ("dense", "moe", "hybrid") and not ring:
        kw = {"prefill_chunk": CHUNK}
        if cfg.family in ("dense", "moe"):
            kw["prefix_cache"] = True
        out.append(("paged", TokenDecodeBackend(
            model, params, max_len=MAX_LEN, n_slots=N_SLOTS,
            page_size=PAGE_SIZE, device=device, **kw)))
    return out


def _pair_backend(cfg, device, seed: int):
    from repro_torch.models import get_model
    from repro_torch.serve.backend import PairBatchBackend
    from repro_torch.serve.scheduler import Request
    model = get_model(cfg)
    be = PairBatchBackend(model, _params(cfg, device, seed),
                          max_len=PAIR_MAX_LEN, n_slots=len(PAIR_RESIDUES),
                          device=device)
    be.ensure_state()
    rng = np.random.default_rng(seed)
    wave = [Request(i, rng.standard_normal((n, PAIR_FEATS))
                    .astype(np.float32), 2)
            for i, n in enumerate(PAIR_RESIDUES)]
    be.admit(wave, list(range(len(wave))))
    return be


def check_pair_backend(be, program: str) -> Tuple[List[Finding],
                                                  Dict[str, int]]:
    """Log one refinement step of an admitted pair backend: no host sync,
    and kernel 2 once a layer on the card."""
    _, ops, launches = logged(be.step, {})
    findings = no_host_sync(ops, program=program)
    want = ({"flashbias_attention_ragged_fwd": be.model.cfg.n_layers}
            if _on_card(be) and "phi_q" in be._cache else {})
    return findings + check_launches(launches, want, program=program), \
        launches


def _check_pair_family(family: str, cfg, device, seed: int) -> List[Finding]:
    findings, _ = check_pair_backend(_pair_backend(cfg, device, seed),
                                     f"{family}/step")
    # Eq. 3: asserted on the precision-free factored path, the plain path
    # (the kernels fold in the kernel), as the reference re-traces its
    # step under attn_impl="xla" for this rule
    if cfg.bias_mode == "flashbias" and cfg.dtype == "float32":
        be = _pair_backend(cfg.replace(attn_impl="torch"), device, seed)
        program = f"{family}/step[torch]"
        _, ops = record(be.step, {})
        findings += no_host_sync(ops, program=program)
        findings += eq3_fold_present(ops, cfg.resolved_head_dim,
                                     be._cache["phi_q"].shape[-1],
                                     program=program)
    return findings


def check_family(family: str, *, device="cpu", seed: int = 0,
                 impl: str = "auto") -> List[Finding]:
    """Log the serve steps of ``family`` and return every rule violation
    (an empty list: the contracts hold)."""
    cfg = FAMILIES[family]().replace(attn_impl=impl)
    device = torch.device(device)
    if cfg.family == "pairformer":
        return _check_pair_family(family, cfg, device, seed)
    findings: List[Finding] = []
    for kind, be in _token_backends(cfg, device, seed):
        findings += check_token_backend(be, f"{family}/decode[{kind}]",
                                        seed=seed)[0]
    return findings


@contextlib.contextmanager
def legacy_adapter():
    """Every ``ops.flash_decode`` call of the models transposes its
    per-layer cache (or pool) to the canonical layout, ``(B, S, KVH, hd)``
    (``(n_pages, ps, KVH, hd)``), calls the op on it (``kv_layout="bshd"``)
    and transposes it back into the model's cache: the per-token Θ(pool)
    round trip of the reference's legacy layout adapters."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    orig = ops.flash_decode

    def adapted(q, k_cache, v_cache, *args, page_table=None, kv_layout="bshd",
                **kw):
        perm = (1, 2, 0, 3) if page_table is not None else (0, 2, 1, 3)
        back = (2, 0, 1, 3) if page_table is not None else (0, 2, 1, 3)
        canon = [c.permute(*perm).contiguous() for c in (k_cache, v_cache)]
        out = orig(q, *canon, *args, page_table=page_table,
                   kv_layout="bshd", **kw)
        for c, t in zip((k_cache, v_cache), canon):
            c.copy_(t.permute(*back))
        return out

    lm.ops.flash_decode = adapted
    try:
        yield
    finally:
        lm.ops.flash_decode = orig


def verify_tripwire(*, device="cpu", seed: int = 0, backends=None
                    ) -> List[Finding]:
    """The built-in negative control: under ``legacy_adapter`` the decode
    step of the dense family (or of ``backends``, ``[(program,
    backend)]``, unfilled) MUST trip ``no-pool-relayout``. Returns a
    finding where it does not: a tripwire that cannot fire would pass
    every future regression too."""
    if backends is None:
        cfg = FAMILIES["dense"]()
        backends = [(f"dense/decode[{kind}]", be) for kind, be in
                    _token_backends(cfg, torch.device(device), seed)]
    missed = []
    with legacy_adapter():
        for program, be in backends:
            found = check_token_backend(be, program, seed=seed)[0]
            if not any(f.rule == "no-pool-relayout" for f in found):
                missed.append(program)
    if not missed:
        return []
    return [Finding(
        rule="tripwire-self-test", program=",".join(missed),
        message=("a per-layer pool transpose in the decode op no longer "
                 "trips no-pool-relayout: the tripwire lost its teeth (did "
                 "the pool threshold or the op log change?)"))]


def run_contracts(families, *, device="cpu", seed: int = 0,
                  impl: str = "auto", self_test: bool = True
                  ) -> List[Finding]:
    """Check ``families``; with ``self_test`` also prove the tripwire
    still fires."""
    findings: List[Finding] = []
    for family in families:
        findings += check_family(family, device=device, seed=seed, impl=impl)
    if self_test:
        findings += verify_tripwire(device=device, seed=seed)
    return findings
