"""LM training against the JAX reference, on the CPU, float32, at SMOKE
size; the reference's parameters carried across with
``params_from_numpy``, inputs from numpy with a seed.

- The loss and every parameter's gradient against
  ``jax.value_and_grad(repro.models.lm.loss_fn)`` for the dense
  (``gpt2_alibi_15b``), MoE (``granite_moe_3b_a800m``), SSM
  (``mamba2_130m``), hybrid (``hymba_15b``, local attention) and frontend
  (``musicgen_medium``) SMOKE configs: the loss at rtol 1e-5, each leaf's
  gradient within ``1e-4 * max|g_ref| + 1e-6`` (float32 sums in other
  orders through 2 layers).
- Remat ``"none"``, ``"dots"`` and ``"full"`` give bit-equal losses and
  gradients; kernel 1 (a counting stand-in for its wrapper, which on a CPU
  tensor runs its plain version) runs once per layer without remat and
  twice with it (the backward recomputes the layer), kernel 5 likewise in
  the hybrid, and the kernel path's SSD Function (``ops._SSDScan``: kernel
  5's wrapper forward, the plain scan's backward) gives the plain scan's
  gradients.
- The plain SSD scan's gradients stay finite at a chunk whose decay
  overflows above the diagonal, where the reference's are NaN; its forward
  is the reference's.
- AdamW (with and without ``compress_grads``) against the reference's at
  rtol 1e-5 (float32 roundings in another order over 4 steps; one element
  of ten read 2e-6), the three schedules at rtol 1e-6; ``make_train_step``
  with ``grad_accum=2`` against the reference's (loss at 1e-5, the updated
  parameters within 1e-5 of each leaf's scale).
- ``LMBatches``, ``PDEBatches`` and ``PatchBatches`` bit-equal to the
  reference's.
- ``TrainLoop``: a restart resumes bit-exactly, SIGTERM saves and stops,
  the straggler watchdog (the cases of ``tests/test_substrates.py``), one
  JSON line per step.
- Checkpoints cross between the packages both ways (float32, bf16 and the
  int32 step; the optimizer state's leaf names are the reference's).
- ``python -m repro_torch.launch.train --smoke --device cpu`` runs and
  resumes from its checkpoint.
"""
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import data as jdata
from repro import optim as joptim
from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro.train import make_train_step as jmake_train_step
from repro_torch import checkpoint as tckpt
from repro_torch import data as tdata
from repro_torch import optim as toptim
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flashbias_attn, ops, ssd_scan
from repro_torch.models import get_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train import TrainLoop, make_train_step

ARCHS = ["gpt2_alibi_15b", "granite_moe_3b_a800m", "mamba2_130m",
         "hymba_15b", "musicgen_medium"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(arch: str, **replace):
    jcfg = jsmoke(arch).replace(attn_impl="xla")
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, seed: int, b: int = 2, s: int = 16) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend_len:
        out["frontend"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def _named(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _loss_and_grads(cfg, params, batch):
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    loss = get_model(cfg).loss(leaves, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, jparams, cfg, params = _carried(arch)
    batch = _batch(cfg, 3)
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads = _loss_and_grads(cfg, params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _named(jax.tree.map(np.asarray, jgrads))
    got = _named(grads)
    assert set(got) == set(want)
    for name, g in want.items():
        err = float(np.abs(got[name].numpy() - g).max())
        assert err <= 1e-4 * float(np.abs(g).max()) + 1e-6, (name, err)


def _counting(monkeypatch, module, name):
    """A counting stand-in for a kernel wrapper in its module and in
    ``ops`` (on a CPU tensor the wrapper runs its plain version)."""
    orig = getattr(module, name)
    calls = []

    def fn(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    monkeypatch.setattr(module, name, fn)
    monkeypatch.setattr(ops, name, fn)
    return calls


@pytest.mark.parametrize("arch", ["gpt2_alibi_15b", "hymba_15b"])
def test_remat_modes_are_equal_and_rerun_kernel_1(arch, monkeypatch):
    attn = _counting(monkeypatch, flashbias_attn, "flashbias_attention_fwd")
    scan = _counting(monkeypatch, ssd_scan, "ssd_scan_fwd")
    plain_scan = ops.ssd_scan

    def kernel_scan(x, dt, a, b, c, *, chunk=256, h0=None, impl="auto"):
        # ops.ssd_scan refuses impl="cuda" off the card; its Function (the
        # counted wrapper's forward) runs here as it does there
        if impl != "cuda":
            return plain_scan(x, dt, a, b, c, chunk=chunk, h0=h0, impl=impl)
        return ops._SSDScan.apply(x, dt, a, b, c, h0, chunk)
    monkeypatch.setattr(ops, "ssd_scan", kernel_scan)
    _, _, cfg, params = _carried(arch, attn_impl="cuda")
    batch = _batch(cfg, 4)
    out = {}
    for remat in ("none", "dots", "full"):
        attn.clear()
        scan.clear()
        out[remat] = _loss_and_grads(cfg.replace(remat=remat), params, batch)
        per_layer = 1 if remat == "none" else 2
        assert len(attn) == per_layer * cfg.n_layers, remat
        assert len(scan) == (per_layer * cfg.n_layers
                             if cfg.family == "hybrid" else 0), remat
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(tree_leaves(out[remat][1]),
                        tree_leaves(out["none"][1])):
            assert torch.equal(a, b)


def test_ssd_function_gives_the_plain_scans_gradients():
    from repro_torch.models import ssd
    rng = np.random.default_rng(6)
    b, s, h, p, n = 2, 40, 3, 4, 8

    def leaves():
        x = rng.standard_normal((b, s, h, p)).astype(np.float32)
        dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
        a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
        bm = rng.standard_normal((b, s, n)).astype(np.float32)
        cm = rng.standard_normal((b, s, n)).astype(np.float32)
        h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
        return [torch.from_numpy(t) for t in (x, dt, a, bm, cm, h0)]

    inputs = leaves()
    gy = torch.from_numpy(rng.standard_normal((b, s, h, p))
                          .astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((b, h, p, n))
                          .astype(np.float32))
    grads = {}
    for name in ("function", "plain"):
        ts = [t.clone().requires_grad_(True) for t in inputs]
        if name == "function":
            y, hf = ops._SSDScan.apply(*ts, 16)
        else:
            y, hf = ssd.ssd_scan(*ts[:5], chunk=16, h0=ts[5])
        torch.autograd.backward((y, hf), (gy, gh))
        grads[name] = [t.grad for t in ts]
    for got, want in zip(grads["function"], grads["plain"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_ssd_scan_gradients_stay_finite_where_the_decay_overflows():
    """At a model's chunk (256) the decay exp(cum_i - cum_j) above the
    diagonal overflows float32 once sum(dt * |a|) over the chunk passes ~88
    (Mamba2-130M's init reaches it). The reference's where(tri, exp(seg),
    0) then differentiates to 0 * inf = NaN; the port masks seg before the
    exp: the reference's forward (float32 sums in another order, 1e-4), and
    the gradients of the scan at a chunk small enough not to overflow."""
    import jax.numpy as jnp2
    from repro.models import ssd as jssd
    from repro_torch.models import ssd
    rng = np.random.default_rng(9)
    b, s, h, p, n = 1, 256, 2, 4, 8
    arrs = [rng.standard_normal((b, s, h, p)).astype(np.float32),
            np.full((b, s, h), 0.6, np.float32),
            np.array([-1.0, -0.5], np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32)]
    jy, jh = jssd.ssd_scan(*map(jnp2.asarray, arrs), chunk=256)
    jgrad = jax.grad(lambda dt: jssd.ssd_scan(
        jnp2.asarray(arrs[0]), dt, *map(jnp2.asarray, arrs[2:]),
        chunk=256)[0].sum())(jnp2.asarray(arrs[1]))
    assert np.isnan(np.asarray(jgrad)).any()     # the reference's, via dt
    grads = {}
    for chunk in (256, 16):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
        y, hf = ssd.ssd_scan(*ts, chunk=chunk)
        if chunk == 256:
            np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(hf.detach().numpy(), np.asarray(jh),
                                       rtol=1e-4, atol=1e-4)
        (y.sum() + hf.sum()).backward()
        grads[chunk] = [t.grad for t in ts]
    for got, want in zip(grads[256], grads[16]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _opt_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": {"scale": rng.standard_normal((2, 5))
                       .astype(np.float32),
                       "bias": rng.standard_normal((6,)).astype(np.float32)}}


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compress_grads"])
def test_adamw_matches_reference(compress):
    params = _opt_tree(1)
    jopt = joptim.AdamW(lr_fn=joptim.cosine(1e-2, 1, 6),
                        compress_grads=compress)
    topt = toptim.AdamW(lr_fn=toptim.cosine(1e-2, 1, 6),
                        compress_grads=compress)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, params))
    ts = topt.init(tp)
    for step in range(4):
        grads = _opt_tree(10 + step)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = topt.update(tree_map(torch.from_numpy, grads), ts, tp)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 4
    pairs = [(tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)]
    if compress:
        pairs.append((ts.err, js.err))
    else:
        assert ts.err is None and js.err is None
    for got, want in pairs:
        for name, w in _named(jax.tree.map(np.asarray, want)).items():
            np.testing.assert_allclose(_named(got)[name].numpy(), w,
                                       rtol=1e-5, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_reference(name):
    args = {"constant": (3e-4,), "cosine": (3e-4, 10, 100),
            "wsd": (3e-4, 10, 70, 20)}[name]
    jf, tf = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    for step in (0, 1, 5, 10, 11, 50, 79, 80, 95, 99, 100, 150):
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jf(jnp.int32(step))),
                                   rtol=1e-6)


def test_train_step_with_grad_accum_matches_reference():
    jcfg, jparams, cfg, params = _carried("gpt2_alibi_15b")
    batch = _batch(cfg, 8, b=4)
    # eps 1: the update is then smooth in the gradient (with eps 1e-8 an
    # element whose gradient is ~1e-9 moves by up to lr on a rounding), so
    # the parameters show the accumulated gradients' agreement
    jopt = joptim.AdamW(lr_fn=joptim.constant(1e-3), eps=1.0)
    topt = toptim.AdamW(lr_fn=toptim.constant(1e-3), eps=1.0)
    jstep = jmake_train_step(jget_model(jcfg).loss, jopt, grad_accum=2)
    tstep = make_train_step(get_model(cfg).loss, topt, grad_accum=2)
    jp, js, jm = jstep(jparams, jopt.init(jparams),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tp, ts, tm = tstep(params, topt.init(params),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for name, w in _named(jax.tree.map(np.asarray, jp)).items():
        got = _named(tp)[name].detach().numpy()
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max() + 1e-7, name


def test_batches_are_bit_equal_to_the_reference():
    pairs = [
        (dict(vocab=1000, seq_len=24, global_batch=4, seed=7,
              frontend_len=5, d_model=8), "LMBatches"),
        (dict(vocab=50, seq_len=8, global_batch=8, seed=1, shard=(1, 2)),
         "LMBatches"),
        (dict(n_points=64, global_batch=2, seed=3), "PDEBatches"),
        (dict(n_windows=4, window=9, global_batch=3, seed=2), "PatchBatches"),
    ]
    for kw, cls in pairs:
        j, t = getattr(jdata, cls)(**kw), getattr(tdata, cls)(**kw)
        for step in (0, 5):
            a, b = j.batch(step), t.batch(step)
            assert set(a) == set(b)
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def _toy_loop(tmp_path, **kw):
    """A small LM trained through TrainLoop: (fresh, step_fn, data_fn)."""
    cfg = smoke_config("gpt2_alibi_15b")
    opt = toptim.AdamW(lr_fn=toptim.cosine(1e-3, 1, 8))
    data = tdata.LMBatches(vocab=cfg.vocab, seq_len=8, global_batch=2,
                           seed=1)

    def fresh():
        from repro_torch.models import init_params
        p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        return p, opt.init(p)

    step_fn = make_train_step(get_model(cfg).loss, opt)
    return fresh, step_fn, lambda s: {k: torch.from_numpy(v)
                                      for k, v in data.batch(s).items()}


def _losses(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_restart_resumes_bit_exactly(tmp_path):
    fresh, step_fn, data_fn = _toy_loop(tmp_path)
    whole = TrainLoop(step_fn, data_fn, log_path=str(tmp_path / "a.jsonl"))
    p1, _, info = whole.run(*fresh(), 8)
    assert info["final_step"] == 8 and not info["preempted"]
    ck = str(tmp_path / "ck")
    TrainLoop(step_fn, data_fn, ckpt_dir=ck, ckpt_every=100,
              log_path=str(tmp_path / "b.jsonl")).run(*fresh(), 5)
    assert tckpt.latest_step(ck) == 4            # saved at the end
    p2, o2, info = TrainLoop(step_fn, data_fn, ckpt_dir=ck, ckpt_every=100,
                             log_path=str(tmp_path / "b.jsonl")).run(
        *fresh(), 8)
    assert info["final_step"] == 8 and int(o2.step) == 8
    a, b = _losses(tmp_path / "a.jsonl"), _losses(tmp_path / "b.jsonl")
    assert [r["step"] for r in b] == list(range(8))
    assert [r["loss"] for r in a] == [r["loss"] for r in b]
    assert set(a[0]) == {"loss", "grad_norm", "lr", "step", "wall_s",
                         "stragglers"}
    for x, y in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(x, y)


def test_sigterm_saves_and_stops(tmp_path):
    fresh, step_fn, data_fn = _toy_loop(tmp_path)

    def step(p, o, b):
        if int(o.step) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(p, o, b)

    ck = str(tmp_path / "ck")
    _, _, info = TrainLoop(step, data_fn, ckpt_dir=ck,
                           ckpt_every=100).run(*fresh(), 10)
    assert info["preempted"] and info["final_step"] == 2
    assert tckpt.latest_step(ck) == 2
    _, o, info = TrainLoop(step_fn, data_fn, ckpt_dir=ck).run(*fresh(), 4)
    assert info["final_step"] == 4 and int(o.step) == 4


def test_straggler_watchdog_counts():
    calls = {"n": 0}

    def slow_step(p, o, b):
        if calls["n"] == 7:
            time.sleep(0.25)
        calls["n"] += 1
        return p, o, {"loss": torch.zeros(())}

    flagged = []
    loop = TrainLoop(slow_step, lambda s: {}, straggler_factor=3.0,
                     on_straggler=lambda s, r: flagged.append(s))
    _, _, info = loop.run({"w": torch.zeros(())}, None, 10)
    assert flagged == [7] and info["stragglers"] == 1


def test_straggler_watchdog_adapts_to_regime_change():
    calls = {"n": 0}

    def step_fn(p, o, b):
        time.sleep(0.02 if calls["n"] < 5 else 0.1)
        calls["n"] += 1
        return p, o, {"loss": torch.zeros(())}

    flagged = []
    loop = TrainLoop(step_fn, lambda s: {}, straggler_factor=3.0,
                     on_straggler=lambda s, r: flagged.append(s))
    loop.run({"w": torch.zeros(())}, None, 20)
    assert 5 in flagged                       # the jump itself is seen
    assert not any(s >= 15 for s in flagged)  # but the baseline adapts


def _ckpt_trees(seed: int):
    """The same (params, opt_state) for both packages: float32 and bf16
    leaves, the int32 step, float32 moments."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((5,)).astype(np.float32)
    mu = rng.standard_normal((3, 4)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "half": jnp.asarray(h).astype(jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w),
          "half": torch.from_numpy(h).to(torch.bfloat16)}
    jo = joptim.OptState(step=jnp.int32(7),
                         mu={"w": jnp.asarray(mu),
                             "half": jnp.zeros((5,), jnp.float32)},
                         nu={"w": jnp.asarray(mu) ** 2,
                             "half": jnp.ones((5,), jnp.float32)})
    to = toptim.OptState(step=torch.tensor(7, dtype=torch.int32),
                         mu={"w": torch.from_numpy(mu),
                             "half": torch.zeros(5)},
                         nu={"w": torch.from_numpy(mu) ** 2,
                             "half": torch.ones(5)})
    return (jp, jo), (tp, to)


def _as_numpy(tree):
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return tree.float().numpy()
        return tree.numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32)
                      if getattr(tree, "dtype", None) == jnp.bfloat16
                      else tree)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoints_cross_between_packages(tmp_path, direction):
    jtree, ttree = _ckpt_trees(2)
    d = str(tmp_path)
    if direction == "port_to_reference":
        tckpt.save_checkpoint(d, 3, ttree, extras={"step": 3})
        got, extras = jckpt.restore_checkpoint(d, None, jtree)
        want = jtree
        assert got[0]["half"].dtype == jnp.bfloat16
    else:
        jckpt.save_checkpoint(d, 3, jtree, extras={"step": 3})
        got, extras = tckpt.restore_checkpoint(d, None, ttree)
        want = ttree
        assert got[0]["half"].dtype == torch.bfloat16
        assert got[1].step.dtype == torch.int32
        assert isinstance(got[1], toptim.OptState) and got[1].err is None
    assert extras == {"step": 3}
    with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    assert names == ["0/half", "0/w", "1/0", "1/1/half", "1/1/w",
                     "1/2/half", "1/2/w"]
    got_l = jax.tree.leaves(jax.tree.map(_as_numpy, got[0])) + [
        _as_numpy(got[1].step)]
    want_l = jax.tree.leaves(jax.tree.map(_as_numpy, want[0])) + [
        _as_numpy(want[1].step)]
    for a, b in zip(got_l, want_l):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_as_numpy(got[1].mu["w"]),
                                  _as_numpy(want[1].mu["w"]))


def test_checkpoint_keep_n_and_structure(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in range(6):
        tckpt.save_checkpoint(str(tmp_path), s, tree, keep_n=2)
    assert sorted(tckpt.all_steps(str(tmp_path))) == [4, 5]
    assert not any(".tmp-" in d for d in os.listdir(tmp_path))
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), None, {"y": torch.zeros(2)})


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path):
    from repro_torch.launch import train
    ck, log = str(tmp_path / "ck"), str(tmp_path / "log.jsonl")
    args = ["--arch", "gpt2_alibi_15b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--grad-accum", "2",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--log", log]
    info = train.main(args + ["--steps", "3"])
    assert info["final_step"] == 3 and tckpt.latest_step(ck) == 2
    info = train.main(args + ["--steps", "5"])
    assert info["final_step"] == 5 and tckpt.latest_step(ck) == 4
    steps = [r["step"] for r in _losses(log)]
    assert steps == [0, 1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in _losses(log))
