"""The port's sharded train step on the CPU, in real multi-process runs:
``gloo`` ranks on a ``(2, 2, 2)`` ``(pod, data, model)`` mesh (8 ranks)
and on ``(2, 2)``, ``(1, 2)`` and ``(2, 1)`` ``(data, model)`` meshes
(``tests/torch_train_worker.py``; the four worlds start together, each
rank with one thread and a 120 s limit).

Every rank takes the same SMOKE parameters (the port's ``init_params``
from a seed, carried to the reference as arrays), keeps its shards
(``TrainLayout``: FSDP over ``data``, tensor parallelism over ``model``,
the batch over ``pod`` x ``data``) and trains them on the same global
``LMBatches`` (8 x 16 tokens; AdamW at lr 1e-3, eps 1). The tests hold
the sharded step, its gradients gathered to global arrays, to:

- the port's unsharded step on the same global batch: the loss and
  ``grad_norm`` of both steps within 1e-5 relative, every gradient of
  step 0 within ``1e-5 * max|g| + 1e-7`` and every parameter after 2 steps
  within ``1e-5 * max|p|`` (the sums over ranks reorder float32
  additions, so the match is not bit-equal);
- the reference's unsharded ``make_train_step`` on one CPU device (its
  compiled step, ``donate=False``, with an optimizer that returns the
  gradients it is given; ``jit=False`` runs the same function op by op at
  ~3x the time): the loss within 1e-5 relative and each gradient within
  ``1e-4 * max|g| + 1e-6`` (``tests/test_torch_train.py``'s bounds against
  ``jax.value_and_grad``);
- a negative control: *g* (``reduce_from``) with the summing backward of
  the functional collectives' own autograd misses the gradients by far
  more than the bound on a ``model``-split mesh;
- ``check_train_step`` on ``(2, 2)``: all-gathers and reduce-scatters of
  the FSDP weights, all-reduces, and the gather count of
  ``fsdp_gathers_per_step``;
- a checkpoint saved on ``(2, 2)`` restored onto ``(1, 2)`` and onto no
  mesh (and by the reference): the next step's loss within 1e-5 of the
  uninterrupted run's;
- ``python -m repro_torch.launch.train --mesh 2x2 --device cpu --smoke``
  under torchrun's environment with a file rendezvous trains and resumes.

Cases: GPT-2 ALiBi (``grad_accum`` 2, remat ``"dots"``: each rank's slopes
are those of its heads) and StableLM (GQA) on the three 2D meshes, GPT-2
again in bf16 on ``(2, 2)`` (against the port's unsharded bf16 step, at
bounds set from readings: ``TOLS``), all
through kernel 1's wrapper (``attn_impl="cuda"``, its plain version on a
CPU tensor) on the local heads and rows; the
dense (CodeQwen), MoE (Granite: 5 experts do not split over 2 ranks, so
``expert`` replicates and the heads split), SSM (Mamba2: the branch whole
on every ``model`` rank) and hybrid (Hymba) families on ``(2, 2, 2)``, the
counterpart of the reference's ``test_mini_multipod_lowering``. Three
cases have microbatches whose rows do not split evenly over the 2
``batch`` ranks (``grad_accum`` 2): GPT-2 with 1 row (global batch 2, on
``(2, 1)``: one rank runs a padding row at weight 0) and with 3 rows
(global batch 6, on ``(2, 2)``: 2 + 1), and Granite with 3 rows on ``(2,
1)``, whose loss adds the MoE load-balance term (a mean over rows of each
row's value, so the rows' shares weigh it exactly as they weigh the
cross-entropy), held to the same bounds.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_worker as W
from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.train import make_train_step as jmake_train_step
from repro_torch import checkpoint as tckpt
from repro_torch.dist import Rules, grad_sum_axes
from repro_torch.dist import collectives as C
from repro_torch.models import get_model, init_params
from repro_torch.models.common import TrainLayout, train_template
from repro_torch.train import make_train_step

WORKER = Path(__file__).resolve().with_name("torch_train_worker.py")
WORLDS = {
    "2x2x2": ("train:codeqwen", "train:granite", "train:mamba2",
              "train:hymba"),
    "2x2": ("train:gpt2", "train:stablelm", "train:gpt2bf16",
            "train:rows3", "statcheck:gpt2",
            "statcheck:stablelm", "control:gpt2", "save:gpt2"),
    "1x2": ("train:gpt2", "train:stablelm", "restore:gpt2"),
    "2x1": ("train:gpt2", "train:stablelm", "train:rows1",
            "train:moerows3"),
}
TRAINED = [(m, job.split(":")[1]) for m, jobs in WORLDS.items()
           for job in jobs if job.startswith("train:")]
# the reference is held against each float32 case once, on its largest
# mesh (the bf16 case against the port's unsharded step only)
REFERENCE = {case: mesh for mesh, case in reversed(TRAINED)
             if case != "gpt2bf16"}
LOSS_RTOL = 1e-5
GRAD_TOL, PARAM_TOL = 1e-5, 1e-5          # of each leaf's max |value|
REF_GRAD_TOL = 1e-4
# case -> (loss rtol, grad_norm rtol, grad tol, param tol) against the
# port's unsharded step; the rest at the float32 bounds above. bf16: each
# rank rounds its partial sums (the heads' and FFN columns' products
# before *g*, its rows' weight gradients before the float32
# reduce-scatter) where the unsharded step rounds the whole sum once.
# Readings on (2, 2): loss 7.0e-6, grad_norm 8.2e-5, gradients 9.2e-3
# (ln1), parameters after 2 steps 9.6e-3 (ln1, zero at init); bounds
# about 3x those.
TOLS = {"gpt2bf16": (3e-5, 3e-4, 3e-2, 3e-2)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_model(case: str):
    arch, kw = W.CASES[case]
    jcfg = jsmoke(arch).replace(**dict(kw, attn_impl="xla"))
    return jcfg, jget_model(jcfg)


def _jax_params(root: Path, case: str) -> dict:
    """The parameters every rank loads, as the reference's tree."""
    tree: dict = {}
    flat = np.load(root / f"{W.CASES[case][0]}.npz")
    for key in flat.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(flat[key])
    return tree


class _Returning:
    """The reference's AdamW, returning the gradients it is given among
    its metrics (so the compiled step hands them out)."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        params, state, metrics = self.opt.update(grads, state, params)
        return params, state, dict(metrics, grads=grads)


def _reference_step0(root: Path, case: str) -> dict:
    """Step 0 of the reference's unsharded step: its loss and gradients."""
    jcfg, jmodel = _jax_model(case)
    jparams = _jax_params(root, case)
    opt = _Returning(joptim.AdamW(lr_fn=joptim.constant(W.LR), eps=1.0))
    step = jmake_train_step(jmodel.loss, opt, grad_accum=jcfg.grad_accum,
                            donate=False)
    batch = {k: jnp.asarray(v.numpy())
             for k, v in W.case_batch(case, 0).items()}
    _, _, metrics = step(jparams, opt.init(jparams), batch)
    return {"loss": float(metrics["loss"]),
            "grads": _flat(jax.tree.map(np.asarray, metrics["grads"]))}


def _unsharded(root: Path, case: str, steps: int = W.STEPS) -> dict:
    """The port's unsharded step on the same parameters and batches:
    losses, norms, step 0's gradients and the parameters after ``steps``."""
    cfg = W.case_config(case)
    params = W.load_params(str(root), case)
    opt = W.optimizer()
    step = make_train_step(get_model(cfg).loss, opt,
                           grad_accum=cfg.grad_accum)
    state = opt.init(params)
    losses, norms = [], []
    for i in range(steps):
        params, state, m = step(params, state, W.case_batch(case, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "grads": {k: v.numpy() for k, v in opt.grads[0].items()},
            "params": {k: v.detach().numpy()
                       for k, v in W._flat(params).items()}}


class Runs(NamedTuple):
    dir: Path           # the worlds' outputs, parameters and checkpoint
    ref: dict           # case -> the reference's step 0
    unsharded: dict     # case -> the port's unsharded run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four worlds' results, with the reference's step 0 and the
    port's unsharded run of each case, computed while the worlds run."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    for case in W.CASES:
        arch = W.CASES[case][0]
        if not (tmp / f"{arch}.npz").exists():
            gen = torch.Generator().manual_seed(0)
            params = init_params(W.case_config(case), gen, device="cpu")
            np.savez(tmp / f"{arch}.npz", **{
                k: v.numpy() for k, v in W._flat(params).items()})
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(WORKER.parents[1] / "src"))
    procs = {}
    for mesh, jobs in WORLDS.items():
        n = int(np.prod([int(v) for v in mesh.split("x")]))
        out = tmp / f"out_{mesh}"
        out.mkdir()
        procs[mesh] = [subprocess.Popen(
            [sys.executable, str(WORKER), "--init",
             f"file://{tmp}/store_{mesh}", "--rank", str(r), "--world",
             str(n), "--mesh", mesh, "--params", str(tmp), "--out",
             str(out), "--jobs", ",".join(jobs), "--ckpt",
             str(tmp / "ckpt")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n)]
    failed = []
    try:
        ref = {case: _reference_step0(tmp, case) for case in REFERENCE}
        unsharded = {case: _unsharded(tmp, case) for case in W.CASES}
    finally:                     # every rank waited for, or stopped
        for mesh, ps in procs.items():
            for r, p in enumerate(ps):
                try:
                    log, _ = p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    log, _ = p.communicate()
                if p.returncode:
                    failed.append(f"{mesh} rank {r} exit {p.returncode}:\n"
                                  f"{log[-3000:]}")
    assert not failed, "\n".join(failed)
    return Runs(tmp, ref, unsharded)


def _rank0(runs, mesh: str) -> dict:
    return json.loads((runs.dir / f"out_{mesh}" / "rank0.json")
                      .read_text())


def _sharded(runs, mesh: str, job: str) -> dict:
    return dict(np.load(runs.dir / f"out_{mesh}" / f"{job}.npz"))


def _grad_gaps(got: dict, want: dict) -> dict:
    """{leaf: max |got - want| / max |want|} of step 0's gradients."""
    return {k: float(np.abs(got[f"grad:{k}"] - w).max()
                     / (np.abs(w).max() + 1e-30)) for k, w in want.items()}


def _assert_grads(got: dict, want: dict, tol: float, atol: float, where):
    assert {k[5:] for k in got if k.startswith("grad:")} == set(want)
    for k, w in want.items():
        err = float(np.abs(got[f"grad:{k}"] - w).max())
        assert err <= tol * float(np.abs(w).max()) + atol, (where, k, err)


@pytest.mark.parametrize("mesh,case", TRAINED,
                         ids=[f"{m}-{c}" for m, c in TRAINED])
def test_sharded_step_matches_unsharded(runs, mesh, case):
    got = _sharded(runs, mesh, f"train-{case}")
    want = runs.unsharded[case]
    where = f"{mesh} {case}"
    loss_tol, norm_tol, grad_tol, param_tol = TOLS.get(
        case, (LOSS_RTOL, LOSS_RTOL, GRAD_TOL, PARAM_TOL))
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=loss_tol, err_msg=where)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=norm_tol,
                               err_msg=where)
    _assert_grads(got, want["grads"], grad_tol, 1e-7, where)
    for k, w in want["params"].items():
        err = float(np.abs(got[f"param:{k}"] - w).max())
        assert err <= param_tol * float(np.abs(w).max()), (where, k, err)


@pytest.mark.parametrize("case", sorted(REFERENCE))
def test_sharded_step_matches_reference(runs, case):
    """Step 0 of the sharded run against the reference's unsharded step:
    the loss and every gradient."""
    want = runs.ref[case]
    got = _sharded(runs, REFERENCE[case], f"train-{case}")
    where = f"{REFERENCE[case]} {case}"
    np.testing.assert_allclose(got["losses"][0], want["loss"],
                               rtol=LOSS_RTOL, err_msg=where)
    _assert_grads(got, want["grads"], REF_GRAD_TOL, 1e-6, where)


def test_summing_g_backward_fails_the_gradient_check(runs):
    """*g* with the functional collectives' own backward (an all-reduce
    of the cotangent) multiplies every gradient upstream of a
    tensor-parallel sum by the ``model`` size: the check must fail."""
    got = _sharded(runs, "2x2", "control-gpt2")
    want = runs.unsharded["gpt2"]
    gaps = _grad_gaps(got, want["grads"])
    assert max(gaps.values()) > 100 * GRAD_TOL, gaps
    with pytest.raises(AssertionError):
        _assert_grads(got, want["grads"], GRAD_TOL, 1e-7, "control")
    # the loss is the forward's, which the control leaves as it is
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("case,want", [
    # gpt2: 6 FSDP layer leaves x 2 layers x 2 microbatches x 2 (remat
    # "dots" gathers again in the backward) + the embedding x 2, plus 2
    # logits gathers over vocab
    ("gpt2", {"all_gather_into_tensor": 52, "reduce_scatter_tensor": 26}),
    # stablelm: 6 x 2 layers x 1 microbatch, no remat, + the embedding,
    # plus 1 logits gather
    ("stablelm", {"all_gather_into_tensor": 14,
                  "reduce_scatter_tensor": 13}),
])
def test_train_step_collectives(runs, case, want):
    res = _rank0(runs, "2x2")[f"statcheck:{case}"]
    assert res["findings"] == [], res
    counts = res["counts"]
    assert {k: counts[k] for k in want} == want, counts
    assert counts["all_reduce"] > 0, counts


def test_checkpoint_restores_elastically(runs):
    """Saved on (2, 2) after step 1; restored onto (1, 2) and onto no mesh,
    step 2's loss is the uninterrupted run's; the reference restores the
    same files to the port's unsharded values."""
    saved = _rank0(runs, "2x2")["save:gpt2"]["losses"]
    restored = _rank0(runs, "1x2")["restore:gpt2"]
    assert restored["final_step"] == 3
    np.testing.assert_allclose(restored["losses"], saved[2:],
                               rtol=LOSS_RTOL)
    cfg = W.case_config("gpt2")
    params = W.load_params(str(runs.dir), "gpt2")
    opt = W.optimizer()
    step = make_train_step(get_model(cfg).loss, opt,
                           grad_accum=cfg.grad_accum)
    ckpt = str(runs.dir / "ckpt")
    (params, state), extras = tckpt.restore_checkpoint(
        ckpt, None, (params, opt.init(params)))
    assert extras == {"step": 1} and int(state.step) == 2
    _, _, m = step(params, state, W.batch(cfg, 2))
    np.testing.assert_allclose(float(m["loss"]), saved[2], rtol=LOSS_RTOL)
    jparams = _jax_params(runs.dir, "gpt2")
    jopt = joptim.AdamW(lr_fn=joptim.constant(W.LR), eps=1.0)
    (jp, js), _ = jckpt.restore_checkpoint(ckpt, None,
                                           (jparams, jopt.init(jparams)))
    (tp, ts), _ = tckpt.restore_checkpoint(
        ckpt, None, (W.load_params(str(runs.dir), "gpt2"),
                     opt.init(W.load_params(str(runs.dir), "gpt2"))))
    for name, a in _flat(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_array_equal(a, W._flat(tp)[name].numpy())
    np.testing.assert_array_equal(np.asarray(js.step), ts.step.numpy())


def test_launcher_trains_and_resumes_on_a_2x2_mesh(tmp_path):
    """``launch.train --mesh 2x2 --device cpu --smoke`` in a world of 4
    (torchrun's environment, a file rendezvous): 2 steps with a
    checkpoint, then a rerun to 3 resumes at step 2; rank 0 alone prints
    and logs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="4",
               PYTHONPATH=str(WORKER.parents[1] / "src"))
    log = tmp_path / "t.jsonl"

    def launch(steps: int, store: str):
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "gpt2_alibi_15b", "--smoke", "--device", "cpu", "--mesh",
                "2x2", "--init-method", f"file://{tmp_path}/{store}",
                "--steps", str(steps), "--batch", "4", "--seq", "16",
                "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
                "--log", str(log)]
        procs = [subprocess.Popen(args, env=dict(env, RANK=str(r),
                                                 LOCAL_RANK=str(r)),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(4)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
        assert [p.returncode for p in procs] == [0] * 4, outs[0][1][-2000:]
        assert all(not out for out, _ in outs[1:])
        return outs[0][0]

    first = launch(2, "store1")
    assert "cpu mesh 2x2 (data, model)" in first and \
        "'final_step': 2" in first, first
    again = launch(3, "store2")
    assert "'final_step': 3" in again, again
    steps = [json.loads(line)["step"] for line in log.read_text().splitlines()]
    assert steps == [0, 1, 2]
    assert tckpt.latest_step(str(tmp_path / "ck")) == 2


def test_launcher_mesh_needs_its_world(monkeypatch, capsys):
    from repro_torch.launch import train as launch_train
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for spec, msg in (("2x2", "needs a world of 4 ranks"),
                      ("2x2x2", "needs a world of 8 ranks"),
                      ("2", "expected DxM or PxDxM")):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", "gpt2_alibi_15b", "--smoke",
                               "--device", "cpu", "--mesh", spec])
        assert msg in capsys.readouterr().err, spec


class _Mesh:
    """A duck-typed mesh (axis names and sizes only)."""

    def __init__(self, **sizes):
        self.axis_names, self.shape = tuple(sizes), dict(sizes)


@pytest.mark.parametrize("shape,axes,want", [
    ((8, 4), ("fsdp", "heads"), ("pod",)),          # reduce-scattered on data
    ((8,), (None,), ("pod", "data")),               # replicated
    ((7, 4), ("fsdp", "heads"), ("pod", "data")),   # fsdp dim degraded
    ((4, 8), ("vocab", "fsdp"), ("pod",)),
    ((4,), ("heads",), ("pod", "data")),
])
def test_grad_sum_axes_on_a_multipod_mesh(shape, axes, want):
    mesh = _Mesh(pod=2, data=2, model=2)
    assert grad_sum_axes(shape, axes, mesh, Rules()) == want
    assert grad_sum_axes(shape, axes, _Mesh(data=2, model=2),
                         Rules()) == tuple(a for a in want if a != "pod")


def test_train_template_keeps_the_ssm_branch_whole():
    tmpl = train_template(get_model(W.case_config("hymba")).template())
    layers = tmpl["layers"]
    assert layers["ssm"]["in_x"].axes == ("layers", "fsdp", None, None)
    assert layers["ssm"]["out"].axes == ("layers", None, None, "fsdp")
    assert layers["ssm"]["a_log"].axes == ("layers", None)
    assert layers["attn"]["wq"].axes == ("layers", "fsdp", "heads", None)


def test_training_collectives_are_the_identity_outside_a_mesh():
    x = torch.randn(3, 4, requires_grad=True)
    for y in (C.reduce_from(x, "heads"), C.copy_to(x, "mlp"),
              C.gather_from(x, -1, "vocab"), C.fsdp_gather(x, 1),
              C.reduce_mesh_axes(x, ("data",))):
        assert y is x


def test_layout_refuses_fsdp_outside_batch():
    """An FSDP reduce-scatter over ranks that hold the same rows would sum
    one gradient twice."""
    tmpl = get_model(W.case_config("gpt2")).template()
    with pytest.raises(ValueError, match="outside the batch"):
        TrainLayout(tmpl, _Mesh(data=2, model=2),
                    Rules.make({"fsdp": "model"}))
