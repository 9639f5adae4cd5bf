"""The ``pairformer`` family (the port's pairformer_lite trunk with fitted
factor MLPs), as a new family brings it: the published widths' fields,
the count of matrix parameters, the inference entry, the factor MLPs'
layout and one fault."""
from __future__ import annotations

from portbench import faults

WIDTHS = {"n_layers": "n_layers", "d_model": "d_model",
          "n_heads": "n_heads", "d_pair": "d_pair", "d_ff": "d_ff",
          "bias_rank": "bias_rank"}


def matmul_params(spec: dict) -> int:
    """The single track's matrices (per residue): q k v, o and the MLP a
    block, the input projection and the output head."""
    d, f = spec["d_model"], spec["d_ff"]
    return 64 * d + spec["n_layers"] * (4 * d * d + 2 * d * f) + 3 * d


def factor_layout(cfg) -> list:
    """``(path, shape, init)`` of the layer-stacked factor MLPs."""
    from repro_torch.models.common import stack_layers
    from repro_torch.models.pairformer import factor_mlp_template
    tmpl = stack_layers(factor_mlp_template(cfg), cfg.n_layers)
    return [((k, leaf), tuple(tmpl[k][leaf].shape),
             tuple(tmpl[k][leaf].init))
            for k in sorted(tmpl) for leaf in sorted(tmpl[k])]


def forward(cfg):
    """``f({"trunk", "factors"}, feats) -> coordinates``."""
    from repro_torch.models import pairformer
    return lambda params, feats: pairformer.forward(
        params["trunk"], feats, cfg, params["factors"])


def _answer_altered():
    from repro_torch.models import pairformer

    def make(inner):
        def forward(params, feats, cfg, factors=None):
            out = inner(params, feats, cfg, factors).clone()
            out[:, 0] += out.abs().max()
            return out
        return forward
    return faults.patched(pairformer, "forward", make)


FAULTS = {"answer_altered": _answer_altered}
