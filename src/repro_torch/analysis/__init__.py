"""Cost model of the port: the H100 roofline of a dry-run cell
(``roofline``) and the tables of a directory of dry-run reports
(``report``)."""
from repro_torch.analysis.roofline import (
    DTYPE_BYTES,
    active_params,
    attention_kernel_flops,
    attention_kv_reread_bytes,
    collective_bytes,
    model_flops,
    roofline_report,
)

__all__ = ["DTYPE_BYTES", "active_params", "attention_kernel_flops",
           "attention_kv_reread_bytes", "collective_bytes", "model_flops",
           "roofline_report"]
