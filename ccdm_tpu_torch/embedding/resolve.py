"""One place that maps the CLI's embedding flags to fn_y2h.

Counterpart of the analytic branch of ccdm_tpu/embedding/resolve.py:85-91.
The trained ILI embedding (`resnet`) and the y2cov covariance path come in
later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable

from ccdm_tpu_torch.embedding.analytic import make_fn_y2h


def build_label_embedding(args) -> Callable:
    """fn_y2h from --y2h_embed_type / --dim_embed / --label_dim."""
    if getattr(args, "use_Hy", False):
        raise NotImplementedError("--use_Hy (the y2cov covariance) comes in a "
                                  "later slice (ROADMAP.md)")
    return make_fn_y2h(args.dim_embed, args.y2h_embed_type,
                       getattr(args, "label_dim", 1))
