"""One place that maps the CLI's embedding flags to (fn_y2h, fn_y2cov).

Counterpart of ccdm_tpu/embedding/resolve.py:27-91:
- sinusoidal and gaussian types -> embedding/analytic.py (the gaussian W
  read from, or drawn into, <setting_folder>/embed_models/);
- resnet -> the ILI pipeline of embedding/ili.py under
  <setting_folder>/embed_models/: trained or loaded when a dataset bundle
  is given, load-only (FileNotFoundError on a miss) when not or with
  `require_cached`. Serving passes the teacher's setting folder.
fn_y2cov is None unless --use_Hy. Multi-dim labels come in a later slice
(ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

from ccdm_tpu_torch.embedding.analytic import (
    Y2COV_SEED,
    Y2H_SEED,
    gaussian_projection,
    make_fn_y2cov,
    make_fn_y2h,
)
from ccdm_tpu_torch.utils.device import resolve_device


def build_label_embedding(args, setting_folder: str, bundle=None, require_cached: bool = False,
                          device=None) -> Tuple[Callable, Optional[Callable]]:
    """(fn_y2h, fn_y2cov or None) from --y2h_embed_type, --y2cov_embed_type,
    --use_Hy, --dim_embed and the ILI flags (the JAX defaults where `args`
    lacks them); the ILI nets run on `device` (default: --device)."""
    label_dim = bundle.label_dim if bundle is not None else getattr(args, "label_dim", 1)
    if label_dim != 1:
        raise NotImplementedError("multi-dim labels (embedding/combine.py) come in a "
                                  "later slice (ROADMAP.md)")
    channels = bundle.channels if bundle is not None else args.num_channels
    image_size = bundle.image_size if bundle is not None else args.image_size
    cov_dim = channels * image_size ** 2
    use_Hy = bool(getattr(args, "use_Hy", False))
    y2h_type = args.y2h_embed_type
    y2cov_type = getattr(args, "y2cov_embed_type", "sinusoidal")
    embed_dir = os.path.join(setting_folder, "embed_models")
    load_only = require_cached or bundle is None

    if y2h_type != "resnet" and use_Hy and y2cov_type == "resnet":
        raise SystemExit("--y2cov_embed_type resnet requires --y2h_embed_type resnet "
                         "(the trained ILI pipeline provides both heads)")

    if y2h_type == "resnet":
        from ccdm_tpu_torch.embedding.ili import LabelEmbed

        le = LabelEmbed(
            bundle, setting_folder,
            dim_embed=args.dim_embed,
            y2cov_type=y2cov_type if use_Hy else None,
            cov_dim=cov_dim,
            epochs_cnn=getattr(args, "epoch_cnn_embed", 200),
            epochs_mlp=getattr(args, "epoch_net_y2h", 500),
            epochs_cnn_y2cov=getattr(args, "epoch_cnn_embed_y2cov", 10),
            epochs_mlp_y2cov=getattr(args, "epoch_net_y2cov", 500),
            net_embed=getattr(args, "net_embed", "ResNet34_embed"),
            net_embed_y2cov=getattr(args, "net_embed_y2cov", "ResNet34_embed_y2cov"),
            batch_size=getattr(args, "batch_size_embed", 256),
            batch_size_y2cov=getattr(args, "batch_size_embed_y2cov", None),
            resume_epoch_cnn=getattr(args, "resumeepoch_cnn_embed", 0),
            resume_epoch_cnn_y2cov=getattr(args, "resumeepoch_cnn_embed_y2cov", 0),
            seed=getattr(args, "seed", 111),
            require_cached=require_cached,
            label_dim=label_dim,
            device=resolve_device(device or getattr(args, "device", None)),
        )
        return le.fn_y2h, le.fn_y2cov

    projection = lambda kind, dim, seed: gaussian_projection(embed_dir, kind, dim, seed,
                                                              write=not load_only)
    fn_y2h = make_fn_y2h(args.dim_embed, y2h_type, label_dim,
                         W=projection("y2h", args.dim_embed, Y2H_SEED)
                         if y2h_type == "gaussian" else None)
    fn_y2cov = None
    if use_Hy:
        fn_y2cov = make_fn_y2cov(cov_dim, y2cov_type, label_dim,
                                 W=projection("y2cov", cov_dim, Y2COV_SEED)
                                 if y2cov_type == "gaussian" else None)
    return fn_y2h, fn_y2cov
