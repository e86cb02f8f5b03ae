"""One place that maps the CLI's embedding flags to (fn_y2h, fn_y2cov).

Counterpart of ccdm_tpu/embedding/resolve.py:27-91:
- sinusoidal and gaussian types -> embedding/analytic.py (the gaussian W
  read from, or drawn into, <setting_folder>/embed_models/);
- resnet -> the ILI pipeline of embedding/ili.py under
  <setting_folder>/embed_models/: trained or loaded when a dataset bundle
  is given, load-only (FileNotFoundError on a miss) when not or with
  `require_cached`. Serving passes the teacher's setting folder.
fn_y2cov is None unless --use_Hy. With --label_dim > 1 (or a bundle of
multi-dim labels) the analytic types embed each selected dim and combine
them by --dim_combination, its weights read from, or drawn into,
embed_models/ (embedding/combine.py); the ILI y2h does the same over every
label dim.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

from ccdm_tpu_torch.embedding.analytic import (
    COMBINER_SEED_OFFSET,
    Y2COV_SEED,
    Y2H_SEED,
    gaussian_projection,
    make_fn_y2cov,
    make_fn_y2h,
    selected_dims,
)
from ccdm_tpu_torch.embedding.combine import combiner_weights
from ccdm_tpu_torch.utils.device import resolve_device


def build_label_embedding(args, setting_folder: str, bundle=None, require_cached: bool = False,
                          device=None) -> Tuple[Callable, Optional[Callable]]:
    """(fn_y2h, fn_y2cov or None) from --y2h_embed_type, --y2cov_embed_type,
    --use_Hy, --dim_embed and the ILI flags (the JAX defaults where `args`
    lacks them); the ILI nets and the combiners run on `device` (default:
    --device)."""
    label_dim = bundle.label_dim if bundle is not None else getattr(args, "label_dim", 1)
    channels = bundle.channels if bundle is not None else args.num_channels
    image_size = bundle.image_size if bundle is not None else args.image_size
    cov_dim = channels * image_size ** 2
    use_Hy = bool(getattr(args, "use_Hy", False))
    y2h_type = args.y2h_embed_type
    y2cov_type = getattr(args, "y2cov_embed_type", "sinusoidal")
    dim_comb = getattr(args, "dim_combination", "mean")
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
            dim_combination=dim_comb,
            require_cached=require_cached,
            label_dim=label_dim,
            device=resolve_device(device or getattr(args, "device", None)),
        )
        return le.fn_y2h, le.fn_y2cov

    num_dims = len(selected_dims(label_dim))
    # a combiner runs where the labels are: --device (default: the card)
    comb_device = (resolve_device(device or getattr(args, "device", None))
                   if label_dim > 1 and dim_comb != "mean" else None)

    def data(kind: str, embed_type: str, dim: int, seed: int) -> dict:
        """The W and the combiner of the `kind` embedding."""
        W = (gaussian_projection(embed_dir, kind, dim, seed, write=not load_only,
                                 num_dims=num_dims) if embed_type == "gaussian" else None)
        combiner = (combiner_weights(embed_dir, kind, dim_comb, dim, num_dims,
                                     seed + COMBINER_SEED_OFFSET, write=not load_only,
                                     device=comb_device)
                    if label_dim > 1 else None)
        return dict(W=W, dim_combination=dim_comb, combiner=combiner)

    fn_y2h = make_fn_y2h(args.dim_embed, y2h_type, label_dim,
                         **data("y2h", y2h_type, args.dim_embed, Y2H_SEED))
    fn_y2cov = None
    if use_Hy:
        fn_y2cov = make_fn_y2cov(cov_dim, y2cov_type, label_dim,
                                 **data("y2cov", y2cov_type, cov_dim, Y2COV_SEED))
    return fn_y2h, fn_y2cov
