"""CLI flags of the training, sampling, eval and serving paths: every flag
of ccdm_tpu/opts.py with its name, default and choices, plus --device and
the flags of the port's own entry points."""

from __future__ import annotations

import argparse


def parse_opts(argv=None):
    parser = argparse.ArgumentParser()

    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")

    # Overall
    parser.add_argument("--root_path", type=str, default="./")
    parser.add_argument("--data_name", type=str, default="synthetic",
                        choices=["UTKFace", "RC-49", "Cell200", "SteeringAngle",
                                 "synthetic", "power_vector", "synthetic_power"])
    parser.add_argument("--data_path", type=str, default="./datasets")
    # power_vector: tiff design images + a CSV of power vectors (multi-dim labels)
    parser.add_argument("--design_folder", type=str, default="None",
                        help="power_vector: tiff design-image folder "
                             "(default <data_path>/designs)")
    parser.add_argument("--power_data_path", type=str, default="None",
                        help="power_vector: power-vector CSV (default <data_path>/power.csv)")
    parser.add_argument("--use_power_transformer", action="store_true", default=False,
                        help="normalize power labels with the quantile PowerTransformer")
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--num_workers", type=int, default=0,
                        help="accepted so that the reference's launch scripts run; "
                             "inert: the data pipeline is device-resident, with no "
                             "host loader processes to parallelise")
    parser.add_argument("--setting_name", type=str, default="Setup1")
    parser.add_argument("--architecture", type=str, default="unet",
                        choices=["unet", "vit", "adm"])
    parser.add_argument("--label_embed", type=str, default="ccdm2",
                        choices=["ccdm1", "ccdm2", "random"])
    parser.add_argument("--label_dim", type=int, default=1)
    parser.add_argument("--vicinity_type", type=str, default=None,
                        choices=["shv", "ssv", "hv", "sv", "none"])
    parser.add_argument("--threshold_type", type=str, default=None, choices=["hard", "soft"],
                        help="vanilla-tree alias: hard->hv, soft->sv")
    parser.add_argument("--distance", type=str, default="l2", choices=["l1", "l2", "cosine"])
    parser.add_argument("--vector_type", type=str, default="gaussian",
                        choices=["gaussian", "rademacher", "sphere"])
    parser.add_argument("--hyperparameter", type=str, default="rule_of_thumb",
                        choices=["rule_of_thumb", "percentile"])
    parser.add_argument("--adaptive_slicing", action="store_true", default=False)
    parser.add_argument("--synthetic_n", type=int, default=0,
                        help="sample count of the synthetic and synthetic_power sets; "
                             "0 keeps each one's default")
    parser.add_argument("--percentile", type=float, default=5.0)
    parser.add_argument("--num_projections", type=int, default=1)
    parser.add_argument("--dim_combination", type=str, default="mean",
                        choices=["mean", "weighted", "attention", "cross", "cross_attention"])

    # Dataset and model
    parser.add_argument("--min_label", type=float, default=0.0)
    parser.add_argument("--max_label", type=float, default=90.0)
    parser.add_argument("--max_num_img_per_label", type=int, default=int(1e30))
    parser.add_argument("--num_img_per_label_after_replica", type=int, default=0)
    parser.add_argument("--data_split", type=str, default="train", choices=["train", "all"])
    parser.add_argument("--stepsize", type=int, default=2, help="Cell-200 label stride")
    parser.add_argument("--num_imgs_per_label", type=int, default=10,
                        help="Cell-200 per-label subset")
    parser.add_argument("--num_channels", type=int, default=3)
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--model_channels", type=int, default=64)
    parser.add_argument("--num_res_blocks", type=int, default=2,
                        help="--architecture adm: resnet blocks per level")
    parser.add_argument("--num_heads", type=int, default=4)
    parser.add_argument("--num_groups", type=int, default=8,
                        help="--architecture adm: GroupNorm groups")
    parser.add_argument("--attention_resolutions", type=str, default="16_32",
                        help="--architecture adm: the downsampling factors (1 at the "
                             "input, doubling per level) whose blocks attend")
    parser.add_argument("--channel_mult", type=str, default="1_2_4_8")
    parser.add_argument("--attn_dim_head", type=int, default=32)
    parser.add_argument("--cond_drop_prob", type=float, default=0.1)

    # Diffusion and training
    parser.add_argument("--pred_objective", type=str, default="pred_noise",
                        choices=["pred_noise", "pred_x0", "pred_v"])
    parser.add_argument("--niters", type=int, default=10)
    parser.add_argument("--resume_niter", type=int, default=0)
    parser.add_argument("--train_timesteps", type=int, default=1000)
    parser.add_argument("--train_batch_size", type=int, default=16)
    parser.add_argument("--train_lr", type=float, default=1e-4)
    parser.add_argument("--train_amp", action="store_true", default=False,
                        help="bf16 activations (f32 master weights)")
    parser.add_argument("--gradient_accumulate_every", type=int, default=1)
    parser.add_argument("--beta_schedule", type=str, default="cosine",
                        choices=["cosine", "linear"])
    parser.add_argument("--sample_every", type=int, default=1000,
                        help="stride of the EMA sample grids results/sample_<step>.png")
    parser.add_argument("--save_every", type=int, default=10000)
    parser.add_argument("--log_every", type=int, default=500,
                        help="loss/throughput logging stride (reference logs every 500)")
    parser.add_argument("--tb_log", action="store_true", default=False,
                        help="also write TensorBoard event files under results/tb")

    # Label embedding
    parser.add_argument("--y2h_embed_type", type=str, default="sinusoidal",
                        choices=["resnet", "sinusoidal", "gaussian"])
    parser.add_argument("--y2cov_embed_type", type=str, default="sinusoidal",
                        choices=["resnet", "sinusoidal", "gaussian"])
    parser.add_argument("--use_Hy", action="store_true", default=False)
    parser.add_argument("--hy_max_log", type=float, default=4.0,
                        help="cap on the y2cov log-scale h in Hy=exp(-h); "
                             "<=0 disables (exact reference semantics)")
    parser.add_argument("--net_embed", type=str, default="ResNet34_embed")
    parser.add_argument("--epoch_cnn_embed", type=int, default=200)
    parser.add_argument("--resumeepoch_cnn_embed", type=int, default=0)
    parser.add_argument("--epoch_net_y2h", type=int, default=500)
    parser.add_argument("--dim_embed", type=int, default=128)
    parser.add_argument("--batch_size_embed", type=int, default=256)
    parser.add_argument("--net_embed_y2cov", type=str, default="ResNet34_embed_y2cov")
    parser.add_argument("--epoch_cnn_embed_y2cov", type=int, default=10)
    parser.add_argument("--resumeepoch_cnn_embed_y2cov", type=int, default=0)
    parser.add_argument("--epoch_net_y2cov", type=int, default=500)
    parser.add_argument("--batch_size_embed_y2cov", type=int, default=256)

    # Auxiliary elastic loss
    parser.add_argument("--lambda_aux", type=float, default=0.0,
                        help=">0 enables the elastic aux label loss (pred_noise only)")
    parser.add_argument("--net_aux", type=str, default="ResNet34",
                        choices=["VGG11", "VGG13", "VGG16", "VGG19", "ResNet18", "ResNet34"])
    parser.add_argument("--epoch_aux", type=int, default=200)
    parser.add_argument("--batch_size_aux", type=int, default=256)
    parser.add_argument("--aux_start_step", type=int, default=0)

    # Vicinal loss
    parser.add_argument("--kernel_sigma", type=float, default=-1.0)
    parser.add_argument("--kappa", type=float, default=-1.0)
    parser.add_argument("--nonzero_soft_weight_threshold", type=float, default=1e-3)

    # Sampling
    parser.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "ddpm"])
    parser.add_argument("--sample_timesteps", type=int, default=250)
    parser.add_argument("--sample_cond_scale", type=float, default=1.5)
    parser.add_argument("--ddim_eta", type=float, default=0.0)
    parser.add_argument("--nfake_per_label", type=int, default=200)
    parser.add_argument("--samp_batch_size", type=int, default=100)
    parser.add_argument("--dump_fake_data", action="store_true", default=False,
                        help="write the per-label h5 sample dumps (sampling runs "
                             "either way); needs h5py")
    parser.add_argument("--samp_precast_bf16", action="store_true", default=False,
                        help="cast the f32 weight tensors to bf16 once before "
                             "sampling (training/state.precast_sampling_params)")

    parser.add_argument("--gif_trajectory", action="store_true", default=False,
                        help="write results/trajectory_niters<N>.gif, the DDIM "
                             "trajectory of the visual label grid")
    parser.add_argument("--interpolation", action="store_true", default=False,
                        help="write results/interpolation_niters<N>.png, two "
                             "training images blended in latent space")

    # Evaluation (the CCGM protocol of eval/protocol.py; ccdm_tpu/opts.py:186-235)
    parser.add_argument("--eval_ckpt_path", type=str, default="./",
                        help="the eval backbones and the NIQE model are trained into, or "
                             "loaded from, <eval_ckpt_path>/eval_models/")
    parser.add_argument("--epochs_eval_ae", type=int, default=10,
                        help="epochs for training the SFID autoencoder backbone")
    parser.add_argument("--epochs_eval_cnn", type=int, default=20,
                        help="epochs for training the LS/Diversity ResNet backbones")
    parser.add_argument("--comp_FID", action="store_true", default=False)
    parser.add_argument("--eval_mode", type=int, default=2, choices=[1, 2, 3, 4])
    parser.add_argument("--FID_radius", type=float, default=0)
    parser.add_argument("--FID_num_centers", type=int, default=-1)
    parser.add_argument("--dump_fake_for_NIQE", action="store_true", default=False,
                        help="write every fake as <niqe_dump_path>/<i>_<label>.png, then stop")
    parser.add_argument("--niqe_dump_path", type=str, default="None",
                        help="default results/saved_images/fake_images")
    parser.add_argument("--comp_niqe", action="store_true", default=False,
                        help="native NIQE (eval/niqe.py) calibrated on the real images")
    parser.add_argument("--niqe_patch", type=int, default=0,
                        help="NIQE patch size; 0 = auto (96 at >=192px, else image_size/2)")
    parser.add_argument("--comp_IS_and_FID_only", action="store_true", default=False)
    parser.add_argument("--comp_prdc", action="store_true", default=False,
                        help="precision/recall/density/coverage over the FID feature net")
    parser.add_argument("--prdc_nearest_k", type=int, default=5)
    parser.add_argument("--comp_intra_fid", action="store_true", default=False,
                        help="FID per label class, the labels binned into shared classes")
    parser.add_argument("--knn_analysis", action="store_true", default=False,
                        help="k-nearest-real grids for fake anchors")
    parser.add_argument("--frequency_analysis", action="store_true", default=False,
                        help="mean FFT log-spectrum, real vs fake")
    parser.add_argument("--tsne_analysis", action="store_true", default=False,
                        help="2-D t-SNE (PCA without sklearn) of the FID features, real vs fake")
    parser.add_argument("--GAN_train", action="store_true", default=False,
                        help="classification accuracy score: train on fake, test on real")
    parser.add_argument("--GAN_test", action="store_true", default=False,
                        help="classification accuracy score: train on real, test on fake")

    # Serving
    parser.add_argument("--serve_port", type=int, default=8600)
    parser.add_argument("--serve_host", type=str, default="127.0.0.1",
                        help="bind address; 0.0.0.0 exposes the card to the "
                             "network and is an explicit opt-in")
    parser.add_argument("--serve_max_labels", type=int, default=1024)
    parser.add_argument("--serve_milestone", type=int, default=0,
                        help="milestone to load (0 = weights from --seed)")
    args = parser.parse_args(argv)
    if args.vicinity_type is None:  # the threshold_type alias (ccdm_tpu/opts.py:241-248)
        args.vicinity_type = {"hard": "hv", "soft": "sv"}.get(args.threshold_type, "shv")
    return args


def parse_channel_mult(s: str) -> tuple:
    """'1_2_4_8' -> (1, 2, 4, 8)."""
    return tuple(int(x) for x in s.split("_"))
