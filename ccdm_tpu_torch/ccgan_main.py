"""The CcGAN and Dual-NDA entry point (ccdm_tpu/ccgan_main.py).

    python -m ccdm_tpu_torch.ccgan_main --data_name Cell200 --gan_arch sngan \
        --niters 30000 --threshold_type hard --comp_FID ...
    Dual-NDA: add --nda_a ... --nda_e (and --badfake_niqe_path /
    --badfake_mae_path, h5 dumps of bad fakes, for nda_d and nda_e).

Flow: parse flags (JAX's names, defaults and choices, plus --device) ->
the Type-I inputs checked (nda_d needs --badfake_niqe_path, nda_e
--badfake_mae_path) -> the dataset -> the label embedding of
<root_path>/output/<data_name>_<image_size>/<setting_name>
(embedding/resolve.build_label_embedding; --y2h_embed_type resnet trains or
loads the ILI nets there) -> SNGAN or SAGAN G and D by --gan_arch ->
CcGANTrainer (+ resume from --resume_niter) -> train, with an eval-mode
grid every --visualize_freq iterations and a milestone every
--save_niters_freq, then a milestone at --niters, under
<setting>/ccgan_results/ -> per eval label (--eval_mode) --nfake_per_label
eval-mode images into ccgan_results/fake_data_niters<N>/: <label>.h5
(fake_images_i uint8 gzip 6, fake_labels_i) with --dump_fake_data and a
36-image grid sample_<label>.png; a label whose h5 exists is read back
instead -> --comp_FID: the CCGM protocol (eval/protocol.run_ccgm_eval).
h5py is imported only where an h5 is read or written. It runs on the card
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_opts_ccgan(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    # data / paths
    p.add_argument("--root_path", type=str, default="./")
    p.add_argument("--data_name", type=str, default="synthetic",
                   choices=["UTKFace", "RC-49", "Cell200", "SteeringAngle", "synthetic"])
    p.add_argument("--data_path", type=str, default="./datasets")
    p.add_argument("--setting_name", type=str, default="Setup_CcGAN")
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--min_label", type=float, default=0.0)
    p.add_argument("--max_label", type=float, default=90.0)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--num_channels", type=int, default=3)
    # label embedding (sinusoidal is the cheap smoke-mode choice)
    p.add_argument("--dim_embed", type=int, default=128)
    p.add_argument("--y2h_embed_type", type=str, default="resnet",
                   choices=["resnet", "sinusoidal", "gaussian"])
    p.add_argument("--y2cov_embed_type", type=str, default="sinusoidal")
    p.add_argument("--epoch_cnn_embed", type=int, default=200)
    p.add_argument("--epoch_net_y2h", type=int, default=500)
    p.add_argument("--batch_size_embed", type=int, default=256)
    p.add_argument("--dim_combination", type=str, default="mean")
    # GAN
    p.add_argument("--gan_arch", type=str, default="sngan", choices=["sngan", "sagan"])
    p.add_argument("--gene_ch", type=int, default=64)
    p.add_argument("--disc_ch", type=int, default=64)
    p.add_argument("--dim_gan", type=int, default=256, help="z dimension")
    # training
    p.add_argument("--niters", type=int, default=30000)
    p.add_argument("--resume_niter", type=int, default=0)
    p.add_argument("--batch_size_disc", type=int, default=64)
    p.add_argument("--batch_size_gene", type=int, default=64)
    p.add_argument("--num_D_steps", type=int, default=2)
    p.add_argument("--lr_g", type=float, default=1e-4)
    p.add_argument("--lr_d", type=float, default=1e-4)
    p.add_argument("--loss_type", type=str, default="hinge", choices=["hinge", "vanilla"])
    p.add_argument("--threshold_type", type=str, default="hard", choices=["hard", "soft"])
    p.add_argument("--kappa", type=float, default=-1.0)
    p.add_argument("--kernel_sigma", type=float, default=-1.0)
    p.add_argument("--nonzero_soft_weight_threshold", type=float, default=1e-3)
    p.add_argument("--gan_DiffAugment", action="store_true", default=False)
    p.add_argument("--gan_DiffAugment_policy", type=str, default="color,translation,cutout")
    # Dual-NDA (nda_a..e mixing weights; d/e need pre-generated bad fakes)
    p.add_argument("--nda_a", type=float, default=1.0)
    p.add_argument("--nda_b", type=float, default=0.0)
    p.add_argument("--nda_c", type=float, default=0.0)
    p.add_argument("--nda_d", type=float, default=0.0)
    p.add_argument("--nda_e", type=float, default=0.0)
    p.add_argument("--nda_start_iter", type=int, default=0)
    p.add_argument("--badfake_niqe_path", type=str, default="",
                   help="h5 with fake_images/fake_labels (NIQE-filtered Type-I negatives)")
    p.add_argument("--badfake_mae_path", type=str, default="",
                   help="h5 with fake_images/fake_labels (MAE-filtered Type-I negatives)")
    p.add_argument("--visualize_freq", type=int, default=2000)
    p.add_argument("--save_niters_freq", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=100)
    # sampling
    p.add_argument("--nfake_per_label", type=int, default=200)
    p.add_argument("--samp_batch_size", type=int, default=500)
    p.add_argument("--eval_mode", type=int, default=2)
    p.add_argument("--dump_fake_data", action="store_true", default=False)
    # evaluation (the CCGM protocol, eval/protocol.py)
    p.add_argument("--comp_FID", action="store_true", default=False)
    p.add_argument("--FID_radius", type=float, default=0)
    p.add_argument("--FID_num_centers", type=int, default=-1)
    p.add_argument("--comp_prdc", action="store_true", default=False)
    p.add_argument("--prdc_nearest_k", type=int, default=5)
    p.add_argument("--comp_intra_fid", action="store_true", default=False)
    p.add_argument("--comp_niqe", action="store_true", default=False)
    p.add_argument("--niqe_patch", type=int, default=0)
    p.add_argument("--epochs_eval_ae", type=int, default=10)
    p.add_argument("--epochs_eval_cnn", type=int, default=20)
    p.add_argument("--eval_ckpt_path", type=str, default="./")
    return p.parse_args(argv)


def _check_nda_inputs(args) -> None:
    """Dual-NDA's Type-I negatives (nda_d / nda_e) need pre-generated bad
    fakes: training another objective than the flags ask for is refused."""
    if args.nda_d > 0 and not args.badfake_niqe_path:
        raise SystemExit("--nda_d > 0 requires --badfake_niqe_path (h5 of low-NIQE bad fakes)")
    if args.nda_e > 0 and not args.badfake_mae_path:
        raise SystemExit("--nda_e > 0 requires --badfake_mae_path (h5 of high-MAE bad fakes)")


def _load_badfake(path: str):
    """(uint8 images NHWC, f32 labels) of a bad-fake h5 (fake_images /
    fake_labels, or the per-label dumps' *_i names; NCHW dumps turned
    NHWC), or None without a path."""
    if not path:
        return None
    from ccdm_tpu_torch.data.datasets import import_h5py

    with import_h5py("--badfake_niqe_path / --badfake_mae_path").File(path, "r") as f:
        key_i = "fake_images" if "fake_images" in f else "fake_images_i"
        key_l = "fake_labels" if "fake_labels" in f else "fake_labels_i"
        imgs = f[key_i][:]
        labels = f[key_l][:]
    if imgs.ndim == 4 and imgs.shape[1] in (1, 3) and imgs.shape[1] != imgs.shape[-1]:
        imgs = np.transpose(imgs, (0, 2, 3, 1))
    return imgs.astype(np.uint8), np.asarray(labels, np.float32)


def sample_eval_labels(trainer, bundle, args, results_folder: str):
    """Every eval label's --nfake_per_label images (ccgan_main.py:217-242):
    returns (fakes, raw labels), read back where a label's h5 exists."""
    from ccdm_tpu_torch.dmd_main import read_dump, write_dump
    from ccdm_tpu_torch.main import get_eval_labels
    from ccdm_tpu_torch.utils.viz import save_image_grid

    dump_folder = os.path.join(results_folder, f"fake_data_niters{args.niters}")
    os.makedirs(dump_folder, exist_ok=True)
    all_fake_images, all_fake_labels = [], []
    for curr_label in get_eval_labels(bundle, args):
        fp = os.path.join(dump_folder, f"{curr_label}.h5")
        if os.path.isfile(fp):
            imgs, fake_labels_i = read_dump(fp)
        else:
            fake_labels_i = curr_label * np.ones(args.nfake_per_label)
            imgs, _ = trainer.sample_given_labels(bundle.fn_normalize(fake_labels_i),
                                                  batch_size=args.samp_batch_size)
            if args.dump_fake_data:
                write_dump(fp, imgs, fake_labels_i)
            save_image_grid(imgs[:36].astype(np.float32) / 255.0,
                            os.path.join(dump_folder, f"sample_{curr_label}.png"), nrow=6)
        all_fake_images.append(imgs)
        all_fake_labels.append(fake_labels_i)
    print("CcGAN sampling complete", flush=True)
    return np.concatenate(all_fake_images, axis=0), np.concatenate(all_fake_labels)


def build_trainer(args, device, mesh):
    """(trainer, bundle, setting folder, results folder): the data, the
    label embedding, the GANs and their CcGANTrainer on `mesh` (a
    parallel.Mesh) as main() builds them."""
    from ccdm_tpu_torch.data.datasets import load_dataset
    from ccdm_tpu_torch.dmd_main import build_gan
    from ccdm_tpu_torch.embedding.resolve import build_label_embedding
    from ccdm_tpu_torch.parallel.mesh import main_first
    from ccdm_tpu_torch.training.ccgan import CcGANConfig, CcGANTrainer

    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    setting_folder = os.path.join(args.root_path, "output",
                                  f"{args.data_name}_{args.image_size}", args.setting_name)
    results_folder = os.path.join(setting_folder, "ccgan_results")
    os.makedirs(results_folder, exist_ok=True)

    ds_kwargs = dict(image_size=args.image_size)
    if args.data_name == "synthetic":
        ds_kwargs.update(channels=args.num_channels)
    else:
        ds_kwargs.update(min_label=args.min_label, max_label=args.max_label)
    bundle = load_dataset(args.data_name, args.data_path, **ds_kwargs)
    with main_first(mesh):  # rank 0 trains and caches the embedding nets, the others load them
        fn_y2h, _ = build_label_embedding(args, setting_folder, bundle=bundle, device=device)
    netG, netD = (net.to(device) for net in build_gan(args, bundle.channels, bundle.image_size,
                                                        dim_z=args.dim_gan))

    cfg = CcGANConfig(
        data_name=bundle.name, niters=args.niters, batch_size_disc=args.batch_size_disc,
        batch_size_gene=args.batch_size_gene, num_D_steps=args.num_D_steps, lr_g=args.lr_g,
        lr_d=args.lr_d, dim_gan=args.dim_gan, threshold_type=args.threshold_type,
        # the raw flags: compute_vicinal_hyperparams owns the reference's
        # convention (a negative kappa is the rule of thumb's multiplier)
        kappa=args.kappa, kernel_sigma=args.kernel_sigma,
        nonzero_soft_weight_threshold=args.nonzero_soft_weight_threshold,
        loss_type=args.loss_type, use_DiffAugment=args.gan_DiffAugment,
        policy=args.gan_DiffAugment_policy, nda_a=args.nda_a, nda_b=args.nda_b,
        nda_c=args.nda_c, nda_d=args.nda_d, nda_e=args.nda_e,
        nda_start_iter=args.nda_start_iter, save_niters_freq=args.save_niters_freq,
        visualize_freq=args.visualize_freq, results_folder=results_folder,
        log_every=args.log_every, seed=args.seed)
    trainer = CcGANTrainer(netG, netD, bundle.images, bundle.labels_norm, fn_y2h, cfg,
                           badfake_niqe=_load_badfake(args.badfake_niqe_path),
                           badfake_mae=_load_badfake(args.badfake_mae_path), device=device,
                           mesh=mesh)
    return trainer, bundle, setting_folder, results_folder


def main(argv=None):
    from ccdm_tpu_torch.parallel.mesh import bootstrap
    from ccdm_tpu_torch.utils.device import resolve_device

    args = parse_opts_ccgan(argv)
    _check_nda_inputs(args)
    mesh = bootstrap(args.device)  # before any device query
    device = resolve_device(args.device)
    trainer, bundle, setting_folder, results_folder = build_trainer(args, device, mesh)
    if args.resume_niter > 0:
        trainer.load(args.resume_niter)
        print(f" resumed from milestone ccgan-{args.resume_niter}", flush=True)
    trainer.train()
    trainer.save(args.niters)
    if not mesh.is_main:  # rank 0 samples, evaluates and writes the artifacts
        return trainer

    fakes, flabels = sample_eval_labels(trainer, bundle, args, results_folder)
    if args.comp_FID:
        from ccdm_tpu_torch.eval.protocol import run_ccgm_eval

        trainer.eval_results = run_ccgm_eval(args, bundle, fakes, flabels, setting_folder,
                                             total_time=0.0)
    return trainer


if __name__ == "__main__":
    main()
