"""The DMD2-M distillation entry point (ccdm_tpu/dmd_main.py).

    python -m ccdm_tpu_torch.dmd_main --data_name SteeringAngle \
        --min_label -80 --max_label 80 --teacher_milestone 20 \
        --model_channels 64 --channel_mult 1_2_2_4_8 --gan_arch sngan \
        --train_batch_size 128 --gan_DiffAugment --niters 50000

Flow: parse flags (JAX's names, defaults and choices, plus --device) ->
the dataset -> the label embeddings of the TEACHER's setting folder
(<root_path>/output/<data_name>_<image_size>/<teacher_setting_name or
setting_name>, its embed_models/ for the ILI nets) -> the teacher Unet (f32)
holding the EMA weights of the port's milestone --teacher_milestone under
that folder's results/ (random weights from --seed if there is none, the
JAX entry's smoke mode), the fake UNet a deep copy of it -> SNGAN or SAGAN
G and D -> DMD2Trainer (+ resume from --resume_niter) -> train, milestones
<setting>/dmd_results/model-dmd-<N>/state.pt and eval-mode grids
sample_<step>.png -> per eval label (--eval_mode) --nfake_per_label
one-step images into dmd_results/fake_data_onestep_niters<N>/: <label>.h5
(fake_images_i uint8 gzip 6, fake_labels_i) and a 36-image grid
sample_<label>.png; a label whose h5 exists is skipped (and read back for
the eval) -> --comp_FID: the CCGM protocol (eval/protocol.run_ccgm_eval)
against the pinned backbones of --eval_ckpt_path, written under the
setting folder -> --interpolation / --sefa: dmd_results/analysis/
interpolation.png (a label sweep at one latent, then a latent sweep at one
label) and sefa.png (SeFa axes of netG's first dense kernel, JAX's [in,
out] layout). It runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch


def parse_opts_dmd(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    # data / paths (shared surface with main.py)
    p.add_argument("--root_path", type=str, default="./")
    p.add_argument("--data_name", type=str, default="synthetic",
                   choices=["UTKFace", "RC-49", "Cell200", "SteeringAngle", "synthetic"])
    p.add_argument("--data_path", type=str, default="./datasets")
    p.add_argument("--setting_name", type=str, default="Setup1")
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--min_label", type=float, default=0.0)
    p.add_argument("--max_label", type=float, default=90.0)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--num_channels", type=int, default=3)
    p.add_argument("--max_num_img_per_label", type=int, default=int(1e30))
    # teacher
    p.add_argument("--teacher_setting_name", type=str, default=None,
                   help="setting dir of the trained CCDM teacher (default: setting_name)")
    p.add_argument("--teacher_milestone", type=int, required=False, default=0)
    p.add_argument("--model_channels", type=int, default=64)
    p.add_argument("--channel_mult", type=str, default="1_2_2_4_8")
    p.add_argument("--dim_embed", type=int, default=128)
    p.add_argument("--train_timesteps", type=int, default=1000)
    p.add_argument("--beta_schedule", type=str, default="cosine")
    p.add_argument("--use_Hy", action="store_true", default=False)
    p.add_argument("--hy_max_log", type=float, default=4.0,
                   help="cap on the y2cov log-scale h in Hy=exp(-h); <=0 disables")
    p.add_argument("--y2h_embed_type", type=str, default="sinusoidal",
                   choices=["resnet", "sinusoidal", "gaussian"])
    p.add_argument("--y2cov_embed_type", type=str, default="sinusoidal")
    # ILI embed-training hyperparameters (the teacher's, so that its cached
    # embed_models/ entries are found)
    p.add_argument("--epoch_cnn_embed", type=int, default=200)
    p.add_argument("--epoch_net_y2h", type=int, default=500)
    p.add_argument("--epoch_cnn_embed_y2cov", type=int, default=10)
    p.add_argument("--epoch_net_y2cov", type=int, default=500)
    p.add_argument("--batch_size_embed", type=int, default=256)
    p.add_argument("--dim_combination", type=str, default="mean")
    # GAN
    p.add_argument("--gan_arch", type=str, default="sngan", choices=["sngan", "sagan"])
    p.add_argument("--gene_ch", type=int, default=64)
    p.add_argument("--disc_ch", type=int, default=64)
    p.add_argument("--dim_z", type=int, default=256)
    # DMD training
    p.add_argument("--niters", type=int, default=50000)
    p.add_argument("--resume_niter", type=int, default=0)
    p.add_argument("--train_batch_size", type=int, default=128)
    p.add_argument("--gradient_accumulate_every", type=int, default=1)
    p.add_argument("--train_lr_generator", type=float, default=1e-4)
    p.add_argument("--train_lr_guidance", type=float, default=1e-4)
    p.add_argument("--num_D_steps", type=int, default=2)
    p.add_argument("--weight_guidance_adv", type=float, default=10.0)
    p.add_argument("--weight_generator_adv", type=float, default=1.0)
    p.add_argument("--adv_loss_type", type=str, default="hinge", choices=["hinge", "vanilla"])
    p.add_argument("--gan_DiffAugment", action="store_true", default=False)
    p.add_argument("--gan_DiffAugment_policy", type=str, default="color,translation,cutout")
    p.add_argument("--min_step_percent", type=float, default=0.02)
    p.add_argument("--max_step_percent", type=float, default=0.98)
    p.add_argument("--kappa", type=float, default=-1.0)
    p.add_argument("--kernel_sigma", type=float, default=-1.0)
    p.add_argument("--sample_every", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=5000)
    # sampling
    p.add_argument("--nfake_per_label", type=int, default=200)
    p.add_argument("--samp_batch_size", type=int, default=200)
    p.add_argument("--eval_mode", type=int, default=2)
    # analysis artifacts over the one-step G
    p.add_argument("--interpolation", action="store_true", default=False,
                   help="fix_z (label sweep) + fix_y (latent sweep) grids")
    p.add_argument("--sefa", action="store_true", default=False,
                   help="closed-form semantic latent axes of netG's first dense layer")
    # evaluation: the CCGM protocol shared with main.py (point
    # --eval_ckpt_path at the teacher's run so that the pinned backbones
    # make teacher and student numbers comparable)
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
    # one-step student serving (python -m ccdm_tpu_torch.serve_dmd)
    p.add_argument("--serve_port", type=int, default=8600)
    p.add_argument("--serve_host", type=str, default="127.0.0.1")
    p.add_argument("--serve_max_labels", type=int, default=4096)
    p.add_argument("--serve_milestone", type=int, default=0)
    return p.parse_args(argv)


def setting_folder(args, teacher: bool = False) -> str:
    """<root_path>/output/<data_name>_<image_size>/<setting_name>, or the
    teacher's (--teacher_setting_name, default the same)."""
    name = (args.teacher_setting_name or args.setting_name) if teacher else args.setting_name
    return os.path.join(args.root_path, "output", f"{args.data_name}_{args.image_size}", name)


def dmd_results_folder(args) -> str:
    return os.path.join(setting_folder(args), "dmd_results")


def build_gan(args, channels: int, image_size: int, dim_z: int | None = None):
    """(netG, netD) of --gan_arch at --gene_ch, --disc_ch, --dim_embed and
    `dim_z` (default --dim_z; ccgan_main's is --dim_gan), weights drawn
    from --seed."""
    from ccdm_tpu_torch.models import sagan, sngan

    G, D = ((sngan.SNGANGenerator, sngan.SNGANDiscriminator) if args.gan_arch == "sngan"
            else (sagan.SAGANGenerator, sagan.SAGANDiscriminator))
    netG = G(dim_z=dim_z or args.dim_z, dim_embed=args.dim_embed, nc=channels,
             img_size=image_size, gene_ch=args.gene_ch, seed=args.seed)
    netD = D(dim_embed=args.dim_embed, nc=channels, img_size=image_size,
             disc_ch=args.disc_ch, seed=args.seed)
    return netG, netD


def first_dense_kernel(netG) -> torch.Tensor:
    """netG's first dense kernel in JAX's [in, out] layout (SNGAN's dense,
    SAGAN's spectral-normalised snlinear0, unnormalised)."""
    dense = netG.dense if hasattr(netG, "dense") else netG.snlinear0.dense
    return dense.weight.detach().T


def write_dump(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """One label's h5, as the JAX entry writes it (dmd_main.py:259-262)."""
    from ccdm_tpu_torch.data.datasets import import_h5py

    with import_h5py("the per-label sample dumps").File(path, "w") as f:
        f.create_dataset("fake_images_i", data=images, dtype="uint8", compression="gzip",
                         compression_opts=6)
        f.create_dataset("fake_labels_i", data=labels, dtype="float")


def read_dump(path: str) -> tuple[np.ndarray, np.ndarray]:
    from ccdm_tpu_torch.data.datasets import import_h5py

    with import_h5py("reading an existing sample dump").File(path, "r") as f:
        return f["fake_images_i"][:], f["fake_labels_i"][:]


def sample_eval_labels(trainer, bundle, args, results: str):
    """One-step samples of every eval label (dmd_main.py:240-268): returns
    (fakes, raw labels) with --comp_FID, else (None, None)."""
    from ccdm_tpu_torch.main import get_eval_labels
    from ccdm_tpu_torch.utils.viz import save_image_grid

    dump_folder = os.path.join(results, f"fake_data_onestep_niters{args.niters}")
    os.makedirs(dump_folder, exist_ok=True)
    all_fake_images, all_fake_labels = [], []
    for curr_label in get_eval_labels(bundle, args):
        fp = os.path.join(dump_folder, f"{curr_label}.h5")
        if os.path.isfile(fp):
            if args.comp_FID:
                imgs, labs = read_dump(fp)
                all_fake_images.append(imgs)
                all_fake_labels.append(labs)
            continue
        fake_labels_i = curr_label * np.ones(args.nfake_per_label)
        imgs, _ = trainer.sample_given_labels(bundle.fn_normalize(fake_labels_i),
                                              batch_size=args.samp_batch_size)
        write_dump(fp, imgs, fake_labels_i)
        save_image_grid(imgs[:36].astype(np.float32) / 255.0,
                        os.path.join(dump_folder, f"sample_{curr_label}.png"), nrow=6)
        if args.comp_FID:
            all_fake_images.append(imgs)
            all_fake_labels.append(fake_labels_i)
    print("DMD sampling complete", flush=True)
    if not args.comp_FID:
        return None, None
    return np.concatenate(all_fake_images, axis=0), np.concatenate(all_fake_labels)


def save_analysis(trainer, bundle, args, results: str) -> list[str]:
    """--interpolation and --sefa over the eval-mode one-step generator
    (dmd_main.py:283-328); returns the paths written."""
    from ccdm_tpu_torch.eval import analysis
    from ccdm_tpu_torch.utils.viz import save_image_grid

    device = trainer.device
    fig_dir = os.path.join(results, "analysis")
    os.makedirs(fig_dir, exist_ok=True)

    def gen_fn(z, y):  # y: normalized scalar labels [B] -> [B, H, W, C] in [0, 1]
        return torch.clamp(trainer.generate(y, z), 0.0, 1.0)

    gen = torch.Generator(device=device).manual_seed(args.seed + 101)
    uniq = np.unique(bundle.labels_norm.reshape(len(bundle.labels_norm), -1)[:, 0])
    y_lo = torch.tensor(float(np.quantile(uniq, 0.1)), device=device)
    y_hi = torch.tensor(float(np.quantile(uniq, 0.9)), device=device)
    z0, z1 = torch.randn(2, args.dim_z, generator=gen, device=device)
    written = []
    if args.interpolation:
        fix_z = analysis.linear_interpolation(gen_fn, z0, z0, y_lo, y_hi, steps=8)
        fix_y = analysis.linear_interpolation(gen_fn, z0, z1, y_lo, y_lo, steps=8)
        written.append(os.path.join(fig_dir, "interpolation.png"))
        save_image_grid(np.concatenate([fix_z, fix_y], 0), written[-1], nrow=8)
        print(f" interpolation grids -> {written[-1]}", flush=True)
    if args.sefa:
        canvas = analysis.semantic_factorization(gen_fn, first_dense_kernel(trainer.netG), z0,
                                                 y_lo, num_axes=4, num_cols=8)
        a, ncol = canvas.shape[:2]
        written.append(os.path.join(fig_dir, "sefa.png"))
        save_image_grid(canvas.reshape(a * ncol, *canvas.shape[2:]), written[-1], nrow=ncol)
        print(f" SeFa canvas -> {written[-1]}", flush=True)
    return written


def main(argv=None):
    from ccdm_tpu_torch.data.datasets import load_dataset
    from ccdm_tpu_torch.embedding.resolve import build_label_embedding
    from ccdm_tpu_torch.models.unet import Unet
    from ccdm_tpu_torch.opts import parse_channel_mult
    from ccdm_tpu_torch.parallel.mesh import bootstrap, main_first
    from ccdm_tpu_torch.serve import ema_model_from_milestone
    from ccdm_tpu_torch.training.dmd import DMD2Trainer, DMDConfig
    from ccdm_tpu_torch.utils.ckpt import checkpoint_exists
    from ccdm_tpu_torch.utils.device import resolve_device

    args = parse_opts_dmd(argv)
    mesh = bootstrap(args.device)  # before any device query
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    setting = setting_folder(args)
    results = dmd_results_folder(args)
    os.makedirs(results, exist_ok=True)

    ds_kwargs = dict(image_size=args.image_size)
    if args.data_name == "synthetic":
        ds_kwargs.update(channels=args.num_channels)
    else:
        ds_kwargs.update(min_label=args.min_label, max_label=args.max_label)
    bundle = load_dataset(args.data_name, args.data_path, **ds_kwargs)

    # the embeddings of the TEACHER's setting folder: distillation conditions
    # through the space the teacher was trained in
    teacher_setting = setting_folder(args, teacher=True)
    with main_first(mesh):  # rank 0 trains and caches the embedding nets, the others load them
        fn_y2h, fn_y2cov = build_label_embedding(args, teacher_setting, bundle=bundle,
                                                 device=device)

    teacher = Unet(dim=args.model_channels, dim_mults=parse_channel_mult(args.channel_mult),
                   in_channels=bundle.channels, seed=args.seed)
    teacher_results = os.path.join(teacher_setting, "results")
    if args.teacher_milestone > 0 and checkpoint_exists(teacher_results, args.teacher_milestone):
        teacher = ema_model_from_milestone(teacher, teacher_results, args.teacher_milestone)
        print(f" loaded teacher from milestone {args.teacher_milestone}", flush=True)
    else:
        print(" WARNING: no teacher checkpoint found; using random init (smoke mode)",
              flush=True)
    teacher = teacher.to(device, memory_format=torch.channels_last)
    fake_unet = copy.deepcopy(teacher)
    netG, netD = (net.to(device) for net in build_gan(args, bundle.channels, bundle.image_size))

    cfg = DMDConfig(
        data_name=bundle.name, train_batch_size=args.train_batch_size, niters=args.niters,
        train_lr_generator=args.train_lr_generator, train_lr_guidance=args.train_lr_guidance,
        num_D_steps=args.num_D_steps, weight_generator_adv=args.weight_generator_adv,
        weight_guidance_adv=args.weight_guidance_adv, adv_loss_type=args.adv_loss_type,
        gan_DiffAugment=args.gan_DiffAugment, gan_DiffAugment_policy=args.gan_DiffAugment_policy,
        min_step_percent=args.min_step_percent, max_step_percent=args.max_step_percent,
        train_timesteps=args.train_timesteps, beta_schedule=args.beta_schedule,
        use_Hy=args.use_Hy, hy_max_log=args.hy_max_log,
        kappa=None if args.kappa < 0 else args.kappa,
        kernel_sigma=None if args.kernel_sigma < 0 else args.kernel_sigma,
        z_dim=args.dim_z, sample_every=args.sample_every, save_every=args.save_every,
        results_folder=results, seed=args.seed)
    trainer = DMD2Trainer(teacher, fake_unet, netG, netD, bundle.images, bundle.labels_norm,
                          fn_y2h, cfg, fn_y2cov=fn_y2cov, device=device, mesh=mesh)
    if args.resume_niter > 0:
        trainer.load(args.resume_niter)
        print(f" resumed from milestone dmd-{args.resume_niter}", flush=True)
    trainer.train()
    trainer.save(args.niters)
    if not mesh.is_main:  # rank 0 samples, evaluates and writes the artifacts
        return trainer

    fakes, flabels = sample_eval_labels(trainer, bundle, args, results)
    if args.comp_FID:
        # the one-step student through the protocol and backbones of the teacher
        from ccdm_tpu_torch.eval.protocol import run_ccgm_eval

        trainer.eval_results = run_ccgm_eval(args, bundle, fakes, flabels, setting,
                                             total_time=0.0)
    if args.interpolation or args.sefa:
        trainer.analysis = save_analysis(trainer, bundle, args, results)
    return trainer


if __name__ == "__main__":
    main()
