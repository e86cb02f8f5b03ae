"""The class-conditional baselines' entry point (ccdm_tpu/classgan_main.py).

    python -m ccdm_tpu_torch.classgan_main --method studiogan --cond_loss d2dce ...
    python -m ccdm_tpu_torch.classgan_main --method cfg --sample_cond_scale 1.5 ...
    python -m ccdm_tpu_torch.classgan_main --method admg --classifier_scale 1.0 ...

Flow: parse flags (JAX's names, defaults and choices, plus --device) ->
the dataset -> its raw labels binned into --num_classes equal-frequency
classes (eval/train_backbones.bin_labels_to_classes), each class's mean raw
label the label its fakes carry -> by --method:
- studiogan: SNGAN G and D on one-hot classes, ClassGANTrainer with the
  D2D-CE or ADC head (training/classgan.py), then --nfake_per_class
  eval-mode images of every class;
- cfg and admg: a class-conditional Unet trained by the diffusion Trainer
  with the vicinity off, its label embedding the row of a fixed class table
  (diffusion/guided.class_table, kept in the results folder) of the class
  that torch.searchsorted finds for a normalised label among the
  normalised class uppers; cfg samples the EMA weights by DDIM at
  --sample_cond_scale; admg trains (or loads) the timestep-aware
  NoisyClassifier under <results>/model-noisycls_<name>_<size>_c<C>_e<E>_seed<S>/
  and samples the EMA weights by classifier-guided ancestral sampling over
  the first min(--sample_timesteps, --train_timesteps) steps of the
  schedule, in batches of --samp_batch_size;
-> <setting>/<method>_results/: with --dump_fake_data
fake_data_<method>_niters<N>_nfake<M>.h5 (fake_images uint8 gzip 6,
fake_labels), always the grid sample_<method>.png of the first 36 fakes ->
--comp_FID: the CCGM protocol (eval/protocol.run_ccgm_eval). The parser has
no --FID_radius or --FID_num_centers, which the protocol reads (JAX's entry
raises AttributeError there); the port takes main.py's defaults, 0 and -1.
It runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import timeit

import numpy as np
import torch

# the eval protocol's flags that this parser lacks, at main.py's defaults
EVAL_DEFAULTS = {"FID_radius": 0.0, "FID_num_centers": -1}
GUIDED_SEED_OFFSET = 77  # admg's noise: fold_in(PRNGKey(seed + 77), s) in JAX


def parse_opts_classgan(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--root_path", type=str, default="./")
    p.add_argument("--data_name", type=str, default="synthetic")
    p.add_argument("--data_path", type=str, default="./datasets")
    p.add_argument("--setting_name", type=str, default="Setup_ClassCond")
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--method", type=str, default="studiogan",
                   choices=["studiogan", "admg", "cfg"])
    # dataset
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--num_channels", type=int, default=3)
    p.add_argument("--min_label", type=float, default=0.0)
    p.add_argument("--max_label", type=float, default=90.0)
    p.add_argument("--num_classes", type=int, default=10,
                   help="equal-frequency label bins (StudioGAN class ids)")
    # GAN (studiogan)
    p.add_argument("--cond_loss", type=str, default="d2dce", choices=["d2dce", "adc", "none"])
    p.add_argument("--lambda_cond", type=float, default=1.0)
    p.add_argument("--gene_ch", type=int, default=64)
    p.add_argument("--disc_ch", type=int, default=64)
    p.add_argument("--dim_z", type=int, default=128)
    p.add_argument("--niters", type=int, default=10000)
    p.add_argument("--train_batch_size", type=int, default=64)
    p.add_argument("--num_D_steps", type=int, default=1)
    p.add_argument("--lr_g", type=float, default=1e-4)
    p.add_argument("--lr_d", type=float, default=1e-4)
    p.add_argument("--gan_DiffAugment", action="store_true", default=False)
    p.add_argument("--visualize_freq", type=int, default=2000)
    p.add_argument("--save_niters_freq", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=20)
    # diffusion (admg / cfg)
    p.add_argument("--model_channels", type=int, default=32)
    p.add_argument("--channel_mult", type=str, default="1_2_2_4")
    p.add_argument("--train_timesteps", type=int, default=1000)
    p.add_argument("--train_lr", type=float, default=1e-4)
    p.add_argument("--cond_drop_prob", type=float, default=0.1)
    p.add_argument("--pred_objective", type=str, default="pred_x0")
    p.add_argument("--classifier_epochs", type=int, default=20)
    p.add_argument("--classifier_scale", type=float, default=1.0,
                   help="ADM-G guidance scale s (classifier_sample.py)")
    p.add_argument("--sample_timesteps", type=int, default=250)
    p.add_argument("--sample_cond_scale", type=float, default=1.5,
                   help="CFG guidance scale (cfg method)")
    # sampling + eval
    p.add_argument("--nfake_per_class", type=int, default=50)
    p.add_argument("--samp_batch_size", type=int, default=50)
    p.add_argument("--dump_fake_data", action="store_true", default=False)
    p.add_argument("--comp_FID", action="store_true", default=False)
    p.add_argument("--eval_mode", type=int, default=2)
    p.add_argument("--epochs_eval_ae", type=int, default=10)
    p.add_argument("--epochs_eval_cnn", type=int, default=20)
    p.add_argument("--eval_ckpt_path", type=str, default="./")
    return p.parse_args(argv)


def _class_centers(labels_raw: np.ndarray, classes: np.ndarray,
                   num_classes: int) -> np.ndarray:
    """The mean raw label of each class (the label its fakes carry into
    the eval protocol), the mean of all labels for an empty class."""
    return np.array([labels_raw[classes == c].mean() if np.any(classes == c)
                     else labels_raw.mean() for c in range(num_classes)], np.float32)


def class_uppers_norm(bundle, num_classes: int) -> np.ndarray:
    """The normalised upper label of each class but the last (f32), as
    bin_labels_to_classes chunks the sorted unique raw labels."""
    chunks = np.array_split(np.sort(np.unique(bundle.labels_raw)), num_classes)
    uppers_raw = np.array([c[-1] for c in chunks[:-1] if len(c)], np.float32)
    return np.asarray(bundle.fn_normalize(uppers_raw), np.float32).reshape(-1)


def make_fn_y2h_classes(uppers_norm: np.ndarray, table, device):
    """Normalised labels [B] or [B, 1] -> the class table's rows of the
    classes searchsorted(uppers, y, side="left") gives."""
    from ccdm_tpu_torch.diffusion.guided import make_fn_class_embed

    uppers = torch.from_numpy(np.ascontiguousarray(uppers_norm, np.float32)).to(device)
    table_fn = make_fn_class_embed(table, device)

    def fn_y2h(y: torch.Tensor) -> torch.Tensor:
        y1 = torch.as_tensor(y, dtype=torch.float32, device=device).reshape(-1)
        return table_fn(torch.searchsorted(uppers, y1, right=False))

    return fn_y2h


def _dump_and_maybe_eval(args, bundle, fakes, flabels, setting_folder, results_folder,
                         total_time: float = 0.0):
    from ccdm_tpu_torch.utils.viz import save_image_grid

    if args.dump_fake_data:
        fp = os.path.join(results_folder,
                          f"fake_data_{args.method}_niters{args.niters}_nfake{len(fakes)}.h5")
        write_fake_h5(fp, fakes, flabels)
        print(f" dumped {fp}", flush=True)
    save_image_grid(fakes[:36].astype(np.float32) / 255.0,
                    os.path.join(results_folder, f"sample_{args.method}.png"), nrow=6)
    if args.comp_FID:
        from ccdm_tpu_torch.eval.protocol import run_ccgm_eval

        eval_args = argparse.Namespace(**{**EVAL_DEFAULTS, **vars(args)})
        return run_ccgm_eval(eval_args, bundle, fakes, flabels.astype(np.float32),
                             setting_folder, total_time=total_time)
    return None


def write_fake_h5(path: str, fakes: np.ndarray, flabels: np.ndarray) -> None:
    """The method's one dump, as the JAX entry writes it."""
    from ccdm_tpu_torch.data.datasets import import_h5py

    with import_h5py("--dump_fake_data").File(path, "w") as f:
        f.create_dataset("fake_images", data=fakes, dtype="uint8", compression="gzip",
                         compression_opts=6)
        f.create_dataset("fake_labels", data=flabels)


def _train_class_diffusion(args, bundle, results_folder, device, mesh):
    """(trainer, fn_y2h): a class-conditional Unet trained by the stock
    Trainer with the vicinity off, its label embedding the class table's
    row of each normalised label's class (the ADM and CFG semantics)."""
    from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
    from ccdm_tpu_torch.diffusion.guided import CLASS_EMBED_DIM, class_table
    from ccdm_tpu_torch.models.unet import Unet
    from ccdm_tpu_torch.opts import parse_channel_mult
    from ccdm_tpu_torch.parallel.mesh import main_first
    from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig

    with main_first(mesh):  # rank 0 draws and writes the table, the others read it
        table = class_table(results_folder, args.num_classes, CLASS_EMBED_DIM, args.seed)
    fn_y2h = make_fn_y2h_classes(class_uppers_norm(bundle, args.num_classes), table, device)
    model = Unet(dim=args.model_channels, dim_mults=parse_channel_mult(args.channel_mult),
                 in_channels=bundle.channels, seed=args.seed).to(
        device, memory_format=torch.channels_last)
    dcfg = DiffusionConfig(image_size=bundle.image_size, channels=bundle.channels,
                           timesteps=args.train_timesteps,
                           sampling_timesteps=args.sample_timesteps,
                           objective=args.pred_objective, cond_drop_prob=args.cond_drop_prob,
                           vicinity_type="none")
    diffusion = GaussianDiffusion(model, dcfg, device=device)
    tcfg = TrainerConfig(data_name=bundle.name, train_batch_size=args.train_batch_size,
                         train_lr=args.train_lr, train_num_steps=args.niters,
                         results_folder=results_folder, vicinity_type="none",
                         sample_every=10 ** 9, save_every=max(args.niters, 1),
                         log_every=args.log_every, seed=args.seed)
    trainer = Trainer(diffusion, bundle.images, bundle.labels_norm, tcfg, mesh=mesh)
    trainer.train(fn_y2h)
    return trainer, fn_y2h


def noisy_classifier(args, bundle, classes, results_folder, device):
    """The cached NoisyClassifier of this data, size, class count, epochs
    and seed, or one trained now and cached (eval mode, no gradients to
    its weights)."""
    from ccdm_tpu_torch.eval.backbones import NoisyClassifier
    from ccdm_tpu_torch.eval.train_backbones import train_noisy_classifier
    from ccdm_tpu_torch.utils.ckpt import checkpoint_exists, load_checkpoint, save_checkpoint

    tag = (f"noisycls_{bundle.name}_{args.image_size}_c{args.num_classes}"
           f"_e{args.classifier_epochs}_seed{args.seed}")
    if checkpoint_exists(results_folder, tag):
        net = NoisyClassifier(args.num_classes, in_channels=bundle.channels)
        net.load_state_dict(load_checkpoint(results_folder, tag))
        net = net.to(device)
        print(f" noisy classifier: loaded cached '{tag}'", flush=True)
    else:
        net = train_noisy_classifier(bundle.images, classes, args.num_classes,
                                     timesteps=args.train_timesteps,
                                     epochs=args.classifier_epochs, seed=args.seed,
                                     device=device)
        save_checkpoint(results_folder, tag,
                        {k: v.detach().cpu() for k, v in net.state_dict().items()})
    return net.eval().requires_grad_(False)


def sample_admg(args, trainer, fn_y2h, classifier, fake_classes, flabels_norm, device):
    """Classifier-guided samples of the EMA weights, uint8 [n, H, W, C], in
    batches of --samp_batch_size (the last one short); batch s draws its
    noise from a generator seeded from (seed + 77, s)."""
    from ccdm_tpu_torch.diffusion.guided import classifier_grad_fn, classifier_guided_sample
    from ccdm_tpu_torch.training.trainer import chunk_seed

    cond_fn = classifier_grad_fn(classifier, takes_t=True)
    diffusion = trainer.ema_diffusion()
    steps = min(args.sample_timesteps, args.train_timesteps)
    bs = args.samp_batch_size
    outs = []
    for s in range(0, len(fake_classes), bs):
        classes = torch.from_numpy(fake_classes[s:s + bs]).to(device)
        emb = fn_y2h(torch.from_numpy(flabels_norm[s:s + bs]).to(device))
        gen = torch.Generator(device=device).manual_seed(
            chunk_seed(args.seed + GUIDED_SEED_OFFSET, s))
        img01 = classifier_guided_sample(diffusion, emb, classes, cond_fn,
                                         guidance_scale=args.classifier_scale,
                                         sampling_timesteps=steps, generator=gen)
        outs.append((torch.clamp(img01, 0, 1) * 255.0).cpu().numpy())
    return np.concatenate(outs).astype(np.uint8)


def main(argv=None) -> dict:
    """Returns {"trainer", "fakes", "flabels", "eval_results"} (and
    "classifier" for admg)."""
    from ccdm_tpu_torch.data.datasets import load_dataset
    from ccdm_tpu_torch.eval.train_backbones import bin_labels_to_classes
    from ccdm_tpu_torch.parallel.mesh import bootstrap
    from ccdm_tpu_torch.utils.device import resolve_device

    args = parse_opts_classgan(argv)
    # the process group, then the mesh both trainers share (JAX's classgan_main.py:189, 208)
    mesh = bootstrap(args.device)
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    setting_folder = os.path.join(args.root_path, "output",
                                  f"{args.data_name}_{args.image_size}", args.setting_name)
    results_folder = os.path.join(setting_folder, f"{args.method}_results")
    os.makedirs(results_folder, exist_ok=True)

    ds_kwargs = dict(image_size=args.image_size)
    if args.data_name == "synthetic":
        ds_kwargs.update(channels=args.num_channels)
    else:
        ds_kwargs.update(min_label=args.min_label, max_label=args.max_label)
    bundle = load_dataset(args.data_name, args.data_path, **ds_kwargs)
    classes = bin_labels_to_classes(bundle.labels_raw, args.num_classes)
    centers = _class_centers(np.asarray(bundle.labels_raw, np.float32), classes,
                             args.num_classes)
    fake_classes = np.repeat(np.arange(args.num_classes), args.nfake_per_class)
    flabels = centers[fake_classes]
    out = {"flabels": flabels}

    t0 = timeit.default_timer()
    if args.method == "studiogan":
        from ccdm_tpu_torch.models.sngan import SNGANDiscriminator, SNGANGenerator
        from ccdm_tpu_torch.training.classgan import ClassGANConfig, ClassGANTrainer

        netG = SNGANGenerator(dim_embed=args.num_classes, dim_z=args.dim_z,
                              nc=bundle.channels, img_size=args.image_size,
                              gene_ch=args.gene_ch, seed=args.seed).to(device)
        netD = SNGANDiscriminator(dim_embed=args.num_classes, nc=bundle.channels,
                                  img_size=args.image_size, disc_ch=args.disc_ch,
                                  seed=args.seed).to(device)
        cfg = ClassGANConfig(
            num_classes=args.num_classes, niters=args.niters, batch_size=args.train_batch_size,
            num_D_steps=args.num_D_steps, lr_g=args.lr_g, lr_d=args.lr_d, dim_z=args.dim_z,
            cond_loss=args.cond_loss, lambda_cond=args.lambda_cond,
            use_DiffAugment=args.gan_DiffAugment, save_niters_freq=args.save_niters_freq,
            visualize_freq=args.visualize_freq, results_folder=results_folder,
            log_every=args.log_every, seed=args.seed)
        trainer = ClassGANTrainer(netG, netD, bundle.images, classes, cfg, device=device,
                                  mesh=mesh)
        trainer.train()
        if not mesh.is_main:  # rank 0 samples, evaluates and writes the artifacts
            return {**out, "trainer": trainer}
        fakes = trainer.sample_given_classes(fake_classes, batch_size=args.samp_batch_size)
    else:
        trainer, fn_y2h = _train_class_diffusion(args, bundle, results_folder, device, mesh)
        if not mesh.is_main:
            return {**out, "trainer": trainer}
        flabels_norm = np.asarray(bundle.fn_normalize(flabels), np.float32)
        if args.method == "cfg":
            from ccdm_tpu_torch.training.trainer import sample_given_labels

            fakes, _ = sample_given_labels(
                trainer.ema_diffusion(), flabels_norm, fn_y2h,
                batch_size=args.samp_batch_size, denorm=True, sampler="ddim",
                cond_scale=args.sample_cond_scale, sample_timesteps=args.sample_timesteps)
        else:
            out["classifier"] = noisy_classifier(args, bundle, classes, results_folder, device)
            fakes = sample_admg(args, trainer, fn_y2h, out["classifier"], fake_classes,
                                flabels_norm, device)

    total_time = timeit.default_timer() - t0
    print(f" {args.method}: sampled {fakes.shape} in {total_time:.1f}s (incl. train)",
          flush=True)
    out.update(trainer=trainer, fakes=fakes)
    out["eval_results"] = _dump_and_maybe_eval(args, bundle, fakes, flabels, setting_folder,
                                               results_folder, total_time=total_time)
    print(f"{args.method} run complete", flush=True)
    return out


if __name__ == "__main__":
    main()
