"""The training and sampling entry point (ccdm_tpu/main.py:87-370), and the
model construction it shares with serve.py.

    python -m ccdm_tpu_torch.main --data_name synthetic --image_size 64 \
        --model_channels 64 --channel_mult 1_2_2_4_8 --train_amp \
        --pred_objective pred_x0 --vicinity_type hv --train_batch_size 128 \
        --niters 30 --save_every 30

Flow: parse flags -> the setting folder <root_path>/output/<data>_<size>/
<setting_name> and setting_info.txt -> dataset -> label embeddings
(fn_y2h, and fn_y2cov with --use_Hy; --y2h_embed_type resnet trains the ILI
nets on the device into <setting folder>/embed_models/, or loads them from
there) -> the denoiser on the card (--device cpu for the CPU) ->
GaussianDiffusion (with H(y) under --use_Hy, capped by --hy_max_log) ->
Trainer (+ resume from --resume_niter) -> train, with an EMA sample grid
every --sample_every steps -> a milestone at --niters -> per eval label
(get_eval_labels, --eval_mode), --nfake_per_label samples from the EMA
weights by --sampler (ddim with --ddim_eta, or ddpm) into the folder
results/fake_data_niters<N>_nfake<M>_<sampler>_sampstep<S>: a 36-image grid
sample_<label>.png and, with --dump_fake_data, <label>.h5 holding
fake_images_i (uint8, gzip 6), fake_labels_i and sample_time_i. A rerun
skips a label whose h5 exists and reads its sample_time_i. Multi-dim
labels, --lambda_aux, --gif_trajectory, --interpolation, --comp_FID and
--dump_fake_for_NIQE come in later slices (ROADMAP.md).
"""

from __future__ import annotations

import os
import timeit

import numpy as np
import torch

from ccdm_tpu_torch.opts import parse_channel_mult


def resolve_label_embed(args) -> None:
    """--label_embed picks the embedding family: random -> Gaussian-Fourier
    y2h; --use_Hy needs ccdm2. Mutates args in place."""
    if args.label_embed == "random":
        args.y2h_embed_type = "gaussian"
    if args.use_Hy and args.label_embed != "ccdm2":
        raise SystemExit(f"--use_Hy needs the y2cov pipeline: --label_embed ccdm2 "
                         f"(got {args.label_embed})")


def build_model(args, image_size: int, channels: int):
    """The denoiser of --architecture, weights drawn from --seed."""
    from ccdm_tpu_torch.models.unet import Unet

    if args.architecture != "unet":
        raise NotImplementedError(f"--architecture {args.architecture} comes in a "
                                  "later slice (ROADMAP.md)")
    return Unet(dim=args.model_channels, dim_mults=parse_channel_mult(args.channel_mult),
                in_channels=channels, attn_heads=args.num_heads,
                attn_dim_head=args.attn_dim_head,
                dtype=torch.bfloat16 if args.train_amp else torch.float32,
                seed=args.seed)


def results_folder(args) -> str:
    """<root_path>/output/<data_name>_<image_size>/<setting_name>/results."""
    return os.path.join(args.root_path, "output", f"{args.data_name}_{args.image_size}",
                        args.setting_name, "results")


def dataset_kwargs(args) -> dict:
    """The loader arguments of --data_name (ccdm_tpu/main.py:115-152)."""
    kw = dict(image_size=args.image_size)
    if args.data_name == "RC-49":
        kw.update(min_label=args.min_label, max_label=args.max_label,
                  max_num_img_per_label=args.max_num_img_per_label, data_split=args.data_split)
    elif args.data_name == "UTKFace":
        kw.update(min_label=args.min_label, max_label=args.max_label,
                  max_num_img_per_label=args.max_num_img_per_label,
                  num_img_per_label_after_replica=args.num_img_per_label_after_replica)
    elif args.data_name == "SteeringAngle":
        kw.update(min_label=args.min_label, max_label=args.max_label,
                  max_num_img_per_label=args.max_num_img_per_label)
    elif args.data_name == "Cell200":
        kw.update(min_label=args.min_label, max_label=args.max_label, stepsize=args.stepsize,
                  num_imgs_per_label=args.num_imgs_per_label)
    elif args.data_name == "synthetic":
        kw.update(channels=args.num_channels)
        if args.synthetic_n > 0:
            kw["n"] = args.synthetic_n
    return kw


def get_eval_labels(bundle, args) -> np.ndarray:
    """The eval label grid of --eval_mode (ccdm_tpu/main.py:23-51, scalar
    labels): 1 the unique train labels; 2 the unique labels of the full raw
    set; 3 the raw-set labels not in the train subset (all of them if none);
    4 --FID_num_centers points (every raw label if <= 0) evenly over the
    raw set's range."""
    train_unique = np.sort(np.unique(bundle.labels_raw))
    if args.eval_mode == 1:
        return train_unique
    all_unique = (np.sort(np.unique(bundle.eval_labels_raw))
                  if bundle.eval_labels_raw is not None else train_unique)
    if args.eval_mode == 2:
        return all_unique
    if args.eval_mode == 3:
        unseen = np.setdiff1d(all_unique, train_unique)
        return unseen if len(unseen) else all_unique
    num = args.FID_num_centers if args.FID_num_centers > 0 else len(all_unique)
    return np.linspace(all_unique.min(), all_unique.max(), num)


def fake_data_folder(args, num_eval: int) -> str:
    return os.path.join(results_folder(args),
                        f"fake_data_niters{args.niters}_nfake{int(args.nfake_per_label * num_eval)}"
                        f"_{args.sampler}_sampstep{args.sample_timesteps}")


def write_fake_h5(path: str, images: np.ndarray, labels: np.ndarray, sample_time: float) -> None:
    """One label's dump, as the JAX entry writes it (main.py:339-343)."""
    from ccdm_tpu_torch.data.datasets import import_h5py

    with import_h5py("--dump_fake_data").File(path, "w") as f:
        f.create_dataset("fake_images_i", data=images, dtype="uint8", compression="gzip",
                         compression_opts=6)
        f.create_dataset("fake_labels_i", data=labels, dtype="float")
        f.create_dataset("sample_time_i", data=np.array([sample_time]), dtype="float")


def read_sample_time(path: str) -> float:
    from ccdm_tpu_torch.data.datasets import import_h5py

    with import_h5py("reading an existing sample dump").File(path, "r") as f:
        return float(f["sample_time_i"][0])


def sample_eval_labels(trainer, bundle, args, fn_y2h) -> None:
    """The per-eval-label sampling of ccdm_tpu/main.py:309-360 from the EMA
    weights."""
    from ccdm_tpu_torch.training.trainer import sample_given_labels
    from ccdm_tpu_torch.utils.viz import save_image_grid

    eval_labels = get_eval_labels(bundle, args)
    num_eval = len(eval_labels)
    print(f"\n Start sampling {args.nfake_per_label} fakes/label for {num_eval} labels >>>",
          flush=True)
    dump_folder = fake_data_folder(args, num_eval)
    os.makedirs(dump_folder, exist_ok=True)
    diffusion = trainer.ema_diffusion()
    total_time = 0.0
    for i, curr_label in enumerate(eval_labels):
        fp = os.path.join(dump_folder, f"{curr_label}.h5")
        if os.path.isfile(fp):
            sample_time_i = read_sample_time(fp)
        else:
            fake_labels_i = curr_label * np.ones(args.nfake_per_label)
            start = timeit.default_timer()
            fake_images_i, _ = sample_given_labels(
                diffusion, bundle.fn_normalize(fake_labels_i), fn_y2h,
                batch_size=args.samp_batch_size, denorm=True, cond_scale=args.sample_cond_scale,
                sample_timesteps=args.sample_timesteps, sampler=args.sampler,
                ddim_eta=args.ddim_eta)
            sample_time_i = timeit.default_timer() - start
            if args.dump_fake_data:
                write_fake_h5(fp, fake_images_i, fake_labels_i, sample_time_i)
            save_image_grid(fake_images_i[:36].astype(np.float32) / 255.0,
                            os.path.join(dump_folder, f"sample_{curr_label}.png"), nrow=6)
        total_time += sample_time_i
        print(f"\r [{i + 1}/{num_eval}] label {curr_label}: {sample_time_i:.2f}s "
              f"(total {total_time:.2f}s)", flush=True)
    print(f"Sampling finished; Time elapses: {total_time}s", flush=True)


def main(argv=None):
    from ccdm_tpu_torch.data.datasets import load_dataset
    from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
    from ccdm_tpu_torch.embedding.resolve import build_label_embedding
    from ccdm_tpu_torch.opts import parse_opts
    from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig
    from ccdm_tpu_torch.utils.ckpt import checkpoint_exists
    from ccdm_tpu_torch.utils.device import resolve_device

    args = parse_opts(argv)
    for flag, on in (("--lambda_aux", args.lambda_aux > 0),
                     ("--gif_trajectory", args.gif_trajectory),
                     ("--interpolation", args.interpolation), ("--comp_FID", args.comp_FID),
                     ("--dump_fake_for_NIQE", args.dump_fake_for_NIQE)):
        if on:
            raise NotImplementedError(f"{flag} comes in a later slice (ROADMAP.md)")
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    results = results_folder(args)
    setting_folder = os.path.dirname(results)
    os.makedirs(results, exist_ok=True)
    with open(os.path.join(setting_folder, "setting_info.txt"), "a") as f:
        f.write("\n" + "=" * 99 + "\n")
        print(args, file=f)

    bundle = load_dataset(args.data_name, args.data_path, **dataset_kwargs(args))
    print(f"\n {args.data_name}: {len(bundle.images)} train images, "
          f"{bundle.image_size}^2 x{bundle.channels}, label_dim={bundle.label_dim}", flush=True)
    if args.vicinity_type in ("shv", "ssv") and args.num_projections <= 0:
        d = bundle.label_dim
        args.num_projections = 10 if d > 20 else 5 if d > 10 else 3 if d > 5 else 1

    resolve_label_embed(args)
    fn_y2h, fn_y2cov = build_label_embedding(args, setting_folder, bundle=bundle, device=device)
    model = build_model(args, bundle.image_size, bundle.channels).to(
        device, memory_format=torch.channels_last)
    n_params = sum(p.numel() for p in model.parameters())
    print(f" model params: {n_params / 1e6:.2f}M", flush=True)
    dcfg = DiffusionConfig(
        image_size=bundle.image_size, channels=bundle.channels,
        timesteps=args.train_timesteps, sampling_timesteps=args.sample_timesteps,
        objective=args.pred_objective, beta_schedule=args.beta_schedule,
        ddim_sampling_eta=args.ddim_eta, cond_drop_prob=args.cond_drop_prob, use_Hy=args.use_Hy,
        hy_max_log=args.hy_max_log, vicinity_type=args.vicinity_type, distance=args.distance,
        vector_type=args.vector_type, num_projections=args.num_projections)
    diffusion = GaussianDiffusion(model, dcfg, device=device, fn_y2cov=fn_y2cov)
    # the grid's labels: 6 quantiles of the unique labels, 6 of each (main.py:203-205)
    uniq = np.sort(np.unique(bundle.labels_norm.reshape(len(bundle.labels_norm), -1)[:, 0]))
    y_visual = np.repeat(np.quantile(uniq, np.linspace(0.05, 0.95, 6)), 6).astype(np.float32)
    tcfg = TrainerConfig(
        data_name=bundle.name, train_batch_size=args.train_batch_size,
        gradient_accumulate_every=args.gradient_accumulate_every, train_lr=args.train_lr,
        train_num_steps=args.niters, sample_every=args.sample_every,
        save_every=args.save_every, results_folder=results,
        vicinity_type=args.vicinity_type, kappa=args.kappa, kernel_sigma=args.kernel_sigma,
        nonzero_soft_weight_threshold=args.nonzero_soft_weight_threshold,
        vector_type=args.vector_type, num_projections=args.num_projections,
        distance=args.distance, hyperparameter=args.hyperparameter,
        percentile=args.percentile, adaptive_slicing=args.adaptive_slicing,
        y_visual=y_visual, cond_scale_visual=args.sample_cond_scale,
        sample_timesteps_visual=min(args.sample_timesteps, 250),
        sample_precast_bf16=args.samp_precast_bf16, log_every=args.log_every, seed=args.seed)
    trainer = Trainer(diffusion, bundle.images, bundle.labels_norm, tcfg)
    print(f" sigma_delta={trainer.sigma_delta}, kappa={trainer.kappa}", flush=True)

    if args.resume_niter > 0 and checkpoint_exists(results, args.resume_niter):
        trainer.load(args.resume_niter)
        print(f" resumed from milestone {args.resume_niter}", flush=True)
    trainer.train(fn_y2h)
    trainer.save(args.niters)
    sample_eval_labels(trainer, bundle, args, fn_y2h)
    return trainer


if __name__ == "__main__":
    main()
