"""The training and sampling entry point (ccdm_tpu/main.py:87-393), and the
model construction it shares with serve.py.

    python -m ccdm_tpu_torch.main --data_name synthetic --image_size 64 \
        --model_channels 64 --channel_mult 1_2_2_4_8 --train_amp \
        --pred_objective pred_x0 --vicinity_type hv --train_batch_size 128 \
        --niters 30 --save_every 30

Flow: parse flags -> the setting folder <root_path>/output/<data>_<size>/
<setting_name> and setting_info.txt -> dataset (multi-dim labels from
power_vector and synthetic_power) -> label embeddings (fn_y2h, and fn_y2cov
with --use_Hy; --y2h_embed_type resnet trains the ILI nets on the device
into <setting folder>/embed_models/, or loads them from there; multi-dim
labels combined by --dim_combination) -> the denoiser on the card (--device
cpu for the CPU) -> GaussianDiffusion (with H(y) under --use_Hy, capped by
--hy_max_log) -> with --lambda_aux > 0 the aux regressor --net_aux, trained
into or loaded from <setting folder>/aux_models/ -> Trainer (+ resume from
--resume_niter) -> train, with an EMA sample grid every --sample_every
steps -> a milestone at --niters -> with --gif_trajectory
results/trajectory_niters<N>.gif, with --interpolation
results/interpolation_niters<N>.png -> per eval label (get_eval_labels,
--eval_mode), --nfake_per_label samples from the EMA weights by --sampler
(ddim with --ddim_eta, or ddpm) into the folder
results/fake_data_niters<N>_nfake<M>_<sampler>_sampstep<S>: a 36-image grid
sample_<label>.png and, with --dump_fake_data, <label>.h5 holding
fake_images_i (uint8, gzip 6), fake_labels_i and sample_time_i (for
multi-dim labels sample_<i:05d>.png and label_<i:05d>.h5, i the row's
index). A rerun skips a label whose h5 exists and reads its
sample_time_i (and, for the eval, its fakes). Then --dump_fake_for_NIQE
writes every fake as results/saved_images/fake_images/<i>_<label>.png (or
under --niqe_dump_path) and stops; --comp_FID on scalar labels scores the
fakes with the CCGM protocol (eval/protocol.run_ccgm_eval: the pinned eval
backbones under <eval_ckpt_path>/eval_models/, <setting
folder>/eval_results_niters<N>.txt), and on a multi-dim run prints that the
scalar-label protocol is skipped.
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
    """The denoiser of --architecture (ccdm_tpu/main.py:67-84): the UNet,
    the ViT, or the ADM UNet; weights drawn from --seed."""
    mults = parse_channel_mult(args.channel_mult)
    dtype = torch.bfloat16 if args.train_amp else torch.float32
    if args.architecture == "vit":
        from ccdm_tpu_torch.models.vit import ViT

        return ViT(dim=args.model_channels, dim_mults=mults, in_channels=channels,
                   attn_heads=args.num_heads, dtype=dtype, seed=args.seed)
    if args.architecture == "adm":
        from ccdm_tpu_torch.models.unet_adm import ADMUnet

        return ADMUnet(model_channels=args.model_channels, channel_mult=mults,
                       in_channels=channels, num_res_blocks=args.num_res_blocks,
                       attention_resolutions=parse_channel_mult(args.attention_resolutions),
                       num_heads=args.num_heads, num_groups=args.num_groups, dtype=dtype,
                       seed=args.seed)
    from ccdm_tpu_torch.models.unet import Unet

    return Unet(dim=args.model_channels, dim_mults=mults, in_channels=channels,
                attn_heads=args.num_heads, attn_dim_head=args.attn_dim_head, dtype=dtype,
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
    elif args.data_name == "power_vector":
        kw = {}
        if args.design_folder != "None":
            kw["design_folder"] = args.design_folder
        if args.power_data_path != "None":
            kw["power_path"] = args.power_data_path
        if args.use_power_transformer:
            from ccdm_tpu_torch.data.power import PowerTransformer

            path = kw.get("power_path", os.path.join(args.data_path, "power.csv"))
            kw["power_transformer"] = PowerTransformer().fit(
                np.loadtxt(path, delimiter=",", skiprows=1))
    elif args.data_name == "synthetic_power":
        kw.update(label_dim=args.label_dim, seed=args.seed)
        if args.synthetic_n > 0:
            kw["n"] = args.synthetic_n
    elif args.data_name == "synthetic":
        kw.update(channels=args.num_channels)
        if args.synthetic_n > 0:
            kw["n"] = args.synthetic_n
    return kw


def get_eval_labels(bundle, args) -> np.ndarray:
    """The eval label grid of --eval_mode (ccdm_tpu/main.py:23-51): 1 the
    unique train labels; 2 the unique labels of the full raw set; 3 the
    raw-set labels not in the train subset (all of them if none); 4
    --FID_num_centers points (every raw label if <= 0) evenly over the raw
    set's range. Multi-dim labels: the unique rows [N, D] of the raw set
    (of the train labels at --eval_mode 1, or without a raw set)."""
    if getattr(bundle, "label_dim", 1) > 1:
        rows = bundle.eval_labels_raw if bundle.eval_labels_raw is not None else bundle.labels_raw
        if args.eval_mode == 1:
            rows = bundle.labels_raw
        return np.unique(np.asarray(rows, np.float64), axis=0)
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


def read_sample_dump(path: str, images: bool = False):
    """sample_time_i of an existing dump, with its fake_images_i and
    fake_labels_i when `images`."""
    from ccdm_tpu_torch.data.datasets import import_h5py

    with import_h5py("reading an existing sample dump").File(path, "r") as f:
        sample_time = float(f["sample_time_i"][0])
        if not images:
            return sample_time, None, None
        return sample_time, f["fake_images_i"][:], f["fake_labels_i"][:]


def sample_eval_labels(trainer, bundle, args, fn_y2h):
    """The per-eval-label sampling of ccdm_tpu/main.py:309-366 from the EMA
    weights; a multi-dim label row gets index-keyed files. With --comp_FID
    or --dump_fake_for_NIQE every label's fakes and labels are kept (read
    back from the h5 where it exists): returns (fakes [N, H, W, C] uint8,
    raw labels, total sampling seconds), the first two None otherwise."""
    from ccdm_tpu_torch.training.trainer import sample_given_labels
    from ccdm_tpu_torch.utils.viz import save_image_grid

    eval_labels = get_eval_labels(bundle, args)
    num_eval = len(eval_labels)
    print(f"\n Start sampling {args.nfake_per_label} fakes/label for {num_eval} labels >>>",
          flush=True)
    dump_folder = fake_data_folder(args, num_eval)
    os.makedirs(dump_folder, exist_ok=True)
    diffusion = trainer.ema_diffusion()
    multi_dim = eval_labels.ndim > 1
    keep = args.comp_FID or args.dump_fake_for_NIQE
    total_time = 0.0
    all_fake_images, all_fake_labels = [], []
    for i, curr_label in enumerate(eval_labels):
        fp = os.path.join(dump_folder, f"label_{i:05d}.h5" if multi_dim else f"{curr_label}.h5")
        if os.path.isfile(fp):
            sample_time_i, fake_images_i, fake_labels_i = read_sample_dump(fp, keep)
        else:
            fake_labels_i = (np.tile(curr_label, (args.nfake_per_label, 1)) if multi_dim
                             else curr_label * np.ones(args.nfake_per_label))
            start = timeit.default_timer()
            fake_images_i, _ = sample_given_labels(
                diffusion, bundle.fn_normalize(fake_labels_i), fn_y2h,
                batch_size=args.samp_batch_size, denorm=True, cond_scale=args.sample_cond_scale,
                sample_timesteps=args.sample_timesteps, sampler=args.sampler,
                ddim_eta=args.ddim_eta)
            sample_time_i = timeit.default_timer() - start
            if args.dump_fake_data:
                write_fake_h5(fp, fake_images_i, fake_labels_i, sample_time_i)
            grid_name = f"sample_{i:05d}.png" if multi_dim else f"sample_{curr_label}.png"
            save_image_grid(fake_images_i[:36].astype(np.float32) / 255.0,
                            os.path.join(dump_folder, grid_name), nrow=6)
        total_time += sample_time_i
        if keep:
            all_fake_images.append(fake_images_i)
            all_fake_labels.append(fake_labels_i)
        print(f"\r [{i + 1}/{num_eval}] label {curr_label}: {sample_time_i:.2f}s "
              f"(total {total_time:.2f}s)", flush=True)
    print(f"Sampling finished; Time elapses: {total_time}s", flush=True)
    if not keep:
        return None, None, total_time
    return np.concatenate(all_fake_images, axis=0), np.concatenate(all_fake_labels), total_time


def dump_fake_for_niqe(args, fakes: np.ndarray, flabels: np.ndarray) -> str:
    """Every fake as <niqe dir>/<i>_<label>.png (grayscale 2-D, RGB 3-D),
    the file names of ccdm_tpu/main.py:371-384, for external MATLAB NIQE."""
    from ccdm_tpu_torch.utils.viz import encode_png

    niqe_dir = (args.niqe_dump_path if args.niqe_dump_path != "None"
                else os.path.join(results_folder(args), "saved_images", "fake_images"))
    os.makedirs(niqe_dir, exist_ok=True)
    for i, (img, lab) in enumerate(zip(fakes, flabels)):
        with open(os.path.join(niqe_dir, f"{i}_{lab}.png"), "wb") as f:
            f.write(encode_png(img[..., 0] if img.shape[-1] == 1 else img))
    print(f"NIQE dump complete: {len(fakes)} PNGs -> {niqe_dir}", flush=True)
    return niqe_dir


def save_trajectory_gif(trainer, args, fn_y2h, y_visual: np.ndarray) -> str:
    """The DDIM trajectory (min(--sample_timesteps, 50) steps) of the visual
    label grid from the EMA weights, one GIF frame a step
    (ccdm_tpu/main.py:267-281)."""
    from ccdm_tpu_torch.utils.viz import save_gif

    device = trainer.device
    y = torch.from_numpy(y_visual.reshape(len(y_visual), -1)).to(device)
    frames = trainer.ema_diffusion().ddim_sample(
        fn_y2h(y), cond_scale=args.sample_cond_scale,
        sampling_timesteps=min(args.sample_timesteps, 50), save_intermediate=True,
        generator=torch.Generator(device=device).manual_seed(args.seed), labels=y)
    path = os.path.join(results_folder(args), f"trajectory_niters{args.niters}.gif")
    save_gif(frames.cpu().numpy(), path, nrow=6)
    print(f" trajectory GIF -> {path}", flush=True)
    return path


def save_interpolation(trainer, bundle, args, fn_y2h) -> str:
    """The training images at the 1/4 and 3/4 quantiles of label dim 0,
    blended at 8 values of lambda in [0, 1] at step min(T // 4, 250) and
    denoised at the median label, from the EMA weights, as one grid row
    (ccdm_tpu/main.py:283-305). Every lambda draws the same noise."""
    from ccdm_tpu_torch.ops.image import to_uint8
    from ccdm_tpu_torch.utils.viz import save_image_grid

    device = trainer.device
    labels0 = bundle.labels_norm.reshape(len(bundle.labels_norm), -1)[:, 0]
    order = np.argsort(labels0)
    i0, i1 = order[len(order) // 4], order[3 * len(order) // 4]
    x_pair = torch.from_numpy(bundle.images[[i0, i1]].astype(np.float32) / 255.0 * 2.0 - 1.0)
    y_mid = np.median(labels0)
    emb = fn_y2h(torch.full((1, max(bundle.label_dim, 1)), float(y_mid), device=device))
    diffusion = trainer.ema_diffusion()
    lams = np.linspace(0.0, 1.0, 8)
    rows = []
    for lam in lams:
        img = diffusion.interpolate(
            x_pair[:1].to(device), x_pair[1:].to(device), emb,
            t=min(args.train_timesteps // 4, 250), lam=float(lam),
            generator=torch.Generator(device=device).manual_seed(args.seed))
        rows.append(to_uint8((img + 1.0) / 2.0)[0].cpu().numpy())
    path = os.path.join(results_folder(args), f"interpolation_niters{args.niters}.png")
    save_image_grid(np.stack(rows).astype(np.float32) / 255.0, path, nrow=len(lams))
    print(f" interpolation grid -> {path}", flush=True)
    return path


def build_trainer(args, device, mesh):
    """(trainer, bundle, fn_y2h, y_visual): the data, the label embedding,
    the denoiser and its Trainer on `mesh` (a parallel.Mesh) as main() builds
    them; rank 0 writes the setting's files and caches."""
    from ccdm_tpu_torch.data.datasets import load_dataset
    from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
    from ccdm_tpu_torch.embedding.resolve import build_label_embedding
    from ccdm_tpu_torch.parallel.mesh import main_first
    from ccdm_tpu_torch.training.trainer import Trainer, TrainerConfig

    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    results = results_folder(args)
    setting_folder = os.path.dirname(results)
    os.makedirs(results, exist_ok=True)
    if mesh.is_main:
        with open(os.path.join(setting_folder, "setting_info.txt"), "a") as f:
            f.write("\n" + "=" * 99 + "\n")
            print(args, file=f)

    bundle = load_dataset(args.data_name, args.data_path, **dataset_kwargs(args))
    print(f"\n {args.data_name}: {len(bundle.images)} train images, "
          f"{bundle.image_size}^2 x{bundle.channels}, label_dim={bundle.label_dim}", flush=True)
    if args.vicinity_type in ("shv", "ssv") and args.num_projections <= 0:
        d = bundle.label_dim
        args.num_projections = 10 if d > 20 else 5 if d > 10 else 3 if d > 5 else 1
        print(f"\r Auto-set num_projections={args.num_projections} for label_dim={d}",
              flush=True)

    resolve_label_embed(args)
    with main_first(mesh):  # rank 0 trains and caches the embedding nets, the others load them
        fn_y2h, fn_y2cov = build_label_embedding(args, setting_folder, bundle=bundle,
                                                 device=device)
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
        sample_precast_bf16=args.samp_precast_bf16, log_every=args.log_every,
        tb_log=args.tb_log, seed=args.seed)
    aux_info = None
    if args.lambda_aux > 0:  # the elastic aux loss: train or load the regressor
        from ccdm_tpu_torch.training.train_aux import get_aux_net

        with main_first(mesh):
            aux_apply = get_aux_net(bundle, setting_folder, name=args.net_aux,
                                    epochs=args.epoch_aux, batch_size=args.batch_size_aux,
                                    seed=args.seed, device=device)
        aux_info = {"apply": aux_apply, "lambda_aux": args.lambda_aux,
                    "aux_start_step": args.aux_start_step}
    trainer = Trainer(diffusion, bundle.images, bundle.labels_norm, tcfg, aux_info=aux_info,
                      mesh=mesh)
    print(f" sigma_delta={trainer.sigma_delta}, kappa={trainer.kappa}", flush=True)
    return trainer, bundle, fn_y2h, y_visual


def main(argv=None):
    from ccdm_tpu_torch.opts import parse_opts
    from ccdm_tpu_torch.parallel.mesh import bootstrap
    from ccdm_tpu_torch.utils.ckpt import checkpoint_exists
    from ccdm_tpu_torch.utils.device import resolve_device

    args = parse_opts(argv)
    mesh = bootstrap(args.device)  # before any device query
    device = resolve_device(args.device)
    trainer, bundle, fn_y2h, y_visual = build_trainer(args, device, mesh)
    results = results_folder(args)
    setting_folder = os.path.dirname(results)
    if args.resume_niter > 0 and checkpoint_exists(results, args.resume_niter):
        trainer.load(args.resume_niter)
        print(f" resumed from milestone {args.resume_niter}", flush=True)
    trainer.train(fn_y2h)
    trainer.save(args.niters)
    if not mesh.is_main:  # rank 0 samples, evaluates and writes the artifacts
        return trainer
    if args.gif_trajectory:
        save_trajectory_gif(trainer, args, fn_y2h, y_visual)
    if args.interpolation:
        save_interpolation(trainer, bundle, args, fn_y2h)
    fakes, flabels, total_time = sample_eval_labels(trainer, bundle, args, fn_y2h)
    if args.dump_fake_for_NIQE:
        dump_fake_for_niqe(args, fakes, flabels)
        return trainer
    if args.comp_FID and bundle.label_dim > 1:
        # the sliding window slides over a 1-D label range
        print(" comp_FID skipped: the SFID/LS sliding-window protocol is scalar-label; "
              "multi-dim runs produce sample dumps only.", flush=True)
    elif args.comp_FID:
        from ccdm_tpu_torch.eval.protocol import run_ccgm_eval

        trainer.eval_results = run_ccgm_eval(args, bundle, fakes, flabels, setting_folder,
                                             total_time)
    return trainer


if __name__ == "__main__":
    main()
