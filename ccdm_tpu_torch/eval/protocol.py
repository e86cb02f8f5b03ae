"""The full CCGM evaluation protocol as one pass (counterpart of
ccdm_tpu/eval/protocol.py; the reference's eval block, vanilla
`CCDM_vanilla/.../main.py:413-643`): sliding-window SFID/LS/Diversity over
label centers, overall FID and LS, and the StudioGAN extras (PRDC at equal
N with a split-half control, intra-class FID, kNN/FFT/t-SNE analyses, the
classification accuracy score) and native NIQE (eval/niqe.py).

Every method scores its fakes through it, against the same pinned
backbones (eval/train_backbones.py, fingerprinted), which is what makes
teacher and student numbers comparable. The nets run on --device; the
metrics' algebra on the host. Flags a caller's parser lacks are read with
inert defaults.
"""

from __future__ import annotations

import os

import numpy as np


def run_ccgm_eval(args, bundle, fakes: np.ndarray, flabels: np.ndarray,
                  setting_folder: str, total_time: float = 0.0) -> dict:
    """Score `fakes` (uint8 [N, H, W, C]) with raw labels `flabels` against
    the bundle's real set; appends to eval_results_niters{N}.txt and writes
    the per-center npz under `setting_folder`; returns the metric dict."""
    from ccdm_tpu_torch.eval.metrics import (
        cal_FID, cal_labelscore, compute_prdc, extract_features, frechet_distance,
        inception_score, intra_class_fid)
    from ccdm_tpu_torch.eval.sfid import sliding_window_eval
    from ccdm_tpu_torch.eval.train_backbones import get_eval_models
    from ccdm_tpu_torch.utils.device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    eval_mode = getattr(args, "eval_mode", 2)
    real_images = (bundle.eval_images
                   if (eval_mode in (2, 4) and bundle.eval_images is not None)
                   else bundle.images)
    real_labels = (bundle.eval_labels_raw
                   if (eval_mode in (2, 4) and bundle.eval_labels_raw is not None)
                   else bundle.labels_raw)

    num_classes = min(49, len(np.unique(real_labels)))
    nets = get_eval_models(bundle, os.path.join(args.eval_ckpt_path, "eval_models"),
                           num_classes, epochs_ae=args.epochs_eval_ae,
                           epochs_cnn=args.epochs_eval_cnn, seed=args.seed, device=device)
    fid_net, ls_net, div_net = nets["fid"], nets["ls"], nets["div"]

    # FID-net features of the full real and fake sets serve the sliding
    # window, FID, kNN, t-SNE, PRDC and intra-FID: extracted once each
    _feat_cache: dict = {}

    def fid_features(name, imgs):
        if name not in _feat_cache:
            _feat_cache[name] = extract_features(fid_net, imgs)
        return _feat_cache[name]

    knn_analysis = getattr(args, "knn_analysis", False)
    frequency_analysis = getattr(args, "frequency_analysis", False)
    tsne_analysis = getattr(args, "tsne_analysis", False)
    if knn_analysis or frequency_analysis or tsne_analysis:
        from ccdm_tpu_torch.eval import analysis
        from ccdm_tpu_torch.utils.viz import save_image_grid

        fig_dir = os.path.join(setting_folder, "analysis")
        os.makedirs(fig_dir, exist_ok=True)
        embed = lambda x: extract_features(fid_net, x)
        if knn_analysis:
            grid = analysis.k_nearest_neighbors(
                fakes, real_images, k=7, anchors=8, embed_fn=embed,
                real_features=fid_features("real", real_images))
            a, kp1 = grid.shape[:2]
            save_image_grid(grid.reshape(a * kp1, *grid.shape[2:]) / 255.0,
                            os.path.join(fig_dir, "knn_grid.png"), nrow=kp1)
            print(f" kNN analysis -> {fig_dir}/knn_grid.png")
        if frequency_analysis:
            rs, fs = analysis.frequency_spectrum(real_images[:256], fakes[:256])
            np.savez(os.path.join(fig_dir, "frequency_spectrum.npz"),
                     real_spectrum=rs, fake_spectrum=fs)
            lo, hi = min(rs.min(), fs.min()), max(rs.max(), fs.max())
            pair = (np.stack([rs, fs])[..., None] - lo) / max(hi - lo, 1e-9)
            save_image_grid(pair, os.path.join(fig_dir, "frequency_spectrum.png"), nrow=2)
            print(f" frequency analysis -> {fig_dir}/frequency_spectrum.*")
        if tsne_analysis:
            nsub = min(len(real_images), len(fakes), 1000)
            r2, f2 = analysis.tsne_embeds(
                fid_features("real", real_images)[:nsub],
                fid_features("fake", fakes)[:nsub])
            np.savez(os.path.join(fig_dir, "tsne.npz"), real_2d=r2, fake_2d=f2)
            print(f" t-SNE analysis -> {fig_dir}/tsne.npz")

    if getattr(args, "GAN_train", False) or getattr(args, "GAN_test", False):
        # Classification Accuracy Score (StudioGAN worker.py:1529-1641):
        # GAN_train fits on fake and tests on real (a recall proxy),
        # GAN_test fits on real and tests on fake (a precision proxy)
        from ccdm_tpu_torch.eval import analysis
        from ccdm_tpu_torch.eval.train_backbones import bin_labels_to_classes

        rc = bin_labels_to_classes(real_labels, num_classes)
        fc = bin_labels_to_classes(flabels, num_classes, ref=real_labels)
        if getattr(args, "GAN_train", False):
            cas_r = analysis.gan_train_test_accuracy(
                fakes, fc, real_images, rc, num_classes,
                epochs=args.epochs_eval_cnn, seed=args.seed, device=device)
            print(f" CAS GAN_train (fit fake, test real): {cas_r:.4f}")
        if getattr(args, "GAN_test", False):
            cas_p = analysis.gan_train_test_accuracy(
                real_images, rc, fakes, fc, num_classes,
                epochs=args.epochs_eval_cnn, seed=args.seed, device=device)
            print(f" CAS GAN_test (fit real, test fake): {cas_p:.4f}")

    if getattr(args, "comp_IS_and_FID_only", False):
        # vanilla main.py:548-560: FID and IS over all fakes, no sliding window
        rng_sh = np.random.default_rng(args.seed)
        fid_all = cal_FID(fid_net, real_images[rng_sh.permutation(len(real_images))],
                          fakes[rng_sh.permutation(len(fakes))])
        is_mean, is_std = inception_score(div_net, fakes, num_classes, splits=10)
        print(f"\n FID of {len(fakes)} fake images: {fid_all:.3f}.")
        print(f"\n IS of {len(fakes)} fake images: {is_mean:.3f}({is_std:.3f}).")
        return {"fid": fid_all, "is": (is_mean, is_std), "fingerprint": nets["fingerprint"]}

    sample_timesteps = getattr(args, "sample_timesteps", 0)
    # the window is shifted by min(min_label, 0): signed labels (SteeringAngle)
    min_before = float(min(args.min_label, 0.0))
    max_after = float(args.max_label + abs(min(args.min_label, 0.0)))
    res = sliding_window_eval(
        real_images, real_labels, fakes, flabels, fn_norm_labels=bundle.fn_normalize,
        fid_net=fid_net, ls_net=ls_net, div_net=div_net,
        fid_radius=args.FID_radius, num_centers=args.FID_num_centers,
        max_label_after_shift=max_after, min_label_before_shift=min_before,
        feats_real=fid_features("real", real_images),
        feats_fake=fid_features("fake", fakes),
    )
    res.save_npz(os.path.join(
        setting_folder, f"fid_ls_entropy_over_centers_sampstep{sample_timesteps}"))

    # full-set FID from the sliding window's cached features (FID is
    # permutation-invariant: the reference's shuffle changes nothing)
    fid_all = frechet_distance(fid_features("real", real_images),
                               fid_features("fake", fakes), eps=1e-6)
    ls_all, ls_std = cal_labelscore(ls_net, fakes, bundle.fn_normalize(flabels),
                                    min_before, max_after)
    prdc = None
    prdc_ctrl = None
    if getattr(args, "comp_prdc", False):
        # PRDC over the FID feature net (StudioGAN metrics/prdc.py:128-168)
        # at equal set sizes: k-NN radii scale with set density
        fr = fid_features("real", real_images)
        prdc = compute_prdc(fr, fid_features("fake", fakes), nearest_k=args.prdc_nearest_k,
                            match_n=True, seed=args.seed)
        # real-vs-real control (split-half): the metric's own ceiling here
        half = len(fr) // 2
        rs = np.random.RandomState(args.seed)
        perm = rs.permutation(len(fr))
        prdc_ctrl = compute_prdc(fr[perm[:half]], fr[perm[half:2 * half]],
                                 nearest_k=args.prdc_nearest_k)

    niqe = None
    niqe_ctrl = None
    if getattr(args, "comp_niqe", False):
        # native NIQE: the pristine model fitted on the real images (cached
        # beside the backbones), fakes scored in-process, a held-out
        # real-vs-real control anchoring the scale
        from ccdm_tpu_torch.eval.niqe import (
            NIQEModel, default_patch_for, fit_niqe_model, niqe_score)

        patch = getattr(args, "niqe_patch", 0) or default_patch_for(args.image_size)
        rs_n = np.random.RandomState(args.seed + 7)
        perm_n = rs_n.permutation(len(real_images))
        n_fit = max(len(real_images) - 500, len(real_images) // 2)
        fit_idx, hold_idx = perm_n[:n_fit], perm_n[n_fit:]
        model_path = os.path.join(args.eval_ckpt_path, "eval_models",
                                  f"niqe_model_p{patch}_n{n_fit}_seed{args.seed}.npz")
        if os.path.isfile(model_path):
            nmodel = NIQEModel.load(model_path)
        else:
            nmodel = fit_niqe_model(real_images[fit_idx], patch=patch, seed=args.seed)
            os.makedirs(os.path.dirname(model_path), exist_ok=True)
            nmodel.save(model_path)
        nsub = rs_n.permutation(len(fakes))[:min(len(fakes), 1000)]
        scores = niqe_score(fakes[nsub], nmodel)
        niqe = (float(scores.mean()), float(scores.std()))
        ctrl = niqe_score(real_images[hold_idx[:500]], nmodel)
        niqe_ctrl = (float(ctrl.mean()), float(ctrl.std()))

    ifid = None
    if getattr(args, "comp_intra_fid", False):
        # FID per label class (StudioGAN worker.py:1392-1466 'iFID'), the
        # continuous labels binned into shared equal-frequency classes
        from ccdm_tpu_torch.eval.train_backbones import bin_labels_to_classes

        ifid_m, ifid_s, _ = intra_class_fid(
            fid_net, real_images, bin_labels_to_classes(real_labels, num_classes),
            fakes, bin_labels_to_classes(flabels, num_classes, ref=real_labels),
            feats_real=fid_features("real", real_images),
            feats_fake=fid_features("fake", fakes))
        ifid = (ifid_m, ifid_s)

    sfid_m, sfid_s = res.sfid
    div_m, div_s = res.diversity
    eval_path = os.path.join(setting_folder, f"eval_results_niters{args.niters}.txt")
    with open(eval_path, "a") as f:
        f.write("\n" + "=" * 99)
        f.write(f"\n Eval backbones: {nets['fingerprint']}.")
        f.write(f"\n Radius: {args.FID_radius}.  \n")
        print(args, file=f)
        f.write(f"\n Sampling Steps: {sample_timesteps}.")
        f.write(f"\n Sampling Time: {total_time:.3f}.")
        f.write(f"\n SFID: {sfid_m:.3f} ({sfid_s:.3f}).")
        f.write(f"\n LS: {ls_all:.3f} ({ls_std:.3f}).")
        f.write(f"\n Diversity: {div_m:.3f} ({div_s:.3f}).")
        f.write(f"\n FID: {fid_all:.3f}.")
        if prdc is not None:
            f.write(f"\n PRDC (k={args.prdc_nearest_k}, equal-N): "
                    f"precision {prdc['precision']:.3f}, recall {prdc['recall']:.3f}, "
                    f"density {prdc['density']:.3f}, coverage {prdc['coverage']:.3f}.")
        if prdc_ctrl is not None:
            f.write(f"\n PRDC real-vs-real control (split-half): "
                    f"precision {prdc_ctrl['precision']:.3f}, recall {prdc_ctrl['recall']:.3f}, "
                    f"density {prdc_ctrl['density']:.3f}, coverage {prdc_ctrl['coverage']:.3f}.")
        if niqe is not None:
            f.write(f"\n NIQE (native, dataset-calibrated): "
                    f"{niqe[0]:.3f} ({niqe[1]:.3f}).")
            f.write(f"\n NIQE real-vs-real control (held-out): "
                    f"{niqe_ctrl[0]:.3f} ({niqe_ctrl[1]:.3f}).")
        if ifid is not None:
            f.write(f"\n Intra-class FID: {ifid[0]:.3f} ({ifid[1]:.3f}).")
    print(f"\n SFID: {sfid_m:.3f}({sfid_s:.3f})  LS: {ls_all:.3f}  "
          f"Diversity: {div_m:.3f}  FID: {fid_all:.3f}")
    if prdc is not None:
        print(f" PRDC: P={prdc['precision']:.3f} R={prdc['recall']:.3f} "
              f"D={prdc['density']:.3f} C={prdc['coverage']:.3f}")
    if niqe is not None:
        print(f" NIQE: {niqe[0]:.3f}({niqe[1]:.3f})  "
              f"control: {niqe_ctrl[0]:.3f}({niqe_ctrl[1]:.3f})")
    if ifid is not None:
        print(f" iFID: {ifid[0]:.3f}({ifid[1]:.3f})")
    return {
        "sfid": res.sfid, "ls": (ls_all, ls_std), "diversity": res.diversity,
        "fid": fid_all, "prdc": prdc, "prdc_ctrl": prdc_ctrl, "niqe": niqe,
        "niqe_ctrl": niqe_ctrl, "ifid": ifid, "eval_path": eval_path,
        "fingerprint": nets["fingerprint"],
    }
