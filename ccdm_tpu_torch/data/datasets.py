"""Dataset layer: h5 loaders for the four benchmark datasets + synthetic.

A numpy copy of ccdm_tpu/data/datasets.py (the port imports nothing of the
JAX package). Each h5 loader is two steps: `read_<name>` opens the file
(it imports h5py when called and raises a clear error where it is not
installed) and returns the raw arrays; `<name>_from_arrays` does all that
follows the read (label filter, normalisation, per-label cap or subset,
the raw eval set), so a run without h5py builds the same bundle from
arrays. The multi-dim-label sets (power_vector, synthetic_power) are in
data/power.py.

Reproduces the vanilla per-dataset pipelines exactly (SURVEY.md §2.2 V1/V9):

- RC-49 (`CCDM_vanilla/RC-49/RC-49_64x64/CCGM/CCDM/main.py:113-159`): h5 keys
  `labels`/`images`/`indx_train`, open-interval label filter (q1, q2),
  per-label cap with shuffle, y/max_label normalization.
- UTKFace (`UTKFace/UK64/.../main.py:100-175`): integer age subset
  [min,max], per-label cap, minority replication up to
  num_img_per_label_after_replica, y/max_label normalization.
- SteeringAngle (`SteeringAngle/SA64/.../main.py:100-135`): signed labels,
  shift normalization (y+|min|)/max_after_shift.
- Cell-200 (`Cell-200/.../main.py:100-150`): h5 keys `CellCounts`/`IMGs_grey`,
  stepsize-strided label subset, first-num_imgs_per_label selection.

Images come back NHWC uint8 (the h5 files store NCHW); labels come back both
raw and normalized, with the normalize/denormalize closures exposed exactly
like the reference's fn_norm_labels/fn_denorm_labels.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class DatasetBundle:
    name: str
    images: np.ndarray  # [N,H,W,C] uint8, training subset
    labels_raw: np.ndarray  # [N] or [N,D] unnormalized
    labels_norm: np.ndarray  # [N] or [N,D] in [0,1]
    fn_normalize: Callable[[np.ndarray], np.ndarray]
    fn_denormalize: Callable[[np.ndarray], np.ndarray]
    eval_images: Optional[np.ndarray] = None  # full raw set (FID reference)
    eval_labels_raw: Optional[np.ndarray] = None

    @property
    def label_dim(self) -> int:
        return 1 if self.labels_norm.ndim == 1 else self.labels_norm.shape[1]

    @property
    def image_size(self) -> int:
        return self.images.shape[1]

    @property
    def channels(self) -> int:
        return self.images.shape[-1]


def import_h5py(user: str):
    """h5py, or an ImportError saying that `user` needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{user} needs the h5py package, which is not installed") from e
    return h5py


def _h5py():
    return import_h5py("reading the h5 datasets (--data_name synthetic needs no file)")


def _to_nhwc(images: np.ndarray) -> np.ndarray:
    if images.ndim == 3:  # [N,H,W] grayscale
        return images[..., None]
    if images.ndim == 4 and images.shape[1] in (1, 3) and images.shape[1] != images.shape[-1]:
        return np.transpose(images, (0, 2, 3, 1))
    return images


def _cap_per_label(images, labels, cap, seed=2023):
    """Per-unique-label cap with shuffle (vanilla main.py:144-159)."""
    if cap is None or cap >= len(labels):
        return images, labels
    rng = np.random.default_rng(seed)
    sel = []
    for lab in np.sort(np.unique(labels)):
        idx = np.where(labels == lab)[0]
        if len(idx) > cap:
            idx = rng.permutation(idx)[:cap]
        sel.append(idx)
    sel = np.concatenate(sel)
    return images[sel], labels[sel]


def read_rc49(data_path: str, image_size: int = 64):
    """RC-49's h5: (images [N, C, H, W] or NHWC, labels, indx_train)."""
    with _h5py().File(os.path.join(data_path, f"RC-49_{image_size}x{image_size}.h5"), "r") as hf:
        return hf["images"][:], hf["labels"][:].astype(float), hf["indx_train"][:]


def rc49_from_arrays(images_all: np.ndarray, labels_all: np.ndarray, indx_train: np.ndarray,
                     min_label: float = 0.0, max_label: float = 90.0,
                     max_num_img_per_label: int = 25, data_split: str = "train") -> DatasetBundle:
    """The RC-49 bundle of the raw arrays load_rc49 reads."""
    labels_all = np.asarray(labels_all, float)
    if data_split == "train":
        images, labels = images_all[indx_train], labels_all[indx_train]
    else:
        images, labels = images_all, labels_all

    keep = np.where((labels > min_label) & (labels < max_label))[0]
    images, labels = images[keep], labels[keep]
    images, labels = _cap_per_label(images, labels, max_num_img_per_label)

    keep_all = np.where((labels_all > min_label) & (labels_all < max_label))[0]

    fn_norm = lambda y: np.asarray(y, float) / max_label
    fn_denorm = lambda y: np.asarray(y, float) * max_label
    return DatasetBundle(
        "RC-49", _to_nhwc(images), labels, fn_norm(labels), fn_norm, fn_denorm,
        eval_images=_to_nhwc(images_all[keep_all]), eval_labels_raw=labels_all[keep_all],
    )


def load_rc49(data_path: str, image_size: int = 64, **kwargs) -> DatasetBundle:
    return rc49_from_arrays(*read_rc49(data_path, image_size), **kwargs)


def read_utkface(data_path: str, image_size: int = 64):
    """UTKFace's h5: (images, labels)."""
    with _h5py().File(os.path.join(data_path, f"UTKFace_{image_size}x{image_size}.h5"),
                      "r") as hf:
        return hf["images"][:], hf["labels"][:].astype(float)


def utkface_from_arrays(images: np.ndarray, labels: np.ndarray, min_label: float = 1,
                        max_label: float = 60, max_num_img_per_label: int = 10**30,
                        num_img_per_label_after_replica: int = 0,
                        seed: int = 2023) -> DatasetBundle:
    """The UTKFace bundle of the raw arrays load_utkface reads."""
    labels = np.asarray(labels, float)
    sel = np.isin(labels, np.arange(min_label, max_label + 1))
    images, labels = images[sel], labels[sel]
    raw_images, raw_labels = images.copy(), labels.copy()
    images, labels = _cap_per_label(images, labels, max_num_img_per_label, seed)

    # minority replication (UTKFace main.py:147-172)
    replica_cap = min(num_img_per_label_after_replica, max_num_img_per_label)
    if replica_cap > 1:
        rng = np.random.default_rng(seed)
        rep_imgs, rep_labels = [], []
        for lab in np.sort(np.unique(labels)):
            idx = np.where(labels == lab)[0]
            if len(idx) < replica_cap:
                extra = rng.choice(idx, size=replica_cap - len(idx), replace=True)
                rep_imgs.append(images[extra])
                rep_labels.append(labels[extra])
        if rep_imgs:
            images = np.concatenate([images] + rep_imgs, axis=0)
            labels = np.concatenate([labels] + rep_labels)

    fn_norm = lambda y: np.asarray(y, float) / max_label
    fn_denorm = lambda y: np.asarray(y, float) * max_label
    return DatasetBundle(
        "UTKFace", _to_nhwc(images), labels, fn_norm(labels), fn_norm, fn_denorm,
        eval_images=_to_nhwc(raw_images), eval_labels_raw=raw_labels,
    )


def load_utkface(data_path: str, image_size: int = 64, **kwargs) -> DatasetBundle:
    return utkface_from_arrays(*read_utkface(data_path, image_size), **kwargs)


def read_steeringangle(data_path: str, image_size: int = 64):
    """SteeringAngle's h5: (images, signed labels in degrees)."""
    fp = os.path.join(data_path, f"SteeringAngle_{image_size}x{image_size}.h5")
    with _h5py().File(fp, "r") as hf:
        return hf["images"][:], hf["labels"][:].astype(float)


def steeringangle_from_arrays(images: np.ndarray, labels: np.ndarray,
                              min_label: float = -80.0, max_label: float = 80.0,
                              max_num_img_per_label: int = 10**30) -> DatasetBundle:
    """The SteeringAngle bundle of the raw arrays load_steeringangle reads
    (or of rendered ones: a run without h5py builds it from arrays)."""
    labels = np.asarray(labels, float)
    keep = np.where((labels > min_label) & (labels < max_label))[0]
    images, labels = images[keep], labels[keep]
    raw_images, raw_labels = images.copy(), labels.copy()

    # shift normalization (SA main.py:108-131)
    min_before = float(np.min(labels))
    max_after = float(np.max(labels + np.abs(min_before)))

    def fn_norm(y):
        return (np.asarray(y, float) + abs(min_before)) / max_after

    def fn_denorm(y):
        return np.asarray(y, float) * max_after - abs(min_before)

    images, labels = _cap_per_label(images, labels, max_num_img_per_label)
    return DatasetBundle(
        "SteeringAngle", _to_nhwc(images), labels, fn_norm(labels), fn_norm, fn_denorm,
        eval_images=_to_nhwc(raw_images), eval_labels_raw=raw_labels,
    )


def load_steeringangle(data_path: str, image_size: int = 64, **kwargs) -> DatasetBundle:
    return steeringangle_from_arrays(*read_steeringangle(data_path, image_size), **kwargs)


def read_cell200(data_path: str, image_size: int = 64):
    """Cell-200's h5: (grayscale images, cell counts)."""
    with _h5py().File(os.path.join(data_path, f"Cell200_{image_size}x{image_size}.h5"),
                      "r") as hf:
        return hf["IMGs_grey"][:], hf["CellCounts"][:].astype(float)


def cell200_from_arrays(images: np.ndarray, labels: np.ndarray, min_label: float = 1,
                        max_label: float = 200, stepsize: int = 2,
                        num_imgs_per_label: int = 10) -> DatasetBundle:
    """The Cell-200 bundle of the raw arrays load_cell200 reads."""
    labels = np.asarray(labels, float)
    sel = np.isin(labels, np.arange(min_label, max_label + 1))
    images, labels = images[sel], labels[sel]
    raw_images, raw_labels = images.copy(), labels.copy()

    # strided subset, first num_imgs_per_label per label (Cell main.py:128-146)
    sel_imgs, sel_labels = [], []
    for lab in np.arange(min_label, max_label + 1, stepsize):
        idx = np.where(labels == lab)[0][:num_imgs_per_label]
        sel_imgs.append(images[idx])
        sel_labels.append(labels[idx])
    images = np.concatenate(sel_imgs, axis=0)
    labels = np.concatenate(sel_labels)

    fn_norm = lambda y: np.asarray(y, float) / max_label
    fn_denorm = lambda y: np.asarray(y, float) * max_label
    return DatasetBundle(
        "Cell200", _to_nhwc(images), labels, fn_norm(labels), fn_norm, fn_denorm,
        eval_images=_to_nhwc(raw_images), eval_labels_raw=raw_labels,
    )


def load_cell200(data_path: str, image_size: int = 64, **kwargs) -> DatasetBundle:
    return cell200_from_arrays(*read_cell200(data_path, image_size), **kwargs)


def make_synthetic(n: int = 512, image_size: int = 64, channels: int = 3,
                   n_labels: int = 32, seed: int = 0) -> DatasetBundle:
    """Brightness-tracks-label synthetic set for tests/benches (no h5 needed)."""
    rng = np.random.default_rng(seed)
    labels = rng.choice(np.linspace(0.1, 0.9, n_labels), size=n)
    base = (labels[:, None, None, None] * 255).astype(np.float32)
    images = np.clip(base + rng.normal(0, 25, (n, image_size, image_size, channels)), 0, 255)
    fn_id = lambda y: np.asarray(y, float)
    return DatasetBundle(
        "synthetic", images.astype(np.uint8), labels, labels.astype(np.float64),
        fn_id, fn_id,
    )


def load_dataset(name: str, data_path: str = "./datasets", **kwargs) -> DatasetBundle:
    """Flag-compatible dispatcher (opts.py --data_name values)."""
    loaders = {
        "RC-49": load_rc49,
        "UTKFace": load_utkface,
        "SteeringAngle": load_steeringangle,
        "Cell200": load_cell200,
        "synthetic": make_synthetic,
    }
    from ccdm_tpu_torch.data.power import load_power_vector, make_synthetic_power

    loaders["synthetic_power"] = make_synthetic_power
    if name == "power_vector":
        # kwargs: design_folder, power_path, power_transformer; data_path
        # supplies the defaults
        kwargs.setdefault("design_folder", os.path.join(data_path, "designs"))
        kwargs.setdefault("power_path", os.path.join(data_path, "power.csv"))
        return load_power_vector(**kwargs)
    if name not in loaders:
        raise ValueError(f"unknown dataset {name}; choices: "
                         f"{sorted(loaders) + ['power_vector']}")
    if name in ("synthetic", "synthetic_power"):
        return loaders[name](**kwargs)
    return loaders[name](data_path, **kwargs)
