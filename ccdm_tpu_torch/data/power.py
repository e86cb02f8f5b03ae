"""The multi-dim-label dataset of Sliced-CCDM (power_vector) and its
synthetic stand-in.

Counterpart of ccdm_tpu/data/power.py, in numpy and scipy (the card's
machine has neither sklearn nor joblib):
- `PowerTransformer` (:26-74): labels / max_power (240000) through a
  quantile transform with the numbers of sklearn's
  QuantileTransformer(n_quantiles=1000, output_distribution="normal",
  random_state=42): up to 1000 quantiles of the fitted values (of a
  subsample of 10000 drawn by RandomState(42) where there are more);
  `transform` takes the mean of the forward and the reversed interpolation
  onto the reference grid, sets values beyond the end quantiles (within
  1e-7) to 0 and 1, maps them through norm.ppf and clips at sklearn's
  bound, then rescales the normal output to [0, 1] by its own min and max;
  `inverse_transform` undoes the rescale by the transforms of 0 and 1,
  then goes back through norm.cdf and the quantiles. Saved with np.savez.
- `load_power_vector` (:77-114): tiff designs (read through PIL, which the
  card's machine lacks: there it raises ImportError) and a CSV of power
  vectors, one row per design after a header.
- `make_synthetic_power` (:117-131): the same arrays as the JAX function
  for the same arguments.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from scipy.stats import norm

from ccdm_tpu_torch.data.datasets import DatasetBundle

BOUNDS_THRESHOLD = 1e-7  # sklearn.preprocessing._data.BOUNDS_THRESHOLD
SUBSAMPLE = 10_000       # QuantileTransformer's default subsample
RANDOM_STATE = 42


class PowerTransformer:
    """Quantile-normalising label transformer."""

    def __init__(self, n_quantiles: int = 1000, output_distribution: str = "normal"):
        if output_distribution not in ("normal", "uniform"):
            raise ValueError(f"output_distribution must be normal or uniform, "
                             f"got {output_distribution!r}")
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution
        self.max_power = 240000.0
        self.quantiles: Optional[np.ndarray] = None
        self.references: Optional[np.ndarray] = None

    def fit(self, power_sequences: np.ndarray) -> "PowerTransformer":
        x = np.asarray(power_sequences, np.float64).reshape(-1) / self.max_power
        if len(x) > SUBSAMPLE:
            idx = np.arange(len(x))
            np.random.RandomState(RANDOM_STATE).shuffle(idx)
            x = x[idx[:SUBSAMPLE]]
        n_quantiles = max(1, min(self.n_quantiles, len(x)))
        self.references = np.linspace(0, 1, n_quantiles, endpoint=True)
        self.quantiles = np.nanpercentile(x, self.references * 100)
        return self

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """The fitted quantile transform of flat values (sklearn's
        _transform_col, forward)."""
        q, refs = self.quantiles, self.references
        if q is None:
            raise RuntimeError("PowerTransformer is not fitted")
        normal = self.output_distribution == "normal"
        if normal:
            lower = x - BOUNDS_THRESHOLD < q[0]
            upper = x + BOUNDS_THRESHOLD > q[-1]
        else:
            lower, upper = x == q[0], x == q[-1]
        y = 0.5 * (np.interp(x, q, refs) - np.interp(-x, -q[::-1], -refs[::-1]))
        y[upper] = 1.0
        y[lower] = 0.0
        if normal:
            eps = np.spacing(1)
            y = np.clip(norm.ppf(y), norm.ppf(BOUNDS_THRESHOLD - eps),
                        norm.ppf(1 - (BOUNDS_THRESHOLD - eps)))
        return y

    def _inverse(self, v: np.ndarray) -> np.ndarray:
        q, refs = self.quantiles, self.references
        if self.output_distribution == "normal":
            v = norm.cdf(v)
            lower = v - BOUNDS_THRESHOLD < 0
            upper = v + BOUNDS_THRESHOLD > 1
        else:
            lower, upper = v == 0, v == 1
        x = np.interp(v, refs, q)
        x[upper] = q[-1]
        x[lower] = q[0]
        return x

    def transform(self, power_sequences: np.ndarray) -> np.ndarray:
        shape = np.shape(power_sequences)
        t = self._forward(np.asarray(power_sequences, np.float64).reshape(-1) / self.max_power)
        if self.output_distribution == "normal":
            t = (t - t.min()) / (t.max() - t.min())
        return t.reshape(shape)

    def inverse_transform(self, transformed: np.ndarray) -> np.ndarray:
        shape = np.shape(transformed)
        v = np.asarray(transformed, np.float64).reshape(-1)
        if self.output_distribution == "normal":
            lo, hi = self._forward(np.array([0.0])), self._forward(np.array([1.0]))
            v = v * (hi - lo) + lo
        return self._inverse(v).reshape(shape) * self.max_power

    def save(self, filepath: str) -> None:
        with open(filepath, "wb") as f:
            np.savez(f, quantiles=self.quantiles, references=self.references,
                     max_power=self.max_power, n_quantiles=self.n_quantiles,
                     output_distribution=self.output_distribution)

    @classmethod
    def load(cls, filepath: str) -> "PowerTransformer":
        with np.load(filepath, allow_pickle=False) as d:
            obj = cls(int(d["n_quantiles"]), str(d["output_distribution"]))
            obj.quantiles, obj.references = d["quantiles"], d["references"]
            obj.max_power = float(d["max_power"])
        return obj


def load_power_vector(design_folder: str, power_path: str,
                      power_transformer: Optional[PowerTransformer] = None) -> DatasetBundle:
    """tiff designs (sorted by the integer of their names) + CSV power
    vectors -> a DatasetBundle with [N, H, W, 1] uint8 images."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("--data_name power_vector reads its tiff designs with PIL, "
                          "which is not installed") from e

    power_data = np.loadtxt(power_path, delimiter=",", skiprows=1)
    if power_data.ndim == 1:
        power_data = power_data[:, None]
    designs = sorted((f for f in os.listdir(design_folder) if f.endswith(".tiff")),
                     key=lambda x: int(x.split(".")[0]))
    if len(designs) != len(power_data):
        raise ValueError(f"design files ({len(designs)}) != power sequences "
                         f"({len(power_data)})")
    images = []
    for name in designs:
        with Image.open(os.path.join(design_folder, name)) as im:
            images.append(np.asarray(im.convert("L"), np.uint8))
    images = np.stack(images)[..., None]

    max_power = float(power_data.max())
    if power_transformer is not None:
        labels_norm = power_transformer.transform(power_data)
        fn_norm, fn_denorm = power_transformer.transform, power_transformer.inverse_transform
    else:
        labels_norm = power_data / max_power
        fn_norm = lambda y: np.asarray(y, float) / max_power
        fn_denorm = lambda y: np.asarray(y, float) * max_power
    return DatasetBundle("power_vector", images, power_data, labels_norm.astype(np.float64),
                         fn_norm, fn_denorm, eval_images=images, eval_labels_raw=power_data)


def make_synthetic_power(n: int = 256, image_size: int = 64, label_dim: int = 8,
                         seed: int = 0) -> DatasetBundle:
    """Labels U(0.05, 0.95)^label_dim; the images encode the first two label
    dims as vertical and horizontal gradients, plus N(0, 10) noise."""
    rng = np.random.default_rng(seed)
    labels = rng.uniform(0.05, 0.95, (n, label_dim))
    ys = np.linspace(0, 1, image_size)
    imgs = np.clip(
        labels[:, 0, None, None, None] * 200 * ys[None, :, None, None]
        + labels[:, 1, None, None, None] * 200 * ys[None, None, :, None]
        + rng.normal(0, 10, (n, image_size, image_size, 1)),
        0, 255,
    ).astype(np.uint8)
    fn_id = lambda y: np.asarray(y, float)
    return DatasetBundle("power_vector", imgs, labels, labels, fn_id, fn_id)
