"""Training telemetry (ccdm_tpu/utils/logging.py): the reference's loss text
file and a jsonl of scalars per logged step (loss, step_time_s,
imgs_per_sec); with `tb` (--tb_log) the same scalars as TensorBoard events
under <results>/tb, as train/<name>."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class TrainLogger:
    def __init__(self, results_folder: str, train_num_steps: int, tb: bool = False):
        os.makedirs(results_folder, exist_ok=True)
        self.text_path = os.path.join(results_folder, f"log_loss_niters{train_num_steps}.txt")
        self.jsonl_path = os.path.join(results_folder, "train_log.jsonl")
        with open(self.text_path, "a") as f:
            f.write("\n" + "=" * 99)
        self._tb = None
        if tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(results_folder, "tb"))
            except ImportError:  # no tensorboard package: the text and jsonl logs only
                print(" TrainLogger: tensorboard writer unavailable")

    def log_text(self, step: int, loss: float) -> None:
        with open(self.text_path, "a") as f:
            f.write(f"\r Step: {step}, Loss: {loss:.4f}.")

    def log_scalars(self, scalars: Dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(scalars) + "\n")
        if self._tb is not None:
            step = int(scalars.get("step", 0))
            for k, v in scalars.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(f"train/{k}", v, step)
            self._tb.flush()


class StepTimer:
    """Wall-clock time per step, skipping the first `skip_first` steps
    (warm-up: kernel builds, allocator growth)."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.count = -1
        self.total = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count >= self.skip_first:
            self.total += dt
        return dt

    @property
    def mean(self) -> float:
        n = max(self.count - self.skip_first + 1, 1)
        return self.total / n if self.total else 0.0
