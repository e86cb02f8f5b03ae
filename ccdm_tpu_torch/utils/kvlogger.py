"""KV-mean logger (ccdm_tpu/utils/kvlogger.py; ADM-G's logger).

Accumulates scalar key/value means between dumps and writes each dump
through its formats at once: "stdout" (a table), "json" (progress.jsonl),
"csv" (progress.csv, rewritten under the union header when new keys
appear) and "tb" (TensorBoard events under <logdir>/tb, through torch's
writer; without the tensorboard package the logger says so and writes
the others). On several processes only rank 0 should build one.
"""

from __future__ import annotations

import csv
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class KVLogger:
    def __init__(self, logdir: str, formats=("stdout", "json", "csv")):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.formats = formats
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._csv_keys: Optional[list] = None
        self._json_path = os.path.join(logdir, "progress.jsonl")
        self._csv_path = os.path.join(logdir, "progress.csv")
        self._start = time.time()
        self._tb = None
        self._tb_step = 0
        if "tb" in formats:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(logdir, "tb"))
            except ImportError:
                print(" KVLogger: tensorboard writer unavailable; 'tb' backend disabled")

    def logkv(self, key: str, value: float) -> None:
        self._sums[key] += float(value)
        self._counts[key] += 1

    def logkv_mean(self, key: str, value: float) -> None:
        self.logkv(key, value)

    def dumpkvs(self) -> Dict[str, float]:
        """The means since the last dump (and "_wall_s", seconds since the
        logger started), written to every format; the sums restart."""
        kvs = {k: self._sums[k] / max(self._counts[k], 1) for k in sorted(self._sums)}
        kvs["_wall_s"] = round(time.time() - self._start, 2)
        if "stdout" in self.formats:
            width = max((len(k) for k in kvs), default=1)
            lines = [f"| {k.ljust(width)} | {v:<12.5g} |" for k, v in kvs.items()]
            sep = "-" * (width + 19)
            print("\n".join([sep] + lines + [sep]))
        if "json" in self.formats:
            with open(self._json_path, "a") as f:
                f.write(json.dumps(kvs) + "\n")
        if "csv" in self.formats:
            self._write_csv(kvs)
        if self._tb is not None:
            # the x axis: a "step" key where there is one, else the dump's index
            step = int(kvs.get("step", self._tb_step))
            for k, v in kvs.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()
            self._tb_step += 1
        self._sums.clear()
        self._counts.clear()
        return kvs

    def _write_csv(self, kvs: Dict[str, float]) -> None:
        keys = sorted(kvs)
        if self._csv_keys != keys:
            old_rows = []
            if os.path.exists(self._csv_path) and self._csv_keys:
                with open(self._csv_path) as f:
                    old_rows = list(csv.DictReader(f))
            self._csv_keys = sorted(set(keys) | {k for r in old_rows for k in r})
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_keys)
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
        with open(self._csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._csv_keys).writerow(kvs)
