"""YAML configs of the GAN trainers (ccdm_tpu/training/gan_config.py).

A yaml file maps onto the typed config of its `trainer` (ccgan:
CcGANConfig, dmd: DMDConfig, diffusion: TrainerConfig, the default);
keys that are not fields of it come back as extras (the launcher's
choices, such as gan_arch), and an extra that matches a field but for its
underscores fails loudly. PyYAML is imported only when a file is read.

    trainer: ccgan
    data_name: RC-49
    niters: 40000
    threshold_type: soft
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def _trainers() -> dict:
    from ccdm_tpu_torch.training.ccgan import CcGANConfig
    from ccdm_tpu_torch.training.dmd import DMDConfig
    from ccdm_tpu_torch.training.trainer import TrainerConfig

    return {"ccgan": CcGANConfig, "dmd": DMDConfig, "diffusion": TrainerConfig}


def load_gan_config(path: str):
    """(trainer kind, its config dataclass, extras dict) of a yaml file;
    raises on an unknown kind and on a near-miss key."""
    import yaml

    with open(path) as f:
        raw: Dict[str, Any] = yaml.safe_load(f) or {}
    kind = raw.pop("trainer", "diffusion")
    trainers = _trainers()
    if kind not in trainers:
        raise ValueError(f"unknown trainer kind {kind}; choices {sorted(trainers)}")
    cls = trainers[kind]
    fields = {f.name for f in dataclasses.fields(cls)}
    cfg_kwargs = {k: v for k, v in raw.items() if k in fields}
    extras = {k: v for k, v in raw.items() if k not in fields}
    for k in extras:
        close = [f for f in fields if f.replace("_", "") == k.replace("_", "")]
        if close:
            raise ValueError(f"config key {k!r}: did you mean {close[0]!r}?")
    return kind, cls(**cfg_kwargs), extras
