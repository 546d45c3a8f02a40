"""Model configuration: the same fields and ``model_config.json`` file as
``clip_codec_tpu/utils/config.py`` (the JAX package's module cannot be
imported without jax), so one file describes a decoder for both packages."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Mapping, Optional, Tuple, Union

PathLike = Union[str, Path]

CONFIG_NAME = "model_config.json"


@dataclass
class ModelConfig:
    """Everything needed to rebuild the trained diffusion decoder."""

    z_dim: int
    base: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2)
    time_dim: int = 256
    img_ch: int = 3
    timesteps: int = 1000
    schedule: str = "cosine"
    out_size: int = 256

    def save(self, directory: PathLike) -> Path:
        path = Path(directory) / CONFIG_NAME
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(asdict(self), indent=2))
        return path

    @classmethod
    def load(cls, path: PathLike) -> "ModelConfig":
        d = json.loads(Path(path).read_text())
        d["ch_mult"] = tuple(d["ch_mult"])
        return cls(**d)

    @classmethod
    def find_for_checkpoint(cls, weights_path: PathLike) -> Optional["ModelConfig"]:
        """The config sitting next to a checkpoint file, if any."""
        cand = Path(weights_path).parent / CONFIG_NAME
        return cls.load(cand) if cand.exists() else None

    @classmethod
    def infer_from_state_dict(cls, sd: Mapping, **overrides) -> "ModelConfig":
        """The architecture of a ``CLIPCondUNet`` torch state dict: ``base``
        and ``img_ch`` from the stem conv, ``z_dim`` and ``time_dim`` from the
        conditioning projection, ``ch_mult`` from each downsample conv's
        channel ratio. Schedule fields keep their defaults unless overridden."""
        cout, cin = sd["in_conv.weight"].shape[:2]
        time_dim, z_dim = sd["z_proj.0.weight"].shape
        ch_mult = []
        i = 0
        while f"down.{3 * i + 2}.weight" in sd:
            w = sd[f"down.{3 * i + 2}.weight"]
            ch_mult.append(int(w.shape[0]) // int(w.shape[1]))
            i += 1
        d = dict(z_dim=int(z_dim), base=int(cout), ch_mult=tuple(ch_mult),
                 time_dim=int(time_dim), img_ch=int(cin))
        d.update(overrides)
        return cls(**d)
