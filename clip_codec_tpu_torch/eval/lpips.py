"""LPIPS perceptual distance (VGG16 backbone) — the port of ``clip_codec_tpu/eval/lpips.py``.

The same computation as the JAX ``lpips_forward``, in fp32: scale-shift the
[-1, 1] inputs, run VGG16's convolutions and max-pools, tap the ReLU after
convs 1, 3, 6, 9 and 12 (relu1_2 ... relu5_3), unit-normalize each tap over
channels with the epsilon inside the square root, square the difference,
weight each channel by the learned 1x1 ``lin`` weights, average over space
and sum over the five taps. The convolutions run in cuDNN (the JAX package
computes them with ``lax.conv``, not in a Pallas kernel) with TF32 off.

The parameters carry the ``lpips`` package's state-dict names
(``net.slice{1..5}.{idx}.weight/bias``, ``lin{0..4}.model.1.weight``,
``scaling_layer.shift/scale``), so the file that JAX's
``convert_lpips_torch`` reads loads here with ``strict=True``
(``torch.save(lpips.LPIPS(net='vgg').state_dict(), 'lpips_vgg.pt')``; the
package's ``lins.{i}`` aliases of ``lin{i}`` are dropped on load).
``LPIPSModel.from_env`` reads ``$CLIP_CODEC_LPIPS_WEIGHTS``.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

# VGG16's conv widths with 'M' max-pools, as the JAX module lists them.
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
TAP_AFTER_CONV = [1, 3, 6, 9, 12]
# lpips's Sequential slices keep torchvision's feature indices:
SLICE_CONV_IDX = {
    "slice1": [0, 2],
    "slice2": [5, 7],
    "slice3": [10, 12, 14],
    "slice4": [17, 19, 21],
    "slice5": [24, 26, 28],
}
ENV = "CLIP_CODEC_LPIPS_WEIGHTS"


class _NetLin(nn.Module):
    """lpips's ``NetLinLayer``: ``model.1`` is the (1, C, 1, 1) 1x1 conv weight."""

    def __init__(self, ch: int) -> None:
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(ch, 1, 1, bias=False))


class LPIPS(nn.Module):
    """(B, H, W, 3) [-1, 1] pairs -> (B,) LPIPS distance, fp32."""

    def __init__(self) -> None:
        super().__init__()
        self.scaling_layer = nn.Module()
        self.scaling_layer.register_buffer("shift", torch.zeros(1, 3, 1, 1))
        self.scaling_layer.register_buffer("scale", torch.ones(1, 3, 1, 1))
        self.net = nn.Module()
        widths = [w for w in VGG_CFG if w != "M"]
        cin, ci = 3, 0
        for name, idxs in SLICE_CONV_IDX.items():
            sl = nn.Module()
            for i in idxs:
                sl.add_module(str(i), nn.Conv2d(cin, widths[ci], 3, padding=1))
                cin = widths[ci]
                ci += 1
            self.net.add_module(name, sl)
        for i, ci in enumerate(TAP_AFTER_CONV):
            self.add_module(f"lin{i}", _NetLin(widths[ci]))

    def convs(self) -> List[nn.Conv2d]:
        return [getattr(getattr(self.net, name), str(i)) for name, idxs in SLICE_CONV_IDX.items() for i in idxs]

    def _taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        convs = iter(self.convs())
        ci = 0
        for item in VGG_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2)
                continue
            conv = next(convs)
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            if ci in TAP_AFTER_CONV:
                taps.append(x)
            ci += 1
        return taps

    def forward(self, a_m11: torch.Tensor, b_m11: torch.Tensor) -> torch.Tensor:
        def scale(x):
            x = x.float().permute(0, 3, 1, 2)
            return (x - self.scaling_layer.shift) / self.scaling_layer.scale

        def unit_norm(x):
            return x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)

        with _no_tf32():
            ta, tb = self._taps(scale(a_m11)), self._taps(scale(b_m11))
        total = 0.0
        for i, (xa, xb) in enumerate(zip(ta, tb)):
            d = (unit_norm(xa) - unit_norm(xb)) ** 2
            w = getattr(self, f"lin{i}").model[1].weight.reshape(1, -1, 1, 1)
            total = total + (d * w).sum(dim=1).mean(dim=(1, 2))
        return total


@torch.no_grad()
def init_params(model: LPIPS, generator: Optional[torch.Generator] = None) -> LPIPS:
    """Random weights drawn from ``generator`` for a run without a
    checkpoint: He-normal convs (activations stay O(1) through the 13),
    biases 0, ``lin`` weights |N(0, 0.1)| (LPIPS's are non-negative), and
    the ``lpips`` package's own shift and scale."""
    model.scaling_layer.shift.copy_(torch.tensor([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1))
    model.scaling_layer.scale.copy_(torch.tensor([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1))
    for conv in model.convs():
        conv.weight.normal_(0.0, (2.0 / (9 * conv.in_channels)) ** 0.5, generator=generator)
        conv.bias.zero_()
    for i in range(len(TAP_AFTER_CONV)):
        w = getattr(model, f"lin{i}").model[1].weight
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device).abs() * 0.1)
    return model


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    """cuDNN convolutions in full fp32 (PyTorch lets them use TF32 by default)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def lpips_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ``lpips.LPIPS(net='vgg')`` state dict in this module's names: the
    ``lins.{i}`` aliases of ``lin{i}`` left out, every tensor fp32."""
    return {k: v.float() for k, v in sd.items() if not k.startswith("lins.")}


class LPIPSModel:
    """Loaded-once LPIPS scorer on ``device``; ``distance(a, b)`` -> (B,) fp32."""

    def __init__(self, model: LPIPS, device: Union[str, torch.device] = "cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LPIPSModel: no CUDA device is available (pass device='cpu')")
        self.model = model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def distance(self, a_m11: torch.Tensor, b_m11: torch.Tensor) -> torch.Tensor:
        return self.model(torch.as_tensor(a_m11).to(self.device), torch.as_tensor(b_m11).to(self.device))

    @classmethod
    def from_checkpoint(cls, path: Union[str, Path], device: Union[str, torch.device] = "cuda") -> "LPIPSModel":
        model = LPIPS()
        model.load_state_dict(lpips_state_dict(torch.load(path, map_location="cpu", weights_only=True)),
                              strict=True)
        return cls(model, device)

    @classmethod
    def from_env(cls, device: Union[str, torch.device] = "cuda") -> Optional["LPIPSModel"]:
        """The scorer from ``$CLIP_CODEC_LPIPS_WEIGHTS``; None where it is
        unset. A path that is set but does not load raises."""
        path = os.environ.get(ENV)
        if not path:
            return None
        return cls.from_checkpoint(path, device)
