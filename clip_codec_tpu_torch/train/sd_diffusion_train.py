"""CLIP-adapter training on the frozen Stable-Diffusion latent path — the port
of ``clip_codec_tpu/train/sd_diffusion_train.py``.

Only the adapter trains; the UNet and VAE are frozen (their parameters are
set to ``requires_grad=False``, and the step asserts it: the models cache
their weights in the compute dtype as detached tensors). Per sample, with
``t`` and ``noise`` drawn by the loop (or injected by a caller):

    lat_t  = sqrt(abar_t) lat0 + sqrt(1 - abar_t) noise
    loss   = |unet(lat_t, t, adapter(z)) - noise|^2
             + recon_w |vae.decode(lat0_hat) - vae.decode(lat0)|^2 + tv_w TV(vae.decode(lat0_hat))

with ``lat0_hat`` the x0-prediction, averaged over the batch's real rows.
The gradient reaches the adapter through every cross-attention of the UNet
and, by the decode of ``lat0_hat``, through the VAE: the flash-attention
backward kernel runs there (``ops/attention.py``). The UNet and VAE compute
in their own dtype (bf16 on the card); the adapter, AdamW and the loss
arithmetic are fp32.

The JAX trainer's DINO (``clip_w``) and LPIPS (``perc_w``) terms need
released weights and ports of their towers, and data parallelism needs the
parallel slice; neither is ported (``ROADMAP.md``), so the ground-truth
images those terms compare against are not loaded.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..io.store import Store
from ..models.sd.decoder import SD_SCALING_FACTOR, StableDiffusionDecoder, sd_alphas_cumprod
from ..utils.batching import padded_index_batches, prefetch_iter
from ..utils.checkpoint import TrainCheckpointer, save_state_dict
from ..utils.logging import TrainLogger
from .losses import eps_mse, total_variation, weighted_mean
from .optim import ema_update, make_optimizer

PathLike = Union[str, Path]
NOT_PORTED_DP = ("data parallelism (mesh, --data_parallel, --distributed) is not ported to the "
                 "PyTorch package yet (ROADMAP.md, Queue 1 item 12)")


@dataclass
class SDTrainConfig:
    """The JAX ``SDTrainConfig`` without the fields of the DINO and LPIPS
    terms (``out_size``, ``clip_w``, ``perc_w``, ``perc_every``), which are
    not ported."""

    epochs: int = 20
    batch_size: int = 4
    lr: float = 1e-4
    timesteps: int = 1000
    recon_w: float = 0.05
    tv_w: float = 1e-4
    seed: int = 0
    log_every: int = 0
    ema_decay: float = 0.0  # EMA of the adapter (0 = off); also writes sd_adapter_ema_final.pt
    data_workers: int = 0  # the JAX CLI's flag; the latents load on the one prefetch thread


class SDStoreData:
    """Store view over ``manifest_latents.json``: the dequantized,
    L2-normalized embeddings and each record's latent."""

    def __init__(self, store_dir: PathLike) -> None:
        self.store = Store.open(store_dir, manifest_name="manifest_latents.json")
        self.z = self.store.decode_all(renormalize=True)

    def __len__(self) -> int:
        return len(self.store)

    def _load_latent(self, i: int) -> np.ndarray:
        lat = np.load(self.store.manifest[i]["latent"])["lat"].astype(np.float32)  # (4, h, w) fp16
        return lat.transpose(1, 2, 0)

    def batch(self, idx: np.ndarray):
        """(z (B, D), latents (B, h, w, 4)) float32 for the rows ``idx``."""
        return self.z[idx], np.stack([self._load_latent(int(i)) for i in idx])


def freeze(decoder: StableDiffusionDecoder) -> None:
    """Freeze the UNet and VAE and check that only the adapter trains."""
    decoder.unet.requires_grad_(False)
    decoder.vae.requires_grad_(False)
    frozen = [p for m in (decoder.unet, decoder.vae) for p in m.parameters()]
    assert not any(p.requires_grad for p in frozen), "UNet/VAE parameters must be frozen"
    assert all(p.requires_grad for p in decoder.adapter.parameters()), "the adapter must train"


def make_sd_train_step(decoder: StableDiffusionDecoder, optimizer: torch.optim.Optimizer,
                       cfg: SDTrainConfig, ema: Optional[dict] = None):
    """``step(z, lat0, weight, t, noise) -> loss`` (detached): the loss, its
    backward, one optimizer step and, with ``ema``, the EMA update.
    ``step.loss_fn(z, lat0, weight, t, noise)`` is the differentiable loss.
    ``z`` (B, D), ``lat0`` and ``noise`` (B, h, w, 4) fp32 scaled latents,
    ``weight`` (B,) fp32 (0 marks padding), ``t`` (B,) int."""
    unet, vae, adapter = decoder.unet, decoder.vae, decoder.adapter
    dev = next(adapter.parameters()).device
    ac = torch.from_numpy(sd_alphas_cumprod(cfg.timesteps)).to(dev)
    need_decode = cfg.recon_w > 0 or cfg.tv_w > 0
    freeze(decoder)

    def loss_fn(z, lat0, weight, t, noise):
        sa = torch.sqrt(ac[t.long()])[:, None, None, None]
        sb = torch.sqrt(1.0 - ac[t.long()])[:, None, None, None]
        lat_t = sa * lat0 + sb * noise
        eps_hat = unet(lat_t, t, adapter(z)).float()
        per = eps_mse(eps_hat, noise)
        if need_decode:
            lat0_hat = (lat_t - sb * eps_hat) / sa
            x_hat = vae.decode(lat0_hat / SD_SCALING_FACTOR).float()
            if cfg.recon_w > 0:
                x_gt = vae.decode(lat0 / SD_SCALING_FACTOR).float()  # no parameter of it trains
                per = per + cfg.recon_w * torch.mean((x_hat - x_gt) ** 2, dim=(1, 2, 3))
            if cfg.tv_w > 0:
                per = per + cfg.tv_w * total_variation(x_hat)
        return weighted_mean(per, weight)

    params = dict(adapter.named_parameters())

    def step(z, lat0, weight, t, noise):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(z, lat0, weight, t, noise)
        loss.backward()
        optimizer.step()
        if ema is not None:
            ema_update(ema, params, cfg.ema_decay)
        return loss.detach()

    step.loss_fn = loss_fn
    return step


def train_sd_diffusion(
    store_dir: PathLike,
    decoder: StableDiffusionDecoder,
    epochs: int = 20,
    batch_size: int = 4,
    lr: float = 1e-4,
    save_dir: Optional[PathLike] = None,
    config: Optional[SDTrainConfig] = None,
    mesh=None,
    resume: bool = False,
) -> Path:
    """Train ``decoder.adapter`` against the store's precomputed latents and
    return the final adapter's path. Writes ``sd_adapter_ep{N}.pt`` after
    every epoch, ``sd_adapter_final.pt`` (and ``sd_adapter_ema_final.pt``
    with ``ema_decay > 0``) at the end, and the full state under
    ``<save_dir>/state_sd/`` for ``resume=True``. The epoch order is
    ``np.random.default_rng(seed).permutation``; ``t`` and the noise come
    from a ``torch.Generator`` on the adapter's device seeded with
    ``seed + 1``."""
    if mesh is not None:
        raise NotImplementedError(NOT_PORTED_DP)
    cfg = config or SDTrainConfig(epochs=epochs, batch_size=batch_size, lr=lr)
    save_dir = Path(save_dir or store_dir)
    data = SDStoreData(store_dir)
    adapter = decoder.adapter
    dev = next(adapter.parameters()).device
    optimizer = make_optimizer(adapter, cfg.lr)
    use_ema = cfg.ema_decay > 0
    ema = {k: v.detach().float().clone() for k, v in adapter.state_dict().items()} if use_ema else None
    checkpointer = TrainCheckpointer(save_dir / "state_sd")
    start_epoch = 0
    if resume:
        restored = checkpointer.restore(map_location=dev)
        if restored is not None:
            adapter.load_state_dict(restored["adapter"])
            optimizer.load_state_dict(restored["optimizer"])
            if use_ema:
                src = restored.get("ema") or restored["adapter"]
                ema = {k: v.float().clone() for k, v in src.items()}
            start_epoch = int(restored["epoch"])
            print(f"[train_sd] resumed from epoch {start_epoch}")
    step_fn = make_sd_train_step(decoder, optimizer, cfg, ema)

    logger = TrainLogger(log_every=cfg.log_every)
    host_rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    n = len(data)

    def epoch_batches(order):
        # npz latent reads on a host thread, overlapping the device steps
        def gen_batches():
            for idx, w in padded_index_batches(n, cfg.batch_size, order):
                yield (float(w.sum()), w) + data.batch(idx)

        return prefetch_iter(gen_batches(), prefetch=2)

    step = 0
    for ep in range(start_epoch, cfg.epochs):
        order = host_rng.permutation(n)
        losses, wsums = [], []
        t0 = time.time()
        for wsum, w, z, lat0 in epoch_batches(order):
            z_d, lat_d, w_d = (torch.from_numpy(a).to(dev) for a in (z, lat0, w))
            b = lat_d.shape[0]
            t = torch.randint(0, cfg.timesteps, (b,), generator=gen, device=dev, dtype=torch.int32)
            noise = torch.randn(lat_d.shape, generator=gen, device=dev, dtype=torch.float32)
            loss = step_fn(z_d, lat_d, w_d, t, noise)
            losses.append(loss)
            wsums.append(wsum)
            step += 1
            logger.step(step, loss)
        ep_loss = float(np.average([float(l) for l in losses], weights=wsums))
        save_state_dict(save_dir / f"sd_adapter_ep{ep + 1}.pt", adapter.state_dict())
        state = {"adapter": adapter.state_dict(), "optimizer": optimizer.state_dict(), "epoch": ep + 1}
        if use_ema:
            state["ema"] = ema
        checkpointer.save(ep + 1, state)
        logger.epoch(ep + 1, cfg.epochs, ep_loss, sum(wsums) / max(time.time() - t0, 1e-9))
    final = save_state_dict(save_dir / "sd_adapter_final.pt", adapter.state_dict())
    if use_ema:
        save_state_dict(save_dir / "sd_adapter_ema_final.pt", ema)
    return final
