"""Pixel-space diffusion training — the port of
``clip_codec_tpu/train/diffusion_train.py``.

One step, with ``t`` and ``noise`` drawn by the loop (or injected by a
caller):

    x_t   = q_sample(x0, t, noise)
    loss  = |unet(x_t, z, t) - noise|^2 + recon_w |x0_pred - x0|_1
            + tv_w TV(x0_pred) [+ clip_w (1 - cos(CLIP(x0_pred), z)) on even epochs]

with ``x0_pred`` the clamped x0-prediction, averaged over the batch's real
rows, then AdamW (optax.adamw's defaults) and, with ``ema_decay``, the EMA.
The U-Net runs in its direct form (``fused_pallas=False``, as the JAX trainer
builds it): every ResBlock's two GroupNorm+SiLU go through K1 on the card,
28 launches of each of its kernels per forward (56 under ``remat``), and the
convs are ``F.conv2d``. Activations are bf16 (``cfg.bf16``); parameters,
AdamW and the loss arithmetic fp32.

The CLIP-alignment term runs when a ``clip_embed_fn`` is given (the CLI
builds it from ``encoders.ClipEncoder`` and ``encoders.clip.embed_m11_images``)
and is skipped without one, as in JAX without CLIP weights. Data
parallelism and spatial sharding (``mesh``, ``spatial``) are not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule
from ..models.unet import CLIPCondUNet, init_params
from ..utils.checkpoint import TrainCheckpointer, save_state_dict
from ..utils.config import ModelConfig
from ..utils.logging import TrainLogger
from .data import StoreData, scale_m11_u8
from .losses import clip_alignment, eps_mse, l1, total_variation, weighted_mean
from .optim import ema_update, make_optimizer
from .sd_diffusion_train import NOT_PORTED_DP

PathLike = Union[str, Path]
NOT_PORTED_SPATIAL = ("spatial sharding (spatial=True, --spatial_shard > 1) is not ported to the PyTorch "
                      "package yet (ROADMAP.md Queue 1, parallel/)")


@dataclass
class DiffusionTrainConfig:
    """The JAX ``DiffusionTrainConfig``: the reference's kwargs, then the
    JAX package's own knobs."""

    out_size: int = 256
    epochs: int = 40
    batch_size: int = 8
    lr: float = 2e-4
    timesteps: int = 1000
    schedule: str = "cosine"
    recon_w: float = 0.05
    clip_w: float = 0.1
    tv_w: float = 1e-4
    base: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2)
    bf16: bool = True
    clip_align_grad: bool = False  # True = the differentiable CLIP term (the reference's has no gradient)
    seed: int = 0
    log_every: int = 0  # 0 = per-epoch only
    ema_decay: float = 0.0  # EMA of the parameters (0 = off); also writes diffusion_unet_ema_final.pt
    remat: bool = False  # recompute each ResBlock in the backward
    data_workers: int = 0  # threads decoding each batch's images
    cache_images: bool = False  # keep decoded images as resized uint8 in RAM


def make_train_step(net: CLIPCondUNet, sched: NoiseSchedule, optimizer: torch.optim.Optimizer,
                    cfg: DiffusionTrainConfig, clip_embed_fn: Optional[Callable] = None,
                    ema: Optional[dict] = None):
    """``step(x0, z, weight, t, noise, clip_on) -> loss`` (detached): the
    loss, its backward, one optimizer step and, with ``ema``, the EMA
    update. ``step.loss_fn`` (same arguments) is the differentiable loss.
    ``x0`` and ``noise`` (B, H, W, 3) fp32, ``z`` (B, D), ``weight`` (B,)
    fp32 (0 marks padding), ``t`` (B,) int; ``clip_embed_fn(images)`` maps
    [-1, 1] NHWC images to CLIP embeddings."""
    if net.fused_pallas and not net.remat:
        raise NotImplementedError("the fused serving form computes no gradient: "
                                  "train CLIPCondUNet(fused_pallas=False)")
    params = dict(net.named_parameters())

    def loss_fn(x0, z, weight, t, noise, clip_on=False):
        ti = t.long()
        x_t = sched.q_sample(x0, ti, noise)
        eps_hat = net(x_t, z, t).float()
        per = eps_mse(eps_hat, noise)
        x0_pred = torch.clamp(sched.predict_x0_from_eps(x_t, ti, eps_hat), -1.0, 1.0)
        if cfg.recon_w > 0:
            per = per + cfg.recon_w * l1(x0_pred, x0)
        if cfg.tv_w > 0:
            per = per + cfg.tv_w * total_variation(x0_pred)
        if clip_on and cfg.clip_w > 0 and clip_embed_fn is not None:
            align = clip_alignment(x0_pred, z, clip_embed_fn, stop_grad=not cfg.clip_align_grad)
            per = per + cfg.clip_w * align
        return weighted_mean(per, weight)

    def step(x0, z, weight, t, noise, clip_on=False):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(x0, z, weight, t, noise, clip_on)
        loss.backward()
        optimizer.step()
        if ema is not None:
            ema_update(ema, params, cfg.ema_decay)
        return loss.detach()

    step.loss_fn = loss_fn
    return step


def train_diffusion(
    store_dir: PathLike,
    out_size: int = 256,
    epochs: int = 40,
    batch_size: int = 8,
    lr: float = 2e-4,
    timesteps: int = 1000,
    schedule: str = "cosine",
    recon_w: float = 0.05,
    clip_w: float = 0.1,
    tv_w: float = 1e-4,
    save_dir: Optional[PathLike] = None,
    clip_embed_fn: Optional[Callable] = None,
    config: Optional[DiffusionTrainConfig] = None,
    resume: bool = False,
    clip_params=None,
    mesh=None,
    spatial: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Path:
    """Train the pixel diffusion decoder on every sample of the store on
    ``device`` and return the final checkpoint's path.

    Writes ``model_config.json``, ``diffusion_unet_ep{N}.pt`` after every
    epoch, ``diffusion_unet_final.pt`` (and ``diffusion_unet_ema_final.pt``
    with ``ema_decay > 0``) at the end, all in the reference state-dict
    layout that ``ClipCodec.load`` reads, and the full state under
    ``<save_dir>/state/`` for ``resume=True``. The parameters start from
    ``init_params`` with a generator on ``device`` seeded with ``seed``; the
    epoch order is ``np.random.default_rng(seed)``'s; ``t`` and the noise come
    from a generator on ``device`` seeded with ``seed + 1``; the CLIP term
    (``clip_embed_fn(clip_params, images)``) runs on even epochs."""
    if mesh is not None:
        raise NotImplementedError(NOT_PORTED_DP)
    if spatial:
        raise NotImplementedError(NOT_PORTED_SPATIAL)
    cfg = config or DiffusionTrainConfig(
        out_size=out_size, epochs=epochs, batch_size=batch_size, lr=lr, timesteps=timesteps,
        schedule=schedule, recon_w=recon_w, clip_w=clip_w, tv_w=tv_w)
    save_dir = Path(save_dir or store_dir)
    dev = torch.device(device)
    data = StoreData(store_dir, out_size=cfg.out_size, workers=cfg.data_workers, cache_images=cfg.cache_images)
    with torch.device(dev):
        net = CLIPCondUNet(z_dim=data.z_dim, base=cfg.base, ch_mult=cfg.ch_mult, img_ch=3,
                           dtype=torch.bfloat16 if cfg.bf16 else torch.float32, fused_pallas=False,
                           remat=cfg.remat)
    init_params(net, torch.Generator(device=dev).manual_seed(cfg.seed))
    sched = NoiseSchedule.create(cfg.timesteps, cfg.schedule, device=dev)
    optimizer = make_optimizer(net, cfg.lr)
    ModelConfig(z_dim=data.z_dim, base=cfg.base, ch_mult=tuple(cfg.ch_mult), timesteps=cfg.timesteps,
                schedule=cfg.schedule, out_size=cfg.out_size).save(save_dir)

    checkpointer = TrainCheckpointer(save_dir / "state")
    use_ema = cfg.ema_decay > 0
    ema = {k: v.detach().float().clone() for k, v in net.state_dict().items()} if use_ema else None
    start_epoch = 0
    if resume:
        restored = checkpointer.restore(map_location=dev)
        if restored is not None:
            net.load_state_dict(restored["params"])
            optimizer.load_state_dict(restored["optimizer"])
            if use_ema:  # a state saved without an EMA restarts the average from its params
                ema = {k: v.float().clone() for k, v in (restored.get("ema") or restored["params"]).items()}
            start_epoch = int(restored["epoch"])
            print(f"[train] resumed from epoch {start_epoch}")
    embed = None if clip_embed_fn is None else (lambda images: clip_embed_fn(clip_params, images))
    step_fn = make_train_step(net, sched, optimizer, cfg, embed, ema)

    logger = TrainLogger(log_every=cfg.log_every)
    data_rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    step = 0
    for ep in range(start_epoch, cfg.epochs):
        clip_on = ep % 2 == 0  # the reference's every other epoch
        losses, wsums = [], []
        t0 = time.time()
        for batch in data.epoch(cfg.batch_size, data_rng, u8=True):
            # uint8 pixels cross to the device and are scaled there, bit-equal to the host math
            x0 = scale_m11_u8(torch.from_numpy(batch.x0).to(dev))
            z, w = (torch.from_numpy(a).to(dev) for a in (batch.z, batch.weight))
            t = torch.randint(0, cfg.timesteps, (x0.shape[0],), generator=gen, device=dev, dtype=torch.int32)
            noise = torch.randn(x0.shape, generator=gen, device=dev, dtype=torch.float32)
            loss = step_fn(x0, z, w, t, noise, clip_on)
            losses.append(loss)
            wsums.append(batch.wsum)
            step += 1
            logger.step(step, loss)
        ep_loss = float(np.average([float(l) for l in losses], weights=wsums))
        save_state_dict(save_dir / f"diffusion_unet_ep{ep + 1}.pt", net.state_dict())
        state = {"params": net.state_dict(), "optimizer": optimizer.state_dict(), "epoch": ep + 1}
        if use_ema:
            state["ema"] = ema
        checkpointer.save(ep + 1, state)
        logger.epoch(ep + 1, cfg.epochs, ep_loss, sum(wsums) / max(time.time() - t0, 1e-9))
    final = save_state_dict(save_dir / "diffusion_unet_final.pt", net.state_dict())
    if use_ema:
        save_state_dict(save_dir / "diffusion_unet_ema_final.pt", ema)
    return final
