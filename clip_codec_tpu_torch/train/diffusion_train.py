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
and is skipped without one, as in JAX without CLIP weights.

Data parallelism (``mesh``, a ``parallel.make_mesh`` mesh): ``batch_size``
is the global batch, and each rank decodes and steps on its rows of it. A
rank's loss is its rows' weighted sum over the global batch's real-row
count, so the ranks' gradients, summed by one all-reduce, are the gradient
of JAX's global ``weighted_mean`` (a rank whose rows are all padding adds
zeros). ``t`` and the noise are drawn for the global batch from the same
seed on every rank and cut to its rows, so one rank and several train the
same trajectory up to the order of the sum. Parameters start equal on every
rank (a broadcast from rank 0), so the optimizer and the EMA stay equal too;
rank 0 writes the files and prints.

Spatially sharded training (``spatial=True``; a mesh with a model axis of
k > 1, ``make_mesh(model_parallel=k)``) also splits the image height over
the model axis, the memory lever for 512px+ training (activations scale as
B*H*W*C): each rank decodes its data row's images and keeps its
``model_slice`` of the rows, ``t`` and the noise are drawn for the global
``(B, H, W, 3)`` and cut to its rows and height slice, and the U-Net runs
``forward(..., mesh)`` (halo rows around every conv, K1's split form with
the GroupNorm moments merged over the axis, every collective
differentiable). Each per-sample loss term sums the rank's rows over the
whole image's count (``losses.py``); the CLIP term runs on ``x0_pred``
gathered over the model axis, counted once an image (each of the axis's n
ranks adds 1/n of it); ``sum_gradients(spatial=True)`` sums the gradients
and the loss over the whole mesh in one fp32 all-reduce. So the first step
equals the unsharded one up to the order of the sums. JAX runs it in one
process; here, as on the data axis, one process a rank under the launcher.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule
from ..models.unet import CLIPCondUNet, check_spatial, init_params
from ..parallel.mesh import (MODEL_AXIS, all_gather_rows, axis_size, barrier, is_main, local_rows, model_slice,
                             rank_device, replicate, sum_gradients)
from ..utils.checkpoint import TrainCheckpointer, save_state_dict
from ..utils.config import ModelConfig
from ..utils.logging import TrainLogger
from .data import StoreData, scale_m11_u8
from .losses import clip_alignment, eps_mse, l1, total_variation, weighted_mean
from .optim import ema_update, make_optimizer

PathLike = Union[str, Path]

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
                    ema: Optional[dict] = None, mesh=None, spatial: bool = False):
    """``step(x0, z, weight, t, noise, clip_on, wsum=None) -> loss``
    (detached): the loss, its backward, one optimizer step and, with
    ``ema``, the EMA update. ``step.loss_fn`` (same arguments) is the
    differentiable loss. ``x0`` and ``noise`` (B, H, W, 3) fp32, ``z`` (B,
    D), ``weight`` (B,) fp32 (0 marks padding), ``t`` (B,) int;
    ``clip_embed_fn(images)`` maps [-1, 1] NHWC images to CLIP embeddings.
    With ``mesh`` the arguments are this rank's rows, ``wsum`` (required)
    the global batch's real-row count, and the step sums the gradients and
    the loss over the data axis: it returns the global batch's loss. With
    ``spatial`` too, ``x0`` and ``noise`` are this rank's height slice of
    them (``model_slice``) and the sums run over the whole mesh."""
    if net.fused_pallas and not net.remat:
        raise NotImplementedError("the fused serving form computes no gradient: "
                                  "train CLIPCondUNet(fused_pallas=False)")
    params = dict(net.named_parameters())
    rows_mesh = mesh if spatial else None  # the mesh the images' rows are split over

    def loss_fn(x0, z, weight, t, noise, clip_on=False, wsum=None):
        ti = t.long()
        x_t = sched.q_sample(x0, ti, noise)
        eps_hat = net(x_t, z, t, rows_mesh).float()
        per = eps_mse(eps_hat, noise, rows_mesh)
        x0_pred = torch.clamp(sched.predict_x0_from_eps(x_t, ti, eps_hat), -1.0, 1.0)
        if cfg.recon_w > 0:
            per = per + cfg.recon_w * l1(x0_pred, x0, rows_mesh)
        if cfg.tv_w > 0:
            per = per + cfg.tv_w * total_variation(x0_pred, rows_mesh)
        if clip_on and cfg.clip_w > 0 and clip_embed_fn is not None:
            if rows_mesh is None:
                align = clip_alignment(x0_pred, z, clip_embed_fn, stop_grad=not cfg.clip_align_grad)
            else:  # the whole images on every rank of the axis, each adding 1/n of the term
                whole = all_gather_rows(rows_mesh, x0_pred, dim=1, axis=MODEL_AXIS)
                align = clip_alignment(whole, z, clip_embed_fn, stop_grad=not cfg.clip_align_grad)
                align = align / axis_size(rows_mesh, MODEL_AXIS)
            per = per + cfg.clip_w * align
        return weighted_mean(per, weight, wsum)

    def step(x0, z, weight, t, noise, clip_on=False, wsum=None):
        if mesh is not None and wsum is None:
            raise ValueError("a data-parallel step needs wsum, the global batch's real-row count")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(x0, z, weight, t, noise, clip_on, wsum)
        loss.backward()
        if mesh is not None:
            (loss,) = sum_gradients(mesh, list(params.values()), loss, spatial=spatial)
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
    (``clip_embed_fn(clip_params, images)``) runs on even epochs.

    ``mesh``: a ``parallel.make_mesh`` mesh for data-parallel training on
    the rank's device (``device`` is then ignored); ``cfg.batch_size`` is
    the global batch and must divide by the mesh's data axis. ``spatial``:
    also split the image height over the mesh's model axis (a mesh of
    ``make_mesh(model_parallel=k)``, k > 1; ``out_size`` divides by k, and
    every level's rows into an even count a rank)."""
    cfg = config or DiffusionTrainConfig(
        out_size=out_size, epochs=epochs, batch_size=batch_size, lr=lr, timesteps=timesteps,
        schedule=schedule, recon_w=recon_w, clip_w=clip_w, tv_w=tv_w)
    save_dir = Path(save_dir or store_dir)
    if spatial and mesh is None:
        raise ValueError("spatial=True requires a mesh (make_mesh(model_parallel=k))")
    rows, cut, epoch_local = slice(None), (slice(None),), None
    if mesh is not None:
        n_data = axis_size(mesh)
        if cfg.batch_size % n_data:
            raise ValueError(f"batch_size={cfg.batch_size} not divisible by data axis {n_data}")
        if spatial:
            n_model = axis_size(mesh, MODEL_AXIS)
            if n_model <= 1:
                raise ValueError("spatial=True needs make_mesh(model_parallel=k>1)")
            if cfg.out_size % n_model:
                raise ValueError(f"out_size={cfg.out_size} not divisible by model axis {n_model}")
            check_spatial(cfg.out_size, len(cfg.ch_mult), n_model)
        rows = local_rows(mesh, cfg.batch_size)
        cut = (rows, model_slice(mesh, cfg.out_size)) if spatial else (rows,)
        epoch_local = (rows.start, rows.stop)  # decode only this rank's rows
    main = is_main(mesh)
    dev = rank_device(mesh) if mesh is not None else torch.device(device)
    data = StoreData(store_dir, out_size=cfg.out_size, workers=cfg.data_workers, cache_images=cfg.cache_images)
    with torch.device(dev):
        net = CLIPCondUNet(z_dim=data.z_dim, base=cfg.base, ch_mult=cfg.ch_mult, img_ch=3,
                           dtype=torch.bfloat16 if cfg.bf16 else torch.float32, fused_pallas=False,
                           remat=cfg.remat)
    init_params(net, torch.Generator(device=dev).manual_seed(cfg.seed))
    sched = NoiseSchedule.create(cfg.timesteps, cfg.schedule, device=dev)
    optimizer = make_optimizer(net, cfg.lr)
    if main:
        ModelConfig(z_dim=data.z_dim, base=cfg.base, ch_mult=tuple(cfg.ch_mult), timesteps=cfg.timesteps,
                    schedule=cfg.schedule, out_size=cfg.out_size).save(save_dir)
    barrier(mesh)

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
            if main:
                print(f"[train] resumed from epoch {start_epoch}")
    if mesh is not None:  # every rank loaded the same file (or none), so the optimizer state is equal too
        replicate(mesh, net)
        if use_ema:
            replicate(mesh, ema)
    embed = None if clip_embed_fn is None else (lambda images: clip_embed_fn(clip_params, images))
    step_fn = make_train_step(net, sched, optimizer, cfg, embed, ema, mesh, spatial)

    logger = TrainLogger(log_every=cfg.log_every, enabled=main)
    data_rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    step = 0
    for ep in range(start_epoch, cfg.epochs):
        clip_on = ep % 2 == 0  # the reference's every other epoch
        losses, wsums = [], []
        t0 = time.time()
        for batch in data.epoch(cfg.batch_size, data_rng, local=epoch_local, u8=True):
            # uint8 pixels (this rank's height slice under spatial) cross to the device and are scaled there,
            # bit-equal to the host math
            x0 = batch.x0[:, cut[1]] if spatial else batch.x0
            x0 = scale_m11_u8(torch.from_numpy(np.ascontiguousarray(x0)).to(dev))
            z, w = (torch.from_numpy(a).to(dev) for a in (batch.z, batch.weight))
            # drawn for the global batch on every rank, then cut to its rows (and height slice)
            B = cfg.batch_size
            t = torch.randint(0, cfg.timesteps, (B,), generator=gen, device=dev, dtype=torch.int32)[rows]
            noise = torch.randn((B,) + batch.x0.shape[1:], generator=gen, device=dev, dtype=torch.float32)[cut]
            loss = step_fn(x0, z, w, t, noise, clip_on, batch.wsum if mesh is not None else None)
            losses.append(loss)
            wsums.append(batch.wsum)
            step += 1
            logger.step(step, loss)
        ep_loss = float(np.average([float(l) for l in losses], weights=wsums))
        if main:
            save_state_dict(save_dir / f"diffusion_unet_ep{ep + 1}.pt", net.state_dict())
            state = {"params": net.state_dict(), "optimizer": optimizer.state_dict(), "epoch": ep + 1}
            if use_ema:
                state["ema"] = ema
            checkpointer.save(ep + 1, state)
        barrier(mesh)
        logger.epoch(ep + 1, cfg.epochs, ep_loss, sum(wsums) / max(time.time() - t0, 1e-9))
    final = save_dir / "diffusion_unet_final.pt"
    if main:
        save_state_dict(final, net.state_dict())
        if use_ema:
            save_state_dict(save_dir / "diffusion_unet_ema_final.pt", ema)
    barrier(mesh)
    return final
