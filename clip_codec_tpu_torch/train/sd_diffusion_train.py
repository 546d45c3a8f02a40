"""CLIP-adapter training on the frozen Stable-Diffusion latent path — the port
of ``clip_codec_tpu/train/sd_diffusion_train.py``.

Only the adapter trains; the UNet and VAE are frozen (their parameters are
set to ``requires_grad=False``, and the step asserts it: the models cache
their weights in the compute dtype as detached tensors). Per sample, with
``t`` and ``noise`` drawn by the loop (or injected by a caller):

    lat_t  = sqrt(abar_t) lat0 + sqrt(1 - abar_t) noise
    x_hat  = vae.decode(lat0_hat)
    loss   = |unet(lat_t, t, adapter(z)) - noise|^2
             + recon_w |x_hat - vae.decode(lat0)|^2 + tv_w TV(x_hat)
             + clip_w (1 - cos(DINO(x_hat), DINO(gt)))          with a DINOv2 tower
             + perc_w LPIPS(x_hat, gt resized to x_hat's size)  with LPIPS, every perc_every-th step

with ``lat0_hat`` the x0-prediction, averaged over the batch's real rows.
``gt`` is the record's image, loaded at ``out_size`` (uint8 to the device,
scaled there by ``scale_m11_u8``) only when one of the last two terms is
on; its DINO embedding takes no gradient, and the cosine divides by the
product of the norms + 1e-8, as JAX's. ``clip_w`` keeps the reference's name
for the DINO term. The gradient reaches the adapter through every
cross-attention of the UNet and, by the decode of ``lat0_hat``, through the
VAE: the flash-attention backward kernel runs there (``ops/attention.py``);
the DINO tower and LPIPS' VGG16 are plain torch (their JAX counterparts
reach no Pallas kernel). The UNet, VAE and DINO tower compute in their own
dtype (bf16 on the card); the adapter, AdamW, LPIPS and the loss arithmetic
are fp32.

Data parallelism (``mesh``) as the pixel trainer's: the frozen UNet and
VAE are loaded on every rank and only the adapter is data-parallel; each
rank loads its rows of every global batch (latents and images), draws ``t``
and the noise for the global batch and cuts them to its rows, computes
every term (DINO and LPIPS too) on its rows, and the adapter's gradients
are summed over the data axis; rank 0 writes the files and prints.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..encoders.dino import DinoV2, embed_m11_images_dino
from ..io.store import Store
from ..models.sd.decoder import SD_SCALING_FACTOR, StableDiffusionDecoder, sd_alphas_cumprod
from ..parallel.mesh import axis_size, barrier, is_main, local_rows, replicate, sum_gradients
from ..utils.batching import padded_index_batches, prefetch_iter
from ..utils.checkpoint import TrainCheckpointer, save_state_dict
from ..utils.logging import TrainLogger
from .data import load_image_u8, scale_m11_u8
from .losses import eps_mse, total_variation, weighted_mean
from .optim import ema_update, make_optimizer

PathLike = Union[str, Path]


@dataclass
class SDTrainConfig:
    """The JAX ``SDTrainConfig``: ``out_size`` is the ground-truth image's
    size for the DINO (``clip_w``) and LPIPS (``perc_w``) terms."""

    out_size: int = 256
    epochs: int = 20
    batch_size: int = 4
    lr: float = 1e-4
    timesteps: int = 1000
    recon_w: float = 0.05
    clip_w: float = 0.1
    perc_w: float = 0.1
    tv_w: float = 1e-4
    perc_every: int = 10
    seed: int = 0
    log_every: int = 0
    ema_decay: float = 0.0  # EMA of the adapter (0 = off); also writes sd_adapter_ema_final.pt
    data_workers: int = 0  # the JAX CLI's flag; the latents load on the one prefetch thread


class SDStoreData:
    """Store view over ``manifest_latents.json``: the dequantized,
    L2-normalized embeddings, each record's latent and, with ``image_size``,
    its ground-truth image."""

    def __init__(self, store_dir: PathLike, image_size: Optional[int] = None) -> None:
        self.store = Store.open(store_dir, manifest_name="manifest_latents.json")
        self.image_size = image_size
        self.z = self.store.decode_all(renormalize=True)

    def __len__(self) -> int:
        return len(self.store)

    def _load_latent(self, i: int) -> np.ndarray:
        lat = np.load(self.store.manifest[i]["latent"])["lat"].astype(np.float32)  # (4, h, w) fp16
        return lat.transpose(1, 2, 0)

    def batch(self, idx: np.ndarray):
        """(z (B, D), latents (B, h, w, 4) float32, images (B, S, S, 3)
        uint8 or None without ``image_size``) for the rows ``idx``."""
        lats = np.stack([self._load_latent(int(i)) for i in idx])
        imgs = None
        if self.image_size is not None:
            imgs = np.stack([load_image_u8(self.store.manifest[int(i)]["image"], self.image_size) for i in idx])
        return self.z[idx], lats, imgs


def freeze(decoder: StableDiffusionDecoder, *towers: Optional[nn.Module]) -> None:
    """Freeze the UNet, the VAE and the loss ``towers`` (None skipped) and
    check that only the adapter trains."""
    frozen = [decoder.unet, decoder.vae] + [m for m in towers if m is not None]
    for m in frozen:
        m.requires_grad_(False)
    assert not any(p.requires_grad for m in frozen for p in m.parameters()), "frozen parameters must stay frozen"
    assert all(p.requires_grad for p in decoder.adapter.parameters()), "the adapter must train"


def make_sd_train_step(decoder: StableDiffusionDecoder, optimizer: torch.optim.Optimizer,
                       cfg: SDTrainConfig, ema: Optional[dict] = None, dino: Optional[DinoV2] = None,
                       lpips: Optional[nn.Module] = None, mesh=None):
    """``step(z, lat0, weight, t, noise, gt_img=None, perc_on=False,
    wsum=None) -> loss`` (detached): the loss, its backward, one optimizer
    step and, with ``ema``, the EMA update. ``step.loss_fn`` (same
    arguments) is the differentiable loss. ``z`` (B, D), ``lat0`` and
    ``noise`` (B, h, w, 4) fp32 scaled latents, ``weight`` (B,) fp32 (0
    marks padding), ``t`` (B,) int; ``gt_img`` (B, S, S, 3) fp32 in [-1,
    1], needed when ``dino`` (the ``clip_w`` term) or ``lpips`` (an
    ``eval.lpips.LPIPS``, the ``perc_w`` term, run only where ``perc_on``)
    is given with a positive weight. With ``mesh`` the arguments are this
    rank's rows, ``wsum`` (required) the global batch's real-row count, and
    the step sums the adapter's gradients and the loss over the data axis."""
    unet, vae, adapter = decoder.unet, decoder.vae, decoder.adapter
    dev = next(adapter.parameters()).device
    ac = torch.from_numpy(sd_alphas_cumprod(cfg.timesteps)).to(dev)
    dino_on = dino is not None and cfg.clip_w > 0
    freeze(decoder, dino, lpips)

    def loss_fn(z, lat0, weight, t, noise, gt_img=None, perc_on=False, wsum=None):
        sa = torch.sqrt(ac[t.long()])[:, None, None, None]
        sb = torch.sqrt(1.0 - ac[t.long()])[:, None, None, None]
        lat_t = sa * lat0 + sb * noise
        eps_hat = unet(lat_t, t, adapter(z)).float()
        per = eps_mse(eps_hat, noise)
        lpips_on = perc_on and lpips is not None and cfg.perc_w > 0
        if cfg.recon_w > 0 or cfg.tv_w > 0 or dino_on or lpips_on:
            lat0_hat = (lat_t - sb * eps_hat) / sa
            x_hat = vae.decode(lat0_hat / SD_SCALING_FACTOR).float()
            if cfg.recon_w > 0:
                x_gt = vae.decode(lat0 / SD_SCALING_FACTOR).float()  # no parameter of it trains
                per = per + cfg.recon_w * torch.mean((x_hat - x_gt) ** 2, dim=(1, 2, 3))
            if cfg.tv_w > 0:
                per = per + cfg.tv_w * total_variation(x_hat)
            if dino_on:
                ya = embed_m11_images_dino(dino, x_hat, dino.cfg.image_size)
                with torch.no_grad():
                    yb = embed_m11_images_dino(dino, gt_img, dino.cfg.image_size)
                norms = torch.linalg.vector_norm(ya, dim=-1) * torch.linalg.vector_norm(yb, dim=-1)
                per = per + cfg.clip_w * (1.0 - (ya * yb).sum(dim=-1) / (norms + 1e-8))
            if lpips_on:
                gt_small = F.interpolate(gt_img.permute(0, 3, 1, 2), size=x_hat.shape[1:3], mode="bilinear",
                                         align_corners=False, antialias=False).permute(0, 2, 3, 1)
                per = per + cfg.perc_w * lpips(x_hat, gt_small)
        return weighted_mean(per, weight, wsum)

    params = dict(adapter.named_parameters())

    def step(z, lat0, weight, t, noise, gt_img=None, perc_on=False, wsum=None):
        if mesh is not None and wsum is None:
            raise ValueError("a data-parallel step needs wsum, the global batch's real-row count")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(z, lat0, weight, t, noise, gt_img, perc_on, wsum)
        loss.backward()
        if mesh is not None:
            (loss,) = sum_gradients(mesh, list(params.values()), loss)
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
    dino: Optional[DinoV2] = None,
    lpips_model: Optional[nn.Module] = None,
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
    ``seed + 1``. ``dino`` (a ``DinoV2``, frozen here) turns on the
    ``clip_w`` term, ``lpips_model`` (an ``eval.lpips.LPIPS``, differentiable
    in its inputs) the ``perc_w`` term on every ``perc_every``-th step.
    ``mesh``: data-parallel training with the decoder on the rank's device;
    ``cfg.batch_size`` is the global batch and must divide by the data axis."""
    cfg = config or SDTrainConfig(epochs=epochs, batch_size=batch_size, lr=lr)
    save_dir = Path(save_dir or store_dir)
    rows = slice(None)
    if mesh is not None:
        n_data = axis_size(mesh)
        if cfg.batch_size % n_data:
            raise ValueError(f"batch_size={cfg.batch_size} not divisible by data axis {n_data}")
        rows = local_rows(mesh, cfg.batch_size)  # load only this rank's rows
    main = is_main(mesh)
    need_gt = (dino is not None and cfg.clip_w > 0) or (lpips_model is not None and cfg.perc_w > 0)
    data = SDStoreData(store_dir, image_size=cfg.out_size if need_gt else None)
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
            if main:
                print(f"[train_sd] resumed from epoch {start_epoch}")
    if mesh is not None:  # the frozen models are loaded alike on every rank; the adapter starts as rank 0's
        replicate(mesh, adapter)
        if use_ema:
            replicate(mesh, ema)
    dp = {} if mesh is None else {"mesh": mesh}  # a one-device run calls the step factory as before
    step_fn = make_sd_train_step(decoder, optimizer, cfg, ema, dino=dino, lpips=lpips_model, **dp)

    logger = TrainLogger(log_every=cfg.log_every, enabled=main)
    host_rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    n = len(data)

    def epoch_batches(order):
        # npz latent and image reads on a host thread, overlapping the device steps
        def gen_batches():
            for idx, w in padded_index_batches(n, cfg.batch_size, order):
                yield (float(w.sum()), w[rows]) + data.batch(idx[rows])

        return prefetch_iter(gen_batches(), prefetch=2)

    step = 0
    for ep in range(start_epoch, cfg.epochs):
        order = host_rng.permutation(n)
        losses, wsums = [], []
        t0 = time.time()
        for wsum, w, z, lat0, img in epoch_batches(order):
            z_d, lat_d, w_d = (torch.from_numpy(a).to(dev) for a in (z, lat0, w))
            img_d = None if img is None else scale_m11_u8(torch.from_numpy(img).to(dev))  # uint8 over the link
            B = cfg.batch_size  # drawn for the global batch on every rank, then cut to its rows
            t = torch.randint(0, cfg.timesteps, (B,), generator=gen, device=dev, dtype=torch.int32)[rows]
            noise = torch.randn((B,) + lat_d.shape[1:], generator=gen, device=dev, dtype=torch.float32)[rows]
            perc_on = lpips_model is not None and step % cfg.perc_every == 0
            loss = step_fn(z_d, lat_d, w_d, t, noise, img_d, perc_on, **({"wsum": wsum} if dp else {}))
            losses.append(loss)
            wsums.append(wsum)
            step += 1
            logger.step(step, loss)
        ep_loss = float(np.average([float(l) for l in losses], weights=wsums))
        if main:
            save_state_dict(save_dir / f"sd_adapter_ep{ep + 1}.pt", adapter.state_dict())
            state = {"adapter": adapter.state_dict(), "optimizer": optimizer.state_dict(), "epoch": ep + 1}
            if use_ema:
                state["ema"] = ema
            checkpointer.save(ep + 1, state)
        barrier(mesh)  # every rank waits for rank 0's write (a resume reads it on every rank)
        logger.epoch(ep + 1, cfg.epochs, ep_loss, sum(wsums) / max(time.time() - t0, 1e-9))
    final = save_dir / "sd_adapter_final.pt"
    if main:
        save_state_dict(final, adapter.state_dict())
        if use_ema:
            save_state_dict(save_dir / "sd_adapter_ema_final.pt", ema)
    barrier(mesh)
    return final
