"""Serving artifacts: the port of ``clip_codec_tpu/deploy.py``.

The JAX package serves from an AOT ``jax.export`` program: the whole
trajectory (the sampler's scan and the final clip) is one compiled program
with no host sync, its shapes fixed at export, its parameters call-time
arguments. Here the artifact is a small file of the same statics, and the
program is rebuilt from it at load: on a CUDA device the whole sampler is
captured once into one ``torch.cuda.CUDAGraph`` and every later call replays
it.

    # build box (has the checkpoint):
    from clip_codec_tpu_torch.deploy import export_decompressor
    export_decompressor(state_dict, mc, "decoder.torchprog", size=256, steps=50)

    # serving box:
    from clip_codec_tpu_torch.deploy import load_decompressor
    dec = load_decompressor("decoder.torchprog")          # device="cuda"
    images = dec(state_dict, z, seed=7)                   # (B, size, size, 3) in [-1, 1]

The file is a magic line (``CLPTORCHPROG1``, not the JAX package's
``CLPJAXPROG1``: each package's loader refuses the other's file) and one
JSON header line. The header holds the JAX header's keys (``kind``,
``size``, ``steps``, ``sampler``, ``eta``, ``batch_size``, ``z_dim``, ...)
and the architecture the JAX program bakes in and this one rebuilds from
(``base``, ``ch_mult``, ``time_dim``, ``timesteps``, ``schedule``; the SD
UNet, VAE and adapter geometry), the compute ``dtype`` and the device kinds
it may load on (``platforms``). Weights are never in the file: parameters
are call-time arguments (state dicts), as in JAX.

A call with a given parameters object builds the network from the header
and loads the state dict once. On ``cuda`` it then runs the sampler once
eagerly on a side stream (lazy state: kernel libraries, packed weights,
tables) and captures it into one graph: the initial noise read from a
static buffer, every step, the clip to [-1, 1], and the ``output="uint8"``
conversion. A later call copies z and the initial noise into the static
buffers and replays. The initial noise is drawn outside the graph from the
program's generator seeded with ``seed`` (what ``ClipCodec._generator(seed,
0)`` and the SD CLI draw), or passed as ``x_T``; at ``eta > 0`` the per-step
draws run inside the graph from that same generator, registered with the
graph, so a replay continues where the eager sampler would and repeats its
draws for a seed. The SD program reads ``guidance_scale`` from a 0-d device
tensor written before each replay, so one capture serves every guidance. A
capture that fails raises; nothing falls back to the eager loop on the
card. On ``cpu`` (the tests) the call runs the eager loop.

Kernel calls recorded during the capture are tallied per wrapper
(``ops.attention.RECORDED``); each replay adds them to the wrappers'
``launches``, so a replayed request counts its kernels as an eager one does.

int8 artifacts (``quant=`` at export; the header's ``int8: true``) serve the
static-int8 U-Net (``ops/int8.py``): every call passes the calibrated quant
dict (``cli.export_decoder --int8`` writes it beside the artifact as
``<artifact>.quant.pt``), and a call without it raises. Its scales are 0-d
device tensors the captured graph reads: each call copies the dict it is
given into static buffers before the replay, as it does z, so one capture
serves any calibration.

The sharded artifacts split the work over a mesh (``parallel.make_mesh``);
their headers add JAX's ``sharded`` (and for pixel ``spatial``) and
``mesh: {data, model}``, and a load checks the mesh's shape with JAX's
message. Every rank exports (rank 0 writes) and loads alike. x_T is drawn
for the global batch from the seed and cut to the rank's part, so a rank's
rows are the single-device artifact's at the rank's batch on those rows of
the seed's noise (in bf16 another batch rounds otherwise).

* The data-sharded pixel artifact (``export_sharded_decompressor``,
  ``load_sharded_decompressor``) splits the batch over the ``data`` axis:
  each rank samples its ``batch_size / n_data`` rows, no collective inside
  the sampler; the rows are gathered after it.
* ``spatial=True`` also splits the image height over the ``model`` axis:
  the U-Net's spatial form (``CLIPCondUNet.forward_spatial``, halo rows and
  GroupNorm totals exchanged over the axis inside every forward); the rows
  are gathered over both axes after the sampler.
* The tensor-parallel SD artifact (``export_sharded_sd_decompressor``,
  ``load_sharded_sd_decompressor``) splits the UNet Megatron-style over the
  ``model`` axis (``parallel/tp.py``: each rank loads its slices,
  ``shard_params_tp``, three all-reduces a transformer block) and the batch
  over ``data``; the VAE and the adapter are replicated. No int8, as JAX's.

Replay follows the backend and is never chosen by catching a failed
capture: a sampler with model-axis collectives is captured only where NCCL
serves them (``parallel.mesh.capturable``); under gloo (ranks sharing one
card) it runs eagerly on the card, since a gloo collective cannot be
captured. A sampler with no collective inside (a model axis of one) is
captured on the card as the single-device artifact is. The loaded call
says which as ``call.replay`` (``"graph"`` or ``"eager"``; the CPU runs
eagerly).
"""

from __future__ import annotations

import collections
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .diffusion import NoiseSchedule, make_sampler
from .models import CLIPCondUNet
from .models.sd import SDClipAdapter, SDUNet, SDUNetConfig, StableDiffusionDecoder, VAEConfig
from .models.sd.unet import NO_TP_INT8
from .models.unet import check_spatial
from .models.sd.decoder import SAMPLERS as SD_SAMPLERS
from .models.sd.decoder import clip_m11
from .models.sd.unet import SD15_UNET
from .models.sd.vae import SD15_VAE, AutoencoderKL
from .ops import attention as _attention
from .ops import int8 as q8
from .parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_gather_rows, axis_size, barrier, capturable, is_main,
                            local_rows, model_slice, rank_device)
from .parallel.tp import shard_params_tp, validate_tp
from .utils.config import ModelConfig

PathLike = Union[str, Path]
StateDict = Mapping[str, torch.Tensor]

_MAGIC = b"CLPTORCHPROG1\n"
_KINDS = ("pixel", "sd")
PLATFORMS = ("cuda", "cpu")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
QUANT_SUFFIX = ".quant.pt"  # the calibration sidecar beside an int8 artifact


# ---------------------------------------------------------------- the file


def _write_artifact(path: PathLike, kind: str, meta: dict) -> Path:
    path = Path(path)
    header = json.dumps({"kind": kind, **meta}, sort_keys=True).encode()
    path.write_bytes(_MAGIC + header + b"\n")
    return path


def read_artifact_meta(path: PathLike) -> dict:
    """The metadata header of an artifact."""
    with open(path, "rb") as f:
        magic, header = f.read(len(_MAGIC)), f.readline()
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a clip_codec_tpu_torch exported program")
    try:
        meta = json.loads(header)
    except ValueError as e:
        raise ValueError(f"{path}: corrupt artifact header: {e}") from None
    if not isinstance(meta, dict) or meta.get("kind") not in _KINDS:
        raise ValueError(f"{path}: unknown artifact kind {meta.get('kind') if isinstance(meta, dict) else meta!r}")
    return meta


def _read_artifact(path: PathLike, expect_kind: str, sharded: bool = False) -> dict:
    meta = read_artifact_meta(path)
    if meta["kind"] != expect_kind:
        raise ValueError(
            f"{path}: this is a {meta['kind']!r} artifact — load it with "
            f"load_{'sd_' if meta['kind'] == 'sd' else ''}decompressor")
    sd = "sd_" if expect_kind == "sd" else ""
    if meta.get("sharded") and not sharded:
        raise ValueError(f"{path}: sharded artifact (mesh {meta.get('mesh')}) — use "
                         f"load_sharded_{sd}decompressor(path, mesh)")
    if sharded and not meta.get("sharded"):
        raise ValueError(f"{path}: not a sharded artifact — use load_{sd}decompressor")
    return meta


def _platforms(platforms: Optional[Sequence[str]]) -> list:
    """The device kinds an artifact may load on; default: this box's."""
    if platforms is None:
        return ["cuda" if torch.cuda.is_available() else "cpu"]
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be drawn from {PLATFORMS}, got {list(platforms)}")
    return list(platforms)


def _dtype_name(dtype: Union[str, torch.dtype]) -> str:
    name = dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {tuple(_DTYPES)}, got {dtype!r}")
    return name


def _check_shapes(module: torch.nn.Module, state: StateDict, what: str) -> None:
    """``state`` fits ``module`` key for key and shape for shape (``module``
    may live on the meta device: only shapes are read)."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    if want != got:
        missing, extra = sorted(want.keys() - got.keys()), sorted(got.keys() - want.keys())
        shapes = sorted(k for k in want.keys() & got.keys() if want[k] != got[k])
        raise ValueError(f"{what} parameters do not fit the architecture: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}, other shapes {shapes[:5]}")


def _check_quant(unet: torch.nn.Module, quant: q8.Quant) -> None:
    """``quant`` holds one scalar absmax for each int8 layer of ``unet``
    (which may live on the meta device) and nothing else."""
    want, got = set(q8.int8_layer_names(unet)), set(quant)
    if want != got:
        raise ValueError(f"quant does not fit the architecture's int8 layers: missing {sorted(want - got)[:5]}, "
                         f"unexpected {sorted(got - want)[:5]}")
    bad = sorted(k for k, v in quant.items() if not torch.is_tensor(v) or v.numel() != 1)
    if bad:
        raise ValueError(f"quant values must be scalar tensors: {bad[:5]}")


def _quant_inputs(program: "_Program", unet: torch.nn.Module, quant: Optional[q8.Quant]) -> Dict[str, torch.Tensor]:
    """The call's quant dict as program inputs (``q:<layer>`` -> a 0-d fp32
    tensor on the device): required by an int8 artifact, refused by another."""
    if not program.meta["int8"]:
        if quant is not None:
            raise ValueError("quant= is for int8 artifacts; this artifact is not one")
        return {}
    if quant is None:
        raise ValueError(f"int8 artifact: pass quant= (the calibration collection exported next to it, "
                         f"<artifact>{QUANT_SUFFIX})")
    _check_quant(unet, quant)
    return {"q:" + k: v.reshape(()).to(device=program.device, dtype=torch.float32) for k, v in quant.items()}


def _use_quant(unet: torch.nn.Module, inputs: Dict[str, torch.Tensor]) -> None:
    """Point the int8 layers at the quant inputs (the static buffers when
    captured); a program without them leaves the U-Net as it is."""
    if inputs:
        q8.load_quant(unet, {k[2:]: v for k, v in inputs.items()})


def _load(module: torch.nn.Module, state: StateDict, what: str) -> torch.nn.Module:
    if not isinstance(state, Mapping) or not all(torch.is_tensor(v) for v in state.values()):
        raise TypeError(f"{what} parameters must be a state dict of tensors, got {type(state).__name__}")
    _check_shapes(module, state, what)
    if next(module.parameters()).device.type != "meta":
        module.load_state_dict(state, strict=True)
    return module


# ------------------------------------------------------------ the capture


class _Graph:
    """``run()`` (reading only static buffers) warmed up once on a side
    stream, then captured into one CUDA graph. ``replay()`` returns the
    captured output buffer (overwritten by the next replay) and adds the
    kernel calls the capture recorded to each wrapper's ``launches``."""

    def __init__(self, run: Callable[[], torch.Tensor], generator: Optional[torch.Generator] = None) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = collections.Counter(_attention.RECORDED)
        with torch.cuda.graph(self.graph):
            self.out = run()
        self.launches: Dict[Callable, int] = dict(_attention.RECORDED - before)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return self.out


class _Program:
    """A loaded artifact: ``meta`` (the header), ``platforms``, the device,
    and the networks built from the last parameters it was called with."""

    def __init__(self, meta: dict, device: Union[str, torch.device], mesh=None) -> None:
        self.meta = meta
        self.platforms = tuple(meta["platforms"])
        self.device = torch.device(device)
        if self.device.type not in self.platforms:
            raise ValueError(f"artifact exported for platforms {list(self.platforms)}, not "
                             f"{self.device.type!r}; re-export with --platforms {self.device.type}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (load with device='cpu')")
        self.mesh = mesh
        # one CUDA graph where the sampler's collectives (if any) can be captured, else the eager loop
        self.replay = "graph" if self.device.type == "cuda" and capturable(mesh) else "eager"
        self.generator = torch.Generator(device=self.device)
        self.rows = slice(None)  # this program's rows of the artifact's batch
        self.cut = self.rows  # its part of the initial noise of the artifact's whole batch
        self.graph: Optional[_Graph] = None
        self._params: Optional[tuple] = None
        self._static: Dict[str, torch.Tensor] = {}

    def _bind(self, params: tuple) -> None:
        if self._params is not None and all(a is b for a, b in zip(self._params, params)):
            return
        self.graph, self._params = None, None
        self._build(*params)
        self._params = params

    def _build(self, *params) -> None:
        raise NotImplementedError

    def _tensor(self, a, shape: Tuple[int, ...], what: str) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} must have shape {tuple(shape)} (the artifact's statics), "
                             f"got {tuple(t.shape)}")
        return t.to(device=self.device, dtype=torch.float32)

    def _noise(self, seed: int, x_T, whole: Tuple[int, ...]) -> torch.Tensor:
        """Seed the generator, then the initial noise of the artifact's whole
        batch (``x_T``, or drawn from it), cut to this program's part."""
        self.generator.manual_seed(int(seed))
        if x_T is not None:
            return self._tensor(x_T, whole, "x_T")[self.cut]
        return torch.randn(whole, generator=self.generator, device=self.device, dtype=torch.float32)[self.cut]

    def _run(self, inputs: Dict[str, torch.Tensor], eager: Callable[..., torch.Tensor],
             seed: int, x_T, shape: Tuple[int, ...], whole: Tuple[int, ...]) -> torch.Tensor:
        """The eager loop on the CPU and where ``replay`` is ``"eager"``;
        else capture on the first call with these parameters, then copy the
        inputs and the noise in and replay. ``shape`` is this program's
        part of the initial noise, ``whole`` the artifact's."""
        gen = self.generator if self.meta["eta"] > 0 else None
        if self.replay == "eager":
            return eager(x_T=self._noise(seed, x_T, whole), generator=gen, **inputs)
        if self.graph is None:
            self._static = {k: torch.zeros_like(v) for k, v in inputs.items()}
            self._static["x_T"] = torch.zeros(shape, device=self.device, dtype=torch.float32)
            self.graph = _Graph(lambda: eager(generator=gen, **self._static), gen)
        noise = self._noise(seed, x_T, whole)
        for k, v in inputs.items():
            self._static[k].copy_(v)
        self._static["x_T"].copy_(noise)
        return self.graph.replay().clone()


# ---------------------------------------------------------------- pixel


def make_decompress_fn(mc: ModelConfig, size: int = 256, steps: int = 50, sampler: str = "ddim",
                       eta: float = 0.0, output: str = "float32",
                       batch_rows: Optional[Tuple[Tuple[int, ...], object]] = None,
                       spatial=None) -> Callable[..., torch.Tensor]:
    """The serving function ``(net, z, x_T, generator) -> images``: the
    sampler from ``x_T`` (B, size, size, img_ch) conditioned on ``z`` (B,
    z_dim), clipped to [-1, 1], and with ``output="uint8"`` converted as
    the host prepares a PNG, ``((x + 1) * 127.5)`` truncated to uint8.
    ``generator`` draws the per-step noise at ``eta > 0``, for the whole
    sample of ``batch_rows`` = (whole shape, index) when ``x_T`` is its
    ``index`` cut (``ddim_sample``'s). ``spatial``: a mesh whose
    model axis splits the height of ``x_T``, which the U-Net's spatial form
    then samples."""
    if output not in ("float32", "uint8"):
        raise ValueError(f"output must be 'float32' or 'uint8', got {output!r}")
    sched = NoiseSchedule.create(mc.timesteps, mc.schedule)
    smp = make_sampler(sampler, sched, eta=eta)
    split = {} if batch_rows is None or eta == 0 else {"batch_rows": batch_rows}

    def run(net: CLIPCondUNet, z: torch.Tensor, x_T: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fn = net if spatial is None else (lambda x, zz, t: net.forward_spatial(x, zz, t, spatial))
        x = smp.sample(fn, z, tuple(x_T.shape), steps=steps, x_T=x_T, generator=generator, **split)
        x = torch.clamp(x, -1.0, 1.0)
        if output == "uint8":
            x = ((x + 1.0) * 127.5).to(torch.uint8)
        return x

    return run


def _pixel_net(meta: dict, device: Union[str, torch.device] = "meta") -> CLIPCondUNet:
    with torch.device(device):
        return CLIPCondUNet(z_dim=meta["z_dim"], base=meta["base"], ch_mult=tuple(meta["ch_mult"]),
                            time_dim=meta["time_dim"], img_ch=meta["img_ch"], dtype=_DTYPES[meta["dtype"]],
                            int8=bool(meta["int8"]))


def export_decompressor(
    params: StateDict,
    mc: ModelConfig,
    path: PathLike,
    *,
    size: int = 256,
    steps: int = 50,
    sampler: str = "ddim",
    eta: float = 0.0,
    batch_size: int = 16,
    quant=None,
    output: str = "float32",
    platforms: Optional[Sequence[str]] = None,
    dtype: Union[str, torch.dtype] = "bfloat16",
) -> Path:
    """Write a pixel artifact for ``mc``'s architecture. ``params`` (a
    ``CLIPCondUNet`` state dict) is checked against it, shapes only: the
    artifact carries no weights. ``dtype`` is the U-Net's compute dtype
    (bf16, as the JAX program; fp32 for parity runs). ``quant`` (a
    calibrated quant dict, ``ops.int8.calibrate_unet``) makes it a
    static-int8 artifact, whose calls then take that dict."""
    meta = _pixel_meta(params, mc, size, steps, sampler, eta, batch_size, quant, output, platforms, dtype)
    return _write_artifact(path, "pixel", meta)


def _pixel_meta(params: StateDict, mc: ModelConfig, size: int, steps: int, sampler: str, eta: float,
                batch_size: int, quant, output: str, platforms: Optional[Sequence[str]],
                dtype: Union[str, torch.dtype]) -> dict:
    """A pixel artifact's header, after checking ``params`` (and ``quant``)
    against the architecture."""
    make_decompress_fn(mc, size, steps, sampler, eta, output)  # rejects a bad sampler, eta or output
    meta = dict(size=int(size), steps=int(steps), sampler=sampler, eta=float(eta), batch_size=int(batch_size),
                z_dim=int(mc.z_dim), img_ch=int(mc.img_ch), int8=quant is not None, output=output,
                base=int(mc.base), ch_mult=[int(c) for c in mc.ch_mult], time_dim=int(mc.time_dim),
                timesteps=int(mc.timesteps), schedule=mc.schedule, dtype=_dtype_name(dtype),
                platforms=_platforms(platforms))
    net = _load(_pixel_net(meta), params, "U-Net")
    if quant is not None:
        _check_quant(net, quant)
    return meta


class PixelDecompressor(_Program):
    """``call(params, z, seed=0, x_T=None, quant=None) -> images``, (B,
    size, size, img_ch) float32 in [-1, 1] or uint8, on the program's
    device; ``quant`` is required by an int8 artifact and only by one."""

    def __init__(self, meta: dict, device: Union[str, torch.device], mesh=None) -> None:
        super().__init__(meta, device, mesh)
        self.mc = ModelConfig(z_dim=meta["z_dim"], base=meta["base"], ch_mult=tuple(meta["ch_mult"]),
                              time_dim=meta["time_dim"], img_ch=meta["img_ch"], timesteps=meta["timesteps"],
                              schedule=meta["schedule"], out_size=meta["size"])
        self.sample = make_decompress_fn(self.mc, meta["size"], meta["steps"], meta["sampler"], meta["eta"],
                                         meta["output"])
        self.net: Optional[CLIPCondUNet] = None

    def _build(self, params: StateDict) -> None:
        self.net = _load(_pixel_net(self.meta, self.device), params, "U-Net").eval()

    def __call__(self, params: StateDict, z, seed: int = 0, x_T=None, quant: Optional[q8.Quant] = None
                 ) -> torch.Tensor:
        m = self.meta
        self._bind((params,))
        z = self._tensor(z, (m["batch_size"], m["z_dim"]), "z")[self.rows]

        def eager(z, x_T, generator, **q):
            _use_quant(self.net, q)
            return self.sample(self.net, z, x_T, generator)

        whole = (m["batch_size"], m["size"], m["size"], m["img_ch"])
        shape = tuple(torch.empty(whole, device="meta")[self.cut].shape)
        return self._run({"z": z, **_quant_inputs(self, self.net, quant)}, eager, seed, x_T, shape, whole)


def load_decompressor(path: PathLike, device: Union[str, torch.device] = "cuda") -> PixelDecompressor:
    """Load a pixel artifact written by :func:`export_decompressor` for
    ``device``; the export-time statics ride on ``call.meta``."""
    return PixelDecompressor(_read_artifact(path, "pixel"), device)


# ------------------------------------------------------------------- SD


def make_sd_decompress_fn(size: int = 512, steps: int = 30, sampler: str = "ddim", eta: float = 0.0,
                          cfg_batched: Optional[bool] = None, batch_size: int = 1
                          ) -> Callable[..., torch.Tensor]:
    """The SD serving function ``(decoder, z, x_T, guidance, generator) ->
    images``: CFG sampling from the latent ``x_T`` and the VAE decode
    (``StableDiffusionDecoder.sample``), clipped to [-1, 1] in fp32.
    ``guidance`` is a number or a 0-d fp32 device tensor; ``cfg_batched``
    None picks the batched pair at ``batch_size`` <= 4, as the JAX
    program."""
    if sampler not in SD_SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}; choose 'ddim' or 'dpmpp'")
    if sampler == "dpmpp" and eta != 0.0:
        raise ValueError("DPM-Solver++ is deterministic: eta must be 0.0")
    batched = batch_size <= 4 if cfg_batched is None else bool(cfg_batched)

    def run(dec: StableDiffusionDecoder, z: torch.Tensor, x_T: torch.Tensor, guidance,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        img = dec.sample(z, tuple(x_T.shape), steps=steps, eta=eta, guidance_scale=guidance,
                         generator=generator, cfg_batched=batched, sampler=sampler, x_T=x_T)
        return clip_m11(img.float())

    return run


def _sd_modules(meta: dict, device: Union[str, torch.device] = "meta", mesh=None):
    """The UNet (this rank's tensor-parallel one under ``mesh``), the VAE and
    the adapter of an SD header."""
    ucfg = SDUNetConfig(**{**meta["unet"], "block_out": tuple(meta["unet"]["block_out"])})
    vcfg = VAEConfig(**{**meta["vae"], "block_out": tuple(meta["vae"]["block_out"])})
    dt = _DTYPES[meta["dtype"]]
    with torch.device(device):
        return (SDUNet(ucfg, dtype=dt, int8=bool(meta["int8"]), mesh=mesh), AutoencoderKL(vcfg, dtype=dt),
                SDClipAdapter(meta["z_dim"], ucfg.cross_dim, meta["adapter_hidden"], meta["n_tokens"]))


def export_sd_decompressor(
    unet_params: StateDict,
    vae_params: StateDict,
    adapter_params: StateDict,
    path: PathLike,
    *,
    unet_cfg: Optional[SDUNetConfig] = None,
    vae_cfg: Optional[VAEConfig] = None,
    clip_dim: Optional[int] = None,
    n_tokens: Optional[int] = None,
    size: int = 512,
    steps: int = 30,
    sampler: str = "ddim",
    eta: float = 0.0,
    cfg_batched: Optional[bool] = None,
    batch_size: int = 1,
    quant=None,
    platforms: Optional[Sequence[str]] = None,
    dtype: Union[str, torch.dtype] = "bfloat16",
) -> Path:
    """Write an SD artifact. The three state dicts are checked against the
    architecture, shapes only (``unet_cfg``/``vae_cfg`` default to SD-1.5's);
    the adapter geometry (clip_dim, hidden, n_tokens) is read off the
    adapter's weights unless overridden. ``quant`` (the UNet's calibrated
    quant dict, ``StableDiffusionDecoder.calibrate_int8_scales``) makes it a
    static-int8 artifact, whose calls then take that dict."""
    meta = _sd_meta(unet_params, vae_params, adapter_params, unet_cfg, vae_cfg, clip_dim, n_tokens, size, steps,
                    sampler, eta, cfg_batched, batch_size, quant, platforms, dtype)
    return _write_artifact(path, "sd", meta)


def _sd_meta(unet_params: StateDict, vae_params: StateDict, adapter_params: StateDict,
             unet_cfg: Optional[SDUNetConfig], vae_cfg: Optional[VAEConfig], clip_dim: Optional[int],
             n_tokens: Optional[int], size: int, steps: int, sampler: str, eta: float, cfg_batched: Optional[bool],
             batch_size: int, quant, platforms: Optional[Sequence[str]], dtype: Union[str, torch.dtype]) -> dict:
    """An SD artifact's header, after checking the state dicts (and
    ``quant``) against the architecture."""
    ucfg = unet_cfg if unet_cfg is not None else SD15_UNET
    vcfg = vae_cfg if vae_cfg is not None else SD15_VAE
    fc1, fc2 = adapter_params["proj.1.weight"], adapter_params["proj.3.weight"]
    hidden = int(fc1.shape[0])
    clip_dim = int(fc1.shape[1]) if clip_dim is None else int(clip_dim)
    n_tokens = int(fc2.shape[0]) // ucfg.cross_dim if n_tokens is None else int(n_tokens)
    make_sd_decompress_fn(size, steps, sampler, eta, cfg_batched, batch_size)
    down = 2 ** (len(vcfg.block_out) - 1)
    if size % down:
        raise ValueError(f"size {size} not divisible by the VAE factor {down}")
    meta = dict(size=int(size), steps=int(steps), sampler=sampler, eta=float(eta), batch_size=int(batch_size),
                z_dim=clip_dim, n_tokens=n_tokens, int8=quant is not None,
                cfg_batched=batch_size <= 4 if cfg_batched is None else bool(cfg_batched),
                unet=dataclasses.asdict(ucfg), vae=dataclasses.asdict(vcfg), adapter_hidden=hidden,
                dtype=_dtype_name(dtype), platforms=_platforms(platforms))
    mods = _sd_modules(meta)
    for mod, state, what in zip(mods, (unet_params, vae_params, adapter_params), ("UNet", "VAE", "adapter")):
        _load(mod, state, what)
    if quant is not None:
        _check_quant(mods[0], quant)
    return meta


class SDDecompressor(_Program):
    """``call(unet_params, vae_params, adapter_params, z, seed=0,
    guidance_scale=5.0, x_T=None, quant=None) -> images``, (B, size, size,
    3) float32 in [-1, 1] on the program's device; ``x_T`` is the initial
    latent, ``quant`` the UNet's calibration (int8 artifacts only)."""

    def __init__(self, meta: dict, device: Union[str, torch.device], mesh=None) -> None:
        super().__init__(meta, device, mesh)
        self.sample = make_sd_decompress_fn(meta["size"], meta["steps"], meta["sampler"], meta["eta"],
                                            meta["cfg_batched"], meta["batch_size"])
        self.decoder: Optional[StableDiffusionDecoder] = None

    def _build(self, unet_params: StateDict, vae_params: StateDict, adapter_params: StateDict) -> None:
        if self.mesh is not None:  # this rank's slices of the whole UNet, checked whole
            _check_shapes(_sd_modules(self.meta)[0], unet_params, "UNet")
            unet_params = shard_params_tp(self.mesh, unet_params)
        mods = [_load(mod, state, what).eval() for mod, state, what in
                zip(_sd_modules(self.meta, self.device, self.mesh), (unet_params, vae_params, adapter_params),
                    ("UNet", "VAE", "adapter"))]
        self.decoder = StableDiffusionDecoder(*mods)

    def latent_shape(self) -> Tuple[int, int, int, int]:
        """The artifact's whole initial latent (B, h, w, latent_ch)."""
        m = self.meta
        f = 2 ** (len(m["vae"]["block_out"]) - 1)
        return (m["batch_size"], m["size"] // f, m["size"] // f, m["vae"]["latent_ch"])

    def __call__(self, unet_params: StateDict, vae_params: StateDict, adapter_params: StateDict, z,
                 seed: int = 0, guidance_scale: float = 5.0, x_T=None, quant: Optional[q8.Quant] = None
                 ) -> torch.Tensor:
        m = self.meta
        self._bind((unet_params, vae_params, adapter_params))
        z = self._tensor(z, (m["batch_size"], m["z_dim"]), "z")[self.rows]
        g = torch.full((), float(np.float32(guidance_scale)), dtype=torch.float32, device=self.device)

        def eager(z, x_T, guidance, generator, **q):
            _use_quant(self.decoder.unet, q)
            return self.sample(self.decoder, z, x_T, guidance, generator)

        whole = self.latent_shape()
        return self._run({"z": z, "guidance": g, **_quant_inputs(self, self.decoder.unet, quant)}, eager, seed, x_T,
                         (z.shape[0],) + whole[1:], whole)


def load_sd_decompressor(path: PathLike, device: Union[str, torch.device] = "cuda") -> SDDecompressor:
    """Load an SD artifact written by :func:`export_sd_decompressor` for
    ``device``; the export-time statics ride on ``call.meta``."""
    return SDDecompressor(_read_artifact(path, "sd"), device)


# ---------------------------------------------------------------- sharded


def _mesh_shape(mesh) -> dict:
    return {"data": axis_size(mesh, DATA_AXIS), "model": axis_size(mesh, MODEL_AXIS)}


def export_sharded_decompressor(
    params: StateDict,
    mc: ModelConfig,
    path: PathLike,
    mesh,
    *,
    spatial: bool = False,
    size: int = 256,
    steps: int = 50,
    sampler: str = "ddim",
    eta: float = 0.0,
    batch_size: int = 16,
    platforms: Optional[Sequence[str]] = None,
    dtype: Union[str, torch.dtype] = "bfloat16",
) -> Path:
    """Write a pixel artifact whose batch splits over ``mesh``'s ``data``
    axis (weights replicated, no collective inside the sampler) and, with
    ``spatial=True``, whose image height also splits over its ``model``
    axis (the U-Net's spatial form). Every rank calls it; rank 0 writes the
    file. A seed's x_T is drawn for the whole batch, as the single-device
    artifact draws it."""
    shape = _mesh_shape(mesh)
    if batch_size % shape["data"]:
        raise ValueError(f"batch_size {batch_size} not divisible by data axis {shape['data']}")
    if spatial:
        if size % shape["model"]:
            raise ValueError(f"size {size} not divisible by model axis {shape['model']}")
        check_spatial(size, len(mc.ch_mult), shape["model"])
    meta = _pixel_meta(params, mc, size, steps, sampler, eta, batch_size, None, "float32", platforms, dtype)
    meta.update(sharded=True, spatial=bool(spatial), mesh=shape)
    if is_main(mesh):
        _write_artifact(path, "pixel", meta)
    barrier(mesh)
    return Path(path)


def _check_mesh(path: PathLike, meta: dict, mesh) -> None:
    want, have = meta["mesh"], _mesh_shape(mesh)
    if have != want:
        raise ValueError(f"{path}: exported for mesh {want}, got {have}")


class ShardedPixelDecompressor(PixelDecompressor):
    """``call(params, z, seed=0, x_T=None) -> images``: the whole batch's
    (batch_size, size, size, img_ch) float32 images on every rank, of which
    this rank sampled its rows (and, spatially sharded, its height slice)."""

    def __init__(self, meta: dict, mesh) -> None:
        super().__init__(meta, rank_device(mesh), mesh)
        self.rows = local_rows(mesh, meta["batch_size"])
        spatial = bool(meta["spatial"])
        self.cut = (self.rows, model_slice(mesh, meta["size"])) if spatial else self.rows
        whole = (meta["batch_size"], meta["size"], meta["size"], meta["img_ch"])
        self.sample = make_decompress_fn(self.mc, meta["size"], meta["steps"], meta["sampler"], meta["eta"],
                                         meta["output"], batch_rows=(whole, self.cut),
                                         spatial=mesh if spatial else None)

    def __call__(self, params: StateDict, z, seed: int = 0, x_T=None) -> torch.Tensor:
        out = super().__call__(params, z, seed, x_T)
        if self.meta["spatial"]:
            out = all_gather_rows(self.mesh, out, dim=1, axis=MODEL_AXIS)
        return all_gather_rows(self.mesh, out)


def load_sharded_decompressor(path: PathLike, mesh) -> ShardedPixelDecompressor:
    """Load a sharded pixel artifact on each rank's device for a mesh of
    the export-time shape (``meta["mesh"]``); every rank calls it alike."""
    meta = _read_artifact(path, "pixel", sharded=True)
    _check_mesh(path, meta, mesh)
    return ShardedPixelDecompressor(meta, mesh)


def export_sharded_sd_decompressor(
    unet_params: StateDict,
    vae_params: StateDict,
    adapter_params: StateDict,
    path: PathLike,
    mesh,
    *,
    unet_cfg: Optional[SDUNetConfig] = None,
    vae_cfg: Optional[VAEConfig] = None,
    size: int = 512,
    steps: int = 30,
    sampler: str = "ddim",
    eta: float = 0.0,
    cfg_batched: Optional[bool] = None,
    batch_size: int = 1,
    quant=None,
    platforms: Optional[Sequence[str]] = None,
    dtype: Union[str, torch.dtype] = "bfloat16",
) -> Path:
    """Write the SD artifact tensor-parallel over ``mesh``: the UNet split
    Megatron-style over the ``model`` axis (``parallel/tp.py``), the batch
    over ``data``, the VAE and adapter replicated; the low-latency SD
    serving shape (B = 1 with CFG, where batching cannot help). The state
    dicts are whole and checked as ``export_sd_decompressor`` checks them.
    Every rank calls it; rank 0 writes the file. ``quant`` is refused:
    tensor parallelism takes no int8."""
    if quant is not None:
        raise ValueError(NO_TP_INT8)
    shape = _mesh_shape(mesh)
    validate_tp(unet_cfg if unet_cfg is not None else SD15_UNET, shape["model"])
    if batch_size % shape["data"]:
        raise ValueError(f"batch_size {batch_size} not divisible by data axis {shape['data']}")
    meta = _sd_meta(unet_params, vae_params, adapter_params, unet_cfg, vae_cfg, None, None, size, steps, sampler,
                    eta, cfg_batched, batch_size, None, platforms, dtype)
    meta.update(sharded=True, mesh=shape)
    if is_main(mesh):
        _write_artifact(path, "sd", meta)
    barrier(mesh)
    return Path(path)


class ShardedSDDecompressor(SDDecompressor):
    """``call(unet_params, vae_params, adapter_params, z, seed=0,
    guidance_scale=5.0, x_T=None) -> images``: the whole batch's images on
    every rank. The parameters are whole state dicts; each rank loads its
    UNet slices (``shard_params_tp``) and samples its data rows with the
    other ranks of its model axis."""

    def __init__(self, meta: dict, mesh) -> None:
        super().__init__(meta, rank_device(mesh), mesh)
        self.rows = self.cut = local_rows(mesh, meta["batch_size"])

    def __call__(self, unet_params: StateDict, vae_params: StateDict, adapter_params: StateDict, z,
                 seed: int = 0, guidance_scale: float = 5.0, x_T=None) -> torch.Tensor:
        out = super().__call__(unet_params, vae_params, adapter_params, z, seed, guidance_scale, x_T)
        return all_gather_rows(self.mesh, out)


def load_sharded_sd_decompressor(path: PathLike, mesh) -> ShardedSDDecompressor:
    """Load a tensor-parallel SD artifact on each rank's device for a mesh
    of the export-time shape; every rank calls it alike."""
    meta = _read_artifact(path, "sd", sharded=True)
    _check_mesh(path, meta, mesh)
    return ShardedSDDecompressor(meta, mesh)


__all__ = [
    "make_decompress_fn", "export_decompressor", "load_decompressor", "PixelDecompressor",
    "make_sd_decompress_fn", "export_sd_decompressor", "load_sd_decompressor", "SDDecompressor",
    "export_sharded_decompressor", "load_sharded_decompressor", "ShardedPixelDecompressor",
    "export_sharded_sd_decompressor", "load_sharded_sd_decompressor", "ShardedSDDecompressor",
    "read_artifact_meta",
]
