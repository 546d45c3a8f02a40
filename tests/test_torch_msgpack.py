"""The port's reader and writer of flax msgpack checkpoints
(``utils/flax_msgpack.py``, ``utils/checkpoint.py``) and the loaders that
take the JAX package's ``.msgpack`` files, against flax and the JAX package.

Trees written by ``flax.serialization.msgpack_serialize`` (the JAX
package's ``save_params``) load bit-equal, fp32, bf16 and integer arrays,
numpy scalars and a chunked array alike, and the port's writer gives
flax's bytes. A pixel U-Net and an SD adapter loaded from JAX's
``.msgpack`` give JAX's outputs within 1e-4 in fp32; the numpy
``convert_unet`` equals JAX's exactly. The refusals kept on purpose (JAX's
orbax directories and ``.quant.msgpack`` sidecars) say so.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from clip_codec_tpu.models import CLIPCondUNet as JaxUNet
from clip_codec_tpu.models import sd as jsd
from clip_codec_tpu.utils.checkpoint import load_params as jax_load_params
from clip_codec_tpu.utils.checkpoint import save_params as jax_save_params
from clip_codec_tpu.weights.convert import convert_unet as jax_convert_unet
from clip_codec_tpu.weights.convert_sd import convert_sd_adapter, convert_sd_unet, convert_sd_vae
from clip_codec_tpu_torch.codec import ClipCodec
from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.utils import checkpoint as ck
from clip_codec_tpu_torch.utils import flax_msgpack
from clip_codec_tpu_torch.weights import convert as tconvert
from clip_codec_tpu_torch.weights import sd_checkpoint as sdck
from clip_codec_tpu_torch.weights.from_jax import unet_state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(z_dim=8, base=8, ch_mult=(1, 2))


def _tree(rng):
    return {
        "dense": {"kernel": rng.standard_normal((3, 5)).astype(np.float32), "bias": np.zeros(5, np.float32)},
        "bf16": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
        "ints": {"i32": np.arange(-40, 260, dtype=np.int32).reshape(3, 100), "u8": np.arange(7, dtype=np.uint8),
                 "i64": np.array([-2**40, 2**40], np.int64)},
        "scalars": {"f32": np.float32(2.5), "f64": np.float64(-1.25), "i64": np.int64(-3),
                    "bf16": ml_dtypes.bfloat16(0.75)},
        "py": [0, 1, -1, -33, 127, 128, 255, 256, 70000, 2**33, -2**40, 1.5, True, False, None, "s" * 40, b"yy"],
        "step": 12,
        "empty": np.zeros((0, 3), np.float16),
        "many": {f"k{i:02d}": i for i in range(20)},
        "c": 1 + 2j,
    }


def _assert_leaf_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == sorted(want), path
        for k in want:
            _assert_leaf_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_leaf_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_flax_bytes_read_bit_equal_and_written_equal(rng, monkeypatch, chunk):
    """MAX_CHUNK_SIZE made small chunks the arrays over 64 bytes in both writers."""
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    tree = _tree(rng)
    data = serialization.msgpack_serialize(tree)
    if chunk:
        assert b"__msgpack_chunked_array__" in data
    _assert_leaf_equal(flax_msgpack.unpackb(data), tree)
    assert flax_msgpack.packb(tree) == data
    # the port's bf16 tensors are written as JAX's bfloat16 arrays
    port_tree = {"w": torch.from_numpy(tree["bf16"].view(np.int16).copy()).view(torch.bfloat16)}
    assert flax_msgpack.packb(port_tree) == serialization.msgpack_serialize({"w": tree["bf16"]})
    restored = serialization.msgpack_restore(flax_msgpack.packb(tree))
    np.testing.assert_array_equal(restored["ints"]["i32"], tree["ints"]["i32"])


def test_reader_refuses_bad_data():
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(serialization.msgpack_serialize({"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="not defined"):
        flax_msgpack.unpackb(b"\xc1")
    with pytest.raises(TypeError, match="tuple"):
        flax_msgpack.packb({"a": (1, 2)})


def test_save_and_load_params_match_jax(rng, tmp_path):
    tree = {"p": {"kernel": rng.standard_normal((2, 3)).astype(np.float32)}, "s": np.float32(1.5)}
    jax_save_params(tmp_path / "jax.msgpack", tree)
    ck.save_params(tmp_path / "port.msgpack", tree)
    assert (tmp_path / "jax.msgpack").read_bytes() == (tmp_path / "port.msgpack").read_bytes()
    _assert_leaf_equal(ck.load_params(tmp_path / "jax.msgpack"), jax_load_params(tmp_path / "jax.msgpack"))


@pytest.fixture(scope="module")
def jax_unet():
    return JaxUNet(**CFG, fused_pallas=False).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                                     jnp.zeros((1, 8)), jnp.zeros((1,), jnp.int32))["params"]


def _eps_jax(params, x, z, t):
    return np.asarray(JaxUNet(**CFG, fused_pallas=False).apply({"params": params}, x, z, t))


def _eps_port(sd, x, z, t):
    net = CLIPCondUNet(**CFG, time_dim=256, fused_pallas=False)
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return net.eval()(torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(t)).numpy()


def test_unet_from_jax_msgpack_gives_jax_outputs(rng, tmp_path, jax_unet):
    """The final, EMA and per-epoch files of JAX's trainer, each its own tree."""
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    t = np.array([3, 40], np.int32)
    for i, name in enumerate(("diffusion_unet_final", "diffusion_unet_ema_final", "diffusion_unet_ep2")):
        params = jax.tree_util.tree_map(lambda a: np.asarray(a) * (1.0 + 0.1 * i), jax_unet)
        path = jax_save_params(tmp_path / f"{name}.msgpack", params)
        sd = ck.load_unet_checkpoint(path)
        for k, v in unet_state_dict_from_jax(params).items():
            assert torch.equal(sd[k], v), k
        np.testing.assert_allclose(_eps_port(sd, x, z, t), _eps_jax(params, x, z, t), rtol=1e-4, atol=1e-4)


def test_clip_codec_loads_a_store_holding_only_the_msgpack(rng, tmp_path, jax_unet):
    from clip_codec_tpu.codec import ClipCodec as JaxCodec

    np.savez(tmp_path / "codec_meta.npz", scale=np.full(8, 2 / 255, np.float32), zero=np.full(8, -1.0, np.float32),
             dim=np.int32(8))
    jax_save_params(tmp_path / "diffusion_unet_final.msgpack", jax_unet)
    with pytest.warns(UserWarning, match="inferred base=8"):
        codec = ClipCodec.load(tmp_path, device="cpu", dtype=torch.float32)
    jcodec = JaxCodec.load(tmp_path)
    assert (codec.mc.base, codec.mc.ch_mult, codec.mc.z_dim) == (jcodec.mc.base, tuple(jcodec.mc.ch_mult), 8)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    t = np.array([5, 900], np.int32)
    with torch.no_grad():
        got = codec.net(torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, _eps_jax(jax_unet, x, z, t), rtol=2e-4, atol=2e-4)
    img = codec.decompress_codes(np.full((1, 8), 128, np.uint8), size=16, steps=2, seed=0)
    assert img.shape == (1, 16, 16, 3) and np.isfinite(img).all()
    # a .pt beside it is preferred, as before
    torch.save(codec.net.state_dict(), tmp_path / "diffusion_unet_final.pt")
    (tmp_path / "diffusion_unet_final.msgpack").write_bytes(b"")  # would raise if it were read
    with pytest.warns(UserWarning, match="inferred"):
        ClipCodec.load(tmp_path, device="cpu")


def test_numpy_convert_unet_equals_jax(jax_unet):
    net = init_params(CLIPCondUNet(**CFG, time_dim=256), torch.Generator().manual_seed(3))
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}  # a prefix both strip
    mine, want = tconvert.convert_unet(sd, CFG["ch_mult"]), jax_convert_unet(sd, CFG["ch_mult"])
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, want)
    # the port's writer then gives the bytes JAX's save_params gives for JAX's tree
    assert flax_msgpack.packb(mine) == serialization.msgpack_serialize(want)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jax_unet))


def _sd_modules():
    gen = torch.Generator().manual_seed(5)
    unet = init_params(tsd.SDUNet(tsd.SDUNetConfig(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2,
                                                   freq_dim=8)), gen)
    vae = init_params(tsd.AutoencoderKL(tsd.VAEConfig(block_out=(8, 16), layers_per_block=1, latent_ch=4)), gen)
    adapter = init_params(tsd.SDClipAdapter(in_dim=32, ctx_dim=16, n_tokens=8), gen)
    with torch.no_grad():
        for m in (unet, vae, adapter):
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return unet.eval(), vae.eval(), adapter.eval()


def test_sd_files_from_jax_msgpack(rng, tmp_path):
    """JAX's converted UNet/VAE trees and its adapter tree, through the SD
    CLI's loader (what --adapter, serve and export_decoder --sd call)."""
    from clip_codec_tpu_torch.cli.reconstruct_sd_diffusion import load_decoder

    unet, vae, adapter = _sd_modules()
    jax_save_params(tmp_path / "unet.msgpack", convert_sd_unet(unet.state_dict(), n_blocks=2, layers_per_block=1))
    jax_save_params(tmp_path / "vae.msgpack", convert_sd_vae(vae.state_dict(), n_blocks=2, enc_layers=1))
    jtree = convert_sd_adapter({"adapter": adapter.state_dict()})
    jax_save_params(tmp_path / "sd_adapter_final.msgpack", jtree)
    dec = load_decoder(tmp_path / "unet.msgpack", tmp_path / "vae.msgpack", tmp_path / "sd_adapter_final.msgpack",
                       "cpu", heads=2)
    for mine, want in ((dec.unet, unet), (dec.vae, vae), (dec.adapter, adapter)):
        for k, v in want.state_dict().items():
            assert torch.equal(mine.state_dict()[k], v), k
    z = rng.standard_normal((3, 32)).astype(np.float32)
    want = np.asarray(jsd.SDClipAdapter(in_dim=32, ctx_dim=16, n_tokens=8).apply({"params": jtree}, jnp.asarray(z)))
    with torch.no_grad():
        got = dec.adapter(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert sdck.load_adapter(tmp_path / "sd_adapter_final.msgpack").keys() == adapter.state_dict().keys()
    # the port's numpy adapter converter writes JAX's tree, byte for byte through save_params
    mine = tconvert.convert_sd_adapter({"adapter": adapter.state_dict()})
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, jtree)
    ck.save_params(tmp_path / "port_adapter.msgpack", mine)
    assert (tmp_path / "port_adapter.msgpack").read_bytes() == (tmp_path / "sd_adapter_final.msgpack").read_bytes()


def test_refusals_kept_on_purpose(tmp_path):
    from clip_codec_tpu_torch.ops.int8 import read_quant

    (tmp_path / "dec.jaxprog.quant.msgpack").write_bytes(serialization.msgpack_serialize({"a": np.ones(1)}))
    with pytest.raises(ValueError, match="JAX int8 calibration sidecar"):
        ck.load_params(tmp_path / "dec.jaxprog.quant.msgpack")
    with pytest.raises(ValueError, match="JAX int8 calibration sidecar"):
        read_quant(tmp_path / "dec.jaxprog.quant.msgpack")
    (tmp_path / "orbax" / "1").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax training state"):
        ck.TrainCheckpointer(tmp_path / "state").restore()
    assert ck.TrainCheckpointer(tmp_path / "other" / "state").restore() is None
    with pytest.raises(ValueError, match="load_unet_checkpoint"):
        ck.load_state_dict(tmp_path / "dec.jaxprog.quant.msgpack")
    with pytest.raises(ValueError, match="load_unet / load_vae / load_adapter"):
        sdck.read_checkpoint(tmp_path / "dec.jaxprog.quant.msgpack")
