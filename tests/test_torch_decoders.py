"""The port's direct decoders (``models/decoders.py``, ``DWConvBlock`` and
``AttnBlock`` in ``models/blocks.py``, ``train/train_decoder.py``) against
the JAX package's, on the CPU at tiny sizes.

The same seeded flax tree goes through JAX's modules and, mapped by
``weights/from_jax.py``, through the port's: outputs within 1e-4 in fp32.
The port's state dicts are in the reference layout: JAX's own converters
(``clip_codec_tpu/weights/convert.py``) map them back to a tree JAX runs to
the same output, and the port's numpy converters equal JAX's exactly. The
inference helper's PIL image is byte-equal to JAX's; one training step's
loss within 1e-5 and its parameters within 1e-4 of JAX's (optax AdamW).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_codec_tpu.models import AttnBlock as JaxAttnBlock
from clip_codec_tpu.models import CLIPCondDecoder as JaxCLIPCondDecoder
from clip_codec_tpu.models import DWConvBlock as JaxDWConvBlock
from clip_codec_tpu.models import FeatureToImageDecoderLite as JaxLite
from clip_codec_tpu.train import train_decoder as jtd
from clip_codec_tpu.weights import convert as jconvert
from clip_codec_tpu_torch.models import AttnBlock, CLIPCondDecoder, DWConvBlock, FeatureToImageDecoderLite
from clip_codec_tpu_torch.train import train_decoder as ttd
from clip_codec_tpu_torch.weights import convert as tconvert
from clip_codec_tpu_torch.weights import from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _tree(module, *args, seed=0):
    """A seeded fp32 tree of ``module``'s structure (``eval_shape`` of its
    init: nothing compiled), scaled so that every layer matters."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _jax(module, tree, *args):
    return np.asarray(module.apply({"params": tree}, *args))


def test_dwconv_block_matches_jax(rng):
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    jm = JaxDWConvBlock(8, 24)
    tree = _tree(jm, jnp.asarray(x))
    m = DWConvBlock(8, 24)
    m.load_state_dict(from_jax.dwconv_state_dict_from_jax(tree), strict=True)
    assert m.gn.num_groups == 8
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), _jax(jm, tree, x), **TOL)


def test_attn_block_matches_jax(rng):
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    h = rng.standard_normal((2, 8)).astype(np.float32)
    jm = JaxAttnBlock(16, heads=4)
    tree = _tree(jm, jnp.asarray(x), jnp.asarray(h))
    m = AttnBlock(16, 8, heads=4)
    m.load_state_dict(from_jax.attn_block_state_dict_from_jax(tree), strict=True)
    got = m(torch.from_numpy(x), torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(got, _jax(jm, tree, x, h), **TOL)


DECODERS = {
    "clip_cond": (lambda: JaxCLIPCondDecoder(in_dim=16, base=32, out_size=64),
                  lambda: CLIPCondDecoder(in_dim=16, base=32, out_size=64),
                  from_jax.clip_cond_decoder_state_dict_from_jax,
                  lambda sd, conv: conv.convert_clip_cond_decoder(sd, base=32, out_size=64)),
    "lite": (lambda: JaxLite(in_dim=16, base=32, out_size=32), lambda: FeatureToImageDecoderLite(16, 32, 32),
             from_jax.lite_decoder_state_dict_from_jax, lambda sd, conv: conv.convert_lite_decoder(sd)),
}


@pytest.mark.parametrize("name", list(DECODERS))
def test_decoder_matches_jax_and_loads_the_reference_layout(name, rng):
    jmake, tmake, to_port, convert = DECODERS[name]
    z = rng.standard_normal((3, 16)).astype(np.float32)
    jm = jmake()
    tree = _tree(jm, jnp.asarray(z))
    m = tmake()
    sd = to_port(tree)
    m.load_state_dict(sd, strict=True)
    got = m(torch.from_numpy(z)).detach().numpy()
    want = _jax(jm, tree, z)
    assert got.shape == want.shape == (3, jm.out_size, jm.out_size, 3)
    np.testing.assert_allclose(got, want, **TOL)
    # the port's state dict is the reference layout: JAX's converter reads it back to the same tree
    back = convert(m.state_dict(), jconvert)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jax.tree_util.tree_map(np.asarray, tree))
    # and the port's numpy converter equals JAX's exactly
    mine = convert(m.state_dict(), tconvert)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, mine, back)


def test_stage_plan_keeps_the_reference_quirk():
    for base, size in ((192, 512), (32, 64), (64, 256)):
        assert CLIPCondDecoder.stage_plan(base, size) == JaxCLIPCondDecoder.stage_plan(base, size)
    assert len(CLIPCondDecoder.stage_plan(192, 512)[0]) == 2


def _store(root: Path, rng, n=4, dim=16):
    """A tiny store: PNGs and .clp frames of random codes."""
    from clip_codec_tpu_torch.io.bitstream import write_bitstream

    root.mkdir(parents=True, exist_ok=True)
    recs = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(root / f"im{i}.png")
        write_bitstream(rng.integers(0, 256, dim, dtype=np.uint8).tobytes(), dim, root / f"im{i}.clp")
        recs.append({"image": str(root / f"im{i}.png"), "bitstream": str(root / f"im{i}.clp")})
    (root / "manifest.json").write_text(json.dumps(recs))
    np.savez(root / "codec_meta.npz", scale=np.full(dim, 1 / 127.5, np.float32),
             zero=np.full(dim, -1.0, np.float32), dim=np.int32(dim))
    return recs


def test_reconstruct_image_from_bitstream_equals_jax(tmp_path, rng):
    recs = _store(tmp_path, rng)
    jm = JaxLite(in_dim=16, base=32, out_size=16)
    tree = _tree(jm, jnp.zeros((1, 16)))
    m = FeatureToImageDecoderLite(16, 32, 16)
    m.load_state_dict(from_jax.lite_decoder_state_dict_from_jax(tree), strict=True)
    np.testing.assert_array_equal(ttd.decode_embedding(recs[0]["bitstream"], tmp_path),
                                  jtd.decode_embedding(recs[0]["bitstream"], tmp_path))
    got = ttd.reconstruct_image_from_bitstream(recs[0]["bitstream"], tmp_path, m)
    want = jtd.reconstruct_image_from_bitstream(recs[0]["bitstream"], tmp_path,
                                                lambda z: jm.apply({"params": tree}, z))
    assert got.size == want.size == (16, 16)
    assert got.tobytes() == want.tobytes()


class _Given:
    """A JAX decoder whose ``init`` returns a given tree (JAX's trainer
    initialises its own; the port's starts from the module it is given)."""

    def __init__(self, module, tree):
        self.module, self.tree = module, tree

    def init(self, *args):
        return {"params": self.tree}

    def apply(self, *args):
        return self.module.apply(*args)


def test_one_training_step_matches_jax(tmp_path, rng):
    """base 64: every GroupNorm group holds two channels or more (with one,
    a conv bias before it has a zero gradient in exact arithmetic, and
    AdamW's first step turns the rounding noise into +-lr)."""
    _store(tmp_path, rng)
    jm = JaxLite(in_dim=16, base=64, out_size=16)
    tree = _tree(jm, jnp.zeros((1, 16)))
    m = FeatureToImageDecoderLite(16, 64, 16)
    m.load_state_dict(from_jax.lite_decoder_state_dict_from_jax(tree), strict=True)
    kw = dict(out_size=16, epochs=1, batch_size=4, lr=1e-3, tv_w=0.1, seed=3)
    jparams, jloss = jtd.train_direct_decoder(tmp_path, _Given(jm, tree), **kw)
    m, loss = ttd.train_direct_decoder(tmp_path, m, **kw, save_path=tmp_path / "lite.pt", device="cpu")
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    got = tconvert.convert_lite_decoder(torch.load(tmp_path / "lite.pt"))
    for (path, a), b, a0 in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_leaves(jparams),
                                jax.tree_util.tree_leaves(tree)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=jax.tree_util.keystr(path))
        assert not np.array_equal(a, np.asarray(a0)), jax.tree_util.keystr(path)  # the step moved it


def test_reconstruct_cli_still_exports_its_helpers():
    from clip_codec_tpu_torch.cli import reconstruct_diffusion as cli

    assert cli.decode_embedding is ttd.decode_embedding and cli.to_pil is ttd.to_pil
