"""The port's CLIP towers (clip_codec_tpu_torch/encoders, weights/convert_clip.py)
against the JAX package on the same seeded inputs, on the CPU.

Weights are a random openai-layout state dict drawn with numpy: JAX reads
it through ``convert_clip_openai``, the port loads it as it is. At a tiny
config (image 32, patch 8, width 32, depth 2, heads 2): the transformer
block with and without the causal mask and both towers within 1e-4 in
fp32, the bf16 towers within ||delta|| / ||ref|| < 2e-2 (the JAX package's
bf16 bound) of JAX's bf16 and of fp32; the weight maps, preprocessing, the normalization table and the
tokens bit-equal; ``embed_m11_images`` within 1e-4 and the CLIP-alignment
loss within 1e-5 of JAX's, its gradient zero under the reference's
stop-grad and within 1e-4 of JAX's without it.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clip_codec_tpu.encoders import clip as jclip
from clip_codec_tpu.encoders import transformer as jtr
from clip_codec_tpu.encoders.tokenizer import CLIPTokenizer as JaxTokenizer
from clip_codec_tpu.weights.convert_clip import convert_clip_openai, load_clip_params
from clip_codec_tpu_torch.encoders import clip as tclip
from clip_codec_tpu_torch.encoders import transformer as ttr
from clip_codec_tpu_torch.encoders.tokenizer import CLIPTokenizer
from clip_codec_tpu_torch.weights.convert_clip import load_clip_state_dict
from clip_codec_tpu_torch.weights.from_jax import clip_state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(image_size=32, patch_size=8, vision_dim=32, vision_depth=2, vision_heads=2, vision_mlp=64,
            text_dim=32, text_depth=2, text_heads=2, text_mlp=64, vocab_size=100, context_length=12,
            embed_dim=16, eos_token_id=99)
TOL = dict(rtol=1e-4, atol=1e-4)


def random_clip_sd(cfg: dict, seed: int) -> dict:
    """A random openai-layout CLIP state dict (fp32 CPU tensors): LayerNorm
    scales near 1, small biases, weights with unit-variance outputs."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in tclip.CLIPModel(tclip.CLIPConfig(**cfg)).state_dict().items()}
    out = {}
    for k, shp in shapes.items():
        n = rng.standard_normal(shp)
        if ".ln_" in f".{k}" and k.endswith("weight"):
            a = 1.0 + 0.1 * n
        elif k.endswith("bias"):
            a = 0.05 * n
        elif k in ("visual.proj", "text_projection"):
            a = n / np.sqrt(shp[0])
        elif k.endswith(("embedding", "embedding.weight")):
            a = 0.5 * n
        else:  # (out, in) linear or (out, 3, p, p) conv weights
            a = n / np.sqrt(np.prod(shp[1:]))
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def jax_params(sd: dict, cfg: dict) -> dict:
    np_sd = {k: v.numpy() for k, v in sd.items()}
    return {"params": convert_clip_openai(np_sd, cfg["vision_depth"], cfg["text_depth"], cfg["vision_dim"],
                                          cfg["text_dim"])}


def port_model(sd: dict, cfg: dict, dtype=torch.float32) -> tclip.CLIPModel:
    m = tclip.CLIPModel(tclip.CLIPConfig(**cfg), dtype=dtype)
    m.load_state_dict(sd, strict=True)
    return m.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def sd():
    return random_clip_sd(TINY, 0)


def _tokens(rng, B, L, eot=99):
    """Token ids below the EOT with the EOT at varied positions, zeros after."""
    t = rng.integers(1, eot, (B, L)).astype(np.int32)
    for i, e in enumerate(rng.integers(1, L, B)):
        t[i, e] = eot
        t[i, e + 1:] = 0
    return t


@pytest.mark.parametrize("causal", [False, True], ids=["vision_block", "causal_block"])
def test_transformer_block_matches_jax(sd, rng, causal):
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    mask = np.triu(np.full((7, 7), -np.inf, np.float32), 1) if causal else None
    p = jax_params(sd, TINY)["params"]["text" if causal else "visual"]["encoder"]["block_1"]
    want = jtr.TransformerBlock(32, 2, 64).apply({"params": p}, jnp.asarray(x),
                                                 None if mask is None else jnp.asarray(mask)[None, None])
    blk = ttr.TransformerBlock(32, 2, 64)
    pre = ("transformer" if causal else "visual.transformer") + ".resblocks.1."
    blk.load_state_dict({k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}, strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_towers_match_jax(sd, rng, dtype):
    """Both towers at the tiny config: fp32 within 1e-4 elementwise; bf16
    within ||delta|| / ||ref|| < 2e-2 of JAX's bf16 towers and of the fp32
    towers (both bf16 paths sit ~0.7-0.9e-2 from fp32 here: the rounding of
    a random-weight network, not the same bits)."""
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tok = _tokens(rng, 3, 12)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jm, params = jclip.CLIPModel(jclip.CLIPConfig(**TINY), dtype=jdt), jax_params(sd, TINY)
    want = [np.asarray(jm.apply(params, jnp.asarray(x), method=jclip.CLIPModel.encode_image), np.float32),
            np.asarray(jm.apply(params, jnp.asarray(tok), method=jclip.CLIPModel.encode_text), np.float32)]
    m = port_model(sd, TINY, tdt)
    got = [m.encode_image(torch.from_numpy(x)), m.encode_text(torch.from_numpy(tok))]
    assert all(g.dtype == tdt and g.shape == (3, 16) for g in got)
    got = [g.float().numpy() for g in got]
    if dtype == "fp32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
        return
    f32 = port_model(sd, TINY)
    ref = [f32.encode_image(torch.from_numpy(x)).numpy(), f32.encode_text(torch.from_numpy(tok)).numpy()]
    for g, w, r in zip(got, want, ref):
        assert _rel(g, w) < 2e-2 and _rel(g, r) < 2e-2, (_rel(g, w), _rel(g, r))


def test_text_feature_is_taken_at_the_first_eot(sd, rng):
    """argmax(tokens): the first position of the largest id, as JAX takes it."""
    tok = _tokens(rng, 2, 12)
    tok[0, 10] = 99  # a second EOT after the first
    params = jax_params(sd, TINY)
    want = jclip.CLIPModel(jclip.CLIPConfig(**TINY)).apply(params, jnp.asarray(tok),
                                                          method=jclip.CLIPModel.encode_text)
    got = port_model(sd, TINY).encode_text(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_state_dict_round_trips_through_jax(sd):
    back = clip_state_dict_from_jax(jax_params(sd, TINY))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_openai_checkpoint_loads_as_it_is(sd, tmp_path):
    """The openai layout loads unchanged, its unused entries dropped; a
    missing tensor fails the strict load."""
    extra = dict(sd, logit_scale=torch.tensor(4.6), input_resolution=torch.tensor(32))
    torch.save({k: v.half() if k == "visual.proj" else v for k, v in extra.items()}, tmp_path / "ck.pt")
    got = load_clip_state_dict(tmp_path / "ck.pt")
    assert set(got) == set(sd)
    np.testing.assert_array_equal(got["visual.proj"].numpy(), sd["visual.proj"].half().float().numpy())
    port_model(got, TINY)
    del got["ln_final.bias"]
    with pytest.raises(RuntimeError, match="ln_final.bias"):
        port_model(got, TINY)


def test_hf_checkpoint_maps_as_jax_reads_it(tmp_path):
    """A tiny HuggingFace CLIPModel: the port's HF -> openai map equals
    JAX's ``load_clip_params`` tree brought back through the inverse map."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.CLIPModel(transformers.CLIPConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                           image_size=32, patch_size=8, hidden_act="quick_gelu"),
        text_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                         vocab_size=100, max_position_embeddings=12, hidden_act="quick_gelu", eos_token_id=99),
        projection_dim=16))
    torch.save(hf.state_dict(), tmp_path / "hf.bin")
    got = load_clip_state_dict(tmp_path / "hf.bin")
    want = clip_state_dict_from_jax(load_clip_params(str(tmp_path / "hf.bin"), 2, 2))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    port_model(got, TINY)


@pytest.mark.parametrize("size,mode", [((35, 32), "RGB"), ((32, 35), "RGB"), ((40, 50), "L"), ((50, 40), "P"),
                                       ((31, 67), "RGBA"), ((32, 32), "RGB"), ((257, 229), "RGB")])
def test_preprocessing_is_bit_equal(rng, size, mode):
    """Odd sizes (35 - 32 = 3: the crop's round-half-even case), other
    modes; the u8 path through the port's device gather equals the host
    float path bit for bit."""
    img = Image.fromarray(rng.integers(0, 256, size[::-1] + (3,), dtype=np.uint8)).convert(mode)
    u8 = tclip.preprocess_pil_u8(img, 32)
    np.testing.assert_array_equal(u8, jclip.preprocess_pil_u8(img, 32))
    f32 = tclip.preprocess_pil(img, 32)
    np.testing.assert_array_equal(f32, jclip.preprocess_pil(img, 32))
    table = torch.from_numpy(tclip.clip_normalize_table())
    np.testing.assert_array_equal(tclip.normalize_u8(torch.from_numpy(u8.copy()), table).numpy(), f32)


def test_normalize_table_equals_jax_and_host_math():
    t = tclip.clip_normalize_table()
    np.testing.assert_array_equal(t, jclip.clip_normalize_table())
    v = (np.arange(256, dtype=np.float32) / 255.0)[:, None]
    np.testing.assert_array_equal(t, (v - tclip.CLIP_MEAN) / tclip.CLIP_STD)


@pytest.fixture
def bpe(tmp_path):
    merges = ["t h", "th e</w>", "h e", "c a", "ca t</w>", "d o", "do g</w>", "c af", "é </w>", "Ã ©"]
    p = tmp_path / "bpe.txt.gz"
    with gzip.open(p, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(p)


def test_tokens_equal_jax(bpe):
    texts = ["the cat", "The  DOG!", "CafÃ© doesnÃ¢â‚¬â„¢t", "fish &amp;amp; chips", "ﬁne “quotes”",
             "ＦＵＬＬ width", "naïve café 42", " ".join(["the cat"] * 50), "", "<|endoftext|> x"]
    want = JaxTokenizer(bpe, 77)(texts)
    got = CLIPTokenizer(bpe, 77)(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, want)
    assert got[7, -1] == CLIPTokenizer(bpe).eot  # truncated, EOT kept last


ALIGN = dict(TINY, image_size=224, patch_size=56)  # embed_m11_images resizes to 224


def test_embed_m11_images_matches_jax(rng):
    sd = random_clip_sd(ALIGN, 1)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = jclip.embed_m11_images(jclip.CLIPModel(jclip.CLIPConfig(**ALIGN)), jax_params(sd, ALIGN),
                                  jnp.asarray(x))
    got = tclip.embed_m11_images(port_model(sd, ALIGN), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stop_grad", [True, False], ids=["reference_stop_grad", "differentiable"])
def test_clip_alignment_on_the_tower_matches_jax(rng, stop_grad):
    """The trainer's CLIP term on the tiny tower: value within 1e-5 and, as
    the reference has it, no gradient under stop-grad; with the
    differentiable term, the input gradient within 1e-4."""
    from clip_codec_tpu.train.losses import clip_alignment as jax_align
    from clip_codec_tpu_torch.train.losses import clip_alignment

    sd = random_clip_sd(ALIGN, 2)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    jm, params = jclip.CLIPModel(jclip.CLIPConfig(**ALIGN)), jax_params(sd, ALIGN)
    f = lambda xx: jnp.sum(jax_align(xx, jnp.asarray(z), lambda im: jclip.embed_m11_images(jm, params, im),
                                     stop_grad) * jnp.array([1.0, 2.0]))
    want, gx = jax.value_and_grad(f)(jnp.asarray(x))
    m = port_model(sd, ALIGN)
    tx = torch.from_numpy(x).requires_grad_(True)
    per = clip_alignment(tx, torch.from_numpy(z), lambda im: tclip.embed_m11_images(m, im), stop_grad)
    got = (per * torch.tensor([1.0, 2.0])).sum()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    if stop_grad:
        assert not got.requires_grad and not np.any(np.asarray(gx))
    else:
        got.backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4 * np.abs(gx).max())


def test_flops_count_matches_torchs_count(sd, rng):
    """``vision_flops`` against torch's own count of the tower's products."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        port_model(sd, TINY).encode_image(torch.from_numpy(rng.standard_normal((3, 32, 32, 3)).astype(np.float32)))
    assert tclip.vision_flops(tclip.CLIPConfig(**TINY), 3) == fc.get_total_flops()
