"""The port's ``cli/search_text.py`` against the JAX package's on one tiny
store, on the CPU: the printed ``score\\tpath`` lines must be equal.

``--query_clp`` runs in all four index forms (exact, ``--u8``, ``--ivf``,
``--u8 --ivf``); ``--query`` and ``--query_image`` run through a tiny
random CLIP tower (HuggingFace names, which both packages read) and a
synthetic merges file, as tests/test_torch_clip.py builds them. Then the
refusals: ``--ivf --data_parallel`` with JAX's message, and ``--device
cuda`` without a card (``--data_parallel`` runs in
tests/test_torch_parallel_cli.py).
"""

import gzip
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu.encoders.clip import CLIPConfig as JaxConfig
from clip_codec_tpu_torch.codecs import quantizer as tq
from clip_codec_tpu_torch.encoders.clip import CLIPConfig
from clip_codec_tpu_torch.io import store as tstore
from clip_codec_tpu_torch.io.bitstream import compress_frame
from tests.test_torch_clip import TINY, random_clip_sd
from tests.test_torch_compress import hf_layout

torch.set_num_threads(1)

# the synthetic merges' vocabulary (512 byte tokens, 10 merges, 2 specials) fits
CFG = {**TINY, "vocab_size": 600, "eos_token_id": 599}
N_IMAGES = 40
FORMS = {"exact": [], "u8": ["--u8"], "ivf": ["--ivf"], "ivf_u8": ["--u8", "--ivf"]}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """40 seeded PNGs and their frames: embeddings from a fixed numpy map of
    the pixels with a shared component, so neighbours are close, as a real
    tower's are."""
    root = tmp_path_factory.mktemp("search")
    rng = np.random.default_rng(7)
    paths, pix = [], []
    for i in range(N_IMAGES):
        img = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
        paths.append(str(root / f"im{i:02d}.png"))
        Image.fromarray(img).save(paths[-1])
        pix.append(img.reshape(-1).astype(np.float64))
    z = np.stack(pix) @ rng.standard_normal((40 * 36 * 3, 16)) / 2e3 + 1.0
    z = (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)
    scale, zero = tq.fit_affine(z)
    tstore.write_store(root / "store", z, paths, scale, zero, tq.quantize(z, scale, zero).numpy())
    return root


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    p = tmp_path_factory.mktemp("clip") / "tiny_hf.bin"
    torch.save(hf_layout(random_clip_sd(CFG, 11)), p)
    return str(p)


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    merges = ["t h", "th e</w>", "h e", "c a", "ca t</w>", "d o", "do g</w>", "c af", "é </w>", "Ã ©"]
    p = tmp_path_factory.mktemp("bpe") / "bpe.txt.gz"
    with gzip.open(p, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(p)


@pytest.fixture
def tiny_towers(monkeypatch):
    real_j, real_t = jax_encoders.ClipEncoder, encoders.ClipEncoder
    monkeypatch.setattr(jax_encoders, "ClipEncoder",
                        lambda **kw: real_j(**kw, cfg=JaxConfig(**CFG), dtype=jnp.float32))
    monkeypatch.setattr(encoders, "ClipEncoder",
                        lambda **kw: real_t(**kw, cfg=CLIPConfig(**CFG), dtype=torch.float32))


def _both(argv, monkeypatch, capsys):
    """The JAX CLI's printed lines, then the port's (``--device cpu``)."""
    from clip_codec_tpu.cli.search_text import main as jax_main
    from clip_codec_tpu_torch.cli.search_text import main

    monkeypatch.setattr(sys, "argv", ["search_text"] + argv)
    jax_main()
    want = capsys.readouterr().out.splitlines()
    main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines(), want


@pytest.mark.parametrize("form", list(FORMS))
def test_query_clp_prints_jax_lines(store, form, monkeypatch, capsys):
    """A store frame as the query, k = 12, IVF at nlist 6 probing 2 lists: the
    frame's own image first at 1.0000, the lines equal JAX's."""
    frame = sorted((store / "store").glob("*.clp"))[5]
    argv = ["--store_dir", str(store / "store"), "--query_clp", str(frame), "--k", "12", "--nlist", "6",
            "--nprobe", "2"] + FORMS[form]
    got, want = _both(argv, monkeypatch, capsys)
    assert got == want
    assert 0 < len(got) <= 12 and got[0] == f"1.0000\t{store / frame.stem}.png"


@pytest.mark.parametrize("form", ["exact", "ivf_u8"])
def test_text_and_image_queries_print_jax_lines(store, ckpt, bpe, tiny_towers, form, monkeypatch, capsys):
    base = ["--store_dir", str(store / "store"), "--weights", ckpt, "--bpe", bpe, "--nlist", "5"] + FORMS[form]
    got, want = _both(base + ["--query", "the cat and the dog"], monkeypatch, capsys)
    assert got == want and len(got) == 10
    got, want = _both(base + ["--query_image", str(store / "im03.png"), "--k", "4"], monkeypatch, capsys)
    assert got == want and len(got) == 4


def test_refusals(store, tmp_path, monkeypatch, capsys):
    from clip_codec_tpu.cli.search_text import main as jax_main
    from clip_codec_tpu_torch.cli.search_text import main

    frame = str(next((store / "store").glob("*.clp")))
    base = ["--store_dir", str(store / "store"), "--query_clp", frame, "--device", "cpu"]
    argv = base[:-2] + ["--ivf", "--data_parallel"]
    monkeypatch.setattr(sys, "argv", ["search_text"] + argv)
    with pytest.raises(SystemExit) as want:
        jax_main()
    with pytest.raises(SystemExit) as got:
        main(argv)
    assert str(got.value) == str(want.value) and "do not combine" in str(got.value)
    (tmp_path / "short.clp").write_bytes(compress_frame(bytes(4)))
    with pytest.raises(SystemExit, match="frame is 4-d but the store's codec is 16-d"):
        main(["--store_dir", str(store / "store"), "--query_clp", str(tmp_path / "short.clp"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(base[:-2])
