"""The port's five ``--data_parallel`` CLIs besides the trainers
(``encode_images`` and its ``--append``, ``encode_images_dino``, ``eval``,
``search_text`` exact and ``--u8``) under two gloo ranks on the CPU
(tests/torch_dp_worker.py ``cli``, one launch), against the same CLIs on
one rank and JAX's.

Tiny fp32 towers (the CLIP config of tests/test_torch_search_cli.py, the
DINOv2 config of tests/test_torch_dino.py), a base-8 U-Net at 16px, a
40-image retrieval store. Checks: rank 0 writes stores byte-equal to the
one-rank CLIs' (the encode batch padded to a multiple of the ranks), whose
codes equal JAX's CLI's; eval prints the one-rank metrics; search prints
the one-rank lines and JAX's; rank 1 prints nothing; a batch that does not
divide, and ``--ivf --data_parallel``, are refused with JAX's messages.
"""

import gzip
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu.encoders.clip import CLIPConfig as JaxConfig
from clip_codec_tpu_torch.codecs import quantizer as tq
from clip_codec_tpu_torch.eval import lpips as tlpips
from clip_codec_tpu_torch.io.store import Store, write_store
from tests.test_torch_clip import random_clip_sd
from tests.test_torch_compress import hf_layout
from tests.test_torch_dino import TINY as DINO
from tests.test_torch_dino import random_hf_dino
from tests.test_torch_eval import _pixel_store
from tests.test_torch_search_cli import CFG as CLIP
from tests.torch_dp_worker import _printed, run_ranks, tiny_towers

torch.set_num_threads(1)


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _images(d: Path, rng, n, corrupt=False):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (30 + i, 36, 3), dtype=np.uint8)).save(d / f"im{i}.png")
    if corrupt:
        (d / "broken.png").write_bytes(b"not an image")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the two ranks' run, then the same argv on one rank here (the
    stores written to a path of the same name, since manifests hold paths)."""
    work = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(2)
    torch.save(hf_layout(random_clip_sd(CLIP, 11)), work / "clip.bin")
    torch.save(random_hf_dino(DINO, 3), work / "dino.bin")
    _images(work / "imgs", rng, 5, corrupt=True)
    _images(work / "more", rng, 3)
    (work / "ev").mkdir()
    weights = _pixel_store(work / "ev", rng, n=5, dim=16)
    torch.save(tlpips.init_params(tlpips.LPIPS(), torch.Generator().manual_seed(0)).state_dict(), work / "lpips.pt")
    # the retrieval store: 40 frames of seeded unit rows with a shared component
    z = rng.standard_normal((40, 16)).astype(np.float32) + 1.0
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    scale, zero = tq.fit_affine(z)
    write_store(work / "ret", z, [str(work / "ret" / f"im{i:02d}.png") for i in range(40)], scale, zero,
                tq.quantize(z, scale, zero).numpy())
    with gzip.open(work / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nt h\nth e</w>\nc a\nca t</w>\n")
    frame = str(sorted((work / "ret").glob("*.clp"))[5])
    base = ["--store_dir", str(work / "ret"), "--device", "cpu", "--k", "7"]
    clip = ["--weights", str(work / "clip.bin"), "--bpe", str(work / "bpe.txt.gz")]
    spec = {
        "clip": CLIP, "dino": DINO,
        "encode": ["--img_dir", str(work / "imgs"), "--out_dir", str(work / "enc"), "--weights",
                   str(work / "clip.bin"), "--device", "cpu", "--batch_size", "3"],
        "append": ["--img_dir", str(work / "more"), "--out_dir", str(work / "enc"), "--weights",
                   str(work / "clip.bin"), "--device", "cpu", "--append"],
        "dino_argv": ["--img_dir", str(work / "imgs"), "--out_dir", str(work / "dino"), "--weights",
                      str(work / "dino.bin"), "--device", "cpu"],
        "eval": ["--store_dir", str(work / "ev"), "--weights", str(weights), "--size", "16", "--steps", "3",
                 "--batch_size", "2", "--device", "cpu", "--seed", "3"],
        "search": [base + ["--query_clp", frame], base + ["--query_clp", frame, "--u8"],
                   base + clip + ["--query", "the cat"], base + clip + ["--query", "the cat", "--u8"]],
    }
    (work / "cli_in.json").write_text(json.dumps(spec))
    env = {"CLIP_CODEC_LPIPS_WEIGHTS": str(work / "lpips.pt"), "CLIP_CODEC_CLIP_WEIGHTS": str(work / "clip.bin")}
    outs = run_ranks("cli", work, env=env)
    for name in ("enc", "dino"):
        (work / name).rename(work / f"{name}_dp")

    from clip_codec_tpu_torch.cli import encode_images, encode_images_dino, search_text
    from clip_codec_tpu_torch.cli import eval as eval_cli

    mp = pytest.MonkeyPatch()
    real_clip, real_dino = encoders.ClipEncoder, encoders.DinoEncoder
    try:
        for k, v in env.items():
            mp.setenv(k, v)
        tiny_towers(spec)
        one = {"encode": _printed(lambda: encode_images.main(spec["encode"])),
               "append": _printed(lambda: encode_images.main(spec["append"])),
               "dino": _printed(lambda: encode_images_dino.main(spec["dino_argv"])),
               "eval": _printed(lambda: eval_cli.main(spec["eval"])),
               "search": [_printed(lambda: search_text.main(argv)) for argv in spec["search"]]}
    finally:
        encoders.ClipEncoder, encoders.DinoEncoder = real_clip, real_dino
        mp.undo()
    return dict(work=work, outs=outs, one=one, spec=spec, env=env)


@pytest.mark.parametrize("name", ["enc", "dino"])
def test_rank_zero_writes_the_one_rank_store(run, name):
    work = run["work"]
    got, want = _files(work / f"{name}_dp"), _files(work / name)
    assert sorted(got) == sorted(want) and len(got) > 3
    for k in want:
        assert got[k] == want[k], k
    n = 8 if name == "enc" else 5  # 5 images (a corrupt file skipped), then 3 appended to the CLIP store
    assert len(Store.open(work / f"{name}_dp")) == n


def test_encode_codes_equal_jax(run, monkeypatch):
    """JAX's encode CLI with the same tiny tower and batch writes the same codes."""
    from clip_codec_tpu.cli.encode_images import main as jax_main

    work = run["work"]
    real = jax_encoders.ClipEncoder
    monkeypatch.setattr(jax_encoders, "ClipEncoder", lambda **kw: real(**kw, cfg=JaxConfig(**CLIP), dtype=jnp.float32))
    argv = [a if a != str(work / "enc") else str(work / "enc_jax") for a in run["spec"]["encode"]]
    argv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
    monkeypatch.setattr(sys, "argv", ["encode_images"] + argv)
    jax_main()
    got = Store.open(work / "enc_dp").read_codes()[:5]
    np.testing.assert_array_equal(got, Store.open(work / "enc_jax").read_codes())


def test_printed_lines_equal_one_rank(run):
    r0, r1 = run["outs"]
    one = run["one"]
    assert r0["encode"][0] == "[parallel] 2 rank(s), backend cpu:gloo (CPU ranks)"  # once, at the group's start
    r0 = {**r0, "encode": r0["encode"][1:]}
    for key in ("encode", "append", "dino", "eval"):
        assert r0[key] == one[key] and r1[key] == [], key
    assert len(one["eval"]) == 4 and all(np.isfinite(float(l.split()[-2 if "PSNR" in l else -1])) for l in one["eval"])
    assert r0["search"] == one["search"] and r1["search"] == [[]] * 4
    assert [len(lines) for lines in one["search"]] == [7] * 4
    assert one["search"][0][0].startswith("1.0000\t")
    assert r0["errors"] == r1["errors"] == ["ValueError: batch_size=3 not divisible by the data-axis size 2"]


def test_search_lines_equal_jax(run, monkeypatch, capsys):
    from clip_codec_tpu.cli.search_text import main as jax_main

    real = jax_encoders.ClipEncoder
    monkeypatch.setattr(jax_encoders, "ClipEncoder", lambda **kw: real(**kw, cfg=JaxConfig(**CLIP), dtype=jnp.float32))
    for argv, got in zip(run["spec"]["search"], run["outs"][0]["search"]):
        argv = [a for a in argv if a not in ("--device", "cpu")]
        monkeypatch.setattr(sys, "argv", ["search_text"] + argv + ["--data_parallel"])
        jax_main()
        assert got == capsys.readouterr().out.splitlines()


def test_refusals_name_jax_messages(run, monkeypatch):
    from clip_codec_tpu_torch.cli import eval as eval_cli
    from clip_codec_tpu_torch.cli import search_text

    argv = run["spec"]["search"][0]
    with pytest.raises(SystemExit, match="--ivf and --data_parallel do not combine"):
        search_text.main(argv + ["--ivf", "--data_parallel"])
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    from clip_codec_tpu_torch.cli import train

    with pytest.raises(SystemExit, match="--distributed needs the launcher's environment"):
        train.main(["--store_dir", str(run["work"]), "--device", "cpu", "--distributed"])
    with pytest.raises(SystemExit, match="reference-parity ddim"):
        eval_cli.main(run["spec"]["eval"] + ["--data_parallel", "--sampler", "ddim_std"])
