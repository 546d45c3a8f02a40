"""The port's HTTP server (clip_codec_tpu_torch/serve.py) against the JAX
package's (clip_codec_tpu/serve.py), through real sockets on the CPU.

One store written by the JAX package (6 random 16-d embeddings, a tiny U-Net
as a msgpack for JAX and the same params as a ``.pt`` for the port) serves
from both packages at once, each from its own artifact (16px, 2 steps, batch
1). The same requests go to both: statuses equal, JSON equal (``/embed``
within 1e-6, search scores within 1e-5, paths equal). Where an error text
comes from a package's own loader (the CLIP weights' message, PIL's), both
name the same variable or exception. Then what only the port's server runs
on the CPU here: the micro-batcher, seeds, the SD artifact behind
``/decompress_sd``, and a process with no jax.
"""

import http.client
import io
import json
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import clip_codec_tpu.encoders as jax_encoders
import clip_codec_tpu_torch.encoders as encoders
from clip_codec_tpu import deploy as jdeploy
from clip_codec_tpu import serve as jserve
from clip_codec_tpu.codec import ClipCodec as JaxCodec
from clip_codec_tpu.codecs.quantizer import fit_affine, quantize
from clip_codec_tpu.io.bitstream import compress_frame
from clip_codec_tpu.io.store import write_store
from clip_codec_tpu.utils.checkpoint import save_params
from clip_codec_tpu.utils.config import ModelConfig as JaxModelConfig
from clip_codec_tpu.weights.export import save_torch_unet
from clip_codec_tpu_torch import deploy, serve
from clip_codec_tpu_torch.codec import ClipCodec
from clip_codec_tpu_torch.models import init_params
from clip_codec_tpu_torch.models import sd as tsd
from clip_codec_tpu_torch.ops import int8 as q8
from clip_codec_tpu_torch.utils.config import ModelConfig
from tests.test_torch_deploy import jax_unet_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIM, N = 16, 6
CFG = dict(z_dim=DIM, base=8, ch_mult=(1, 2))
MC = dict(**CFG, timesteps=50, schedule="linear")
STATICS = dict(size=16, steps=2, batch_size=1)


def _store(root: Path, seed: int = 0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, DIM)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    scale, zero = fit_affine(feats)
    q = np.asarray(quantize(feats, scale, zero))
    write_store(root, feats, [f"img{i}.png" for i in range(N)], np.asarray(scale), np.asarray(zero), q)
    return feats, q


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv.server_address


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The JAX and the port's servers over one store, each behind its own
    batch-1 artifact of the same U-Net."""
    root = tmp_path_factory.mktemp("serve")
    store = root / "store"
    feats, q = _store(store)
    params = jax_unet_params(CFG, 0)
    ckpt = root / "ckpt"
    mc = JaxModelConfig(**MC)
    mc.save(ckpt)
    jw = save_params(ckpt / "unet.msgpack", params)
    tw = ckpt / "unet.pt"
    save_torch_unet(str(tw), params, CFG["ch_mult"])
    jart = jdeploy.export_decompressor(params, mc, root / "dec.jaxprog", **STATICS)
    tart = deploy.export_decompressor(torch.load(tw), ModelConfig(**MC), root / "dec.torchprog", platforms=["cpu"],
                                      **STATICS)
    jsrv = jserve.serve(str(store), weights=str(jw), port=0, artifact=str(jart))
    tsrv = serve.serve(str(store), weights=str(tw), port=0, artifact=str(tart), device="cpu")
    yield dict(jax=_start(jsrv), port=_start(tsrv), q=q, feats=feats, store=store, root=root, weights=tw,
               artifact=tart)
    jsrv.shutdown()
    tsrv.shutdown()


def _png(color=(100, 50, 25)) -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", (16, 16), color).save(buf, format="PNG")
    return buf.getvalue()


def _same(servers, method, path, body=None):
    """Both servers' (status, content type, body) for one request; statuses
    and content types equal."""
    j = _request(servers["jax"], method, path, body)
    t = _request(servers["port"], method, path, body)
    assert (t[0], t[1]) == (j[0], j[1]), (path, t, j)
    return j, t


def _hits_equal(jd, td):
    jr, tr = json.loads(jd)["results"], json.loads(td)["results"]
    assert [h["path"] for h in tr] == [h["path"] for h in jr]
    np.testing.assert_allclose([h["score"] for h in tr], [h["score"] for h in jr], rtol=0, atol=1e-5)
    return tr


CASES = {
    "healthz": ("GET", "/healthz", None),
    "embed": ("POST", "/embed", "frame 0"),
    "embed_garbage": ("POST", "/embed", b"garbage"),
    "embed_bomb": ("POST", "/embed", "bomb"),
    "search_without_q": ("GET", "/search", None),
    "unknown_get": ("GET", "/nope", None),
    "unknown_post": ("POST", "/nope", b""),
    "statics_steps": ("POST", "/decompress?steps=50", "frame 2"),
    "statics_several": ("POST", "/decompress?size=32&sampler=dpmpp&eta=0.5", "frame 2"),
    "statics_sd": ("POST", "/decompress_sd?steps=3", "frame 2"),
    "bad_format": ("POST", "/decompress?format=gif", "frame 2"),
    "sd_unconfigured": ("POST", "/decompress_sd", "frame 0"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_same_status_and_json_as_jax(servers, case):
    method, path, body = CASES[case]
    if body == "bomb":
        body = compress_frame(b"\x00" * (64 << 20))
    elif isinstance(body, str):
        body = compress_frame(servers["q"][int(body.split()[1])].tobytes())
    (js, _, jd), (ts, _, td) = _same(servers, method, path, body)
    jo, to = json.loads(jd), json.loads(td)
    if case == "embed":
        assert js == 200
        np.testing.assert_allclose(to["embedding"], jo["embedding"], rtol=0, atol=1e-6)
        assert abs(np.linalg.norm(to["embedding"]) - 1.0) < 1e-4
    else:
        assert to == jo
    assert js == {"healthz": 200, "embed": 200, "embed_garbage": 400, "embed_bomb": 400, "search_without_q": 400,
                  "unknown_get": 404, "unknown_post": 404, "statics_steps": 412, "statics_several": 412,
                  "statics_sd": 503, "bad_format": 400, "sd_unconfigured": 503}[case]
    if case == "embed_bomb":
        assert "bomb" in to["error"]


def test_oversized_body_is_413_in_both(servers):
    out = []
    for addr in (servers["jax"], servers["port"]):
        conn = http.client.HTTPConnection(*addr, timeout=120)
        conn.putrequest("POST", "/embed")
        conn.putheader("Content-Length", str(1 << 31))
        conn.endheaders()
        resp = conn.getresponse()
        out.append((resp.status, json.loads(resp.read())))
        conn.close()
    assert out[0] == out[1] and out[0][0] == 413 and "limit" in out[0][1]["error"]


def test_early_answers_read_the_body_first(servers):
    """A 412, 400 and 404 sent before the body is used: the server still
    reads the whole body before it closes, so a client that sent a large one
    gets its answer (closing over unread bytes resets the connection)."""
    body = bytes(4 << 20)
    for path, status in (("/decompress?steps=10", 412), ("/decompress?format=gif", 400), ("/nowhere", 404)):
        for _ in range(3):
            got, ctype, data = _request(servers["port"], "POST", path, body)
            assert (got, ctype) == (status, "application/json") and "error" in json.loads(data)


def test_weight_gated_paths_answer_503_then_search(servers, monkeypatch):
    """/compress and /search without CLIP weights: 503 from both, each
    message naming the variable; then /search with both text towers stubbed
    to one store row: the same hits."""
    monkeypatch.delenv("CLIP_CODEC_CLIP_WEIGHTS", raising=False)
    for method, path, body in (("POST", "/compress", _png()), ("GET", "/search?q=cat", None)):
        (js, _, jd), (ts, _, td) = _same(servers, method, path, body)
        assert js == 503
        for d in (jd, td):
            assert "CLIP_CODEC_CLIP_WEIGHTS" in json.loads(d)["error"]
    row = servers["feats"][3:4]

    class _Stub:
        def __init__(self, **kw):
            pass

        def encode_text(self, text):
            return row.copy()

    monkeypatch.setattr(jax_encoders, "ClipEncoder", _Stub)
    monkeypatch.setattr(encoders, "ClipEncoder", _Stub)
    (js, _, jd), (_, _, td) = _same(servers, "GET", "/search?q=cat&k=3")
    assert js == 200
    hits = _hits_equal(jd, td)
    assert hits[0]["path"] == "img3.png" and len(hits) == 3


def test_search_image_matches_jax(servers):
    blob = compress_frame(servers["q"][1].tobytes())
    (js, _, jd), (_, _, td) = _same(servers, "POST", "/search_image?k=3", blob)
    assert js == 200
    hits = _hits_equal(jd, td)
    assert hits[0]["path"] == "img1.png" and hits[0]["score"] > 0.99
    (js, _, jd), (_, _, td) = _same(servers, "POST", "/search_image", b"not an image")
    assert js == 400
    # PIL's text names the BytesIO object's address: the exception's name is what is shared
    assert json.loads(td)["error"].split(":")[0] == json.loads(jd)["error"].split(":")[0]


def test_artifact_decompress_and_stats(servers):
    """Both servers answer /decompress with a 16px PNG; the port's seed
    reproduces byte for byte, another seed does not; /stats counts it."""
    blob = compress_frame(servers["q"][2].tobytes())
    (js, jt, jd), (_, _, td) = _same(servers, "POST", "/decompress?seed=7&size=16&steps=2", blob)
    assert js == 200 and jt == "image/png"
    for d in (jd, td):
        assert Image.open(io.BytesIO(d)).size == (16, 16)
    assert _request(servers["port"], "POST", "/decompress?seed=7", blob)[2] == td
    assert _request(servers["port"], "POST", "/decompress?seed=8", blob)[2] != td
    jpeg = _request(servers["port"], "POST", "/decompress?format=jpeg", blob)
    assert jpeg[:2] == (200, "image/jpeg")
    st = json.loads(_request(servers["port"], "GET", "/stats")[2])
    assert st["requests"]["decompress"] >= 4 and st["decompress_latency_s"]["p50"] > 0
    assert "micro_batch" not in st


def test_micro_batcher_pads_and_measures_its_fill_as_jaxs():
    """A lone row is padded with itself to the batch; a full gather fills
    it; a failure reaches every waiter. The JAX class does the same."""
    for cls in (serve._MicroBatcher, jserve._MicroBatcher):
        seen = []

        def run(zs, seed):
            seen.append((zs.copy(), seed))
            if zs[0, 0] < 0:
                raise ValueError("boom")
            return zs * 2

        mb = cls(run, batch_size=4, max_wait_ms=300.0)
        out = mb.submit(np.full(3, 1.5, np.float32))
        np.testing.assert_array_equal(out, np.full(3, 3.0))
        assert seen[0][0].shape == (4, 3) and np.all(seen[0][0] == 1.5)
        assert (mb.calls, mb.rows_served, mb.fill_rate) == (1, 1, 0.25)
        res = [None] * 4
        threads = [threading.Thread(target=lambda i=i: res.__setitem__(i, mb.submit(np.full(3, float(i + 1)))))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(float(r[0]) for r in res) == [2.0, 4.0, 6.0, 8.0]
        assert mb.calls >= 2 and 0.25 < mb.fill_rate <= 1.0 and mb.rows_served == 5
        with pytest.raises(ValueError, match="boom"):
            mb.submit(np.full(3, -1.0, np.float32))
        assert [s for _, s in seen] == list(range(len(seen)))  # one seed per call, counted up


def test_micro_batched_serving(servers):
    """A batch-2 artifact: concurrent requests share replays, a lone one is
    padded, ``seed`` is refused, /stats reports the fill rate."""
    art = deploy.export_decompressor(torch.load(servers["weights"]), ModelConfig(**MC), servers["root"] / "b2.torchprog",
                                     size=16, steps=2, batch_size=2, platforms=["cpu"])
    srv = serve.serve(str(servers["store"]), weights=str(servers["weights"]), port=0, artifact=str(art),
                      batch_wait_ms=100.0, device="cpu")
    addr = _start(srv)
    try:
        blobs = [compress_frame(servers["q"][i].tobytes()) for i in range(4)]
        status, ctype, data = _request(addr, "POST", "/decompress", blobs[0])
        assert (status, ctype) == (200, "image/png") and Image.open(io.BytesIO(data)).size == (16, 16)
        res = [None] * 4
        threads = [threading.Thread(target=lambda i=i: res.__setitem__(i, _request(addr, "POST", "/decompress",
                                                                                   blobs[i]))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(r[0] == 200 for r in res) and len({r[2] for r in res}) == 4
        status, _, data = _request(addr, "POST", "/decompress?seed=7", blobs[0])
        assert status == 400 and "seed is per-program" in json.loads(data)["error"]
        mb = json.loads(_request(addr, "GET", "/stats")[2])["micro_batch"]
        assert mb["batch_size"] == 2 and mb["calls"] >= 3 and 0 < mb["fill_rate"] <= 1.0
    finally:
        srv.shutdown()


@pytest.mark.parametrize("ivf,u8", [(True, False), (False, True), (True, True)])
def test_searcher_forms_match_jaxs(servers, monkeypatch, ivf, u8):
    """``_Searcher`` over the IVF (every list probed) and uint8 indexes: the
    hits of the exact index and of JAX's searcher in the same form."""
    row = servers["feats"][5:6]

    class _Stub:
        def __init__(self, **kw):
            pass

        def encode_text(self, text):
            return row.copy()

    monkeypatch.setattr(jax_encoders, "ClipEncoder", _Stub)
    monkeypatch.setattr(encoders, "ClipEncoder", _Stub)
    st, lock = servers["store"], threading.Lock()
    form = dict(ivf=ivf, nlist=2, nprobe=2, u8=u8)
    got = serve._Searcher(st, ClipCodec.load(st, device="cpu"), lock, **form).search("x", k=4)
    flat = serve._Searcher(st, ClipCodec.load(st, device="cpu"), lock).search("x", k=4)
    ref = jserve._Searcher(st, JaxCodec.load(st), lock, **form).search("x", k=4)
    assert [p for p, _ in got] == [p for p, _ in flat] == [p for p, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], rtol=0, atol=1e-5)
    assert got[0][0] == "img5.png"


def test_searcher_raw_image_query(servers, monkeypatch):
    """Image bytes go through ``preprocess_pil_u8`` at the tower's size and
    ``encode_image_array`` (stubbed to a store row)."""
    seen = {}

    class _Stub:
        cfg = SimpleNamespace(image_size=32)

        def __init__(self, **kw):
            pass

        def encode_image_array(self, x):
            seen["shape"], seen["dtype"] = x.shape, x.dtype
            return servers["feats"][4:5].copy()

    monkeypatch.setattr(encoders, "ClipEncoder", _Stub)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((20, 40, 3), np.uint8)).save(buf, format="PNG")
    st = servers["store"]
    hits = serve._Searcher(st, ClipCodec.load(st, device="cpu"), threading.Lock()).search_image(buf.getvalue(), k=2)
    assert hits[0][0] == "img4.png"
    assert seen == {"shape": (1, 32, 32, 3), "dtype": np.uint8}


def test_sd_artifact_serving(servers, monkeypatch):
    """/decompress_sd from a tiny SD artifact: a PNG, the same bytes for a
    seed, another image for another guidance, 412 on another sampler, 400
    on a bad frame; the refusals of ``serve`` and ``main``."""
    gen = torch.Generator().manual_seed(0)
    mods = [tsd.SDUNet(tsd.SDUNetConfig(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)),
            tsd.AutoencoderKL(tsd.VAEConfig(block_out=(8, 16), layers_per_block=1, latent_ch=4)),
            tsd.SDClipAdapter(in_dim=DIM, ctx_dim=16, n_tokens=2)]
    root = servers["root"]
    for name, m in zip(("unet", "vae", "adapter"), mods):
        init_params(m, gen)
        torch.save(m.state_dict(), root / f"sd_{name}.pt")
    sds = [m.state_dict() for m in mods]
    art = deploy.export_sd_decompressor(*sds, root / "sd.torchprog", unet_cfg=mods[0].cfg, vae_cfg=mods[1].cfg,
                                        size=16, steps=2, platforms=["cpu"])
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(root / "sd_unet.pt"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(root / "sd_vae.pt"))
    st = str(servers["store"])
    with pytest.raises(ValueError, match="only makes sense"):
        serve.serve(st, port=0, adapter=str(root / "sd_adapter.pt"), device="cpu")
    with pytest.raises(ValueError, match="needs --adapter"):
        serve.serve(st, port=0, sd_artifact=str(art), device="cpu")
    b2 = deploy.export_sd_decompressor(*sds, root / "sd2.torchprog", unet_cfg=mods[0].cfg, vae_cfg=mods[1].cfg,
                                       size=16, steps=2, batch_size=2, platforms=["cpu"])
    with pytest.raises(ValueError, match="--batch_size 1"):
        serve.serve(st, port=0, sd_artifact=str(b2), adapter=str(root / "sd_adapter.pt"), device="cpu")
    with pytest.raises(ValueError, match="still needs --weights"):
        serve.serve(st, port=0, artifact=str(servers["artifact"]), device="cpu")
    started = []
    monkeypatch.setattr(serve, "serve", lambda *a, **kw: started.append(q8.int8_enabled()) or SimpleNamespace(
        serve_forever=lambda: None))
    try:
        serve.main(["--store_dir", st, "--int8", "--device", "cpu"])  # --int8 turns the process default on
    finally:
        q8.set_int8_conv(False)
    assert started == [True]
    monkeypatch.undo()
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(root / "sd_unet.pt"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(root / "sd_vae.pt"))
    srv = serve.serve(st, port=0, sd_artifact=str(art), adapter=str(root / "sd_adapter.pt"), device="cpu")
    addr = _start(srv)
    try:
        blob = compress_frame(servers["q"][0].tobytes())
        status, ctype, data = _request(addr, "POST", "/decompress_sd?seed=4", blob)
        assert (status, ctype) == (200, "image/png") and Image.open(io.BytesIO(data)).size == (16, 16)
        assert _request(addr, "POST", "/decompress_sd?seed=4", blob)[2] == data
        assert _request(addr, "POST", "/decompress_sd?seed=4&guidance=0", blob)[2] != data
        status, _, d = _request(addr, "POST", "/decompress_sd?sampler=dpmpp", blob)
        assert status == 412 and json.loads(d)["artifact"] == {"sampler": "ddim"}
        assert _request(addr, "POST", "/decompress_sd", b"garbage")[0] == 400
        # no pixel decoder behind /decompress: the codec's own 503
        status, _, d = _request(addr, "POST", "/decompress?size=16&steps=1", blob)
        assert status == 503 and "No decoder" in json.loads(d)["error"]
    finally:
        srv.shutdown()


def test_int8_serving(servers, tmp_path, monkeypatch):
    """``--int8`` with no artifact: /decompress through ClipCodec with the
    dynamic int8 U-Net. An int8 artifact without its sidecar stops the
    server at start-up, naming the file; with it, /decompress and
    /decompress_sd answer from the static-int8 programs."""
    from clip_codec_tpu_torch.models import CLIPCondUNet

    st, root = str(servers["store"]), servers["root"]
    frame = (servers["store"] / "img0.clp").read_bytes()
    want = {}
    for on in (False, True):
        q8.set_int8_conv(on)
        try:
            codec = ClipCodec.load(st, weights=str(servers["weights"]), device="cpu")
            want[on] = codec.decompress([frame], size=16, steps=2, batch_size=1, seed=3)[0]
            srv = serve.serve(st, weights=str(servers["weights"]), port=0, device="cpu")
            addr = _start(srv)
            status, _, data = _request(addr, "POST", "/decompress?size=16&steps=2&seed=3", frame)
            srv.shutdown()
        finally:
            q8.set_int8_conv(False)
        got = np.asarray(Image.open(io.BytesIO(data)), np.uint8)
        assert status == 200 and np.array_equal(got, ((np.clip(want[on], -1, 1) + 1.0) * 127.5).astype(np.uint8))
    assert not np.array_equal(want[False], want[True])

    net = CLIPCondUNet(**CFG, time_dim=256, int8=True)
    net.load_state_dict(torch.load(servers["weights"], weights_only=True))
    quant = q8.calibrate_unet(net.eval(), 16, DIM, timesteps=MC["timesteps"], batch=1)
    art = deploy.export_decompressor(torch.load(servers["weights"]), ModelConfig(**MC), root / "q.torchprog",
                                     platforms=["cpu"], quant=quant, **STATICS)
    with pytest.raises(ValueError, match=r"int8 artifact: calibration sidecar .*q\.torchprog\.quant\.pt not found "
                                         r"\(cli\.export_decoder --int8 writes it\)"):
        serve.serve(st, weights=str(servers["weights"]), port=0, artifact=str(art), device="cpu")
    q8.save_quant(quant, str(art) + ".quant.pt")

    gen = torch.Generator().manual_seed(0)
    mods = [tsd.SDUNet(tsd.SDUNetConfig(block_out=(8, 16), layers_per_block=1, cross_dim=16, heads=2, freq_dim=8)),
            tsd.AutoencoderKL(tsd.VAEConfig(block_out=(8, 16), layers_per_block=1, latent_ch=4)),
            tsd.SDClipAdapter(in_dim=DIM, ctx_dim=16, n_tokens=2)]
    for name, m in zip(("unet", "vae", "adapter"), mods):
        init_params(m, gen)
        torch.save(m.state_dict(), root / f"sdq_{name}.pt")
    dec = tsd.StableDiffusionDecoder(*mods, int8=True)
    dec.calibrate_int8_scales(torch.from_numpy(servers["feats"][:1]), (1, 8, 8, 4))
    sd_art = deploy.export_sd_decompressor(*[m.state_dict() for m in mods], root / "sdq.torchprog",
                                           unet_cfg=mods[0].cfg, vae_cfg=mods[1].cfg, size=16, steps=2,
                                           platforms=["cpu"], quant=dec.unet_quant)
    q8.save_quant(dec.unet_quant, str(sd_art) + ".quant.pt")
    monkeypatch.setenv("CLIP_CODEC_SD_UNET_WEIGHTS", str(root / "sdq_unet.pt"))
    monkeypatch.setenv("CLIP_CODEC_SD_VAE_WEIGHTS", str(root / "sdq_vae.pt"))
    srv = serve.serve(st, weights=str(servers["weights"]), port=0, artifact=str(art), sd_artifact=str(sd_art),
                      adapter=str(root / "sdq_adapter.pt"), device="cpu")
    addr = _start(srv)
    try:
        status, ctype, data = _request(addr, "POST", "/decompress?seed=2", frame)
        assert (status, ctype) == (200, "image/png") and Image.open(io.BytesIO(data)).size == (16, 16)
        status, ctype, data = _request(addr, "POST", "/decompress_sd?seed=2", frame)
        assert (status, ctype) == (200, "image/png") and Image.open(io.BytesIO(data)).size == (16, 16)
    finally:
        srv.shutdown()


def test_serving_runs_without_jax(servers, tmp_path):
    """Export, serve and answer /healthz and /decompress in a process with
    no jax."""
    code = (
        "import sys, json, threading, http.client, torch\n"
        "from clip_codec_tpu_torch import serve, deploy\n"
        "from clip_codec_tpu_torch.cli import export_decoder\n"
        f"export_decoder.main(['--weights', {str(servers['weights'])!r}, '--out', {str(tmp_path / 'a.torchprog')!r},"
        " '--size', '16', '--steps', '1', '--batch_size', '1', '--device', 'cpu', '--output', 'uint8'])\n"
        f"srv = serve.serve({str(servers['store'])!r}, weights={str(servers['weights'])!r}, port=0,"
        f" artifact={str(tmp_path / 'a.torchprog')!r}, device='cpu')\n"
        "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
        "c = http.client.HTTPConnection(*srv.server_address, timeout=60)\n"
        "c.request('GET', '/healthz'); r = c.getresponse(); assert json.loads(r.read()) == {'status': 'ok', 'dim': 16}\n"
        f"c.request('POST', '/decompress', body=open({str(servers['store'] / 'img0.clp')!r}, 'rb').read())\n"
        "r = c.getresponse(); d = r.read(); assert r.status == 200 and d[:4] == b'\\x89PNG', d[:200]\n"
        "srv.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'clip_codec_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax', 'optax', 'clip_codec_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_serve_times_probe_runs_on_the_cpu(capsys):
    """``probes/serve_times.py`` end to end at a tiny size: the latency and
    fill-rate lines, then bench_serve.py's one JSON line."""
    from clip_codec_tpu_torch.probes import serve_times

    serve_times.main(["--device", "cpu", "--base", "32", "--z_dim", "16", "--size", "16", "--steps", "1",
                      "--batch", "2", "--n_requests", "4", "--concurrency", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"} and last["value"] > 0
    assert "micro-batch 2" in last["metric"] and "fill rate" in lines[-2] and "p95" in lines[-3]


def test_raw_frames_keep_the_magic_and_the_length():
    """Without zstandard a frame is the magic, the length and the raw codes,
    read back by the codec (and refused without the magic)."""
    import struct

    from clip_codec_tpu_torch.io import bitstream
    from clip_codec_tpu_torch.probes.serve_times import raw_frames

    names = ("compress_frame", "decompress_frame", "compress_frames", "decompress_frames")
    saved = [getattr(bitstream, n) for n in names]
    codes = np.arange(DIM, dtype=np.uint8)
    with raw_frames(False):
        frame = bitstream.compress_frame(codes.tobytes())
        assert frame == b"CLPF" + struct.pack("<I", DIM) + codes.tobytes()
        codec = ClipCodec(np.full(DIM, 2 / 255, np.float32), np.full(DIM, -1.0, np.float32), device="cpu")
        np.testing.assert_array_equal(codec.codes([frame])[0], codes)
        with pytest.raises(ValueError, match="Bad magic"):
            codec.codes([codes.tobytes()])
    assert [getattr(bitstream, n) for n in names] == saved
