"""The port's native store codec (``clip_codec_tpu_torch/io/native.py`` over
``csrc/store_codec.cpp``) against ``zstandard`` and the JAX package's native
engine (``clip_codec_tpu/io/native.py``), on this machine's libzstd.

Frames are compared byte for byte only between engines on one machine: zstd
at level 22 may encode differently in another library version (the JAX
self-check probe does here: ``matches_zstandard`` must then agree with the
JAX engine's ``_self_check``). Across engines the decoded codes are equal."""

import struct
from pathlib import Path

import numpy as np
import pytest
import zstandard

from clip_codec_tpu.io import native as jax_native
from clip_codec_tpu.io.bitstream import compress_frame as jax_compress_frame
from clip_codec_tpu_torch.codec import ClipCodec
from clip_codec_tpu_torch.io import bitstream, native
from clip_codec_tpu_torch.io.store import Store, append_store, write_store


def _codes(seed, n=16, d=512):
    """Code-like rows: a quantized Gaussian around the middle of the range."""
    rng = np.random.default_rng(seed)
    return np.clip(np.rint(rng.standard_normal((n, d)) * 24 + 128), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def nc():
    c = native.codec()
    assert c is not None, native.load_error()
    return c


def _force(monkeypatch, engine):
    """Frame and parse with ``engine`` only: the native codec as on a
    machine without ``zstandard``, or ``zstandard`` as where the native
    codec does not build."""
    if engine == "native":
        monkeypatch.setattr(bitstream, "_have_zstandard", lambda: False)
    else:
        monkeypatch.setattr(native, "codec", lambda: None)


@pytest.fixture
def jax_engine(monkeypatch):
    """The JAX package's native engine with its self-check passed over, so
    that its ``compress_frames`` runs here whatever the probe says."""
    monkeypatch.setattr(jax_native, "_self_check", lambda lib: True)
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)
    if jax_native.get_lib() is None:
        pytest.fail("the JAX package's native engine did not build")
    yield jax_native
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)


@pytest.mark.parametrize("d", [512, 768])
def test_frames_byte_equal_to_zstandard_and_to_jax(nc, jax_engine, d):
    q = _codes(d, d=d)
    frames = nc.compress_batch(q)
    assert frames == jax_engine.compress_frames(q)
    assert frames == [jax_compress_frame(row.tobytes()) for row in q]
    assert [nc.compress_frame(row.tobytes()) for row in q] == frames
    np.testing.assert_array_equal(nc.decompress_batch(frames, d), q)
    np.testing.assert_array_equal(jax_engine.decompress_frames(frames, d), q)


def test_self_check_agrees_with_jax(nc, monkeypatch):
    import ctypes

    lib = ctypes.CDLL(str(jax_native._build()))
    for f in ("clp_frame_bound", "clp_compress_frame"):
        getattr(lib, f).restype = ctypes.c_size_t
    lib.clp_frame_bound.argtypes = [ctypes.c_size_t]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.clp_compress_frame.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, ctypes.c_int]
    assert nc.matches_zstandard() == jax_native._self_check(lib)
    want = "native" if nc.matches_zstandard() else "zstandard"
    assert bitstream.zstd_engine() == want
    _force(monkeypatch, "native")
    assert bitstream.zstd_engine() == "native"
    q = _codes(3, n=2)
    assert bitstream.compress_frame(q[0].tobytes()) == nc.compress_frame(q[0].tobytes())
    np.testing.assert_array_equal(bitstream.decompress_frame(nc.compress_frame(q[1].tobytes())), q[1])


FAKE_ZSTD = """
#include <stddef.h>
unsigned ZSTD_versionNumber(void) { return 99999; }
size_t ZSTD_compress(void* d, size_t dc, const void* s, size_t n, int level) { return (size_t)-1; }
"""


def test_frames_use_the_linked_libzstd_whatever_was_loaded_before(nc, tmp_path):
    """A library loaded earlier with RTLD_GLOBAL that exports other zstd
    symbols (as TensorFlow's does, zstd 1.5.7, once ``torch.utils.tensorboard``
    has imported it) does not change which libzstd the codec calls: in a
    fresh process that loads such a stand-in first, the codec reports the
    version it reports here and frames as it frames here."""
    import subprocess
    import sys

    src = tmp_path / "fake_zstd.c"
    src.write_text(FAKE_ZSTD)
    fake = tmp_path / "libfake_zstd.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(fake), str(src)], check=True)
    probe = _codes(6, n=1)[0].tobytes()
    script = (
        "import ctypes, sys\n"
        f"ctypes.CDLL({str(fake)!r}, mode=ctypes.RTLD_GLOBAL)\n"
        "from clip_codec_tpu_torch.io import native\n"
        "c = native.codec()\n"
        f"print(c.zstd_version, c.compress_frame({probe!r}).hex())\n")
    out = subprocess.run([sys.executable, "-c", script], check=True, capture_output=True, text=True,
                         cwd=str(Path(__file__).resolve().parents[1])).stdout.split()
    assert out == [nc.zstd_version, nc.compress_frame(probe).hex()]


def test_batch_decodes_frames_of_either_engine(nc, monkeypatch):
    q = _codes(1, n=64)
    z_frames = [zstandard.ZstdCompressor(level=22).compress(r.tobytes()) for r in q]
    z_frames = [b"CLPF" + struct.pack("<I", len(c)) + c for c in z_frames]
    np.testing.assert_array_equal(nc.decompress_batch(z_frames, 512), q)
    np.testing.assert_array_equal(nc.decompress_batch(nc.compress_batch(q), 512), q)
    _force(monkeypatch, "native")
    np.testing.assert_array_equal(bitstream.decompress_frames(z_frames, 512), q)
    assert bitstream.decompress_frames([], 512).shape == (0, 512)


@pytest.mark.parametrize("engine", ["native", "zstandard"])
def test_bad_frames_refused(nc, engine, monkeypatch):
    good = nc.compress_frame(_codes(2, n=1)[0].tobytes())
    corrupt = good[:8] + bytes(len(good) - 8)
    bomb = zstandard.ZstdCompressor().compress(bytes(1 << 21))
    bomb = b"CLPF" + struct.pack("<I", len(bomb)) + bomb
    corrupt_error = bitstream.FrameError if engine == "native" else zstandard.ZstdError
    _force(monkeypatch, engine)
    with pytest.raises(ValueError, match="Bad magic"):
        bitstream.decompress_frame(b"XXXX" + good[4:])
    with pytest.raises(ValueError, match="Truncated"):
        bitstream.decompress_frame(b"CLPF\x01")
    with pytest.raises(corrupt_error):
        bitstream.decompress_frame(corrupt)
    with pytest.raises(corrupt_error, match="decompression-bomb"):
        bitstream.decompress_frame(bomb, max_output=1 << 20)
    # the batch path raises the single frame's error for the bad record
    with pytest.raises(ValueError, match="Bad magic"):
        bitstream.decompress_frames([good, b"XXXX" + good[4:]], 512)
    with pytest.raises(corrupt_error):
        bitstream.decompress_frames([corrupt, good], 512)
    with pytest.raises(ValueError, match="different store"):
        bitstream.decompress_frames([good, nc.compress_frame(bytes(16))], 512)
    assert nc.decompress_batch([good, bomb], 512) == 1  # bounded by dim: no allocation


def test_store_bytes_equal_under_each_engine(nc, tmp_path, monkeypatch):
    q = _codes(4, n=12, d=32)
    scale, zero = np.full(32, 2 / 255, np.float32), np.full(32, -1.0, np.float32)
    feats = q.astype(np.float32) * scale + zero
    paths = [f"img/{i}.png" for i in range(12)]
    stores = {}
    for engine in ("native", "zstandard"):
        with monkeypatch.context() as m:
            _force(m, engine)
            write_store(tmp_path / engine, feats[:8], paths[:8], scale, zero, q[:8])
            append_store(tmp_path / engine, feats[8:], paths[8:])
            stores[engine] = Store.open(tmp_path / engine)
            np.testing.assert_array_equal(stores[engine].read_codes(), q)
    a, b = stores["native"], stores["zstandard"]
    for ra, rb in zip(a.manifest, b.manifest):
        assert open(ra["bitstream"], "rb").read() == open(rb["bitstream"], "rb").read()
    _force(monkeypatch, "native")
    np.testing.assert_array_equal(b.read_codes(), q)


def test_codec_frames_through_the_batch_path(nc, monkeypatch):
    q = _codes(5, n=6, d=32)
    codec = ClipCodec(np.full(32, 2 / 255, np.float32), np.full(32, -1.0, np.float32), device="cpu")
    _force(monkeypatch, "native")
    frames = bitstream.compress_frames(q)
    assert frames == nc.compress_batch(q)
    np.testing.assert_array_equal(codec.codes(frames), q)
    with pytest.raises(ValueError, match="different store"):
        codec.codes([nc.compress_frame(bytes(16))])


def test_no_engine_is_refused(monkeypatch):
    """Neither zstandard nor the native codec: no engine frames, and a
    single frame raises naming both."""
    monkeypatch.setattr(bitstream, "_have_zstandard", lambda: False)
    monkeypatch.setattr(native, "codec", lambda: None)
    assert bitstream.zstd_engine() is None
    with pytest.raises(RuntimeError, match="no zstd engine"):
        bitstream.compress_frame(bytes(16))
