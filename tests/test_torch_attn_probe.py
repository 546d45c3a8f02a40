"""The port's attention probes (clip_codec_tpu_torch/ops/attention_probe.py,
clip_codec_tpu_torch/probes/attn_probe.py) against bench_attn_probe.py.

The plain versions (what the wrappers run on a CPU tensor and what the CUDA
kernels are held against on the card) against the JAX probe's Pallas
kernels in TPU interpret mode, on the same fp32 inputs made with numpy from
a seed, at (BH, N, D) = (2, 256, 40) with tq = tk = 128. Tolerances:
outputs and the P2 accumulator within 1e-5 of their largest magnitude (the
two sum the products and the row sums in other orders); ``fast_exp2``
within 2 ulp (XLA may contract the polynomial's multiply-adds into FMAs);
the bf16 case within bf16's rounding (2^-8 of the largest magnitude).
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from clip_codec_tpu_torch.ops import attention_probe as ap
from clip_codec_tpu_torch.probes import attn_probe

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
BH, N, D, T = 2, 256, 40, 128


@pytest.fixture(scope="module")
def bap():
    """bench_attn_probe, imported with the compilation-cache settings that
    its import changes (:32-33) put back as they were."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {key: getattr(jax.config, key) for key in keys}
    import bench_attn_probe

    for key, value in saved.items():
        jax.config.update(key, value)
    return bench_attn_probe


def _qkv(seed=0, q_scale=1.0, shape=(BH, N, D)):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(shape) * q_scale).astype(np.float32)
    return q, rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _jax(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*map(jnp.asarray, args[:3]), *args[3:]), np.float32)


def _jax_fast_acc(bap, q, k, v, tq, tk, deg, mxu_sum):
    """The pallas_call of bench_attn_probe.fast_flash (:255-276) without its
    final divide: the raw (BH, N, D+1) accumulator."""
    q, k, v = map(jnp.asarray, (q, k, v))
    bh, n, d = q.shape
    if mxu_sum:
        v = jnp.concatenate([v, jnp.ones((bh, n, 1), v.dtype)], axis=-1)
    dv = v.shape[-1]
    kernel = functools.partial(bap._fast_kernel, deg=deg, scale2=(1.0 / float(d) ** 0.5) * float(np.log2(np.e)),
                               mxu_sum=mxu_sum)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((bh, n, d + 1), jnp.float32), grid=(bh, n // tq, n // tk),
            in_specs=[pl.BlockSpec((1, tq, d), lambda b, iq, ik: (b, iq, 0)),
                      pl.BlockSpec((1, tk, d), lambda b, iq, ik: (b, ik, 0)),
                      pl.BlockSpec((1, tk, dv), lambda b, iq, ik: (b, ik, 0))],
            out_specs=pl.BlockSpec((1, tq, d + 1), lambda b, iq, ik: (b, iq, 0)),
            scratch_shapes=[pltpu.VMEM((tq, 1), jnp.float32), pltpu.VMEM((tq, d + 1), jnp.float32)],
        )(q, k, v)
    return np.asarray(out)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (mode, tk): the six P1 modes at tk = 128, and noexp again at tk = 64: its
# output depends on the key-tile width, because alpha multiplies the
# accumulator once per tile.
@pytest.mark.parametrize("mode,tk", [(m, T) for m in ap.MODES] + [("noexp", 64)])
def test_flash_variant_plain_matches_pallas(bap, mode, tk):
    q, k, v = _qkv()
    want = _jax(bap.flash_variant, q, k, v, T, tk, mode)
    got = ap.flash_variant(*_t(q, k, v), T, tk, mode)  # a CPU tensor: the plain version
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    if mode == "noexp" and tk == 64:
        other = ap.flash_variant_plain(*_t(q, k, v), T, mode).numpy()
        assert np.abs(other - want).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("deg,mxu_sum", [(0, True), (2, False), (2, True), (3, True)])
def test_fast_flash_plain_matches_pallas(bap, deg, mxu_sum):
    """The raw accumulator and the divided output."""
    q, k, v = _qkv(1)
    acc = ap.fast_flash_plain(*_t(q, k, v), T, deg, mxu_sum)
    assert acc.shape == (BH, N, D + 1) and acc.dtype == torch.float32
    _close(acc.numpy(), _jax_fast_acc(bap, q, k, v, T, T, deg, mxu_sum))
    _close(ap.fast_flash(*_t(q, k, v), T, T, deg, mxu_sum).numpy(), _jax(bap.fast_flash, q, k, v, T, T, deg, mxu_sum))


@pytest.mark.parametrize("deg", [2, 3])
def test_fast_exp2_matches_jax(bap, deg):
    x = np.concatenate([np.linspace(-130.0, 0.0, 20001, dtype=np.float32), np.float32([-126.5, -0.5, 0.0])])
    want = np.asarray(bap.fast_exp2(jnp.asarray(x), deg))
    got = ap.fast_exp2(torch.from_numpy(x), deg).numpy()
    assert (got > 0).all() and (want > 0).all()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, ulps.max()
    # the approximation itself, above -126: deg 2 is 3.2e-3 off 2^x at worst
    # (bf16's quantum is 3.9e-3), deg 3 1.4e-4
    exact = np.exp2(x.astype(np.float64))
    keep = x > -126
    assert (np.abs(got[keep] - exact[keep]) / exact[keep]).max() < {2: 3.5e-3, 3: 1.5e-4}[deg]


def test_single_pass_plain_matches_pallas(bap):
    q, k, v = _qkv(2)
    got = ap.single_pass(*_t(q, k, v), T)
    _close(got.numpy(), _jax(bap.single_pass, q, k, v, T))


def test_mxu_sum_adds_the_bf16_rounded_p(bap):
    """In bf16 the ones column sums p after its rounding to bf16, the vpu
    form sums the fp32 p: one key tile (tk = N) so that neither is rescaled."""
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32) for a in _qkv(3, shape=(1, N, D)))
    qt, kt, vt = (t.to(torch.bfloat16) for t in _t(q, k, v))
    s = (q[0].astype(np.float64) @ k[0].astype(np.float64).T) * (np.log2(np.e) / np.sqrt(D))
    p = np.exp2(s - s.max(-1, keepdims=True)).astype(np.float32)
    l_bf16 = torch.from_numpy(p).to(torch.bfloat16).double().sum(-1).numpy()
    l_fp32 = p.astype(np.float64).sum(-1)
    for mxu_sum, want in ((True, l_bf16), (False, l_fp32)):
        acc = ap.fast_flash_plain(qt, kt, vt, N, 0, mxu_sum)
        np.testing.assert_allclose(acc[0, :, D].double().numpy(), want, rtol=1e-5)
        jax_acc = _jax_fast_acc(bap, jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), T, N, 0, mxu_sum)
        _close(acc.numpy(), jax_acc, tol=2.0 ** -8)
    assert np.abs(l_bf16 - l_fp32).max() > 1e-4 * l_fp32.max()  # the two sums differ


def test_probe_main_on_the_cpu(capsys):
    """``--device cpu`` runs every variant's plain version once at a tiny
    shape: one line per dot probe, the production kernel and each P1, P3
    and P2 variant, then the four correctness lines."""
    assert attn_probe.main(["--device", "cpu", "--bh", "2", "--n", "256", "--d", "40"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[attn-probe]")]
    timed = 11 + 1 + len(ap.P1_TILES) + len(ap.P3_TILES) + len(ap.P2_TILES)
    assert len(lines) == timed + 4
    assert all(" ms" in line for line in lines[:timed])
    checks = lines[timed:]
    assert [line.split()[1] for line in checks] == ["production", "exp2-fold", "poly2+mxu-sum", "poly3+mxu-sum"]
    for line in checks:
        assert float(line.split("=")[-1]) <= 2e-2


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 128, 40), device="meta")
    for call in (lambda: ap.flash_variant(q, q, q, 64, 64, "full"), lambda: ap.fast_flash(q, q, q, 64, 64, 2),
                 lambda: ap.single_pass(q, q, q, 64)):
        with pytest.raises(ValueError, match="CUDA or CPU tensor"):
            call()


def test_probe_modules_import_no_jax():
    code = (
        "import sys\n"
        "import clip_codec_tpu_torch.ops.attention_probe, clip_codec_tpu_torch.probes.attn_probe\n"
        "import clip_codec_tpu_torch.probes.flash_times\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'clip_codec_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.', 'optax', 'clip_codec_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_flash_times_needs_a_card(monkeypatch):
    """The kernel timer has no CPU mode: without a card it exits with a usage error."""
    from clip_codec_tpu_torch.probes import flash_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        flash_times.main([])
    assert e.value.code == 2
