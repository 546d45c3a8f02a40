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


# (deg, mxu_sum, tk): the four forms at tk = 128, and poly2 + mxu-sum at
# tk = 64, the key width of the kernels' narrower tiles.
@pytest.mark.parametrize("deg,mxu_sum,tk", [pytest.param(0, True, T, id="0-True"),
                                            pytest.param(2, False, T, id="2-False"),
                                            pytest.param(2, True, T, id="2-True"),
                                            pytest.param(3, True, T, id="3-True"),
                                            pytest.param(2, True, 64, id="2-True-tk64")])
def test_fast_flash_plain_matches_pallas(bap, deg, mxu_sum, tk):
    """The raw accumulator and the divided output."""
    q, k, v = _qkv(1)
    acc = ap.fast_flash_plain(*_t(q, k, v), tk, deg, mxu_sum)
    assert acc.shape == (BH, N, D + 1) and acc.dtype == torch.float32
    _close(acc.numpy(), _jax_fast_acc(bap, q, k, v, T, tk, deg, mxu_sum))
    _close(ap.fast_flash(*_t(q, k, v), T, tk, deg, mxu_sum).numpy(),
           _jax(bap.fast_flash, q, k, v, T, tk, deg, mxu_sum))


@pytest.mark.parametrize("D_", ap.KERNEL_DEPTHS)
def test_fast_v_is_the_v_the_kernel_maps(D_):
    """With the row sum on P.V, the v that ``fast_flash_acc`` hands the
    kernel is D + 1 rounded up to 8 wide (48 at D = 40, 56 at D = 48: a TMA
    row stride of a multiple of 16 bytes), v in its first D columns, ones
    in column D and zeros after; without it, v itself. On the CPU the
    kernel-alone entry gives the wrapper's accumulator from that v."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal((2, 128, D_)).astype(np.float32)).to(torch.bfloat16)
    vk = ap.fast_v(v, True)
    assert vk.shape == (2, 128, {40: 48, 48: 56}[D_]) == (2, 128, ap.fast_v_width(D_, True))
    assert vk.dtype == v.dtype and vk.is_contiguous()
    assert torch.equal(vk[..., :D_], v)
    assert bool((vk[..., D_] == 1).all()) and bool((vk[..., D_ + 1:] == 0).all())
    assert ap.fast_v(v, False) is v and ap.fast_v_width(D_, False) == D_
    q, k = (torch.from_numpy(rng.standard_normal((2, 128, D_)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    for mxu_sum in (True, False):
        got = ap.fast_flash_kernel(q, k, ap.fast_v(v, mxu_sum), 192, 128, 2, mxu_sum)
        assert torch.equal(got, ap.fast_flash_acc(q, k, v, 192, 128, 2, mxu_sum))


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
    shape: one line per dot probe, the production kernel, SDPA and each P1,
    P3 and P2 variant, then the four correctness lines."""
    assert attn_probe.main(["--device", "cpu", "--bh", "2", "--n", "256", "--d", "40"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[attn-probe]")]
    timed = 11 + 2 + len(ap.P1_TILES) + len(ap.P3_TILES) + 2 * len(ap.P2_TILES)  # P2: kernel alone, wrapper
    assert len(lines) == timed + 4
    assert all(" ms" in line for line in lines[:timed])
    checks = lines[timed:]
    assert [line.split()[1] for line in checks] == ["production", "exp2-fold", "poly2+mxu-sum", "poly3+mxu-sum"]
    for line in checks:
        assert float(line.split("=")[-1]) <= 2e-2


def test_p1_p3_tiles_are_ones_the_wgmma_design_takes():
    """P1, P2 and P3 run on K4's loop: 64 query rows per consumer
    warpgroup, two or three warpgroups taking turns (tq = 128 or 192), key
    tiles of 64 or 128; the six P1 modes and the four P2 forms at K4's own
    tile (192, 128), so that the ablations remove one piece each from one
    loop, and P2's poly2 + mxu-sum at the three other tiles."""
    assert len(set(ap.P1_TILES)) == len(ap.P1_TILES) == 12
    for mode, tq, tk in ap.P1_TILES:
        assert mode in ap.MODES and tq in (128, 192) and tk in (64, 128)
    assert [m for m, tq, tk in ap.P1_TILES if (tq, tk) == (192, 128)] == list(ap.MODES)
    assert {(m, tq, tk) for m, tq, tk in ap.P1_TILES if (tq, tk) != (192, 128)} == {
        (m, tq, tk) for m in ("full", "exp2") for tq, tk in ((128, 128), (192, 64), (128, 64))}
    assert sorted(ap.P3_TILES) == [128, 192]
    assert [label for label, tq, tk, mode in attn_probe.P1_VARIANTS if "production form" in label] == [
        "full (192,128) [= production form]"]
    assert len(set(ap.P2_TILES)) == len(ap.P2_TILES) == 7
    for deg, mxu_sum, tq, tk in ap.P2_TILES:
        assert deg in (0, 2, 3) and tq in (128, 192) and tk in (64, 128)
    assert [(deg, mxu) for deg, mxu, tq, tk in ap.P2_TILES if (tq, tk) == (192, 128)] == [
        (0, True), (2, False), (2, True), (3, True)]
    assert {t for t in ap.P2_TILES if t[2:] != (192, 128)} == {
        (2, True, tq, tk) for tq, tk in ((128, 128), (192, 64), (128, 64))}


def test_check_refuses_the_old_tiles_before_any_launch():
    """(64, 64), the mma.sync design's tile, has no P1, P2 or P3 kernel:
    ``_check`` refuses it on CPU bf16 tensors of a shape the kernels take."""
    q = torch.zeros((2, 256, 40), dtype=torch.bfloat16)
    ap._check(q, q, q, ("full", 192, 128), ap.P1_TILES)
    ap._check(q, q, q, 192, ap.P3_TILES)
    ap._check(q, q, q, (2, True, 192, 128), ap.P2_TILES)
    for tile, tiles in ((("full", 64, 64), ap.P1_TILES), (("noexp", 128, 128), ap.P1_TILES), (64, ap.P3_TILES),
                        ((2, True, 64, 64), ap.P2_TILES), ((2, False, 128, 128), ap.P2_TILES)):
        with pytest.raises(ValueError, match="no kernel is instantiated"):
            ap._check(q, q, q, tile, tiles)
    with pytest.raises(ValueError, match=r"v must have shape \(2, 256, 48\)"):
        ap._check(q, q, q, (2, True, 192, 128), ap.P2_TILES, ap.fast_v_width(40, True))
    assert ap.flash_variant.launches == 0 and ap.single_pass.launches == 0 and ap.fast_flash_acc.launches == 0


def test_sass_counts_reads_cuobjdump_and_ptxas():
    """The SASS counter on a made-up disassembly and build log of one P2
    kernel (poly2 + mxu-sum, (192, 128)) and one kernel it ignores."""
    from clip_codec_tpu_torch.probes import sass_counts

    name = "_ZN12_GLOBAL__N_16hopper12probe_kernelILi7ELi128ELi3ELi4ELi48ELi2ELb1EEEv14CUtensorMap_stS2_S2_Pviif"
    sass = "\n".join([
        "\t\tFunction : _Z5otherv", "        /*0000*/                   MUFU.EX2 R1, R2 ;",
        f"\t\tFunction : {name}", "\t.headerflags\t@\"EF_CUDA_SM90\"",
        "        /*0000*/                   FADD.RM R3, R2, 1.2582912e+07 ;",
        "        /*0010*/              @!P0 MUFU.EX2 R4, R5 ;",
        "        /*0020*/                   F2FP.BF16.F32.PACK_AB R6, R7, R8 ;",
        "        /*0030*/                   F2FP.BF16.F32.PACK_AB R6, R7, R9 ;",
        "        /*0040*/              @UPT LEA R3, R3, R10, 0x17 ;"])
    log = "\n".join([f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                     f"ptxas info    : Function properties for {name}",
                     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                     "ptxas info    : Used 168 registers, used 1 barriers"])
    counts = sass_counts.opcode_counts(sass)
    assert counts[name] == {"FADD": 1, "MUFU": 1, "F2FP": 2, "LEA": 1} and counts["_Z5otherv"] == {"MUFU": 1}
    assert sass_counts.kernel_args(name) == (7, 128, 3, 4, 48, 2, 1) and sass_counts.kernel_args("_Z5otherv") is None
    lines = sass_counts.report(sass, log, ["MUFU", "F2I", "F2FP"])
    assert len(lines) == 2
    assert [" ".join(line.split()) for line in lines] == [
        "[sass] P2 poly2-exp2 + mxu-sum, P.V 48 (192,128) 5 instructions; MUFU 1 F2I 0 F2FP 2; "
        "per S element (4 a thread): MUFU 0.2500 F2I 0.0000 F2FP 0.5000",
        "[ptxas] P2 poly2-exp2 + mxu-sum, P.V 48 (192,128) "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; Used 168 registers, used 1 barriers"]


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
        "import clip_codec_tpu_torch.probes.flash_times, clip_codec_tpu_torch.probes.conv_times\n"
        "import clip_codec_tpu_torch.probes.sass_counts\n"
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


def test_conv_times_needs_a_card(monkeypatch):
    """The conv kernel timer has no CPU mode: without a card it exits with a usage error."""
    from clip_codec_tpu_torch.probes import conv_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        conv_times.main([])
    assert e.value.code == 2
