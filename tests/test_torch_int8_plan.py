"""The int8 conv's tile plan (``ops/int8.py``'s ``int8_conv_plan``) on the CPU.

The kernel (``csrc/int8_conv.cu``) runs the plan it is handed, so these
tests hold the plan itself: at every shape of the int8 serving paths (the
pixel artifact's seven 3x3 convs at B = 16 and the dynamic server's at
B = 1, SD-1.5's timed shapes at 64x64 latents with CFG, the adapter's
8-token and CLIP's 77-token context projections), on a card of 132 SMs and
on one of 8, every output tile is walked once, every K step of a tile once,
the ring fits the block's shared memory, and the operands swap exactly where
M <= 64; the act form's plans (bf16 and fp32 activations, whose windows make
the stages larger) too. At small shapes, the plan's K slices of the plain version's
arithmetic, summed in int64, give its int32 accumulator bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

from clip_codec_tpu_torch.ops import int8 as q8

# (xq shape, wq shape, stride, padding)
PIXEL = [[((B, 256, 256, 128), (128, 3, 3, 128), 1, 1), ((B, 256, 256, 128), (128, 3, 3, 128), 2, 1),
          ((B, 128, 128, 128), (128, 3, 3, 128), 1, 1), ((B, 128, 128, 128), (256, 3, 3, 128), 2, 1),
          ((B, 64, 64, 256), (256, 3, 3, 256), 1, 1), ((B, 64, 64, 256), (512, 3, 3, 256), 2, 1),
          ((B, 32, 32, 512), (512, 3, 3, 512), 1, 1)] for B in (16, 1)]
PIXEL16, PIXEL1 = PIXEL
SD_TIMED = [((2, 64, 64, 320), (320, 3, 3, 320), 1, 1), ((2, 32, 32, 640), (640, 3, 3, 640), 1, 1),
            ((2, 16, 16, 1280), (1280, 3, 3, 1280), 1, 1), ((2, 8, 8, 1280), (1280, 3, 3, 1280), 1, 1),
            ((8192, 1, 1, 320), (320, 1, 1, 320), 1, 0), ((8192, 1, 1, 320), (2560, 1, 1, 320), 1, 0),
            ((8192, 1, 1, 1280), (320, 1, 1, 1280), 1, 0), ((16, 1, 1, 768), (320, 1, 1, 768), 1, 0)]
CONTEXT = [((rows, 1, 1, 768), (cout, 1, 1, 768), 1, 0) for rows in (16, 154) for cout in (320, 640, 1280)]
SHAPES = PIXEL16 + PIXEL1 + SD_TIMED + CONTEXT


def _plan(xs, ws, stride, pad, sms, act=1):
    B, H, W, cin = xs
    cout, k, _, _ = ws
    return q8.int8_conv_plan(B, H, W, cin, cout, k, stride, pad, sms, act)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("xs,ws,stride,pad", SHAPES, ids=[f"{a}-{b}-s{c}" for a, b, c, _ in SHAPES])
def test_plan_covers_every_tile_and_k_step_once(xs, ws, stride, pad, sms):
    pl = _plan(xs, ws, stride, pad, sms)
    _check_covers(pl, xs, ws, stride, pad, sms)
    # the ring fits the block, as the kernel's Cfg computes it
    assert pl.stages == q8.ring_stages(pl.mw, pl.bn) >= 2
    assert q8.smem_bytes(pl.mw, pl.bn) <= q8.SMEM_LIMIT
    assert (pl.mw == 1 and pl.bn in q8.SWAP_BN) if pl.swap else (pl.mw, pl.bn) in q8.TILES
    assert pl.mw * pl.bn // 2 <= 128  # accumulators a thread


@pytest.mark.parametrize("act", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("xs,ws,stride,pad", SHAPES, ids=[f"{a}-{b}-s{c}" for a, b, c, _ in SHAPES])
def test_act_plan_fits_and_covers_every_tile_and_k_step_once(xs, ws, stride, pad, act):
    """Every plan of the act form (bf16 or fp32 activations quantized in
    shared memory), the chosen one among them: a stage holds ``act``
    128-byte boxes of the window beside the weights, so the ring is shorter;
    it still keeps two stages or more, fits the block, and walks every
    output tile and K step once. fp32 windows run 128-row tiles only (a
    256-row one leaves no second stage)."""
    plans = [p for _, p in q8.int8_conv_plans(*xs, ws[0], ws[1], stride, pad, 132, act)]
    assert _plan(xs, ws, stride, pad, 132, act) in plans
    for pl in plans:
        assert pl.act == act
        _check_covers(pl, xs, ws, stride, pad, 132)
        assert (pl.mw == 1 and pl.bn in q8.SWAP_BN) if pl.swap else (pl.mw, pl.bn) in q8.TILES
        assert act == 2 or pl.mw == 1
        x_rows, w_rows = (pl.bn, 128) if pl.swap else (128 * pl.mw, pl.bn)
        assert q8.stage_bytes(pl.mw, pl.bn, pl.swap, act) == (act * x_rows + w_rows) * q8.KSTEP
        assert pl.stages == q8.ring_stages(pl.mw, pl.bn, pl.swap, act) >= 2
        assert q8.smem_bytes(pl.mw, pl.bn, pl.swap, act) <= q8.SMEM_LIMIT


def _check_covers(pl, xs, ws, stride, pad, sms):
    """Every output tile once, each with every K step once, in the plan's
    view of the output; the tile's shape within TMA's box limits."""
    B, H, W, cin = xs
    cout, k, _, _ = ws
    ho, wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    M = B * ho * wo
    assert pl.swap == (M <= 64)
    assert pl.gemm == (k == 1 and stride == 1 and pad == 0)
    assert pl.view == ((M, 1, 1) if pl.gemm else (B, ho, wo))
    tb, th, tw = pl.tile
    assert tb * th * tw == pl.rows and all(v & (v - 1) == 0 for v in pl.tile)
    assert tb <= 256 and th * stride <= 256 and tw * stride <= 256  # TMA box limits
    assert pl.k_steps == k * k * -(-cin // q8.KSTEP)
    assert 1 <= pl.splits <= pl.k_steps and (pl.splits == 1 or pl.m_tiles * pl.n_tiles < sms and pl.units <= 2 * sms)
    assert pl.units == pl.m_tiles * pl.n_tiles * pl.splits and pl.blocks == min(pl.units, sms)
    # every (pixel tile, channel tile) once, each with every K step once
    where, steps = {}, {}
    for u in range(pl.units):
        tile, corner, n0, (k0, k1) = pl.unit(u)
        assert where.setdefault(tile, (corner, n0)) == (corner, n0)
        steps.setdefault(tile, []).extend(range(k0, k1))
    grid = set(itertools.product(range(0, pl.view[0], tb), range(0, pl.view[1], th), range(0, pl.view[2], tw)))
    assert {c for c, _ in where.values()} == grid
    assert sorted({n for _, n in where.values()}) == list(range(0, cout, pl.n_width))
    assert len(where) == len(set(where.values())) == pl.m_tiles * pl.n_tiles == len(grid) * -(-cout // pl.n_width)
    assert all(sorted(ks) == list(range(pl.k_steps)) for ks in steps.values())


def test_plan_splits_the_small_sd_levels_and_not_the_pixel_path():
    """Split-K where the output tiles cannot fill 132 SMs: SD's 16^2 and 8^2
    3x3 convs; the pixel path's tiles fill the card without it."""
    for xs, ws, stride, pad in SD_TIMED[2:4]:
        pl = _plan(xs, ws, stride, pad, 132)
        assert pl.splits > 1 and pl.m_tiles * pl.n_tiles < 132 <= pl.units + pl.units // 4
    for xs, ws, stride, pad in PIXEL16:
        assert _plan(xs, ws, stride, pad, 132).splits == 1


def _slice_sum(rng, xs, ws, stride, pad, sms):
    """The plan's units, each summing its K steps (one tap's 128 channels
    each) of the plain version's int32 products over its tile, added into an
    int64 output; and the plain version's int32 accumulator."""
    xq = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, ws, dtype=np.int8))
    cout, k, _, cin = ws
    one = torch.ones(cout)
    acc = q8.int8_conv2d_plain(xq, wq, one, torch.ones(()), None, stride, pad, torch.int32)
    pl = _plan(xs, ws, stride, pad, sms)
    chunks = -(-cin // q8.KSTEP)
    steps = []
    for ks in range(pl.k_steps):
        tap, c0 = divmod(ks, chunks)
        c0 *= q8.KSTEP
        wk = torch.zeros_like(wq)
        wk[:, tap // k, tap % k, c0:c0 + q8.KSTEP] = wq[:, tap // k, tap % k, c0:c0 + q8.KSTEP]
        steps.append(q8.int8_conv2d_plain(xq, wk, one, torch.ones(()), None, stride, pad, torch.int32)
                     .reshape(-1, cout).long())
    total = torch.zeros(acc.numel() // cout, cout, dtype=torch.int64)
    view = pl.view
    for u in range(pl.units):
        _, (b0, h0, w0), n0, (k0, k1) = pl.unit(u)
        tb, th, tw = pl.tile
        b, h, w = np.meshgrid(np.arange(b0, b0 + tb), np.arange(h0, h0 + th), np.arange(w0, w0 + tw), indexing="ij")
        ok = (b < view[0]) & (h < view[1]) & (w < view[2])
        rows = torch.from_numpy(((b * view[1] + h) * view[2] + w)[ok])
        cols = torch.arange(n0, min(n0 + pl.n_width, cout))
        part = sum(steps[ks][rows][:, cols] for ks in range(k0, k1))
        total[rows[:, None], cols[None, :]] += part
    return pl, total, acc.reshape(-1, cout)


@pytest.mark.parametrize("case,xs,ws,stride,pad", [
    ("split 3x3", (2, 8, 8, 256), (128, 3, 3, 256), 1, 1),
    ("stride 2", (2, 16, 16, 128), (128, 3, 3, 128), 2, 1),
    ("swapped M=16 Linear", (16, 1, 1, 4096), (64, 1, 1, 4096), 1, 0),
    ("Cin 320", (2, 8, 8, 320), (64, 3, 3, 320), 1, 1),
])
def test_plan_k_slices_sum_to_the_plain_accumulator(rng, case, xs, ws, stride, pad):
    pl, total, acc = _slice_sum(rng, xs, ws, stride, pad, 132)
    assert pl.splits > 1 or case in ("stride 2", "Cin 320")
    assert pl.swap == (case == "swapped M=16 Linear")
    assert torch.equal(total, acc.long())


@pytest.mark.parametrize("argv", [[], ["--sd_profile"], ["--eager"], ["--quantize"]])
def test_int8_times_takes_the_path_shapes_and_needs_a_card(monkeypatch, argv):
    """``probes/int8_times.py`` times phase 22a's timed convs (the shapes
    above), and with ``--eager`` some of them and the forwards from Python;
    having no CPU mode, it exits with a usage error without a card."""
    from clip_codec_tpu_torch.probes import int8_times

    assert int8_times.CONVS == PIXEL16 + SD_TIMED
    assert set(int8_times.EAGER_CONVS) <= set(SD_TIMED)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        int8_times.main(argv)
    assert e.value.code == 2


def test_plan_is_computed_once_a_shape():
    """The launch asks for the plan on every call, and an eager SD request
    makes thousands: the same shape gives the same plan object back."""
    args = (2, 8, 8, 1280, 1280, 3, 1, 1, 132)
    first = q8.int8_conv_plan(*args)
    assert q8.int8_conv_plan(*args) is first
    assert first == min(q8.int8_conv_plans(*args),
                        key=lambda cp: (round(cp[0], 6), cp[1].splits, -cp[1].mw, -cp[1].bn))[1]


@pytest.mark.parametrize("sms", [132, 8])
def test_scratch_holds_every_split_plan(sms):
    """The scratch ``_workspace`` sizes (``csrc/int8_conv.cu`` refuses a
    launch it could not hold): a slot of ``SPLIT_TILE_INTS`` a unit of a
    split plan, a counter a tile, then absmax's counter and a float a block."""
    ints = q8._workspace_ints(sms)
    assert q8._absmax_scratch(sms) == 2 * sms * q8.SPLIT_TILE_INTS + sms
    assert ints - q8._absmax_scratch(sms) >= 4 + 2 * sms
    for xs, ws, stride, pad in SHAPES:
        pl = _plan(xs, ws, stride, pad, sms)
        assert pl.rows * pl.n_width <= q8.SPLIT_TILE_INTS
        if pl.splits > 1:
            assert pl.units <= 2 * sms and pl.m_tiles * pl.n_tiles < sms


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_int8_cli_times_needs_a_card(monkeypatch, tmp_path):
    """``probes/int8_cli_times.py`` runs phase 22c's entry points on a card;
    without one it exits with a usage error."""
    from clip_codec_tpu_torch.probes import int8_cli_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        int8_cli_times.main(["--build_dir", str(tmp_path)])
    assert e.value.code == 2
