"""The port's hand-written CUDA kernels on a card (marker ``cuda``; every test
here skips without one).

The kernels have no CPU mode, so each is held against its plain PyTorch
version on the same card in bf16: the conv kernel within rtol = atol = 2e-2
(the JAX package's bf16 bound for its own kernel,
tests/test_pallas_resblock.py), moments within 1e-3 of their largest
magnitude; flash attention's out within rtol = atol = 2e-2 and its lse
within 1e-3 absolute (fp32 statistics in both); the fused MLP within
rtol = atol = 2e-2; the fused GroupNorm+SiLU's partials within 1e-5 of
their largest magnitude and its output within rtol = atol = 2e-2 in bf16,
1e-4 in fp32, and bit-equal across calls, graph replays and SM counts;
the attention probes (P1-P3) within 2e-2 of the largest
magnitude, and softmax outputs also within rtol = atol = 2e-2 (at normal
logits their values are ~0.02, so the elementwise atol alone would let a
dropped key tile pass), the P2 row sum within 2e-2 relative; a guided
inversion step's latent gradient within 2e-2 (relative norm) of the plain
path's; PSNR and SSIM within 1e-5 of the CPU's and LPIPS within 1e-4
relative; the int8 conv (codes in, and its act form that quantizes in
shared memory), quantize and absmax bit-equal to their plain versions, and
across CUDA-graph replays; K1's codes-out form bit-equal to K1 then
``int8_quantize`` (its plain version, whose SiLU is exact where the
kernel's is approximate, within one code). This file imports no jax, so it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.ops import attention as attn
from clip_codec_tpu_torch.ops import attention_probe as ap
from clip_codec_tpu_torch.ops import int8 as q8
from clip_codec_tpu_torch.ops import mlp
from clip_codec_tpu_torch.ops import resblock_conv as rc
from clip_codec_tpu_torch.probes.conv_times import path_conv_shapes

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(rng, B, H, W, cin, cout, with_add, dev):
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = bf(rng.standard_normal((B, H, W, cin)))
    A = f32(0.5 + rng.random((B, cin)))
    Bv = f32(0.1 * rng.standard_normal((B, cin)))
    w9 = bf(rng.standard_normal((9, cin, cout)) / np.sqrt(9 * cin))
    bias = f32(0.1 * rng.standard_normal(cout))
    add = bf(rng.standard_normal((B, H, W, cout))) if with_add else None
    return x, A, Bv, w9, bias, add


@pytest.mark.parametrize("with_add,want_moments", [(False, True), (True, False), (True, True), (False, False)])
@pytest.mark.parametrize("shape", [(2, 32, 32, 64, 64), (1, 20, 12, 32, 96), (2, 16, 16, 128, 256)])
def test_kernel_matches_plain(rng, cuda, shape, with_add, want_moments):
    """Includes an image whose pixel count is not a multiple of the 128-row
    tile (20x12) and a Cout that is not a multiple of the 64-column tile."""
    args = _args(rng, *shape, with_add, cuda)
    n0 = rc.affine_silu_conv3x3.launches
    y, m = rc.affine_silu_conv3x3(*args, want_moments=want_moments)
    y_ref, m_ref = rc.affine_conv3x3_plain(*args, want_moments=want_moments)
    torch.cuda.synchronize()
    assert rc.affine_silu_conv3x3.launches == n0 + 1
    assert y.dtype == torch.bfloat16 and y.shape == y_ref.shape
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
    if want_moments:
        for k in range(2):
            assert (m[:, k] - m_ref[:, k]).abs().max() <= 1e-3 * m_ref[:, k].abs().max()
    else:
        assert m is None


@pytest.mark.parametrize("cout", [3, 8, 70])
def test_linear_kernel_matches_plain(rng, cuda, cout):
    args = _args(rng, 2, 24, 24, 64, cout, False, cuda)
    n0 = rc.affine_conv3x3.launches
    y, _ = rc.affine_conv3x3(*args)
    y_ref, _ = rc.affine_conv3x3_plain(*args, linear=True)
    torch.cuda.synchronize()
    assert rc.affine_conv3x3.launches == n0 + 1
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take(rng, cuda):
    x, A, Bv, w9, bias, _ = _args(rng, 1, 8, 8, 32, 32, False, cuda)
    n0 = rc.affine_silu_conv3x3.launches
    with pytest.raises(TypeError, match="x must be torch.bfloat16"):
        rc.affine_silu_conv3x3(x.float(), A, Bv, w9, bias)
    with pytest.raises(ValueError, match="contiguous"):
        rc.affine_silu_conv3x3(x.transpose(1, 2), A, Bv, w9, bias)
    with pytest.raises(ValueError, match="Cin % 32"):
        rc.affine_silu_conv3x3(x[..., :16].contiguous(), A[:, :16].contiguous(),
                               Bv[:, :16].contiguous(), w9[:, :16].contiguous(), bias)
    with pytest.raises(ValueError, match="is on cpu"):
        rc.affine_silu_conv3x3(x, A.cpu(), Bv, w9, bias)
    assert rc.affine_silu_conv3x3.launches == n0


def test_unet_kernel_path_matches_plain(rng, cuda):
    """A narrow U-Net (base 32: the kernel needs Cin % 32 == 0), bf16, 32px:
    the kernel path vs the same network on the plain versions."""
    net = init_params(CLIPCondUNet(z_dim=8, base=32, ch_mult=(1, 2), time_dim=32, dtype=torch.bfloat16),
                      torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).to(cuda)
    t = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    n0 = rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches
    with torch.no_grad():
        ek = net(x, z, t).float()
        n = rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches - n0
        saved = rc.affine_silu_conv3x3, rc.affine_conv3x3
        rc.affine_silu_conv3x3 = lambda *a, **k: rc.affine_conv3x3_plain(*a, **k)
        rc.affine_conv3x3 = lambda *a, **k: rc.affine_conv3x3_plain(*a, **k, linear=True)
        try:
            ep = net(x, z, t).float()
        finally:
            rc.affine_silu_conv3x3, rc.affine_conv3x3 = saved
    assert n == 2 * 10 + 1  # 10 ResBlocks at ch_mult=(1, 2), two calls each, + head
    assert torch.isfinite(ek).all()
    assert ((ek - ep).norm() / ep.norm()).item() < 2e-2


def _check_conv(args, linear, want_moments):
    fn = rc.affine_conv3x3 if linear else rc.affine_silu_conv3x3
    n0 = fn.launches
    y, m = fn(*args, want_moments=want_moments)
    y_ref, m_ref = rc.affine_conv3x3_plain(*args, want_moments=want_moments, linear=linear)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert y.dtype == torch.bfloat16 and y.shape == y_ref.shape and y.is_contiguous()
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)
    if want_moments:
        assert m.shape == m_ref.shape
        for k in range(2):
            assert (m[:, k] - m_ref[:, k]).abs().max() <= 1e-3 * m_ref[:, k].abs().max()
    return y, m


# (B, H, W, Cin, Cout, linear, with_add, want_moments): the wgmma kernel (K2)
# and the head kernel (K3: linear, no residual or moments, Cout <= 8) at
# their edges: Cin of one 32-channel half chunk and of eight chunks, Cout
# narrower than a 64-column tile and not a multiple of 8 (70, 8 and 3 with
# the residual or the moments: K2 on weights the wrapper pads), ragged
# images, one and sixteen images.
TRAP_CASES = [
    (3, 20, 12, 32, 96, False, True, True), (1, 37, 29, 32, 128, False, False, True),
    (2, 37, 29, 512, 256, False, True, False), (1, 20, 12, 512, 512, False, True, True),
    (2, 24, 24, 64, 70, True, True, True), (2, 37, 29, 64, 70, False, False, True),
    (16, 16, 16, 128, 128, False, True, True), (16, 20, 12, 32, 8, False, True, True),
    (3, 37, 29, 128, 3, True, False, True), (1, 20, 12, 512, 3, True, True, False),
    (2, 16, 16, 32, 8, False, False, False), (3, 40, 24, 96, 3, True, True, True),
    (3, 37, 29, 128, 3, True, False, False), (1, 20, 12, 512, 8, True, False, False),
    (16, 40, 24, 96, 3, True, False, False),
]


@pytest.mark.parametrize("B,H,W,cin,cout,linear,with_add,want_moments", TRAP_CASES)
def test_conv_kernels_match_plain_at_their_edges(rng, cuda, B, H, W, cin, cout, linear, with_add, want_moments):
    """With shifts |B| ~ 3: TMA zero-fills x outside the image, but
    act(0 A + B) = act(B) is not zero, so a halo pixel left unpadded after
    the prologue moves y by far more than the tolerance."""
    x, A, _, w9, bias, add = _args(rng, B, H, W, cin, cout, with_add, cuda)
    shift = torch.from_numpy((3.0 * np.sign(rng.standard_normal((B, cin)))
                              + 0.3 * rng.standard_normal((B, cin))).astype(np.float32)).to(cuda)
    _check_conv((x, A, shift, w9, bias, add), linear, want_moments)


@pytest.mark.parametrize("shape,calls", path_conv_shapes(128, (1, 2, 2), 256, 1))
def test_conv_kernels_match_plain_at_the_path_shapes(rng, cuda, shape, calls):
    """Every fused conv shape of the full-width U-Net at 256px, one image:
    the ResBlock convs in both forms the U-Net runs, the head linear."""
    B, H, W, cin, cout = shape
    if cout == 3:  # the head
        _check_conv(_args(rng, B, H, W, cin, cout, False, cuda), True, False)
        return
    for with_add, want_moments in ((False, True), (True, False)):
        _check_conv(_args(rng, B, H, W, cin, cout, with_add, cuda), False, want_moments)


@pytest.mark.parametrize("cin,cout", [(128, 128), (512, 512), (128, 70)])
def test_conv_moments_are_bit_equal_across_calls(rng, cuda, cin, cout):
    """Per-tile partials reduced in a fixed order, no atomics: two calls on
    the same inputs give the same bits, y and moments."""
    args = _args(rng, 2, 37, 29, cin, cout, False, cuda)
    y1, m1 = rc.affine_silu_conv3x3(*args, want_moments=True)
    y2, m2 = rc.affine_silu_conv3x3(*args, want_moments=True)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(m1, m2)


def test_conv_graph_replay_matches_eager(rng, cuda):
    """A ResBlock's two convs and the head recorded into one CUDA graph: the
    tensor maps go in by value, so capture copies nothing from the host; the
    replay gives the eager calls' outputs bit for bit, and no launch counter
    moves in capture or replay."""
    x, A, Bv, w9, bias, add = _args(rng, 2, 40, 24, 128, 128, True, cuda)
    w3, b3 = w9[..., :3].contiguous(), bias[:3].contiguous()

    def run():
        y, m = rc.affine_silu_conv3x3(x, A, Bv, w9, bias, want_moments=True)
        out, _ = rc.affine_silu_conv3x3(y, A, Bv, w9, bias, add=add)
        head, _ = rc.affine_conv3x3(out, A, Bv, w3, b3)
        return y, m, out, head

    want = run()
    torch.cuda.synchronize()
    n0 = (rc.affine_silu_conv3x3.launches, rc.affine_conv3x3.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert (rc.affine_silu_conv3x3.launches, rc.affine_conv3x3.launches) == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,H,W,cin,cout", [(1, 16, 16, 128, 128), (1, 32, 32, 512, 512), (1, 16, 16, 128, 3),
                                            (2, 12, 20, 256, 64)])
def test_conv_kernels_with_fewer_work_units_than_sms(rng, cuda, B, H, W, cin, cout):
    """Persistent grids of a few blocks (one 16x16 tile; four tiles x eight
    64-column Cout tiles), each walking one unit or none of the others."""
    head = cout <= 8  # K3 takes the head's function: no residual, no moments
    _check_conv(_args(rng, B, H, W, cin, cout, not head, cuda), head, not head)


def _bf16(rng, shape, scale=1.0, dev="cuda"):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, torch.bfloat16)


# (BH, N, Nk, D): the SD-1.5 shapes at 512px with CFG batched (UNet 64x64 and
# 32x32 self-attention, the VAE's single head), then ragged query and key
# tiles, a cross-attention length and a D = 72 that pads to 80.
FLASH_CASES = [(16, 4096, 4096, 40), (16, 1024, 1024, 80), (1, 4096, 4096, 512),
               (3, 200, 200, 40), (2, 130, 77, 80), (2, 96, 160, 72)]


@pytest.mark.parametrize("extreme", [False, True], ids=["normal", "extreme_logits"])
@pytest.mark.parametrize("BH,N,Nk,D", FLASH_CASES)
def test_flash_attention_matches_plain(rng, cuda, BH, N, Nk, D, extreme):
    """Extreme logits: q scaled so that |logit| reaches ~1e2..1e3, where a
    softmax without the running max would overflow."""
    q = _bf16(rng, (BH, N, D), 30.0 if extreme else 1.0)
    k = _bf16(rng, (BH, Nk, D))
    v = _bf16(rng, (BH, Nk, D))
    n0 = attn.flash_attention_fwd.launches
    out, lse = attn.flash_attention_fwd(q, k, v)
    ref, lse_ref = attn.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert attn.flash_attention_fwd.launches == n0 + 1
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B", [2, 1])
def test_flash_attention_heads_layout(rng, cuda, B):
    """(B, H, N, D) heads as the blocks pass them, a transpose of (B, N, H,
    D); at B = 1 its (B*H, N, D) reshape is a strided view."""
    q, k, v = (_bf16(rng, (B, 256, 3, 40)).transpose(1, 2) for _ in range(3))
    out = attn.flash_attention_heads(q, k, v)
    r = lambda t: t.reshape(B * 3, 256, 40)
    ref, _ = attn.flash_attention_plain(r(q), r(k), r(v))
    torch.testing.assert_close(out.float(), ref.reshape(B, 3, 256, 40).float(), rtol=2e-2, atol=2e-2)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(rng, cuda):
    q = _bf16(rng, (2, 128, 80))
    n0 = attn.flash_attention_fwd.launches
    with pytest.raises(TypeError, match="q must be torch.bfloat16"):
        attn.flash_attention_fwd(q.float(), q, q)
    for d in (36, 64):  # not a multiple of 8; a depth with no instantiation
        with pytest.raises(ValueError, match="kernel takes D in"):
            r = q[..., :d].contiguous()
            attn.flash_attention_fwd(r, r, r)
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention_fwd(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="is on cpu"):
        attn.flash_attention_fwd(q, q.cpu(), q)
    assert attn.flash_attention_fwd.launches == n0


# (BH, N, Nk, D): the SD-1.5 training shapes at 512px, batch 4 (64x64 and
# 32x32 self-attention over 8 heads, the VAE's single head), then a ragged
# query tile and ragged query and key tiles with N != Nk.
FLASH_BWD_CASES = [(32, 4096, 4096, 40), (32, 1024, 1024, 80), (4, 4096, 4096, 512), (1, 4096, 4096, 512),
                   (3, 200, 200, 40), (2, 130, 77, 80), (1, 130, 77, 512)]


@pytest.mark.parametrize("extreme", [False, True], ids=["normal", "extreme_logits"])
@pytest.mark.parametrize("BH,N,Nk,D", FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_plain(rng, cuda, BH, N, Nk, D, extreme):
    """dq, dk, dv of the two backward kernels against the plain fp32
    backward on the same bf16 inputs and the same saved (out, lse): within
    rtol = 2e-2 and atol = 2e-2 of each gradient's largest magnitude."""
    q = _bf16(rng, (BH, N, D), 30.0 if extreme else 1.0)
    k, v = _bf16(rng, (BH, Nk, D)), _bf16(rng, (BH, Nk, D))
    dout = _bf16(rng, (BH, N, D))
    out, lse = attn.flash_attention_plain(q, k, v)
    n0 = attn.flash_attention_bwd_dq.launches, attn.flash_attention_bwd_dkv.launches
    got = attn.flash_attention_bwd(q, k, v, out, lse, dout)
    want = attn.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert (attn.flash_attention_bwd_dq.launches, attn.flash_attention_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        g, w = g.float(), w.float()
        bound = 2e-2 * (w.abs() + w.abs().max())
        assert bool(((g - w).abs() <= bound).all()), (name, (g - w).abs().max().item(), w.abs().max().item())


def test_flash_attention_autograd_launches_both_directions(rng, cuda):
    """Backward through flash_attention_heads runs the forward kernel once
    and each backward kernel once, and agrees with autograd through the
    materializing version."""
    q, k, v = (_bf16(rng, (2, 4, 256, 80)).requires_grad_(True) for _ in range(3))
    g = _bf16(rng, (2, 4, 256, 80))
    n0 = (attn.flash_attention_fwd.launches, attn.flash_attention_bwd_dq.launches,
          attn.flash_attention_bwd_dkv.launches)
    attn.flash_attention_heads(q, k, v).backward(g)
    n = (attn.flash_attention_fwd.launches - n0[0], attn.flash_attention_bwd_dq.launches - n0[1],
         attn.flash_attention_bwd_dkv.launches - n0[2])
    got = [t.grad.float() for t in (q, k, v)]
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    r3 = lambda t: t.reshape(8, 256, 80)
    attn.flash_attention_plain(r3(qf), r3(kf), r3(vf))[0].reshape(2, 4, 256, 80).backward(g.float())
    assert n == (1, 1, 1)
    for a, b in zip(got, (qf.grad, kf.grad, vf.grad)):
        assert ((a - b).abs().max() <= 2e-2 * b.abs().max()).item()


def test_flash_bwd_wrapper_rejects_what_the_kernel_does_not_take(rng, cuda):
    q = _bf16(rng, (2, 128, 80))
    lse = torch.zeros((2, 128), device=cuda)
    n0 = attn.flash_attention_bwd_dq.launches + attn.flash_attention_bwd_dkv.launches
    for d in (36, 64, 128):  # not a multiple of 8; depths with no instantiation
        r = q[..., :d].contiguous() if d <= 80 else _bf16(rng, (2, 128, d))
        with pytest.raises(ValueError, match="kernel takes D in"):
            attn.flash_attention_bwd(r, r, r, r, lse, r)
    with pytest.raises(TypeError, match="lse2 must be torch.float32"):
        attn.flash_attention_bwd_dq(q, q, q, q, lse.bfloat16(), lse)
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_attention_bwd_dkv(q, q, q, q.transpose(1, 2).contiguous().transpose(1, 2), lse, lse)
    assert attn.flash_attention_bwd_dq.launches + attn.flash_attention_bwd_dkv.launches == n0


# (BH, N, Nk, D) at the edges of the kernels' TMA rings. Forward: 192 query
# rows per block and key tiles of 128 at D = 40, 128 rows and 64-key tiles at
# D = 80, 128 rows and 32-key tiles at D = 512. Backward: 128 rows per block
# and 64-row tiles (D = 40, 80), 64 and 16 at D = 512. Cases: Nk equal to one
# key tile; Nk one row over a tile; N below 64; N not a multiple of the
# block's rows; more blocks than the card's SMs; D = 72 and D = 512 with
# ragged N and Nk.
FLASH_EDGE_CASES = [(2, 256, 128, 40), (2, 256, 64, 80), (1, 128, 32, 512),
                    (2, 256, 129, 40), (2, 256, 65, 80), (1, 130, 33, 512),
                    (3, 17, 300, 40), (2, 300, 200, 40), (2, 200, 256, 80), (300, 128, 128, 40),
                    (2, 77, 150, 72), (2, 100, 70, 512)]
FLASH_BWD_EDGE_CASES = [(2, 128, 64, 40), (1, 64, 16, 512),
                        (2, 128, 65, 40), (1, 64, 17, 512),
                        (2, 20, 100, 80), (2, 200, 128, 40), (300, 128, 128, 80),
                        (2, 77, 150, 72), (1, 90, 70, 512)]


@pytest.mark.parametrize("BH,N,Nk,D", FLASH_EDGE_CASES)
def test_flash_attention_ring_edges_match_plain(rng, cuda, BH, N, Nk, D):
    q, k, v = _bf16(rng, (BH, N, D)), _bf16(rng, (BH, Nk, D)), _bf16(rng, (BH, Nk, D))
    out, lse = attn.flash_attention_fwd(q, k, v)
    ref, lse_ref = attn.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("BH,N,Nk,D", FLASH_BWD_EDGE_CASES)
def test_flash_attention_bwd_ring_edges_match_plain(rng, cuda, BH, N, Nk, D):
    q, k, v = _bf16(rng, (BH, N, D)), _bf16(rng, (BH, Nk, D)), _bf16(rng, (BH, Nk, D))
    dout = _bf16(rng, (BH, N, D))
    out, lse = attn.flash_attention_plain(q, k, v)
    got = attn.flash_attention_bwd(q, k, v, out, lse, dout)
    want = attn.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        bound = 2e-2 * (w.abs() + w.abs().max())
        assert bool(((g - w).abs() <= bound).all()), (name, (g - w).abs().max().item(), w.abs().max().item())


def test_flash_attention_graph_replay_matches_eager(rng, cuda):
    """K4 and the K5 pair recorded into one CUDA graph: the tensor maps go in
    by value, so capture copies nothing from the host; the replay gives the
    eager calls' outputs bit for bit, and no launch counter moves in capture
    or replay."""
    q, k, v, dout = (_bf16(rng, (4, 300, 40)) for _ in range(4))
    counters = (attn.flash_attention_fwd, attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv)

    def run():
        out, lse = attn.flash_attention_fwd(q, k, v)
        return (out, lse, *attn.flash_attention_bwd(q, k, v, out, lse, dout))

    want = run()
    torch.cuda.synchronize()
    n0 = [c.launches for c in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    assert [c.launches for c in counters] == n0
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == n0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _mlp_args(rng, R, C, F, dev="cuda"):
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = _bf16(rng, (R, C))
    lns, lnb = f32(1 + 0.1 * rng.standard_normal(C)), f32(0.1 * rng.standard_normal(C))
    wh, wg = (f32(rng.standard_normal((C, F)) / np.sqrt(C)) for _ in range(2))
    bh, bg = (f32(0.1 * rng.standard_normal(F)) for _ in range(2))
    wo = f32(rng.standard_normal((F, C)) / np.sqrt(F))
    return x, lns, lnb, wh, bh, wg, bg, wo


# (R, C, F): the four SD-1.5 MLP shapes at 512px, batch 2, the 320-wide one
# at batch 8 (a request of four embeddings; enough row tiles for no split),
# then ragged rows.
MLP_CASES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
             (32768, 320, 1280), (100, 320, 1280), (37, 640, 2560)]


@pytest.mark.parametrize("R,C,F", MLP_CASES)
def test_transformer_mlp_matches_plain(rng, cuda, R, C, F):
    x, lns, lnb, wh, bh, wg, bg, wo = _mlp_args(rng, R, C, F)
    n0 = mlp.transformer_mlp.launches
    y = mlp.transformer_mlp(x, lns, lnb, wh, bh, wg, bg, wo)
    ref = mlp.mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo)
    torch.cuda.synchronize()
    assert mlp.transformer_mlp.launches == n0 + 1
    assert y.dtype == torch.bfloat16 and y.shape == (R, C)
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("R,C,F", MLP_CASES)
def test_mlp_stages_match_their_plain_pieces(rng, cuda, R, C, F):
    """mlp_up (LayerNorm pre-pass + GEGLU product) against mlp_up_plain, and
    mlp_down against mlp_down_plain on the same h, each on its own launch
    counter."""
    x, lns, lnb, wh, bh, wg, bg, wo = _mlp_args(rng, R, C, F)
    packed = mlp.pack_weights(wh, wg, wo)
    n0 = mlp.mlp_up.launches, mlp.mlp_down.launches, mlp.transformer_mlp.launches
    h = mlp.mlp_up(x, lns, lnb, wh, bh, wg, bg, packed)
    h_ref = mlp.mlp_up_plain(x, lns, lnb, wh, bh, wg, bg)
    y = mlp.mlp_down(h_ref, wo, packed)
    y_ref = mlp.mlp_down_plain(h_ref, wo)
    torch.cuda.synchronize()
    assert (mlp.mlp_up.launches, mlp.mlp_down.launches, mlp.transformer_mlp.launches) == (n0[0] + 1, n0[1] + 1, n0[2])
    assert h.dtype == torch.bfloat16 and h.shape == (R, F) and y.shape == (R, C)
    torch.testing.assert_close(h.float(), h_ref.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2, atol=2e-2)


def test_transformer_mlp_cases_cover_both_epilogues(cuda):
    """The cases above run the out-projection with one split (bf16 stored
    from registers) and with several (fp32 partials summed by a second
    kernel), as ``down_splits`` picks for the card's SM count."""
    splits = {mlp.kernel_splits(R, C, F, cuda) for R, C, F in MLP_CASES}
    assert 1 in splits and max(splits) > 1


@pytest.mark.parametrize("splits", [1, 2, 3, 40])
def test_mlp_down_any_split_count_matches_one(rng, cuda, splits):
    """Every split count without an empty split gives the same y within
    bf16 rounding of the fp32 partials' sum; one split is bit-equal to a
    second run (deterministic)."""
    _, _, _, _, _, _, _, wo = _mlp_args(rng, 300, 640, 2560)
    h = _bf16(rng, (300, 2560))
    y1 = mlp.mlp_down(h, wo, splits=1)
    y = mlp.mlp_down(h, wo, splits=splits)
    torch.testing.assert_close(y.float(), y1.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(y, mlp.mlp_down(h, wo, splits=splits))


def test_transformer_mlp_packed_weights_and_token_view(rng, cuda):
    """Pre-packed weights (the model's cached form) on (B, N, C) tokens give
    the same output as packing on the call."""
    x, lns, lnb, wh, bh, wg, bg, wo = _mlp_args(rng, 2 * 64, 320, 1280)
    packed = mlp.pack_weights(wh, wg, wo)
    y3 = mlp.transformer_mlp(x.reshape(2, 64, 320), lns, lnb, wh, bh, wg, bg, wo, packed=packed)
    y2 = mlp.transformer_mlp(x, lns, lnb, wh, bh, wg, bg, wo)
    torch.cuda.synchronize()
    assert y3.shape == (2, 64, 320)
    assert torch.equal(y3.reshape(128, 320), y2)


@pytest.mark.parametrize("R,C,F", [(2048, 640, 2560), (37, 320, 1280)])
def test_transformer_mlp_backward_is_autograd_of_plain(rng, cuda, R, C, F):
    """The MLP Function's backward on the card: the gradients of x and of the
    LayerNorm scale equal autograd of mlp_plain on the same inputs, and the
    frozen weights get none."""
    x, lns, lnb, wh, bh, wg, bg, wo = _mlp_args(rng, R, C, F)
    x.requires_grad_(True)
    lns.requires_grad_(True)
    g = _bf16(rng, (R, C))
    n0 = mlp.transformer_mlp.launches
    mlp.transformer_mlp(x, lns, lnb, wh, bh, wg, bg, wo).backward(g)
    assert mlp.transformer_mlp.launches == n0 + 1 and wh.grad is None
    got = x.grad.clone(), lns.grad.clone()
    x.grad = lns.grad = None
    mlp.mlp_plain(x, lns, lnb, wh, bh, wg, bg, wo).backward(g)
    assert torch.equal(got[0], x.grad)
    torch.testing.assert_close(got[1], lns.grad, rtol=0, atol=0)


def test_mlp_wrapper_rejects_what_the_kernel_does_not_take(rng, cuda):
    x, lns, lnb, wh, bh, wg, bg, wo = _mlp_args(rng, 64, 320, 1280)
    n0 = mlp.transformer_mlp.launches
    with pytest.raises(TypeError, match="x must be torch.bfloat16"):
        mlp.transformer_mlp(x.float(), lns, lnb, wh, bh, wg, bg, wo)
    with pytest.raises(TypeError, match="lns must be torch.float32"):
        mlp.transformer_mlp(x, lns.bfloat16(), lnb, wh, bh, wg, bg, wo)
    with pytest.raises(ValueError, match="C in"):
        a = _mlp_args(rng, 64, 48, 192)
        mlp.transformer_mlp(*a)
    with pytest.raises(ValueError, match="is on cpu"):
        mlp.transformer_mlp(x, lns.cpu(), lnb, wh, bh, wg, bg, wo)
    assert mlp.transformer_mlp.launches == n0


def test_sd_unet_and_vae_kernel_paths_match_plain(cuda):
    """Shallow SD blocks at SD-1.5's first two widths and 8 heads (head dims
    40 and 80; the VAE's last width is SD-1.5's 512, its mid-block head
    dim), bf16, 32x32 latents so that N = 1024 takes flash attention: the
    kernel path vs the same modules on the plain versions."""
    from clip_codec_tpu_torch.models.sd import AutoencoderKL, SDUNet, SDUNetConfig, VAEConfig

    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.device(cuda):
        unet = init_params(SDUNet(SDUNetConfig(block_out=(320, 640), layers_per_block=1, cross_dim=32,
                                               heads=8, freq_dim=32), dtype=torch.bfloat16), gen).eval()
        vae = init_params(AutoencoderKL(VAEConfig(block_out=(128, 512), layers_per_block=1),
                                        dtype=torch.bfloat16), gen).eval()
    lat = torch.randn((2, 32, 32, 4), generator=gen, device=cuda)
    ctx = torch.randn((2, 8, 32), generator=gen, device=cuda)
    t = torch.tensor([981, 41], dtype=torch.int32, device=cuda)

    def run():
        return unet(lat, t, ctx).float(), vae.decode(lat).float()

    with torch.no_grad():
        n0 = attn.flash_attention_fwd.launches, mlp.transformer_mlp.launches
        ek, yk = run()
        n = attn.flash_attention_fwd.launches - n0[0], mlp.transformer_mlp.launches - n0[1]
        saved = attn.flash_attention_fwd, mlp.transformer_mlp
        attn.flash_attention_fwd = attn.flash_attention_plain
        mlp.transformer_mlp = lambda *a, packed=None: mlp.mlp_plain(*a)
        try:
            ep, yp = run()
        finally:
            attn.flash_attention_fwd, mlp.transformer_mlp = saved
    # flash: 3 self-attentions at 32x32 (320 wide) + the VAE mid-block; MLP: 4 blocks
    assert n == (4, 4)
    assert torch.isfinite(ek).all() and torch.isfinite(yk).all()
    assert ((ek - ep).norm() / ep.norm()).item() < 2e-2
    assert ((yk - yp).norm() / yp.norm()).item() < 2e-2


# (B, H, W, C, G): a ragged last slab (37 x 29 pixels), groups of fewer
# than 8 channels (C/G = 4 and 3: one thread's 8-channel vector spans two or
# three groups), one group, and a training shape.
GN_CASES = [(3, 37, 29, 64, 8), (2, 9, 7, 32, 8), (2, 16, 16, 24, 8), (1, 5, 3, 16, 1), (8, 64, 64, 256, 8)]
# Shapes of several rounds (8 and 2 on a 132-SM card), and a sample larger
# than a round (its slabs past the blocks' buffers are read from device memory).
GN_ROUND_CASES = [((8, 256, 256, 128, 8), torch.bfloat16), ((8, 128, 128, 128, 8), torch.float32),
                  ((1, 512, 512, 128, 8), torch.bfloat16)]


def _gn_args(rng, B, H, W, C, dtype, dev):
    x = torch.from_numpy((rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)).to(dev, dtype)
    scale = torch.from_numpy((1 + 0.2 * rng.standard_normal(C)).astype(np.float32)).to(dev)
    bias = torch.from_numpy((0.2 * rng.standard_normal(C)).astype(np.float32)).to(dev)
    return x, scale, bias


def _check_gn(x, scale, bias, G):
    """Two launches of K1, bit-equal, against its plain version: the slab
    partials within 1e-5 of their largest magnitude, y against the
    normalisation from the plain partials and against
    ``group_norm_silu_plain`` within 1e-4 (fp32) or rtol = atol = 2e-2
    (bf16: the plain version rounds the normalised value once more)."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    n0 = gn.group_norm_silu.launches
    y = gn.group_norm_silu(x, (scale, bias), G)
    y_again, part = gn._launch(x, scale, bias, G, gn.GN_EPS)  # the wrapper's launch, with its partials
    torch.cuda.synchronize()
    assert gn.group_norm_silu.launches == n0 + 2
    assert torch.equal(y, y_again)
    part_ref = gn.group_norm_silu_stats_plain(x, G)
    assert part.shape == part_ref.shape
    for k in range(2):
        assert (part[:, :, k] - part_ref[:, :, k]).abs().max() <= 1e-5 * part_ref[:, :, k].abs().max()
    y_pieces = gn.group_norm_silu_norm_plain(x, part_ref, scale, bias, G)
    y_ref = gn.group_norm_silu_plain(x, (scale, bias), G)
    tol = dict(rtol=1e-4, atol=1e-4) if x.dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    assert y.dtype == x.dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), y_pieces.float(), **tol)
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,G", GN_CASES)
def test_group_norm_silu_matches_plain(rng, cuda, B, H, W, C, G, dtype):
    """K1 against its plain version and ``group_norm_silu_plain``, one
    launch per call."""
    _check_gn(*_gn_args(rng, B, H, W, C, dtype, cuda), G)


@pytest.mark.parametrize("shape,dtype", GN_ROUND_CASES, ids=["8x256^2x128-bf16", "8x128^2x128-fp32",
                                                               "1x512^2x128-bf16"])
def test_group_norm_silu_rounds_and_large_samples_match_plain(rng, cuda, shape, dtype):
    B, H, W, C, G = shape
    _check_gn(*_gn_args(rng, B, H, W, C, dtype, cuda), G)


@pytest.mark.parametrize("shape,dtype", [((3, 37, 29, 64, 8), torch.float32)] + GN_ROUND_CASES[:2],
                         ids=["3x37x29x64-fp32", "8x256^2x128-bf16", "8x128^2x128-fp32"])
def test_group_norm_silu_is_bit_equal_across_calls_and_graph_replays(rng, cuda, shape, dtype):
    """Two eager calls give bit-equal y, and so do two replays of the call
    captured in a CUDA graph (the grid barrier resets itself)."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    B, H, W, C, G = shape
    x, scale, bias = _gn_args(rng, B, H, W, C, dtype, cuda)
    y1 = gn.group_norm_silu(x, (scale, bias), G)
    y2 = gn.group_norm_silu(x, (scale, bias), G)
    assert torch.equal(y1, y2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        yg = gn.group_norm_silu(x, (scale, bias), G)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        yg.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(yg, y1)


@pytest.mark.parametrize("shape,dtype", [((8, 128, 128, 128, 8), torch.bfloat16), ((3, 37, 29, 64, 8), torch.float32)],
                         ids=["8x128^2x128-bf16", "3x37x29x64-fp32"])
def test_group_norm_silu_is_bit_equal_on_any_sm_count(rng, cuda, shape, dtype):
    """The statistics come from a slab cut fixed by the shape and are summed
    in an order fixed by it: on 114 or 7 SMs (other rounds and grids, and on
    7 most slabs read from device memory) y and the partials are bit-equal
    to the whole card's."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    B, H, W, C, G = shape
    x, scale, bias = _gn_args(rng, B, H, W, C, dtype, cuda)
    y, part = gn._launch(x, scale, bias, G, gn.GN_EPS)
    for sms in (114, 7):
        assert gn.plan(B, H, W, C, G, x.element_size(), sms).grid <= sms
        y_s, part_s = gn._launch(x, scale, bias, G, gn.GN_EPS, sms)
        assert torch.equal(part_s, part) and torch.equal(y_s, y), sms


def test_group_norm_silu_plan_at_the_path_shapes(cuda):
    """The kernel's plan on a 132-SM card at the four batch-8 training
    shapes in bf16 (8 groups): one sample a round at 256^2 (8 rounds), 4 at
    128^2 (2 rounds), the two smaller shapes in one round, 6 chunk buffers a
    block; a 512^2 sample is larger than a round. On 114 SMs the slabs stay
    the same and only the rounds and the grid follow."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    if torch.cuda.get_device_properties(cuda).multi_processor_count < 132:
        pytest.skip("the expected plan is a 132-SM card's")
    want = {(256, 128): (512, 128, 1, 8, 128), (128, 128): (128, 128, 4, 2, 132), (64, 256): (64, 64, 8, 1, 132),
            (32, 512): (32, 32, 8, 1, 132)}
    for (s, C), (rows, S, per_round, rounds, grid) in want.items():
        p = gn.plan(8, s, s, C, 8, 2, 132)
        assert (p.slab_rows, p.slabs, p.per_round, p.rounds, p.grid, p.ring) == (rows, S, per_round, rounds, grid, 6)
        q = gn.plan(8, s, s, C, 8, 2, 114)
        assert q[:5] == p[:5] and q.grid <= 114 and q.per_round * q.rounds >= 8 > (q.rounds - 1) * q.per_round
    big = gn.plan(1, 512, 512, 128, 8, 2, 132)
    assert (big.slabs, big.chunks, big.rounds, big.grid) == (512, 4, 1, 132)
    assert big.slabs > 132 * ((big.ring - 1) // big.chunks)
    assert gn.plan(8, 128, 128, 128, 8, 4, 132)[:8] == (128, 128, 64, 2, 6, 2, 4, 132)  # fp32: 2 chunks a slab


def test_group_norm_silu_plan_fits_every_shape(cuda):
    """Every shape ``group_norm_silu`` takes (C a multiple of 8 up to 2048,
    every G that divides C, one pixel to 1024^2 a sample, batch 1 and 8,
    bf16 and fp32) gets a plan from the kernel that fits a block's shared
    memory, no more blocks than SMs, and rounds that cover the batch."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    props = torch.cuda.get_device_properties(cuda)
    optin = props.shared_memory_per_block_optin
    hws = [(1, 1), (1, 3), (37, 29), (64, 64), (128, 128), (257, 255), (512, 512), (1024, 1024)]
    for C in range(8, 2049, 8):
        for G in (g for g in range(1, C + 1) if C % g == 0):
            for H, W in hws:
                for B in (1, 8):
                    for itemsize in (2, 4):
                        p = gn.plan(B, H, W, C, G, itemsize)
                        assert p.smem <= optin and 1 <= p.grid <= props.multi_processor_count
                        assert p.ring > p.chunks and p.per_round * p.rounds >= B > (p.rounds - 1) * p.per_round
                        slots = (p.ring - 1) // p.chunks
                        assert p.per_round == 1 or -(-p.per_round * p.slabs // p.grid) <= slots


def test_group_norm_silu_rejects_what_the_kernel_does_not_take(rng, cuda):
    from clip_codec_tpu_torch.ops import groupnorm as gn

    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 32)).astype(np.float32)).to(cuda)
    sb = (torch.ones(32, device=cuda), torch.zeros(32, device=cuda))
    n0 = gn.group_norm_silu.launches
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
            gn.group_norm_silu(x.to(dt), sb, 8)
    with pytest.raises(ValueError, match="C % 8 == 0"):
        gn.group_norm_silu(x[..., :12].contiguous(), (sb[0][:12], sb[1][:12]), 4)
    with pytest.raises(ValueError, match="C <= 2048"):
        gn.group_norm_silu(torch.zeros((1, 2, 2, 4096), device=cuda), (torch.ones(4096, device=cuda),) * 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu(x.transpose(1, 2), sb, 8)
    with pytest.raises(TypeError, match="scale must be torch.float32"):
        gn.group_norm_silu(x, (sb[0].bfloat16(), sb[1]), 8)
    with pytest.raises(ValueError, match="not a multiple of groups"):
        gn.group_norm_silu(x, sb, 3)
    with pytest.raises(ValueError, match="is on cpu"):
        gn.group_norm_silu(x, (sb[0].cpu(), sb[1]), 8)
    assert gn.group_norm_silu.launches == n0


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (3, 37, 29, 32)])
def test_group_norm_silu_backward_is_autograd_of_plain(rng, cuda, shape):
    """The autograd Function's dx, dscale and dbias on the card against
    autograd of group_norm_silu_plain on the same bf16 inputs (the backward
    recomputes the plain version, so it is exact up to the kernel's forward
    having run)."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    x = _bf16(rng, shape, 2.0).requires_grad_(True)
    C = shape[-1]
    scale = torch.from_numpy((1 + 0.2 * rng.standard_normal(C)).astype(np.float32)).to(cuda).requires_grad_(True)
    bias = torch.from_numpy((0.2 * rng.standard_normal(C)).astype(np.float32)).to(cuda).requires_grad_(True)
    g = _bf16(rng, shape)
    n0 = gn.group_norm_silu.launches
    gn.group_norm_silu(x, (scale, bias), 8).backward(g)
    assert gn.group_norm_silu.launches == n0 + 1
    got = [t.grad.clone() for t in (x, scale, bias)]
    for t in (x, scale, bias):
        t.grad = None
    gn.group_norm_silu_plain(x, (scale, bias), 8).backward(g)
    for a, t in zip(got, (x, scale, bias)):
        assert a.dtype == t.dtype
        assert torch.equal(a, t.grad)


def test_unet_training_form_runs_k1_and_trains(rng, cuda):
    """The direct (training) form of a narrow U-Net on the card, bf16, 32px:
    each forward launches K1 twice per ResBlock (20 times: 10 ResBlocks at
    ch_mult=(1, 2)) and no fused conv; every parameter gets a finite
    gradient, and eps agrees with the same network on the plain GroupNorm+SiLU."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    net = init_params(CLIPCondUNet(z_dim=8, base=32, ch_mult=(1, 2), time_dim=32, dtype=torch.bfloat16,
                                   fused_pallas=False), torch.Generator().manual_seed(0)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).to(cuda)
    t = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    n0 = (gn.group_norm_silu.launches, rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches)
    ek = net(x, z, t)
    ek.float().square().mean().backward()
    n = (gn.group_norm_silu.launches - n0[0], rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches - n0[1])
    assert n == (20, 0)
    for name, p in net.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    saved = gn.group_norm_silu
    gn.group_norm_silu = gn.group_norm_silu_plain
    try:
        with torch.no_grad():
            ep = net(x, z, t).float()
    finally:
        gn.group_norm_silu = saved
    assert ((ek.detach().float() - ep).norm() / ep.norm()).item() < 2e-2


# ------------------------------------------------- attention probes (P1-P3)


def _probe_qkv(rng, D):
    return tuple(_bf16(rng, (2, 512, D)) for _ in range(3))


def _within_of_max(got, want, tol=2e-2):
    """max |got - want| within ``tol`` of want's largest magnitude."""
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.parametrize("D", [40, 48])
@pytest.mark.parametrize("mode,tq,tk", ap.P1_TILES)
def test_probe_variant_matches_plain(rng, cuda, mode, tq, tk, D):
    """Every instantiated P1 kernel; noexp against the plain version at tk =
    the kernel's key tile (its output depends on the tile width)."""
    q, k, v = _probe_qkv(rng, D)
    n0 = ap.flash_variant.launches
    out = ap.flash_variant(q, k, v, tq, tk, mode)
    ref = ap.flash_variant_plain(q, k, v, tk, mode)
    torch.cuda.synchronize()
    assert ap.flash_variant.launches == n0 + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _within_of_max(out, ref)
    if mode not in ("noexp", "dotonly"):
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def _check_fast(acc, ref, D):
    """P2's raw accumulator: the last column (the row sum) within 2e-2
    relative, the divided output within 2e-2."""
    assert acc.dtype == torch.float32 and acc.shape == ref.shape and acc.shape[-1] == D + 1
    assert bool(((acc[..., D] - ref[..., D]).abs() <= 2e-2 * ref[..., D].abs()).all())
    out, out_ref = ((a[..., :D] / a[..., D:]).to(torch.bfloat16).float() for a in (acc, ref))
    _within_of_max(out, out_ref)
    torch.testing.assert_close(out, out_ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("D", [40, 48])
@pytest.mark.parametrize("deg,mxu_sum,tq,tk", ap.P2_TILES)
def test_probe_fast_matches_plain(rng, cuda, deg, mxu_sum, tq, tk, D):
    """Every instantiated P2 kernel at both depths (at D = 48 the mxu-sum's
    ones column widens P.V to 64): its raw accumulator against plain."""
    q, k, v = _probe_qkv(rng, D)
    n0 = ap.fast_flash_acc.launches
    acc = ap.fast_flash_acc(q, k, v, tq, tk, deg, mxu_sum)
    ref = ap.fast_flash_plain(q, k, v, tk, deg, mxu_sum)
    torch.cuda.synchronize()
    assert ap.fast_flash_acc.launches == n0 + 1
    assert acc.shape == (2, 512, D + 1)
    _check_fast(acc, ref, D)


@pytest.mark.parametrize("deg,mxu_sum,tq,tk", ap.P2_TILES)
def test_probe_fast_extreme_logits(rng, cuda, deg, mxu_sum, tq, tk):
    """q x 30: logits up to ~1e3, so about half of s - m fall below -126, where
    ``fast_exp2`` gives 2^-126 p(frac x), not 0; the kernel alone on
    ``fast_v``'s v gives the wrapper's accumulator."""
    q, k, v = _probe_qkv(rng, 40)
    q = (q.float() * 30).to(torch.bfloat16)
    acc = ap.fast_flash_acc(q, k, v, tq, tk, deg, mxu_sum)
    ref = ap.fast_flash_plain(q, k, v, tk, deg, mxu_sum)
    alone = ap.fast_flash_kernel(q, k, ap.fast_v(v, mxu_sum), tq, tk, deg, mxu_sum)
    torch.cuda.synchronize()
    s = (q.float() @ k.float().transpose(1, 2)) * (ap._scale(40) * ap.LOG2E)
    assert bool(((s - s.amax(-1, keepdim=True)) < -126).float().mean() > 0.25)
    _check_fast(acc, ref, 40)
    assert torch.equal(alone, acc)


@pytest.mark.parametrize("D", [40, 48])
@pytest.mark.parametrize("tq", ap.P3_TILES)
def test_probe_single_pass_matches_plain(rng, cuda, tq, D):
    q, k, v = _probe_qkv(rng, D)
    n0 = ap.single_pass.launches
    out = ap.single_pass(q, k, v, tq)
    ref = ap.single_pass_plain(q, k, v)
    torch.cuda.synchronize()
    assert ap.single_pass.launches == n0 + 1
    _within_of_max(out, ref)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("mode", ["full", "exp2"])
def test_probe_variant_at_k4s_tile_matches_k4(rng, cuda, mode):
    """P1 full and exp2 at (192, 128) compute K4's function on K4's loop
    (with expf or exp2f and the scale in q or a separate multiply): out
    within rtol = atol = 2e-2 and 2e-2 of the largest magnitude of K4's."""
    q, k, v = _probe_qkv(rng, 40)
    out = ap.flash_variant(q, k, v, 192, 128, mode)
    ref = attn.flash_attention_fwd(q, k, v)[0]
    torch.cuda.synchronize()
    _within_of_max(out, ref)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def _in_poisoned(a, fill):
    """``a`` copied to the front of a flat buffer whose tail (192 rows) holds
    ``fill``; returns the view and the buffer."""
    BH, N, D = a.shape
    buf = torch.full((BH * N * D + 192 * D,), fill, dtype=a.dtype, device=a.device)
    buf[:BH * N * D] = a.flatten()
    return buf[:BH * N * D].view(BH, N, D), buf


@pytest.mark.parametrize("kind", ["full", "single_pass", "fast"])
def test_probe_partial_last_query_tile(rng, cuda, kind):
    """N = 4096 at tq = 192: the last query tile of each head holds 64 rows.
    Every row matches plain; q, k and v lie at the front of buffers whose
    tail is NaN (a key row read past N of the last head would show in the
    output), and out at the front of one whose tail is a sentinel that no
    row written past N may overwrite. The C entry points are called
    directly, into the poisoned out (P2: poly2 + mxu-sum at (192, 128), its
    fp32 (D + 1)-wide accumulator, from a poisoned ``fast_v``)."""
    BH, N, D = 2, 4096, 40
    q, k, v = (_in_poisoned(_bf16(rng, (BH, N, D)), float("nan"))[0] for _ in range(3))
    out, out_buf = _in_poisoned(torch.zeros_like(q), 7.0)
    if kind == "fast":
        vk = _in_poisoned(ap.fast_v(v, True), float("nan"))[0]
        acc, acc_buf = _in_poisoned(torch.zeros((BH, N, D + 1), dtype=torch.float32, device=q.device), 7.0)
        ap._launch("attn_probe_fast_bf16", q, q.data_ptr(), k.data_ptr(), vk.data_ptr(), acc.data_ptr(),
                   BH, N, D, vk.shape[-1], 192, 128, 2, 1, ap._scale(D) * ap.LOG2E)
        ref = ap.fast_flash_plain(q, k, v, 128, 2, True)
        torch.cuda.synchronize()
        assert bool((acc_buf[BH * N * (D + 1):] == 7.0).all())
        _check_fast(acc, ref, D)
        _check_fast(acc[:, N - 64:], ref[:, N - 64:], D)  # the partial tile's rows, held on their own
        return
    if kind == "full":
        ap._launch("attn_probe_variant_bf16", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   BH, N, D, 192, 128, ap.MODES.index("full"), ap._scale(D))
        ref = ap.flash_variant_plain(q, k, v, 128, "full")
    else:
        ap._launch("attn_probe_single_pass_bf16", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   BH, N, D, 192, ap._scale(D))
        ref = ap.single_pass_plain(q, k, v)
    torch.cuda.synchronize()
    assert bool((out_buf[BH * N * D:] == 7.0).all())
    _within_of_max(out, ref)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    tail = out[:, N - 64:]  # the partial tile's rows, held on their own
    _within_of_max(tail, ref[:, N - 64:])


@pytest.mark.parametrize("tq", ap.P3_TILES)
def test_probe_single_pass_extreme_logits(rng, cuda, tq):
    """q x 30: logits up to ~1e3, where a wrong max would overflow expf."""
    q, k, v = _probe_qkv(rng, 40)
    q = (q.float() * 30).to(torch.bfloat16)
    out = ap.single_pass(q, k, v, tq)
    ref = ap.single_pass_plain(q, k, v)
    torch.cuda.synchronize()
    _within_of_max(out, ref)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_probe_wrappers_reject_what_the_kernels_do_not_take(rng, cuda):
    q = _bf16(rng, (2, 256, 40))
    calls = (lambda t: ap.flash_variant(t, t, t, 192, 128, "full"),
             lambda t: ap.fast_flash(t, t, t, 192, 128, 2),
             lambda t: ap.single_pass(t, t, t, 192))
    n0 = (ap.flash_variant.launches, ap.fast_flash_acc.launches, ap.single_pass.launches)
    for call in calls:
        with pytest.raises(ValueError, match="take D in"):
            call(_bf16(rng, (2, 256, 80)))
        with pytest.raises(ValueError, match="N % 128"):
            call(q[:, :200].contiguous())
        with pytest.raises(ValueError, match="must be torch.bfloat16"):
            call(q.float())
        with pytest.raises(ValueError, match="contiguous"):
            call(_bf16(rng, (2, 40, 256)).transpose(1, 2))
    for call in (lambda: ap.flash_variant(q, q, q, 64, 64, "full"), lambda: ap.flash_variant(q, q, q, 128, 128, "noexp"),
                 lambda: ap.single_pass(q, q, q, 64), lambda: ap.fast_flash_acc(q, q, q, 64, 64, 2),
                 lambda: ap.fast_flash_acc(q, q, q, 128, 128, 3)):
        with pytest.raises(ValueError, match="no kernel is instantiated"):
            call()
    with pytest.raises(ValueError, match="v must have shape"):  # the kernel alone takes fast_v's v only
        ap.fast_flash_kernel(q, q, q, 192, 128, 2, True)
    with pytest.raises(ValueError, match="is on cpu"):
        ap.single_pass(q, q.cpu(), q, 192)
    assert (ap.flash_variant.launches, ap.fast_flash_acc.launches, ap.single_pass.launches) == n0


def test_probe_graph_capture_counts_no_launch(rng, cuda):
    """A call recorded into a CUDA graph launches nothing and is not counted;
    the graph's replay runs the kernel and gives the eager call's output."""
    q, k, v = _probe_qkv(rng, 40)
    want = ap.flash_variant(q, k, v, 192, 128, "full")
    torch.cuda.synchronize()
    n0 = ap.flash_variant.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ap.flash_variant(q, k, v, 192, 128, "full")
    assert ap.flash_variant.launches == n0
    graph.replay()
    torch.cuda.synchronize()
    assert ap.flash_variant.launches == n0
    assert torch.equal(out, want)


# ------------------------------------------------------------------ compress side


def test_quantizer_on_the_card_is_integer_exact(rng, cuda):
    """fit_affine's min/max on the card and its host scale, and quantize's
    codes, bit-equal to numpy's IEEE fp32 math (round half to even), ties
    included: a device division that is not IEEE, or a multiply by a
    reciprocal, would flip some."""
    from pathlib import Path

    from clip_codec_tpu_torch.codecs import quantizer as tq

    Z = np.load(Path(__file__).parent / "fixtures" / "clip_embeddings_fp32.npz")["Z"]
    scale, zero = tq.fit_affine(torch.from_numpy(Z).to(cuda))
    rng_ = np.maximum(Z.max(0) - Z.min(0), np.float32(1e-8))
    np.testing.assert_array_equal(scale.view(np.uint32), (rng_ / np.float32(255)).view(np.uint32))
    np.testing.assert_array_equal(zero.view(np.uint32), Z.min(0).view(np.uint32))
    want = np.clip(np.round((Z - zero) / scale), 0, 255).astype(np.uint8)
    got = tq.quantize(torch.from_numpy(Z).to(cuda), scale, zero)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    x = rng.uniform(-0.2, 0.2, (4096, 512)).astype(np.float32)  # many draws, past the fitted range too
    np.testing.assert_array_equal(tq.quantize(torch.from_numpy(x).to(cuda), scale, zero).cpu().numpy(),
                                  np.clip(np.round((x - zero) / scale), 0, 255).astype(np.uint8))
    half = np.full(4, 0.5, np.float32)
    ties = np.arange(-2, 518, dtype=np.float32)[:, None] * 0.25 + np.zeros(4, np.float32)
    np.testing.assert_array_equal(tq.quantize(torch.from_numpy(ties).to(cuda), half, half * 0).cpu().numpy(),
                                  np.clip(np.round(ties / half), 0, 255).astype(np.uint8))


def test_u8_lut_on_the_card_equals_host_normalize(rng, cuda, tmp_path):
    """The device gather from clip_normalize_table gives host preprocess_pil's
    fp32 pixels bit for bit, and a tower in fp32 the same embeddings from
    either input."""
    from PIL import Image

    from clip_codec_tpu_torch.encoders import ClipEncoder
    from clip_codec_tpu_torch.encoders.clip import (CLIPConfig, CLIPModel, clip_normalize_table, init_params,
                                                    normalize_u8, preprocess_pil, preprocess_pil_u8)

    table = torch.from_numpy(clip_normalize_table()).to(cuda)
    every = torch.arange(256, dtype=torch.uint8, device=cuda)[:, None].expand(256, 3).contiguous()
    np.testing.assert_array_equal(normalize_u8(every, table).cpu().numpy(), clip_normalize_table())
    cfg = CLIPConfig(vision_dim=64, vision_depth=2, vision_heads=2, vision_mlp=128, text_dim=64, text_depth=1,
                     text_heads=2, text_mlp=128, vocab_size=1000, embed_dim=32)
    torch.save(init_params(CLIPModel(cfg), torch.Generator().manual_seed(0)).state_dict(), tmp_path / "w.pt")
    enc = ClipEncoder(weights_path=str(tmp_path / "w.pt"), cfg=cfg, dtype=torch.float32, device=cuda)
    imgs = [Image.fromarray(rng.integers(0, 256, (230 + i, 300 - i, 3), dtype=np.uint8)) for i in range(6)]
    u8 = np.stack([preprocess_pil_u8(im) for im in imgs])
    host = np.stack([preprocess_pil(im) for im in imgs])
    np.testing.assert_array_equal(normalize_u8(torch.from_numpy(u8).to(cuda), table).cpu().numpy(), host)
    np.testing.assert_array_equal(enc.encode_image_array(u8), enc.encode_image_array(host))


def test_inversion_gradient_kernel_path_matches_plain(cuda):
    """One guided step's latent gradient through a bf16 VAE at SD-1.5's
    mid-block width (512, one head) over 32x32 latents, so the decode runs
    flash attention forward and backward at (1, 1024, 512): the kernel path
    vs the plain versions, ||delta|| / ||plain|| < 2e-2, one launch of each."""
    from clip_codec_tpu_torch.models.sd import AutoencoderKL, SDClipAdapter, SDUNet, SDUNetConfig, VAEConfig
    from clip_codec_tpu_torch.models.sd.decoder import StableDiffusionDecoder

    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.device(cuda):
        unet = SDUNet(SDUNetConfig(block_out=(8, 16), layers_per_block=1, cross_dim=32, heads=2, freq_dim=8))
        vae = init_params(AutoencoderKL(VAEConfig(block_out=(128, 512), layers_per_block=1),
                                        dtype=torch.bfloat16), gen)
        dec = StableDiffusionDecoder(unet, vae, SDClipAdapter(32, 32, 64, 8))
    lat, eps = (torch.randn((1, 32, 32, 4), generator=gen, device=cuda) for _ in range(2))
    z = torch.nn.functional.normalize(torch.randn((1, 32), generator=gen, device=cuda), dim=-1)
    embed = lambda x: x.mean(dim=(1, 2)).tile(1, 11)[:, :32] + x[:, ::4, ::4].reshape(1, -1)[:, :32]
    n0 = (attn.flash_attention_fwd.launches, attn.flash_attention_bwd_dq.launches,
          attn.flash_attention_bwd_dkv.launches)
    gk = dec.inversion_grad(lat, eps, 0.8, 0.6, embed, z)
    n = (attn.flash_attention_fwd.launches - n0[0], attn.flash_attention_bwd_dq.launches - n0[1],
         attn.flash_attention_bwd_dkv.launches - n0[2])
    saved = attn.flash_attention_fwd, attn.flash_attention_bwd
    attn.flash_attention_fwd, attn.flash_attention_bwd = attn.flash_attention_plain, attn.flash_attention_bwd_plain
    try:
        gp = dec.inversion_grad(lat, eps, 0.8, 0.6, embed, z)
    finally:
        attn.flash_attention_fwd, attn.flash_attention_bwd = saved
    assert n == (1, 1, 1)
    assert torch.isfinite(gk).all() and gk.norm() > 0
    assert ((gk - gp).norm() / gp.norm()).item() < 2e-2


def test_metrics_on_the_card_equal_the_cpu(rng, cuda, tmp_path):
    """PSNR and SSIM of the same [-1, 1] images on the card and on the CPU
    (uint8 quantization bit-equal, metrics within 1e-5), and LPIPS-VGG16 at
    full widths in fp32 within 1e-4 relative (cuDNN's convs with TF32 off)."""
    from clip_codec_tpu_torch.eval import lpips as lp
    from clip_codec_tpu_torch.eval import metrics as tm

    a = rng.uniform(-1.05, 1.05, (4, 64, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1.1, 1.1).astype(np.float32)
    ac, bc = torch.from_numpy(a), torch.from_numpy(b)
    ag, bg = ac.to(cuda), bc.to(cuda)
    assert torch.equal(tm._u8_float(ag).cpu(), tm._u8_float(ac))
    assert (tm.psnr_batch(ag, bg).cpu() - tm.psnr_batch(ac, bc)).abs().max().item() <= 1e-5
    assert (tm.ssim_batch(ag, bg).cpu() - tm.ssim_batch(ac, bc)).abs().max().item() <= 1e-5
    torch.save(lp.init_params(lp.LPIPS(), torch.Generator().manual_seed(1)).state_dict(), tmp_path / "lpips.pt")
    torch.backends.cudnn.allow_tf32 = True  # the scorer turns TF32 off itself
    try:
        got = tm.lpips_batch(a, b, lpips_model=lp.LPIPSModel.from_checkpoint(tmp_path / "lpips.pt", device=cuda))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = tm.lpips_batch(a, b, lpips_model=lp.LPIPSModel.from_checkpoint(tmp_path / "lpips.pt", device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


# ------------------------------------------------------- retrieval (u8 scan)


def _u8_inputs(rng, n, d, nq, dev):
    from clip_codec_tpu_torch.ops import u8_scan

    codes = torch.from_numpy(rng.integers(0, 256, (n, d), dtype=np.uint8)).to(dev)
    scale = torch.from_numpy((0.5 + rng.random(d)).astype(np.float32) / 255).to(dev)
    zero = torch.from_numpy(-0.5 * np.ones(d, np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(dev)
    q = q / q.norm(dim=1, keepdim=True)
    qs, qz = u8_scan.fold_query(q, scale, zero)
    inv = torch.from_numpy(rng.random(n).astype(np.float32) + 0.5).to(dev)
    return codes, qs, qz, inv


@pytest.mark.parametrize("n,d,nq", [(1000, 16, 1), (3000, 100, 3), (5000, 512, 64), (777, 512, 9), (300, 768, 2)])
def test_u8_ip_scores_matches_plain(rng, cuda, n, d, nq):
    """Product widths 16 and 64, any D, ragged last tiles: within 1e-5 of
    the plain version (exact products, fp32 sums in another order)."""
    from clip_codec_tpu_torch.ops import u8_scan

    args = _u8_inputs(rng, n, d, nq, cuda)
    n0 = u8_scan.u8_ip_scores.launches
    got = u8_scan.u8_ip_scores(*args)
    want = u8_scan.u8_ip_scores_plain(*args)
    torch.cuda.synchronize()
    assert u8_scan.u8_ip_scores.launches == n0 + 1 and got.shape == (nq, n)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("d", [16, 100, 512])
def test_u8_ip_probe_matches_plain_and_scores(rng, cuda, d):
    """The probe kernel against its plain version within 1e-5, and
    bit-equal to u8_ip_scores over the same rows (one summation order)."""
    from clip_codec_tpu_torch.ops import u8_scan

    lists, qs, qz, inv = _u8_inputs(rng, 13 * 300, d, 5, cuda)
    lists, inv = lists.view(13, 300, d), inv.view(13, 300)
    probe = torch.from_numpy(rng.integers(0, 13, (5, 4)).astype(np.int32)).to(cuda)
    n0 = u8_scan.u8_ip_probe.launches
    got = u8_scan.u8_ip_probe(lists, inv, probe, qs, qz)
    want = u8_scan.u8_ip_probe_plain(lists, inv, probe, qs, qz)
    torch.cuda.synchronize()
    assert u8_scan.u8_ip_probe.launches == n0 + 1 and got.shape == (5, 4, 300)
    assert (got - want).abs().max().item() <= 1e-5
    for q in range(5):
        sel = probe[q].long()
        flat = u8_scan.u8_ip_scores(lists[sel].reshape(-1, d).contiguous(), qs[q:q + 1].contiguous(),
                                    qz[q:q + 1].contiguous(), inv[sel].reshape(-1).contiguous())
        assert torch.equal(got[q].reshape(1, -1), flat)


def test_u8_duplicated_rows_score_bit_identically(rng, cuda):
    """A block of 64 copies of one row spread over the matrix (different
    tiles, slabs and lanes) scores bit-identically in both kernel forms, and
    the exact u8 index returns the ten lowest of their ids, in order."""
    from clip_codec_tpu_torch.index import build_index_u8
    from clip_codec_tpu_torch.ops import u8_scan

    codes, qs, qz, inv = _u8_inputs(rng, 20000, 512, 64, cuda)
    rows = torch.from_numpy(np.sort(rng.choice(20000, 64, replace=False))).to(cuda)
    codes[rows] = codes[7].clone()
    inv[rows] = inv[7].clone()
    for nq in (1, 64):
        s = u8_scan.u8_ip_scores(codes, qs[:nq].contiguous(), qz[:nq].contiguous(), inv)
        dup = s[:, rows]
        assert torch.equal(dup, dup[:, :1].expand_as(dup))
    scale = torch.full((512,), 1 / 255, device=cuda)
    idx = build_index_u8(codes, scale, torch.zeros(512, device=cuda), device=cuda)
    x = codes[7].float() / 255
    _, ids = idx.search(x / x.norm(), 10)
    assert ids[0].tolist() == sorted(set([7] + rows.tolist()))[:10]


U8_QS = (1, 7, 8, 63, 64, 65, 200)  # widths 8 and 64 (16, 32 in the probes' groups), > 64, 128- to 512-row tiles
U8_DS = (16, 50, 100, 512, 768, 2048)  # TMA, or not (50 and 100; 50 bytewise); past 1792


@pytest.mark.parametrize("d", U8_DS)
@pytest.mark.parametrize("nq", U8_QS)
def test_u8_ip_scores_matches_plain_at_every_width(rng, cuda, nq, d):
    """Every product width and query grouping, D with and without TMA, a
    ragged last 512-row tile: within 1e-5 of the plain version."""
    from clip_codec_tpu_torch.ops import u8_scan

    args = _u8_inputs(rng, 1037, d, nq, cuda)
    got = u8_scan.u8_ip_scores(*args)
    want = u8_scan.u8_ip_scores_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (nq, 1037)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("d", [512, 2048])
def test_u8_scores_err_against_float64_no_more_than_plain(rng, cuda, d):
    """The products are exact and each 64-byte chunk's sum starts from zero
    before the chunks are added in fp32 rounded to nearest: against a
    float64 reference the kernel errs no more than the plain version's
    cuBLAS fp32 product."""
    from clip_codec_tpu_torch.ops import u8_scan

    codes, qs, qz, inv = _u8_inputs(rng, 4096, d, 64, cuda)
    got = u8_scan.u8_ip_scores(codes, qs, qz, inv)
    plain = u8_scan.u8_ip_scores_plain(codes, qs, qz, inv)
    ref = (qs.double() @ codes.double().T + qz.double()[:, None]) * inv.double()[None, :]
    assert (got.double() - ref).abs().max().item() <= (plain.double() - ref).abs().max().item()


def _probe_case(rng, nq, d, nlist, cap, nprobe, dev):
    """Lists, their inverse norms and a probe in which every query probes list
    0, lists nlist - 2 and nlist - 1 are probed by none, and query 0's row
    names one list twice."""
    lists, qs, qz, inv = _u8_inputs(rng, nlist * cap, d, nq, dev)
    probe = rng.integers(1, nlist - 2, (nq, nprobe)).astype(np.int32)
    probe[:, 0] = 0
    probe[0, nprobe - 1] = probe[0, 1]
    return lists.view(nlist, cap, d), inv.view(nlist, cap), torch.from_numpy(probe).to(dev), qs, qz


@pytest.mark.parametrize("d", U8_DS)
@pytest.mark.parametrize("nq", U8_QS)
def test_u8_ip_probe_matches_plain_at_every_width(rng, cuda, nq, d):
    """The probe against its plain version within 1e-5 (a list every query
    probes, lists none probes, a list named twice in one row, a cap of two
    512-row tiles at D = 512), and each query's scores bit-equal to
    u8_ip_scores over the same rows."""
    from clip_codec_tpu_torch.ops import u8_scan

    cap = 700 if d == 512 else 300
    lists, inv, probe, qs, qz = _probe_case(rng, nq, d, 9, cap, 3, cuda)
    got = u8_scan.u8_ip_probe(lists, inv, probe, qs, qz)
    want = u8_scan.u8_ip_probe_plain(lists, inv, probe, qs, qz)
    torch.cuda.synchronize()
    assert got.shape == (nq, 3, cap)
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got[0, 1], got[0, 2])
    for q in (0, nq - 1):
        sel = probe[q].long()
        flat = u8_scan.u8_ip_scores(lists[sel].reshape(-1, d).contiguous(), qs[q:q + 1].contiguous(),
                                    qz[q:q + 1].contiguous(), inv[sel].reshape(-1).contiguous())
        assert torch.equal(got[q].reshape(1, -1), flat)


@pytest.mark.parametrize("nq,nprobe", [(101, 400), (4, 8)])
def test_u8_ip_probe_over_many_lists(rng, cuda, nq, nprobe):
    """40,000 lists of 16 rows. Probed 40,400 times, the items are the lists'
    tiles: each block owns about 300, past the 256 it buckets at a time (a
    second window, counted again) and past the 4096 lists whose bucket a
    shared-memory table holds. Probed 32 times (at most 128), the items are
    the probed pairs' tiles. Against plain within 1e-5."""
    from clip_codec_tpu_torch.ops import u8_scan

    lists, inv, probe, qs, qz = _probe_case(rng, nq, 16, 40_000, 16, nprobe, cuda)
    probe.copy_(torch.from_numpy(rng.integers(0, 40_000, (nq, nprobe)).astype(np.int32)))
    got = u8_scan.u8_ip_probe(lists, inv, probe, qs, qz)
    want = u8_scan.u8_ip_probe_plain(lists, inv, probe, qs, qz)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


def test_u8_ip_probe_one_query_naming_a_list_many_times(rng, cuda):
    """Q = 2 (256-row tiles) with every one of 80 slots naming list 3: groups
    of 64 and 32 columns (and 16 for the other query's lists) over a cap of
    700 rows, against plain within 1e-5, every slot's scores equal."""
    from clip_codec_tpu_torch.ops import u8_scan

    lists, inv, probe, qs, qz = _probe_case(rng, 2, 512, 9, 700, 80, cuda)
    probe[0] = 3
    got = u8_scan.u8_ip_probe(lists, inv, probe, qs, qz)
    want = u8_scan.u8_ip_probe_plain(lists, inv, probe, qs, qz)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got[0], got[0, :1].expand_as(got[0]))


@pytest.mark.parametrize("nlist,lists", [(5, (0, 0)), (200, (0, 132))])
def test_u8_ip_probe_lists_with_more_pairs_than_the_buckets_hold(rng, cuda, nlist, lists):
    """Every slot of 1700 queries names list 0 (3400 pairs, past the 2048 a
    block buckets at once: ordered passes of 256 pairs), or one slot names
    list 0 and the other list 132 (on a 132-SM card one block holds both:
    two batches of buckets): against plain within 1e-5."""
    from clip_codec_tpu_torch.ops import u8_scan

    lists_, inv, probe, qs, qz = _probe_case(rng, 1700, 64, nlist, 64, 2, cuda)
    probe[:, 0], probe[:, 1] = lists
    got = u8_scan.u8_ip_probe(lists_, inv, probe, qs, qz)
    want = u8_scan.u8_ip_probe_plain(lists_, inv, probe, qs, qz)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5


def test_u8_query_scores_do_not_depend_on_the_batch(rng, cuda):
    """A query's scores are bit-equal alone (product width 16), in a batch of
    20 (32) and of 200 (64, four groups): one arithmetic at every Q."""
    from clip_codec_tpu_torch.ops import u8_scan

    codes, qs, qz, inv = _u8_inputs(rng, 3000, 512, 200, cuda)
    every = u8_scan.u8_ip_scores(codes, qs, qz, inv)
    some = u8_scan.u8_ip_scores(codes, qs[:20].contiguous(), qz[:20].contiguous(), inv)
    assert torch.equal(some, every[:20])
    for q in (0, 19, 130, 199):
        alone = u8_scan.u8_ip_scores(codes, qs[q:q + 1].contiguous(), qz[q:q + 1].contiguous(), inv)
        assert torch.equal(alone, every[q:q + 1])


def test_u8_graph_replays_are_bit_equal(rng, cuda):
    """Both entry points captured in one CUDA graph: two replays bit-equal to
    each other and to eager calls (the probe's grouping needs no host sync)."""
    from clip_codec_tpu_torch.ops import u8_scan

    codes, qs, qz, inv = _u8_inputs(rng, 5000, 512, 64, cuda)
    lists, linv, probe, pqs, pqz = _probe_case(rng, 64, 512, 12, 370, 8, cuda)
    calls = (lambda: u8_scan.u8_ip_scores(codes, qs, qz, inv),
             lambda: u8_scan.u8_ip_probe(lists, linv, probe, pqs, pqz))
    eager = [f() for f in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    graph.replay()
    first = [o.clone() for o in outs]
    graph.replay()
    torch.cuda.synchronize()
    for a, b, e in zip(first, outs, eager):
        assert torch.equal(a, b) and torch.equal(a, e)


def test_ivf_builds_are_bit_equal_on_the_card(rng, cuda):
    """Two builds of one store (both u8 train paths and fp32) give bit-equal
    centroids, lists, ids and list_inv: the k-means update has no atomics."""
    from clip_codec_tpu_torch.codecs import quantizer as tq
    from clip_codec_tpu_torch.index import build_ivf_index, build_ivf_index_u8

    x = torch.from_numpy(rng.standard_normal((6000, 64)).astype(np.float32)).to(cuda)
    x = x / x.norm(dim=1, keepdim=True)
    scale, zero = tq.fit_affine(x)
    codes = tq.quantize(x, scale, zero)
    for build in (lambda: build_ivf_index_u8(codes, scale, zero, nlist=16, device=cuda),   # subsample path
                  lambda: build_ivf_index_u8(codes, scale, zero, nlist=40, device=cuda),   # small store
                  lambda: build_ivf_index(x, nlist=40, device=cuda)):
        a, b = build(), build()
        for name in ("centroids", "lists", "list_ids", "list_inv"):
            ta, tb = getattr(a, name), getattr(b, name)
            assert (ta is None and tb is None) or torch.equal(ta, tb), name


def _px_artifact(tmp_path, **kw):
    """A base-32 U-Net (the conv kernels take Cin % 32 == 0) and a 32px
    artifact of it at batch 2, bf16, for the card."""
    from clip_codec_tpu_torch import deploy
    from clip_codec_tpu_torch.utils.config import ModelConfig

    net = init_params(CLIPCondUNet(z_dim=16, base=32, ch_mult=(1, 2)), torch.Generator().manual_seed(0))
    sd = {k: v.cuda() for k, v in net.state_dict().items()}
    path = deploy.export_decompressor(sd, ModelConfig(z_dim=16, base=32, ch_mult=(1, 2), timesteps=100), tmp_path / "a",
                                      **{"size": 32, "steps": 4, "batch_size": 2, "platforms": ["cuda"], **kw})
    return deploy.load_decompressor(path), sd


@pytest.mark.parametrize("output", ["float32", "uint8"])
def test_pixel_artifact_replay_matches_the_eager_sampler(rng, cuda, tmp_path, output):
    """The whole sampler captured in one CUDA graph: two replays of a seed
    bit-equal, another seed differs, the eager sampler from the same x_T
    within 1e-3 (uint8: one level), the launches a replay's kernel calls."""
    call, sd = _px_artifact(tmp_path, output=output)
    z = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    a = call(sd, z, seed=3)
    assert call.graph is not None and a.shape == (2, 32, 32, 3)
    n0 = rc.affine_silu_conv3x3.launches, rc.affine_conv3x3.launches
    b = call(sd, z, seed=3)
    assert (rc.affine_silu_conv3x3.launches - n0[0], rc.affine_conv3x3.launches - n0[1]) == (4 * 20, 4)
    assert call.graph.launches == {rc.affine_silu_conv3x3: 4 * 20, rc.affine_conv3x3: 4}
    assert torch.equal(a, b) and not torch.equal(a, call(sd, z, seed=4))
    x_T = torch.randn((2, 32, 32, 3), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    e = call.sample(call.net, z.to(cuda), x_T)
    if output == "uint8":
        assert (a.int() - e.int()).abs().max().item() <= 1
    else:
        assert (a - e).abs().max().item() < 1e-3


def test_artifact_replays_repeat_their_per_step_draws(rng, cuda, tmp_path):
    """At eta > 0 the per-step noise is drawn inside the graph from the
    program's generator, registered with it: a replay with seed s repeats
    its draws, and continues where the eager sampler from the same seed
    does (x_T, then each step's noise)."""
    call, sd = _px_artifact(tmp_path, sampler="ddim_std", eta=0.5)
    z = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    a = call(sd, z, seed=5)
    assert torch.equal(a, call(sd, z, seed=5)) and not torch.equal(a, call(sd, z, seed=6))
    gen = torch.Generator(device=cuda).manual_seed(5)
    x_T = torch.randn((2, 32, 32, 3), generator=gen, device=cuda)
    e = call.sample(call.net, z.to(cuda), x_T, gen)
    assert torch.isfinite(a).all() and (a - e).abs().max().item() < 1e-3


def test_sd_artifact_replay_serves_every_guidance(rng, cuda, tmp_path):
    """SD at the MLP kernel's width (320, 640) over 16x16 latents: one
    capture, guidance written before each replay; each replay within 2e-2
    (||delta|| / ||eager||) of the eager sampler at its guidance."""
    from clip_codec_tpu_torch import deploy
    from clip_codec_tpu_torch.models.sd import AutoencoderKL, SDClipAdapter, SDUNet, SDUNetConfig, VAEConfig

    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.device(cuda):
        mods = [init_params(m, gen) for m in (
            SDUNet(SDUNetConfig(block_out=(320, 640), layers_per_block=1, cross_dim=64, heads=8, freq_dim=32)),
            AutoencoderKL(VAEConfig(block_out=(32, 64), layers_per_block=1)), SDClipAdapter(16, 64, 64, 2))]
    sds = [m.state_dict() for m in mods]
    path = deploy.export_sd_decompressor(*sds, tmp_path / "sd", unet_cfg=mods[0].cfg, vae_cfg=mods[1].cfg,
                                         size=32, steps=3, platforms=["cuda"])
    call = deploy.load_sd_decompressor(path)
    z = torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32))
    outs = {g: call(*sds, z, seed=2, guidance_scale=g) for g in (5.0, 1.5)}
    graph = call.graph
    assert call(*sds, z, seed=2, guidance_scale=5.0).equal(outs[5.0]) and call.graph is graph
    n0 = mlp.mlp_up.launches
    with torch.no_grad():  # the artifact's own bf16 UNet, eager, at the CFG pair's batch
        call.decoder.unet(torch.zeros((2, 16, 16, 4), device=cuda), torch.zeros((2,), dtype=torch.int32, device=cuda),
                          torch.zeros((2, 2, 64), device=cuda))
    per_forward = mlp.mlp_up.launches - n0
    assert per_forward > 0 and graph.launches[mlp.mlp_up] == 3 * per_forward
    assert not outs[5.0].equal(outs[1.5])
    x_T = torch.randn(call.latent_shape(), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    for g, out in outs.items():
        e = call.sample(call.decoder, z.to(cuda), x_T, g)
        assert ((out - e).norm() / e.norm()).item() < 2e-2, g


# ------------------------------------------------------------ int8 (ops/int8.py)

INT8_CASES = {  # (xq shape, wq shape, stride, padding): the plan's forms on a 132-SM card
    "sd 8^2 split": ((2, 8, 8, 1280), (1280, 3, 3, 1280), 1, 1),
    "sd 16^2 split": ((2, 16, 16, 1280), (1280, 3, 3, 1280), 1, 1),
    "split 3x3 small": ((2, 8, 8, 256), (128, 3, 3, 256), 1, 1),
    "stride 2": ((2, 32, 32, 128), (256, 3, 3, 128), 2, 1),
    "stride 2 odd": ((1, 15, 15, 64), (64, 3, 3, 64), 2, 1),
    "swap M=16 linear": ((16, 1, 1, 768), (320, 1, 1, 768), 1, 0),
    "swap split": ((16, 1, 1, 4096), (320, 1, 1, 4096), 1, 0),
    "swap M=64 conv": ((1, 8, 8, 256), (256, 3, 3, 256), 1, 1),
    "swap M=27 conv": ((3, 3, 3, 96), (40, 3, 3, 96), 1, 1),
    "ragged M=154 gemm": ((154, 1, 1, 768), (320, 1, 1, 768), 1, 0),
    "cin 320": ((2, 16, 16, 320), (320, 3, 3, 320), 1, 1),
    "ragged image": ((3, 20, 12, 96), (40, 3, 3, 96), 1, 1),
    "1x1 stride 2": ((2, 16, 16, 64), (128, 1, 1, 64), 2, 0),
    "mw2 gemm": ((8192, 1, 1, 320), (2560, 1, 1, 320), 1, 0),
    "pixel 32^2": ((4, 32, 32, 512), (512, 3, 3, 512), 1, 1),
}


def _int8_args(rng, xs, ws, dev):
    xq = torch.from_numpy(rng.integers(-127, 128, xs, dtype=np.int8)).to(dev)
    wq = torch.from_numpy(rng.integers(-127, 128, ws, dtype=np.int8)).to(dev)
    wsc = torch.from_numpy((rng.random(ws[0]) * 1e-3 + 1e-4).astype(np.float32)).to(dev)
    s = torch.tensor(0.02, device=dev)
    bias = torch.from_numpy(rng.standard_normal(ws[0]).astype(np.float32)).to(dev)
    return xq, wq, wsc, s, bias


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_conv_bit_equal_to_plain(rng, cuda, case):
    """Split-K, swapped, stride-2, ragged and Cin = 320 plans: the int32
    accumulator, fp32 and bf16 outputs bit for bit (integer sums are exact)."""
    xs, ws, stride, pad = INT8_CASES[case]
    xq, wq, wsc, s, bias = _int8_args(rng, xs, ws, cuda)
    acc = q8.int8_conv2d_plain(xq, wq, wsc, s, bias, stride, pad, torch.int32)
    n0 = q8.int8_conv2d.launches
    for dt in (torch.int32, torch.float32, torch.bfloat16):
        got = q8.int8_conv2d(xq, wq, wsc, s, bias, stride, pad, dt)
        want = q8._epilogue(acc, wsc, s, bias, dt).contiguous()
        torch.cuda.synchronize()
        assert got.dtype == dt and torch.equal(got, want), (case, dt)
    assert torch.equal(q8.int8_conv2d(xq, wq, wsc, s, None, stride, pad, torch.float32),
                       q8._epilogue(acc, wsc, s, None, torch.float32).contiguous())
    assert q8.int8_conv2d.launches == n0 + 4


def test_int8_conv_split_graph_replays_are_bit_equal(rng, cuda):
    """SD's 8^2 conv splits K over several blocks a tile: the arrival
    counters reset themselves and the partials are overwritten, so two
    replays agree with each other and with the plain version."""
    xs, ws, stride, pad = INT8_CASES["sd 8^2 split"]
    xq, wq, wsc, s, bias = _int8_args(rng, xs, ws, cuda)
    plan = q8.int8_conv_plan(*xs, ws[0], ws[1], stride, pad, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.splits > 1
    run = lambda: q8.int8_conv2d(xq, wq, wsc, s, bias, stride, pad, torch.bfloat16)
    run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    want = q8.int8_conv2d_plain(xq, wq, wsc, s, bias, stride, pad, torch.bfloat16)
    assert torch.equal(first, out) and torch.equal(out, want)


@pytest.mark.parametrize("n", [8, 4096 * 256, 65536 * 128 + 8, 1000 * 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_absmax_one_launch_bit_equal_and_replayable(rng, cuda, n, dtype):
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda, dtype)
    x[n // 3] = -7.5  # the max is a negative value's magnitude
    want = q8.absmax_plain(x)
    n0 = q8.absmax.launches
    assert torch.equal(q8.absmax(x), want) and q8.absmax.launches == n0 + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = q8.absmax(x)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(out, want)


def test_int8_split_conv_on_two_streams_keeps_its_own_scratch(rng, cuda):
    """Split-K launches on two streams overlap: each stream has its own
    scratch, so neither stream's arrival counters see the other's slices."""
    xs, ws, stride, pad = INT8_CASES["sd 8^2 split"]
    args = [_int8_args(rng, xs, ws, cuda) for _ in range(2)]
    want = [q8.int8_conv2d_plain(*a, stride, pad, torch.int32) for a in args]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(q8.int8_conv2d(*args[i], stride, pad, torch.int32))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i]), i


def test_int8_kernels_refuse_a_scratch_too_small(rng, cuda):
    """The C entry points check the scratch they are handed against the
    launch: a split conv or an absmax it could not hold returns an error."""
    xs, ws, stride, pad = INT8_CASES["sd 8^2 split"]
    xq, wq, wsc, s, bias = _int8_args(rng, xs, ws, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pl = q8.int8_conv_plan(*xs, ws[0], ws[1], stride, pad, sms)
    lib = q8._kernel_lib()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    small = torch.zeros(1024, dtype=torch.int32, device=cuda)
    y = torch.empty((xs[0], xs[1], xs[2], ws[0]), dtype=torch.int32, device=cuda)
    rc = lib.int8_conv_nhwc(xq.data_ptr(), wq.data_ptr(), wsc.data_ptr(), s.data_ptr(), None, y.data_ptr(),
                            small.data_ptr(), 4 * small.numel(), *xs, ws[0], ws[1], ws[2], stride, pad, 2, pl.mw,
                            pl.bn, pl.splits, int(pl.swap), int(pl.gemm), *pl.tile, pl.blocks, pl.stages, sms, stream)
    assert pl.splits > 1 and rc != 0
    x = torch.ones(1 << 20, dtype=torch.bfloat16, device=cuda)
    out = torch.empty((), dtype=torch.float32, device=cuda)
    rc = lib.absmax(x.data_ptr(), 1, x.numel(), out.data_ptr(), small.data_ptr(), 32, sms, stream)
    assert rc != 0
    torch.cuda.synchronize()


def _act_input(rng, xs, dtype, dev):
    """Activations whose absmax is 127/64 (s = 1/64 exactly) and a quarter
    of whose values are exact halves (k + 1/2) / 64: ties, which go to the
    even code, where x * (1 / s) lands exactly on the half."""
    x = np.clip(rng.standard_normal(xs) * 0.5, -1.9, 1.9).astype(np.float32)
    ties = (rng.integers(-127, 127, xs) + 0.5) / 64
    x = np.where(rng.random(xs) < 0.25, ties, x).astype(np.float32)
    x.reshape(-1)[7] = 127 / 64
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_int8_quantize_bit_equal_to_plain(rng, cuda, act):
    """``int8_quantize``'s codes and scale bit for bit ``quantize_plain``'s:
    at the absmax (s = 1/64, a quarter of the values exact ties, which go to
    the even code), at half of it (codes saturate), at a power-of-two s from
    the absmax of other data, at a zero absmax (the 1e-12 floor), and at
    absmax where the fma form does not hold (inf, FLT_MAX: every value
    through the IEEE divide)."""
    x = _act_input(rng, (4, 33, 17, 96), act, cuda)
    y = torch.from_numpy(rng.standard_normal((4, 33, 17, 96)).astype(np.float32)).to(cuda, act)
    am = q8.absmax(x)
    pow2 = 127.0 * torch.exp2(torch.floor(torch.log2(y.float().abs().amax() / 127.0)))
    n0 = q8.quantize.launches
    for what, v, a in (("ties", x, am), ("half", x, am * 0.5), ("pow2", y, pow2), ("zero", x, am * 0.0),
                       ("inf", x, am * float("inf")), ("max", x, torch.tensor(torch.finfo(torch.float32).max,
                                                                                device=cuda))):
        got, want = q8.quantize(v, a), q8.quantize_plain(v, a)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), what
    assert q8.quantize.launches == n0 + 6


@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_conv_act_bit_equal_to_plain(rng, cuda, case, act):
    """The act form (codes made in shared memory) at every plan form, bf16
    and fp32 activations: dynamic (ties included), and static at half the
    absmax (codes saturate), bit for bit ``quantize_plain`` then
    ``int8_conv2d_plain``: the int32 accumulator, fp32 and bf16 outputs."""
    xs, ws, stride, pad = INT8_CASES[case]
    x = _act_input(rng, xs, act, cuda)
    _, wq, wsc, _, bias = _int8_args(rng, xs, ws, cuda)
    n0 = q8.int8_conv2d_act.launches
    am = q8.absmax(x)
    assert am.item() == 127 / 64
    for mode, a in (("dynamic", am), ("static half", am * 0.5)):
        acc = q8.int8_conv2d_act_plain(x, a, wq, wsc, bias, stride, pad, torch.int32)
        s = q8.act_scale_plain(a)
        for dt in (torch.int32, torch.float32, torch.bfloat16):
            got = q8.int8_conv2d_act(x, a, wq, wsc, bias, stride, pad, dt)
            want = q8._epilogue(acc, wsc, s, bias, dt).contiguous()
            torch.cuda.synchronize()
            assert got.dtype == dt and torch.equal(got, want), (case, mode, dt)
    assert q8.int8_conv2d_act.launches == n0 + 6


def test_int8_conv_act_split_graph_replays_and_linear(rng, cuda):
    """The act form at SD's split 8^2 level: two graph replays bit-equal to
    each other and to the plain version; and the Linear over (2, 77, 768)."""
    xs, ws, stride, pad = INT8_CASES["sd 8^2 split"]
    x = _act_input(rng, xs, torch.bfloat16, cuda)
    _, wq, wsc, _, bias = _int8_args(rng, xs, ws, cuda)
    am = torch.tensor(1.5, device=cuda)
    run = lambda: q8.int8_conv2d_act(x, am, wq, wsc, bias, stride, pad, torch.bfloat16)
    run()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, out) and torch.equal(out, q8.int8_conv2d_act_plain(x, am, wq, wsc, bias, stride, pad))
    xl = _act_input(rng, (2, 77, 768), torch.float32, cuda)
    _, wl, wsl, _, bl = _int8_args(rng, (154, 1, 1, 768), (320, 1, 1, 768), cuda)
    n0 = q8.int8_linear_act.launches
    got = q8.int8_linear_act(xl, am, wl, wsl, bl, torch.float32)
    want = q8.int8_conv2d_act_plain(xl.reshape(154, 1, 1, 768), am, wl, wsl, bl, 1, 0, torch.float32)
    assert got.shape == (2, 77, 320) and torch.equal(got.reshape(want.shape), want)
    assert q8.int8_linear_act.launches == n0 + 1


# ---------------------------------- K1's codes-out form (ops/groupnorm.py group_norm_silu_int8)

GN_INT8_CASES = {  # (B, H, W, C, G), dtype
    "2x32^2x128-bf16": ((2, 32, 32, 128, 8), torch.bfloat16),
    "2x32^2x128-fp32": ((2, 32, 32, 128, 8), torch.float32),
    "3x37x29x64-bf16": ((3, 37, 29, 64, 8), torch.bfloat16),
    "2x16^2x512-fp32": ((2, 16, 16, 512, 8), torch.float32),
    "1x512^2x128-bf16": ((1, 512, 512, 128, 8), torch.bfloat16),  # a sample larger than a round
    # the units that code a chunk: a warp above, all 256 compute threads (C / 8 = 12), three warps (C / 8 = 96)
    "2x9x11x96-bf16": ((2, 9, 11, 96, 8), torch.bfloat16),
    "2x8x8x768-fp32": ((2, 8, 8, 768, 8), torch.float32),
}


def _gn_int8_pair(x, scale, bias, G, am):
    """The two-launch form the codes-out form replaces: K1, then int8_quantize."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    return q8.quantize(gn.group_norm_silu(x, (scale, bias), G), am)


def gn_int8_absmax(y, kind):
    """The absmax a codes-out check runs at: the output's (``calibrated``),
    half of it (``clamped``: codes at +-127), or the largest 127 * 2^k not
    above it (``pow2``: s = 2^k, where many y / s are exact halves, ties that
    the codes must round to even as ``int8_quantize`` does)."""
    am = y.float().abs().amax()
    if kind == "clamped":
        return am * 0.5
    if kind == "pow2":
        return 127.0 * torch.exp2(torch.floor(torch.log2(am / 127.0)))
    return am


@pytest.mark.parametrize("kind", ["calibrated", "clamped", "pow2"])
@pytest.mark.parametrize("case", list(GN_INT8_CASES))
def test_group_norm_silu_int8_equals_k1_then_quantize(rng, cuda, case, kind):
    """One launch, the codes and the scale bit for bit K1's output quantized
    by ``int8_quantize`` (at the output's absmax, at half of it: codes
    clamped, and at a power-of-two scale: exact ties); against the plain
    version (K1's plain version, whose SiLU is exact where the kernel's is
    approximate, then ``quantize_plain``) the scale bit-equal and the codes
    within one."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    (B, H, W, C, G), dtype = GN_INT8_CASES[case]
    x, scale, bias = _gn_args(rng, B, H, W, C, dtype, cuda)
    y = gn.group_norm_silu(x, (scale, bias), G)
    am = gn_int8_absmax(y, kind)
    half = kind == "clamped"
    n0 = (gn.group_norm_silu_int8.launches, gn.group_norm_silu.launches)
    xq, s = gn.group_norm_silu_int8(x, (scale, bias), G, am)
    torch.cuda.synchronize()
    assert (gn.group_norm_silu_int8.launches - n0[0], gn.group_norm_silu.launches - n0[1]) == (1, 0)
    assert xq.dtype == torch.int8 and xq.shape == x.shape and s.shape == ()
    want, want_s = _gn_int8_pair(x, scale, bias, G, am)
    assert torch.equal(s, want_s) and torch.equal(xq, want)
    assert torch.equal(xq, q8.quantize_plain(y, am)[0])
    plain, plain_s = gn.group_norm_silu_int8_plain(x, (scale, bias), G, am)
    assert torch.equal(s, plain_s) and int((xq.int() - plain.int()).abs().max()) <= 1
    assert not half or int((xq.abs() == 127).sum()) > 0


@pytest.mark.parametrize("case", ["2x32^2x128-bf16", "3x37x29x64-bf16", "1x512^2x128-bf16", "2x9x11x96-bf16"])
def test_group_norm_silu_int8_graph_replays_and_sm_counts(rng, cuda, case):
    """Two replays of the captured launch bit-equal to the eager call (the
    grid barrier resets itself; a new absmax copied into the captured one
    rescales the replay), and on 114 or 7 SMs (other rounds; on 7 most slabs
    read from device memory) the codes bit-equal to the whole card's."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    (B, H, W, C, G), dtype = GN_INT8_CASES[case]
    x, scale, bias = _gn_args(rng, B, H, W, C, dtype, cuda)
    am = torch.tensor(3.0, device=cuda)
    want, want_s = gn.group_norm_silu_int8(x, (scale, bias), G, am)
    for sms in (114, 7):
        xq, s = gn._launch_int8(x, scale, bias, G, am, gn.GN_EPS, sms)
        assert torch.equal(xq, want) and torch.equal(s, want_s), sms
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        xq, s = gn.group_norm_silu_int8(x, (scale, bias), G, am)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        xq.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(xq, want) and torch.equal(s, want_s)
    am.fill_(1.5)
    graph.replay()
    torch.cuda.synchronize()
    again, again_s = _gn_int8_pair(x, scale, bias, G, am)
    assert torch.equal(xq, again) and torch.equal(s, again_s) and not torch.equal(xq, want)


def test_group_norm_silu_int8_rejects_what_the_kernel_does_not_take(rng, cuda):
    from clip_codec_tpu_torch.ops import groupnorm as gn

    x, scale, bias = _gn_args(rng, 2, 8, 8, 24, torch.bfloat16, cuda)
    am = torch.tensor(2.0, device=cuda)
    n0 = gn.group_norm_silu_int8.launches
    with pytest.raises(ValueError, match="C % 16 == 0"):
        gn.group_norm_silu_int8(x, (scale, bias), 8, am)
    x, scale, bias = _gn_args(rng, 2, 8, 8, 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="absmax must be one torch.float32 value"):
        gn.group_norm_silu_int8(x, (scale, bias), 8, am.cpu())
    with pytest.raises(ValueError, match="absmax must be one torch.float32 value"):
        gn.group_norm_silu_int8(x, (scale, bias), 8, am.to(torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
        gn.group_norm_silu_int8(x.half(), (scale, bias), 8, am)
    assert gn.group_norm_silu_int8.launches == n0


def test_static_int8_unet_takes_the_codes_out_form(rng, cuda):
    """A narrow pixel U-Net in static int8 on the card: every ResBlock conv's
    codes from ``group_norm_silu_int8`` (no K1, a quantize pass only for the
    stride-2 convs), eps bit-equal to the two-launch form's (K1, then
    ``int8_quantize``); dynamic int8 keeps K1 and a quantize pass a layer."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    net = init_params(CLIPCondUNet(z_dim=8, base=32, ch_mult=(1, 2), time_dim=32, dtype=torch.bfloat16, int8=True),
                      torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).to(cuda)
    t = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    layers = len(q8.int8_layer_names(net))
    with torch.no_grad():
        quant = q8.calibrate_unet(net, size=32, z_dim=8, timesteps=50, batch=2)
        counters = (gn.group_norm_silu_int8, gn.group_norm_silu, q8.quantize, q8.int8_conv2d)
        for q, want in ((quant, (20, 0, layers - 20, layers)), (None, (0, 20, layers, layers))):
            q8.load_quant(net, q)
            n0 = [c.launches for c in counters]
            out = net(x, z, t)
            torch.cuda.synchronize()
            assert tuple(c.launches - n for c, n in zip(counters, n0)) == want
        q8.load_quant(net, quant)
        static = net(x, z, t)
        saved = q8.static_absmax
        q8.static_absmax = lambda layer: None
        try:
            two = net(x, z, t)
        finally:
            q8.static_absmax = saved
    assert bool(torch.isfinite(static.float()).all()) and torch.equal(static, two)


# ---------------------------------------------- the modules with no TPU kernel of their own


def test_native_store_codec_frames_on_the_card_machine(rng, cuda, monkeypatch):
    """The card machine has no zstandard: the native engine frames there."""
    import importlib.util

    from clip_codec_tpu_torch.io import bitstream, native

    assert native.codec() is not None, native.load_error()
    want = ("native", "zstandard") if importlib.util.find_spec("zstandard") else ("native",)
    assert bitstream.zstd_engine() in want
    q = np.clip(np.rint(rng.standard_normal((1000, 512)) * 24 + 128), 0, 255).astype(np.uint8)
    monkeypatch.setattr(bitstream, "_have_zstandard", lambda: False)  # single frames native too
    frames = bitstream.compress_frames(q)
    np.testing.assert_array_equal(bitstream.decompress_frames(frames, 512), q)
    assert [bitstream.compress_frame(r.tobytes()) for r in q[:8]] == frames[:8]
    with pytest.raises(ValueError, match="Bad magic"):
        bitstream.decompress_frames([frames[0], b"XXXX" + frames[1][4:]], 512)


def _narrow_unet(cuda):
    return init_params(CLIPCondUNet(z_dim=8, base=32, ch_mult=(1, 2), time_dim=32, dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0)).to(cuda).eval()


def test_ddpm_kernel_path_matches_plain(rng, cuda):
    """Ancestral DDPM on a 10-step schedule through the narrow U-Net, the
    same injected noise on the kernel and the plain path: within 2e-2."""
    from clip_codec_tpu_torch.diffusion import NoiseSchedule, ddpm_sample

    net = _narrow_unet(cuda)
    shape = (2, 32, 32, 3)
    g = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn((2, 8), generator=g, device=cuda)
    x_T = torch.randn(shape, generator=g, device=cuda)
    noise = [torch.randn(shape, generator=g, device=cuda) for _ in range(9)]
    sched = NoiseSchedule.create(10, device=cuda)
    n0 = rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches
    xk = ddpm_sample(net, sched, z, shape, x_T=x_T, noise=noise)
    assert rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches - n0 == 21 * 10
    saved = rc.affine_silu_conv3x3, rc.affine_conv3x3
    rc.affine_silu_conv3x3 = lambda *a, **k: rc.affine_conv3x3_plain(*a, **k)
    rc.affine_conv3x3 = lambda *a, **k: rc.affine_conv3x3_plain(*a, **k, linear=True)
    try:
        xp = ddpm_sample(net, sched, z, shape, x_T=x_T, noise=noise)
    finally:
        rc.affine_silu_conv3x3, rc.affine_conv3x3 = saved
    assert torch.isfinite(xk).all()
    assert ((xk - xp).norm() / xp.norm()).item() < 2e-2


@pytest.mark.parametrize("name", ["clip_cond", "lite"])
def test_direct_decoders_bf16_near_fp32(cuda, name):
    from clip_codec_tpu_torch.models import CLIPCondDecoder, FeatureToImageDecoderLite

    make = {"clip_cond": lambda dt: CLIPCondDecoder(64, 64, 128, dtype=dt),
            "lite": lambda dt: FeatureToImageDecoderLite(64, 64, 32, dtype=dt)}[name]
    m32 = init_params(make(torch.float32), torch.Generator().manual_seed(0)).to(cuda).eval()
    mbf = make(torch.bfloat16)
    mbf.load_state_dict(m32.state_dict())
    mbf = mbf.to(cuda).eval()
    z = torch.randn((4, 64), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    with torch.no_grad():
        y32, ybf = m32(z), mbf(z).float()
    assert torch.isfinite(ybf).all()
    assert ((ybf - y32).norm() / y32.norm()).item() < 2e-2


def test_trace_names_the_region_and_k2_and_nan_checked_raises(rng, cuda, tmp_path):
    import json

    from clip_codec_tpu_torch.utils.debug import nan_checked
    from clip_codec_tpu_torch.utils.profiling import TRACE_NAME, annotate, trace

    net = _narrow_unet(cuda)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).to(cuda)
    t = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    with torch.no_grad():
        net(x, z, t)
        with trace(tmp_path):
            with annotate("unet_forward"):
                net(x, z, t)
        events = json.loads((tmp_path / TRACE_NAME).read_text())["traceEvents"]
        assert any(e.get("name") == "unet_forward" for e in events)
        # CUPTI may drop a kernel at the profiler's start: K2 is named, up to its 20 launches
        assert 1 <= sum("conv_wgmma_kernel" in e.get("name", "") for e in events if e.get("cat") == "kernel") <= 20
        checked = nan_checked(net)
        checked(x, z, t)
        x[0, 0, 0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match="CLIPCondUNet output"):
            checked(x, z, t)
