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
1e-4 in fp32; the attention probes (P1-P3) within 2e-2 of the largest
magnitude, and softmax outputs also within rtol = atol = 2e-2 (at normal
logits their values are ~0.02, so the elementwise atol alone would let a
dropped key tile pass), the P2 row sum within 2e-2 relative. This file imports no
jax, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
from clip_codec_tpu_torch.ops import attention as attn
from clip_codec_tpu_torch.ops import attention_probe as ap
from clip_codec_tpu_torch.ops import mlp
from clip_codec_tpu_torch.ops import resblock_conv as rc

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
FLASH_BWD_CASES = [(32, 4096, 4096, 40), (32, 1024, 1024, 80), (4, 4096, 4096, 512),
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


def test_transformer_mlp_cases_cover_both_epilogues(cuda):
    """The cases above run the kernel with one split (bf16 stored from
    registers) and with several (fp32 partials summed by a second kernel)."""
    splits = {mlp.kernel_splits(R, C, F, cuda) for R, C, F in MLP_CASES}
    assert 1 in splits and max(splits) > 1


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


# (B, H, W, C, G): a ragged last row chunk (37 x 29 pixels), groups of fewer
# than 8 channels (C/G = 4 and 3: one thread's 8-channel vector spans two or
# three groups), one group, and a training shape.
GN_CASES = [(3, 37, 29, 64, 8), (2, 9, 7, 32, 8), (2, 16, 16, 24, 8), (1, 5, 3, 16, 1), (8, 64, 64, 256, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,G", GN_CASES)
def test_group_norm_silu_matches_plain(rng, cuda, B, H, W, C, G, dtype):
    """K1's stats kernel against its plain version within 1e-5 of the
    largest partial, the norm kernel on the same partials and the pair
    against ``group_norm_silu_plain`` within 1e-4 (fp32) or rtol = atol =
    2e-2 (bf16: the plain version rounds the normalised value once more)."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    x = torch.from_numpy((rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)).to(cuda, dtype)
    scale = torch.from_numpy((1 + 0.2 * rng.standard_normal(C)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((0.2 * rng.standard_normal(C)).astype(np.float32)).to(cuda)
    n0 = gn.group_norm_silu_stats.launches, gn.group_norm_silu_norm.launches
    part = gn.group_norm_silu_stats(x)
    part_ref = gn.group_norm_silu_stats_plain(x, part.shape[1])
    y_norm = gn.group_norm_silu_norm(x, part, scale, bias, G)
    y_norm_ref = gn.group_norm_silu_norm_plain(x, part, scale, bias, G)
    y = gn.group_norm_silu(x, (scale, bias), G)
    y_ref = gn.group_norm_silu_plain(x, (scale, bias), G)
    torch.cuda.synchronize()
    assert (gn.group_norm_silu_stats.launches - n0[0], gn.group_norm_silu_norm.launches - n0[1]) == (2, 2)
    assert part.shape == (B, gn.n_chunks(B, H * W), 2, C)
    for k in range(2):
        assert (part[:, :, k] - part_ref[:, :, k]).abs().max() <= 1e-5 * part_ref[:, :, k].abs().max()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y_norm.float(), y_norm_ref.float(), **tol)
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)


def test_group_norm_silu_rejects_what_the_kernel_does_not_take(rng, cuda):
    from clip_codec_tpu_torch.ops import groupnorm as gn

    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 32)).astype(np.float32)).to(cuda)
    sb = (torch.ones(32, device=cuda), torch.zeros(32, device=cuda))
    n0 = gn.group_norm_silu_stats.launches + gn.group_norm_silu_norm.launches
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
    assert gn.group_norm_silu_stats.launches + gn.group_norm_silu_norm.launches == n0


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
    n0 = gn.group_norm_silu_norm.launches
    gn.group_norm_silu(x, (scale, bias), 8).backward(g)
    assert gn.group_norm_silu_norm.launches == n0 + 1
    got = [t.grad.clone() for t in (x, scale, bias)]
    for t in (x, scale, bias):
        t.grad = None
    gn.group_norm_silu_plain(x, (scale, bias), 8).backward(g)
    for a, t in zip(got, (x, scale, bias)):
        assert a.dtype == t.dtype
        assert torch.equal(a, t.grad)


def test_unet_training_form_runs_k1_and_trains(rng, cuda):
    """The direct (training) form of a narrow U-Net on the card, bf16, 32px:
    each forward launches each K1 kernel twice per ResBlock (10 at
    ch_mult=(1, 2)) and no fused conv; every parameter gets a finite
    gradient, and eps agrees with the same network on the plain GroupNorm+SiLU."""
    from clip_codec_tpu_torch.ops import groupnorm as gn

    net = init_params(CLIPCondUNet(z_dim=8, base=32, ch_mult=(1, 2), time_dim=32, dtype=torch.bfloat16,
                                   fused_pallas=False), torch.Generator().manual_seed(0)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32)).to(cuda)
    t = torch.tensor([3, 40], dtype=torch.int32, device=cuda)
    n0 = (gn.group_norm_silu_stats.launches, gn.group_norm_silu_norm.launches,
          rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches)
    ek = net(x, z, t)
    ek.float().square().mean().backward()
    n = (gn.group_norm_silu_stats.launches - n0[0], gn.group_norm_silu_norm.launches - n0[1],
         rc.affine_silu_conv3x3.launches + rc.affine_conv3x3.launches - n0[2])
    assert n == (20, 20, 0)
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


@pytest.mark.parametrize("D", [40, 48])
@pytest.mark.parametrize("deg,mxu_sum,tq,tk", ap.P2_TILES)
def test_probe_fast_matches_plain(rng, cuda, deg, mxu_sum, tq, tk, D):
    """Every instantiated P2 kernel: the raw accumulator's last column (the
    row sum) within 2e-2 relative, the divided output within 2e-2."""
    q, k, v = _probe_qkv(rng, D)
    n0 = ap.fast_flash_acc.launches
    acc = ap.fast_flash_acc(q, k, v, tq, tk, deg, mxu_sum)
    ref = ap.fast_flash_plain(q, k, v, tk, deg, mxu_sum)
    torch.cuda.synchronize()
    assert ap.fast_flash_acc.launches == n0 + 1
    assert acc.dtype == torch.float32 and acc.shape == (2, 512, D + 1)
    assert ((acc[..., D] - ref[..., D]).abs() <= 2e-2 * ref[..., D].abs()).all()
    out, out_ref = ((a[..., :D] / a[..., D:]).to(torch.bfloat16).float() for a in (acc, ref))
    _within_of_max(out, out_ref)
    torch.testing.assert_close(out, out_ref, rtol=2e-2, atol=2e-2)


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


def test_probe_wrappers_reject_what_the_kernels_do_not_take(rng, cuda):
    q = _bf16(rng, (2, 256, 40))
    calls = (lambda t: ap.flash_variant(t, t, t, 64, 64, "full"),
             lambda t: ap.fast_flash(t, t, t, 64, 64, 2),
             lambda t: ap.single_pass(t, t, t, 64))
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
    with pytest.raises(ValueError, match="no kernel is instantiated"):
        ap.flash_variant(q, q, q, 64, 128, "noexp")
    with pytest.raises(ValueError, match="is on cpu"):
        ap.single_pass(q, q.cpu(), q, 64)
    assert (ap.flash_variant.launches, ap.fast_flash_acc.launches, ap.single_pass.launches) == n0


def test_probe_graph_capture_counts_no_launch(rng, cuda):
    """A call recorded into a CUDA graph launches nothing and is not counted;
    the graph's replay runs the kernel and gives the eager call's output."""
    q, k, v = _probe_qkv(rng, 40)
    want = ap.flash_variant(q, k, v, 64, 64, "full")
    torch.cuda.synchronize()
    n0 = ap.flash_variant.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ap.flash_variant(q, k, v, 64, 64, "full")
    assert ap.flash_variant.launches == n0
    graph.replay()
    torch.cuda.synchronize()
    assert ap.flash_variant.launches == n0
    assert torch.equal(out, want)
