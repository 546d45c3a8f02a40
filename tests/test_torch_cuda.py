"""The port's hand-written CUDA kernel on a card (marker ``cuda``; every test
here skips without one).

The kernel has no CPU mode, so it is held against its plain PyTorch version
on the same card, bf16, within rtol = atol = 2e-2 (the JAX package's bf16
bound for its own kernel, tests/test_pallas_resblock.py), moments within
1e-3 of their largest magnitude. This file imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from clip_codec_tpu_torch.models import CLIPCondUNet, init_params
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
