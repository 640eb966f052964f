"""The downfirdn2d_x2 kernel of the PyTorch port (K1) and its adjoint (K1-bwd).

On CPU: its plain version against the JAX package's Pallas kernel in
interpret mode (the same shapes as tests/test_pallas_kernels.py plus an
asymmetric filter), and the wrapper's input checks. float32 holds to 1e-5;
bf16 to 1e-2, since both sides round once from a float32 sum.

Tests marked `cuda` need an NVIDIA GPU and nvcc; they skip elsewhere. On
such a machine, which need not have jax:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from stylegan_v_tpu_torch.ops import (downfirdn2d_x2, downfirdn2d_x2_bwd,
                                      downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain,
                                      downsample2d, fir_kernels, setup_filter, upfirdn2d)

SYM = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64
ASYM = (np.arange(16, dtype=np.float32).reshape(4, 4) - 5.0) / 40
TOLS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def assert_close(got: torch.Tensor, want: torch.Tensor, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    tol = TOLS[dtype]
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 32, 64, 16), (3, 8, 8, 4)])
@pytest.mark.parametrize("filt", ["sym", "asym"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_interpret(shape, filt, dtype):
    import jax.numpy as jnp   # here, not at the top: the `cuda` tests run without jax
    from stylegan_v_tpu.ops.pallas_kernels import downfirdn2d_x2 as pallas_downfirdn2d_x2

    f = SYM if filt == "sym" else ASYM
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    want = pallas_downfirdn2d_x2(jx, f, interpret=True)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).to(dtype)
    got = downfirdn2d_x2_plain(x.permute(0, 3, 1, 2).contiguous(), f)
    assert_close(got.permute(0, 2, 3, 1), want, dtype)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    x = torch.randn(2, 3, 8, 6, generator=torch.Generator().manual_seed(1))
    before = downfirdn2d_x2.launches
    got = downfirdn2d_x2(x, SYM)
    assert downfirdn2d_x2.launches == before
    torch.testing.assert_close(got, downfirdn2d_x2_plain(x, SYM), rtol=0, atol=0)
    torch.testing.assert_close(got, downsample2d(x, setup_filter([1, 3, 3, 1])),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,f,match", [
    ((2, 3, 7, 8), SYM, "even"),
    ((2, 3, 8), SYM, "NCHW"),
    ((2, 3, 8, 8), np.ones((3, 3), np.float32), "4x4"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(shape, f, match):
    with pytest.raises(ValueError, match=match):
        downfirdn2d_x2(torch.zeros(shape), f)


def test_bwd_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    dy = torch.randn(2, 3, 4, 3, generator=torch.Generator().manual_seed(2))
    before = downfirdn2d_x2_bwd.launches
    got = downfirdn2d_x2_bwd(dy, ASYM)
    assert downfirdn2d_x2_bwd.launches == before and got.shape == (2, 3, 8, 6)
    torch.testing.assert_close(got, downfirdn2d_x2_bwd_plain(dy, ASYM), rtol=0, atol=0)
    with pytest.raises(ValueError, match="NCHW"):
        downfirdn2d_x2_bwd(torch.zeros(2, 3, 4), ASYM)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("filt", ["sym", "asym"])
def test_kernel_matches_plain_on_card(cuda, dtype, filt):
    f = SYM if filt == "sym" else ASYM
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, 5, 18, 34, generator=g, device=cuda).to(dtype)
    before = downfirdn2d_x2.launches
    got = downfirdn2d_x2(x, f)
    torch.cuda.synchronize()
    assert downfirdn2d_x2.launches == before + 1
    assert_close(got, downfirdn2d_x2_plain(x, f), dtype)


@pytest.mark.cuda
def test_upfirdn2d_sends_only_the_k1_case_to_the_kernel(cuda):
    f = setup_filter([1, 3, 3, 1])
    x = torch.randn(2, 4, 16, 16, device=cuda)
    before = downfirdn2d_x2.launches
    got = upfirdn2d(x, f, down=2, padding=1)
    assert downfirdn2d_x2.launches == before + 1
    torch.testing.assert_close(got, downfirdn2d_x2_plain(x, f), rtol=1e-5, atol=1e-5)
    upfirdn2d(x, f, down=2, padding=2)
    upfirdn2d(x, f, up=2, padding=1)
    upfirdn2d(x[:, :, :15, :15], f, down=2, padding=1)
    assert downfirdn2d_x2.launches == before + 1


@pytest.mark.cuda
def test_kernel_raises_on_cuda_input_it_does_not_take(cuda):
    x = torch.randn(2, 4, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        downfirdn2d_x2(x.transpose(2, 3), SYM)
    with pytest.raises(ValueError, match="bfloat16"):
        downfirdn2d_x2(x.half(), SYM)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("filt", ["sym", "asym"])
def test_bwd_kernel_matches_plain_on_card(cuda, dtype, filt):
    f = SYM if filt == "sym" else ASYM
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(3, 5, 9, 17, generator=g, device=cuda).to(dtype)
    before = downfirdn2d_x2_bwd.launches
    got = downfirdn2d_x2_bwd(dy, f)
    torch.cuda.synchronize()
    assert downfirdn2d_x2_bwd.launches == before + 1
    assert_close(got, downfirdn2d_x2_bwd_plain(dy, f), dtype)


@pytest.mark.cuda
def test_grads_through_k1_launch_k1_bwd_then_k1(cuda):
    """First order launches K1-bwd once; the second order launches K1 again."""
    x = torch.randn(2, 4, 16, 16, device=cuda, requires_grad=True)
    f = setup_filter([1, 3, 3, 1])
    k1, k1b = downfirdn2d_x2.launches, downfirdn2d_x2_bwd.launches
    y = upfirdn2d(x, f, down=2, padding=1)
    dx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert (downfirdn2d_x2.launches - k1, downfirdn2d_x2_bwd.launches - k1b) == (1, 1)
    # d/dx of sum(dx^2) with dx = 2 * K1bwd(K1(x)): K1 and K1-bwd once more each
    gx, = torch.autograd.grad(dx.square().sum(), x)
    torch.cuda.synchronize()
    assert (downfirdn2d_x2.launches - k1, downfirdn2d_x2_bwd.launches - k1b) == (2, 2)
    want = 8 * downfirdn2d_x2_bwd_plain(downfirdn2d_x2_plain(
        downfirdn2d_x2_bwd_plain(downfirdn2d_x2_plain(x.detach(), f), f), f), f)
    torch.testing.assert_close(gx, want, rtol=1e-4, atol=1e-5)
    # a non-contiguous incoming gradient is made contiguous before the launch
    dy = torch.randn(2, 4, 8, 8, device=cuda).transpose(2, 3)
    gx, = torch.autograd.grad(fir_kernels._DownFirX2.apply(x, f), x, dy)
    torch.testing.assert_close(gx, downfirdn2d_x2_bwd_plain(dy.contiguous(), f),
                               rtol=1e-5, atol=1e-5)
