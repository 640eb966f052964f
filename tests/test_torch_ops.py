"""Parity of the PyTorch port's ops against the JAX package's, on CPU.

Inputs come from numpy with a seed; the JAX side runs NHWC/HWIO, the port
NCHW/OIHW, and outputs are compared after one transpose. Everything is
float32, so the tolerance is 1e-5 relative to the output scale: the two
frameworks only sum in other orders.
"""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from stylegan_v_tpu.ops import bias_act as jbias_act
from stylegan_v_tpu.ops import conv2d_resample as jconv2d_resample
from stylegan_v_tpu.ops import modulated_conv2d as jmodulated_conv2d
from stylegan_v_tpu_torch.ops import (activation_funcs, bias_act, conv2d_resample,
                                      modulated_conv2d, setup_filter, upfirdn2d)

# the modules, which the packages' re-exported functions of the same name shadow
jup = importlib.import_module("stylegan_v_tpu.ops.upfirdn2d")
tup = importlib.import_module("stylegan_v_tpu_torch.ops.upfirdn2d")

TOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def assert_close_nhwc(got: torch.Tensor, want, tol=TOL):
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


@pytest.mark.parametrize("taps,kw", [
    ([1, 3, 3, 1], dict()),                                    # plain filter
    ([1, 3, 3, 1], dict(padding=2)),                           # pad
    ([1, 3, 3, 1], dict(padding=(-1, 2, 1, -2))),              # asymmetric + crop
    ([1, 3, 3, 1], dict(up=2, padding=(2, 1, 2, 1), gain=4)),  # up + gain
    ([1, 3, 3, 1], dict(down=2, padding=1)),                   # down (the K1 case)
    ([1, 2, 3, 4], dict(down=2, padding=1, flip_filter=True)),  # down + flip
    ([1, 2, 3, 4], dict(up=(2, 1), down=(1, 2), padding=(1, 2, 0, 1))),  # mixed factors
    ([1, 4, 6, 4, 1, 2, 3, 1], dict(up=2, padding=4, gain=4)),  # separable (8 taps)
    ([1, 4, 6, 4, 1, 2, 3, 1], dict(down=2, padding=3, flip_filter=True)),
])
def test_upfirdn2d(taps, kw):
    x = np.random.RandomState(0).randn(2, 11, 12, 3).astype(np.float32)
    if taps == [1, 2, 3, 4] and "up" not in kw:
        jf = np.outer(taps, [4, 1, 2, 3]).astype(np.float32)    # asymmetric 2-D filter
        tf = torch.from_numpy(jf)
    else:
        jf, tf = jup.setup_filter(taps), setup_filter(taps)
        np.testing.assert_array_equal(tf.numpy(), jf)
    want = jup.upfirdn2d(jnp.asarray(x), jf, **kw)
    assert_close_nhwc(upfirdn2d(nchw(x), tf, **kw), want)


@pytest.mark.parametrize("fn,kw", [
    ("filter2d", dict()), ("filter2d", dict(padding=1, gain=2.0)),
    ("upsample2d", dict()), ("upsample2d", dict(up=(2, 1), padding=1)),
    ("downsample2d", dict()), ("downsample2d", dict(down=2, padding=(0, 1, 1, 0))),
])
def test_resample_wrappers(fn, kw):
    x = np.random.RandomState(1).randn(2, 8, 10, 4).astype(np.float32)
    f = [1, 3, 3, 1]
    want = getattr(jup, fn)(jnp.asarray(x), jup.setup_filter(f), **kw)
    assert_close_nhwc(getattr(tup, fn)(nchw(x), setup_filter(f), **kw), want)


@pytest.mark.parametrize("act", sorted(activation_funcs))
@pytest.mark.parametrize("clamp", [None, 0.7])
def test_bias_act(act, clamp):
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 5, 4, 4) * 2).astype(np.float32)           # NCHW
    b = rng.randn(5).astype(np.float32)
    want = jbias_act(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(b), act=act,
                     clamp=clamp)
    got = bias_act(torch.from_numpy(x), torch.from_numpy(b), act=act, clamp=clamp)
    assert_close_nhwc(got, want)


def test_bias_act_alpha_gain_and_axis():
    rng = np.random.RandomState(3)
    x = rng.randn(6, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    want = jbias_act(jnp.asarray(x), jnp.asarray(b), act="lrelu", alpha=0.1, gain=3.0,
                     clamp=2.0)
    got = bias_act(torch.from_numpy(x), torch.from_numpy(b), act="lrelu", alpha=0.1,
                   gain=3.0, clamp=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


# (kernel, up, down, padding): the 1x1-down, 1x1-up, down, up and plain paths
CONV_CASES = [(1, 1, 2, 0), (1, 2, 1, 0), (3, 1, 2, 1), (3, 2, 1, 1), (3, 1, 1, 1),
              (3, 1, 1, (2, 0, 1, -1))]


@pytest.mark.parametrize("k,up,down,pad", CONV_CASES)
@pytest.mark.parametrize("flip_weight", [True, False])
def test_conv2d_resample(k, up, down, pad, flip_weight):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)                 # HWIO
    f = [1, 3, 3, 1] if (up > 1 or down > 1) else None
    want = jconv2d_resample(jnp.asarray(x), jnp.asarray(w),
                            f=jup.setup_filter(f) if f else None, up=up, down=down,
                            padding=pad, flip_weight=flip_weight)
    got = conv2d_resample(nchw(x), hwio_to_oihw(w), f=setup_filter(f) if f else None,
                          up=up, down=down, padding=pad, flip_weight=flip_weight)
    assert_close_nhwc(got, want)


@pytest.mark.parametrize("demodulate", [True, False])
@pytest.mark.parametrize("with_noise", [True, False])
@pytest.mark.parametrize("k,up", [(3, 1), (3, 2), (1, 1)])
def test_modulated_conv2d(demodulate, with_noise, k, up):
    rng = np.random.RandomState(5)
    N, I, O, H = 2, 4, 6, 8
    x = rng.randn(N, H, H, I).astype(np.float32)
    w = rng.randn(k, k, I, O).astype(np.float32)
    styles = (rng.randn(N, I) + 1).astype(np.float32)
    noise = rng.randn(N, H * up, H * up, 1).astype(np.float32) if with_noise else None
    f = [1, 3, 3, 1] if up > 1 else None
    kw = dict(up=up, padding=k // 2, demodulate=demodulate, flip_weight=(up == 1))
    want = jmodulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(styles),
                             noise=None if noise is None else jnp.asarray(noise),
                             resample_filter=jup.setup_filter(f) if f else None, **kw)
    got = modulated_conv2d(nchw(x), hwio_to_oihw(w), torch.from_numpy(styles),
                           noise=None if noise is None else nchw(noise),
                           resample_filter=setup_filter(f) if f else None, **kw)
    assert_close_nhwc(got, want)
