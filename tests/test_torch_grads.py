"""Gradients of the PyTorch port's ops, K1's autograd pair and Freeze-D,
against the JAX package, on CPU.

For each op, with the same inputs x (numpy, from a seed), an output
cotangent dy and a probe v per input, both sides give:
  * the value y = f(x);
  * the first-order gradient, the vjp of dy (jax.vjp / torch.autograd.grad);
  * the second order: the gradient of <vjp(dy), v> with respect to every
    input and to dy (jax.grad of that dot / autograd.grad with create_graph),
    which is what R1 and Gpl differentiate.
The JAX side runs NHWC/HWIO, the port NCHW/OIHW; everything is converted to
the JAX layout before it is compared. float32 throughout: values and first
order to 1e-4 of each array's scale (its largest magnitude), second order to
1e-3, since its sums run through twice as many differently ordered steps.
Random inputs keep away from the leaky-ReLU kink and the clamp bounds, whose
ties are tested on their own.
"""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.models import Discriminator as JDiscriminator
from stylegan_v_tpu.ops import bias_act as jbias_act
from stylegan_v_tpu.ops import conv2d_resample as jconv2d_resample
from stylegan_v_tpu.ops import modulated_conv2d as jmodulated_conv2d
from stylegan_v_tpu_torch.io import jax_to_torch_discriminator
from stylegan_v_tpu_torch.models import Discriminator
from stylegan_v_tpu_torch.ops import (bias_act, conv2d_resample, downfirdn2d_x2_bwd_plain,
                                      downfirdn2d_x2_plain, fir_kernels, modulated_conv2d,
                                      setup_filter, upfirdn2d)
from test_torch_models import port_cfg, small_disc_cfg, to_np

jup = importlib.import_module("stylegan_v_tpu.ops.upfirdn2d")

TOL, TOL2 = 1e-4, 1e-3
ASYM = (np.arange(16, dtype=np.float32).reshape(4, 4) - 5.0) / 40

# layout converters, JAX -> port and back
NHWC = (lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))),
        lambda t: t.detach().numpy().transpose(0, 2, 3, 1))
HWIO = (lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))),
        lambda t: t.detach().numpy().transpose(2, 3, 1, 0))
SAME = (lambda a: torch.from_numpy(np.ascontiguousarray(a)), lambda t: t.detach().numpy())


def assert_close(got, want, tol, what):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3g} > {tol} * scale {scale:.3g}"


def check_op(jfn, tfn, args, layouts, out_layout, seed=0):
    """Value, vjp and second order of tfn (port) against jfn (JAX) at args."""
    rng = np.random.RandomState(seed)
    args = [np.asarray(a, np.float32) for a in args]
    y, vjp = jax.vjp(jfn, *args)
    dy = rng.randn(*y.shape).astype(np.float32)
    vs = [rng.randn(*a.shape).astype(np.float32) for a in args]
    jgrads = vjp(dy)

    def probe(args, dy):
        _, vjp = jax.vjp(jfn, *args)
        return sum(jnp.sum(g * v) for g, v in zip(vjp(dy), vs))

    jsecond = jax.grad(probe, argnums=(0, 1))(args, dy)
    jsecond = list(jsecond[0]) + [jsecond[1]]

    targs = [lay[0](a).requires_grad_(True) for a, lay in zip(args, layouts)]
    tdy = out_layout[0](dy).requires_grad_(True)
    ty = tfn(*targs)
    tgrads = torch.autograd.grad(ty, targs, tdy, create_graph=True)
    dot = sum((g * lay[0](v)).sum() for g, v, lay in zip(tgrads, vs, layouts))
    tsecond = torch.autograd.grad(dot, targs + [tdy], allow_unused=True)

    assert_close(out_layout[1](ty), y, TOL, "value")
    for i, (g, w, lay) in enumerate(zip(tgrads, jgrads, layouts)):
        assert_close(lay[1](g), w, TOL, f"grad of input {i}")
    for i, (g, w, lay) in enumerate(zip(tsecond, jsecond, layouts + [out_layout])):
        got = np.zeros(np.shape(w), np.float32) if g is None else lay[1](g)
        assert_close(got, w, TOL2, f"second order, input {i}")


# ----------------------------------------------------------------------- ops

@pytest.mark.parametrize("case", ["k1", "up2", "separable12", "flip", "crop", "mixed", "pad2"])
def test_upfirdn2d_grads(case):
    """The K1 case runs _DownFirX2; every other case _UpFirDn2d, whose
    backward is upfirdn2d with mirrored padding (checked here for crops,
    asymmetric padding and mixed factors too)."""
    x = np.random.RandomState(1).randn(2, 12, 10, 3).astype(np.float32)
    f, kw = [1, 3, 3, 1], {
        "k1": dict(down=2, padding=1),
        "up2": dict(up=2, padding=(2, 1, 2, 1), gain=4),
        "separable12": dict(up=2, down=2, padding=5),
        "flip": dict(down=2, padding=1, flip_filter=True),
        "crop": dict(padding=(-1, 2, 1, -2), flip_filter=True),
        "mixed": dict(up=(2, 1), down=(1, 2), padding=(1, 2, 0, 1), gain=2),
        "pad2": dict(padding=2),            # D's pre-filter of every down=2 3x3 conv
    }[case]
    if case == "separable12":
        f = [1, 2, 4, 6, 8, 9, 9, 8, 6, 4, 2, 1]
    jf, tf = jup.setup_filter(f), setup_filter(f)
    if case in ("flip", "crop", "mixed"):   # an asymmetric 4x4 filter
        jf, tf = ASYM, torch.from_numpy(ASYM)
    check_op(lambda x: jup.upfirdn2d(x, jf, **kw), lambda x: upfirdn2d(x, tf, **kw),
             [x], [NHWC], NHWC)


@pytest.mark.parametrize("act,clamp", [("lrelu", 1.5), ("linear", None), ("tanh", None)])
def test_bias_act_grads(act, clamp):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 4, 5, 6) * 2).astype(np.float32)        # NHWC; |x| > 1.5 often
    b = rng.randn(6).astype(np.float32)
    if clamp is not None:
        assert (np.abs(x) * np.sqrt(2) > clamp).mean() > 0.2   # the clamp is hit
    check_op(lambda x, b: jbias_act(x, b, act=act, clamp=clamp),
             lambda x, b: bias_act(x, b, act=act, clamp=clamp), [x, b], [NHWC, SAME], NHWC)


def test_bias_act_clamp_ties_match_jax():
    """Where the input equals a clamp bound, jnp.clip passes half the gradient;
    beyond it none (the port repaired toward this; torch.clamp passes all)."""
    x = np.asarray([-3.0, -2.0, -1.0, 0.5, 1.0, 2.0, 3.0], np.float32)
    want = jax.grad(lambda x: jnp.sum(jbias_act(x, None, act="linear", clamp=2.0)))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    bias_act(tx, None, dim=0, act="linear", clamp=2.0).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), [0, 0.5, 1, 1, 1, 0.5, 0])


@pytest.mark.parametrize("clamp", [None, 1.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_act_lrelu_grads_at_zero_match_jax(dtype, clamp):
    """jax.nn.leaky_relu passes the whole gradient where its input is exactly 0
    (+0 or -0); F.leaky_relu passed the slope. Value, vjp and second order
    (the gradient of <vjp(dy), v> in x and in dy) against jax.vjp: exact at
    the zeros, elsewhere within one rounding of the working dtype (JAX scales
    by the slope rounded to bf16, torch by the float32 slope)."""
    rng = np.random.RandomState(11)
    x = (rng.randn(96) * 2).astype(np.float32)
    x[::4], x[2::8] = 0.0, -0.0
    dy, v = rng.randn(2, 96).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    zeros = x == 0
    tol = 1e-6 if dtype == "float32" else 1e-2

    def jfn(x):
        return jbias_act(x, None, act="lrelu", clamp=clamp)

    def probe(x, dy):
        return jnp.sum(jax.vjp(jfn, x)[1](dy)[0] * v.astype(jdt))

    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    y, vjp = jax.vjp(jfn, jx)
    want = [y, vjp(jdy)[0], *jax.grad(probe, argnums=(0, 1))(jx, jdy)]
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tdy = torch.from_numpy(dy).to(tdt).requires_grad_(True)
    ty = bias_act(tx, None, dim=0, act="lrelu", clamp=clamp)
    tg, = torch.autograd.grad(ty, tx, tdy, create_graph=True)
    tsx, tsdy = torch.autograd.grad((tg * torch.from_numpy(v).to(tdt)).sum(), [tx, tdy],
                                    allow_unused=True)
    tsx = torch.zeros_like(tx) if tsx is None else tsx
    for what, got, w in zip(("value", "vjp", "second order in x", "second order in dy"),
                            (ty, tg, tsx, tsdy), want):
        got = got.detach().float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_array_equal(got[zeros], w[zeros], err_msg=f"{what} at the zeros")
        np.testing.assert_allclose(got, w, rtol=tol, atol=tol, err_msg=what)
    # the gradient at 0 is the gain (and at a clamp bound it would be halved)
    np.testing.assert_array_equal(tg.detach().float().numpy()[zeros],
                                  (tdy.detach() * float(torch.tensor(np.sqrt(2), dtype=tdt))
                                   ).to(tdt).float().numpy()[zeros])


@pytest.mark.parametrize("k,up,down", [(3, 2, 1), (3, 1, 2), (1, 2, 1), (1, 1, 2)])
def test_conv2d_resample_grads(k, up, down):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = rng.randn(k, k, 4, 5).astype(np.float32)               # HWIO
    f = [1, 3, 3, 1]
    kw = dict(up=up, down=down, padding=k // 2, flip_weight=(up == 1))
    check_op(lambda x, w: jconv2d_resample(x, w, f=jup.setup_filter(f), **kw),
             lambda x, w: conv2d_resample(x, w, f=setup_filter(f), **kw),
             [x, w], [NHWC, HWIO], NHWC)


@pytest.mark.parametrize("demodulate,up", [(True, 1), (False, 1), (True, 2)])
def test_modulated_conv2d_grads(demodulate, up):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 6, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 5).astype(np.float32)
    styles = (rng.randn(2, 4) + 1).astype(np.float32)
    f = [1, 3, 3, 1] if up > 1 else None
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=(up == 1))
    check_op(lambda x, w, s: jmodulated_conv2d(
                 x, w, s, resample_filter=jup.setup_filter(f) if f else None, **kw),
             lambda x, w, s: modulated_conv2d(
                 x, w, s, resample_filter=setup_filter(f) if f else None, **kw),
             [x, w, styles], [NHWC, HWIO, SAME], NHWC)


# ------------------------------------------------------------ K1's Functions

@pytest.mark.parametrize("filt", ["sym", "asym"])
def test_k1_adjoint_identity(filt):
    """<K1(x), dy> == <x, K1bwd(dy)> for the Functions' forward values."""
    f = setup_filter([1, 3, 3, 1]) if filt == "sym" else torch.from_numpy(ASYM)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3, 10, 8)).float()
    dy = torch.from_numpy(rng.randn(2, 3, 5, 4)).float()
    y = fir_kernels._DownFirX2.apply(x, f)
    dx = fir_kernels._UpFirX2.apply(dy, f)
    lhs, rhs = float((y.double() * dy.double()).sum()), float((x.double() * dx.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0), (lhs, rhs)


def test_k1_bwd_plain_matches_jax_vjp_of_downsample2d():
    x = np.random.RandomState(6).randn(2, 12, 8, 3).astype(np.float32)
    dy = np.random.RandomState(7).randn(2, 6, 4, 3).astype(np.float32)
    for f in (jup.setup_filter([1, 3, 3, 1]), ASYM):
        _, vjp = jax.vjp(lambda x: jup.downsample2d(x, f), x)
        want = vjp(dy)[0]
        got = downfirdn2d_x2_bwd_plain(NHWC[0](dy), torch.from_numpy(np.asarray(f)))
        assert_close(NHWC[1](got), want, TOL, "K1-bwd plain")
        # and the conv_transpose2d form is the upfirdn2d form of the same adjoint
        up = upfirdn2d(NHWC[0](dy), torch.from_numpy(np.asarray(f)), up=2,
                       padding=[2, 1, 2, 1], flip_filter=True)
        assert_close(NHWC[1](got), NHWC[1](up), TOL, "upfirdn2d form")


def test_k1_functions_carry_the_plain_versions_on_cpu():
    """On a CPU tensor the pair runs the plain versions, to any order, and
    launches nothing."""
    f = torch.from_numpy(ASYM)
    x = torch.randn(2, 3, 8, 6, generator=torch.Generator().manual_seed(8), requires_grad=True)
    before = (fir_kernels.downfirdn2d_x2.launches, fir_kernels.downfirdn2d_x2_bwd.launches)
    y = fir_kernels._DownFirX2.apply(x, f)
    torch.testing.assert_close(y, downfirdn2d_x2_plain(x.detach(), f), rtol=0, atol=0)
    dy = torch.randn_like(y, requires_grad=True)
    dx, = torch.autograd.grad(y, x, dy, create_graph=True)
    torch.testing.assert_close(dx, downfirdn2d_x2_bwd_plain(dy.detach(), f), rtol=0, atol=0)
    assert dx.grad_fn is not None and "UpFirX2" in type(dx.grad_fn).__name__
    v = torch.randn_like(dx)
    ddy, = torch.autograd.grad((dx * v).sum(), dy)
    torch.testing.assert_close(ddy, downfirdn2d_x2_plain(v, f), rtol=0, atol=0)
    assert (fir_kernels.downfirdn2d_x2.launches,
            fir_kernels.downfirdn2d_x2_bwd.launches) == before


# ----------------------------------------------------------------- Freeze-D

@pytest.mark.parametrize("freeze_layers", [0, 5])
def test_freeze_d_zeroes_exactly_the_frozen_layers(freeze_layers):
    """The JAX counters (discriminator.py:50-56): b32 is fromrgb 0, conv0 1,
    conv1 2, skip 3; b16 is conv0 4, conv1 5, skip 6; so 5 freezes all of b32
    and b16.conv0."""
    cfg = small_disc_cfg(freeze_layers=freeze_layers)
    rng = np.random.RandomState(9)
    img = rng.randn(6, 32, 32, 3).astype(np.float32)
    t = np.asarray([[0.0, 2.0, 7.0], [1.0, 5.0, 6.0]], np.float32)
    JD = JDiscriminator(cfg)
    variables = to_np(jax.jit(JD.init)(jax.random.PRNGKey(2), img, None, t))

    def score(p, img):
        return jnp.sum(JD.apply({"params": p}, img, None, t)["image_logits"] ** 2)

    jgrads = to_np(jax.jit(jax.grad(score))(variables["params"], img))
    want = jax_to_torch_discriminator({"params": jgrads})
    D = Discriminator(port_cfg(cfg))
    D.load_state_dict(jax_to_torch_discriminator(variables))
    x = NHWC[0](img).requires_grad_(True)           # so the first skip still runs K1-bwd
    (D(x, None, torch.from_numpy(t))["image_logits"] ** 2).sum().backward()
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in D.named_parameters()}
    frozen_want = {n for n, g in want.items() if not torch.any(g)}
    frozen_got = {n for n, g in got.items() if not torch.any(g)}
    expected = ({f"b32.{layer}.{p}" for layer in ("fromrgb", "conv0", "conv1", "skip")
                 for p in ("weight", "bias")} | {"b16.conv0.weight", "b16.conv0.bias"}
                if freeze_layers else set())
    expected &= set(want)                            # the skips have no bias
    assert frozen_want == frozen_got == expected
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        assert err <= TOL * scale, f"{n}: max abs err {err:.3g} > {TOL} * {scale:.3g}"
