"""Parity of the PyTorch port's ADA pipe and bilinear warp against the JAX
package, on CPU.

Inputs are numpy arrays from a seed, NHWC on the JAX side and NCHW in the
port, compared in the JAX layout. The JAX pipe takes one key of
`jax.random.split(rng, 64)` per draw; `JaxKeyDraws` replays exactly those
draws into the port's pipe as its draw source. Every JAX pipe runs the
gather warp (`warp_mode="gather"`: "auto" is the shear executor on a CPU)
in float32 (`geom_dtype="auto"` is float32 on a CPU on both sides); the
pipe with the shear executor on both sides is held in test_torch_shear.py.

Tolerances, float32 throughout:
  * the copied constants, config and filter bank are equal exactly;
  * the matrix helpers to 1e-6 of scale (sin, cos and exp2 may differ by
    an ulp between the two frameworks);
  * the warp's value and first order to TOL = 1e-4 of each array's scale
    (its largest magnitude), its second order to TOL2 = 1e-3
    (test_torch_grads.py:check_op); the port's value is bitwise JAX's here,
    the vjp differs by the scatter's summation order;
  * the pipe to TOL of scale: both build G_inv and the color matrix from the
    same draws in the same product order, and only the last bits of
    sin/cos/exp2/erfinv and the 3x3 products differ (a few 1e-6 of scale
    measured); its vjp and second order (R1 through ADA) as check_op's.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.ops.grid_sample import affine_grid_sample as jaffine_grid_sample
from stylegan_v_tpu.training import augment as jaug
from stylegan_v_tpu_torch.ops import grid_sample as tgs
from stylegan_v_tpu_torch.training import augment as taug
from test_torch_grads import NHWC, TOL, check_op

PIPES = ["blit", "geom", "color", "filter", "noise", "cutout", "bgc", "bgcfnc"]


class JaxKeyDraws:
    """The JAX pipe's draws from `rng` (augment.py:341-347), as a draw source."""

    def __init__(self, rng):
        self.keys = iter(jax.random.split(rng, 64))

    def rand(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(next(self.keys), shape)))

    def randn(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(next(self.keys), shape)))


def pipes(spec, warp_mode="gather", **kw):
    """The JAX pipe and the port's, from one augpipe preset, with the gather
    warp (or `warp_mode`'s executor)."""
    kw = dict(jaug.AUGPIPE_SPECS[spec], warp_mode=warp_mode, **kw)
    return (jaug.make_augment_pipe(jaug.AugmentConfig(**kw)),
            taug.make_augment_pipe(taug.AugmentConfig(**kw)))


def assert_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3g} > {tol} * scale {scale:.3g}"


# ------------------------------------------------------- copied constants

@pytest.mark.parametrize("name", ["_SYM6", "_SYM2", "AUGPIPE_SPECS"])
def test_constants_equal_the_jax_package(name):
    assert getattr(taug, name) == getattr(jaug, name)


def test_augment_config_copy_equals_the_jax_package():
    jf, tf = dataclasses.fields(jaug.AugmentConfig), dataclasses.fields(taug.AugmentConfig)
    assert [(f.name, f.type, f.default) for f in jf] == [(f.name, f.type, f.default) for f in tf]
    assert taug.AugmentConfig.__dataclass_params__.frozen


def test_filter_bank_equals_the_jax_package():
    got, want = taug._build_fbank(), jaug._build_fbank()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (4, 43)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("helper", ["translate2d", "scale2d", "rotate2d", "translate3d",
                                    "scale3d", "rotate3d"])
def test_matrix_helpers_match_jax(helper):
    rng = np.random.RandomState(1)
    args = {"translate2d": 2, "scale2d": 2, "rotate2d": 1, "translate3d": 3, "scale3d": 3,
            "rotate3d": 1}[helper]
    xs = [(rng.randn(5) * 2).astype(np.float32) for _ in range(args)]
    if helper == "rotate3d":
        v = (np.asarray([1, 1, 1, 0]) / np.sqrt(3)).astype(np.float32)
        want = jaug.rotate3d(jnp.asarray(v), jnp.asarray(xs[0]))
        got = taug.rotate3d(torch.from_numpy(v), torch.from_numpy(xs[0]))
    else:
        want = getattr(jaug, helper)(*map(jnp.asarray, xs))
        got = getattr(taug, helper)(*map(torch.from_numpy, xs))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want, 1e-6, helper)


# ------------------------------------------------------------------ the warp

def g_inv_set(name, N=2):
    """[N, 3, 3] float32 inverse maps. "shift": identity, then a shift of
    0.6 px left, which puts the first column's samples at px = -0.6 (the
    mirror's x0 = -1 clip in reflect mode, inside the image in zeros mode);
    "extreme": a quarter scale (the samples reach 4x past the border), 45
    degrees and a translation past the border; "random": a generic affine."""
    G = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    if name == "shift":
        G[1, 0, 2] = G[1, 1, 2] = -0.6 * 2 / 9
    elif name == "extreme":
        c = np.cos(np.pi / 4) * 4
        G[0] = [[c, -c, 1.7], [c, c, -2.3], [0, 0, 1]]
        G[1] = [[4, 0, -3.1], [0, 4, 2.6], [0, 0, 1]]
    else:
        G[:, :2] += np.random.RandomState(2).randn(N, 2, 3).astype(np.float32) * 0.4
    return G


@pytest.mark.parametrize("gset", ["shift", "extreme", "random"])
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_affine_grid_sample_matches_jax(mode, gset):
    """Value, vjp and the second order (jax.vjp of a vjp) of the warp, on a
    9 x 9 image to an 8 x 11 output; G_inv takes no gradient."""
    x = np.random.RandomState(3).randn(2, 9, 9, 4).astype(np.float32)
    G = g_inv_set(gset)
    check_op(lambda x: jaffine_grid_sample(x, G, 8, 11, mode=mode),
             lambda x: tgs.affine_grid_sample(x, torch.from_numpy(G), 8, 11, mode),
             [x], [NHWC], NHWC)


@pytest.fixture
def one_thread():
    """gradcheck runs thousands of tiny float64 ops; with every core per op
    they crawl when the test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_affine_warp_gradcheck(mode, one_thread):
    """_AffineWarp to second order in float64 (its backward _AffineWarpT is the
    exact transpose, whose backward is _AffineWarp again)."""
    x = torch.randn(2, 2, 5, 4, dtype=torch.float64, requires_grad=True,
                    generator=torch.Generator().manual_seed(4))
    G = torch.from_numpy(np.concatenate([g_inv_set("extreme"), g_inv_set("random")])[1:3])
    fn = lambda x: tgs._AffineWarp.apply(x, G, 3, 6, mode)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
    dy = torch.randn(2, 2, 3, 6, dtype=torch.float64, requires_grad=True)
    fnT = lambda dy: tgs._AffineWarpT.apply(dy, G, 5, 4, mode)  # noqa: E731
    assert torch.autograd.gradcheck(fnT, (dy,))


def test_affine_grid_sample_refuses_a_g_inv_gradient():
    G = torch.eye(3).repeat(1, 1, 1).requires_grad_(True)
    with pytest.raises(AssertionError, match="G_inv"):
        tgs.affine_grid_sample(torch.zeros(1, 1, 4, 4), G, 4, 4)


def test_plane_filter_gradcheck(one_thread):
    """imgfilter's per-plane separable filter: every order is a forward pass."""
    x = torch.randn(1, 2, 5, 6, dtype=torch.float64, requires_grad=True,
                    generator=torch.Generator().manual_seed(5))
    k = torch.randn(2, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(6))
    for axis in (2, 3):
        fn = lambda x: taug._PlaneFilter.apply(x, k, axis)  # noqa: E731
        assert torch.autograd.gradcheck(fn, (x,))
        assert torch.autograd.gradgradcheck(fn, (x,))


# ------------------------------------------------------------------ the pipe

def run_both(spec, x, p, rng, debug_percentile=None, **kw):
    jpipe, tpipe = pipes(spec, **kw)
    want = np.asarray(jpipe(rng, jnp.asarray(x), p, debug_percentile=debug_percentile))
    got = tpipe(JaxKeyDraws(rng), NHWC[0](x), torch.tensor(p),
                debug_percentile=debug_percentile)
    return NHWC[1](got), want


@pytest.mark.parametrize("warp_upsample", [1, 2])
@pytest.mark.parametrize("C", [3, 9])
@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("spec", PIPES)
def test_pipe_matches_jax(spec, p, C, warp_upsample):
    """4 samples at 32^2 (C = 9: 3 frames sharing one transform)."""
    x = (np.random.RandomState(7).randn(4, 32, 32, C) * 0.5).astype(np.float32)
    got, want = run_both(spec, x, p, jax.random.PRNGKey(8), warp_upsample=warp_upsample)
    assert np.abs(want - x).max() > 1e-2, "the pipe did nothing"
    assert_close(got, want, TOL, spec)


@pytest.mark.parametrize("C", [3, 9])
@pytest.mark.parametrize("dp", [0.1, 0.5, 0.9])
def test_bgc_debug_percentile_matches_jax(dp, C):
    """The deterministic debug mode overrides every draw (which are still taken)."""
    x = (np.random.RandomState(9).randn(2, 32, 32, C) * 0.5).astype(np.float32)
    got, want = run_both("bgc", x, 1.0, jax.random.PRNGKey(10), debug_percentile=dp)
    assert_close(got, want, TOL, f"bgc at debug_percentile {dp}")


@pytest.mark.parametrize("spec,warp_upsample", [("bgc", 2), ("bgc", 1), ("bgcfnc", 2)])
def test_pipe_grads_match_jax(spec, warp_upsample):
    """The pipe's vjp and its second order (R1 through ADA), C = 9, p = 0.5."""
    x = (np.random.RandomState(11).randn(2, 32, 32, 9) * 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(12)
    jpipe, tpipe = pipes(spec, warp_upsample=warp_upsample)
    check_op(lambda x: jpipe(rng, x, 0.5),
             lambda x: tpipe(JaxKeyDraws(rng), x, torch.tensor(0.5)), [x], [NHWC], NHWC)


@pytest.mark.parametrize("warp_upsample", [1, 2])
def test_identity_at_p_zero(warp_upsample):
    """p = 0: every gate fails, every transform is the identity (the warp
    still runs: its filters are orthogonal, so it gives the image back)."""
    x = (np.random.RandomState(13).randn(2, 32, 32, 9) * 0.5).astype(np.float32)
    got, want = run_both("bgcfnc", x, 0.0, jax.random.PRNGKey(14),
                         warp_upsample=warp_upsample)
    np.testing.assert_allclose(got, x, atol=1e-4)
    assert_close(got, want, TOL, "p = 0")


def test_pipe_draws_from_a_generator_and_takes_p_as_a_device_tensor():
    """A torch.Generator is a draw source; the same seed gives the same images."""
    _, tpipe = pipes("bgc")
    x = torch.randn(2, 9, 32, 32, generator=torch.Generator().manual_seed(15))
    p = torch.tensor(0.7)
    y1 = tpipe(torch.Generator().manual_seed(16), x, p)
    y2 = tpipe(taug.GeneratorDraws(torch.Generator().manual_seed(16)), x, p)
    assert torch.equal(y1, y2) and not torch.allclose(y1, x, atol=0.1)
    with pytest.raises(ValueError, match="draw source"):
        tpipe(None, x, p)


@pytest.mark.parametrize("kw,match", [(dict(warp_mode="bilinear"), "warp_mode")])
def test_unported_options_raise(kw, match):
    """A warp executor that neither package has is refused; "shear" is ported
    (test_torch_shear.py)."""
    with pytest.raises(ValueError, match=match):
        taug.make_augment_pipe(taug.AugmentConfig(**kw))


def test_data_shards_are_accepted_and_change_nothing():
    """data_shards only chunks the JAX package's warp; the port's pipe gives
    the same images for any count, to the bit."""
    x = torch.randn(4, 9, 32, 32, generator=torch.Generator().manual_seed(17))
    p = torch.tensor(0.7)
    out = [taug.make_augment_pipe(taug.AugmentConfig(**jaug.AUGPIPE_SPECS["bgc"],
                                                     data_shards=n))(
               torch.Generator().manual_seed(18), x, p) for n in (1, 2, 4)]
    assert all(torch.equal(o, out[0]) for o in out[1:])
