"""The port's metric detectors against the JAX package's flax detectors, on the CPU.

  * `linear_resize_weights` equals its original, and `bilinear_resize` the
    JAX package's in both mappings;
  * I3D, InceptionV3 and C3D under the same random weights, carried from flax
    by io/bridge.py, give the flax features within TOL of their scale (float32,
    convolutions summed in other orders): the I3D at [2, 8, 32, 32, 3] native
    (its head's window clamped to [1, 2, 2]) and at [1, 8, 64, 64, 3] resized
    to 224^2, the Inception on one image (features, and the probabilities
    without the output bias that IS reads), the C3D on one clip with a mean
    cube;
  * `convert_*_state_dict` of the port's state_dict gives the flax variables
    back, so a file the JAX package's converters read loads into the port;
    and the port's loaders take a file's names with wrapper prefixes.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.metrics.detectors_flax import c3d as jc3d
from stylegan_v_tpu.metrics.detectors_flax import i3d as ji3d
from stylegan_v_tpu.metrics.detectors_flax import inception_v3 as jinc
from stylegan_v_tpu.metrics.detectors_flax import resize as jresize
from stylegan_v_tpu_torch.io import jax_to_torch_c3d, jax_to_torch_i3d, jax_to_torch_inception
from stylegan_v_tpu_torch.metrics.detectors import c3d as tc3d
from stylegan_v_tpu_torch.metrics.detectors import i3d as ti3d
from stylegan_v_tpu_torch.metrics.detectors import inception_v3 as tinc
from stylegan_v_tpu_torch.metrics.detectors import resize as tresize

TOL = 1e-4      # float32, relative to the largest feature magnitude


def random_variables(model, x, seed, **kw):
    """Flax variables of `model` with seeded random values in the structure of
    an abstract init: LeCun-uniform kernels (variance 1/fan_in), batch norms
    away from the identity (the stats conversion is exercised), small biases."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, **kw))
    rng = np.random.default_rng(seed)

    def uniform(shape, lo, hi):
        u = rng.random(shape, np.float32)
        u *= hi - lo
        u += lo
        return u

    def draw(path, s):
        leaf = path[-1].key
        if leaf in ("conv_w", "kernel", "fc_w"):
            a = np.sqrt(3.0 / np.prod(s.shape[:-1]))
            return uniform(s.shape, -a, a)
        if leaf == "bn_w":
            return uniform(s.shape, 0.8, 1.2)
        if leaf == "bn_var":
            return uniform(s.shape, 0.5, 1.5)
        return uniform(s.shape, -0.1, 0.1)                 # bn_b, bn_mean, biases

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw(p, s), np.float32), shapes)


def flax_features(make, variables, x, **kw):
    """The JAX package's features function `make(variables, **kw)` on the batch
    x, with the weights as arguments of its jitted program: closed over, XLA
    folds them as constants, which takes seconds for each detector. The C3D's
    mean cube stays in the closure (its function reads it on the host)."""
    pre = {k: v for k, v in variables.items() if k == "preprocess"}
    weights = {k: v for k, v in variables.items() if k != "preprocess"}
    run = jax.jit(lambda w, a: make({**w, **pre}, **kw).jittable(a))
    return np.asarray(run(weights, jnp.asarray(x)))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def assert_close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= TOL * scale, f"{what}: max abs err {err:.3g} > {TOL} x {scale:.3g}"


def empty(cls):
    """A port module with uninitialised tensors, all of which are loaded next
    (the default init of the C3D's 78M weights takes seconds)."""
    with torch.device("meta"):
        module = cls()
    return module.to_empty(device="cpu")


def bridged(cls, state_dict):
    """A port module whose tensors are the bridge's state_dict (strict)."""
    with torch.device("meta"):
        module = cls()
    module.load_state_dict(state_dict, assign=True)
    return module


def assert_loaded_equal(got, want):
    got, want = got.state_dict(), want.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def state_numpy(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


# ----------------------------------------------------------------- resize

@pytest.mark.parametrize("mapping", ["half_pixel", "asymmetric"])
@pytest.mark.parametrize("sizes", [(256, 224), (64, 224), (17, 13), (31, 29), (112, 112)])
def test_linear_resize_weights_equal_the_jax_package(sizes, mapping):
    for got, want in zip(tresize.linear_resize_weights(*sizes, mapping),
                         jresize.linear_resize_weights(*sizes, mapping)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mapping", ["half_pixel", "asymmetric"])
def test_bilinear_resize_equals_the_jax_package(mapping):
    x = np.random.RandomState(0).rand(2, 3, 17, 31, 3).astype(np.float32) * 255
    want = np.asarray(jresize.bilinear_resize(jnp.asarray(x), 40, 13, 2, 3, mapping))
    got = tresize.bilinear_resize(torch.from_numpy(x), 40, 13, 2, 3, mapping).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# -------------------------------------------------------------------- I3D

@pytest.fixture(scope="module")
def i3d():
    variables = random_variables(ji3d.InceptionI3d(), jnp.zeros((1, 8, 32, 32, 3)), seed=1,
                                 return_features=False)
    model = bridged(ti3d.InceptionI3d, jax_to_torch_i3d(variables))
    return variables, model


@pytest.mark.parametrize("shape,resize", [((2, 8, 32, 32, 3), False),
                                          ((1, 8, 64, 64, 3), True)])
def test_i3d_matches_flax(i3d, shape, resize):
    variables, model = i3d
    videos = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    want = flax_features(ji3d.i3d_features_fn, variables, videos, resize=resize)
    got = ti3d.i3d_features_fn(model, device="cpu", resize=resize)(videos)
    assert got.shape == (shape[0], 1024)
    assert_close(got, want, f"I3D {shape} resize={resize}")


def test_i3d_state_dict_converts_back_and_loads_with_prefixes(i3d):
    variables, model = i3d
    assert_trees_equal(ji3d.convert_i3d_state_dict(state_numpy(model)), variables)
    fresh = empty(ti3d.InceptionI3d)
    ti3d.load_i3d_state_dict(fresh, {f"wrapped.module.{k}": v
                                     for k, v in model.state_dict().items()})
    assert_loaded_equal(fresh, model)


# -------------------------------------------------------------- Inception

@pytest.fixture(scope="module")
def inception():
    variables = random_variables(jinc.InceptionV3(), jnp.zeros((1, 299, 299, 3)), seed=4,
                                 return_features=False)
    model = bridged(tinc.InceptionV3, jax_to_torch_inception(variables))
    return variables, model


@pytest.mark.parametrize("kw", [dict(return_features=True),
                                dict(return_features=False, no_output_bias=True)])
def test_inception_matches_flax(inception, kw):
    variables, model = inception
    images = np.random.RandomState(5).randint(0, 256, (1, 48, 64, 3)).astype(np.uint8)
    want = flax_features(jinc.inception_features_fn, variables, images, **kw)
    got = tinc.inception_features_fn(model, device="cpu", **kw)(images)
    assert got.shape == (1, 2048 if kw["return_features"] else 1008)
    assert_close(got, want, f"Inception {kw}")


def test_inception_state_dict_converts_back_and_loads_by_order(inception):
    variables, model = inception
    assert_trees_equal(jinc.convert_inception_state_dict(state_numpy(model), variables),
                       variables)
    # a file's own names: only the order and the shapes carry the mapping
    renamed = {f"layers.{i}.{k.split('.')[-1]}": v
               for i, (k, v) in enumerate(model.state_dict().items())}
    fresh = empty(tinc.InceptionV3)
    tinc.load_inception_state_dict(fresh, renamed)
    assert_loaded_equal(fresh, model)


# -------------------------------------------------------------------- C3D

@pytest.fixture(scope="module")
def c3d():
    variables = random_variables(jc3d.C3D(), jnp.zeros((1, 16, 112, 112, 3)), seed=6)
    cube = np.random.RandomState(7).rand(16, 112, 112, 3).astype(np.float32) * 60 + 70
    variables = {**variables, "preprocess": {"mean_cube": cube}}
    model = bridged(tc3d.C3D, jax_to_torch_c3d(variables))
    return variables, model


def test_c3d_matches_flax(c3d):
    variables, model = c3d
    videos = np.random.RandomState(8).randint(0, 256, (1, 16, 64, 64, 3)).astype(np.uint8)
    want = flax_features(jc3d.c3d_features_fn, variables, videos)
    got = tc3d.c3d_features_fn(model, device="cpu")(videos)
    assert got.shape == (1, 101)
    assert_close(got, want, "C3D")


def test_c3d_state_dict_converts_back_and_loads_with_prefixes(c3d):
    variables, model = c3d
    assert_trees_equal(jc3d.convert_c3d_state_dict(state_numpy(model)), variables)
    fresh = empty(tc3d.C3D)
    sd = {f"model.{k}": v for k, v in model.state_dict().items() if k != "mean"}
    tc3d.load_c3d_state_dict(fresh, {**sd, "mean": model.mean[None]})       # [1, 3, T, H, W]
    assert_loaded_equal(fresh, model)
    # without a cube, the per-channel means the JAX package falls back to
    mean = jax_to_torch_c3d({"params": {"fc8": variables["params"]["fc8"]}})["mean"]
    assert mean.shape == (3, 16, 112, 112)
    np.testing.assert_array_equal(mean[:, 3, 5, 7].numpy(), np.float32(jc3d.UCF101_MEAN_RGB))
