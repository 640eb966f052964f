"""Parity of the PyTorch port's model layers, motion encoder, G, D and the
G->D slice against the JAX package, on CPU.

Weights come from the JAX modules' own init and cross through
stylegan_v_tpu_torch.io.bridge (the generator bridge for bare sub-modules);
inputs are numpy arrays from a seed handed to both packages (motion_z
explicitly, so no RNG is drawn inside a model).

Tolerances: float32 everywhere (num_bf16_res=0) holds to 1e-4 relative to
the output scale; the two frameworks only sum in other orders. With bf16
blocks, both round activations to bf16 at the same layers but at other
points inside them, so the check is loose: 5e-2 relative to the output scale.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.models import (Discriminator as JDiscriminator,
                                   Generator as JGenerator,
                                   MotionMappingNetwork as JMotion)
from stylegan_v_tpu.models import config as jconfig
from stylegan_v_tpu.models import layers as jlayers
from stylegan_v_tpu_torch.io import jax_to_torch_discriminator, jax_to_torch_generator
from stylegan_v_tpu_torch.models import config as tconfig
from stylegan_v_tpu_torch.models import layers as tlayers
from stylegan_v_tpu_torch.models.discriminator import Discriminator
from stylegan_v_tpu_torch.models.generator import Generator
from stylegan_v_tpu_torch.models.motion import MotionMappingNetwork

FP32_TOL = 1e-4
BF16_TOL = 5e-2


def small_gen_cfg(**kw):
    """tests/test_models.py:small_gen_cfg (JAX config)."""
    cfg = jconfig.GeneratorConfig(
        w_dim=64, z_dim=64, img_resolution=32, channel_base=1024, channel_max=64,
        num_bf16_res=0, mapping_layers=2,
        motion=jconfig.MotionConfig(z_dim=32, v_dim=32, motion_z_distance=16, kernel_size=11),
        time_enc=jconfig.TimeEncConfig(dim=32, min_period_len=16, max_period_len=1024),
        sampling=jconfig.SamplingConfig(num_frames_per_video=3, max_num_frames=128),
    )
    return jconfig.replace(cfg, **kw) if kw else cfg


def small_disc_cfg(**kw):
    """tests/test_models.py:small_disc_cfg (JAX config)."""
    cfg = jconfig.DiscriminatorConfig(
        img_resolution=32, channel_base=1024, channel_max=64, num_bf16_res=0,
        concat_res=8, mbstd_group_size=2, mapping_layers=2,
        sampling=jconfig.SamplingConfig(num_frames_per_video=3, max_num_frames=128),
    )
    return jconfig.replace(cfg, **kw) if kw else cfg


def port_cfg(cfg):
    """The same config as the port's dataclass."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields = {k: port_cfg(v) if dataclasses.is_dataclass(v) else v for k, v in fields.items()}
    return getattr(tconfig, type(cfg).__name__)(**fields)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def assert_close(got: torch.Tensor, want, tol: float):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err:.3g} > {tol} * scale {scale:.3g}"


def inputs(cfg, B=2, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.randn(B, cfg.z_dim).astype(np.float32)
    t = np.sort(rng.uniform(0, 100, (B, cfg.sampling.num_frames_per_video)), axis=1)
    t = t.astype(np.float32)
    L = JMotion.required_traj_len(cfg)
    mz = rng.randn(B, L, cfg.motion.z_dim).astype(np.float32)
    return z, t, mz


def jax_generator(cfg, z, t, mz, noise_mode="none"):
    G = JGenerator(cfg)
    variables = to_np(G.init(jax.random.PRNGKey(1), z, None, t, motion_z=mz,
                             noise_mode=noise_mode))
    if cfg.use_noise:   # noise_strength starts at 0: make the const noise count
        for block in variables["params"]["synthesis"].values():
            for layer in block.values():
                if "noise_strength" in layer:
                    layer["noise_strength"] = np.float32(0.5)
    img = G.apply(variables, z, None, t, motion_z=mz, noise_mode=noise_mode)
    return variables, np.asarray(img)


def port_generator(cfg, variables):
    G = Generator(port_cfg(cfg))
    G.load_state_dict(jax_to_torch_generator(variables))
    return G.eval()


def jax_discriminator(cfg, img_nhwc, t):
    D = JDiscriminator(cfg)
    variables = D.init(jax.random.PRNGKey(2), img_nhwc, None, t)
    return to_np(variables), np.asarray(D.apply(variables, img_nhwc, None, t)["image_logits"])


def port_discriminator(cfg, variables):
    D = Discriminator(port_cfg(cfg))
    D.load_state_dict(jax_to_torch_discriminator(variables))
    return D.eval()


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("kw", [
    dict(),
    dict(activation="lrelu", lr_multiplier=0.01, bias_init=0.5),
    dict(use_bias=False, activation="linear"),
])
def test_fully_connected(kw):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 24).astype(np.float32)
    layer = jlayers.FullyConnectedLayer(24, 7, **kw)
    variables = to_np(layer.init(jax.random.PRNGKey(0), x))
    want = layer.apply(variables, x)
    tkw = {("bias" if k == "use_bias" else k): v for k, v in kw.items()}
    port = tlayers.FullyConnectedLayer(24, 7, **tkw)
    port.load_state_dict(jax_to_torch_generator(variables))
    assert_close(port(torch.from_numpy(x)), want, FP32_TOL)


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.5, None), (0.7, 2)])
def test_mapping_network_truncation(psi, cutoff):
    rng = np.random.RandomState(1)
    z = rng.randn(4, 16).astype(np.float32)
    m = jlayers.MappingNetwork(z_dim=16, c_dim=0, w_dim=16, num_ws=5, num_layers=2)
    variables = to_np(m.init(jax.random.PRNGKey(0), z, None))
    variables["moving"]["w_avg"] = rng.randn(16).astype(np.float32)
    want = m.apply(variables, z, None, truncation_psi=psi, truncation_cutoff=cutoff)
    port = tlayers.MappingNetwork(z_dim=16, c_dim=0, w_dim=16, num_ws=5, num_layers=2)
    port.load_state_dict(jax_to_torch_generator(variables))
    got = port(torch.from_numpy(z), None, truncation_psi=psi, truncation_cutoff=cutoff)
    assert_close(got, want, FP32_TOL)


def test_mapping_network_c_only_and_w_avg_update():
    """D's cmap mapping (z_dim=0, embed) and the w_avg moving average."""
    rng = np.random.RandomState(2)
    c = rng.randn(3, 10).astype(np.float32)
    m = jlayers.MappingNetwork(z_dim=0, c_dim=10, w_dim=12, num_ws=None, num_layers=3,
                               w_avg_beta=None)
    variables = to_np(m.init(jax.random.PRNGKey(0), None, c))
    port = tlayers.MappingNetwork(z_dim=0, c_dim=10, w_dim=12, num_ws=None, num_layers=3,
                                  w_avg_beta=None)
    port.load_state_dict(jax_to_torch_generator(variables))
    assert_close(port(None, torch.from_numpy(c)), m.apply(variables, None, c), FP32_TOL)

    z = rng.randn(4, 8).astype(np.float32)
    m2 = jlayers.MappingNetwork(z_dim=8, c_dim=0, w_dim=8, num_ws=2, num_layers=2)
    v2 = to_np(m2.init(jax.random.PRNGKey(1), z, None))
    _, mut = m2.apply(v2, z, None, update_w_avg=True, mutable=["moving"])
    port2 = tlayers.MappingNetwork(z_dim=8, c_dim=0, w_dim=8, num_ws=2, num_layers=2)
    port2.load_state_dict(jax_to_torch_generator(v2))
    port2(torch.from_numpy(z), None, update_w_avg=True)
    assert_close(port2.w_avg, mut["moving"]["w_avg"], FP32_TOL)


def test_eqlr_conv1d_and_time_encoders():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 30, 6).astype(np.float32)                         # NLC
    conv = jlayers.EqLRConv1d(6, 5, 11, activation="lrelu", lr_multiplier=0.01)
    variables = to_np(conv.init(jax.random.PRNGKey(0), x))
    port = tlayers.EqLRConv1d(6, 5, 11, activation="lrelu", lr_multiplier=0.01)
    port.load_state_dict(jax_to_torch_generator(variables))
    got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert_close(got, conv.apply(variables, x), FP32_TOL)

    t = np.asarray([[0.0, 3.5, 17.25], [2.0, 2.5, 99.0]], np.float32)
    assert_close(tlayers.FixedTimeEncoder(128)(torch.from_numpy(t)),
                 jlayers.FixedTimeEncoder(128)(jnp.asarray(t)), FP32_TOL)


@pytest.mark.parametrize("kind", ["random", "uniform"])
def test_temporal_difference_encoder(kind):
    sampling = jconfig.SamplingConfig(type=kind, num_frames_per_video=3, max_num_frames=64)
    # 2.5 - 2.0 = 0.5 rounds half to even (to 0) in both frameworks
    t = np.asarray([[0.0, 4.0, 9.0], [2.0, 2.5, 40.5]], np.float32)
    enc = jlayers.TemporalDifferenceEncoder(sampling)
    variables = to_np(enc.init(jax.random.PRNGKey(0), t))
    port = tlayers.TemporalDifferenceEncoder(port_cfg(sampling))
    port.load_state_dict(jax_to_torch_generator(variables))
    assert port.get_dim() == enc.get_dim()
    assert_close(port(torch.from_numpy(t)), enc.apply(variables, t), FP32_TOL)


# ------------------------------------------------------------------ motion

@pytest.mark.parametrize("fourier", [True, False])
def test_motion_mapping_network(fourier):
    cfg = small_gen_cfg(**{"motion.fourier": fourier})
    _, t, mz = inputs(cfg)
    enc = JMotion(cfg)
    variables = to_np(enc.init(jax.random.PRNGKey(0), None, t, motion_z=mz))
    want = enc.apply(variables, None, t, motion_z=mz)["motion_v"]
    port = MotionMappingNetwork(port_cfg(cfg))
    prefix = "synthesis.motion_encoder."
    sd = jax_to_torch_generator({"params": {"synthesis": {"motion_encoder": variables["params"]}}})
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    got = port(None, torch.from_numpy(t), motion_z=torch.from_numpy(mz))["motion_v"]
    assert got.shape[1] == port.get_dim()
    assert_close(got, want, FP32_TOL)


# ------------------------------------------------------------------- G, D

@pytest.mark.parametrize("kw,tol", [
    (dict(), FP32_TOL),
    (dict(architecture="resnet"), FP32_TOL),
    # motion codes on w instead of the const input (w_dim == 2 * time_enc.dim)
    ({"time_enc.cond_type": "sum_w", "input_type": "const"}, FP32_TOL),
    ({"time_enc.cond_type": "concat_w", "input_type": "const"}, FP32_TOL),
    (dict(num_bf16_res=2), BF16_TOL),
    (dict(use_noise=True), FP32_TOL),            # per-layer const noise
])
def test_generator(kw, tol):
    cfg = small_gen_cfg(**kw)
    noise_mode = "const" if cfg.use_noise else "none"
    z, t, mz = inputs(cfg)
    variables, want = jax_generator(cfg, z, t, mz, noise_mode)
    G = port_generator(cfg, variables)
    with torch.no_grad():
        got = G(torch.from_numpy(z), None, torch.from_numpy(t), motion_z=torch.from_numpy(mz),
                noise_mode=noise_mode)
    assert got.dtype == torch.float32
    assert_close(got, np.transpose(want, (0, 3, 1, 2)), tol)


@pytest.mark.parametrize("num_bf16_res,tol", [(0, FP32_TOL), (2, BF16_TOL)])
def test_discriminator(num_bf16_res, tol):
    cfg = small_disc_cfg(num_bf16_res=num_bf16_res)
    rng = np.random.RandomState(4)
    img = rng.randn(6, 32, 32, 3).astype(np.float32)
    t = np.asarray([[0.0, 2.0, 7.0], [1.0, 5.0, 6.0]], np.float32)
    variables, want = jax_discriminator(cfg, img, t)
    D = port_discriminator(cfg, variables)
    with torch.no_grad():
        got = D(nchw(img), None, torch.from_numpy(t))["image_logits"]
    assert got.shape == (2,)
    assert_close(got, want, tol)


def test_generate_then_score_slice():
    """The slice end to end: G forward, then D forward on the frames."""
    gcfg, dcfg = small_gen_cfg(), small_disc_cfg()
    z, t, mz = inputs(gcfg, B=2, seed=5)
    gvars, frames = jax_generator(gcfg, z, t, mz)
    dvars, want = jax_discriminator(dcfg, frames, t)
    G, D = port_generator(gcfg, gvars), port_discriminator(dcfg, dvars)
    with torch.no_grad():
        tt = torch.from_numpy(t)
        got_frames = G(torch.from_numpy(z), None, tt, motion_z=torch.from_numpy(mz))
        got = D(got_frames, None, tt)["image_logits"]
    assert_close(got_frames, np.transpose(frames, (0, 3, 1, 2)), FP32_TOL)
    assert_close(got, want, FP32_TOL)


def test_weights_from_seeded_generator_are_reproducible():
    """Port weights come from an explicit torch.Generator, not the global RNG."""
    cfg = port_cfg(small_gen_cfg())
    a = Generator(cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    torch.manual_seed(123)
    b = Generator(cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
