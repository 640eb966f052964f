"""The port's projection CLI (`python -m stylegan_v_tpu_torch.project`) against
scripts/project.py (the JAX package's), on the CPU at test_torch_models.py's
small configs.

  * multiscale_loss: value and gradient against the JAX function on the same
    numpy arrays (NHWC there, NCHW here), at 1e-5 of scale: both are float32
    sums of the same depthwise filters.
  * One step of the fallback objective at the same weights (io/bridge.py):
    the loss and its gradient with respect to (w, motion_z) against JAX's
    value_and_grad, at 1e-4 of scale, as the port's G is held elsewhere.
  * The LPIPS objective on one scripted stand-in vgg16.pt shared by both
    sides (JAX's through its host bridge): the feature fn and its gradient
    at 384^2 (the area resize to 256), and one step's loss and gradient
    with respect to (w, motion_z), at 1e-4 of scale.
  * The optimizer: torch Adam whose group lr is set each step against
    optax.chain(scale_by_adam(), scale(-1)) times the lr on the same
    gradients, three steps, at 1e-6 of scale.
  * K1 and K1-bwd calls per projection step, counted on the CPU (the wrappers
    count only their CUDA launches, so their plain calls are counted here):
    3 and 3; the target's pyramid once, 3 per motion trial.
  * The CLI end to end with the fallback loss and with a scripted stand-in
    vgg16.pt (LPIPS), each making progress, as tests/test_project_cli.py.
"""
import os
import re
import sys

import numpy as np
import optax
import PIL.Image
import pytest
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import project as jproject  # noqa: E402
from stylegan_v_tpu.models import Generator as JGenerator  # noqa: E402
from stylegan_v_tpu.models.motion import MotionMappingNetwork as JMotion  # noqa: E402
from stylegan_v_tpu_torch import project as tproject  # noqa: E402
from stylegan_v_tpu_torch.utils.latent_opt import get_lr, make_adam, set_lr  # noqa: E402
from stylegan_v_tpu_torch.io.checkpoint import save_snapshot  # noqa: E402
from stylegan_v_tpu_torch.models import Discriminator, Generator  # noqa: E402
from stylegan_v_tpu_torch.ops import fir_kernels  # noqa: E402
from stylegan_v_tpu_torch.training import train_step as tts  # noqa: E402

from test_torch_models import (jax_generator, nchw, port_cfg, port_generator,  # noqa: E402
                               small_disc_cfg, small_gen_cfg)
from test_torch_train import one_torch_thread  # noqa: E402

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

FRAMES = 4


def close(got: torch.Tensor, want, tol: float) -> None:
    got = got.detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err:.3g} > {tol} x scale {scale:.3g}"


@pytest.fixture
def k1_calls(monkeypatch):
    """Counts of K1's and K1-bwd's calls through their wrappers, plain ones too."""
    counts = {"K1": 0, "K1-bwd": 0}
    for name, key in (("downfirdn2d_x2", "K1"), ("downfirdn2d_x2_bwd", "K1-bwd")):
        orig = getattr(fir_kernels, name)

        def counted(*args, _orig=orig, _key=key):
            counts[_key] += 1
            return _orig(*args)
        monkeypatch.setattr(fir_kernels, name, counted)
    return counts


def test_multiscale_loss_matches_jax(k1_calls):
    rng = np.random.RandomState(0)
    a = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    want, want_grad = jax.value_and_grad(lambda x: jproject.multiscale_loss(x, jnp.asarray(b)))(
        jnp.asarray(a))
    x = nchw(a).requires_grad_(True)
    got = tproject.multiscale_loss(x, nchw(b))
    got.backward()
    close(got, want, 1e-5)
    close(x.grad, np.transpose(np.asarray(want_grad), (0, 3, 1, 2)), 1e-5)
    # three 2x downsamples a side, through K1; the gradient runs back through 3 K1-bwd
    assert k1_calls == {"K1": 6, "K1-bwd": 3}
    levels = tproject.pyramid(nchw(b))
    assert [tuple(v.shape[2:]) for v in levels] == [(32, 32), (16, 16), (8, 8), (4, 4)]
    close(tproject.multiscale_loss(x, levels), want, 1e-5)


def jax_projection_loss(cfg, variables, target_nhwc, lpips=None):
    """scripts/project.py's synth and loss_fn (LPIPS through `lpips`, its
    make_lpips_features, else the fallback), under value_and_grad."""
    G = JGenerator(cfg)
    target = jnp.asarray(target_nhwc)
    t = jnp.arange(target.shape[0], dtype=jnp.float32)[None]

    def synth(w, mz):
        def call(g, ws, t):
            return g.synthesis(ws, t=t, motion_z=mz, noise_mode="none")
        return G.apply(variables, w, t, method=call, rngs={"motion": jax.random.PRNGKey(0)})

    if lpips is not None:
        target_features = jax.lax.stop_gradient(lpips(target))

        def loss(w, mz):
            return jnp.sum(jnp.square(lpips(synth(w, mz)) - target_features))
    else:
        def loss(w, mz):
            return jproject.multiscale_loss(synth(w, mz), target)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))


def projection_step_against_jax(lpips_path=None):
    """The projection loss and its (w, motion_z) gradient at one step, the
    port's against JAX's at the same weights, at 1e-4 of scale."""
    cfg = small_gen_cfg()
    rng = np.random.RandomState(1)
    L = JMotion.required_traj_len(cfg, float(FRAMES))
    z = rng.randn(1, cfg.z_dim).astype(np.float32)
    mz = rng.randn(1, L, cfg.motion.z_dim).astype(np.float32)
    t = np.arange(FRAMES, dtype=np.float32)[None]
    variables, _ = jax_generator(cfg, z, t, mz)
    G = port_generator(cfg, variables).requires_grad_(False)
    num_ws = G.num_ws
    w = (0.5 * rng.randn(1, num_ws, cfg.w_dim)).astype(np.float32)
    target = rng.uniform(-1, 1, (FRAMES, 32, 32, 3)).astype(np.float32)

    jax_lpips = tlpips = None
    if lpips_path is not None:
        jax_lpips = jproject.make_lpips_features(lpips_path, 32)
        tlpips = tproject.make_lpips_features(lpips_path, "cpu")
    want, (want_w, want_mz) = jax_projection_loss(cfg, variables, target, jax_lpips)(w, mz)
    wt = torch.from_numpy(w).requires_grad_(True)
    mzt = torch.from_numpy(mz).requires_grad_(True)
    got = tproject.projection_loss(G, nchw(target), tlpips)(wt, mzt)
    got.backward()
    close(got, want, 1e-4)
    close(wt.grad, want_w, 1e-4)
    close(mzt.grad, want_mz, 1e-4)


def test_projection_step_matches_jax():
    projection_step_against_jax()


@pytest.fixture(scope="module")
def fake_vgg_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vgg") / "vgg16.pt")
    torch.jit.script(FakeVGG().eval()).save(path)
    return path


def test_lpips_features_match_jax(fake_vgg_path):
    """Above 256 both sides area-resize to 256 before the features (at a
    factor of 1.5, where area and bilinear differ)."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, 384, 384, 3)).astype(np.float32)
    jax_fn = jproject.make_lpips_features(fake_vgg_path, 384)
    probe = np.random.RandomState(4).randn(2, 8).astype(np.float32)
    want, want_grad = jax.value_and_grad(lambda v: jnp.sum(jax_fn(v) * probe))(jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    feats = tproject.make_lpips_features(fake_vgg_path, "cpu")(xt)
    close(feats, np.asarray(jax_fn(jnp.asarray(x))), 1e-4)
    got = torch.sum(feats * torch.from_numpy(probe))
    got.backward()
    close(got, want, 1e-4)
    close(xt.grad, np.transpose(np.asarray(want_grad), (0, 3, 1, 2)), 1e-4)


def test_lpips_projection_step_matches_jax(fake_vgg_path):
    projection_step_against_jax(fake_vgg_path)


def test_scheduled_adam_matches_optax():
    rng = np.random.RandomState(2)
    params = {"w": rng.randn(1, 6, 8).astype(np.float32),
              "mz": rng.randn(1, 5, 4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * s for k, v in params.items()}
             for s in (1.0, 1e-3, 30.0)]
    lrs = [get_lr(step / 3, 0.1, 0.25, 0.05) for step in range(3)]     # 0, then the ramp
    opt = optax.chain(optax.scale_by_adam(), optax.scale(-1.0))
    state, want = opt.init(params), dict(params)
    tensors = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    topt = make_adam(list(tensors.values()))
    for g, lr in zip(grads, lrs):
        updates, state = opt.update(g, state)
        want = optax.apply_updates(want, jax.tree_util.tree_map(lambda u: lr * u, updates))
        set_lr(topt, lr)
        for k, v in tensors.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
    assert lrs[0] == 0.0 and lrs[2] > 0
    for k, v in tensors.items():
        close(v, want[k], 1e-6)


def small_port_generator(seed=5):
    return Generator(port_cfg(small_gen_cfg()), generator=torch.Generator().manual_seed(seed))


def test_projection_launches_k1_as_derived(k1_calls):
    """K1 and K1-bwd per projection step, derived from the code: the frames'
    pyramid runs 3 K1 forward and 3 K1-bwd in the backward; G's upsamples
    are not the K1 case and their backward is upfirdn2d's own (no K1)."""
    G = small_port_generator().requires_grad_(False)
    target = torch.rand(FRAMES, 3, 32, 32, generator=torch.Generator().manual_seed(6)) * 2 - 1
    trials, steps = 2, 3
    result = tproject.project(G, target, num_steps=steps, motion_init_trials=trials, seed=7,
                              log=lambda *_: None)
    assert k1_calls == {"K1": 3 + 3 * trials + 3 * steps, "K1-bwd": 3 * steps}
    assert len(result["losses"]) == steps and np.isfinite(result["losses"]).all()


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("project")
    gen = torch.Generator().manual_seed(8)
    gcfg, dcfg = port_cfg(small_gen_cfg()), port_cfg(small_disc_cfg())
    state = tts.init_train_state(Generator(gcfg, generator=gen), Discriminator(dcfg, generator=gen),
                                 tts.OptimizerConfig(), tts.OptimizerConfig(),
                                 tts.TrainingConfig(batch_size=4))
    snap = save_snapshot(str(root / "run"), state, cur_nimg=0, configs={"G": gcfg, "D": dcfg})
    target = root / "target"
    target.mkdir()
    base = np.random.RandomState(0).randint(0, 255, (32, 32, 3)).astype(np.uint8)
    for i in range(FRAMES):
        PIL.Image.fromarray(np.roll(base, i, axis=1)).save(target / f"{i:04d}.png")
    return snap, str(target)


class FakeVGG(torch.nn.Module):
    """tests/test_project_cli.py's stand-in with the reference's call
    signature (img 0..255 NCHW, resize_images=, return_lpips=)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(3, 8, 4, stride=4)

    def forward(self, x, resize_images: bool = False, return_lpips: bool = True):
        y = self.conv(x / 255.0)
        y = torch.nn.functional.relu(y).mean(dim=(2, 3))
        norm = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True) + 1e-8)
        return y / norm


@pytest.mark.parametrize("loss", ["multiscale", "lpips"])
def test_project_cli_makes_progress(snapshot, tmp_path, capsys, loss):
    snap, target = snapshot
    out = str(tmp_path / "proj")
    argv = ["--network", snap, "--target-dir", target, "-o", out, "--num-steps", "30",
            "--num-frames", str(FRAMES), "--motion-init-trials", "2", "--device", "cpu"]
    if loss == "lpips":
        det = tmp_path / "detectors"
        det.mkdir()
        torch.jit.script(FakeVGG().eval()).save(str(det / "vgg16.pt"))
        argv += ["--detector-dir", str(det)]
    result = tproject.main(argv)

    text = capsys.readouterr().out
    assert ("Using VGG16-LPIPS perceptual loss" in text) == (loss == "lpips")
    init_l = float(re.search(r"best of \d+ -> ([\d.]+)", text).group(1))
    steps = re.findall(r"step\s+\d+\s+loss ([\d.]+)", text)
    assert steps and float(steps[-1]) < init_l
    assert result["losses"][-1] < result["init_loss"]
    assert os.path.exists(os.path.join(out, "projected.mp4"))
    lat = np.load(os.path.join(out, "projected_latents.npz"))
    L = JMotion.required_traj_len(small_gen_cfg(), float(FRAMES))
    assert lat["w"].shape == (1, small_port_generator().num_ws, 64)
    assert lat["motion_z"].shape == (1, L, 32)
    assert np.isfinite(lat["w"]).all() and np.isfinite(lat["motion_z"]).all()
