"""The port's CLIP editing CLI (`python -m stylegan_v_tpu_torch.clip_edit`)
against scripts/clip_edit.py (the JAX package's), on the CPU at
test_torch_models.py's small config, with tests/test_clip_edit_cli.py's tiny
local transformers CLIP (saved here, loaded by both sides: through the JAX
package's host bridge there, natively here) and its TorchScript ArcFace
stand-in.

  * get_lr equal to the JAX one.
  * edit_loss and its gradient with respect to ws against the JAX script's
    loss_fn (clip_edit.py:138-151) at the same weights, with the ArcFace
    identity term and with the pixel one: the value, each term and the
    gradient at 1e-4 of scale (G's float32 frames agree to ~1e-6; CLIP and
    ArcFace are the same torch modules on both sides).
  * The CLI end to end with both stand-ins: the latent moves, finite.
"""
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import clip_edit as jclip  # noqa: E402
from stylegan_v_tpu.models import Generator as JGenerator  # noqa: E402
from stylegan_v_tpu.models.motion import MotionMappingNetwork as JMotion  # noqa: E402
from stylegan_v_tpu_torch import clip_edit as tclip  # noqa: E402
from stylegan_v_tpu_torch.io.checkpoint import save_snapshot  # noqa: E402
from stylegan_v_tpu_torch.models import Discriminator, Generator  # noqa: E402
from stylegan_v_tpu_torch.training import train_step as tts  # noqa: E402

from test_clip_edit_cli import TinyArcFace, build_tiny_clip  # noqa: E402
from test_torch_models import (jax_generator, port_cfg, port_generator,  # noqa: E402
                               small_disc_cfg, small_gen_cfg)
from test_torch_train import one_torch_thread  # noqa: E402

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

FRAMES = 2
PROMPT = "a smiling face"
CPU = torch.device("cpu")


def close(got: torch.Tensor, want, tol: float) -> None:
    got = got.detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err:.3g} > {tol} x scale {scale:.3g}"


@pytest.fixture(scope="module")
def stand_ins(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip_edit")
    clip_dir = str(root / "clip")
    build_tiny_clip(clip_dir)
    arc_path = str(root / "arcface.pt")
    torch.jit.script(TinyArcFace().eval()).save(arc_path)
    return clip_dir, arc_path, root


def test_get_lr_equals_jax():
    for t in np.linspace(0.0, 0.999, 37):
        for rampdown, rampup in ((0.25, 0.05), (0.5, 0.1)):
            assert tclip.get_lr(t, 0.1, rampdown, rampup) == jclip.get_lr(t, 0.1, rampdown,
                                                                           rampup)


@pytest.mark.parametrize("identity", ["arcface", "pixel"])
def test_edit_loss_matches_jax(stand_ins, identity):
    clip_dir, arc_path, _ = stand_ins
    cfg = small_gen_cfg()
    rng = np.random.RandomState(3)
    L = JMotion.required_traj_len(cfg, float(FRAMES))
    z = rng.randn(1, cfg.z_dim).astype(np.float32)
    mz = rng.randn(1, L, cfg.motion.z_dim).astype(np.float32)
    t = np.arange(FRAMES, dtype=np.float32)[None]
    variables, _ = jax_generator(cfg, z, t, mz)
    G = port_generator(cfg, variables).requires_grad_(False)
    ws0 = (0.5 * rng.randn(1, G.num_ws, cfg.w_dim)).astype(np.float32)
    ws = (ws0 + 0.1 * rng.randn(*ws0.shape)).astype(np.float32)
    l2_weight, id_weight = 0.008, 0.5          # an identity term large enough to matter

    # the JAX script's objective (clip_edit.py:119-151), its CLIP and ArcFace
    # through the host bridge
    jclip_embed, jtext_embed = jclip.make_clip_embed(clip_dir)
    jtext = jnp.asarray(jtext_embed(PROMPT))
    jarc = jclip.make_arcface_embed(arc_path) if identity == "arcface" else None
    JG = JGenerator(cfg)

    def jsynth(w):
        return JG.apply(variables, w, jnp.asarray(t), motion_z=jnp.asarray(mz),
                        noise_mode="none",
                        method=lambda g, ws, t, motion_z, noise_mode:
                        g.synthesis(ws, t=t, motion_z=motion_z, noise_mode=noise_mode),
                        rngs={"motion": jax.random.PRNGKey(0)})

    base = jsynth(jnp.asarray(ws0))
    base_id = jarc(base) if jarc is not None else None

    def loss_fn(w):
        frames = jsynth(w)
        emb = jclip_embed(frames)
        emb = emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)
        c_loss = jnp.sum(1.0 - emb @ jtext)
        l2_loss = jnp.sum(jnp.square(w - ws0))
        if jarc is not None:
            gid = jarc(frames)
            gid = gid / jnp.linalg.norm(gid, axis=-1, keepdims=True)
            bid = base_id / jnp.linalg.norm(base_id, axis=-1, keepdims=True)
            i_loss = jnp.mean(1.0 - jnp.sum(gid * bid, axis=-1))
        else:
            i_loss = jnp.mean(jnp.square(frames - base))
        return c_loss + l2_weight * l2_loss + id_weight * i_loss, (c_loss, l2_loss, i_loss)

    (want, want_terms), want_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jnp.asarray(ws))

    clip_embed, text_embed = tclip.make_clip_embed(clip_dir, CPU)
    text = text_embed(PROMPT)
    close(text, jtext, 1e-6)
    arc = tclip.make_arcface_embed(arc_path, CPU) if identity == "arcface" else None
    tt, mzt = torch.from_numpy(t), torch.from_numpy(mz)

    def synth(w):
        return G.synthesis(w, t=tt, motion_z=mzt, noise_mode="none")

    ws0t = torch.from_numpy(ws0)
    with torch.no_grad():
        tbase = synth(ws0t)
        tbase_id = arc(tbase) if arc is not None else None
    wst = torch.from_numpy(ws).requires_grad_(True)
    got, terms = tclip.edit_loss(synth, wst, ws0t, clip_embed, text, tbase, tbase_id, arc,
                                 l2_weight, id_weight)
    got.backward()
    close(got, want, 1e-4)
    for g, w in zip(terms, want_terms):
        close(g, w, 1e-4)
    close(wst.grad, want_grad, 1e-4)
    assert float(terms[2].detach()) > 0


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("edit_run")
    gen = torch.Generator().manual_seed(9)
    gcfg, dcfg = port_cfg(small_gen_cfg()), port_cfg(small_disc_cfg())
    state = tts.init_train_state(Generator(gcfg, generator=gen), Discriminator(dcfg, generator=gen),
                                 tts.OptimizerConfig(), tts.OptimizerConfig(),
                                 tts.TrainingConfig(batch_size=4))
    return save_snapshot(str(root), state, cur_nimg=0, configs={"G": gcfg, "D": dcfg})


def test_clip_edit_cli(stand_ins, snapshot, capsys):
    clip_dir, arc_path, root = stand_ins
    out = str(root / "edit")
    result = tclip.main(["--network", snapshot, "--text", PROMPT, "--clip-path", clip_dir,
                         "--arcface-path", arc_path, "-o", out, "--num-steps", "20",
                         "--num-frames", str(FRAMES), "--lr", "0.05", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "clip" in text and "id" in text
    assert os.path.exists(os.path.join(out, "edited.mp4"))
    lat = np.load(os.path.join(out, "edited_latents.npz"))
    assert np.isfinite(lat["ws"]).all()
    assert np.abs(lat["ws"] - lat["ws_orig"]).max() > 1e-4
    history = np.asarray(result["history"])
    assert history.shape == (20, 4) and np.isfinite(history).all()
    assert tuple(result["frames"].shape) == (FRAMES, 3, 32, 32)
