"""The port's serving export (`python -m stylegan_v_tpu_torch.export_model`)
on the CPU, against scripts/export_model.py's contract (the JAX package's).

  * The CLI's roundtrip (--selftest inside), unconditional and conditional:
    the sidecar's contract, the artifact's shape, finite frames, two seeds
    giving two videos, every op of the graph torch's own.
  * The artifact in a subprocess that imports torch alone (no
    stylegan_v_tpu_torch on its path) equals the artifact in this process.
  * The artifact at a seed equals the JAX build_export body's frames at the
    motion_z that the seed draws (counter_normal), float32 at 1e-4 of scale:
    the same weights through io/bridge.py, noise_mode "const", truncation.
  * counter_normal: its hash equals a uint32 numpy reference; deterministic per
    seed, distinct across seeds, mean, std and neighbour correlation within
    sampling error.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.models import Generator as JGenerator
from stylegan_v_tpu.models.motion import MotionMappingNetwork as JMotion
from stylegan_v_tpu_torch import export_model as texport
from stylegan_v_tpu_torch.io.checkpoint import save_snapshot
from stylegan_v_tpu_torch.models import Discriminator, Generator
from stylegan_v_tpu_torch.training import train_step as tts

from test_torch_models import (jax_generator, port_cfg, port_generator, small_disc_cfg,
                               small_gen_cfg)
from test_torch_train import one_torch_thread

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

B, T = 2, 3


def run_dir(root, c_dim=0):
    gen = torch.Generator().manual_seed(10 + c_dim)
    gcfg = port_cfg(small_gen_cfg(c_dim=c_dim))
    dcfg = port_cfg(small_disc_cfg(c_dim=c_dim))
    state = tts.init_train_state(Generator(gcfg, generator=gen), Discriminator(dcfg, generator=gen),
                                 tts.OptimizerConfig(), tts.OptimizerConfig(),
                                 tts.TrainingConfig(batch_size=4))
    save_snapshot(str(root), state, cur_nimg=0, configs={"G": gcfg, "D": dcfg})
    return str(root)


def artifact_inputs(meta, seed):
    z = torch.from_numpy(np.random.RandomState(1).randn(*meta["inputs"]["z"]).astype(np.float32))
    t = torch.arange(T, dtype=torch.float32)[None].repeat(B, 1)
    c = [torch.eye(meta["inputs"]["c"][1])[:B]] if "c" in meta["inputs"] else []
    return (z, *c, t, torch.tensor(seed, dtype=torch.int32))


@pytest.mark.parametrize("c_dim", [0, 5])
def test_export_roundtrip(tmp_path, c_dim):
    out = str(tmp_path / "model.pt2")
    meta = texport.main(["--ckpt", run_dir(tmp_path / "run", c_dim), "--out", out,
                         "--batch", str(B), "--video-len", str(T), "--selftest",
                         "--device", "cpu"])
    assert meta["selftest_max_abs_err"] < 1e-4
    side = json.load(open(out + ".json"))
    assert side["inputs"]["z"] == [B, 64] and side["inputs"]["t"] == [B, T]
    assert side["inputs"]["seed"] == [] and side["device"] == "cpu"
    assert ("c" in side["inputs"]) == (c_dim > 0) and side["t_max"] == float(T)
    assert side["output"] == [B, T, 3, 32, 32] and side["range"] == [-1.0, 1.0]

    program = torch.export.load(out)
    texport.check_portable(program)
    frames = program.module()(*artifact_inputs(side, 0))
    assert list(frames.shape) == side["output"] and torch.isfinite(frames).all()
    other = program.module()(*artifact_inputs(side, 5))
    assert (frames - other).abs().max() > 1e-4          # another seed, another motion


def test_artifact_runs_with_torch_alone(tmp_path):
    out = str(tmp_path / "model.pt2")
    texport.main(["--ckpt", run_dir(tmp_path / "run"), "--out", out, "--batch", str(B),
                  "--video-len", str(T), "--device", "cpu"])
    side = json.load(open(out + ".json"))
    inputs = artifact_inputs(side, 3)
    torch.save(inputs, str(tmp_path / "inputs.pt"))
    code = (
        "import sys, torch\n"
        f"m = torch.export.load({out!r}).module()\n"
        f"frames = m(*torch.load({str(tmp_path / 'inputs.pt')!r}))\n"
        f"torch.save(frames, {str(tmp_path / 'frames.pt')!r})\n"
        "bad = [k for k in sys.modules if k.startswith('stylegan_v_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(str(tmp_path / "frames.pt"))
    assert torch.equal(got, torch.export.load(out).module()(*inputs))


def test_artifact_equals_the_jax_export_body():
    cfg = small_gen_cfg()
    rng = np.random.RandomState(2)
    z = rng.randn(B, cfg.z_dim).astype(np.float32)
    t = np.tile(np.arange(T, dtype=np.float32)[None], (B, 1))
    truncation, seed = 0.7, 11
    L = JMotion.required_traj_len(cfg, float(T))
    mz = texport.counter_normal(torch.tensor(seed, dtype=torch.int32),
                                (B, L, cfg.motion.z_dim), torch.device("cpu"))
    variables, _ = jax_generator(cfg, z, t, mz.numpy(), noise_mode="const")
    w_avg = rng.randn(cfg.w_dim).astype(np.float32)           # truncation moves toward it
    variables["moving"]["mapping"]["w_avg"] = w_avg
    G = port_generator(cfg, variables).requires_grad_(False)
    assert np.array_equal(G.mapping.w_avg.numpy(), w_avg)

    exported, _ = texport.build_export(G, B, T, truncation)
    got = exported.module()(torch.from_numpy(z), torch.from_numpy(t),
                            torch.tensor(seed, dtype=torch.int32))
    # scripts/export_model.py:build_export's body, at the motion_z the seed drew
    img = JGenerator(cfg).apply(variables, jnp.asarray(z), None, jnp.asarray(t),
                                motion_z=jnp.asarray(mz.numpy()), noise_mode="const",
                                truncation_psi=truncation,
                                rngs={"motion": jax.random.PRNGKey(0)})
    want = np.array(img).reshape(B, T, *img.shape[1:]).transpose(0, 1, 4, 2, 3)
    scale = float(np.abs(want).max())
    err = float((got - torch.from_numpy(want)).abs().max())
    assert got.shape == want.shape and err <= 1e-4 * scale, (err, scale)


def lowbias32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def test_counter_normal():
    cpu = torch.device("cpu")
    x = np.random.RandomState(4).randint(0, 2 ** 32, 4096, dtype=np.uint64)
    x[:3] = (0, 1, 2 ** 32 - 1)
    got = texport._hash32(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), lowbias32(x).astype(np.int64))

    shape = (4, 250, 200)
    draws = [texport.counter_normal(torch.tensor(s, dtype=torch.int32), shape, cpu)
             for s in (0, 0, 1, -1)]
    assert draws[0].shape == shape and draws[0].dtype == torch.float32
    assert torch.equal(draws[0], draws[1])
    for d in draws[1:]:
        assert torch.isfinite(d).all()
    for a, b in ((0, 2), (0, 3), (2, 3)):
        assert (draws[a] - draws[b]).abs().mean() > 1.0
    n = draws[0].numel()
    for d in (draws[0], draws[2], draws[3]):
        flat = d.flatten().double()
        assert abs(float(flat.mean())) < 5 / n ** 0.5
        assert abs(float(flat.std()) - 1.0) < 5 * (0.5 / n) ** 0.5
        corr = float(torch.corrcoef(torch.stack([flat[:-1], flat[1:]]))[0, 1])
        assert abs(corr) < 5 / n ** 0.5
