"""The port's stability gates on the CPU: the shear validator
(`validate_shear_onchip`), the FFS-256 soak (`soak_train`) and the dynamics
probe (`diag_dynamics`), each `python -m stylegan_v_tpu_torch.<name>`.

  * The shear validator's PSNR of the shear warp (bf16 geometry) against the
    gather warp (float32) at 32^2 and 64^2, on the JAX script's draws, is
    within 0.1 dB of what scripts/validate_shear_onchip.py computes with the
    JAX package's warps on the same draws (about 35.6 and 35.0 dB), and its
    gradients are finite.
  * Two soak rounds at a narrow width and 32^2 (the soak's step: bgc ADA,
    R1 at the round's end, the ADA controller) run finite; a NaN planted in
    the batch's frames makes the soak raise, naming round 0.
  * Two steps of diag_dynamics --freeze-d on a moving-pattern zip leave D's
    parameters unchanged and move G's.
  * The five entry points of the slice raise without a card unless asked
    for the CPU.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.ops import setup_filter as jsetup_filter
from stylegan_v_tpu.training import augment as jaug
from stylegan_v_tpu_torch import diag_dynamics as tdiag
from stylegan_v_tpu_torch import fvd_parity as tfp
from stylegan_v_tpu_torch import soak_train as tsoak
from stylegan_v_tpu_torch import train_fvd_demo as tdemo
from stylegan_v_tpu_torch import validate_detectors as tvd
from stylegan_v_tpu_torch import validate_shear_onchip as tshear
from stylegan_v_tpu_torch.models import Discriminator, Generator
from test_torch_models import port_cfg, small_disc_cfg, small_gen_cfg
from test_torch_train import one_torch_thread

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

PSNR_TOL = 0.1         # dB, the port's validator against the JAX script's on the same draws


def jax_psnr(case, hz_pad=tshear.HZ_PAD):
    """scripts/validate_shear_onchip.py's PSNR at one resolution (its jitted
    forwards: shear with bf16 geometry against gather with float32)."""
    x, th, sx, sy = case
    Hz = jsetup_filter(jaug._SYM6)
    G = jaug.rotate2d(jnp.asarray(th)) @ jaug.scale2d(jnp.asarray(sx), jnp.asarray(sy))
    got = np.asarray(jax.jit(lambda x_: jaug._warp_antialiased(
        x_, G, Hz, hz_pad, warp_mode="shear", geom_dtype="bfloat16"))(jnp.asarray(x)))
    ref = np.asarray(jax.jit(lambda x_: jaug._warp_antialiased(
        x_, G, Hz, hz_pad, warp_mode="gather", geom_dtype="float32"))(jnp.asarray(x)))
    return tshear.psnr(ref.transpose(0, 3, 1, 2), got.transpose(0, 3, 1, 2))


def test_the_shear_validator_equals_the_jax_script(one_torch_thread, capsys):
    rows = tshear.main(["--res", "32,64", "--device", "cpu", "--iters", "1"])
    cases = tshear.draws((32, 64))
    assert [r["res"] for r in rows] == [32, 64] and list(cases) == [32, 64]
    for r in rows:
        want = jax_psnr(cases[r["res"]])
        assert abs(r["psnr"] - want) <= PSNR_TOL, (r["res"], r["psnr"], want)
        assert r["grad_finite"] and r["finite"] and r["ok"] and r["psnr"] > 34.0
        assert r["batch"] == 4 and r["canvas"] == (r["res"] + 24) * 2
    out = capsys.readouterr().out
    assert "verdict: {32: True, 64: True}" in out and out.count("-> PASS") == 2


def test_the_shear_draws_follow_the_jax_order():
    """A subset keeps the draws the full sequence gives it."""
    full, alone = tshear.draws(), tshear.draws((128,))
    assert list(full) == list(tshear.RESOLUTIONS) and list(alone) == [128]
    for a, b in zip(full[128], alone[128]):
        np.testing.assert_array_equal(a, b)
    assert [full[r][0].shape[0] for r in tshear.RESOLUTIONS] == [4, 4, 4, 4, 2, 1]


def narrow_models():
    gen = torch.Generator().manual_seed(7)
    return (Generator(port_cfg(small_gen_cfg()), generator=gen),
            Discriminator(port_cfg(small_disc_cfg()), generator=gen))


def test_two_soak_rounds_run_finite(one_torch_thread):
    G, D = narrow_models()
    batch = tsoak.make_batch(2, 3, 32, torch.device("cpu"))
    lines = []
    out = tsoak.soak(G, D, batch, rounds=2, r1_every=2, seed=1, log=lines.append)
    assert out["steps"] == 4 and out["state"].step == 4
    assert set(out["stats"]) == set(tsoak.WATCH)              # the R1 step's
    assert all(np.isfinite(v) for v in out["stats"].values())
    assert np.isfinite(out["augment_p"]) and out["frames_per_s"] > 0
    assert lines[0].startswith("round    0 (step     2): p=") and lines[1].startswith("round    1")
    assert lines[-1].startswith("SOAK PASS: 4 steps, zero non-finite stats, final ADA p=")


def test_a_nan_in_the_batch_stops_the_soak_at_round_0(one_torch_thread):
    G, D = narrow_models()
    batch = tsoak.make_batch(2, 3, 32, torch.device("cpu"))
    batch["real_img"] = batch["real_img"].float()
    batch["real_img"][0, 0, 0, 0, 0] = float("nan")
    with pytest.raises(AssertionError, match=r"non-finite at round 0: \[.*Loss/scores/real"):
        tsoak.soak(G, D, batch, rounds=2, r1_every=2, log=lambda _: None)


def test_the_soak_batch_is_the_jax_scripts():
    batch = tsoak.make_batch(2, 3, 8, torch.device("cpu"))
    rng = np.random.RandomState(0)
    t = np.sort(rng.randint(0, 128, size=(2, 3)).astype(np.float32), axis=1)
    t += np.arange(3)[None] * 0.1
    img = rng.randint(0, 255, (2, 3, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(batch["real_t"].numpy(), t)
    np.testing.assert_array_equal(batch["real_img"].numpy(), img.transpose(0, 1, 4, 2, 3))
    np.testing.assert_array_equal(batch["gen_t"].numpy(), np.stack([t, t + 1, t + 2], axis=1))
    assert batch["real_c"].shape == (2, 0) and batch["gen_c"].shape == (2, 3, 0)


def test_freeze_d_leaves_d_unchanged(one_torch_thread, tmp_path, capsys):
    data = tdemo.load_maker().write_dataset(str(tmp_path / "mv.zip"), 4, 16, 32, seed=0)
    argv = ["--data", data, "--res", "32", "--batch", "4", "--channel-base", "1024",
            "--steps", "2", "--log-every", "1", "--dataset-frames", "16", "--freeze-d",
            "--device", "cpu"]
    before, *_ = tdiag.build(tdiag.parse_args(argv), torch.device("cpu"))
    hist, state = tdiag.main(argv)
    assert [s for s, _ in hist] == [0, 1] and "Loss/r1_penalty" in hist[0][1]
    for name, p in before.D.state_dict().items():
        assert torch.equal(p, state.D.state_dict()[name]), name
    assert any(not torch.equal(p, state.G.state_dict()[n])
               for n, p in before.G.state_dict().items())
    out = capsys.readouterr().out
    assert out.startswith("mode=FROZEN-D (G sanity) lr=0.0025 d_lr=0.0 gamma=0.0512")
    assert "D(fake) logit delta over run:" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("entry", ["validate_detectors", "fvd_parity", "validate_shear_onchip",
                                   "soak_train", "diag_dynamics"])
def test_entry_points_raise_without_a_card(entry, tmp_path):
    main, argv = {
        "validate_detectors": (tvd.main, ["--detector-dir", str(tmp_path)]),
        "fvd_parity": (tfp.main, ["--data", str(tmp_path), "--ckpts", str(tmp_path / "*.pt"),
                                  "--ref-jsonl", str(tmp_path)]),
        "validate_shear_onchip": (tshear.main, ["--res", "32"]),
        "soak_train": (tsoak.main, ["--rounds", "1"]),
        "diag_dynamics": (tdiag.main, ["--data", str(tmp_path / "none.zip")]),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert os.listdir(tmp_path) == []
