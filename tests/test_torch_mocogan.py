"""The port's MoCoGAN discriminator (stylegan_v_tpu_torch/models/mocogan.py)
and autoregressive (LSTM) motion encoder against the JAX package on the CPU;
the counterpart of tests/test_mocogan.py.

  * Forward passes within FP32_TOL (1e-4 of scale, test_torch_models.py):
    the video D at 64^2 with 16 frames and num_t_paddings=0, and with 3
    frames and num_t_paddings=6; the multiscale VideoDiscriminator with and
    without its intermediate features; MoCoGANDiscriminator's two logits;
    the LSTM G's frames. The video D's instance noise is drawn inside the
    JAX module (make_rng("noise")): `JaxVideoNoise` records those normals
    (a jitted apply during whose trace jax.random.normal records what it
    returns) and `ReplayNoise` hands them to the port as its draw source.
  * The LSTM bridge is the inverse of the JAX package's convert_lstm_state,
    to the bit.
  * Two MoCoGAN steps with R1 and the video branch's 0.1x learning rate,
    each from the JAX state before it (the second with optax's
    multi_transform moments carried by the bridge), within
    test_torch_train.py's TOL: the stats, the video ones included, G, D,
    G_ema and Adam's moments per group. JAX's draws are replayed as there,
    D's noise with them, and D's input from G takes the JAX frames' values
    (test_torch_train.py's `pin`). The moments of the video D, and of G's
    synthesis, whose Gmain gradient runs back through the video D, are held
    to VIDEO_TOL = 1e-2 of scale: the video D's leaky ReLUs follow batch
    norms, whose outputs crowd around zero, and one input that crosses zero
    moves a gradient element by up to ~1e-2 of scale. JAX does it to itself
    (`test_jax_moves_its_own_video_d_gradient_at_a_kink`: 8.6e-3 and 6.6e-3
    of scale at a 1e-5 move of the frames). The image D's and the mapping's
    moments, and the parameters, stay at TOL (Adam's eps keeps the update
    Lipschitz in g).
  * Port only: a step moves the video branch 0.1 as far as a run without
    the split; a snapshot and its restore keep both groups' learning rates.
  * The loop through the entry point with model=mocogan: two ticks, a
    snapshot, a resume that keeps the groups, both logit streams in
    stats.jsonl.
  * An LSTM G through generate (against scripts/generate.py), the generator
    metrics (against the JAX package, JAX's draws replayed) and the frame
    split (rank blocks against one process).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.io import legacy as jleg
from stylegan_v_tpu.metrics import metric_utils as jmu
from stylegan_v_tpu.models import Generator as JGenerator
from stylegan_v_tpu.models import mocogan as jmoco
from stylegan_v_tpu.models.motion import MotionMappingNetwork as JMotion
from stylegan_v_tpu.training import train_step as jts
from stylegan_v_tpu.training import video_io as jvio
from stylegan_v_tpu_torch import generate as tgen
from stylegan_v_tpu_torch import train as ttrain
from stylegan_v_tpu_torch import train_setup as tsetup
from stylegan_v_tpu_torch.io import (jax_to_torch_discriminator, jax_to_torch_generator,
                                     jax_to_torch_train_state, load_adam_state)
from stylegan_v_tpu_torch.io.bridge import jax_to_torch_adam
from stylegan_v_tpu_torch.io.checkpoint import load_snapshot, restore_train_state, save_snapshot
from stylegan_v_tpu_torch.metrics import metric_utils as tmu
from stylegan_v_tpu_torch.models import (Generator, MoCoGANDiscriminator,
                                         MoCoGANVideoDiscriminator, VideoDiscriminator)
from stylegan_v_tpu_torch.parallel import sharded_eval
from stylegan_v_tpu_torch.parallel.distributed import World
from stylegan_v_tpu_torch.tools.ref_pickle import write_reference_pickle
from stylegan_v_tpu_torch.training import loss as tloss_mod
from stylegan_v_tpu_torch.training import train_step as tts
from stylegan_v_tpu_torch.training import video_io as tvio
from test_data import build_video_dataset_zip
from test_torch_cli import jax_cli, recording, replaying_motion
from test_torch_metrics import JaxGenDraws, assert_frames_agree, dataset_kwargs, ds_path, pixels
from test_torch_models import (FP32_TOL, assert_close, inputs, nchw, port_cfg, small_disc_cfg,
                               small_gen_cfg, to_np)
from test_torch_train import (TOL, JaxDraws, assert_state_close, assert_stats_close,
                              assert_tree_close, make_batch, numpy, one_torch_thread)

__all__ = ["ds_path", "one_torch_thread"]     # fixtures from test_torch_metrics, _train

# configs/model/mocogan.yaml's generator at test_torch_models.py's small widths
LSTM = {"motion.gen_strategy": "autoregressive", "motion.fourier": False,
        "motion.motion_z_distance": 1, "input_type": "const",
        "time_enc.cond_type": "concat_w"}
RES, B, F, NTP = 64, 4, 3, 6     # tests/test_mocogan.py's step: 3 frames need t paddings
MGCFG = small_gen_cfg(img_resolution=RES, **LSTM)
MDCFG = small_disc_cfg(img_resolution=RES)
MLOSS = dict(r1_gamma=1.0, pl_weight=0.0, style_mixing_prob=0.0)   # mocogan.yaml's
MTRAIN = dict(batch_size=B, ema_kimg=1.0, ada_target=0.6, ada_interval=1,
              G_reg_interval=None, D_reg_interval=4)
OPT = dict(lr=0.0025, eps=1e-3)      # test_torch_train.py's: Adam Lipschitz in g
VIDEO_TOL = 1e-2                     # moments through the video D (module docstring)


def ncdhw(a):
    """NDHWC numpy -> NCDHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


class ReplayNoise:
    """A draw source handing out recorded JAX normals, NDHWC, in the port's
    NCDHW layout, in call order."""

    def __init__(self, arrays):
        self.arrays, self.next = list(arrays), 0

    def randn(self, shape):
        x = ncdhw(self.arrays[self.next])
        self.next += 1
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), tuple(shape))
        return x


class JaxVideoNoise:
    """The normals a JAX module's video D draws in `apply(variables, key,
    *inputs)` (with rngs={"noise": key}), recorded under jit: while the
    apply is traced, jax.random.normal keeps what it returns for a video
    [B, T, H, W, C] (flax traces its parameter initialisers too), and the
    jitted function returns those arrays; with `output`, the apply's output
    too, from the same compiled forward (else XLA drops the rest of it)."""

    def __init__(self, apply, output=False):
        self.apply, self.output = apply, output
        self.run = jax.jit(self._record)

    def _record(self, variables, key, *xs):
        drawn, normal = [], jax.random.normal

        def recording_normal(k, shape=(), dtype=jnp.float32):
            x = normal(k, shape, dtype)
            if len(shape) == 5:
                drawn.append(x)
            return x

        jax.random.normal = recording_normal
        try:
            out = self.apply(variables, key, *xs)
        finally:
            jax.random.normal = normal
        return drawn, (out if self.output else None)

    def __call__(self, variables, key, *xs):
        """ReplayNoise of the draws; with `output`, (ReplayNoise, the output)."""
        drawn, out = self.run(variables, key, *xs)
        noise = ReplayNoise(np.asarray(a) for a in drawn)
        return (noise, out) if self.output else noise


def jax_video_noise(JD, output=False):
    """JaxVideoNoise of a MoCoGANDiscriminator: (variables, key, img, t)."""
    return JaxVideoNoise(lambda v, k, img, t: JD.apply(v, img, None, t, rngs={"noise": k}),
                         output)


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("frames,ntp", [(16, 0), (3, 6)])
def test_video_discriminator_matches_jax(frames, ntp):
    """16 frames collapse to one time step at num_t_paddings=0 (the reference's
    MoCoGAN sampling); 3 frames need num_t_paddings=6, as tests/test_mocogan.py's."""
    JVD = jmoco.MoCoGANVideoDiscriminator(n_channels=3, image_size=RES, num_t_paddings=ntp)
    x = np.random.RandomState(0).randn(2, frames, RES, RES, 3).astype(np.float32)
    variables = to_np(jax.jit(JVD.init)({"params": jax.random.PRNGKey(0),
                                "noise": jax.random.PRNGKey(1)}, x))
    noise, want = JaxVideoNoise(lambda v, k, x: JVD.apply(v, x, rngs={"noise": k}),
                                output=True)(variables, jax.random.PRNGKey(5), x)
    port = MoCoGANVideoDiscriminator(3, image_size=RES, num_t_paddings=ntp)
    port.load_state_dict(jax_to_torch_discriminator(variables))
    with torch.no_grad():
        got = port(ncdhw(x), noise)
    assert noise.next == len(noise.arrays) == 4
    assert_close(got, want, FP32_TOL)
    with pytest.raises(ValueError, match="noise source"):
        port(ncdhw(x))


def test_video_discriminator_rejects_a_collapsed_time_axis():
    """3 frames at num_t_paddings=0: the JAX module's assertion, as a ValueError."""
    port = MoCoGANVideoDiscriminator(3, image_size=RES, use_noise=False,
                                     generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="collapsed the time axis"):
        port(torch.zeros(2, 3, 3, RES, RES))


@pytest.mark.parametrize("intermediate", [True, False])
def test_multiscale_video_discriminator_matches_jax(intermediate):
    JD = jmoco.VideoDiscriminator(num_input_channels=3, num_sub_discrs=2, n_layers=3,
                                  get_intermediate_feat=intermediate)
    x = np.random.RandomState(1).randn(2, 8, 32, 32, 3).astype(np.float32)
    variables = to_np(jax.jit(JD.init)(jax.random.PRNGKey(0), x))
    want = jax.jit(JD.apply)(variables, x)
    port = VideoDiscriminator(3, num_sub_discrs=2, n_layers=3,
                              get_intermediate_feat=intermediate)
    port.load_state_dict(jax_to_torch_discriminator(variables))
    with torch.no_grad():
        got = port(ncdhw(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        pairs = zip(g, w) if intermediate else [(g, w)]
        if intermediate:
            assert len(g) == len(w) == 3 + 2
        for gf, wf in pairs:
            assert_close(gf, np.moveaxis(np.asarray(wf), -1, 1), FP32_TOL)


def jax_mocogan(seed=1):
    """tests/test_mocogan.py's MoCoGAN D at 64^2 and its variables."""
    JD = jmoco.MoCoGANDiscriminator(MDCFG, video_discr_num_t_paddings=NTP)
    img = np.zeros((B * F, RES, RES, 3), np.float32)
    t = np.zeros((B, F), np.float32)
    variables = to_np(jax.jit(JD.init)({"params": jax.random.PRNGKey(seed),
                               "noise": jax.random.PRNGKey(2)}, img, None, t))
    return JD, variables


def port_mocogan(variables=None):
    D = MoCoGANDiscriminator(port_cfg(MDCFG), video_discr_num_t_paddings=NTP)
    if variables is not None:
        D.load_state_dict(jax_to_torch_discriminator(variables))
    return D


def test_mocogan_discriminator_matches_jax():
    JD, variables = jax_mocogan()
    img = np.random.RandomState(2).randn(B * F, RES, RES, 3).astype(np.float32)
    t = np.asarray([[0.0, 1.0, 2.0], [0.0, 2.0, 4.0], [1.0, 3.0, 5.0], [0.0, 4.0, 8.0]],
                   np.float32)
    noise, want = jax_video_noise(JD, output=True)(variables, jax.random.PRNGKey(3), img, t)
    D = port_mocogan(variables)
    assert D.lr_scale_map == {"video_discr": 0.1}
    with torch.no_grad():
        got = D(nchw(img), None, torch.from_numpy(t), noise=noise)
    assert got["image_logits"].shape == (B * F,) and got["video_logits"].shape[0] == B
    for k in ("image_logits", "video_logits"):
        assert_close(got[k], want[k], FP32_TOL)


def test_lstm_generator_matches_jax():
    """configs/model/mocogan.yaml's G: the LSTM trajectory, the 2-layer motion
    mapping (fourier off), the const input and concat_w."""
    cfg = small_gen_cfg(**LSTM)
    z, t, mz = inputs(cfg, B=2, seed=4)
    JG = JGenerator(cfg)
    variables = to_np(jax.jit(JG.init)({"params": jax.random.PRNGKey(1)}, z, None, t,
                                       motion_z=mz))
    assert set(variables["params"]["synthesis"]["motion_encoder"]["rnn"]) == \
        {"OptimizedLSTMCell_0"}
    want = jax.jit(JG.apply)(variables, z, None, t, motion_z=mz)
    G = Generator(port_cfg(cfg))
    G.load_state_dict(jax_to_torch_generator(variables))
    with torch.no_grad():
        got = G(torch.from_numpy(z), None, torch.from_numpy(t), motion_z=torch.from_numpy(mz))
    assert_close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)), FP32_TOL)
    # drawn from a torch.Generator, never from the global RNG
    torch.manual_seed(0)
    a = Generator(port_cfg(cfg), generator=torch.Generator().manual_seed(9)).state_dict()
    torch.manual_seed(1)
    b = Generator(port_cfg(cfg), generator=torch.Generator().manual_seed(9)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    bound = 1 / np.sqrt(cfg.motion.z_dim)
    rnn = [v for k, v in a.items() if ".rnn." in k]
    assert len(rnn) == 4 and all(float(v.abs().max()) <= bound for v in rnn)


def test_lstm_bridge_inverts_convert_lstm_state():
    """nn.LSTM state -> convert_lstm_state (the JAX package's) -> the bridge:
    the weights back to the bit, flax's summed bias in bias_ih_l0 and zeros in
    bias_hh_l0, and that state converts back to the same flax cell."""
    r = np.random.RandomState(6)
    H, In = 8, 12
    flat = {"weight_ih_l0": r.randn(4 * H, In), "weight_hh_l0": r.randn(4 * H, H),
            "bias_ih_l0": r.randn(4 * H), "bias_hh_l0": r.randn(4 * H)}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    cell = jleg.convert_lstm_state(flat)
    got = jax_to_torch_generator({"params": {"motion_encoder": {"rnn": cell}}})
    pre = "motion_encoder.rnn."
    assert set(got) == {pre + k for k in flat}
    for k in ("weight_ih_l0", "weight_hh_l0"):
        np.testing.assert_array_equal(got[pre + k].numpy(), flat[k])
    np.testing.assert_array_equal(got[pre + "bias_ih_l0"].numpy(),
                                  flat["bias_ih_l0"] + flat["bias_hh_l0"])
    np.testing.assert_array_equal(got[pre + "bias_hh_l0"].numpy(), np.zeros(4 * H, np.float32))
    back = jleg.convert_lstm_state({k[len(pre):]: v.numpy() for k, v in got.items()})
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, cell)


# --------------------------------------------------------------------- step

@pytest.fixture(scope="module")
def jax_moco():
    JG, JD = JGenerator(MGCFG), jmoco.MoCoGANDiscriminator(MDCFG, video_discr_num_t_paddings=NTP)
    tcfg = jts.TrainingConfig(**MTRAIN)
    opt = jts.OptimizerConfig(**OPT)
    state = jts.init_train_state(jax.random.PRNGKey(0), JG, JD, opt, opt, tcfg,
                                 d_lr_scales=JD.lr_scale_map)
    step = jts.make_train_step(JG, JD, jts.LossConfig(**MLOSS), opt, opt, tcfg, donate=False,
                               d_lr_scales=JD.lr_scale_map)
    draws = JaxDraws(JG, {"params": state.params_G, **state.extra_G}, cfg=MGCFG, batch=B,
                     loss=MLOSS)
    # eager: jitted, this G's frames differ from the eager ones by ~1e-4 of scale
    frames = lambda v, z, t, mz: JG.apply(v, z, None, t, motion_z=mz)     # noqa: E731
    return frames, state, step, draws, jax_video_noise(JD)


def moco_batch(seed):
    """test_torch_train.py's make_batch at 64^2."""
    r = np.random.RandomState(seed)
    jbatch, _ = make_batch(seed)
    jbatch["real_img"] = r.randint(0, 255, size=(B, F, RES, RES, 3)).astype(np.uint8)
    tbatch = {k: torch.from_numpy(v) for k, v in jbatch.items()}
    tbatch["real_img"] = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(jbatch["real_img"], -1, 2)))
    return jbatch, tbatch


def moco_port_state(jstate):
    """The port's state and step from the JAX state, Adam's moments (optax's
    multi_transform for D) carried by the bridge."""
    G, D = Generator(port_cfg(MGCFG)), port_mocogan()
    pieces = jax_to_torch_train_state(jstate, G, D)
    G.load_state_dict(pieces["params_G"])
    D.load_state_dict(pieces["params_D"])
    tcfg, opt = tts.TrainingConfig(**MTRAIN), tts.OptimizerConfig(**OPT)
    state = tts.init_train_state(G, D, opt, opt, tcfg, augment_p=pieces["augment_p"])
    state.G_ema.load_state_dict(pieces["params_Gema"])
    state.ada_sign_acc.fill_(pieces["ada_sign_acc"])
    state.step, state.cur_nimg = pieces["step"], pieces["cur_nimg"]
    load_adam_state(state.opt_G, pieces["opt_G"])
    load_adam_state(state.opt_D, pieces["opt_D"])
    step = tts.make_train_step(G, D, tloss_mod.LossConfig(**MLOSS), tcfg)
    return state, step


def moco_draws(jdraws, jnoise, jstate, rng, do_dr1):
    """The JAX step's draws, D's video noise for each D call included (run_D
    folds 99 into its key: stylegan_v_tpu/training/loss.py:121)."""
    draws = jdraws.step(rng, 1, do_gpl=False, do_dr1=do_dr1)
    img, t = jnp.zeros((B * F, RES, RES, 3)), jnp.zeros((B, F))
    for name, keys in jdraws.d_call_keys(rng, 1, do_dr1).items():
        draws.setdefault(name, {})["d_noise"] = [
            jnoise({"params": jstate.params_D}, jax.random.fold_in(k, 99), img, t)
            for k in keys]
    return draws


RUN_SYNTHESIS = tloss_mod.GANLoss.run_synthesis


def pin_frames(monkeypatch, jframes, jstate, jstate_next, jbatch, draws):
    """The port's synthesis hands D the JAX frames' values, with the gradient of
    its own frames, after checking them (test_torch_train.py:pin): Gmain's
    from G before the step, Dgen's from G after Gmain's update, which is
    jstate_next's without Gpl. D's leaky-ReLU kinks would otherwise turn the
    frames' float differences into gradient jumps (test_torch_train.py's
    docstring); the LSTM's frames differ from JAX's by a little more than
    the conv trajectory's."""
    want = []
    for params, d, p in ((jstate.params_G, draws["Gmain"], 0),
                         (jstate_next.params_G, draws["Dgen"], 2)):
        img = jframes({"params": params, **jstate.extra_G}, d["z"].numpy(),
                      jbatch["gen_t"][:, p], d["motion_z"].numpy())
        want.append(nchw(img))
    def pinned(self, *args, **kw):
        img = RUN_SYNTHESIS(self, *args, **kw)
        jimg = want.pop(0)
        assert_tree_close({"img": img}, {"img": jimg}, what="frames ")
        return img + (jimg - img).detach()

    monkeypatch.setattr(tloss_mod.GANLoss, "run_synthesis", pinned)
    return want


def through_the_video_d(name):
    """The parameters whose moments are held at VIDEO_TOL: the video D's own,
    and G's synthesis, whose Gmain gradient runs back through the video D.
    The image D's gradient never crosses the video D (Dmain's losses add the
    two logits' terms; R1 reads the image logits alone). G's mapping crosses
    it behind the synthesis, but its moments stay within TOL of G's scale
    (3.1e-6 in these steps)."""
    return name.startswith(("video_discr.", "synthesis."))


def assert_moments_close(opt, jopt, module, convert, what):
    """Adam's exp_avg and exp_avg_sq, group by group, against optax's, each
    entry within a tolerance times the group's largest magnitude: VIDEO_TOL
    for the parameters `through_the_video_d`, TOL for the rest."""
    want = jax_to_torch_adam(jopt, module, convert)
    names = [n for n, _ in module.named_parameters()]
    state = opt.state_dict()
    for g, group in enumerate(state["param_groups"]):
        for key in ("exp_avg", "exp_avg_sq"):
            w = {i: numpy(want[i][key]) for i in group["params"]}
            scale = max(max(float(np.abs(v).max()) for v in w.values()), 1e-6)
            for i, v in w.items():
                tol = VIDEO_TOL if through_the_video_d(names[i]) else TOL
                err = float(np.abs(numpy(state["state"][i][key]) - v).max())
                assert err <= tol * scale, (f"{what} group {g} {key} {names[i]}: max abs err "
                                            f"{err:.3g} > {tol} * {scale:.3g}")
        assert {float(state["state"][i]["step"]) for i in group["params"]} == \
            {float(want[group["params"][0]]["step"])}


def test_jax_moves_its_own_video_d_gradient_at_a_kink():
    """VIDEO_TOL's basis, JAX against itself: the gradient of the step's
    video D (64^2, 4 videos of 3 frames, num_t_paddings 6) jumps where a
    leaky ReLU's input, just after a batch norm, crosses zero. Real frames
    moved by 1e-5 of themselves (seeds 10 and 11) moved the gradient of
    mean(softplus(-logits)) with respect to the parameters by 8.6e-3 and
    6.6e-3 of its largest magnitude, and with respect to the frames, which
    G's synthesis receives, by 3.4e-2 and 3.7e-2, on the CPU. So no
    tolerance under ~1e-2 holds two computations of it whose inputs differ
    by float rounding; VIDEO_TOL holds these, and in the step test the
    port's moments differ from JAX's by up to 1.5e-3 of scale."""
    JVD = jmoco.MoCoGANVideoDiscriminator(n_channels=3, image_size=RES, num_t_paddings=NTP)
    x = (np.random.RandomState(0).randint(0, 255, size=(B, F, RES, RES, 3)) / 127.5
         - 1).astype(np.float32)
    variables = to_np(jax.jit(JVD.init)({"params": jax.random.PRNGKey(0),
                                         "noise": jax.random.PRNGKey(1)}, x))
    key = jax.random.PRNGKey(5)
    grad = jax.jit(jax.grad(lambda p, x: jnp.mean(jax.nn.softplus(
        -JVD.apply({"params": p}, x, rngs={"noise": key}))), argnums=(0, 1)))

    def move(a, b):
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        return (max(float(jnp.abs(u - v).max()) for u, v in zip(la, lb))
                / max(float(jnp.abs(u).max()) for u in la))

    base = grad(variables["params"], x)
    moves = []
    for seed in (10, 11):
        xp = (x * (1 + 1e-5 * np.random.RandomState(seed).randn(*x.shape))).astype(np.float32)
        moved = grad(variables["params"], xp)
        moves.append((move(base[0], moved[0]), move(base[1], moved[1])))
    params = [m[0] for m in moves]
    assert TOL < min(params) and max(params) < VIDEO_TOL, moves


def test_two_mocogan_steps_match_jax(jax_moco, monkeypatch):
    """Two steps with every D phase (Dmain, Dr1), each from the JAX state
    before it; the video branch at 0.1 of the image branch's learning rate.
    D's input from G takes the JAX frames' values (`pin_frames`)."""
    jframes, jstate, jstep, jdraws, jnoise = jax_moco
    for i in range(2):
        jbatch, tbatch = moco_batch(30 + i)
        rng = jax.random.PRNGKey(200 + i)
        state, step = moco_port_state(jstate)
        draws = moco_draws(jdraws, jnoise, jstate, rng, do_dr1=True)
        jnext, jstats = jstep(jstate, jbatch, rng, do_gpl=False, do_dr1=True)
        left = pin_frames(monkeypatch, jframes, jstate, jnext, jbatch, draws)
        jstate = jnext
        state, stats = step(state, tbatch, do_dr1=True, draws=draws)
        assert not left
        assert {"Loss/G/loss_video", "Loss/scores/fake_video",
                "Loss/scores/real_video"} <= set(stats)
        assert_stats_close(stats, jstats)
        assert_state_close(state, jstate)
        assert len(state.opt_D.param_groups) == 2 and len(state.opt_G.param_groups) == 1
        assert_moments_close(state.opt_D, jstate.opt_D, state.D, jax_to_torch_discriminator,
                             "opt_D")
        assert_moments_close(state.opt_G, jstate.opt_G, state.G, jax_to_torch_generator,
                             "opt_G")
        lrs = [g["lr"] for g in state.opt_D.param_groups]
        ratio = MTRAIN["D_reg_interval"] / (MTRAIN["D_reg_interval"] + 1)
        assert lrs == [OPT["lr"] * ratio, OPT["lr"] * ratio * 0.1]
        assert all(n.startswith("video_discr.") == (g == 1)
                   for g, group in enumerate(state.opt_D.param_groups)
                   for n, p in state.D.named_parameters()
                   if any(p is q for q in group["params"]))
        assert all(d.next == len(d.arrays) for k in draws.values() for d in k["d_noise"])


def port_step_run(lr_scales, seed=0):
    """One Dmain step of the port's MoCoGAN from seeded weights and draws, D's
    Adam built with `lr_scales` ({} for none); returns D's parameters before
    and after, and the state."""
    gen = torch.Generator().manual_seed(seed)
    G = Generator(port_cfg(MGCFG), generator=gen)
    D = MoCoGANDiscriminator(port_cfg(MDCFG), video_discr_num_t_paddings=NTP, generator=gen)
    before = {k: v.clone() for k, v in D.state_dict().items()}
    tcfg, opt = tts.TrainingConfig(**MTRAIN), tts.OptimizerConfig(**OPT)
    state = tts.init_train_state(G, D, opt, opt, tcfg, d_lr_scales=lr_scales)
    step = tts.make_train_step(G, D, tloss_mod.LossConfig(**MLOSS), tcfg)
    state, _ = step(state, moco_batch(7)[1], generator=torch.Generator().manual_seed(3))
    return before, D.state_dict(), state


@pytest.fixture(scope="module")
def split_run():
    """port_step_run with MoCoGAN's 0.1x video group."""
    return port_step_run({"video_discr": 0.1})


def test_the_video_branch_moves_a_tenth_as_far(split_run):
    """Adam's first update is lr * g / (|g| + eps): with the same gradients,
    the 0.1x group moves exactly a tenth as far as without the split, and
    the image branch as far."""
    before, split, _ = split_run
    _, whole, _ = port_step_run({})
    moved = 0
    for k, b in before.items():
        d_split, d_whole = split[k] - b, whole[k] - b
        want = d_whole * (0.1 if k.startswith("video_discr.") else 1.0)
        torch.testing.assert_close(d_split, want, rtol=1e-3, atol=1e-7, msg=k)
        moved += int(k.startswith("video_discr.") and bool(d_whole.abs().max() > 0))
    assert moved > 0


def test_a_snapshot_keeps_both_groups_learning_rates(tmp_path, split_run):
    """A snapshot and its restore keep each group's learning rate; a state
    built without d_lr_scales takes D's lr_scale_map, and {} takes none."""
    _, _, state = split_run
    path = save_snapshot(str(tmp_path), state, cur_nimg=12, configs={})
    payload, _ = load_snapshot(path)
    assert [g["lr"] for g in payload["opt_D"]["param_groups"]] == \
        [g["lr"] for g in state.opt_D.param_groups]
    G, D = Generator(port_cfg(MGCFG)), port_mocogan()
    tcfg, opt = tts.TrainingConfig(**MTRAIN), tts.OptimizerConfig(**OPT)
    fresh = tts.init_train_state(G, D, opt, opt, tcfg)
    restore_train_state(fresh, payload)
    assert [g["lr"] for g in fresh.opt_D.param_groups] == \
        [g["lr"] for g in state.opt_D.param_groups]
    got, want = fresh.opt_D.state_dict()["state"], state.opt_D.state_dict()["state"]
    assert all(torch.equal(got[i][k], want[i][k]) for i in want for k in want[i])
    plain = tts.init_train_state(G, D, opt, opt, tcfg, d_lr_scales={})
    assert [g["lr"] for g in plain.opt_D.param_groups] == [state.opt_D.param_groups[0]["lr"]]


# --------------------------------------------------------------------- loop

# the entry point's model=mocogan at narrow widths, 3 frames a clip
LOOP_ARGS = ["model=mocogan", "sampling.num_frames_per_video=3", "dataset.max_num_frames=16",
             f"model.discriminator.video_discr_num_t_paddings={NTP}",
             "model.discriminator.channel_max=16", "model.generator.fmaps=0.03125",
             "model.generator.channel_max=16", "model.generator.w_dim=32",
             "model.generator.z_dim=32", "model.generator.motion.z_dim=16",
             "model.generator.motion.v_dim=16", "training.batch_size=4",
             "training.kimg_per_tick=0.012", "training.snap=2", "training.metrics=[]",
             "training.num_workers=1", "--device", "cpu"]


def test_mocogan_trains_and_resumes_through_the_entry_point(tmp_path, monkeypatch):
    """Two ticks of one step and a snapshot, then resume=latest for one more:
    the resumed optimizer keeps the 0.1x group, and stats.jsonl holds both
    logit streams. The setup's kimg (an int in the config) is cut to steps."""
    zip_path = build_video_dataset_zip(str(tmp_path), num_videos=4, frames_per_video=16,
                                       res=RES)
    setup_training = tsetup.setup_training
    kimg = {}

    def short(*args, **kw):
        return dataclasses.replace(setup_training(*args, **kw), total_kimg=kimg["kimg"])

    monkeypatch.setattr(tsetup, "setup_training", short)
    run = tmp_path / "run"
    args = LOOP_ARGS + [f"dataset.path={zip_path}", f"project_release_dir={run}"]
    kimg["kimg"] = 0.024
    first = ttrain.main(args)
    kimg["kimg"] = 0.036
    second = ttrain.main(args + ["training.resume=latest"])
    assert (first["state"].step, second["start_step"], second["state"].step) == (2, 2, 3)
    for state in (first["state"], second["state"]):
        assert isinstance(state.D, MoCoGANDiscriminator)
        assert state.G.cfg.motion.gen_strategy == "autoregressive"
        lrs = [g["lr"] for g in state.opt_D.param_groups]
        assert len(lrs) == 2 and lrs[1] == pytest.approx(0.1 * lrs[0], rel=1e-12)
    rows = [json.loads(line) for line in open(run / "stats.jsonl")]
    assert len(rows) == 3
    for row in rows:
        assert {"Loss/G/loss_video", "Loss/scores/fake_video", "Loss/scores/real_video",
                "Loss/scores/fake", "Loss/scores/real"} <= set(row)
        assert all(np.isfinite(v["mean"]) for k, v in row.items() if k != "timestamp")
    assert {"network-snapshot-000000.pt", "network-snapshot-000000.meta.json"} <= \
        set(os.listdir(run))


# --------------------------------------------------- sampling and scoring

def lstm_modules(cfg, seed=21):
    gen = torch.Generator().manual_seed(seed)
    G, G_ema = Generator(port_cfg(cfg), generator=gen), Generator(port_cfg(cfg), generator=gen)
    return G.eval(), G_ema.eval()


def test_generate_on_an_lstm_pkl_writes_the_jax_cli_frames(tmp_path, monkeypatch):
    """tests/test_torch_cli.py's frames case on a .pkl whose G has the LSTM."""
    G, G_ema = lstm_modules(small_gen_cfg(**LSTM))
    pkl = write_reference_pickle(str(tmp_path / "lstm.pkl"), G=G, G_ema=G_ema)
    argv = ["--network", pkl, "--num-videos", "2", "--video-len", "5", "--save-as-frames"]
    want, got = [], []
    recording(monkeypatch, jvio, want)
    recording(monkeypatch, tvio, got)
    replaying_motion(monkeypatch)
    jax_cli(monkeypatch, "generate", argv + ["-o", str(tmp_path / "jax")])
    videos = tgen.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 2
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.std() > 0
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
    assert videos.shape == (2, 5, 32, 32, 3)


def test_generator_metrics_take_an_lstm_g(ds_path, monkeypatch):
    """tests/test_torch_metrics.py's generator stats with an LSTM G carried
    by the bridge, JAX's draws replayed."""
    jcfg = small_gen_cfg(img_resolution=16, **LSTM)
    JG = JGenerator(jcfg)
    z, t = np.zeros((1, jcfg.z_dim), np.float32), np.zeros((1, 3), np.float32)
    mz = np.zeros((1, JMotion.required_traj_len(jcfg), jcfg.motion.z_dim), np.float32)
    variables = to_np(jax.jit(JG.init)(jax.random.PRNGKey(3), z, None, t, motion_z=mz))
    r = np.random.RandomState(5)
    variables = jax.tree_util.tree_map(lambda a: (r.randn(*a.shape) * 0.4).astype(a.dtype),
                                       variables)
    G = Generator(port_cfg(jcfg))
    G.load_state_dict(jax_to_torch_generator(variables))
    for mod in (jmu, tmu):
        monkeypatch.setitem(mod._custom_detectors, "pixels", pixels)
    kw = dict(capture_all=True, max_items=3, temporal_detector=True, num_video_frames=4,
              subsample_factor=2, batch_size=8, seed=2)
    want = jmu.compute_feature_stats_for_generator(
        jmu.MetricOptions(G=JG, G_variables=variables, dataset_kwargs=dataset_kwargs(ds_path)),
        "pixels", {}, **kw).get_all()
    got = tmu.compute_feature_stats_for_generator(
        tmu.MetricOptions(G=G, dataset_kwargs=dataset_kwargs(ds_path), device="cpu"),
        "pixels", {}, draws=JaxGenDraws(seed=2), **kw).get_all()
    assert got.shape == want.shape == (3, 4 * 16 * 16 * 3)
    assert_frames_agree(got, want)


def test_the_frame_split_takes_an_lstm_g(monkeypatch):
    """Two ranks of the (data x frame) grid, run one after the other in this
    process with the gather played by hand: each rank synthesises its frames
    from every video's whole trajectory, and rank 0's gathered grid equals
    one process's frames."""
    cfg = small_gen_cfg(**LSTM)
    _, G = lstm_modules(cfg)
    V, T = 2, 6
    r = np.random.RandomState(8)
    z = r.randn(V, cfg.z_dim).astype(np.float32)
    ts = np.tile(np.arange(T, dtype=np.float32)[None] * 2, (V, 1))
    mz = r.randn(V, JMotion.required_traj_len(cfg, float(ts.max())),
                 cfg.motion.z_dim).astype(np.float32)
    whole = sharded_eval.sharded_generate_frames(G, z, None, ts, mz, frame_shards=1)
    blocks = {}

    def all_gather(out, block):
        blocks.setdefault("rank1", block)
        out[0].copy_(block)
        out[1].copy_(blocks["rank1"])

    monkeypatch.setattr(sharded_eval.dist, "all_gather", all_gather)
    assert sharded_eval.sharded_generate_frames(
        G, z, None, ts, mz, frame_shards=2, world=World(1, 2, "gloo")) is None
    got = sharded_eval.sharded_generate_frames(G, z, None, ts, mz, frame_shards=2,
                                               world=World(0, 2, "gloo"))
    assert got.shape == whole.shape == (V, T, 32, 32, 3)
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-5)
