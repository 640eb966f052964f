"""Parity of the PyTorch port's loss phases and training step against the JAX
package, on CPU, at test_torch_models.py's small configs. The step with
accumulation rounds and from bridged Adam moments is held in
test_torch_train_rounds.py, over several ranks in test_torch_parallel.py;
both use the helpers here.

The JAX state comes from its own init_train_state and crosses to the port
through stylegan_v_tpu_torch.io.bridge.jax_to_torch_train_state. The JAX
package draws z, motion trajectories, Gpl's noise and the style-mixing
cutoffs inside; the tests replay its key splits (train_step.py:259-262,
:289, :310; loss.py:74-80, :142-147) and read each motion trajectory back
from the synthesis it fed (`capture_intermediates`), then hand every draw
to the port explicitly.

Tolerances, float32 throughout. Each compared tree (a network's gradient,
its parameters, a set of stats) is held to TOL = 1e-4 times its scale, the
largest magnitude in the JAX package's tree (at least 1 for stats, which are
O(1) losses and scores). Two things make that hold:
  * Where G's frames feed D (gmain, dgen), D's input takes the JAX frames'
    values (`pin`: the port's frames plus the detached difference, so the
    gradient still runs through the port's G). The frames themselves agree
    to ~4e-6 of their scale, but at that distance a few of D's leaky-ReLU
    pre-activations lie on the other side of zero, and the slope jump (1 to
    0.2) moves single gradient elements by up to ~1e-3 of their scale. JAX
    does the same to itself: a move of z by 1e-6 of its size moved JAX's own
    gradients that much on this config.
  * Gpl's loss is itself a gradient of G, so its value and gradients jump at
    G's own kinks, which no pin can reach: a 1e-6 relative move of z moved
    JAX's own gpl loss by 5.3e-4 of its value, and the port's gradients
    differed from JAX's by up to 1.3e-3 of scale across the seeds tried, a
    few such jumps. Gpl's loss and gradients are held to GPL_TOL = 5e-3 of
    scale, above them and far below what a wrong scale, layout or sum would
    give (order 1). The same kinks inside G move Gmain's gradients by up to
    0.8 * TOL across seeds; Gmain stays at TOL.
  * With the ADA pipe (bgc, warp_upsample=2, from augment_p = 0.5 so that
    the transforms fire), the JAX pipe's keys are replayed into the port's
    (test_torch_augment.py:JaxKeyDraws). The pipe is linear in the frames
    for given draws, so it adds no kink of its own; in the loss phases D's
    input after the augment takes the JAX values (`pin_augment`, as `pin`
    does for the frames), and the augment's output is held to TOL on its
    own. The whole step is held as without the pipe.
  * Parameters after a step pass through Adam, whose update
    lr * g / (|g| + eps) is a sign for |g| >> eps: a gradient element within
    float noise of zero could move by +lr on one side and -lr on the other.
    Both sides therefore run Adam with eps = 1e-3 (OPT): the update is then
    Lipschitz in g, with constant lr / eps, and parameters agree about as
    well as gradients do.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylegan_v_tpu.models import Discriminator as JDiscriminator
from stylegan_v_tpu.models import Generator as JGenerator
from stylegan_v_tpu.training import augment as jaug
from stylegan_v_tpu.training import loss as jloss_mod
from stylegan_v_tpu.training import train_step as jts
from stylegan_v_tpu_torch.io import (jax_to_torch_discriminator, jax_to_torch_generator,
                                     jax_to_torch_train_state)
from stylegan_v_tpu_torch.models import Discriminator, Generator
from stylegan_v_tpu_torch.parallel import World
from stylegan_v_tpu_torch.training import augment as taug
from stylegan_v_tpu_torch.training import loss as tloss_mod
from stylegan_v_tpu_torch.training import train_step as tts
from test_torch_augment import JaxKeyDraws
from test_torch_models import port_cfg, small_disc_cfg, small_gen_cfg, to_np

TOL = 1e-4
GPL_TOL = 5e-3
B, F, RES = 4, 3, 32
GCFG, DCFG = small_gen_cfg(), small_disc_cfg()
LOSS = dict(r1_gamma=1.0, pl_weight=2.0, style_mixing_prob=0.9)
OPT = dict(lr=0.0025, eps=1e-3)
TRAIN = dict(batch_size=B, ema_kimg=1.0, ada_target=0.6, ada_interval=1,
             G_reg_interval=4, D_reg_interval=4)
AUG = dict(jaug.AUGPIPE_SPECS["bgc"], warp_upsample=2, warp_mode="gather")
AUG_P = 0.5


def augment_pipes(warp_mode="gather"):
    """The JAX package's bgc pipe and the port's, with the gather warp (or
    `warp_mode`'s executor)."""
    kw = dict(AUG, warp_mode=warp_mode)
    return (jaug.make_augment_pipe(jaug.AugmentConfig(**kw)),
            taug.make_augment_pipe(taug.AugmentConfig(**kw)))


def numpy(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree_close(got, want, tol=TOL, what="", min_scale=1e-6):
    """Every entry of got within tol * scale of want's; scale = want's largest magnitude."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    want = {k: np.asarray(numpy(v), dtype=np.float32) for k, v in want.items()}
    scale = max(max(float(np.abs(v).max()) for v in want.values()), min_scale)
    for k, w in want.items():
        g = numpy(got[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        assert np.isfinite(g).all(), (what, k)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what}{k}: max abs err {err:.3g} > {tol} * scale {scale:.3g}"


def assert_stats_close(got, want, tol=TOL):
    assert_tree_close(got, {k: np.asarray(v) for k, v in want.items()}, tol, "stats ",
                      min_scale=1.0)


def nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def make_batch(seed):
    """tests/test_train_step.py:make_batch, in both layouts."""
    r = np.random.RandomState(seed)
    t = np.sort(r.randint(0, 60, size=(B, F)).astype(np.float32), axis=1)
    t += np.arange(F)[None] * 0.1
    jbatch = {"real_img": r.randint(0, 255, size=(B, F, RES, RES, 3)).astype(np.uint8),
              "real_c": np.zeros((B, 0), np.float32), "real_t": t,
              "gen_c": np.zeros((B, 3, 0), np.float32),
              "gen_t": np.stack([t + i for i in range(3)], axis=1).astype(np.float32)}
    tbatch = {k: torch.from_numpy(v) for k, v in jbatch.items()}
    tbatch["real_img"] = nchw(jbatch["real_img"])
    return jbatch, tbatch


# ------------------------------------------------------------ the JAX draws

class JaxDraws:
    """Replays the JAX package's random draws, to hand them to the port: for
    G's config `cfg` (GCFG by default), a step of `batch` videos (the module's
    B when the draws are made, by default) and the loss settings `loss` (LOSS)."""

    def __init__(self, G, vars_G, cfg=GCFG, batch=None, loss=LOSS):
        self.G, self.vars_G = G, vars_G
        self.cfg, self._batch, self.loss = cfg, batch, loss
        self.frames, self.res = cfg.sampling.num_frames_per_video, cfg.img_resolution
        self.num_ws = G.apply(vars_G, jnp.zeros((1, cfg.z_dim)), None,
                              method=lambda g, z, c: g.mapping(z, c)).shape[1]
        self._motion_z = jax.jit(self._capture_motion_z, static_argnums=2)

    @property
    def batch(self):
        return B if self._batch is None else self._batch

    def _capture_motion_z(self, vars_G, k_syn, n):
        def call(g, ws, t):
            return g.synthesis(ws, t=t, c=None)
        rngs = {"motion": jax.random.fold_in(k_syn, 1), "noise": jax.random.fold_in(k_syn, 2)}
        _, inter = self.G.apply(vars_G, jnp.zeros((n, self.num_ws, self.cfg.w_dim)),
                                jnp.zeros((n, self.frames)), method=call, rngs=rngs,
                                capture_intermediates=True, mutable=["intermediates"])
        return inter["intermediates"]["synthesis"]["motion_encoder"]["__call__"][0]["motion_z"]

    def motion_z(self, k_syn, n):
        """The trajectories synthesis draws with run_synthesis's rngs (loss.py:88)."""
        return np.array(self._motion_z(self.vars_G, k_syn, n))

    def mix(self, k_mix, n):
        """run_mapping's style-mixing draws (loss.py:74-79)."""
        k_cut, k_prob, k_z = jax.random.split(k_mix, 3)
        cutoff = jax.random.randint(k_cut, (), 1, self.num_ws)
        cutoff = jnp.where(jax.random.uniform(k_prob) < self.loss["style_mixing_prob"],
                           cutoff, self.num_ws)
        return int(cutoff), np.array(jax.random.normal(k_z, (n, self.cfg.z_dim)))

    def phase(self, rng, n, with_noise=False):
        """One phase call's draws from its rng: motion_z, mix, pl_noise (NCHW)."""
        k_mix, k_syn, k_third = jax.random.split(rng, 3)
        d = {"motion_z": self.motion_z(k_syn, n)}
        d["mix_cutoff"], d["mix_z"] = self.mix(k_mix, n)
        if with_noise:
            d["pl_noise"] = nchw(jax.random.normal(k_third, (n * self.frames, self.res,
                                                              self.res, 3)))
        return d

    def step(self, rng, rounds, do_gpl, augment=False, do_dr1=False):
        """All draws of train_step(state, batch, rng), as the port's `draws`."""
        keys = jax.random.split(rng, 8)
        mb = self.batch // rounds
        bsz = mb // self.loss.get("pl_batch_shrink", 2)

        def gather(z_key, round_rng, n, with_noise=False):
            per_round = [self.phase(round_rng(r * mb), n, with_noise) for r in range(rounds)]
            d = {k: torch.cat([torch.as_tensor(np.array(p[k])) for p in per_round])
                 for k in ("motion_z", "mix_z") + (("pl_noise",) if with_noise else ())}
            d["mix_cutoff"] = torch.tensor([p["mix_cutoff"] for p in per_round])
            d["z"] = torch.from_numpy(np.array(jax.random.normal(
                z_key, (self.batch, self.cfg.z_dim))))
            return d

        draws = {
            "Gmain": gather(keys[0], lambda i: jax.random.fold_in(keys[1], i), mb),
            "Dgen": gather(keys[4], lambda i: jax.random.fold_in(
                jax.random.fold_in(keys[5], i), 0), mb)}
        if do_gpl:
            draws["Gpl"] = gather(keys[2], lambda i: jax.random.fold_in(keys[3], i), bsz,
                                  with_noise=True)
        if augment:
            for name, ks in self.d_call_keys(rng, rounds, do_dr1).items():
                draws.setdefault(name, {})["augment"] = [JaxKeyDraws(k) for k in ks]
        return draws

    def d_call_keys(self, rng, rounds, do_dr1):
        """The key each D call of train_step(state, batch, rng) hands run_D,
        by phase, a list of one per round (train_step.py:268,317,320,345;
        loss.py:120,162): the augment's key, from which D's noise is folded."""
        keys, fold = jax.random.split(rng, 8), jax.random.fold_in
        mb = self.batch // rounds

        def per_round(key_of):
            return [key_of(r * mb) for r in range(rounds)]

        out = {"Gmain": per_round(lambda i: jax.random.split(fold(keys[1], i), 3)[2]),
               "Dgen": per_round(lambda i: jax.random.split(fold(fold(keys[5], i), 0), 3)[2]),
               "Dreal": per_round(lambda i: fold(fold(keys[5], i), 1))}
        if do_dr1:
            out["Dr1"] = per_round(lambda i: fold(keys[7], i))
        return out


# ------------------------------------------------------------------ fixtures

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops in one thread while a module's tests run: the test
    processes run side by side (pytest-xdist), and torch's threads on every
    core would wait on each other. Results are compared within one setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side():
    JG, JD = JGenerator(GCFG), JDiscriminator(DCFG)
    tcfg = jts.TrainingConfig(**TRAIN)
    opt = jts.OptimizerConfig(**OPT)
    state = jts.init_train_state(jax.random.PRNGKey(0), JG, JD, opt, opt, tcfg)
    vars_G = {"params": state.params_G, **state.extra_G}
    return JG, JD, state, JaxDraws(JG, vars_G)


def port_state(jstate, batch_chip=None, augment_fn=None):
    """The port's state and step from the JAX state (Adam's moments are zero
    on both sides)."""
    pieces = jax_to_torch_train_state(jstate)
    G, D = Generator(port_cfg(GCFG)), Discriminator(port_cfg(DCFG))
    G.load_state_dict(pieces["params_G"])
    D.load_state_dict(pieces["params_D"])
    tcfg = tts.TrainingConfig(**TRAIN, batch_chip=batch_chip)
    opt = tts.OptimizerConfig(**OPT)
    state = tts.init_train_state(G, D, opt, opt, tcfg, augment_p=pieces["augment_p"])
    state.G_ema.load_state_dict(pieces["params_Gema"])
    state.pl_mean.fill_(pieces["pl_mean"])
    state.ada_sign_acc.fill_(pieces["ada_sign_acc"])
    state.step, state.cur_nimg = pieces["step"], pieces["cur_nimg"]
    step = tts.make_train_step(G, D, tloss_mod.LossConfig(**LOSS), tcfg, augment_fn=augment_fn)
    return state, step


def assert_state_close(state, jstate):
    want = jax_to_torch_train_state(jstate)
    assert_tree_close(state.G.state_dict(), want["params_G"], TOL, "G.")
    assert_tree_close(state.D.state_dict(), want["params_D"], TOL, "D.")
    assert_tree_close(state.G_ema.state_dict(), want["params_Gema"], TOL, "G_ema.")
    assert_tree_close({"w_avg": state.G.mapping.w_avg}, {"w_avg": want["w_avg"]})
    assert_tree_close({k: getattr(state, k) for k in ("pl_mean", "augment_p", "ada_sign_acc")},
                      {k: np.float32(want[k]) for k in ("pl_mean", "augment_p", "ada_sign_acc")},
                      what="scalars ", min_scale=1.0)
    assert (state.step, state.cur_nimg) == (want["step"], want["cur_nimg"])


# --------------------------------------------------------------- loss phases

def pin(loss, jimg):
    """Make the port's synthesis hand D the JAX frames' values (see the module
    docstring), with the gradient of the port's frames, and check those frames."""
    run = loss.run_synthesis

    def pinned(*args, **kwargs):
        img = run(*args, **kwargs)
        assert_tree_close({"img": img}, {"img": jimg}, what="frames ")
        return img + (jimg - img).detach()

    loss.run_synthesis = pinned


def pin_augment(loss, jaug_nchw):
    """Make D's input after the port's augment take the JAX pipe's values,
    with the gradient of the port's pipe, and check those values."""
    fn = loss.augment_fn

    def pinned(draws, img, p):
        out = fn(draws, img, p)
        assert_tree_close({"augmented": out}, {"augmented": jaug_nchw}, what="augment ")
        return out + (jaug_nchw - out).detach()

    loss.augment_fn = pinned


def fuse_frames(img):
    """[B*F, H, W, C] -> [B, H, W, F*C], frame major (JAX loss.py:103-105)."""
    img = np.asarray(img)
    n, h, w, ch = img.shape
    return np.moveaxis(img.reshape(n // F, F, h, w, ch), 1, -2).reshape(n // F, h, w, F * ch)


def check_loss_phase(jax_side, phase, augment):
    JG, JD, jstate, jdraws = jax_side
    jpipe, tpipe = augment_pipes() if augment else (None, None)
    jl = jloss_mod.GANLoss(JG, JD, jloss_mod.LossConfig(**LOSS), augment_fn=jpipe)
    state, _ = port_state(jstate)
    tl = tloss_mod.GANLoss(state.G, state.D, tloss_mod.LossConfig(**LOSS), augment_fn=tpipe)
    jbatch, _ = make_batch(7)
    z = np.random.RandomState(8).randn(B, GCFG.z_dim).astype(np.float32)
    t = jbatch["gen_t"][:, 0]
    tz, tt = torch.from_numpy(z), torch.from_numpy(t)
    rng = jax.random.PRNGKey(11)
    p_G, p_D, ap, extra = jstate.params_G, jstate.params_D, jstate.augment_p, jstate.extra_G
    vars_G = {"params": p_G, **extra}
    tol = TOL
    k_mix, k_syn, k_aug = jax.random.split(rng, 3)
    aug = {}
    if augment:
        ap = jnp.float32(AUG_P)
        # run_D's augment key: the third split in gmain and dgen, rng itself in dreal_dr1
        aug_key = rng if phase == "dreal_dr1" else k_aug
        aug = dict(aug_draws=JaxKeyDraws(aug_key), augment_p=torch.tensor(AUG_P))

    def draws(n, with_noise=False):
        d = jdraws.phase(rng, n, with_noise)
        mix = torch.tensor(d["mix_cutoff"]), torch.from_numpy(d["mix_z"])
        return torch.from_numpy(d["motion_z"]), mix, d.get("pl_noise")

    def jax_frames():
        ws, _ = jl.run_mapping(vars_G, z, None, k_mix, update_w_avg=False)
        return np.asarray(jl.run_synthesis(vars_G, ws, t, None, k_syn))

    def pin_d_input(frames):
        """D's input takes the JAX values: the frames', or the augment's of them."""
        if augment:
            pin_augment(tl, nchw(jpipe(aug_key, fuse_frames(frames), ap)))
        if phase != "dreal_dr1":
            pin(tl, nchw(frames))

    if phase == "gmain":
        fn = lambda p: jl.gmain(p, extra, {"params": p_D}, z, None, t, rng, ap)  # noqa: E731
        (jloss, (moving, jstats)), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(p_G)
        pin_d_input(jax_frames())
        motion_z, mix, _ = draws(B)
        loss, stats = tl.gmain(tz, None, tt, motion_z, mix, **aug)
        # the w_avg update runs under autograd, in place, outside the graph
        w_avg = state.G.mapping.w_avg
        assert w_avg.grad_fn is None and not w_avg.requires_grad
        assert_tree_close({"w_avg": w_avg}, {"w_avg": moving["moving"]["mapping"]["w_avg"]})
    elif phase == "gpl":
        fn = lambda p: jl.gpl(p, extra, z, None, t, rng, jnp.float32(0.3))  # noqa: E731
        (jloss, (jpl, jstats)), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(p_G)
        motion_z, mix, pl_noise = draws(B // LOSS.get("pl_batch_shrink", 2), with_noise=True)
        loss, pl, stats = tl.gpl(tz, None, tt, motion_z, pl_noise, torch.tensor(0.3), mix)
        assert_tree_close({"pl_mean": pl}, {"pl_mean": jpl}, min_scale=1.0)
        tol = GPL_TOL
    elif phase == "dgen":
        fn = lambda p: jl.dgen(p, vars_G, {}, z, None, t, rng, ap)  # noqa: E731
        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(p_D)
        pin_d_input(jax_frames())
        motion_z, mix, _ = draws(B)
        loss, stats = tl.dgen(tz, None, tt, motion_z, mix, **aug)
    else:
        img = jbatch["real_img"].reshape(B * F, RES, RES, 3).astype(np.float32) / 127.5 - 1
        fn = lambda p: jl.dreal_dr1(p, {}, img, None, jbatch["real_t"], rng, ap,  # noqa: E731
                                    do_main=True, do_r1=True, r1_gamma=LOSS["r1_gamma"])
        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(fn, has_aux=True))(p_D)
        pin_d_input(img)
        loss, stats = tl.dreal_dr1(nchw(img), None, torch.from_numpy(jbatch["real_t"]),
                                   do_main=True, do_r1=True, r1_gamma=LOSS["r1_gamma"], **aug)

    module = state.G if phase in ("gmain", "gpl") else state.D
    to_port = jax_to_torch_generator if module is state.G else jax_to_torch_discriminator
    loss.backward(inputs=list(module.parameters()))
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in module.named_parameters()}
    assert_stats_close({"loss": loss, **stats}, {"loss": jloss, **jstats}, tol)
    assert_tree_close(got, to_port({"params": to_np(jgrads)}), tol, "grad ")


@pytest.mark.parametrize("phase", ["gmain", "gpl", "dgen", "dreal_dr1"])
def test_loss_phase_matches_jax(jax_side, phase):
    check_loss_phase(jax_side, phase, augment=False)


@pytest.mark.parametrize("phase", ["gmain", "dgen", "dreal_dr1"])
def test_loss_phase_with_augment_matches_jax(jax_side, phase):
    """Gmain, Dgen and Dreal + R1 (R1 through the pipe's double backward) with
    the bgc pipe in front of D, the JAX augment keys replayed."""
    check_loss_phase(jax_side, phase, augment=True)


# ---------------------------------------------------------------- the step

def run_steps(jax_side, batch_chip, plan, augment=False, warp_mode="gather"):
    """Run the JAX step and the port's on the same batches and draws; after
    each step, hold the port's state and stats against the JAX package's.
    With `augment`, both run the bgc pipe from augment_p = AUG_P, with
    `warp_mode`'s warp."""
    JG, JD, jstate, jdraws = jax_side
    tcfg = jts.TrainingConfig(**TRAIN, batch_chip=batch_chip)
    opt = jts.OptimizerConfig(**OPT)
    jpipe, tpipe = augment_pipes(warp_mode) if augment else (None, None)
    if augment:
        jstate = jstate.replace(augment_p=jnp.float32(AUG_P))
    jstep = jts.make_train_step(JG, JD, jts.LossConfig(**LOSS), opt, opt, tcfg,
                                augment_fn=jpipe, donate=False)
    state, step = port_state(jstate, batch_chip, augment_fn=tpipe)
    rounds = B // (batch_chip or B)
    for i, (do_gpl, do_dr1) in enumerate(plan):
        jbatch, tbatch = make_batch(20 + i)
        rng = jax.random.PRNGKey(100 + i)
        jstate, jstats = jstep(jstate, jbatch, rng, do_gpl=do_gpl, do_dr1=do_dr1)
        state, stats = step(state, tbatch, do_gpl=do_gpl, do_dr1=do_dr1,
                            draws=jdraws.step(rng, rounds, do_gpl, augment, do_dr1))
        yield state, stats, jstate, jstats


def test_three_steps_match_jax(jax_side):
    """A step with every phase, then two with the main phases only; the ADA
    controller moves on every step (ada_interval=1)."""
    plan = [(True, True), (False, False), (False, False)]
    for state, stats, jstate, jstats in run_steps(jax_side, None, plan):
        assert_stats_close(stats, jstats, GPL_TOL if "Loss/pl_penalty" in jstats else TOL)
        assert_state_close(state, jstate)
    assert state.step == 3 and float(state.augment_p) > 0


def test_three_steps_with_augment_match_jax(jax_side):
    """The steps of test_three_steps_match_jax with the bgc pipe
    (warp_upsample=2) in front of every D call, from augment_p = 0.5."""
    plan = [(True, True), (False, False), (False, False)]
    for state, stats, jstate, jstats in run_steps(jax_side, None, plan, augment=True):
        assert_stats_close(stats, jstats, GPL_TOL if "Loss/pl_penalty" in jstats else TOL)
        assert_state_close(state, jstate)
    assert state.step == 3 and abs(float(state.augment_p) - AUG_P) < 1e-3


# ----------------------------------------------------------------- port only

def small_port_models(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (Generator(port_cfg(GCFG), generator=gen),
            Discriminator(port_cfg(DCFG), generator=gen))


@pytest.mark.parametrize("augment", [False, True])
def test_steps_drawn_from_a_generator_are_reproducible(augment):
    """Without `draws`, every draw comes from the torch.Generator handed in,
    the augment pipe's too."""
    _, tbatch = make_batch(3)
    results = []
    for _ in range(2):
        G, D = small_port_models()
        tcfg = tts.TrainingConfig(**TRAIN)
        state = tts.init_train_state(G, D, tts.OptimizerConfig(**OPT),
                                     tts.OptimizerConfig(**OPT), tcfg, augment_p=AUG_P)
        step = tts.make_train_step(G, D, tloss_mod.LossConfig(**LOSS), tcfg,
                                   augment_fn=augment_pipes()[1] if augment else None)
        torch.manual_seed(len(results))           # the global RNG must not matter
        state, stats = step(state, tbatch, generator=torch.Generator().manual_seed(5),
                            do_gpl=True, do_dr1=True)
        results.append((state.G.state_dict(), state.D.state_dict(), stats))
    (g1, d1, s1), (g2, d2, s2) = results
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    with pytest.raises(ValueError, match="Generator"):
        step(state, tbatch)


@pytest.mark.parametrize("what", ["d_lr_scales"])
def test_unported_options_raise(what):
    """d_lr_scales, ported with MoCoGAN (ROADMAP P9c; tests/test_torch_mocogan.py
    holds it to the JAX step): D's Adam takes a parameter group per scaled
    child, in D.parameters() order, and a step runs. The step takes D's
    learning rates from the state's groups: a state built without the scales
    (this D carries no lr_scale_map) steps with one group and moves D."""
    G, D = small_port_models()
    lcfg = tloss_mod.LossConfig(**LOSS)
    tcfg = tts.TrainingConfig(**TRAIN)
    scales = {"b4": 0.5}
    opt = tts.OptimizerConfig(**OPT)
    state = tts.init_train_state(G, D, opt, opt, tcfg, d_lr_scales=scales)
    groups = state.opt_D.param_groups
    assert [g["lr"] for g in groups] == [groups[0]["lr"], groups[0]["lr"] * 0.5]
    assert [p for g in groups for p in g["params"]] == list(D.parameters())
    step = tts.make_train_step(G, D, lcfg, tcfg, d_lr_scales=scales)
    _, tbatch = make_batch(3)
    state, stats = step(state, tbatch, generator=torch.Generator().manual_seed(5))
    assert state.step == 1 and all(bool(torch.isfinite(v)) for v in stats.values())
    plain = tts.init_train_state(G, D, opt, opt, tcfg)
    assert [len(g["params"]) for g in plain.opt_D.param_groups] == [len(list(D.parameters()))]
    before = [p.detach().clone() for p in D.parameters()]
    plain, _ = step(plain, tbatch, generator=torch.Generator().manual_seed(5))
    assert plain.step == 1 and any(not torch.equal(a, p) for a, p in zip(before, D.parameters()))


@pytest.mark.parametrize("what", ["augment_shards", "zero1", "mesh"])
def test_options_ported_for_several_ranks_run_a_step(what):
    """The multi-GPU options (ROADMAP P8) run in one process: the augment's
    data_shards is ignored (it only chunked JAX's warp), ZeRO-1 over one rank
    is plain Adam, and the process group that replaced the mesh may be given
    explicitly. tests/test_torch_parallel.py runs them over two ranks."""
    G, D = small_port_models()
    lcfg = tloss_mod.LossConfig(**LOSS)
    tcfg = tts.TrainingConfig(**TRAIN, zero1=(what == "zero1"))
    kw = {"augment_shards": lambda: dict(augment_fn=taug.make_augment_pipe(
              taug.AugmentConfig(**AUG, data_shards=2))),
          "zero1": dict, "mesh": lambda: dict(world=World())}[what]()
    state = tts.init_train_state(G, D, tts.OptimizerConfig(**OPT), tts.OptimizerConfig(**OPT),
                                 tcfg, augment_p=AUG_P, world=kw.get("world"))
    assert type(state.opt_G) is torch.optim.Adam
    step = tts.make_train_step(G, D, lcfg, tcfg, **kw)
    _, tbatch = make_batch(3)
    state, stats = step(state, tbatch, generator=torch.Generator().manual_seed(5))
    assert state.step == 1 and all(bool(torch.isfinite(v)) for v in stats.values())


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_step_runs_without_tf32_unless_asked_and_restores_the_callers_settings(allow_tf32):
    """Inside the step (read by a forward hook on D) TF32 is off for cuDNN's
    convolutions and for matmuls, or on with allow_tf32=True; after a step
    that returns or raises, the caller's settings are back."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    _, tbatch = make_batch(3)
    G, D = small_port_models()
    tcfg = tts.TrainingConfig(**TRAIN)
    state = tts.init_train_state(G, D, tts.OptimizerConfig(**OPT), tts.OptimizerConfig(**OPT),
                                 tcfg)
    step = tts.make_train_step(G, D, tloss_mod.LossConfig(**LOSS), tcfg, allow_tf32=allow_tf32)
    seen = []
    hook = D.register_forward_hook(
        lambda *_: seen.append((cudnn.allow_tf32, matmul.allow_tf32)))
    try:
        for caller in ((True, False), (False, True)):
            cudnn.allow_tf32, matmul.allow_tf32 = caller
            seen.clear()
            step(state, tbatch, generator=torch.Generator().manual_seed(5))
            assert seen and set(seen) == {(allow_tf32, allow_tf32)}
            assert (cudnn.allow_tf32, matmul.allow_tf32) == caller
            with pytest.raises(ValueError, match="Generator"):
                step(state, tbatch)
            assert (cudnn.allow_tf32, matmul.allow_tf32) == caller
    finally:
        hook.remove()
        cudnn.allow_tf32, matmul.allow_tf32 = saved
