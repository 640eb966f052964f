"""The port's training step against the JAX package's with accumulation
rounds (batch_chip) and from Adam moments carried through the bridge, on the
CPU: the second half of test_torch_train.py, whose docstring gives the
tolerances and how the JAX draws are replayed, and whose helpers these tests
use.
"""
import jax

from stylegan_v_tpu.training import train_step as jts
from stylegan_v_tpu_torch.io import jax_to_torch_train_state, load_adam_state
from test_torch_train import (GPL_TOL, LOSS, OPT, TRAIN, assert_state_close, assert_stats_close,
                              jax_side, make_batch, one_torch_thread, port_state, run_steps)

__all__ = ["jax_side", "one_torch_thread"]        # fixtures shared with test_torch_train.py


def test_batch_chip_rounds_match_jax(jax_side):
    """batch_chip=2: two accumulation rounds per phase, w_avg and pl_mean carried
    from round to round, as the JAX package's scan does."""
    for state, stats, jstate, jstats in run_steps(jax_side, 2, [(True, True)]):
        assert_stats_close(stats, jstats, GPL_TOL)
        assert_state_close(state, jstate)


def test_batch_chip_rounds_with_augment_match_jax(jax_side):
    """batch_chip=2 with the bgc pipe: each round's D calls take that round's
    augment keys."""
    for state, stats, jstate, jstats in run_steps(jax_side, 2, [(True, True)], augment=True):
        assert_stats_close(stats, jstats, GPL_TOL)
        assert_state_close(state, jstate)


def test_adam_moments_through_the_bridge_match_jax(jax_side):
    """Two JAX steps, then the bridge carries the whole state, Adam's moments
    (optax mu, nu, count -> torch exp_avg, exp_avg_sq, step) included, into
    the port, whose next step is held to JAX's third. Without the moments the
    port's Adam would restart its bias correction and its averages."""
    JG, JD, jstate, jdraws = jax_side
    tcfg = jts.TrainingConfig(**TRAIN)
    opt = jts.OptimizerConfig(**OPT)
    jstep = jts.make_train_step(JG, JD, jts.LossConfig(**LOSS), opt, opt, tcfg, donate=False)
    plan = [(False, False)] * 3          # one compiled JAX step
    for i, (do_gpl, do_dr1) in enumerate(plan[:2]):
        jbatch, _ = make_batch(20 + i)
        jstate, _ = jstep(jstate, jbatch, jax.random.PRNGKey(100 + i), do_gpl=do_gpl,
                          do_dr1=do_dr1)
    state, step = port_state(jstate)
    pieces = jax_to_torch_train_state(jstate, state.G, state.D)
    for opt_t, name in ((state.opt_G, "opt_G"), (state.opt_D, "opt_D")):
        assert len(pieces[name]) == len(opt_t.param_groups[0]["params"])
        assert {float(s["step"]) for s in pieces[name].values()} == {2.0}
        load_adam_state(opt_t, pieces[name])
    do_gpl, do_dr1 = plan[2]
    jbatch, tbatch = make_batch(22)
    rng = jax.random.PRNGKey(102)
    jstate, jstats = jstep(jstate, jbatch, rng, do_gpl=do_gpl, do_dr1=do_dr1)
    state, stats = step(state, tbatch, do_gpl=do_gpl, do_dr1=do_dr1,
                        draws=jdraws.step(rng, 1, do_gpl))
    assert_stats_close(stats, jstats)
    assert_state_close(state, jstate)
    assert {float(s["step"]) for s in state.opt_D.state_dict()["state"].values()} == {3.0}
