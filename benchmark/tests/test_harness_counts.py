"""The yardstick's counts against the program at tiny widths on the CPU:
the convolution FLOPs that count/work.py tallies against forward-hook counts
of the program's own modules (2 x output elements x one filter's weights,
chip_smoke.py:conv_flops' rule), and the FIR calls that the reference
records against the calls the program's kernels' wrappers receive."""
from collections import Counter

import pytest
import torch

from helpers import tiny_plain

HOOKED = ("Conv2dLayer", "SynthesisLayer", "ToRGBLayer", "EqLRConv1d", "_Conv3d")


def _hook_flops(module, run):
    total = [0]

    def count(m, _, out):
        if type(m).__name__ in HOOKED:
            total[0] += 2 * out.numel() * m.weight[0].numel()
    handles = [m.register_forward_hook(count) for m in module.modules()]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return total[0]


@pytest.mark.parametrize("config", ["sgv_tiny", "mocogan_tiny"])
def test_forward_conv_flops_match_hook_counts(config):
    from stylegan_v_tpu_torch.models import Generator
    from stylegan_v_tpu_torch.training.loop import build_discriminator
    from benchmark.count import work
    from benchmark.lib.traffic import motion_len
    from benchmark.lib.weights import init_from_seed
    from benchmark.reference import build_models
    cell, setup, plain = tiny_plain(config)
    gcfg = plain["gen_cfg"]
    B, F, R = 2, gcfg["sampling"]["num_frames_per_video"], gcfg["img_resolution"]
    z = torch.randn(B, gcfg["z_dim"])
    t = torch.arange(F, dtype=torch.float32)[None].repeat(B, 1)
    mz = torch.randn(B, motion_len(gcfg), gcfg["motion"]["z_dim"])
    img = torch.randn(B * F, 3, R, R)
    G, D = Generator(setup.gen_cfg), build_discriminator(setup, None)
    init_from_seed([G, D], 1)
    want = _hook_flops(G, lambda: G(z, None, t, motion_z=mz, noise_mode="const"))
    want += _hook_flops(D, lambda: D(img, None, t, **({"noise": _Zeros()}
                                                     if plain["disc_source"] == "mocogan" else {})))
    Gr, Dr = build_models(plain, "meta")
    meta = {"device": "meta"}
    with torch.no_grad(), work._Counter() as counted:
        Gr(torch.empty(B, gcfg["z_dim"], **meta), None, torch.empty(B, F, **meta),
           motion_z=torch.empty(*mz.shape, **meta), noise_mode="const")
        Dr(torch.empty(B * F, 3, R, R, **meta), None, torch.empty(B, F, **meta),
           **({"noise": _MetaZeros()} if plain["disc_source"] == "mocogan" else {}))
    assert counted.by_op["aten.convolution"] == want


class _Zeros:
    def randn(self, shape):
        return torch.zeros(shape)


class _MetaZeros:
    def randn(self, shape):
        return torch.empty(shape, device="meta")


def _program_calls(run):
    """(in_shape, out_shape, dtype) of every FIR call the program's kernel
    wrappers receive (K2's and K1's, forward and adjoint) while run() runs."""
    import importlib
    FK = importlib.import_module("stylegan_v_tpu_torch.ops.fir_kernels")
    U = importlib.import_module("stylegan_v_tpu_torch.ops.upfirdn2d")   # not ops.upfirdn2d()
    calls = []
    saved = U.upfirdn2d_k2, FK.downfirdn2d_x2, FK.downfirdn2d_x2_bwd

    def rec(fn):
        def wrapper(x, *args, **kwargs):
            y = fn(x, *args, **kwargs)
            calls.append((tuple(x.shape), tuple(y.shape), x.dtype))
            return y
        return wrapper
    U.upfirdn2d_k2 = rec(saved[0])
    FK.downfirdn2d_x2, FK.downfirdn2d_x2_bwd = rec(saved[1]), rec(saved[2])
    try:
        run()
    finally:
        U.upfirdn2d_k2, FK.downfirdn2d_x2, FK.downfirdn2d_x2_bwd = saved
    return calls


@pytest.mark.parametrize("config", ["sgv_tiny", "mocogan_tiny"])
def test_fir_calls_match_the_program_over_main_and_r1_steps(config):
    from benchmark.lib.train_cell import Program
    from benchmark.lib.traffic import TrainFeed
    from benchmark.lib.weights import init_from_seed
    from benchmark.reference import build_models
    from benchmark.reference.ops import fir_calls
    from benchmark.reference.step import Trainer
    cell, setup, plain = tiny_plain(config)
    cpu = torch.device("cpu")
    prog = Program(setup, plain, cell, 5, cpu)
    program = _program_calls(lambda: [prog.step() for _ in range(2)])   # R1 step, main step
    G, D = build_models(plain, cpu)
    init_from_seed([G, D], 5)
    tr = Trainer(G, D, plain["loss_cfg"], plain["train_cfg"], plain["opt_g"], plain["opt_d"],
                 plain["augment_cfg"], 0.5)
    feed = TrainFeed(cell["traffic"], cell["config"]["clip"], plain["gen_cfg"], 5, cpu,
                     True, plain["disc_source"] == "mocogan")
    with fir_calls() as calls:
        for s in range(2):
            tr.step(feed.batch(s), feed.draws(s, s == 0), s == 0)
    reference = [(c.in_shape, c.out_shape, c.dtype) for c in calls]
    assert len(program) > 0
    assert Counter(program) == Counter(reference)


def test_work_counts_are_positive_and_r1_adds_work():
    from benchmark.count import work
    _, _, plain = tiny_plain("sgv_tiny")
    w = work.train_work(plain, 4)
    assert 0 < w["main_flops"] < w["r1_flops"]
    assert 0 < w["main_fir_bytes"] < w["r1_fir_bytes"]
    s = work.synth_work(plain, 2, 4)
    assert s["batch_flops"] > 0 and s["batch_fir_bytes"] > 0
