"""The "train" mix: the program's training step, driven as its loop drives it.

Set-up builds ONE state, the program's `train_step` with G, D, G_ema, both
Adams and the ADA pipe (`make_train_step` over the configuration composed
by the program's entry-point code), makes the weights on the device from the
seed, and runs the first three steps through the same call and feed as the
window: step 0 with R1 (the loop's rule, step % 16 == 0), then two main
steps, each on its own batch. That same state goes on into the window.

The window is whole R1 intervals: from step 3, runs of 16 consecutive steps,
each holding exactly one R1 step, so R1 is 1/16 of the steps as in training.
After each interval the host synchronises; the window ends at the last
interval boundary that fits into `seconds`, judged by the longest interval
so far (the first interval always runs). train_frames_per_s is every frame
of those intervals over their whole time.

What the check compares (`check`), each side read by a Probe:
  set-up  steps 0-2 from the seed: each step's losses, every leaf's
          gradient as each optimizer step of step 0 gets it (G's Gmain, D's
          Dmain and Dr1) and every leaf's change over the three steps;
  window  the window's first R1 step (step 16) and the main step after it:
          the state at the R1 step's start is copied to pinned host memory
          (no sync), the two steps' losses and gradient norms stay on the
          device until the window has closed, and the leaves after the main
          step are copied too. The reference starts from that copy of the
          program's state, with the same batches and draws.
After the window (and the traced interval of a `--trace 1` run) the
program's state is freed and the reference (`reference/step.py`) runs both.

The module is one mix of the harness's interface (README.md): `Program`,
`run_program`, `checked_output`, `check`, `work`, `FAULTS`, `CHIPS`.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import torch

from .traffic import TrainFeed, subseed
from .weights import init_from_seed

CHIPS = (1,)
LOSS_KEYS = ("Loss/G/loss", "Loss/D/loss", "Loss/D/reg")
CHECKED_STEPS = 3
WINDOW_STEPS = 2           # the window's first R1 step and the main step after it


def _named_leaves(G, D, G_ema) -> Dict[str, torch.Tensor]:
    out = {f"G.{n}": p for n, p in G.named_parameters()}
    out.update({f"D.{n}": p for n, p in D.named_parameters()})
    out.update({f"G_ema.{n}": p for n, p in G_ema.named_parameters()})
    return out


def _state_tensors(G, D, G_ema, opts: Dict[str, object], scalars: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Every tensor of a trainer's state by name: the three networks'
    parameters and buffers, each Adam's per-leaf state and the scalars."""
    out = {}
    for net, m in (("G", G), ("D", D), ("G_ema", G_ema)):
        out.update({f"{net}.{k}": v for k, v in m.state_dict().items()})
    leaves = _named_leaves(G, D, G_ema)
    names = {id(p): k for k, p in leaves.items()}
    for label, opt in opts.items():
        for p, st in opt.state.items():
            out.update({f"{label}:{names[id(p)]}:{k}": v for k, v in st.items()
                        if isinstance(v, torch.Tensor)})
    out.update(scalars)
    return out


def _program_state_tensors(st) -> Dict[str, torch.Tensor]:
    return _state_tensors(st.G, st.D, st.G_ema, {"opt_G": st.opt_G, "opt_D": st.opt_D},
                          {"augment_p": st.augment_p, "ada_sign_acc": st.ada_sign_acc})


class HostCopy:
    """Pinned host memory for a fixed set of named device tensors, one flat
    buffer a dtype, allocated once; `take` queues the copies on the current
    stream and returns without waiting for them."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        pin = any(t.is_cuda for t in tensors.values())
        sizes: Dict[torch.dtype, int] = {}
        for t in tensors.values():
            sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
        flat = {dt: torch.empty(n, dtype=dt, pin_memory=pin) for dt, n in sizes.items()}
        offset = dict.fromkeys(sizes, 0)
        self.views = {}
        for k, t in tensors.items():
            o = offset[t.dtype]
            self.views[k] = flat[t.dtype][o:o + t.numel()].view(t.shape)
            offset[t.dtype] = o + t.numel()

    def take(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if set(tensors) != set(self.views):
            raise RuntimeError("the state's tensors changed between set-up and the window")
        for k, t in tensors.items():
            self.views[k].copy_(t.detach(), non_blocking=True)
        return self.views


def _norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The norm of each tensor, on their device, without waiting for it."""
    return torch.stack([n.float() for n in torch._foreach_norm([t.detach() for t in tensors])])


class Probe:
    """What the check reads of `steps` consecutive steps of a trainer, keyed
    by leaf name, kept on the device until `readings`: each step's losses;
    the norm of every leaf's gradient as each optimizer step gets it (a step
    pre-hook: G's Gmain gradient, then D's Dmain and, on an R1 step, Dr1);
    with `change`, the norm of every leaf's change over the steps."""

    def __init__(self, leaves: Dict[str, torch.Tensor], optimizers: Dict[str, object],
                 steps: int, change: bool = True):
        self.leaves, self.steps = leaves, steps
        self.start = {k: p.detach().clone() for k, p in leaves.items()} if change else None
        self.index = 0
        self.losses: List[Dict[str, torch.Tensor]] = []
        self.grads: List[Dict[str, torch.Tensor]] = [{} for _ in range(steps)]
        self.change: Optional[torch.Tensor] = None
        names = {id(p): k for k, p in leaves.items()}
        self.order = {}
        self._hooks = []
        for label, opt in optimizers.items():
            params = [(names[id(p)], p) for g in opt.param_groups for p in g["params"]]
            self.order[label] = [k for k, _ in params]
            self._hooks.append(opt.register_step_pre_hook(self._reader(label, params)))

    def _reader(self, label: str, params):
        phases = {"G": ["Gmain"], "D": ["Dmain", "Dr1"]}[label]

        def hook(opt, args, kwargs):
            if self.index >= self.steps:
                return
            got = self.grads[self.index]
            taken = sum(1 for k in got if k in phases)
            grads = [p.grad if p.grad is not None else torch.full_like(p, math.nan)
                     for _, p in params]
            got[phases[min(taken, len(phases) - 1)]] = _norms(grads)
        return hook

    def after_step(self, stats: Dict) -> None:
        self.losses.append({k: stats[k].detach().float().reshape(()) for k in LOSS_KEYS
                            if k in stats})
        self.index += 1
        if self.index == self.steps:
            if self.start is not None:
                keys = list(self.leaves)
                self.change = _norms([self.leaves[k] - self.start[k] for k in keys])
                self.start = None
            for h in self._hooks:
                h.remove()

    def readings(self, change_norms: Optional[Dict[str, float]] = None) -> Dict:
        """Plain numbers; `change_norms` where the change was not taken here."""
        label = {"Gmain": "G", "Dmain": "D", "Dr1": "D"}
        grads = [{ph: dict(zip(self.order[label[ph]], v.tolist())) for ph, v in step.items()}
                 for step in self.grads]
        if change_norms is None and self.change is not None:
            change_norms = dict(zip(self.leaves, self.change.tolist()))
        return {"losses": [{k: float(v) for k, v in step.items()} for step in self.losses],
                "grads": grads, "change_norms": change_norms or {}}


def _change_norms(start: Dict[str, torch.Tensor], end: Dict[str, torch.Tensor],
                  device: torch.device) -> Dict[str, float]:
    keys = list(end)
    return dict(zip(keys, _norms([end[k].to(device) - start[k].to(device)
                                  for k in keys]).tolist()))


class Program:
    """The program's state and step for a cell, with its feed. The window's
    check: the state before step `probe_at` (the first R1 step after set-up)
    and the leaves after the main step that follows are copied to host
    memory, and a Probe reads those two steps."""

    def __init__(self, setup, plain: Dict, cell: Dict, seed: int, device: torch.device):
        from stylegan_v_tpu_torch.models import Generator
        from stylegan_v_tpu_torch.training import (init_train_state, make_augment_pipe,
                                                   make_train_step)
        from stylegan_v_tpu_torch.training.loop import build_discriminator
        traffic, clip = cell["traffic"], cell["config"]["clip"]
        G = Generator(setup.gen_cfg).to(device)
        D = build_discriminator(setup, None).to(device)
        init_from_seed([G, D], subseed(seed, "weights"))
        self.state = init_train_state(G, D, setup.opt_g, setup.opt_d, setup.train_cfg,
                                      augment_p=traffic["augment_p"])
        pipe = make_augment_pipe(setup.augment_cfg) if setup.augment_cfg else None
        self.step_fn = make_train_step(G, D, setup.loss_cfg, setup.train_cfg, augment_fn=pipe,
                                       allow_tf32=setup.allow_tf32)
        self.feed = TrainFeed(traffic, clip, plain["gen_cfg"], seed, device, pipe is not None,
                              plain["disc_source"] == "mocogan")
        self.device = device
        self.interval = int(setup.train_cfg.D_reg_interval)
        self.probe_at = -(-CHECKED_STEPS // self.interval) * self.interval
        self.frames_per_step = self.feed.videos * self.feed.frames
        self.step_index = 0
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.window_probe: Optional[Probe] = None
        self.copies: Optional[Dict[str, HostCopy]] = None
        self.start_state = self.end_leaves = None

    def leaves(self) -> Dict[str, torch.Tensor]:
        st = self.state
        return _named_leaves(st.G, st.D, st.G_ema)

    def optimizers(self) -> Dict[str, object]:
        return {"G": self.state.opt_G, "D": self.state.opt_D}

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        return _program_state_tensors(self.state)

    def prepare_window_check(self) -> None:
        """Allocate the host copies (set-up work, before the window)."""
        self.copies = {"start": HostCopy(self.state_tensors()),
                       "end": HostCopy(self.leaves())}

    def _before(self, s: int) -> None:
        if s == self.probe_at and self.copies is not None:
            self.start_state = {"tensors": self.copies["start"].take(self.state_tensors()),
                                "step": self.state.step, "cur_nimg": self.state.cur_nimg}
            self.window_probe = Probe(self.leaves(), self.optimizers(), WINDOW_STEPS,
                                      change=False)

    def _after(self, s: int, stats: Dict) -> None:
        if self.window_probe is not None and self.window_probe.index < WINDOW_STEPS:
            self.window_probe.after_step(stats)
            if self.window_probe.index == WINDOW_STEPS:
                self.end_leaves = self.copies["end"].take(self.leaves())

    def step(self, card=None, r1_events=None) -> Dict:
        s = self.step_index
        do_dr1 = s % self.interval == 0
        self._before(s)
        start = card.event() if (do_dr1 and r1_events is not None) else None
        self.state, stats = self.step_fn(self.state, self.feed.batch(s),
                                         draws=self.feed.draws(s, do_dr1), do_dr1=do_dr1)
        if start is not None:
            r1_events.append((start, card.event()))
        self.bad += (~torch.isfinite(stats["Loss/G/loss"] + stats["Loss/D/loss"])).long()
        self._after(s, stats)
        self.step_index += 1
        return stats

    def window_readings(self) -> Dict:
        """The window probe's readings, with the state it started from;
        call once its copies have landed (after a sync)."""
        if self.end_leaves is None:
            return {}
        start = self.start_state["tensors"]
        change = _change_norms({k: start[k] for k in self.end_leaves}, self.end_leaves,
                               self.device)
        return dict(self.window_probe.readings(change), start=self.start_state,
                    step=self.probe_at)


def setup_steps(prog: Program) -> Dict:
    """The first three steps of the program's state, with what the check reads."""
    probe = Probe(prog.leaves(), prog.optimizers(), CHECKED_STEPS)
    for _ in range(CHECKED_STEPS):
        probe.after_step(prog.step())
    return probe.readings()


def checked_output(prog: Program, card, log) -> Dict:
    """What the check reads of the program without a timed window: the
    set-up steps, then steps up to the end of the window's probe."""
    out = {"setup": setup_steps(prog)}
    prog.prepare_window_check()
    while prog.step_index < prog.probe_at + WINDOW_STEPS:
        prog.step()
    card.sync()
    out["window"] = prog.window_readings()
    return out


def run_program(prog: Program, card, seconds: float, trace: bool, log) -> Dict:
    """Set-up's checked steps, then the window; returns the program's side."""
    out = {"setup": setup_steps(prog)}
    prog.prepare_window_check()
    card.sync()
    setup_peak = card.peak_bytes()
    log(f"set-up steps done; losses {out['setup']['losses']}")

    card.reset_peak()
    r1_events, durations = [], []
    t0 = time.perf_counter()
    while True:
        ti = time.perf_counter()
        for _ in range(prog.interval):
            prog.step(card, r1_events)
        card.sync()
        durations.append(time.perf_counter() - ti)
        if time.perf_counter() - t0 + max(durations) > seconds:
            break
    window_s = sum(durations)
    window_peak = card.peak_bytes()
    steps = len(durations) * prog.interval
    out.update(window_t0=t0, interval=prog.interval, window_s=window_s,
               intervals=len(durations), steps=steps, attempted=steps,
               frames=steps * prog.frames_per_step, interval_s=durations,
               r1_ms=[card.elapsed_ms(a, b) for a, b in r1_events],
               setup_peak=setup_peak, window_peak=window_peak,
               window=prog.window_readings())
    log(f"window: {len(durations)} intervals of {prog.interval} steps in {window_s:.3f} s; "
        f"interval s {[round(d, 3) for d in durations]}")
    if trace:
        from .trace import traced

        def one_interval():
            for _ in range(prog.interval):
                prog.step()
        out["trace"] = traced(one_interval, card.sync)
        out["traced_units"] = prog.interval
    out["failed"] = int(prog.bad)
    return out


def _reference_trainer(plain: Dict, cell: Dict, seed: int, device: torch.device):
    from ..reference import build_models
    from ..reference.step import Trainer
    G, D = build_models(plain, device)
    init_from_seed([G, D], subseed(seed, "weights"))
    tr = Trainer(G, D, plain["loss_cfg"], plain["train_cfg"], plain["opt_g"], plain["opt_d"],
                 plain["augment_cfg"], cell["traffic"]["augment_p"])
    feed = TrainFeed(cell["traffic"], cell["config"]["clip"], plain["gen_cfg"], seed, device,
                     plain["augment_cfg"] is not None, plain["disc_source"] == "mocogan")
    return tr, feed


@torch.no_grad()
def _load_state(tr, start: Dict, device: torch.device) -> None:
    """Put the program's state at the window probe's start into the
    reference trainer: the networks, each Adam's per-leaf state, the ADA
    scalars and the step counters."""
    t = start["tensors"]
    for net, m in (("G", tr.G), ("D", tr.D), ("G_ema", tr.G_ema)):
        m.load_state_dict({k.split(".", 1)[1]: v for k, v in t.items()
                           if k.split(".", 1)[0] == net and ":" not in k})
    leaves = _named_leaves(tr.G, tr.D, tr.G_ema)
    for label, opt in (("opt_G", tr.opt_G), ("opt_D", tr.opt_D)):
        opt.state.clear()
        for k, v in t.items():
            if k.startswith(label + ":"):
                _, leaf, key = k.split(":")
                p = leaves[leaf]
                val = v.clone() if key == "step" else v.to(device, copy=True)
                opt.state.setdefault(p, {})[key] = val
    tr.augment_p = t["augment_p"].to(device, copy=True)
    tr.ada_sign_acc = t["ada_sign_acc"].to(device, copy=True)
    tr.step_index, tr.cur_nimg = start["step"], start["cur_nimg"]


def run_reference(plain: Dict, cell: Dict, seed: int, device: torch.device,
                  window: Optional[Dict] = None, allow_tf32: bool = False) -> Dict:
    """The reference's set-up steps from the seed and, given the program's
    window readings, its two window steps from the program's state there,
    on the same batches and draws; TF32 as asked (off: the configuration's
    precision; on: the control)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    interval = plain["train_cfg"]["D_reg_interval"]
    out = {}
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = allow_tf32
        spans = [("setup", 0, CHECKED_STEPS)]
        if window:
            spans.append(("window", window["step"], WINDOW_STEPS))
        for name, first, steps in spans:
            tr, feed = _reference_trainer(plain, cell, seed, device)
            if name == "window":
                _load_state(tr, window["start"], device)
            probe = Probe(_named_leaves(tr.G, tr.D, tr.G_ema), {"G": tr.opt_G, "D": tr.opt_D},
                          steps)
            for i in range(first, first + steps):
                probe.after_step(tr.step(feed.batch(i), feed.draws(i, i % interval == 0),
                                         i % interval == 0))
            out[name] = probe.readings()
            del tr, feed, probe
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    return out


def check(plain: Dict, cell: Dict, seed: int, device: torch.device, out: Dict,
          control: bool = False) -> Dict[str, Dict]:
    """The numbers compared for `correct`: the program's readings in `out`
    against the reference's; with `control`, the reference with TF32
    allowed, in the program's place, against the reference."""
    from .checks import train_numbers
    window = out.get("window")
    ref = run_reference(plain, cell, seed, device, window)
    prog = (run_reference(plain, cell, seed, device, window, allow_tf32=True) if control
            else out)
    numbers = train_numbers(prog["setup"], ref["setup"])
    if window:
        numbers.update(train_numbers(prog["window"], ref["window"], prefix="w_", main=True))
    else:
        numbers["w_loss0_gap"] = {"value": math.inf, "at": "no window step was read"}
    return numbers


def work(plain: Dict, cell: Dict, out: Dict) -> Dict[str, float]:
    """FLOPs of the window, and FIR bytes of the traced interval."""
    from ..count import work as W
    w = W.train_work(plain, cell["config"]["clip"]["videos_per_chip"])
    per_interval = (out["interval"] - 1) * w["main_flops"] + w["r1_flops"]
    return dict(w, window_flops=out["intervals"] * per_interval,
                traced_fir_bytes=(out["interval"] - 1) * w["main_fir_bytes"]
                + w["r1_fir_bytes"])


# ------------------------------------------------ faults, for the checks' own tests

class UnchangedProgram(Program):
    """The step returns its state unchanged, from step `from_step` on: every
    tensor of the state and the optimizers' per-leaf state are put back as
    they were (the gradients are still taken)."""
    from_step = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        inner = self.step_fn

        def step_fn(state, batch, draws, do_dr1):
            if self.step_index < self.from_step:
                return inner(state, batch, draws=draws, do_dr1=do_dr1)
            tensors = _program_state_tensors(state)
            saved = {k: t.detach().clone() for k, t in tensors.items()}
            had = {id(opt): set(opt.state) for opt in (state.opt_G, state.opt_D)}
            _, stats = inner(state, batch, draws=draws, do_dr1=do_dr1)
            for opt in (state.opt_G, state.opt_D):
                for p in [p for p in opt.state if p not in had[id(opt)]]:
                    del opt.state[p]
            with torch.no_grad():
                for k, t in tensors.items():
                    t.copy_(saved[k])
            return state, stats
        self.step_fn = step_fn


class LateUnchangedProgram(UnchangedProgram):
    """The same from the first step after set-up: a fault that only the
    window's check can see."""
    from_step = CHECKED_STEPS


def _half(x):
    if isinstance(x, torch.Tensor):
        return x[:x.shape[0] // 2]
    if isinstance(x, dict):
        return {k: _half(v) for k, v in x.items()}
    return x


class HalfBatchProgram(Program):
    """The step leaves out half of the batch and takes its means over the rest."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        inner = self.step_fn
        self.step_fn = lambda state, batch, draws, do_dr1: inner(
            state, _half(batch), draws=_half(draws), do_dr1=do_dr1)


FAULTS = {"unchanged": UnchangedProgram, "late_unchanged": LateUnchangedProgram,
          "half_batch": HalfBatchProgram}
