"""The numbers that decide `correct`, each held to the limit in
`limits/<cell>.json`; a number without a limit there is printed, not judged.

Training: two spans of steps, each against the reference's from the same
state, batches and draws: the program's three set-up steps from the seed,
and (names with the prefix w_) the window's first R1 step and the main step
after it, from the program's state there. A gap of norms is |program's
norm - reference's norm| over the reference's norm (of the leaf, or of its
network's median leaf where that is larger, for a worst leaf).
  loss0_gap      the relative gap of the span's first G loss, the one loss
                 before any optimizer step of the span;
  grad_gap       the median over G's leaves of the gap of their Gmain
                 gradients in the span's first step, before any update;
  d_grad_gap     the same over D's leaves for its Dmain gradient (after G's
                 update);
  r1_grad_gap    the same for D's Dr1 gradient (after D's Dmain update);
  w_main_grad_gap, w_main_d_grad_gap
                 the same for the window's main step (Gmain, Dmain);
  change_gap     the worst leaf's gap of its change over the span, per
                 network (G, D, G_ema). A leaf whose reference gradients of
                 the span's first step (G's for a G_ema leaf) are under a
                 thousandth of its network's median leaf's moves under Adam
                 by round-off alone and is left out (`moved_leaves`).
  Printed beside them: loss_gap (every loss of the span), the *_worst
  leaves of each gradient and change_median; and every number that
  limits/<cell>.json does not name. Adam's first steps move each weight by about lr times the
  sign of its gradient, so a rounding difference in a gradient near 0 flips
  a whole step: what follows an update is noisy, and the worst leaf of a
  gradient is a bias whose sum cancels. PERF.md gives the readings.
Synthesis (the window's kept uint8 frames against the reference's):
  frames_mean_gap  the mean absolute difference in 8-bit levels over every
                   pixel of the kept batches;
  frames_max_gap   (printed) the largest absolute difference in levels.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Tuple

SMALL_GRAD = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys: Iterable[str]) -> Tuple[float, str]:
    keys = list(keys)
    if not keys:
        return math.inf, "no leaf"
    if set(keys) - set(prog):
        return math.inf, "leaf missing from the program"
    median = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}
    bad = [k for k, g in gaps.items() if not math.isfinite(g)]
    if bad:
        return math.inf, bad[0]
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def _median_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    """The median over the leaves of the relative gap of their norms (a
    steadier reading than the worst leaf, printed beside it)."""
    keys = [k for k in keys if k in prog]
    if not keys:
        return math.inf
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], 1e-30) for k in keys)


def _network(key: str) -> str:
    return key.split(".", 1)[0]


def _losses_gap(prog, ref, steps) -> Tuple[float, str]:
    worst, at = 0.0, ""
    if len(prog) != len(ref):
        return math.inf, "steps missing"
    for i in steps:
        for k, rv in ref[i].items():
            gap = abs(prog[i].get(k, math.nan) - rv) / max(abs(rv), 1e-12)
            if not math.isfinite(gap):
                return math.inf, f"step {i} {k}"
            if gap > worst:
                worst, at = gap, f"step {i} {k}"
    return worst, at


def _worst(parts) -> Tuple[float, str]:
    worst, at = 0.0, ""
    for gap, where in parts:
        if gap > worst or not math.isfinite(gap):
            worst, at = gap, where
            if not math.isfinite(gap):
                break
    return worst, at


def train_numbers(prog: Dict, ref: Dict, prefix: str = "", main: bool = False
                  ) -> Dict[str, Dict]:
    """{name: {"value", ...}} for one span of training steps (Probe's
    readings): the first step's gradients, with `main` the second step's
    too, and the change over the span. Names take `prefix`."""
    pl, rl = prog["losses"], ref["losses"]
    loss0 = _losses_gap([{"Loss/G/loss": s.get("Loss/G/loss", math.nan)} for s in pl[:1]],
                        [{"Loss/G/loss": s["Loss/G/loss"]} for s in rl[:1]], [0])
    loss_all = _losses_gap(pl, rl, range(len(rl)))
    pg, rg = prog["grads"], ref["grads"]
    out = {"loss0_gap": {"value": loss0[0], "at": loss0[1]},
           "loss_gap": {"value": loss_all[0], "at": loss_all[1]}}
    read = [("grad", 0, "Gmain"), ("d_grad", 0, "Dmain"), ("r1_grad", 0, "Dr1")]
    if main:
        read += [("main_grad", 1, "Gmain"), ("main_d_grad", 1, "Dmain")]
    for name, step, phase in read:
        got = pg[step].get(phase) if step < len(pg) else None
        want = rg[step][phase]
        if got is None:
            out[f"{name}_gap"] = {"value": math.inf, "at": f"no {phase} gradient"}
            out[f"{name}_worst"] = {"value": math.inf}
            continue
        worst, at = _leaf_gap(got, want, want)
        out[f"{name}_gap"] = {"value": _median_gap(got, want, want)}
        out[f"{name}_worst"] = {"value": worst, "at": at}
    kept, left_out = moved_leaves(ref)
    change = _worst(_leaf_gap(prog["change_norms"], ref["change_norms"],
                              [k for k in kept if _network(k) == net])
                    for net in ("G", "D", "G_ema"))
    out["change_gap"] = {"value": change[0], "at": change[1], "leaves": len(kept),
                         "left_out": left_out}
    out["change_median"] = {"value": _median_gap(prog["change_norms"], ref["change_norms"], kept)}
    return {prefix + k: v for k, v in out.items()}


def moved_leaves(ref: Dict) -> Tuple[list, list]:
    """The leaves whose change is compared, and those left out: a leaf whose
    reference gradients of the span's first step (G's for a G_ema leaf) are
    under SMALL_GRAD of its network's median leaf's moves under Adam by
    round-off alone."""
    first = ref["grads"][0]
    scale = {"G": first["Gmain"],
             "D": {k: max(first["Dmain"][k], first.get("Dr1", {}).get(k, 0.0))
                   for k in first["Dmain"]}}
    median = {net: statistics.median(v.values()) for net, v in scale.items()}
    kept, left_out = [], []
    for k in ref["change_norms"]:
        own = k.replace("G_ema.", "G.", 1)
        net = _network(own)
        (kept if scale[net][own] >= SMALL_GRAD * median[net] else left_out).append(k)
    return kept, left_out


def frames_numbers(pairs) -> Dict[str, Dict]:
    """pairs: (program uint8 frames, reference uint8 frames) of each kept batch."""
    total, count, worst = 0.0, 0, 0.0
    for p, r in pairs:
        if p.shape != r.shape:
            return {"frames_mean_gap": {"value": math.inf}, "frames_max_gap": {"value": math.inf}}
        d = (p.int() - r.int()).abs()
        total += float(d.sum())
        count += d.numel()
        worst = max(worst, float(d.max()))
    mean = total / count if count else math.inf
    return {"frames_mean_gap": {"value": mean, "batches": len(pairs)},
            "frames_max_gap": {"value": worst if count else math.inf}}


def judge(numbers: Dict[str, Dict], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """correct, and each compared number beside its limit."""
    shown, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = numbers.get(name, {}).get("value", math.inf)
        passed = math.isfinite(value) and value <= limit
        ok = ok and passed
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
