"""Summary of quality-demo runs, side by side: the FVD series and the training
telemetry that explains it.

    python -m stylegan_v_tpu_torch.tools.fvd_demo_report runs/fvd_demo_torch runs/fvd_demo_r5

For each run directory (train_fvd_demo's, of either package: both write the
same metric-fvd2048_16f.jsonl and stats.jsonl): the FVD's peak, minimum and
final snapshot with final/peak and min/peak, in training and in each
backfill's metric-fvd2048_16f.seed<N>.jsonl beside it; the range of D's mean
real and fake scores over the ticks after tick 16; the ADA p at a few ticks;
the median ms a step of each step variant and the median seconds a tick that
wrote no snapshot (stats.jsonl timestamps; a tick wrote one when a metric
row's timestamp falls in it). Reads json only.
"""
from __future__ import annotations

import argparse
import json
import os
from statistics import median
from typing import Dict, List, Optional

METRIC = "fvd2048_16f"
P_TICKS = (1, 8, 16, 24, 32, 48)
AFTER_TICK = 16


def read_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def fvd_summary(path: str) -> Dict:
    """Peak, minimum and final (kimg, FVD) of a metric jsonl, with final/peak
    and min/peak; the last row of a snapshot wins (a backfill's --force
    appends)."""
    series = {}
    for r in read_jsonl(path):
        kimg = int(r["snapshot"].rsplit("-", 1)[1].split(".")[0])
        series[kimg] = float(r["results"][METRIC])
    kimgs = sorted(series)
    peak, low = max(kimgs, key=series.get), min(kimgs, key=series.get)
    return dict(snapshots=len(kimgs), first_kimg=kimgs[0], last_kimg=kimgs[-1],
                peak=(peak, series[peak]), min=(low, series[low]),
                final=(kimgs[-1], series[kimgs[-1]]),
                final_over_peak=series[peak] / series[kimgs[-1]],
                min_over_peak=series[peak] / series[low])


def summary(run_dir: str) -> Dict:
    """The report's numbers for one run directory: its in-training series and
    the telemetry, and under `seeds` each metric-fvd2048_16f.seed<N>.jsonl's."""
    stats = read_jsonl(os.path.join(run_dir, "stats.jsonl"))
    metric_path = os.path.join(run_dir, f"metric-{METRIC}.jsonl")
    late = stats[AFTER_TICK:]

    def means(key, rows_):
        return [r[key]["mean"] for r in rows_ if key in r]

    times = [r["timestamp"] for r in stats]
    # a tick's seconds end at its own row; the ticks that wrote a snapshot
    # hold its metric row's timestamp
    snapped = [r["timestamp"] for r in read_jsonl(metric_path)]
    plain_ticks = [b - a for a, b in zip(times, times[1:])
                   if not any(a < t <= b for t in snapped)]
    prefix = f"metric-{METRIC}.seed"
    seeds = {int(n[len(prefix):-len(".jsonl")]): fvd_summary(os.path.join(run_dir, n))
             for n in sorted(os.listdir(run_dir))
             if n.startswith(prefix) and n.endswith(".jsonl")}
    return dict(
        fvd_summary(metric_path), seeds=seeds,
        ticks=len(stats),
        d_real=(min(means("Loss/scores/real", late)), max(means("Loss/scores/real", late))),
        d_fake=(min(means("Loss/scores/fake", late)), max(means("Loss/scores/fake", late))),
        p={t: stats[t - 1]["Progress/augment_p"]["mean"] for t in P_TICKS + (len(stats),)
           if t <= len(stats)},
        p_range=(min(means("Progress/augment_p", stats)), max(means("Progress/augment_p", stats))),
        step_ms={k.split("/", 1)[1]: 1e3 * median(means(k, stats[1:] or stats))
                 for k in sorted({k for r in stats for k in r if k.startswith("Timing/Gmain")})},
        sec_per_tick=median(plain_ticks) if plain_ticks else None,
    )


def report(run_dir: str) -> str:
    s = summary(run_dir)

    def fvd(name, f):
        kimg_value = lambda kv: f"{kv[1]:.4g} at {kv[0]} kimg"    # noqa: E731
        return (f"  {name}: peak {kimg_value(f['peak'])}, min {kimg_value(f['min'])}, final "
                f"{kimg_value(f['final'])}; final/peak {f['final_over_peak']:.2f}x, min/peak "
                f"{f['min_over_peak']:.2f}x")

    return "\n".join([
        f"{run_dir}: {s['snapshots']} snapshots, {s['first_kimg']}..{s['last_kimg']} kimg, "
        f"{s['ticks']} ticks",
        fvd("FVD in training", s)] + [fvd(f"FVD rescored, detector seed {n}", f)
                                      for n, f in s["seeds"].items()] + [
        f"  after tick {AFTER_TICK}: Dreal {s['d_real'][0]:.3f}..{s['d_real'][1]:.3f}, Dfake "
        f"{s['d_fake'][0]:.3f}..{s['d_fake'][1]:.3f}",
        "  ADA p at tick " + ", ".join(f"{t}: {p:.3f}" for t, p in s["p"].items())
        + f"; range {s['p_range'][0]:.3f}..{s['p_range'][1]:.3f}",
        "  median ms a step: " + ", ".join(f"{k} {v:.1f}" for k, v in s["step_ms"].items())
        + (f"; median s a tick without a snapshot {s['sec_per_tick']:.1f}"
           if s["sec_per_tick"] is not None else ""),
    ])


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dirs", nargs="+")
    args = ap.parse_args(argv)
    for d in args.run_dirs:
        print(report(d))


if __name__ == "__main__":
    main()
