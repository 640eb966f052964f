"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--faults N] [--control N]

For each seed, in one process on the card, through the cell's mix module
(lib/<kind>_cell.py, as run.py drives it): the program's checked output
(`checked_output`, the same steps or batches as a run's, without the timed
window) against the reference (`check`), the control against the reference,
and on the first N seeds each of the mix's FAULTS (the control on the
first --control seeds, all by default). The control is the
reference put in the program's place with TF32 allowed in its float32
convolutions and matmuls, the precision just below the configuration's
(float32, TF32 off). Prints one JSON line a seed and, last, the largest
reading of each number for the program and the smallest for the control
and each fault.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seeds, faults: int, device=None, spec_path=None, log=print,
             control: int = None):
    """One row a seed; the first `faults` seeds also read every fault, the
    first `control` seeds (all when None) the control."""
    import torch
    from benchmark.lib import env, spec as speclib

    device = device or torch.device("cuda", 0)
    card = env.Card(device)
    cell = speclib.load_cell(workload, spec_path)
    mix = speclib.load_mix(cell["traffic"]["kind"])
    env.build_kernels(device)
    setup = speclib.compose_setup(cell["config"])
    plain = speclib.plain_setup(setup)
    rows = []
    for n, seed in enumerate(seeds):
        row = {"seed": seed}
        sides = {"program": mix.Program}
        if n < faults:
            sides.update(mix.FAULTS)
        program_out = None
        for name, cls in sides.items():
            prog = cls(setup, plain, cell, seed, device)
            out = mix.checked_output(prog, card, env.log)
            del prog
            card.free()
            row[name] = mix.check(plain, cell, seed, device, out)
            if name == "program":
                program_out = out
        if control is None or n < control:
            row["control"] = mix.check(plain, cell, seed, device, program_out, control=True)
        log(json.dumps(row, default=str))
        rows.append(row)
    return rows


def summary(rows):
    out = {}
    sides = {s for r in rows for s in r} - {"seed"}
    for side in sorted(sides):
        for name in rows[0]["program"]:
            vals = [r[side][name]["value"] for r in rows if side in r]
            out.setdefault(name, {})[side] = max(vals) if side == "program" else min(vals)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", type=int, default=0,
                    help="read the faults on the first this many seeds")
    ap.add_argument("--control", type=int, default=None,
                    help="read the control on the first this many seeds (default: all)")
    args = ap.parse_args(argv)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.faults,
                    control=args.control)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)


if __name__ == "__main__":
    main()
