"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (stylegan_v_tpu_torch) on
a machine with an NVIDIA GPU. BENCHMARK.json names the cell's configuration
and traffic; README.md says how a run goes and what it prints.
"""
import time

T0 = time.perf_counter()          # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _reader(metric: str):
    """metrics/<name>.py, else metrics/<name before its first dot>.py."""
    for mod in (metric, metric.split(".")[0]):
        path = os.path.join(ROOT, "benchmark", "metrics", f"{mod}.py")
        if os.path.exists(path):
            return importlib.import_module(f"benchmark.metrics.{mod}").read
    raise SystemExit(f"no reader for metric {metric!r} under benchmark/metrics/")


def _metrics_of(spec, workload: str, trace: bool):
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        spec_path: str = None, program=None) -> dict:
    """One run of a cell; returns the result object. `device` None means the
    first CUDA device, which must exist; the tests pass a CPU device, their
    own spec and, to break the timed path, their own `program` class."""
    import torch
    from benchmark.lib import env, spec as speclib
    from benchmark.lib.checks import judge
    env.T0 = T0
    env.log("torch imported")

    cell = speclib.load_cell(workload, spec_path)
    chips = cell["workload"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"{workload} needs {chips} CUDA device(s); this machine has "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    kind = cell["traffic"]["kind"]
    mix = speclib.load_mix(kind)
    if chips not in mix.CHIPS:
        raise SystemExit(f"the {kind} mix runs on {mix.CHIPS} chip(s), not {chips}")
    card = env.Card(device)
    for k, v in env.describe(device).items():
        print(f"# {k}: {v}", flush=True)
    env.log("card described")
    env.build_kernels(device)
    env.log("kernels built")
    setup = speclib.compose_setup(cell["config"])
    plain = speclib.plain_setup(setup)
    speclib.check_resolved(plain, cell["config"])
    env.log(f"{workload}: {kind} mix, seed {seed}, {seconds} s window, trace {int(trace)}")

    prog = (program or mix.Program)(setup, plain, cell, seed, device)
    env.log("program built, weights drawn")
    out = mix.run_program(prog, card, seconds, trace, env.log)
    setup_s = out["window_t0"] - T0
    memory_peak = max(out["setup_peak"], out["window_peak"])
    del prog
    card.free()
    env.log("window closed, program freed")

    ctx = dict(out, kind=kind, setup_s=setup_s)
    work_cache = {}

    def work():
        if not work_cache:
            work_cache.update(mix.work(plain, cell, out))
        return work_cache
    ctx["work"] = work

    metrics = {}
    for m in _metrics_of(cell["spec"], workload, trace):
        value = _reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers = mix.check(plain, cell, seed, device, out)
    correct, checks = judge(numbers, cell["limits"])
    for name, n in numbers.items():
        env.log(f"check {name}: {n}")

    result = {"correct": bool(correct),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": metrics,
              "device": {"platform": "gpu" if card.cuda else device.type, "kind": card.kind(),
                         "count": chips, "memory_peak_bytes": int(memory_peak)}}
    if trace and out.get("trace"):
        tr = out["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr["top_ops"]],
                               "idle_gaps": [[n, s] for n, s in tr["idle_gaps"]]}
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    args = _parse(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    from benchmark.lib.env import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"[bench] refused: modules of JAX or of the JAX package are loaded: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
