"""Time variants of K2 (csrc/upfirdn2d.cu), this design and an earlier one,
at calls of the ADA step, to see where their time goes.

    python3 -m stylegan_v_tpu_torch.tools.k2_variants [--old CHECKOUT] [--calls 2d|sep|all]
        [--designs new,old]

The 2-D pass (`--calls 2d`), bf16 at 16 videos x 3 frames: D's r = 256
pre-filter [48, 64, 256, 256] -> 257^2, its adjoint 257^2 -> 256^2, and G's
r = 256 up-conv [48, 128, 128, 128] -> 258^2. The separable pass (`--calls
sep`), bf16: the ADA pipe's 12-tap 2x up [16, 9, 268^2] -> 536^2, its 2x
down [16, 9, 524^2] -> 256^2, and their adjoints. Each variant is a copy of
a design's source with one edit, built with the port's nvcc flags (and
-Xptxas -v) into a temporary directory and called through ctypes with the
wrapper's arguments and that design's launches: this design's plans
(k2_plan_2d, k2_plan_sep: one launch a call), and, with --old, those of the
checkout CHECKOUT (e.g. the parent commit unpacked by `git archive`), whose
ops/upfirdn2d_kernel.py plans its own source's launches (there a separable
call is two, a row and a column pass, through an intermediate in device
memory). They run in turns, twice, each timed by CUDA events over 10 calls
that rotate through two copies of the input (each larger than the L2); each
prints its worst error against the plain version (copy_only and sums_only
compute something else) and the registers and spills of the instantiations
the call runs:

  final          the design as it is
  copy_only      the window copies and the stores: no sums
  sums_only      the sums over whatever shared memory holds, and the
                 stores: no copies
  static_filter  the filter's size at compile time: no fh / fw guards (this
                 design's 2-D pass: its 2-D sum of exactly 4x4 taps, instead
                 of rows then columns; the earlier design's separable passes)
  sum2d          (this design, 2-D) the 2-D sum guarded by the filter's size
  stages2        (this design, 2-D) a ring of 2 windows, not 3
  noshift        (this design, separable) no shift of a row's samples into
                 place after its 16-byte loads (bf16)

With --old it then times `final` of both designs as device time: with
`--calls 2d` (or all) at every 2-D call of one forward at 16 x 3 (G's
up-convs and image skips, D's pre-filters, r = 8 ... 256) and at its
adjoint, in the path's dtype, each a CUDA graph of 20 calls replayed in
turns old, new, new, old, three times (the small calls' times in
chip_smoke.py phase 3b also hold the host's launch gaps); with `--calls
sep` (or all) at the separable calls on one input (warm L2), 20 calls each
by CUDA events, in the same turns, at 16 x 9 and at the MoCoGAN step's 8 x
48 channels.

Needs a CUDA device and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import itertools
import shutil
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import torch

from ..ops import cuda_build, setup_filter, upfirdn2d_kernel as k2
from ..ops.upfirdn2d import adjoint_args
from ..training.augment import _SYM6

SOURCE = Path(cuda_build.SOURCES["upfirdn2d"])

NEW_SUMS = "    if (active)\n      sums<T, MODE"
NEW_ISSUE = ("    if (t < pl.tiles) issue_tile<", "    if (nt < pl.tiles) issue_tile<")
SEP_SUMS = ("    row_sums<RX, SEG, FX, UX, DX, PX>(acc, v, k, pl);",
            "    column_sums<T, FY, UY, DY, PY>(acc, mid")
SEP_ISSUE = ("    issue_tile<T>(ring, x,", "      issue_tile<T>(ring + (slot ^ 1)")
OLD_SUMS = "accumulate<T, FY, FX, UY, DY, RY, UX, DX, RX>(acc, s, k, pl);"
OLD_COPY = "  switch (pl.chunk_bytes) {\n    case 16: copy_window"
OLD_GUARDS = ("if (ty < 0 || ty >= FY || ty >= pl.fh) continue;",
              "if (tx < 0 || tx >= FX || tx >= pl.fw) continue;")

# (design, variant): (edits, this design's 2-D sum mode: None for the plan's
# own, the calls it applies to)
VARIANTS = {
    ("new", "final"): ([], None, ("2d", "sep")),
    ("new", "copy_only"): ([(NEW_SUMS, "    if (false)\n      sums<T, MODE")]
                           + [(s, "    if (false)" + s[3:]) for s in SEP_SUMS], None,
                           ("2d", "sep")),
    ("new", "sums_only"): ([(NEW_ISSUE[0], "    if (false) issue_tile<"),
                            (NEW_ISSUE[1], "    if (false) issue_tile<")]
                           + [(s, s.replace("issue_tile<T>(", "if (false) issue_tile<T>("))
                              for s in SEP_ISSUE], None, ("2d", "sep")),
    ("new", "static_filter"): ([], k2.FULL, ("2d",)),
    ("new", "sum2d"): ([], k2.GUARDED, ("2d",)),
    ("new", "stages2"): ([("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")], None,
                         ("2d",)),
    ("new", "noshift"): ([("  const int s = c & 7;", "  const int s = 0;")], None, ("sep",)),
    ("old", "final"): ([], None, ("2d", "sep")),
    ("old", "copy_only"): ([(OLD_SUMS, "if (false) " + OLD_SUMS)], None, ("sep",)),
    ("old", "sums_only"): ([(OLD_COPY, "  if (false) switch (pl.chunk_bytes) {\n    case 16: "
                                       "copy_window")], None, ("sep",)),
    ("old", "static_filter"): ([(OLD_GUARDS[0], "if (ty < 0 || ty >= FY) continue;"),
                                (OLD_GUARDS[1], "if (tx < 0 || tx >= FX) continue;")], None,
                               ("sep",)),
}


def calls(which: str, batch=(16, 9)):
    """(label, x shape, upfirdn2d's (f, up, down, padding, flip, gain)) of
    the 2-D or the separable calls."""
    if which == "2d":
        f = setup_filter([1, 3, 3, 1])
        d = (f, [1, 1], [1, 1], [2, 2, 2, 2], False, 1.0)
        return [("D r=256 pre-filter", (48, 64, 256, 256), d),
                ("its adjoint", (48, 64, 257, 257), adjoint_args(*d, (256, 256), (257, 257))),
                ("G r=256 up-conv", (48, 128, 128, 128),
                 (f, [2, 2], [1, 1], [3, 2, 3, 2], False, 4.0))]
    f = setup_filter(_SYM6)
    up = (f, [2, 2], [1, 1], [6, 5, 6, 5], False, 4.0)
    down = (f, [1, 1], [2, 2], [-1, -1, -1, -1], True, 1.0)
    return [("pipe 2x up", (*batch, 268, 268), up),
            ("its adjoint", (*batch, 536, 536), adjoint_args(*up, (268, 268), (536, 536))),
            ("pipe 2x down", (*batch, 524, 524), down),
            ("its adjoint", (*batch, 256, 256), adjoint_args(*down, (524, 524), (256, 256)))]


def old_planner(checkout: Path):
    """The checkout's ops/upfirdn2d_kernel.py, imported under another name
    (with its own cuda_build), to plan its own source's launches."""
    ops = checkout / "stylegan_v_tpu_torch" / "ops"
    pkg = types.ModuleType("_k2_old_ops")
    pkg.__path__ = [str(ops)]
    sys.modules["_k2_old_ops"] = pkg
    return importlib.import_module("_k2_old_ops.upfirdn2d_kernel")


def build(root: Path, sources: dict, which: str):
    """Start one nvcc for each variant that times `which` calls; returns
    {(design, name): (library, process)}."""
    started = {}
    for (design, name), (edits, _, kinds) in VARIANTS.items():
        if design not in sources or which not in kinds:
            continue
        text = sources[design]
        if any(old not in text for old, _ in edits):
            print(f"{design} {name}: its edit does not apply to this source, left out")
            continue
        for old, new in edits:
            text = text.replace(old, new)
        d = root / f"{which}_{design}_{name}"
        d.mkdir()
        (d / "upfirdn2d.cu").write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(d / "lib.so"), str(d / "upfirdn2d.cu")]
        started[(design, name)] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return started


def registers(ptxas_out: str) -> dict:
    """{demangled kernel name without spaces: 'N registers, S bytes spill stores'}."""
    found, name = {}, None
    for line in ptxas_out.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            found[name] = f"{line.split('Used')[1].split(',')[0].strip()}, {spill}"
            name = None
    out = list(found)
    for filt in (lambda: shutil.which("c++filt"),
                 lambda: str(Path(cuda_build._nvcc()).parent / "cu++filt")):
        try:
            names = subprocess.run([filt()], input="\n".join(found) + "\n", capture_output=True,
                                   text=True, check=True).stdout.splitlines()
        except (TypeError, OSError, RuntimeError, subprocess.CalledProcessError):
            continue
        if len(names) == len(found):
            out = names
            break
    return {d.replace(" ", ""): r for d, r in zip(out, found.values())}


def instantiations(design: str, launches) -> list:
    """The template arguments of the kernels `launches` run, as the demangled
    names spell them."""
    names = []
    for out_shape, variant, _, _, plan, planner in launches:
        args = [str(v) for v in planner.VARIANTS[variant]]
        if design == "new" and variant < k2.N_2D:
            odd = "true" if out_shape[3] % 2 else "false"
            names.append("upfirdn2d_2d_kernel<" + ",".join(
                ["__nv_bfloat16", odd, str(plan.mode), *args[2:]]) + ">")
        elif design == "new":
            names.append("upfirdn2d_sep_kernel<" + ",".join(["__nv_bfloat16", *args]) + ">")
        else:
            odd = "true" if out_shape[3] % 2 else "false"
            names.append("upfirdn2d_kernel<" + ",".join(["__nv_bfloat16", odd, *args]) + ">")
    return names


def launch_args(design: str, planner, x: torch.Tensor, args, mode=None):
    """The launches of one call in `design`: [(output shape, variant, plan
    array, taps array, plan, planner)], this design's 2-D sum mode forced
    where `mode` is not None."""
    ps = k2.passes(*args)
    sms = k2._sm_count(x.device)
    if design == "new":
        variant, plan, taps = k2.call_launch(ps, x.shape, x.dtype, x.data_ptr() % 16, sms)
        if mode is not None:
            plan = plan._replace(mode=mode)
        plans, shapes = [(variant, plan, taps)], [(*x.shape[:2], plan.out_h, plan.out_w)]
    else:
        plans, shapes, shape, ptr = [], [], tuple(x.shape), x.data_ptr() % 16
        for p in ps:                             # a pass a launch, chained
            variant, plan, taps = planner.pass_launch(p, shape, x.dtype, ptr, sms)
            shape, ptr = (*shape[:2], plan.out_h, plan.out_w), 0
            plans.append((variant, plan, taps))
            shapes.append(shape)
    return [(shape, variant, (ctypes.c_int64 * len(plan))(*plan),
             (ctypes.c_float * len(taps))(*taps.tolist()), plan, planner)
            for shape, (variant, plan, taps) in zip(shapes, plans)]


def runner(fn, launches, x, stream=None):
    """A function that runs a call's launches from x through fresh buffers;
    returns the last one's output."""
    bufs = [torch.empty(L[0], dtype=x.dtype, device=x.device) for L in launches]
    code = cuda_build.DTYPE_CODES[x.dtype]

    def run(x=x, stream=stream):
        s = stream or torch.cuda.current_stream().cuda_stream
        src = x
        for (_, variant, plan_a, taps, _, _), y in zip(launches, bufs):
            err = fn(src.data_ptr(), y.data_ptr(), taps, code, variant, plan_a, s)
            if err:
                raise RuntimeError(f"a launch failed with CUDA error {err}")
            src = y
        return src
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--old", default=None, help="an earlier design's checkout")
    ap.add_argument("--calls", default="all", choices=("2d", "sep", "all"))
    ap.add_argument("--designs", default="new,old",
                    help="the designs whose variants to time (old needs --old)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    sources, planners = {"new": SOURCE.read_text()}, {"new": k2}
    if args.old:
        old = Path(args.old)
        sources["old"] = (old / "stylegan_v_tpu_torch" / "csrc" / "upfirdn2d.cu").read_text()
        planners["old"] = old_planner(old)
    dev = torch.device("cuda", 0)
    kinds = ("2d", "sep") if args.calls == "all" else (args.calls,)
    with tempfile.TemporaryDirectory() as tmp:
        chosen = {d: s for d, s in sources.items() if d in args.designs.split(",")}
        started = {which: build(Path(tmp), chosen, which) for which in kinds}
        for which in kinds:
            fns, regs = {}, {}
            for key, (lib, proc) in started[which].items():
                out, _ = proc.communicate()
                if proc.returncode:
                    if key[1] == "final":
                        raise SystemExit(f"{key} failed to build:\n{out[-3000:]}")
                    print(f"{key}: failed to build, left out:\n{out[-1500:]}")
                    continue
                fn = ctypes.CDLL(str(lib)).upfirdn2d
                fn.argtypes, fn.restype = list(k2._ARGTYPES), ctypes.c_int
                fns[key], regs[key] = fn, registers(out)
            time_variants(fns, regs, planners, which, dev)
            if {"old", "new"} <= set(chosen):
                finals = {d: fns[(d, "final")] for d in ("old", "new")}
                if which == "2d":
                    graph_times(finals, planners, dev)
                else:
                    for batch in ((16, 9), (8, 48)):
                        call_times(finals, planners, dev, batch)
    return 0


def time_variants(fns, regs, planners, which, dev) -> None:
    g = torch.Generator(device=dev).manual_seed(16)
    for label, shape, cargs in calls(which):
        xs = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
        want = k2.upfirdn2d_k2_plain(xs[0], *cargs)
        runs = {}
        for key, fn in fns.items():
            per_x = [launch_args(key[0], planners[key[0]], x, cargs, VARIANTS[key][1])
                     for x in xs]
            runs[key] = [runner(fn, L, x) for L, x in zip(per_x, xs)]
            y = runs[key][0]()
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            reg = "; ".join(f"{inst}: " + next((r for n, r in regs[key].items() if inst in n),
                                               "not found")
                            for inst in instantiations(key[0], per_x[0]))
            print(f"{label} {key[0]} {key[1]}: {len(per_x[0])} launch(es), max_abs_err "
                  f"{err:.3g}; {reg}", flush=True)
        order = list(runs) + list(runs)[::-1]
        ms = {key: [] for key in runs}
        for _ in range(2):
            for key in order:
                turn = itertools.cycle(runs[key])
                next(turn)()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(10):
                    next(turn)()
                end.record()
                end.synchronize()
                ms[key].append(start.elapsed_time(end) / 10)
        bound = (xs[0].numel() + want.numel()) * 2 / 3.35e12 * 1e3
        for key, t in ms.items():
            print(f"{label} {key[0]:3s} {key[1]:13s} {min(t):.4f}-{max(t):.4f} ms over "
                  f"{len(t)} turns; bound {bound:.4f} ms ({bound / min(t):.3f} of it)",
                  flush=True)
        del xs, want, runs
        torch.cuda.empty_cache()


def main_path_calls():
    """Every 2-D K2 call of one forward of FFS-256's G and D at 16 x 3
    (channel_base 16384, channel_max 512, bf16 at 32^2-256^2) and its
    adjoint: (label, x shape, dtype, upfirdn2d's arguments)."""
    f = setup_filter([1, 3, 3, 1])
    kinds = {"G up-conv": (f, [2, 2], [1, 1], [3, 2, 3, 2], False, 4.0),
             "G image skip": (f, [2, 2], [1, 1], [2, 1, 2, 1], False, 4.0),
             "D pre-filter": (f, [1, 1], [1, 1], [2, 2, 2, 2], False, 1.0)}
    for r in (8, 16, 32, 64, 128, 256):
        dtype = torch.bfloat16 if r >= 32 else torch.float32
        ch = min(16384 // r, 512)
        for kind, shape, dt in (
                ("G up-conv", (48, min(16384 // (r // 2), 512), r // 2, r // 2), dtype),
                ("G image skip", (48, 3, r // 2, r // 2), torch.float32),
                ("D pre-filter", (48 if r > 16 else 16, ch, r, r), dtype)):
            args = kinds[kind]
            p, = k2.passes(*args)
            out = k2.pass_out_hw(p, *shape[2:])
            yield f"{kind} r={r}", shape, dt, args
            yield (f"{kind} r={r}, adjoint", (*shape[:2], *out), dt,
                   adjoint_args(*args, shape[2:], out))


def graph_times(fns: dict, planners, dev) -> None:
    """Device ms of each design's `final` at main_path_calls(), by CUDA
    graphs of 20 calls, beside the call's bytes bound; and how far the two
    designs' outputs differ."""
    for label, shape, dt, cargs in main_path_calls():
        x = torch.randn(shape, device=dev).to(dt)
        graphs, side = {}, torch.cuda.Stream()
        for design, fn in fns.items():
            run = runner(fn, launch_args(design, planners[design], x, cargs), x)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                y = run(stream=side.cuda_stream)
                torch.cuda.synchronize()
                with torch.cuda.graph(g, stream=side):
                    for _ in range(20):
                        run(stream=torch.cuda.current_stream().cuda_stream)
            graphs[design] = (g, y)
        ms = {design: [] for design in graphs}
        for _ in range(3):
            for design in list(graphs) + list(graphs)[::-1]:
                g = graphs[design][0]
                g.replay()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                g.replay()
                end.record()
                end.synchronize()
                ms[design].append(start.elapsed_time(end) / 20)
        y = graphs["new"][1]
        diff = (graphs["old"][1].float() - y.float()).abs().max().item()
        bound = (x.numel() + y.numel()) * x.element_size() / 3.35e12 * 1e3
        print(f"{label} {list(shape)} {str(dt)[6:]}: " + ", ".join(
            f"{d} {min(t):.4f}-{max(t):.4f} ms" for d, t in ms.items())
            + f"; bound {bound:.4f} ms; outputs differ by {diff:.3g}", flush=True)
        del graphs
        torch.cuda.empty_cache()


def call_times(fns: dict, planners, dev, batch) -> None:
    """Each design's `final` at the separable calls on `batch`: CUDA-event ms
    over 20 calls on one input (warm L2), in turns old, new, new, old, three
    times, beside the call's bytes bound; and whether the two designs'
    outputs are equal to the bit."""
    for label, shape, cargs in calls("sep", batch):
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        runs = {d: runner(fn, launch_args(d, planners[d], x, cargs), x) for d, fn in fns.items()}
        outs = {d: run() for d, run in runs.items()}
        ms = {d: [] for d in runs}
        for _ in range(3):
            for d in list(runs) + list(runs)[::-1]:
                runs[d]()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    runs[d]()
                end.record()
                end.synchronize()
                ms[d].append(start.elapsed_time(end) / 20)
        y = outs["new"]
        equal = torch.equal(outs["old"], y)
        bound = (x.numel() + y.numel()) * x.element_size() / 3.35e12 * 1e3
        print(f"{label} {list(shape)} bf16, warm L2: " + ", ".join(
            f"{d} {min(t):.4f}-{max(t):.4f} ms" for d, t in ms.items())
            + f"; bound {bound:.4f} ms; outputs equal to the bit: {equal}", flush=True)
        del runs, outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
