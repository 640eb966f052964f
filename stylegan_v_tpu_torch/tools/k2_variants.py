"""Time variants of K2's 2-D pass (csrc/upfirdn2d.cu), this design and an
earlier one, at three calls of the ADA step, to see where their time goes.

    python3 -m stylegan_v_tpu_torch.tools.k2_variants [--old OLD_SOURCE]

The calls, bf16 at 16 videos x 3 frames: D's r = 256 pre-filter [48, 64,
256, 256] -> 257^2, its adjoint 257^2 -> 256^2, and G's r = 256 up-conv
[48, 128, 128, 128] -> 258^2. Each variant is a copy of a design's source
with one edit, built with the port's nvcc flags (and -Xptxas -v) into a
temporary directory and called through ctypes with the wrapper's arguments
and that design's plan (k2_plan_2d for this one, k2_plan for the earlier
one, whose source --old names, e.g. a checkout of the parent commit). They
run in turns, twice, each timed by CUDA events over 10 calls that rotate
through two copies of the input (each larger than the L2); each prints its
worst error against the plain version (copy_only and sums_only compute
something else) and the registers and spills of the instantiation the call
runs:

  final          the design as it is
  copy_only      the window copies and the stores: no sums
  sums_only      the sums over whatever shared memory holds, and the
                 stores: no copies
  static_filter  the filter's size at compile time: no fh / fw guards (this
                 design: its 2-D sum of exactly 4x4 taps, instead of rows
                 then columns)
  sum2d          (this design) the 2-D sum guarded by the filter's size
  stages2        (this design) a ring of 2 windows, not 3

With --old it then times `final` of both designs at every 2-D call of one
forward at 16 x 3 (G's up-convs and image skips, D's pre-filters, r = 8 ...
256) and at its adjoint, in the path's dtype, as device time: a CUDA graph
of 20 launches each, replayed in turns old, new, new, old, three times (the
small calls' times in chip_smoke.py phase 3b also hold the host's launch
gaps).

Needs a CUDA device and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build, setup_filter, upfirdn2d_kernel as k2
from ..ops.upfirdn2d import adjoint_args

SOURCE = Path(cuda_build.SOURCES["upfirdn2d"])

NEW_SUMS = "    if (active)\n      sums<T, MODE"
NEW_ISSUE = ("    if (t < pl.tiles) issue_tile<", "    if (nt < pl.tiles) issue_tile<")
OLD_SUMS = "accumulate<T, FY, FX, UY, DY, RY, UX, DX, RX>(acc, s, k, pl);"
OLD_COPY = "  switch (pl.chunk_bytes) {\n    case 16: copy_window"
OLD_GUARDS = ("if (ty < 0 || ty >= FY || ty >= pl.fh) continue;",
              "if (tx < 0 || tx >= FX || tx >= pl.fw) continue;")

# (design, variant): (edits, this design's sum mode: None for the plan's own)
VARIANTS = {
    ("new", "final"): ([], None),
    ("new", "copy_only"): ([(NEW_SUMS, "    if (false)\n      sums<T, MODE")], None),
    ("new", "sums_only"): ([(NEW_ISSUE[0], "    if (false) issue_tile<"),
                            (NEW_ISSUE[1], "    if (false) issue_tile<")], None),
    ("new", "static_filter"): ([], k2.FULL),
    ("new", "sum2d"): ([], k2.GUARDED),
    ("new", "stages2"): ([("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")], None),
    ("old", "final"): ([], None),
    ("old", "copy_only"): ([(OLD_SUMS, "if (false) " + OLD_SUMS)], None),
    ("old", "sums_only"): ([(OLD_COPY, "  if (false) switch (pl.chunk_bytes) {\n    case 16: "
                                       "copy_window")], None),
    ("old", "static_filter"): ([(OLD_GUARDS[0], "if (ty < 0 || ty >= FY) continue;"),
                                (OLD_GUARDS[1], "if (tx < 0 || tx >= FX) continue;")], None),
}


def calls():
    """(label, x shape, upfirdn2d's (f, up, down, padding, flip, gain))."""
    f = setup_filter([1, 3, 3, 1])
    d = (f, [1, 1], [1, 1], [2, 2, 2, 2], False, 1.0)
    return [("D r=256 pre-filter", (48, 64, 256, 256), d),
            ("its adjoint", (48, 64, 257, 257),
             adjoint_args(*d, (256, 256), (257, 257))),
            ("G r=256 up-conv", (48, 128, 128, 128), (f, [2, 2], [1, 1], [3, 2, 3, 2], False,
                                                      4.0))]


def build(root: Path, sources: dict):
    """Start one nvcc for each variant; returns {(design, name): (library, process)}."""
    started = {}
    for (design, name), (edits, _) in VARIANTS.items():
        if design not in sources:
            continue
        text = sources[design]
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {design} {name}: the kernel source has changed")
            text = text.replace(old, new)
        d = root / f"{design}_{name}"
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


def instantiation(design: str, variant: int, mode: int, out_w: int) -> str:
    """The template arguments a call runs with, as the demangled name spells them."""
    FY, FX, *rest = k2.VARIANTS[variant]
    odd = "true" if out_w % 2 else "false"
    if design == "new":
        args = ["__nv_bfloat16", odd, str(mode), *map(str, rest)]
        return "upfirdn2d_2d_kernel<" + ",".join(args) + ">"
    return "upfirdn2d_kernel<" + ",".join(["__nv_bfloat16", odd, str(FY), str(FX),
                                           *map(str, rest)]) + ">"


def launch_args(design: str, x: torch.Tensor, args, mode=None):
    """(output shape, variant, plan array, taps array, plan) of a one-pass
    call; this design's sum mode forced where `mode` is not None."""
    p, = k2.passes(*args)
    N, C, H, W = x.shape
    variant, plan, taps = k2.pass_launch(p, x.shape, x.dtype, x.data_ptr() % 16,
                                         k2._sm_count(x.device))
    if design == "new" and mode is not None:
        plan = plan._replace(mode=mode)
    if design == "old":
        fh, fw = p.k.shape
        plan = k2.k2_plan(variant, N * C, H, W, fh, fw, p.pad, x.element_size(),
                          x.data_ptr() % 16 == 0)
    return ((N, C, plan.out_h, plan.out_w), variant, (ctypes.c_int64 * len(plan))(*plan),
            (ctypes.c_float * 24)(*taps.tolist()), plan)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--old", default=None, help="an earlier design's csrc/upfirdn2d.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    sources = {"new": SOURCE.read_text()}
    if args.old:
        sources["old"] = Path(args.old).read_text()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        fns, regs = {}, {}
        for key, (lib, proc) in build(Path(tmp), sources).items():
            out, _ = proc.communicate()
            if proc.returncode:
                if key[1] == "final":
                    raise SystemExit(f"{key} failed to build:\n{out[-3000:]}")
                print(f"{key}: failed to build, left out:\n{out[-1500:]}")
                continue
            fn = ctypes.CDLL(str(lib)).upfirdn2d
            fn.argtypes, fn.restype = list(k2._ARGTYPES), ctypes.c_int
            fns[key], regs[key] = fn, registers(out)
        g = torch.Generator(device=dev).manual_seed(16)
        stream = torch.cuda.current_stream().cuda_stream
        for label, shape, cargs in calls():
            xs = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
            want = k2.upfirdn2d_k2_plain(xs[0], *cargs)
            runs = {}
            for key, fn in fns.items():
                per_x = [launch_args(key[0], x, cargs, VARIANTS[key][1]) for x in xs]
                out_shape, variant, *_, plan = per_x[0]
                y = torch.empty(out_shape, dtype=torch.bfloat16, device=dev)

                def call(turn=itertools.count(1), fn=fn, per_x=per_x, y=y):
                    i = next(turn) % 2
                    _, variant, plan_a, taps, _ = per_x[i]
                    err = fn(xs[i].data_ptr(), y.data_ptr(), taps, 1, variant, plan_a, stream)
                    if err:
                        raise RuntimeError(f"{key} launch failed with CUDA error {err}")
                runs[key] = call
                fn(xs[0].data_ptr(), y.data_ptr(), per_x[0][3], 1, variant, per_x[0][2], stream)
                torch.cuda.synchronize()
                err = (y.float() - want.float()).abs().max().item()
                inst = instantiation(key[0], variant, plan.mode if key[0] == "new" else 0,
                                     out_shape[3])
                reg = next((r for n, r in regs[key].items() if inst in n), "not found")
                print(f"{label} {key[0]} {key[1]}: max_abs_err {err:.3g}; {inst}: {reg}",
                      flush=True)
            order = list(runs) + list(runs)[::-1]
            ms = {key: [] for key in runs}
            for _ in range(2):
                for key in order:
                    runs[key]()
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(10):
                        runs[key]()
                    end.record()
                    end.synchronize()
                    ms[key].append(start.elapsed_time(end) / 10)
            nbytes = (xs[0].numel() + y.numel()) * 2
            bound = nbytes / 3.35e12 * 1e3
            for key, t in ms.items():
                print(f"{label} {key[0]:3s} {key[1]:13s} {min(t):.4f}-{max(t):.4f} ms over "
                      f"{len(t)} turns; bound {bound:.4f} ms ({bound / min(t):.3f} of it)",
                      flush=True)
            del xs, want, runs
            torch.cuda.empty_cache()
        if args.old:
            call_times({d: fns[(d, "final")] for d in ("old", "new")}, dev)
    return 0


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


def call_times(fns: dict, dev) -> None:
    """Device ms of each design's `final` at main_path_calls(), by CUDA
    graphs of 20 launches, beside the call's bytes bound."""
    for label, shape, dt, cargs in main_path_calls():
        x = torch.randn(shape, device=dev).to(dt)
        graphs, side = {}, torch.cuda.Stream()
        for design, fn in fns.items():
            out_shape, variant, plan_a, taps, _ = launch_args(design, x, cargs)
            y = torch.empty(out_shape, dtype=dt, device=dev)
            args = (x.data_ptr(), y.data_ptr(), taps, cuda_build.DTYPE_CODES[dt], variant, plan_a)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                if fn(*args, side.cuda_stream):
                    raise RuntimeError(f"{design} {label}: the launch failed")
                torch.cuda.synchronize()
                with torch.cuda.graph(g, stream=side):
                    for _ in range(20):
                        fn(*args, torch.cuda.current_stream().cuda_stream)
            graphs[design] = (g, y, args)
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


if __name__ == "__main__":
    raise SystemExit(main())
