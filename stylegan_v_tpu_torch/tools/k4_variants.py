"""Time variants of the K4 kernel (csrc/affine_warp.cu) at the ADA step's
warp, to see where its time goes.

    python3 -m stylegan_v_tpu_torch.tools.k4_variants

Each variant is a copy of the kernel's source (with affine_warp.cuh and
fir_tile.cuh) with one edit, built with the port's nvcc flags into a
temporary directory and called through ctypes with the wrapper's arguments.
They all run on the pipe's own warp at 16 videos x 3 frames: x [16, 9, 536,
536] -> y [16, 9, 524, 524] in bfloat16, reflect mode, G_inv from the bgc
pipe at p = 1 (as chip_smoke.py phase 10 takes it). CUDA-event times in
turns, twice; each variant's worst error against the plain version is
printed beside its registers and spills (no_loads and stage_only compute
something else):

  final       the kernel as it is
  per_pixel   the reference design, one thread an output, every tap from
              device memory (the kernel source's affine_warp_per_pixel)
  no_loads    the geometry and the stores: no staging, no tap reads
  stage_only  the staging and the stores: no geometry, no tap reads
  stores_only the box and the stores: no geometry, no staging, no tap reads
  stores_nobox the stores alone: a fixed box, no geometry, staging or reads
  stage_first the first copy started before the geometry, not after it
  wide64      tiles of 64 x 16 (two warps a row): 128-byte runs of stores
  wide64_rows4 tiles of 64 x 16, four rows a thread
  stores_nobox_wide64 stores_nobox with tiles of 64 x 16
  streaming   bf16 stores with the streaming hint (st.global.cs)
  tight_pitch rows of the box as many chunks apart as they hold (not odd)
  rows1       one output row a thread: tiles of 32 x 8
  rows4       four output rows a thread: tiles of 32 x 32
  smem96      a staging budget of 96 KB a block (2 blocks an SM)
  smem40_b5   40 KB a block, at most 51 registers a thread (5 blocks an SM)
  smem32_b6   32 KB a block, at most 42 registers a thread (6 blocks an SM)
  no_chunks   no channel chunks: a tile whose channels do not all fit the
              budget takes the direct path

then final, per_pixel and no_chunks once more in float32 (where a third of
the step's tiles stage their channels in chunks), and the guard count: the
final kernel with counters of the taps read from device memory because they
fell outside their tile's box, of the tiles that took the direct path and of
those that staged in chunks, over one call each at the step's warp and at
warp_upsample=1 in both dtypes.

Needs a CUDA device and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build, grid_sample
from .k4_bwd_variants import cuda_ms, step_warp

CSRC = Path(cuda_build.__file__).resolve().parents[1] / "csrc"
STAGE = "  stage<T, VEC>(buf, src, in_plane, W, b, 0, min(cg, C));\n"
TAPS = "  const int ox = ox0 + threadIdx.x % TILE_W;\n"
TILE = "constexpr int TILE_W = 32;"
WARPS = "constexpr int THREAD_ROWS = 8;"
STORE = "{ *p = __float2bfloat16_rn(v); }"
SPAN = ("    tile_span(m, threadIdx.x == 0 ? W : H, ox0, last_x, oy0, last_y, zeros,\n"
        "              span[2 * threadIdx.x], span[2 * threadIdx.x + 1]);\n")
STAGE_NEXT = "      stage<T, VEC>(buf + ((k + 1) & 1) * buf_step, src, in_plane, W, b, c0 + cg,\n"
READ = ("          v = bilinear(to_f32(g[0]), to_f32(g[p.sx]), to_f32(g[p.sy]), "
        "to_f32(g[p.sy + p.sx]),\n")
GEOMETRY = "    p.t = taps_from(A, gx, grid_coord(p.oy, out_h), H, W, zeros);\n"
PITCH = "  b.pitch = (b.chunks | 1) * V;\n"
ROWS = "constexpr int ROWS = 2;"
SMEM = "constexpr int SMEM_BYTES = 48 * 1024;"
BOUNDS = "__launch_bounds__(THREADS, 4)"
GUARD = "        } else {  // a tap outside the box: never, by the margin\n"
DIRECT = "  if (cg == 0) {  // the direct path\n"
CHANNELS = ("  return (int64_t)C * plane_bytes <= SMEM_BYTES ? C : "
            "(int)(SMEM_BYTES / (2 * plane_bytes));\n")
COUNTERS = """
__device__ unsigned long long k4_counters[3];  // guard hits, direct tiles, chunked tiles
extern "C" int k4_counts(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k4_counters, sizeof(k4_counters));
  const unsigned long long zero[3] = {0, 0, 0};
  if (e == cudaSuccess && reset) e = cudaMemcpyToSymbol(k4_counters, zero, sizeof(zero));
  return (int)e;
}
"""

VARIANTS = {
    "final": [],
    "no_loads": [(STAGE, ""), (STAGE_NEXT, "      if (false) stage<T, VEC>(buf, src, in_plane, "
                                           "W, b, c0 + cg,\n"),
                 (READ, "          v = p.t.wx; if (false)\n" + READ)],
    "stage_only": [(GEOMETRY, "    p.t = Taps{};\n")],
    "stores_only": [(GEOMETRY, "    p.t = Taps{};\n"), (STAGE, ""),
                    (STAGE_NEXT, "      if (false) stage<T, VEC>(buf, src, in_plane, W, b, "
                                 "c0 + cg,\n")],
    "stores_nobox": [(GEOMETRY, "    p.t = Taps{};\n"), (STAGE, ""),
                     (STAGE_NEXT, "      if (false) stage<T, VEC>(buf, src, in_plane, W, b, "
                                  "c0 + cg,\n"),
                     (SPAN, "    span[2 * threadIdx.x] = 0, span[2 * threadIdx.x + 1] = 31;\n")],
    "stage_first": [(STAGE + "  fir::cp_async_commit();\n", ""),
                    (TAPS, "  if (cg > 0) {\n  " + STAGE + "    fir::cp_async_commit();\n  }\n"
                     + TAPS)],
    "wide64": [(TILE, "constexpr int TILE_W = 64;"), (WARPS, "constexpr int THREAD_ROWS = 4;")],
    "wide64_rows4": [(TILE, "constexpr int TILE_W = 64;"),
                     (WARPS, "constexpr int THREAD_ROWS = 4;"), (ROWS, "constexpr int ROWS = 4;"), (BOUNDS, "__launch_bounds__(THREADS, 2)")],
    "stores_nobox_wide64": [(GEOMETRY, "    p.t = Taps{};\n"), (STAGE, ""),
                            (STAGE_NEXT, "      if (false) stage<T, VEC>(buf, src, in_plane, W, "
                                         "b, c0 + cg,\n"),
                            (SPAN, "    span[2 * threadIdx.x] = 0, span[2 * threadIdx.x + 1] = "
                                   "31;\n"),
                            (TILE, "constexpr int TILE_W = 64;"),
                            (WARPS, "constexpr int THREAD_ROWS = 4;")],
    "streaming": [(STORE, "{ __stcs(p, __float2bfloat16_rn(v)); }")],
    "tight_pitch": [(PITCH, "  b.pitch = b.chunks * V;\n")],
    "rows1": [(ROWS, "constexpr int ROWS = 1;")],
    "rows4": [(ROWS, "constexpr int ROWS = 4;"), (BOUNDS, "__launch_bounds__(THREADS, 2)")],
    "smem96": [(SMEM, "constexpr int SMEM_BYTES = 96 * 1024;"),
               (BOUNDS, "__launch_bounds__(THREADS, 2)")],
    "smem40_b5": [(SMEM, "constexpr int SMEM_BYTES = 40 * 1024;"),
                  (BOUNDS, "__launch_bounds__(THREADS, 5)")],
    "smem32_b6": [(SMEM, "constexpr int SMEM_BYTES = 32 * 1024;"),
                  (BOUNDS, "__launch_bounds__(THREADS, 6)")],
    "no_chunks": [(CHANNELS, "  return (int64_t)C * plane_bytes <= SMEM_BYTES ? C : 0;\n")],
    "guard_count": [(SMEM, SMEM + "\n}  // namespace\n" + COUNTERS + "namespace {\n"),
                    (GUARD, GUARD + "          atomicAdd(&k4_counters[0], 1ULL);\n"),
                    (DIRECT, DIRECT + "    if (threadIdx.x == 0) atomicAdd(&k4_counters[1], "
                                      "1ULL);\n"),
                    (STAGE, "  if (threadIdx.x == 0 && cg < C) atomicAdd(&k4_counters[2], 1ULL);\n"
                     + STAGE)],
}


def build(root: Path):
    """Start one nvcc for each variant; returns {name: (library, process)}."""
    source = (CSRC / "affine_warp.cu").read_text()
    started = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the kernel source has changed")
            text = text.replace(old, new)
        d = root / name
        d.mkdir()
        (d / "affine_warp.cu").write_text(text)
        for header in ("affine_warp.cuh", "fir_tile.cuh"):
            (d / header).write_text((CSRC / header).read_text())
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(d / "lib.so"), str(d / "affine_warp.cu")]
        started[name] = (d / "lib.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True))
    return started


def warp_calls(dev):
    """The pipe's two warps at 16 x 3: (x shape, G_inv, out_h, out_w) for
    warp_upsample 2 (the step's) and 1, with the same draws."""
    big = step_warp(dev)
    (N, C, H, W), G, _, _ = big
    return [big, ((N, C, 256, 256), G, 256, 256)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, (lib, proc) in build(Path(tmp)).items():
            out, _ = proc.communicate()
            if proc.returncode:
                if name in ("final", "guard_count"):
                    raise SystemExit(f"variant {name} failed to build:\n{out}")
                print(f"{name}: failed to build, left out:\n{out[-1500:]}")
                continue
            ptxas = [line.split(":", 1)[-1].strip() for line in out.splitlines()
                     if "registers" in line or "spill" in line]
            print(f"{name}: {' / '.join(ptxas)}")
            libs[name] = ctypes.CDLL(str(lib))
        fns = {}
        for name, lib in libs.items():
            fns[name] = lib.affine_warp
            if name == "final":
                fns["per_pixel"] = lib.affine_warp_per_pixel
        for fn in fns.values():
            fn.argtypes, fn.restype = list(grid_sample._ARGTYPES), ctypes.c_int
        counts = libs["guard_count"].k4_counts
        counts.argtypes, counts.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
        calls = warp_calls(dev)
        (N, C, H, W), G, out_h, out_w = calls[0]
        x = torch.randn(N, C, H, W, generator=torch.Generator(device=dev).manual_seed(7),
                        device=dev).to(torch.bfloat16)
        want = grid_sample.affine_grid_sample_plain(x, G, out_h, out_w)
        y = torch.empty(N, C, out_h, out_w, dtype=x.dtype, device=dev)

        def call(fn, x=x, y=y, G=G, out_h=out_h, out_w=out_w):
            n, c, h, w = x.shape
            err = fn(x.data_ptr(), G.data_ptr(), y.data_ptr(), cuda_build.DTYPE_CODES[x.dtype],
                     0, n, c, h, w, out_h, out_w, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed with CUDA error {err}")

        for name, fn in fns.items():
            call(fn)
            torch.cuda.synchronize()
            print(f"{name}: max_abs_err {(y.float() - want.float()).abs().max().item():.3g}, "
                  f"equal to the plain version {torch.equal(y, want)}")
        got = (ctypes.c_ulonglong * 3)()
        counts(got, 1)
        for (shape, G_, oh, ow) in calls:
            for dtype in (torch.bfloat16, torch.float32):
                xi = torch.randn(shape, device=dev).to(dtype)
                yi = torch.empty(*shape[:2], oh, ow, dtype=dtype, device=dev)
                call(fns["guard_count"], xi, yi, G_, oh, ow)
                torch.cuda.synchronize()
                if counts(got, 1):
                    raise RuntimeError("reading the counters failed")
                ch = grid_sample._warp_tile_boxes(G_, *shape[2:], oh, ow,
                                                  itemsize=xi.element_size()).channels
                print(f"guard_count {list(shape)} -> {[oh, ow]} {str(dtype)[6:]}: guard hits "
                      f"{got[0]}, direct tiles {got[1]}, chunked tiles {got[2]} (the plan: "
                      f"{int((ch == 0).sum())} and {int(((ch > 0) & (ch < shape[1])).sum())} "
                      f"of {ch.size})")

        def turns(names, label, **kw):
            order = names + names[::-1]
            ms = {name: [] for name in names}
            for _ in range(2):
                for name in order:
                    call(fns[name], **kw)                             # warm
                    ms[name].append(cuda_ms(lambda: call(fns[name], **kw)))
            for name, t in ms.items():
                print(f"{name:10s} {min(t):.4f}-{max(t):.4f} ms over {len(t)} turns{label}")

        turns([n for n in fns if n != "guard_count"], "")
        x32 = x.float()
        y32 = torch.empty(y.shape, device=dev)
        want32 = grid_sample.affine_grid_sample_plain(x32, G, out_h, out_w)
        f32 = [n for n in ("final", "per_pixel", "no_chunks") if n in fns]
        for name in f32:
            call(fns[name], x32, y32)
            torch.cuda.synchronize()
            print(f"{name} float32: equal to the plain version {torch.equal(y32, want32)}")
        turns(f32, " in float32", x=x32, y=y32)
        # floors of the same output: a memset of y, and a copy into y
        other = torch.empty_like(y)
        floors = {"y.zero_()": lambda: y.zero_(), "y.copy_(y2)": lambda: y.copy_(other)}
        for name, fn in floors.items():
            fn()
            t = [cuda_ms(fn) for _ in range(4)]
            print(f"{name:10s} {min(t):.4f}-{max(t):.4f} ms over {len(t)} turns")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
