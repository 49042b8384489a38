#!/usr/bin/env python3
"""The measurements behind H1's chain design, on one card.

    python3 tools/chain_variants.py

Builds ``tensor_networks_tpu_torch/kernels/csrc/zipper.cu`` as it is and
in two variants (each by one text substitution, compiled side by side),
and times them in turns (as is, variant, variant, as is; CUDA events,
mean ms of 10 calls after 2), d=50, n=32:

* ``two_an_sm``: the float tile's block asks for its ring's shared
  memory only, so its registers (not ``EXCLUSIVE_SMEM``) set how many
  blocks share an SM: the chain at (256, 256) and (512, 300) f32;
* ``tile_gemm_prologue``: the fused route's W0 = fa^T fb through
  ``tile_gemm`` instead of ``gemm_tn``: the fused route at (100, 100);
* ``next_split``: the as-is build with one split more than
  ``chain_plan`` gives (a second wave of a few blocks) at (512, 300);
* the f64 ``mma.sync`` shapes m8n8k4 and m16n8k4: TFLOP/s of a kernel
  that keeps 8 independent products a warp in registers (4 warps a
  block, 2 blocks an SM).

Prints one JSON line.  Needs a card and ``nvcc``; builds under
``tensor_networks_tpu_torch/kernels/_build``.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tensor_networks_tpu_torch.kernels import _build  # noqa: E402
from tensor_networks_tpu_torch.kernels import zipper as zp  # noqa: E402

CSRC = ROOT / "tensor_networks_tpu_torch" / "kernels" / "csrc"
D, N = 50, 32

VARIANTS = {
    "two_an_sm": ("        WIDE && kSmem < EXCLUSIVE_SMEM ? EXCLUSIVE_SMEM : kSmem;",
                  "        kSmem;"),
    "tile_gemm_prologue": (
        "    int rc = prologue_gemm<T>(fa, fb, w, n0, ra, rb, stream);\n    if (rc) return rc;\n"
        "    if (d_mid > 0) {",
        "    constexpr int E = std::is_same<T, double>::value ? 64 : 128;\n"
        "    int rc = launch_gemm<T, S, S, E, E>(fa, ra, fb, rb, w, ra, rb, n0, n0, 1, false,\n"
        "                                        stream);\n    if (rc) return rc;\n"
        "    if (d_mid > 0) {"),
}

DMMA_BENCH = r"""
#include <cuda_runtime.h>
constexpr int CHAINS = 8, ITERS = 4096;
__global__ void m8n8k4(double* out) {
    double acc[CHAINS][2] = {};
    const double a = 1e-9 * threadIdx.x, b = 1e-9;
    for (int i = 0; i < ITERS; ++i)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c)
            asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                         : "+d"(acc[c][0]), "+d"(acc[c][1]) : "d"(a), "d"(b));
    double s = 0;
    for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void m16n8k4(double* out) {
    double acc[CHAINS][4] = {};
    const double a0 = 1e-9 * threadIdx.x, a1 = 1e-9, b = 1e-9;
    for (int i = 0; i < ITERS; ++i)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c)
            asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                         : "+d"(acc[c][0]), "+d"(acc[c][1]), "+d"(acc[c][2]), "+d"(acc[c][3])
                         : "d"(a0), "d"(a1), "d"(b));
    double s = 0;
    for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// TFLOP/s of each shape: blocks of 128 threads, two an SM
extern "C" int dmma_rates(double* out, int blocks, double* rates) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    void (*kernels[2])(double*) = {m8n8k4, m16n8k4};
    const double flop[2] = {2.0 * 8 * 8 * 4, 2.0 * 16 * 8 * 4};
    for (int k = 0; k < 2; ++k) {
        kernels[k]<<<blocks, 128>>>(out);
        cudaEventRecord(e0);
        kernels[k]<<<blocks, 128>>>(out);
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        float ms = 0;
        cudaEventElapsedTime(&ms, e0, e1);
        rates[k] = flop[k] * blocks * 4.0 * ITERS * CHAINS / (ms * 1e-3) / 1e12;
    }
    return (int)cudaGetLastError();
}
"""


def _build_all(tmp: Path):
    """The as-is library, one per variant, and the DMMA benchmark."""
    src = (CSRC / "zipper.cu").read_text()
    jobs = {"as_is": src}
    for name, (old, new) in VARIANTS.items():
        if old not in src:
            raise RuntimeError(f"variant {name}: its text is not in zipper.cu")
        jobs[name] = src.replace(old, new)
    paths = {}
    for name, text in jobs.items():
        paths[name] = tmp / name / "zipper.cu"
        paths[name].parent.mkdir()
        paths[name].write_text(text)
    (tmp / "dmma.cu").write_text(DMMA_BENCH)
    flags = _build.NVCC_FLAGS + ["-I", str(CSRC)]
    nvcc = _build.find_nvcc()

    def one(item):
        name, path = item
        return name, _build.compile_shared(nvcc, [path], flags, f"libvariant_{name}.so",
                                           headers=[CSRC / "common.cuh"])

    items = list(paths.items()) + [("dmma", tmp / "dmma.cu")]
    with ThreadPoolExecutor(len(items)) as pool:
        return {name: ctypes.CDLL(str(p)) for name, p in pool.map(one, items)}


def _train(g, r, dtype, dev):
    return [torch.randn((N, r), generator=g, device=dev, dtype=torch.float64).to(dtype),
            (torch.randn((D - 2, r, N, r), generator=g, device=dev, dtype=torch.float64)
             / math.sqrt(N * r)).to(dtype),
            torch.randn((r, N), generator=g, device=dev, dtype=torch.float64).to(dtype)]


def _chain_call(lib, x, y, plan):
    """One chain inner product through ``lib``'s f32 entry point."""
    fn = lib.tnt_zipper_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    ra, rb = x[0].shape[1], y[0].shape[1]
    dev = x[0].device
    w = torch.empty(ra * rb, device=dev)
    t = torch.empty(rb * N * ra, device=dev)
    part = torch.empty(plan.splits * ra * rb, device=dev)
    out = torch.empty((), device=dev)
    args = [p.data_ptr() for p in (*x, *y, w, t, part, out)] + [
        N, N, N, ra, rb, D - 2, plan.tile, plan.splits, plan.kchunk,
        torch.cuda.current_stream(dev).cuda_stream]

    def call():
        if fn(*args):
            raise RuntimeError("chain call failed")
        return out
    return call


def _fused_call(lib, x, y):
    fn = lib.tnt_zipper_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    dev = x[0].device
    plan = zp.band_plan(100, 100, N, torch.float32, zp._sm_count(dev.index))
    w = torch.empty(100 * 100, device=dev)
    part = torch.empty(N * 100 * 100, device=dev)
    out = torch.empty((), device=dev)
    args = [p.data_ptr() for p in (*x, *y, w, part, out)] + [
        N, N, N, 100, 100, D - 2, plan.nbands, plan.tmax,
        torch.cuda.current_stream(dev).cuda_stream]

    def call():
        if fn(*args):
            raise RuntimeError("fused call failed")
        return out
    return call


def _ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _turns(a, b):
    """ms of ``a`` and ``b`` timed a, b, b, a."""
    runs = [_ms(a), _ms(b), _ms(b), _ms(a)]
    return {"as_is": [runs[0], runs[3]], "variant": [runs[1], runs[2]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    sms = zp._sm_count(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(Path(tmp))
    g = torch.Generator(device=dev).manual_seed(17)
    out = {"card": torch.cuda.get_device_name(0)}
    for ra, rb in ((256, 256), (512, 300)):
        x, y = _train(g, ra, torch.float32, dev), _train(g, rb, torch.float32, dev)
        plan = zp.chain_plan(ra, rb, N, torch.float32, sms)
        key = f"{ra}x{rb}"
        out[f"two_an_sm {key}"] = _turns(_chain_call(libs["as_is"], x, y, plan),
                                         _chain_call(libs["two_an_sm"], x, y, plan))
        if (ra, rb) == (512, 300):
            k = rb * N
            kchunk = math.ceil(math.ceil(k / 16) / (plan.splits + 1)) * 16
            more = plan._replace(splits=math.ceil(k / kchunk), kchunk=kchunk)
            out[f"next_split {key} ({plan.splits} -> {more.splits} splits)"] = _turns(
                _chain_call(libs["as_is"], x, y, plan), _chain_call(libs["as_is"], x, y, more))
        del x, y
    x, y = _train(g, 100, torch.float32, dev), _train(g, 100, torch.float32, dev)
    out["tile_gemm_prologue fused 100x100"] = _turns(
        _fused_call(libs["as_is"], x, y), _fused_call(libs["tile_gemm_prologue"], x, y))
    rates = (ctypes.c_double * 2)()
    scratch = torch.empty(2 * sms * 128, device=dev, dtype=torch.float64)
    lib = libs["dmma"]
    lib.dmma_rates.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    if lib.dmma_rates(scratch.data_ptr(), 2 * sms, rates):
        raise RuntimeError("the DMMA benchmark failed")
    out["dmma_tflops"] = {"m8n8k4": rates[0], "m16n8k4": rates[1]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
