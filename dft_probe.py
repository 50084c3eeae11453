#!/usr/bin/env python3
"""Where a dft_stage launch spends its time, phase by phase, on one card.

    python3 dft_probe.py [--reps N] [--ntt | --mma-rate | --g1-inline]

Builds a copy of halo2_lib_tpu_torch/csrc/dft_kernels.cu with a timestamp
(%globaltimer, ns) taken by each block's thread 0 at its start, after the
staging barrier, after the products, after the column sums and at the end
of its epilogue, into halo2_lib_tpu_torch/_build/dft_probe/ (nvcc), and runs
it at the stage shapes of the k=9 prover's largest transforms (the 2^11
coset forward's two stages, 12 columns; the Poseidon circuit's 105) and of
wide batches of 2^8 and 2^9 points, as a mesh's sub-transforms give them.
Every output is held equal to the package's dft_stage. Prints, per shape, the mean time of a launch (CUDA
events over N launches, host launch path included), each phase's mean over
the blocks, the longest block and the span from the first block's start to
the last block's end, then one JSON line. Without a CUDA device it exits
non-zero. With --ntt it instruments dft_ntt instead (start, staged, each
stage's products and epilogue) at the k=9 and Poseidon transforms, built at
both block heights (8 rows k1 a block, the package's, and 16, by
-DDFT_NTT_KT=16); with --mma-rate it measures the card's mma.sync u8 rate
with 4 to 16 warps an SM (independent products, no memory traffic); with
--g1-inline it times g1_batch_mul's comb at [16, 2^20] built with its
products inlined (-DG1_COMB_MUL=MulInline) against the package's, which
calls one out-of-line copy, in turns.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))


def instrumented_source(src: str) -> str:
    """dft_kernels.cu with the five marks and a reader of the mark buffer."""
    head = (
        '#include "fp256.cuh"\n'
        "__device__ unsigned long long g_marks[1 << 16];\n"
        "__device__ __forceinline__ unsigned long long now_ns() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
        "  return t;\n"
        "}\n"
        'extern "C" int read_marks(unsigned long long* h, int n) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, g_marks, n * 8);\n"
        "}\n"
    )

    def mark(k: int) -> str:
        return ("  if (tid == 0) g_marks[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + "
                f"{k}] = now_ns();\n")

    out = src.replace('#include "fp256.cuh"\n', head, 1)
    anchors = (
        ("  const int64_t RC = (int64_t)R * C;\n", 0),
        ("  __syncthreads();\n\n  // 3. the products", 1),
        ("  __syncthreads();  // every warp has read the tiles: the column sums reuse them\n", 2),
        ("  __syncthreads();\n\n  // 4. the epilogue", 3),
        ("  st_strided(out + l * 16 * RoC + k * (int64_t)C + c, RoC, res);\n", 4),
    )
    for anchor, k in anchors:
        if anchor not in out:
            raise RuntimeError(f"dft_kernels.cu has changed: no anchor for mark {k}")
        if k in (1, 3):
            first, rest = anchor.split("\n", 1)
            out = out.replace(anchor, first + "\n" + mark(k) + rest, 1)
        else:
            out = out.replace(anchor, anchor + mark(k), 1)
    return out


def instrumented_ntt_source(src: str) -> str:
    """dft_kernels.cu with six marks in dft_ntt_k (start, staged, stage 1's
    products and epilogue, stage 2's products, end; the products and
    epilogue marks of a stage's first round, the end mark after its last)
    and a reader of the mark buffer."""
    out = instrumented_source(src)

    def mark(k: str) -> str:
        return f"  if (tid == 0) g_marks[blockIdx.x * 16 + {k}] = now_ns();\n"

    anchors = (
        ("  const int32_t* xl = x + l * 16 * (int64_t)n;\n", "0", False),
        ("  __syncthreads();  // the panels (and the weights) are in place\n", "1", False),
        ("      __syncthreads();\n      if (tid < in_round * DFT_TM * DFT_TN) {",
         "(r0 == 0 ? 2 + 2 * stage : 7)", True),
        ("      __syncthreads();\n    }\n  }\n}", "(stage == 0 ? 3 : 5)", True),
        # inside the staging: own rows staged and written to device memory,
        # the cluster barrier passed; inside stage 1's first epilogue (thread
        # 0): folded, times the twiddle
        ("  cluster.sync();  // every block's rows are in device memory\n", "9", False),
        ("  __syncthreads();\n  for (int it = tid; it < DFT_D * N2; it += DFT_THREADS) {", "8", True),
        ("          Fe v = dft_fold<F>(CS + tid, 256);\n", "(stage == 0 && r0 == 0 ? 10 : 15)",
         False),
        ("          if (aux_on) v = mul<F>(v, aux);\n", "(stage == 0 && r0 == 0 ? 11 : 15)", False),
    )
    for anchor, k, after_first in anchors:
        if anchor not in out:
            raise RuntimeError(f"dft_kernels.cu has changed: no dft_ntt anchor for mark {k}")
        if after_first:
            first, rest = anchor.split("\n", 1)
            out = out.replace(anchor, first + "\n" + mark(k) + rest, 1)
        else:
            out = out.replace(anchor, anchor + mark(k), 1)
    return out


def build_copy(cf, src: str, name: str, defines=()):
    """Compile one CUDA source text (csrc/'s headers on the include path)
    into _build/dft_probe/lib<name>.so and load it; the library and ptxas's
    report."""
    out_dir = os.path.join(cf.BUILD_DIR, "dft_probe")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([cf._nvcc(), *cf.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-Xptxas",
                          "-v", "-I", cf.CSRC_DIR, "-shared", cu, "-o", so],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    return ctypes.CDLL(so), res.stderr


def registers(report: str, kernel: str) -> list:
    """ptxas's 'Used N registers' and spill lines for each instantiation of
    `kernel` in a -v report."""
    out, on = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("spill" in line or "Used" in line):
            out.append(line.split("ptxas info    :")[-1].strip())
    return out


def probe_ntt(libs: dict, cf, torch, rand, reps: int) -> list:
    """dft_ntt's block phases at the k=9 prover's largest transforms (2^11 x
    12 coset forward, 2^9 x 12 inverse) and the Poseidon circuit's (2^11 x
    105), for each block height kt of `libs` ({kt: instrumented library});
    each output held to the package's dft_ntt."""
    from halo2_lib_tpu_torch.ops.limbs import DeviceField
    from halo2_lib_tpu_torch.ops.ntt_mxu import MxuNTT
    from halo2_lib_tpu_torch.utils.fields import FR_BN254

    df = DeviceField(FR_BN254)
    P_, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for lib in libs.values():
        lib.h2_dft_ntt.argtypes = [I] + [P_] * 6 + [I64, P_, P_, I64, I64, I64, P_]
        lib.read_marks.argtypes = [P_, I]
    rows = []
    for label, L, log_n, fwd in (("k=9 2^11 coset forward", 12, 11, True),
                                 ("k=9 2^9 inverse", 12, 9, False),
                                 ("Poseidon 2^11 coset forward", 105, 11, True)):
        mxu = MxuNTT(df, log_n, "cuda")
        n, N1, N2 = mxu.n, 1 << mxu.k1, 1 << mxu.k2
        tw, w1, w2 = mxu._consts[fwd]
        x = rand((L, 16, n))
        pre = rand((16, n)) if fwd else None
        post = None if fwd else mxu.n_inv_mont
        want = cf.dft_ntt(cf.FR, x, w1, w2, tw, pre, post)
        for kt, lib in libs.items():
            out = torch.empty_like(want)
            scratch = torch.empty(L * 32 * -(-N1 // 32) * max(N2, 16) * 8, dtype=torch.int32,
                                  device="cuda")
            args = (0, x.data_ptr(), w1.data_ptr(), w2.data_ptr(), tw.data_ptr(),
                    None if pre is None else pre.data_ptr(),
                    None if post is None else post.data_ptr(), 0 if post is None else 1,
                    out.data_ptr(), scratch.data_ptr(), L, N1, N2,
                    torch.cuda.current_stream().cuda_stream)
            for _ in range(3):
                if lib.h2_dft_ntt(*args):
                    raise RuntimeError("the instrumented dft_ntt failed to launch")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{label}: the instrumented kernel differs from dft_ntt")
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                lib.h2_dft_ntt(*args)
            e1.record()
            torch.cuda.synchronize()
            lib.h2_dft_ntt(*args)
            torch.cuda.synchronize()
            nb = L * (N1 // kt)
            buf = (ctypes.c_ulonglong * (16 * nb))()
            if lib.read_marks(ctypes.addressof(buf), 16 * nb):
                raise RuntimeError("reading the marks failed")
            marks = torch.tensor(list(buf), dtype=torch.float64).reshape(nb, 16) / 1e3  # us
            t = marks[:, :6]
            names = ("staging", "stage 1 products", "stage 1 epilogue", "stage 2 products",
                     "stage 2 epilogue")
            phases = {name: float((t[:, k + 1] - t[:, k]).mean()) for k, name in enumerate(names)}
            # the staging and stage 1's epilogue split
            for name, a_, b_ in (("staging: own rows", 0, 8),
                                 ("staging: written, cluster barrier", 8, 9),
                                 ("staging: panel copied back, weights", 9, 1),
                                 ("stage 1 epilogue, thread 0: twiddle load, fold", 2, 10),
                                 ("stage 1 epilogue, thread 0: twiddle product", 10, 11),
                                 ("stage 1 epilogue, thread 0: digit stores, barrier", 11, 3)):
                phases[name] = float((marks[:, b_] - marks[:, a_]).mean())
            row = {"shape": label, "L": L, "n": n, "kt": kt, "blocks": nb,
                   "launch_ms": e0.elapsed_time(e1) / reps, "phases_us": phases,
                   "longest_block_us": float((t[:, 5] - t[:, 0]).max()),
                   "span_us": float(t[:, 5].max() - t[:, 0].min())}
            rows.append(row)
            print(f"[dft_probe] dft_ntt {label} [{L}, 16, {n}], {kt} rows a block, {nb} blocks: "
                  f"{row['launch_ms']:.4f} ms a launch; block phases (us, mean) "
                  + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
                  + f"; longest block {row['longest_block_us']:.2f} us, span "
                  f"{row['span_us']:.2f} us", flush=True)
    return rows


MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Independent m16n8k32 u8 products (eight accumulators a warp, no memory
// traffic) for `iters` rounds: the card's mma.sync rate at a given number of
// warps an SM.
__global__ void mma_rate(uint32_t* out, int iters) {
  uint32_t acc[8][4];
  for (int u = 0; u < 8; u++)
    for (int e = 0; e < 4; e++) acc[u][e] = 0;
  const uint32_t a = threadIdx.x * 0x01010101u, b = blockIdx.x * 0x01030507u;
  for (int k = 0; k < iters; k++) {
#pragma unroll
    for (int u = 0; u < 8; u++)
      asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
          "{%8, %9}, {%0, %1, %2, %3};"
          : "+r"(acc[u][0]), "+r"(acc[u][1]), "+r"(acc[u][2]), "+r"(acc[u][3])
          : "r"(a), "r"(a + u), "r"(a ^ u), "r"(a), "r"(b + u), "r"(b));
  }
  uint32_t s = 0;
  for (int u = 0; u < 8; u++)
    for (int e = 0; e < 4; e++) s += acc[u][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_mma_rate(uint32_t* out, int blocks, int threads, int iters, void* stream) {
  mma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def probe_g1_inline(cf, torch, reps: int = 5) -> list:
    """g1_batch_mul's comb at [16, 2^20] (gen_srs(19)'s 2n lanes) built with
    its products inlined against the package's build (out-of-line products):
    the outputs held equal, each warmed by `reps` launches, then timed in
    turns package, inlined, inlined, package, twice."""
    from halo2_lib_tpu_torch.ops.ec_device import DeviceCurve
    from halo2_lib_tpu_torch.ops.limbs import DeviceField
    from halo2_lib_tpu_torch.utils.curves import BN254_G1
    from halo2_lib_tpu_torch.utils.fields import FR_BN254

    with open(os.path.join(cf.CSRC_DIR, "ec_kernels.cu")) as f:
        lib, report = build_copy(cf, f.read(), "g1_inline", ("G1_COMB_MUL=MulInline",))
    P_ = ctypes.c_void_p
    lib.h2_g1_batch_mul.argtypes = [P_] * 5 + [ctypes.c_int64, P_]
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    Gx, Gy = dc.pack_points_affine([BN254_G1.g], "cuda")
    n = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(19)
    sc = torch.randint(0, 1 << 16, (16, n), generator=gen, dtype=torch.int32, device="cuda")
    sc[15] %= FR_BN254.p >> 240
    table = cf.g1_comb_table(Gx, Gy)
    outs = [torch.empty_like(sc) for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream

    def inlined():
        if lib.h2_g1_batch_mul(sc.data_ptr(), table.data_ptr(), *(o.data_ptr() for o in outs), n,
                               stream):
            raise RuntimeError("the inlined g1_batch_mul failed to launch")

    want = cf.g1_batch_mul(sc, Gx, Gy)
    inlined()
    torch.cuda.synchronize()
    if any(not torch.equal(a, b) for a, b in zip(outs, want)):
        raise AssertionError("the inlined comb differs from the package's")
    runs = {"out-of-line products (the package's)": lambda: cf.g1_batch_mul(sc, Gx, Gy),
            "inlined products": inlined}
    for fn in runs.values():
        for _ in range(reps):
            fn()
    turns = {k: [] for k in runs}
    for k in 2 * (list(runs) + list(runs)[::-1]):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            runs[k]()
        e1.record()
        torch.cuda.synchronize()
        turns[k].append(e0.elapsed_time(e1) / reps)
    regs = registers(report, "g1_fixed_mul_k")
    print("[dft_probe] g1_batch_mul at [16, 2^20] (ms, CUDA events, turns): "
          + json.dumps(turns) + "; the inlined build's ptxas: " + json.dumps(regs), flush=True)
    return [{"shape": [16, n], "turns_ms": turns, "inlined_ptxas": regs}]


def probe_mma_rate(cf, torch) -> list:
    """m16n8k32 u8 products an SM a microsecond by mma.sync, with 4 to 16
    warps an SM (one block an SM), at the card's current SM clock."""
    lib, _ = build_copy(cf, MMA_RATE_SRC, "mma_rate")
    lib.run_mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.strip()
    rows, iters = [], 2048
    for threads in (128, 256, 512):
        out = torch.empty(sms * threads, dtype=torch.int32, device="cuda")
        args = (out.data_ptr(), sms, threads, iters, torch.cuda.current_stream().cuda_stream)
        lib.run_mma_rate(*args)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            lib.run_mma_rate(*args)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / 5
        mmas = threads // 32 * iters * 8  # a warp's products, per SM
        row = {"warps_per_sm": threads // 32, "ms": ms,
               "mma_per_sm_per_us": mmas / (ms * 1e3),
               "u8_macs_per_s": sms * mmas * 4096 / (ms * 1e-3)}
        rows.append(row)
        print(f"[dft_probe] mma.sync m16n8k32 u8, {threads // 32} warps an SM: {ms:.4f} ms, "
              f"{row['mma_per_sm_per_us']:.1f} products an SM a us, "
              f"{row['u8_macs_per_s'] / 1e12:.1f} T MAC/s (max SM clock {clock} MHz)", flush=True)
    return rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("dft_probe: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from halo2_lib_tpu_torch.ops import cuda_field as cf
    from halo2_lib_tpu_torch.ops.ntt_mxu import dft_planes_np
    from halo2_lib_tpu_torch.utils.fields import FR_BN254

    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 20
    with open(os.path.join(cf.CSRC_DIR, "dft_kernels.cu")) as f:
        src = f.read()
    cf.load()
    dev = torch.device("cuda")
    p = FR_BN254.p
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape):
        x = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32, device=dev)
        x[..., 15, :] %= p >> 240
        return x

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if "--mma-rate" in sys.argv:
        rows = probe_mma_rate(cf, torch)
        print(smi, flush=True)
        print(json.dumps({"mma_rate": rows, "device": smi}), flush=True)
        return
    if "--g1-inline" in sys.argv:
        rows = probe_g1_inline(cf, torch)
        print(smi, flush=True)
        print(json.dumps({"g1_inline": rows, "device": smi}), flush=True)
        return
    if "--ntt" in sys.argv:
        # both block heights, one nvcc each, started together
        nsrc = instrumented_ntt_source(src)
        with ThreadPoolExecutor(2) as ex:
            built = list(ex.map(lambda kt: build_copy(cf, nsrc, f"dft_probe_ntt{kt}",
                                                      (f"DFT_NTT_KT={kt}",)), (8, 16)))
        libs = {kt: lib for kt, (lib, _) in zip((8, 16), built)}
        for kt, (_, report) in zip((8, 16), built):
            print(f"[dft_probe] dft_ntt_k, {kt} rows a block (instrumented), ptxas: "
                  + json.dumps(registers(report, "dft_ntt_k")), flush=True)
        rows = probe_ntt(libs, cf, torch, rand, reps)
        print(smi, flush=True)
        print(json.dumps({"dft_probe_ntt": rows, "device": smi}), flush=True)
        return
    lib, _ = build_copy(cf, instrumented_source(src), "dft_probe")
    P_, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.h2_dft_stage.argtypes = [I, P_, P_, P_, P_, I64, P_, I64, I64, I64, I64, P_]
    lib.read_marks.argtypes = [P_, I]
    # (label, L, R, C, pre, post): stage 1 takes the coset's pre row and the
    # twiddle block, stage 2 no diagonal (forward)
    shapes = (
        ("k=9 2^11 stage 1", 12, 64, 32, True, True),
        ("k=9 2^11 stage 2", 12, 32, 64, False, False),
        ("Poseidon 2^11 stage 1", 105, 64, 32, True, True),
        ("2^9 stage 1, 128 columns", 128, 32, 16, False, True),
        ("2^8 stage 1, 256 columns", 256, 16, 16, False, True),
    )
    rows = []
    for label, L, R, C, with_pre, with_post in shapes:
        root = FR_BN254.nth_root_of_unity(R.bit_length() - 1)
        planes = torch.from_numpy(dft_planes_np(p, root, R)).to(dev)
        x = rand((L, 16, R * C)).reshape(L, 16, R, C)
        pre = rand((16, R * C)).reshape(16, R, C) if with_pre else None
        post = rand((16, R * C)).reshape(16, R, C) if with_post else None
        want = cf.dft_stage(cf.FR, x, planes, pre, post)
        out = torch.empty_like(want)
        args = (0, x.data_ptr(), planes.data_ptr(), None if pre is None else pre.data_ptr(),
                None if post is None else post.data_ptr(), 0 if post is None else R * C,
                out.data_ptr(), L, R, R, C, torch.cuda.current_stream().cuda_stream)
        for _ in range(3):
            if lib.h2_dft_stage(*args):
                raise RuntimeError("the instrumented dft_stage failed to launch")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: the instrumented kernel differs from dft_stage")
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            lib.h2_dft_stage(*args)
        e1.record()
        torch.cuda.synchronize()
        lib.h2_dft_stage(*args)
        torch.cuda.synchronize()
        nb = -(-L * C // 8) * -(-R // 16)
        buf = (ctypes.c_ulonglong * (8 * nb))()
        if lib.read_marks(ctypes.addressof(buf), 8 * nb):
            raise RuntimeError("reading the marks failed")
        t = torch.tensor(list(buf), dtype=torch.float64).reshape(nb, 8)[:, :5] / 1e3  # us
        phases = {name: float((t[:, k + 1] - t[:, k]).mean())
                  for k, name in enumerate(("staging", "products", "column_sums", "epilogue"))}
        row = {"shape": label, "L": L, "R": R, "C": C, "blocks": nb,
               "launch_ms": e0.elapsed_time(e1) / reps,
               "phases_us": phases, "longest_block_us": float((t[:, 4] - t[:, 0]).max()),
               "span_us": float(t[:, 4].max() - t[:, 0].min())}
        rows.append(row)
        print(f"[dft_probe] {label} [{L}, 16, {R}, {C}], {nb} blocks: {row['launch_ms']:.4f} ms a "
              f"launch; block phases (us, mean) "
              + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
              + f"; longest block {row['longest_block_us']:.2f} us, span {row['span_us']:.2f} us",
              flush=True)
    print(smi, flush=True)
    print(json.dumps({"dft_probe": rows, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
