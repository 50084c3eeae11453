#!/usr/bin/env python3
"""Where a dft_stage launch spends its time, phase by phase, on one card.

    python3 dft_probe.py [--reps N]

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
non-zero.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

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
    out_dir = os.path.join(cf.BUILD_DIR, "dft_probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cf.CSRC_DIR, "dft_kernels.cu")) as f:
        src = instrumented_source(f.read())
    cu, so = os.path.join(out_dir, "dft_probe.cu"), os.path.join(out_dir, "libdft_probe.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([cf._nvcc(), *cf.NVCC_FLAGS, "-I", cf.CSRC_DIR, "-shared", cu, "-o", so],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    P_, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.h2_dft_stage.argtypes = [I, P_, P_, P_, P_, I64, P_, I64, I64, I64, I64, P_]
    lib.read_marks.argtypes = [P_, I]
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
