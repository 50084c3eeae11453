"""One run of one benchmark cell of halo2_lib_tpu_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in BENCHMARK.json once on the NVIDIA card it is
started on: set-up (load, build, keys, inputs from the seed, warm-up), a
window of `--seconds` seconds of requests, then the comparison with the
plain reference. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, also the last lines of standard error). With ``--trace
0`` the metrics are the cell's end-to-end ones, with ``--trace 1`` its
per-layer ones, from a torch.profiler trace of the window.

Exits with another code than 0 and prints no result when there is no card
(or fewer than the cell asks for), when the program cannot be imported,
or when JAX or the JAX package was loaded. ``--cpu`` (tests only) runs a
cell on the CPU with the kernels' plain versions, at the tiny sizes a test
gives it; ``--control`` and ``--fault`` break the timed path on purpose,
to show that the comparison catches it (``PERF.md``).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_lib_tpu")


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program builds its kernels into halo2_lib_tpu_torch/_build/, and
    its SRS files go under _build/params/."""
    build = os.path.join(ROOT, "halo2_lib_tpu_torch", "_build")
    os.environ["PARAMS_DIR"] = os.path.join(build, "params")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def loaded_forbidden() -> list[str]:
    """Top-level names, compared whole, of loaded modules that are JAX or
    the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--control", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cells, session

    cell = cells.load(BENCH_DIR, args.workload)
    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell.chips} CUDA device(s); {have} visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    result = session.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                              args.control, args.fault)
    bad = loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
