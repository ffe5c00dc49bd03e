"""The benchmark of image_enhance_keras_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  Prints
diagnostics on standard error (the card, the build, set-up, the window,
the checked numbers with their limits last) and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the window),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last.  Exits
non-zero, printing no result, without enough CUDA devices, when the
program is missing, or when a forbidden module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches at fixed paths inside the checkout (torch's jiterator, the CUDA driver's JIT)
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", os.path.join(_ROOT, ".bench_cache", "torch_kernels"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(_ROOT, ".bench_cache", "nv"))
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    chips = next(w["chips"] for w in json.load(open(os.path.join(_ROOT, "BENCHMARK.json")))["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    harness.log(f"cell {cell.name}: config {cell.config['name']}, seed {args.seed}, {args.seconds} s, "
                f"trace {args.trace}; torch {torch.__version__} (CUDA {torch.version.cuda}) on "
                f"{torch.cuda.get_device_name(0)}")
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded in this process: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
