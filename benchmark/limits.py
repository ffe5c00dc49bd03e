"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/limits.py --workload <cell> --seeds 1 2 .. --control-seeds 1 2 3 \
        [--seconds 3] [--out chiprun_out/limits.jsonl]

For every seed: the program built from that seed's weights and traffic as a
run builds it, a short closed-loop window at the cell's own size, and each
number compared between the requests a run would check and the plain
reference (the program's readings; the limit goes above their largest).
For the control seeds also the control: the reference itself in the
precision step below the configuration's (``workloads/<cell>.json``
``control``: int4 codes for int8, TF32 for float32) put in the program's
place, against the reference (its smallest reading bounds the limit from
above), and for information the reference with its bf16 convolutions
summed in another order (``bf16_reorder``).  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    cell = harness.load_cell(args.workload)
    own, ctrl = harness.common.Numerics(), harness.control_numeric(cell)
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        row = {"cell": cell.name, "seed": seed}
        with torch.inference_mode():
            s = harness.setup(cell, seed, "cuda")
            keep = set(harness.check_indices(cell, seed, s.image_s, args.seconds))
            w = harness.run_window(s, args.seconds, keep)
            weights, tr, calib_x = s.weights, s.traffic, s.calib_x
            outs = {i: w.kept[i] for i in sorted(keep) if i in w.kept} or dict(w.kept)
            row.update(completed=w.completed, failed=w.failed, checked=sorted(outs))
            del s, w
            gc.collect()
            torch.cuda.empty_cache()
            tr0 = time.perf_counter()
            refs = harness.reference_outputs(cell, weights, tr, calib_x, sorted(outs), "cuda", own)
            row["reference_s"] = time.perf_counter() - tr0
            if seed in args.seeds:
                row["program"] = _worst(outs, refs)
            if seed in args.control_seeds:
                ctl = harness.reference_outputs(cell, weights, tr, calib_x, sorted(outs), "cuda", ctrl)
                row["control"] = _worst(ctl, refs)
                alt = harness.reference_outputs(cell, weights, tr, calib_x, sorted(outs), "cuda",
                                                harness.common.Numerics(bf16_via_f32=True))
                row["bf16_reorder"] = _worst(alt, refs)
            del weights, refs
            gc.collect()
            torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    for key in ("program", "control", "bf16_reorder"):
        vals = [r[key]["diff_share"] for r in rows if key in r]
        if vals:
            print(f"{cell.name} {key}: diff_share max {max(vals)!r} min {min(vals)!r} over {len(vals)} seeds",
                  flush=True)
    return 0


def _worst(outs: dict, refs: dict) -> dict:
    worst: dict = {}
    for i, o in outs.items():
        for k, v in harness.compare(o, refs[i]).items():
            worst[k] = max(worst.get(k, v), v)
    return worst


if __name__ == "__main__":
    sys.exit(main())
