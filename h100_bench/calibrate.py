"""Readings of the numbers that decide ``correct``, for setting their limits.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--variants program,control,half] [--out readings.jsonl]

For each seed, one set-up of the cell (the program's first steps), then
the float32 reference, and each variant's readings against it, one JSON
line each:

* ``program``: the program as the configuration states it (a sound run:
  the lower readings);
* ``control``: the next lower precision in the program's place: the
  program's own lower path where the cell names one (``control`` holds
  ``overrides``), else the reference computed in the cell's
  ``control.quant``;
* ``half``: the fault of a batch of which half is left out, planted in
  the reference put in the program's place;
* the name of a precision of ``reference.train.QUANTS``: the reference
  computed in it.

No window is run.  Runs on the card only, as ``run.py`` does.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

from h100_bench import harness  # noqa: E402
from h100_bench.reference import compare, train  # noqa: E402


def _ctx(cell, seed, device, tmp, overrides=None):
    from h100_bench.run import Ctx

    return Ctx(cell, seed, device, tmp, overrides)


def readings(cell, seed: int, variants, device: str = "cuda",
             bench_dir: Path = harness.HERE):
    """-> {variant: readings} for one seed."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="h100_bench_cal_") as tmp:
        job = harness.driver(cell.kind, bench_dir).make(_ctx(cell, seed, device, tmp))
        job.prepare()
        job.free()
        ref = job.reference()

        def against(got):
            return compare.readings(got["losses"], ref["losses"], got["grad"],
                                    ref["grad"], got["change"], ref["change"])

        for v in variants:
            if v == "program":
                out[v] = against(job.program)
            elif v == "half":
                out[v] = against(job.reference(half=True))
            elif v in train.QUANTS:
                out[v] = against(job.reference(quant=v))
            elif v == "control" and "overrides" in cell.spec["control"]:
                sub = os.path.join(tmp, "control")
                os.makedirs(sub)
                other = harness.driver(cell.kind, bench_dir).make(
                    _ctx(cell, seed, device, sub, cell.spec["control"]["overrides"]))
                other.prepare()
                other.free()
                out[v] = against(other.program)
            elif v == "control":
                out[v] = against(job.reference(quant=cell.spec["control"]["quant"]))
            else:
                raise ValueError(f"unknown variant {v!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,control,half")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    variants = args.variants.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(cell, seed, variants)
        for v, r in got.items():
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "variant": v, **r,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
