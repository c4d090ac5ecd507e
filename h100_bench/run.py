"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA cards.
Set-up (building the program's kernels on a checkout's first run,
weights, inputs, the first steps) is ``setup_s``; then the window runs
for ``--seconds``; then the program's state is freed and the plain
reference follows the first steps from the same inputs, which decides
``correct``.  With ``--trace 0`` the metrics are the cell's end-to-end
ones, with ``--trace 1`` its per-layer ones.  The numbers compared, each
beside its limit, are the last lines on standard error and the result's
last key.  Exit codes: 0 a result; 2 no card, too few cards or a route
override set; 3 a forbidden module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# caches of the program and its libraries at fixed paths in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

from h100_bench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Ctx:
    """What a driver is given: the cell, the seed, the device, a temporary
    directory under the run's ``TMPDIR``, the records, and overrides of the
    job's hyperparameters (the control runs only)."""

    def __init__(self, cell, seed, device, tmpdir, overrides=None):
        self.cell, self.seed, self.device, self.tmpdir = cell, seed, device, tmpdir
        self.overrides = overrides or {}
        self.records = harness.Records(cell.kind, cell.cfg)


def refuse(msg: str, code: int) -> int:
    print(f"h100_bench: {msg}", file=sys.stderr, flush=True)
    return code


def metric_values(cell, res, records, setup_s, trace: bool,
                  bench_dir: Path = harness.HERE) -> dict:
    if not trace:
        vals = {"setup_s": setup_s,
                "peak_hbm_gib": res.get("peak_bytes", 0) / 2 ** 30,
                "outer_steps_per_s": res["steps"] / res["seconds"],
                "expert_images_per_s": res["work"] / res["seconds"]}
        return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    out = {}
    for m in cell.per_layer:
        v = harness.reader(m["name"], bench_dir).read(records)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(args, device: str = "cuda", root: Path = ROOT,
        bench_dir: Path = harness.HERE) -> dict:
    """The run without the look for a card: -> the result line's object."""
    from h100_bench.reference import compare

    cell = harness.load_cell(args.workload, root, bench_dir)
    with tempfile.TemporaryDirectory(prefix="h100_bench_") as tmp:
        ctx = Ctx(cell, args.seed, device, tmp)
        job = harness.driver(cell.kind, bench_dir).make(ctx)
        job.prepare()
        setup_s = time.perf_counter() - T0
        res = job.window(args.seconds, bool(args.trace))
        ctx.records.rate = res["steps"] / res["seconds"]
        ctx.records.trace = res.get("trace")
        peak = res.get("peak_bytes", 0)
        job.free()
        ref = job.reference()
    values = compare.readings(job.program["losses"], ref["losses"],
                              job.program["grad"], ref["grad"],
                              job.program["change"], ref["change"])
    limits = cell.spec["limits"]
    checks = {k: {"value": values[k] if math.isfinite(values[k]) else None,
                  "limit": limits[k]} for k in limits}
    out = {"correct": compare.judge(values, limits) and res["failed"] == 0,
           "attempted": res["steps"], "failed": res["failed"],
           "metrics": metric_values(cell, res, ctx.records, setup_s,
                                    bool(args.trace), bench_dir),
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": harness.card_kind() if device == "cuda" else device,
                      "count": cell.entry["chips"],
                      "memory_peak_bytes": peak}}
    tr = ctx.records.trace
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.wall_s)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": [list(g) for g in tr.gaps]}
    out["laps"] = res["laps"]  # printed to standard error, not in the line
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    found = harness.overrides_set()
    if found:
        return refuse(f"route overrides set: {', '.join(found)}; unset them "
                      f"(the configuration pins every route)", 2)
    import torch

    chips = harness.load_cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return refuse(f"needs {chips} CUDA card(s); found "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                      2)
    out = run(args)
    bad = harness.forbidden_loaded()
    if bad:
        return refuse(f"forbidden modules loaded: {', '.join(bad)}", 3)
    laps = out.pop("laps")
    print(f"window laps (s, one per loop of the window: an outer step or an "
          f"epoch): {' '.join(f'{v:.4f}' for v in laps)}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
