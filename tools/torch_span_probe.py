#!/usr/bin/env python3
"""What the program's spans cost and show on the card.

    python3 tools/torch_span_probe.py --out FILE [--distill_rounds 16]
        [--expert_rounds 20] [--seed N] [--toy]

Runs the benchmark's own jobs (``h100_bench``'s drivers: the
``nfnet_l0.distill_f32`` outer step and the ``nfnet_l0.expert`` trainer
step, each after its set-up and warm steps) and writes one JSON object
to ``--out``:

* ``recorded_in_profile``: the spans a device-only profile (as
  ``h100_bench/trace.py`` takes) records; empty means spans never turn
  on in the benchmark's profiled stretch, and the probe stops there;
* ``disabled_span_ns``: the host's nanoseconds per span with no profiler
  active (least and median of 5 rounds of 200,000), the cost of tracing
  off; ``spans_per_step`` in each job gives what a step pays;
* per job:

  * ``idle_ms_by_span``: the device's idle time in one profiled stretch
    (``busy_ms`` of ``window_ms`` busy), split by the innermost span open
    on the host at that moment;
  * ``spans``: each span's durations (ms), allocator change (GiB) and
    counter gains in that stretch;
  * ``clock`` (that stretch) and ``clock_on_stretches`` (each stretch
    of ``cost_on`` with the spans on): over the kernels whose launch lay
    inside a span, the least time from that span's ``time.time_ns()``
    start to the kernel's start (a negative one puts a kernel before the
    span that launched it, and so before its own launch event, which lies
    inside that span); and over every kernel matched to its launch event
    by correlation id, the least time from the launch to the kernel and
    how many kernels start before their launch (the device's and the
    runtime's clocks disagreeing);
  * ``cost_on``: ``--*_rounds`` rounds of three profiled stretches: spans
    on, spans forced off (each module's ``span`` replaced by the shared
    no-op) and forced off again, in an order that rotates from round to
    round: the walls; each round's ``on / off - 1`` and, as the control
    that shows what two identical stretches differ by, ``off again / off
    - 1``, in percent, with their quartiles and how many rounds read
    above 0.  The cost is resolved only where the first's quartiles lie
    on one side of 0 and the control's do not;
  * ``unprofiled_wall_s``: the same stretch with no profiler.

``--toy`` runs the benchmark's toy cells on the CPU, to rehearse the
probe without a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from h100_bench import harness  # noqa: E402
from h100_bench import run as brun  # noqa: E402

rlog = importlib.import_module(harness.PROGRAM + ".utils.logging")
#: the modules that open spans, each through its own name ``span``
SPAN_MODULES = [importlib.import_module(harness.PROGRAM + m) for m in
                (".engine.distill", ".engine.expert", ".data.pipeline")]
STEPS = {"distill": 2, "expert": 10}      # steps in a profiled stretch
WARM = {"distill": 2, "expert": 10}


def set_spans(on: bool) -> None:
    for m in SPAN_MODULES:
        m.span = rlog.span if on else (lambda name, group=None: rlog._NO_SPAN)


def disabled_span_ns(n: int = 200_000, rounds: int = 5) -> list:
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with rlog.span("x"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            pass
        t2 = time.perf_counter_ns()
        per.append(((t1 - t0) - (t2 - t1)) / n)
    return [min(per), statistics.median(per)]


def profiled(step, steps: int, sync, acts):
    """-> (events, spans, wall_s, (t0_ns, t1_ns)) of ``steps`` steps."""
    rlog.reset()
    sync()
    with profile(activities=acts) as prof:
        a = time.time_ns()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        wall = time.perf_counter() - t0
        b = time.time_ns()
    return prof.profiler.kineto_results.events(), rlog.spans(), wall, (a, b)


def _on_device(e) -> bool:
    return not str(e.device_type()).endswith("CPU")


def _innermost(spans, t: int):
    hold = [s for s in spans if s.start_ns <= t < s.end_ns]
    return max(hold, key=lambda s: s.start_ns) if hold else None


def idle_by_span(events, spans, window) -> tuple:
    """-> ({span name: device idle ms}, busy ms, window ms) in ``window``."""
    dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events if _on_device(e))
    a, b = window
    gaps, cur = [], a
    for s, e in dev:
        if s > cur:
            gaps.append((cur, min(s, b)))
        cur = max(cur, e)
        if cur >= b:
            break
    if cur < b:
        gaps.append((cur, b))
    cuts = sorted({t for s in spans for t in (s.start_ns, s.end_ns)})
    out: dict = {}
    for g0, g1 in gaps:
        pts = [g0] + [t for t in cuts if g0 < t < g1] + [g1]
        for x, y in zip(pts, pts[1:]):
            s = _innermost(spans, (x + y) // 2)
            name = s.name if s else "outside any span"
            out[name] = out.get(name, 0) + (y - x)
    busy = (b - a) - sum(g1 - g0 for g0, g1 in gaps)
    return {k: v / 1e6 for k, v in out.items()}, busy / 1e6, (b - a) / 1e6


def launch_clock(events, spans) -> dict:
    launch = {e.correlation_id(): e.start_ns() for e in events
              if not _on_device(e) and "Launch" in e.name()}
    worst, n, lags = None, 0, []
    for e in events:
        if not _on_device(e) or e.correlation_id() not in launch:
            continue
        ls = launch[e.correlation_id()]
        lags.append(e.start_ns() - ls)
        s = _innermost(spans, ls)
        if s is None:
            continue
        n += 1
        d = e.start_ns() - s.start_ns
        worst = d if worst is None else min(worst, d)
    return {"kernels_checked": n,
            "min_kernel_start_after_span_start_ns": worst,
            "min_kernel_start_after_launch_ns": min(lags, default=None),
            "kernels_before_their_launch": sum(x < 0 for x in lags)}


def span_table(spans) -> dict:
    by: dict = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    return {k: {"ms": [(s.end_ns - s.start_ns) / 1e6 for s in v],
                "mem_delta_gib": [None if s.mem0 is None else
                                  (s.mem1 - s.mem0) / 2 ** 30 for s in v],
                "counts": [s.counts for s in v if s.counts is not None]}
            for k, v in by.items()}


def quartiles(xs: list) -> list:
    return statistics.quantiles(xs, n=4) if len(xs) > 1 else xs * 3


def _pct(a: list, b: list) -> list:
    return [100.0 * (x / y - 1.0) for x, y in zip(a, b)]


def probe_job(kind: str, cell_name: str, seed: int, device: str, root: Path,
              bench_dir: Path, rounds: int) -> dict:
    cell = harness.load_cell(cell_name, root, bench_dir)
    cuda = device == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    steps = STEPS[kind]
    res: dict = {"cell": cell_name, "steps": steps}
    with tempfile.TemporaryDirectory(prefix="span_probe_") as tmp:
        job = harness.driver(cell.kind, bench_dir).make(
            brun.Ctx(cell, seed, device, tmp))
        job.prepare()
        if kind == "distill":
            step = job.step
        else:
            batches = (b for _ in iter(int, 1) for b in job.loader)
            step = lambda: job.trainer.train_batch(*next(batches))  # noqa: E731
        for _ in range(WARM[kind]):
            step()
        sync = job._sync
        sync()
        ev, sp, res["wall_s"], win = profiled(step, steps, sync, acts)
        res["idle_ms_by_span"], res["busy_ms"], res["window_ms"] = \
            idle_by_span(ev, sp, win)
        res["spans"] = span_table(sp)
        res["spans_per_step"] = len(sp) / steps
        res["clock"] = launch_clock(ev, sp)
        modes = ("on", "off", "off_again")
        walls: dict = {m: [] for m in modes}
        res["clock_on_stretches"] = []
        try:
            for k in range(rounds):
                for mode in modes[k % 3:] + modes[:k % 3]:
                    set_spans(mode == "on")
                    ev, sp, wall, _ = profiled(step, steps, sync, acts)
                    walls[mode].append(wall)
                    if mode == "on":
                        res["clock_on_stretches"].append(launch_clock(ev, sp))
        finally:
            set_spans(True)
        on, ctl = (_pct(walls[m], walls["off"]) for m in ("on", "off_again"))
        qo, qc = quartiles(on), quartiles(ctl)
        res["cost_on"] = {
            "walls_s": walls, "on_pct": on, "on_pct_quartiles": qo,
            "on_above": sum(x > 0 for x in on), "control_pct": ctl,
            "control_pct_quartiles": qc,
            "control_above": sum(x > 0 for x in ctl),
            "resolved": (min(qo) > 0 or max(qo) < 0)
            and min(qc) <= 0 <= max(qc)}
        plain = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            sync()
            plain.append(time.perf_counter() - t0)
        res["unprofiled_wall_s"] = plain
        job.free()
    return res


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--distill_rounds", type=int, default=16)
    ap.add_argument("--expert_rounds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=2147480333)
    ap.add_argument("--toy", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    out: dict = {}
    if args.toy:
        sys.path.insert(0, str(ROOT / "h100_bench" / "tests"))
        import bench_toy

        root = bench_toy.make(Path(tempfile.mkdtemp(prefix="span_probe_")))
        bench_dir, device = root / "h100_bench", "cpu"
        cells = {"distill": "toy.distill", "expert": "toy.expert"}
        acts = [ProfilerActivity.CPU]
    else:
        if not torch.cuda.is_available():
            print("torch_span_probe: no CUDA card", file=sys.stderr)
            return 3
        root, bench_dir, device = harness.ROOT, harness.HERE, "cuda"
        cells = {"distill": "nfnet_l0.distill_f32", "expert": "nfnet_l0.expert"}
        out["card"] = harness.card_kind()
        acts = [ProfilerActivity.CUDA]
    rlog.reset()
    with profile(activities=acts):
        with rlog.span("probe"):
            pass
    out["recorded_in_profile"] = [s.name for s in rlog.spans()]
    out["disabled_span_ns"] = disabled_span_ns()
    if not out["recorded_in_profile"]:
        Path(args.out).write_text(json.dumps(out))
        return 1
    for k, (kind, rounds) in enumerate((("distill", args.distill_rounds),
                                        ("expert", args.expert_rounds))):
        out[kind] = probe_job(kind, cells[kind], args.seed + k, device, root,
                              bench_dir, rounds)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out))
    print("span probe: " + json.dumps(
        {k: (v if k not in cells else {
            "idle_ms_by_span": v["idle_ms_by_span"], "clock": v["clock"],
            "cost_on_pct": v["cost_on"]["on_pct_quartiles"],
            "control_pct": v["cost_on"]["control_pct_quartiles"]})
         for k, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
