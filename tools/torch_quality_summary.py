#!/usr/bin/env python
"""Summary of a quality rehearsal (``tools/torch_quality.sh``).

Reads the distill CLI's log of metrics (the ``Grand_Loss`` rows of the
``logged_files/*.jsonl`` in the work directory) and the eval CLI's output
``eval_{distilled,init,random}.log`` (the eval
CLI's ``--std True`` lines ``Mean/r_mean = X  Std/r_mean = Y`` and its
``Evaluate_NN: ...`` lines), and prints one line per set, the grand loss
at the first and last logged iteration, each phase's wall seconds, whether
the distilled set's mean r_mean lies above the init's and the random
control's by more than two standard errors of the distilled students
(std / sqrt(n)), the card (``card.txt``: ``nvidia-smi``'s name and power
limit, written by the recipe), and last, one JSON object with all of it.

Usage::

    python tools/torch_quality_summary.py <work_dir> [name=unix_seconds ...]
    python tools/torch_quality_summary.py <work_dir> <work_dir> ...
    python tools/torch_quality_summary.py --welch <run> ... -- <run> ...

The ``name=t`` pairs are the phases' start times in order, the last one
the end; each phase's wall time is the next start less its own.  Given
several work directories (rehearsals at several seeds, or their copied
logs, or a run's three mean r_means written ``distilled/init/random``),
it prints each run's three mean r_means and card, and tests the
order on the runs' differences, distilled less init and distilled less
random: each difference's mean over the runs must exceed two standard
errors of it (sample std / sqrt(runs)), so the spread between runs
counts, not only the spread between the students of one run.

``--welch`` compares two groups of rehearsals (say, the JAX package's runs
and the port's): for each difference, distilled less init and distilled
less random, Welch's two-sided t-test between the groups' per-run values
(unequal variances, Welch-Satterthwaite degrees of freedom), and whether
it rejects at 5%.  A run is a work directory, or its three mean r_means
written ``distilled/init/random``.  Where a run is given as one number
it is a distill run's gain (below), and the test is on the gains: a work
directory then gives its own.

A headline-scale run (``tools/torch_quality_nfnet.sh``) adds, from its
``distill.log`` and JSONL: the r_mean of each eval block of the distill
CLI (its students' values, mean and sample std), the gain (the last
block's mean less the iteration-0 block's), every grand loss and the
ratio of the last to iteration 0's, the wrapper's kernel launches and
seconds per outer step (the median and mean interval between step calls,
those that hold an eval block left out), and the allocator's peak after
each block (``MDD_DEBUG_HBM=1``).  ``--rule`` holds such runs to the
decision rule R1-R6 of PERF.md section 6::

    python tools/torch_quality_summary.py --rule seeds=<w0>,<w1>,<w2> \
        off=<kernels-off w0> resume=<resumed w0> repeat=<second w0> \
        soak=<leg 1>[,<leg 2> ...]

Each criterion is judged when its runs are given; the last line is one
JSON object with every figure and verdict.
"""

import glob
import json
import math
import os
import re
import statistics
import sys

SETS = ("distilled", "init", "random")
MEAN = re.compile(r"Mean/r_mean = ([-+0-9.eE]+)\s+Std/r_mean = ([-+0-9.eE]+)")
STUDENT = re.compile(r"^Evaluate_\d+: .*\br_mean=([-+0-9.eE]+)", re.M)
PEAK = re.compile(r"^\[hbm post-eval it=(\d+)\] .*peak=(\d+) MiB", re.M)
WRAPPER = "distill wrapper: "
#: the JAX package's gains in r_mean from the real-pair init at the
#: headline scale (QUALITY.md:70-72, :96-97 (two students' mean),
#: :150-152, :173-174)
JAX_GAINS = (15.52, 16.77, 5.47, 18.18)
#: the soak's eval blocks that R6 reads: the first is the reference
SOAK_BLOCKS = (100, 200, 300, 400)


def read(path):
    with open(path) as f:
        return f.read()


def summarize(work, stamps=()):
    out = {"sets": {}, "phase_s": {}}
    for name in SETS:
        path = os.path.join(work, f"eval_{name}.log")
        if not os.path.exists(path) and os.path.exists(
                os.path.join(work, "distill.log")):
            continue   # a headline-scale run scored by its eval blocks only
        text = read(path)
        m = MEAN.search(text)
        if m is None:
            raise SystemExit(f"no Mean/r_mean line in eval_{name}.log")
        n = len(STUDENT.findall(text))
        out["sets"][name] = {"mean": float(m.group(1)),
                             "std": float(m.group(2)), "n": n}
    losses, block_its = [], []
    for path in sorted(glob.glob(os.path.join(work, "logged_files",
                                              "*.jsonl"))):
        for line in read(path).splitlines():
            row = json.loads(line)
            if "Grand_Loss" in row:
                losses.append([row["step"], row["Grand_Loss"]])
            if "Mean/r_mean" in row:
                block_its.append(row["step"])
    if losses:
        out["loss_first"], out["loss_last"] = losses[0], losses[-1]
    if os.path.exists(os.path.join(work, "distill.log")):
        out.update(distill_run(read(os.path.join(work, "distill.log")),
                               losses, block_its))
    for (name, t), (_, t_next) in zip(stamps, stamps[1:]):
        out["phase_s"][name] = round(t_next - t, 3)
    card = os.path.join(work, "card.txt")
    out["card"] = read(card).strip() if os.path.exists(card) else None
    return _order(out) if len(out["sets"]) == len(SETS) else out


def distill_run(log, losses, block_its):
    """A headline-scale run's distill figures (the module docstring)."""
    blocks, cur = [], None
    for line in log.splitlines():
        m = STUDENT.match(line)
        if m:
            if line.startswith("Evaluate_00:"):
                cur = []
                blocks.append(cur)
            cur.append(float(m.group(1)))
    out = {"losses": losses, "blocks": {}}
    for it, vals in zip(block_its, blocks):
        out["blocks"][it] = {"values": vals, "mean": sum(vals) / len(vals),
                             "std": _sd(vals), "n": len(vals)}
    b = out["blocks"]
    if 0 in b and len(b) > 1:
        last = b[max(b)]
        out["gain"] = last["mean"] - b[0]["mean"]
        out["gain_se"] = math.sqrt(sum(v["std"] ** 2 / v["n"]
                                       for v in (b[0], last)))
    by_step = dict(map(tuple, losses))
    if 0 in by_step and losses:
        out["loss_ratio"] = losses[-1][1] / by_step[0]
    out["losses_finite"] = all(math.isfinite(v) for _, v in losses)
    out["peak_mib"] = {int(i): int(v) for i, v in PEAK.findall(log)}
    wrap = [line[len(WRAPPER):] for line in log.splitlines()
            if line.startswith(WRAPPER)]
    if wrap:
        w = json.loads(wrap[-1])
        out["launches"] = w["launches"]
        out["nan_bailout_it"] = w["nan_bailout_it"]
        out["wall_s"] = w["wall_s"]
        # the call of step it+1 less step it's, unless an eval block
        # ran between them
        first = losses[0][0] if losses else 0
        ivs = [t1 - t0 for k, (t0, t1) in enumerate(
            zip(w["step_calls_s"], w["step_calls_s"][1:]))
            if first + k + 1 not in b]
        if ivs:
            out["s_per_step"] = {"median": statistics.median(ivs),
                                 "mean": statistics.fmean(ivs),
                                 "n": len(ivs)}
    return out


def _sd(vals):
    """Sample standard deviation (0 for one value)."""
    return statistics.stdev(vals) if len(vals) > 1 else 0.0


def across(works):
    """Several rehearsals: each run's mean r_mean per set, and the order
    tested on the per-run differences of the distilled set's mean from
    the init's and the random control's."""
    runs = [run_means(w) for w in works]
    out = {"runs": [{"work": w, "card": summarize(w)["card"]
                     if os.path.isdir(w) else None, **m}
                    for w, m in zip(works, runs)], "diffs": {}}
    n = len(runs)
    for k in ("init", "random"):
        d = [m["distilled"] - m[k] for m in runs]
        std = _sd(d)
        out["diffs"][k] = {"values": d, "mean": sum(d) / n, "std": std,
                           "two_se": 2 * std / math.sqrt(n)}
    out["order_holds"] = all(v["mean"] > v["two_se"]
                             for v in out["diffs"].values())
    return out


def run_means(run):
    """A work directory's mean r_mean per set, or a literal
    ``distilled/init/random`` triple's."""
    if os.path.isdir(run):
        return {k: v["mean"] for k, v in summarize(run)["sets"].items()}
    return dict(zip(SETS, (float(v) for v in run.split("/"))))


def welch(runs_a, runs_b, alpha=0.05):
    """Welch's two-sided t-test between two groups of runs, on each
    per-run difference of the distilled set from the init and the random
    control; or, where a run is given as one number, on the distill
    runs' gains."""
    from scipy import stats

    def test(da, db):
        res = stats.ttest_ind(da, db, equal_var=False)
        return {"a": da, "b": db, "mean_a": sum(da) / len(da),
                "mean_b": sum(db) / len(db), "t": float(res.statistic),
                "df": float(res.df), "p": float(res.pvalue),
                "differs": bool(res.pvalue < alpha)}

    if any(_number(r) for r in (*runs_a, *runs_b)):
        return {"tests": {"gain": test(*([float(r) if _number(r) else
                                          summarize(r)["gain"] for r in runs]
                                         for runs in (runs_a, runs_b)))}}
    groups = [[run_means(r) for r in runs] for runs in (runs_a, runs_b)]
    out = {"a": groups[0], "b": groups[1], "tests": {}}
    for k in ("init", "random"):
        out["tests"][k] = test(*([m["distilled"] - m[k] for m in g]
                                 for g in groups))
    return out


def _number(run):
    try:
        float(run)
    except ValueError:
        return False
    return True


def rule(seeds=(), off=None, resume=None, repeat=None, soak=()):
    """The decision rule R1-R6 (PERF.md section 6) over headline-scale
    runs: ``seeds`` the recipe at several seeds (the first at the seed of
    the others), ``off`` its kernels-off rerun, ``resume`` its resumed
    run, ``repeat`` a second uninterrupted run, ``soak`` the soak's legs
    in order."""
    runs = {w: summarize(w) for w in (*seeds, off, resume, repeat, *soak)
            if w}
    out = {"runs": runs, "verdict": {}}
    v = out["verdict"]
    a = [runs[w] for w in seeds]

    def loss(r, it):
        return dict(map(tuple, r["losses"]))[it]

    if a:
        v["R1"] = all(r["losses_finite"] and r["loss_ratio"] <= 0.5
                      for r in a)
        v["R2"] = all(r["blocks"][max(r["blocks"])]["mean"]
                      > r["blocks"][0]["mean"] for r in a)
    if len(a) > 1:
        gains = [r["gain"] for r in a]
        two_se = 2 * _sd(gains) / math.sqrt(len(gains))
        w = welch(gains, list(JAX_GAINS))["tests"]["gain"]
        out["R3"] = {"gains": gains, "mean": sum(gains) / len(gains),
                     "two_se": two_se, "welch": w}
        v["R3"] = out["R3"]["mean"] > two_se and not w["differs"]
    if a and off:
        b, a0 = runs[off], a[0]
        last = max(a0["blocks"])
        half = [it for it, _ in a0["losses"] if it > last // 2]
        mean = [sum(loss(r, it) for it in half) / len(half) for r in (a0, b)]
        out["R4"] = {
            "loss0_rel": abs(loss(b, 0) - loss(a0, 0)) / abs(loss(a0, 0)),
            "mean_loss_rel": abs(mean[1] - mean[0]) / abs(mean[0]),
            "gain_diff": b["gain"] - a0["gain"],
            "two_se": 2 * math.hypot(a0["gain_se"], b["gain_se"])}
        r4 = out["R4"]
        v["R4"] = (r4["loss0_rel"] <= 2e-2 and r4["mean_loss_rel"] <= 0.05
                   and abs(r4["gain_diff"]) < r4["two_se"])
    if a and resume:
        c = runs[resume]
        its = [it for it, _ in c["losses"]]

        def dist(r):
            return max(abs(loss(r, it) - loss(a[0], it)) for it in its)

        out["R5"] = {"steps": [its[0], its[-1]], "max_abs_diff": dist(c),
                     "bitwise": dist(c) == 0.0}
        if repeat:
            out["R5"]["repeat_max_abs_diff"] = dist(runs[repeat])
        v["R5"] = out["R5"]["bitwise"] or (
            repeat is not None
            and dist(c) <= out["R5"]["repeat_max_abs_diff"])
    if soak:
        legs = [runs[w] for w in soak]
        blocks = {it: bl for r in legs for it, bl in r["blocks"].items()}
        peaks = {it: p for r in legs for it, p in r["peak_mib"].items()}
        later = [it for it in SOAK_BLOCKS[1:] if it in blocks]
        out["R6"] = {
            "r_mean": {it: blocks[it]["mean"] for it in sorted(blocks)},
            "missing_blocks": [it for it in SOAK_BLOCKS if it not in blocks],
            "peak_mib": peaks, "peak_growth": (
                peaks[SOAK_BLOCKS[-1]] / peaks[SOAK_BLOCKS[0]] - 1
                if SOAK_BLOCKS[-1] in peaks and SOAK_BLOCKS[0] in peaks
                else None),
            "s_per_step": [r.get("s_per_step") for r in legs]}
        v["R6"] = (not out["R6"]["missing_blocks"]
                   and all(r["losses_finite"] for r in legs)
                   and all(blocks[it]["mean"]
                           >= blocks[SOAK_BLOCKS[0]]["mean"] - 3.0
                           for it in later)
                   and out["R6"]["peak_growth"] is not None
                   and abs(out["R6"]["peak_growth"]) <= 0.01)
    return out


def _order(out):
    """Whether the distilled set's mean lies above the init's and the
    random control's by more than 2 standard errors of its students."""
    d = out["sets"]["distilled"]
    se = d["std"] / math.sqrt(max(d["n"], 1))
    out["two_se"] = 2 * se
    out["order_holds"] = all(d["mean"] - out["sets"][k]["mean"] > 2 * se
                             for k in ("init", "random"))
    return out


def _run_line(r):
    """A headline-scale run's figures, one line."""
    parts = ["r_mean " + ", ".join(
        f"{it}: {b['mean']:.4f} ± {b['std']:.4f}"
        for it, b in sorted(r["blocks"].items()))]
    if "gain" in r:
        parts.append(f"gain {r['gain']:.4f} (s.e. {r['gain_se']:.4f})")
    if "loss_ratio" in r:
        parts.append(f"grand loss ratio {r['loss_ratio']:.4f}")
    parts.append(f"losses finite {r['losses_finite']}")
    if "s_per_step" in r:
        parts.append(f"s/step median {r['s_per_step']['median']:.4f}")
    parts.append(f"peak MiB {r['peak_mib']}")
    parts.append(f"launches {r.get('launches')}")
    return "; ".join(parts)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--welch"]:
        cut = argv.index("--")
        s = welch(argv[1:cut], argv[cut + 1:])
        for k, v in s["tests"].items():
            name = "gain" if k == "gain" else f"distilled - {k}"
            print(f"{name}: a {v['mean_a']:.4f} over {len(v['a'])} "
                  f"runs, b {v['mean_b']:.4f} over {len(v['b'])}; Welch t "
                  f"{v['t']:.4f}, df {v['df']:.2f}, p {v['p']:.4f}: "
                  f"{'differs' if v['differs'] else 'no difference'} at 5%")
        print(json.dumps(s))
        return s
    if argv[:1] == ["--rule"]:
        kw = dict(a.split("=", 1) for a in argv[1:])
        s = rule(**{k: (v.split(",") if k in ("seeds", "soak") else v)
                    for k, v in kw.items()})
        for w, r in s["runs"].items():
            print(f"run {w}: " + _run_line(r))
        for k in ("R3", "R4", "R5", "R6"):
            if k in s:
                print(f"{k}: " + json.dumps(s[k]))
        for k, ok in s["verdict"].items():
            print(f"{k}: {'holds' if ok else 'FAILS'}")
        print(json.dumps(s))
        return s
    works = [a for a in argv if "=" not in a]
    stamps = [(a.split("=")[0], float(a.split("=")[1])) for a in argv
              if "=" in a]
    if len(works) > 1:
        s = across(works)
        for r in s["runs"]:
            print("run {work}: r_mean distilled {distilled:.4f} init "
                  "{init:.4f} random {random:.4f} (card: {card})".format(**r))
        for k, v in s["diffs"].items():
            print(f"distilled - {k} over {len(works)} runs: "
                  f"{v['mean']:.4f} ± {v['std']:.4f}, 2 s.e. "
                  f"{v['two_se']:.4f}")
        print(f"distilled above init and random by more than 2 s.e. of "
              f"the runs' differences: {s['order_holds']}")
        print(json.dumps(s))
        return s
    s = summarize(works[0], stamps)
    for name, v in s["sets"].items():
        print(f"r_mean {name}: {v['mean']:.4f} ± {v['std']:.4f} "
              f"(n={v['n']})")
    if "loss_first" in s:
        print("grand loss: iter {} {:.4f} -> iter {} {:.4f}".format(
            *s["loss_first"], *s["loss_last"]))
    print("phase seconds: " + " ".join(
        f"{k} {v:.1f}" for k, v in s["phase_s"].items()))
    if "two_se" in s:
        print(f"distilled above init and random by more than 2 s.e. "
              f"({s['two_se']:.4f}): {s['order_holds']}")
    if "blocks" in s:
        print(_run_line(s))
    print(f"card: {s['card']}")
    print(json.dumps(s))
    return s


if __name__ == "__main__":
    main()
