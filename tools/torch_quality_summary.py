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
written ``distilled/init/random``.
"""

import glob
import json
import math
import os
import re
import sys

SETS = ("distilled", "init", "random")
MEAN = re.compile(r"Mean/r_mean = ([-+0-9.eE]+)\s+Std/r_mean = ([-+0-9.eE]+)")
STUDENT = re.compile(r"^Evaluate_\d+: .*\br_mean=([-+0-9.eE]+)", re.M)


def read(path):
    with open(path) as f:
        return f.read()


def summarize(work, stamps=()):
    out = {"sets": {}, "phase_s": {}}
    for name in SETS:
        text = read(os.path.join(work, f"eval_{name}.log"))
        m = MEAN.search(text)
        if m is None:
            raise SystemExit(f"no Mean/r_mean line in eval_{name}.log")
        n = len(STUDENT.findall(text))
        out["sets"][name] = {"mean": float(m.group(1)),
                             "std": float(m.group(2)), "n": n}
    losses = []
    for path in sorted(glob.glob(os.path.join(work, "logged_files",
                                              "*.jsonl"))):
        for line in read(path).splitlines():
            row = json.loads(line)
            if "Grand_Loss" in row:
                losses.append([row["step"], row["Grand_Loss"]])
    if losses:
        out["loss_first"], out["loss_last"] = losses[0], losses[-1]
    for (name, t), (_, t_next) in zip(stamps, stamps[1:]):
        out["phase_s"][name] = round(t_next - t, 3)
    card = os.path.join(work, "card.txt")
    out["card"] = read(card).strip() if os.path.exists(card) else None
    return _order(out)


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
        mean = sum(d) / n
        std = math.sqrt(sum((v - mean) ** 2 for v in d) / (n - 1))
        out["diffs"][k] = {"values": d, "mean": mean, "std": std,
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
    control."""
    from scipy import stats

    groups = [[run_means(r) for r in runs] for runs in (runs_a, runs_b)]
    out = {"a": groups[0], "b": groups[1], "tests": {}}
    for k in ("init", "random"):
        da, db = ([m["distilled"] - m[k] for m in g] for g in groups)
        res = stats.ttest_ind(da, db, equal_var=False)
        out["tests"][k] = {
            "a": da, "b": db, "mean_a": sum(da) / len(da),
            "mean_b": sum(db) / len(db), "t": float(res.statistic),
            "df": float(res.df), "p": float(res.pvalue),
            "differs": bool(res.pvalue < alpha)}
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--welch"]:
        cut = argv.index("--")
        s = welch(argv[1:cut], argv[cut + 1:])
        for k, v in s["tests"].items():
            print(f"distilled - {k}: a {v['mean_a']:.4f} over {len(v['a'])} "
                  f"runs, b {v['mean_b']:.4f} over {len(v['b'])}; Welch t "
                  f"{v['t']:.4f}, df {v['df']:.2f}, p {v['p']:.4f}: "
                  f"{'differs' if v['differs'] else 'no difference'} at 5%")
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
    print(f"distilled above init and random by more than 2 s.e. "
          f"({s['two_se']:.4f}): {s['order_holds']}")
    print(f"card: {s['card']}")
    print(json.dumps(s))
    return s


if __name__ == "__main__":
    main()
