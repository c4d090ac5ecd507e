"""Run logging (JSONL, wandb when wanted), timestamps, the program's
spans and counters, and a trace scope.

The port's own copy of ``multimodal_dataset_distillation_tpu/utils/
logging.py``: :class:`RunLogger` writes every record to
``{log_dir}/{name}.jsonl`` (and to wandb when it is importable and not
disabled, offline unless configured otherwise); :class:`Profiler` is a
``torch.profiler`` scope writing a Chrome trace, where the JAX package
uses ``jax.profiler``.

The recorder (:func:`span`, :func:`spans`, :func:`reset`,
:func:`counter_group`, :func:`reset_counters`) is the port's own:

* A span is a phase of the program (``distill.step``, ``distill.unroll``,
  ``distill.meta_backward``, ``cycler.segment``, ``expert.step``,
  ``expert.put``, ``data.batch``).  It records only while a
  ``torch.profiler`` session is active in the process, on the profiler's
  clock (``time.time_ns()``, which kineto stamps its host events with),
  with the span open around it as its parent and, on a CUDA device, the
  allocator's ``memory_allocated()`` at both ends, and, when it is given
  a counter group, what that group gained inside it (``cycler.segment``
  carries ``cycler``'s).  It adds no event to the profiler's own.  With
  no session active a span costs one check.
* A counter group is a dict of integers, always on, each event one add:
  ``launches`` (:data:`..ops.gconv.LAUNCHES`) and ``cycler``
  (:class:`..engine.distill.ExpertCycler`'s ``segments`` and
  ``copy_ns``).  Only its own reset clears it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch


class RunLogger:
    """wandb if available and enabled, and always a JSONL file."""

    def __init__(self, project: str = "DatasetDistillation",
                 name: Optional[str] = None, config: Optional[Dict] = None,
                 disable_wandb: bool = True, log_dir: str = "./logged_files"):
        self.step = 0
        self._wandb = None
        self.name = name or time.strftime("%Y-%m-%d %H:%M:%S")
        if not disable_wandb:
            try:
                # never block on the network: `wandb sync` uploads later
                os.environ.setdefault("WANDB_MODE", "offline")
                import wandb

                wandb.init(project=project, config=config, name=name)
                self._wandb = wandb
                self.name = wandb.run.name or self.name
            except Exception as e:  # any wandb failure: keep the JSONL log
                print(f"[log] wandb unavailable ({e}); falling back to JSONL")
        os.makedirs(log_dir, exist_ok=True)
        safe = self.name.replace("/", "_").replace(":", "-").replace(" ", "_")
        self._file = open(os.path.join(log_dir, f"{safe}.jsonl"), "a")

    def _write(self, record: Dict[str, Any]) -> None:
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        step = self.step if step is None else step
        clean = {}
        for k, v in metrics.items():
            if isinstance(v, (int, float, str)):
                clean[k] = v
                continue
            try:  # numpy scalars, one-element arrays and tensors
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._wandb is not None:
            self._wandb.log(clean, step=step)
        self._write({"step": step, **clean})

    # rich artifacts (reference distill.py:386-394: wandb Images /
    # Histograms / Html sentence tables per eval)

    def log_image(self, key: str, image, step: Optional[int] = None,
                  caption: Optional[str] = None):
        """``image``: an HWC array or the path of a saved PNG; the JSONL
        records the path (an array by its shape)."""
        step = self.step if step is None else step
        is_path = isinstance(image, (str, os.PathLike))
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Image(
                str(image) if is_path else np.asarray(image),
                caption=caption)}, step=step)
        ref = (str(image) if is_path
               else f"<image {tuple(np.asarray(image).shape)}>")
        self._write({"step": step, key: {"_type": "image", "path": ref}})

    def log_histogram(self, key: str, values, step: Optional[int] = None):
        """wandb.Histogram when available; summary statistics in the JSONL."""
        step = self.step if step is None else step
        v = np.asarray(values, np.float64).ravel()
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Histogram(v)}, step=step)
        stats = {"n": int(v.size), "min": 0.0, "max": 0.0, "mean": 0.0,
                 "std": 0.0}
        if v.size:
            stats.update(min=float(v.min()), max=float(v.max()),
                         mean=float(v.mean()), std=float(v.std()))
        self._write({"step": step, key: {"_type": "histogram", **stats}})

    def log_html(self, key: str, html: str, step: Optional[int] = None,
                 path: Optional[str] = None):
        """wandb.Html when available; the JSONL records the backing file."""
        step = self.step if step is None else step
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Html(html)}, step=step)
        self._write({"step": step, key: {
            "_type": "html", "path": path or f"<inline {len(html)}B>"}})

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        self._file.close()


class SilentLogger:
    """A :class:`RunLogger` that writes nothing: the logger of a
    data-parallel rank other than 0 (``name`` is rank 0's run name)."""

    def __init__(self, name: str):
        self.name = name

    def log(self, *args, **kw) -> None:
        pass

    log_image = log_histogram = log_html = log

    def finish(self) -> None:
        pass


class Span(NamedTuple):
    """One recorded span: ``start_ns``/``end_ns`` from ``time.time_ns()``;
    ``parent`` the id of the innermost span open at its start (None at the
    top); ``mem0``/``mem1`` the CUDA allocator's bytes at its ends (None
    when CUDA is not in use); ``counts`` what the span's counter group
    gained over it (None when it was given none)."""
    name: str
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    mem0: Optional[int]
    mem1: Optional[int]
    counts: Optional[Dict[str, int]] = None


def _allocated() -> Optional[int]:
    return (torch.cuda.memory_allocated() if torch.cuda.is_initialized()
            else None)


_NO_SPAN = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("rec", "name", "group", "id", "parent", "t0", "m0", "c0")

    def __init__(self, rec: "Recorder", name: str,
                 group: Optional[Dict[str, int]]):
        self.rec, self.name, self.group = rec, name, group

    def __enter__(self):
        rec = self.rec
        self.id = next(rec._ids)
        self.parent = rec._open[-1] if rec._open else None
        rec._open.append(self.id)
        self.m0 = _allocated()
        self.c0 = None if self.group is None else dict(self.group)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        rec._open.pop()
        counts = (None if self.group is None else
                  {k: v - self.c0.get(k, 0) for k, v in self.group.items()})
        rec._spans.append(Span(self.name, self.id, self.parent, self.t0, t1,
                               self.m0, _allocated(), counts))
        return False


class Recorder:
    """The program's spans (while a profiler is active) and counter
    groups (always).  Spans are opened on one thread: the one that runs
    the steps."""

    def __init__(self):
        self._spans: List[Span] = []
        self._open: List[int] = []     # ids of the open spans, innermost last
        self._ids = itertools.count()
        self.counters: Dict[str, Dict[str, int]] = {}

    def span(self, name: str, group: Optional[Dict[str, int]] = None):
        """A context manager recording ``name`` (and what the counter group
        ``group`` gains inside it) while a ``torch.profiler`` session is
        active; a shared no-op otherwise."""
        if not torch.autograd._profiler_enabled():
            return _NO_SPAN
        return _OpenSpan(self, name, group)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """The recorded spans (of ``name``) in the order they started."""
        out = sorted(self._spans, key=lambda s: s.id)
        return out if name is None else [s for s in out if s.name == name]

    def reset(self) -> None:
        """Forget the recorded spans; the counters stay."""
        self._spans = []

    def counter_group(self, group: str, counts: Dict[str, int]
                      ) -> Dict[str, int]:
        """Register ``counts`` (a dict the caller keeps and adds to) as the
        counter group ``group``; -> that same dict."""
        self.counters[group] = counts
        return counts

    def reset_counters(self, group: str) -> None:
        counts = self.counters[group]
        for k in counts:
            counts[k] = 0


#: the process's recorder
RECORDER = Recorder()
span = RECORDER.span
spans = RECORDER.spans
reset = RECORDER.reset
counter_group = RECORDER.counter_group
reset_counters = RECORDER.reset_counters
#: the tid of the spans' row in an exported trace
SPAN_TID = 0


def _trace_events(recorded: List[Span], base_ns: int, pid: int
                  ) -> List[dict]:
    """Chrome-trace complete events of ``recorded`` on one row of ``pid``,
    ``ts``/``dur`` in microseconds from ``base_ns`` (the trace's
    ``baseTimeNanoseconds``)."""
    row = {"pid": pid, "tid": SPAN_TID}
    out = [{"ph": "M", "name": "thread_name", **row,
            "args": {"name": "program spans"}},
           {"ph": "M", "name": "thread_sort_index", **row,
            "args": {"sort_index": -1}}]
    for s in recorded:
        args = {"id": s.id, "parent": s.parent}
        if s.mem0 is not None:
            args.update(mem0=s.mem0, mem1=s.mem1)
        if s.counts is not None:
            args.update(s.counts)
        out.append({"ph": "X", "cat": "program_span", "name": s.name, **row,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


class Profiler:
    """``torch.profiler`` over a scope (host ops, and the card's kernels
    when one is present); writes ``{profile_dir}/trace.json`` (Chrome
    trace format) on exit, with the program's spans of the scope on a row
    of their own.  A no-op scope when ``profile_dir`` is empty."""

    def __init__(self, profile_dir: Optional[str]):
        self.dir = profile_dir
        self._prof = None

    def __enter__(self):
        if self.dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            reset()
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            trace["traceEvents"] += _trace_events(
                spans(), int(trace.get("baseTimeNanoseconds", 0)),
                os.getpid())
            with open(path, "w") as f:
                json.dump(trace, f)
            self._prof = None
        return False


def get_time() -> str:
    return time.strftime("[%Y-%m-%d %H:%M:%S]", time.localtime())
