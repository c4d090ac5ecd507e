"""Run logging (JSONL, wandb when wanted), timestamps and a trace scope.

The port's own copy of ``multimodal_dataset_distillation_tpu/utils/
logging.py``: :class:`RunLogger` writes every record to
``{log_dir}/{name}.jsonl`` (and to wandb when it is importable and not
disabled, offline unless configured otherwise); :class:`SmoothedValue`
and :class:`MetricLogger` track windowed metrics; :class:`Profiler` is a
``torch.profiler`` scope writing a Chrome trace, where the JAX package
uses ``jax.profiler``.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, Optional

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


class SmoothedValue:
    """Windowed median / average tracker (utils.py:714-773 analog)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    """Iteration logger (utils.py:623-710 analog): one ``SmoothedValue``
    per metric name, printed every ``print_freq`` items by ``log_every``."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        for i, obj in enumerate(iterable):
            t0 = time.time()
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0:
                print(f"{header} [{i}]  {self}  time: {iter_time}")
        total = time.time() - start
        print(f"{header} Total time: {total:.1f}s")


class Profiler:
    """``torch.profiler`` over a scope (host ops, and the card's kernels
    when one is present); writes ``{profile_dir}/trace.json`` (Chrome
    trace format) on exit.  A no-op scope when ``profile_dir`` is empty."""

    def __init__(self, profile_dir: Optional[str]):
        self.dir = profile_dir
        self._prof = None

    def __enter__(self):
        if self.dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.dir,
                                                        "trace.json"))
            self._prof = None
        return False


def get_time() -> str:
    return time.strftime("[%Y-%m-%d %H:%M:%S]", time.localtime())
