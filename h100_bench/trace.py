"""A profiled stretch of the window and its reduction to what the
per-layer readers and ``breakdown`` read.

From one ``torch.profiler`` trace of whole steps: the device's activity
intervals (kernels, copies, sets) and their union, the runtime's kernel
launches, and the host op running during each idle gap.  Busy time and
the stretch's wall come from the same steps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Tuple

import numpy as np


def kernel_class(name: str) -> str:
    """The class of a device operation, for ``breakdown``."""
    n = name.lower()
    if "gconv3x3" in n:
        return "gconv kernels (the port's)"
    if any(k in n for k in ("conv", "cudnn", "implicit_", "xmma", "dgrad",
                            "wgrad", "fprop", "nchwtonhwc", "nhwctonchw")):
        return "cuDNN convolution"
    if any(k in n for k in ("gemm", "sm90_", "cutlass", "ampere_", "nvjet")):
        return "GEMM"
    if "reduce" in n:
        return "reduction"
    if "copy" in n or "cat" in n:
        return "copy/cat"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


@dataclasses.dataclass
class Summary:
    steps: int                  # whole steps in the stretch
    wall_s: float               # host clock over those steps, synchronized
    busy_s: float               # union of device activity intervals
    launches: int               # runtime kernel launches
    kernels: List[Tuple[str, float]]   # (name, seconds) of each device op
    gaps: List[Tuple[str, float]]      # the longest idle gaps, by host op

    def device_ops(self, top: int = 10) -> List[list]:
        by: dict = {}
        for name, s in self.kernels:
            k = kernel_class(name)
            by[k] = by.get(k, 0.0) + s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def time_of(self, needle: str) -> float:
        return sum(s for name, s in self.kernels if needle in name)


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def _profiled(step, steps, sync, acts):
    from torch.profiler import profile

    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        wall = time.perf_counter() - t0
    return prof.profiler.kineto_results.events(), wall


def profile_steps(step: Callable[[], None], steps: int, sync: Callable[[], None],
                  cuda: bool = True) -> Summary:
    """Run ``steps`` calls of ``step`` under the profiler, from a
    synchronized start to a synchronized end, recording the device and the
    runtime only: recording every host op as well would stretch the host's
    time per op and so the idle share.  One more step, with the host's ops
    recorded too, names the idle gaps."""
    from torch.profiler import ProfilerActivity

    if not cuda:
        events, wall = _profiled(step, steps, sync, [ProfilerActivity.CPU])
        return summarize(events, steps, wall)
    events, wall = _profiled(step, steps, sync, [ProfilerActivity.CUDA])
    out = summarize(events, steps, wall)
    named, wall1 = _profiled(step, 1, sync, [ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
    out.gaps = summarize(named, 1, wall1).gaps
    return out


def summarize(events, steps: int, wall: float, top: int = 10) -> Summary:
    dev, cpu = [], []
    launches = 0
    for e in events:
        if e.is_user_annotation():
            continue
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            if _is_runtime(name):
                launches += "LaunchKernel" in name
            else:
                cpu.append((e.start_ns(), e.duration_ns(), name))
        else:
            dev.append((e.start_ns(), e.duration_ns(), name))
    kernels = [(n, d * 1e-9) for _, d, n in dev]
    busy, gaps = 0.0, []
    if dev:
        dev.sort()
        s = np.array([a for a, _, _ in dev], np.int64)
        end = s + np.array([d for _, d, _ in dev], np.int64)
        run_end = np.maximum.accumulate(end)
        # a new busy interval starts where an op starts after every earlier end
        starts = np.concatenate([[True], s[1:] > run_end[:-1]])
        first = np.flatnonzero(starts)
        last_end = np.append(run_end[first[1:] - 1], run_end[-1])
        busy = float((last_end - s[first]).sum()) * 1e-9
        gap_a, gap_b = last_end[:-1], s[first[1:]]
        order = np.argsort(gap_a - gap_b)[:top]
        c0 = np.array([a for a, _, _ in cpu], np.int64)
        cd = np.array([d for _, d, _ in cpu], np.int64)
        gaps = [(_host_op(c0, cd, cpu, (gap_a[i] + gap_b[i]) // 2),
                 float(gap_b[i] - gap_a[i]) * 1e-9) for i in order]
    return Summary(steps=steps, wall_s=wall, busy_s=busy, launches=launches,
                   kernels=kernels, gaps=gaps)


def _host_op(c0, cd, cpu, t: int) -> str:
    """The innermost host op whose interval holds ``t``."""
    hold = np.flatnonzero((c0 <= t) & (c0 + cd >= t))
    if not len(hold):
        return "host: outside any op"
    return cpu[hold[np.argmin(cd[hold])]][2]
