"""The benchmark's machinery: finding a cell's files by name, the run's
records, weights and inputs made from the seed, and the checks every run
makes before it prints a result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Its files:

* ``cells/<cell>.json``: configuration, traffic, chips, why (as in
  ``BENCHMARK.json``) and the limits of the numbers that decide
  ``correct``;
* ``configs/<config>.json``: the model configuration (layer table,
  widths, the job's hyperparameters, compute dtype, the peak ``mfu``
  divides by);
* ``traffic/<traffic>.json``: the traffic mix's parameters, whose
  ``kind`` names the driver ``traffic/<kind>.py``;
* ``metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "multimodal_dataset_distillation_tpu_torch"
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_dataset_distillation_tpu")
#: the program's route overrides: a run refuses to start with one set
ENV_OVERRIDES = ("MDD_PALLAS_GCONV", "MDD_STEM_S2D", "MDD_FUSED_JVP")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file of the benchmark, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the BENCHMARK.json workload entry
    spec: dict           # cells/<name>.json
    cfg: dict            # configs/<config>.json
    mix: dict            # traffic/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``,
    or every cell where it lists none."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = read_json(bench_dir / "cells" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"cells/{name}.json: {key} {spec[key]!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    cfg = read_json(bench_dir / "configs" / f"{entry['config']}.json")
    mix = read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, entry=entry, spec=spec, cfg=cfg, mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def driver(kind: str, bench_dir: Path = HERE) -> ModuleType:
    return load_module(bench_dir / "traffic" / f"{kind}.py",
                       f"h100_bench_traffic_{kind}")


def reader(metric: str, bench_dir: Path = HERE) -> ModuleType:
    return load_module(bench_dir / "metrics" / f"{metric}.py",
                       "h100_bench_metric_" + metric.replace(".", "_"))


def overrides_set() -> List[str]:
    return [k for k in ENV_OVERRIDES if k in os.environ]


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that no run may hold, compared
    whole (the program's name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# ---------------------------------------------------------------------------
# the run's records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Records:
    """What the run saw, for the per-layer readers."""
    kind: str
    cfg: dict
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    rate: Optional[float] = None          # steps/s, unprofiled part
    trace: Optional[object] = None        # trace.Summary of the stretch

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


# ---------------------------------------------------------------------------
# weights and inputs from the seed, on the device
# ---------------------------------------------------------------------------

def init_flat(table, gen, device, init: dict):
    """One flat parameter vector in the table's order: he-normal (fan in)
    convolution kernels, lecun-normal (fan in) dense kernels, unit gains
    and norm scales, zero biases, skipinit gains ``init['skipinit_gain']``
    (mean, std); normals cut at two standard deviations.  Three device
    calls whatever the depth."""
    import torch

    means, stds, sizes = [], [], []
    for _, shape, kind in table:
        n = math.prod(shape)
        fan_in = n // shape[0] if shape else 1
        mean, std = {"ws": (0.0, math.sqrt(2.0 / max(fan_in, 1))),
                     "fan_in": (0.0, math.sqrt(1.0 / max(fan_in, 1))),
                     "zero": (0.0, 0.0), "one": (1.0, 0.0),
                     "skipinit": tuple(init["skipinit_gain"])}[kind]
        means.append(mean)
        stds.append(std)
        sizes.append(n)
    sizes_t = torch.tensor(sizes, device=device)
    mean_v = torch.repeat_interleave(torch.tensor(means, device=device), sizes_t)
    std_v = torch.repeat_interleave(torch.tensor(stds, device=device), sizes_t)
    z = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    return mean_v + std_v * z


def check_layout(module, table, what: str) -> None:
    """The program's parameters must be the reference's, name by name and
    shape by shape, in the same order: that order is the flat vector's."""
    got = [(n, tuple(p.shape)) for n, p in module.named_parameters()]
    want = [(n, tuple(s)) for n, s, _ in table]
    if got != want:
        bad = next(((a, b) for a, b in zip(got, want) if a != b),
                   (len(got), len(want)))
        raise ValueError(f"{what}: the program's parameters are not the "
                         f"configuration's layer table: {bad}")


def load_flat(module, flat) -> None:
    """Copy ``flat`` into the module's parameters (no storage shared)."""
    import torch

    with torch.no_grad():
        off = 0
        for p in module.parameters():
            p.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()


def flat_of(module):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def split_leaves(flat, table) -> list:
    return [flat[i:i + n] for i, n in
            zip(_offsets(table), [math.prod(s) for _, s, _ in table])]


def _offsets(table) -> List[int]:
    out, off = [], 0
    for _, s, _ in table:
        out.append(off)
        off += math.prod(s)
    return out


def card_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0)
