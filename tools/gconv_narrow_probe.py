#!/usr/bin/env python3
"""What holds the 8-channel grouped-conv kernels (``csrc/gconv3x3_narrow.cu``)
at NF-RegNet-B1's four grouped sites, on one NVIDIA card.

    python3 tools/gconv_narrow_probe.py

Builds the source twice: as the port builds it, and with
``-DMDD_NARROW_COPIES_ONLY``, which keeps every block's copies into shared
memory (the ring of pixel rows, the ybar tiles), its tap masks and the
wgrad's partials and their reduction, and drops the compute between them
(with the forward's output stores).  Times both builds' forward
and wgrad in float32 and bfloat16 at mini-batch 100 (cold L2, in a CUDA
graph, as ``chip_smoke.py`` does), beside ``x.clone()`` (one read and one
write of the activation: what a copy of the same bytes costs) and the
card's bound.  Prints one JSON line per site and dtype and the per-tower-pass
totals (sites weighted by their count).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from multimodal_dataset_distillation_tpu_torch.ops import (  # noqa: E402
    gconv as gc)

SRC = gc._CSRC / "gconv3x3_narrow.cu"


def build(out: Path, flags: list):
    cmd = gc._nvcc_cmd(SRC, str(out), False)
    return subprocess.Popen(cmd[:-1] + flags + [cmd[-1]])


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mdd_gconv3x3_fwd_narrow.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.mdd_gconv3x3_wgrad_narrow.argtypes = [p, p, p, p] + [i] * 6 + [p]
    lib.mdd_gconv3x3_fwd_narrow.restype = i
    lib.mdd_gconv3x3_wgrad_narrow.restype = i
    return lib


def launched(rc: int) -> None:
    if rc:
        raise RuntimeError(f"kernel launch failed, CUDA error {rc}")


def calls(lib, groups: int):
    """The two entry points of ``lib`` with the wrappers' plans."""
    sms = gc._sm_count(torch.device("cuda"))

    def fwd(x, w):
        n, h, wd, _ = x.shape
        y = torch.empty_like(x)
        runs = gc.narrow_runs("fwd", n * h * wd, groups, x.element_size(), wd,
                              sms)
        launched(lib.mdd_gconv3x3_fwd_narrow(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, groups, runs,
            gc._DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream))
        return y

    def wgrad(x, yb):
        n, h, wd, c = x.shape
        runs = gc.narrow_runs("wgrad", n * h * wd, groups, x.element_size(),
                              wd, sms)
        ws = torch.empty(runs * groups * 576, device=x.device)
        dw = torch.empty(3, 3, 8, c, dtype=x.dtype, device=x.device)
        launched(lib.mdd_gconv3x3_wgrad_narrow(
            x.data_ptr(), yb.data_ptr(), ws.data_ptr(), dw.data_ptr(), n, h,
            wd, groups, runs, gc._DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream))
        return dw

    return {"fwd": fwd, "wgrad": wgrad}


def main() -> int:
    if not torch.cuda.is_available():
        print("gconv_narrow_probe: no CUDA card", file=sys.stderr)
        return 3
    print(cs.card_line(), flush=True)
    out = ROOT / "build" / "kernels"
    out.mkdir(parents=True, exist_ok=True)
    libs = {"full": out / "probe_full.so", "copies": out / "probe_copies.so"}
    jobs = [build(libs["full"], []),
            build(libs["copies"], ["-DMDD_NARROW_COPIES_ONLY"])]
    if any(j.wait() for j in jobs):
        raise RuntimeError("nvcc failed")
    libs = {k: load(v) for k, v in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = {}
    for (h, c, groups), sites in cs.REGNET_SITES.items():
        for dtype, peak in ((torch.float32, cs.PEAK_FP32),
                            (torch.bfloat16, cs.PEAK_BF16)):
            x = torch.randn(cs.BATCH, h, h, c, device="cuda",
                            generator=gen).to(dtype)
            yb = torch.randn_like(x)
            w = (torch.randn(3, 3, 8, c, device="cuda", generator=gen)
                 / math.sqrt(72)).to(dtype)
            flops = 2.0 * cs.BATCH * h * h * c * 72
            nbytes = (2 * x.numel() + w.numel()) * x.element_size()
            row = {"shape": list(x.shape), "groups": groups, "sites": sites,
                   "dtype": str(dtype)[6:],
                   "bound_ms": cs.bound_ms(flops, nbytes, peak)[0],
                   "clone_ms": cs.cuda_ms(lambda a: a.clone(),
                                          cs.cold_copies(x))}
            for kind, other in (("fwd", w), ("wgrad", yb)):
                for name, lib in libs.items():
                    fn = calls(lib, groups)[kind]
                    row[f"{kind}_{name}_ms"] = cs.cuda_ms(
                        fn, cs.cold_copies(x, other))
            print(json.dumps(row), flush=True)
            for k, v in row.items():
                if k.endswith("_ms"):
                    key = f"{row['dtype']}_{k}"
                    total[key] = total.get(key, 0.0) + sites * v
    print(json.dumps({"per_tower_pass": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
