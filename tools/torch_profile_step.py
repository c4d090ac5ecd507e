#!/usr/bin/env python3
"""Where the time of one outer distillation step of the PyTorch port goes,
on one NVIDIA card.

    python3 tools/torch_profile_step.py [--timed 3] [--steps 1] [--no-gconv]
                                        [--image_encoder nf_regnet]
                                        [--stem_s2d] [--fr_bwd {rof,for}]
                                        [--no-fused-jvp]
                                        [--trace build/step_trace.json]

Builds the headline configuration of ``chip_smoke.py`` (NFNet-L0 at 224^2,
or the tower ``--image_encoder`` names, nq=100, mb=100, syn_steps=8, bf16
inner compute, forward-HVP, grouped-conv kernels on unless
``--no-gconv``, the NF stems in space-to-depth form with ``--stem_s2d``,
the meta-backward's orientation ``--fr_bwd`` (default ``rof``, grad of
jvp, with the merged-tangent conv unless ``--no-fused-jvp``; ``for``,
jvp of grad)), takes one warm-up outer step, times
``--timed`` outer steps without the profiler, then profiles ``--steps``
outer steps with ``torch.profiler`` and prints:

* the wall time per outer step without and with the profiler (host clock
  around work that ends in a synchronize), the device-busy time (sum of
  kernel times on the card's one stream, from the profiled steps) and the
  idle share against each wall time (the profiler's host overhead inflates
  the profiled one);
* device time grouped by kernel class (the port's gconv kernels, cuDNN
  convolutions, GEMMs, elementwise/reduction/copy kernels);
* the 25 kernels with the most device time;
* the convolution ops with the most device time, by input shapes (which
  layer a slow kernel belongs to);
* the count of ``aten::_convolution_double_backward`` calls (PyTorch's
  conv double backward) per step.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from multimodal_dataset_distillation_tpu_torch.config import Config  # noqa: E402
from multimodal_dataset_distillation_tpu_torch.ops import (  # noqa: E402
    fused_jvp, gconv, s2d)


def kernel_class(name: str) -> str:
    n = name.lower()
    if "gconv3x3" in n:
        return "gconv kernels (this port)"
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timed", type=int, default=3)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--no-gconv", action="store_true")
    ap.add_argument("--image_encoder", default="nfnet")
    ap.add_argument("--stem_s2d", action="store_true")
    ap.add_argument("--fr_bwd", choices=("rof", "for"), default="rof")
    ap.add_argument("--no-fused-jvp", action="store_true")
    ap.add_argument("--trace", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_step: no CUDA card", file=sys.stderr)
        return 3
    cfg = chip_smoke.main_cfg(Config, image_encoder=args.image_encoder,
                              pallas_gconv=not args.no_gconv,
                              stem_s2d=args.stem_s2d, fr_bwd=args.fr_bwd,
                              fused_jvp=not args.no_fused_jvp)
    d, traj_img, traj_txt, rng = chip_smoke.make_distiller(cfg)
    float(d.step_traj(traj_img, traj_txt, 0,
                      d.sample_indices(rng))["grand_loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.timed):
        d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / max(args.timed, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def ms(e):  # a kernel's device time
        return e.time_range.elapsed_us() / 1e3 / args.steps

    busy = sum(ms(e) for e in kernels)
    by_class = collections.Counter()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in kernels:
        by_class[kernel_class(e.name)] += ms(e)
        by_name[e.name] += ms(e)
        count[e.name] += 1
    out = {
        "card": chip_smoke.card_line(),
        "image_encoder": cfg.image_encoder,
        "pallas_gconv": gconv.configure(cfg),
        "stem_s2d": s2d.configure(cfg),
        "fr_bwd": cfg.fr_bwd,
        "fused_jvp": fused_jvp.resolve(cfg),
        "wall_ms_per_step": plain_wall * 1e3,
        "profiled_wall_ms_per_step": wall * 1e3,
        "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / (plain_wall * 1e3),
        "profiled_idle_share": 1.0 - busy / (wall * 1e3),
        "kernel_launches_per_step": len(kernels) / args.steps,
        "conv_double_backward_calls_per_step": sum(
            e.name == "aten::_convolution_double_backward"
            for e in prof.events()) / args.steps,
        "ms_by_class": dict(by_class.most_common()),
    }
    print(json.dumps(out), flush=True)
    print(f"{'ms/step':>10} {'calls/step':>10}  kernel")
    for name, t in by_name.most_common(25):
        print(f"{t:10.3f} {count[name] / args.steps:10.0f}  {name[:110]}")
    convs = [a for a in prof.key_averages(group_by_input_shape=True)
             if a.key in ("aten::cudnn_convolution",
                          "aten::convolution_backward")]
    convs.sort(key=lambda a: -a.device_time_total)
    print(f"{'ms/step':>10} {'calls/step':>10}  conv op, input shapes")
    for a in convs[:15]:
        print(f"{a.device_time_total / 1e3 / args.steps:10.3f} "
              f"{a.count / args.steps:10.0f}  {a.key} {a.input_shapes[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
