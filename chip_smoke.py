#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``multimodal_dataset_distillation_tpu_torch``)
on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``/usr/local/cuda``) and the repository
beside this file; exits non-zero, and prints no result, otherwise.  Phases,
each of which raises on failure:

1. Build the grouped 3x3 conv kernels (``csrc/gconv3x3.cu``, ``nvcc`` for
   ``sm_90a``) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version at NFNet-L0's three
   grouped-conv shapes (mini-batch 100): the forward conv, the input
   gradient (the forward kernel on the rotated weight) and the weight
   gradient, in float32 and bfloat16; one double-backward HVP through the
   autograd Functions; times of the kernel, the plain version and the
   cuDNN call beside the card's bound.
3. The main path: ``Distiller.step_traj`` outer steps of NFNet-L0 at 224^2,
   nq=100, mb=100, syn_steps=8, bf16 inner compute, forward-HVP, kernels
   on, dropout and DropPath active; launch counters read around it.
4. One float32 outer step with the kernels against the same step on
   ``F.conv2d`` (TF32 off), from the same seed and state.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
PKG = "multimodal_dataset_distillation_tpu_torch"

PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12    # H100 SXM device memory bytes/s

# NFNet-L0's stride-1 grouped 3x3 sites at 224^2: (H, C, groups) -> count
SITES = {(28, 128, 2): 3, (14, 384, 6): 11, (7, 384, 6): 5}
BATCH = 100
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # x max|plain|; see below
TPU_SRC = "multimodal_dataset_distillation_tpu/ops/pallas_gconv.py"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def max_err(got: torch.Tensor, want: torch.Tensor):
    err = float((got.float() - want).abs().max())
    return err, float(want.abs().max())


def check(name: str, got, want, dtype) -> float:
    err, scale = max_err(got, want)
    print(f"  {name:<6} {str(dtype)[6:]:<8} max_abs_err {err:.3e}  "
          f"max|plain| {scale:.3e}  tol {TOL[dtype] * scale:.3e}", flush=True)
    if not err <= TOL[dtype] * scale:
        raise AssertionError(f"{name} {dtype}: max abs error {err} > "
                             f"{TOL[dtype]} x {scale}")
    return err


def check_kernels(gc):
    """Phase 2.  Tolerances: float32 1e-4 of the largest plain value (both
    sides accumulate in float32, in other orders); bfloat16 1e-2 of it (the
    kernel rounds its float32 sum to bfloat16, 2^-9 relative, and the plain
    version is computed in float32 from the same bfloat16 operands)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (h, c, groups), sites in SITES.items():
        cpg = c // groups
        x32 = torch.randn(BATCH, h, h, c, device="cuda", generator=gen)
        w32 = torch.randn(3, 3, cpg, c, device="cuda",
                          generator=gen) / math.sqrt(9 * cpg)
        yb32 = torch.randn(BATCH, h, h, c, device="cuda", generator=gen)
        print(f"shape x=({BATCH},{h},{h},{c}) groups={groups} "
              f"({sites} sites per tower pass)", flush=True)
        row = {"shape": [BATCH, h, h, c], "groups": groups, "sites": sites}
        for dtype in (torch.float32, torch.bfloat16):
            x, w, yb = x32.to(dtype), w32.to(dtype), yb32.to(dtype)
            xf, wf, ybf = x.float(), w.float(), yb.float()
            tag = "f32" if dtype == torch.float32 else "bf16"
            row[f"fwd_err_{tag}"] = check(
                "fwd", gc.gconv3x3_fwd(x, w, groups),
                gc.gconv3x3_ref(xf, wf, groups), dtype)
            xr = xf.clone().requires_grad_()
            (dx_plain,) = torch.autograd.grad(gc.gconv3x3_ref(xr, wf, groups),
                                              xr, ybf)
            row[f"dgrad_err_{tag}"] = check(
                "dgrad", gc.gconv3x3_fwd(yb, gc.rot_swap(w, groups), groups),
                dx_plain, dtype)
            row[f"wgrad_err_{tag}"] = check(
                "wgrad", gc.gconv3x3_wgrad(x, yb, groups),
                gc.gconv3x3_wgrad_ref(xf, ybf, groups), dtype)
        # times in bfloat16, the main path's dtype
        x, w, yb = x32.bfloat16(), w32.bfloat16(), yb32.bfloat16()
        x_nchw = x.permute(0, 3, 1, 2)          # channels-last view, no copy
        yb_nchw = yb.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        flops = 2.0 * BATCH * h * h * c * 9 * cpg
        fwd_bytes = (x.numel() * 2 + w.numel() * 2 + yb.numel() * 2)
        row["fwd_ms"] = cuda_ms(lambda: gc.gconv3x3_fwd(x, w, groups))
        row["fwd_plain_ms"] = cuda_ms(lambda: gc.gconv3x3_ref(x, w, groups))
        row["fwd_library_ms"] = cuda_ms(lambda: F.conv2d(
            x_nchw, w_oihw, padding=1, groups=groups))
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(
            flops, fwd_bytes, PEAK_BF16)
        row["wgrad_ms"] = cuda_ms(lambda: gc.gconv3x3_wgrad(x, yb, groups))
        row["wgrad_plain_ms"] = cuda_ms(
            lambda: gc.gconv3x3_wgrad_ref(x, yb, groups))
        row["wgrad_library_ms"] = cuda_ms(
            lambda: torch.ops.aten.convolution_backward(
                yb_nchw, x_nchw, w_oihw, None, [1, 1], [1, 1], [1, 1], False,
                [0, 0], groups, [False, True, False]))
        row["wgrad_bound_ms"], row["wgrad_bound_by"] = bound_ms(
            flops, fwd_bytes, PEAK_BF16)
        print("  bf16 ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms")),
            flush=True)
        rows.append(row)
    return rows


def check_hvp(gc):
    """Double backward through GConv3x3 (its backward is GConv3x3 and
    GConv3x3Wgrad applies, so the HVP runs on the kernels) against autograd
    through the plain version; float32, tolerance 1e-4 of the largest
    plain value."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    groups, cpg = 2, 64
    x = torch.randn(2, 6, 6, groups * cpg, device="cuda", generator=gen)
    w = torch.randn(3, 3, cpg, groups * cpg, device="cuda",
                    generator=gen) / 24.0
    vx, vw = torch.randn_like(x), torch.randn_like(w) / 24.0

    def hvp(conv):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        gx, gw = torch.autograd.grad(torch.sin(conv(xx, ww, groups)).sum(),
                                     (xx, ww), create_graph=True)
        return torch.autograd.grad((gx * vx).sum() + (gw * vw).sum(),
                                   (xx, ww))

    before = dict(gc.LAUNCHES)
    got = hvp(gc.gconv3x3)
    if gc.LAUNCHES["gconv3x3_wgrad"] == before["gconv3x3_wgrad"]:
        raise AssertionError("the HVP did not reach the wgrad kernel")
    want = hvp(gc.gconv3x3_ref)
    for name, a, b in zip(("hvp_x", "hvp_w"), got, want):
        check(name, a, b, torch.float32)


def main_cfg(Config, **kw):
    """The headline configuration (bench.py:188-193) with the kernels on."""
    base = dict(image_encoder="nfnet", image_size=224, num_queries=100,
                syn_steps=8, mini_batch_size=100, expert_epochs=1,
                lr_img=1000.0, lr_txt=1000.0, lr_lr=1e-2,
                lr_teacher_img=0.1, lr_teacher_txt=0.1, seed=0,
                inner_dtype="bfloat16", hvp_mode="forward", pallas_gconv=True)
    return Config(**{**base, **kw})


def make_distiller(cfg, seed: int = 0, device: str = "cuda"):
    """Seeded NFNet-L0 bi-encoder, synthetic data and a 2-snapshot expert
    trajectory, as bench.py builds them; theta_0's skipinit gains are moved
    off zero so that the residual branches (and the grouped convs in them)
    shape the loss."""
    from multimodal_dataset_distillation_tpu_torch.engine.distill import (
        Distiller)
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder, init_bi_encoder)
    from multimodal_dataset_distillation_tpu_torch.utils.flat import (
        flatten_params)

    model = init_bi_encoder(build_bi_encoder(cfg, device="cpu"), seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("skipinit_gain"):
                p.fill_(0.2 + 0.05 * rng.randn())
    img0 = flatten_params(model.image_encoder).numpy()
    txt0 = flatten_params(model.text_projection).numpy()
    image_syn = rng.randn(cfg.num_queries, cfg.image_size, cfg.image_size,
                          3).astype(np.float32)
    text_syn = rng.randn(cfg.num_queries, 768).astype(np.float32)
    d = Distiller(cfg, model, image_syn, text_syn, device=device)
    traj_img = d.put_trajectory(np.stack(
        [img0, img0 + 0.01 * rng.randn(*img0.shape).astype(np.float32)]))
    traj_txt = d.put_trajectory(np.stack(
        [txt0, txt0 + 0.01 * rng.randn(*txt0.shape).astype(np.float32)]))
    return d, traj_img, traj_txt, rng


def main_path(gc, cfg, steps: int = 3):
    """Phase 3: warm-up step + ``steps`` timed outer steps; counters are
    zeroed just before and read just after."""
    d, traj_img, traj_txt, rng = make_distiller(cfg)
    st0 = d.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.reset_launches()
    t0 = time.perf_counter()
    losses = [float(d.step_traj(traj_img, traj_txt, 0,
                                d.sample_indices(rng))["grand_loss"])]
    t1 = time.perf_counter()
    for _ in range(steps):
        m = d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))
        losses.append(float(m["grand_loss"]))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(gc.LAUNCHES)
    st = d.state
    print(f"main path: grand_loss per step {losses}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite grand_loss: {losses}")
    for name in ("image_syn", "text_syn", "syn_lr_img", "syn_lr_txt"):
        a, b = getattr(st0, name), getattr(st, name)
        if not bool(torch.isfinite(b).all()) or torch.equal(a, b):
            raise AssertionError(f"{name} did not move to finite values")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k}: no launch on the main path")
    out = {
        "outer_steps": steps + 1,
        "first_step_s": t1 - t0,
        "steps_per_s": steps / (t2 - t1),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
        "launches_per_outer_step": {k: n / (steps + 1)
                                    for k, n in launches.items()},
        "syn_lr_img": float(st.syn_lr_img), "syn_lr_txt": float(st.syn_lr_txt),
    }
    print("main path: " + json.dumps(out), flush=True)
    return out


def compare_f32(cfg, mb: int = 25, syn_steps: int = 2):
    """Phase 4: one float32 outer step with the kernels against the same
    step on F.conv2d, at full width and 224^2 (mini-batch and syn_steps
    cut so that two float32 second-order graphs fit).  Tolerance 1e-3 on
    the loss and 1e-2 on each meta-gradient's relative error norm: the two
    convs sum in other orders, and the difference passes through two
    second-order inner steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for gconv in (True, False):
        c = cfg.replace(syn_steps=syn_steps, mini_batch_size=mb,
                        inner_dtype="float32", pallas_gconv=gconv)
        d, traj_img, traj_txt, rng = make_distiller(c)
        st0 = d.state
        m = d.step_traj(traj_img, traj_txt, 0, d.sample_indices(rng))
        st = d.state
        # first step: trace = g, update = -lr * g
        res[gconv] = {
            "loss": float(m["grand_loss"]),
            "pixels": (st0.image_syn - st.image_syn) / c.lr_img,
            "texts": (st0.text_syn - st.text_syn) / c.lr_txt,
            "lr_img": m["syn_lr_img_grad"], "lr_txt": m["syn_lr_txt_grad"]}
        del d, traj_img, traj_txt, st0, st, m
        torch.cuda.empty_cache()
    a, b = res[True], res[False]
    out = {"mini_batch": mb, "syn_steps": syn_steps,
           "loss_kernel": a["loss"], "loss_plain": b["loss"],
           "loss_rel_err": abs(a["loss"] - b["loss"]) / abs(b["loss"])}
    if not out["loss_rel_err"] <= 1e-3:
        raise AssertionError(f"f32 grand_loss differs: {out}")
    for k in ("pixels", "texts", "lr_img", "lr_txt"):
        ref = b[k].double()
        rel = float((a[k].double() - ref).norm() / ref.norm())
        out[f"{k}_grad_rel_err"] = rel
        if not (ref.norm() > 0 and rel <= 1e-2):
            raise AssertionError(f"f32 meta-gradient {k} differs: {out}")
    print("f32 kernels vs F.conv2d: " + json.dumps(out), flush=True)
    return out


def kernel_entries(rows, launches):
    def total(key):
        return sum(r["sites"] * r[key] for r in rows)

    entries = []
    for name, kind, line in (("gconv3x3_fwd", "fwd", 176),
                             ("gconv3x3_wgrad", "wgrad", 223)):
        errs = [r[f"{kind}_err_bf16"] for r in rows]
        if kind == "fwd":
            errs += [r["dgrad_err_bf16"] for r in rows]
        bound = total(f"{kind}_bound_ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/gconv3x3.cu",
            "replaces": f"{TPU_SRC}:{line}",
            "launches": launches[name],
            "max_abs_err": max(errs),
            # times: bf16, summed over one tower pass (19 sites, mb=100)
            "ms": total(f"{kind}_ms"), "plain_ms": total(f"{kind}_plain_ms"),
            "bound_ms": bound,
            "bound_by": max(rows, key=lambda r: r[f"{kind}_bound_ms"])[
                f"{kind}_bound_by"],
            "library_ms": total(f"{kind}_library_ms"),
            "per_shape": [{k: r[k] for k in (
                "shape", "groups", "sites", f"{kind}_ms", f"{kind}_plain_ms",
                f"{kind}_library_ms", f"{kind}_bound_ms",
                f"{kind}_err_f32", f"{kind}_err_bf16")} for r in rows],
        })
    return entries


def main() -> int:
    if not (HERE / PKG / "csrc" / "gconv3x3.cu").is_file():
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, str(HERE))
    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.ops import gconv as gc

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    print(f"card: {card_line()}", flush=True)
    t0 = time.perf_counter()
    gc.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    rows = check_kernels(gc)
    check_hvp(gc)
    torch.backends.cudnn.allow_tf32 = True   # the library defaults again
    cfg = main_cfg(Config)
    path = main_path(gc, cfg)
    torch.cuda.empty_cache()
    compare_f32(cfg)

    print(json.dumps({"kernels": kernel_entries(rows, path["launches"])}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
