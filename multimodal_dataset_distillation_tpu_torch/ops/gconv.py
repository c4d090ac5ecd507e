"""Grouped 3x3 stride-1 TF-SAME convolution: CUDA kernels, plain versions,
autograd wiring.

Counterpart of ``multimodal_dataset_distillation_tpu/ops/pallas_gconv.py``.
The two TPU kernels there (``_spatial_kernel`` and ``_wgrad_kernel``) are
``csrc/gconv3x3.cu`` here, built with ``nvcc`` for ``sm_90a`` into
``build/kernels/libgconv.so`` at first use and called through ``ctypes``.

Public layout is the JAX one: NHWC activations x HWIO weights.

* :func:`gconv3x3_fwd` / :func:`gconv3x3_wgrad` are the raw wrappers.  On a
  CUDA tensor they launch the kernel (or raise); on a CPU tensor they run
  the plain version, :func:`gconv3x3_ref` / :func:`gconv3x3_wgrad_ref`.
* :class:`GConv3x3` and :class:`GConv3x3Wgrad` are the autograd Functions.
  Each backward is built only from ``.apply`` calls of the two, as the
  ``defbilinear`` rules of the JAX primitive are: the transposes of the
  conv are the conv on :func:`rot_swap` of the weight (dgrad) and the
  wgrad; the transposes of the wgrad are convs again.  So the op is
  differentiable to any order, and the distillation meta-backward
  (a second derivative) stays on the kernels.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "gconv3x3.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_PATH = _BUILD_DIR / "libgconv.so"

#: kernel launches per wrapper, counted where the wrapper launches
LAUNCHES = {"gconv3x3_fwd": 0, "gconv3x3_wgrad": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132            # H100 SXM streaming multiprocessors
_WGRAD_ROWS = 128     # kTileM of the .cu file
_WGRAD_COLS = 64      # kTileN
_WGRAD_SLICE = 16     # kTileK
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/gconv3x3.cu`` (when the library is missing or older
    than the source) and load it.  ``verbose`` adds ``-Xptxas -v`` and
    prints nvcc's report (registers, shared memory, spills)."""
    global _lib
    if _lib is not None:
        return _lib
    stale = (not _LIB_PATH.exists()
             or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime)
    if stale or verbose:
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, str(_SRC)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, _LIB_PATH)  # atomic: a concurrent loader sees old or new
    lib = ctypes.CDLL(str(_LIB_PATH))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mdd_gconv3x3_fwd.argtypes = [p, p, p] + [i] * 7 + [p]
    lib.mdd_gconv3x3_fwd.restype = i
    lib.mdd_gconv3x3_wgrad.argtypes = [p, p, p, p] + [i] * 9 + [p]
    lib.mdd_gconv3x3_wgrad.restype = i
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and chip_smoke.py's yardstick on the card)
# ---------------------------------------------------------------------------

def gconv3x3_ref(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """NHWC x HWIO -> NHWC through ``F.conv2d(groups=...)`` with padding 1
    (TF-SAME at stride 1)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1,
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def gconv3x3_wgrad_ref(x: torch.Tensor, ybar: torch.Tensor,
                       groups: int) -> torch.Tensor:
    """dW[dy, dx, c, g*opg + o] = sum over (n, h, w) of
    x[n, h+dy-1, w+dx-1, g*cpg + c] * ybar[n, h, w, g*opg + o]: one batched
    product per tap over zero-padded windows."""
    n, h, wd, c = x.shape
    cpg, opg = c // groups, ybar.shape[-1] // groups
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    yb = ybar.reshape(-1, groups, opg)
    taps = [torch.einsum("mgc,mgo->cgo",
                         xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, groups, cpg),
                         yb)
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, cpg, groups * opg)


def rot_swap(w: torch.Tensor, groups: int) -> torch.Tensor:
    """HWIO grouped kernel -> the kernel of the transposed (input-grad)
    conv: spatially rotated, per-group in/out channels swapped."""
    kh, kw, cpg, feats = w.shape
    opg = feats // groups
    w5 = w.reshape(kh, kw, cpg, groups, opg).flip(0, 1).permute(0, 1, 4, 3, 2)
    return w5.reshape(kh, kw, opg, groups * cpg).contiguous()


# ---------------------------------------------------------------------------
# raw wrappers: the kernel on a CUDA tensor, the plain version on a CPU one
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, other: torch.Tensor) -> None:
    if x.dim() != 4 or other.dim() != 4:
        raise ValueError(f"{name}: expected 4-d tensors, got {tuple(x.shape)}"
                         f" and {tuple(other.shape)}")
    if x.dtype != other.dtype or x.device != other.device:
        raise ValueError(f"{name}: operands differ in dtype or device "
                         f"({x.dtype}/{x.device} vs {other.dtype}/"
                         f"{other.device})")


def _cuda_check(name: str, *ts: torch.Tensor) -> int:
    if ts[0].device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {ts[0].device}")
    if ts[0].dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {ts[0].dtype}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return _DTYPE_CODE[ts[0].dtype]


def gconv3x3_fwd(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """y (N,H,W,F) = grouped 3x3 stride-1 SAME conv of x (N,H,W,C) with
    w (3,3,C/groups,F)."""
    _check("gconv3x3_fwd", x, w)
    n, h, wd, c = x.shape
    kh, kw, cpg, feats = w.shape
    if (kh, kw) != (3, 3) or c != groups * cpg or feats % groups:
        raise ValueError(f"gconv3x3_fwd: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and groups={groups} disagree")
    if x.device.type == "cpu":
        return gconv3x3_ref(x, w, groups)
    code = _cuda_check("gconv3x3_fwd", x, w)
    y = torch.empty((n, h, wd, feats), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.mdd_gconv3x3_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, groups, cpg,
            feats // groups, code, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"gconv3x3_fwd: kernel launch failed, CUDA error "
                           f"{rc}")
    LAUNCHES["gconv3x3_fwd"] += 1
    return y


def wgrad_splits(m: int, groups: int, cpg: int, opg: int) -> tuple:
    """(splits, pixels per split) for the wgrad's first pass: enough blocks
    for about four per SM, each summing at least 256 pixels."""
    tiles = (math.ceil(9 * cpg / _WGRAD_ROWS) * math.ceil(opg / _WGRAD_COLS)
             * groups)
    splits = max(1, min(math.ceil(4 * _SMS / tiles), math.ceil(m / 256)))
    chunk = math.ceil(math.ceil(m / splits) / _WGRAD_SLICE) * _WGRAD_SLICE
    return math.ceil(m / chunk), chunk


def gconv3x3_wgrad(x: torch.Tensor, ybar: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """dW (3,3,C/groups,F) of the conv, from its input x (N,H,W,C) and the
    output cotangent ybar (N,H,W,F); in x's dtype."""
    _check("gconv3x3_wgrad", x, ybar)
    n, h, wd, c = x.shape
    feats = ybar.shape[-1]
    if ybar.shape[:3] != x.shape[:3] or c % groups or feats % groups:
        raise ValueError(f"gconv3x3_wgrad: x {tuple(x.shape)}, ybar "
                         f"{tuple(ybar.shape)} and groups={groups} disagree")
    if x.device.type == "cpu":
        return gconv3x3_wgrad_ref(x, ybar, groups)
    code = _cuda_check("gconv3x3_wgrad", x, ybar)
    cpg, opg = c // groups, feats // groups
    m = n * h * wd
    if m == 0:
        return torch.zeros((3, 3, cpg, feats), dtype=x.dtype, device=x.device)
    splits, chunk = wgrad_splits(m, groups, cpg, opg)
    ws = torch.empty(splits * groups * 9 * cpg * opg, dtype=torch.float32,
                     device=x.device)
    dw = torch.empty((3, 3, cpg, feats), dtype=x.dtype, device=x.device)
    lib = build()
    with torch.cuda.device(x.device):
        rc = lib.mdd_gconv3x3_wgrad(
            x.data_ptr(), ybar.data_ptr(), ws.data_ptr(), dw.data_ptr(), n, h,
            wd, groups, cpg, opg, splits, chunk, code,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"gconv3x3_wgrad: kernel launch failed, CUDA "
                           f"error {rc}")
    LAUNCHES["gconv3x3_wgrad"] += 1
    return dw


# ---------------------------------------------------------------------------
# autograd: every backward is built from .apply of the two Functions
# ---------------------------------------------------------------------------

class GConv3x3(torch.autograd.Function):
    """y = conv(x, w); bilinear in (x, w).  On the card the operands must
    be contiguous: the Function saves its inputs as given, so that its
    backward stays differentiable."""

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        return gconv3x3_fwd(x, w, groups)

    @staticmethod
    def backward(ctx, ybar):
        x, w = ctx.saved_tensors
        g = ctx.groups
        ybar = ybar.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = GConv3x3.apply(ybar, rot_swap(w, g), g)
        if ctx.needs_input_grad[1]:
            dw = GConv3x3Wgrad.apply(x, ybar, g)
        return dx, dw, None


class GConv3x3Wgrad(torch.autograd.Function):
    """dW = wgrad(x, ybar); bilinear in (x, ybar)."""

    @staticmethod
    def forward(ctx, x, ybar, groups):
        ctx.save_for_backward(x, ybar)
        ctx.groups = groups
        return gconv3x3_wgrad(x, ybar, groups)

    @staticmethod
    def backward(ctx, dwbar):
        x, ybar = ctx.saved_tensors
        g = ctx.groups
        dwbar = dwbar.contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = GConv3x3.apply(ybar, rot_swap(dwbar, g), g)
        if ctx.needs_input_grad[1]:
            dy = GConv3x3.apply(x, dwbar, g)
        return dx, dy, None


def gconv3x3(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """Differentiable grouped 3x3 stride-1 SAME conv (NHWC x HWIO -> NHWC)."""
    return GConv3x3.apply(x.contiguous(), w.contiguous(), groups)
