"""Grouped 3x3 stride-1 TF-SAME convolution: CUDA kernels, plain versions,
autograd wiring.

Counterpart of ``multimodal_dataset_distillation_tpu/ops/pallas_gconv.py``.
The two TPU kernels there (``_spatial_kernel`` and ``_wgrad_kernel``) have
four CUDA routes here, each built with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at first use (all sources at once) and called through
``ctypes``:

* ``csrc/gconv3x3_tc.cu``: tensor-core kernels (``wgmma`` with A from
  ldmatrix on halo rows, cp.async halo tiles) for bfloat16 with 64 input
  and 64 output channels per group, every grouped site of NFNet-L0;
* ``csrc/gconv3x3_tf32.cu``: float32 at that width (forward, dgrad and
  wgrad) on the tensor cores, in three TF32 passes (hi*hi + hi*lo + lo*hi
  of the operands split by :func:`tf32_split`), float32-accurate;
* ``csrc/gconv3x3_narrow.cu``: 8 input and 8 output channels per group
  (every grouped site of NF-RegNet-B1) in float32 and bfloat16: a block
  spans up to 8 groups and a run of pixel tiles; bf16 on ``mma.sync``
  tensor cores, the float32 forward on ``mma.sync`` TF32 in three passes,
  the float32 wgrad on CUDA-core FMAs from shared memory;
* ``csrc/gconv3x3.cu``: CUDA-core float32-FMA kernels for everything else
  (other group widths, images too wide for the other kernels' tiles).

:func:`use_tc`, :func:`use_tf32` and :func:`use_narrow` are the rule
between them, by dtype and shape alone.  Whether a tower's grouped convs
come here at all is :func:`configure`'s answer: ``cfg.pallas_gconv``, or
``MDD_PALLAS_GCONV`` when it is set.

Public layout is the JAX one: NHWC activations x HWIO weights.

* :func:`gconv3x3_fwd` / :func:`gconv3x3_wgrad` are the raw wrappers.  On a
  CUDA tensor they launch a kernel (or raise); on a CPU tensor they run
  the plain version, :func:`gconv3x3_ref` / :func:`gconv3x3_wgrad_ref`.
* :class:`GConv3x3` and :class:`GConv3x3Wgrad` are the autograd Functions.
  Each backward is built only from ``.apply`` calls of the two, as the
  ``defbilinear`` rules of the JAX primitive are: the transposes of the
  conv are the conv on :func:`rot_swap` of the weight (dgrad) and the
  wgrad; the transposes of the wgrad are convs again.  Each forward-mode
  rule (``jvp``) is the bilinear product rule, again from ``.apply`` of
  the same two.  So the op is differentiable to any order in either mode
  (``torch.autograd.forward_ad`` dual tensors, ``torch.func.jvp`` /
  ``grad``), and the distillation meta-backward (a second derivative, as
  grad-of-jvp or jvp-of-grad) stays on the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.env import env_bool

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = {"simt": (_CSRC / "gconv3x3.cu", _BUILD_DIR / "libgconv.so"),
            "tc": (_CSRC / "gconv3x3_tc.cu", _BUILD_DIR / "libgconv_tc.so"),
            "tf32": (_CSRC / "gconv3x3_tf32.cu",
                     _BUILD_DIR / "libgconv_tf32.so"),
            "narrow": (_CSRC / "gconv3x3_narrow.cu",
                       _BUILD_DIR / "libgconv_narrow.so")}

#: kernel launches per wrapper route, counted where the wrapper launches:
#: ``gconv3x3_fwd``/``gconv3x3_wgrad`` are the CUDA-core kernels,
#: ``*_tc`` the bfloat16 tensor-core ones, ``*_tf32`` the float32
#: tensor-core ones (the forward's weight pre-pass and main kernel are one
#: launch of its entry point), ``*_narrow`` the 8-channels-per-group ones
LAUNCHES = {"gconv3x3_fwd": 0, "gconv3x3_wgrad": 0,
            "gconv3x3_fwd_tc": 0, "gconv3x3_wgrad_tc": 0,
            "gconv3x3_wgrad_tf32": 0, "gconv3x3_fwd_tf32": 0,
            "gconv3x3_fwd_narrow": 0, "gconv3x3_wgrad_narrow": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132            # H100 SXM streaming multiprocessors
_WGRAD_ROWS = 128     # kTileM of gconv3x3.cu
_WGRAD_COLS = 64      # kTileN
_WGRAD_SLICE = 16     # kTileK
# gconv3x3_tc.cu
TC_WIDTH = 64         # channels per group, in and out
TC_TILE = 128         # pixels per tile
_TC_ROW = 2 * TC_WIDTH            # bytes of one pixel's group row
_TF32_ROW = 4 * TC_WIDTH          # the same in float32 (gconv3x3_tf32.cu)
_SMEM_BLOCK_MAX = 232_448         # dynamic shared memory one block may use
_SMEM_SM = 233_472                # shared memory of one SM (228 KB)
_SMEM_RESERVED = 1_024            # reserved by the runtime per block
_FWD_TC_BLOCKS_PER_SM = 2         # __launch_bounds__ of gconv3x3_fwd_tc
_FWD_TF32_BLOCKS_PER_SM = 1       # __launch_bounds__ of gconv3x3_fwd_tf32
_TF32_SLOT = 2 * TC_WIDTH * TC_WIDTH * 4   # one tap's weight, hi + lo
_TF32_SLOTS = 3                   # the forward's weight ring
# gconv3x3_narrow.cu
NARROW_WIDTH = 8      # channels per group, in and out
NARROW_CHUNK = 8      # groups per block
# __launch_bounds__ of its kernels, by (kind, operand size)
_NARROW_BLOCKS_PER_SM = {("fwd", 2): 3, ("fwd", 4): 2, ("wgrad", 2): 2,
                         ("wgrad", 4): 2}


class _Libs(NamedTuple):
    simt: ctypes.CDLL
    tc: ctypes.CDLL
    tf32: ctypes.CDLL
    narrow: ctypes.CDLL


_libs: Optional[_Libs] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def configure(cfg) -> bool:
    """Whether the towers built for ``cfg`` route their grouped 3x3 convs
    to the kernels: ``cfg.pallas_gconv``, with ``MDD_PALLAS_GCONV=0/1``
    winning when it is set (:func:`..utils.env.env_bool`: empty is unset).

    This is the JAX ``configure`` + ``enabled`` on one device, with two
    deliberate differences:

    * no multi-device force-off.  The JAX gate turns the kernel off, even
      against the variable, whenever more than one device is visible,
      because GSPMD cannot partition a ``pallas_call``.  Here every rank
      launches its own kernels on its own rows, so the value holds at any
      world size;
    * every CLI honours it, ``cli/eval_distilled.py`` included.  The JAX
      eval CLI never calls ``configure``, so there ``--pallas_gconv`` does
      nothing and only the variable acts.  The kernels compute the
      function ``F.conv2d`` does, so only the route differs, not the
      result.
    """
    env = env_bool("MDD_PALLAS_GCONV")
    return bool(getattr(cfg, "pallas_gconv", False)) if env is None else env


def _nvcc_cmd(src: Path, out: str, verbose: bool) -> list:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, str(src)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build(verbose: bool = False) -> _Libs:
    """Compile the kernel sources (those whose library is missing or older
    than the source; one ``nvcc`` each, all started together) and load
    them.  ``verbose`` rebuilds and prints nvcc's report (registers, shared
    memory, spills)."""
    global _libs
    if _libs is not None:
        return _libs
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (src, lib) in _SOURCES.items():
        stale = (not lib.exists()
                 or lib.stat().st_mtime < src.stat().st_mtime)
        if verbose or stale:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            jobs[name] = (tmp, subprocess.Popen(
                _nvcc_cmd(src, tmp, verbose), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"nvcc {name} failed ({proc.returncode}):\n{out}")
            continue
        if verbose:
            print(f"nvcc {_SOURCES[name][0].name}:\n{out}", flush=True)
        os.replace(tmp, _SOURCES[name][1])  # atomic: old or new, never half
    if failed:
        raise RuntimeError("\n".join(failed))
    simt, tc, tf32, narrow = (ctypes.CDLL(str(_SOURCES[name][1]))
                              for name in _Libs._fields)
    p, i = ctypes.c_void_p, ctypes.c_int
    simt.mdd_gconv3x3_fwd.argtypes = [p, p, p] + [i] * 7 + [p]
    simt.mdd_gconv3x3_wgrad.argtypes = [p, p, p, p] + [i] * 9 + [p]
    tc.mdd_gconv3x3_fwd_tc.argtypes = [p, p, p] + [i] * 5 + [p]
    tc.mdd_gconv3x3_wgrad_tc.argtypes = [p, p, p, p] + [i] * 6 + [p]
    tc.mdd_gconv3x3_tc_smem.argtypes = [i, i]
    tf32.mdd_gconv3x3_fwd_tf32.argtypes = [p, p, p, p] + [i] * 5 + [p]
    tf32.mdd_gconv3x3_wgrad_tf32.argtypes = [p, p, p, p] + [i] * 6 + [p]
    tf32.mdd_gconv3x3_tf32_smem.argtypes = [i, i]
    narrow.mdd_gconv3x3_fwd_narrow.argtypes = [p, p, p] + [i] * 6 + [p]
    narrow.mdd_gconv3x3_wgrad_narrow.argtypes = [p, p, p, p] + [i] * 6 + [p]
    narrow.mdd_gconv3x3_narrow_smem.argtypes = [i, i, i]
    for fn in (simt.mdd_gconv3x3_fwd, simt.mdd_gconv3x3_wgrad,
               tc.mdd_gconv3x3_fwd_tc, tc.mdd_gconv3x3_wgrad_tc,
               tc.mdd_gconv3x3_tc_smem, tf32.mdd_gconv3x3_fwd_tf32,
               tf32.mdd_gconv3x3_wgrad_tf32, tf32.mdd_gconv3x3_tf32_smem,
               narrow.mdd_gconv3x3_fwd_narrow,
               narrow.mdd_gconv3x3_wgrad_narrow,
               narrow.mdd_gconv3x3_narrow_smem):
        fn.restype = i
    _libs = _Libs(simt, tc, tf32, narrow)
    return _libs


# ---------------------------------------------------------------------------
# route and grid plans (pure Python: the CPU tests hold them)
# ---------------------------------------------------------------------------

def tc_smem_bytes(kind: str, width: int) -> int:
    """Dynamic shared memory of a tensor-core kernel at image width
    ``width``: ``fwd_smem_bytes``/``wgrad_smem_bytes`` of gconv3x3_tc.cu."""
    halo = TC_TILE + 2 * width + 2
    if kind == "fwd":   # align slack, weights, 2 halos, zero row
        return 1024 + 9 * TC_WIDTH * _TC_ROW + 2 * halo * _TC_ROW + _TC_ROW
    if kind == "wgrad":  # align slack, 2 x (ybar tile + halo), 2 masks, zero row
        return 1024 + 2 * (TC_TILE + halo) * _TC_ROW + 2 * TC_TILE * 2 + _TC_ROW
    raise ValueError(f"unknown kernel kind {kind!r}")


def tf32_smem_bytes(width: int) -> int:
    """Dynamic shared memory of the float32 tensor-core wgrad at image
    width ``width``: ``wgrad_smem_bytes`` of gconv3x3_tf32.cu (align slack,
    ybar hi + lo K-major, 2 x ybar tile, 2 x halo, 2 masks, zero row)."""
    tile = TC_TILE * _TF32_ROW
    halo = TC_TILE + 2 * width + 2
    return (1024 + 4 * tile + 2 * halo * _TF32_ROW + 2 * TC_TILE * 2
            + _TF32_ROW)


def tf32_fwd_smem_bytes(width: int) -> int:
    """Dynamic shared memory of the float32 tensor-core forward at image
    width ``width``: ``fwd_smem_bytes`` of gconv3x3_tf32.cu (align slack,
    a ring of 3 tap weights as hi + lo, 2 x halo, zero row)."""
    halo = TC_TILE + 2 * width + 2
    return (1024 + _TF32_SLOTS * _TF32_SLOT + 2 * halo * _TF32_ROW
            + _TF32_ROW)


def use_tc(kind: str, dtype: torch.dtype, cpg: int, opg: int,
           width: int) -> bool:
    """The dispatch rule: bfloat16 with 64 input and 64 output channels per
    group goes to the tensor-core kernel (``kind`` "fwd" or "wgrad"),
    unless the image is so wide that its halo tiles exceed a block's shared
    memory; everything else to the CUDA-core kernel.  A choice by dtype and
    shape: the wrappers catch no failure of any route."""
    return (dtype == torch.bfloat16 and cpg == TC_WIDTH and opg == TC_WIDTH
            and tc_smem_bytes(kind, width) <= _SMEM_BLOCK_MAX)


def use_tf32(kind: str, dtype: torch.dtype, cpg: int, opg: int,
             width: int) -> bool:
    """The float32 side of the rule: float32 with 64 input and 64 output
    channels per group goes to the three-pass TF32 kernel of ``kind``
    ("fwd", also the dgrad, or "wgrad"), unless the image is so wide that
    its halo tiles exceed a block's shared memory."""
    smem = {"fwd": tf32_fwd_smem_bytes, "wgrad": tf32_smem_bytes}[kind]
    return (dtype == torch.float32 and cpg == TC_WIDTH and opg == TC_WIDTH
            and smem(width) <= _SMEM_BLOCK_MAX)


def narrow_tile(kind: str, itemsize: int) -> int:
    """Pixels per tile of the 8-channel kernel of ``kind`` ("fwd" or
    "wgrad") and operand size ``itemsize`` (2 or 4 bytes): ``tile_of`` of
    gconv3x3_narrow.cu (64 for the float32 wgrad, 128 otherwise)."""
    if kind not in ("fwd", "wgrad"):
        raise ValueError(f"unknown kernel kind {kind!r}")
    return 64 if kind == "wgrad" and itemsize == 4 else 128


def narrow_smem_bytes(kind: str, itemsize: int, width: int) -> int:
    """Dynamic shared memory of the 8-channel kernel of ``kind`` at image
    width ``width``: ``smem_bytes`` of gconv3x3_narrow.cu.  Rows of 64
    channels and 16 bytes of padding: a ring of pixel rows (one tile's halo
    and the next tile's new rows, rounded up to 8), the bf16 forward's
    output tile or the wgrads' two ybar tiles, then tap masks and a zero
    row."""
    tile = narrow_tile(kind, itemsize)
    pitch = NARROW_CHUNK * NARROW_WIDTH * itemsize + 16
    ring = math.ceil((2 * tile + 2 * width + 2) / 8) * 8
    tiles = 2 if kind == "wgrad" else 1 if itemsize == 2 else 0
    return (ring + tiles * tile) * pitch + 2 * tile + 16


def use_narrow(dtype: torch.dtype, cpg: int, opg: int, width: int) -> bool:
    """The rule of the 8-channel kernels (forward, also the dgrad, and
    wgrad): float32 or bfloat16 with 8 input and 8 output channels per
    group, unless the image is so wide that a block's ring of pixel rows
    exceeds its shared memory in either kernel (wider than 295 pixels in
    float32, 547 in bfloat16)."""
    return (dtype in _DTYPE_CODE and cpg == NARROW_WIDTH
            and opg == NARROW_WIDTH
            and all(narrow_smem_bytes(kind, dtype.itemsize, width)
                    <= _SMEM_BLOCK_MAX for kind in ("fwd", "wgrad")))


def narrow_chunks(groups: int) -> int:
    """Blocks across the channels, each of at most 8 groups (64 channels):
    both kernels' grid.x."""
    return math.ceil(groups / NARROW_CHUNK)


def narrow_chunk_groups(groups: int) -> list:
    """The groups of each chunk, ``range(first, stop)``: ``chunk_first`` of
    gconv3x3_narrow.cu, sizes that differ by at most one (G = 11 -> 5 and
    6), so that no block is left with a sliver of the work."""
    n = narrow_chunks(groups)
    return [range(c * groups // n, (c + 1) * groups // n) for c in range(n)]


def narrow_runs(kind: str, m: int, groups: int, itemsize: int, width: int,
                sms: int = _SMS) -> int:
    """Runs of the 8-channel kernel of ``kind``, its grid.y: as many blocks
    (runs x chunks) as fit on the card at once, but no more runs than
    tiles.  Run r covers tiles [r * tiles // runs, (r + 1) * tiles //
    runs): runs differ by at most one tile.  The wgrad's partials are one
    per run."""
    tiles = math.ceil(m / narrow_tile(kind, itemsize))
    smem = narrow_smem_bytes(kind, itemsize, width)
    per_sm = max(1, min(_NARROW_BLOCKS_PER_SM[kind, itemsize],
                        _SMEM_SM // (smem + _SMEM_RESERVED)))
    return max(1, min(tiles, per_sm * sms // narrow_chunks(groups)))


def fwd_tc_blocks(m: int, groups: int, smem: int, blocks_per_sm: int,
                  sms: int = _SMS) -> int:
    """Persistent blocks per group of a tensor-core forward whose block
    takes ``smem`` bytes of dynamic shared memory and whose launch bounds
    allow ``blocks_per_sm`` blocks on an SM.  Block b of a group walks
    pixel tiles b, b + blocks, b + 2 * blocks, ...; as many blocks as fit
    on the card at once, evened out so every block walks the same number
    of tiles (or one fewer)."""
    tiles = math.ceil(m / TC_TILE)
    per_sm = min(blocks_per_sm, _SMEM_SM // (smem + _SMEM_RESERVED))
    cap = max(1, sms * max(per_sm, 1) // groups)
    rounds = math.ceil(tiles / cap)
    return max(1, math.ceil(tiles / rounds))


def wgrad_tc_splits(m: int, groups: int, sms: int = _SMS) -> tuple:
    """(splits, tiles per split) of the tensor-core wgrads (bfloat16 and
    float32): about one block per SM (splits x groups), each summing a
    contiguous run of 128-pixel tiles; split s covers tiles
    [s * per, (s + 1) * per)."""
    tiles = math.ceil(m / TC_TILE)
    per = math.ceil(tiles / max(1, min(tiles, sms // groups)))
    return math.ceil(tiles / per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def tf32_split(t: torch.Tensor):
    """float32 -> (hi, lo), both TF32 values (10 mantissa bits) with
    hi + lo = t to ~2^-22 relative: hi is t rounded to nearest, ties away
    from zero (cvt.rna.tf32.f32), lo the rest rounded the same way.  The
    arithmetic of gconv3x3_tf32.cu's split, for the tests."""
    def rna(a):
        bits = (a.contiguous().view(torch.int32) + 0x1000) & -0x2000
        return bits.view(torch.float32)
    hi = rna(t)
    return hi, rna(t - hi)


def gconv3x3_fwd_tf32_ref(x: torch.Tensor, w: torch.Tensor,
                          groups: int) -> torch.Tensor:
    """The arithmetic of gconv3x3_tf32.cu's forward, for the CPU tests: the
    plain conv of the TF32 parts of x and w in float32, hi*hi + (hi*lo +
    lo*hi), the kernel's two accumulators.  Nothing on the card calls it:
    :func:`gconv3x3_ref` is the kernel's yardstick there."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    return gconv3x3_ref(xh, wh, groups) + (gconv3x3_ref(xh, wl, groups)
                                           + gconv3x3_ref(xl, wh, groups))


def tf32_fwd_weight(w: torch.Tensor, groups: int):
    """The forward's pre-pass in plain PyTorch, for the CPU tests: HWIO w
    (3, 3, 64, groups * 64) -> (hi, lo), each (groups, 9, 64 o, 64 c), the
    weight of each group and tap K-major (an output's 64 input channels
    contiguous), before gconv3x3_tf32.cu's 128-byte swizzle."""
    hi, lo = tf32_split(w)

    def kmajor(t):
        return (t.reshape(9, TC_WIDTH, groups, TC_WIDTH)
                .permute(2, 0, 3, 1).contiguous())
    return kmajor(hi), kmajor(lo)


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


def _route(name: str, kind: str, tc: Optional[bool], dtype: torch.dtype,
           cpg: int, opg: int, width: int, *ts: torch.Tensor) -> str:
    """-> "tc", "tf32", "narrow" or "simt".  ``tc`` None applies
    :func:`use_tc`, :func:`use_tf32` and :func:`use_narrow`; True demands
    the 64-wide tensor-core kernel of the dtype (and raises where none
    applies), False the generic CUDA-core one."""
    fits = ("tc" if use_tc(kind, dtype, cpg, opg, width) else
            "tf32" if use_tf32(kind, dtype, cpg, opg, width) else None)
    if tc and fits is None:
        raise ValueError(f"{name}: the tensor-core kernel takes bfloat16 "
                         f"or float32 with {TC_WIDTH} channels per "
                         f"group in and out and width <= its shared memory; "
                         f"got {dtype}, {cpg}->{opg}, width {width}")
    if tc is None:
        route = fits or ("narrow" if use_narrow(dtype, cpg, opg, width)
                         else "simt")
    else:
        route = fits if tc else "simt"
    if route != "simt" and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the tensor-core kernel needs 16-byte "
                         f"aligned operands")
    return route


def _launched(name: str, rc: int) -> None:
    if rc:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    LAUNCHES[name] += 1


def gconv3x3_fwd(x: torch.Tensor, w: torch.Tensor, groups: int,
                 tc: Optional[bool] = None) -> torch.Tensor:
    """y (N,H,W,F) = grouped 3x3 stride-1 SAME conv of x (N,H,W,C) with
    w (3,3,C/groups,F).  On the card ``tc`` picks the kernel (see
    :func:`_route`); the CPU ignores it."""
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
    opg = feats // groups
    route = _route("gconv3x3_fwd", "fwd", tc, x.dtype, cpg, opg, wd, x, w, y)
    libs = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc":
            blocks = fwd_tc_blocks(n * h * wd, groups,
                                   tc_smem_bytes("fwd", wd),
                                   _FWD_TC_BLOCKS_PER_SM, _sm_count(x.device))
            _launched("gconv3x3_fwd_tc", libs.tc.mdd_gconv3x3_fwd_tc(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, groups,
                blocks, stream))
        elif route == "tf32":
            blocks = fwd_tc_blocks(n * h * wd, groups,
                                   tf32_fwd_smem_bytes(wd),
                                   _FWD_TF32_BLOCKS_PER_SM, _sm_count(x.device))
            wp = torch.empty(2 * w.numel(), dtype=torch.float32,
                             device=x.device)
            _launched("gconv3x3_fwd_tf32", libs.tf32.mdd_gconv3x3_fwd_tf32(
                x.data_ptr(), w.data_ptr(), wp.data_ptr(), y.data_ptr(), n,
                h, wd, groups, blocks, stream))
        elif route == "narrow":
            runs = narrow_runs("fwd", n * h * wd, groups, x.element_size(),
                               wd, _sm_count(x.device))
            _launched("gconv3x3_fwd_narrow",
                      libs.narrow.mdd_gconv3x3_fwd_narrow(
                          x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd,
                          groups, runs, code, stream))
        else:
            _launched("gconv3x3_fwd", libs.simt.mdd_gconv3x3_fwd(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, groups,
                cpg, opg, code, stream))
    return y


def wgrad_splits(m: int, groups: int, cpg: int, opg: int) -> tuple:
    """(splits, pixels per split) for the CUDA-core wgrad's first pass:
    enough blocks for about four per SM, each summing at least 256
    pixels."""
    tiles = (math.ceil(9 * cpg / _WGRAD_ROWS) * math.ceil(opg / _WGRAD_COLS)
             * groups)
    splits = max(1, min(math.ceil(4 * _SMS / tiles), math.ceil(m / 256)))
    chunk = math.ceil(math.ceil(m / splits) / _WGRAD_SLICE) * _WGRAD_SLICE
    return math.ceil(m / chunk), chunk


def gconv3x3_wgrad(x: torch.Tensor, ybar: torch.Tensor, groups: int,
                   tc: Optional[bool] = None) -> torch.Tensor:
    """dW (3,3,C/groups,F) of the conv, from its input x (N,H,W,C) and the
    output cotangent ybar (N,H,W,F); in x's dtype.  On the card ``tc``
    picks the kernel (see :func:`_route`: True is the tensor-core kernel of
    the dtype, the TF32 one for float32); the CPU ignores it."""
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
    dw = torch.empty((3, 3, cpg, feats), dtype=x.dtype, device=x.device)
    route = _route("gconv3x3_wgrad", "wgrad", tc, x.dtype, cpg, opg, wd, x,
                   ybar, dw)
    if route == "simt":
        splits, per = wgrad_splits(m, groups, cpg, opg)
    elif route == "narrow":
        splits = narrow_runs("wgrad", m, groups, x.element_size(), wd,
                             _sm_count(x.device))
    else:
        splits, per = wgrad_tc_splits(m, groups, _sm_count(x.device))
    ws = torch.empty(splits * groups * 9 * cpg * opg, dtype=torch.float32,
                     device=x.device)
    libs = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc":
            _launched("gconv3x3_wgrad_tc", libs.tc.mdd_gconv3x3_wgrad_tc(
                x.data_ptr(), ybar.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                n, h, wd, groups, splits, per, stream))
        elif route == "tf32":
            _launched("gconv3x3_wgrad_tf32",
                      libs.tf32.mdd_gconv3x3_wgrad_tf32(
                          x.data_ptr(), ybar.data_ptr(), ws.data_ptr(),
                          dw.data_ptr(), n, h, wd, groups, splits, per,
                          stream))
        elif route == "narrow":
            _launched("gconv3x3_wgrad_narrow",
                      libs.narrow.mdd_gconv3x3_wgrad_narrow(
                          x.data_ptr(), ybar.data_ptr(), ws.data_ptr(),
                          dw.data_ptr(), n, h, wd, groups, splits, code,
                          stream))
        else:
            _launched("gconv3x3_wgrad", libs.simt.mdd_gconv3x3_wgrad(
                x.data_ptr(), ybar.data_ptr(), ws.data_ptr(), dw.data_ptr(),
                n, h, wd, groups, cpg, opg, splits, per, code, stream))
    return dw


# ---------------------------------------------------------------------------
# autograd: every backward is built from .apply of the two Functions
# ---------------------------------------------------------------------------

def _sum(*terms: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The sum of the terms that are not None (None if all are)."""
    terms = [t for t in terms if t is not None]
    return sum(terms[1:], terms[0]) if terms else None


class GConv3x3(torch.autograd.Function):
    """y = conv(x, w); bilinear in (x, w).  On the card the operands must
    be contiguous: the Function saves its inputs as given, so that its
    backward and its forward-mode rule stay differentiable.  A missing
    cotangent or tangent comes in as None (``set_materialize_grads``), so
    no kernel runs on a zero operand."""

    @staticmethod
    def forward(x, w, groups):
        return gconv3x3_fwd(x, w, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, groups = inputs
        ctx.save_for_backward(x, w)
        ctx.save_for_forward(x, w)
        ctx.groups = groups
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, ybar):
        x, w = ctx.saved_tensors
        g = ctx.groups
        dx = dw = None
        if ybar is not None:
            ybar = ybar.contiguous()
            if ctx.needs_input_grad[0]:
                dx = GConv3x3.apply(ybar, rot_swap(w, g), g)
            if ctx.needs_input_grad[1]:
                dw = GConv3x3Wgrad.apply(x, ybar, g)
        return dx, dw, None

    @staticmethod
    def jvp(ctx, xdot, wdot, _):
        """ydot = conv(xdot, w) + conv(x, wdot)."""
        x, w = ctx.saved_tensors
        g = ctx.groups
        return _sum(
            None if xdot is None else GConv3x3.apply(xdot.contiguous(), w, g),
            None if wdot is None else GConv3x3.apply(x, wdot.contiguous(), g))


class GConv3x3Wgrad(torch.autograd.Function):
    """dW = wgrad(x, ybar); bilinear in (x, ybar)."""

    @staticmethod
    def forward(x, ybar, groups):
        return gconv3x3_wgrad(x, ybar, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ybar, groups = inputs
        ctx.save_for_backward(x, ybar)
        ctx.save_for_forward(x, ybar)
        ctx.groups = groups
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dwbar):
        x, ybar = ctx.saved_tensors
        g = ctx.groups
        dx = dy = None
        if dwbar is not None:
            dwbar = dwbar.contiguous()
            if ctx.needs_input_grad[0]:
                dx = GConv3x3.apply(ybar, rot_swap(dwbar, g), g)
            if ctx.needs_input_grad[1]:
                dy = GConv3x3.apply(x, dwbar, g)
        return dx, dy, None

    @staticmethod
    def jvp(ctx, xdot, ybardot, _):
        """dWdot = wgrad(xdot, ybar) + wgrad(x, ybardot)."""
        x, ybar = ctx.saved_tensors
        g = ctx.groups
        return _sum(
            None if xdot is None
            else GConv3x3Wgrad.apply(xdot.contiguous(), ybar, g),
            None if ybardot is None
            else GConv3x3Wgrad.apply(x, ybardot.contiguous(), g))


def gconv3x3(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """Differentiable grouped 3x3 stride-1 SAME conv (NHWC x HWIO -> NHWC)."""
    return GConv3x3.apply(x.contiguous(), w.contiguous(), groups)
