"""Typed configuration: the port's own copy of the JAX package's ``Config``.

Same field names and defaults as ``multimodal_dataset_distillation_tpu/
config.py`` (the reference's flag names), so one configuration reads the
same in both packages.  :func:`parse_config` is the reference-flag shim
of the JAX ``config.py:360-446``: the same flags, ``type=bool`` flags
parsed as strings, store-true switches, ``--dsa True|False``, and unknown
flags warned about and ignored.  ``device`` is a runtime field, not a flag.

Fields the distillation step of this package reads: ``inner_dtype``,
``inner_scale``, ``hvp_mode``, ``fr_bwd``, ``fused_jvp`` (with the
``MDD_FUSED_JVP`` override), ``fr_resid_dtype``, ``pallas_gconv`` (with
the ``MDD_PALLAS_GCONV`` override), ``max_grad_norm``, ``image_only``,
``text_only``, the learning rates, ``syn_steps``, ``mini_batch_size``,
``expert_epochs``, ``seed``.

XLA scheduling knobs with no counterpart here, kept for the shared surface
and ignored: ``scan_unroll``, ``carry_mode``, ``remat_inner``,
``remat_group``, ``remat_policy``, ``remat_prevent_cse``, ``fr_remat``.
The forward-HVP inner step keeps one inner step's graph alive at a time,
which is what the remat knobs traded for on XLA; ``fr_remat`` is a
``jax.checkpoint`` policy inside that step, bit-exact, that only
schedules XLA's recompute against its memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


def _str2bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes", "t", "y")


@dataclass
class Config:
    # ---- dataset / paths ----
    dataset: str = "flickr"
    image_root: str = "./Flickr30k/flickr-image-dataset/flickr30k-images/"
    ann_root: str = "./Flickr30k/ann_file/"
    data_path: str = "./data/Flickr30k/"
    buffer_path: str = "./buffers"
    save_dir: str = "./logged_files"

    # ---- expert (buffer) phase ----
    num_experts: int = 100
    train_epochs: int = 50
    lr_teacher_img: float = 0.1
    lr_teacher_txt: float = 0.1
    mom: float = 0.0
    l2: float = 0.0
    decay: bool = False
    save_interval: int = 10

    # ---- distillation phase ----
    Iteration: int = 50000
    syn_steps: int = 20
    expert_epochs: int = 3
    max_start_epoch: int = 25
    num_queries: int = 100
    mini_batch_size: int = 100
    lr_img: float = 1000.0
    lr_txt: float = 1000.0
    lr_lr: float = 1e-3
    pix_init: str = "real"
    txt_init: str = "real"
    max_files: Optional[int] = None
    max_experts: Optional[int] = None
    load_all: bool = False
    texture: bool = False
    canvas_size: int = 2
    canvas_samples: int = 1
    basis: bool = False
    n_basis: int = 64
    recursive: bool = False
    optimize: str = "reparam"

    # ---- evaluation ----
    eval_it: int = 50
    num_eval: int = 5
    epoch_eval_train: int = 1
    batch_train: int = 128
    eval_mode: str = "S"
    transfer: bool = False
    std: bool = False
    k_test: int = 128

    # ---- model ----
    image_encoder: str = "nfnet"
    text_encoder: str = "bert"
    image_pretrained: bool = True
    text_pretrained: bool = True
    image_trainable: bool = True
    text_trainable: bool = False
    only_has_image_projection: bool = False
    distill: bool = False
    image_size: int = 224

    # ---- augmentation ----
    dsa: bool = True
    dsa_strategy: str = "color_crop_cutout_flip_scale_rotate"
    zca: bool = False
    no_aug: bool = False

    # ---- data loading ----
    batch_size_train: int = 128
    batch_size_test: int = 128
    load_npy: bool = False
    num_workers: int = 4

    # ---- misc (reference surface) ----
    draw: bool = True
    force_save: bool = False
    save_pt: bool = False
    ipc: int = 1
    name: str = field(
        default_factory=lambda: datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    )
    disable_wandb: bool = False
    distributed: bool = False
    margin: float = 0.2
    measure: str = "cosine"
    max_violation: bool = False
    grounding: bool = False

    # ---- additions of the JAX package ----
    # inner-loss logit scale: "fixed" = raw log(1/0.07); "syn_lr" = the
    # learnable inner image LR doubles as the scale
    inner_scale: str = "fixed"
    # dtype of the inner-unroll compute: float32 | bfloat16 | float64
    inner_dtype: str = "float32"
    train_dtype: str = "float32"
    remat_inner: bool = True              # ignored (XLA remat)
    remat_group: int = 1                  # ignored
    remat_policy: str = "none"            # ignored
    remat_prevent_cse: bool = True        # ignored
    scan_unroll: int = 2                  # ignored (XLA scan unroll)
    # meta-backward through each inner SGD step: "forward" = one autograd
    # Function per inner step (saved theta, g; second derivatives in its
    # backward, oriented by fr_bwd); "reverse" = create_graph=True unroll
    hvp_mode: str = "forward"
    # "inner" stores the Function's theta and g residuals in inner_dtype
    fr_resid_dtype: str = "carry"         # carry | inner
    fr_remat: str = "none"                # ignored (XLA remat policy)
    # the Function's backward: "rof" = grad of the directional derivative
    # (forward-mode jvp, reverse pass over it); "for" = jvp of the gradient
    fr_bwd: str = "rof"                   # rof | for
    carry_mode: str = "flat"              # ignored
    parallel_eval: bool = True
    shard_syn: bool = True
    # grouped 3x3 stride-1 convs through the hand-written kernels
    # (ops/gconv.py); off = F.conv2d; env MDD_PALLAS_GCONV=0/1 wins
    # (ops/gconv.py::configure)
    pallas_gconv: bool = False
    stem_s2d: bool = False
    # merged-tangent conv in the "rof" jvp (ops/fused_jvp.py); env
    # MDD_FUSED_JVP=0/1 wins
    fused_jvp: bool = True
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ("data",)
    text_encoder_config: str = "base"     # base | tiny
    seed: int = 0
    synthetic_size: int = 64
    synthetic_test_size: int = 16
    profile_dir: Optional[str] = None
    ckpt_it: int = 0
    resume_from: str = ""
    distilled_npz: str = ""
    parallel_experts: int = 1
    native_decode: bool = True
    device_augment: bool = False
    traj_cache_cap: int = 4
    traj_prefetch: bool = True
    # global-norm clipping of each outer gradient group (0 = off)
    max_grad_norm: float = 0.0
    image_only: bool = False
    text_only: bool = False

    # ---- derived / runtime (not flags) ----
    lr_net: float = 0.1
    device: str = "cuda"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def image_embedding(self) -> int:
        """Projection target dim per image encoder (networks.py:810-819)."""
        table = {
            "nfnet": 1000 if self.transfer else 2304,
            "convnet": 768,
            "resnet18": 512,
            "convnext": 640,
            "nf_tiny": 128,
            "convnet_tiny": 64,
        }
        return table.get(self.image_encoder, 1000)

    @property
    def text_embedding(self) -> int:
        """Text encoder output dim (networks.py:821-826)."""
        if self.text_encoder == "clip":
            return 512
        if self.text_encoder == "bert":
            return 768
        raise NotImplementedError(f"Unsupported text encoder: {self.text_encoder}")


# flags the reference declared with `type=bool`: parsed from a string, so a
# bare `--std` is an error, as it is there
_BOOL_VALUED = {
    "text_pretrained", "image_pretrained", "text_trainable", "image_trainable",
    "load_npy", "only_has_image_projection", "grounding", "distill", "draw",
    "transfer", "std", "load_all", "texture", "recursive",
}
# store_true switches of the reference, and new switches that default off
_STORE_TRUE = {
    "zca", "decay", "max_violation", "force_save", "disable_wandb",
    "distributed", "no_aug", "basis", "device_augment",
}
# `--dsa` is a str choice {'True', 'False'} in the reference
_TRISTATE_STR = {"dsa"}


def add_reference_flags(parser: argparse.ArgumentParser,
                        defaults: Optional[Config] = None
                        ) -> argparse.ArgumentParser:
    """Register the union of the reference's flags (every ``Config`` field
    but the runtime ``device``) on ``parser``."""
    cfg = defaults or Config()
    parser.add_argument("--mesh_shape", type=str,
                        default=",".join(map(str, cfg.mesh_shape)))
    parser.add_argument("--mesh_axes", type=str,
                        default=",".join(cfg.mesh_axes))
    for f in dataclasses.fields(Config):
        if f.name in ("mesh_shape", "mesh_axes", "device"):
            continue
        flag = f"--{f.name}"
        default = getattr(cfg, f.name)
        if f.name in _TRISTATE_STR:
            parser.add_argument(flag, type=str,
                                default="True" if default else "False",
                                choices=["True", "False"])
        elif f.name in _STORE_TRUE:
            parser.add_argument(flag, action="store_true", default=default)
        elif f.name in _BOOL_VALUED or isinstance(default, bool):
            parser.add_argument(flag, type=_str2bool, default=default)
        elif f.name in ("max_files", "max_experts") or isinstance(default, int):
            parser.add_argument(flag, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=str, default=default)
    return parser


def explicit_flags(argv: Optional[Sequence[str]] = None) -> set:
    """Names of the flags present on the command line (``sys.argv`` when
    ``argv`` is None): where a flag the user typed must beat a value read
    from data, which an argparse default cannot say."""
    toks = list(sys.argv[1:]) if argv is None else list(argv)
    return {t[2:].split("=", 1)[0] for t in toks if t.startswith("--")}


def parse_config(argv: Optional[Sequence[str]] = None,
                 defaults: Optional[Config] = None) -> Config:
    """A reference-style command line -> :class:`Config`; unknown flags are
    warned about and ignored (the reference's ``parse_known_args``)."""
    parser = argparse.ArgumentParser(description="Parameter Processing")
    add_reference_flags(parser, defaults)
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print("Warning: Ignoring unknown arguments:", unknown)
    kw: Dict[str, Any] = vars(args)
    kw["dsa"] = _str2bool(kw.get("dsa", "True"))
    kw["mesh_shape"] = tuple(int(x) for x in str(kw.get("mesh_shape", "")
                                                 ).split(",") if x.strip())
    kw["mesh_axes"] = tuple(x for x in str(kw.get("mesh_axes", "data")
                                           ).split(",") if x.strip()) or ("data",)
    if defaults is not None:
        kw["device"] = defaults.device
    valid = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in kw.items() if k in valid})
