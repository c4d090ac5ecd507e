"""Typed configuration: the port's own copy of the JAX package's ``Config``.

Same field names and defaults as ``multimodal_dataset_distillation_tpu/
config.py`` (the reference's flag names), so one configuration reads the
same in both packages.  The reference-flag argparse shims come with the
port's CLI.

Fields the distillation step of this package reads: ``inner_dtype``,
``inner_scale``, ``hvp_mode``, ``fr_resid_dtype``, ``pallas_gconv``,
``max_grad_norm``, ``image_only``, ``text_only``, the learning rates,
``syn_steps``, ``mini_batch_size``, ``expert_epochs``, ``seed``.

XLA scheduling knobs with no counterpart here, kept for the shared surface
and ignored: ``scan_unroll``, ``carry_mode``, ``remat_inner``,
``remat_group``, ``remat_policy``, ``remat_prevent_cse``, ``fr_remat``,
``fr_bwd``, ``fused_jvp``.  The forward-HVP inner step keeps one inner
step's graph alive at a time, which is what those knobs traded for on XLA.
"""

from __future__ import annotations

import dataclasses
import datetime
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
    # Function per inner step (saved theta, g; reverse-over-reverse
    # recompute in its backward); "reverse" = create_graph=True unroll
    hvp_mode: str = "forward"
    # "inner" stores the Function's theta and g residuals in inner_dtype
    fr_resid_dtype: str = "carry"         # carry | inner
    fr_remat: str = "none"                # ignored
    fr_bwd: str = "rof"                   # ignored
    carry_mode: str = "flat"              # ignored
    parallel_eval: bool = True
    shard_syn: bool = True
    # grouped 3x3 stride-1 convs through the hand-written kernels
    # (ops/gconv.py); off = F.conv2d
    pallas_gconv: bool = False
    stem_s2d: bool = False
    fused_jvp: bool = True                # ignored
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
