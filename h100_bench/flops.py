"""The benchmark's own count of the work: model FLOPs and the grouped-conv
kernels' operations, bytes and bounds, from a configuration's layer table.

Model FLOPs (the ``mfu`` metrics).  Convolutions and linear layers count 2
FLOPs per multiply-add; the projection head and the contrastive logits
are included; elementwise work and recomputation are not.  F(n) is one
forward pass over n image-text pairs.  An expert step counts 3 F(batch)
(forward and backward).  An outer distillation step counts
``syn_steps`` x 9 F(mini-batch): 3 F for each inner step's forward and
backward, and 6 F for the meta-backward through it, the backward of that
forward-and-backward graph at twice its cost, which is the work the
reference algorithm (``create_graph=True``) does.  The count is the same
whatever implements the step.

Grouped-conv bounds (the ``gconv_roofline`` metrics): each stride-1
grouped 3x3 site of the tower (the sites the program sends to its
kernels) at mini-batch N, H x W pixels, C channels in and out, ``cpg``
per group:

    FLOPs = 2 N H W C 9 cpg,   bytes = (N H W C + 9 cpg C + N H W C) * size

read once and written once, the same for the forward, the data gradient
(the forward on the flipped weight) and the weight gradient; the bound is
max(FLOPs / peak, bytes / 3.35 TB/s), at 989 TFLOP/s in bfloat16 and, in
float32, three TF32 passes at 495 TFLOP/s.  Per site and inner step the
distillation step needs 8 forward-kind and 4 weight-gradient products (the
inner gradient's forward and data gradient and its weight gradient, then
the meta-backward's primal forward, two tangent products and three data
gradients, and three weight gradients); an expert step 2 and 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .reference import nf

PEAK = {"bfloat16": 989e12, "tf32": 495e12}
HBM_BPS = 3.35e12
TF32_PASSES = 3
GCONV_CALLS = {"distill": (8, 4), "expert": (2, 1)}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _out(h: int, s: int) -> int:
    return -(-h // s)


def conv_layers(t: dict, image_size: int) -> List[dict]:
    """Every convolution of the tower with its input and output size."""
    out = []
    h = image_size
    for name, cin, cout, k, s in nf.stem_convs(t):
        out.append(dict(name=name, cin=cin, cout=cout, k=k, stride=s,
                        groups=1, h=h, ho=_out(h, s)))
        h = _out(h, s)
    for b in nf.blocks(t):
        n, s, ho = b["name"], b["stride"], _out(h, b["stride"])
        if b["transition"]:
            out.append(dict(name=f"{n}.downsample.conv", cin=b["cin"],
                            cout=b["cout"], k=1, stride=1, groups=1, h=ho, ho=ho))
        out.append(dict(name=f"{n}.conv1", cin=b["cin"], cout=b["mid"], k=1,
                        stride=1, groups=1, h=h, ho=h))
        out.append(dict(name=f"{n}.conv2", cin=b["mid"], cout=b["mid"], k=3,
                        stride=s, groups=b["groups"], h=h, ho=ho))
        if t["extra_conv"]:
            out.append(dict(name=f"{n}.conv2b", cin=b["mid"], cout=b["mid"],
                            k=3, stride=1, groups=b["groups"], h=ho, ho=ho))
        out.append(dict(name=f"{n}.conv3", cin=b["mid"], cout=b["cout"], k=1,
                        stride=1, groups=1, h=ho, ho=ho))
        h = ho
    if t["num_features"]:
        out.append(dict(name="final_conv", cin=b["cout"], cout=t["num_features"],
                        k=1, stride=1, groups=1, h=h, ho=h))
    return out


def image_flops(t: dict, image_size: int) -> float:
    """FLOPs of one image through the tower."""
    total = 0.0
    for c in conv_layers(t, image_size):
        total += 2.0 * c["ho"] ** 2 * c["cout"] * (c["cin"] // c["groups"]) * c["k"] ** 2
    if t["attn_rd_ratio"] > 0:
        for b in nf.blocks(t):
            c = b["mid"] if t["reg"] else b["cout"]
            total += 2.0 * 2 * c * nf.se_width(c, t["attn_rd_ratio"])
    if t["num_classes"]:
        total += 2.0 * (t["num_features"] or b["cout"]) * t["num_classes"]
    return total


def text_flops(d_in: int, d_out: int) -> float:
    """FLOPs of one caption embedding through the projection head."""
    return 2.0 * (d_in * d_out + d_out * d_out)


def pass_flops(cfg: dict, n: int) -> float:
    """F(n): n pairs through both students and the n x n logits."""
    d = nf.feature_width(cfg["tower"])
    return (n * (image_flops(cfg["tower"], cfg["image_size"])
                 + text_flops(cfg["text"]["embedding"], d)) + 2.0 * n * n * d)


def distill_step_flops(cfg: dict) -> float:
    hp = cfg["distill"]
    mb = min(hp["mini_batch_size"], hp["num_queries"])
    return hp["syn_steps"] * 9 * pass_flops(cfg, mb)


def expert_step_flops(cfg: dict) -> float:
    return 3 * pass_flops(cfg, cfg["expert"]["batch"])


def gconv_sites(t: dict, image_size: int) -> Dict[Tuple[int, int, int], int]:
    """(H, C, groups) -> count of the stride-1 grouped 3x3 sites."""
    out: Dict[Tuple[int, int, int], int] = {}
    for c in conv_layers(t, image_size):
        if c["k"] == 3 and c["stride"] == 1 and c["groups"] > 1:
            key = (c["h"], c["cin"], c["groups"])
            out[key] = out.get(key, 0) + 1
    return out


def gconv_call(n: int, h: int, c: int, groups: int, dtype: str) -> Tuple[float, float]:
    """(FLOPs, bytes) of one grouped-conv product at a site."""
    cpg = c // groups
    flops = 2.0 * n * h * h * c * 9 * cpg
    nbytes = (2 * n * h * h * c + 9 * cpg * c) * DTYPE_BYTES[dtype]
    return flops, nbytes


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of a product: operations or bytes, whichever bounds."""
    if dtype == "float32":
        t_ops = TF32_PASSES * flops / PEAK["tf32"]
    else:
        t_ops = flops / PEAK[dtype]
    return max(t_ops, nbytes / HBM_BPS)


def tower_pass_bound_s(t: dict, image_size: int, n: int, dtype: str) -> float:
    """Bound of one product at every grouped site of the tower."""
    return sum(k * bound_s(*gconv_call(n, h, c, g, dtype), dtype)
               for (h, c, g), k in gconv_sites(t, image_size).items())


def gconv_step_bound_s(cfg: dict, kind: str) -> float:
    """Bound of the grouped-conv work one step of ``kind`` needs."""
    fwd, wgrad = GCONV_CALLS[kind]
    if kind == "distill":
        hp = cfg["distill"]
        n, dtype, per = (min(hp["mini_batch_size"], hp["num_queries"]),
                         hp["inner_dtype"], hp["syn_steps"])
    else:
        n, dtype, per = cfg["expert"]["batch"], cfg["expert"]["train_dtype"], 1
    return per * (fwd + wgrad) * tower_pass_bound_s(cfg["tower"], cfg["image_size"],
                                                     n, dtype)
