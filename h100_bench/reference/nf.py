"""Plain float32 Normalizer-Free towers built from a layer table.

The table is the ``tower`` object of a configuration file
(``h100_bench/configs/<name>.json``): depths, channels, stem, group size,
bottleneck ratio, SE ratio, skipinit, drop-path rate, head.  From it this
module derives, with no code of the measured program:

* :func:`param_table`: every parameter's name, shape and init kind, in the
  order the program's flat student vector holds them (module registration
  order of timm's ``NormFreeNet``, under the program's ``model.`` prefix);
* :func:`tower_forward`: the forward pass on NHWC images through
  ``F.conv2d`` (grouped convolutions included), TF/flax "SAME" padding,
  scaled weight standardization, SE, stochastic depth from given masks;
* :func:`text_param_table` / :func:`text_forward`: the projection head
  (Linear, exact GELU, Linear, dropout, residual, LayerNorm);
* :func:`contrastive`: the symmetric InfoNCE of the two embeddings.

``quant`` (the precision control): a function applied to both operands of
every convolution and matrix product, e.g. a rounding to float8.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# gamma of x -> act(x) under x ~ N(0, 1) (Brock et al. 2021, Table 5)
GAMMA = {"silu": 1.7881293296813965, "relu": 1.7139588594436646,
         "gelu": 1.7015043497085571}
ACT = {"silu": F.silu, "relu": F.relu, "gelu": F.gelu}
WS_EPS = 1e-6
LN_EPS = 1e-5

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def make_divisible(v: float, divisor: int = 8, round_limit: float = 0.9) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def se_width(features: int, ratio: float, divisor: int = 8) -> int:
    rd = max(int(features * ratio), divisor)
    return int((rd + divisor / 2) // divisor * divisor)


def blocks(t: dict) -> List[dict]:
    """The table expanded to one record per block: widths, stride, groups,
    beta, drop-path rate."""
    wf, div = t.get("width_factor", 1.0), t.get("ch_div", 8)
    stem_chs = make_divisible(t["stem_chs"] * wf, div)
    stem_stride = 2 if t["stem_type"] == "3x3" else 4
    total = sum(t["depths"])
    out, idx, expected_std, prev = [], 0, 1.0, stem_chs
    for si, (depth, chs) in enumerate(zip(t["depths"], t["channels"])):
        out_chs = make_divisible(chs * wf, div)
        stride = 1 if si == 0 and stem_stride > 2 else 2
        for bi in range(depth):
            mid = make_divisible((prev if t["reg"] else out_chs)
                                 * t["bottle_ratio"], div)
            groups = 1
            if t["group_size"]:
                groups = max(1, mid // t["group_size"])
                if t["group_size"] % div == 0:
                    mid = groups * t["group_size"]
            out.append(dict(name=f"stages.{si}.{bi}", cin=prev, cout=out_chs,
                            mid=mid, groups=groups,
                            stride=stride if bi == 0 else 1,
                            beta=1.0 / expected_std, transition=bi == 0,
                            dpr=t["drop_path_rate"] * idx / max(total - 1, 1)))
            if bi == 0:
                expected_std = 1.0
            expected_std = (expected_std ** 2 + t["alpha"] ** 2) ** 0.5
            idx += 1
            prev = out_chs
    return out


def stem_convs(t: dict) -> List[Tuple[str, int, int, int, int]]:
    """(name, cin, cout, kernel, stride) of the stem's convolutions."""
    c = make_divisible(t["stem_chs"] * t.get("width_factor", 1.0),
                       t.get("ch_div", 8))
    if t["stem_type"] == "deep_quad":
        return [("stem.conv1", 3, c // 8, 3, 2), ("stem.conv2", c // 8, c // 4, 3, 1),
                ("stem.conv3", c // 4, c // 2, 3, 1), ("stem.conv4", c // 2, c, 3, 2)]
    if t["stem_type"] == "3x3":
        return [("stem.conv", 3, c, 3, 2)]
    raise ValueError(f"stem {t['stem_type']!r} is not in the reference")


def param_table(t: dict, prefix: str = "model.") -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) in the program's flat order."""
    out: List[Tuple[str, tuple, str]] = []

    def ws(name, cin, cout, k, groups=1):
        out.extend([(f"{prefix}{name}.weight", (cout, cin // groups, k, k), "ws"),
                    (f"{prefix}{name}.bias", (cout,), "zero"),
                    (f"{prefix}{name}.gain", (cout, 1, 1, 1), "one")])

    def se(name, c):
        rd = se_width(c, t["attn_rd_ratio"])
        out.extend([(f"{prefix}{name}.fc1.weight", (rd, c, 1, 1), "fan_in"),
                    (f"{prefix}{name}.fc1.bias", (rd,), "zero"),
                    (f"{prefix}{name}.fc2.weight", (c, rd, 1, 1), "fan_in"),
                    (f"{prefix}{name}.fc2.bias", (c,), "zero")])

    for name, cin, cout, k, _ in stem_convs(t):
        ws(name, cin, cout, k)
    last = None
    for b in blocks(t):
        n = b["name"]
        if t["skipinit"]:
            out.append((f"{prefix}{n}.skipinit_gain", (), "skipinit"))
        if b["transition"]:
            ws(f"{n}.downsample.conv", b["cin"], b["cout"], 1)
        ws(f"{n}.conv1", b["cin"], b["mid"], 1)
        ws(f"{n}.conv2", b["mid"], b["mid"], 3, b["groups"])
        if t["extra_conv"]:
            ws(f"{n}.conv2b", b["mid"], b["mid"], 3, b["groups"])
        if t["attn_rd_ratio"] > 0 and t["reg"]:
            se(f"{n}.attn", b["mid"])
        ws(f"{n}.conv3", b["mid"], b["cout"], 1)
        if t["attn_rd_ratio"] > 0 and not t["reg"]:
            se(f"{n}.attn_last", b["cout"])
        last = b["cout"]
    if t["num_features"]:
        ws("final_conv", last, t["num_features"], 1)
        last = t["num_features"]
    if t["num_classes"]:
        out.extend([(f"{prefix}head.fc.weight", (t["num_classes"], last), "fan_in"),
                    (f"{prefix}head.fc.bias", (t["num_classes"],), "zero")])
    return out


def feature_width(t: dict) -> int:
    if t["num_classes"]:
        return t["num_classes"]
    if t["num_features"]:
        return t["num_features"]
    return make_divisible(t["channels"][-1] * t.get("width_factor", 1.0),
                          t.get("ch_div", 8))


def text_param_table(d_in: int, d_out: int) -> List[Tuple[str, tuple, str]]:
    return [("projection.weight", (d_out, d_in), "fan_in"),
            ("projection.bias", (d_out,), "zero"),
            ("fc.weight", (d_out, d_out), "fan_in"), ("fc.bias", (d_out,), "zero"),
            ("layer_norm.weight", (d_out,), "one"),
            ("layer_norm.bias", (d_out,), "zero")]


def drop_layers(t: dict) -> List[str]:
    """Names of the blocks that draw a stochastic-depth mask, in draw order."""
    return [b["name"] for b in blocks(t) if b["dpr"] > 0]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    ih, iw = x.shape[-2:]
    ph = max((-(-ih // s) - 1) * s + k - ih, 0)
    pw = max((-(-iw // s) - 1) * s + k - iw, 0)
    if not (ph or pw):
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def ws_conv(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
            stride: int = 1, groups: int = 1, quant: Quant = None) -> torch.Tensor:
    w, gain, bias = p[name + ".weight"], p[name + ".gain"], p[name + ".bias"]
    flat = w.reshape(w.shape[0], -1)
    mean = flat.mean(1, keepdim=True)
    var = ((flat - mean) ** 2).mean(1, keepdim=True)
    wn = ((flat - mean) / torch.sqrt((var + WS_EPS) * flat.shape[1])).view_as(w) * gain
    k = w.shape[-1]
    y = F.conv2d(_q(_same_pad(x, k, stride), quant), _q(wn, quant),
                 stride=stride, groups=groups)
    return y + bias.view(1, -1, 1, 1)


def _linear(x, w, b, quant: Quant):
    return _q(x, quant) @ _q(w, quant).T + b


def _se(p, name, x, quant: Quant):
    s = x.mean(dim=(2, 3))
    s = F.relu(_linear(s, p[name + ".fc1.weight"].flatten(1), p[name + ".fc1.bias"], quant))
    s = torch.sigmoid(_linear(s, p[name + ".fc2.weight"].flatten(1),
                              p[name + ".fc2.bias"], quant))
    return x * s[:, :, None, None]


def tower_forward(t: dict, p: Dict[str, torch.Tensor], images: torch.Tensor,
                  masks: Optional[Dict[str, torch.Tensor]] = None,
                  quant: Quant = None, prefix: str = "model.") -> torch.Tensor:
    """(N, H, W, 3) images -> (N, features).  ``masks``: per drop-path block
    name, the (N,) keep mask already divided by the keep rate (None: eval
    mode, no drop)."""
    p = {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}
    gamma = GAMMA[t["act"]]
    act_fn = ACT[t["act"]]

    def act(v):
        return act_fn(v) * gamma

    x = images.permute(0, 3, 1, 2)
    convs = stem_convs(t)
    for i, (name, _, _, _, stride) in enumerate(convs):
        x = ws_conv(p, name, x, stride, quant=quant)
        if i < len(convs) - 1:
            x = act(x)
    for b in blocks(t):
        n = b["name"]
        out = act(x) * b["beta"]
        if b["transition"]:
            sc = out
            if b["stride"] > 1:
                sc = F.avg_pool2d(_same_pad(sc, 2, b["stride"]), 2, b["stride"])
            shortcut = ws_conv(p, f"{n}.downsample.conv", sc, quant=quant)
        else:
            shortcut = x
        out = ws_conv(p, f"{n}.conv1", out, quant=quant)
        out = ws_conv(p, f"{n}.conv2", act(out), b["stride"], b["groups"], quant)
        if t["extra_conv"]:
            out = ws_conv(p, f"{n}.conv2b", act(out), 1, b["groups"], quant)
        if t["attn_rd_ratio"] > 0 and t["reg"]:
            out = t["attn_gain"] * _se(p, f"{n}.attn", out, quant)
        out = ws_conv(p, f"{n}.conv3", act(out), quant=quant)
        if t["attn_rd_ratio"] > 0 and not t["reg"]:
            out = t["attn_gain"] * _se(p, f"{n}.attn_last", out, quant)
        if masks is not None and n in masks:
            out = out * masks[n].view(-1, 1, 1, 1)
        if t["skipinit"]:
            out = out * p[f"{n}.skipinit_gain"]
        x = out * t["alpha"] + shortcut
    if t["num_features"]:
        x = act(ws_conv(p, "final_conv", x, quant=quant))
    x = x.mean(dim=(2, 3))
    if t["num_classes"]:
        if masks is not None and "head" in masks:
            x = x * masks["head"]
        x = _linear(x, p["head.fc.weight"], p["head.fc.bias"], quant)
    return x


def text_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 quant: Quant = None) -> torch.Tensor:
    """The projection head; ``mask`` the dropout's keep mask divided by the
    keep rate (None: eval mode)."""
    proj = _linear(x, p["projection.weight"], p["projection.bias"], quant)
    h = _linear(F.gelu(proj), p["fc.weight"], p["fc.bias"], quant)
    if mask is not None:
        h = h * mask
    z = h + proj
    mean = z.mean(-1, keepdim=True)
    var = ((z - mean) ** 2).mean(-1, keepdim=True)
    return (z - mean) / torch.sqrt(var + LN_EPS) * p["layer_norm.weight"] \
        + p["layer_norm.bias"]


def contrastive(f: torch.Tensor, g: torch.Tensor, scale: float,
                quant: Quant = None) -> torch.Tensor:
    """Symmetric InfoNCE with diagonal targets over l2-normalized rows."""
    f = f / f.norm(dim=1, keepdim=True)
    g = g / g.norm(dim=1, keepdim=True)
    logits = scale * (_q(f, quant) @ _q(g, quant).T)
    n = logits.shape[0]
    diag = torch.arange(n, device=logits.device)
    i2t = -(logits.log_softmax(1)[diag, diag]).mean()
    t2i = -(logits.log_softmax(0)[diag, diag]).mean()
    return (i2t + t2i) / 2


FIXED_LOGIT_SCALE = 1.0 / 0.07          # the trainers' scale
RAW_LOG_SCALE = math.log(1.0 / 0.07)    # the distill inner loop's scale


def unflatten(flat: torch.Tensor, table: Sequence[Tuple[str, tuple, str]]
              ) -> Dict[str, torch.Tensor]:
    sizes = [math.prod(s) for _, s, _ in table]
    return {n: v.view(s) for (n, s, _), v in zip(table, flat.split(sizes))}
