"""The plain reference's training algorithms, in float32.

* :func:`inner_grads`: the contrastive loss of one minibatch and its
  gradients over both students, the image tower's taken in row blocks;
* :func:`meta_backward`: reverse-mode through one inner SGD step
  ``theta' = theta - lr * grad L(theta, x, y)``: the cotangents of theta,
  of the minibatch's rows and of the two learning rates, with the Hessian
  action taken in row blocks (below);
* :func:`distill_step`: one outer step: the ``syn_steps`` unroll, the
  grand loss, the meta-gradients and the SGD(momentum 0.5) update of the
  synthetic images, texts and the two learnable learning rates;
* :func:`expert_step`: one SGD step of the expert bi-encoder.

Row blocks.  The loss couples the rows only through the embeddings F
(image) and G (text).  With A = dL/dF and the jvp JF = (dF/dtheta) v, the
Hessian action is

    d/dtheta <grad L, v> = sum_b J_b^T P_b + d/dtheta <v, J_b^T A_b>

where P = d/dF <A(F, G), JF> + <B(F, G), JG> is taken on the embeddings
alone and A_b is held fixed in the second term, which is one block's
reverse-over-reverse.  So no more than one block of rows keeps a graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import nf


@dataclasses.dataclass
class Model:
    """What the reference knows of the two students: the tower's table,
    the two parameter tables, and the rows per block."""
    tower: dict
    img_table: list
    txt_table: list
    rows: int
    quant: nf.Quant = None

    def params(self, theta: torch.Tensor, table) -> Dict[str, torch.Tensor]:
        """Named views of a student; under ``quant`` each parameter rounded
        first, as a program computing in that precision casts its weights."""
        p = nf.unflatten(theta, table)
        if self.quant is None:
            return p
        return {k: self.quant(v) for k, v in p.items()}

    def image(self, theta: torch.Tensor, x: torch.Tensor, masks) -> torch.Tensor:
        return nf.tower_forward(self.tower, self.params(theta, self.img_table),
                                x, masks, self.quant)

    def text(self, theta: torch.Tensor, y: torch.Tensor, mask) -> torch.Tensor:
        return nf.text_forward(self.params(theta, self.txt_table), y, mask,
                               self.quant)

    def blocks(self, n: int) -> List[slice]:
        return [slice(i, min(i + self.rows, n)) for i in range(0, n, self.rows)]


def _cut(masks: Optional[Dict[str, torch.Tensor]], sl: slice):
    return None if masks is None else {k: v[sl] for k, v in masks.items()}


def tower_masks(tower: dict, n: int, gen: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """The stochastic-depth keep masks (divided by the keep rate) of one
    train-mode pass over ``n`` rows, drawn from ``gen`` block by block as
    the program's towers draw them: one uniform (n, 1, 1, 1) per block
    with a nonzero rate, in block order; then the head's dropout, if any."""
    out = {}
    rates = {b["name"]: b["dpr"] for b in nf.blocks(tower)}
    for name in nf.drop_layers(tower):
        keep = 1.0 - rates[name]
        u = torch.rand((n, 1, 1, 1), generator=gen, device=device).view(n)
        out[name] = (u < keep).float() / keep
    if tower["num_classes"] and tower["drop_rate"] > 0:
        keep = 1.0 - tower["drop_rate"]
        width = tower["num_features"] or nf.feature_width(tower)
        u = torch.rand((n, width), generator=gen, device=device)
        out["head"] = (u < keep).float() / keep
    return out


def text_mask(n: int, width: int, rate: float, gen: torch.Generator,
              device) -> Optional[torch.Tensor]:
    if rate == 0:
        return None
    keep = 1.0 - rate
    u = torch.rand((n, width), generator=gen, device=device)
    return (u < keep).float() / keep


def inner_grads(m: Model, thi, tht, x, y, masks_i, mask_t, scale
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (loss, dL/dthi, dL/dtht) of one minibatch."""
    n = x.shape[0]
    with torch.no_grad():
        f = torch.cat([m.image(thi, x[b], _cut(masks_i, b)) for b in m.blocks(n)])
    f = f.requires_grad_()
    b_ = tht.detach().requires_grad_()
    with torch.enable_grad():
        loss = nf.contrastive(f, m.text(b_, y, mask_t), scale, m.quant)
        a, gt = torch.autograd.grad(loss, (f, b_))
    gi = torch.zeros_like(thi)
    for b in m.blocks(n):
        th = thi.detach().requires_grad_()
        with torch.enable_grad():
            fb = m.image(th, x[b], _cut(masks_i, b))
            (g,) = torch.autograd.grad(fb, th, a[b])
        gi += g
    return loss.detach(), gi, gt


def meta_backward(m: Model, thi, tht, x, y, masks_i, mask_t, scale,
                  lr_i, lr_t, ybi, ybt):
    """Cotangents through ``theta' = theta - lr * grad L``: -> (dthi, dtht,
    dx, dy, dlr_i, dlr_t) for the cotangents ``ybi``, ``ybt`` of theta'."""
    n = x.shape[0]
    vi, vt = lr_i * ybi, lr_t * ybt
    fs, jfs = [], []
    for b in m.blocks(n):
        f, jf = torch.func.jvp(lambda th: m.image(th, x[b], _cut(masks_i, b)),
                               (thi,), (vi,))
        fs.append(f)
        jfs.append(jf)
    g, jg = torch.func.jvp(lambda th: m.text(th, y, mask_t), (tht,), (vt,))
    F_, G_ = torch.cat(fs).requires_grad_(), g.detach().requires_grad_()
    JF, JG = torch.cat(jfs).detach(), jg.detach()
    with torch.enable_grad():
        loss = nf.contrastive(F_, G_, scale, m.quant)
        a, bb = torch.autograd.grad(loss, (F_, G_), create_graph=True)
        phi = (a * JF).sum() + (bb * JG).sum()
        p, r = torch.autograd.grad(phi, (F_, G_))
    a, bb = a.detach(), bb.detach()
    hi = torch.zeros_like(thi)
    gi = torch.zeros_like(thi)
    dx = torch.zeros_like(x)
    for b in m.blocks(n):
        th = thi.detach().requires_grad_()
        xb = x[b].detach().requires_grad_()
        with torch.enable_grad():
            f = m.image(th, xb, _cut(masks_i, b))
            (q,) = torch.autograd.grad((a[b] * f).sum(), th, create_graph=True)
            big_q = (p[b] * f).sum() + (q * vi).sum()
            h, hx = torch.autograd.grad(big_q, (th, xb))
        hi += h
        gi += q.detach()
        dx[b] = -hx
    th = tht.detach().requires_grad_()
    yb = y.detach().requires_grad_()
    with torch.enable_grad():
        gg = m.text(th, yb, mask_t)
        (q,) = torch.autograd.grad((bb * gg).sum(), th, create_graph=True)
        big_q = (r * gg).sum() + (q * vt).sum()
        ht, hy = torch.autograd.grad(big_q, (th, yb))
    gt = q.detach()
    return (ybi - hi, ybt - ht, dx, -hy, -torch.dot(gi, ybi),
            -torch.dot(gt, ybt))


@dataclasses.dataclass
class SynState:
    image_syn: torch.Tensor
    text_syn: torch.Tensor
    lr_img: torch.Tensor
    lr_txt: torch.Tensor
    mom: List[torch.Tensor]

    def leaves(self) -> List[torch.Tensor]:
        return [self.image_syn, self.text_syn, self.lr_img, self.lr_txt]


def distill_step(m: Model, st: SynState, seg: Sequence[torch.Tensor],
                 idx_seq: torch.Tensor, seeds: Sequence[Tuple[int, int]],
                 hp: dict, device) -> Tuple[SynState, torch.Tensor, List[torch.Tensor]]:
    """One outer step.  ``seg`` = (theta0_img, theta0_txt, target_img,
    target_txt); ``seeds`` the (image, text) dropout seeds of each inner
    step.  -> (new state, grand loss, meta-gradients of the four leaves)."""
    th0i, th0t, tgti, tgtt = seg
    lr_i, lr_t = st.lr_img, st.lr_txt
    scale = nf.RAW_LOG_SCALE

    def masks(s, n):
        gi = torch.Generator(device=device).manual_seed(int(seeds[s][0]))
        gt = torch.Generator(device=device).manual_seed(int(seeds[s][1]))
        return (tower_masks(m.tower, n, gi, device),
                text_mask(n, hp["text_width"], hp["text_dropout"], gt, device))

    thetas = [(th0i, th0t)]
    for s in range(len(idx_seq)):
        idx = idx_seq[s]
        x, y = st.image_syn[idx], st.text_syn[idx]
        mi, mt = masks(s, len(idx))
        thi, tht = thetas[-1]
        _, gi, gt = inner_grads(m, thi, tht, x, y, mi, mt, scale)
        thetas.append((thi - lr_i * gi, tht - lr_t * gt))
    thi, tht = thetas[-1]
    di, dt = ((th0i - tgti) ** 2).sum(), ((th0t - tgtt) ** 2).sum()
    loss = ((thi - tgti) ** 2).sum() / di + ((tht - tgtt) ** 2).sum() / dt
    ybi, ybt = 2 * (thi - tgti) / di, 2 * (tht - tgtt) / dt
    g_img = torch.zeros_like(st.image_syn)
    g_txt = torch.zeros_like(st.text_syn)
    g_li, g_lt = torch.zeros_like(lr_i), torch.zeros_like(lr_t)
    for s in reversed(range(len(idx_seq))):
        idx = idx_seq[s]
        x, y = st.image_syn[idx], st.text_syn[idx]
        mi, mt = masks(s, len(idx))
        thi, tht = thetas[s]
        ybi, ybt, dx, dy, dli, dlt = meta_backward(
            m, thi, tht, x, y, mi, mt, scale, lr_i, lr_t, ybi, ybt)
        g_img.index_add_(0, idx, dx)
        g_txt.index_add_(0, idx, dy)
        g_li, g_lt = g_li + dli, g_lt + dlt
    grads = [g_img, g_txt, g_li, g_lt]
    lrs = [hp["lr_img"], hp["lr_txt"], hp["lr_lr"], hp["lr_lr"]]
    mom = [g + 0.5 * t for g, t in zip(grads, st.mom)]
    new = [p - lr * t for p, lr, t in zip(st.leaves(), lrs, mom)]
    return SynState(*new, mom=mom), loss, grads


def expert_step(m: Model, thi, tht, images, texts, gen: torch.Generator,
                hp: dict, device):
    """One SGD step (no momentum, no decay) of the expert bi-encoder on a
    batch; the dropout masks drawn from the trainer's one generator, the
    tower's first.  -> (thi', tht', loss, grads)."""
    n = images.shape[0]
    mi = tower_masks(m.tower, n, gen, device)
    mt = text_mask(n, hp["text_width"], hp["text_dropout"], gen, device)
    loss, gi, gt = inner_grads(m, thi, tht, images, texts, mi, mt,
                               nf.FIXED_LOGIT_SCALE)
    return thi - hp["lr_img"] * gi, tht - hp["lr_txt"] * gt, loss, (gi, gt)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """float8 (e4m3) rounding with a per-tensor scale, straight through in
    the derivatives: the control's precision."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    s = amax / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def int8_quant(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 rounding with a per-tensor scale, straight through in
    the derivatives."""
    s = x.detach().abs().amax().clamp_min(1e-12) / 127.0
    q = torch.round(x.detach() / s).clamp(-127, 127) * s
    return x + (q - x).detach()


def bf16_quant(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 rounding, straight through in the derivatives."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


QUANTS = {"float32": None, "float8": fp8_quant, "int8": int8_quant,
          "bfloat16": bf16_quant}
