"""Bi-trajectory distillation engine: the outer distillation step.

Counterpart of ``multimodal_dataset_distillation_tpu/engine/distill.py``
(``:54-717, 724-938, 989-1027`` there).  Per outer step: start a student
at epoch ``t`` of an expert trajectory, take ``syn_steps`` SGD steps on
minibatches of the synthetic data, and minimize

    grand_loss = ||theta_img - theta*_img||^2 / ||theta_img_t - theta*_img||^2
               + the same for the text projection,

backpropagated through the unrolled inner steps into the synthetic pixels,
the synthetic text embeddings and the two learnable inner LRs; then step
three SGD(momentum 0.5) optimizers (optax semantics: the trace starts at
zero, optional ``clip_by_global_norm`` per group).

The student is a flat float32 vector per tower (:mod:`..utils.flat`), and
the towers run through ``torch.func.functional_call`` over views of it.

Meta-backward through each inner step ``theta' = theta - lr * g``:

* ``hvp_mode="forward"``: :class:`_FrCore`, one ``autograd.Function`` per
  inner step (the JAX ``fr_core`` custom VJP, ``:353-438`` there).  Its
  forward takes ``g`` without keeping a graph and saves
  ``(theta, g, x, y, lr, seeds)``; its backward recomputes the loss with
  ``create_graph=True`` and differentiates ``<g, lr * ybar>`` once more, a
  reverse-over-reverse form of the same second derivative JAX takes as
  grad-of-jvp.  Only one inner step's graph is alive at a time.
* ``hvp_mode="reverse"``: the plain ``create_graph=True`` unroll (reference
  semantics, every step's graph kept).  The oracle the Function is held
  against; at full size it is not expected to fit.

Dropout and DropPath masks come from a ``torch.Generator`` seeded per inner
step and tower, so the Function's recompute redraws the same masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..config import Config
from ..models.clip_model import VLBiEncoder
from ..ops.contrastive import RAW_LOG_SCALE, _symmetric_ce, l2_normalize
from ..utils.flat import FlatParams
from .buffer_io import load_buffer

_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclasses.dataclass
class DistillState:
    image_syn: torch.Tensor          # (N, H, W, 3) learned pixels
    text_syn: torch.Tensor           # (N, text_dim) learned embeddings
    syn_lr_img: torch.Tensor         # scalar learnable inner LR (image)
    syn_lr_txt: torch.Tensor         # scalar learnable inner LR (text)
    mom_img: torch.Tensor            # SGD momentum traces (optax: start at 0)
    mom_txt: torch.Tensor
    mom_lr: Tuple[torch.Tensor, torch.Tensor]


class _FrCore(torch.autograd.Function):
    """One inner SGD step of both towers with a hand-written backward."""

    @staticmethod
    def forward(ctx, d, lr_i, lr_t, x, y, thi, tht, seeds):
        with torch.enable_grad():
            a = thi.detach().requires_grad_()
            b = tht.detach().requires_grad_()
            loss = d._closs(a, b, x.detach(), y.detach(), lr_i.detach(), seeds)
            gi, gt = torch.autograd.grad(loss, (a, b))
        ctx.d, ctx.seeds = d, seeds
        pack = d._resid_pack
        ctx.save_for_backward(lr_i, lr_t, x, y, pack(thi), pack(tht),
                              pack(gi), pack(gt))
        return thi - lr_i * gi, tht - lr_t * gt

    @staticmethod
    def backward(ctx, ybi, ybt):
        d = ctx.d
        lr_i, lr_t, x, y, thi, tht, gi, gt = ctx.saved_tensors
        cdt = ybi.dtype  # carry dtype; theta stored in inner dtype is exact
        with torch.enable_grad():
            a = thi.detach().to(cdt).requires_grad_()
            b = tht.detach().to(cdt).requires_grad_()
            xx = x.detach().requires_grad_()
            yy = y.detach().requires_grad_()
            lr = lr_i.detach().requires_grad_()
            loss = d._closs(a, b, xx, yy, lr, ctx.seeds)
            ga, gb = torch.autograd.grad(loss, (a, b), create_graph=True)
            # h = <grad closs, v> at v = lr * ybar: its gradients are the
            # Hessian action (theta) and the mixed terms (x, y, lr)
            h = (torch.dot(ga, (lr_i * ybi).detach())
                 + torch.dot(gb, (lr_t * ybt).detach()))
            hs = torch.autograd.grad(h, (a, b, xx, yy, lr), allow_unused=True)
        hgi, hgt, hx, hy, hlr = [torch.zeros_like(t) if g is None else g
                                 for g, t in zip(hs, (a, b, xx, yy, lr))]
        dlr_i = -torch.dot(gi.to(cdt), ybi) - hlr
        dlr_t = -torch.dot(gt.to(cdt), ybt)
        return (None, dlr_i, dlr_t, -hx, -hy, ybi - hgi, ybt - hgt, None)


class Distiller:
    """Owns the synthetic state and the outer step; host code feeds expert
    segments."""

    def __init__(self, cfg: Config, model: VLBiEncoder,
                 image_syn, text_syn, *, device="cuda", inner_pad: int = 0):
        """``inner_pad`` pads each inner minibatch with that many masked
        slots (the exact pad-and-mask loss of the JAX package's mesh path;
        the data-parallel slice sets it from the world size)."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.inner_dtype = _DTYPES.get(cfg.inner_dtype, torch.float32)
        self.out_dtype = (torch.float64 if self.inner_dtype == torch.float64
                          else torch.float32)
        sdt = self.out_dtype  # outer state: f32 unless the f64 check mode
        self._img = FlatParams(model.image_encoder)
        self._txt = FlatParams(model.text_projection)
        self._use_fr = cfg.hvp_mode == "forward"
        self._resid_dt = (self.inner_dtype
                          if cfg.fr_resid_dtype == "inner"
                          and self.inner_dtype != torch.float64 else None)

        def put(a):
            a = a if torch.is_tensor(a) else np.asarray(a)
            return torch.as_tensor(a, dtype=sdt, device=self.device).clone()

        image_syn, text_syn = put(image_syn), put(text_syn)
        self.n_queries = int(image_syn.shape[0])
        self._inner_mb = int(min(cfg.mini_batch_size, self.n_queries))
        self._inner_pad = int(inner_pad)
        self._mask = None
        if self._inner_pad:
            self._mask = torch.cat([torch.ones(self._inner_mb),
                                    torch.zeros(self._inner_pad)]).to(
                                        self.device, self.out_dtype)
        lr_i = torch.tensor(cfg.lr_teacher_img, dtype=sdt, device=self.device)
        lr_t = torch.tensor(cfg.lr_teacher_txt, dtype=sdt, device=self.device)
        self.state = DistillState(
            image_syn=image_syn, text_syn=text_syn,
            syn_lr_img=lr_i, syn_lr_txt=lr_t,
            mom_img=torch.zeros_like(image_syn),
            mom_txt=torch.zeros_like(text_syn),
            mom_lr=(torch.zeros_like(lr_i), torch.zeros_like(lr_t)))
        #: host generator of the per-inner-step dropout seeds
        self.rng = torch.Generator().manual_seed(cfg.seed)

    # -- the inner loss --------------------------------------------------

    def _resid_pack(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self._resid_dt) if self._resid_dt is not None else t

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _closs(self, thi, tht, x, y, lr_i, seeds) -> torch.Tensor:
        """Symmetric InfoNCE of the two students on one minibatch; params
        cast to the inner dtype inside the graph, so gradients reach the
        float32 carry through the cast."""
        pi = self._img.unflatten(thi.to(self.inner_dtype))
        pt = self._txt.unflatten(tht.to(self.inner_dtype))
        f = functional_call(self.model.image_encoder, pi, (x,),
                            {"train": True,
                             "generator": self._generator(seeds[0])})
        g = functional_call(self.model.text_projection, pt, (y,),
                            {"train": True,
                             "generator": self._generator(seeds[1])})
        f = l2_normalize(f.to(self.out_dtype))
        g = l2_normalize(g.to(self.out_dtype))
        scale = RAW_LOG_SCALE if self.cfg.inner_scale == "fixed" else lr_i
        logits = scale * (f @ g.T)
        if self._mask is None:
            return _symmetric_ce(logits)
        return _symmetric_ce(logits, self._mask, self._inner_mb)

    def _inner_step(self, lr_i, lr_t, image_syn, text_syn, thi, tht, idx,
                    seeds, create_graph: bool):
        if self._inner_pad:
            idx = torch.cat([idx, idx[:1].expand(self._inner_pad)])
        x = image_syn[idx].to(self.inner_dtype)
        y = text_syn[idx].to(self.inner_dtype)
        if self._use_fr:
            return _FrCore.apply(self, lr_i, lr_t, x, y, thi, tht, seeds)
        with torch.enable_grad():
            if not create_graph:
                thi = thi.detach().requires_grad_()
                tht = tht.detach().requires_grad_()
            loss = self._closs(thi, tht, x, y, lr_i, seeds)
            gi, gt = torch.autograd.grad(loss, (thi, tht),
                                         create_graph=create_graph)
        return thi - lr_i * gi, tht - lr_t * gt

    # -- the unroll and its loss -----------------------------------------

    def grand_loss(self, image_syn, text_syn, lr_i, lr_t, img_th0, txt_th0,
                   img_tgt, txt_tgt, idx_seq, seeds):
        """-> (loss, (img_loss, txt_loss)); differentiable in the first four
        arguments.  ``idx_seq`` (syn_steps, mb) long, ``seeds``
        (syn_steps, 2) ints."""
        thi, tht = img_th0, txt_th0
        if not self._use_fr:
            thi = thi.detach().requires_grad_()
            tht = tht.detach().requires_grad_()
        for s in range(len(idx_seq)):
            thi, tht = self._inner_step(lr_i, lr_t, image_syn, text_syn, thi,
                                        tht, idx_seq[s], seeds[s],
                                        create_graph=True)

        def mse(a, b):
            return ((a.to(b.dtype) - b) ** 2).sum()

        img_loss = mse(thi, img_tgt) / mse(img_th0, img_tgt)
        txt_loss = mse(tht, txt_tgt) / mse(txt_th0, txt_tgt)
        return img_loss + txt_loss, (img_loss, txt_loss)

    @torch.no_grad()
    def unroll(self, image_syn, text_syn, lr_i, lr_t, img_th0, txt_th0,
               idx_seq, seeds):
        """Diagnostic: every per-step student, (syn_steps, P) per tower."""
        his, hts = [], []
        thi, tht = img_th0, txt_th0
        for s in range(len(idx_seq)):
            thi, tht = self._inner_step(lr_i, lr_t, image_syn, text_syn, thi,
                                        tht, idx_seq[s], seeds[s],
                                        create_graph=False)
            thi, tht = thi.detach(), tht.detach()
            his.append(thi)
            hts.append(tht)
        return torch.stack(his), torch.stack(hts)

    # -- the outer step ----------------------------------------------------

    def _sgd(self, grads, traces, lr):
        """optax chain(clip_by_global_norm?, sgd(lr, momentum=0.5)) over one
        parameter group -> (updates, new traces)."""
        max_norm = self.cfg.max_grad_norm
        if max_norm:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            grads = [torch.where(norm < max_norm, g, g / norm * max_norm)
                     for g in grads]
        traces = [g + 0.5 * t for g, t in zip(grads, traces)]
        return [-lr * t for t in traces], traces

    def _outer_update(self, img_th0, txt_th0, img_tgt, txt_tgt, idx_seq,
                      seeds) -> Dict[str, torch.Tensor]:
        cfg, st = self.cfg, self.state
        leaves = [t.detach().requires_grad_() for t in
                  (st.image_syn, st.text_syn, st.syn_lr_img, st.syn_lr_txt)]
        loss, (img_loss, txt_loss) = self.grand_loss(
            *leaves, img_th0, txt_th0, img_tgt, txt_tgt, idx_seq, seeds)
        g_img, g_txt, g_li, g_lt = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            if cfg.text_only:
                g_img, g_li = torch.zeros_like(g_img), torch.zeros_like(g_li)
            if cfg.image_only:
                g_txt, g_lt = torch.zeros_like(g_txt), torch.zeros_like(g_lt)
            (u_img,), (m_img,) = self._sgd([g_img], [st.mom_img], cfg.lr_img)
            (u_txt,), (m_txt,) = self._sgd([g_txt], [st.mom_txt], cfg.lr_txt)
            (u_li, u_lt), m_lr = self._sgd([g_li, g_lt], list(st.mom_lr),
                                           cfg.lr_lr)
            self.state = DistillState(
                image_syn=st.image_syn + u_img, text_syn=st.text_syn + u_txt,
                syn_lr_img=st.syn_lr_img + u_li,
                syn_lr_txt=st.syn_lr_txt + u_lt,
                mom_img=m_img, mom_txt=m_txt, mom_lr=tuple(m_lr))
        return {"grand_loss": loss.detach(), "img_param_loss": img_loss.detach(),
                "txt_param_loss": txt_loss.detach(),
                "syn_lr_img_grad": g_li, "syn_lr_txt_grad": g_lt,
                "syn_lr_img_pre": st.syn_lr_img, "syn_lr_txt_pre": st.syn_lr_txt,
                "syn_lr_img": self.state.syn_lr_img,
                "syn_lr_txt": self.state.syn_lr_txt}

    def draw_seeds(self, n: int) -> List[Tuple[int, int]]:
        """(image, text) dropout seeds for ``n`` inner steps."""
        s = torch.randint(0, 2 ** 62, (n, 2), generator=self.rng)
        return [tuple(int(v) for v in row) for row in s]

    def _indices(self, idx_seq) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx_seq), dtype=torch.long,
                               device=self.device)

    def _flat(self, a) -> torch.Tensor:
        a = a if torch.is_tensor(a) else np.asarray(a)
        return torch.as_tensor(a, dtype=self.out_dtype, device=self.device)

    def step(self, img_th0, txt_th0, img_tgt, txt_tgt,
             idx_seq) -> Dict[str, torch.Tensor]:
        """One outer step on a host-supplied segment (flat vectors in this
        package's order)."""
        idx = self._indices(idx_seq)
        return self._outer_update(self._flat(img_th0), self._flat(txt_th0),
                                  self._flat(img_tgt), self._flat(txt_tgt),
                                  idx, self.draw_seeds(len(idx)))

    def step_traj(self, traj_img: torch.Tensor, traj_txt: torch.Tensor,
                  start: int, idx_seq) -> Dict[str, torch.Tensor]:
        """Outer step on device-resident (T, P) trajectories (put once with
        :meth:`put_trajectory`): theta_0 and theta* are sliced on the
        device."""
        idx = self._indices(idx_seq)
        e = self.cfg.expert_epochs
        return self._outer_update(traj_img[start], traj_txt[start],
                                  traj_img[start + e], traj_txt[start + e],
                                  idx, self.draw_seeds(len(idx)))

    def put_trajectory(self, traj) -> torch.Tensor:
        """Host (T, P) stacked trajectory -> device float32 tensor."""
        return torch.as_tensor(np.asarray(traj, np.float32),
                               device=self.device)

    def sample_indices(self, rng: np.random.RandomState) -> np.ndarray:
        """(syn_steps, mini_batch_size) minibatch indices; per step a fresh
        randperm prefix (distill_original.py:414-416)."""
        n = self.n_queries
        m = min(self.cfg.mini_batch_size, n)
        return np.stack([rng.permutation(n)[:m]
                         for _ in range(self.cfg.syn_steps)])

    def syn_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(image_syn, text_syn) host copies."""
        return (self.state.image_syn.cpu().numpy().copy(),
                self.state.text_syn.cpu().numpy().copy())


# ---------------------------------------------------------------------------
# expert buffer cycling (distill.py:450-476, distill_original.py:186-196)
# ---------------------------------------------------------------------------

class ExpertCycler:
    """Shuffle buffer files, walk trajectories, sample start epochs.

    The JAX package's cursor walk and random draws, so one seed visits the
    same (file, expert, start) sequence in both packages.  Trajectories are
    read in the templates' flat order (:func:`~.buffer_io.load_buffer`).
    The bounded device cache with prefetch, and ``load_all``, come in a
    later slice.
    """

    def __init__(self, img_files: Sequence[str], txt_files: Sequence[str],
                 max_start_epoch: int, expert_epochs: int,
                 img_template: nn.Module, txt_template: nn.Module,
                 max_files: Optional[int] = None, seed: int = 0,
                 max_experts: Optional[int] = None):
        self.img_template, self.txt_template = img_template, txt_template
        self.rng = np.random.RandomState(seed)
        if max_files:
            img_files = list(img_files)[:max_files]
            txt_files = list(txt_files)[:max_files]
        self.img_files = list(img_files)
        self.txt_files = list(txt_files)
        if not self.img_files:
            raise AssertionError("No buffers detected")
        self.max_start_epoch = max_start_epoch
        self.expert_epochs = expert_epochs
        self.max_experts = max_experts
        self._shuffle()
        self.file_idx = 0
        self.expert_idx = 0
        self._load_current()

    def _read(self, img_path: str, txt_path: str):
        def trim(buf):
            return buf[: self.max_experts] if self.max_experts else buf

        return (trim(load_buffer(img_path, self.img_template)),
                trim(load_buffer(txt_path, self.txt_template)))

    def _shuffle(self):
        perm = self.rng.permutation(len(self.img_files))
        self.img_files = [self.img_files[i] for i in perm]
        self.txt_files = [self.txt_files[i] for i in perm]

    def _load_current(self):
        self.img_buffer, self.txt_buffer = self._read(
            self.img_files[self.file_idx], self.txt_files[self.file_idx])

    def _advance(self) -> Tuple[np.ndarray, np.ndarray, int]:
        img_traj = self.img_buffer[self.expert_idx]
        txt_traj = self.txt_buffer[self.expert_idx]
        self.expert_idx += 1
        if self.expert_idx == len(self.img_buffer):
            self.expert_idx = 0
            self.file_idx += 1
            if self.file_idx == len(self.img_files):
                self.file_idx = 0
                self._shuffle()
            if len(self.img_files) > 1:
                self._load_current()
        hi = max(1, min(self.max_start_epoch,
                        len(img_traj) - self.expert_epochs))
        start = int(self.rng.randint(0, hi))
        return img_traj, txt_traj, start

    def next_segment(self):
        """-> (img_theta0, txt_theta0, img_target, txt_target, start)."""
        img_traj, txt_traj, start = self._advance()
        tgt = start + self.expert_epochs
        return (img_traj[start], txt_traj[start],
                img_traj[tgt], txt_traj[tgt], start)

    def next_segment_device(self, device="cuda"):
        """-> (img_traj, txt_traj, start) as float32 tensors on ``device``,
        for :meth:`Distiller.step_traj`."""
        img_traj, txt_traj, start = self._advance()
        return (torch.as_tensor(img_traj, dtype=torch.float32, device=device),
                torch.as_tensor(txt_traj, dtype=torch.float32, device=device),
                start)


# ---------------------------------------------------------------------------
# synthetic-data initialization (distill_original.py:65-86,138-148)
# ---------------------------------------------------------------------------

# per-channel stats of CLIP-normalized natural images
PIX_NOISE_MEAN = np.array([-0.0626, -0.0221, 0.0680], np.float32)
PIX_NOISE_STD = np.array([1.0451, 1.0752, 1.0539], np.float32)
TXT_NOISE_MEAN, TXT_NOISE_STD = -0.0094, 0.5253


def noise_images(n: int, image_size: int,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """(n, H, W, 3) noise with natural-image channel statistics."""
    rng = rng or np.random
    x = rng.randn(n, image_size, image_size, 3).astype(np.float32)
    return x * PIX_NOISE_STD + PIX_NOISE_MEAN


def noise_texts(n: int, dim: int = 768,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    return (rng.randn(n, dim) * TXT_NOISE_STD + TXT_NOISE_MEAN).astype(np.float32)


def dummy_trajectory(snapshot: Sequence[np.ndarray], copies: int = 2,
                     rng: Optional[np.random.RandomState] = None
                     ) -> List[List[np.ndarray]]:
    """Dummy-buffer bootstrap (distill.py:262-274): a trajectory of
    ``copies`` snapshots (lists of per-parameter arrays), each a small
    perturbation of the last (scalars such as skipinit gains kept), so the
    normalized trajectory loss is not 0/0."""
    rng = rng or np.random.RandomState(0)
    out = [[np.asarray(x) for x in snapshot]]
    for _ in range(copies - 1):
        out.append([x + 1e-3 * rng.randn(*x.shape).astype(x.dtype)
                    if x.ndim else x for x in out[-1]])
    return out
