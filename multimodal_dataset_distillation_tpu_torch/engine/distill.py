"""Bi-trajectory distillation engine: the outer distillation step.

Counterpart of ``multimodal_dataset_distillation_tpu/engine/distill.py``
(``:54-1027`` there).  Per outer step: start a student
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
  ``(theta, g, x, y, lr, seeds)``; its backward recomputes the loss's
  second derivatives in the direction ``v = lr * ybar`` in the
  orientation ``fr_bwd`` names, as the JAX ``fr_core_bwd`` does
  (:meth:`Distiller._second_order`): ``"rof"`` (the default) the gradient
  of the directional derivative ``h = d/de closs(theta + e v)``, taken in
  forward mode (``torch.autograd.forward_ad``) with the merged-tangent
  conv under ``fused_jvp`` (:mod:`..ops.fused_jvp`); ``"for"`` the jvp of
  ``grad(closs)`` (``torch.func``).  Only one inner step's graph is alive
  at a time.
* ``hvp_mode="reverse"``: the plain ``create_graph=True`` unroll (reference
  semantics, every step's graph kept).  The oracle the Function is held
  against; at full size it is not expected to fit.

Dropout and DropPath masks come from a ``torch.Generator`` seeded per inner
step and tower, so the Function's recompute redraws the same masks.

Data parallelism (``mesh`` of :mod:`..parallel.mesh` with more than one
rank), the JAX Distiller's mesh path: the minibatch is padded to a
multiple of the world (pad-and-mask) and each rank embeds its slots; the
embeddings are gathered (:func:`~..parallel.collectives.gather_rows`), so
every rank computes the same global InfoNCE.  The students' parameters
enter the towers through :func:`~..parallel.collectives.copy_to_ranks`,
whose backward sums over the ranks: every gradient of a replicated tensor
(the inner gradient, the Hessian action, the LR terms) is whole on every
rank, in every ``fr_bwd`` and ``hvp_mode``.  Dropout and DropPath draw the
whole minibatch's masks and keep the rank's rows
(:class:`~..parallel.mesh.RowShard`), so a step at any world is the
one-rank step.  The synthetic set's meta-gradient (each rank's rows' part)
is summed over the ranks; under ``--shard_syn`` it is reduce-scattered
instead, and rank r holds rows ``[r n/W, (r+1) n/W)`` of the set padded
to ``n`` rows with inert pad rows (never indexed: zero meta-gradient), of
their momentum too, and gathers a working copy once per outer step.

Any stateless tower of the zoo distils.  Two configurations do not, as
they do not in the JAX package (:func:`check_distillable`): a tower with
BatchNorm, and a bi-encoder with an image projection.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch import nn
from torch.func import functional_call

from ..config import Config
from ..models.clip_model import VLBiEncoder
from ..models.layers import BatchNorm
from ..ops import fused_jvp
from ..ops.contrastive import RAW_LOG_SCALE, _symmetric_ce, l2_normalize
from ..parallel import collectives as col
from ..parallel.mesh import SINGLE, Mesh, RowShard, pad_to_multiple
from ..utils.flat import FlatParams
from ..utils.logging import counter_group, span
from .buffer_io import load_buffer

_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}

#: :class:`ExpertCycler`'s counters: ``segments`` one per
#: :meth:`~ExpertCycler.next_segment_device`, ``copy_ns`` the host's
#: nanoseconds in its host->device copies (a miss's synchronous copy, a
#: prefetch's pinning and the enqueuing of its copy); each
#: ``cycler.segment`` span carries what they gained inside it
CYCLER = counter_group("cycler", {"segments": 0, "copy_ns": 0})


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
        # the Hessian action (theta) and the mixed terms (x, y, lr) of the
        # inner loss in the direction v = lr * ybar
        hgi, hgt, hx, hy, hlr = d._second_order(
            thi.detach().to(cdt), tht.detach().to(cdt), x.detach(),
            y.detach(), lr_i.detach(), (lr_i * ybi).detach(),
            (lr_t * ybt).detach(), ctx.seeds)
        dlr_i = -torch.dot(gi.to(cdt), ybi) - hlr
        dlr_t = -torch.dot(gt.to(cdt), ybt)
        return (None, dlr_i, dlr_t, -hx, -hy, ybi - hgi, ybt - hgt, None)


def check_distillable(model: VLBiEncoder) -> None:
    """Raise ``ValueError`` for a student the JAX ``Distiller`` cannot run:

    * a tower with BatchNorm (``resnet18``, ``resnet50``): the JAX
      Distiller applies the students in train mode with ``batch_stats``
      frozen and immutable, and flax raises ``ModifyScopeVariableError``
      at the first BatchNorm's running-average update;
    * an image projection (``--only_has_image_projection``): the JAX
      Distiller hands ``encode_image`` the ``image_encoder`` parameters
      alone, and flax finds no ``image_projection`` parameters."""
    if any(isinstance(m, BatchNorm) for m in model.image_encoder.modules()):
        raise ValueError(
            f"--image_encoder={model.image_encoder.encoder_name}: a tower "
            f"with BatchNorm cannot be distilled, as in the JAX package "
            f"(its Distiller runs the students in train mode with frozen "
            f"batch_stats, which flax refuses); take a stateless tower "
            f"such as resnet18_gn")
    if getattr(model, "image_projection", None) is not None:
        raise ValueError(
            "--only_has_image_projection cannot be distilled, as in the JAX "
            "package (its Distiller passes the image tower's parameters "
            "alone, without the image projection's)")


class Distiller:
    """Owns the synthetic state and the outer step; host code feeds expert
    segments."""

    def __init__(self, cfg: Config, model: VLBiEncoder,
                 image_syn, text_syn, *, device="cuda", inner_pad: int = 0,
                 mesh: Optional[Mesh] = None):
        """``inner_pad`` pads each inner minibatch with that many masked
        slots (the exact pad-and-mask loss of the JAX package's mesh path);
        on a ``mesh`` of W ranks it is set from W.  ``image_syn`` and
        ``text_syn`` are the whole set, the same on every rank."""
        check_distillable(model)
        self.cfg = cfg
        self.mesh = mesh or SINGLE
        world = self.mesh.world
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.inner_dtype = _DTYPES.get(cfg.inner_dtype, torch.float32)
        self.out_dtype = (torch.float64 if self.inner_dtype == torch.float64
                          else torch.float32)
        sdt = self.out_dtype  # outer state: f32 unless the f64 check mode
        self._img = FlatParams(model.image_encoder)
        self._txt = FlatParams(model.text_projection)
        self._use_fr = cfg.hvp_mode == "forward"
        if cfg.fr_bwd not in ("rof", "for"):
            raise ValueError(f"fr_bwd={cfg.fr_bwd!r}: expected 'rof' "
                             f"(grad of jvp) or 'for' (jvp of grad)")
        self._fused_jvp = fused_jvp.resolve(cfg) and cfg.fr_bwd == "rof"
        self._resid_dt = (self.inner_dtype
                          if cfg.fr_resid_dtype == "inner"
                          and self.inner_dtype != torch.float64 else None)

        def put(a):
            a = a if torch.is_tensor(a) else np.asarray(a)
            return torch.as_tensor(a, dtype=sdt, device=self.device).clone()

        image_syn, text_syn = put(image_syn), put(text_syn)
        self.n_queries = int(image_syn.shape[0])
        self._inner_mb = int(min(cfg.mini_batch_size, self.n_queries))
        self._inner_pad = int(inner_pad) or (
            pad_to_multiple(self._inner_mb, world) - self._inner_mb)
        if (self._inner_mb + self._inner_pad) % world:
            raise ValueError(f"inner_pad {inner_pad}: a padded minibatch of "
                             f"{self._inner_mb + self._inner_pad} does not "
                             f"split over {world} ranks")
        #: this rank's slots [start, start + per) of the padded minibatch
        self._slots = self.mesh.rows(self._inner_mb + self._inner_pad)
        #: --shard_syn: this rank holds its rows of the set padded to a
        #: multiple of the world
        self._shard_syn = bool(cfg.shard_syn) and world > 1
        self._syn_pad = (pad_to_multiple(self.n_queries, world)
                         - self.n_queries) if self._shard_syn else 0
        image_syn, text_syn = (self._own_syn_rows(t)
                               for t in (image_syn, text_syn))
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
        #: iteration the distill CLI's NaN bailout stopped at (None: none)
        self.nan_bailout_it: Optional[int] = None

    # -- the inner loss --------------------------------------------------

    def _resid_pack(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self._resid_dt) if self._resid_dt is not None else t

    def _generator(self, seed: int):
        """The generator of one inner step's tower; on a mesh a
        :class:`RowShard` of it over the rank's slots."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        if self.mesh.world == 1:
            return g
        return RowShard(g, self._slots[0], self._inner_mb)

    def _own_syn_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Whole-set rows -> what this rank holds (all of them, or under
        --shard_syn its rows of the padded set)."""
        if not self._shard_syn:
            return t
        if self._syn_pad:
            t = torch.cat([t, t.new_zeros((self._syn_pad,) + t.shape[1:])])
        return col.slice_rows(t, self.mesh).detach().clone()

    def _whole_syn(self, t: torch.Tensor) -> torch.Tensor:
        """What this rank holds -> the whole set (padded under
        --shard_syn; a collective)."""
        return col.all_gather_rows(t, self.mesh) if self._shard_syn else t

    def _closs(self, thi, tht, x, y, lr_i, seeds) -> torch.Tensor:
        """Symmetric InfoNCE of the two students on one minibatch; params
        cast to the inner dtype inside the graph, so gradients reach the
        float32 carry through the cast."""
        mesh = self.mesh
        thi, tht = col.copy_to_ranks(thi, mesh), col.copy_to_ranks(tht, mesh)
        pi = self._img.unflatten(thi.to(self.inner_dtype))
        pt = self._txt.unflatten(tht.to(self.inner_dtype))
        f = functional_call(self.model.image_encoder, pi, (x,),
                            {"train": True,
                             "generator": self._generator(seeds[0])})
        g = functional_call(self.model.text_projection, pt, (y,),
                            {"train": True,
                             "generator": self._generator(seeds[1])})
        f = col.gather_rows(l2_normalize(f.to(self.out_dtype)), mesh)
        g = col.gather_rows(l2_normalize(g.to(self.out_dtype)), mesh)
        scale = RAW_LOG_SCALE if self.cfg.inner_scale == "fixed" else lr_i
        logits = scale * (f @ g.T)
        if self._mask is None:
            return _symmetric_ce(logits)
        return _symmetric_ce(logits, self._mask, self._inner_mb)

    def _second_order(self, thi, tht, x, y, lr_i, vi, vt, seeds):
        """-> (hgi, hgt, hx, hy, hlr): the gradients over (thi, tht, x, y,
        lr_i) of h = d/de closs(thi + e vi, tht + e vt), the directional
        derivative of the inner loss, as the JAX ``fr_core_bwd`` takes them.

        ``fr_bwd="rof"``: the reverse pass over h, with h taken in forward
        mode on dual tensors whose tangents sit on the two thetas only (x,
        y and lr enter as plain leaves), WSConv on the merged-tangent conv
        when ``fused_jvp`` is on.  ``"for"``: the jvp, in the direction
        (vi, vt), of the gradient over all five; x, y and lr stay inside
        the jvp as constants, which is JAX's zero tangents on them without
        the zero work."""
        if self.cfg.fr_bwd == "for":
            def grads(a, b):
                return torch.func.grad(
                    lambda a_, b_, x_, y_, l_: self._closs(
                        a_, b_, x_, y_, l_, seeds),
                    argnums=(0, 1, 2, 3, 4))(a, b, x, y, lr_i)

            return torch.func.jvp(grads, (thi, tht), (vi, vt))[1]
        leaves = [t.requires_grad_() for t in (thi, tht, x, y, lr_i)]
        with torch.enable_grad(), fwAD.dual_level(), \
                fused_jvp.activate(self._fused_jvp):
            loss = self._closs(fwAD.make_dual(thi, vi),
                               fwAD.make_dual(tht, vt), *leaves[2:], seeds)
            h = fwAD.unpack_dual(loss).tangent
        hs = torch.autograd.grad(h, leaves, allow_unused=True)
        return [torch.zeros_like(t) if g is None else g
                for g, t in zip(hs, leaves)]

    def _inner_step(self, lr_i, lr_t, image_syn, text_syn, thi, tht, idx,
                    seeds, create_graph: bool):
        if self._inner_pad:
            idx = torch.cat([idx, idx[:1].expand(self._inner_pad)])
        idx = idx[self._slots[0]:self._slots[1]]
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

    def _meta_grads(self, img_th0, txt_th0, img_tgt, txt_tgt, idx_seq,
                    seeds):
        """-> (loss, (img_loss, txt_loss), [g_img, g_txt, g_lr_img,
        g_lr_txt]) at the current state; on a mesh the two set gradients
        are this rank's slots' part (over the whole, padded set), the LR
        gradients whole."""
        st = self.state
        leaves = [t.detach().requires_grad_() for t in
                  (self._whole_syn(st.image_syn), self._whole_syn(st.text_syn),
                   st.syn_lr_img, st.syn_lr_txt)]
        with span("distill.unroll"):
            loss, aux = self.grand_loss(*leaves, img_th0, txt_th0, img_tgt,
                                        txt_tgt, idx_seq, seeds)
        with span("distill.meta_backward"):
            grads = list(torch.autograd.grad(loss, leaves))
        return loss.detach(), aux, grads

    def _outer_update(self, img_th0, txt_th0, img_tgt, txt_tgt, idx_seq,
                      seeds) -> Dict[str, torch.Tensor]:
        with span("distill.step"):
            cfg, st, mesh = self.cfg, self.state, self.mesh
            loss, (img_loss, txt_loss), grads = self._meta_grads(
                img_th0, txt_th0, img_tgt, txt_tgt, idx_seq, seeds)
            g_img, g_txt, g_li, g_lt = grads
            with torch.no_grad():
                # each rank's meta-gradient holds its slots' rows: sum them
                # (this rank's rows of the sum under --shard_syn); the LR
                # gradients are whole on every rank already
                reduce = (col.reduce_scatter_rows if self._shard_syn
                          else col.all_reduce_sum)
                g_img, g_txt = reduce(g_img, mesh), reduce(g_txt, mesh)
                if cfg.text_only:
                    g_img = torch.zeros_like(g_img)
                    g_li = torch.zeros_like(g_li)
                if cfg.image_only:
                    g_txt = torch.zeros_like(g_txt)
                    g_lt = torch.zeros_like(g_lt)
                (u_img,), (m_img,) = self._sgd([g_img], [st.mom_img],
                                               cfg.lr_img)
                (u_txt,), (m_txt,) = self._sgd([g_txt], [st.mom_txt],
                                               cfg.lr_txt)
                (u_li, u_lt), m_lr = self._sgd([g_li, g_lt], list(st.mom_lr),
                                               cfg.lr_lr)
                self.state = DistillState(
                    image_syn=st.image_syn + u_img,
                    text_syn=st.text_syn + u_txt,
                    syn_lr_img=st.syn_lr_img + u_li,
                    syn_lr_txt=st.syn_lr_txt + u_lt,
                    mom_img=m_img, mom_txt=m_txt, mom_lr=tuple(m_lr))
            return {"grand_loss": loss, "img_param_loss": img_loss.detach(),
                    "txt_param_loss": txt_loss.detach(),
                    "syn_lr_img_grad": g_li, "syn_lr_txt_grad": g_lt,
                    "syn_lr_img_pre": st.syn_lr_img,
                    "syn_lr_txt_pre": st.syn_lr_txt,
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
        """(image_syn, text_syn) host copies of the whole set, pad rows
        stripped (a collective on a mesh)."""
        st = self.whole_state()
        return (st.image_syn.cpu().numpy().copy(),
                st.text_syn.cpu().numpy().copy())

    def whole_state(self) -> DistillState:
        """The state with the whole synthetic set and its momentum, pad
        rows stripped: what a checkpoint holds (a collective on a mesh)."""
        st, n = self.state, self.n_queries

        def whole(t):
            return self._whole_syn(t)[:n]

        return dataclasses.replace(
            st, image_syn=whole(st.image_syn), text_syn=whole(st.text_syn),
            mom_img=whole(st.mom_img), mom_txt=whole(st.mom_txt))

    def set_whole_state(self, st: DistillState) -> None:
        """Take a state of the whole set (``n_queries`` rows): every rank
        keeps what it holds, re-padded to this world's pad (exact: pad rows
        are never indexed)."""
        for t in (st.image_syn, st.text_syn, st.mom_img, st.mom_txt):
            if t.shape[0] != self.n_queries:
                raise ValueError(f"a state of {t.shape[0]} rows for "
                                 f"num_queries={self.n_queries}")
        own = self._own_syn_rows
        self.state = dataclasses.replace(
            st, image_syn=own(st.image_syn), text_syn=own(st.text_syn),
            mom_img=own(st.mom_img), mom_txt=own(st.mom_txt))


# ---------------------------------------------------------------------------
# expert buffer cycling (distill.py:450-476, distill_original.py:186-196)
# ---------------------------------------------------------------------------

class ExpertCycler:
    """Shuffle buffer files, walk trajectories, sample start epochs, and
    serve the trajectories on the device.

    The JAX package's cursor walk and random draws, so one seed visits the
    same (file, expert, start) sequence in both packages.  Trajectories are
    read in the templates' flat order (:func:`~.buffer_io.load_buffer`).

    * ``load_all`` (--load_all): every buffer file is read once into host
      memory, keyed by file, and device copies stay cached across files.
    * A bounded cache of device copies, ``device_cache_cap`` trajectories
      (--traj_cache_cap; <= 0 disables it).  The walk is cyclic, where LRU
      misses every time once more trajectories rotate than fit; eviction is
      therefore most-recent-excluding-the-newest: the first cap-1 stay and
      one slot rotates ((cap-1)/N hits for N > cap, all hits for N <= cap).
    * One-step prefetch (--traj_prefetch, cap >= 2): after the cursor
      moves, the next trajectory's host->device copy starts from pinned
      host memory on a side CUDA stream while the current outer step runs;
      the consumer's stream waits on the copy's event.  Cache plus
      in-flight copies stay within the cap.  On a CPU device the copy is
      made at once.
    """

    def __init__(self, img_files: Sequence[str], txt_files: Sequence[str],
                 max_start_epoch: int, expert_epochs: int,
                 img_template: nn.Module, txt_template: nn.Module,
                 max_files: Optional[int] = None, seed: int = 0,
                 max_experts: Optional[int] = None, load_all: bool = False,
                 device_cache_cap: int = 4, prefetch: bool = True,
                 device="cuda"):
        self.img_template, self.txt_template = img_template, txt_template
        self.device = torch.device(device)
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
        self._all: Optional[Dict[str, Tuple[list, list]]] = None
        if load_all:
            self._all = {i: self._read(i, t)
                         for i, t in zip(self.img_files, self.txt_files)}
        self._cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._cache_cap = device_cache_cap
        self._pending: Dict[tuple, tuple] = {}
        self._prefetch = prefetch and device_cache_cap >= 2
        self._stream = None
        self._shuffle()
        self.file_idx = 0
        self.expert_idx = 0
        self._load_current()

    def _read(self, img_path: str, txt_path: str):
        def trim(buf):  # --max_experts (distill.py:258-260)
            return buf[: self.max_experts] if self.max_experts else buf

        return (trim(load_buffer(img_path, self.img_template)),
                trim(load_buffer(txt_path, self.txt_template)))

    def _shuffle(self):
        """shuffle_files (distill.py:79-87): one permutation, both lists."""
        perm = self.rng.permutation(len(self.img_files))
        self.img_files = [self.img_files[i] for i in perm]
        self.txt_files = [self.txt_files[i] for i in perm]

    def _load_current(self):
        if self._all is not None:
            self.img_buffer, self.txt_buffer = self._all[
                self.img_files[self.file_idx]]
            return  # the host arrays are stable: device copies stay cached
        self.img_buffer, self.txt_buffer = self._read(
            self.img_files[self.file_idx], self.txt_files[self.file_idx])
        self._cache.clear()

    def _advance(self) -> Tuple[np.ndarray, np.ndarray, int]:
        """-> (img_traj (T, P), txt_traj (T, Pt), start_epoch); walks the
        expert and file cursors as distill.py:450-465."""
        img_traj = self.img_buffer[self.expert_idx]
        txt_traj = self.txt_buffer[self.expert_idx]
        self._last_key = (self.img_files[self.file_idx], self.expert_idx)
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

    def _put(self, img: np.ndarray, txt: np.ndarray) -> tuple:
        t0 = time.perf_counter_ns()
        out = tuple(torch.as_tensor(a, dtype=torch.float32,
                                    device=self.device) for a in (img, txt))
        CYCLER["copy_ns"] += time.perf_counter_ns() - t0
        return out

    def _put_async(self, img: np.ndarray, txt: np.ndarray) -> tuple:
        """-> (device tensors, pinned host copies, copy event)."""
        if self.device.type != "cuda":
            return self._put(img, txt), (), None
        t0 = time.perf_counter_ns()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        hosts = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                      .pin_memory() for a in (img, txt))
        with torch.cuda.stream(self._stream):
            devs = tuple(h.to(self.device, non_blocking=True) for h in hosts)
            event = torch.cuda.Event()
            event.record(self._stream)
        CYCLER["copy_ns"] += time.perf_counter_ns() - t0
        return devs, hosts, event

    def _claim(self, pending: tuple) -> tuple:
        """A prefetched pair, ordered before the consumer's later work."""
        devs, _, event = pending
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in devs:  # allocated on the side stream, used on this one
                t.record_stream(stream)
        return devs

    def next_segment_device(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """-> (img_traj, txt_traj, start) as float32 tensors on the device,
        for :meth:`Distiller.step_traj`; cached per (file, expert)."""
        with span("cycler.segment", CYCLER):
            CYCLER["segments"] += 1
            img_traj, txt_traj, start = self._advance()
            key = self._last_key
            if self._cache_cap <= 0:
                return (*self._put(img_traj, txt_traj), start)
            # a pending copy of another key has no consumer (the cursor
            # moved without us, e.g. a checkpoint restore): drop it
            for stale in [k for k in self._pending if k != key]:
                self._pending.pop(stale)
            hit = self._cache.get(key)
            if hit is None:
                pending = self._pending.pop(key, None)
                hit = (self._claim(pending) if pending is not None
                       else self._put(img_traj, txt_traj))
                self._cache[key] = hit
                while len(self._cache) > self._cache_cap:
                    victims = [k for k in self._cache if k != key]
                    self._cache.pop(victims[-1])
            self._maybe_prefetch(key)
            return hit[0], hit[1], start

    def _maybe_prefetch(self, current_key) -> None:
        """Start the copy of the trajectory the cursor now points at,
        keeping cache + in-flight <= cap without evicting the one in use or
        the incoming one; skip when no such victim exists."""
        if not self._prefetch:
            return
        nxt = (self.img_files[self.file_idx], self.expert_idx)
        if nxt in self._cache or nxt in self._pending:
            return
        while len(self._cache) + len(self._pending) >= self._cache_cap:
            victims = [k for k in self._cache if k not in (current_key, nxt)]
            if not victims:
                return
            self._cache.pop(victims[-1])
        self._pending[nxt] = self._put_async(self.img_buffer[self.expert_idx],
                                             self.txt_buffer[self.expert_idx])

    def close(self) -> None:
        """Drop the device copies and any copy in flight."""
        self._pending.clear()
        self._cache.clear()


# ---------------------------------------------------------------------------
# synthetic-data initialization (distill_original.py:65-86,138-148)
# ---------------------------------------------------------------------------

def get_images_texts(n: int, dataset, text_encoder,
                     rng: Optional[np.random.RandomState] = None,
                     num_workers: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` random (transformed image, caption CLS embedding) pairs.

    Indices and per-item augment seeds are drawn from ``rng`` exactly as the
    JAX package draws them; each item's augment draws come from its own
    seeded thread-local RNG (:mod:`..utils.augrng`), so the result is the
    same for any ``num_workers`` (a thread pool; decode releases the GIL in
    the C++ pool and in PIL)."""
    from ..utils import augrng

    rng = rng or np.random
    idx = rng.permutation(len(dataset))[:n]
    seeds = rng.randint(0, 2**31 - 1, size=len(idx))

    def fetch(args):
        i, s = args
        augrng.seed_item(s)
        try:
            return dataset[int(i)]
        finally:
            augrng.clear()

    if num_workers > 0:
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
            items = list(ex.map(fetch, zip(idx, seeds)))
    else:
        items = [fetch(a) for a in zip(idx, seeds)]
    images = np.stack([it[0] for it in items])
    texts = text_encoder.encode([it[1] for it in items])
    return images.astype(np.float32), texts.astype(np.float32)


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
