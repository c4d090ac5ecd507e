"""Bi-encoder training: the expert phase's and the synthetic-set eval's SGD.

Counterpart of ``multimodal_dataset_distillation_tpu/engine/expert.py``
(reference ``buffer.py`` + ``epoch``).  Two SGD optimizers, image
tower and text projection, stepped per batch exactly as the reference
steps them (``epoch_original.py:53-57``, ``buffer.py:59-60``).  The frozen
text encoder runs outside: batches carry cached text embeddings.

Dropout, DropPath and the ``--device_augment`` plan draw from one
``torch.Generator`` per trainer, seeded at :meth:`BiEncoderTrainer.reset`,
and each step's backward pass takes only cuDNN's deterministic algorithms
(:func:`deterministic_cudnn`), so one seed gives one run, bit for bit,
on the card as on the CPU.  Loss and
accuracy stay on the device until the end of an epoch, which reads them
once.

Data parallelism (a ``mesh`` of :mod:`..parallel.mesh`), the JAX
trainers' mesh path: :class:`BiEncoderTrainer` takes its rows of each
global batch, computes the global contrastive loss over the gathered
embeddings, sums the parameter gradients over the ranks and takes
BatchNorm's moments over the global batch; its dropout, drop-path and
augment draws are the global batch's, cut to its rows
(:class:`~..parallel.mesh.RowShard`), so a step at any world is the
one-rank step.  :class:`ParallelExpertTrainer` splits its K models over
the ranks, as the JAX package shards K over ``data``.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.transforms import CLIP_MEAN, CLIP_STD
from ..models.clip_model import VLBiEncoder, VLBiEncoderTrainableText
from ..models.layers import sync_batchnorm
from ..ops.contrastive import FIXED_LOGIT_SCALE, contrastive_loss_and_acc
from ..ops.randaugment_device import random_augment
from ..parallel import collectives as col
from ..parallel.mesh import SINGLE, Mesh, RowShard
from ..utils.logging import span

StateDict = Dict[str, torch.Tensor]


def torch_sgd(params: Iterable[torch.Tensor], lr: float,
              momentum: float = 0.0,
              weight_decay: float = 0.0) -> torch.optim.SGD:
    """torch's SGD: g += wd * p, then the momentum trace (whose first value
    is g), then p -= lr * trace; the JAX package's optax chain
    add_decayed_weights -> trace -> scale(-lr).  ``lr`` may be negative, as
    there (a learned LR the outer loop drove below zero): torch refuses one
    only at construction, so it is set after."""
    opt = torch.optim.SGD(params, lr=abs(lr), momentum=momentum,
                          weight_decay=weight_decay)
    for group in opt.param_groups:
        group["lr"] = lr
    return opt


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms only, inside the block.  Left to its
    heuristics, cuDNN takes the weight gradient of the NF stems' first conv
    (3 -> 16 channels, 3x3, stride 2, at 224^2) with an algorithm whose
    sums land in a different order from call to call, so two students
    trained from one init and one seed drifted apart.  Every other op of
    NFNet-L0's training step, and the scoring pass, repeated bit for bit
    without it (``tools/torch_eval_repro.py``)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _epoch_means(per: List[Tuple[torch.Tensor, torch.Tensor, int]]
                 ) -> Tuple[float, float]:
    """(sample-weighted mean loss, summed acc / samples) of an epoch's
    batches, read from the device once."""
    if not per:
        return 0.0, 0.0
    stats = torch.stack([torch.stack((loss.float(), acc.float()))
                         for loss, acc, _ in per]).cpu().tolist()
    num = sum(n for _, _, n in per)
    loss_sum = sum(s[0] * n for s, (_, _, n) in zip(stats, per))
    acc_sum = sum(s[1] for s in stats)
    return loss_sum / max(num, 1), acc_sum / max(num, 1)


class BiEncoderTrainer:
    """Trains ``model`` in place, on the model's device.

    ``variables`` (a state dict, or None to keep the model's weights) is
    loaded first.  ``compute_dtype="bfloat16"`` is the fork's AMP epoch
    (``epoch.py:59-98``): the parameters are cast inside the graph, so the
    gradients reach the float32 masters through the cast; the image tower
    computes in bfloat16 and the text projection in float32 from
    bfloat16-rounded weights (flax's dtype promotion in the JAX package).

    ``device_augment`` (``--device_augment``): images arrive as raw [0, 255]
    crops, and each step draws a RandAugment(2, 5) plan from the trainer's
    generator (before any dropout draw), augments on the device, applies
    the CLIP normalisation and only then the bfloat16 cast.

    ``mesh``: data parallelism over its ranks; each takes its equal share
    of the rows of every global batch (``train_batch`` gets those rows)
    and the model, loaded with the same ``variables`` on every rank,
    stays the same on every rank.
    """

    #: the submodule the text optimizer steps and the text snapshot holds
    text_tower = "text_projection"

    def __init__(self, model: VLBiEncoder, variables: Optional[StateDict] = None,
                 *, lr_img: float, lr_txt: float, momentum: float = 0.0,
                 weight_decay: float = 0.0, seed: int = 0,
                 compute_dtype: str = "float32",
                 device_augment: bool = False, mesh: Optional[Mesh] = None):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or "
                             f"bfloat16")
        self.model = model
        self.mesh = mesh or SINGLE
        if self.mesh.world > 1:
            sync_batchnorm(model, self.mesh)
        self.device = next(model.parameters()).device
        self.compute_dtype = compute_dtype
        self.device_augment = device_augment
        self._mean, self._std = (torch.as_tensor(v, device=self.device)
                                 for v in (CLIP_MEAN, CLIP_STD))
        self.momentum, self.weight_decay = momentum, weight_decay
        self.reset(variables, seed=seed, lr_img=lr_img, lr_txt=lr_txt)

    def reset(self, variables: Optional[StateDict], *, seed: int,
              lr_img: Optional[float] = None,
              lr_txt: Optional[float] = None) -> None:
        """Re-arm as a fresh trainer: new weights (if given), zero momentum
        traces, the generator at ``seed``, and the learning rates (runtime
        values: one trainer serves every eval block's learned LR)."""
        if variables is not None:
            self.model.load_state_dict(variables)
        self.lr_img = float(self.lr_img if lr_img is None else lr_img)
        self.lr_txt = float(self.lr_txt if lr_txt is None else lr_txt)
        self.reset_optimizers(self.lr_img, self.lr_txt, self.momentum,
                              self.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))

    def reset_optimizers(self, lr_img: float, lr_txt: float,
                         momentum: float = 0.0,
                         weight_decay: float = 0.0) -> None:
        """Fresh SGD at these hyperparameters (the reference's step decay
        recreates the optimizers, buffer.py:97-102 /
        epoch_original.py:190-192)."""
        self.lr_img, self.lr_txt = float(lr_img), float(lr_txt)
        self.momentum, self.weight_decay = momentum, weight_decay
        self.opt_img = torch_sgd(self.model.image_encoder.parameters(),
                                 self.lr_img, momentum, weight_decay)
        self.opt_txt = torch_sgd(
            getattr(self.model, self.text_tower).parameters(), self.lr_txt,
            momentum, weight_decay)

    def _draws(self, n: int):
        """The generator of a step on ``n`` local rows: on a mesh a
        :class:`RowShard` of the global batch."""
        if self.mesh.world == 1:
            return self.generator
        return RowShard(self.generator, self.mesh.rank * n,
                        n * self.mesh.world)

    def _rows(self, n: int) -> int:
        """The global batch's rows for ``n`` local ones."""
        return n * self.mesh.world

    def _loss(self, images: torch.Tensor, texts: torch.Tensor):
        """The global batch's contrastive loss and accuracy: this rank's
        rows embedded, the embeddings gathered over the ranks."""
        m, gen = self.model, self._draws(len(images))
        if self.compute_dtype == "float32":
            img = m.encode_image(images, True, gen)
            txt = m.project_text(texts, True, gen)
        else:
            bf16 = torch.bfloat16
            img = functional_call(
                m.image_encoder, {n: p.to(bf16) for n, p in
                                  m.image_encoder.named_parameters()},
                (images.to(bf16), True, gen))
            if m.image_projection is not None:
                img = m.image_projection(img, True, gen)
            txt = functional_call(
                m.text_projection, {n: p.to(bf16).float() for n, p in
                                    m.text_projection.named_parameters()},
                (texts, True, gen))
        img, txt = (col.gather_rows(t.float(), self.mesh) for t in (img, txt))
        return contrastive_loss_and_acc(img, txt, FIXED_LOGIT_SCALE)

    def train_batch(self, images, text_feats
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step on (B, H, W, 3) images and (B, D) text features
        (arrays or tensors); -> (loss, acc) on the device."""
        with span("expert.step"):
            with span("expert.put"):
                texts = torch.as_tensor(text_feats, dtype=torch.float32,
                                        device=self.device)
                images = self._put(images)
            return self._step(self._loss(self._augment(images), texts))

    def _put(self, images) -> torch.Tensor:
        """The step's input images on the device, float32."""
        return torch.as_tensor(images, dtype=torch.float32,
                               device=self.device)

    def _augment(self, images: torch.Tensor) -> torch.Tensor:
        """The step's device images, augmented and normalised under
        ``device_augment``."""
        if self.device_augment:
            images = random_augment(images, self._draws(len(images)))
            images = (images / 255.0 - self._mean) / self._std
        return images

    def _step(self, out: Tuple[torch.Tensor, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        loss, acc = out
        self.opt_img.zero_grad(set_to_none=True)
        self.opt_txt.zero_grad(set_to_none=True)
        with deterministic_cudnn():
            loss.backward()
        self._sum_grads()
        self.opt_img.step()
        self.opt_txt.step()
        return loss.detach(), acc

    def _sum_grads(self) -> None:
        """Each rank's gradients are its rows' part of the global loss's:
        sum them over the ranks (one flat all-reduce)."""
        if self.mesh.world == 1:
            return
        params = [p for p in self.model.parameters() if p.grad is not None]
        flat = col.all_reduce_sum(
            torch.cat([p.grad.reshape(-1) for p in params]), self.mesh)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))

    def train_epoch_arrays(self, loader) -> Tuple[float, float]:
        """One epoch over an ArrayPairLoader (synthetic-set training);
        ``epoch`` (epoch_original.py:20-62) with distill=True."""
        return _epoch_means([(*self.train_batch(images, texts),
                              self._rows(len(images)))
                             for images, texts in loader])

    def train_epoch_captions(self, loader, caption_to_embed: Callable
                             ) -> Tuple[float, float]:
        """One epoch over a caption dataset loader (expert phase);
        ``epoch`` with distill=False."""
        return _epoch_means([
            (*self.train_batch(batch[0], caption_to_embed(batch[1])),
             self._rows(len(batch[0]))) for batch in loader])

    # ---- parameter snapshots (buffer.py:67-68,94-95): registration order

    def snapshot_image_params(self) -> List[np.ndarray]:
        return [p.detach().cpu().numpy().copy()
                for p in self.model.image_encoder.parameters()]

    def snapshot_text_params(self) -> List[np.ndarray]:
        return [p.detach().cpu().numpy().copy()
                for p in getattr(self.model, self.text_tower).parameters()]


class ParallelExpertTrainer:
    """K independent bi-encoders trained in lockstep: each batch step
    trains model 0, then 1, ... on its own batch.

    Model ``j`` is a copy of ``model`` loaded with ``variables_list[j]``,
    with its own optimizers and its own generator at ``seeds[j]``, so its
    run is bit for bit that of ``BiEncoderTrainer(seed=seeds[j])`` fed the
    same batches (the parity the JAX class's vmap promises).  The JAX
    vmap takes XLA's conv for the grouped 3x3 sites; here every model's
    sites stay on the kernels.

    ``mesh``: the K models split over its ranks in contiguous blocks (as
    the JAX class shards K over ``data``); rank r trains the models of
    :attr:`mine` on their own batch streams.  Per-model reads
    (:meth:`on_owner`, the snapshots) run on the model's rank and reach
    every rank; the epoch's means are gathered.  Every rank calls each
    method in the same order.
    """

    def __init__(self, model: VLBiEncoder, variables_list: Sequence[StateDict],
                 *, lr_img: float, lr_txt: float, seeds: Sequence[int],
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 compute_dtype: str = "float32", mesh: Optional[Mesh] = None):
        self.k = len(variables_list)
        if len(seeds) != self.k:
            raise ValueError(f"{len(seeds)} seeds for {self.k} models")
        self.mesh = mesh or SINGLE
        self.owner = np.concatenate([
            np.full(len(b), r, int) for r, b in enumerate(
                np.array_split(np.arange(self.k), self.mesh.world))])
        #: the models this rank trains
        self.mine = [j for j in range(self.k)
                     if self.owner[j] == self.mesh.rank]
        self.trainers = {
            j: BiEncoderTrainer(copy.deepcopy(model), variables_list[j],
                                lr_img=lr_img, lr_txt=lr_txt,
                                momentum=momentum, weight_decay=weight_decay,
                                seed=seeds[j], compute_dtype=compute_dtype)
            for j in self.mine}

    def reset(self, variables_list: Sequence[StateDict], *,
              seeds: Sequence[int], lr_img: Optional[float] = None,
              lr_txt: Optional[float] = None) -> None:
        """Re-arm every model as a fresh trainer would start."""
        if len(variables_list) != self.k or len(seeds) != self.k:
            raise ValueError(f"reset of {self.k} models with "
                             f"{len(variables_list)} inits, {len(seeds)} "
                             f"seeds")
        for j, t in self.trainers.items():
            t.reset(variables_list[j], seed=seeds[j], lr_img=lr_img,
                    lr_txt=lr_txt)

    def train_batch(self, images, text_feats
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``images[i]`` (B, H, W, C) and ``text_feats[i]`` (B, D) for the
        i-th model of :attr:`mine` -> losses and accs on the device, one
        per model of :attr:`mine`."""
        out = [self.trainers[j].train_batch(images[i], text_feats[i])
               for i, j in enumerate(self.mine)]
        if not out:
            return torch.zeros(0), torch.zeros(0)
        return (torch.stack([loss for loss, _ in out]),
                torch.stack([acc for _, acc in out]))

    def train_epoch_captions(self, loaders, caption_to_embed: Callable
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """One epoch: ``loaders`` holds one batch stream per model (this
        rank reads those of :attr:`mine`).  -> (K,) mean losses and accs,
        read from the device at the epoch's end and gathered."""
        per = []
        for batches in zip(*[loaders[j] for j in self.mine]):
            sizes = {len(b[0]) for b in batches}
            if len(sizes) != 1:
                raise ValueError(
                    f"parallel expert loaders disagree on batch size: "
                    f"{sorted(sizes)} — all {len(batches)} streams must "
                    f"yield identically-shaped batches each step")
            loss, acc = self.train_batch([b[0] for b in batches],
                                         [caption_to_embed(b[1])
                                          for b in batches])
            per.append((loss, acc, sizes.pop()))
        means = {j: _epoch_means([(loss[i], acc[i], n)
                                  for loss, acc, n in per])
                 for i, j in enumerate(self.mine)}
        for part in col.all_gather_object(means, self.mesh):
            means.update(part)
        return (np.array([means[j][0] for j in range(self.k)]),
                np.array([means[j][1] for j in range(self.k)]))

    # ---- per-model views / snapshots ----

    def model_for(self, k: int) -> VLBiEncoder:
        """Model ``k`` (on its rank only)."""
        return self.trainers[k].model

    def on_owner(self, k: int, fn: Callable[[BiEncoderTrainer], object]):
        """``fn(trainer of model k)`` run on the model's rank, the result
        on every rank (picklable)."""
        mine = self.trainers[k] if k in self.trainers else None
        return col.broadcast_object(None if mine is None else fn(mine),
                                    self.mesh, src=int(self.owner[k]))

    def snapshot_image_params(self, k: int) -> List[np.ndarray]:
        return self.on_owner(k, BiEncoderTrainer.snapshot_image_params)

    def snapshot_text_params(self, k: int) -> List[np.ndarray]:
        return self.on_owner(k, BiEncoderTrainer.snapshot_text_params)


class TrainableTextTrainer(BiEncoderTrainer):
    """The ``--text_trainable`` expert (buffer.py:49-50): the text optimizer
    covers the BERT tower and the projection stays frozen at its init (the
    reference's optimizer groups); captions are tokenized on the host and
    padded to ``pad_to`` tokens.  float32, no in-step augment (as the JAX
    trainer).  The text snapshot is the BERT tower."""

    text_tower = "text_encoder"

    def __init__(self, model: VLBiEncoderTrainableText,
                 variables: Optional[StateDict] = None, **kw):
        model.text_projection.requires_grad_(False)
        super().__init__(model, variables, **kw)

    def train_batch(self, images, input_ids, attention_mask
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step on (B, H, W, 3) images and (B, N) token ids and
        mask; -> (loss, acc) on the device."""
        ids, mask = (torch.as_tensor(np.asarray(t), dtype=torch.long,
                                     device=self.device)
                     for t in (input_ids, attention_mask))
        images = self._augment(self._put(images))
        return self._step(self.model(images, ids, mask, train=True,
                                     generator=self.generator))

    def train_epoch_captions(self, loader, tokenize: Callable,
                             pad_to: int = 64) -> Tuple[float, float]:
        """``tokenize(captions) -> (ids, mask)``, padded or cut to
        ``pad_to`` tokens."""
        per = []
        for batch in loader:
            ids, mask = tokenize(list(batch[1]))
            n = min(ids.shape[1], pad_to)
            out = np.zeros((2, len(ids), pad_to), np.int64)
            out[0, :, :n], out[1, :, :n] = ids[:, :n], mask[:, :n]
            per.append((*self.train_batch(batch[0], out[0], out[1]),
                        len(batch[0])))
        return _epoch_means(per)
