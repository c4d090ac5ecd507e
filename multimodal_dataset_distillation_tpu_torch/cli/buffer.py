"""Expert-trajectory entry point (reference ``buffer.py``): the paper's
phase 1.

Counterpart of ``multimodal_dataset_distillation_tpu/cli/buffer.py``.
Trains ``num_experts`` CLIP-style bi-encoders on the dataset, snapshots
the image tower and the text projection after every epoch, and saves each
expert's pair of trajectories as ``{img,txt}_replay_buffer_{n}.{pt,npz}``
under ``{buffer_path}/{dataset}[_NO_ZCA]/{image_encoder}/{text_encoder}``
(buffer.py:27-31, 104-112), where the distill CLI finds them.  Runs on
``cfg.device``, the card unless the configuration says otherwise; with no
card there it raises.  Three modes:

* sequential (the default): one expert after another, expert ``it`` from
  the seed ``cfg.seed + it``; ``--decay`` cuts both learning rates 10x
  after epoch ``train_epochs // 2 + 1``; ``--device_augment`` runs
  RandAugment and the normalisation in the step, on raw crops;
* ``--parallel_experts=K``: K experts in lockstep, each on its own batch
  stream (float32, as the JAX package);
* ``--text_trainable``: BERT in the step; its trajectory is the text
  buffer.

The last two have no in-step augment: ``--device_augment`` with either is
refused before any data is read (the JAX CLI trains them on raw crops).

The frozen text tower (BERT, or CLIP under ``--text_encoder=clip``) runs
once up front into the caption caches in the current directory;
``--stem_s2d`` (or ``MDD_STEM_S2D``) runs the NF stems in space-to-depth
form.

Across ranks (torchrun, one process per card; :mod:`..parallel.mesh`), the
JAX CLI's three modes:

* one node: each expert data-parallel over the ranks, every rank on its
  rows of the one-rank run's batches (``Loader(rows=...)``);
* several nodes with ``--distributed``: data-parallel over every rank,
  each reading its shard of the epoch (``Loader(shard=(rank, world))``)
  at ``batch_size_train // world``;
* several nodes without it: the experts fan out over the nodes
  (:func:`~..parallel.mesh.expert_assignment`), each node data-parallel
  over its ranks and writing its experts under their global indices.

Rank 0 (of the node, in the fan-out) writes the buffers and the log.
``--parallel_experts=K`` splits its K models over every rank of the world
(each model on one rank, on the one-rank run's batches).
``--text_trainable`` builds no mesh in the JAX CLI: here rank 0 trains
alone and the other ranks only wait.  A ``--mesh_shape`` that does not
fit the world raises before any data is read
(:func:`~.distill.check_supported`).

Usage::

  python -m multimodal_dataset_distillation_tpu_torch.cli.buffer \\
      --dataset=flickr --image_encoder=nfnet --text_encoder=bert \\
      --num_experts=100 --train_epochs=50 --buffer_path=./buffers \\
      --pallas_gconv True
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, parse_config
from ..data import get_dataset
from ..data.pipeline import Loader
from ..data.textcache import (
    load_or_process_file,
    make_text_encoder,
    textprocess,
    textprocess_train,
)
from ..engine.buffer_io import save_expert
from ..engine.eval import epoch_test, itm_eval
from ..engine.expert import (
    BiEncoderTrainer,
    ParallelExpertTrainer,
    TrainableTextTrainer,
)
from ..parallel import collectives as col
from ..parallel.mesh import SINGLE, Mesh, expert_assignment, node_mesh
from ..models.bert import TextEncoder, init_bert
from ..models.clip_model import (
    VLBiEncoderTrainableText,
    build_bi_encoder,
    build_trainable_text,
    init_bi_encoder,
)
from ..models.zoo import load_timm_image_tower, load_timm_state_dict

#: tokens per caption in the --text_trainable step (the JAX package's)
TEXT_PAD = 64


def make_caption_lookup(train_dataset, cfg: Config, cache_dir: str = ".",
                        encoder: Optional[TextEncoder] = None):
    """-> (lookup: captions -> cached CLS embeddings, the train embedding
    cache, the train captions).  The tower is frozen, so the cache is
    exact.  ``encoder`` computes a missing cache (a fresh tower when
    None)."""
    sentences = train_dataset.get_all_captions()
    cache = load_or_process_file(
        "train_text", functools.partial(textprocess_train, encoder=encoder),
        cfg, sentences, cache_dir=cache_dir)
    embed = cache["bert_test_embed"].astype(np.float32)
    index: Dict[str, int] = {}
    for i, s in enumerate(sentences):
        index.setdefault(s, i)

    def lookup(captions: Sequence[str]) -> np.ndarray:
        return embed[[index[c] for c in captions]]

    return lookup, embed, sentences


def expert_dir(cfg: Config) -> str:
    """``{buffer_path}/{dataset}[_NO_ZCA]/{image_encoder}/{text_encoder}``."""
    d = os.path.join(cfg.buffer_path, cfg.dataset)
    if cfg.dataset in ("CIFAR10", "CIFAR100") and not cfg.zca:
        d += "_NO_ZCA"
    return os.path.join(d, cfg.image_encoder, cfg.text_encoder)


def init_expert(model: torch.nn.Module, cfg: Config,
                seed: int) -> Dict[str, torch.Tensor]:
    """A fresh expert's weights, as a state dict: the seeded init (BERT's by
    its own rule under ``--text_trainable``), the image tower from a local
    timm checkpoint when ``image_pretrained`` is set and one exists (the
    reference's ``pretrained=True``, networks.py:666).  The model's own
    weights are overwritten."""
    init_bi_encoder(model, seed)
    if isinstance(model, VLBiEncoderTrainableText):
        init_bert(model.text_encoder, seed)
    if cfg.image_pretrained:
        sd, path = load_timm_state_dict(cfg.image_encoder)
        if sd is not None:
            load_timm_image_tower(model.image_encoder, sd)
            print(f"Loaded pretrained image tower from {path}")
    return {k: v.clone() for k, v in model.state_dict().items()}


def _test(cfg: Config, testloader, model, bert_test_embed) -> Dict[str, float]:
    i2t, t2i = epoch_test(testloader, model, bert_test_embed, cfg.k_test)
    return itm_eval(i2t, t2i, testloader.dataset.txt2img,
                    testloader.dataset.img2txt)


def _recall_line(val: Dict[str, float], every_k: bool = True) -> str:
    if not every_k:
        return f"Img R@1: {val['img_r1']:.2f}\tTxt R@1: {val['txt_r1']:.2f}"
    return (f"Img R@1: {val['img_r1']:.2f} R@5: {val['img_r5']:.2f} "
            f"R@10: {val['img_r10']:.2f}\tTxt R@1: {val['txt_r1']:.2f} "
            f"R@5: {val['txt_r5']:.2f} R@10: {val['txt_r10']:.2f}")


def main(cfg: Config) -> List[int]:
    """-> the buffer index of each expert saved (by this rank: rank 0,
    or each node's rank 0 in the fan-out)."""
    from .distill import check_supported, run_logger, start_mesh

    # the reference buffer.py has no --transfer flag (buffer.py:118-161):
    # teachers are plain CLIPModel_full(args), whatever the union config
    # says, so that their trajectories fit the distill students
    cfg = cfg.replace(transfer=False)
    check_supported(cfg)
    if cfg.device_augment and (cfg.parallel_experts > 1 or cfg.text_trainable):
        raise ValueError(
            "--device_augment runs in the sequential trainer's step only: "
            "the --parallel_experts and --text_trainable trainers neither "
            "augment nor normalise, so they would train on raw [0, 255] "
            "crops (as the JAX package's do); unset one of the flags")
    cfg, mesh = start_mesh(cfg)
    logger = run_logger(cfg, mesh)
    if mesh.is_main:
        print("Hyper-parameters: \n", cfg)
    save_dir = expert_dir(cfg)
    os.makedirs(save_dir, exist_ok=True)

    trainloader, testloader, train_dataset, _ = get_dataset(cfg)
    text_encoder = make_text_encoder(cfg)
    with col.main_first(mesh):   # rank 0 writes the caption caches
        data = load_or_process_file(
            "text", functools.partial(textprocess, encoder=text_encoder),
            cfg, testloader)
        caption_lookup, _, _ = make_caption_lookup(train_dataset, cfg,
                                                   encoder=text_encoder)
    bert_test_embed = data["bert_test_embed"].astype(np.float32)
    print(f"The shape of bert_test_embed: {bert_test_embed.shape}")

    if cfg.text_trainable:
        saved = []
        if mesh.world > 1:
            print(f"[rank {mesh.rank}] --text_trainable builds no mesh (as "
                  f"in the JAX CLI): rank 0 trains alone")
        if mesh.is_main:   # the other ranks have nothing to wait for
            saved = _run_text_trainable(cfg, save_dir, trainloader,
                                        testloader, bert_test_embed, logger,
                                        text_encoder)
    elif cfg.parallel_experts > 1:
        saved = _run_parallel(cfg, save_dir, trainloader, testloader,
                              caption_lookup, bert_test_embed, logger, mesh)
    else:
        saved = _run_sequential(cfg, save_dir, trainloader, testloader,
                                caption_lookup, bert_test_embed, logger, mesh)
    logger.finish()
    return saved


def data_parallel_plan(cfg: Config, mesh: Mesh, trainloader):
    """The JAX CLI's modes (cli/buffer.py:103-148 there) -> (the experts
    this rank trains, the mesh of their data parallelism, this rank's
    train loader, whether buffers take the experts' global indices)."""
    experts = list(range(cfg.num_experts))
    if mesh.world == 1:
        return experts, mesh, trainloader, False
    ds, batch = trainloader.dataset, trainloader.batch_size
    if mesh.nodes > 1 and cfg.distributed:
        per = max(1, batch // mesh.world)
        print(f"[multi-node] DP: {mesh.world} ranks on {mesh.nodes} nodes, "
              f"per-rank batch {per}")
        return experts, mesh, Loader(
            ds, per, shuffle=True, drop_last=True,
            num_workers=cfg.num_workers, seed=cfg.seed,
            shard=(mesh.rank, mesh.world)), False
    dp, indexed = mesh, False
    if mesh.nodes > 1:
        experts = expert_assignment(cfg.num_experts, mesh)
        dp, indexed = node_mesh(mesh), True
        print(f"[multi-node] expert fan-out: node {mesh.node} trains "
              f"experts {experts} on {dp.world} rank(s)")
    if dp.world == 1:
        return experts, dp, trainloader, indexed
    if batch % dp.world:
        raise ValueError(f"--batch_size_train={batch} does not split over "
                         f"{dp.world} ranks")
    tl = trainloader
    return experts, dp, Loader(
        ds, batch, shuffle=tl.shuffle, drop_last=tl.drop_last,
        num_workers=tl.num_workers, seed=tl.seed, prefetch=tl.prefetch,
        rows=(dp.rank, dp.world)), indexed


def _run_sequential(cfg: Config, save_dir, trainloader, testloader,
                    caption_lookup, bert_test_embed, logger,
                    mesh: Mesh = SINGLE) -> List[int]:
    experts, dp, trainloader, indexed = data_parallel_plan(cfg, mesh,
                                                           trainloader)
    model = build_bi_encoder(cfg)
    saved: List[int] = []
    for it in experts:
        # expert it reads the epochs the sequential run gives it
        trainloader.set_epoch(it * cfg.train_epochs)
        trainer = BiEncoderTrainer(
            model, init_expert(model, cfg, cfg.seed + it),
            lr_img=cfg.lr_teacher_img, lr_txt=cfg.lr_teacher_txt,
            momentum=cfg.mom, weight_decay=cfg.l2, seed=cfg.seed + it,
            compute_dtype=cfg.train_dtype,
            device_augment=cfg.device_augment, mesh=dp)
        img_traj = [trainer.snapshot_image_params()]
        txt_traj = [trainer.snapshot_text_params()]
        lr_img, lr_txt = cfg.lr_teacher_img, cfg.lr_teacher_txt
        for e in range(cfg.train_epochs):
            train_loss, train_acc = trainer.train_epoch_captions(
                trainloader, caption_lookup)
            if dp.is_main:   # the model is the same on every rank
                val = _test(cfg, testloader, model, bert_test_embed)
                logger.log({"train_loss": train_loss,
                            "train_acc": train_acc, **val})
                print(f"Itr: {it}\tEpoch: {e}\tTrain Acc: "
                      f"{train_acc:.4f}\t" + _recall_line(val))
                img_traj.append(trainer.snapshot_image_params())
                txt_traj.append(trainer.snapshot_text_params())
            # the reference's step decay (buffer.py:97-102)
            if cfg.decay and e == cfg.train_epochs // 2 + 1:
                lr_img, lr_txt = lr_img * 0.1, lr_txt * 0.1
                trainer.reset_optimizers(lr_img, lr_txt, cfg.mom, cfg.l2)
        if dp.is_main:
            n = save_expert(save_dir, img_traj, txt_traj, model.image_encoder,
                            model.text_projection,
                            index=it if indexed else None)
            print(f"Saved expert {it} -> buffer index {n} in {save_dir}")
            saved.append(n)
    col.barrier(mesh)
    return saved


def _run_parallel(cfg: Config, save_dir, trainloader, testloader,
                  caption_lookup, bert_test_embed, logger,
                  mesh: Mesh = SINGLE) -> List[int]:
    """``parallel_experts`` experts at a time in lockstep, each with its own
    shuffle of the train split (seed ``cfg.seed + 7919 * it``), split over
    the ranks of ``mesh``; rank 0 writes the buffers."""
    if cfg.decay:
        print("Warning: --decay LR schedule not applied in expert-parallel "
              "mode; run with --parallel_experts=1 for decayed experts")
    model = build_bi_encoder(cfg)
    saved: List[int] = []
    for it0 in range(0, cfg.num_experts, cfg.parallel_experts):
        its = list(range(it0, min(it0 + cfg.parallel_experts,
                                  cfg.num_experts)))
        seeds = [cfg.seed + it for it in its]
        trainer = ParallelExpertTrainer(
            model, [init_expert(model, cfg, s) for s in seeds],
            lr_img=cfg.lr_teacher_img, lr_txt=cfg.lr_teacher_txt,
            seeds=seeds, momentum=cfg.mom, weight_decay=cfg.l2, mesh=mesh)
        loaders = [Loader(trainloader.dataset, trainloader.batch_size,
                          shuffle=True, drop_last=True,
                          num_workers=cfg.num_workers, seed=cfg.seed + 7919 * it)
                   for it in its]
        img_trajs = [[trainer.snapshot_image_params(j)]
                     for j in range(len(its))]
        txt_trajs = [[trainer.snapshot_text_params(j)]
                     for j in range(len(its))]
        for e in range(cfg.train_epochs):
            losses, accs = trainer.train_epoch_captions(loaders,
                                                        caption_lookup)
            for j, it in enumerate(its):
                val = trainer.on_owner(j, lambda t: _test(
                    cfg, testloader, t.model, bert_test_embed))
                logger.log({"train_loss": float(losses[j]),
                            "train_acc": float(accs[j]), **val})
                if mesh.is_main:
                    print(f"Itr: {it}\tEpoch: {e}\tTrain Acc: "
                          f"{float(accs[j]):.4f}\t" + _recall_line(val, False))
                snaps = (trainer.snapshot_image_params(j),
                         trainer.snapshot_text_params(j))
                if mesh.is_main:   # rank 0 alone keeps the trajectories
                    img_trajs[j].append(snaps[0])
                    txt_trajs[j].append(snaps[1])
        for j, it in enumerate(its):
            if not mesh.is_main:
                continue
            n = save_expert(save_dir, img_trajs[j], txt_trajs[j],
                            model.image_encoder, model.text_projection)
            print(f"Saved expert {it} -> buffer index {n} in {save_dir}")
            saved.append(n)
    col.barrier(mesh)
    return saved


def _run_text_trainable(cfg: Config, save_dir, trainloader, testloader,
                        bert_test_embed, logger,
                        text_encoder: TextEncoder) -> List[int]:
    """``--text_trainable`` experts (buffer.py:49-50): the text optimizer
    and the text snapshots cover the BERT tower, the projection stays at
    its init; retrieval still scores the cached CLS embeddings, as the
    reference does.  With ``text_pretrained`` the tower starts from the
    frozen encoder's weights (HF's when a local cache has them)."""
    model = build_trainable_text(cfg)
    saved: List[int] = []
    for it in range(cfg.num_experts):
        variables = init_expert(model, cfg, cfg.seed + it)
        if cfg.text_pretrained:
            variables.update({f"text_encoder.{k}": v for k, v in
                              text_encoder.module.state_dict().items()})
        trainer = TrainableTextTrainer(
            model, variables, lr_img=cfg.lr_teacher_img,
            lr_txt=cfg.lr_teacher_txt, momentum=cfg.mom, weight_decay=cfg.l2,
            seed=cfg.seed + it)
        img_traj = [trainer.snapshot_image_params()]
        txt_traj = [trainer.snapshot_text_params()]
        for e in range(cfg.train_epochs):
            train_loss, train_acc = trainer.train_epoch_captions(
                trainloader, text_encoder.tokenize, pad_to=TEXT_PAD)
            val = _test(cfg, testloader, model, bert_test_embed)
            logger.log({"train_loss": train_loss, "train_acc": train_acc,
                        **val})
            print(f"Itr: {it}\tEpoch: {e}\tTrain Acc: {train_acc:.4f}\t"
                  + _recall_line(val, False) + "\t(text_trainable)")
            img_traj.append(trainer.snapshot_image_params())
            txt_traj.append(trainer.snapshot_text_params())
        n = save_expert(save_dir, img_traj, txt_traj, model.image_encoder,
                        model.text_encoder)
        print(f"Saved expert {it} -> buffer index {n} in {save_dir}")
        saved.append(n)
    return saved


if __name__ == "__main__":
    main(parse_config(defaults=Config(image_encoder="nfnet")))
