"""Bi-trajectory distillation entry point (reference ``distill.py``).

Counterpart of ``multimodal_dataset_distillation_tpu/cli/distill.py``.
Runs on ``cfg.device``, the card unless the configuration says otherwise
(``device`` is a ``Config`` field, not a flag); with no card there it
raises.  Flow (distill_original.py:89-496):

1. data, and the test and train caption caches through the port's BERT
   (:mod:`..data.textcache`; computed if missing);
2. the synthetic init: random real pairs (or noise, --pix_init/--txt_init);
3. expert buffers: discovered, shuffled and cycled with a device cache and
   prefetch (:class:`~..engine.distill.ExpertCycler`); a dummy trajectory
   from a fresh init when none exist (distill.py:262-274);
4. the outer loop, ``Iteration + 1`` steps: every ``eval_it`` iterations
   an eval block (``num_eval`` fresh students trained on the synthetic set
   and scored on the test split, --std mean/std, the artifacts of
   :mod:`..utils.visualize`), then one outer step; the NaN bailout
   (distill.py:599) one step late, as the host reads a step's metrics
   after the next step is queued; a checkpoint every ``ckpt_it``
   iterations, and --resume_from.

Data parallel across ranks (:mod:`..parallel.mesh`), one process per
card under torchrun (``torchrun --nproc_per_node=N -m ...cli.distill``):
the inner minibatch pads to a multiple of the world and each rank embeds
its slots; ``--shard_syn`` (on by default, as in the JAX package) splits
the synthetic set over the ranks.  Every rank prints the JAX CLI's mesh
line; the initial synthetic set is checked to be the same on every rank;
the expert cycler walks the same segments on every rank (the same seed);
logs, images, ``distilled_*.npz`` and checkpoints are written by rank 0;
the NaN bail-out is agreed over the ranks.  The eval students split over
the ranks when ``--parallel_eval`` and ``num_eval`` divides the world, else
rank 0 evaluates alone.  At start-up, before any data is read
(:func:`check_supported`, :func:`~..parallel.mesh.get_mesh`): a
``--mesh_shape`` that does not multiply to the world raises
``ValueError``, as does a student the JAX distill CLI cannot run either
(:func:`~..engine.distill.check_distillable`); one process that sees
several cards, or ranks that share a card without ``gloo``, raise
``RuntimeError``.  ``--transfer`` gives the eval students the transfer
head and leaves the distill students plain, as there.  ``--zca`` fits ZCA
whitening on the host (at most 2048 train images), whitens the real-init
pixels and adds the de-whitened artifacts; ``--stem_s2d`` (or
``MDD_STEM_S2D``) runs the NF stems of the distill and the eval students
in space-to-depth form, as the JAX package's global gate does.

Usage::

  python -m multimodal_dataset_distillation_tpu_torch.cli.distill \\
      --dataset=flickr --image_encoder=nfnet --text_encoder=bert \\
      --num_queries=100 --syn_steps=8 --mini_batch_size=100 \\
      --buffer_path=./buffers --pallas_gconv True
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, parse_config
from ..data import get_dataset
from ..data.textcache import (
    load_or_process_file,
    make_text_encoder,
    textprocess,
)
from ..engine.buffer_io import discover_buffers, save_expert
from ..engine.checkpoint import (
    load_distill_checkpoint,
    save_distill_checkpoint,
)
from ..engine.distill import (
    Distiller,
    ExpertCycler,
    check_distillable,
    dummy_trajectory,
    get_images_texts,
    noise_images,
    noise_texts,
)
from ..engine.eval import evaluate_synset, evaluate_synset_parallel
from ..models.clip_model import VLBiEncoder, build_bi_encoder, init_bi_encoder
from ..models.zoo import load_timm_image_tower, load_timm_state_dict
from ..ops.zca import ZCAWhitening
from ..parallel import collectives as col
from ..parallel.mesh import (
    Mesh,
    check_mesh_shape,
    data_axis_size,
    get_mesh,
    pad_to_multiple,
)
from ..utils.logging import Profiler, RunLogger, SilentLogger, get_time
from ..utils.visualize import save_visualizations
from .buffer import make_caption_lookup


def make_eval_initializer(cfg: Config
                          ) -> Callable[[VLBiEncoder, int],
                                        Dict[str, torch.Tensor]]:
    """Eval students start like the reference's ``CLIPModel_full(args)``
    eval nets (networks.py:666 via epoch_original.py:164): from a local
    timm checkpoint of the image tower when ``image_pretrained`` is set and
    one exists, from the seeded init otherwise.  -> ``init(eval_model,
    seed) -> state dict`` (the model's own weights are overwritten)."""
    sd = None
    if cfg.image_pretrained:
        sd, path = load_timm_state_dict(cfg.image_encoder)
        if sd is not None:
            print(f"Eval students use pretrained image tower: {path}")

    def init(eval_model: VLBiEncoder, seed: int) -> Dict[str, torch.Tensor]:
        init_bi_encoder(eval_model, seed)
        if sd is not None:
            load_timm_image_tower(eval_model.image_encoder, sd)
        return {k: v.clone() for k, v in eval_model.state_dict().items()}

    return init


def check_supported(cfg: Config, ignore: Sequence[str] = ()) -> None:
    """Start-up checks, before any data is read: ``RuntimeError`` when the
    device asked for is a card and none is there, ``ValueError`` for a
    ``--mesh_shape`` that does not fit the world (torchrun's
    ``WORLD_SIZE``).  ``ignore``: flags the calling entry point never
    reads (as its JAX counterpart does not), skipped."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {cfg.device!r} asked for and no CUDA card is "
            f"visible; run with a card, or cfg.replace(device='cpu')")
    if "--mesh_shape" not in ignore:
        check_mesh_shape(cfg.mesh_shape, cfg.mesh_axes)


def start_mesh(cfg: Config) -> Tuple[Config, Mesh]:
    """Join the ranks (:func:`~..parallel.mesh.get_mesh`); -> (the config
    on this rank's device, the mesh)."""
    mesh = get_mesh(cfg.mesh_shape, cfg.mesh_axes, device=cfg.device)
    if mesh.world > 1:
        print(f"[rank {mesh.rank}] {mesh.world} ranks on {mesh.nodes} "
              f"node(s), backend {mesh.backend}, device {mesh.device}",
              flush=True)
    return cfg.replace(device=str(mesh.device)), mesh


def run_logger(cfg: Config, mesh: Mesh):
    """Rank 0's :class:`RunLogger`; the other ranks log nothing, under
    rank 0's run name."""
    logger = (RunLogger(name=cfg.name, disable_wandb=cfg.disable_wandb,
                        log_dir=cfg.save_dir) if mesh.is_main else None)
    name = col.broadcast_object(logger.name if logger else None, mesh)
    return logger or SilentLogger(name)


def _bootstrap_dummy_buffers(expert_dir: str, model: VLBiEncoder,
                             expert_epochs: int) -> None:
    """A 1-expert trajectory from the student's fresh init (distill.py:
    262-274), so distillation runs end to end without the expert phase."""
    print(f"No buffers at {expert_dir}; fabricating dummy buffers")
    towers = (model.image_encoder, model.text_projection)
    copies = max(expert_epochs + 1, 2)
    trajs = [dummy_trajectory([p.detach().cpu().numpy() for p in
                               t.parameters()], copies) for t in towers]
    save_expert(expert_dir, *trajs, *towers, write_pt=False)


def _student_cfg(cfg: Config) -> Config:
    """The distill students: distill-mode towers, never the transfer head
    (distill.py:440 builds plain ``CLIPModel_full(args)``)."""
    return cfg.replace(distill=True, transfer=False)


def _memory_probe(tag: str, device: torch.device) -> None:
    """``MDD_DEBUG_HBM=1``: the card's allocator statistics, for long-run
    out-of-memory triage."""
    if os.environ.get("MDD_DEBUG_HBM") != "1" or device.type != "cuda":
        return
    st = torch.cuda.memory_stats(device)
    print(f"[hbm {tag}] in_use="
          f"{st.get('allocated_bytes.all.current', 0) / 2**20:.0f} MiB "
          f"peak={st.get('allocated_bytes.all.peak', 0) / 2**20:.0f} MiB "
          f"reserved={st.get('reserved_bytes.all.current', 0) / 2**20:.0f} "
          f"MiB", flush=True)


def main(cfg: Config):
    """-> (distiller, history: [(it, [metrics per eval student])]).  A
    student the JAX distill CLI cannot run either (a BatchNorm tower,
    --only_has_image_projection) raises ``ValueError`` before any data is
    read."""
    check_supported(cfg)
    with torch.device("meta"):   # shapes only: no weights are made
        check_distillable(build_bi_encoder(_student_cfg(cfg), device="meta"))
    cfg, mesh = start_mesh(cfg)
    device = torch.device(cfg.device)
    if cfg.texture and cfg.pix_init == "real":
        print("WARNING: Using texture with real initialization will take a "
              "very long time to smooth out the boundaries between images.")

    logger = run_logger(cfg, mesh)
    if mesh.is_main:
        print("Hyper-parameters: \n", cfg)

    trainloader, testloader, train_dataset, test_dataset = get_dataset(cfg)
    train_sentences = train_dataset.get_all_captions()
    text_encoder = make_text_encoder(cfg)
    with col.main_first(mesh):   # rank 0 writes the caption caches
        data = load_or_process_file(
            "text", functools.partial(textprocess, encoder=text_encoder),
            cfg, testloader)
        _, train_caption_embed, _ = make_caption_lookup(
            train_dataset, cfg, encoder=text_encoder)
    bert_test_embed = data["bert_test_embed"].astype(np.float32)

    rng = np.random.RandomState(cfg.seed)

    # ---- ZCA whitening (the CIFAR path, utils.py:50-105), on the host ----
    zca = None
    if cfg.zca:
        sample_n = min(len(train_dataset), 2048)
        zca = ZCAWhitening().fit(np.stack([train_dataset[i][0]
                                           for i in range(sample_n)]))
        print(f"Fitted ZCA whitening on {sample_n} train images")

    # ---- synthetic data init (distill_original.py:137-148) ----
    image_syn, text_syn = get_images_texts(cfg.num_queries, train_dataset,
                                           text_encoder, rng)
    if cfg.pix_init == "noise":
        image_syn = noise_images(cfg.num_queries, cfg.image_size, rng)
        print("Initialized synthetic image from random noise")
    if cfg.txt_init == "noise":
        text_syn = noise_texts(cfg.num_queries, text_encoder.hidden_size, rng)
        print("Initialized synthetic text from random noise")
    if zca is not None and cfg.pix_init == "real":
        # the reference's --zca path serves whitened images from
        # get_dataset (utils.py:50-105): whiten the real-init pixels here
        image_syn = zca.transform(image_syn)
    del text_encoder  # the caches hold all the run needs of the tower
    col.check_replicated(torch.from_numpy(image_syn), mesh,
                         "the initial synthetic images")
    col.check_replicated(torch.from_numpy(text_syn), mesh,
                         "the initial synthetic texts")

    # ---- student template + distiller ----
    student_cfg = _student_cfg(cfg)
    model = init_bi_encoder(build_bi_encoder(student_cfg), cfg.seed)
    if mesh.world > 1:
        mb = min(cfg.mini_batch_size, cfg.num_queries)
        padded = pad_to_multiple(mb, data_axis_size(mesh))
        print(f"Device mesh: {mesh.shape}" + (
            f" (mini_batch {mb} -> {padded} pad-and-mask)"
            if padded != mb else ""), flush=True)
    distiller = Distiller(student_cfg, model, image_syn, text_syn,
                          device=device, mesh=mesh)

    # ---- expert buffers (distill_original.py:170-196) ----
    expert_dir = cfg.buffer_path
    nested = os.path.join(cfg.buffer_path, cfg.dataset, cfg.image_encoder,
                          cfg.text_encoder)
    if not discover_buffers(expert_dir)[0] and discover_buffers(nested)[0]:
        expert_dir = nested
    print(f"Expert Dir: {expert_dir}")
    with col.main_first(mesh):
        if not discover_buffers(expert_dir)[0]:
            _bootstrap_dummy_buffers(expert_dir, model, cfg.expert_epochs)
    img_files, txt_files = discover_buffers(expert_dir)
    # an .npz of another width raises the flat-size ValueError here
    cycler = ExpertCycler(img_files, txt_files, cfg.max_start_epoch,
                          cfg.expert_epochs, model.image_encoder,
                          model.text_projection, max_files=cfg.max_files,
                          seed=cfg.seed, max_experts=cfg.max_experts,
                          load_all=cfg.load_all,
                          device_cache_cap=cfg.traj_cache_cap,
                          prefetch=cfg.traj_prefetch, device=device)

    eval_it_pool = set(np.arange(0, cfg.Iteration + 1, cfg.eval_it).tolist())
    history = []
    eval_init = make_eval_initializer(cfg)

    start_it = 0
    if cfg.resume_from:
        start_it = load_distill_checkpoint(cfg.resume_from, distiller,
                                           cycler=cycler, host_rng=rng) + 1
        print(f"Resumed from {cfg.resume_from} at iteration {start_it}")
    run_dir = os.path.join(cfg.save_dir, cfg.dataset, logger.name)

    # The host reads step N's metrics (loss print, NaN check, logging:
    # each waits for the card) after step N+1 is queued, so the card does
    # not idle on the host.  The NaN bailout is one step late: the step
    # after the NaN one has run when it is seen, so ``distiller.state`` is
    # invalid whenever ``distiller.nan_bailout_it`` is set.
    pending = None  # (it, metrics) of the last queued step

    def drain(pending) -> bool:
        """Read and log the queued step's metrics; False on a NaN."""
        if pending is None:
            return True
        pit, metrics = pending
        grand = float(metrics["grand_loss"])
        if col.agree(math.isnan(float(metrics["img_param_loss"])), mesh):
            print("NaN param loss — stopping (distill.py:599)")
            distiller.nan_bailout_it = pit
            return False
        # the logged LRs are the values before the step, as the
        # reference logs syn_lr before optimizer.step
        logger.log({"Synthetic_LR_Image": metrics["syn_lr_img_pre"],
                    "Synthetic_LR_Text": metrics["syn_lr_txt_pre"]},
                   step=pit)
        logger.log({"Grand_Loss": grand,
                    "Start_Epoch": metrics["_start_epoch"],
                    "img_param_loss": metrics["img_param_loss"],
                    "txt_param_loss": metrics["txt_param_loss"]}, step=pit)
        if pit % 10 == 0 and mesh.is_main:
            print(f"{get_time()} iter = {pit:04d}, loss = {grand:.4f}")
        return True

    # one eval model and one trainer cache for the whole run: trainers are
    # re-armed per block, not rebuilt
    eval_model = None
    eval_reuse: dict = {}

    for it in range(start_it, cfg.Iteration + 1):
        # ---- evaluation block (distill_original.py:201-283) ----
        if it in eval_it_pool and cfg.num_eval > 0:
            if not drain(pending):
                pending = None
                break
            pending = None
            _memory_probe(f"pre-eval it={it}", device)
            results = []
            st = distiller.state
            eval_cfg = cfg.replace(distill=True, lr_net=float(st.syn_lr_img))
            if eval_model is None:
                eval_model = build_bi_encoder(eval_cfg)
            img_eval, txt_eval = distiller.syn_arrays()
            parallel = cfg.parallel_eval and cfg.num_eval > 1
            # the students split over the ranks when they divide evenly;
            # else rank 0 evaluates alone (the JAX CLI's eval_mesh=None)
            eval_mesh = mesh if cfg.num_eval % mesh.data == 0 else None
            if parallel and (eval_mesh or mesh.is_main):
                var_list = [eval_init(eval_model, cfg.seed + 1000 + j)
                            for j in range(cfg.num_eval)]
                _, results = evaluate_synset_parallel(
                    cfg.num_eval, eval_model, var_list, img_eval, txt_eval,
                    testloader, eval_cfg, bert_test_embed, reuse=eval_reuse,
                    mesh=eval_mesh)
            elif mesh.is_main:
                for j in range(cfg.num_eval):
                    variables = eval_init(eval_model, cfg.seed + 1000 + j)
                    results.append(evaluate_synset(
                        j, eval_model, variables, img_eval, txt_eval,
                        testloader, eval_cfg, bert_test_embed,
                        reuse=eval_reuse)[2])
            if not mesh.is_main:
                results = []
            for j, val in enumerate(results):
                print(f"Evaluate_{j:02d}: "
                      + " ".join(f"{k}={v:.4f}" for k, v in val.items()))
                if not cfg.std:
                    logger.log(val, step=it)
            if cfg.std and results:
                agg = {}
                for k in results[0]:
                    vals = [r[k] for r in results]
                    agg[f"Mean/{k}"] = float(np.mean(vals))
                    agg[f"Std/{k}"] = float(np.std(vals))
                logger.log(agg, step=it)
            history.append((it, results))
            _memory_probe(f"post-eval it={it}", device)

            if cfg.draw and mesh.is_main:
                # grids and sentences gated as the reference (distill.py:
                # 368: ipc < 50 or --force_save); the npz always saves
                arts = save_visualizations(
                    run_dir, it, img_eval, txt_eval, train_sentences,
                    train_caption_embed,
                    save_grids=cfg.ipc < 50 or cfg.force_save,
                    syn_lrs=(st.syn_lr_img, st.syn_lr_txt),
                    save_pt=cfg.save_pt, zca=zca)
                for k in ("grid", "clipped_2.5"):
                    if k in arts:
                        logger.log_image(f"Synthetic_Images/{k}", arts[k],
                                         step=it)
                logger.log_histogram("Synthetic_Pixels", img_eval, step=it)
                logger.log_histogram("Synthetic_Texts", txt_eval, step=it)
                if "sentences" in arts:
                    with open(arts["sentences"]) as f:
                        html = "<br>".join(line.strip() for line in f)
                    logger.log_html("Synthetic_Sentences", html, step=it,
                                    path=arts["sentences"])

        # ---- one outer step ----
        with Profiler(cfg.profile_dir if it == 2 and mesh.is_main
                      else None):
            traj_img, traj_txt, start_epoch = cycler.next_segment_device()
            metrics = distiller.step_traj(traj_img, traj_txt, start_epoch,
                                          distiller.sample_indices(rng))
            if cfg.profile_dir and it == 2 and device.type == "cuda":
                torch.cuda.synchronize(device)
        metrics["_start_epoch"] = start_epoch

        # read and log the previous step while this one runs on the card
        if not drain(pending):
            pending = None
            break
        pending = (it, metrics)

        if cfg.ckpt_it and it % cfg.ckpt_it == 0 and it > start_it:
            if not drain(pending):
                pending = None
                break
            pending = None
            p = save_distill_checkpoint(
                os.path.join(run_dir, f"distill_ckpt_{it}.pt"), distiller,
                it, cycler=cycler, host_rng=rng)
            print(f"Checkpointed outer loop -> {p}")

    drain(pending)
    cycler.close()
    logger.finish()
    return distiller, history


if __name__ == "__main__":
    main(parse_config(defaults=Config(image_encoder="nfnet", Iteration=5000)))
