"""Evaluate a saved distilled dataset (``distilled_{it}.npz`` or a
``--save_pt`` ``images_{it}.pt``/``labels_{it}.pt`` pair).

Counterpart of ``multimodal_dataset_distillation_tpu/cli/eval_distilled.py``:
trains ``--num_eval`` fresh NFNet + ProjectionHead students on the
distilled set by the standard synset-evaluation protocol
(epoch_original.py:164-195), sequentially or through the parallel
trainer, scores each on the test split and prints its metrics.  The test
captions' text embeddings are read from the cache in the current
directory (:mod:`..data.textcache`).  Runs on ``cfg.device``, the card
unless the configuration says otherwise.

Usage::

  python -m multimodal_dataset_distillation_tpu_torch.cli.eval_distilled \\
      --distilled_npz=logged_files/flickr/<run>/distilled_1000.npz \\
      --dataset=flickr --image_encoder=nfnet --text_encoder=bert \\
      --num_eval=5 --epoch_eval_train=4 --std True
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config, explicit_flags, parse_config
from ..data import get_dataset
from ..data.textcache import load_or_process_file, textprocess
from ..engine.eval import evaluate_synset, evaluate_synset_parallel
from ..models.clip_model import build_bi_encoder
from .distill import check_supported, make_eval_initializer

#: flags that the JAX eval_distilled never reads (the ZCA, the mesh and the
#: space-to-depth stem are the distill and buffer CLIs' only), so this entry
#: point ignores them too: ``check_supported`` skips the mesh (one card,
#: as the JAX CLI builds no mesh: more than one rank raises), ``main``
#: never reads ``zca`` and builds its students with ``stem_s2d`` off
#: (``MDD_STEM_S2D`` still applies, as it does to the JAX package's gate)
EVAL_IGNORES = ("--mesh_shape",)


def load_distilled(path: str):
    """-> (image_syn NHWC float32, text_syn float32, payload with the
    learned LRs or {} for a ``.pt`` pair)."""
    if path.endswith(".pt"):
        # --save_pt pair: images_{it}.pt (NCHW) + labels_{it}.pt; the
        # reference's format carries no learned LR
        lbl = path.replace("images_", "labels_")
        if lbl == path or not os.path.exists(lbl):
            raise SystemExit(f"Sibling labels file not found: {lbl}")
        imgs = torch.load(path, map_location="cpu", weights_only=True)
        image_syn = np.asarray(imgs, np.float32).transpose(0, 2, 3, 1)
        text_syn = np.asarray(
            torch.load(lbl, map_location="cpu", weights_only=True),
            np.float32)
        return image_syn, text_syn, {}
    with np.load(path) as f:
        payload = dict(f)
    return (payload["image_syn"].astype(np.float32),
            payload["text_syn"].astype(np.float32), payload)


def choose_lr_net(cfg: Config, payload, explicit: set) -> float:
    """Explicit ``--lr_net`` > the npz's learned ``syn_lr_img`` > the
    default, with the JAX CLI's messages (an LR sweep over a saved set must
    not be pinned to the embedded value)."""
    if "lr_net" in explicit:
        print(f"Using the explicit --lr_net={cfg.lr_net} (overrides the "
              "npz-embedded learned LR)")
        return cfg.lr_net
    if "syn_lr_img" in payload:
        lr_net = float(payload["syn_lr_img"])
        print(f"Using the learned inner LR from the npz: lr_net={lr_net:.6f}")
        return lr_net
    print("No embedded learned LR (pre-round-3 npz or .pt pair); "
          f"lr_net={cfg.lr_net}")
    return cfg.lr_net


def main(cfg: Config, argv: Optional[Sequence[str]] = None) -> List[dict]:
    """``argv``: the command line the config came from (``sys.argv`` when
    None), read only for an explicit ``--lr_net``.  A flag whose module is
    not ported yet, or a card asked for and missing, raises before any
    data is read (:func:`check_supported`); so does a launch of more than
    one rank (the JAX eval CLI builds no mesh)."""
    check_supported(cfg, ignore=EVAL_IGNORES)
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world > 1:
        raise RuntimeError(
            f"eval_distilled runs on one card, as the JAX eval CLI builds "
            f"no mesh ({world} ranks launched): run it as one process; the "
            f"distill CLI splits its eval students over the ranks")
    cfg = cfg.replace(stem_s2d=False)
    if not cfg.distilled_npz:
        raise SystemExit("--distilled_npz=<path to distilled_{it}.npz or "
                         "images_{it}.pt> is required")
    image_syn, text_syn, payload = load_distilled(cfg.distilled_npz)
    lr_net = choose_lr_net(cfg, payload, explicit_flags(argv))
    print(f"Distilled set: {image_syn.shape[0]} pairs, "
          f"images {image_syn.shape}, texts {text_syn.shape}")

    _, testloader, _, _ = get_dataset(cfg)
    data = load_or_process_file("text", textprocess, cfg, testloader)
    bert_test_embed = data["bert_test_embed"].astype(np.float32)

    eval_cfg = cfg.replace(distill=True, lr_net=lr_net)
    eval_model = build_bi_encoder(eval_cfg)
    eval_init = make_eval_initializer(cfg)

    if cfg.parallel_eval and cfg.num_eval > 1:
        var_list = [eval_init(eval_model, cfg.seed + 1000 + j)
                    for j in range(cfg.num_eval)]
        _, results = evaluate_synset_parallel(
            cfg.num_eval, eval_model, var_list, image_syn, text_syn,
            testloader, eval_cfg, bert_test_embed)
    else:
        results = []
        for j in range(cfg.num_eval):
            variables = eval_init(eval_model, cfg.seed + 1000 + j)
            results.append(evaluate_synset(
                j, eval_model, variables, image_syn, text_syn, testloader,
                eval_cfg, bert_test_embed)[2])
    for j, val in enumerate(results):
        print(f"Evaluate_{j:02d}: "
              + " ".join(f"{k}={v:.4f}" for k, v in val.items()))

    if cfg.std and results:
        for k in results[0]:
            vals = [r[k] for r in results]
            print(f"Mean/{k} = {np.mean(vals):.4f}  "
                  f"Std/{k} = {np.std(vals):.4f}")
    return results


if __name__ == "__main__":
    main(parse_config())
