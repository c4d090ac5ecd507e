#!/usr/bin/env python3
"""Are the port's eval students bit-reproducible, and if not, which op
differs?

    python3 tools/torch_eval_repro.py [--shape recipe|phase8|toy]
        [--mode plain|cudnn_det|strict] [--reps 4] [--blocks 2]
        [--tag NAME] [--out FILE]

One eval block as the distill CLI runs it (2 students through
``evaluate_synset_parallel``, each from ``make_eval_initializer``'s seeded
init, on a seeded synthetic set and test split) is run twice in one
process from the same init and set (``--blocks`` more than 2: more
blocks, for their times).  Printed as one JSON line:

* ``block``: the two blocks' metrics, whether each student's trained
  parameters, score matrix (before the top-k mask) and masked i2t / t2i
  matrices are ``torch.equal``, and every block's wall seconds (host clock
  between synchronizes; the first block builds cuDNN's plans);
* ``grads``: one training step's gradients taken ``--reps`` times from the
  same weights (the first block's first student) and generator, by
  ``loss.backward()`` outside the trainer's step (so outside its
  ``deterministic_cudnn`` scope, under ``--mode`` alone): the parameters
  whose gradient is not bit-identical every time, in forward order, with
  their module's class and the largest difference.  A nondeterministic
  weight-gradient op shows as its own weight alone; a nondeterministic
  input-gradient op moves every parameter upstream of it, the last of
  which is its own;
* ``forward``: whether the image and text embeddings of two forward
  passes are equal;
* ``scores``: whether ``score_matrix`` of one trained student, taken
  twice, is equal.

``--shape``: ``recipe`` is ``tools/torch_quality_nfnet.sh``'s block (100
pairs, batch 50, 4 + 1 epochs, a 64 x 5 test split, tiny BERT's 128-wide
text); ``phase8`` is ``chip_smoke.py`` phase 8's (batch 128, 1 + 1
epochs, a 1000 x 5 test split, BERT-base's 768); ``toy`` is NF_TINY at
32^2 on the CPU (8 pairs, batch 4, 1 + 1 epochs, an 8 x 5 test split),
to rehearse the script without a card.  ``--mode``:
``plain`` runs as the package does; ``cudnn_det`` sets
``torch.backends.cudnn.deterministic`` for the whole run;
``strict`` runs under ``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), which raises at the first op that
has no deterministic implementation: the error is recorded under
``strict_error`` and the run goes on with ``warn_only``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_HEADLINE = dict(image_encoder="nfnet", image_size=224, device="cuda")
SHAPES = {
    "recipe": dict(_HEADLINE, pairs=100, batch_train=50, epoch_eval_train=4,
                   test=64, text_encoder_config="tiny"),
    "phase8": dict(_HEADLINE, pairs=100, batch_train=128, epoch_eval_train=1,
                   test=1000, text_encoder_config="base"),
    "toy": dict(image_encoder="nf_tiny", image_size=32, device="cpu",
                pairs=8, batch_train=4, epoch_eval_train=1, test=8,
                text_encoder_config="tiny"),
}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", choices=sorted(SHAPES), default="recipe")
    p.add_argument("--mode", choices=("plain", "cudnn_det", "strict"),
                   default="plain")
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--tag", default="")
    p.add_argument("--out")
    return p.parse_args(argv)


def setup(args):
    """-> (cfg, eval model, init fn, syn images, syn texts, test loader,
    test text embeddings)."""
    import numpy as np

    from multimodal_dataset_distillation_tpu_torch.cli.distill import (
        make_eval_initializer)
    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.data import get_dataset
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        build_bi_encoder)

    shape = SHAPES[args.shape]
    cfg = Config(dataset="synthetic", image_encoder=shape["image_encoder"],
                 image_size=shape["image_size"], text_encoder="bert",
                 text_encoder_config=shape["text_encoder_config"],
                 synthetic_test_size=shape["test"], num_eval=2,
                 epoch_eval_train=shape["epoch_eval_train"],
                 batch_train=shape["batch_train"], batch_size_test=64,
                 k_test=128, parallel_eval=True, pallas_gconv=True,
                 image_pretrained=False, lr_net=0.1, distill=True, seed=0,
                 num_workers=0, device=shape["device"])
    _, testloader, _, _ = get_dataset(cfg)
    model = build_bi_encoder(cfg)
    dim = model.text_projection.projection.in_features
    rng = np.random.RandomState(0)
    images = rng.randn(shape["pairs"], cfg.image_size, cfg.image_size,
                       3).astype(np.float32)
    texts = rng.randn(shape["pairs"], dim).astype(np.float32)
    bert = rng.randn(5 * shape["test"], dim).astype(np.float32)
    return (cfg, model, make_eval_initializer(cfg), images, texts,
            testloader, bert)


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def one_block(cfg, model, init, images, texts, testloader, bert):
    """-> (metrics per student, trained state per student, scores, wall s):
    a fresh block, as the distill CLI's first."""
    import torch

    from multimodal_dataset_distillation_tpu_torch.engine import eval as ev

    var_list = [init(model, cfg.seed + 1000 + j) for j in range(cfg.num_eval)]
    reuse: dict = {}
    sync(cfg.device)
    t0 = time.perf_counter()
    _, results = ev.evaluate_synset_parallel(
        cfg.num_eval, model, var_list, images, texts, testloader, cfg, bert,
        reuse=reuse)
    sync(cfg.device)
    wall = time.perf_counter() - t0
    states, scores = [], []
    for j in range(cfg.num_eval):
        m = reuse["trainer"].model_for(j)
        states.append({k: v.detach().clone() for k, v in
                       m.state_dict().items()})
        sims = ev.score_matrix(testloader, m, bert)
        scores.append((sims, ev.topk_score_matrix(sims, cfg.k_test),
                       ev.topk_score_matrix(sims.T, cfg.k_test)))
    return results, states, scores, wall


def block_diff(a, b) -> dict:
    import torch

    out = {"metrics": [a[0], b[0]], "metrics_equal": a[0] == b[0],
           "students": []}
    for j in range(len(a[1])):
        differ = [k for k in a[1][j] if not torch.equal(a[1][j][k],
                                                        b[1][j][k])]
        out["students"].append({
            "params_differ": len(differ), "first_params_differ": differ[:8],
            "sims_equal": torch.equal(a[2][j][0], b[2][j][0]),
            "i2t_equal": torch.equal(a[2][j][1], b[2][j][1]),
            "t2i_equal": torch.equal(a[2][j][2], b[2][j][2]),
            "sims_max_abs_diff": float((a[2][j][0] - b[2][j][0]).abs().max())})
    out["bit_identical"] = out["metrics_equal"] and all(
        s["params_differ"] == 0 and s["sims_equal"] and s["i2t_equal"]
        and s["t2i_equal"] for s in out["students"])
    return out


def grad_spread(cfg, model, variables, images, texts, reps: int) -> dict:
    """One training step's gradients, ``reps`` times from the same weights
    (a trained student's: at the seeded init the skipinit gains are 0 and
    the residual branches' weights get no gradient) and generator: which
    parameters differ, in forward order."""
    import torch

    from multimodal_dataset_distillation_tpu_torch.engine.expert import (
        BiEncoderTrainer)

    trainer = BiEncoderTrainer(model, variables, lr_img=cfg.lr_net,
                               lr_txt=cfg.lr_net, momentum=0.9,
                               weight_decay=5e-4, seed=cfg.seed)
    n = cfg.batch_train
    x = trainer._augment(trainer._put(images[:n]))
    t = torch.as_tensor(texts[:n], device=trainer.device)
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}"] = type(mod).__name__
    grads, embeds = [], []
    for _ in range(reps):
        trainer.reset(variables, seed=cfg.seed)
        model.zero_grad(set_to_none=True)
        loss, _ = trainer._loss(x, t)
        loss.backward()
        grads.append({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()
                      if p.grad is not None})
        with torch.no_grad():
            embeds.append((model.encode_image(x).clone(),
                           model.project_text(t).clone()))
    differ = []
    for k in grads[0]:
        d = max(float((g[k] - grads[0][k]).abs().max()) for g in grads[1:])
        if any(not torch.equal(g[k], grads[0][k]) for g in grads[1:]):
            differ.append({"param": k, "module": owner.get(k, "?"),
                           "shape": list(grads[0][k].shape),
                           "max_abs_diff": d})
    return {"reps": reps, "params": len(grads[0]), "differ": differ,
            "forward_equal": all(torch.equal(e[0], embeds[0][0])
                                 and torch.equal(e[1], embeds[0][1])
                                 for e in embeds[1:])}


def main(argv=None) -> int:
    args = parse(argv)
    if args.mode == "strict":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from multimodal_dataset_distillation_tpu_torch.engine import eval as ev
    from multimodal_dataset_distillation_tpu_torch.ops import gconv as gc

    device = SHAPES[args.shape]["device"]
    if device == "cuda":
        if not torch.cuda.is_available():
            print("torch_eval_repro: no CUDA card", file=sys.stderr)
            return 3
        gc.build()
    out = {"tag": args.tag, "shape": args.shape, "mode": args.mode}
    if args.mode == "cudnn_det":
        torch.backends.cudnn.deterministic = True
    if args.mode == "strict":
        torch.use_deterministic_algorithms(True)
    parts = setup(args)
    cfg, model = parts[0], parts[1]
    if args.mode == "strict":
        try:
            one_block(*parts)
        except RuntimeError as e:
            out["strict_error"] = str(e).splitlines()[0][:400]
        torch.use_deterministic_algorithms(True, warn_only=True)
    blocks = [one_block(*parts) for _ in range(max(2, args.blocks))]
    out["block"] = block_diff(*blocks[:2])
    out["block"]["wall_s"] = [b[3] for b in blocks]
    out["grads"] = grad_spread(cfg, model, blocks[0][1][0], parts[3],
                               parts[4], args.reps)
    m = blocks[0][1][0]
    model.load_state_dict(m)
    s = [ev.score_matrix(parts[5], model, parts[6]) for _ in range(2)]
    out["scores"] = {"equal": torch.equal(*s)}
    if device == "cuda":
        out["launches"] = dict(gc.LAUNCHES)
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    line = json.dumps(out)
    print("eval repro: " + line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
