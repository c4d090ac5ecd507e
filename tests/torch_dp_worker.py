"""Rank processes of the port's data-parallel tests (not a test module).

:func:`spawn` starts ``world`` copies of this file, one per rank, on a
``gloo`` process group with a ``file://`` rendezvous in the test's
``tmp_path`` (no TCP port, so pytest-xdist workers never clash).  Each
rank runs with one torch thread, reads the job (a pickle) and writes its
result to ``out_{rank}.pkl``.  The ranks import the port only: no JAX, and
no test module that imports it.

Run by hand as: python tests/torch_dp_worker.py <job.pkl> <rank> <world>
<local_world>
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: seconds a test waits for its ranks
JOIN_TIMEOUT = 120


def spawn(tmp_path, job: Dict[str, Any], world: int,
          local_world: int = 0) -> List[Any]:
    """Run ``job`` on ``world`` ranks (``local_world`` per node, default
    all on one node); -> each rank's result, in rank order.  A rank that
    fails or outlives the timeout fails the call, with its output."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    job = dict(job, init=f"file://{tmp}/rendezvous_{time.time_ns()}",
               out=tmp)
    path = os.path.join(tmp, f"job_{time.time_ns()}.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path, str(r), str(world),
         str(local_world or world)], env=env, cwd=tmp,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.time() + JOIN_TIMEOUT
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} failed "
                                 f"(exit {p.returncode}):\n{logs[r]}")
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"out_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the scenarios (run inside a rank)
# ---------------------------------------------------------------------------

def _model(job):
    """The job's bi-encoder; ``drop_path`` sets every DropPath's rate."""
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        VLBiEncoder,
    )
    from multimodal_dataset_distillation_tpu_torch.models.layers import (
        DropPath,
    )

    model = VLBiEncoder(**job["model_kw"])
    model.load_state_dict(job["state_dict"])
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = job.get("drop_path", m.rate)
    return model


def distill(job, mesh):
    """Per mode of ``job["modes"]``: the per-step students at the initial
    state, the first outer step on the job's seeds (its loss, and its
    meta-gradients read from the whole state's momentum traces: optax's
    start at 0, so the first trace is the gradient the step applied),
    then ``job["steps"]`` more outer steps -> the whole state and this
    rank's raw rows."""
    import numpy as np
    import torch

    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.engine.distill import (
        Distiller,
    )

    out = []
    dtype = {"float64": torch.float64}.get(job.get("dtype"), torch.float32)
    for mode in job["modes"]:
        cfg = Config(**{**job["cfg"], **mode})
        d = Distiller(cfg, _model(job).to(dtype), *job["data"], device="cpu",
                      mesh=mesh)
        seg = [torch.as_tensor(s, dtype=d.out_dtype) for s in job["seg"]]
        st = d.state
        his, hts = d.unroll(d._whole_syn(st.image_syn),
                            d._whole_syn(st.text_syn), st.syn_lr_img,
                            st.syn_lr_txt, seg[0], seg[1],
                            d._indices(job["idx"]), job["seeds"])
        d.draw_seeds = lambda n: job["seeds"]
        first = d.step(*seg, job["idx"])
        del d.draw_seeds
        st = d.whole_state()
        res = dict(loss=float(first["grand_loss"]),
                   grads=[g.numpy() for g in (st.mom_img, st.mom_txt,
                                              *st.mom_lr)],
                   his=his.numpy(), hts=hts.numpy(), losses=[])
        for _ in range(job.get("steps", 0)):
            m = d.step(*seg, job["idx"])
            res["losses"].append(float(m["grand_loss"]))
        whole = d.whole_state()
        res["state"] = [whole.image_syn.numpy(), whole.text_syn.numpy(),
                        float(whole.syn_lr_img), float(whole.syn_lr_txt),
                        whole.mom_img.numpy(), whole.mom_txt.numpy()]
        res["own_rows"] = [d.state.image_syn.numpy(),
                           d.state.text_syn.numpy(),
                           d.state.mom_img.numpy(), d.state.mom_txt.numpy()]
        res["loss_bits"] = np.float64(res["losses"][-1] if res["losses"]
                                      else res["loss"]).tobytes()
        out.append(res)
    return out


def gather_f64(job, mesh):
    """Second derivatives through gather_rows, in float64: the reverse
    pass over a forward-mode jvp, the jvp of a gradient and
    reverse-over-reverse, of a loss over the gathered rows of every rank."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from multimodal_dataset_distillation_tpu_torch.ops.contrastive import (
        log_softmax,
    )
    from multimodal_dataset_distillation_tpu_torch.parallel import (
        collectives as col,
    )

    torch.manual_seed(0)
    w = torch.randn(6, 5, dtype=torch.float64)
    v = torch.randn(6, 5, dtype=torch.float64)
    x_all = torch.randn(8, 6, dtype=torch.float64)
    x = col.slice_rows(x_all, mesh)

    def loss(w_, x_):
        f = torch.tanh(x_ @ col.copy_to_ranks(w_, mesh))
        f = col.gather_rows(f, mesh)
        g = f / f.norm(dim=1, keepdim=True)
        logits = 3.0 * g @ g.T
        return log_softmax(logits, 1).diagonal().mean() + (f ** 3).sum()

    # reverse over reverse
    a = w.clone().requires_grad_()
    xa = x.clone().requires_grad_()
    (gw,) = torch.autograd.grad(loss(a, xa), a, create_graph=True)
    rr = torch.autograd.grad((gw * v).sum(), (a, xa))
    # grad of jvp (rof)
    a = w.clone().requires_grad_()
    xa = x.clone().requires_grad_()
    with fwAD.dual_level():
        h = fwAD.unpack_dual(loss(fwAD.make_dual(a, v), xa)).tangent
    rof = torch.autograd.grad(h, (a, xa))
    # jvp of grad (for)
    fo = torch.func.jvp(lambda w_, x_: torch.func.grad(
        loss, argnums=(0, 1))(w_, x_), (w, x), (v, torch.zeros_like(x)))[1]
    return dict(rr=[t.numpy() for t in rr], rof=[t.numpy() for t in rof],
                fo=[t.numpy() for t in fo],
                value=float(loss(w, x)))


def expert(job, mesh):
    """The buffer CLI on this rank -> the buffer files it wrote."""
    import glob

    import numpy as np

    from multimodal_dataset_distillation_tpu_torch.cli import buffer
    from multimodal_dataset_distillation_tpu_torch.config import Config

    os.chdir(job["cwd"])
    saved = buffer.main(Config(**job["cfg"]))
    files = {}
    for p in sorted(glob.glob(os.path.join(job["cfg"]["buffer_path"], "**",
                                           "*.npz"), recursive=True)):
        with np.load(p) as f:
            files[os.path.basename(p)] = {k: f[k] for k in f.files}
    return dict(saved=saved, files=files if mesh.rank == 0 else None)


class _ShardBatches:
    """Batch k the concatenation, in rank order, of batch k of each
    shard loader: the global batches of a ``--distributed`` run."""

    def __init__(self, loaders):
        self.loaders = loaders

    def set_epoch(self, epochs_done):
        for loader in self.loaders:
            loader.set_epoch(epochs_done)

    def __len__(self):
        return len(self.loaders[0])

    def __iter__(self):
        import numpy as np

        for parts in zip(*self.loaders):
            yield tuple(np.concatenate(c) if isinstance(c[0], np.ndarray)
                        else [x for part in c for x in part]
                        for c in zip(*parts))


def expert_shards(job, mesh):
    """The buffer CLI on one rank whose batch k is batch k of each of
    ``job["shards"]`` ranks' ``--distributed`` shards (``Loader(shard=)``
    at the per-rank batch), in rank order -> the buffer files."""
    from multimodal_dataset_distillation_tpu_torch.cli import buffer
    from multimodal_dataset_distillation_tpu_torch.data.pipeline import (
        Loader,
    )

    count = job["shards"]

    def plan(cfg, mesh, trainloader):
        per = trainloader.batch_size // count
        return list(range(cfg.num_experts)), mesh, _ShardBatches([
            Loader(trainloader.dataset, per, shuffle=True, drop_last=True,
                   num_workers=cfg.num_workers, seed=cfg.seed,
                   shard=(r, count)) for r in range(count)]), False

    buffer.data_parallel_plan = plan
    return expert(job, mesh)


def eval_students(job, mesh):
    """evaluate_synset_parallel, the students split over the ranks (on the
    synthetic dataset's test split, with random caption embeddings)."""
    import numpy as np

    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.data import get_dataset
    from multimodal_dataset_distillation_tpu_torch.engine.eval import (
        evaluate_synset_parallel,
    )
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        init_bi_encoder,
    )

    cfg = Config(**job["cfg"])
    _, testloader, _, test_ds = get_dataset(cfg)
    embed = np.random.RandomState(5).randn(
        len(test_ds.txt2img), 768).astype(np.float32)
    model = _model(job)
    variables = [{k: v.clone() for k, v in
                  init_bi_encoder(model, 1000 + j).state_dict().items()}
                 for j in range(cfg.num_eval)]
    acc, val = evaluate_synset_parallel(
        cfg.num_eval, model, variables, *job["syn"], testloader, cfg, embed,
        mesh=mesh if mesh.world > 1 else None)
    return dict(acc=acc, val=val)


def resume(job, mesh):
    """Outer steps from a checkpoint (optionally written first) -> the
    whole state after them."""
    import torch

    from multimodal_dataset_distillation_tpu_torch.config import Config
    from multimodal_dataset_distillation_tpu_torch.engine.checkpoint import (
        load_distill_checkpoint,
        save_distill_checkpoint,
    )
    from multimodal_dataset_distillation_tpu_torch.engine.distill import (
        Distiller,
    )

    d = Distiller(Config(**job["cfg"]), _model(job), *job["data"],
                  device="cpu", mesh=mesh)
    seg = [torch.as_tensor(s) for s in job["seg"]]
    if job.get("load"):
        load_distill_checkpoint(job["load"], d)
    for idx in job["before"]:
        d.step(*seg, idx)
    if job.get("save"):
        save_distill_checkpoint(job["save"], d, len(job["before"]))
    for idx in job["after"]:
        d.step(*seg, idx)
    st = d.whole_state()
    return [st.image_syn.numpy(), st.text_syn.numpy(), float(st.syn_lr_img),
            float(st.syn_lr_txt), st.mom_img.numpy(), st.mom_txt.numpy()]


def distill_cli(job, mesh):
    """The distill CLI on this rank -> its Grand_Loss log (rank 0)."""
    import json

    from multimodal_dataset_distillation_tpu_torch.cli import distill as cli
    from multimodal_dataset_distillation_tpu_torch.config import Config

    os.chdir(job["cwd"])
    distiller, history = cli.main(Config(**job["cfg"]))
    losses = []
    log = os.path.join(job["cfg"]["save_dir"], "run.jsonl")
    if mesh.rank == 0:
        with open(log) as f:
            losses = [r["Grand_Loss"] for r in map(json.loads, f)
                      if "Grand_Loss" in r]
    img, txt = distiller.syn_arrays()
    return dict(losses=losses, history=history, syn=(img, txt))


SCENARIOS = dict(distill=distill, gather_f64=gather_f64, expert=expert,
                 expert_shards=expert_shards, eval_students=eval_students, resume=resume,
                 distill_cli=distill_cli)


def main(argv):
    path, rank, world, local_world = argv[0], *map(int, argv[1:4])
    with open(path, "rb") as f:
        job = pickle.load(f)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=job["init"],
                            world_size=world, rank=rank)
    from multimodal_dataset_distillation_tpu_torch.parallel.mesh import (
        get_mesh,
    )

    mesh = get_mesh(device="cpu")
    result = SCENARIOS[job["scenario"]](job, mesh)
    with open(os.path.join(job["out"], f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
