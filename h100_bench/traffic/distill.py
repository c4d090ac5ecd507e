"""Driver of the ``distill`` traffic kind: the outer distillation step.

Set-up writes the mix's expert buffer files (``.pt``, the program's
container: a list of trajectories of snapshots of per-parameter tensors
in the flat order) to the run's temporary directory, serves them through
the program's ``ExpertCycler`` and builds its ``Distiller`` over a seeded
synthetic set.  The first ``first_steps`` outer steps go through the
window's own call and are the ones the reference follows.

The window's body is the distill CLI's loop: ``next_segment_device()``,
``sample_indices``, ``step_traj``, then the previous step's loss read
back while this one runs.  No eval blocks, no checkpoints.
"""

from __future__ import annotations

import gc
import math
import os
import time

import numpy as np
import torch

from h100_bench import harness
from h100_bench.reference import exact_float32, nf, train, walk
from h100_bench.trace import profile_steps

P = harness.PROGRAM


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cell.cfg
        self.mix = ctx.cell.mix
        self.hp = {**self.cfg["distill"], **ctx.overrides}
        self.dev = torch.device(ctx.device)
        t = self.cfg["tower"]
        self.img_table = nf.param_table(t)
        self.txt_table = nf.text_param_table(self.cfg["text"]["embedding"],
                                             nf.feature_width(t))
        self.timed = False

    # -- set-up ------------------------------------------------------------

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _write_buffers(self, gen):
        """The mix's buffer files: per expert a seeded init and a random walk
        of ``snapshots`` epochs."""
        mix, step = self.mix, self.cfg["init"]["trajectory_step"]
        self.files = ([], [])
        for f in range(mix["buffer_files"]):
            trajs = ([], [])
            for _ in range(mix["experts_per_file"]):
                for tr, table in zip(trajs, (self.img_table, self.txt_table)):
                    th = harness.init_flat(table, gen, self.dev, self.cfg["init"])
                    snaps = [th]
                    for _ in range(mix["snapshots"] - 1):
                        th = th + step * torch.randn(th.shape, generator=gen,
                                                     device=self.dev)
                        snaps.append(th)
                    tr.append([[v.view(s) for v, (_, s, _) in zip(
                        harness.split_leaves(sn.cpu(), table), table)]
                        for sn in snaps])
            for kind, tr, out in zip(("img", "txt"), trajs, self.files):
                path = os.path.join(self.ctx.tmpdir, f"{kind}_replay_buffer_{f}.pt")
                torch.save(tr, path)
                out.append(path)

    def prepare(self):
        from importlib import import_module

        Config = import_module(f"{P}.config").Config
        build = import_module(f"{P}.models.clip_model").build_bi_encoder
        eng = import_module(f"{P}.engine.distill")
        hp, mix, cfg, seed = self.hp, self.mix, self.cfg, self.ctx.seed
        self.pcfg = Config(
            image_encoder=cfg["port_encoder"], image_size=cfg["image_size"],
            text_encoder_config=cfg["text"].get("port_config", "base"),
            num_queries=hp["num_queries"], mini_batch_size=hp["mini_batch_size"],
            syn_steps=hp["syn_steps"], expert_epochs=hp["expert_epochs"],
            lr_img=hp["lr_img"], lr_txt=hp["lr_txt"], lr_lr=hp["lr_lr"],
            lr_teacher_img=hp["lr_teacher"], lr_teacher_txt=hp["lr_teacher"],
            inner_dtype=hp["inner_dtype"], hvp_mode=hp["hvp_mode"],
            fr_bwd=hp["fr_bwd"], pallas_gconv=hp["pallas_gconv"],
            stem_s2d=hp["stem_s2d"], max_start_epoch=mix["max_start_epoch"],
            load_all=mix["load_all"], seed=seed, device=self.ctx.device)
        model = build(self.pcfg, device=self.dev)
        harness.check_layout(model.image_encoder, self.img_table, "image tower")
        harness.check_layout(model.text_projection, self.txt_table, "text head")
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self._write_buffers(gen)
        n, h = hp["num_queries"], cfg["image_size"]
        mean = torch.tensor(mix["syn_pixel_mean"], device=self.dev)
        std = torch.tensor(mix["syn_pixel_std"], device=self.dev)
        self.image_syn0 = torch.randn((n, h, h, 3), generator=gen,
                                      device=self.dev) * std + mean
        self.text_syn0 = (torch.randn((n, cfg["text"]["embedding"]), generator=gen,
                                      device=self.dev) * mix["syn_text_std"]
                          + mix["syn_text_mean"])
        self.cycler = eng.ExpertCycler(
            *self.files, mix["max_start_epoch"], hp["expert_epochs"],
            model.image_encoder, model.text_projection, seed=seed,
            load_all=mix["load_all"], device_cache_cap=self.pcfg.traj_cache_cap,
            prefetch=self.pcfg.traj_prefetch, device=self.dev)
        self.distiller = eng.Distiller(self.pcfg, model, self.image_syn0,
                                       self.text_syn0, device=self.dev)
        self.rng = np.random.RandomState((seed + 1) % 2 ** 32)
        d = self.distiller
        st0, losses, ref_steps = d.state, [], mix["reference_steps"]
        for k in range(mix["first_steps"]):
            losses.append(self.step()["grand_loss"])
            if k == 0:
                first_grad = [d.state.mom_img, d.state.mom_txt, *d.state.mom_lr]
            if k == ref_steps - 1:
                st = d.state
        self.program = {
            "losses": [float(v) for v in losses[:ref_steps]],
            "grad": [t.detach().cpu() for t in first_grad],
            "change": [(getattr(st, k) - getattr(st0, k)).cpu() for k in
                       ("image_syn", "text_syn", "syn_lr_img", "syn_lr_txt")]}
        self._sync()

    # -- the window ----------------------------------------------------------

    def step(self):
        t0 = time.perf_counter()
        img, txt, start = self.cycler.next_segment_device()
        if self.timed:
            self.ctx.records.span("cycler", time.perf_counter() - t0)
        d = self.distiller
        return d.step_traj(img, txt, start, d.sample_indices(self.rng))

    def window(self, seconds: float, trace: bool) -> dict:
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self._sync()
        self.timed = True
        span = seconds / 2 if trace else seconds
        losses, prev, n, laps = [], None, 0, []
        t0 = time.perf_counter()
        while True:
            m = self.step()
            n += 1
            if prev is not None:
                losses.append(float(prev["grand_loss"]))
            prev = m
            laps.append(time.perf_counter() - t0 - sum(laps))
            if time.perf_counter() - t0 >= span:
                break
        losses.append(float(prev["grand_loss"]))
        self._sync()
        wall = time.perf_counter() - t0
        out = {"work": n, "steps": n, "seconds": wall, "laps": laps,
               "failed": sum(not math.isfinite(v) for v in losses)}
        if trace:
            out["trace"] = profile_steps(self.step, self.mix["profiled_steps"],
                                         self._sync, self.dev.type == "cuda")
        self.timed = False
        if self.dev.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated(self.dev)
        return out

    def free(self):
        self.cycler.close()
        del self.cycler, self.distiller
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------

    def reference(self, quant: str = "float32", half: bool = False) -> dict:
        """The reference's first steps from the same inputs; ``quant`` its
        precision (the control), ``half`` the fault of a minibatch of which
        half is left out."""
        hp, mix, cfg, seed = self.hp, self.mix, self.cfg, self.ctx.seed
        m = train.Model(cfg["tower"], self.img_table, self.txt_table,
                        cfg["reference_rows"], train.QUANTS[quant])
        trajs = ([], [])
        for files, out in zip(self.files, trajs):
            for path in files:
                out.append([torch.stack([torch.cat([t.reshape(-1).float()
                                                    for t in snap])
                                         for snap in traj])
                            for traj in torch.load(path, weights_only=True)])
        segs = walk.segments(mix["buffer_files"], mix["experts_per_file"],
                             mix["snapshots"], mix["max_start_epoch"],
                             hp["expert_epochs"], seed)
        idx_rng = np.random.RandomState((seed + 1) % 2 ** 32)
        seeds = walk.DropoutSeeds(seed)
        lr0 = torch.tensor(hp["lr_teacher"], device=self.dev)
        st0 = train.SynState(self.image_syn0, self.text_syn0, lr0, lr0.clone(),
                             [torch.zeros_like(t) for t in
                              (self.image_syn0, self.text_syn0, lr0, lr0)])
        hpx = {**hp, "text_width": nf.feature_width(cfg["tower"]),
               "text_dropout": cfg["text"]["dropout"]}
        st, losses, e = st0, [], hp["expert_epochs"]
        with exact_float32():
            for k in range(mix["reference_steps"]):
                f, x, start = next(segs)
                ti, tt = trajs[0][f][x], trajs[1][f][x]
                seg = [v.to(self.dev) for v in (ti[start], tt[start],
                                                ti[start + e], tt[start + e])]
                idx = walk.minibatches(idx_rng, hp["num_queries"],
                                       hp["mini_batch_size"], hp["syn_steps"])
                if half:
                    idx = idx[:, :idx.shape[1] // 2]
                st, loss, grads = train.distill_step(
                    m, st, seg, torch.as_tensor(idx, device=self.dev),
                    seeds.draw(hp["syn_steps"]), hpx, self.dev)
                losses.append(float(loss))
                if k == 0:
                    first = [g.cpu() for g in grads]
        return {"losses": losses, "grad": first,
                "change": [(a - b).cpu() for a, b in zip(st.leaves(), st0.leaves())]}


def make(ctx) -> Job:
    return Job(ctx)
