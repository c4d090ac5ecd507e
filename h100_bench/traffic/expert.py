"""Driver of the ``expert`` traffic kind: expert training (phase 1).

Set-up makes a host pool of ``pool`` image-text pairs from the seed, feeds
it through the program's ``ArrayPairLoader`` (shuffled per epoch) and
builds a ``BiEncoderTrainer`` over seeded weights.  The first epoch is
set-up; its first ``first_steps`` steps are the ones the reference
follows.  The window runs whole epochs, each ended by the read of its
losses, as ``train_epoch_arrays`` ends one.
"""

from __future__ import annotations

import gc
import math
import time

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
        self.hp = {**self.cfg["expert"], **ctx.overrides}
        self.dev = torch.device(ctx.device)
        t = self.cfg["tower"]
        self.img_table = nf.param_table(t)
        self.txt_table = nf.text_param_table(self.cfg["text"]["embedding"],
                                             nf.feature_width(t))

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def prepare(self):
        from importlib import import_module

        Config = import_module(f"{P}.config").Config
        build = import_module(f"{P}.models.clip_model").build_bi_encoder
        ArrayPairLoader = import_module(f"{P}.data.pipeline").ArrayPairLoader
        Trainer = import_module(f"{P}.engine.expert").BiEncoderTrainer
        hp, cfg, seed = self.hp, self.cfg, self.ctx.seed
        pcfg = Config(image_encoder=cfg["port_encoder"], image_size=cfg["image_size"],
                      text_encoder_config=cfg["text"].get("port_config", "base"),
                      train_dtype=hp["train_dtype"], pallas_gconv=hp["pallas_gconv"],
                      seed=seed, device=self.ctx.device)
        model = build(pcfg, device=self.dev)
        harness.check_layout(model.image_encoder, self.img_table, "image tower")
        harness.check_layout(model.text_projection, self.txt_table, "text head")
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.thi0 = harness.init_flat(self.img_table, gen, self.dev, cfg["init"])
        self.tht0 = harness.init_flat(self.txt_table, gen, self.dev, cfg["init"])
        harness.load_flat(model.image_encoder, self.thi0)
        harness.load_flat(model.text_projection, self.tht0)
        n, h = self.mix["pool"], cfg["image_size"]
        self.images = torch.randn((n, h, h, 3), generator=gen,
                                  device=self.dev).cpu().numpy()
        self.texts = torch.randn((n, cfg["text"]["embedding"]), generator=gen,
                                 device=self.dev).cpu().numpy()
        self.loader = ArrayPairLoader(self.images, self.texts, hp["batch"],
                                      shuffle=True, seed=seed)
        self.trainer = Trainer(model, None, lr_img=hp["lr_teacher"],
                               lr_txt=hp["lr_teacher"], momentum=hp["momentum"],
                               seed=seed, compute_dtype=hp["train_dtype"],
                               device_augment=hp["device_augment"])
        self.model = model
        snaps, losses = [], []
        for k, (images, texts) in enumerate(self.loader):
            loss, _ = self.trainer.train_batch(images, texts)
            if k < self.mix["reference_steps"]:
                losses.append(loss)
                snaps.append((harness.flat_of(model.image_encoder),
                              harness.flat_of(model.text_projection)))
        lr = hp["lr_teacher"]
        th1, th3 = snaps[0], snaps[-1]
        leaves = self._leaves
        self.program = {
            "losses": [float(v) for v in losses],
            "grad": leaves((self.thi0 - th1[0]) / lr, (self.tht0 - th1[1]) / lr),
            "change": leaves(th3[0] - self.thi0, th3[1] - self.tht0)}
        self._sync()

    def _leaves(self, img, txt):
        return ([t.cpu() for t in harness.split_leaves(img, self.img_table)]
                + [t.cpu() for t in harness.split_leaves(txt, self.txt_table)])

    def epoch(self) -> list:
        """One epoch, ended by the read of its losses."""
        per = [self.trainer.train_batch(images, texts)[0]
               for images, texts in self.loader]
        return torch.stack(per).cpu().tolist()

    def window(self, seconds: float, trace: bool) -> dict:
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self._sync()
        span = seconds / 2 if trace else seconds
        losses, laps = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < span:
            losses += self.epoch()
            laps.append(time.perf_counter() - t0 - sum(laps))
        wall = time.perf_counter() - t0
        n = len(losses)
        out = {"work": n * self.hp["batch"], "steps": n, "seconds": wall,
               "laps": laps, "failed": sum(not math.isfinite(v) for v in losses)}
        if trace:
            batches = (b for _ in iter(int, 1) for b in self.loader)
            out["trace"] = profile_steps(
                lambda: self.trainer.train_batch(*next(batches)),
                self.mix["profiled_steps"], self._sync, self.dev.type == "cuda")
        if self.dev.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated(self.dev)
        return out

    def free(self):
        del self.trainer, self.model, self.loader
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant: str = "float32", half: bool = False) -> dict:
        """The reference's first steps from the same init and pool; its own
        derivation of the first epoch's batches; ``quant`` its precision,
        ``half`` the fault of a batch of which half is left out."""
        hp, cfg, seed = self.hp, self.cfg, self.ctx.seed
        m = train.Model(cfg["tower"], self.img_table, self.txt_table,
                        cfg["reference_rows"], train.QUANTS[quant])
        rows = walk.batch_rows(self.mix["pool"], hp["batch"], seed, 1)
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        hpx = {"lr_img": hp["lr_teacher"], "lr_txt": hp["lr_teacher"],
               "text_width": nf.feature_width(cfg["tower"]),
               "text_dropout": cfg["text"]["dropout"]}
        thi, tht, losses = self.thi0, self.tht0, []
        with exact_float32():
            for k in range(self.mix["reference_steps"]):
                r = rows[k][: len(rows[k]) // 2] if half else rows[k]
                x = torch.as_tensor(self.images[r], device=self.dev)
                y = torch.as_tensor(self.texts[r], device=self.dev)
                thi, tht, loss, grads = train.expert_step(m, thi, tht, x, y, gen,
                                                          hpx, self.dev)
                losses.append(float(loss))
                if k == 0:
                    first = self._leaves(*grads)
        return {"losses": losses, "grad": first,
                "change": self._leaves(thi - self.thi0, tht - self.tht0)}


def make(ctx) -> Job:
    return Job(ctx)
