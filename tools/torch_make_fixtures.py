#!/usr/bin/env python
"""Offline dataset fixtures in the reference's on-disk formats, written by
the PyTorch port's own data module.

Counterpart of ``tools/make_fixtures.py`` that imports nothing of the JAX
package: the images and captions come from the port's copy of the
synthetic dataset's concept generator
(``multimodal_dataset_distillation_tpu_torch/data/datasets.py``:
``_sample_concept``, ``_draw_fake_image``, ``_caption_for``), with the
same seeds, sizes and JPEG quality, so the two tools write the same bytes.

* ``coco``: Karpathy-split JSONs. Train rows are
  ``{"image", "caption": <str>, "image_id"}``, two per image, so image ids
  repeat; val/test rows are ``{"image", "caption": [<5 strs>]}``; the
  images sit under ``images/val2014/`` and the JSONs name them by relative
  path.
* ``roco``: the ROCOv2 ``id,name,caption`` CSV over a flat image
  directory. Row 1's JPEG is truncated to 40 bytes and row 2's file is
  removed, so every run over the fixture takes the loader's black-image
  fallback.

Usage::

    python tools/torch_make_fixtures.py coco <out_dir> [n_train] [n_test]
    python tools/torch_make_fixtures.py roco <out_dir> [n_rows]

Used by ``tools/torch_quality_{roco,coco}.sh`` and ``chip_smoke.py``.
"""

import csv
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_dataset_distillation_tpu_torch.data.datasets import (  # noqa: E402
    _caption_for,
    _draw_fake_image,
    _sample_concept,
)

IMG_SIZE = 64
JPEG_QUALITY = 92
COCO_SEEDS = {"train": 0, "val": 1, "test": 2}
ROCO_SEED = 3


def concept_images(n, seed):
    """[(PIL image, [5 captions])] * n from one ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        color, shape, bg = _sample_concept(rng)
        img = _draw_fake_image(rng, IMG_SIZE, color, shape, bg)
        caps = [_caption_for(rng, color, shape, bg) for _ in range(5)]
        out.append((img, caps))
    return out


def make_coco(out_dir, n_train=64, n_test=16):
    os.makedirs(os.path.join(out_dir, "images", "val2014"), exist_ok=True)
    ann_dir = os.path.join(out_dir, "ann")
    os.makedirs(ann_dir, exist_ok=True)

    train = []
    for i, (img, caps) in enumerate(concept_images(n_train,
                                                   COCO_SEEDS["train"])):
        name = f"val2014/COCO_val2014_{i:012d}.jpg"
        img.save(os.path.join(out_dir, "images", name), quality=JPEG_QUALITY)
        train += [{"image": name, "caption": cap, "image_id": str(i)}
                  for cap in caps[:2]]
    with open(os.path.join(ann_dir, "coco_karpathy_train.json"), "w") as f:
        json.dump(train, f)

    for split in ("val", "test"):
        rows = []
        for i, (img, caps) in enumerate(concept_images(n_test,
                                                       COCO_SEEDS[split])):
            name = f"val2014/COCO_{split}_{i:012d}.jpg"
            img.save(os.path.join(out_dir, "images", name),
                     quality=JPEG_QUALITY)
            rows.append({"image": name, "caption": caps})
        with open(os.path.join(ann_dir, f"coco_karpathy_{split}.json"),
                  "w") as f:
            json.dump(rows, f)
    print(f"coco fixture: {len(train)} train rows, {n_test} eval images "
          f"x 5 captions -> {out_dir}")


def make_roco(out_dir, n_rows=64):
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    for i, (img, caps) in enumerate(concept_images(n_rows, ROCO_SEED)):
        name = f"ROCOv2_2023_{i:06d}.jpg"
        path = os.path.join(img_dir, name)
        img.save(path, quality=JPEG_QUALITY)
        if i == 1:   # corrupt: PIL raises on the truncated stream
            with open(path, "r+b") as f:
                f.truncate(40)
        if i == 2:   # missing file
            os.remove(path)
        rows.append({"id": f"R{i:05d}", "name": name, "caption": caps[0]})
    csv_path = os.path.join(out_dir, "radiologytraindata.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "name", "caption"])
        w.writeheader()
        w.writerows(rows)
    print(f"roco fixture: {len(rows)} CSV rows (row 1 corrupt jpeg, "
          f"row 2 missing file) -> {csv_path}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    kind, out, sizes = argv[0], argv[1], [int(a) for a in argv[2:]]
    if kind == "coco":
        make_coco(out, *sizes)
    elif kind == "roco":
        make_roco(out, *sizes)
    else:
        raise SystemExit(f"unknown fixture kind: {kind}")


if __name__ == "__main__":
    main()
