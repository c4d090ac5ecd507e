"""Dataset factory + loaders (reference ``data/__init__.py:193-270``).

The port's own copy of ``multimodal_dataset_distillation_tpu/data/
__init__.py``.  ``create_dataset(cfg)`` -> (train, val, test) datasets
with the reference transforms; ``get_dataset(cfg)`` -> ``(train_loader,
test_loader, train_dataset, test_dataset)`` (the reference's
``get_dataset_flickr``, which despite the name serves every dataset).
"""

from __future__ import annotations

import os

from ..config import Config
from .datasets import (
    COCO_ANN,
    FLICKR_ANN,
    CifarVLEval,
    CifarVLTrain,
    JsonVLEval,
    JsonVLTrain,
    RocoEval,
    RocoTrain,
    SyntheticVLEval,
    SyntheticVLTrain,
)
from .pipeline import Loader
from .transforms import (
    make_test_transform,
    make_train_transform,
    make_train_transform_native,
    make_train_transform_raw,
)


def create_dataset(cfg: Config, min_scale: float = 0.5):
    """(train, val, test) with reference transforms (data/__init__.py:193-227).

    ``device_augment`` installs the raw-crop train transform (RandAugment
    and normalisation run in the train step), else ``native_decode`` (the
    ``Config`` default) the C++ decode pool's."""
    if cfg.device_augment:
        t_train = make_train_transform_raw(cfg.image_size, min_scale)
    elif cfg.native_decode:
        t_train = make_train_transform_native(cfg.image_size, min_scale)
    else:
        t_train = make_train_transform(cfg.image_size, min_scale)
    t_test = make_test_transform(cfg.image_size)

    if cfg.dataset in ("flickr", "coco"):
        names = FLICKR_ANN if cfg.dataset == "flickr" else COCO_ANN
        ann = lambda s: os.path.join(cfg.ann_root, names[s])  # noqa: E731
        return (JsonVLTrain(ann("train"), cfg.image_root, t_train),
                JsonVLEval(ann("val"), cfg.image_root, t_test),
                JsonVLEval(ann("test"), cfg.image_root, t_test))
    if cfg.dataset == "roco":
        # ann_root is the CSV path in the ROCO flow (Buffer_ROCO_Test.py)
        return (RocoTrain(cfg.ann_root, cfg.image_root, t_train,
                          image_size=cfg.image_size),
                RocoEval(cfg.ann_root, cfg.image_root, t_test,
                         image_size=cfg.image_size),
                RocoEval(cfg.ann_root, cfg.image_root, t_test,
                         image_size=cfg.image_size))
    if cfg.dataset in ("cifar10_vl", "CIFAR10"):
        return (CifarVLTrain(cfg.data_path, t_train),
                CifarVLEval(cfg.data_path, t_test),
                CifarVLEval(cfg.data_path, t_test))
    if cfg.dataset == "synthetic":
        return (SyntheticVLTrain(cfg.synthetic_size, t_train,
                                 cfg.image_size, seed=cfg.seed),
                SyntheticVLEval(cfg.synthetic_test_size, t_test,
                                cfg.image_size, seed=cfg.seed + 1),
                SyntheticVLEval(cfg.synthetic_test_size, t_test,
                                cfg.image_size, seed=cfg.seed + 2))
    raise NotImplementedError(f"unknown dataset: {cfg.dataset}")


def get_dataset(cfg: Config):
    """(train_loader, test_loader, train_dataset, test_dataset) —
    reference ``get_dataset_flickr`` (data/__init__.py:258-270)."""
    train_ds, _val_ds, test_ds = create_dataset(cfg)
    train_loader = Loader(train_ds, cfg.batch_size_train, shuffle=True,
                          drop_last=True, num_workers=cfg.num_workers,
                          seed=cfg.seed)
    test_loader = Loader(test_ds, cfg.batch_size_test, shuffle=False,
                         drop_last=False, num_workers=cfg.num_workers)
    return train_loader, test_loader, train_ds, test_ds
