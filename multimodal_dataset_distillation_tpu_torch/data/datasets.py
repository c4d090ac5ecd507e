"""Dataset definitions: Flickr30K, COCO (Karpathy), ROCOv2, CIFAR-as-VL, synthetic.

The port's own copy of ``multimodal_dataset_distillation_tpu/data/
datasets.py``: the same files read, the same pixels, captions and
retrieval maps for the same seed.

Re-designs of the reference dataset classes:
* ``flickr30k_train`` / ``flickr30k_retrieval_eval``
  (``data/flickr30k_dataset.py:38-128``) — BLIP-style JSON annotations;
  train yields ``(image, caption, img_id)``, eval builds ``text[]``,
  ``image[]``, ``img2txt{}``, ``txt2img{}`` (5 captions/image).
* ``coco_train`` / ``coco_retrieval_eval`` (``data/coco_dataset.py``) —
  same shape, Karpathy-split JSONs.
* ``roco_train`` / ``roco_retrieval_eval``
  (``data/rocov2Radiology_dataset.py``) — CSV-driven (id,name,caption),
  train capped at 1000 images, eval at 100, 1 caption/image, black-image
  fallback for missing/corrupt files.
* ``cifar_dataset.py`` — CIFAR10 wrapped with prompt templates (the
  reference file is syntactically broken at HEAD; rebuilt working here).
* ``synthetic`` — a deterministic generated VL dataset for offline
  CI/benchmarks (no network, no image files).

All images come back as normalized NHWC float32; annotation download is
NOT attempted (air-gapped) — files must exist locally, mirroring the
reference's cache-after-download behavior.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List

import numpy as np
from PIL import Image

from .caption import pre_caption


class VLTrainDataset:
    """Common train-side interface: index -> (image, caption, img_id)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int):
        raise NotImplementedError

    def get_all_captions(self) -> List[str]:
        raise NotImplementedError


class VLEvalDataset:
    """Common eval-side interface with retrieval ground truth maps."""

    text: List[str]
    image: List[str]
    img2txt: Dict[int, List[int]]
    txt2img: Dict[int, int]

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int):
        raise NotImplementedError


def _load_image(path: str, transform: Callable,
                fallback_black: bool = False,
                image_size: int = 224) -> np.ndarray:
    try:
        if getattr(transform, "accepts_bytes", False):
            # native fast path: the transform decodes raw file bytes via
            # the C++ fastimage pipeline (GIL-free), PIL only on fallback
            with open(path, "rb") as f:
                return transform(f.read())
        with Image.open(path) as im:
            return transform(im)
    except Exception:
        if not fallback_black:
            raise
        # ROCO behavior: black-image substitution for unreadable files
        # (data/rocov2Radiology_dataset.py:60-68)
        return transform(Image.new("RGB", (image_size, image_size)))


# ---------------------------------------------------------------------------
# Flickr30K / COCO (BLIP-style JSON annotation format)
# ---------------------------------------------------------------------------

class JsonVLTrain(VLTrainDataset):
    """BLIP-format train JSON: [{'image', 'caption', 'image_id'}, ...]."""

    def __init__(self, ann_file: str, image_root: str, transform: Callable,
                 max_words: int = 30, prompt: str = ""):
        with open(ann_file) as f:
            self.annotation = json.load(f)
        self.transform = transform
        self.image_root = image_root
        self.max_words = max_words
        self.prompt = prompt
        self.img_ids: Dict[str, int] = {}
        n = 0
        for ann in self.annotation:
            img_id = ann["image_id"]
            if img_id not in self.img_ids:
                self.img_ids[img_id] = n
                n += 1

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        ann = self.annotation[index]
        img = _load_image(os.path.join(self.image_root, ann["image"]),
                          self.transform)
        caption = self.prompt + pre_caption(ann["caption"], self.max_words)
        return img, caption, self.img_ids[ann["image_id"]]

    def get_all_captions(self):
        return [self.prompt + pre_caption(a["caption"], self.max_words)
                for a in self.annotation]


class JsonVLEval(VLEvalDataset):
    """BLIP-format eval JSON: [{'image', 'caption': [5 strings]}, ...]."""

    def __init__(self, ann_file: str, image_root: str, transform: Callable,
                 max_words: int = 30):
        with open(ann_file) as f:
            self.annotation = json.load(f)
        self.transform = transform
        self.image_root = image_root
        self.text, self.image = [], []
        self.img2txt, self.txt2img = {}, {}
        txt_id = 0
        for img_id, ann in enumerate(self.annotation):
            self.image.append(ann["image"])
            self.img2txt[img_id] = []
            for caption in ann["caption"]:
                self.text.append(pre_caption(caption, max_words))
                self.img2txt[img_id].append(txt_id)
                self.txt2img[txt_id] = img_id
                txt_id += 1

    def __len__(self):
        return len(self.annotation)

    def __getitem__(self, index):
        img = _load_image(
            os.path.join(self.image_root, self.annotation[index]["image"]),
            self.transform)
        return img, index


FLICKR_ANN = {"train": "flickr30k_train.json", "val": "flickr30k_val.json",
              "test": "flickr30k_test.json"}
COCO_ANN = {"train": "coco_karpathy_train.json",
            "val": "coco_karpathy_val.json",
            "test": "coco_karpathy_test.json"}


# ---------------------------------------------------------------------------
# ROCOv2 radiology (CSV-driven)
# ---------------------------------------------------------------------------

class RocoTrain(VLTrainDataset):
    """CSV columns (id, name, caption); capped at ``max_images`` rows
    (data/rocov2Radiology_dataset.py:30-42)."""

    def __init__(self, csv_file: str, image_root: str, transform: Callable,
                 max_words: int = 30, max_images: int = 1000,
                 image_size: int = 224):
        import pandas as pd

        df = pd.read_csv(csv_file).head(max_images)
        self.names = df["name"].astype(str).tolist()
        self.captions = [pre_caption(str(c), max_words)
                         for c in df["caption"].tolist()]
        self.image_root = image_root
        self.transform = transform
        self.image_size = image_size

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index):
        img = _load_image(os.path.join(self.image_root, self.names[index]),
                          self.transform, fallback_black=True,
                          image_size=self.image_size)
        return img, self.captions[index], index

    def get_all_captions(self):
        return list(self.captions)


class RocoEval(VLEvalDataset):
    """Eval split capped at 100 rows, 1 caption per image
    (data/rocov2Radiology_dataset.py:77-109)."""

    def __init__(self, csv_file: str, image_root: str, transform: Callable,
                 max_words: int = 30, max_images: int = 100,
                 image_size: int = 224):
        import pandas as pd

        df = pd.read_csv(csv_file).head(max_images)
        self.image = df["name"].astype(str).tolist()
        self.text = [pre_caption(str(c), max_words)
                     for c in df["caption"].tolist()]
        self.img2txt = {i: [i] for i in range(len(self.image))}
        self.txt2img = {i: i for i in range(len(self.image))}
        self.image_root = image_root
        self.transform = transform
        self.image_size = image_size

    def __len__(self):
        return len(self.image)

    def __getitem__(self, index):
        img = _load_image(os.path.join(self.image_root, self.image[index]),
                          self.transform, fallback_black=True,
                          image_size=self.image_size)
        return img, index


# ---------------------------------------------------------------------------
# CIFAR10-as-VL (rebuilt working; reference file broken at HEAD)
# ---------------------------------------------------------------------------

CIFAR_CLASSES = ["airplane", "automobile", "bird", "cat", "deer", "dog",
                 "frog", "horse", "ship", "truck"]
CIFAR_PROMPTS = ["a photo of a {}", "a blurry photo of a {}",
                 "a black and white photo of a {}", "a low contrast photo of a {}",
                 "a high contrast photo of a {}"]


class CifarVLTrain(VLTrainDataset):
    def __init__(self, data_path: str, transform: Callable,
                 num_prompts: int = 1, train: bool = True):
        import torchvision

        ds = torchvision.datasets.CIFAR10(data_path, train=train,
                                          download=False)
        self.images = ds.data  # uint8 NHWC
        self.labels = list(ds.targets)
        self.transform = transform
        self.prompts = CIFAR_PROMPTS[:num_prompts]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index):
        img = self.transform(Image.fromarray(self.images[index]))
        prompt = self.prompts[index % len(self.prompts)]
        caption = pre_caption(prompt.format(CIFAR_CLASSES[self.labels[index]]),
                              30)
        return img, caption, index

    def get_all_captions(self):
        return [pre_caption(self.prompts[i % len(self.prompts)].format(
            CIFAR_CLASSES[self.labels[i]]), 30) for i in range(len(self))]

    def fetch_distill_images(self, ipc: int) -> np.ndarray:
        """Per-class sampling (data/cifar_dataset.py:84-108)."""
        out = []
        labels = np.asarray(self.labels)
        for c in range(10):
            idx = np.where(labels == c)[0][:ipc]
            out.extend(self.transform(Image.fromarray(self.images[i]))
                       for i in idx)
        return np.stack(out)


class CifarVLEval(VLEvalDataset):
    def __init__(self, data_path: str, transform: Callable,
                 max_images: int = 1000):
        import torchvision

        ds = torchvision.datasets.CIFAR10(data_path, train=False,
                                          download=False)
        self.images_arr = ds.data[:max_images]
        labels = list(ds.targets)[:max_images]
        self.transform = transform
        self.image = [str(i) for i in range(len(self.images_arr))]
        self.text = [pre_caption(f"a photo of a {CIFAR_CLASSES[l]}", 30)
                     for l in labels]
        self.img2txt = {i: [i] for i in range(len(self.image))}
        self.txt2img = {i: i for i in range(len(self.image))}

    def __len__(self):
        return len(self.image)

    def __getitem__(self, index):
        return self.transform(Image.fromarray(self.images_arr[index])), index


# ---------------------------------------------------------------------------
# Synthetic offline dataset (tests / CI / air-gapped benches)
# ---------------------------------------------------------------------------

_COLORS = {
    "red": (220, 40, 40), "blue": (40, 70, 220), "green": (40, 180, 70),
    "yellow": (230, 210, 40), "purple": (150, 50, 200),
    "orange": (240, 140, 30), "white": (240, 240, 240), "black": (20, 20, 20),
}
_BGS = {"gray": (128, 128, 128), "dark": (50, 50, 60),
        "light": (210, 210, 200), "teal": (40, 140, 140)}
_SHAPES = ("square", "circle", "stripe", "cross")
_CAPTION_TEMPLATES = (
    "a {c} {s} on a {b} background",
    "the {c} {s} over {b}",
    "one {c} {s} against a {b} backdrop",
    "photo of a {c} {s} with {b} behind",
    "{c} colored {s} on {b}",
)


def _draw_fake_image(rng: np.random.RandomState, size: int,
                     color: str, shape: str, bg: str) -> Image.Image:
    """Image whose content MATCHES its caption (color/shape/background),
    so the bi-encoder has real signal to learn — the previous generator
    paired random pixels with random words (zero mutual information),
    which made every retrieval metric chance-level by construction."""
    arr = np.zeros((size, size, 3), np.float32)
    arr[:] = _BGS[bg]
    arr += rng.randn(size, size, 3) * 8.0  # mild texture noise
    c = np.array(_COLORS[color], np.float32)
    s = size
    cx = rng.randint(s // 4, 3 * s // 4)
    cy = rng.randint(s // 4, 3 * s // 4)
    r = rng.randint(s // 6, s // 3)
    yy, xx = np.mgrid[0:s, 0:s]
    if shape == "square":
        mask = (abs(xx - cx) < r) & (abs(yy - cy) < r)
    elif shape == "circle":
        mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
    elif shape == "stripe":
        mask = abs(xx - cx) < max(2, r // 3)
    else:  # cross
        mask = (abs(xx - cx) < max(2, r // 4)) | (abs(yy - cy) < max(2, r // 4))
    arr[mask] = c + rng.randn(int(mask.sum()), 3) * 5.0
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def _sample_concept(rng: np.random.RandomState):
    color = list(_COLORS)[rng.randint(len(_COLORS))]
    shape = _SHAPES[rng.randint(len(_SHAPES))]
    bg = list(_BGS)[rng.randint(len(_BGS))]
    return color, shape, bg


def _caption_for(rng: np.random.RandomState, color, shape, bg) -> str:
    t = _CAPTION_TEMPLATES[rng.randint(len(_CAPTION_TEMPLATES))]
    return pre_caption(t.format(c=color, s=shape, b=bg), 30)


class SyntheticVLTrain(VLTrainDataset):
    def __init__(self, n: int, transform: Callable, image_size: int = 64,
                 seed: int = 0):
        self.transform = transform
        self.image_size = image_size
        rng = np.random.RandomState(seed)
        self._imgs, self._caps = [], []
        for _ in range(n):
            color, shape, bg = _sample_concept(rng)
            self._imgs.append(_draw_fake_image(rng, image_size, color,
                                               shape, bg))
            self._caps.append(_caption_for(rng, color, shape, bg))

    def __len__(self):
        return len(self._imgs)

    def __getitem__(self, index):
        return (self.transform(self._imgs[index]), self._caps[index], index)

    def get_all_captions(self):
        return list(self._caps)


class SyntheticVLEval(VLEvalDataset):
    def __init__(self, n: int, transform: Callable, image_size: int = 64,
                 captions_per_image: int = 5, seed: int = 1):
        self.transform = transform
        rng = np.random.RandomState(seed)
        self._imgs = []
        self.image = [str(i) for i in range(n)]
        self.text, self.img2txt, self.txt2img = [], {}, {}
        t = 0
        for i in range(n):
            color, shape, bg = _sample_concept(rng)
            self._imgs.append(_draw_fake_image(rng, image_size, color,
                                               shape, bg))
            self.img2txt[i] = []
            for _ in range(captions_per_image):
                self.text.append(_caption_for(rng, color, shape, bg))
                self.img2txt[i].append(t)
                self.txt2img[t] = i
                t += 1

    def __len__(self):
        return len(self._imgs)

    def __getitem__(self, index):
        return self.transform(self._imgs[index]), index
