"""Port parity: the data side of the eval path against the JAX package.

Captions byte for byte, transforms and datasets pixel for pixel (both
sides run the same PIL and numpy code on the same inputs, so equality is
exact), loaders batch for batch over two epochs, on the synthetic dataset
and on ``tools/make_fixtures.py`` fixtures in the reference formats.
"""

import numpy as np
import pytest
from PIL import Image

from multimodal_dataset_distillation_tpu import data as jdata
from multimodal_dataset_distillation_tpu.data import caption as jcaption
from multimodal_dataset_distillation_tpu.data import datasets as jdatasets
from multimodal_dataset_distillation_tpu.data import pipeline as jpipeline
from multimodal_dataset_distillation_tpu.data import transforms as jtransforms
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.ops import randaugment as jra
from multimodal_dataset_distillation_tpu.utils import augrng as jaugrng
from multimodal_dataset_distillation_tpu_torch import data as tdata
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data import caption as tcaption
from multimodal_dataset_distillation_tpu_torch.data import datasets as tdatasets
from multimodal_dataset_distillation_tpu_torch.data import pipeline as tpipeline
from multimodal_dataset_distillation_tpu_torch.data import transforms as ttransforms
from multimodal_dataset_distillation_tpu_torch.ops import randaugment as tra
from multimodal_dataset_distillation_tpu_torch.utils import augrng as taugrng
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE = 32
HARD = [
    'A man (left) says: "Hi!"', "  Hello World.\n", "a~b#c",
    "red, blue? high-contrast", "Two  dogs...  run;  fast!!\n\n",
    "UPPER*case* (with) [brackets] and {braces}", "tab\tseparated\twords",
    "ünïcödé Café — naïve résumé!", "", "   ", "...", "\n",
    " ".join(str(i) for i in range(50)),
    "multiple\n\nnewlines\n inside. ",
]


@pytest.mark.parametrize("text", HARD)
def test_pre_caption_same_bytes(text):
    for max_words in (30, 5, 50):
        got = tcaption.pre_caption(text, max_words)
        assert got.encode() == jcaption.pre_caption(text, max_words).encode()
    assert tcaption.pre_question(text) == jcaption.pre_question(text)


def _image(seed=0, size=48):
    rs = np.random.RandomState(seed)
    return Image.fromarray(rs.randint(0, 256, (size, size + 8, 3),
                                      dtype=np.uint8))


@pytest.mark.parametrize("op", sorted(jra.OPS))
def test_randaugment_op_same_pixels(op):
    img = _image(1)
    jaugrng.seed_item(5, 1, 2)
    taugrng.seed_item(5, 1, 2)
    try:
        want = np.asarray(jra.OPS[op](img, 5))
        got = np.asarray(tra.OPS[op](img, 5))
    finally:
        jaugrng.clear()
        taugrng.clear()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("item", [0, 1, 7])
def test_transforms_same_pixels(item):
    img = _image(item)
    np.testing.assert_array_equal(ttransforms.make_test_transform(SIZE)(img),
                                  jtransforms.make_test_transform(SIZE)(img))
    jaugrng.seed_item(3, 2, item)
    taugrng.seed_item(3, 2, item)
    try:
        want = jtransforms.make_train_transform(SIZE)(img)
        got = ttransforms.make_train_transform(SIZE)(img)
    finally:
        jaugrng.clear()
        taugrng.clear()
    np.testing.assert_array_equal(got, want)
    x = np.random.RandomState(item).randn(4, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(ttransforms.denormalize(x),
                                  jtransforms.denormalize(x))
    np.testing.assert_array_equal(ttransforms.CLIP_MEAN, jtransforms.CLIP_MEAN)
    np.testing.assert_array_equal(ttransforms.CLIP_STD, jtransforms.CLIP_STD)


def _same_eval(a, b):
    assert (a.text, a.image, a.img2txt, a.txt2img) == (
        b.text, b.image, b.img2txt, b.txt2img)
    assert len(a) == len(b)
    for i in range(len(a)):
        (xa, ia), (xb, ib) = a[i], b[i]
        assert ia == ib
        np.testing.assert_array_equal(xa, xb)


def test_synthetic_datasets_same():
    t_test, j_test = (ttransforms.make_test_transform(SIZE),
                      jtransforms.make_test_transform(SIZE))
    _same_eval(tdatasets.SyntheticVLEval(6, t_test, SIZE, seed=3),
               jdatasets.SyntheticVLEval(6, j_test, SIZE, seed=3))
    a = tdatasets.SyntheticVLTrain(5, t_test, SIZE, seed=4)
    b = jdatasets.SyntheticVLTrain(5, j_test, SIZE, seed=4)
    assert a.get_all_captions() == b.get_all_captions()
    for i in range(len(a)):
        (xa, ca, ia), (xb, cb, ib) = a[i], b[i]
        assert (ca, ia) == (cb, ib)
        np.testing.assert_array_equal(xa, xb)


def _batches(loader, epochs=2):
    return [[b for b in loader] for _ in range(epochs)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for bg, bw in zip(eg, ew):
            assert len(bg) == len(bw)
            for cg, cw in zip(bg, bw):
                if isinstance(cw, list):
                    assert cg == cw
                else:
                    np.testing.assert_array_equal(cg, cw)


@pytest.mark.parametrize("shuffle,drop_last,workers", [
    (True, True, 3), (True, False, 1), (False, False, 2)])
def test_seeded_loader_same_batches(shuffle, drop_last, workers):
    """Seeded loaders over the augmenting train transform: the same
    per-item augmentation draws, the same order, two epochs."""
    ta = tdatasets.SyntheticVLTrain(7, ttransforms.make_train_transform(SIZE),
                                    SIZE, seed=1)
    ja = jdatasets.SyntheticVLTrain(7, jtransforms.make_train_transform(SIZE),
                                    SIZE, seed=1)
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=11)
    got = _batches(tpipeline.Loader(ta, num_workers=workers, **kw))
    want = _batches(jpipeline.Loader(ja, num_workers=2, **kw))
    _assert_same_batches(got, want)
    assert len(tpipeline.Loader(ta, **kw)) == len(jpipeline.Loader(ja, **kw))


@pytest.mark.parametrize("batch_size,seed", [(4, 0), (3, 5), (16, 2)])
def test_array_pair_loader_same_batches(batch_size, seed):
    rs = np.random.RandomState(seed)
    images = rs.randn(10, 4, 4, 3).astype(np.float32)
    texts = rs.randn(10, 6).astype(np.float32)
    kw = dict(batch_size=batch_size, shuffle=True, seed=seed)
    _assert_same_batches(
        _batches(tpipeline.ArrayPairLoader(images, texts, **kw)),
        _batches(jpipeline.ArrayPairLoader(images, texts, **kw)))


def test_create_dataset_synthetic_same():
    kw = dict(dataset="synthetic", image_size=SIZE, synthetic_size=4,
              synthetic_test_size=3, seed=2, native_decode=False,
              batch_size_test=2, batch_size_train=2, num_workers=2)
    t_loaders = tdata.get_dataset(Config(**kw))
    j_loaders = jdata.get_dataset(JConfig(**kw))
    _same_eval(t_loaders[3], j_loaders[3])
    _assert_same_batches(_batches(t_loaders[1]), _batches(j_loaders[1]))
    _assert_same_batches(_batches(t_loaders[0]), _batches(j_loaders[0]))


def _encoded(item, fmt):
    import io
    buf = io.BytesIO()
    Image.fromarray(np.asarray(_image(item).resize((40, 28)))).save(
        buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("mode", [dict(device_augment=True),
                                  dict(device_augment=True,
                                       native_decode=False)])
def test_unported_train_transform_raises(mode):
    """``device_augment`` installs the raw-crop train transform, with
    ``native_decode`` (the default) on or off, as the JAX ``create_dataset``
    does: the same float32 [0, 255] crops as JAX ``make_train_transform_raw``
    on the same seeded items, from the synthetic split's PIL images and
    from JPEG (the C++ pool) and PNG (PIL) bytes; the eval split keeps the
    test transform.  (Named from when this transform raised; ``native_decode``
    alone: tests/test_torch_native.py.)"""
    kw = dict(dataset="synthetic", image_size=SIZE, synthetic_size=3,
              synthetic_test_size=2, **mode)
    train, _, test = tdata.create_dataset(Config(**kw))
    jtrain, _, jtest = jdata.create_dataset(JConfig(**kw))
    np.testing.assert_array_equal(test[0][0], jtest[0][0])
    raw, jraw = (m.make_train_transform_raw(SIZE)
                 for m in (ttransforms, jtransforms))
    cases = [(lambda i: train[i][0], lambda i: jtrain[i][0], i)
             for i in range(3)]
    cases += [(lambda i, f=f: raw(_encoded(i, f)),
               lambda i, f=f: jraw(_encoded(i, f)), i)
              for f in ("JPEG", "PNG") for i in (0, 1)]
    for got_fn, want_fn, i in cases:
        taugrng.seed_item(5, 1, i)
        jaugrng.seed_item(5, 1, i)
        try:
            got, want = got_fn(i), want_fn(i)
        finally:
            taugrng.clear()
            jaugrng.clear()
        assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.float32
        assert 0.0 <= got.min() and got.max() <= 255.0
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import make_fixtures
    root = tmp_path_factory.mktemp("fixtures")
    make_fixtures.make_coco(str(root / "coco"), n_train=4, n_test=3)
    make_fixtures.make_roco(str(root / "roco"), n_rows=5)
    return root


def test_json_vl_datasets_same(fixtures):
    ann = fixtures / "coco" / "ann"
    img_root = str(fixtures / "coco" / "images")
    t_test, j_test = (ttransforms.make_test_transform(SIZE),
                      jtransforms.make_test_transform(SIZE))
    _same_eval(
        tdatasets.JsonVLEval(str(ann / "coco_karpathy_test.json"), img_root,
                             t_test),
        jdatasets.JsonVLEval(str(ann / "coco_karpathy_test.json"), img_root,
                             j_test))
    a = tdatasets.JsonVLTrain(str(ann / "coco_karpathy_train.json"), img_root,
                              t_test)
    b = jdatasets.JsonVLTrain(str(ann / "coco_karpathy_train.json"), img_root,
                              j_test)
    assert a.get_all_captions() == b.get_all_captions()
    for i in range(len(a)):
        (xa, ca, ia), (xb, cb, ib) = a[i], b[i]
        assert (ca, ia) == (cb, ib)
        np.testing.assert_array_equal(xa, xb)


def test_roco_datasets_same_with_black_fallback(fixtures):
    """ROCO rows 1 (corrupt JPEG) and 2 (missing file) fall back to a black
    image in both packages."""
    pytest.importorskip("pandas")
    csv = str(fixtures / "roco" / "radiologytraindata.csv")
    img_root = str(fixtures / "roco" / "images")
    t_test, j_test = (ttransforms.make_test_transform(SIZE),
                      jtransforms.make_test_transform(SIZE))
    a = tdatasets.RocoEval(csv, img_root, t_test, image_size=SIZE)
    _same_eval(a, jdatasets.RocoEval(csv, img_root, j_test, image_size=SIZE))
    black = ttransforms.make_test_transform(SIZE)(
        Image.new("RGB", (SIZE, SIZE)))
    np.testing.assert_array_equal(a[2][0], black)
    ta = tdatasets.RocoTrain(csv, img_root, t_test, image_size=SIZE)
    ja = jdatasets.RocoTrain(csv, img_root, j_test, image_size=SIZE)
    assert ta.get_all_captions() == ja.get_all_captions()
    np.testing.assert_array_equal(ta[1][0], ja[1][0])
