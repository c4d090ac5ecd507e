"""Port parity: the C++ decode pool and the ``native_decode`` train
transform against the JAX package's.

The port's copy of ``fastimage.cpp`` is built here with ``g++`` into
``build/native/``; both packages' libraries decode the same JPEGs (written
with PIL from seeded numpy pixels) to the same bytes, and the two
``make_train_transform_native`` give the same pixels under the same
``augrng.seed_item`` seed (both sides run the same C++, PIL and numpy code
on the same inputs, so equality is exact).

The JAX package builds its library into one fixed temporary name and
remembers a failed load for the life of the process, so pytest-xdist
workers that build it at once (each collects ``tests/test_fastimage.py``,
whose module-level ``skipif`` loads it) can leave some of them without it.
The comparisons here take it through the ``jax_fastimage`` fixture
(:func:`load_jax_fastimage`), which repairs that under a file lock; if
the library still does not load, they fail.
"""

import ctypes
import fcntl
import io
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from multimodal_dataset_distillation_tpu import native as jnative
from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.data import create_dataset as jcreate
from multimodal_dataset_distillation_tpu.data import transforms as jtransforms
from multimodal_dataset_distillation_tpu.utils import augrng as jaugrng
from multimodal_dataset_distillation_tpu_torch import native
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data import create_dataset
from multimodal_dataset_distillation_tpu_torch.data import transforms
from multimodal_dataset_distillation_tpu_torch.utils import augrng
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE = 32
ROOT = Path(__file__).resolve().parents[1]


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def load_jax_fastimage():
    """The JAX package's ``fastimage`` library in this process.  Where
    ``jnative.get_fastimage()`` gives ``None`` or raises ``OSError`` (a
    sibling process's build lost the race on its fixed temporary name),
    then under a lock in the gitignored ``build/``: a missing or unloadable
    ``_fastimage.so`` is rebuilt from the package's ``fastimage.cpp`` to a
    unique temporary name and moved into place, and the package's
    remembered failure (``_tried``, ``_lib``) is cleared before it loads
    again.  -> the library, or ``None`` if it never loads."""
    try:
        lib = jnative.get_fastimage()
    except OSError:
        lib = None
    if lib is not None:
        return lib
    (ROOT / "build").mkdir(exist_ok=True)
    with open(ROOT / "build" / "jax_fastimage.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(3):
            if not _loads(jnative._SO):
                fd, tmp = tempfile.mkstemp(suffix=".so",
                                           dir=os.path.dirname(jnative._SO))
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                         jnative._SRC, "-ljpeg", "-o", tmp],
                        check=True, capture_output=True, timeout=300)
                    os.replace(tmp, jnative._SO)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            with jnative._lock:
                jnative._tried, jnative._lib = False, None
            try:
                lib = jnative.get_fastimage()
            except OSError:
                lib = None
            if lib is not None:
                return lib
    return None


@pytest.fixture(scope="module")
def jax_fastimage():
    lib = load_jax_fastimage()
    assert lib is not None, ("g++ and libjpeg are present: the JAX "
                             "package's library must load")
    return lib


def _encoded(w, h, seed, fmt="JPEG"):
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 255, (6, 8, 3), np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def test_fastimage_builds_into_build_dir():
    lib = native.get_fastimage()
    assert lib is not None, "g++ and libjpeg are present: the build must work"
    root = Path(native.__file__).resolve().parents[2]
    assert (root / "build" / "native" / "_fastimage.so").is_file()
    assert native.get_fastimage() is lib  # built and loaded once


@pytest.mark.parametrize("w,h", [(320, 240), (97, 203), (40, 40)])
def test_decode_batch_same_bytes_as_jax(w, h, jax_fastimage):
    data = _encoded(w, h, seed=w)
    assert native.is_jpeg(data) and native.read_dims(data) == (w, h)
    assert native.read_dims(data) == jnative.read_dims(data)
    rng = np.random.RandomState(h)
    items = []
    for _ in range(6):
        cw, ch = rng.randint(8, w + 1), rng.randint(8, h + 1)
        items.append((data, (rng.randint(0, w - cw + 1),
                             rng.randint(0, h - ch + 1), cw, ch),
                      bool(rng.randint(2))))
    items.append((data, (0, 0, 0, 0), False))  # 0 = the whole image
    got, failed = native.decode_batch(items, SIZE, n_threads=3)
    want, jfailed = jnative.decode_batch(items, SIZE, n_threads=2)
    assert failed == jfailed == []
    assert got.dtype == np.uint8 and got.shape == (len(items), SIZE, SIZE, 3)
    assert got.tobytes() == want.tobytes()


def test_bad_input_is_reported():
    assert not native.is_jpeg(b"\x89PNG....") and native.read_dims(b"xx") is None
    good = _encoded(64, 48, seed=1)
    bad = good[:20] + b"\x00" * 40  # a header, then garbage
    out, failed = native.decode_batch([(good, (0, 0, 64, 48), False),
                                       (bad, (0, 0, 64, 48), False)], 16)
    assert failed == [1] and out[0].any() and not out[1].any()


@pytest.mark.parametrize("item,kind", [(0, "jpeg"), (1, "jpeg"), (2, "png"),
                                       (3, "pil")])
def test_native_transform_same_pixels_as_jax(item, kind, jax_fastimage):
    """JPEG bytes take the C++ pool; PNG bytes and PIL images take the PIL
    path; each equals the JAX package's transform under one seed."""
    data = _encoded(120 + 7 * item, 90, seed=item,
                    fmt="PNG" if kind == "png" else "JPEG")
    if kind == "pil":
        data = Image.open(io.BytesIO(data)).convert("RGB")
    out = []
    for mod, rng in ((transforms, augrng), (jtransforms, jaugrng)):
        t = mod.make_train_transform_native(SIZE)
        assert t.accepts_bytes
        rng.seed_item(4, 1, item)
        try:
            out.append(t(data))
        finally:
            rng.clear()
    assert out[0].dtype == np.float32 and out[0].shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(out[0], out[1])


def test_native_decode_is_the_default_train_transform(jax_fastimage):
    """``native_decode`` (the Config default) installs the C++ pool's
    transform: a train item equals the JAX package's under one seed."""
    kw = dict(dataset="synthetic", image_size=SIZE, synthetic_size=3,
              synthetic_test_size=2, seed=3)
    assert Config().native_decode and JConfig().native_decode
    train, _, _ = create_dataset(Config(**kw))
    jtrain, _, _ = jcreate(JConfig(**kw))
    assert train.transform.accepts_bytes
    for i in range(3):
        augrng.seed_item(9, i)
        jaugrng.seed_item(9, i)
        try:
            got, want = train[i], jtrain[i]
        finally:
            augrng.clear()
            jaugrng.clear()
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
