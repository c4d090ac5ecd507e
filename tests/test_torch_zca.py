"""Port parity: ZCA whitening (``ops/zca.py``) and the ZCA artifacts of
``utils/visualize.py`` against the JAX package's.

The fit (mean, whitening and de-whitening matrices), the transform and its
inverse on seeded numpy images, 1e-6 relative; the round trip; the
whitened features' identity covariance.  ``save_visualizations`` with a
fitted ZCA writes the JAX package's file names, and ``images_zca_{it}.pt``
holds the JAX package's de-whitened NCHW images.
"""

import os

import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.ops import zca as jzca
from multimodal_dataset_distillation_tpu.utils import visualize as jvis
from multimodal_dataset_distillation_tpu_torch.ops import zca
from multimodal_dataset_distillation_tpu_torch.utils import visualize

from test_torch_threads import share_cores  # noqa: F401 (autouse)


def _images(n=64, hw=4, seed=0):
    rs = np.random.RandomState(seed)
    base = rs.randn(n, hw, hw, 3) + 0.5 * rs.randn(n, 1, 1, 3)
    return base.astype(np.float32)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("eps", [0.1, 1e-3])
def test_fit_matches_jax(eps):
    x = _images()
    got, want = zca.ZCAWhitening(eps).fit(x), jzca.ZCAWhitening(eps).fit(x)
    for k in ("mean", "whiten", "dewhiten"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == np.float64 and a.shape == b.shape
        assert _rel(a, b) < 1e-6, k


def test_transform_and_inverse_match_jax():
    x, y = _images(), _images(8, seed=1)
    got, want = zca.ZCAWhitening().fit(x), jzca.ZCAWhitening().fit(x)
    w = got.transform(y)
    assert w.dtype == np.float32 and w.shape == y.shape
    assert _rel(w, want.transform(y)) < 1e-6
    back = got.inverse_transform(w)
    assert _rel(back, want.inverse_transform(w)) < 1e-6
    assert _rel(back, y) < 1e-5


def test_whitened_covariance_is_near_identity():
    """With a small eps the whitened training features are decorrelated
    and of unit variance (the reference's kornia ZCA)."""
    x = _images(256)
    w = zca.ZCAWhitening(eps=1e-6).fit(x).transform(x).reshape(256, -1)
    cov = np.cov(w.astype(np.float64), rowvar=False)
    np.testing.assert_allclose(cov, np.eye(cov.shape[0]), atol=1e-3)


def test_zca_artifacts_match_jax(tmp_path):
    """The ZCA grids and ``images_zca_{it}.pt`` under ``--save_pt``: the
    JAX package's names and de-whitened values."""
    x = _images()
    fitted = zca.ZCAWhitening().fit(x)
    rs = np.random.RandomState(2)
    img = fitted.transform(_images(4, seed=3))
    txt = rs.randn(4, 16).astype(np.float32)
    embed = rs.randn(5, 16).astype(np.float32)
    sents = [f"s{i}" for i in range(5)]
    arts = visualize.save_visualizations(str(tmp_path / "p"), 7, img, txt,
                                         sents, embed, save_pt=True,
                                         zca=fitted)
    jarts = jvis.save_visualizations(str(tmp_path / "j"), 7, img, txt, sents,
                                     embed, save_pt=True,
                                     zca=jzca.ZCAWhitening().fit(x))
    assert set(arts) == set(jarts)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))
    for name in ("zca_synthetic_images_7.png",
                 "clipped_zca_synthetic_images_7_std_2.5.png",
                 "images_zca_7.pt"):
        assert (tmp_path / "p" / name).exists()
    got = torch.load(arts["images_zca_pt"], weights_only=True).numpy()
    want = torch.load(jarts["images_zca_pt"], weights_only=True).numpy()
    assert got.shape == (4, 3, 4, 4)
    assert _rel(got, want) < 1e-6
    # without a ZCA nothing of it is written
    plain = visualize.save_visualizations(str(tmp_path / "n"), 7, img, txt,
                                          sents, embed, save_pt=True)
    assert not any(k.startswith(("zca", "images_zca")) for k in plain)
