"""The port's DSA suite, legacy augment and LR schedules against the JAX
package's (``ops/diffaug.py``, ``ops/legacy_augment.py``,
``utils/schedules.py``), mirroring
``tests/test_diffaug.py``.

JAX's random draws cannot be made by torch, so each port op is fed the
JAX op's own uniforms (``_per_batch`` on the keys the JAX op splits) and
its output and pixel gradient are held against the JAX op's in float32
at 1e-5.  The host-side legacy augment draws from numpy and is held
exactly on the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.ops import diffaug as jdiffaug
from multimodal_dataset_distillation_tpu.ops import legacy_augment as jlegacy
from multimodal_dataset_distillation_tpu.utils import schedules as jsched
from multimodal_dataset_distillation_tpu_torch.ops import diffaug
from multimodal_dataset_distillation_tpu_torch.ops import legacy_augment
from multimodal_dataset_distillation_tpu_torch.utils import schedules
from test_torch_threads import share_cores  # noqa: F401 (autouse)

NAMES = list(diffaug.OPS)
SHAPE = (3, 12, 16, 3)   # H != W, so a swapped axis shows


def _x(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_draws(name, key, batch_shared, n):
    """The uniforms the JAX ``rand_<name>`` draws from ``key``: one
    ``_per_batch`` on the key itself, or one on each half of its split."""
    k = diffaug.OPS[name][0]
    keys = [key] if k == 1 else list(jax.random.split(key))
    return np.stack([np.asarray(jdiffaug._per_batch(kk, batch_shared, n))
                     for kk in keys])


@pytest.mark.parametrize("batch_shared", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_apply_matches_jax_on_its_draws(name, batch_shared):
    x = _x()
    key = jax.random.PRNGKey(NAMES.index(name) + 11)
    jop = getattr(jdiffaug, f"rand_{name}")
    want = np.asarray(jop(jnp.asarray(x), key, jdiffaug.ParamDiffAug(),
                          batch_shared))
    u = torch.from_numpy(_jax_draws(name, key, batch_shared, x.shape[0]))
    got = getattr(diffaug, f"apply_{name}")(
        torch.from_numpy(x), u, diffaug.ParamDiffAug())
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_pixel_gradient_matches_jax(name):
    """Gradients flow to the pixels, equal to JAX's on the same draws."""
    x = _x(1)
    key = jax.random.PRNGKey(3)
    jop = getattr(jdiffaug, f"rand_{name}")
    want = np.asarray(jax.grad(lambda v: jnp.sum(jop(
        v, key, jdiffaug.ParamDiffAug(), False) ** 2))(jnp.asarray(x)))
    u = torch.from_numpy(_jax_draws(name, key, False, x.shape[0]))
    xt = torch.from_numpy(x).requires_grad_()
    apply = getattr(diffaug, f"apply_{name}")
    (apply(xt, u, diffaug.ParamDiffAug()) ** 2).sum().backward()
    assert torch.isfinite(xt.grad).all() and xt.grad.abs().sum() > 0
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_batch_shared_is_one_transform(name):
    """``batch_shared``: identical inputs give identical outputs, and the
    draws are one value repeated over the batch."""
    x = torch.from_numpy(np.repeat(_x(2, (1, 8, 8, 3)), 4, axis=0))
    gen = torch.Generator().manual_seed(5)
    y = getattr(diffaug, f"rand_{name}")(x, gen, diffaug.ParamDiffAug(),
                                         True)
    for i in range(1, 4):
        np.testing.assert_allclose(y[0].numpy(), y[i].numpy(), rtol=1e-6)
    u = diffaug.uniforms(2, 4, torch.Generator().manual_seed(5), True)
    assert (u == u[:, :1]).all()


def test_rand_ops_draw_from_the_generator():
    """``rand_<name>`` is ``apply_<name>`` on the generator's next
    uniforms; the same seed gives the same output."""
    x = torch.from_numpy(_x(3))
    p = diffaug.ParamDiffAug()
    for name in NAMES:
        y = getattr(diffaug, f"rand_{name}")(
            x, torch.Generator().manual_seed(9), p, False)
        u = torch.rand((diffaug.OPS[name][0], x.shape[0]),
                       generator=torch.Generator().manual_seed(9))
        torch.testing.assert_close(
            y, getattr(diffaug, f"apply_{name}")(x, u, p), rtol=0, atol=0)


def _replay(x, families, seed, p, skip_pick):
    """The ops of ``families`` in order, on draws replayed from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if skip_pick:
        torch.randint(1, (1,), generator=gen)
    for family in families:
        for name in diffaug.AUGMENT_FNS[family]:
            k, apply = diffaug.OPS[name]
            x = apply(x, diffaug.uniforms(k, x.shape[0], gen, False), p)
    return x


def test_strategy_dispatch_modes():
    x = torch.from_numpy(_x(4))
    strat = "color_crop_cutout_flip_scale_rotate"
    names = strat.split("_")
    pm = diffaug.ParamDiffAug(aug_mode="M")
    y_m = diffaug.diff_augment(x, strat, torch.Generator().manual_seed(0), pm)
    torch.testing.assert_close(y_m, _replay(x, names, 0, pm, False),
                               rtol=0, atol=0)
    ps = diffaug.ParamDiffAug()
    picks = set()
    for seed in range(12):
        pick = int(torch.randint(len(names), (1,),
                                 generator=torch.Generator().manual_seed(seed)))
        picks.add(pick)
        y_s = diffaug.DiffAugment(x, strat,
                                  torch.Generator().manual_seed(seed), ps)
        assert y_s.shape == x.shape
        torch.testing.assert_close(
            y_s, _replay(x, [names[pick]], seed, ps, True), rtol=0, atol=0)
    assert len(picks) > 2
    torch.testing.assert_close(diffaug.diff_augment(x, "none"), x)
    with pytest.raises(ValueError, match="aug_mode"):
        diffaug.diff_augment(x, strat, None, diffaug.ParamDiffAug(aug_mode="X"))


def test_param_defaults_match_jax():
    assert (jdiffaug.ParamDiffAug().__dict__
            == diffaug.ParamDiffAug().__dict__)
    assert set(jdiffaug.AUGMENT_FNS) == set(diffaug.AUGMENT_FNS)
    for family, fns in jdiffaug.AUGMENT_FNS.items():
        assert [f.__name__ for f in fns] == [
            f"rand_{n}" for n in diffaug.AUGMENT_FNS[family]]


def test_flip_semantics():
    x = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(2, 4, 4, 1)
    p = diffaug.ParamDiffAug(prob_flip=1.1)  # always flip
    torch.testing.assert_close(diffaug.rand_flip(x, None, p, False),
                               x.flip(2), rtol=0, atol=0)
    p.prob_flip = -0.1  # never
    torch.testing.assert_close(diffaug.rand_flip(x, None, p, False), x,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dataset,model_eval", [
    ("MNIST", "ConvNet"), ("CIFAR10", "ConvNetBN"), ("CIFAR10", "ConvNet")])
def test_legacy_augment_matches_jax(dataset, model_eval):
    p = legacy_augment.get_daparam(dataset, "ConvNet", model_eval, 1)
    assert p == jlegacy.get_daparam(dataset, "ConvNet", model_eval, 1)
    x = _x(5, (6, 16, 16, 3))
    got = legacy_augment.augment(x, p, np.random.RandomState(0))
    want = jlegacy.augment(x, p, np.random.RandomState(0))
    np.testing.assert_array_equal(got, want)
    if p["strategy"] != "none":
        assert not np.allclose(got, x)
    np.testing.assert_array_equal(
        legacy_augment.augment(x, {"strategy": "none"}), x)


def test_schedules_match_jax():
    for e in range(12):
        assert (schedules.cosine_lr_schedule(e, 10, 1.0, 0.1)
                == jsched.cosine_lr_schedule(e, 10, 1.0, 0.1))
        assert (schedules.warmup_lr_schedule(e, 7, 0.01, 1.0)
                == jsched.warmup_lr_schedule(e, 7, 0.01, 1.0))
        assert (schedules.step_lr_schedule(e, 1.0, 0.01, 0.5)
                == jsched.step_lr_schedule(e, 1.0, 0.01, 0.5))
    assert schedules.warmup_lr_schedule(3, 0, 0.0, 1.0) == 1.0
