"""Port parity: ``ops/randaugment_device.py`` (the in-step augment of
``--device_augment``) against the JAX package's module, on the CPU.

Seeded images in [0, 255] (uniform, a low-contrast one, and one with a
constant channel, so that equalize's step-0 rule and autocontrast's flat
channel are reached).  Each op at levels 0, 3, 5, 8 and 10; the geometric
ops' sign is the one the JAX op draws from ``bernoulli(key)``, handed to
the port, and the keys are chosen so both signs occur.  Tolerances:
autocontrast, equalize, posterize and solarize exact (the same float32 or
integer operations); the blends 1e-4 absolute (means summed in another
order); the affine ops 1e-3 absolute on the [0, 255] scale (the sampling
grid and weights in another order).

``random_augment_device`` is held through its plan: the JAX key is split
as the JAX function splits it (per image, per round, into ``kop, kp,
kparam``), the plan rebuilt from ``randint`` / ``bernoulli`` and given to
``apply_augment_plan``; 1e-3 absolute on every image, with one exception.
An equalize after a resampling op truncates the resampled values, and
those sit within an ulp of an integer wherever the resample lands on a
pixel or in the 128 fill: 128 - 2^-17 on one side and 128 on the other
move a pixel one histogram bin, and the LUT by several levels.  The JAX
module is not consistent with itself there (its op eager and under
``jit`` land on either side, as XLA folds the sampling arithmetic
differently), so an image whose plan holds that chain is held round by
round instead: each round against the JAX ops on the same input, at the
same 1e-3.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.ops import randaugment_device as jra
from multimodal_dataset_distillation_tpu_torch.ops import (
    randaugment_device as pra,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

LEVELS = (0, 3, 5, 8, 10)
EXACT = ("identity", "autocontrast", "equalize", "posterize", "solarize")
BLENDS = ("color", "contrast", "brightness", "sharpness")
AFFINE = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")
OPS = EXACT + BLENDS + AFFINE
TOL = {**{k: 0.0 for k in EXACT}, **{k: 1e-4 for k in BLENDS},
       **{k: 1e-3 for k in AFFINE}}


def _images(b=6, h=20, w=24, seed=0, rounded=(3,)):
    """Uniform images, one of low contrast, one with a constant channel;
    the images ``rounded`` integer valued."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    x[1] = rs.uniform(100, 140, (h, w, 3))
    x[2, ..., 1] = 77.0
    for i in rounded:
        x[i] = np.round(x[i])
    return x


def _keys(b, seed):
    return jax.random.split(jax.random.PRNGKey(seed), b)


@functools.lru_cache(maxsize=None)
def _jax_batched(name, level):
    f = getattr(jra, name)
    return jax.jit(jax.vmap(lambda x, k: f(x, float(level), k)))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", OPS)
def test_op_matches_jax(name, level):
    x = _images()
    keys = _keys(len(x), 3)
    negate = np.array([bool(jax.random.bernoulli(k)) for k in keys])
    assert negate.any() and not negate.all()   # both signs
    want = np.asarray(_jax_batched(name, level)(x, keys))
    got = getattr(pra, name)(torch.from_numpy(x), float(level),
                             torch.from_numpy(negate)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if TOL[name] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[name])


def jax_plan(key, batch, n):
    """The plan ``random_augment_device(images, key, n)`` draws, rebuilt
    from its key splits."""
    op, apply, negate = (np.zeros((batch, n), t) for t in
                         (np.int64, bool, bool))
    for i, kimg in enumerate(jax.random.split(key, batch)):
        for r, kr in enumerate(jax.random.split(kimg, n)):
            kop, kp, kparam = jax.random.split(kr, 3)
            op[i, r] = int(jax.random.randint(kop, (), 0,
                                              len(jra.VL_DEVICE_OPS)))
            apply[i, r] = bool(jax.random.bernoulli(kp, 0.5))
            negate[i, r] = bool(jax.random.bernoulli(kparam))
    return pra.AugmentPlan(*map(torch.from_numpy, (op, apply, negate)))


def test_op_tables_agree():
    assert [f.__name__ for f in pra.VL_DEVICE_OPS] == [
        f.__name__ for f in jra.VL_DEVICE_OPS]


def _jax_round_keys(x, keys, plan, r, m):
    """Round ``r`` of ``plan`` through the JAX ops, image i's op drawing its
    sign from the key ``random_augment_device`` derives from ``keys[i]``."""
    out = x.copy()
    for i, kimg in enumerate(keys):
        if plan.apply[i, r]:
            kparam = jax.random.split(jax.random.split(kimg, 2)[r], 3)[2]
            fn = jra.VL_DEVICE_OPS[int(plan.op[i, r])]
            out[i] = np.asarray(jax.jit(fn, static_argnums=1)(x[i], float(m),
                                                             kparam))
    return out


@pytest.mark.parametrize("seed,m", [(0, 5), (1, 5), (2, 9), (3, 2)])
def test_plan_driven_augment_matches_jax(seed, m):
    x = _images(b=16, h=16, w=16, seed=seed)
    key = jax.random.PRNGKey(100 + seed)
    plan = jax_plan(key, len(x), 2)
    want = np.asarray(jra.random_augment_device(x, key, n=2, m=m))
    got = pra.apply_augment_plan(torch.from_numpy(x), plan, m).numpy()
    names = [f.__name__ for f in pra.VL_DEVICE_OPS]
    op = [[names[k] if a else None for k, a in zip(ks, ap)]
          for ks, ap in zip(plan.op.tolist(), plan.apply.tolist())]
    chain = np.array([o[0] in AFFINE and o[1] == "equalize" for o in op])
    assert any(o[0] in AFFINE or o[1] in AFFINE
               for o, c in zip(op, chain) if not c)
    np.testing.assert_allclose(got[~chain], want[~chain], rtol=0, atol=1e-3)
    if chain.any():
        sub = x[chain]
        splan = pra.AugmentPlan(*(t[torch.from_numpy(chain)] for t in plan))
        keys = jax.random.split(key, len(x))[chain]
        for r in range(2):
            ref = _jax_round_keys(sub, keys, splan, r, m)
            one = pra.AugmentPlan(*(t[:, r:r + 1] for t in splan))
            np.testing.assert_allclose(
                pra.apply_augment_plan(torch.from_numpy(sub), one, m).numpy(),
                ref, rtol=0, atol=1e-3, err_msg=f"round {r}")
            sub = ref


def test_sampler_is_seeded():
    x = torch.from_numpy(_images(b=16, h=16, w=16))

    def run(seed):
        return pra.random_augment(x, torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, x)
    plan = pra.sample_augment_plan(64, 2, torch.Generator().manual_seed(0))
    assert plan.op.shape == (64, 2) and plan.op.dtype == torch.int64
    assert int(plan.op.min()) >= 0 and int(plan.op.max()) < 10
    assert 0 < int(plan.apply.sum()) < 128 and 0 < int(plan.negate.sum()) < 128
