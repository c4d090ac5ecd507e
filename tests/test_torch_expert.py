"""Port parity: ``engine/expert.py`` (the SGD the eval students train with)
against the JAX package.

The same NF_TINY bi-encoder weights (JAX init with the skipinit gains
moved off zero, carried across with ``models/convert.params_from_jax``)
and the same batches go through both trainers.  Dropout is off on both
sides (``proj_dropout=0``; NF_TINY has no DropPath): torch's generators
cannot draw JAX's masks.  The port runs with ``pallas_gconv`` on, so its
grouped convs go through the ``GConv3x3`` Functions (their plain versions
on the CPU).

Tolerances: float32 parameters 2e-4 relative (as
tests/test_reference_parity.py holds per-step students: the convs sum in
other orders), loss 1e-5 relative and acc exactly; bfloat16 compute 1e-2
(bf16 rounds each product to 2^-9, and the two packages round at other
places); the optimizer alone 1e-6 (the same float32 operations, in
another association of ``p - lr * t``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine import expert as jexpert
from multimodal_dataset_distillation_tpu.models.clip_model import (
    VLBiEncoder as JVLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.engine import expert
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    params_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.utils.flat import flatten_params
from test_torch_threads import share_cores  # noqa: F401 (autouse)

SIZE, B = 32, 4
HYPER = dict(lr_img=0.05, lr_txt=0.05, momentum=0.9, weight_decay=5e-4)


def _jax_variables(seed=0):
    model = JVLBiEncoder(image_encoder_name="nf_tiny", text_embedding=768,
                         image_embedding=128, proj_dropout=0.0)
    variables = jexpert.init_bi_encoder(
        model, JConfig(image_encoder="nf_tiny", image_size=SIZE),
        jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed + 100)

    def lift(path, leaf):
        if getattr(path[-1], "key", None) == "skipinit_gain":
            return np.float32(0.5 + 0.1 * rs.randn())
        return np.asarray(leaf)

    return model, {"params": jax.tree_util.tree_map_with_path(
        lift, variables["params"])}


def port_state(jparams):
    """JAX params -> the port bi-encoder's state dict."""
    model = VLBiEncoder("nf_tiny", 768, 128, proj_dropout=0.0, gconv=True)
    sd = {}
    for tower in ("image_encoder", "text_projection"):
        for k, v in params_from_jax(jparams[tower],
                                    getattr(model, tower)).items():
            sd[f"{tower}.{k}"] = v
    return sd


def port_model(jparams=None, proj_dropout=0.0):
    model = VLBiEncoder("nf_tiny", 768, 128, proj_dropout=proj_dropout,
                        gconv=True)
    if jparams is not None:
        model.load_state_dict(port_state(jparams))
    return model


def _batches(n=3, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(B, SIZE, SIZE, 3).astype(np.float32),
             rs.randn(B, 768).astype(np.float32)) for _ in range(n)]


def _assert_params(model, jparams, rtol=2e-4, atol=2e-6):
    want = port_state(jparams)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def _assert_towers_rel_norm(model, jparams, tol):
    want = port_state(jparams)
    for tower in ("image_encoder", "text_projection"):
        keys = [k for k in want if k.startswith(tower)]
        a = torch.cat([model.state_dict()[k].reshape(-1) for k in keys])
        b = torch.cat([want[k].reshape(-1) for k in keys])
        assert float((a - b).norm() / b.norm()) <= tol, tower


@pytest.mark.parametrize("momentum,weight_decay", [
    (0.9, 5e-4), (0.0, 0.0), (0.5, 0.0), (0.0, 1e-2)])
def test_torch_sgd_matches_optax_chain(momentum, weight_decay):
    rs = np.random.RandomState(1)
    p0 = [rs.randn(5, 3).astype(np.float32), rs.randn(7).astype(np.float32)]
    grads = [[rs.randn(*p.shape).astype(np.float32) for p in p0]
             for _ in range(5)]
    tx = jexpert.torch_sgd(0.05, momentum, weight_decay)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = expert.torch_sgd(tp, 0.05, momentum, weight_decay)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = [a + u for a, u in zip(jp, upd)]
        for t, a in zip(tp, g):
            t.grad = torch.from_numpy(a)
        opt.step()
        for t, a in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(a),
                                       rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX train_batch steps in float32 and in bfloat16."""
    model, variables = _jax_variables()
    out = {"variables": variables}
    for dtype in ("float32", "bfloat16"):
        tr = jexpert.BiEncoderTrainer(model, variables, seed=0,
                                      compute_dtype=dtype, **HYPER)
        steps = [tuple(float(v) for v in tr.train_batch(*b))
                 for b in _batches()]
        out[dtype] = (steps, jax.tree_util.tree_map(
            np.asarray, tr.variables["params"]))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bi_encoder_trainer_matches_jax(jax_run, dtype):
    steps, jparams = jax_run[dtype]
    tr = expert.BiEncoderTrainer(port_model(jax_run["variables"]["params"]),
                                 seed=0, compute_dtype=dtype, **HYPER)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for (jl, ja), batch in zip(steps, _batches()):
        loss, acc = tr.train_batch(*batch)
        np.testing.assert_allclose(float(loss), jl, rtol=tol)
        if dtype == "float32":
            assert float(acc) == ja
    if dtype == "float32":
        _assert_params(tr.model, jparams)
    else:
        _assert_towers_rel_norm(tr.model, jparams, 1e-2)


def test_train_epoch_arrays_matches_jax(jax_run):
    """One epoch over the seeded ArrayPairLoader: the same batch order, so
    the same epoch means (loss 1e-5, acc exactly)."""
    from multimodal_dataset_distillation_tpu.data.pipeline import (
        ArrayPairLoader as JLoader)
    from multimodal_dataset_distillation_tpu_torch.data.pipeline import (
        ArrayPairLoader)
    model, variables = _jax_variables()
    rs = np.random.RandomState(3)
    images = rs.randn(10, SIZE, SIZE, 3).astype(np.float32)
    texts = rs.randn(10, 768).astype(np.float32)
    jtr = jexpert.BiEncoderTrainer(model, variables, seed=0, **HYPER)
    want = jtr.train_epoch_arrays(JLoader(images, texts, 4, seed=5))
    tr = expert.BiEncoderTrainer(port_model(variables["params"]), seed=0,
                                 **HYPER)
    got = tr.train_epoch_arrays(ArrayPairLoader(images, texts, 4, seed=5))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == want[1]
    _assert_params(tr.model, jax.tree_util.tree_map(
        np.asarray, jtr.variables["params"]))


def test_parallel_trainer_matches_sequential_and_jax():
    """K=2: bit for bit two sequential port trainers (dropout on, per-model
    generators), and JAX's ParallelExpertTrainer(seeds=...) within the
    float32 tolerance (dropout off)."""
    (jmodel, v0), (_, v1) = _jax_variables(0), _jax_variables(1)
    batches = _batches(2, seed=7)
    images = [np.stack([b[0], b[0][::-1]]) for b in batches]
    texts = [np.stack([b[1], b[1][::-1]]) for b in batches]
    inits = [port_state(v["params"]) for v in (v0, v1)]
    for dropout in (0.1, 0.0):
        par = expert.ParallelExpertTrainer(
            port_model(proj_dropout=dropout), inits, seeds=[3, 4], **HYPER)
        p_out = [par.train_batch(i, t) for i, t in zip(images, texts)]
        for j in range(2):
            seq = expert.BiEncoderTrainer(port_model(proj_dropout=dropout),
                                          inits[j], seed=3 + j, **HYPER)
            for (loss, acc), i, t in zip(p_out, images, texts):
                sl, sa = seq.train_batch(i[j], t[j])
                assert torch.equal(sl, loss[j]) and torch.equal(sa, acc[j])
            assert torch.equal(flatten_params(seq.model),
                               flatten_params(par.model_for(j)))
    jpar = jexpert.ParallelExpertTrainer(jmodel, [v0, v1], seeds=[3, 4],
                                         **HYPER)
    for (loss, acc), i, t in zip(p_out, images, texts):
        jl, ja = jpar.train_batch(i, t)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(ja))
    for j in range(2):
        _assert_params(par.model_for(j), jax.tree_util.tree_map(
            lambda x: np.asarray(x[j]), jpar.variables["params"]))


def test_reset_rearms_to_a_fresh_trainer():
    """reset(init, seed, lr) after training equals a new trainer at that
    init, seed and lr, bit for bit (momentum traces cleared, generator
    reseeded; dropout on so the generator matters)."""
    init = {k: v.clone() for k, v in port_model(
        _jax_variables()[1]["params"]).state_dict().items()}
    batches = _batches(2, seed=9)
    used = expert.BiEncoderTrainer(port_model(proj_dropout=0.1), init,
                                   seed=1, **HYPER)
    for b in _batches(2, seed=8):
        used.train_batch(*b)
    used.reset(init, seed=5, lr_img=0.02, lr_txt=0.03)
    fresh = expert.BiEncoderTrainer(port_model(proj_dropout=0.1), init,
                                    seed=5, **{**HYPER, "lr_img": 0.02,
                                               "lr_txt": 0.03})
    for b in batches:
        a, f = used.train_batch(*b), fresh.train_batch(*b)
        assert torch.equal(a[0], f[0]) and torch.equal(a[1], f[1])
    assert torch.equal(flatten_params(used.model), flatten_params(fresh.model))
    for get in ("snapshot_image_params", "snapshot_text_params"):
        for x, y in zip(getattr(used, get)(), getattr(fresh, get)()):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        np.concatenate([a.reshape(-1) for a in used.snapshot_image_params()]),
        flatten_params(used.model.image_encoder).numpy())
