"""The JAX side and the checks of tests/test_torch_dp_distill*.py (not a
test module): data parallelism of the distill step against the JAX
Distiller on a mesh.

The JAX Distiller runs on a 2- and a 3-device CPU mesh (``get_mesh((W,))``
over ``tests/conftest.py``'s 8 CPU devices) with ``--shard_syn`` on; the
port's runs on W ``gloo`` ranks (``tests/torch_dp_worker.py``), with the
same NF_TINY weights (JAX init, carried by ``models/convert.py``), data,
minibatch indices and expert segment.  The minibatch (5) and the query
count (7) divide neither world, so both packages pad and mask the
minibatch and pad the synthetic set with inert rows.  Dropout is off:
torch's generators cannot draw JAX's masks (tests/test_torch_dp_world.py
holds the port at every world to its own one-rank step with dropout on).

Tolerances (float32 on the CPU, as tests/test_torch_distill.py): 2e-4 on
per-step students, 5e-3 on the loss and the meta-gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine.distill import (
    Distiller as JDistiller,
)
from multimodal_dataset_distillation_tpu.engine.expert import (
    init_bi_encoder as jinit_bi_encoder,
)
from multimodal_dataset_distillation_tpu.models.clip_model import (
    VLBiEncoder as JVLBiEncoder,
)
from multimodal_dataset_distillation_tpu.parallel.mesh import (
    get_mesh as jget_mesh,
)
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
    params_from_jax,
)
from torch_dp_worker import spawn

NQ, MB, STEPS, SIZE = 7, 5, 2, 32
CFG = dict(image_encoder="nf_tiny", image_size=SIZE, num_queries=NQ,
           syn_steps=STEPS, mini_batch_size=MB, expert_epochs=1,
           lr_img=10.0, lr_txt=10.0, lr_lr=1e-2, lr_teacher_img=0.05,
           lr_teacher_txt=0.05, seed=0, inner_scale="syn_lr", shard_syn=True)
MODEL_KW = dict(image_encoder_name="nf_tiny", text_embedding=768,
                image_embedding=128, proj_dropout=0.0, gconv=True)
MODES = [dict(fr_bwd="rof"), dict(fr_bwd="for")]


def _jax_params():
    """JAX NF_TINY bi-encoder params with skipinit gains moved off zero."""
    model = JVLBiEncoder(image_encoder_name="nf_tiny", text_embedding=768,
                         image_embedding=128, proj_dropout=0.0)
    variables = jinit_bi_encoder(model, JConfig(**CFG))
    rs = np.random.RandomState(100)

    def lift(path, leaf):
        if getattr(path[-1], "key", None) == "skipinit_gain":
            return np.float32(0.5 + 0.1 * rs.randn())
        return np.asarray(leaf)

    return model, {"params": jax.tree_util.tree_map_with_path(
        lift, variables["params"])}


def _inputs(params):
    rs = np.random.RandomState(0)
    data = (rs.randn(NQ, SIZE, SIZE, 3).astype(np.float32),
            rs.randn(NQ, 768).astype(np.float32))
    i0 = np.asarray(ravel_pytree(params["image_encoder"])[0])
    t0 = np.asarray(ravel_pytree(params["text_projection"])[0])
    seg = (i0, t0, (i0 + 0.01 * rs.randn(*i0.shape)).astype(np.float32),
           (t0 + 0.01 * rs.randn(*t0.shape)).astype(np.float32))
    idx = np.stack([rs.permutation(NQ)[:MB] for _ in range(STEPS)])
    return data, seg, idx


def _jax_run(world):
    jmodel, variables = _jax_params()
    data, seg, idx = _inputs(variables["params"])
    jd = JDistiller(JConfig(**CFG), jmodel, variables, *data,
                    mesh=jget_mesh((world,)))
    keys = jax.random.split(jax.random.PRNGKey(7), STEPS)
    s0 = jd.state
    args = (s0.image_syn, s0.text_syn, s0.syn_lr_img, s0.syn_lr_txt,
            *map(jnp.asarray, seg), jnp.asarray(idx), keys)
    his, hts = jd.unroll(*args[:6], jnp.asarray(idx), keys)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jd.grand_loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    return dict(params=variables["params"], data=data, seg=seg, idx=idx,
                loss=float(loss), grads=[np.asarray(g) for g in grads],
                his=np.asarray(his), hts=np.asarray(hts),
                syn_pad=jd._syn_pad)


def run_both(world, tmp):
    """The JAX Distiller's results on a ``world``-device mesh and the
    port's ranks' on ``world`` ranks."""
    j = _jax_run(world)
    model = VLBiEncoder(**MODEL_KW)
    jp = j["params"]
    model.image_encoder.load_state_dict(
        params_from_jax(jp["image_encoder"], model.image_encoder))
    model.text_projection.load_state_dict(
        params_from_jax(jp["text_projection"], model.text_projection))
    towers = (model.image_encoder, model.text_projection) * 2
    seg = [flat_from_jax(s, t) for s, t in zip(j["seg"], towers)]
    job = dict(scenario="distill", model_kw=MODEL_KW,
               state_dict=model.state_dict(), data=j["data"], seg=seg,
               idx=j["idx"], seeds=[(1, 2), (3, 4)],
               cfg=dict(CFG, pallas_gconv=True), modes=MODES, steps=STEPS)
    ranks = spawn(tmp, job, world)
    return dict(world=world, jax=j, ranks=ranks, model=model)


def _close(got, want, rtol, name):
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


def check_against_jax(runs, mode):
    """Per-step students to 2e-4, the loss and the meta-gradients to 5e-3;
    the JAX pad rows get no meta-gradient either."""
    j, port = runs["jax"], runs["ranks"][0][mode]
    m = runs["model"]
    _close(port["his"], flat_from_jax(j["his"], m.image_encoder), 2e-4,
           "image students")
    _close(port["hts"], flat_from_jax(j["hts"], m.text_projection), 2e-4,
           "text students")
    np.testing.assert_allclose(port["loss"], j["loss"], rtol=5e-3)
    for g, jg, name in zip(port["grads"], j["grads"],
                           ("pixels", "texts", "lr_img", "lr_txt")):
        _close(g, np.asarray(jg)[:NQ] if np.ndim(jg) else jg, 5e-3, name)
    # the JAX pad rows get nothing either
    assert j["syn_pad"] == (-NQ) % runs["world"] > 0
    for jg in j["grads"][:2]:
        assert not np.asarray(jg)[NQ:].any()


def check_steps_and_pad_rows(runs, mode):
    """After the outer steps every rank holds the same whole set and
    loss; rank r holds its rows of the padded set, and the pad rows (and
    their momentum: zero meta-gradient) stay zero."""
    ranks = runs["ranks"]
    port = ranks[0][mode]["state"]
    # every rank gathers the same whole set and computes the same loss
    for r in ranks[1:]:
        assert r[mode]["loss_bits"] == ranks[0][mode]["loss_bits"]
        for a, b in zip(r[mode]["state"], port):
            np.testing.assert_array_equal(a, b)
    # rank r holds rows [r n/W, (r+1) n/W) of the padded set; the last
    # rank's pad rows (and their momentum: zero meta-gradient) stay zero
    world = runs["world"]
    per = (NQ + (-NQ) % world) // world
    for r, res in enumerate(ranks):
        own = res[mode]["own_rows"]
        assert own[0].shape[0] == per
        lo, hi = r * per, min((r + 1) * per, NQ)
        np.testing.assert_array_equal(own[0][:hi - lo], port[0][lo:hi])
        for t in own:
            assert not t[hi - lo:].any()
