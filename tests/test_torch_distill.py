"""Port parity: the outer distillation step against the JAX Distiller.

The same NF_TINY bi-encoder weights (JAX init, carried across with
``models/convert.params_from_jax``), the same synthetic data, minibatch
indices and expert segment go through both packages' ``Distiller``.  The
port runs with ``pallas_gconv`` on, so its grouped 3x3 convs (NF_TINY's
stage-0 and stage-1 blocks) go through the ``GConv3x3`` autograd Functions
(their plain versions on the CPU) to second order.  Dropout is off
(``proj_dropout=0``; NF_TINY has no DropPath): torch's generators cannot
draw JAX's masks.  Skipinit gains are set non-zero, so the residual
branches, and with them the grouped convs, shape the loss.

Tolerances (float32 on the CPU, as tests/test_reference_parity.py):
2e-4 on per-step students, 5e-3 on meta-gradients and outer-step updates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.ops import contrastive as jcontrastive
from multimodal_dataset_distillation_tpu.engine import buffer_io as jbuffer_io
from multimodal_dataset_distillation_tpu.engine.distill import (
    Distiller as JDistiller,
)
from multimodal_dataset_distillation_tpu.engine.expert import (
    init_bi_encoder as jinit_bi_encoder,
)
from multimodal_dataset_distillation_tpu.models.clip_model import (
    VLBiEncoder as JVLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.engine.buffer_io import (
    discover_buffers,
)
from multimodal_dataset_distillation_tpu_torch.engine.distill import (
    Distiller,
    ExpertCycler,
    dummy_trajectory,
    noise_images,
    noise_texts,
)
from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
    VLBiEncoder,
)
from multimodal_dataset_distillation_tpu_torch.ops import contrastive
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    flat_from_jax,
    params_from_jax,
)
from multimodal_dataset_distillation_tpu_torch.utils.flat import flatten_params

NQ, MB, STEPS, SIZE = 4, 2, 2, 32
CFG = dict(image_encoder="nf_tiny", image_size=SIZE, num_queries=NQ,
           syn_steps=STEPS, mini_batch_size=MB, expert_epochs=1,
           lr_img=10.0, lr_txt=10.0, lr_lr=1e-2,
           lr_teacher_img=0.05, lr_teacher_txt=0.05, seed=0)


def _jax_params(seed=0):
    """JAX NF_TINY bi-encoder params with skipinit gains moved off zero."""
    model = JVLBiEncoder(image_encoder_name="nf_tiny", text_embedding=768,
                         image_embedding=128, proj_dropout=0.0)
    variables = jinit_bi_encoder(model, JConfig(**CFG))
    rs = np.random.RandomState(seed + 100)

    def lift(path, leaf):
        if getattr(path[-1], "key", None) == "skipinit_gain":
            return np.float32(0.5 + 0.1 * rs.randn())
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(lift, variables["params"])
    return model, {"params": params}


def _port_model(jparams, dtype=torch.float32, proj_dropout=0.0):
    model = VLBiEncoder("nf_tiny", 768, 128, proj_dropout=proj_dropout,
                        gconv=True)
    model.image_encoder.load_state_dict(
        params_from_jax(jparams["image_encoder"], model.image_encoder))
    model.text_projection.load_state_dict(
        params_from_jax(jparams["text_projection"], model.text_projection))
    return model.to(dtype)


def _data(dtype=np.float32):
    rng = np.random.RandomState(0)
    image_syn = rng.randn(NQ, SIZE, SIZE, 3).astype(dtype)
    text_syn = rng.randn(NQ, 768).astype(dtype)
    return image_syn, text_syn


def _segment(jparams, dtype=np.float32):
    """(i0, t0, it, tt) in JAX ravel order."""
    rng = np.random.RandomState(3)
    i0 = np.asarray(ravel_pytree(jparams["image_encoder"])[0], dtype)
    t0 = np.asarray(ravel_pytree(jparams["text_projection"])[0], dtype)
    it = (i0 + 0.01 * rng.randn(*i0.shape)).astype(dtype)
    tt = (t0 + 0.01 * rng.randn(*t0.shape)).astype(dtype)
    return i0, t0, it, tt


@pytest.fixture(scope="module", params=["fixed", "syn_lr"])
def parity(request):
    """JAX results and the matching port Distiller for one inner_scale."""
    inner_scale = request.param
    jmodel, variables = _jax_params()
    image_syn, text_syn = _data()
    jd = JDistiller(JConfig(**CFG, inner_scale=inner_scale), jmodel,
                    variables, image_syn, text_syn)
    seg = _segment(variables["params"])
    idx = jd.sample_indices(np.random.RandomState(1))
    keys = jax.random.split(jax.random.PRNGKey(7), STEPS)
    s0 = jd.state
    args = (s0.image_syn, s0.text_syn, s0.syn_lr_img, s0.syn_lr_txt,
            *map(jnp.asarray, seg), jnp.asarray(idx), keys)
    j_unroll = [np.asarray(a) for a in jd.unroll(
        *args[:6], jnp.asarray(idx), keys)]
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        jd.grand_loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    j_states = []
    for _ in range(2):
        jd.step(*seg, idx)
        st = jd.state
        j_states.append([np.asarray(st.image_syn), np.asarray(st.text_syn),
                         float(st.syn_lr_img), float(st.syn_lr_txt)])

    model = _port_model(variables["params"])
    cfg = Config(**CFG, inner_scale=inner_scale, pallas_gconv=True)
    port_seg = (flat_from_jax(seg[0], model.image_encoder),
                flat_from_jax(seg[1], model.text_projection),
                flat_from_jax(seg[2], model.image_encoder),
                flat_from_jax(seg[3], model.text_projection))
    return dict(
        cfg=cfg, model=model, data=(image_syn, text_syn), seg=port_seg,
        idx=idx, j_unroll=j_unroll, j_loss=float(j_loss),
        j_grads=[np.asarray(g) for g in j_grads], j_states=j_states)


def _port_args(d, seg, idx, dtype=torch.float32):
    st = d.state
    leaves = [t.detach().clone().requires_grad_() for t in
              (st.image_syn, st.text_syn, st.syn_lr_img, st.syn_lr_txt)]
    flats = [torch.as_tensor(np.asarray(s), dtype=dtype) for s in seg]
    return leaves, flats, torch.as_tensor(idx)


def test_unroll_matches_jax(parity):
    p = parity
    d = Distiller(p["cfg"], p["model"], *p["data"], device="cpu")
    leaves, flats, idx = _port_args(d, p["seg"], p["idx"])
    his, hts = d.unroll(*leaves, flats[0], flats[1], idx,
                        d.draw_seeds(STEPS))
    j_his, j_hts = p["j_unroll"]
    np.testing.assert_allclose(
        his.numpy(), flat_from_jax(j_his, p["model"].image_encoder),
        rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(
        hts.numpy(), flat_from_jax(j_hts, p["model"].text_projection),
        rtol=2e-4, atol=2e-6)


def test_meta_gradients_match_jax(parity):
    p = parity
    d = Distiller(p["cfg"], p["model"], *p["data"], device="cpu")
    leaves, flats, idx = _port_args(d, p["seg"], p["idx"])
    loss, _ = d.grand_loss(*leaves, *flats, idx, d.draw_seeds(STEPS))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), p["j_loss"], rtol=5e-3)
    for g, jg, name in zip(grads, p["j_grads"],
                           ("pixels", "texts", "lr_img", "lr_txt")):
        scale = np.abs(jg).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), jg, rtol=5e-3,
                                   atol=5e-3 * scale, err_msg=name)


def test_outer_steps_match_jax(parity):
    p = parity
    d = Distiller(p["cfg"], p["model"], *p["data"], device="cpu")
    init = [np.asarray(a) for a in p["data"]] + [
        p["cfg"].lr_teacher_img, p["cfg"].lr_teacher_txt]
    for j_state in p["j_states"]:
        d.step(*p["seg"], p["idx"])
        st = d.state
        port = [st.image_syn.numpy(), st.text_syn.numpy(),
                float(st.syn_lr_img), float(st.syn_lr_txt)]
        for a, b, a0, name in zip(port, j_state, init,
                                  ("pixels", "texts", "lr_img", "lr_txt")):
            delta_j = np.asarray(b) - a0
            np.testing.assert_allclose(
                np.asarray(a) - a0, delta_j, rtol=5e-3,
                atol=5e-3 * np.abs(delta_j).max(), err_msg=name)


def _f64_distiller(hvp_mode, inner_scale="syn_lr", proj_dropout=0.1,
                   inner_pad=0):
    jmodel, variables = _jax_params()
    model = _port_model(variables["params"], torch.float64, proj_dropout)
    cfg = Config(**CFG, inner_scale=inner_scale, inner_dtype="float64",
                 hvp_mode=hvp_mode, pallas_gconv=True)
    d = Distiller(cfg, model, *_data(np.float64), device="cpu",
                  inner_pad=inner_pad)
    seg = [flat_from_jax(s, m) for s, m in zip(
        _segment(variables["params"], np.float64),
        (model.image_encoder, model.text_projection) * 2)]
    return d, seg


def _meta_grads(d, seg, seeds):
    leaves, flats, idx = _port_args(
        d, seg, d.sample_indices(np.random.RandomState(1)), torch.float64)
    loss, _ = d.grand_loss(*leaves, *flats, idx, seeds)
    return [float(loss)] + [g.numpy() for g in
                            torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("inner_scale", ["fixed", "syn_lr"])
def test_forward_function_matches_reverse_unroll(inner_scale):
    """The per-step autograd Function (hvp_mode="forward") against the
    create_graph=True unroll, float64, projection dropout on: the same
    seeds redraw the same masks in the Function's recompute."""
    seeds = [(11, 12), (13, 14)]
    out = {}
    for mode in ("reverse", "forward"):
        d, seg = _f64_distiller(mode, inner_scale)
        out[mode] = _meta_grads(d, seg, seeds)
    for a, b, name in zip(out["reverse"], out["forward"],
                          ("loss", "pixels", "texts", "lr_img", "lr_txt")):
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-14,
                                   err_msg=name)


def test_pad_and_mask_matches_unpadded():
    """A minibatch padded with masked slots gives exactly the unpadded
    loss and meta-gradients (the JAX package's mesh pad-and-mask)."""
    seeds = [(1, 2), (3, 4)]
    d, seg = _f64_distiller("forward", proj_dropout=0.0)
    dp, _ = _f64_distiller("forward", proj_dropout=0.0, inner_pad=1)
    for a, b in zip(_meta_grads(d, seg, seeds), _meta_grads(dp, seg, seeds)):
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-14)


def test_lr_img_finite_difference():
    """Independent ground truth for the Function's inner-LR cotangent:
    central differences of grand_loss in float64."""
    d, seg = _f64_distiller("forward")
    seeds = [(5, 6), (7, 8)]
    idx = torch.as_tensor(d.sample_indices(np.random.RandomState(1)))
    st = d.state
    flats = [torch.as_tensor(s) for s in seg]

    def loss_at(lr):
        lr = torch.tensor(lr, dtype=torch.float64, requires_grad=True)
        loss, _ = d.grand_loss(st.image_syn, st.text_syn, lr, st.syn_lr_txt,
                               *flats, idx, seeds)
        return loss, lr

    lr0 = float(st.syn_lr_img)
    loss, lr = loss_at(lr0)
    (g,) = torch.autograd.grad(loss, lr)
    eps = 1e-5
    fd = (float(loss_at(lr0 + eps)[0]) - float(loss_at(lr0 - eps)[0])) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-6)


def test_buffers_written_by_jax_read_through_cycler(tmp_path):
    """``.npz`` (ravel order) and ``.pt`` (reference order) buffers that
    ``engine/buffer_io.save_expert`` writes read back as the same
    trajectories in the port's flat order."""
    _, variables = _jax_params()
    params = variables["params"]
    model = _port_model(params)
    rs = np.random.RandomState(0)

    def traj(tree, n=3):
        return [jax.tree_util.tree_map(
            lambda x: np.asarray(x) + np.float32(0.01 * k) * rs.randn(
                *np.shape(x)).astype(np.float32) if np.ndim(x) else x, tree)
            for k in range(n)]

    img_traj, txt_traj = traj(params["image_encoder"]), traj(
        params["text_projection"])
    want_img = flat_from_jax(jbuffer_io.stack_trajectory(img_traj),
                             model.image_encoder)
    want_txt = flat_from_jax(jbuffer_io.stack_trajectory(txt_traj),
                             model.text_projection)
    for fmt in ("npz", "pt"):
        out = tmp_path / fmt
        jbuffer_io.save_expert(str(out), img_traj, txt_traj,
                               write_pt=fmt == "pt", write_npz=fmt == "npz")
        img_files, txt_files = discover_buffers(str(out))
        assert [f.endswith(fmt) for f in img_files] == [True]
        cyc = ExpertCycler(img_files, txt_files, max_start_epoch=2,
                           expert_epochs=1,
                           img_template=model.image_encoder,
                           txt_template=model.text_projection, seed=0)
        i0, t0, it, tt, start = cyc.next_segment()
        assert 0 <= start < 2
        np.testing.assert_array_equal(i0, want_img[start])
        np.testing.assert_array_equal(it, want_img[start + 1])
        np.testing.assert_array_equal(t0, want_txt[start])
        np.testing.assert_array_equal(tt, want_txt[start + 1])
        ti, tt_, start = cyc.next_segment_device("cpu")
        assert ti.dtype == torch.float32 and 0 <= start < 2
        np.testing.assert_array_equal(ti.numpy(), want_img)
        np.testing.assert_array_equal(tt_.numpy(), want_txt)


def test_pt_buffer_in_another_order_is_refused(tmp_path):
    _, variables = _jax_params()
    model = _port_model(variables["params"])
    snap = [p.detach() for p in model.text_projection.parameters()]
    torch.save([[snap[::-1]]], tmp_path / "txt.pt")
    from multimodal_dataset_distillation_tpu_torch.engine.buffer_io import (
        load_buffer,
    )
    with pytest.raises(ValueError, match="registration order"):
        load_buffer(str(tmp_path / "txt.pt"), model.text_projection)


def test_noise_init_and_dummy_trajectory_step():
    """Noise-initialized synthetic data and a dummy trajectory from a
    fresh port init give a finite outer step that moves the state."""
    rng = np.random.RandomState(0)
    image_syn = noise_images(NQ, SIZE, rng)
    text_syn = noise_texts(NQ, 768, rng)
    np.testing.assert_allclose(image_syn.reshape(-1, 3).mean(0),
                               [-0.0626, -0.0221, 0.0680], atol=0.05)
    from multimodal_dataset_distillation_tpu_torch.models.clip_model import (
        init_bi_encoder,
    )
    model = init_bi_encoder(VLBiEncoder("nf_tiny", 768, 128, gconv=True), 0)
    cfg = Config(**CFG, pallas_gconv=True)
    d = Distiller(cfg, model, image_syn, text_syn, device="cpu")
    segs = []
    for tower in (model.image_encoder, model.text_projection):
        t = dummy_trajectory([p.detach().numpy() for p in tower.parameters()])
        segs.append([np.concatenate([a.reshape(-1) for a in s]) for s in t])
    (i0, it), (t0, tt) = segs
    assert np.array_equal(i0, flatten_params(model.image_encoder).numpy())
    m = d.step(i0, t0, it, tt, d.sample_indices(rng))
    assert np.isfinite(float(m["grand_loss"]))
    assert not np.array_equal(d.state.image_syn.numpy(), image_syn)
    assert float(m["syn_lr_img"]) != float(m["syn_lr_img_pre"])


def test_config_matches_jax():
    """The port's own Config: the JAX package's field names, order and
    defaults; only the runtime device differs."""
    jfields = [f.name for f in dataclasses.fields(JConfig)]
    assert [f.name for f in dataclasses.fields(Config)] == jfields
    j, t = JConfig(), Config()
    differ = {n for n in jfields if n != "name"
              and getattr(j, n) != getattr(t, n)}
    assert differ == {"device"}
    assert (t.device, t.image_embedding, t.text_embedding) == ("cuda", 2304,
                                                               768)


def test_contrastive_matches_jax():
    """l2_normalize, info_nce, contrastive_loss_and_acc and the masked
    _symmetric_ce (pad columns and rows) against the JAX package."""
    rs = np.random.RandomState(4)
    img = rs.randn(6, 16).astype(np.float32)
    txt = rs.randn(6, 16).astype(np.float32)
    ti, tt = torch.from_numpy(img), torch.from_numpy(txt)
    np.testing.assert_allclose(contrastive.l2_normalize(ti).numpy(),
                               np.asarray(jcontrastive.l2_normalize(img)),
                               rtol=1e-6, atol=1e-7)
    for scale in (contrastive.FIXED_LOGIT_SCALE, contrastive.RAW_LOG_SCALE):
        np.testing.assert_allclose(
            float(contrastive.info_nce(ti, tt, scale)),
            float(jcontrastive.info_nce(img, txt, scale)), rtol=1e-5)
    loss, acc = contrastive.contrastive_loss_and_acc(ti, tt)
    jloss, jacc = jcontrastive.contrastive_loss_and_acc(img, txt)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc)
    logits = rs.randn(6, 6).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    got = contrastive._symmetric_ce(torch.from_numpy(logits),
                                    torch.from_numpy(mask), 4)
    np.testing.assert_allclose(
        float(got), float(jcontrastive._symmetric_ce(logits, mask, 4)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(got), float(contrastive._symmetric_ce(
            torch.from_numpy(logits[:4, :4]))), rtol=1e-5)


@pytest.mark.parametrize("max_norm", [0.0, 1.0, 100.0])
def test_outer_sgd_matches_optax(max_norm):
    """Each group's outer optimizer is optax's chain(clip_by_global_norm,
    sgd(momentum=0.5)): the trace starts at zero and the clip scales by
    max_norm / norm only above max_norm (no epsilon)."""
    d = Distiller(Config(**CFG, max_grad_norm=max_norm),
                  VLBiEncoder("nf_tiny", 768, 128), *_data(), device="cpu")
    tx = optax.sgd(0.3, momentum=0.5)
    if max_norm:
        tx = optax.chain(optax.clip_by_global_norm(max_norm), tx)
    rs = np.random.RandomState(5)
    grads = [[rs.randn(4, 3).astype(np.float32) * k,
              np.float32(rs.randn() * k)] for k in (3.0, 0.01)]
    opt = tx.init([jnp.zeros((4, 3)), jnp.zeros(())])
    traces = [torch.zeros(4, 3), torch.zeros(())]
    for g in grads:
        want, opt = tx.update([jnp.asarray(a) for a in g], opt)
        got, traces = d._sgd([torch.as_tensor(a) for a in g], traces, 0.3)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_image_only_freezes_the_text_side():
    """image_only: the text embeddings and the text LR do not move (their
    gradients are zeroed before the optimizer, as in the JAX package)."""
    _, variables = _jax_params()
    model = _port_model(variables["params"])
    d = Distiller(Config(**CFG, image_only=True, pallas_gconv=True), model,
                  *_data(), device="cpu")
    seg = [flat_from_jax(s, m) for s, m in zip(
        _segment(variables["params"]),
        (model.image_encoder, model.text_projection) * 2)]
    st0 = d.state
    m = d.step(*seg, d.sample_indices(np.random.RandomState(1)))
    assert float(m["syn_lr_txt_grad"]) == 0.0
    assert torch.equal(d.state.text_syn, st0.text_syn)
    assert torch.equal(d.state.syn_lr_txt, st0.syn_lr_txt)
    assert not torch.equal(d.state.image_syn, st0.image_syn)
