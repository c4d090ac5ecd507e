"""Files the JAX package writes, read by the port: legacy ``.pt`` expert
buffers whose 0-d leaves were promoted to ``(1,)``, and ``.msgpack``
distill checkpoints on resume (the port's ``engine/buffer_io.py`` and
``engine/checkpoint.py`` against the JAX ``engine/buffer_io.py``,
``models/torch_order.py::identify`` and ``engine/checkpoint.py``).

The checkpoint is written by the JAX ``save_distill_checkpoint`` after two
outer steps of the JAX Distiller (NF_TINY at 32², as
``tests/test_torch_distill.py``), on one device and on the 8-device CPU
mesh with ``shard_syn`` (pad rows); the port resumes from it with its
state equal to JAX's, then takes the third step, held against JAX's third
step at 2e-4 on the state and 5e-3 on the update.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.engine import buffer_io as jbuffer_io
from multimodal_dataset_distillation_tpu.engine import checkpoint as jcheckpoint
from multimodal_dataset_distillation_tpu.engine.distill import (
    Distiller as JDistiller,
    ExpertCycler as JExpertCycler,
)
from multimodal_dataset_distillation_tpu.parallel.mesh import get_mesh
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.engine import checkpoint
from multimodal_dataset_distillation_tpu_torch.engine.buffer_io import (
    discover_buffers,
    load_buffer,
)
from multimodal_dataset_distillation_tpu_torch.engine.distill import (
    Distiller,
    ExpertCycler,
)
from multimodal_dataset_distillation_tpu_torch.models.convert import flat_from_jax
from test_torch_distill import CFG, NQ, _data, _jax_params, _port_model, _segment
from test_torch_threads import share_cores  # noqa: F401 (autouse)

#: flax's eager init of the tower is the slow part: once per module
_jax_params = functools.lru_cache(maxsize=1)(_jax_params)


def _trajectory(tree, rs, n=3):
    return [jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.01 * k) * np.asarray(
            rs.randn(*np.shape(x)), np.float32), tree) for k in range(n)]


def _promote_scalars(path):
    """Rewrite a ``.pt`` buffer as the JAX writers before round 4 did:
    every leaf through ``ascontiguousarray``, so 0-d leaves become (1,).
    -> how many leaves were promoted."""
    payload = torch.load(path, weights_only=True)
    promoted = sum(t.dim() == 0 for traj in payload for snap in traj
                   for t in snap)
    torch.save([[[torch.from_numpy(np.ascontiguousarray(t.numpy()))
                  for t in snap] for snap in traj] for traj in payload],
               path)
    return promoted


@pytest.fixture(scope="module")
def jax_expert(tmp_path_factory):
    """A JAX-written expert (``.pt`` and ``.npz``) of the NF_TINY tower,
    whose skipinit gains are 0-d leaves."""
    _, variables = _jax_params()
    params = variables["params"]
    rs = np.random.RandomState(0)
    out = tmp_path_factory.mktemp("jax_expert")
    jbuffer_io.save_expert(str(out), _trajectory(params["image_encoder"], rs),
                           _trajectory(params["text_projection"], rs))
    return out, _port_model(params)


def test_legacy_pt_with_promoted_gains_reads_as_the_npz(jax_expert):
    out, model = jax_expert
    for kind, tower in (("img", model.image_encoder),
                        ("txt", model.text_projection)):
        pt = str(out / f"{kind}_replay_buffer_0.pt")
        legacy = str(out / f"legacy_{kind}.pt")
        torch.save(torch.load(pt, weights_only=True), legacy)
        promoted = _promote_scalars(legacy)
        if kind == "img":
            assert promoted > 0   # the skipinit gains
        want = load_buffer(str(out / f"{kind}_replay_buffer_0.npz"), tower)
        for got in (load_buffer(pt, tower), load_buffer(legacy, tower)):
            assert len(got) == 1
            np.testing.assert_array_equal(got[0], want[0])


def test_legacy_pt_of_a_wrong_shape_is_refused(jax_expert, tmp_path):
    out, model = jax_expert
    payload = torch.load(str(out / "img_replay_buffer_0.pt"),
                         weights_only=True)
    snap = payload[0][0]
    big = max(range(len(snap)), key=lambda i: snap[i].numel())
    payload[0][0][big] = snap[big].reshape(-1)[1:]   # one value short
    torch.save(payload, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="registration order"):
        load_buffer(str(tmp_path / "bad.pt"), model.image_encoder)
    # (2,) where the parameter is 0-d is not a scalar spelling
    payload = torch.load(str(out / "img_replay_buffer_0.pt"),
                         weights_only=True)
    snap = payload[0][0]
    gain = next(i for i, t in enumerate(snap) if t.dim() == 0)
    payload[0][0][gain] = snap[gain].reshape(1).repeat(2)
    torch.save(payload, tmp_path / "bad2.pt")
    with pytest.raises(ValueError, match="registration order"):
        load_buffer(str(tmp_path / "bad2.pt"), model.image_encoder)


def _state_arrays(state):
    """JAX DistillState -> the port's field names, as numpy."""
    def trace(opt):
        leaves = [x for x in jax.tree_util.tree_leaves(opt)]
        return [np.asarray(x) for x in leaves]

    return {"image_syn": np.asarray(state.image_syn),
            "text_syn": np.asarray(state.text_syn),
            "syn_lr_img": np.asarray(state.syn_lr_img),
            "syn_lr_txt": np.asarray(state.syn_lr_txt),
            "mom_img": trace(state.opt_img)[0],
            "mom_txt": trace(state.opt_txt)[0],
            "mom_lr": trace(state.opt_lr)}


@pytest.fixture(scope="module", params=["one_device", "shard_syn"])
def jax_checkpoint(request, tmp_path_factory):
    """Two JAX outer steps, the JAX checkpoint (with a cycler over
    JAX-written buffers), then the JAX third step and cycler segments."""
    padded = request.param == "shard_syn"
    tmp = tmp_path_factory.mktemp(request.param)
    jmodel, variables = _jax_params()
    image_syn, text_syn = _data()
    mesh = get_mesh((8,), ("data",)) if padded else None
    jd = JDistiller(JConfig(**CFG, shard_syn=padded), jmodel, variables,
                    image_syn, text_syn, mesh=mesh)
    assert jd._syn_pad == (8 - NQ if padded else 0)
    seg = _segment(variables["params"])
    params = variables["params"]
    rs = np.random.RandomState(1)
    bdir = str(tmp / "buffers")
    for _ in range(3):
        jbuffer_io.save_expert(bdir, _trajectory(params["image_encoder"], rs),
                               _trajectory(params["text_projection"], rs),
                               write_pt=False)
    img_files, txt_files = discover_buffers(bdir)
    cyc = JExpertCycler(img_files, txt_files, max_start_epoch=2,
                        expert_epochs=1, seed=0)
    host = np.random.RandomState(7)
    for _ in range(2):
        jd.step(*seg, jd.sample_indices(host))
        cyc.next_segment()
    path = str(tmp / "distill_ckpt_2.msgpack")
    jcheckpoint.save_distill_checkpoint(path, jd, it=2, cycler=cyc,
                                        host_rng=host)
    saved, host_state = _state_arrays(jd.state), host.get_state()
    jd.step(*seg, jd.sample_indices(host))
    segments = [cyc.next_segment() for _ in range(3)]
    return dict(path=path, saved=saved, after=_state_arrays(jd.state),
                host_state=host_state,
                seg=seg, files=(img_files, txt_files), segments=segments,
                params=params, padded=padded)


def _port_distiller(params):
    model = _port_model(params)
    d = Distiller(Config(**CFG), model, *_data(), device="cpu")
    return d, model


def _port_state(d):
    st = d.state
    return {"image_syn": st.image_syn.numpy(), "text_syn": st.text_syn.numpy(),
            "syn_lr_img": st.syn_lr_img.numpy(),
            "syn_lr_txt": st.syn_lr_txt.numpy(),
            "mom_img": st.mom_img.numpy(), "mom_txt": st.mom_txt.numpy(),
            "mom_lr": [t.numpy() for t in st.mom_lr]}


def test_msgpack_resume_restores_the_jax_state(jax_checkpoint, capsys):
    ck = jax_checkpoint
    d, model = _port_distiller(ck["params"])
    d.rng.manual_seed(12345)
    img_files, txt_files = ck["files"]
    cyc = ExpertCycler(img_files[::-1], txt_files[::-1], max_start_epoch=2,
                       expert_epochs=1, img_template=model.image_encoder,
                       txt_template=model.text_projection, seed=99,
                       device="cpu")
    host = np.random.RandomState(123)
    it = checkpoint.load_distill_checkpoint(ck["path"], d, cycler=cyc,
                                            host_rng=host)
    assert it == 2
    assert "jax_rng has no torch counterpart" in capsys.readouterr().out
    fresh = torch.Generator().manual_seed(d.cfg.seed)
    assert torch.equal(d.rng.get_state(), fresh.get_state())
    got = _port_state(d)
    for k, want in ck["saved"].items():
        for a, b in zip(got[k] if k == "mom_lr" else [got[k]],
                        want if k == "mom_lr" else [want]):
            if ck["padded"] and k in ("image_syn", "text_syn", "mom_img",
                                      "mom_txt"):
                assert b.shape[0] == 8 and not b[NQ:].any()
                b = b[:NQ]
            assert a.shape == b.shape and a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    # the cycler's cursor and RandomState continue JAX's walk
    for want in ck["segments"]:
        i0, t0, itg, ttg, start = cyc.next_segment()
        assert start == want[4]
        np.testing.assert_array_equal(
            i0, flat_from_jax(want[0], model.image_encoder))
        np.testing.assert_array_equal(
            ttg, flat_from_jax(want[3], model.text_projection))
    # the host RandomState too, so the third step's minibatch is JAX's
    st, want = host.get_state(), ck["host_state"]
    np.testing.assert_array_equal(st[1], want[1])
    assert st[2:] == want[2:]


def test_msgpack_resume_then_step_matches_jax(jax_checkpoint):
    ck = jax_checkpoint
    d, model = _port_distiller(ck["params"])
    host = np.random.RandomState(123)
    checkpoint.load_distill_checkpoint(ck["path"], d, host_rng=host)
    seg = ck["seg"]
    d.step(flat_from_jax(seg[0], model.image_encoder),
           flat_from_jax(seg[1], model.text_projection),
           flat_from_jax(seg[2], model.image_encoder),
           flat_from_jax(seg[3], model.text_projection),
           d.sample_indices(host))
    got = _port_state(d)
    for k in ("image_syn", "text_syn", "syn_lr_img", "syn_lr_txt"):
        before = ck["saved"][k][:NQ] if ck["saved"][k].ndim else ck["saved"][k]
        want = ck["after"][k][:NQ] if ck["after"][k].ndim else ck["after"][k]
        np.testing.assert_allclose(got[k], want, rtol=2e-4, atol=2e-6,
                                   err_msg=k)
        delta = want - before
        np.testing.assert_allclose(got[k] - before, delta, rtol=5e-3,
                                   atol=5e-3 * np.abs(delta).max(),
                                   err_msg=k)


def test_chunked_or_foreign_msgpack_is_refused(tmp_path):
    import msgpack

    path = str(tmp_path / "chunked.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.packb({"image_syn": {
            "__msgpack_chunked_array__": True, "shape": {"0": 4}}}))
    with pytest.raises(ValueError, match="chunks"):
        checkpoint.read_flax_msgpack(path)
    with open(path, "wb") as f:
        f.write(msgpack.packb({"x": msgpack.ExtType(2, b"\x00")}))
    with pytest.raises(ValueError, match="ext type 2"):
        checkpoint.read_flax_msgpack(path)


def test_read_flax_msgpack_matches_flax(tmp_path):
    """The decoder against flax's own ``from_bytes``, with a bfloat16 leaf
    and a numpy scalar."""
    import flax.serialization
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    tree = {"a": rs.randn(3, 4).astype(np.float32),
            "b": {"c": jnp.asarray(rs.randn(5), jnp.bfloat16),
                  "d": np.float32(1.5), "e": np.arange(4, dtype=np.int64)}}
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        f.write(flax.serialization.to_bytes(tree))
    got = checkpoint.read_flax_msgpack(path)
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(
        got["b"]["c"], np.asarray(tree["b"]["c"], np.float32))
    assert float(got["b"]["d"]) == 1.5
    np.testing.assert_array_equal(got["b"]["e"], tree["b"]["e"])
    assert os.path.getsize(path) > 0
