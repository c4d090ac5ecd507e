"""Port parity: the BERT text tower against the JAX package's.

The same weights on both sides (the JAX init carried across with
``models/convert.bert_state_dict_from_jax``), the same token ids from
seeded numpy draws.  Tolerances (float32 on the CPU): CLS rows rtol 1e-5
at ``BERT_TINY`` (2 layers), 1e-4 at ``BERT_BASE`` (12 layers, 768 wide).
The hashing tokenizer is held byte for byte.  A toy ``transformers``
``BertModel``'s own state dict loads by name and matches HF's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.models import bert as jbert
from multimodal_dataset_distillation_tpu_torch.models import bert
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    bert_state_dict_from_jax,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

CAPTIONS = [
    "a dog runs on the beach",
    "two people ride bicycles down a narrow street in the rain",
    "red",
    "",
    " ".join(f"word{i}" for i in range(80)),  # truncated at max_len
    "a  cat   sits\ton a mat",
]


def _jax_encoder(cfg, seed=0, n=8):
    module = jbert.BertEncoder(cfg)
    dummy = jnp.zeros((1, n), jnp.int32)
    variables = module.init(jax.random.PRNGKey(seed), dummy,
                            jnp.ones_like(dummy))
    return module, variables


def _port_encoder(cfg, variables):
    model = bert.BertEncoder(cfg)
    model.load_state_dict(bert_state_dict_from_jax(variables["params"]))
    return model.eval()


def _ids(cfg, b, n, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, cfg.vocab_size, size=(b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    for i in range(1, b):  # ragged rows: padded tails of several lengths
        keep = max(2, n - 3 * i)
        ids[i, keep:], mask[i, keep:] = 0, 0
    return ids, mask


@pytest.mark.parametrize("vocab,max_len", [(4096, 64), (30522, 64),
                                           (100, 8)])
def test_hashing_tokenizer_is_the_jax_one(vocab, max_len):
    got = bert.HashingTokenizer(vocab, max_len)(CAPTIONS)
    want = jbert.HashingTokenizer(vocab, max_len)(CAPTIONS)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    ids, mask = got
    assert (ids[:, 0] == 1).all() and ids.shape[1] <= max_len
    assert ((ids == 0) == (mask == 0)).all()


def test_bert_tiny_matches_jax():
    cfg = jbert.BERT_TINY
    module, variables = _jax_encoder(cfg)
    model = _port_encoder(bert.BERT_TINY, variables)
    ids, mask = _ids(cfg, 5, 20)
    want = np.asarray(module.apply(variables, ids, mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-5)
    for i in range(5):  # every unmasked position, not only CLS
        v = mask[i].astype(bool)
        np.testing.assert_allclose(got[i, v], want[i, v], rtol=1e-5,
                                   atol=1e-5)


def test_bert_base_matches_jax():
    cfg = jbert.BERT_BASE
    module, variables = _jax_encoder(cfg, seed=1)
    model = _port_encoder(bert.BERT_BASE, variables)
    ids, mask = jbert.HashingTokenizer(cfg.vocab_size)(CAPTIONS[:3] + [
        "a small boat on a lake"])
    want = np.asarray(module.apply(variables, ids, mask))[:, 0]
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask))[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_text_encoder_encode_matches_jax():
    """The encode pipeline (tokenize, chunk, CLS, float32 numpy) with the
    JAX tower's weights: the same embeddings, whatever the chunking."""
    jenc = jbert.TextEncoder(variant="tiny", pretrained=False, seed=3)
    enc = bert.TextEncoder(variant="tiny", pretrained=False, seed=0,
                           device="cpu")
    enc.module.load_state_dict(bert_state_dict_from_jax(
        jenc.variables["params"]))
    want = jenc.encode(CAPTIONS)
    for chunk in (256, 2):
        got = enc.encode(CAPTIONS, chunk_size=chunk)
        assert got.dtype == np.float32 and got.shape == (len(CAPTIONS), 128)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert enc.hidden_size == jenc.hidden_size == 128
    assert enc.encode([]).shape == (0, 128)


def test_text_encoder_random_init_is_seeded():
    """Offline the tower is a random init from the seed (a torch.Generator,
    not the global stream) with the hashing tokenizer; frozen."""
    a = bert.TextEncoder("tiny", pretrained=False, seed=5, device="cpu")
    torch.manual_seed(123)
    b = bert.TextEncoder("tiny", pretrained=False, seed=5, device="cpu")
    c = bert.TextEncoder("tiny", pretrained=False, seed=6, device="cpu")
    sa, sb, sc = (m.module.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.layer.0.attention.self.query.weight"],
                           sc["encoder.layer.0.attention.self.query.weight"])
    assert isinstance(a.tokenize, bert.HashingTokenizer)
    assert not any(p.requires_grad for p in a.module.parameters())
    w = sa["embeddings.word_embeddings.weight"]
    assert float(w[0].abs().max()) == 0.0 and abs(float(w.std()) - 0.02) < 2e-3
    np.testing.assert_array_equal(a.encode(CAPTIONS), b.encode(CAPTIONS))


def test_hf_state_dict_loads_by_name():
    """A real ``transformers.BertModel`` (toy size) state dict loads with
    ``load_state_dict`` under HF names, pooler dropped, and the port
    gives HF's own ``last_hidden_state[:, 0]``."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()  # with its pooler
    cfg = bert.BertConfig(vocab_size=256, hidden_size=64, num_layers=2,
                          num_heads=2, intermediate_size=128,
                          max_position_embeddings=64)
    model = bert.BertEncoder(cfg)
    model.load_state_dict(bert.hf_state_dict(hf.state_dict()))  # strict
    ids, mask = _ids(cfg, 3, 12, seed=1)
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        want = hf(input_ids=t_ids, attention_mask=t_mask.long()
                  ).last_hidden_state[:, 0].numpy()
        got = model(t_ids, t_mask)[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
