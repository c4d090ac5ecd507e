"""Port parity: the frozen CLIP text tower against the JAX package's
``models/clip_text.py``.

The hashing tokenizer id for id; the tower at the tiny width (weights of
the JAX init carried across by ``models/convert.params_from_jax``) to
1e-5; the base configuration's published sizes; the encode pipeline
(tokenize, chunk, float32 numpy) whatever the chunking; the seeded random
init and the quiet HF lookup; and the HF-format import from a toy
``transformers.CLIPModel`` held against HF's own ``get_text_features`` and
against the JAX package's ``clip_text_params_from_hf_state_dict``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_dataset_distillation_tpu.models import clip_text as jct
from multimodal_dataset_distillation_tpu_torch.models import clip_text
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    params_from_jax,
)

from test_torch_zoo import assert_close
from test_torch_threads import share_cores  # noqa: F401 (autouse)

CAPTIONS = ["a dog runs on the beach", "two people ride bikes",
            "", "a very long caption " * 20, "A DOG runs"]


@pytest.mark.parametrize("vocab,context", [(49408, 77), (4096, 32), (99, 8)])
def test_hashing_tokenizer_is_the_jax_one(vocab, context):
    got = clip_text.ClipHashingTokenizer(vocab, context)(CAPTIONS)
    want = jct.ClipHashingTokenizer(vocab, context)(CAPTIONS)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got.argmax(-1) == [int(np.flatnonzero(r == vocab - 1)[0])
                               for r in got]).all()


def test_configs_are_the_jax_ones():
    for a, b in ((clip_text.CLIP_TEXT_BASE, jct.CLIP_TEXT_BASE),
                 (clip_text.CLIP_TEXT_TINY, jct.CLIP_TEXT_TINY)):
        assert vars(a) == vars(b)
    base = clip_text.ClipTextTransformer(clip_text.CLIP_TEXT_BASE)
    shapes = jax.eval_shape(lambda: jct.ClipTextTransformer(
        jct.CLIP_TEXT_BASE).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 77), jnp.int32)))
    assert sum(p.numel() for p in base.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    x = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(clip_text.quick_gelu(x).numpy(),
                               np.asarray(jct.quick_gelu(x.numpy())),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX encoder, the port's encoder with its weights)."""
    jenc = jct.ClipTextEncoder(variant="tiny", pretrained=False, seed=3)
    enc = clip_text.ClipTextEncoder(variant="tiny", pretrained=False,
                                    seed=0, device="cpu")
    enc.module.load_state_dict(params_from_jax(jenc.variables["params"],
                                               enc.module))
    return jenc, enc


def test_tiny_tower_matches_jax(tiny_pair):
    """The tower on ids whose EOT is not last (padding after it), 1e-5."""
    jenc, enc = tiny_pair
    ids = enc.tokenize(CAPTIONS)
    want = np.asarray(jenc.module.apply(jenc.variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = enc.module(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (len(CAPTIONS), 128)
    assert_close(got, want, rtol=1e-5, floor=1e-5)


def test_encode_matches_jax(tiny_pair):
    jenc, enc = tiny_pair
    want = jenc.encode(CAPTIONS)
    for chunk in (256, 2):
        got = enc.encode(CAPTIONS, chunk_size=chunk)
        assert got.dtype == np.float32 and got.shape == (len(CAPTIONS), 128)
        assert_close(got, want, rtol=1e-5, floor=1e-5)
    assert enc.hidden_size == jenc.hidden_size == 128
    assert enc.encode([]).shape == (0, 128)


def test_random_init_is_seeded_and_frozen(monkeypatch):
    """Offline: a random init from the seed with the JAX initializers'
    scales, the hashing tokenizer, frozen; without ``transformers`` (as on
    the card's machine) the base tower falls back quietly too."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    a = clip_text.ClipTextEncoder("base", pretrained=True, seed=5,
                                  device="cpu")
    torch.manual_seed(123)
    b = clip_text.ClipTextEncoder("base", pretrained=True, seed=5,
                                  device="cpu")
    assert isinstance(a.tokenize, clip_text.ClipHashingTokenizer)
    assert a.tokenize.context_length == 77 and a.hidden_size == 512
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(p.requires_grad for p in a.module.parameters())
    assert abs(float(sa["token_embedding.weight"].std()) - 512 ** -0.5) \
        < 1e-3
    for k in ("positional_embedding", "text_projection"):
        assert abs(float(sa[k].std()) - 0.01) < 1e-3
    w = sa["blocks.0.attn.q_proj.weight"]
    assert abs(float(w.std()) - 512 ** -0.5) < 2e-3
    np.testing.assert_array_equal(a.encode(CAPTIONS[:2]),
                                  b.encode(CAPTIONS[:2]))


def test_clip_text_import_from_real_hf_model():
    transformers = pytest.importorskip("transformers")
    vocab = 99
    text_cfg = transformers.CLIPTextConfig(
        vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=16, eos_token_id=vocab - 1,
        bos_token_id=vocab - 2, hidden_act="quick_gelu")
    vision_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=64, image_size=32, patch_size=16,
        hidden_act="quick_gelu")
    torch.manual_seed(1)
    hf = transformers.CLIPModel(transformers.CLIPConfig(
        text_config=text_cfg.to_dict(), vision_config=vision_cfg.to_dict(),
        projection_dim=24)).eval()
    cfg = clip_text.ClipTextConfig(vocab_size=vocab, width=32, num_layers=2,
                                   num_heads=2, context_length=16,
                                   embed_dim=24)
    tower = clip_text.ClipTextTransformer(cfg)
    tower.load_state_dict(clip_text.clip_text_state_dict_from_hf(
        hf.state_dict(), cfg))
    # the JAX mapping of the same state dict, carried across
    jcfg = jct.ClipTextConfig(vocab_size=vocab, width=32, num_layers=2,
                              num_heads=2, context_length=16, embed_dim=24)
    jv = jct.clip_text_params_from_hf_state_dict(hf.state_dict(), jcfg)
    want_sd = params_from_jax(jv["params"], tower)
    for k, p in tower.state_dict().items():
        torch.testing.assert_close(p, want_sd[k], rtol=0, atol=0, msg=k)
    # ids whose EOS (vocab - 1) is the unique largest id: HF pools at the
    # EOS position, the tower at the argmax
    ids = np.random.RandomState(2).randint(1, vocab - 2, size=(3, 10))
    ids[:, 0], ids[:, -1] = vocab - 2, vocab - 1
    ids_t = torch.from_numpy(ids).long()
    with torch.no_grad():
        want = hf.get_text_features(input_ids=ids_t).numpy()
        got = tower(ids_t).numpy()
    assert_close(got, want, rtol=1e-4, floor=1e-5)
