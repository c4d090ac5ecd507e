"""Port parity: the caption caches against the JAX package's textcache.

Both packages' ``textprocess`` / ``textprocess_train`` run on the same
synthetic split with the same tiny BERT weights (the JAX init carried
across): the same file names, the same ``bert_test_embed`` key, the same
embeddings (rtol 1e-5, float32).  A cache either package wrote is read by
the other's ``load_or_process_file`` without recomputing it.
"""

import os

import numpy as np
import pytest

from multimodal_dataset_distillation_tpu.config import Config as JConfig
from multimodal_dataset_distillation_tpu.data import get_dataset as jget
from multimodal_dataset_distillation_tpu.data import textcache as jtc
from multimodal_dataset_distillation_tpu.models import bert as jbert
from multimodal_dataset_distillation_tpu_torch.cli.buffer import (
    make_caption_lookup,
)
from multimodal_dataset_distillation_tpu_torch.config import Config
from multimodal_dataset_distillation_tpu_torch.data import get_dataset
from multimodal_dataset_distillation_tpu_torch.data import textcache
from multimodal_dataset_distillation_tpu_torch.models import bert
from multimodal_dataset_distillation_tpu_torch.models.convert import (
    bert_state_dict_from_jax,
)
from test_torch_threads import share_cores  # noqa: F401 (autouse)

KW = dict(dataset="synthetic", image_size=16, synthetic_size=6,
          synthetic_test_size=3, text_encoder_config="tiny",
          text_pretrained=False, native_decode=False, batch_size_test=2,
          num_workers=0, seed=1)


@pytest.fixture(scope="module")
def towers():
    jenc = jbert.TextEncoder(variant="tiny", pretrained=False, seed=2)
    enc = textcache.make_text_encoder(Config(**KW, device="cpu"))
    enc.module.load_state_dict(bert_state_dict_from_jax(
        jenc.variables["params"]))
    return jenc, enc


def _files(d):
    return sorted(os.listdir(d))


def test_textprocess_writes_the_jax_files(tmp_path, towers):
    jenc, enc = towers
    cfg, jcfg = Config(**KW, device="cpu"), JConfig(**KW)
    _, testloader, train_ds, _ = get_dataset(cfg)
    _, jtestloader, jtrain_ds, _ = jget(jcfg)
    assert testloader.dataset.text == jtestloader.dataset.text
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for fn, jfn, args, jargs in (
            (textcache.textprocess, jtc.textprocess, testloader,
             jtestloader),
            (textcache.textprocess_train, jtc.textprocess_train,
             train_ds.get_all_captions(), jtrain_ds.get_all_captions())):
        got = fn(cfg, args, encoder=enc, cache_dir=str(tmp_path / "port"))
        want = jfn(jcfg, jargs, encoder=jenc, cache_dir=str(tmp_path / "jax"))
        assert os.path.basename(got) == os.path.basename(want)
        with np.load(got) as a, np.load(want) as b:
            assert list(a) == list(b) == ["bert_test_embed"]
            assert a["bert_test_embed"].dtype == np.float32
            np.testing.assert_allclose(a["bert_test_embed"],
                                       b["bert_test_embed"], rtol=1e-5,
                                       atol=1e-5)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "synthetic_bert_text_embed.npz",
        "synthetic_bert_train_text_embed.npz"]


def _refuse(*a, **k):
    raise AssertionError("the cache exists: nothing to compute")


def test_caches_cross_packages(tmp_path, towers):
    """A JAX-written cache is loaded by the port, and the reverse; the
    port's caption lookup reads the train cache by caption."""
    jenc, enc = towers
    cfg, jcfg = Config(**KW, device="cpu"), JConfig(**KW)
    _, jtestloader, jtrain_ds, _ = jget(jcfg)
    _, testloader, train_ds, _ = get_dataset(cfg)
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    os.makedirs(jdir)
    os.makedirs(pdir)
    jtc.textprocess(jcfg, jtestloader, encoder=jenc, cache_dir=jdir)
    jtc.textprocess_train(jcfg, jtrain_ds.get_all_captions(), encoder=jenc,
                          cache_dir=jdir)
    textcache.textprocess(cfg, testloader, encoder=enc, cache_dir=pdir)
    for src, load in ((jdir, textcache.load_or_process_file),
                      (pdir, jtc.load_or_process_file)):
        with np.load(os.path.join(src, "synthetic_bert_text_embed.npz")) as f:
            want = f["bert_test_embed"]
        got = load("text", _refuse, cfg if src == jdir else jcfg, None,
                   cache_dir=src)
        np.testing.assert_array_equal(got["bert_test_embed"], want)
    lookup, embed, sentences = make_caption_lookup(train_ds, cfg,
                                                   cache_dir=jdir)
    assert sentences == jtrain_ds.get_all_captions()
    np.testing.assert_array_equal(lookup(sentences[::-1]), embed[::-1])


def test_missing_train_cache_is_computed(tmp_path, towers, capsys):
    _, enc = towers
    cfg = Config(**KW, device="cpu")
    _, _, train_ds, _ = get_dataset(cfg)
    lookup, embed, sentences = make_caption_lookup(
        train_ds, cfg, cache_dir=str(tmp_path), encoder=enc)
    assert "Processing" in capsys.readouterr().out
    np.testing.assert_array_equal(embed, enc.encode(sentences))
    assert embed.shape == (6, 128)


def test_clip_text_caches_match_jax(tmp_path):
    """``--text_encoder=clip``: ``make_text_encoder`` builds the frozen CLIP
    text tower (the tiny one here, the JAX init carried across), and both
    caches come out under the JAX package's names with its embeddings."""
    from multimodal_dataset_distillation_tpu.models import clip_text as jct
    from multimodal_dataset_distillation_tpu_torch.models import clip_text
    from multimodal_dataset_distillation_tpu_torch.models.convert import (
        params_from_jax,
    )

    kw = {**KW, "text_encoder": "clip"}
    cfg, jcfg = Config(**kw, device="cpu"), JConfig(**kw)
    enc = textcache.make_text_encoder(cfg)
    assert isinstance(enc, clip_text.ClipTextEncoder)
    assert enc.hidden_size == 128
    jenc = jtc.make_text_encoder(jcfg)
    enc.module.load_state_dict(params_from_jax(jenc.variables["params"],
                                               enc.module))
    _, testloader, train_ds, _ = get_dataset(cfg)
    _, jtestloader, jtrain_ds, _ = jget(jcfg)
    (tmp_path / "j").mkdir()
    for fn, jfn, args, jargs in (
            (textcache.textprocess, jtc.textprocess, testloader,
             jtestloader),
            (textcache.textprocess_train, jtc.textprocess_train,
             train_ds.get_all_captions(), jtrain_ds.get_all_captions())):
        got = fn(cfg, args, encoder=enc, cache_dir=str(tmp_path))
        want = jfn(jcfg, jargs, encoder=jenc, cache_dir=str(tmp_path / "j"))
        assert os.path.basename(got) == os.path.basename(want)
        with np.load(got) as a, np.load(want) as b:
            assert a["bert_test_embed"].shape[1] == 128
            np.testing.assert_allclose(a["bert_test_embed"],
                                       b["bert_test_embed"], rtol=1e-5,
                                       atol=1e-5)
    assert _files(tmp_path / "j") == ["synthetic_clip_text_embed.npz",
                                      "synthetic_clip_train_text_embed.npz"]
    assert bert.BERT_TINY.hidden_size == 128
