"""Frozen text tower: a BERT encoder and its CLS embeddings.

Counterpart of ``multimodal_dataset_distillation_tpu/models/bert.py``
(the reference's ``TextEncoder``, ``networks.py:693-737``: HF
``BertModel('bert-base-uncased')``, frozen, CLS row of the last hidden
state).  Its outputs are computed once into the caption caches
(:mod:`..data.textcache`), so the tower runs off the training hot path.

* Post-LN transformer ("original" BERT layout), exact GELU, additive mask
  ``(1 - mask) * -1e9``, LayerNorm eps 1e-12, float32; plain
  ``torch.matmul``/softmax attention, as the JAX module is plain einsum.
* Submodules carry HF ``BertModel`` names (``embeddings.word_embeddings``,
  ``encoder.layer.{i}.attention.self.query``, ...), so a local
  ``bert-base-uncased`` state dict loads with ``load_state_dict`` (pooler
  keys dropped).
* No network: HF weights and vocabulary only from a local cache
  (``transformers`` is imported there and nowhere else); otherwise a
  random init from a seeded ``torch.Generator`` (the reference's
  ``BertModel(BertConfig())`` fallback) and the deterministic
  :class:`HashingTokenizer`, byte for byte the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=4096, hidden_size=128, num_layers=2,
                       num_heads=2, intermediate_size=512,
                       max_position_embeddings=128)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.num_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, add_mask: torch.Tensor) -> torch.Tensor:
        b, n, width = x.shape
        d = width // self.heads

        def heads(t):  # (B, N, H*D) -> (B, H, N, D)
            return t.view(b, n, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5) + add_mask
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return out.transpose(1, 2).reshape(b, n, width)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x: torch.Tensor, add_mask: torch.Tensor) -> torch.Tensor:
        h = self.output.dense(self.self(x, add_mask))
        return self.output.LayerNorm(x + h)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, x: torch.Tensor, add_mask: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, add_mask)
        h = F.gelu(self.intermediate.dense(x))  # exact (erf) GELU
        return self.output.LayerNorm(x + self.output.dense(h))


class _Layers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """-> the last hidden state (B, N, hidden); the caller takes row 0."""

    def __init__(self, cfg: BertConfig = BERT_BASE):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = _Layers(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        add_mask = (1.0 - attention_mask.to(x.dtype))[:, None, None, :] * -1e9
        for layer in self.encoder.layer:
            x = layer(x, add_mask)
        return x


@torch.no_grad()
def init_bert(model: BertEncoder, seed: int = 0) -> BertEncoder:
    """Random init from a seeded CPU generator, HF's rule (``BertConfig``'s
    ``initializer_range`` 0.02): normal(0, 0.02) weights and embeddings,
    the padding row zero, zero biases, unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            w = torch.empty(mod.weight.shape).normal_(0.0, 0.02, generator=gen)
            mod.weight.copy_(w)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    model.embeddings.word_embeddings.weight[model.cfg.pad_token_id].zero_()
    return model


def hf_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``BertModel.state_dict()`` -> this module's: the same names,
    without the pooler and the ``position_ids`` buffer."""
    return {k: v for k, v in sd.items()
            if not k.startswith("pooler.") and k != "embeddings.position_ids"}


# ---------------------------------------------------------------------------
# tokenizers and the frozen tower
# ---------------------------------------------------------------------------

class HashingTokenizer:
    """Deterministic offline tokenizer (whitespace + md5 bucket), the JAX
    package's: CLS=1, SEP=2, PAD=0, ``max_len`` tokens at most."""

    def __init__(self, vocab_size: int, max_len: int = 64):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.cls_id, self.sep_id, self.pad_id = 1, 2, 0

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        def tok(word: str) -> int:
            h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
            return 3 + h % (self.vocab_size - 3)

        rows = []
        for t in texts:
            ids = [self.cls_id] + [tok(w) for w in t.split()][: self.max_len - 2]
            ids.append(self.sep_id)
            rows.append(ids)
        n = max(len(r) for r in rows)
        ids = np.full((len(rows), n), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), n), dtype=np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask


def _try_hf_tokenizer():
    """The ``bert-base-uncased`` tokenizer from a local HF cache, or None."""
    try:
        from transformers import AutoTokenizer

        tk = AutoTokenizer.from_pretrained("bert-base-uncased",
                                           local_files_only=True)
    except (ImportError, OSError, ValueError):
        return None

    def tokenize(texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        enc = tk(list(texts), return_tensors="np", padding=True,
                 truncation=True)
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.int32))

    return tokenize


def _try_hf_weights() -> Optional[Dict[str, torch.Tensor]]:
    """``bert-base-uncased`` weights from a local HF cache, or None."""
    try:
        from transformers import BertModel

        m = BertModel.from_pretrained("bert-base-uncased",
                                      local_files_only=True)
    except (ImportError, OSError, ValueError):
        return None
    return hf_state_dict(m.state_dict())


class TextEncoder:
    """Frozen BERT returning CLS embeddings: tokenizes on the host, encodes
    in chunks on ``device`` under ``inference_mode``."""

    def __init__(self, variant: str = "base", pretrained: bool = True,
                 seed: int = 0, device="cuda"):
        self.cfg = BERT_BASE if variant == "base" else BERT_TINY
        self.device = torch.device(device)
        self.module = BertEncoder(self.cfg)
        sd = _try_hf_weights() if pretrained and variant == "base" else None
        if sd is not None:
            self.module.load_state_dict(sd)
        else:
            init_bert(self.module, seed)
        self.module.to(self.device).eval().requires_grad_(False)
        tok = _try_hf_tokenizer() if variant == "base" else None
        self.tokenize = tok or HashingTokenizer(self.cfg.vocab_size)

    @property
    def hidden_size(self) -> int:
        return self.cfg.hidden_size

    def encode(self, texts: Sequence[str], chunk_size: int = 256) -> np.ndarray:
        """CLS embeddings (len(texts), hidden) float32 for raw strings."""
        out = []
        with torch.inference_mode():
            for i in range(0, len(texts), chunk_size):
                ids, mask = self.tokenize(texts[i : i + chunk_size])
                h = self.module(
                    torch.as_tensor(ids, dtype=torch.long, device=self.device),
                    torch.as_tensor(mask, device=self.device))
                out.append(h[:, 0].float().cpu().numpy())
        if not out:
            return np.zeros((0, self.hidden_size), np.float32)
        return np.concatenate(out, axis=0)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)
