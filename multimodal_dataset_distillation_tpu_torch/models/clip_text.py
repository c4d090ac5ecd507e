"""Frozen CLIP text tower: causal transformer, EOT pooling, projection.

Counterpart of ``multimodal_dataset_distillation_tpu/models/clip_text.py``
(the reference's ``--text_encoder=clip``: OpenAI CLIP ViT-B/32's
``encode_text(clip.tokenize(texts))``, ``networks.py:700-702, 728-731``,
512-d).  Like BERT it is frozen and its outputs are cached once
(:mod:`..data.textcache`), so it runs off the training hot path.

* Token embedding (vocab 49408) plus a learned positional embedding
  (context 77); pre-LN residual blocks with an additive causal mask of
  -1e9 in float32 and QuickGELU; a final LayerNorm; the features at the
  EOT token, ``argmax(input_ids)`` (the first maximum, as ``jnp.argmax``),
  times the (width, embed) ``text_projection``.  Float32; attention is an
  explicit matmul + softmax, as the JAX module's einsums.  The block is
  :class:`ClipBlock`, which the vision tower shares.
* Names follow the JAX tree (``token_embedding``, ``positional_embedding``,
  ``blocks.{i}`` for ``block{i}`` with ``ln_1``, ``attn.{q,k,v,out}_proj``,
  ``ln_2``, ``mlp_fc``, ``mlp_proj``; ``ln_final``, ``text_projection``), so
  :mod:`.convert` carries its weights across by the generic rule.
* No network: HF weights and vocabulary only from a local cache with
  ``local_files_only=True`` (``transformers`` is imported there and
  nowhere else); otherwise a random init from a seeded
  ``torch.Generator`` with the JAX module's initializers and the
  deterministic :class:`ClipHashingTokenizer`, id for id the JAX one's.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.contrastive import softmax
from .layers import dense, layer_norm, trunc_normal_fan_in


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 512
    num_layers: int = 12
    num_heads: int = 8
    context_length: int = 77
    embed_dim: int = 512          # the projected output width
    layer_norm_eps: float = 1e-5


CLIP_TEXT_BASE = ClipTextConfig()
CLIP_TEXT_TINY = ClipTextConfig(vocab_size=4096, width=128, num_layers=2,
                                num_heads=2, context_length=32, embed_dim=128)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    """Multi-head attention with an optional additive mask: logits,
    softmax and the weighted sum in float32, the projections in the
    promoted dtype (flax's einsums with ``preferred_element_type``)."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads

        def heads(layer):   # (B, N, H*D) -> (B, H, N, D), float32
            return dense(x, layer).reshape(b, n, h, c // h).transpose(
                1, 2).float()

        q, k, v = heads(self.q_proj), heads(self.k_proj), heads(self.v_proj)
        scores = (q @ k.transpose(-2, -1)) * (c // h) ** -0.5
        if mask is not None:
            scores = scores + mask
        out = softmax(scores, -1) @ v
        return dense(out.transpose(1, 2).reshape(b, n, c), self.out_proj)


class ClipBlock(nn.Module):
    """Pre-LN residual block with QuickGELU (both CLIP towers)."""

    def __init__(self, width: int, num_heads: int, eps: float):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=eps)
        self.attn = ClipAttention(width, num_heads)
        self.ln_2 = nn.LayerNorm(width, eps=eps)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln_1), mask)
        h = quick_gelu(dense(layer_norm(x, self.ln_2), self.mlp_fc))
        return x + dense(h, self.mlp_proj)


class ClipTextTransformer(nn.Module):
    """input ids (B, N), N <= context -> projected EOT features (B, embed)."""

    def __init__(self, cfg: ClipTextConfig = CLIP_TEXT_BASE):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.width))
        self.blocks = nn.ModuleList(
            ClipBlock(cfg.width, cfg.num_heads, cfg.layer_norm_eps)
            for _ in range(cfg.num_layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.text_projection = nn.Parameter(
            torch.zeros(cfg.width, cfg.embed_dim))
        self.jax_names = {f"blocks.{i}": f"block{i}"
                          for i in range(cfg.num_layers)}

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        b, n = input_ids.shape
        x = self.token_embedding(input_ids) + self.positional_embedding[:n]
        causal = torch.full((n, n), -1e9, dtype=torch.float32,
                            device=x.device).triu(1)
        for block in self.blocks:
            x = block(x, causal)
        x = self.ln_final(x)
        eot = input_ids.argmax(dim=-1)
        return x[torch.arange(b, device=x.device), eot] @ self.text_projection


@torch.no_grad()
def init_clip_text(model: ClipTextTransformer,
                   seed: int = 0) -> ClipTextTransformer:
    """Random init from a seeded CPU generator with the JAX module's
    initializers: flax ``Embed``'s normal(width^-0.5) token embedding,
    normal(0.01) positional embedding and text projection, lecun-normal
    Dense kernels, zero biases, unit LayerNorm scales."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            w = torch.empty(mod.weight.shape)
            trunc_normal_fan_in(w, mod.in_features, 1.0, gen)
            mod.weight.copy_(w)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    cfg = model.cfg
    model.token_embedding.weight.copy_(torch.randn(
        model.token_embedding.weight.shape, generator=gen) * cfg.width ** -0.5)
    for p in (model.positional_embedding, model.text_projection):
        p.copy_(0.01 * torch.randn(p.shape, generator=gen))
    return model


# ---------------------------------------------------------------------------
# tokenizers, HF weights and the frozen tower
# ---------------------------------------------------------------------------

class ClipHashingTokenizer:
    """Deterministic offline tokenizer in the CLIP id layout: SOT =
    vocab - 2 first, EOT = vocab - 1 last (the largest id, so argmax
    pooling finds it), words as 1 + md5 % (vocab - 3), zero padding to the
    context length."""

    def __init__(self, vocab_size: int, context_length: int):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot_id = vocab_size - 2
        self.eot_id = vocab_size - 1

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        def tok(word: str) -> int:
            h = int(hashlib.md5(word.encode()).hexdigest()[:8], 16)
            return 1 + h % (self.vocab_size - 3)

        n = self.context_length
        ids = np.zeros((len(texts), n), dtype=np.int32)
        for i, t in enumerate(texts):
            row = [self.sot_id] + [tok(w) for w in t.split()][: n - 2]
            row.append(self.eot_id)
            ids[i, : len(row)] = row
        return ids


def _try_hf_tokenizer(context_length: int):
    """The ``openai/clip-vit-base-patch32`` tokenizer from a local HF
    cache, or None."""
    try:
        from transformers import CLIPTokenizer

        tk = CLIPTokenizer.from_pretrained("openai/clip-vit-base-patch32",
                                           local_files_only=True)
    except (ImportError, OSError, ValueError):
        return None

    def tokenize(texts: Sequence[str]) -> np.ndarray:
        enc = tk(list(texts), return_tensors="np", padding="max_length",
                 max_length=context_length, truncation=True)
        return enc["input_ids"].astype(np.int32)

    return tokenize


def clip_text_state_dict_from_hf(sd: Dict[str, torch.Tensor],
                                 cfg: ClipTextConfig
                                 ) -> Dict[str, torch.Tensor]:
    """An HF ``CLIPModel.state_dict()``'s text branch -> the state dict of
    :class:`ClipTextTransformer` (renames; HF's ``text_projection`` Linear
    transposed into the (width, embed) matrix)."""
    out = {
        "token_embedding.weight":
            sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding":
            sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].t(),
    }
    names = {"layer_norm1": "ln_1", "layer_norm2": "ln_2",
             "self_attn.q_proj": "attn.q_proj",
             "self_attn.k_proj": "attn.k_proj",
             "self_attn.v_proj": "attn.v_proj",
             "self_attn.out_proj": "attn.out_proj",
             "mlp.fc1": "mlp_fc", "mlp.fc2": "mlp_proj"}
    for i in range(cfg.num_layers):
        for hf, own in names.items():
            for leaf in ("weight", "bias"):
                out[f"blocks.{i}.{own}.{leaf}"] = sd[
                    f"text_model.encoder.layers.{i}.{hf}.{leaf}"]
    return {k: v.detach().float().contiguous() for k, v in out.items()}


def _try_hf_weights(cfg: ClipTextConfig
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """CLIP text weights from a local HF cache, or None."""
    try:
        from transformers import CLIPModel

        m = CLIPModel.from_pretrained("openai/clip-vit-base-patch32",
                                      local_files_only=True)
    except (ImportError, OSError, ValueError):
        return None
    return clip_text_state_dict_from_hf(m.state_dict(), cfg)


class ClipTextEncoder:
    """Frozen CLIP text tower returning projected EOT embeddings: tokenizes
    on the host, encodes in chunks on ``device`` under ``inference_mode``
    (the same interface as :class:`~.bert.TextEncoder`)."""

    def __init__(self, variant: str = "base", pretrained: bool = True,
                 seed: int = 0, device="cuda"):
        self.cfg = CLIP_TEXT_BASE if variant == "base" else CLIP_TEXT_TINY
        self.device = torch.device(device)
        self.module = ClipTextTransformer(self.cfg)
        sd = (_try_hf_weights(self.cfg) if pretrained and variant == "base"
              else None)
        if sd is not None:
            self.module.load_state_dict(sd)
        else:
            init_clip_text(self.module, seed)
        self.module.to(self.device).eval().requires_grad_(False)
        tok = (_try_hf_tokenizer(self.cfg.context_length)
               if variant == "base" else None)
        self.tokenize = tok or ClipHashingTokenizer(self.cfg.vocab_size,
                                                    self.cfg.context_length)

    @property
    def hidden_size(self) -> int:
        return self.cfg.embed_dim

    def encode(self, texts: Sequence[str], chunk_size: int = 256) -> np.ndarray:
        """Projected EOT features (len(texts), embed) float32."""
        out = []
        with torch.inference_mode():
            for i in range(0, len(texts), chunk_size):
                ids = self.tokenize(texts[i : i + chunk_size])
                out.append(self.module(torch.as_tensor(
                    ids, dtype=torch.long, device=self.device)).float().cpu()
                    .numpy())
        if not out:
            return np.zeros((0, self.hidden_size), np.float32)
        return np.concatenate(out, axis=0)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.encode(texts)
