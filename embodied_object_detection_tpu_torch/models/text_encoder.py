"""CLIP text encoder and BPE tokenizer: vocabularies embedded at run time.

Counterpart of the JAX package's `models/text_encoder.py` (ref:
Detic/detic/modeling/text/text_encoder.py, the openai CLIP text tower
that predictor.py:61-65 uses to embed an arbitrary vocabulary): a 49408
token byte-level BPE vocabulary, 77 context positions, 12 residual
blocks of width 512 with 8 heads, causal attention, quick-GELU MLPs,
ln_final and text_projection; the output is the end-of-text token's row
(the largest token id), projected in f32 and L2-normalised. LayerNorms
are the JAX package's (epsilon 1e-6, `layers.LayerNorm`), and the whole
tower runs in f32 with TF32 off (the JAX package's projection is
`Precision.HIGHEST`). Module names mirror the JAX parameter tree, so
`convert/from_jax.py:load_jax_params` carries its weights too.

The weights and the BPE merge table are external files that the
repository does not hold: `load_default_text_encoder` and
`SimpleTokenizer` take explicit paths (or `CLIP_TEXT_WEIGHTS` /
`CLIP_BPE_PATH`) and raise `FileNotFoundError` naming what is missing.
The built-in vocabularies' precomputed embeddings (`data/metadata/*.npy`)
need neither.
"""

from __future__ import annotations

import gzip
import html
import math
import os
import re
from functools import lru_cache
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .layers import LayerNorm

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


# ------------------------------------------------------------- tokenizer

@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """CLIP's byte -> printable unicode character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    """The set of adjacent symbol pairs of `word`."""
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class SimpleTokenizer:
    """CLIP's byte-level BPE tokenizer over the public merge table
    (bpe_simple_vocab_16e6.txt.gz). CLIP's pattern uses \\p{L} / \\p{N}
    (the `regex` module); this one is its stdlib ASCII equivalent, as in
    the JAX package, which agrees on English vocabulary text."""

    def __init__(self, bpe_path: str):
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f"CLIP BPE vocab not found at {bpe_path}; it is the public "
                "bpe_simple_vocab_16e6.txt.gz (openai/CLIP), which this "
                "repository does not hold; use the precomputed embedding "
                ".npy files instead")
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and \
                        word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens = []
        text = html.unescape(html.unescape(text)).strip().lower()
        for token in self.pat.findall(" ".join(text.split())):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def tokenize(self, texts: List[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """[len(texts), context_length] int32: start, the text's tokens
        (cut to fit), end, zeros."""
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text)[: context_length - 2] + [eot]
            out[i, : len(toks)] = toks
        return out


# ------------------------------------------------------------ the tower

class SelfAttention(nn.Module):
    """Multi-head causal self-attention in the JAX package's arithmetic:
    queries divided by sqrt(head_dim), masked logits set to the f32
    minimum."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(width, width))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        h = self.heads
        d = c // h

        def split(y):
            return y.reshape(b, t, h, d).transpose(1, 2)    # [B, h, T, d]

        q = split(self.query(x)) / math.sqrt(d)
        logits = torch.matmul(q, split(self.key(x)).transpose(-2, -1))
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        out = torch.matmul(torch.softmax(logits, dim=-1),
                           split(self.value(x)))
        return self.out(out.transpose(1, 2).reshape(b, t, c))


class ResidualBlock(nn.Module):

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = SelfAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        y = self.mlp_fc(self.ln_2(x))
        return x + self.mlp_proj(y * torch.sigmoid(1.702 * y))  # quick-GELU


class TextTransformer(nn.Module):
    """tokens [B, T] -> [B, width] L2-normalised embeddings of the
    end-of-text rows."""

    def __init__(self, width: int = 512, layers: int = 12, heads: int = 8):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Embedding(VOCAB_SIZE, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(CONTEXT_LENGTH, width))
        for i in range(layers):
            self.add_module(f"resblock{i}", ResidualBlock(width, heads))
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.zeros(width, width))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """f32 with TF32 off for the call, whatever the caller set: the
        JAX package's projection is `Precision.HIGHEST`."""
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._embed(tokens)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        causal = torch.ones((t, t), dtype=torch.bool,
                            device=tokens.device).tril()
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)          # the end token has the top id
        feats = x[torch.arange(b, device=tokens.device), eot] @ \
            self.text_projection
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def text_tower_shape(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """(width, layers) of a converted state dict, as keyword arguments of
    `TextTransformer` (8 heads, as the JAX package's converter has)."""
    layers = 0
    while f"resblock{layers}.ln_1.weight" in state_dict:
        layers += 1
    return dict(width=state_dict["positional_embedding"].shape[1],
                layers=layers)


class CLIPTextEncoder:
    """Callable: list of texts -> [B, width] f32 L2-normalised embeddings
    (numpy), the tower on `device` (the card unless the caller asks for
    the CPU) in f32 with TF32 off, `batch` texts a forward."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], bpe_path: str,
                 device: "torch.device | str" = "cuda", batch: int = 256):
        from .detector import resolve_device
        self.tokenizer = SimpleTokenizer(bpe_path)
        self.device = resolve_device(device)
        self.model = TextTransformer(**text_tower_shape(state_dict))
        self.model.load_state_dict(dict(state_dict))
        self.model.to(self.device).eval()
        self.batch = batch

    @torch.no_grad()
    def embed_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """[B, T] token ids -> [B, width] embeddings on the device."""
        t = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        return torch.cat([self.model(t[i:i + self.batch])
                          for i in range(0, t.shape[0], self.batch)])

    def __call__(self, texts: List[str]) -> np.ndarray:
        return self.embed_tokens(self.tokenizer.tokenize(texts)).cpu().numpy()


def convert_clip_text_weights(state_dict: Mapping[str, np.ndarray]
                              ) -> Dict[str, torch.Tensor]:
    """openai CLIP state dict (its text tower's keys; tensors or numpy)
    -> `TextTransformer`'s state dict. PyTorch layouts are kept: the
    fused in_proj rows split into query, key and value."""
    def t(name):
        v = state_dict[name]
        return (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).float()

    out = {"token_embedding.weight": t("token_embedding.weight"),
           "positional_embedding": t("positional_embedding"),
           "text_projection": t("text_projection"),
           "ln_final.weight": t("ln_final.weight"),
           "ln_final.bias": t("ln_final.bias")}
    width = out["positional_embedding"].shape[1]
    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in state_dict:
        pre, blk = f"transformer.resblocks.{i}", f"resblock{i}"
        for ln in ("ln_1", "ln_2"):
            out[f"{blk}.{ln}.weight"] = t(f"{pre}.{ln}.weight")
            out[f"{blk}.{ln}.bias"] = t(f"{pre}.{ln}.bias")
        wqkv = t(f"{pre}.attn.in_proj_weight")           # [3w, w]
        bqkv = t(f"{pre}.attn.in_proj_bias")
        for j, nm in enumerate(("query", "key", "value")):
            out[f"{blk}.attn.{nm}.weight"] = wqkv[j * width:(j + 1) * width]
            out[f"{blk}.attn.{nm}.bias"] = bqkv[j * width:(j + 1) * width]
        out[f"{blk}.attn.out.weight"] = t(f"{pre}.attn.out_proj.weight")
        out[f"{blk}.attn.out.bias"] = t(f"{pre}.attn.out_proj.bias")
        out[f"{blk}.mlp_fc.weight"] = t(f"{pre}.mlp.c_fc.weight")
        out[f"{blk}.mlp_fc.bias"] = t(f"{pre}.mlp.c_fc.bias")
        out[f"{blk}.mlp_proj.weight"] = t(f"{pre}.mlp.c_proj.weight")
        out[f"{blk}.mlp_proj.bias"] = t(f"{pre}.mlp.c_proj.bias")
        i += 1
    return out


def load_default_text_encoder(weights_path: Optional[str] = None,
                              bpe_path: Optional[str] = None,
                              device: "torch.device | str" = "cuda"
                              ) -> CLIPTextEncoder:
    """The encoder from a CLIP checkpoint (`weights_path`, else
    `CLIP_TEXT_WEIGHTS`) and the merge table (`bpe_path`, else
    `CLIP_BPE_PATH`, else datasets/metadata/bpe_simple_vocab_16e6.txt.gz).
    Raises `FileNotFoundError` naming what is missing."""
    weights_path = weights_path or os.environ.get("CLIP_TEXT_WEIGHTS", "")
    bpe_path = bpe_path or os.environ.get(
        "CLIP_BPE_PATH", "datasets/metadata/bpe_simple_vocab_16e6.txt.gz")
    if not weights_path or not os.path.exists(weights_path):
        raise FileNotFoundError(
            "CLIP text-encoder weights not available"
            + (f" at {weights_path}" if weights_path else "") +
            "; set CLIP_TEXT_WEIGHTS to a CLIP checkpoint (.pth) or use "
            "precomputed vocabulary embeddings (datasets/metadata/*.npy)")
    sd = torch.load(weights_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return CLIPTextEncoder(convert_clip_text_weights(sd), bpe_path, device)
