"""Whisper-style encoder-decoder (audio family).

Port of repro/models/encdec.py. The conv frontend is a stub: callers
give precomputed frame embeddings (B, enc_seq, D); the transformer
backbone (bidirectional encoder, causal decoder with cross-attention,
LayerNorm, GELU MLP, learned absolute positions) is real. JAX's stacked
`enc_layers` / `dec_layers` are `nn.ModuleList`s here; in training each
encoder and decoder layer runs under activation checkpointing, as JAX's
scan bodies do (`transformer.remat`).

Serving cache: {"k", "v": (n_layers, B, L, d), "enc_out": (B, Se, d),
"pos": int}; a step writes ``k`` and ``v`` in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import (
    Key,
    Params,
    additive_mask,
    dense_init,
    gelu_mlp,
    init_gelu_mlp,
    layernorm,
    load_tree,
    make_generator,
    normal,
    to_numpy,
    to_tensor,
    torch_dtype,
    unstack,
    write_along_seq,
    zeros,
)
from repro_torch.models.transformer import remat

DEC_POS = 448 * 128  # rows of the learned decoder position table


def _init_mha(gen, d: int, dtype) -> Params:
    return Params(
        wq=dense_init(gen, d, d, dtype), bq=zeros(gen, (d,), dtype),
        wk=dense_init(gen, d, d, dtype),
        wv=dense_init(gen, d, d, dtype), bv=zeros(gen, (d,), dtype),
        wo=dense_init(gen, d, d, dtype), bo=zeros(gen, (d,), dtype),
    )


def _mha(p, xq, xkv, n_heads: int, mask=None):
    b, s, d = xq.shape
    l = xkv.shape[1]
    dh = d // n_heads
    q = (xq @ p.wq.to(xq.dtype) + p.bq).reshape(b, s, n_heads, dh)
    k = (xkv @ p.wk.to(xq.dtype)).reshape(b, l, n_heads, dh)
    v = (xkv @ p.wv.to(xq.dtype) + p.bv).reshape(b, l, n_heads, dh)
    return _attend(p, q, k, v, mask, b, s, d)


def _attend(p, q, k, v, mask, b, s, d):
    dh = q.shape[-1]
    logits = torch.einsum("bshd,blhd->bhsl", q.float(), k.float()) / dh ** 0.5
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhsl,blhd->bshd", probs.to(v.dtype), v).reshape(b, s, d)
    return out @ p.wo.to(out.dtype) + p.bo


def _init_ln(gen, d, dtype) -> Params:
    return Params(w=torch.ones(d, dtype=dtype, device=gen.device), b=zeros(gen, (d,), dtype))


def _ln(p, x):
    return layernorm(x, p.w, p.b)


class EncLayer(Params):
    def __init__(self, gen, cfg: ArchConfig, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _init_ln(gen, d, dtype)
        self.attn = _init_mha(gen, d, dtype)
        self.ln2 = _init_ln(gen, d, dtype)
        self.mlp = init_gelu_mlp(gen, d, cfg.d_ff, dtype)


class DecLayer(Params):
    def __init__(self, gen, cfg: ArchConfig, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _init_ln(gen, d, dtype)
        self.self_attn = _init_mha(gen, d, dtype)
        self.ln_x = _init_ln(gen, d, dtype)
        self.cross_attn = _init_mha(gen, d, dtype)
        self.ln2 = _init_ln(gen, d, dtype)
        self.mlp = init_gelu_mlp(gen, d, cfg.d_ff, dtype)


class EncDec(Params):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32):
        d = cfg.d_model
        super().__init__(
            enc_pos=normal(gen, (cfg.enc_dec.enc_seq, d), 0.01, dtype),
            embed=normal(gen, (cfg.vocab, d), 0.02, dtype),
            dec_pos=normal(gen, (DEC_POS, d), 0.01, dtype),
        )
        self.enc_layers = nn.ModuleList(
            EncLayer(gen, cfg, dtype) for _ in range(cfg.enc_dec.n_enc_layers))
        self.enc_ln = _init_ln(gen, d, dtype)
        self.dec_layers = nn.ModuleList(DecLayer(gen, cfg, dtype) for _ in range(cfg.n_layers))
        self.dec_ln = _init_ln(gen, d, dtype)
        self.cfg = cfg


def init_encdec(cfg: ArchConfig, key: Key = 0, dtype=torch.float32, device=None) -> EncDec:
    return EncDec(cfg, make_generator(key, device), dtype)


def encode(model: EncDec, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames: precomputed conv-frontend embeddings (B, Se, D) [stub]."""
    x = frames + model.enc_pos[None, :frames.shape[1]].to(frames.dtype)

    def body(x, lp):
        h = _ln(lp.ln1, x)
        x = x + _mha(lp.attn, h, h, cfg.n_heads)
        h = _ln(lp.ln2, x)
        return x + gelu_mlp(lp.mlp, h)

    for lp in model.enc_layers:
        x = remat(body, x, lp)
    return _ln(model.enc_ln, x)


def _dec_logits(model: EncDec, x) -> torch.Tensor:
    x = _ln(model.dec_ln, x)
    return (x @ model.embed.T.to(x.dtype)).float()


def decode_train(model: EncDec, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Teacher-forced decoder. tokens: (B, S) -> logits (B, S, V)."""
    s = tokens.shape[1]
    x = F.embedding(tokens, model.embed) + model.dec_pos[None, :s].to(model.embed.dtype)
    ar = torch.arange(s, device=x.device)
    causal = additive_mask(ar[None, :] <= ar[:, None])[None, None]

    def body(x, lp, enc_out):
        h = _ln(lp.ln1, x)
        x = x + _mha(lp.self_attn, h, h, cfg.n_heads, causal)
        h = _ln(lp.ln_x, x)
        x = x + _mha(lp.cross_attn, h, enc_out, cfg.n_heads)
        h = _ln(lp.ln2, x)
        return x + gelu_mlp(lp.mlp, h)

    for lp in model.dec_layers:
        x = remat(body, x, lp, enc_out)
    return _dec_logits(model, x)


def encdec_forward(model: EncDec, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    return decode_train(model, batch["tokens"], encode(model, batch["frames"], cfg), cfg)


# --------------------------------------------------------------- serving
def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> Dict:
    d, n = cfg.d_model, cfg.n_layers
    return {
        "k": torch.zeros((n, batch, max_len, d), dtype=dtype, device=device),
        "v": torch.zeros((n, batch, max_len, d), dtype=dtype, device=device),
        "enc_out": torch.zeros((batch, cfg.enc_dec.enc_seq, d), dtype=dtype, device=device),
        "pos": 0,
    }


def encdec_prefill(model: EncDec, batch: Dict, cfg: ArchConfig, cache: Dict):
    """Encode the audio and teacher-force the prompt tokens into the KV
    cache; returns the last position's logits (B, 1, V)."""
    enc_out = encode(model, batch["frames"], cfg)
    cache = dict(cache, enc_out=enc_out.to(cache["enc_out"].dtype))
    logits, cache = _dec_steps(model, batch["tokens"], cfg, cache)
    return logits[:, -1:], cache


def encdec_decode_step(model: EncDec, tokens: torch.Tensor, cfg: ArchConfig, cache: Dict):
    return _dec_steps(model, tokens, cfg, cache)


def _dec_steps(model: EncDec, tokens, cfg: ArchConfig, cache):
    b, s = tokens.shape
    d = cfg.d_model
    dh = d // cfg.n_heads
    pos0 = cache["pos"]
    start = min(max(pos0, 0), DEC_POS - s)  # dynamic_slice clamps its start
    x = F.embedding(tokens, model.embed) + model.dec_pos[start:start + s][None].to(
        model.embed.dtype)
    enc_out = cache["enc_out"]
    l = cache["k"].shape[2]
    qpos = pos0 + torch.arange(s, device=x.device)[:, None]
    mask = additive_mask(torch.arange(l, device=x.device)[None, :] <= qpos)[None, None]

    for i, lp in enumerate(model.dec_layers):
        sa = lp.self_attn
        h = _ln(lp.ln1, x)
        # append this step's self-attention k and v
        k_all = write_along_seq(cache["k"][i], h @ sa.wk.to(h.dtype), pos0)
        v_all = write_along_seq(cache["v"][i], h @ sa.wv.to(h.dtype) + sa.bv, pos0)
        q = (h @ sa.wq.to(h.dtype) + sa.bq).reshape(b, s, cfg.n_heads, dh)
        x = x + _attend(sa, q, k_all.reshape(b, l, cfg.n_heads, dh),
                        v_all.reshape(b, l, cfg.n_heads, dh), mask, b, s, d)
        h = _ln(lp.ln_x, x)
        x = x + _mha(lp.cross_attn, h, enc_out.to(h.dtype), cfg.n_heads)
        h = _ln(lp.ln2, x)
        x = x + gelu_mlp(lp.mlp, h)
    return _dec_logits(model, x), dict(cache, pos=pos0 + s)


# ------------------------------------------------------------ carry-over
def encdec_params_from_jax(cfg: ArchConfig, params_np: Dict, device=None) -> EncDec:
    """An `EncDec` holding the weights of `repro.models.encdec.init_encdec`'s
    output, given as numpy arrays (its stacked `enc_layers` / `dec_layers`
    unstacked into the module lists)."""
    model = init_encdec(cfg, 0, torch_dtype(params_np["embed"]), device)
    tree = dict(params_np)
    tree["enc_layers"] = unstack(params_np["enc_layers"], cfg.enc_dec.n_enc_layers)
    tree["dec_layers"] = unstack(params_np["dec_layers"], cfg.n_layers)
    load_tree(model, tree)
    return model


def encdec_jax_path(name: str) -> Tuple[Tuple, Optional[int]]:
    """The JAX pytree path of the port parameter ``name`` and, for a leaf
    of the stacked `enc_layers` / `dec_layers`, its layer index."""
    parts = tuple(name.split("."))
    if parts[0] in ("enc_layers", "dec_layers"):
        return (parts[0],) + parts[2:], int(parts[1])
    return parts, None


def encdec_cache_from_jax(cache_np: Dict, device=None) -> Dict:
    return {k: int(np.asarray(v)) if k == "pos" else to_tensor(v, device)
            for k, v in cache_np.items()}


def encdec_cache_to_numpy(cache: Dict) -> Dict:
    return {k: to_numpy(v) for k, v in cache.items()}
