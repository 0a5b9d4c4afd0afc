"""Decoder-only LM for every decoder family (dense, vlm, moe, ssm, hybrid;
MLA layers).

Port of repro/models/transformer.py. JAX stacks the
uniform tail of the layer stack and scans it (with remat); here every
layer is a `Block` in an `nn.ModuleList`, looped in Python, in
`layer_kinds` order (the head layers, then the tail's units unrolled).
Where grad is enabled and no cache is given (training), each tail unit
(one layer, or a hybrid's period) runs under activation checkpointing,
as JAX's `jax.checkpoint(nothing_saveable)` scan body does: this changes
memory, not values. The head layers are not checkpointed.
Caches follow the same order: ``{"layers": [one cache dict per layer]}``,
each with its own ``pos``, as each of JAX's per-layer caches has.
On a mesh (``mesh=``, a process mesh of `launch.mesh`) each rank runs
its own rows: MoE layers take the expert-parallel path, and with
``REPRO_LONG_ATTN=sharded`` long-context decode takes the sharded CSR
window attention over this rank's slice of the cache.
A config with a per-layer attention plan (`configs.layers.layer_plan`,
Mellum2) gives each layer its own attention (`attention.layer_attention`):
its sliding-window layers run CSR attention over the causal band, through
the scheduler's hand kernels where ``sage`` is given (the plain reference
oracles where it is not). Every other config ignores ``sage``, and its
products stay the plain torch ops of the JAX package's twin.
Spans (core/obs.py, with device time): ``lm.moe`` around each MoE FFN,
``lm.head`` around the final norm and the unembedding.

Entry points:
  init_lm(cfg, key, dtype, device)             -> LM
  lm_forward(model, batch, cfg, mesh, sage)    -> logits   (teacher forcing)
  init_lm_cache(cfg, batch, max_len, dtype, device) -> cache
  lm_prefill / lm_decode_step                  -> serving, with KV/SSM caches
  lm_params_from_jax, lm_cache_from_jax, lm_cache_to_numpy: carry-over
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.layers import layer_plan
from repro_torch.core import obs
from repro_torch.distributed.sharding import mesh_shape, sanitize, to_placements
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.modules import (
    Key,
    Params,
    dense_init,
    init_swiglu,
    load_tree,
    make_generator,
    normal,
    rmsnorm,
    swiglu,
    to_numpy,
    to_tensor,
    torch_dtype,
    unstack,
    zeros,
)

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
REMAT = True  # JAX's REMAT_POLICY: a tail unit saves nothing but its input


# ---------------------------------------------------------------- blocks
class Block(Params):
    """One layer of kind ``ssm`` (mixer only), ``rglru`` (mixer, ln2, no
    FFN), ``attn`` (a hybrid's local attention, no FFN), ``attn_mlp``,
    ``dense_ffn`` or ``moe``; attention is MLA where the config has it."""

    def __init__(self, gen, cfg: ArchConfig, kind: str, dtype):
        super().__init__(ln1=zeros(gen, (cfg.d_model,), dtype))
        self.kind = kind
        if kind == "ssm":
            self.mixer = ssm_mod.init_mamba2(gen, cfg, dtype)
            return  # mamba2 blocks have no separate FFN
        if kind == "rglru":
            self.mixer = rglru_mod.init_rglru(gen, cfg, dtype)
        elif cfg.mla:
            self.attn = attn.init_mla(gen, cfg, dtype)
        else:
            self.attn = attn.init_gqa(gen, cfg, dtype)
        self.ln2 = nn.Parameter(zeros(gen, (cfg.d_model,), dtype))
        if kind == "moe":
            self.ffn = moe_mod.init_moe(gen, cfg, dtype)
        elif kind == "dense_ffn":
            d_ff = cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff
            self.ffn = init_swiglu(gen, cfg.d_model, d_ff, dtype)
        elif kind == "attn_mlp":
            self.ffn = init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype)


def block_apply(
    p: Block,
    x: torch.Tensor,
    cfg: ArchConfig,
    positions: torch.Tensor,
    cache: Optional[Dict],
    window: Optional[int],
    long_ctx: bool,
    mesh=None,
    layer=None,
    sage=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One layer; ``layer`` (a `configs.layers.LayerAttn`) is its entry
    of the config's plan, None without one; ``sage`` schedules the
    plan's window attention."""
    kind = p.kind
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    new_cache = cache
    s = x.shape[1]
    if kind == "ssm":
        if cache is not None and s == 1:
            y, new_cache = ssm_mod.mamba2_step(p.mixer, h, cfg, cache)
        elif cache is not None:
            y, new_cache = ssm_mod.mamba2_prefill(p.mixer, h, cfg, cache)
        else:
            y = ssm_mod.mamba2_forward(p.mixer, h, cfg)
        return x + y, new_cache
    if kind == "rglru":
        if cache is not None and s == 1:
            y, new_cache = rglru_mod.rglru_step(p.mixer, h, cfg, cache)
        elif cache is not None:
            y, new_cache = rglru_mod.rglru_prefill(p.mixer, h, cfg, cache)
        else:
            y = rglru_mod.rglru_forward(p.mixer, h, cfg)
    elif cfg.mla:
        y, new_cache = attn.mla_attention(p.attn, h, cfg, positions, cache)
    elif layer is not None:
        y, new_cache = attn.layer_attention(p.attn, h, cfg, positions, layer, cache, sage)
    elif long_ctx and cache is not None:
        if os.environ.get("REPRO_LONG_ATTN") == "sharded" and mesh is not None:
            y, new_cache = attn.csr_window_attention_sharded(p.attn, h, cfg, positions, cache,
                                                             mesh)
        else:
            y, new_cache = attn.csr_window_attention(p.attn, h, cfg, positions, cache)
    else:
        y, new_cache = attn.gqa_attention(p.attn, h, cfg, positions, cache, window=window)
    x = x + y
    ffn = getattr(p, "ffn", None)
    if ffn is not None:
        h2 = rmsnorm(x, p.ln2, cfg.norm_eps)
        if kind == "moe":
            with obs.span("lm.moe", x.device):
                f = moe_mod.moe_ffn(ffn, h2, cfg, mesh)
        else:
            f = swiglu(ffn, h2)
        x = x + f
    return x, new_cache


# --------------------------------------------------------- architecture
def layer_kinds(cfg: ArchConfig) -> List[str]:
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return ["dense_ffn"] * fd + ["moe"] * (cfg.n_layers - fd)
    return ["attn_mlp"] * cfg.n_layers


def _stack_plan(cfg: ArchConfig) -> Tuple[List[str], Tuple[str, ...], int]:
    """JAX's split of the layer stack into (irregular head kinds, scan
    unit, reps); the port runs the layers flat, and the carry-over reads
    JAX's `head_blocks` / `tail_blocks` through it."""
    kinds = layer_kinds(cfg)
    if cfg.family == "hybrid":
        p = len(cfg.hybrid.pattern)
        rem = cfg.n_layers % p
        return kinds[:rem], tuple(kinds[rem:rem + p]), (cfg.n_layers - rem) // p
    tail_kind = kinds[-1]
    n_tail = 0
    for k in reversed(kinds):
        if k != tail_kind:
            break
        n_tail += 1
    return kinds[:len(kinds) - n_tail], (tail_kind,), n_tail


class LM(Params):
    """Embedding, the layer stack (`blocks`, in `layer_kinds` order), the
    final norm and the unembedding (absent with tied embeddings)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32):
        if cfg.family not in FAMILIES:
            raise ValueError(f"init_lm: family {cfg.family!r} is not a decoder LM")
        super().__init__(
            embed=normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
            final_norm=zeros(gen, (cfg.d_model,), dtype),
            unembed=None if cfg.tie_embeddings else dense_init(gen, cfg.d_model, cfg.vocab, dtype),
        )
        self.blocks = nn.ModuleList(Block(gen, cfg, k, dtype) for k in layer_kinds(cfg))
        self.cfg = cfg


def init_lm(cfg: ArchConfig, key: Key = 0, dtype=torch.float32, device=None) -> LM:
    """Weights drawn as the JAX package's `init_lm` draws them (same
    shapes and scales) from a torch.Generator: ``key`` is a seed or a
    generator; ``device`` defaults to the card."""
    return LM(cfg, make_generator(key, device), dtype)


def _embed_inputs(model: LM, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    tok_emb = F.embedding(batch["tokens"], model.embed)  # (B, St, D)
    if cfg.vlm_patches and "patch_embeds" in batch:
        # stub InternViT frontend: precomputed patch embeddings prepended
        return torch.cat([batch["patch_embeds"].to(tok_emb.dtype), tok_emb], dim=1)
    return tok_emb


def remat(fn, *args):
    """``fn(*args)`` under activation checkpointing where grad is enabled
    (and `REMAT` is on): its activations are recomputed in the backward."""
    if REMAT and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def activation_constraint(x: torch.Tensor, mesh) -> torch.Tensor:
    """JAX's layer-boundary layout hint: batch over ('pod', 'data'), the
    sequence over 'model' (Megatron-style sequence parallelism;
    ``REPRO_ACT_SP=0`` drops that shard), sanitized. A layout, never a
    value: a plain tensor (each rank's own rows, as the step factories
    keep activations) comes back unchanged, and a DTensor is
    redistributed to the spec's placements."""
    if mesh is None or x.ndim != 3:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    seq_axis = None if os.environ.get("REPRO_ACT_SP") == "0" else "model"
    spec = sanitize((batch_axes or None, seq_axis, None), tuple(x.shape), mesh)
    return x.redistribute(x.device_mesh, to_placements(spec, mesh))


def _run_blocks(model: LM, x, cfg: ArchConfig, positions, caches: Optional[Dict],
                long_ctx: bool, mesh=None, sage=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    window = cfg.hybrid.local_window if cfg.hybrid else None
    plan = layer_plan(cfg)

    def layer(i: int):
        return None if plan is None else plan[i]

    if caches is None:  # training / teacher forcing: remat each tail unit
        head, unit, _ = _stack_plan(cfg)
        blocks = list(model.blocks)
        for i, blk in enumerate(blocks[:len(head)]):
            x, _ = block_apply(blk, x, cfg, positions, None, window, False, mesh, layer(i), sage)

        def unit_apply(xu, unit_layers):  # [(block, its entry of the plan)]
            xu = activation_constraint(xu, mesh)
            for blk, attn_layer in unit_layers:
                xu, _ = block_apply(blk, xu, cfg, positions, None, window, False, mesh,
                                    attn_layer, sage)
            return xu

        for i in range(len(head), len(blocks), len(unit)):
            x = remat(unit_apply, x, [(blocks[j], layer(j)) for j in range(i, i + len(unit))])
        return x, None
    head, unit, _ = _stack_plan(cfg)
    new_layers = []
    for i, (blk, c) in enumerate(zip(model.blocks, caches["layers"])):
        if i >= len(head) and (i - len(head)) % len(unit) == 0:
            x = activation_constraint(x, mesh)
        x, c2 = block_apply(blk, x, cfg, positions, c, window, long_ctx, mesh, layer(i))
        new_layers.append(c2)
    return x, {"layers": new_layers}


def _logits(model: LM, x, cfg: ArchConfig) -> torch.Tensor:
    with obs.span("lm.head", x.device):
        h = rmsnorm(x, model.final_norm, cfg.norm_eps)
        w = model.embed.T if cfg.tie_embeddings else model.unembed
        return (h @ w.to(h.dtype)).float()


def lm_forward(model: LM, batch: Dict, cfg: ArchConfig, mesh=None, sage=None) -> torch.Tensor:
    """Teacher-forcing forward. batch: tokens (B, S) [+ patch_embeds].
    ``sage`` schedules the window attention of a config with a layer
    plan; other configs ignore it."""
    x = _embed_inputs(model, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, _ = _run_blocks(model, x, cfg, positions, None, long_ctx=False, mesh=mesh, sage=sage)
    return _logits(model, x, cfg)


# --------------------------------------------------------------- serving
def _layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, dtype, device) -> Dict:
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, device)
    # a hybrid's local-attention layers keep full-length caches too
    return attn.init_kv_cache(cfg, batch, max_len, dtype, device)


def init_lm_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> Dict:
    return {"layers": [_layer_cache(cfg, k, batch, max_len, dtype, device)
                       for k in layer_kinds(cfg)]}


def lm_prefill(model: LM, batch: Dict, cfg: ArchConfig, cache: Dict, mesh=None
               ) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt, filling the caches; returns the last
    position's logits (B, 1, V)."""
    x = _embed_inputs(model, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, new_cache = _run_blocks(model, x, cfg, positions, cache, long_ctx=False, mesh=mesh)
    return _logits(model, x[:, -1:], cfg), new_cache


def lm_decode_step(model: LM, tokens: torch.Tensor, cfg: ArchConfig, cache: Dict,
                   long_ctx: bool = False, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1). long_ctx=True routes GQA layers
    through the CSR window + sink path (the paper's pipeline)."""
    x = F.embedding(tokens, model.embed)
    b = x.shape[0]
    positions = torch.full((b, 1), _first_pos(cache), dtype=torch.long, device=x.device)
    x, new_cache = _run_blocks(model, x, cfg, positions, cache, long_ctx=long_ctx, mesh=mesh)
    return _logits(model, x, cfg), new_cache


def _first_pos(cache: Dict) -> int:
    """The first layer's ``pos``: JAX's first 'pos' leaf in pytree order
    (head layers first, then the stacked tail's element 0)."""
    return cache["layers"][0]["pos"] if cache["layers"] else 0


# ------------------------------------------------------------ carry-over
def _jax_layers(cfg: ArchConfig, head: List, tail) -> List:
    """JAX's (head list, stacked tail) as one list per layer, in order."""
    _, unit, n_tail = _stack_plan(cfg)
    out = list(head)
    if n_tail:
        reps = unstack(tail, n_tail)
        for r in reps:
            out += [r] if len(unit) == 1 else [r[f"sub_{i}"] for i in range(len(unit))]
    return out


def lm_params_from_jax(cfg: ArchConfig, params_np: Dict, device=None) -> LM:
    """An `LM` holding the weights of `repro.models.transformer.init_lm`'s
    output, given as numpy arrays (its pytree: `head_blocks`, the stacked
    `tail_blocks`, hybrid units `sub_i`). Every name and shape must match."""
    model = init_lm(cfg, 0, torch_dtype(params_np["embed"]), device)
    top = {k: params_np[k] for k in ("embed", "final_norm", "unembed") if k in params_np}
    layers = _jax_layers(cfg, params_np["head_blocks"], params_np["tail_blocks"])
    if len(layers) != len(model.blocks):
        raise ValueError(f"{len(layers)} JAX layers for {len(model.blocks)} blocks")
    load_tree(model, {**top, "blocks": layers})
    return model


def lm_jax_path(cfg: ArchConfig, name: str) -> Tuple[Tuple, Optional[int]]:
    """The JAX pytree path of the port parameter ``name`` (list indices as
    ints) and, for a leaf of the stacked `tail_blocks`, its index along
    the leading (layer) axis: ``blocks.5.attn.wq`` of a 1-layer unit with
    one head layer is (("tail_blocks", "attn", "wq"), 4)."""
    parts = tuple(name.split("."))
    if parts[0] != "blocks":
        return parts, None
    head, unit, _ = _stack_plan(cfg)
    i, rest = int(parts[1]), parts[2:]
    if i < len(head):
        return ("head_blocks", i) + rest, None
    rep, sub = divmod(i - len(head), len(unit))
    return ("tail_blocks",) + ((f"sub_{sub}",) if len(unit) > 1 else ()) + rest, rep


def lm_cache_from_jax(cfg: ArchConfig, cache_np: Dict, device=None) -> Dict:
    """The port's cache from `repro.models.transformer.init_lm_cache`'s
    layout (numpy arrays; each layer's ``pos`` becomes an int)."""
    layers = _jax_layers(cfg, cache_np["head"], cache_np["tail"])
    return {"layers": [
        {k: (int(np.asarray(v)) if k == "pos" else to_tensor(v, device)) for k, v in c.items()}
        for c in layers
    ]}


def lm_cache_to_numpy(cfg: ArchConfig, cache: Dict) -> Dict:
    """The JAX layout of a port cache (head list, stacked tail), as numpy
    arrays (bf16 tensors as float32); ``pos`` as int32 scalars."""
    head, unit, _ = _stack_plan(cfg)
    layers = [{k: to_numpy(v) for k, v in c.items()} for c in cache["layers"]]
    tail_layers = layers[len(head):]
    p = len(unit)

    def stack(items: List[Dict]) -> Dict:
        return {k: np.stack([it[k] for it in items]) for k in items[0]} if items else {}

    if p == 1:
        tail: Any = stack(tail_layers)
    else:
        tail = {f"sub_{i}": stack(tail_layers[i::p]) for i in range(p)}
    return {"head": layers[:len(head)], "tail": tail}
