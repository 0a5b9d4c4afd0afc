"""Plain fp32 PyTorch reference of a Mellum2 training step.

Independent of the program: it reads the configuration's published keys
(Hugging Face names), the initial weights and the token batches that
the benchmark made, and works the model out again from its equations:

  x = embed[tokens]; per layer i (layer_types[i]):
    x = x + attn_i(rmsnorm(x, ln1)); x = x + moe_i(rmsnorm(x, ln2))
  logits = rmsnorm(x, final_norm) @ unembed
  loss = mean over labelled tokens of (logsumexp - gold + 1e-4 logsumexp^2)

- rmsnorm(x, w) = x / sqrt(mean(x^2) + eps) * (1 + w): the weight is
  kept as an offset from 1, as the benchmark's weights are (0 at start);
  the same function as Hugging Face's weight of ones.
- Attention: GQA, query head h on KV head h // (heads / kv_heads), rope
  on the two halves of each head (Hugging Face's rotate_half), scale
  1/sqrt(head_dim). A ``sliding_attention`` layer takes default rope
  and masks row t to keys t - sliding_window + 1 .. t; a
  ``full_attention`` layer takes YaRN rope (`yarn_inv_freq`, cos and
  sin times ``attention_factor``) and masks causally. Both run as dense
  masked products in query chunks, each chunk under activation
  checkpointing so that only its inputs are kept for the backward.
- MoE: router logits x @ router, softmax over all experts, top-k,
  gates renormalised to sum to 1; each expert's SwiGLU
  (silu(x W_gate) * (x W_up)) W_down over the tokens routed to it, in a
  loop over the experts, weighted by the gate; no shared expert. Given
  `Routes`, the experts are the ids another side took, and the
  reference records how far they are from its own top-k.
- AdamW as the port's objective runs it: the gradients clipped to a
  global norm of ``clip_norm``; m, v with b1, b2; bias corrections;
  p -= lr (m^ / (sqrt(v^) + eps) + weight_decay p) with no decay on the
  norms' weights; the learning rate warms up linearly over
  ``warmup_steps`` (the first update takes lr / warmup_steps), then a
  cosine to ``min_lr_frac`` of it at ``total_steps``.

Departures from the published model (each also in the configuration's
``assumed``): fp32 in place of bf16; no multi-token-prediction head; the
z-loss of the port's objective.

``precision`` as in `bench.reference.gnn`: ``"tf32"`` rounds every
operand of every product to TF32, forward and backward (projections,
router, experts, unembedding, q·k and P·V of every layer);
``"tf32_sparse"`` rounds the window layers' q·k and P·V alone, the
products the program runs as sparse kernels. ``half_batch`` masks the
labels of the second half of each sequence: the fault "half of the
tokens left out of the loss".
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.gnn import PRECISIONS, fp32_matmul, operand, result

Q_CHUNK = 1024
Z_LOSS = 1e-4


def product(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """a @ b, in TF32 (operands and the incoming gradient rounded) or fp32."""
    if not tf32:
        return a @ b
    return result(operand(a, "tf32") @ operand(b, "tf32"), "tf32")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def default_inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, dim, 2, device=device).float() / dim)


def yarn_inv_freq(dim: int, rp: Dict[str, Any], device) -> torch.Tensor:
    """YaRN's frequencies from its definition (Peng et al. 2023, as
    Hugging Face computes them with ``truncate``): the dimension that
    makes r rotations over the original context is
    d(r) = dim ln(L / (2 pi r)) / (2 ln theta); below floor(d(beta_fast))
    the frequency is theta's, above ceil(d(beta_slow)) it is theta's
    over ``factor``, and linear in between."""
    theta, factor = float(rp["rope_theta"]), float(rp["factor"])
    length = float(rp["original_max_position_embeddings"])

    def d_of(r):
        return dim * math.log(length / (2 * math.pi * r)) / (2 * math.log(theta))

    low = max(math.floor(d_of(float(rp["beta_fast"]))), 0)
    high = min(math.ceil(d_of(float(rp["beta_slow"]))), dim - 1)
    base = default_inv_freq(dim, theta, device)
    i = torch.arange(dim // 2, device=device).float()
    interp_share = torch.clamp((i - low) / max(high - low, 1e-3), 0.0, 1.0)
    return base * (1 - interp_share) + (base / factor) * interp_share


def rope(x: torch.Tensor, inv_freq: torch.Tensor, scale: float) -> torch.Tensor:
    """x (S, H, D): position t rotates each pair (x[i], x[i + D/2])."""
    t = torch.arange(x.shape[0], device=x.device).float()
    ang = torch.outer(t, inv_freq)
    cos = (torch.cos(ang) * scale)[:, None, :]
    sin = (torch.sin(ang) * scale)[:, None, :]
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int, k0: int,
                  window: int, tf32: bool) -> torch.Tensor:
    """q (H, C, D) at positions q0.., k and v (H, L, D) at k0..: the
    masked softmax(q k^T / sqrt(D)) v; window 0 is causal."""
    logits = product(q, k.transpose(1, 2), tf32) * q.shape[-1] ** -0.5
    qpos = q0 + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = k0 + torch.arange(k.shape[1], device=q.device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    probs = torch.softmax(logits.masked_fill(~ok, float("-inf")), dim=-1)
    return product(probs, v, tf32)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], p: str, config: Dict[str, Any],
              kind: str, precision: str) -> torch.Tensor:
    """One layer's attention of x (S, d) for one sequence."""
    s = x.shape[0]
    h, hkv, dh = (config["num_attention_heads"], config["num_key_value_heads"],
                  config["head_dim"])
    dense = precision == "tf32"
    sparse = precision in ("tf32", "tf32_sparse") and kind == "sliding_attention"
    core_tf32 = dense or sparse
    q = product(x, w[p + "attn.wq"], dense).reshape(s, h, dh)
    k = product(x, w[p + "attn.wk"], dense).reshape(s, hkv, dh)
    v = product(x, w[p + "attn.wv"], dense).reshape(s, hkv, dh)
    rp = config["rope_parameters"][kind]
    if rp["rope_type"] == "yarn":
        inv, scale = yarn_inv_freq(dh, rp, x.device), float(rp["attention_factor"])
    else:
        inv, scale = default_inv_freq(dh, float(rp["rope_theta"]), x.device), 1.0
    q, k = rope(q, inv, scale), rope(k, inv, scale)
    g = h // hkv
    qh = q.transpose(0, 1)  # (H, S, D)
    kh = k.transpose(0, 1).repeat_interleave(g, dim=0)
    vh = v.transpose(0, 1).repeat_interleave(g, dim=0)
    window = config["sliding_window"] if kind == "sliding_attention" else 0
    outs = []
    for q0 in range(0, s, Q_CHUNK):
        q1 = min(q0 + Q_CHUNK, s)
        k0 = max(0, q0 - window + 1) if window else 0
        outs.append(checkpoint(_attend_chunk, qh[:, q0:q1], kh[:, k0:q1], vh[:, k0:q1],
                               q0, k0, window, core_tf32, use_reentrant=False))
    out = torch.cat(outs, dim=1).transpose(0, 1).reshape(s, h * dh)
    return product(out, w[p + "attn.wo"], dense)


class Routes:
    """Expert choices handed to the reference, and what it finds of them.

    ``ids`` holds, per step, per layer, the (tokens, k) expert ids a side
    took (tokens of all sequences of the batch, in order); the reference
    routes by them in place of its own top-k, so that a near-tie decided
    the other way by rounding (which then moves the hidden states of the
    tokens after it through the window) does not enter the comparison of
    the continuous numbers. ``gap`` records how far those choices are
    from the top-k of the reference's own router logits: the largest
    (best logit left out - smallest logit taken) over every token, layer
    and step, 0 where every choice is a top-k set."""

    def __init__(self, ids: List[List[torch.Tensor]]):
        self.ids = ids
        self.gap = 0.0
        self.step = 0

    def take(self, layer: int, rows: slice) -> torch.Tensor:
        return self.ids[self.step][layer][rows]

    def check(self, logits: torch.Tensor, ids: torch.Tensor) -> None:
        taken = logits.gather(1, ids).min(-1).values
        left = logits.scatter(1, ids, float("-inf")).max(-1).values
        self.gap = max(self.gap, float(torch.clamp_min(left - taken, 0.0).max()))


def moe(x: torch.Tensor, w: Dict[str, torch.Tensor], p: str, config: Dict[str, Any],
        precision: str, ids: torch.Tensor = None, routes: Routes = None) -> torch.Tensor:
    """The MoE FFN of x (S, d); ``ids`` (S, k), where given, are the
    experts taken (checked against this layer's logits in ``routes``)."""
    tf32 = precision == "tf32"
    k = config["num_experts_per_tok"]
    logits = product(x, w[p + "ffn.router"], tf32)
    probs = torch.softmax(logits, dim=-1)
    if ids is None:
        gates, ids = torch.topk(probs, k, dim=-1)
    else:
        with torch.no_grad():
            routes.check(logits, ids)
        gates = probs.gather(1, ids)
    if config["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(config["num_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        hidden = F.silu(product(xe, w[p + "ffn.w_gate"][e], tf32)) * product(
            xe, w[p + "ffn.w_up"][e], tf32)
        ye = product(hidden, w[p + "ffn.w_down"][e], tf32)
        out = out.index_add(0, tok, ye * gates[tok, slot][:, None])
    return out


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, config: Dict[str, Any],
            precision: str = "fp32", routes: Routes = None, rows: slice = None
            ) -> torch.Tensor:
    """The logits (S, vocab) of one sequence of token ids (S,); with
    ``routes``, its experts are the ids of ``rows`` of the current step."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    eps = config["rms_norm_eps"]
    x = w["embed"][tokens]
    for i, kind in enumerate(config["layer_types"][:config["num_hidden_layers"]]):
        p = f"blocks.{i}."
        x = x + attention(rmsnorm(x, w[p + "ln1"], eps), w, p, config, kind, precision)
        ids = None if routes is None else routes.take(i, rows)
        x = x + moe(rmsnorm(x, w[p + "ln2"], eps), w, p, config, precision, ids, routes)
    return product(rmsnorm(x, w["final_norm"], eps), w["unembed"], precision == "tf32")


def loss_of(w: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], config: Dict[str, Any],
            precision: str = "fp32", half_batch: bool = False,
            routes: Routes = None) -> torch.Tensor:
    """The mean next-token cross-entropy plus z-loss of one batch."""
    total = torch.zeros((), device=batch["tokens"].device)
    count = 0
    s = batch["tokens"].shape[1]
    for b, (tokens, labels) in enumerate(zip(batch["tokens"], batch["labels"])):
        if half_batch:
            labels = torch.where(torch.arange(labels.shape[0], device=labels.device)
                                 < labels.shape[0] // 2, labels, torch.full_like(labels, -1))
        logits = forward(w, tokens, config, precision, routes, slice(b * s, (b + 1) * s))
        lse = torch.logsumexp(logits, dim=-1)
        keep = labels >= 0
        gold = logits.gather(1, labels.clamp_min(0)[:, None])[:, 0]
        total = total + ((lse - gold + Z_LOSS * lse * lse) * keep).sum()
        count += int(keep.sum())
    return total / max(count, 1)


def _schedule(opt: Dict[str, Any], count: int) -> float:
    lr, warm, total = float(opt["lr"]), int(opt["warmup_steps"]), int(opt["total_steps"])
    if count < warm:
        return lr * count / max(warm, 1)
    prog = min(max((count - warm) / max(total - warm, 1), 0.0), 1.0)
    floor = float(opt["min_lr_frac"])
    return lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


def train(weights: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
          config: Dict[str, Any], opt: Dict[str, Any], precision: str = "fp32",
          half_batch: bool = False, routes: Routes = None
          ) -> Tuple[List[float], Dict[str, float]]:
    """One AdamW step per batch from ``weights``, a dict whose entries
    are replaced by the updated weights: returns the losses before each
    update and the norm of each weight's first gradient as the update
    saw it (clipped). With ``routes`` every step routes by its ids."""
    names = list(weights)
    m = {n: torch.zeros_like(t) for n, t in weights.items()}
    v = {n: torch.zeros_like(t) for n, t in weights.items()}
    b1, b2, eps = float(opt["b1"]), float(opt["b2"]), float(opt["eps"])
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with fp32_matmul():
        for count, batch in enumerate(batches, start=1):
            leaves = {n: weights[n].detach().requires_grad_(True) for n in names}
            if routes is not None:
                routes.step = count - 1
            loss = loss_of(leaves, batch, config, precision, half_batch, routes)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            losses.append(float(loss.detach()))
            del leaves, loss
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                clip = min(1.0, float(opt["clip_norm"]) / max(float(norm), 1e-9))
                lr = _schedule(opt, count)
                for n, g in zip(names, grads):
                    g = g * clip
                    if count == 1:
                        grad_norms[n] = float(torch.linalg.vector_norm(g.double()))
                    m[n] = b1 * m[n] + (1 - b1) * g
                    v[n] = b2 * v[n] + (1 - b2) * g * g
                    step = (m[n] / (1 - b1 ** count)) / (
                        torch.sqrt(v[n] / (1 - b2 ** count)) + eps)
                    if weights[n].ndim > 1:  # matrices decay, the norms' weights do not
                        step = step + float(opt["weight_decay"]) * weights[n]
                    weights[n] = weights[n] - lr * step
            del grads
    return losses, grad_norms
