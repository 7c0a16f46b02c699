"""Greedy autoregressive generation with a dense KV cache for Llama.

Port of ``paddle_tpu/models/generation.py``.  Prefill is one causal fp32
einsum forward over the prompt that also writes each layer's K/V into a
``[L, b, kvh, M, d]`` cache (head-major, the decode kernel's layout);
each decode step embeds one token and runs every layer against the cache
through the ``flash_decode`` kernel (``ops/decode_attention.py``), whose
traffic is bounded by the current position.  PyTorch runs eagerly, so the
JAX ``lax.scan`` becomes a Python loop and the cache is updated in place.

Norms, rope, SwiGLU and the head are plain PyTorch, as the JAX package
left them to XLA.  Weight-only int8 dicts (``quantize_params_int8``, the
``._scale`` views of ``_Weights``) and sparse checkpoints (``_moe_ffn``,
expert GEMMs on the grouped-matmul kernel B7, ``ops/grouped_matmul.py``)
serve through every path.  Sampling and beam search belong to later
slices of the port and raise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.decode_attention import flash_decode
from ..ops.grouped_matmul import grouped_matmul_raw, sorted_segments
from .llama import _rope_tables

__all__ = ["generate", "quantize_params_int8"]


def _rms_norm(x, w, eps):
    """fp32 statistics, cast back to x's dtype BEFORE the gain multiply
    (the JAX order, kept for bf16 parity)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _apply_rope(q, k, cos, sin):
    """q: [..., h, d]; cos/sin broadcastable [..., 1, d] in x's dtype (neox
    style, the layout _rope_tables builds)."""
    return (q * cos + _rotate_half(q) * sin,
            k * cos + _rotate_half(k) * sin)


class _Weights:
    """Name-indexed view over a functional-state dict (Linear weights are
    [in, out]: y = x @ W).  Mirror of ``paddle_tpu.models.generation.
    _Weights``, weight-only int8 included: a weight ``N`` may ride with a
    sibling ``N._scale`` (``quantize_params_int8``), and the accessors
    dequantize ``int8 -> compute dtype`` at the consumer, casting weight
    and scale to the compute dtype before the multiply (the JAX order).
    The compute dtype ``_dt`` is the first floating, non-``._scale``
    parameter's dtype, else bf16.  Embedding lookups gather int8 rows first
    and dequantize the gathered rows only."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.p = params
        self._dt = next((v.dtype for k, v in params.items()
                         if not k.endswith("._scale")
                         and v.is_floating_point()), torch.bfloat16)

    def _deq(self, name):
        w = self.p[name]
        sc = self.p.get(name + "._scale")
        if sc is None:
            return w
        # per-out-channel (last axis) scales
        return w.to(self._dt) * sc.to(self._dt)[None, :]

    def layer(self, i, name):
        return self._deq(f"model.layers.{i}.{name}")

    def is_moe_layer(self, i) -> bool:
        """A layer is MoE iff the checkpoint carries its stacked expert
        weights (sparse checkpoints may mix dense and MoE layers)."""
        return f"model.layers.{i}.mlp.experts.gate_proj.weight" in self.p

    def expert(self, i, proj, idx):
        """Gather-then-dequant expert slices of the stacked ``[E, in,
        out]`` bank: the int8 slices of ``idx`` first, then their
        per-(expert, out-channel) scales."""
        name = f"model.layers.{i}.mlp.experts.{proj}.weight"
        idx = idx.long()
        rows = self.p[name][idx]                       # [T, in, out]
        sc = self.p.get(name + "._scale")
        if sc is None:
            return rows
        return rows.to(self._dt) * sc.to(self._dt)[idx][:, None, :]

    def embed(self, ids):
        """Gather rows, then dequantize the gathered rows only (per-row
        scales of the [vocab, hidden] matrix)."""
        ids = ids.long()
        rows = self.p["model.embed_tokens.weight"][ids]
        sc = self.p.get("model.embed_tokens.weight._scale")
        if sc is None:
            return rows
        return rows.to(self._dt) * sc.to(self._dt)[ids][..., None]

    def head(self, x):
        if "lm_head.weight" in self.p:
            w = self.p["lm_head.weight"]
            sc = self.p.get("lm_head.weight._scale")
        else:
            # tied embeddings: the per-row embed scales become
            # per-out-channel head scales
            w = self.p["model.embed_tokens.weight"].T
            sc = self.p.get("model.embed_tokens.weight._scale")
        if sc is None:
            return x @ w
        return (x @ w.to(self._dt)) * sc.to(self._dt)[None, :]

    def __getitem__(self, k):
        return self._deq(k)


def quantize_params_int8(params: Dict[str, torch.Tensor],
                         keep=("norm", "layernorm", "router")
                         ) -> Dict[str, torch.Tensor]:
    """Weight-only int8 quantization of a functional-state dict (mirror of
    ``quantize_params_int8``, equal to it bit for bit): 2D floating weights
    become int8 with a per-output-channel symmetric-absmax fp32
    ``<name>._scale``; 1D weights and names matching ``keep`` (norms, the
    MoE router) stay as they are.  The embedding quantizes per row, stacked
    ``[E, in, out]`` expert banks per (expert, out-channel)."""
    out = {}
    for name, w in params.items():
        is_embed = name.endswith("embed_tokens.weight")
        is_expert = ".mlp.experts." in name and w.dim() == 3
        if ((w.dim() != 2 and not is_expert) or not w.is_floating_point()
                or any(s in name for s in keep)):
            out[name] = w
            continue
        wf = w.float()
        if is_expert:
            scale = wf.abs().amax(dim=1).clamp_min(1e-8) / 127.0  # [E, out]
            den = scale[:, None, :]
        else:
            axis = 1 if is_embed else 0         # reduce over the in-dim
            scale = wf.abs().amax(dim=axis).clamp_min(1e-8) / 127.0
            den = scale[:, None] if is_embed else scale[None, :]
        out[name] = torch.round(wf / den).clamp(-127, 127).to(torch.int8)
        out[name + "._scale"] = scale
        del wf
    return out


#: row-block quantum of the serving grouped-matmul launches (segment
#: alignment; serving batches are small, so a fine block keeps the padding
#: slack low)
_MOE_FFN_BLOCK_ROWS = 8


def _top_k(probs, k):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _moe_ffn(w: _Weights, i, xm):
    """Top-k expert routing of one MoE layer (mirror of ``_moe_ffn``): fp32
    router logits -> softmax -> top-k, renormalised over the chosen k ->
    token copies sorted by expert (stable) into ``_MOE_FFN_BLOCK_ROWS``-
    aligned segments -> ONE ``grouped_matmul_raw`` launch (B7) per
    projection, SwiGLU, then a weighted scatter-add back to token order.
    An int8 bank goes into the kernel as it is, with its fp32 ``._scale``
    (widened and scaled in-kernel).  ``xm`` is any [..., hidden] batch;
    routing is per token row.  Nothing here waits for the device
    (``sorted_segments``), so a decode chunk enqueues without a host
    sync."""
    cfg = w.cfg
    shape = xm.shape
    x2 = xm.reshape(-1, shape[-1])
    router = w.layer(i, "mlp.router.weight")            # [h, E], fp
    e = int(router.shape[-1])
    bank_e = int(
        w.p[f"model.layers.{i}.mlp.experts.gate_proj.weight"].shape[0])
    if bank_e != e:
        raise ValueError(
            f"layer {i}: router routes {e} experts but the stacked bank "
            f"holds {bank_e}")
    k = int(cfg.moe_top_k)
    if not 1 <= k <= e:
        raise ValueError(
            f"layer {i}: moe_top_k={k} outside [1, {e}] — set "
            f"LlamaConfig.moe_top_k for this sparse checkpoint")
    probs = torch.softmax(x2.float() @ router.float(), dim=-1)
    top_p, top_ids = _top_k(probs, k)                   # [T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # sorted ragged dispatch
    bm = _MOE_FFN_BLOCK_ROWS
    order, _, counts, seg_st, dest, rpad = sorted_segments(top_ids, e, bm)
    token_of = order // k
    wsorted = top_p.reshape(-1)[order]
    xr = torch.zeros((rpad, x2.shape[1]), dtype=x2.dtype, device=x2.device)
    xr.index_copy_(0, dest, x2[token_of])
    wids = torch.arange(e, dtype=torch.int32, device=x2.device)

    def gmm(xin, proj):
        name = f"model.layers.{i}.mlp.experts.{proj}.weight"
        wq = w.p[name]
        sc = w.p.get(name + "._scale")
        if sc is None:
            wq = wq.to(x2.dtype)
        else:
            sc = sc.float()
        return grouped_matmul_raw(xin, wq, seg_st, counts, wids,
                                  block_rows=bm, w_scale=sc)

    gate = gmm(xr, "gate_proj")
    up = gmm(xr, "up_proj")
    eo = gmm(F.silu(gate) * up, "down_proj")            # [rpad, h]

    # combine: each copy's expert output, weighted, added into token order
    ys = eo[dest] * wsorted.to(x2.dtype)[:, None]
    y = torch.zeros_like(x2).index_add_(0, token_of, ys)
    return y.reshape(shape)


def _ffn(w: _Weights, i, xm):
    """Layer ``i``'s FFN (mirror of ``_ffn``): dense SwiGLU, or top-k
    expert routing (``_moe_ffn``) when the checkpoint carries the layer's
    stacked expert banks.  The one FFN of prefill, ``generate``'s decode,
    the chunked engine and the unified step."""
    if w.is_moe_layer(i):
        return _moe_ffn(w, i, xm)
    gate = xm @ w.layer(i, "mlp.gate_proj.weight")
    up = xm @ w.layer(i, "mlp.up_proj.weight")
    return (F.silu(gate) * up) @ w.layer(i, "mlp.down_proj.weight")


def _block(w: _Weights, i, x, cos, sin, mask, k_all=None, v_all=None,
           cache_pos=None):
    """One decoder layer (mirror of ``_block``).  x [b, s, hidden].
    Without a cache (prefill) it attends x's own K/V with the additive
    ``mask`` in fp32 and returns them ([b, s, kvh, d]).  With the layer
    cache k_all/v_all ([b, kvh, M, d]) it takes one token (s == 1, no
    mask), writes its K/V at ``cache_pos`` IN PLACE, attends over the
    cache through the ``flash_decode`` kernel and returns the cache.
    (The JAX ``_block``'s chunked attention against a cache, s > 1, has
    no caller in the port.)"""
    cfg = w.cfg
    b, s, _ = x.shape
    h, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    xin = _rms_norm(x, w.layer(i, "input_layernorm.weight"), eps)
    q = (xin @ w.layer(i, "self_attn.q_proj.weight")).reshape(b, s, h, d)
    k = (xin @ w.layer(i, "self_attn.k_proj.weight")).reshape(b, s, kvh, d)
    v = (xin @ w.layer(i, "self_attn.v_proj.weight")).reshape(b, s, kvh, d)
    q, k = _apply_rope(q, k, cos, sin)
    if k_all is None:
        k_all, v_all = k, v
        qg = q.reshape(b, s, kvh, h // kvh, d).float()
        scores = torch.einsum("bskgd,bSkd->bskgS", qg,
                              k.float()) * (d ** -0.5)
        scores = scores + mask[None, :, None, None, :]
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bskgS,bSkd->bskgd", probs,
                           v.float()).reshape(b, s, h * d)
    else:
        k_all[:, :, cache_pos] = k[:, 0].to(k_all.dtype)
        v_all[:, :, cache_pos] = v[:, 0].to(v_all.dtype)
        lens = torch.full((b,), cache_pos + 1, dtype=torch.int32,
                          device=x.device)
        ctx = flash_decode(q.reshape(b, h, d), k_all, v_all, lens,
                           scale=d ** -0.5).reshape(b, s, h * d)
    x = x + ctx.to(x.dtype) @ w.layer(i, "self_attn.o_proj.weight")
    xm = _rms_norm(x, w.layer(i, "post_attention_layernorm.weight"), eps)
    x = x + _ffn(w, i, xm)
    return x, k_all, v_all


def _causal_mask(s, device):
    keep = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), device=device)
    return torch.where(keep, zero, torch.full_like(zero, float("-inf")))


def _prefill(w: _Weights, ids, cos_tab, sin_tab):
    """Causal forward over ids [b, S] from position 0.  Returns the final
    normed hidden states [b, S, hidden] and the per-layer K/V lists
    ([b, S, kvh, d] each)."""
    S = ids.shape[1]
    x = w.embed(ids)
    cos = cos_tab[:S][None, :, None, :].to(x.dtype)
    sin = sin_tab[:S][None, :, None, :].to(x.dtype)
    mask = _causal_mask(S, ids.device)
    ks, vs = [], []
    for i in range(w.cfg.num_hidden_layers):
        x, k, v = _block(w, i, x, cos, sin, mask)
        ks.append(k)
        vs.append(v)
    return _rms_norm(x, w["model.norm.weight"], w.cfg.rms_norm_eps), ks, vs


def _decode_step(w: _Weights, cos_tab, sin_tab, token, pos, k_cache,
                 v_cache):
    """One-token step (mirror of ``_decode_step``).  token [b], pos int;
    caches [L, b, kvh, M, d], written in place at ``pos``.  Returns
    logits [b, V]."""
    x = w.embed(token[:, None])
    cos = cos_tab[pos][None, None, None, :].to(x.dtype)
    sin = sin_tab[pos][None, None, None, :].to(x.dtype)
    for i in range(w.cfg.num_hidden_layers):
        x, _, _ = _block(w, i, x, cos, sin, None, k_cache[i], v_cache[i],
                         pos)
    x = _rms_norm(x, w["model.norm.weight"], w.cfg.rms_norm_eps)
    return w.head(x[:, 0])


def rope_tables_on(cfg, device):
    cos, sin = _rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                            cfg.rope_theta)
    return cos.to(device), sin.to(device)


@torch.no_grad()
def _generate_greedy(cfg, params, ids, max_new_tokens: int, eos_id: int):
    w = _Weights(cfg, params)
    b, S = ids.shape
    M = S + max_new_tokens
    L, kvh, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    cos_tab, sin_tab = rope_tables_on(cfg, ids.device)
    x, ks, vs = _prefill(w, ids, cos_tab, sin_tab)
    k_cache = torch.zeros((L, b, kvh, M, d), dtype=x.dtype, device=ids.device)
    v_cache = torch.zeros_like(k_cache)
    for i in range(L):
        k_cache[i, :, :, :S] = ks[i].transpose(1, 2)
        v_cache[i, :, :, :S] = vs[i].transpose(1, 2)
    tok = w.head(x[:, -1]).float().argmax(dim=-1).to(torch.int32)
    done = tok == eos_id
    out = [tok]
    for pos in range(S, M - 1):
        logits = _decode_step(w, cos_tab, sin_tab, tok, pos, k_cache, v_cache)
        nxt = logits.float().argmax(dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             eos_token_id: Optional[int] = None, num_beams: int = 1,
             length_penalty: float = 1.0):
    """Greedy continuation of ``input_ids`` ([b, S] int) with a KV cache on
    the model's device; returns int32 [b, S + max_new_tokens] including
    the prompt (mirror of ``paddle_tpu.models.generation.generate``).
    After an EOS a sequence keeps emitting ``eos_token_id``.  Sampling
    (``do_sample``) and beam search (``num_beams > 1``) are later slices
    and raise."""
    if do_sample:
        raise NotImplementedError("sampling (temperature/top-k/top-p) "
                                  "belongs to a later slice of the port")
    if num_beams > 1:
        raise NotImplementedError("beam search belongs to a later slice of "
                                  "the port")
    cfg = model.cfg
    device = model.device
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids)
    ids = ids.to(device=device, dtype=torch.int32)
    max_new_tokens = int(max_new_tokens)
    if max_new_tokens <= 0:
        return ids
    total = ids.shape[1] + max_new_tokens
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"generate: prompt ({ids.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) = {total} exceeds max_position_embeddings "
            f"({cfg.max_position_embeddings}); rope phases past the table "
            f"would silently repeat")
    eos = -1 if eos_token_id is None else int(eos_token_id)
    new = _generate_greedy(cfg, model.functional_state(), ids,
                           max_new_tokens, eos)
    return torch.cat([ids, new], dim=1)
