"""Autoregressive generation with a dense KV cache for Llama.

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
serve through every path.  ``generate`` decodes greedily, samples
(temperature, then top-k, then top-p, ties at either cutoff kept; the
draws from a ``torch.Generator`` seeded from ``seed`` on the model's
device) or runs beam search (``num_beams > 1``: the prompt cache tiled to
b * num_beams rows and reordered by parent each step, finished beams
frozen, scores ``logp / len**length_penalty``).  Every decode step of
every mode attends through ``flash_decode`` (B4).  ``self_draft_params``
cuts a model to its first layers, the serving engine's speculative
drafter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.decode_attention import flash_decode
from ..ops.grouped_matmul import grouped_matmul_raw, sorted_segments
from .llama import _rope_tables

__all__ = ["generate", "quantize_params_int8", "self_draft_params"]


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


def self_draft_params(cfg, params, num_layers: int):
    """Layer-truncated self-speculative draft (mirror of
    ``self_draft_params``): the target's first ``num_layers`` decoder
    layers with its embeddings, final norm and head, as ``(draft_cfg,
    draft_params)`` for ``ContinuousBatchingEngine(draft_cfg=...,
    draft_params=...)``.  The draft shares the target's tensors (no copy);
    the ``._scale`` siblings of kept int8 layers ride along."""
    n = int(num_layers)
    if not 0 < n <= cfg.num_hidden_layers:
        raise ValueError(
            f"draft depth {n} outside (0, {cfg.num_hidden_layers}]")
    dcfg = dataclasses.replace(cfg, num_hidden_layers=n)
    dparams = {k: v for k, v in params.items()
               if not (k.startswith("model.layers.")
                       and int(k.split(".")[2]) >= n)}
    return dcfg, dparams


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


def _sample_filter(logits, temperature: float, top_k: int, top_p: float):
    """The filtered fp32 logits of ``_sample`` (``generation.py:411-422``):
    divided by the temperature, then every logit below the top_k-th largest
    and then every logit below the top-p cutoff (the smallest prefix of the
    sorted row with mass >= top_p) set to -inf; ties at either cutoff are
    kept.  logits [b, V]."""
    logits = logits.float()
    # a tensor divisor: the division is the JAX one, not a multiply by the
    # reciprocal of a scalar
    logits = logits / torch.full((), max(float(temperature), 1e-6),
                                 dtype=torch.float32, device=logits.device)
    V = logits.shape[-1]
    ninf = torch.full((), float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -min(top_k, V)][:, None]
        logits = torch.where(logits < kth, ninf, logits)
    if top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # an index past the row (rounding left cum below top_p) reads the
        # last entry, as the JAX gather clamps it
        cut = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=V - 1)
        logits = torch.where(logits < sorted_l.gather(1, cut), ninf, logits)
    return logits


def _sample(logits, gen, do_sample: bool, temperature: float, top_k: int,
            top_p: float):
    """Next tokens [b] int32 (mirror of ``_sample``): the argmax, or a draw
    from the softmax of ``_sample_filter``'s logits by the Gumbel-max rule
    (what ``jax.random.categorical`` does), its noise from ``gen``."""
    if not do_sample:
        return logits.float().argmax(dim=-1).to(torch.int32)
    logits = _sample_filter(logits, temperature, top_k, top_p)
    noise = torch.empty_like(logits).exponential_(generator=gen)
    return (logits - noise.log()).argmax(dim=-1).to(torch.int32)


def _prefill_cache(w: _Weights, ids, M: int, rows_per_prompt: int = 1):
    """Prefill ids [b, S] and write each layer's K/V into a fresh dense
    cache [L, b * rows_per_prompt, kvh, M, d] (each prompt's rows
    repeated, beam search's tiling).  Returns (last position's logits
    [b, V], k_cache, v_cache, rope tables)."""
    cfg = w.cfg
    b, S = ids.shape
    L, kvh, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                 cfg.head_dim)
    cos_tab, sin_tab = rope_tables_on(cfg, ids.device)
    x, ks, vs = _prefill(w, ids, cos_tab, sin_tab)
    k_cache = torch.zeros((L, b * rows_per_prompt, kvh, M, d), dtype=x.dtype,
                          device=ids.device)
    v_cache = torch.zeros_like(k_cache)
    for i in range(L):
        k_cache[i, :, :, :S] = ks[i].transpose(1, 2).repeat_interleave(
            rows_per_prompt, dim=0)
        v_cache[i, :, :, :S] = vs[i].transpose(1, 2).repeat_interleave(
            rows_per_prompt, dim=0)
    return w.head(x[:, -1]), k_cache, v_cache, cos_tab, sin_tab


@torch.no_grad()
def _generate(cfg, params, ids, max_new_tokens: int, eos_id: int,
              do_sample: bool = False, temperature: float = 1.0,
              top_k: int = 0, top_p: float = 1.0, seed: int = 0):
    """The new tokens [b, max_new_tokens] of greedy or sampled decoding
    (mirror of ``_generate_jit``): one prefill, then one ``_decode_step``
    per token.  After an EOS a row keeps emitting ``eos_id``."""
    w = _Weights(cfg, params)
    S = ids.shape[1]
    M = S + max_new_tokens
    gen = None
    if do_sample:
        gen = torch.Generator(device=ids.device).manual_seed(int(seed))
    logits, k_cache, v_cache, cos_tab, sin_tab = _prefill_cache(w, ids, M)
    tok = _sample(logits, gen, do_sample, temperature, top_k, top_p)
    done = tok == eos_id
    out = [tok]
    for pos in range(S, M - 1):
        logits = _decode_step(w, cos_tab, sin_tab, tok, pos, k_cache, v_cache)
        nxt = _sample(logits, gen, do_sample, temperature, top_k, top_p)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


def _generate_greedy(cfg, params, ids, max_new_tokens: int, eos_id: int):
    return _generate(cfg, params, ids, max_new_tokens, eos_id)


@torch.no_grad()
def _beam_search(cfg, params, ids, max_new_tokens: int, num_beams: int,
                 length_penalty: float, eos_id: int):
    """Beam search (mirror of ``_beam_search_jit``): one prefill per
    prompt, its cache tiled to b * num_beams rows, then ``max_new_tokens``
    - 1 decode steps over all beams, each keeping the top num_beams of
    beams x vocab (ties to the lower index, as ``lax.top_k``) and
    reordering every beam's state and cache rows by parent.  A finished
    beam's row collapses to "EOS again at +0 logp".  Returns each prompt's
    best beam [b, max_new_tokens] int32 and its score logp /
    len**length_penalty [b]."""
    w = _Weights(cfg, params)
    b, S = ids.shape
    B = int(num_beams)
    dev = ids.device
    logits, k_cache, v_cache, cos_tab, sin_tab = _prefill_cache(
        w, ids, S + max_new_tokens, B)
    logp0 = torch.log_softmax(logits.float(), dim=-1)
    V = logp0.shape[-1]
    alive, tok = _top_k(logp0, B)                       # [b, B]
    tok = tok.to(torch.int32)
    done = tok == eos_id
    gen_len = torch.ones((b, B), dtype=torch.int32, device=dev)
    toks_buf = torch.zeros((b, B, max_new_tokens), dtype=torch.int32,
                           device=dev)
    toks_buf[:, :, 0] = tok
    eos_row = torch.full((V,), float("-inf"), device=dev)
    eos_row[eos_id if eos_id >= 0 else 0] = 0.0
    base = (torch.arange(b, device=dev) * B)[:, None]
    for t in range(max_new_tokens - 1):
        logits = _decode_step(w, cos_tab, sin_tab, tok.reshape(b * B), S + t,
                              k_cache, v_cache)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, B, V)
        lp = torch.where(done[:, :, None], eos_row, lp)
        top, idx = _top_k((alive[:, :, None] + lp).reshape(b, B * V), B)
        parent = idx // V
        ntok = (idx % V).to(torch.int32)
        toks_buf = toks_buf.gather(
            1, parent[:, :, None].expand(-1, -1, max_new_tokens))
        gen_len = gen_len.gather(1, parent)
        done = done.gather(1, parent)
        rows = (base + parent).reshape(-1)
        k_cache.copy_(k_cache[:, rows])
        v_cache.copy_(v_cache[:, rows])
        gen_len = gen_len + (~done).to(torch.int32)
        toks_buf[:, :, t + 1] = ntok
        done = done | (ntok == eos_id)
        alive, tok = top, ntok
    scores = alive / gen_len.float().pow(float(length_penalty))
    best = scores.argmax(dim=1)
    sel = torch.arange(b, device=dev)
    return toks_buf[sel, best], scores[sel, best]


def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             eos_token_id: Optional[int] = None, num_beams: int = 1,
             length_penalty: float = 1.0):
    """Continuation of ``input_ids`` ([b, S] int) with a KV cache on the
    model's device; returns int32 [b, S + max_new_tokens] including the
    prompt (mirror of ``paddle_tpu.models.generation.generate``).  Greedy
    by default; ``do_sample`` enables temperature / top-k / top-p (draws
    seeded by ``seed``); ``num_beams > 1`` selects beam search (each
    prompt's best beam, scored as logp / len**length_penalty).  After an
    EOS a sequence keeps emitting ``eos_token_id``."""
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
    params = model.functional_state()
    if num_beams > 1:
        if do_sample:
            raise ValueError("beam search is deterministic: num_beams > 1 "
                             "is incompatible with do_sample=True")
        new, _ = _beam_search(cfg, params, ids, max_new_tokens,
                              int(num_beams), float(length_penalty), eos)
    else:
        new = _generate(cfg, params, ids, max_new_tokens, eos,
                        bool(do_sample), float(temperature), int(top_k),
                        float(top_p), int(seed))
    return torch.cat([ids, new], dim=1)
