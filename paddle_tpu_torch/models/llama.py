"""Llama causal LM: configuration, parameters, forward, loss, train step.

Port of ``paddle_tpu/models/llama.py``: ``LlamaConfig``, ``_rope_tables``,
``LlamaForCausalLM`` (parameter container and forward), the functional
core ``llama_forward`` (``LlamaRMSNorm``, ``LlamaAttention`` with its
segment-id and FlashMask branches, ``LlamaMLP``, ``LlamaDecoderLayer``,
``LlamaModel.forward`` with its mask normalisation, and the head in one
function over the functional-state names), the loss (``_gold_logit``,
``_ce_loss``), ``llama_decay_mask``, ``_accum_fold`` and the single-device
``build_train_step`` (unmasked and token-weighted masked, with the memory
engine's remat policies and host-resident optimizer state).  ``LlamaForCausalLM`` holds
its parameters under exactly the names of the JAX model's
``functional_state()`` (``model.layers.0.self_attn.q_proj.weight``,
``lm_head.weight``, ...), with Paddle's ``[in, out]`` Linear layout, so a
JAX state dict crosses through numpy with no renaming or transpose
(``params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..incubate.nn.attention import flash_attention
from ..incubate.nn.fused import (fused_rms_norm,
                                 fused_rotary_position_embedding, swiglu)
from ..ops.flashmask import flashmask_attention_raw
from ..parallel import memory as _memory


@dataclasses.dataclass
class LlamaConfig:
    """Mirror of ``paddle_tpu.models.llama.LlamaConfig``."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # sparse checkpoints: a layer is mixture-of-experts iff the checkpoint
    # carries its stacked ``mlp.experts.*`` banks and ``mlp.router.weight``
    # (generation._moe_ffn); these fields size the routing
    num_experts: int = 0
    moe_top_k: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_hidden_layers=32,
                           num_attention_heads=32, num_key_value_heads=8)

    @staticmethod
    def debug(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2,
              inter=128, max_pos=256) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab, hidden_size=hidden,
                           intermediate_size=inter, num_hidden_layers=layers,
                           num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           max_position_embeddings=max_pos,
                           rope_theta=10000.0)


def _rope_tables(head_dim: int, max_pos: int, theta: float):
    """Neox rope tables [max_pos, head_dim], computed in float64 numpy and
    rounded to fp32 (mirror of ``paddle_tpu.models.llama._rope_tables``).
    Returned on the CPU; callers move them."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                / head_dim))
    t = np.arange(max_pos, dtype=np.float64)
    emb = np.concatenate([np.outer(t, inv_freq)] * 2, axis=-1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)),
            torch.from_numpy(np.sin(emb).astype(np.float32)))


class _Weight(nn.Module):
    """One named weight: ``<name>.weight``.  Linear weights are [in, out]
    (y = x @ W), as Paddle's."""

    def __init__(self, shape, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device,
                                               dtype=dtype),
                                   requires_grad=False)


def _module(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def _decoder_layer(cfg: LlamaConfig, device, dtype) -> nn.Module:
    h, d = cfg.hidden_size, cfg.head_dim
    qd, kvd = cfg.num_attention_heads * d, cfg.num_key_value_heads * d
    inter = cfg.intermediate_size

    def w(*shape):
        return _Weight(shape, device, dtype)

    return _module(
        input_layernorm=w(h),
        self_attn=_module(q_proj=w(h, qd), k_proj=w(h, kvd),
                          v_proj=w(h, kvd), o_proj=w(qd, h)),
        post_attention_layernorm=w(h),
        mlp=_module(gate_proj=w(h, inter), up_proj=w(h, inter),
                    down_proj=w(inter, h)))


class LlamaForCausalLM(nn.Module):
    """Parameter container and serving entry of the Llama causal LM
    (mirror of ``paddle_tpu.models.llama.LlamaForCausalLM``).

    ``device=None`` means ``cuda`` (raises without a GPU); tests pass
    ``device="cpu"``.  Parameters are initialised from ``generator`` (an
    explicit ``torch.Generator`` on ``device``; seed 0 when omitted) as
    the JAX model initialises them (``paddle_tpu/nn/common.py``):
    Xavier-uniform Linear weights, Normal(0, 1) embedding, RMSNorm gains
    of one.  They are stored with ``requires_grad=False``: the train step
    (``build_train_step``) is functional and takes its gradients with
    ``torch.autograd.grad`` over leaf copies of a parameter dict."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        h = cfg.hidden_size
        self.model = _module(
            embed_tokens=_Weight((cfg.vocab_size, h), self.device, dtype),
            layers=nn.ModuleList([_decoder_layer(cfg, self.device, dtype)
                                  for _ in range(cfg.num_hidden_layers)]),
            norm=_Weight((h,), self.device, dtype))
        if not cfg.tie_word_embeddings:
            self.lm_head = _Weight((h, cfg.vocab_size), self.device, dtype)
        cos, sin = _rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                                cfg.rope_theta)
        self.register_buffer("rope_cos", cos.to(self.device), persistent=False)
        self.register_buffer("rope_sin", sin.to(self.device), persistent=False)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if p.dim() == 1:                       # RMSNorm gains
                p.fill_(1.0)
            elif name == "model.embed_tokens.weight":
                p.normal_(0.0, 1.0, generator=generator)
            else:                                  # [in, out] Linear
                limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.uniform_(-limit, limit, generator=generator)

    def functional_state(self) -> Dict[str, torch.Tensor]:
        """Parameters keyed by the JAX ``functional_state()`` names."""
        return {k: p.detach() for k, p in self.named_parameters()}

    @torch.no_grad()
    def load_functional_state(self, state: Dict[str, torch.Tensor]):
        """Copy a functional-state dict into the parameters (cast to their
        dtype and device).  Names must match exactly."""
        params = dict(self.named_parameters())
        unknown = sorted(set(state) - set(params))
        missing = sorted(set(params) - set(state))
        if unknown or missing:
            raise KeyError(f"state names differ: unknown {unknown[:5]}, "
                           f"missing {missing[:5]}")
        for k, t in state.items():
            if tuple(t.shape) != tuple(params[k].shape):
                raise ValueError(f"{k}: shape {tuple(t.shape)} != "
                                 f"{tuple(params[k].shape)}")
            params[k].copy_(t)
        return self

    def forward(self, input_ids, position_ids=None, attention_mask=None,
                startend_row_indices=None):
        """Logits [b, s, vocab] (mirror of ``LlamaForCausalLM.forward``),
        computed by ``llama_forward`` with this model's own parameters, in
        their dtype.  ``attention_mask``: a bool keep-mask or int segment
        ids [b, s] (0 marks padding); ``startend_row_indices``: FlashMask
        bands [b, mh, s, {1, 2}] (causal classes); not both."""
        ids = torch.as_tensor(input_ids, device=self.device)
        return llama_forward(self.cfg, dict(self.named_parameters()), ids,
                             position_ids, self.rope,
                             attention_mask=attention_mask,
                             startend_row_indices=startend_row_indices)

    @property
    def rope(self):
        """The fp32 rope tables (cos, sin) [max_pos, head_dim] on the
        model's device (``LlamaModel``'s ``rope_cos``/``rope_sin``
        buffers)."""
        return self.rope_cos, self.rope_sin

    def generate(self, input_ids, **kwargs):
        """KV-cached decoding: greedy, sampling or beam search
        (models/generation.py)."""
        from .generation import generate

        return generate(self, input_ids, **kwargs)


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)                 # writable copy; accepts JAX arrays too
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: torch refuses it
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(state: Dict[str, np.ndarray], device: DeviceLike,
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """A JAX ``functional_state()`` dict (numpy or JAX arrays) as torch
    tensors on ``device``, same names, same layouts.  ``dtype`` casts the
    floating weights only: int8 weights and their fp32 ``._scale``
    siblings (``quantize_params_int8``) cross unchanged.  bf16 arrays cross
    bit-exactly through an int16 view."""
    dev = resolve_device(device)
    out = {}
    for k, a in state.items():
        t = _to_torch(a)
        cast = (dtype is not None and t.is_floating_point()
                and not k.endswith("._scale"))
        out[k] = t.to(device=dev, dtype=dtype if cast else t.dtype)
    return out


def opt_state_from_jax(state, device: DeviceLike):
    """A JAX optimizer state (the flat ``{"__flat__": {group: {moment1,
    moment2[, master]}}}`` of ``init_flat_state``, or a per-param one) as
    torch tensors on ``device``, with the same group names and keys, so
    both packages can start from one state."""
    dev = resolve_device(device)
    if isinstance(state, dict):
        return {k: opt_state_from_jax(v, dev) for k, v in state.items()}
    return _to_torch(state).to(dev)


# ------------------------------------------------------------------- forward

def normalize_masks(attention_mask, startend_row_indices, device):
    """The masks as the attention takes them (mirror of
    ``LlamaModel.forward``'s normalisation, then ``LlamaAttention``'s
    check): ``startend_row_indices`` as int32; ``attention_mask`` a bool
    keep-mask or integer segment ids, as int32 segment ids (bool: kept 1,
    padding 0).  A float mask raises ``TypeError`` (casting it would invert
    the additive convention), and so do negative ids (one host sync: the
    train step normalises once per step, not once per micro-step); both
    masks given raise ``ValueError``."""
    if startend_row_indices is not None:
        startend_row_indices = torch.as_tensor(
            startend_row_indices, device=device).to(torch.int32)
    if attention_mask is not None:
        mask = torch.as_tensor(attention_mask, device=device)
        if mask.is_floating_point() or mask.is_complex():
            raise TypeError(
                "LlamaModel.attention_mask expects a bool keep-mask or int "
                f"segment ids [b, s], got dtype {mask.dtype}; convert an "
                "additive float mask with (mask == 0) first")
        if mask.dtype != torch.bool and bool((mask < 0).any()):
            raise TypeError(
                "integer attention_mask values must be >= 0 (segment ids; 0 "
                "marks padding) - additive masks are not accepted")
        attention_mask = mask.to(torch.int32)
    if attention_mask is not None and startend_row_indices is not None:
        # composing band masks with segment ids is ambiguous: a causal
        # document mask expresses packed segments on its own
        raise ValueError("pass either attention_mask (segment ids) or "
                         "startend_row_indices (FlashMask bands), not both")
    return attention_mask, startend_row_indices


def llama_forward(cfg: LlamaConfig, params: Dict[str, torch.Tensor],
                  input_ids: torch.Tensor,
                  position_ids: Optional[torch.Tensor] = None,
                  rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  attention_mask=None, startend_row_indices=None
                  ) -> torch.Tensor:
    """Logits [b, s, vocab] of the Llama causal LM from a functional-state
    dict, computed in the parameters' dtype.  One function mirroring
    ``LlamaRMSNorm`` (``fused_rms_norm``), ``LlamaAttention`` (the [b, s, h,
    d] layout, neox rope with tables cast to the compute dtype, GQA passed
    unexpanded; causal ``flash_attention``, with ``attention_mask`` segment
    ids, or ``flashmask_attention_raw`` with ``startend_row_indices``),
    ``LlamaMLP`` (SwiGLU), ``LlamaDecoderLayer`` (pre-norm residual
    blocks), ``LlamaModel.forward`` (``normalize_masks``; rope sliced to
    ``[:s]`` or gathered by ``position_ids``) and ``LlamaForCausalLM.forward``
    (``lm_head``, or the tied embedding).  ``rope``: the (cos, sin) tables
    on the ids' device (``LlamaForCausalLM.rope``); made here when not
    given."""
    seg, sri = normalize_masks(attention_mask, startend_row_indices,
                               input_ids.device)
    return _forward(cfg, params, input_ids, position_ids, rope, seg, sri)


def _forward(cfg, params, input_ids, position_ids, rope, seg, sri,
             remat: bool = False,
             remat_policy: Optional[_memory.SavePolicy] = None):
    """``llama_forward`` on normalised masks (int32 segment ids or bands).
    With ``remat`` (and grad enabled) each decoder layer runs under a
    non-reentrant checkpoint that keeps what ``remat_policy`` names (None:
    nothing, full remat); under a policy that reads the tags, the layer
    tags its attention-block and MLP-block outputs ``decoder_attn_out`` and
    ``decoder_mlp_out`` (the JAX layer's ``checkpoint_name`` tags)."""
    b, s = input_ids.shape
    H, KV, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    if rope is None:
        rope = tuple(t.to(input_ids.device) for t in _rope_tables(
            d, cfg.max_position_embeddings, cfg.rope_theta))
    cos_t, sin_t = rope
    if position_ids is None:
        cos, sin = cos_t[:s][None, :, None], sin_t[:s][None, :, None]
    else:
        pid = torch.as_tensor(position_ids, device=input_ids.device).long()
        cos, sin = cos_t[pid][:, :, None], sin_t[pid][:, :, None]
    embed = params["model.embed_tokens.weight"]
    x = F.embedding(input_ids.long(), embed)
    tagged = remat and remat_policy is not None and remat_policy.tagged

    def tag(t, name):
        return _memory.tag_saveable(t, name) if tagged else t

    def layer(x, i):
        def w(name):
            return params[f"model.layers.{i}.{name}.weight"]

        h = fused_rms_norm(x, w("input_layernorm"), eps)
        q = (h @ w("self_attn.q_proj")).reshape(b, s, H, d)
        k = (h @ w("self_attn.k_proj")).reshape(b, s, KV, d)
        v = (h @ w("self_attn.v_proj")).reshape(b, s, KV, d)
        q, k = fused_rotary_position_embedding(q, k, sin=sin, cos=cos)
        if sri is not None:
            attn = flashmask_attention_raw(q, k, v, sri, causal=True)
        else:
            attn = flash_attention(q, k, v, causal=True, q_segment_ids=seg,
                                   kv_segment_ids=seg)
        x = x + tag(attn.reshape(b, s, H * d) @ w("self_attn.o_proj"),
                    "decoder_attn_out")
        h = fused_rms_norm(x, w("post_attention_layernorm"), eps)
        return x + tag(swiglu(h @ w("mlp.gate_proj"), h @ w("mlp.up_proj"))
                       @ w("mlp.down_proj"), "decoder_mlp_out")

    checkpointed = remat and torch.is_grad_enabled()
    for i in range(cfg.num_hidden_layers):
        if checkpointed:
            x = _memory.checkpoint_layer(layer, remat_policy, x, i)
        else:
            x = layer(x, i)
    h = fused_rms_norm(x, params["model.norm.weight"], eps)
    if cfg.tie_word_embeddings:
        return h @ embed.t()
    return h @ params["lm_head.weight"]


# ---------------------------------------------------------------------- loss

def _gold_logit(lv: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label column of the logits, read in fp32 (mirror of
    ``_gold_logit``: the JAX iota-compare reduction picks the same one
    value per row)."""
    return lv.gather(-1, labels.long()[..., None])[..., 0].float()


def _ce_loss(lv: torch.Tensor, labels: torch.Tensor,
             attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming cross entropy (mirror of ``_ce_loss``): logsumexp in fp32
    over compute-dtype logits minus the gold logit; a plain mean, or with
    ``attn_mask`` a token-weighted mean guarded by ``max(w.sum(), 1)``."""
    lse = torch.logsumexp(lv.float(), dim=-1)
    nll = lse - _gold_logit(lv, labels)
    if attn_mask is None:
        return nll.mean()
    wt = (attn_mask > 0).float()
    return (nll * wt).sum() / torch.clamp(wt.sum(), min=1.0)


def llama_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Per-parameter AdamW decay mask (mirror of ``llama_decay_mask``):
    norm weights and biases are exempt."""
    return {n: not ("layernorm" in n or n.endswith("norm.weight")
                    or n.endswith(".bias"))
            for n, _ in model.named_parameters()}


def _accum_fold(accum_steps: int, cap: int = 8) -> int:
    """Largest divisor of ``accum_steps`` not above ``cap``: the bf16
    micro-grad adds between two fp32 folds (mirror of ``_accum_fold``)."""
    for f in range(min(cap, accum_steps), 0, -1):
        if accum_steps % f == 0:
            return f
    return 1


# ---------------------------------------------------------------- train step

# options of the JAX build_train_step that belong to later work
_UNPORTED_STEP_OPTIONS = {
    "mesh": "multi-GPU training (ROADMAP A5)",
    "overlap": "the communication-overlap engine (ROADMAP A5)",
    "health": "the fused health probe (ROADMAP A6)",
    "schedule": "the partitioning schedule (ROADMAP A5)",
}


def build_train_step(model: LlamaForCausalLM, optimizer,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     accum_steps: int = 1,
                     accum_dtype: Optional[torch.dtype] = None,
                     remat: bool = False,
                     remat_policy: Optional[_memory.SavePolicy] = None,
                     memory: Optional[_memory.MemoryConfig] = None,
                     **later) -> Callable:
    """The single-device ``build_train_step``:

        step(params, opt_state, step_no, lr, input_ids, labels)
            -> (loss, new_params, new_opt_state)

    - ``loss_fn`` casts the float params to ``compute_dtype`` and runs
      ``llama_forward`` and ``_ce_loss``; the gradients are taken with
      ``torch.autograd.grad`` over leaf copies of the params, so they come
      back in the at-rest dtype (bf16 for bf16 params);
    - ``accum_steps > 1``: ids/labels carry a leading [accum_steps] axis;
      the micro-grads sum into a ``accum_dtype`` carry (None: bf16 under
      bf16 compute, else fp32) folded into an fp32 accumulator every
      ``_accum_fold(accum_steps)`` micro-steps, or straight into the fp32
      accumulator when the carry is fp32 or the fold is 1; the update runs
      once on the mean;
    - ``attention_mask`` (segment ids, ``[b, s]`` or ``[accum_steps, b,
      s]``; 0 marks padding) runs the masked attention kernels and the
      token-weighted loss; at accum > 1 each micro-grad is scaled by its
      valid-token count w into an fp32 carry (no bf16 fold: the
      normalisation is known only at the end), and the sum is divided by
      the total count, clamped to at least 1 only in total, so an
      all-padding micro-batch weighs 0 (mirror of ``micro_step_masked``);
    - ``remat=True`` runs each decoder layer under a non-reentrant
      ``torch.utils.checkpoint``, keeping what ``remat_policy`` (a
      ``parallel.memory.SavePolicy``) names, or nothing when it is None;
    - ``memory`` (a ``parallel.memory.MemoryConfig``) owns the remat
      decision (``resolve_remat``) and replaces both flags;
    - the update is ``parallel.memory.apply_flat_offloaded`` for a
      host-resident state (``init_offloaded_state``; it updates the params
      and the state in place, as the JAX step donates them),
      ``optimizer.apply_flat`` for a flat state (``init_flat_state``) and
      ``optimizer.apply`` otherwise, at Adam step ``step_no + 1``, with
      ``llama_decay_mask``.

    PyTorch runs eagerly: no jit and no donation (but for the offloaded
    update); the step keeps nothing from one call to the next, and the
    loss stays on the device.  The one
    host sync is the mask's negative-id check, once per step, outside the
    accumulation.  ``step.accumulate(params, ids, labels,
    attention_mask=None) -> (loss, grads)`` is the gradient half alone.
    The options in ``_UNPORTED_STEP_OPTIONS`` raise
    ``NotImplementedError``."""
    for name, value in later.items():
        if name not in _UNPORTED_STEP_OPTIONS:
            raise TypeError(f"build_train_step: unknown option {name!r}")
        if value not in (None, False):
            raise NotImplementedError(
                f"build_train_step: {name}= is "
                f"{_UNPORTED_STEP_OPTIONS[name]}, not ported yet")
    if not isinstance(remat, bool):
        raise TypeError(f"build_train_step: remat= takes a bool, got "
                        f"{type(remat).__name__}")
    if remat_policy is not None and not isinstance(remat_policy,
                                                   _memory.SavePolicy):
        raise TypeError("build_train_step: remat_policy= takes a "
                        "parallel.memory.SavePolicy or None (full remat)")
    if memory is not None:
        if not isinstance(memory, _memory.MemoryConfig):
            raise TypeError("build_train_step: memory= takes a "
                            "parallel.memory.MemoryConfig")
        # the named policy owns the remat decision: resolve once, here
        remat, remat_policy = memory.resolve_remat()
    cfg, dev, rope = model.cfg, model.device, model.rope
    decay_mask = llama_decay_mask(model)
    if accum_dtype is None:
        accum_dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                       else torch.float32)
    fold = _accum_fold(accum_steps)
    bf16_carry = accum_steps > 1 and accum_dtype != torch.float32 \
        and fold > 1

    def grad_fn(params, ids, labels, seg=None):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in params.items() if v.is_floating_point()}
        cast = {k: leaves[k].to(compute_dtype) if k in leaves else v
                for k, v in params.items()}
        with torch.enable_grad():
            loss = _ce_loss(_forward(cfg, cast, ids, None, rope, seg, None,
                                     remat, remat_policy), labels, seg)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def zeros(params, dtype):
        return {k: torch.zeros_like(v, dtype=dtype)
                for k, v in params.items() if v.is_floating_point()}

    def accumulate_masked(params, ids, labels, seg):
        acc = zeros(params, torch.float32)
        wsum = torch.zeros((), dtype=torch.float32, device=dev)
        wloss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(accum_steps):
            loss, g = grad_fn(params, ids[i], labels[i], seg[i])
            # the true token count, no clamp: an all-padding micro-batch
            # weighs 0 (its loss and grads are already 0)
            w = (seg[i] > 0).sum().float()
            for k, a in acc.items():
                a += g[k].float() * w
            wsum += w
            wloss += loss * w
        wsum = torch.clamp(wsum, min=1.0)          # guard only the total
        return wloss / wsum, {k: a / wsum for k, a in acc.items()}

    def accumulate(params, ids, labels, attention_mask=None):
        seg = None
        if attention_mask is not None:
            seg, _ = normalize_masks(attention_mask, None, dev)
            if seg.shape != ids.shape:
                raise ValueError(f"attention_mask {tuple(seg.shape)} does not "
                                 f"match input_ids {tuple(ids.shape)}")
        if accum_steps <= 1:
            return grad_fn(params, ids, labels, seg)
        if seg is not None:
            return accumulate_masked(params, ids, labels, seg)
        acc, losses = zeros(params, torch.float32), []
        if bf16_carry:
            for c in range(accum_steps // fold):
                acc_lo = zeros(params, accum_dtype)
                for i in range(c * fold, (c + 1) * fold):
                    loss, g = grad_fn(params, ids[i], labels[i])
                    for k, a in acc_lo.items():
                        a += g[k].to(accum_dtype)
                    losses.append(loss)
                for k, a in acc.items():
                    a += acc_lo[k].float()
        else:
            for i in range(accum_steps):
                loss, g = grad_fn(params, ids[i], labels[i])
                for k, a in acc.items():
                    a += g[k].float()
                losses.append(loss)
        return (torch.stack(losses).mean(),
                {k: a / accum_steps for k, a in acc.items()})

    def apply_update(params, grads, opt_state, lr, step_no):
        if _memory.state_is_offloaded(opt_state):
            return _memory.apply_flat_offloaded(
                optimizer, params, grads, opt_state, lr, step_no + 1,
                decay_mask=decay_mask)
        if optimizer.state_is_flat(opt_state):
            return optimizer.apply_flat(params, grads, opt_state, lr,
                                        step_no + 1, decay_mask=decay_mask)
        return optimizer.apply(params, grads, opt_state, lr, step_no + 1,
                               decay_mask=decay_mask)

    def as_ids(x):
        return torch.as_tensor(x, device=dev).long()

    def step(params, opt_state, step_no, lr, input_ids, labels,
             attention_mask=None):
        ids, lab = as_ids(input_ids), as_ids(labels)
        want = 3 if accum_steps > 1 else 2
        if ids.dim() != want or lab.shape != ids.shape \
                or (accum_steps > 1 and ids.shape[0] != accum_steps):
            raise ValueError(f"input_ids {tuple(ids.shape)} / labels "
                             f"{tuple(lab.shape)}: expected "
                             f"{'[accum_steps, b, s]' if want == 3 else '[b, s]'}")
        loss, grads = accumulate(params, ids, lab, attention_mask)
        new_params, new_state = apply_update(params, grads, opt_state,
                                             float(lr), int(step_no))
        return loss, new_params, new_state

    step.accumulate = accumulate
    return step
