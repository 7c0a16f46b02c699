"""Llama causal LM: configuration, parameters, forward, loss, train step.

Port of ``paddle_tpu/models/llama.py``: ``LlamaConfig``, ``_rope_tables``,
``LlamaForCausalLM`` (parameter container and forward), the functional
core ``llama_forward`` (``LlamaRMSNorm``, ``LlamaAttention`` with its
segment-id and FlashMask branches, ``LlamaMLP``, ``LlamaDecoderLayer``,
``LlamaModel.forward`` with its mask normalisation, and the head in one
function over the functional-state names), the loss (``_gold_logit``,
``_ce_loss``), ``llama_decay_mask``, ``_accum_fold``, the mesh parts
(``LLAMA_SHARDING_PLAN``, ``plan_spec_for``, ``apply_llama_sharding``,
``make_batch_shardings``) and ``build_train_step``: one step body, on a
mesh of any sizes (data-parallel x ZeRO-3 x Megatron tensor-parallel on
``torch.distributed``, ``_MeshPlan``) or, with ``mesh=None``, on the mesh
of one rank, which needs no process group (unmasked and token-weighted
masked, with the memory engine's remat policies and host-resident
optimizer state); with ``overlap=`` the decoder stack runs through the
communication-overlap engine (``_build_overlap_forward``).
``LlamaForCausalLM`` holds its parameters under exactly the names of the
JAX model's ``functional_state()``
(``model.layers.0.self_attn.q_proj.weight``, ``lm_head.weight``, ...),
with Paddle's ``[in, out]`` Linear layout, so a
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
        # set by apply_llama_sharding: the parameters are then this rank's
        # blocks, placed by the schedule
        self.schedule = None

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
        """Parameters keyed by the JAX ``functional_state()`` names; after
        ``apply_llama_sharding``, this rank's ``ShardedTensor`` blocks."""
        if self.schedule is not None:
            sched = self.schedule
            return {k: sched.named_sharding(k, sched.shape_of(k)).wrap(
                        p.detach(), sched.shape_of(k))
                    for k, p in self.named_parameters()}
        return {k: p.detach() for k, p in self.named_parameters()}

    @torch.no_grad()
    def load_functional_state(self, state: Dict[str, torch.Tensor]):
        """Copy a functional-state dict into the parameters (cast to their
        dtype and device).  Names must match exactly; a sharded model takes
        ``ShardedTensor`` blocks."""
        params = dict(self.named_parameters())
        unknown = sorted(set(state) - set(params))
        missing = sorted(set(params) - set(state))
        if unknown or missing:
            raise KeyError(f"state names differ: unknown {unknown[:5]}, "
                           f"missing {missing[:5]}")
        for k, t in state.items():
            t = getattr(t, "local", t)
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
        if self.schedule is not None:
            raise ValueError("this model's parameters are per-rank blocks "
                             "(apply_llama_sharding): train it with "
                             "build_train_step(mesh=...), or run the forward "
                             "of a model loaded from gather_params")
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
                    dtype: Optional[torch.dtype] = None, *, mesh=None,
                    schedule=None) -> Dict[str, torch.Tensor]:
    """A JAX ``functional_state()`` dict (numpy or JAX arrays) as torch
    tensors on ``device``, same names, same layouts.  ``dtype`` casts the
    floating weights only: int8 weights and their fp32 ``._scale``
    siblings (``quantize_params_int8``) cross unchanged.  bf16 arrays cross
    bit-exactly through an int16 view.  With ``mesh`` (or ``schedule``) the
    arrays are the global values and each comes back as this rank's
    ``ShardedTensor`` block under the schedule (``LLAMA_SHARDING_PLAN`` by
    default; another model's state passes its own: GPT-MoE the placed
    model's ``schedule``, the MoE EP block
    ``PartitionSchedule.from_moe_ep``).  A stacked hybrid state
    (``llama_hybrid.stack_llama_state``'s ``model.layers.X`` leaves, JAX's
    ``init_hybrid_state`` tree) on a hybrid mesh is placed by
    ``llama_hybrid.hybrid_param_spec``."""
    dev = resolve_device(device)
    out = {}
    for k, a in state.items():
        t = _to_torch(a)
        cast = (dtype is not None and t.is_floating_point()
                and not k.endswith("._scale"))
        out[k] = t.to(dtype=dtype if cast else t.dtype)
    if mesh is None and schedule is None:
        return {k: t.to(dev) for k, t in out.items()}
    if schedule is None:
        from .llama_hybrid import _is_stacked, shard_hybrid_state

        if any(_is_stacked(k) for k in out):
            return shard_hybrid_state({k: t.to(dev) for k, t in out.items()},
                                      mesh)
    schedule = _schedule_for(out, mesh, schedule)
    return {k: schedule.named_sharding(k, tuple(t.shape)).shard(t.to(dev))
            for k, t in out.items()}


def _schedule_for(params, mesh, schedule):
    from ..parallel.schedule import PartitionSchedule

    if schedule is not None:
        return schedule
    return PartitionSchedule.from_plan(
        mesh, {k: tuple(v.shape) for k, v in params.items()}, plan_spec_for)


def opt_state_from_jax(state, device: DeviceLike, *, flat_layout=None,
                       params=None, bucket_bytes: int = 4 << 20):
    """A JAX optimizer state as torch tensors on ``device``, with the same
    group names and keys, so both packages can start from one state: the
    flat ``{"__flat__": {group: {moment1, moment2[, master]}}}`` of
    ``init_flat_state``, the bucketed ``{"__offload__": ...}`` of
    ``init_offloaded_state`` or a per-param one.  On a mesh the arrays are
    the global values and each rank keeps its blocks: ``flat_layout`` (the
    step's ``FlatUpdateLayout``) cuts the shard-major groups (``|sm[``
    names; row-major groups stay whole), an offloaded state is re-bucketed
    by ``bucket_bytes`` in pinned host memory, and ``params`` (this rank's
    ``ShardedTensor`` params) place a per-param state."""
    dev = resolve_device(device)
    if flat_layout is None and params is None:
        return _state_to(state, dev)
    if isinstance(state, dict) and set(state) == {"__offload__"}:
        from ..parallel.memory import gather_offloaded_state

        flat = gather_offloaded_state(_state_to(state, torch.device("cpu")))
        block = opt_state_from_jax(flat, dev, flat_layout=flat_layout)
        return _memory.offload_flat_state(block, bucket_bytes)
    if isinstance(state, dict) and set(state) == {"__flat__"}:
        out = {}
        for g, gs in state["__flat__"].items():
            cut = flat_layout is not None and "|sm[" in g
            out[g] = {k: (flat_layout.block_of(_to_torch(v)) if cut
                          else _to_torch(v)).to(dev).contiguous()
                      for k, v in gs.items()}
        return {"__flat__": out}
    return {k: {n: params[k].with_local(
                    params[k].shard_like(_to_torch(v).to(dev)))
                for n, v in st.items()}
            for k, st in state.items()}


def _state_to(state, dev):
    if isinstance(state, dict):
        return {k: _state_to(v, dev) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_state_to(v, dev) for v in state)
    return _to_torch(state).to(dev)


def gather_params(tree):
    """The inverse of the per-rank placement, for checkpoints and tests:
    every ``ShardedTensor`` of a (nested) dict as its global tensor on
    every rank (a collective: every rank calls it)."""
    from ..parallel.specs import ShardedTensor

    if isinstance(tree, dict):
        return {k: gather_params(v) for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        return tree.full()
    return tree


def gather_opt_state(state, flat_layout=None):
    """The global form of this rank's optimizer state (JAX's layout): a
    flat state's shard-major blocks all-gathered into whole buffers, an
    offloaded one's buckets joined first, a per-param state's blocks
    gathered.  A collective: every rank calls it."""
    if isinstance(state, dict) and set(state) == {"__offload__"}:
        state = _memory.gather_offloaded_state(state)
    if isinstance(state, dict) and set(state) == {"__flat__"}:
        return {"__flat__": {
            g: {k: (flat_layout.gather_block(v)
                    if flat_layout is not None and "|sm[" in g else v)
                for k, v in gs.items()}
            for g, gs in state["__flat__"].items()}}
    return gather_params(state)


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


def decoder_layer_forward(x, cos, sin, cfg, weight: Callable, mm: Callable,
                          row: Callable, *, seg=None, sri=None, mesh=None,
                          attn_tp: bool = False, mlp_tp: bool = False,
                          gather: Optional[Tuple[str, ...]] = None,
                          tag: Optional[Callable] = None,
                          attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """One decoder layer: the one body of ``_forward``'s layer loop and of
    the overlap engine's ``parallel.overlap.decoder_layer_tp``.  RMSNorm,
    q/k/v with the rotary embedding (``cos``/``sin`` broadcastable to [b,
    s, h, d]), causal flash attention (B1/B2 on the card; B5/B6 under the
    segment ids ``seg``; FlashMask under the bands ``sri``) and o_proj,
    then RMSNorm and the SwiGLU MLP, each block added to the residual.

    The caller places the weights and the reductions (``name`` is the
    suffix within the layer, as ``"self_attn.q_proj.weight"``):
    ``weight(name)`` is a norm's weight, ``mm(h, name)`` the product with
    an input projection, ``row(y, name, tp)`` the product with an output
    projection, reduced over ``mp`` when ``tp``.  ``attn_tp``/``mlp_tp``:
    the block is tensor-parallel over ``mp`` (its input passes
    ``pbroadcast``).  ``gather``: None when attention runs on this rank's
    heads; else every rank runs all heads, the projections named in it
    (``"q"``, ``"k"``, ``"v"``) are all-gathered over ``mp``, and the rank
    keeps its columns for o_proj.  ``tag(t, name)`` places the memory
    engine's saveable tags.  ``attn_fn(q, k, v)`` replaces the attention
    call (the hybrid step's ring or Ulysses attention over ``sep``); None
    keeps the flash call above."""
    from ..parallel import compat

    b, s, _ = x.shape
    d, eps = cfg.head_dim, cfg.rms_norm_eps
    tag = tag if tag is not None else (lambda t, name: t)
    h = fused_rms_norm(x, weight("input_layernorm.weight"), eps)
    if attn_tp:
        h = compat.pbroadcast(h, "mp", mesh=mesh)
    qkv = []
    for r in ("q", "k", "v"):
        t = mm(h, f"self_attn.{r}_proj.weight")
        if gather is not None and r in gather:
            t = compat.all_gather(t, "mp", axis=2, mesh=mesh)
        qkv.append(t.reshape(b, s, -1, d))
    q, k, v = qkv
    q, k = fused_rotary_position_embedding(q, k, sin=sin, cos=cos)
    if attn_fn is not None:
        attn = attn_fn(q, k, v)
    elif sri is not None:
        attn = flashmask_attention_raw(q, k, v, sri, causal=True)
    else:
        attn = flash_attention(q, k, v, causal=True, q_segment_ids=seg,
                               kv_segment_ids=seg)
    attn = attn.reshape(b, s, -1)
    if gather is not None:
        cols = attn.shape[2] // int(mesh.shape["mp"])
        attn = attn.narrow(2, mesh.axis_index("mp") * cols, cols)
    out = row(attn, "self_attn.o_proj.weight", attn_tp)
    x = x + tag(out, "decoder_attn_out")
    h = fused_rms_norm(x, weight("post_attention_layernorm.weight"), eps)
    if mlp_tp:
        h = compat.pbroadcast(h, "mp", mesh=mesh)
    out = row(swiglu(mm(h, "mlp.gate_proj.weight"),
                     mm(h, "mlp.up_proj.weight")),
              "mlp.down_proj.weight", mlp_tp)
    return x + tag(out, "decoder_mlp_out")


def _forward(cfg, params, input_ids, position_ids, rope, seg, sri,
             plan=None, remat: bool = False,
             remat_policy: Optional[_memory.SavePolicy] = None,
             stack: Optional[Callable] = None):
    """``llama_forward`` on normalised masks (int32 segment ids or bands):
    the one forward body, of ``llama_forward`` and of the train step.
    ``plan`` None: the params are whole tensors and the logits are [b, s,
    vocab].  With a ``_MeshPlan`` the params are this rank's at-rest blocks
    and ``input_ids`` this rank's batch block; the layers run by explicit
    collectives (each weight cut over ``sharding`` is all-gathered for its
    product and again in the backward, ``_ZeroMatmul``; Megatron column-
    and row-parallel blocks over ``mp``; a vocab-parallel embedding and
    head), and the logits are [b, s, vocab or this rank's vocab block].
    With ``remat`` (and grad enabled) each decoder layer runs under a
    non-reentrant checkpoint that keeps what ``remat_policy`` names (None:
    nothing, full remat); under a policy that reads the tags, the layer
    tags its attention-block and MLP-block outputs ``decoder_attn_out`` and
    ``decoder_mlp_out`` (the JAX layer's ``checkpoint_name`` tags).
    ``stack(x, cos, sin, seg)`` (the overlap engine's decoder stack, which
    takes segment ids and no bands) runs the decoder layers instead of the
    loop here; each layer of either is ``decoder_layer_forward``."""
    from ..parallel import compat

    plan = plan if plan is not None else _ONE_DEVICE
    mesh = plan.mesh
    s = input_ids.shape[1]
    if rope is None:
        rope = tuple(t.to(input_ids.device) for t in _rope_tables(
            cfg.head_dim, cfg.max_position_embeddings, cfg.rope_theta))
    cos_t, sin_t = rope
    if position_ids is None:
        cos, sin = cos_t[:s][None, :, None], sin_t[:s][None, :, None]
    else:
        pid = torch.as_tensor(position_ids, device=input_ids.device).long()
        cos, sin = cos_t[pid][:, :, None], sin_t[pid][:, :, None]
    tagged = remat and remat_policy is not None and remat_policy.tagged

    def tag(t, name):
        return _memory.tag_saveable(t, name) if tagged else t

    def mm(x, name):
        w, sh = params[name], plan.leaf(name).sh_dim
        return x @ w if sh is None else _ZeroMatmul.apply(x, w, mesh, sh)

    table = params["model.embed_tokens.weight"]
    sh = plan.leaf("model.embed_tokens.weight").sh_dim
    if sh is not None:
        table = compat.all_gather(table, "sharding", axis=sh, mesh=mesh)
    if plan.vocab_split:
        vl = table.shape[0]
        lab = input_ids.long() - mesh.axis_index("mp") * vl
        hit = (lab >= 0) & (lab < vl)
        x = F.embedding(lab.clamp(0, vl - 1), table) * hit[..., None]
        x = compat.psum(x.to(table.dtype), "mp", mesh=mesh)
    else:
        x = F.embedding(input_ids.long(), table)

    def layer(x, i):
        pre = f"model.layers.{i}."

        def row(y, name, tp):
            out = mm(y, pre + name)
            return compat.psum(out, "mp", mesh=mesh) if tp else out

        return decoder_layer_forward(
            x, cos, sin, cfg, lambda n: params[pre + n],
            lambda h, n: mm(h, pre + n), row, seg=seg, sri=sri, mesh=mesh,
            attn_tp=plan.attn_tp, mlp_tp=plan.mlp_tp, gather=plan.gather,
            tag=tag)

    if stack is not None:
        if sri is not None:
            raise ValueError("the overlap stack takes segment ids, not "
                             "FlashMask bands")
        x = stack(x, cos, sin, seg)
    else:
        for i in range(cfg.num_hidden_layers):
            if remat and torch.is_grad_enabled():
                x = _memory.checkpoint_layer(layer, remat_policy, x, i)
            else:
                x = layer(x, i)
    h = fused_rms_norm(x, params["model.norm.weight"], cfg.rms_norm_eps)
    if plan.head_split:
        h = compat.pbroadcast(h, "mp", mesh=mesh)
    if cfg.tie_word_embeddings:
        return h @ table.t()
    return mm(h, "lm_head.weight")


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


# ------------------------------------------------------------ the mesh plan

# param-name suffix -> placement (``sharding``: the ZeRO-3 axis, ``mp``: the
# tensor-parallel axis); mirror of paddle_tpu's ``LLAMA_SHARDING_PLAN``.  The
# vocab of the embedding splits over both axes, mp-major.
def _plan():
    from ..parallel.specs import P

    return {
        "embed_tokens.weight": P(("mp", "sharding"), None),  # [vocab, hidden]
        "q_proj.weight": P("sharding", "mp"),       # [hidden, heads*d]
        "k_proj.weight": P("sharding", "mp"),
        "v_proj.weight": P("sharding", "mp"),
        "o_proj.weight": P("mp", "sharding"),       # [heads*d, hidden]
        "gate_proj.weight": P("sharding", "mp"),
        "up_proj.weight": P("sharding", "mp"),
        "down_proj.weight": P("mp", "sharding"),    # [inter, hidden]
        "lm_head.weight": P("sharding", "mp"),      # [hidden, vocab]
        "input_layernorm.weight": P(None),
        "post_attention_layernorm.weight": P(None),
        "norm.weight": P(None),
    }


LLAMA_SHARDING_PLAN = _plan()


def plan_spec_for(name: str, plan=None):
    """The plan's spec of the first suffix ``name`` ends with, else
    replicated (mirror of ``plan_spec_for``)."""
    from ..parallel.specs import REPLICATED

    plan = plan if plan is not None else LLAMA_SHARDING_PLAN
    for suffix, spec in plan.items():
        if name.endswith(suffix):
            return spec
    return REPLICATED


def global_param_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's global shape (the schedule's, once sharded)."""
    sched = getattr(model, "schedule", None)
    return {name: (sched.shape_of(name) if sched is not None
                   else tuple(int(d) for d in p.shape))
            for name, p in model.named_parameters()}


@torch.no_grad()
def apply_llama_sharding(model: LlamaForCausalLM, mesh, plan=None,
                         schedule=None) -> None:
    """Keep only this rank's block of every parameter, placed by the
    schedule (``PartitionSchedule.from_model``: the plan under the at-rest
    divisibility rule), as the JAX function places each parameter on the
    mesh.  The model then answers ``functional_state()`` with
    ``ShardedTensor`` blocks; its eager forward refuses to run."""
    from ..parallel.schedule import PartitionSchedule

    if model.schedule is not None:
        raise ValueError("the model is already sharded")
    if schedule is None:
        schedule = PartitionSchedule.from_model(model, mesh, plan=plan)
    for name, p in model.named_parameters():
        p.data = schedule.named_sharding(name, tuple(p.shape)).shard(
            p.data).local
    model.schedule = schedule


def make_batch_shardings(mesh, data_axes: Tuple[str, ...] = ("dp",
                                                           "sharding")):
    """The [B, ...] batch placement over the data axes present (mirror of
    ``make_batch_shardings``)."""
    from ..parallel.specs import NamedSharding, batch_partition_spec

    return NamedSharding(mesh, batch_partition_spec(mesh, data_axes))


class _ZeroMatmul(torch.autograd.Function):
    """``x @ W`` with W all-gathered over ``sharding`` from its at-rest
    block: the gathered weight is freed after the product and gathered
    again in the backward, whose weight gradient is reduce-scattered back
    to the block (ZeRO-3)."""

    @staticmethod
    def forward(ctx, x, w_block, mesh, dim):
        from ..parallel.compat import all_gather_raw

        ctx.save_for_backward(x, w_block)
        ctx.meta = (mesh, dim)
        return x @ all_gather_raw(w_block, "sharding", dim, mesh)

    @staticmethod
    def backward(ctx, dy):
        from ..parallel.compat import all_gather_raw, reduce_scatter_raw

        x, w_block = ctx.saved_tensors
        mesh, dim = ctx.meta
        w = all_gather_raw(w_block, "sharding", dim, mesh)
        dx = dy @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.reshape(-1, x.shape[-1]).t() @ dy.reshape(-1, dy.shape[-1])
        return dx, reduce_scatter_raw(dw, "sharding", dim, mesh), None, None


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """How the step uses one parameter: the dim its at-rest block is
    gathered along over ``sharding`` (None: not cut over it) and the axes
    its gradient is partial over."""

    sh_dim: Optional[int]
    partial: Tuple[str, ...]


class _OneDevice:
    """The plan of whole tensors on one device (``llama_forward``): no
    collective anywhere."""

    mesh, mp, gather = None, 1, None
    attn_tp = mlp_tp = vocab_split = head_split = False

    @staticmethod
    def leaf(name: str) -> _Leaf:
        return _Leaf(None, ())


_ONE_DEVICE = _OneDevice()


class _MeshPlan:
    """The layout decisions of the train step, from the schedule's table
    (axes of size 1 cut nothing, so on a mesh of one rank every decision is
    ``_OneDevice``'s):

    - each block (attention, MLP) is tensor-parallel when its output
      projection is split over ``mp`` (Megatron: the input passes
      ``pbroadcast``, the output is ``psum``-ed);
    - attention runs on this rank's heads when q, k and v split over ``mp``
      on whole heads (``heads % mp == 0`` and ``kv_heads % mp == 0``);
      otherwise (``gather``) q/k/v are all-gathered over ``mp``, every
      rank runs all heads and keeps its columns for ``o_proj``;
    - the embedding and the head are vocab-parallel when the vocab splits
      over ``mp``;
    - a gradient is partial over the data axes of real degree its leaf is
      not cut along at rest, and over ``mp`` for a replicated projection
      inside a tensor-parallel block."""

    def __init__(self, cfg: LlamaConfig, schedule, data_axes):
        from ..parallel.schedule import canonical_key

        mesh = schedule.mesh
        self.mesh = mesh
        sizes = dict(mesh.shape)
        self.mp = sizes.get("mp", 1)
        if "mp" in data_axes:
            raise ValueError("data_axes cannot hold the tensor-parallel "
                             "axis 'mp'")
        self.data_axes = tuple(a for a in data_axes
                               if a in mesh.axis_names and sizes[a] > 1)

        def dims(name):
            ts = schedule.table[canonical_key(name)]
            sh = mp = None
            cut = frozenset(a for axes in ts.dim_axes for a in axes
                            if sizes.get(a, 1) > 1)
            for i, axes in enumerate(ts.dim_axes):
                if "sharding" in axes and "sharding" in cut:
                    if axes[-1] != "sharding":
                        raise ValueError(f"{name}: 'sharding' must be the "
                                         f"minor axis of its entry {axes}")
                    sh = i
                if "mp" in axes and "mp" in cut:
                    mp = i
            return sh, mp, cut

        L = "model.layers.0."
        role = {r: dims(L + r + ".weight") for r in (
            "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
            "mlp.down_proj")}
        H, KV = cfg.num_attention_heads, cfg.num_key_value_heads
        qkv = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")
        self.attn_tp = role["self_attn.o_proj"][1] == 0
        self.mlp_tp = role["mlp.down_proj"][1] == 0
        self.split = {r: role[r][1] is not None for r in role}
        for block, ins in ((self.attn_tp, qkv),
                           (self.mlp_tp, ("mlp.gate_proj", "mlp.up_proj"))):
            if not block and any(self.split[r] for r in ins):
                raise ValueError(f"{ins}: split over mp while the block's "
                                 f"output projection is not; this layout is "
                                 f"not supported")
        if self.mlp_tp and not all(self.split[r] for r in ("mlp.gate_proj",
                                                           "mlp.up_proj")):
            raise ValueError("gate/up must split over mp with down_proj")
        self.local_heads = self.attn_tp and all(self.split[r] for r in qkv) \
            and H % self.mp == 0 and KV % self.mp == 0
        # q/k/v all-gathered over mp where attention cannot run locally
        self.gather = None if not self.attn_tp or self.local_heads else \
            tuple(p for p in "qkv" if self.split[f"self_attn.{p}_proj"])
        mp_partial = {r for r in qkv if self.attn_tp and not self.split[r]}
        self.vocab_split = dims("model.embed_tokens.weight")[1] == 0
        if cfg.tie_word_embeddings:
            self.head_split = self.vocab_split
        else:
            head = dims("lm_head.weight")
            if head[1] == 0:
                raise ValueError("lm_head split over mp along hidden is not "
                                 "supported")
            self.head_split = head[1] == 1
        self.leaves: Dict[str, _Leaf] = {}
        for name, ts in schedule.table.items():
            sh, _, at_rest = dims(name)
            partial = tuple(a for a in self.data_axes if a not in at_rest)
            if any(name.endswith(r + ".weight") for r in mp_partial):
                partial += ("mp",)
            self.leaves[name] = _Leaf(sh, partial)
        self._canonical = canonical_key

    def leaf(self, name: str) -> _Leaf:
        return self.leaves[self._canonical(name)]


def _vocab_parallel_nll(lv, labels, mesh):
    """Cross entropy over logits whose vocab splits over ``mp``: the max,
    the sum of exponentials and the gold logit are reduced over ``mp``
    (the reference's ``c_softmax_with_cross_entropy``); fp32."""
    import torch.distributed as dist

    from ..parallel import compat

    vl = lv.shape[-1]
    off = mesh.axis_index("mp") * vl
    lf = lv.float()
    m = compat.all_reduce_raw(lf.detach().amax(-1), "mp", mesh,
                              op=dist.ReduceOp.MAX)
    lse = torch.log(compat.psum(torch.exp(lf - m[..., None]).sum(-1), "mp",
                                mesh=mesh)) + m
    lab = labels.long() - off
    hit = (lab >= 0) & (lab < vl)
    gold = torch.where(hit, lf.gather(-1, lab.clamp(0, vl - 1)[..., None])
                       [..., 0], torch.zeros_like(lse))
    return lse - compat.psum(gold, "mp", mesh=mesh)


def _local(t):
    """A ``ShardedTensor``'s block; anything else as it is."""
    return getattr(t, "local", t)


# ---------------------------------------------------------------- train step

# options of the JAX build_train_step that belong to later work
_UNPORTED_STEP_OPTIONS = {
    "health": "the fused health probe (ROADMAP A6)",
}

_LAYER_PREFIX = "model.layers."


def _build_overlap_forward(model: LlamaForCausalLM, schedule, overlap,
                           plan: _MeshPlan, compute_dtype, remat: bool,
                           remat_policy):
    """The overlap engine's decoder stack for the mesh step (mirror of
    ``_build_overlap_forward``): ``parallel/overlap.py``'s
    ``build_overlap_stack`` on the schedule's layer shapes and pre-filter
    plan specs.  The embedding, the final norm, the head and the loss stay
    on ``_forward``'s mesh code.  The layers' at-rest blocks must be the
    engine's layout (they are, under the same plan: JAX uses one at-rest
    layout for both steps)."""
    from ..parallel.overlap import OverlapConfig, build_overlap_stack
    from ..parallel.schedule import canonical_key

    if not isinstance(overlap, OverlapConfig):
        raise TypeError("build_train_step: overlap= takes a "
                        "parallel.overlap.OverlapConfig")
    mesh = schedule.mesh
    shapes = schedule.layer_shapes()
    stack = build_overlap_stack(model.cfg, mesh, shapes,
                                schedule.plan_spec_for, overlap,
                                batch_axes=plan.data_axes, remat=remat,
                                remat_policy=remat_policy,
                                compute_dtype=compute_dtype)
    sizes = dict(mesh.shape)
    for sfx, pl in stack.layout.items():
        ts = schedule.table[canonical_key(_LAYER_PREFIX + "0." + sfx)]
        dims = {a: next((i for i, axes in enumerate(ts.dim_axes)
                         if a in axes and sizes.get(a, 1) > 1), None)
                for a in ("sharding", "mp")}
        if (dims["sharding"], dims["mp"]) != (pl.sh_dim, pl.mp_dim):
            raise ValueError(f"{sfx}: at rest {ts.describe()}, but the "
                             f"overlap layout cuts sharding dim {pl.sh_dim} "
                             f"and mp dim {pl.mp_dim}")
    L = model.cfg.num_hidden_layers
    keys = {sfx: [f"{_LAYER_PREFIX}{i}.{sfx}" for i in range(L)]
            for sfx in shapes}
    return stack, keys


def build_train_step(model: LlamaForCausalLM, optimizer, mesh=None,
                     data_axes: Tuple[str, ...] = ("dp", "sharding"),
                     compute_dtype: torch.dtype = torch.bfloat16,
                     accum_steps: int = 1,
                     accum_dtype: Optional[torch.dtype] = None,
                     remat: bool = False,
                     remat_policy: Optional[_memory.SavePolicy] = None,
                     memory: Optional[_memory.MemoryConfig] = None,
                     schedule=None, overlap=None, **later) -> Callable:
    """``build_train_step``, on one device or on a mesh:

        step(params, opt_state, step_no, lr, input_ids, labels)
            -> (loss, new_params, new_opt_state)

    - the float params are cast to ``compute_dtype`` and run through the
      forward (``_forward``) and the cross entropy; the gradients are taken
      with ``torch.autograd.grad`` over leaf copies of the params, so they
      come back in the at-rest dtype (bf16 for bf16 params);
    - ``accum_steps > 1``: ids/labels carry a leading [accum_steps] axis;
      the micro-grads sum into a ``accum_dtype`` carry (None: bf16 under
      bf16 compute, else fp32) folded into an fp32 accumulator every
      ``_accum_fold(accum_steps)`` micro-steps, or straight into the fp32
      accumulator when the carry is fp32 or the fold is 1; the update runs
      once on the mean;
    - ``attention_mask`` (segment ids, ``[b, s]`` or ``[accum_steps, b,
      s]``; 0 marks padding) runs the masked attention kernels and the
      token-weighted loss: each micro-step's token losses are summed over
      the total valid-token count of the step, clamped to at least 1 only
      in total, into an fp32 carry, so an all-padding micro-batch weighs 0
      (mirror of ``micro_step_masked``);
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
      ``llama_decay_mask``;
    - ``mesh`` (a live ``parallel.specs.Mesh`` named ``("dp", "sharding",
      "mp")``, any sizes) runs the step of every rank over explicit
      collectives, as the JAX step runs GSPMD: ``schedule`` (a
      ``PartitionSchedule``; by default the model's, or ``from_model``)
      places the params, which are ``ShardedTensor`` blocks (plain global
      tensors are cut); the global batch splits over the ``data_axes``
      present, as far as they divide it (``pick_batch_axes``; the
      micro-batch axis never splits); the forward runs by ``_MeshPlan``
      (ZeRO-3 over ``sharding``, Megatron tensor parallelism over ``mp``,
      a vocab-parallel cross entropy); losses are global means
      (token-weighted over the global count under a mask); the update runs
      on each rank's block of the shard-major flat state
      (``FlatUpdateLayout``: gradients reduce-scattered in, params
      all-gathered out), on whole row-major groups, or per tensor on
      completed gradient blocks.  On a mesh of one rank the layout is
      None, as in the JAX step;
    - ``overlap`` (a ``parallel.overlap.OverlapConfig``; needs ``mesh``)
      runs the decoder stack through the communication-overlap engine
      (``_build_overlap_forward``): the layers' ZeRO-3 weights gathered in
      flat buckets one layer ahead, their gradients reduce-scattered per
      bucket in flight and unpacked after the backward, the row-parallel
      projections on the collective-matmul ring, two-stage collectives
      with the inter-slice codec where the sharding axis spans slices.
      The same losses and gradients as ``overlap=None``;
    - ``mesh=None`` (and no ``schedule``) is the mesh of one rank, which
      needs no process group: plain tensors in, plain tensors out, and the
      update of one device on them.

    PyTorch runs eagerly: no jit and no donation (but for the offloaded
    update); the step keeps nothing from one call to the next, and the
    loss stays on the device.  The one
    host sync is the mask's negative-id check, once per step, outside the
    accumulation.  ``step.accumulate(params, ids, labels,
    attention_mask=None) -> (loss, grads)`` is the gradient half alone.
    The options in ``_UNPORTED_STEP_OPTIONS`` raise
    ``NotImplementedError``."""
    from ..parallel.compat import all_reduce_raw
    from ..parallel.schedule import PartitionSchedule
    from ..parallel.specs import Mesh, ShardedTensor, pick_batch_axes

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
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("build_train_step: mesh= takes a parallel.specs.Mesh")
    if schedule is not None and not isinstance(schedule, PartitionSchedule):
        raise TypeError("build_train_step: schedule= takes a "
                        "parallel.schedule.PartitionSchedule")
    if accum_dtype is None:
        accum_dtype = (torch.bfloat16 if compute_dtype == torch.bfloat16
                       else torch.float32)
    cfg, dev, rope = model.cfg, model.device, model.rope
    if overlap is not None and mesh is None:
        raise ValueError("overlap=OverlapConfig(...) needs a mesh")
    if mesh is None and schedule is not None:
        mesh = schedule.mesh
    plain = mesh is None
    if plain:
        if model.schedule is not None:
            raise ValueError("the model is sharded (apply_llama_sharding): "
                             "build its step with mesh=")
        mesh = Mesh((1, 1, 1), ("dp", "sharding", "mp"),
                    device_type=dev.type)
    if not mesh.live:
        raise ValueError("build_train_step(mesh=...) needs a live mesh "
                         "(parallel.specs.init_mesh)")
    if mesh.device_type not in (None, dev.type):
        raise ValueError(f"a {mesh.device_type} mesh for a model on {dev}")
    if schedule is None:
        schedule = model.schedule or PartitionSchedule.from_model(model,
                                                                  mesh)
    if schedule.mesh is not mesh:
        raise ValueError("the schedule was built over another mesh")
    plan = _MeshPlan(cfg, schedule, data_axes)
    stack = None
    if overlap is not None:
        stack, stack_keys = _build_overlap_forward(
            model, schedule, overlap, plan, compute_dtype, remat,
            remat_policy)
        in_stack = {k for ks in stack_keys.values() for k in ks}
    decay_mask = llama_decay_mask(model)
    flat_layout = schedule.flat_update_layout()
    if not flat_layout.axes:
        flat_layout = None              # one rank: nothing to cut
    fold = _accum_fold(accum_steps)
    bf16_carry = accum_steps > 1 and accum_dtype != torch.float32 \
        and fold > 1
    sizes = dict(mesh.shape)

    def grad_fn(params, ids, labels, seg, denom):
        leaves = {k: v.local.detach().requires_grad_()
                  for k, v in params.items() if v.is_floating_point()}
        run_stack, sink = None, None
        if stack is not None:
            from ..parallel.overlap import StackGrads

            # the stack packs its layers' blocks itself, cast on the way
            sink = StackGrads()
            layer_leaves = {sfx: [leaves[k] for k in ks]
                            for sfx, ks in stack_keys.items()}

            def run_stack(x, cos, sin, s):
                return stack(layer_leaves, x, cos, sin, s, sink=sink)
        cast = {k: leaves[k].to(compute_dtype) for k in leaves
                if stack is None or k not in in_stack}
        with torch.enable_grad():
            lv = _forward(cfg, cast, ids, None, rope, seg, None, plan, remat,
                          remat_policy, stack=run_stack)
            if plan.head_split:
                tok = _vocab_parallel_nll(lv, labels, mesh)
            else:
                tok = torch.logsumexp(lv.float(), dim=-1) \
                    - _gold_logit(lv, labels)
            if seg is not None:
                tok = tok * (seg > 0).float()
            loss = tok.sum() / denom
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=stack is not None)
        grads = dict(zip(leaves, grads))
        if stack is not None:
            # every bucket reduction is waited here, before anything reads
            # a gradient; the gathered leaves had none from autograd
            for sfx, gs in stack.grads(sink, layer_leaves).items():
                for k, g in zip(stack_keys[sfx], gs):
                    if grads[k] is not None:
                        raise RuntimeError(f"{k}: a bucketed leaf got a "
                                           f"gradient outside its bucket")
                    grads[k] = g
            missing = [k for k, g in grads.items() if g is None]
            if missing:
                raise RuntimeError(f"no gradient for {missing[:3]}")
        return loss.detach(), grads

    def batch_block(x, axes, dim):
        """This rank's block of the batch dim ``dim`` over ``axes``."""
        n = math.prod(sizes[a] for a in axes) if axes else 1
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + mesh.axis_index(a)
        b = x.shape[dim] // n
        return x.narrow(dim, idx * b, b)

    def psum_batch(x, axes):
        for a in axes:
            x = all_reduce_raw(x, a, mesh)
        return x

    def gradients(params, ids, labels, attention_mask):
        """(loss, grads): the global loss and this rank's gradient blocks,
        ``ShardedTensor``s partial over the axes still to sum."""
        seg = None
        if attention_mask is not None:
            seg, _ = normalize_masks(attention_mask, None, dev)
            if seg.shape != ids.shape:
                raise ValueError(f"attention_mask {tuple(seg.shape)} does not "
                                 f"match input_ids {tuple(ids.shape)}")
        bdim = 1 if accum_steps > 1 else 0
        B, s = ids.shape[bdim], ids.shape[-1]
        axes = pick_batch_axes(mesh, plan.data_axes, B)
        # ranks along a data axis that does not split this batch hold the
        # same rows: each counts 1/rep of them, so every gradient is
        # partial over every data axis and the sums stay exact
        rep = math.prod(sizes[a] for a in plan.data_axes if a not in axes)
        ids, labels = batch_block(ids, axes, bdim), batch_block(labels, axes,
                                                                bdim)
        if seg is not None:
            # every rank holds the global batch: its count is the global one
            count = (seg > 0).sum().float()
            seg = batch_block(seg, axes, bdim)
            denom = torch.clamp(count, min=1.0) * rep
        else:
            denom = float(B * s * rep)
        if accum_steps <= 1:
            loss, g = grad_fn(params, ids, labels, seg, denom)
        elif seg is not None:
            loss, g = None, None
            for i in range(accum_steps):
                li, gi = grad_fn(params, ids[i], labels[i], seg[i], denom)
                if g is None:
                    loss, g = li, {k: v.float() for k, v in gi.items()}
                else:
                    loss = loss + li
                    for k, a in g.items():
                        a += gi[k].float()
        else:
            loss, g, chunk = None, None, fold if bf16_carry else 1
            for c in range(accum_steps // chunk):
                lo = None
                for i in range(c * chunk, (c + 1) * chunk):
                    li, gi = grad_fn(params, ids[i], labels[i], None, denom)
                    loss = li if loss is None else loss + li
                    if lo is None:
                        lo = {k: v.to(accum_dtype if bf16_carry
                                      else torch.float32)
                              for k, v in gi.items()}
                    else:
                        for k, a in lo.items():
                            a += gi[k].to(a.dtype)
                if g is None:
                    g = {k: v.float() for k, v in lo.items()}
                else:
                    for k, a in g.items():
                        a += lo[k].float()
        if accum_steps > 1 and seg is None:      # the mean of the micro-steps
            loss = loss / accum_steps
            g = {k: v / accum_steps for k, v in g.items()}
        loss = psum_batch(loss, plan.data_axes)
        # the overlap stack's layer gradients come back reduced
        grads = {k: params[k].with_local(
                     v, () if stack is not None and k in in_stack
                     else plan.leaf(k).partial)
                 for k, v in g.items()}
        return loss, grads

    def apply_update(params, grads, opt_state, lr, step_no):
        if plain:       # the caller's own tensors: the one-device update
            params = {k: v.local for k, v in params.items()}
            grads = {k: v.local for k, v in grads.items()}
        if _memory.state_is_offloaded(opt_state):
            return _memory.apply_flat_offloaded(
                optimizer, params, grads, opt_state, lr, step_no + 1,
                decay_mask=decay_mask, flat_layout=flat_layout)
        if optimizer.state_is_flat(opt_state):
            return optimizer.apply_flat(params, grads, opt_state, lr,
                                        step_no + 1, decay_mask=decay_mask,
                                        flat_layout=flat_layout)
        return optimizer.apply(
            {k: _local(v) for k, v in params.items()},
            {k: _local(v.complete() if isinstance(v, ShardedTensor) else v)
             for k, v in grads.items()},
            {k: {n: _local(t) for n, t in st.items()}
             for k, st in opt_state.items()},
            lr, step_no + 1, decay_mask=decay_mask)

    def as_ids(x):
        return torch.as_tensor(x, device=dev).long()

    def placed(params):
        # on one rank a block is the whole tensor: wrap it, do not copy it
        return {k: v if isinstance(v, ShardedTensor) else
                schedule.named_sharding(k, tuple(v.shape)).wrap(v, v.shape)
                if mesh.size == 1 else
                schedule.named_sharding(k, tuple(v.shape)).shard(
                    torch.as_tensor(v, device=dev))
                for k, v in params.items()}

    def as_given(at_rest, new_params, new_state):
        """The update's result in the callers' form: plain tensors without
        a mesh, else ``ShardedTensor`` blocks of the params' placement."""
        if plain:
            return new_params, new_state

        def wrap(k, t):
            return t if isinstance(t, ShardedTensor) else \
                at_rest[k].with_local(t)

        new_params = {k: wrap(k, v) for k, v in new_params.items()}
        if _memory.state_is_offloaded(new_state) \
                or optimizer.state_is_flat(new_state):
            return new_params, new_state
        return new_params, {k: {n: wrap(k, t) for n, t in st.items()}
                            for k, st in new_state.items()}

    def accumulate(params, ids, labels, attention_mask=None):
        loss, grads = gradients(placed(params), ids, labels, attention_mask)
        if plain:
            grads = {k: v.local for k, v in grads.items()}
        return loss, grads

    def step(params, opt_state, step_no, lr, input_ids, labels,
             attention_mask=None):
        ids, lab = as_ids(input_ids), as_ids(labels)
        want = 3 if accum_steps > 1 else 2
        if ids.dim() != want or lab.shape != ids.shape \
                or (accum_steps > 1 and ids.shape[0] != accum_steps):
            raise ValueError(f"input_ids {tuple(ids.shape)} / labels "
                             f"{tuple(lab.shape)}: expected "
                             f"{'[accum_steps, b, s]' if want == 3 else '[b, s]'}")
        params = placed(params)
        loss, grads = gradients(params, ids, lab, attention_mask)
        new_params, new_state = apply_update(params, grads, opt_state,
                                             float(lr), int(step_no))
        return (loss,) + as_given(params, new_params, new_state)

    step.accumulate = accumulate
    step.schedule = schedule
    step.flat_layout = flat_layout
    step.stack = stack
    return step
