"""GPT-MoE: the causal LM whose every ``moe_every``-th FFN is a mixture of
experts (port of ``paddle_tpu/models/gpt_moe.py``).

``GPTMoEConfig`` (with ``debug()``), ``GPTMoEAttention``, ``GPTMoEBlock``
and ``GPTMoEForCausalLM`` are ``nn.Module``s built from the port's Paddle
layers (``nn/``), so their parameter names are the JAX model's
``functional_state()`` names (``blocks.0.mlp.0.weight``,
``blocks.1.mlp.w_up``, ...) and a JAX state crosses through
``params_from_jax`` and ``load_state_dict`` with no renaming.  Attention
is the port's causal flash entry (``incubate/nn/attention.py``: B1 forward
and B2 backward on the card); the dense FFN's ``nn.GELU`` is the exact erf
form; each MoE FFN is ``MoELayer`` on its capacity path (the masked
einsum), whose experts use the tanh gelu.

The hybrid dp x ep x mp plan (``_param_specs``, JAX's): the attention and
dense-FFN weights column- (``qkv_proj``, ``mlp.0``, their biases) and
row-split (``out_proj``, ``mlp.2``) over ``mp``, ``wte`` cut over ``mp``
on its hidden dim and ``lm_head`` on its vocab, the expert stacks by the
canonical EP rule (leading [E] on ``ep``, the expert hidden on ``mp``),
the gate and everything else replicated.  ``apply_gpt_moe_sharding`` keeps
each rank's block.  ``build_moe_train_step`` has one body: on a mesh it
runs the modules' forwards on the blocks through ``_Plan`` (the qkv
projection all-gathered over ``mp`` and every head run on every rank,
each rank keeping its columns for the row-split ``out_proj``, since a
column block of the packed ``[3, heads, d]`` projection is not whole
heads; Megatron blocks; the embedding's hidden blocks all-gathered; the
vocab-parallel cross entropy; ``MoELayer``'s mesh op), and ``mesh=None``
runs it on the mesh of one rank, where every decision is the meshless one.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .. import nn as pnn
from ..device import DeviceLike, resolve_device
from ..incubate.distributed.models.moe.moe_layer import MoELayer, check_mesh
from ..incubate.nn.attention import flash_attention
from ..parallel import compat

__all__ = ["GPTMoEConfig", "GPTMoEForCausalLM", "apply_gpt_moe_sharding",
           "build_moe_train_step"]


@dataclass
class GPTMoEConfig:
    """Mirror of ``paddle_tpu.models.gpt_moe.GPTMoEConfig``."""

    vocab_size: int = 32000
    hidden_size: int = 1024
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    ffn_hidden_size: int = 4096
    num_experts: int = 8
    moe_every: int = 2           # every k-th block gets an MoE FFN
    top_k: int = 2
    gate: str = "gshard"
    capacity_factor: float = 1.2
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def debug(cls):
        return cls(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, ffn_hidden_size=64, num_experts=4,
                   moe_every=2, max_position_embeddings=64)


class GPTMoEAttention(nn.Module):
    """Causal MHA over the flash-attention entry, layout [b, s, h, d].  On
    a mesh whose ``out_proj`` is row-split over ``mp`` (``plan.attn_tp``)
    the projection's column block is all-gathered, every rank runs every
    head and keeps its columns for ``out_proj``, whose partial products
    sum over ``mp`` before the bias."""

    def __init__(self, cfg: GPTMoEConfig, device: DeviceLike = None):
        super().__init__()
        h = cfg.hidden_size
        self.qkv_proj = pnn.Linear(h, 3 * h, device=device)
        self.out_proj = pnn.Linear(h, h, device=device)
        self.cfg = cfg

    def forward(self, x, plan=None):
        b, s, _ = x.shape
        cfg = self.cfg
        tp = plan is not None and plan.attn_tp
        if tp:
            x = compat.pbroadcast(x, "mp", mesh=plan.mesh)
        qkv = self.qkv_proj(x)
        if tp:
            qkv = compat.all_gather(qkv, "mp", axis=2, mesh=plan.mesh)
        qkv = qkv.reshape(b, s, 3, cfg.num_attention_heads, cfg.head_dim)
        out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal=True).reshape(b, s, cfg.hidden_size)
        if not tp:
            return self.out_proj(out)
        cols = cfg.hidden_size // plan.mp
        out = out.narrow(2, plan.mesh.axis_index("mp") * cols, cols)
        return compat.psum(out @ self.out_proj.weight, "mp",
                           mesh=plan.mesh) + self.out_proj.bias


class GPTMoEBlock(nn.Module):
    def __init__(self, cfg: GPTMoEConfig, use_moe: bool,
                 device: DeviceLike = None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ln_1 = pnn.LayerNorm(cfg.hidden_size, epsilon=eps, device=device)
        self.attn = GPTMoEAttention(cfg, device)
        self.ln_2 = pnn.LayerNorm(cfg.hidden_size, epsilon=eps, device=device)
        self.use_moe = use_moe
        if use_moe:
            self.mlp = MoELayer(cfg.hidden_size, cfg.ffn_hidden_size,
                                num_expert=cfg.num_experts, gate=cfg.gate,
                                top_k=cfg.top_k,
                                capacity_factor=cfg.capacity_factor,
                                activation="gelu", device=device)
        else:
            self.mlp = pnn.Sequential(
                pnn.Linear(cfg.hidden_size, cfg.ffn_hidden_size,
                           device=device),
                pnn.GELU(),
                pnn.Linear(cfg.ffn_hidden_size, cfg.hidden_size,
                           device=device))

    def forward(self, x, plan=None):
        x = x + self.attn(self.ln_1(x), plan)
        h = self.ln_2(x)
        if self.use_moe:
            return x + self.mlp(h, None if plan is None else plan.batch_axes)
        if plan is None or not plan.mlp_tp:
            return x + self.mlp(h)
        # Megatron: column-split mlp.0, row-split mlp.2 summed over mp
        up, act, down = self.mlp
        h = compat.pbroadcast(h, "mp", mesh=plan.mesh)
        out = compat.psum(act(up(h)) @ down.weight, "mp", mesh=plan.mesh)
        return x + (out + down.bias)


class GPTMoEForCausalLM(nn.Module):
    """Learned token and position embeddings, the blocks (MoE FFN where
    ``(i + 1) % moe_every == 0``), a final LayerNorm and a bias-free LM
    head [hidden, vocab].  ``device=None`` means ``cuda``; parameters are
    drawn from the port's default generator (``ops/random.py``) in the JAX
    model's construction order, the experts from numpy's
    ``RandomState(0)`` as ``MoELayer`` draws them."""

    def __init__(self, cfg: GPTMoEConfig, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.wte = pnn.Embedding(cfg.vocab_size, cfg.hidden_size, device=dev)
        self.wpe = pnn.Embedding(cfg.max_position_embeddings,
                                 cfg.hidden_size, device=dev)
        self.blocks = pnn.LayerList([
            GPTMoEBlock(cfg, (i + 1) % cfg.moe_every == 0, dev)
            for i in range(cfg.num_hidden_layers)])
        self.ln_f = pnn.LayerNorm(cfg.hidden_size,
                                  epsilon=cfg.layer_norm_eps, device=dev)
        self.lm_head = pnn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias_attr=False, device=dev)
        self.schedule = None

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, input_ids, plan=None):
        """Logits [b, s, vocab]; with a ``_Plan`` (the mesh step) this
        rank's batch block through the blocks' mesh forwards, the logits
        this rank's vocab block when ``lm_head`` is split."""
        if plan is None and self.schedule is not None:
            raise ValueError("the model is sharded (apply_gpt_moe_sharding): "
                             "run it through build_moe_train_step(mesh=)")
        ids = torch.as_tensor(input_ids, device=self.device)
        pos = torch.arange(ids.shape[-1], device=self.device)
        x = self.wte(ids)
        if plan is not None and plan.hidden_split:
            x = compat.gather_blocks(x, ("mp",), dim=-1, mesh=plan.mesh)
        x = x + self.wpe(pos)
        for blk in self.blocks:
            x = blk(x, plan)
        x = self.ln_f(x)
        if plan is not None and plan.head_split:
            x = compat.pbroadcast(x, "mp", mesh=plan.mesh)
        return self.lm_head(x)

    def aux_losses(self):
        """The MoE blocks' aux load-balance losses of the last forward."""
        return [blk.mlp.l_aux for blk in self.blocks
                if blk.use_moe and blk.mlp.l_aux is not None]

    def functional_state(self) -> Dict[str, torch.Tensor]:
        """Parameters keyed by the JAX ``functional_state()`` names; on a
        mesh (``apply_gpt_moe_sharding``) this rank's ``ShardedTensor``
        blocks."""
        if self.schedule is None:
            return {k: p.detach() for k, p in self.named_parameters()}
        return {k: self.schedule.named_sharding(
            k, self.schedule.shape_of(k)).wrap(p.detach(),
                                               self.schedule.shape_of(k))
            for k, p in self.named_parameters()}


# ----------------------------------------------------------- the mesh plan

def _param_specs(name: str):
    """The spec of each parameter by name (mirror of ``_param_specs``): the
    Megatron/GShard hybrid over dp x ep x mp."""
    from ..parallel.specs import P, expert_leaf_spec, is_expert_leaf

    if ".mlp.gate.weight" in name:
        return P()
    if is_expert_leaf(name):
        tails = {".mlp.w_up": P(None, "mp"), ".mlp.b_up": P("mp"),
                 ".mlp.w_down": P("mp", None), ".mlp.b_down": P(None)}
        for marker, tail in tails.items():
            if marker in name:
                return expert_leaf_spec(tail)
        return expert_leaf_spec()
    if ".qkv_proj.weight" in name or ".mlp.0.weight" in name:
        return P(None, "mp")            # column parallel
    if ".qkv_proj.bias" in name or ".mlp.0.bias" in name:
        return P("mp")
    if ".out_proj.weight" in name or ".mlp.2.weight" in name:
        return P("mp", None)            # row parallel
    if name.startswith("wte.") or name.startswith("lm_head."):
        return P(None, "mp") if name.endswith("weight") else P()
    return P()


def _schedule(model: GPTMoEForCausalLM, mesh):
    from ..parallel.schedule import PartitionSchedule

    return PartitionSchedule.from_plan(
        mesh, {k: tuple(p.shape) for k, p in model.named_parameters()},
        _param_specs)


_MOE_SUFFIXES = ("gate.weight", "w_up", "b_up", "w_down", "b_down")


@torch.no_grad()
def apply_gpt_moe_sharding(model: GPTMoEForCausalLM, mesh,
                           schedule=None) -> None:
    """Keep only this rank's block of every parameter under the dp x ep x
    mp plan (``_param_specs`` under the at-rest rule), as the JAX function
    places each parameter on the mesh; each parameter's ``placement`` is
    its ``NamedSharding``, and each MoE layer runs its op on the mesh.
    ``functional_state()`` then answers ``ShardedTensor`` blocks; the eager
    forward refuses to run."""
    check_mesh(mesh, "apply_gpt_moe_sharding")
    if model.schedule is not None:
        raise ValueError("the model is already sharded")
    schedule = schedule if schedule is not None else _schedule(model, mesh)
    for name, p in model.named_parameters():
        ns = schedule.named_sharding(name, tuple(p.shape))
        p.data = ns.shard(p.data).local
        p.placement = ns
    model.schedule = schedule
    for i, blk in enumerate(model.blocks):
        if blk.use_moe:
            pre = f"blocks.{i}.mlp."
            blk.mlp.place(mesh, {sfx: schedule.spec_for(
                pre + sfx, schedule.shape_of(pre + sfx))
                for sfx in _MOE_SUFFIXES}, cut=False)


class _Plan:
    """The layout decisions of the train step, from the schedule's table
    (axes of size 1 cut nothing, so on a mesh of one rank every decision
    is the meshless one):

    - attention is tensor-parallel when ``out_proj`` is row-split over
      ``mp`` (its ``qkv_proj`` must then be column-split), the dense FFN
      when ``mlp.2`` is (with ``mlp.0`` column-split);
    - ``hidden_split``: ``wte`` is cut on its hidden dim; ``head_split``:
      ``lm_head`` on its vocab (the vocab-parallel cross entropy);
    - a gradient is partial over the data axes of real degree its leaf is
      not cut along at rest (a value every rank of ``ep`` or ``mp`` holds
      carries its whole cotangent on each: ``pbroadcast`` before a split
      use, ``psum`` after it);
    - ``batch_axes``: the data axes that split this call's batch (set per
      call), which the MoE layers' routing gathers over."""

    def __init__(self, cfg: GPTMoEConfig, schedule, data_axes):
        mesh = schedule.mesh
        sizes = dict(mesh.shape)
        self.mesh, self.mp = mesh, int(sizes.get("mp", 1))
        if "mp" in data_axes:
            raise ValueError("data_axes cannot hold the tensor-parallel "
                             "axis 'mp'")
        self.data_axes = tuple(a for a in data_axes
                               if a in mesh.axis_names and sizes[a] > 1)
        self.batch_axes = self.data_axes
        table = schedule.table.entries

        def cut(name):
            """The dim ``mp`` cuts, and the axes the leaf is cut along."""
            ts = table[name]
            dim = next((i for i, axes in enumerate(ts.dim_axes)
                        if "mp" in axes and self.mp > 1), None)
            return dim, frozenset(a for axes in ts.dim_axes for a in axes
                                  if sizes.get(a, 1) > 1)

        self.hidden_split = cut("wte.weight")[0] == 1
        self.head_split = cut("lm_head.weight")[0] == 1
        attn = "blocks.0.attn."
        self.attn_tp = cut(attn + "out_proj.weight")[0] == 0
        if self.attn_tp != (cut(attn + "qkv_proj.weight")[0] == 1):
            raise ValueError("qkv_proj and out_proj must split over mp "
                             "together")
        dense = next((f"blocks.{i}.mlp." for i in range(
            cfg.num_hidden_layers) if (i + 1) % cfg.moe_every), None)
        self.mlp_tp = dense is not None and cut(dense + "2.weight")[0] == 0
        if dense is not None and self.mlp_tp != (cut(dense + "0.weight")[0]
                                                 == 1):
            raise ValueError("mlp.0 and mlp.2 must split over mp together")
        self.leaves = {name: tuple(a for a in self.data_axes
                                   if a not in cut(name)[1])
                       for name in table}

    def at(self, batch_axes) -> "_Plan":
        run = copy.copy(self)
        run.batch_axes = tuple(batch_axes)
        return run


def build_moe_train_step(model: GPTMoEForCausalLM, optimizer, mesh=None,
                         data_axes: Tuple[str, ...] = ("dp",),
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Callable:
    """The train step (mirror of ``build_moe_train_step``):

        step(params, opt_state, step_no, lr, input_ids, labels)
            -> (ce, aux, new_params, new_opt_state)

    Every floating parameter is cast to ``compute_dtype`` first, and the
    model runs on the cast dict (``torch.func.functional_call``), so at
    bf16 the router sees bf16-rounded gate weights in fp32 arithmetic, as
    in JAX.  The loss is the mean CE over the given labels (logsumexp of
    the fp32 logits minus the label's) plus ``aux_loss_weight`` times the
    mean of the MoE blocks' aux losses; gradients come back in the
    parameters' dtype; the update is ``optimizer.apply(params, grads,
    opt_state, lr, step_no + 1)`` per tensor.  After a step each MoE
    layer's ``l_aux`` and ``tokens_dropped`` hold the step's values.

    ``mesh`` (a live ``parallel.specs.Mesh`` named ``("dp", "ep", "mp")``,
    the model placed by ``apply_gpt_moe_sharding``) runs every rank's step
    over explicit collectives (``_Plan``): ``params`` are ``ShardedTensor``
    blocks, the global batch splits over the ``data_axes`` present as far
    as they divide it, ``ce`` is the global mean and the update runs on the
    blocks of completed gradients.  ``mesh=None`` is the mesh of one rank:
    plain tensors in and out, the same body."""
    from ..parallel.specs import Mesh, ShardedTensor, pick_batch_axes
    from .llama import _vocab_parallel_nll

    cfg, dev = model.cfg, model.device
    plain = mesh is None
    if plain:
        if model.schedule is not None:
            raise ValueError("the model is sharded (apply_gpt_moe_sharding):"
                             " build its step with mesh=")
        mesh = Mesh((1, 1, 1), ("dp", "ep", "mp"), device_type=dev.type)
    check_mesh(mesh, "build_moe_train_step")
    if mesh.device_type not in (None, dev.type):
        raise ValueError(f"a {mesh.device_type} mesh for a model on {dev}")
    schedule = model.schedule
    if schedule is None:
        if mesh.size > 1:
            raise ValueError("place the model first: "
                             "apply_gpt_moe_sharding(model, mesh)")
        schedule = _schedule(model, mesh)
    if schedule.mesh is not mesh:
        raise ValueError("the model was placed on another mesh")
    plan = _Plan(cfg, schedule, data_axes)
    sizes = dict(mesh.shape)

    def batch_block(x, axes):
        b = x.shape[0] // math.prod(sizes[a] for a in axes)
        return x.narrow(0, mesh.block_index(axes) * b, b)

    def placed(params):
        return {k: v if isinstance(v, ShardedTensor) else
                schedule.named_sharding(k, tuple(v.shape)).wrap(v, v.shape)
                if mesh.size == 1 else
                schedule.named_sharding(k, tuple(v.shape)).shard(
                    torch.as_tensor(v, device=dev))
                for k, v in params.items()}

    def step(params, opt_state, step_no, lr, input_ids, labels):
        ids = torch.as_tensor(input_ids, device=dev).long()
        lab = torch.as_tensor(labels, device=dev).long()
        at_rest = placed(params)
        B, s = ids.shape
        axes = pick_batch_axes(mesh, plan.data_axes, B)
        # ranks along a data axis that does not split this batch hold the
        # same rows: each counts 1/rep of them
        rep = math.prod(sizes[a] for a in plan.data_axes if a not in axes)
        ids, lab = batch_block(ids, axes), batch_block(lab, axes)
        leaves = {k: v.local.detach().requires_grad_()
                  for k, v in at_rest.items() if v.is_floating_point()}
        cast = {k: leaves[k].to(compute_dtype) if k in leaves else v.local
                for k, v in at_rest.items()}
        with torch.enable_grad():
            # fp32 logits (the compute-dtype ones are not kept alive); the
            # gold logit is taken first, so the backward runs its
            # logits-sized scatter last, after logsumexp's buffers are freed
            lv = functional_call(model, cast, (ids,),
                                 {"plan": plan.at(axes)}).float()
            if plan.head_split:
                nll = _vocab_parallel_nll(lv, lab, mesh)
            else:
                gold = lv.gather(-1, lab[..., None])[..., 0]
                nll = torch.logsumexp(lv, dim=-1) - gold
            ce = nll.sum() / (B * s * rep)
            auxes = model.aux_losses()
            aux = (torch.stack(auxes).mean() if auxes else
                   torch.zeros((), dtype=torch.float32, device=dev))
            grads = torch.autograd.grad(ce + cfg.aux_loss_weight * aux / rep,
                                        list(leaves.values()))
        for a in plan.data_axes:
            ce = compat.all_reduce_raw(ce.detach(), a, mesh)
        grads = {k: at_rest[k].with_local(g, plan.leaves[k]).complete().local
                 for k, g in zip(leaves, grads)}
        new_params, new_state = optimizer.apply(
            {k: v.local for k, v in at_rest.items()}, grads,
            {k: {n: getattr(t, "local", t) for n, t in st.items()}
             for k, st in opt_state.items()}, float(lr), int(step_no) + 1)
        if not plain:
            new_params = {k: at_rest[k].with_local(v)
                          for k, v in new_params.items()}
            new_state = {k: {n: at_rest[k].with_local(t)
                             for n, t in st.items()}
                         for k, st in new_state.items()}
        return ce.detach(), aux.detach(), new_params, new_state

    step.schedule = schedule
    return step
