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

``build_moe_train_step`` is the single-device step.  A mesh, and the
hybrid dp x ep x mp plan (``apply_gpt_moe_sharding``, ``_param_specs``),
raise ``NotImplementedError`` naming ROADMAP queue A5.3 (multi-GPU
training).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .. import nn as pnn
from ..device import DeviceLike, resolve_device
from ..incubate.distributed.models.moe.moe_layer import MoELayer
from ..incubate.nn.attention import flash_attention

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
    """Causal MHA over the flash-attention entry, layout [b, s, h, d]."""

    def __init__(self, cfg: GPTMoEConfig, device: DeviceLike = None):
        super().__init__()
        h = cfg.hidden_size
        self.qkv_proj = pnn.Linear(h, 3 * h, device=device)
        self.out_proj = pnn.Linear(h, h, device=device)
        self.cfg = cfg

    def forward(self, x):
        b, s, _ = x.shape
        cfg = self.cfg
        qkv = self.qkv_proj(x).reshape(b, s, 3, cfg.num_attention_heads,
                                       cfg.head_dim)
        out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal=True)
        return self.out_proj(out.reshape(b, s, cfg.hidden_size))


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

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


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

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, input_ids):
        ids = torch.as_tensor(input_ids, device=self.device)
        pos = torch.arange(ids.shape[-1], device=self.device)
        x = self.wte(ids) + self.wpe(pos)
        for blk in self.blocks:
            x = blk(x)
        return self.lm_head(self.ln_f(x))

    def aux_losses(self):
        """The MoE blocks' aux load-balance losses of the last forward."""
        return [blk.mlp.l_aux for blk in self.blocks
                if blk.use_moe and blk.mlp.l_aux is not None]

    def functional_state(self) -> Dict[str, torch.Tensor]:
        """Parameters keyed by the JAX ``functional_state()`` names."""
        return {k: p.detach() for k, p in self.named_parameters()}


def _needs_a5(what: str):
    raise NotImplementedError(
        f"{what}: the hybrid dp x ep x mp plan belongs to multi-GPU "
        f"training, ROADMAP queue A5.3")


def _param_specs(name: str):
    _needs_a5("_param_specs")


def apply_gpt_moe_sharding(model: GPTMoEForCausalLM, mesh) -> None:
    _needs_a5("apply_gpt_moe_sharding")


def build_moe_train_step(model: GPTMoEForCausalLM, optimizer, mesh=None,
                         data_axes: Tuple[str, ...] = ("dp",),
                         compute_dtype: torch.dtype = torch.float32
                         ) -> Callable:
    """The single-device train step (mirror of ``build_moe_train_step``
    with ``mesh=None``):

        step(params, opt_state, step_no, lr, input_ids, labels)
            -> (ce, aux, new_params, new_opt_state)

    Every floating parameter is cast to ``compute_dtype`` first, and the
    model runs on the cast dict (``torch.func.functional_call``), so at
    bf16 the router sees bf16-rounded gate weights in fp32 arithmetic, as
    in JAX.  The loss is the mean CE over the given labels (logsumexp of
    the fp32 logits minus the label's) plus ``aux_loss_weight`` times the
    mean of the MoE blocks' aux losses; gradients come back in the
    parameters' dtype; the update is ``optimizer.apply(params, grads,
    opt_state, lr, step_no + 1)``.  The step keeps nothing between calls;
    after it each MoE layer's ``l_aux`` and ``tokens_dropped`` hold the
    step's values.  A mesh raises (ROADMAP A5.3)."""
    if mesh is not None:
        _needs_a5("build_moe_train_step(mesh=...)")
    cfg, dev = model.cfg, model.device

    def step(params, opt_state, step_no, lr, input_ids, labels):
        ids = torch.as_tensor(input_ids, device=dev).long()
        lab = torch.as_tensor(labels, device=dev).long()
        leaves = {k: v.detach().requires_grad_()
                  for k, v in params.items() if v.is_floating_point()}
        cast = {k: leaves[k].to(compute_dtype) if k in leaves else v
                for k, v in params.items()}
        with torch.enable_grad():
            lv = functional_call(model, cast, (ids,)).float()
            ll = lv.gather(-1, lab[..., None])[..., 0]
            ce = (torch.logsumexp(lv, dim=-1) - ll).mean()
            auxes = model.aux_losses()
            aux = (torch.stack(auxes).mean() if auxes else
                   torch.zeros((), dtype=torch.float32, device=dev))
            grads = torch.autograd.grad(ce + cfg.aux_loss_weight * aux,
                                        list(leaves.values()))
        new_params, new_state = optimizer.apply(
            params, dict(zip(leaves, grads)), opt_state, float(lr),
            int(step_no) + 1)
        return ce.detach(), aux.detach(), new_params, new_state

    return step
