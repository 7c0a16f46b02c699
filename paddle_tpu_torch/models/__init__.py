"""Model families of the port (mirror of ``paddle_tpu/models``): Llama and
GPT-MoE."""

from .gpt_moe import (GPTMoEConfig, GPTMoEForCausalLM,
                      apply_gpt_moe_sharding, build_moe_train_step)
from .llama import (LlamaConfig, LlamaForCausalLM, build_train_step,
                    llama_decay_mask, llama_forward, opt_state_from_jax,
                    params_from_jax)

__all__ = ["GPTMoEConfig", "GPTMoEForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "apply_gpt_moe_sharding", "build_moe_train_step",
           "build_train_step", "llama_decay_mask", "llama_forward",
           "opt_state_from_jax", "params_from_jax"]
