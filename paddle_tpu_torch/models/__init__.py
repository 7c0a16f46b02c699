"""Model families of the port (mirror of ``paddle_tpu/models``): Llama and
GPT-MoE."""

from .gpt_moe import (GPTMoEConfig, GPTMoEForCausalLM,
                      apply_gpt_moe_sharding, build_moe_train_step)
from .llama import (LLAMA_SHARDING_PLAN, LlamaConfig, LlamaForCausalLM,
                    apply_llama_sharding, build_train_step, gather_opt_state,
                    gather_params, llama_decay_mask, llama_forward,
                    make_batch_shardings, opt_state_from_jax,
                    params_from_jax, plan_spec_for)

__all__ = ["GPTMoEConfig", "GPTMoEForCausalLM", "LLAMA_SHARDING_PLAN",
           "LlamaConfig", "LlamaForCausalLM", "apply_gpt_moe_sharding",
           "apply_llama_sharding", "build_moe_train_step", "build_train_step",
           "gather_opt_state", "gather_params", "llama_decay_mask",
           "llama_forward", "make_batch_shardings", "opt_state_from_jax",
           "params_from_jax", "plan_spec_for"]
