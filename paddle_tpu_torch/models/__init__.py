"""Model families of the port (mirror of ``paddle_tpu/models``): Llama and
GPT-MoE, and the hybrid-parallel Llama step (``llama_hybrid.py``)."""

from .gpt_moe import (GPTMoEConfig, GPTMoEForCausalLM,
                      apply_gpt_moe_sharding, build_moe_train_step)
from .llama import (LLAMA_SHARDING_PLAN, LlamaConfig, LlamaForCausalLM,
                    apply_llama_sharding, build_train_step, gather_opt_state,
                    gather_params, llama_decay_mask, llama_forward,
                    make_batch_shardings, opt_state_from_jax,
                    params_from_jax, plan_spec_for)
from .llama_hybrid import (HYBRID_AXES, build_hybrid_train_step, hybrid_mesh,
                           hybrid_param_spec, init_hybrid_state,
                           shard_hybrid_state, stack_llama_state,
                           unstack_llama_state)

__all__ = ["GPTMoEConfig", "GPTMoEForCausalLM", "HYBRID_AXES",
           "LLAMA_SHARDING_PLAN",
           "LlamaConfig", "LlamaForCausalLM", "apply_gpt_moe_sharding",
           "apply_llama_sharding", "build_hybrid_train_step",
           "build_moe_train_step", "build_train_step", "gather_opt_state",
           "gather_params", "hybrid_mesh", "hybrid_param_spec",
           "init_hybrid_state", "llama_decay_mask", "llama_forward",
           "make_batch_shardings", "opt_state_from_jax", "params_from_jax",
           "plan_spec_for", "shard_hybrid_state", "stack_llama_state",
           "unstack_llama_state"]
