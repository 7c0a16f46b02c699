"""Llama model family of the port (mirror of ``paddle_tpu/models``)."""

from .llama import (LlamaConfig, LlamaForCausalLM, build_train_step,
                    llama_decay_mask, llama_forward, opt_state_from_jax,
                    params_from_jax)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "build_train_step",
           "llama_decay_mask", "llama_forward", "opt_state_from_jax",
           "params_from_jax"]
