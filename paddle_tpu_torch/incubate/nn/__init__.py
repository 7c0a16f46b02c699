"""Fused LLM ops (``fused_rms_norm``, ``fused_rotary_position_embedding``,
``swiglu``, ``fused_moe``) and the flash-attention entry (mirror of
``paddle_tpu/incubate/nn``)."""
