"""Fused LLM ops and the flash-attention entry (mirror of
``paddle_tpu/incubate/nn``)."""
