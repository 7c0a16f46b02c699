"""Incubating fused ops of the port (mirror of ``paddle_tpu/incubate``)."""
