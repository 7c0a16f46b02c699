"""Optimizers of the port (mirror of ``paddle_tpu/optimizer``)."""

from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
