"""Parallel training blocks of the port (mirror of ``paddle_tpu/parallel``):
so far the single-device dropless MoE block (``expert.py``) and the memory
engine (``memory.py``)."""
