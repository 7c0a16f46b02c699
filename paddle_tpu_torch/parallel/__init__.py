"""Parallel training blocks of the port (mirror of ``paddle_tpu/parallel``):
so far the single-device MoE block with its capacity and dropless train
steps (``expert.py``) and the memory engine (``memory.py``)."""
