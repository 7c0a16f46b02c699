"""Distributed model pieces of the port (mirror of
``paddle_tpu/incubate/distributed``): the MoE stack on one device."""
