"""Mirror of ``paddle_tpu/incubate/distributed/models``."""
