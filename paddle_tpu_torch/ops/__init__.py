"""Kernels of the port and their plain PyTorch versions (mirror of
``paddle_tpu/ops/pallas``), and the plain ops the kernels' entries route
to: the softmax attention and dropout (``nn_ops.py``) and the random
generator (``random.py``).  Every kernel launcher is a registered operator
of the ``paddle_tpu_torch`` namespace (``_registry.py``)."""
