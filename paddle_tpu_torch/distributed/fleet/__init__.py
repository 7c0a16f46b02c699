"""Fleet helpers of the port (mirror of ``paddle_tpu/distributed/fleet``):
the elastic restart policy (``elastic.py``)."""

from .elastic import (ElasticManager, ElasticStatus, HeartbeatWriter,
                      parse_nnodes)

__all__ = ["ElasticManager", "ElasticStatus", "HeartbeatWriter",
           "parse_nnodes"]
