"""Serving plane of the port (mirror of ``paddle_tpu/inference``): the
continuous-batching engine (``serving.py``), the serving fleet
(``fleet.py``) and disaggregated prefill/decode serving (``disagg.py``)."""

from .disagg import AutoscaleConfig, DisaggRouter, KVHandoffPlanner
from .fleet import (FleetConfig, FleetRouter, OverloadRejected, Replica,
                    ReplicaSet, RouterConfig, RouterRequest)
from .serving import (ContinuousBatchingEngine, Finished, PageAllocator,
                      PrefixCache, Request)

__all__ = ["AutoscaleConfig", "ContinuousBatchingEngine", "DisaggRouter",
           "Finished", "FleetConfig", "FleetRouter", "KVHandoffPlanner",
           "OverloadRejected", "PageAllocator", "PrefixCache", "Replica",
           "ReplicaSet", "Request", "RouterConfig", "RouterRequest"]
