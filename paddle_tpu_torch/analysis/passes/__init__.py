"""The port's analysis passes: the Graph Doctor's graph passes
(``dtype_promotion`` DT, ``donation`` DON, ``memory_budget`` MEM,
``health_probe`` HEALTH, and above one rank ``collective_order`` COLL,
``collective_budget`` COMM, ``hlo_checks`` HLO002 and
``sharding_consistency`` SHARD; each self-registers with
``@register_pass`` when ``core.resolve_passes`` imports ``GRAPH_PASSES``),
the call-driven
``retrace`` sentinel (RT), and the Concurrency Doctor's lock-discipline
pass (RACE001-004, driven by ``analysis/concurrency.py``)."""

#: the modules whose import registers the graph passes
GRAPH_PASSES = ("dtype_promotion", "donation", "memory_budget",
                "health_probe", "collective_order", "collective_budget",
                "hlo_checks", "sharding_consistency")
