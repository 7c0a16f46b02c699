"""The port's analysis passes: the Graph Doctor's graph passes
(``dtype_promotion`` DT, ``donation`` DON, ``memory_budget`` MEM,
``health_probe`` HEALTH; each self-registers with ``@register_pass`` when
``core.resolve_passes`` imports ``GRAPH_PASSES``), the call-driven
``retrace`` sentinel (RT), and the Concurrency Doctor's lock-discipline
pass (RACE001-004, driven by ``analysis/concurrency.py``)."""

#: the modules whose import registers the graph passes
GRAPH_PASSES = ("dtype_promotion", "donation", "memory_budget",
                "health_probe")
