"""The canonical SpecLayout extractors: one per-tensor ``(mesh axes per
dim, dtype, memory kind)`` table per stack.

Port of ``paddle_tpu/analysis/sharding.py``.  Each stack of the port
places the same parameters by its own rule: the mesh step by its
``PartitionSchedule`` (``parallel/schedule.py``), the overlap engine by
its layout plan (``overlap.stack_layout_plan``), the hybrid bodies by
``hybrid_param_spec``, serving by the engine's concrete params, expert
parallelism by ``expert.moe_ep_layout``.  This module walks each rule and
produces one comparable ``parallel.specs.SpecLayout``; the tables are
what ``passes/sharding_consistency.py`` audits (SHARD002-004, SHARD003
across the stacks) and what the schedule is checked against (SCHED001:
``check_schedule_derivation``, ``check_stack_plan_derivation``).

Canonical keys collapse the layer index (``model.layers.*.self_attn.
q_proj.weight``, ``schedule.canonical_key``): every stack places all
decoder layers alike.  The hybrid stack's leading [L] dim (placed over
pp) is the placement of the layer set, not of the tensor, so its
per-layer entries drop it.  The extractors are plan math over global
shapes: an abstract mesh will do.
"""

from __future__ import annotations

from typing import Dict, List

from ..parallel.schedule import canonical_key
from ..parallel.specs import (SpecLayout, TensorSpec, _dtype_name,
                              filter_divisible_spec, layout_from_arrays,
                              layout_mesh_axes, spec_to_dim_axes)
from .exemptions import apply_exemptions
from .findings import Finding, Report

_PASS = "sharding_consistency"


def collapse_layers(layout: SpecLayout) -> SpecLayout:
    """Fold per-layer entries onto their canonical key; the layers of one
    role must carry the same spec."""
    entries: Dict[str, TensorSpec] = {}
    for name, ts in layout.items():
        key = canonical_key(name)
        prev = entries.get(key)
        if prev is not None and prev != ts:
            raise ValueError(
                f"{key}: layers disagree within one stack "
                f"({prev.describe()} vs {ts.describe()}); the canonical "
                f"table assumes one spec per layer role")
        entries[key] = ts
    return SpecLayout(mesh_axes=layout.mesh_axes, entries=entries)


def _params(model):
    """(name, global shape, dtype name) of every parameter."""
    from ..models.llama import global_param_shapes

    shapes = global_param_shapes(model)
    return [(name, shapes[name], _dtype_name(p.dtype))
            for name, p in model.named_parameters()]


# ---------------------------------------------------------------------------
# per-stack extractors
# ---------------------------------------------------------------------------


def extract_mesh_layout(model, mesh, plan=None) -> SpecLayout:
    """The mesh step's table (``build_train_step(mesh=...)`` without
    overlap): the plan (``LLAMA_SHARDING_PLAN`` by default) under the
    at-rest divisibility rule, which is what ``apply_llama_sharding``
    places.  JAX's ``extract_gspmd_layout``."""
    from ..models.llama import plan_spec_for

    entries: Dict[str, TensorSpec] = {}
    for name, shape, dt in _params(model):
        spec = filter_divisible_spec(plan_spec_for(name, plan), shape, mesh)
        entries[name] = TensorSpec(shape=shape, dtype=dt,
                                   dim_axes=spec_to_dim_axes(spec,
                                                             len(shape)))
    return collapse_layers(
        SpecLayout(mesh_axes=layout_mesh_axes(mesh), entries=entries))


def extract_overlap_layout(model, mesh, oc=None, plan=None) -> SpecLayout:
    """The overlap stack's table: the decoder-layer leaves from the
    engine's own layout plan (``overlap.stack_layout_plan``, the bucket
    plan kept on the table as ``buckets``/``sync_suffixes``), the plan's
    rule for the leaves outside the engine (embedding, final norm, head).
    """
    from ..models.llama import _LAYER_PREFIX, plan_spec_for
    from ..parallel import overlap as _ov
    from ..parallel.specs import filter_spec_to_mesh

    oc = oc if oc is not None else _ov.OverlapConfig()
    shapes = _ov.llama_layer_shapes(model.cfg)
    layout, buckets, sync = _ov.stack_layout_plan(
        shapes, mesh,
        lambda sfx: filter_spec_to_mesh(plan_spec_for(sfx, plan), mesh), oc)
    params = {name: (shape, dt) for name, shape, dt in _params(model)}
    entries: Dict[str, TensorSpec] = {}
    for suffix, place in layout.items():
        dims = [() for _ in place.shape]
        if place.sh_dim is not None:
            dims[place.sh_dim] = ("sharding",)
        if place.mp_dim is not None:
            dims[place.mp_dim] = ("mp",)
        entries[f"{_LAYER_PREFIX}*.{suffix}"] = TensorSpec(
            shape=tuple(place.shape),
            dtype=params[f"{_LAYER_PREFIX}0.{suffix}"][1],
            dim_axes=tuple(dims))
    for name, (shape, dt) in params.items():
        if name.startswith(_LAYER_PREFIX):
            continue
        spec = filter_divisible_spec(plan_spec_for(name, plan), shape, mesh)
        entries[name] = TensorSpec(shape=shape, dtype=dt,
                                   dim_axes=spec_to_dim_axes(spec,
                                                             len(shape)))
    out = SpecLayout(mesh_axes=layout_mesh_axes(mesh), entries=entries)
    out.buckets = buckets          # introspection riders (not compared)
    out.sync_suffixes = sync
    return out


def extract_hybrid_layout(model, mesh, plan=None) -> SpecLayout:
    """The hybrid gpipe/1F1B stack's table: ``hybrid_param_spec`` over the
    stacked state's shapes, the leading [L] dim dropped."""
    from ..models.llama import _LAYER_PREFIX
    from ..models.llama_hybrid import hybrid_param_spec

    L = model.cfg.num_hidden_layers
    entries: Dict[str, TensorSpec] = {}
    for name, shape, dt in _params(model):
        if name.startswith(_LAYER_PREFIX):
            suffix = name[len(_LAYER_PREFIX):].split(".", 1)[1]
            full = hybrid_param_spec(_LAYER_PREFIX + suffix, (L,) + shape,
                                     mesh, plan)
            dims = spec_to_dim_axes(full, len(shape) + 1)[1:]
        else:
            dims = spec_to_dim_axes(hybrid_param_spec(name, shape, mesh,
                                                      plan), len(shape))
        entries[name] = TensorSpec(shape=shape, dtype=dt, dim_axes=dims)
    return collapse_layers(
        SpecLayout(mesh_axes=layout_mesh_axes(mesh), entries=entries))


def extract_serving_layout(engine) -> SpecLayout:
    """The serving stack's table: the engine's committed params as they
    are (one device: replicated, quantized dtypes visible)."""
    return collapse_layers(layout_from_arrays(engine.params))


def extract_moe_ep_layout(cfg, mesh, dtype: str = "float32") -> SpecLayout:
    """The expert-parallel MoE stack's table: ``expert.moe_ep_layout``
    (expert-stacked leaves lead [E] on ``ep``, shared leaves replicate)."""
    from ..parallel.expert import moe_ep_layout

    return moe_ep_layout(cfg, mesh, dtype=dtype)


# ---------------------------------------------------------------------------
# table-level checks as Reports
# ---------------------------------------------------------------------------


def _report(findings, exemptions, target) -> Report:
    active, suppressed = apply_exemptions(findings, exemptions)
    return Report(target=target, findings=active, suppressed=suppressed,
                  passes_run=(_PASS,))


def check_layout(layout: SpecLayout, *, replicated_min_bytes=None,
                 ignore_axes=(), exemptions=None,
                 target: str = "layout") -> Report:
    """SHARD002 (replication waste) and SHARD004 (shard padding) over one
    canonical table; ``ignore_axes`` are the data axes the plan
    replicates params over by design (dp, pp, sep)."""
    from .passes.sharding_consistency import (REPLICATED_MIN_BYTES,
                                              replication_waste_findings,
                                              shard_padding_findings)

    mb = (REPLICATED_MIN_BYTES if replicated_min_bytes is None
          else replicated_min_bytes)
    return _report(replication_waste_findings(layout, mb,
                                              ignore_axes=ignore_axes)
                   + shard_padding_findings(layout), exemptions, target)


def check_cross_stack(layouts: Dict[str, SpecLayout], *, exemptions=None,
                      target: str = "cross_stack") -> Report:
    """SHARD003 across two or more stacks' tables."""
    from .passes.sharding_consistency import cross_stack_findings

    return _report(cross_stack_findings(layouts), exemptions, target)


def schedule_divergence_findings(schedule, layouts: Dict[str, SpecLayout]
                                 ) -> List[Finding]:
    """SCHED001: the schedule's canonical table differs from a stack's
    extracted table (the key sets and every ``TensorSpec`` exactly)."""
    findings = []
    st = schedule.table
    for stack, lo in sorted(layouts.items()):
        for name in sorted(set(st.entries) - set(lo.entries)):
            findings.append(Finding(
                code="SCHED001", pass_name=_PASS, severity="error",
                message=f"{name}: in the schedule's table but absent from "
                        f"stack '{stack}': the derivation and the stack "
                        f"disagree on the tensor set", arg_path=name,
                data={"tensor": name, "stack": stack,
                      "kind": "missing_in_stack"}))
        for name in sorted(set(lo.entries) - set(st.entries)):
            findings.append(Finding(
                code="SCHED001", pass_name=_PASS, severity="error",
                message=f"{name}: stack '{stack}' places a tensor the "
                        f"schedule does not know: the canonical table is "
                        f"incomplete", arg_path=name,
                data={"tensor": name, "stack": stack,
                      "kind": "missing_in_schedule"}))
        for name in sorted(set(st.entries) & set(lo.entries)):
            a, b = st[name], lo[name]
            if a == b:
                continue
            findings.append(Finding(
                code="SCHED001", pass_name=_PASS, severity="error",
                message=f"{name}: the schedule derives ({a.describe()}) but "
                        f"stack '{stack}' places ({b.describe()}): the "
                        f"derivation moved a placement", arg_path=name,
                data={"tensor": name, "stack": stack,
                      "schedule": a.describe(), "stack_spec": b.describe()}))
    return findings


def check_schedule_derivation(schedule, layouts: Dict[str, SpecLayout],
                              *, exemptions=None,
                              target: str = "schedule_derivation"
                              ) -> Report:
    """SCHED001 of the schedule against one or more stacks' tables."""
    return _report(schedule_divergence_findings(schedule, layouts),
                   exemptions, target)


def check_stack_plan_derivation(schedule, model, mesh, oc=None,
                                *, exemptions=None,
                                target: str = "schedule_stack_plan"
                                ) -> Report:
    """SCHED001 of the overlap derivation: the schedule's ``stack_plan``
    (leaf layout, bucket plan, sync leaves) equals the engine's own
    ``stack_layout_plan`` seeded from the model's plan rule."""
    from ..models.llama import plan_spec_for
    from ..parallel import overlap as _ov
    from ..parallel.specs import filter_spec_to_mesh

    oc = oc if oc is not None else _ov.OverlapConfig()
    shapes = _ov.llama_layer_shapes(model.cfg)
    layout, buckets, sync = _ov.stack_layout_plan(
        shapes, mesh, lambda sfx: filter_spec_to_mesh(plan_spec_for(sfx),
                                                      mesh), oc)
    plan = schedule.stack_plan(oc, shapes=shapes)
    findings = []
    if (plan.layout, plan.buckets, plan.sync_suffixes) \
            != (layout, buckets, sync):
        diffs = []
        if plan.layout != layout:
            moved = [s for s in sorted(shapes)
                     if plan.layout.get(s) != layout.get(s)]
            diffs.append(f"leaf placements differ on {moved}")
        if plan.buckets != buckets:
            diffs.append(f"bucket plan {plan.buckets} vs {buckets}")
        if plan.sync_suffixes != sync:
            diffs.append(f"sync leaves {plan.sync_suffixes} vs {sync}")
        findings.append(Finding(
            code="SCHED001", pass_name=_PASS, severity="error",
            message="schedule.stack_plan diverges from the overlap engine's "
                    "stack_layout_plan: " + "; ".join(diffs),
            data={"diffs": diffs}))
    return _report(findings, exemptions, target)


def flagship_layouts(model, mesh, overlap_config=None
                     ) -> Dict[str, SpecLayout]:
    """The training stacks' tables for one model on one mesh (the
    SHARD003 probe): the mesh step's and the overlap stack's, and the
    hybrid stack's when the mesh carries the hybrid axes."""
    from ..models.llama_hybrid import HYBRID_AXES

    out = {"mesh": extract_mesh_layout(model, mesh),
           "overlap": extract_overlap_layout(model, mesh,
                                             oc=overlap_config)}
    if all(a in mesh.axis_names for a in HYBRID_AXES):
        out["hybrid"] = extract_hybrid_layout(model, mesh)
    return out


__all__ = ["check_cross_stack", "check_layout",
           "check_schedule_derivation", "check_stack_plan_derivation",
           "collapse_layers", "extract_hybrid_layout", "extract_mesh_layout",
           "extract_moe_ep_layout", "extract_overlap_layout",
           "extract_serving_layout", "flagship_layouts",
           "schedule_divergence_findings"]
