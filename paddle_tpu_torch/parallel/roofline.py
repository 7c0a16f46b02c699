"""The roofline step-time estimator and the enumerated partitioning search.

Port of ``paddle_tpu/parallel/roofline.py``.  The joint tuner
(``schedule.tune_schedule_config``) walks a lattice cheapest-first and
builds and measures each point; this module is its analytic half: a
closed-form step time of a ``(PartitionPoint, MemoryConfig, OverlapConfig,
codec)`` point, so that the walk ranks the points first and builds only
the top K (``tune_schedule_config(predict=True)``), the measured peak and
DCN gates staying the verdict.

Three layers:

- the chip table and the primitives: ``CHIP_SPECS`` (the reference's four
  TPU rows, and the ``"h100"`` row measured on the card, each constant's
  run named in ``CHIP_SOURCES``), ``matmul_time``, ``elementwise_time``,
  ``collective_time`` and ``ring_wire_cost``, the one copy of the ring
  cost model (the Graph Doctor's COMM004 pass prices a capture with it, so
  predicted and measured wire bytes share their arithmetic);
- the estimate: ``ModelCostSheet`` (a decoder's per-layer weights and
  FLOPs from a ``LlamaConfig``), ``predict_wire_table`` (the overlap
  engine's collectives per step, ICI and DCN, on the codec's packed
  widths), ``predict_peak_bytes`` (a structural peak, calibrated on one
  measured point) and ``estimate_step_time``: the larger of the compute and
  HBM rooflines, remat's recompute folded in, plus the collective time the
  overlap cannot hide;
- the search: ``enumerate_partitionings`` (tactic compositions over a
  pod-shaped mesh, pruned by divisibility and by the peak) and
  ``rank_partitionings``.

Every time is a plain Python float and every byte count a Python int, in
the reference's order of operations.  The estimates are the reference's
but for what this package's engine does differently: its overlap engine
issues every collective explicitly and its capture counts each of them,
where the reference's pins counted only the collectives its jaxpr named,
so three of its wire terms differ (``predict_wire_table``); and its
stochastic int8 encode holds a working set the reference's fused encode
does not (``predict_peak_bytes``).

The ``"h100"`` row has no DCN rate: the card's machine is one host, so no
inter-host link was measured, and an estimate that puts bytes on DCN with
it raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .memory import _ACT_KEEP_FACTOR, REMAT_RECOMPUTE_FACTOR

__all__ = [
    "ChipSpec", "CHIP_SPECS", "CHIP_SOURCES", "chip_spec", "ring_wire_cost",
    "matmul_time", "elementwise_time", "collective_time",
    "ModelCostSheet", "llama_cost_sheet", "predict_wire_table",
    "predict_peak_bytes", "StepTimeEstimate", "estimate_step_time",
    "estimate_joint_config", "joint_estimator",
    "enumerate_partitionings", "rank_partitionings",
]


# ---------------------------------------------------------------------------
# the chip table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One chip's roofline constants.  ``hbm_bytes`` is the per-chip
    capacity the feasibility pruner checks against; bandwidths are per-chip
    aggregates (ICI: the ring model's per-hop currency, all links combined;
    DCN: the per-host share).  A constant that was not measured is NaN."""

    name: str
    peak_bf16_flops: float
    hbm_bytes_per_s: float
    hbm_bytes: int
    ici_bytes_per_s: float
    dcn_bytes_per_s: float

    def replace(self, **kw) -> "ChipSpec":
        return dataclasses.replace(self, **kw)


#: The chip table.  The four TPU rows are the reference's spec-sheet rows,
#: byte for byte (the parity tests price the reference's cells on them);
#: the ``"h100"`` row is this port's card, each constant measured there
#: (``CHIP_SOURCES``).
CHIP_SPECS: Dict[str, ChipSpec] = {
    # -- the reference's spec-sheet rows (paddle_tpu/parallel/roofline.py)
    "v4": ChipSpec("v4", 275e12, 1228e9, 32 << 30, 100e9, 6.25e9),
    "v5e": ChipSpec("v5e", 197e12, 819e9, 16 << 30, 45e9, 6.25e9),
    "v5p": ChipSpec("v5p", 459e12, 2765e9, 95 << 30, 100e9, 6.25e9),
    "v6e": ChipSpec("v6e", 918e12, 1640e9, 32 << 30, 90e9, 6.25e9),
    # -- measured on NVIDIA H100 80GB HBM3 cards at their 700 W limit
    "h100": ChipSpec("h100", 788110778464372.0, 3018414654828.2754,
                     85017493504, 321123721157.2959, math.nan),
}

_REFERENCE_ROW = ("the reference's spec-sheet row "
                  "(paddle_tpu/parallel/roofline.py CHIP_SPECS)")

#: Where each constant of each row comes from.  The ``"h100"`` entries name
#: the run (the script that measured it and the PERF.md entry that records
#: it with the card's name and power limit).
CHIP_SOURCES: Dict[str, Dict[str, str]] = {
    **{name: {f: _REFERENCE_ROW for f in ("peak_bf16_flops",
                                           "hbm_bytes_per_s", "hbm_bytes",
                                           "ici_bytes_per_s",
                                           "dcn_bytes_per_s")}
       for name in ("v4", "v5e", "v5p", "v6e")},
    "h100": {
        "peak_bf16_flops": "chip_smoke.py roofline_constants: one bf16 "
                           "8192^3 torch.matmul, 2 n^3 over its CUDA-event "
                           "time (PERF.md run RF1)",
        "hbm_bytes_per_s": "chip_smoke.py roofline_constants: a 2 GiB "
                           "device-to-device copy_, bytes read plus written "
                           "over its CUDA-event time (PERF.md run RF1)",
        "hbm_bytes": "chip_smoke.py roofline_constants: "
                     "torch.cuda.mem_get_info total (PERF.md run RF1)",
        "ici_bytes_per_s": "tests/test_torch_cuda_kernels.py "
                           "test_link_rate_on_four_cards: an NCCL "
                           "all-gather on four cards, ring_wire_cost over "
                           "its time (PERF.md run RF2)",
        "dcn_bytes_per_s": "unmeasured: the card's machine is one host",
    },
}


def chip_spec(chip) -> ChipSpec:
    """Resolve a chip argument: a ChipSpec passes through, a name looks
    up the table (KeyError names the known chips)."""
    if isinstance(chip, ChipSpec):
        return chip
    try:
        return CHIP_SPECS[str(chip)]
    except KeyError:
        raise KeyError(f"unknown chip {chip!r}; known: "
                       f"{sorted(CHIP_SPECS)} (or pass a ChipSpec)")


def _rate(spec: ChipSpec, field: str) -> float:
    """``spec``'s ``field``, refused when it was not measured."""
    v = getattr(spec, field)
    if math.isnan(v):
        raise ValueError(f"chip {spec.name!r}: {field} is unmeasured ("
                         f"{CHIP_SOURCES.get(spec.name, {}).get(field, '')}"
                         f"); an estimate that puts bytes there needs a "
                         f"measured rate (pass a ChipSpec)")
    return v


def ring_wire_cost(kind: str, nbytes: int, g: int) -> int:
    """Bytes each participant sends under the ring cost model of one
    collective over a group of ``g``, from the INPUT buffer's size (the
    one copy: the COMM004 pass, ``analysis.passes.collective_budget``,
    prices a capture with it): a gather moves the input to g-1 peers, a
    reduce-scatter and an all-to-all (g-1)/g of it, an all-reduce both, a
    permute the buffer once."""
    if g <= 1:
        return 0
    if kind == "allgather":
        return nbytes * (g - 1)
    if kind == "reducescatter":
        return nbytes * (g - 1) // g
    if kind == "allreduce":
        return 2 * nbytes * (g - 1) // g
    if kind == "alltoall":
        return nbytes * (g - 1) // g
    return nbytes                       # collectivepermute


def _norm_kind(kind: str) -> str:
    return kind.replace("_", "").replace("-", "")


# ---------------------------------------------------------------------------
# the roofline primitives
# ---------------------------------------------------------------------------


def matmul_time(m: int, n: int, k: int, *, bytes_per_el: int = 2,
                peak_flops: Optional[float] = None,
                hbm_bytes_per_s: Optional[float] = None,
                chip="h100") -> float:
    """The compute/HBM roofline of one (m,k)x(k,n) matmul: max(compute,
    memory) seconds."""
    spec = chip_spec(chip)
    peak = peak_flops if peak_flops is not None else spec.peak_bf16_flops
    bw = (hbm_bytes_per_s if hbm_bytes_per_s is not None
          else spec.hbm_bytes_per_s)
    flops = 2.0 * m * n * k
    bytes_moved = bytes_per_el * (m * k + k * n + m * n)
    return max(flops / peak, bytes_moved / bw)


def elementwise_time(numel: int, bytes_per_el: int = 4, *,
                     hbm_bytes_per_s: Optional[float] = None,
                     chip="h100") -> float:
    """An HBM-bound elementwise op: each element read and written once."""
    bw = (hbm_bytes_per_s if hbm_bytes_per_s is not None
          else chip_spec(chip).hbm_bytes_per_s)
    return 2.0 * numel * bytes_per_el / bw


def collective_time(bytes_total: int, n_devices: int, *,
                    link_bytes_per_s: Optional[float] = None,
                    kind: str = "all_reduce", chip="h100",
                    link: str = "ici") -> float:
    """Ring-model time of one collective over ``bytes_total`` (the FULL
    payload: the all-gather's result, the all-reduce's operand) on a group
    of ``n_devices``; an all-gather's ring input is the shard
    bytes_total/n (``ring_wire_cost``'s formulas, in floats)."""
    if n_devices <= 1:
        return 0.0
    spec = chip_spec(chip)
    bw = (link_bytes_per_s if link_bytes_per_s is not None
          else _rate(spec, "dcn_bytes_per_s" if link == "dcn"
                     else "ici_bytes_per_s"))
    k = _norm_kind(kind)
    nb = bytes_total / n_devices if k == "allgather" else bytes_total
    frac = {"allreduce": 2.0 * (n_devices - 1) / n_devices,
            "allgather": float(n_devices - 1),
            "reducescatter": (n_devices - 1) / n_devices,
            "alltoall": (n_devices - 1) / n_devices,
            "collectivepermute": 1.0}[k]
    return frac * nb / bw


# ---------------------------------------------------------------------------
# the model cost sheet
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelCostSheet:
    """Per-layer weight and FLOP accounting of a decoder LM, all the
    estimator reads of a model (no mesh, no tensors).  Derive one with
    ``llama_cost_sheet(cfg)``."""

    name: str
    num_layers: int
    hidden: int
    intermediate: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab: int
    num_experts: int = 0
    moe_top_k: int = 2
    #: price the DROPLESS engine: the routed segments' FLOPs and dispatch,
    #: no capacity padding
    moe_dropless: bool = False
    #: the dropless engine's balance point (>= 1): the max-loaded expert
    #: shard over the mean, so segments are priced at balance * top_k
    #: rows per token (1.0 = perfectly balanced routing)
    moe_balance: float = 1.0
    #: the capacity engine's padding factor cf: its static [E, C, d]
    #: buffer computes and ships cf * top_k rows per token (0.0: unpriced)
    moe_capacity_factor: float = 0.0

    # -- per-layer element counts ------------------------------------------

    @property
    def layer_attn_elems(self) -> int:
        """q/k/v/o projection weights (the attention leaves the sharding
        axis gathers)."""
        h, kv = self.hidden, self.num_kv_heads * self.head_dim
        return 2 * h * h + 2 * h * kv

    @property
    def layer_mlp_elems(self) -> int:
        """gate/up/down of the DENSE MLP (0 when the layer is MoE)."""
        if self.num_experts:
            return 0
        return 3 * self.hidden * self.intermediate

    @property
    def layer_expert_elems(self) -> int:
        """Expert-stacked weights, placed on ``ep`` (leading [E] dim),
        plus the replicated router gate."""
        if not self.num_experts:
            return 0
        return (self.num_experts * 3 * self.hidden * self.intermediate
                + self.hidden * self.num_experts)

    @property
    def moe_eff_rows_per_token(self) -> float:
        """Expert-FFN rows computed (and dispatched) per token: the
        dropless engine's ``balance * top_k``, the capacity engine's
        ``cf * top_k`` (cf == 0: top_k)."""
        if self.moe_dropless:
            return self.moe_balance * self.moe_top_k
        if self.moe_capacity_factor > 0:
            return self.moe_capacity_factor * self.moe_top_k
        return float(self.moe_top_k)

    @property
    def layer_gathered_elems(self) -> int:
        """The ZeRO-3 bucketed stack per layer: what the overlap engine's
        bucket gathers and reduce-scatters move."""
        return self.layer_attn_elems + self.layer_mlp_elems

    @property
    def layer_sync_elems(self) -> int:
        """Per-layer replicated leaves (the two RMSNorm weights), whose
        gradients the engine syncs over the data axes."""
        return 2 * self.hidden

    @property
    def misc_sync_elems(self) -> int:
        """Non-layer replicated leaves (the final norm)."""
        return self.hidden

    @property
    def embed_elems(self) -> int:
        return self.vocab * self.hidden

    @property
    def head_elems(self) -> int:
        return self.hidden * self.vocab

    @property
    def params_total(self) -> int:
        return (self.num_layers * (self.layer_gathered_elems
                                   + self.layer_expert_elems
                                   + self.layer_sync_elems)
                + self.misc_sync_elems + self.embed_elems
                + self.head_elems)

    # -- FLOPs --------------------------------------------------------------

    def fwd_flops(self, batch: int, seq: int) -> float:
        """Forward FLOPs of one step: 2 a weight element a token, the two
        attention products, the lm head; an MoE layer routes each token
        through its effective expert rows."""
        tokens = batch * seq
        per_tok = 2.0 * (self.layer_attn_elems + self.layer_mlp_elems)
        if self.num_experts:
            per_tok += 2.0 * self.moe_eff_rows_per_token * (
                3 * self.hidden * self.intermediate) \
                + 2.0 * self.hidden * self.num_experts
        attn = 4.0 * seq * self.hidden          # QK^T + AV per token
        lm = 2.0 * (self.hidden * self.vocab)   # lm_head
        return tokens * (self.num_layers * (per_tok + attn) + lm)

    def step_flops(self, batch: int, seq: int,
                   recompute_factor: float = 0.0) -> float:
        """fwd + 2x bwd + remat's recompute (``recompute_factor`` more
        forward passes)."""
        return self.fwd_flops(batch, seq) * (3.0 + recompute_factor)


def llama_cost_sheet(cfg) -> ModelCostSheet:
    """The cost sheet of a LlamaConfig (or any object with its fields)."""
    heads = int(cfg.num_attention_heads)
    hd = int(getattr(cfg, "head_dim", cfg.hidden_size // heads))
    return ModelCostSheet(
        name=type(cfg).__name__,
        num_layers=int(cfg.num_hidden_layers),
        hidden=int(cfg.hidden_size),
        intermediate=int(cfg.intermediate_size),
        num_heads=heads,
        num_kv_heads=int(cfg.num_key_value_heads),
        head_dim=hd,
        vocab=int(cfg.vocab_size),
        num_experts=int(getattr(cfg, "num_experts", 0) or 0),
        moe_top_k=int(getattr(cfg, "moe_top_k", 2) or 2),
        moe_dropless=bool(getattr(cfg, "moe_dropless", False)),
        moe_balance=float(getattr(cfg, "moe_balance", 1.0) or 1.0),
        moe_capacity_factor=float(
            getattr(cfg, "moe_capacity_factor", 0.0) or 0.0))


def _axis_degrees(axes) -> Dict[str, int]:
    """Axis name -> degree of a PartitionPoint's axes (tuple or dict)."""
    d = dict(axes if not hasattr(axes, "items") else axes.items())
    return {str(a): int(n) for a, n in d.items()}


def _slice_shape(axes: Dict[str, int],
                 slice_map: Optional[Sequence[int]]) -> Tuple[int, int]:
    """(slices S, per-slice degree K) of the slice-spanning sharding axis;
    (1, sh) on one slice."""
    sh = axes.get("sharding", 1)
    if not slice_map:
        return 1, sh
    s = len(set(slice_map))
    return s, max(1, sh // s)


# ---------------------------------------------------------------------------
# the analytic wire table
# ---------------------------------------------------------------------------


def _packed(codec, n_elems: int) -> int:
    """Wire bytes of an ``n_elems`` row after the codec (int8 blocks and
    their scales: ``CollectiveCodec.wire_bytes``; a bare object with a
    ``block`` through ``codec.packed_width``)."""
    if hasattr(codec, "wire_bytes"):
        return int(codec.wire_bytes(n_elems))
    from .codec import packed_width

    return packed_width(int(n_elems), codec.block,
                        getattr(codec, "checksum", False))


def predict_wire_table(axes, slice_map, sheet: ModelCostSheet, *,
                       codec=None, batch: int, seq: int,
                       compute_itemsize: int = 2) -> Dict[str, Any]:
    """Analytic ICI and DCN bytes on the wire of one training step, in the
    currency of the COMM004 pass's ``collect_wire_table`` (``ring_wire_cost``
    of each collective's payload, the codec's packed widths).

    The DCN terms follow the two-stage schedule per layer: the bucket
    all-gather forward, the bucket reduce-scatter backward, the norm
    gradients' sync, and the non-layer collectives.  Three terms differ
    from the reference's (whose four recorded pins they do not give), each
    as this package's capture counts it:

    - the uncoded bucket reduce-scatter moves this rank's ``mp`` share of
      the bucket (the reference's jaxpr payload is the whole bucket);
    - the norm gradients sync in the compute dtype (reference: fp32);
    - the non-layer collectives run over the sharding axis: the embedding's
      gather and its gradient's reduce-scatter, the lm head's two gathers
      and one reduce-scatter, the final norm's gradient completion (fp32)
      and the loss's psum (the reference's pins count one fp32 all-reduce
      of the final norm forward and backward over every device).

    ICI terms (dp gradient psums, mp activation psums, the per-slice stages
    of the two-stage collectives, pp permutes, ep dispatch) are first
    order: no budget gates them."""
    ax = _axis_degrees(axes)
    dp, sh, mp = (ax.get(k, 1) for k in ("dp", "sharding", "mp"))
    pp, sep, ep = (ax.get(k, 1) for k in ("pp", "sep", "ep"))
    S, K = _slice_shape(ax, slice_map)
    L = sheet.num_layers
    isz = compute_itemsize

    dcn: Dict[str, int] = {}
    ici: Dict[str, int] = {}

    def add(tab, key, cost):
        if cost > 0:
            tab[key] = tab.get(key, 0) + int(cost)

    # -- the ZeRO-3 bucketed stack: two-stage gather fwd / scatter bwd
    g_elems = sheet.layer_gathered_elems
    ways = max(1, sh * mp)
    local_elems = g_elems // ways
    local_bytes = local_elems * isz
    global_bytes = g_elems * isz
    scatter_bytes = global_bytes // max(1, mp)
    for _ in range(L):
        if S > 1:
            if codec is None:
                add(dcn, "bucket_allgather",
                    ring_wire_cost("allgather", local_bytes, S))
                add(dcn, "bucket_reducescatter",
                    ring_wire_cost("reducescatter", scatter_bytes // K, S))
            else:
                w = _packed(codec, local_elems)
                add(dcn, "bucket_allgather",
                    ring_wire_cost("allgather", w, S))
                # the coded scatter: one all-to-all of [S, packed(local)]
                add(dcn, "bucket_reducescatter",
                    ring_wire_cost("alltoall", S * w, S))
        if K > 1:
            add(ici, "bucket_allgather",
                ring_wire_cost("allgather", local_bytes * S, K))
            add(ici, "bucket_reducescatter",
                ring_wire_cost("reducescatter", global_bytes, K))

    # -- per-layer sync leaves (the norm weights): a gradient psum over the
    #    data axes; the coded path ships a packed int8 gather across slices
    sync_bytes = sheet.layer_sync_elems * isz
    for _ in range(L):
        if S > 1:
            if codec is None:
                add(dcn, "norm_sync",
                    ring_wire_cost("allreduce", sync_bytes, sh))
            else:
                add(dcn, "norm_sync",
                    ring_wire_cost("allgather",
                                   _packed(codec, sheet.layer_sync_elems),
                                   S))
                if K > 1:
                    add(ici, "norm_sync",
                        ring_wire_cost("allreduce", sync_bytes, K))
        elif sh > 1:
            add(ici, "norm_sync",
                ring_wire_cost("allreduce", sync_bytes, sh))
        if dp > 1:
            add(ici, "norm_sync_dp",
                ring_wire_cost("allreduce", sync_bytes, dp))

    # -- the non-layer collectives (uncoded even under the codec)
    misc = sheet.misc_sync_elems * 4
    stage = dcn if S > 1 else ici
    for key, elems, gathers in (("embed", sheet.embed_elems, 1),
                                ("head", sheet.head_elems, 2)):
        block = elems * isz // max(1, mp)
        add(stage, key + "_allgather",
            gathers * ring_wire_cost("allgather", block // sh, sh))
        add(stage, key + "_reducescatter",
            ring_wire_cost("reducescatter", block, sh))
    add(stage, "misc_sync", ring_wire_cost("allreduce", misc, sh))
    add(stage, "loss_psum", ring_wire_cost("allreduce", 4, sh))

    # -- data-parallel gradient psums (ICI), first order: the full bf16
    #    gradient set, mp-sharded
    if dp > 1:
        grads = sheet.params_total * isz // max(1, mp)
        add(ici, "dp_grad_psum", ring_wire_cost("allreduce", grads, dp))

    # -- tensor-parallel activation psums (ICI): o/down projections fwd
    #    + bwd per layer, plus the logits reduction
    if mp > 1:
        act = (batch // max(1, dp)) * (seq // max(1, sep)) \
            * sheet.hidden * isz
        add(ici, "mp_act_psum",
            (4 * L + 1) * ring_wire_cost("allreduce", act, mp))

    # -- pipeline microbatch boundary sends (ICI permutes, fwd + bwd)
    if pp > 1:
        act = (batch // max(1, dp)) * (seq // max(1, sep)) \
            * sheet.hidden * isz // max(1, mp)
        add(ici, "pp_permute",
            2 * (pp - 1) * ring_wire_cost("collectivepermute", act, pp))

    # -- sep (Ulysses) head/seq exchanges (ICI all-to-alls, fwd + bwd)
    if sep > 1:
        act = (batch // max(1, dp)) * seq * sheet.hidden * isz \
            // max(1, mp)
        add(ici, "sep_alltoall",
            4 * L * ring_wire_cost("alltoall", act, sep))

    # -- ep dispatch/return all-to-alls (ICI; the engine's rows per token)
    if ep > 1 and sheet.num_experts:
        tokens = (batch // max(1, dp)) * (seq // max(1, sep))
        payload = int(tokens * sheet.moe_eff_rows_per_token
                      * sheet.hidden)
        nbytes = (_packed(codec, payload) if codec is not None
                  else payload * isz)
        add(ici, "ep_dispatch",
            4 * L * ring_wire_cost("alltoall", nbytes, ep))

    return {"dcn": {"bytes": sum(dcn.values()), "by_part": dcn},
            "ici": {"bytes": sum(ici.values()), "by_part": ici}}


# ---------------------------------------------------------------------------
# the structural peak
# ---------------------------------------------------------------------------

#: device bytes per parameter element when everything is resident:
#: fp32 master + AdamW m + v (12) + bf16 grads (2) + bf16 cast (2)
_STATE_BYTES_PER_PARAM = 16
_OPT_BYTES_PER_PARAM = 12

#: the port's stochastic int8 encode (``codec.encode_rows``) at its peak,
#: per element it encodes: the fp32 rows and their scaled copy (4 + 4),
#: the int64 payload bits and hash state (8 + 8) and ``_mul32``'s three
#: int64 temporaries (24)
_SR_ENCODE_BYTES_PER_ELEM = 48


def _encodes_stochastic(codec) -> bool:
    resolve = getattr(codec, "resolve", None)
    got = resolve("grad") if resolve is not None else None
    return bool(got and got[1])


def predict_peak_bytes(axes, sheet: ModelCostSheet, memory=None, *,
                       batch: int, seq: int, codec=None,
                       compute_itemsize: int = 2,
                       calibration_offset: int = 0,
                       slice_map: Optional[Sequence[int]] = None) -> int:
    """Structural per-device peak of one train step: params at rest,
    optimizer state, gradients and the bf16 cast over the weight ways,
    activations over the data ways with remat's keep factor, the logits,
    one gathered bucket and, under the codec, its packed scratch.  First
    order by design: the absolute level comes from one measured point
    (``calibration_offset`` = measured - model there); the deltas order the
    rest, and the measured gate decides.

    A stochastic gradient codec across slices (``slice_map``) adds its
    encode's working set, which the reference's fused encode does not
    hold: the reduce-scatter encodes this rank's [S, local] rows of a
    bucket at once."""
    ax = _axis_degrees(axes)
    dp, sh, mp = (ax.get(k, 1) for k in ("dp", "sharding", "mp"))
    pp, sep, ep = (ax.get(k, 1) for k in ("pp", "sep", "ep"))
    remat = getattr(memory, "remat", "none") if memory else "none"
    isz = compute_itemsize
    L = sheet.num_layers
    layers_here = max(1, L // max(1, pp))

    ways = max(1, sh * mp)
    sharded = (layers_here * sheet.layer_gathered_elems
               + sheet.embed_elems + sheet.head_elems) // ways
    sharded += layers_here * sheet.layer_expert_elems \
        // max(1, ep * mp)
    replicated = layers_here * sheet.layer_sync_elems \
        + sheet.misc_sync_elems

    state = _STATE_BYTES_PER_PARAM
    if memory is not None \
            and getattr(memory, "optimizer_residency", "device") == "host":
        state -= _OPT_BYTES_PER_PARAM
    params_bytes = (sharded + replicated) * state

    tokens = (batch // max(1, dp)) * (seq // max(1, sep))
    act_tok_layer = (4 * sheet.hidden + 2 * sheet.intermediate
                     + sheet.num_heads * (seq // max(1, sep))) \
        * isz // max(1, mp)
    if memory is not None and hasattr(memory, "act_keep_factor"):
        keep = memory.act_keep_factor()
    else:
        keep = _ACT_KEEP_FACTOR.get(remat, 1.0)
        if memory is not None and getattr(memory, "activation_offload",
                                          False):
            keep *= 0.5
    acts = int(tokens * layers_here * act_tok_layer * keep)
    logits = tokens * sheet.vocab * 4 // max(1, mp)

    # gathered working set: one layer's full bucket (+ codec scratch)
    gathered = sheet.layer_gathered_elems * isz // max(1, mp)
    if codec is not None:
        gathered += _packed(codec, sheet.layer_gathered_elems // ways)
        S, K = _slice_shape(ax, slice_map)
        if S > 1 and _encodes_stochastic(codec):
            gathered += _SR_ENCODE_BYTES_PER_ELEM * (
                sheet.layer_gathered_elems // max(1, mp * K))

    return int(params_bytes + acts + logits + gathered
               + calibration_offset)


# ---------------------------------------------------------------------------
# the step-time estimate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepTimeEstimate:
    """One point's analytic step time: the larger of the compute and HBM
    rooflines plus the exposed collective time, with the wire and peak
    predictions the budget pre-filter reads.  ``fits`` is the PREDICTED
    budget verdict (None when no budget was declared); the measured gates
    stay the verdict."""

    label: str
    total_s: float
    compute_s: float
    hbm_s: float
    ici_s: float
    dcn_s: float
    exposed_comm_s: float
    peak_bytes: int
    dcn_wire_bytes: int
    ici_wire_bytes: int
    fits: Optional[bool] = None
    breakdown: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"label": self.label, "total_s": self.total_s,
                "compute_s": self.compute_s, "hbm_s": self.hbm_s,
                "ici_s": self.ici_s, "dcn_s": self.dcn_s,
                "exposed_comm_s": self.exposed_comm_s,
                "peak_bytes": self.peak_bytes,
                "dcn_wire_bytes": self.dcn_wire_bytes,
                "ici_wire_bytes": self.ici_wire_bytes,
                "fits": self.fits}


def _link_s(nbytes: int, spec: ChipSpec, field: str) -> float:
    """``nbytes`` over ``spec``'s link rate; no bytes take no time, on an
    unmeasured link too."""
    return nbytes / _rate(spec, field) if nbytes else 0.0


def estimate_step_time(axes, slice_map, sheet: ModelCostSheet, *,
                       memory=None, codec=None, overlap=None,
                       batch: int, seq: int, chip="h100",
                       hbm_budget: Optional[int] = None,
                       dcn_budget: Optional[int] = None,
                       calibration_offset: int = 0,
                       label: str = "") -> StepTimeEstimate:
    """The analytic estimate of one (partitioning, memory, overlap, codec)
    point: compute FLOPs against HBM bytes (max of the rooflines, remat's
    recompute folded in) plus per-tactic ICI and DCN time from the ring
    cost model and the codec's widths, the overlap hiding collectives
    behind compute (exposed = max(0, comm - hideable compute))."""
    spec = chip_spec(chip)
    ax = _axis_degrees(axes)
    ndev = max(1, math.prod(ax.values()))
    remat = getattr(memory, "remat", "none") if memory else "none"
    recompute = (memory.recompute_fwd_passes()
                 if memory is not None
                 and hasattr(memory, "recompute_fwd_passes")
                 else REMAT_RECOMPUTE_FACTOR.get(remat, 0.0))

    flops_dev = sheet.step_flops(batch, seq, recompute) / ndev
    compute_s = flops_dev / spec.peak_bf16_flops

    # HBM traffic: weights touched once a pass (fwd, bwd, update and the
    # recompute), activations written forward and read backward
    ax_peak = predict_peak_bytes(
        axes, sheet, memory, batch=batch, seq=seq, codec=codec,
        calibration_offset=calibration_offset, slice_map=slice_map)
    param_local = sheet.params_total * 2 // max(
        1, ax.get("sharding", 1) * ax.get("mp", 1))
    hbm_bytes = param_local * (3.0 + recompute) \
        + sheet.params_total * _STATE_BYTES_PER_PARAM / max(
            1, ax.get("sharding", 1) * ax.get("mp", 1)) \
        + 2.0 * ax_peak
    hbm_s = hbm_bytes / spec.hbm_bytes_per_s

    wire = predict_wire_table(axes, slice_map, sheet, codec=codec,
                              batch=batch, seq=seq)
    ici_b = wire["ici"]["bytes"]
    dcn_b = wire["dcn"]["bytes"]
    ici_s = _link_s(ici_b, spec, "ici_bytes_per_s")
    dcn_s = _link_s(dcn_b, spec, "dcn_bytes_per_s")

    # overlap: prefetched, bucketed schedules hide collectives behind
    # compute; exposed = what compute cannot cover
    if overlap is None:
        hides = True
    elif hasattr(overlap, "hides_collectives"):
        hides = overlap.hides_collectives()
    else:
        hides = bool(getattr(overlap, "prefetch", True))
    hideable = compute_s if hides else 0.0
    exposed = max(0.0, ici_s + dcn_s - hideable)
    total = max(compute_s, hbm_s) + exposed

    fits: Optional[bool] = None
    if hbm_budget is not None or dcn_budget is not None:
        fits = True
        if hbm_budget is not None and ax_peak > hbm_budget:
            fits = False
        if dcn_budget is not None and dcn_b > dcn_budget:
            fits = False

    return StepTimeEstimate(
        label=label, total_s=total, compute_s=compute_s, hbm_s=hbm_s,
        ici_s=ici_s, dcn_s=dcn_s, exposed_comm_s=exposed,
        peak_bytes=int(ax_peak), dcn_wire_bytes=int(dcn_b),
        ici_wire_bytes=int(ici_b), fits=fits,
        breakdown={"wire": wire, "ndev": ndev,
                   "recompute_factor": recompute})


def estimate_joint_config(jc, sheet: ModelCostSheet, *, batch: int,
                          seq: int, chip="h100",
                          hbm_budget: Optional[int] = None,
                          dcn_budget: Optional[int] = None,
                          calibration_offset: int = 0
                          ) -> StepTimeEstimate:
    """The estimate of one ``JointScheduleConfig`` (partition x memory x
    overlap and codec)."""
    codec = getattr(jc.overlap, "codec", None)
    return estimate_step_time(
        jc.partition.axes, jc.partition.slice_map, sheet,
        memory=jc.memory, codec=codec, overlap=jc.overlap,
        batch=batch, seq=seq, chip=chip, hbm_budget=hbm_budget,
        dcn_budget=dcn_budget, calibration_offset=calibration_offset,
        label=jc.label())


def joint_estimator(sheet: ModelCostSheet, *, batch: int, seq: int,
                    chip="h100", hbm_budget: Optional[int] = None,
                    dcn_budget: Optional[int] = None,
                    calibration_offset: int = 0
                    ) -> Callable[[Any], StepTimeEstimate]:
    """The estimator of ``tune_schedule_config(predict=True)``: a callable
    JointScheduleConfig -> StepTimeEstimate over the sheet, the step's
    shape, the chip and (optionally) the budgets of the predicted
    pre-filter."""
    def estimate(jc) -> StepTimeEstimate:
        return estimate_joint_config(
            jc, sheet, batch=batch, seq=seq, chip=chip,
            hbm_budget=hbm_budget, dcn_budget=dcn_budget,
            calibration_offset=calibration_offset)

    return estimate


def calibration_offset_from(record: Dict[str, Any], jc,
                            sheet: ModelCostSheet, *, batch: int,
                            seq: int) -> int:
    """One-point peak calibration: measured - structural on one measured
    record (the anchor the walk already paid for); apply the offset to
    every later prediction."""
    codec = getattr(jc.overlap, "codec", None)
    structural = predict_peak_bytes(
        jc.partition.axes, sheet, jc.memory, batch=batch, seq=seq,
        codec=codec, slice_map=jc.partition.slice_map)
    return int(record["peak_bytes"]) - structural


# ---------------------------------------------------------------------------
# the enumerated partitioning search
# ---------------------------------------------------------------------------


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _mesh_shape(mesh_shape) -> Tuple[int, int]:
    """(slices, devices per slice) from an int (one slice), a (slices,
    per_slice) tuple or a dict with those keys."""
    if isinstance(mesh_shape, int):
        return 1, int(mesh_shape)
    if hasattr(mesh_shape, "get"):
        return (int(mesh_shape.get("num_slices", 1)),
                int(mesh_shape.get("devices_per_slice")))
    s, per = mesh_shape
    return int(s), int(per)


def enumerate_partitionings(mesh_shape, model, *, batch: int = 8,
                            seq: int = 4096, chip="h100", memory=None,
                            hbm_fraction: float = 0.9,
                            max_points: Optional[int] = None) -> Tuple:
    """Candidate tactic compositions over a pod-shaped mesh, from the
    named-tactic vocabulary (pp / dp / sharding3 / sep / tp / ep), pruned
    by divisibility and by the structural peak.

    ``mesh_shape``: the device count, or ``(num_slices,
    devices_per_slice)`` (the slice-spanning axis is ``sharding``: points
    whose sharding degree cannot host the slices are dropped).  ``model``:
    a LlamaConfig or a ModelCostSheet.  Every degree divides its model
    dimension (pp | layers, mp | hidden/intermediate/kv width/heads, sep |
    seq and heads, ep | experts, sharding | hidden, dp | batch) and the
    peak fits ``hbm_fraction`` of the chip's capacity.  Returns
    PartitionPoints, in no meaningful order (``rank_partitionings``
    orders them)."""
    from .schedule import PartitionPoint

    sheet = model if isinstance(model, ModelCostSheet) \
        else llama_cost_sheet(getattr(model, "config", model))
    S, per_slice = _mesh_shape(mesh_shape)
    total = S * per_slice
    spec = chip_spec(chip)
    budget = int(spec.hbm_bytes * hbm_fraction)

    def ok_mp(mp):
        kvw = sheet.num_kv_heads * sheet.head_dim
        return (sheet.hidden % mp == 0 and sheet.intermediate % mp == 0
                and kvw % mp == 0 and sheet.num_heads % mp == 0)

    points = []
    for pp in _divisors(math.gcd(total, sheet.num_layers)):
        for mp in (m for m in _divisors(total // pp) if ok_mp(m)):
            for sep in (s for s in _divisors(total // (pp * mp))
                        if seq % s == 0 and sheet.num_heads % s == 0
                        and s <= seq):
                ep_opts = [e for e in _divisors(total // (pp * mp * sep))
                           if sheet.num_experts and
                           sheet.num_experts % e == 0] or [1]
                for ep in ep_opts:
                    rest = total // (pp * mp * sep * ep)
                    for sh in (d for d in _divisors(rest)
                               if sheet.hidden % d == 0):
                        dp = rest // sh
                        if batch % dp != 0:
                            continue
                        # multi-slice pods span slices on sharding
                        if S > 1 and sh % S != 0:
                            continue
                        slice_map = None
                        if S > 1:
                            k = sh // S
                            slice_map = tuple(i // k for i in range(sh))
                        axes = tuple(
                            (a, n) for a, n in
                            (("pp", pp), ("dp", dp), ("sharding", sh),
                             ("sep", sep), ("ep", ep), ("mp", mp)))
                        peak = predict_peak_bytes(
                            axes, sheet, memory, batch=batch, seq=seq)
                        if peak > budget:
                            continue
                        points.append(PartitionPoint(
                            "auto", axes, slice_map=slice_map))
    if max_points is not None:
        points = points[:max_points]
    return tuple(points)


def rank_partitionings(points: Sequence, sheet: ModelCostSheet, *,
                       batch: int = 8, seq: int = 4096, chip="h100",
                       memory=None, codec=None
                       ) -> List[Tuple[StepTimeEstimate, Any]]:
    """Order PartitionPoints by the estimate, cheapest first: [(estimate,
    point), ...], the top K of which the predicted walk builds."""
    sheet = sheet if isinstance(sheet, ModelCostSheet) \
        else llama_cost_sheet(getattr(sheet, "config", sheet))
    ranked = []
    for pt in points:
        est = estimate_step_time(
            pt.axes, pt.slice_map, sheet, memory=memory, codec=codec,
            batch=batch, seq=seq, chip=chip, label=pt.label())
        ranked.append((est, pt))
    ranked.sort(key=lambda t: t[0].total_s)
    return ranked
