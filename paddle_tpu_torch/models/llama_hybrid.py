"""The composed hybrid-parallel Llama train step: pp x dp x sharding x sep x
mp on ``torch.distributed``.

Port of ``paddle_tpu/models/llama_hybrid.py``.  The mesh carries the five
axes of ``HYBRID_AXES`` (pp outermost, mp innermost over the ranks); every
axis's process group is made when the mesh is built, on every rank.

- The state is layer-major: ``stack_llama_state`` collapses
  ``model.layers.{i}.X`` into ``model.layers.X`` with a leading [L], cut
  over ``pp`` at rest (``hybrid_param_spec``, the schedule layer's
  ``hybrid_leaf_spec``), its inner dims placed by the Llama plan (ZeRO-3
  over ``sharding``, Megatron over ``mp``).
- The decoder layer is the overlap engine's ``decoder_layer_tp`` (the one
  layer body of every Llama step, ``models/llama.py``'s
  ``decoder_layer_forward``) on sharding-gathered, mp-local weights, with
  ``attn_fn`` set to ring or Ulysses attention over ``sep`` when sep > 1
  (after ``_sep_gqa``'s kv-head repeat), else the causal flash call.
- ``schedule="gpipe"``: ``pipeline_apply`` over the overlap engine's
  ``gathered_layer_scan`` (per-layer ZeRO-3 bucket gathers with the
  layer-ahead prefetch, bucket reduce-scatters left in flight), autograd
  through the ticks.  Every tick runs each layer of the stage again, so
  the step keys the bucket reductions by tick and sums them after the
  backward.
- ``schedule="1F1B"`` (``"FThenB"``, ``"ZBH1"``, ``"VPP"``, ``"ZBV"``): the
  schedule executor (``parallel/pipelining.pipeline_train_step``) on the
  static tables of ``parallel/schedules.py``.  Its per-rank branches
  cannot host collectives over ``sharding``, so the chunk weights are
  gathered over ``sharding`` once before the schedule and the gradients,
  the same on every sharding rank (the batch does not ride ``sharding``
  here), are cut back to each rank's block after it; dp splits the batch
  and the gradients are summed over dp and sep after the schedule.  With
  v > 1 chunks per rank the layer blocks a rank runs are not its at-rest
  block: they are gathered over ``pp`` and the gradients gathered back.
- The embedding, final norm, LM head and the fp32 cross entropy run
  outside the pipeline on every rank, on the whole (gathered) weights; the
  loss is the mean over the global token count.  Their gradients, like
  every weight's, are summed over the ranks holding different tokens (the
  data axes that split the batch, and ``sep``), and each rank keeps its
  at-rest block.

Gradient convention (the port's, as in ``parallel/overlap.py``): a value
replicated over ranks carries the whole cotangent on every rank; the JAX
region instead psums some cotangents a second time (its x-grad over mp),
which AdamW's scale invariance hides.  ``step.gradients(params, ids,
labels) -> (loss, grads)`` gives the completed gradient blocks.

``cpu_bf16``: on a CPU mesh ``"promote"`` (the default) runs bf16 compute
in fp32, as the JAX step does on XLA:CPU; ``"fp32-wire"`` keeps the
compute in bf16, and every collective then moves fp32, as gloo's
collectives do for bf16 in ``compat.py`` (JAX's mode of that name works
around an XLA:CPU abort and refuses mp and sharding; the port has no such
abort and takes any mesh).  On a CUDA mesh the argument is ignored.
``health=`` is the fused health probe of ROADMAP A6 and raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..incubate.nn.fused import fused_rms_norm
from ..parallel import compat as _compat
from ..parallel.compat import all_gather_raw, all_reduce_raw
from .llama import LlamaConfig, _gold_logit, _local, _rope_tables, \
    plan_spec_for

HYBRID_AXES = ("pp", "dp", "sharding", "sep", "mp")

_LAYER_PREFIX = "model.layers."


def hybrid_mesh(devices: str = "cuda", pp: int = 1, dp: int = 1,
                sharding: int = 1, sep: int = 1, mp: int = 1, *,
                store=None, rank: Optional[int] = None,
                world_size: Optional[int] = None,
                timeout_s: float = 300.0):
    """The 5-axis hybrid mesh (reference topology.py:189 order pp -> dp ->
    sharding -> sep -> mp, outermost first, so rank r sits at the row-major
    coordinate r).  ``devices`` is the device type of the ranks, ``"cuda"``
    or ``"cpu"``; the ranks are the world's processes (``init_mesh``'s
    ``store``/``rank``/``world_size``, or torchrun's environment).  A mesh
    of one rank with no process group running and no ``store`` is the
    one-rank mesh, which needs none."""
    import torch.distributed as dist

    from ..parallel.specs import Mesh, init_mesh

    shape = (pp, dp, sharding, sep, mp)
    if math.prod(shape) == 1 and store is None and not dist.is_initialized():
        return Mesh(shape, HYBRID_AXES, device_type=devices)
    return init_mesh(devices, shape, HYBRID_AXES, store=store, rank=rank,
                     world_size=world_size, timeout_s=timeout_s)


# --------------------------------------------------------------------------
# the state: layer-major stacking
# --------------------------------------------------------------------------


def _is_stacked(name: str) -> bool:
    rest = name[len(_LAYER_PREFIX):] if name.startswith(_LAYER_PREFIX) \
        else None
    return rest is not None and not rest.split(".", 1)[0].isdigit()


def stack_llama_state(state: Dict[str, Any], num_layers: int
                      ) -> Dict[str, Any]:
    """Collapse ``model.layers.{i}.X`` into layer-major stacks
    ``model.layers.X`` with a leading [L]: cutting dim 0 over ``pp`` gives
    stage s the contiguous layers [s*L/P, (s+1)*L/P)."""
    out: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for k, v in state.items():
        if k.startswith(_LAYER_PREFIX) and not _is_stacked(k):
            idx, suffix = k[len(_LAYER_PREFIX):].split(".", 1)
            per_layer.setdefault(suffix, [None] * num_layers)[int(idx)] = v
        else:
            out[k] = v
    for suffix, vals in per_layer.items():
        if any(v is None for v in vals):
            raise ValueError(f"missing layers for {suffix}")
        out[_LAYER_PREFIX + suffix] = torch.stack(
            [torch.as_tensor(v) for v in vals], dim=0)
    return out


def unstack_llama_state(hstate: Dict[str, Any], num_layers: int
                        ) -> Dict[str, Any]:
    """Inverse of ``stack_llama_state``."""
    out: Dict[str, Any] = {}
    for k, v in hstate.items():
        if _is_stacked(k):
            suffix = k[len(_LAYER_PREFIX):]
            for i in range(num_layers):
                out[f"{_LAYER_PREFIX}{i}.{suffix}"] = v[i]
        else:
            out[k] = v
    return out


def hybrid_param_spec(name: str, shape: Tuple[int, ...], mesh,
                      plan=None):
    """The at-rest spec of one hybrid-state leaf: the schedule layer's
    ``hybrid_leaf_spec`` bound to the Llama plan."""
    from ..parallel.schedule import hybrid_leaf_spec

    return hybrid_leaf_spec(name, shape, mesh,
                            lambda n: plan_spec_for(n, plan))


def shard_hybrid_state(hstate: Dict[str, Any], mesh, plan=None
                       ) -> Dict[str, Any]:
    """This rank's ``ShardedTensor`` block of every stacked leaf, placed by
    ``hybrid_param_spec``."""
    from ..parallel.specs import NamedSharding

    return {name: NamedSharding(mesh, hybrid_param_spec(
                name, tuple(v.shape), mesh, plan)).shard(torch.as_tensor(v))
            for name, v in hstate.items()}


def init_hybrid_state(model, mesh) -> Dict[str, Any]:
    """model (an unsharded ``LlamaForCausalLM``) -> the stacked hybrid
    state, this rank's blocks."""
    if model.schedule is not None:
        raise ValueError("init_hybrid_state takes an unsharded model")
    return shard_hybrid_state(
        stack_llama_state(model.functional_state(),
                          model.cfg.num_hidden_layers), mesh)


# --------------------------------------------------------------------------
# the composed train step
# --------------------------------------------------------------------------


class _TickSink:
    """One pipeline tick's view of the step's ``StackGrads``: the bucket
    reductions of ``gathered_layer_scan`` arrive keyed (bucket, layer), and
    every tick runs each layer again, so they are kept (tick, bucket,
    layer) and summed over the ticks after the backward."""

    def __init__(self, sink, tick: int):
        self.sink, self.tick = sink, tick

    def add(self, key, pending) -> None:
        self.sink.add((self.tick,) + tuple(key), pending)


def _sep_gqa(q, k, v, sep: int):
    """With mp-local heads the local kv-head count can drop below the sep
    degree; repeating kv heads up to the q grouping is exact GQA (each q
    head keeps its kv group) and restores Ulysses' divisibility."""
    if k.shape[2] % sep:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return q, k, v


def build_hybrid_train_step(cfg: LlamaConfig, optimizer, mesh,
                            num_microbatches: int = 1,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            remat=False, sep_attn: str = "ulysses",
                            schedule: str = "gpipe",
                            virtual_chunks: int = 1,
                            data_axes: Tuple[str, ...] = ("dp", "sharding"),
                            cpu_bf16: str = "promote", overlap=None,
                            health=None):
    """The composed hybrid train step (mirror of
    ``build_hybrid_train_step``; the module docstring has the design):

        step(params, opt_state, step_no, lr, input_ids, labels)
            -> (loss, new_params, new_opt_state)

    ``params``: this rank's ``init_hybrid_state`` blocks (``ShardedTensor``
    leaves); ``opt_state``: ``optimizer.init_state(params)``; input_ids /
    labels: the global [B, S] batch on every rank, B divisible by
    ``num_microbatches`` (and the micro-batch by the data-axis degrees it
    splits over), S by the sep degree.  ``remat``: a bool, a named policy
    (``none | dots | names | offload | full``) or a
    ``parallel.memory.MemoryConfig``.  ``overlap``: the overlap engine's
    ``OverlapConfig`` (None: the defaults).  ``step.gradients(params,
    input_ids, labels) -> (loss, grads)`` is the gradient half alone."""
    from ..parallel import overlap as _ov
    from ..parallel.memory import MemoryConfig, checkpoint_layer, \
        tag_saveable
    from ..parallel.specs import Mesh, ShardedTensor, pick_batch_axes

    if health is not None:
        raise NotImplementedError(
            "build_hybrid_train_step: health= is the fused health probe "
            "(ROADMAP A6), not ported yet")
    if not isinstance(mesh, Mesh):
        raise TypeError("build_hybrid_train_step: mesh= takes a "
                        "parallel.specs.Mesh (hybrid_mesh)")
    for ax in HYBRID_AXES:
        if ax not in mesh.axis_names:
            raise ValueError(f"hybrid mesh must carry axis {ax!r}")
    remat_policy = None
    if isinstance(remat, MemoryConfig):
        remat, remat_policy = remat.resolve_remat()
    elif isinstance(remat, str):
        remat, remat_policy = MemoryConfig(remat=remat).resolve_remat()
    remat = bool(remat)
    if cpu_bf16 not in ("promote", "fp32-wire"):
        raise ValueError(f"unknown cpu_bf16 mode {cpu_bf16!r}")
    if (compute_dtype == torch.bfloat16 and mesh.device_type == "cpu"
            and cpu_bf16 == "promote"):
        compute_dtype = torch.float32
    if sep_attn not in ("ulysses", "ring"):
        raise ValueError(f"sep_attn={sep_attn!r}: 'ulysses' or 'ring'")
    size = {a: int(mesh.shape[a]) for a in HYBRID_AXES}
    pp, sep, dpd = size["pp"], size["sep"], size["dp"]
    sh_deg, mp_deg = size["sharding"], size["mp"]
    L, m = cfg.num_hidden_layers, int(num_microbatches)
    if L % pp:
        raise ValueError(f"{L} layers not divisible by pp={pp}")
    batch_axes = tuple(a for a in data_axes
                       if a in mesh.axis_names and size.get(a, 1) > 1)
    if "mp" in batch_axes or "pp" in batch_axes or "sep" in batch_axes:
        raise ValueError(f"data_axes {data_axes}: batch axes are dp and "
                         f"sharding")
    seq_axes = ("sep",) if sep > 1 else ()
    oc = overlap if overlap is not None else _ov.OverlapConfig()
    sh_ax = "sharding" if sh_deg > 1 else None
    mp_ax = "mp" if mp_deg > 1 else None
    hier = oc.resolve_hier(mesh, sh_ax)
    _ov.register_hier(mesh, sh_ax, hier)
    codec = oc.codec if hier is not None else None
    shapes = _ov.llama_layer_shapes(cfg)
    layout = _ov.plan_layer_layout(shapes, mesh, plan_spec_for)
    suffixes = sorted(shapes)
    local = {s: layout[s].local_shape(sh_deg, mp_deg) for s in suffixes}
    tagged = remat and remat_policy is not None and remat_policy.tagged

    def tag(t, name):
        return tag_saveable(t, name) if tagged else t

    attn_fn = None
    if sep > 1:
        from ..parallel.ring_attention import ring_flash_attention
        from ..parallel.sep import ulysses_attention

        sep_fn = ring_flash_attention if sep_attn == "ring" \
            else ulysses_attention

        def attn_fn(q, k, v):
            return sep_fn(*_sep_gqa(q, k, v, sep), axis="sep", causal=True,
                          mesh=mesh)

    def layer_fn(lp, x, cos, sin):
        return _ov.decoder_layer_tp(lp, x, cos, sin, cfg, mp_ax, oc,
                                    mesh=mesh, tag=tag, attn_fn=attn_fn)

    sched = None
    if schedule.lower() == "gpipe":
        if int(virtual_chunks) > 1:
            raise ValueError(
                "virtual_chunks > 1 needs a schedule-explicit runtime "
                "(schedule='VPP'); the gpipe dataflow has no interleaved "
                "placement")
    else:
        if cfg.tie_word_embeddings:
            raise NotImplementedError(
                "schedule-explicit hybrid needs an untied lm_head (the "
                "embedding lives outside the pipeline)")
        from ..parallel.pipelining import device_major_order
        from ..parallel.schedules import build_schedule

        vch = max(int(virtual_chunks), 1)
        if schedule.upper() == "ZBV" and vch == 1:
            vch = 2              # ZBV's two-chunk zigzag is intrinsic
        if L % (pp * vch):
            raise ValueError(f"{L} layers not divisible by "
                             f"pp*virtual_chunks = {pp}*{vch}")
        sched = build_schedule(schedule, p=pp, m=m, v=vch)
        order, inverse = device_major_order(sched)

    cos_full, sin_full = _rope_tables(cfg.head_dim,
                                      cfg.max_position_embeddings,
                                      cfg.rope_theta)
    def decay(name):
        return not ("layernorm" in name or name.endswith("norm.weight")
                    or name.endswith(".bias"))

    def check_blocks(params):
        for sfx in suffixes:
            got = tuple(params[_LAYER_PREFIX + sfx].local.shape)
            want = (L // pp,) + local[sfx]
            if got != want:
                raise ValueError(f"{_LAYER_PREFIX}{sfx}: block {got} is not "
                                 f"the hybrid layout's {want}")

    def rope(dev, S):
        sl = S // sep
        s0 = mesh.axis_index("sep") * sl
        return tuple(t[s0:s0 + sl].to(dev, compute_dtype)[None, :, None]
                     for t in (cos_full, sin_full))

    def block(x, axes, dim):
        """This rank's block of dim ``dim`` over ``axes`` (row-major)."""
        n = math.prod(size.get(a, 1) for a in axes) if axes else 1
        b = x.shape[dim] // n
        return x.narrow(dim, mesh.block_index(axes) * b, b)

    def psum(x, axes):
        for a in axes:
            x = all_reduce_raw(x, a, mesh)
        return x

    def outer_leaves(params):
        """The non-layer leaves, gathered whole on every rank, as leaves
        that take a gradient."""
        return {k: v.full().detach().requires_grad_(True)
                for k, v in params.items() if not _is_stacked(k)}

    def own_blocks(params, full_grads, axes):
        """Whole gradients summed over ``axes``, cut to this rank's
        blocks."""
        return {k: params[k].shard_like(psum(g, axes))
                for k, g in full_grads.items()}

    def head_logits(outer, h):
        c = {k: v.to(compute_dtype) for k, v in outer.items()}
        h = fused_rms_norm(h, c["model.norm.weight"], cfg.rms_norm_eps)
        if cfg.tie_word_embeddings:
            return h @ c["model.embed_tokens.weight"].t()
        return h @ c["lm_head.weight"]

    def gpipe_gradients(params, ids, labels):
        from ..parallel.pipelining import pipeline_apply

        B, S = ids.shape
        mb = B // m
        used = pick_batch_axes(mesh, batch_axes, mb)
        ids = block(block(ids.reshape(m, mb, S), used, 1), seq_axes, 2)
        labels = block(block(labels.reshape(m, mb, S), used, 1), seq_axes, 2)
        dev = ids.device
        # bucket backward: reduce-scatter over 'sharding' where the batch
        # rides it (else each rank keeps its slice of the same cotangent),
        # then psum over the other batch axes and sep
        gather_psum = tuple(a for a in used if a != "sharding") + seq_axes
        grad_mode = "scatter" if "sharding" in used else "slice"
        itemsize = torch.empty((), dtype=compute_dtype).element_size()
        buckets = _ov.plan_buckets(layout, suffixes, sh_deg, mp_deg,
                                   oc.bucket_bytes, itemsize)
        in_bucket = {s for b in buckets for s in b}
        sync_sfx = [s for s in suffixes if s not in in_bucket]
        gather_fns = [_ov.make_bucket_gather(sh_ax, hier, gather_psum,
                                             grad_mode, codec, mesh=mesh)
                      for _ in buckets]
        sync_fn = _ov.make_grad_sync(used + seq_axes, hier_axis=sh_ax,
                                     hier=hier, codec=codec, mesh=mesh)
        # x feeds stage 0 only: its cotangent is psummed over pp so that
        # every pp rank's embedding gradient is the whole one
        x_sync = _ov.make_grad_sync(("pp",), mesh=mesh)

        stacked = {s: params[_LAYER_PREFIX + s].local.detach()
                   .requires_grad_(True) for s in suffixes}
        outer = outer_leaves(params)
        Lloc = L // pp
        # one UnbindBackward a leaf, which stacks the layers' gradients
        # once (a per-layer select would materialize the whole stack's
        # zeros for every layer)
        per_layer = {s: list(stacked[s].unbind(0)) for s in suffixes}
        xs_buckets = [_ov._pack_bucket(per_layer, b, local, compute_dtype)
                      for b in buckets]
        anchors = [[tuple(per_layer[s][i] for s in b) for i in range(Lloc)]
                   for b in buckets]
        xs_sync = [[per_layer[s][i].to(compute_dtype) for s in sync_sfx]
                   for i in range(Lloc)]
        sink = _ov.StackGrads()
        cos, sin = rope(dev, S)
        tick = [0]

        def stage_fn(_, act):
            t = tick[0]
            tick[0] += 1
            return _ov.gathered_layer_scan(
                lambda lp, a: layer_fn(lp, a, cos, sin), xs_buckets, xs_sync,
                act, buckets, sync_sfx, layout, sh_deg, mp_deg, gather_fns,
                sync_fn, oc, remat=remat, remat_policy=remat_policy,
                anchors=anchors, sink=_TickSink(sink, t))

        with torch.enable_grad():
            emb = outer["model.embed_tokens.weight"].to(compute_dtype)
            x = x_sync(F.embedding(ids.long(), emb))
            outs = pipeline_apply(stage_fn, None, x, axis="pp",
                                  squeeze_stage_dim=False, mesh=mesh)
            last = torch.tensor(float(mesh.axis_index("pp") == pp - 1),
                                dtype=outs.dtype, device=dev)
            h = _compat.psum(outs * last, "pp", mesh=mesh)
            logits = head_logits(outer, h)
            nll = torch.logsumexp(logits.float(), dim=-1) \
                - _gold_logit(logits, labels)
            loss = nll.sum() / (B * S)
            want = [stacked[s] for s in suffixes] + list(outer.values())
            gs = torch.autograd.grad(loss, want, allow_unused=True)
        grads = {}
        rows: Dict[Tuple[int, int], torch.Tensor] = {}
        for (_, b, i), r in sorted(sink.wait_all().items()):  # tick order
            rows[(b, i)] = r if (b, i) not in rows else rows[(b, i)] + r
        for b, bucket in enumerate(buckets):
            for s, gl in _ov._unpack_bucket_grads(
                    [rows[(b, i)] for i in range(Lloc)], bucket, local,
                    per_layer).items():
                grads[_LAYER_PREFIX + s] = torch.stack(gl)
        for s, g in zip(suffixes, gs[:len(suffixes)]):
            if s not in in_bucket:      # the bucketed ones came from the sink
                grads[_LAYER_PREFIX + s] = g
        outer_g = dict(zip(outer, gs[len(suffixes):]))
        grads.update(own_blocks(params, outer_g, used + seq_axes))
        return psum(loss.detach(), used + seq_axes), grads

    def sched_gradients(params, ids, labels):
        from ..parallel.pipelining import pipeline_train_step

        B, S = ids.shape
        mb = B // m
        if mb % dpd:
            raise ValueError(
                f"micro-batch size {mb} not divisible by dp degree {dpd}")
        dp_axes = ("dp",) if dpd > 1 else ()
        ids = block(block(ids.reshape(m, mb, S), dp_axes, 1), seq_axes, 2)
        labels = block(block(labels.reshape(m, mb, S), dp_axes, 1),
                       seq_axes, 2)
        dev = ids.device
        v, nstage = sched.v, pp * sched.v
        blk = L // nstage
        me = mesh.axis_index("pp")

        def to_chunks(t):
            """This rank's [v, blk, ...] chunks of an at-rest [L/pp, ...]
            block (device-major: chunk j is global stage order[me*v+j])."""
            if v == 1:
                return t.reshape((1, blk) + tuple(t.shape[1:]))
            full = all_gather_raw(t, "pp", 0, mesh)
            full = full.reshape((nstage, blk) + tuple(t.shape[1:]))
            return full[[order[me * v + j] for j in range(v)]]

        def from_chunks(g):
            """Inverse of ``to_chunks`` for the gradients."""
            if v == 1:
                return g.reshape((L // pp,) + tuple(g.shape[2:]))
            full = all_gather_raw(g, "pp", 0, mesh)     # device-major
            full = full[inverse].reshape((L,) + tuple(g.shape[2:]))
            return full.narrow(0, me * (L // pp), L // pp)

        chunked = {s: to_chunks(params[_LAYER_PREFIX + s].local.to(
                       compute_dtype)) for s in suffixes}
        chunked = _ov.gather_tree_over_sharding(
            chunked, layout, lead_ndim=2, sh=sh_deg, mp=mp_deg, axis=sh_ax,
            hier=hier, bucket_bytes=oc.bucket_bytes, codec=codec, mesh=mesh)
        outer = outer_leaves(params)
        head = {"norm": outer["model.norm.weight"].detach().to(compute_dtype),
                "head": outer["lm_head.weight"].detach().to(compute_dtype)}
        cos, sin = rope(dev, S)

        def stage_fn(chunk, act):
            layers = {s: chunk[s].unbind(0) for s in suffixes}
            for j in range(blk):
                lp = {s: layers[s][j] for s in suffixes}
                if remat and torch.is_grad_enabled():
                    act = checkpoint_layer(
                        lambda a, lp=lp: layer_fn(lp, a, cos, sin),
                        remat_policy, act)
                else:
                    act = layer_fn(lp, act, cos, sin)
            return act

        def loss_fn(lp, act, y_mb):
            h = fused_rms_norm(act, lp["norm"], cfg.rms_norm_eps)
            logits = h @ lp["head"]
            nll = torch.logsumexp(logits.float(), dim=-1) \
                - _gold_logit(logits, y_mb)
            # the local-token mean / (sep * dp): summed over sep and dp
            # below, the global token mean (equal shard sizes)
            return nll.mean() / (sep * dpd)

        with torch.enable_grad():
            emb = outer["model.embed_tokens.weight"].to(compute_dtype)
            x = F.embedding(ids.long(), emb)
        loss, sgrads, hgrads, dxs = pipeline_train_step(
            stage_fn, loss_fn, sched, chunked, x.detach(), labels, axis="pp",
            loss_params=head, want_x_grad=True, mesh=mesh)
        (d_emb,) = torch.autograd.grad(x, [outer["model.embed_tokens.weight"]],
                                       dxs.to(x.dtype))
        red = seq_axes + dp_axes
        loss = psum(loss, red)
        sgrads = _ov.slice_tree_own_shard(
            {s: psum(g, red) for s, g in sgrads.items()}, layout,
            lead_ndim=2, sh=sh_deg, axis=sh_ax, mesh=mesh)
        grads = {_LAYER_PREFIX + s: from_chunks(g) for s, g in sgrads.items()}
        grads.update(own_blocks(params, {
            "model.embed_tokens.weight": d_emb,
            "model.norm.weight": hgrads["norm"],
            "lm_head.weight": hgrads["head"]}, red))
        return loss, grads

    def gradients(params, input_ids, labels):
        """(global loss, this rank's complete gradient blocks)."""
        check_blocks(params)
        dev = params[_LAYER_PREFIX + suffixes[0]].local.device
        ids = torch.as_tensor(input_ids, device=dev)
        lab = torch.as_tensor(labels, device=dev)
        B, S = ids.shape
        if B % m or S % sep:
            raise ValueError(f"batch {B} x seq {S}: B must divide by "
                             f"num_microbatches={m} and S by sep={sep}")
        if sched is None:
            return gpipe_gradients(params, ids, lab)
        return sched_gradients(params, ids, lab)

    def step(params, opt_state, step_no, lr, input_ids, labels):
        loss, grads = gradients(params, input_ids, labels)
        names = list(params)
        new_p, new_s = optimizer.apply(
            {k: _local(params[k]) for k in names},
            {k: grads[k].to(_local(params[k]).dtype) for k in names},
            {k: {n: _local(t) for n, t in opt_state.get(k, {}).items()}
             for k in names},
            float(lr), int(step_no) + 1,
            decay_mask={n: decay(n) for n in names})

        def wrap(k, t):
            p = params[k]
            return p.with_local(t) if isinstance(p, ShardedTensor) else t

        return (loss, {k: wrap(k, t) for k, t in new_p.items()},
                {k: {n: wrap(k, t) for n, t in st.items()}
                 for k, st in new_s.items()})

    step.gradients = gradients
    return step


__all__ = ["HYBRID_AXES", "build_hybrid_train_step", "hybrid_mesh",
           "hybrid_param_spec", "init_hybrid_state", "shard_hybrid_state",
           "stack_llama_state", "unstack_llama_state"]
