"""The gloo gangs of the port's multi-rank CPU tests.

``run_gang`` spawns ``world`` CPU processes once per test run with
``torch.multiprocessing`` and waits for them: rank r runs ``target(r,
world, root, *args)``, rendezvousing through a ``FileStore`` under
``root`` and writing its results there.  Under xdist every worker that
needs the gang takes a lock file keyed by the run: the first runs it, the
others read its results (or its failure).
"""

from __future__ import annotations

import fcntl
import json
import os
import time
import traceback

import torch


def run_gang(name, target, world, tmp_path_factory, args=(), prepare=None):
    """Run the gang ``name`` (``prepare(root)`` first, in this process) and
    return its results directory."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = (base.parent / f"{name}-{uid}") if uid else (base / name)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (root / "failed").exists():
            raise RuntimeError("the gang failed in another worker:\n"
                               + (root / "failed").read_text())
        if not (root / "done").exists():
            try:
                if prepare is not None:
                    prepare(root)
                t0 = time.time()
                torch.multiprocessing.spawn(
                    target, args=(world, str(root)) + tuple(args),
                    nprocs=world, join=True)
                (root / "done").write_text(json.dumps(
                    {"seconds": time.time() - t0}))
            except BaseException:
                (root / "failed").write_text(traceback.format_exc())
                raise
    return root


def file_store(root, world):
    """The gang's rendezvous store."""
    import torch.distributed as dist

    return dist.FileStore(os.path.join(root, "store"), world)


# ------------------------------------- real collectives against the capture

def _record_collectives(log):
    """Patch the ``torch.distributed`` calls the port's collectives issue
    (``parallel/compat.py``: ``_issue``'s reductions, gathers, scatters and
    exchanges, ``_ppermute_raw``'s ``batch_isend_irecv``) to append
    (op, group ranks, peer, bytes) to ``log``; returns the undo."""
    import torch.distributed as dist

    def ranks(group):
        return tuple(sorted(dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD)))

    def nbytes(t):
        return t.numel() * t.element_size()

    saved = {}

    def wrap(name, kind, payload):
        fn = saved[name] = getattr(dist, name)

        def call(*args, **kwargs):
            log.append((kind, ranks(kwargs.get("group")), None,
                        nbytes(payload(args))))
            return fn(*args, **kwargs)
        setattr(dist, name, call)

    wrap("all_reduce", "allreduce", lambda a: a[0])
    wrap("all_gather_into_tensor", "allgather", lambda a: a[1])
    wrap("reduce_scatter_tensor", "reducescatter", lambda a: a[1])
    wrap("all_to_all_single", "alltoall", lambda a: a[1])
    batch = saved["batch_isend_irecv"] = dist.batch_isend_irecv

    def batched(ops):
        for op in ops:
            g = ranks(op.group)
            log.append(("send" if op.op is dist.isend else "recv", g,
                        op.peer, nbytes(op.tensor)))
        return batch(ops)
    dist.batch_isend_irecv = batched

    def undo():
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return undo


def _parity_steps(device, compute_dtype):
    """(name, mesh shape, axis names, build(mesh) -> (fn, args)) of the
    four-rank parity cases: the Llama mesh step on (dp, sharding, mp) =
    (1, 2, 2) and the dropless EP step on (1, 1, 4), debug sizes."""
    import numpy as np

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         build_train_step)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import expert as pexp

    def llama(mesh):
        cfg = LlamaConfig.debug(vocab=128, hidden=64, layers=2, heads=4,
                                kv_heads=2, inter=128, max_pos=64)
        model = LlamaForCausalLM(
            cfg, device=device, dtype=torch.float32,
            generator=torch.Generator(device=device).manual_seed(3))
        apply_llama_sharding(model, mesh)
        opt = AdamW(learning_rate=1e-4)
        step = build_train_step(model, opt, mesh=mesh,
                                compute_dtype=compute_dtype)
        rng = np.random.default_rng(3)
        ids = torch.from_numpy(rng.integers(0, 128, (4, 16))).to(device)
        params = model.functional_state()
        return step, (params, opt.init_state(params), 0, 1e-4, ids, ids)

    def ep(mesh):
        cfg = pexp.MoEEPConfig(d_model=64, d_hidden=128, num_expert=8,
                               top_k=2)
        g = torch.Generator().manual_seed(5)
        x2d = torch.randn(256, 64, generator=g).to(device, compute_dtype)
        tgt = torch.randn(256, 64, generator=g).to(device)
        params = pexp.init_moe_ep_params(cfg, mesh, seed=4, device=device)
        return pexp.build_moe_ep_dropless_train_step(cfg, mesh, lr=3e-3), \
            (params, x2d, tgt)

    return (("mesh", (1, 2, 2), ("dp", "sharding", "mp"), llama),
            ("ep", (1, 1, 4), ("dp", "sharding", "ep"), ep))


def parity_captures(root, world, device):
    """The Graph Doctor's view of every rank of the parity cases: each
    rank's step captured on a fake group of ``world`` in this process (op,
    group, peer, payload bytes of every collective node, in order), saved
    to ``root/want.<rank>.pt``.  It runs in a process that starts no real
    group: a fake default group destroyed before NCCL starts in the same
    process crashed the NCCL ranks on the card (torch 2.11)."""
    from paddle_tpu_torch.analysis.core import capture, fake_mesh, fake_ranks

    dt = torch.bfloat16 if device == "cuda" else torch.float32
    for rank in range(world):
        want = {}
        for name, shape, axes, build in _parity_steps(device, dt):
            with fake_ranks(world, rank):
                mesh = fake_mesh(shape, axes, device)
                fn, args = build(mesh)
                cap = capture(fn, args, device=device, mesh=mesh)
            want[name] = [(c.op if c.is_p2p else c.kind, c.group, c.peer,
                           c.nbytes) for c in cap.collectives]
            del cap, fn, args
        torch.save(want, os.path.join(root, f"want.{rank}.pt"))


def capture_parity_rank(rank, world, root, device):
    """One rank of the four-rank capture parity: each case's step built on
    a real group (NCCL on ``cuda``, gloo on ``cpu``) and run once with the
    collectives it issues recorded, beside this rank's capture
    (``parity_captures``, made before the ranks start).  Saves both to
    ``root/parity.<rank>.pt``.  On gloo the compute is fp32 (gloo reduces
    bf16 in fp32, which the fake group does not)."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import init_mesh

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dt = torch.bfloat16 if device == "cuda" else torch.float32
    want = torch.load(os.path.join(root, f"want.{rank}.pt"))
    store = dist.FileStore(os.path.join(root, "store"), world)
    out = {}
    try:
        # one default group for both cases (a second NCCL start after a
        # destroy crashed a rank on the card, torch 2.11)
        for name, shape, axes, build in _parity_steps(device, dt):
            mesh = init_mesh(device, shape, axes, store=store, rank=rank,
                             world_size=world)
            fn, args = build(mesh)
            got = []
            undo = _record_collectives(got)
            try:
                fn(*args)
            finally:
                undo()
            if device == "cuda":
                torch.cuda.synchronize()
            out[name] = {"want": want[name], "got": got}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"parity.{rank}.pt"))


# ----------------------------- the in-place update across bucket edges

#: buckets of 997 fp32 elements: their edges fall inside the debug
#: model's leaves, so leaf spans cross buckets
SMALL_BUCKET_BYTES = 4 * 997

#: (name, params dtype, state kind, health) of the in-place mesh cases:
#: bf16 params keep fp32 masters in the flat state, fp32 params have none
IN_PLACE_CASES = (("flat_bf16", torch.bfloat16, "flat", False),
                  ("flat_fp32", torch.float32, "flat", False),
                  ("per_tensor", torch.bfloat16, "per_tensor", False),
                  ("flat_bf16_health", torch.bfloat16, "flat", True),
                  ("flat_fp32_health", torch.float32, "flat", True),
                  ("per_tensor_health", torch.bfloat16, "per_tensor", True),
                  # the host-resident state (C.9): its buckets stream
                  # through both passes of the guarded step
                  ("host_fp32_health", torch.float32, "host", True))


def _leaf_crossings(opt, params, mask, layout):
    """(buckets, leaves whose span in this rank's flat buffers holds a
    bucket edge) of the in-place update's plan."""
    from paddle_tpu_torch.parallel import memory as M

    buckets = crossing = 0
    for g in M._rank_groups(opt._flat_groups(params, mask, layout), params):
        plan = M.stream_bucket_plan(sum(g["sizes"]), 4,
                                    M.IN_PLACE_BUCKET_BYTES)
        buckets += len(plan)
        edges = [off for off, _ in plan[1:]]
        crossing += sum(any(a < e < b for e in edges)
                        for _, a, b in M._key_spans(g))
    return buckets, crossing


def in_place_rank(rank, world, root):
    """One rank of the in-place update (``memory.apply_flat_in_place`` /
    ``apply_in_place``) on a (dp, sharding, mp) = (1, 2, 2) gloo mesh with
    ``SMALL_BUCKET_BYTES`` buckets, for each of ``IN_PLACE_CASES``: three
    steps against the functional twin (the step's own gradients, then
    ``apply_flat`` / ``apply`` building new blocks beside the old), and
    under ``health=`` a fired gate, then an open one held to the twin and
    its probe.  Saves the checks to ``root/in_place.<rank>.json``."""
    import numpy as np
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.health import HealthConfig, make_probe
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import init_mesh
    from paddle_tpu_torch.parallel import memory as M
    from paddle_tpu_torch.parallel.specs import ShardedTensor

    torch.set_num_threads(1)
    M.IN_PLACE_BUCKET_BYTES = SMALL_BUCKET_BYTES
    lr = 1e-3
    store = dist.FileStore(os.path.join(root, "store"), world)
    mesh = init_mesh("cpu", (1, 2, 2), ("dp", "sharding", "mp"), store=store,
                     rank=rank, world_size=world)
    cfg = LlamaConfig.debug(vocab=128, hidden=64, layers=2, heads=4,
                            kv_heads=2, inter=128, max_pos=64)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 128, (4, 16)))

    def loc(t):
        return t.local if isinstance(t, ShardedTensor) else t

    def as_flat(s):
        """A host-resident state's buckets as the flat state they cut."""
        if "__offload__" not in s:
            return s
        return {"__flat__": {g: {n: torch.cat(list(bs))
                                 for n, bs in gs.items()}
                             for g, gs in s["__offload__"].items()}}

    def flat_tensors(p, s):
        out = [p[k].local for k in sorted(p)]
        s = as_flat(s)
        if "__flat__" in s:
            return out + [s["__flat__"][g][n] for g in sorted(s["__flat__"])
                          for n in sorted(s["__flat__"][g])]
        return out + [loc(s[k][n]) for k in sorted(s) for n in sorted(s[k])]

    def clone(p, s):
        p = {k: v.with_local(v.local.clone()) for k, v in p.items()}
        s = as_flat(s)
        if "__flat__" in s:
            return p, {"__flat__": {g: {n: t.clone() for n, t in gs.items()}
                                    for g, gs in s["__flat__"].items()}}
        return p, {k: {n: t.with_local(t.local.clone()) for n, t in
                        st.items()} for k, st in s.items()}

    def kept(p2, s2, p, s):
        """The step handed back the caller's blocks and state."""
        return s2 is s and all(p2[k] is v for k, v in p.items())

    def same(a, b):
        return all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(flat_tensors(*a), flat_tensors(*b)))

    out = {}
    try:
        for name, dtype, kind, health in IN_PLACE_CASES:
            model = LlamaForCausalLM(
                cfg, device="cpu", dtype=dtype,
                generator=torch.Generator().manual_seed(3))
            apply_llama_sharding(model, mesh)
            opt = AdamW(learning_rate=lr, weight_decay=0.01)
            mask = llama_decay_mask(model)
            step = build_train_step(model, opt, mesh=mesh,
                                    compute_dtype=torch.float32)
            p = model.functional_state()
            if kind == "host":
                s = M.init_offloaded_state(opt, p, decay_mask=mask,
                                           bucket_bytes=SMALL_BUCKET_BYTES,
                                           flat_layout=step.flat_layout)
            else:
                s = (opt.init_flat_state(p, decay_mask=mask,
                                         flat_layout=step.flat_layout)
                     if kind == "flat" else opt.init_state(p))

            def twin(p, s, i):
                """The functional update: new blocks, the old untouched."""
                loss, grads = step.accumulate(p, ids, ids)
                if kind in ("flat", "host"):
                    new_p, new_s = opt.apply_flat(
                        p, grads, s, lr, i + 1, decay_mask=mask,
                        flat_layout=step.flat_layout)
                    return loss, grads, new_p, new_s
                new_p, new_s = opt.apply(
                    {k: v.local for k, v in p.items()},
                    {k: g.complete().local for k, g in grads.items()},
                    {k: {n: t.local for n, t in st.items()}
                     for k, st in s.items()},
                    lr, i + 1, decay_mask=mask)
                return loss, grads, \
                    {k: p[k].with_local(v) for k, v in new_p.items()}, \
                    {k: {n: p[k].with_local(t) for n, t in st.items()}
                     for k, st in new_s.items()}

            rec = {}
            if kind == "flat":
                rec["buckets"], rec["crossing"] = _leaf_crossings(
                    opt, p, mask, step.flat_layout)
            if not health:
                tp, ts = clone(p, s)
                ok = True
                for i in range(3):
                    loss, p2, s2 = step(p, s, i, lr, ids, ids)
                    ok &= kept(p2, s2, p, s)
                    tloss, _, tp, ts = twin(tp, ts, i)
                    ok &= torch.equal(loss, tloss) and same((p, s), (tp, ts))
                rec["bit_equal"] = bool(ok)
            else:
                hstep = build_train_step(model, opt, mesh=mesh,
                                         compute_dtype=torch.float32,
                                         health=HealthConfig())
                before = clone(p, s)
                _, p2, s2, probe = hstep(p, s, 0, lr, ids, ids,
                                         health_gates=np.array(
                                             [-1.0, np.inf, np.inf]))
                rec["fired_untouched"] = bool(
                    not probe["ok"] and kept(p2, s2, p, s)
                    and same((p, s), before))
                tloss, tgrads, tp, ts = twin(*before, 0)
                want = make_probe(tloss, tgrads, before[0], tp)
                loss, p2, s2, probe = hstep(p, s, 0, lr, ids, ids)
                rec["open_bit_equal"] = bool(
                    probe["ok"] and kept(p2, s2, p, s)
                    and torch.equal(loss, tloss) and same((p, s), (tp, ts)))
                rec["ratio"] = [float(probe["update_ratio"]),
                                float(want["update_ratio"])]
            out[name] = rec
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"in_place.{rank}.json"), "w") as f:
        json.dump(out, f)
