#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit; the kernels' build from csrc/;
2. every kernel launcher (flash_decode B4, paged_decode B3,
   ragged_paged_decode B3') at the Llama-3-8B attention shapes (32 q heads,
   8 kv heads, head dim 128) in bf16, int8 K/V and fp32, held against its
   plain PyTorch version on the same inputs (per-row error gate, see
   ``row_error``), and timed beside its bandwidth bound, its plain version
   and, for the dense case, one ``scaled_dot_product_attention`` call (a
   yardstick the port never calls);
3. serving at the full width (and depth) of ``LlamaConfig.llama3_8b()`` with
   random bf16 weights from a seeded generator: the chunked engine, the
   unified engine with the prefix cache, and one-shot ``generate``.  The
   launch counters are set to 0 before each path and read after it; every
   decode attention call of the path must have been a kernel launch, and
   every chunk launch of the chunked engine must enqueue without a host
   sync (``torch.cuda.set_sync_debug_mode("error")``).  Emitted tokens are
   checked teacher-forced against a plain fp32 full-sequence forward;
4. ``torch.profiler`` over PROFILE_CHUNKS steady decode chunks of the
   chunked engine with 8 requests of 300 prompt tokens: wall and device
   milliseconds per decode step, the device's idle share, the host's
   enqueue time, the top device kernels;
5. the head-batched flash attention kernels (B1 forward, B2 backward) at
   the ``bench.py`` attention shape (b 6, s 1024, 16 q heads over 4 kv
   heads, head dim 128, causal) in bf16 and fp32, held against their plain
   versions (per-row error gate) and timed beside their bounds, their plain
   versions and one ``scaled_dot_product_attention`` call (forward, and
   forward+backward for B2; a yardstick the port never calls);
6. training at the full width and depth of the ``bench.py`` configuration
   (``TRAIN_CFG``): bf16 params, fp32 AdamW masters from the unrounded init,
   accum 64 with the bf16 carry, one warm-up and three timed steps on one
   batch.  Every attention call of the steps must be a kernel launch (no
   plain-version call), the losses finite and falling, and the bf16 kernel
   path's loss on micro-batch 0 within 2e-2 of a plain fp32 forward on the
   same weights.  Prints ms per step, tokens/s and MFU (6 N per token over
   989 TFLOP/s), and profiles one micro-step;
7. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero, printing no result, when CUDA is not available or the
package is not beside the script.  Writes the full record to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}   # dense, tensor / CUDA cores
# teacher-forced check: an emitted token's fp32 reference logit must lie
# within EPS_STD reference-logit standard deviations of the reference max.
# Why 0.25: the bf16 engine rounds its residual stream at each of the 64
# sublayer adds (2^-9 relative each, ~1.6% after 64), which moves a logit
# by ~0.02 std; the worst of ~200 tokens sits a few of those out, ~0.1.
# Greedy near-ties inside that band may flip.  A wrong attention result
# picks tokens that are typical under the reference, ~4 std below its max.
EPS_STD = 0.25
# kernel error gate, per output row (one q head of one query): the row's
# largest |kernel - plain| over its largest |plain|; see row_error.  bf16
# (also bf16 q with int8 K/V): both sides round their fp32 result to bf16,
# and two fp32 values a hair apart can round one bf16 ulp apart, up to
# 2^-7 = 7.8e-3 of the element; the kernel also rounds p against its
# running max, the plain version against the final max.  The limit is two
# such ulps.  A planted fault (a skipped loop trip, a missing rescale of
# the accumulator) reads far above it: tests/test_torch_cuda_kernels.py.
ROW_TOL = {"fp32": 1e-4, "bf16": 1.6e-2}
# the attention shapes of LlamaConfig.llama3_8b() and the serving pools
H, KVH, D = 32, 8, 128
PAGE, N_PAGES, MAX_PAGES = 16, 1025, 128
KERNEL_CASES = {"bf16": "bf16", "int8": "bf16", "fp32": "fp32"}  # -> q kind
PROFILE_CHUNKS = 3            # profiled window: 3 chunks of 8 decode steps
# B1/B2 at the bench.py attention shape: b, s, q heads, kv heads, head dim
FLASH_SHAPE = (6, 1024, 16, 4, 128)
# flash kernel error gate, with row_error's per-row measure: o and dq per q
# row of each head, dk and dv per kv row; lse (fp32 on both sides) as its
# largest |kernel - plain| over its largest |plain|.  fp32 1e-4, as the
# decode kernels.  bf16 outputs: two bf16 ulps, as the decode kernels.  Both
# sides round the same fp32 sums, taken in another order, to bf16 (o, and
# the gradients at the end), and round p or ds to bf16 from fp32 values a
# hair apart before a product; the sound kernels read at most one ulp
# (7.8e-3) on every card-test shape and at the bench.py shape.
FLASH_ROW_TOL = {"fp32": {"o": 1e-4, "lse": 1e-4, "dq": 1e-4, "dk": 1e-4,
                          "dv": 1e-4},
                 "bf16": {"o": 1.6e-2, "lse": 1e-4, "dq": 1.6e-2,
                          "dk": 1.6e-2, "dv": 1.6e-2}}
# A gradient row can be 0 in exact arithmetic and rounding noise on both
# sides: causal position 0 sees only key 0, so p = 1 and dp = delta, and
# its dq row is ds * k with ds = p (dp - delta) * scale of order 1e-7.  The
# gradient gate therefore divides each row's error by at least this share
# of the tensor's largest magnitude.
GRAD_ROW_FLOOR = 1e-3
# the one-chip train step of bench.py:57-67 (vocab 32000, hidden 2048,
# intermediate 5504, 10 layers, 16 q heads over 4 kv heads, seq 1024,
# batch 6, accum 64), AdamW lr 1e-4
TRAIN_CFG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=10, num_attention_heads=16,
                 num_key_value_heads=4, max_position_embeddings=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 6, 1024, 64
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_LR = 1, 3, 1e-4
# step-0 loss of the bf16 kernel path against a plain fp32 forward
TRAIN_LOSS_TOL = 2e-2
H100_BF16_PEAK = 989e12       # dense bf16 tensor-core rate, the MFU yardstick


def _sync():
    import torch
    torch.cuda.synchronize()


def time_ms(fn, reps, flush):
    """Mean device milliseconds of ``fn`` over ``reps`` launches, each
    after overwriting ``flush`` (larger than the 50 MB L2): a serving step
    finds each layer's K/V cold."""
    import torch
    fn()
    _sync()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- kernel phase

def row_error(got, want, floor=0.0):
    """(gate error, max-abs error) of a kernel output against its plain
    version.  The gate error is the largest, over output rows (the last
    axis is the head dim), of the row's largest |got - want| over its
    largest |want|: a long row's small outputs are held as tightly as a
    short row's large ones.  A row whose plain output is exactly 0 (no
    visible key, a padding row) must be exactly 0 (error inf otherwise).
    ``floor`` > 0 divides instead by at least ``floor`` times the whole
    output's largest |want| (for gradients, see GRAD_ROW_FLOOR)."""
    import torch
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    if not torch.isfinite(g).all():
        return float("inf"), float("inf")
    diff = (g - w).abs().amax(-1)
    den = w.abs().amax(-1)
    if floor > 0:
        den = den.clamp_min(floor * den.max())
    rel = torch.where(den > 0, diff / den.clamp_min(1e-30),
                      torch.where(diff > 0, float("inf"), 0.0))
    return rel.max().item(), diff.max().item()


def launcher_inputs(case, dev):
    """Inputs of the three launchers at the 8B attention shapes for one
    case of ``KERNEL_CASES`` (bf16; bf16 q with int8 K/V; fp32), made from
    SEED: lengths of 0 and off page multiples, -1 table entries, padding
    rows.  Returns {launcher: dict(args, shape, nbytes, ops)}: ``nbytes``
    counts each input the launcher must read once (the visible K/V rows,
    q, lens, tables) and the output written once; ``ops`` the flops of
    the attended (row, token) pairs."""
    import numpy as np
    import torch

    dtype = torch.bfloat16 if KERNEL_CASES[case] == "bf16" else torch.float32
    int8 = case == "int8"
    g = torch.Generator(device=dev).manual_seed(SEED)
    perm = np.random.default_rng(SEED).permutation(N_PAGES - 1)
    item = 1 if int8 else torch.empty((), dtype=dtype).element_size()
    qitem = torch.empty((), dtype=dtype).element_size()

    def kv(*shape):
        if int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def qt(rows):
        qs = 0.05 if int8 else 1.0           # int8 K/V: scores stay O(1)
        return (qs * torch.randn(rows, H, D, generator=g,
                                 device=dev)).to(dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def tables(slot_lens):
        t = np.full((len(slot_lens), MAX_PAGES), -1, np.int32)
        for s, n in enumerate(slot_lens):
            npg = -(-n // PAGE)
            t[s, :npg] = perm[s * MAX_PAGES:s * MAX_PAGES + npg]
        return torch.from_numpy(t).to(dev)

    def work(kv_rows, attended, rows, extra_ints):
        nbytes = 2 * kv_rows * KVH * D * item + 2 * rows * H * D * qitem \
            + 4 * extra_ints
        return nbytes, 4 * H * D * attended

    out = {}
    # B4 dense: 8 sequences against a [8, 8, 2048, 128] cache
    t_max = PAGE * MAX_PAGES
    lens = [0, 1, 37, 300, 513, 1024, 1500, 2048]
    nbytes, ops = work(sum(lens), sum(lens), 8, 8)
    out["flash_decode"] = dict(
        args=(qt(8), kv(8, KVH, t_max, D), kv(8, KVH, t_max, D), i32(lens)),
        shape=f"q[8,{H},{D}] kv[8,{KVH},{t_max},{D}]", nbytes=nbytes,
        ops=ops)
    # B3 paged: the chunked engine's decode batch on the serving pools
    kp, vp = kv(N_PAGES, KVH, PAGE, D), kv(N_PAGES, KVH, PAGE, D)
    lens = [0, 5, 16, 33, 300, 777, 1500, 2048]
    nbytes, ops = work(sum(lens), sum(lens), 8, 8 + 8 * MAX_PAGES)
    out["paged_decode"] = dict(
        args=(qt(8), kp, vp, i32(lens), tables(lens)),
        shape=f"q[8,{H},{D}] pools[{N_PAGES},{KVH},{PAGE},{D}] "
              f"tables[8,{MAX_PAGES}]", nbytes=nbytes, ops=ops)
    # B3' ragged: the unified engine's rows (rows_cap = 8 + 256): 6 decode
    # rows, a 200-row prefill chunk of slot 6, a 50-row first chunk of
    # slot 7, 8 padding rows; each sequence's K/V is read once at best
    dec = [0, 17, 300, 1000, 1500, 2048]
    row_lens = dec + list(range(101, 301)) + list(range(1, 51)) + [7] * 8
    row_slot = list(range(6)) + [6] * 200 + [7] * 50 + [-1] * 8
    slot_lens = dec + [300, 50]
    T = len(row_lens)
    attended = sum(n for n, s in zip(row_lens, row_slot) if s >= 0)
    nbytes, ops = work(sum(slot_lens), attended, T,
                       2 * T + 8 * MAX_PAGES)
    out["ragged_paged_decode"] = dict(
        args=(qt(T), kp, vp, i32(row_lens), i32(row_slot),
              tables(slot_lens)),
        shape=f"q[{T},{H},{D}] pools[{N_PAGES},{KVH},{PAGE},{D}] "
              f"tables[8,{MAX_PAGES}]", nbytes=nbytes, ops=ops)
    return out


def _sdpa_ms(q, k, v, lens, flush):
    """One ``scaled_dot_product_attention`` call computing flash_decode's
    function on its inputs (int8 K/V excepted), timed as a yardstick."""
    import torch
    import torch.nn.functional as F
    mask = (torch.arange(k.shape[2], device=k.device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q.view(q.shape[0], q.shape[1], 1, q.shape[2])
    return time_ms(lambda: F.scaled_dot_product_attention(
        q4, k, v, attn_mask=mask, scale=q.shape[2] ** -0.5,
        enable_gqa=True), 20, flush)


def kernel_cases(dev, flush):
    """Each launcher at the 8B attention shapes in every case; returns one
    record per (launcher, case)."""
    import torch
    from paddle_tpu_torch.ops import decode_attention as da

    records = []
    plain_reps = {"flash_decode": 5, "paged_decode": 5,
                  "ragged_paged_decode": 3}
    for case, kind in KERNEL_CASES.items():
        tol = ROW_TOL[kind]
        for name, inp in launcher_inputs(case, dev).items():
            kernel, plain = getattr(da, name), getattr(da, name + "_plain")
            args = inp["args"]
            got, want = kernel(*args), plain(*args)
            _sync()
            err, abs_err = row_error(got, want)
            if not err <= tol:
                raise AssertionError(f"{name}[{case}]: per-row error {err} "
                                     f"> {tol}")
            library, call = None, ("none: no single PyTorch call computes "
                                   "paged attention")
            if name == "flash_decode":
                call = "none: no PyTorch call takes int8 K/V"
                if case != "int8":
                    library = _sdpa_ms(*args, flush)
                    call = ("F.scaled_dot_product_attention(enable_gqa, "
                            "length mask)")
            bms, by = bound(inp["nbytes"], inp["ops"], kind)
            records.append(dict(
                name=name, case=case, shape=inp["shape"], err=err, tol=tol,
                max_abs_err=abs_err,
                ms=time_ms(lambda: kernel(*args), 50, flush),
                plain_ms=time_ms(lambda: plain(*args), plain_reps[name],
                                 flush),
                bound_ms=bms, bound_by=by, library_ms=library,
                library_call=call))
        del inp, args, got, want
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ serving phase

def _reference_hidden(cfg, params, seqs, dev):
    """Plain fp32 full-sequence forward (independent of the port's code):
    each bf16 weight is cast to fp32 at its use, so the fp32 copies of the
    model never coexist.  Sequences are right-padded; causal attention
    keeps the padding out of every real position."""
    import numpy as np
    import torch

    n, S = len(seqs), max(len(s) for s in seqs)
    ids = torch.zeros(n, S, dtype=torch.long, device=dev)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = torch.from_numpy(np.asarray(s, np.int64))
    H, KV, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    inv = 1.0 / cfg.rope_theta ** (np.arange(0, d, 2) / d)
    ang = np.outer(np.arange(S), inv)
    cos = torch.from_numpy(np.cos(np.concatenate([ang, ang], -1))).float()
    sin = torch.from_numpy(np.sin(np.concatenate([ang, ang], -1))).float()
    cos, sin = cos.to(dev)[None, :, None], sin.to(dev)[None, :, None]

    def rms(x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + cfg.rms_norm_eps) * w.float()

    def rope(x):
        a, b = x.chunk(2, -1)
        return x * cos + torch.cat([-b, a], -1) * sin

    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    x = params["model.embed_tokens.weight"][ids].float()
    for i in range(cfg.num_hidden_layers):
        def W(name):
            return params[f"model.layers.{i}.{name}"].float()
        hx = rms(x, W("input_layernorm.weight"))
        q = rope((hx @ W("self_attn.q_proj.weight")).view(n, S, H, d))
        k = rope((hx @ W("self_attn.k_proj.weight")).view(n, S, KV, d))
        v = (hx @ W("self_attn.v_proj.weight")).view(n, S, KV, d)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        att = torch.einsum("bshd,bthd->bhst", q, k) * d ** -0.5
        att = att.masked_fill(~causal, float("-inf")).softmax(-1)
        o = torch.einsum("bhst,bthd->bshd", att, v).reshape(n, S, H * d)
        x = x + o @ W("self_attn.o_proj.weight")
        hx = rms(x, W("post_attention_layernorm.weight"))
        x = x + (torch.nn.functional.silu(hx @ W("mlp.gate_proj.weight"))
                 * (hx @ W("mlp.up_proj.weight"))) @ W("mlp.down_proj.weight")
    return rms(x, params["model.norm.weight"])


def teacher_forced(cfg, params, prompts, outputs, dev):
    """For every emitted token, its fp32 reference logit (teacher-forced on
    prompt + emitted tokens) must be within EPS_STD reference standard
    deviations of the reference row's max.  Returns the statistics."""
    import numpy as np
    import torch

    seqs = [np.concatenate([p, o[:-1]]) for p, o in zip(prompts, outputs)]
    with torch.no_grad():
        x = _reference_hidden(cfg, params, seqs, dev)
        head = params["lm_head.weight"].float()
        worst, exact, total = 0.0, 0, 0
        for i, (p, o) in enumerate(zip(prompts, outputs)):
            rows = x[i, len(p) - 1:len(p) - 1 + len(o)] @ head   # [n, V]
            toks = torch.from_numpy(np.asarray(o, np.int64)).to(dev)
            mx, arg = rows.max(-1)
            gap = (mx - rows.gather(1, toks[:, None])[:, 0]) / rows.std(-1)
            worst = max(worst, gap.max().item())
            exact += int((arg == toks).sum())
            total += len(o)
        del head
    torch.cuda.empty_cache()
    if worst > EPS_STD:
        raise AssertionError(
            f"teacher-forced check: an emitted token's reference logit is "
            f"{worst:.4f} reference std below the max (limit {EPS_STD})")
    return {"worst_gap_std": worst, "argmax_agree": exact / total,
            "tokens_checked": total}


def serve_chunked(cfg, params, prompts, dev):
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=1025,
                                   page_size=16, max_seq_len=2048,
                                   decode_chunk_steps=8, device=dev)
    for p in prompts:
        eng.add_request(p, max_new_tokens=32)
    launched = {"chunks": 0}
    launch = eng._launch

    def counted():
        # a launch only enqueues: any host<->device sync in it raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            ok = launch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched["chunks"] += ok
        return ok

    eng._launch = counted
    steps = []
    da.reset_launches()
    t0 = time.perf_counter()
    while eng.queue or eng.active.any() or eng._inflight:
        s0, c0 = time.perf_counter(), launched["chunks"]
        produced = eng.step()
        steps.append((time.perf_counter() - s0,
                      int(eng.last_report["seq_lens_encoder"].sum()),
                      produced, launched["chunks"] - c0))
    _sync()
    wall = time.perf_counter() - t0
    counts = dict(da.LAUNCHES)
    done = sorted(eng.finished, key=lambda f: f.rid)
    eng.shutdown()
    L = cfg.num_hidden_layers
    want = launched["chunks"] * eng.chunk * L
    if counts["paged_decode"] != want or counts["paged_decode"] == 0:
        raise AssertionError(f"chunked path: {counts} paged launches, "
                             f"expected {want} ({launched['chunks']} chunks)")
    if counts["flash_decode"] or counts["ragged_paged_decode"]:
        raise AssertionError(f"chunked path launched other kernels {counts}")
    if len(done) != len(prompts) or any(len(f.tokens) != 32 for f in done):
        raise AssertionError("chunked path: not every request finished")
    steady = [w / eng.chunk for w, enc, prod, ch in steps
              if enc == 0 and prod > 0 and ch == 1]
    tokens = sum(len(f.tokens) for f in done)
    return done, dict(
        requests=len(done), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, launches=counts,
        chunks=launched["chunks"],
        ms_per_decode_step=statistics.median(steady) * 1e3 if steady
        else None, steady_steps=len(steady))


def serve_unified(cfg, params, prompts, dev):
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=1025,
                                   page_size=16, max_seq_len=2048,
                                   prefill_token_budget=256,
                                   enable_prefix_cache=True, device=dev)
    launched = {"steps": 0}
    unified_step = eng._unified_step

    def counted(*a):
        launched["steps"] += 1
        return unified_step(*a)

    eng._unified_step = counted
    # the second sharer of the system prompt arrives after the first
    # one's prefill committed its pages, so it hits the prefix cache
    first = [eng.add_request(p, max_new_tokens=32) for p in prompts[:-1]]
    steps = []
    da.reset_launches()
    t0 = time.perf_counter()
    late = None
    while eng.queue or eng.active.any() or late is None:
        if late is None and first[-1] in eng.out_tokens:
            late = eng.add_request(prompts[-1], max_new_tokens=32)
        s0 = time.perf_counter()
        produced = eng.step()
        steps.append((time.perf_counter() - s0,
                      int(eng.last_report["seq_lens_encoder"].sum()),
                      produced))
    _sync()
    wall = time.perf_counter() - t0
    counts = dict(da.LAUNCHES)
    stats = eng.serving_stats()
    done = sorted(eng.finished, key=lambda f: f.rid)
    eng.shutdown()
    want = launched["steps"] * cfg.num_hidden_layers
    if counts["ragged_paged_decode"] != want or want == 0:
        raise AssertionError(f"unified path: {counts} ragged launches, "
                             f"expected {want}")
    if counts["flash_decode"] or counts["paged_decode"]:
        raise AssertionError(f"unified path launched other kernels {counts}")
    if len(done) != len(prompts) or any(len(f.tokens) != 32 for f in done):
        raise AssertionError("unified path: not every request finished")
    hit = stats["prefill"][late]
    if stats["prefix_cache"]["hits"] < 1 or hit["cached_tokens"] != 64 \
            or hit["prefilled"] != hit["prompt_len"] - 64:
        raise AssertionError(f"unified path: no prefix-cache hit {stats}")
    decode_only = [w for w, enc, prod in steps if enc == 0 and prod > 0]
    tokens = sum(len(f.tokens) for f in done)
    return done, dict(
        requests=len(done), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, launches=counts,
        unified_steps=launched["steps"],
        ms_per_decode_step=statistics.median(decode_only) * 1e3
        if decode_only else None, decode_only_steps=len(decode_only),
        prefix_cache=stats["prefix_cache"], warm_request=hit)


def serve_generate(cfg, model, prompt, dev):
    import torch
    from paddle_tpu_torch.ops import decode_attention as da

    da.reset_launches()
    t0 = time.perf_counter()
    out = model.generate(prompt[None], max_new_tokens=32)
    _sync()
    wall = time.perf_counter() - t0
    counts = dict(da.LAUNCHES)
    want = 31 * cfg.num_hidden_layers
    if counts["flash_decode"] != want or counts["paged_decode"] \
            or counts["ragged_paged_decode"]:
        raise AssertionError(f"generate: {counts}, expected {want} "
                             f"flash_decode launches")
    toks = out[0, len(prompt):].cpu().numpy()
    if toks.shape != (32,) or not torch.isfinite(out.float()).all():
        raise AssertionError("generate: bad output")
    return toks, dict(tokens=32, wall_s=wall, tokens_per_s=32 / wall,
                      launches=counts)


def profile_decode(cfg, params, dev, chunks):
    """Where a steady decode step of the chunked engine spends its time:
    8 requests of 300 prompt tokens decode together while
    ``torch.profiler`` records ``chunks`` decode chunks (CPU and CUDA
    activities).  Returns wall and device milliseconds per decode step,
    the device's idle share, the host's time to enqueue a chunk without the
    profiler and the device kernels that take most time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=1025,
                                   page_size=16, max_seq_len=2048,
                                   decode_chunk_steps=8, device=dev)
    rng = np.random.default_rng(SEED)
    for _ in range(8):
        eng.add_request(rng.integers(1, cfg.vocab_size, 300),
                        8 * (chunks + 4))
    for _ in range(2):                     # admit all, fill the pipeline
        eng.step()
    _sync()
    # one step after the device drained: the host's enqueue cost alone
    t0 = time.perf_counter()
    eng.step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            eng.step()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    eng.shutdown()
    steps = chunks * eng.chunk
    # device rows only (kernels, copies): a CPU op's row also carries the
    # device time of the kernels it launched, which would count twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise AssertionError("profile: the profiler saw no device time")
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "slots": 8, "prompt_tokens": 300, "profiled_steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e3 / wall_ms,
        "enqueue_ms_per_step_unprofiled": enqueue_ms / eng.chunk,
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_step": e.self_device_time_total / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top]}


# ------------------------------------------------------ flash kernel phase

def flash_inputs(kind, dev, shape=FLASH_SHAPE):
    """(q, k, v, do) of the HB launchers for ``shape`` = (b, s, h, kvh, d)
    in bf16 or fp32, from SEED: q, do [b*kvh, h/kvh, s, d]; k, v
    [b*kvh, s, d]; N(0, 1), so the scaled scores are O(1)."""
    import torch
    b, s, h, kvh, d = shape
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    g = torch.Generator(device=dev).manual_seed(SEED)

    def r(*sh):
        return torch.randn(sh, generator=g, device=dev).to(dtype)

    return (r(b * kvh, h // kvh, s, d), r(b * kvh, s, d), r(b * kvh, s, d),
            r(b * kvh, h // kvh, s, d))


def flash_work(q, k):
    """(forward bytes, backward bytes, forward flops) of causal HB
    attention: each input read once and each output written once (forward
    q, k, v -> o, lse; backward q, k, v, o, do, lse -> dq, dk, dv); the
    flops of the two products over the s(s+1)/2 visible pairs per head
    (the backward does 2.5 times as many)."""
    bkv, rep, s, d = q.shape
    item = q.element_size()
    lse = 4 * bkv * rep * s
    fwd = item * (2 * q.numel() + 2 * k.numel()) + lse
    bwd = item * (4 * q.numel() + 4 * k.numel()) + lse
    return fwd, bwd, 4 * d * (s * (s + 1) // 2) * bkv * rep


def flash_errors(kind, got, want):
    """{output: gate error} and the largest absolute error, raising when a
    reading is above FLASH_ROW_TOL[kind]."""
    import torch
    errs, worst = {}, 0.0
    for name, g in got.items():
        w = want[name]
        if name == "lse":
            diff = (g - w).abs().max().item()
            err = diff / w.abs().max().item() if torch.isfinite(g).all() \
                else float("inf")
        else:
            err, diff = row_error(g, w, 0.0 if name == "o"
                                  else GRAD_ROW_FLOOR)
        errs[name], worst = err, max(worst, diff)
        if not err <= FLASH_ROW_TOL[kind][name]:
            raise AssertionError(f"flash {name}[{kind}]: error {err} > "
                                 f"{FLASH_ROW_TOL[kind][name]}")
    return errs, worst


def flash_cases(dev, flush):
    """B1 and B2 at FLASH_SHAPE in bf16 and fp32: gated against the plain
    versions (the backward from the plain forward's o and lse), timed beside
    bound, plain and one SDPA call."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    b, s, h, kvh, d = FLASH_SHAPE
    scale = d ** -0.5
    records = []
    for kind in ("bf16", "fp32"):
        q, k, v, do = flash_inputs(kind, dev)
        o, lse = fa.hb_flash_forward(q, k, v, True, scale)
        wo, wlse = fa.hb_flash_forward_plain(q, k, v, True, scale)
        dq, dk, dv = fa.hb_flash_backward(q, k, v, wo, wlse, do, True, scale)
        want = fa.hb_flash_backward_plain(q, k, v, wo, wlse, do, True, scale)
        _sync()
        ferr, fabs = flash_errors(kind, {"o": o, "lse": lse},
                                  {"o": wo, "lse": wlse})
        berr, babs = flash_errors(kind, {"dq": dq, "dk": dk, "dv": dv},
                                  dict(zip(("dq", "dk", "dv"), want)))
        del o, lse, dq, dk, dv, want
        fwd_bytes, bwd_bytes, ops = flash_work(q, k)
        q4, k4, v4, do4 = (q.view(b, h, s, d), k.view(b, kvh, s, d),
                           v.view(b, kvh, s, d), do.view(b, h, s, d))
        leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]

        def sdpa(*t):
            return F.scaled_dot_product_attention(*t, is_causal=True,
                                                  scale=scale,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(*leaves), leaves, do4)

        reps, plain_reps = (20, 3) if kind == "bf16" else (5, 2)
        shape = f"q[{b * kvh},{h // kvh},{s},{d}] kv[{b * kvh},{s},{d}]"
        for name, kernel, plain, lib, nbytes, flops, errs, worst in (
                ("flash_attention_fwd",
                 lambda: fa.hb_flash_forward(q, k, v, True, scale),
                 lambda: fa.hb_flash_forward_plain(q, k, v, True, scale),
                 lambda: sdpa(q4, k4, v4), fwd_bytes, ops, ferr, fabs),
                ("flash_attention_bwd",
                 lambda: fa.hb_flash_backward(q, k, v, wo, wlse, do, True,
                                              scale),
                 lambda: fa.hb_flash_backward_plain(q, k, v, wo, wlse, do,
                                                    True, scale),
                 sdpa_fwd_bwd, bwd_bytes, 2.5 * ops, berr, babs)):
            bms, by = bound(nbytes, flops, kind)
            ms = time_ms(kernel, reps, flush)
            records.append(dict(
                name=name, case=kind, shape=shape, err=errs,
                tol={n: FLASH_ROW_TOL[kind][n] for n in errs},
                max_abs_err=worst, ms=ms,
                plain_ms=time_ms(plain, plain_reps, flush),
                bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9,
                library_ms=time_ms(lib, reps, flush),
                library_call=("F.scaled_dot_product_attention(is_causal, "
                              "enable_gqa)" + (" forward+backward"
                                               if name.endswith("bwd")
                                               else ""))))
        del q, k, v, do, wo, wlse, q4, k4, v4, do4, leaves
        torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------- training phase

def reference_loss(cfg, params, ids, labels, dev):
    """Mean CE of a plain fp32 forward (``_reference_hidden``: einsum
    attention, independent of the port's code) on the given bf16 weights,
    each cast to fp32 at its use."""
    import torch
    with torch.no_grad():
        x = _reference_hidden(cfg, params, list(ids.cpu().numpy()), dev)
        logits = x @ params["lm_head.weight"].float()
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[..., None])[..., 0]
        loss = nll.mean().item()
    del x, logits, nll
    torch.cuda.empty_cache()
    return loss


def train_phase(dev, accum=TRAIN_ACCUM):
    """bench.py main() on the port: the TRAIN_CFG Llama with bf16 params,
    fp32 AdamW masters from the unrounded fp32 init (master_from), the bf16
    accumulation carry; the same batch every step (numpy seed SEED)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**TRAIN_CFG)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             generator=gen)
    p32 = model.functional_state()
    params = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    opt = AdamW(learning_rate=TRAIN_LR, multi_precision=True)
    state = opt.init_flat_state(params, decay_mask=llama_decay_mask(model),
                                master_from=p32)
    del p32
    n_params = sum(v.numel() for v in params.values())
    rng = np.random.default_rng(SEED)
    shape = (accum, TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)

    # step-0 check at accum 1 on micro-batch 0: bf16 kernel path vs fp32
    step1 = build_train_step(model, opt, compute_dtype=torch.bfloat16)
    kernel_loss = step1.accumulate(params, ids[0], labels[0])[0].item()
    ref_loss = reference_loss(cfg, params, ids[0], labels[0], dev)
    rel = abs(kernel_loss - ref_loss) / abs(ref_loss)
    if not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"train: bf16 kernel loss {kernel_loss} vs fp32 "
                             f"plain {ref_loss}: {rel} > {TRAIN_LOSS_TOL}")
    torch.cuda.empty_cache()

    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=accum)
    plain_calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = fa.hb_flash_forward_plain, fa.hb_flash_backward_plain

    def counted(fn, key):
        def call(*a, **kw):
            plain_calls[key] += 1
            return fn(*a, **kw)
        return call

    fa.hb_flash_forward_plain = counted(plain_fwd, "fwd")
    fa.hb_flash_backward_plain = counted(plain_bwd, "bwd")
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    fa.reset_launches()
    try:
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, params, state = step(params, state, i, TRAIN_LR, ids,
                                       labels)
            _sync()
            walls.append(time.perf_counter() - t0)
            losses.append(loss.item())
    finally:
        fa.hb_flash_forward_plain, fa.hb_flash_backward_plain = \
            plain_fwd, plain_bwd
    counts = dict(fa.LAUNCHES)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    want = cfg.num_hidden_layers * accum * steps
    if counts != {"flash_attention_fwd": want, "flash_attention_bwd": want} \
            or any(plain_calls.values()):
        raise AssertionError(f"train: launches {counts} (expected {want} "
                             f"each), plain calls {plain_calls}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} not finite and falling")
    window = sum(walls[TRAIN_WARMUP:])
    tokens_per_s = accum * TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / window
    result = dict(
        config=TRAIN_CFG, batch=TRAIN_BATCH, seq=TRAIN_SEQ, accum=accum,
        n_params=n_params, losses=losses, step_s=walls,
        ms_per_step=window / TRAIN_STEPS * 1e3, tokens_per_s=tokens_per_s,
        mfu=6 * n_params * tokens_per_s / H100_BF16_PEAK,
        launches=counts, plain_calls=plain_calls,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        step0_check=dict(kernel_bf16=kernel_loss, plain_fp32=ref_loss,
                         rel=rel, tol=TRAIN_LOSS_TOL))
    result["profile"] = profile_train(step1, params, ids[0], labels[0])
    del model, params, state, step, step1
    torch.cuda.empty_cache()
    return result


def profile_train(step1, params, ids, labels, micro_steps=2):
    """``torch.profiler`` over ``micro_steps`` fwd+bwd micro-steps (accum 1,
    no update): wall and device ms per micro-step, the device's idle share
    and the kernels that take most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step1.accumulate(params, ids, labels)
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(micro_steps):
            step1.accumulate(params, ids, labels)
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        raise AssertionError("train profile: the profiler saw no device time")
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]

    def share(match):
        return sum(e.self_device_time_total for e in events
                   if match(e.key)) / 1e3 / micro_steps

    flash = share(lambda k: "hb_" in k and "_kernel" in k)
    gemm = share(lambda k: any(t in k.lower() for t in
                               ("nvjet", "gemm", "cutlass", "sm90_xmma")))
    return {"micro_steps": micro_steps,
            "device_ms_by_class": {
                "flash_kernels": flash, "gemms": gemm,
                "other": device_us / 1e3 / micro_steps - flash - gemm},
            "wall_ms_per_micro_step": wall_ms / micro_steps,
            "device_ms_per_micro_step": device_us / 1e3 / micro_steps,
            "device_idle_share": 1.0 - device_us / 1e3 / wall_ms,
            "top_kernels": [{"name": e.key[:80],
                             "ms_per_micro_step":
                                 e.self_device_time_total / 1e3 / micro_steps,
                             "calls_per_micro_step": e.count / micro_steps}
                            for e in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import numpy as np
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    record["build_s"] = _build.build()
    print(f"build: {record['build_s']:.1f} s (nvcc, sm_90a)", flush=True)

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    record["kernels"] = kernel_cases(dev, flush)
    print(f"kernel phase: {len(record['kernels'])} decode launcher/dtype cases "
          f"agree with their plain versions", flush=True)
    del flush
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              max_position_embeddings=2048)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=gen)
    params = model.functional_state()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (32, 75, 128, 190, 257, 300)]
    system = rng.integers(1, cfg.vocab_size, (64,)).astype(np.int32)
    # four private prompts and two sharing a 64-token system prompt; the
    # last sharer arrives once the first one's prefill committed its pages
    shared = [prompts[0], prompts[2], prompts[3], prompts[5],
              np.concatenate([system, prompts[1][:40]]),
              np.concatenate([system, prompts[4][:120]])]

    serving = {}
    done, serving["chunked"] = serve_chunked(cfg, params, prompts, dev)
    serving["chunked"]["teacher_forced"] = teacher_forced(
        cfg, params, prompts, [f.tokens for f in done], dev)
    print("serving chunked: " + json.dumps(serving["chunked"]), flush=True)

    done, serving["unified"] = serve_unified(cfg, params, shared, dev)
    by_rid = {f.rid: f.tokens for f in done}
    order = sorted(by_rid)
    serving["unified"]["teacher_forced"] = teacher_forced(
        cfg, params, shared, [by_rid[r] for r in order], dev)
    print("serving unified+prefix-cache: " + json.dumps(serving["unified"]),
          flush=True)

    toks, serving["generate"] = serve_generate(cfg, model, prompts[3], dev)
    serving["generate"]["teacher_forced"] = teacher_forced(
        cfg, params, [prompts[3]], [toks], dev)
    print("serving generate: " + json.dumps(serving["generate"]), flush=True)
    record["serving"] = serving
    record["profile"] = profile_decode(cfg, params, dev, PROFILE_CHUNKS)
    print("profile: " + json.dumps(record["profile"]), flush=True)
    del model, params
    torch.cuda.empty_cache()

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    record["flash_kernels"] = flash_cases(dev, flush)
    del flush
    torch.cuda.empty_cache()
    for r in record["flash_kernels"]:
        print(f"kernel {r['name']}[{r['case']}] {r['shape']}: "
              f"err={json.dumps(r['err'])} (tol {json.dumps(r['tol'])}) "
              f"max_abs_err={r['max_abs_err']:.3g} kernel_ms={r['ms']:.4f} "
              f"({r['tflops']:.1f} TFLOP/s) plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']:.4f} [{r['library_call']}]",
              flush=True)
    record["train"] = train_phase(dev)
    print("train: " + json.dumps({k: v for k, v in record["train"].items()
                                  if k != "profile"}), flush=True)
    print("train profile: " + json.dumps(record["train"]["profile"]),
          flush=True)
    record["wall_s"] = time.perf_counter() - t0

    source = "paddle_tpu_torch/csrc/decode_attention.cu"
    tpu = "paddle_tpu/ops/pallas/decode_attention.py"
    main_path = {"flash_decode": ("generate", f"{tpu}:45"),
                 "paged_decode": ("chunked", f"{tpu}:177"),
                 "ragged_paged_decode": ("unified", f"{tpu}:177")}
    for r in record["kernels"]:
        path = main_path[r["name"]][0]
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']}[{r['case']}] {r['shape']}: "
              f"err={r['err']:.3g} (per-row tol {r['tol']}) "
              f"max_abs_err={r['max_abs_err']:.3g} "
              f"launches={serving[path]['launches'][r['name']]} ({path} "
              f"path) kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={lib} [{r['library_call']}]", flush=True)
    kernels = []
    for name, (path, replaces) in main_path.items():
        bf16 = next(r for r in record["kernels"]
                    if r["name"] == name and r["case"] == "bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": serving[path]["launches"][name],
            "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
            "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "checked_by": f"kernel phase (bf16, int8, fp32 at the 8B "
                          f"shapes) and the {path} serving path",
            "row_errors": {r["case"]: r["err"] for r in record["kernels"]
                           if r["name"] == name}})
    flash_source = "paddle_tpu_torch/csrc/flash_attention.cu"
    flash_tpu = "paddle_tpu/ops/pallas/flash_attention.py"
    for name, replaces in (("flash_attention_fwd", f"{flash_tpu}:471"),
                           ("flash_attention_bwd", f"{flash_tpu}:592")):
        bf16 = next(r for r in record["flash_kernels"]
                    if r["name"] == name and r["case"] == "bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": flash_source,
            "replaces": replaces,
            "launches": record["train"]["launches"][name],
            "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
            "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "checked_by": "kernel phase (bf16, fp32 at the bench.py "
                          "attention shape) and the training path",
            "row_errors": {r["case"]: r["err"]
                           for r in record["flash_kernels"]
                           if r["name"] == name}})
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
