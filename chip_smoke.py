#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit; the kernels' build from csrc/, with
   each kernel's registers, spill bytes and static shared memory
   (``ptxas -v``) and whether its SASS holds HGMMA; the bf16 B1, B2, B5,
   B6, B7 and B8 kernels (``_build.WGMMA_KERNELS``) must;
2. every kernel launcher (flash_decode B4, paged_decode B3,
   ragged_paged_decode B3') at the Llama-3-8B attention shapes (32 q heads,
   8 kv heads, head dim 128) in bf16, int8 K/V and fp32, held against its
   plain PyTorch version on the same inputs (per-row error gate, see
   ``row_error``), and timed (the wrapper by CUDA events, and its kernels'
   device time by the profiler: each launcher is a split and a combine
   kernel, ``decode_split_kernel`` for B4, ``paged_split_kernel`` for B3
   and B3')
   beside its bandwidth bound, its plain version and, for the dense case,
   one ``scaled_dot_product_attention`` call (a yardstick the port never
   calls);
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
   versions and one ``scaled_dot_product_attention`` call (forward; for B2
   its backward alone, the forward run outside the timed window, with the
   forward+backward reading beside it; a yardstick the port never calls);
6. training at the full width and depth of the ``bench.py`` configuration
   (``TRAIN_CFG``): bf16 params, fp32 AdamW masters from the unrounded init,
   accum 64 with the bf16 carry, one warm-up and three timed steps on one
   batch.  Every attention call of the steps must be a kernel launch (no
   plain-version call), the losses finite and falling, and the bf16 kernel
   path's loss on micro-batch 0 within 2e-2 of a plain fp32 forward on the
   same weights.  Prints ms per step, tokens/s and MFU (6 N per token over
   989 TFLOP/s), and profiles two micro-steps, in which every B2 call must
   run the wgmma pair;
7. the masked flash kernels (B5 forward; B6 fused, dq and dk/dv backward)
   on MASKED_CASES: packed documents at the train shape, a causal
   document mask as FlashMask bands at 8K, every other mask class, the
   varlen padded layout, an unaligned length, rep 16 and sk != sq, in
   bf16 and fp32, each held against its plain version (per-row gate; rows
   that see no key exact) and timed beside its bound over the visible
   pairs, its plain version and ``scaled_dot_product_attention`` with the
   dense bool mask (forward; for B6 its backward alone, with the
   forward+backward beside it; a yardstick the port never calls); for
   bf16 at head dim 64/128 B5 runs ``masked_fwd_wgmma_kernel`` and B6
   ``masked_dkv_wgmma_kernel`` (fused or split) and
   ``masked_dq_wgmma_kernel``;
8. packed-document training at the ``bench.py`` width and depth
   (MASKED_ACCUM micro-batches of 6 rows of 1024 tokens, documents of
   median DOC_MEDIAN with a padding tail, ``attention_mask`` segment ids):
   every attention call a B5 + fused B6 launch, losses finite and
   falling, the step-0 bf16 loss within 2e-2 of a plain fp32 masked
   forward; step time, valid and all tokens/s, MFU, a micro-step profile
   in which every B5 call must run ``masked_fwd_wgmma_kernel`` and every
   B6 call the fused ``masked_dkv_wgmma_kernel``;
9. the long-context recipe (s 8192, b 1, accum 2, documents of median
   1024 truncated at the row end): B5 + B6 dq + dk/dv launches only (a
   profiled micro-step's B6 calls all ``masked_dq_wgmma_kernel`` +
   ``masked_dkv_wgmma_kernel``, a profiled forward's B5 calls all
   ``masked_fwd_wgmma_kernel``), and
   the causal document mask as FlashMask bands gives the segment-id
   logits within the bf16 gate;
10. the grouped-matmul kernels (B7 float, int8 and on the transposed
    bank; B8) on GMM_CASES: the Mixtral decode, unified-step and prefill
    calls on int8 banks (``gmm_int8_wgmma_kernel``, its device time by the
    profiler beside, and the same bits and times with the grid order its
    plan did not pick), the dropless train cell's three calls in bf16 and
    fp32, an empty segment, one expert, unaligned lengths, repeated weight ids;
    each held against its plain version (per-row gate) and timed beside
    its bound, its plain version and ``torch._grouped_mm`` or a loop of
    per-segment ``torch.matmul`` (a yardstick the port never calls);
11. the dropless MoE train step (``parallel/expert.py``) at Mixtral's
    expert shape: 2 B7 forward, 1 B7 dx (the first GEMM's input needs no
    gradient) and 2 B8 launches per step, no plain call, losses finite and
    falling, dropped 0, the step-0 loss within 2e-2 of a plain fp32
    forward; ms per step and TFLOP/s over the five grouped GEMMs it runs,
    and a profile of one more step;
12. Mixtral-8x7B serving at full width and depth (MIXTRAL_CFG), int8
    weight-only with random weights, on the serving phase's traffic: the
    chunked and unified engines and ``_generate_greedy``; every MoE
    projection a B7 int8 launch and every decode attention call a kernel
    launch, the chunk launches without a host sync, the fp32
    teacher-forced check on the same int8 weights beside the count of
    (token, layer) pairs whose expert choice flipped; a decode profile;
    one profiled window over a short session of each path in which every
    B7 int8 call runs ``gmm_int8_wgmma_kernel`` (none ``gmm_kernel``);
    then, on the 8B model built anew, one profiled window over a short
    session of each of the chunked and unified paths in which every paged
    decode call runs ``paged_split_kernel`` + ``decode_combine_kernel``.
    These route checks are the last profiled phase;
13. the serving extras on the same 8B model (the serving phase's weights),
    after every profiled phase: ``generate`` sampling
    (temperature 0.8, top-k 50, top-p 0.9) and beam search (4 beams) on
    two prompts, every decode attention call a B4 launch, each token within
    the reference's top-k (top num_beams); the chunked and unified engines
    with an int8 cache (B3/B3' over int8 pools, no host sync in a chunk
    launch, the reference's K/V through the engine's frozen scales);
    speculative decoding (speculative_k 3) with the full model and its first
    4 layers as self-drafts, every verify window, proposal and mirror a B3'
    launch, the full-depth draft's mean accepted length above 1; the prefix
    cache's host tier (promoted pages equal to the demoted ones); the KV
    handoff from a prefill_only engine in bf16 and int8 (the int8 scales
    unchanged); ``tune_page_size`` at the serving shape.  Tokens of every
    greedy path pass the teacher-forced check; ms per decode step beside
    the bf16 engines';
14. the optimizer family: five eager steps of each of the 15 optimizers on
    CUDA parameters in lockstep with the same steps on the CPU, fp32
    within 1e-5, every update in place;
15. the attention path for additive masks and dropout at the train cell's
    attention shape (b 6, s 1024, 16 q heads over 4 kv heads, head dim
    128) in bf16: an additive-mask call and a dropout call against fp32 on
    the CPU (the dropout reference takes the card's mask, drawn again from
    the same seed), no flash launch, the keep rate within 3 sigma;
16. the memory lattice on the train cell's model (full width and depth;
    cut: accum 2): one step per ``MEMORY_LATTICE`` point, the loss within
    2e-2 of the none/device point's, peak allocated bytes, ms per step,
    B1 once per layer and micro-step (twice under a checkpointed policy)
    and B2 once, all kernel launches; host residency must lower the peak
    by 0.8 x 12 B per parameter at none, dots and names;
17. Llama-3-8B at full width, EIGHT_B_LAYERS deep (a cut forced by the
    host memory, see EIGHT_B_LAYERS), seq 2048, batch 1, AdamW with the
    fp32 state in pinned host memory: two full-remat steps and one offload
    step on the same state; three streamed buckets recomputed on the card
    bit for bit; peak device bytes, pinned host bytes, ms per step,
    tokens/s, MFU, and the host link's pinned copy rates;
18. GPT-MoE's train step at the full width and depth of
    ``GPTMoEConfig()`` (403 M parameters; fp32 weights, bf16 compute,
    AdamW, batch 8 x seq 1024, the gates drawn from SEED): 8 B1 and 8 B2
    launches a step (exact, by the wrappers and by the profiler) and no
    other attention kernel, losses falling, the step-0 CE within 2e-2 of a
    plain fp32 forward; ms per step, tokens/s, peak device bytes, CE, aux
    and each MoE layer's dropped assignments per step, where the step's
    device time goes; then B1/B2 alone at its attention shape (MHA, head
    dim 64) against their plain versions, timed;
19. ``MoELayer(1024, 4096, 8, dropless=True)`` forward and backward on
    8192 bf16 tokens: 2 B7 forward, 2 B7 dx and 2 B8 launches, each call
    against its plain version on its own inputs and timed beside its
    bound, plain version and ``torch._grouped_mm``; the output on 2048
    tokens against the capacity path at capacity = tokens;
20. the capacity EP step (degree 1) beside the dropless one at the MoE
    train cell's shape: ms per step, the dropped share, peak bytes;
21. ``moe_ep``: NCCL at world size 1 from a FileStore; the dropless and
    the capacity EP steps at the MoE train cell on the ("dp", "sharding",
    "ep") mesh (1, 1, 1) beside ``mesh=None``, and GPT-MoE at
    ``GPTMoEConfig()`` through ``apply_gpt_moe_sharding`` +
    ``build_moe_train_step(mesh=...)`` on ("dp", "ep", "mp") = (1, 1, 1)
    beside ``mesh=None``, 1 + 3 steps each: losses equal bit for bit, the
    dropless step 2 B7 forward, 1 B7 dx and 2 B8 launches a step, the
    capacity step none, GPT-MoE 8 B1 and 8 B2, no plain call; ms per step
    and peak bytes of both;
22. ``hybrid_train``: NCCL at world size 1 from a new FileStore; the
    hybrid step (``init_hybrid_state`` + ``build_hybrid_train_step``) on
    the (pp, dp, sharding, sep, mp) mesh (1, 1, 1, 1, 1) at the train
    cell's full width and depth (the 6 rows of one micro-step, fp32
    weights, bf16 compute, AdamW) under gpipe (2 micro-batches) and 1F1B
    (3), beside ``build_train_step(mesh=None)`` on the same weights and
    rows, 1 + 3 steps each: losses within 2e-2 of the meshless step's,
    the B1/B2 launches of ``hybrid_predicted_launches`` by the wrappers
    and, per micro-batch, by the profiler, no plain call; then ring and
    Ulysses attention at sep 1 on the long-context shape (b 1, s 8192,
    16/4 heads, d 128, bf16) against ``flash_attention(causal=True)``:
    the ring one B5 and one B6 call within 2e-2, Ulysses bit for bit; ms
    per step, peak bytes and ms per attention call;
23. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
    last.

The ``mesh_train`` phase runs after phase 9 (the long-context recipe):
NCCL at world size 1 from a FileStore, the ("dp", "sharding", "mp") mesh
(1, 1, 1) on cuda, each collective of parallel/compat.py once and one raw
NCCL collective of each kind on every axis group; then the train cell
(``TRAIN_CFG`` at full width and depth; cut: accum MESH_ACCUM instead of
64) through ``apply_llama_sharding`` + ``build_train_step(mesh=...)``
beside the meshless step (the same step body on the mesh of one rank,
without a process group) on the same weights and batches (1 + 3 steps),
one masked step (accum MESH_MASKED_ACCUM) on the masked cell's packed
documents, and the mesh step again with its flat state in pinned host
memory.  It raises where a loss differs from the meshless one by more
than 2e-2 relative, where an attention call was not a kernel launch,
where the B1/B2 (B5/B6) launch counts, by the wrappers and per
micro-step by the profiler, differ from the meshless step's, or where
host residency saves less than 80 % of the 12 B per parameter of the
device-resident state at the mesh step's peak; it prints ms per step,
the losses and peak device bytes of each run.

The ``overlap_train`` phase follows on a new (1, 1, 1) NCCL mesh: the same
cell through ``build_train_step(mesh, overlap=OverlapConfig())`` beside
the same step with ``overlap=None`` (the mesh_train path of each, then
OVERLAP_TURNS timed steps of the two in turns, then one step of each under
``MemoryConfig(remat="full")``).  It raises where a loss differs from the
mesh step's by more than 2e-2 relative, where an attention call was not a
kernel launch, where the launch counts (wrappers and profiler) differ from
the mesh step's, or where a plain version was called; it prints whether
the losses are equal bit for bit, ms per step and peak bytes.  At world
size 1 every collective is a no-op: it measures no hidden communication.
The ``codec`` phase then encodes a CODEC_SHAPE fp32 payload on the card
under int8 (stochastic and round-to-nearest, the latter checksummed) and
fp8: the packed bytes must equal the CPU encode's bit for bit, each block
decode within its profile's bound, one flipped byte must poison exactly
its row and make ``verify_rows_host`` raise; encode and decode ms beside
a bytes bound.  The codec is not a TPU kernel and is not in the kernels
line.

The ``serving_fleet`` phase follows the serving extras: the 8B weights
moved to the host (a checkpoint's form) feed ``inference/fleet.py``'s
replica sets on the unified cell's engine geometry.  A fleet of 2
replicas serves FLEET_REQUESTS requests (32-300 prompt tokens, every other
one behind a 64-token system prompt, 32 new tokens) unfaulted, then with
a kill, a hang (FLEET_HANG_STALL_S against FLEET_STEP_TIMEOUT_S) and a
drain as the preemption notice; one spawn delivers int8-coded weights; a
prefill + decode fleet with an int8 cache and the host tier serves
DISAGG_REQUESTS requests through a decode-replica kill, then the first
DISAGG_REPEAT of them again, with a prefill pool small enough that prompt
pages demote to the host tier and the repeats promote them.  It raises
where a request is lost or a token repeated, where an attention call was
not a B3' launch or a plain version was called, where a topology was
planned twice, where the device does not return within one replica's
pools of its level after a reap, where the coded spawn staged other bytes
than the packed ones or a leaf differs from the CPU decode of its packed
bytes, where an int8 handoff's pages or scales differ between the two
ends, where no page was demoted or no host-tier page hit, or where a
stream fails teacher forcing; it prints each spawn's seconds and GB/s,
the recoveries, the p50/p99 of each request's gaps between its tokens
(and, apart, a tick's wall time over the tokens it produced) with and
without faults, whether each migrated stream equals the unfaulted run's,
the handoffs' bytes, the host tier's counters and peak device bytes.

Kernel times are the median of their reps (CUDA events, L2 flushed before
each rep), with the min and max beside them in the record.  Exits
non-zero, printing no result, when CUDA is not available or the package is
not beside the script.  Writes the full record to
chiprun_out/chip_smoke.json.

To compare two checkouts on one card (say, the parent commit unpacked by
``git archive`` into a gitignored directory):

    python3 chip_smoke.py --turns OTHER_ROOT --phases moe_train,gpt_moe_train

runs the named phases (``TURN_PHASES``) of OTHER_ROOT, of this checkout,
of this checkout and of OTHER_ROOT, each turn in a fresh process that
builds and imports that checkout's own package and chip_smoke.py.  Each
phase prints one ``TURN`` line (the checkout, the phase's summary, its
wall seconds and the device's peak bytes over it, allocator counters
reset before it); the records go to chiprun_out/turns.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
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
# profiled windows a check or a device-time reading may take: the profiler
# here can lose all or a few of a window's device records after a long
# unprofiled run (PERF.md §7); a lost record is no launch of another kernel
PROFILE_WINDOWS = 10
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
# B5/B6 cases: name -> (b, sq, sk, q heads, kv heads, head dim, causal,
# mask).  packed_docs is the masked train phase's attention call,
# doc_bands_8k the long-context phase's (as bands; the step itself passes
# segment ids); the others cover each mask class, the varlen qkv-packed
# padded layout (negative ids), an unaligned length, rep 16 and sk != sq.
MASKED_CASES = {
    "packed_docs": (6, 1024, 1024, 16, 4, 128, True, "segments"),
    "doc_bands_8k": (1, 8192, 8192, 16, 4, 128, True, "doc_bands"),
    "share_question": (2, 1024, 1024, 16, 4, 128, True, "share_question"),
    "sliding_causal": (2, 1024, 1024, 16, 4, 128, True, "sliding"),
    "sliding_bidirectional": (2, 1024, 1024, 16, 4, 128, False, "sliding"),
    "global_sliding": (2, 1024, 1024, 16, 4, 128, False, "global_sliding"),
    "per_head_bands": (2, 1024, 1024, 16, 4, 128, True, "per_head_bands"),
    "varlen_padded": (1, 1024, 1024, 16, 4, 128, True, "varlen_padded"),
    "unaligned": (2, 1000, 1000, 16, 4, 128, True, "segments"),
    "rep16": (2, 1024, 1024, 32, 2, 128, True, "segments"),
    "cross": (2, 512, 1536, 16, 4, 128, False, None),
    "unmasked_8k": (1, 8192, 8192, 16, 4, 128, True, None),
}
# packed documents: lognormal lengths of this median (and sigma), clipped to
# [DOC_MIN, row length]; the masked train phase pads the row's tail (id 0),
# the long-context phase truncates its last document at the row end
DOC_MEDIAN, DOC_SIGMA, DOC_MIN = 256, 0.75, 16
MASKED_ACCUM, MASKED_WARMUP, MASKED_STEPS = 16, 1, 2
LONG_SEQ, LONG_ACCUM, LONG_DOC_MEDIAN = 8192, 2, 1024


def _sync():
    import torch
    torch.cuda.synchronize()


def build_report():
    """Each kernel of the built library: registers, stack, spill bytes and
    static shared memory (ptxas -v), and whether its SASS holds HGMMA
    (cuobjdump).  Raises if a bf16 kernel that must issue wgmma (B1, B2,
    B5, B6, B7, B8) does not."""
    from paddle_tpu_torch.ops import _build
    report = _build.kernel_report()
    for name, r in sorted(report.items()):
        print(f"ptxas {name}: {r.get('registers')} registers, stack "
              f"{r.get('stack')} B, spill stores/loads "
              f"{r.get('spill_stores')}/{r.get('spill_loads')} B, static "
              f"smem {r.get('smem')} B, HGMMA {'yes' if r['hgmma'] else 'no'}",
              flush=True)
    for kernel in _build.WGMMA_KERNELS:
        found = [n for n in report if kernel in n]
        if not found or not all(report[n]["hgmma"] for n in found):
            raise AssertionError(f"{kernel}: no HGMMA in its SASS ({found})")
    return report


def timing(fn, reps, flush):
    """(median, min, max) device milliseconds of ``fn`` over ``reps``
    launches, each after overwriting ``flush`` (larger than the 50 MB L2):
    a serving step finds each layer's K/V cold."""
    import torch
    fn()
    _sync()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def host_ms(fn, calls=100, reps=5):
    """(median, min, max) host milliseconds per call of ``fn`` over ``reps``
    batches of ``calls`` calls, each batch started on an idle card and
    timed on the host's clock without a sync: what the wrapper costs the
    host that enqueues it (a few hundred launches never fill the queue)."""
    fn()
    _sync()
    times = []
    for _ in range(reps):
        _sync()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) * 1e3 / calls)
    _sync()
    return statistics.median(times), min(times), max(times)


def time_ms(fn, reps, flush):
    """Median device milliseconds of ``fn`` (``timing``)."""
    return timing(fn, reps, flush)[0]


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


# the CUDA kernels each decode launcher runs, as the profiler names them
DECODE_KERNELS = {"flash_decode": ("decode_split_kernel",
                                   "decode_combine_kernel"),
                  "paged_decode": ("paged_split_kernel",
                                   "decode_combine_kernel"),
                  "ragged_paged_decode": ("paged_split_kernel",
                                          "decode_combine_kernel")}


def kernel_cases(dev, flush):
    """Each launcher at the 8B attention shapes in every case; returns one
    record per (launcher, case).  ``ms``: the wrapper by CUDA events (its
    host launch time included); ``device_ms``: the profiler's device time
    per call of each of its kernels, ``kernel_ms`` their sum; ``host_ms``:
    the wrapper's host time per call (``host_ms``)."""
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
            ms, lo, hi = timing(lambda: kernel(*args), 50, flush)
            # L2 flushed before each call, as for the events
            device = _device_ms(lambda: (flush.zero_(), kernel(*args)), 10,
                                DECODE_KERNELS[name])
            host = host_ms(lambda: kernel(*args))
            records.append(dict(
                name=name, case=case, shape=inp["shape"], err=err, tol=tol,
                max_abs_err=abs_err, ms=ms, ms_min=lo, ms_max=hi,
                device_ms=device, kernel_ms=sum(device.values()),
                host_ms=host[0], host_ms_min=host[1], host_ms_max=host[2],
                plain_ms=time_ms(lambda: plain(*args), plain_reps[name],
                                 flush),
                bound_ms=bms, bound_by=by, library_ms=library,
                library_call=call))
        del inp, args, got, want
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ serving phase

def _f32(params, name):
    """fp32 copy of a weight, dequantized when it rides with an int8
    ``._scale`` (per output channel, the last axis)."""
    w = params[name].float()
    sc = params.get(name + "._scale")
    return w if sc is None else w * sc.float()[..., None, :]


def _moe_reference(cfg, params, i, hx, forced=None):
    """fp32 top-k expert FFN of MoE layer ``i`` on hx [n, S, h]: softmax of
    the fp32 router logits, top-k (or the expert ids ``forced`` [n*S, k]),
    weights renormalised over the chosen k, each expert's SwiGLU on its
    tokens with its dequantized slices.  Returns (y, chosen ids)."""
    import torch
    import torch.nn.functional as F
    n, S, h = hx.shape
    x2 = hx.reshape(-1, h)
    probs = (x2 @ params[f"model.layers.{i}.mlp.router.weight"].float()
             ).softmax(-1)
    ids = probs.topk(cfg.moe_top_k, dim=-1).indices if forced is None \
        else forced
    top_p = probs.gather(1, ids)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x2)
    pre = f"model.layers.{i}.mlp.experts."

    def slice_f32(proj, e):
        w = params[pre + proj + ".weight"][e].float()
        sc = params.get(pre + proj + ".weight._scale")
        return w if sc is None else w * sc[e].float()[None, :]

    for e in range(params[pre + "gate_proj.weight"].shape[0]):
        rows, slot = (ids == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x2[rows]
        out = (F.silu(xe @ slice_f32("gate_proj", e))
               * (xe @ slice_f32("up_proj", e))) @ slice_f32("down_proj", e)
        y.index_add_(0, rows, out * top_p[rows, slot][:, None])
    return y.view(n, S, h), ids


def _fake_quant(x, q, dq):
    """x [n, S, kvh, d] through the int8 cache's frozen per-kv-head scales
    in fp32: quantized (round half away from zero, clamped to +-127), then
    dequantized."""
    y = x * q[None, None, :, None]
    y = (y.sign() * (y.abs() + 0.5).floor()).clamp(-127, 127)
    return y * dq[None, None, :, None]


def _reference_hidden(cfg, params, seqs, dev, seg=None, forced=None,
                      choices=None, kv_scales=None):
    """Plain fp32 full-sequence forward (independent of the port's code):
    each weight is cast to fp32 (int8 weights dequantized) at its use, so
    the fp32 copies of the model never coexist.  Sequences are
    right-padded; causal attention keeps the padding out of every real
    position.  ``seg`` ([n, S] segment ids) also keeps each position's
    attention within its segment.  A sparse checkpoint's MoE layers take
    ``_moe_reference`` (with ``forced[i]`` expert ids when given; each
    layer's chosen ids are appended to ``choices``).  ``kv_scales`` (an
    int8 engine's frozen scales) passes every K/V through them
    (``_fake_quant``), as the engine's cache holds them."""
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

    causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[None]
    if seg is not None:
        causal = causal & (seg[:, :, None] == seg[:, None, :])
    x = params["model.embed_tokens.weight"][ids].float()
    emb_scale = params.get("model.embed_tokens.weight._scale")
    if emb_scale is not None:
        x = x * emb_scale.float()[ids][..., None]
    for i in range(cfg.num_hidden_layers):
        def W(name):
            return _f32(params, f"model.layers.{i}.{name}")
        hx = rms(x, W("input_layernorm.weight"))
        q = rope((hx @ W("self_attn.q_proj.weight")).view(n, S, H, d))
        k = rope((hx @ W("self_attn.k_proj.weight")).view(n, S, KV, d))
        v = (hx @ W("self_attn.v_proj.weight")).view(n, S, KV, d)
        if kv_scales is not None:
            k = _fake_quant(k, kv_scales["kq"][i], kv_scales["kdq"][i])
            v = _fake_quant(v, kv_scales["vq"][i], kv_scales["vdq"][i])
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        att = torch.einsum("bshd,bthd->bhst", q, k) * d ** -0.5
        att = att.masked_fill(~causal[:, None], float("-inf")).softmax(-1)
        o = torch.einsum("bhst,bthd->bshd", att, v).reshape(n, S, H * d)
        x = x + o @ W("self_attn.o_proj.weight")
        hx = rms(x, W("post_attention_layernorm.weight"))
        if f"model.layers.{i}.mlp.router.weight" in params:
            y, chosen = _moe_reference(cfg, params, i, hx, None
                                       if forced is None else forced[i])
            if choices is not None:
                choices.append(chosen)
            x = x + y
            continue
        x = x + (torch.nn.functional.silu(hx @ W("mlp.gate_proj.weight"))
                 * (hx @ W("mlp.up_proj.weight"))) @ W("mlp.down_proj.weight")
    return rms(x, params["model.norm.weight"])


def teacher_forced(cfg, params, prompts, outputs, dev, forced=None,
                   choices=None, kv_scales=None, top=1):
    """For every emitted token, its fp32 reference logit (teacher-forced on
    prompt + emitted tokens) must be within EPS_STD reference standard
    deviations of the reference row's max, or with ``top`` > 1 of its
    top-th largest logit (a token sampled from the top-k, a beam's token:
    each is among its parent row's top num_beams).  Returns the
    statistics.  ``forced``/``choices``: the MoE layers' expert ids;
    ``kv_scales``: an int8 cache's scales (``_reference_hidden``)."""
    import numpy as np
    import torch

    seqs = [np.concatenate([p, o[:-1]]) for p, o in zip(prompts, outputs)]
    with torch.no_grad():
        x = _reference_hidden(cfg, params, seqs, dev, forced=forced,
                              choices=choices, kv_scales=kv_scales)
        head = _f32(params, "lm_head.weight")
        worst, exact, total = 0.0, 0, 0
        for i, (p, o) in enumerate(zip(prompts, outputs)):
            rows = x[i, len(p) - 1:len(p) - 1 + len(o)] @ head   # [n, V]
            toks = torch.from_numpy(np.asarray(o, np.int64)).to(dev)
            arg = rows.argmax(-1)
            kth = rows.topk(top, dim=-1).values[:, -1]
            gap = (kth - rows.gather(1, toks[:, None])[:, 0]) / rows.std(-1)
            worst = max(worst, gap.max().item())
            exact += int((arg == toks).sum())
            total += len(o)
        del head
    torch.cuda.empty_cache()
    if worst > EPS_STD:
        raise AssertionError(
            f"teacher-forced check: an emitted token's reference logit is "
            f"{worst:.4f} reference std below the top-{top} logit (limit "
            f"{EPS_STD})")
    return {"worst_gap_std": worst, "argmax_agree": exact / total,
            "tokens_checked": total, "top": top}


def serve_chunked(cfg, params, prompts, dev, out=None, **engine_kw):
    """The chunked engine on ``prompts`` (32 new tokens each); ``out``
    receives the engine's int8 scales (None for a float cache)."""
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=1025,
                                   page_size=16, max_seq_len=2048,
                                   decode_chunk_steps=8, device=dev,
                                   **engine_kw)
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
    if out is not None:
        out["kv_scales"] = eng.kv_scales
    _check_pools("chunked path", eng, engine_kw)
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


def serve_unified(cfg, params, prompts, dev, out=None, **engine_kw):
    """The unified engine with the prefix cache on ``prompts`` (the last
    one arrives once the one before it produced its first token); ``out``
    receives the engine's int8 scales (None for a float cache)."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=1025,
                                   page_size=16, max_seq_len=2048,
                                   prefill_token_budget=256,
                                   enable_prefix_cache=True, device=dev,
                                   **engine_kw)
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
    if out is not None:
        out["kv_scales"] = eng.kv_scales
    _check_pools("unified path", eng, engine_kw)
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


def _check_pools(what, eng, engine_kw):
    """An engine asked for an int8 cache holds int8 pools, calibrated."""
    import torch
    if engine_kw.get("cache_dtype") == torch.int8 and (
            eng.kv_scales is None
            or any(p.dtype != torch.int8 for p in eng.k_pages + eng.v_pages)):
        raise AssertionError(f"{what}: int8 cache not in place")


def serve_generate(cfg, model, prompt, dev, generate=None):
    """``model.generate`` on one prompt, or ``generate(ids [1, S])`` (the
    full [1, S + 32] sequence) when given."""
    import torch
    from paddle_tpu_torch.ops import decode_attention as da

    da.reset_launches()
    t0 = time.perf_counter()
    out = (model.generate(prompt[None], max_new_tokens=32) if generate is None
           else generate(prompt[None]))
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


# ------------------------------------------------------ serving extras phase

def generate_extras(cfg, model, params, prompts, dev, **kw):
    """``model.generate`` on the [2, S] ``prompts`` with ``kw`` (sampling
    or beam search), 32 new tokens: every decode attention call a B4
    launch (b x num_beams rows for beams), ms per decode step as the
    difference to a 2-token call over 30 steps, each token within the
    reference's top-k (sampling: the filter's k; beams: num_beams)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import decode_attention as da

    ids = np.stack(prompts)

    def call(n):
        _sync()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=n, **kw)
        _sync()
        return out, time.perf_counter() - t0

    call(2)
    _, short = call(2)
    da.reset_launches()
    out, wall = call(32)
    counts = dict(da.LAUNCHES)
    want = 31 * cfg.num_hidden_layers
    if counts["flash_decode"] != want or counts["paged_decode"] \
            or counts["ragged_paged_decode"]:
        raise AssertionError(f"generate {kw}: {counts}, expected {want} "
                             f"flash_decode launches")
    toks = out[:, ids.shape[1]:].cpu().numpy()
    if toks.shape != (2, 32):
        raise AssertionError(f"generate {kw}: bad output {toks.shape}")
    top = kw.get("num_beams", kw.get("top_k", 1))
    return dict(
        kwargs=kw, rows=2 * kw.get("num_beams", 1), launches=counts,
        wall_s=wall, ms_per_decode_step=(wall - short) / 30 * 1e3,
        teacher_forced=teacher_forced(cfg, params, list(ids), list(toks),
                                      dev, top=top))


def _counted(eng, name):
    """Count the calls of engine method ``name``."""
    calls = {"n": 0}
    fn = getattr(eng, name)

    def counted(*a, **k):
        calls["n"] += 1
        return fn(*a, **k)
    setattr(eng, name, counted)
    return calls


def _drive_unified(eng, requests):
    """Run ``requests`` [(prompt, kwargs)] through a unified engine to its
    end; returns {rid: tokens}, its step walls and tokens per step."""
    for prompt, kw in requests:
        eng.add_request(prompt, **kw)
    steps = []
    while eng.queue or eng.active.any():
        t0 = time.perf_counter()
        produced = eng.step()
        steps.append((time.perf_counter() - t0,
                      int(eng.last_report["seq_lens_encoder"].sum()),
                      produced))
    _sync()
    return {f.rid: f.tokens for f in eng.finished}, steps


def _decode_ms(steps):
    """Median wall ms of the steps that prefilled nothing and emitted, and
    the median tokens such a step emitted."""
    dec = [(w, p) for w, enc, p in steps if enc == 0 and p > 0]
    if not dec:
        return None, None
    return (statistics.median(w for w, _ in dec) * 1e3,
            statistics.median(p for _, p in dec))


def _check_ragged(what, counts, want):
    if counts["ragged_paged_decode"] != want or want == 0 or \
            counts["flash_decode"] or counts["paged_decode"]:
        raise AssertionError(f"{what}: {counts}, expected {want} ragged "
                             f"launches and no other")


def serve_speculative(cfg, params, prompts, dev, draft_layers):
    """The unified engine with a self-draft of ``draft_layers`` layers,
    speculative_k 3, two greedy and two sampled requests of 32 tokens:
    every target step, proposal and mirror a ragged launch per layer, the
    greedy tokens teacher-forced."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.generation import self_draft_params
    from paddle_tpu_torch.ops import decode_attention as da

    dcfg, dparams = self_draft_params(cfg, params, draft_layers)
    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=1025,
                                   page_size=16, max_seq_len=2048,
                                   prefill_token_budget=256, draft_cfg=dcfg,
                                   draft_params=dparams, speculative_k=3,
                                   device=dev)
    target = _counted(eng, "_unified_step")
    draft = _counted(eng, "_draft_launch")
    greedy = [prompts[0], prompts[2]]
    sampled = [prompts[1], prompts[3]]
    reqs = [(p, dict(max_new_tokens=32)) for p in greedy] + \
        [(p, dict(max_new_tokens=32, temperature=0.8, seed=SEED + i))
         for i, p in enumerate(sampled)]
    da.reset_launches()
    t0 = time.perf_counter()
    out, steps = _drive_unified(eng, reqs)
    wall = time.perf_counter() - t0
    counts = dict(da.LAUNCHES)
    stats = eng.serving_stats()
    eng.shutdown()
    want = target["n"] * cfg.num_hidden_layers \
        + draft["n"] * dcfg.num_hidden_layers
    _check_ragged(f"speculative (draft {draft_layers})", counts, want)
    if sorted(len(t) for t in out.values()) != [32] * 4:
        raise AssertionError("speculative: not every request finished")
    ms, per_step = _decode_ms(steps)
    tokens = sum(len(t) for t in out.values())
    return dict(
        draft_layers=draft_layers, speculative_k=3, launches=counts,
        target_steps=target["n"], draft_launches=draft["n"],
        mean_accepted_len=stats.get("mean_accepted_len"),
        windows=len(stats["accepted_lengths"]), wall_s=wall,
        tokens_per_s=tokens / wall, ms_per_decode_step=ms,
        tokens_per_decode_step=per_step,
        teacher_forced=teacher_forced(cfg, params, greedy,
                                      [out[0], out[1]], dev))


def serve_host_tier(cfg, params, system, prompts, dev):
    """The unified engine with a prefix cache of a 4-page host tier over a
    24-page pool: a 104-token prompt (its 64-token system prefix first)
    commits 6 pages, a 352-token one demotes all 6 and the tier drops its
    2 deepest, a second sharer of the system prompt promotes the 4 prefix
    pages and hits 64 tokens.  Every promoted page is ``torch.equal`` to
    the page that was demoted; every call a ragged launch; the tokens
    teacher-forced."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=25,
                                   page_size=16, max_seq_len=2048,
                                   prefill_token_budget=256,
                                   enable_prefix_cache=True,
                                   host_tier_pages=4, device=dev)
    steps = _counted(eng, "_unified_step")
    pc = eng.prefix_cache
    demoted, checks = {}, []
    demote, promote = pc.demote_fn, pc.promote_fn

    def page_kv(page):
        return (torch.stack([p[page] for p in eng.k_pages]),
                torch.stack([p[page] for p in eng.v_pages]))

    def demote_fn(page):
        snap = page_kv(page)
        host = demote(page)
        demoted[id(host)] = snap
        return host

    def promote_fn(host):
        page = promote(host)
        if page is not None:
            checks.append(all(torch.equal(a, b) for a, b in
                              zip(page_kv(page), demoted.pop(id(host)))))
        return page

    pc.demote_fn, pc.promote_fn = demote_fn, promote_fn
    a = np.concatenate([system, prompts[2][:40]])
    c = np.concatenate([system, prompts[1][:40]])
    b = prompts[5][:300]
    b = np.concatenate([b, prompts[4][:352 - len(b)]])
    da.reset_launches()
    outs, stats = [], []
    for p in (a, b, c):
        out, _ = _drive_unified(eng, [(p, dict(max_new_tokens=32))])
        outs.append(out[max(out)])
        stats.append(dict(pc.stats()))
    counts = dict(da.LAUNCHES)
    warm = eng.serving_stats()["prefill"][2]
    eng.shutdown()
    _check_ragged("host tier", counts, steps["n"] * cfg.num_hidden_layers)
    st = stats[-1]
    if st["demoted_pages"] < 4 or st["promoted_pages"] < 4 \
            or st["host_hits"] < 1 or warm["cached_tokens"] != 64:
        raise AssertionError(f"host tier: no demote/promote round trip "
                             f"{stats} {warm}")
    if not checks or not all(checks):
        raise AssertionError(f"host tier: promoted pages differ from the "
                             f"demoted ones {checks}")
    return dict(launches=counts, unified_steps=steps["n"],
                prefix_cache=stats, warm_request=warm,
                promoted_pages_equal=len(checks),
                teacher_forced=teacher_forced(cfg, params, [a, b, c], outs,
                                              dev))


def serve_handoff(cfg, params, prompts, dev, cache_dtype):
    """A prefill_only engine hands a greedy and a sampled request to a
    decode engine through ``export_handoff``/``adopt_request``: every
    call of both a ragged launch, an int8 handoff's pages int8 and its
    scales the same on both sides, the greedy stream teacher-forced."""
    import numpy as np
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    kw = dict(max_slots=8, num_pages=1025, page_size=16, max_seq_len=2048,
              prefill_token_budget=256, cache_dtype=cache_dtype, device=dev)
    pre = ContinuousBatchingEngine(cfg, params, prefill_only=True, **kw)
    pre_steps = _counted(pre, "_unified_step")
    reqs = [(prompts[2], dict(max_new_tokens=32)),
            (prompts[3], dict(max_new_tokens=32, temperature=0.8,
                              seed=SEED))]
    da.reset_launches()
    for prompt, rkw in reqs:
        pre.add_request(prompt, **rkw)
    while len(pre.handoff_ready) < len(reqs):
        pre.step()
    payloads = []
    for slot in sorted(pre.handoff_ready, key=lambda s:
                       pre.handoff_ready[s]["rid"]):
        payloads.append(pre.export_handoff(slot))
        pre.release_handoff(slot)
    pre_counts = dict(da.LAUNCHES)
    scales = pre.kv_scales
    pre.shutdown()
    del pre
    _check_ragged("handoff prefill", pre_counts,
                  pre_steps["n"] * cfg.num_hidden_layers)
    dec = ContinuousBatchingEngine(cfg, params, **kw)
    dec_steps = _counted(dec, "_unified_step")
    da.reset_launches()
    rids = [dec.adopt_request(tree, meta, 32) for tree, meta in payloads]
    out, steps = _drive_unified(dec, [])
    dec_counts = dict(da.LAUNCHES)
    _check_ragged("handoff decode", dec_counts,
                  dec_steps["n"] * cfg.num_hidden_layers)
    meta = payloads[0][1]
    if scales is not None:
        if payloads[0][0]["k"].dtype != np.int8 or any(
                not np.array_equal(meta["kv_scales"][k],
                                   dec.kv_scales[k].cpu().numpy())
                or not np.array_equal(meta["kv_scales"][k],
                                      scales[k].cpu().numpy())
                for k in scales):
            raise AssertionError("handoff: int8 pages or scales changed")
    kv_scales = dec.kv_scales
    dec.shutdown()
    if sorted(len(out[r]) for r in rids) != [32, 32] or \
            payloads[1][1]["rng_state"] is None:
        raise AssertionError("handoff: not every request finished")
    ms, _ = _decode_ms(steps)
    return dict(
        cache_dtype=meta["cache_dtype"], prefill_launches=pre_counts,
        decode_launches=dec_counts, prefill_steps=pre_steps["n"],
        decode_steps=dec_steps["n"], ms_per_decode_step=ms,
        payload_mb=sum(t[k].nbytes for t, _ in payloads
                       for k in ("k", "v")) / 1e6,
        teacher_forced=teacher_forced(cfg, params, [prompts[2]],
                                      [out[rids[0]]], dev,
                                      kv_scales=kv_scales))


def serving_extras(cfg, model, params, prompts, shared, system, dev):
    """The serving extras at the serving phase's shape and weights: the
    sampling and beam-search ``generate`` (B4), the chunked and unified
    engines with an int8 cache (B3/B3' over int8 pools, the reference
    through the engine's frozen scales), speculative decoding with the
    full model and a 4-layer cut as self-drafts, the prefix cache's host
    tier, the KV handoff in bf16 and int8, and ``tune_page_size``.  The
    launch counts are set to 0 before each path and read after it."""
    import torch
    from paddle_tpu_torch.inference import serving as sv

    rec = {}
    pair = [prompts[2], prompts[4][:128]]
    rec["sampling"] = generate_extras(cfg, model, params, pair, dev,
                                      do_sample=True, temperature=0.8,
                                      top_k=50, top_p=0.9, seed=SEED)
    print("serving extras sampling: " + json.dumps(rec["sampling"]),
          flush=True)
    rec["beams"] = generate_extras(cfg, model, params, pair, dev,
                                   num_beams=4)
    print("serving extras beams: " + json.dumps(rec["beams"]), flush=True)

    got = {}
    done, rec["chunked_int8"] = serve_chunked(cfg, params, prompts, dev,
                                              out=got, cache_dtype=torch.int8)
    rec["chunked_int8"]["teacher_forced"] = teacher_forced(
        cfg, params, prompts, [f.tokens for f in done], dev,
        kv_scales=got["kv_scales"])
    print("serving extras chunked int8: " + json.dumps(rec["chunked_int8"]),
          flush=True)
    done, rec["unified_int8"] = serve_unified(cfg, params, shared, dev,
                                              out=got, cache_dtype=torch.int8)
    by_rid = {f.rid: f.tokens for f in done}
    rec["unified_int8"]["teacher_forced"] = teacher_forced(
        cfg, params, shared, [by_rid[r] for r in sorted(by_rid)], dev,
        kv_scales=got["kv_scales"])
    print("serving extras unified int8: " + json.dumps(rec["unified_int8"]),
          flush=True)

    for layers in (cfg.num_hidden_layers, 4):
        key = f"speculative_self{layers}"
        rec[key] = serve_speculative(cfg, params, prompts, dev, layers)
        print(f"serving extras {key}: " + json.dumps(rec[key]), flush=True)
    full = rec[f"speculative_self{cfg.num_hidden_layers}"]
    if not full["mean_accepted_len"] or full["mean_accepted_len"] <= 1:
        raise AssertionError(f"speculative decoding with the full model as "
                             f"its draft: mean accepted length "
                             f"{full['mean_accepted_len']}")

    rec["host_tier"] = serve_host_tier(cfg, params, system, prompts, dev)
    print("serving extras host tier: " + json.dumps(rec["host_tier"]),
          flush=True)
    for name, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        rec[f"handoff_{name}"] = serve_handoff(cfg, params, prompts, dev, dt)
        print(f"serving extras handoff {name}: "
              + json.dumps(rec[f"handoff_{name}"]), flush=True)

    kvh, d = cfg.num_key_value_heads, cfg.head_dim
    page = sv.tune_page_size(8, kvh, d, 2048, device=dev)
    key = ("paged_page_size", 8, kvh, d, 2048, str(torch.bfloat16))
    rec["tune_page_size"] = {"shape": [8, kvh, d, 2048], "page": page,
                             "ms": {str(p): t for p, t in
                                    sv.PAGE_SIZE_TIMES[key].items()}}
    print("serving extras tune_page_size: "
          + json.dumps(rec["tune_page_size"]), flush=True)
    return rec


def profile_decode(cfg, params, dev, chunks, classes=None):
    """Where a steady decode step of the chunked engine spends its time:
    8 requests of 300 prompt tokens decode together while
    ``torch.profiler`` records ``chunks`` decode chunks (CPU and CUDA
    activities).  Returns wall and device milliseconds per decode step,
    the device's idle share, the host's time to enqueue a chunk without the
    profiler and the device kernels that take most time; with ``classes``
    ({class: [name substrings]}) also device ms per step of each class
    ("other": the rest)."""
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
    by_class = None
    if classes:
        by_class = dict.fromkeys(list(classes) + ["other"], 0.0)
        for e in events:
            name = next((c for c, subs in classes.items()
                         if any(t in e.key for t in subs)), "other")
            by_class[name] += e.self_device_time_total / 1e3 / steps
    return {
        "slots": 8, "prompt_tokens": 300, "profiled_steps": steps,
        **({"device_ms_per_step_by_class": by_class} if by_class else {}),
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e3 / wall_ms,
        "enqueue_ms_per_step_unprofiled": enqueue_ms / eng.chunk,
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_step": e.self_device_time_total / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top]}


def route_profile(what, run, launches, keys, kernels, absent=()):
    """``run()`` inside one ``torch.profiler`` window (device activity
    only): every one of the wrapper launches counted under ``keys`` while
    it runs must have run each CUDA kernel whose name contains an entry of
    ``kernels`` (as many launches each) and none of ``absent``.  The
    profiler can drop a window's records, so a window that did not record
    every launch is profiled again, up to PROFILE_WINDOWS.  Returns
    {kernel: launches}
    with the wrappers' launches in the window and the windows profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for used in range(1, PROFILE_WINDOWS + 1):
        before = {k: launches[k] for k in keys}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            _sync()
        window = {k: launches[k] - before[k] for k in keys}
        n = sum(window.values())
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        got = {k: sum(e.count for e in events if k in e.key)
               for k in (*kernels, *absent)}
        if all(got[k] == n for k in kernels):
            break
    if n == 0 or any(got[k] != n for k in kernels) or \
            any(got[k] for k in absent):
        raise AssertionError(f"{what}: {n} launches of {list(keys)} ran "
                             f"{got} (expected {list(kernels)} each, none "
                             f"of {list(absent)})")
    return dict(got, wrapper_launches=window, windows=used)


def short_session(cfg, params, dev, unified):
    """A short session of one engine path (two prompts of 40 and 90
    tokens, 9 new tokens each; unified: a 64-token prefill budget), run to
    its end: the calls a route check profiles."""
    import numpy as np
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    kw = (dict(prefill_token_budget=64, enable_prefix_cache=True) if unified
          else dict(decode_chunk_steps=8))
    eng = ContinuousBatchingEngine(cfg, params, max_slots=8, num_pages=1025,
                                   page_size=16, max_seq_len=2048,
                                   device=dev, **kw)
    rng = np.random.default_rng(SEED + 5)
    for n in (40, 90):
        eng.add_request(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=9)
    eng.run()
    eng.shutdown()


def paged_routes(cfg, params, dev):
    """Every paged decode call of a short chunked and a short unified
    session of the 8B serving model (built anew from SEED, as the serving
    phase builds it) on the paged split and combine kernels, one profiled
    window per path."""
    from paddle_tpu_torch.ops import decode_attention as da
    return {path: route_profile(
        f"8B paged route ({path})",
        lambda: short_session(cfg, params, dev, path == "unified"),
        da.LAUNCHES, ("paged_decode", "ragged_paged_decode"),
        DECODE_KERNELS["paged_decode"]) for path in ("chunked", "unified")}


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


def flash_cases(dev, flush, shape=FLASH_SHAPE, kinds=("bf16", "fp32")):
    """B1 and B2 at ``shape`` (default FLASH_SHAPE) in ``kinds``: gated
    against the plain
    versions (the backward from the plain forward's o and lse), timed beside
    bound, plain and one SDPA call: the forward for B1; for B2 SDPA's
    backward alone (``torch.autograd.grad`` on a forward graph built
    outside the timed window and kept), with its forward+backward reading
    as a second field.  ``split_ms``: the profiler's device ms of each of
    the wrapper's kernels (B2: dk/dv, then dq; the rest of the wrapper is
    the PyTorch delta = rowsum(do * o) before them and its host time), or
    None when the profiler recorded none of them (not measured)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    b, s, h, kvh, d = shape
    scale = d ** -0.5
    records = []
    for kind in kinds:
        q, k, v, do = flash_inputs(kind, dev, shape)
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

        out = sdpa(*leaves)

        def sdpa_bwd():
            torch.autograd.grad(out, leaves, do4, retain_graph=True)

        reps, plain_reps = (20, 3) if kind == "bf16" else (5, 2)
        layout = f"q[{b * kvh},{h // kvh},{s},{d}] kv[{b * kvh},{s},{d}]"
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
                 sdpa_bwd, bwd_bytes, 2.5 * ops, berr, babs)):
            bms, by = bound(nbytes, flops, kind)
            ms, lo, hi = timing(kernel, reps, flush)
            bwd = name.endswith("bwd")
            try:
                split = _device_ms(kernel, 3, ("hb_dkv", "hb_dq") if bwd
                                   else ("hb_fwd",))
            except AssertionError:
                # a reading, not a gate: the profiler here can record no
                # kernel of a window after long unprofiled work (PERF.md
                # §7); the gates and the CUDA-event times above stand
                split = None
            records.append(dict(
                name=name, case=kind, shape=layout, err=errs,
                tol={n: FLASH_ROW_TOL[kind][n] for n in errs},
                max_abs_err=worst, ms=ms, ms_min=lo, ms_max=hi,
                plain_ms=time_ms(plain, plain_reps, flush),
                bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9,
                library_ms=time_ms(lib, reps, flush),
                library_call=("F.scaled_dot_product_attention(is_causal, "
                              "enable_gqa)" + (" backward alone" if bwd
                                               else "")),
                library_fwd_bwd_ms=(time_ms(sdpa_fwd_bwd, reps, flush)
                                    if bwd else None),
                split_ms=split))
        del q, k, v, do, wo, wlse, q4, k4, v4, do4, leaves, out
        torch.cuda.empty_cache()
    return records


# ----------------------------------------------------- masked kernel phase

def packed_documents(rng, rows, seq, median, pad):
    """[rows, seq] int32 segment ids of whole documents (1-based per row)
    and each row's document lengths, drawn lognormal (median ``median``,
    sigma DOC_SIGMA) and clipped to [DOC_MIN, seq].  ``pad``: a document
    that does not fit ends the row and the tail is padding (id 0); else the
    last document is truncated at the row end."""
    import numpy as np
    ids = np.zeros((rows, seq), np.int32)
    lens = []
    for r in range(rows):
        pos, row = 0, []
        while pos < seq:
            n = int(np.clip(rng.lognormal(np.log(median), DOC_SIGMA),
                            DOC_MIN, seq))
            if pos + n > seq:
                if pad:
                    break
                n = seq - pos
            row.append(n)
            ids[r, pos:pos + n] = len(row)
            pos += n
        lens.append(row)
    return ids, lens


@contextlib.contextmanager
def forced_route(route):
    """Make ``flash_backward`` take the fused (``"fused"``) or the dq + dkv
    (``"split"``) kernels whatever the shape, through the budget its
    routing rule reads."""
    from paddle_tpu_torch.ops import flash_attention as fa
    saved = fa._FUSED_BWD_VMEM_BUDGET
    fa._FUSED_BWD_VMEM_BUDGET = 1 << 62 if route == "fused" else 0
    try:
        yield
    finally:
        fa._FUSED_BWD_VMEM_BUDGET = saved


def masked_inputs(name, kind, dev):
    """Inputs of the masked launchers for MASKED_CASES[name], from SEED:
    q, do [b*h, sq, d]; k, v [b*kvh, sk, d] (N(0, 1) in bf16 or fp32); the
    mask keywords of ``flash_forward``; the dense keep mask [b, mh, sq, sk]
    built from its definition (causal, equal segment ids, outside the
    bands); the visible (q head, key) pairs."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flashmask as fm

    b, sq, sk, h, kvh, d, causal, mask = MASKED_CASES[name]
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def r(*sh):
        return torch.randn(sh, generator=g, device=dev).to(dtype)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32), device=dev)

    q, k, v, do = r(b * h, sq, d), r(b * kvh, sk, d), r(b * kvh, sk, d), \
        r(b * h, sq, d)
    kw, sri = {}, None
    # every mask scales with sq; at sq 1024 the documents have median
    # DOC_MEDIAN (the masked train phase's), at 8192 LONG_DOC_MEDIAN
    if mask == "segments":
        ids, _ = packed_documents(rng, b, sq, sq // 4, pad=True)
        kw = dict(q_seg=i32(ids), k_seg=i32(ids))
    elif mask == "varlen_padded":
        # flash_attn_varlen_qkvpacked's padded layout: 4 sequences in rows
        # of sq / 4; padding gets unique negative ids, q and k sides disjoint
        smax = sq // 4
        lens = np.array([256, 100, 200, 37]) * smax // 256
        pos = np.arange(sq)
        seq_i, off = pos // smax, pos % smax
        real = off < lens[seq_i]
        kw = dict(q_seg=i32(np.where(real, seq_i + 1, -(2 * pos + 2))[None]),
                  k_seg=i32(np.where(real, seq_i + 1, -(2 * pos + 3))[None]))
    elif mask == "doc_bands":
        _, lens = packed_documents(rng, 1, sq, sq // 8, pad=False)
        sri = fm.causal_document_row_indices(lens[0])
    elif mask == "share_question":
        sri = fm.share_question_row_indices(sq // 4, (sq // 2, 3 * sq // 4),
                                            sq)
    elif mask == "sliding":
        sri = fm.sliding_window_row_indices(
            sq, sq // 8 if causal else (sq // 8, sq // 16), causal)
    elif mask == "global_sliding":
        sri = fm.global_sliding_row_indices(sq, sq // 8, n_global=sq // 32)
    elif mask == "per_head_bands":
        # the reference's random causal 2-bound mask, one per kv head
        lo = np.maximum(np.arange(sq)[None, None] + 1,
                        rng.integers(0, sq, (b, kvh, sq)))
        hi = np.maximum(lo, rng.integers(0, sq, (b, kvh, sq)))
        sri = np.stack([lo, hi], -1).astype(np.int32)
    if sri is not None:
        sri = torch.as_tensor(sri).expand((b,) + tuple(sri.shape[1:]))
        bands = tuple(x.to(dev).contiguous() for x in
                      fm.normalize_startend_row_indices(sri, causal, sq))
        kw = dict(bands=bands, mask_h=bands[0].shape[1])
    keep = torch.ones(b, 1, sq, sk, dtype=torch.bool, device=dev)
    rows = torch.arange(sq, device=dev)[:, None]
    if causal:
        keep &= rows >= torch.arange(sk, device=dev)[None, :]
    if "q_seg" in kw:
        keep &= kw["q_seg"][:, None, :, None] == kw["k_seg"][:, None, None, :]
    if "bands" in kw:
        lts, lte, uts, ute = (x[:, :, None, :] for x in kw["bands"])
        keep = keep & ~(((rows >= lts) & (rows < lte))
                        | ((rows >= uts) & (rows < ute)))
    pairs = int(keep.sum().item()) * (h // keep.shape[1])
    return dict(q=q, k=k, v=v, do=do, kw=kw, keep=keep, pairs=pairs,
                b=b, h=h, kvh=kvh, causal=causal, scale=d ** -0.5,
                shape=f"q[{b * h},{sq},{d}] kv[{b * kvh},{sk},{d}] "
                      f"h{h}/kvh{kvh} {'causal' if causal else 'full'} "
                      f"{mask or 'unmasked'}")


def masked_errors(kind, got, want, dead):
    """flash_errors for the masked kernels, with the rows that see no key
    (``dead``, [b*h, sq]: the plain lse is +1e30) held exact: o and dq 0,
    lse +1e30, on both sides; lse is gated on the other rows."""
    import torch
    if "lse" in got:
        if not torch.equal(got["lse"] >= 1e30, dead) or \
                not torch.all(got["lse"][dead] == 1e30) or \
                not torch.all(got["o"][dead] == 0):
            raise AssertionError("masked forward: rows without a key are "
                                 "not o = 0, lse = +1e30")
        got = dict(got, lse=got["lse"][~dead])
        want = dict(want, lse=want["lse"][~dead])
    elif not torch.all(got["dq"][dead] == 0):
        raise AssertionError("masked backward: dq of rows without a key "
                             "is not 0")
    return flash_errors(kind, got, want)


def masked_work(inp, kernel):
    """(bytes, flops) of one masked launcher's function on ``inp``: each
    input read once and each output written once (masks included); 2 d
    flops per visible (q head, key) pair and product: 2 products forward,
    5 fused backward, 3 for dq, 4 for dk/dv."""
    q, k = inp["q"], inp["k"]
    item = q.element_size()
    rows = 4 * q.shape[0] * q.shape[1]              # one fp32 per q row
    masks = sum(t.numel() * 4 for t in inp["kw"].get("bands", ()))
    masks += sum(inp["kw"][n].numel() * 4 for n in ("q_seg", "k_seg")
                 if n in inp["kw"])
    qn, kn = q.numel(), k.numel()
    nbytes = {"fwd": item * (2 * qn + 2 * kn) + rows,
              "fused": item * (4 * qn + 4 * kn) + rows,
              "dq": item * (3 * qn + 2 * kn) + 2 * rows,
              "dkv": item * (2 * qn + 4 * kn) + 2 * rows}[kernel] + masks
    products = {"fwd": 2, "fused": 5, "dq": 3, "dkv": 4}[kernel]
    return nbytes, 2 * q.shape[-1] * products * inp["pairs"]


def _device_ms(fn, calls, names, attempts=PROFILE_WINDOWS):
    """Device milliseconds per launch of each kernel whose name contains
    one of ``names`` (each launches once per call of ``fn``), by
    ``torch.profiler`` over ``calls`` calls: the average over the launches
    the profiler recorded.  It can drop device records, some (one H100 run
    read B1 over 3 calls at a third of its per-launch time in the train
    profile) or all of a window's (one run had none for kernels that ran
    and passed their gate), so the first name must have a record, and a
    window without one is profiled again, up to ``attempts`` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            _sync()
        total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                for n in names:
                    if n in e.key:
                        total[n] += e.self_device_time_total / 1e3
                        count[n] += e.count
        out = {n: total[n] / count[n] if count[n] else 0.0 for n in names}
        if out[names[0]]:
            return out
    raise AssertionError(f"profile: no device time for {out} in "
                         f"{attempts} windows")


# B6's (dk/dv, dq) kernel names by masked_bwd_route (the fused pass is the
# dk/dv kernel's other instantiation)
B6_KERNELS = {"wgmma": ("masked_dkv_wgmma_kernel", "masked_dq_wgmma_kernel"),
              "smem": ("masked_dkv_kernel", "masked_dq_kernel")}


def masked_case(name, kind, dev, flush):
    """B5 and the three B6 kernels on MASKED_CASES[name] in bf16 or fp32:
    each gated against its plain version (the backward from the plain
    forward's o and lse, once through each route), then timed beside its
    bound, the plain version and ``scaled_dot_product_attention`` with the
    dense bool mask (forward; for B6 its backward alone, the forward run
    outside the timed window, with the forward+backward reading beside
    it), a yardstick the port never calls.  The kernels are the ones
    ``masked_fwd_route`` and ``masked_bwd_route`` name (for bf16 at d
    64/128 ``masked_fwd_wgmma_kernel``, ``masked_dkv_wgmma_kernel`` and
    ``masked_dq_wgmma_kernel``, else ``masked_fwd_kernel``,
    ``masked_dkv_kernel`` and ``masked_dq_kernel``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    inp = masked_inputs(name, kind, dev)
    q, k, v, do, kw = inp["q"], inp["k"], inp["v"], inp["do"], inp["kw"]
    args = (inp["causal"], inp["scale"], inp["h"], inp["kvh"])
    o, lse = fa.flash_forward(q, k, v, *args, **kw)
    wo, wlse = fa.flash_forward_plain(q, k, v, *args, **kw)
    _sync()
    dead = wlse >= 1e30
    errs, worst = {}, {}
    errs["fwd"], worst["fwd"] = masked_errors(
        kind, {"o": o, "lse": lse}, {"o": wo, "lse": wlse}, dead)
    del o, lse
    want = dict(zip(("dq", "dk", "dv"),
                    fa.flash_backward_plain(q, k, v, wo, wlse, do, *args,
                                            **kw)))
    for route in ("fused", "split"):
        with forced_route(route):
            got = fa.flash_backward(q, k, v, wo, wlse, do, *args, **kw)
        _sync()
        errs[route], worst[route] = masked_errors(
            kind, dict(zip(("dq", "dk", "dv"), got)), want, dead)
        del got
    del want
    torch.cuda.empty_cache()

    # timing
    b, h, kvh = inp["b"], inp["h"], inp["kvh"]
    q4 = q.view(b, h, q.shape[1], q.shape[2])
    k4, v4 = (t.view(b, kvh, k.shape[1], k.shape[2]) for t in (k, v))
    do4 = do.view_as(q4)
    mask = inp["keep"]
    if mask.shape[1] > 1:
        mask = mask.repeat_interleave(h // kvh, dim=1)
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]

    def sdpa(*t):
        return F.scaled_dot_product_attention(*t, attn_mask=mask,
                                              scale=inp["scale"],
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(*leaves), leaves, do4)

    def library_bwd():
        try:
            out = sdpa(*leaves)
        except RuntimeError as e:          # the yardstick only
            return f"failed: {str(e)[:120]}"
        ms = library(lambda: torch.autograd.grad(out, leaves, do4,
                                                 retain_graph=True))
        del out
        return ms

    long = q.shape[1] > 4096
    reps = (5 if kind == "bf16" else 3) if not long else 2
    plain_reps = 1

    def bwd(route):
        def run():
            with forced_route(route):
                fa.flash_backward(q, k, v, wo, wlse, do, *args, **kw)
        return run

    def library(fn):
        try:
            return time_ms(fn, 2, flush)
        except RuntimeError as e:          # the yardstick only
            return f"failed: {str(e)[:120]}"

    # each kernel's own device time (the profiler), beside the wrapper's
    # (CUDA events: the live tables, delta and output buffers included)
    fwd = _device_ms(lambda: fa.flash_forward(q, k, v, *args, **kw), 2,
                     ("masked_fwd",))
    route = fa.masked_bwd_route(q.shape[2], q.dtype)
    dkv_name, dq_name = B6_KERNELS[route]
    rep = h // kvh
    tiles_kv, tiles_q = (fa.masked_bwd_wgmma_tiles(rep) if route == "wgmma"
                         else (fa.masked_tiles(rep, q.shape[2], q.dtype),) * 2)
    masks = (b, kw.get("mask_h", 1) if "bands" in kw else 1, q.shape[1],
             k.shape[1], inp["causal"], kw.get("q_seg"), kw.get("k_seg"),
             kw.get("bands"))
    fused = _device_ms(bwd("fused"), 2, (dkv_name, "cast_kernel"))
    split = _device_ms(bwd("split"), 2, (dq_name, dkv_name))
    times = {
        "fwd": fwd["masked_fwd"], "fused": sum(fused.values()),
        "dq": split[dq_name], "dkv": split[dkv_name],
        "wrapper_fwd": time_ms(lambda: fa.flash_forward(q, k, v, *args,
                                                        **kw), reps, flush),
        "wrapper_fused": time_ms(bwd("fused"), reps, flush),
        "wrapper_split": time_ms(bwd("split"), reps, flush),
        # the wrapper's own work: the route's live tables, and delta
        "tables_fused": time_ms(lambda: fa.masked_live_lists(
            tiles_kv, *masks, transposed=True, device=dev), reps, flush),
        "tables_split": time_ms(lambda: (
            fa.masked_live_lists(tiles_q, *masks, device=dev),
            fa.masked_live_lists(tiles_kv, *masks, transposed=True,
                                 device=dev)), reps, flush),
        "delta": time_ms(lambda: (do.float() * wo.float()).sum(dim=-1),
                         reps, flush),
        "plain_fwd": time_ms(lambda: fa.flash_forward_plain(q, k, v, *args,
                                                            **kw),
                             plain_reps, flush),
        "plain_bwd": time_ms(lambda: fa.flash_backward_plain(
            q, k, v, wo, wlse, do, *args, **kw), plain_reps, flush),
        "library_fwd": library(lambda: sdpa(q4, k4, v4)),
        "library_bwd": library_bwd(),
        "library_fwd_bwd": library(sdpa_fwd_bwd)}
    bounds = {}
    for kernel in ("fwd", "fused", "dq", "dkv"):
        nbytes, flops = masked_work(inp, kernel)
        bounds[kernel] = bound(nbytes, flops, kind)
    record = dict(case=name, kind=kind, shape=inp["shape"],
                  visible_pairs=inp["pairs"], dead_rows=int(dead.sum()),
                  fwd_route=fa.masked_fwd_route(q.shape[2], q.dtype),
                  bwd_kernels=fa.masked_bwd_route(q.shape[2], q.dtype),
                  route_here=fa.flash_bwd_route(q.shape[1], k.shape[1],
                                                q.shape[2]),
                  err=errs, max_abs_err=worst,
                  tol=FLASH_ROW_TOL[kind], times_ms=times,
                  bound_ms={n: t for n, (t, _) in bounds.items()},
                  bound_by={n: by for n, (_, by) in bounds.items()})
    del q, k, v, do, wo, wlse, inp, leaves, q4, k4, v4, do4, mask
    torch.cuda.empty_cache()
    return record


def masked_cases(dev, flush):
    """masked_case for every case and dtype.  A case that fails its gate is
    recorded as failed and the phase goes on, so that one run reads every
    case; main() fails the run for it after the training phases."""
    import torch
    records = []
    for name in MASKED_CASES:
        for kind in ("bf16", "fp32"):
            try:
                records.append(masked_case(name, kind, dev, flush))
            except AssertionError as e:
                records.append(dict(case=name, kind=kind, failed=str(e)))
                torch.cuda.empty_cache()
    return records


# ----------------------------------------------------------- training phase

def reference_loss(cfg, params, ids, labels, dev, seg=None):
    """CE of a plain fp32 forward (``_reference_hidden``: einsum attention,
    independent of the port's code) on the given bf16 weights, each cast to
    fp32 at its use: the mean over tokens, or with segment ids ``seg`` the
    mean over the tokens of id > 0, attention kept within a segment."""
    import torch
    with torch.no_grad():
        x = _reference_hidden(cfg, params, list(ids.cpu().numpy()), dev, seg)
        logits = x @ params["lm_head.weight"].float()
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[..., None])[..., 0]
        if seg is None:
            loss = nll.mean().item()
        else:
            w = (seg > 0).float()
            loss = ((nll * w).sum() / w.sum()).item()
    del x, logits, nll
    torch.cuda.empty_cache()
    return loss


def train_setup(dev, **overrides):
    """The TRAIN_CFG Llama (with ``overrides``) from SEED with bf16 params
    and fp32 AdamW masters from the unrounded fp32 init (master_from):
    (cfg, model, params, optimizer, flat state, parameter count)."""
    import torch
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**dict(TRAIN_CFG, **overrides))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             generator=gen)
    p32 = model.functional_state()
    params = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    opt = AdamW(learning_rate=TRAIN_LR, multi_precision=True)
    state = opt.init_flat_state(params, decay_mask=llama_decay_mask(model),
                                master_from=p32)
    del p32
    return cfg, model, params, opt, state, sum(v.numel()
                                               for v in params.values())


@contextlib.contextmanager
def plain_call_counter(module=None, names=(
        "hb_flash_forward_plain", "hb_flash_backward_plain",
        "flash_forward_plain", "flash_backward_plain")):
    """Count the calls of ``module``'s plain versions ``names`` (the flash
    kernels' by default) while the block runs; a path on the card must
    make none."""
    if module is None:
        from paddle_tpu_torch.ops import flash_attention as module
    calls = dict.fromkeys(names, 0)
    saved = {n: getattr(module, n) for n in names}

    def counted(n):
        def call(*a, **kw):
            calls[n] += 1
            return saved[n](*a, **kw)
        return call

    for n in names:
        setattr(module, n, counted(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(module, n, saved[n])


def check_launches(what, counts, plain, **want):
    """The flash LAUNCHES read after a path: exactly ``want`` (every kernel
    not named: 0), and no plain-version call."""
    full = {n: want.get(n, 0) for n in counts}
    if counts != full or any(plain.values()):
        raise AssertionError(f"{what}: launches {counts} (expected {full}), "
                             f"plain calls {plain}")


def train_steps(step, carry, n, *batch, first=0, lr=TRAIN_LR, **kw):
    """``n`` steps of ``step`` on one batch (step numbers ``first`` on, at
    ``lr``), synchronised after each, from ``carry`` = [params, state],
    which it empties so that the caller holds no second copy of the model
    and its optimizer state: (losses, wall seconds per step, params,
    state, the LAUNCHES and the plain calls of the steps)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    params, state = carry
    carry.clear()
    losses, walls = [], []
    with plain_call_counter() as plain:
        fa.reset_launches()
        for i in range(n):
            t0 = time.perf_counter()
            loss, params, state = step(params, state, first + i, lr,
                                       *batch, **kw)
            _sync()
            walls.append(time.perf_counter() - t0)
            losses.append(loss.item())
        counts = dict(fa.LAUNCHES)
    return losses, walls, params, state, counts, dict(plain)


def train_phase(dev, accum=TRAIN_ACCUM):
    """bench.py main() on the port: the TRAIN_CFG Llama with bf16 params,
    fp32 AdamW masters from the unrounded fp32 init (master_from), the bf16
    accumulation carry; the same batch every step (numpy seed SEED)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import build_train_step

    cfg, model, params, opt, state, n_params = train_setup(dev)
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
    torch.cuda.reset_peak_memory_stats()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    carry = [params, state]
    del params, state
    losses, walls, params, state, counts, plain_calls = train_steps(
        step, carry, steps, ids, labels)
    want = cfg.num_hidden_layers * accum * steps
    check_launches("train", counts, plain_calls, flash_attention_fwd=want,
                   flash_attention_bwd=want)
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
    # every B2 call of the profiled micro-steps ran the wgmma pair
    from paddle_tpu_torch.ops import flash_attention as fa

    def b2_calls(prof):
        return {n: c for n, c in prof["flash_kernel_calls"].items()
                if "hb_dkv" in n or "hb_dq" in n}

    result["profile"], result["profile_windows"] = until_counted(
        lambda: profile_train(step1, params, ids[0], labels[0]),
        lambda prof: sorted(b2_calls(prof).values()) == [
            cfg.num_hidden_layers * prof["micro_steps"]] * 2)
    want_calls = cfg.num_hidden_layers * result["profile"]["micro_steps"]
    b2 = b2_calls(result["profile"])
    if fa.bwd_route(cfg.head_dim, torch.bfloat16) != "wgmma" or \
            sorted(b2.values()) != [want_calls] * 2 or \
            not all("wgmma" in n for n in b2):
        raise AssertionError(f"train: B2 kernels {b2}, expected the wgmma "
                             f"pair {want_calls} times each")
    del model, params, state, step, step1
    torch.cuda.empty_cache()
    return result


def masked_train_phase(dev):
    """Packed-document training, the Llama 3 pre-training recipe at the
    bench.py width and depth: each row of [MASKED_ACCUM, 6, 1024] packs
    whole documents (packed_documents, median DOC_MEDIAN) with a padding
    tail; ``build_train_step(..., accum_steps=MASKED_ACCUM)`` with
    ``attention_mask=segment_ids`` runs the masked kernels (B5 forward, B6
    fused backward) and the token-weighted fp32 accumulation.  One warm-up
    and MASKED_STEPS timed steps on one batch."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import build_train_step

    cfg, model, params, opt, state, n_params = train_setup(dev)
    rng = np.random.default_rng(SEED + 1)
    shape = (MASKED_ACCUM, TRAIN_BATCH, TRAIN_SEQ)
    seg, _ = packed_documents(rng, MASKED_ACCUM * TRAIN_BATCH, TRAIN_SEQ,
                              DOC_MEDIAN, pad=True)
    seg = torch.from_numpy(seg.reshape(shape)).to(dev)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)

    step1 = build_train_step(model, opt, compute_dtype=torch.bfloat16)
    kernel_loss = step1.accumulate(params, ids[0], labels[0],
                                   attention_mask=seg[0])[0].item()
    ref_loss = reference_loss(cfg, params, ids[0], labels[0], dev, seg[0])
    rel = abs(kernel_loss - ref_loss) / abs(ref_loss)
    if not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"masked train: bf16 kernel loss {kernel_loss} "
                             f"vs fp32 plain {ref_loss}: {rel} > "
                             f"{TRAIN_LOSS_TOL}")
    torch.cuda.empty_cache()

    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=MASKED_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    steps = MASKED_WARMUP + MASKED_STEPS
    carry = [params, state]
    del params, state
    losses, walls, params, state, counts, plain_calls = train_steps(
        step, carry, steps, ids, labels, attention_mask=seg)
    want = cfg.num_hidden_layers * MASKED_ACCUM * steps
    check_launches("masked train", counts, plain_calls,
                   flash_masked_fwd=want, flash_masked_bwd_fused=want)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"masked train: losses {losses} not finite and "
                             f"falling")
    window = sum(walls[MASKED_WARMUP:])
    tokens = MASKED_ACCUM * TRAIN_BATCH * TRAIN_SEQ
    valid = int((seg > 0).sum().item())
    result = dict(
        config=TRAIN_CFG, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        accum=MASKED_ACCUM, n_params=n_params, doc_median=DOC_MEDIAN,
        documents=int(seg.amax(-1).sum().item()), valid_tokens=valid,
        tokens=tokens, losses=losses, step_s=walls,
        ms_per_step=window / MASKED_STEPS * 1e3,
        tokens_per_s=tokens * MASKED_STEPS / window,
        valid_tokens_per_s=valid * MASKED_STEPS / window,
        mfu=6 * n_params * tokens * MASKED_STEPS / window / H100_BF16_PEAK,
        launches=counts, plain_calls=plain_calls,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        step0_check=dict(kernel_bf16=kernel_loss, plain_fp32=ref_loss,
                         rel=rel, tol=TRAIN_LOSS_TOL))
    def full(prof):
        want = cfg.num_hidden_layers * prof["micro_steps"]
        calls = prof["flash_kernel_calls"]
        return all(sum(c for n, c in calls.items() if m in n) == want
                   for m in ("masked_fwd", "::masked_d"))

    result["profile"], result["profile_windows"] = until_counted(
        lambda: profile_train(step1, params, ids[0], labels[0],
                              attention_mask=seg[0]), full)
    # every B5 call of the profiled micro-steps ran the wgmma kernel
    calls = result["profile"]["flash_kernel_calls"]
    want_calls = cfg.num_hidden_layers * result["profile"]["micro_steps"]
    b5 = {n: c for n, c in calls.items() if "masked_fwd" in n}
    if sorted(b5.values()) != [want_calls] or \
            not all("masked_fwd_wgmma_kernel" in n for n in b5):
        raise AssertionError(f"masked train: B5 kernels {b5}, expected "
                             f"masked_fwd_wgmma_kernel {want_calls} times")
    # ... and every B6 call the fused wgmma pass (the dk/dv kernel's fused
    # instantiation; the dq sums' cast is not a masked_ kernel)
    b6 = {n: c for n, c in calls.items() if "::masked_d" in n}
    if sorted(b6.values()) != [want_calls] or \
            not all("masked_dkv_wgmma_kernel" in n and "true" in n
                    for n in b6):
        raise AssertionError(f"masked train: B6 kernels {b6}, expected the "
                             f"fused masked_dkv_wgmma_kernel {want_calls} "
                             f"times")
    del model, params, state, step, step1
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------- the mesh train cell

# the train cell through the mesh step: accum cut from the cell's 64 to 4
# (and 2 for the masked step) to fit the script's time
MESH_ACCUM, MESH_MASKED_ACCUM = 4, 2


def mesh_world1(dev):
    """NCCL at world size 1 from a FileStore in a temporary directory and
    the ("dp", "sharding", "mp") mesh (1, 1, 1) on cuda; each collective of
    parallel/compat.py once on a CUDA tensor (identity on size-1 axes), and
    one raw NCCL collective of each kind on every axis group (each must
    give its input back).  Returns (mesh, checks)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import compat, init_mesh

    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="mesh_"),
                                        "store"), 1)
    mesh = init_mesh("cuda", (1, 1, 1), ("dp", "sharding", "mp"),
                     store=store, rank=0, world_size=1)
    x = torch.arange(24, dtype=torch.float32, device=dev).reshape(4, 6)
    ops = {"psum": lambda a: compat.psum(a, "mp", mesh=mesh),
           "pbroadcast": lambda a: compat.pbroadcast(a, "mp", mesh=mesh),
           "all_gather": lambda a: compat.all_gather(a, "sharding", axis=1,
                                                     mesh=mesh),
           "psum_scatter": lambda a: compat.psum_scatter(a, "sharding",
                                                         mesh=mesh),
           "ppermute": lambda a: compat.ppermute(a, "mp", [(0, 0)],
                                                 mesh=mesh),
           "all_to_all": lambda a: compat.all_to_all(a, "dp", 0, 1,
                                                     tiled=True, mesh=mesh)}
    checks = {}
    for name, fn in ops.items():
        checks[name] = bool(torch.equal(fn(x), x))
    for axis in mesh.axis_names:
        g = mesh.group(axis)
        y = x.clone()
        dist.all_reduce(y, group=g)
        got = torch.empty(24, device=dev)
        dist.all_gather_into_tensor(got, x.reshape(-1), group=g)
        rs = torch.empty(24, device=dev)
        dist.reduce_scatter_tensor(rs, x.reshape(-1), group=g)
        a2a = torch.empty(24, device=dev)
        dist.all_to_all_single(a2a, x.reshape(-1), group=g)
        checks[f"nccl_{axis}"] = all(
            bool(torch.equal(t.reshape(4, 6), x)) for t in (y, got, rs, a2a))
    _sync()
    if not all(checks.values()):
        raise AssertionError(f"mesh_train: collectives {checks}")
    return mesh, checks


def mesh_setup(dev, mesh, host=False):
    """The TRAIN_CFG Llama from SEED placed on ``mesh`` (apply_llama_sharding;
    at world size 1 each block is the whole tensor): bf16 ShardedTensor
    params, fp32 masters from the unrounded init in the step's flat layout,
    on the card or (``host``) in pinned host memory (init_offloaded_state).
    (cfg, model, schedule, params, optimizer, state)."""
    import torch
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PartitionSchedule
    from paddle_tpu_torch.parallel import memory as M

    cfg = LlamaConfig(**TRAIN_CFG)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             generator=gen)
    sched = PartitionSchedule.from_model(model, mesh)
    apply_llama_sharding(model, mesh, schedule=sched)
    p32 = model.functional_state()
    params = {k: v.with_local(v.local.to(torch.bfloat16))
              for k, v in p32.items()}
    opt = AdamW(learning_rate=TRAIN_LR, multi_precision=True)
    layout = sched.flat_update_layout()
    layout = layout if layout.axes else None
    mask = llama_decay_mask(model)
    if host:
        state = M.init_offloaded_state(opt, params, decay_mask=mask,
                                       master_from=p32, flat_layout=layout)
    else:
        state = opt.init_flat_state(params, decay_mask=mask, master_from=p32,
                                    flat_layout=layout)
    del p32
    return cfg, model, sched, params, opt, state


def _mesh_run(what, dev, mesh, ids, labels, seg, host=False, overlap=None):
    """One path of the mesh_train phase (``mesh`` None: the meshless step;
    ``overlap``: the overlap_train phase's OverlapConfig):
    TRAIN_WARMUP + TRAIN_STEPS unmasked steps at MESH_ACCUM, their LAUNCHES
    and plain calls and peak device bytes; then, but for the host-resident
    state (``host``: those steps only), one masked step at
    MESH_MASKED_ACCUM, the accumulation alone (``step.accumulate``) and a
    profiled micro-step of each (B1/B2, B5/B6 launches)."""
    import torch
    from paddle_tpu_torch.models import build_train_step

    if mesh is None:
        cfg, model, params, opt, state, n_params = train_setup(dev)
        kw = {}
    else:
        cfg, model, sched, params, opt, state = mesh_setup(dev, mesh, host)
        n_params = sum(v.local.numel() for v in params.values())
        kw = {"mesh": mesh, "schedule": sched, "overlap": overlap}
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=MESH_ACCUM, **kw)
    masked = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                              accum_steps=MESH_MASKED_ACCUM, **kw)
    step1 = build_train_step(model, opt, compute_dtype=torch.bfloat16, **kw)
    torch.cuda.reset_peak_memory_stats()
    steps = TRAIN_WARMUP + TRAIN_STEPS
    carry = [params, state]
    del params, state
    losses, walls, params, state, counts, plain = train_steps(
        step, carry, steps, ids, labels)
    peak = torch.cuda.max_memory_allocated()
    if host:
        out = dict(losses=losses, step_s=walls, n_params=n_params,
                   ms_per_step=sum(walls[TRAIN_WARMUP:]) / TRAIN_STEPS * 1e3,
                   launches=counts, plain_calls=plain,
                   peak_device_bytes=peak)
        print(f"mesh_train {what}: " + json.dumps(out), flush=True)
        del model, params, state, step, masked, step1, opt
        gc.collect()
        torch.cuda.empty_cache()
        return out
    carry = [params, state]
    del params, state
    m_losses, m_walls, params, state, m_counts, m_plain = train_steps(
        masked, carry, 1, ids[:MESH_MASKED_ACCUM], labels[:MESH_MASKED_ACCUM],
        first=steps, attention_mask=seg)
    layers = cfg.num_hidden_layers
    # the step's gradient half alone (MESH_ACCUM micro-steps and their
    # carry, no update), best of two: splits ms per step into the
    # accumulation and the rest (the update and the step's own code)
    acc_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = step.accumulate(params, ids, labels)
        _sync()
        acc_ms.append((time.perf_counter() - t0) * 1e3)
        del out

    def full(prof, marks):
        calls = prof["flash_kernel_calls"]
        return all(sum(c for n, c in calls.items() if m in n)
                   == layers * prof["micro_steps"] for m in marks)

    prof, windows = until_counted(
        lambda: profile_train(step1, params, ids[0], labels[0]),
        lambda p: full(p, ("hb_fwd", "hb_dkv", "hb_dq")))
    m_prof, m_windows = until_counted(
        lambda: profile_train(step1, params, ids[0], labels[0],
                              attention_mask=seg[0]),
        lambda p: full(p, ("masked_fwd", "::masked_d")))

    def per_micro(p, marks):
        return {m: sum(c for n, c in p["flash_kernel_calls"].items()
                       if m in n) / p["micro_steps"] for m in marks}

    out = dict(
        losses=losses, step_s=walls, n_params=n_params,
        ms_per_step=sum(walls[TRAIN_WARMUP:]) / TRAIN_STEPS * 1e3,
        masked_loss=m_losses[0], masked_step_ms=m_walls[0] * 1e3,
        launches=counts, plain_calls=plain, masked_launches=m_counts,
        masked_plain_calls=m_plain, peak_device_bytes=peak,
        profiled_per_micro_step=per_micro(prof, ("hb_fwd", "hb_dkv",
                                                 "hb_dq")),
        masked_profiled_per_micro_step=per_micro(m_prof, ("masked_fwd",
                                                          "::masked_d")),
        profile_windows=[windows, m_windows],
        accumulate_ms=min(acc_ms),
        device_ms_per_micro_step=prof["device_ms_per_micro_step"],
        wall_ms_per_micro_step=prof["wall_ms_per_micro_step"])
    print(f"mesh_train {what}: " + json.dumps(out), flush=True)
    del model, params, state, step, masked, step1, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_train_phase(dev):
    """The train cell (bench.py:57-67 at full width and depth) through
    ``apply_llama_sharding`` + ``build_train_step(mesh=...)`` on a (1, 1, 1)
    NCCL mesh, beside the meshless step (``mesh=None``: the same step body
    on the mesh of one rank, no process group) on the same weights and
    batches, and the mesh step again with its flat state in pinned host
    memory; cut: accum MESH_ACCUM instead of 64 (MESH_MASKED_ACCUM for the
    masked step on the masked cell's packed documents).  Raises where a
    loss differs from the meshless one by more than TRAIN_LOSS_TOL
    relative, where an attention call was not a kernel launch, where the
    launch counts (wrappers and profiler) differ from the meshless step's,
    or where host residency saves less than HOST_SAVING_SHARE of the 12 B
    per parameter of device-resident state at the mesh step's peak."""
    import numpy as np
    import torch
    import torch.distributed as dist

    mesh, checks = mesh_world1(dev)
    try:
        rng = np.random.default_rng(SEED)
        shape = (MESH_ACCUM, TRAIN_BATCH, TRAIN_SEQ)
        ids = torch.from_numpy(rng.integers(0, TRAIN_CFG["vocab_size"],
                                            shape)).to(dev)
        labels = torch.from_numpy(rng.integers(0, TRAIN_CFG["vocab_size"],
                                               shape)).to(dev)
        seg, _ = packed_documents(np.random.default_rng(SEED + 1),
                                  MESH_MASKED_ACCUM * TRAIN_BATCH, TRAIN_SEQ,
                                  DOC_MEDIAN, pad=True)
        seg = torch.from_numpy(seg.reshape(
            (MESH_MASKED_ACCUM, TRAIN_BATCH, TRAIN_SEQ))).to(dev)
        a = _mesh_run("meshless", dev, None, ids, labels, seg)
        b = _mesh_run("mesh", dev, mesh, ids, labels, seg)
        h = _mesh_run("mesh host", dev, mesh, ids, labels, seg, host=True)
    finally:
        dist.destroy_process_group()
    ends = (0, len(a["losses"]) - 1)
    rel = {f"{what}step{i}": abs(r["losses"][i] - a["losses"][i])
           / abs(a["losses"][i])
           for what, r in (("", b), ("host_", h)) for i in ends}
    rel["masked"] = abs(b["masked_loss"] - a["masked_loss"]) \
        / abs(a["masked_loss"])
    layers = TRAIN_CFG["num_hidden_layers"]
    steps = TRAIN_WARMUP + TRAIN_STEPS
    for r in (a, b, h):
        check_launches("mesh_train", r["launches"], r["plain_calls"],
                       flash_attention_fwd=layers * MESH_ACCUM * steps,
                       flash_attention_bwd=layers * MESH_ACCUM * steps)
    for r in (a, b):
        check_launches("mesh_train masked", r["masked_launches"],
                       r["masked_plain_calls"],
                       flash_masked_fwd=layers * MESH_MASKED_ACCUM,
                       flash_masked_bwd_fused=layers * MESH_MASKED_ACCUM)
    if not all(v <= TRAIN_LOSS_TOL for v in rel.values()):
        raise AssertionError(f"mesh_train: mesh vs meshless losses {rel} > "
                             f"{TRAIN_LOSS_TOL}")
    for key in ("launches", "masked_launches", "profiled_per_micro_step",
                "masked_profiled_per_micro_step"):
        if b[key] != a[key]:
            raise AssertionError(f"mesh_train: {key} mesh {b[key]} vs "
                                 f"meshless {a[key]}")
    if h["launches"] != a["launches"]:
        raise AssertionError(f"mesh_train: launches host {h['launches']} "
                             f"vs meshless {a['launches']}")
    if not all(np.isfinite(b["losses"])) or \
            not b["losses"][-1] < b["losses"][0]:
        raise AssertionError(f"mesh_train: losses {b['losses']} not finite "
                             f"and falling")
    saved = b["peak_device_bytes"] - h["peak_device_bytes"]
    need = HOST_SAVING_SHARE * 12 * b["n_params"]
    if not saved >= need:
        raise AssertionError(f"mesh_train: host residency saved {saved} B "
                             f"of the mesh step's peak, expected >= "
                             f"{need:.0f}")
    return dict(config=TRAIN_CFG, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                accum=MESH_ACCUM, masked_accum=MESH_MASKED_ACCUM,
                reduced=[f"accum {MESH_ACCUM} instead of 64 (masked step: "
                         f"accum {MESH_MASKED_ACCUM}), to fit the script's "
                         f"time"],
                mesh=[1, 1, 1], collectives=checks, loss_rel=rel,
                tol=TRAIN_LOSS_TOL,
                ms_per_step={"meshless": a["ms_per_step"],
                             "mesh": b["ms_per_step"],
                             "mesh_host": h["ms_per_step"]},
                accumulate_ms={"meshless": a["accumulate_ms"],
                               "mesh": b["accumulate_ms"]},
                peak_device_bytes={"meshless": a["peak_device_bytes"],
                                   "mesh": b["peak_device_bytes"],
                                   "mesh_host": h["peak_device_bytes"]},
                host_peak_saving=saved, required_saving=need,
                meshless=a, mesh_step=b, mesh_host=h)


# ------------------------------------------------------- overlap_train phase

OVERLAP_TURNS = 3


def _overlap_turns(dev, mesh, ids, labels, overlap, rounds=OVERLAP_TURNS):
    """The mesh step and the overlap step, each on its own copy of the same
    weights, one step each in turn: a warm-up round, then ``rounds``
    timed ones.  ({path: [ms per step]}, {path: [losses]})."""
    import torch
    from paddle_tpu_torch.models import build_train_step

    runs = {}
    for name, oc in (("mesh", None), ("overlap", overlap)):
        cfg, model, sched, params, opt, state = mesh_setup(dev, mesh)
        runs[name] = [build_train_step(model, opt,
                                       compute_dtype=torch.bfloat16,
                                       accum_steps=MESH_ACCUM, mesh=mesh,
                                       schedule=sched, overlap=oc),
                      params, state]
        del model, params, state
    ms = {n: [] for n in runs}
    losses = {n: [] for n in runs}
    for i in range(rounds + 1):
        for name, r in runs.items():
            t0 = time.perf_counter()
            loss, r[1], r[2] = r[0](r[1], r[2], i, TRAIN_LR, ids, labels)
            _sync()
            if i:
                ms[name].append((time.perf_counter() - t0) * 1e3)
            losses[name].append(loss.item())
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return ms, losses


def _overlap_remat(dev, mesh, ids, labels, overlap):
    """One step of the mesh step and of the overlap step under
    MemoryConfig(remat="full") (the overlap layer's gathers inside the
    checkpoint): loss, ms, launches, plain calls and peak bytes of each."""
    import torch
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.parallel.memory import MemoryConfig

    out = {}
    for name, oc in (("mesh", None), ("overlap", overlap)):
        cfg, model, sched, params, opt, state = mesh_setup(dev, mesh)
        step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                                accum_steps=MESH_ACCUM, mesh=mesh,
                                schedule=sched, overlap=oc,
                                memory=MemoryConfig(remat="full"))
        torch.cuda.reset_peak_memory_stats()
        carry = [params, state]
        del params, state
        losses, walls, params, state, counts, plain = train_steps(
            step, carry, 1, ids, labels)
        out[name] = dict(loss=losses[0], ms=walls[0] * 1e3,
                         launches=counts, plain_calls=plain,
                         peak_device_bytes=torch.cuda.max_memory_allocated())
        del model, params, state, step, opt
        gc.collect()
        torch.cuda.empty_cache()
    return out


BUCKET_LEG_SHAPES = {"a.weight": (1024, 2048), "b.weight": (2048, 1024)}
BUCKET_LEG_LAYERS = 3
BUCKET_LEG_TOL = 1e-5


def overlap_bucket_leg(dev, mesh):
    """The overlap engine's bucket path on CUDA tensors, which the train
    cell at world size 1 does not reach (``sharding`` of size 1 cuts no
    leaf, so the stack plans no bucket).  A hand-made layout puts the two
    BUCKET_LEG_SHAPES leaves of each of BUCKET_LEG_LAYERS layers in one
    bucket (cut along dim 0, at sh 1); ``_pack_bucket`` ->
    ``gathered_layer_scan`` (``BucketTransport.attach``,
    ``_unpack_bucket_full``) -> backward -> ``StackGrads.wait_all`` ->
    ``_unpack_bucket_grads`` give each leaf's gradient, held with the
    input's to BUCKET_LEG_TOL relative of plain autograd on the leaves.
    Run prefetched and under remat, with the engine's transport (axis
    None: no collective) and with one whose gathers and reductions are
    asynchronous collectives (NCCL on the card) over the one-rank
    ``sharding`` group, waited through the engine's ``Pending`` and
    ``StackGrads``."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.parallel import overlap as ov
    from paddle_tpu_torch.parallel.compat import Pending, _quiet

    group = mesh.group("sharding")

    class NcclTransport(ov.BucketTransport):
        def _issue(self, fn, t, async_op):
            t = t.detach().contiguous()
            buf = torch.empty_like(t)
            p = Pending(_quiet(fn, buf, t, group=group, async_op=True), buf)
            return p if async_op else p.wait()

        def gather(self, local, async_op=False):
            return self._issue(dist.all_gather_into_tensor, local, async_op)

        def reduce(self, g, async_op=False):
            return self._issue(dist.reduce_scatter_tensor, g, async_op)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = BUCKET_LEG_SHAPES
    bucket = sorted(shapes)
    layout = {s: ov._LeafPlace(s, shp, 0, None) for s, shp in shapes.items()}
    L = BUCKET_LEG_LAYERS
    leaves = {s: [(torch.randn(shp, generator=gen, device=dev)
                   / shp[0] ** 0.5).requires_grad_() for _ in range(L)]
              for s, shp in shapes.items()}
    x0 = torch.randn(4, 256, shapes["a.weight"][0], generator=gen,
                     device=dev).requires_grad_()

    def layer_fn(lp, x):
        return x + torch.tanh(x @ lp["a.weight"]) @ lp["b.weight"]

    flat = [leaves[s][i] for i in range(L) for s in bucket]
    x = x0
    for i in range(L):
        x = layer_fn({s: leaves[s][i] for s in bucket}, x)
    want = torch.autograd.grad(x.square().mean(), flat + [x0])
    out = {}
    for name, transport in (("engine", ov.make_bucket_gather(None,
                                                             mesh=mesh)),
                            ("nccl_async", NcclTransport(None, mesh=mesh))):
        for remat in (False, True):
            sink = ov.StackGrads()
            packed = ov._pack_bucket(leaves, bucket, shapes, torch.float32)
            y = ov.gathered_layer_scan(
                layer_fn, [packed], [[] for _ in range(L)], x0, [bucket], [],
                layout, 1, 1, [transport], None, ov.OverlapConfig(),
                remat=remat, anchors=[[tuple(leaves[s][i] for s in bucket)
                                       for i in range(L)]], sink=sink)
            auto = torch.autograd.grad(y.square().mean(), flat + [x0],
                                       allow_unused=True)
            if any(g is not None for g in auto[:-1]):
                raise AssertionError("overlap bucket leg: a bucketed leaf "
                                     "got a gradient outside its bucket")
            done = sink.wait_all()
            if sorted(done) != [(0, i) for i in range(L)]:
                raise AssertionError(f"overlap bucket leg: reductions "
                                     f"{sorted(done)}")
            cut = ov._unpack_bucket_grads([done[(0, i)] for i in range(L)],
                                          bucket, shapes, leaves)
            got = [cut[s][i] for i in range(L) for s in bucket] + [auto[-1]]
            err = max(((g - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(got, want))
            out[f"{name}{'_remat' if remat else ''}"] = dict(
                max_rel_err=err,
                bitwise=all(torch.equal(g, w) for g, w in zip(got, want)))
    print("overlap bucket leg: " + json.dumps(out), flush=True)
    bad = {k: v for k, v in out.items() if not v["max_rel_err"]
           <= BUCKET_LEG_TOL}
    if bad:
        raise AssertionError(f"overlap bucket leg: gradients off plain "
                             f"autograd: {bad}")
    return dict(shapes=shapes, layers=L, tol=BUCKET_LEG_TOL, runs=out)


def overlap_train_phase(dev):
    """The train cell (bench.py:57-67 at full width and depth, accum
    MESH_ACCUM as mesh_train) through ``build_train_step(mesh,
    overlap=OverlapConfig())`` on the (1, 1, 1) NCCL mesh, beside the same
    step with ``overlap=None`` on the same weights and batches: the mesh_train
    path of each (steps, a masked step at MESH_MASKED_ACCUM, the
    accumulation alone, profiled micro-steps), the two in turns for their ms
    a step, and one step of each under MemoryConfig(remat="full").  At
    world size 1 every collective is a no-op and ``sharding`` cuts nothing,
    so the overlap stack runs its layer code and its per-layer packing of
    the grad-sync leaves, not its bucket transport, which
    ``overlap_bucket_leg`` drives on its own; nothing here measures hidden
    communication.  Raises where a loss differs from the mesh step's
    by more than TRAIN_LOSS_TOL relative, where an attention call was not a
    kernel launch, where the launch counts (wrappers and profiler) differ
    from the mesh step's, or where a plain version was called."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    oc = OverlapConfig()
    mesh, checks = mesh_world1(dev)
    try:
        rng = np.random.default_rng(SEED)
        shape = (MESH_ACCUM, TRAIN_BATCH, TRAIN_SEQ)
        ids = torch.from_numpy(rng.integers(0, TRAIN_CFG["vocab_size"],
                                            shape)).to(dev)
        labels = torch.from_numpy(rng.integers(0, TRAIN_CFG["vocab_size"],
                                               shape)).to(dev)
        seg, _ = packed_documents(np.random.default_rng(SEED + 1),
                                  MESH_MASKED_ACCUM * TRAIN_BATCH, TRAIN_SEQ,
                                  DOC_MEDIAN, pad=True)
        seg = torch.from_numpy(seg.reshape(
            (MESH_MASKED_ACCUM, TRAIN_BATCH, TRAIN_SEQ))).to(dev)
        a = _mesh_run("overlap_train mesh", dev, mesh, ids, labels, seg)
        b = _mesh_run("overlap_train overlap", dev, mesh, ids, labels, seg,
                      overlap=oc)
        turns_ms, turns_losses = _overlap_turns(dev, mesh, ids, labels, oc)
        remat = _overlap_remat(dev, mesh, ids, labels, oc)
        bucket_leg = overlap_bucket_leg(dev, mesh)
    finally:
        dist.destroy_process_group()
    layers = TRAIN_CFG["num_hidden_layers"]
    steps = TRAIN_WARMUP + TRAIN_STEPS
    for r in (a, b):
        check_launches("overlap_train", r["launches"], r["plain_calls"],
                       flash_attention_fwd=layers * MESH_ACCUM * steps,
                       flash_attention_bwd=layers * MESH_ACCUM * steps)
        check_launches("overlap_train masked", r["masked_launches"],
                       r["masked_plain_calls"],
                       flash_masked_fwd=layers * MESH_MASKED_ACCUM,
                       flash_masked_bwd_fused=layers * MESH_MASKED_ACCUM)
    for r in remat.values():
        # full remat: each layer's forward runs again in the backward
        check_launches("overlap_train remat", r["launches"],
                       r["plain_calls"],
                       flash_attention_fwd=2 * layers * MESH_ACCUM,
                       flash_attention_bwd=layers * MESH_ACCUM)
    for key in ("launches", "masked_launches", "profiled_per_micro_step",
                "masked_profiled_per_micro_step"):
        if b[key] != a[key]:
            raise AssertionError(f"overlap_train: {key} overlap {b[key]} "
                                 f"vs mesh {a[key]}")
    pairs = [(f"step{i}", b["losses"][i], a["losses"][i])
             for i in range(len(a["losses"]))]
    pairs.append(("masked", b["masked_loss"], a["masked_loss"]))
    pairs += [(f"turn{i}", x, y) for i, (x, y) in enumerate(
        zip(turns_losses["overlap"], turns_losses["mesh"]))]
    pairs.append(("remat", remat["overlap"]["loss"],
                  remat["mesh"]["loss"]))
    pairs.append(("remat_vs_step0", remat["overlap"]["loss"],
                  a["losses"][0]))
    rel = {k: abs(x - y) / abs(y) for k, x, y in pairs}
    bitwise = {k: x == y for k, x, y in pairs}
    if not all(v <= TRAIN_LOSS_TOL for v in rel.values()):
        raise AssertionError(f"overlap_train: overlap vs mesh losses {rel} "
                             f"> {TRAIN_LOSS_TOL}")
    if not all(np.isfinite(b["losses"])) or \
            not b["losses"][-1] < b["losses"][0]:
        raise AssertionError(f"overlap_train: losses {b['losses']} not "
                             f"finite and falling")
    med = {k: statistics.median(v) for k, v in turns_ms.items()}
    return dict(config=TRAIN_CFG, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                accum=MESH_ACCUM, masked_accum=MESH_MASKED_ACCUM,
                reduced=[f"accum {MESH_ACCUM} instead of 64 (masked step: "
                         f"accum {MESH_MASKED_ACCUM}), as mesh_train"],
                mesh=[1, 1, 1], overlap=dataclasses.asdict(oc),
                collectives=checks, loss_rel=rel, losses_bitwise=bitwise,
                tol=TRAIN_LOSS_TOL, turns_ms=turns_ms,
                ms_per_step=med,
                overlap_minus_mesh_ms=med["overlap"] - med["mesh"],
                run_ms_per_step={"mesh": a["ms_per_step"],
                                 "overlap": b["ms_per_step"]},
                accumulate_ms={"mesh": a["accumulate_ms"],
                               "overlap": b["accumulate_ms"]},
                peak_device_bytes={"mesh": a["peak_device_bytes"],
                                   "overlap": b["peak_device_bytes"],
                                   "mesh_remat": remat["mesh"][
                                       "peak_device_bytes"],
                                   "overlap_remat": remat["overlap"][
                                       "peak_device_bytes"]},
                remat=remat, bucket_leg=bucket_leg, mesh_step=a,
                overlap_step=b)


# --------------------------------------------------------------- codec phase

# one train-cell layer's seven projection weights in 8 rows
CODEC_SHAPE = (8, 5537792)
CODEC_PROFILES = (("int8_sr", "int8", True, False),
                  ("int8", "int8", False, True),
                  ("fp8", "fp8", False, False))
CODEC_TOL = {"int8_sr": 1.0 / 127, "int8": 0.5 / 127, "fp8": 1.0 / 16}
CODEC_REPS = 20


def codec_phase(dev, flush):
    """parallel/codec.py on the card: a CODEC_SHAPE fp32 payload drawn from
    SEED on the card (a wide dynamic range across blocks), encoded there
    under int8 with stochastic rounding, int8 round-to-nearest (with the
    row checksum) and fp8.  Raises unless the packed bytes equal the CPU
    encode of the same input bit for bit, unless each block decodes within
    its profile's bound of its absmax, and unless one flipped byte poisons
    exactly its row to NaN in decode_rows and raises ChecksumError in
    verify_rows_host.  Times encode and decode (CUDA events, median, min,
    max) beside a bytes bound: fp32 read and the packed row written, and
    back."""
    import torch
    from paddle_tpu_torch.parallel import codec as C

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, n = CODEC_SHAPE
    x = torch.randn(CODEC_SHAPE, generator=gen, device=dev) * torch.exp(
        2 * torch.randn(CODEC_SHAPE, generator=gen, device=dev))
    x_cpu = x.cpu()
    out = []
    for name, profile, sr, cs in CODEC_PROFILES:
        codec = C.CollectiveCodec(checksum=cs)
        packed = C.encode_rows(x, codec, profile, stochastic=sr)
        cpu = C.encode_rows(x_cpu, codec, profile, stochastic=sr)
        same = bool(torch.equal(packed.cpu(), cpu))
        y = C.decode_rows(packed, n, codec, profile)
        nb = C.num_blocks(n, codec.block)
        amax = x.reshape(rows, nb, codec.block).abs().amax(-1)
        err = (y - x).abs().reshape(rows, nb, codec.block).amax(-1)
        worst = float((err / amax.clamp_min(1e-30)).max())
        within = bool((err <= amax * CODEC_TOL[name] * 1.02 + 1e-12).all())
        poisoned = None
        if cs:
            C.verify_rows_host(packed)
            bad = packed.clone()
            bad[3, 12345] ^= 0x10
            dec = C.decode_rows(bad, n, codec, profile)
            nan_rows = torch.isnan(dec).any(dim=1).cpu().tolist()
            try:
                C.verify_rows_host(bad)
                raised = False
            except C.ChecksumError:
                raised = True
            poisoned = bool(torch.isnan(dec[3]).all()) and \
                nan_rows == [r == 3 for r in range(rows)] and raised
            del bad, dec
        enc = timing(lambda: C.encode_rows(x, codec, profile,
                                           stochastic=sr), CODEC_REPS, flush)
        dec_t = timing(lambda: C.decode_rows(packed, n, codec, profile),
                       CODEC_REPS, flush)
        nbytes = x.numel() * 4 + packed.numel()
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        r = dict(name=name, profile=profile, stochastic=sr, checksum=cs,
                 shape=list(CODEC_SHAPE), packed_width=packed.shape[1],
                 wire_ratio=C.wire_ratio(n, codec.block),
                 bytes_equal_cpu=same, within_block_bound=within,
                 worst_block_err=worst, tol=CODEC_TOL[name],
                 checksum_poisons_row=poisoned,
                 encode_ms=enc[0], encode_min=enc[1], encode_max=enc[2],
                 decode_ms=dec_t[0], decode_min=dec_t[1],
                 decode_max=dec_t[2], bound_ms=b_ms, bound_by="bytes")
        print(f"codec {name} {list(CODEC_SHAPE)}: bytes_equal_cpu={same} "
              f"worst_block_err={worst:.3g} (tol {CODEC_TOL[name]:.3g}) "
              f"poisoned={poisoned} encode_ms={enc[0]:.4f} [{enc[1]:.4f}, "
              f"{enc[2]:.4f}] decode_ms={dec_t[0]:.4f} [{dec_t[1]:.4f}, "
              f"{dec_t[2]:.4f}] bound_ms={b_ms:.4f} (bytes)", flush=True)
        out.append(r)
        del packed, cpu, y
    del x, x_cpu
    torch.cuda.empty_cache()
    failed = [r["name"] for r in out
              if not (r["bytes_equal_cpu"] and r["within_block_bound"]
                      and r["checksum_poisons_row"] is not False)]
    if failed:
        raise AssertionError(f"codec phase: {failed} failed: {out}")
    return out


def long_context_phase(dev):
    """The Llama 3 8K recipe on the bench.py model: b 1, s LONG_SEQ, accum
    LONG_ACCUM, documents of median LONG_DOC_MEDIAN packed and truncated at
    the row end, segment ids through ``build_train_step``: the masked
    forward and the dq + dkv backward (the fused kernel's scratch rule says
    no at 8K).  One warm-up and one timed step.  Then the causal document
    mask as FlashMask bands (``startend_row_indices``) must give the
    segment-id logits of ``LlamaForCausalLM.forward``, within the bf16
    gate.  The rope tables reach 8192 positions (bench.py's config stops
    at 2048); nothing else of the model changes."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, build_train_step
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.flashmask import causal_document_row_indices

    cfg, model, params, opt, state, n_params = train_setup(
        dev, max_position_embeddings=LONG_SEQ)
    rng = np.random.default_rng(SEED + 2)
    shape = (LONG_ACCUM, 1, LONG_SEQ)
    seg, lens = packed_documents(rng, LONG_ACCUM, LONG_SEQ, LONG_DOC_MEDIAN,
                                 pad=False)
    seg = torch.from_numpy(seg.reshape(shape)).to(dev)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=LONG_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    carry = [params, state]
    del params, state
    losses, walls, params, state, counts, plain_calls = train_steps(
        step, carry, 2, ids, labels, attention_mask=seg)
    want = cfg.num_hidden_layers * LONG_ACCUM * 2
    check_launches("long context", counts, plain_calls,
                   flash_masked_fwd=want, flash_masked_bwd_dq=want,
                   flash_masked_bwd_dkv=want)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"long context: losses {losses} not finite")
    # every B6 call of one profiled micro-step runs the split wgmma pair
    # (the profiler can drop a window's records: PROFILE_WINDOWS windows)
    step1 = build_train_step(model, opt, compute_dtype=torch.bfloat16)
    b6, b6_windows = until_counted(
        lambda: profiled_calls(lambda: step1.accumulate(
            params, ids[0], labels[0], attention_mask=seg[0]), "::masked_d"),
        lambda calls: sum(calls.values()) == 2 * cfg.num_hidden_layers)
    del step1
    torch.cuda.empty_cache()
    if sorted(b6.values()) != [cfg.num_hidden_layers] * 2 or \
            not any("masked_dq_wgmma_kernel" in n for n in b6) or \
            not any("masked_dkv_wgmma_kernel" in n and "false" in n
                    for n in b6):
        raise AssertionError(f"long context: B6 kernels {b6}, expected "
                             f"masked_dq_wgmma_kernel and the split "
                             f"masked_dkv_wgmma_kernel "
                             f"{cfg.num_hidden_layers} times each")
    tokens = LONG_ACCUM * LONG_SEQ
    result = dict(seq=LONG_SEQ, batch=1, accum=LONG_ACCUM,
                  doc_median=LONG_DOC_MEDIAN, documents=[len(r) for r in lens],
                  losses=losses, step_s=walls, ms_per_step=walls[-1] * 1e3,
                  tokens_per_s=tokens / walls[-1],
                  mfu=6 * n_params * tokens / walls[-1] / H100_BF16_PEAK,
                  launches=counts, plain_calls=plain_calls,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  b6_kernel_calls=b6)
    del step, state
    torch.cuda.empty_cache()

    bf16 = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                            generator=torch.Generator(device=dev).manual_seed(
                                SEED)).load_functional_state(params)
    del model, params
    # every B5 call of a segment-id forward runs the wgmma kernel (the
    # profiler can drop a window's records: up to PROFILE_WINDOWS windows)
    with torch.no_grad():
        b5, b5_windows = until_counted(
            lambda: profiled_calls(lambda: bf16(ids[0],
                                                attention_mask=seg[0]),
                                   "masked_fwd"),
            lambda calls: sum(calls.values()) == cfg.num_hidden_layers)
    result["b5_kernel_calls"] = b5
    result["profile_windows"] = dict(b6=b6_windows, b5=b5_windows)
    fa.reset_launches()
    with torch.no_grad():
        by_ids = bf16(ids[0], attention_mask=seg[0])
        by_doc = bf16(ids[0], startend_row_indices=causal_document_row_indices(
            lens[0]))
    _sync()
    if list(b5.values()) != [cfg.num_hidden_layers] or \
            not all("masked_fwd_wgmma_kernel" in n for n in b5):
        raise AssertionError(f"long context: B5 kernels {b5}, expected "
                             f"masked_fwd_wgmma_kernel "
                             f"{cfg.num_hidden_layers} times")
    err, abs_err = row_error(by_doc, by_ids)
    finite = bool(torch.isfinite(by_ids.float()).all())
    result["doc_mask_logits"] = dict(
        row_error=err, max_abs_err=abs_err, tol=FLASH_ROW_TOL["bf16"]["o"],
        launches=dict(fa.LAUNCHES), shape=list(by_ids.shape))
    if not finite or not err <= FLASH_ROW_TOL["bf16"]["o"] or \
            fa.LAUNCHES["flash_masked_fwd"] != 2 * cfg.num_hidden_layers:
        raise AssertionError(f"long context: document-mask logits "
                             f"{result['doc_mask_logits']}")
    del bf16, by_ids, by_doc
    torch.cuda.empty_cache()
    return result


def profiled_calls(fn, match):
    """{kernel name: launches} of the device kernels whose name contains
    ``match``, by ``torch.profiler`` over one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    return {e.key[:80]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key}


def until_counted(profile_fn, counted, windows=PROFILE_WINDOWS):
    """``profile_fn()`` (one profiled window) repeated until ``counted``
    holds for its result, up to ``windows`` windows; returns (the last
    result, the windows profiled), the second recorded beside each check.
    The profiler can drop a window's device records, all or a few (a
    launch count one short), and a dropped record is no launch of another
    kernel: each check that follows stays exact, and passes on the best of
    ``windows`` windows."""
    out = profile_fn()
    used = 1
    while used < windows and not counted(out):
        out = profile_fn()
        used += 1
    return out, used


def profile_train(step1, params, ids, labels, micro_steps=2,
                  attention_mask=None):
    """``torch.profiler`` over ``micro_steps`` fwd+bwd micro-steps (accum 1,
    no update): wall and device ms per micro-step, the device's idle share
    and the kernels that take most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step1.accumulate(params, ids, labels, attention_mask)
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(micro_steps):
            step1.accumulate(params, ids, labels, attention_mask)
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

    flash = share(lambda k: ("hb_" in k or "masked_" in k) and "_kernel" in k)
    gemm = share(lambda k: any(t in k.lower() for t in
                               ("nvjet", "gemm", "cutlass", "sm90_xmma")))
    return {"micro_steps": micro_steps,
            "flash_kernel_calls": {e.key[:80]: e.count for e in events
                                   if ("hb_" in e.key or "masked_" in e.key)
                                   and "_kernel" in e.key},
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


# ------------------------------------------------ grouped-matmul kernel phase

def _decode_lens(slots, top_k, experts, seed):
    """Per-expert copy counts of ``slots`` tokens routed top-k to distinct
    experts, drawn from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = [rng.choice(experts, top_k, replace=False) for _ in range(slots)]
    return np.bincount(np.concatenate(ids), minlength=experts).tolist()


def _multinomial_lens(total, experts, seed):
    """Per-expert copy counts of ``total`` copies under a seeded Dirichlet
    routing mix (uneven, as a learned router's is)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.multinomial(total, rng.dirichlet(np.full(experts, 4.0))
                           ).tolist()


# B7/B8 cases: name -> (op, kinds, per-segment lengths, K, N, wids or None,
# block_rows).  op "fwd": y [R, N] = x [R, K] @ w[wid] [K, N]; "t": the same
# product with the bank stored [E, N, K] (the backward's dx on w^T);
# "outer": out [S, K, N] = x[win]^T @ dy[win] (B8).  The Mixtral decode call
# (8 slots x top-2 = 16 rows over 8 experts, block_rows 8), a unified-step
# call (528 copies, R 592) and a 6 x 300-token prefill call on the int8
# bank; the dropless train cell's three
# calls (16384 copies over 8 experts, K/N 4096/14336); then an empty
# segment, all rows on one expert, unaligned lengths at block_rows 128 and
# repeated weight ids (the adapter shape).
GMM_CASES = {
    "mixtral_decode_up": ("fwd", ("int8",), _decode_lens(8, 2, 8, SEED),
                          4096, 14336, None, 8),
    "mixtral_decode_down": ("fwd", ("int8",), _decode_lens(8, 2, 8, SEED),
                            14336, 4096, None, 8),
    "mixtral_unified_up": ("fwd", ("int8",), _multinomial_lens(528, 8, SEED),
                           4096, 14336, None, 8),
    "mixtral_prefill_up": ("fwd", ("int8",),
                           _multinomial_lens(6 * 300 * 2, 8, SEED), 4096,
                           14336, None, 8),
    "train_fwd": ("fwd", ("bf16", "fp32"), _multinomial_lens(16384, 8, SEED),
                  4096, 14336, None, 8),
    "train_dx": ("t", ("bf16", "fp32"), _multinomial_lens(16384, 8, SEED),
                 14336, 4096, None, 8),
    "train_dw": ("outer", ("bf16", "fp32"), _multinomial_lens(16384, 8, SEED),
                 4096, 14336, None, 8),
    "empty_segments": ("fwd", ("bf16", "fp32", "int8"),
                       [37, 0, 100, 0, 5, 64, 0, 1], 1024, 512, None, 8),
    "one_expert": ("fwd", ("bf16", "fp32", "int8"),
                   [0, 0, 0, 2048, 0, 0, 0, 0], 1024, 1024, None, 8),
    "unaligned_br128": ("fwd", ("bf16", "fp32", "int8"),
                        [13, 77, 3, 200, 1, 65, 31, 9], 512, 768, None, 128),
    "repeated_wids": ("fwd", ("bf16", "fp32"),
                      [9, 30, 2, 17, 0, 40, 5, 11, 23, 1, 8, 14, 3, 60, 7,
                       19], 512, 512, [i % 4 for i in range(16)], 8),
    "outer_empty_unaligned": ("outer", ("bf16", "fp32"),
                              [13, 0, 77, 3, 0, 200, 1, 65], 512, 768, None,
                              8),
}


def gmm_work(inp):
    """(bytes, ops) of a B7/B8 call: the covered rows of x (and dy) read
    once, the weight slices of non-empty segments and their scales read
    once, the output written once (B8: fp32 [S, K, N]), 12 B of segment
    table per segment; 2 K N per real row."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    lens, bm = inp["lens"].tolist(), inp["bm"]
    used = sum(int(gm.align_rows(n, bm)) for n in lens)
    item, K = inp["x"].element_size(), inp["x"].shape[1]
    if inp["op"] == "outer":
        N = inp["dy"].shape[1]
        nbytes = used * (K + N) * item + len(lens) * K * N * 4
    else:
        w = inp["w"]
        N = w.shape[1] if inp["op"] == "t" else w.shape[2]
        wread = len({i for i, n in zip(inp["wids"].tolist(), lens) if n})
        nbytes = used * (K + N) * item + wread * K * N * w.element_size()
        if inp["scale"] is not None:
            nbytes += wread * N * 4
    return nbytes + 12 * len(lens), 2 * sum(lens) * K * N


def gmm_inputs(name, kind, dev):
    """Inputs of GMM_CASES[name] in ``kind`` (bf16, fp32, or int8: a bf16
    x over an int8 bank with fp32 scales) from SEED, laid out as the MoE
    callers lay them out: block-aligned dense segment starts, zero
    alignment slack, rows = align(copies) + E * block_rows; ``nbytes``
    and ``ops`` by ``gmm_work``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import grouped_matmul as gm

    op, _, lens, K, N, wids, bm = GMM_CASES[name]
    S = len(lens)
    wids = list(range(S)) if wids is None else wids
    E = max(wids) + 1
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    starts = gm.segment_starts(lens_t, bm)
    R = int(gm.align_rows(sum(lens), bm) + E * bm)
    valid = np.zeros(R, bool)
    for st, n in zip(starts.tolist(), lens):
        valid[st:st + n] = True
    valid = torch.from_numpy(valid).to(dev)[:, None]

    def rows(width):
        x = torch.randn(R, width, generator=g, device=dev).to(dtype)
        return torch.where(valid, x, torch.zeros((), dtype=dtype,
                                                 device=dev))

    out = dict(op=op, lens=lens_t, starts=starts,
               wids=torch.tensor(wids, dtype=torch.int32, device=dev),
               bm=bm, scale=None, dy=None)
    live = sum(1 for n in lens if n > 0)
    if op == "outer":
        out["x"], out["dy"] = rows(K), rows(N)
    else:
        out["x"] = rows(K)
        wshape = (E, N, K) if op == "t" else (E, K, N)
        if kind == "int8":
            out["w"] = torch.randint(-127, 128, wshape, generator=g,
                                     device=dev, dtype=torch.int8)
            out["scale"] = (torch.rand(E, N, generator=g, device=dev) + 0.5
                            ) / (73.0 * K ** 0.5)
        else:
            out["w"] = (torch.randn(wshape, generator=g, device=dev)
                        / K ** 0.5).to(dtype)
    out["nbytes"], out["ops"] = gmm_work(out)
    out["shape"] = (f"{op} rows {R} ({sum(lens)} real, {live}/{S} segments "
                    f"live) K {K} N {N} block_rows {bm}")
    return out


def _gmm_call(inp, plain=False):
    from paddle_tpu_torch.ops import grouped_matmul as gm
    if inp["op"] == "outer":
        fn = gm.grouped_outer_plain if plain else gm.grouped_outer_raw
        return fn(inp["x"], inp["dy"], inp["starts"], inp["lens"],
                  inp["bm"])
    fn = gm.grouped_matmul_plain if plain else gm.grouped_matmul_raw
    return fn(inp["x"], inp["w"], inp["starts"], inp["lens"], inp["wids"],
              inp["bm"], w_scale=inp["scale"], transpose_w=inp["op"] == "t")


def _gmm_library(inp):
    """A PyTorch call computing the case's function, never called by the
    port: ``torch._grouped_mm`` over the aligned segment ends (bf16, one
    weight slice per segment), else a loop of per-segment
    ``torch.matmul``; None for an int8 bank.  Returns (fn, name)."""
    import torch
    if inp["scale"] is not None:
        return None, "none: no PyTorch call takes an int8 bank"
    ends = torch.cumsum(((inp["lens"] + inp["bm"] - 1) // inp["bm"])
                        * inp["bm"], 0, dtype=torch.int32)
    x, op, end = inp["x"], inp["op"], int(ends[-1])
    identity = inp["wids"].tolist() == list(range(len(inp["wids"])))
    if x.dtype == torch.bfloat16 and identity and hasattr(torch,
                                                          "_grouped_mm"):
        if op == "outer":
            a, b = x[:end].t(), inp["dy"][:end]
        else:
            a = x[:end]
            b = inp["w"].transpose(1, 2) if op == "t" else inp["w"]

        def grouped():
            return torch._grouped_mm(a, b, offs=ends)
        try:
            grouped()
            _sync()
            return grouped, "torch._grouped_mm(offs=aligned segment ends)"
        except (RuntimeError, TypeError):
            pass
    lo = (ends - (((inp["lens"] + inp["bm"] - 1) // inp["bm"])
                  * inp["bm"])).tolist()
    segs = list(zip(lo, ends.tolist(), inp["wids"].tolist()))

    def loop():
        for a0, a1, wid in segs:
            if a1 <= a0:
                continue
            if op == "outer":
                torch.matmul(x[a0:a1].t(), inp["dy"][a0:a1])
            else:
                wb = inp["w"][wid]
                torch.matmul(x[a0:a1], wb.t() if op == "t" else wb)
    return loop, "loop of per-segment torch.matmul"


# B7 int8's CUDA kernels (the reducer runs where K is split)
GMM_INT8_KERNELS = ("gmm_int8_wgmma_kernel", "gmm_split_reduce_kernel")


@contextlib.contextmanager
def forced_int8_order(rows_inner):
    """Make B7 int8 walk its grid with row tiles (True) or column tiles
    (False) innermost whatever the shape, through the plan its wrapper
    reads."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    plan = gm.gmm_int8_plan

    def forced(*shape):
        tile, splits, _, ctas = plan(*shape)
        return tile, splits, rows_inner, ctas

    gm.gmm_int8_plan = forced
    try:
        yield
    finally:
        gm.gmm_int8_plan = plan


def int8_other_order(inp, reps, flush):
    """B7 int8 on ``inp`` with the grid order its plan did not pick: the
    same bits as the planned order (each CTA's sums do not depend on when
    it runs), timed as the planned order is (CUDA events and profiler, L2
    flushed), the evidence for ``gmm_int8_plan``'s order rule."""
    import torch
    from paddle_tpu_torch.ops import grouped_matmul as gm
    (R, K), N = inp["x"].shape, inp["w"].shape[2]
    rows_inner = not gm.gmm_int8_plan(R, K, N, len(inp["lens"]))[2]
    planned = _gmm_call(inp)
    with forced_int8_order(rows_inner):
        got = _gmm_call(inp)
        _sync()
        if not torch.equal(got, planned):
            raise AssertionError(f"grouped int8: the grid order changed "
                                 f"the output at R {R}, K {K}, N {N}")
        ms, lo, hi = timing(lambda: _gmm_call(inp), reps, flush)
        device = _device_ms(lambda: (flush.zero_(), _gmm_call(inp)), 5,
                            GMM_INT8_KERNELS)
    return dict(rows_inner=rows_inner, ms=ms, ms_min=lo, ms_max=hi,
                device_ms=device)


def gmm_cases(dev, flush):
    """B7 (float, int8, transposed) and B8 on GMM_CASES, each gated against
    its plain version (per-row gate; rows no segment covers exact 0) and
    timed beside its bound, the plain version and a library yardstick."""
    import torch

    records = []
    for name, (op, kinds, lens, K, N, _, bm) in GMM_CASES.items():
        for kind in kinds:
            inp = gmm_inputs(name, kind, dev)
            got, want = _gmm_call(inp), _gmm_call(inp, plain=True)
            _sync()
            tol = ROW_TOL["fp32" if kind == "fp32" else "bf16"]
            err, abs_err = row_error(got, want)
            del got, want
            if not err <= tol:
                raise AssertionError(f"grouped {name}[{kind}]: per-row "
                                     f"error {err} > {tol}")
            big = inp["ops"] > 1e11
            reps = (2 if kind == "fp32" else 3) if big else 20
            lib, call = _gmm_library(inp)
            bms, by = bound(inp["nbytes"], inp["ops"],
                            "fp32" if kind == "fp32" else "bf16")
            ms, lo, hi = timing(lambda: _gmm_call(inp), reps, flush)
            # B7 int8: its kernels' device time by the profiler, L2 flushed
            device = (_device_ms(lambda: (flush.zero_(), _gmm_call(inp)), 5,
                                 GMM_INT8_KERNELS) if kind == "int8" else None)
            other = (int8_other_order(inp, reps, flush)
                     if kind == "int8" and name.startswith("mixtral_")
                     else None)
            records.append(dict(
                name=name, kind=kind, op=op, shape=inp["shape"],
                lens=inp["lens"].tolist(), err=err, tol=tol,
                max_abs_err=abs_err, ms=ms, ms_min=lo, ms_max=hi,
                device_ms=device, other_order=other,
                plain_ms=time_ms(lambda: _gmm_call(inp, plain=True),
                                 1 if big else 3, flush),
                bound_ms=bms, bound_by=by,
                tflops=inp["ops"] / ms / 1e9,
                gbytes_per_s=inp["nbytes"] / ms / 1e6,
                library_ms=None if lib is None else time_ms(lib, reps, flush),
                library_call=call))
            del inp, lib
            torch.cuda.empty_cache()
    return records


# ---------------------------------------------------- Mixtral serving phase

# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json) at full width and
# depth; cut: max_position_embeddings 2048 (32768), as the 8B cell
MIXTRAL_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                   num_hidden_layers=32, num_attention_heads=32,
                   num_key_value_heads=8, max_position_embeddings=2048,
                   rope_theta=1e6, rms_norm_eps=1e-5, num_experts=8,
                   moe_top_k=2)
MOE_PROFILE_CHUNKS = 1


def mixtral_params(cfg, dev):
    """Seeded random Mixtral weights, int8 weight-only: each tensor is
    drawn in bf16 on the card (Xavier-uniform [in, out] slices, a Normal
    embedding, unit norm gains, as LlamaForCausalLM initialises), quantized
    at once by the port's ``quantize_params_int8`` (norms and routers stay
    bf16) and its bf16 copy dropped, so the bf16 model never exists."""
    import math
    import torch
    from paddle_tpu_torch.models.generation import quantize_params_int8

    g = torch.Generator(device=dev).manual_seed(SEED)
    h, it, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    qd, kvd = h, cfg.num_key_value_heads * cfg.head_dim
    params = {}

    def xavier(*shape):
        w = torch.rand(shape, generator=g, device=dev)
        w.mul_(2.0).sub_(1.0).mul_(math.sqrt(6.0 / (shape[-2] + shape[-1])))
        return w.to(torch.bfloat16)

    def add(name, w):
        params.update(quantize_params_int8({name: w}))

    add("model.embed_tokens.weight", torch.randn(
        cfg.vocab_size, h, generator=g, device=dev).to(torch.bfloat16))
    ones = torch.ones(h, dtype=torch.bfloat16, device=dev)
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        add(pre + "input_layernorm.weight", ones.clone())
        for proj, shape in (("q_proj", (h, qd)), ("k_proj", (h, kvd)),
                            ("v_proj", (h, kvd)), ("o_proj", (qd, h))):
            add(pre + f"self_attn.{proj}.weight", xavier(*shape))
        add(pre + "post_attention_layernorm.weight", ones.clone())
        add(pre + "mlp.router.weight", xavier(h, E))
        for proj, shape in (("gate_proj", (E, h, it)), ("up_proj", (E, h, it)),
                            ("down_proj", (E, it, h))):
            add(pre + f"mlp.experts.{proj}.weight", xavier(*shape))
        torch.cuda.empty_cache()
    add("model.norm.weight", ones)
    add("lm_head.weight", xavier(h, cfg.vocab_size))
    return params


@contextlib.contextmanager
def moe_counter():
    """Zero the grouped-matmul LAUNCHES and count, while the block runs,
    the ``_moe_ffn`` calls and the plain-version calls of B7/B8."""
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.ops import grouped_matmul as gm
    names = ("grouped_matmul_plain", "grouped_outer_plain")
    calls = dict.fromkeys(("moe_ffn",) + names, 0)
    saved = {n: getattr(gm, n) for n in names}
    saved_ffn = gen._moe_ffn

    def counted(n, fn):
        def call(*a, **kw):
            calls[n] += 1
            return fn(*a, **kw)
        return call

    gm.reset_launches()
    for n in names:
        setattr(gm, n, counted(n, saved[n]))
    gen._moe_ffn = counted("moe_ffn", saved_ffn)
    try:
        yield calls
    finally:
        for n in names:
            setattr(gm, n, saved[n])
        gen._moe_ffn = saved_ffn


def check_moe_launches(what, calls):
    """Every _moe_ffn projection of a serving path a B7 int8 launch, no
    other grouped launch and no plain call."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    want = dict.fromkeys(gm.LAUNCHES, 0)
    want["grouped_matmul_int8"] = 3 * calls["moe_ffn"]
    if calls["moe_ffn"] == 0 or dict(gm.LAUNCHES) != want or \
            calls["grouped_matmul_plain"] or calls["grouped_outer_plain"]:
        raise AssertionError(f"{what}: grouped launches {gm.LAUNCHES} "
                             f"(expected {want}), calls {calls}")
    return dict(gm.LAUNCHES, moe_ffn_calls=calls["moe_ffn"])


def int8_routes(cfg, params, prompt, dev):
    """Every B7 int8 call of a short chunked and a short unified session
    and of ``_generate_greedy`` (4 new tokens) on the Mixtral weights, one
    profiled window per path, ran ``gmm_int8_wgmma_kernel``, none
    ``gmm_kernel``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.generation import _generate_greedy
    from paddle_tpu_torch.ops import grouped_matmul as gm
    ids = torch.from_numpy(np.ascontiguousarray(prompt[None])).to(dev)
    runs = {"chunked": lambda: short_session(cfg, params, dev, False),
            "unified": lambda: short_session(cfg, params, dev, True),
            "generate": lambda: _generate_greedy(cfg, params, ids, 4, -1)}
    return {path: route_profile(
        f"mixtral B7 int8 route ({path})", run, gm.LAUNCHES,
        ("grouped_matmul_int8",), GMM_INT8_KERNELS[:1], ("::gmm_kernel<",))
        for path, run in runs.items()}


def served_choices(cfg, params, seqs, dev):
    """The served model's expert choices on ``seqs``: per sequence, per
    MoE layer, the [len, k] expert ids that the port's bf16 prefill (the
    same ``_ffn``, B7 launches included) picks, teacher-forced."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import generation as gen

    w = gen._Weights(cfg, params)
    cos, sin = gen.rope_tables_on(cfg, dev)
    out, saved = [], gen._top_k

    def record(probs, k):
        vals, ids = saved(probs, k)
        layers.append(ids)
        return vals, ids

    gen._top_k = record
    try:
        with torch.no_grad():
            for s in seqs:
                layers = []
                ids = torch.from_numpy(np.asarray(s, np.int32)).to(dev)
                gen._prefill(w, ids[None], cos, sin)
                out.append(layers)
    finally:
        gen._top_k = saved
    return out


def moe_teacher_forced(cfg, params, prompts, outputs, dev):
    """``teacher_forced`` on the sparse model, beside the count of (token,
    layer) pairs whose top-k expert set differs between the served path
    (``served_choices``) and the fp32 reference.  Routing is
    discontinuous: a near-tie of the k-th and (k+1)-th expert may flip
    between the bf16 served path and fp32.  If the check fails with its own
    choices and some flipped, it is repeated with the reference taking the
    served choices, and that decides; both readings are recorded."""
    import numpy as np
    seqs = [np.concatenate([p, o[:-1]]) for p, o in zip(prompts, outputs)]
    served = served_choices(cfg, params, seqs, dev)
    own = []
    try:
        stats, failed = teacher_forced(cfg, params, prompts, outputs, dev,
                                       choices=own), None
    except AssertionError as e:
        stats, failed = None, str(e)
    S = max(len(s) for s in seqs)
    flips = pairs = 0
    forced = [c.clone() for c in own]
    for j, s in enumerate(seqs):
        for i, layer in enumerate(served[j]):
            mine = own[i][j * S:j * S + len(s)]
            flips += int((layer.sort(-1).values != mine.sort(-1).values
                          ).any(-1).sum())
            pairs += len(s)
            forced[i][j * S:j * S + len(s)] = layer
    if stats is None:
        if flips == 0:
            raise AssertionError(failed)
        stats = teacher_forced(cfg, params, prompts, outputs, dev,
                               forced=forced)
        stats["with_own_choices"] = failed
        stats["reference_choices"] = "served"
    else:
        stats["reference_choices"] = "own"
    stats.update(top_k_sets_differing=flips, token_layer_pairs=pairs)
    return stats


def moe_serving_phase(dev):
    """Mixtral-8x7B at full width and depth, int8 weight-only, random
    weights: the chunked engine, the unified engine with the prefix cache
    and ``_generate_greedy`` on the params dict, with the 8B cell's
    traffic; every MoE projection a B7 int8 launch, every decode attention
    call a B3/B3'/B4 launch, the chunk launches under the sync check, the
    fp32 teacher-forced check on the same int8 weights; then a short
    decode profile."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.generation import _generate_greedy

    cfg = LlamaConfig(**MIXTRAL_CFG)
    t0 = time.perf_counter()
    params = mixtral_params(cfg, dev)
    _sync()
    build_s = time.perf_counter() - t0
    total = sum(v.numel() * v.element_size() for v in params.values())
    emb = params["model.embed_tokens.weight"]
    # a decode step reads every weight but the embedding, of which it
    # gathers one row per slot
    step_bytes = total - emb.numel() * emb.element_size() + 8 * emb.shape[1]
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (32, 75, 128, 190, 257, 300)]
    system = rng.integers(1, cfg.vocab_size, (64,)).astype(np.int32)
    shared = [prompts[0], prompts[2], prompts[3], prompts[5],
              np.concatenate([system, prompts[1][:40]]),
              np.concatenate([system, prompts[4][:120]])]
    rec = {"config": MIXTRAL_CFG, "weight_gb": total / 1e9,
           "weights_build_s": build_s,
           "decode_step_weight_gb": step_bytes / 1e9,
           "weight_stream_floor_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
           "peak_mem_gb_weights": torch.cuda.max_memory_allocated() / 1e9}

    with moe_counter() as calls:
        done, rec["chunked"] = serve_chunked(cfg, params, prompts, dev)
    rec["chunked"]["grouped_launches"] = check_moe_launches("mixtral chunked",
                                                            calls)
    rec["chunked"]["teacher_forced"] = moe_teacher_forced(
        cfg, params, prompts, [f.tokens for f in done], dev)
    print("mixtral chunked: " + json.dumps(rec["chunked"]), flush=True)

    with moe_counter() as calls:
        done, rec["unified"] = serve_unified(cfg, params, shared, dev)
    rec["unified"]["grouped_launches"] = check_moe_launches("mixtral unified",
                                                            calls)
    by_rid = {f.rid: f.tokens for f in done}
    rec["unified"]["teacher_forced"] = moe_teacher_forced(
        cfg, params, shared, [by_rid[r] for r in sorted(by_rid)], dev)
    print("mixtral unified+prefix-cache: " + json.dumps(rec["unified"]),
          flush=True)

    def greedy(ids):
        ids = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
        return torch.cat([ids, _generate_greedy(cfg, params, ids, 32, -1)],
                         dim=1)

    with moe_counter() as calls:
        toks, rec["generate"] = serve_generate(cfg, None, prompts[3], dev,
                                               generate=greedy)
    rec["generate"]["grouped_launches"] = check_moe_launches(
        "mixtral generate", calls)
    rec["generate"]["teacher_forced"] = moe_teacher_forced(
        cfg, params, [prompts[3]], [toks], dev)
    print("mixtral generate: " + json.dumps(rec["generate"]), flush=True)
    rec["profile"] = profile_decode(
        cfg, params, dev, MOE_PROFILE_CHUNKS,
        classes={"grouped_matmul": list(GMM_INT8_KERNELS),
                 "decode_attention": ["paged_split_kernel",
                                      "decode_split_kernel",
                                      "decode_combine_kernel"],
                 "dense_gemm": ["nvjet", "gemm", "cutlass", "sm90_xmma"]})
    print("mixtral profile: " + json.dumps(rec["profile"]), flush=True)
    rec["grouped_routes"] = int8_routes(cfg, params, prompts[3], dev)
    print("mixtral grouped routes: " + json.dumps(rec["grouped_routes"]),
          flush=True)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("mixtral: " + json.dumps({k: v for k, v in rec.items() if k not in
                                    ("chunked", "unified", "generate",
                                     "profile")}), flush=True)
    del params
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------ dropless MoE train phase

# parallel/expert.py's dropless block at Mixtral-8x7B's expert shape (its
# own default activation, gelu); x2d bf16 [8192, 4096], fp32 params and
# target, block_rows 8.  Plain SGD on this objective (squared error summed
# over the 4096 features) has a curvature that grows with the width: at
# lr 1e-2, the JAX step's default, the losses grow from the first step
# (14157 -> 15920 -> 22281 -> 33895 on an H100), so the cell takes 3e-3
MOE_TRAIN_CFG = dict(d_model=4096, d_hidden=14336, num_expert=8, top_k=2)
MOE_TRAIN_TOKENS, MOE_TRAIN_WARMUP, MOE_TRAIN_STEPS = 8192, 1, 3
MOE_TRAIN_LR = 3e-3


def moe_reference_loss(cfg, params, x2d, tgt):
    """The dropless step's loss by a plain fp32 forward, independent of the
    port's code: top-k of the fp32 router softmax (raw weights), each
    expert's gelu FFN with biases on its tokens, the summed squared error
    over the tokens plus the weighted load-balance aux."""
    import torch
    import torch.nn.functional as F
    with torch.no_grad():
        x = x2d.float()
        probs = (x @ params["gate_w"]).softmax(-1)
        top_p, ids = probs.topk(cfg.top_k, dim=-1)
        y = torch.zeros_like(x)
        for e in range(cfg.num_expert):
            rows, slot = (ids == e).nonzero(as_tuple=True)
            if rows.numel():
                hid = F.gelu(x[rows] @ params["w_up"][e] + params["b_up"][e],
                             approximate="tanh")
                out = hid @ params["w_down"][e] + params["b_down"][e]
                y.index_add_(0, rows, out * top_p[rows, slot][:, None])
        load = F.one_hot(probs.argmax(-1), cfg.num_expert).float().mean(0)
        aux = cfg.num_expert * (load * probs.mean(0)).sum()
        loss = ((x + y - tgt).square().sum() / x.shape[0]
                + cfg.aux_weight * aux)
    return loss.item()


def profile_moe_step(step, params, x2d, tgt):
    """``torch.profiler`` over one more dropless step: wall and device ms,
    the device's idle share, device ms by kernel class (B7
    ``gmm_wgmma_kernel``, B8 ``outer_wgmma_kernel``, cuBLAS GEMMs, the
    rest) and the top kernels.  Returns (profile, the step's updated
    params)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params = step(params, x2d, tgt)[-1]
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms <= 0:
        raise AssertionError("moe train profile: no device time")
    classes = {"B7 gmm_wgmma_kernel": lambda k: "gmm_wgmma_kernel" in k,
               "B8 outer_wgmma_kernel": lambda k: "outer_wgmma_kernel" in k,
               "cuBLAS GEMMs": lambda k: any(t in k.lower() for t in (
                   "nvjet", "gemm", "cutlass", "sm90_xmma"))}
    by_class = {c: sum(e.self_device_time_total for e in events
                       if match(e.key)) / 1e3
                for c, match in classes.items()}
    by_class["other"] = device_ms - sum(by_class.values())
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_ms_by_class": by_class,
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}, params


def moe_train_inputs(cfg, dev):
    """(params, x2d bf16, tgt) of the MoE train cell from SEED:
    init_moe_ep_params's distributions, drawn on the card, then
    MOE_TRAIN_TOKENS tokens and their targets."""
    import torch
    m, h, e = cfg.d_model, cfg.d_hidden, cfg.num_expert
    g = torch.Generator(device=dev).manual_seed(SEED)
    params = {
        "gate_w": torch.randn(m, e, generator=g, device=dev),
        "w_up": torch.randn(e, m, h, generator=g, device=dev) / m ** 0.5,
        "b_up": torch.zeros(e, h, device=dev),
        "w_down": torch.randn(e, h, m, generator=g, device=dev) / m ** 0.5,
        "b_down": torch.zeros(e, m, device=dev)}
    x2d = torch.randn(MOE_TRAIN_TOKENS, m, generator=g, device=dev).to(
        torch.bfloat16)
    tgt = torch.randn(MOE_TRAIN_TOKENS, m, generator=g, device=dev)
    return params, x2d, tgt


def moe_train_phase(dev):
    """``build_moe_ep_dropless_train_step`` on one GPU at MOE_TRAIN_CFG:
    one warm-up and MOE_TRAIN_STEPS timed steps on one batch; per step
    exactly 2 B7 forward, 1 B7 dx (the first GEMM's input, the dispatched
    tokens, needs no gradient) and 2 B8 launches and no plain call;
    losses finite and falling, dropped 0, the step-0 loss within
    TRAIN_LOSS_TOL of a plain fp32 forward on the same weights."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.parallel.expert import (
        MoEEPConfig, build_moe_ep_dropless_train_step)

    cfg = MoEEPConfig(**MOE_TRAIN_CFG)
    m, h = cfg.d_model, cfg.d_hidden
    params, x2d, tgt = moe_train_inputs(cfg, dev)
    ref_loss = moe_reference_loss(cfg, params, x2d, tgt)
    torch.cuda.empty_cache()
    step = build_moe_ep_dropless_train_step(cfg, lr=MOE_TRAIN_LR,
                                            block_rows=8)
    torch.cuda.reset_peak_memory_stats()
    losses, walls, dropped, launches = [], [], [], []
    want = dict(grouped_matmul=2, grouped_matmul_int8=0, grouped_matmul_t=1,
                grouped_outer=2)
    for _ in range(MOE_TRAIN_WARMUP + MOE_TRAIN_STEPS):
        with moe_counter() as calls:
            t0 = time.perf_counter()
            loss, aux, drop, load, params = step(params, x2d, tgt)
            _sync()
            walls.append(time.perf_counter() - t0)
        launches.append(dict(gm.LAUNCHES))
        if dict(gm.LAUNCHES) != want or calls["grouped_matmul_plain"] or \
                calls["grouped_outer_plain"]:
            raise AssertionError(f"moe train: launches {gm.LAUNCHES} "
                                 f"(expected {want}), calls {calls}")
        losses.append(loss.item())
        dropped.append(float(drop))
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            any(dropped) or not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"moe train: losses {losses}, dropped "
                             f"{dropped}, step-0 {losses[0]} vs fp32 "
                             f"{ref_loss} ({rel})")
    window = sum(walls[MOE_TRAIN_WARMUP:])
    profile, params = profile_moe_step(step, params, x2d, tgt)
    # the grouped GEMMs the step runs: 2 forward, 1 dx, 2 dW
    flops = 5 * 2 * MOE_TRAIN_TOKENS * cfg.top_k * m * h
    rec = dict(config=MOE_TRAIN_CFG, activation=cfg.activation,
               tokens=MOE_TRAIN_TOKENS, block_rows=8, lr=MOE_TRAIN_LR,
               losses=losses, step_s=walls, dropped=dropped,
               ms_per_step=window / MOE_TRAIN_STEPS * 1e3,
               gemm_flop_per_step=flops,
               tflops=flops * MOE_TRAIN_STEPS / window / 1e12,
               launches_per_step=launches[-1],
               launches_total={k: sum(d[k] for d in launches)
                               for k in launches[0]},
               load=load.tolist(), aux=aux.item(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               step0_check=dict(kernel_bf16=losses[0], plain_fp32=ref_loss,
                                rel=rel, tol=TRAIN_LOSS_TOL),
               profile=profile)
    del params, x2d, tgt, step
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------ the training left-outs
# (the optimizer family, additive masks and dropout, the memory engine)

# eager steps of each optimizer on the card against the same steps on the
# CPU: fp32 within 1e-5 of the largest magnitude (one fp32 program, kernels
# that may sum in another order)
OPT_TOL = 1e-5
OPT_STEPS = 5
OPT_SHAPES = {"w": (512, 384), "b": (2048,), "s": (8, 64, 64)}
OPT_CASES = [
    ("SGD", dict(weight_decay=0.01), 0.1),
    ("Momentum", dict(momentum=0.9, use_nesterov=True, weight_decay=0.01),
     0.05),
    ("Adam", dict(weight_decay=0.01), 0.01),
    ("AdamW", dict(weight_decay=0.05), 0.01),
    ("Adagrad", dict(weight_decay=0.01, initial_accumulator_value=0.1), 0.1),
    ("RMSProp", dict(momentum=0.5, centered=True, weight_decay=0.01), 0.01),
    ("Adamax", dict(weight_decay=0.01), 0.01),
    ("Lamb", dict(lamb_weight_decay=0.01), 0.01),
    ("LarsMomentum", dict(), 0.1),
    ("Adadelta", dict(rho=0.9, epsilon=1e-2, weight_decay=0.01), 1.0),
    ("ASGD", dict(batch_num=3, weight_decay=0.01), 0.1),
    ("Rprop", dict(learning_rate_range=(1e-4, 1.0)), 0.01),
    ("NAdam", dict(weight_decay=0.01), 0.01),
    ("RAdam", dict(weight_decay=0.01), 0.01),
    ("LBFGS", dict(history_size=3), 0.1),
]
# the masked-attention checks at the train cell's attention shape (b, s,
# q heads, kv heads, d) in bf16, against fp32 on the CPU; the bench.py gate
MASK_SHAPE = (6, 1024, 16, 4, 128)
MASK_TOL = 2e-2
MASK_DROPOUT = 0.1
# the memory lattice on the train cell's model, two steps per point (the
# second one timed: the first pays each point's first pinned and device
# allocations); cut: accum 2 (the cell runs 64)
LATTICE_ACCUM = 2
LATTICE_STEPS = 2
# host residency must lower the peak by 0.8 of the optimizer state (12 B
# per parameter: master, moment1, moment2)
HOST_SAVING_SHARE = 0.8
# Llama-3-8B on one card with the optimizer state in pinned host memory.
# Cut: 16 of its 32 layers.  The card's machine has a 96 GiB memory limit
# (MemTotal 101 GiB); the full model's fp32 AdamW state is 12 B x 8.03 G =
# 96.4 GB (89.7 GiB) and would not fit beside the process, so the depth is
# halved: 4.54 G parameters, 54.5 GB of pinned state.  Width, vocabulary,
# sequence and the optimizer are the model's own.
EIGHT_B_LAYERS = 16
EIGHT_B_SEQ = 2048
EIGHT_B_BUCKET_BYTES = 256 << 20     # 64 Mi fp32 elements a stream bucket
EIGHT_B_LR = 1e-4


def _rel_err(got, want):
    den = want.abs().max().item()
    return (got - want).abs().max().item() / (den if den > 0 else 1.0)


def optimizer_phase(dev):
    """OPT_STEPS eager steps of every optimizer on CUDA parameters in
    lockstep with the same optimizer on the CPU, both fed the same
    gradients each step (seeded CPU draws; for LBFGS the gradients of a
    quadratic at the CPU run's params).  Every parameter of the card run is
    updated in place and lies within OPT_TOL of the CPU run's."""
    import torch
    from paddle_tpu_torch import optimizer as topt

    tgen = torch.Generator().manual_seed(99)
    target = {k: torch.randn(s, generator=tgen)
              for k, s in OPT_SHAPES.items()}
    out = []
    for name, kw, lr in OPT_CASES:
        gen = torch.Generator().manual_seed(SEED)
        p0 = {k: torch.randn(s, generator=gen) for k, s in OPT_SHAPES.items()}
        sides = {}
        for where in ("cpu", dev):
            ps = {k: torch.nn.Parameter(v.clone().to(where))
                  for k, v in p0.items()}
            sides[where] = (ps, getattr(topt, name)(
                learning_rate=lr, parameters=list(ps.items()), **kw))
        ptrs = [p.data_ptr() for p in sides[dev][0].values()]
        for t in range(1, OPT_STEPS + 1):
            ggen = torch.Generator().manual_seed(1000 + t)
            cpu_ps = sides["cpu"][0]
            grads = {k: 2.0 * (cpu_ps[k].detach() - target[k])
                     if name == "LBFGS" else torch.randn(s, generator=ggen)
                     for k, s in OPT_SHAPES.items()}
            for where, (ps, opt) in sides.items():
                for k, p in ps.items():
                    p.grad = grads[k].to(where)
                opt.step()
                opt.clear_grad()
        _sync()
        if [p.data_ptr() for p in sides[dev][0].values()] != ptrs:
            raise AssertionError(f"optimizers: {name} did not update the "
                                 f"card's params in place")
        err = max(_rel_err(sides[dev][0][k].detach().cpu(),
                           sides["cpu"][0][k].detach()) for k in p0)
        if not err <= OPT_TOL:
            raise AssertionError(f"optimizers: {name} on the card vs the "
                                 f"CPU: {err} > {OPT_TOL}")
        out.append({"name": name, "err": err, "tol": OPT_TOL})
    return out


def attention_mask_phase(dev):
    """The plain attention path at the train cell's attention shape in
    bf16: an additive-mask call and a dropout call on the card, each
    against fp32 on the CPU (the dropout reference takes the card's mask,
    drawn again from the same seed and copied to the host).  Neither call
    may launch a flash kernel or call a plain flash function; the mask's
    keep rate lies within 3 sigma of 1 - p."""
    import torch
    from paddle_tpu_torch.incubate.nn import attention as tattn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import random as trandom
    from paddle_tpu_torch.ops.nn_ops import scaled_dot_product_attention

    b, s, h, kvh, d = MASK_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, s, h, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, s, kvh, d, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, s, kvh, d, device=dev, generator=gen).bfloat16()
    # an additive bias with a tenth of the pairs pushed to -1e4
    add = torch.randn(b, 1, s, s, device=dev, generator=gen)
    add = add.masked_fill(torch.rand(b, 1, s, s, device=dev, generator=gen)
                          < 0.1, -1e4)
    p = MASK_DROPOUT
    calls = {"additive": lambda: tattn.flash_attention(q, k, v, causal=True,
                                                       attn_mask=add),
             "dropout": lambda: tattn.flash_attention(q, k, v, causal=True,
                                                      dropout=p)}
    with plain_call_counter() as plain:
        fa.reset_launches()
        out = {"additive": calls["additive"]()}
        trandom.seed(SEED)
        out["dropout"] = calls["dropout"]()
        _sync()
        launches = dict(fa.LAUNCHES)
    check_launches("attention masks", launches, plain)
    trandom.seed(SEED)
    mask = trandom.bernoulli(1 - p, (b, h, s, s), dev).cpu()
    keep = mask.float().mean().item()
    sigma = (p * (1 - p) / mask.numel()) ** 0.5
    if not abs(keep - (1 - p)) <= 3 * sigma:
        raise AssertionError(f"attention masks: keep rate {keep}, expected "
                             f"{1 - p} within {3 * sigma}")
    qc = q.float().cpu()
    kc, vc = (x.float().cpu().repeat_interleave(h // kvh, dim=2)
              for x in (k, v))
    want = {"additive": scaled_dot_product_attention(
                qc, kc, vc, attn_mask=add.cpu(), is_causal=True),
            "dropout": scaled_dot_product_attention(
                qc, kc, vc, dropout_mask=mask, dropout_p=p, is_causal=True)}
    result = {"shape": MASK_SHAPE, "dtype": "bf16", "dropout": p,
              "keep_rate": keep, "keep_sigma": sigma, "launches": launches,
              "tol": MASK_TOL}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    for name, got in out.items():
        err = _rel_err(got.float().cpu(), want[name])
        if not err <= MASK_TOL:
            raise AssertionError(f"attention masks: {name} call vs fp32 "
                                 f"CPU: {err} > {MASK_TOL}")
        ms, lo, hi = timing(calls[name], 10, flush)
        result[name] = {"err": err, "ms": ms, "ms_min": lo, "ms_max": hi}
    del flush
    torch.cuda.empty_cache()
    return result


def memory_lattice_phase(dev):
    """LATTICE_STEPS steps of the train cell's model (TRAIN_CFG at full
    width and depth, bf16 params, fp32 AdamW masters from the unrounded
    init) per ``MEMORY_LATTICE`` point, at accum LATTICE_ACCUM, each from
    the same params and a fresh state: the first step's loss within
    TRAIN_LOSS_TOL of the none/device point's, the peak allocated bytes
    over the steps, ms per step (the last step's), and exact B1/B2 launch
    counts (B1 once per layer and micro-step, twice under a checkpointed
    policy; B2 once; no plain call).  Host residency must lower the peak
    by HOST_SAVING_SHARE of the 12 B per parameter of optimizer state at
    every remat policy that has both residencies.  Garbage of earlier
    phases is collected first, so that no point's peak carries it."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import memory as M

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**TRAIN_CFG)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             generator=gen)
    p32 = model.functional_state()
    params0 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    n_params = sum(v.numel() for v in params0.values())
    decay = llama_decay_mask(model)
    rng = np.random.default_rng(SEED)
    shape = (LATTICE_ACCUM, TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           shape)).to(dev)
    layers = cfg.num_hidden_layers
    records = []
    for mc in M.MEMORY_LATTICE:
        opt = AdamW(learning_rate=TRAIN_LR, multi_precision=True)
        params = {k: v.clone() for k, v in params0.items()}
        if mc.optimizer_residency == "host":
            state = M.init_offloaded_state(
                opt, params, decay_mask=decay, master_from=p32,
                bucket_bytes=mc.stream_bucket_bytes)
            host_bytes = M.offloaded_bytes(state)
        else:
            state = opt.init_flat_state(params, decay_mask=decay,
                                        master_from=p32)
            host_bytes = 0
        step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                                accum_steps=LATTICE_ACCUM, memory=mc)
        _sync()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        carry = [params, state]
        del params, state
        losses, walls, params, state, counts, plain = train_steps(
            step, carry, LATTICE_STEPS, ids, labels)
        peak = torch.cuda.max_memory_allocated()
        micro = layers * LATTICE_ACCUM * LATTICE_STEPS
        check_launches(f"memory lattice {mc.label()}", counts, plain,
                       flash_attention_fwd=micro * (
                           2 if mc.resolve_remat()[0] else 1),
                       flash_attention_bwd=micro)
        records.append({"label": mc.label(), "config": mc.to_json(),
                        "loss": losses[0], "losses": losses,
                        "ms_per_step": walls[-1] * 1e3,
                        "step_ms": [w * 1e3 for w in walls],
                        "peak_bytes": peak, "resident_bytes": resident,
                        "host_state_bytes": host_bytes, "launches": counts})
        del params, state, step, opt, carry
        gc.collect()
        torch.cuda.empty_cache()
    by = {r["label"]: r for r in records}
    ref = by["none/device"]["loss"]
    for r in records:
        rel = abs(r["loss"] - ref) / abs(ref)
        if not (np.isfinite(r["loss"]) and rel <= TRAIN_LOSS_TOL):
            raise AssertionError(f"memory lattice {r['label']}: loss "
                                 f"{r['loss']} vs none/device {ref}")
    need = HOST_SAVING_SHARE * 12 * n_params
    savings = {}
    for remat in ("none", "dots", "names"):
        saved = by[f"{remat}/device"]["peak_bytes"] \
            - by[f"{remat}/host"]["peak_bytes"]
        savings[remat] = saved
        if not saved >= need:
            raise AssertionError(f"memory lattice: host residency saved "
                                 f"{saved} B of peak at {remat}, expected "
                                 f">= {need:.0f}")
    del model, p32, params0
    torch.cuda.empty_cache()
    return {"config": TRAIN_CFG, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "accum": LATTICE_ACCUM, "n_params": n_params, "points": records,
            "host_peak_savings": savings, "required_saving": need}


def host_link(dev, gib=2):
    """The card's link to pinned host memory: GB/s of one ``gib`` GiB copy
    host to device, device to host, and both at once on two streams (the
    offloaded update's two copy lanes); and the host's physical memory."""
    import torch

    n = gib << 30
    hosts = [torch.empty(n, dtype=torch.uint8, pin_memory=True)
             for _ in range(2)]
    cards = [torch.empty(n, dtype=torch.uint8, device=dev) for _ in range(2)]
    lanes = [torch.cuda.Stream(dev) for _ in range(2)]

    def timed(*copies):
        _sync()
        t0 = time.perf_counter()
        for lane, (dst, src) in zip(lanes, copies):
            with torch.cuda.stream(lane):
                dst.copy_(src, non_blocking=True)
        _sync()
        return len(copies) * n / (time.perf_counter() - t0) / 1e9

    timed((cards[0], hosts[0]), (hosts[1], cards[1]))     # warm-up
    out = {"h2d_gb_per_s": timed((cards[0], hosts[0])),
           "d2h_gb_per_s": timed((hosts[1], cards[1])),
           "both_gb_per_s": timed((cards[0], hosts[0]),
                                  (hosts[1], cards[1])),
           "host_physical_bytes": os.sysconf("SC_PHYS_PAGES")
           * os.sysconf("SC_PAGE_SIZE")}
    del hosts, cards
    return out


def _checked_offloaded_update(dev, picks, report):
    """A stand-in for ``apply_flat_offloaded`` that, before the streamed
    update, copies the ``picks`` buckets (group, index) of master, moment1
    and moment2 to the card and computes their AdamW update there from the
    same packed gradients; after it, the streamed host buckets and the
    params' slices must equal that recomputation bit for bit."""
    import torch
    from paddle_tpu_torch.parallel import memory as M

    real = M.apply_flat_offloaded

    def update(optimizer, params, grads, state, lr, step, decay_mask=None,
               **kw):
        groups = {g["name"]: g
                  for g in optimizer._flat_groups(params, decay_mask)}
        want = []
        for gname, i in picks:
            g, gs = groups[gname], state["__offload__"][gname]
            i = i % len(gs["moment1"])
            off = sum(b.numel() for b in gs["moment1"][:i])
            size = gs["moment1"][i].numel()
            spans = M._key_spans(g)
            gbuf = torch.empty(size, dtype=torch.float32, device=dev)
            new = optimizer._flat_group_update(
                M._pack(gbuf, lambda k: grads[k].reshape(-1), spans, off,
                        size),
                gs["moment1"][i].to(dev), gs["moment2"][i].to(dev),
                gs["master"][i].to(dev), lr, step, g["decay"])
            want.append((gname, i, off, size, spans, new))
        out = real(optimizer, params, grads, state, lr, step,
                   decay_mask=decay_mask, **kw)
        _sync()
        for gname, i, off, size, spans, (master, m1, m2) in want:
            gs = state["__offload__"][gname]
            same = all(torch.equal(gs[key][i], val.cpu()) for key, val in
                       (("master", master), ("moment1", m1),
                        ("moment2", m2)))
            same = same and all(
                torch.equal(params[k].view(-1)[src],
                            master[dst].to(params[k].dtype))
                for k, src, dst in M._pieces(spans, off, size))
            report.append({"group": gname, "bucket": i, "offset": off,
                           "size": size, "bit_equal": same})
            if not same:
                raise AssertionError(f"llama3_8b: streamed bucket {gname}"
                                     f"[{i}] differs from the on-card "
                                     f"recomputation")
        return out

    return update


def llama3_8b_phase(dev):
    """Llama-3-8B at full width, EIGHT_B_LAYERS deep (the host-RAM cut),
    on one card: bf16 params from SEED, seq EIGHT_B_SEQ, batch 1, AdamW
    with the fp32 state in pinned host memory (EIGHT_B_BUCKET_BYTES
    buckets): two steps under MemoryConfig(remat="full",
    optimizer_residency="host"), then one under remat="offload" on the same
    state.  Before the second step three buckets (the first and last of the
    decay group, the no-decay group's) are recomputed on the card and must
    equal the streamed result bit for bit.  Every B1/B2 call a kernel
    launch (B1 twice per layer, B2 once), losses finite.  Prints peak
    device bytes, pinned host bytes, ms per step, tokens/s and MFU (6 N per
    token over 989 TFLOP/s), and first the host link's copy rates
    (``host_link``), the yardstick of the step's state stream."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import memory as M

    host_cache_emptied = hasattr(torch._C, "_host_emptyCache")
    link = host_link(dev)
    if host_cache_emptied:          # earlier phases' cached pinned blocks
        torch._C._host_emptyCache()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=EIGHT_B_LAYERS,
                              max_position_embeddings=EIGHT_B_SEQ)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=gen)
    params = model.functional_state()
    n_params = sum(v.numel() for v in params.values())
    opt = AdamW(learning_rate=EIGHT_B_LR, multi_precision=True)
    t0 = time.perf_counter()
    state = M.init_offloaded_state(opt, params,
                                   decay_mask=llama_decay_mask(model),
                                   bucket_bytes=EIGHT_B_BUCKET_BYTES)
    init_s = time.perf_counter() - t0
    host_bytes = M.offloaded_bytes(state)
    buckets = sum(len(gs["moment1"]) for gs in state["__offload__"].values())
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (1, EIGHT_B_SEQ))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, EIGHT_B_SEQ))).to(dev)
    layers = cfg.num_hidden_layers
    runs, checked = [], []
    torch.cuda.reset_peak_memory_stats()
    schedule = [M.MemoryConfig(remat="full", optimizer_residency="host",
                               stream_bucket_bytes=EIGHT_B_BUCKET_BYTES)] * 2 \
        + [M.MemoryConfig(remat="offload", optimizer_residency="host",
                          stream_bucket_bytes=EIGHT_B_BUCKET_BYTES)]
    for i, mc in enumerate(schedule):
        step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                                memory=mc)
        real = M.apply_flat_offloaded
        if i == 1:
            M.apply_flat_offloaded = _checked_offloaded_update(
                dev, [("decay|bfloat16", 0), ("decay|bfloat16", -1),
                      ("nodecay|bfloat16", 0)], checked)
        carry = [params, state]
        del params, state
        try:
            losses, walls, params, state, counts, plain = train_steps(
                step, carry, 1, ids, labels, first=i, lr=EIGHT_B_LR)
        finally:
            M.apply_flat_offloaded = real
        check_launches(f"llama3_8b step {i} ({mc.label()})", counts, plain,
                       flash_attention_fwd=2 * layers,
                       flash_attention_bwd=layers)
        if not np.isfinite(losses[0]):
            raise AssertionError(f"llama3_8b: step {i} loss {losses[0]}")
        tokens_per_s = EIGHT_B_SEQ / walls[0]
        runs.append({"step": i, "memory": mc.label(), "loss": losses[0],
                     "ms": walls[0] * 1e3, "tokens_per_s": tokens_per_s,
                     "mfu": 6 * n_params * tokens_per_s / H100_BF16_PEAK,
                     "launches": counts})
    if len(checked) != 3:
        raise AssertionError(f"llama3_8b: {len(checked)} buckets checked")
    peak = torch.cuda.max_memory_allocated()
    del model, params, state, step, opt, carry
    torch.cuda.empty_cache()
    if host_cache_emptied:
        torch._C._host_emptyCache()
    return {"layers": layers, "layers_of_model": 32, "seq": EIGHT_B_SEQ,
            "batch": 1, "n_params": n_params, "bucket_bytes":
            EIGHT_B_BUCKET_BYTES, "buckets": buckets,
            "pinned_host_bytes": host_bytes, "state_init_s": init_s,
            "peak_device_bytes": peak, "steps": runs,
            "checked_buckets": checked, "host_link": link}


# ------------------------------------------------ the MoE left-outs
# (GPT-MoE and its train step, MoELayer's dropless path, the capacity EP
# step)

# GPTMoEConfig() at full width and depth: vocab 32000, hidden 1024, 8
# layers (MoE FFN in blocks 1, 3, 5, 7), 16 heads of 64, ffn 4096, 8
# experts, top-2 gshard, capacity factor 1.2, aux weight 0.01
GPT_MOE_BATCH, GPT_MOE_SEQ = 8, 1024
GPT_MOE_WARMUP, GPT_MOE_STEPS = 1, 3
GPT_MOE_LR = 1e-4
# B1/B2 at GPT-MoE's attention: MHA (rep 1), head dim 64
GPT_MOE_ATTN_SHAPE = (GPT_MOE_BATCH, GPT_MOE_SEQ, 16, 16, 64)
# MoELayer(1024, 4096, 8, dropless=True) on 8192 bf16 tokens; the
# capacity-path cross-check on the first MOE_LAYER_CUT of them
MOE_LAYER_SHAPE = (1024, 4096, 8)
MOE_LAYER_TOKENS, MOE_LAYER_CUT = 8192, 2048
MOE_CAPACITY_WARMUP, MOE_CAPACITY_STEPS = 1, 2
# the grouped-matmul kernels by class, as the profiler names them
GROUPED_KERNEL_NAMES = {
    "B7": ("gmm_wgmma_kernel",),
    "B8": ("outer_wgmma_kernel",),
    "other": ("gmm_kernel", "outer_kernel", "gmm_int8", "gmm_split_reduce")}
# attention kernels other than B1/B2's wgmma route: a GPT-MoE step must
# launch none of them
OTHER_ATTENTION = ("masked_fwd", "masked_dkv", "masked_dq", "hb_fwd_kernel",
                   "hb_dkv_kernel", "hb_dq_kernel", "flash_fwd", "flash_bwd",
                   "fmha", "efficient_attention", "sdpa")


def _capacity_moe_reference(x2d, params, pre, cfg):
    """A capacity MoE FFN in plain fp32, independent of the port's code:
    the router softmax, ``top_k`` rounds of argmax over what is left, each
    expert keeping the first ``capacity - filled`` of a round's tokens in
    token order (every routed assignment fills a slot, kept or not), each
    kept token's tanh-gelu FFN output weighted by its raw probability."""
    import torch
    import torch.nn.functional as F
    g, e = x2d.shape[0], cfg.num_experts
    cap = int(cfg.capacity_factor * g * cfg.top_k / e + 1)
    probs = (x2d @ params[pre + "gate.weight"]).softmax(-1)
    remaining = probs.clone()
    filled = [0] * e
    y = torch.zeros_like(x2d)
    for _ in range(cfg.top_k):
        choice = remaining.argmax(-1)
        for ex in range(e):
            rows = (choice == ex).nonzero()[:, 0]
            kept = rows[:max(0, cap - filled[ex])]
            filled[ex] += rows.numel()
            if kept.numel():
                hid = F.gelu(x2d[kept] @ params[pre + "w_up"][ex]
                             + params[pre + "b_up"][ex], approximate="tanh")
                out = hid @ params[pre + "w_down"][ex] \
                    + params[pre + "b_down"][ex]
                y.index_add_(0, kept, probs[kept, ex:ex + 1] * out)
        remaining.scatter_(1, choice[:, None], 0.0)
    return y


def gpt_moe_reference_loss(cfg, params, ids, labels):
    """The mean CE of a plain fp32 GPT-MoE forward on ``params`` (fp32),
    independent of the port's code: einsum attention under a causal mask,
    ``F.layer_norm``, the dense FFN's erf gelu, ``_capacity_moe_reference``
    in the MoE blocks."""
    import torch
    import torch.nn.functional as F
    b, s = ids.shape
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    d = h // nh

    def ln(x, name):
        return F.layer_norm(x, (h,), params[name + ".weight"],
                            params[name + ".bias"], cfg.layer_norm_eps)

    def lin(x, name, bias=True):
        y = x @ params[name + ".weight"]
        return y + params[name + ".bias"] if bias else y

    keep = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
    with torch.no_grad():
        x = params["wte.weight"][ids] + params["wpe.weight"][:s]
        for i in range(cfg.num_hidden_layers):
            pre = f"blocks.{i}."
            q, k, v = lin(ln(x, pre + "ln_1"), pre + "attn.qkv_proj").reshape(
                b, s, 3, nh, d).unbind(2)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
            pr = sc.masked_fill(~keep, float("-inf")).softmax(-1)
            att = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, s, h)
            x = x + lin(att, pre + "attn.out_proj")
            hn = ln(x, pre + "ln_2")
            if (i + 1) % cfg.moe_every == 0:
                x = x + _capacity_moe_reference(
                    hn.reshape(-1, h), params, pre + "mlp.", cfg).reshape(
                        b, s, h)
            else:
                x = x + lin(F.gelu(lin(hn, pre + "mlp.0")), pre + "mlp.2")
            del q, k, v, sc, pr, att, hn
        logits = lin(ln(x, "ln_f"), "lm_head", bias=False)
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, labels[..., None])[..., 0]
        loss = nll.mean().item()
    del x, logits, nll
    torch.cuda.empty_cache()
    return loss


def _device_events(fn):
    """[(name, launches, device ms)] of the device kernels of one call of
    ``fn`` under ``torch.profiler``, and the call's wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA], wall_ms


def _attention_profile(events, wall_ms):
    """A GPT-MoE step's profile: B1/B2 launches by kernel, launches of any
    other attention kernel, device ms by kernel class, idle share, top
    kernels."""
    def total(match):
        return sum(ms for k, _, ms in events if match(k))

    device_ms = sum(ms for _, _, ms in events)
    classes = {
        "B1 hb_fwd_wgmma_kernel": lambda k: "hb_fwd_wgmma_kernel" in k,
        "B2 hb_dkv/hb_dq_wgmma_kernel": lambda k: "hb_dkv_wgmma_kernel" in k
        or "hb_dq_wgmma_kernel" in k,
        "cuBLAS GEMMs": lambda k: any(t in k.lower() for t in (
            "nvjet", "gemm", "cutlass", "sm90_xmma"))}
    by_class = {c: total(m) for c, m in classes.items()}
    by_class["other"] = device_ms - sum(by_class.values())
    top = sorted(events, key=lambda e: e[2], reverse=True)[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_ms_by_class": by_class,
            "b1_b2_launches": {n: sum(c for k, c, _ in events if n in k)
                               for n in ("hb_fwd_wgmma_kernel",
                                         "hb_dkv_wgmma_kernel",
                                         "hb_dq_wgmma_kernel")},
            "other_attention": {k[:80]: c for k, c, _ in events
                                if any(t in k for t in OTHER_ATTENTION)},
            "top_kernels": [{"name": k[:80], "calls": c, "ms": ms}
                            for k, c, ms in top]}


def gpt_moe_train_phase(dev, flush):
    """GPT-MoE's train step at full width and depth (``GPTMoEConfig()``):
    fp32 parameters from the port's generator seeded SEED, the gate weights
    drawn N(0, 1/hidden) from a card generator seeded SEED (the zero init
    sends every token to experts 0 and 1), AdamW at GPT_MOE_LR,
    ``compute_dtype`` bf16, one fixed batch of GPT_MOE_BATCH x GPT_MOE_SEQ
    tokens (numpy seed SEED), GPT_MOE_WARMUP + GPT_MOE_STEPS steps.  Every
    step exactly 8 B1 and 8 B2 launches (one per layer) and no plain call;
    a profiled step holds exactly 8 ``hb_fwd_wgmma_kernel``, 8
    ``hb_dkv_wgmma_kernel`` and 8 ``hb_dq_wgmma_kernel`` and no other
    attention kernel; the losses finite and falling, the step-0 CE within
    TRAIN_LOSS_TOL of ``gpt_moe_reference_loss``.  Then B1/B2 alone at
    the step's attention shape (GPT_MOE_ATTN_SHAPE, bf16) against their
    plain versions, timed.  Reports ms per step, tokens/s, peak device
    bytes, CE and aux per step, each MoE layer's ``tokens_dropped`` per
    step."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (GPTMoEConfig, GPTMoEForCausalLM,
                                         build_moe_train_step)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import random as prandom
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTMoEConfig()
    layers = cfg.num_hidden_layers
    prandom.seed(SEED)
    model = GPTMoEForCausalLM(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    moe_blocks = [blk for blk in model.blocks if blk.use_moe]
    with torch.no_grad():
        for blk in moe_blocks:
            blk.mlp.gate.weight.normal_(0.0, cfg.hidden_size ** -0.5,
                                        generator=g)
    params = model.functional_state()
    n_params = sum(v.numel() for v in params.values())
    rng = np.random.default_rng(SEED)
    shape = (GPT_MOE_BATCH, GPT_MOE_SEQ)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    ref = gpt_moe_reference_loss(cfg, params, ids, labels)
    opt = AdamW(learning_rate=GPT_MOE_LR)
    state = opt.init_state(params)
    step = build_moe_train_step(model, opt, compute_dtype=torch.bfloat16)
    capacity = moe_blocks[0].mlp.gate.capacity(ids.numel(),
                                               cfg.capacity_factor)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    with plain_call_counter() as plain:
        for i in range(GPT_MOE_WARMUP + GPT_MOE_STEPS):
            fa.reset_launches()
            t0 = time.perf_counter()
            ce, aux, params, state = step(params, state, i, GPT_MOE_LR, ids,
                                          labels)
            _sync()
            wall = time.perf_counter() - t0
            counts = dict(fa.LAUNCHES)
            check_launches(f"gpt_moe step {i}", counts, plain,
                           flash_attention_fwd=layers,
                           flash_attention_bwd=layers)
            runs.append({"step": i, "ce": ce.item(), "aux": aux.item(),
                         "ms": wall * 1e3,
                         "tokens_dropped": [float(blk.mlp.tokens_dropped)
                                            for blk in moe_blocks],
                         "launches": counts})
    peak = torch.cuda.max_memory_allocated()
    ces = [r["ce"] for r in runs]
    rel = abs(ces[0] - ref) / abs(ref)
    if not all(np.isfinite([r["ce"] for r in runs] + [r["aux"]
                                                       for r in runs])) \
            or not ces[-1] < ces[0] or not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"gpt_moe: ce {ces}, step-0 {ces[0]} vs fp32 "
                             f"{ref} ({rel})")

    carry = {"params": params, "state": state, "i": len(runs)}

    def one_step():
        _, _, carry["params"], carry["state"] = step(
            carry["params"], carry["state"], carry["i"], GPT_MOE_LR, ids,
            labels)
        carry["i"] += 1

    def counted(prof):
        return (prof["b1_b2_launches"] == dict.fromkeys(
            ("hb_fwd_wgmma_kernel", "hb_dkv_wgmma_kernel",
             "hb_dq_wgmma_kernel"), layers))

    profile, windows = until_counted(
        lambda: _attention_profile(*_device_events(one_step)), counted)
    if not counted(profile) or profile["other_attention"]:
        raise AssertionError(f"gpt_moe profile: B1/B2 "
                             f"{profile['b1_b2_launches']}, other attention "
                             f"{profile['other_attention']} ({windows} "
                             f"windows)")
    profile["windows"] = windows
    parts = gpt_moe_parts(cfg, opt, carry["params"], carry["state"],
                          capacity, flush)
    del params, state, carry, step, opt, model
    torch.cuda.empty_cache()
    kernels = flash_cases(dev, flush, shape=GPT_MOE_ATTN_SHAPE,
                          kinds=("bf16",))
    timed = runs[GPT_MOE_WARMUP:]
    ms = statistics.median(r["ms"] for r in timed)
    return {"config": dataclasses.asdict(cfg), "n_params": n_params,
            "batch": GPT_MOE_BATCH, "seq": GPT_MOE_SEQ, "lr": GPT_MOE_LR,
            "compute_dtype": "bfloat16", "capacity": capacity,
            "gate_init": "N(0, 1/hidden)", "steps": runs,
            "ms_per_step": ms, "tokens_per_s": ids.numel() / ms * 1e3,
            "peak_device_bytes": peak,
            "launches_total": {k: sum(r["launches"][k] for r in runs)
                               for k in runs[0]["launches"]},
            "step0_check": {"kernel_bf16": ces[0], "plain_fp32": ref,
                            "rel": rel, "tol": TRAIN_LOSS_TOL},
            "profile": profile, "parts_ms": parts, "kernels": kernels}


def gpt_moe_parts(cfg, opt, params, state, capacity, flush):
    """Device ms of two pieces of the GPT-MoE step, each alone (CUDA
    events, L2 flushed): one MoE layer's routing masks
    (``top_k_masks_with_drops`` on the step's [tokens, E] fp32
    probabilities, here a seeded softmax, at its capacity), and the AdamW
    update of every parameter (seeded gradients)."""
    import torch
    from paddle_tpu_torch.incubate.distributed.models.moe.gate import \
        top_k_masks_with_drops
    dev = next(iter(params.values())).device
    g = torch.Generator(device=dev).manual_seed(SEED)
    probs = torch.randn(GPT_MOE_BATCH * GPT_MOE_SEQ, cfg.num_experts,
                        generator=g, device=dev).softmax(-1)
    masks = time_ms(lambda: top_k_masks_with_drops(probs, cfg.top_k,
                                                   capacity), 5, flush)
    grads = {k: torch.randn(v.shape, generator=g, device=dev)
             for k, v in params.items()}
    update = time_ms(lambda: opt.apply(params, grads, state, GPT_MOE_LR,
                                       GPT_MOE_WARMUP + GPT_MOE_STEPS + 1),
                     3, flush)
    del probs, grads
    torch.cuda.empty_cache()
    return {"routing_masks_one_layer_forward": masks,
            "adamw_update": update}


@contextlib.contextmanager
def grouped_recorder():
    """Record every ``grouped_matmul_raw`` / ``grouped_outer_raw`` call
    while the block runs (their wrappers' callers look them up at call
    time): [(op, arguments, keywords, output)]."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    calls = []
    saved = gm.grouped_matmul_raw, gm.grouped_outer_raw

    def matmul(*a, **kw):
        out = saved[0](*a, **kw)
        calls.append(("t" if kw.get("transpose_w") else "fwd", a, kw, out))
        return out

    def outer(*a, **kw):
        out = saved[1](*a, **kw)
        calls.append(("outer", a, kw, out))
        return out

    gm.grouped_matmul_raw, gm.grouped_outer_raw = matmul, outer
    try:
        yield calls
    finally:
        gm.grouped_matmul_raw, gm.grouped_outer_raw = saved


def _gmm_inp(op, a):
    """A recorded float B7/B8 call as a GMM_CASES-style input dict."""
    import torch
    if op == "outer":
        x, dy, starts, lens, bm = a
        wids = torch.arange(lens.shape[0], dtype=torch.int32,
                            device=lens.device)
        return dict(op=op, x=x, dy=dy, starts=starts, lens=lens, bm=bm,
                    wids=wids, scale=None)
    x, w, starts, lens, wids, bm = a[:6]
    return dict(op=op, x=x, w=w, starts=starts, lens=lens, wids=wids, bm=bm,
                scale=None, dy=None)


def moe_layer_phase(dev, flush):
    """``MoELayer(*MOE_LAYER_SHAPE, dropless=True)`` on the card: the
    experts' ``RandomState(0)`` draws, the gate N(0, 1/d_model) from a card
    generator seeded SEED, x bf16 [MOE_LAYER_TOKENS, d_model] N(0, 1) with
    ``requires_grad``, one forward and backward (of the summed square of
    the output).  Exactly 2 B7 forward, 2 B7 dx, 2 B8 launches and no plain
    call, by the wrappers and, over one more forward and backward, by the
    profiler (4 ``gmm_wgmma_kernel``, 2 ``outer_wgmma_kernel``, no other
    grouped kernel); each call's output against its plain version on the
    same inputs
    (per-row gate); each call timed (L2 flushed) beside its bound, its
    plain version and ``torch._grouped_mm``; the layer's output on the
    first MOE_LAYER_CUT tokens against the capacity path at capacity =
    the token count (nothing drops), within TRAIN_LOSS_TOL."""
    import torch
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
        DROPLESS_BLOCK_ROWS, _moe_forward_op)
    from paddle_tpu_torch.ops import grouped_matmul as gm

    m, h, e = MOE_LAYER_SHAPE
    layer = MoELayer(m, h, e, dropless=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        layer.gate.weight.normal_(0.0, m ** -0.5, generator=g)
    x = torch.randn(MOE_LAYER_TOKENS, m, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_()
    with moe_counter() as plain, grouped_recorder() as calls:
        t0 = time.perf_counter()
        y = layer(x)
        y.float().square().sum().backward()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(gm.LAUNCHES)
    want = dict(grouped_matmul=2, grouped_matmul_int8=0, grouped_matmul_t=2,
                grouped_outer=2)
    if launches != want or plain["grouped_matmul_plain"] or \
            plain["grouped_outer_plain"]:
        raise AssertionError(f"moe_layer: launches {launches} (expected "
                             f"{want}), calls {plain}")
    # the same forward and backward under the profiler: exactly 4 B7
    # (gmm_wgmma_kernel: 2 forward, 2 dx) and 2 B8 (outer_wgmma_kernel)
    # launches, no other grouped kernel
    def fwd_bwd():
        layer(x.detach().requires_grad_()).float().square().sum().backward()

    def window():
        events, _ = _device_events(fwd_bwd)
        return {n: sum(c for k, c, _ in events if any(t in k for t in ts))
                for n, ts in GROUPED_KERNEL_NAMES.items()}

    want_profiled = {"B7": 4, "B8": 2, "other": 0}
    profiled, windows = until_counted(window,
                                      lambda got: got == want_profiled)
    if profiled != want_profiled:
        raise AssertionError(f"moe_layer profile: {profiled} (expected "
                             f"{want_profiled}, {windows} windows)")
    names = {"fwd": "grouped_matmul", "t": "grouped_matmul_t",
             "outer": "grouped_outer"}
    records = []
    with torch.no_grad():
        for op, a, kw, out in calls:
            inp = _gmm_inp(op, a)
            err, abs_err = row_error(out, _gmm_call(inp, plain=True))
            if not err <= ROW_TOL["bf16"]:
                raise AssertionError(f"moe_layer {names[op]}: per-row error "
                                     f"{err} > {ROW_TOL['bf16']}")
            nbytes, ops = gmm_work(inp)
            bms, by = bound(nbytes, ops, "bf16")
            lib, call = _gmm_library(inp)
            ms, lo, hi = timing(lambda: _gmm_call(inp), 10, flush)
            records.append(dict(
                name=names[op], op=op, shape=(f"rows {inp['x'].shape[0]} K "
                                              f"{inp['x'].shape[1]} out "
                                              f"{out.shape[-1]}"),
                lens=inp["lens"].tolist(), err=err, tol=ROW_TOL["bf16"],
                max_abs_err=abs_err, ms=ms, ms_min=lo, ms_max=hi,
                plain_ms=time_ms(lambda: _gmm_call(inp, plain=True), 1, flush),
                bound_ms=bms, bound_by=by, tflops=ops / ms / 1e9,
                library_ms=None if lib is None else time_ms(lib, 10, flush),
                library_call=call))
    del calls, y
    with torch.no_grad():
        xs = x[:MOE_LAYER_CUT].detach()
        yd = layer(xs)
        bf = {n: getattr(layer, n).to(torch.bfloat16)
              for n in ("w_up", "b_up", "w_down", "b_down")}
        yc, _, dropped = _moe_forward_op(
            xs, layer.gate.weight, bf["w_up"], bf["b_up"], bf["w_down"],
            bf["b_down"], topk=layer.gate.topk, capacity=MOE_LAYER_CUT)
        cut_err = ((yd.float() - yc.float()).abs().max()
                   / yc.float().abs().max()).item()
    if float(dropped) != 0.0 or not cut_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"moe_layer: dropless vs capacity {cut_err} "
                             f"(dropped {float(dropped)})")
    rec = dict(shape=MOE_LAYER_SHAPE, tokens=MOE_LAYER_TOKENS,
               block_rows=DROPLESS_BLOCK_ROWS, launches=launches,
               profiled_launches=profiled, profile_windows=windows,
               fwd_bwd_wall_ms=wall_ms, aux=layer.l_aux.item(),
               calls=records,
               capacity_cut=dict(tokens=MOE_LAYER_CUT, rel=cut_err,
                                 tol=TRAIN_LOSS_TOL))
    del layer, x, xs, yd, yc, bf
    torch.cuda.empty_cache()
    return rec


def moe_capacity_phase(dev):
    """The capacity EP step (``build_moe_ep_train_step``, degree 1) and the
    dropless one at the MoE train cell's shape (MOE_TRAIN_CFG, capacity
    factor 1.2, the cell's inputs from SEED, lr MOE_TRAIN_LR), each from
    the same parameters: MOE_CAPACITY_WARMUP + MOE_CAPACITY_STEPS steps,
    ms per step, the share of top-k assignments dropped, peak device bytes,
    and the tokens whose capacity routing re-picks an expert (the
    reference gate's argmax over underflowed probabilities).  The capacity
    step launches no grouped kernel; the dropless one 2 B7 forward, 1 B7
    dx and 2 B8 a step.  Losses finite."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.parallel.expert import (
        MoEEPConfig, build_moe_ep_dropless_train_step,
        build_moe_ep_train_step)

    cfg = MoEEPConfig(**MOE_TRAIN_CFG)
    params0, x2d, tgt = moe_train_inputs(cfg, dev)
    assignments = MOE_TRAIN_TOKENS * cfg.top_k
    with torch.no_grad():
        # tokens whose second argmax round re-picks the first round's
        # expert: every other probability underflowed to 0, so the argmax
        # of zeros is expert 0, and the capacity gate (as JAX's) adds
        # that expert's output twice; top_k in the dropless path cannot
        probs = torch.softmax(x2d.float() @ params0["gate_w"], dim=-1)
        first = probs.argmax(-1)
        second = probs.scatter(1, first[:, None], 0.0).argmax(-1)
        repicked = int((first == second).sum())
        del probs
    out = {"config": MOE_TRAIN_CFG, "capacity_factor": cfg.capacity_factor,
           "slots_per_expert": cfg.ep_capacity(MOE_TRAIN_TOKENS),
           "tokens": MOE_TRAIN_TOKENS, "lr": MOE_TRAIN_LR,
           "repicked_tokens": repicked}
    for name, step, want in (
            ("capacity", build_moe_ep_train_step(cfg, lr=MOE_TRAIN_LR),
             dict.fromkeys(gm.LAUNCHES, 0)),
            ("dropless", build_moe_ep_dropless_train_step(
                cfg, lr=MOE_TRAIN_LR, block_rows=8),
             dict(grouped_matmul=2, grouped_matmul_int8=0,
                  grouped_matmul_t=1, grouped_outer=2))):
        params = {k: v.clone() for k, v in params0.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, walls, dropped = [], [], []
        for _ in range(MOE_CAPACITY_WARMUP + MOE_CAPACITY_STEPS):
            with moe_counter() as plain:
                t0 = time.perf_counter()
                loss, _, drop, _, params = step(params, x2d, tgt)
                _sync()
                walls.append(time.perf_counter() - t0)
            if dict(gm.LAUNCHES) != want or plain["grouped_matmul_plain"] \
                    or plain["grouped_outer_plain"]:
                raise AssertionError(f"moe_capacity {name}: launches "
                                     f"{gm.LAUNCHES} (expected {want}), "
                                     f"calls {plain}")
            losses.append(loss.item())
            dropped.append(float(drop))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"moe_capacity {name}: losses {losses}")
        out[name] = dict(
            losses=losses, step_ms=[w * 1e3 for w in walls],
            ms_per_step=statistics.median(walls[MOE_CAPACITY_WARMUP:]) * 1e3,
            dropped=dropped, dropped_share=[d / assignments for d in dropped],
            peak_device_bytes=torch.cuda.max_memory_allocated(),
            launches_per_step=want)
        del params, step
    del params0, x2d, tgt
    torch.cuda.empty_cache()
    return out


# the moe_ep phase (ROADMAP A5.3): each EP step on the (1, 1, 1) NCCL mesh
# beside mesh=None at the MoE train cell, and GPT-MoE on ("dp", "ep", "mp")
MOE_EP_WARMUP, MOE_EP_STEPS = 1, 3


def moe_ep_world1(dev, axes):
    """NCCL at world size 1 from a FileStore in a temporary directory and a
    (1, 1, 1) cuda mesh named ``axes`` (the default process group is
    started once and kept for the phase's second mesh)."""
    import tempfile

    import torch.distributed as dist
    from paddle_tpu_torch.parallel import init_mesh

    store = None
    if not dist.is_initialized():
        store = dist.FileStore(os.path.join(
            tempfile.mkdtemp(prefix="moe_ep_"), "store"), 1)
    return init_mesh("cuda", (1, 1, 1), axes, store=store, rank=0,
                     world_size=1)


def _ep_runs(name, build, mesh, params0, x2d, tgt, want):
    """``build(mesh)``'s step for MOE_EP_WARMUP + MOE_EP_STEPS steps from a
    copy of ``params0``: losses, ms per step, the grouped launches of every
    step (each must be ``want``, with no plain call) and the peak."""
    import torch
    from paddle_tpu_torch.ops import grouped_matmul as gm

    step = build(mesh)
    params = {k: v.clone() for k, v in params0.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(MOE_EP_WARMUP + MOE_EP_STEPS):
        with moe_counter() as plain:
            t0 = time.perf_counter()
            loss, _, drop, _, params = step(params, x2d, tgt)
            _sync()
            walls.append(time.perf_counter() - t0)
        if dict(gm.LAUNCHES) != want or plain["grouped_matmul_plain"] \
                or plain["grouped_outer_plain"]:
            raise AssertionError(f"moe_ep {name}: launches {gm.LAUNCHES} "
                                 f"(expected {want}), calls {plain}")
        losses.append(loss.item())
    return {"losses": losses, "step_ms": [w * 1e3 for w in walls],
            "ms_per_step": statistics.median(walls[MOE_EP_WARMUP:]) * 1e3,
            "launches_per_step": want,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def _gpt_moe_ep_runs(dev, mesh):
    """GPT-MoE at ``GPTMoEConfig()`` (gpt_moe_train's weights, gates and
    batch from SEED, AdamW at GPT_MOE_LR, bf16 compute) through
    ``build_moe_train_step`` with ``mesh=None``, then placed on ``mesh`` by
    ``apply_gpt_moe_sharding`` and stepped with ``mesh=``: GPT_MOE_WARMUP +
    GPT_MOE_STEPS steps each, every step GPT-MoE's layers' B1 and B2
    launches and no plain call; ce per step, ms per step, peak bytes."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (GPTMoEConfig, GPTMoEForCausalLM,
                                         apply_gpt_moe_sharding,
                                         build_moe_train_step)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import random as prandom
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTMoEConfig()
    layers = cfg.num_hidden_layers
    prandom.seed(SEED)
    model = GPTMoEForCausalLM(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for blk in model.blocks:
            if blk.use_moe:
                blk.mlp.gate.weight.normal_(0.0, cfg.hidden_size ** -0.5,
                                            generator=g)
    rng = np.random.default_rng(SEED)
    shape = (GPT_MOE_BATCH, GPT_MOE_SEQ)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    out = {}
    for path in ("meshless", "mesh"):
        if path == "mesh":
            apply_gpt_moe_sharding(model, mesh)
        params = model.functional_state()
        if path == "meshless":
            params = {k: v.clone() for k, v in params.items()}
        opt = AdamW(learning_rate=GPT_MOE_LR)
        state = opt.init_state(params)
        step = build_moe_train_step(model, opt, mesh=None if path ==
                                    "meshless" else mesh,
                                    compute_dtype=torch.bfloat16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ces, walls = [], []
        with plain_call_counter() as plain:
            for i in range(GPT_MOE_WARMUP + GPT_MOE_STEPS):
                fa.reset_launches()
                t0 = time.perf_counter()
                ce, _, params, state = step(params, state, i, GPT_MOE_LR,
                                            ids, labels)
                _sync()
                walls.append(time.perf_counter() - t0)
                check_launches(f"moe_ep gpt_moe {path} step {i}",
                               dict(fa.LAUNCHES), plain,
                               flash_attention_fwd=layers,
                               flash_attention_bwd=layers)
                ces.append(ce.item())
        out[path] = {"ce": ces, "step_ms": [w * 1e3 for w in walls],
                     "ms_per_step": statistics.median(
                         walls[GPT_MOE_WARMUP:]) * 1e3,
                     "launches_per_step": {"flash_attention_fwd": layers,
                                           "flash_attention_bwd": layers},
                     "peak_device_bytes": torch.cuda.max_memory_allocated()}
        del params, state, step, opt
    del model
    torch.cuda.empty_cache()
    return out


def moe_ep_phase(dev):
    """Expert parallelism's paths at world size 1 (NCCL, FileStore): the
    dropless and the capacity EP steps (MOE_TRAIN_CFG, the cell's inputs
    from SEED, lr MOE_TRAIN_LR, nothing cut) on the ("dp", "sharding",
    "ep") = (1, 1, 1) mesh beside ``mesh=None``, and GPT-MoE at full width
    and depth on ("dp", "ep", "mp") = (1, 1, 1) beside ``mesh=None``.  One
    step body each: the losses must be equal bit for bit on every step;
    the dropless step 2 B7 forward, 1 B7 dx and 2 B8 launches a step, the
    capacity step none, GPT-MoE 8 B1 and 8 B2 a step, no plain call
    anywhere.  At world size 1 every exchange and gather is the identity:
    the collectives' cost is not measured here."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.parallel.expert import (
        MoEEPConfig, build_moe_ep_dropless_train_step,
        build_moe_ep_train_step)

    cfg = MoEEPConfig(**MOE_TRAIN_CFG)
    dropless = dict(grouped_matmul=2, grouped_matmul_int8=0,
                    grouped_matmul_t=1, grouped_outer=2)
    out = {"config": MOE_TRAIN_CFG, "tokens": MOE_TRAIN_TOKENS,
           "lr": MOE_TRAIN_LR, "mesh": [1, 1, 1]}
    try:
        mesh = moe_ep_world1(dev, ("dp", "sharding", "ep"))
        params0, x2d, tgt = moe_train_inputs(cfg, dev)
        for name, build, want in (
                ("dropless", lambda m: build_moe_ep_dropless_train_step(
                    cfg, m, lr=MOE_TRAIN_LR, block_rows=8), dropless),
                ("capacity", lambda m: build_moe_ep_train_step(
                    cfg, m, lr=MOE_TRAIN_LR),
                 dict.fromkeys(gm.LAUNCHES, 0))):
            runs = {path: _ep_runs(f"{name} {path}", build, m, params0, x2d,
                                   tgt, want)
                    for path, m in (("meshless", None), ("mesh", mesh))}
            if runs["mesh"]["losses"] != runs["meshless"]["losses"]:
                raise AssertionError(f"moe_ep {name}: mesh losses "
                                     f"{runs['mesh']['losses']} != meshless "
                                     f"{runs['meshless']['losses']}")
            runs["mesh_minus_meshless_ms"] = (runs["mesh"]["ms_per_step"]
                                              - runs["meshless"]
                                              ["ms_per_step"])
            out[name] = runs
        del params0, x2d, tgt
        torch.cuda.empty_cache()
        gpt = out["gpt_moe"] = _gpt_moe_ep_runs(
            dev, moe_ep_world1(dev, ("dp", "ep", "mp")))
        if gpt["mesh"]["ce"] != gpt["meshless"]["ce"]:
            raise AssertionError(f"moe_ep gpt_moe: mesh ce {gpt['mesh']['ce']}"
                                 f" != meshless {gpt['meshless']['ce']}")
        gpt["mesh_minus_meshless_ms"] = (gpt["mesh"]["ms_per_step"]
                                         - gpt["meshless"]["ms_per_step"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


# ------------------------------------------------------- hybrid_train phase

# (schedule, num_microbatches) of the hybrid step runs on the train cell's
# 6 rows: gpipe over 2 micro-batches of 3 rows, 1F1B over 3 of 2
HYBRID_RUNS = (("gpipe", 2), ("1F1B", 3))
# the long-context attention shape (b, s, q heads, kv heads, head dim), bf16
SEQ_SHAPE = (1, 8192, 16, 4, 128)
SEQ_TOL = 2e-2
SEQ_REPS = 5


def hybrid_predicted_launches(schedule, m, layers):
    """B1/B2 launches (``flash_attention_fwd``/``_bwd``) a step of the
    hybrid step at world size 1 (pp 1): gpipe runs m ticks, each every
    layer's forward and, in the backward, its backward once; the 1F1B
    executor runs each micro-batch's forward (FWD, no autograd) and
    recomputes it in its BWD before the backward: 2 m forwards a layer."""
    fwd = layers * m * (1 if schedule == "gpipe" else 2)
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": layers * m}


def _hybrid_steps(what, step, grads_fn, params, state, ids, labels, want, m):
    """TRAIN_WARMUP + TRAIN_STEPS steps of ``step`` from (params, state):
    each step exactly ``want`` flash launches and no plain call; losses, ms
    per step, peak bytes, and the B1/B2 kernels per micro-batch of one
    profiled ``grads_fn`` call (best of PROFILE_WINDOWS windows)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    with plain_call_counter() as plain:
        for i in range(TRAIN_WARMUP + TRAIN_STEPS):
            fa.reset_launches()
            t0 = time.perf_counter()
            loss, params, state = step(params, state, i, TRAIN_LR, ids,
                                       labels)
            _sync()
            walls.append(time.perf_counter() - t0)
            check_launches(f"hybrid_train {what} step {i}",
                           dict(fa.LAUNCHES), plain, **want)
            losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    marks = {"hb_fwd": want["flash_attention_fwd"],
             "hb_dkv": want["flash_attention_bwd"],
             "hb_dq": want["flash_attention_bwd"]}

    def counted(calls):
        return all(sum(c for n, c in calls.items() if mk in n) == n_want
                   for mk, n_want in marks.items())

    calls, windows = until_counted(
        lambda: profiled_calls(lambda: grads_fn(params), "hb_"), counted)
    if not counted(calls):
        raise AssertionError(f"hybrid_train {what}: profiled kernels {calls}"
                             f", expected {marks} a step")
    out = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
           "ms_per_step": statistics.median(walls[TRAIN_WARMUP:]) * 1e3,
           "launches_per_step": want, "num_microbatches": m,
           "profiled_per_micro_batch": {
               mk: sum(c for n, c in calls.items() if mk in n) / m
               for mk in marks},
           "profile_windows": windows, "peak_device_bytes": peak}
    print(f"hybrid_train {what}: " + json.dumps(
        {k: out[k] for k in ("losses", "ms_per_step", "launches_per_step",
                             "profiled_per_micro_batch",
                             "peak_device_bytes")}), flush=True)
    return out


def sequence_attention_leg(dev, mesh, flush):
    """Ring and Ulysses attention at world size 1 on the long-context shape
    (SEQ_SHAPE, bf16, causal) against ``flash_attention(causal=True)`` on
    the same inputs and cotangent: the ring is one diagonal hop (one B5
    and one B6 call; B6 at 8K is the dq + dk/dv pair), output and grads
    within SEQ_TOL of the flash call's; Ulysses' exchanges are the identity
    and it must equal the flash call bit for bit (whose route at this shape
    ``flash_attention``'s HB predicate picks).  ms per forward + backward
    call (CUDA events, L2 flushed)."""
    import torch
    from paddle_tpu_torch.incubate.nn.attention import flash_attention
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import (ring_flash_attention,
                                           ulysses_attention)

    b, s, h, kvh, d = SEQ_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)

    q, k, v, w = draw(b, s, h, d), draw(b, s, kvh, d), draw(b, s, kvh, d), \
        draw(b, s, h, d)

    def run(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ins)
        return [o.detach()] + list(torch.autograd.grad(o, ins, w))

    calls = {"flash": lambda a, c, e: flash_attention(a, c, e, causal=True),
             "ring": lambda a, c, e: ring_flash_attention(a, c, e, mesh=mesh),
             "ulysses": lambda a, c, e: ulysses_attention(a, c, e,
                                                          mesh=mesh)}
    hb = fa.hb_bwd_blocks(h // kvh, s, s, d) is not None
    bwd = (("flash_masked_bwd_fused",)
           if fa.flash_bwd_route(s, s, d) == "fused"
           else ("flash_masked_bwd_dq", "flash_masked_bwd_dkv"))
    masked = dict.fromkeys(("flash_masked_fwd",) + bwd, 1)
    want_launches = {"flash": ({"flash_attention_fwd": 1,
                                "flash_attention_bwd": 1} if hb else masked),
                     "ring": masked}
    want_launches["ulysses"] = want_launches["flash"]
    out = {"shape": list(SEQ_SHAPE), "tol": SEQ_TOL}
    ref = None
    for name, fn in calls.items():
        fa.reset_launches()
        with plain_call_counter() as plain:
            got = run(fn)
            counts = dict(fa.LAUNCHES)
        check_launches(f"hybrid_train {name} at {SEQ_SHAPE}", counts, plain,
                       **want_launches[name])
        ms = timing(lambda: run(fn), SEQ_REPS, flush)
        rec = {"launches": {n: c for n, c in counts.items() if c},
               "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2]}
        if ref is None:
            ref = got
        else:
            errs = {key: ((x.float() - y.float()).abs().max()
                          / y.float().abs().max()).item()
                    for key, x, y in zip(("o", "dq", "dk", "dv"), got, ref)}
            rec["rel_err"] = errs
            rec["bitwise"] = all(torch.equal(x, y) for x, y in zip(got, ref))
            if not all(e <= SEQ_TOL for e in errs.values()):
                raise AssertionError(f"hybrid_train {name}: {errs} > "
                                     f"{SEQ_TOL}")
            if name == "ulysses" and not rec["bitwise"]:
                raise AssertionError("hybrid_train: Ulysses at sep 1 is not "
                                     f"flash_attention bit for bit: {errs}")
        out[name] = rec
        print(f"hybrid_train {name} {list(SEQ_SHAPE)}: " + json.dumps(rec),
              flush=True)
    return out


def hybrid_train_phase(dev, flush):
    """The hybrid step (``init_hybrid_state`` + ``build_hybrid_train_step``)
    on the (pp, dp, sharding, sep, mp) = (1, 1, 1, 1, 1) NCCL mesh at world
    size 1 (a new FileStore world), at the train cell's full width and
    depth (TRAIN_CFG, the 6 rows of 1024 tokens from SEED, fp32 weights,
    bf16 compute, per-tensor AdamW at TRAIN_LR), once per HYBRID_RUNS
    schedule, beside ``build_train_step(mesh=None)`` on the same weights
    and rows: 1 + 3 steps each.  Raises where a loss is more than
    TRAIN_LOSS_TOL relative from the meshless step's, where a step's B1/B2
    launches (by the wrappers, and by the profiler over one gradient pass)
    differ from ``hybrid_predicted_launches``, or where a plain version is
    called; then ``sequence_attention_leg``.  At world size 1 every
    exchange is the identity: no collective is timed here."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_hybrid_train_step,
                                         build_train_step, hybrid_mesh,
                                         init_hybrid_state)
    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.default_rng(SEED)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(rng.integers(0, TRAIN_CFG["vocab_size"],
                                        shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, TRAIN_CFG["vocab_size"],
                                           shape)).to(dev)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="hybrid_"),
                                        "store"), 1)
    mesh = hybrid_mesh("cuda", store=store, rank=0, world_size=1)
    out = {"config": TRAIN_CFG, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "mesh": [1, 1, 1, 1, 1], "runs": dict(HYBRID_RUNS),
           "reduced": ["no accumulation: the 6 rows of one micro-step of "
                       "the train cell, split into the runs' micro-batches"]}
    try:
        cfg = LlamaConfig(**TRAIN_CFG)
        layers = cfg.num_hidden_layers
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                                 generator=gen)
        opt = AdamW(learning_rate=TRAIN_LR)
        params = {k: v.clone() for k, v in model.functional_state().items()}
        step = build_train_step(model, opt, compute_dtype=torch.bfloat16)
        out["meshless"] = _hybrid_steps(
            "meshless", step,
            lambda p: step.accumulate(p, ids, labels), params,
            opt.init_state(params), ids, labels,
            hybrid_predicted_launches("gpipe", 1, layers), 1)
        del params, step
        for sched, m in HYBRID_RUNS:
            hs = init_hybrid_state(model, mesh)
            step = build_hybrid_train_step(cfg, opt, mesh,
                                           num_microbatches=m,
                                           compute_dtype=torch.bfloat16,
                                           schedule=sched)
            out[sched] = _hybrid_steps(
                sched, step, lambda p, st=step: st.gradients(p, ids, labels),
                hs, opt.init_state(hs), ids, labels,
                hybrid_predicted_launches(sched, m, layers), m)
            del hs, step
            gc.collect()
        del model
        torch.cuda.empty_cache()
        out["sequence_attention"] = sequence_attention_leg(dev, mesh, flush)
    finally:
        dist.destroy_process_group()
    base = out["meshless"]["losses"]
    rel = {f"{sched}.step{i}": abs(out[sched]["losses"][i] - base[i])
           / abs(base[i]) for sched, _ in HYBRID_RUNS
           for i in range(len(base))}
    out["loss_rel"], out["tol"] = rel, TRAIN_LOSS_TOL
    if not all(x <= TRAIN_LOSS_TOL for x in rel.values()):
        raise AssertionError(f"hybrid_train: losses vs meshless {rel} > "
                             f"{TRAIN_LOSS_TOL}")
    for sched, _ in HYBRID_RUNS:
        ls = out[sched]["losses"]
        if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
            raise AssertionError(f"hybrid_train {sched}: losses {ls} not "
                                 f"finite and falling")
    return out


# the resilient_train phase: the train cell (TRAIN_CFG, batch 6 x 1024)
# at accum 2 through resilient_train_loop on one card, health armed; a NaN
# enters step 1 through the rope table (a float input of the step, never
# the stored params), a kill before step 5 restores the step-3
# checkpoint, a preemption before step 7 drains and reshards live
RESIL_ACCUM = 2
RESIL_STEPS = 8
RESIL_CKPT_EVERY = 3
RESIL_NAN_STEP = 1
RESIL_FAULTS = (("kill", 5), ("preempt", 7))
RESIL_CKPT_FREE_BYTES = 27 << 30     # keep=2 plus one save in flight


@contextlib.contextmanager
def nan_rope(model):
    """One step's float input made non-finite: the model's rope cos table
    at position 0 (the train step reads it in place), restored after."""
    saved = model.rope_cos[0, 0].clone()
    model.rope_cos[0, 0] = float("nan")
    try:
        yield
    finally:
        model.rope_cos[0, 0] = saved


def _fingerprint(tree):
    """A bitwise fingerprint of every tensor of a state: the int64 sum of
    its bytes read as int16 (bf16) or int32 (fp32), on the device."""
    import torch
    out = []
    for t in _tensors(tree):
        v = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out.append(v.sum(dtype=torch.int64))
    return torch.stack(out).cpu().tolist()


@contextlib.contextmanager
def _step_peak(out, key, on):
    """With ``on``: ``out[key]`` = the device bytes the block allocated at
    its peak above what was allocated when it started (a step's transient
    over its resident state)."""
    import torch
    if not on:
        yield
        return
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    out[key] = torch.cuda.max_memory_allocated() - before


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif hasattr(tree, "element_size"):
        yield tree


def resilient_train_phase(dev):
    """``resilient_train_loop`` on one H100 (LocalCluster semantics, the
    harness's scripted FakeCluster) over the train cell's width and depth
    at accum RESIL_ACCUM, with ``health=HealthConfig()``; checks the NaN
    step a bit-exact no-op, the kill restored from the crc-verified step-3
    checkpoint, the replayed losses and the final params bit-equal to an
    uninterrupted run of the same steps (step RESIL_NAN_STEP skipped), and
    B1/B2 launched RESIL_ACCUM x layers times a step execution with no
    plain call."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    sys.path.insert(0, str(HERE / "tests"))
    from torch_fault_injection import FakeCluster, FaultEvent
    from paddle_tpu_torch.distributed import health as th
    from paddle_tpu_torch.distributed.resilience import (ResilienceConfig,
                                                         resilient_train_loop)
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.specs import Mesh

    cfg, model, params, opt, state, n_params = train_setup(dev)
    layers = cfg.num_hidden_layers
    ckpt_bytes = sum(t.numel() * t.element_size()
                     for t in _tensors({"p": params, "s": state}))
    root = tempfile.mkdtemp(prefix="resilient_train_")
    free = shutil.disk_usage(root).free
    if free < RESIL_CKPT_FREE_BYTES:
        raise AssertionError(f"resilient_train: {free} bytes free under "
                             f"{root}, need {RESIL_CKPT_FREE_BYTES}")

    def batch(step):
        rng = np.random.default_rng(SEED + 1000 + step)
        shape = (RESIL_ACCUM, TRAIN_BATCH, TRAIN_SEQ)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
        lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
        return ids.to(dev), lab.to(dev), step == RESIL_NAN_STEP

    # the uninterrupted reference: the same steps, the NaN batch skipped
    plain = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             accum_steps=RESIL_ACCUM)
    rp = {k: v.clone() for k, v in params.items()}
    rs = {"__flat__": {g: {n: t.clone() for n, t in gs.items()}
                       for g, gs in state["__flat__"].items()}}
    ref_losses, t_ref, peak = {}, 0, {}
    for step in range(RESIL_STEPS):
        if step == RESIL_NAN_STEP:
            continue
        ids, lab, _ = batch(step)
        with _step_peak(peak, "plain", step == 0):
            loss, rp, rs = plain(rp, rs, t_ref, TRAIN_LR, ids, lab)
            ref_losses[step] = loss.item()
        t_ref += 1
    del rs
    torch.cuda.empty_cache()

    health = th.HealthConfig()
    probe_ms = []
    real_probe = th.make_probe

    def timed_probe(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_probe(*a, **kw)
        probe_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    th.make_probe = timed_probe
    noop_checks = []

    def step_builder(mesh, specs):
        step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                                accum_steps=RESIL_ACCUM, health=health)

        def step_fn(st, b, health_gates=None, lr_scale=1.0):
            ids, lab, poison = b
            before = _fingerprint(st) if poison else None
            with nan_rope(model) if poison else contextlib.nullcontext(), \
                    _step_peak(peak, "probed", "probed" not in peak):
                loss, p, s, probe = step(st["params"], st["opt"], st["t"],
                                         TRAIN_LR * lr_scale, ids, lab,
                                         health_gates=health_gates)
                loss.item()
            new = {"params": p, "opt": s,
                   "t": st["t"] + (1 if probe["ok"] else 0)}
            if poison:
                noop_checks.append(dict(
                    ok=probe["ok"], same_objects=p is st["params"]
                    and s is st["opt"], t=new["t"] == st["t"],
                    bits_equal=_fingerprint(new) == before))
            return loss, new, probe

        return step_fn

    init = {"params": params, "opt": state, "t": 0}
    del params, state
    cluster = FakeCluster(faults=[FaultEvent(step=s, kind=k)
                                  for k, s in RESIL_FAULTS])
    conf = ResilienceConfig(checkpoint_dir=root,
                            checkpoint_every=RESIL_CKPT_EVERY, keep=2,
                            health=health)
    events, executions, saves = [], [], []

    def on_event(kind, info):
        if kind == "step":
            executions.append((info["step"], info["loss"], info["s"]))
        elif kind == "save":
            saves.append(info)
        else:
            events.append(info["event"].__dict__)

    mgr_restores = []
    from paddle_tpu_torch.distributed.checkpoint import manager as cm
    real_restore = cm.CheckpointManager.restore_latest

    def timed_restore(self, *a, **kw):
        out = real_restore(self, *a, **kw)
        mgr_restores.append(dict(step=out[1], degraded=out[2],
                                 s=self.last_restore_s))
        return out

    cm.CheckpointManager.restore_latest = timed_restore
    try:
        with plain_call_counter() as plain_calls:
            fa.reset_launches()
            t0 = time.perf_counter()
            res = resilient_train_loop(
                mesh_builder=lambda devs: (Mesh((1, 1, 1),
                                                ("dp", "sharding", "mp"),
                                                device_type=dev.type), None),
                init_fn=lambda mesh, specs: init, step_builder=step_builder,
                data_fn=batch, num_steps=RESIL_STEPS, config=conf,
                cluster=cluster, on_event=on_event)
            wall = time.perf_counter() - t0
            counts = dict(fa.LAUNCHES)
    finally:
        th.make_probe = real_probe
        cm.CheckpointManager.restore_latest = real_restore
    del init

    first, replays = {}, {}
    for step, loss, _ in executions:
        (replays if step in first else first)[step] = loss
    n_exec = len(executions)
    want = layers * RESIL_ACCUM * n_exec
    check_launches("resilient_train", counts, dict(plain_calls),
                   flash_attention_fwd=want, flash_attention_bwd=want)
    kinds = [(e["fault"], e["resume_step"], e["steps_replayed"],
              e["checkpointed"], e["reshard_bytes"], e["degraded_steps"])
             for e in events]
    if kinds != [("WorkerLost", 3, 2, False, 0, []),
                 ("Preemption", 7, 0, True, 0, [])]:
        raise AssertionError(f"resilient_train: recoveries {events}")
    rep = res.health
    if rep["stage_counts"]["skip"] != 1 or [
            (q["data_offset"], q["rule"]) for q in rep["quarantined"]] != [
            (RESIL_NAN_STEP, "nonfinite")]:
        raise AssertionError(f"resilient_train: health report {rep}")
    if noop_checks != [dict(ok=False, same_objects=True, t=True,
                            bits_equal=True)]:
        raise AssertionError(f"resilient_train: the NaN step {noop_checks}")
    replay_equal = all(first[s] == v for s, v in replays.items())
    final_equal = all(torch.equal(res.state["params"][k], rp[k])
                      for k in rp)
    loss_equal = all(res.losses[s] == ref_losses[s] for s in ref_losses)
    if sorted(replays) != [3, 4] or not replay_equal or not final_equal \
            or not loss_equal or res.final_step != RESIL_STEPS:
        raise AssertionError(
            f"resilient_train: replays {replays} vs first {first}, final "
            f"params equal {final_equal}, losses equal {loss_equal}")
    gb = ckpt_bytes / 1e9
    save_rows = [dict(step=x["step"], s=x["s"], **x["timings"])
                 for x in saves]
    for r in save_rows:
        r["gb_per_s"] = gb / r["s"]
        r["d2h_gb_per_s"] = gb / r["d2h_s"]
        r["crc_gb_per_s"] = gb / r["crc_s"]
        r["write_gb_per_s"] = gb / r["write_s"]
    restores = [dict(r, gb_per_s=gb / r["s"]) for r in mgr_restores
                if r["step"] > 0]
    del rp, res
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config=TRAIN_CFG, accum=RESIL_ACCUM, steps=RESIL_STEPS,
                checkpoint_every=RESIL_CKPT_EVERY, n_params=n_params,
                reduced=f"accum {RESIL_ACCUM} of {TRAIN_ACCUM}",
                checkpoint_bytes=ckpt_bytes, disk_free_bytes=free,
                recoveries=events, health=rep["stage_counts"],
                executions=[[s, l, t] for s, l, t in executions],
                replayed_losses_bitwise=replay_equal,
                final_params_bitwise=final_equal,
                losses_bitwise=loss_equal, saves=save_rows,
                restores=restores, probe_ms=probe_ms,
                step_peak_bytes_plain=peak["plain"],
                step_peak_bytes_probed=peak["probed"],
                launches=counts, plain_calls=dict(plain_calls),
                launches_per_execution={k: v // n_exec
                                        for k, v in counts.items()},
                wall_s=wall)


# --------------------------------------------------------- serving fleet phase

FLEET_ENGINE = dict(max_slots=8, num_pages=1025, page_size=16,
                    max_seq_len=2048, prefill_token_budget=256,
                    enable_prefix_cache=True)
FLEET_REQUESTS = 16
FLEET_NEW_TOKENS = 32
FLEET_ADMISSION_CAP = 2048       # outstanding tokens a replica
FLEET_STEP_TIMEOUT_S = 1.0       # an 8B unified step is tens of ms
FLEET_HANG_STALL_S = 4.0
FLEET_KILL = (0, 6)              # (replica, its step): mid-decode
FLEET_HANG = (1, 14)
DISAGG_REQUESTS = 8
DISAGG_HOST_TIER_PAGES = 64
# the prefill replica's pool: the 8 prompts' 63 pages overflow its 24, so
# cold prompt pages demote to the host tier (the kill's replays promote
# some); the first DISAGG_REPEAT prompts come back after the first round
# (a returning conversation) and promote theirs
DISAGG_PREFILL_PAGES = 24
DISAGG_REPEAT = 4
DISAGG_KILL = (1, 8)             # the decode replica, mid-decode


def fleet_prompts(cfg):
    """FLEET_REQUESTS prompts of 32-300 tokens, every other one behind a
    shared 64-token system prompt."""
    import numpy as np

    rng = np.random.default_rng(SEED + 18)
    system = rng.integers(1, cfg.vocab_size, (64,)).astype(np.int32)
    out = []
    for i in range(FLEET_REQUESTS):
        if i % 2:
            body = rng.integers(1, cfg.vocab_size,
                                (int(rng.integers(16, 237)),))
            out.append(np.concatenate([system, body.astype(np.int32)]))
        else:
            out.append(rng.integers(1, cfg.vocab_size,
                                    (int(rng.integers(32, 301)),))
                       .astype(np.int32))
    return out


def host_weights(params):
    """The serving cell's weights moved to the host: a checkpoint's form,
    the source a fleet delivers from."""
    return {k: v.detach().cpu() for k, v in params.items()}


# the decode kernels' plain versions
DECODE_PLAIN = ("flash_decode_plain", "split_merge_plain", "paged_decode_plain",
                "paged_split_merge_plain", "ragged_paged_decode_plain")


def _lat_ms(samples):
    import numpy as np
    if not samples:
        return {"p50": None, "p99": None}
    a = np.asarray(samples) * 1e3
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


class _TokenGaps:
    """Steps a router and times its requests' tokens: each request's gaps
    between consecutive committed tokens (the host clock at the end of the
    tick that committed them; tokens committed together are 0 s apart),
    which is the inter-token latency a client sees, and the tick's wall
    time over the tokens it produced, the fleet's amortised cost of a
    token."""

    def __init__(self, router):
        self.router = router
        self.gaps, self.amortised = [], []
        self._n, self._t = {}, {}

    def step(self) -> int:
        t1 = time.perf_counter()
        produced = self.router.step()
        now = time.perf_counter()
        if produced:
            self.amortised.extend([(now - t1) / produced] * produced)
        for rid, q in self.router.requests.items():
            n, old = len(q.emitted), self._n.get(rid, 0)
            if n > old:
                if rid in self._t:
                    self.gaps.append(now - self._t[rid])
                self.gaps.extend([0.0] * (n - old - 1))
                self._n[rid], self._t[rid] = n, now
        return produced

    def record(self) -> dict:
        return {"inter_token_ms": _lat_ms(self.gaps),
                "ms_per_token_amortised": _lat_ms(self.amortised)}


def _pool_bytes(cfg, engine_kw, itemsize=2):
    return (2 * cfg.num_hidden_layers * engine_kw["num_pages"]
            * cfg.num_key_value_heads * engine_kw["page_size"]
            * cfg.head_dim * itemsize)


def _spawns(rs):
    """Each delivery's seconds, staged GB and GB/s."""
    return [{"s": d["s"], "staged_gb": d["staged_bytes"] / 1e9,
             "gb_per_s": d["staged_bytes"] / d["s"] / 1e9,
             "coded": d["coded"]} for d in rs.delivery_log]


def _fleet_run(cfg, host, dev, prompts, faults):
    """One unified fleet of 2 replicas over ``prompts``: scripted faults
    (a kill, a hang, then a drain as the preemption notice) when
    ``faults``.  Checks no request lost or repeated, every attention call a
    B3' launch with no plain call, one plan per topology and, after every
    reap, the device back within one replica's pools of its level before
    the fault."""
    import torch
    sys.path.insert(0, str(HERE / "tests"))
    from torch_fault_injection import FakeReplica, ReplicaFaultEvent
    from paddle_tpu_torch.inference.fleet import (REMOVED, FleetConfig,
                                                  FleetRouter, ReplicaSet,
                                                  RouterConfig)
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    steps = {"n": 0}

    def engine_factory(p):
        eng = ContinuousBatchingEngine(cfg, p, device=dev, **FLEET_ENGINE)
        unified_step = eng._unified_step

        def counted(*a):
            steps["n"] += 1
            return unified_step(*a)

        eng._unified_step = counted
        return eng

    scripts = {}
    if faults:
        scripts = {FLEET_KILL[0]: [ReplicaFaultEvent(step=FLEET_KILL[1],
                                                     kind="kill")],
                   FLEET_HANG[0]: [ReplicaFaultEvent(
                       step=FLEET_HANG[1], kind="hang",
                       stall_s=FLEET_HANG_STALL_S)]}

    def replica_factory(rid, factory, step_timeout_s=0.0):
        return FakeReplica(rid, factory, step_timeout_s=step_timeout_s,
                           script=scripts.get(rid, ()))

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    da.reset_launches()
    with plain_call_counter(da, DECODE_PLAIN) as plain:
        t0 = time.perf_counter()
        rs = ReplicaSet(host, engine_factory,
                        FleetConfig(target_replicas=2,
                                    step_timeout_s=FLEET_STEP_TIMEOUT_S),
                        replica_factory=replica_factory, device=dev)
        router = FleetRouter(rs, RouterConfig(
            admission_token_cap=FLEET_ADMISSION_CAP))
        level = torch.cuda.memory_allocated()
        rids = [router.submit(p, max_new_tokens=FLEET_NEW_TOKENS)
                for p in prompts]
        clock, mem, drain = _TokenGaps(router), [], None
        seen = 0
        while router.pending():
            clock.step()
            recs = router.telemetry["recoveries"]
            done = [ev for ev in recs if ev.replacement_id is not None]
            for ev in done[seen:]:
                mem.append({"fault": ev.fault, "tick": router._tick,
                            "allocated": torch.cuda.memory_allocated()})
            seen = len(done)
            if faults and drain is None and seen == 2:
                # the preemption notice: drain the busiest replica; its
                # in-flight requests complete there, then it is removed
                victim = max(rs.serving(), key=lambda r: (
                    len(router._assigned.get(r.id, {})), -r.id))
                drain = {"replica": victim.id, "tick": router._tick,
                         "in_flight": len(router._assigned.get(victim.id,
                                                               {})),
                         "rep": victim}
                router.drain(victim.id)
            if drain is not None and "removed_tick" not in drain \
                    and drain["rep"].state == REMOVED:
                drain["removed_tick"] = router._tick
                mem.append({"fault": "drain", "tick": router._tick,
                            "allocated": torch.cuda.memory_allocated()})
        _sync()
        wall = time.perf_counter() - t0
    counts = dict(da.LAUNCHES)
    out = router.results()
    reqs = [router.requests[r] for r in rids]
    if sorted(out) != sorted(rids):
        raise AssertionError(f"fleet: requests lost {set(rids) - set(out)}")
    if any(len(out[r]) != FLEET_NEW_TOKENS for r in rids) or any(
            len(q.emitted) != FLEET_NEW_TOKENS for q in reqs):
        raise AssertionError("fleet: a token was lost or emitted twice")
    want = steps["n"] * cfg.num_hidden_layers
    if counts["ragged_paged_decode"] != want or want == 0 or \
            counts["flash_decode"] or counts["paged_decode"] or \
            any(plain.values()):
        raise AssertionError(f"fleet: launches {counts} (expected {want} "
                             f"ragged and no other), plain calls {plain}")
    if rs.telemetry["plans_built"] != 1:
        raise AssertionError(f"fleet: {rs.telemetry['plans_built']} plans "
                             f"for one topology")
    pools = _pool_bytes(cfg, FLEET_ENGINE)
    for m in mem:
        m["minus_level"] = m["allocated"] - level
        if abs(m["minus_level"]) > pools:
            raise AssertionError(
                f"fleet: after the {m['fault']} reap the device holds "
                f"{m['minus_level']} B beyond the 2-replica level (more "
                f"than one replica's pools, {pools} B): a dead replica's "
                f"memory was kept")
    recoveries = [{k: getattr(ev, k) for k in (
        "replica_id", "fault", "died_at_tick", "migrated_requests",
        "replacement_id", "recovery_ticks", "wall_s")}
        for ev in router.telemetry["recoveries"]]
    if faults and sorted(r["fault"] for r in recoveries) != \
            ["ReplicaHung", "ReplicaKilled"]:
        raise AssertionError(f"fleet: recoveries {recoveries}")
    if faults and (drain is None or "removed_tick" not in drain):
        raise AssertionError(f"fleet: the drained replica was not removed "
                             f"({drain})")
    if drain is not None:
        drain.pop("rep")
    rec = dict(
        replicas=2, requests=len(rids), new_tokens=FLEET_NEW_TOKENS,
        ticks=router._tick, wall_s=wall, launches=counts,
        unified_steps=steps["n"], **clock.record(),
        spawns=_spawns(rs), set_telemetry=dict(rs.telemetry),
        router={k: router.telemetry[k] for k in (
            "submitted", "completed", "migrations", "retries")},
        recoveries=recoveries, drain=drain, reap_memory=mem,
        level_bytes=level - base, pools_bytes=pools,
        migrated=[r for r, q in zip(rids, reqs) if q.migrations])
    tokens = [out[r] for r in rids]
    live = rs.serving()[0].engine.params
    return rec, tokens, live, (router, rs)


def _first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _coded_spawn(cfg, host, dev):
    """One spawn with the int8 weight codec: the bytes staged to the card
    must equal the plan's packed wire bytes, and every delivered leaf the
    CPU decode of the packed bytes that crossed, bit for bit."""
    import torch
    from paddle_tpu_torch.inference.fleet import FleetConfig, ReplicaSet
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.parallel import reshard
    from paddle_tpu_torch.parallel.codec import CollectiveCodec, decode_rows

    codec = CollectiveCodec(weight_profile="int8")
    rs = ReplicaSet(host, lambda p: ContinuousBatchingEngine(
        cfg, p, device=dev, **FLEET_ENGINE),
        FleetConfig(target_replicas=1, delivery_codec=codec), device=dev)
    wire = {}
    execute = reshard.execute_encoded

    def capture(packed, path, chunk):
        wire[(path, chunk)] = packed
        return packed

    reshard.execute_encoded = lambda plan, tree, c, **kw: execute(
        plan, tree, c, corrupt=capture, **kw)
    try:
        rep = rs.spawn()
    finally:
        reshard.execute_encoded = execute
    plan = rs.delivery_plan()
    wb = reshard.plan_wire_bytes(plan, codec)
    staged = plan.telemetry["last_staged_bytes"]
    if staged != wb["wire_bytes"] or staged != sum(
            p.nbytes for p in wire.values()):
        raise AssertionError(f"coded spawn: {staged} bytes staged, "
                             f"{wb['wire_bytes']} packed")
    t0 = time.perf_counter()
    got = rep.engine.params
    mismatched = []
    for lp in plan.leaf_plans:
        if not lp.moved:
            raise AssertionError(f"coded spawn: {lp.path} was not delivered "
                                 f"(a source already on the card)")
        leaf = got[lp.path]
        axis = lp.chunk_axis or 0
        spans = lp.chunks if lp.chunk_axis is not None \
            else [(0, leaf.shape[0])]
        for ci, (a, b) in enumerate(spans):
            card = leaf.narrow(axis, a, b - a).cpu()
            cpu = decode_rows(torch.from_numpy(wire[(lp.path, ci)]),
                              card.numel(), codec, "int8",
                              out_dtype=card.dtype).reshape(card.shape)
            if not torch.equal(card, cpu):
                mismatched.append(f"{lp.path}[{ci}]")
    check_s = time.perf_counter() - t0
    if mismatched:
        raise AssertionError(f"coded spawn: card decode differs from the "
                             f"CPU decode at {mismatched[:8]}")
    spawn = _spawns(rs)[0]
    rs.remove(rep)
    del rep, got, wire
    return dict(profile="int8", block=codec.block,
                raw_bytes=wb["raw_bytes"], wire_bytes=wb["wire_bytes"],
                staged_bytes=staged, ratio=wb["ratio"], spawn=spawn,
                leaves=len(plan.leaf_plans),
                chunks=sum(len(lp.chunks) for lp in plan.leaf_plans),
                check_s=check_s)


def _disagg_run(cfg, host, dev, prompts):
    """One prefill and one decode replica, int8 KV, the host tier on, one
    kill of the decode replica mid-decode, then the first DISAGG_REPEAT
    prompts again: no request lost or repeated, every int8 handoff's pages
    and scales the same at both ends, prompt pages demoted to the host
    tier and promoted back by the repeats, the streams teacher-forced
    through the fleet's frozen scales."""
    import numpy as np
    import torch
    sys.path.insert(0, str(HERE / "tests"))
    from torch_fault_injection import FakeReplica, ReplicaFaultEvent
    from paddle_tpu_torch.inference.disagg import (DisaggRouter,
                                                   KVHandoffPlanner)
    from paddle_tpu_torch.inference.fleet import (FleetConfig, ReplicaSet,
                                                  RouterConfig)
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import decode_attention as da

    steps = {"n": 0}
    exported, landed = {}, []     # id(meta) -> export; adoptions
    kw = dict(FLEET_ENGINE, cache_dtype=torch.int8)

    def count(eng):
        unified_step = eng._unified_step

        def counted(*a):
            steps["n"] += 1
            return unified_step(*a)

        eng._unified_step = counted
        return eng

    def prefill_factory(p):
        eng = count(ContinuousBatchingEngine(
            cfg, p, prefill_only=True, device=dev,
            host_tier_pages=DISAGG_HOST_TIER_PAGES,
            **dict(kw, num_pages=DISAGG_PREFILL_PAGES)))
        export = eng.export_handoff

        def keep(slot):
            tree, meta = export(slot)
            exported[id(meta)] = (tree, meta)
            return tree, meta

        eng.export_handoff = keep
        return eng

    def decode_factory(p):
        eng = count(ContinuousBatchingEngine(cfg, p, device=dev, **kw))
        adopt = eng.adopt_request

        def spy(tree, meta, max_new_tokens, rid=None):
            new = adopt(tree, meta, max_new_tokens, rid)
            if new is not None:
                landed.append((
                    id(meta), {k: v.cpu() for k, v in tree.items()},
                    {k: v.cpu().numpy() for k, v in eng.kv_scales.items()}))
            return new

        eng.adopt_request = spy
        return eng

    def replica_factory(rid, factory, step_timeout_s=0.0):
        script = ([ReplicaFaultEvent(step=DISAGG_KILL[1], kind="kill")]
                  if rid == DISAGG_KILL[0] else ())
        return FakeReplica(rid, factory, step_timeout_s=step_timeout_s,
                           script=script)

    gc.collect()
    torch.cuda.empty_cache()
    da.reset_launches()
    with plain_call_counter(da, DECODE_PLAIN) as plain:
        t0 = time.perf_counter()
        rs = ReplicaSet(
            host, decode_factory,
            FleetConfig(pool_targets={"prefill": 1, "decode": 1},
                        step_timeout_s=FLEET_STEP_TIMEOUT_S),
            engine_factories={"prefill": prefill_factory,
                              "decode": decode_factory},
            replica_factory=replica_factory, device=dev)
        router = DisaggRouter(
            rs, RouterConfig(admission_token_cap=FLEET_ADMISSION_CAP),
            planner=KVHandoffPlanner(device=dev))
        clock = _TokenGaps(router)
        rids = [router.submit(p, max_new_tokens=FLEET_NEW_TOKENS)
                for p in prompts]
        while router.pending():
            clock.step()
        first = rs.serving("prefill")[0].engine.prefix_cache.stats()
        repeats = [router.submit(p, max_new_tokens=FLEET_NEW_TOKENS)
                   for p in prompts[:DISAGG_REPEAT]]
        while router.pending():
            clock.step()
        _sync()
        wall = time.perf_counter() - t0
    counts = dict(da.LAUNCHES)
    out = router.results()
    if sorted(out) != sorted(rids + repeats) or any(
            len(out[r]) != FLEET_NEW_TOKENS for r in rids + repeats):
        raise AssertionError("disagg: a request was lost or a token "
                             "emitted twice")
    want = steps["n"] * cfg.num_hidden_layers
    if counts["ragged_paged_decode"] != want or want == 0 or \
            counts["flash_decode"] or counts["paged_decode"] or \
            any(plain.values()):
        raise AssertionError(f"disagg: launches {counts} (expected {want} "
                             f"ragged and no other), plain calls {plain}")
    if len(landed) != router.telemetry["handoffs"] or not landed:
        raise AssertionError(f"disagg: {len(landed)} adoptions for "
                             f"{router.telemetry['handoffs']} handoffs")
    # each adoption's pages equal the export it came from (the meta the
    # router passed on is the export's own), its engine's scales the
    # prefill side's, bit for bit
    for key, tree, scales in landed:
        t, m = exported[key]
        if tree["k"].dtype != torch.int8 or not all(
                np.array_equal(tree[x].numpy(), t[x]) for x in ("k", "v")) \
                or any(not np.array_equal(scales[s], m["kv_scales"][s])
                       for s in scales):
            raise AssertionError("disagg: an int8 handoff's pages or "
                                 "scales differ between the two ends")
    recoveries = [{k: getattr(ev, k) for k in (
        "replica_id", "fault", "died_at_tick", "migrated_requests",
        "replacement_id", "recovery_ticks", "wall_s")}
        for ev in router.telemetry["recoveries"]]
    if [r["fault"] for r in recoveries] != ["ReplicaKilled"]:
        raise AssertionError(f"disagg: recoveries {recoveries}")
    pre = rs.serving("prefill")[0].engine
    cache = pre.prefix_cache.stats()
    if not first["demoted_pages"] or \
            cache["host_hits"] <= first["host_hits"]:
        raise AssertionError(f"disagg: the repeats hit no host-tier page "
                             f"(after the first round {first}, at the "
                             f"end {cache})")
    scales = {k: torch.from_numpy(v).to(dev)
              for k, v in router._fleet_kv_scales.items()}
    live = rs.serving("decode")[0].engine.params
    tf = teacher_forced(cfg, live, list(prompts) + list(
        prompts[:DISAGG_REPEAT]), [out[r] for r in rids + repeats], dev,
        kv_scales=scales)
    rec = dict(
        pools={"prefill": 1, "decode": 1}, cache_dtype="int8",
        host_tier_pages=DISAGG_HOST_TIER_PAGES,
        prefill_pages=DISAGG_PREFILL_PAGES, requests=len(rids),
        repeats=len(repeats),
        repeats_equal=[out[a].tolist() == out[b].tolist()
                       for a, b in zip(rids, repeats)],
        ticks=router._tick, wall_s=wall, launches=counts,
        unified_steps=steps["n"], **clock.record(),
        spawns=_spawns(rs), handoffs=router.telemetry["handoffs"],
        handoffs_mid_decode=router.telemetry["handoffs_mid_decode"],
        handoff_bytes={k: router.planner.telemetry[k]
                       for k in ("bytes_raw", "bytes_wire", "plans_built")},
        handoff_bf16_bytes=2 * router.planner.telemetry["bytes_raw"],
        recoveries=recoveries, prefix_cache_first_round=first,
        prefix_cache=cache, teacher_forced=tf)
    del router, rs, live, pre, exported, landed
    return rec


def serving_fleet_phase(dev, host=None):
    """The serving fleet at the serving cell (Llama-3-8B, full width and
    depth, seeded bf16 weights on the host): a unified fleet of 2 replicas
    without and with faults (kill, hang, drain), one coded spawn, a
    disaggregated int8 fleet with a decode-replica kill."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              max_position_embeddings=2048)
    if host is None:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 generator=gen)
        host = host_weights(model.functional_state())
        del model
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    source_bytes = sum(v.nbytes for v in host.values())
    prompts = fleet_prompts(cfg)

    def done(what):
        print(f"serving_fleet: {what} at {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)

    done("host weights")
    clean, clean_tokens, live, held = _fleet_run(cfg, host, dev, prompts,
                                                 False)
    del live, held
    done("unfaulted fleet")
    faulted, tokens, live, held = _fleet_run(cfg, host, dev, prompts, True)
    done("faulted fleet")
    faulted["teacher_forced"] = teacher_forced(cfg, live, prompts, tokens,
                                               dev)
    del live, held
    done("teacher forcing")
    rids = list(range(len(prompts)))
    faulted["migrated_equal"] = {
        r: {"equal": tokens[r].tolist() == clean_tokens[r].tolist(),
            "first_diff": _first_diff(tokens[r].tolist(),
                                      clean_tokens[r].tolist())}
        for r in faulted["migrated"] if r in rids}
    gc.collect()
    torch.cuda.empty_cache()
    coded = _coded_spawn(cfg, host, dev)
    done("coded spawn")
    gc.collect()
    torch.cuda.empty_cache()
    disagg = _disagg_run(cfg, host, dev, prompts[:DISAGG_REQUESTS])
    done("disaggregated fleet")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        config="llama3_8b", max_position_embeddings=2048,
        source_bytes=source_bytes, engine=FLEET_ENGINE,
        step_timeout_s=FLEET_STEP_TIMEOUT_S, hang_stall_s=FLEET_HANG_STALL_S,
        unfaulted=clean, faulted=faulted, coded=coded, disagg=disagg,
        launches_by_path={
            "serving_fleet": clean["launches"]["ragged_paged_decode"]
            + faulted["launches"]["ragged_paged_decode"],
            "serving_disagg": disagg["launches"]["ragged_paged_decode"]},
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        device_bytes_before=before, wall_s=time.perf_counter() - t0)


def print_serving_fleet(rec, card):
    """The serving_fleet phase's lines, each with the card's string."""
    for name in ("unfaulted", "faulted"):
        r = rec[name]
        print(f"serving_fleet {name}: " + json.dumps(
            {k: r[k] for k in ("replicas", "requests", "ticks", "wall_s",
                               "unified_steps", "inter_token_ms",
                               "ms_per_token_amortised", "spawns",
                               "recoveries", "drain", "reap_memory",
                               "set_telemetry", "router")}
            | ({"teacher_forced": r["teacher_forced"],
                "migrated_equal": r["migrated_equal"]}
               if name == "faulted" else {}))
            + f" ({card})", flush=True)
    c = rec["coded"]
    print("serving_fleet coded spawn: " + json.dumps(
        {k: c[k] for k in ("profile", "block", "raw_bytes", "wire_bytes",
                           "staged_bytes", "ratio", "spawn", "check_s")})
        + f" ({card})", flush=True)
    d = rec["disagg"]
    print("serving_fleet disagg: " + json.dumps(
        {k: d[k] for k in ("pools", "cache_dtype", "prefill_pages",
                           "requests", "repeats", "repeats_equal", "ticks",
                           "wall_s", "inter_token_ms",
                           "ms_per_token_amortised", "spawns", "handoffs",
                           "handoffs_mid_decode", "handoff_bytes",
                           "handoff_bf16_bytes", "recoveries",
                           "prefix_cache_first_round", "prefix_cache",
                           "teacher_forced")})
        + f" ({card})", flush=True)
    print(f"serving_fleet: peak_device_bytes={rec['peak_device_bytes']} "
          f"source_bytes={rec['source_bytes']} launches_by_path="
          f"{json.dumps(rec['launches_by_path'])} wall_s="
          f"{rec['wall_s']:.1f} ({card})", flush=True)


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
    record["build_report"] = build_report()

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
              f"[{r['ms_min']:.4f}, {r['ms_max']:.4f}] "
              f"({r['tflops']:.1f} TFLOP/s) plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']:.4f} [{r['library_call']}]"
              + (f" library_fwd_bwd_ms={r['library_fwd_bwd_ms']:.4f}"
                 if r["library_fwd_bwd_ms"] is not None else "")
              + f" split_ms={json.dumps(r['split_ms'])}", flush=True)
    record["train"] = train_phase(dev)
    print("train: " + json.dumps({k: v for k, v in record["train"].items()
                                  if k != "profile"}), flush=True)
    print("train profile: " + json.dumps(record["train"]["profile"]),
          flush=True)

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    record["masked_kernels"] = masked_cases(dev, flush)
    del flush
    torch.cuda.empty_cache()
    for r in record["masked_kernels"]:
        if "failed" in r:
            print(f"masked {r['case']}[{r['kind']}] FAILED: {r['failed']}",
                  flush=True)
            continue
        print(f"masked {r['case']}[{r['kind']}] {r['shape']}: pairs="
              f"{r['visible_pairs']} dead_rows={r['dead_rows']} err="
              f"{json.dumps(r['err'])} ms={json.dumps(r['times_ms'])} "
              f"bound_ms={json.dumps(r['bound_ms'])}", flush=True)
    record["masked_train"] = masked_train_phase(dev)
    print("masked train: " + json.dumps(
        {k: v for k, v in record["masked_train"].items() if k != "profile"}),
        flush=True)
    print("masked train profile: "
          + json.dumps(record["masked_train"]["profile"]), flush=True)
    record["long_context"] = long_context_phase(dev)
    print("long context: " + json.dumps(record["long_context"]), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    mt = record["mesh_train"] = mesh_train_phase(dev)
    print("mesh_train: " + json.dumps(
        {k: mt[k] for k in ("mesh", "accum", "masked_accum", "reduced",
                            "collectives", "loss_rel", "ms_per_step",
                            "accumulate_ms", "peak_device_bytes",
                            "host_peak_saving", "required_saving")})
        + f" ({card})", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    ot = record["overlap_train"] = overlap_train_phase(dev)
    print("overlap_train: " + json.dumps(
        {k: ot[k] for k in ("mesh", "accum", "masked_accum", "reduced",
                            "loss_rel", "losses_bitwise", "ms_per_step",
                            "turns_ms", "overlap_minus_mesh_ms",
                            "run_ms_per_step", "accumulate_ms",
                            "peak_device_bytes")})
        + f" ({card})", flush=True)
    print("overlap_train remat: " + json.dumps(
        {k: {f: v[f] for f in ("loss", "ms", "peak_device_bytes")}
         for k, v in ot["remat"].items()}) + f" ({card})", flush=True)

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    record["codec"] = codec_phase(dev, flush)
    print(f"codec: {len(record['codec'])} profiles checked ({card})",
          flush=True)
    record["grouped_kernels"] = gmm_cases(dev, flush)
    del flush
    torch.cuda.empty_cache()
    for r in record["grouped_kernels"]:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"grouped {r['name']}[{r['kind']}] {r['shape']}: err="
              f"{r['err']:.3g} (tol {r['tol']}) max_abs_err="
              f"{r['max_abs_err']:.3g} kernel_ms={r['ms']:.4f} "
              f"[{r['ms_min']:.4f}, {r['ms_max']:.4f}] "
              f"({r['tflops']:.1f} TFLOP/s, {r['gbytes_per_s']:.0f} GB/s) "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms={lib} [{r['library_call']}]"
              + (f" device_ms={json.dumps(r['device_ms'])}"
                 if r["device_ms"] else "")
              + (f" other_order={json.dumps(r['other_order'])}"
                 if r["other_order"] else ""), flush=True)
    record["moe_train"] = moe_train_phase(dev)
    print("moe train: " + json.dumps(record["moe_train"]), flush=True)
    record["mixtral"] = moe_serving_phase(dev)
    # the 8B serving model again, from SEED: the paged route checks, then
    # the serving extras.  The extras run after every profiled phase: a
    # profiler window taken after a long unprofiled run that followed an
    # earlier window records few or none of its kernels on this machine
    # (PERF.md §7)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=gen)
    params = model.functional_state()
    record["paged_routes"] = paged_routes(cfg, params, dev)
    print("paged routes: " + json.dumps(record["paged_routes"]), flush=True)
    extras = record["serving_extras"] = serving_extras(
        cfg, model, params, prompts, shared, system, dev)
    print("serving extras ms per decode step (bf16 [int8]): chunked "
          f"{serving['chunked']['ms_per_decode_step']:.2f} "
          f"[{extras['chunked_int8']['ms_per_decode_step']:.2f}], unified "
          f"{serving['unified']['ms_per_decode_step']:.2f} "
          f"[{extras['unified_int8']['ms_per_decode_step']:.2f}] ({card})",
          flush=True)
    host = host_weights(params)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    fleet = record["serving_fleet"] = serving_fleet_phase(dev, host)
    del host
    print_serving_fleet(fleet, card)

    # the training left-outs, after every profiled phase, once the earlier
    # phases' garbage (engines hold their pools in reference cycles) is
    # collected
    gc.collect()
    torch.cuda.empty_cache()
    record["optimizers"] = optimizer_phase(dev)
    print("optimizers (5 eager steps, card vs CPU): " + json.dumps(
        {r["name"]: r["err"] for r in record["optimizers"]}), flush=True)
    record["attention_masks"] = attention_mask_phase(dev)
    print("attention masks: " + json.dumps(record["attention_masks"]),
          flush=True)
    lattice = record["memory_lattice"] = memory_lattice_phase(dev)
    for r in lattice["points"]:
        print(f"memory lattice {r['label']}: loss={r['loss']:.6f} "
              f"peak_bytes={r['peak_bytes']} resident_bytes="
              f"{r['resident_bytes']} host_state_bytes="
              f"{r['host_state_bytes']} step_ms={json.dumps(r['step_ms'])} "
              f"launches={json.dumps(r['launches'])} ({card})", flush=True)
    print("memory lattice host-residency peak savings: "
          + json.dumps(lattice["host_peak_savings"])
          + f" (required {lattice['required_saving']:.0f})", flush=True)
    big = record["llama3_8b"] = llama3_8b_phase(dev)
    for r in big["steps"]:
        print(f"llama3_8b ({big['layers']} of 32 layers) step {r['step']} "
              f"{r['memory']}: loss={r['loss']:.4f} ms={r['ms']:.1f} "
              f"tokens_per_s={r['tokens_per_s']:.1f} mfu={r['mfu']:.4f} "
              f"({card})", flush=True)
    print(f"llama3_8b: n_params={big['n_params']} peak_device_bytes="
          f"{big['peak_device_bytes']} pinned_host_bytes="
          f"{big['pinned_host_bytes']} ({big['buckets']} buckets of "
          f"{big['bucket_bytes']} B, state init {big['state_init_s']:.1f} s)"
          f" checked_buckets={json.dumps(big['checked_buckets'])} "
          f"host_link={json.dumps(big['host_link'])}", flush=True)

    # the MoE left-outs, last: GPT-MoE's train step, MoELayer's dropless
    # path on B7/B8, the capacity EP step beside the dropless one
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gpt = record["gpt_moe_train"] = gpt_moe_train_phase(dev, flush)
    for r in gpt["steps"]:
        print(f"gpt_moe step {r['step']}: ce={r['ce']:.5f} aux={r['aux']:.5f} "
              f"ms={r['ms']:.1f} tokens_dropped="
              f"{json.dumps(r['tokens_dropped'])} ({card})", flush=True)
    print("gpt_moe: " + json.dumps(
        {k: gpt[k] for k in ("n_params", "capacity", "ms_per_step",
                             "tokens_per_s", "peak_device_bytes",
                             "launches_total", "step0_check")})
        + f" ({card})", flush=True)
    print("gpt_moe profile: " + json.dumps(gpt["profile"]), flush=True)
    for r in gpt["kernels"]:
        print(f"kernel {r['name']}[gpt_moe {r['case']}] {r['shape']}: "
              f"err={json.dumps(r['err'])} max_abs_err={r['max_abs_err']:.3g}"
              f" kernel_ms={r['ms']:.4f} [{r['ms_min']:.4f}, "
              f"{r['ms_max']:.4f}] plain_ms={r['plain_ms']:.4f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms="
              f"{r['library_ms']:.4f} ({card})", flush=True)
    layer = record["moe_layer"] = moe_layer_phase(dev, flush)
    del flush
    torch.cuda.empty_cache()
    for r in layer["calls"]:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"moe_layer {r['name']} {r['shape']}: err={r['err']:.3g} "
              f"(tol {r['tol']}) kernel_ms={r['ms']:.4f} [{r['ms_min']:.4f}, "
              f"{r['ms_max']:.4f}] ({r['tflops']:.1f} TFLOP/s) plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms={lib} ({card})", flush=True)
    print("moe_layer: " + json.dumps(
        {k: v for k, v in layer.items() if k != "calls"}), flush=True)
    cap = record["moe_capacity"] = moe_capacity_phase(dev)
    print("moe_capacity: " + json.dumps(cap) + f" ({card})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    ep = record["moe_ep"] = moe_ep_phase(dev)
    for name in ("dropless", "capacity", "gpt_moe"):
        r = ep[name]
        key = "ce" if name == "gpt_moe" else "losses"
        print(f"moe_ep {name}: " + json.dumps(
            {path: {k: r[path][k] for k in (key, "ms_per_step",
                                            "launches_per_step",
                                            "peak_device_bytes")}
             for path in ("meshless", "mesh")})
            + f" mesh_minus_meshless_ms={r['mesh_minus_meshless_ms']:.3f}"
            f" ({card})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    hy = record["hybrid_train"] = hybrid_train_phase(dev, flush)
    del flush
    torch.cuda.empty_cache()
    print("hybrid_train: " + json.dumps(
        {k: hy[k] for k in ("mesh", "runs", "loss_rel", "reduced")}
        | {path: {k: hy[path][k] for k in ("ms_per_step",
                                            "peak_device_bytes")}
           for path in ("meshless",) + tuple(dict(HYBRID_RUNS))})
        + f" ({card})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    rt = record["resilient_train"] = resilient_train_phase(dev)
    print("resilient_train: " + json.dumps(
        {k: rt[k] for k in ("accum", "steps", "reduced", "checkpoint_bytes",
                            "disk_free_bytes", "recoveries", "health",
                            "replayed_losses_bitwise",
                            "final_params_bitwise", "losses_bitwise",
                            "saves", "restores", "probe_ms",
                            "step_peak_bytes_plain",
                            "step_peak_bytes_probed",
                            "launches_per_execution", "wall_s")})
        + f" ({card})", flush=True)
    record["wall_s"] = time.perf_counter() - t0
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    failed = [f"{r['case']}[{r['kind']}]" for r in record["masked_kernels"]
              if "failed" in r]
    if failed:
        raise AssertionError(f"masked kernel phase: {failed} failed")

    source = "paddle_tpu_torch/csrc/decode_attention.cu"
    tpu = "paddle_tpu/ops/pallas/decode_attention.py"
    main_path = {"flash_decode": ("generate", f"{tpu}:45"),
                 "paged_decode": ("chunked", f"{tpu}:177"),
                 "ragged_paged_decode": ("unified", f"{tpu}:177")}
    # each decode kernel's launches on every serving path that runs it
    by_path = {name: {} for name in main_path}
    for path, r in [(p, serving[p]) for p in ("generate", "chunked",
                                              "unified")] + list(
                                                  extras.items()):
        for key in ("launches", "prefill_launches", "decode_launches"):
            tag = path if key == "launches" else f"{path}_{key[:-9]}"
            for name, n in r.get(key, {}).items():
                if n:
                    by_path[name][tag] = n
    by_path["ragged_paged_decode"].update(fleet["launches_by_path"])
    for r in record["kernels"]:
        path = main_path[r["name"]][0]
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']}[{r['case']}] {r['shape']}: "
              f"err={r['err']:.3g} (per-row tol {r['tol']}) "
              f"max_abs_err={r['max_abs_err']:.3g} "
              f"launches={serving[path]['launches'][r['name']]} ({path} "
              f"path) wrapper_ms={r['ms']:.4f} kernel_ms={r['kernel_ms']:.4f} "
              f"{json.dumps(r['device_ms'])} host_ms={r['host_ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={lib} [{r['library_call']}]", flush=True)
    # ms: the kernels' device time (profiler); wrapper_ms: the wrapper by
    # CUDA events, host launch time included, with its min and max
    kernels = []
    for name, (path, replaces) in main_path.items():
        bf16 = next(r for r in record["kernels"]
                    if r["name"] == name and r["case"] == "bf16")
        kernels.append({
            "name": name, "kernel": "+".join(DECODE_KERNELS[name]),
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": serving[path]["launches"][name],
            "launches_by_path": by_path[name],
            "max_abs_err": bf16["max_abs_err"], "ms": bf16["kernel_ms"],
            "device_ms": bf16["device_ms"],
            "wrapper_ms": bf16["ms"], "ms_min": bf16["ms_min"],
            "ms_max": bf16["ms_max"], "host_ms": bf16["host_ms"],
            "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "checked_by": f"kernel phase (bf16, int8, fp32 at the 8B "
                          f"shapes) and the {path} serving path",
            "row_errors": {r["case"]: r["err"] for r in record["kernels"]
                           if r["name"] == name}})
    flash_source = "paddle_tpu_torch/csrc/flash_attention.cu"
    flash_tpu = "paddle_tpu/ops/pallas/flash_attention.py"
    for name, kernel, replaces in (
            ("flash_attention_fwd", "hb_fwd_wgmma_kernel", f"{flash_tpu}:471"),
            ("flash_attention_bwd", "hb_dkv_wgmma_kernel+hb_dq_wgmma_kernel",
             f"{flash_tpu}:592")):
        bf16 = next(r for r in record["flash_kernels"]
                    if r["name"] == name and r["case"] == "bf16")
        kernels.append({
            "name": name, "kernel": kernel, "route": "cuda",
            "source": flash_source,
            "replaces": replaces,
            "launches": record["train"]["launches"][name],
            "launches_by_path": {
                "train": record["train"]["launches"][name],
                "memory_lattice": sum(r["launches"][name]
                                      for r in lattice["points"]),
                "llama3_8b": sum(r["launches"][name]
                                 for r in big["steps"]),
                "gpt_moe_train": gpt["launches_total"][name],
                "moe_ep_gpt_moe_mesh": ep["gpt_moe"]["mesh"][
                    "launches_per_step"][name] * len(
                        ep["gpt_moe"]["mesh"]["ce"]),
                "mesh_train": mt["mesh_step"]["launches"][name],
                "overlap_train": ot["overlap_step"]["launches"][name],
                "overlap_train_remat": ot["remat"]["overlap"]["launches"][
                    name],
                **{f"hybrid_train_{sched}": hy[sched]["launches_per_step"][
                    name] * len(hy[sched]["losses"])
                   for sched, _ in HYBRID_RUNS},
                "resilient_train": rt["launches"][name]},
            "gpt_moe_shape": next(
                {k: r[k] for k in ("shape", "err", "max_abs_err", "ms",
                                   "ms_min", "ms_max", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for r in gpt["kernels"] if r["name"] == name),
            "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
            "ms_min": bf16["ms_min"], "ms_max": bf16["ms_max"],
            "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
            "checked_by": "kernel phase (bf16, fp32 at the bench.py "
                          "attention shape) and the training path",
            "row_errors": {r["case"]: r["err"]
                           for r in record["flash_kernels"]
                           if r["name"] == name}})
    masked_source = "paddle_tpu_torch/csrc/masked_flash_attention.cu"
    for name, kernel, cuda, case, path, line in (
            ("flash_masked_fwd", "fwd", "masked_fwd_wgmma_kernel",
             "packed_docs", "masked_train", 209),
            ("flash_masked_bwd_fused", "fused",
             "masked_dkv_wgmma_kernel<fused>+cast_kernel", "packed_docs",
             "masked_train", 857),
            ("flash_masked_bwd_dq", "dq", "masked_dq_wgmma_kernel",
             "doc_bands_8k", "long_context", 939),
            ("flash_masked_bwd_dkv", "dkv", "masked_dkv_wgmma_kernel<split>",
             "doc_bands_8k", "long_context", 988)):
        route = {"dq": "split", "dkv": "split"}.get(kernel, kernel)
        rows = record["masked_kernels"]
        bf16 = next(r for r in rows if r["case"] == case
                    and r["kind"] == "bf16")
        # B6's yardstick: SDPA's backward alone (its forward+backward in
        # the masked phase's record)
        lib = bf16["times_ms"]["library_fwd" if kernel == "fwd"
                               else "library_bwd"]
        fwd_bwd = bf16["times_ms"]["library_fwd_bwd"]
        kernels.append({
            "name": name, "kernel": cuda, "route": "cuda",
            "source": masked_source,
            "replaces": f"{flash_tpu}:{line}",
            "launches": record[path]["launches"][name],
            "launches_by_path": {
                path: record[path]["launches"][name],
                "mesh_train": mt["mesh_step"]["masked_launches"][name],
                "overlap_train": ot["overlap_step"]["masked_launches"][
                    name],
                "hybrid_train_ring": hy["sequence_attention"]["ring"][
                    "launches"].get(name, 0)},
            "max_abs_err": bf16["max_abs_err"][route],
            "ms": bf16["times_ms"][kernel],
            "wrapper_ms": bf16["times_ms"]["wrapper_" + route],
            "tables_ms": (bf16["times_ms"]["tables_" + route]
                          if kernel != "fwd" else None),
            "plain_ms": bf16["times_ms"]["plain_fwd" if kernel == "fwd"
                                         else "plain_bwd"],
            "bound_ms": bf16["bound_ms"][kernel],
            "bound_by": bf16["bound_by"][kernel],
            "library_ms": lib if isinstance(lib, float) else None,
            "library_fwd_bwd_ms": (fwd_bwd if kernel != "fwd" and
                                   isinstance(fwd_bwd, float) else None),
            "checked_by": f"masked kernel phase ({len(MASKED_CASES)} cases, "
                          f"bf16 and fp32; timed at {case}) and the {path} "
                          f"path",
            "row_errors": {kind: max(max(r["err"][route].values())
                                     for r in rows if r["kind"] == kind)
                           for kind in ("bf16", "fp32")}})
    gmm_source = "paddle_tpu_torch/csrc/grouped_matmul.cu"
    gmm_tpu = "paddle_tpu/ops/pallas/grouped_matmul.py"
    rows = record["grouped_kernels"]
    mixtral = record["mixtral"]
    moe_launches = record["moe_train"]["launches_total"]
    for name, cuda, line, case, kind, launches, ops in (
            ("grouped_matmul_int8", "+".join(GMM_INT8_KERNELS), 82,
             "mixtral_decode_up",
             "int8",
             sum(mixtral[p]["grouped_launches"]["grouped_matmul_int8"]
                 for p in ("chunked", "unified", "generate")),
             ("fwd",)),
            ("grouped_matmul_float", "gmm_wgmma_kernel", 82, "train_fwd",
             "bf16",
             moe_launches["grouped_matmul"] + moe_launches["grouped_matmul_t"],
             ("fwd", "t")),
            ("grouped_outer", "outer_wgmma_kernel", 180, "train_dw", "bf16",
             moe_launches["grouped_outer"], ("outer",))):
        r = next(x for x in rows if x["name"] == case and x["kind"] == kind)
        kernels.append({
            "name": name, "kernel": cuda, "route": "cuda",
            "source": gmm_source,
            "replaces": f"{gmm_tpu}:{line}", "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "ms_min": r["ms_min"], "ms_max": r["ms_max"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "checked_by": f"grouped-matmul kernel phase ({case}[{kind}] "
                          f"timed) and the "
                          + ("Mixtral serving paths" if kind == "int8"
                             else "dropless train step"),
            "row_errors": {f"{x['name']}[{x['kind']}]": x["err"]
                           for x in rows if x["op"] in ops
                           and (x["kind"] == "int8") == (kind == "int8")}})
        if kind != "int8":
            keys = {"grouped_matmul_float": ("grouped_matmul",
                                             "grouped_matmul_t"),
                    "grouped_outer": ("grouped_outer",)}[name]
            kernels[-1]["launches_by_path"] = {
                "moe_train": launches,
                "moe_layer": sum(layer["launches"][k] for k in keys),
                "moe_ep_dropless_mesh": sum(
                    ep["dropless"]["mesh"]["launches_per_step"][k]
                    for k in keys) * len(ep["dropless"]["mesh"]["losses"])}
            kernels[-1]["moe_layer_calls"] = [
                {k: c[k] for k in ("name", "shape", "err", "max_abs_err",
                                   "ms", "ms_min", "ms_max", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
                for c in layer["calls"] if c["name"] in keys]
        if kind == "int8":
            # the serving calls' shapes: decode, unified, prefill
            kernels[-1]["device_ms"] = r["device_ms"]
            kernels[-1]["cases"] = {
                x["name"]: {k: x[k] for k in ("ms", "ms_min", "ms_max",
                                              "device_ms", "bound_ms",
                                              "bound_by", "other_order")}
                for x in rows if x["kind"] == "int8"
                and x["name"].startswith("mixtral_")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# phase name -> its call on a chip_smoke module, for --turns
TURN_PHASES = {
    "moe_train": lambda cs, dev, flush: cs.moe_train_phase(dev),
    "moe_capacity": lambda cs, dev, flush: cs.moe_capacity_phase(dev),
    "gpt_moe_train": lambda cs, dev, flush: cs.gpt_moe_train_phase(
        dev, flush),
    "resilient_train": lambda cs, dev, flush: cs.resilient_train_phase(dev),
    "serving_fleet": lambda cs, dev, flush: cs.serving_fleet_phase(dev),
}


def _summary(rec):
    """A phase record without its long parts (profiles, kernel rows)."""
    if isinstance(rec, dict):
        return {k: _summary(v) for k, v in rec.items()
                if k not in ("profile", "kernels", "steps")}
    return rec


def phase_worker(root: str, phases) -> int:
    """Run ``phases`` of the checkout at ``root`` in this process, on its
    own package and chip_smoke.py; one ``TURN`` JSON line per phase."""
    import importlib.util

    import torch

    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "turn_chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops import _build

    _build.build()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    for name in phases:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = TURN_PHASES[name](cs, dev, flush)
        print("TURN " + json.dumps({
            "root": root, "phase": name, "s": time.perf_counter() - t0,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "record": _summary(rec)}), flush=True)
    return 0


def turns_main(argv) -> int:
    """``--turns OTHER_ROOT --phases a,b``: the phases of OTHER_ROOT, this
    checkout, this checkout, OTHER_ROOT, each turn a fresh process."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--turns", help="the other checkout's root")
    ap.add_argument("--phase-worker", help=argparse.SUPPRESS)
    ap.add_argument("--phases", required=True)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = [p for p in phases if p not in TURN_PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {list(TURN_PHASES)}")
    if args.phase_worker:
        return phase_worker(args.phase_worker, phases)
    if not args.turns:
        ap.error("--turns OTHER_ROOT is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    other = str(Path(args.turns).resolve())
    turns = []
    for root in (other, str(HERE), str(HERE), other):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--phase-worker",
             root, "--phases", args.phases], capture_output=True, text=True,
            cwd=root, timeout=900)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            print(f"turn in {root} failed ({out.returncode})", flush=True)
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("TURN "):
                print(line, flush=True)
                turns.append(json.loads(line[5:]))
    record = HERE / "chiprun_out" / "turns.json"
    record.parent.mkdir(exist_ok=True)
    record.write_text(json.dumps({"card": card, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(turns_main(sys.argv[1:]) if len(sys.argv) > 1 else main())
