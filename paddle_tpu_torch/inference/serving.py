"""Continuous-batching LLM serving engine over a paged KV cache.

Port of ``paddle_tpu/inference/serving.py``.  The host owns scheduling
(slot and page bookkeeping, admission, eviction); the device runs the
model eagerly, with every attention call on a hand-written paged kernel
(``ops/decode_attention.py``):

- the default chunked path: ``_admit`` prefills one prompt (padded to a
  power-of-two bucket >= 16, prompt + generation budget reserved up
  front) and writes its K/V into the slot's pages; ``_decode_chunk`` runs
  ``decode_chunk_steps`` single-token steps for ALL slots through
  ``paged_decode``.  The scheduler runs one chunk ahead: ``step()``
  launches the next chunk against the device-resident token carry BEFORE
  it reads back the previous chunk's tokens (copied to the host
  asynchronously right after that chunk), so host bookkeeping overlaps
  device work.  Masked and overrun slots scribble into a reserved trash
  page;
- the unified ragged path (``prefill_token_budget > 0``): one launch per
  step packs a decode row per decoding slot and up to
  ``prefill_token_budget`` prompt tokens into ``rows [rows_cap, 5]``,
  attends through ``ragged_paged_decode``, gathers the consumed rows
  before the head and samples on the host.  Admission walks the radix
  prefix cache, so a shared system prompt maps its full pages
  copy-on-write and prefills only the private suffix.

Both paths take weight-only int8 dicts (``quantize_params_int8``; the
cache is then bf16, as in the JAX engine) and sparse (MoE) checkpoints,
whose expert FFNs run on the grouped-matmul kernel through
``models/generation.py::_ffn``.

``cache_dtype=torch.int8`` quantizes the cache on both paths with frozen
per-(layer, kv head) scales calibrated on the first prompt (absmax, 2x
headroom): each new K/V row is rounded half away from zero on write, k's
dequant folded into q and v's into the context, so the paged kernels
read int8 pools.  On the unified path a draft model (``draft_params``,
``speculative_k``; ``models/generation.py::self_draft_params``) proposes
up to k tokens per slot, one ragged launch per depth over draft pools that
mirror the target's page geometry; the target verifies each k+1-row
window in its one launch (exact prefix match for greedy requests,
rejection sampling for sampled ones) and the rows are mirrored through
the draft.  The prefix cache can keep a host tier
(``host_tier_pages``: LRU pages demoted to pinned host memory and
promoted back on a hit); ``prefill_only`` engines park completed prompts
for a KV handoff (``export_handoff`` -> ``adopt_request`` on a decode
engine, ``release_handoff``, ``can_adopt``); ``throttle`` sheds the
speculation depth and the prefill budget at run time;
``page_size="auto"`` times the paged kernel per page size
(``tune_page_size``).

Unlike the JAX engine, the page pools are updated IN PLACE (indexed
assignment) instead of being donated through a compiled program: that is
the donation contract ``analysis_entry`` hands the Graph Doctor, on both
paths.  ``param_layout`` is the engine's table for the Sharding Doctor
(``analysis/sharding.py``).
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.generation import (_Weights, _apply_rope, _ffn, _prefill,
                                 _rms_norm, rope_tables_on)
from ..models.llama import _to_torch
from ..ops.decode_attention import (MAX_PAGE_ON_CARD, default_pages_per_step,
                                    paged_decode, ragged_paged_decode)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int
    arrival: float = 0.0
    temperature: float = 0.0            # 0 = greedy
    seed: int = 0                       # per-request sampling stream
    rng: Any = None                     # np.random.Generator at admission


@dataclasses.dataclass
class Finished:
    rid: int
    tokens: np.ndarray                  # generated tokens (incl. first)
    prompt_len: int


def _pool_dtype(params: Dict[str, torch.Tensor]) -> torch.dtype:
    """A model's cache dtype: its first non-scale parameter's, bf16 when
    that is not floating (int8-weight dicts)."""
    dt = next(v for k, v in params.items() if not k.endswith("._scale")).dtype
    return dt if dt.is_floating_point else torch.bfloat16


def _pools(layers, num_pages, kvh, page, d, dtype, device):
    """Per-layer page pools [num_pages, kvh, page, d], zeroed."""
    return [torch.zeros((num_pages, kvh, page, d), dtype=dtype, device=device)
            for _ in range(layers)]


def _softmax_np(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Host-side fp64 softmax over one row of returned logits, so a warm
    prefix-cache request replays the cold request's sampling stream."""
    x = logits.astype(np.float64) / max(float(temperature), 1e-6)
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


class PageAllocator:
    """Host-side physical-page free list with explicit refcounts; reuse is
    LIFO (mirror of ``paddle_tpu.inference.serving.PageAllocator``).
    ``alloc`` hands out a page at refcount 1, every additional sharer
    ``acquire``\\ s it, ``release`` returns it to the free list when the
    count reaches zero.  ``available + live == total`` is a checked
    contract (``assert_consistent``).  Every mutation runs under
    ``_lock``."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.total = num_pages
        self.refs: List[int] = [0] * num_pages
        self._lock = threading.Lock()

    def alloc(self) -> Optional[int]:
        with self._lock:
            if not self.free:
                return None
            p = self.free.pop()
            self.refs[p] = 1
            return p

    def acquire(self, page: int) -> int:
        """Add a reference to an already-live page (prefix sharing)."""
        with self._lock:
            if self.refs[page] <= 0:
                raise AssertionError(
                    f"acquire of dead page {page} (refcount "
                    f"{self.refs[page]}) — prefix-cache/table corruption")
            self.refs[page] += 1
            return page

    def release(self, pages) -> None:
        """Drop one reference per page; a page returns to the free list
        only when its last reference is gone."""
        with self._lock:
            for p in reversed(list(pages)):
                p = int(p)
                if self.refs[p] <= 0:
                    raise AssertionError(
                        f"release of free page {p} — double release")
                self.refs[p] -= 1
                if self.refs[p] == 0:
                    self.free.append(p)

    @property
    def available(self) -> int:
        return len(self.free)

    @property
    def live(self) -> int:
        return sum(1 for r in self.refs if r > 0)

    def assert_consistent(self) -> None:
        """Every page is exactly one of free or live, no refcount is
        negative, free pages carry no references, and the free list holds
        unique in-range ids."""
        with self._lock:
            live = sum(1 for r in self.refs if r > 0)
            if len(self.free) + live != self.total:
                raise AssertionError(
                    f"page pool out of balance: available={len(self.free)} "
                    f"+ live={live} != total={self.total}")
            neg = [p for p, r in enumerate(self.refs) if r < 0]
            if neg:
                raise AssertionError(f"negative refcounts on pages {neg}")
            bad = [p for p in self.free if self.refs[p] != 0]
            if bad:
                raise AssertionError(f"free pages with live refs: {bad}")
            if len(set(self.free)) != len(self.free):
                raise AssertionError("duplicate pages on the free list")
            oob = [p for p in self.free if not 0 <= p < self.total]
            if oob:
                raise AssertionError(f"out-of-range pages on free list: {oob}")

    def assert_balanced(self) -> None:
        """Alias of ``assert_consistent`` (the older leak-check name)."""
        self.assert_consistent()


class _TrieNode:
    """One committed full page of tokens in the prefix cache.  A node lives
    in one of two tiers: ``device`` (``page`` is a live pool page, the trie
    holds one allocator ref) or ``host`` (``page`` is None and ``host_kv``
    holds the page's per-layer K/V pair, each [L, kvh, page, d], in pinned
    host memory on the card)."""

    __slots__ = ("children", "key", "page", "parent", "tick", "host_kv")

    def __init__(self, key=None, page=None, parent=None):
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.key = key
        self.page = page
        self.parent = parent
        self.tick = 0
        self.host_kv = None

    @property
    def tier(self) -> str:
        return "device" if self.host_kv is None else "host"


class PrefixCache:
    """Radix/trie prefix cache over the engine's page pools (mirror of
    ``paddle_tpu.inference.serving.PrefixCache``).

    Keys are page-granular token chunks, values are physical page ids.  A
    node exists only for pages whose prompt tokens a completed prefill
    committed, and the trie holds its own allocator reference on each, so
    cached prefixes outlive their requests and ``lookup`` hands the same
    pages to a new request copy-on-write (it only writes past its private
    suffix).  Eviction is LRU over refcount-1 leaves under pool pressure.

    With a host tier (``host_tier_pages > 0``) pool pressure DEMOTES LRU
    refcount-1 device pages (leaf or interior) to the host through
    ``demote_fn`` instead of evicting them; a lookup that reaches a host
    node PROMOTES it back into a device page (``promote_fn``) and the hit
    proceeds as a device hit.  Only when the host tier overflows its cap
    are LRU host leaves dropped."""

    def __init__(self, page_size: int, alloc: PageAllocator, *,
                 host_tier_pages: int = 0, demote_fn=None,
                 promote_fn=None):
        self.page_size = int(page_size)
        self.alloc = alloc
        self.root = _TrieNode()
        self._tick = 0
        self.hits = 0
        self.lookups = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.host_tier_pages = int(host_tier_pages)
        self.demote_fn = demote_fn
        self.promote_fn = promote_fn
        if self.host_tier_pages > 0 and (demote_fn is None
                                         or promote_fn is None):
            raise ValueError(
                "host_tier_pages > 0 needs demote_fn/promote_fn (the "
                "engine's pool residency hooks)")
        self.host_pages = 0
        self.host_hits = 0
        self.demoted_pages = 0
        self.promoted_pages = 0

    def _chunks(self, tokens, npages: int):
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(npages)]

    def lookup(self, prompt):
        """Walk the trie with the prompt's full pages; returns
        ``(pages, matched_tokens)`` with one allocator ref acquired per
        page.  At most ``(len(prompt) - 1) // page_size`` pages match, so
        the suffix holding the last prompt token is always prefilled.  A
        host node on the path is promoted first; no page to promote into
        ends the walk.  Hit stats are committed by ``record_hit`` once
        admitted."""
        self.lookups += 1
        self._tick += 1
        limit = max(0, (len(prompt) - 1) // self.page_size)
        node = self.root
        pages: List[int] = []
        for key in self._chunks(prompt, limit):
            child = node.children.get(key)
            if child is None:
                break
            # recency first: the promote hook may demote under pressure,
            # and the node being promoted must not be the one dropped
            child.tick = self._tick
            if child.host_kv is not None:
                page = self.promote_fn(child.host_kv)
                if page is None:
                    break
                child.page, child.host_kv = int(page), None
                self.host_pages -= 1
                self.promoted_pages += 1
                self.host_hits += 1
            self.alloc.acquire(child.page)
            pages.append(child.page)
            node = child
        return pages, len(pages) * self.page_size

    def probe(self, prompt) -> int:
        """Matched full-page tokens for ``prompt`` across both tiers, with
        no refs acquired and no stats or LRU change."""
        limit = max(0, (len(prompt) - 1) // self.page_size)
        node = self.root
        matched = 0
        for key in self._chunks(prompt, limit):
            child = node.children.get(key)
            if child is None:
                break
            matched += self.page_size
            node = child
        return matched

    def record_hit(self, matched_tokens: int) -> None:
        if matched_tokens > 0:
            self.hits += 1
            self.hit_tokens += matched_tokens

    def insert(self, prompt, pages) -> int:
        """Commit a completed prefill's full prompt pages; new nodes take a
        trie reference on their page, existing nodes stay.  Returns the
        number of newly committed pages."""
        self._tick += 1
        n = min(len(prompt) // self.page_size, len(pages))
        node = self.root
        added = 0
        for i, key in enumerate(self._chunks(prompt, n)):
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(key, self.alloc.acquire(int(pages[i])),
                                  node)
                node.children[key] = child
                self.inserted_pages += 1
                added += 1
            child.tick = self._tick
            node = child
        return added

    def _nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def evict(self, pages_needed: int) -> int:
        """LRU-evict refcount-1 leaves (trie-only pages) until
        ``pages_needed`` pages were freed or nothing evictable is left; a
        parent that becomes such a leaf joins the heap.  With the host tier
        this demotes instead (``_demote_lru``).  Returns pages freed."""
        if self.host_tier_pages > 0:
            return self._demote_lru(pages_needed)
        freed = 0
        seq = 0                      # tie-break: the heap never compares nodes
        heap = []
        for n in self._nodes():
            if not n.children and self.alloc.refs[n.page] == 1:
                heap.append((n.tick, seq, n))
                seq += 1
        heapq.heapify(heap)
        while freed < pages_needed and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.key]
            self.alloc.release([victim.page])
            self.evicted_pages += 1
            freed += 1
            if (parent is not self.root and not parent.children
                    and self.alloc.refs[parent.page] == 1):
                heapq.heappush(heap, (parent.tick, seq, parent))
                seq += 1
        return freed

    def _demote_lru(self, pages_needed: int) -> int:
        """Demote up to ``pages_needed`` LRU refcount-1 device pages to the
        host tier (their pool pages free), then drop LRU host leaves until
        the tier is back under its cap; a node on the lookup path being
        promoted (tick == the current tick) is never dropped.  Returns
        device pages freed."""
        freed = 0
        seq = 0
        heap = []
        for n in self._nodes():
            if n.host_kv is None and self.alloc.refs[n.page] == 1:
                heap.append((n.tick, seq, n))
                seq += 1
        heapq.heapify(heap)
        while freed < pages_needed and heap:
            _, _, victim = heapq.heappop(heap)
            victim.host_kv = self.demote_fn(victim.page)
            victim.page = None
            self.host_pages += 1
            self.demoted_pages += 1
            freed += 1
        if self.host_pages > self.host_tier_pages:
            trim = []
            for n in self._nodes():
                if (n.host_kv is not None and not n.children
                        and n.tick < self._tick):
                    trim.append((n.tick, seq, n))
                    seq += 1
            heapq.heapify(trim)
            while self.host_pages > self.host_tier_pages and trim:
                _, _, drop = heapq.heappop(trim)
                parent = drop.parent
                del parent.children[drop.key]
                self.host_pages -= 1
                self.evicted_pages += 1
                if (parent is not self.root and not parent.children
                        and parent.host_kv is not None
                        and parent.tick < self._tick):
                    heapq.heappush(trim, (parent.tick, seq, parent))
                    seq += 1
        return freed

    def clear(self) -> None:
        """Drop every trie reference (engine teardown); host payloads hold
        no allocator ref and just drop."""
        for n in list(self._nodes()):
            if n.host_kv is None:
                self.alloc.release([n.page])
        self.root = _TrieNode()
        self.host_pages = 0

    def assert_consistent(self) -> None:
        """Every node lives in exactly one tier; device pages are unique
        across the trie and each holds a live allocator refcount (the
        trie's own reference); ``host_pages`` counts the host nodes."""
        seen: Dict[int, Any] = {}
        host_nodes = 0
        for n in self._nodes():
            has_page = n.page is not None
            has_host = n.host_kv is not None
            if has_page == has_host:
                raise AssertionError(
                    f"trie node {n.key!r} in "
                    f"{'both tiers' if has_page else 'no tier'}")
            if has_host:
                host_nodes += 1
                continue
            if n.page in seen:
                raise AssertionError(
                    f"device page {n.page} held by two trie nodes "
                    f"({seen[n.page]!r} and {n.key!r})")
            seen[n.page] = n.key
            if self.alloc.refs[n.page] <= 0:
                raise AssertionError(
                    f"trie node {n.key!r} holds dead page {n.page} "
                    f"(refcount {self.alloc.refs[n.page]})")
        if host_nodes != self.host_pages:
            raise AssertionError(
                f"host-tier counter drift: counter={self.host_pages} "
                f"actual={host_nodes}")

    @property
    def cached_pages(self) -> int:
        return sum(1 for n in self._nodes() if n.host_kv is None)

    def stats(self) -> Dict[str, int]:
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "cached_pages": self.cached_pages,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages,
                "host_pages": self.host_pages,
                "host_hits": self.host_hits,
                "demoted_pages": self.demoted_pages,
                "promoted_pages": self.promoted_pages}


def _ragged_forward(cfg, w, k_pages, v_pages, cos_tab, sin_tab, rows, tables,
                    pages_per_step, fold=None, gather=None, with_head=True):
    """ONE ragged step of a model over its page pools (the body of
    ``_unified_step_jit``).  ``rows`` [T, 5] int32: (input token, physical
    page for this token's K/V, in-page offset, visibility = position + 1,
    slot); padding rows carry slot -1 / visibility 0 and scatter into the
    trash page.  Every row's K/V is scattered first (a chunk row sees its
    in-chunk predecessors), then one ragged kernel launch per layer.  Over
    int8 pools (``fold``: the engine's frozen scales) the rows' K/V are
    quantized on write, k's dequant folded into q and v's into the
    context.  Returns fp32 logits of the ``gather`` rows (every row without
    it), or None with ``with_head`` False (a draft's cache mirror)."""
    h, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    T = rows.shape[0]
    tok = rows[:, 0]
    phys = rows[:, 1].long()
    off = rows[:, 2].long()
    lens = rows[:, 3].contiguous()
    slot = rows[:, 4].contiguous()
    x = w.embed(tok)                                      # [T, hidden]
    pos = (lens - 1).clamp(min=0).long()
    cos = cos_tab[pos][:, None, :].to(x.dtype)
    sin = sin_tab[pos][:, None, :].to(x.dtype)
    for i in range(cfg.num_hidden_layers):
        xin = _rms_norm(x, w.layer(i, "input_layernorm.weight"),
                        cfg.rms_norm_eps)
        q = (xin @ w.layer(i, "self_attn.q_proj.weight")).reshape(T, h, d)
        k = (xin @ w.layer(i, "self_attn.k_proj.weight")).reshape(T, kvh, d)
        v = (xin @ w.layer(i, "self_attn.v_proj.weight")).reshape(T, kvh, d)
        q, k = _apply_rope(q, k, cos, sin)
        kp, vp = k_pages[i], v_pages[i]
        int8 = kp.dtype == torch.int8
        if int8:
            k, v, q = _quant_rows(fold, i, k, v, q)
        kp[phys, :, off] = k.to(kp.dtype)
        vp[phys, :, off] = v.to(vp.dtype)
        ctx = ragged_paged_decode(q.contiguous(), kp, vp, lens, slot, tables,
                                  scale=d ** -0.5,
                                  pages_per_step=pages_per_step)
        if int8:
            ctx = ctx.float() * fold["vdq"][i][None, :, None]
        x = x + (ctx.reshape(T, h * d).to(x.dtype)
                 @ w.layer(i, "self_attn.o_proj.weight"))
        xm = _rms_norm(x, w.layer(i, "post_attention_layernorm.weight"),
                       cfg.rms_norm_eps)
        x = x + _ffn(w, i, xm)
    if not with_head:
        return None
    # gather the CONSUMED rows before the final norm and the head: a
    # prefill chunk's intermediate rows never produce logits
    if gather is not None:
        x = x[gather.long()]
    x = _rms_norm(x, w["model.norm.weight"], cfg.rms_norm_eps)
    return w.head(x).float()


def _round_int8(x):
    """Round half away from zero into the int8 range (the reference's
    quant_round_type=1; mirror of ``_round_int8``)."""
    y = torch.sign(x) * torch.floor(x.abs() + 0.5)
    return y.clamp(-127, 127).to(torch.int8)


def _quant_rows(fold, i, k, v, q):
    """Layer ``i``'s new K/V rows ([..., kvh, d]) quantized with the frozen
    scales, and q ([..., h, d]) times k's dequant scale per head, cast back
    to q's dtype (exact per-head linear folds)."""
    kq = _round_int8(k.float() * fold["kq"][i][:, None])
    vq = _round_int8(v.float() * fold["vq"][i][:, None])
    return kq, vq, (q.float() * fold["kdq"][i][:, None]).to(q.dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a cache dtype ("bfloat16", "int8", "float32")."""
    return str(dtype).replace("torch.", "")


def _to_host_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array of its dtype (bf16 as ``ml_dtypes.bfloat16``,
    the JAX package's numpy form of it)."""
    t = t.cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    import ml_dtypes
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


#: ``tune_page_size``'s choices, keyed as the JAX autotune cache keys them,
#: and each candidate's measured milliseconds (None: the kernel does not
#: take that page on the card)
_PAGE_SIZE_CACHE: Dict[tuple, int] = {}
PAGE_SIZE_TIMES: Dict[tuple, Dict[int, Optional[float]]] = {}


def tune_page_size(b, kvh, d, capacity, dtype=torch.bfloat16,
                   candidates=(64, 128, 256, 512), device: DeviceLike = None):
    """Page size for a serving shape (mirror of ``tune_page_size``): on the
    card, ``paged_decode`` over b rows of kvh heads, half of ``capacity``
    visible, timed by CUDA events (median of 20 calls) for every
    candidate that divides ``capacity``; the fastest is kept per shape.
    Pages above ``MAX_PAGE_ON_CARD`` are recorded untimed (None).  On the
    CPU: 128, as the JAX function there."""
    key = ("paged_page_size", b, kvh, d, capacity, str(dtype))
    if key in _PAGE_SIZE_CACHE:
        return _PAGE_SIZE_CACHE[key]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return 128
    times: Dict[int, Optional[float]] = {}
    for page in (p for p in candidates if capacity % p == 0):
        if page > MAX_PAGE_ON_CARD:
            times[page] = None
            continue
        per_seq = capacity // page
        kc = torch.zeros((b * per_seq, kvh, page, d), dtype=dtype, device=dev)
        vc = torch.zeros_like(kc)
        tables = torch.arange(b * per_seq, dtype=torch.int32,
                              device=dev).reshape(b, per_seq)
        q = torch.ones((b, kvh, d), dtype=dtype, device=dev)
        lens = torch.full((b,), capacity // 2, dtype=torch.int32, device=dev)
        paged_decode(q, kc, vc, lens, tables)
        ms = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            paged_decode(q, kc, vc, lens, tables)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        times[page] = sorted(ms)[len(ms) // 2]
    timed = [(t, p) for p, t in times.items() if t is not None]
    if not timed:
        raise ValueError(f"tune_page_size: no candidate of {candidates} "
                         f"divides capacity {capacity} and fits the kernel")
    PAGE_SIZE_TIMES[key] = times
    _PAGE_SIZE_CACHE[key] = min(timed)[1]
    return _PAGE_SIZE_CACHE[key]


class ContinuousBatchingEngine:
    """Continuous batching over a paged cache (mirror of
    ``paddle_tpu.inference.serving.ContinuousBatchingEngine``).

    params/cfg: the Llama functional state (``LlamaForCausalLM.
    functional_state()`` or ``params_from_jax``), moved to ``device``
    (``None`` = ``cuda``, raising without a GPU).  ``max_slots`` bounds the
    in-flight batch; ``num_pages`` x ``page_size`` is the shared KV pool
    per layer, its last page the reserved trash page.  ``page_size="auto"``
    takes ``tune_page_size``; ``pages_per_step="auto"`` the
    ``default_pages_per_step`` heuristic.  ``cache_dtype=torch.int8``
    quantizes the cache with frozen per-(layer, kv head) scales calibrated
    on the first prompt.  A draft model (``draft_params``, ``draft_cfg``,
    ``speculative_k``) proposes tokens that the unified step verifies;
    ``prefill_only`` engines park completed prompts for a KV handoff
    (``export_handoff`` -> ``adopt_request`` on a decode engine);
    ``host_tier_pages`` gives the prefix cache a host tier."""

    def __init__(self, cfg, params, max_slots: int = 8,
                 num_pages: int = 64, page_size="auto",
                 max_seq_len: Optional[int] = None,
                 decode_chunk_steps: int = 8, eos_id: int = -1,
                 cache_dtype=None, pages_per_step="auto",
                 prefill_token_budget: Optional[int] = None,
                 enable_prefix_cache: bool = False,
                 draft_params=None, draft_cfg=None,
                 speculative_k: int = 0,
                 prefill_only: bool = False,
                 host_tier_pages: int = 0,
                 device: DeviceLike = None):
        if cache_dtype is not None and not isinstance(cache_dtype,
                                                      torch.dtype):
            raise TypeError(f"cache_dtype must be a torch.dtype, got "
                            f"{cache_dtype!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len or cfg.max_position_embeddings)
        L = cfg.num_hidden_layers
        kvh, d = cfg.num_key_value_heads, cfg.head_dim

        # ---- unified serving plane (ragged prefill + decode) ----
        self.prefill_budget = (0 if prefill_token_budget is None
                               else int(prefill_token_budget))
        self.unified = self.prefill_budget > 0
        self.spec_k = int(speculative_k)
        if self.spec_k and draft_params is None:
            raise ValueError("speculative_k > 0 needs draft_params "
                             "(the small proposer model)")
        if draft_params is not None and not self.spec_k:
            raise ValueError(
                "draft_params without speculative_k >= 1: the draft "
                "would mirror every step without ever proposing")
        if (self.spec_k or draft_params is not None) and not self.unified:
            raise ValueError(
                "speculative decoding requires the unified engine "
                "(prefill_token_budget > 0): the verify step IS a "
                "q_len=k+1 ragged chunk of the unified step")
        if enable_prefix_cache and not self.unified:
            raise ValueError(
                "the prefix cache requires the unified engine "
                "(prefill_token_budget > 0): cache hits enter decode "
                "mid-prompt, which only the ragged step can serve")
        # prefill_only: a completed prompt parks in ``handoff_ready`` (its
        # pages and first sampled token) for the KV handoff
        self.prefill_only = bool(prefill_only)
        if self.prefill_only and not self.unified:
            raise ValueError(
                "prefill_only requires the unified engine "
                "(prefill_token_budget > 0): the prompt-only step IS "
                "the ragged prefill chunk")
        if self.prefill_only and self.spec_k:
            raise ValueError(
                "prefill_only excludes speculative decoding: a prefill "
                "replica never runs a verify window")
        self.host_tier_pages = int(host_tier_pages)
        if self.host_tier_pages > 0 and not enable_prefix_cache:
            raise ValueError(
                "host_tier_pages > 0 is a prefix-cache tier — enable "
                "the prefix cache")
        if self.host_tier_pages > 0 and draft_params is not None:
            raise ValueError(
                "the host-tier prefix cache does not compose with a "
                "draft model: demotion moves only the target's pools, "
                "so a promoted page's draft mirror would be stale")

        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.w = _Weights(cfg, self.params)
        self.cos_tab, self.sin_tab = rope_tables_on(cfg, self.device)
        if page_size == "auto":
            page_size = tune_page_size(self.max_slots, kvh, d,
                                       self.max_seq_len, device=self.device)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        # the LAST physical page is a reserved scribble target: masked
        # (inactive/overrun) slots write their garbage K/V there
        self.trash_page = self.num_pages - 1
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.chunk = int(decode_chunk_steps)
        self.eos_id = int(eos_id)

        self.cache_dtype = cache_dtype if cache_dtype is not None \
            else _pool_dtype(self.params)
        if pages_per_step == "auto":
            pages_per_step = default_pages_per_step(
                self.page_size, kvh, d, self.pages_per_seq,
                torch.empty((), dtype=self.cache_dtype).element_size())
        self.pages_per_step = int(pages_per_step)
        # int8 cache: frozen per-(layer, kv head) scales from the first
        # prompt's K/V absmax (2x headroom): {kq, kdq, vq, vdq} [L, kvh],
        # and ``_fold``, the same with the dequant scales per q head
        self.kv_scales: Optional[Dict[str, torch.Tensor]] = None
        self._fold: Optional[Dict[str, torch.Tensor]] = None
        # per-layer pools, written in place
        self.k_pages = _pools(L, self.num_pages, kvh, self.page_size, d,
                              self.cache_dtype, self.device)
        self.v_pages = _pools(L, self.num_pages, kvh, self.page_size, d,
                              self.cache_dtype, self.device)
        # host-side slot state
        self.tables = np.full((self.max_slots, self.pages_per_seq), -1,
                              np.int32)
        self.seq_lens = np.zeros(self.max_slots, np.int32)
        self.active = np.zeros(self.max_slots, bool)
        self.cur_tok = np.zeros(self.max_slots, np.int32)
        self.budget = np.zeros(self.max_slots, np.int32)
        self.slot_rid = np.full(self.max_slots, -1, np.int64)
        self.slot_pages: Dict[int, List[int]] = {}
        self.out_tokens: Dict[int, List[int]] = {}
        self.prompt_lens: Dict[int, int] = {}
        self.alloc = PageAllocator(self.num_pages - 1)
        self.queue: Deque[Request] = deque()
        self._next_rid = 0
        self.finished: List[Finished] = []
        # pipelined-launch state: chunks launched but not yet harvested,
        # the device-resident token carry of the newest launch, per-slot
        # dirty mask (host rewrote the slot since the last launch) and
        # pending (launched-but-unharvested) steps
        self._inflight: deque = deque()
        self._dev_tok: Optional[torch.Tensor] = None
        self._dirty = np.ones(self.max_slots, bool)
        self._pending = np.zeros(self.max_slots, np.int32)
        # step report (seq_lens_encoder/decoder/this_time semantics)
        self.last_report: Dict[str, np.ndarray] = {}

        # slot -> handoff record (kept until the KV is exported and
        # released, or the request is canceled; pages stay reserved)
        self.handoff_ready: Dict[int, Dict[str, Any]] = {}
        self.prefix_cache = (PrefixCache(
            self.page_size, self.alloc,
            host_tier_pages=self.host_tier_pages,
            demote_fn=self._demote_page if self.host_tier_pages else None,
            promote_fn=self._promote_page if self.host_tier_pages else None)
            if enable_prefix_cache else None)
        # static packed-row capacity of one unified launch: one decode row
        # per slot (k+1 under speculation) plus the prefill chunk; the
        # consumed-row gather holds every verify-window row and at most
        # one chunk-final row per slot
        self.rows_cap = self.max_slots * (1 + self.spec_k) \
            + self.prefill_budget
        self.gather_cap = self.max_slots * (1 + self.spec_k) + self.max_slots
        # throttle() may shed work but never grow past these
        self._init_spec_k = self.spec_k
        self._init_prefill_budget = self.prefill_budget
        self.pending_prompt: Dict[int, np.ndarray] = {}
        self.prefill_order: List[int] = []       # FIFO over mid-prefill slots
        self.req_info: Dict[int, Request] = {}   # slot -> live request
        # per-rid prefill accounting: warm requests show
        # prefilled == prompt_len - cached_tokens
        self.prefill_stats: Dict[int, Dict[str, int]] = {}
        # one entry per verify window, bounded
        self.accepted_lengths: Deque[int] = deque(maxlen=65536)
        self.draft: Optional[Dict[str, Any]] = None
        if draft_params is not None:
            dcfg = draft_cfg if draft_cfg is not None else cfg
            dparams = {k: v.to(self.device) for k, v in draft_params.items()}
            ddt = _pool_dtype(dparams)
            dkvh, dd = dcfg.num_key_value_heads, dcfg.head_dim
            dL = dcfg.num_hidden_layers
            dcos, dsin = rope_tables_on(dcfg, self.device)
            # the draft pools mirror the target's page GEOMETRY (same ids,
            # same tables), so one page table serves both models
            self.draft = {
                "cfg": dcfg, "params": dparams,
                "w": _Weights(dcfg, dparams), "cos_tab": dcos,
                "sin_tab": dsin,
                "k_pages": _pools(dL, self.num_pages, dkvh, self.page_size,
                                  dd, ddt, self.device),
                "v_pages": _pools(dL, self.num_pages, dkvh, self.page_size,
                                  dd, ddt, self.device),
            }

    # ---------------- device work ----------------

    @torch.no_grad()
    def _decode_chunk(self, sched: torch.Tensor, dev_tok: torch.Tensor):
        """``chunk`` decode steps for all slots (mirror of
        ``_decode_chunk_jit``).  ``sched`` is the packed host schedule,
        ONE int32 [slots, P+4] upload per chunk: columns [0:P) page
        tables, P seq lens, P+1 active, P+2 dirty, P+3 restart token.
        Slots the host rewrote since the last launch restart from the
        sched token, the others continue from ``dev_tok``.  An int8 cache
        quantizes each new token's K/V on write.  Returns the last tokens
        [slots] and all tokens [slots, chunk]."""
        cfg, w = self.cfg, self.w
        h, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        page = self.page_size
        P = sched.shape[1] - 4
        tables = sched[:, :P].contiguous()
        seq_lens = sched[:, P].clone()
        active = sched[:, P + 1] > 0
        done = ~active
        tok = torch.where(sched[:, P + 2] > 0, sched[:, P + 3], dev_tok)
        nslots = sched.shape[0]
        bidx = torch.arange(nslots, device=self.device)
        toks = []
        max_pos = self.cos_tab.shape[0] - 1
        for _ in range(self.chunk):
            x = w.embed(tok[:, None])
            # overrun slots (lookahead past a finished budget) may run past
            # the rope table; their tokens are discarded, so clamp instead
            # of indexing out of range
            pos = seq_lens.long().clamp(max=max_pos)
            cos = self.cos_tab[pos][:, None, None, :].to(x.dtype)
            sin = self.sin_tab[pos][:, None, None, :].to(x.dtype)
            blk = (seq_lens // page).long()
            slot = (seq_lens % page).long()
            phys = tables[bidx, blk.clamp(max=P - 1)].long()
            # masked slots (inactive/finished) and overrun slots (the
            # lookahead chunk of a finished sequence) scribble into the
            # trash page
            phys = torch.where(done | (phys < 0) | (blk >= P),
                               torch.full_like(phys, self.trash_page), phys)
            lens = seq_lens + 1
            for i in range(cfg.num_hidden_layers):
                xin = _rms_norm(x, w.layer(i, "input_layernorm.weight"),
                                cfg.rms_norm_eps)
                q = (xin @ w.layer(i, "self_attn.q_proj.weight")
                     ).reshape(nslots, 1, h, d)
                k = (xin @ w.layer(i, "self_attn.k_proj.weight")
                     ).reshape(nslots, 1, kvh, d)
                v = (xin @ w.layer(i, "self_attn.v_proj.weight")
                     ).reshape(nslots, 1, kvh, d)
                q, k = _apply_rope(q, k, cos, sin)
                kw_, vw_, qd = k[:, 0], v[:, 0], q.reshape(nslots, h, d)
                kp, vp = self.k_pages[i], self.v_pages[i]
                int8 = kp.dtype == torch.int8
                if int8:
                    kw_, vw_, qd = _quant_rows(self._fold, i, kw_, vw_, qd)
                kp[phys, :, slot] = kw_.to(kp.dtype)
                vp[phys, :, slot] = vw_.to(vp.dtype)
                ctx = paged_decode(qd.contiguous(), kp, vp, lens, tables,
                                   scale=d ** -0.5,
                                   pages_per_step=self.pages_per_step)
                if int8:
                    ctx = ctx.float() * self._fold["vdq"][i][None, :, None]
                x = x + (ctx.reshape(nslots, 1, h * d).to(x.dtype)
                         @ w.layer(i, "self_attn.o_proj.weight"))
                xm = _rms_norm(x, w.layer(i, "post_attention_layernorm"
                                             ".weight"), cfg.rms_norm_eps)
                x = x + _ffn(w, i, xm)
            x = _rms_norm(x, w["model.norm.weight"], cfg.rms_norm_eps)
            logits = w.head(x[:, 0]).float()
            nxt = logits.argmax(dim=-1).to(torch.int32)
            tok = torch.where(done, tok, nxt)
            seq_lens = torch.where(active & ~done, seq_lens + 1, seq_lens)
            toks.append(tok)
        return tok, torch.stack(toks, dim=1)

    @torch.no_grad()
    def _prefill_one(self, ids: np.ndarray, length: int):
        """Causal prefill of ONE prompt padded to its bucket (mirror of
        ``_prefill_jit``); returns (first greedy token, per-layer K/V
        [L, bucket, kvh, d])."""
        ids_t = torch.from_numpy(ids).to(self.device)[None]
        x, ks, vs = _prefill(self.w, ids_t, self.cos_tab, self.sin_tab)
        logits = self.w.head(x[0, length - 1][None]).float()
        tok = int(logits.argmax(dim=-1)[0])
        return tok, torch.stack([k[0] for k in ks]), \
            torch.stack([v[0] for v in vs])

    @torch.no_grad()
    def _write_pages(self, ks, vs, pg: np.ndarray):
        """Write a prompt's per-layer K/V ([L, bucket, kvh, d], already in
        the cache dtype's values) into its physical pages ``pg`` (mirror
        of ``_write_pages_jit``); pages past the prompt's real length are
        the trash page."""
        npages = len(pg)
        L, B, kvh, d = ks.shape
        pad = npages * self.page_size - B
        pg_t = torch.from_numpy(pg).to(self.device).long()

        def paged(x):
            x = x.transpose(1, 2)                            # [L, kvh, B, d]
            if pad > 0:
                x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            return x.reshape(L, kvh, npages, self.page_size, d
                             ).transpose(1, 2)               # [L, np, kvh, page, d]

        kt, vt = paged(ks), paged(vs)
        for i in range(L):
            self.k_pages[i][pg_t] = kt[i].to(self.cache_dtype)
            self.v_pages[i][pg_t] = vt[i].to(self.cache_dtype)

    @torch.no_grad()
    def _unified_step(self, rows: torch.Tensor, tables: torch.Tensor,
                      gather: torch.Tensor) -> torch.Tensor:
        """ONE ragged engine step of the target (mirror of
        ``_unified_step_jit``, see ``_ragged_forward``): fp32 logits of
        the ``gather`` rows [G, vocab]."""
        return _ragged_forward(self.cfg, self.w, self.k_pages, self.v_pages,
                               self.cos_tab, self.sin_tab, rows, tables,
                               self.pages_per_step, fold=self._fold,
                               gather=gather)

    # ---- host-tier residency hooks (the prefix cache's demote_fn and
    # promote_fn) ----

    @torch.no_grad()
    def _demote_page(self, page: int):
        """Copy one pool page's per-layer K/V ([L, kvh, page, d] each) to
        the host, pinned on the card (queued on the engine's stream, so
        later writes to the freed page cannot overtake it), and free the
        device page."""
        pg = int(page)
        out = []
        for pools in (self.k_pages, self.v_pages):
            x = torch.stack([p[pg] for p in pools])
            if self.device.type == "cuda":
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                x = host
            out.append(x)
        self.alloc.release([pg])
        return tuple(out)

    @torch.no_grad()
    def _promote_page(self, host_kv):
        """Inverse of ``_demote_page``: allocate a device page (demoting a
        colder page if the pool is full), copy the host payload back in.
        Returns the page id at trie-refcount 1, or None when no device page
        could be found (the lookup then ends its walk)."""
        p = self.alloc.alloc()
        if p is None and self.prefix_cache is not None:
            # ancestors on the lookup path hold extra refs, so this can
            # never demote the chain being promoted
            self.prefix_cache.evict(1)
            p = self.alloc.alloc()
        if p is None:
            return None
        for pools, host in zip((self.k_pages, self.v_pages), host_kv):
            x = host.to(self.device, non_blocking=True)
            for i, pool in enumerate(pools):
                pool[p] = x[i]
        return p

    # ---- int8 cache: calibration and quantization ----

    @staticmethod
    def _kv_calibration_scales(ks, vs, s: int) -> Dict[str, torch.Tensor]:
        """The int8 K/V scale rule: absmax per (layer, kv head) over the
        first ``s`` real tokens, 2x headroom, frozen quant/dequant pairs
        (mirror of ``_kv_calibration_scales``)."""
        kabs = ks[:, :s].float().abs().amax(dim=(1, 3)) * 2.0 + 1e-6
        vabs = vs[:, :s].float().abs().amax(dim=(1, 3)) * 2.0 + 1e-6
        # true divisions (a scalar operand would become a multiply by its
        # reciprocal on some backends)
        c = torch.full_like(kabs, 127.0)
        return {"kq": c / kabs, "kdq": kabs / c, "vq": c / vabs,
                "vdq": vabs / c}

    def _set_kv_scales(self, scales: Dict[str, torch.Tensor]) -> None:
        """Freeze the int8 scales, and their per-q-head dequant folds."""
        self.kv_scales = {k: v.to(self.device, torch.float32)
                          for k, v in scales.items()}
        rep = self.cfg.num_attention_heads // self.cfg.num_key_value_heads
        self._fold = {
            "kq": self.kv_scales["kq"], "vq": self.kv_scales["vq"],
            "kdq": self.kv_scales["kdq"].repeat_interleave(rep, dim=1),
            "vdq": self.kv_scales["vdq"].repeat_interleave(rep, dim=1)}

    @staticmethod
    def _quant(x, scale):
        """x [L, tokens, kvh, d] x per-(L, kvh) scale -> int8."""
        return _round_int8(x.float() * scale[:, None, :, None])

    def _calibrate_int8_unified(self, prompt) -> None:
        """One-shot scale calibration for the unified plane: the chunked
        path's full prefill over the first prompt, the shared scale rule,
        its K/V then discarded (the unified step re-prefills the prompt
        through its quantized scatter)."""
        s = len(prompt)
        bucket = max(16, 1 << (s - 1).bit_length())
        ids = np.zeros(bucket, np.int32)
        ids[:s] = prompt
        _, ks, vs = self._prefill_one(ids, s)
        self._set_kv_scales(self._kv_calibration_scales(ks, vs, s))

    # ---------------- host scheduler ----------------

    def add_request(self, prompt, max_new_tokens: int = 32, rid=None,
                    arrival: float = 0.0, temperature: float = 0.0,
                    seed: int = 0):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        # prefill-only engines reserve prompt pages alone: the budget's
        # pages belong to the engine the KV hands off to
        reserve = len(prompt) + (0 if self.prefill_only else max_new_tokens)
        if self._pages_needed(reserve) > self.alloc.total:
            raise ValueError(
                f"request needs {self._pages_needed(reserve)} pages but the "
                f"pool only has {self.alloc.total} — it could never be "
                f"admitted (head-of-line livelock)")
        if temperature > 0 and not self.unified:
            raise ValueError("temperature sampling requires the unified "
                             "engine (host-side sampling from returned "
                             "logits); the chunked path is greedy-only")
        if (self.unified and self.cache_dtype == torch.int8
                and self.kv_scales is None):
            # calibrate on the first prompt at submission, outside any step
            self._calibrate_int8_unified(prompt)
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        self.queue.append(Request(int(rid), prompt, int(max_new_tokens),
                                  arrival, float(temperature), int(seed)))
        return rid

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _admit(self) -> List[tuple]:
        """Admit queued prompts into free slots while pages last; the full
        prompt + generation budget is reserved up front.  The first
        prefill of an int8 engine calibrates its scales."""
        admitted = []
        free_slots = np.nonzero(~self.active)[0]
        si = 0
        while self.queue and si < len(free_slots):
            req = self.queue[0]
            need = self._pages_needed(len(req.prompt) + req.max_new_tokens)
            if need > self.alloc.available:
                break                      # head-of-line waits for pages
            self.queue.popleft()
            slot = int(free_slots[si])
            si += 1
            pages = [self.alloc.alloc() for _ in range(need)]
            self.slot_pages[slot] = pages
            self.tables[slot] = -1
            self.tables[slot, :need] = pages
            s = len(req.prompt)
            bucket = max(16, 1 << (s - 1).bit_length())
            ids = np.zeros(bucket, np.int32)
            ids[:s] = req.prompt
            tok, ks, vs = self._prefill_one(ids, s)
            if self.cache_dtype == torch.int8:
                if self.kv_scales is None:
                    self._set_kv_scales(
                        self._kv_calibration_scales(ks, vs, s))
                ks = self._quant(ks, self.kv_scales["kq"])
                vs = self._quant(vs, self.kv_scales["vq"])
            npg = self._pages_needed(bucket)
            pg = np.full(npg, self.trash_page, np.int32)
            pg[:self._pages_needed(s)] = pages[:self._pages_needed(s)]
            self._write_pages(ks, vs, pg)
            self.active[slot] = True
            self.seq_lens[slot] = s
            self.cur_tok[slot] = tok
            self.budget[slot] = req.max_new_tokens - 1
            self.slot_rid[slot] = req.rid
            self._dirty[slot] = True
            self._pending[slot] = 0
            self.out_tokens[req.rid] = [tok]
            self.prompt_lens[req.rid] = s
            admitted.append((slot, s))
            if tok == self.eos_id or req.max_new_tokens <= 1:
                self._finish(slot)
        return admitted

    def _release_slot(self, slot: int):
        """Return a slot's pages and clear its host state."""
        self.alloc.release(self.slot_pages.pop(slot))
        self.active[slot] = False
        self.tables[slot] = -1
        self.seq_lens[slot] = 0
        self.slot_rid[slot] = -1
        self._dirty[slot] = True
        self._pending[slot] = 0
        self.pending_prompt.pop(slot, None)
        if slot in self.prefill_order:
            self.prefill_order.remove(slot)
        self.req_info.pop(slot, None)
        self.handoff_ready.pop(slot, None)

    def _finish(self, slot: int):
        rid = int(self.slot_rid[slot])
        self.finished.append(Finished(
            rid, np.asarray(self.out_tokens.pop(rid), np.int32),
            self.prompt_lens.pop(rid)))
        self._release_slot(slot)

    def cancel(self, rid: int) -> bool:
        """Withdraw a request WITHOUT a ``Finished`` record.  Queued
        requests leave the queue; an active one releases its pages (trie
        refs on shared pages survive); a stale in-flight chunk of it is
        dropped at harvest by the rid match.  Returns True when found."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                return True
        hit = np.nonzero(self.slot_rid == rid)[0]
        if len(hit):
            slot = int(hit[0])
            self.out_tokens.pop(rid, None)
            self.prompt_lens.pop(rid, None)
            self._release_slot(slot)
            return True
        return False

    def throttle(self, *, speculative_k=None, prefill_token_budget=None):
        """Runtime shed knobs (mirror of ``throttle``): both only REDUCE
        work below the constructor's static shapes (``rows_cap`` and
        ``gather_cap`` keep their capacity), and can be restored."""
        if speculative_k is not None:
            k = int(speculative_k)
            if not 0 <= k <= self._init_spec_k:
                raise ValueError(
                    f"speculative_k {k} outside [0, {self._init_spec_k}] "
                    f"(the constructor's static verify-window capacity)")
            self.spec_k = k
        if prefill_token_budget is not None:
            b = int(prefill_token_budget)
            if not 1 <= b <= self._init_prefill_budget:
                raise ValueError(
                    f"prefill_token_budget {b} outside "
                    f"[1, {self._init_prefill_budget}] (the constructor's "
                    f"static chunk capacity)")
            self.prefill_budget = b

    # ---------------- KV handoff (disaggregated serving) ----------------

    @torch.no_grad()
    def export_handoff(self, slot: int):
        """A handoff-ready slot's committed KV on the host and its record
        (mirror of ``export_handoff``): ``tree`` {"k", "v"}, each
        [L, npages, kvh, page, d] numpy in the cache dtype (int8 pools as
        int8, bit-exact), and ``meta`` (first sampled token, committed
        length, temperature, seed and the sampling stream's state, page
        size, cache dtype, the frozen int8 scales).  Pages stay reserved
        until ``release_handoff``."""
        info = self.handoff_ready[slot]
        npg = self._pages_needed(info["seq_len"])
        pg = torch.tensor(self.slot_pages[slot][:npg], dtype=torch.long,
                          device=self.device)
        tree = {"k": _to_host_numpy(torch.stack([p[pg]
                                                 for p in self.k_pages])),
                "v": _to_host_numpy(torch.stack([p[pg]
                                                 for p in self.v_pages]))}
        meta = dict(info, page_size=self.page_size,
                    cache_dtype=_dtype_name(self.cache_dtype))
        if self.kv_scales is not None:
            meta["kv_scales"] = {k: v.cpu().numpy()
                                 for k, v in self.kv_scales.items()}
        return tree, meta

    def release_handoff(self, slot: int) -> None:
        """Free a handed-off (or abandoned) prefill slot WITHOUT a
        Finished record; prefix-cache refs on shared pages survive."""
        info = self.handoff_ready.pop(slot)
        self.prompt_lens.pop(info["rid"], None)
        self.out_tokens.pop(info["rid"], None)
        self._release_slot(slot)

    def can_adopt(self, seq_len: int, max_new_tokens: int) -> bool:
        """Capacity probe for a KV handoff (mirror of ``can_adopt``): a
        free slot and enough free (or prefix-evictable refcount-1) pages
        for the committed prefix and the budget.  Slightly optimistic;
        ``adopt_request``'s None return is authoritative."""
        if not self.unified or self.prefill_only:
            return False
        if self.active.all():
            return False
        if int(seq_len) + int(max_new_tokens) > self.max_seq_len:
            return False
        need = self._pages_needed(int(seq_len) + int(max_new_tokens))
        avail = self.alloc.available
        if self.prefix_cache is not None:
            avail += sum(1 for n in self.prefix_cache._nodes()
                         if n.host_kv is None
                         and self.alloc.refs[n.page] == 1)
        return need <= avail

    @torch.no_grad()
    def adopt_request(self, kv, meta, max_new_tokens: int, rid=None):
        """Decode-side landing of a KV handoff (mirror of
        ``adopt_request``): pages for the committed prefix plus the budget,
        the delivered block written in, and the slot entered in DECODE
        state with the prefill side's first token (already part of the
        stream).  Frozen int8 scales in ``meta`` install on an
        uncalibrated engine and must equal a calibrated one's; the
        sampling stream resumes from ``rng_state``.  Returns the rid, or
        None when no slot or pages are free."""
        if not self.unified or self.prefill_only:
            raise ValueError("adopt_request needs a decode-capable "
                             "unified engine")
        plen = int(meta["seq_len"])
        first = int(meta["first_token"])
        if int(meta["page_size"]) != self.page_size:
            raise ValueError(
                f"handoff page_size {meta['page_size']} != this "
                f"engine's {self.page_size} — pools are incompatible")
        src_dtype = meta.get("cache_dtype")
        if (src_dtype is not None
                and str(src_dtype) != _dtype_name(self.cache_dtype)):
            raise ValueError(
                f"handoff cache_dtype {src_dtype} != this engine's "
                f"{_dtype_name(self.cache_dtype)} — pools are incompatible")
        if plen + int(max_new_tokens) > self.max_seq_len:
            raise ValueError("adopted prefix + budget exceeds max_seq_len")
        free = [s for s in range(self.max_slots) if not self.active[s]]
        if not free:
            return None
        need = self._pages_needed(plen + int(max_new_tokens))
        npg = int(np.shape(kv["k"])[1])
        if need > self.alloc.available and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.alloc.available)
        if need > self.alloc.available:
            return None
        scales = meta.get("kv_scales")
        if scales is not None:
            if self.kv_scales is None:
                self._set_kv_scales({k: torch.from_numpy(np.array(v, np.float32))
                                     for k, v in scales.items()})
            elif any(not np.array_equal(self.kv_scales[k].cpu().numpy(),
                                        np.asarray(v))
                     for k, v in scales.items()):
                raise ValueError(
                    "handoff kv_scales diverge from this engine's frozen "
                    "calibration — the fleet must share one int8 K/V "
                    "calibration")
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        slot = free[0]
        pages = [self.alloc.alloc() for _ in range(need)]
        self.slot_pages[slot] = pages
        self.tables[slot] = -1
        self.tables[slot, :need] = pages
        pg = torch.tensor(pages[:npg], dtype=torch.long, device=self.device)
        for pools, block in zip((self.k_pages, self.v_pages),
                                (kv["k"], kv["v"])):
            # a handoff delivered to this device arrives as its tensors
            x = (block if isinstance(block, torch.Tensor)
                 else _to_torch(block)).to(self.device)
            for i, pool in enumerate(pools):
                pool[pg] = x[i].to(pool.dtype)
        self.active[slot] = True
        self.seq_lens[slot] = plen
        self.cur_tok[slot] = first
        self.budget[slot] = int(max_new_tokens) - 1
        self.slot_rid[slot] = rid
        self.out_tokens[rid] = [first]
        self.prompt_lens[rid] = plen
        req = Request(int(rid), np.zeros(0, np.int32), int(max_new_tokens),
                      temperature=float(meta.get("temperature", 0.0)),
                      seed=int(meta.get("seed", 0)))
        req.rng = np.random.default_rng(req.seed)
        if meta.get("rng_state") is not None:
            # resume the prefill side's seeded stream mid-state
            req.rng.bit_generator.state = meta["rng_state"]
        self.req_info[slot] = req
        if self.budget[slot] <= 0 or first == self.eos_id:
            self._finish(slot)
        return rid

    def analysis_entry(self):
        """(fn, args, kwargs, options) for ``analysis.check`` over the
        serving hot path (mirror of the JAX ``analysis_entry``): the
        decode chunk, or on the unified engine one ragged step at its
        static row capacity (decode rows + spec windows + a full prefill
        chunk), with the engine's own weights, pools and rope tables.

            fn, args, kwargs, options = engine.analysis_entry()
            report = analysis.check(fn, *args, kwargs=kwargs,
                                    options=options, device=engine.device)

        ``options`` declares the donation contract: the params and the
        rope tables (arguments 0, 5, 6) persist across steps by design;
        the page pools (1, 2) are the port's donation, updated in place,
        and the doctor checks that stays true (``min_bytes`` is half a
        layer's pool, so a debug engine whose pools stopped being written
        in place still fails)."""
        if self.unified:
            return self._unified_analysis_entry()
        dev_tok = (self._dev_tok if self._dev_tok is not None else
                   torch.zeros(self.max_slots, dtype=torch.int32,
                               device=self.device))
        sched = torch.from_numpy(self._pack_sched()).to(self.device)

        def decode_chunk(params, k_pages, v_pages, sched, dev_tok, cos_tab,
                         sin_tab, kv_scales=None):
            view = self._view(params, k_pages, v_pages, cos_tab, sin_tab,
                              kv_scales)
            return ContinuousBatchingEngine._decode_chunk(view, sched,
                                                          dev_tok)

        args = (self.params, list(self.k_pages), list(self.v_pages), sched,
                dev_tok, self.cos_tab, self.sin_tab)
        return decode_chunk, args, {"kv_scales": self._entry_scales()}, \
            self._entry_options()

    def _unified_analysis_entry(self):
        """The unified ragged step at ``rows_cap`` rows (every row padding:
        slot -1, the trash page), the engine's page table and a full
        consumed-row gather."""
        rows = np.zeros((self.rows_cap, 5), np.int32)
        rows[:, 1] = self.trash_page
        rows[:, 4] = -1

        def unified_step(params, k_pages, v_pages, rows, tables, cos_tab,
                         sin_tab, kv_scales=None, gather=None):
            view = self._view(params, k_pages, v_pages, cos_tab, sin_tab,
                              kv_scales)
            return ContinuousBatchingEngine._unified_step(view, rows, tables,
                                                          gather)

        dev = self.device
        args = (self.params, list(self.k_pages), list(self.v_pages),
                torch.from_numpy(rows).to(dev),
                torch.from_numpy(self.tables).to(dev), self.cos_tab,
                self.sin_tab)
        kwargs = {"kv_scales": self._entry_scales(),
                  "gather": torch.zeros(self.gather_cap, dtype=torch.int32,
                                        device=dev)}
        return unified_step, args, kwargs, self._entry_options()

    def _view(self, params, k_pages, v_pages, cos_tab, sin_tab, kv_scales):
        """A shallow copy of the engine over the given weights, pools,
        rope tables and int8 scales (the entries' functional form)."""
        import copy

        view = copy.copy(self)
        view.params, view.w = params, _Weights(self.cfg, params)
        view.k_pages, view.v_pages = list(k_pages), list(v_pages)
        view.cos_tab, view.sin_tab = cos_tab, sin_tab
        view._fold = None
        if kv_scales is not None:
            rep = self.cfg.num_attention_heads // self.cfg.num_key_value_heads
            view._fold = {
                "kq": kv_scales["kq"], "vq": kv_scales["vq"],
                "kdq": kv_scales["kdq"].repeat_interleave(rep, dim=1),
                "vdq": kv_scales["vdq"].repeat_interleave(rep, dim=1)}
        return view

    def _entry_scales(self):
        """The engine's int8 scales; before the first admission calibrated
        them, unit placeholders of their shape, so the priced program is
        the one real traffic runs (as the JAX entry does)."""
        if self.kv_scales is not None or self.cache_dtype != torch.int8:
            return self.kv_scales
        ones = torch.ones((self.cfg.num_hidden_layers,
                           self.cfg.num_key_value_heads),
                          dtype=torch.float32, device=self.device)
        return {"kq": ones, "kdq": ones, "vq": ones, "vdq": ones}

    def _entry_options(self):
        pool = self.k_pages[0]
        pool_bytes = pool.numel() * pool.element_size()
        return {"donation": {"persistent": (0, 5, 6),
                             "min_bytes": min(1 << 20,
                                              max(1, pool_bytes // 2))}}

    def param_layout(self):
        """The canonical ``SpecLayout`` of the engine's committed params
        (the Sharding Doctor's serving-stack table,
        ``analysis.sharding.extract_serving_layout``)."""
        from ..analysis.sharding import extract_serving_layout

        return extract_serving_layout(self)

    # ---------------- unified serving plane ----------------

    def _phys(self, slot: int, pos: int) -> int:
        """Physical page holding ``pos`` of ``slot``'s sequence."""
        page = int(self.tables[slot, pos // self.page_size])
        if page < 0:
            raise AssertionError(
                f"slot {slot} writing position {pos} past its reserved "
                f"pages — admission under-reserved")
        return page

    def _admit_unified(self) -> List[tuple]:
        """Admit queued prompts into free slots; no prefill runs here — the
        prompt is consumed ``prefill_token_budget`` tokens per step by the
        unified launch.  Prefix-cache hits map the shared full pages into
        the new table and skip their prefill."""
        admitted = []
        if (self.cache_dtype == torch.int8 and self.kv_scales is None
                and self.queue):
            # normally calibrated at add_request already
            self._calibrate_int8_unified(self.queue[0].prompt)
        free_slots = [s for s in range(self.max_slots) if not self.active[s]]
        si = 0
        while self.queue and si < len(free_slots):
            req = self.queue[0]
            plen = len(req.prompt)
            need = self._pages_needed(
                plen if self.prefill_only else plen + req.max_new_tokens)
            shared: List[int] = []
            matched = 0
            if self.prefix_cache is not None:
                shared, matched = self.prefix_cache.lookup(req.prompt)
            need_new = need - len(shared)
            if need_new > self.alloc.available \
                    and self.prefix_cache is not None:
                self.prefix_cache.evict(need_new - self.alloc.available)
            if need_new > self.alloc.available:
                if shared:          # aborted hit: hand the refs back
                    self.alloc.release(shared)
                break               # head-of-line waits for pages
            self.queue.popleft()
            slot = free_slots[si]
            si += 1
            pages = list(shared) \
                + [self.alloc.alloc() for _ in range(need_new)]
            self.slot_pages[slot] = pages
            self.tables[slot] = -1
            self.tables[slot, :need] = pages
            self.active[slot] = True
            self.seq_lens[slot] = matched
            self.cur_tok[slot] = 0
            self.budget[slot] = req.max_new_tokens
            self.slot_rid[slot] = req.rid
            self.pending_prompt[slot] = np.asarray(req.prompt[matched:],
                                                   np.int32)
            self.prefill_order.append(slot)
            req.rng = np.random.default_rng(req.seed)
            self.req_info[slot] = req
            self.prompt_lens[req.rid] = plen
            self.prefill_stats[req.rid] = {
                "prompt_len": plen, "cached_tokens": matched,
                "prefilled": 0}
            if self.prefix_cache is not None:
                self.prefix_cache.record_hit(matched)
            admitted.append((slot, plen))
        return admitted

    def _sample_row(self, logits_row: np.ndarray, req: Request) -> int:
        """Greedy argmax (first max on ties) or host-side temperature
        sampling from the request's seeded stream."""
        if req.temperature <= 0:
            return int(np.argmax(logits_row))
        p = _softmax_np(logits_row, req.temperature)
        return int(req.rng.choice(len(p), p=p))

    def _draft_launch(self, rows_np: np.ndarray, need_logits: bool = True):
        """One draft-model launch over a packed row schedule (the same rows
        and tables as the target's: the draft pools mirror its page
        geometry).  Returns host logits of every row, or None with
        ``need_logits`` False (the cache mirror: no head, no copy)."""
        d = self.draft
        logits = _ragged_forward(
            d["cfg"], d["w"], d["k_pages"], d["v_pages"], d["cos_tab"],
            d["sin_tab"], torch.from_numpy(rows_np).to(self.device),
            torch.from_numpy(self.tables).to(self.device),
            self.pages_per_step, with_head=need_logits)
        return logits.cpu().numpy() if need_logits else None

    def _propose(self, decoding: List[int]) -> Dict[int, tuple]:
        """Draft proposals (mirror of ``_propose``): up to ``spec_k`` tokens
        per decoding slot, one batched draft launch per proposal depth
        (proposal j+1 attends proposal j's K/V).  Returns slot ->
        (draft tokens, draft prob rows); the rows are None for greedy
        requests (exact prefix-match acceptance needs no q)."""
        props: Dict[int, tuple] = {}
        keff: Dict[int, int] = {}
        for s in decoding:
            cap = len(self.slot_pages[s]) * self.page_size
            keff[s] = max(0, min(self.spec_k, int(self.budget[s]) - 1,
                                 cap - int(self.seq_lens[s]) - 1))
            props[s] = ([], [])
        for j in range(max(keff.values(), default=0)):
            rows = np.zeros((self.max_slots, 5), np.int32)
            rows[:, 1] = self.trash_page
            rows[:, 4] = -1
            live = []
            for s in decoding:
                if keff[s] <= j:
                    continue
                tok = (int(self.cur_tok[s]) if j == 0
                       else props[s][0][j - 1])
                p = int(self.seq_lens[s]) + j
                rows[s] = (tok, self._phys(s, p), p % self.page_size,
                           p + 1, s)
                live.append(s)
            if not live:
                break
            logits = self._draft_launch(rows)
            for s in live:
                req = self.req_info[s]
                if req.temperature <= 0:
                    props[s][0].append(int(np.argmax(logits[s])))
                    props[s][1].append(None)
                else:
                    q = _softmax_np(logits[s], req.temperature)
                    props[s][0].append(int(req.rng.choice(len(q), p=q)))
                    props[s][1].append(q)
        return props

    def _commit_window(self, slot: int, start: int, n: int,
                       logits: np.ndarray, prop) -> List[int]:
        """Accept or reject one slot's verify window (gathered rows
        ``start`` .. ``start+n-1``, inputs [cur_tok, d_1..d_{n-1}]) and
        commit the emitted tokens (mirror of ``_commit_window``): exact
        prefix match for a greedy request; for a sampled one, accept d with
        probability min(1, p(d)/q(d)) and resample the first rejection
        from max(p - q, 0).  n == 1 is plain decode.  Returns the tokens."""
        req = self.req_info[slot]
        rid = int(self.slot_rid[slot])
        drafts = prop[0] if prop else []
        qrows = prop[1] if prop else []
        emitted: List[int] = []
        if req.temperature <= 0:
            for j in range(n - 1):
                t = int(np.argmax(logits[start + j]))
                emitted.append(t)
                if drafts[j] != t:
                    break
            else:
                emitted.append(int(np.argmax(logits[start + n - 1])))
        else:
            rng = req.rng
            for j in range(n - 1):
                p = _softmax_np(logits[start + j], req.temperature)
                d = drafts[j]
                q = qrows[j]
                if rng.random() < min(1.0, p[d] / max(q[d], 1e-30)):
                    emitted.append(d)
                else:
                    resid = np.maximum(p - q, 0.0)
                    tot = resid.sum()
                    tok = (int(np.argmax(p)) if tot <= 0
                           else int(rng.choice(len(p), p=resid / tot)))
                    emitted.append(tok)
                    break
            else:
                p = _softmax_np(logits[start + n - 1], req.temperature)
                emitted.append(int(rng.choice(len(p), p=p)))
        if n > 1:
            self.accepted_lengths.append(len(emitted))
        take: List[int] = []
        for t in emitted:
            take.append(t)
            if t == self.eos_id:
                break
        self.out_tokens[rid].extend(take)
        # the window wrote K/V for positions len..len+n-1; those past the
        # accepted prefix hold rejected drafts ABOVE the new length,
        # invisible and overwritten by later steps
        self.seq_lens[slot] += len(take)
        self.cur_tok[slot] = take[-1]
        self.budget[slot] -= len(take)
        if self.budget[slot] <= 0 or take[-1] == self.eos_id:
            self._finish(slot)
        return take

    def _step_unified(self) -> int:
        """One unified engine step: admit, propose (draft), pack ONE
        ragged row schedule — a decode or verify window per decoding slot
        plus up to ``prefill_token_budget`` prompt tokens — launch the
        target once (and mirror the rows through the draft), sample on the
        host, commit.  Decode slots emit at least one token EVERY step
        whatever the co-scheduled prompts' lengths (the chunked-prefill
        latency contract)."""
        self._admit_unified()
        enc = np.zeros(self.max_slots, np.int32)
        this_dec = np.zeros(self.max_slots, np.int32)
        decoding = [s for s in range(self.max_slots)
                    if self.active[s] and s not in self.pending_prompt
                    and s not in self.handoff_ready]
        props = {}
        if self.draft is not None and self.spec_k > 0 and decoding:
            props = self._propose(decoding)
        rows = np.zeros((self.rows_cap, 5), np.int32)
        rows[:, 1] = self.trash_page
        rows[:, 4] = -1
        # consumed-row gather schedule: metas carry GATHERED offsets
        gather = np.zeros(self.gather_cap, np.int32)
        g = 0
        r = 0
        metas = []
        for s in decoding:
            base = int(self.seq_lens[s])
            window = [int(self.cur_tok[s])] + list(props.get(s, ([],))[0])
            gstart = g
            for j, t in enumerate(window):
                p = base + j
                rows[r] = (t, self._phys(s, p), p % self.page_size, p + 1, s)
                gather[g] = r
                g += 1
                r += 1
            metas.append(("verify", s, gstart, len(window)))
        left = self.prefill_budget
        for s in list(self.prefill_order):
            if left <= 0:
                break
            pend = self.pending_prompt[s]
            chunk = min(len(pend), left)
            base = int(self.seq_lens[s])
            for j in range(chunk):
                p = base + j
                rows[r] = (int(pend[j]), self._phys(s, p),
                           p % self.page_size, p + 1, s)
                r += 1
            left -= chunk
            enc[s] = chunk
            # only the chunk's FINAL row can seed generation
            gather[g] = r - 1
            metas.append(("prefill", s, g, chunk))
            g += 1
        if r == 0:
            self.last_report = {
                "seq_lens_encoder": enc,
                "seq_lens_decoder": np.zeros(self.max_slots, np.int32),
                "seq_lens_this_time": enc + this_dec,
            }
            return 0

        dec = np.where(self.active, self.seq_lens, 0).astype(np.int32)
        logits = self._unified_step(
            torch.from_numpy(rows).to(self.device),
            torch.from_numpy(self.tables).to(self.device),
            torch.from_numpy(gather).to(self.device))
        if self.draft is not None:
            # mirror the SAME rows through the draft, so its cache tracks
            # the target's committed stream (prefill chunks included)
            self._draft_launch(rows, need_logits=False)
        logits = logits.cpu().numpy()

        produced = 0
        for kind, s, gi, n in metas:
            rid = int(self.slot_rid[s])
            if kind == "verify":
                take = self._commit_window(s, gi, n, logits, props.get(s))
                this_dec[s] = len(take)
                produced += len(take)
                continue
            # prefill chunk: commit the scattered prompt K/V
            req = self.req_info[s]
            self.seq_lens[s] += n
            self.prefill_stats[rid]["prefilled"] += n
            pend = self.pending_prompt[s]
            if n < len(pend):
                self.pending_prompt[s] = pend[n:]
                continue
            # prompt complete: its final row carries the first-token
            # logits; commit full pages to the prefix cache
            del self.pending_prompt[s]
            self.prefill_order.remove(s)
            if self.prefix_cache is not None:
                self.prefix_cache.insert(req.prompt, self.slot_pages[s])
            tok = self._sample_row(logits[gi], req)
            self.cur_tok[s] = tok
            if self.prefill_only:
                # park for the KV handoff: pages stay reserved, the first
                # token rides the record (the decode side commits it) with
                # the sampling stream's state after its draw
                self.handoff_ready[s] = {
                    "rid": rid, "first_token": int(tok),
                    "seq_len": int(self.seq_lens[s]),
                    "temperature": float(req.temperature),
                    "max_new_tokens": int(req.max_new_tokens),
                    "seed": int(req.seed),
                    "rng_state": (req.rng.bit_generator.state
                                  if req.temperature > 0 else None),
                }
                continue
            self.out_tokens[rid] = [tok]
            self.budget[s] = req.max_new_tokens - 1
            this_dec[s] += 1
            produced += 1
            if tok == self.eos_id or self.budget[s] <= 0:
                self._finish(s)
        self.last_report = {
            "seq_lens_encoder": enc,
            "seq_lens_decoder": dec,
            "seq_lens_this_time": enc + this_dec,
        }
        return produced

    def shutdown(self) -> None:
        """Teardown: drop the prefix cache's page references and run the
        allocator leak check."""
        if self.active.any() or self.queue:
            raise AssertionError(
                "shutdown with live requests — drain via run() first")
        if self.prefix_cache is not None:
            self.prefix_cache.assert_consistent()
            self.prefix_cache.clear()
        self.alloc.assert_consistent()
        if self.alloc.available != self.alloc.total:
            raise AssertionError(
                f"page leak at teardown: "
                f"{self.alloc.total - self.alloc.available} pages still "
                f"referenced")

    def serving_stats(self) -> Dict[str, Any]:
        """Prefix-cache counters, per-request prefill accounting and the
        verify windows' accepted lengths (``mean_accepted_len`` once a
        window ran)."""
        out: Dict[str, Any] = {
            "prefill": dict(self.prefill_stats),
            "accepted_lengths": list(self.accepted_lengths),
        }
        if self.accepted_lengths:
            out["mean_accepted_len"] = float(np.mean(self.accepted_lengths))
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out

    # ---------------- chunked path: one-chunk-ahead pipeline ----------

    def _pack_sched(self) -> np.ndarray:
        P = self.pages_per_seq
        sched = np.empty((self.max_slots, P + 4), np.int32)
        sched[:, :P] = self.tables
        sched[:, P] = self.seq_lens
        sched[:, P + 1] = self.active
        sched[:, P + 2] = self._dirty
        sched[:, P + 3] = self.cur_tok
        return sched

    def _launch(self) -> bool:
        """Enqueue the next decode chunk against the current host schedule
        and the device-resident token carry, then an asynchronous copy of
        its tokens to the host.  Returns False when no active slot could
        still produce a consumable token."""
        if not self.active.any():
            return False
        remaining = self.budget - self._pending
        if not (self.active & (remaining > 0)).any():
            return False
        dev_tok = (self._dev_tok if self._dev_tok is not None else
                   torch.zeros(self.max_slots, dtype=torch.int32,
                               device=self.device))
        sched_host = torch.from_numpy(self._pack_sched())
        if self.device.type == "cuda":
            # from pinned memory the upload is queued on the stream behind
            # the chunk in flight; a pageable copy would wait for it to drain
            sched_host = sched_host.pin_memory()
        sched = sched_host.to(self.device, non_blocking=True)
        self._dev_tok, toks = self._decode_chunk(sched, dev_tok)
        if self.device.type == "cuda":
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = toks, None
        self._inflight.append({
            "toks": host,
            "sched": sched_host,       # alive until the chunk's event fires
            "ready": ready,
            "steps": self.chunk,
            "rids": self.slot_rid.copy(),
            "launched_active": self.active.copy(),
        })
        # the host mirror advances deterministically (one token per step
        # per active slot) — no readback needed
        self.seq_lens = np.where(self.active, self.seq_lens + self.chunk,
                                 self.seq_lens).astype(np.int32)
        self._pending = np.where(self.active, self._pending + self.chunk,
                                 self._pending).astype(np.int32)
        self._dirty[:] = False
        return True

    def _harvest(self, force: bool = False):
        """Consume the oldest in-flight chunk's tokens: the only
        host<->device sync of the chunked decode path, since ``_launch``
        uploads its schedule from pinned memory without waiting.  With the
        one-chunk lookahead this normally waits while the NEXT chunk runs;
        ``force`` drains the pipeline when nothing new was launched."""
        this_time = np.zeros(self.max_slots, np.int32)
        if not self._inflight or (len(self._inflight) < 2 and not force):
            return 0, this_time
        inf = self._inflight.popleft()
        if inf["ready"] is not None:
            inf["ready"].synchronize()
        toks = inf["toks"].numpy()                    # [slots, steps]
        produced = 0
        for s in np.nonzero(inf["launched_active"])[0]:
            s = int(s)
            rid = int(inf["rids"][s])
            if (rid < 0 or not self.active[s]
                    or int(self.slot_rid[s]) != rid):
                continue            # evicted (or slot reused) since launch
            take = int(min(inf["steps"], self.budget[s]))
            hit_eos = False
            for t in toks[s, :take]:
                self.out_tokens[rid].append(int(t))
                produced += 1
                this_time[s] += 1
                if int(t) == self.eos_id:
                    hit_eos = True
                    break
            self.budget[s] -= take
            self._pending[s] = max(0, int(self._pending[s]) - inf["steps"])
            if self.budget[s] <= 0 or hit_eos:
                self._finish(s)
        return produced, this_time

    def step(self):
        """One scheduler iteration.  Unified engines run the ragged
        admit/launch/commit step; chunked engines admit, launch the next
        decode chunk and harvest the previous one.  Returns the number of
        tokens consumed this iteration (chunked: 0 while the pipeline
        fills)."""
        if self.unified:
            return self._step_unified()
        admitted = self._admit()
        enc = np.zeros(self.max_slots, np.int32)
        for s, plen in admitted:
            enc[s] = plen
        launched = self._launch()
        # decoder lens snapshot BEFORE this harvest's evictions
        dec = np.where(self.active, self.seq_lens, 0).astype(np.int32)
        produced, this_dec = self._harvest(force=not launched)
        self.last_report = {
            "seq_lens_encoder": enc,
            "seq_lens_decoder": dec,
            "seq_lens_this_time": enc + this_dec,
        }
        return produced

    def run(self, max_iters: int = 10_000):
        """Drive until queue + slots + in-flight chunks drain.  Returns
        finished requests sorted by rid."""
        it = 0
        while ((self.queue or self.active.any() or self._inflight)
               and it < max_iters):
            self.step()
            it += 1
        if self.queue or self.active.any() or self._inflight:
            raise RuntimeError("serving loop did not drain")
        return sorted(self.finished, key=lambda f: f.rid)
