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

Unlike the JAX engine, the page pools are updated IN PLACE (indexed
assignment) instead of being donated through a compiled program.

Later slices of the port, which raise here if asked for: speculative
decoding (draft model, ``_propose``), the int8 KV cache and its
calibration, the host tier of the prefix cache
(``_demote_page``/``_promote_page``), disaggregated handoff
(``export_handoff``, ``adopt_request``, ``prefill_only``), ``throttle``,
``tune_page_size`` (``page_size="auto"``), ``analysis_entry`` and
``param_layout``.
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
from ..ops.decode_attention import (default_pages_per_step, paged_decode,
                                    ragged_paged_decode)


def _later(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} belongs to a later slice of the PyTorch port "
        f"(paddle_tpu.inference.serving has it)")


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
    """One committed full page of tokens in the prefix cache (device tier:
    ``page`` is a live pool page, the trie holds one allocator ref)."""

    __slots__ = ("children", "key", "page", "parent", "tick")

    def __init__(self, key=None, page=None, parent=None):
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.key = key
        self.page = page
        self.parent = parent
        self.tick = 0


class PrefixCache:
    """Radix/trie prefix cache over the engine's page pools, device tier
    (mirror of ``paddle_tpu.inference.serving.PrefixCache``).

    Keys are page-granular token chunks, values are physical page ids.  A
    node exists only for pages whose prompt tokens a completed prefill
    committed, and the trie holds its own allocator reference on each, so
    cached prefixes outlive their requests and ``lookup`` hands the same
    pages to a new request copy-on-write (it only writes past its private
    suffix).  Eviction is LRU over refcount-1 leaves under pool pressure.
    The host tier (``host_tier_pages > 0``) is a later slice."""

    def __init__(self, page_size: int, alloc: PageAllocator, *,
                 host_tier_pages: int = 0):
        if host_tier_pages:
            raise _later("the host tier of the prefix cache")
        self.page_size = int(page_size)
        self.alloc = alloc
        self.root = _TrieNode()
        self._tick = 0
        self.hits = 0
        self.lookups = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def _chunks(self, tokens, npages: int):
        ps = self.page_size
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(npages)]

    def lookup(self, prompt):
        """Walk the trie with the prompt's full pages; returns
        ``(pages, matched_tokens)`` with one allocator ref acquired per
        page.  At most ``(len(prompt) - 1) // page_size`` pages match, so
        the suffix holding the last prompt token is always prefilled.
        Hit stats are committed by ``record_hit`` once admitted."""
        self.lookups += 1
        self._tick += 1
        limit = max(0, (len(prompt) - 1) // self.page_size)
        node = self.root
        pages: List[int] = []
        for key in self._chunks(prompt, limit):
            child = node.children.get(key)
            if child is None:
                break
            child.tick = self._tick
            self.alloc.acquire(child.page)
            pages.append(child.page)
            node = child
        return pages, len(pages) * self.page_size

    def probe(self, prompt) -> int:
        """Matched full-page tokens for ``prompt``, with no refs acquired
        and no stats or LRU change."""
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
        parent that becomes such a leaf joins the heap.  Returns pages
        freed."""
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

    def clear(self) -> None:
        """Drop every trie reference (engine teardown)."""
        for n in list(self._nodes()):
            self.alloc.release([n.page])
        self.root = _TrieNode()

    def assert_consistent(self) -> None:
        """Device pages are unique across the trie and each holds a live
        allocator refcount (the trie's own reference)."""
        seen: Dict[int, Any] = {}
        for n in self._nodes():
            if n.page is None:
                raise AssertionError(f"trie node {n.key!r} holds no page")
            if n.page in seen:
                raise AssertionError(
                    f"device page {n.page} held by two trie nodes "
                    f"({seen[n.page]!r} and {n.key!r})")
            seen[n.page] = n.key
            if self.alloc.refs[n.page] <= 0:
                raise AssertionError(
                    f"trie node {n.key!r} holds dead page {n.page} "
                    f"(refcount {self.alloc.refs[n.page]})")

    @property
    def cached_pages(self) -> int:
        return sum(1 for _ in self._nodes())

    def stats(self) -> Dict[str, int]:
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "cached_pages": self.cached_pages,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages}


class ContinuousBatchingEngine:
    """Greedy-decode continuous batching over a paged cache (mirror of
    ``paddle_tpu.inference.serving.ContinuousBatchingEngine``).

    params/cfg: the Llama functional state (``LlamaForCausalLM.
    functional_state()`` or ``params_from_jax``), moved to ``device``
    (``None`` = ``cuda``, raising without a GPU).  ``max_slots`` bounds the
    in-flight batch; ``num_pages`` x ``page_size`` is the shared KV pool
    per layer, its last page the reserved trash page.
    ``pages_per_step="auto"`` takes the ``default_pages_per_step``
    heuristic (the measuring tuner is a later slice)."""

    def __init__(self, cfg, params, max_slots: int = 8,
                 num_pages: int = 64, page_size=128,
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
        if page_size == "auto":
            raise _later("page-size autotuning (page_size='auto')")
        if cache_dtype is not None and not isinstance(cache_dtype,
                                                      torch.dtype):
            raise TypeError(f"cache_dtype must be a torch.dtype, got "
                            f"{cache_dtype!r}")
        if cache_dtype == torch.int8:
            raise _later("the int8 KV cache and its calibration")
        if draft_params is not None or draft_cfg is not None \
                or speculative_k:
            raise _later("speculative decoding (draft model, _propose)")
        if prefill_only:
            raise _later("disaggregated prefill (prefill_only, "
                         "export_handoff)")
        if host_tier_pages:
            raise _later("the host tier of the prefix cache")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.w = _Weights(cfg, self.params)
        self.cos_tab, self.sin_tab = rope_tables_on(cfg, self.device)
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len or cfg.max_position_embeddings)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        # the LAST physical page is a reserved scribble target: masked
        # (inactive/overrun) slots write their garbage K/V there
        self.trash_page = self.num_pages - 1
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.chunk = int(decode_chunk_steps)
        self.eos_id = int(eos_id)

        L = cfg.num_hidden_layers
        kvh, d = cfg.num_key_value_heads, cfg.head_dim
        # the cache takes the first non-scale param's dtype, bf16 when that
        # is not floating (int8-weight dicts)
        dt = next(v for k, v in self.params.items()
                  if not k.endswith("._scale")).dtype
        if not dt.is_floating_point:
            dt = torch.bfloat16
        if cache_dtype is not None:
            dt = cache_dtype
        self.cache_dtype = dt
        if pages_per_step == "auto":
            pages_per_step = default_pages_per_step(
                self.page_size, kvh, d, self.pages_per_seq,
                torch.empty((), dtype=dt).element_size())
        self.pages_per_step = int(pages_per_step)
        # per-layer pools, written in place
        self.k_pages = [torch.zeros((self.num_pages, kvh, self.page_size, d),
                                    dtype=dt, device=self.device)
                        for _ in range(L)]
        self.v_pages = [torch.zeros_like(p) for p in self.k_pages]
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

        # ---- unified serving plane (ragged prefill + decode) ----
        self.prefill_budget = (0 if prefill_token_budget is None
                               else int(prefill_token_budget))
        self.unified = self.prefill_budget > 0
        if enable_prefix_cache and not self.unified:
            raise ValueError(
                "the prefix cache requires the unified engine "
                "(prefill_token_budget > 0): cache hits enter decode "
                "mid-prompt, which only the ragged step can serve")
        self.prefix_cache = (PrefixCache(self.page_size, self.alloc)
                             if enable_prefix_cache else None)
        # static packed-row capacity of one unified launch: one decode row
        # per slot plus the prefill chunk; the consumed-row gather holds a
        # decode row and at most one chunk-final row per slot
        self.rows_cap = self.max_slots + self.prefill_budget
        self.gather_cap = 2 * self.max_slots
        self.pending_prompt: Dict[int, np.ndarray] = {}
        self.prefill_order: List[int] = []       # FIFO over mid-prefill slots
        self.req_info: Dict[int, Request] = {}   # slot -> live request
        # per-rid prefill accounting: warm requests show
        # prefilled == prompt_len - cached_tokens
        self.prefill_stats: Dict[int, Dict[str, int]] = {}

    # ---------------- device work ----------------

    @torch.no_grad()
    def _decode_chunk(self, sched: torch.Tensor, dev_tok: torch.Tensor):
        """``chunk`` decode steps for all slots (mirror of
        ``_decode_chunk_jit``).  ``sched`` is the packed host schedule,
        ONE int32 [slots, P+4] upload per chunk: columns [0:P) page
        tables, P seq lens, P+1 active, P+2 dirty, P+3 restart token.
        Slots the host rewrote since the last launch restart from the
        sched token, the others continue from ``dev_tok``.  Returns the
        last tokens [slots] and all tokens [slots, chunk]."""
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
                kp, vp = self.k_pages[i], self.v_pages[i]
                kp[phys, :, slot] = k[:, 0].to(kp.dtype)
                vp[phys, :, slot] = v[:, 0].to(vp.dtype)
                ctx = paged_decode(q.reshape(nslots, h, d), kp, vp, lens,
                                   tables, scale=d ** -0.5,
                                   pages_per_step=self.pages_per_step)
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
        """Write a prompt's per-layer K/V ([L, bucket, kvh, d]) into its
        physical pages ``pg`` (mirror of ``_write_pages_jit``); pages past
        the prompt's real length are the trash page."""
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
        """ONE ragged engine step (mirror of ``_unified_step_jit``).
        ``rows`` [rows_cap, 5] int32: (input token, physical page for this
        token's K/V, in-page offset, visibility = position + 1, slot);
        padding rows carry slot -1 / visibility 0 and scatter into the
        trash page.  Every row's K/V is scattered first (a chunk row sees
        its in-chunk predecessors), then one ragged kernel launch per
        layer.  Returns fp32 logits of the ``gather`` rows [G, vocab]."""
        cfg, w = self.cfg, self.w
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
        cos = self.cos_tab[pos][:, None, :].to(x.dtype)
        sin = self.sin_tab[pos][:, None, :].to(x.dtype)
        for i in range(cfg.num_hidden_layers):
            xin = _rms_norm(x, w.layer(i, "input_layernorm.weight"),
                            cfg.rms_norm_eps)
            q = (xin @ w.layer(i, "self_attn.q_proj.weight")).reshape(T, h, d)
            k = (xin @ w.layer(i, "self_attn.k_proj.weight")
                 ).reshape(T, kvh, d)
            v = (xin @ w.layer(i, "self_attn.v_proj.weight")
                 ).reshape(T, kvh, d)
            q, k = _apply_rope(q, k, cos, sin)
            kp, vp = self.k_pages[i], self.v_pages[i]
            kp[phys, :, off] = k.to(kp.dtype)
            vp[phys, :, off] = v.to(vp.dtype)
            ctx = ragged_paged_decode(q.contiguous(), kp, vp, lens, slot,
                                      tables, scale=d ** -0.5,
                                      pages_per_step=self.pages_per_step)
            x = x + (ctx.reshape(T, h * d).to(x.dtype)
                     @ w.layer(i, "self_attn.o_proj.weight"))
            xm = _rms_norm(x, w.layer(i, "post_attention_layernorm.weight"),
                           cfg.rms_norm_eps)
            x = x + _ffn(w, i, xm)
        # gather the CONSUMED rows before the final norm and the head: a
        # prefill chunk's intermediate rows never produce logits
        x = x[gather.long()]
        x = _rms_norm(x, w["model.norm.weight"], cfg.rms_norm_eps)
        return w.head(x).float()

    # ---------------- host scheduler ----------------

    def add_request(self, prompt, max_new_tokens: int = 32, rid=None,
                    arrival: float = 0.0, temperature: float = 0.0,
                    seed: int = 0):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        need = self._pages_needed(len(prompt) + max_new_tokens)
        if need > self.alloc.total:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.alloc.total} — it could never be admitted "
                f"(head-of-line livelock)")
        if temperature > 0 and not self.unified:
            raise ValueError("temperature sampling requires the unified "
                             "engine (host-side sampling from returned "
                             "logits); the chunked path is greedy-only")
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
        prompt + generation budget is reserved up front."""
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

    def throttle(self, **kwargs):
        raise _later("throttle (runtime shed knobs)")

    def export_handoff(self, slot: int):
        raise _later("disaggregated KV handoff (export_handoff)")

    def adopt_request(self, kv, meta, max_new_tokens: int, rid=None):
        raise _later("disaggregated KV handoff (adopt_request)")

    def analysis_entry(self):
        raise _later("the graph doctor entry (analysis_entry)")

    def param_layout(self):
        raise _later("the sharding doctor entry (param_layout)")

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
        free_slots = [s for s in range(self.max_slots) if not self.active[s]]
        si = 0
        while self.queue and si < len(free_slots):
            req = self.queue[0]
            plen = len(req.prompt)
            need = self._pages_needed(plen + req.max_new_tokens)
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

    def _commit_decode(self, slot: int, logits_row: np.ndarray) -> int:
        """Commit one decode row's token (the spec-free case of the JAX
        engine's ``_commit_window``)."""
        req = self.req_info[slot]
        rid = int(self.slot_rid[slot])
        t = self._sample_row(logits_row, req)
        self.out_tokens[rid].append(t)
        self.seq_lens[slot] += 1
        self.cur_tok[slot] = t
        self.budget[slot] -= 1
        if self.budget[slot] <= 0 or t == self.eos_id:
            self._finish(slot)
        return t

    def _step_unified(self) -> int:
        """One unified engine step: admit, pack ONE ragged row schedule —
        a decode row per decoding slot plus up to ``prefill_token_budget``
        prompt tokens — launch once, sample on the host, commit.  Decode
        slots emit a token EVERY step whatever the co-scheduled prompts'
        lengths (the chunked-prefill latency contract)."""
        self._admit_unified()
        enc = np.zeros(self.max_slots, np.int32)
        this_dec = np.zeros(self.max_slots, np.int32)
        decoding = [s for s in range(self.max_slots)
                    if self.active[s] and s not in self.pending_prompt]
        rows = np.zeros((self.rows_cap, 5), np.int32)
        rows[:, 1] = self.trash_page
        rows[:, 4] = -1
        # consumed-row gather schedule: metas carry GATHERED offsets
        gather = np.zeros(self.gather_cap, np.int32)
        g = 0
        r = 0
        metas = []
        for s in decoding:
            p = int(self.seq_lens[s])
            rows[r] = (int(self.cur_tok[s]), self._phys(s, p),
                       p % self.page_size, p + 1, s)
            gather[g] = r
            metas.append(("decode", s, g, 1))
            g += 1
            r += 1
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
            torch.from_numpy(gather).to(self.device)).cpu().numpy()

        produced = 0
        for kind, s, gi, n in metas:
            rid = int(self.slot_rid[s])
            if kind == "decode":
                self._commit_decode(s, logits[gi])
                this_dec[s] = 1
                produced += 1
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
        """Prefix-cache counters and per-request prefill accounting."""
        out: Dict[str, Any] = {"prefill": dict(self.prefill_stats)}
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
