"""The serving extras of the port's engine (paddle_tpu_torch/inference/
serving.py) against the JAX engine on the CPU: the int8 KV cache on both
paths, speculative decoding with a self-draft, ``throttle``, the prefix
cache's host tier, the disaggregated KV handoff in both directions and
``page_size="auto"``.

The debug Llama of tests/test_torch_serving.py crosses to the port through
``params_from_jax``, fp32.  The JAX engines of a module share their
compiled programs (one per row shape and cache dtype), so the file stays
well under a minute.  Greedy tokens, seeded sampled tokens and
the verify windows' accepted lengths are exact; int8 scales agree to
1e-6, int8 pages to +-1 on at most 0.1 % of their elements (a K/V value
rounded at .5 from the other side)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models.generation import \
    self_draft_params as jax_self_draft_params
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                PageAllocator, PrefixCache,
                                                tune_page_size)
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models.generation import self_draft_params
from test_torch_serving import DEBUG, _prompts

KW = dict(max_slots=3, num_pages=33, page_size=16, max_seq_len=128,
          decode_chunk_steps=4)


@pytest.fixture(scope="module")
def pair():
    state = paddle.get_rng_state()
    paddle.seed(20240806)
    jm = JaxModel(JaxConfig.debug(**DEBUG))
    paddle.set_rng_state(state)
    jstate = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    cfg = LlamaConfig.debug(**DEBUG)
    params = params_from_jax(jstate, "cpu")
    jparams = {k: jnp.asarray(v) for k, v in jstate.items()}
    return jm.cfg, jparams, cfg, params


def _engines(pair, draft_layers=None, **kw):
    """(JAX engine, port engine) on the same weights and settings."""
    jcfg, jparams, cfg, params = pair
    kw = {**KW, **kw}
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("cache_dtype") is not None:
        jkw["cache_dtype"] = {torch.int8: jnp.int8,
                              torch.bfloat16: jnp.bfloat16}[kw["cache_dtype"]]
    if draft_layers is not None:
        jkw["draft_cfg"], jkw["draft_params"] = jax_self_draft_params(
            jcfg, jparams, draft_layers)
        pkw["draft_cfg"], pkw["draft_params"] = self_draft_params(
            cfg, params, draft_layers)
    return (JaxEngine(jcfg, jparams, **jkw),
            ContinuousBatchingEngine(cfg, params, device="cpu", **pkw))


def _drive(eng, requests):
    for prompt, kw in requests:
        eng.add_request(prompt, **kw)
    return {f.rid: np.asarray(f.tokens) for f in eng.run()}


def _pools(eng):
    pools = [eng.k_pages, eng.v_pages]
    if hasattr(eng.k_pages[0], "numpy"):
        return np.stack([np.stack([p.numpy() for p in ps]) for ps in pools])
    return np.stack([np.stack([np.asarray(p) for p in ps]) for ps in pools])


def _scales(eng):
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in eng.kv_scales.items()}


# ------------------------------------------------------------- int8 cache

def _int8_requests(cfg):
    return [(p, dict(max_new_tokens=8))
            for p in _prompts(cfg, 41, (5, 19, 33))]


@pytest.mark.parametrize("path", ["chunked", "unified"])
def test_int8_cache_matches_jax(pair, path):
    """Scales within 1e-6, int8 pages within +-1 on <= 0.1 % of elements,
    greedy tokens exact, on each engine path."""
    cfg = pair[2]
    kw = dict(cache_dtype=torch.int8)
    if path == "unified":
        kw["prefill_token_budget"] = 8
    jeng, eng = _engines(pair, **kw)
    reqs = _int8_requests(cfg)
    want, got = _drive(jeng, reqs), _drive(eng, reqs)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    for k, v in _scales(jeng).items():
        np.testing.assert_allclose(_scales(eng)[k], v, rtol=1e-6)
    assert all(p.dtype == torch.int8 for p in eng.k_pages + eng.v_pages)
    a = _pools(eng)[:, :, :-1].astype(np.int32)  # the trash page aside
    b = _pools(jeng)[:, :, :-1].astype(np.int32)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(),
                                                           (diff > 0).mean())
    assert np.count_nonzero(a) > 0
    eng.shutdown()
    jeng.shutdown()


# -------------------------------------------------- speculative decoding

def _spec_requests(cfg):
    p = _prompts(cfg, 43, (7, 26, 12))
    return [(p[0], dict(max_new_tokens=10)), (p[1], dict(max_new_tokens=10)),
            (p[2], dict(max_new_tokens=10, temperature=0.9, seed=7))]


def test_speculative_matches_jax(pair):
    """A one-layer self-draft, speculative_k 2: greedy and seeded sampled
    tokens and every verify window's accepted length equal JAX's (both
    sample on the host with numpy's default_rng)."""
    cfg = pair[2]
    jeng, eng = _engines(pair, draft_layers=1, prefill_token_budget=16,
                         speculative_k=2)
    reqs = _spec_requests(cfg)
    want, got = _drive(jeng, reqs), _drive(eng, reqs)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        assert len(got[rid]) == 10
    assert list(eng.accepted_lengths) == list(jeng.accepted_lengths)
    st, jst = eng.serving_stats(), jeng.serving_stats()
    assert st["accepted_lengths"] == jst["accepted_lengths"]
    assert st["mean_accepted_len"] == jst["mean_accepted_len"]
    assert set(eng.accepted_lengths) - {1} and 1 in eng.accepted_lengths
    eng.shutdown()
    jeng.shutdown()


def test_speculative_greedy_equals_plain_unified(pair):
    """Greedy requests through a draft emit the draft-free stream."""
    cfg = pair[2]
    reqs = _spec_requests(cfg)[:2]
    base = ContinuousBatchingEngine(cfg, pair[3], device="cpu",
                                    prefill_token_budget=16, **KW)
    want = _drive(base, reqs)
    for layers in (1, 2):       # an imperfect and an exact drafter
        dcfg, dparams = self_draft_params(cfg, pair[3], layers)
        eng = ContinuousBatchingEngine(cfg, pair[3], device="cpu",
                                       prefill_token_budget=16,
                                       draft_cfg=dcfg, draft_params=dparams,
                                       speculative_k=3, **KW)
        got = _drive(eng, reqs)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])
        if layers == 2:
            assert eng.serving_stats()["mean_accepted_len"] > 1
        eng.shutdown()


def test_throttle_sheds_and_restores(pair):
    """``throttle`` within JAX's bounds: shed spec and prefill budget, the
    tokens still JAX's; restore; out-of-range values refused."""
    cfg = pair[2]
    jeng, eng = _engines(pair, draft_layers=2, prefill_token_budget=16,
                         speculative_k=2)
    for e in (jeng, eng):
        e.throttle(speculative_k=0, prefill_token_budget=4)
        assert e.spec_k == 0 and e.prefill_budget == 4
    reqs = [(_prompts(cfg, 26, (21,))[0], dict(max_new_tokens=6))]
    want, got = _drive(jeng, reqs), _drive(eng, reqs)
    np.testing.assert_array_equal(got[0], want[0])
    assert not eng.accepted_lengths
    for e in (jeng, eng):
        e.throttle(speculative_k=2, prefill_token_budget=16)
        assert e.spec_k == 2 and e.prefill_budget == 16
        for bad in (dict(speculative_k=3), dict(prefill_token_budget=0),
                    dict(prefill_token_budget=32), dict(speculative_k=-1)):
            with pytest.raises(ValueError):
                e.throttle(**bad)
    eng.shutdown()


# ------------------------------------------------------------- host tier

def test_host_tier_matches_jax(pair):
    """The trace of tests/test_serving_disagg.py::test_host_tier_roundtrip_
    bit_identical on both engines: the same demotions, promotions, hits
    and ``stats()`` after every phase, and warm tokens bit-identical to
    the cold engine's and to JAX's."""
    rng = np.random.default_rng(202)
    A = rng.integers(1, 64, (33,)).astype(np.int32)
    B = rng.integers(1, 64, (40,)).astype(np.int32)
    kw = dict(max_slots=1, num_pages=6, max_seq_len=64,
              prefill_token_budget=16, enable_prefix_cache=True,
              host_tier_pages=4)
    cold = ContinuousBatchingEngine(pair[2], pair[3], device="cpu",
                                    **{**KW, **kw})
    ref = _drive(cold, [(A, dict(max_new_tokens=7))])[0]
    jeng, eng = _engines(pair, **kw)
    out = {}
    for e in (jeng, eng):
        seen = []
        for prompt, n in ((A, 7), (B, 24), (A, 7)):
            e.finished.clear()
            seen.append((_drive(e, [(prompt, dict(max_new_tokens=n))]),
                         e.prefix_cache.stats()))
        out[e is eng] = seen
    for (jtok, jst), (tok, st) in zip(out[False], out[True]):
        assert st == jst
        for rid in jtok:
            np.testing.assert_array_equal(tok[rid], jtok[rid])
    st = eng.prefix_cache.stats()
    assert st["demoted_pages"] > 0 and st["promoted_pages"] > 0
    assert st["host_hits"] > 0 and st["evicted_pages"] == 0
    np.testing.assert_array_equal(out[True][2][0][2], ref)
    eng.prefix_cache.assert_consistent()
    eng.shutdown()


def test_host_tier_roundtrip_is_bit_identical(pair):
    """A demoted page's host payload is the device page, a promoted page
    equals it again, and host leaves past the tier's cap are dropped."""
    eng = ContinuousBatchingEngine(
        pair[2], pair[3], device="cpu", prefill_token_budget=16,
        enable_prefix_cache=True, host_tier_pages=1,
        **{**KW, "num_pages": 9})
    rng = np.random.default_rng(5)
    for n in (40, 40):
        eng.add_request(rng.integers(1, 64, (n,)).astype(np.int32),
                        max_new_tokens=4)
        eng.run()
    pc = eng.prefix_cache

    def page_kv(page):
        return (torch.stack([p[page] for p in eng.k_pages]),
                torch.stack([p[page] for p in eng.v_pages]))
    before = {id(n): page_kv(n.page) for n in pc._nodes()}
    assert len(before) == 4
    assert pc.evict(2) == 2 and pc.host_pages == 1
    assert pc.stats()["evicted_pages"] == 1        # the cap dropped a leaf
    node = next(n for n in pc._nodes() if n.tier == "host")
    assert all(torch.equal(a, b)
               for a, b in zip(node.host_kv, before[id(node)]))
    page = eng._promote_page(node.host_kv)
    assert all(torch.equal(a, b)
               for a, b in zip(page_kv(page), before[id(node)]))
    eng.alloc.release([page])
    pc.assert_consistent()
    eng.shutdown()


# ------------------------------------------------------------ KV handoff

def _handoff(pre, dec, prompt, kw):
    """Prefill ``prompt`` on ``pre`` (prefill_only), export its KV, adopt
    it on ``dec`` and decode to the end.  Returns (tokens, meta)."""
    rid = pre.add_request(prompt, **kw)
    while not pre.handoff_ready:
        pre.step()
    slot = next(iter(pre.handoff_ready))
    assert pre.handoff_ready[slot]["rid"] == rid
    tree, meta = pre.export_handoff(slot)
    pre.release_handoff(slot)
    assert not pre.active.any() and not pre.handoff_ready
    new = dec.adopt_request(tree, meta, kw["max_new_tokens"])
    done = {f.rid: np.asarray(f.tokens) for f in dec.run()}
    return done[new], tree, meta


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_handoff_crosses_packages(pair, dtype, direction):
    """A prefill_only engine of one package hands a greedy and a seeded
    sampled request to a decode engine of the other: the joined streams
    equal one JAX unified engine's, int8 pages and scales arrive
    unchanged and the sampling stream resumes from ``rng_state``."""
    cfg = pair[2]
    ct = {"bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    kw = dict(prefill_token_budget=16, cache_dtype=ct, max_slots=2)
    reqs = [(p, dict(max_new_tokens=6))
            for p in _prompts(cfg, 51, (13,))] + \
        [(p, dict(max_new_tokens=6, temperature=0.8, seed=42))
         for p in _prompts(cfg, 52, (9,))]
    jref, _ = _engines(pair, **kw)
    want = [_drive(jref, [r])[i] for i, r in enumerate(reqs)]
    jpre, ppre = _engines(pair, prefill_only=True, **kw)
    jdec, pdec = _engines(pair, **kw)
    pre, dec = (jpre, pdec) if direction == "jax_to_port" else (ppre, jdec)
    for (prompt, rkw), ref in zip(reqs, want):
        got, tree, meta = _handoff(pre, dec, prompt, rkw)
        np.testing.assert_array_equal(got, ref)
        assert meta["cache_dtype"] == {"bf16": "bfloat16",
                                       "int8": "int8"}[dtype]
        assert (meta["rng_state"] is not None) == ("temperature" in rkw)
        if dtype == "int8":
            assert tree["k"].dtype == np.int8
            for k, v in meta["kv_scales"].items():
                np.testing.assert_array_equal(_scales(dec)[k], v)
                np.testing.assert_allclose(v, _scales(jref)[k], rtol=1e-6)


def test_handoff_guards_and_can_adopt_match_jax(pair):
    """tests/test_serving_disagg.py::test_prefill_only_engine_guards on the
    port, the refusals of a mismatched dtype and of diverging int8
    scales, and ``can_adopt`` equal to JAX's on the same probes."""
    cfg, params = pair[2], pair[3]
    kw = dict(max_slots=2, num_pages=17, page_size=16, max_seq_len=64)

    def port(**k):
        return ContinuousBatchingEngine(cfg, params, device="cpu",
                                        **{**kw, **k})
    with pytest.raises(ValueError, match="prefill_only"):
        port(prefill_only=True)
    with pytest.raises(ValueError, match="host_tier"):
        port(prefill_token_budget=16, host_tier_pages=2)
    pre = port(prefill_token_budget=16, prefill_only=True)
    with pytest.raises(ValueError, match="decode-capable"):
        pre.adopt_request({"k": np.zeros(1), "v": np.zeros(1)},
                          {"seq_len": 1, "first_token": 0, "page_size": 16}, 4)
    dec = port(prefill_token_budget=16)
    with pytest.raises(ValueError, match="page_size"):
        dec.adopt_request({"k": np.zeros(1), "v": np.zeros(1)},
                          {"seq_len": 1, "first_token": 0, "page_size": 32}, 4)
    with pytest.raises(ValueError, match="cache_dtype"):
        dec.adopt_request({"k": np.zeros(1), "v": np.zeros(1)},
                          {"seq_len": 1, "first_token": 0, "page_size": 16,
                           "cache_dtype": "int8"}, 4)
    i8 = port(prefill_token_budget=16, cache_dtype=torch.int8)
    i8.add_request(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    ones = np.ones((cfg.num_hidden_layers, cfg.num_key_value_heads),
                   np.float32)
    with pytest.raises(ValueError, match="kv_scales"):
        i8.adopt_request(
            {"k": np.zeros((2, 1, 2, 16, 8), np.int8),
             "v": np.zeros((2, 1, 2, 16, 8), np.int8)},
            {"seq_len": 4, "first_token": 0, "page_size": 16,
             "cache_dtype": "int8",
             "kv_scales": {"kq": ones, "kdq": ones, "vq": ones, "vdq": ones}},
            4)
    jeng = JaxEngine(pair[0], pair[1], prefill_token_budget=16, **kw)
    jpre = JaxEngine(pair[0], pair[1], prefill_token_budget=16,
                     prefill_only=True, **kw)
    probes = [(1, 4), (40, 20), (60, 5), (200, 1), (64, 0), (16, 200)]
    for e, j in ((dec, jeng), (pre, jpre)):
        assert [e.can_adopt(*p) for p in probes] == \
            [j.can_adopt(*p) for p in probes]
    # a full engine cannot adopt
    for e in (dec, jeng):
        for p in _prompts(cfg, 3, (5, 5)):
            e.add_request(p, max_new_tokens=40)
        e.step()
    assert dec.can_adopt(1, 4) == jeng.can_adopt(1, 4) is False


def test_prefill_only_reserves_prompt_pages_only(pair):
    """A prefill_only engine reserves the prompt's pages alone and parks
    the finished prompt; a request the pool could never hold is refused
    as in JAX."""
    cfg, params = pair[2], pair[3]
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", max_slots=2,
                                   num_pages=3, page_size=16, max_seq_len=128,
                                   prefill_token_budget=16, prefill_only=True)
    eng.add_request(np.arange(1, 30, dtype=np.int32), max_new_tokens=90)
    for _ in range(2):
        eng.step()
    assert len(eng.handoff_ready) == 1 and eng.alloc.available == 0
    slot = next(iter(eng.handoff_ready))
    assert eng.handoff_ready[slot]["seq_len"] == 29
    eng.release_handoff(slot)
    assert eng.alloc.available == 2
    with pytest.raises(ValueError, match="pages"):
        eng.add_request(np.arange(1, 60, dtype=np.int32), max_new_tokens=2)
    eng.shutdown()


# ---------------------------------------------------------- page size auto

def test_page_size_auto_is_128_on_cpu(pair):
    cfg, params = pair[2], pair[3]
    eng = ContinuousBatchingEngine(cfg, params, device="cpu", max_slots=2,
                                   num_pages=5, max_seq_len=128)
    assert eng.page_size == 128 and eng.pages_per_seq == 1
    assert tune_page_size(8, 8, 128, 2048, device="cpu") == 128
    jeng = JaxEngine(pair[0], pair[1], max_slots=2, num_pages=5,
                     max_seq_len=128)
    assert jeng.page_size == eng.page_size
    eng.add_request(_prompts(cfg, 9, (11,))[0], max_new_tokens=5)
    jeng.add_request(_prompts(cfg, 9, (11,))[0], max_new_tokens=5)
    np.testing.assert_array_equal(eng.run()[0].tokens, jeng.run()[0].tokens)


def test_prefix_cache_host_tier_needs_hooks():
    for cls in (PrefixCache, JaxPrefixCache):
        with pytest.raises(ValueError, match="demote_fn"):
            cls(16, PageAllocator(4), host_tier_pages=2)
