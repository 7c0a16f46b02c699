"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports neither jax nor paddle_tpu, so it also runs on a
machine without JAX, where the repository's conftest (which imports jax)
is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

The error gate is chip_smoke.py's: per output row, the largest
|kernel - plain| over the row's largest |plain|, at most ``ROW_TOL`` for the
decode kernels (fp32 1e-4; bf16, and bf16 q with int8 K/V, two bf16 ulps)
and ``FLASH_ROW_TOL`` for the flash kernels B1/B2 (o and dq per q row of a
head, dk and dv per kv row).  ``test_error_gate_catches_planted_faults`` and
``test_flash_gate_catches_planted_faults`` build copies of the kernel
library with a fault planted in one source and show that the gate rejects
them at the serving and training shapes; run them with ``-s`` to see the
readings.
"""

import concurrent.futures
import ctypes
import json
import math

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (FLASH_ROW_TOL, FLASH_SHAPE, GRAD_ROW_FLOOR, ROW_TOL,
                        flash_errors, flash_inputs, forced_route,
                        launcher_inputs, masked_errors, masked_inputs,
                        row_error)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import decode_attention as da
from paddle_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _err(got, want, dtype):
    err, _ = row_error(got, want)
    assert err <= ROW_TOL["bf16" if dtype == torch.bfloat16 else "fp32"], err


def _inputs(dev, rows, h, kvh, d, n_kv, dtype, kv_int8, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qs = 0.05 if kv_int8 else 1.0
    q = (qs * torch.randn(rows, h, d, device=dev, generator=g)).to(dtype)
    if kv_int8:
        k = torch.randint(-127, 128, n_kv, device=dev, generator=g,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, n_kv, device=dev, generator=g,
                          dtype=torch.int8)
    else:
        k = torch.randn(n_kv, device=dev, generator=g).to(dtype)
        v = torch.randn(n_kv, device=dev, generator=g).to(dtype)
    return q, k, v


CASES = [(torch.float32, False), (torch.bfloat16, False),
         (torch.bfloat16, True)]


@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("dtype,kv_int8", CASES)
def test_flash_decode_kernel_matches_plain(dev, d, dtype, kv_int8):
    b, h, kvh, t_max = 5, 8, 2, 700
    q, k, v = _inputs(dev, b, h, kvh, d, (b, kvh, t_max, d), dtype, kv_int8,
                      1)
    lens = torch.tensor([0, 1, 33, 512, 700], dtype=torch.int32, device=dev)
    before = da.LAUNCHES["flash_decode"]
    got = da.flash_decode(q, k, v, lens, block_k=128)
    torch.cuda.synchronize()
    assert da.LAUNCHES["flash_decode"] == before + 1
    want = da.flash_decode_plain(q, k, v, lens)
    _err(got, want, dtype)
    assert torch.all(got[0] == 0)


# (q dtype, K/V dtype) pairs of the split kernels: bf16, int8 K/V under bf16
# q, fp32, and fp32 q over a bf16 cache
SPLIT_CASES = {"bf16": (torch.bfloat16, torch.bfloat16),
               "int8": (torch.bfloat16, torch.int8),
               "fp32": (torch.float32, torch.float32),
               "fp32_over_bf16": (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_flash_decode_split_kernels_match_plain(dev, case, d, rep, b):
    """B4's split and combine kernels against the plain version at the
    plan's chunk C (b 1 over 300 positions: C 16; b 8 over 2100: C 128):
    lengths 0, 1, C - 1, C, C + 1 and t_max (b 1: one call each), NaN keys
    and values planted past every length (float caches).  The gate is the
    bf16 one wherever p is rounded to bf16 (a bf16 or int8-under-bf16 V, and
    fp32 q over a bf16 cache: the kernel rounds p against its chunk's max,
    the plain version against the row's), else fp32's; rows that see no key
    exactly 0."""
    qdt, kvdt = SPLIT_CASES[case]
    kvh, t_max = 2, 300 if b == 1 else 2100
    h = rep * kvh
    chunk, _ = da.decode_split_plan(b, kvh, t_max, 512)
    assert chunk == (16 if b == 1 else 128)
    lens = [0, 1, chunk - 1, chunk, chunk + 1, t_max]
    calls = [[n] for n in lens] if b == 1 else [lens + [37, 2]]
    tol = ROW_TOL["fp32" if kvdt == torch.float32 or
                  (kvdt == torch.int8 and qdt == torch.float32) else "bf16"]
    for i, row_lens in enumerate(calls):
        q, k, v = _inputs(dev, b, h, kvh, d, (b, kvh, t_max, d), qdt,
                          kvdt == torch.int8, 20 + i)
        k, v = k.to(kvdt), v.to(kvdt)
        if kvdt != torch.int8:
            for r, n in enumerate(row_lens):
                k[r, :, n:] = float("nan")
                v[r, :, n:] = float("nan")
        lens_t = torch.tensor(row_lens, dtype=torch.int32, device=dev)
        before = da.LAUNCHES["flash_decode"]
        got = da.flash_decode(q, k, v, lens_t)
        torch.cuda.synchronize()
        assert da.LAUNCHES["flash_decode"] == before + 1
        want = da.flash_decode_plain(q, k, v, lens_t)
        err, _ = row_error(got, want)
        assert err <= tol, (row_lens, err)
        for r, n in enumerate(row_lens):
            if n == 0:
                assert torch.all(got[r] == 0)


def _plant_unseen(k, v, tables, lens, slots, walked):
    """NaN in every pool position no row sees (float pools): past each
    row's length, the unused table entries and the trash page.  A row sees
    token t < min(len, walked * page) at logical page min(t // page,
    max_pages - 1), its table entry clamped to page 0."""
    page, max_pages = k.shape[2], tables.shape[1]
    seen = torch.zeros(k.shape[0], page, dtype=torch.bool)
    tab = tables.cpu().long()
    for n, slot in zip(lens, slots):
        if slot < 0:
            continue
        t = torch.arange(min(max(n, 0), walked * page))
        phys = tab[slot, (t // page).clamp(max=max_pages - 1)].clamp(min=0)
        seen[phys, t % page] = True
    unseen = (~seen).to(k.device)[:, None, :, None]
    k.masked_fill_(unseen, float("nan"))
    v.masked_fill_(unseen, float("nan"))


def _force_chunk(monkeypatch, chunk):
    """Run the paged split kernel at ``chunk`` tokens (whole pages) instead
    of the plan's."""
    if chunk == "plan":
        return
    def forced(rows, kvh, page, max_pages, pp):
        t_walk = -(-max_pages // pp) * pp * page
        return chunk, -(-t_walk // chunk)
    monkeypatch.setattr(da, "paged_split_plan", forced)


@pytest.mark.parametrize("chunk", ["plan", 48])
@pytest.mark.parametrize("d", [8, 64, 128])
@pytest.mark.parametrize("dtype,kv_int8", CASES)
@pytest.mark.parametrize("pp", [1, 3, "auto"])
def test_paged_decode_kernel_matches_plain(dev, d, dtype, kv_int8, pp, chunk,
                                           monkeypatch):
    """The paged split and combine kernels (B3) at the plan's chunk (one
    page of 16 here) and at a forced chunk of three pages: rows that see
    nothing, end mid-page and mid-chunk, a -1 entry inside the visible
    range, a length past the table; NaN planted everywhere no row sees
    (float pools), the trash page included."""
    b, h, kvh, page, mp = 8, 8, 2, 16, 9
    n_pages = b * mp + 1
    q, k, v = _inputs(dev, b, h, kvh, d, (n_pages, kvh, page, d), dtype,
                      kv_int8, 2)
    g = torch.Generator().manual_seed(3)
    tables = torch.randperm(n_pages, generator=g)[:b * mp].reshape(b, mp)
    tables = tables.to(torch.int32)
    tables[0, 1:] = -1                       # unused tail entries
    tables[2, 3] = -1                        # -1 inside the visible range
    tables = tables.to(dev)
    lens = [7, 0, 100, 999, 40, 57, 95, 143]
    if not kv_int8:
        step = da._resolve_pp(pp, k, mp)
        _plant_unseen(k, v, tables, lens, range(b), -(-mp // step) * step)
    _force_chunk(monkeypatch, chunk)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = da.LAUNCHES["paged_decode"]
    got = da.paged_decode(q, k, v, lens, tables, pages_per_step=pp)
    torch.cuda.synchronize()
    assert da.LAUNCHES["paged_decode"] == before + 1
    want = da.paged_decode_plain(q, k, v, lens, tables, pages_per_step=pp)
    _err(got, want, dtype)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("chunk", ["plan", 48])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("dtype,kv_int8", CASES)
def test_ragged_paged_decode_kernel_matches_plain(dev, d, dtype, kv_int8,
                                                  chunk, monkeypatch):
    """The paged split and combine kernels (B3') on packed rows: decode
    rows, a prefill chunk of slot 0 (lengths 40-70, ending mid-page and,
    at the forced three-page chunk, mid-chunk), padding rows; the plan's
    chunk here is the whole walk (8 pages).  NaN planted everywhere no row
    sees (float pools)."""
    slots, h, kvh, page, mp = 3, 32, 8, 16, 8
    n_pages = slots * mp + 1
    lens = [70, 0, 17] + list(range(40, 71)) + [5, 9]
    slot = [0, 1, 2] + [0] * 31 + [-1, -1]
    q, k, v = _inputs(dev, len(lens), h, kvh, d, (n_pages, kvh, page, d),
                      dtype, kv_int8, 4)
    tables = torch.arange(n_pages - 1, dtype=torch.int32).reshape(slots, mp)
    tables = tables.flip(1).contiguous().to(dev)
    if not kv_int8:
        _plant_unseen(k, v, tables, lens, slot, mp)
    _force_chunk(monkeypatch, chunk)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    slot = torch.tensor(slot, dtype=torch.int32, device=dev)
    before = da.LAUNCHES["ragged_paged_decode"]
    got = da.ragged_paged_decode(q, k, v, lens, slot, tables)
    torch.cuda.synchronize()
    assert da.LAUNCHES["ragged_paged_decode"] == before + 1
    want = da.ragged_paged_decode_plain(q, k, v, lens, slot, tables)
    _err(got, want, dtype)
    assert torch.all(got[-2:] == 0) and torch.all(got[1] == 0)


def test_cuda_guards_raise(dev):
    q = torch.randn(2, 4, 64, device=dev)
    k = torch.randn(2, 2, 32, 64, device=dev)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        da.flash_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                        k, lens)
    with pytest.raises(ValueError):
        da.flash_decode(q, k, k, lens.cpu())


def test_generate_on_cuda_matches_cpu(dev):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.debug(vocab=64, hidden=64, layers=2, heads=4,
                            kv_heads=2, inter=128, max_pos=128)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(5))
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.load_functional_state(cpu.functional_state())
    ids = np.random.default_rng(0).integers(1, 64, (2, 11)).astype(np.int32)
    da.reset_launches()
    got = gpu.generate(ids, max_new_tokens=10).cpu()
    assert da.LAUNCHES["flash_decode"] == 9 * cfg.num_hidden_layers
    assert torch.equal(got, cpu.generate(ids, max_new_tokens=10))


# faults planted into copies of csrc/decode_attention.cu: (text,
# replacement, the launchers it breaks, the cases that show it, the factor
# over the limit its reading must reach)
PLANTED = {
    # the paged split kernel treats every row's second chunk as empty (no
    # visible key: its partial carries no weight)
    "skipped_trip": (
        "int n = min(a.chunk, len - c0);  // visible tokens of the paged chunk",
        "int n = c == 1 ? 0 : min(a.chunk, len - c0);",
        ("paged_decode", "ragged_paged_decode"), ("bf16", "int8"), 10),
    # the combine does not rescale each chunk's p V sums to the row's max
    "no_alpha_rescale": ("acc += acc_c[static_cast<size_t>(c) * D] * w;",
                         "acc += acc_c[static_cast<size_t>(c) * D];",
                         ("flash_decode", "paged_decode",
                          "ragged_paged_decode"), ("bf16", "int8"), 10),
    # the paged walk maps every token to the next logical page's entry
    "wrong_page": ("const int li = min(t / a.page, a.max_pages - 1);",
                   "const int li = min(t / a.page + 1, a.max_pages - 1);",
                   ("paged_decode", "ragged_paged_decode"), ("bf16", "int8"),
                   10),
    # B4's combine drops each row's last split
    "combine_drops_last_split": (
        "for (int c = 0; c < ns; ++c) {  // merge in split order",
        "for (int c = 0; c < ns - 1; ++c) {  // merge in split order",
        ("flash_decode",), ("bf16", "int8"), 10),
    # the split kernels stop zeroing the V rows past the length that their
    # copy brings in: NaN planted there (float caches only) reaches the sum
    "v_tail_not_zeroed": (
        "reinterpret_cast<uint32_t*>(v_s + n * R::kBytes)[i] = 0u;", "{}",
        ("flash_decode", "paged_decode", "ragged_paged_decode"), ("bf16",),
        10),
}


def _readings(dev, case):
    """Per-row gate error of each launcher at the serving shapes, with NaN
    planted past every row's length in flash_decode's float cache and in
    every pool position no row sees in the paged launchers' float pools."""
    out = {}
    for name, inp in launcher_inputs(case, dev).items():
        args = list(inp["args"])
        if name == "flash_decode" and args[1].dtype != torch.int8:
            for r, n in enumerate(args[3].tolist()):
                args[1][r, :, n:] = float("nan")
                args[2][r, :, n:] = float("nan")
        elif name != "flash_decode" and args[1].dtype != torch.int8:
            tables = args[-1]
            slots = (args[4].tolist() if name == "ragged_paged_decode"
                     else range(len(args[3])))
            mp = tables.shape[1]
            pp = da._resolve_pp("auto", args[1], mp)
            args[1], args[2] = args[1].clone(), args[2].clone()
            _plant_unseen(args[1], args[2], tables, args[3].tolist(), slots,
                          -(-mp // pp) * pp)
        got = getattr(da, name)(*args)
        want = getattr(da, name + "_plain")(*args)
        out[name] = row_error(got, want)[0]
    return out


def _build_planted(tmp_path, source_name, planted):
    """Build, in parallel, one kernel library per planted fault: every
    source of the library, with ``source_name``'s text edited.  Returns
    {fault: library path}."""
    target = next(p for p in _build.SOURCES if p.name == source_name)
    source = target.read_text()
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(len(planted)) as pool:
        for fault, (text, replacement) in planted.items():
            assert source.count(text) == 1, fault
            src = tmp_path / fault / source_name
            src.parent.mkdir()
            src.write_text(source.replace(text, replacement))
            out = tmp_path / f"{fault}.so"
            sources = [src if p == target else p for p in _build.SOURCES]
            jobs[fault] = (out, pool.submit(_build.build_library, sources,
                                            out))
        for job in jobs.values():
            job[1].result()
    return {fault: out for fault, (out, _) in jobs.items()}


def test_error_gate_catches_planted_faults(dev, tmp_path, monkeypatch):
    """Each planted fault reads at least 10 times over the limit in every
    launcher it breaks, at the serving shapes; the sound kernels read
    within it, NaN past the lengths included."""
    libs = _build_planted(tmp_path, "decode_attention.cu",
                          {f: v[:2] for f, v in PLANTED.items()})
    tol = ROW_TOL["bf16"]
    for case in ("bf16", "int8"):
        sound = _readings(dev, case)
        print(json.dumps({"kernel": "sound", "case": case, "tol": tol,
                          "row_error": sound}))
        assert max(sound.values()) <= tol, sound
        for fault, (_, _, broken, cases, factor) in PLANTED.items():
            if case not in cases:
                continue
            lib = _build.bind(ctypes.CDLL(str(libs[fault])))
            monkeypatch.setattr(_build, "_lib", lib)
            bad = _readings(dev, case)
            monkeypatch.undo()
            print(json.dumps({"kernel": fault, "case": case, "tol": tol,
                              "row_error": bad}))
            assert min(bad[n] for n in broken) > factor * tol, \
                (fault, case, bad)


# ---------------------------------------------------------------- B1 / B2

@pytest.mark.parametrize("s,d", [(200, 64), (640, 128), (1000, 128),
                                 (72, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_hb_flash_kernels_match_plain(dev, kind, rep, causal, s, d):
    """B1 and B2 against their plain versions with the per-row gate, at
    every rep the HB predicate admits (h // kvh <= 8); s 200, 1000 and 72
    end inside the wgmma kernels' 64-key and 128-key tiles and their
    128 // rep- and 64 // rep-position q tiles (rep 8: 16 and 8 positions;
    rep 3, 5, 6, 7: 42 / 25 / 21 / 18 positions leave 2, 3, 2, 2 of a
    128-row CTA idle, and 21 / 12 / 10 / 9 positions leave 1, 4, 4, 1 of a
    64-row q tile idle, rows the dk/dv kernel zeroes), and 200 and 640
    inside the other backward's tiles.  The backward takes the plain
    forward's o and lse, so it is gated on its own."""
    q, k, v, do = flash_inputs(kind, dev, (2, s, 2 * rep, 2, d))
    scale = d ** -0.5
    before = dict(fa.LAUNCHES)
    o, lse = fa.hb_flash_forward(q, k, v, causal, scale)
    wo, wlse = fa.hb_flash_forward_plain(q, k, v, causal, scale)
    grads = fa.hb_flash_backward(q, k, v, wo, wlse, do, causal, scale)
    want = fa.hb_flash_backward_plain(q, k, v, wo, wlse, do, causal, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    ferr, _ = flash_errors(kind, {"o": o, "lse": lse},
                           {"o": wo, "lse": wlse})
    berr, _ = flash_errors(kind, dict(zip(("dq", "dk", "dv"), grads)),
                           dict(zip(("dq", "dk", "dv"), want)))
    print(json.dumps({"case": [kind, rep, causal, s, d], **ferr, **berr}))


def test_hb_flash_forward_without_keys(dev):
    """sk 0: every row sees no key, o = 0 and lse = +1e30 as the plain
    version, with no launch (there is no work and no K/V to map)."""
    q = torch.randn(2, 4, 40, 128, device=dev).to(torch.bfloat16)
    k = torch.zeros(2, 0, 128, device=dev, dtype=torch.bfloat16)
    before = dict(fa.LAUNCHES)
    o, lse = fa.hb_flash_forward(q, k, k, False)
    wo, wlse = fa.hb_flash_forward_plain(q, k, k, False, 128 ** -0.5)
    assert fa.LAUNCHES == before
    assert torch.equal(o, wo) and torch.equal(lse, wlse)


def _changes_close(got, want, before, lr, steps=1):
    """``steps`` AdamW steps' parameter changes (new minus old) on the card
    against the CPU's, ``{name: tensor}`` each: each tensor's largest change
    exceeds 0.5 lr (Adam moves every element by about lr a step: a skipped
    update fails), and all but a 1e-3 share of each tensor's elements (at
    least 2 may differ) and of the model's agree to 1e-4 of their tensor's
    largest change, the rest within 2 lr a step (kernel and plain version
    round fp32 sums apart, which can flip the sign of a near-zero gradient
    and with it that element's whole step; a wrong sign across a tensor
    fails)."""
    bad = total = 0
    for k, w in want.items():
        d_got, d_want = got[k] - before[k], w - before[k]
        top = d_want.abs().max().item()
        assert top > 0.5 * lr, k
        diff = (d_got - d_want).abs()
        assert diff.max().item() <= 2 * lr * steps * (1 + 1e-3), k
        bad_k = int((diff > 1e-4 * top).sum())
        assert bad_k <= max(2, 1e-3 * diff.numel()), (k, bad_k, diff.numel())
        bad += bad_k
        total += diff.numel()
    assert bad < 1e-3 * total, (bad, total)


def test_flash_autograd_and_train_step_on_cuda_match_cpu(dev):
    """The port's fp32 train step on the card (kernels, CUDA-core path) vs
    the same step on the CPU (plain versions): every attention call of the
    step is a launch; the losses agree to 1e-4 and each parameter's change
    over one AdamW step as ``_changes_close`` holds it."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.debug(vocab=128, hidden=128, layers=2, heads=4,
                            kv_heads=2, inter=256, max_pos=256)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.load_functional_state(cpu.functional_state())
    before = {k: v.clone() for k, v in cpu.functional_state().items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 2, 96))
    lab = rng.integers(0, 128, (2, 2, 96))
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        opt = AdamW(1e-3)
        step = build_train_step(model, opt, compute_dtype=torch.float32,
                                accum_steps=2)
        params = model.functional_state()
        state = opt.init_flat_state(params, llama_decay_mask(model))
        fa.reset_launches()
        loss, params, _ = step(params, state, 0, 1e-3, ids, lab)
        out[name] = (loss.item(), {k: v.cpu() for k, v in params.items()},
                     dict(fa.LAUNCHES))
    assert set(out["cpu"][2].values()) == {0}
    assert out["gpu"][2] == dict(out["cpu"][2], flash_attention_fwd=4,
                                 flash_attention_bwd=4)
    assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    _changes_close(out["gpu"][1], out["cpu"][1], before, 1e-3)


# faults planted into copies of csrc/flash_attention.cu: (text, replacement)
# B1's two, then one in each B2 wgmma kernel
PLANTED_FLASH = {
    # the wgmma forward skips its second k tile (it still frees the stage,
    # so the producer is not left waiting)
    "skipped_k_tile": (
        "mbar_wait(&full[s], (kt / kFwdStages) & 1);",
        "mbar_wait(&full[s], (kt / kFwdStages) & 1);\n"
        "    if (kt == 1) {\n      mbar_arrive(&empty[s]);\n      continue;\n"
        "    }"),
    # the wgmma forward's output accumulator is not rescaled by alpha
    "no_alpha_rescale": ("o[p][i] *= alpha[(i / 2) % 2];",
                         "o[p][i] *= 1.f;"),
    # dk loses the contribution of the group's second head (the dk/dv
    # kernel's ds^T columns of head 1 are 0)
    "dk_drops_head_1": (
        "ds[e] = keep[(i + e) * 128] * (sc[i + e] - st_dlt[s][col]) * "
        "a.scale;",
        "ds[e] = keep[(i + e) * 128] * (sc[i + e] - st_dlt[s][col]) * "
        "(col / a.bq == 1 ? 0.f : a.scale);"),
    # the dq kernel skips its second k tile (it still frees the stage)
    "dq_skipped_k_tile": (
        "mbar_wait(&full[s], (kt / kBwdStages) & 1);",
        "mbar_wait(&full[s], (kt / kBwdStages) & 1);\n"
        "    if (kt == 1) {\n      mbar_arrive(&empty[s]);\n      continue;\n"
        "    }"),
}


def _flash_readings(dev, kind):
    """Gate errors of B1 (o) and B2 (dq, dk, dv) at the training shape,
    without the limits."""
    q, k, v, do = flash_inputs(kind, dev)
    scale = FLASH_SHAPE[-1] ** -0.5
    o, _ = fa.hb_flash_forward(q, k, v, True, scale)
    wo, wlse = fa.hb_flash_forward_plain(q, k, v, True, scale)
    got = fa.hb_flash_backward(q, k, v, wo, wlse, do, True, scale)
    want = fa.hb_flash_backward_plain(q, k, v, wo, wlse, do, True, scale)
    out = {"o": row_error(o, wo)[0]}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        out[name] = row_error(g, w, GRAD_ROW_FLOOR)[0]
    return out


def test_flash_gate_catches_planted_faults(dev, tmp_path, monkeypatch):
    """Each planted fault reads at least 10 times over the bf16 limit of
    the output it breaks at the training shape; the sound kernels read
    within the limits."""
    libs = _build_planted(tmp_path, "flash_attention.cu", PLANTED_FLASH)
    faulty = {"skipped_k_tile": "o", "no_alpha_rescale": "o",
              "dk_drops_head_1": "dk", "dq_skipped_k_tile": "dq"}
    tol = FLASH_ROW_TOL["bf16"]
    sound = _flash_readings(dev, "bf16")
    print(json.dumps({"kernel": "sound", "tol": tol, "row_error": sound}))
    assert all(sound[n] <= tol[n] for n in sound), sound
    for fault, out in faulty.items():
        lib = _build.bind(ctypes.CDLL(str(libs[fault])))
        monkeypatch.setattr(_build, "_lib", lib)
        bad = _flash_readings(dev, "bf16")
        monkeypatch.undo()
        print(json.dumps({"kernel": fault, "tol": tol, "row_error": bad}))
        assert bad[out] > 10 * tol[out], (fault, bad)


# ---------------------------------------------------------------- B5 / B6

# (b, sq, sk, q heads, kv heads, head dim, causal, mask) of chip_smoke's
# masked_inputs: every mask class, unaligned lengths, rep 1 to 16 (rep 3
# takes a 3-head CTA), head dims 16 to 128, sk != sq
MASKED_SWEEP = {
    "segments_s200": (2, 200, 200, 8, 2, 64, True, "segments"),
    "varlen_padded": (1, 256, 256, 4, 2, 128, True, "varlen_padded"),
    "doc_bands": (1, 512, 512, 4, 4, 64, True, "doc_bands"),
    "share_question": (2, 256, 256, 4, 2, 32, True, "share_question"),
    "sliding_causal_s300": (1, 300, 300, 4, 1, 32, True, "sliding"),
    "sliding_bidirectional": (1, 256, 256, 4, 2, 64, False, "sliding"),
    "global_sliding": (1, 256, 256, 2, 2, 128, False, "global_sliding"),
    "per_head_bands": (2, 256, 256, 8, 4, 64, True, "per_head_bands"),
    "rep16": (1, 128, 128, 16, 1, 64, True, "segments"),
    "rep3_d16": (1, 192, 192, 6, 2, 16, True, "segments"),
    "rep8": (1, 160, 160, 16, 2, 128, True, "segments"),
    "cross": (2, 100, 300, 4, 2, 64, False, None),
    "unmasked": (1, 256, 256, 4, 2, 128, True, None),
}


@pytest.mark.parametrize("case", list(MASKED_SWEEP))
@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_masked_flash_kernels_match_plain(dev, kind, case, monkeypatch):
    """B5 and the three B6 kernels (the fused route, then the dq + dkv
    route) against their plain versions with chip_smoke's per-row gate;
    rows that see no key exact.  The backward takes the plain forward's o
    and lse, so each kernel is gated on its own."""
    from paddle_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(chip_smoke, "MASKED_CASES", MASKED_SWEEP)
    inp = masked_inputs(case, kind, dev)
    q, k, v, do, kw = inp["q"], inp["k"], inp["v"], inp["do"], inp["kw"]
    args = (inp["causal"], inp["scale"], inp["h"], inp["kvh"])
    fa.reset_launches()
    o, lse = fa.flash_forward(q, k, v, *args, **kw)
    wo, wlse = fa.flash_forward_plain(q, k, v, *args, **kw)
    torch.cuda.synchronize()
    dead = wlse >= 1e30
    reading = {"case": [kind, case], "dead_rows": int(dead.sum())}
    reading.update(masked_errors(kind, {"o": o, "lse": lse},
                                 {"o": wo, "lse": wlse}, dead)[0])
    want = dict(zip(("dq", "dk", "dv"), fa.flash_backward_plain(
        q, k, v, wo, wlse, do, *args, **kw)))
    # A q row that sees one key has dq = 0 in exact arithmetic (p = 1, dp =
    # delta): both sides read the rounding noise of dp - delta, which at
    # these small widths can exceed the fp32 gate's floor (1e-3 of the
    # tensor max; GRAD_ROW_FLOOR).  Those rows are held to 1e-5 of the
    # tensor's largest |dq| instead, and left out of the per-row gate.
    counts = inp["keep"].sum(-1)                              # [b, mh, sq]
    one_key = counts.repeat_interleave(inp["h"] // counts.shape[1],
                                       dim=1).reshape(dead.shape) == 1
    want["dq"] = torch.where(one_key[..., None], 0, want["dq"])
    for route in ("fused", "split"):
        with forced_route(route):
            dq, dk, dv = fa.flash_backward(q, k, v, wo, wlse, do, *args,
                                           **kw)
        torch.cuda.synchronize()
        noise = dq[one_key].float().abs().max().item() if one_key.any() \
            else 0.0
        assert noise <= 1e-5 * want["dq"].float().abs().max().item(), \
            (route, noise)
        dq = torch.where(one_key[..., None], 0, dq)
        errs, _ = masked_errors(kind, {"dq": dq, "dk": dk, "dv": dv}, want,
                                dead)
        reading.update({f"{n}_{route}": e for n, e in errs.items()})
    print(json.dumps(reading))
    assert fa.LAUNCHES == dict.fromkeys(fa.LAUNCHES, 0) | {
        "flash_masked_fwd": 1, "flash_masked_bwd_fused": 1,
        "flash_masked_bwd_dq": 1, "flash_masked_bwd_dkv": 1}


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8, 16])
@pytest.mark.parametrize("case", list(MASKED_SWEEP))
def test_masked_fwd_wgmma_matches_plain(dev, case, rep, monkeypatch):
    """B5 on wgmma (bf16; head dims under 64 raised to 64, the smallest it
    takes) on every MASKED_SWEEP case at rep 1 to 8 and 16: hpc heads of
    128 // hpc positions per CTA (rep 5: 5 x 25 rows, 3 of 128 idle; rep 16:
    8 x 16), the live lists at masked_fwd_wgmma_tiles, held against the plain
    version with the per-row gate; rows that see no key exact (o = 0,
    lse = +1e30)."""
    b, sq, sk, _, kvh, d, causal, mask = MASKED_SWEEP[case]
    monkeypatch.setattr(chip_smoke, "MASKED_CASES", {
        case: (b, sq, sk, rep * kvh, kvh, max(d, 64), causal, mask)})
    inp = masked_inputs(case, "bf16", dev)
    q, k, v, kw = inp["q"], inp["k"], inp["v"], inp["kw"]
    args = (inp["causal"], inp["scale"], inp["h"], inp["kvh"])
    assert fa.masked_fwd_route(q.shape[-1], q.dtype) == "wgmma"
    fa.reset_launches()
    o, lse = fa.flash_forward(q, k, v, *args, **kw)
    wo, wlse = fa.flash_forward_plain(q, k, v, *args, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_masked_fwd"] == 1
    dead = wlse >= 1e30
    errs, _ = masked_errors("bf16", {"o": o, "lse": lse},
                            {"o": wo, "lse": wlse}, dead)
    print(json.dumps({"case": [case, rep], "dead_rows": int(dead.sum()),
                      **errs}))
    tol = FLASH_ROW_TOL["bf16"]
    assert all(e <= tol[n] for n, e in errs.items()), errs


def test_masked_fwd_wgmma_empty_live_list(dev):
    """Bands that hide rows [0, 160) from every key: the wgmma forward's q
    tiles there have an empty live list, write o = 0 and lse = +1e30 and
    load nothing; the other rows match the plain version."""
    b, s, h, kvh, d = 2, 320, 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b * h, s, d, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(b * kvh, s, d, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(b * kvh, s, d, generator=g, device=dev).to(torch.bfloat16)
    full = torch.full((b, 1, s), 160, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(full)
    bands = (zero, full, full, full)             # key j hides rows [0, 160)
    hpc, bq, bk = fa.masked_fwd_wgmma_tiles(h // kvh)
    count, _ = fa._compress_live(fa._live_tables(
        b, 1, -(-s // bq), -(-s // bk), bq, bk, s, s, False, bands=bands))
    assert (count == 0).sum().item() == b * (160 // bq)
    o, lse = fa.flash_forward(q, k, v, False, None, h, kvh, bands=bands,
                              mask_h=1)
    wo, wlse = fa.flash_forward_plain(q, k, v, False, d ** -0.5, h, kvh,
                                      bands=bands, mask_h=1)
    torch.cuda.synchronize()
    dead = wlse >= 1e30
    assert dead[:, :160].all() and not dead[:, 160:].any()
    errs, _ = masked_errors("bf16", {"o": o, "lse": lse},
                            {"o": wo, "lse": wlse}, dead)
    assert all(e <= FLASH_ROW_TOL["bf16"][n] for n, e in errs.items()), errs


def _masked_bwd_case(case, rep, monkeypatch, dev):
    """MASKED_SWEEP[case] at rep (bf16, head dims under 64 raised to 64):
    the inputs, the plain forward's o and lse, the plain gradients with the
    one-key rows' dq zeroed, and those rows."""
    b, sq, sk, _, kvh, d, causal, mask = MASKED_SWEEP[case]
    monkeypatch.setattr(chip_smoke, "MASKED_CASES", {
        case: (b, sq, sk, rep * kvh, kvh, max(d, 64), causal, mask)})
    inp = masked_inputs(case, "bf16", dev)
    q, k, v, do, kw = inp["q"], inp["k"], inp["v"], inp["do"], inp["kw"]
    args = (inp["causal"], inp["scale"], inp["h"], inp["kvh"])
    wo, wlse = fa.flash_forward_plain(q, k, v, *args, **kw)
    want = dict(zip(("dq", "dk", "dv"), fa.flash_backward_plain(
        q, k, v, wo, wlse, do, *args, **kw)))
    dead = wlse >= 1e30
    counts = inp["keep"].sum(-1)
    one_key = counts.repeat_interleave(inp["h"] // counts.shape[1],
                                       dim=1).reshape(dead.shape) == 1
    want["dq"] = torch.where(one_key[..., None], 0, want["dq"])
    return inp, args, wo, wlse, want, dead, one_key


@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 6, 7, 8, 16])
@pytest.mark.parametrize("case", list(MASKED_SWEEP))
def test_masked_bwd_wgmma_matches_plain(dev, case, rep, monkeypatch):
    """B6 on wgmma (bf16; head dims under 64 raised to 64), both routes
    forced, on every MASKED_SWEEP case at rep 1 to 8 and 16: the fused
    masked_dkv_wgmma_kernel, then masked_dq_wgmma_kernel +
    masked_dkv_wgmma_kernel, each at masked_bwd_wgmma_tiles, held against
    the plain backward (from the plain forward's o and lse) with the per-row
    gate; dq exactly 0 on rows that see no key.  One-key rows are held as
    in test_masked_flash_kernels_match_plain."""
    inp, args, wo, wlse, want, dead, one_key = _masked_bwd_case(
        case, rep, monkeypatch, dev)
    q, k, v, do, kw = inp["q"], inp["k"], inp["v"], inp["do"], inp["kw"]
    assert fa.masked_bwd_route(q.shape[-1], q.dtype) == "wgmma"
    reading = {"case": [case, rep], "dead_rows": int(dead.sum())}
    fa.reset_launches()
    for route in ("fused", "split"):
        with forced_route(route):
            dq, dk, dv = fa.flash_backward(q, k, v, wo, wlse, do, *args,
                                           **kw)
        torch.cuda.synchronize()
        noise = dq[one_key].float().abs().max().item() if one_key.any() \
            else 0.0
        assert noise <= 1e-5 * want["dq"].float().abs().max().item(), \
            (route, noise)
        dq = torch.where(one_key[..., None], 0, dq)
        errs, _ = masked_errors("bf16", {"dq": dq, "dk": dk, "dv": dv},
                                want, dead)
        reading.update({f"{n}_{route}": e for n, e in errs.items()})
    print(json.dumps(reading))
    assert fa.LAUNCHES == dict.fromkeys(fa.LAUNCHES, 0) | {
        "flash_masked_bwd_fused": 1, "flash_masked_bwd_dq": 1,
        "flash_masked_bwd_dkv": 1}
    tol = FLASH_ROW_TOL["bf16"]
    assert all(e <= tol[n.split("_")[0]] for n, e in reading.items()
               if n not in ("case", "dead_rows")), reading


def test_masked_bwd_wgmma_empty_live_lists(dev):
    """Bands where keys [256, 384) hide every row and the other keys hide
    rows [0, 64): the dk/dv kernels' k tile over those keys has an empty
    transposed list and the dq kernel's q tiles over rows [0, 64) an empty
    list (no TMA is issued for either).  On both routes dk = dv = 0 on
    those keys and dq = 0 on those rows, exactly; the rest matches the
    plain version."""
    b, s, h, kvh, d = 2, 384, 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    q, do = r(b * h, s, d), r(b * h, s, d)
    k, v = r(b * kvh, s, d), r(b * kvh, s, d)
    lte = torch.full((b, 1, s), 64, dtype=torch.int32, device=dev)
    lte[..., 256:] = s
    zero, end = torch.zeros_like(lte), torch.full_like(lte, s)
    bands = (zero, lte, end, end)
    args = (False, d ** -0.5, h, kvh)
    (hpc, bq_kv, bk_kv), (_, bq_q, bk_q) = fa.masked_bwd_wgmma_tiles(h // kvh)
    live = fa._live_tables(b, 1, -(-s // bq_kv), -(-s // bk_kv), bq_kv,
                           bk_kv, s, s, False, bands=bands)
    count_t, _ = fa._compress_live(live.transpose(1, 2))
    assert (count_t[:, 2] == 0).all() and (count_t[:, :2] > 0).all()
    count, _ = fa._compress_live(fa._live_tables(
        b, 1, -(-s // bq_q), -(-s // bk_q), bq_q, bk_q, s, s, False,
        bands=bands))
    assert (count[:, :64 // bq_q] == 0).all()
    assert (count[:, 64 // bq_q:] > 0).all()
    wo, wlse = fa.flash_forward_plain(q, k, v, *args, bands=bands, mask_h=1)
    dead = wlse >= 1e30
    assert dead[:, :64].all() and not dead[:, 64:].any()
    want = dict(zip(("dq", "dk", "dv"), fa.flash_backward_plain(
        q, k, v, wo, wlse, do, *args, bands=bands, mask_h=1)))
    for route in ("fused", "split"):
        with forced_route(route):
            dq, dk, dv = fa.flash_backward(q, k, v, wo, wlse, do, *args,
                                           bands=bands, mask_h=1)
        torch.cuda.synchronize()
        assert torch.all(dk[:, 256:] == 0) and torch.all(dv[:, 256:] == 0)
        assert torch.all(dq[:, :64] == 0)
        errs, _ = masked_errors("bf16", {"dq": dq, "dk": dk, "dv": dv},
                                want, dead)
        assert all(e <= FLASH_ROW_TOL["bf16"][n] for n, e in errs.items()), \
            (route, errs)


def test_masked_bwd_split_route_is_deterministic(dev):
    """Two split-route runs of the wgmma B6 at packed_docs are bitwise
    equal: dq is written once per row, dk/dv summed inside one CTA."""
    inp = masked_inputs("packed_docs", "bf16", dev)
    q, k, v, do, kw = inp["q"], inp["k"], inp["v"], inp["do"], inp["kw"]
    args = (inp["causal"], inp["scale"], inp["h"], inp["kvh"])
    o, lse = fa.flash_forward(q, k, v, *args, **kw)
    with forced_route("split"):
        first = fa.flash_backward(q, k, v, o, lse, do, *args, **kw)
        second = fa.flash_backward(q, k, v, o, lse, do, *args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_masked_train_step_on_cuda_matches_cpu(dev):
    """The port's fp32 masked train step (packed documents with a padding
    tail, and one all-padding micro-batch) on the card vs the same step on
    the CPU: every attention call is a masked launch (B5 + fused B6); loss
    and each parameter's change over one AdamW step agree as in
    test_flash_autograd_and_train_step_on_cuda_match_cpu."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.debug(vocab=128, hidden=128, layers=2, heads=4,
                            kv_heads=2, inter=256, max_pos=256)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.load_functional_state(cpu.functional_state())
    before = {k: v.clone() for k, v in cpu.functional_state().items()}
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (3, 2, 96))
    lab = rng.integers(0, 128, (3, 2, 96))
    seg, _ = chip_smoke.packed_documents(rng, 6, 96, 24, pad=True)
    seg = seg.reshape(3, 2, 96)
    seg[1] = 0                                   # an all-padding micro-batch
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        opt = AdamW(1e-3)
        step = build_train_step(model, opt, compute_dtype=torch.float32,
                                accum_steps=3)
        params = model.functional_state()
        state = opt.init_flat_state(params, llama_decay_mask(model))
        fa.reset_launches()
        loss, params, _ = step(params, state, 0, 1e-3, ids, lab,
                               attention_mask=seg)
        out[name] = (loss.item(), {k: v.cpu() for k, v in params.items()},
                     dict(fa.LAUNCHES))
    assert set(out["cpu"][2].values()) == {0}
    assert out["gpu"][2] == dict(out["cpu"][2], flash_masked_fwd=6,
                                 flash_masked_bwd_fused=6)
    assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    _changes_close(out["gpu"][1], out["cpu"][1], before, 1e-3)


# faults planted into copies of csrc/masked_flash_attention.cu
PLANTED_MASKED = {
    # the wgmma forward skips each CTA's last live k tile (it still frees
    # the stage, so the producer is not left waiting)
    "wgmma_skips_last_tile": (
        "mbar_wait(&full[s], (jt / kWStages) & 1);",
        "mbar_wait(&full[s], (jt / kWStages) & 1);\n"
        "    if (jt == cnt - 1) {\n      mbar_arrive(&empty[s]);\n"
        "      continue;\n    }"),
    # the wgmma forward's queries see keys of other segments in live tiles
    "wgmma_ignores_segments": (
        "if (seg) keep = keep && qid[j] == (hi ? kid.y : kid.x);", ""),
    # the wgmma dk/dv kernel (fused here) drops the second head of every
    # head chunk: its rows read lse = +inf, so their p and ds are 0
    "dkv_drops_head_1": (
        "st_lse[s][r] = ok ? a.lse[row] * kLog2e : inf;",
        "st_lse[s][r] = ok && r / a.bq != 1 ? a.lse[row] * kLog2e : inf;"),
    # the wgmma dq kernel (split route) skips each CTA's last live k tile
    # (it still frees the stage)
    "dq_skips_last_tile": (
        "mbar_wait(&full[s], (kt / kWStages) & 1);",
        "mbar_wait(&full[s], (kt / kWStages) & 1);\n"
        "    if (kt == cnt - 1) {\n      mbar_arrive(&empty[s]);\n"
        "      continue;\n    }"),
    # the fused pass drops the dq reduction of each CTA's first q tile
    "fused_drops_first_dq": ("if (row >= 0) atomicAdd(",
                             "if (row >= 0 && c != 0) atomicAdd("),
}


def _masked_readings(dev):
    """Gate errors of B5 (o), the fused B6 (dq, dk, dv: the route the
    shape takes) and the split B6 (dq_split, dk_split, dv_split, forced) on
    chip_smoke's packed_docs case (the masked train phase's attention call,
    bf16), without the limits."""
    from paddle_tpu_torch.ops import flash_attention as fa

    inp = masked_inputs("packed_docs", "bf16", dev)
    q, k, v, do, kw = inp["q"], inp["k"], inp["v"], inp["do"], inp["kw"]
    args = (inp["causal"], inp["scale"], inp["h"], inp["kvh"])
    o, _ = fa.flash_forward(q, k, v, *args, **kw)
    wo, wlse = fa.flash_forward_plain(q, k, v, *args, **kw)
    want = fa.flash_backward_plain(q, k, v, wo, wlse, do, *args, **kw)
    out = {"o": row_error(o, wo)[0]}
    got = fa.flash_backward(q, k, v, wo, wlse, do, *args, **kw)
    with forced_route("split"):
        split = fa.flash_backward(q, k, v, wo, wlse, do, *args, **kw)
    for name, g, s_, w in zip(("dq", "dk", "dv"), got, split, want):
        out[name] = row_error(g, w, GRAD_ROW_FLOOR)[0]
        out[name + "_split"] = row_error(s_, w, GRAD_ROW_FLOOR)[0]
    return out


def test_masked_gate_catches_planted_faults(dev, tmp_path, monkeypatch):
    """Each planted fault reads at least 10 times over the bf16 limit of
    the output it breaks; the sound kernels read within the limits."""
    libs = _build_planted(tmp_path, "masked_flash_attention.cu",
                          PLANTED_MASKED)
    faulty = {"wgmma_skips_last_tile": "o", "wgmma_ignores_segments": "o",
              "dkv_drops_head_1": "dk", "dq_skips_last_tile": "dq_split",
              "fused_drops_first_dq": "dq"}
    tol = FLASH_ROW_TOL["bf16"]
    sound = _masked_readings(dev)
    print(json.dumps({"kernel": "sound", "tol": tol, "row_error": sound}))
    assert all(sound[n] <= tol[n.split("_")[0]] for n in sound), sound
    for fault, out in faulty.items():
        lib = _build.bind(ctypes.CDLL(str(libs[fault])))
        monkeypatch.setattr(_build, "_lib", lib)
        bad = _masked_readings(dev)
        monkeypatch.undo()
        print(json.dumps({"kernel": fault, "tol": tol, "row_error": bad}))
        assert bad[out] > 10 * tol[out.split("_")[0]], (fault, bad)


def test_decode_kernels_fp32_q_over_bf16_cache(dev):
    """An fp32 model serving an int8-weight dict runs on bf16 pools: the
    decode kernels take fp32 q over bf16 K/V (p rounded to bf16, as v).
    Against the independent ``paged_decode_plain`` the gate is bf16's, as
    B4's split test holds the same pair: the split kernel rounds p against
    its chunk's max (one page at this shape's plan), the plain version
    against the row's.  Against ``paged_split_merge_plain``, which rounds
    p to bf16 where the kernel does (and is held against the Pallas kernel
    at this dtype pair on the CPU), the gate is fp32's."""
    b, h, kvh, d, page, mp = 3, 8, 2, 64, 16, 6
    n_pages = b * mp + 1
    q, k, v = _inputs(dev, b, h, kvh, d, (n_pages, kvh, page, d),
                      torch.bfloat16, False, 9)
    q = q.float()
    tables = torch.arange(b * mp, dtype=torch.int32).reshape(b, mp).to(dev)
    lens = torch.tensor([1, 40, 96], dtype=torch.int32, device=dev)
    got = da.paged_decode(q, k, v, lens, tables)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    _err(got, da.paged_decode_plain(q, k, v, lens, tables), torch.bfloat16)
    _err(got, da.paged_split_merge_plain(q, k, v, lens, tables),
         torch.float32)


# ---------------------------------------------------------------- B7 / B8

# (K, N, per-segment lengths, block_rows): K/N from 64 to 4096, including
# widths off the kernels' 64-wide tiles; empty segments, one expert with
# every row, unaligned lengths at block_rows 128, segments past one 64-row
# tile
GMM_SWEEP = {
    "k64_n64_mixed": (64, 64, [5, 0, 17, 64, 1, 0, 3, 200], 8),
    "k128_n4096_br128": (128, 4096, [13, 77, 0, 130, 1], 128),
    "k4096_n256": (4096, 256, [2, 3, 1, 2, 2, 2, 3, 1], 8),
    "k1024_one_expert": (1024, 1024, [0, 0, 300, 0], 8),
    "k264_n200_edges": (264, 200, [70, 0, 9, 129, 33], 8),
    # windows starting on multiples of 8 off the 64-row steps (16, 96, 232,
    # 280, 344), lengths off 64: B8's last step zeroes the next segment's rows
    "k384_n768_starts_off_64": (384, 768, [13, 77, 0, 130, 45, 64, 300], 8),
    # B7 on wgmma: windows off its 128-row tiles (16, 96, 232, 280, 344,
    # 648), K off its 64-deep steps, N off its 256-wide tiles
    "k200_n520_starts_off_128": (200, 520, [13, 77, 0, 130, 45, 64, 300, 9],
                                 8),
}


def _gmm_case(dev, K, N, lens, bm, kind, op, seed=0, wids=None):
    """Inputs of one B7/B8 call in the MoE callers' layout (dense aligned
    starts, zero slack, E * block_rows spare rows); op fwd, t (bank stored
    [E, N, K]) or outer."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(lens)
    wids = list(range(S)) if wids is None else wids
    E = max(wids) + 1
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    starts = gm.segment_starts(lens_t, bm)
    R = int(gm.align_rows(sum(lens), bm) + E * bm)
    keep = torch.zeros(R, 1, dtype=torch.bool, device=dev)
    for st, n in zip(starts.tolist(), lens):
        keep[st:st + n] = True
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16

    def rows(width):
        x = torch.randn(R, width, generator=g, device=dev).to(dtype)
        return torch.where(keep, x, torch.zeros((), dtype=dtype, device=dev))

    inp = dict(op=op, starts=starts, lens=lens_t, bm=bm, scale=None,
               wids=torch.tensor(wids, dtype=torch.int32, device=dev),
               x=rows(K), dy=rows(N) if op == "outer" else None)
    if op != "outer":
        shape = (E, N, K) if op == "t" else (E, K, N)
        if kind == "int8":
            inp["w"] = torch.randint(-127, 128, shape, generator=g,
                                     device=dev, dtype=torch.int8)
            inp["scale"] = torch.rand(E, N, generator=g, device=dev) / (
                73.0 * K ** 0.5)
        else:
            inp["w"] = (torch.randn(shape, generator=g, device=dev)
                        / K ** 0.5).to(dtype)
    return inp


# the int8 cases of chip_smoke's GMM_CASES (the Mixtral decode, unified and
# prefill calls among them), run by test_grouped_kernels_match_plain beside
# the sweep
INT8_CHIP_CASES = [n for n, c in chip_smoke.GMM_CASES.items()
                   if "int8" in c[1]]


GMM_KINDS = [("bf16", "fwd"), ("fp32", "fwd"), ("int8", "fwd"),
             ("bf16", "t"), ("fp32", "t"), ("bf16", "outer"),
             ("fp32", "outer")]


@pytest.mark.parametrize("case,kind,op",
                         [(c, k, o) for c in GMM_SWEEP for k, o in GMM_KINDS]
                         + [(f"chip:{n}", "int8", "fwd")
                            for n in INT8_CHIP_CASES])
def test_grouped_kernels_match_plain(dev, case, kind, op):
    """Every B7/B8 kernel on the sweep (bf16 x over an int8 bank on
    ``gmm_int8_wgmma_kernel``: row tiles 16, 64 and 128, K split and not)
    and, for the int8 route, on every int8 chip_smoke case.  The int8
    route takes N a multiple of 16 (the bank's row is a TMA stride): a
    sweep width off 16 raises there, and the case runs at N rounded up to
    16 instead, still off the kernel's 128-column tiles."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    if case.startswith("chip:"):
        inp = chip_smoke.gmm_inputs(case[5:], "int8", dev)
    else:
        K, N, lens, bm = GMM_SWEEP[case]
        if kind == "int8" and N % 16:
            with pytest.raises(ValueError, match="multiple of 16"):
                chip_smoke._gmm_call(_gmm_case(dev, K, N, lens, bm, kind, op))
            N = -(-N // 16) * 16
        inp = _gmm_case(dev, K, N, lens, bm, kind, op)
    gm.reset_launches()
    got = chip_smoke._gmm_call(inp)
    torch.cuda.synchronize()
    want = chip_smoke._gmm_call(inp, plain=True)
    key = {"t": "grouped_matmul_t", "outer": "grouped_outer"}.get(
        op, "grouped_matmul_int8" if kind == "int8" else "grouped_matmul")
    assert gm.LAUNCHES[key] == 1 and sum(gm.LAUNCHES.values()) == 1
    err, _ = row_error(got, want)
    print(json.dumps({"case": case, "kind": kind, "op": op,
                      "row_error": err}))
    assert err <= ROW_TOL["fp32" if kind == "fp32" else "bf16"], err


def test_grouped_int8_split_route_is_deterministic(dev):
    """B7 int8 with K split (the Mixtral decode down projection: 4 splits
    by ``gmm_int8_plan``) gives the same bits in two runs: the splits' fp32
    sums are added in split order, no atomics."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    inp = chip_smoke.gmm_inputs("mixtral_decode_down", "int8", dev)
    R, K = inp["x"].shape
    assert gm.gmm_int8_plan(R, K, inp["w"].shape[2], len(inp["lens"]))[1] > 1
    first = chip_smoke._gmm_call(inp)
    second = chip_smoke._gmm_call(inp)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", [n for n, c in chip_smoke.GMM_CASES.items()
                                  if n.startswith("mixtral_")
                                  and "int8" in c[1]])
@pytest.mark.parametrize("rows_inner", [False, True])
def test_grouped_int8_grid_orders_agree(dev, case, rows_inner):
    """B7 int8 with either grid order (row tiles or column tiles
    innermost, whatever ``gmm_int8_plan`` picks) gives the planned order's
    bits on every Mixtral case: a CTA's sums do not depend on when it
    runs."""
    inp = chip_smoke.gmm_inputs(case, "int8", dev)
    planned = chip_smoke._gmm_call(inp)
    with chip_smoke.forced_int8_order(rows_inner):
        got = chip_smoke._gmm_call(inp)
    torch.cuda.synchronize()
    assert torch.equal(got, planned)


@pytest.mark.parametrize("case", [n for n, c in chip_smoke.GMM_CASES.items()
                                  if c[0] != "outer"])
def test_grouped_wgmma_matches_plain_on_every_chip_case(dev, case):
    """B7 on wgmma (bf16 x over a bf16 bank) on every chip_smoke B7 case,
    the Mixtral decode and prefill shapes and the train cell's forward and
    dx included, with the case's op (forward, or transposed for
    train_dx)."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    inp = chip_smoke.gmm_inputs(case, "bf16", dev)
    gm.reset_launches()
    got = chip_smoke._gmm_call(inp)
    torch.cuda.synchronize()
    key = "grouped_matmul_t" if inp["op"] == "t" else "grouped_matmul"
    assert gm.LAUNCHES[key] == 1 and sum(gm.LAUNCHES.values()) == 1
    err, _ = row_error(got, chip_smoke._gmm_call(inp, plain=True))
    print(json.dumps({"case": case, "row_error": err}))
    assert err <= ROW_TOL["bf16"], err


@pytest.mark.parametrize("kind", ["bf16", "fp32", "int8"])
def test_grouped_matmul_repeated_wids_matches_plain(dev, kind):
    """The adapter shape: 12 segments over 3 weight slices."""
    lens = [9, 30, 2, 17, 0, 40, 5, 11, 23, 1, 8, 14]
    inp = _gmm_case(dev, 256, 192, lens, 8, kind, "fwd",
                    wids=[i % 3 for i in range(12)])
    got = chip_smoke._gmm_call(inp)
    torch.cuda.synchronize()
    err, _ = row_error(got, chip_smoke._gmm_call(inp, plain=True))
    assert err <= ROW_TOL["fp32" if kind == "fp32" else "bf16"], err


def test_grouped_wrappers_refuse_on_the_card(dev):
    from paddle_tpu_torch.ops import grouped_matmul as gm
    seg = (torch.zeros(1, dtype=torch.int32, device=dev),) * 3
    x = torch.zeros(8, 12, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.grouped_matmul_raw(x, torch.zeros(1, 12, 8, device=dev), *seg,
                              block_rows=8)
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_matmul_raw(torch.zeros(8, 16, device=dev),
                              torch.zeros(1, 8, 16, device=dev
                                          ).transpose(1, 2), *seg,
                              block_rows=8)
    with pytest.raises(ValueError, match="tensors on"):
        gm.grouped_matmul_raw(torch.zeros(8, 8),
                              torch.zeros(1, 8, 8, device=dev),
                              *(t.cpu() for t in seg), block_rows=8)


def test_dropless_train_step_on_cuda_matches_cpu(dev):
    """The dropless step on the card (B7 forward and dx, B8 dW) against
    the same step on the CPU (plain versions), fp32: 3 steps, loss and
    params within 1e-4 of each tensor's largest magnitude (fp32 sums in
    other orders); 2 + 1 + 2 launches per step (the first GEMM's input,
    the dispatched tokens, needs no gradient, so it gets no dx)."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.parallel.expert import (
        MoEEPConfig, build_moe_ep_dropless_train_step, init_moe_ep_params)

    cfg = MoEEPConfig(d_model=64, d_hidden=128, num_expert=4, top_k=2)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        params = init_moe_ep_params(cfg, seed=2, device=device)
        step = build_moe_ep_dropless_train_step(cfg, block_rows=8)
        losses = []
        for _ in range(3):
            gm.reset_launches()
            loss, _, dropped, _, params = step(params, x.to(device),
                                               t.to(device))
            losses.append(loss.item())
            assert float(dropped) == 0.0
        out[name] = (losses, {k: v.cpu() for k, v in params.items()},
                     dict(gm.LAUNCHES))
    assert set(out["cpu"][2].values()) == {0}
    assert out["gpu"][2] == dict(grouped_matmul=2, grouped_matmul_int8=0,
                                 grouped_matmul_t=1, grouped_outer=2)
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=1e-4)
    for k, want in out["cpu"][1].items():
        got = out["gpu"][1][k]
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item(), k


def _debug_llama():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.debug(vocab=64, hidden=64, layers=2, heads=4,
                            kv_heads=2, inter=128, max_pos=128)
    return cfg, LlamaForCausalLM(
        cfg, device="cpu",
        generator=torch.Generator().manual_seed(5)).functional_state()


# the serving extras on the debug engine: (engine keywords, draft layers,
# a handoff from a prefill_only engine)
ENGINE_EXTRAS = {
    "int8_chunked": (dict(cache_dtype=torch.int8), None, False),
    "int8_unified": (dict(cache_dtype=torch.int8, prefill_token_budget=8),
                     None, False),
    "speculative": (dict(prefill_token_budget=16, speculative_k=2), 1, False),
    "speculative_int8": (dict(prefill_token_budget=16, speculative_k=3,
                              cache_dtype=torch.int8), 2, False),
    "handoff_int8": (dict(prefill_token_budget=16, cache_dtype=torch.int8),
                     None, True),
    "host_tier": (dict(prefill_token_budget=16, enable_prefix_cache=True,
                       host_tier_pages=2, num_pages=9), None, False),
}


def _run_extras(case, device):
    """Tokens of the debug engine on ``device`` with the extras of
    ``case``: three greedy requests (and a seeded sampled one on the
    unified path), the handoff through a prefill_only engine, and the
    launch counts of the decode kernels."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.generation import self_draft_params
    cfg, params = _debug_llama()
    params = {k: v.to(device) for k, v in params.items()}
    kw, layers, handoff = ENGINE_EXTRAS[case]
    kw = dict(dict(max_slots=3, num_pages=33, page_size=16, max_seq_len=128,
                   decode_chunk_steps=4), **kw)
    if layers:
        kw["draft_cfg"], kw["draft_params"] = self_draft_params(cfg, params,
                                                                layers)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 64, n).astype(np.int32) for n in (5, 19, 37)]
    reqs = [(p, dict(max_new_tokens=9)) for p in prompts]
    if "prefill_token_budget" in kw:
        reqs.append((prompts[1], dict(max_new_tokens=9, temperature=0.8,
                                      seed=3)))
    if case == "host_tier":
        # a 90-token prompt demotes the first one's two full pages, which
        # the third request promotes again
        long = rng.integers(1, 64, 90).astype(np.int32)
        reqs = [reqs[2], (long, dict(max_new_tokens=9)), reqs[2]]
    da.reset_launches()
    eng = ContinuousBatchingEngine(cfg, params, device=device, **kw)
    out = {}
    if handoff:
        pre = ContinuousBatchingEngine(cfg, params, device=device,
                                       prefill_only=True, **kw)
        for prompt, rkw in reqs:
            pre.add_request(prompt, **rkw)
            while not pre.handoff_ready:
                pre.step()
            slot = next(iter(pre.handoff_ready))
            tree, meta = pre.export_handoff(slot)
            pre.release_handoff(slot)
            rid = eng.adopt_request(tree, meta, rkw["max_new_tokens"])
            out[rid] = {f.rid: f.tokens for f in eng.run()}[rid].tolist()
        pre.shutdown()
    else:
        for prompt, rkw in reqs:
            if case == "host_tier":     # one at a time, the pool is small
                eng.add_request(prompt, **rkw)
                eng.run()
            else:
                eng.add_request(prompt, **rkw)
        out = {f.rid: f.tokens.tolist() for f in eng.run()}
    stats = eng.serving_stats()
    eng.shutdown()
    return out, dict(da.LAUNCHES), stats


@pytest.mark.parametrize("case", list(ENGINE_EXTRAS))
def test_engine_extras_on_cuda_match_cpu(dev, case):
    """The debug engine in fp32 on the card, with an int8 cache, spec
    decode, a handoff or the host tier, emits the tokens of the same
    engine on the CPU, and every decode attention call of it is a kernel
    launch."""
    got, launches, stats = _run_extras(case, dev)
    want, _, want_stats = _run_extras(case, "cpu")
    assert got == want
    chunked = "prefill_token_budget" not in ENGINE_EXTRAS[case][0]
    key = "paged_decode" if chunked else "ragged_paged_decode"
    assert launches[key] > 0 and launches["flash_decode"] == 0
    assert stats.get("accepted_lengths") == want_stats.get("accepted_lengths")
    if case == "host_tier":
        pc = stats["prefix_cache"]
        assert pc == want_stats["prefix_cache"]
        assert pc["demoted_pages"] > 0 and pc["promoted_pages"] > 0


@pytest.mark.parametrize("kw", [dict(do_sample=True, temperature=0.8,
                                     top_k=20, top_p=0.9, seed=4),
                                dict(num_beams=3, length_penalty=1.2)])
def test_sampling_and_beams_on_cuda(dev, kw):
    """Beam search on the card gives the CPU's beams; sampling on the card
    is seeded (the same tokens twice) and draws within the top-k of the
    CPU's logits; both run B4 at b x beams rows."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    cfg, params = _debug_llama()
    cpu = LlamaForCausalLM(cfg, device="cpu").load_functional_state(params)
    gpu = LlamaForCausalLM(cfg, device=dev).load_functional_state(
        {k: v.to(dev) for k, v in params.items()})
    ids = np.random.default_rng(0).integers(1, 64, (2, 11)).astype(np.int32)
    da.reset_launches()
    got = gpu.generate(ids, max_new_tokens=10, **kw).cpu()
    assert da.LAUNCHES["flash_decode"] == 9 * cfg.num_hidden_layers
    if "num_beams" in kw:
        assert torch.equal(got, cpu.generate(ids, max_new_tokens=10, **kw))
        return
    assert torch.equal(got, gpu.generate(ids, max_new_tokens=10, **kw).cpu())
    logits = cpu(got[:, :-1])[:, 10:]                  # teacher-forced
    kth = logits.topk(kw["top_k"], dim=-1).values[..., -1:]
    picked = logits.gather(-1, got[:, 11:, None].long())
    assert (picked >= kth - 1e-4).all()


def test_sparse_generate_on_cuda_matches_cpu(dev):
    """A toy sparse Llama, fp32 and int8 weight-only, on the card (B7
    float and int8 launches in every layer) emits the CPU's greedy
    tokens."""
    import dataclasses
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.ops import grouped_matmul as gm

    cfg = dataclasses.replace(LlamaConfig.debug(vocab=128, hidden=64,
                                                layers=2, inter=128),
                              num_experts=4, moe_top_k=2)
    int8 = {k: v.float() if v.is_floating_point() else v for k, v in
            chip_smoke.mixtral_params(cfg, torch.device("cpu")).items()}
    # its dequantized fp32 twin: per out channel; the embedding per row
    emb = "model.embed_tokens.weight"
    dense = {k: v.float() * int8[k + "._scale"][..., None, :]
             if k + "._scale" in int8 and k != emb else v
             for k, v in int8.items() if not k.endswith("._scale")}
    dense[emb] = int8[emb].float() * int8[emb + "._scale"][:, None]
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        1, 128, (1, 9)).astype(np.int32))
    for key, params in (("grouped_matmul", dense),
                        ("grouped_matmul_int8", int8)):
        want = gen._generate_greedy(cfg, params, ids, 8, -1)
        gm.reset_launches()
        got = gen._generate_greedy(
            cfg, {k: v.to(dev) for k, v in params.items()}, ids.to(dev), 8,
            -1)
        assert gm.LAUNCHES[key] == 3 * 2 * 8           # layers x 8 passes
        assert torch.equal(got.cpu(), want), key


# faults planted into copies of csrc/grouped_matmul.cu: (text, replacement)
PLANTED_GMM = {
    # B7 int8 (gmm_int8_wgmma_kernel) skips the last row tile of a segment
    # longer than one tile
    "skips_last_row_tile": (
        "  // this split's K steps [c0, c0 + steps); a split past K stores zeros",
        "  if (row0 + NR >= row_end && (a.lens[seg] + a.br - 1) / a.br * a.br "
        "> NR) return;"),
    # B7 int8 drops the int8 bank's dequant scale
    "int8_scale_dropped": (
        "__float2bfloat16(acc[i] * ((i / 2) % 2 ? s1 : s0));",
        "__float2bfloat16(acc[i]);"),
    # B7 int8's reducer drops the last K split's fp32 sums
    "int8_split_dropped": ("for (int sp = 0; sp < splits; ++sp) {",
                           "for (int sp = 0; sp < splits - 1; ++sp) {"),
    # B8 (bf16, wgmma) leaves an empty segment's tile unwritten
    "outer_empty_unwritten": (
        "  const int steps = row_end > base ? (row_end - base + kOutBR - 1) "
        "/ kOutBR : 0;",
        "  const int steps = row_end > base ? (row_end - base + kOutBR - 1) "
        "/ kOutBR : 0;\n  if (steps == 0) return;"),
    # B7 bf16 (gmm_wgmma_kernel) skips its second K step (the ring still
    # turns, so nothing hangs)
    "wgmma_skipped_k_step": (
        "for (int ks = 0; ks < kGmmBK / 16; ++ks) {",
        "for (int ks = 0; ks < (c == 1 ? 0 : kGmmBK / 16); ++ks) {"),
    # B7 bf16 stores its tile's rows past the window's end (the next
    # segment's, or rows no segment covers)
    "wgmma_stores_past_window": ("if (row < row_end && n < a.N)\n      *reinterpret_cast<__nv_bfloat162*>",
                                 "if (row < a.R && n < a.N)\n      *reinterpret_cast<__nv_bfloat162*>"),
}


def _gmm_readings(dev):
    """Gate errors of B7 (bf16, int8) and B8 (bf16) on segments longer
    than one row tile, with an empty segment, without the limits; of B7
    int8 at a decode shape with K split; and of
    B7 bf16 on two windows with rows between them that no segment covers
    (their x rows not zero), whose plain output is exactly 0.  B8's output
    block is recycled from a NaN-filled one first, so a tile left
    unwritten cannot read as zeros by chance."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    out = {}
    g = torch.Generator(device=dev).manual_seed(1)
    i32 = dict(dtype=torch.int32, device=dev)
    gaps = dict(op="fwd", bm=8, scale=None, dy=None,
                x=torch.randn(256, 256, generator=g, device=dev).to(
                    torch.bfloat16),
                w=(torch.randn(2, 256, 256, generator=g, device=dev) / 16
                   ).to(torch.bfloat16),
                starts=torch.tensor([0, 128], **i32),
                lens=torch.tensor([100, 60], **i32),
                wids=torch.tensor([0, 1], **i32))
    assert gm.gmm_route(torch.bfloat16, False) == "wgmma"
    out["fwd[bf16,gaps]"] = row_error(chip_smoke._gmm_call(gaps),
                                      chip_smoke._gmm_call(gaps, plain=True))[0]
    # B7 int8 at a decode shape, K split in 8 (gmm_int8_plan)
    split = _gmm_case(dev, 4096, 256, [2, 3, 1, 2, 2, 2, 3, 1], 8, "int8",
                      "fwd")
    assert gm.gmm_int8_plan(80, 4096, 256, 8) == (16, 8, False, 13 * 8 * 2)
    out["fwd[int8,split]"] = row_error(
        chip_smoke._gmm_call(split), chip_smoke._gmm_call(split, plain=True))[0]
    for kind, op in (("bf16", "fwd"), ("int8", "fwd"), ("bf16", "outer")):
        inp = _gmm_case(dev, 256, 256, [100, 0, 3, 200, 65], 8, kind, op)
        want = chip_smoke._gmm_call(inp, plain=True)
        if op == "outer":
            del want
            torch.full((5, 256, 256), float("nan"), device=dev)
            torch.cuda.synchronize()
            got = chip_smoke._gmm_call(inp)
            want = chip_smoke._gmm_call(inp, plain=True)
        else:
            got = chip_smoke._gmm_call(inp)
        torch.cuda.synchronize()
        out[f"{op}[{kind}]"] = row_error(got, want)[0]
    return out


def test_grouped_gate_catches_planted_faults(dev, tmp_path, monkeypatch):
    """Each planted fault reads at least 10 times over the bf16 limit of
    the output it breaks; the sound kernels read within it."""
    libs = _build_planted(tmp_path, "grouped_matmul.cu", PLANTED_GMM)
    faulty = {"skips_last_row_tile": "fwd[int8]",
              "int8_scale_dropped": "fwd[int8]",
              "int8_split_dropped": "fwd[int8,split]",
              "outer_empty_unwritten": "outer[bf16]",
              "wgmma_skipped_k_step": "fwd[bf16]",
              "wgmma_stores_past_window": "fwd[bf16,gaps]"}
    tol = ROW_TOL["bf16"]
    sound = _gmm_readings(dev)
    print(json.dumps({"kernel": "sound", "tol": tol, "row_error": sound}))
    assert max(sound.values()) <= tol, sound
    for fault, out in faulty.items():
        lib = _build.bind(ctypes.CDLL(str(libs[fault])))
        monkeypatch.setattr(_build, "_lib", lib)
        bad = _gmm_readings(dev)
        monkeypatch.undo()
        print(json.dumps({"kernel": fault, "tol": tol, "row_error": bad}))
        assert bad[out] > 10 * tol, (fault, bad)


# ------------------------------------------------ Hopper layouts and wgmma

@pytest.mark.parametrize("mode", sorted(_build.PROBE_B_SHAPES))
def test_wgmma_probe_matches_matmul(dev, mode):
    """The one-tile layout probe (csrc/wgmma_probe.cu) against torch.matmul
    of the same bf16 tiles in fp32: mode 0 both operands K-major (B1's
    Q K^T, B2's S and dP), 1 A in registers and B MN-major (B1's P V, B2's
    products at d 64), 2 both MN-major with B over four panels (B8's
    x^T dy), 3 A K-major and B MN-major over four panels (B7's forward), 4
    both K-major with B one 256-row panel (B7's dx), 5 A in registers and
    B MN-major over two panels as one n128 product (B2's products at d
    128), 6 both MN-major at n64 with A stored by the threads through
    ``swizzle128`` (B6's fused dq = ds K); 7, 8, 9 an int8 tile [64, 128]
    loaded through the 8-bit tensor map, widened to bf16 panels by
    ``widen_i8_panel`` (A, MN-major) against b K-major at n 16, 64, 128
    (B7 int8's swapped product), the extreme bytes -128 and 127 included.
    Exact products, fp32 sums of 64 terms in another order: 1e-5 of the
    largest |c|."""
    g = torch.Generator(device=dev).manual_seed(mode)
    b = torch.randn(*_build.PROBE_B_SHAPES[mode], generator=g,
                    device=dev).to(torch.bfloat16)
    if mode in _build.PROBE_INT8_MODES:
        a = torch.randint(-127, 128, (64, 128), generator=g, device=dev,
                          dtype=torch.int8)
        a[0, :4] = torch.tensor([-128, 127, -1, 0], dtype=torch.int8)
    else:
        a = torch.randn(64, 64, generator=g, device=dev).to(torch.bfloat16)
    got = _build.wgmma_probe(mode, a, b)
    torch.cuda.synchronize()
    af, bf = a.float(), b.float()
    if mode in _build.PROBE_INT8_MODES:
        want = af.T @ bf.T
    else:
        want = af @ bf.T if mode in (0, 4) else \
            (af.T if mode in (2, 6) else af) @ bf
    err = (got - want).abs().max().item()
    print(json.dumps({"mode": mode, "max_abs_err": err}))
    assert err <= 1e-5 * want.abs().max().item(), err


def test_wgmma_kernels_issue_hgmma(dev):
    """The bf16 B1, B2, B5, B6, B7 and B8 kernels issue wgmma (HGMMA in
    their SASS) and spill nothing (ptxas -v)."""
    _build.library()
    report = _build.kernel_report()
    for name in _build.WGMMA_KERNELS:
        found = {n: r for n, r in report.items() if name in n}
        print(json.dumps(found))
        assert found, name
        for n, r in found.items():
            assert r["hgmma"], n
            assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (n, r)


# ------------------------------------------ memory engine (training left-outs)

@pytest.mark.parametrize("bucket_bytes", [4 << 20, 4 * 1000 + 12, 0])
def test_offloaded_update_on_cuda_equals_apply_flat(dev, bucket_bytes):
    """The streamed update on the card (pinned host buckets, two buckets in
    flight on side streams) against the device-resident ``apply_flat``,
    three steps: bf16 params with fp32 masters, an fp32 group without a
    master, buckets with odd tails; params, masters and moments bit for
    bit."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import memory as M

    g = torch.Generator(device=dev).manual_seed(3)
    shapes = {"a.w": (311, 97), "b.w": (5003,), "c.norm.weight": (777,),
              "d.w": (64, 129)}
    p32 = {k: torch.randn(s, device=dev, generator=g)
           for k, s in shapes.items()}
    p = {k: v.to(torch.float32 if "norm" in k else torch.bfloat16)
         for k, v in p32.items()}
    mask = {k: "norm" not in k for k in p}
    opt = AdamW(learning_rate=1e-3, weight_decay=0.05)
    flat = opt.init_flat_state(p, decay_mask=mask, master_from=p32)
    off = M.init_offloaded_state(opt, p, decay_mask=mask, master_from=p32,
                                 bucket_bytes=bucket_bytes)
    assert all(b.is_pinned() for gs in off["__offload__"].values()
               for bs in gs.values() for b in bs)
    ref, cur = dict(p), {k: v.clone() for k, v in p.items()}
    for step in range(1, 4):
        grads = {k: torch.randn(v.shape, device=dev, generator=g).to(v.dtype)
                 for k, v in p.items()}
        ref, flat = opt.apply_flat(ref, grads, flat, 1e-3, step,
                                   decay_mask=mask)
        cur, off = M.apply_flat_offloaded(opt, cur, grads, off, 1e-3, step,
                                          decay_mask=mask)
        for k in p:
            assert torch.equal(cur[k], ref[k]), (k, step)
    back = M.gather_offloaded_state(off)["__flat__"]
    for name, gs in flat["__flat__"].items():
        for key, val in gs.items():
            assert torch.equal(back[name][key], val.cpu()), (name, key)


@pytest.mark.parametrize("label", ["dots/host", "offload/host",
                                   "none/host/act_offload", "full/host"])
def test_checkpointed_step_on_cuda_matches_no_remat(dev, label):
    """One bf16 step of a small Llama (head dim 128, on B1/B2) under a
    checkpointed policy with the state in pinned host memory, against the
    same step without remat and with the state on the card: loss and
    params within the bf16 gate (2e-2 of the largest magnitude); B1 runs
    twice per layer, B2 once."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import memory as M

    cfg = LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=torch.Generator(device=dev)
                             .manual_seed(0))
    ids = torch.randint(0, 512, (2, 256), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    mc = next(m for m in M.MEMORY_LATTICE if m.label() == label)
    out = {}
    for name, memory in (("plain", M.MemoryConfig()), ("remat", mc)):
        opt = AdamW(1e-3)
        params = {k: v.clone() for k, v in model.functional_state().items()}
        if memory.optimizer_residency == "host":
            state = M.init_offloaded_state(opt, params,
                                           decay_mask=llama_decay_mask(model),
                                           bucket_bytes=1 << 20)
        else:
            state = opt.init_flat_state(params,
                                        decay_mask=llama_decay_mask(model))
        step = build_train_step(model, opt, memory=memory)
        fa.reset_launches()
        loss, params, _ = step(params, state, 0, 1e-3, ids, ids)
        torch.cuda.synchronize()
        out[name] = (float(loss), params, dict(fa.LAUNCHES))
    (lp, pp, cp), (lr_, pr, cr) = out["plain"], out["remat"]
    layers = cfg.num_hidden_layers
    assert cp["flash_attention_fwd"] == layers
    assert cr["flash_attention_fwd"] == 2 * layers
    assert cp["flash_attention_bwd"] == cr["flash_attention_bwd"] == layers
    assert abs(lr_ - lp) <= 2e-2 * abs(lp)
    for k in pp:
        den = pp[k].float().abs().max().item()
        assert (pr[k].float() - pp[k].float()).abs().max().item() \
            <= 2e-2 * den, k


def test_tune_memory_config_on_cuda(dev):
    """The meter and the tuner on the card: each lattice point's measured
    peak of one step of a small Llama; host residency measures below the
    device point of its policy; a larger budget never picks a later
    (costlier) point, and the tightest fitting budget picks its point."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import memory as M

    cfg = LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16)
    ids = torch.randint(0, 512, (2, 256), device=dev)
    lattice = [M.MemoryConfig(remat="none"),
               M.MemoryConfig(remat="none", optimizer_residency="host"),
               M.MemoryConfig(remat="full", optimizer_residency="host")]

    def builder(mc):
        opt = AdamW(1e-3)
        params = {k: v.clone() for k, v in model.functional_state().items()}
        mask = llama_decay_mask(model)
        state = (M.init_offloaded_state(opt, params, decay_mask=mask)
                 if mc.optimizer_residency == "host"
                 else opt.init_flat_state(params, decay_mask=mask))
        step = build_train_step(model, opt, memory=mc)
        return step, (params, state, 0, 1e-3, ids, ids)

    chosen, recs = M.tune_memory_config(builder, 1 << 40, lattice)
    assert chosen == lattice[0] and all(r["fits"] for r in recs)
    peaks = [r["peak_bytes"] for r in recs]
    assert peaks[1] < peaks[0]
    picks = [M.choose_memory_config(recs, b) for b in sorted(peaks)]
    assert all(a >= b for a, b in zip(picks, picks[1:]))
    assert M.choose_memory_config(recs, min(peaks) - 1) is None


# ------------------------------------------- the MoE left-outs' new shapes

@pytest.mark.parametrize("kind", ["bf16", "fp32"])
def test_hb_flash_kernels_at_gpt_moe_shape(dev, kind):
    """B1 and B2 at GPT-MoE's attention (chip_smoke.GPT_MOE_ATTN_SHAPE: b 8,
    s 1024, 16 heads over 16 kv heads, so rep 1, head dim 64), causal,
    against their plain versions with the per-row gate."""
    q, k, v, do = flash_inputs(kind, dev, chip_smoke.GPT_MOE_ATTN_SHAPE)
    scale = 64 ** -0.5
    fa.reset_launches()
    o, lse = fa.hb_flash_forward(q, k, v, True, scale)
    wo, wlse = fa.hb_flash_forward_plain(q, k, v, True, scale)
    grads = fa.hb_flash_backward(q, k, v, wo, wlse, do, True, scale)
    want = fa.hb_flash_backward_plain(q, k, v, wo, wlse, do, True, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd"] == 1
    assert fa.LAUNCHES["flash_attention_bwd"] == 1
    ferr, _ = flash_errors(kind, {"o": o, "lse": lse},
                           {"o": wo, "lse": wlse})
    berr, _ = flash_errors(kind, dict(zip(("dq", "dk", "dv"), grads)),
                           dict(zip(("dq", "dk", "dv"), want)))
    print(json.dumps({"case": ["gpt_moe", kind], **ferr, **berr}))


# MoELayer(1024, 4096, 8, dropless=True) on 8192 tokens, top-2: 16384
# copies over 8 experts; (K, N, op) of its six grouped calls
MOE_LAYER_CALLS = [(1024, 4096, "fwd"), (4096, 1024, "fwd"),
                   (4096, 1024, "t"), (1024, 4096, "t"),
                   (1024, 4096, "outer"), (4096, 1024, "outer")]


@pytest.mark.parametrize("K,N,op", MOE_LAYER_CALLS)
def test_grouped_kernels_at_moe_layer_shape(dev, K, N, op):
    """B7 (forward and dx) and B8 at GPT-MoE's expert shape (d_model 1024,
    d_hidden 4096, 8 experts, 16384 routed rows split by a seeded uneven
    mix, block_rows 8), bf16, against their plain versions with the per-row
    gate; one launch each."""
    from paddle_tpu_torch.ops import grouped_matmul as gm
    lens = chip_smoke._multinomial_lens(16384, 8, 0)
    inp = _gmm_case(dev, K, N, lens, 8, "bf16", op)
    gm.reset_launches()
    got = chip_smoke._gmm_call(inp)
    torch.cuda.synchronize()
    want = chip_smoke._gmm_call(inp, plain=True)
    key = {"t": "grouped_matmul_t", "outer": "grouped_outer"}.get(
        op, "grouped_matmul")
    assert gm.LAUNCHES[key] == 1 and sum(gm.LAUNCHES.values()) == 1
    err, _ = row_error(got, want)
    print(json.dumps({"case": ["moe_layer", K, N, op], "row_error": err}))
    assert err <= ROW_TOL["bf16"], err


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_layer_on_cuda_matches_cpu(dev, dropless):
    """MoELayer in fp32 on the card against the same layer on the CPU: the
    output, l_aux, tokens_dropped and every gradient within 1e-4 of each
    tensor's largest magnitude; the dropless path 2 B7 forward, 2 B7 dx and
    2 B8 launches, the capacity path none."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.ops import grouped_matmul as gm
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(np.float32))
    gw = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    out = {}
    for name, device in (("cpu", "cpu"), ("gpu", dev)):
        layer = MoELayer(64, 128, 4, capacity_factor=1.0, dropless=dropless,
                         device=device)
        with torch.no_grad():
            layer.gate.weight.copy_(gw)
        xd = x.to(device, copy=True).requires_grad_()
        gm.reset_launches()
        y = layer(xd)
        (y.square().sum() + layer.l_aux).backward()
        out[name] = ([y.detach().cpu(), xd.grad.cpu()]
                     + [p.grad.cpu() for p in layer.parameters()],
                     float(layer.l_aux), float(layer.tokens_dropped),
                     dict(gm.LAUNCHES))
    assert set(out["cpu"][3].values()) == {0}
    want = (dict(grouped_matmul=2, grouped_matmul_int8=0,
                 grouped_matmul_t=2, grouped_outer=2) if dropless
            else out["cpu"][3])
    assert out["gpu"][3] == want
    assert out["gpu"][2] == out["cpu"][2]
    assert abs(out["gpu"][1] - out["cpu"][1]) <= 1e-5
    for got, ref in zip(out["gpu"][0], out["cpu"][0]):
        assert (got - ref).abs().max().item() <= \
            1e-4 * ref.abs().max().item()


def test_gpt_moe_train_step_on_cuda_matches_cpu(dev):
    """A small GPT-MoE (head dim 64, so B1/B2 run their kernels) in fp32:
    one SGD step on the card against the same step on the CPU, CE, aux,
    drops and every parameter within 1e-4 of each tensor's largest
    magnitude; one B1 and one B2 launch per layer."""
    from paddle_tpu_torch.models import (GPTMoEConfig, GPTMoEForCausalLM,
                                         build_moe_train_step)
    from paddle_tpu_torch.ops import random as prandom
    from paddle_tpu_torch.optimizer import SGD
    cfg = GPTMoEConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                       num_attention_heads=2, ffn_hidden_size=256,
                       num_experts=4, max_position_embeddings=128)
    prandom.seed(1)
    cpu = GPTMoEForCausalLM(cfg, device="cpu")
    with torch.no_grad():
        cpu.blocks[1].mlp.gate.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(2))
    gpu = GPTMoEForCausalLM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 96))
    lab = rng.integers(0, 256, (2, 96))
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        step = build_moe_train_step(model, SGD(learning_rate=1e-2))
        fa.reset_launches()
        ce, aux, params, _ = step(model.functional_state(), {}, 0, 1e-2, ids,
                                  lab)
        out[name] = (ce.item(), aux.item(),
                     float(model.blocks[1].mlp.tokens_dropped),
                     {k: v.cpu() for k, v in params.items()},
                     dict(fa.LAUNCHES))
    assert set(out["cpu"][4].values()) == {0}
    assert out["gpu"][4] == dict(out["cpu"][4], flash_attention_fwd=2,
                                 flash_attention_bwd=2)
    assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    assert abs(out["gpu"][1] - out["cpu"][1]) <= 1e-4 * abs(out["cpu"][1])
    assert out["gpu"][2] == out["cpu"][2]
    for k, want in out["cpu"][3].items():
        got = out["gpu"][3][k]
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item(), k


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "segments"])
def test_mesh_step_at_world_size_1_launches_as_meshless(dev, tmp_path,
                                                        masked):
    """The mesh train step on a (1, 1, 1) NCCL mesh (one process, the
    FileStore rendezvous) launches the same attention kernels as the
    meshless step (B1/B2, or B5/B6 under segment ids), none of their plain
    versions, and gives its loss and each parameter's change over one fp32
    AdamW step to 1e-5 relative (plus two fp32 ulps of the tensor's
    largest value, the rounding of the new parameter): both are the one
    step body, whose collectives are no-ops at world size 1, on the same
    fp32 numbers."""
    import torch.distributed as dist

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         build_train_step, gather_params,
                                         llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import init_mesh

    cfg = LlamaConfig.debug(vocab=128, hidden=128, layers=2, heads=4,
                            kv_heads=2, inter=256, max_pos=256)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 2, 96))).to(dev)
    lab = torch.from_numpy(rng.integers(0, 128, (2, 2, 96))).to(dev)
    seg = None
    if masked:
        seg = torch.ones(2, 2, 96, dtype=torch.int32, device=dev)
        seg[:, :, 40:] = 2
        seg[:, 1, 90:] = 0
    mesh = init_mesh("cuda", (1, 1, 1), store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        out = {}
        for name in ("meshless", "mesh"):
            model = LlamaForCausalLM(cfg, device=dev,
                                     generator=torch.Generator(
                                         device=dev).manual_seed(3))
            kw = {}
            if name == "mesh":
                apply_llama_sharding(model, mesh)
                kw["mesh"] = mesh
            opt = AdamW(1e-3)
            step = build_train_step(model, opt, compute_dtype=torch.float32,
                                    accum_steps=2, **kw)
            params = model.functional_state()
            before = {k: v.clone() for k, v in gather_params(params).items()}
            state = opt.init_flat_state(params, llama_decay_mask(model))
            fa.reset_launches()
            with chip_smoke.plain_call_counter() as plain:
                loss, params, _ = step(params, state, 0, 1e-3, ids, lab,
                                       attention_mask=seg)
            torch.cuda.synchronize()
            out[name] = (loss.item(),
                         {k: (v - before[k], before[k].abs().max().item())
                          for k, v in gather_params(params).items()},
                         dict(fa.LAUNCHES), dict(plain))
    finally:
        dist.destroy_process_group()
    (l0, p0, n0, c0), (l1, p1, n1, c1) = out["meshless"], out["mesh"]
    assert n1 == n0 and not any(c0.values()) and not any(c1.values())
    fwd = "flash_masked_fwd" if masked else "flash_attention_fwd"
    assert n0[fwd] == 4 and sum(n for k, n in n0.items()
                                if "bwd" in k) >= 4, n0
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    ulp = torch.finfo(torch.float32).eps
    for k, (want, top) in p0.items():
        # Adam's first step moves every element by about lr
        assert want.abs().max().item() > 0.5e-3, k
        assert (p1[k][0] - want).abs().max().item() <= \
            1e-5 * want.abs().max().item() + 2 * ulp * top, k


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "segments"])
def test_overlap_step_at_world_size_1_launches_as_mesh_step(dev, tmp_path,
                                                            masked):
    """The overlap train step (``overlap=OverlapConfig()``) on a (1, 1, 1)
    NCCL mesh launches the mesh step's attention kernels (B1/B2, or B5/B6
    under segment ids) and none of their plain versions, and gives its loss
    and each parameter's change over one fp32 AdamW step to 1e-5 relative
    (plus two fp32 ulps of the tensor's largest value) of the mesh step's:
    at world size 1 the overlap layer runs the mesh layer's arithmetic.
    Against the same overlap step on the CPU (one-rank mesh, plain
    versions) the changes agree as ``_changes_close`` holds them."""
    import torch.distributed as dist

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         build_train_step, gather_params,
                                         llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import Mesh, OverlapConfig, init_mesh

    cfg = LlamaConfig.debug(vocab=128, hidden=128, layers=2, heads=4,
                            kv_heads=2, inter=256, max_pos=256)
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, 128, (2, 2, 96)))
    lab = torch.from_numpy(rng.integers(0, 128, (2, 2, 96)))
    seg = None
    if masked:
        seg = torch.ones(2, 2, 96, dtype=torch.int32)
        seg[:, :, 40:] = 2
        seg[:, 1, 90:] = 0
    init = LlamaForCausalLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    state0 = init.functional_state()
    mesh = init_mesh("cuda", (1, 1, 1), store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    cpu_mesh = Mesh((1, 1, 1), ("dp", "sharding", "mp"), device_type="cpu")
    try:
        out = {}
        for name, where, m, oc in (("mesh", dev, mesh, None),
                                   ("overlap", dev, mesh, OverlapConfig()),
                                   ("cpu", "cpu", cpu_mesh,
                                    OverlapConfig())):
            model = LlamaForCausalLM(cfg, device=where)
            model.load_functional_state({k: v.to(where)
                                         for k, v in state0.items()})
            apply_llama_sharding(model, m)
            opt = AdamW(1e-3)
            step = build_train_step(model, opt, mesh=m,
                                    compute_dtype=torch.float32,
                                    accum_steps=2, overlap=oc)
            params = model.functional_state()
            state = opt.init_flat_state(params, llama_decay_mask(model))
            fa.reset_launches()
            with chip_smoke.plain_call_counter() as plain:
                loss, params, _ = step(
                    params, state, 0, 1e-3, ids.to(where), lab.to(where),
                    attention_mask=None if seg is None else seg.to(where))
            if where != "cpu":
                torch.cuda.synchronize()
            out[name] = (loss.item(),
                         {k: v.cpu() for k, v in gather_params(params).items()},
                         dict(fa.LAUNCHES), dict(plain))
    finally:
        dist.destroy_process_group()
    (l0, p0, n0, c0), (l1, p1, n1, c1) = out["mesh"], out["overlap"]
    assert n1 == n0 and not any(c0.values()) and not any(c1.values())
    fwd = "flash_masked_fwd" if masked else "flash_attention_fwd"
    assert n0[fwd] == 4 and sum(n for k, n in n0.items()
                                if "bwd" in k) >= 4, n0
    assert set(out["cpu"][2].values()) == {0}
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert abs(l1 - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    ulp = torch.finfo(torch.float32).eps
    for k, before in state0.items():
        want, got = p0[k] - before, p1[k] - before
        top = before.abs().max().item()
        assert want.abs().max().item() > 0.5e-3, k
        assert (got - want).abs().max().item() <= \
            1e-5 * want.abs().max().item() + 2 * ulp * top, k
    _changes_close(p1, out["cpu"][1], state0, 1e-3)


def test_overlap_bucket_path_on_cuda(dev, tmp_path):
    """The overlap engine's bucket path (pack, attach, unpack, the sink's
    in-flight reductions, the gradient cut) on CUDA tensors, which the
    world-size-1 train step never plans: ``chip_smoke.overlap_bucket_leg``
    on a (1, 1, 1) NCCL mesh, prefetched and under remat, with the
    engine's transport and with asynchronous NCCL collectives; each
    gradient within ``BUCKET_LEG_TOL`` of plain autograd."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import init_mesh

    mesh = init_mesh("cuda", (1, 1, 1), store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        out = chip_smoke.overlap_bucket_leg(dev, mesh)
    finally:
        dist.destroy_process_group()
    assert len(out["runs"]) == 4
    assert all(r["max_rel_err"] <= chip_smoke.BUCKET_LEG_TOL
               for r in out["runs"].values()), out


# mesh shape and OverlapConfig kwargs of each case of the NCCL gang; the
# coded case (the codec's defaults at block 64: fp8 weights, int8
# stochastic gradients on the inter-slice stage) is held to the same case
# on a gloo gang, not to the uncoded mesh step
NCCL_GANG_CASES = {
    "all_levers": ((1, 2, 2), dict(collective_matmul_min_out_elems=1)),
    "two_stage": ((1, 4, 1), dict(hierarchical="on",
                                  slice_map=(0, 0, 1, 1))),
    "coded": ((1, 4, 1), dict(hierarchical="on", slice_map=(0, 0, 1, 1),
                              codec=dict(block=64))),
}
NCCL_GANG_STEPS = 3


def _nccl_gang_rank(rank, world, root, device, names=None):
    """One rank of ``test_overlap_step_on_four_cards``: each case's (of
    ``names``, default all) mesh step and overlap step, NCCL_GANG_STEPS
    fp32 AdamW steps each from the same seeded weights and batch; rank 0
    saves the losses, the gathered params after the first and the last
    step, the stack's buckets and, for a coded case, the first payload the
    codec packed (the first layer's weight bucket)."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         build_train_step, gather_params)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import OverlapConfig, init_mesh
    from paddle_tpu_torch.parallel import overlap as pov
    from paddle_tpu_torch.parallel.codec import CollectiveCodec

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world)
    cfg = LlamaConfig.debug(vocab=128, hidden=128, layers=2, heads=4,
                            kv_heads=2, inter=256, max_pos=256)
    init = LlamaForCausalLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3)
                            ).functional_state()
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(0, 128, (8, 96)))
    lab = torch.from_numpy(rng.integers(0, 128, (8, 96)))
    out, meshes = {}, {}
    encode = pov.encode_rows
    try:
        for name, (shape, okw) in NCCL_GANG_CASES.items():
            if names is not None and name not in names:
                continue
            if shape not in meshes:
                meshes[shape] = init_mesh(device, shape, store=store,
                                          rank=rank, world_size=world)
            mesh = meshes[shape]
            okw = dict(okw)
            if "codec" in okw:
                okw["codec"] = CollectiveCodec(**okw["codec"])
                packed, grad = [], {}

                def spy(*a, **k):
                    packed.append(encode(*a, **k))
                    if k.get("stochastic") and a[2] == "int8" and not grad:
                        # the first gradient bucket the codec packed: its
                        # fp32 rows and their stochastic int8 payload
                        grad.update(x=a[0].detach().cpu().clone(),
                                    packed=packed[-1].cpu())
                    return packed[-1]

                pov.encode_rows = spy
            for path, oc in (("mesh", None),
                             ("overlap", OverlapConfig(**okw))):
                model = LlamaForCausalLM(cfg, device=device)
                model.load_functional_state({k: v.to(device)
                                             for k, v in init.items()})
                apply_llama_sharding(model, mesh)
                opt = AdamW(1e-3)
                step = build_train_step(model, opt, mesh=mesh,
                                        compute_dtype=torch.float32,
                                        overlap=oc)
                params = model.functional_state()
                state = opt.init_state(params)
                losses, p = [], []
                for i in range(NCCL_GANG_STEPS):
                    loss, params, state = step(params, state, i, 1e-3,
                                               ids.to(device),
                                               lab.to(device))
                    losses.append(loss.item())
                    if i in (0, NCCL_GANG_STEPS - 1):
                        p.append({k: v.cpu() for k, v in
                                  gather_params(params).items()})
                out[f"{name}.{path}"] = dict(
                    losses=losses, params=p,
                    buckets=step.stack.buckets if oc is not None else None)
            if "codec" in okw:
                out[f"{name}.overlap"]["packed"] = packed[0].cpu()
                out[f"{name}.overlap"]["grad"] = dict(grad)
                pov.encode_rows = encode
    finally:
        pov.encode_rows = encode
        dist.destroy_process_group()
    if rank == 0:
        torch.save(dict(out, init=init), os.path.join(root, "out.pt"))


def test_overlap_step_on_four_cards(tmp_path):
    """The overlap step on four cards over NCCL, where its bucket gathers
    and in-flight reduce-scatters are real asynchronous NCCL collectives:
    on (1, 2, 2) with every lever (the ring at any size) and on (1, 4, 1)
    two-stage (slice_map (0, 0, 1, 1)), against the mesh step
    (``overlap=None``) on the same gang: losses to 1e-5 relative, each
    parameter's change over the first step as ``_changes_close`` holds
    it, and the params after the last step within 1e-5 + 1e-5 relative
    but for a 1e-3 share of each tensor (Adam turns the summation orders'
    rounding of near-zero gradients into larger moves in later steps).
    The coded case (C.2) runs again, with the uncoded two-stage case, on
    a gloo gang of four CPU processes: the first packed payload equal
    byte for byte and the params after the first step within 1e-5 but for
    a 1 % share, each of those within 2 lr.  The coded losses take their
    gate from the codec's quanta: each within half the gloo gang's
    coded-to-uncoded gap plus 1e-4 of the gang's coded loss, a floor
    under half the gap, so that losses from the uncoded path fail it
    (measured on four H100s: 4.8e-7, 2.0e-4, 8.3e-5 against half gaps of
    5.0e-4, 3.8e-4, 6.1e-4).  ``test_codec_bytes_equal`` shows
    the codec exact on the card (a gradient bucket's rows encode to the
    CPU's bytes, stochastic int8 included), so the card's coded losses
    differ from the gang's only through the gradients' last bits, which
    the stochastic rounding hashes into whole quanta.  Needs four GPUs."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    _build.build()                      # once, before the ranks load it
    torch.multiprocessing.spawn(_nccl_gang_rank,
                                args=(4, str(tmp_path), "cuda"), nprocs=4,
                                join=True)
    out = torch.load(tmp_path / "out.pt")
    init = out.pop("init")
    for name in NCCL_GANG_CASES:
        if name == "coded":
            continue
        ref, got = out[f"{name}.mesh"], out[f"{name}.overlap"]
        assert got["buckets"], name        # the bucket path ran
        print(json.dumps({"case": name, "mesh": ref["losses"],
                          "overlap": got["losses"],
                          "buckets": got["buckets"]}))
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        _changes_close(got["params"][0], ref["params"][0], init, 1e-3)
        for k, w in ref["params"][1].items():
            diff = (got["params"][1][k] - w).abs()
            assert diff.max().item() <= 2e-3 * NCCL_GANG_STEPS + 1e-6, k
            assert (diff > 1e-5 + 1e-5 * w.abs()).float().mean().item() \
                < 1e-3, k
    cpu_root = tmp_path / "gloo"
    cpu_root.mkdir()
    torch.multiprocessing.spawn(_nccl_gang_rank,
                                args=(4, str(cpu_root), "cpu",
                                      ("two_stage", "coded")),
                                nprocs=4, join=True)
    gloo = torch.load(cpu_root / "out.pt")
    cpu, flat = gloo["coded.overlap"], gloo["two_stage.overlap"]
    got = out["coded.overlap"]
    diff = {k: (got["params"][0][k] - w).abs()
            for k, w in cpu["params"][0].items()}
    print(json.dumps({"case": "coded", "card": got["losses"],
                      "gloo": cpu["losses"], "gloo_uncoded": flat["losses"],
                      "packed_bytes": got["packed"].numel(),
                      "params_max_diff": max(d.max().item()
                                             for d in diff.values())}))
    assert torch.equal(got["packed"], cpu["packed"])
    for c, g, u in zip(got["losses"], cpu["losses"], flat["losses"]):
        gate = 0.5 * abs(g - u) + 1e-4
        assert gate < abs(g - u), (g, u)       # the uncoded path fails it
        assert abs(c - g) <= gate, (c, g, u)
    for k, d in diff.items():
        w = cpu["params"][0][k]
        assert d.max().item() <= 2e-3 + 1e-6, k
        assert (d > 1e-5 + 1e-5 * w.abs()).float().mean().item() <= 0.01, k


def test_codec_bytes_equal(dev, tmp_path):
    """ROADMAP C.2, the codec's part: the exact fp32 rows of the first
    coded gradient bucket of the coded overlap step on a gloo gang of four
    CPU processes (``_nccl_gang_rank``'s capture), encoded by
    ``parallel/codec.py`` on the card and on the CPU: the packed payloads
    equal byte for byte for the int8 stochastic profile (the one the
    gradients ride; its rounding hashes the fp32 bits), int8 to nearest and
    fp8, checksummed or not, and equal to the payload the gang itself
    packed.  One card."""
    from paddle_tpu_torch.parallel.codec import (CollectiveCodec,
                                                 encode_rows)

    torch.multiprocessing.spawn(_nccl_gang_rank,
                                args=(4, str(tmp_path), "cpu", ("coded",)),
                                nprocs=4, join=True)
    grad = torch.load(tmp_path / "out.pt")["coded.overlap"]["grad"]
    x = grad["x"]
    assert x.dtype == torch.float32 and x.numel() > 0
    rows = {}
    for checksum in (False, True):
        codec = CollectiveCodec(block=NCCL_GANG_CASES["coded"][1]["codec"][
            "block"], checksum=checksum)
        for profile, stochastic in (("int8", True), ("int8", False),
                                    ("fp8", False)):
            cpu = encode_rows(x, codec, profile, stochastic=stochastic)
            card = encode_rows(x.to(dev), codec, profile,
                               stochastic=stochastic).cpu()
            tag = f"{profile}{'_sr' if stochastic else ''}" \
                  f"{'_ck' if checksum else ''}"
            rows[tag] = int((card != cpu).sum().item())
            if profile == "int8" and stochastic and not checksum:
                rows["gang_vs_cpu"] = int((grad["packed"] != cpu).sum()
                                          .item())
    print(json.dumps({"c2_codec_bytes": {"rows": list(x.shape),
                                         "differing_bytes": rows}}))
    assert all(v == 0 for v in rows.values()), rows


# ------------------------------------------------- the serving fleet (A6.2)


def test_coded_delivery_decodes_on_card_bit_equal(dev):
    """The coded weight delivery onto a one-rank cuda mesh: the packed
    bytes are what the staging buffer carries (staged bytes equal
    ``plan_wire_bytes``' wire bytes), the decode runs on the card, and
    each leaf equals the CPU decode of the bytes that crossed, bit for
    bit; an int8 leaf rides the exact path; ``decode_jit`` placed on the
    card equals it placed on the CPU."""
    from paddle_tpu_torch.parallel import reshard as R
    from paddle_tpu_torch.parallel.codec import (CollectiveCodec,
                                                 decode_jit, decode_rows)
    from paddle_tpu_torch.parallel.specs import Mesh, P

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(384, 1024, generator=g).to(torch.bfloat16),
            "b": torch.randn(1000, generator=g),
            "i": torch.arange(77, dtype=torch.int32)}
    mesh = Mesh((1,), ("replica",), device_type="cuda")
    for profile in ("int8", "fp8"):
        codec = CollectiveCodec(weight_profile=profile, block=256,
                                checksum=profile == "fp8")
        plan = R.plan_reshard(tree, mesh, None, max_transient_bytes=1 << 18)
        wire = {}

        def capture(packed, path, chunk):
            wire[(path, chunk)] = packed
            return packed

        out = R.execute_encoded(plan, tree, codec, corrupt=capture)
        assert plan.telemetry["last_staged_bytes"] == \
            R.plan_wire_bytes(plan, codec)["wire_bytes"]
        assert torch.equal(out["i"].cpu(), tree["i"])
        for lp in plan.leaf_plans:
            if lp.path == "i":
                continue
            leaf = out[lp.path]
            assert leaf.device.type == "cuda"
            axis = lp.chunk_axis or 0
            spans = lp.chunks if lp.chunk_axis is not None \
                else [(0, leaf.shape[0])]
            assert len(spans) > 1 or lp.path == "b"
            for ci, (a, b) in enumerate(spans):
                card = leaf.narrow(axis, a, b - a).cpu()
                packed = torch.from_numpy(wire[(lp.path, ci)])
                cpu = decode_rows(packed, card.numel(), codec, profile,
                                  out_dtype=card.dtype).reshape(card.shape)
                assert torch.equal(card, cpu), (profile, lp.path, ci)
                on_card = decode_jit(tuple(card.shape), card.dtype, codec,
                                     profile, out_sharding=(mesh, P()))
                assert torch.equal(on_card(packed).cpu(), cpu)


def _fleet_tokens(device, disagg):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_fault_injection as T

    cfg, params = _debug_llama()
    host = {k: v.numpy() for k, v in params.items()}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32)
               for n in (5, 9, 17, 7, 20, 11)]
    da.reset_launches()
    if disagg:
        router, rs = T.build_disagg_fleet(
            cfg, host, prefill=1, decode=1, device=device,
            cache_dtype=torch.int8, host_tier_pages=4,
            scripts={1: [T.ReplicaFaultEvent(step=4, kind="kill")]})
    else:
        router, rs = T.build_serving_fleet(
            cfg, host, target=2, device=device,
            scripts={0: [T.ReplicaFaultEvent(step=2, kind="kill")]})
    rids = [router.submit(p, max_new_tokens=6) for p in prompts]
    out = router.run()
    events = [(ev.fault, ev.migrated_requests)
              for ev in router.telemetry["recoveries"]]
    return ({r: out[r].tolist() for r in rids}, events, dict(da.LAUNCHES),
            dict(rs.telemetry))


@pytest.mark.parametrize("disagg", [False, True])
def test_fleet_on_cuda_matches_cpu(dev, disagg):
    """The debug model's fleet (two unified replicas, a kill) and its
    disaggregated int8 fleet (a decode-replica kill) in fp32 on the card
    emit the CPU fleets' tokens with the same recoveries and telemetry,
    every attention call a B3' launch."""
    got, events, launches, tel = _fleet_tokens(dev, disagg)
    want, want_events, _, want_tel = _fleet_tokens("cpu", disagg)
    assert got == want and events == want_events and tel == want_tel
    assert launches["ragged_paged_decode"] > 0
    assert launches["flash_decode"] == launches["paged_decode"] == 0


# ------------------------------------------- training resilience (A6.1)

RESIL4_CFG = dict(vocab=128, hidden=128, layers=2, heads=4, kv_heads=2,
                  inter=256, max_pos=256)
RESIL4_LR = 1e-3


def _resil4_batch(step, device):
    rng = np.random.default_rng(100 + step)
    return (torch.from_numpy(rng.integers(0, 128, (8, 96))).to(device),
            torch.from_numpy(rng.integers(0, 128, (8, 96))).to(device))


def _resil4_init():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.debug(**RESIL4_CFG)
    return cfg, LlamaForCausalLM(
        cfg, device="cpu",
        generator=torch.Generator().manual_seed(5)).functional_state()


class _StateSpecs:
    """The reshard planner's rule for a {"params", "opt", "t"} state: a
    param and its optimizer state take the schedule's placement of the
    param."""

    def __init__(self, sched):
        self.sched = sched

    def reshard_spec(self, path, leaf=None):
        from paddle_tpu_torch.parallel.specs import P

        head, _, rest = path.partition(".")
        if head == "opt":
            rest = rest.rsplit(".", 1)[0]
        elif head != "params":
            return P()
        return self.sched.reshard_spec(rest, leaf)

    def rederive(self, mesh):
        return _StateSpecs(self.sched.rederive(mesh))


def _resilience_rank(rank, world, root, device):
    """One rank of ``test_resilience_on_four_cards``: the debug Llama,
    fp32, on a (1, n, 1) dp x sharding x mp mesh (ZeRO-3 over sharding)
    through ``resilient_train_loop`` and the harness's script
    (tests/torch_fault_injection.py ``GANG_FAULTS``: 4 -> 2 ranks by
    preemption, a kill on 2, back to 4); rank 0 saves its losses, the
    recovery events and the state's bytes."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed.resilience import (ResilienceConfig,
                                                         resilient_train_loop)
    from paddle_tpu_torch.models import LlamaForCausalLM, build_train_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PartitionSchedule
    from paddle_tpu_torch.parallel.specs import Mesh
    from torch_fault_injection import (GANG_FAULTS, GANG_STEPS, FaultEvent,
                                       GangFakeCluster)

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world)
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world, **kw)
    cfg, init = _resil4_init()
    model = LlamaForCausalLM(cfg, device=device)
    opt = AdamW(RESIL4_LR)
    nbytes = {}

    def mesh_builder(devices):
        mesh = Mesh((1, len(devices), 1), ("dp", "sharding", "mp"),
                    device_type=device)
        return mesh, _StateSpecs(PartitionSchedule.from_model(model, mesh))

    def init_fn(mesh, specs):
        params = {k: specs.sched.named_sharding(k, tuple(v.shape)).shard(
            v.to(device)) for k, v in init.items()}
        state = {"params": params, "opt": opt.init_state(params), "t": 0}
        nbytes["state"] = sum(
            math.prod(x.shape) * x.local.element_size()
            for x in list(params.values())
            + [t for st in state["opt"].values() for t in st.values()])
        return state

    def step_builder(mesh, specs):
        step = build_train_step(model, opt, mesh=mesh,
                                compute_dtype=torch.float32,
                                schedule=specs.sched)

        def step_fn(st, batch):
            loss, p, s = step(st["params"], st["opt"], st["t"], RESIL4_LR,
                              *batch)
            return loss, {"params": p, "opt": s, "t": st["t"] + 1}

        return step_fn

    cluster = GangFakeCluster(store, rank, world, device_type=device,
                              faults=[FaultEvent(step=s, kind=k,
                                                 device_count=n)
                                      for k, s, n in GANG_FAULTS])
    conf = ResilienceConfig(checkpoint_dir=os.path.join(root, "ckpt"),
                            checkpoint_every=4)
    res = resilient_train_loop(
        mesh_builder=mesh_builder, init_fn=init_fn, step_builder=step_builder,
        data_fn=lambda s: _resil4_batch(s, device), num_steps=GANG_STEPS,
        config=conf, cluster=cluster)
    if rank == 0:
        torch.save({"losses": res.losses, "state_bytes": nbytes["state"],
                    "recoveries": [e.__dict__ for e in res.recoveries],
                    "final_step": res.final_step},
                   os.path.join(root, "resil.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _resil4_one_card(device):
    """The same steps on one device (mesh=None): the reference losses."""
    from paddle_tpu_torch.models import LlamaForCausalLM, build_train_step
    from paddle_tpu_torch.optimizer import AdamW
    from torch_fault_injection import GANG_STEPS

    cfg, init = _resil4_init()
    model = LlamaForCausalLM(cfg, device=device)
    opt = AdamW(RESIL4_LR)
    step = build_train_step(model, opt, compute_dtype=torch.float32)
    params = {k: v.to(device) for k, v in init.items()}
    state = opt.init_state(params)
    losses = {}
    for i in range(GANG_STEPS):
        loss, params, state = step(params, state, i, RESIL4_LR,
                                   *_resil4_batch(i, device))
        losses[i] = loss.item()
    return losses


def _resil4_check(out, ref):
    """The script's predicted recovery events and the one-card losses
    within 1e-5 relative."""
    b = out["state_bytes"]
    want = [dict(step=5, fault="Preemption", resume_step=5, steps_replayed=0,
                 restart_index=1, rendezvous_attempts=1, device_count=2,
                 reshard_bytes=b, checkpointed=True, degraded_steps=[]),
            dict(step=7, fault="WorkerLost", resume_step=5, steps_replayed=2,
                 restart_index=2, rendezvous_attempts=1, device_count=2,
                 reshard_bytes=0, checkpointed=False, degraded_steps=[]),
            dict(step=10, fault="Preemption", resume_step=10,
                 steps_replayed=0, restart_index=3, rendezvous_attempts=1,
                 device_count=4, reshard_bytes=b, checkpointed=True,
                 degraded_steps=[])]
    assert out["recoveries"] == want, out["recoveries"]
    assert sorted(out["losses"]) == sorted(ref)
    for s, v in ref.items():
        assert abs(out["losses"][s] - v) <= 1e-5 * abs(v), (s, v)


def test_resilience_on_four_cards(tmp_path):
    """ROADMAP A6.1 on four cards over NCCL: the resilient loop scales the
    ZeRO-3 debug Llama from 4 ranks to 2 by preemption (the live reshard
    over the old group, a new process group, ranks 2 and 3 parked, zero
    replay), restores a kill on 2 ranks from the 4-rank checkpoint
    (reshard-on-load), and grows back to 4 by restoring the grace
    window's checkpoint onto the new mesh; the recovery events as the
    script predicts and the losses within 1e-5 relative of the one-card
    run (fp32, different reduction orders).  Needs four GPUs; rehearse on
    gloo with ``_resilience_rank(rank, 4, root, "cpu")``."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    _build.build()
    torch.multiprocessing.spawn(_resilience_rank,
                                args=(4, str(tmp_path), "cuda"), nprocs=4,
                                join=True)
    out = torch.load(tmp_path / "resil.pt")
    ref = _resil4_one_card(torch.device("cuda"))
    print(json.dumps({"resilience_four_cards": out["recoveries"],
                      "losses": out["losses"], "one_card": ref}))
    _resil4_check(out, ref)


def test_watchdog_aborts_a_hung_nccl_group(tmp_path):
    """The comm watchdog on two cards over NCCL: rank 0 blocks on an
    all_reduce that rank 1 never joins (the host waits in the sync after
    it); past 1 s the watchdog aborts the process groups through
    ``distributed_c10d._abort_process_group`` (ncclCommAbort) and the
    process exits with 124, whichever ends first: the abort, or the main
    thread that the abort released.  Prints whether the blocked call
    returned and whether the abort did.  Needs two GPUs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from torch_fault_injection import run_hung_collective

    rc, out, err = run_hung_collective(str(tmp_path), "nccl")
    print(json.dumps({"watchdog_nccl": {
        "rc": rc, "call_returned": "returned" in out,
        "abort_returned": "_abort_process_group returned" in err}}))
    assert rc == 124, err
    assert "task 'hung_all_reduce' hung" in err, err
    assert "_abort_process_group (backend nccl)" in err, err


# -------------------------------------------- expert parallelism (A5.3)

# the EP legs' MoE block on the card: bf16 tokens at widths whose B7/B8
# launches take the wgmma route
EP_CARD_CFG = dict(d_model=256, d_hidden=512, num_expert=8, top_k=2)
EP_CARD_TOKENS = 1024
# a GPT-MoE whose head dim (64) the flash kernels take (the debug config's
# 8 is no kernel shape)
GPT_MOE_CARD_CFG = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, ffn_hidden_size=256,
                        num_experts=4, max_position_embeddings=128)


def _ep_inputs(cfg, tokens, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(tokens, cfg.d_model, generator=g)
    t = torch.randn(tokens, cfg.d_model, generator=g)
    return x.to(device, torch.bfloat16), t.to(device)


def _gpt_moe_card_model(device):
    """GPT_MOE_CARD_CFG drawn on the CPU from seed 1 (gates N(0, 0.1^2)),
    then moved to ``device``."""
    from paddle_tpu_torch.models import GPTMoEConfig, GPTMoEForCausalLM
    from paddle_tpu_torch.ops import random as prandom

    cfg = GPTMoEConfig(**GPT_MOE_CARD_CFG)
    prandom.seed(1)
    cpu = GPTMoEForCausalLM(cfg, device="cpu")
    with torch.no_grad():
        for blk in cpu.blocks:
            if blk.use_moe:
                blk.mlp.gate.weight.normal_(
                    0.0, 0.1, generator=torch.Generator().manual_seed(2))
    model = GPTMoEForCausalLM(cfg, device=device)
    model.load_state_dict(cpu.state_dict())
    return model


def _gpt_moe_steps(model, mesh, steps, ids, lab, lr=1e-3):
    from paddle_tpu_torch.models import build_moe_train_step
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=lr)
    params = model.functional_state()
    if mesh is None:
        params = {k: v.clone() for k, v in params.items()}
    state = opt.init_state(params)
    step = build_moe_train_step(model, opt, mesh=mesh)
    ces = []
    for i in range(steps):
        ce, _, params, state = step(params, state, i, lr, ids, lab)
        ces.append(ce.item())
    return ces


@pytest.mark.parametrize("path", ["dropless", "capacity", "gpt_moe"])
def test_moe_ep_at_world_size_1_matches_meshless(dev, tmp_path, path):
    """Expert parallelism's steps on a (1, 1, 1) NCCL mesh (one process, the
    FileStore rendezvous) against ``mesh=None``, the one step body of each:
    the dropless and capacity EP steps (EP_CARD_CFG, bf16 tokens, 2 SGD
    steps) and GPT-MoE (GPT_MOE_CARD_CFG, fp32, 2 AdamW steps) give equal
    losses bit for bit; the dropless step launches 2 B7 forward, 1 B7 dx
    and 2 B8 a step, the capacity step no grouped kernel, GPT-MoE one B1
    and one B2 per layer a step; no plain version anywhere."""
    import torch.distributed as dist

    from paddle_tpu_torch.models import apply_gpt_moe_sharding
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.parallel import expert as pexp
    from paddle_tpu_torch.parallel import init_mesh

    axes = ("dp", "ep", "mp") if path == "gpt_moe" else ("dp", "sharding",
                                                         "ep")
    mesh = init_mesh("cuda", (1, 1, 1), axes, store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        out = {}
        for name, m in (("meshless", None), ("mesh", mesh)):
            if path == "gpt_moe":
                model = _gpt_moe_card_model(dev)
                if m is not None:
                    apply_gpt_moe_sharding(model, m)
                rng = np.random.default_rng(0)
                ids = torch.from_numpy(rng.integers(0, 256, (2, 96))).to(dev)
                lab = torch.from_numpy(rng.integers(0, 256, (2, 96))).to(dev)
                fa.reset_launches()
                with chip_smoke.plain_call_counter() as plain:
                    losses = _gpt_moe_steps(model, m, 2, ids, lab)
                out[name] = (losses, dict(fa.LAUNCHES), dict(plain))
                continue
            cfg = pexp.MoEEPConfig(**EP_CARD_CFG)
            build = (pexp.build_moe_ep_dropless_train_step
                     if path == "dropless" else pexp.build_moe_ep_train_step)
            step = build(cfg, m, lr=1e-2)
            params = pexp.init_moe_ep_params(cfg, seed=3, device=dev)
            x, t = _ep_inputs(cfg, EP_CARD_TOKENS, dev)
            losses = []
            with chip_smoke.moe_counter() as plain:
                for _ in range(2):
                    losses.append(step(params, x, t)[0].item())
                launches = dict(gm.LAUNCHES)
            out[name] = (losses, launches, dict(plain))
    finally:
        dist.destroy_process_group()
    (l0, n0, c0), (l1, n1, c1) = out["meshless"], out["mesh"]
    assert l1 == l0, (l1, l0)
    assert n1 == n0 and not any(c0.values()) and not any(c1.values())
    if path == "gpt_moe":
        assert n0["flash_attention_fwd"] == n0["flash_attention_bwd"] == 4
    elif path == "dropless":
        assert n0 == dict(grouped_matmul=4, grouped_matmul_int8=0,
                          grouped_matmul_t=2, grouped_outer=4), n0
    else:
        assert set(n0.values()) == {0}, n0


def _card_names():
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()


# the four-card dropless step: d_model 1024, d_hidden 4096, 8 experts,
# 4096 bf16 tokens (B7/B8 on their wgmma route)
EP_FOUR_CFG = dict(d_model=1024, d_hidden=4096, num_expert=8, top_k=2)
EP_FOUR_TOKENS = 4096
EP_FOUR_STEPS = 3


def _moe_ep_gang_rank(rank, world, root, device):
    """One rank of ``test_moe_ep_on_four_cards``: the flat and two-stage
    exchanges on an ``x`` axis of four, the dropless EP step on (1, 1, 4)
    and GPT-MoE on (1, 2, 2); rank 0 also runs the degree-1 steps
    (``mesh=None``) on its card and saves everything."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed.topology import hierarchical_axis
    from paddle_tpu_torch.models import apply_gpt_moe_sharding
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.parallel import compat, init_mesh
    from paddle_tpu_torch.parallel import expert as pexp
    from paddle_tpu_torch.parallel.overlap import register_hier

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world)
    out = {}
    try:
        mesh = init_mesh(device, (4,), ("x",), store=store, rank=rank,
                         world_size=world)
        hier = hierarchical_axis(mesh, "x", (0, 0, 1, 1))
        register_hier(mesh, "x", hier)
        g = torch.Generator().manual_seed(10 + rank)
        x = torch.randn(64, 96, generator=g).to(device)
        flat = compat._all_to_all_raw(x, "x", 0, 0, mesh, True)
        ex = pexp.make_ep_all_to_all("x", hier, mesh=mesh)
        two = ex(x)
        ok = torch.tensor([float(torch.equal(two, flat)
                                 and torch.equal(ex(two), x))],
                          device=device)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        out["exchange_equal"] = bool(ok.item())

        cfg = pexp.MoEEPConfig(**EP_FOUR_CFG)
        x2d, tgt = _ep_inputs(cfg, EP_FOUR_TOKENS, device, seed=5)
        mesh = init_mesh(device, (1, 1, 4), ("dp", "sharding", "ep"),
                         store=store, rank=rank, world_size=world)
        for name, m in (("ep", mesh), ("one_card", None)):
            if name == "one_card" and rank != 0:
                continue
            step = pexp.build_moe_ep_dropless_train_step(cfg, m, lr=3e-3)
            params = pexp.init_moe_ep_params(cfg, m, seed=4, device=device)
            losses, launches = [], []
            for _ in range(EP_FOUR_STEPS):
                gm.reset_launches()
                loss, _, dropped, _, params = step(params, x2d, tgt)
                losses.append(loss.item())
                launches.append(dict(gm.LAUNCHES))
                assert float(dropped) == 0.0
            out[f"dropless.{name}"] = dict(losses=losses, launches=launches)
            del params, step
        # the capacity step (C.3) in fp32 at a capacity factor with room
        # for every token (no drop at either degree)
        cap_cfg = pexp.MoEEPConfig(**EP_FOUR_CFG, capacity_factor=4.0)
        for name, m in (("ep", mesh), ("one_card", None)):
            if name == "one_card" and rank != 0:
                continue
            step = pexp.build_moe_ep_train_step(cap_cfg, m, lr=3e-3)
            params = pexp.init_moe_ep_params(cap_cfg, m, seed=4,
                                             device=device)
            losses = []
            for _ in range(EP_FOUR_STEPS):
                loss, _, dropped, _, params = step(params, x2d.float(), tgt)
                losses.append(loss.item())
                assert float(dropped) == 0.0
            out[f"capacity.{name}"] = dict(losses=losses)
            del params, step

        mesh = init_mesh(device, (1, 2, 2), ("dp", "ep", "mp"), store=store,
                         rank=rank, world_size=world)
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(0, 256, (2, 96))).to(device)
        lab = torch.from_numpy(rng.integers(0, 256, (2, 96))).to(device)
        model = _gpt_moe_card_model(device)
        if rank == 0:
            out["gpt_moe.one_card"] = _gpt_moe_steps(model, None, 3, ids,
                                                     lab)
        apply_gpt_moe_sharding(model, mesh)
        out["gpt_moe.mesh"] = _gpt_moe_steps(model, mesh, 3, ids, lab)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(out, os.path.join(root, "out.pt"))


# the coded EP legs (C.2): the exchange's input (tests/
# test_torch_expert_parallel.py's ``_coded_x``, int8 stochastic, block 32)
# and the dropless step's (EP_CARD_CFG, fp32 tokens, block 64)
CODED_X_BLOCK, CODED_STEP_BLOCK = 32, 64


def _coded_ep_rank(rank, world, root, device):
    """The coded EP legs on four ranks of ``device`` (NCCL on cards, gloo
    on the CPU): the coded two-stage exchange on an ``x`` axis of four
    (slice map (0, 0, 1, 1)) beside the flat one, and one dropless SGD step
    on (dp, sharding, ep) = (1, 1, 4) coded and uncoded; the first payload
    each packed, the outputs, the losses and the quanta.  Every rank saves
    its results."""
    import os

    import torch.distributed as dist

    from paddle_tpu_torch.distributed.topology import hierarchical_axis
    from paddle_tpu_torch.parallel import compat, init_mesh
    from paddle_tpu_torch.parallel import expert as pexp
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import (OverlapConfig,
                                                   register_hier)

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world)
    out, packed, quanta = {}, [], []
    encode = pexp.encode_rows

    def spy(rows, *a, **k):
        quanta.append(float(rows.abs().max()) / 127.0)
        packed.append(encode(rows, *a, **k))
        return packed[-1]

    try:
        mesh = init_mesh(device, (4,), ("x",), store=store, rank=rank,
                         world_size=world)
        hier = hierarchical_axis(mesh, "x", (0, 0, 1, 1))
        register_hier(mesh, "x", hier)
        x = torch.from_numpy(np.random.RandomState(3).randn(32, 8).astype(
            np.float32)[rank * 8:(rank + 1) * 8]).to(device)
        pexp.encode_rows = spy
        out["x.coded"] = pexp.make_ep_all_to_all(
            "x", hier, CollectiveCodec(block=CODED_X_BLOCK),
            mesh=mesh)(x).cpu()
        out["x.packed"] = packed[0].cpu()
        out["x.flat"] = compat._all_to_all_raw(x, "x", 0, 0, mesh,
                                               True).cpu()
        cfg = pexp.MoEEPConfig(**EP_CARD_CFG)
        x2d, tgt = _ep_inputs(cfg, EP_CARD_TOKENS, device, seed=6)
        mesh = init_mesh(device, (1, 1, 4), ("dp", "sharding", "ep"),
                         store=store, rank=rank, world_size=world)
        oc = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1),
                           codec=CollectiveCodec(block=CODED_STEP_BLOCK))
        for name, o in (("flat", None), ("coded", oc)):
            packed.clear()
            quanta.clear()
            step = pexp.build_moe_ep_dropless_train_step(cfg, mesh, oc=o,
                                                         lr=3e-3)
            params = pexp.init_moe_ep_params(cfg, mesh, seed=4,
                                             device=device)
            out[f"step.{name}.loss"] = step(params, x2d.float(), tgt)[0] \
                .item()
            if name == "coded":
                out["step.packed"] = packed[0].cpu()
                out["step.quantum"] = max(quanta)
    finally:
        pexp.encode_rows = encode
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"coded.{rank}.pt"))


def test_moe_ep_on_four_cards(tmp_path):
    """Expert parallelism over NCCL on four cards: the two-stage exchange
    (slice map (0, 0, 1, 1), codec off) equal to the flat one bit for bit
    on CUDA tensors, and an involution; the dropless EP step on (dp,
    sharding, ep) = (1, 1, 4) (EP_FOUR_CFG, 4096 bf16 tokens, 3 SGD steps
    at 3e-3), rank 0's B7/B8 launches 2 forward, 1 dx and 2 dW a step,
    its losses within 1e-5 relative of the one-card degree-1 step on the
    same global batch at step 0 and within 1e-3 after (C.3); the capacity
    EP step on (1, 1, 4) the same way (fp32 tokens, capacity factor 4:
    no drop at either degree); GPT-MoE (GPT_MOE_CARD_CFG, fp32, 3 AdamW
    steps) on (dp, ep, mp) = (1, 2, 2) within 1e-5 of ``mesh=None``.  The
    coded legs (C.2, ``_coded_ep_rank``) run on the cards and again on a
    gloo gang of four CPU processes: the packed payloads of the coded
    exchange and of the coded step's first exchange equal byte for byte,
    the coded exchange within 1.5 quanta of the flat one, and the coded
    step's loss within the CPU gang's coded-step budget of the gloo run's
    (half the coded-to-flat loss gap plus 1e-3 relative).  Prints each
    card's name and power limit.  Needs four GPUs."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    for line in _card_names():
        print(line)
    _build.build()                      # once, before the ranks load it
    torch.multiprocessing.spawn(_moe_ep_gang_rank,
                                args=(4, str(tmp_path), "cuda"), nprocs=4,
                                join=True)
    out = torch.load(tmp_path / "out.pt")
    print(json.dumps(out))
    assert out["exchange_equal"]
    ep, one = out["dropless.ep"], out["dropless.one_card"]
    want = dict(grouped_matmul=2, grouped_matmul_int8=0, grouped_matmul_t=1,
                grouped_outer=2)
    assert all(n == want for n in ep["launches"]), ep["launches"]
    for what in ("dropless", "capacity"):
        got, ref = out[f"{what}.ep"]["losses"], \
            out[f"{what}.one_card"]["losses"]
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-3,
                                   err_msg=what)
        assert got[-1] < got[0], what
    roots = {}
    for device in ("cuda", "cpu"):
        roots[device] = tmp_path / f"coded_{device}"
        roots[device].mkdir()
        torch.multiprocessing.spawn(_coded_ep_rank,
                                    args=(4, str(roots[device]), device),
                                    nprocs=4, join=True)
    for r in range(4):
        card, cpu = (torch.load(roots[d] / f"coded.{r}.pt")
                     for d in ("cuda", "cpu"))
        assert torch.equal(card["x.packed"], cpu["x.packed"]), r
        assert torch.equal(card["step.packed"], cpu["step.packed"]), r
        bound = 1.5 * float(np.abs(np.random.RandomState(3).randn(
            32, 8)).max()) / 127.0
        assert (card["x.coded"] - card["x.flat"]).abs().max().item() \
            <= bound, r
        gap = abs(cpu["step.coded.loss"] - cpu["step.flat.loss"])
        print(json.dumps({"rank": r, "coded_card": card["step.coded.loss"],
                          "coded_gloo": cpu["step.coded.loss"],
                          "flat_gloo": cpu["step.flat.loss"],
                          "quantum": card["step.quantum"]}))
        assert abs(card["step.coded.loss"] - cpu["step.coded.loss"]) <= \
            0.5 * gap + 1e-3 * abs(cpu["step.coded.loss"]), r
    np.testing.assert_allclose(out["gpt_moe.mesh"], out["gpt_moe.one_card"],
                               rtol=1e-5)


# ------------------------------------ sequence and pipeline parallelism (A5.4, A5.5)

# the four-card hybrid legs at the card's sizes: the long-context attention
# shape (b, s, q heads, kv heads, head dim) and the train cell
HYBRID_FOUR = dict(seq_shape=chip_smoke.SEQ_SHAPE, cfg=chip_smoke.TRAIN_CFG,
                   batch=chip_smoke.TRAIN_BATCH, seq=chip_smoke.TRAIN_SEQ,
                   fp32_layers=2)
# (name, mesh degrees, build_hybrid_train_step kwargs) of the train-cell
# runs; "fp32" runs the first at fp32 compute and depth fp32_layers
HYBRID_FOUR_RUNS = (("ulysses", dict(pp=2, sep=2), {}),
                    ("ring", dict(pp=2, sep=2), {"sep_attn": "ring"}),
                    ("1F1B", dict(pp=2, sharding=2), {"schedule": "1F1B"}))


def _hybrid_gang_rank(rank, world, root, device, sizes):
    """One rank of ``test_hybrid_on_four_cards``: ring and Ulysses attention
    at sep 4 on ``sizes["seq_shape"]`` (each rank its sequence block, the
    outputs and grads gathered; launches per rank), then the train cell's
    hybrid step on each of HYBRID_FOUR_RUNS (bf16 compute, 2
    micro-batches, one AdamW step) and the first again in fp32 at depth
    ``fp32_layers``; rank 0 also runs the one-card references
    (``flash_attention`` on the whole sequence, ``build_train_step(mesh=
    None)``) and saves everything."""
    import os
    import time

    import torch.distributed as dist

    from paddle_tpu_torch.incubate.nn.attention import flash_attention
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_hybrid_train_step,
                                         build_train_step, hybrid_mesh,
                                         init_hybrid_state)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (compat, init_mesh,
                                           ring_flash_attention,
                                           ulysses_attention)

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), world)
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    out = {"rank": rank}
    try:
        mesh = init_mesh(device, (world,), ("sep",), store=store, rank=rank,
                         world_size=world)
        b, s, h, kvh, d = sizes["seq_shape"]
        g = torch.Generator().manual_seed(0)
        full = [torch.randn(b, s, n, d, generator=g).to(device, dtype)
                for n in (h, kvh, kvh, h)]
        sl = s // world
        for name, fn in (("ring", ring_flash_attention),
                         ("ulysses", ulysses_attention)):
            ins = [t[:, rank * sl:(rank + 1) * sl].clone().requires_grad_()
                   for t in full[:3]]
            fa.reset_launches()
            with chip_smoke.plain_call_counter() as plain:
                o = fn(*ins, mesh=mesh)
                grads = torch.autograd.grad(
                    o, ins, full[3][:, rank * sl:(rank + 1) * sl])
            out[f"{name}.launches"] = dict(fa.LAUNCHES)
            out[f"{name}.plain"] = dict(plain)
            got = [compat.all_gather_raw(t.detach().contiguous(), "sep", 1,
                                         mesh).cpu()
                   for t in [o] + list(grads)]
            if rank == 0:
                out[f"{name}.got"] = got
        if rank == 0:
            ins = [t.clone().requires_grad_() for t in full[:3]]
            o = flash_attention(*ins, causal=True)
            out["flash.want"] = [t.cpu() for t in [o.detach()] + list(
                torch.autograd.grad(o, ins, full[3]))]
        del full, ins, o, grads

        rng = np.random.default_rng(0)
        cfg_kw = sizes["cfg"]
        ids = torch.from_numpy(rng.integers(
            0, cfg_kw["vocab_size"], (sizes["batch"], sizes["seq"]))).to(
                device)
        labels = torch.from_numpy(rng.integers(
            0, cfg_kw["vocab_size"], (sizes["batch"], sizes["seq"]))).to(
                device)
        runs = [(n, deg, kw, dtype, cfg_kw) for n, deg, kw in
                HYBRID_FOUR_RUNS]
        runs.append(("fp32",) + HYBRID_FOUR_RUNS[0][1:] + (
            torch.float32, dict(cfg_kw,
                                num_hidden_layers=sizes["fp32_layers"])))
        meshes = {}
        for name, deg, kw, cdt, ckw in runs:
            cfg = LlamaConfig(**ckw)
            model = LlamaForCausalLM(
                cfg, device=device, dtype=torch.float32,
                generator=torch.Generator(device=device).manual_seed(0))
            key = tuple(sorted(deg.items()))
            if key not in meshes:
                meshes[key] = hybrid_mesh(device, **deg, store=store,
                                          rank=rank, world_size=world)
            hs = init_hybrid_state(model, meshes[key])
            opt = AdamW(learning_rate=1e-4)
            step = build_hybrid_train_step(cfg, opt, meshes[key],
                                           num_microbatches=2,
                                           compute_dtype=cdt, **kw)
            fa.reset_launches()
            with chip_smoke.plain_call_counter() as plain:
                t0 = time.perf_counter()
                loss = step(hs, opt.init_state(hs), 0, 1e-4, ids,
                            labels)[0].item()
                if device == "cuda":
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            out[f"step.{name}.loss"], out[f"step.{name}.ms"] = loss, ms
            out[f"step.{name}.launches"] = dict(fa.LAUNCHES)
            out[f"step.{name}.plain"] = dict(plain)
            del hs, step
            if rank == 0 and name in ("ulysses", "fp32"):
                params = model.functional_state()
                one = build_train_step(model, AdamW(1e-4), compute_dtype=cdt)
                out[f"step.{name}.one_card"] = one.accumulate(
                    params, ids, labels)[0].item()
            del model
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"hybrid.{rank}.pt"))


def test_hybrid_on_four_cards(tmp_path):
    """Sequence and pipeline parallelism over NCCL on four cards.  Ring
    attention at sep 4 on the long-context shape (b 1, s 8192, 16 q heads
    over 4 kv heads, d 128, bf16): rank r runs r + 1 live hops, so r + 1
    B5 and r + 1 B6 calls (on 2048-row blocks B6 is the fused kernel);
    Ulysses at sep 4 one flash call; each's gathered output and grads
    within 2e-2 of
    ``flash_attention(causal=True)`` on one card.  The train cell's hybrid
    step (TRAIN_CFG, 6 rows of 1024, 2 micro-batches, bf16) on (pp 2, sep
    2) with Ulysses and with ring and on (pp 2, sharding 2) under 1F1B:
    step-0 losses finite, equal on every rank and, for Ulysses, within
    2e-2 of the one-card meshless step's; the Ulysses run again in fp32 at
    depth 2 within 1e-4 of its one-card step; no plain version anywhere.
    Prints each card's name and power limit.  Needs four GPUs."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    for line in _card_names():
        print(line)
    _build.build()                      # once, before the ranks load it
    torch.multiprocessing.spawn(_hybrid_gang_rank,
                                args=(4, str(tmp_path), "cuda",
                                      HYBRID_FOUR), nprocs=4, join=True)
    _check_hybrid_gang(tmp_path, HYBRID_FOUR, 2e-2, 1e-4)


def _check_hybrid_gang(root, sizes, tol, fp32_tol, kernels=True):
    """The four-card hybrid gang's gates (``kernels=False``: a gloo
    rehearsal's, where the plain versions run and nothing launches)."""
    outs = [torch.load(root / f"hybrid.{r}.pt") for r in range(4)]
    b, s, h, kvh, d = sizes["seq_shape"]
    split = fa.flash_bwd_route(s // 4, s // 4, d) == "split"
    for r, o in enumerate(outs):
        print(json.dumps({k: v for k, v in o.items()
                          if not k.endswith((".got", ".want"))}))
        if not kernels:
            continue
        n = o["ring.launches"]
        assert n["flash_masked_fwd"] == r + 1, (r, n)
        assert (n["flash_masked_bwd_dq"] == n["flash_masked_bwd_dkv"] == r + 1
                if split else n["flash_masked_bwd_fused"] == r + 1), (r, n)
        assert not any(v for k, v in o.items() if k.endswith(".plain")
                       for v in v.values()), r
    want = outs[0]["flash.want"]
    for name in ("ring", "ulysses"):
        errs = {key: ((x.float() - y.float()).abs().max()
                      / y.float().abs().max()).item()
                for key, x, y in zip(("o", "dq", "dk", "dv"),
                                     outs[0][f"{name}.got"], want)}
        print(json.dumps({name: errs}))
        assert all(e <= tol for e in errs.values()), (name, errs)
    for name in [n for n, _, _ in HYBRID_FOUR_RUNS] + ["fp32"]:
        losses = [o[f"step.{name}.loss"] for o in outs]
        assert all(np.isfinite(losses)), (name, losses)
        assert max(losses) - min(losses) <= 1e-6 * abs(losses[0]), \
            (name, losses)
    for name, t in (("ulysses", tol), ("fp32", fp32_tol)):
        ref = outs[0][f"step.{name}.one_card"]
        assert abs(outs[0][f"step.{name}.loss"] - ref) <= t * abs(ref), \
            (name, outs[0][f"step.{name}.loss"], ref)


# ------------------------------------------ the kernels as registered ops

def _op_cases(dev):
    """(operator, args, the module's CUDA implementation) of every kernel
    operator (B1-B8) at a small shape on ``dev``, bf16."""
    from paddle_tpu_torch.ops import grouped_matmul as gm

    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    q, k, v = rnd(2, 2, 128, 64), rnd(2, 128, 64), rnd(2, 128, 64)
    o, lse = fa._hb_fwd_cuda(q, k, v, True, 0.125)
    qm, km, vm = rnd(4, 128, 64), rnd(2, 128, 64), rnd(2, 128, 64)
    seg = i32([[1] * 100 + [0] * 28])
    om, lsem = fa._masked_fwd_cuda(qm, km, vm, True, 0.125, 4, 2, seg, seg,
                                   None, 1)
    qd, kc, vc = rnd(3, 8, 64), rnd(3, 2, 256, 64), rnd(3, 2, 256, 64)
    kp, vp = rnd(17, 2, 16, 64), rnd(17, 2, 16, 64)
    tables = i32([[0, 1, 2, -1], [3, 4, -1, -1], [5, 6, 7, 8]])
    x, w = rnd(256, 64), rnd(2, 64, 64)
    starts, lens, wids = i32([0, 128]), i32([100, 128]), i32([0, 1])
    return [
        ("hb_flash_fwd", (q, k, v, True, 0.125), fa._hb_fwd_cuda),
        ("hb_flash_bwd", (q, k, v, o, lse, rnd(2, 2, 128, 64), True, 0.125),
         fa._hb_bwd_cuda),
        ("masked_flash_fwd", (qm, km, vm, True, 0.125, 4, 2, seg, seg, None,
                              1), fa._masked_fwd_cuda),
        ("masked_flash_bwd", (qm, km, vm, om, lsem, rnd(4, 128, 64), True,
                              0.125, 4, 2, seg, seg, None, 1, None),
         fa._masked_bwd_cuda),
        ("flash_decode", (qd, kc, vc, i32([0, 100, 256]), 0.125, 512),
         da._flash_decode_cuda),
        ("paged_decode", (qd, kp, vp, i32([40, 20, 64]), tables, 0.125, 2),
         da._paged_cuda),
        ("ragged_paged_decode", (rnd(5, 8, 64), kp, vp, i32([3, 40, 7, 64, 0]),
                                 i32([0, 0, 1, 2, -1]), tables, 0.125, 2),
         da._ragged_cuda),
        ("grouped_matmul", (x, w, starts, lens, wids, 128, None, False),
         gm._gmm_cuda),
        ("grouped_outer", (x, x, starts, lens, 128), gm._outer_cuda),
    ]


def _launch_counts():
    from paddle_tpu_torch.ops import grouped_matmul as gm

    return [dict(m.LAUNCHES) for m in (da, fa, gm)]


def test_kernel_ops_on_fake_cuda_give_shapes_and_launch_nothing(dev):
    """Every kernel operator on fake cuda tensors: the real call's output
    shapes and dtypes, no launch and no device byte allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from paddle_tpu_torch.ops import _registry

    cases = _op_cases(dev)
    assert sorted({_registry.KERNELS[n] for n, _, _ in cases}) == [
        "B1", "B2", "B3", "B3'", "B4", "B5", "B6", "B7", "B8"]
    for name, args, _ in cases:
        op = getattr(torch.ops.paddle_tpu_torch, name).default
        real = op(*args)
        torch.cuda.synchronize()
        mode = FakeTensorMode()
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        before, alloc = _launch_counts(), torch.cuda.memory_allocated()
        with mode:
            fake = op(*fake_args)
        assert _launch_counts() == before, name
        assert torch.cuda.memory_allocated() == alloc, name
        reals = real if isinstance(real, tuple) else (real,)
        fakes = fake if isinstance(fake, tuple) else (fake,)
        assert [(tuple(t.shape), t.dtype, t.device.type) for t in fakes] \
            == [(tuple(t.shape), t.dtype, t.device.type) for t in reals], \
            name


def test_kernel_ops_equal_direct_launches_bit_for_bit(dev, monkeypatch):
    """Each operator's output equals its CUDA implementation called
    directly (the launch the wrapper made before the registration), bit
    for bit; B6 on its deterministic split route."""
    monkeypatch.setattr(fa, "_FUSED_BWD_VMEM_BUDGET", 0)
    for name, args, impl in _op_cases(dev):
        op = getattr(torch.ops.paddle_tpu_torch, name).default
        got, want = op(*args), impl(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name


def test_graph_doctor_checks_at_small_width(dev):
    """chip_smoke's graph_doctor checks (``_doctor_target``) at a small
    width: a capture on fake cuda tensors allocates and launches nothing,
    the sweeps are clean, the kernel nodes equal the real call's launches
    and the static peak lies within GD_PEAK_TOL of the measured one, for
    the train step, the health-probed step and both serving paths."""
    from paddle_tpu_torch.distributed.health import (HealthConfig,
                                                     default_gates)
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, llama_decay_mask)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.debug(vocab=512, hidden=256, layers=2, heads=4,
                            kv_heads=2, inter=512, max_pos=256)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             generator=torch.Generator(device=dev)
                             .manual_seed(0))
    p32 = model.functional_state()
    params = {k: v.bfloat16() for k, v in p32.items()}
    opt = AdamW(learning_rate=1e-4, multi_precision=True)
    state = opt.init_flat_state(params, decay_mask=llama_decay_mask(model),
                                master_from=p32)
    ids = torch.randint(0, cfg.vocab_size, (2, 2, 128), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    want = {"hb_flash_fwd": 4, "hb_flash_bwd": 4}
    args = (params, state, 0, 1e-4, ids, ids)
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=2)
    rec, base = chip_smoke._doctor_target(
        "train", step, args, {}, {"donation": {}}, dev, want,
        passes=["dtype_promotion", "donation", "memory_budget"],
        declared=torch.bfloat16)
    assert rec["double_resident_bytes"] > 0
    hstep = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             accum_steps=2, health=HealthConfig())
    chip_smoke._doctor_target(
        "train_health", hstep, args, {"health_gates": default_gates()},
        {"donation": {}, "health_probe": {"probe_overhead_bytes": 1 << 20,
                                          "baseline_collectives": {}}},
        dev, want, passes=["dtype_promotion", "donation", "health_probe"],
        declared=torch.bfloat16, baseline=base["peak_bytes"])
    for kw, want in (({"decode_chunk_steps": 2}, {"paged_decode": 4}),
                     ({"prefill_token_budget": 16},
                      {"ragged_paged_decode": 2})):
        eng = ContinuousBatchingEngine(cfg, params, max_slots=2,
                                       num_pages=33, page_size=16,
                                       max_seq_len=128, device=dev, **kw)
        fn, a, kwargs, options = eng.analysis_entry()
        chip_smoke._doctor_target("serving", fn, a, kwargs, options, dev,
                                  want)


def test_capture_parity_on_four_cards(tmp_path):
    """The Graph Doctor's view of a rank against the rank's real NCCL
    collectives on four cards: each rank's capture on a fake group of 4
    (fake cuda tensors) lists the collectives (op, group, peer, payload
    bytes, in order) that the same step then issues over NCCL, counted
    where ``parallel/compat.py`` hands them to ``torch.distributed``
    (``_issue``'s calls, ``_ppermute_raw``'s ``batch_isend_irecv``), for
    the mesh step on (dp, sharding, mp) = (1, 2, 2) and the dropless EP
    step on (1, 1, 4) (``tests/torch_gang.py``; the gloo rehearsal is
    tests/test_torch_collective_doctor.py's).  The captures run in this
    process before the ranks start.  Prints each card's name and power
    limit and the counts.  Needs four GPUs."""
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_gang import capture_parity_rank, parity_captures

    for line in _card_names():
        print(line)
    _build.build()                      # once, before the ranks load it
    parity_captures(str(tmp_path), 4, "cuda")    # here: no real group
    torch.multiprocessing.spawn(capture_parity_rank,
                                args=(4, str(tmp_path), "cuda"), nprocs=4,
                                join=True)
    summary = {}
    for rank in range(4):
        out = torch.load(tmp_path / f"parity.{rank}.pt")
        for name, rec in out.items():
            assert rec["want"], (rank, name)
            assert rec["got"] == rec["want"], (rank, name, rec)
            kinds = {}
            for op, _, _, nbytes in rec["got"]:
                k = kinds.setdefault(op, [0, 0])
                k[0] += 1
                k[1] += nbytes
            summary[f"{name}.rank{rank}"] = kinds
    print("capture_parity_four_cards: " + json.dumps(summary))


# ------------------------------------------------ the roofline's link rate

#: one rank's shard of the all-gather (bf16); the all-reduce runs over the
#: gathered LINK_SHARD_BYTES x world
LINK_SHARD_BYTES = 256 << 20
LINK_WARMUP, LINK_REPS = 3, 10


def _link_rank(rank, world, root):
    """One rank of ``test_link_rate_on_four_cards``: NCCL over a FileStore,
    an all-gather of a LINK_SHARD_BYTES shard and an all-reduce of the
    gathered buffer, each timed over LINK_REPS calls between CUDA events
    after LINK_WARMUP; rank 0 saves every rank's milliseconds."""
    import os

    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group("nccl", store=store, rank=rank,
                            world_size=world, device_id=dev)
    shard = torch.ones(LINK_SHARD_BYTES // 2, dtype=torch.bfloat16,
                       device=dev)
    full = torch.empty(world * shard.numel(), dtype=torch.bfloat16,
                       device=dev)

    def timed(fn):
        for _ in range(LINK_WARMUP):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(LINK_REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / LINK_REPS

    ms = torch.tensor([timed(lambda: dist.all_gather_into_tensor(full,
                                                                 shard)),
                       timed(lambda: dist.all_reduce(full))], device=dev)
    every = [torch.empty_like(ms) for _ in range(world)]
    dist.all_gather(every, ms)
    if rank == 0:
        torch.save(torch.stack(every).cpu(), os.path.join(root, "link.pt"))
    dist.destroy_process_group()


def test_link_rate_on_four_cards(tmp_path):
    """The ``"h100"`` row's ICI rate (``parallel/roofline.py``
    CHIP_SOURCES): an NCCL all-gather of a LINK_SHARD_BYTES bf16 shard on
    four cards, priced in the ring model's own currency,
    ``ring_wire_cost("allgather", shard, 4)`` over the slowest rank's time
    (NCCL's bus bandwidth), so that ``collective_time`` gives the measured
    time back; the all-reduce of the gathered buffer the same way beside
    it.  Prints each card's name and power limit and the rates.  Needs four
    GPUs."""
    from paddle_tpu_torch.parallel.roofline import (CHIP_SPECS,
                                                    collective_time,
                                                    ring_wire_cost)

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    cards = _card_names()[:4]
    torch.multiprocessing.spawn(_link_rank, args=(4, str(tmp_path)),
                                nprocs=4, join=True)
    ms = torch.load(tmp_path / "link.pt")
    ag_ms, ar_ms = (float(ms[:, i].max()) for i in range(2))
    full = 4 * LINK_SHARD_BYTES
    ici = ring_wire_cost("allgather", LINK_SHARD_BYTES, 4) / (ag_ms * 1e-3)
    ar = ring_wire_cost("allreduce", full, 4) / (ar_ms * 1e-3)
    back = collective_time(full, 4, kind="all_gather",
                           link_bytes_per_s=ici)
    print("link_rate_four_cards: " + json.dumps({
        "cards": cards, "shard_bytes": LINK_SHARD_BYTES, "reps": LINK_REPS,
        "allgather_ms": ag_ms, "allreduce_ms": ar_ms,
        "per_rank_ms": ms.tolist(), "ici_bytes_per_s": ici,
        "allreduce_bus_bytes_per_s": ar,
        "table_ici_bytes_per_s": CHIP_SPECS["h100"].ici_bytes_per_s}))
    assert math.isfinite(ici) and ici > 0 and math.isfinite(ar) and ar > 0
    assert abs(back - ag_ms * 1e-3) <= 1e-9 * ag_ms


# ---------------------------------------------- C.10: NCCL after a check

def _c10_check(dev):
    """The Graph Doctor's two-rank check of the debug mesh step on
    ``dev`` (``check_ranks``: in this process when no group is live here,
    else in a spawned child)."""
    from paddle_tpu_torch.analysis import check_ranks
    from paddle_tpu_torch.analysis.self_check import _llama_build

    rep = check_ranks(_llama_build((1, 2, 1), dev), 2, device=dev,
                      passes=["collective_order"])
    assert rep.ok, rep.summary()


def test_nccl_after_check_ranks(dev, tmp_path):
    """C.10 on one card: the check in this process, then NCCL here and an
    all-reduce that gives its input back; with that group live, the check
    again (now in a spawned child) and a second all-reduce."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    _c10_check(dev)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1, device_id=dev)
    try:
        for again in (False, True):
            if again:
                _c10_check(dev)
            x = torch.arange(8, dtype=torch.float32, device=dev)
            y = x.clone()
            dist.all_reduce(y)
            torch.cuda.synchronize()
            assert torch.equal(x, y)
    finally:
        dist.destroy_process_group()


def _c10_rank(rank, world, root):
    """One rank of ``test_check_ranks_then_nccl_on_four_cards``: the check
    on this rank's card in this process, then NCCL over all ``world``
    ranks (a FileStore under ``root``) and one all-reduce, whose sum is
    checked."""
    import datetime
    import os

    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    _c10_check(dev)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(root, "store"), world),
        rank=rank, world_size=world, device_id=dev,
        timeout=datetime.timedelta(seconds=120))
    x = torch.full((8,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    assert x[0].item() == world * (world + 1) / 2, x


def test_check_ranks_then_nccl_on_four_cards(tmp_path):
    """C.10 on four cards, the setting in which NCCL once crashed after a
    fake group: each rank, a process of its own, checks the debug mesh
    step in its own process and then joins a four-rank NCCL group for one
    all-reduce.  Prints each card's name and power limit.  Needs four
    GPUs."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    _build.build()
    print("c10_four_cards: " + json.dumps({"cards": _card_names()[:4]}))
    torch.multiprocessing.spawn(_c10_rank, args=(4, str(tmp_path)),
                                nprocs=4, join=True)
