"""Port parity: the prefix cache and int8 KV in the pool and the engine.

The pool's trie, refcounts, free list, block tables and LRU order equal
the reference's after every op of seeded op sequences; writes through
shared pages copy them first and gather the same values; engine streams
with ``prefix_cache`` and ``kv_int8`` are the reference engine's, with the
same prefix-cache counters and logits within ``RTOL``/``ATOL``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import drive_ticks, fp_decoders

from repro.configs import get_smoke_config as ref_smoke
from repro.data import make_calibration as ref_calibration
from repro.serve import Engine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve.kv_cache import PagedKVPool as RefPool
from repro_torch.configs import get_smoke_config
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.kv_cache import PagedKVPool

RTOL = ATOL = 2e-3


def _pools(n_pages=14, page_size=4, n_slots=4, max_pages=6, dtype=None):
    kw = dict(n_pages=n_pages, page_size=page_size, n_slots=n_slots,
              max_pages_per_seq=max_pages, prefix_cache=True)
    ref_dt = {None: None, "int8": jnp.int8, "bfloat16": jnp.bfloat16}[dtype]
    port_dt = {None: None, "int8": torch.int8,
               "bfloat16": torch.bfloat16}[dtype]
    return (RefPool(ref_smoke("qwen3-14b"), dtype=ref_dt, **kw),
            PagedKVPool(get_smoke_config("qwen3-14b"), dtype=port_dt,
                        device="cpu", **kw))


def _same_state(ref, port):
    assert port._free_pages == ref._free_pages
    assert port._free_slots == ref._free_slots
    np.testing.assert_array_equal(port._page_ref, ref._page_ref)
    assert list(port._trie.items()) == list(ref._trie.items())  # LRU order
    assert {n: (v.key, v.page, v.parent, v.children)
            for n, v in port._nodes.items()} == {
        n: (v.key, v.page, v.parent, v.children)
        for n, v in ref._nodes.items()}
    for name in ("pages_in_use", "peak_pages_in_use", "cached_pages",
                 "shared_pages", "max_page_ref", "cow_copies",
                 "prefix_hit_pages"):
        assert getattr(port, name) == getattr(ref, name), name
    live = sorted(ref._slots)
    assert sorted(port._slots) == live
    for s in live:
        assert port.length(s) == ref.length(s)
    np.testing.assert_array_equal(port.block_table(live + [None]),
                                  ref.block_table(live + [None]))


def _both(ref, port, fn):
    """Run ``fn`` on both pools: equal results, or the same exception."""
    out = []
    for pool in (ref, port):
        try:
            out.append(("ok", fn(pool)))
        except (RuntimeError, ValueError) as e:
            out.append(("raised", type(e).__name__))
    assert out[0][0] == out[1][0], out
    if out[0][0] == "ok":
        a, b = out
        if isinstance(a[1], tuple):  # address arrays
            for x, y in zip(a[1], b[1]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            assert a[1] == b[1]
    return out[0]


@pytest.mark.parametrize("seed", range(6))
def test_random_prefix_op_sequence_matches_reference(seed):
    """admit with tokens, write + register, extend, decode writes,
    truncate, release, token-less admits — under pressure, so reclaim and
    copy-on-write run — leave both pools in the same state after every
    op."""
    rng = np.random.default_rng(seed)
    ref, port = _pools()
    bases = rng.integers(0, 3, size=(3, 24)).astype(np.int32)
    toks: dict[int, np.ndarray] = {}  # live slot -> its token sequence
    for _ in range(250):
        op = int(rng.integers(0, 7))
        live = sorted(toks)
        if op in (0, 6):
            seq = bases[rng.integers(3)][: int(rng.integers(1, 25))].copy()
            if seq.size > 4 and rng.random() < 0.3:
                seq[rng.integers(seq.size)] ^= 1  # diverge mid-prefix
            tokens = seq if op == 0 else None
            kind, slot = _both(ref, port,
                               lambda p: p.admit(seq.size, tokens=tokens))
            if slot is not None:
                toks[slot] = seq
        elif op == 1 and live:
            # prefill the rest of the slot's tokens, then register them
            s = live[rng.integers(len(live))]
            seq, start = toks[s], ref.length(s)
            cap = len(ref._slots[s].pages) * ref.page_size
            n = min(seq.size, cap) - start
            if n > 0:
                args = ([s, None], [start, 0], [n, 0], 24)
                kind, _ = _both(ref, port,
                                lambda p: p.span_addresses(*args))
                if kind == "ok":
                    for p in (ref, port):
                        p.note_span_written(*args[:3])
                        p.register_prefix(s, seq[: p.length(s)])
        elif op == 2 and live:
            s = live[rng.integers(len(live))]
            new_len = ref.length(s) + int(rng.integers(1, 6))
            _both(ref, port, lambda p: p.extend(s, new_len))
        elif op == 3 and live:
            # one decode token at the slot's length (copy-on-write)
            s = live[rng.integers(len(live))]
            pos = ref.length(s)
            if pos < len(ref._slots[s].pages) * ref.page_size:
                kind, _ = _both(ref, port,
                                lambda p: p.addresses([None, s], [0, pos]))
                if kind == "ok":
                    for p in (ref, port):
                        p.note_written([s], [pos])
        elif op == 4 and live:
            s = live[rng.integers(len(live))]
            new_len = int(rng.integers(0, ref.length(s) + 1))
            _both(ref, port, lambda p: p.truncate(s, new_len))
        elif op == 5 and live:
            s = live[rng.integers(len(live))]
            _both(ref, port, lambda p: p.release(s))
            del toks[s]
        if op == 0 and rng.random() < 0.2:
            probe = bases[rng.integers(3)]
            _both(ref, port, lambda p: p.cached_prefix_pages(probe))
        _same_state(ref, port)
    for s in sorted(toks):
        ref.release(s)
        port.release(s)
    _same_state(ref, port)
    assert port.pages_in_use == port.cached_pages


def test_truncate_rollback_matches_reference():
    ref, port = _pools(n_pages=9, max_pages=4)
    for p in (ref, port):
        p.prefix_cache = False
    s = _both(ref, port, lambda p: p.admit(10))[1]
    for p in (ref, port):
        p.note_span_written([s], [0], [10])
    assert _both(ref, port, lambda p: p.truncate(s, 6))[1] == 1
    assert _both(ref, port, lambda p: p.truncate(s, 5))[1] == 0
    assert _both(ref, port, lambda p: p.truncate(s, 7))[0] == "raised"
    assert _both(ref, port, lambda p: p.truncate(s, 0))[1] == 1
    for n in (16, 17, 32, 33):  # per-sequence and total capacity
        assert _both(ref, port, lambda p: p.fits(n))[0] == "ok"
    _same_state(ref, port)


def _kv(rng, n, cfg):
    return rng.standard_normal(
        (cfg.n_layers, n, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
def test_copy_on_write_and_gather_match_reference(dtype):
    """A forked request writes into a shared page: the page is copied
    first, the cached content stays, and every view gathers the same
    values (and int8 codes and scales) as the reference's."""
    cfg = get_smoke_config("qwen3-14b")
    ref, port = _pools(n_pages=13, max_pages=4, dtype=dtype)
    rng = np.random.default_rng(5)
    toks = np.arange(8, dtype=np.int32)
    k, v = _kv(rng, 8, cfg), _kv(rng, 8, cfg)
    a = _both(ref, port, lambda p: p.admit(10, tokens=toks))[1]
    ref.write_span(a, 0, 8, jnp.asarray(k), jnp.asarray(v))
    port.write_span(a, 0, 8, torch.from_numpy(k), torch.from_numpy(v))
    for p in (ref, port):
        p.register_prefix(a, toks)
    b = _both(ref, port, lambda p: p.admit(10, tokens=toks))[1]
    assert port.length(b) == 8 and port.shared_pages == 2
    patch = _kv(rng, 1, cfg)
    ref.write_span(b, 5, 1, jnp.asarray(patch), jnp.asarray(-patch))
    port.write_span(b, 5, 1, torch.from_numpy(patch),
                    torch.from_numpy(-patch))
    assert port.cow_copies == ref.cow_copies == 1
    tok = _kv(rng, 1, cfg)
    assert ref.extend(b, 9) and port.extend(b, 9)
    ref.write([b], [8], jnp.asarray(tok), jnp.asarray(tok))
    port.write([b], [8], torch.from_numpy(tok), torch.from_numpy(tok))
    # a page-aligned full hit: copy-on-admit of the last page
    c = _both(ref, port, lambda p: p.admit(8, tokens=toks))[1]
    assert port.length(c) == 7 and port.cow_copies == 2
    _same_state(ref, port)
    # int8: the same codes; scales and dequantized values within the
    # fp32 rounding of max|x|/127 (tests/test_torch_kv_cache.py's bounds)
    tol = 1e-6 if dtype == "int8" else 0.0
    for got, want in zip(port.gather([a, b, c, None]),
                         ref.gather([a, b, c, None])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=tol)
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(ref, name) is not None:
            np.testing.assert_allclose(
                getattr(port, name).float().numpy(),
                np.asarray(getattr(ref, name).astype(jnp.float32)),
                rtol=tol, atol=0)


# ---- engine streams -------------------------------------------------------

PS = 4  # page size of every engine case


def _prompts(kind):
    """Prompt sets that exercise the cache (arrival ticks staggered so a
    prompt's pages are registered before the next one is admitted)."""
    base = np.asarray(ref_calibration(256, n_segments=4, seg_len=16,
                                      seed=3).tokens, np.int32)
    if kind == "identical":  # 12 tokens: 2 full pages + 4 shared
        return [base[0, :12]] * 3, (0, 3, 6), 5, {}
    if kind == "shared_prefix":  # 8 shared tokens, 4 distinct each
        return ([np.concatenate([base[0, :8], base[i, 8:12]])
                 for i in range(4)], (0, 3, 3, 5), 5, {})
    if kind == "full_hit":  # page aligned: copy-on-admit
        return [base[1, :8]] * 2 + [base[1, :12]], (0, 3, 4), 4, {}
    # eviction pressure with repeats: reclaim and replay
    return ([base[0, :8], base[1, :8], base[0, :8], base[2, :8]],
            (0, 0, 2, 2), 8, dict(n_slots=3, n_pages=10))


def _serve(engine_cls, cfg_cls, adapter, prompts, arrive, gen, **kw):
    knobs = dict(max_seq_len=16 + gen, n_slots=4, page_size=PS,
                 token_budget=32, prefill_chunk=8, record_logits=True)
    knobs.update(kw)
    eng = engine_cls(adapter, cfg_cls(**knobs))
    run = drive_ticks(eng, [(t, dict(prompt=p, max_new=gen))
                            for p, t in zip(prompts, arrive)])
    return eng, run


COUNTERS = ("prefix_hit_tokens", "cow_copies", "cached_pages",
            "shared_pages", "evictions", "prefill_tokens", "steps")


@pytest.fixture(scope="module")
def decoders():
    return fp_decoders(seed=1)


def _hold(eng, run, ref_eng, ref_run):
    s, rs = eng.summary(), ref_eng.summary()
    assert {k: s[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert run.admitted == ref_run.admitted
    assert run.ticks == ref_run.ticks
    for i in ref_run.reqs:
        assert run.outcome(i) == ref_run.outcome(i)
        np.testing.assert_allclose(np.stack(run.reqs[i].step_logits),
                                   np.stack(ref_run.reqs[i].step_logits),
                                   rtol=RTOL, atol=ATOL)
    pool = eng.pool
    assert pool.pages_in_use == pool.cached_pages and not pool._slots


@pytest.mark.parametrize("path", ["paged", "dense"])
@pytest.mark.parametrize("kind", ["identical", "shared_prefix", "full_hit",
                                  "evict"])
def test_engine_prefix_cache_matches_reference_engine(decoders, kind, path):
    ref_adapter, port_adapter = decoders
    prompts, arrive, gen, kw = _prompts(kind)
    kw.update(prefix_cache=True, paged_decode=path == "paged",
              paged_prefill=path == "paged")
    ref = _serve(RefEngine, RefEngineConfig, ref_adapter, prompts, arrive,
                 gen, **kw)
    got = _serve(Engine, EngineConfig, port_adapter, prompts, arrive, gen,
                 **kw)
    _hold(*got, *ref)
    s = got[0].summary()
    assert s["prefix_hit_tokens"] > 0
    if kind == "full_hit":
        assert s["cow_copies"] >= 1
    if kind == "evict":
        assert s["evictions"] > 0


@pytest.mark.parametrize("kind", ["shared_prefix", "evict"])
def test_engine_kv_int8_matches_reference_and_gather_dense(decoders, kind):
    """int8 pages: the paged kernels' path, the gather-dense path and the
    reference engine emit the same streams (the paged path held to the
    gather-dense one is the CLI's ``--kv-int8 --check`` oracle)."""
    ref_adapter, port_adapter = decoders
    prompts, arrive, gen, kw = _prompts(kind)
    streams = {}
    for path in ("paged", "dense"):
        knobs = dict(kw, kv_int8=True, paged_decode=path == "paged",
                     paged_prefill=path == "paged")
        ref = _serve(RefEngine, RefEngineConfig, ref_adapter, prompts,
                     arrive, gen, **knobs)
        got = _serve(Engine, EngineConfig, port_adapter, prompts, arrive,
                     gen, **knobs)
        assert got[0].pool.is_int8
        _hold(*got, *ref)
        streams[path] = [got[1].outcome(i) for i in sorted(got[1].reqs)]
    assert streams["paged"] == streams["dense"]
