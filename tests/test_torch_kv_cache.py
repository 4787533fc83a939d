"""Port parity: PagedKVPool bookkeeping equals the reference's exactly
after the same op sequence; writes + gathers move the same values."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.serve.kv_cache import PagedKVPool as RefPool
from repro.serve.kv_cache import page_bucket as ref_bucket
from repro.serve.kv_cache import pages_needed as ref_needed
from repro_torch.configs import ArchConfig, get_smoke_config
from repro_torch.serve.kv_cache import PagedKVPool, page_bucket, pages_needed


def _pools(n_pages=12, page_size=4, n_slots=4, max_pages=5, int8=False):
    kw = dict(n_pages=n_pages, page_size=page_size, n_slots=n_slots,
              max_pages_per_seq=max_pages)
    ref = RefPool(ref_smoke("qwen3-14b"), dtype=jnp.int8 if int8 else None,
                  **kw)
    port = PagedKVPool(get_smoke_config("qwen3-14b"),
                       dtype=torch.int8 if int8 else None, device="cpu",
                       **kw)
    return ref, port


def _same_state(ref, port, live):
    assert port._free_pages == ref._free_pages
    assert port._free_slots == ref._free_slots
    assert port.pages_in_use == ref.pages_in_use
    assert port.peak_pages_in_use == ref.peak_pages_in_use
    for s in live:
        assert port._slots[s].pages == ref._slots[s].pages
        assert port.length(s) == ref.length(s)
    slots = list(live) + [None]
    np.testing.assert_array_equal(port.block_table(slots),
                                  ref.block_table(slots))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = _pools()
    live = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(1, 22))
            a, b = ref.admit(n), port.admit(n)
            assert a == b
            if a is not None:
                live.append(a)
        elif op == 1 and live:
            s = live[rng.integers(len(live))]
            new_len = ref.length(s) + int(rng.integers(1, 6))
            assert ref.extend(s, new_len) == port.extend(s, new_len)
        elif op == 2 and live:
            s = live.pop(rng.integers(len(live)))
            ref.release(s)
            port.release(s)
        elif op == 3 and live:
            # length accounting through the address paths
            s = live[rng.integers(len(live))]
            cap = len(ref._slots[s].pages) * ref.page_size
            start = ref.length(s)
            n = min(int(rng.integers(1, 4)), cap - start)
            if n > 0:
                slots, starts, ns = [s, None], [start, 0], [n, 0]
                np.testing.assert_array_equal(
                    port.span_addresses(slots, starts, ns, 4),
                    ref.span_addresses(slots, starts, ns, 4))
                ref.note_span_written(slots, starts, ns)
                port.note_span_written(slots, starts, ns)
                pos = [ref.length(s) - 1, 0]
                np.testing.assert_array_equal(
                    port.addresses([s, None], pos),
                    ref.addresses([s, None], pos))
                ref.note_written([s, None], pos)
                port.note_written([s, None], pos)
        _same_state(ref, port, live)


def test_page_helpers_match_reference():
    for n in range(0, 40):
        assert pages_needed(n, 4) == ref_needed(n, 4)
        for cap in (1, 4, 16):
            assert page_bucket(n, cap) == ref_bucket(n, cap)


@pytest.mark.parametrize("int8", [False, True])
def test_write_gather_matches_reference(int8):
    ref, port = _pools(int8=int8)
    cfg = get_smoke_config("qwen3-14b")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(3)
    a = ref.admit(6)
    assert port.admit(6) == a
    k = rng.standard_normal((L, 6, KV, hd)).astype(np.float32)
    v = rng.standard_normal((L, 6, KV, hd)).astype(np.float32)
    ref.write_span(a, 0, 6, jnp.asarray(k), jnp.asarray(v))
    port.write_span(a, 0, 6, torch.from_numpy(k), torch.from_numpy(v))
    tok = rng.standard_normal((L, 1, KV, hd)).astype(np.float32)
    assert ref.extend(a, 7) and port.extend(a, 7)
    ref.write([a], [6], jnp.asarray(tok), jnp.asarray(tok))
    port.write([a], [6], torch.from_numpy(tok), torch.from_numpy(tok))
    assert port.length(a) == ref.length(a) == 7
    for got, want in zip(port.gather([a, None]), ref.gather([a, None])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    if int8:  # same int8 codes and scales, not just the same dequant
        np.testing.assert_array_equal(port.k.numpy(), np.asarray(ref.k))
        np.testing.assert_allclose(port.k_scale.numpy(),
                                   np.asarray(ref.k_scale), rtol=1e-6)


def test_config_from_reference_manifest_dict():
    import dataclasses

    d = dataclasses.asdict(ref_smoke("qwen3-14b"))
    cfg = ArchConfig.from_dict(d)
    assert cfg == get_smoke_config("qwen3-14b")
    assert (cfg.q_dim, cfg.kv_dim) == (64, 32)


@pytest.mark.parametrize("flag,value", [("weight_bits", 2)])
def test_config_from_dict_refuses_fields_it_does_not_model(flag, value):
    """A reference config field that changes what the dense path computes
    raises, naming the field, instead of being dropped."""
    import dataclasses

    d = dataclasses.asdict(ref_smoke("qwen3-14b"))
    d[flag] = value
    with pytest.raises(ValueError, match=f"^{flag}="):
        ArchConfig.from_dict(d)


@pytest.mark.parametrize("flag", ["qkv_bias", "mlp_bias"])
def test_config_from_dict_accepts_the_biases(flag):
    """qwen2-72b's and starcoder2-15b's bias flags are modelled: kept, not
    refused and not dropped."""
    import dataclasses

    d = dataclasses.asdict(ref_smoke("qwen3-14b"))
    d[flag] = True
    cfg = ArchConfig.from_dict(d)
    assert getattr(cfg, flag) is True
    assert cfg == dataclasses.replace(get_smoke_config("qwen3-14b"),
                                      **{flag: True})
