"""Shared helpers of the port's parity tests (not a test module).

The ``*_numpy`` helpers extract JAX-package objects as the numpy trees
``repro_torch.convert`` takes; ``reference_transforms`` builds the port's
transform factory that hands the port the JAX package's own factors, so a
port run and a reference run see the same U and V.
"""
from __future__ import annotations

import numpy as np

from repro.core import incoherence as ref_inc
from repro.core.quantizer import QuantizedLinear as RefLinear
from repro_torch import convert


def _arr(x):
    return None if x is None else np.asarray(x)


def transform_numpy(t) -> dict:
    return {"kind": t.kind, "n": t.n, "A": _arr(t.A), "B": _arr(t.B),
            "signs": _arr(t.signs), "perm": _arr(t.perm)}


def linear_numpy(ql) -> dict:
    st = ql.state
    return {"packed": np.asarray(ql.packed), "s": np.asarray(st.s),
            "D": _arr(st.D), "bits": ql.bits, "m": ql.m, "n": ql.n,
            "maxq": st.maxq, "use_kernel": ql.use_kernel,
            "U": transform_numpy(st.U), "V": transform_numpy(st.V)}


def quantized_tree_numpy(qm) -> dict:
    """A reference QuantizedModel as the numpy tree convert takes."""
    blocks = []
    for blk in qm.blocks:
        out = {}
        for name, val in blk.items():
            if isinstance(val, RefLinear):
                out[name] = linear_numpy(val)
            elif isinstance(val, dict):
                out[name] = {k: np.asarray(v) for k, v in val.items()}
            else:
                out[name] = np.asarray(val)
        blocks.append(out)
    return {"embed": {k: np.asarray(v) for k, v in qm.embed.items()},
            "final_norm": {k: np.asarray(v) for k, v in qm.final_norm.items()},
            "blocks": blocks}


def reference_transforms(kind, n, seed, permute):
    """Port transform factory: the JAX package's ``make_transform(kind, n,
    seed)`` factors, converted (pass as ``transforms=``)."""
    t = ref_inc.make_transform(kind, n, seed, permute=permute)
    return convert.transform_from_numpy(transform_numpy(t), device="cpu")


def fp_decoders(seed: int = 0):
    """The reference smoke ``qwen3-14b`` at fp params from ``seed``, as
    (reference CachedDecoder, port CachedDecoder on the CPU)."""
    import dataclasses

    import jax

    from repro.configs import get_smoke_config
    from repro.models import build_model
    from repro.serve import CachedDecoder as RefDecoder
    from repro_torch.configs import ArchConfig
    from repro_torch.serve.adapter import CachedDecoder

    cfg = get_smoke_config("qwen3-14b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    port = CachedDecoder.from_model(
        ArchConfig.from_dict(dataclasses.asdict(cfg)),
        convert.fp_params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu"))
    return RefDecoder.from_model(model, params), port


class TickRun:
    """What :func:`drive_ticks` saw, indexed by schedule position (rids
    differ between the two packages' engines)."""

    def __init__(self):
        self.reqs = {}  # schedule index -> Request
        self.rejected = {}  # schedule index -> AdmissionRejected.reason
        self.admitted = []  # schedule indices in admission order
        self.ticks = []  # per tick: (emitted [(i, tok)], finished [i])

    def outcome(self, i):
        r = self.reqs[i]
        return r.state.value, r.finish_reason, list(r.out_tokens)


def drive_ticks(engine, schedule, *, events=None, max_ticks=1000):
    """Drive ``engine`` one tick at a time on an injected clock that reads
    the tick number.  ``schedule`` is a list of (tick, submit kwargs): each
    is submitted just before that tick with ``arrival`` = the tick (unless
    the kwargs give one: a later arrival waits).
    ``events`` maps a tick to ``fn(engine, run)``, called after that
    tick's submissions and before the tick (a cancel between ticks).  The
    same schedule takes the same decisions in every run, so both packages'
    engines can be held to each other."""
    clock = [0.0]
    engine.now = lambda: clock[0]
    run = TickRun()
    index = {}
    plan = engine.scheduler.plan

    def plan_and_log(running, pool, now=0.0):
        before = {id(r) for r in running}
        out = plan(running, pool, now=now)
        run.admitted += [index[id(r)] for r in running
                         if id(r) not in before]
        return out

    engine.scheduler.plan = plan_and_log
    order = sorted(range(len(schedule)), key=lambda i: schedule[i][0])
    for tick in range(max_ticks):
        clock[0] = float(tick)
        while order and schedule[order[0]][0] <= tick:
            i = order.pop(0)
            try:
                r = engine.submit(**{"arrival": float(tick),
                                     **schedule[i][1]})
            except ValueError as e:  # AdmissionRejected in both packages
                run.rejected[i] = e.reason
                continue
            run.reqs[i] = r
            index[id(r)] = i
        if events and tick in events:
            events[tick](engine, run)
        res = engine.tick()
        run.ticks.append(([(index[id(r)], int(t)) for r, t in res.emitted],
                          [index[id(r)] for r in res.finished]))
        if not order and engine.idle:
            return run
    raise RuntimeError(f"engine did not drain in {max_ticks} ticks")


def draw_explained(logits, temp, top_p, u, token, *, delta=0.0, floor=0.0):
    """Whether ``token`` can be the inverse-CDF draw of uniform ``u`` from
    ``logits`` (V,) at temperature ``temp`` and nucleus ``top_p`` once
    every logit may move by up to ``delta`` and the CDF by up to ``floor``
    of its mass: ``chip_smoke.py``'s rule (``_draw_explained``), so the CPU
    tests and the card's gates admit partings alike."""
    import importlib.util
    import pathlib

    global _chip_smoke
    if _chip_smoke is None:
        path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        _chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_chip_smoke)
    return _chip_smoke._draw_explained(logits, temp, top_p, u, token,
                                       delta=delta, floor=floor)[0]


_chip_smoke = None


def first_partings(streams_a, streams_b):
    """{key: first position where two token streams differ} over the keys
    both dicts share (a missing key: the streams are equal)."""
    out = {}
    for i in streams_a:
        a, b = list(streams_a[i]), list(streams_b[i])
        n = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if n is None and len(a) != len(b):
            n = min(len(a), len(b))
        if n is not None:
            out[i] = n
    return out


def assert_streams_agree(got, want, *, floor, draws_on_device=True,
                         rtol=2e-3, atol=2e-3):
    """Two runs' sampled streams (TickRun, record_logits) are equal up to
    each stream's first parting, which :func:`draw_explained` must admit
    on the ``want`` run's logits with ``delta`` = the max |Δlogit| of the
    positions both runs computed alike (``floor``: the CDF's rounding),
    logits within ``rtol``/``atol`` up to the parting.  Returns the
    partings."""
    import torch

    from repro_torch.serve import adapter

    streams = lambda run: {i: run.reqs[i].out_tokens for i in run.reqs}
    partings = first_partings(streams(got), streams(want))
    for i in want.reqs:
        g, w = got.reqs[i], want.reqs[i]
        n = partings.get(i, len(w.out_tokens))
        upto = min(n + 1, len(g.step_logits), len(w.step_logits))
        lg, lw = (np.stack(r.step_logits[:upto]) for r in (g, w))
        np.testing.assert_allclose(lg, lw, rtol=rtol, atol=atol)
        if i not in partings:
            continue
        sp = w.sampling
        delta = float(np.abs(lg - lw).max())
        # the host draw's uniform is the generator's, not the keyed one:
        # admit any token the perturbed nucleus can reach at some u
        us = ([float(adapter.uniform(torch.tensor(sp.seed), torch.tensor(n)))]
              if draws_on_device else list(np.linspace(0, 1, 4097)))
        assert any(draw_explained(lw[n], sp.temperature, sp.top_p, u,
                                  g.out_tokens[n], delta=delta,
                                  floor=floor) for u in us), (i, n)
    return partings


# ---------------------------------------------------------------------------
# tensor-parallel engines (tests/test_torch_distributed*.py)
# ---------------------------------------------------------------------------

# engine logits, TP against single device: the row-parallel sums add the
# ranks' fp32 partials (read ~1e-6); against the JAX engine as
# tests/test_torch_engine.py
TP_RTOL = TP_ATOL = 2e-3


def tp_knobs(prompts, gen, **kw) -> dict:
    """EngineConfig knobs of the reference TP tests (tests/
    test_distributed.py ``_run_engine``), logits recorded."""
    out = dict(max_seq_len=prompts.shape[1] + gen, n_slots=4, page_size=4,
               token_budget=32, prefill_chunk=8, paged_decode=True,
               record_logits=True)
    out.update(kw)
    return out


def tp_drive(adapter, eng_cls, cfg_cls, prompts, gen, *, arrive=None,
             sampling=None, **kw):
    """One engine of either package over ``prompts`` on the tick clock of
    :func:`drive_ticks` (request i before tick ``arrive[i]``, default 0).
    Returns (engine, run)."""
    eng = eng_cls(adapter, cfg_cls(**tp_knobs(prompts, gen, **kw)))
    arrive = arrive or [0] * len(prompts)
    extra = {} if sampling is None else {"sampling": sampling}
    sched = [(t, dict(prompt=np.asarray(p), max_new=gen, **extra))
             for t, p in zip(arrive, prompts)]
    return eng, drive_ticks(eng, sched)


def run_tokens(run) -> list:
    return [list(map(int, run.reqs[i].out_tokens)) for i in sorted(run.reqs)]


def run_logits(run) -> list:
    return [np.stack(run.reqs[i].step_logits) for i in sorted(run.reqs)]


def three_engines(adapters, prompts, gen, **kw):
    """The JAX engine, the port's engine and the port's TP engine
    (``adapters`` in that order) on one schedule: streams identical,
    logits within ``TP_RTOL``/``TP_ATOL``, no page held after the drain.
    Returns the TP engine and its run."""
    from repro.serve import Engine as RefEngine
    from repro.serve import EngineConfig as RefEngineConfig
    from repro_torch.serve.engine import Engine, EngineConfig

    ref_a, port_a, tp_a = adapters
    _, ref = tp_drive(ref_a, RefEngine, RefEngineConfig, prompts, gen, **kw)
    _, port = tp_drive(port_a, Engine, EngineConfig, prompts, gen, **kw)
    eng, tp = tp_drive(tp_a, Engine, EngineConfig, prompts, gen, **kw)
    assert run_tokens(tp) == run_tokens(port) == run_tokens(ref)
    for a, b, c in zip(run_logits(tp), run_logits(port), run_logits(ref)):
        np.testing.assert_allclose(a, b, rtol=TP_RTOL, atol=TP_ATOL)
        np.testing.assert_allclose(a, c, rtol=TP_RTOL, atol=TP_ATOL)
    assert eng.pool.pages_in_use == eng.pool.cached_pages
    assert not eng.pool._slots
    return eng, tp


def smoke_prompts(n: int, seg_len: int, seed: int) -> np.ndarray:
    from repro.data import make_calibration

    return np.asarray(make_calibration(256, n_segments=n, seg_len=seg_len,
                                       seed=seed).tokens)


def family_models(arch: str, seed: int = 0, **overrides):
    """The JAX package's smoke ``arch`` (fields replaced by ``overrides``,
    e.g. ``weight_bits=2``) and its params from ``PRNGKey(seed)``, beside
    the port's model of the same config and those params converted to the
    CPU: ``(ref_model, ref_params, port_model, port_params)``."""
    import dataclasses

    import jax

    from repro.configs import get_smoke_config
    from repro.models import build_model as ref_build
    from repro_torch.configs import ArchConfig
    from repro_torch.models.lm import build_model

    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = build_model(ArchConfig.from_dict(dataclasses.asdict(cfg)))
    return (ref, params, port, convert.fp_params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))


def stack_port_cache(cache):
    """A port cache (per-layer lists) as the JAX package's stacked numpy
    tree: lists of dicts become dicts of arrays stacked on axis 0."""
    if isinstance(cache, list):
        return {k: np.stack([c[k].numpy() for c in cache])
                for k in cache[0]}
    return {k: stack_port_cache(v) for k, v in cache.items()}
