"""The port's LM serving path against the reference's, on the CPU, for all
ten architectures (the "attn" stacks, MoE, MLA with DeepSeek-V3's dense
prefix, SSD and the hybrid block), at their SMOKE sizes.

The reference's ``init_lm`` draws the weights (JAX on the CPU, as
``tests/test_archs.py`` runs it, ``ctx=None``) and ``lm_from_reference``
carries them into the port. Both packages then prefill the same prompt
and decode three more positions teacher-forced: logits and caches must
agree, float32 within 1e-4 (logits) and 1e-5 (caches), bfloat16 within
3e-2 of the largest reference logit. ``serve_batch`` must generate the
same greedy tokens in float32 for seeds 0 and 1. The port's own
decode-against-forward check (the reference's test_archs bound, MoE
configs at capacity factor 64 as there) and the ``python -m
repro_torch.launch.serve`` CLI run here too.
"""

import contextlib
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as RR
import repro.launch.serve as RS
import repro.models.lm as RLM
import repro.models.moe as RM
import repro_torch.configs.registry as TR
import repro_torch.models.moe as TM
from repro_torch.launch.serve import decode_forward_error, device_agreement, serve_batch
from repro_torch.models import lm
from repro_torch.models.convert import lm_from_reference
from repro_torch.serving.steps import make_decode_step, make_prefill_step

ARCHS = RR.ARCHS
B, S, N_DECODE = 2, 13, 3
ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's init_lm compiled once per config: eager it takes seconds,
# and the same key gives the same weights either way
_ref_init_lm = jax.jit(RLM.init_lm, static_argnames=("cfg", "tp"))
# its serving steps made once per config and shape, for both seeds
_ref_prefill_step = functools.cache(RS.make_prefill_step)
_ref_decode_step = functools.cache(RS.make_decode_step)


def _configs(arch, dtype):
    return dataclasses.replace(RR.get_smoke(arch), dtype=dtype), dataclasses.replace(TR.get_smoke(arch), dtype=dtype)


def _models(arch, dtype, seed):
    rcfg, tcfg = _configs(arch, dtype)
    params = _ref_init_lm(jax.random.PRNGKey(seed), rcfg, 1)  # tp as the reference's serve_batch passes it
    return rcfg, tcfg, params, lm_from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _inputs(cfg, rng, n):
    """(reference batch, port batch) of ``n`` positions."""
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
        return {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x).long()}
    x = rng.normal(0, 1, (B, n, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _reference_run(rcfg, params, rb, kw, *, eager: bool = False) -> list:
    """The reference's prefill and teacher-forced decode steps: (logits,
    cache) as numpy after each; jitted, or op by op under
    ``jax.disable_jit``."""
    at = lambda d, i: {k: v[:, i : i + 1] for k, v in d.items()}
    prefill = lambda p, b: RLM.prefill(p, b, rcfg, None, **kw)
    decode = lambda p, c, b, pos: RLM.decode_step(p, c, b, pos, rcfg, None)
    with jax.disable_jit() if eager else contextlib.nullcontext():
        if not eager:
            prefill, decode = jax.jit(prefill), jax.jit(decode)
        logits, cache = prefill(params, {k: v[:, :S] for k, v in rb.items()})
        steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
        for i in range(S, S + N_DECODE):
            logits, cache = decode(params, cache, at(rb, i), jnp.int32(i))
            steps.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return steps


@contextlib.contextmanager
def _routes():
    """Record every call of the port's router and of the reference's, in
    order, jitted or op by op: (expert indices, float32 router logits)
    for each. Yields (the port's, the reference's)."""
    port, ref = [], []
    t_route, r_route = TM.route, RM._route

    def t_recording(cfg, logits, e_valid):
        out = t_route(cfg, logits, e_valid)
        port.append((out[0].numpy(), logits.numpy()))
        return out

    def r_recording(cfg, logits, e_valid):
        out = r_route(cfg, logits, e_valid)
        jax.debug.callback(lambda i, l: ref.append((np.asarray(i), np.asarray(l))), out[0], logits, ordered=True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "route", t_recording)
        mp.setattr(RM, "_route", r_recording)
        yield port, ref


def _route_mismatches(arch, dtype, want, got, *, near_ties: bool) -> list[str]:
    """Every router call whose expert choices differ from the reference's.
    With ``near_ties``, a choice may differ where the router's logits
    agree within the bfloat16 bound (3e-2 of the largest) and every
    expert either side chose is within twice that bound of the
    reference's k-th logit: a tie that rounding decides."""
    bad = []
    assert len(got) == len(want), (len(got), len(want))
    for n, ((r_idx, r_logits), (t_idx, t_logits)) in enumerate(zip(want, got)):
        rows = np.nonzero((r_idx != t_idx).any(-1))[0]
        if not len(rows):
            continue
        bound = 3e-2 * np.abs(r_logits).max()
        err = np.abs(t_logits - r_logits).max()
        for t in rows:
            cut = np.take(r_logits[t], r_idx[t]).min()
            spread = cut - np.take(r_logits[t], np.concatenate([r_idx[t], t_idx[t]])).min()
            if not (near_ties and err <= bound and spread <= 2 * bound):
                bad.append(f"{arch} {dtype} routing call {n} token {t}: experts {t_idx[t]} against "
                           f"{r_idx[t]}, logits differ by {err} (bound {bound}), spread {spread}")
    return bad


def _mismatches(arch, dtype, want_steps, got_steps, V) -> list[str]:
    """Every logit or cache entry of ``got_steps`` (the port's) outside the
    bound of ``want_steps`` (the reference's)."""
    bad = []
    for n, ((r_logits, r_cache), (t_logits, t_cache)) in enumerate(zip(want_steps, got_steps)):
        want, got = _np(r_logits)[..., :V], _np(t_logits)[..., :V]
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        bound = 1e-4 if dtype == "float32" else 3e-2 * np.abs(want).max()
        if not err <= bound:
            bad.append(f"{arch} {dtype} step {n}: logits differ by {err} > {bound}")
        for name in r_cache:
            err = np.abs(_np(t_cache[name]) - _np(r_cache[name])).max()
            bound = 1e-5 if dtype == "float32" else 3e-2 * np.abs(_np(r_cache[name])).max()
            if not err <= bound:
                bad.append(f"{arch} {dtype} step {n}: cache {name} differs by {err} > {bound}")
    return bad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    """For MoE configs the port's expert choices, call by call, must equal
    those of the reference run it is held against. In bfloat16 a router's
    top-k can flip on a one-ulp difference of its input: deepseek-v3's
    SMOKE config does, at one token of its prefill (reference logits 0.526
    against 0.490, the port's 0.5047 against 0.5039) and at the third
    decode step, where the reference's own jitted and op-by-op runs differ
    by ten times the bound. For that config in bfloat16 only, the port
    must stay within the bound of one of those two runs of the reference,
    over every step, and may differ from its routing only on near ties
    (``_route_mismatches``); everywhere else it is held to the jitted run
    and its routing exactly."""
    rcfg, tcfg, params, model = _models(arch, dtype, seed=1)
    rb, tb = _inputs(tcfg, np.random.default_rng(0), S + N_DECODE)
    kw = dict(s_alloc=S + N_DECODE, q_chunk=4, kv_chunk=8)
    t_prefill = make_prefill_step(tcfg, device="cpu", **kw)
    t_decode = make_decode_step(tcfg, device="cpu")
    V = tcfg.vocab_size

    # the port's cache is written in place by the next step: copy each
    with _routes() as (got_routes, want_routes):
        logits, cache = t_prefill(model, {k: v[:, :S] for k, v in tb.items()})
        got = [(logits.clone(), {k: c.clone() for k, c in cache.items()})]
        for i in range(S, S + N_DECODE):
            logits, cache = t_decode(model, cache, {k: v[:, i : i + 1] for k, v in tb.items()}, i)
            got.append((logits.clone(), {k: c.clone() for k, c in cache.items()}))
        want = _reference_run(rcfg, params, rb, kw)
    for (r_logits, r_cache), (t_logits, t_cache) in zip(want, got):
        assert torch.equal(t_logits[..., V:], torch.full_like(t_logits[..., V:], -1e30))
        assert sorted(t_cache) == sorted(r_cache)
        for name in r_cache:  # every entry in the model's type but the SSD state, float32 in both
            assert t_cache[name].dtype == getattr(torch, r_cache[name].dtype.name)
    flaky = dtype == "bfloat16" and arch == "deepseek-v3-671b"
    bad = _mismatches(arch, dtype, want, got, V)
    if bad and flaky:
        with _routes() as (_, eager_routes):
            eager = _reference_run(rcfg, params, rb, kw, eager=True)
        if not _mismatches(arch, dtype, eager, got, V):
            bad, want_routes = [], eager_routes
    assert not bad, "\n".join(bad)
    assert len(got_routes) == (N_DECODE + 1) * sum(st.n_layers for st in lm.stacks_for(tcfg) if st.kind == "moe")
    bad = _route_mismatches(arch, dtype, want_routes, got_routes, near_ties=flaky)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_tokens_match_the_reference(arch, seed, monkeypatch):
    rcfg, tcfg, _, model = _models(arch, "float32", seed)
    kw = dict(batch_size=2, prompt_len=8, gen_tokens=4, seed=seed)
    monkeypatch.setattr(RS.lm, "init_lm", _ref_init_lm)
    monkeypatch.setattr(RS, "make_prefill_step", _ref_prefill_step)
    monkeypatch.setattr(RS, "make_decode_step", _ref_decode_step)
    want = RS.serve_batch(rcfg, **kw)
    got = serve_batch(tcfg, device="cpu", model=model, **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (2, 4)
    assert got["cache_bytes"] == sum(a.size * a.dtype.itemsize for a in jax.eval_shape(
        lambda: RLM.init_cache(rcfg, 2, 12)).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's own check (tests/test_archs.py), on the port alone
    with its own weights: float32, S = 17, and, as there, MoE configs at
    capacity factor 64 (a decode step of B tokens has a far smaller
    capacity than a prefill of B·S)."""
    cfg = dataclasses.replace(TR.get_smoke(arch), dtype="float32")
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    _, batch = _inputs(cfg, np.random.default_rng(0), 17)
    assert decode_forward_error(model, batch, device="cpu", q_chunk=4, kv_chunk=4) < 5e-3


def test_serve_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "musicgen-medium", "--smoke",
         "--batch", "2", "--prompt-len", "8", "--gen", "3", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "decode" in out.stdout and "sample tokens" in out.stdout


def test_device_agreement_sees_a_changed_copy():
    """The check phase lm_serve and the card tests run: a copy agrees to
    the bit, a copy with one projection scaled by 1 + 1e-4 does not, in
    logits and in every step's cache."""
    import copy

    cfg = dataclasses.replace(TR.get_smoke("yi-34b"), dtype="float32")
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    _, batch = _inputs(cfg, np.random.default_rng(0), 17)
    same = device_agreement(model, copy.deepcopy(model), batch, q_chunk=4, kv_chunk=8)
    assert same == {"prefill_logits": 0.0, "decode_logits": 0.0, "cache": 0.0}
    other = copy.deepcopy(model)
    with torch.no_grad():
        other.stacks["main"][1].attn.wk.mul_(1 + 1e-4)
    diff = device_agreement(model, other, batch, q_chunk=4, kv_chunk=8)
    assert min(diff.values()) > 1e-6, diff


def test_device_agreement_counts_expert_choices_and_the_state():
    """For an MoE model the check counts the expert choices that differ
    between the two runs; for an SSD model it holds the float32 state
    apart, relative to its own largest magnitude."""
    import copy

    cfg = dataclasses.replace(TR.get_smoke("qwen2-moe-a2.7b"), dtype="float32")
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    _, batch = _inputs(cfg, np.random.default_rng(0), 17)
    same = device_agreement(model, copy.deepcopy(model), batch, q_chunk=4, kv_chunk=8)
    assert same == {"prefill_logits": 0.0, "decode_logits": 0.0, "cache": 0.0, "expert_choices_differ": 0}
    other = copy.deepcopy(model)
    with torch.no_grad():
        other.stacks["moe"][0].moe.router.copy_(torch.flip(other.stacks["moe"][0].moe.router, dims=[1]))
    assert device_agreement(model, other, batch, q_chunk=4, kv_chunk=8)["expert_choices_differ"] > 0

    cfg = dataclasses.replace(TR.get_smoke("mamba2-780m"), dtype="float32")
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    _, batch = _inputs(cfg, np.random.default_rng(0), 17)
    assert device_agreement(model, copy.deepcopy(model), batch)["state"] == 0.0
    other = copy.deepcopy(model)
    with torch.no_grad():
        other.stacks["main"][1].ssm.A_log.add_(1e-3)
    assert device_agreement(model, other, batch)["state"] > 1e-6
