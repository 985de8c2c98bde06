"""The port's LM serving path against the reference's, on the CPU, for the
six architectures whose layers form one "attn" stack, at their SMOKE
sizes.

The reference's ``init_lm`` draws the weights (JAX on the CPU, as
``tests/test_archs.py`` runs it, ``ctx=None``) and ``lm_from_reference``
carries them into the port. Both packages then prefill the same prompt
and decode three more positions teacher-forced: logits and caches must
agree, float32 within 1e-4 (logits) and 1e-5 (caches), bfloat16 within
3e-2 of the largest reference logit. ``serve_batch`` must generate the
same greedy tokens in float32 for seeds 0 and 1. The port's own
decode-against-forward check (the reference's test_archs bound) and the
``python -m repro_torch.launch.serve`` CLI run here too.
"""

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
import repro_torch.configs.registry as TR
from repro_torch.launch.serve import decode_forward_error, device_agreement, serve_batch
from repro_torch.models import lm
from repro_torch.models.convert import lm_from_reference
from repro_torch.serving.steps import make_decode_step, make_prefill_step

ARCHS = ("starcoder2-3b", "yi-34b", "chatglm3-6b", "minitron-8b", "musicgen-medium", "paligemma-3b")
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, dtype):
    rcfg, tcfg, params, model = _models(arch, dtype, seed=1)
    rb, tb = _inputs(tcfg, np.random.default_rng(0), S + N_DECODE)
    head = lambda d: {k: v[:, :S] for k, v in d.items()}
    at = lambda d, i: {k: v[:, i : i + 1] for k, v in d.items()}
    kw = dict(s_alloc=S + N_DECODE, q_chunk=4, kv_chunk=8)
    r_prefill = jax.jit(lambda p, b: RLM.prefill(p, b, rcfg, None, **kw))
    r_decode = jax.jit(lambda p, c, b, pos: RLM.decode_step(p, c, b, pos, rcfg, None))
    t_prefill = make_prefill_step(tcfg, device="cpu", **kw)
    t_decode = make_decode_step(tcfg, device="cpu")

    V = tcfg.vocab_size

    def check(n, r_logits, r_cache, t_logits, t_cache):
        """One step's logits and caches (the port's cache is written in place
        by the next step, so each is checked at once)."""
        want, got = _np(r_logits)[..., :V], _np(t_logits)[..., :V]
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        bound = 1e-4 if dtype == "float32" else 3e-2 * np.abs(want).max()
        assert err <= bound, f"{arch} {dtype} step {n}: logits differ by {err} > {bound}"
        assert torch.equal(t_logits[..., V:], torch.full_like(t_logits[..., V:], -1e30))
        assert sorted(t_cache) == sorted(r_cache)
        for name in r_cache:
            assert t_cache[name].dtype == getattr(torch, dtype)
            err = np.abs(_np(t_cache[name]) - _np(r_cache[name])).max()
            bound = 1e-5 if dtype == "float32" else 3e-2 * np.abs(_np(r_cache[name])).max()
            assert err <= bound, f"{arch} {dtype} step {n}: cache {name} differs by {err} > {bound}"

    (r_logits, r_cache), (t_logits, t_cache) = r_prefill(params, head(rb)), t_prefill(model, head(tb))
    check(0, r_logits, r_cache, t_logits, t_cache)
    for i in range(S, S + N_DECODE):
        r_logits, r_cache = r_decode(params, r_cache, at(rb, i), jnp.int32(i))
        t_logits, t_cache = t_decode(model, t_cache, at(tb, i), i)
        check(i - S + 1, r_logits, r_cache, t_logits, t_cache)


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
    assert got["cache_bytes"] == 2 * tcfg.n_layers * 2 * 12 * tcfg.n_kv_heads * tcfg.d_head * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's own check (tests/test_archs.py), on the port alone
    with its own weights: float32, S = 17."""
    cfg = dataclasses.replace(TR.get_smoke(arch), dtype="float32")
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
