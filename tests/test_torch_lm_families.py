"""The port's MoE, SSD, MLA and hybrid modules against the reference's, on
the CPU, one module at a time.

Both packages take the same numpy inputs and the reference's weights
(``repro.models``, JAX on the CPU, ``ctx=None``, each call compiled with
``jax.jit``: eager it takes seconds; the port's modules built from the
same arrays). Routing must be equal: expert indices exactly, ties
to the lower expert as ``jax.lax.top_k`` breaks them, gates within 1e-6;
capacity drops must hit the same (token, choice) assignments. Outputs and
cache entries agree in float32 within 1e-5 (of the largest magnitude for
the SSD's float32 state), bfloat16 within 3e-2 of the largest magnitude,
the serving tests' bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as RR
import repro.models.attention as RA
import repro.models.blocks as RB
import repro.models.moe as RM
import repro.models.ssm as RS
import repro.parallel.padding as RP
import repro_torch.configs.registry as TR
import repro_torch.models.attention as TA
import repro_torch.models.moe as TM
import repro_torch.models.ssm as TS
import repro_torch.parallel.padding as TP
from repro_torch.models.blocks import GLOBAL_WINDOW
from repro_torch.models.convert import _tensor, block_from_reference

F32_TOL = 1e-5


def _configs(arch: str, dtype: str = "float32", **over):
    return (dataclasses.replace(RR.get_smoke(arch), dtype=dtype, **over),
            dataclasses.replace(TR.get_smoke(arch), dtype=dtype, **over))


def _port(tree: dict) -> dict:
    """The reference's leaves as port tensors, each in its own type."""
    return {k: _tensor(np.asarray(v), "cpu") for k, v in tree.items()}


def _np(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(ref, got, dtype: str, tol: float = F32_TOL) -> None:
    r, g = _np(ref), _np(got)
    assert r.shape == g.shape
    scale = max(float(np.abs(r).max()), 1.0)
    atol = tol if dtype == "float32" else 3e-2 * scale
    np.testing.assert_allclose(g, r, rtol=0, atol=atol)


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


# -- routing -------------------------------------------------------------------------------


def _tied_logits(rng, T: int, E: int) -> np.ndarray:
    """Random logits with ties planted: duplicated values inside rows, whole
    rows equal, and a row of one value."""
    x = rng.normal(0, 1, (T, E)).astype(np.float32)
    x[1, E // 2] = x[1, 0]  # the lower index must rank first
    x[2, [1, 3, 5]] = x[2].max() + 0.5  # a three-way tie at the top
    x[3] = 0.25  # every expert tied
    x[4, -1] = x[4, 2] = x[4].max()
    x[5:8] = np.round(x[5:8] * 2) / 2  # many ties, coarse values
    return x


@pytest.mark.parametrize("e_valid_cut", [0, 3])
@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_route_equals_the_reference_ties_and_pad_mask_included(score, e_valid_cut):
    rcfg, tcfg = _configs("deepseek-v3-671b", router_score=score, moe_top_k=3)
    E = 16
    e_valid = E - e_valid_cut  # experts past e_valid are pad experts: they never win
    logits = _tied_logits(np.random.default_rng(11), 24, E)
    if e_valid_cut:
        logits[:, e_valid:] = 50.0  # would win, were they not masked
    r_idx, r_gates, r_probs = RM._route(rcfg, jnp.asarray(logits), e_valid)
    t_idx, t_gates, t_probs = TM.route(tcfg, torch.from_numpy(logits), e_valid)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(r_idx))
    assert t_gates.dtype == torch.float32
    np.testing.assert_allclose(t_gates.numpy(), np.asarray(r_gates), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(r_probs), rtol=0, atol=1e-6)
    assert int(t_idx.max()) < e_valid
    assert t_idx[3].tolist() == [0, 1, 2]  # an all-tied row takes the lowest experts


def _reference_kept(idx: np.ndarray, C: int) -> np.ndarray:
    """The reference's drop rule written out: an assignment is kept when
    fewer than C earlier (token-major) assignments chose its expert."""
    flat = idx.reshape(-1)
    seen: dict[int, int] = {}
    kept = np.zeros(flat.shape, bool)
    for a, e in enumerate(flat):
        kept[a] = seen.get(int(e), 0) < C
        seen[int(e)] = seen.get(int(e), 0) + 1
    return kept.reshape(idx.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_moe_forward_drops_what_the_reference_drops(arch, dtype):
    """Capacity factor 1.0 and tokens skewed toward a few experts (copies
    of three base tokens, a little noise), so that experts overflow."""
    rcfg, tcfg = _configs(arch, dtype, capacity_factor=1.0)
    p = RM.init_moe(jax.random.PRNGKey(4), rcfg, 1, jnp.dtype(dtype))
    tp = TM.MoE(*(_tensor(np.asarray(p[k]), "cpu") for k in ("router", "wi", "wg", "wo")))
    assert tp.router.dtype == torch.float32
    rng = np.random.default_rng(5)
    base = rng.normal(0, 1, (3, rcfg.d_model))
    x = base[rng.integers(0, 3, (2, 16))] + rng.normal(0, 0.05, (2, 16, rcfg.d_model))
    rx, tx = _both(x, dtype)
    r_y, r_aux = jax.jit(lambda p, x: RM.moe_forward(p, x, rcfg, None))(p, rx)
    with TM.route_log(torch.nn.Sequential(tp)) as log:
        t_y, t_aux = TM.moe_forward(tp, tx, tcfg)
    assert t_y.dtype == tx.dtype
    _close(r_y, t_y, dtype)
    np.testing.assert_allclose(float(t_aux.detach()), float(r_aux), rtol=1e-5)

    T, k = 32, rcfg.moe_top_k
    C = max(1, int(np.ceil(T * k * rcfg.capacity_factor / rcfg.n_experts)))
    logits = jnp.asarray(np.asarray(rx, np.float32).reshape(T, -1)) @ p["router"]
    r_idx = np.asarray(RM._route(rcfg, logits, rcfg.n_experts)[0])
    (call,) = log.calls
    np.testing.assert_array_equal(call["choices"].numpy(), r_idx)
    want_kept = _reference_kept(r_idx, C)
    np.testing.assert_array_equal(call["kept"].numpy(), want_kept)
    assert call["capacity"] == C and 0 < int(call["dropped"]) == int((~want_kept).sum())


def test_moe_dropped_assignments_add_nothing():
    """With every expert's capacity at 1 a token whose choices were all
    dropped gets exactly zero, and the kept ones equal a dense evaluation
    of their experts."""
    _, tcfg = _configs("qwen2-moe-a2.7b", capacity_factor=0.01)
    torch.manual_seed(0)
    tp = TM.init_moe(tcfg, generator=torch.Generator().manual_seed(1), device="cpu", dtype=torch.float32)
    x = torch.randn(1, 12, tcfg.d_model)
    with TM.route_log(torch.nn.Sequential(tp)) as log:
        y, _ = TM.moe_forward(tp, x, tcfg)
    (call,) = log.calls
    kept, idx = call["kept"], call["choices"]
    assert call["capacity"] == 1
    logits = x[0] @ tp.router
    _, gates, _ = TM.route(tcfg, logits, tcfg.n_experts)
    for t in range(12):
        want = torch.zeros(tcfg.d_model)
        for j in range(tcfg.moe_top_k):
            if kept[t, j]:
                e = int(idx[t, j])
                h = torch.nn.functional.silu(x[0, t] @ tp.wg[e]) * (x[0, t] @ tp.wi[e])
                want = want + gates[t, j] * (h @ tp.wo[e])
        torch.testing.assert_close(y[0, t], want, rtol=0, atol=1e-5)
    all_dropped = ~kept.any(1)
    assert all_dropped.any() and torch.all(y[0, all_dropped] == 0)


def test_expert_matmul_gives_float32_from_bfloat16_inputs():
    """The expert products' results are float32, not rounded to the
    inputs' bfloat16: equal to the float64 product of the same values
    within float32's accumulation error."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 5, 64), generator=g).bfloat16()
    w = torch.randn((3, 64, 48), generator=g).bfloat16()
    got = TM.expert_matmul(x, w)
    assert got.dtype == torch.float32
    want = torch.bmm(x.double(), w.double())
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-4)
    assert (got.double() - got.bfloat16().double()).abs().max() > 1e-3  # bfloat16 would lose this


# -- SSD -----------------------------------------------------------------------------------------


def _ssm_pair(arch: str, dtype: str, seed: int = 6):
    rcfg, tcfg = _configs(arch, dtype)
    p = RS.init_ssm(jax.random.PRNGKey(seed), rcfg, 1, jnp.dtype(dtype))
    # a spread of decays and a live D, so the scan's carry and skip both matter
    p["dt_bias"] = p["dt_bias"] + 1.0
    tp = TS.SSM(**_port(p))
    for name in TS.SSM.FLOAT32:
        assert getattr(tp, name).dtype == torch.float32
    return rcfg, tcfg, p, tp


def _state_close(ref: dict, got: dict, dtype: str) -> None:
    for name in ("conv_x", "conv_bc"):
        assert got[name].dtype == getattr(torch, dtype)
        _close(ref[name], got[name], dtype)
    assert got["state"].dtype == torch.float32
    scale = float(np.abs(_np(ref["state"])).max())
    tol = F32_TOL * scale if dtype == "float32" else 3e-2 * scale
    np.testing.assert_allclose(_np(got["state"]), _np(ref["state"]), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 16), (48, 16), (24, 12), (23, 1), (21, 7)])
def test_ssm_forward_and_its_state_match_the_reference(S, chunk, dtype):
    """S that ``ssm_chunk`` (16) divides, and S that it does not: the chunk
    is the largest divisor of S not above 16 (23 → 1, 21 → 7, 24 → 12)."""
    rcfg, tcfg, p, tp = _ssm_pair("mamba2-780m", dtype)
    x = np.random.default_rng(S).normal(0, 1, (2, S, rcfg.d_model))
    rx, tx = _both(x, dtype)
    r_out, r_state = jax.jit(lambda p, x: RS.ssm_forward(p, x, rcfg, 1, return_state=True))(p, rx)
    t_out, t_state = TS.ssm_forward(tp, tx, tcfg, return_state=True)
    assert t_out.dtype == tx.dtype
    _close(r_out, t_out, dtype)
    _state_close(r_state, t_state, dtype)
    # the divisor rule: an explicit chunk gives the same function
    _close(t_out, TS.ssm_forward(tp, tx, tcfg, chunk=chunk), dtype, tol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_decode_steps_match_the_reference_and_the_chunked_forward(arch):
    """From the state a forward over 13 positions leaves, 4 recurrent steps:
    each output and state against the reference's step, and the outputs
    against the port's own chunked forward over all 17 positions."""
    rcfg, tcfg, p, tp = _ssm_pair(arch, "float32", seed=7)
    x = np.random.default_rng(8).normal(0, 1, (2, 17, rcfg.d_model)).astype(np.float32)
    rx, tx = jnp.asarray(x), torch.from_numpy(x)
    _, r_state = jax.jit(lambda p, x: RS.ssm_forward(p, x, rcfg, 1, return_state=True))(p, rx[:, :13])
    r_decode = jax.jit(lambda p, x, st: RS.ssm_decode(p, x, st, rcfg, 1))
    _, t_state = TS.ssm_forward(tp, tx[:, :13], tcfg, return_state=True)
    full = TS.ssm_forward(tp, tx, tcfg)
    for i in range(13, 17):
        r_y, r_state = r_decode(p, rx[:, i : i + 1], r_state)
        t_y, t_state = TS.ssm_decode(tp, tx[:, i : i + 1], t_state, tcfg)
        _close(r_y, t_y, "float32")
        _state_close(r_state, t_state, "float32")
        torch.testing.assert_close(t_y, full[:, i : i + 1], rtol=0, atol=1e-4)


def test_init_ssm_state_is_float32_whatever_the_type():
    _, tcfg = _configs("mamba2-780m", "bfloat16")
    st = TS.init_ssm_state(tcfg, 3, device="cpu", dtype=torch.bfloat16)
    dims = TS.ssm_dims(tcfg)
    assert st["conv_x"].shape == (3, 3, dims["di"]) and st["conv_x"].dtype == torch.bfloat16
    assert st["conv_bc"].shape == (3, 3, 2 * dims["N"])
    assert st["state"].shape == (3, dims["H"], dims["P"], dims["N"]) and st["state"].dtype == torch.float32
    ref = RS.init_ssm_state(RR.get_smoke("mamba2-780m"), 1, 3, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: tuple(v.shape) for k, v in ref.items()}


# -- MLA -------------------------------------------------------------------------------------------


def _mla_pair(dtype: str):
    rcfg, tcfg = _configs("deepseek-v3-671b", dtype)
    rpd, tpd = RP.padded_dims(rcfg, 1), TP.padded_dims(tcfg, 1)
    p = RA.init_mla(jax.random.PRNGKey(9), rcfg, rpd, jnp.dtype(dtype))
    p["q_a_norm"] = p["q_a_norm"] * 1.5  # the norm scales must be read
    p["kv_a_norm"] = p["kv_a_norm"] * 0.75
    return rcfg, tcfg, rpd, tpd, p, TA.MLA(**_port(p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,qc,kc", [(13, 4, 8), (16, 16, 16), (9, 5, 3)])
def test_mla_forward_matches_the_reference(S, qc, kc, dtype):
    """Keys [k_nope, k_rope broadcast], values v_head_dim (16) wide against
    queries 24 wide, scale 1/sqrt(24)."""
    rcfg, tcfg, rpd, tpd, p, tp = _mla_pair(dtype)
    assert tp.q_a_norm.dtype == torch.float32 and tcfg.v_head_dim != tcfg.d_head
    x = np.random.default_rng(S).normal(0, 1, (2, S, rcfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    rx, tx = _both(x, dtype)
    r_out, (r_c, r_k) = jax.jit(lambda p, x, pos: RA.mla_forward(p, x, pos, rcfg, rpd, q_chunk=qc, kv_chunk=kc))(
        p, rx, jnp.asarray(pos))
    t_out, (t_c, t_k) = TA.mla_forward(tp, tx, torch.from_numpy(pos), tcfg, tpd, q_chunk=qc, kv_chunk=kc)
    for r, t in ((r_out, t_out), (r_c, t_c), (r_k, t_k)):
        assert t.dtype == tx.dtype
        _close(r, t, dtype)


@pytest.mark.parametrize("pos", [0, 6, 11])
def test_mla_absorbed_decode_matches_the_reference(pos):
    """``mla_attend_decode`` on a partly filled cache (garbage past ``pos``,
    an empty slot at -1), then the projections of ``mla_project_decode``."""
    rcfg, tcfg, rpd, tpd, p, tp = _mla_pair("float32")
    rng = np.random.default_rng(10 + pos)
    B, S, H = 2, 12, tpd.n_heads
    q_eff = rng.normal(0, 1, (B, 1, H, tcfg.kv_lora_rank)).astype(np.float32)
    q_rope = rng.normal(0, 1, (B, 1, H, tcfg.qk_rope_dim)).astype(np.float32)
    ckv = rng.normal(0, 2, (B, S, tcfg.kv_lora_rank)).astype(np.float32)
    krope = rng.normal(0, 2, (B, S, tcfg.qk_rope_dim)).astype(np.float32)
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[min(pos, 3)] = -1
    want = RA.mla_attend_decode(*(jnp.asarray(a) for a in (q_eff, q_rope, ckv, krope, kv_pos)), jnp.int32(pos),
                                rcfg, rpd)
    got = TA.mla_attend_decode(*(torch.from_numpy(a) for a in (q_eff, q_rope, ckv, krope, kv_pos)), pos, tcfg, tpd)
    _close(want, got, "float32")
    x = rng.normal(0, 1, (B, 1, tcfg.d_model)).astype(np.float32)
    want = RA.mla_project_decode(p, jnp.asarray(x), jnp.int32(pos), rcfg, rpd)
    got = TA.mla_project_decode(tp, torch.from_numpy(x), pos, tcfg, tpd)
    for r, t in zip(want, got):
        _close(r, t, "float32")


# -- blocks -------------------------------------------------------------------------------------------


def _block_pair(arch: str, kind: str, d_ff: int, dtype: str = "float32", **over):
    rcfg, tcfg = _configs(arch, dtype, **over)
    rpd = RP.padded_dims(rcfg, 1)
    p = RB.init_block(jax.random.PRNGKey(12), rcfg, rpd, 1, jnp.dtype(dtype), kind, d_ff)
    p = jax.tree.map(np.asarray, p)
    return rcfg, tcfg, rpd, p, block_from_reference(p, tcfg, kind, device="cpu")


def _block_check(rcfg, tcfg, rpd, p, block, kind: str, window: int, dtype: str = "float32") -> None:
    """Prefill over 13 positions, then 3 decode steps into a cache of 16
    slots: outputs and every cache entry against the reference's."""
    S, n = 13, 16
    x = np.random.default_rng(13).normal(0, 1, (2, n, rcfg.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    rx, tx = _both(x, dtype)
    r_forward = jax.jit(lambda p, x, pos: RB.block_forward(p, x, pos, rcfg, rpd, None, kind=kind, window=window,
                                                           q_chunk=4, kv_chunk=8))
    r_decode = jax.jit(lambda p, x, c, pos: RB.block_decode(p, x, c, pos, rcfg, rpd, None, kind=kind, window=window))
    r_out, r_entries, _ = r_forward(p, rx[:, :S], jnp.asarray(pos))
    with torch.inference_mode():
        t_out, t_entries = block(tx[:, :S], torch.from_numpy(pos), window=window, q_chunk=4, kv_chunk=8)
    _close(r_out, t_out, dtype)
    assert len(t_entries) == len(r_entries)
    r_cache, t_cache = [], []
    n_seq = 0 if kind == "ssm" else 2  # the attention entries, padded to the cache's slots
    for j, (r, t) in enumerate(zip(r_entries, t_entries)):
        _close(r, t, dtype)
        if j < n_seq:
            pad = [(0, 0)] * r.ndim
            pad[1] = (0, n - S)
            r = jnp.pad(r, pad)
            t = torch.cat([t, torch.zeros((t.shape[0], n - S) + tuple(t.shape[2:]), dtype=t.dtype)], dim=1)
        r_cache.append(r)
        t_cache.append(t.clone())
    for i in range(S, n):
        r_y, r_cache = r_decode(p, rx[:, i : i + 1], tuple(r_cache), jnp.int32(i))
        with torch.inference_mode():
            t_y = block.decode(tx[:, i : i + 1], tuple(t_cache), i, window=window)
        _close(r_y, t_y, dtype)
        for r, t in zip(r_cache, t_cache):
            _close(r, t, dtype)


@pytest.mark.parametrize("window", [4, GLOBAL_WINDOW])
def test_hybrid_block_with_a_window_and_as_a_global_layer(window):
    """Hymba's block: GQA ∥ SSD on the same normed input, each branch
    RMS-normed, averaged, then the MLP; a window of 4 of 13 positions
    masks, the global sentinel does not."""
    rcfg, tcfg, rpd, p, block = _block_pair("hymba-1.5b", "hybrid", 128)
    assert block.kind == "hybrid" and block.norm_attn is not None and block.mlp is not None
    _block_check(rcfg, tcfg, rpd, p, block, "hybrid", window)


def test_hybrid_window_masks():
    """The window changes the block's output: it really masks."""
    _, tcfg, _, _, block = _block_pair("hymba-1.5b", "hybrid", 128)
    x = torch.randn(2, 13, tcfg.d_model)
    pos = torch.arange(13, dtype=torch.int32).expand(2, 13)
    with torch.inference_mode():
        a, _ = block(x, pos, window=4, q_chunk=4, kv_chunk=8)
        b, _ = block(x, pos, window=GLOBAL_WINDOW, q_chunk=4, kv_chunk=8)
    assert torch.equal(a[:, :4], b[:, :4]) and not torch.allclose(a[:, 4:], b[:, 4:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kind,d_ff", [
    ("deepseek-v3-671b", "moe", 0),
    ("deepseek-v3-671b", "attn", 96),
    ("qwen2-moe-a2.7b", "moe", 0),
    ("mamba2-780m", "ssm", 0),
])
def test_blocks_of_the_new_kinds_match_the_reference(arch, kind, d_ff, dtype):
    """The MoE block (shared experts ∥ routed MoE, over MLA or GQA), the
    MLA "attn" block (absorbed decode) and the SSD block; MoE at capacity
    factor 64, so that decode's B tokens drop nothing."""
    over = dict(capacity_factor=64.0) if kind == "moe" else {}
    rcfg, tcfg, rpd, p, block = _block_pair(arch, kind, d_ff, dtype, **over)
    _block_check(rcfg, tcfg, rpd, p, block, kind, 0, dtype)
