"""The port's LM layers, configs and serving boundaries against the
reference, on the CPU.

The layers (``repro_torch.models.layers`` and the GQA half of
``repro_torch.models.attention``) take the same numpy inputs as the
reference's (``repro.models``, JAX on the CPU) and must agree: float32
within 1e-5, bfloat16 within a few units of its last place. The ten
configs, their parameter counts and their TP padding must equal the
reference's field for field, and ``init_lm`` must build the reference's
structure for each. The serving path must refuse to run without a CUDA
device unless asked for the CPU, and a mesh must have a "model" axis and
a serving placement of "fsdp" or "tp", as the reference's rules say. The
MoE, SSD, MLA and hybrid modules have their own file,
``tests/test_torch_lm_families.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as RR
import repro.models.attention as RA
import repro.models.layers as RL
import repro.models.lm as RLM
import repro.parallel.padding as RP
import repro_torch.configs.registry as TR
import repro_torch.models.attention as TA
import repro_torch.models.layers as TL
import repro_torch.parallel.padding as TP
from repro.models.config import ArchConfig as RArchConfig
from repro_torch.launch.serve import serve_batch
from repro_torch.models import lm
from repro_torch.models.blocks import RMSNorm
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.convert import lm_from_reference
from repro_torch.serving import steps

F32_TOL = 1e-5
ARCHS = RR.ARCHS


def _both(a: np.ndarray, dtype: str):
    """The same values as a reference array and a port tensor."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _close(ref, got: torch.Tensor, dtype: str) -> None:
    r, g = np.asarray(ref, np.float32), got.float().numpy()
    assert r.shape == g.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, r, rtol=0, atol=F32_TOL)
    else:  # a couple of bfloat16 ulps of the values' scale
        np.testing.assert_allclose(g, r, rtol=0, atol=2 * 2**-8 * max(np.abs(r).max(), 1.0))


# -- layers ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_dense(dtype):
    rng = np.random.default_rng(0)
    x, scale, w = rng.normal(0, 1, (2, 5, 16)), rng.normal(1, 0.1, 16), rng.normal(0, 0.25, (16, 24))
    rx, tx = _both(x, dtype)
    rw, tw = _both(w, dtype)
    rs, ts = jnp.asarray(scale, jnp.float32), torch.from_numpy(scale.astype(np.float32))
    got = TL.rmsnorm(tx, ts, 1e-6)
    assert got.dtype == tx.dtype
    _close(RL.rmsnorm(rx, rs, 1e-6), got, dtype)
    got = TL.dense(tx, tw)
    assert got.dtype == tx.dtype
    _close(RL.dense(rx, rw), got, dtype)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(gated, act, dtype):
    """GELU is the tanh approximation (jax.nn.gelu's default): torch's exact
    default differs by ~1e-3 and fails the float32 cases."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.5, (2, 7, 16))
    ws = {"wi": rng.normal(0, 0.25, (16, 32)), "wo": rng.normal(0, 0.2, (32, 16))}
    if gated:
        ws["wg"] = rng.normal(0, 0.25, (16, 32))
    rx, tx = _both(x, dtype)
    rp = {k: _both(v, dtype)[0] for k, v in ws.items()}
    tp = types.SimpleNamespace(**{k: _both(v, dtype)[1] for k, v in ws.items()})
    _close(RL.mlp_apply(rp, rx, act, gated), TL.mlp_apply(tp, tx, act, gated), dtype)


@pytest.mark.parametrize("dh,rotary_pct", [(16, 1.0), (16, 0.5), (12, 0.5), (12, 0.25), (8, 0.1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dh, rotary_pct, dtype):
    """Halves rotated, not interleaved pairs; the rotated width is
    int(dh · rotary_pct) rounded down to even (0 leaves x as it is);
    positions up to 4,000 keep the float32 angles honest."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 6, 3, dh))
    pos = rng.integers(0, 4000, (2, 6)).astype(np.int32)
    rx, tx = _both(x, dtype)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 10_000.0, rotary_pct)
    _close(RL.apply_rope(rx, jnp.asarray(pos), 10_000.0, rotary_pct), got, dtype)
    d_rot = int(dh * rotary_pct) // 2 * 2
    assert torch.equal(got[..., d_rot:], tx[..., d_rot:])


def test_combine_partial_softmax():
    rng = np.random.default_rng(3)
    args = [rng.normal(0, 1, s) for s in ((3, 4, 5), (3, 4), (3, 4))] * 2
    want = RL.combine_partial_softmax(*(jnp.asarray(a, jnp.float32) for a in args))
    got = TL.combine_partial_softmax(*(torch.from_numpy(a.astype(np.float32)) for a in args))
    for w, g in zip(want, got):
        _close(w, g, "float32")


# S, q_chunk, kv_chunk, G, window, kv offset (keys start there, so queries
# before it see no key: fully masked rows)
FLASH_CASES = [
    (16, 4, 4, 1, 0, 0),
    (33, 8, 16, 4, 0, 0),
    (17, 5, 3, 2, 0, 0),
    (64, 64, 64, 4, 0, 0),
    (24, 8, 8, 2, 4, 0),
    (13, 4, 8, 4, 1, 0),
    (40, 16, 16, 1, 9, 0),
    (19, 4, 6, 2, 0, 7),
    (21, 8, 5, 3, 5, 4),
]


@pytest.mark.parametrize("S,qc,kc,G,window,offset", FLASH_CASES)
def test_flash_attention(S, qc, kc, G, window, offset):
    rng = np.random.default_rng(S * 7 + G)
    B, Hkv, D = 2, 2, 8
    q = rng.normal(0, 1, (B, S, Hkv * G, D))
    k, v = rng.normal(0, 1, (B, S, Hkv, D)), rng.normal(0, 1, (B, S, Hkv, D))
    qpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kpos = qpos + offset
    kw = dict(causal=True, window=window, q_chunk=qc, kv_chunk=kc)
    want = RL.flash_attention(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)), jnp.asarray(qpos), jnp.asarray(kpos), **kw)
    got = TL.flash_attention(*(torch.from_numpy(a.astype(np.float32)) for a in (q, k, v)),
                             torch.from_numpy(qpos.copy()), torch.from_numpy(kpos.copy()), **kw)
    _close(want, got, "float32")
    if offset:  # queries before the first key are zero rows
        assert torch.count_nonzero(got[:, :offset]) == 0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_and_padding(causal):
    """bfloat16 inputs, a non-causal call (padded keys masked through
    INT32_MAX), a score bias and an explicit scale."""
    rng = np.random.default_rng(4)
    B, S, Hkv, G, D = 2, 11, 1, 4, 16
    arrs = [rng.normal(0, 1, (B, S, Hkv * G, D)), rng.normal(0, 1, (B, S, Hkv, D)), rng.normal(0, 1, (B, S, Hkv, D))]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(causal=causal, q_chunk=4, kv_chunk=4, scale=0.3, score_bias=0.5)
    want = RL.flash_attention(*(_both(a, "bfloat16")[0] for a in arrs), jnp.asarray(pos), jnp.asarray(pos), **kw)
    got = TL.flash_attention(*(_both(a, "bfloat16")[1] for a in arrs), torch.from_numpy(pos), torch.from_numpy(pos), **kw)
    assert got.dtype == torch.bfloat16
    _close(want, got, "bfloat16")


def _cfg_pair(**kw):
    base = dict(name="unit", family="dense", n_layers=1, d_model=32, n_kv_heads=2, d_ff=0, vocab_size=8)
    return RArchConfig(**base, **kw), TArchConfig(**base, **kw)


@pytest.mark.parametrize("pos,window", [(6, 0), (6, 3), (0, 0), (11, 0)])
@pytest.mark.parametrize("n_heads", [2, 8])
def test_gqa_attend_decode_on_a_partly_filled_cache(pos, window, n_heads):
    """Slots past ``pos`` hold garbage and empty slots (-1) too: only
    ``0 <= kv_pos <= pos`` (inside the window) may count."""
    rcfg, tcfg = _cfg_pair(n_heads=n_heads, d_head=8)
    rpd, tpd = RP.padded_dims(rcfg, 1), TP.padded_dims(tcfg, 1)
    rng = np.random.default_rng(5 + pos)
    B, S = 2, 12
    q = rng.normal(0, 1, (B, 1, n_heads, 8))
    kc, vc = rng.normal(0, 3, (B, S, 2, 8)), rng.normal(0, 3, (B, S, 2, 8))
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[2] = -1
    want = RA.gqa_attend_decode(*(jnp.asarray(a, jnp.float32) for a in (q, kc, vc)), jnp.asarray(kv_pos),
                                jnp.int32(pos), rcfg, rpd, window=window)
    got = TA.gqa_attend_decode(*(torch.from_numpy(a.astype(np.float32)) for a in (q, kc, vc)),
                               torch.from_numpy(kv_pos), pos, tcfg, tpd, window=window)
    _close(want, got, "float32")


# -- configs -----------------------------------------------------------------------------


def test_registry_equals_the_reference():
    assert TR.ARCHS == RR.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in TR.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RR.SHAPES.items()
    }
    for arch in RR.ARCHS:
        for shape in RR.SHAPES:
            assert TR.shape_applicable(TR.get_arch(arch), shape) == RR.shape_applicable(RR.get_arch(arch), shape)
    with pytest.raises(KeyError):
        TR.get_arch("gpt-2")


@pytest.mark.parametrize("arch", RR.ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_equals_the_reference(arch, which):
    get_t, get_r = (TR.get_arch, RR.get_arch) if which == "CONFIG" else (TR.get_smoke, RR.get_smoke)
    t, r = get_t(arch), get_r(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for prop in ("d_inner", "ssm_heads", "is_moe", "uses_attention", "uses_ssm", "supports_long_context"):
        assert getattr(t, prop) == getattr(r, prop)
    assert t.param_count() == r.param_count()
    for tp in (1, 2, 4, 8, 16):
        assert dataclasses.asdict(TP.padded_dims(t, tp)) == dataclasses.asdict(RP.padded_dims(r, tp))
        assert TP.padding_report(t, tp) == RP.padding_report(r, tp)


def test_paligemma_vocabulary_pads_to_257280_at_tp1():
    cfg = TR.get_arch("paligemma-3b")
    assert TP.padded_dims(cfg, 1).vocab_size == 257_280
    assert TP.padding_report(cfg, 1) == {"vocab_size": (257_216, 257_280)}


# -- the serving path's boundaries ------------------------------------------------------------


def test_serving_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TR.get_smoke("starcoder2-3b")
    for call in (
        lambda: serve_batch(cfg, batch_size=1, prompt_len=4, gen_tokens=1),
        lambda: steps.make_prefill_step(cfg, s_alloc=8),
        lambda: steps.make_decode_step(cfg),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    out = serve_batch(cfg, batch_size=1, prompt_len=4, gen_tokens=2, device="cpu")
    assert out["tokens"].shape == (1, 2)


def test_mesh_placements_raise():
    """The mesh rules the reference enforces: a mesh needs a "model" axis,
    and a serving placement is "fsdp" or "tp"."""
    from repro_torch.parallel.sharding import AbstractMesh, make_ctx

    cfg = TR.get_smoke("yi-34b")
    with pytest.raises(ValueError, match="'model' axis"):
        make_ctx(AbstractMesh((2, 4), ("data", "tensor")))
    with pytest.raises(ValueError, match="serve_sharding"):
        steps.make_decode_step(cfg, make_ctx(AbstractMesh((2, 4), ("data", "model"))), serve_sharding="ep",
                               device="cpu")


def test_steps_refuse_another_model_or_device():
    cfg = TR.get_smoke("yi-34b")
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    other = steps.make_prefill_step(TR.get_smoke("chatglm3-6b"), s_alloc=8, device="cpu")
    with pytest.raises(ValueError, match="the model is"):
        other(model, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    meta = steps.make_prefill_step(cfg, s_alloc=8, device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        meta(model, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def test_exact_matmul_turns_reduced_precision_off_and_restores_it():
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    try:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = True, True
        with steps.exact_matmul():
            assert not m.allow_bf16_reduced_precision_reduction and not m.allow_tf32
        assert m.allow_bf16_reduced_precision_reduction and m.allow_tf32
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved


# -- weights ---------------------------------------------------------------------------------


#: float32 leaves that are not norm scales, and how the reference draws them
SSD_FLOAT32 = ("A_log", "D", "dt_bias")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_has_the_reference_structure_and_distributions(arch):
    """``init_lm`` makes the tensors ``lm_from_reference`` makes from the
    reference's ``init_lm`` pytree (names, shapes, types; the MTP head
    included), drawn as the reference draws them: dense weights and
    experts inside ±2/sqrt(d_in), the embedding's spread 0.02, norm scales
    ones in float32, the router float32, the SSD's conv weights normal
    times 0.1, zero conv biases, ``A_log = log(linspace(1, 16, H))``,
    ``D`` ones and ``dt_bias`` the inverse softplus of a dt in [0.001,
    0.1]."""
    cfg = TR.get_smoke(arch)
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda key: RLM.init_lm(key, RR.get_smoke(arch)), jax.random.PRNGKey(0))
    ref = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    carried = lm_from_reference(ref, cfg, device="cpu")
    mine = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    assert mine == {n: (tuple(p.shape), p.dtype) for n, p in carried.named_parameters()}
    n_leaves = len(jax.tree.leaves(shapes))
    assert len(mine) == n_leaves + sum(  # the reference stacks each stack's layers on one leaf
        (len(jax.tree.leaves(shapes[f"stack_{s.name}"])) * (s.n_layers - 1)) for s in lm.stacks_for(cfg)
    )
    assert (model.mtp is not None) == cfg.mtp
    for name, p in model.named_parameters():
        w = p.detach().float()
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("scale") or leaf in ("out_norm", "q_a_norm", "kv_a_norm", "D"):
            assert p.dtype == torch.float32 and torch.all(w == 1), name
        elif leaf == "A_log":
            assert p.dtype == torch.float32
            torch.testing.assert_close(w, torch.log(torch.linspace(1.0, 16.0, w.numel())))
        elif leaf == "dt_bias":
            dt = torch.nn.functional.softplus(w)
            assert p.dtype == torch.float32
            assert float(dt.min()) >= 0.001 * (1 - 1e-4) and float(dt.max()) <= 0.1 * (1 + 1e-4)
        elif leaf in ("conv_x_b", "conv_bc_b"):
            assert torch.all(w == 0), name
        elif leaf in ("conv_x", "conv_bc"):
            assert abs(float(w.std()) - 0.1) < 0.03, name
        elif name == "embed":
            assert abs(float(w.std()) - 0.02) < 0.002
        else:
            assert p.dtype == (torch.float32 if leaf == "router" else torch.bfloat16), name
            d_in = w.shape[-2]
            assert float(w.abs().max()) <= 2 / d_in**0.5 * (1 + 2**-7), name
            assert abs(float(w.std()) * d_in**0.5 - 0.88) < 0.1, name  # the [-2, 2] normal's spread
    assert model.dtype == torch.bfloat16


def test_norm_scales_stay_float32_when_the_model_is_cast():
    cfg = dataclasses.replace(TR.get_smoke("paligemma-3b"), dtype="float32")
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    norms = [m for m in model.modules() if isinstance(m, RMSNorm)]
    for m in norms:
        m.scale.data.uniform_(0.5, 1.5)
    before = [m.scale.detach().clone() for m in norms]
    model.to(torch.bfloat16)
    assert model.dtype == torch.bfloat16
    for m, b in zip(norms, before):
        assert m.scale.dtype == torch.float32 and torch.equal(m.scale, b)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-780m", "hymba-1.5b"])
def test_float32_leaves_stay_float32_when_the_model_is_cast(arch):
    """The router, the SSD's ``A_log``, ``D``, ``dt_bias`` and ``out_norm``
    and MLA's two norm scales are float32 in the reference whatever the
    model's type: a cast of the port's model leaves them so, values and
    all, and casts every other weight."""
    cfg = dataclasses.replace(TR.get_smoke(arch), dtype="float32")
    model = lm.init_lm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    kept = ("scale", "router", "A_log", "D", "dt_bias", "out_norm", "q_a_norm", "kv_a_norm")
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n.rsplit(".", 1)[-1] in kept}
    assert any(not n.endswith("scale") for n in before)
    model.to(torch.bfloat16)
    for n, p in model.named_parameters():
        if n in before:
            assert p.dtype == torch.float32 and torch.equal(p, before[n]), n
        else:
            assert p.dtype == torch.bfloat16, n


@pytest.mark.parametrize("d_model", [48, 2048])
def test_embed_scale_rounds_sqrt_d_to_the_activation_type(d_model):
    """``embed_scale`` multiplies by sqrt(d_model) cast to the activation
    type first (45.25 for paligemma's 2048 in bfloat16, not 45.2548...)."""
    base = dict(TR.get_smoke("paligemma-3b").__dict__, d_model=d_model, n_layers=1, d_ff=8)
    rcfg, tcfg = RArchConfig(**base), TArchConfig(**base)
    model = lm.init_lm(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = np.random.default_rng(6).normal(0, 1, (1, 3, d_model))
    rx, tx = _both(x, "bfloat16")
    want = np.asarray(RLM._embed_in({}, {"embeds": rx}, rcfg), np.float32)
    np.testing.assert_array_equal(lm._embed_in(model, {"embeds": tx}).float().numpy(), want)
