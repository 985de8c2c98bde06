"""The port's LM training path against the reference's, on the CPU, for the
six "attn"-stack architectures at their SMOKE sizes (the MoE, MLA, SSD and
hybrid families are in ``test_torch_lm_train_families.py``, which takes
its helpers from here).

The reference's ``init_lm`` draws the weights and ``lm_from_reference``
carries them into the port. Both packages then take the loss
(``forward_train``, ``remat="none"``) and its gradients
(``jax.value_and_grad`` against ``torch.autograd``) on the same batch;
the port's gradients go back to the reference's layout, leaf by leaf,
through ``param_leaves``. Bounds, each beside the largest gap measured on
the CPU over the ten configs:

  float32:  loss and metrics within 1e-5 (measured 4.8e-7); gradients
            within 1e-5 of the largest gradient magnitude (1.1e-6).
  bfloat16: loss and metrics within 1e-2 (2.0e-3); gradients within
            6e-2 of the largest gradient magnitude (2.5e-2, 4 bfloat16
            ulps at that magnitude).

The bfloat16 reference is compiled with ``xla_allow_excess_precision``
off: PyTorch rounds every operation's output to bfloat16, and so does
the reference run op by op, but XLA's fusions may otherwise keep
intermediates in float32, which flips qwen2-moe's routing on near ties
against the reference's own op-by-op run.

Remat ``none``, ``dots`` and ``full`` give bit-equal gradients. One whole
``make_train_step`` step in float32 (AdamW, lr 1e-2, warmup 1) with
``microbatches`` 1 and 2 against the reference's step: metrics within
1e-5 (measured 4.8e-7, ``grad_norm`` relative 1e-6), the optimizer state
within 1e-6 (1.3e-8) and the parameters within 1e-5 wherever the
step's gradient is above 1e-5 of its largest magnitude. Where it is
not, Adam's first update (the learning rate times the gradient's sign,
as ``eps`` is 1e-8) may flip with rounding: there the bound is twice the
learning rate (measured 1.5e-4 on 22 entries at most).
"""

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs.registry as RR
import repro.models.lm as RLM
import repro.models.moe as RM
import repro.training.optimizer as RO
import repro.training.steps as RS
import repro_torch.configs.registry as TR
import repro_torch.models.moe as TM
from repro_torch.models import lm
from repro_torch.models.convert import lm_from_reference, lm_to_reference, opt_to_reference, param_leaves
from repro_torch.training.optimizer import OptConfig, global_norm, init_opt
from repro_torch.training.steps import TrainSettings, loss_and_grads, make_train_step
from test_torch_lm_serve import _route_mismatches

ATTN_ARCHS = ("starcoder2-3b", "yi-34b", "chatglm3-6b", "minitron-8b", "musicgen-medium", "paligemma-3b")
B, S, CHUNK = 2, 16, 8
BOUNDS = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 6e-2)}  # (loss and metrics, gradients relative)
STEP_LR = 1e-2
_ref_init_lm = jax.jit(RLM.init_lm, static_argnames=("cfg", "tp"))
#: PyTorch rounds each operation's bfloat16 output; so must the reference
EXACT_ROUNDING = {"xla_allow_excess_precision": False}


def _configs(arch, dtype):
    return dataclasses.replace(RR.get_smoke(arch), dtype=dtype), dataclasses.replace(TR.get_smoke(arch), dtype=dtype)


@functools.cache
def _ref_params(arch, dtype):
    rcfg, _ = _configs(arch, dtype)
    return jax.tree.map(np.asarray, _ref_init_lm(jax.random.PRNGKey(0), rcfg, 1))


def _model(arch, dtype):
    return lm_from_reference(_ref_params(arch, dtype), _configs(arch, dtype)[1], device="cpu")


def _batch(arch, b=B):
    """(reference batch, port batch): tokens or frame embeddings, and labels
    ``[B, S]`` (``[B, S, CB]`` for multi-codebook archs)."""
    cfg = RR.get_smoke(arch)
    rng = np.random.default_rng(1)
    if cfg.input_mode == "tokens":
        x = {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)}
    else:
        x = {"embeds": rng.normal(0, 1, (b, S, cfg.d_model)).astype(np.float32)}
    shape = (b, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, S)
    x["labels"] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return x, {k: torch.from_numpy(v) for k, v in x.items()}


def _flat(tree) -> dict:
    """{path tuple: float32 numpy} of a reference-layout tree."""
    return {
        tuple(str(k.key) for k in path): np.asarray(leaf).astype(np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _port_grads(model, grads) -> dict:
    """The port's gradients in the reference's layout: {path: float32 numpy},
    a stack leaf's layers stacked on axis 0."""
    it, out = iter(grads), {}
    for path, ps in param_leaves(model):
        gs = [next(it).float().numpy() for _ in ps]
        out[path] = np.stack(gs) if path[0].startswith("stack_") else gs[0]
    return out


@contextlib.contextmanager
def _routes(force=None):
    """Every call of the port's router and of the reference's, in order:
    (expert indices, float32 router logits). Yields (the port's, the
    reference's). With ``force``, a list of the reference's calls, the
    port records its own choices but routes each call as the reference
    did (the gates from its own scores at those experts)."""
    port, ref = [], []
    t_route, r_route = TM.route, RM._route

    def t_recording(cfg, logits, e_valid):
        out = t_route(cfg, logits, e_valid)
        port.append((out[0].numpy(), logits.detach().numpy()))
        if force is None:
            return out
        idx = torch.tensor(np.asarray(force[len(port) - 1][0]), dtype=torch.long)
        masked = torch.where(torch.arange(logits.shape[-1]) < e_valid, logits, -1e30)
        scores = torch.sigmoid(masked) if cfg.router_score == "sigmoid" else torch.softmax(masked, dim=-1)
        top = scores.gather(1, idx)
        return idx, top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9), out[2]

    def r_recording(cfg, logits, e_valid):
        out = r_route(cfg, logits, e_valid)
        jax.debug.callback(lambda i, l: ref.append((np.asarray(i), np.asarray(l))), out[0], logits, ordered=True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "route", t_recording)
        mp.setattr(RM, "_route", r_recording)
        yield port, ref


@functools.cache
def _ref_value_and_grad(arch, dtype):
    """The reference's jitted ``value_and_grad`` of ``forward_train``, made
    once per config; bfloat16 compiled with every operation rounded."""
    rcfg, _ = _configs(arch, dtype)
    fn = lambda p, b: RLM.forward_train(p, b, rcfg, None, remat="none", q_chunk=CHUNK, kv_chunk=CHUNK)  # noqa: E731
    opts = EXACT_ROUNDING if dtype == "bfloat16" else None
    return jax.jit(jax.value_and_grad(fn, has_aux=True), compiler_options=opts)


@functools.cache
def _ref_run(arch, dtype):
    """The reference's (loss, metrics, gradient tree, routing calls) on
    ``_batch``, run once per config."""
    rb, _ = _batch(arch)
    with _routes() as (_, routes):
        (loss, metrics), grads = _ref_value_and_grad(arch, dtype)(_ref_params(arch, dtype), rb)
        jax.effects_barrier()
    return loss, metrics, grads, list(routes)


def _reference_loss_and_grads(arch, dtype):
    """(loss, metrics, gradients {path: float32 numpy}, routing calls)."""
    loss, metrics, grads, routes = _ref_run(arch, dtype)
    return float(loss), {k: float(v) for k, v in metrics.items()}, _flat(grads), routes


def check_loss_and_grads(arch, dtype, *, near_ties: bool | frozenset = False) -> dict:
    """The port's loss, metrics and gradients against the reference's within
    ``BOUNDS``. An MoE config's port routes every call as the reference
    did, so that one choice flipped by rounding does not move every
    layer after it, and its own choices, call by call, must equal the
    reference's: exactly, or with ``near_ties`` up to ties that rounding
    decides (``_route_mismatches``), anywhere (``True``) or only at the
    (routing call, token) pairs of a set. Returns the gaps."""
    want_loss, want_metrics, want_grads, want_routes = _reference_loss_and_grads(arch, dtype)
    model = _model(arch, dtype)
    _, tb = _batch(arch)
    with _routes(force=want_routes) as (got_routes, _):
        loss, metrics, grads = loss_and_grads(model, tb, TrainSettings(remat="none", q_chunk=CHUNK, kv_chunk=CHUNK))
    bad = _route_mismatches(arch, dtype, want_routes, got_routes, near_ties=bool(near_ties))
    assert not bad, "\n".join(bad)
    if isinstance(near_ties, frozenset):
        flips = {(n, int(t)) for n, ((r_idx, _), (t_idx, _)) in enumerate(zip(want_routes, got_routes))
                 for t in np.nonzero((r_idx != t_idx).any(-1))[0]}
        assert flips <= near_ties, f"{arch} {dtype}: choices differ at (call, token) {sorted(flips - near_ties)}"
    loss_bound, grad_bound = BOUNDS[dtype]
    assert sorted(metrics) == sorted(want_metrics)
    assert float(metrics["tokens"]) == want_metrics["tokens"]
    gaps = {"loss": abs(float(loss) - want_loss)}
    for name in ("ce", "aux", "mtp"):
        if name in want_metrics:
            gaps[name] = abs(float(metrics[name]) - want_metrics[name])
    for name, gap in gaps.items():
        assert gap <= loss_bound, f"{arch} {dtype}: {name} differs by {gap} > {loss_bound}"
    got_grads = _port_grads(model, grads)
    assert sorted(got_grads) == sorted(want_grads)
    g_max = max(np.abs(g).max() for g in want_grads.values())
    for path, want in want_grads.items():
        assert got_grads[path].shape == want.shape, path
        gap = np.abs(got_grads[path] - want).max() / g_max
        assert gap <= grad_bound, f"{arch} {dtype}: gradient {'/'.join(path)} differs by {gap} > {grad_bound}"
        gaps["grad_rel"] = max(gaps.get("grad_rel", 0.0), float(gap))
    return gaps


def check_remat(arch):
    """Remat ``none``, ``dots`` and ``full`` give bit-equal gradients."""
    model = _model(arch, "float32")
    _, tb = _batch(arch)
    runs = [loss_and_grads(model, tb, TrainSettings(remat=r, q_chunk=CHUNK, kv_chunk=CHUNK))
            for r in lm.REMATS]
    for remat, (loss, _, grads) in zip(lm.REMATS[1:], runs[1:]):
        assert torch.equal(loss, runs[0][0]), remat
        for a, b in zip(runs[0][2], grads):
            assert torch.equal(a, b), f"{arch}: remat {remat} changes a gradient"


def _ref_step(arch, microbatches, params, opt_state, batch):
    """The reference's ``train_step``: at one microbatch its own two parts,
    ``value_and_grad`` (``_ref_run``'s, compiled already) and
    ``opt_update``; at two, its jitted step."""
    rcfg, _ = _configs(arch, "float32")
    ropt = RO.OptConfig(lr=STEP_LR, warmup_steps=1)
    if microbatches == 1:
        loss, metrics, grads, _ = _ref_run(arch, "float32")
        new_p, new_o, stats = jax.jit(functools.partial(RO.opt_update, cfg=ropt))(grads, opt_state, params)
        return new_p, new_o, dict(metrics, loss=loss, **stats)
    settings = RS.TrainSettings(microbatches=microbatches, remat="none", q_chunk=CHUNK, kv_chunk=CHUNK, opt=ropt)
    return jax.jit(RS.make_train_step(rcfg, None, settings)[0])(params, opt_state, batch)


def check_train_step(arch, microbatches):
    """One float32 step of ``make_train_step`` against the reference's."""
    params = _ref_params(arch, "float32")
    rb, tb = _batch(arch)
    ropt = RO.OptConfig(lr=STEP_LR, warmup_steps=1)
    want_p, want_o, want_m = _ref_step(arch, microbatches, params, RO.init_opt(params, ropt), rb)
    model = _model(arch, "float32")
    _, tcfg = _configs(arch, "float32")
    opt = OptConfig(lr=STEP_LR, warmup_steps=1)
    settings = TrainSettings(microbatches=microbatches, remat="none", q_chunk=CHUNK, kv_chunk=CHUNK, opt=opt)
    # the step's gradient, the microbatches' mean (an MoE layer's capacity
    # follows the microbatch's tokens, so it is not the whole batch's)
    size = B // microbatches
    parts = [loss_and_grads(model, {k: v[i * size : (i + 1) * size] for k, v in tb.items()}, settings)[2]
             for i in range(microbatches)]
    grads = _port_grads(model, [sum(g) / microbatches for g in zip(*parts)])
    step, in_sh, out_sh = make_train_step(tcfg, None, settings, device="cpu")
    assert in_sh is None and out_sh is None
    opt_state = init_opt(param_leaves(model), opt)
    same_model, opt_state, metrics = step(model, opt_state, tb)
    assert same_model is model and opt_state["step"] == 1
    assert sorted(metrics) == sorted(want_m)
    for name, want in want_m.items():
        got, want = float(metrics[name]), float(want)
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), f"{arch} mb {microbatches}: {name} {got} != {want}"
    # the state: bit layout of the reference's, values within 1e-6
    got_o, want_o = _flat(opt_to_reference(opt_state)["state"]), _flat(want_o["state"])
    assert sorted(got_o) == sorted(want_o)
    for path, want in want_o.items():
        assert np.abs(got_o[path] - want).max() <= 1e-6, path
    # the parameters: within 1e-5 but where the gradient is at the rounding level
    g_max = max(np.abs(g).max() for g in grads.values())
    got_p, want_p = _flat(lm_to_reference(model)), _flat(want_p)
    for path, want in want_p.items():
        gap = np.abs(got_p[path] - want)
        noise = np.abs(grads[path]) <= 1e-5 * g_max
        assert gap[~noise].max(initial=0.0) <= 1e-5, f"{arch} mb {microbatches}: {'/'.join(path)} moved differently"
        assert gap[noise].max(initial=0.0) <= 2 * STEP_LR * (1 + 1e-6), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_loss_and_gradients_match_the_reference(arch, dtype):
    gaps = check_loss_and_grads(arch, dtype)
    assert gaps["aux"] == 0.0  # no MoE layer: the auxiliary loss is 0 in both


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_remat_leaves_the_gradients_unchanged(arch):
    check_remat(arch)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_train_step_matches_the_reference(arch, microbatches):
    check_train_step(arch, microbatches)


def test_microbatches_accumulate_in_float32():
    """Two microbatches give the gradient of the whole batch (every label is
    valid, so the mean of the halves' means is the batch's mean) within
    float32 rounding; on a bfloat16 model the step's gradient norm is
    that of the float32 mean of the halves' bfloat16 gradients, bit for
    bit (the reference's float32 ``g0`` accumulator), not of a bfloat16
    sum."""
    opt = OptConfig(lr=STEP_LR, warmup_steps=1)
    _, tb = _batch("starcoder2-3b")
    for dtype in ("float32", "bfloat16"):
        norms = []
        for mb in (1, 2):
            model = _model("starcoder2-3b", dtype)
            settings = TrainSettings(microbatches=mb, remat="none", q_chunk=CHUNK, kv_chunk=CHUNK, opt=opt)
            step, _, _ = make_train_step(model.cfg, None, settings, device="cpu")
            norms.append(float(step(model, init_opt(param_leaves(model), opt), tb)[2]["grad_norm"]))
        assert abs(norms[0] - norms[1]) <= (1e-6 if dtype == "float32" else 1e-2) * norms[0], (dtype, norms)
    model = _model("starcoder2-3b", "bfloat16")
    halves = [loss_and_grads(model, {k: v[i : i + 1] for k, v in tb.items()}, settings)[2] for i in range(2)]
    want = global_norm([(a.float() + b.float()) / 2 for a, b in zip(*halves)])
    assert halves[0][0].dtype == torch.bfloat16
    assert norms[1] == float(want)


def test_remat_and_mesh_settings_are_checked():
    cfg = TR.get_smoke("starcoder2-3b")
    with pytest.raises(ValueError, match="remat"):
        make_train_step(cfg, None, TrainSettings(remat="some"), device="cpu")
    with pytest.raises(ValueError, match="remat"):
        lm.forward_train(_model("starcoder2-3b", "float32"), _batch("starcoder2-3b")[1], remat="some")
    # the reference's mesh rules: fsdp_all is not for MoE archs, param_mode is one of two
    from repro_torch.parallel.sharding import AbstractMesh, make_ctx

    ctx = make_ctx(AbstractMesh((2, 4), ("data", "model")))
    with pytest.raises(ValueError, match="fsdp_all"):
        make_train_step(TR.get_smoke("qwen2-moe-a2.7b"), ctx, TrainSettings(param_mode="fsdp_all"), device="cpu")
    with pytest.raises(ValueError, match="param_mode"):
        make_train_step(cfg, ctx, TrainSettings(param_mode="zero"), device="cpu")
