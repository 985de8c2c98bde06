"""The port's training loop against the reference's, on the CPU: the
optimizer, the corpus and the HR data pipeline, checkpoints (written by
either package, restored by the other) with their manifests and restore
routing, and ``run_training`` with failure recovery, resume and a
six-step loop parity run. The reference's own ``tests/test_substrate.py``
cases are mirrored on the port.

Bounds: the optimizer on identical gradients within 1e-6 of each leaf's
largest magnitude (float32 means and divisions taken in other orders);
``adamw_bf16``'s bfloat16 moments within 2^-7 of each leaf's largest
magnitude (a rounding of the moment before, carried on), and its
parameters, whose next update such a rounding moves, within 2^-5 of the
learning rate; the loop parity run's losses within 1e-5 (measured
4.8e-7 over six steps), its optimizer state within 1e-5 of each leaf's
largest magnitude and its parameters' movement within 1e-3 of each
leaf's largest movement. The corpus, the pipeline's batches and reports,
checkpoint bytes, manifests and restore plans are equal exactly.
"""

import dataclasses
import filecmp
import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.layouts as RCL
import repro.checkpoint.manager as RCM
import repro.configs.registry as RR
import repro.data.corpus as RC
import repro.data.pipeline as RP
import repro.launch.train as RT
import repro.models.lm as RLM
import repro.training.optimizer as RO
import repro_torch.configs.registry as TR
import repro_torch.launch.train as TT
from repro.core import Eq as REq, Query as RQuery, Range as RRange
from repro_torch.checkpoint.layouts import CheckpointRouter
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    latest_step,
    load_train_tree,
    restore_checkpoint,
    save_checkpoint,
    train_tree,
    unflatten,
)
from repro_torch.core import Eq, Query, Range
from repro_torch.data.corpus import CorpusSpec, SyntheticCorpus
from repro_torch.data.pipeline import HRDataPipeline, curriculum_workload
from repro_torch.ft.failures import FailurePlan
from repro_torch.models.convert import (
    lm_from_reference,
    lm_to_reference,
    opt_from_reference,
    opt_to_reference,
    param_leaves,
)
from repro_torch.training.optimizer import OptConfig, init_opt, opt_update
from repro_torch.training.steps import make_train_step

_ref_init_lm = jax.jit(RLM.init_lm, static_argnames=("cfg", "tp"))


def _configs(arch, **kw):
    return dataclasses.replace(RR.get_smoke(arch), **kw), dataclasses.replace(TR.get_smoke(arch), **kw)


def _flat(tree) -> dict:
    """{path tuple: numpy} of a nested-dict tree (bfloat16 as its bits)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[tuple(str(getattr(k, "key", k)) for k in path)] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return out


def _f32(a: np.ndarray) -> np.ndarray:
    """float32 values of an array, bfloat16 bits (``uint16``) widened."""
    return (a.astype(np.uint32) << 16).view(np.float32) if a.dtype == np.uint16 else a.astype(np.float32)


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


# -- the optimizer --------------------------------------------------------------


OPT_CASES = [("starcoder2-3b", 2), ("starcoder2-3b", 8), ("deepseek-v3-671b", 3)]


@pytest.mark.parametrize("kind", ["adamw", "adamw_bf16", "adafactor"])
@pytest.mark.parametrize("arch,n_layers", OPT_CASES)
def test_optimizer_matches_the_reference(arch, n_layers, kind):
    """Three steps on the same random gradients (the first clipped): the
    parameters and every state leaf, in the reference's layout. At 8
    layers a stack's norm scale ``[8, D]`` is factored across its layers
    and decayed, as the reference's stacked leaf is; deepseek-v3 carries
    the unstacked MTP block, whose norms are neither."""
    rcfg, tcfg = _configs(arch, n_layers=n_layers, dtype="float32")
    params = jax.tree.map(np.asarray, _ref_init_lm(jax.random.PRNGKey(0), rcfg, 1))
    model = lm_from_reference(params, tcfg, device="cpu")
    cfg = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    ropt, topt = RO.OptConfig(**cfg), OptConfig(**cfg)
    r_state = RO.init_opt(params, ropt)
    t_state = init_opt(param_leaves(model), topt)
    _assert_trees_equal(opt_to_reference(t_state), r_state)  # zeros, the same shapes and types
    r_update = jax.jit(functools.partial(RO.opt_update, cfg=ropt))
    rng = np.random.default_rng(2)
    for step, scale in enumerate((10.0, 0.01, 0.01)):
        grads = jax.tree.map(lambda p: (rng.normal(0, scale, p.shape)).astype(np.float32), params)
        params, r_state, r_stats = r_update(grads, r_state, params)
        t_grads = [torch.from_numpy(g[i] if path[0].startswith("stack_") else g).clone()
                   for path, ps in param_leaves(model)
                   for g in [functools.reduce(lambda t, k: t[k], path, grads)]
                   for i in range(len(ps))]
        t_stats = opt_update(t_grads, t_state, param_leaves(model), topt)
        assert t_state["step"] == int(r_state["step"]) == step + 1
        assert t_stats["lr"] == float(r_stats["lr"])
        assert abs(float(t_stats["grad_norm"]) - float(r_stats["grad_norm"])) <= 1e-6 * float(r_stats["grad_norm"])
        t_params = lm_to_reference(model)
        for got_tree, want_tree in ((t_params, params), (opt_to_reference(t_state)["state"], r_state["state"])):
            got, want = _flat(got_tree), _flat(want_tree)
            assert sorted(got) == sorted(want)
            for path, w in want.items():
                gap = np.abs(_f32(got[path]) - _f32(w))
                if w.dtype == np.uint16:  # adamw_bf16's moments: a bfloat16 rounding apart, carried on
                    assert gap.max() <= 2.0**-7 * np.abs(_f32(w)).max(), (step, path)
                elif kind == "adamw_bf16" and got_tree is t_params:
                    # a moment a rounding apart moves the next update by 2^-7
                    # of itself: lr 2^-5 (measured 2.8e-5 = lr 2^-8.5)
                    assert gap.max() <= cfg["lr"] * 2.0**-5, (step, path)
                else:
                    assert gap.max() <= 1e-6 * max(float(np.abs(w).max()), 1e-30), (step, path)
    if n_layers >= 8 and kind == "adafactor":
        norm = opt_to_reference(t_state)["state"]["stack_main"]["ln1"]
        assert norm["vr"].shape == (n_layers,) and norm["vc"].shape == (tcfg.d_model,)


def _leaves(**tensors):
    return [((name,), [t]) for name, t in sorted(tensors.items())]


@pytest.mark.parametrize("kind", ["adamw", "adamw_bf16", "adafactor"])
def test_optimizer_descends_a_quadratic(kind, rng):
    w = torch.from_numpy(rng.normal(0, 1, (16, 16)).astype(np.float32))
    cfg = OptConfig(kind=kind, lr=0.1, warmup_steps=1, weight_decay=0.0, total_steps=100)
    leaves = _leaves(w=w)
    state = init_opt(leaves, cfg)
    loss0 = float(torch.mean(w**2))
    for _ in range(30):
        opt_update([2 * w / w.numel()], state, leaves, cfg)
    assert float(torch.mean(w**2)) < loss0 * 0.5


def test_adafactor_state_is_factored():
    state = init_opt(_leaves(w=torch.zeros((32, 64))), OptConfig(kind="adafactor"))
    assert state["state"]["w"]["vr"].shape == (32,)
    assert state["state"]["w"]["vc"].shape == (64,)


def test_grad_clip_caps_the_update():
    cfg = OptConfig(lr=1.0, grad_clip=1e-3, warmup_steps=1, weight_decay=0.0)
    w = torch.ones((4, 4))
    leaves = _leaves(w=w)
    stats = opt_update([torch.full((4, 4), 1e6)], init_opt(leaves, cfg), leaves, cfg)
    assert float(stats["grad_norm"]) > 1e3
    assert float((w - 1).abs().max()) < 10.0


def test_optimizer_checks_its_inputs():
    leaves = _leaves(w=torch.ones((4, 4)))
    with pytest.raises(ValueError, match="optimizer"):
        init_opt(leaves, OptConfig(kind="sgd"))
    with pytest.raises(ValueError, match="gradients"):
        opt_update([], init_opt(leaves, OptConfig()), leaves, OptConfig())


# -- corpus and pipeline --------------------------------------------------------


def test_corpus_equals_the_reference():
    spec = dict(n_docs=3000, vocab_size=500, seed=4)
    want, got = RC.SyntheticCorpus(RC.CorpusSpec(**spec)), SyntheticCorpus(CorpusSpec(**spec))
    for name in want.key_cols:
        np.testing.assert_array_equal(got.key_cols[name], want.key_cols[name])
    np.testing.assert_array_equal(got.value_cols["doc_id"], want.value_cols["doc_id"])
    ids = np.array([0, 7, 2999, 7])
    np.testing.assert_array_equal(got.tokens(ids, 33), want.tokens(ids, 33))


@pytest.mark.parametrize("mechanism", ["HR", "TR"])
def test_pipeline_equals_the_reference(mechanism):
    """The same layouts, routed replicas, rows and token batches, draw by
    draw, over the workload's own draws and explicit queries."""
    spec = dict(n_docs=5000, vocab_size=128, seed=3)
    kw = dict(mechanism=mechanism, seed=3, hrca_kwargs={"k_max": 300, "seed": 0})
    want = RP.HRDataPipeline(RC.SyntheticCorpus(RC.CorpusSpec(**spec)), **kw)
    got = HRDataPipeline(SyntheticCorpus(CorpusSpec(**spec)), device="cpu", **kw)
    assert got.layouts() == want.layouts()
    # a (domain, day) no document has: a query that matches nothing, after
    # which the pipeline draws documents uniformly
    keys = want.corpus.key_cols
    taken = set(zip(keys["domain"].tolist(), keys["day"].tolist()))
    dom, day = next((d, t) for d in range(8) for t in range(1024) if (d, t) not in taken)
    r_queries = [RQuery(filters={"domain": REq(3), "quality": RRange(7, 10)}, agg="select"),
                 RQuery(filters={"domain": REq(dom), "day": RRange(day, day + 1)}, agg="select")]
    t_queries = [Query(filters={"domain": Eq(3), "quality": Range(7, 10)}, agg="select"),
                 Query(filters={"domain": Eq(dom), "day": Range(day, day + 1)}, agg="select")]
    for i in range(12):
        rq, tq = (r_queries[i % 2], t_queries[i % 2]) if i >= 8 else (None, None)
        (wb, wr), (gb, gr) = want.sample_batch(4, 16, query=rq), got.sample_batch(4, 16, query=tq)
        assert dataclasses.asdict(gr) == dataclasses.asdict(wr)
        for k in wb:
            assert gb[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(gb[k], wb[k])
    assert (got.total_rows_scanned, got.n_reads) == (want.total_rows_scanned, want.n_reads)


def test_hr_scans_fewer_rows_than_tr():
    corpus = SyntheticCorpus(CorpusSpec(n_docs=30_000, vocab_size=1000))
    wl = curriculum_workload(np.random.default_rng(5), 30)
    hr = HRDataPipeline(corpus, mechanism="HR", workload=wl, seed=1, device="cpu")
    tr = HRDataPipeline(corpus, mechanism="TR", workload=wl, seed=1, device="cpu")
    for q in wl.queries:
        hr.sample_batch(4, 16, query=q)
        tr.sample_batch(4, 16, query=q)
    assert hr.total_rows_scanned < tr.total_rows_scanned


def test_pipeline_batch_shapes_and_determinism():
    corpus = SyntheticCorpus(CorpusSpec(n_docs=5000, vocab_size=128))
    pipe = HRDataPipeline(corpus, seed=3, hrca_kwargs={"k_max": 300, "seed": 0}, device="cpu")
    batch, _ = pipe.sample_batch(4, 32)
    assert batch["tokens"].shape == (4, 32) and batch["labels"].shape == (4, 32)
    assert (batch["tokens"] >= 0).all() and (batch["tokens"] < 128).all()
    np.testing.assert_array_equal(corpus.tokens(np.array([7]), 8), corpus.tokens(np.array([7]), 8))


# -- checkpoints ----------------------------------------------------------------


def _train_state(arch="deepseek-v3-671b", dtype="bfloat16", kind="adafactor"):
    """A reference training state after one update (so that every moment
    is nonzero) and the port's copy of it."""
    rcfg, tcfg = _configs(arch, dtype=dtype)
    params = jax.tree.map(np.asarray, _ref_init_lm(jax.random.PRNGKey(0), rcfg, 1))
    ropt = RO.OptConfig(kind=kind, warmup_steps=1)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(0, 1, p.shape), p.dtype), params)
    params, opt, _ = jax.jit(functools.partial(RO.opt_update, cfg=ropt))(grads, RO.init_opt(params, ropt), params)
    ref = {"params": jax.tree.map(np.asarray, params), "opt": jax.tree.map(np.asarray, opt)}
    model = lm_from_reference(ref["params"], tcfg, device="cpu")
    return ref, model, opt_from_reference(ref["opt"], device="cpu")


def _manifests(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("manifest_"):
            with open(os.path.join(d, name)) as f:
                out[name] = json.load(f)
    return out


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A bfloat16 deepseek-v3 state with adafactor moments: written by each
    package, the two directories hold the same files byte for byte and
    the same replica manifests; each package restores the other's bit for
    bit; the restore router plans alike over both."""
    ref, model, opt_state = _train_state()
    _assert_trees_equal(train_tree(model, opt_state), ref)
    RCM.save_checkpoint(str(tmp_path / "r"), 3, ref, n_chunks=3, replicas=3)
    save_checkpoint(str(tmp_path / "t"), 3, train_tree(model, opt_state), n_chunks=3, replicas=3)
    dr, dt = tmp_path / "r" / "step_00000003", tmp_path / "t" / "step_00000003"
    assert _manifests(dr) == _manifests(dt)
    files = sorted(os.listdir(dr / "data"))
    assert files == sorted(os.listdir(dt / "data"))
    match, mismatch, errors = filecmp.cmpfiles(dr / "data", dt / "data", files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)

    # the port restores the reference's checkpoint into a fresh model and state
    fresh, fresh_opt = _train_state(kind="adafactor")[1:]
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    fresh_opt["step"] = 0
    restored = CheckpointManager(str(tmp_path / "r")).restore_latest(fresh, fresh_opt)
    assert restored == 3
    _assert_trees_equal(train_tree(fresh, fresh_opt), ref)
    # and the reference restores the port's
    step, flat = RCM.restore_checkpoint(str(tmp_path / "t"))
    assert step == 3
    back = RCM.rebuild_tree(ref, flat)
    assert str(back["params"]["embed"].dtype) == "bfloat16"
    _assert_trees_equal(back, ref)

    queries = [({"layer": (0, 2)}, None), ({"stack_id": 0}, None), ({"kind_id": 3}, None),
               ({"layer": (1, 3), "stack_id": 1}, None)]
    r_router, t_router = RCL.CheckpointRouter(str(tmp_path / "r"), 3), CheckpointRouter(str(tmp_path / "t"), 3)
    assert t_router.layouts == r_router.layouts
    for filters, _ in queries:
        rq = RQuery(filters={k: RRange(*v) if isinstance(v, tuple) else REq(v) for k, v in filters.items()})
        tq = Query(filters={k: Range(*v) if isinstance(v, tuple) else Eq(v) for k, v in filters.items()})
        for r_plan, t_plan in ((r_router.plan(rq), t_router.plan(tq)), (r_router.worst_plan(rq),
                                                                         t_router.worst_plan(tq))):
            assert (t_plan.replica, t_plan.layout, t_plan.files_span, t_plan.files_needed) == (
                r_plan.replica, r_plan.layout, r_plan.files_span, r_plan.files_needed)
            np.testing.assert_array_equal(t_plan.file_indices, r_plan.file_indices)


def test_restore_checks_the_layout(tmp_path):
    ref, model, opt_state = _train_state(kind="adamw")
    save_checkpoint(str(tmp_path), 1, train_tree(model, opt_state))
    other = init_opt(param_leaves(model), OptConfig(kind="adafactor"))
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path)).restore_latest(model, other)
    _, flat = restore_checkpoint(str(tmp_path))
    tree = unflatten(flat)
    tree["params"]["final_norm"] = tree["params"]["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        load_train_tree(model, opt_state, tree)


def test_an_async_save_holds_the_state_of_its_step(tmp_path):
    """The host copy is taken before the writer thread starts: a step that
    changes the parameters in place right after does not reach the
    checkpoint."""
    ref, model, opt_state = _train_state(kind="adamw")
    mgr = CheckpointManager(str(tmp_path), every=1, replicas=2)
    assert mgr.maybe_save(1, model, opt_state)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    mgr.wait()
    _, flat = restore_checkpoint(str(tmp_path))
    _assert_trees_equal(unflatten(flat), ref)


def _tree(rng):
    return {
        "params": {
            "stack_main": {"w": rng.normal(0, 1, (8, 16, 4)).astype(np.float32)},
            "embed": rng.normal(0, 1, (32, 4)).astype(np.float32),
        },
        "opt": {"m": rng.normal(0, 1, (8, 16, 4)).astype(np.float32)},
    }


def test_checkpoint_roundtrip(rng, tmp_path):
    tree = _tree(rng)
    save_checkpoint(str(tmp_path), 7, tree, n_chunks=3, replicas=3)
    step, flat = restore_checkpoint(str(tmp_path))
    assert step == 7
    _assert_trees_equal(unflatten(flat), tree)


def test_checkpoint_bf16_roundtrip(rng, tmp_path):
    w = torch.from_numpy(rng.normal(0, 1, (8, 4)).astype(np.float32)).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 1, {"w": w})
    _, flat = restore_checkpoint(str(tmp_path))
    assert flat["w"].dtype == np.uint16
    assert torch.equal(torch.from_numpy(flat["w"].view(np.int16)).view(torch.bfloat16), w)
    with open(tmp_path / "step_00000001" / "manifest_r0.json") as f:
        assert json.load(f)["leaves"][0]["dtype"] == "bfloat16"


def test_checkpoint_leaves_no_tmp(rng, tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree(rng))
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert latest_step(str(tmp_path)) == 3


def test_replica_manifests_same_dataset_different_order(rng, tmp_path):
    save_checkpoint(str(tmp_path), 5, _tree(rng), n_chunks=4, replicas=3)
    orders = [[e["path"] for e in m["leaves"]] for m in _manifests(tmp_path / "step_00000005").values()]
    assert sorted(orders[0]) == sorted(orders[1]) == sorted(orders[2])
    assert any(orders[0] != o for o in orders[1:])
    _, flat0 = restore_checkpoint(str(tmp_path), replica=0)
    _, flat1 = restore_checkpoint(str(tmp_path), replica=1)
    for k in flat0:
        np.testing.assert_array_equal(flat0[k], flat1[k])


def test_router_picks_the_cheaper_replica(rng, tmp_path):
    save_checkpoint(str(tmp_path), 2, _tree(rng), n_chunks=8, replicas=3)
    router = CheckpointRouter(str(tmp_path), 2)
    q = Query(filters={"layer": Range(0, 2)})
    plan, worst = router.plan(q), router.worst_plan(q)
    assert plan.files_needed == worst.files_needed
    assert plan.files_needed <= plan.files_span <= worst.files_span


def test_manager_saves_on_its_steps_and_resumes(tmp_path):
    _, model, opt_state = _train_state(kind="adamw")
    mgr = CheckpointManager(str(tmp_path), every=2, async_save=False, replicas=2)
    assert mgr.maybe_save(2, model, opt_state)
    assert not mgr.maybe_save(3, model, opt_state)
    assert mgr.restore_latest(model, opt_state) == 2


# -- the loop -------------------------------------------------------------------


TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)


def test_failure_recovery_resumes(tmp_path):
    cfg = dataclasses.replace(TR.get_smoke("starcoder2-3b"), **TINY)
    loop = TT.TrainLoopConfig(steps=14, batch_size=2, seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=5,
                              log_every=100, failure_plan=FailurePlan(fail_at_steps=(12,), nodes=(0,)))
    out = TT.run_training(cfg, loop, device="cpu")
    assert out["steps_run"] == 14
    assert len(out["recoveries"]) == 1 and out["recoveries"][0]["step"] == 12
    assert np.isfinite(out["final_loss"])
    # steps 1-11, then the failure at 12 restarts from step 10's checkpoint: 11-14
    assert len(out["losses"]) == 15
    assert latest_step(str(tmp_path)) == 10


def test_resume_from_checkpoint(tmp_path):
    cfg = dataclasses.replace(TR.get_smoke("starcoder2-3b"), **TINY)
    loop = TT.TrainLoopConfig(steps=6, batch_size=2, seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=3,
                              log_every=100)
    first = TT.run_training(cfg, loop, device="cpu")
    out = TT.run_training(cfg, dataclasses.replace(loop, steps=9), resume=True, device="cpu")
    assert out["steps_run"] == 9 and len(out["losses"]) == 3
    assert latest_step(str(tmp_path)) == 9
    assert len(first["step_s"]) == len(first["data_s"]) == len(first["grad_norms"]) == 6


def test_loop_parity_from_the_reference_initial_state(tmp_path):
    """The reference's initial ``{params, opt}``, written as a step-0
    checkpoint and copied: both packages' ``run_training`` resume from it
    and take six float32 steps on the same batches; their losses agree
    within 1e-5 (measured 4.8e-7). Of the states they end in, each
    optimizer leaf agrees within 1e-5 of its own largest magnitude
    (measured 8.4e-7, ``ln2/v``), and each parameter's movement from step
    0 within 1e-3 of its leaf's largest movement (measured 9.7e-5,
    ``attn/wq``; a parameter moves at most lr = 3e-4 a step)."""
    rcfg, tcfg = _configs("starcoder2-3b", dtype="float32", **TINY)
    params = RLM.init_lm(jax.random.PRNGKey(0), rcfg)
    kw = dict(steps=6, batch_size=2, seq_len=16, ckpt_every=6, log_every=100)
    r_loop = RT.TrainLoopConfig(ckpt_dir=str(tmp_path / "r"), **kw)
    t_loop = TT.TrainLoopConfig(ckpt_dir=str(tmp_path / "t"), **kw)
    RCM.save_checkpoint(r_loop.ckpt_dir, 0, {"params": params, "opt": RO.init_opt(params, r_loop.opt)}, replicas=3)
    shutil.copytree(r_loop.ckpt_dir, t_loop.ckpt_dir)
    want, got = RT.run_training(rcfg, r_loop), TT.run_training(tcfg, t_loop, device="cpu")
    assert got["steps_run"] == want["steps_run"] == 6
    assert got["data_layouts"] == want["data_layouts"] and got["avg_rows_scanned"] == want["avg_rows_scanned"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5)
    _, start = RCM.restore_checkpoint(r_loop.ckpt_dir, 0)
    _, r_flat = RCM.restore_checkpoint(r_loop.ckpt_dir, 6)
    _, t_flat = restore_checkpoint(t_loop.ckpt_dir, 6)
    assert sorted(r_flat) == sorted(t_flat)
    for k, w in r_flat.items():
        got, w = t_flat[k].astype(np.float64), w.astype(np.float64)
        if k.startswith("params/"):
            moved = w - start[k]
            gap = np.abs((got - start[k]) - moved).max() / np.abs(moved).max()
            assert np.abs(moved).max() > 0 and gap <= 1e-3, (k, gap)
        else:
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), k


@pytest.mark.parametrize("fault", ["none", "no update", "sign flipped"])
def test_train_agreement_holds_the_step_entry_by_entry(monkeypatch, fault):
    """``train_agreement``, which the card checks run against the CPU, on two
    CPU copies: no gap at all; and when the second copy's optimizer makes
    no update or steps against the gradient, the stepped parameters whose
    gradients stand above the rounding level lie the learning rate or
    twice it apart, far above the 1e-5 those checks allow."""
    import copy

    import repro_torch.training.steps as TS
    from repro_torch.models.lm import init_lm
    from repro_torch.training.steps import TrainSettings

    lr = 1e-2
    cfg = dataclasses.replace(TR.get_smoke("starcoder2-3b"), dtype="float32", **TINY)
    model = init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16))) for k in ("tokens", "labels")}
    settings = TrainSettings(remat="none", q_chunk=8, kv_chunk=8, opt=OptConfig(lr=lr, warmup_steps=1))
    calls, real = [], TS.opt_update

    def second_is_faulty(grads, state, leaves, opt):
        calls.append(1)
        if len(calls) == 2 and fault == "no update":
            opt = dataclasses.replace(opt, lr=0.0)
        if len(calls) == 2 and fault == "sign flipped":
            grads = [-g for g in grads]
        return real(grads, state, leaves, opt)

    monkeypatch.setattr(TS, "opt_update", second_is_faulty)
    diff = TT.train_agreement(model, copy.deepcopy(model), batch, settings)
    assert len(calls) == 2
    assert diff["loss"] == diff["grad_rel"] == diff["step_loss"] == diff["step_grad_norm_rel"] == 0.0, diff
    if fault == "none":
        assert diff["params"] == diff["params_noise"] == 0.0, diff
    else:
        want = lr if fault == "no update" else 2 * lr
        assert 0.9 * want <= diff["params"] <= 1.1 * want, diff


def test_the_loop_runs_on_the_card_unless_told(monkeypatch):
    """With no CUDA device, ``make_train_step`` and ``run_training`` raise
    unless ``device`` names another; a mesh must hold devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(TR.get_smoke("starcoder2-3b"), **TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.run_training(cfg, TT.TrainLoopConfig(steps=1))
    from repro_torch.parallel.sharding import AbstractMesh, make_ctx

    with pytest.raises(ValueError, match="live DeviceMesh"):  # a mesh of names and sizes runs nothing
        TT.run_training(cfg, TT.TrainLoopConfig(steps=1), ctx=make_ctx(AbstractMesh((2, 4), ("data", "model"))),
                        device="cpu")


def test_the_cli_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(["src", os.environ.get("PYTHONPATH", "")]))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)],
        cwd=root, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("done: 2 steps, final loss ")
    assert "jax" not in out.stderr
