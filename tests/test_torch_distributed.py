"""The port's serving path on a (2, 4) ("data", "model") mesh of 8 gloo
ranks on the CPU, against one device and against the reference's own
sharded decode: the counterpart of the reference's
``tests/test_distributed.py`` serving cases, at its bounds.

The file's cases run in turn on one launch of 8 rank processes
(``run_cases``: ``launch.mesh.run_local_ranks``, a ``FileStore`` in a
temporary directory, process groups with a 120 s timeout, one thread a
rank), since a launch costs ~8 s of imports and rendezvous; rank 0
prints each case's measurements on a ``RESULT`` line, which its test
holds to the bounds. The measured gaps stand beside each bound.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch.mesh import run_local_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

PRELUDE = """
import dataclasses, json, os, traceback
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_local_group
rank = int(os.environ["RANK"])
BACKEND = os.environ["REPRO_BACKEND"]
DEV = f"cuda:{rank}" if BACKEND == "nccl" else "cpu"
if BACKEND == "nccl":
    torch.cuda.set_device(rank)
init_local_group(rank, int(os.environ["WORLD_SIZE"]), os.environ["REPRO_STORE"], BACKEND)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.registry import get_smoke
from repro_torch.models import lm
from repro_torch.parallel.sharding import make_ctx
from repro_torch.serving.steps import make_decode_step, make_prefill_step
mesh = init_device_mesh(DEV.split(":")[0], tuple(json.loads(os.environ["REPRO_MESH"])),
                        mesh_dim_names=("data", "model"))
ctx = make_ctx(mesh)
CASE = None

def report(**kw):
    if rank == 0:
        print("RESULT " + json.dumps(dict(kw, case=CASE)), flush=True)

def rel(ref, got):
    ref, got = ref.float(), got.float()
    return float(((ref - got).abs() / (ref.abs() + 1e-2)).max())
"""


def run_cases(cases: dict[str, str], setup: str = "", *, shape=(2, 4), backend: str = "gloo") -> dict[str, dict]:
    """Run each case's body in turn on the same ranks of a ("data",
    "model") mesh of ``shape`` (gloo on the CPU; "nccl", one card a rank,
    on the cards), after ``PRELUDE`` and ``setup``, each from
    ``np.random.default_rng(0)``; every rank must exit 0. Returns rank 0's
    ``RESULT`` of each case, or ``{"error": its traceback}`` for a case
    that raised there."""
    code = PRELUDE + setup
    for name, body in cases.items():
        code += (f"\nCASE = {name!r}\nrng = np.random.default_rng(0)\ndef _case():\n"
                 + textwrap.indent(textwrap.dedent(body), "    ")
                 + "\ntry:\n    _case()\nexcept Exception:\n    report(error=traceback.format_exc())\n")
    code += "\ntorch.distributed.destroy_process_group()\n"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_BACKEND=backend, REPRO_MESH=json.dumps(shape))
    outs = run_local_ranks(code, shape[0] * shape[1], timeout=TIMEOUT, cwd=ROOT, env=env)
    for rank, out in enumerate(outs):
        assert out.returncode == 0, f"rank {rank} exited {out.returncode}:\n{out.stderr[-4000:]}"
    got = [json.loads(ln[len("RESULT "):]) for ln in outs[0].stdout.splitlines() if ln.startswith("RESULT ")]
    return {r.pop("case"): r for r in got}


def result(results: dict, case: str) -> dict:
    """One case's ``RESULT``; a case that raised fails its test with the
    rank's traceback."""
    got = results.get(case, {"error": "no RESULT line"})
    assert "error" not in got, got.get("error")
    return got


DECODE = """
def decode_logits(model, cfg, batch, ctx, serve_sharding="fsdp"):
    S = batch["tokens"].shape[1]
    pre = {k: v[:, : S - 1] for k, v in batch.items()}
    last = {k: v[:, S - 1 :] for k, v in batch.items()}
    prefill = make_prefill_step(cfg, ctx, s_alloc=20, q_chunk=4, kv_chunk=4, serve_sharding=serve_sharding,
                                device=DEV)
    _, cache = prefill(model, pre)
    logits, _ = make_decode_step(cfg, ctx, serve_sharding=serve_sharding, device=DEV)(model, cache, last, S - 1)
    return logits.full_tensor() if ctx is not None else logits
"""

ARCHS = ("starcoder2-3b", "deepseek-v3-671b", "hymba-1.5b")

SHARDED_DECODE = """
errs = {}
for arch in %r:
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", capacity_factor=64.0)
    model = lm.init_lm(cfg, generator=torch.Generator(DEV).manual_seed(0), device=DEV, tp=ctx.tp_size)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 17)), device=DEV)}
    ref = decode_logits(model, cfg, batch, None)
    errs[arch] = rel(ref, decode_logits(model, cfg, batch, ctx))
report(**errs)
""" % (ARCHS,)

SERVE_EP = """
from repro_torch.models.moe import ep_over_data_ok
cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32", capacity_factor=64.0)
assert ep_over_data_ok(cfg, ctx)
B, S_alloc = 4, 8
tok = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)), device=DEV)}
outs = {}
for mode in (None, "fsdp", "tp"):
    model = lm.init_lm(cfg, generator=torch.Generator(DEV).manual_seed(0), device=DEV, tp=ctx.tp_size)
    cache = lm.init_cache(cfg, B, S_alloc, device=DEV, tp=ctx.tp_size)
    step = make_decode_step(cfg, None if mode is None else ctx, serve_sharding=mode or "fsdp", device=DEV)
    logits, _ = step(model, cache, tok, 0)
    outs[mode] = logits if mode is None else logits.full_tensor()
# the inference placement holds one expert a rank, over data and model
from torch.distributed.tensor import Shard
assert model.stacks["moe"][0].moe.wi.placements == (Shard(0), Shard(0))
report(tp_vs_fsdp=rel(outs["fsdp"], outs["tp"]), fsdp_vs_one=rel(outs[None], outs["fsdp"]))
"""

REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np, dataclasses
from repro.configs import get_smoke
from repro.parallel.sharding import make_ctx
from repro.models import lm
mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices(),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
ctx = make_ctx(mesh)
rng = np.random.default_rng(0)
out = {}
for arch in %r:
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", capacity_factor=64.0)
    params = lm.init_lm(jax.random.PRNGKey(0), cfg, tp=ctx.tp_size)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 17)), jnp.int32)
    pre, last = {"tokens": toks[:, :16]}, {"tokens": toks[:, 16:]}
    with jax.set_mesh(mesh):
        _, cache = lm.prefill(params, pre, cfg, ctx, s_alloc=20, q_chunk=4, kv_chunk=4)
        logits, _ = lm.decode_step(params, cache, last, jnp.int32(16), cfg, ctx)
    out[arch + "|tokens"] = np.asarray(toks)
    out[arch + "|logits"] = np.asarray(logits, np.float32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[arch + "|" + "/".join(k.key for k in path)] = np.asarray(leaf)
# the MoE training loss and its gradients on the mesh; the loss and the
# load-balance statistic as each device holds them, by mesh coordinate
cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32", capacity_factor=64.0)
params = lm.init_lm(jax.random.PRNGKey(0), cfg, tp=ctx.tp_size)
toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (8, 17)), jnp.int32)
batch = {"tokens": toks[:, :16], "labels": toks[:, 1:]}
with jax.set_mesh(mesh):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: lm.forward_train(p, batch, cfg, ctx, remat="none", q_chunk=8, kv_chunk=8), has_aux=True))(params)
where = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
for name, v in (("loss", loss), ("aux", metrics["aux"])):
    held = np.zeros(mesh.devices.shape, np.float32)
    for shard in v.addressable_shards:
        held[where[shard.device.id]] = np.asarray(shard.data)
    out["moe_train|" + name] = held
out["moe_train|tokens"] = np.asarray(toks)
for kind, tree in (("param", params), ("grad", grads)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["moe_train|" + kind + "/" + "/".join(k.key for k in path)] = np.asarray(leaf, np.float32)
np.savez(sys.argv[1], **out)
"""

FROM_REFERENCE = """
from repro_torch.models.convert import lm_from_reference, nest
saved = np.load(%r)
errs = {}
for arch in %r:
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", capacity_factor=64.0)
    leaves = {tuple(k.split("|")[1].split("/")): saved[k] for k in saved.files
              if k.startswith(arch + "|") and k.split("|")[1] not in ("tokens", "logits")}
    model = lm_from_reference(nest(leaves), cfg, device="cpu", tp=ctx.tp_size)
    batch = {"tokens": torch.as_tensor(saved[arch + "|tokens"]).long()}
    errs[arch] = rel(torch.as_tensor(saved[arch + "|logits"]), decode_logits(model, cfg, batch, ctx))
report(**errs)
"""


MOE_TRAIN = """
from repro_torch.models.convert import full, is_stacked, lm_from_reference, nest, param_leaves
from repro_torch.parallel.sharding import place
from repro_torch.training.steps import TrainSettings, batch_specs, loss_and_grads, place_train_state
saved = np.load(%r)

def leaves(kind):
    pre = "moe_train|" + kind + "/"
    return {tuple(k[len(pre):].split("/")): saved[k] for k in saved.files if k.startswith(pre)}

cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32", capacity_factor=64.0)
toks = torch.as_tensor(saved["moe_train|tokens"]).long()
batch = {"tokens": toks[:, :16], "labels": toks[:, 1:]}
settings = TrainSettings(remat="none", q_chunk=8, kv_chunk=8)
ref_g = leaves("grad")
g_max = max(float(np.abs(g).max()) for g in ref_g.values())
gaps, held = {}, {}
for where in ("one", "mesh"):
    model = lm_from_reference(nest(leaves("param")), cfg, device="cpu", tp=ctx.tp_size)
    c, on = None, batch
    if where == "mesh":
        c = ctx
        place_train_state(cfg, ctx, settings, model)
        on = {k: place(v, ctx, batch_specs(cfg, ctx)[k]) for k, v in batch.items()}
    loss, metrics, grads = loss_and_grads(model, on, settings, c)
    it, gap = iter(grads), 0.0
    for path, ps in param_leaves(model):
        g = torch.stack([full(next(it)) for _ in ps]) if is_stacked(path) else full(next(it))
        gap = max(gap, float(np.abs(g.numpy() - ref_g[path]).max()))
    gaps[where] = gap / g_max
    mine = torch.tensor([float(loss), float(metrics["aux"])])
    every = [torch.zeros(2) for _ in range(8)]
    torch.distributed.all_gather(every, mine)
    held[where] = torch.stack(every).numpy().reshape(2, 4, 2)
rel_held = {name: float(np.abs(held["mesh"][..., i] - saved["moe_train|" + name]).max()
                        / np.abs(saved["moe_train|" + name]).max()) for i, name in enumerate(("loss", "aux"))}
report(grad_rel=gaps["mesh"], one_device_grad_rel=gaps["one"], **rel_held,
       aux_by_data_row=[float(a) for a in saved["moe_train|aux"][:, 0]])
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case of the file on one launch of 8 ranks; first the
    reference's (2, 4) sharded decode of the three archs on 8 forced host
    devices, as its ``tests/test_distributed.py`` runs it, and its (2, 4)
    MoE training loss and gradients, saved with their weights and
    tokens."""
    path = tmp_path_factory.mktemp("reference") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", REFERENCE % (ARCHS,), str(path)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return run_cases({"sharded_decode": SHARDED_DECODE, "serve_ep": SERVE_EP,
                      "reference": FROM_REFERENCE % (str(path), ARCHS), "moe_train": MOE_TRAIN % str(path)}, DECODE)


def test_sharded_decode_matches_one_device(results):
    """The reference's ``test_sharded_decode_matches_single_device``: prefill
    16 tokens, decode the 17th; the sequence-sharded cache (5 slots a model
    rank) against one device, rel 1e-3 (measured: starcoder2 2.1e-5,
    deepseek-v3 1.4e-4, hymba 6.6e-5)."""
    got = result(results, "sharded_decode")
    assert set(got) == set(ARCHS)
    for arch, err in got.items():
        assert err < 1e-3, (arch, err)


def test_serve_ep_matches_fsdp_placement(results):
    """The reference's ``test_serve_ep_matches_fsdp_placement``: qwen2-moe's
    decode with the inference placement (global EP: 8 experts over data ×
    model, one a rank) against the training placement, rel 1e-3 (measured
    0: each token's two expert outputs add in either order exactly), and
    the training placement against one device (measured 7.8e-5)."""
    got = result(results, "serve_ep")
    assert got["tp_vs_fsdp"] < 1e-3, got
    assert got["fsdp_vs_one"] < 1e-3, got


def test_sharded_decode_matches_the_reference(results):
    """The reference's (2, 4) sharded decode of the three archs (the
    fixture's) against the port's 8 ranks on the same weights
    (``lm_from_reference(tp=4)``) and tokens, rel 1e-3 (measured:
    starcoder2 1.6e-5, deepseek-v3 6.2e-5, hymba 3.5e-5)."""
    got = result(results, "reference")
    assert set(got) == set(ARCHS)
    for arch, err in got.items():
        assert err < 1e-3, (arch, err)


def test_moe_train_statistic_matches_the_reference(results):
    """The reference's (2, 4) training loss and gradients of qwen2-moe
    (float32, 8 × 16 tokens, no drops) against the port's 8 ranks on the
    same weights and tokens. The load-balance statistic is each data
    shard's own on its ranks (the two data rows hold different values) and
    its gradient that of their mean: the port's gradients within 1e-5 of
    the largest (measured 9.9e-7), every rank's loss and statistic
    within 1e-5 relative of the same mesh coordinate's in the reference
    (measured 0 and 0). One device's gradients,
    with the statistic of the whole batch, lie further off than 1e-4
    (measured 5.2e-4)."""
    got = result(results, "moe_train")
    assert got["aux_by_data_row"][0] != got["aux_by_data_row"][1], got
    assert got["grad_rel"] <= 1e-5, got
    assert got["loss"] <= 1e-5 and got["aux"] <= 1e-5, got
    assert got["one_device_grad_rel"] > 1e-4, got
