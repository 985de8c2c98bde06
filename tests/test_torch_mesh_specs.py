"""The port's mesh placements against the reference's, with no process
group: specs need only axis names and sizes, so both packages compute
them on abstract meshes (``jax.sharding.AbstractMesh`` and the port's
``parallel.sharding.AbstractMesh``) for all ten configs at full width.

Held equal, entry by entry: parameter shapes at tp 1, 4 and 16 (the
port's model on the ``meta`` device, the reference's ``jax.eval_shape``
of ``init_lm``); the parameter specs for training and for serving (with
and without global EP); the cache specs; the batch and token specs; the
optimizer-state specs of the three optimizers; the specs with
``shard_batch=False`` and with ``fsdp_all`` (with and without the
override); ``check_mesh_fits`` (also on meshes that do not fit);
``ep_over_data_ok``; and the input stand-ins of ``launch.input_specs``.
``lm_from_reference`` at tp 4 round-trips the reference's weights bit
for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.ft import elastic as RE
from repro.launch import input_specs as RI
from repro.launch import mesh as RMESH
from repro.models import lm as RL
from repro.models import moe as RM
from repro.parallel import sharding as RS
from repro.serving import steps as RV
from repro.training import optimizer as RO
from repro.training import steps as RT
from repro_torch.configs import registry as TR
from repro_torch.ft import elastic as TE
from repro_torch.launch import input_specs as TI
from repro_torch.launch.mesh import make_mesh_shape, make_production_mesh
from repro_torch.models import convert
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.parallel import sharding as TS
from repro_torch.serving import steps as TV
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TT

MESHES = [((2, 4), ("data", "model")), make_mesh_shape(), make_mesh_shape(multi_pod=True)]
OPTS = ("adamw", "adamw_bf16", "adafactor")


def _ctxs(shape, names):
    return (RS.make_ctx(jax.sharding.AbstractMesh(shape, names)),
            TS.make_ctx(TS.AbstractMesh(shape, names)))


def _specs(tree):
    """The reference's tree of PartitionSpecs as the port's tuples."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


def _variants(rctx, tctx, cfg):
    """(name, reference ctx, port ctx) of the placements a train or serve
    step can take on this mesh."""
    override = tuple(a for a in tctx.axis_names if a != "model")
    out = [("plain", rctx, tctx),
           ("no_batch_shard", dataclasses.replace(rctx, shard_batch=False),
            dataclasses.replace(tctx, shard_batch=False))]
    for o in (None, override):
        out.append((f"fsdp_all_{o}", dataclasses.replace(rctx, fsdp_all=True, fsdp_axes_override=o),
                    dataclasses.replace(tctx, fsdp_all=True, fsdp_axes_override=o)))
    return out


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_parameter_shapes_at_every_tp(arch):
    cfg = RR.get_arch(arch)
    for tp in (1, 4, 16):
        ref = jax.eval_shape(lambda: RL.init_lm(jax.random.PRNGKey(0), cfg, tp))
        flat = {tuple(k.key for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert convert.init_lm_shapes(TR.get_arch(arch), tp) == flat, (arch, tp)


@pytest.mark.parametrize("arch", RR.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_specs_match_the_reference(arch, mesh):
    rcfg, tcfg = RR.get_arch(arch), TR.get_arch(arch)
    rctx0, tctx0 = _ctxs(*mesh)
    tp = tctx0.tp_size
    p_shape = jax.eval_shape(lambda: RL.init_lm(jax.random.PRNGKey(0), rcfg, tp))
    t_params, _ = TT.train_state_shapes(tcfg, TT.TrainSettings(), tp)
    for name, rctx, tctx in _variants(rctx0, tctx0, rcfg):
        where = (arch, mesh, name)
        for serve in (False, True):
            for epd in (False, True):
                r = RS.param_specs_for_tree(rctx, RL.lm_axes(rcfg, tp, serve=serve, ep_over_data=epd))
                t = TS.param_specs_for_tree(tctx, TL.lm_axes(tcfg, tp, serve=serve, ep_over_data=epd))
                assert t == _specs(r), (*where, serve, epd)
        assert TL.cache_axes(tcfg, 8, 64, tp) == RL.cache_axes(rcfg, 8, 64, tp), where
        assert TV.cache_shardings(tcfg, tctx, 8, 64) == _specs(RV.cache_shardings(rcfg, rctx, 8, 64)), where
        assert TT.batch_specs(tcfg, tctx) == _specs(RT.batch_specs(rcfg, rctx)), where
        assert TV.token_specs(tcfg, tctx) == _specs(RV.token_specs(rcfg, rctx)), where
        for kind in OPTS:
            r_axes = RO.opt_state_axes(RL.lm_axes(rcfg, tp), RO.OptConfig(kind=kind), p_shape)
            t_axes = TO.opt_state_axes(TL.lm_axes(tcfg, tp), TO.OptConfig(kind=kind), t_params)
            assert t_axes == r_axes, (*where, kind)
            assert TS.param_specs_for_tree(tctx, t_axes) == _specs(RS.param_specs_for_tree(rctx, r_axes)), (*where, kind)
    for serve_sharding in TV.SERVE_SHARDINGS:
        rc, ra = RV.serve_ctx_and_axes(rcfg, rctx0, serve_sharding)
        tc, ta = TV.serve_ctx_and_axes(tcfg, tctx0, serve_sharding)
        assert (tc.serve_ep, ta) == (rc.serve_ep, ra), (arch, mesh, serve_sharding)
    assert TM.ep_over_data_ok(tcfg, tctx0) == RM.ep_over_data_ok(rcfg, rctx0), (arch, mesh)


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_check_mesh_fits_matches_the_reference(arch):
    rcfg, tcfg = RR.get_arch(arch), TR.get_arch(arch)
    misfits = {}
    for shape, names in MESHES + [((3, 5), ("data", "model")), ((7, 2), ("data", "model"))]:
        rctx, tctx = _ctxs(shape, names)
        got = TE.check_mesh_fits(tcfg, tctx)
        assert got == RE.check_mesh_fits(rcfg, rctx), (arch, shape)
        misfits[shape] = got
    for shape, names in MESHES:
        assert misfits[shape] == [], (arch, shape)
    # measured on the reference: only mamba2 fits (3, 5), only yi-34b fits (7, 2)
    assert bool(misfits[(3, 5)]) == (arch != "mamba2-780m"), misfits[(3, 5)]
    assert bool(misfits[(7, 2)]) == (arch != "yi-34b"), misfits[(7, 2)]


def _dtype(d) -> str:
    return str(np.dtype(d)) if not isinstance(d, torch.dtype) else str(d).removeprefix("torch.")


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_input_specs_match_the_reference(arch):
    rcfg, tcfg = RR.get_arch(arch), TR.get_arch(arch)

    def same(t, r, where):
        assert t.device.type == "meta", where
        assert (tuple(t.shape), _dtype(t.dtype)) == (tuple(r.shape), _dtype(r.dtype)), where

    for shape in ("train_4k", "decode_32k"):
        for k, r in RI.train_batch_specs(rcfg, RR.SHAPES[shape]).items():
            same(TI.train_batch_specs(tcfg, TR.SHAPES[shape])[k], r, (arch, shape, k))
        for k, r in RI.prefill_batch_specs(rcfg, RR.SHAPES[shape]).items():
            same(TI.prefill_batch_specs(tcfg, TR.SHAPES[shape])[k], r, (arch, shape, k))
    for tp in (1, 16):
        r_cache, r_bt, r_pos = RI.decode_input_specs(rcfg, RR.SHAPES["decode_32k"], tp)
        t_cache, t_bt, t_pos = TI.decode_input_specs(tcfg, TR.SHAPES["decode_32k"], tp)
        assert t_cache.keys() == r_cache.keys()
        for k in r_cache:
            same(t_cache[k], r_cache[k], (arch, tp, k))
        for k in r_bt:
            same(t_bt[k], r_bt[k], (arch, tp, k))
        same(t_pos, r_pos, (arch, tp, "pos"))


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_weights_at_tp4_round_trip_bit_for_bit(arch):
    cfg = RR.get_smoke(arch)
    ref = jax.tree.map(np.asarray, jax.jit(RL.init_lm, static_argnums=(1, 2))(jax.random.PRNGKey(3), cfg, 4))
    model = convert.lm_from_reference(ref, TR.get_smoke(arch), device="cpu", tp=4)
    assert model.tp == 4 and model.pd.n_heads == TL.padded_dims(TR.get_smoke(arch), 4).n_heads
    back = convert.lm_to_reference(model)
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_r.keys() == flat_b.keys()
    for k, r in flat_r.items():
        b = flat_b[k]
        bits = r.view(np.uint16) if r.dtype.name == "bfloat16" else r
        assert b.dtype == bits.dtype and np.array_equal(b, bits), k
    tcfg = TR.get_smoke(arch)
    assert convert.init_lm_shapes(tcfg, 16) != convert.init_lm_shapes(tcfg, 4)
    with pytest.raises(ValueError, match="tp=16"):  # another padding: refused
        convert.lm_from_reference(ref, tcfg, device="cpu", tp=16)


def test_production_meshes_and_placements():
    """The production shapes are the reference's; without a process group
    of that many ranks the production mesh raises, as the reference's does
    without the devices; a dimension sharded over two mesh axes is
    ``Shard`` on both, major to minor, and a spec naming its axes out of
    the mesh's order, or one axis twice, is refused."""
    from torch.distributed.tensor import Replicate, Shard

    for multi_pod in (False, True):
        assert make_mesh_shape(multi_pod=multi_pod) == RMESH.make_mesh_shape(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    ctx = TS.make_ctx(TS.AbstractMesh(*make_mesh_shape(multi_pod=True)))
    assert (ctx.dp_axes, ctx.dp_size, ctx.tp_size) == (("pod", "data"), 32, 16)
    assert ctx.placements((("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert ctx.placements((None, "model")) == (Replicate(), Replicate(), Shard(1))
    assert ctx.placements(()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        ctx.placements((("data", "pod"),))
    with pytest.raises(ValueError, match="two dimensions"):
        ctx.placements(("model", "model"))
