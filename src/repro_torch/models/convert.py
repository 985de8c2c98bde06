"""Carry the reference's weights and optimizer state into the port, and
back.

``lm_from_reference`` takes the pytree the reference's ``init_lm`` makes
(nested dicts, every leaf a numpy array; bfloat16 leaves as numpy's
``bfloat16`` extension type) and returns an ``LM`` that computes the same
function. The reference stacks each stack's layer leaves on a leading
axis; the converter slices that axis per layer. Dense weights keep the
reference's ``[d_in, d_out]`` layout, untransposed, as the port's
``dense`` is ``x @ w``; so do ``head`` (``[D, V]`` or ``[CB, D, V]``) and
the embedding ``[V, D]`` (a tied head reads it transposed), the experts
(``[E, d, f]``, ``[E, f, d]``) and the SSD's conv weights ``[K, C]``.
Every leaf keeps its type: norm scales, the router and the SSD's
``A_log``, ``D``, ``dt_bias`` and ``out_norm`` are float32 in the
reference and stay so. The MTP head (an unstacked block) comes across
too.

``lm_to_reference`` is the inverse: the model's weights as the
reference's pytree, each stack's layers stacked on axis 0 again;
``opt_to_reference`` and ``opt_from_reference`` carry the optimizer
state (``repro_torch.training.optimizer``, kept in the reference's layout
already) between tensors and numpy. Without ``ml_dtypes`` the port holds
a bfloat16 array in numpy as its bits, a ``uint16`` array (as the
reference's checkpoints store it); the loaders take those and numpy's
``bfloat16`` alike, bit for bit.

Both directions work at any tensor-parallel degree: the reference's
``init_lm(key, cfg, tp)`` pads heads, experts and the vocabulary for
``tp``, and ``lm_from_reference(..., tp=)`` builds the model padded the
same way. A model whose parameters are DTensors (placed on a mesh) is
read through ``full_tensor()`` (a collective: every rank calls it) and
loaded into shard by shard, each rank keeping its own part of the whole
leaf it reads.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.padding import padded_dims
from .attention import GQA, MLA
from .blocks import MLP, Block, RMSNorm
from .config import ArchConfig
from .lm import LM, MTP, init_lm, stacks_for
from .moe import MoE
from .ssm import SSM

__all__ = [
    "block_from_reference",
    "lm_from_reference",
    "lm_to_reference",
    "load_lm_from_reference",
    "param_leaves",
    "reference_path",
    "init_lm_shapes",
    "full",
    "copy_whole",
    "is_stacked",
    "opt_to_reference",
    "opt_from_reference",
    "to_numpy",
    "nest",
    "tree_get",
]

#: numpy dtype names that hold bfloat16: numpy's extension type and its bits
_BF16_NAMES = ("bfloat16", "uint16")


def _tensor(a, device) -> torch.Tensor:
    """A copy of ``a`` (numpy, or a tensor) on ``device``; a ``uint16`` or
    numpy ``bfloat16`` array becomes bfloat16 with the same bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name in _BF16_NAMES:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def full(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor's ``full_tensor()`` (a collective), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (whole, if a DTensor); bfloat16 as its bits, a
    ``uint16`` array."""
    t = full(t.detach()).to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def nest(flat: dict) -> dict:
    """``{(k1, k2, ...): leaf}`` → nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_get(tree: dict, path: tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def reference_path(name: str) -> tuple[str, ...]:
    """The reference's tree path of the parameter ``name`` (as
    ``named_parameters`` gives it); a stack layer's parameter maps to its
    stack leaf."""
    parts = name.split(".")
    if parts[-1] == "scale":  # an RMSNorm's scale is the reference's leaf itself
        parts = parts[:-1]
    if parts[0] == "stacks":  # stacks.<name>.<layer>.<...>
        return (f"stack_{parts[1]}", *parts[3:])
    return tuple(parts)


def param_leaves(model: LM) -> list[tuple[tuple[str, ...], list[torch.nn.Parameter]]]:
    """The reference's parameter leaves in its tree order (paths sorted, as
    ``jax.tree.leaves`` flattens dicts): (path, tensors). A stack leaf
    (``is_stacked``) holds the layers' tensors in order, which the
    reference stacks on axis 0; any other leaf its one tensor."""
    leaves: dict = {}
    for name, p in model.named_parameters():
        leaves.setdefault(reference_path(name), []).append(p)
    return sorted(leaves.items())


def is_stacked(path: tuple[str, ...]) -> bool:
    """Whether the reference stacks the leaf at ``path`` over layers."""
    return path[0].startswith("stack_")


def lm_to_reference(model: LM) -> dict:
    """The model's weights as the reference's ``init_lm`` pytree of host
    numpy arrays (bfloat16 as ``uint16`` bits)."""
    return nest({
        path: np.stack([to_numpy(p) for p in ps]) if is_stacked(path) else to_numpy(ps[0])
        for path, ps in param_leaves(model)
    })


def copy_whole(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for ``src`` whole; a DTensor ``dst`` takes its own
    shard of ``src`` (no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(dst, DTensor):
        src = distribute_tensor(src, dst.device_mesh, dst.placements, src_data_rank=None)
    dst.copy_(src)


@torch.no_grad()
def load_lm_from_reference(model: LM, params: dict) -> None:
    """Copy the reference's pytree (numpy or CPU tensors) into the model's
    live parameters; every leaf must have the shape and type the model's
    has."""
    for path, ps in param_leaves(model):
        src = _tensor(tree_get(params, path), ps[0].device)
        for p, a in zip(ps, src if is_stacked(path) else [src], strict=True):
            if a.shape != p.shape or a.dtype != p.dtype:
                raise ValueError(f"{'/'.join(path)}: {tuple(a.shape)} {a.dtype}, the model holds "
                                 f"{tuple(p.shape)} {p.dtype}")
            copy_whole(p, a)


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def opt_to_reference(opt_state: dict) -> dict:
    """The optimizer state as the reference's ``{"step": int32 scalar,
    "state": {...}}`` of host numpy arrays."""
    return {"step": np.asarray(opt_state["step"], np.int32), "state": _map(opt_state["state"], to_numpy)}


def opt_from_reference(tree: dict, *, device) -> dict:
    """The reference's optimizer state (numpy or CPU tensors) → the port's
    on ``device``."""
    return {"step": int(np.asarray(tree["step"])), "state": _map(tree["state"], lambda a: _tensor(a, device))}


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _mlp(m: dict, t) -> MLP:
    return MLP(t(m["wi"]), t(m["wo"]), t(m["wg"]) if "wg" in m else None)


def block_from_reference(p: dict, cfg: ArchConfig, kind: str, *, device, tp: int = 1) -> Block:
    """One layer's leaves (the reference's ``init_block`` dict, numpy, made
    at tensor-parallel degree ``tp``) → a ``Block`` of ``kind`` on
    ``device``."""
    t = lambda a: _tensor(a, device)  # noqa: E731
    parts: dict = {}
    if "attn" in p:
        a = p["attn"]
        if cfg.attention == "mla":
            parts["attn"] = MLA(**{name: t(a[name]) for name in MLA.NAMES})
        else:
            parts["attn"] = GQA(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]))
    if "ssm" in p:
        parts["ssm"] = SSM(**{name: t(p["ssm"][name]) for name in SSM.NAMES})
    for name in ("norm_attn", "norm_ssm", "ln2"):
        if name in p:
            parts[name] = RMSNorm(t(p[name]))
    for name in ("mlp", "shared"):
        if name in p:
            parts[name] = _mlp(p[name], t)
    if "moe" in p:
        m = p["moe"]
        parts["moe"] = MoE(t(m["router"]), t(m["wi"]), t(m["wg"]), t(m["wo"]))
    return Block(cfg, padded_dims(cfg, tp), kind, RMSNorm(t(p["ln1"])), **parts)


def lm_from_reference(params: dict, cfg: ArchConfig, *, device, tp: int = 1) -> LM:
    """The reference's ``init_lm(key, cfg, tp)`` pytree (numpy leaves) → an
    ``LM`` on ``device`` holding the same weights, each leaf in its own
    type, padded for ``tp``."""
    stacks = {}
    for spec in stacks_for(cfg):
        stacked = params[f"stack_{spec.name}"]
        stacks[spec.name] = [
            block_from_reference(_layer(stacked, i), cfg, spec.kind, device=device, tp=tp)
            for i in range(spec.n_layers)
        ]
    embed = _tensor(params["embed"], device) if "embed" in params else None
    head = _tensor(params["head"], device) if "head" in params else None
    mtp = None
    if "mtp" in params:
        m = params["mtp"]
        block = block_from_reference(m["block"], cfg, "attn", device=device, tp=tp)
        mtp = MTP(_tensor(m["proj"], device), block, RMSNorm(_tensor(m["norm"], device)))
    model = LM(cfg, embed, stacks, RMSNorm(_tensor(params["final_norm"], device)), head, mtp, tp=tp)
    ref = {path: shape for path, shape in _ref_shapes(params)}
    init = init_lm_shapes(cfg, tp)
    if ref != init:
        bad = sorted(p for p in set(ref) | set(init) if ref.get(p) != init.get(p))
        raise ValueError(f"the tree is not {cfg.name}'s at tp={tp}: {bad[:3]} differ")
    return model


def _ref_shapes(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _ref_shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(np.shape(v))


def init_lm_shapes(cfg: ArchConfig, tp: int) -> dict[tuple[str, ...], tuple[int, ...]]:
    """The reference's leaf shapes of ``init_lm`` at ``tp``: the port's
    model built on the ``meta`` device, each stack leaf stacked."""
    model = init_lm(cfg, generator=None, device="meta", tp=tp)
    return {path: ((len(ps),) if is_stacked(path) else ()) + tuple(ps[0].shape) for path, ps in param_leaves(model)}
