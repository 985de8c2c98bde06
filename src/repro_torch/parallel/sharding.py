"""Mesh context and logical-axis sharding rules of the port, the
counterpart of ``repro.parallel.sharding``.

Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data", "model")``
single-pod. Parallelism map:

  batch (activations)      → (pod, data)           [DP]
  d_model dim of params    → (pod, data)           [FSDP / ZeRO-3]
  heads / d_ff / experts   → model                 [TP / EP]
  vocab (output head)      → model
  embedding table d_model  → model
  KV-cache sequence        → model                 [SP — decode LSE-combine]

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dimension (trailing dimensions may be left out), each ``None``,
a mesh axis name or a tuple of names. Spec math needs only axis names and
sizes: ``AbstractMesh`` carries those, as JAX's ``AbstractMesh`` does, so
the specs of a ``(16, 16)`` or ``(2, 16, 16)`` mesh compute in one
process. Placing tensors (``placements``, ``place``) needs a live
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the axis names. A tensor dimension sharded over two mesh axes, such as
``("pod", "data")``, becomes ``Shard(d)`` on both mesh dimensions, major
to minor, as JAX orders them; so the axes of such an entry must come in
the mesh's order.

``MeshCtx`` is threaded through the model code; ``None`` means one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

__all__ = [
    "AbstractMesh",
    "MeshCtx",
    "make_ctx",
    "logical_to_spec",
    "param_specs_for_tree",
    "is_axes_leaf",
    "map_axes",
    "is_placed",
    "mesh_axes",
    "place",
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, no devices: enough for every spec."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for the axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axes(mesh) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """(axis names, axis sizes) of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names, mesh.axis_sizes
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the DeviceMesh needs mesh_dim_names")
    return tuple(names), tuple(mesh.shape)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: object  # AbstractMesh, or a DeviceMesh with mesh_dim_names
    dp_axes: tuple[str, ...]  # ("pod","data") or ("data",)
    tp_axis: str  # "model"
    shard_batch: bool = True  # False for global_batch < dp_size (long_500k)
    serve_ep: bool = False  # serving: global expert-parallel MoE dispatch
    fsdp_all: bool = False  # train: pure FSDP over every mesh axis (no TP)
    fsdp_axes_override: tuple | None = None  # fsdp_all: narrower weight shard

    @property
    def axis_names(self) -> tuple[str, ...]:
        return mesh_axes(self.mesh)[0]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(*mesh_axes(self.mesh)))

    @property
    def size(self) -> int:
        return math.prod(mesh_axes(self.mesh)[1])

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.shape[self.tp_axis]

    @property
    def live(self) -> bool:
        """Whether the mesh holds devices (a ``DeviceMesh``)."""
        return not isinstance(self.mesh, AbstractMesh)

    def placements(self, spec: Sequence) -> tuple:
        """The DTensor placements of ``spec`` (the counterpart of the
        reference's ``sharding(*spec)``), one per mesh axis: ``Shard(d)``
        where tensor dimension ``d`` names the axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        names = self.axis_names
        owner: dict[str, int] = {}
        for d, entry in enumerate(spec):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"spec {spec}: the axes {axes} are not in the mesh's order {names}")
            for a in axes:
                if a in owner:
                    raise ValueError(f"spec {spec} shards two dimensions over {a!r}")
                owner[a] = d
        return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


def make_ctx(mesh, *, shard_batch: bool = True) -> MeshCtx:
    names = mesh_axes(mesh)[0]
    if "model" not in names:
        raise ValueError(f"mesh must have a 'model' axis, got {names}")
    dp = tuple(a for a in names if a != "model")
    return MeshCtx(mesh=mesh, dp_axes=dp, tp_axis="model", shard_batch=shard_batch)


#: logical axis name → mesh axes (None = replicated). The FSDP entry is
#: filled per-mesh because the pod axis may be absent.
_LOGICAL_RULES = {
    "batch": "__dp__",
    "fsdp": "__dp__",  # d_model dim of transformer params
    "model_dim": None,  # activations' d_model — replicated
    "seq": None,  # train/prefill activations sequence
    "kv_seq": "model",  # decode KV cache sequence (SP)
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "experts_serve": "__ep_serve__",  # (data, model) when it divides, else model
    "vocab": "model",
    "embed_tp": "model",  # embedding table d_model
    "expert_mlp": "__dp__",  # MoE expert d_ff — FSDP'd, gathered in-layer
    "layers": None,
    "layers_pp": "pod",  # pipeline stage axis
    "stats": None,
}


def logical_to_spec(ctx: MeshCtx | None, axes: Sequence[str | None]) -> tuple:
    """Map logical axis names to a spec under ``ctx``: the reference's
    ``PartitionSpec`` as a tuple, entry by entry (``()`` without a mesh)."""
    if ctx is None:
        return ()
    out = []
    all_axes = ctx.axis_names
    for ax in axes:
        if ax is None:
            out.append(None)
            continue
        if ax == "batch" and not ctx.shard_batch:
            out.append(None)
            continue
        if ctx.fsdp_all:
            # pure-FSDP placement: batch and the param d_model dim cover
            # the whole mesh; every TP-ish axis is replicated
            if ax == "batch":
                out.append(all_axes)
                continue
            if ax == "fsdp":
                out.append(ctx.fsdp_axes_override or all_axes)
                continue
            if ax in ("heads", "kv_heads", "mlp", "vocab", "embed_tp",
                      "experts", "expert_mlp", "kv_seq"):
                out.append(None)
                continue
        rule = _LOGICAL_RULES.get(ax, None)
        if rule == "__dp__":
            out.append(ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0])
        elif rule == "__ep_serve__":
            out.append(("data", ctx.tp_axis))
        else:
            out.append(rule)
    # as PartitionSpec keeps them: a one-axis tuple is the axis itself
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in out)


def is_axes_leaf(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and Nones."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def map_axes(fn, tree, *rest):
    """``fn`` over the axes leaves of nested dicts (and of ``rest``, trees of
    the same structure), keeping the structure."""
    if is_axes_leaf(tree):
        return fn(tree, *rest)
    return {k: map_axes(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def param_specs_for_tree(ctx: MeshCtx | None, logical_tree) -> object:
    """Map a tree of logical-axis tuples to specs."""
    return map_axes(lambda axes: logical_to_spec(ctx, axes), logical_tree)


def is_placed(t: torch.Tensor, ctx: MeshCtx, spec: Sequence) -> bool:
    """Whether ``t`` is a DTensor on ``ctx``'s mesh placed by ``spec`` (an
    ``nn.Parameter`` of one included)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor) and t.device_mesh == ctx.mesh and tuple(t.placements) == ctx.placements(spec)


def place(t: torch.Tensor, ctx: MeshCtx, spec: Sequence):
    """``t`` placed by ``spec``: a DTensor placed so as it is, one placed
    otherwise redistributed; a plain tensor, the whole tensor held alike by
    every rank, distributed with no collective (each rank keeps its own
    shard)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if is_placed(t, ctx, spec):
        return t
    if isinstance(t, DTensor):
        return t.redistribute(ctx.mesh, ctx.placements(spec))
    return distribute_tensor(t, ctx.mesh, ctx.placements(spec), src_data_rank=None)
