"""Elastic scaling: restore a checkpoint onto a different mesh; the
counterpart of ``repro.ft.elastic``.

Checkpoints are mesh-independent (whole leaves reassembled from chunks),
so scaling in or out is: build the new mesh and ctx → compute the specs
from the same logical axes → place the restored tree. The only constraint
is that the sharded dims divide the new axis sizes; ``check_mesh_fits``
says so before anything is placed, from shapes on the ``meta`` device.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import init_lm_shapes, is_stacked, reference_path, tree_get
from repro_torch.parallel.sharding import MeshCtx, is_placed, logical_to_spec, param_specs_for_tree, place

__all__ = ["check_mesh_fits", "reshard_tree"]


def check_mesh_fits(cfg: ArchConfig, ctx: MeshCtx) -> list[str]:
    """Returns the divisibility violations of the parameters (empty =
    fits), in the reference's words and order."""
    problems = []
    tp = ctx.tp_size
    shapes = init_lm_shapes(cfg, tp)
    specs = param_specs_for_tree(ctx, lm.lm_axes(cfg, tp))
    for path in sorted(shapes):
        shape, spec = shapes[path], tree_get(specs, path)
        for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            size = 1
            for a in axes:
                size *= ctx.shape[a]
            if dim % size:
                problems.append(f"dim {dim} not divisible by {size} ({axes})")
    return problems


def reshard_tree(tree, ctx: MeshCtx, axes_tree):
    """Place a tree of whole tensors (nested dicts, each rank holding the
    same values) onto ``ctx``'s mesh by ``axes_tree``, its logical axes;
    the dicts are updated leaf by leaf, in place, and returned. Given an
    ``LM`` it places the model's parameters in place, by the reference's
    paths (a stack layer's tensor takes its stack leaf's axes without the
    ``"layers"`` entry), and returns the model. A tensor already placed so
    is left as it is; one placed otherwise is redistributed. Each rank
    keeps only its shards: a leaf's whole tensor is dropped as soon as it
    is placed, so placing costs one leaf's memory, not the tree's."""
    if isinstance(tree, lm.LM):
        modules = dict(tree.named_modules())
        for name in [n for n, _ in tree.named_parameters()]:
            path = reference_path(name)
            axes = tuple(tree_get(axes_tree, path))
            owner, _, attr = name.rpartition(".")
            p = getattr(modules[owner], attr)
            spec = logical_to_spec(ctx, axes[1:] if is_stacked(path) else axes)
            if not is_placed(p, ctx, spec):
                placed = place(p.detach(), ctx, spec)
                setattr(modules[owner], attr, torch.nn.Parameter(placed, requires_grad=p.requires_grad))
                del placed
            del p
        return tree
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = reshard_tree(tree[k], ctx, axes_tree[k])
        return tree
    return place(tree, ctx, logical_to_spec(ctx, axes_tree))
