"""Carry the reference's weights into the port.

``lm_from_reference`` takes the pytree the reference's ``init_lm`` makes
(nested dicts, every leaf a numpy array; bfloat16 leaves as numpy's
``bfloat16`` extension type) and returns an ``LM`` that computes the same
function. The reference stacks each stack's layer leaves on a leading
axis; the converter slices that axis per layer. Dense weights keep the
reference's ``[d_in, d_out]`` layout, untransposed, as the port's
``dense`` is ``x @ w``; so do ``head`` (``[D, V]`` or ``[CB, D, V]``) and
the embedding ``[V, D]`` (a tied head reads it transposed). Norm scales
stay float32; every other leaf keeps its type.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.padding import padded_dims
from .attention import GQA
from .blocks import MLP, Block, RMSNorm
from .config import ArchConfig
from .lm import LM, require_in_slice, stacks_for, torch_dtype

__all__ = ["lm_from_reference"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch_dtype(a.dtype.name)
    # torch reads no numpy bfloat16: widen it exactly to float32 and narrow
    # it back; torch.tensor copies, so the model owns its weights
    host = a.astype(np.float32) if dtype == torch.bfloat16 else a
    return torch.tensor(host, device=device).to(dtype)


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _block(p: dict, cfg: ArchConfig, device) -> Block:
    t = lambda a: _tensor(a, device)
    pd = padded_dims(cfg, 1)
    a = p["attn"]
    attn = GQA(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]))
    if "mlp" not in p:
        return Block(cfg, pd, RMSNorm(t(p["ln1"])), attn)
    m = p["mlp"]
    mlp = MLP(t(m["wi"]), t(m["wo"]), t(m["wg"]) if "wg" in m else None)
    return Block(cfg, pd, RMSNorm(t(p["ln1"])), attn, RMSNorm(t(p["ln2"])), mlp)


def lm_from_reference(params: dict, cfg: ArchConfig, *, device) -> LM:
    """The reference's ``init_lm`` pytree (numpy leaves) → an ``LM`` on
    ``device`` holding the same weights."""
    require_in_slice(cfg)
    stacks = {}
    for spec in stacks_for(cfg):
        stacked = params[f"stack_{spec.name}"]
        stacks[spec.name] = [_block(_layer(stacked, i), cfg, device) for i in range(spec.n_layers)]
    embed = _tensor(params["embed"], device) if "embed" in params else None
    head = _tensor(params["head"], device) if "head" in params else None
    return LM(cfg, embed, stacks, RMSNorm(_tensor(params["final_norm"], device)), head)
