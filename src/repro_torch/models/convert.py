"""Carry the reference's weights into the port.

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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.padding import padded_dims
from .attention import GQA, MLA
from .blocks import MLP, Block, RMSNorm
from .config import ArchConfig
from .lm import LM, MTP, stacks_for, torch_dtype
from .moe import MoE
from .ssm import SSM

__all__ = ["block_from_reference", "lm_from_reference"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch_dtype(a.dtype.name)
    # torch reads no numpy bfloat16: widen it exactly to float32 and narrow
    # it back; torch.tensor copies, so the model owns its weights
    host = a.astype(np.float32) if dtype == torch.bfloat16 else a
    return torch.tensor(host, device=device).to(dtype)


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _mlp(m: dict, t) -> MLP:
    return MLP(t(m["wi"]), t(m["wo"]), t(m["wg"]) if "wg" in m else None)


def block_from_reference(p: dict, cfg: ArchConfig, kind: str, *, device) -> Block:
    """One layer's leaves (the reference's ``init_block`` dict, numpy) → a
    ``Block`` of ``kind`` on ``device``."""
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
    return Block(cfg, padded_dims(cfg, 1), kind, RMSNorm(t(p["ln1"])), **parts)


def lm_from_reference(params: dict, cfg: ArchConfig, *, device) -> LM:
    """The reference's ``init_lm`` pytree (numpy leaves) → an ``LM`` on
    ``device`` holding the same weights, each leaf in its own type."""
    stacks = {}
    for spec in stacks_for(cfg):
        stacked = params[f"stack_{spec.name}"]
        stacks[spec.name] = [
            block_from_reference(_layer(stacked, i), cfg, spec.kind, device=device) for i in range(spec.n_layers)
        ]
    embed = _tensor(params["embed"], device) if "embed" in params else None
    head = _tensor(params["head"], device) if "head" in params else None
    mtp = None
    if "mtp" in params:
        m = params["mtp"]
        block = block_from_reference(m["block"], cfg, "attn", device=device)
        mtp = MTP(_tensor(m["proj"], device), block, RMSNorm(_tensor(m["norm"], device)))
    return LM(cfg, embed, stacks, RMSNorm(_tensor(params["final_norm"], device)), head, mtp)
