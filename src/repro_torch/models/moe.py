"""Mixture-of-Experts of the port at one device: the counterpart of
``repro.models.moe`` with ``ctx=None`` (``_moe_local`` over every expert,
offset 0).

Capacity-factor dispatch with static shapes: each expert takes at most
``C = max(1, ceil(T·k·capacity_factor / n_experts))`` of the ``T·k``
(token, choice) assignments, in token-major order; the rest are dropped
and add nothing. The three expert products take model-dtype inputs and
give float32 results, as the reference's ``preferred_element_type``;
the gate-weighted combine sums into float32. Shared experts are the
caller's dense MLP. Expert parallelism over a mesh comes with the port's
``DeviceMesh`` (ROADMAP item 7f).

``route_log`` records what every MoE layer's router chose and dropped,
call by call, for the checks that compare two runs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import KeepFloat32, dense_init

__all__ = ["MoE", "RouteLog", "init_moe", "route", "expert_matmul", "moe_forward", "route_log"]


class MoE(KeepFloat32):
    """``router`` float32 ``[d, E]``; ``wi``, ``wg`` ``[E, d, f]`` and ``wo``
    ``[E, f, d]`` in the model's type. ``log``, when set by ``route_log``,
    receives each call's routing."""

    FLOAT32 = ("router",)

    def __init__(self, router: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.router, self.wi, self.wg, self.wo = (torch.nn.Parameter(w) for w in (router, wi, wg, wo))
        self.log: tuple[str, RouteLog] | None = None


def _trunc_normal(shape, std: float, *, generator, device, dtype) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``std``, drawn in float32 and
    scaled in place (a full-width expert tensor is 15 GB in float32)."""
    w = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def init_moe(cfg: ArchConfig, *, generator, device, dtype) -> MoE:
    """The reference's ``init_moe`` at tp 1: E = ``n_experts``."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    kw = dict(generator=generator, device=device, dtype=dtype)
    return MoE(
        dense_init(d, E, generator=generator, device=device, dtype=torch.float32),
        _trunc_normal((E, d, f), 1.0 / math.sqrt(d), **kw),
        _trunc_normal((E, d, f), 1.0 / math.sqrt(d), **kw),
        _trunc_normal((E, f, d), 1.0 / math.sqrt(f), **kw),
    )


def route(cfg: ArchConfig, logits: torch.Tensor, e_valid: int):
    """Top-k routing of float32 ``logits [T, E]`` → (expert indices [T, k],
    gates [T, k] float32, probabilities [T, E]). Experts at or past
    ``e_valid`` never win. Equal scores rank the lower expert first, as
    ``jax.lax.top_k`` does: a stable descending sort, not ``torch.topk``,
    whose order on ties is unspecified."""
    mask = torch.arange(logits.shape[-1], device=logits.device) < e_valid
    logits = torch.where(mask, logits, -1e30)
    if cfg.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        scores = torch.softmax(logits, dim=-1)
        probs = scores
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[:, : cfg.moe_top_k], idx[:, : cfg.moe_top_k]
    gates = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
    return idx, gates.float(), probs


class _ExpertMatmul(torch.autograd.Function):
    """The float32-out product of two tensors in a narrower type. Forward:
    cuBLAS writes float32 on the card; on the CPU the inputs widen first,
    which is exact (a product of two bfloat16 values fits a float32).
    Backward, on either device: the float32 cotangent against the other
    input widened, cast back to the input's type, as the transpose of the
    reference's ``preferred_element_type=float32`` product is."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            return torch.bmm(x, w, out_dtype=torch.float32)
        return torch.bmm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.bmm(g, w.float().transpose(1, 2)).to(x.dtype) if ctx.needs_input_grad[0] else None
        gw = torch.bmm(x.float().transpose(1, 2), g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[E, C, a] @ [E, a, b]`` → float32 ``[E, C, b]`` from inputs in the
    model's type, accumulated in float32 (``_ExpertMatmul``)."""
    if x.dtype == torch.float32:
        return torch.bmm(x, w)
    return _ExpertMatmul.apply(x, w)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed-expert output of ``x [B, S, D]`` → (y [B, S, D] in ``x``'s type,
    the load-balance statistic, a float32 scalar)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    T = B * S
    E = p.router.shape[-1]
    k = cfg.moe_top_k
    C = max(1, int(math.ceil(T * k * cfg.capacity_factor / cfg.n_experts)))

    logits = xt.float() @ p.router
    idx, gates, probs = route(cfg, logits, cfg.n_experts)

    # each assignment's slot in its expert: the exclusive prefix count over
    # the (token, choice) assignments in token-major order
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot).gather(1, flat_e[:, None])[:, 0].long()
    kept = slot < C
    tok = torch.arange(T, device=x.device).repeat_interleave(k)

    # the reference's scatter mode "drop" and gather mode "fill", with no
    # sync: a dropped assignment writes to a spare slot C, which no expert
    # reads, and reads a zero row there
    slot = torch.where(kept, slot, C)
    x_buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    x_buf[flat_e, slot] = xt[tok]
    x_buf = x_buf[:, :C]
    h = expert_matmul(x_buf, p.wi)
    g = expert_matmul(x_buf, p.wg)
    act = F.silu if cfg.act == "silu" else (lambda v: F.gelu(v, approximate="tanh"))
    h = (act(g) * h).to(x.dtype)
    y_buf = F.pad(expert_matmul(h, p.wo), (0, 0, 0, 1))

    y_tok = y_buf[flat_e, slot]
    y_tok = (y_tok * gates.reshape(-1, 1)).reshape(T, k, D)
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(k):  # the reference's scatter-add, in its order
        y = y + y_tok[:, j]

    sel = F.one_hot(idx, E).float().sum(1)
    aux = torch.sum(sel.mean(0) * probs.mean(0)) * cfg.n_experts
    if p.log is not None:
        name, log = p.log
        log.add(name, idx, kept.reshape(T, k), C)
    return y.reshape(B, S, D).to(x.dtype), aux


class RouteLog:
    """What each MoE layer's router did, one entry a call: the layer's name,
    the tokens, the capacity, the assignments, how many were dropped (a
    device tensor until ``summary``), the expert indices [T, k] and the
    kept mask [T, k]."""

    def __init__(self):
        self.calls: list[dict] = []

    def add(self, layer: str, idx: torch.Tensor, kept: torch.Tensor, capacity: int) -> None:
        self.calls.append(dict(layer=layer, tokens=idx.shape[0], capacity=capacity, assignments=idx.numel(),
                               dropped=(~kept).sum(), choices=idx, kept=kept))

    def summary(self) -> list[dict]:
        """Per call: layer, tokens, capacity, assignments, dropped (ints)."""
        return [dict(layer=c["layer"], tokens=c["tokens"], capacity=c["capacity"], assignments=c["assignments"],
                     dropped=int(c["dropped"])) for c in self.calls]


@contextlib.contextmanager
def route_log(model: torch.nn.Module):
    """Record every MoE layer of ``model`` while the block runs; yields the
    ``RouteLog``."""
    log = RouteLog()
    layers = [(name, m) for name, m in model.named_modules() if isinstance(m, MoE)]
    for name, m in layers:
        m.log = (name, log)
    try:
        yield log
    finally:
        for _, m in layers:
            m.log = None
