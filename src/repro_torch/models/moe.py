"""Mixture-of-Experts of the port: shared + routed experts, expert
parallelism over the model axis; the counterpart of ``repro.models.moe``.

Capacity-factor dispatch with static shapes: each expert takes at most
``C = max(1, ceil(T·k·capacity_factor / n_experts))`` of the ``T·k``
(token, choice) assignments of the ``T`` tokens a rank routes, in
token-major order; the rest are dropped and add nothing. The three expert
products take model-dtype inputs and give float32 results, as the
reference's ``preferred_element_type``; the gate-weighted combine sums
into float32. Shared experts are the caller's dense MLP.

Under a mesh (``ctx``) the routed experts run in a region on local shards
(``_moe_local`` at this rank's expert offset), because DTensor has no
sharding strategy for the float32-out expert product (``aten.bmm.dtype``):

  * training and ``fsdp`` serving: activations data-parallel over the dp
    axes and replicated over ``model``; every model rank routes the same
    local tokens but owns ``E / tp`` experts. The expert weights,
    FSDP-sharded on d_ff over the dp axes, are gathered in-layer by a
    ``redistribute`` (its backward is the reduce-scatter); the partial
    outputs are summed over ``model`` (a ``Partial`` placement made
    ``Replicate``).
  * ``tp`` serving (``ctx.serve_ep``): the weights hold no FSDP shard, so
    the same region runs with no gather; when the padded expert count
    divides data × model (``ep_over_data_ok``) it is the global EP region
    instead: experts over (data, model), the tokens gathered over the dp
    axes, the partials reduce-scattered back to each dp row's slice.

The load-balance statistic under a mesh is the reference's: each rank
takes it over the tokens it routes (its data shard's; the whole batch's
under global EP or an unsharded batch), and returns it under a
replicated placement, as the reference's region does under its
replicated out-spec (``check_vma=False``): its value on each rank is its
own data shard's (the loss the reference reads back is data shard 0's),
and its gradient is that of the mean over the data shards (the
reference's transpose divides the out-spec's cotangent among the ranks
and sums the inputs' cotangents over them). With one data shard that is
the one-device statistic.

``route_log`` records what every MoE layer's router chose and dropped,
call by call, for the checks that compare two runs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import KeepFloat32, dense_init, region_in, region_out

__all__ = ["MoE", "RouteLog", "init_moe", "moe_axes", "ep_over_data_ok", "route", "expert_matmul", "moe_forward",
           "route_log"]


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


def _e_pad(cfg: ArchConfig, tp: int) -> int:
    return -(-cfg.n_experts // tp) * tp


def init_moe(cfg: ArchConfig, *, generator, device, dtype, tp: int = 1) -> MoE:
    """The reference's ``init_moe``: E = ``n_experts`` rounded up to a
    multiple of ``tp``; the pad experts never win the routing."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, _e_pad(cfg, tp)
    kw = dict(generator=generator, device=device, dtype=dtype)
    return MoE(
        dense_init(d, E, generator=generator, device=device, dtype=torch.float32),
        _trunc_normal((E, d, f), 1.0 / math.sqrt(d), **kw),
        _trunc_normal((E, d, f), 1.0 / math.sqrt(d), **kw),
        _trunc_normal((E, f, d), 1.0 / math.sqrt(f), **kw),
    )


def moe_axes(cfg: ArchConfig, tp: int = 1) -> dict:
    return {
        "router": (None, None),
        "wi": ("experts", None, "expert_mlp"),
        "wg": ("experts", None, "expert_mlp"),
        "wo": ("experts", "expert_mlp", None),
    }


def ep_over_data_ok(cfg: ArchConfig, ctx) -> bool:
    """Global EP (experts over data×model) requires divisibility."""
    if ctx is None or "data" not in ctx.axis_names:
        return False
    E = _e_pad(cfg, ctx.tp_size)
    return E % (ctx.shape["data"] * ctx.tp_size) == 0


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


def _moe_local(router: torch.Tensor, w: tuple, xt: torch.Tensor, cfg: ArchConfig, e_offset: int, E_local: int,
               log=None):
    """The reference's ``_moe_local``: the routed output of the local tokens
    ``xt [T, D]`` through the experts ``[e_offset, e_offset + E_local)``
    only, whose weights ``w = (wi, wg, wo)`` are local tensors, as is the
    whole ``router``. Returns (y [T, D] float32, the routed fractions [E]
    and the mean probabilities [E] over the ``T`` tokens); ``log`` is the
    layer's ``MoE.log``."""
    wi, wg, wo = w
    T, D = xt.shape
    E = router.shape[-1]
    k = cfg.moe_top_k
    C = max(1, int(math.ceil(T * k * cfg.capacity_factor / cfg.n_experts)))

    logits = xt.float() @ router
    idx, gates, probs = route(cfg, logits, cfg.n_experts)

    # each assignment's slot in its expert: the exclusive prefix count over
    # the (token, choice) assignments in token-major order; another rank's
    # assignments go to the spare expert row E_local
    local_e = idx.reshape(-1) - e_offset
    is_local = (local_e >= 0) & (local_e < E_local)
    flat_e = torch.where(is_local, local_e, E_local)
    onehot = F.one_hot(flat_e, E_local + 1).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot).gather(1, flat_e[:, None])[:, 0].long()
    kept = is_local & (slot < C)
    tok = torch.arange(T, device=xt.device).repeat_interleave(k)

    # the reference's scatter mode "drop" and gather mode "fill", with no
    # sync: a dropped or foreign assignment writes to a spare slot C of the
    # spare row, which no expert reads, and reads a zero row there
    slot = torch.where(kept, slot, C)
    flat_e = torch.where(kept, flat_e, E_local)
    x_buf = torch.zeros((E_local + 1, C + 1, D), dtype=xt.dtype, device=xt.device)
    x_buf[flat_e, slot] = xt[tok]
    x_buf = x_buf[:E_local, :C]
    h = expert_matmul(x_buf, wi)
    g = expert_matmul(x_buf, wg)
    act = F.silu if cfg.act == "silu" else (lambda v: F.gelu(v, approximate="tanh"))
    h = (act(g) * h).to(xt.dtype)
    y_buf = F.pad(expert_matmul(h, wo), (0, 0, 0, 1, 0, 1))

    y_tok = y_buf[flat_e, slot]
    y_tok = (y_tok * gates.reshape(-1, 1)).reshape(T, k, D)
    y = torch.zeros((T, D), dtype=torch.float32, device=xt.device)
    for j in range(k):  # the reference's scatter-add, in its order
        y = y + y_tok[:, j]

    if log is not None:
        name, calls = log
        calls.add(name, idx, kept.reshape(T, k), C)
    return y, F.one_hot(idx, E).float().sum(1).mean(0), probs.mean(0)


def moe_forward(p: MoE, x: torch.Tensor, cfg: ArchConfig, ctx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Routed-expert output of ``x [B, S, D]`` → (y [B, S, D] in ``x``'s type,
    the load-balance statistic, a float32 scalar). Under ``ctx`` ``x`` and
    the weights are DTensors and so is what comes back."""
    B, S, D = x.shape
    if ctx is None:
        E = p.router.shape[-1]
        y, frac, mean_p = _moe_local(p.router, (p.wi, p.wg, p.wo), x.reshape(B * S, D), cfg, 0, E, p.log)
        return y.reshape(B, S, D).to(x.dtype), torch.sum(frac * mean_p) * cfg.n_experts
    return _moe_mesh(p, x, cfg, ctx)


def _moe_mesh(p: MoE, x, cfg: ArchConfig, ctx):
    """The reference's ``shard_map`` regions (module docstring) over
    DTensors. As in its transpose, the gradients of what every model rank
    reads whole (the tokens, the router) are summed over the ranks that
    add to the output, and the statistic enters that sum divided by their
    number."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.parallel.sharding import logical_to_spec

    mesh, names = ctx.mesh, ctx.axis_names
    E = p.router.shape[-1]
    global_ep = ctx.serve_ep and ep_over_data_ok(cfg, ctx)
    x_pl = ctx.placements(logical_to_spec(ctx, ("batch", None, None)))
    # the ranks whose experts add up to the output
    ep = ("data", ctx.tp_axis) if global_ep else (ctx.tp_axis,)
    n_ep = math.prod(ctx.shape[a] for a in ep)
    E_local = E // n_ep
    rank = 0
    for a in ep:
        rank = rank * ctx.shape[a] + mesh.get_local_rank(a)
    w_pl = ctx.placements((ep, None, None) if global_ep else (ctx.tp_axis, None, None))
    # the tokens every rank routes: its own rows, or (global EP) all of them
    in_pl = [Replicate()] * len(names) if global_ep else list(x_pl)
    row = [Shard(0) if p == Shard(0) else None for p in in_pl]  # rows this rank alone holds
    added = [Partial() if a in ep else Replicate() for a in names]  # summed over the experts' ranks
    x_grad = [r or s for r, s in zip(row, added)]
    whole_grad = [Partial() if r or a in ep else Replicate() for r, a in zip(row, names)]
    x_loc = region_in(x, mesh, in_pl, x_grad)
    router = region_in(p.router, mesh, [Replicate()] * len(names), whole_grad)
    w_grad = [Partial() if r else pl for r, pl in zip(row, w_pl)]
    w = tuple(region_in(t, mesh, w_pl, w_grad) for t in (p.wi, p.wg, p.wo))
    Bl, Sl, D = x_loc.shape
    y, frac, mean_p = _moe_local(router, w, x_loc.reshape(Bl * Sl, D), cfg, rank * E_local, E_local, p.log)
    y = region_out(y.reshape(Bl, Sl, D), mesh, x_grad, x.shape).redistribute(mesh, x_pl)
    # the statistic (module docstring): the mean over the ranks that add to
    # the output carries the gradient, this rank's own the value
    own = torch.sum(frac * mean_p) * cfg.n_experts
    stat_pl = [Partial() if r or a in ep else Replicate() for r, a in zip(row, names)]
    n = math.prod(ctx.shape[a] for a, pl in zip(names, stat_pl) if pl.is_partial())
    whole = [Replicate()] * len(names)
    mean = region_out(own / n, mesh, stat_pl, ()).redistribute(mesh, whole)
    return y.to(x.dtype), mean + DTensor.from_local((own - mean.to_local()).detach(), mesh, whole, run_check=False)


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
