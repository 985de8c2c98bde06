"""Mamba-2 (SSD, state-space duality) block of the port, chunked-scan
formulation: the counterpart of ``repro.models.ssm``.

Prefill: a loop over sequence chunks of length Q; within a chunk the
quadratic "attention-like" form (masked decay matrix L), across chunks
the float32 state ``[B, H, P, N]`` is carried. Decode: the exact
recurrent step on (conv window, state). The input projection is split
into (w_xz, w_bc, w_dt) as in the reference.

TP: heads are sharded over the ``model`` axis, padded to a multiple of
``tp`` (``ssm_dims``); the pad heads have zero ``D``, zero input and
output projections, and contribute nothing. The forward and decode read
the padded head count from the module itself (``A_log`` is ``[H_pad]``).

Under a mesh the block runs in a region on each rank's batch rows: its
weights and the decode state are gathered whole (a ``redistribute``,
differentiable, whose backward reduce-scatters the gradients), the
forward or decode runs on ``to_local()`` tensors, and what comes out is
a DTensor over the same rows, replicated over the other axes. DTensor's
propagation cannot carry the chunk loop's reshapes of the sequence and
head dimensions; the heads' weights stay sharded at rest.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from .config import ArchConfig
from .layers import KeepFloat32, dense, dense_init, region_in, region_out, rmsnorm, row_partial, rows

__all__ = ["SSM", "ssm_dims", "init_ssm", "ssm_axes", "ssm_forward", "ssm_decode", "init_ssm_state"]


class SSM(KeepFloat32):
    """The reference's twelve leaves: ``w_xz`` ``[d, 2·di]``, ``w_bc`` ``[d,
    2N]``, ``w_dt`` ``[d, H]``, ``conv_x`` ``[K, di]``, ``conv_bc`` ``[K,
    2N]``, their biases, ``w_out`` ``[di, d]`` in the model's type;
    ``A_log``, ``D``, ``dt_bias`` ``[H]`` and ``out_norm`` ``[di]`` float32."""

    FLOAT32 = ("A_log", "D", "dt_bias", "out_norm")
    NAMES = ("w_xz", "w_bc", "w_dt", "conv_x", "conv_bc", "conv_x_b", "conv_bc_b", "A_log", "D", "dt_bias",
             "out_norm", "w_out")

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        if sorted(leaves) != sorted(self.NAMES):
            raise ValueError(f"SSM takes the leaves {self.NAMES}, got {sorted(leaves)}")
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(leaves[name]))


def ssm_dims(cfg: ArchConfig, tp: int = 1) -> dict[str, int]:
    """Padded SSD dimensions for tensor-parallel degree ``tp``."""
    P = cfg.ssm_head_dim
    H = cfg.d_inner // P
    H_pad = -(-H // tp) * tp if tp > 1 else H
    return {"P": P, "H": H, "H_pad": H_pad, "di": H_pad * P, "N": cfg.ssm_state, "conv": cfg.ssm_conv}


def _dims(p, cfg: ArchConfig) -> dict[str, int]:
    """The dimensions of a built module: its own (padded) head count."""
    P, H = cfg.ssm_head_dim, p.A_log.shape[0]
    return {"P": P, "H": H, "di": H * P, "N": cfg.ssm_state}


def ssm_axes(cfg: ArchConfig, tp: int = 1) -> dict:
    return {
        "w_xz": ("fsdp", "heads"),
        "w_bc": ("fsdp", None),
        "w_dt": ("fsdp", "heads"),
        "conv_x": (None, "heads"),
        "conv_bc": (None, None),
        "conv_x_b": ("heads",),
        "conv_bc_b": (None,),
        "A_log": ("heads",),
        "D": ("heads",),
        "dt_bias": ("heads",),
        "out_norm": ("heads",),
        "w_out": ("heads", "fsdp"),
    }


def init_ssm(cfg: ArchConfig, *, generator, device, dtype, tp: int = 1) -> SSM:
    """The reference's distributions: projections truncated normal, conv
    weights normal times 0.1, zero biases, ``A_log = log(linspace(1, 16,
    H_pad))``, ``D`` ones, ``dt_bias`` the inverse softplus of a dt drawn
    log-uniform on [0.001, 0.1]; the pad heads' input and output
    projections and ``D`` zero."""
    dims = ssm_dims(cfg, tp)
    d, di, N, H, K = cfg.d_model, dims["di"], dims["N"], dims["H_pad"], cfg.ssm_conv
    kw = dict(generator=generator, device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)

    def normal(shape):
        return (torch.empty(shape, **f32).normal_(generator=generator) * 0.1).to(dtype)

    u = torch.empty((H,), **f32).uniform_(generator=generator)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p = SSM(
        w_xz=dense_init(d, 2 * di, **kw),
        w_bc=dense_init(d, 2 * N, **kw),
        w_dt=dense_init(d, H, **kw),
        conv_x=normal((K, di)),
        conv_bc=normal((K, 2 * N)),
        conv_x_b=torch.zeros((di,), device=device, dtype=dtype),
        conv_bc_b=torch.zeros((2 * N,), device=device, dtype=dtype),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        D=torch.ones((H,), **f32),
        dt_bias=torch.log(torch.expm1(dt)),
        out_norm=torch.ones((di,), **f32),
        w_out=dense_init(di, d, **kw),
    )
    if H != dims["H"]:  # zero the pad heads end to end
        live = dims["H"] * dims["P"]
        with torch.no_grad():
            p.w_xz[:, live:di] = 0
            p.w_xz[:, di + live :] = 0
            p.w_out[live:, :] = 0
            p.D[dims["H"] :] = 0
    return p


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) without torch's linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [K, C] → causal depthwise conv, silu activation."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i : i + S, :] * w[i]
    return F.silu(out + b)


def _in_region(fn, p: SSM, x, *args):
    """``fn(p, x, *args)`` on ``x``'s batch rows with whole weights; plain
    tensors pass straight through. ``args`` may hold a dict of [B, ...]
    DTensors (the decode state); every [B, ...] output comes back as a
    DTensor over the same rows."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return fn(p, x, *args)
    mesh, pl = x.device_mesh, rows(x)
    whole = [Replicate()] * mesh.ndim
    grad = row_partial(x)  # the weights' gradients: summed over the ranks of other rows
    lp = types.SimpleNamespace(**{n: region_in(getattr(p, n), mesh, whole, grad) for n in SSM.NAMES})
    args = [{k: region_in(v, mesh, pl) for k, v in a.items()} if isinstance(a, dict) else a for a in args]
    out = fn(lp, region_in(x, mesh, pl), *args)
    B = x.shape[0]

    def back(t):
        if isinstance(t, dict):
            return {k: back(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(back(v) for v in t)
        return region_out(t, mesh, pl, (B, *t.shape[1:]))

    return back(out)


def ssm_forward(p: SSM, x: torch.Tensor, cfg: ArchConfig, *, chunk: int | None = None, return_state: bool = False):
    """Full-sequence SSD, x [B, S, D] → y [B, S, D]; with ``return_state``
    also the decode cache it leaves: ``conv_x``, ``conv_bc`` (the last K − 1
    projections before the conv, in ``x``'s type) and ``state`` (float32)."""
    return _in_region(_ssm_forward, p, x, cfg, chunk, return_state)


def _ssm_forward(p, x: torch.Tensor, cfg: ArchConfig, chunk: int | None, return_state: bool):
    dims = _dims(p, cfg)
    B, S, _ = x.shape
    di, N, H, P = dims["di"], dims["N"], dims["H"], dims["P"]
    Q = min(chunk or cfg.ssm_chunk, S)
    while S % Q:  # the largest divisor of S not above the chunk
        Q -= 1
    nc = S // Q

    xz = dense(x, p.w_xz)
    xs_raw, z = xz[..., :di], xz[..., di:]
    bc_raw = dense(x, p.w_bc)
    dt = _softplus(dense(x, p.w_dt).float() + p.dt_bias)  # [B, S, H]
    xs = _causal_depthwise_conv(xs_raw, p.conv_x, p.conv_x_b)
    bc = _causal_depthwise_conv(bc_raw, p.conv_bc, p.conv_bc_b)
    Bm, Cm = bc[..., :N], bc[..., N:]  # [B, S, N], shared by the heads

    A = -torch.exp(p.A_log)  # [H]
    a = dt * A  # [B, S, H] log-decay per step
    xh = xs.reshape(B, S, H, P)
    dtx = xh.float() * dt[..., None]  # [B, S, H, P]

    a_c = a.reshape(B, nc, Q, H)
    dtx_c = dtx.reshape(B, nc, Q, H, P)
    B_c = Bm.reshape(B, nc, Q, N).float()
    C_c = Cm.reshape(B, nc, Q, N).float()
    qt_mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, :, :, None]

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        a_q, dtx_q, B_q, C_q = a_c[:, c], dtx_c[:, c], B_c[:, c], C_c[:, c]
        cum = torch.cumsum(a_q, dim=1)  # [B, Q, H] inclusive
        # within the chunk: L[b, q, t, h] = exp(cum[q] - cum[t]) for q >= t
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        L = torch.where(qt_mask, torch.exp(diff), 0.0)
        CB = torch.einsum("bqn,btn->bqt", C_q, B_q)
        y_diag = torch.einsum("bqt,bqth,bthp->bqhp", CB, L, dtx_q)
        # the carried state's contribution
        y_off = torch.einsum("bqn,bhpn,bqh->bqhp", C_q, h, torch.exp(cum))
        total = cum[:, -1:, :]  # [B, 1, H]
        w = torch.exp(total - cum)  # decay from t to the chunk's end
        h = h * torch.exp(total[:, 0, :])[:, :, None, None] + torch.einsum("btn,bthp,bth->bhpn", B_q, dtx_q, w)
        ys.append(y_diag + y_off)
    Y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    Y = Y + p.D[None, None, :, None] * xh.float()
    y = Y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    out = dense(y, p.w_out)
    if not return_state:
        return out
    K = cfg.ssm_conv
    state = {
        "conv_x": xs_raw[:, S - (K - 1) :, :].to(x.dtype),
        "conv_bc": bc_raw[:, S - (K - 1) :, :].to(x.dtype),
        "state": h,
    }
    return out, state


def init_ssm_state(cfg: ArchConfig, batch: int, *, device, dtype=torch.float32, tp: int = 1) -> dict[str, torch.Tensor]:
    """A zeroed decode cache of one layer; ``state`` is float32 whatever
    ``dtype``."""
    dims = ssm_dims(cfg, tp)
    return {
        "conv_x": torch.zeros((batch, cfg.ssm_conv - 1, dims["di"]), device=device, dtype=dtype),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * dims["N"]), device=device, dtype=dtype),
        "state": torch.zeros((batch, dims["H_pad"], dims["P"], dims["N"]), device=device, dtype=torch.float32),
    }


def ssm_decode(p: SSM, x_t: torch.Tensor, state: dict[str, torch.Tensor],
               cfg: ArchConfig) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One recurrent step, x_t [B, 1, D] → (y [B, 1, D], the new state)."""
    return _in_region(_ssm_decode, p, x_t, state, cfg)


def _ssm_decode(p, x_t: torch.Tensor, state: dict[str, torch.Tensor], cfg: ArchConfig):
    dims = _dims(p, cfg)
    B = x_t.shape[0]
    di, N, H, P = dims["di"], dims["N"], dims["H"], dims["P"]
    x = x_t[:, 0, :]
    xz = dense(x, p.w_xz)
    xs, z = xz[..., :di], xz[..., di:]
    bc = dense(x, p.w_bc)
    dt = _softplus(dense(x, p.w_dt).float() + p.dt_bias)  # [B, H]

    # the conv window: the last K - 1 inputs and this one
    win_x = torch.cat([state["conv_x"], xs[:, None, :].to(state["conv_x"].dtype)], dim=1)
    xs = F.silu(torch.einsum("bkc,kc->bc", win_x, p.conv_x) + p.conv_x_b)
    win_bc = torch.cat([state["conv_bc"], bc[:, None, :].to(state["conv_bc"].dtype)], dim=1)
    bc_c = F.silu(torch.einsum("bkc,kc->bc", win_bc, p.conv_bc) + p.conv_bc_b)
    Bv, Cv = bc_c[..., :N].float(), bc_c[..., N:].float()

    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)  # [B, H]
    xh = xs.reshape(B, H, P).float()
    dtx = xh * dt[..., None]
    h_new = state["state"] * decay[:, :, None, None] + torch.einsum("bn,bhp->bhpn", Bv, dtx)
    y = torch.einsum("bhpn,bn->bhp", h_new, Cv) + p.D[None, :, None] * xh
    y = y.reshape(B, di).to(x_t.dtype)
    y = rmsnorm(y * F.silu(z), p.out_norm, cfg.norm_eps)
    out = dense(y, p.w_out)[:, None, :]
    return out, {"conv_x": win_x[:, 1:], "conv_bc": win_bc[:, 1:], "state": h_new}
