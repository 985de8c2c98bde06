"""Batched serving driver of the port: prefill a batch of prompts, decode N
tokens greedily; the counterpart of ``repro.launch.serve``.

Runs on the CUDA device unless ``device="cpu"`` is given (with no GPU and
no device it raises). Reports the prefill wall and decode tokens/s, both
on the host clock after a device synchronize. Prompts, and the frame
embeddings of embedding-input archs, are drawn from
``np.random.default_rng(seed)`` in the reference's order, so both
packages serve the same inputs; the weights come from ``init_lm`` on a
``torch.Generator`` seeded with ``seed`` unless a ``model`` is given.
Under a mesh (``ctx``) every rank calls it alike: the weights are padded
for the mesh's ``tp`` and placed by ``serve_sharding``, the cache's
``s_alloc`` is rounded up to a multiple of ``tp``, and decode runs the
sequence-sharded path; the tokens and logits come back whole.

    python -m repro_torch.launch.serve --arch starcoder2-3b [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_arch, get_smoke
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import full
from repro_torch.models.moe import route_log
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.serving.steps import make_decode_step, make_prefill_step, serving_device

__all__ = ["serve_batch", "decode_forward_error", "device_agreement", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _embeds(rng: np.random.Generator, shape, dev: torch.device) -> torch.Tensor:
    """Standard normal frame embeddings in bfloat16, as the reference's."""
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev, torch.bfloat16)


def serve_batch(
    cfg: ArchConfig,
    *,
    batch_size: int = 4,
    prompt_len: int = 64,
    gen_tokens: int = 32,
    seed: int = 0,
    device=None,
    dtype=None,
    model: lm.LM | None = None,
    ctx: MeshCtx | None = None,
    serve_sharding: str = "fsdp",
) -> dict:
    """Greedy decoding of ``gen_tokens`` tokens after a prompt of
    ``prompt_len`` for ``batch_size`` sequences. Returns the walls, decode
    tokens/s, the generated tokens ``[B, gen_tokens]`` (codebook 0 for
    multi-codebook archs), the last step's logits and the parameter and
    cache bytes (under a mesh, those this rank holds)."""
    dev = serving_device(device)
    tp = ctx.tp_size if ctx else 1
    if model is None:
        model = lm.init_lm(cfg, generator=torch.Generator(dev).manual_seed(seed), device=dev, dtype=dtype, tp=tp)
    elif dtype is not None:
        raise ValueError("dtype applies to the weights serve_batch draws, not to a given model")
    rng = np.random.default_rng(seed)
    s_alloc = prompt_len + gen_tokens
    if ctx is not None:
        s_alloc = -(-s_alloc // tp) * tp

    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch_size, prompt_len)), device=dev)}
    else:
        batch = {"embeds": _embeds(rng, (batch_size, prompt_len, cfg.d_model), dev)}

    prefill_step = make_prefill_step(cfg, ctx, s_alloc=s_alloc, q_chunk=min(512, prompt_len),
                                     kv_chunk=min(1024, prompt_len), serve_sharding=serve_sharding, device=dev)
    decode_step = make_decode_step(cfg, ctx, serve_sharding=serve_sharding, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_step(model, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = []
    t0 = time.perf_counter()
    tok = torch.argmax(logits[..., : cfg.vocab_size], dim=-1)
    for i in range(gen_tokens):
        if cfg.n_codebooks > 1:
            tok_step = tok.reshape(batch_size, cfg.n_codebooks)[:, :1]  # greedy codebook 0
        else:
            tok_step = tok.reshape(batch_size, 1)
        generated.append(tok_step)
        if cfg.input_mode == "tokens":
            step_in = {"tokens": tok_step}
        else:
            # embedding-frontend archs decode from (stub) frame embeddings
            step_in = {"embeds": _embeds(rng, (batch_size, 1, cfg.d_model), dev)}
        logits, cache = decode_step(model, cache, step_in, prompt_len + i)
        tok = torch.argmax(logits[..., : cfg.vocab_size], dim=-1)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": batch_size * gen_tokens / max(t_decode, 1e-9),
        "tokens": torch.cat([full(t) for t in generated], dim=1).cpu().numpy(),
        "logits": full(logits),
        "param_bytes": sum(_held(p).numel() * p.element_size() for p in model.parameters()),
        "cache_bytes": sum(_held(c).numel() * c.element_size() for c in cache.values()),
    }


def _held(t: torch.Tensor) -> torch.Tensor:
    """What this rank holds of ``t``: a DTensor's shard, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def decode_forward_error(model: lm.LM, batch: dict, *, device=None, q_chunk: int = 512,
                         kv_chunk: int = 1024) -> float:
    """Teacher-forced prefill over the batch's ``n`` positions against
    prefill over ``n - 1`` then one decode step at ``n - 1``:
    ``max |a - b| / (|b| + 1e-2)`` over the logits of the vocabulary, the
    reference's check of its decode path (its ``tests/test_archs.py``
    holds it under 5e-3 in float32)."""
    cfg = model.cfg
    n = next(iter(batch.values())).shape[1]
    kw = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, device=device)
    ref, _ = make_prefill_step(cfg, s_alloc=n, **kw)(model, batch)
    _, cache = make_prefill_step(cfg, s_alloc=n + 3, **kw)(model, {k: v[:, : n - 1] for k, v in batch.items()})
    dec, _ = make_decode_step(cfg, device=device)(model, cache, {k: v[:, n - 1 :] for k, v in batch.items()}, n - 1)
    r, d = ref[..., : cfg.vocab_size].float(), dec[..., : cfg.vocab_size].float()
    return float(((r - d).abs() / (r.abs() + 1e-2)).max())


def device_agreement(model_a: lm.LM, model_b: lm.LM, batch: dict, *, n_decode: int = 3, q_chunk: int = 512,
                     kv_chunk: int = 1024) -> dict:
    """The same weights on two devices (``model_b`` a copy of ``model_a``):
    both prefill the batch's first ``n - n_decode`` positions and decode the
    rest teacher-forced. Returns the largest absolute differences of the
    vocabulary's logits (prefill and decode) and of the caches after each
    step; for a model with SSD layers the float32 ``state`` entries apart,
    as ``state``, their difference over their own largest magnitude; for an
    MoE model ``expert_choices_differ``, the (token, choice) expert
    selections of all its routing calls that differ."""
    cfg = model_a.cfg
    n = next(iter(batch.values())).shape[1]
    out = {"prefill_logits": 0.0, "decode_logits": 0.0, "cache": 0.0}
    runs, routes = [], []
    for model in (model_a, model_b):
        dev = model.device
        on = {k: v.to(dev) for k, v in batch.items()}
        prefill = make_prefill_step(cfg, s_alloc=n, q_chunk=q_chunk, kv_chunk=kv_chunk, device=dev)
        decode = make_decode_step(cfg, device=dev)
        with route_log(model) as log:
            logits, cache = prefill(model, {k: v[:, : n - n_decode] for k, v in on.items()})
            steps = [(logits.cpu(), {k: c.to("cpu", copy=True) for k, c in cache.items()})]
            for pos in range(n - n_decode, n):
                logits, cache = decode(model, cache, {k: v[:, pos : pos + 1] for k, v in on.items()}, pos)
                steps.append((logits.cpu(), {k: c.to("cpu", copy=True) for k, c in cache.items()}))
        runs.append(steps)
        routes.append([c["choices"].cpu() for c in log.calls])
    for i, ((la, ca), (lb, cb)) in enumerate(zip(*runs)):
        key = "prefill_logits" if i == 0 else "decode_logits"
        diff = (la[..., : cfg.vocab_size].float() - lb[..., : cfg.vocab_size].float()).abs().max()
        out[key] = max(out[key], float(diff))
        for k in ca:
            diff = float((ca[k].float() - cb[k].float()).abs().max())
            if k.endswith("/state"):
                out["state"] = max(out.get("state", 0.0), diff / max(float(cb[k].abs().max()), 1e-30))
            else:
                out["cache"] = max(out["cache"], diff)
    if routes[0] or routes[1]:
        if [r.shape for r in routes[0]] != [r.shape for r in routes[1]]:
            raise AssertionError("the two runs routed a different number or shape of calls")
        out["expert_choices_differ"] = sum(int((a != b).sum()) for a, b in zip(*routes))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Prefill a batch of prompts and decode greedily.")
    ap.add_argument("--arch", default="starcoder2-3b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    out = serve_batch(cfg, batch_size=args.batch, prompt_len=args.prompt_len, gen_tokens=args.gen,
                      seed=args.seed, device=args.device)
    print(
        f"prefill {out['prefill_s']*1e3:.1f} ms | decode {out['decode_tok_s']:.1f} tok/s "
        f"| sample tokens {out['tokens'][0, :8].tolist()}"
    )


if __name__ == "__main__":
    main()
