"""Where a warm step's time goes on a one-rank ("data", "model") = (1, 1)
NCCL mesh against no mesh, on an NVIDIA GPU: starcoder2-3b at full width
in bfloat16, from the same weights in each run.

* ``train``: ``make_train_step`` on 8 × 256 tokens (AdamW, remat
  ``dots``), without and with the mesh.
* ``decode``: ``make_decode_step`` (``serve_sharding="fsdp"``) on 8
  sequences after a 1024-token prefill, without and with the mesh.

For each: the warm step's wall (CUDA-synchronised; the median of
``--reps``), and one warm step under ``torch.profiler``: the host's self
time summed over every operator (``host_ms``, DTensor's sharding
propagation and redistribution included, as they run inside the
operators they dispatch), the card's kernel time (``device_ms``), the
count of ``aten`` calls (``aten_calls``) and the ten operators with the
most host self time (``top``). On the mesh, the time of placing a model
that is placed already, as the step does before it runs: through
``training.steps.place_train_state`` (which builds the axes first) and
through ``ft.elastic.reshard_tree`` given the axes (``place_ms``,
``reshard_ms``).

Run on the card from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.bench.mesh_profile [--what train,decode]``;
it prints one JSON line, with the card's name and power limit, and
writes no file. Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

ARCH = "starcoder2-3b"
TRAIN = (8, 256)
DECODE = (8, 1024, 8)  # batch, prompt, decode steps timed


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall_ms(fn)
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:10]
    return dict(profiled_wall_ms=wall, host_ms=sum(e.self_cpu_time_total for e in ev) / 1e3,
                device_ms=sum(dev_us(e) for e in ev) / 1e3,
                aten_calls=sum(e.count for e in ev if e.key.startswith("aten::")),
                top=[[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top])


def _timed(fn, reps: int) -> dict:
    walls = [_wall_ms(fn) for _ in range(reps)]
    return dict(wall_ms=statistics.median(walls), walls_ms=walls, **_profile(fn))


def train_case(ctx, dev, reps: int) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.launch.train import TrainLoopConfig
    from repro_torch.models.convert import param_leaves
    from repro_torch.models.lm import init_lm, lm_axes
    from repro_torch.training.optimizer import init_opt
    from repro_torch.training.steps import TrainSettings, make_train_step, place_train_state, train_ctx

    cfg = get_arch(ARCH)
    loop = TrainLoopConfig()
    B, S = TRAIN
    settings = TrainSettings(remat=loop.remat, q_chunk=min(512, S), kv_chunk=min(1024, S), opt=loop.opt)
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device=dev) for k in ("tokens", "labels")}
    out = dict(arch=ARCH, batch=B, seq=S)
    for name, c in (("one", None), ("mesh", ctx)):
        torch.cuda.empty_cache()
        model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        opt = init_opt(param_leaves(model), settings.opt)
        step, _, _ = make_train_step(cfg, c, settings, device=dev)
        step(model, opt, batch)  # the first step places what the mesh needs
        run = _timed(lambda: step(model, opt, batch), reps)
        if c is not None:
            tc = train_ctx(cfg, c, settings)
            axes = lm_axes(cfg, tc.tp_size)
            run["place_ms"] = statistics.median(
                _wall_ms(lambda: place_train_state(cfg, tc, settings, model, opt)) for _ in range(reps))
            run["reshard_ms"] = statistics.median(_wall_ms(lambda: reshard_tree(model, tc, axes)) for _ in range(reps))
        out[name] = run
        del model, opt, step
    return out


def decode_case(ctx, dev, reps: int) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.models.lm import init_lm
    from repro_torch.serving.steps import make_decode_step, make_prefill_step, serve_ctx_and_axes

    cfg = get_arch(ARCH)
    B, P, G = DECODE
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P + 1)), device=dev)
    out = dict(arch=ARCH, batch=B, prompt=P, steps=G, serve_sharding="fsdp")
    for name, c in (("one", None), ("mesh", ctx)):
        torch.cuda.empty_cache()
        model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        prefill = make_prefill_step(cfg, c, s_alloc=P + G + reps + 2, device=dev)
        decode = make_decode_step(cfg, c, device=dev)
        _, cache = prefill(model, {"tokens": toks[:, :P]})
        last = {"tokens": toks[:, P:]}
        pos = [P]

        def one_step():
            nonlocal cache
            _, cache = decode(model, cache, last, pos[0])
            pos[0] += 1

        one_step()
        walls = [_wall_ms(one_step) for _ in range(G)]
        run = dict(wall_ms=statistics.median(walls), walls_ms=walls, **_profile(one_step))
        if c is not None:
            sc, p_axes = serve_ctx_and_axes(cfg, c, "fsdp")
            run["reshard_ms"] = statistics.median(_wall_ms(lambda: reshard_tree(model, sc, p_axes)) for _ in range(reps))
        out[name] = run
        del model, cache, prefill, decode
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", default="train,decode")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("mesh_profile runs on an NVIDIA GPU")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_local_group
    from repro_torch.parallel.sharding import make_ctx

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result: dict = {"card": _card(), "torch": torch.__version__}
    cases = {"train": train_case, "decode": decode_case}
    with tempfile.TemporaryDirectory() as d:
        init_local_group(0, 1, os.path.join(d, "store"), "nccl")
        try:
            ctx = make_ctx(init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model")))
            for what in args.what.split(","):
                result[what] = cases[what](ctx, dev, args.reps)
        finally:
            dist.destroy_process_group()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
