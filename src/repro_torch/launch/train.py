"""End-to-end training loop of the port, the counterpart of
``repro.launch.train``: the HR-routed data pipeline → ``make_train_step``
→ the checkpoint manager (async, HR-layout replica manifests) → failure
injection and recovery → resume.

Runs on the CUDA device unless ``device="cpu"`` is given (with no GPU and
no device it raises). The weights come from ``init_lm`` on a
``torch.Generator`` seeded with ``loop.seed``; the corpus, the pipeline's
draws and the failure plan are the reference's, so both packages see the
same batches, and a checkpoint either writes resumes in the other.

Under a mesh (``ctx``, a live ``DeviceMesh``) every rank runs the loop
alike: the weights are padded for the mesh's ``tp``, the parameters and
the optimizer state placed by their specs (``place_train_state``), each
batch placed by ``batch_specs``; rank 0 writes the checkpoints, from
whole tensors, and every rank restores onto the mesh after a barrier.

    python -m repro_torch.launch.train --arch starcoder2-3b [--smoke] [--steps 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ARCHS, get_arch, get_smoke
from repro_torch.data.corpus import CorpusSpec, SyntheticCorpus
from repro_torch.data.pipeline import HRDataPipeline
from repro_torch.ft.failures import FailureInjector, FailurePlan
from repro_torch.launch.serve import _sync
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import full, param_leaves
from repro_torch.models.moe import route_log
from repro_torch.parallel.sharding import MeshCtx, place
from repro_torch.serving.steps import serving_device
from repro_torch.training.optimizer import OptConfig, init_opt
from repro_torch.training.steps import (
    TrainSettings,
    batch_specs,
    loss_and_grads,
    make_train_step,
    place_train_state,
    train_ctx,
    train_params,
)

__all__ = ["TrainLoopConfig", "run_training", "train_agreement", "main"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 256
    ckpt_dir: str = "artifacts/ckpt"
    ckpt_every: int = 50
    replication_factor: int = 3
    data_mechanism: str = "HR"
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    remat: str = "dots"
    opt: OptConfig = dataclasses.field(default_factory=lambda: OptConfig(warmup_steps=20))
    failure_plan: FailurePlan = dataclasses.field(default_factory=FailurePlan)


def run_training(cfg: ArchConfig, loop: TrainLoopConfig, ctx: MeshCtx | None = None, *, resume: bool = True,
                 device=None) -> dict:
    """Returns the reference's summary (losses, recovery log, data-routing
    stats, ``steps_run``) and, measured on the host clock after a device
    synchronize, ``init_s`` (weights and optimizer state), per step
    ``data_s`` (drawing the batch and moving it to the device) and
    ``step_s`` (the train step up to reading its loss), and per step the
    ``grad_norms``."""
    if ctx is not None and not ctx.live:
        raise ValueError("run_training runs on a live DeviceMesh, not on an abstract one")
    dev = serving_device(device)
    corpus = SyntheticCorpus(CorpusSpec(n_docs=20_000, vocab_size=cfg.vocab_size, seed=loop.seed))
    pipeline = HRDataPipeline(
        corpus,
        replication_factor=loop.replication_factor,
        mechanism=loop.data_mechanism,
        seed=loop.seed,
        device=dev,
    )
    injector = FailureInjector(loop.failure_plan, pipeline.engine)

    settings = TrainSettings(
        microbatches=loop.microbatches,
        remat=loop.remat,
        q_chunk=min(512, loop.seq_len),
        kv_chunk=min(1024, loop.seq_len),
        opt=loop.opt,
    )
    step_fn, _, _ = make_train_step(cfg, ctx, settings, device=dev)

    t_init = time.perf_counter()
    tp = ctx.tp_size if ctx else 1
    model = lm.init_lm(cfg, generator=torch.Generator(dev).manual_seed(loop.seed), device=dev, tp=tp)
    opt_state = init_opt(param_leaves(model), loop.opt)
    if ctx is not None:
        place_train_state(cfg, train_ctx(cfg, ctx, settings), settings, model, opt_state)
    _sync(dev)
    init_s = time.perf_counter() - t_init
    start_step = 0

    ckpt = CheckpointManager(loop.ckpt_dir, every=loop.ckpt_every, replicas=loop.replication_factor,
                             write=ctx is None or torch.distributed.get_rank() == 0)

    def restore() -> int | None:
        ckpt.wait()
        if ctx is not None:  # the writing rank has finished
            torch.distributed.barrier()
        return ckpt.restore_latest(model, opt_state)

    if resume:
        restored = restore()
        if restored is not None:
            start_step = restored

    losses, grad_norms, data_s, step_s = [], [], [], []
    t0 = time.perf_counter()
    step = start_step
    while step < loop.steps:
        step += 1
        if injector.maybe_fail(step):
            # node lost: data replicas already rebuilt by the injector via
            # HR Recovery; restart model state from the last checkpoint.
            restored = restore()
            if restored is not None:
                step = restored + 1
        t = time.perf_counter()
        batch_np, _ = pipeline.sample_batch(loop.batch_size, loop.seq_len)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
        _sync(dev)
        data_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        ckpt.maybe_save(step, model, opt_state)
        if step % loop.log_every == 0:
            dt = time.perf_counter() - t0
            tok_s = loop.batch_size * loop.seq_len * step / max(dt, 1e-9)
            print(f"step {step:5d} loss {loss:7.4f} lr {float(metrics['lr']):.2e} {tok_s:9.0f} tok/s")
    ckpt.wait()
    if ctx is not None:
        torch.distributed.barrier()

    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "recoveries": injector.log,
        "data_layouts": [list(a) for a in pipeline.layouts()],
        "avg_rows_scanned": pipeline.total_rows_scanned / max(1, pipeline.n_reads),
        "steps_run": step,
        "init_s": init_s,
        "data_s": data_s,
        "step_s": step_s,
        "grad_norms": grad_norms,
    }


def train_agreement(model_a: lm.LM, model_b: lm.LM, batch: dict, settings: TrainSettings, *,
                    ctx: MeshCtx | None = None) -> dict:
    """The same weights in two runs (``model_b`` a copy of ``model_a``, on
    another device or, under ``ctx``, placed on a mesh): the loss and
    gradients of ``batch`` in each, then one train step in each from fresh
    optimizer state. Returns the largest
    differences: of the loss (``loss``), of the gradients over the largest
    gradient magnitude (``grad_rel``), of the step's loss (``step_loss``)
    and of its gradient norm over the norm (``step_grad_norm_rel``), and
    of the stepped parameters: ``params`` where both runs' gradients
    exceed ``1e-5`` of the largest magnitude, ``params_noise`` elsewhere
    (Adam's first update is the learning rate times the gradient's sign
    wherever the gradient is far above ``eps``, so a gradient at the
    rounding level that flips sign moves its parameter up to twice the
    rate apart); for an MoE model ``expert_choices_differ``, the (token,
    choice) selections of all its routing calls that differ (loss and
    gradients, ``settings.remat`` as given), unless a mesh splits the
    batch, when each rank routes its own rows only. Under a mesh every
    rank calls it alike."""
    out, grads, losses, routes, steps = {}, [], [], [], []
    for model, c in ((model_a, None), (model_b, ctx)):
        dev, cfg = model.device, model.cfg
        on = {k: v.to(dev) for k, v in batch.items()}
        placed, tctx = on, train_ctx(cfg, c, settings)
        if c is not None:
            place_train_state(cfg, tctx, settings, model)
            placed = {k: place(v, tctx, batch_specs(cfg, tctx)[k]) for k, v in on.items()}
        with route_log(model) as log:
            loss, _, g = loss_and_grads(model, placed, settings, tctx)
        losses.append(float(loss))
        grads.append([full(x).float().cpu() for x in g])
        routes.append([c["choices"].cpu() for c in log.calls])
        step, _, _ = make_train_step(cfg, c, settings, device=dev)
        _, _, metrics = step(model, init_opt(param_leaves(model), settings.opt), on)
        steps.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                       [full(p.detach()).float().cpu() for p in train_params(model)]))
    out["loss"] = abs(losses[0] - losses[1])
    g_max = max(float(x.abs().max()) for x in grads[1])
    out["grad_rel"] = max(float((a - b).abs().max()) for a, b in zip(*grads)) / max(g_max, 1e-30)
    out["step_loss"] = abs(steps[0][0] - steps[1][0])
    out["step_grad_norm_rel"] = abs(steps[0][1] - steps[1][1]) / max(steps[1][1], 1e-30)
    out["params"] = out["params_noise"] = 0.0
    for a, b, ga, gb in zip(steps[0][2], steps[1][2], *grads):
        gap = (a - b).abs()
        signal = torch.minimum(ga.abs(), gb.abs()) > 1e-5 * g_max
        out["params"] = max(out["params"], float(gap[signal].max()) if signal.any() else 0.0)
        out["params_noise"] = max(out["params_noise"], float(gap[~signal].max()) if (~signal).any() else 0.0)
    if (routes[0] or routes[1]) and not (ctx is not None and ctx.dp_size > 1):
        if [r.shape for r in routes[0]] != [r.shape for r in routes[1]]:
            raise AssertionError("the two runs routed a different number or shape of calls")
        out["expert_choices_differ"] = sum(int((a != b).sum()) for a, b in zip(*routes))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train an LM on the HR-routed synthetic corpus.")
    ap.add_argument("--arch", default="starcoder2-3b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--data-mechanism", default="HR", choices=("HR", "TR"))
    ap.add_argument("--fail-at", type=int, default=0, help="inject a node failure at this step")
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    plan = FailurePlan(fail_at_steps=(args.fail_at,) if args.fail_at else (), nodes=(0,))
    loop = TrainLoopConfig(
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        data_mechanism=args.data_mechanism,
        failure_plan=plan,
    )
    summary = run_training(cfg, loop, device=args.device)
    print(
        f"done: {summary['steps_run']} steps, final loss {summary['final_loss']:.4f}, "
        f"avg rows scanned/read {summary['avg_rows_scanned']:.0f}, "
        f"recoveries {len(summary['recoveries'])}"
    )


if __name__ == "__main__":
    main()
