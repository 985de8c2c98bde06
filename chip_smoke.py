#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
the port's two read paths at TPC-H scale factor 5 (7.5 M ``orders`` rows,
replication factor 3): CREATE a device-resident HR column family, serve
``read_many`` and ``read`` batches, write through commit log, memtable,
flush and append, and compact the run stack on the device; then the same
on a second column family with materialized per-slab views, whose
eligible sums and counts are served from per-block partials; and the
same rows partitioned over a token ring (four partitions of three
replicas), read by scatter-gather and written by routed writes; then the
availability layer on all three (digest reads with read repair, hinted
handoff, recovery, hedges, failover, scrub with view healing); then ring
migration (split, merge, the drift trigger's rebalance) of the
partitioned families, a parallel write and read deadlines; then the
serving front door, traced, over the resident ``orders`` family, and the
chaos harnesses with port engines as victim and oracle; last, the LM
serving path, starcoder2-3b at full width. It holds
every kernel of these paths against its plain PyTorch version on the same
CUDA tensors, at the paths' shapes, and times both.

Phases, each asserting (a failure exits non-zero and prints no result):
  1. setup      card name and power limit, kernel build
  2. kernels    the compaction's merge-rank kernel on the 9-run stack the
                write phase folds (vs plain and the host merge order) and
                on a stack of that shape whose appended keys all equal
                keys of other runs (vs plain); the histogram kernel on a
                write batch's three key columns, one by one and in the one
                batched launch the statistics refresh makes, vs plain and
                np.bincount (repro_torch.bench.write_kernels); times by
                CUDA events and under torch.profiler, bounds,
                torch.bincount in turns, an empty launch of the same grid
  3. create     HREngine(n_nodes=6), HR layouts from HRCA over Q1/Q2
  4. reads      4 read_many batches of 256 (1/2 sums, 1/4 counts, 1/4
                selects), one repeated batch (result-cache hits), a batch
                of wide queries and 16 scalar reads; 64 + 8 answers held
                against a brute-force numpy pass over the generated rows;
                select_compact on the replica groups of the first batch
                vs its plain version (single runs)
  5. row_slab   the row-slab read path on the three replicas while each
                holds one sorted run, its launch counts from 0: per replica,
                a fresh batch of 256 (128 sums, 128 counts) located by
                slab_many (the k-ary search kernel, equal to the host
                searchsorted), scanned by table_scan_device_many on both
                grids (queries outer on the 128 sums) and with slabs=None,
                and one Q = 1 table_scan_device; every answer against the
                brute-force oracle. Then each of the three kernels against
                its plain version on the same CUDA tensors (slabs equal,
                counts equal, sums within rtol 1e-5 / atol 1e-3), timed
                beside its bound and, for slab_locate, torch.searchsorted
                on the packed key, the two timed in turns (kernel,
                library, library, kernel) by CUDA events and under
                torch.profiler (bench.select_slab.slab_locate_turns); the
                two scans by events and under torch.profiler pass by pass,
                beside the same launch with every slab empty, their bound
                over the int32 rate and the queries-outer scan's bytes by
                design (bench.row_slab); the k-ary search's dependent
                rounds, one dependent load's latency
                (bench.select_slab.load_latency_ns) and the latency bound
                they give go into the row_slab line. Then both scans on the
                edge cases of their decomposition (bench.row_slab.edge_check:
                equal to plain, run to run, and bit for bit to the
                decomposition written out in PyTorch)
  6. batched_read  repro_torch.bench.batched_read.run_device on one
                replica of the SF 5 rows, batch sizes 16, 64 and 256: the
                numpy, qgrid, rowgrid, rowgrid-over-device-slabs and fused
                engines, cross-checked, then timed in queries per second
  7. writes     8 write-through writes of 20,000 rows (the 8th trips the
                compaction policy's max_runs), resident state vs a fresh
                build, 2 more writes, reads checked again over all rows;
                the main path's launches: merge_run_positions 3 (one
                compaction a replica), ecdf_hist 10 (one a write);
                on the appended run stacks slab_many launches nothing and
                table_scan_device_many raises
  8. partitions  "orders_p": the same SF 5 rows at partitions=4,
                partition_balance="tokens", RF 3, 6 nodes, device-resident,
                HR layouts from HRCA over the row-weighted blend of the four
                partitions' cost models (12 replica tables); two fresh
                batches of 256, 16 scalar reads, the 10 writes (each
                partition compacts at the 8th), one more batch. Every answer
                against the oracle: counts and rows_matched exact, sums
                within rtol 1e-5 / atol 1e-3, rows_scanned the serving
                replicas' host slabs, select indices the serving replicas'
                host scans in ring order and their rows, materialized, equal
                as a set to the oracle's; the token histogram equal to
                np.bincount of every committed token after CREATE and after
                the writes; the path's launches (scan, select compaction,
                merge rank one a compaction, the histogram once at CREATE and
                per write once for the token histogram, once per routed
                partition and once for the column family). The token
                histogram's launch on the CREATE tokens (7.5 M) and on a
                write's (20,000) vs plain and np.bincount, by events and on
                the device, torch.bincount in turns, bound. Then "orders_pv":
                TPC-H SF 1 at partitions=2 with views=True in orders'
                layouts, one batch of 256 against its oracle, view hits > 0
  9. groups     one fresh read_many batch of 256; then the fused scan and
                the select compaction on each replica group that batch
                formed (the launches read_many makes), each vs its plain
                version: counts and indices equal, sums within rtol 1e-5 /
                atol 1e-3; per-group times and bounds, summed per batch
                (the fused scan's bound counts the (query, tile) pairs its
                skip rule leaves live, live_tile_pairs; their share per
                group goes into the read_layer line); the select
                compaction's three passes timed apart under torch.profiler
                (bench.select_slab.select_group), its bound counted from
                the (query, segment) pairs its skip rule leaves live
                (select_live_pairs); those pairs and the (query, block)
                pairs holding a match go into the read_layer line
  10. views     CREATE "orders_v" on the same rows with views=True (same
                layouts, every view verified), the same 4 batches, the
                wide batch and scalar reads (most sums and counts served
                by the views), the same 10 writes (the compaction rebuilds
                every view, the 2 writes after it leave runs, so view reads
                rescan boundary blocks across several run windows); every
                answer against the brute-force oracle and every
                view-served answer against the fused kernel on the same
                replica table, bit for bit, before the writes, after the
                compaction and after the last write; select_compact vs its
                plain version on the replica groups of the first batch and
                of the batch after the writes (run stacks)
  11. view_kernels  block_sums on a full SF 5 tile (whole and a flush's
                tail) and boundary_block_sums on the pairs one fresh batch
                forms, each vs its plain version; block_sums also bit for
                bit vs the contract's in-block order written out in
                PyTorch (block_partials_card_order); times, bounds, the
                library yardstick; then the bit identity of view and fused
                scan, and of block_sums and the card order, on a table
                whose schema shrinks the staging tile
  12. breakdown  one fresh batch on orders, orders_v and orders_p: the engine's spans
                on the host clock, and a second under torch.profiler (the
                fused scan's scan_partials and scan_fold apart)
  13. availability  orders_v: a corrupted view partial and a deleted view,
                reported and healed by scrub, then a batch whose view-served
                answers equal the fused kernel bit for bit. orders_p: a
                QUORUM batch, one node's loss (reads routed around it) and
                recovery across its partitions. orders: a fresh batch at
                ONE, QUORUM and ALL (no digest mismatch unless the replicas
                disagree in float32 on a sum, counted first); one flipped
                exponent bit in a replica's resident value tile, unseen by
                the checksum, found by an ALL read of that row (one digest
                mismatch, one read repair, the repaired state a fresh
                build); a transient fail_node, two writes of 20,000 rows,
                node_up replaying exactly those rows, every replica's
                fingerprint equal; a node loss rebuilt from the log, then
                from a survivor, each rebuilt state array-equal to a fresh
                build of the same rows; a hedged batch with one node slowed
                past hedge_ratio; a failover with read_fault_budget = 1.
                Every answer against the oracle
  14. migration  every node up first. orders_p: split_partition of
                partition 0 at its median token, a batch of 256; the
                merge back (the ring as CREATE made it), a batch; the drift
                trigger armed at 1.05 (rebalance_imbalance), one routed
                write of 20,000 rows firing exactly one rebalance to a row
                imbalance <= 1.25, a batch. A fresh SF 1, P = 2 views family
                like orders_pv: split, merge, rebalance(exact=False), each
                rebuilding views on the resharded vnodes only (block_sums)
                and keeping the other vnodes' view state, each followed by a
                batch whose view-served partial answers equal the fused
                kernel bit for bit. orders: a serial write of 20,000 rows,
                then write(parallel=True) of 20,000 (three replica flushes
                on the pool), fingerprints equal; read_many with deadline_s=0.0 refused and counted
                once, with deadline_s=60.0 equal to a call without it.
                Every answer against the oracle; device allocation before,
                at the peak and after the split, the drift rebalance and the
                views steps, each back within the new rows' bytes + 64 MiB
  15. frontdoor  the port's FrontDoor with a perf-counter Tracer over
                orders as phase 14 left it (result cache off for the phase):
                1,024 requests from read_batches (per 256: 128 sums, 64
                counts, 64 selects), 30 % at QUORUM, three priorities, on
                seeded Poisson arrivals fixed in seconds (mean gap 0.1 ms,
                0.01 ms in the middle third, the burst window; a budget of
                10 ms each); max_batch 64, max_wait 0.4 ms, max_queue 256. Every answer against the oracle, the statuses equal to
                the counters, every launched batch's tree reaching
                kernel.scan_launch, queue + service = latency, every tree
                dumped as JSON lines and loaded back, the slow-query log
                written to chiprun_out/frontdoor_slow.jsonl and rendered by
                render_report into chiprun_out/frontdoor_report.txt
  16. chaos     ChaosHarness(views=True) for seeds 0 and 1 (20 steps, 2,000
                rows, P = 4, RF 3, 6 nodes; victim and oracle port engines on
                the card, device-resident with views), each report's
                acceptance property, every replica resident, the views hit
                and rebuilt; then on each healed victim a battery of 24
                view-eligible range sums and counts at QUORUM against the
                oracle (boundary rescans; the float32 digest mismatches and
                repairs, and the battery's sums not bit-equal, counted); then
                OverloadHarness for seed 0 (400 requests, its acceptance
                property)
  17. lm_serve  the LM serving path (repro_torch.models, plain PyTorch, no
                kernel of its own; launch counts from 0 and checked to stay
                0), after the engines are released: the ten SMOKE configs
                in float32, prefill and three decode steps on the card
                against the port's CPU path (logits within 1e-4, caches
                within 1e-5, the SSD state within 1e-5 of its largest
                magnitude, MoE expert choices equal); serve_batch on
                starcoder2-3b at full
                width in bfloat16 (batch 8, prompt 1024, 32 greedy tokens,
                q_chunk 512, kv_chunk 1024), twice on the same weights
                (logits finite, tokens in the vocabulary); the full width
                in float32, prefill over 129 positions against prefill over
                128 and one decode step, B = 2, under the reference's 5e-3;
                walls, decode tokens/s, parameter and cache bytes, peak
                device memory; one prefill and 8 decode steps under
                torch.profiler (device busy time, events, kernels); then,
                at published widths in bfloat16, each model built and freed
                in turn, serve_batch on qwen2-moe-a2.7b (B 8 x 1024, 32
                tokens; each MoE layer's capacity and dropped share at
                prefill and decode), mamba2-780m (B 8 x 1024, 32 tokens;
                the float32 decode check at full width, B 2, 129
                positions), hymba-1.5b (B 8 x 2048, 32 tokens; a windowed
                layer against its global twin) and deepseek-v3-671b cut to
                its 3 dense and 1 MoE layer (B 4 x 1024, 16 tokens); each
                with 2 decode steps under torch.profiler (and the prefill,
                for MoE); the MoE routing from a second, untimed serve_batch
  18. lm_train  the LM training path (repro_torch.training, data,
                checkpoint, launch.train; plain PyTorch, launch counts
                from 0 and checked to stay 0): the ten SMOKE configs in
                float32, the loss, gradients and one train step on the card
                against the CPU from the same weights and batch (loss
                within 1e-5, gradients within 1e-5 of their largest
                magnitude, MoE expert choices equal, stepped parameters
                within twice the learning rate); run_training on
                starcoder2-3b at full width with the reference's loop
                defaults (8 x 256 tokens from the HR pipeline, AdamW, remat
                dots, warmup 20) for 8 steps, no checkpoint written (losses
                finite, step 1's within 1.5 of ln V), then a warm step of a
                fresh model (its parameters must move) and one step under
                torch.profiler; the reference test's tiny config: failure
                recovery (14 steps, one recovery), resume (6, then 9), and
                the recovery run's checkpoint restored on the CPU and on
                the card to its own bytes, rewritten from the CPU to the
                same files
  19. mesh      the mesh placements (repro_torch.parallel.sharding, the
                model's sequence-sharded decode and MoE regions; plain
                PyTorch, launch counts from 0 and checked to stay 0) on a
                one-rank ("data", "model") = (1, 1) DeviceMesh over NCCL,
                each run held to its twin without a mesh and timed beside
                it: one make_train_step step of starcoder2-3b at full width
                (bfloat16, 8 x 256, AdamW, remat dots) from the same weights
                and batch (loss within 1e-5 relative, stepped parameters
                within 1e-5 where both gradients exceed 1e-5 of the largest
                and within twice the learning rate elsewhere, gradient norm
                within 1e-5 relative), then a warm step of each; serve_batch
                of starcoder2-3b (8 x 1024, 32 tokens) with serve_sharding
                "fsdp" and "tp", and of qwen2-moe-a2.7b at published width
                (8 x 256, 16 tokens) with "tp", the global-EP region: equal
                tokens, no expert choice different; walls, decode tokens/s
                and peak memory of every run
Every kernel wrapper's launch count is set to 0 just before phase 3 and
read after phase 7, just before phase 5 and after it, just before phase 6
and after it, just before each of phase 8's two column families and after
it, just before phase 10 and after it, and just before phases 13, 14, 15
and 16 and after each; phases 5, 6, 8, 13, 14, 15 and 16 count apart and
their counts are restored after them, so the main path's counts hold
phases 3, 4 and 7. Each kernel must have launched on its path (the
row-slab kernels on phase 5's, rows 1-4 on phase 8's, the view kernels on
phase 10's, the fused scan, select compaction, histogram and both view
kernels on phase 13's, the fused scan, select compaction, histogram and
block_sums on phase 14's, the fused scan and select compaction on phase
15's, both view kernels, the merge rank and the histogram on phase 16's);
the row-slab line reports phase 6's launches beside phase 5's, and the
kernels line's launches add phases 13's to 16's to the main path's.
The oracle is a brute-force pass over every generated row on the card
(plain PyTorch masks and float64 sums); checks that launch kernels
(verify_views, the fused comparisons, the select checks) leave the
launch counts untouched. The read_layer line's select_checks hold the
select checks of both column families before and after the writes.

The standard output ends with the kernels line, the per-phase wall times
and per-layer numbers, the views line, the write-kernels line (phase 2's
measurements in full), the row-slab line, the partitions line (CREATE
and HRCA walls, the ring, partition imbalance and rows per partition,
empty-partition skips, batch, write and per-flush walls, launches per
kernel, the token histogram's launch times; ``orders_pv``'s), the
batched-read line, the availability line (walls of the scrub, recovery,
``node_up`` and the QUORUM/ALL batches, the counters each step moved,
the launches, the card), the migration line (each step's host wall,
rows moved, splits and merges, imbalances, device allocation, launches),
the frontdoor line (statuses, counters, p50/p99 latency and queue wait,
group service walls, stage totals, launches, the card), the chaos line
(per views seed its counters, repairs, battery and float32 sum
differences; the overload counters; launches; the card), the lm_serve
line (card against CPU per SMOKE config, the full-width serving runs and
decode checks, memory, per family its run under ``families`` and the
depth cut under ``reduced``, the card), the lm_train line (card against
CPU per SMOKE config; at full width the walls of init and each step, warm
tokens/s, losses, gradient norms, peak memory and the profiled step; the
recovery, resume and checkpoint checks), the mesh line (the mesh, the
train step's gaps, walls and peak memory with and without the mesh, each
serving run's walls, decode tokens/s and peak memory), the card's name
and power limit, and
``{"ok": true, "device": ...}``. The kernels line's ``ecdf_hist`` row
carries the token histogram's launches under ``token_hist``.

Run from the root of a checkout: ``python3 chip_smoke.py``
(``--sf`` and ``--seed`` change the scale factor and the data seed).
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

RTOL, ATOL = 1e-5, 1e-3
BATCH = 256
WRITE_ROWS = 20_000

# kernel name -> (source in the repo, the TPU kernel it replaces)
KERNEL_INFO = {
    "scan_agg_locate": (
        "src/repro_torch/csrc/scan_locate.cu",
        "src/repro/kernels/slab_locate.py:255",
    ),
    "select_compact": (
        "src/repro_torch/csrc/select_compact.cu",
        "src/repro/kernels/slab_locate.py:449",
    ),
    "merge_run_positions": (
        "src/repro_torch/csrc/merge_rank.cu",
        "src/repro/kernels/merge_runs.py:55",
    ),
    "ecdf_hist": (
        "src/repro_torch/csrc/ecdf_hist.cu",
        "src/repro/kernels/ecdf_hist.py:26",
    ),
    "block_sums": (
        "src/repro_torch/csrc/block_sums.cu",
        "src/repro/kernels/block_agg.py:52",
    ),
    "boundary_block_sums": (
        "src/repro_torch/csrc/block_sums.cu",
        "src/repro/kernels/block_agg.py:104",
    ),
    "slab_locate": (
        "src/repro_torch/csrc/slab_rank.cu",
        "src/repro/kernels/slab_locate.py:155",
    ),
    "scan_agg_rowstream": (
        "src/repro_torch/csrc/scan_agg.cu",
        "src/repro/kernels/scan_agg.py:85",
    ),
    "scan_agg_qgrid": (
        "src/repro_torch/csrc/scan_agg.cu",
        "src/repro/kernels/scan_agg.py:279",
    ),
}
# the kernels each path must launch
ORDERS_KERNELS = ("scan_agg_locate", "select_compact", "merge_run_positions", "ecdf_hist")
VIEW_KERNELS = ("block_sums", "boundary_block_sums")
ROW_SLAB_KERNELS = ("slab_locate", "scan_agg_rowstream", "scan_agg_qgrid")
AVAIL_KERNELS = ("scan_agg_locate", "select_compact", "ecdf_hist", "block_sums", "boundary_block_sums")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    from repro_torch.bench.fused_scan import card_line

    return card_line()


class Phases:
    """Wall time of each phase, between CUDA events on the current stream
    (the phase's device work included: each phase ends synchronized)."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    def run(self, name: str, fn, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        self.ms[name] = start.elapsed_time(end)
        print(f"phase {name}: ok, {self.ms[name]:.1f} ms", flush=True)
        return out


def time_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` between CUDA events over ``reps`` calls after one
    warm-up (``bench.fused_scan.events_ms``)."""
    from repro_torch.bench.fused_scan import events_ms

    return events_ms(fn, reps)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time for the work, and what sets it
    (``bench.fused_scan.bound_ms``: one H100 SXM's published peaks)."""
    from repro_torch.bench.fused_scan import bound_ms

    return bound_ms(bytes_moved, ops)


# -- workload -----------------------------------------------------------------


def read_batches(n_rows: int, seed: int):
    """4 batches of 256 drawn from the paper's Q1/Q2 templates: per batch
    128 sums, then 64 counts and 64 selects with the same filters."""
    import repro_torch.core as T
    import repro_torch.core.tpch  # noqa: F401  (T.tpch)

    wl = T.tpch.q1_q2_workload(n_instances=4 * BATCH, seed=seed + 2, n_rows=n_rows)
    batches = []
    for b in range(4):
        qs = wl.queries[b * BATCH : (b + 1) * BATCH]
        batch = list(qs[: BATCH // 2])
        batch += [T.Query(filters=q.filters, agg="count") for q in qs[BATCH // 2 : 3 * BATCH // 4]]
        batch += [T.Query(filters=q.filters, agg="select") for q in qs[3 * BATCH // 4 :]]
        batches.append(batch)
    return batches


def wide_batch():
    """Queries that match thousands of rows spread over the table."""
    import repro_torch.core as T

    R, E = T.Range, T.Eq
    return [
        T.Query(filters={"custkey": R(0, 200)}, agg="select"),
        T.Query(filters={"clerk": E(7)}, agg="select"),
        T.Query(filters={"orderdate": R(100, 101)}, agg="select"),
        T.Query(filters={"clerk": R(5, 6), "orderdate": R(0, 1200)}, agg="select"),
        T.Query(filters={"custkey": R(1000, 90_000)}, agg="sum", value_col="totalprice"),
        T.Query(filters={"clerk": R(0, 40)}, agg="count"),
        T.Query(filters={"orderdate": R(2000, 2406)}, agg="sum", value_col="shippriority"),
        T.Query(filters={"custkey": R(5, 5)}, agg="sum", value_col="totalprice"),  # empty
    ]


# -- brute-force oracle -------------------------------------------------------------


class Oracle:
    """Every row a column family holds, as columns on the card: key
    columns int64, value columns float32 (as stored) widened to float64
    for the sums."""

    def __init__(self, key_cols, value_cols, dev):
        self.keys = {c: torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(dev) for c, v in key_cols.items()}
        self.vals = {
            c: torch.from_numpy(np.asarray(v).astype(np.float32).astype(np.float64)).to(dev)
            for c, v in value_cols.items()
        }

    def mask(self, q, schema) -> torch.Tensor:
        mask = None
        for col, f in q.filters.items():
            lo, hi = f.bounds(schema, col)
            v = self.keys[col]
            m = (v >= lo) & (v < hi)
            mask = m if mask is None else mask & m
        if mask is None:
            mask = torch.ones_like(next(iter(self.keys.values())), dtype=torch.bool)
        return mask

    def rows(self, q, schema, key_names, value_names) -> np.ndarray:
        """The rows ``q`` selects as sorted ``(keys…, values…)`` float64
        rows (values as stored, float32)."""
        mask = self.mask(q, schema)
        cols = [self.keys[c][mask].double() for c in key_names] + [self.vals[c][mask] for c in value_names]
        return sorted_rows(torch.stack(cols, dim=1).cpu().numpy())

    def answer(self, q, schema) -> tuple[int, float]:
        mask = self.mask(q, schema)
        n_match = int(mask.sum())
        total = float(self.vals[q.value_col][mask].sum()) if q.agg == "sum" else 0.0
        return n_match, total


def check_answers(eng, cf_name, pairs, oracle, label):
    """Each (query, (ScanResult, ReadReport)) against the oracle over every
    row the column family holds: counts and rows_matched exact, sums within
    tolerance, rows_scanned equal to the serving replica's host slab and
    select indices equal to its host scan."""
    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    for i, (q, (res, rep)) in enumerate(pairs):
        n_match, want = oracle.answer(q, cf.schema)
        what = f"{label} query {i} ({q.agg}, {q.filters})"
        check(res.rows_matched == n_match, f"{what}: rows_matched {res.rows_matched} != {n_match}")
        table = eng._table(cf, handles[rep.replica_id])
        lo, hi = table.slab(q)
        check(res.rows_scanned == hi - lo, f"{what}: rows_scanned {res.rows_scanned} != {hi - lo}")
        if q.agg == "count":
            check(res.value == n_match, f"{what}: count {res.value} != {n_match}")
        elif q.agg == "sum":
            check(
                math.isclose(res.value, want, rel_tol=RTOL, abs_tol=ATOL),
                f"{what}: sum {res.value} != {want}",
            )
        else:
            host = table._scan_slab(q, lo, hi).selected
            check(
                res.selected is not None and np.array_equal(res.selected, host),
                f"{what}: select indices differ from the host scan",
            )


def sorted_rows(rows: np.ndarray) -> np.ndarray:
    """``rows`` (``[m, c]``) in lexicographic order."""
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def uncounted(fn, *args):
    """``fn(*args)`` with every kernel's launch count restored afterwards:
    launches a check makes are not the main path's."""
    import repro_torch.kernels as K

    saved = {name: k.launches for name, k in K.KERNELS.items()}
    try:
        return fn(*args)
    finally:
        for name, k in K.KERNELS.items():
            k.launches = saved[name]


def own_counts(fn, *args):
    """``fn(*args)`` with every kernel's launch count from 0, the counts
    before restored afterwards: a path whose launches are not the main
    path's. Returns the result and the launches ``fn`` made."""
    import repro_torch.kernels as K

    saved = {name: k.launches for name, k in K.KERNELS.items()}
    for k in K.KERNELS.values():
        k.launches = 0
    try:
        out = fn(*args)
        return out, {name: k.launches for name, k in K.KERNELS.items()}
    finally:
        for name, k in K.KERNELS.items():
            k.launches = saved[name]


def check_partial_view_bits(eng, cf_name, partials, label) -> int:
    """``check_view_bits`` on a partitioned read: each (replica, query,
    partial answer) ``ServedBy`` recorded whose query is eligible for that
    replica's view against the fused kernel on the same table, bit for
    bit. Returns how many partial answers the views served."""
    from repro_torch.kernels import ops

    cf = eng.column_families[cf_name]
    groups: dict[int, tuple] = {}
    for r, q, res in partials:
        if eng._table(cf, r)._view_eligible(q):
            groups.setdefault(r.replica_id, (r, []))[1].append((q, res))
    for r, items in groups.values():
        fused = ops.table_execute_device_many(eng._table(cf, r), [q for q, _ in items])
        for (q, a), b in zip(items, fused):
            check(
                (a.value, a.rows_scanned, a.rows_matched) == (b.value, b.rows_scanned, b.rows_matched),
                f"{label}: view partial {a} != fused {b} for {q.filters} on replica {r.replica_id}",
            )
    return sum(len(items) for _, items in groups.values())


def check_view_bits(eng, cf_name, pairs, label) -> int:
    """Every view-served answer (a sum or count eligible for the view of
    the replica that answered it) against the fused kernel on that replica
    table: value equal under float ``==``, every other ScanResult field
    equal. Returns how many answers the views served."""
    from repro_torch.kernels import ops

    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    groups: dict[int, list] = {}
    for q, (res, rep) in pairs:
        if eng._table(cf, handles[rep.replica_id])._view_eligible(q):
            groups.setdefault(rep.replica_id, []).append((q, res))
    for rid, items in groups.items():
        fused = ops.table_execute_device_many(eng._table(cf, handles[rid]), [q for q, _ in items])
        for (q, a), b in zip(items, fused):
            check(
                (a.value, a.rows_scanned, a.rows_matched, a.selected) == (b.value, b.rows_scanned, b.rows_matched, b.selected),
                f"{label}: view answer {a} != fused {b} for {q.filters}",
            )
    return sum(len(v) for v in groups.values())


# -- phase 2: kernels against their plain versions ---------------------------------------


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_phase(key_cols, value_cols, writes, dev):
    """The write path's kernels on the main path's shapes
    (``repro_torch.bench.write_kernels``): the 9-run stack that compaction
    folds after the 8th write (SF-scale base plus eight appended runs),
    against plain and the host merge order, and a stack of the same shape
    whose appended keys all equal keys of other runs, against plain; a
    write batch's three key columns through ``ecdf_hist`` one by one and
    through the batched call the statistics refresh makes, against plain
    and ``np.bincount``, beside ``torch.bincount`` in turns and an empty
    launch of the same grid. Returns the kernels line's rows and the
    ``write_kernels`` line."""
    import repro_torch.core as T
    from repro_torch.bench import write_kernels as W
    from repro_torch.core.tpch import orders_schema

    table = W.run_stack(key_cols, value_cols, writes[:8], dev)
    st = table._device
    starts, n_rows = st["run_starts"], st["n_rows"]
    check(len(starts) == 9, f"merge: expected 9 runs, got {len(starts)}")
    k_ex = sum(st["col_parts"])
    detail = {}
    try:
        merge = W.merge_case(st["keys"], starts, n_rows, k_ex, row_map=st["row_map"])
        dup_keys, dup_starts, dup_n = W.dup_stack(st["keys"], starts[1], k_ex, run_rows=n_rows - starts[-1])
        del table, st
        detail["merge_dup"] = W.merge_case(dup_keys, dup_starts, dup_n, k_ex)
        del dup_keys
        stats = T.TableStats.from_columns({c: v[:1] for c, v in key_cols.items()}, orders_schema())
        hist = W.hist_case(writes[0][0], stats, dev)
    except AssertionError as e:
        fail(str(e))
    detail["merge"] = merge
    detail["hist"] = hist
    b, by = bound(*W.merge_work(merge["run_rows"], k_ex))
    # the design's own traffic, beside the function's least (the bound)
    design = W.merge_design_bytes(merge["run_rows"], k_ex)
    merge.update(bound_ms=b, design_bytes=design, design_bytes_ms=bound(design, 0)[0])
    rows = {
        "merge_run_positions": dict(
            max_abs_err=merge["max_abs_err"], ms=merge["ms"], device_ms=merge["device_ms"],
            plain_ms=merge["plain_ms"], bound_ms=b, bound_by=by, library_ms=merge["library_ms"],
            per=f"one compaction of {len(starts)} runs, {n_rows} rows",
        ),
    }
    batched = hist["batched"]
    n_cols, n = len(hist["columns"]), hist["rows"]
    b, by = bound(4 * n_cols * n + 4 * sum(hist["n_bins"]), 3 * n_cols * n)
    rows["ecdf_hist"] = dict(
        max_abs_err=batched["max_abs_err"], ms=batched["ms"], device_ms=batched["device_ms"],
        plain_ms=batched["plain_ms"], bound_ms=b, bound_by=by, library_ms=batched["library_ms"],
        empty_launch_ms=hist["empty_launch"]["ms"], empty_launch_device_ms=hist["empty_launch"]["device_ms"],
        per=f"one write batch: {n_cols} columns of {n} rows, one launch",
    )
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows, detail


def group_phase(eng, cf_name, batch, dev) -> tuple[dict, dict]:
    """One fresh ``read_many`` batch, timed on the host clock; then the
    read kernels on each replica group that batch formed (queries grouped
    by the replica that answered them, as ``read_many`` launches them),
    each held against its plain version and timed on CUDA events. The
    kernels' ``ms``, ``plain_ms`` and ``bound_ms`` are sums over the
    batch's groups; the per-group numbers ride along. Also returns the
    read layer's numbers for the batch: its wall, the kernels' share and
    the operand bytes uploaded."""
    from repro_torch.bench.fused_scan import device_ms
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_agg import scan_tile
    from repro_torch.kernels.slab_locate import scan_agg_locate, scan_agg_locate_plain

    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.read_many(cf_name, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(batch, out):
        groups.setdefault(rep.replica_id, []).append(q)

    scan_rows, sel_rows, live_rows = [], [], {}
    upload_bytes = 0
    cross_ops = cross_bytes = 0.0
    for rid, qs in groups.items():
        table = eng._table(cf, handles[rid])
        st = table._device
        cp, n, n_vals = st["col_parts"], st["n_rows"], st["n_value_rows"]
        k_ex = sum(cp)
        d = ops.device_query_operands(table, qs)
        upload_bytes += sum(t.numel() * t.element_size() for t in d.values())
        args = (d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"], d["sel"])

        def scan(args=args):
            return scan_agg_locate(st["keys"], st["values_tile"], *args, col_parts=cp, n_vals=n_vals)

        def scan_plain():
            return scan_agg_locate_plain(st["keys"], st["values_tile"][:n_vals], *args, col_parts=cp)

        ks, kp = scan(), scan_plain()
        what = f"scan_agg_locate (replica {rid}, {len(qs)} queries)"
        check(torch.equal(ks[1], kp[1]) and torch.equal(ks[2], kp[2]), f"{what}: counts differ from plain")
        check(bool(torch.allclose(ks[0], kp[0], rtol=RTOL, atol=ATOL)), f"{what}: sums differ from plain")
        check(all(torch.equal(a, b) for a, b in zip(ks, scan())), f"{what}: not deterministic")
        q = len(qs)
        work, live = fused_scan_work(st, d, scan_tile(k_ex, n_vals))
        live_rows[str(rid)] = live
        # every (row, query) pair of the windows, as the scan evaluated
        # them before it skipped pairs
        pairs = int((d["limits"][:, 1] - d["limits"][:, 0]).sum())
        cross_bytes += 4 * n * (k_ex + n_vals) + q * (16 * k_ex + 12) + 12 * q
        cross_ops += pairs * (3 + 4 * k_ex)
        one = tuple(a[:1] for a in args)
        scan_rows.append(dict(
            replica=rid, queries=q, max_abs_err=max_abs_diff(ks[0], kp[0]), ms=time_ms(scan, 10),
            device_ms=device_ms(scan, 10, ("scan_partials", "scan_fold")),
            fold_device_ms=device_ms(scan, 10, ("scan_fold",)),
            plain_ms=time_ms(scan_plain, 2), bound_ms=bound(*work)[0], work=work,
            q1_ms=time_ms(lambda: scan(one), 10),
        ))

        # select compaction on the group's selects with matches
        row = select_group(st, d, [qq.agg for qq in qs], ks[1])
        if row is not None:
            sel_rows.append(dict(replica=rid, **row))
    check(len(sel_rows) > 0, "select_compact: no group of the batch had selects with matches")

    def summed(rows):
        """The batch's launches together: times summed, and the bound of
        their bytes and operations summed."""
        b, by = bound(sum(r["work"][0] for r in rows), sum(r["work"][1] for r in rows))
        out = dict(
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows), bound_ms=b, bound_by=by, library_ms=None,
            per=f"read_many batch of {len(batch)} ({len(rows)} launches)",
            groups=[{k: v for k, v in r.items() if k not in ("work", "live")} for r in rows],
        )
        for key in ("device_ms", "fold_device_ms"):
            if all(key in r for r in rows):
                out[key] = sum(r[key] for r in rows)
        if all("pass_device_ms" in r for r in rows):
            out["pass_device_ms"] = {p: sum(r["pass_device_ms"][p] for r in rows) for p in rows[0]["pass_device_ms"]}
        return out

    report = {"scan_agg_locate": summed(scan_rows), "select_compact": summed(sel_rows)}
    kernel_ms = report["scan_agg_locate"]["ms"] + report["select_compact"]["ms"]
    layer = {
        "read_many_wall_ms": wall_ms, "read_kernels_ms": kernel_ms,
        "read_host_ms": wall_ms - kernel_ms, "operand_upload_bytes": upload_bytes,
        "groups": {str(rid): len(qs) for rid, qs in groups.items()},
        "scan_live_tile_pairs": live_rows,
        "select_groups": [_select_check_row(r["replica"], r) for r in sel_rows],
        "scan_cross_product_bound_ms": bound(cross_bytes, cross_ops)[0],
    }
    torch.cuda.synchronize()
    return report, layer


def select_group(st, d, aggs, matched) -> dict | None:
    """``bench.select_slab.select_group`` on one replica group's selects
    with matches (the launch ``read_many`` makes after the fused scan, whose
    ``matched`` counts size it): held equal to its plain version, timed by
    CUDA events and under ``torch.profiler`` (its three passes apart), with
    its bound counted from the pairs its skip rule leaves live. The
    measured numbers and ``bound_ms`` come back as they go into the
    kernels line; ``work`` and ``live`` (the live pairs, for the read
    layer's line) ride along. None if the group has no select with a
    match."""
    from repro_torch.bench.select_slab import select_group as measure

    try:
        row = measure(st, d, aggs, matched)
    except AssertionError as e:
        fail(str(e))
    if row is not None:
        row["bound_ms"] = bound(*row["work"])[0]
    return row


def select_check(eng, cf_name, batch, out, dev) -> list:
    """``select_group`` on every replica group of an answered ``read_many``
    batch (``out``: its answers, whose reports say which replica served
    each query), its launches left out of the path's counts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.slab_locate import scan_agg_locate

    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(batch, out):
        groups.setdefault(rep.replica_id, []).append(q)
    rows = []
    for rid, qs in sorted(groups.items()):
        st = eng._table(cf, handles[rid])._device
        d = ops.device_query_operands(eng._table(cf, handles[rid]), qs)
        _, matched, _ = uncounted(lambda: scan_agg_locate(
            st["keys"], st["values_tile"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"],
            d["sel"], col_parts=st["col_parts"], n_vals=st["n_value_rows"],
        ))
        row = uncounted(select_group, st, d, [q.agg for q in qs], matched)
        if row is not None:
            rows.append(_select_check_row(rid, row))
    check(len(rows) > 0, f"{cf_name}: no group of the batch had selects with matches")
    return rows


def _select_check_row(rid, row) -> dict:
    """One group's select check as the read layer's line holds it: the
    measured numbers, the bound and the live pairs, without ``work``."""
    return dict(replica=rid, **{k: v for k, v in row.items() if k not in ("replica", "work", "live")}, **row["live"])


def fused_scan_work(st, d, tile) -> tuple[tuple[float, float], dict]:
    """Bytes and operations the fused scan needs on a group's operands,
    counted from the (query, tile) pairs its skip rule leaves live
    (``live_tile_pairs``): the key lanes of the table's rows once, the
    value row of each (tile, value row) some live pair takes once, the
    operands and the outputs once; the predicate for every row of a live
    pair inside its query's window. Also the live share."""
    from repro_torch.kernels.slab_locate import live_tile_pairs

    n, k_ex = st["n_rows"], sum(st["col_parts"])
    live = live_tile_pairs(
        st["keys"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"],
        col_parts=st["col_parts"], n_rows=n, tile=tile,
    )
    q, n_tiles = live.shape[0], -(-n // tile)
    start = torch.arange(live.shape[1], device=live.device, dtype=torch.int64) * tile
    lim = d["limits"].long()
    inside = (torch.minimum(start + tile, lim[:, 1:2].clamp(max=n)) - torch.maximum(start, lim[:, 0:1])).clamp(min=0)
    pair_rows = int((inside * live).sum())
    tile_rows = (torch.minimum(start + tile, torch.full_like(start, n)) - start).clamp(min=0)
    value_bytes = sum(
        4 * int(tile_rows[live[d["sel"] == v].any(dim=0)].sum()) for v in torch.unique(d["sel"]).tolist()
    )
    work = (4 * n * k_ex + value_bytes + q * (16 * k_ex + 12) + 12 * q, pair_rows * (3 + 4 * k_ex))
    share = dict(
        queries=q, tiles=n_tiles, tile=tile, live_pairs=int(live.sum()),
        live_share=int(live.sum()) / (q * n_tiles), live_rows=pair_rows,
    )
    return work, share


def row_slab_batch(batch):
    """The fresh batch with its selects turned into counts: the row-slab
    scans serve sums and counts only."""
    import repro_torch.core as T

    return [q if q.agg != "select" else T.Query(filters=q.filters, agg="count") for q in batch]


def host_slabs(table, batch) -> np.ndarray:
    """The host searchsorted's slabs: ``slab_many`` of a host twin."""
    import repro_torch.core as T

    return T.SortedTable(table.layout, table.schema, table.key_cols, table.value_cols, table.packed).slab_many(batch)


def row_slab_phase(eng, cf_name, batch, oracle, dev) -> dict:
    """The row-slab read path on every replica of ``cf_name`` while each
    holds one sorted run: ``slab_many`` on the device against the host
    searchsorted, ``table_scan_device_many`` on both grids and with
    ``slabs=None``, and one ``table_scan_device``, every answer against the
    oracle. Returns the phase's walls."""
    from repro_torch.kernels import ops

    cf = eng.column_families[cf_name]
    sum_idx = [i for i, q in enumerate(batch) if q.agg == "sum"]
    sums = [batch[i] for i in sum_idx]
    walls = []
    for r in cf.replicas:
        table = eng._table(cf, r)
        check(table._device["n_runs"] == 1, f"replica {r.replica_id} holds more than one run")
        what = f"row_slab (replica {r.replica_id})"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slabs = table.slab_many(batch)
        t1 = time.perf_counter()
        rows = ops.table_scan_device_many(table, batch, slabs=slabs)
        t2 = time.perf_counter()
        qrows = ops.table_scan_device_many(table, sums, slabs=slabs[sum_idx], grid="queries_outer")
        t3 = time.perf_counter()
        located = ops.table_scan_device_many(table, batch)
        t4 = time.perf_counter()
        one = ops.table_scan_device(table, batch[0])
        walls.append(dict(
            replica=r.replica_id, slab_many_ms=(t1 - t0) * 1e3, rows_outer_ms=(t2 - t1) * 1e3,
            queries_outer_ms=(t3 - t2) * 1e3, rows_outer_device_slabs_ms=(t4 - t3) * 1e3,
        ))
        check(np.array_equal(slabs, host_slabs(table, batch)), f"{what}: slab_many differs from the host searchsorted")
        check(located == rows, f"{what}: slabs=None answers differ from the located slabs'")
        check(one == rows[0], f"{what}: table_scan_device differs from the batch")
        for i, (q, (value, count)) in enumerate(zip(batch, rows)):
            n_match, want = oracle.answer(q, cf.schema)
            check(count == n_match, f"{what} query {i}: count {count} != {n_match}")
            if q.agg == "sum":
                check(math.isclose(value, want, rel_tol=RTOL, abs_tol=ATOL), f"{what} query {i}: sum {value} != {want}")
            else:
                check(value == n_match, f"{what} query {i}: count value {value} != {n_match}")
        check([c for _, c in qrows] == [rows[i][1] for i in sum_idx], f"{what}: queries-outer counts differ")
        for (a, _), i in zip(qrows, sum_idx):
            check(math.isclose(a, rows[i][0], rel_tol=RTOL, abs_tol=ATOL), f"{what}: queries-outer sum {a} != {rows[i][0]}")
    torch.cuda.synchronize()
    return dict(queries=len(batch), sums=len(sums), answers_checked=len(batch) * len(walls), walls=walls)


def row_slab_kernel_phase(eng, cf_name, batch, dev) -> tuple[dict, list, dict]:
    """The three row-slab kernels on each replica's launches of the
    row_slab phase, against their plain versions on the same CUDA tensors,
    timed beside their bounds (sums over the three replicas' launches) and,
    for slab_locate, ``torch.searchsorted`` on the packed key
    (``bench.select_slab.slab_locate_turns``). The two scans are measured
    by ``bench.row_slab``: by events and under the profiler, pass by pass,
    beside the same launch with every slab empty, their bound over the
    int32 rate too. Returns the kernels' rows; per replica, the bytes the
    queries-outer scan reads by design (each query its own slab's rows);
    and slab_locate's dependent rounds per replica, the latency of one
    dependent load (``bench.select_slab.load_latency_ns``) and the latency
    bound they give."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.scan_agg import scan_agg_qgrid_plain, scan_agg_rowstream_plain
    from repro_torch.bench.row_slab import int_bound_ms, qgrid_case, qgrid_design_bytes, rowstream_case, slab_scan_work
    from repro_torch.bench.select_slab import LATENCY_BUFFERS, load_latency_ns, slab_locate_turns

    cf = eng.column_families[cf_name]
    sum_idx = [i for i, q in enumerate(batch) if q.agg == "sum"]
    rows = {name: [] for name in ROW_SLAB_KERNELS}
    by_design = []  # the queries-outer scan's traffic, each query its slab's rows
    rounds = []  # slab_locate's dependent rounds, and a binary search's
    for r in cf.replicas:
        table = eng._table(cf, r)
        st = table._device
        cp, n_vals, lanes = st["col_parts"], st["n_value_rows"], sum(st["col_parts"])
        keys, tile = st["keys"], st["values_tile"]
        d = ops.device_query_operands(table, batch)
        what = f"replica {r.replica_id}"

        # slab_locate, and torch.searchsorted on the packed key as yardstick
        try:
            loc, got = uncounted(slab_locate_turns, table, batch)
        except AssertionError as e:
            fail(f"{e} ({what})")
        host = host_slabs(table, batch)
        check(np.array_equal(got.cpu().numpy(), host), f"slab_locate ({what}): ranks differ from the host searchsorted")
        rounds.append(dict(replica=r.replica_id, **loc.pop("rounds")))
        rows["slab_locate"].append(dict(replica=r.replica_id, bound_ms=bound(*loc["work"])[0], **loc))

        # rows outer on the located slabs, queries outer on the batch's sums
        # (one value row): each against plain and run to run
        slabs = got
        try:
            rs, ks = uncounted(rowstream_case, st, d, slabs)
            qg, kq = uncounted(qgrid_case, st, d, slabs, sum_idx)
        except AssertionError as e:
            fail(f"{e} ({what})")
        check(torch.equal(kq[:, 1], ks[sum_idx, 1]), f"scan_agg_qgrid ({what}): counts differ from rows outer")

        def rs_plain(a=(keys, tile[:n_vals], d["res_lo"], d["res_hi"], slabs, d["sel"]), cp=cp):
            return scan_agg_rowstream_plain(*a, col_parts=cp)

        idx = torch.tensor(sum_idx, device=dev)
        g_args = (
            keys, tile[int(d["sel"][sum_idx[0]])], *(x[idx].contiguous() for x in (d["res_lo"], d["res_hi"], slabs))
        )

        def qg_plain(a=g_args):
            return scan_agg_qgrid_plain(*a)

        sel_np = d["sel"].cpu().numpy()
        for name, m, plain, sel_idx in (
            ("scan_agg_rowstream", rs, rs_plain, slice(None)), ("scan_agg_qgrid", qg, qg_plain, sum_idx)
        ):
            work = slab_scan_work(host[sel_idx], sel_np[sel_idx], lanes)
            rows[name].append(dict(
                replica=r.replica_id, queries=m["queries"], max_abs_err=m["max_abs_err"], ms=m["ms"],
                device_ms=m["device_ms"], device_parts_ms=m["device_parts_ms"], floor_ms=m["floor"]["ms"],
                floor_device_ms=m["floor"]["device_ms"], plain_ms=time_ms(plain, 2), bound_ms=bound(*work)[0],
                int_bound_ms=int_bound_ms(work[1]), library_ms=None, work=work,
            ))
        design = qgrid_design_bytes(host[sum_idx], lanes)
        by_design.append(dict(replica=r.replica_id, bytes=design, bytes_ms=bound(design, 0)[0]))
        rows["scan_agg_qgrid"][-1].update(design_bytes=design, design_bytes_ms=bound(design, 0)[0])

    report = {}
    summed = ("device_ms", "library_device_ms", "floor_ms", "floor_device_ms", "int_bound_ms", "design_bytes",
              "design_bytes_ms")
    for name, per in rows.items():
        b, by = bound(sum(x["work"][0] for x in per), sum(x["work"][1] for x in per))
        lib = [x["library_ms"] for x in per]
        report[name] = dict(
            max_abs_err=max(x["max_abs_err"] for x in per), ms=sum(x["ms"] for x in per),
            plain_ms=sum(x["plain_ms"] for x in per), bound_ms=b, bound_by=by,
            library_ms=None if None in lib else sum(lib),
            **{k: sum(x[k] for x in per) for k in summed if k in per[0]},
            per=f"batch of {per[0]['queries']} on each of {len(per)} replicas ({len(per)} launches)",
            groups=[{k: v for k, v in x.items() if k != "work"} for x in per],
        )
        if "device_parts_ms" in per[0]:
            report[name]["device_parts_ms"] = {
                k: sum(x["device_parts_ms"].get(k, 0.0) for x in per) for k in per[0]["device_parts_ms"]
            }
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # slab_locate's latency bound: its dependent rounds times one dependent
    # load's latency, from device memory and from L2
    latency = {name: load_latency_ns(dev, n_bytes) for name, n_bytes in LATENCY_BUFFERS.items()}
    torch.cuda.empty_cache()
    most = max(x["kary"] for x in rounds)
    slab = dict(
        rounds=rounds, load_latency_ns=latency,
        latency_bound_ms={name: most * ns * 1e-6 for name, ns in latency.items()},
    )
    return report, by_design, slab


def views_phase(base_eng, key_cols, value_cols, writes, batches, oracles, dev) -> dict:
    """The views path, its launch counts set to 0 first: CREATE "orders_v"
    with views on the same rows, the orders reads, the 10 writes. Returns
    the path's numbers and its engine."""
    import repro_torch.core as T
    import repro_torch.kernels as K
    from repro_torch.core.storage.views import verify_views

    for fn in K.KERNELS.values():
        fn.launches = 0
    n_rows = len(key_cols["custkey"])
    eng = T.HREngine(n_nodes=6, device=dev)
    t = time.perf_counter()
    eng.create_column_family(
        "orders_v", key_cols, value_cols, replication_factor=3, mechanism="HR",
        workload=T.tpch.q1_q2_workload(n_rows=n_rows), schema=T.tpch.orders_schema(),
        device_resident=True, views=True,
    )
    torch.cuda.synchronize()
    create_ms = (time.perf_counter() - t) * 1e3
    check(eng.layouts("orders_v") == base_eng.layouts("orders"), "orders_v layouts differ from orders'")
    cf = eng.column_families["orders_v"]

    def verify_all(label):
        for r in cf.replicas:
            table = eng._table(cf, r)
            check(table.has_views and uncounted(verify_views, table), f"{label}: replica {r.replica_id} view stale")

    def checked(pairs, oracle, label) -> int:
        uncounted(check_answers, eng, "orders_v", pairs, oracle, label)
        return uncounted(check_view_bits, eng, "orders_v", pairs, label)

    verify_all("create")
    bl = K.KERNELS["boundary_block_sums"]
    per_batch, served = [], 0
    for b, batch in enumerate(batches):
        before = (eng.stats["view_hits"], eng.stats["view_boundary_rows"], bl.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.read_many("orders_v", batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        hits = eng.stats["view_hits"] - before[0]
        n_agg = sum(q.agg in ("sum", "count") for q in batch)
        check(hits * 2 > n_agg, f"batch {b}: only {hits} of {n_agg} sums and counts were view hits")
        per_batch.append(dict(
            wall_ms=wall, queries=len(batch), view_hits=hits,
            view_boundary_rows=eng.stats["view_boundary_rows"] - before[1],
            boundary_launches=bl.launches - before[2],
        ))
        served += checked(list(zip(batch, out)), oracles[0], f"views batch {b}")
        if b == 0:
            selects = {"orders_v_before_writes": select_check(eng, "orders_v", batch, out, dev)}
    wide = wide_batch()
    served += checked(list(zip(wide, eng.read_many("orders_v", wide))), oracles[0], "views wide")
    scalar = batches[1][::16]
    served += checked([(q, eng.read("orders_v", q)) for q in scalar], oracles[0], "views scalar")
    check(served > 0, "no answer was served by a view")

    write_ms = []
    for i, (wk, wv) in enumerate(writes):
        t = time.perf_counter()
        eng.write("orders_v", wk, wv)
        torch.cuda.synchronize()
        write_ms.append((time.perf_counter() - t) * 1e3)
        if i == 7:
            check(eng.stats["compactions"] >= 3, "the 8th write did not compact orders_v")
            check(eng.stats["view_rebuilds"] >= 3, f"view_rebuilds {eng.stats['view_rebuilds']} < 3")
            verify_all("after the compaction")
            out = eng.read_many("orders_v", batches[3])
            served_c = checked(list(zip(batches[3], out)), oracles[1], "views after the compaction")
            check(served_c > 0, "no view hit after the compaction")
    check(all(eng._table(cf, r)._device["n_runs"] == 3 for r in cf.replicas), "orders_v holds no appended runs")
    verify_all("after the last write")
    launches_before = bl.launches
    out = eng.read_many("orders_v", batches[2])
    check(bl.launches > launches_before, "no boundary rescan after the writes")
    served_w = checked(list(zip(batches[2], out)), oracles[2], "views after the writes")
    selects["orders_v_after_writes"] = select_check(eng, "orders_v", batches[2], out, dev)
    served_w += checked(list(zip(wide, eng.read_many("orders_v", wide))), oracles[2], "views wide after the writes")
    check(served_w > 0, "no view hit after the writes")

    launches = {name: fn.launches for name, fn in K.KERNELS.items()}
    for name in VIEW_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the views path")
    stats = eng.stats
    return eng, dict(
        create_ms=create_ms, batches=per_batch, write_ms=write_ms, launches=launches,
        view_hits=stats["view_hits"], view_boundary_rows=stats["view_boundary_rows"],
        view_rebuilds=stats["view_rebuilds"], compactions=stats["compactions"],
        result_cache_hits=stats["result_cache_hits"], select_checks=selects,
    )


def view_kernel_phase(eng, fresh_batch, dev) -> dict:
    """The view kernels at the views path's shapes, each vs its plain
    version: block_sums over a replica's whole SF 5 tile and over the tail
    a 20,000-row flush refolds; boundary_block_sums on the pairs each
    replica group of one fresh batch forms (timed per launch, summed per
    batch). Then the bit identity of view and fused scan on a table whose
    schema shrinks the fused scan's staging tile."""
    import repro_torch.core as T
    from repro_torch.bench.fused_scan import device_ms
    from repro_torch.core.storage.memtable import sort_run
    from repro_torch.core.storage.views import plan_view_batch, verify_views
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_agg import (
        block_partials_card_order, block_sums, block_sums_plain, boundary_block_sums,
        boundary_block_sums_plain, scan_tile, scan_tile_plain,
    )

    cf = eng.column_families["orders_v"]
    handles = {r.replica_id: r for r in cf.replicas}
    st = eng._table(cf, cf.replicas[0])._device
    tile, n, nv, k_ex = st["values_tile"], st["n_rows"], st["n_value_rows"], sum(st["col_parts"])
    nb = -(-tile.shape[1] // 8192)
    args = dict(n_rows=n, block_n=8192, n_vals=nv, n_key_lanes=k_ex)
    report = {}

    def full():
        return block_sums(tile, **args)

    def full_plain():
        return block_sums_plain(tile, n_rows=n, n_vals=nv)

    def full_library():
        return tile[:nv].view(nv, nb, 8192).sum(dim=2)

    got, want = full(), full_plain()
    check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)), "block_sums: differs from plain")
    check(torch.equal(got, full()), "block_sums: not deterministic")
    first = (n - WRITE_ROWS) // 8192

    def tail():
        return block_sums(tile, first_block=first, **args)

    # the contract's in-block order, written out in PyTorch: bit for bit
    rows = scan_tile(k_ex, nv)
    check(rows == scan_tile_plain(k_ex, nv), f"scan_tile {rows} != the frozen formula's {scan_tile_plain(k_ex, nv)}")
    tail_got = tail()
    for v in range(nv):
        order = block_partials_card_order(tile[v], n, rows)
        check(torch.equal(got[v], order), f"block_sums: value row {v} differs from the card order")
        check(torch.equal(tail_got[v], order[first:]), f"block_sums tail: value row {v} differs from the card order")

    b_full = bound(4 * nv * n + 4 * nv * nb, nv * n)
    b_tail = bound(4 * nv * (n - first * 8192) + 4 * nv * (nb - first), nv * (n - first * 8192))
    report["block_sums"] = dict(
        max_abs_err=max_abs_diff(got, want), ms=time_ms(full, 20), device_ms=device_ms(full, 20, ("block_sums",)),
        plain_ms=time_ms(full_plain, 3), bound_ms=b_full[0], bound_by=b_full[1],
        library_ms=time_ms(full_library, 20), per=f"full build, {n} rows x {nv} value rows ({nb} blocks)",
        tail=dict(
            blocks=nb - first, ms=time_ms(tail, 50), device_ms=device_ms(tail, 50, ("block_sums",)),
            bound_ms=b_tail[0], bound_by=b_tail[1],
        ),
        scan_tile=rows, card_order_blocks=nv * nb,
    )

    # boundary pairs of one fresh batch, per replica group
    torch.cuda.synchronize()
    out = eng.read_many("orders_v", fresh_batch)
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(fresh_batch, out):
        table = eng._table(cf, handles[rep.replica_id])
        if table._view_eligible(q):
            groups.setdefault(rep.replica_id, []).append(q)
    rows = []
    for rid, qs in groups.items():
        table = eng._table(cf, handles[rid])
        s2 = table._device
        plan = plan_view_batch(table, qs)
        p = int(plan["pair_sel"].shape[0])
        if p == 0:
            continue
        ops_args = (plan["pair_sel"], plan["pair_block"], plan["pair_lo"], plan["pair_hi"])
        bargs = dict(n_rows=s2["n_rows"], block_n=8192, n_vals=s2["n_value_rows"], n_key_lanes=sum(s2["col_parts"]))
        t_ops = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev) for a in ops_args]

        def bnd(s2=s2, ops_args=ops_args, bargs=bargs):
            return boundary_block_sums(s2["values_tile"], *ops_args, **bargs)

        def bnd_plain(s2=s2, t_ops=t_ops):
            return boundary_block_sums_plain(s2["values_tile"], *t_ops, n_rows=s2["n_rows"])

        kb, kp = bnd(), bnd_plain()
        check(bool(torch.allclose(kb, kp, rtol=RTOL, atol=ATOL)), f"boundary_block_sums (replica {rid}): differs from plain")
        check(torch.equal(kb, bnd()), "boundary_block_sums: not deterministic")
        # rows the rescans read: each pair's in-window live rows of its block
        b0 = plan["pair_block"][:, None] * 8192
        b1 = np.minimum(b0 + 8192, s2["n_rows"])
        read = np.maximum(np.minimum(plan["pair_hi"], b1) - np.maximum(plan["pair_lo"], b0), 0).sum()
        w = plan["pair_lo"].shape[1]
        work = (4 * int(read) + p * (8 + 8 * w) + 4 * p, int(read) * (1 + 2 * w))
        rows.append(dict(
            replica=rid, pairs=p, windows=w, rows_read=int(read), max_abs_err=max_abs_diff(kb, kp),
            ms=time_ms(bnd, 20), device_ms=device_ms(bnd, 20, ("boundary_sums",)), plain_ms=time_ms(bnd_plain, 3),
            bound_ms=bound(*work)[0], work=work,
        ))
    check(len(rows) > 0, "boundary_block_sums: the fresh batch formed no boundary pairs")
    b, by = bound(sum(r["work"][0] for r in rows), sum(r["work"][1] for r in rows))
    report["boundary_block_sums"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=sum(r["ms"] for r in rows),
        device_ms=sum(r["device_ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows), bound_ms=b, bound_by=by, library_ms=None,
        per=f"read_many batch of {len(fresh_batch)} ({len(rows)} launches)",
        groups=[{k: v for k, v in r.items() if k != "work"} for r in rows],
    )

    # a schema whose staging tile is 1024 rows: eight key lanes and fifteen
    # value columns plus the ones row (24 staged words a row)
    rng = np.random.default_rng(7)
    bits = {f"k{i}": 7 for i in range(8)}
    layout = tuple(bits)
    n_small, n_vcols = 300_000, 15

    def cols(m):
        kc = {c: rng.integers(0, 64, m, dtype=np.int64) for c in bits}
        return kc, {f"v{i}": rng.uniform(-10.0, 100.0, m) for i in range(n_vcols)}

    small = T.SortedTable.from_columns(*cols(n_small), layout, T.KeySchema(dict(bits)))
    small.place_on_device(dev).build_views()
    s3 = small._device
    small_tile = scan_tile(sum(s3["col_parts"]), s3["n_value_rows"])
    check(small_tile < 2048, f"the wide schema's staging tile is {small_tile}, not below 2048")
    small_sums = block_sums(
        s3["values_tile"], n_rows=n_small, block_n=8192, n_vals=s3["n_value_rows"], n_key_lanes=sum(s3["col_parts"]),
    )
    for v in range(s3["n_value_rows"]):
        order = block_partials_card_order(s3["values_tile"][v], n_small, small_tile)
        check(torch.equal(small_sums[v], order), f"small-tile block_sums: value row {v} differs from the card order")
    qs = []
    for i in range(256):
        depth = int(rng.integers(0, 4))
        f = {c: T.Eq(int(rng.integers(0, 64))) for c in layout[:depth]}
        lo = int(rng.integers(0, 64))
        f[layout[depth]] = T.Range(lo, int(rng.integers(lo, 65)))
        qs.append(T.Query(filters=f, agg="sum" if i % 4 else "count", value_col=f"v{i % n_vcols}"))
    compared = 0
    for step in range(3):
        check(verify_views(small), f"small-tile table, step {step}: view stale")
        served = small.execute_many(qs)
        fused = ops.table_execute_device_many(small, qs)
        for q, a, c in zip(qs, served, fused):
            check(
                (a.value, a.rows_scanned, a.rows_matched) == (c.value, c.rows_scanned, c.rows_matched),
                f"small-tile table, step {step}: view {a} != fused {c} for {q.filters}",
            )
        compared += len(qs)
        small = small.merge_run(sort_run(*cols(40_000), layout, small.schema))
    report["small_tile"] = dict(
        rows=n_small, key_lanes=sum(s3["col_parts"]), value_rows=s3["n_value_rows"], scan_tile=small_tile,
        answers_compared=compared, card_order_blocks=int(small_sums.numel()),
    )
    torch.cuda.synchronize()
    return report


class StageClock:
    """A sink for the engine's ``trace=`` spans: host-clock wall per span
    name, summed over the batch. The read path's spans end after their
    results reach the host, so each holds the device work it waited for."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    def child(self, name: str, **_) -> "_Span":
        return _Span(self, name)


class _Span:
    def __init__(self, clock: StageClock, name: str):
        self.clock, self.name, self.t0 = clock, name, time.perf_counter()

    def child(self, name: str, **_) -> "_Span":
        return _Span(self.clock, name)

    def end(self, **_) -> None:
        ms = (time.perf_counter() - self.t0) * 1e3
        self.clock.ms[self.name] = self.clock.ms.get(self.name, 0.0) + ms


def breakdown_phase(targets, n_rows: int, seed: int) -> dict:
    """Where the time of a fresh ``read_many`` batch of 256 goes on each
    column family: the engine's spans on the host clock for one batch, and
    the device's busy time and kernels under ``torch.profiler`` for a
    second one (the profiler's own host cost makes its wall, and the idle
    share it gives, an upper bound)."""
    clocked, profiled = read_batches(n_rows, seed)[:2]
    out = {}
    for label, (eng, cf_name) in targets.items():
        clock = StageClock()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.read_many(cf_name, clocked, trace=clock)
        torch.cuda.synchronize()
        out[label] = {
            "wall_ms": (time.perf_counter() - t) * 1e3,
            "spans_ms": clock.ms,
            "profile": profile_batch(eng, cf_name, profiled),
        }
    return out


def under_profiler(fn, *args) -> tuple[dict, dict]:
    """``fn(*args)`` under ``torch.profiler``: its host wall, the union of
    the device's kernel and copy intervals (busy time), the number of
    device events, and the device time of each kernel by name (the twelve
    longest in the dict, all in the second value). The profiler's own host
    cost inflates the wall, so the idle share it gives is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start) / 1e3
    busy_us, last = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "device_events": len(spans),
        "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms) if spans else None,
        "device_ms_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
    }, by_name


def profile_batch(eng, cf_name, batch) -> dict:
    """One ``read_many`` batch under ``torch.profiler`` (``under_profiler``), the
    fused scan's two kernels (``scan_partials``, ``scan_fold``) apart."""
    prof, by_name = under_profiler(eng.read_many, cf_name, batch)
    prof.pop("device_events")
    fused = {k: sum(ms for name, ms in by_name.items() if k in name) for k in ("scan_partials", "scan_fold")}
    return {"queries": len(batch), **prof, "fused_scan_ms": fused}


# -- phase 8: partitioned column families ---------------------------------------------


class GcClock:
    """Host time the cyclic garbage collector spends inside a ``with``
    block, by generation, from ``gc.callbacks``."""

    def __enter__(self):
        self.ms: dict[int, float] = {}
        gc.callbacks.append(self._tick)
        return self

    def _tick(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            gen = info["generation"]
            self.ms[gen] = self.ms.get(gen, 0.0) + (time.perf_counter() - self._t0) * 1e3

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)


class ServedBy:
    """Which replica served each query of an engine's last read, per
    partition: wraps the engine's ``_execute_group`` (the call every
    (partition, replica) group of ``read_many`` goes through, cache hits
    included) and records each group's replica and query indices, and
    each (replica, query, partial answer) that group kept in ``partials``.
    It only observes. ``read_many`` and ``read`` clear the record first."""

    def __init__(self, eng):
        self.eng = eng
        self.map: dict[int, list] = {}
        self.partials: list = []
        inner = eng._execute_group

        def recording(cf, r, qidx, queries, est_rows, est_costs, results, reports, **kwargs):
            for qi in qidx:
                self.map.setdefault(qi, []).append(r)
            out = inner(cf, r, qidx, queries, est_rows, est_costs, results, reports, **kwargs)
            self.partials.extend(
                (r, queries[qi], results[qi]) for qi in qidx
                if reports[qi] is not None and reports[qi].replica_id == r.replica_id
            )
            return out

        eng._execute_group = recording

    def read_many(self, cf_name, batch, **kwargs):
        self.map, self.partials = {}, []
        return self.eng.read_many(cf_name, batch, **kwargs)

    def read(self, cf_name, q):
        self.map, self.partials = {}, []
        return self.eng.read(cf_name, q)


def check_partitioned(eng, cf_name, pairs, served, oracle, label):
    """Each (query, (ScanResult, ReadReport)) of a partitioned read against
    the oracle over every row the column family holds: rows_matched and
    counts exact, sums within tolerance; rows_scanned the sum of the
    serving replicas' host slabs; select indices equal to the serving
    replicas' host scans offset into the ring-order index space, and the
    rows they name, materialized as ``(keys…, values…)``, equal as a set
    to the rows the oracle selects. ``served`` maps a query's index to
    its serving replicas (``ServedBy.map``)."""
    cf = eng.column_families[cf_name]
    offsets = eng._partition_row_offsets(cf)
    for i, (q, (res, rep)) in enumerate(pairs):
        what = f"{label} query {i} ({q.agg}, {q.filters})"
        n_match, want = oracle.answer(q, cf.schema)
        check(res.rows_matched == n_match, f"{what}: rows_matched {res.rows_matched} != {n_match}")
        reps = sorted(served.get(i, []), key=lambda r: r.partition_id)
        check(len({r.partition_id for r in reps}) == len(reps), f"{what}: a partition served twice")
        if not reps:
            check(rep.replica_id == -1 and res.rows_scanned == 0, f"{what}: no partition served it")
        slabs = [(r, eng._table(cf, r).slab(q)) for r in reps]
        scanned = sum(hi - lo for _, (lo, hi) in slabs)
        check(res.rows_scanned == scanned, f"{what}: rows_scanned {res.rows_scanned} != {scanned}")
        if q.agg == "count":
            check(res.value == n_match, f"{what}: count {res.value} != {n_match}")
        elif q.agg == "sum":
            check(math.isclose(res.value, want, rel_tol=RTOL, abs_tol=ATOL), f"{what}: sum {res.value} != {want}")
        else:
            host = [
                eng._table(cf, r)._scan_slab(q, lo, hi).selected + offsets[r.partition_id]
                for r, (lo, hi) in slabs
            ]
            host = np.concatenate(host) if host else np.empty(0, np.int64)
            check(
                res.selected is not None and np.array_equal(res.selected, host),
                f"{what}: select indices differ from the serving replicas' host scans",
            )
            got = []
            for r, _ in slabs:
                t = eng._table(cf, r)
                local = res.selected[(res.selected >= offsets[r.partition_id]) & (res.selected < offsets[r.partition_id] + len(t))]
                local = local - offsets[r.partition_id]
                got.append(np.stack(
                    [t.key_cols[c][local].astype(np.float64) for c in cf.key_names]
                    + [np.asarray(t.value_cols[c])[local].astype(np.float32).astype(np.float64) for c in cf.value_names],
                    axis=1,
                ))
            got = sorted_rows(np.concatenate(got)) if got else np.empty((0, len(cf.key_names) + len(cf.value_names)))
            check(
                np.array_equal(got, oracle.rows(q, cf.schema, cf.key_names, cf.value_names)),
                f"{what}: the selected rows differ from the oracle's",
            )


def token_hist_row(bins: np.ndarray, n_bins: int, dev) -> dict:
    """The token histogram's launch on ``bins`` (``bench.write_kernels.
    token_hist_case``), its launches left out of the path's counts, with
    its bound: each bin read once and each count written once, three
    operations a token."""
    from repro_torch.bench.write_kernels import token_hist_case

    try:
        row = uncounted(token_hist_case, bins, n_bins, dev)
    except AssertionError as e:
        fail(str(e))
    row["bound_ms"], row["bound_by"] = bound(4 * len(bins) + 4 * n_bins, 3 * len(bins))
    return row


def partitions_phase(key_cols, value_cols, writes, oracles, seed, dev) -> tuple[dict, object]:
    """``orders_p``: the SF 5 ``orders`` rows at P = 4 with token-quantile
    boundaries, RF 3, HR layouts from HRCA over the per-partition blend,
    device-resident; two fresh batches, 16 scalar reads, the 10 writes,
    one more batch, each answer against the oracle (each batch's engine
    spans on the host clock, ``StageClock``, and the garbage collector's
    time in it, ``GcClock``); the token histogram against
    ``np.bincount`` of every committed token; the launches the path made
    (its counts from 0, ``own_counts``). Returns the path's numbers and
    its engine."""
    import repro_torch.core as T
    import repro_torch.kernels as K

    n_rows = len(key_cols["custkey"])
    eng = T.HREngine(n_nodes=6, device=dev)
    served = ServedBy(eng)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cf = eng.create_column_family(
        "orders_p", key_cols, value_cols, replication_factor=3, mechanism="HR",
        workload=T.tpch.q1_q2_workload(n_rows=n_rows), schema=T.tpch.orders_schema(),
        device_resident=True, partitions=4, partition_balance="tokens",
    )
    torch.cuda.synchronize()
    create_ms = (time.perf_counter() - t) * 1e3
    check(len(cf.partitions) == 4 and len(cf.replicas) == 12, "orders_p is not 4 partitions of RF 3")
    for r in cf.replicas:
        check(eng._table(cf, r).device_resident, f"orders_p replica {r.replica_id} is not resident")
    check(K.KERNELS["ecdf_hist"].launches == 1, "CREATE did not put the token histogram on the kernel")
    hist = cf.token_hist
    committed = [cf.ring.tokens(key_cols, cf.schema)]

    def hist_equal(label):
        want = np.bincount(np.concatenate(committed) >> hist.shift, minlength=hist.n_bins)
        check(np.array_equal(hist.counts, want), f"{label}: token histogram != np.bincount of the committed tokens")

    hist_equal("orders_p CREATE")

    def batch(b, qs, oracle, label):
        clock = StageClock()
        torch.cuda.synchronize()
        with GcClock() as gc_clock:
            t = time.perf_counter()
            out = served.read_many("orders_p", qs, trace=clock)
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t) * 1e3)
        batch_spans.append(dict(clock.ms, gc_ms_by_generation=gc_clock.ms))
        check_partitioned(eng, "orders_p", list(zip(qs, out)), served.map, oracle, f"{label} {b}")

    batch_ms: list[float] = []
    batch_spans: list[dict] = []
    imbalance = {"token_hist_at_create": hist.imbalance(cf.ring.starts)}
    fresh = read_batches(n_rows, seed + 6)
    for b, qs in enumerate(fresh[:2]):
        batch(b, qs, oracles[0], "orders_p batch")
    for q in fresh[1][::16]:
        pair = (q, served.read("orders_p", q))
        check_partitioned(eng, "orders_p", [pair], served.map, oracles[0], "orders_p scalar")

    write_ms, flush_ms, routed_rows = [], [], np.zeros(4, np.int64)
    hist_launches = 1
    for wk, wv in writes:
        before = (eng.stats["flush_wall_seconds"], eng.stats["memtable_flushes"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.write("orders_p", wk, wv)
        torch.cuda.synchronize()
        write_ms.append((time.perf_counter() - t) * 1e3)
        stats = eng.stats
        flush_ms.append((stats["flush_wall_seconds"] - before[0]) * 1e3 / max(1, stats["memtable_flushes"] - before[1]))
        committed.append(cf.ring.tokens(wk, cf.schema))
        pids = cf.ring.partition_of_tokens(committed[-1])
        routed_rows += np.bincount(pids, minlength=4)
        # the token histogram, each routed partition's statistics, the
        # column family's statistics: one launch each
        hist_launches += 2 + len(np.unique(pids))
    hist_equal("orders_p after the writes")
    imbalance["token_hist_after_writes"] = hist.imbalance(cf.ring.starts)
    stats = eng.stats
    check(stats["compactions"] > 0, "no partition of orders_p compacted")
    check(
        sum(p.n_rows_committed for p in cf.partitions) == n_rows + len(writes) * WRITE_ROWS,
        "orders_p's partition logs miss rows",
    )
    batch(2, read_batches(n_rows, seed + 7)[0], oracles[2], "orders_p batch after the writes")

    launches = {name: fn.launches for name, fn in K.KERNELS.items()}
    for name in ORDERS_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the partitioned path")
    check(launches["ecdf_hist"] == hist_launches, f"ecdf_hist launched {launches['ecdf_hist']} times, not {hist_launches}")
    check(
        launches["merge_run_positions"] == stats["compactions"],
        f"merge_run_positions launched {launches['merge_run_positions']} times for {stats['compactions']} compactions",
    )
    token_hist = {
        "create": token_hist_row(committed[0] >> hist.shift, hist.n_bins, dev),
        "write": token_hist_row(committed[-1] >> hist.shift, hist.n_bins, dev),
    }
    return dict(
        rows=n_rows, partitions=4, replication_factor=3, partition_balance="tokens",
        slot_layouts=[list(a) for a in cf.slot_layouts],
        ring_starts=[int(x) for x in cf.ring.starts],
        create_ms=create_ms, hrca_ms=cf.hrca_result.wall_seconds * 1e3,
        partition_imbalance=eng.partition_imbalance("orders_p"), imbalance=imbalance,
        rows_per_partition=[int(p.n_rows_committed) for p in cf.partitions],
        written_rows_per_partition=routed_rows.tolist(),
        empty_partition_skips=stats["empty_partition_skips"],
        batch_ms=batch_ms, batch_spans_ms=batch_spans, write_ms=write_ms, flush_ms_per_replica_flush=flush_ms,
        replica_flushes=stats["memtable_flushes"], compactions=stats["compactions"],
        result_cache_hits=stats["result_cache_hits"],
        launches={name: n for name, n in launches.items() if n},
        token_hist=token_hist,
    ), eng


def partitioned_views_phase(layouts, seed, dev) -> dict:
    """``orders_pv``: TPC-H SF 1 ``orders`` at P = 2 (token-quantile
    boundaries), RF 3, ``views=True``, device-resident, in the layouts
    ``orders`` chose (passed as ``layouts=``: no second HRCA); one batch
    of 256, every answer against the oracle, and view hits. Its launch
    counts from 0 (``own_counts``)."""
    import repro_torch.core as T

    kc, vc = T.tpch.generate_orders(1.0, seed=seed + 8)
    n_rows = len(kc["custkey"])
    oracle = Oracle(kc, vc, dev)
    eng = T.HREngine(n_nodes=6, device=dev)
    served = ServedBy(eng)
    t = time.perf_counter()
    eng.create_column_family(
        "orders_pv", kc, vc, replication_factor=3, layouts=layouts, schema=T.tpch.orders_schema(),
        device_resident=True, views=True, partitions=2, partition_balance="tokens",
    )
    torch.cuda.synchronize()
    create_ms = (time.perf_counter() - t) * 1e3
    qs = read_batches(n_rows, seed + 9)[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = served.read_many("orders_pv", qs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    check_partitioned(eng, "orders_pv", list(zip(qs, out)), served.map, oracle, "orders_pv batch")
    stats = eng.stats
    check(stats["view_hits"] > 0, "orders_pv: no answer was served by a view")
    return dict(
        rows=n_rows, partitions=2, layouts="those orders chose, passed as layouts=",
        create_ms=create_ms, batch_ms=wall, view_hits=stats["view_hits"],
        view_boundary_rows=stats["view_boundary_rows"],
        partition_imbalance=eng.partition_imbalance("orders_pv"),
        empty_partition_skips=stats["empty_partition_skips"],
    )


# -- main path -----------------------------------------------------------------------


# -- phase 13: the availability layer -------------------------------------------------


def replica_noise(eng, cf_name, batch) -> int:
    """Queries of ``batch`` whose float32 answers differ across the replicas
    that hold them (each replica table of each partition runs the batch;
    launches left out of the path's counts). A sum's float32 reduction order
    follows each replica's layout, so such a query's digests can disagree on
    clean data; counts and selects never do."""
    cf = eng.column_families[cf_name]

    def run():
        noisy = set()
        for part in cf.partitions:
            answers = [eng._table(cf, r).execute_many(batch) for r in part.replicas]
            for i in range(len(batch)):
                vals = {(np.float32(a[i].value).tobytes(), a[i].rows_matched) for a in answers}
                if len(vals) > 1:
                    noisy.add(i)
        return len(noisy)

    return uncounted(run)


def flip_resident(table, col: str, host_row: int) -> None:
    """Flip the top exponent bit of one float32 in a resident value tile:
    the value of ``col`` at host row ``host_row``, at its device row. The
    host columns, and so the sealed checksum, are untouched."""
    st = table._device
    d = host_row if st["row_map"] is None else int(np.flatnonzero(st["row_map"] == host_row)[0])
    bits = st["values_tile"][st["value_rows"][col]].view(torch.int32)
    bits[d] ^= 1 << 30


def fresh_state_equal(table, key_cols, value_cols, dev) -> bool:
    """A rebuilt replica's resident key lanes and value tile against a
    fresh ``build_device_state`` of the same rows in its layout."""
    import repro_torch.core as T
    from repro_torch.kernels import ops

    fresh_table = T.SortedTable.from_columns(key_cols, value_cols, table.layout, table.schema)
    fresh = ops.build_device_state(fresh_table, device=dev)
    st = table._device
    ok = (
        st["n_runs"] == 1 and st["row_map"] is None
        and torch.equal(st["keys"], fresh["keys"]) and torch.equal(st["values_tile"], fresh["values_tile"])
    )
    del fresh, fresh_table
    return ok


def with_writes(key_cols, value_cols, writes):
    """The rows a column family holds after ``writes``, CREATE rows first."""
    return (
        {c: np.concatenate([key_cols[c]] + [w[0][c] for w in writes]) for c in key_cols},
        {c: np.concatenate([value_cols[c]] + [w[1][c] for w in writes]) for c in value_cols},
    )


def extra_writes(seed: int, n: int) -> list:
    """``n`` writes of ``WRITE_ROWS`` generated TPC-H orders rows from
    ``seed``."""
    import repro_torch.core as T

    wk, wv = T.tpch.generate_orders(1.0, seed=seed, rows_per_sf=n * WRITE_ROWS)
    return [
        ({c: v[i * WRITE_ROWS:(i + 1) * WRITE_ROWS] for c, v in wk.items()},
         {c: v[i * WRITE_ROWS:(i + 1) * WRITE_ROWS] for c, v in wv.items()})
        for i in range(n)
    ]


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and its wall in ms on the host clock, the
    card synchronized on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def delta(eng, before: dict, names) -> dict:
    st = eng.stats
    return {k: st[k] - before[k] for k in names}


AVAIL_COUNTERS = (
    "digest_mismatches", "read_repairs", "read_retries", "read_faults", "hints_queued", "hint_replays",
    "hint_rows_replayed", "hint_fallbacks", "scrub_checks", "scrub_repairs", "view_rebuilds",
)


def availability_phase(eng, veng, peng, key_cols, value_cols, writes, n_rows, seed, dev) -> tuple[dict, list]:
    """The availability layer on the three SF 5 column families.

    ``orders``: a fresh batch of 256 at ONE, QUORUM and ALL (answers
    against the oracle; with no replica disagreeing in float32 on the
    batch, no digest mismatch); one flipped exponent bit in one replica's
    resident value tile, caught by an ALL batch on that row (one read
    repair, the answer the oracle's, the repaired state a fresh build) and
    not by the checksum; a transient ``fail_node``, two writes of 20,000
    rows, ``node_up`` replaying exactly those 40,000 rows, every replica's
    fingerprint equal afterwards; a node loss, ``recover_node`` from the log
    and (after a second loss) from a survivor, each rebuilt state equal to
    a fresh build of the same rows; a hedged batch with one node slowed
    past ``hedge_ratio``; a failover with ``read_fault_budget = 1``.
    ``orders_v``: a corrupted view partial and a deleted view, reported and
    healed by scrub, then view-served sums equal to the fused scan bit for
    bit. ``orders_p``: a QUORUM batch, and one node's loss and recovery
    across its partitions. Every answer against the oracle. Returns the
    phase's report and the writes it made on ``orders``."""
    import repro_torch.core as T
    from repro_torch.core.storage.views import verify_views

    info: dict = {"card": card_line()}
    rows10 = with_writes(key_cols, value_cols, writes)
    oracle = Oracle(*rows10, dev)

    # -- orders_v: scrub reports and heals a corrupt and a missing view
    vcf = veng.column_families["orders_v"]
    before = veng.stats
    t0, t1 = (veng._table(vcf, r) for r in vcf.replicas[:2])
    t0._device["views"]["block_sums"][0, 1] = 2 * t0._device["views"]["block_sums"][0, 1] + 1
    del t1._device["views"]
    report, info["scrub_ms"] = timed(veng.scrub_column_family, "orders_v")
    bad = [vcf.replicas[0].replica_id, vcf.replicas[1].replica_id]
    check(report == {"replicas_checked": 3, "corrupt": bad, "repaired": 2}, f"orders_v scrub: {report}")
    check(all(uncounted(verify_views, veng._table(vcf, r)) for r in vcf.replicas), "scrub left a view unhealed")
    batch = read_batches(n_rows, seed + 6)[1]
    out, info["orders_v_batch_ms"] = timed(veng.read_many, "orders_v", batch)
    check_answers(veng, "orders_v", list(zip(batch, out)), oracle, "orders_v after scrub")
    info["orders_v_view_served"] = uncounted(check_view_bits, veng, "orders_v", list(zip(batch, out)), "after scrub")
    check(info["orders_v_view_served"] > 0, "no view served a sum or count after the heal")
    info["orders_v"] = delta(veng, before, AVAIL_COUNTERS)
    check(info["orders_v"]["view_rebuilds"] == 2 and info["orders_v"]["scrub_repairs"] == 2, "scrub counters")

    # -- orders_p: a QUORUM batch, then one node's loss and recovery
    pcf = peng.column_families["orders_p"]
    served = ServedBy(peng)
    before = peng.stats
    batch = read_batches(n_rows, seed + 7)[0]
    noise = replica_noise(peng, "orders_p", batch)
    out, info["orders_p_quorum_ms"] = timed(served.read_many, "orders_p", batch, consistency="QUORUM")
    mism = peng.stats["digest_mismatches"] - before["digest_mismatches"]
    check(noise > 0 or mism == 0, f"orders_p QUORUM: {mism} digest mismatches on agreeing replicas")
    if mism == 0:
        check_partitioned(peng, "orders_p", list(zip(batch, out)), served.map, oracle, "orders_p QUORUM")
    victim = pcf.partitions[0].replicas[0].node_id
    hosted = [r for r in pcf.replicas if r.node_id == victim]
    peng.fail_node(victim)
    out = served.read_many("orders_p", batch[:64])
    check(all(rep.node_id != victim for _, rep in out), "orders_p: a read reached the lost node")
    check_partitioned(peng, "orders_p", list(zip(batch[:64], out)), served.map, oracle, "orders_p during the loss")
    info["orders_p_recover_ms"] = timed(peng.recover_node, victim)[1]
    for r in hosted:
        t = peng._table(pcf, r)
        part = pcf.partitions[r.partition_id]
        check(len(t) == part.n_rows_committed and t.verify_checksum(), f"orders_p replica {r.replica_id} rebuilt wrong")
    out = served.read_many("orders_p", batch[64:128])
    check_partitioned(peng, "orders_p", list(zip(batch[64:128], out)), served.map, oracle, "orders_p after recovery")
    info["orders_p"] = dict(delta(peng, before, AVAIL_COUNTERS), replica_noise=noise,
                            lost_replicas=[r.replica_id for r in hosted])
    torch.cuda.empty_cache()

    # -- orders: ONE, QUORUM and ALL on a fresh batch
    cf = eng.column_families["orders"]
    before = eng.stats
    batch = read_batches(n_rows, seed + 6)[0]
    noise = replica_noise(eng, "orders", batch)
    walls = {}
    outs = {}
    for level in ("ONE", "QUORUM", "ALL"):
        outs[level], walls[level] = timed(eng.read_many, "orders", batch, consistency=level)
        check_answers(eng, "orders", list(zip(batch, outs[level])), oracle, f"orders at {level}")
    for (a, _), (b, _), (c, _) in zip(outs["ONE"], outs["QUORUM"], outs["ALL"]):
        check(a.rows_matched == b.rows_matched == c.rows_matched, "QUORUM/ALL rows_matched differ from ONE")
    levels = delta(eng, before, AVAIL_COUNTERS)
    check(noise > 0 or levels["digest_mismatches"] == 0, f"orders: digest mismatches {levels} on agreeing replicas")
    info["orders_levels"] = dict(levels, replica_noise=noise, batch_ms=walls)

    # -- orders: one flipped resident value, found by an ALL read
    flip_r = cf.replicas[1]
    table = eng._table(cf, flip_r)
    q = None
    for host_row in range(0, len(table), len(table) // 64):
        key = {c: int(table.key_cols[c][host_row]) for c in cf.key_names}
        cand = T.Query({c: T.Eq(v) for c, v in key.items()}, "sum", "totalprice")
        if oracle.answer(cand, cf.schema)[0] == 1:
            q = cand
            break
    check(q is not None, "no row with a unique key to flip")
    flip_resident(table, "totalprice", host_row)
    check(eng.scrub_column_family("orders", repair=False)["corrupt"] == [], "the checksum saw a resident flip")
    probe = [q, T.Query(q.filters, "count"), T.Query(q.filters, "select")]
    before = eng.stats
    out, info["orders_flip_all_ms"] = timed(eng.read_many, "orders", probe, consistency="ALL")
    flip = delta(eng, before, AVAIL_COUNTERS)
    check(flip["digest_mismatches"] == 1 and flip["read_repairs"] == 1, f"resident flip: {flip}")
    check_answers(eng, "orders", list(zip(probe, out)), oracle, "after the read repair")
    check(fresh_state_equal(eng._table(cf, flip_r), *rows10, dev), "the repaired replica is not a fresh build")
    info["orders_flip"] = dict(flip, replica=flip_r.replica_id, host_row=host_row)
    del oracle
    torch.cuda.empty_cache()

    # -- orders: a transient outage healed by hinted handoff
    outage = extra_writes(seed + 9, 2)
    rows12 = with_writes(*rows10, outage)
    del rows10
    victim_r = cf.replicas[2]
    victim = victim_r.node_id
    hosted = sum(r.node_id == victim for r in cf.replicas)
    before = eng.stats
    eng.fail_node(victim, transient=True)
    check(eng.stats["hints_open"] == hosted, "the outage opened no hint")
    write_ms = [timed(eng.write, "orders", k, v)[1] for k, v in outage]
    _, info["node_up_ms"] = timed(eng.node_up, victim)
    hh = delta(eng, before, AVAIL_COUNTERS)
    check(
        hh["hints_queued"] == 2 * hosted and hh["hint_replays"] == hosted and hh["hint_fallbacks"] == 0,
        f"hinted handoff: {hh}",
    )
    check(hh["hint_rows_replayed"] == 2 * WRITE_ROWS * hosted, f"node_up replayed {hh['hint_rows_replayed']} rows")
    fps = {eng._table(cf, r).dataset_fingerprint() for r in cf.replicas}
    check(len(fps) == 1, "replica fingerprints differ after node_up")
    info["orders_outage"] = dict(hh, write_ms=write_ms, victim_replica=victim_r.replica_id)

    # -- orders: a node loss, rebuilt from the log, then from a survivor
    oracle = Oracle(*rows12, dev)
    info["recover_ms"] = {}
    for source in ("log", "survivor"):
        eng.fail_node(victim)
        # the rows the rebuild sorts: the log's, or the first live peer's
        peer = next(r for r in cf.replicas if r.node_id != victim)
        rows = rows12 if source == "log" else (
            eng._table(cf, peer).key_cols, eng._table(cf, peer).value_cols
        )
        _, info["recover_ms"][source] = timed(eng.recover_node, victim, source=source)
        check(fresh_state_equal(eng._table(cf, victim_r), *rows, dev), f"recover_node({source}) != a fresh build")
    fps = {eng._table(cf, r).dataset_fingerprint() for r in cf.replicas}
    check(len(fps) == 1, "replica fingerprints differ after recovery")
    out = eng.read_many("orders", batch)
    check_answers(eng, "orders", list(zip(batch, out)), oracle, "orders after recovery")
    del rows12

    # -- orders: a hedged batch, one node slowed past hedge_ratio
    hbatch = read_batches(n_rows, seed + 8)[0]
    plain = eng.read_many("orders", hbatch[:64])
    slow = max({rep.node_id for _, rep in plain}, key=lambda n: sum(rep.node_id == n for _, rep in plain))
    eng.nodes[slow].slowdown = 1e4
    try:
        out, info["hedged_batch_ms"] = timed(eng.read_many, "orders", hbatch, hedge=True)
    finally:
        eng.nodes[slow].slowdown = 1.0
    hedged = sum(rep.hedged for _, rep in out)
    check(hedged > 0, "no hedge fired against a 1e4x straggler")
    check_answers(eng, "orders", list(zip(hbatch, out)), oracle, "hedged")
    info["hedge"] = dict(slow_node=slow, hedged=hedged, slowdown=1e4, hedge_ratio=2.0)

    # -- orders: a failover, one transient read fault on the node that served
    # most of a batch (its cached answers dropped, so the rerun scans)
    fbatch = read_batches(n_rows, seed + 10)[0]
    nodes = [rep.node_id for _, rep in eng.read_many("orders", fbatch)]
    faulty = max(set(nodes), key=nodes.count)
    eng._invalidate_result_cache("orders")
    before = eng.stats
    eng.nodes[faulty].read_fault_budget = 1
    out, info["failover_batch_ms"] = timed(eng.read_many, "orders", fbatch)
    fo = delta(eng, before, AVAIL_COUNTERS)
    check(fo["read_faults"] == 1 and fo["read_retries"] > 0, f"failover: {fo}")
    check_answers(eng, "orders", list(zip(fbatch, out)), oracle, "after the failover")
    info["failover"] = dict(fo, faulty_node=faulty)
    info["total_bytes"] = {"orders": eng.total_bytes(), "orders_v": veng.total_bytes(), "orders_p": peng.total_bytes()}
    del oracle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return info, outage


# -- phase 14: ring migration, the drift trigger, parallel flushes, deadlines ---------


MIGRATION_KERNELS = ("scan_agg_locate", "select_compact", "ecdf_hist", "block_sums")
MIGRATION_COUNTERS = ("partition_splits", "partition_merges", "rebalance_rows_moved", "view_rebuilds")
MEM_SLACK = 64 << 20
VIEWS_SF = 1.0  # scale factor of phase 14's views family (orders_pv's)


def device_bytes_per_row(table) -> int:
    """Resident bytes a row of ``table`` takes: its key lanes and value
    tile rows, 4 bytes each."""
    st = table._device
    return 4 * (st["keys"].shape[0] + st["values_tile"].shape[0])


class MemStep:
    """``torch.cuda.memory_allocated`` before a step, its peak (the peak
    counter reset first) and after it; the step must end within
    ``new_bytes`` + 64 MiB of where it began, or a retired table's tensors
    are still held."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.before = torch.cuda.memory_allocated(self.dev)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.peak = torch.cuda.max_memory_allocated(self.dev)
        self.after = torch.cuda.memory_allocated(self.dev)

    def report(self, new_bytes: int, label: str) -> dict:
        check(
            self.after - self.before <= new_bytes + MEM_SLACK,
            f"{label}: device allocation grew {self.after - self.before} bytes, "
            f"more than the new rows' {new_bytes} + 64 MiB",
        )
        return dict(before=self.before, peak=self.peak, after=self.after, new_rows_bytes=new_bytes)


class FlushClock:
    """A sink for ``write``'s ``trace=`` spans that keeps each replica's
    ``engine.flush`` wall on the host clock (a parallel write's spans end
    on pool threads)."""

    def __init__(self):
        self.flush_ms: dict[int, float] = {}
        self.tracer = self

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def child(self, name: str, **kw) -> "_FlushSpan":
        return _FlushSpan(self, name, kw.get("replica"))


class _FlushSpan:
    def __init__(self, clock: FlushClock, name: str, replica):
        self.clock, self.name, self.replica, self.t0 = clock, name, replica, time.perf_counter()
        self.tracer = clock

    def child(self, name: str, **kw) -> "_FlushSpan":
        return _FlushSpan(self.clock, name, kw.get("replica"))

    def end(self, **_) -> None:
        if self.name == "engine.flush":
            self.clock.flush_ms[self.replica] = (time.perf_counter() - self.t0) * 1e3


def migration_phase(eng, peng, key_cols, value_cols, writes, outage, n_rows, seed, dev) -> tuple[dict, list]:
    """Ring migration, the drift trigger, parallel flushes and read
    deadlines on the SF 5 families phase ``availability`` left (every node
    up), each step's answers against the oracle on the card.

    (a) ``split_partition`` of ``orders_p``'s partition 0 at its median
    token, then a batch of 256; (b) ``merge_partitions(0)``, which restores
    the ring, and a batch; (c) the drift trigger armed at 1.05 through
    ``rebalance_imbalance``, one more routed write of 20,000 rows, which
    must fire exactly one rebalance to an imbalance <= 1.25, and a batch;
    (d) on a fresh SF 1, P = 2 views family shaped like ``orders_pv``:
    split, merge and ``rebalance(exact=False)``, each followed by a batch
    whose view-served partial answers equal the fused kernel bit for bit,
    views rebuilt on resharded vnodes only, each batch's garbage-collector
    time clocked (``GcClock``); (e) four writes of 20,000 rows on
    ``orders``, serial, parallel (three replica flushes on the pool),
    parallel, serial, each with its flush wall, per-replica flush walls
    and compactions, all replicas' fingerprints equal after each parallel
    one, and a batch; (f) ``read_many`` with
    ``deadline_s=0.0`` refused once, with ``deadline_s=60.0`` answered as
    without. Device allocation before, at the peak and after (a), (c) and
    (d). ``outage`` is what phase ``availability`` wrote on ``orders``.
    Returns the phase's report and the writes (e) made on ``orders``."""
    import repro_torch.core as T

    for e in (eng, peng):
        check(all(n.alive for n in e.nodes), "a node is still down at the start of the migration phase")
    info: dict = {"card": card_line(), "walls_ms": {}, "batch_ms": {}, "memory": {}}
    walls, batch_ms = info["walls_ms"], info["batch_ms"]
    pcf = peng.column_families["orders_p"]
    served = ServedBy(peng)
    before = peng.stats
    rows_p = with_writes(key_cols, value_cols, writes)
    oracle = Oracle(*rows_p, dev)

    def batch(e, srv, cf_name, qs, orc, label):
        out, batch_ms[label] = timed(srv.read_many, cf_name, qs)
        check_partitioned(e, cf_name, list(zip(qs, out)), srv.map, orc, label)
        return out

    # (a) split partition 0 at its median committed token
    starts0 = pcf.ring.starts
    info["imbalance"] = {"rows_at_start": peng.partition_imbalance("orders_p"),
                         "token_hist_at_start": pcf.token_hist.imbalance(starts0)}
    with MemStep(dev) as m:
        token, walls["a_split"] = timed(peng.split_partition, "orders_p", 0)
    info["memory"]["a_split"] = m.report(0, "split")
    check(pcf.ring.n_partitions == 5 and token in pcf.ring.starts, "the split did not add its boundary")
    info["imbalance"]["rows_after_split"] = peng.partition_imbalance("orders_p")
    for r in pcf.replicas:
        check(peng._table(pcf, r)._device["keys"].device.type == dev.type, f"replica {r.replica_id} is not resident")
    batch(peng, served, "orders_p", read_batches(n_rows, seed + 11)[0], oracle, "after the split")

    # (b) merge the two children back: the ring is CREATE's again
    _, walls["b_merge"] = timed(peng.merge_partitions, "orders_p", 0)
    check(pcf.ring.starts == starts0, "merge did not restore the ring")
    info["imbalance"]["rows_after_merge"] = peng.partition_imbalance("orders_p")
    batch(peng, served, "orders_p", read_batches(n_rows, seed + 12)[0], oracle, "after the merge")

    # (c) the drift trigger: armed above CREATE's imbalance and below the
    # writes', it must fire on the next write's flush, once
    fired = []
    inner = peng.rebalance

    def counting(cf_name, **kwargs):
        fired.append(cf_name)
        return inner(cf_name, **kwargs)

    peng.rebalance = counting
    peng.rebalance_imbalance = 1.05
    moved0 = peng.stats["rebalance_rows_moved"]
    (wk, wv), = extra_writes(seed + 13, 1)
    bpr = device_bytes_per_row(peng._table(pcf, pcf.replicas[0]))
    info["imbalance"]["token_hist_before_trigger"] = pcf.token_hist.imbalance(pcf.ring.starts)
    with MemStep(dev) as m:
        _, walls["c_write_with_rebalance"] = timed(peng.write, "orders_p", wk, wv)
    info["memory"]["c_drift"] = m.report(WRITE_ROWS * bpr * pcf.replication_factor, "drift rebalance")
    peng.rebalance_imbalance = 0.0
    del peng.rebalance
    check(fired == ["orders_p"], f"the drift trigger fired {len(fired)} rebalances, not 1")
    moved = peng.stats["rebalance_rows_moved"] - moved0
    check(moved > 0, "the drift rebalance moved no rows")
    info["imbalance"]["rows_after_rebalance"] = peng.partition_imbalance("orders_p")
    info["imbalance"]["token_hist_after_rebalance"] = pcf.token_hist.imbalance(pcf.ring.starts)
    check(info["imbalance"]["rows_after_rebalance"] <= 1.25, f"imbalance after the rebalance {info['imbalance']}")
    info["drift"] = dict(threshold=1.05, rows_moved=moved, ring_starts=[int(x) for x in pcf.ring.starts],
                         rows_per_partition=[int(p.n_rows_committed) for p in pcf.partitions])
    del oracle
    rows_p = with_writes(*rows_p, [(wk, wv)])
    oracle = Oracle(*rows_p, dev)
    batch(peng, served, "orders_p", read_batches(n_rows, seed + 14)[0], oracle, "after the drift rebalance")
    info["orders_p"] = delta(peng, before, MIGRATION_COUNTERS)
    del oracle, rows_p
    torch.cuda.empty_cache()

    # (d) a views family like orders_pv: split, merge, histogram rebalance
    kc, vc = T.tpch.generate_orders(VIEWS_SF, seed=seed + 8)
    vrows = len(kc["custkey"])
    voracle = Oracle(kc, vc, dev)
    veng = T.HREngine(n_nodes=6, device=dev)
    vserved = ServedBy(veng)
    vcf, walls["d_create"] = timed(
        veng.create_column_family, "orders_pv", kc, vc, replication_factor=3, layouts=eng.layouts("orders"),
        schema=T.tpch.orders_schema(), device_resident=True, views=True, partitions=2, partition_balance="tokens",
    )
    import repro_torch.kernels as K

    views_info = {}
    with MemStep(dev) as m:
        for step, call in (
            ("split", lambda: veng.split_partition("orders_pv", 0)),
            ("merge", lambda: veng.merge_partitions("orders_pv", 0)),
            ("rebalance_histogram", lambda: veng.rebalance("orders_pv", exact=False)),
        ):
            kept = {
                p.vnode_id: [veng._table(vcf, r)._device["views"] for r in p.replicas] for p in vcf.partitions
            }
            vb, bs = veng.stats, K.KERNELS["block_sums"].launches
            _, walls[f"d_{step}"] = timed(call)
            rebuilt = [p for p in vcf.partitions if p.vnode_id not in kept]
            d = delta(veng, vb, MIGRATION_COUNTERS)
            check(d["view_rebuilds"] == 3 * len(rebuilt), f"views {step}: {d} for {len(rebuilt)} new vnodes")
            check(K.KERNELS["block_sums"].launches - bs >= 3 * len(rebuilt), f"views {step}: block_sums did not launch")
            for p in vcf.partitions:
                if p.vnode_id in kept:
                    check(
                        all(veng._table(vcf, r)._device["views"] is v for r, v in zip(p.replicas, kept[p.vnode_id])),
                        f"views {step}: a kept vnode's view state changed",
                    )
            qs = read_batches(vrows, seed + 15)[0]
            with GcClock() as gc_clock:
                batch(veng, vserved, "orders_pv", qs, voracle, f"orders_pv after the {step}")
            served_n = uncounted(check_partial_view_bits, veng, "orders_pv", vserved.partials, f"orders_pv {step}")
            check(served_n > 0, f"orders_pv after the {step}: no view served a partial answer")
            views_info[step] = dict(d, new_vnodes=len(rebuilt), view_served_partials=served_n,
                                    ring_starts=[int(x) for x in vcf.ring.starts],
                                    batch_gc_ms={str(g): ms for g, ms in gc_clock.ms.items()})
    info["memory"]["d_views"] = m.report(0, "views family migrations")
    info["orders_pv"] = views_info
    del voracle, veng, vserved, vcf
    torch.cuda.empty_cache()

    # (e) four writes on orders in the order serial, parallel, parallel,
    # serial: three replica flushes in turn or on the pool, each write's
    # compactions recorded beside its walls
    cf = eng.column_families["orders"]
    rows_o = with_writes(key_cols, value_cols, writes + outage)
    e_writes = extra_writes(seed + 16, 4)
    info["e_writes"] = []
    for i, ((wk, wv), parallel) in enumerate(zip(e_writes, (False, True, True, False))):
        if i == 0:
            check(eng._pool is None, "a serial write used the pool")
        before, clock = eng.stats, FlushClock()
        _, wall = timed(eng.write, "orders", wk, wv, parallel=parallel, trace=clock)
        st = eng.stats
        check(st["memtable_flushes"] - before["memtable_flushes"] == 3, f"write {i} did not flush 3 replicas")
        if parallel:
            check(eng._pool is not None, "the parallel write did not use the pool")
            fps = {eng._table(cf, r).dataset_fingerprint() for r in cf.replicas}
            check(len(fps) == 1, f"replica fingerprints differ after parallel write {i}")
        info["e_writes"].append(dict(
            parallel=parallel, wall_ms=wall, flush_wall_ms=(st["flush_wall_seconds"] - before["flush_wall_seconds"]) * 1e3,
            replica_flush_ms={str(r): ms for r, ms in sorted(clock.flush_ms.items())},
            compactions=st["compactions"] - before["compactions"],
        ))
        walls[f"e_write_{i}_{'parallel' if parallel else 'serial'}"] = wall
    oracle = Oracle(*with_writes(*rows_o, e_writes), dev)
    del rows_o
    qs = read_batches(n_rows, seed + 17)[0]
    # the round-robin counter restarts before this read and before the one
    # with a deadline, so both route every query alike
    cf.rr_counter = itertools.count()
    out, batch_ms["orders after the parallel write"] = timed(eng.read_many, "orders", qs)
    check_answers(eng, "orders", list(zip(qs, out)), oracle, "orders after the parallel write")

    # (f) read deadlines: a spent budget is refused and counted once; a
    # generous one answers as a call without it
    before = eng.stats
    try:
        eng.read_many("orders", qs, deadline_s=0.0)
    except T.DeadlineExceeded:
        pass
    else:
        fail("read_many(deadline_s=0.0) answered")
    check(eng.stats["deadline_exceeded"] - before["deadline_exceeded"] == 1, "the refusal was not counted once")
    eng._invalidate_result_cache("orders")
    cf.rr_counter = itertools.count()
    got, batch_ms["orders with deadline_s=60"] = timed(eng.read_many, "orders", qs, deadline_s=60.0)
    for (a, _), (b, _) in zip(out, got):
        check((a.value, a.rows_matched, a.rows_scanned) == (b.value, b.rows_matched, b.rows_scanned),
              "deadline_s=60 answered differently")
    info["deadline"] = delta(eng, before, ("deadline_exceeded", "read_retries"))
    del oracle
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return info, e_writes


# -- phase 15: the serving front door, traced -------------------------------------


FRONTDOOR_KERNELS = ("scan_agg_locate", "select_compact")
FRONTDOOR_COUNTERS = ("digest_mismatches", "read_repairs", "read_retries", "deadline_exceeded")
# The request stream is fixed in seconds, so that the seed alone pins it:
# a mean arrival gap of 0.1 ms, about twice the per-request service that a
# closed-loop batch of 64 on `orders` reports on the H100 (0.051-0.057 ms,
# PERF.md sections 5-6), a tenth of it in the burst window, a budget of
# 100 gaps a request and a batching wait of 4 gaps.
FRONTDOOR_GAP_S = 1.0e-4
FRONTDOOR_BURST_GAP_S = FRONTDOOR_GAP_S / 10
FRONTDOOR_DEADLINE_S = 100 * FRONTDOOR_GAP_S
FRONTDOOR_MAX_WAIT_S = 4 * FRONTDOOR_GAP_S


def percentiles_ms(xs) -> dict:
    xs = np.asarray(xs, dtype=np.float64) * 1e3
    if not len(xs):
        return {"n": 0}
    return {"n": int(len(xs)), "p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99)),
            "max": float(xs.max())}


def frontdoor_phase(eng, rows, n_rows, seed, dev) -> dict:
    """The port's ``FrontDoor`` with a perf-counter ``Tracer`` over the
    resident ``orders`` family as phase ``migration`` left it.

    1,024 requests from ``read_batches`` (per 256: 128 sums, 64 counts, 64
    selects), 30 % at QUORUM, three priorities, on seeded Poisson arrivals
    with a mean gap of ``FRONTDOOR_GAP_S``, ``FRONTDOOR_BURST_GAP_S`` in the
    middle third (the burst window, as ``OverloadHarness`` has), and a
    budget of ``FRONTDOOR_DEADLINE_S`` each. The per-request service that
    one closed-loop batch of 64 reports is read beside them. The result
    cache is off for the phase, so every launched group scans. Every answer against
    the oracle; the statuses equal the counters; every batch's tree reaches
    ``kernel.scan_launch``; the traces dumped as JSON lines, loaded back and
    rendered (``chiprun_out/frontdoor_report.txt``, the slow-query log in
    ``chiprun_out/frontdoor_slow.jsonl``)."""
    import io

    from repro_torch.obs import Tracer, dump_jsonl, load_jsonl, render_report, stage_totals
    from repro_torch.serving import FrontDoor, Request

    oracle = Oracle(*rows, dev)
    info: dict = {"card": card_line()}
    cache_enabled, eng._cache_enabled = eng._cache_enabled, False
    before = eng.stats
    try:
        probe = read_batches(n_rows, seed + 20)[0][:64]
        out, info["probe_batch_ms"] = timed(eng.read_many, "orders", probe)
        check_answers(eng, "orders", list(zip(probe, out)), oracle, "front door probe batch")
        per_request = sum(rep.wall_seconds for _, rep in out) / len(probe)
        queries = [q for b in read_batches(n_rows, seed + 18) for q in b]
        rng = np.random.default_rng(seed + 19)
        n = len(queries)
        t, requests = 0.0, []
        for i, q in enumerate(queries):
            t += float(rng.exponential(FRONTDOOR_BURST_GAP_S if n // 3 <= i < 2 * n // 3 else FRONTDOOR_GAP_S))
            requests.append(Request(
                "orders", q, arrival_s=t, deadline_s=FRONTDOOR_DEADLINE_S, priority=int(rng.integers(0, 3)),
                consistency="QUORUM" if rng.random() < 0.3 else "ONE",
            ))
        tracer = Tracer()
        fd = FrontDoor(eng, max_batch=64, max_wait=FRONTDOOR_MAX_WAIT_S, max_queue=256, tracer=tracer)
        resps, info["serve_wall_ms"] = timed(fd.serve, requests)
    finally:
        eng._cache_enabled = cache_enabled
    stats = fd.stats
    info["stats"] = stats
    info["engine"] = delta(eng, before, FRONTDOOR_COUNTERS)
    info["arrivals"] = dict(requests=n, mean_gap_ms=FRONTDOOR_GAP_S * 1e3, burst_gap_ms=FRONTDOOR_BURST_GAP_S * 1e3,
                            deadline_ms=FRONTDOOR_DEADLINE_S * 1e3, max_wait_ms=FRONTDOOR_MAX_WAIT_S * 1e3,
                            last_arrival_ms=requests[-1].arrival_s * 1e3,
                            quorum=sum(r.consistency == "QUORUM" for r in requests))
    info["per_request_service_ms"] = per_request * 1e3

    # statuses against the counters, then every answer against the oracle
    by = {k: sum(r.status == k for r in resps) for k in ("ok", "rejected", "shed", "deadline")}
    info["statuses"] = by
    check(sum(by.values()) == n == stats["submitted"], f"front door: {by} for {n} requests")
    check(by["ok"] == stats["served_ok"], f"front door: {by['ok']} ok, served_ok {stats['served_ok']}")
    check(by["rejected"] == stats["rejected_throttle"] + stats["rejected_bulkhead"] + stats["rejected_queue_full"],
          f"front door: rejected {by['rejected']} vs {stats}")
    check(by["shed"] == stats["shed_overload"] and by["deadline"] == stats["shed_deadline"],
          f"front door: shed/deadline {by} vs {stats}")
    check(sum(r.degraded for r in resps) == stats["consistency_degraded"], "front door: degraded responses uncounted")
    check(by["ok"] > 0, "the front door answered nothing")
    check(all(r.error for r in resps if not r.ok), "an untyped refusal")
    served = [(req.query, (r.result, r.report)) for req, r in zip(requests, resps) if r.ok]
    uncounted(check_answers, eng, "orders", served, oracle, "front door")
    del oracle

    # one tree per request; every launched batch's tree reaches the kernel
    roots = tracer.roots
    check(sum(r.name == "frontdoor.request" for r in roots) == n, "front door: a request has no tree")
    # a launched group's engine subtree hangs under its frontdoor.batch root,
    # or under its sole member's frontdoor.service span
    groups = [
        h for root in roots
        for h in ([root] if root.name == "frontdoor.batch" else root.find_all("frontdoor.service"))
        if h.find("engine.read_many") is not None
    ]
    reached: dict[float, bool] = {}
    for h in groups:
        reached[h.t_start] = reached.get(h.t_start, False) or h.find("kernel.scan_launch") is not None
    check(0 < len(reached) <= stats["batches"], f"front door: {len(reached)} launched batches, {stats['batches']} counted")
    check(all(reached.values()), f"front door: {sum(not v for v in reached.values())} batches without a scan launch")
    for req, r in zip(requests, resps):
        if r.ok:
            check(r.latency_s <= req.deadline_s, "an ok answer landed past its budget")
    for root in roots:
        if root.name != "frontdoor.request" or root.attrs.get("status") != "ok":
            continue
        q, sv = root.find("frontdoor.queue"), root.find("frontdoor.service")
        check(math.isclose(q.wall + sv.wall, root.wall, rel_tol=1e-9, abs_tol=1e-12), "queue + service != latency")

    # export: every tree as JSON lines and back; the slow-query log to a file
    buf = io.StringIO()
    check(dump_jsonl(roots, buf) == len(roots), "front door: the dump lost trees")
    docs = load_jsonl(io.StringIO(buf.getvalue()))
    check(len(docs) == len(roots), "front door: the dump did not load back")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    slow = out_dir / "frontdoor_slow.jsonl"
    dump_jsonl(fd.slow_log.entries(), str(slow))
    slow_docs = load_jsonl(str(slow))
    check(len(slow_docs) == len(fd.slow_log) > 0, "front door: the slow-query log did not round-trip")
    report = render_report(slow_docs, top=3, unit="ms")
    check(report.startswith(f"trace report: {len(slow_docs)} span trees"), "front door: render_report")
    (out_dir / "frontdoor_report.txt").write_text(report)
    totals = stage_totals(docs)
    info["stage_totals_ms"] = {k: {"count": v["count"], "total_ms": v["total"] * 1e3} for k, v in totals.items()}
    info["latency_ms"] = percentiles_ms([r.latency_s for r in resps if r.ok])
    info["queue_wait_ms"] = percentiles_ms([r.queue_wait_s for r in resps if r.ok])
    info["group_service_ms"] = percentiles_ms([h.wall for h in groups])
    info["launched_batches"] = len(reached)
    info["trees"] = len(roots)
    info["slow_log"] = [round(lat * 1e3, 6) for lat, _ in fd.slow_log.entries()]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return info


# -- phase 16: the chaos harnesses on the card ----------------------------------------


CHAOS_KERNELS = ("block_sums", "boundary_block_sums", "merge_run_positions", "ecdf_hist")
CHAOS_SEEDS = (0, 1)
CHAOS_COUNTERS = (
    "hints_queued", "hint_replays", "hint_fallbacks", "digest_mismatches", "read_repairs", "read_retries",
    "scrub_checks", "scrub_repairs", "corrupt_runs", "flush_faults", "view_hits", "view_boundary_rows",
    "view_rebuilds", "compactions",
)


def view_battery(harness) -> dict:
    """View-eligible range sums and counts on each replica layout's leading
    key, read at QUORUM on a healed views chaos victim and at ONE on its
    oracle: counts exact, sums within rtol 1e-5 / atol 1e-3, the sums that
    are not bit-equal counted. The harness's own probes are counts, which
    never reach a boundary rescan; these do, and their float32 sums meet
    the layout-dependent digests (ROADMAP Queue 3), whose mismatches and
    repairs are counted, not hidden."""
    import repro_torch.core as T

    cf = harness.victim.column_families["chaos"]
    qs = []
    for layout in cf.slot_layouts:
        col = layout[0]
        dom = cf.schema.max_value(col) + 1
        for i in range(4):
            lo, hi = i * dom // 8, i * dom // 8 + dom // 2
            qs += [T.Query({col: T.Range(lo, hi)}, "sum", "metric"), T.Query({col: T.Range(lo + 1, hi - 1)}, "count")]
    before = harness.victim.stats
    got = harness.victim.read_many("chaos", qs, consistency="QUORUM")
    want = harness.oracle.read_many("chaos", qs)
    diffs = 0
    for q, (g, _), (w, _) in zip(qs, got, want):
        what = f"views chaos battery ({q.agg}, {q.filters})"
        check(g.rows_matched == w.rows_matched, f"{what}: rows {g.rows_matched} != {w.rows_matched}")
        if q.agg == "count":
            check(g.value == w.value, f"{what}: count {g.value} != {w.value}")
        else:
            check(math.isclose(g.value, w.value, rel_tol=RTOL, abs_tol=ATOL), f"{what}: sum {g.value} != {w.value}")
            diffs += g.value != w.value
    moved = delta(harness.victim, before, ("view_hits", "view_boundary_rows", "digest_mismatches", "read_repairs"))
    check(moved["view_hits"] > 0 and moved["view_boundary_rows"] > 0, f"views chaos battery: {moved}")
    return dict(moved, queries=len(qs), sums_not_bit_equal=int(diffs))


def chaos_phase(dev) -> dict:
    """``ChaosHarness(views=True)`` for two seeds and ``OverloadHarness`` for
    one on the card, at the reference's test sizes (20 steps, 2,000 rows;
    400 requests): victim and oracle are port engines on the card, the
    views families resident with their views. Each report must hold its
    acceptance property; each healed views victim then answers
    ``view_battery``."""
    from repro_torch.ft.chaos import ChaosHarness, OverloadHarness

    info: dict = {"card": card_line(), "views": [], "overload": None}
    for seed in CHAOS_SEEDS:
        harness, create_ms = timed(ChaosHarness, seed, n_steps=20, n_rows=2_000, views=True, device=dev)
        report, run_ms = timed(harness.run)
        check(report.ok, f"views chaos seed {seed}: {report.failures}")
        for e in (harness.victim, harness.oracle):
            cf = e.column_families["chaos"]
            for r in cf.replicas:
                check(e._table(cf, r)._device["keys"].device.type == dev.type,
                      f"views chaos seed {seed}: replica {r.replica_id} is not resident")
        st = report.stats
        check(st["view_hits"] > 0 and st["view_rebuilds"] > 0, f"views chaos seed {seed}: views idle {st}")
        battery, battery_ms = timed(view_battery, harness)
        info["views"].append(dict(
            seed=seed, events=report.n_events, create_ms=create_ms, run_ms=run_ms,
            **{k: st[k] for k in CHAOS_COUNTERS},
            battery=dict(battery, wall_ms=battery_ms),
        ))
        del harness
    harness, create_ms = timed(OverloadHarness, 0, device=dev)
    report, run_ms = timed(harness.run)
    check(report.ok, f"overload seed 0: {report.failures}")
    info["overload"] = dict(seed=0, requests=report.n_requests, create_ms=create_ms, run_ms=run_ms, stats=report.stats)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return info


# -- phase 17: the LM serving path ------------------------------------------------------

LM_ARCHS = ("starcoder2-3b", "yi-34b", "chatglm3-6b", "minitron-8b", "musicgen-medium", "paligemma-3b",
            "qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-780m", "hymba-1.5b")
LM_FULL = "starcoder2-3b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 32
LM_CHECK_B, LM_CHECK_S = 2, 129
LM_PROFILE_STEPS = 8
#: the other families' profiled decode steps (each is thousands of device
#: events: the profiler's collection takes seconds)
LM_FAMILY_PROFILE_STEPS = 2
LM_F32_LOGITS, LM_F32_CACHE, LM_DECODE_BOUND = 1e-4, 1e-5, 5e-3
#: the other families at their published widths, bfloat16: (batch, prompt,
#: greedy tokens, layers kept; None = all)
LM_FAMILIES = {
    "qwen2-moe-a2.7b": (8, 1024, 32, None),
    "mamba2-780m": (8, 1024, 32, None),
    "hymba-1.5b": (8, 2048, 32, None),
    # 671 B parameters are ~1.34 TB in bfloat16, 17x the card: the 3 dense
    # layers and 1 MoE layer, 15.11 B parameters by param_count()
    "deepseek-v3-671b": (4, 1024, 16, 4),
}


def lm_smoke_batch(cfg, rng, n=17) -> dict:
    """``n`` positions of 2 sequences: tokens, or frame embeddings."""
    if cfg.input_mode == "tokens":
        return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, n)))}
    return {"embeds": torch.as_tensor(rng.normal(0, 1, (2, n, cfg.d_model)).astype(np.float32))}


def lm_where_time(model, dev, batch: int = LM_BATCH, prompt: int = LM_PROMPT, steps: int = LM_PROFILE_STEPS,
                  profile_prefill: bool = True) -> dict:
    """One prefill of ``batch`` prompts of ``prompt`` tokens and then
    ``steps`` greedy decode steps, each under ``torch.profiler``
    (``under_profiler``; the prefill unprofiled when ``profile_prefill``
    is false): walls, device busy time, device events, the kernels that
    take the device's time."""
    from repro_torch.serving.steps import make_decode_step, make_prefill_step

    cfg = model.cfg
    prefill = make_prefill_step(cfg, s_alloc=prompt + steps, device=dev)
    decode = make_decode_step(cfg, device=dev)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt)), device=dev)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(model, {"tokens": tokens})

    def run_decode():
        for i in range(steps):
            tok = state["logits"][..., : cfg.vocab_size].argmax(-1)[:, None]
            state["logits"], _ = decode(model, state["cache"], {"tokens": tok}, prompt + i)

    out = {}
    if profile_prefill:
        out["prefill"] = under_profiler(run_prefill)[0]
    else:
        run_prefill()
    out[f"decode_{steps}_steps"] = under_profiler(run_decode)[0]
    return out


def lm_route_shares(log, tokens_prefill: int, tokens_decode: int) -> dict:
    """Per MoE layer, from a ``route_log`` of one ``serve_batch``: the
    capacity and the share of (token, choice) assignments dropped at the
    prefill and over the decode steps."""
    layers: dict = {}
    for call in log.summary():
        phase = "prefill" if call["tokens"] == tokens_prefill else "decode"
        check(call["tokens"] in (tokens_prefill, tokens_decode), f"a routing call of {call['tokens']} tokens")
        row = layers.setdefault(call["layer"], {})
        acc = row.setdefault(phase, dict(capacity=call["capacity"], calls=0, assignments=0, dropped=0))
        check(acc["capacity"] == call["capacity"], f"{call['layer']}: capacity changed within the {phase}")
        acc["calls"] += 1
        acc["assignments"] += call["assignments"]
        acc["dropped"] += call["dropped"]
    for row in layers.values():
        for acc in row.values():
            acc["dropped_share"] = acc["dropped"] / acc["assignments"]
    return layers


def lm_window_check(model, seq: int, dev) -> dict:
    """A windowed hybrid layer at full width on a random input of ``seq``
    positions, with its window and with the global sentinel: the outputs
    before position ``window`` agree, after it they differ (the window
    masks)."""
    from repro_torch.models.blocks import GLOBAL_WINDOW
    from repro_torch.models.lm import _windows_for, stacks_for
    from repro_torch.serving.steps import exact_matmul

    cfg = model.cfg
    (spec,) = stacks_for(cfg)
    windows = _windows_for(cfg, spec, 0)
    layer = next(i for i, w in enumerate(windows) if w != GLOBAL_WINDOW)
    check([i for i, w in enumerate(windows) if w == GLOBAL_WINDOW] == list(cfg.global_layers),
          f"{cfg.name}: global layers {windows}")
    g = torch.Generator(dev).manual_seed(5)
    x = torch.randn((1, seq, cfg.d_model), generator=g, device=dev).to(model.dtype)
    pos = torch.arange(seq, dtype=torch.int32, device=dev)[None]
    block, w = model.stacks[spec.name][layer], windows[layer]
    with torch.inference_mode(), exact_matmul():
        a, _ = block(x, pos, window=w)
        b, _ = block(x, pos, window=GLOBAL_WINDOW)
    inside, outside = max_abs_diff(a[:, :w], b[:, :w]), max_abs_diff(a[:, w:], b[:, w:])
    check(outside > 0 and outside > 10 * inside, f"{cfg.name}: the window of {w} does not mask ({inside}, {outside})")
    return dict(layer=layer, window=w, global_layers=list(cfg.global_layers), positions=seq,
                max_abs_diff_inside=inside, max_abs_diff_outside=outside)


def lm_family_run(arch: str, dev) -> dict:
    """``serve_batch`` at the published widths in bfloat16 (``LM_FAMILIES``:
    batch, prompt, tokens, depth), the model from ``init_lm`` on a CUDA
    generator seeded 0 and freed after: logits finite, tokens in the
    vocabulary; ``lm_where_time`` at the same batch and prompt
    (``LM_FAMILY_PROFILE_STEPS`` decode steps, the prefill too for MoE,
    where the dispatch's scan shows); for MoE,
    the capacities and dropped shares per layer from a second, untimed
    ``serve_batch`` under ``route_log`` (the timed one carries no
    instrumentation); the hybrid's window; the SSD's float32 decode check
    at full width."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import decode_forward_error, serve_batch
    from repro_torch.models.lm import init_lm
    from repro_torch.models.moe import route_log

    B, P, G, layers = LM_FAMILIES[arch]
    cfg = get_arch(arch)
    info: dict = dict(arch=arch, dtype=cfg.dtype, batch=B, prompt=P, gen=G)
    if layers is not None:
        info["reduced"] = dict(
            n_layers=[cfg.n_layers, layers],
            kept=f"the {cfg.first_k_dense} dense layers and {layers - cfg.first_k_dense} of "
                 f"{cfg.n_layers - cfg.first_k_dense} MoE layers, widths as published",
            why=f"{cfg.param_count() / 1e9:.0f} B parameters are {2 * cfg.param_count() / 1e12:.2f} TB in bfloat16",
        )
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, info["init_ms"] = timed(init_lm, cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    out = serve_batch(cfg, batch_size=B, prompt_len=P, gen_tokens=G, seed=0, device=dev, model=model)
    tokens = out["tokens"]
    check(bool(torch.isfinite(out["logits"][..., : cfg.vocab_size]).all()), f"lm_serve {arch}: logits not finite")
    check(tokens.shape == (B, G) and tokens.min() >= 0 and tokens.max() < cfg.vocab_size,
          f"lm_serve {arch}: tokens {tokens.shape}, range {tokens.min()}..{tokens.max()}")
    info.update(
        param_count=cfg.param_count(), param_bytes=out["param_bytes"], cache_bytes=out["cache_bytes"],
        prefill_ms=out["prefill_s"] * 1e3, decode_ms=out["decode_s"] * 1e3, decode_tok_s=out["decode_tok_s"],
        peak_bytes=torch.cuda.max_memory_allocated(), tokens_head=tokens[0, :8].tolist(),
    )
    del out
    t0 = time.perf_counter()
    info["where_time"] = lm_where_time(model, dev, B, P, LM_FAMILY_PROFILE_STEPS, profile_prefill=cfg.is_moe)
    info["where_time_host_s"] = time.perf_counter() - t0
    if cfg.is_moe:
        with route_log(model) as log:
            logged = serve_batch(cfg, batch_size=B, prompt_len=P, gen_tokens=G, seed=0, device=dev, model=model)
        info["logged_run_tokens_equal"] = bool(np.array_equal(logged["tokens"], tokens))
        del logged
        info["moe"] = lm_route_shares(log, B * P, B)
        for name, row in info["moe"].items():
            for phase, T in (("prefill", B * P), ("decode", B)):
                want = max(1, math.ceil(T * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts))
                check(row[phase]["capacity"] == want, f"{arch} {name}: {phase} capacity {row[phase]['capacity']}")
        print(f"lm_serve {arch}: dropped share per MoE layer, prefill / decode: "
              + ", ".join(f"{r['prefill']['dropped_share']:.4f}/{r['decode']['dropped_share']:.4f}"
                          for r in info["moe"].values()), flush=True)
    if cfg.family == "hybrid":
        info["window_check"] = lm_window_check(model, P, dev)
    del model
    torch.cuda.empty_cache()
    if cfg.family == "ssm":
        torch.cuda.reset_peak_memory_stats()
        f32 = dataclasses.replace(cfg, dtype="float32")
        model, init_ms = timed(init_lm, f32, generator=torch.Generator(dev).manual_seed(1), device=dev)
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.as_tensor(rng.integers(0, f32.vocab_size, (LM_CHECK_B, LM_CHECK_S)), device=dev)}
        err, ms = timed(decode_forward_error, model, batch, device=dev)
        check(err < LM_DECODE_BOUND, f"lm_serve {arch} float32: decode differs from forward by {err}")
        info["decode_check"] = dict(
            dtype="float32", batch=LM_CHECK_B, positions=LM_CHECK_S, max_rel_err=err, bound=LM_DECODE_BOUND,
            init_ms=init_ms, wall_ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
        )
        del model
        torch.cuda.empty_cache()
    print(f"lm_serve {arch}: prefill {info['prefill_ms']:.1f} ms, decode {info['decode_tok_s']:.1f} tok/s, "
          f"peak {info['peak_bytes'] / 1e9:.2f} GB", flush=True)
    return info


def lm_serve_phase(dev) -> dict:
    """The port's LM serving path (plain PyTorch: it has no kernel of its
    own). First the ten SMOKE configs in float32, the card's prefill and
    three teacher-forced decode steps against the port's CPU path on the
    same weights (logits within 1e-4, caches within 1e-5, the SSD's float32
    state within 1e-5 of its largest magnitude, no MoE expert choice
    different); then ``serve_batch`` on starcoder2-3b at full width in
    bfloat16 (batch 8, prompt 1024, 32 greedy tokens, weights from
    ``init_lm`` on a CUDA generator seeded 0), twice on the same weights,
    the first call cold; then the full width in float32: teacher-forced
    prefill over 129 positions against prefill over 128 and one decode
    step, B = 2, within the reference's 5e-3. Between the two widths,
    ``lm_where_time``. Last, ``lm_family_run`` for each of
    ``LM_FAMILIES``."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.launch.serve import decode_forward_error, device_agreement, serve_batch
    from repro_torch.models.lm import init_lm

    info: dict = {"card": card_line(), "allocated_before_bytes": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    smoke = {}
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        cpu_model = init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
        diff, ms = timed(device_agreement, cpu_model, copy.deepcopy(cpu_model).to(dev),
                         lm_smoke_batch(cfg, np.random.default_rng(0)), q_chunk=4, kv_chunk=8)
        check(diff["prefill_logits"] <= LM_F32_LOGITS and diff["decode_logits"] <= LM_F32_LOGITS
              and diff["cache"] <= LM_F32_CACHE and diff.get("state", 0.0) <= LM_F32_CACHE
              and diff.get("expert_choices_differ", 0) == 0, f"lm_serve {arch}: the card differs from the CPU: {diff}")
        if "expert_choices_differ" in diff:
            print(f"lm_serve {arch} SMOKE: {diff['expert_choices_differ']} expert choices differ, card against CPU",
                  flush=True)
        smoke[arch] = dict(diff, wall_ms=ms)
    info["smoke_vs_cpu"] = smoke

    cfg = get_arch(LM_FULL)
    model, init_ms = timed(init_lm, cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    runs, generated = [], []
    for _ in range(2):
        out = serve_batch(cfg, batch_size=LM_BATCH, prompt_len=LM_PROMPT, gen_tokens=LM_GEN, seed=0, device=dev,
                          model=model)
        tokens = out["tokens"]
        generated.append(tokens)
        check(bool(torch.isfinite(out["logits"]).all()), f"lm_serve {LM_FULL}: logits not finite")
        check(tokens.shape == (LM_BATCH, LM_GEN) and tokens.min() >= 0 and tokens.max() < cfg.vocab_size,
              f"lm_serve {LM_FULL}: tokens {tokens.shape}, range {tokens.min()}..{tokens.max()}")
        runs.append(dict(prefill_ms=out["prefill_s"] * 1e3, decode_ms=out["decode_s"] * 1e3,
                         decode_tok_s=out["decode_tok_s"], tokens_head=tokens[0, :8].tolist()))
    info["serve"] = dict(
        arch=LM_FULL, dtype=cfg.dtype, batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, q_chunk=512, kv_chunk=1024,
        init_ms=init_ms, runs=runs, repeat_tokens_equal=bool(np.array_equal(*generated)),
        param_count=cfg.param_count(), param_bytes=out["param_bytes"], cache_bytes=out["cache_bytes"],
        peak_bytes=torch.cuda.max_memory_allocated(),
    )
    info["where_time"] = lm_where_time(model, dev)
    del model, out
    torch.cuda.empty_cache()

    f32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = timed(init_lm, f32, generator=torch.Generator(dev).manual_seed(1), device=dev)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, f32.vocab_size, (LM_CHECK_B, LM_CHECK_S)), device=dev)}
    err, ms = timed(decode_forward_error, model, batch, device=dev)
    check(err < LM_DECODE_BOUND, f"lm_serve {LM_FULL} float32: decode differs from forward by {err}")
    info["decode_check"] = dict(
        dtype="float32", batch=LM_CHECK_B, positions=LM_CHECK_S, max_rel_err=err, bound=LM_DECODE_BOUND,
        init_ms=init_ms, wall_ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
    )
    del model
    torch.cuda.empty_cache()
    info["families"] = {arch: lm_family_run(arch, dev) for arch in LM_FAMILIES}
    info["reduced"] = {arch: f["reduced"] for arch, f in info["families"].items() if "reduced" in f}
    return info


# -- phase 18: the LM training path -----------------------------------------------------

LM_TRAIN_STEPS = 8
#: the CPU tests' float32 bounds: loss, and gradients over the largest magnitude
LM_TRAIN_F32_LOSS, LM_TRAIN_F32_GRAD = 1e-5, 1e-5
#: the CPU step tests' bound on a stepped parameter where both gradients
#: exceed 1e-5 of the largest; elsewhere twice the learning rate
LM_TRAIN_F32_PARAM = 1e-5
LM_TRAIN_LR = 1e-2
#: the reference's failure-recovery config (its tests/test_substrate.py)
LM_TRAIN_TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64)


def lm_train_batch(cfg, rng, b: int = 2, s: int = 16) -> dict:
    """``b`` sequences of ``s`` positions: tokens or frame embeddings, and
    labels (``[b, s, CB]`` for multi-codebook archs)."""
    batch = lm_smoke_batch(cfg, rng, s)
    batch = {k: v[:b] for k, v in batch.items()}
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    batch["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape))
    return batch


def lm_train_full(dev) -> dict:
    """``run_training`` on starcoder2-3b at full width with the reference's
    ``TrainLoopConfig`` (batch 8 x 256, AdamW, remat ``dots``, warmup 20)
    for ``LM_TRAIN_STEPS`` steps, checkpoints every ``steps + 1``, into a
    temporary directory; then one more step of the same model under
    ``torch.profiler``, after a warm step whose parameters must move."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import TrainLoopConfig, run_training
    from repro_torch.models.convert import param_leaves
    from repro_torch.models.lm import init_lm
    from repro_torch.training.optimizer import init_opt
    from repro_torch.training.steps import TrainSettings, make_train_step, train_params

    cfg = get_arch(LM_FULL)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        loop = TrainLoopConfig(steps=LM_TRAIN_STEPS, ckpt_dir=d, ckpt_every=LM_TRAIN_STEPS + 1,
                               log_every=LM_TRAIN_STEPS)
        out, wall_ms = timed(run_training, cfg, loop, device=dev)
        check(not os.listdir(d), f"lm_train {LM_FULL}: the timed loop wrote a checkpoint")
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    check(len(losses) == LM_TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"lm_train {LM_FULL}: losses {losses}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) < 1.5, f"lm_train {LM_FULL}: step 1 loss {losses[0]}, ln V = {ln_v}")
    tokens = loop.batch_size * loop.seq_len
    warm = out["step_s"][1:]
    info = dict(
        arch=LM_FULL, dtype=cfg.dtype, param_count=cfg.param_count(), batch=loop.batch_size, seq=loop.seq_len,
        remat=loop.remat, opt=loop.opt.kind, warmup_steps=loop.opt.warmup_steps, steps=LM_TRAIN_STEPS,
        init_ms=out["init_s"] * 1e3, step_ms=[s * 1e3 for s in out["step_s"]],
        data_ms=[s * 1e3 for s in out["data_s"]], warm_tok_s=tokens * len(warm) / sum(warm),
        losses=losses, grad_norms=out["grad_norms"], run_wall_ms=wall_ms, peak_bytes=peak,
        data_layouts=out["data_layouts"], avg_rows_scanned=out["avg_rows_scanned"],
    )
    del out
    torch.cuda.empty_cache()

    # one step profiled, on a model of its own, after a warm step
    settings = TrainSettings(remat=loop.remat, q_chunk=min(512, loop.seq_len), kv_chunk=min(1024, loop.seq_len),
                             opt=loop.opt)
    step, _, _ = make_train_step(cfg, None, settings, device=dev)
    model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(loop.seed), device=dev)
    opt_state = init_opt(param_leaves(model), loop.opt)
    rng = np.random.default_rng(4)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (loop.batch_size, loop.seq_len)), device=dev)
             for k in ("tokens", "labels")}
    params = train_params(model)
    before = [p.detach().clone() for p in params]
    step(model, opt_state, batch)
    moved = [int((p.detach() != b).sum()) for p, b in zip(params, before)]
    # bfloat16 weights at lr 3e-4 / 20: an entry moves only where the update
    # rounds in, but every tensor has such entries
    still = [i for i, n in enumerate(moved) if n == 0]
    check(not still, f"lm_train {LM_FULL}: a step left {len(still)} of {len(params)} parameter tensors unchanged")
    info["warm_step_moved"] = dict(entries=sum(moved), of=sum(p.numel() for p in params),
                                   matrices=sum(1 for p in params if p.ndim >= 2),
                                   tensors_moved=sum(1 for n in moved if n), tensors=len(params))
    info["profiled_step"] = under_profiler(step, model, opt_state, batch)[0]
    del model, opt_state, batch, params, before
    torch.cuda.empty_cache()
    print(f"lm_train {LM_FULL}: steps {[round(s) for s in info['step_ms']]} ms, warm {info['warm_tok_s']:.0f} tok/s, "
          f"peak {peak / 1e9:.2f} GB, losses {[round(x, 4) for x in losses]}", flush=True)
    return info


def lm_train_recovery(dev) -> dict:
    """The reference test's failure-recovery and resume runs on the card at
    its tiny config; the failure run's last checkpoint restored into a
    model on the CPU and one on the card: both give the checkpoint's
    bytes back, and the CPU's copy written again gives the same files."""
    import dataclasses
    import filecmp

    from repro_torch.checkpoint.manager import (
        CheckpointManager, flatten, latest_step, restore_checkpoint, save_checkpoint, train_tree,
    )
    from repro_torch.configs import get_smoke
    from repro_torch.ft.failures import FailurePlan
    from repro_torch.launch.train import TrainLoopConfig, run_training
    from repro_torch.models.convert import param_leaves
    from repro_torch.models.lm import init_lm
    from repro_torch.training.optimizer import init_opt

    cfg = dataclasses.replace(get_smoke(LM_FULL), **LM_TRAIN_TINY)
    info: dict = {"config": dict(LM_TRAIN_TINY)}
    with tempfile.TemporaryDirectory() as d:
        fail_dir, resume_dir = os.path.join(d, "fail"), os.path.join(d, "resume")
        loop = TrainLoopConfig(steps=14, batch_size=2, seq_len=16, ckpt_dir=fail_dir, ckpt_every=5, log_every=100,
                               failure_plan=FailurePlan(fail_at_steps=(12,), nodes=(0,)))
        out, ms = timed(run_training, cfg, loop, device=dev)
        check(out["steps_run"] == 14 and len(out["recoveries"]) == 1 and math.isfinite(out["final_loss"]),
              f"lm_train recovery: {out['steps_run']} steps, {len(out['recoveries'])} recoveries")
        info["recovery"] = dict(steps_run=out["steps_run"], recoveries=len(out["recoveries"]),
                                recovery_s=out["recoveries"][0]["recovery_s"], final_loss=out["final_loss"],
                                wall_ms=ms)
        loop = TrainLoopConfig(steps=6, batch_size=2, seq_len=16, ckpt_dir=resume_dir, ckpt_every=3, log_every=100)
        run_training(cfg, loop, device=dev)
        out = run_training(cfg, dataclasses.replace(loop, steps=9), resume=True, device=dev)
        check(out["steps_run"] == 9 and latest_step(resume_dir) == 9 and len(out["losses"]) == 3,
              f"lm_train resume: {out['steps_run']} steps")
        info["resume"] = dict(steps_run=out["steps_run"], latest_step=latest_step(resume_dir))

        step, flat = restore_checkpoint(fail_dir)
        copies = {}
        for where in (torch.device("cpu"), dev):
            model = init_lm(cfg, generator=torch.Generator(where).manual_seed(9), device=where)
            opt_state = init_opt(param_leaves(model), loop.opt)
            check(CheckpointManager(fail_dir).restore_latest(model, opt_state) == step, "restore_latest")
            copies[where.type] = (model, opt_state)
            got = flatten(train_tree(model, opt_state))
            check(sorted(got) == sorted(flat), f"lm_train: the state restored on {where.type} has other leaves")
            for path, leaf in got.items():
                check(leaf.dtype == flat[path].dtype and np.array_equal(leaf, flat[path]),
                      f"lm_train: {path} restored on {where.type} differs from the card's checkpoint")
        again = os.path.join(d, "again")
        save_checkpoint(again, step, train_tree(*copies["cpu"]), replicas=loop.replication_factor)
        a, b = os.path.join(fail_dir, f"step_{step:08d}"), os.path.join(again, f"step_{step:08d}")
        files = sorted(os.listdir(os.path.join(a, "data")))
        same, diff, err = filecmp.cmpfiles(os.path.join(a, "data"), os.path.join(b, "data"), files, shallow=False)
        check(not diff and not err and sorted(os.listdir(os.path.join(b, "data"))) == files,
              f"lm_train: the CPU's copy of step {step} writes other files: {diff} {err}")
        info["checkpoint"] = dict(step=step, leaves=len(flat), files=len(files), cpu_restore_bytes_equal=True,
                                  card_restore_bytes_equal=True, cpu_rewrite_files_equal=len(same))
    return info


def lm_train_phase(dev) -> dict:
    """The port's LM training path (plain PyTorch: no kernel of its own).
    (a) The ten SMOKE configs in float32, one ``make_train_step`` step on
    the card against the port's CPU path from the same weights and batch
    (``train_agreement``): the loss, and the step's loss, within 1e-5, the
    gradients within 1e-5 of the largest magnitude, the step's gradient
    norm within 1e-5 of itself, no MoE expert choice different, the
    stepped parameters within 1e-5 where both gradients exceed 1e-5 of the
    largest magnitude and within twice the learning rate elsewhere (Adam's
    first update is the rate times a sign, which flips where a gradient
    sits at the rounding level). (b) ``lm_train_full``. (c)
    ``lm_train_recovery``."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train_agreement
    from repro_torch.models.lm import init_lm
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.steps import TrainSettings

    info: dict = {"card": card_line(), "allocated_before_bytes": torch.cuda.memory_allocated()}
    settings = TrainSettings(remat="none", q_chunk=8, kv_chunk=8, opt=OptConfig(lr=LM_TRAIN_LR, warmup_steps=1))
    smoke = {}
    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        cpu_model = init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
        diff, ms = timed(train_agreement, cpu_model, copy.deepcopy(cpu_model).to(dev),
                         lm_train_batch(cfg, np.random.default_rng(0)), settings)
        check(diff["loss"] <= LM_TRAIN_F32_LOSS and diff["grad_rel"] <= LM_TRAIN_F32_GRAD
              and diff["step_loss"] <= LM_TRAIN_F32_LOSS and diff["step_grad_norm_rel"] <= LM_TRAIN_F32_GRAD
              and diff["params"] <= LM_TRAIN_F32_PARAM and diff["params_noise"] <= 2 * LM_TRAIN_LR * (1 + 1e-6)
              and diff.get("expert_choices_differ", 0) == 0, f"lm_train {arch}: the card differs from the CPU: {diff}")
        smoke[arch] = dict(diff, wall_ms=ms)
    info["smoke_vs_cpu"] = smoke
    info["bounds"] = dict(loss=LM_TRAIN_F32_LOSS, grad_rel=LM_TRAIN_F32_GRAD, step_grad_norm_rel=LM_TRAIN_F32_GRAD,
                          params=LM_TRAIN_F32_PARAM, params_noise=2 * LM_TRAIN_LR)
    info["full"] = lm_train_full(dev)
    info["recovery"] = lm_train_recovery(dev)
    info["reduced"] = {LM_FULL: "none: 30 layers at published widths; 8 steps, no checkpoint at full width"}
    return info


#: the mesh phase's runs: starcoder2-3b decode (batch, prompt, tokens), as
#: lm_serve's; qwen2-moe-a2.7b decode, a shorter prompt; the train step's batch
MESH_SERVE = (8, 1024, 32)
MESH_MOE = (8, 256, 16)
MESH_TRAIN = (8, 256)
MESH_F32_PARAM, MESH_GRAD_NORM_REL = 1e-5, 1e-5


def mesh_train_check(ctx, dev) -> dict:
    """One ``make_train_step`` step of starcoder2-3b at full width (bfloat16,
    ``MESH_TRAIN`` tokens, AdamW, remat ``dots``) without a mesh and through
    ``ctx``, from the same weights and batch: the loss, the gradients over
    their largest magnitude, the stepped parameters where both gradients
    exceed 1e-5 of the largest (``params``, bound ``MESH_F32_PARAM``) and
    elsewhere, and the gradient norm relative (bound ``MESH_GRAD_NORM_REL``);
    then a warm step of each, timed, and each run's peak memory. The
    first run's gradients and stepped parameters wait on the host."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import TrainLoopConfig
    from repro_torch.models.convert import full, param_leaves
    from repro_torch.models.lm import init_lm
    from repro_torch.parallel.sharding import place
    from repro_torch.training.optimizer import init_opt, schedule
    from repro_torch.training.steps import (
        TrainSettings, batch_specs, loss_and_grads, make_train_step, place_train_state, train_ctx, train_params,
    )

    cfg = get_arch(LM_FULL)
    loop = TrainLoopConfig()
    B, S = MESH_TRAIN
    settings = TrainSettings(remat=loop.remat, q_chunk=min(512, S), kv_chunk=min(1024, S), opt=loop.opt)
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device=dev) for k in ("tokens", "labels")}
    info: dict = dict(arch=LM_FULL, dtype=cfg.dtype, batch=B, seq=S, remat=settings.remat, opt=settings.opt.kind)
    ref = {}
    for name, c in (("one", None), ("mesh", ctx)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        tc = train_ctx(cfg, c, settings)
        placed = batch
        if c is not None:
            place_train_state(cfg, tc, settings, model)
            placed = {k: place(v, tc, batch_specs(cfg, tc)[k]) for k, v in batch.items()}
        loss, _, grads = loss_and_grads(model, placed, settings, tc)
        grads = [full(g) for g in grads]
        run: dict = dict(loss=float(loss))
        if name == "one":
            ref["grads"] = [g.to("cpu") for g in grads]
            ref["g_max"] = g_max = max(float(g.abs().max()) for g in grads)
        else:
            g_max, signal, gap = ref["g_max"], [], 0.0
            for g, r in zip(grads, ref["grads"]):
                r = r.to(dev)
                gap = max(gap, float((g.float() - r.float()).abs().max()))
                signal.append((torch.minimum(g.abs(), r.abs()).float() > 1e-5 * g_max).cpu())
            run["grad_rel"] = gap / g_max
        del grads
        step, _, _ = make_train_step(cfg, c, settings, device=dev)
        opt_state = init_opt(param_leaves(model), settings.opt)
        (_, _, m), run["step_ms"] = timed(step, model, opt_state, batch)
        run.update(step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        stepped = [full(p.detach()) for p in train_params(model)]
        if name == "one":
            ref["params"] = [p.to("cpu") for p in stepped]
        else:
            params = noise = 0.0
            for p, r, sig in zip(stepped, ref["params"], signal):
                d = (p.float() - r.to(dev).float()).abs()
                sig = sig.to(dev)
                params = max(params, float(d[sig].max()) if bool(sig.any()) else 0.0)
                noise = max(noise, float(d[~sig].max()) if bool((~sig).any()) else 0.0)
            run.update(params=params, params_noise=noise)
        del stepped
        (_, _, m), run["warm_step_ms"] = timed(step, model, opt_state, batch)
        run["peak_bytes"] = torch.cuda.max_memory_allocated()
        info[name] = run
        del model, opt_state, step
    one, mesh = info["one"], info["mesh"]
    info["step_grad_norm_rel"] = abs(one["grad_norm"] - mesh["grad_norm"]) / one["grad_norm"]
    info["lr"] = lr = schedule(settings.opt, 1)
    check(abs(one["loss"] - mesh["loss"]) <= 1e-5 * abs(one["loss"]) and mesh["params"] <= MESH_F32_PARAM
          and mesh["params_noise"] <= 2 * lr * (1 + 1e-6) and info["step_grad_norm_rel"] <= MESH_GRAD_NORM_REL,
          f"mesh train: the (1, 1) mesh's step differs from one device's: {info}")
    ref.clear()
    torch.cuda.empty_cache()
    print(f"mesh train {LM_FULL}: warm step {one['warm_step_ms']:.0f} ms without a mesh, "
          f"{mesh['warm_step_ms']:.0f} ms on it; params gap {mesh['params']:.2e}", flush=True)
    return info


def mesh_serve_check(arch: str, ctx, serve_sharding: str, shape, dev) -> dict:
    """``serve_batch`` of ``arch`` at its published width in bfloat16 without
    a mesh and through ``ctx`` with ``serve_sharding``, from the same
    weights (a model each, drawn alike) and prompts: the tokens equal, for
    MoE no expert choice different (both runs under ``route_log``); the
    walls, decode tokens/s and peak memory of each."""
    import contextlib

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models.lm import init_lm
    from repro_torch.models.moe import route_log

    B, P, G = shape
    cfg = get_arch(arch)
    info: dict = dict(arch=arch, dtype=cfg.dtype, serve_sharding=serve_sharding, batch=B, prompt=P, gen=G)
    runs, routes = {}, {}
    for name, c in (("one", None), ("mesh", ctx)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        with route_log(model) if cfg.is_moe else contextlib.nullcontext() as log:
            out = serve_batch(cfg, batch_size=B, prompt_len=P, gen_tokens=G, seed=0, device=dev, model=model, ctx=c,
                              serve_sharding=serve_sharding)
        if log is not None:
            routes[name] = [r["choices"].cpu() for r in log.calls]
        runs[name] = out["tokens"]
        info[name] = dict(prefill_ms=out["prefill_s"] * 1e3, decode_ms=out["decode_s"] * 1e3,
                          decode_tok_s=out["decode_tok_s"], peak_bytes=torch.cuda.max_memory_allocated(),
                          param_bytes=out["param_bytes"], cache_bytes=out["cache_bytes"])
        check(bool(torch.isfinite(out["logits"][..., : cfg.vocab_size]).all()), f"mesh {arch}: logits not finite")
        del model, out
    info["tokens_equal"] = bool(np.array_equal(runs["one"], runs["mesh"]))
    check(info["tokens_equal"], f"mesh {arch} {serve_sharding}: the mesh's tokens differ from one device's")
    if routes:
        check([r.shape for r in routes["one"]] == [r.shape for r in routes["mesh"]], f"mesh {arch}: routing calls")
        info["expert_choices_differ"] = sum(int((a != b).sum()) for a, b in zip(routes["one"], routes["mesh"]))
        check(info["expert_choices_differ"] == 0, f"mesh {arch}: {info['expert_choices_differ']} expert choices differ")
    torch.cuda.empty_cache()
    print(f"mesh {arch} {serve_sharding}: decode {info['one']['decode_tok_s']:.1f} tok/s without a mesh, "
          f"{info['mesh']['decode_tok_s']:.1f} on it", flush=True)
    return info


def mesh_phase(dev) -> dict:
    """The port's mesh placements (repro_torch.parallel.sharding and the
    model's regions; plain PyTorch, no kernel of its own) on a one-rank
    ("data", "model") = (1, 1) DeviceMesh over NCCL: ``mesh_train_check``,
    then ``mesh_serve_check`` on starcoder2-3b with ``serve_sharding``
    "fsdp" and "tp" and on qwen2-moe-a2.7b with "tp" (global EP: 60
    experts divide data × model). The process group is made here, through
    a ``FileStore`` in a temporary directory, and destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import GROUP_TIMEOUT_S, init_local_group
    from repro_torch.models.moe import ep_over_data_ok
    from repro_torch.configs import get_arch
    from repro_torch.parallel.sharding import make_ctx

    info: dict = {"card": card_line(), "mesh": {"shape": [1, 1], "axes": ["data", "model"], "backend": "nccl",
                                                "group_timeout_s": GROUP_TIMEOUT_S}}
    with tempfile.TemporaryDirectory() as d:
        init_local_group(0, 1, os.path.join(d, "store"), "nccl")
        try:
            ctx = make_ctx(init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model")))
            check(ep_over_data_ok(get_arch("qwen2-moe-a2.7b"), ctx), "qwen2-moe on (1, 1): global EP must apply")
            info["train"] = mesh_train_check(ctx, dev)
            info["serve"] = [mesh_serve_check(LM_FULL, ctx, mode, MESH_SERVE, dev) for mode in ("fsdp", "tp")]
            info["serve"].append(mesh_serve_check("qwen2-moe-a2.7b", ctx, "tp", MESH_MOE, dev))
        finally:
            dist.destroy_process_group()
    info["reduced"] = {"qwen2-moe-a2.7b": f"prompt {MESH_MOE[1]} and {MESH_MOE[2]} tokens (lm_serve: 1024, 32)"}
    return info


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=5.0, help="TPC-H scale factor (1.5 M rows each)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"run from the root of a checkout: {ROOT / 'src' / 'repro_torch'} is missing")
    sys.path.insert(0, str(ROOT / "src"))
    run(args, torch.device("cuda"))


def run(args, dev) -> None:
    """The phases on ``dev``, after ``main`` has put ``src`` on the path."""
    import repro_torch.core as T
    import repro_torch.core.tpch  # noqa: F401  (T.tpch)
    import repro_torch.kernels as K
    from repro_torch.kernels import _build, ops

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    phases = Phases()

    # 1. setup: build every kernel, one nvcc per source in parallel
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s", flush=True)

    key_cols, value_cols = T.tpch.generate_orders(args.sf, seed=args.seed)
    n_rows = len(key_cols["custkey"])
    wk_all, wv_all = T.tpch.generate_orders(1.0, seed=args.seed + 1, rows_per_sf=10 * WRITE_ROWS)
    writes = [
        (
            {c: v[i * WRITE_ROWS : (i + 1) * WRITE_ROWS] for c, v in wk_all.items()},
            {c: v[i * WRITE_ROWS : (i + 1) * WRITE_ROWS] for c, v in wv_all.items()},
        )
        for i in range(10)
    ]
    batches = read_batches(n_rows, args.seed)
    print(f"data: {n_rows} orders rows (SF {args.sf}), 10 writes of {WRITE_ROWS} rows", flush=True)
    # the oracle's rows: the CREATE rows, then after 8 and after 10 writes
    oracles = [
        Oracle(
            {c: np.concatenate([key_cols[c]] + [w[0][c] for w in writes[:k]]) for c in key_cols},
            {c: np.concatenate([value_cols[c]] + [w[1][c] for w in writes[:k]]) for c in value_cols},
            dev,
        )
        for k in (0, 8, 10)
    ]

    # 2. kernels against their plain versions
    report, write_kernels = phases.run("kernels", kernel_phase, key_cols, value_cols, writes, dev)

    # -- the main path: every launch count starts at 0 here ----------------------
    for fn in K.KERNELS.values():
        fn.launches = 0

    # 3. CREATE
    def create():
        eng = T.HREngine(n_nodes=6, device=dev)
        eng.create_column_family(
            "orders", key_cols, value_cols, replication_factor=3, mechanism="HR",
            workload=T.tpch.q1_q2_workload(n_rows=n_rows), schema=T.tpch.orders_schema(),
            device_resident=True,
        )
        for r in eng.column_families["orders"].replicas:
            st = eng._table(eng.column_families["orders"], r)._device
            check(st is not None and st["keys"].device.type == dev.type, f"replica {r.replica_id} is not resident")
        return eng

    eng = phases.run("create", create)
    print(f"layouts: {eng.layouts('orders')}", flush=True)

    # 4. reads
    batch_ms, write_ms = [], []
    select_checks = {}  # select_compact vs plain on the replica groups, per state

    def reads():
        outs = []
        for batch in batches:
            t = time.perf_counter()
            outs.append(eng.read_many("orders", batch))
            batch_ms.append((time.perf_counter() - t) * 1e3)
        hits = eng.stats["result_cache_hits"]
        again = eng.read_many("orders", batches[0])
        check(eng.stats["result_cache_hits"] > hits, "the repeated batch did not hit the result cache")
        for (a, _), (b, _) in zip(outs[0], again):
            check((a.value, a.rows_matched) == (b.value, b.rows_matched), "a cache hit differs")
        wide = wide_batch()
        wide_out = eng.read_many("orders", wide)
        scalar = [eng.read("orders", qq) for qq in batches[1][::16]]
        for qq, got, want in zip(batches[1][::16], scalar, outs[1][::16]):
            check(got[1].replica_id == want[1].replica_id, "read routes differently from read_many")
            check(got[0].rows_matched == want[0].rows_matched, f"read != read_many for {qq.filters}")
        for b, (batch, out) in enumerate(zip(batches, outs)):
            check_answers(eng, "orders", list(zip(batch, out)), oracles[0], f"batch {b} before writes")
        check_answers(eng, "orders", list(zip(wide, wide_out)), oracles[0], "wide")
        select_checks["orders_before_writes"] = select_check(eng, "orders", batches[0], outs[0], dev)

    phases.run("reads", reads)
    print(f"read_many batch ms (host clock): {[round(x, 3) for x in batch_ms]}", flush=True)

    # 5. the row-slab read path while every replica holds one sorted run
    from repro_torch.bench.row_slab import edge_check

    slab_batch = row_slab_batch(read_batches(n_rows, args.seed + 4)[0])

    def row_slab():
        info, launches = own_counts(row_slab_phase, eng, "orders", slab_batch, oracles[0], dev)
        for name in ROW_SLAB_KERNELS:
            check(launches[name] > 0, f"kernel {name} was not launched on the row-slab path")
        info["launches"] = launches
        rows, info["qgrid_design_bytes"], info["slab_locate"] = row_slab_kernel_phase(
            eng, "orders", slab_batch, dev
        )
        report.update(rows)
        # both scans bit for bit against their decomposition written out, on
        # the edge cases of that decomposition
        try:
            info["edge_cases"] = uncounted(edge_check, dev)
        except AssertionError as e:
            fail(str(e))
        return info

    row_slab_info = phases.run("row_slab", row_slab)

    # 6. the port's batched-read benchmark on one SF-scale replica, its
    # launches (a table of its own) counted apart from the main path's
    from repro_torch.bench.batched_read import run_device

    trajectory, bench_launches = phases.run(
        "batched_read", own_counts, lambda: run_device(
            n_rows=n_rows, batch_sizes=(16, 64, 256), seed=args.seed, repeats=3, numpy_repeats=1, device=dev,
        )
    )
    row_slab_info["batched_read_launches"] = {name: n for name, n in bench_launches.items() if n}

    # 7. writes, device compaction, reads over every row
    def timed_write(wk, wv):
        t = time.perf_counter()
        eng.write("orders", wk, wv)
        torch.cuda.synchronize()
        write_ms.append((time.perf_counter() - t) * 1e3)

    def writes_phase():
        cf = eng.column_families["orders"]
        for wk, wv in writes[:8]:
            timed_write(wk, wv)
        check(eng.stats["compactions"] > 0, "the 8th write did not compact")
        check(K.KERNELS["merge_run_positions"].launches > 0, "compaction did not launch the merge kernel")
        for r in cf.replicas:
            table = eng._table(cf, r)
            st = table._device
            check(st["n_runs"] == 1 and st["row_map"] is None, f"replica {r.replica_id} still holds runs")
            fresh = ops.build_device_state(table, device=dev)
            check(torch.equal(st["keys"], fresh["keys"]), f"replica {r.replica_id}: keys differ from a fresh build")
            check(
                torch.equal(st["values_tile"], fresh["values_tile"]),
                f"replica {r.replica_id}: value tile differs from a fresh build",
            )
            del fresh
        for wk, wv in writes[8:]:
            timed_write(wk, wv)
        check(
            all(eng._table(cf, r)._device["n_runs"] == 3 for r in cf.replicas),
            "the last two writes did not leave appended runs",
        )
        out = eng.read_many("orders", batches[2])
        check_answers(eng, "orders", list(zip(batches[2], out)), oracles[2], "after writes")
        wide = wide_batch()
        check_answers(eng, "orders", list(zip(wide, eng.read_many("orders", wide))), oracles[2], "wide after writes")
        check(cf.stats.n_rows == n_rows + len(writes) * WRITE_ROWS, "statistics missed rows")
        # appended run stacks: slab_many takes the host path, the scans refuse
        for r in cf.replicas:
            table = eng._table(cf, r)
            before = {name: fn.launches for name, fn in K.KERNELS.items()}
            check(np.array_equal(table.slab_many(slab_batch), host_slabs(table, slab_batch)), "slab_many after writes")
            check({name: fn.launches for name, fn in K.KERNELS.items()} == before, "slab_many launched on a run stack")
            try:
                ops.table_scan_device_many(table, slab_batch)
            except ValueError as e:
                check("single sorted run" in str(e), f"table_scan_device_many on a run stack: {e}")
            else:
                fail(f"table_scan_device_many served replica {r.replica_id}'s run stack")

    phases.run("writes", writes_phase)

    launches = {name: fn.launches for name, fn in K.KERNELS.items()}
    for name in ORDERS_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    # one compaction a replica; one histogram launch a write for all key columns
    check(launches["merge_run_positions"] == 3, f"merge_run_positions launched {launches['merge_run_positions']} times, not 3")
    check(launches["ecdf_hist"] == len(writes), f"ecdf_hist launched {launches['ecdf_hist']} times, not {len(writes)}")
    for name in ROW_SLAB_KERNELS:
        launches[name] = row_slab_info["launches"][name]
    stats = eng.stats
    write_layer = {
        "replica_flushes": stats["memtable_flushes"], "compactions": stats["compactions"],
        "flush_wall_ms_per_replica_flush": stats["flush_wall_seconds"] * 1e3 / stats["memtable_flushes"],
    }

    # 8. the partitioned path, its launch counts from 0 (orders_p, then orders_pv)
    def partitions():
        (info, peng), _ = own_counts(partitions_phase, key_cols, value_cols, writes, oracles, args.seed, dev)
        pv, pv_launches = own_counts(partitioned_views_phase, eng.layouts("orders"), args.seed, dev)
        pv["launches"] = {name: n for name, n in pv_launches.items() if n}
        info["orders_pv"] = pv
        torch.cuda.empty_cache()
        return info, peng

    partitions_info, peng = phases.run("partitions", partitions)
    report["ecdf_hist"]["token_hist"] = partitions_info["token_hist"]

    # 9. the read kernels on the replica groups of one fresh batch
    fresh = read_batches(n_rows, args.seed + 3)[0]
    group_report, read_layer = phases.run("groups", group_phase, eng, "orders", fresh, dev)
    report.update(group_report)
    select_checks["orders_after_writes"] = read_layer.pop("select_groups")

    # 10. the views path: its own launch counts, from 0
    veng, views = phases.run(
        "views", views_phase, eng, key_cols, value_cols, writes, batches, oracles, dev
    )
    for name in VIEW_KERNELS:
        launches[name] = views["launches"][name]
    select_checks.update(views.pop("select_checks"))
    read_layer["select_checks"] = select_checks
    oracles.clear()

    # 11. the view kernels against their plain versions
    report.update(phases.run("view_kernels", view_kernel_phase, veng, read_batches(n_rows, args.seed + 3)[0], dev))

    # 12. where a fresh batch's time goes, on both column families
    where = phases.run(
        "breakdown", breakdown_phase,
        {"orders": (eng, "orders"), "orders_v": (veng, "orders_v"), "orders_p": (peng, "orders_p")},
        n_rows, args.seed + 5,
    )

    # 13. the availability layer on the three column families, its launch
    # counts from 0, then added to the kernels line's
    (avail, outage), avail_launches = phases.run(
        "availability", own_counts, availability_phase,
        eng, veng, peng, key_cols, value_cols, writes, n_rows, args.seed,
        dev,
    )
    for name in AVAIL_KERNELS:
        check(avail_launches[name] > 0, f"kernel {name} was not launched on the availability path")
    avail["launches"] = {name: n for name, n in avail_launches.items() if n}
    for name, n in avail_launches.items():
        launches[name] += n

    # 14. ring migration, the drift trigger, a parallel write and read
    # deadlines, its launch counts from 0, then added to the kernels line's
    (migration, e_writes), migration_launches = phases.run(
        "migration", own_counts, migration_phase,
        eng, peng, key_cols, value_cols, writes, outage, n_rows, args.seed, dev,
    )
    for name in MIGRATION_KERNELS:
        check(migration_launches[name] > 0, f"kernel {name} was not launched on the migration path")
    migration["launches"] = {name: n for name, n in migration_launches.items() if n}
    for name, n in migration_launches.items():
        launches[name] += n

    # 15. the serving front door, traced, over orders as migration left it,
    # its launch counts from 0, then added to the kernels line's
    fd_rows = with_writes(key_cols, value_cols, writes + outage + e_writes)
    frontdoor, frontdoor_launches = phases.run(
        "frontdoor", own_counts, frontdoor_phase, eng, fd_rows, n_rows, args.seed, dev,
    )
    del fd_rows, outage, e_writes
    for name in FRONTDOOR_KERNELS:
        check(frontdoor_launches[name] > 0, f"kernel {name} was not launched on the front door path")
    frontdoor["launches"] = {name: n for name, n in frontdoor_launches.items() if n}
    for name, n in frontdoor_launches.items():
        launches[name] += n
    frontdoor["phase_ms"] = phases.ms["frontdoor"]

    # 16. the chaos harnesses, their launch counts from 0, then added
    chaos, chaos_launches = phases.run("chaos", own_counts, chaos_phase, dev)
    for name in CHAOS_KERNELS:
        check(chaos_launches[name] > 0, f"kernel {name} was not launched on the views chaos path")
    chaos["launches"] = {name: n for name, n in chaos_launches.items() if n}
    for name, n in chaos_launches.items():
        launches[name] += n
    chaos["phase_ms"] = phases.ms["chaos"]

    # 17. the LM serving path, once the engines' device state is released; it
    # launches none of the engine's kernels
    del eng, veng, peng
    gc.collect()
    torch.cuda.empty_cache()
    lm_serve, lm_launches = phases.run("lm_serve", own_counts, lm_serve_phase, dev)
    check(not any(lm_launches.values()), f"the LM serving path launched engine kernels: {lm_launches}")
    lm_serve["phase_ms"] = phases.ms["lm_serve"]

    # 18. the LM training path, after the serving models are freed; it too
    # launches none of the engine's kernels
    gc.collect()
    torch.cuda.empty_cache()
    lm_train, train_launches = phases.run("lm_train", own_counts, lm_train_phase, dev)
    check(not any(train_launches.values()), f"the LM training path launched engine kernels: {train_launches}")
    lm_train["phase_ms"] = phases.ms["lm_train"]

    # 19. the mesh placements on a one-rank mesh; they too launch none of the
    # engine's kernels
    gc.collect()
    torch.cuda.empty_cache()
    mesh, mesh_launches = phases.run("mesh", own_counts, mesh_phase, dev)
    check(not any(mesh_launches.values()), f"the mesh path launched engine kernels: {mesh_launches}")
    mesh["phase_ms"] = phases.ms["mesh"]

    # 20. report
    small_tile = report.pop("small_tile")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append(
            dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[name], ok=True, **report[name])
        )
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"phases_ms": phases.ms, "build_s": build_s, "card": card,
                      "read_many_batch_ms": batch_ms, "write_ms": write_ms, "rows": n_rows,
                      "read_layer": read_layer, "write_layer": write_layer}))
    print(json.dumps({"views": dict(
        card=card, orders_batch_ms=batch_ms,
        orders_v_batch_ms=[b["wall_ms"] for b in views["batches"]], **views,
        small_tile=small_tile, where_time=where,
    )}))
    print(json.dumps({"write_kernels": dict(card=card, **write_kernels)}))
    print(json.dumps({"row_slab": dict(card=card, **row_slab_info)}))
    print(json.dumps({"partitions": dict(card=card, **partitions_info)}))
    print(json.dumps({"batched_read": dict(card=card, **trajectory)}))
    print(json.dumps({"availability": avail}))
    print(json.dumps({"migration": migration}))
    print(json.dumps({"frontdoor": frontdoor}))
    print(json.dumps({"chaos": chaos}))
    print(json.dumps({"lm_serve": lm_serve}))
    print(json.dumps({"lm_train": lm_train}))
    print(json.dumps({"mesh": mesh}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
