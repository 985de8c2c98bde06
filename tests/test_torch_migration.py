"""Ring migration of the port (``HREngine.split_partition``,
``merge_partitions``, ``rebalance``, the ``rebalance_imbalance`` drift
trigger) against the reference's, on the CPU.

Mirrors ``tests/test_vnode_ring.py``'s ``TestSplitMerge``,
``TestRecoveryAfterMigration``, ``TestRebalanceAcceptance`` and
``TestMigrationSequences``, ``tests/test_vnode_properties.py``'s two
properties (derandomized) and ``tests/test_views.py``'s
``TestMigrationViews`` and interleavings. Every case runs the reference
and the port on the same numpy inputs with an explicit ``KeySchema`` and,
where the reference's test does, holds the port against its own P = 1
oracle. After every operation the two engines must agree on ring starts,
vnode ids, replica placement, layouts, rows moved and the replica each
query picks; counts and selects exactly, sums within rtol 1e-5 / atol
1e-3; every partition a migration keeps keeps its table objects. The
device-resident families (at most 3,000 rows) run the reference's
kernels in Pallas interpret mode and the port's plain versions; there a
view-served partial answer equals the port's fused scan on the same
table bit for bit.
"""

import copy
import gc
import weakref

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro_torch.core as T
import repro_torch.kernels.block_agg as TB
from repro.core.tpch import generate_simulation
from repro_torch.core.storage.views import verify_views
from repro_torch.kernels import ops as tops

LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-3
MIGRATION_KEYS = ("partition_splits", "partition_merges", "rebalance_rows_moved", "view_rebuilds")


def _zipf_columns(rng, n, schema, a=1.3):
    return {
        c: (np.minimum(rng.zipf(a, n), schema.max_value(c) + 1) - 1).astype(np.int64)
        for c in schema.bits
    }


def _mixed_queries(pkg, seed, schema, n=24, value_col="metric"):
    """The reference's generator: per query an equality or range on the
    leading key, or a short range on the last, over count/sum/select."""
    rng = np.random.default_rng(seed)
    cols = list(schema.bits)
    doms = {c: schema.max_value(c) + 1 for c in cols}
    lead, resid = cols[0], cols[-1]
    qs = []
    for i in range(n):
        agg = ("count", "sum", "select")[i % 3]
        u = rng.random()
        if u < 0.35:
            f = {lead: pkg.Eq(int(rng.integers(0, doms[lead])))}
        elif u < 0.65:
            lo = int(rng.integers(0, doms[lead] - 1))
            width = int(rng.integers(1, max(2, doms[lead] // 3)))
            f = {lead: pkg.Range(lo, min(lo + width, doms[lead]))}
        else:
            lo = int(rng.integers(0, doms[resid] - 1))
            f = {resid: pkg.Range(lo, min(lo + 2, doms[resid]))}
        qs.append(pkg.Query(filters=f, agg=agg, value_col=value_col if agg == "sum" else None))
    return qs


def _engine(pkg, kc, vc, schema, *, partitions, rf=3, n_nodes=6, engine_kw=None, **cf_kw):
    eng = pkg.HREngine(n_nodes=n_nodes, **({"device": "cpu"} if pkg is T else {}), **(engine_kw or {}))
    eng.create_column_family(
        "cf", kc, vc, replication_factor=rf, layouts=LAYOUTS[:rf],
        schema=pkg.KeySchema(dict(schema.bits)), partitions=partitions, **cf_kw,
    )
    return eng


class Pair:
    """The reference engine and the port's, built from the same inputs and
    driven through the same calls."""

    def __init__(self, kc, vc, schema, **kw):
        self.schema = schema
        self.ref = _engine(R, kc, vc, schema, **kw)
        self.port = _engine(T, kc, vc, schema, **kw)

    @property
    def engines(self):
        return (self.ref, self.port)

    def both(self, method, *args, **kwargs):
        """``method`` on both engines; the port's answer must equal the
        reference's (a cut token, a rebalance report, None). A migration
        must keep every surviving vnode's tables as the same objects."""
        before = _tables_by_vnode(self.port)
        a = getattr(self.ref, method)(*args, **kwargs)
        b = getattr(self.port, method)(*args, **kwargs)
        assert a == b, (method, a, b)
        if method in ("split_partition", "merge_partitions", "rebalance"):
            after = _tables_by_vnode(self.port)
            for vnode in set(before) & set(after):
                assert all(x is y for x, y in zip(before[vnode], after[vnode])), vnode
        assert_same_ring(self.ref, self.port)
        return b

    def write(self, kw, vw, **kwargs):
        for e in self.engines:
            e.write("cf", kw, vw, **kwargs)
        assert_same_ring(self.ref, self.port)

    def reads(self, seed, n=18):
        """The same mixed batch on both: same picks, equal answers.
        Returns the port's batch and answers."""
        rq, tq = _mixed_queries(R, seed, self.schema, n), _mixed_queries(T, seed, self.schema, n)
        out = self.port.read_many("cf", tq)
        assert_reads_equal(self.ref.read_many("cf", rq), out)
        return tq, out


def _tables_by_vnode(eng):
    cf = eng.column_families["cf"]
    return {
        p.vnode_id: [eng.nodes[r.node_id].tables.get(("cf", r.replica_id)) for r in p.replicas]
        for p in cf.partitions
    }


def assert_same_ring(ref, port):
    rcf, pcf = ref.column_families["cf"], port.column_families["cf"]
    assert rcf.ring.starts == pcf.ring.starts
    assert [(p.partition_id, p.vnode_id, p.token_lo, p.token_hi) for p in rcf.partitions] == [
        (p.partition_id, p.vnode_id, p.token_lo, p.token_hi) for p in pcf.partitions
    ]
    assert [(r.replica_id, r.node_id, r.partition_id, r.layout) for r in rcf.replicas] == [
        (r.replica_id, r.node_id, r.partition_id, r.layout) for r in pcf.replicas
    ]
    assert ref.layouts("cf") == port.layouts("cf")
    assert [p.n_rows_committed for p in rcf.partitions] == [p.n_rows_committed for p in pcf.partitions]
    assert [(p.token_min, p.token_max) for p in rcf.partitions] == [(p.token_min, p.token_max) for p in pcf.partitions]
    assert [(p.flushed_lsn, p.hints) for p in rcf.partitions] == [(p.flushed_lsn, p.hints) for p in pcf.partitions]
    assert [sorted(n.tables) for n in ref.nodes] == [sorted(n.tables) for n in port.nodes]
    assert {k: ref.stats[k] for k in MIGRATION_KEYS} == {k: port.stats[k] for k in MIGRATION_KEYS}
    assert ref.partition_imbalance("cf") == port.partition_imbalance("cf")


def assert_reads_equal(ref_out, port_out):
    for (ra, pa), (rb, pb) in zip(ref_out, port_out):
        assert (pa.replica_id, pa.node_id) == (pb.replica_id, pb.node_id)
        assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
        np.testing.assert_allclose(ra.value, rb.value, rtol=RTOL, atol=ATOL)
        if ra.selected is None:
            assert rb.selected is None
        else:
            np.testing.assert_array_equal(ra.selected, rb.selected)


def _selected_rows(eng, selected, value_col="metric"):
    """Global select indices as sorted ``(keys…, value)`` rows: the
    layout-independent form the oracle comparison uses."""
    cf = eng.column_families["cf"]
    offsets = eng._partition_row_offsets(cf)
    pids = np.searchsorted(offsets, selected, side="right") - 1
    rows = []
    for pid, g in zip(pids, selected):
        t = eng._table(cf, cf.partitions[int(pid)].replicas[0])
        li = int(g - offsets[int(pid)])
        rows.append(
            tuple(int(t.key_cols[c][li]) for c in cf.key_names) + (float(np.asarray(t.value_cols[value_col])[li]),)
        )
    return sorted(rows)


def assert_oracle_equal(eng, oracle, qs, *, rows=False):
    for q, (a, _), (b, _) in zip(qs, oracle.read_many("cf", qs), eng.read_many("cf", qs)):
        assert b.rows_matched == a.rows_matched, q
        if q.agg == "sum":
            np.testing.assert_allclose(b.value, a.value, rtol=1e-9)
        else:
            assert b.value == a.value, q
        if rows and q.agg == "select":
            assert _selected_rows(eng, b.selected) == _selected_rows(oracle, a.selected), q


def _write_batch(rng, schema, n):
    kw = {c: rng.integers(0, schema.max_value(c) + 1, n).astype(np.int64) for c in ("k0", "k1", "k2")}
    return kw, {"metric": rng.uniform(0, 1, n)}


# -- split and merge -------------------------------------------------------------------


class TestSplitMerge:
    def _small(self, seed=10, partitions=2, rf=2, **engine_kw):
        kc, vc, schema = generate_simulation(3_000, 3, seed=seed)
        pair = Pair(kc, vc, schema, partitions=partitions, rf=rf, engine_kw=engine_kw)
        oracle = _engine(T, kc, vc, schema, partitions=1, rf=rf)
        return pair, oracle, schema

    def test_split_preserves_oracle_equality_and_counts(self):
        pair, oracle, schema = self._small()
        token = pair.both("split_partition", "cf", 0)
        cf = pair.port.column_families["cf"]
        assert cf.ring.n_partitions == 3 and token in cf.ring.starts
        st_ = pair.port.stats
        assert (st_["partition_splits"], st_["partition_merges"]) == (1, 0)
        assert st_["rebalance_rows_moved"] > 0
        assert sorted(p.vnode_id for p in cf.partitions) == [1, 2, 3]
        qs, _ = pair.reads(20)
        assert_oracle_equal(pair.port, oracle, qs)

    def test_default_split_halves_the_rows(self):
        pair, _, _ = self._small()
        cf = pair.port.column_families["cf"]
        before = cf.partitions[0].n_rows_committed
        pair.both("split_partition", "cf", 0)
        a, b = cf.partitions[0], cf.partitions[1]
        assert a.n_rows_committed + b.n_rows_committed == before
        assert 0 < a.n_rows_committed < before
        assert pair.port.stats["rebalance_rows_moved"] == before

    def test_merge_restores_oracle_equality(self):
        pair, oracle, schema = self._small(partitions=4)
        pair.both("merge_partitions", "cf", 1)
        assert pair.port.column_families["cf"].ring.n_partitions == 3
        assert pair.port.stats["partition_merges"] == 1
        qs, _ = pair.reads(21)
        assert_oracle_equal(pair.port, oracle, qs)

    def test_split_then_merge_round_trips(self):
        pair, oracle, schema = self._small(rf=1)
        tok = pair.both("split_partition", "cf", 1)
        pair.both("merge_partitions", "cf", 1)
        cf = pair.port.column_families["cf"]
        assert cf.ring.n_partitions == 2 and tok not in cf.ring.starts
        qs, _ = pair.reads(22)
        assert_oracle_equal(pair.port, oracle, qs, rows=True)

    def test_writes_route_by_new_ring_after_split(self):
        pair, oracle, schema = self._small()
        rng = np.random.default_rng(23)
        pair.both("split_partition", "cf", 0)
        kw, vw = _write_batch(rng, schema, 200)
        pair.write(kw, vw)
        oracle.write("cf", kw, vw)
        cf = pair.port.column_families["cf"]
        for part in cf.partitions:
            toks = T.pack_columns(part.commitlog.replay_columns()[0], cf.key_names, cf.schema)
            assert ((toks >= part.token_lo) & (toks <= part.token_hi)).all()
        qs, _ = pair.reads(24, n=12)
        assert_oracle_equal(pair.port, oracle, qs)

    def test_staged_rows_survive_migration(self):
        """Rows staged under the group-commit threshold are log records:
        they ride the log-slicing migration, and the fresh vnodes' memtables
        start empty."""
        pair, oracle, schema = self._small(memtable_rows=1 << 30)
        rng = np.random.default_rng(24)
        kw, vw = _write_batch(rng, schema, 150)
        pair.write(kw, vw, flush=False)
        oracle.write("cf", kw, vw, flush=False)
        staged = pair.port.stats["staged_rows"]
        assert staged == pair.ref.stats["staged_rows"] > 0
        pair.both("split_partition", "cf", 0)
        assert pair.port.stats["staged_rows"] == pair.ref.stats["staged_rows"] < staged
        qs, _ = pair.reads(25, n=12)
        assert_oracle_equal(pair.port, oracle, qs)

    def test_validation(self):
        pair, _, _ = self._small(partitions=2)
        cf = pair.port.column_families["cf"]
        with pytest.raises(ValueError, match="no right neighbor"):
            pair.port.merge_partitions("cf", 1)
        with pytest.raises(ValueError, match="outside partition"):
            pair.port.split_partition("cf", 0, token=cf.partitions[1].token_hi)

    def test_untouched_partitions_keep_tables_and_cache(self):
        """Only the split partition's replicas lose their tables and cached
        results; the other vnode keeps its tables, log, statistics, warm
        cache entries and round-robin counter."""
        pair, _, _ = self._small(partitions=2)
        eng = pair.port
        cf = eng.column_families["cf"]
        keep, split = cf.partitions[1], cf.partitions[0]
        keep_tables = {r.replica_id: eng._table(cf, r) for r in keep.replicas}
        keep_ids = {r.replica_id for r in keep.replicas}
        split_ids = {r.replica_id for r in split.replicas}
        keep_log, keep_stats, keep_rr = keep.commitlog, keep.stats, keep.rr_counter
        for e, pkg in ((pair.ref, R), (eng, T)):
            q = pkg.Query(filters={"k1": pkg.Eq(3)}, agg="count")
            e.read_many("cf", [q])
            e.read_many("cf", [q])
        cached_keep = {k for k in eng._result_cache if k[1] in keep_ids}
        cached_split = {k for k in eng._result_cache if k[1] in split_ids}
        assert cached_keep and cached_split
        assert set(eng._result_cache) == set(pair.ref._result_cache)
        pair.both("split_partition", "cf", 0)
        assert keep in cf.partitions
        for r in keep.replicas:
            assert eng._table(cf, r) is keep_tables[r.replica_id]
        assert cached_keep <= set(eng._result_cache)
        assert set(eng._result_cache) == set(pair.ref._result_cache)
        assert keep.commitlog is keep_log and keep.stats is keep_stats and keep.rr_counter is keep_rr
        for rid in split_ids:
            assert ("cf", rid) not in eng._result_cache and ("cf", rid) not in eng._cache_sel_bytes
            assert all(("cf", rid) not in n.tables for n in eng.nodes)

    def test_rebuilt_partition_stats_match_recompute(self):
        pair, _, _ = self._small(partitions=4, rf=1)
        pair.both("merge_partitions", "cf", 2)
        rpart = pair.ref.column_families["cf"].partitions[2]
        part = pair.port.column_families["cf"].partitions[2]
        kc_p, _ = part.commitlog.replay_columns()
        fresh = T.TableStats.from_columns(kc_p, pair.port.column_families["cf"].schema)
        assert part.stats.n_rows == fresh.n_rows == rpart.stats.n_rows
        for c in fresh.columns:
            np.testing.assert_allclose(part.stats.columns[c].counts, fresh.columns[c].counts)
            np.testing.assert_array_equal(part.stats.columns[c].counts, rpart.stats.columns[c].counts)


# -- recovery after migration ----------------------------------------------------------


def _assert_log_equals_survivor(eng, ref=None):
    """Fail a node hosting a replica of partition 0 and recover it from
    the log and, in a copy, from a survivor: every rebuilt replica equal
    (packed keys, key columns, fingerprint), and equal to the reference's
    log rebuild when ``ref`` is given."""
    cf = eng.column_families["cf"]
    victim = cf.partitions[0].replicas[0].node_id
    e_log, e_sur = copy.deepcopy(eng), copy.deepcopy(eng)
    e_log.fail_node(victim)
    e_log.recover_node(victim, source="log")
    e_sur.fail_node(victim)
    e_sur.recover_node(victim, source="survivor")
    if ref is not None:
        ref = copy.deepcopy(ref)
        ref.fail_node(victim)
        ref.recover_node(victim, source="log")
    checked = 0
    for part in cf.partitions:
        for r in part.replicas:
            if r.node_id != victim:
                continue
            t_log = e_log._table(e_log.column_families["cf"], r)
            t_sur = e_sur._table(e_sur.column_families["cf"], r)
            np.testing.assert_array_equal(t_log.packed, t_sur.packed)
            for c in t_log.key_cols:
                np.testing.assert_array_equal(t_log.key_cols[c], t_sur.key_cols[c])
            assert t_log.dataset_fingerprint() == t_sur.dataset_fingerprint()
            if ref is not None:
                t_ref = ref._table(ref.column_families["cf"], r)
                np.testing.assert_array_equal(t_log.packed, t_ref.packed)
                assert t_log.stored_digest == t_ref.stored_digest
            checked += 1
    assert checked > 0


class TestRecoveryAfterMigration:
    def test_log_replay_bit_identical_after_split(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=30)
        rng = np.random.default_rng(30)
        pair = Pair(kc, vc, schema, partitions=2, rf=2, n_nodes=5)
        for _ in range(2):
            pair.write(*_write_batch(rng, schema, 120))
        pair.both("split_partition", "cf", 0)
        pair.both("merge_partitions", "cf", 1)
        _assert_log_equals_survivor(pair.port, pair.ref)

    @pytest.mark.parametrize("transient", [False, True])
    def test_split_with_node_down_installs_on_recovery(self, transient):
        """A reshard while a node is down installs nothing on it: a fresh
        vnode has no hints and watermarks only for the replicas it
        installed, as in the reference. A lost node's ``recover_node``
        rebuilds the new vnodes' replicas from the migrated logs; a
        transient one's ``node_up`` keeps the kept vnode's hint and falls
        back to a full rebuild for the migrated replicas it never held."""
        kc, vc, schema = generate_simulation(2_500, 3, seed=31)
        pair = Pair(kc, vc, schema, partitions=2, rf=2, n_nodes=4)
        oracle = _engine(T, kc, vc, schema, partitions=1, rf=2, n_nodes=4)
        cf = pair.port.column_families["cf"]
        victim = cf.partitions[0].replicas[0].node_id
        for e in pair.engines:
            e.fail_node(victim, transient=transient)
        pair.both("split_partition", "cf", 0)
        fresh = [p for p in cf.partitions if p.vnode_id >= 2]
        for p in fresh:
            assert p.hints == {}
            assert set(p.flushed_lsn) == {r.replica_id for r in p.replicas if r.node_id != victim}
            assert all(lsn == p.commitlog.next_lsn for lsn in p.flushed_lsn.values())
        assert not any(k[1] in {r.replica_id for p in fresh for r in p.replicas} for k in pair.port.nodes[victim].tables)
        if transient:
            for e in pair.engines:
                e.node_up(victim)
            assert pair.port.stats["hint_fallbacks"] == pair.ref.stats["hint_fallbacks"]
        else:
            assert pair.port.nodes[victim].tables == {}
            for e in pair.engines:
                e.recover_node(victim, source="log")
        assert_same_ring(pair.ref, pair.port)
        for part in cf.partitions:
            assert len({pair.port._table(cf, r).dataset_fingerprint() for r in part.replicas}) == 1
            assert all(lsn == part.commitlog.next_lsn for lsn in part.flushed_lsn.values())
        qs, _ = pair.reads(31, n=12)
        assert_oracle_equal(pair.port, oracle, qs)


# -- rebalance -------------------------------------------------------------------------


class TestRebalanceAcceptance:
    """A Zipf keyspace at P = 8 equal splits rebalances to <= 1.25x, with
    reads equal to the P = 1 oracle."""

    def _zipf(self, partitions, rf=1, n=12_000, seed=40, **engine_kw):
        schema = R.KeySchema({"k0": 8, "k1": 8, "k2": 8})
        rng = np.random.default_rng(seed)
        kc = _zipf_columns(rng, n, schema)
        vc = {"metric": rng.uniform(0, 1, n)}
        pair = Pair(kc, vc, schema, partitions=partitions, rf=rf, n_nodes=8, engine_kw=engine_kw)
        oracle = _engine(T, kc, vc, schema, partitions=1, rf=rf, n_nodes=8)
        return pair, oracle, schema

    def test_zipf_p8_rebalances_under_1_25(self):
        pair, oracle, schema = self._zipf(8)
        before = pair.port.partition_imbalance("cf")
        assert before > 2.0
        info = pair.both("rebalance", "cf")
        assert info["imbalance_before"] == before
        assert info["imbalance_after"] <= 1.25 and info["rows_moved"] > 0
        assert pair.port.column_families["cf"].ring.n_partitions == 8
        qs, _ = pair.reads(40, n=24)
        assert_oracle_equal(pair.port, oracle, qs, rows=True)

    def test_histogram_rebalance_reduces_imbalance(self):
        pair, _, _ = self._zipf(8)
        before = pair.port.partition_imbalance("cf")
        info = pair.both("rebalance", "cf", exact=False)
        assert info["imbalance_after"] < before

    def test_rebalance_changes_partition_count(self):
        pair, oracle, schema = self._zipf(4, n=6_000)
        info = pair.both("rebalance", "cf", partitions=6)
        assert info["partitions"] == 6 and pair.port.column_families["cf"].ring.n_partitions == 6
        assert pair.port.partition_imbalance("cf") <= 1.25
        qs, _ = pair.reads(41, n=12)
        assert_oracle_equal(pair.port, oracle, qs)

    def test_rebalance_is_idempotent(self):
        pair, _, _ = self._zipf(8, n=6_000)
        pair.both("rebalance", "cf")
        moved = pair.port.stats["rebalance_rows_moved"]
        tables = _tables_by_vnode(pair.port)
        assert pair.both("rebalance", "cf")["rows_moved"] == 0
        assert pair.port.stats["rebalance_rows_moved"] == moved
        assert _tables_by_vnode(pair.port).keys() == tables.keys()

    def test_auto_rebalance_on_write_drift(self):
        """``rebalance_imbalance``: uniform data stays put; skewed writes
        push the token histogram past the threshold and the write path
        reshards by itself, exactly as often as the reference's."""
        kc, vc, schema = generate_simulation(4_000, 3, seed=41)
        rng = np.random.default_rng(41)
        pair = Pair(kc, vc, schema, partitions=4, rf=1, engine_kw={"rebalance_imbalance": 2.0})
        assert pair.port.rebalance_imbalance == 2.0
        assert pair.port.stats["rebalance_rows_moved"] == 0
        for _ in range(4):
            kw = {c: rng.integers(0, 4, 2_000).astype(np.int64) for c in ("k0", "k1", "k2")}
            pair.write(kw, {"metric": rng.uniform(0, 1, 2_000)})
        assert pair.port.stats["rebalance_rows_moved"] > 0
        cf = pair.port.column_families["cf"]
        assert cf.token_hist.imbalance(cf.ring.starts) <= 2.0
        pair.reads(42, n=12)


# -- random migration programs ---------------------------------------------------------


def apply_migration_ops(pair, ops):
    """Apply ``(op, index)`` programs to both engines, indices reduced
    modulo the live partition count (the reference's helper)."""
    applied = []
    for op, idx in ops:
        P = pair.port.column_families["cf"].ring.n_partitions
        if op == "split":
            part = pair.port.column_families["cf"].partitions[idx % P]
            if part.token_hi > part.token_lo:
                pair.both("split_partition", "cf", idx % P)
                applied.append((op, idx % P))
        elif op == "merge":
            if P > 1:
                pair.both("merge_partitions", "cf", idx % (P - 1))
                applied.append((op, idx % (P - 1)))
        else:
            pair.both("rebalance", "cf")
            applied.append((op, 0))
    return applied


def _random_ops(rng):
    return [
        (str(rng.choice(["split", "merge", "rebalance"])), int(rng.integers(0, 64)))
        for _ in range(int(rng.integers(2, 6)))
    ]


def _sequence_equals_oracle(seed, ops, n=800):
    kc, vc, schema = generate_simulation(n, 3, seed=seed)
    pair = Pair(kc, vc, schema, partitions=2, rf=1, n_nodes=4)
    oracle = _engine(T, kc, vc, schema, partitions=1, rf=1, n_nodes=4)
    applied = apply_migration_ops(pair, ops)
    cf = pair.port.column_families["cf"]
    assert sum(p.n_rows_committed for p in cf.partitions) == n
    qs, _ = pair.reads(seed + 7, n=12)
    assert_oracle_equal(pair.port, oracle, qs, rows=True), applied


def _sequence_recovers_bit_identically(seed, ops, n=600):
    kc, vc, schema = generate_simulation(n, 3, seed=seed)
    pair = Pair(kc, vc, schema, partitions=2, rf=2, n_nodes=4)
    apply_migration_ops(pair, ops)
    _assert_log_equals_survivor(pair.port, pair.ref)


class TestMigrationSequences:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_sequence_equals_p1_oracle(self, seed):
        _sequence_equals_oracle(seed, _random_ops(np.random.default_rng(1000 + seed)))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_log_recovery_bit_identical_after_random_sequence(self, seed):
        _sequence_recovers_bit_identically(seed, _random_ops(np.random.default_rng(2000 + seed)))


@st.composite
def op_sequences(draw):
    n_ops = draw(st.integers(min_value=1, max_value=5))
    return [
        (draw(st.sampled_from(["split", "merge", "rebalance"])), draw(st.integers(min_value=0, max_value=63)))
        for _ in range(n_ops)
    ]


class TestMigrationProperties:
    """``tests/test_vnode_properties.py``, derandomized."""

    @settings(max_examples=12, deadline=None, derandomize=True, database=None)
    @given(ops=op_sequences(), seed=st.integers(min_value=0, max_value=3))
    def test_any_split_merge_sequence_equals_p1_oracle(self, ops, seed):
        _sequence_equals_oracle(seed, ops)

    @settings(max_examples=8, deadline=None, derandomize=True, database=None)
    @given(ops=op_sequences(), seed=st.integers(min_value=0, max_value=2))
    def test_log_recovery_bit_identical_after_any_sequence(self, ops, seed):
        _sequence_recovers_bit_identically(seed, ops)


# -- device-resident families with views ---------------------------------------------


class Partials:
    """Records each (replica, query, partial answer) of an engine's reads:
    wraps ``_execute_group``, through which every (partition, replica)
    group goes. It only observes."""

    def __init__(self, eng):
        self.items = []
        inner = eng._execute_group

        def recording(cf, r, qidx, queries, est_rows, est_costs, results, reports, **kw):
            inner(cf, r, qidx, queries, est_rows, est_costs, results, reports, **kw)
            for qi in qidx:
                if reports[qi] is not None and reports[qi].replica_id == r.replica_id:
                    self.items.append((r, queries[qi], results[qi]))

        eng._execute_group = recording


def assert_view_bits(eng, partials):
    """Every recorded partial answer of a view-eligible query equals the
    port's fused scan on the table that served it, bit for bit. Returns
    how many were view-eligible."""
    cf = eng.column_families["cf"]
    groups = {}
    for r, q, res in partials.items:
        if eng._table(cf, r)._view_eligible(q):
            groups.setdefault(r.replica_id, (r, []))[1].append((q, res))
    for r, items in groups.values():
        fused = tops.table_execute_device_many(eng._table(cf, r), [q for q, _ in items])
        for (q, a), b in zip(items, fused):
            assert (a.value, a.rows_matched, a.rows_scanned) == (b.value, b.rows_matched, b.rows_scanned), q
    partials.items.clear()
    return sum(len(v[1]) for v in groups.values())


def _view_queries(pkg, seed, n, domain, aggs=("sum", "count", "select")):
    rng = np.random.default_rng(seed)
    qs = []
    for _ in range(n):
        f = {}
        for c in ("k0", "k1", "k2"):
            u = rng.random()
            if u < 0.35:
                f[c] = pkg.Eq(int(rng.integers(0, domain)))
            elif u < 0.65:
                lo = int(rng.integers(0, domain - 1))
                f[c] = pkg.Range(lo, int(rng.integers(lo + 1, domain + 1)))
        qs.append(pkg.Query(agg=str(rng.choice(list(aggs))), filters=f, value_col="metric"))
    return qs


class ViewsPair(Pair):
    """A device-resident views family on both engines (the reference in
    interpret mode); the port's partial answers are recorded."""

    def __init__(self, kc, vc, schema, **kw):
        super().__init__(kc, vc, schema, rf=3, n_nodes=5, device_resident=True, views=True, **kw)
        self.partials = Partials(self.port)
        self.domain = schema.max_value("k0") + 1

    def view_reads(self, seed, n=20, aggs=("sum", "count", "select")):
        rq = _view_queries(R, seed, n, self.domain, aggs)
        tq = _view_queries(T, seed, n, self.domain, aggs)
        out = self.port.read_many("cf", tq)
        assert_reads_equal(self.ref.read_many("cf", rq), out)
        return assert_view_bits(self.port, self.partials)

    def all_views_valid(self):
        cf = self.port.column_families["cf"]
        for r in cf.replicas:
            t = self.port.nodes[r.node_id].tables.get(("cf", r.replica_id))
            if t is not None:
                assert t.has_views and verify_views(t) and t._device["keys"].device == CPU


def _write_views(rng, domain, m):
    kw = {c: rng.integers(0, domain, m).astype(np.int64) for c in ("k0", "k1", "k2")}
    return kw, {"metric": rng.standard_normal(m)}


class TestMigrationViews:
    def build(self, partitions=4):
        kc, vc, schema = generate_simulation(3_000, 3, seed=6)
        return ViewsPair(kc, vc, schema, partitions=partitions, engine_kw={"result_cache": False})

    def test_split_merge_rebalance_parity(self, monkeypatch):
        """Split, merge, a write and a rebalance on both engines: after
        each, reads agree with the reference's, view-served partials equal
        the fused scan bit for bit, views are rebuilt on the resharded
        vnodes only (on the ``block_sums`` wrapper) and every view
        verifies."""
        pair = self.build()
        calls = []
        real = TB.block_sums
        monkeypatch.setattr(TB, "block_sums", lambda *a, **k: calls.append(1) or real(*a, **k))
        served = pair.view_reads(41)
        pair.both("split_partition", "cf", 0)
        assert pair.port.stats["view_rebuilds"] == 6 and len(calls) == 6
        served += pair.view_reads(41)
        pair.both("merge_partitions", "cf", 1)
        served += pair.view_reads(41)
        rng = np.random.default_rng(43)
        pair.write(*_write_views(rng, pair.domain, 400))
        pair.both("rebalance", "cf")
        served += pair.view_reads(41)
        pair.all_views_valid()
        assert served > 0 and pair.port.stats["view_rebuilds"] > 6

    def test_untouched_vnodes_keep_their_views(self):
        pair = self.build()
        cf = pair.port.column_families["cf"]
        keep = cf.partitions[-1]
        before = {r.replica_id: pair.port._table(cf, r)._device["views"] for r in keep.replicas}
        sums = {rid: np.array(v["block_sums"], copy=True) for rid, v in before.items()}
        pair.both("split_partition", "cf", 0)
        keep2 = cf.partitions[-1]
        assert keep2 is keep
        for r in keep2.replicas:
            views = pair.port._table(cf, r)._device["views"]
            assert views is before[r.replica_id]
            np.testing.assert_array_equal(views["block_sums"], sums[r.replica_id])

    def test_retired_tables_release_their_tensors(self):
        """After a migration nothing of the engine holds a retired
        replica's table: with the garbage collector off, every retired
        table is gone once the migration returns, and the new tables sit
        on the engine's device."""
        pair = self.build(partitions=2)
        eng = pair.port
        cf = eng.column_families["cf"]
        eng.read_many("cf", _view_queries(T, 3, 8, pair.domain))
        refs = [weakref.ref(eng._table(cf, r)) for r in cf.replicas]
        gc.disable()
        try:
            eng.rebalance("cf", partitions=3)
            assert all(w() is None for w in refs)
        finally:
            gc.enable()
        pair.ref.rebalance("cf", partitions=3)
        assert_same_ring(pair.ref, eng)
        pair.all_views_valid()


OPS = ("write", "flush", "split", "merge", "rebalance", "read")


def _interleaving(seed, ops):
    """An op sequence on a P = 2 views family (group commit at 400 rows)
    on both engines; after every step the reads agree and view-served
    partials equal the fused scan bit for bit."""
    kc, vc, schema = generate_simulation(2_000, 3, seed=seed)
    pair = ViewsPair(kc, vc, schema, partitions=2, memtable_rows=400, engine_kw={"result_cache": False})
    rng = np.random.default_rng(seed + 17)
    for step, op in enumerate(ops):
        if op == "write":
            pair.write(*_write_views(rng, pair.domain, int(rng.integers(100, 900))))
        elif op == "flush":
            for e in pair.engines:
                e.flush_memtables("cf")
        elif op == "split":
            pair.both("split_partition", "cf", int(rng.integers(pair.port.column_families["cf"].ring.n_partitions)))
        elif op == "merge":
            n_p = pair.port.column_families["cf"].ring.n_partitions
            if n_p > 1:
                pair.both("merge_partitions", "cf", int(rng.integers(n_p - 1)))
        elif op == "rebalance":
            pair.both("rebalance", "cf")
        pair.view_reads(seed + 3, n=12, aggs=("sum", "count"))
    pair.all_views_valid()


class TestInterleavingDeterministic:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_interleavings(self, seed):
        rng = np.random.default_rng(100 + seed)
        _interleaving(seed, [str(rng.choice(OPS)) for _ in range(8)])

    def test_adversarial_sequence(self):
        _interleaving(7, ["write", "write", "flush", "split", "write", "rebalance", "merge", "flush"])


class TestInterleavingHypothesis:
    @settings(max_examples=10, deadline=None, derandomize=True, database=None)
    @given(seed=st.integers(min_value=0, max_value=3), ops=st.lists(st.sampled_from(OPS), min_size=1, max_size=6))
    def test_any_interleaving_matches_oracle(self, seed, ops):
        _interleaving(seed, ops)
