"""The availability layer of the port (``repro_torch.core.HREngine`` on
``device="cpu"``: hinted handoff, QUORUM/ALL digest reads with read repair,
failure detection and failover, hedged reads, recovery, scrub) against the
reference engine (``repro.core.HREngine``) on the same numpy inputs.

Mirrors ``tests/test_availability.py`` (``TestHintedHandoff``,
``TestFailRecoverEdges``, ``TestConsistency``, ``TestScrub``,
``TestFailureDetector``, ``TestHedgeConsistency``,
``TestReadRetryLimitValidation``) and the hedge and fail/recover cases of
``tests/test_partitioning.py``. Every case runs the same operations on both
engines, each with the same explicit ``KeySchema``, and compares answers,
routing (``replica_id``, ``node_id``, ``hedged``), dataset fingerprints and
counters: exactly, except float32 sums (rtol 1e-5, atol 1e-3). Engines
whose routing reads scan walls (hedges, the failure detector) get the same
deterministic ``scan_timer``, a tick counter, so nothing depends on a wall
clock. The device-resident cases are in
``tests/test_torch_availability_views.py``.
"""

import copy

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.tpch import generate_simulation
from repro.ft.detector import FailureDetector as RefDetector
from repro_torch.core.engine import _result_digest
from repro_torch.ft.detector import FailureDetector

LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
RTOL, ATOL = 1e-5, 1e-3
COUNTERS = (
    "hints_open", "hints_queued", "hint_replays", "hint_rows_replayed", "hint_fallbacks",
    "digest_mismatches", "read_repairs", "read_retries", "scrub_checks", "scrub_repairs",
    "read_faults", "flush_faults", "commitlog_auto_checkpoints", "memtable_flushes",
    "compactions", "result_cache_hits", "result_cache_misses",
)


class Tick:
    """A deterministic scan clock: each call advances it by ``step``."""

    def __init__(self, step: float = 1.0):
        self.n = 0
        self.step = step

    def __call__(self) -> float:
        self.n += 1
        return self.n * self.step


def _pair(kc, vc, schema, *, partitions=1, rf=3, n_nodes=6, layouts=None, ticks=False, **kw):
    """The reference and the port, each with the same column family "cf"."""
    layouts = LAYOUTS[:rf] if layouts is None else layouts
    out = []
    for pkg, extra in ((R, {}), (T, {"device": "cpu"})):
        if ticks:
            extra["scan_timer"] = Tick()
        eng = pkg.HREngine(n_nodes=n_nodes, **extra, **kw)
        eng.create_column_family(
            "cf", kc, vc, replication_factor=rf, layouts=layouts,
            schema=pkg.KeySchema(dict(schema.bits)), partitions=partitions,
        )
        out.append(eng)
    return tuple(out)


def _batches(seed, schema, n_batches, rows=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        kc = {c: rng.integers(0, schema.max_value(c) + 1, rows).astype(np.int64) for c in ("k0", "k1", "k2")}
        out.append((kc, {"metric": rng.uniform(0, 1, rows)}))
    return out


def _write(engines, batches):
    for kc, vc in batches:
        for eng in engines:
            eng.write("cf", kc, vc)


def _fingerprints(eng):
    """Per partition, the set of its held replica tables' fingerprints (a
    lost replica holds none)."""
    cf = eng.column_families["cf"]
    return [
        {
            t.dataset_fingerprint()
            for r in part.replicas
            if (t := eng.nodes[r.node_id].tables.get(("cf", r.replica_id))) is not None
        }
        for part in cf.partitions
    ]


def _corrupt(eng, replica=0, elem=0):
    """Flip an exponent bit of one stored host float: silent corruption."""
    cf = eng.column_families["cf"]
    r = cf.replicas[replica]
    arr = eng._table(cf, r).value_cols["metric"]
    arr.view(np.int64)[elem % arr.size] ^= np.int64(1) << np.int64(62)
    return r


def _same_state(ref, port):
    """Equal counters, equal fingerprints per partition, equal hints."""
    rs, ps = ref.stats, port.stats
    assert {k: rs[k] for k in COUNTERS} == {k: ps[k] for k in COUNTERS}
    assert _fingerprints(ref) == _fingerprints(port)
    for pr, pp in zip(ref.column_families["cf"].partitions, port.column_families["cf"].partitions):
        assert (pr.hints, pr.flushed_lsn) == (pp.hints, pp.flushed_lsn)
    assert [n.alive for n in ref.nodes] == [n.alive for n in port.nodes]
    assert ref.total_bytes() == port.total_bytes()


def _same_answers(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for (ra, pa), (rb, pb) in zip(ref_out, port_out):
        assert (pa.replica_id, pa.node_id, pa.hedged) == (pb.replica_id, pb.node_id, pb.hedged)
        assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
        np.testing.assert_allclose(ra.value, rb.value, rtol=RTOL, atol=ATOL)
        if ra.selected is None:
            assert rb.selected is None
        else:
            np.testing.assert_array_equal(ra.selected, rb.selected)


def _queries(pkg, seed, schema, n=12):
    """Sums, counts and selects: leading-key equalities, leading-key
    ranges and residual-only filters, in ``pkg``'s query types."""
    rng = np.random.default_rng(seed)
    doms = {c: schema.max_value(c) + 1 for c in ("k0", "k1", "k2")}
    aggs = ("sum", "count", "select")
    qs = []
    for i in range(n):
        agg = aggs[i % 3]
        u = rng.random()
        if u < 0.35:
            f = {"k0": pkg.Eq(int(rng.integers(0, doms["k0"])))}
        elif u < 0.7:
            lo = int(rng.integers(0, doms["k0"] - 1))
            f = {"k0": pkg.Range(lo, min(lo + 3, doms["k0"]))}
        else:
            lo = int(rng.integers(0, doms["k1"] - 1))
            f = {"k1": pkg.Range(lo, min(lo + 2, doms["k1"]))}
        qs.append(pkg.Query(filters=f, agg=agg, value_col="metric" if agg == "sum" else None))
    return qs


class TestHintedHandoff:
    @pytest.mark.parametrize("partitions", [1, 2])
    def test_transient_outage_heals_by_tail_replay(self, partitions):
        kc, vc, schema = generate_simulation(4_000, 3, seed=0)
        ref, port = _pair(kc, vc, schema, partitions=partitions)
        victim = port.column_families["cf"].partitions[-1].replicas[0].node_id
        for eng in (ref, port):
            eng.fail_node(victim, transient=True)
        assert port.stats["hints_open"] == ref.stats["hints_open"] > 0
        _write((ref, port), _batches(1, schema, 3))
        assert port.stats["hints_queued"] == ref.stats["hints_queued"] > 0
        for eng in (ref, port):
            eng.node_up(victim)
        _same_state(ref, port)
        st = port.stats
        assert st["hint_replays"] >= 1 and st["hint_fallbacks"] == 0 and st["hints_open"] == 0
        assert st["hint_rows_replayed"] == ref.stats["hint_rows_replayed"] > 0
        assert all(len(fps) == 1 for fps in _fingerprints(port))

    def test_zero_missed_writes_costs_nothing(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=0)
        ref, port = _pair(kc, vc, schema)
        cf = port.column_families["cf"]
        victim = cf.replicas[0].node_id
        before = {r.replica_id: port._table(cf, r) for r in cf.replicas if r.node_id == victim}
        for eng in (ref, port):
            eng.fail_node(victim, transient=True)
            eng.node_up(victim)
        _same_state(ref, port)
        assert port.stats["hint_replays"] == 0 and port.stats["hint_fallbacks"] == 0
        for rid, table in before.items():
            r = next(x for x in cf.replicas if x.replica_id == rid)
            assert port._table(cf, r) is table  # untouched, not rebuilt

    def test_checkpoint_collapse_forces_full_rebuild(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=0)
        ref, port = _pair(kc, vc, schema)
        victim = port.column_families["cf"].replicas[0].node_id
        for eng in (ref, port):
            eng.fail_node(victim, transient=True)
        _write((ref, port), _batches(2, schema, 2))
        for eng in (ref, port):
            eng.checkpoint_commitlog("cf")
            eng.node_up(victim)
        _same_state(ref, port)
        assert port.stats["hint_fallbacks"] >= 1
        assert all(len(fps) == 1 for fps in _fingerprints(port))

    def test_auto_checkpoint_deferred_while_hint_open(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=0)
        ref, port = _pair(kc, vc, schema, commitlog_checkpoint_records=3)
        victim = port.column_families["cf"].replicas[0].node_id
        for eng in (ref, port):
            eng.fail_node(victim, transient=True)
        _write((ref, port), _batches(3, schema, 6, rows=50))
        assert port.stats["commitlog_auto_checkpoints"] == 0  # deferred
        for eng in (ref, port):
            eng.node_up(victim)
        assert port.stats["hint_replays"] == 1
        _write((ref, port), _batches(4, schema, 1, rows=50))
        assert port.stats["commitlog_auto_checkpoints"] >= 1  # resumes
        _same_state(ref, port)

    @pytest.mark.parametrize("partitions", [1, 2])
    def test_hint_replay_matches_full_rebuild(self, partitions):
        kc, vc, schema = generate_simulation(3_000, 3, seed=0)
        hinted = _pair(kc, vc, schema, partitions=partitions)
        full = _pair(kc, vc, schema, partitions=partitions)
        victim = hinted[1].column_families["cf"].partitions[0].replicas[0].node_id
        for eng in hinted:
            eng.fail_node(victim, transient=True)
        for eng in full:
            eng.fail_node(victim)  # durable loss
        _write(hinted + full, _batches(5, schema, 2))
        for eng in hinted:
            eng.node_up(victim)
        for eng in full:
            eng.recover_node(victim)
        _same_state(*hinted)
        _same_state(*full)
        assert _fingerprints(hinted[1]) == _fingerprints(full[1])
        assert hinted[1].stats["hint_replays"] >= 1


class TestFailRecoverEdges:
    def test_unknown_node_raises(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        _, port = _pair(kc, vc, schema, n_nodes=3)
        for call in (lambda: port.fail_node(17), lambda: port.node_up(-1), lambda: port.recover_node(17)):
            with pytest.raises(ValueError):
                call()
        with pytest.raises(ValueError):
            port.recover_node(0, source="tape")

    def test_fail_dead_node_is_noop(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        ref, port = _pair(kc, vc, schema)
        victim = port.column_families["cf"].replicas[0].node_id
        for eng in (ref, port):
            eng.fail_node(victim, transient=True)
        hints = dict(port.column_families["cf"].partitions[0].hints)
        _write((ref, port), _batches(1, schema, 1))
        for eng in (ref, port):
            eng.fail_node(victim, transient=True)
            eng.fail_node(victim)  # a durable re-fail of a dead node: no-op too
        assert dict(port.column_families["cf"].partitions[0].hints) == hints
        for eng in (ref, port):
            eng.node_up(victim)
        _same_state(ref, port)
        assert all(len(fps) == 1 for fps in _fingerprints(port))

    def test_recover_live_node_is_noop(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        _, port = _pair(kc, vc, schema)
        cf = port.column_families["cf"]
        table = port._table(cf, cf.replicas[0])
        assert port.recover_node(cf.replicas[0].node_id) == 0.0
        assert port.node_up(cf.replicas[0].node_id) == 0.0
        assert port._table(cf, cf.replicas[0]) is table

    @pytest.mark.parametrize("partitions", [1, 2])
    def test_reads_route_around_a_down_node(self, partitions):
        """While a node is down the planner ranks only live replicas, the
        writes reach only live replicas, and recovery restores routing."""
        kc, vc, schema = generate_simulation(3_000, 3, seed=3)
        ref, port = _pair(kc, vc, schema, partitions=partitions)
        victim = port.column_families["cf"].replicas[1].node_id
        for eng in (ref, port):
            eng.fail_node(victim)
        _write((ref, port), _batches(6, schema, 2))
        ref_out = ref.read_many("cf", _queries(R, 7, schema))
        port_out = port.read_many("cf", _queries(T, 7, schema))
        _same_answers(ref_out, port_out)
        assert all(rep.node_id != victim for _, rep in port_out)
        assert [ref.read("cf", q)[1].replica_id for q in _queries(R, 8, schema)] == [
            port.read("cf", q)[1].replica_id for q in _queries(T, 8, schema)
        ]
        for eng in (ref, port):
            eng.recover_node(victim, source="survivor")
        _same_state(ref, port)
        _same_answers(ref.read_many("cf", _queries(R, 9, schema)), port.read_many("cf", _queries(T, 9, schema)))


class TestPartitionedFailRecover:
    def _pair_with_writes(self, partitions=4, rf=2, seed=4):
        kc, vc, schema = generate_simulation(5_000, 3, seed=seed)
        pair = _pair(kc, vc, schema, partitions=partitions, rf=rf, n_nodes=5)
        _write(pair, _batches(seed, schema, 3, rows=100))
        return pair

    def test_node_loses_only_its_partition_replicas(self):
        ref, port = self._pair_with_writes()
        cf = port.column_families["cf"]
        victim = cf.partitions[1].replicas[0].node_id
        surviving = {r.replica_id: port._table(cf, r) for r in cf.replicas if r.node_id != victim}
        for eng in (ref, port):
            eng.fail_node(victim)
        assert port.nodes[victim].tables == {}
        for r in cf.replicas:
            if r.node_id != victim:
                assert port._table(cf, r) is surviving[r.replica_id]
        for part in cf.partitions:
            assert [r for r in part.replicas if port.nodes[r.node_id].alive]
        _same_state(ref, port)

    @pytest.mark.parametrize("source", ["log", "survivor"])
    def test_recovery_equals_the_reference_and_the_other_source(self, source):
        ref, port = self._pair_with_writes()
        cf = port.column_families["cf"]
        victim = cf.partitions[2].replicas[1].node_id
        other = copy.deepcopy(port)
        for eng in (ref, port):
            eng.fail_node(victim)
            eng.recover_node(victim, source=source)
        other.fail_node(victim)
        other.recover_node(victim, source="survivor" if source == "log" else "log")
        _same_state(ref, port)
        checked = 0
        rcf, ocf = ref.column_families["cf"], other.column_families["cf"]
        for r in cf.replicas:
            if r.node_id != victim:
                continue
            t, tr, to = port._table(cf, r), ref._table(rcf, r), other._table(ocf, r)
            for a in (tr, to):
                np.testing.assert_array_equal(t.packed, a.packed)
                for c in t.key_cols:
                    np.testing.assert_array_equal(t.key_cols[c], a.key_cols[c])
            assert t.dataset_fingerprint() == to.dataset_fingerprint() == tr.dataset_fingerprint()
            assert t.verify_checksum()
            checked += 1
        assert checked > 0

    def test_recovery_repairs_missed_partition_writes(self):
        ref, port = self._pair_with_writes()
        victim = port.column_families["cf"].partitions[0].replicas[0].node_id
        for eng in (ref, port):
            eng.fail_node(victim)
        _write((ref, port), _batches(99, port.column_families["cf"].schema, 1, rows=120))
        for eng in (ref, port):
            eng.recover_node(victim, source="log")
        _same_state(ref, port)
        assert all(len(fps) == 1 for fps in _fingerprints(port))

    def test_full_scan_correct_through_fail_recover(self):
        ref, port = self._pair_with_writes()
        victim = port.column_families["cf"].partitions[1].replicas[0].node_id
        counts = []
        for step in ("before", "during", "after"):
            if step == "during":
                for eng in (ref, port):
                    eng.fail_node(victim)
            if step == "after":
                for eng in (ref, port):
                    eng.recover_node(victim, source="log")
            a = ref.read_many("cf", [R.Query(filters={}, agg="count")])
            b = port.read_many("cf", [T.Query(filters={}, agg="count")])
            _same_answers(a, b)
            counts.append(b[0][0].value)
        assert counts[0] == counts[1] == counts[2]


class TestConsistency:
    @pytest.mark.parametrize("partitions", [1, 2])
    def test_quorum_and_all_equal_one_when_clean(self, partitions):
        kc, vc, schema = generate_simulation(4_000, 3, seed=1)
        ref, port = _pair(kc, vc, schema, partitions=partitions)
        outs = {}
        for level in ("ONE", "QUORUM", "ALL"):
            a = ref.read_many("cf", _queries(R, 11, schema, n=15), consistency=level)
            b = port.read_many("cf", _queries(T, 11, schema, n=15), consistency=level)
            _same_answers(a, b)
            outs[level] = b
        for (r1, _), (rq, _), (ra, _) in zip(outs["ONE"], outs["QUORUM"], outs["ALL"]):
            assert r1.value == rq.value == ra.value and r1.rows_matched == rq.rows_matched == ra.rows_matched
        assert port.stats["digest_mismatches"] == 0 and port.stats["read_repairs"] == 0
        _same_state(ref, port)

    def test_digest_equals_the_reference(self):
        """``_result_digest`` of every answer equals the reference's digest
        of the same answer, on each replica's own table."""
        from repro.core.engine import _result_digest as ref_digest

        kc, vc, schema = generate_simulation(3_000, 3, seed=2)
        ref, port = _pair(kc, vc, schema)
        rcf, pcf = ref.column_families["cf"], port.column_families["cf"]
        for r in pcf.replicas:
            ra = ref._table(rcf, r).execute_many(_queries(R, 12, schema))
            pa = port._table(pcf, r).execute_many(_queries(T, 12, schema))
            for a, b in zip(ra, pa):
                assert ref_digest(a, ref._table(rcf, r), rcf.key_names, rcf.schema) == _result_digest(
                    b, port._table(pcf, r), pcf.key_names, pcf.schema
                )

    def test_all_detects_every_injected_corruption(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=1)
        ref, port = _pair(kc, vc, schema, n_nodes=3, result_cache=False)
        oracle, _ = _pair(kc, vc, schema, n_nodes=3)
        want = oracle.read("cf", R.Query(filters={}, agg="sum", value_col="metric"))[0].value
        rng = np.random.default_rng(9)
        for t in range(12):
            elem = int(rng.integers(0, 2_000))
            rs = [_corrupt(eng, replica=t % 3, elem=elem) for eng in (ref, port)]
            a = ref.read("cf", R.Query(filters={}, agg="sum", value_col="metric"), consistency="ALL")
            b = port.read("cf", T.Query(filters={}, agg="sum", value_col="metric"), consistency="ALL")
            _same_answers([a], [b])
            assert port.stats["digest_mismatches"] == t + 1
            assert b[0].value == want
            assert port._table(port.column_families["cf"], rs[1]).verify_checksum()
        _same_state(ref, port)
        assert port.stats["read_repairs"] >= 12

    def test_rf2_split_repairs_from_log(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=1)
        ref, port = _pair(kc, vc, schema, rf=2, n_nodes=2, result_cache=False)
        for eng in (ref, port):
            _corrupt(eng, replica=0)
        a = ref.read("cf", R.Query(filters={}, agg="sum", value_col="metric"), consistency="QUORUM")
        b = port.read("cf", T.Query(filters={}, agg="sum", value_col="metric"), consistency="QUORUM")
        _same_answers([a], [b])
        assert port.stats["digest_mismatches"] == 1 and port.stats["read_repairs"] == 2
        _same_state(ref, port)
        assert all(len(fps) == 1 for fps in _fingerprints(port))

    def test_select_digest_catches_a_corrupt_key(self):
        """A flipped key column changes the canonical keys a select digests;
        ALL repairs the minority and answers from the majority."""
        kc, vc, schema = generate_simulation(2_000, 3, seed=5)
        ref, port = _pair(kc, vc, schema, result_cache=False)
        for eng, pkg in ((ref, R), (port, T)):
            cf = eng.column_families["cf"]
            t = eng._table(cf, cf.replicas[1])
            sel = t.execute(pkg.Query(filters={"k1": pkg.Range(0, 4)}, agg="select")).selected
            t.key_cols["k2"][sel[0]] ^= 1
        a = ref.read_many("cf", [R.Query(filters={"k1": R.Range(0, 4)}, agg="select")], consistency="ALL")
        b = port.read_many("cf", [T.Query(filters={"k1": T.Range(0, 4)}, agg="select")], consistency="ALL")
        _same_answers(a, b)
        assert port.stats["digest_mismatches"] == 1 and port.stats["read_repairs"] == 1
        _same_state(ref, port)

    @pytest.mark.parametrize("partitions", [2, 4])
    def test_partitioned_all_consistency(self, partitions):
        kc, vc, schema = generate_simulation(4_000, 3, seed=2)
        ref, port = _pair(kc, vc, schema, partitions=partitions, result_cache=False)
        oracle, _ = _pair(kc, vc, schema, partitions=partitions)
        want = oracle.read("cf", R.Query(filters={}, agg="sum", value_col="metric"))[0].value
        for eng in (ref, port):
            _corrupt(eng, replica=0)
        a = ref.read("cf", R.Query(filters={}, agg="sum", value_col="metric"), consistency="ALL")
        b = port.read("cf", T.Query(filters={}, agg="sum", value_col="metric"), consistency="ALL")
        _same_answers([a], [b])
        assert port.stats["digest_mismatches"] >= 1 and b[0].value == want
        _same_state(ref, port)
        cf = port.column_families["cf"]
        assert port._table(cf, cf.replicas[0]).verify_checksum()

    def test_invalid_level_and_insufficient_quorum(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        _, port = _pair(kc, vc, schema, n_nodes=3)
        with pytest.raises(ValueError):
            port.read("cf", T.Query(filters={}), consistency="TWO")
        port.fail_node(0)
        port.fail_node(1)
        with pytest.raises(RuntimeError):
            port.read("cf", T.Query(filters={}), consistency="QUORUM")
        port.recover_node(0)
        with pytest.raises(RuntimeError):  # ALL needs every replica live
            port.read("cf", T.Query(filters={}), consistency="ALL")
        port.read("cf", T.Query(filters={}), consistency="QUORUM")


class TestScrub:
    def test_scrub_finds_and_heals_bit_flips(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=3)
        ref, port = _pair(kc, vc, schema, partitions=2)
        reports = []
        for eng in (ref, port):
            r = _corrupt(eng, replica=1, elem=37)
            reports.append(eng.scrub_column_family("cf"))
        assert reports[0] == reports[1]
        assert reports[1]["corrupt"] == [r.replica_id] and reports[1]["repaired"] == 1
        _same_state(ref, port)
        clean = port.scrub_column_family("cf")
        assert clean["corrupt"] == [] and clean["repaired"] == 0

    def test_scrub_report_only(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=3)
        ref, port = _pair(kc, vc, schema)
        reports = []
        for eng in (ref, port):
            r = _corrupt(eng, replica=2)
            reports.append(eng.scrub_column_family("cf", repair=False))
        assert reports[0] == reports[1] == {"replicas_checked": 3, "corrupt": [r.replica_id], "repaired": 0}
        assert not port._table(port.column_families["cf"], r).verify_checksum()

    def test_flush_does_not_launder_corruption(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=3)
        ref, port = _pair(kc, vc, schema)
        oracle, _ = _pair(kc, vc, schema)
        for eng in (ref, port):
            _corrupt(eng, replica=0, elem=11)
        _write((ref, port, oracle), _batches(6, schema, 2, rows=100))
        assert port.scrub_column_family("cf") == ref.scrub_column_family("cf")
        assert port.stats["scrub_repairs"] == 1
        _same_state(ref, port)
        assert _fingerprints(port) == _fingerprints(oracle)

    def test_scrub_skips_down_nodes(self):
        kc, vc, schema = generate_simulation(1_500, 3, seed=3)
        ref, port = _pair(kc, vc, schema, partitions=2)
        victim = port.column_families["cf"].replicas[0].node_id
        for eng in (ref, port):
            eng.fail_node(victim, transient=True)
        assert port.scrub_column_family("cf") == ref.scrub_column_family("cf")
        _same_state(ref, port)


class TestFailureDetector:
    def test_latency_outlier_becomes_suspected(self):
        dets = [FailureDetector(window=16, phi_suspect=4.0), RefDetector(window=16, phi_suspect=4.0)]
        for det in dets:
            for _ in range(16):
                for nid in (1, 2, 3):
                    det.record(nid, 1e-4)
                det.record(0, 5e-3)  # 50x its peers
        det, ref = dets
        assert [det.phi(n) for n in range(4)] == [ref.phi(n) for n in range(4)]
        assert det.phi(0) >= det.phi_suspect and det.state(0) in ("suspected", "dead")
        assert det.cost_factor(0) > 1.0 and det.cost_factor(1) == 1.0
        assert det.suspected_nodes() == ref.suspected_nodes() == [0]

    def test_failure_streak_accrues_and_clears(self):
        dets = [FailureDetector(failure_phi=4.0, phi_dead=12.0), RefDetector(failure_phi=4.0, phi_dead=12.0)]
        for det in dets:
            for _ in range(3):
                det.record_failure(5)
        assert dets[0].state(5) == dets[1].state(5) == "dead"
        for det in dets:
            det.record(5, 1e-4)  # one answer clears the streak
        assert dets[0].phi(5) == dets[1].phi(5) < dets[0].phi_suspect

    @pytest.mark.parametrize(
        "kwargs", [{"window": 1}, {"phi_suspect": 8.0, "phi_dead": 4.0}, {"suspect_penalty": 0.5}]
    )
    def test_validation(self, kwargs):
        with pytest.raises(ValueError):
            FailureDetector(**kwargs)
        with pytest.raises(ValueError):
            RefDetector(**kwargs)

    @pytest.mark.parametrize("partitions", [1, 2])
    def test_suspected_node_routed_around(self, partitions):
        kc, vc, schema = generate_simulation(2_000, 3, seed=4)
        engines = []
        for pkg, det_cls, extra in ((R, RefDetector, {}), (T, FailureDetector, {"device": "cpu"})):
            det = det_cls(min_samples=2, window=8)
            # each scan takes one 1e-4 tick: the healthy nodes' latency
            eng = pkg.HREngine(
                n_nodes=3, failure_detector=det, result_cache=False, scan_timer=Tick(1e-4), **extra
            )
            # identical layouts: every replica ties on cost, so routing
            # rotates round-robin until suspicion breaks the tie
            eng.create_column_family(
                "cf", kc, vc, replication_factor=3, layouts=[LAYOUTS[0]] * 3,
                schema=pkg.KeySchema(dict(schema.bits)), partitions=partitions,
            )
            engines.append((pkg, eng, det))
        picks = []
        for pkg, eng, det in engines:
            probe = pkg.Query(filters={}, agg="count")
            first = [eng.read("cf", probe)[1].node_id for _ in range(6)]
            for _ in range(8):
                det.record(0, 5e-2)
                det.record(1, 1e-4)
                det.record(2, 1e-4)
            assert det.state(0) != "alive"
            picks.append((first, [eng.read("cf", probe)[1].node_id for _ in range(6)]))
        assert picks[0] == picks[1]
        assert len(set(picks[1][0])) == 3  # healthy cluster: ties rotate
        assert set(picks[1][1]) == {1, 2}  # soft-avoided, not excluded
        _, port, det = engines[1]
        assert [det.phi(n) for n in range(3)] == [engines[0][2].phi(n) for n in range(3)]

    @pytest.mark.parametrize("partitions", [1, 2])
    def test_transient_read_fault_fails_over(self, partitions):
        kc, vc, schema = generate_simulation(2_000, 3, seed=4)
        ref, port = _pair(kc, vc, schema, n_nodes=3, partitions=partitions, result_cache=False)
        oracle, _ = _pair(kc, vc, schema, n_nodes=3, partitions=partitions)
        want, wrep = oracle.read("cf", R.Query(filters={}, agg="sum", value_col="metric"))
        for eng in (ref, port):
            eng.nodes[wrep.node_id].read_fault_budget = 1
        a = ref.read("cf", R.Query(filters={}, agg="sum", value_col="metric"))
        b = port.read("cf", T.Query(filters={}, agg="sum", value_col="metric"))
        _same_answers([a], [b])
        assert b[0].value == want.value and b[1].node_id != wrep.node_id
        assert port.stats["read_retries"] == 1 and port.stats["read_faults"] == 1
        _same_state(ref, port)

    def test_batched_failover_and_retry_limit(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=4)
        ref, port = _pair(kc, vc, schema, result_cache=False, read_retry_limit=2)
        for eng in (ref, port):
            cf = eng.column_families["cf"]
            eng.nodes[cf.replicas[0].node_id].read_fault_budget = 2
        _same_answers(
            ref.read_many("cf", _queries(R, 13, schema, n=18)),
            port.read_many("cf", _queries(T, 13, schema, n=18)),
        )
        _same_state(ref, port)
        assert port.stats["read_retries"] > 0

    def test_flush_fault_keeps_rows_staged(self):
        kc, vc, schema = generate_simulation(1_500, 3, seed=4)
        ref, port = _pair(kc, vc, schema)
        node = port.column_families["cf"].replicas[0].node_id
        (bk, bv), = _batches(14, schema, 1)
        for eng in (ref, port):
            eng.nodes[node].flush_fault_budget = 1
            with pytest.raises(Exception) as e:
                eng.write("cf", bk, bv)
            assert type(e.value).__name__ == "TransientFlushError"
            eng.flush_memtables("cf")
        assert port.stats["flush_faults"] == 1
        _same_state(ref, port)

    def test_retry_exhaustion_raises(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=4)
        _, port = _pair(kc, vc, schema, n_nodes=3, result_cache=False)
        for n in port.nodes:
            n.read_fault_budget = 5
        with pytest.raises(RuntimeError):
            port.read("cf", T.Query(filters={}, agg="count"))
        with pytest.raises(RuntimeError):
            port.read_many("cf", [T.Query(filters={}, agg="count")])


class TestHedgeConsistency:
    """The hedge duplicates only the primary read (the hedge pass runs
    before the digest pass), and a losing hedge leaves the primary's report
    untouched; both engines on the same tick clock."""

    @staticmethod
    def _spied(eng, calls):
        orig = eng._scan_with_cache

        def spy(cf, r, group, trace=None):
            calls.append((r.replica_id, len(group)))
            return orig(cf, r, group, trace=trace)

        eng._scan_with_cache = spy

    @pytest.mark.parametrize("level,n_scans", [("QUORUM", 1 + 3), ("ALL", 1 + 4)])
    def test_hedge_duplicates_primary_only(self, level, n_scans):
        kc, vc, schema = generate_simulation(2_000, 3, seed=6)
        ref, port = _pair(kc, vc, schema, result_cache=False, ticks=True)
        calls = ([], [])
        outs = []
        for eng, pkg, log in ((ref, R, calls[0]), (port, T, calls[1])):
            q = pkg.Query({"k0": pkg.Eq(int(kc["k0"][0]))})
            _, rep0 = eng.read("cf", q)
            eng.nodes[rep0.node_id].slowdown = 3.0
            self._spied(eng, log)
            plain, _ = eng.read("cf", q)
            outs.append((plain, eng.read("cf", q, hedge=True, consistency=level)))
        assert calls[0] == calls[1] and len(calls[1]) == n_scans
        _same_answers([outs[0][1]], [outs[1][1]])
        assert outs[1][1][0].value == outs[1][0].value

    def test_losing_hedge_keeps_primary_report(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=6)
        ref, port = _pair(kc, vc, schema, result_cache=False, ticks=True)
        outs = []
        for eng, pkg in ((ref, R), (port, T)):
            q = pkg.Query({"k0": pkg.Eq(int(kc["k0"][2]))})
            _, rep0 = eng.read("cf", q)
            for n in eng.nodes:
                n.slowdown = 1e6  # every alternate is hopeless
            eng.nodes[rep0.node_id].slowdown = 3.0
            outs.append((rep0, eng.read("cf", q, hedge=True)))
        _same_answers([outs[0][1]], [outs[1][1]])
        rep0, (_, rep) = outs[1]
        assert rep.node_id == rep0.node_id and rep.hedged is False and rep.wall_seconds < 1e3

    def test_winning_hedge_reports_alternate(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=6)
        ref, port = _pair(kc, vc, schema, result_cache=False, ticks=True)
        outs = []
        for eng, pkg in ((ref, R), (port, T)):
            q = pkg.Query({"k0": pkg.Eq(int(kc["k0"][3]))})
            _, rep0 = eng.read("cf", q)
            eng.nodes[rep0.node_id].slowdown = 1e6
            outs.append((rep0, eng.read("cf", q, hedge=True)))
        _same_answers([outs[0][1]], [outs[1][1]])
        rep0, (_, rep) = outs[1]
        assert rep.hedged is True and rep.node_id != rep0.node_id

    @pytest.mark.parametrize("partitions", [1, 2])
    def test_hedged_batch_lands_off_the_straggler(self, partitions):
        kc, vc, schema = generate_simulation(3_000, 3, seed=2)
        ref, port = _pair(kc, vc, schema, partitions=partitions, result_cache=False, ticks=True)
        victim = port.column_families["cf"].partitions[0].replicas[0].node_id
        for eng in (ref, port):
            eng.nodes[victim].slowdown = 1e4
        a = ref.read_many("cf", _queries(R, 4, schema, n=24), hedge=True, hedge_ratio=1.5)
        b = port.read_many("cf", _queries(T, 4, schema, n=24), hedge=True, hedge_ratio=1.5)
        _same_answers(a, b)
        assert any(rep.hedged for _, rep in b), "no hedge fired against a 1e4x straggler"
        plain = port.read_many("cf", _queries(T, 4, schema, n=24))
        for (x, _), (y, _) in zip(b, plain):
            assert x.rows_matched == y.rows_matched

    def test_hedge_with_cache_and_quorum_batched(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=8)
        ref, port = _pair(kc, vc, schema, partitions=2, ticks=True)
        victim = port.column_families["cf"].partitions[1].replicas[1].node_id
        for eng in (ref, port):
            eng.nodes[victim].slowdown = 50.0
        for level in ("ONE", "QUORUM", "ALL"):
            _same_answers(
                ref.read_many("cf", _queries(R, 5, schema, n=18), hedge=True, consistency=level),
                port.read_many("cf", _queries(T, 5, schema, n=18), hedge=True, consistency=level),
            )
        _same_state(ref, port)


class TestReadRetryLimitValidation:
    @pytest.mark.parametrize("bad", [0, -1, -7])
    def test_zero_and_negative_rejected_at_construction(self, bad):
        with pytest.raises(ValueError, match="read_retry_limit"):
            T.HREngine(n_nodes=3, device="cpu", read_retry_limit=bad)

    def test_one_and_none_still_accepted(self):
        assert T.HREngine(n_nodes=3, device="cpu", read_retry_limit=1).read_retry_limit == 1
        assert T.HREngine(n_nodes=3, device="cpu", read_retry_limit=None).read_retry_limit is None


class TestTotalBytes:
    @pytest.mark.parametrize("partitions", [1, 2])
    def test_total_bytes_through_writes_loss_and_recovery(self, partitions):
        kc, vc, schema = generate_simulation(2_500, 3, seed=10)
        ref, port = _pair(kc, vc, schema, partitions=partitions)
        sizes = [port.total_bytes()]
        assert sizes[0] == ref.total_bytes() > 0
        _write((ref, port), _batches(15, schema, 2))
        victim = port.column_families["cf"].replicas[0].node_id
        for step in ("fail", "recover"):
            for eng in (ref, port):
                getattr(eng, f"{step}_node")(victim)
            sizes.append(port.total_bytes())
            assert port.total_bytes() == ref.total_bytes()
        assert sizes[1] < sizes[0] + 2 * 200 * 3 * 40 and sizes[2] > sizes[1]
        assert [n.bytes_stored() for n in port.nodes] == [n.bytes_stored() for n in ref.nodes]
