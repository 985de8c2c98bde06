"""The availability layer on device-resident column families of the port
(``repro_torch.core.HREngine`` on ``device="cpu"``, the kernels' plain
versions) against the reference (``repro.core.HREngine``, its kernels in
Pallas interpret mode), on the same numpy inputs and explicit
``KeySchema``.

Mirrors ``tests/test_views.py``'s ``TestScrubHealsViews`` and
``TestRecoveryViews``, and adds what residency changes: the checksum
covers the host columns while reads come from the resident tensors, so a
flipped host value is caught by scrub and not by a digest read, and a
flipped value in the resident value tile is caught by an ALL digest read
(then read repair) and not by scrub. A rebuilt replica's resident state is
array-equal to a fresh build of its rows and to the reference's rebuilt
state. Counts, row counts, fingerprints and counters are compared exactly,
float32 sums within rtol 1e-5 / atol 1e-3; view-served sums equal the
port's own fused scan bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.storage.views import verify_views as ref_verify_views
from repro.core.tpch import generate_simulation
from repro_torch.core.storage.views import verify_views
from repro_torch.kernels import ops

LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
RTOL, ATOL = 1e-5, 1e-3
DOM = 32  # each key column's domain in the generated rows
COUNTERS = (
    "hints_open", "hint_replays", "hint_rows_replayed", "hint_fallbacks", "digest_mismatches",
    "read_repairs", "scrub_checks", "scrub_repairs", "view_rebuilds", "memtable_flushes",
    "compactions",
)


def _build(pkg, kc, vc, schema, *, views, partitions):
    extra = {} if pkg is R else {"device": "cpu"}
    eng = pkg.HREngine(n_nodes=5, result_cache=False, **extra)
    eng.create_column_family(
        "cf", kc, vc, replication_factor=3, layouts=LAYOUTS, schema=pkg.KeySchema(dict(schema.bits)),
        device_resident=True, views=views, memtable_rows=0, partitions=partitions,
    )
    return eng


@pytest.fixture(scope="module", params=[1, 2], ids=["P1", "P2"])
def pairs(request):
    """(reference, port) views families, the port's fused twin, and the
    reference's fused twin, each over the same 12,000 rows."""
    kc, vc, schema = generate_simulation(12_000, 3, seed=4)
    assert all(schema.max_value(c) + 1 == DOM for c in ("k0", "k1", "k2"))
    p = request.param
    return (
        _build(R, kc, vc, schema, views=True, partitions=p),
        _build(T, kc, vc, schema, views=True, partitions=p),
        _build(T, kc, vc, schema, views=False, partitions=p),
        _build(R, kc, vc, schema, views=False, partitions=p),
    )


def _copies(pairs):
    """Fresh copies of the fixture's engines, counters at 0."""
    out = [copy.deepcopy(e) for e in pairs]
    for e in out:
        e.reset_stats()
    return out


def _tables(eng):
    cf = eng.column_families["cf"]
    return [eng.nodes[r.node_id].tables.get(("cf", r.replica_id)) for r in cf.replicas]


def _queries(pkg, seed, n=24, dom=DOM):
    """Sums, counts and selects: a leading-key equality, a leading-key
    range with a second range (view-eligible on the first layout), or an
    equality on the second key."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        agg = ("sum", "count", "select")[i % 3]
        u = rng.random()
        if u < 0.4:
            f = {"k0": pkg.Eq(int(rng.integers(0, dom)))}
        elif u < 0.7:
            lo = int(rng.integers(0, dom - 4))
            f = {"k0": pkg.Range(lo, lo + 4), "k1": pkg.Range(0, dom // 2)}
        else:
            f = {"k1": pkg.Eq(int(rng.integers(0, dom)))}
        qs.append(pkg.Query(filters=f, agg=agg, value_col="metric" if agg == "sum" else None))
    return qs


def _exact_queries(pkg, seed, rows_of):
    """Queries whose digests are exact on every replica and in both
    engines: the counts and selects of a batch, and sums over one full key
    each (a float32 sum of two values or fewer does not depend on the
    order). A sum over many rows is left out of the digest comparisons:
    float32 reduction order differs across layouts and between the two
    engines' kernels (ROADMAP.md Queue 3)."""
    qs = [q for q in _queries(pkg, seed) if q.agg != "sum"]
    for keys in rows_of:
        qs.append(pkg.Query({c: pkg.Eq(v) for c, v in keys.items()}, "sum", "metric"))
    return qs


def _point_keys(port, n=6):
    t = _tables(port)[0]
    idx = np.linspace(0, len(t) - 1, n).astype(int)
    return [{c: int(t.key_cols[c][i]) for c in ("k0", "k1", "k2")} for i in idx]


def _same(ref, port, *, seed=21, level="ONE", exact=False):
    """Same answers (sums within tolerance) and routing on one batch
    (``exact``: the exact-digest batch, for consistency levels above ONE)."""
    if exact:
        keys = _point_keys(port)
        a = ref.read_many("cf", _exact_queries(R, seed, keys), consistency=level)
        b = port.read_many("cf", _exact_queries(T, seed, keys), consistency=level)
    else:
        a = ref.read_many("cf", _queries(R, seed), consistency=level)
        b = port.read_many("cf", _queries(T, seed), consistency=level)
    for (ra, pa), (rb, pb) in zip(a, b):
        assert (pa.replica_id, pa.node_id) == (pb.replica_id, pb.node_id)
        assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
        np.testing.assert_allclose(ra.value, rb.value, rtol=RTOL, atol=ATOL)
        if ra.selected is not None:
            np.testing.assert_array_equal(ra.selected, rb.selected)
    return b


def _same_counters(ref, port):
    rs, ps = ref.stats, port.stats
    assert {k: rs[k] for k in COUNTERS} == {k: ps[k] for k in COUNTERS}
    fps = []
    for eng in (ref, port):
        cf = eng.column_families["cf"]
        fps.append([
            {t.dataset_fingerprint() for r in part.replicas
             if (t := eng.nodes[r.node_id].tables.get(("cf", r.replica_id))) is not None}
            for part in cf.partitions
        ])
    assert fps[0] == fps[1]
    assert ref.total_bytes() == port.total_bytes()


def _view_bits(port, fused):
    """Every view-served answer of a batch equals the port's fused scan on
    the same rows bit for bit (and the fused twin's answer)."""
    qs = [q for q in _queries(T, 31) if q.agg != "select"]
    cf = port.column_families["cf"]
    handles = {r.replica_id: r for r in cf.replicas}
    served = 0
    for q, (a, rep), (b, _) in zip(qs, port.read_many("cf", qs), fused.read_many("cf", qs)):
        assert a.rows_matched == b.rows_matched
        if cf.ring.n_partitions == 1 and port._table(cf, handles[rep.replica_id])._view_eligible(q):
            c = ops.table_execute_device_many(port._table(cf, handles[rep.replica_id]), [q])[0]
            assert (a.value, a.rows_matched, a.rows_scanned) == (c.value, c.rows_matched, c.rows_scanned)
            served += 1
    assert port.stats["view_hits"] > 0
    return served


def _flip_resident(eng, replica, row):
    """Flip the exponent's top bit of one resident float32 value (the
    ``metric`` row of the value tile) on one replica; the host columns and
    the sealed checksum are untouched."""
    cf = eng.column_families["cf"]
    st = eng._table(cf, cf.replicas[replica])._device
    i = st["value_rows"]["metric"]
    tile = np.array(st["values_tile"], dtype=np.float32)
    tile[i].view(np.int32)[row] ^= np.int32(1 << 30)
    if isinstance(st["values_tile"], torch.Tensor):
        st["values_tile"] = torch.from_numpy(tile)
    else:
        import jax.numpy as jnp

        st["values_tile"] = jnp.asarray(tile)


class TestScrubHealsViews:
    def test_corrupted_partial_detected_and_rebuilt(self, pairs):
        ref, port, fused, _ = _copies(pairs)
        reports = []
        for eng, verify in ((ref, ref_verify_views), (port, verify_views)):
            t0 = _tables(eng)[0]
            t0._device["views"]["block_sums"][0, 0] += 0.5
            assert not verify(t0)
            reports.append(eng.scrub_column_family("cf"))
            assert verify(t0)
        rid = port.column_families["cf"].replicas[0].replica_id
        assert reports[0] == reports[1] and reports[1]["corrupt"] == [rid] and reports[1]["repaired"] == 1
        assert port.stats["scrub_repairs"] == 1 and port.stats["view_rebuilds"] == 1
        _same_counters(ref, port)
        _same(ref, port)
        _view_bits(port, fused)

    def test_missing_views_also_healed(self, pairs):
        ref, port, fused, _ = _copies(pairs)
        reports = []
        for eng in (ref, port):
            del _tables(eng)[1]._device["views"]
            reports.append(eng.scrub_column_family("cf"))
        t1 = _tables(port)[1]
        assert reports[0] == reports[1] and reports[1]["repaired"] == 1
        assert t1.has_views and verify_views(t1)
        _same_counters(ref, port)
        _view_bits(port, fused)

    def test_heal_on_a_run_stack(self, pairs):
        """Scrub heals views between compactions: the rebuilt view indexes
        each resident run apart, so view-served answers still equal the
        fused scan bit for bit (the port's fix; the reference indexes a
        run stack's keys as one run)."""
        _, port, fused, _ = _copies(pairs)
        rng = np.random.default_rng(61)
        for _ in range(2):
            kw = {c: rng.integers(0, DOM, 700).astype(np.int64) for c in ("k0", "k1", "k2")}
            vw = {"metric": rng.standard_normal(700)}
            port.write("cf", kw, vw)
            fused.write("cf", kw, vw)
        tables = _tables(port)
        assert all(t._device["n_runs"] == 3 for t in tables)
        tables[0]._device["views"]["block_sums"][0, 0] += 1.0
        del tables[2]._device["views"]
        report = port.scrub_column_family("cf")
        assert report["repaired"] == 2 and all(verify_views(t) for t in tables)
        for t in tables:
            assert [len(p) for p in t._device["views"]["run_packed"]] == [
                b - a for a, b in zip(t._device["run_starts"], list(t._device["run_starts"][1:]) + [len(t)])
            ]
        assert _view_bits(port, fused) > 0 or port.column_families["cf"].ring.n_partitions > 1

    def test_report_only_mode_leaves_corruption(self, pairs):
        ref, port, _, _ = _copies(pairs)
        reports = []
        for eng in (ref, port):
            _tables(eng)[0]._device["views"]["block_sums"][0, 0] += 0.5
            reports.append(eng.scrub_column_family("cf", repair=False))
        assert reports[0] == reports[1] and reports[1]["repaired"] == 0
        assert not verify_views(_tables(port)[0])


class TestRecoveryViews:
    def test_recovered_replicas_regain_views(self, pairs):
        ref, port, fused, _ = _copies(pairs)
        victim = port.column_families["cf"].replicas[0].node_id
        for eng in (ref, port):
            eng.fail_node(victim)
            eng.recover_node(victim)
        for t in _tables(port):
            assert t.has_views and verify_views(t)
        assert port.stats["view_rebuilds"] > 0
        _same_counters(ref, port)
        _same(ref, port)
        _view_bits(port, fused)

    def test_recovered_state_equals_a_fresh_build_and_the_reference(self, pairs):
        ref, port, _, _ = _copies(pairs)
        cf = port.column_families["cf"]
        victim = cf.replicas[2].node_id
        for eng in (ref, port):
            eng.fail_node(victim)
            eng.recover_node(victim, source="survivor")
        for r, t, tr in zip(cf.replicas, _tables(port), _tables(ref)):
            if r.node_id != victim:
                continue
            st = t._device
            fresh = ops.build_device_state(t, device="cpu")
            assert st["n_runs"] == 1 and st["row_map"] is None
            assert torch.equal(st["keys"], fresh["keys"])
            assert torch.equal(st["values_tile"], fresh["values_tile"])
            np.testing.assert_array_equal(st["keys"].numpy(), np.asarray(tr._device["keys"]))
            np.testing.assert_array_equal(st["values_tile"].numpy(), np.asarray(tr._device["values_tile"]))
            # float32 block partials: each engine's own reduction order
            np.testing.assert_allclose(
                st["views"]["block_sums"], np.asarray(tr._device["views"]["block_sums"]), rtol=RTOL, atol=ATOL
            )
            assert verify_views(t)
        _same_counters(ref, port)

    def test_hinted_node_up_extends_views(self, pairs):
        ref, port, fused, _ = _copies(pairs)
        rng = np.random.default_rng(51)
        m = 1500
        kw = {c: rng.integers(0, DOM, m).astype(np.int64) for c in ("k0", "k1", "k2")}
        vw = {"metric": rng.standard_normal(m)}
        victim = port.column_families["cf"].replicas[0].node_id
        for eng in (ref, port, fused):
            eng.fail_node(victim, transient=True)
            eng.write("cf", kw, vw)
            eng.node_up(victim)
        for t in _tables(port):
            assert t.has_views and verify_views(t)
        assert port.stats["hint_rows_replayed"] > 0 and port.stats["hint_fallbacks"] == 0
        _same_counters(ref, port)
        _same(ref, port)
        _view_bits(port, fused)


class TestResidentCorruption:
    def test_resident_flip_caught_by_all_digest_read_not_by_scrub(self, pairs):
        """A flipped resident value on a family without views: the sealed
        checksum (host columns) still verifies, an ALL read of a point
        query on that row sees the digests disagree, repairs the replica
        from the log and answers from the majority. (On a views family
        scrub's view audit would see the tile disagree with its view.)"""
        oracle, _, port, ref = _copies(pairs)
        t = _tables(port)[0]
        row = 17
        key = {c: int(t.key_cols[c][row]) for c in ("k0", "k1", "k2")}
        want = oracle.read_many("cf", [R.Query({c: R.Eq(v) for c, v in key.items()}, "sum", "metric")])
        for eng in (ref, port):
            _flip_resident(eng, 0, row)
            assert eng.scrub_column_family("cf", repair=False)["corrupt"] == []
        outs = []
        for eng, pkg in ((ref, R), (port, T)):
            q = pkg.Query({c: pkg.Eq(v) for c, v in key.items()}, "sum", "metric")
            outs.append(eng.read_many("cf", [q], consistency="ALL"))
        (a, ra), = outs[0]
        (b, rb), = outs[1]
        assert (ra.replica_id, ra.node_id) == (rb.replica_id, rb.node_id)
        np.testing.assert_allclose(a.value, b.value, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b.value, want[0][0].value, rtol=RTOL, atol=ATOL)
        assert port.stats["digest_mismatches"] == 1 and port.stats["read_repairs"] == 1
        _same_counters(ref, port)
        st = _tables(port)[0]._device
        fresh = ops.build_device_state(_tables(port)[0], device="cpu")
        assert torch.equal(st["values_tile"], fresh["values_tile"])

    def test_host_flip_caught_by_scrub_not_by_digest_read(self, pairs):
        """A flipped host value: reads are served from the resident tensors,
        so ALL reads agree; scrub's checksum finds it and heals it."""
        ref, port, _, _ = _copies(pairs)
        for eng in (ref, port):
            cf = eng.column_families["cf"]
            arr = eng._table(cf, cf.replicas[1]).value_cols["metric"]
            arr.view(np.int64)[5] ^= np.int64(1) << np.int64(62)
        _same(ref, port, level="ALL", exact=True)
        assert port.stats["digest_mismatches"] == 0
        reports = [eng.scrub_column_family("cf") for eng in (ref, port)]
        assert reports[0] == reports[1] and reports[1]["repaired"] == 1
        _same_counters(ref, port)

    def test_quorum_and_all_on_resident_replicas(self, pairs):
        ref, port, _, _ = _copies(pairs)
        one = _same(ref, port, seed=41, exact=True)
        for level in ("QUORUM", "ALL"):
            got = _same(ref, port, seed=41, level=level, exact=True)
            for (x, _), (y, _) in zip(one, got):
                assert x.rows_matched == y.rows_matched
        _same_counters(ref, port)
