"""The port's metrics registry, exposition and bridges (``obs/metrics.py``,
``obs/exporter.py``, ``obs/bridge.py``) against the JAX package's, on the
CPU.

The ``TestRegistry`` and ``TestExposition`` scenarios and the bridge and
catalog tests of ``tests/test_observability.py`` run once per package.
Where both packages see the same operations, their ``render_text`` must be
equal byte for byte; every catalog (``*_METRICS``) must equal the JAX
package's key for key; the ``/metrics`` endpoint binds 127.0.0.1 on an
ephemeral port.  The metrics-catalog checker
(``tools/analyze/metrics.py``) reads the JAX package's files only, so its
two tests have no case here: the catalog equality below holds the port to
what it checks.
"""
import json
import math
import re
import threading
import types
import urllib.error
import urllib.request

import pytest

from repro.api.types import QoSClass as JQoS
from repro.core import versioning as jversioning
from repro.obs import bridge as jbridge
from repro.obs import exporter as jexporter
from repro.obs import metrics as jmetrics
from repro.serve import scheduler as jsched
from repro.stream import pipeline as jpipeline
import repro_torch.obs as tobs
from repro_torch.api.types import QoSClass as TQoS
from repro_torch.core import versioning as tversioning
from repro_torch.obs import bridge as tbridge
from repro_torch.obs import exporter as texporter
from repro_torch.obs import metrics as tmetrics
from repro_torch.serve import scheduler as tsched
from repro_torch.stream import pipeline as tpipeline

PKGS = {
    "jax": types.SimpleNamespace(
        metrics=jmetrics, exporter=jexporter, bridge=jbridge,
        sched=jsched, versioning=jversioning, pipeline=jpipeline,
        QoS=JQoS),
    "torch": types.SimpleNamespace(
        metrics=tmetrics, exporter=texporter, bridge=tbridge,
        sched=tsched, versioning=tversioning, pipeline=tpipeline,
        QoS=TQoS),
}
CATALOGS = sorted(n for n in vars(jbridge) if n.endswith("_METRICS"))


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _both(fn):
    """``fn(pkg)`` in each package -> (jax result, torch result)."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------
class TestRegistry:
    def test_counter_inc_and_set_total(self, pkg):
        reg = pkg.metrics.Registry()
        c = reg.counter("repro_x_total", "x")
        c.inc()
        c.inc(2.5)
        assert c.value() == 3.5
        c.set_total(10)
        assert c.value() == 10
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_labels_must_match_declaration(self, pkg):
        reg = pkg.metrics.Registry()
        c = reg.counter("repro_l_total", "x", labelnames=("qos",))
        c.inc(qos="RANKING")
        with pytest.raises(ValueError):
            c.inc()                        # missing label
        with pytest.raises(ValueError):
            c.inc(qos="A", extra="B")      # unknown label
        with pytest.raises(ValueError):
            reg.counter("repro_l_total", "x", labelnames=("other",))
        with pytest.raises(ValueError):
            reg.gauge("repro_l_total", "x", labelnames=("qos",))

    def test_histogram_buckets_sorted_and_deduped(self, pkg):
        reg = pkg.metrics.Registry()
        with pytest.raises(ValueError):
            reg.histogram("repro_h", "h", buckets=(1.0, 1.0))
        h = reg.histogram("repro_h", "h", buckets=(2.0, 0.5))
        h.observe(1.0)
        sample_les = [dict(lp)["le"] for suffix, lp, _ in h.samples()
                      if suffix == "_bucket"]
        assert sample_les == ["0.5", "2", "+Inf"]

    def test_collectors_run_outside_lock(self, pkg):
        # a collector that itself creates metrics must not deadlock
        reg = pkg.metrics.Registry()

        def collect():
            reg.gauge("repro_from_collector", "g").set(1.0)

        reg.register_collector(collect)
        names = [m.name for m in reg.collect()]
        assert "repro_from_collector" in names

    def test_concurrent_writers_exact_totals(self, pkg):
        reg = pkg.metrics.Registry()
        c = reg.counter("repro_stress_total", "s", labelnames=("w",))
        h = reg.histogram("repro_stress_lat", "s", buckets=(0.5,))
        n_threads, n_iter = 8, 2000
        barrier = threading.Barrier(n_threads)

        def worker(w: int):
            barrier.wait()
            for i in range(n_iter):
                c.inc(w=str(w % 2))
                h.observe(0.25 if i % 2 else 0.75)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total = n_threads * n_iter
        assert c.value(w="0") + c.value(w="1") == total
        flat = {f"{s}{dict(lp).get('le', '')}": v
                for s, lp, v in h.samples()}
        assert flat["_count"] == total
        assert flat["_bucket0.5"] == total // 2

    def test_default_registry_and_package_exports(self):
        assert tmetrics.get_registry() is tmetrics.REGISTRY
        assert tmetrics.REGISTRY is not jmetrics.REGISTRY
        assert tobs.Registry is tmetrics.Registry
        assert sorted(tobs.__all__) == sorted(
            __import__("repro.obs", fromlist=["__all__"]).__all__
            + ["sort_timeline"])
        assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


# ---------------------------------------------------------------------------
# exposition round-trip
# ---------------------------------------------------------------------------
def _populate(pkg):
    """The same operations on a fresh registry of ``pkg``: every metric
    kind, labels that need escaping, special values, a collector."""
    reg = pkg.metrics.Registry()
    reg.counter("repro_esc_total", "e\\scape\nhelp", labelnames=("k",)) \
        .inc(3, k='a\\b"c\nd')
    reg.counter("repro_plain_total", "p").inc(2.5)
    g = reg.gauge("repro_g", "g", labelnames=("qos", "shard"))
    g.set(1.25, qos="RANKING", shard="0")
    g.set(-7, qos="PREFETCH", shard="1")
    reg.gauge("repro_nan", "n").set(float("nan"))
    reg.gauge("repro_inf", "i").set(float("-inf"))
    h = reg.histogram("repro_lat_seconds", "lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    reg.histogram("repro_default_seconds", "").observe(0.003)
    reg.register_collector(
        lambda: reg.gauge("repro_collected", "c").set(42))
    return reg


class TestExposition:
    def test_render_text_equal_byte_for_byte(self):
        jtext, ttext = _both(lambda p: p.exporter.render_text(_populate(p)))
        assert ttext == jtext
        assert texporter.parse_text(ttext).keys() == \
            jexporter.parse_text(jtext).keys()
        assert texporter.CONTENT_TYPE == jexporter.CONTENT_TYPE

    def test_label_escaping_round_trips(self, pkg):
        reg = pkg.metrics.Registry()
        nasty = 'a\\b"c\nd'
        reg.counter("repro_esc_total", "e", labelnames=("k",)) \
            .inc(3, k=nasty)
        text = pkg.exporter.render_text(reg)
        parsed = pkg.exporter.parse_text(text)
        assert parsed[("repro_esc_total", (("k", nasty),))] == 3.0

    def test_histogram_buckets_cumulative_and_consistent(self, pkg):
        reg = pkg.metrics.Registry()
        h = reg.histogram("repro_lat_seconds", "lat",
                          buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
        parsed = pkg.exporter.parse_text(pkg.exporter.render_text(reg))

        def bucket(le):
            return parsed[("repro_lat_seconds_bucket", (("le", le),))]

        counts = [bucket("0.1"), bucket("1"), bucket("10"), bucket("+Inf")]
        assert counts == sorted(counts)          # monotone
        assert counts == [1, 3, 4, 5]            # cumulative
        assert counts[-1] == parsed[("repro_lat_seconds_count", ())]
        assert parsed[("repro_lat_seconds_sum", ())] == \
            pytest.approx(56.05)

    def test_special_values_render(self, pkg):
        reg = pkg.metrics.Registry()
        reg.gauge("repro_nan", "n").set(float("nan"))
        reg.gauge("repro_inf", "i").set(float("inf"))
        parsed = pkg.exporter.parse_text(pkg.exporter.render_text(reg))
        assert math.isnan(parsed[("repro_nan", ())])
        assert parsed[("repro_inf", ())] == float("inf")

    def test_http_endpoint_serves_and_404s(self, pkg):
        reg = pkg.metrics.Registry()
        reg.counter("repro_served_total", "s").inc(7)
        with pkg.exporter.MetricsServer(reg, host="127.0.0.1",
                                        port=0) as srv:
            assert srv.url.startswith("http://127.0.0.1:")
            with urllib.request.urlopen(srv.url, timeout=5) as r:
                body = r.read()
                ctype = r.headers["Content-Type"]
            assert b"repro_served_total 7" in body
            assert ctype == pkg.exporter.CONTENT_TYPE
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/nope", timeout=5)

    def test_http_bodies_equal_across_packages(self):
        bodies = []
        for p in (PKGS["jax"], PKGS["torch"]):
            with p.exporter.MetricsServer(_populate(p)) as srv:
                with urllib.request.urlopen(srv.url, timeout=5) as r:
                    bodies.append(r.read())
        assert bodies[0] == bodies[1]

    def test_snapshot_flattens_for_records(self, pkg):
        reg = pkg.metrics.Registry()
        reg.counter("repro_s_total", "s", labelnames=("q",)).inc(2, q="A")
        flat = pkg.exporter.snapshot(reg)
        assert flat['repro_s_total{q="A"}'] == 2.0
        json.dumps(flat)                         # JSON-able by contract

    def test_snapshot_equal_across_packages(self):
        jflat, tflat = _both(lambda p: p.exporter.snapshot(_populate(p)))
        assert list(tflat) == list(jflat)
        for k in jflat:
            assert tflat[k] == jflat[k] or (
                math.isnan(tflat[k]) and math.isnan(jflat[k])), k


# ---------------------------------------------------------------------------
# bridges and the catalogs
# ---------------------------------------------------------------------------
class TestBridges:
    @pytest.mark.parametrize("name", CATALOGS)
    def test_catalog_equals_the_jax_package_key_for_key(self, name):
        want = getattr(jbridge, name)
        got = getattr(tbridge, name)
        assert list(got.items()) == list(want.items())

    def test_the_same_catalogs_and_bridges(self):
        def names(mod, pred):
            return sorted(n for n in vars(mod) if pred(n))

        assert names(tbridge, lambda n: n.endswith("_METRICS")) == CATALOGS
        assert names(tbridge, lambda n: n.startswith("bridge_")) == \
            names(jbridge, lambda n: n.startswith("bridge_"))

    def test_catalog_names_unique_and_wellformed(self):
        all_names = [name for cat in CATALOGS
                     for name in getattr(tbridge, cat).values()]
        assert len(all_names) == len(set(all_names))
        for name in all_names:
            assert re.match(r"^repro_[a-z][a-z0-9_]*$", name), name

    def test_server_and_class_stats_bridge(self, pkg):
        stats = pkg.sched.ServerStats(pkg.sched.BatchPolicy())
        stats.on_submit(pkg.QoS.RANKING)
        stats.on_complete(0.010, True, pkg.QoS.RANKING)
        reg = pkg.metrics.Registry()
        pkg.bridge.bridge_server_stats(reg, stats.snapshot,
                                       labels={"shard": "s0"})
        parsed = pkg.exporter.parse_text(pkg.exporter.render_text(reg))
        assert parsed[("repro_server_requests_submitted_total",
                       (("shard", "s0"),))] == 1.0
        assert parsed[("repro_server_class_requests_completed_total",
                       (("qos", "RANKING"), ("shard", "s0")))] == 1.0

    def test_tier_bridge_with_derived_ratios(self, pkg):
        tiers = {"emb": {"lookups": 100, "hot_hits": 80, "cold_misses": 15,
                         "garbage_bytes": 30, "cold_file_bytes": 120}}
        reg = pkg.metrics.Registry()
        pkg.bridge.bridge_tier_stats(reg, lambda: tiers)
        parsed = pkg.exporter.parse_text(pkg.exporter.render_text(reg))
        key = (("table", "emb"),)
        assert parsed[("repro_tier_hot_hits_total", key)] == 80.0
        assert parsed[("repro_tier_hot_hit_rate", key)] == 0.8
        assert parsed[("repro_tier_garbage_fraction", key)] == 0.25

    def test_version_window_bridge(self, pkg):
        w = pkg.versioning.VersionWindow(retain=1)
        w.publish(1, "a")
        w.publish(2, "b")                        # evicts v1
        w.get(2)
        w.get(1)                                 # NACK
        reg = pkg.metrics.Registry()
        pkg.bridge.bridge_version_window(reg, w)
        parsed = pkg.exporter.parse_text(pkg.exporter.render_text(reg))
        assert parsed[("repro_version_pin_served_total", ())] == 1.0
        assert parsed[("repro_version_pin_nacks_total", ())] == 1.0
        assert parsed[("repro_version_window_publishes_total", ())] == 2.0
        assert parsed[("repro_version_window_evictions_total", ())] == 1.0

    def test_stream_stats_bridge(self, pkg):
        stats = pkg.pipeline.StreamStats(slo_budget_s=1.0)
        reg = pkg.metrics.Registry()
        pkg.bridge.bridge_stream_stats(reg, stats)
        stats.inc("deltas_published", 3)
        for s in (0.002, 0.3, 1.5):              # the last breaks the SLO
            stats.observe_freshness(s)
        parsed = pkg.exporter.parse_text(pkg.exporter.render_text(reg))
        assert parsed[("repro_stream_deltas_published_total", ())] == 3.0
        assert parsed[("repro_stream_staleness_violations_total", ())] == 1.0
        assert parsed[("repro_stream_freshness_seconds_count", ())] == 3.0
        assert parsed[("repro_stream_freshness_seconds_bucket",
                       (("le", "0.5"),))] == 2.0
        assert parsed[("repro_stream_freshness_seconds_sum", ())] == \
            pytest.approx(1.802)

    def test_snapshot_dicts_render_equal_across_packages(self):
        """Each data bridge fed the same dict snapshots renders the same
        text in both packages."""
        server = {"submitted": 5, "completed": 4, "p99_ms": 2.5,
                  "shed_rate": 0.2, "per_class": {
                      "RANKING": {"submitted": 3, "p50_ms": 1.0},
                      "PREFETCH": {"submitted": 2, "shed_rate": 0.5}}}
        tiers = {"a": {"lookups": 10, "hot_hits": 9, "garbage_bytes": 1,
                       "cold_file_bytes": 4}, "b": {"lookups": 0}}
        traffic = {"offered": 10, "attainment": 0.9, "per_class": {
            "RANKING": {"offered": 10, "p99_ms": 3.0}}}
        controller = types.SimpleNamespace(snapshot=lambda: {
            "ticks": 3, "hot_fraction": 0.25, "per_lane": {
                "RANKING": {"max_batch_keys": 4096, "max_wait_ms": 2.0}}})

        def render(p):
            reg = p.metrics.Registry()
            p.bridge.bridge_server_stats(reg, lambda: server,
                                         labels={"shard": "0"})
            p.bridge.bridge_tier_stats(reg, lambda: tiers)
            p.bridge.bridge_traffic_stats(reg, lambda: traffic)
            p.bridge.bridge_controller(reg, controller)
            return p.exporter.render_text(reg)

        jtext, ttext = _both(render)
        assert ttext == jtext
        assert "repro_traffic_ctl_lane_max_batch_keys" in ttext
