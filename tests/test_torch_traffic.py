"""The port's traffic harness (``repro_torch.traffic``) and load-test
launcher (``repro_torch.launch.loadtest``) against the JAX package's, on
the CPU.  Host code on both sides, so the comparisons are exact: the same
seeded pattern gives bitwise the same schedule (offer times, sessions,
classes, key ranks per table, budgets); the same scripted outcomes give
the same ``TrafficStats`` snapshots, ``burst_p99_ms`` and ``slo_report``;
``OpenLoopDriver`` against a stub server that answers, sheds or fails by
a seeded script gives the same offered, completed, shed and failed
counts; ``AdaptiveController.tick()`` over scripted stats and a fake store
gives the same record tick by tick and the same ``decisions()``; and the
launcher run in-process exits 0 with a report of the same keys.  No test
here asserts a latency, a rate or an attainment of a live run."""
from __future__ import annotations

import dataclasses
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api.types as jtypes
import repro.launch.loadtest as jloadtest
import repro.serve.scheduler as jsched
import repro.traffic as jtraffic
import repro_torch.api.types as ttypes
import repro_torch.launch.loadtest as tloadtest
import repro_torch.serve.scheduler as tsched
import repro_torch.traffic as ttraffic

# each package's (types, scheduler, traffic) modules
PKGS = {"jax": (jtypes, jsched, jtraffic),
        "torch": (ttypes, tsched, ttraffic)}


def _same(a, b):
    """Equal as JSON (NaN equal to NaN, floats bit for bit through repr)."""
    assert json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# loadgen: the schedule
# ---------------------------------------------------------------------------
def _pattern(pkg, *, bursts=(), diurnal=None, mix=None, shapes=None, **kw):
    """A ``TrafficPattern`` of package ``pkg`` built from plain values:
    ``bursts`` (start, duration, multiplier) tuples, ``diurnal`` (period,
    peak_to_trough, phase) or None, ``mix`` (ranking, retrieval, prefetch)
    or None, ``shapes`` {class name: ((table, n_keys), ..., budget)}."""
    types, _, traffic = PKGS[pkg]
    if diurnal is not None:
        kw["diurnal"] = traffic.DiurnalCurve(*diurnal)
    if mix is not None:
        kw["mix"] = traffic.QoSMix(*mix)
    if shapes is not None:
        kw["shapes"] = {types.QoSClass[q]: traffic.RequestShape(
            tuple(spec[:-1]), budget_s=spec[-1])
            for q, spec in shapes.items()}
    return traffic.TrafficPattern(
        bursts=tuple(traffic.FlashCrowd(*b) for b in bursts), **kw)


def _events(events):
    return [(ev.t_s, ev.session, ev.qos.name, ev.budget_s,
             {t: (r.dtype.str, r.tolist()) for t, r in ev.ranks.items()})
            for ev in events]


PATTERNS = {
    "plain": dict(duration_s=2.0, base_session_rate=30.0, vocab=5000),
    "diurnal_and_bursts": dict(
        duration_s=3.0, base_session_rate=25.0, seed=7, vocab=20_000,
        zipf_skew=0.9, diurnal=(3.0, 3.0, 0.25),
        bursts=((0.5, 0.4, 4.0), (0.7, 1.0, 2.5), (2.8, 5.0, 3.0))),
    "mix_and_shapes": dict(
        duration_s=1.5, base_session_rate=40.0, seed=3, vocab=1000,
        zipf_skew=0.0, mix=(2.0, 0.0, 1.0), think_time_s=0.0,
        requests_per_session=(1, 3),
        shapes={"RANKING": (("a", 5), ("b", 17), 0.03),
                "RETRIEVAL": (("a", 9), None),
                "PREFETCH": (("c", 33), None)}),
    "peak_diurnal": dict(duration_s=2.0, base_session_rate=15.0, seed=11,
                         vocab=300, zipf_skew=1.4,
                         diurnal=(1.0, 6.0, 0.5), bursts=((1.0, 0.5, 8.0),),
                         requests_per_session=(4, 9), think_time_s=0.2),
}


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("name", list(PATTERNS))
def test_schedule_matches_reference_bitwise(name, seed):
    kw = dict(PATTERNS[name], seed=PATTERNS[name].get("seed", 0) + seed)
    jp, tp = _pattern("jax", **kw), _pattern("torch", **kw)
    got = ttraffic.generate_schedule(tp)
    want = jtraffic.generate_schedule(jp)
    assert len(got) > 10
    assert _events(got) == _events(want)
    assert ttraffic.burst_windows(tp) == jtraffic.burst_windows(jp)
    for w in (0.1, 0.37):
        np.testing.assert_array_equal(ttraffic.offered_per_window(got, w),
                                      jtraffic.offered_per_window(want, w))
    t = np.linspace(0, kw["duration_s"], 97)
    np.testing.assert_array_equal(tp.rate(t), jp.rate(t))
    assert tp.peak_rate() == jp.peak_rate()


@settings(deadline=None, max_examples=25, database=None)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(1.0, 60.0),
       vocab=st.integers(1, 3000), skew=st.floats(0.0, 2.0),
       burst=st.tuples(st.floats(0.0, 1.0), st.floats(0.05, 1.0),
                       st.floats(1.0, 5.0)),
       peak=st.floats(1.0, 5.0), phase=st.floats(0.0, 1.0))
def test_schedule_property_matches_reference(seed, rate, vocab, skew, burst,
                                             peak, phase):
    kw = dict(duration_s=1.0, base_session_rate=rate, seed=seed,
              vocab=vocab, zipf_skew=skew, bursts=(burst,),
              diurnal=(0.7, peak, phase))
    assert _events(ttraffic.generate_schedule(_pattern("torch", **kw))) == \
        _events(jtraffic.generate_schedule(_pattern("jax", **kw)))


@pytest.mark.parametrize("vocab,skew", [(1, 1.1), (50, 0.0), (1000, 1.1),
                                        (4096, 2.5)])
def test_zipf_popularity_matches_reference(vocab, skew):
    tz = ttraffic.ZipfianPopularity(vocab, skew)
    jz = jtraffic.ZipfianPopularity(vocab, skew)
    np.testing.assert_array_equal(tz.pmf(), jz.pmf())
    got = tz.sample(np.random.default_rng(vocab), (3, 500))
    want = jz.sample(np.random.default_rng(vocab), (3, 500))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [
    dict(duration_s=0.0), dict(base_session_rate=-1.0),
    dict(requests_per_session=(3, 2)), dict(think_time_s=-0.1),
    dict(bursts=((-1.0, 1.0, 2.0),)), dict(bursts=((0.0, 1.0, 0.5),)),
    dict(diurnal=(0.0, 2.0, 0.0)), dict(diurnal=(1.0, 0.5, 0.0)),
    dict(mix=(0.0, 0.0, 0.0)), dict(mix=(-1.0, 1.0, 1.0)),
    dict(shapes={"RANKING": (("t", 0), None)}),
    dict(shapes={"RANKING": (("t", 4), -1.0)})])
def test_pattern_validation_matches_reference(bad):
    errors = []
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError) as info:
            _pattern(pkg, **bad)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# driver: stats, burst p99 and the report on scripted samples
# ---------------------------------------------------------------------------
OUTCOMES = ("completed", "completed", "completed", "shed", "failed")


def _script(seed, n=400):
    """A seeded script of (t_s, class name, outcome, latency_s, budget_s)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = ("RANKING", "RETRIEVAL", "PREFETCH")[int(rng.integers(3))]
        outcome = OUTCOMES[int(rng.integers(len(OUTCOMES)))]
        lat = float(rng.exponential(0.03)) if outcome == "completed" \
            else float("nan")
        budget = {"RANKING": 0.05, "RETRIEVAL": 0.1, "PREFETCH": None}[q]
        out.append((float(i) * 0.01, q, outcome, lat, budget))
    return out


def _samples(pkg, script):
    types, _, traffic = PKGS[pkg]
    return [traffic.Sample(t_s=t, qos=types.QoSClass[q], outcome=o,
                           latency_s=lat, budget_s=b)
            for t, q, o, lat, b in script]


def _stats(pkg, script):
    """A ``TrafficStats`` fed the script, each offer at a fixed clock."""
    types, _, traffic = PKGS[pkg]
    stats = traffic.TrafficStats()
    for i, (t, q, o, lat, b) in enumerate(script):
        stats.on_offer(types.QoSClass[q], 0.001 * (i % 7), 100.0 + t)
    for s in _samples(pkg, script):
        stats.on_outcome(s.qos, s.outcome, s.latency_s, s.slo_met)
    return stats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traffic_stats_and_report_match_reference(seed):
    script = _script(seed)
    kw = PATTERNS["diurnal_and_bursts"]
    snaps = {pkg: _stats(pkg, script).snapshot() for pkg in PKGS}
    _same(dataclasses.asdict(snaps["torch"]),
          dataclasses.asdict(snaps["jax"]))
    assert snaps["torch"].offered == len(script)
    reports = {pkg: PKGS[pkg][2].slo_report(
        _pattern(pkg, **kw), snaps[pkg], _samples(pkg, script),
        controller={"ticks": 3}) for pkg in PKGS}
    _same(reports["torch"], reports["jax"])
    assert set(reports["torch"]["burst"]) == {"RANKING", "RETRIEVAL",
                                              "PREFETCH"}


@pytest.mark.parametrize("ceiling_s", [0.02, 1.0])
@pytest.mark.parametrize("qos", ["RANKING", "RETRIEVAL", "PREFETCH"])
def test_burst_p99_matches_reference(qos, ceiling_s):
    script = _script(9)
    windows = [(0.5, 1.5), (2.0, 2.2), (3.9, 10.0)]
    got = ttraffic.burst_p99_ms(_samples("torch", script), windows,
                                qos=ttypes.QoSClass[qos],
                                ceiling_s=ceiling_s)
    want = jtraffic.burst_p99_ms(_samples("jax", script), windows,
                                 qos=jtypes.QoSClass[qos],
                                 ceiling_s=ceiling_s)
    assert np.isfinite(got)
    _same(got, want)


# ---------------------------------------------------------------------------
# driver: open-loop replay against a stub server
# ---------------------------------------------------------------------------
class _Ticket:
    def __init__(self, resp):
        self._resp = resp

    def result(self, timeout=None):
        if isinstance(self._resp, Exception):
            raise self._resp
        return self._resp


class _ScriptedServer:
    """Settles each request by a seeded script over its submission order
    (the dispatcher submits in schedule order, so the script is the same
    whatever the reapers' timing): shed at submit, shed at the result,
    fail at submit, fail at the result, or complete with a scripted
    latency."""

    def __init__(self, pkg, seed):
        self.shed = PKGS[pkg][1].ShedError
        self.rng = np.random.default_rng(seed)
        self.requests = []

    def submit(self, request):
        self.requests.append(request)
        fate = int(self.rng.integers(8))
        lat = float(self.rng.exponential(0.02))
        if fate == 0:
            raise self.shed("lane full")
        if fate == 1:
            raise RuntimeError("backend down")
        if fate == 2:
            return _Ticket(self.shed("deadline"))
        if fate == 3:
            return _Ticket(RuntimeError("lookup failed"))
        return _Ticket(SimpleNamespace(latency_s=lat))


@pytest.mark.parametrize("seed", [0, 1])
def test_open_loop_driver_matches_reference(seed):
    kw = dict(PATTERNS["diurnal_and_bursts"], duration_s=1.0, seed=seed)
    out = {}
    for pkg in PKGS:
        traffic = PKGS[pkg][2]
        server = _ScriptedServer(pkg, seed)
        pattern = _pattern(pkg, **kw)
        keys = {"item_attr": np.arange(pattern.vocab, dtype=np.uint64) * 3}
        driver = traffic.OpenLoopDriver(server, pattern, keys=keys,
                                        time_scale=0.02, reapers=3)
        snap = dataclasses.asdict(driver.run())
        for k in ("offered_rps", "dispatch_lag_ms"):
            snap.pop(k)                  # the host clock's
        out[pkg] = (snap, sorted((s.t_s, s.qos.name, s.outcome,
                                  str(s.latency_s)) for s in driver.samples),
                    [(r.qos.name, {t: v.tolist() for t, v in
                                   r.tables.items()}, r.budget_s)
                     for r in server.requests])
    _same(out["torch"], out["jax"])
    snap = out["torch"][0]
    assert snap["offered"] == len(out["torch"][2]) > 50
    assert min(snap["completed"], snap["shed"], snap["failed"]) > 0
    assert snap["completed"] + snap["shed"] + snap["failed"] == \
        snap["offered"]


def test_driver_validation_matches_reference():
    for pkg in PKGS:
        traffic = PKGS[pkg][2]
        pattern = _pattern(pkg, duration_s=1.0)
        with pytest.raises(ValueError, match="time_scale"):
            traffic.OpenLoopDriver(None, pattern, time_scale=0.0)
        with pytest.raises(ValueError, match="reapers"):
            traffic.OpenLoopDriver(None, pattern, reapers=0)


# ---------------------------------------------------------------------------
# controller: scripted stats, one tick at a time
# ---------------------------------------------------------------------------
class _LaneServer:
    """Real ``BatchPolicy`` objects of package ``pkg`` per lane (the
    validation stays in the loop), no scheduler behind them."""

    def __init__(self, pkg, policy_kw):
        types, sched, _ = PKGS[pkg]
        self._pol = {q.name: sched.BatchPolicy(**policy_kw)
                     for q in types.QoSClass}

    def lane_policies(self):
        return dict(self._pol)

    def retune_lane(self, qos, **changes):
        pol = dataclasses.replace(self._pol[qos.name], **changes)
        self._pol[qos.name] = pol
        return pol


class _Store:
    def __init__(self, hits):
        self.hot_fraction, self.compaction_threshold = 0.1, 0.4
        self._hits = iter(hits)
        self.tiers = SimpleNamespace(hot_hits=0, cold_misses=0)

    def set_hot_fraction(self, f):
        self.hot_fraction = f

    def set_compaction_threshold(self, t):
        self.compaction_threshold = t

    def stats_snapshot(self):
        h, m = next(self._hits, (0, 0))
        self.tiers = SimpleNamespace(hot_hits=self.tiers.hot_hits + h,
                                     cold_misses=self.tiers.cold_misses + m)
        return self.tiers


def _stats_walk(pkg, seed, ticks):
    """Cumulative ``StatsSnapshot``s of package ``pkg``: a seeded walk of
    calm, overloaded, stalled and thin intervals on RANKING and
    RETRIEVAL."""
    _, sched, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    tot = dict(submitted=0, completed=0, batches=0, keys_requested=0,
               service_sum_ms=0.0)
    lanes = {q: dict(submitted=0, completed=0, shed_deadline=0,
                     latency_sum_ms=0.0) for q in ("RANKING", "RETRIEVAL")}
    out = []
    for i in range(ticks + 1):
        if i:
            batches = int(rng.integers(0, 30)) * int(rng.random() > 0.15)
            tot["batches"] += batches
            tot["keys_requested"] += batches * int(rng.integers(50, 9000))
            tot["service_sum_ms"] += batches * float(rng.exponential(30.0))
            for lane in lanes.values():
                sub = int(rng.integers(0, 200))
                shed = int(sub * rng.random() * (rng.random() > 0.6) * 0.3)
                done = sub - shed
                lane["submitted"] += sub
                lane["shed_deadline"] += shed
                lane["completed"] += done
                lane["latency_sum_ms"] += done * float(rng.exponential(40.0))
                tot["submitted"] += sub
                tot["completed"] += done
        per_class = {q: sched.ClassSnapshot() for q in
                     ("RANKING", "RETRIEVAL", "PREFETCH")}
        per_class.update({q: sched.ClassSnapshot(**v)
                          for q, v in lanes.items()})
        out.append(sched.StatsSnapshot(per_class=per_class, **tot))
    return out


@pytest.mark.parametrize("cooldown", [0, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_ticks_match_reference(seed, cooldown):
    ticks = 40
    hits = [(int(h), int(m)) for h, m in np.random.default_rng(seed).integers(
        0, 100, (ticks + 1, 2))]
    out = {}
    for pkg in PKGS:
        types, _, traffic = PKGS[pkg]
        walk = iter(_stats_walk(pkg, seed, ticks))
        server = _LaneServer(pkg, dict(max_batch_keys=512,
                                       max_batch_requests=5,
                                       max_wait_s=1e-3))
        store = _Store(hits)
        ctl = traffic.AdaptiveController(
            server, {types.QoSClass.RANKING: 0.05, "RETRIEVAL": 0.1},
            config=traffic.ControllerConfig(min_samples=10,
                                            cooldown_ticks=cooldown),
            stores=(store,), stats_fn=lambda: next(walk))
        records = [ctl.tick() for _ in range(ticks)]
        out[pkg] = (records, ctl.decisions(), ctl.history,
                    dataclasses.asdict(ctl.snapshot()),
                    (store.hot_fraction, store.compaction_threshold))
    _same(out["torch"], out["jax"])
    actions = {lane["action"] for rec in out["torch"][0]
               for lane in rec["lanes"].values()}
    assert {"grow", "shrink", "hold"} <= actions


def test_controller_validation_matches_reference():
    for pkg in PKGS:
        types, _, traffic = PKGS[pkg]
        server = _LaneServer(pkg, dict(max_batch_keys=512))
        with pytest.raises(ValueError):
            traffic.AdaptiveController(server, {})
        with pytest.raises(ValueError):
            traffic.AdaptiveController(server, {types.QoSClass.RANKING: 0})
        for bad in (dict(lat_low_frac=0.7, lat_high_frac=0.6),
                    dict(grow_factor=0.9), dict(min_wait_s=0.0),
                    dict(min_batch_keys=4096, max_batch_keys=512)):
            with pytest.raises(ValueError):
                traffic.ControllerConfig(**bad)


# ---------------------------------------------------------------------------
# the launcher, in-process
# ---------------------------------------------------------------------------
ARGV = ["--smoke", "--adaptive", "--duration-s", "1"]


def _keys(obj):
    """The nested key structure of a JSON object."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def _report(capsys):
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("loadtest SLO report: ")]
    assert len(line) == 1
    return json.loads(line[0][len("loadtest SLO report: "):])


def test_loadtest_main_runs_in_process_like_the_reference(capsys,
                                                          monkeypatch,
                                                          tmp_path):
    record = str(tmp_path / "loadtest.json")
    with pytest.raises(SystemExit) as info:
        tloadtest.main(ARGV + ["--record", record])
    assert info.value.code == 0
    got = _report(capsys)
    monkeypatch.setattr(sys, "argv", ["loadtest"] + ARGV)
    with pytest.raises(SystemExit) as info:
        jloadtest.main()
    assert info.value.code == 0
    want = _report(capsys)
    assert _keys(got) == _keys(want)
    assert got["pattern"] == want["pattern"]
    assert got["offered"] == want["offered"] > 0 and got["failed"] == 0
    assert got["controller"]["ticks"] > 0
    with open(record) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["report"] == got
    families = {name.split("{")[0] for name in rec["metrics"]}
    assert {"repro_traffic_requests_offered_total",
            "repro_traffic_class_requests_offered_total",
            "repro_traffic_ctl_ticks_total",
            "repro_traffic_ctl_lane_max_batch_keys"} <= families


def test_loadtest_refuses_a_bad_burst():
    with pytest.raises(SystemExit) as info:
        tloadtest.main(["--burst", "1:2"])
    assert info.value.code == 2
    assert tloadtest.parse_burst("1:0.5:3") == ttraffic.FlashCrowd(1.0, 0.5,
                                                                   3.0)
