"""The port's wire codec (``api/wire.py``) against the JAX package's.

The cases come from each package's ``wire.WIRE_MESSAGES``: every registered
kind round-trips through the port's framing, and a frame encoded by either
package decodes in the other to an equal value, the two packages' payload
bytes equal.  Typed errors decode as the decoding package's own classes;
in the port, with the JAX package unimportable, so that no error source
reaches it at run time.  An unknown error type degrades to
``RuntimeError``.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from repro.api import types as jtypes
from repro.api import wire as jwire
from repro.core import query_types as jqt
from repro.serve import scheduler as jsched
from repro_torch.api import types as ttypes
from repro_torch.api import wire as twire
from repro_torch.core import query_types as tqt
from repro_torch.serve import scheduler as tsched

from conftest import subprocess_env

PKGS = {
    "jax": types.SimpleNamespace(wire=jwire, types=jtypes, qt=jqt,
                                 sched=jsched),
    "torch": types.SimpleNamespace(wire=twire, types=ttypes, qt=tqt,
                                   sched=tsched),
}


def _sample_request(t):
    rng = np.random.default_rng(3)
    return t.QueryRequest(
        tables={"emb": rng.integers(0, 2**63, 17).astype(np.uint64),
                "scalar": rng.integers(0, 2**63, 5).astype(np.uint64)},
        qos=t.QoSClass.RETRIEVAL,
        consistency=t.Consistency("pinned", 42),
        budget_s=0.25,
        trace={"trace_id": "deadbeefcafe0123", "parent_id": "0011223344"})


def _sample_response(t):
    rng = np.random.default_rng(7)
    tables = {
        "emb": t.TableResult(
            found=rng.integers(0, 2, 17).astype(bool),
            payloads=rng.integers(0, 2**63, 17).astype(np.uint64),
            values=rng.integers(0, 256, (17, 8)).astype(np.uint8)),
        "empty": t.TableResult(
            found=np.zeros(0, dtype=bool),
            payloads=np.zeros(0, dtype=np.uint64),
            values=np.zeros((0, 8), dtype=np.uint8)),
    }
    return t.QueryResponse(version=9, tables=tables,
                           qos=t.QoSClass.PREFETCH, latency_s=0.003,
                           batch_id=12,
                           trace=[{"trace_id": "deadbeefcafe0123",
                                   "span_id": "aa", "parent_id": None,
                                   "name": "serve", "proc": "shard0/r0",
                                   "t0": 1.5, "t1": 1.75,
                                   "tags": {"version": 9}}])


def _sample_update(_t):
    rng = np.random.default_rng(11)
    upserts = {"emb": (rng.integers(0, 2**63, 6).astype(np.uint64),
                       rng.integers(0, 256, (6, 16)).astype(np.uint8))}
    deletes = {"emb": rng.integers(0, 2**63, 3).astype(np.uint64)}
    return 5, upserts, deletes


def _sample_tree(_t):
    return {"op": "snapshot", "dir": "/tmp/x", "nested": {"n": 3},
            "arr": np.arange(12, dtype=np.int64).reshape(3, 4)}


def _assert_request_eq(got, want):
    assert got.qos.name == want.qos.name
    assert got.consistency.mode == want.consistency.mode
    assert got.consistency.version == want.consistency.version
    assert got.budget_s == want.budget_s
    assert got.trace == want.trace
    assert set(got.tables) == set(want.tables)
    for name in want.tables:
        np.testing.assert_array_equal(got.tables[name], want.tables[name])
        assert got.tables[name].dtype == want.tables[name].dtype


def _assert_response_eq(got, want):
    assert got.version == want.version
    assert got.qos.name == want.qos.name
    assert got.latency_s == want.latency_s
    assert got.batch_id == want.batch_id
    assert got.trace == want.trace
    assert set(got.tables) == set(want.tables)
    for name, tr in want.tables.items():
        for field in ("found", "payloads", "values"):
            g, w = getattr(got.tables[name], field), getattr(tr, field)
            np.testing.assert_array_equal(g, w, field)
            assert g.dtype == w.dtype and g.shape == w.shape


def _assert_update_eq(got, want):
    assert got[0] == want[0]
    assert set(got[1]) == set(want[1])
    for name, (k, r) in want[1].items():
        np.testing.assert_array_equal(got[1][name][0], k)
        np.testing.assert_array_equal(got[1][name][1], r)
    assert set(got[2]) == set(want[2])
    for name, k in want[2].items():
        np.testing.assert_array_equal(got[2][name], k)


def _assert_tree_eq(got, want):
    assert set(got) == set(want)
    assert got["op"] == want["op"] and got["dir"] == want["dir"]
    assert got["nested"] == want["nested"]
    np.testing.assert_array_equal(got["arr"], want["arr"])


def _assert_error_eq(got, want):
    assert type(got).__name__ == type(want).__name__
    assert str(want.args[0]) in str(got)


def _assert_ok_eq(got, want):
    assert got == (want or {})


def _stats(_t):
    return {"server": {"submitted": 12, "p99_ms": 1.25,
                       "per_class": {"RANKING": {"shed": 0}}},
            "tiers": {"emb": {"lookups": 40, "hot_hits": 33}}}


# kind -> (sample maker over a package, equality assertion, calling)
_SAMPLES = {
    1: (lambda p: _sample_request(p.types), _assert_request_eq, None),
    2: (lambda p: _sample_update(p.types), _assert_update_eq, "splat"),
    3: (lambda p: _sample_tree(p.types), _assert_tree_eq, None),
    4: (lambda p: _sample_tree(p.types), _assert_tree_eq, None),
    5: (lambda p: {"op": "shutdown", "dir": ".", "nested": {},
                   "arr": np.zeros(1)}, _assert_tree_eq, None),
    6: (lambda p: _stats(p.types), _assert_ok_eq, None),
    16: (lambda p: _sample_response(p.types), _assert_response_eq, None),
    17: (lambda p: {"applied": 3}, _assert_ok_eq, None),
    18: (lambda p: p.qt.VersionEvictedError("version 4 evicted"),
         _assert_error_eq, None),
}


def _encode(pkg, kind):
    make, _, calling = _SAMPLES[kind]
    sample = make(pkg)
    encode = pkg.wire.WIRE_MESSAGES[kind][0]
    return sample, encode(*sample) if calling == "splat" else encode(sample)


def test_every_registered_kind_has_a_sample():
    assert set(_SAMPLES) == set(twire.WIRE_MESSAGES) == \
        set(jwire.WIRE_MESSAGES)
    for name in dir(jwire):
        if name.startswith("KIND_"):
            assert getattr(twire, name) == getattr(jwire, name), name


@pytest.mark.parametrize("kind", sorted(twire.WIRE_MESSAGES))
def test_roundtrip(kind):
    pkg = PKGS["torch"]
    sample, payload = _encode(pkg, kind)
    assert isinstance(payload, bytes)
    frame = twire.pack_frame(kind, 77, payload)
    got_kind, rid, got_payload = twire.unpack_frame(frame)
    assert got_kind == kind and rid == 77
    _SAMPLES[kind][1](twire.WIRE_MESSAGES[kind][1](got_payload), sample)


@pytest.mark.parametrize("kind", sorted(twire.WIRE_MESSAGES))
@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_frames_cross_packages(kind, direction):
    """A frame one package encodes decodes in the other to an equal value
    (errors as the decoder's own class of that name); both packages encode
    equal samples to equal bytes."""
    src, dst = (PKGS[p] for p in direction.split("->"))
    sample, payload = _encode(src, kind)
    _, other = _encode(dst, kind)
    assert payload == other
    frame = src.wire.pack_frame(kind, 2**40 + 3, payload)
    assert frame == dst.wire.pack_frame(kind, 2**40 + 3, other)
    got_kind, rid, got_payload = dst.wire.unpack_frame(frame)
    assert (got_kind, rid) == (kind, 2**40 + 3)
    got = dst.wire.WIRE_MESSAGES[kind][1](got_payload)
    _SAMPLES[kind][1](got, sample)
    if kind == twire.KIND_ERROR:
        assert type(got) is dst.qt.VersionEvictedError


@pytest.mark.parametrize("name", ["QueueFullError", "DeadlineError",
                                  "ServerClosedError", "ShedError"])
def test_server_errors_decode_as_the_ports_own(name):
    err = getattr(jsched, name)("lane full")
    got = twire.decode_error(jwire.encode_error(err))
    assert type(got) is getattr(tsched, name)
    assert "lane full" in str(got)


def test_builtin_and_api_errors_decode_typed():
    got = twire.decode_error(twire.encode_error(KeyError("no table 'x'")))
    assert type(got) is KeyError and got.args[0] == "no table 'x'"
    got = twire.decode_error(jwire.encode_error(
        jtypes.ConsistencyError("mixed")))
    assert type(got) is ttypes.ConsistencyError


def test_unknown_error_type_degrades_to_runtimeerror():
    class Weird(Exception):
        pass
    got = twire.decode_error(twire.encode_error(Weird("boom")))
    assert isinstance(got, RuntimeError)
    assert "Weird" in str(got) and "boom" in str(got)
    # the fabric's errors are the port's own now, from either encoder
    from repro.serve import fabric as jfabric
    from repro_torch.serve import fabric as tfabric
    for wire_of, err in ((jwire, jfabric.NoReplicaError("none")),
                         (twire, tfabric.NoReplicaError("none"))):
        got = twire.decode_error(wire_of.encode_error(err))
        assert type(got) is tfabric.NoReplicaError and "none" in str(got)
    got = twire.decode_error(twire.encode_tree(
        {"type": "NoSuchFabricError", "message": "gone"}))
    assert type(got) is RuntimeError and "NoSuchFabricError" in str(got)


def test_errors_decode_without_the_jax_package():
    """Decoding every error kind in the port, in a process where neither
    JAX nor the JAX package can be imported, imports neither."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.api import wire\n"
        "for name in ('VersionEvictedError', 'QueueFullError',\n"
        "             'ConsistencyError', 'NoReplicaError',\n"
        "             'ReplicaDeadError', 'KeyError'):\n"
        "    data = wire.encode_tree({'type': name, 'message': 'm'})\n"
        "    print(name, type(wire.decode_error(data)).__module__)\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m, v in sys.modules.items() if v is not None)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=subprocess_env(),
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-3000:]
    mods = dict(line.split() for line in r.stdout.split("\n") if line)
    assert mods == {"VersionEvictedError": "repro_torch.core.query_types",
                    "QueueFullError": "repro_torch.serve.scheduler",
                    "ConsistencyError": "repro_torch.api.types",
                    "NoReplicaError": "repro_torch.serve.fabric",
                    "ReplicaDeadError": "repro_torch.serve.fabric",
                    "KeyError": "builtins"}


def test_malformed_payloads_raise_wire_errors():
    with pytest.raises(twire.WireError):
        twire.decode_tree(b"XXXX\0\0\0\0")
    payload = twire.encode_tree({"a": np.arange(4)})
    with pytest.raises(twire.WireError):
        twire.decode_tree(payload[:-1])
    with pytest.raises(twire.WireError):
        twire.unpack_frame(b"\x01")
    with pytest.raises(TypeError):
        twire.encode_tree({"__nd__": 1})
