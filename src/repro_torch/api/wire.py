"""Wire encoding for the FeatureService protocol (the fabric's transport).

``QueryRequest`` / ``QueryResponse`` / delta updates / typed errors travel
between the router and shard-server processes as framed byte messages:

    frame   := kind (u8) | request_id (u64le) | payload
    payload := MAGIC "NWIR" | header_len (u32le) | JSON header | raw arrays

The JSON header carries the message tree with every numpy array replaced by
a ``{"__nd__": i, "dtype": ..., "shape": ...}`` placeholder; the arrays'
raw bytes follow the header back-to-back in placeholder order.  Key sets
and value rows — the bulk of every message — therefore cross the pipe as
straight buffer copies, and the decoder is ``json.loads`` plus
``np.frombuffer``: **no pickle anywhere**, so a compromised or corrupted
peer can at worst produce a malformed message error, never code execution.

Errors cross the wire as ``{type, message}`` and are re-raised typed on the
other side when the name matches a known protocol error
(``VersionEvictedError``, ``QueueFullError``, ...), else as ``RuntimeError``
— the router's retry logic keys on these types, so a NACK must survive the
process hop as itself.
"""
from __future__ import annotations

import importlib
import json
import struct
from typing import Optional

import numpy as np

from repro_torch.api.types import (Consistency, QoSClass, QueryRequest,
                                   QueryResponse, TableResult)

__all__ = [
    "KIND_QUERY", "KIND_UPDATE", "KIND_HEALTH", "KIND_SNAPSHOT",
    "KIND_SHUTDOWN", "KIND_STATS", "KIND_RESPONSE", "KIND_OK",
    "KIND_ERROR", "WIRE_MESSAGES",
    "decode_error", "decode_ok", "decode_request", "decode_response",
    "decode_stats", "decode_tree", "decode_update", "encode_error",
    "encode_ok", "encode_request", "encode_response", "encode_stats",
    "encode_tree", "encode_update", "pack_frame", "unpack_frame",
]

MAGIC = b"NWIR"
_ND = "__nd__"

# frame kinds: router -> shard
KIND_QUERY = 1
KIND_UPDATE = 2
KIND_HEALTH = 3
KIND_SNAPSHOT = 4
KIND_SHUTDOWN = 5
KIND_STATS = 6       # observability scrape: shard stats silo snapshots
# shard -> router
KIND_RESPONSE = 16
KIND_OK = 17
KIND_ERROR = 18


class WireError(RuntimeError):
    """Malformed frame or payload (bad magic, truncated segment, ...)."""


# ---------------------------------------------------------------------------
# tree codec: JSON header + raw array segments
# ---------------------------------------------------------------------------
def encode_tree(obj) -> bytes:
    """Serialize a tree of dict/list/str/int/float/bool/None/np.ndarray."""
    blobs: list[np.ndarray] = []

    def enc(o):
        if isinstance(o, np.ndarray):
            a = np.ascontiguousarray(o)
            blobs.append(a)
            return {_ND: len(blobs) - 1, "dtype": a.dtype.str,
                    "shape": list(a.shape)}
        if isinstance(o, dict):
            out = {}
            for k, v in o.items():
                if not isinstance(k, str):
                    raise TypeError(f"wire dict keys must be str, "
                                    f"got {type(k).__name__}")
                if k == _ND:
                    raise TypeError(f"{_ND!r} is a reserved key")
                out[k] = enc(v)
            return out
        if isinstance(o, (list, tuple)):
            return [enc(v) for v in o]
        if isinstance(o, bool) or o is None or isinstance(o, str):
            return o
        if isinstance(o, (int, np.integer)):
            return int(o)
        if isinstance(o, (float, np.floating)):
            return float(o)
        raise TypeError(f"cannot encode {type(o).__name__} on the wire")

    header = json.dumps(enc(obj), separators=(",", ":")).encode("utf-8")
    parts = [MAGIC, struct.pack("<I", len(header)), header]
    parts.extend(a.tobytes() for a in blobs)
    return b"".join(parts)


def decode_tree(data):
    """Inverse of ``encode_tree``.  Arrays are copied out of the buffer
    (the caller may recycle it); placeholder order defines segment order."""
    view = memoryview(data)
    if len(view) < 8 or bytes(view[:4]) != MAGIC:
        raise WireError("bad magic (not a wire payload)")
    (hlen,) = struct.unpack_from("<I", view, 4)
    if 8 + hlen > len(view):
        raise WireError("truncated header")
    tree = json.loads(bytes(view[8:8 + hlen]).decode("utf-8"))

    # first pass: collect placeholder specs in index order
    specs: dict[int, tuple[np.dtype, tuple]] = {}

    def scan(o):
        if isinstance(o, dict):
            if _ND in o:
                specs[int(o[_ND])] = (np.dtype(o["dtype"]),
                                      tuple(o["shape"]))
            else:
                for v in o.values():
                    scan(v)
        elif isinstance(o, list):
            for v in o:
                scan(v)

    scan(tree)
    offsets: dict[int, int] = {}
    pos = 8 + hlen
    for i in sorted(specs):
        if i != len(offsets):
            raise WireError("non-contiguous array segment indices")
        dtype, shape = specs[i]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * dtype.itemsize
        if pos + nbytes > len(view):
            raise WireError("truncated array segment")
        offsets[i] = pos
        pos += nbytes

    def sub(o):
        if isinstance(o, dict):
            if _ND in o:
                i = int(o[_ND])
                dtype, shape = specs[i]
                n = int(np.prod(shape, dtype=np.int64)) if shape else 1
                start = offsets[i]
                a = np.frombuffer(view, dtype=dtype, count=n,
                                  offset=start).reshape(shape)
                return a.copy()
            return {k: sub(v) for k, v in o.items()}
        if isinstance(o, list):
            return [sub(v) for v in o]
        return o

    return sub(tree)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------
_FRAME = struct.Struct("<BQ")


def pack_frame(kind: int, request_id: int, payload: bytes) -> bytes:
    return _FRAME.pack(kind, request_id) + payload


def unpack_frame(data) -> tuple[int, int, memoryview]:
    view = memoryview(data)
    if len(view) < _FRAME.size:
        raise WireError("truncated frame")
    kind, request_id = _FRAME.unpack_from(view, 0)
    return kind, request_id, view[_FRAME.size:]


# ---------------------------------------------------------------------------
# protocol messages
# ---------------------------------------------------------------------------
def encode_request(req: QueryRequest) -> bytes:
    return encode_tree({
        "tables": req.tables,
        "qos": req.qos.name,
        "consistency": {"mode": req.consistency.mode,
                        "version": req.consistency.version},
        "budget_s": req.budget_s,
        # tracing context header (obs/trace.py); None when unsampled
        "trace": req.trace,
    })


def decode_request(data) -> QueryRequest:
    t = decode_tree(data)
    c = t["consistency"]
    return QueryRequest(
        tables=t["tables"],
        qos=QoSClass.parse(t["qos"]),
        consistency=Consistency(c["mode"], c["version"]),
        budget_s=t["budget_s"],
        trace=t.get("trace"))


def encode_response(res: QueryResponse) -> bytes:
    tables = {}
    for name, tr in res.tables.items():
        tables[name] = {"found": tr.found, "payloads": tr.payloads,
                        "values": tr.values}
    return encode_tree({
        "version": res.version,
        "qos": res.qos.name,
        "latency_s": res.latency_s,
        "batch_id": res.batch_id,
        "tables": tables,
        # spans recorded shard-side for a traced request (wire dicts);
        # the router merges them into its own timeline
        "trace": res.trace,
    })


def decode_response(data) -> QueryResponse:
    t = decode_tree(data)
    tables = {name: TableResult(found=d["found"], payloads=d["payloads"],
                                values=d["values"])
              for name, d in t["tables"].items()}
    return QueryResponse(version=int(t["version"]), tables=tables,
                         qos=QoSClass.parse(t["qos"]),
                         latency_s=t["latency_s"],
                         batch_id=int(t["batch_id"]),
                         trace=t.get("trace"))


def encode_update(version: int, upserts: dict, deletes: dict) -> bytes:
    """Delta update as plain partitioned arrays — NOT an ``UpdateRequest``:
    a shard's partition may be empty (its rows all routed elsewhere), and
    the receiving shard-server turns an empty partition into a bare
    version bump (``StoreBackend.bump_version``) instead of an update."""
    return encode_tree({
        "version": int(version),
        "upserts": {name: [np.asarray(k, dtype=np.uint64),
                           np.asarray(r, dtype=np.uint8)]
                    for name, (k, r) in upserts.items()},
        "deletes": {name: np.asarray(k, dtype=np.uint64)
                    for name, k in deletes.items()},
    })


def decode_update(data) -> tuple[int, dict, dict]:
    t = decode_tree(data)
    upserts = {name: (k, r) for name, (k, r) in t["upserts"].items()}
    return int(t["version"]), upserts, t["deletes"]


# ---------------------------------------------------------------------------
# typed errors across the process boundary
# ---------------------------------------------------------------------------
# modules whose exception classes may cross the wire by name; resolved
# lazily so api/ never imports serve/ at module load (layering) while a
# shard's QueueFullError still re-raises typed on the router side.  The
# port's own modules only
_ERROR_SOURCES = ("builtins", "repro_torch.core.query_types",
                  "repro_torch.api.types", "repro_torch.serve.scheduler",
                  "repro_torch.serve.fabric")


def _error_class(name: str) -> Optional[type]:
    for modname in _ERROR_SOURCES:
        try:
            mod = importlib.import_module(modname)
        except ImportError:                       # pragma: no cover
            continue
        cls = getattr(mod, name, None)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            return cls
    return None


def encode_error(err: BaseException) -> bytes:
    # KeyError reprs its arg; unwrap so the message round-trips readable
    msg = err.args[0] if len(err.args) == 1 and \
        isinstance(err.args[0], str) else str(err)
    return encode_tree({"type": type(err).__name__, "message": msg})


def decode_error(data) -> BaseException:
    t = decode_tree(data)
    cls = _error_class(t["type"])
    if cls is None:
        return RuntimeError(f"{t['type']}: {t['message']}")
    try:
        return cls(t["message"])
    except Exception:                             # pragma: no cover
        return RuntimeError(f"{t['type']}: {t['message']}")


def encode_ok(info: Optional[dict] = None) -> bytes:
    return encode_tree(info or {})


def decode_ok(data) -> dict:
    return decode_tree(data)


def encode_stats(stats: Optional[dict] = None) -> bytes:
    """Observability scrape payload — a plain tree of stat-silo snapshots
    (``{"server": ..., "tiers": ...}`` in replies; ``{}`` as the request
    ping).  Kept as its own codec pair so the wire-coverage gate pins a
    stable shape for the stats RPC."""
    return encode_tree(stats or {})


def decode_stats(data) -> dict:
    return decode_tree(data)


# Message registry: every frame kind with its (encode, decode) pair.
# This is the protocol's single source of truth — a fabric dispatches by
# kind, and tests/test_torch_wire.py discovers its cases from it, so a new
# message type gets codec coverage the moment it is registered.
WIRE_MESSAGES = {
    KIND_QUERY: (encode_request, decode_request),
    KIND_UPDATE: (encode_update, decode_update),
    KIND_HEALTH: (encode_tree, decode_tree),
    KIND_SNAPSHOT: (encode_tree, decode_tree),
    KIND_SHUTDOWN: (encode_tree, decode_tree),
    KIND_STATS: (encode_stats, decode_stats),
    KIND_RESPONSE: (encode_response, decode_response),
    KIND_OK: (encode_ok, decode_ok),
    KIND_ERROR: (encode_error, decode_error),
}
