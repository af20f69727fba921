"""MultiTableEngine — the paper's fused, deduplicated batch query (Fig 2), on
the card.

A model request spans many tables at once: scalar attribute tables (key ->
52-bit payload) and embedding tables (key -> fixed-width value row, hot-only
or hybrid hot/cold).  The engine implements the cross-table pipeline:

  1. **Per-batch key deduplication** — request keys are zipfian, so a batch
     repeats hot keys many times.  Each table's keys are uniqued once on the
     host; the device probes only unique keys and results are reconstructed
     by an inverse gather.
  2. **Cross-table coalescing** — every scalar table shares one engine-level
     shard layout; all tables' sub-queries for a shard go down in ONE grouped
     kernel launch, which finds each query's table in a device array of
     table descriptors (kernels/neighbor_lookup.py).  A shard whose tables
     fit in shared memory launches ``probe_smem``, any other ``probe_lines``.
  3. **Double-buffered pipeline** — ``begin`` stages the batch on the host
     and enqueues its copies and launches on the engine's CUDA stream;
     ``finish`` waits on that batch's event (not the device), so
     ``query_stream`` stages batch i+1 while the card resolves batch i.
  4. **Strong-version pinning, once** — a publish builds a whole new fused
     table set; a retention window (core/versioning.VersionWindow) keeps the
     previous build alive so in-flight batches never mix versions, and a
     request pinned to an evicted version gets the protocol NACK + re-pin.

Each scalar table lives on the card once, line-packed (8 buckets per 128 B
line).  Embedding tables resolve on the host through
core/hybrid_store.HybridKVStore (dedup also dedups NVMe IO).  With
``device="cpu"`` the same pipeline runs the plain probe of kernels/ref.py.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import hashcore as hc
from repro_torch.core import lookup as lk
from repro_torch.core import neighborhash as nh
from repro_torch.core.hybrid_store import HybridKVStore
from repro_torch.core.query_types import (EmbeddingTable,  # noqa: F401
                                          QueryResult, ScalarTable,
                                          TableResult, VersionEvictedError)
from repro_torch.core.sharding import ShardPlan, TableSpec, plan_shards
from repro_torch.core.versioning import VersionWindow
from repro_torch.kernels import neighbor_lookup as nl
from repro_torch.kernels import ops


@dataclasses.dataclass
class EngineStats:
    batches: int = 0
    keys_requested: int = 0       # sum over tables of raw request keys
    keys_deviceside: int = 0      # after dedup (what shards actually probe)
    hits: int = 0
    launches: int = 0             # grouped kernel launches (one per shard hit)
    repins: int = 0               # NACK -> re-pin events
    delta_publishes: int = 0      # publish_delta calls
    shards_copied: int = 0        # copy-on-write shard rebuilds across deltas
    shards_shared: int = 0        # shards whose tensors were shared across deltas
    versions_served: set = dataclasses.field(default_factory=set)

    @property
    def dedup_rate(self) -> float:
        """Fraction of requested keys eliminated before the device."""
        if not self.keys_requested:
            return 0.0
        return 1.0 - self.keys_deviceside / self.keys_requested


def _device_table(tbl: nh.HashTable, device: torch.device) -> nl.DeviceTable:
    """A built table on the card, with its probe statics."""
    st = lk.probe_statics(tbl)
    return nl.device_table(
        tbl.device_arrays(), capacity=tbl.capacity,
        home_capacity=tbl.home_capacity, host_check=st["host_check"],
        max_probes=st["max_probes"], device=device)


def _uploaded(device: torch.device) -> None:
    """Wait for a build's uploads: batches read its tensors on another
    stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# ---------------------------------------------------------------------------
# one published version: fused shard layout + stores
# ---------------------------------------------------------------------------
class _FusedBuild:
    """All tables of one version, built onto one engine-level shard plan."""

    def __init__(self, scalars: Sequence[ScalarTable],
                 embeddings: Sequence[EmbeddingTable], *,
                 max_shard_bytes: int, buckets_per_line: int,
                 device: torch.device):
        self.device = device
        self.scalar_names = [t.name for t in scalars]
        self.scalar_index = {t.name: i for i, t in enumerate(scalars)}
        # kinds live on the build, not the engine: retained older builds
        # stay queryable under THEIR table sets during a rollout
        self.table_kinds = {t.name: "scalar" for t in scalars}
        self.table_kinds.update({t.name: "embedding" for t in embeddings})
        total_rows = sum(len(t.keys) for t in scalars)
        spec = TableSpec(name="fused-scalars", n_rows=max(total_rows, 1),
                         bytes_per_row=16)
        self.plan: ShardPlan = plan_shards(spec, max_shard_bytes)
        n_shards = self.plan.n_shards

        # per shard, per scalar table: a NeighborHash over that table's keys
        # owned by the shard (same hash routing for every table, so one
        # request partition serves all of them), and its copy on the device
        self.shard_tables: list[list[nh.HashTable]] = [
            [] for _ in range(n_shards)]
        self.shard_device: list[list[nl.DeviceTable]] = [
            [] for _ in range(n_shards)]
        for t in scalars:
            keys = np.asarray(t.keys, dtype=np.uint64)
            payloads = np.asarray(t.payloads, dtype=np.uint64)
            for s, rows in enumerate(self.plan.partition(keys)):
                tbl = nh.build_grow(keys[rows], payloads[rows],
                                    variant=t.variant,
                                    load_factor=t.load_factor,
                                    buckets_per_line=buckets_per_line)
                self.shard_tables[s].append(tbl)
                self.shard_device[s].append(_device_table(tbl, device))
        self.groups = [self._make_group(s) for s in range(n_shards)]
        _uploaded(device)
        self.shards_copied = 0
        self.shards_shared = 0

        self.stores: dict[str, HybridKVStore] = {}
        for t in embeddings:
            self.stores[t.name] = HybridKVStore(
                np.asarray(t.keys, dtype=np.uint64),
                np.asarray(t.values, dtype=np.uint8),
                hot_fraction=t.hot_fraction, variant=t.variant)

    def _make_group(self, shard: int) -> Optional[nl.TableGroup]:
        """The descriptor group of one shard's grouped launch (None when
        the build has no scalar tables)."""
        tables = self.shard_device[shard]
        return nl.TableGroup(tables) if tables else None

    # ------------------------------------------------------------------
    @classmethod
    def from_delta(cls, prev: "_FusedBuild",
                   upserts: dict, deletes: dict) -> "_FusedBuild":
        """Copy-on-write build: only the shards a delta touches get new
        tables, device tensors and descriptor groups; everything else is
        shared with ``prev``, so retaining both versions costs O(delta), not
        O(rows).

        ``upserts[name]`` is ``(keys, payloads)`` for scalar tables or
        ``(keys, value_rows)`` for embedding tables; ``deletes[name]`` is a
        key array.  Upserts apply before deletes."""
        self = cls.__new__(cls)
        self.device = prev.device
        self.scalar_names = prev.scalar_names
        self.scalar_index = prev.scalar_index
        self.table_kinds = dict(prev.table_kinds)
        self.plan = prev.plan
        n_shards = prev.n_shards
        self.shard_tables = [list(ts) for ts in prev.shard_tables]
        self.shard_device = [list(d) for d in prev.shard_device]
        self.stores = dict(prev.stores)

        for name in set(upserts) | set(deletes):
            if name not in self.table_kinds:
                raise KeyError(
                    f"unknown table {name!r}; a delta must target the "
                    f"previous build's tables {sorted(self.table_kinds)}")

        # route the delta: per touched shard, the list of (table, keys)
        # pieces it owns — shards are independent, so they build in parallel
        shard_work: dict[int, list[tuple]] = {}
        for name in sorted(set(upserts) | set(deletes)):
            if self.table_kinds[name] != "scalar":
                continue
            bi = self.scalar_index[name]
            uk, up = upserts.get(name, ((), ()))
            uk = np.asarray(uk, dtype=np.uint64).ravel()
            up = np.asarray(up, dtype=np.uint64).ravel()
            dk = np.asarray(deletes.get(name, ()),
                            dtype=np.uint64).ravel()
            u_owner = self.plan.shard_of_np(uk)
            d_owner = self.plan.shard_of_np(dk)
            for s in range(n_shards):
                ku, pu = uk[u_owner == s], up[u_owner == s]
                kd = dk[d_owner == s]
                if not len(ku) and not len(kd):
                    continue
                shard_work.setdefault(s, []).append((bi, ku, pu, kd))

        def build_shard(s: int) -> tuple[int, list[tuple]]:
            out = []
            for bi, ku, pu, kd in shard_work[s]:
                tbl = nh.apply_delta(prev.shard_tables[s][bi], ku, pu, kd,
                                     copy=True)
                out.append((bi, tbl, _device_table(tbl, self.device)))
            return s, out

        # the per-shard capacity copies / uploads release the GIL and
        # overlap on the pool; the per-key insert loop inside apply_delta
        # does NOT, so threads only pay off when the copy side is
        # substantive — tiny shards convoy on the GIL and build faster
        # serially
        copy_bytes = sum(prev.shard_tables[s][bi].capacity * 16
                         for s, tasks in shard_work.items()
                         for bi, *_ in tasks)
        if len(shard_work) > 1 and \
                copy_bytes // len(shard_work) >= (1 << 20):
            # result adoption stays deterministic (each shard's output
            # lands in its own slot regardless of completion order)
            built = list(_shard_pool().map(build_shard, sorted(shard_work)))
        else:
            built = [build_shard(s) for s in sorted(shard_work)]
        for s, out in built:
            for bi, tbl, dev in out:
                self.shard_tables[s][bi] = tbl
                self.shard_device[s][bi] = dev
        touched = set(shard_work)
        # a touched shard's descriptors point at its new tensors; an
        # untouched shard keeps prev's group (and so its tensors) as is
        self.groups = [self._make_group(s) if s in touched
                       else prev.groups[s] for s in range(n_shards)]
        _uploaded(self.device)
        self.shards_copied = len(touched)
        self.shards_shared = n_shards - len(touched)

        cloned_parents = []
        for name in sorted(set(upserts) | set(deletes)):
            if self.table_kinds[name] != "embedding":
                continue
            parent = prev.stores[name]
            store = parent.clone(retire=False)
            if name in upserts:
                k, v = upserts[name]
                store.upsert_batch(k, v, copy_on_write=True)
            if name in deletes:
                store.delete_batch(deletes[name])
            self.stores[name] = store
            cloned_parents.append(parent)
        # hand over the write paths only now that EVERY table's delta
        # applied: a delta that raised above (bad dtype, growth failure)
        # leaves the base build's stores writable, so a corrected
        # publish_delta retry works instead of hitting retired stores
        for parent in cloned_parents:
            parent.retire()
        return self

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards


# ---------------------------------------------------------------------------
# staged batch (host work, overlappable with device lookups)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _StagedScalar:
    name: str
    build_index: int              # position in the build's scalar order
    n_request: int
    uniq_hi: np.ndarray
    uniq_lo: np.ndarray
    inverse: np.ndarray           # request position -> unique position
    owners: np.ndarray            # unique position -> shard
    shard_pos: list[np.ndarray]   # shard -> unique positions routed there


@dataclasses.dataclass
class _StagedEmbedding:
    name: str
    n_request: int
    uniq: np.ndarray
    inverse: np.ndarray


@dataclasses.dataclass
class _StagedBatch:
    version: int
    build: _FusedBuild
    scalars: list[_StagedScalar]
    embeddings: list[_StagedEmbedding]
    keys_requested: int
    keys_deviceside: int


@dataclasses.dataclass
class _InflightBatch:
    staged: _StagedBatch
    # shard -> (int32 [3, N] host tensor of the launch's uint32 words —
    # found, payload_hi, payload_lo — and its query segment offsets in build
    # order)
    device_out: dict[int, tuple[torch.Tensor, list[int]]]
    launches: int
    done: Optional[torch.cuda.Event]   # recorded after the copy-backs

    # the backend protocol's coalesce-stats face (api/backends.py): every
    # backend's inflight object exposes these three, so the server's stats
    # stay storage-agnostic
    @property
    def keys_requested(self) -> int:
        return self.staged.keys_requested

    @property
    def keys_deviceside(self) -> int:
        return self.staged.keys_deviceside


# shared executor for per-shard delta builds: publish_delta runs at rolling-
# update cadence (tens of ms), so paying pool spawn/teardown per delta would
# rival the O(delta) work the incremental path exists to minimize
_delta_pool: Optional[ThreadPoolExecutor] = None
_delta_pool_lock = threading.Lock()


def _shard_pool() -> ThreadPoolExecutor:
    global _delta_pool
    with _delta_pool_lock:
        if _delta_pool is None:
            _delta_pool = ThreadPoolExecutor(
                max_workers=os.cpu_count() or 1,
                thread_name_prefix="delta-shard")
        return _delta_pool


class MultiTableEngine:
    """N named tables behind one fused batch-query front end.

    ``publish`` installs a new version of every table atomically; queries are
    answered entirely from one retained version (strong-version pinning at
    the engine level — no per-table version bookkeeping anywhere else).
    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    ``device="cpu"`` runs the plain probe."""

    def __init__(self, scalars: Sequence[ScalarTable] = (),
                 embeddings: Sequence[EmbeddingTable] = (), *,
                 max_shard_bytes: int = 1 << 22, retain: int = 2,
                 buckets_per_line: int = hc.CPU_BUCKETS_PER_LINE,
                 version: int = 1, device=None):
        self.device = ops.resolve_device(device)
        # batches' copies and launches run here, off the default stream
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.max_shard_bytes = max_shard_bytes
        self.buckets_per_line = buckets_per_line
        self.window = VersionWindow(retain)
        self.stats = EngineStats()      # guarded-by: _stats_lock
        # concurrent _finish calls (server worker pool) update the shared
        # counters under this lock; query paths stay lock-free
        self._stats_lock = threading.Lock()
        # publishes serialize: publish_delta's read-prev -> build -> install
        # must be atomic, or two concurrent publishers would both clone the
        # same base build's stores (two live writers on one shared cold
        # file) and one delta would silently vanish
        self._publish_lock = threading.Lock()
        if scalars or embeddings:
            self.publish(version, scalars, embeddings)

    # ------------------------------------------------------------------
    # update subsystem face
    # ------------------------------------------------------------------
    def publish(self, version: int, scalars: Sequence[ScalarTable] = (),
                embeddings: Sequence[EmbeddingTable] = ()) -> None:
        """Build + install one consistent version of the full table set.
        The previous ``retain-1`` builds stay queryable, so batches pinned
        mid-rollout still succeed (paper Fig 7/8)."""
        with self._publish_lock:
            build = _FusedBuild(scalars, embeddings,
                                max_shard_bytes=self.max_shard_bytes,
                                buckets_per_line=self.buckets_per_line,
                                device=self.device)
            self.window.publish(version, build)

    def publish_delta(self, version: int,
                      upserts: Optional[dict] = None,
                      deletes: Optional[dict] = None) -> None:
        """Install ``version`` as an incremental delta on the latest build
        (paper Fig 2, the Update Subsystem's minute-level publish path).

        ``upserts`` maps table name to ``(keys, payloads)`` for scalar
        tables or ``(keys, uint8 value rows)`` for embedding tables (new
        keys extend the table); ``deletes`` maps table name to keys.
        Upserts apply before deletes.  Only the shards the delta touches
        are copy-on-written — untouched shards share device tensors and
        descriptor groups with the previous build, so retaining the old
        version for in-flight batches stays O(delta).  A batch pinned to
        the previous version keeps reading the old rows bitwise."""
        with self._publish_lock:
            ok, _, prev = self.window.get(None)
            if not ok:
                raise RuntimeError(
                    "publish_delta needs a published base version; call "
                    "publish() first")
            build = _FusedBuild.from_delta(prev, upserts or {},
                                           deletes or {})
            self.window.publish(version, build)
        with self._stats_lock:
            self.stats.delta_publishes += 1
            self.stats.shards_copied += build.shards_copied
            self.stats.shards_shared += build.shards_shared

    @property
    def versions(self) -> list[int]:
        return self.window.versions

    @property
    def latest_version(self) -> int:
        return self.window.latest

    @property
    def table_names(self) -> list[str]:
        """Tables of the latest published version."""
        ok, _, build = self.window.get(None)
        return sorted(build.table_kinds) if ok else []

    # ------------------------------------------------------------------
    # query pipeline stages
    # ------------------------------------------------------------------
    def _pin(self, version: Optional[int],
             strict: bool = False) -> tuple[int, _FusedBuild]:
        # the NACK -> re-pin handshake loops: between one get() and the
        # next, a fast concurrent publisher may evict the hinted version
        # again, so a single retry is not enough under serving load
        for _ in range(64):
            ok, v, build = self.window.get(version)
            if ok:
                return v, build
            if v < 0:
                raise RuntimeError("engine has no published version")
            if strict:
                raise VersionEvictedError(
                    f"version {version} not retained; have {self.versions}")
            # NACK: requested version evicted from the window — re-pin to
            # the newest retained version (protocol metadata in the reply)
            with self._stats_lock:
                self.stats.repins += 1
            version = v
        raise RuntimeError(
            "could not pin a version: publisher outran the re-pin loop")

    def _stage(self, request: dict[str, np.ndarray],
               version: Optional[int] = None,
               strict: bool = False) -> _StagedBatch:
        """Host half: dedup every table's keys, route uniques to shards."""
        v, build = self._pin(version, strict)
        scalars: list[_StagedScalar] = []
        embeddings: list[_StagedEmbedding] = []
        requested = deviceside = 0
        for name, keys in request.items():
            kind = build.table_kinds.get(name)
            if kind is None:
                raise KeyError(
                    f"unknown table {name!r}; version {v} serves "
                    f"{sorted(build.table_kinds)}")
            keys = np.asarray(keys, dtype=np.uint64).ravel()
            uniq, inverse = np.unique(keys, return_inverse=True)
            requested += len(keys)
            deviceside += len(uniq)
            if kind == "scalar":
                owners = build.plan.shard_of_np(uniq)
                shard_pos = [np.flatnonzero(owners == s)
                             for s in range(build.n_shards)]
                hi, lo = hc.key_split_np(uniq)
                scalars.append(_StagedScalar(
                    name=name, build_index=build.scalar_index[name],
                    n_request=len(keys), uniq_hi=hi, uniq_lo=lo,
                    inverse=inverse, owners=owners, shard_pos=shard_pos))
            else:
                embeddings.append(_StagedEmbedding(
                    name=name, n_request=len(keys), uniq=uniq,
                    inverse=inverse))
        return _StagedBatch(version=v, build=build, scalars=scalars,
                            embeddings=embeddings, keys_requested=requested,
                            keys_deviceside=deviceside)

    def _launch(self, staged: _StagedBatch) -> _InflightBatch:
        """Device half: one grouped launch per shard covering every scalar
        table with keys there, its results copied back to pinned host
        memory.  Returns without blocking on either."""
        build = staged.build
        device_out: dict[int, tuple[torch.Tensor, list[int]]] = {}
        launches = 0
        by_build_idx = {st.build_index: st for st in staged.scalars}
        cuda = self._stream is not None
        with torch.cuda.stream(self._stream):     # a no-op on the CPU
            for s in range(build.n_shards):
                if not any(len(st.shard_pos[s]) for st in staged.scalars):
                    continue
                # segments in the build's scalar order (the descriptor
                # order); a table the request didn't touch gets an empty
                # segment, so a subset (or reordered) request never
                # misindexes the outputs
                seg, his, los = [0], [], []
                for bi in range(len(build.scalar_names)):
                    st = by_build_idx.get(bi)
                    pos = st.shard_pos[s] if st is not None else ()
                    if len(pos):
                        his.append(st.uniq_hi[pos])
                        los.append(st.uniq_lo[pos])
                    seg.append(seg[-1] + len(pos))
                q = nl.to_device(np.stack([np.concatenate(his),
                                           np.concatenate(los)]),
                                 self.device)
                out = ops.probe_group(build.groups[s], q[0], q[1], seg)
                out = out.view(torch.int32)     # copies move int32 words
                if cuda:
                    host = torch.empty(out.shape, dtype=torch.int32,
                                       pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    out = host
                device_out[s] = (out, seg)
                launches += 1
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record(self._stream)
        return _InflightBatch(staged=staged, device_out=device_out,
                              launches=launches, done=done)

    def _finish(self, inflight: _InflightBatch) -> QueryResult:
        """Wait for the batch's copy-backs; inverse-gather back to request
        order; resolve embedding tables through their hybrid stores."""
        staged = inflight.staged
        build = staged.build
        # the embedding tables resolve on the host while the card works
        emb_results = {}
        for se in staged.embeddings:
            store = build.stores[se.name]
            found_u, vals_u = store.get_batch(se.uniq)
            emb_results[se.name] = TableResult(found=found_u[se.inverse],
                                               values=vals_u[se.inverse])
        if inflight.done is not None:
            inflight.done.synchronize()
        tables: dict[str, TableResult] = {}
        hits = 0
        for st in staged.scalars:
            found_u = np.zeros(st.owners.shape[0], dtype=bool)
            payload_u = np.zeros(st.owners.shape[0], dtype=np.uint64)
            for s, (out, seg) in inflight.device_out.items():
                pos = st.shard_pos[s]
                if not len(pos):
                    continue
                a = seg[st.build_index]
                res = out[:, a:a + len(pos)].numpy().view(np.uint32)
                found_u[pos] = res[0].astype(bool)
                payload_u[pos] = (res[1].astype(np.uint64) << np.uint64(32)) \
                    | res[2].astype(np.uint64)
            found = found_u[st.inverse]
            payloads = payload_u[st.inverse]
            hits += int(found.sum())
            tables[st.name] = TableResult(found=found, payloads=payloads)
        for name, res in emb_results.items():
            hits += int(res.found.sum())
            tables[name] = res
        with self._stats_lock:
            self.stats.batches += 1
            self.stats.keys_requested += staged.keys_requested
            self.stats.keys_deviceside += staged.keys_deviceside
            self.stats.hits += hits
            self.stats.launches += inflight.launches
            self.stats.versions_served.add(staged.version)
        return QueryResult(version=staged.version, tables=tables)

    # ------------------------------------------------------------------
    # public query faces
    # ------------------------------------------------------------------
    def query(self, request: dict[str, np.ndarray],
              version: Optional[int] = None,
              strict: bool = False) -> QueryResult:
        """One fused batch query: ``{table_name: keys}`` -> per-table
        results, all answered from a single pinned version.  ``strict=True``
        surfaces the NACK (VersionEvictedError) instead of re-pinning."""
        return self._finish(self._launch(
            self._stage(request, version, strict)))

    def begin(self, request: dict[str, np.ndarray],
              version: Optional[int] = None,
              strict: bool = False) -> _InflightBatch:
        """Split-phase face for serving pipelines: stage (host dedup + shard
        routing, pins the version for the batch's whole lifetime) and
        launch (copies and kernels enqueued on the engine's stream) WITHOUT
        blocking on results.  ``finish`` waits and scatters back.  The
        returned batch's build reference keeps its version's tables alive
        even if the window evicts it mid-flight."""
        return self._launch(self._stage(request, version, strict))

    def finish(self, inflight: _InflightBatch) -> QueryResult:
        """Second half of ``begin``: wait for this batch's event, inverse-
        gather to request order, resolve embedding tables.  Safe to call
        from a worker thread while another thread begins the next batch —
        that overlap is the server's double buffering."""
        return self._finish(inflight)

    def query_stream(self, requests: Iterable[dict[str, np.ndarray]],
                     version: Optional[int] = None
                     ) -> Iterator[QueryResult]:
        """Double-buffered pipeline: while the device resolves batch i, the
        host stages (dedups + routes) batch i+1.  Yields results in order."""
        it = iter(requests)
        try:
            first = next(it)
        except StopIteration:
            return
        inflight = self._launch(self._stage(first, version))
        for req in it:
            staged = self._stage(req, version)   # overlaps device batch i
            yield self._finish(inflight)
            inflight = self._launch(staged)
        yield self._finish(inflight)

    # ------------------------------------------------------------------
    def maintain(self) -> None:
        """Hybrid-store eviction tick for every embedding table of the
        latest version (the async Update Subsystem pass)."""
        ok, _, build = self.window.get(None)
        if ok:
            for store in build.stores.values():
                store.maintain()

    def compact(self, min_garbage_fraction: float = 0.3) -> dict:
        """Cold-store compaction tick for every embedding table of the
        latest version: copy-on-write delta publishes append superseded
        rows to the shared cold files, and this rewrites the live rows
        once a store's garbage fraction crosses the threshold.  Retained
        older versions keep serving bitwise from the retired generation
        (refcounted cold-file handles) until the window drops them.
        Returns ``{"stores_compacted": n, "reclaimed_bytes": total}``."""
        ok, _, build = self.window.get(None)
        compacted = reclaimed = 0
        if ok:
            for store in build.stores.values():
                r = store.compact(min_garbage_fraction=min_garbage_fraction)
                if not r.get("skipped"):
                    compacted += 1
                    reclaimed += r["reclaimed_bytes"]
        return {"stores_compacted": compacted, "reclaimed_bytes": reclaimed}
