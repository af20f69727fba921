"""Hybrid hot/cold key-value store on top of NeighborHash (paper §2.1.2).

Layout is the paper's Figure 6, bit-faithful:

  - the *index* (key -> 52-bit payload) always lives in memory as a
    NeighborHash table;
  - payload bit 51 is the tier flag: 0 = hot (in-memory value region),
    1 = cold (NVMe value file);
  - payload bits 50..0 are the slot index in the owning tier;
  - hot slots carry LRU metadata, scanned by an asynchronous eviction pass
    (here: an explicit ``maintain()`` tick, optionally driven by a background
    thread) — queries never take a write lock, matching the paper's
    "storing both hot and cold keys in memory reduces concurrent read/write
    overhead ... compared to traditional LRU";
  - a cold miss performs exactly one NVMe IO, then (optionally) admits the
    value to the hot tier.

The cold tier is a real file on disk accessed through np.memmap — an honest
stand-in for NVMe on a host without one; tiering.DeviceCostModel
translates observed IO counts into modeled NVMe/DDR time for benchmarks.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import tempfile
import threading
import weakref
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import hashcore as hc
from repro_torch.core import neighborhash as nh
from repro_torch.core.tiering import TierStats

TIER_BIT = 51
TIER_MASK = 1 << TIER_BIT
SLOT_MASK = TIER_MASK - 1

# compaction generation filenames must be unique across EVERY store that
# shares a cold_dir — a clone chain shares its parent's dir, and a per-store
# counter would let a (retired) parent and its clone both mint
# "cold.gen1.bin" and truncate each other's live file.  A process-wide
# counter makes collisions impossible (itertools.count.__next__ is atomic
# under the GIL).
_cold_gen_counter = itertools.count(1)


class _ColdFile:
    """Refcounted handle on one generation of the cold value file.

    A store and every live ``clone()`` descended from it share the same
    file; compaction retires the writer's generation by swapping in a fresh
    file and dropping its ref.  The file is unlinked only when the LAST
    holder releases it — a retained old version (engine retention window)
    keeps serving its rows bitwise from the old generation until it is
    dropped, exactly the clone-chain lifecycle of delta publishing.  Each
    ``HybridKVStore`` holds exactly one ref, released by ``close()`` or by
    a GC finalizer when the store object dies."""

    def __init__(self, path: str):
        self.path = path
        self._refs = 1
        self._lock = threading.Lock()

    def incref(self) -> None:
        with self._lock:
            if self._refs <= 0:                       # pragma: no cover
                raise RuntimeError("cold file already released")
            self._refs += 1

    def decref(self) -> None:
        with self._lock:
            self._refs -= 1
            last = self._refs == 0
        if last:
            try:
                os.unlink(self.path)
            except OSError:                           # pragma: no cover
                pass   # caller-managed dir may already be gone

    @property
    def refs(self) -> int:
        with self._lock:
            return self._refs


class HybridKVStore:
    """Fixed-width-value KV store with a NeighborHash index and two value
    tiers.  Values are byte records of ``value_bytes`` each (an embedding row,
    a packed feature blob, ...)."""

    def __init__(
        self,
        keys: np.ndarray,
        values: np.ndarray,             # uint8 [n, value_bytes]
        *,
        hot_fraction: float = 0.1,
        hot_keys: Optional[np.ndarray] = None,
        load_factor: float = 0.8,
        cold_dir: Optional[str] = None,
        variant: str = "neighborhash",
        buckets_per_line: int = hc.CPU_BUCKETS_PER_LINE,
    ):
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values)
        if values.dtype != np.uint8 or values.ndim != 2:
            raise ValueError("values must be uint8 [n, value_bytes]")
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        self.n = len(keys)              # guarded-by: _lock
        self.value_bytes = values.shape[1]
        self._load_factor = load_factor
        self.stats = TierStats()        # guarded-by: _stats_lock

        # --- tier assignment: requested hot set, else the first fraction ---
        if hot_keys is not None:
            hot_mask = np.isin(keys, np.asarray(hot_keys, dtype=np.uint64))
        else:
            hot_mask = np.zeros(self.n, dtype=bool)
            hot_mask[: int(self.n * hot_fraction)] = True
        n_hot = int(hot_mask.sum())
        self.hot_capacity = max(n_hot, 1)

        # --- hot tier: value region + LRU metadata ---
        # (_hot_last_access is deliberately NOT guarded: the LRU touch in
        # get_batch is a benign racy write — a lost recency stamp costs at
        # worst one suboptimal eviction, never a torn value)
        self._hot_values = np.zeros((self.hot_capacity, self.value_bytes),
                                    dtype=np.uint8)  # guarded-by: _lock
        self._hot_last_access = np.zeros(self.hot_capacity, dtype=np.int64)
        self._hot_key = np.full(self.hot_capacity, hc.EMPTY_KEY,
                                dtype=np.uint64)     # guarded-by: _lock
        self._hot_free: list[int] = []               # guarded-by: _lock
        self._clock = 0                              # guarded-by: _stats_lock

        # --- cold tier: file-backed memmap (the "NVMe file") ---
        self._cold_dir = cold_dir or tempfile.mkdtemp(prefix="neighborkv_")
        self._cold_path = os.path.join(self._cold_dir,
                                       "cold.bin")    # guarded-by: _lock
        cold_rows = max(self.n, 1)
        self._cold = np.memmap(self._cold_path, dtype=np.uint8, mode="w+",
                               shape=(cold_rows,
                                      self.value_bytes))  # guarded-by: _lock
        # every record has a cold home slot (hot tier is a cache, like the
        # paper: eviction just flips the tier bit; no cold write needed if the
        # cold copy is current)
        self._cold[:] = values
        self._cold.flush()
        self._cold_handle = _ColdFile(self._cold_path)  # guarded-by: _lock
        # guarded-by: _lock
        self._cold_finalizer = weakref.finalize(self,
                                                self._cold_handle.decref)
        self.stats.cold_file_bytes = cold_rows * self.value_bytes

        # --- index: payload = tier bit + slot ---
        payloads = np.empty(self.n, dtype=np.uint64)
        hot_slot = 0
        for i in range(self.n):
            if hot_mask[i]:
                self._hot_values[hot_slot] = values[i]
                self._hot_key[hot_slot] = keys[i]
                payloads[i] = np.uint64(hot_slot)
                hot_slot += 1
            else:
                payloads[i] = np.uint64(TIER_MASK | i)
        # slots never occupied at build time (e.g. hot_fraction=0, where
        # hot_capacity is clamped to 1) must start on the free list or the
        # hot tier is permanently unusable — _admit would always bail
        self._hot_free = list(range(self.hot_capacity - 1, hot_slot - 1, -1))
        # guarded-by: _lock
        self._cold_slot_of_key_order = {int(k): i for i, k in enumerate(keys)}
        self.index = nh.build(keys, payloads, variant=variant,
                              load_factor=load_factor,
                              buckets_per_line=buckets_per_line)  # guarded-by: _lock
        self._lock = threading.Lock()   # update-path only; reads lock-free
        # seqlock for the lock-free read path: every tier-moving mutation
        # (_admit / eviction / value or index write) bumps this once on
        # entry and once on exit under _lock, so it is odd while arrays are
        # mid-mutation; get_batch retries its probe+gather when the counter
        # moved, instead of risking a torn payload read (e.g. a cold->hot
        # repoint seen half-written classifying a hot slot as a cold one)
        self._write_seq = 0             # guarded-by: _lock
        # counter updates from concurrent readers (QueryServer finish
        # workers) go through their own lock so they never contend with —
        # or get lost against — the long-held update-path _lock
        self._stats_lock = threading.Lock()
        # True once a clone() owns the writes; strict — the writability
        # check itself must run under the lock, or a clone() landing
        # between check and lock lets the retired parent keep writing
        # rows the clone serves from the shared cold file
        self._retired = False           # guarded-by: _lock (strict)
        # guards background-thread start/stop: start_async_* must be
        # idempotent under concurrent callers, and it must not ride the
        # update-path _lock (stop joins a loop that takes _lock)
        self._threads_lock = threading.Lock()
        self._evict_thread: Optional[threading.Thread] = None  # guarded-by: _threads_lock
        self._evict_stop = threading.Event()
        self._compact_thread: Optional[threading.Thread] = None  # guarded-by: _threads_lock
        self._compact_stop = threading.Event()
        # retunable at runtime (set_compaction_threshold): the async
        # compaction loop re-reads it each tick — a benign racy float,
        # each pass uses whichever value it observed
        self._compact_threshold = 0.3

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def get_batch(self, keys: Sequence[int], admit: bool = True
                  ) -> tuple[np.ndarray, np.ndarray]:
        """-> (found bool[n], values uint8[n, value_bytes]).

        One vectorized index probe over the whole batch
        (``NeighborHash.lookup_host_batch``, the numpy masked-advance loop);
        hot hits gather from memory; cold misses do one memmap IO each and
        are optionally admitted to the hot tier."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        with self._stats_lock:
            self._clock += 1
        # seqlock read: if a concurrent tier move (admission/eviction from
        # another reader's batch or the async eviction thread) bumps
        # _write_seq while we probe+gather, the payloads we classified may
        # be torn — retry, and serialize under the lock as a last resort
        for _ in range(8):
            seq0 = self._write_seq
            if seq0 & 1:
                continue
            found, out, cold, hot_slots = self._probe_and_gather(keys)
            if self._write_seq == seq0:
                break
        else:
            with self._lock:
                found, out, cold, hot_slots = self._probe_and_gather(keys)
        # LRU touch only AFTER the read validated: a discarded torn attempt
        # must leave no side effects, or a bogus recency stamp would keep
        # the wrong entry hot through the next eviction scan.  The array is
        # re-snapshotted and the slots re-clipped because set_hot_fraction
        # may have swapped in a shorter array since the gather; a stamp
        # landing in the superseded array is the same benign lost-touch
        # race the unguarded write already accepts
        if len(hot_slots):
            last_access = self._hot_last_access
            last_access[np.clip(hot_slots, 0,
                                last_access.shape[0] - 1)] = self._clock
        n_cold = int(cold.sum())
        n_hot = int(found.sum()) - n_cold
        with self._stats_lock:
            self.stats.lookups += len(keys)
            self.stats.not_found += int(len(keys) - found.sum())
            self.stats.cold_misses += n_cold
            self.stats.cold_bytes_read += n_cold * self.value_bytes
            self.stats.hot_hits += n_hot
            self.stats.hot_bytes_read += n_hot * self.value_bytes
        if admit and n_cold:
            # first-occurrence-ordered dedup: the same cold key twice in
            # one batch must queue ONE admission (a second _admit would pop
            # a second hot slot and orphan the first); _admit re-derives
            # the slot under the lock
            for k in dict.fromkeys(keys[cold].tolist()):
                self._admit(int(k))
        return found, out

    def _probe_and_gather(self, keys: np.ndarray       # seqlock-read
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        """One vectorized probe + tier-split gather (no stats, no
        admission, no LRU writes) — the seqlock-retryable section of
        get_batch.  Returns (found, rows, cold mask, hot slots); the
        caller applies the LRU touch only once the read proves stable."""
        # snapshot the swappable references ONCE: a concurrent compact()
        # replaces index + cold file together under the seqlock, so each
        # attempt must probe one index object and gather from one file
        # object — re-reading the attributes mid-attempt could clip slots
        # against the new (smaller) file after probing the old index and
        # step out of range before the seqlock check ever runs
        index = self.index
        cold_file = self._cold
        # the hot arrays are swappable too (set_hot_fraction resizes
        # them), so they get the same one-object-per-attempt treatment:
        # clip against the snapshotted array's own length, never against
        # self.hot_capacity, which may already describe the replacement
        hot_values = self._hot_values
        out = np.zeros((len(keys), self.value_bytes), dtype=np.uint8)
        found, payloads = index.lookup_host_batch(keys)
        cold = found & ((payloads & np.uint64(TIER_MASK)) != 0)
        hot = found & ~cold
        # slots are clipped (mirroring the device lookup's mode="clip"
        # takes): a torn payload read mid-mutation may carry an
        # out-of-range slot, and the gather must survive long enough for
        # the caller's seqlock check to discard and retry the batch
        hot_slots = np.empty(0, dtype=np.int64)
        if hot.any():
            hot_slots = np.clip(payloads[hot].astype(np.int64), 0,
                                hot_values.shape[0] - 1)
            out[hot] = hot_values[hot_slots]
        if cold.any():
            slots = np.clip(
                (payloads[cold] & np.uint64(SLOT_MASK)).astype(np.int64),
                0, cold_file.shape[0] - 1)
            out[cold] = cold_file[slots]            # the one NVMe IO per row
        return found, out, cold, hot_slots

    # ------------------------------------------------------------------
    # tier movement (update path — serialized, like the Update Subsystem)
    # ------------------------------------------------------------------
    def _admit(self, key: int):
        with self._lock:
            # re-check the payload tier under the lock: a concurrent admit
            # (or an earlier admission of the same key) may have already
            # moved it hot, and admitting twice would orphan a hot slot
            ok, payload, _, _ = self.index.probe_trace(key)
            if not ok or not (payload & TIER_MASK):
                return
            if not self._hot_free:
                return          # hot tier full: eviction pass will make room
            # closing bump in finally: an exception mid-write must not
            # leave the seqlock odd forever (which would silently demote
            # every future read to the serialized lock fallback)
            self._write_seq += 1
            try:
                cold_slot = int(payload & np.uint64(SLOT_MASK))
                hot_slot = self._hot_free.pop()
                self._hot_values[hot_slot] = self._cold[cold_slot]
                self._hot_key[hot_slot] = key
                self._hot_last_access[hot_slot] = self._clock
                self._set_payload(key, np.uint64(hot_slot))
                # counters live under _stats_lock (nested inside _lock,
                # the established order): a bare increment here would race
                # the reader-side stats writes in get_batch
                with self._stats_lock:
                    self.stats.admissions += 1
            finally:
                self._write_seq += 1

    def maintain(self, target_free_fraction: float = 0.05) -> int:
        """One asynchronous-eviction pass: scan LRU metadata of the hot tier
        and demote the stalest entries until ``target_free_fraction`` of hot
        slots are free.  Mirrors the paper's async scanning thread; queries
        racing with this pass still resolve correctly (they read either tier's
        consistent copy — the cold home slot always holds current data)."""
        with self._lock:
            want_free = int(self.hot_capacity * target_free_fraction)
            need = want_free - len(self._hot_free)
            if need <= 0:
                return 0
            occupied = np.flatnonzero(self._hot_key != np.uint64(hc.EMPTY_KEY))
            if len(occupied) == 0:
                return 0
            order = occupied[np.argsort(self._hot_last_access[occupied])]
            evicted = 0
            self._write_seq += 1
            try:
                for slot in order[:need]:
                    slot = int(slot)
                    key = int(self._hot_key[slot])
                    cold_slot = self._cold_slot_of_key_order[key]
                    # flip tier bit back to cold (cold copy is
                    # authoritative)
                    self._set_payload(key,
                                      np.uint64(TIER_MASK | cold_slot))
                    self._hot_key[slot] = hc.EMPTY_KEY
                    self._hot_free.append(slot)
                    evicted += 1
                    with self._stats_lock:
                        self.stats.evictions += 1
            finally:
                self._write_seq += 1
            return evicted

    def start_async_eviction(self, period_s: float = 0.01):
        """Start the background eviction thread.  Idempotent: a second
        call while the thread is running is a no-op (the running thread
        keeps its period) — starting twice used to orphan the first
        daemon loop, and the two then raced on the shared ``_evict_stop``
        event (one ``stop`` would half-kill the pair)."""
        def loop():
            while not self._evict_stop.wait(period_s):
                self.maintain()
        with self._threads_lock:
            if self._evict_thread is not None:
                return
            self._evict_stop.clear()
            self._evict_thread = threading.Thread(
                target=loop, name="kv-evict", daemon=True)
            self._evict_thread.start()

    def stop_async_eviction(self):
        with self._threads_lock:
            thread = self._evict_thread
            if thread is None:
                return
            self._evict_stop.set()
            thread.join()
            self._evict_thread = None
            self._evict_stop.clear()

    # ------------------------------------------------------------------
    # cold-store compaction (background garbage reclamation)
    # ------------------------------------------------------------------
    def _garbage_state(self) -> tuple[int, int]:
        """``(garbage_bytes, cold_file_bytes)`` as one atomic pair.  Both
        counters move together under ``_stats_lock`` (a COW supersede
        adds garbage, a grow or compact resizes the file); readers that
        divide one by the other must snapshot them together or a torn
        pair yields a fraction that never existed."""
        with self._stats_lock:
            return self.stats.garbage_bytes, self.stats.cold_file_bytes

    def stats_snapshot(self) -> TierStats:
        """A consistent copy of the tier counters for observability
        bridges/scrapes — every field read under ``_stats_lock`` as one
        atomic snapshot (a scrape must never see a torn hit/lookup or
        garbage/file pair)."""
        with self._stats_lock:
            return dataclasses.replace(self.stats)

    @property
    def garbage_fraction(self) -> float:
        """Fraction of the cold file holding superseded/orphaned rows."""
        garbage, total = self._garbage_state()
        return garbage / total if total else 0.0

    def compact(self, *, min_garbage_fraction: float = 0.0) -> dict:
        """One compaction pass: rewrite every LIVE cold row into a fresh
        file, remap the cold home slots, and atomically swap file + index
        under the seqlock, so concurrent ``get_batch`` readers see either
        the old generation or the new one — never a torn mix.

        Skips (returns ``{"skipped": True, ...}``) while the garbage
        fraction is below ``min_garbage_fraction`` — the threshold form the
        async thread and ``StoreBackend.apply_update`` call on every tick.
        The retired generation's file is unlinked only once no live
        ``clone()`` still serves from it (refcounted ``_ColdFile``), so a
        retained old version keeps reading its rows bitwise.

        Reads never block: the rewrite happens into a file invisible to
        readers, and only the final pointer swap sits inside the seqlock's
        odd window.  Writers (``upsert_batch``/``delete_batch``/``_admit``/
        ``maintain``) serialize with the pass on the update lock."""
        with self._lock:
            # (garbage, size) snapshotted as one pair under the stats
            # lock: the threshold decision must come from a consistent
            # fraction, not a garbage count paired with a file size from
            # a different instant (see _garbage_state)
            garbage, before_bytes = self._garbage_state()
            frac = garbage / before_bytes if before_bytes else 0.0
            if frac < min_garbage_fraction:
                return {"skipped": True, "garbage_fraction": frac,
                        "cold_file_bytes": before_bytes}
            # live rows, in old-slot order: the gather reads the old file
            # roughly sequentially and the new file is written as a stream
            live = sorted(self._cold_slot_of_key_order.items(),
                          key=lambda kv: kv[1])
            n_live = len(live)
            keys_arr = np.fromiter((k for k, _ in live), dtype=np.uint64,
                                   count=n_live)
            old_slots = np.fromiter((s for _, s in live), dtype=np.int64,
                                    count=n_live)
            new_path = os.path.join(
                self._cold_dir, f"cold.gen{next(_cold_gen_counter)}.bin")
            new_rows = max(n_live, 1)
            new_cold = np.memmap(new_path, dtype=np.uint8, mode="w+",
                                 shape=(new_rows, self.value_bytes))
            if n_live:
                new_cold[:n_live] = self._cold[old_slots]   # the rewrite IO
            new_cold.flush()
            # remap the index on a PRIVATE copy: cold-tier keys move to
            # their new slot (one vectorized update_batch pass); hot-tier
            # keys keep their hot slot and only the home-slot map changes.
            # Readers keep probing the old index object until the swap.
            new_index = self.index.copy()
            if n_live:
                found, payloads = new_index.lookup_host_batch(keys_arr)
                if not found.all():               # pragma: no cover
                    raise RuntimeError(
                        "cold home-slot map names a key the index lost — "
                        "store corrupted")
                cold_mask = (payloads & np.uint64(TIER_MASK)) != 0
                new_slots = np.arange(n_live, dtype=np.uint64)
                if cold_mask.any():
                    new_index.update_batch(
                        keys_arr[cold_mask],
                        np.uint64(TIER_MASK) | new_slots[cold_mask])
            new_map = {int(k): i for i, k in enumerate(keys_arr)}
            new_handle = _ColdFile(new_path)
            old_handle = self._cold_handle
            old_finalizer = self._cold_finalizer
            # the atomic swap: everything a reader dereferences flips
            # inside one seqlock odd window, and an attempt that straddled
            # it retries against the consistent new state
            self._write_seq += 1
            try:
                self.index = new_index
                self._cold = new_cold
                self._cold_path = new_path
                self._cold_handle = new_handle
                self._cold_slot_of_key_order = new_map
            finally:
                self._write_seq += 1
            self._cold_finalizer = weakref.finalize(self, new_handle.decref)
            # release OUR ref on the retired generation; clones still
            # serving from it keep the file alive
            old_finalizer.detach()
            old_handle.decref()
            reclaimed = before_bytes - new_rows * self.value_bytes
            with self._stats_lock:
                self.stats.garbage_bytes = 0
                self.stats.cold_file_bytes = new_rows * self.value_bytes
                self.stats.compactions += 1
                self.stats.compaction_rows_rewritten += n_live
                self.stats.compaction_bytes_reclaimed += max(reclaimed, 0)
            return {"skipped": False, "live_rows": n_live,
                    "reclaimed_bytes": max(reclaimed, 0),
                    "cold_file_bytes": new_rows * self.value_bytes,
                    "garbage_fraction_before": frac}

    # ------------------------------------------------------------------
    # runtime knobs (traffic/controller.py actuates these)
    # ------------------------------------------------------------------
    @property
    def compaction_threshold(self) -> float:
        return self._compact_threshold

    def set_compaction_threshold(self, threshold: float) -> None:
        """Retune the async-compaction trigger at runtime.  Validated like
        the ``start_async_compaction`` argument it replaces; the running
        loop picks the new value up on its next tick (benign racy float —
        a pass in flight finishes under the value it observed)."""
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"threshold must be in (0, 1], got {threshold}")
        self._compact_threshold = float(threshold)

    @property
    def hot_fraction(self) -> float:
        """Current hot-tier capacity as a fraction of the row count."""
        return self.hot_capacity / max(self.n, 1)

    def set_hot_fraction(self, fraction: float) -> dict:
        """Resize the hot tier to ``fraction`` of the current row count
        while serving.

        Runs under the update lock inside a seqlock odd window, like every
        other tier move: readers that gathered from the superseded arrays
        retry.  Growing allocates replacement arrays and extends the free
        list; shrinking first demotes every occupant above the new
        capacity exactly like ``maintain`` (flip the tier bit back to the
        cold home slot — the cold copy is authoritative, no data moves).
        Returns ``{"hot_capacity": ..., "evicted": ...}``."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        with self._lock:
            self._check_writable()
            new_cap = max(int(round(self.n * fraction)), 1)
            if new_cap == self.hot_capacity:
                return {"hot_capacity": new_cap, "evicted": 0}
            evicted = 0
            self._write_seq += 1
            try:
                if new_cap > self.hot_capacity:
                    grow = new_cap - self.hot_capacity
                    self._hot_values = np.vstack(
                        [self._hot_values,
                         np.zeros((grow, self.value_bytes), dtype=np.uint8)])
                    self._hot_last_access = np.concatenate(
                        [self._hot_last_access,
                         np.zeros(grow, dtype=np.int64)])
                    self._hot_key = np.concatenate(
                        [self._hot_key,
                         np.full(grow, hc.EMPTY_KEY, dtype=np.uint64)])
                    # new slots on top of the free list, highest first
                    # (matches the build-time free-list order)
                    self._hot_free.extend(
                        range(new_cap - 1, self.hot_capacity - 1, -1))
                else:
                    doomed = np.flatnonzero(
                        self._hot_key[new_cap:] != np.uint64(hc.EMPTY_KEY)
                    ) + new_cap
                    for slot in doomed:
                        key = int(self._hot_key[int(slot)])
                        cold_slot = self._cold_slot_of_key_order[key]
                        self._set_payload(
                            key, np.uint64(TIER_MASK | cold_slot))
                        evicted += 1
                        with self._stats_lock:
                            self.stats.evictions += 1
                    # fresh (copied) arrays, not views: an in-flight reader
                    # still holds the old full-size array and must keep
                    # seeing a self-consistent object until its seqlock
                    # check rejects the attempt
                    self._hot_values = self._hot_values[:new_cap].copy()
                    self._hot_last_access = \
                        self._hot_last_access[:new_cap].copy()
                    self._hot_key = self._hot_key[:new_cap].copy()
                    self._hot_free = [s for s in self._hot_free
                                      if s < new_cap]
                self.hot_capacity = new_cap
            finally:
                self._write_seq += 1
            return {"hot_capacity": new_cap, "evicted": evicted}

    def start_async_compaction(self, threshold: float = 0.3,
                               period_s: float = 0.01):
        """Background reclamation, modeled on the async-eviction thread:
        every ``period_s`` the garbage fraction is checked and a compaction
        pass runs once it reaches ``threshold``.  Queries keep flowing
        throughout (lock-free seqlock reads).  The threshold stays
        retunable while the thread runs (``set_compaction_threshold``) —
        the loop re-reads it every tick."""
        self.set_compaction_threshold(threshold)

        def loop():
            while not self._compact_stop.wait(period_s):
                # one atomic (garbage, size) snapshot: reading the two
                # counters independently could pair a fresh garbage_bytes
                # with a stale cold_file_bytes mid-supersede and trigger
                # (or skip) a pass on a fraction that never existed
                threshold_now = self._compact_threshold
                garbage, total = self._garbage_state()
                if total and garbage / total >= threshold_now:
                    self.compact(min_garbage_fraction=threshold_now)
        with self._threads_lock:
            if self._compact_thread is not None:
                return
            self._compact_stop.clear()
            self._compact_thread = threading.Thread(
                target=loop, name="kv-compact", daemon=True)
            self._compact_thread.start()

    def stop_async_compaction(self):
        with self._threads_lock:
            thread = self._compact_thread
            if thread is None:
                return
            self._compact_stop.set()
            thread.join()
            self._compact_thread = None
            self._compact_stop.clear()

    def close(self) -> None:
        """Stop background threads and release this store's ref on its
        cold-file generation (idempotent; GC does the same eventually via
        the finalizer).  The file disappears once the last holder in the
        clone chain lets go; reads after close() are undefined."""
        self.stop_async_eviction()
        self.stop_async_compaction()
        self._cold_finalizer()

    # ------------------------------------------------------------------
    # snapshot/restore (the fabric's spin-up-from-disk path)
    # ------------------------------------------------------------------
    SNAPSHOT_FORMAT = 1

    def save(self, path_prefix: str) -> None:
        """Serialize the whole store to three files —

          - ``<prefix>.npz``        hot tier + cold slot map + metadata
          - ``<prefix>.index.npz``  the NeighborHash index (HashTable.save)
          - ``<prefix>.cold.bin``   the cold value file, current generation,
                                    byte-for-byte

        — such that ``load`` serves every key bitwise identically,
        including tier placement (a key hot here is hot in the restored
        store) and the garbage accounting compaction runs on.  Taken
        under the update lock, so no upsert/delete/admission/compaction
        can tear the (index, hot arrays, cold file) triple mid-save."""
        prefix = os.fspath(path_prefix)
        with self._lock:
            self._cold.flush()
            self.index.save(prefix + ".index.npz")
            cold_tmp = prefix + ".cold.bin.tmp"
            shutil.copyfile(self._cold_path, cold_tmp)
            os.replace(cold_tmp, prefix + ".cold.bin")
            n_cold = len(self._cold_slot_of_key_order)
            cold_keys = np.fromiter(self._cold_slot_of_key_order.keys(),
                                    dtype=np.uint64, count=n_cold)
            cold_slots = np.fromiter(self._cold_slot_of_key_order.values(),
                                     dtype=np.int64, count=n_cold)
            with self._stats_lock:
                garbage_bytes = self.stats.garbage_bytes
                cold_file_bytes = self.stats.cold_file_bytes
            meta = {
                "format": self.SNAPSHOT_FORMAT,
                "n": self.n,
                "value_bytes": self.value_bytes,
                "load_factor": self._load_factor,
                "hot_capacity": self.hot_capacity,
                "clock": self._clock,
                "cold_rows": int(self._cold.shape[0]),
                # garbage carries across the snapshot: the cold file is
                # copied as-is, superseded rows included, and the restored
                # store is the writer that will eventually compact them
                "garbage_bytes": garbage_bytes,
                "cold_file_bytes": cold_file_bytes,
            }
            tmp = prefix + ".npz.tmp"
            with open(tmp, "wb") as f:
                np.savez(
                    f,
                    meta_json=np.frombuffer(
                        json.dumps(meta).encode("utf-8"), dtype=np.uint8),
                    hot_values=self._hot_values,
                    hot_last_access=self._hot_last_access,
                    hot_key=self._hot_key,
                    hot_free=np.asarray(self._hot_free, dtype=np.int64),
                    cold_keys=cold_keys,
                    cold_slots=cold_slots)
            os.replace(tmp, prefix + ".npz")

    @classmethod
    def load(cls, path_prefix: str, *,
             cold_dir: Optional[str] = None) -> "HybridKVStore":
        """Restore a store saved by ``save``.  The cold file is COPIED
        into a fresh working dir (or ``cold_dir``): the snapshot on disk
        stays immutable — many replicas may restore from it concurrently,
        and the restored store's writes/compactions must never touch it."""
        prefix = os.fspath(path_prefix)
        with np.load(prefix + ".npz", allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
            if meta.get("format") != cls.SNAPSHOT_FORMAT:
                raise ValueError(f"unsupported store snapshot format "
                                 f"{meta.get('format')!r} at {prefix}")
            new = object.__new__(cls)
            new.n = int(meta["n"])
            new.value_bytes = int(meta["value_bytes"])
            new._load_factor = float(meta["load_factor"])
            new.stats = TierStats(
                garbage_bytes=int(meta["garbage_bytes"]),
                cold_file_bytes=int(meta["cold_file_bytes"]))
            new.hot_capacity = int(meta["hot_capacity"])
            new._hot_values = z["hot_values"].copy()
            new._hot_last_access = z["hot_last_access"].copy()
            new._hot_key = z["hot_key"].copy()
            new._hot_free = [int(s) for s in z["hot_free"]]
            new._clock = int(meta["clock"])
            new._cold_slot_of_key_order = {
                int(k): int(s)
                for k, s in zip(z["cold_keys"], z["cold_slots"])}
        new.index = nh.HashTable.load(prefix + ".index.npz")
        new._cold_dir = cold_dir or tempfile.mkdtemp(prefix="neighborkv_")
        new._cold_path = os.path.join(new._cold_dir, "cold.bin")
        shutil.copyfile(prefix + ".cold.bin", new._cold_path)
        new._cold = np.memmap(new._cold_path, dtype=np.uint8, mode="r+",
                              shape=(int(meta["cold_rows"]),
                                     new.value_bytes))
        new._cold_handle = _ColdFile(new._cold_path)
        new._cold_finalizer = weakref.finalize(new, new._cold_handle.decref)
        new._lock = threading.Lock()
        new._stats_lock = threading.Lock()
        new._write_seq = 0
        new._retired = False
        new._threads_lock = threading.Lock()
        new._evict_thread = None
        new._evict_stop = threading.Event()
        new._compact_thread = None
        new._compact_stop = threading.Event()
        return new

    # ------------------------------------------------------------------
    def _set_payload(self, key: int, payload: np.uint64):  # lock-held: _lock
        self.index.update(key, int(payload))     # in-place, offset-preserving

    def _check_writable(self):                    # lock-held: _lock
        # must run under _lock: clone() flips _retired under the lock, so
        # an unlocked check could pass just before the flip and let the
        # retired parent write rows the clone now serves from the shared
        # cold file (check-then-act race)
        if self._retired:
            raise RuntimeError(
                "store was retired by clone(): the clone owns the write "
                "path now (writes here would corrupt rows the clone serves "
                "through the shared cold file)")

    def update_value(self, key: int, value: np.ndarray):
        """Update-path write: cold home slot is rewritten; a hot copy, if
        present, is refreshed in place (single-writer Update Subsystem)."""
        value = np.asarray(value, dtype=np.uint8)
        if value.shape != (self.value_bytes,):
            # a scalar or wrong-length value would silently broadcast over
            # the whole row — reject instead
            raise ValueError(
                f"value must have shape ({self.value_bytes},), "
                f"got {value.shape}")
        with self._lock:
            self._check_writable()
            ok, payload, _, _ = self.index.probe_trace(int(key))
            if not ok:
                raise KeyError(key)
            self._write_seq += 1
            try:
                cold_slot = self._cold_slot_of_key_order[int(key)]
                self._cold[cold_slot] = value
                if not (payload & TIER_MASK):
                    self._hot_values[int(payload)] = value
            finally:
                self._write_seq += 1

    # ------------------------------------------------------------------
    # incremental write path (Update Subsystem: delta publishing)
    # ------------------------------------------------------------------
    def upsert_batch(self, keys: Sequence[int], values: np.ndarray, *,
                     copy_on_write: bool = False) -> dict:
        """Batch upsert: update existing keys and ADD brand-new keys,
        extending the cold file and the NeighborHash index.

        ``copy_on_write=True`` never rewrites an existing cold row — updated
        values are appended to the cold file and the index repointed, so a
        ``clone()`` of this store taken before the upsert keeps serving its
        rows bitwise (the engine's delta-publish retention window).  The
        superseded rows await background compaction (``compact``).

        Duplicate keys within one batch are last-write-wins.  Returns
        ``{"inserted": ..., "updated": ..., "cold_rows_appended": ...}``.
        """
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        values = np.asarray(values, dtype=np.uint8)
        if values.ndim != 2 or values.shape != (len(keys), self.value_bytes):
            raise ValueError(
                f"values must be uint8 [{len(keys)}, {self.value_bytes}], "
                f"got {values.dtype} {values.shape}")
        with self._lock:
            # before the seqlock bump: a writability failure must raise
            # with the counter still even
            self._check_writable()
            self._write_seq += 1
            try:
                return self._upsert_locked(keys, values, copy_on_write)
            finally:
                # in finally: a mid-write exception (index growth failure,
                # cold-file IO error) must not leave the seqlock odd, which
                # would silently demote all future reads to the lock path
                self._write_seq += 1

    def _upsert_locked(self, keys: np.ndarray, values: np.ndarray,
                       copy_on_write: bool) -> dict:   # lock-held: _lock
        last = {int(k): i for i, k in enumerate(keys)}   # last-write-wins
        sel = sorted(last.values())
        # one vectorized probe over the batch (mirrors get_batch)
        f_sel, p_sel = self.index.lookup_host_batch(keys[sel])
        exists = {i: (int(p_sel[j]) if f_sel[j] else None)
                  for j, i in enumerate(sel)}
        rows_needed = int((~f_sel).sum())
        if copy_on_write:
            rows_needed += int(f_sel.sum())
        next_slot = self._grow_cold(rows_needed)
        inserted = updated = 0
        new_entries: list[tuple[int, int]] = []
        for i in sel:
            k, v, payload = int(keys[i]), values[i], exists[i]
            if payload is None:                          # brand-new key
                self._cold[next_slot] = v
                self._cold_slot_of_key_order[k] = next_slot
                new_entries.append((k, TIER_MASK | next_slot))
                next_slot += 1
                self.n += 1
                inserted += 1
            elif copy_on_write:
                # the superseded cold row is unreachable from THIS store's
                # view from here on (a retained clone may still serve it
                # from the shared file) — account it as garbage awaiting
                # the next compaction pass
                with self._stats_lock:
                    self.stats.garbage_bytes += self.value_bytes
                self._cold[next_slot] = v
                self._cold_slot_of_key_order[k] = next_slot
                if payload & TIER_MASK:
                    self.index.update(k, TIER_MASK | next_slot)
                else:
                    # hot copy (ours, freshly cloned) refreshed in
                    # place; the repointed cold slot above already holds
                    # the new value, so a later eviction flip to it
                    # stays consistent
                    self._hot_values[int(payload)] = v
                next_slot += 1
                updated += 1
            else:
                self._cold[self._cold_slot_of_key_order[k]] = v
                if not (payload & TIER_MASK):
                    self._hot_values[int(payload)] = v
                updated += 1
        if new_entries:
            # one apply_delta call: in-place while there is headroom,
            # at most ONE growth rebuild per batch (not per key);
            # assume_new — the probe above already proved these absent
            ks = np.array([k for k, _ in new_entries], dtype=np.uint64)
            ps = np.array([p for _, p in new_entries], dtype=np.uint64)
            self.index = nh.apply_delta(self.index, ks, ps,
                                        load_factor=self._load_factor,
                                        assume_new=True)
        return {"inserted": inserted, "updated": updated,
                "cold_rows_appended": rows_needed}

    def delete_batch(self, keys: Sequence[int]) -> int:
        """Remove keys from the index (hot slots are freed; cold rows are
        orphaned until compaction).  Returns the number removed."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        removed = 0
        with self._lock:
            self._check_writable()
            self._write_seq += 1
            try:
                for k in keys:
                    k = int(k)
                    ok, payload, _, _ = self.index.probe_trace(k)
                    if not ok:
                        continue
                    if not (payload & TIER_MASK):
                        slot = int(payload)
                        self._hot_key[slot] = hc.EMPTY_KEY
                        self._hot_free.append(slot)
                    try:
                        self.index.delete(k)
                    except nh.BuildError:    # coalesced-variant index
                        self.index = nh.apply_delta(
                            self.index, (), (),
                            np.array([k], dtype=np.uint64),
                            load_factor=self._load_factor)
                    # the key's cold home slot is orphaned in place —
                    # garbage until compaction rewrites the file
                    if self._cold_slot_of_key_order.pop(k, None) is not None:
                        with self._stats_lock:
                            self.stats.garbage_bytes += self.value_bytes
                    self.n -= 1
                    removed += 1
            finally:
                self._write_seq += 1
        return removed

    def clone(self, *, retire: bool = True) -> "HybridKVStore":
        """O(index + hot tier) snapshot sharing the cold file.  The clone
        may take ``upsert_batch(..., copy_on_write=True)`` / ``delete_batch``
        writes while this store keeps serving every row bitwise — the
        substrate of per-version embedding tables in delta publishing.

        Cloning RETIRES this store from the write path (further writes here
        raise): two writers allocating cold-file slots from divergent views
        of the shared file's end would corrupt each other's rows.  Reads,
        admissions, and evictions remain untouched — exactly the lifecycle
        of a retained previous version.

        ``retire=False`` defers the handover: the caller must invoke
        ``retire()`` once the clone's deltas all applied (engine.from_delta
        does this so a delta that fails mid-apply leaves the base build
        writable for a corrected retry instead of wedged)."""
        new = object.__new__(HybridKVStore)
        with self._lock:
            if self._retired:
                # a second clone would create two live writers sharing one
                # cold file — exactly the corruption retirement prevents
                raise RuntimeError(
                    "store already retired by a previous clone(); clone "
                    "the newest generation instead")
            # snapshot under the lock: a concurrent _admit / eviction pass
            # mutating hot arrays + index mid-copy would tear the snapshot
            # (index says hot slot S, but S's bytes/key/free-list state are
            # from before the admission)
            new.n = self.n
            new.value_bytes = self.value_bytes
            new._load_factor = self._load_factor
            # counters start fresh, but the garbage view carries over: the
            # superseded rows in the shared file are garbage from the
            # clone's perspective too, and the clone is the writer that
            # will eventually compact them away
            new.stats = TierStats(
                garbage_bytes=self.stats.garbage_bytes,
                cold_file_bytes=self.stats.cold_file_bytes)
            new.hot_capacity = self.hot_capacity
            new._hot_values = self._hot_values.copy()
            new._hot_last_access = self._hot_last_access.copy()
            new._hot_key = self._hot_key.copy()
            new._hot_free = list(self._hot_free)
            new._clock = self._clock
            new._cold_dir = self._cold_dir
            new._cold_path = self._cold_path
            new._cold = np.memmap(self._cold_path, dtype=np.uint8, mode="r+",
                                  shape=self._cold.shape)
            new._cold_slot_of_key_order = dict(self._cold_slot_of_key_order)
            # the clone's ref on the shared generation: the file outlives
            # whichever of parent/clone compacts or dies first
            new._cold_handle = self._cold_handle
            new._cold_handle.incref()
            new.index = self.index.copy()
            self._retired = retire        # single writer: the clone
        new._cold_finalizer = weakref.finalize(new, new._cold_handle.decref)
        new._lock = threading.Lock()
        new._stats_lock = threading.Lock()
        new._write_seq = 0
        new._retired = False
        new._threads_lock = threading.Lock()
        new._evict_thread = None
        new._evict_stop = threading.Event()
        new._compact_thread = None
        new._compact_stop = threading.Event()
        return new

    def retire(self) -> None:
        """Deferred half of ``clone(retire=False)``: hand the write path to
        the clone once its deltas are fully applied."""
        with self._lock:
            self._retired = True

    def _grow_cold(self, extra_rows: int) -> int:      # lock-held: _lock
        """Extend the cold file by ``extra_rows``; returns the first new
        slot.  Clones mapping the old (shorter) prefix stay valid — the file
        only ever grows and existing offsets never move."""
        old_rows = self._cold.shape[0]
        if extra_rows > 0:
            self._cold.flush()
            with open(self._cold_path, "r+b") as f:
                f.truncate((old_rows + extra_rows) * self.value_bytes)
            self._cold = np.memmap(
                self._cold_path, dtype=np.uint8, mode="r+",
                shape=(old_rows + extra_rows, self.value_bytes))
            with self._stats_lock:
                self.stats.cold_file_bytes = \
                    (old_rows + extra_rows) * self.value_bytes
        return old_rows

    def memory_bytes(self) -> dict:
        idx_bytes = self.index.capacity * 16
        if self.index.next_idx is not None:   # side offset array variants
            idx_bytes += self.index.next_idx.nbytes
        return {
            "index": idx_bytes,
            "hot_values": self._hot_values.nbytes,
            "hot_metadata": self._hot_last_access.nbytes + self._hot_key.nbytes,
            "resident_total": idx_bytes + self._hot_values.nbytes
            + self._hot_last_access.nbytes + self._hot_key.nbytes,
            "cold_file": self._cold.shape[0] * self.value_bytes,
            "cold_garbage": self.stats.garbage_bytes,
        }
