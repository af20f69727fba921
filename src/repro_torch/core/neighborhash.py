"""Host-side builders for NeighborHash and its ablation family (paper §2.1).

The Update Subsystem (paper Fig 2) builds/compacts tables on the host; the hot
batch-lookup path runs on device (core/lookup.py, kernels/neighbor_lookup.py).
Insertion is deliberately allowed to be expensive — "query requests dominate
the workload of recommendation systems" (§2.1.1).

Variants (paper Table 3 ablation + Table 1 baselines):

    linear           classic linear probing (no chains)            [T1 baseline]
    coalesced        classic coalesced hashing with static cellar  [T1/T3]
    perfect_cellar   + lodger relocation (dynamic cellar)          [T3]
    linear_lodger    lodger relocation + unidirectional free-slot
                     search (the paper's "linear probing with
                     Lodger Relocation", APCL 1.24)                [T3 text]
    neighbor_probing + cacheline-aware bidirectional probing,
                     offsets in a side array                       [T3]
    neighborhash     + inline 12-bit offsets in the value word     [the paper]

All chained variants with lodger relocation share the invariant that every
chain is "home-pure": each chain contains exactly the records whose hash-home
is the chain head's bucket.  Classic coalesced hashing does not have this
invariant (chains coalesce), which is exactly why its APCL is worst.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np

from repro_torch.core import hashcore as hc

VARIANTS = (
    "linear",
    "coalesced",
    "perfect_cellar",
    "linear_lodger",
    "neighbor_probing",
    "neighborhash",
)

_CHAINED = {"coalesced", "perfect_cellar", "linear_lodger", "neighbor_probing",
            "neighborhash"}
_RELOCATING = {"perfect_cellar", "linear_lodger", "neighbor_probing",
               "neighborhash"}


class BuildError(RuntimeError):
    """Raised when a variant cannot place a record (e.g. no free bucket within
    the 12-bit offset range for the inline variant).  Callers grow capacity."""


@dataclasses.dataclass
class BuildStats:
    n: int = 0
    capacity: int = 0
    load_factor: float = 0.0
    max_chain_len: int = 1
    relocations: int = 0
    inserts: int = 0
    updates: int = 0
    deletes: int = 0
    build_seconds: float = 0.0


@dataclasses.dataclass
class HashTable:
    """A built table.  uint32 SoA layout (see hashcore docstring)."""

    variant: str
    capacity: int
    buckets_per_line: int
    key_hi: np.ndarray          # uint32[capacity]
    key_lo: np.ndarray          # uint32[capacity]
    val_hi: np.ndarray          # uint32[capacity]  (inline offset for neighborhash)
    val_lo: np.ndarray          # uint32[capacity]
    next_idx: Optional[np.ndarray]   # int32[capacity], -1 END; None if inline
    home_capacity: int          # hash range (== capacity except coalesced)
    stats: BuildStats
    _mut: Optional[object] = dataclasses.field(default=None, repr=False,
                                               compare=False)

    # ------------------------------------------------------------------
    @property
    def inline(self) -> bool:
        return self.next_idx is None

    def device_arrays(self) -> dict:
        """Arrays the device lookup consumes (host numpy; caller puts them)."""
        out = {
            "key_hi": self.key_hi,
            "key_lo": self.key_lo,
            "val_hi": self.val_hi,
            "val_lo": self.val_lo,
        }
        if self.next_idx is not None:
            out["next_idx"] = self.next_idx
        return out

    # ------------------------------------------------------------------
    # host-side reference lookup + exact probe accounting
    # ------------------------------------------------------------------
    def probe_trace(self, key: int) -> tuple[bool, int, list[int], list[int]]:
        """Returns (found, payload, visited bucket indices, next-pointer reads)
        for one key.  ``next_reads`` lists bucket indices whose chain pointer
        had to be consulted — relevant for APCL when pointers live in a
        separate offset array (the paper's NeighborProbing ablation)."""
        hi, lo = hc.key_split_int(int(key))
        j = hc.bucket_of_int(hi, lo, self.home_capacity)
        visited = [j]
        next_reads: list[int] = []
        if self.variant == "linear":
            idx = j
            for _ in range(self.capacity):
                khi, klo = int(self.key_hi[idx]), int(self.key_lo[idx])
                if khi == hc.EMPTY_HI and klo == hc.EMPTY_LO:
                    return False, 0, visited, next_reads
                if khi == hi and klo == lo:
                    payload, _ = hc.unpack_value_int(int(self.val_hi[idx]),
                                                     int(self.val_lo[idx]))
                    return True, payload, visited, next_reads
                idx = (idx + 1) % self.capacity
                visited.append(idx)
            return False, 0, visited, next_reads

        # chained variants
        khi, klo = int(self.key_hi[j]), int(self.key_lo[j])
        if khi == hc.EMPTY_HI and klo == hc.EMPTY_LO:
            return False, 0, visited, next_reads
        if self.variant in _RELOCATING:
            # home-pure chains: if the resident is a lodger there is no chain
            # rooted here.
            if hc.bucket_of_int(khi, klo, self.home_capacity) != j:
                return False, 0, visited, next_reads
        idx = j
        for _ in range(self.capacity + 1):
            khi, klo = int(self.key_hi[idx]), int(self.key_lo[idx])
            if khi == hi and klo == lo:
                payload, _ = hc.unpack_value_int(int(self.val_hi[idx]),
                                                 int(self.val_lo[idx]))
                return True, payload, visited, next_reads
            next_reads.append(idx)
            nxt = self._next_of(idx)
            if nxt < 0:
                return False, 0, visited, next_reads
            idx = nxt
            visited.append(idx)
        raise RuntimeError("cycle detected in chain")  # pragma: no cover

    def _next_of(self, idx: int) -> int:
        if self.next_idx is not None:
            return int(self.next_idx[idx])
        off = hc.decode_offset_int(
            (int(self.val_hi[idx]) >> hc.PAYLOAD_HI_BITS) & 0xFFF)
        return idx + off if off != 0 else -1

    def lookup_host(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        found = np.zeros(len(keys), dtype=bool)
        payloads = np.zeros(len(keys), dtype=np.uint64)
        for i, k in enumerate(keys):
            f, p, _, _ = self.probe_trace(int(k))
            found[i] = f
            payloads[i] = p
        return found, payloads

    def lookup_host_batch(self, keys: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized host-side batch probe — numpy analogue of the device
        lookup's masked-advance loop (core/lookup.lookup): the whole batch
        advances one probe step per iteration under an active-lane mask, so
        host probing costs O(max chain length) numpy passes instead of one
        Python probe loop per key.  Bit-identical to per-key
        ``probe_trace`` / ``lookup_host`` for every variant.

        One probe implementation serves both faces: this is
        ``locate_batch`` (the walk) plus a payload gather over the hit
        buckets."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        found, where = self.locate_batch(keys)
        payloads = np.zeros(len(keys), dtype=np.uint64)
        if found.any():
            idx = where[found]
            payloads[found] = hc.payload_np(self.val_hi[idx],
                                            self.val_lo[idx])
        return found, payloads

    def locate_batch(self, keys: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """THE vectorized masked-advance probe: ``(found bool[n], bucket
        int64[n])`` (bucket undefined where not found) — one numpy pass
        per probe step over the still-active lanes.  ``lookup_host_batch``
        is this walk plus a payload gather; ``update_batch`` and the
        hybrid store's compaction remap consume the bucket indices
        directly."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        n = len(keys)
        found = np.zeros(n, dtype=bool)
        where = np.zeros(n, dtype=np.int64)
        if n == 0:
            return found, where
        q_hi, q_lo = hc.key_split_np(keys)
        idx = hc.bucket_of_np(q_hi, q_lo, self.home_capacity)
        khi, klo = self.key_hi[idx], self.key_lo[idx]
        empty = (khi == np.uint32(hc.EMPTY_HI)) \
            & (klo == np.uint32(hc.EMPTY_LO))

        if self.variant == "linear":
            hit = ~empty & (khi == q_hi) & (klo == q_lo)
            found[hit] = True
            where[hit] = idx[hit]
            active = ~empty & ~hit
            for _ in range(self.capacity):
                if not active.any():
                    break
                idx[active] = (idx[active] + 1) % self.capacity
                khi, klo = self.key_hi[idx], self.key_lo[idx]
                empty = (khi == np.uint32(hc.EMPTY_HI)) \
                    & (klo == np.uint32(hc.EMPTY_LO))
                hit = active & ~empty & (khi == q_hi) & (klo == q_lo)
                found[hit] = True
                where[hit] = idx[hit]
                active = active & ~hit & ~empty
            return found, where

        active = ~empty
        if self.variant in _RELOCATING:
            rooted = hc.bucket_of_np(khi, klo, self.home_capacity) == idx
            active &= rooted
        hit = active & (khi == q_hi) & (klo == q_lo)
        found[hit] = True
        where[hit] = idx[hit]
        active = active & ~hit
        for _ in range(self.capacity + 1):
            if not active.any():
                break
            if self.next_idx is not None:
                nxt = self.next_idx[idx].astype(np.int64)
                has_next = nxt >= 0
            else:
                off = hc.decode_offset_np(self.val_hi[idx]).astype(np.int64)
                has_next = off != 0
                nxt = idx + off
            active = active & has_next
            # clip like the device lookup's mode="clip" takes: a torn
            # offset read (concurrent in-place mutation; the caller's
            # seqlock discards the batch) must not index out of range
            idx = np.clip(np.where(active, nxt, idx), 0, self.capacity - 1)
            khi, klo = self.key_hi[idx], self.key_lo[idx]
            hit = active & (khi == q_hi) & (klo == q_lo)
            found[hit] = True
            where[hit] = idx[hit]
            active = active & ~hit
        return found, where

    def update_batch(self, keys: np.ndarray, payloads: np.ndarray
                     ) -> np.ndarray:
        """Vectorized in-place payload update of every present key (absent
        keys are left alone; the returned bool mask says which landed).
        Semantically ``update`` per present key with last-write-wins on
        duplicates, but the probe is one ``locate_batch`` masked-advance
        pass and the writes are two fancy-index stores — no per-key Python
        loop.  Like ``update``, never relocates: safe on a table shared
        read-only with device lookups of the same version (inline chain
        offsets are preserved bit-exactly)."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        payloads = np.asarray(payloads, dtype=np.uint64).ravel()
        if keys.shape != payloads.shape:
            raise ValueError("keys/payloads must be equal-length")
        if np.any(payloads > np.uint64(hc.PAYLOAD_MASK)):
            raise ValueError("payload exceeds 52 bits")
        found, where = self.locate_batch(keys)
        if not found.any():
            return found
        idx = where[found]
        pay = payloads[found]
        # preserve the top 12 offset bits of val_hi (the inline chain link;
        # always zero for side-array variants) — only payload bits change.
        # Duplicate keys hit the same bucket: numpy fancy assignment keeps
        # the LAST occurrence, i.e. last-write-wins, same as the loop.
        keep = self.val_hi[idx] & np.uint32(0xFFF << hc.PAYLOAD_HI_BITS)
        self.val_hi[idx] = keep | (
            (pay >> np.uint64(32)).astype(np.uint32)
            & np.uint32(hc.PAYLOAD_HI_MASK))
        self.val_lo[idx] = (pay & np.uint64(hc.MASK32)).astype(np.uint32)
        self.stats.updates += int(found.sum())
        return found

    def apcl(self, keys: np.ndarray, buckets_per_line: Optional[int] = None,
             separate_offset_array: bool = False) -> float:
        """Average Probing Cache Lines over the given query keys (paper §3.1).

        Counts *distinct* lines touched per query, exactly (not sampled).
        ``separate_offset_array=True`` models the paper's NeighborProbing
        ablation where chain offsets live in a side int32 array: every
        next-pointer read charges a line of that array (16 int32 per 64 B
        line, scaled to ``buckets_per_line``)."""
        bpl = buckets_per_line or self.buckets_per_line
        # bytes per line = bpl * 16 (16-byte buckets); int32 entries per line:
        off_per_line = bpl * 4
        total = 0
        for k in keys:
            _, _, visited, next_reads = self.probe_trace(int(k))
            lines = {v // bpl for v in visited}
            if separate_offset_array and not self.inline:
                lines |= {("off", r // off_per_line) for r in next_reads}
            total += len(lines)
        return total / max(len(keys), 1)

    def max_probe_len(self) -> int:
        return self.stats.max_chain_len

    # ------------------------------------------------------------------
    # in-place mutation (the Update Subsystem's host-side write path)
    # ------------------------------------------------------------------
    def copy(self) -> "HashTable":
        """Deep copy of the SoA arrays + stats (copy-on-write deltas)."""
        return HashTable(
            variant=self.variant, capacity=self.capacity,
            buckets_per_line=self.buckets_per_line,
            key_hi=self.key_hi.copy(), key_lo=self.key_lo.copy(),
            val_hi=self.val_hi.copy(), val_lo=self.val_lo.copy(),
            next_idx=None if self.next_idx is None else self.next_idx.copy(),
            home_capacity=self.home_capacity,
            stats=dataclasses.replace(self.stats),
        )

    # ------------------------------------------------------------------
    # snapshot/restore (the fabric's spin-up-from-disk path)
    # ------------------------------------------------------------------
    SNAPSHOT_FORMAT = 1

    def save(self, path: str) -> str:
        """Serialize the table to one ``.npz``: the SoA arrays verbatim
        plus a JSON metadata record (variant, capacities, build stats —
        ``max_chain_len`` matters because the device lookup bakes
        ``max_probe_len()`` into its compiled program).  ``load`` restores
        a bitwise-identical table: every bucket, chain offset, and stats
        field round-trips exactly, so a replica restored from disk probes
        the same buckets in the same order as the builder that saved it.

        Writes ``<path>.tmp`` then renames: a crash mid-save never leaves
        a truncated file where a restoring replica would look.  Returns
        the final path (``.npz`` appended if missing)."""
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        meta = {
            "format": self.SNAPSHOT_FORMAT,
            "variant": self.variant,
            "capacity": self.capacity,
            "buckets_per_line": self.buckets_per_line,
            "home_capacity": self.home_capacity,
            "stats": dataclasses.asdict(self.stats),
        }
        arrays = {"key_hi": self.key_hi, "key_lo": self.key_lo,
                  "val_hi": self.val_hi, "val_lo": self.val_lo}
        if self.next_idx is not None:
            arrays["next_idx"] = self.next_idx
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta_json=np.frombuffer(
                json.dumps(meta).encode("utf-8"), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "HashTable":
        """Restore a table saved by ``save`` — bitwise identical arrays,
        stats, and variant config.  ``allow_pickle`` stays off: the file
        is arrays + JSON, never executable."""
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
            if meta.get("format") != cls.SNAPSHOT_FORMAT:
                raise ValueError(f"unsupported table snapshot format "
                                 f"{meta.get('format')!r} in {path}")
            if meta["variant"] not in VARIANTS:
                raise ValueError(f"unknown variant {meta['variant']!r} "
                                 f"in {path}")
            return cls(
                variant=meta["variant"],
                capacity=int(meta["capacity"]),
                buckets_per_line=int(meta["buckets_per_line"]),
                key_hi=z["key_hi"].copy(), key_lo=z["key_lo"].copy(),
                val_hi=z["val_hi"].copy(), val_lo=z["val_lo"].copy(),
                next_idx=(z["next_idx"].copy() if "next_idx" in z.files
                          else None),
                home_capacity=int(meta["home_capacity"]),
                stats=BuildStats(**meta["stats"]))

    def items_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Every resident (keys uint64, payloads uint64) — rebuild fodder."""
        occ = ~((self.key_hi == np.uint32(hc.EMPTY_HI))
                & (self.key_lo == np.uint32(hc.EMPTY_LO)))
        idx = np.flatnonzero(occ)
        keys = (self.key_hi[idx].astype(np.uint64) << np.uint64(32)) \
            | self.key_lo[idx].astype(np.uint64)
        return keys, hc.payload_np(self.val_hi[idx], self.val_lo[idx])

    def _ops(self) -> "_Builder":
        if self._mut is None:
            self._mut = _Builder.wrap(self)
        return self._mut

    def insert(self, key: int, payload: int) -> None:
        """In-place upsert (last-write-wins, exactly the builder's insert
        semantics).  Raises BuildError when the variant cannot place the
        record — callers fall back to ``build_grow`` (see ``apply_delta``)."""
        key, payload = int(key), int(payload)
        if key == hc.EMPTY_KEY:
            raise ValueError("EMPTY_KEY (2^64-1) is reserved")
        if payload & ~hc.PAYLOAD_MASK:
            raise ValueError("payload exceeds 52 bits")
        ops = self._ops()
        hi, lo = hc.key_split_int(key)
        home = hc.bucket_of_int(hi, lo, self.home_capacity)
        before = self.stats.inserts
        placed = ops.insert(hi, lo, payload, home)
        if self.stats.inserts != before:          # real insert, not update
            self.stats.n += 1
            self.stats.load_factor = self.stats.n / self.capacity
            if self.variant == "linear" and placed >= 0:
                # filling a gap can merge two occupied runs, lengthening the
                # probe bound past the new key's own PSL — rescan just the
                # run containing the placed slot (O(run), not O(capacity))
                self.stats.max_chain_len = max(
                    self.stats.max_chain_len,
                    ops._run_len_around(placed) + 1)

    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray,
                     *, assume_new: bool = False) -> int:
        """Vectorized mass upsert — ``apply_delta``'s brand-new-key path.

        Semantically equivalent to ``insert`` per key (last-write-wins on
        duplicate keys) but structured in phases so insert-heavy streaming
        deltas avoid per-key Python chain surgery:

        1. probe: one ``update_batch`` masked-advance pass rewrites keys
           already resident (skipped under ``assume_new``);
        2. mass placement: fresh keys whose home bucket is empty — the
           dominant case below the target load factor — land with a
           handful of fancy-index stores, one winner per contested home;
        3. chain append: leftovers are grouped by home bucket, each
           group's chain is walked to its tail once, and free slots come
           from a batch-wide sorted free-slot index (``searchsorted``)
           instead of a fresh occupancy-window scan per key.

        Lodger evictions, end-pointer variants, and linear probing keep
        the per-key path (their placement is inherently sequential).
        Chain variants are home-rooted, so an empty home proves the key
        absent — phase 2 cannot create duplicates even when
        ``assume_new`` is wrong, and phase 3's chain walk doubles as the
        membership check.  Raises ``BuildError`` exactly where ``insert``
        would (state stays a consistent prefix; callers fall back to
        ``build_grow``).  Returns the number of real inserts."""
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        payloads = np.asarray(payloads, dtype=np.uint64).ravel()
        if keys.shape != payloads.shape:
            raise ValueError("keys/payloads must be equal-length")
        if len(keys) == 0:
            return 0
        if np.any(keys == np.uint64(hc.EMPTY_KEY)):
            raise ValueError("EMPTY_KEY (2^64-1) is reserved")
        if np.any(payloads > np.uint64(hc.PAYLOAD_MASK)):
            raise ValueError("payload exceeds 52 bits")
        before = self.stats.inserts
        # last-write-wins dedup: np.unique keeps the FIRST occurrence, so
        # feed it the reversed array (first-in-reverse = last-in-delta)
        ridx = np.unique(keys[::-1], return_index=True)[1]
        sel = np.sort(np.int64(len(keys) - 1) - ridx)
        keys, payloads = keys[sel], payloads[sel]
        if not assume_new:
            updated = self.update_batch(keys, payloads)
            if updated.all():
                return 0
            keys, payloads = keys[~updated], payloads[~updated]
        if self.variant == "linear":
            # PSL-bound maintenance is per-run anyway; stats stay
            # consistent because insert() maintains n/load_factor itself
            for k, p in zip(keys, payloads):
                self.insert(int(k), int(p))
            return self.stats.inserts - before
        ops = self._ops()
        q_hi, q_lo = hc.key_split_np(keys)
        homes = hc.bucket_of_np(q_hi, q_lo,
                                self.home_capacity).astype(np.int64)
        # phase 2: mass placement into empty homes (offset code 0 = chain
        # end, so val_hi carries only the top payload bits)
        cand = np.flatnonzero(~ops.occ[homes])
        left = np.ones(len(keys), dtype=bool)
        if cand.size:
            win = cand[np.unique(homes[cand], return_index=True)[1]]
            idx = homes[win]
            pay = payloads[win]
            self.key_hi[idx] = q_hi[win]
            self.key_lo[idx] = q_lo[win]
            self.val_hi[idx] = ((pay >> np.uint64(32)).astype(np.uint32)
                                & np.uint32(hc.PAYLOAD_HI_MASK))
            self.val_lo[idx] = (pay & np.uint64(hc.MASK32)).astype(np.uint32)
            ops.occ[idx] = True
            self.stats.inserts += len(win)
            left[win] = False
        rest = np.flatnonzero(left)
        if rest.size:
            self._append_chains_batch(ops, payloads, q_hi, q_lo, homes, rest)
        gained = self.stats.inserts - before
        self.stats.n += gained
        self.stats.load_factor = self.stats.n / self.capacity
        return gained

    def _append_chains_batch(self, ops: "_Builder", payloads: np.ndarray,
                             q_hi: np.ndarray, q_lo: np.ndarray,
                             homes: np.ndarray, rest: np.ndarray) -> None:
        """``insert_batch`` phase 3: group leftovers by home bucket, walk
        each host chain once (upserting any key found en route), then link
        appendees to nearest free slots claimed from one sorted free-slot
        index shared across the whole batch."""
        per_key = self.variant in ("coalesced", "perfect_cellar",
                                   "linear_lodger")
        free_slots = np.flatnonzero(~ops.occ)
        free_taken = np.zeros(free_slots.size, dtype=bool)

        def claim_nearest(ref: int, lo: int, hi: int) -> int:
            """Nearest live free slot to ``ref`` inside ``[lo, hi]`` or -1.
            Lazily skips entries consumed since the index was built (the
            per-key fallback occupies slots without telling us)."""
            lo_i = int(np.searchsorted(free_slots, lo, side="left"))
            hi_i = int(np.searchsorted(free_slots, hi, side="right"))
            i = int(np.searchsorted(free_slots, ref))
            l, r = min(i - 1, hi_i - 1), max(i, lo_i)
            while l >= lo_i or r < hi_i:
                dl = ref - int(free_slots[l]) if l >= lo_i else -1
                dr = int(free_slots[r]) - ref if r < hi_i else -1
                if dr < 0 or (0 <= dl <= dr):
                    j, l = l, l - 1
                else:
                    j, r = r, r + 1
                s = int(free_slots[j])
                if not free_taken[j] and not ops.occ[s]:
                    free_taken[j] = True
                    return s
            return -1

        order = rest[np.argsort(homes[rest], kind="stable")]
        g = 0
        while g < len(order):
            h = int(homes[order[g]])
            e = g
            while e < len(order) and int(homes[order[e]]) == h:
                e += 1
            group = order[g:e]
            g = e
            if per_key or not ops.occ[h] \
                    or ops._home_of_resident(h) != h:
                # end-pointer/linear-scan variants and lodger evictions:
                # the per-key path does the full surgery
                for j in group:
                    ops.insert(int(q_hi[j]), int(q_lo[j]),
                               int(payloads[j]), h)
                continue
            # host chain: one walk both upserts any group key already on
            # the chain (home-purity: a resident key can live nowhere
            # else) and finds the tail to append the rest behind
            pending = {(int(q_hi[j]), int(q_lo[j])): int(payloads[j])
                       for j in group}
            idx, length = h, 1
            while True:
                hit = pending.pop((int(self.key_hi[idx]),
                                   int(self.key_lo[idx])), None)
                if hit is not None:
                    _, code = hc.unpack_value_int(int(self.val_hi[idx]),
                                                  int(self.val_lo[idx]))
                    vhi, vlo = hc.pack_value_int(
                        hit, code if self.inline else 0)
                    self.val_hi[idx] = vhi
                    self.val_lo[idx] = vlo
                    self.stats.updates += 1
                nxt = ops._next_of(idx)
                if nxt < 0:
                    break
                idx = nxt
                length += 1
            tail = idx
            for (kh, kl), pay in pending.items():
                if self.inline:
                    lo = max(0, tail + hc.OFFSET_MIN)
                    hi = min(self.capacity - 1, tail + hc.OFFSET_MAX)
                else:
                    lo, hi = 0, self.capacity - 1
                f = claim_nearest(tail, lo, hi)
                if f < 0:
                    if self.inline:
                        raise BuildError(
                            f"no free bucket within ±{hc.OFFSET_MAX} of "
                            f"{tail} (12-bit inline offset exhausted; "
                            f"grow the table)")
                    raise BuildError("table full (batched chain append)")
                ops._place(f, kh, kl, pay)
                ops._set_next(tail, f)
                tail = f
                length += 1
                self.stats.inserts += 1
                self.stats.max_chain_len = max(self.stats.max_chain_len,
                                               length)

    def update(self, key: int, payload: int) -> None:
        """Strict in-place payload update; KeyError if the key is absent.
        Never relocates, so it is safe on a table shared read-only with
        device lookups of the same version."""
        payload = int(payload)
        if payload & ~hc.PAYLOAD_MASK:
            raise ValueError("payload exceeds 52 bits")
        found, _, visited, _ = self.probe_trace(int(key))
        if not found:
            raise KeyError(key)
        idx = visited[-1]
        _, code = hc.unpack_value_int(int(self.val_hi[idx]),
                                      int(self.val_lo[idx]))
        vhi, vlo = hc.pack_value_int(payload, code if self.inline else 0)
        self.val_hi[idx] = vhi
        self.val_lo[idx] = vlo
        self.stats.updates += 1

    def delete(self, key: int) -> bool:
        """In-place removal; returns False if absent.  Relocating variants
        stay home-pure (the chain's tail record is pulled into the vacated
        slot, so every already-encoded offset remains valid); linear probing
        uses backward-shift deletion.  Classic coalesced chains are not
        home-pure and raise BuildError — ``apply_delta`` rebuilds instead."""
        key = int(key)
        if key == hc.EMPTY_KEY:
            return False
        ops = self._ops()
        hi, lo = hc.key_split_int(key)
        home = hc.bucket_of_int(hi, lo, self.home_capacity)
        removed = ops.delete(hi, lo, home)
        if removed:
            self.stats.n -= 1
            self.stats.load_factor = self.stats.n / self.capacity
            self.stats.deletes += 1
        return removed


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------
def build(
    keys: np.ndarray,
    payloads: np.ndarray,
    *,
    variant: str = "neighborhash",
    load_factor: float = 0.8,
    capacity: Optional[int] = None,
    buckets_per_line: int = hc.CPU_BUCKETS_PER_LINE,
    cellar_fraction: float = 0.14,
) -> HashTable:
    """Build a table of the given variant from unique uint64 keys + ≤52-bit
    payloads.  ``capacity`` overrides ``load_factor`` sizing when given."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    keys = np.asarray(keys, dtype=np.uint64)
    payloads = np.asarray(payloads, dtype=np.uint64)
    if keys.shape != payloads.shape or keys.ndim != 1:
        raise ValueError("keys/payloads must be equal-length 1-D arrays")
    n = len(keys)
    if capacity is None:
        capacity = max(int(np.ceil(n / load_factor)), 8)
    if n > capacity:
        raise ValueError("more keys than capacity")
    if np.any(payloads > np.uint64(hc.PAYLOAD_MASK)):
        raise ValueError("payload exceeds 52 bits")
    if np.any(keys == np.uint64(hc.EMPTY_KEY)):
        raise ValueError("EMPTY_KEY (2^64-1) is reserved")

    t0 = time.perf_counter()
    b = _Builder(variant, capacity, buckets_per_line, cellar_fraction)
    key_hi, key_lo = hc.key_split_np(keys)
    homes = hc.bucket_of_np(key_hi, key_lo, b.home_capacity)
    # Faithful to the paper's workload: records arrive in stream order (the
    # Update Subsystem applies them incrementally), NOT grouped by home —
    # grouping would artificially pack chains into single cachelines and
    # understate APCL.
    for i in range(n):
        b.insert(int(key_hi[i]), int(key_lo[i]), int(payloads[i]), int(homes[i]))
    table = b.finish()
    table.stats.build_seconds = time.perf_counter() - t0
    return table


class _Builder:
    def __init__(self, variant: str, capacity: int, buckets_per_line: int,
                 cellar_fraction: float):
        self.variant = variant
        self.capacity = capacity
        self.bpl = buckets_per_line
        if variant == "coalesced":
            # classic cellar: hash range excludes the cellar tail region
            self.home_capacity = max(int(capacity * (1.0 - cellar_fraction)), 1)
        else:
            self.home_capacity = capacity
        self.key_hi = np.full(capacity, hc.EMPTY_HI, dtype=np.uint32)
        self.key_lo = np.full(capacity, hc.EMPTY_LO, dtype=np.uint32)
        self.val_hi = np.zeros(capacity, dtype=np.uint32)
        self.val_lo = np.zeros(capacity, dtype=np.uint32)
        self.occ = np.zeros(capacity, dtype=bool)
        self.inline = variant == "neighborhash"
        self.next_idx = None if self.inline else np.full(capacity, -1,
                                                         dtype=np.int32)
        self.free_ptr = capacity - 1          # for end-pointer strategies
        self.stats = BuildStats(capacity=capacity)

    @classmethod
    def wrap(cls, table: HashTable) -> "_Builder":
        """Adopt a built table's arrays for in-place mutation (no copies:
        mutations through the returned ops are visible in ``table``)."""
        b = cls.__new__(cls)
        b.variant = table.variant
        b.capacity = table.capacity
        b.bpl = table.buckets_per_line
        b.home_capacity = table.home_capacity
        b.key_hi = table.key_hi
        b.key_lo = table.key_lo
        b.val_hi = table.val_hi
        b.val_lo = table.val_lo
        b.occ = ~((table.key_hi == np.uint32(hc.EMPTY_HI))
                  & (table.key_lo == np.uint32(hc.EMPTY_LO)))
        b.inline = table.inline
        b.next_idx = table.next_idx
        b.free_ptr = table.capacity - 1
        b.stats = table.stats                 # shared: counters stay in sync
        return b

    # -- primitive bucket ops ------------------------------------------------
    def _empty(self, idx: int) -> bool:
        return not self.occ[idx]

    def _place(self, idx: int, khi: int, klo: int, payload: int,
               offset_code: int = 0):
        vhi, vlo = hc.pack_value_int(payload, offset_code)
        self.key_hi[idx] = khi
        self.key_lo[idx] = klo
        self.val_hi[idx] = vhi
        self.val_lo[idx] = vlo
        self.occ[idx] = True

    def _clear(self, idx: int):
        self.key_hi[idx] = hc.EMPTY_HI
        self.key_lo[idx] = hc.EMPTY_LO
        self.val_hi[idx] = 0
        self.val_lo[idx] = 0
        self.occ[idx] = False
        if not self.inline:
            self.next_idx[idx] = -1
        if self.variant in ("coalesced", "perfect_cellar"):
            # freed slots above the end pointer become reusable again
            self.free_ptr = max(self.free_ptr, idx)

    def _set_next(self, idx: int, nxt: int):
        """Point idx's chain successor at nxt (or END when nxt < 0)."""
        if self.inline:
            payload, _ = hc.unpack_value_int(int(self.val_hi[idx]),
                                             int(self.val_lo[idx]))
            code = 0 if nxt < 0 else hc.encode_offset_int(nxt - idx)
            vhi, vlo = hc.pack_value_int(payload, code)
            self.val_hi[idx] = vhi
            self.val_lo[idx] = vlo
        else:
            self.next_idx[idx] = nxt

    def _next_of(self, idx: int) -> int:
        if self.inline:
            code = (int(self.val_hi[idx]) >> hc.PAYLOAD_HI_BITS) & 0xFFF
            off = hc.decode_offset_int(code)
            return idx + off if off != 0 else -1
        return int(self.next_idx[idx])

    def _home_of_resident(self, idx: int) -> int:
        return hc.bucket_of_int(int(self.key_hi[idx]), int(self.key_lo[idx]),
                                self.home_capacity)

    # -- free-slot search ----------------------------------------------------
    def _find_free_end_pointer(self) -> int:
        while self.free_ptr >= 0 and self.occ[self.free_ptr]:
            self.free_ptr -= 1
        if self.free_ptr < 0:
            raise BuildError("table full (end-pointer search)")
        return self.free_ptr

    def _find_free_linear(self, ref: int,
                          bounds: Optional[tuple[int, int]]) -> int:
        """Unidirectional upward scan from ref+1 (with wrap), chunked."""
        cap = self.capacity
        pos = ref + 1
        remaining = cap - 1
        while remaining > 0:
            chunk = min(256, remaining)
            if pos >= cap:
                pos -= cap
            hi = min(pos + chunk, cap)
            free = np.flatnonzero(~self.occ[pos:hi])
            for f in free:
                idx = pos + int(f)
                if bounds is None or (bounds[0] <= idx <= bounds[1]):
                    return idx
            remaining -= hi - pos
            pos = hi
        raise BuildError("table full (linear search)")

    def _find_free_neighbor(self, ref: int,
                            bounds: Optional[tuple[int, int]],
                            max_range: Optional[int]) -> int:
        """Cacheline-aware bidirectional nearest-free search around ``ref``
        (paper Fig 4): same line first, then nearest line outward, both
        directions; within a line, nearest bucket to ``ref``.

        ``bounds`` is an inclusive feasible interval (offset-encoding
        constraints, already intersected by the caller); ``max_range`` caps the
        search radius (±2047 for the inline variant)."""
        cap = self.capacity
        rng = max_range if max_range is not None else cap
        window = 2 * self.bpl                   # start: ref's line ± a line
        while True:
            window = min(window, rng)
            loh = max(0, ref - window)
            hih = min(cap, ref + window + 1)
            if bounds is not None:
                loh = max(loh, bounds[0])
                hih = min(hih, bounds[1] + 1)
            if hih > loh:
                free = np.flatnonzero(~self.occ[loh:hih])
                if free.size:
                    cand = free + loh
                    ref_line = ref // self.bpl
                    line_d = np.abs(cand // self.bpl - ref_line)
                    bucket_d = np.abs(cand - ref)
                    # lexicographic: line distance first, bucket distance next
                    best = np.lexsort((bucket_d, line_d))[0]
                    idx = int(cand[best])
                    # a nearer free bucket could lie just outside the current
                    # window only if the window didn't already reach the best
                    # candidate's line distance; grow once more if so.
                    if line_d[best] * self.bpl <= window or window >= rng:
                        return idx
            if window >= rng:
                if max_range is not None:
                    raise BuildError(
                        f"no free bucket within ±{rng} of {ref} "
                        f"(12-bit inline offset exhausted; grow the table)")
                raise BuildError("table full (neighbor search)")
            window = min(window * 4, rng)

    def _find_free(self, ref: int,
                   bounds: Optional[tuple[int, int]] = None) -> int:
        if self.variant in ("coalesced", "perfect_cellar"):
            idx = self._find_free_end_pointer()
            if bounds is not None and not (bounds[0] <= idx <= bounds[1]):
                raise BuildError("end-pointer slot violates offset constraint")
            return idx
        if self.variant == "linear_lodger":
            return self._find_free_linear(ref, bounds)
        max_range = hc.OFFSET_MAX if self.inline else None
        return self._find_free_neighbor(ref, bounds, max_range)

    # -- chain utilities -----------------------------------------------------
    def _chain_tail(self, head: int) -> tuple[int, int]:
        idx, length = head, 1
        while True:
            nxt = self._next_of(idx)
            if nxt < 0:
                return idx, length
            idx = nxt
            length += 1
            if length > self.capacity:       # pragma: no cover
                raise RuntimeError("cycle in chain")

    def _predecessor(self, node: int) -> int:
        """Chain predecessor of an occupied non-head node."""
        head = self._home_of_resident(node)
        idx = head
        while True:
            nxt = self._next_of(idx)
            if nxt == node:
                return idx
            if nxt < 0:                      # pragma: no cover
                raise RuntimeError("node not on its home chain")
            idx = nxt

    def _find_update(self, khi: int, klo: int, home: int) -> int:
        """Existing bucket index of key, or -1."""
        if self._empty(home):
            return -1
        if self.variant in _RELOCATING and self._home_of_resident(home) != home:
            return -1
        idx = home
        while idx >= 0:
            if int(self.key_hi[idx]) == khi and int(self.key_lo[idx]) == klo:
                return idx
            idx = self._next_of(idx)
        return -1

    # -- insert --------------------------------------------------------------
    def insert(self, khi: int, klo: int, payload: int, home: int) -> int:
        """For the linear variant returns the placed bucket index on a real
        insert (PSL-bound maintenance), -1 otherwise."""
        if self.variant == "linear":
            return self._insert_linear(khi, klo, payload, home)
        existing = self._find_update(khi, klo, home)
        if existing >= 0:
            # update-in-place (Update Subsystem semantics): keep chain intact
            _, code = hc.unpack_value_int(int(self.val_hi[existing]),
                                          int(self.val_lo[existing]))
            vhi, vlo = hc.pack_value_int(payload, code if self.inline else 0)
            self.val_hi[existing] = vhi
            self.val_lo[existing] = vlo
            if not self.inline:
                pass                       # next_idx untouched
            self.stats.updates += 1
            return -1
        if self.variant == "coalesced":
            self._insert_coalesced(khi, klo, payload, home)
        else:
            self._insert_relocating(khi, klo, payload, home)
        self.stats.inserts += 1
        return -1

    def _insert_linear(self, khi: int, klo: int, payload: int,
                       home: int) -> int:
        idx = home
        for _ in range(self.capacity):
            if self._empty(idx):
                self._place(idx, khi, klo, payload)
                self.stats.inserts += 1
                return idx
            if int(self.key_hi[idx]) == khi and int(self.key_lo[idx]) == klo:
                vhi, vlo = hc.pack_value_int(payload, 0)
                self.val_hi[idx] = vhi
                self.val_lo[idx] = vlo
                self.stats.updates += 1
                return -1
            idx = (idx + 1) % self.capacity
        raise BuildError("linear probing table full")

    def _run_len_around(self, idx: int) -> int:
        """Length of the contiguous occupied run containing ``idx``
        (wrap-aware) — O(run), for incremental linear PSL maintenance."""
        cap = self.capacity
        length, j = 1, (idx - 1) % cap
        while self.occ[j] and length < cap:
            length += 1
            j = (j - 1) % cap
        j = (idx + 1) % cap
        while self.occ[j] and length < cap:
            length += 1
            j = (j + 1) % cap
        return length

    def _insert_coalesced(self, khi: int, klo: int, payload: int, home: int):
        if self._empty(home):
            self._place(home, khi, klo, payload)
            return
        tail, length = self._chain_tail(home)
        f = self._find_free_end_pointer()
        self._place(f, khi, klo, payload)
        self._set_next(tail, f)
        self.stats.max_chain_len = max(self.stats.max_chain_len, length + 1)

    def _insert_relocating(self, khi: int, klo: int, payload: int, home: int):
        if self._empty(home):
            self._place(home, khi, klo, payload)
            return
        if self._home_of_resident(home) != home:
            # resident is a lodger: relocate it, then claim home as host
            self._relocate_lodger(home)
            self._place(home, khi, klo, payload)
            return
        # resident is host: append to this chain near its tail
        tail, length = self._chain_tail(home)
        bounds = None
        if self.inline:
            bounds = (tail + hc.OFFSET_MIN, tail + hc.OFFSET_MAX)
        f = self._find_free(tail, bounds)
        self._place(f, khi, klo, payload)
        self._set_next(tail, f)
        self.stats.max_chain_len = max(self.stats.max_chain_len, length + 1)

    def _relocate_lodger(self, j: int):
        """Move the lodger occupying bucket j elsewhere, fixing its chain."""
        pred = self._predecessor(j)
        succ = self._next_of(j)
        bounds = None
        if self.inline:
            # f must be offset-reachable from pred AND reach succ (if any)
            lo = pred + hc.OFFSET_MIN
            hi = pred + hc.OFFSET_MAX
            if succ >= 0:
                lo = max(lo, succ - hc.OFFSET_MAX)
                hi = min(hi, succ - hc.OFFSET_MIN)
            if lo > hi:
                raise BuildError("offset constraints infeasible for relocation")
            bounds = (lo, hi)
        f = self._find_free(pred, bounds)
        # move record j -> f
        payload, _ = hc.unpack_value_int(int(self.val_hi[j]),
                                         int(self.val_lo[j]))
        self._place(f, int(self.key_hi[j]), int(self.key_lo[j]), payload)
        self._set_next(f, succ)
        self._set_next(pred, f)
        self._clear(j)
        self.stats.relocations += 1

    # -- delete --------------------------------------------------------------
    def delete(self, khi: int, klo: int, home: int) -> bool:
        if self.variant == "linear":
            return self._delete_linear(khi, klo, home)
        idx = self._find_update(khi, klo, home)
        if idx < 0:
            return False
        if self.variant == "coalesced":
            raise BuildError(
                "in-place delete unsupported for classic coalesced chains "
                "(not home-pure); rebuild via apply_delta")
        # home-pure chain: walk once to find the tail and its predecessor
        prev, cur = -1, home
        while True:
            nxt = self._next_of(cur)
            if nxt < 0:
                break
            prev, cur = cur, nxt
        tail, tail_pred = cur, prev
        if idx == tail:
            if tail_pred >= 0:
                self._set_next(tail_pred, -1)     # END is always encodable
            self._clear(tail)
            return True
        # pull the tail record into the vacated slot: the chain keeps its
        # shape (idx's own next pointer survives), every already-encoded
        # offset stays valid, and home-purity is preserved because all
        # chain members share the head's home
        payload, _ = hc.unpack_value_int(int(self.val_hi[tail]),
                                         int(self.val_lo[tail]))
        self.key_hi[idx] = self.key_hi[tail]
        self.key_lo[idx] = self.key_lo[tail]
        _, code = hc.unpack_value_int(int(self.val_hi[idx]),
                                      int(self.val_lo[idx]))
        vhi, vlo = hc.pack_value_int(payload, code if self.inline else 0)
        self.val_hi[idx] = vhi
        self.val_lo[idx] = vlo
        self._set_next(tail_pred, -1)
        self._clear(tail)
        return True

    def _delete_linear(self, khi: int, klo: int, home: int) -> bool:
        cap = self.capacity
        idx = home
        for _ in range(cap):
            if self._empty(idx):
                return False
            if int(self.key_hi[idx]) == khi and int(self.key_lo[idx]) == klo:
                break
            idx = (idx + 1) % cap
        else:
            return False
        # backward-shift deletion: keep every probe sequence gap-free
        i = idx
        self._clear(i)
        j = i
        for _ in range(cap):
            j = (j + 1) % cap
            if self._empty(j):
                break
            h = self._home_of_resident(j)
            if (j - h) % cap >= (j - i) % cap:    # j's probe path covers i
                payload, _ = hc.unpack_value_int(int(self.val_hi[j]),
                                                 int(self.val_lo[j]))
                self._place(i, int(self.key_hi[j]), int(self.key_lo[j]),
                            payload)
                self._clear(j)
                i = j
        return True

    # -------------------------------------------------------------------
    def finish(self) -> HashTable:
        self.stats.n = int(self.occ.sum())
        self.stats.load_factor = self.stats.n / self.capacity
        # recompute max chain length exactly (relocations may have changed it)
        max_len = 1
        if self.variant != "linear":
            seen_len = {}
            for idx in np.flatnonzero(self.occ):
                idx = int(idx)
                if self._home_of_resident(idx) == idx or \
                        self.variant == "coalesced":
                    # chain head (coalesced chains counted from address slots)
                    if self.variant == "coalesced" and \
                            self._home_of_resident(idx) != idx:
                        continue
                    _, length = self._chain_tail(idx)
                    max_len = max(max_len, length)
        else:
            # linear probing: probe sequence length until empty
            max_len = self._linear_max_psl()
        self.stats.max_chain_len = max_len
        return HashTable(
            variant=self.variant,
            capacity=self.capacity,
            buckets_per_line=self.bpl,
            key_hi=self.key_hi, key_lo=self.key_lo,
            val_hi=self.val_hi, val_lo=self.val_lo,
            next_idx=self.next_idx,
            home_capacity=self.home_capacity,
            stats=self.stats,
        )

    def _linear_max_psl(self) -> int:
        # longest run of occupied buckets bounds the PSL
        occ = self.occ
        if occ.all():
            return self.capacity
        # wrap-aware longest occupied run
        idx = np.flatnonzero(~occ)
        gaps = np.diff(np.concatenate([idx, [idx[0] + self.capacity]])) - 1
        return int(gaps.max()) + 1


def build_grow(
    keys: np.ndarray,
    payloads: np.ndarray,
    *,
    variant: str = "neighborhash",
    load_factor: float = 0.8,
    buckets_per_line: int = hc.CPU_BUCKETS_PER_LINE,
    growth: float = 1.5,
    max_attempts: int = 8,
) -> HashTable:
    """``build`` with the caller-side growth loop the BuildError contract
    expects: on a placement failure (e.g. no free bucket within the 12-bit
    inline offset range) retry at ``growth``x capacity until it fits."""
    n = len(keys)
    capacity = max(int(np.ceil(n / load_factor)), 8)
    last: Optional[BuildError] = None
    for _ in range(max_attempts):
        try:
            return build(keys, payloads, variant=variant, capacity=capacity,
                         buckets_per_line=buckets_per_line)
        except BuildError as e:
            last = e
            capacity = int(capacity * growth) + 1
    raise BuildError(
        f"could not place {n} keys after {max_attempts} growth attempts "
        f"(last capacity {capacity})") from last


def apply_delta(
    table: HashTable,
    upsert_keys: np.ndarray,
    upsert_payloads: np.ndarray,
    delete_keys: np.ndarray = (),
    *,
    copy: bool = False,
    load_factor: float = 0.8,
    assume_new: bool = False,
) -> HashTable:
    """Apply an incremental delta (upserts then deletes) to a table.

    The fast path mutates in place — O(delta), not O(rows) — and is
    numpy-vectorized for the dominant delta shape: upserts of keys the
    table already holds go through one ``update_batch`` masked-advance
    probe plus two fancy-index stores instead of a per-key Python loop
    (batch updates release the GIL
    inside numpy, so thread-pooled per-shard delta builds really overlap).
    Brand-new keys go through ``insert_batch`` (bulk empty-home placement
    plus grouped chain appends against a sorted free-slot index); only
    deletes, lodger evictions, and the end-pointer variants remain
    per-key.  When a placement fails (table full, 12-bit inline offset
    exhausted, or a coalesced-variant delete) the BuildError contract kicks
    in: the current residents plus the full delta are rebuilt through
    ``build_grow``.  Either way the returned table holds exactly
    ``old ∪ upserts − deletes``.

    ``copy=True`` leaves ``table`` untouched (copy-on-write for retention
    windows); with ``copy=False`` the caller must adopt the return value —
    after a fallback it is a brand-new, larger table.

    ``assume_new=True`` skips the ``update_batch`` probe: for callers that
    already classified the delta (the hybrid store upserts only keys its
    own probe proved absent), re-probing would be pure waste.  Safe even
    when the assumption is wrong — per-key ``insert`` is itself an upsert.
    """
    upsert_keys = np.asarray(upsert_keys, dtype=np.uint64).ravel()
    upsert_payloads = np.asarray(upsert_payloads, dtype=np.uint64).ravel()
    delete_keys = np.asarray(delete_keys, dtype=np.uint64).ravel()
    if upsert_keys.shape != upsert_payloads.shape:
        raise ValueError("upsert keys/payloads must be equal-length")
    t = table.copy() if copy else table
    try:
        if len(upsert_keys):
            if assume_new:
                t.insert_batch(upsert_keys, upsert_payloads,
                               assume_new=True)
            else:
                updated = t.update_batch(upsert_keys, upsert_payloads)
                if not updated.all():
                    # brand-new keys: vectorized mass placement (empty
                    # homes in bulk, then grouped chain appends against a
                    # sorted free-slot index) — last-write-wins dedup
                    # happens inside insert_batch
                    t.insert_batch(upsert_keys[~updated],
                                   upsert_payloads[~updated],
                                   assume_new=True)
        for k in delete_keys:
            t.delete(int(k))
        return t
    except BuildError:
        # every single op is atomic (it either completed or raised before
        # mutating), so t's residents are a consistent prefix of the delta;
        # re-applying the whole delta on top is idempotent
        keys, payloads = t.items_arrays()
        kv = {int(k): int(p) for k, p in zip(keys, payloads)}
        for k, p in zip(upsert_keys, upsert_payloads):
            kv[int(k)] = int(p)
        for k in delete_keys:
            kv.pop(int(k), None)
        ks = np.fromiter(kv.keys(), dtype=np.uint64, count=len(kv))
        ps = np.fromiter(kv.values(), dtype=np.uint64, count=len(kv))
        return build_grow(ks, ps, variant=table.variant,
                          load_factor=load_factor,
                          buckets_per_line=table.buckets_per_line)


# ---------------------------------------------------------------------------
# convenience
# ---------------------------------------------------------------------------
def random_kv(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Unique random uint64 keys + 52-bit payloads (benchmark datasets)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**63 - 1, size=int(n * 1.1), dtype=np.uint64)
    keys = np.unique(keys)[:n]
    while len(keys) < n:   # pragma: no cover — astronomically unlikely
        extra = rng.integers(0, 2**63 - 1, size=n, dtype=np.uint64)
        keys = np.unique(np.concatenate([keys, extra]))[:n]
    payloads = rng.integers(0, hc.PAYLOAD_MASK, size=n, dtype=np.uint64)
    return keys, payloads
