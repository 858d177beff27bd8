"""Segment runtime: host staging + device-resident tensor bundle.

Mirrors ``vectorsearch_tpu/core/segment.py``. A segment is a fixed-capacity
bundle:

  vectors   f32[cap_pad, d_pad]  raw rows (pad rows and pad columns zero)
  exists    bool[cap_pad]        row was written (tombstones included)
  alive     bool[cap_pad]        row not tombstoned (the exact scan's mask)

Host numpy arrays are authoritative (they feed the durability layer); the
device copy is synchronized incrementally — appended row ranges and
tombstone flips — so an insert never re-uploads the whole segment.

Snapshot isolation: JAX updates make new arrays, so queries in flight keep
the snapshot they started with. The port keeps that contract by copying on
write: ``sync_device`` clones a plane, writes the clone, and then publishes
it. A tensor a query already holds is never written in place.

Sealed artifacts: the PQ codes (u8[cap_pad, M]) and the codebook go to the
device on the flat path's first use, the adjacency (i32[cap_pad, R]) on the
first traversal (``adjacency_dev``). A flat or graph query reads vectors,
flags and codes from ONE locked sync (``flat_snapshot``), so it never pairs
the codes of one sync with the flags of another. Once on the device the
codes and the adjacency are never rewritten: a vacuumed row's codes and
edges stay stale there under exists=False, as its vectors do (its distance
is +inf in every scan, so a traversal never expands it), as in the JAX
package.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from vectorsearch_torch.types import SegmentMeta, SegmentState

_LANE = 128


def pad_cap(n: int) -> int:
    return max(_LANE, ((n + _LANE - 1) // _LANE) * _LANE)


def pad_lane(d: int) -> int:
    """Feature dim padded to a 128 multiple. Segments ALLOCATE their vector
    planes at this width, as the JAX package does: zero pad columns change
    neither dot products nor norms, and checkpoints/WAL still store
    logical-dim rows (save slices, load pads), so the storage format is the
    same in both packages."""
    return max(_LANE, ((d + _LANE - 1) // _LANE) * _LANE)


class DeviceSnapshot(NamedTuple):
    """A segment's device planes as of one sync (see Segment.device_snapshot)."""

    vectors: torch.Tensor  # f32[cap_pad, d_pad]
    alive: torch.Tensor  # bool[cap_pad]
    exists: torch.Tensor  # bool[cap_pad]
    xn2: torch.Tensor  # f32[cap_pad] squared row norms
    rows: int  # rows [0, rows) are on the device


class FlatSnapshot(NamedTuple):
    """A sealed segment's planes for the flat (PQ) path, from one sync (see
    Segment.flat_snapshot)."""

    vectors: torch.Tensor  # f32[cap_pad, d_pad]
    alive: torch.Tensor  # bool[cap_pad]
    exists: torch.Tensor  # bool[cap_pad]
    codes: torch.Tensor  # u8[cap_pad, M]
    rows: int


#: Max rows shipped per incremental append put: bounds the query path's
#: worst single host->device copy when it syncs a writer's backlog inline.
_SYNC_CHUNK = 16384


class Segment:
    """One segment's runtime state. Thread-safety: all mutation goes through
    the owning index's lock; device sync is internally locked so concurrent
    readers can trigger it safely."""

    # True for shard-foreign placeholder segments (meta only, no row data):
    # a cluster shard host loads other shards' segments as stubs
    # (core/store.py). Stubs are never searched, WAL-replayed or
    # checkpointed.
    is_stub = False

    def __init__(self, meta: SegmentMeta, capacity: int, dim: int, device=None,
                 payload_arena: bool = False):
        self.meta = meta
        self.capacity = capacity
        self.cap_pad = pad_cap(capacity)
        self.dim = dim
        self.device = torch.device("cpu" if device is None else device)

        self.d_pad = pad_lane(dim)  # lane-padded allocation; see pad_lane
        self.vectors_np = np.zeros((self.cap_pad, self.d_pad), np.float32)
        self.exists_np = np.zeros(self.cap_pad, bool)
        self.alive_np = np.zeros(self.cap_pad, bool)
        self.gids_np = np.full(self.cap_pad, -1, np.int64)  # vectorized gid join
        if payload_arena:
            from vectorsearch_torch.core.payloads import PayloadArena

            self.payloads = PayloadArena(self.cap_pad)
        else:
            self.payloads = [None] * self.cap_pad
        self.next_row = 0  # rows [0, next_row) were ever written
        self.version = 0  # bumped on DATA mutations (stack-cache invalidation)
        # tombstones bump flags_version instead: stacks keep their data planes
        # and re-stack only the bool flag planes
        self.flags_version = 0

        # sealed artifacts (host side; None until built)
        self.codes_np: Optional[np.ndarray] = None
        self.codebook_np: Optional[np.ndarray] = None
        self.adjacency_np: Optional[np.ndarray] = None

        # device mirrors (published snapshots; never written in place)
        self._dev_lock = threading.Lock()
        self._vectors_dev: Optional[torch.Tensor] = None
        self._alive_dev: Optional[torch.Tensor] = None
        self._exists_dev: Optional[torch.Tensor] = None
        self._dev_rows = 0  # rows synced to device
        # cached squared norms of _vectors_dev, keyed by the identity of the
        # vectors tensor they were computed from
        self._xn2_dev: Optional[torch.Tensor] = None
        self._xn2_src: Optional[torch.Tensor] = None
        self._codes_dev: Optional[torch.Tensor] = None
        self._codebook_dev: Optional[torch.Tensor] = None
        self._adjacency_dev: Optional[torch.Tensor] = None
        # (row ids, alive value, exists value) batches: tombstones queue
        # (ids, False, True), physical clears queue (ids, False, False)
        self._pending_flag_updates: list[tuple[np.ndarray, bool, bool]] = []

    # ------------------------------------------------------------------ host

    @property
    def seg_id(self) -> int:
        return self.meta.segment_id

    @property
    def state(self) -> SegmentState:
        return self.meta.state

    def remaining_capacity(self) -> int:
        return self.capacity - self.next_row

    def exists_count(self) -> int:
        """Rows with data (tombstones included), cached by version."""
        key = (self.version, self.flags_version)
        cached = getattr(self, "_exists_count_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        n = int(np.count_nonzero(self.exists_np[: self.next_row]))
        self._exists_count_cache = (key, n)
        return n

    def append_rows(self, rows: np.ndarray, payloads: list) -> list[int]:
        """Appends rows (host side); returns the assigned vector ids."""
        n = rows.shape[0]
        if n > self.remaining_capacity():
            raise ValueError(
                f"segment {self.seg_id}: capacity exceeded "
                f"({self.next_row}+{n} > {self.capacity})"
            )
        start = self.next_row
        # rows arrive at the logical dim; pad columns stay zero
        self.vectors_np[start : start + n, : rows.shape[1]] = rows
        self.exists_np[start : start + n] = True
        self.alive_np[start : start + n] = True
        if isinstance(self.payloads, list):
            self.payloads[start : start + n] = payloads
        else:
            for i, p in enumerate(payloads):
                self.payloads[start + i] = p
        self.next_row += n
        self.meta.count += n
        self.version += 1
        return list(range(start, start + n))

    def tombstone_batch(self, vec_ids: np.ndarray) -> np.ndarray:
        """Vectorized tombstone: flips every alive, in-range row in one
        numpy pass. Returns the vids actually flipped."""
        v = np.unique(np.asarray(vec_ids, np.int64))
        v = v[(v >= 0) & (v < self.next_row)]
        flipped = v[self.alive_np[v]]
        if len(flipped) == 0:
            return flipped
        self.alive_np[flipped] = False
        self.gids_np[flipped] = -1
        self.meta.count -= len(flipped)
        self.meta.deleted_count += len(flipped)
        self.flags_version += 1
        with self._dev_lock:
            self._pending_flag_updates.append(
                (flipped.astype(np.int32), False, True)
            )
        return flipped

    def remove_rows(self, vec_ids: np.ndarray) -> None:
        """Bulk physical clear (a replayed vacuum): drops data + tombstone."""
        if len(vec_ids) == 0:
            return
        self.exists_np[vec_ids] = False
        self.alive_np[vec_ids] = False
        self.gids_np[vec_ids] = -1
        for vid in vec_ids:
            self.payloads[vid] = None
        self.vectors_np[vec_ids] = 0.0
        if self.codes_np is not None:
            self.codes_np[vec_ids] = 0
        if self.adjacency_np is not None:
            self.adjacency_np[vec_ids] = -1
        # flags-only: data planes of masked rows are never read, but the
        # exists flips must reach the device mirror
        self.flags_version += 1
        with self._dev_lock:
            self._pending_flag_updates.append(
                (np.asarray(vec_ids, np.int32).ravel().copy(), False, False)
            )

    def replay_wal(self, records: list[dict]) -> None:
        """Applies WAL records in append order over the last checkpoint
        (idempotent, as in the JAX package)."""
        for rec in records:
            if rec["op"] == "add":
                start = int(rec["start"])
                rows = np.asarray(rec["vectors"], np.float32)
                n = rows.shape[0]
                self.vectors_np[start : start + n, : rows.shape[1]] = rows
                self.exists_np[start : start + n] = True
                self.alive_np[start : start + n] = True
                self.gids_np[start : start + n] = np.asarray(rec["gids"], np.int64)
                payloads = rec.get("payloads")
                if payloads:
                    for i, p in enumerate(payloads):
                        self.payloads[start + i] = p
                self.next_row = max(self.next_row, start + n)
            elif rec["op"] == "del":
                vids = np.asarray(rec["vids"], np.int64)
                self.alive_np[vids] = False
                self.gids_np[vids] = -1
            elif rec["op"] == "vac":
                self.remove_rows(np.asarray(rec["vids"], np.int64))
        if records:
            self.version += 1
            self.flags_version += 1

    def reconcile_counts(self) -> None:
        """Recomputes meta.count / meta.deleted_count from the arrays."""
        alive = int(np.count_nonzero(self.alive_np[: self.next_row]))
        dead = int(
            np.count_nonzero(
                self.exists_np[: self.next_row] & ~self.alive_np[: self.next_row]
            )
        )
        self.meta.count = alive
        self.meta.deleted_count = dead

    def attach_build_artifacts(
        self, codes: np.ndarray, codebook: np.ndarray, adjacency: np.ndarray
    ) -> None:
        if codes.shape[0] != self.cap_pad or adjacency.shape[0] != self.cap_pad:
            raise ValueError(
                f"segment {self.seg_id}: artifact planes must have "
                f"{self.cap_pad} rows"
            )
        self.codes_np = codes
        self.codebook_np = codebook
        self.adjacency_np = adjacency
        self.version += 1
        with self._dev_lock:
            self._codes_dev = None
            self._codebook_dev = None
            self._adjacency_dev = None

    def device_resident_bytes(self) -> int:
        """Device bytes held by this segment's mirrors (reads the private
        fields only: budget enforcement must never cause uploads)."""
        with self._dev_lock:
            return sum(
                a.numel() * a.element_size()
                for a in (
                    self._vectors_dev, self._alive_dev, self._exists_dev,
                    self._codes_dev, self._codebook_dev, self._adjacency_dev,
                )
                if a is not None
            )

    def invalidate_device(self) -> None:
        self.version += 1
        with self._dev_lock:
            self._vectors_dev = None
            self._alive_dev = None
            self._exists_dev = None
            self._codes_dev = None
            self._codebook_dev = None
            self._adjacency_dev = None
            self._dev_rows = 0
            self._pending_flag_updates.clear()

    # ---------------------------------------------------------------- device

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (always a copy: a CPU tensor must
        not alias the host planes, which writers mutate in place)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, copy=True
        )

    def sync_device(self) -> None:
        """Brings the device mirror up to date: uploads appended row ranges
        and applies pending tombstone flips, copy-on-write (see the module
        docstring)."""
        with self._dev_lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        # next_row is read BEFORE the planes: a writer appending meanwhile
        # (under the store lock, not this one) fills vectors, then flags, then
        # bumps next_row, so rows below `stop` are complete in the copies
        stop = self.next_row
        if self._vectors_dev is None:
            self._pending_flag_updates.clear()
            self._vectors_dev = self._put(self.vectors_np)
            alive, exists = self._put(self.alive_np), self._put(self.exists_np)
            # rows at or past `stop` may be half-written: invisible until the
            # next sync copies them
            alive[stop:] = False
            exists[stop:] = False
            self._alive_dev, self._exists_dev = alive, exists
            self._dev_rows = stop
            return
        if stop > self._dev_rows:
            vectors = self._vectors_dev.clone()
            exists = self._exists_dev.clone()
            alive = self._alive_dev.clone()
            start = self._dev_rows
            while start < stop:
                # chunks of at most _SYNC_CHUNK rows; only logical-dim columns
                # ship (pad columns are zero since the first put)
                end = min(stop, start + _SYNC_CHUNK)
                vectors[start:end, : self.dim] = self._put(
                    self.vectors_np[start:end, : self.dim]
                )
                exists[start:end] = self._put(self.exists_np[start:end])
                alive[start:end] = self._put(self.alive_np[start:end])
                start = end
            self._vectors_dev, self._exists_dev = vectors, exists
            self._alive_dev = alive
            self._dev_rows = stop
        if self._pending_flag_updates:
            ids = np.concatenate(
                [b for b, _, _ in self._pending_flag_updates]
            ).astype(np.int64)
            al = np.concatenate([
                np.full(len(b), av, bool)
                for b, av, _ in self._pending_flag_updates
            ])
            ex = np.concatenate([
                np.full(len(b), ev, bool)
                for b, _, ev in self._pending_flag_updates
            ])
            if len(np.unique(ids)) != len(ids):
                # the same row queued twice with different values (tombstone,
                # then clear): a scatter with duplicate indices picks an
                # arbitrary one (on CUDA, nondeterministically), so keep the
                # LAST queued write per row
                _, last_rev = np.unique(ids[::-1], return_index=True)
                keep = np.sort(len(ids) - 1 - last_rev)
                ids, al, ex = ids[keep], al[keep], ex[keep]
            idx = self._put(ids)
            alive = self._alive_dev.clone()
            exists = self._exists_dev.clone()
            alive[idx] = self._put(al)
            exists[idx] = self._put(ex)
            self._alive_dev, self._exists_dev = alive, exists
            self._pending_flag_updates.clear()

    def device_snapshot(self) -> DeviceSnapshot:
        """The device planes from ONE sync, under one lock: a query that
        read vectors and alive in two separate syncs could see rows marked
        alive whose vectors its snapshot does not hold. ``xn2`` is cached
        per vectors tensor and recomputed only when the mirror is replaced."""
        with self._dev_lock:
            self._sync_locked()
            v = self._vectors_dev
            if self._xn2_src is not v:
                self._xn2_dev = torch.sum(v * v, dim=-1)
                self._xn2_src = v
            return DeviceSnapshot(
                v, self._alive_dev, self._exists_dev, self._xn2_dev,
                self._dev_rows,
            )

    def flat_snapshot(self) -> FlatSnapshot:
        """Vectors, flags and PQ codes from ONE sync, under one lock (the
        flat path's counterpart of device_snapshot). The codes go to the
        device on first use after the seal."""
        with self._dev_lock:
            self._sync_locked()
            if self._codes_dev is None:
                if self.codes_np is None:
                    raise ValueError(f"segment {self.seg_id} has no PQ codes")
                self._codes_dev = self._put(self.codes_np)
            return FlatSnapshot(
                self._vectors_dev, self._alive_dev, self._exists_dev,
                self._codes_dev, self._dev_rows,
            )

    @property
    def codebook_dev(self) -> Optional[torch.Tensor]:
        """The sealed codebook f32[M, K, D/M] on the device (uploaded on
        first use); None before the seal."""
        with self._dev_lock:
            if self._codebook_dev is None and self.codebook_np is not None:
                self._codebook_dev = self._put(self.codebook_np)
            return self._codebook_dev

    @property
    def adjacency_dev(self) -> Optional[torch.Tensor]:
        """The sealed graph i32[cap_pad, R] on the device (uploaded on the
        first traversal); None before the seal."""
        with self._dev_lock:
            if self._adjacency_dev is None and self.adjacency_np is not None:
                self._adjacency_dev = self._put(self.adjacency_np)
            return self._adjacency_dev

    def warm_device(self) -> None:
        """Materializes every device mirror now (the planes, their squared
        norms, and the PQ codes and codebook of a sealed segment), so that
        the first query after an ``invalidate_device`` (a compaction's
        destination) does not pay the upload on its latency path. Called
        from maintenance threads."""
        self.device_snapshot()
        if self.codes_np is not None:
            self.flat_snapshot()
        _ = self.codebook_dev

    def append_backlog(self) -> int:
        """Advisory (lock-free) count of appended rows not yet on the device
        mirror — the background syncer's eager-mode signal."""
        if self._vectors_dev is None:
            return 0
        return max(0, self.next_row - self._dev_rows)

    # ------------------------------------------------------------ persistence

    def to_arrays(self) -> dict:
        """The checkpoint planes, in the JAX package's format (logical-dim
        rows)."""
        arrays = {
            "vectors": self.vectors_np[: self.next_row, : self.dim],
            "exists": self.exists_np[: self.next_row],
            "alive": self.alive_np[: self.next_row],
            "next_row": np.array([self.next_row], np.int64),
            "capacity": np.array([self.capacity], np.int64),
            "gids": self.gids_np[: self.next_row],
        }
        if self.codes_np is not None:
            arrays["codes"] = self.codes_np
            arrays["codebook"] = self.codebook_np
            arrays["adjacency"] = self.adjacency_np
        if not isinstance(self.payloads, list):
            arrays.update(self.payloads.to_npz_arrays(self.next_row))
        return arrays

    def payloads_for_checkpoint(self):
        """List payloads ride the pickle side-channel; arena payloads are
        embedded in to_arrays() planes."""
        if isinstance(self.payloads, list):
            return self.payloads[: self.next_row]
        return None

    @staticmethod
    def from_arrays(
        meta: SegmentMeta, capacity: int, dim: int, rec: dict, device=None,
        payload_arena: bool = False,
    ) -> "Segment":
        """Loads the record the JAX package's ``Segment.to_arrays`` (or this
        class's) wrote."""
        arrays = rec["arrays"]
        if "capacity" in arrays:
            # compacted segments may exceed maxSegmentSize
            capacity = max(capacity, int(arrays["capacity"][0]))
        seg = Segment(meta, capacity, dim, device=device,
                      payload_arena=payload_arena)
        n = int(arrays["next_row"][0])
        seg.next_row = n
        vec = arrays["vectors"]
        seg.vectors_np[:n, : vec.shape[1]] = vec
        seg.exists_np[:n] = arrays["exists"]
        seg.alive_np[:n] = arrays["alive"]
        if "gids" in arrays:
            seg.gids_np[:n] = arrays["gids"]
        if "payload_off" in arrays:
            from vectorsearch_torch.core.payloads import PayloadArena

            seg.payloads = PayloadArena.from_npz_arrays(seg.cap_pad, arrays)
        elif rec.get("payloads"):
            for i, p in enumerate(rec["payloads"][: seg.cap_pad]):
                seg.payloads[i] = p
        if "codes" in arrays:
            seg.codes_np = np.array(arrays["codes"])
            seg.codebook_np = np.array(arrays["codebook"])
            seg.adjacency_np = np.array(arrays["adjacency"])
        return seg
