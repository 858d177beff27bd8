"""Segment stacking: batch same-shape segments into one device call.

Mirrors ``vectorsearch_tpu/core/stack.py``. Segments with the same capacity
stack into

  vectors  f32[S, N, D]   exists/alive bool[S, N]   (sealed; exact mode)
  + codes  u8[S, N, M]    codebooks f32[S, M, K, sub] (sealed, ``pq=True``:
                                                     the unified flat route)
  vectors  f32[S_pad*N, D] alive bool[S_pad*N]     (brute force, flattened)

(the graph plane of full sealed stacks belongs to the traversal slice,
ROADMAP.md Queue A14).
so all sealed segments of a power-of-two subgroup are searched by one pool
and all brute-force segments by one product.

Stacks are cached keyed by the (seg_id, version) tuple of their members,
where version covers DATA mutations. Tombstone flips bump a separate
flags_version, absorbed by re-stacking only the bool planes. Stacking copies,
so a stack is a snapshot: queries in flight keep consistent data while
segments mutate (the same contract as the per-segment device mirrors).
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch

from vectorsearch_torch.core.segment import Segment


def _pad_dim(a: torch.Tensor) -> torch.Tensor:
    """Zero-pads the trailing (feature) dim to a 128 multiple (zero pads
    change neither dot products nor norms). Segments already allocate
    lane-padded planes, so this is the identity on the serving path."""
    pad = (-a.shape[-1]) % 128
    if pad == 0:
        return a
    return torch.nn.functional.pad(a, (0, pad))


def _flags_upto(flags: torch.Tensor, snap_rows: int, rows: int) -> torch.Tensor:
    """A flag plane from a newer sync, cut back to the rows a stack's data
    planes hold: rows appended since then stay invisible to this stack
    (their vectors are not in it). Appends also change the segment version,
    so queries that start later build a new stack."""
    if snap_rows <= rows:
        return flags
    flags = flags.clone()
    flags[rows:] = False
    return flags


class SealedStack:
    def __init__(self, segments: Sequence[Segment], pq: bool = False):
        """``pq=True`` (the unified flat route): the members' PQ codes and
        codebooks are stacked too, each member's codes from the same sync
        as its flags (Segment.flat_snapshot); the exact route's squared
        norms are not."""
        self.segments = list(segments)
        self._lock = threading.Lock()
        self._flag_versions = [s.flags_version for s in segments]
        if pq:
            snaps = [s.flat_snapshot() for s in segments]
            self.codes = torch.stack([sn.codes for sn in snaps])
            self.codebooks = torch.stack([s.codebook_dev for s in segments])
            self.xn2 = None
        else:
            snaps = [s.device_snapshot() for s in segments]
            # f32[S, N] squared norms, stacked from the members' cached planes
            self.xn2 = torch.stack([sn.xn2 for sn in snaps])
        self._rows = [sn.rows for sn in snaps]
        self.vectors = _pad_dim(torch.stack([sn.vectors for sn in snaps]))
        self.exists = torch.stack([sn.exists for sn in snaps])
        self.alive = torch.stack([sn.alive for sn in snaps])

    def refresh_flags(self) -> None:
        """Re-stacks ONLY the bool flag planes when members' tombstone state
        moved (flags_version). Swaps are attribute assignments of new
        tensors: queries in flight keep their snapshot."""
        current = [s.flags_version for s in self.segments]
        if current == self._flag_versions:
            return
        with self._lock:
            if current == self._flag_versions:
                return
            snaps = [s.device_snapshot() for s in self.segments]
            self.exists = torch.stack([
                _flags_upto(sn.exists, sn.rows, r)
                for sn, r in zip(snaps, self._rows)
            ])
            self.alive = torch.stack([
                _flags_upto(sn.alive, sn.rows, r)
                for sn, r in zip(snaps, self._rows)
            ])
            self._flag_versions = current


class BruteStack:
    def __init__(self, segments: Sequence[Segment]):
        self.segments = list(segments)
        self.cap_pad = segments[0].cap_pad
        self._lock = threading.Lock()
        self._flag_versions = [s.flags_version for s in segments]
        # flattened: one product covers every row of every segment. The
        # segment-count axis pads to a power of two, as in the JAX package
        # (there it bounds the number of compiled programs; here it keeps the
        # two packages' row layouts, and so their results, identical). Pad
        # rows are alive=False.
        self._n_pad = 1
        while self._n_pad < len(segments):
            self._n_pad *= 2
        snaps = [s.device_snapshot() for s in segments]
        self._rows = [sn.rows for sn in snaps]
        if self._n_pad == 1:
            # zero-copy: the stack IS the device mirror (never written in
            # place, see core/segment.py)
            self.vectors = _pad_dim(snaps[0].vectors)
            self.alive = snaps[0].alive
            self.xn2 = snaps[0].xn2
            return
        vecs = [_pad_dim(sn.vectors) for sn in snaps]
        xn2 = [sn.xn2 for sn in snaps]
        extra = self._n_pad - len(segments)
        if extra:
            cap, dim = vecs[0].shape
            vecs.append(vecs[0].new_zeros((extra * cap, dim)))
            xn2.append(xn2[0].new_zeros(extra * cap))
        self.vectors = torch.cat(vecs, dim=0)
        # f32[S_pad * cap] squared norms, from the members' cached planes
        self.xn2 = torch.cat(xn2, dim=0)
        self.alive = self._stack_alive(snaps)

    def _stack_alive(self, snaps) -> torch.Tensor:
        alive = [
            _flags_upto(sn.alive, sn.rows, r) for sn, r in zip(snaps, self._rows)
        ]
        if self._n_pad == 1:
            return alive[0]
        extra = self._n_pad - len(self.segments)
        if extra:
            alive.append(alive[0].new_zeros(extra * self.cap_pad))
        return torch.cat(alive, dim=0)

    def refresh_flags(self) -> None:
        """Tombstone-only restack of the alive plane."""
        current = [s.flags_version for s in self.segments]
        if current == self._flag_versions:
            return
        with self._lock:
            if current == self._flag_versions:
                return
            self.alive = self._stack_alive(
                [s.device_snapshot() for s in self.segments]
            )
            self._flag_versions = current


class StackCache:
    """Caches stacks keyed by ((seg_id, version), ...)."""

    def __init__(self, max_entries: int = 8):
        self._lock = threading.Lock()
        self._sealed: dict[tuple, SealedStack] = {}
        self._brute: dict[tuple, BruteStack] = {}
        self._max = max_entries

    @staticmethod
    def _key(segments: Sequence[Segment]) -> tuple:
        return tuple((s.seg_id, s.version) for s in segments)

    def sealed(self, segments: Sequence[Segment], pq: bool = False) -> SealedStack:
        key = ("sealed-pq" if pq else "sealed", self._key(segments))
        with self._lock:
            st = self._sealed.get(key)
        if st is not None:
            st.refresh_flags()
            return st
        st = SealedStack(segments, pq=pq)
        with self._lock:
            if len(self._sealed) >= self._max:
                self._sealed.clear()  # stacks rebuild cheaply from device arrays
            self._sealed[key] = st
        return st

    def brute(self, segments: Sequence[Segment]) -> BruteStack:
        key = self._key(segments)
        with self._lock:
            st = self._brute.get(key)
        if st is not None:
            st.refresh_flags()
            return st
        st = BruteStack(segments)
        with self._lock:
            if len(self._brute) >= self._max:
                self._brute.clear()
            self._brute[key] = st
        return st
