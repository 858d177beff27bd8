"""SegmentBuildService: the sealer (reference: tasks/SegmentBuildService.java:51-393).

Mirrors ``vectorsearch_tpu/core/build.py`` for the three seals this port
serves:
  - an empty segment: zero codebook (reference :116-120,143-157);
  - ``pq_build_mode="skip_for_exact"``: a metadata flip + checkpoint with
    zero-column codes and adjacency planes (no PQ or graph compute);
  - ``pq_build_mode="always"`` with ``graph_build_mode="skip_for_flat"``: PQ
    training and encoding on the segment's device (every written row,
    tombstones included, as the reference encodes every stored record,
    :159-185), a finite-codebook check that fails the build so the queue
    retries, and a graph-less seal (zero-column adjacency).
The graph build (ROADMAP.md Queue A13) and the mesh-sharded build (A15)
raise; the config refuses the modes that need them.

PyTorch compiles nothing per shape, so the JAX package's per-device compute
lock (which serialized kernel compiles across build threads) has no
counterpart.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from vectorsearch_torch.config import VectorIndexConfig
from vectorsearch_torch.core.store import VectorStore
from vectorsearch_torch.ops import pq as pq_ops
from vectorsearch_torch.types import SegmentState
from vectorsearch_torch.utils.metrics import get_registry
from vectorsearch_torch.utils.metrics import span as metrics_span

LOG = logging.getLogger("vectorsearch_torch.build")


class SegmentBuildService:
    def __init__(self, config: VectorIndexConfig, store: VectorStore):
        self.config = config
        self.store = store

    def build(self, seg_id: int) -> None:
        t0 = time.monotonic()
        metrics = get_registry(self.config.metric_attributes)
        try:
            # OTel span parity: vectorsearch.build (SegmentBuildService.java:75)
            with metrics_span("vectorsearch.build", {"segment": seg_id}):
                self._build_inner(seg_id)
            metrics.inc("vectorsearch.build.count")
        finally:
            metrics.record(
                "vectorsearch.build.duration_ms", (time.monotonic() - t0) * 1000.0
            )

    def _build_inner(self, seg_id: int) -> None:
        cfg = self.config
        with self.store.lock:
            seg = self.store.segments.get(seg_id)
            if seg is None:
                LOG.debug("build(%d): segment missing; skip", seg_id)
                return
            if seg.state not in (SegmentState.PENDING, SegmentState.WRITING):
                LOG.debug("build(%d): state %s not buildable; skip", seg_id, seg.state)
                return
            n_rows = seg.next_row

        m, k, sub = cfg.pq_m, cfg.pq_k, cfg.sub_dim
        if n_rows == 0:
            # empty-segment build: zero codebook + SEALED (reference :116-120,143-157)
            codes = np.zeros((seg.cap_pad, m), np.uint8)
            codebook = np.zeros((m, k, sub), np.float32)
            adjacency = np.full((seg.cap_pad, cfg.graph_degree), -1, np.int32)
            self._seal(seg_id, codes, codebook, adjacency)
            return

        if cfg.pq_build_mode == "skip_for_exact":
            # Exact mode never reads codes/codebook/adjacency: sealing is a
            # metadata flip + checkpoint. Zero-column planes mark the segment
            # PQ-less and graph-less, as in the JAX package.
            self._seal(
                seg_id,
                np.zeros((seg.cap_pad, 0), np.uint8),
                np.zeros((0, 0, 0), np.float32),
                np.zeros((seg.cap_pad, 0), np.int32),
            )
            return
        if cfg.mesh is not None:
            raise NotImplementedError(
                "the mesh-sharded PQ build is not ported to PyTorch yet "
                "(ROADMAP.md Queue A15)"
            )
        if not (
            cfg.graph_build_mode == "skip_for_flat"
            and cfg.sealed_search_mode in ("flat", "exact")
        ):
            raise NotImplementedError(
                "the graph build at seal is not ported to PyTorch yet "
                "(ROADMAP.md Queue A13); flat and exact mode seal graph-less "
                "with graph_build_mode='skip_for_flat'"
            )

        # every written row, tombstones included; the logical dim, since the
        # PQ subspace split (m x sub = dim) must see the unpadded width
        with self.store.lock:
            vectors = np.array(seg.vectors_np[:, : seg.dim])  # [cap_pad, D]
            exists = np.array(seg.exists_np)
        dev = seg.device
        xs = torch.from_numpy(vectors).to(dev)
        ex = torch.from_numpy(exists).to(dev)
        gen = torch.Generator(device=dev).manual_seed(cfg.pq_train_seed)
        codebook = pq_ops.pq_train(
            xs, ex, m=m, k=k, iters=cfg.pq_train_iters, generator=gen
        )
        if not bool(torch.isfinite(codebook).all()):
            # fail the build so the queue retries (reference :174-185)
            raise RuntimeError(
                f"PQ training failed for segment {seg_id} (m={m}, k={k})"
            )
        codes = pq_ops.pq_encode(xs, codebook, ex)
        # flat/exact search never reads adjacency: a zero-column plane marks
        # the segment graph-less
        self._seal(
            seg_id, codes.cpu().numpy(), codebook.cpu().numpy(),
            np.zeros((seg.cap_pad, 0), np.int32),
        )

    def _seal(self, seg_id: int, codes, codebook, adjacency) -> None:
        with self.store.lock:
            seg = self.store.segments.get(seg_id)
            if seg is None:
                return
            if seg.state not in (SegmentState.PENDING, SegmentState.WRITING):
                return  # raced with another builder; builds are idempotent
            seg.attach_build_artifacts(codes, codebook, adjacency)
            seg.meta.state = SegmentState.SEALED
            self.store.checkpoint_segment(seg_id)
            self.store.checkpoint_state()
        LOG.debug("sealed segment %d", seg_id)
