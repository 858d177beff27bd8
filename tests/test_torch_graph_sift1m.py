"""Graph mode at the sift1m shape on the CPU (marker ``slow``: about 12
minutes and 3 GB, so the suite's ``-m 'not slow'`` run leaves it out; run
it with ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_graph_sift1m.py
-m slow -s``).

bench.py's sift1m index (1M x 128 rows of its generator, seed 42, ten
100k-row segments, PQ 16 x 256, graph degree 32, breadth 64, alpha 1.2) is
built by the JAX package and served by both packages in graph mode with
bench.py's SearchParams, per segment and with ``unified_search=True`` (8 +
2 segments, one ef of 150 per subgroup), on 128 queries against float64
ground truth. It prints both packages' recall@10: the unified reading is
the floor ``chip_smoke.py`` holds the port's unified graph route to on the
card. Tolerances: recall@10 within 0.01 of the JAX package's, ids
overlapping >= 0.98 (the port ranks the traversal with the bf16-LUT scan,
the JAX package on the CPU with the f32 one).
"""

import numpy as np
import pytest

import vectorsearch_tpu as jvs
import vectorsearch_torch as tvs

pytestmark = pytest.mark.slow


def _config(pkg, path, unified):
    kw = dict(device="cpu") if pkg is tvs else {}
    return pkg.VectorIndexConfig(
        storage=pkg.DiskStorage(path, fsync=False), name="sift1m",
        dimension=128, max_segment_size=100_000, pq_m=16, pq_k=256,
        graph_degree=32, graph_build_breadth=64, graph_alpha=1.2,
        local_worker_threads=0, local_maintenance_worker_threads=0,
        sealed_search_mode="graph", unified_search=unified, **kw)


def test_sift1m_graph_mode_matches_jax(tmp_path):
    rng = np.random.default_rng(42)
    n, d = 1_000_000, 128
    centers = rng.normal(size=(2048, d)).astype(np.float32) * 4
    x = centers[rng.integers(0, 2048, n)] + rng.normal(size=(n, d)).astype(np.float32)
    q = centers[rng.integers(0, 2048, 512)] + rng.normal(size=(512, d)).astype(np.float32)
    q = q[:128]
    path = str(tmp_path / "idx")
    idx = jvs.VectorIndex.create_or_open(_config(jvs, path, False))
    try:
        idx.add_all(x)
        for sid in range(10):
            idx.build_service.build(sid)
        idx.checkpoint()
    finally:
        idx.close()
    q64 = q.astype(np.float64)
    truth = np.argsort(
        (q64 * q64).sum(1)[:, None] - 2 * q64 @ x.T.astype(np.float64)
        + (x.astype(np.float64) ** 2).sum(1)[None], axis=1)[:, :10]
    for unified in (False, True):
        got = {}
        for pkg in (jvs, tvs):
            idx = pkg.VectorIndex.create_or_open(_config(pkg, path, unified))
            try:
                params = pkg.SearchParams(ef_search=150, beam_width=128,
                                          max_iters=6, max_explore=150,
                                          mode=pkg.Mode.BEST_FIRST)
                got[pkg] = idx.query_batch_arrays(q, 10, params)[0]
            finally:
                idx.close()
        recall = {pkg: np.mean([len(set(g) & set(t)) / 10
                                for g, t in zip(got[pkg], truth)])
                  for pkg in got}
        overlap = np.mean([len(set(a) & set(b)) / 10
                           for a, b in zip(got[jvs], got[tvs])])
        print(f"unified={unified}: recall@10 JAX {recall[jvs]:.4f}, port "
              f"{recall[tvs]:.4f}, ids overlap {overlap:.4f}")
        assert abs(recall[tvs] - recall[jvs]) <= 0.01
        assert overlap >= 0.98
