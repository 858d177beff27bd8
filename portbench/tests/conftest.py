"""Fixtures of the benchmark's own tests: every cell of BENCHMARK.json cut to
a size the CPU runs in a few seconds (the shapes shrink, the code paths do
not), and the card, decided here and never at import."""

import time

import pytest

from portbench import harness, spec


def tiny(name: str) -> spec.Cell:
    c = spec.cell(spec.load_benchmark(), name)
    d, i, t = c.config["data"], c.config["index"], c.traffic
    d.update(rows=4000, dim=16, centres=64)
    i.update(dimension=16, max_segment_size=1000)
    if i.get("sealed_search_mode") == "flat":
        i.update(pq_m=4, pq_k=64, graph_degree=16)
    t.update(query_pool=256, sample=64, lead_s=0.3, clients=2, batch=32)
    if t.get("writer"):
        t["writer"].update(rate_per_s=2000, adds=20, deletes=20, lead_max_s=5)
    return c


def run_tiny(cell, seed=2**31 + 77, seconds=1.5, system="port"):
    return harness.run(cell, seed, seconds, False, "cpu", time.perf_counter(),
                       system=system)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
