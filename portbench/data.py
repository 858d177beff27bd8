"""Rows, queries and writes from the seed: the clustered generators of the
repository's ``bench.py`` (``bench_sift1m``, ``bench_deep10m``), drawn on the
device with one seeded ``torch.Generator`` in a few large calls and handed
to the index as host arrays, as a client sends them.

A configuration's ``data`` block::

    {"rows": 1000000, "dim": 128, "centres": 2048, "centre_scale": 4.0,
     "unit_centres": false, "noise": 1.0, "unit_rows": false,
     "queries": {"from": "centres", "noise": 1.0}}

Rows are a uniformly drawn centre plus ``noise`` times a normal vector
(normalised with ``unit_rows``); queries are a centre or a drawn row plus
``queries.noise`` times a normal vector. A writer's fresh rows come from the
row generator, so they are as near the queries as the rows they join.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_CHUNK = 1_000_000


@dataclasses.dataclass
class Inputs:
    rows: np.ndarray  # f32 [n, d]
    queries: np.ndarray  # f32 [pool, d], held out
    fresh: np.ndarray  # f32 [m, d], the writer's rows, in the order it adds them


def _rows(spec, centres, n, gen, device):
    d = centres.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for off in range(0, n, _CHUNK):
        m = min(_CHUNK, n - off)
        pick = torch.randint(0, centres.shape[0], (m,), generator=gen, device=device)
        block = centres[pick] + spec["noise"] * torch.randn(
            (m, d), generator=gen, device=device)
        if spec.get("unit_rows", False):
            block /= block.norm(dim=1, keepdim=True)
        out[off : off + m] = block
    return out


def make(spec: dict, seed: int, n_queries: int, n_fresh: int,
         device: str) -> Inputs:
    """Every input of a run, from ``seed``: the same seed on the same kind
    of device gives the same arrays."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d = int(spec["dim"])
    centres = torch.randn((int(spec["centres"]), d), generator=gen,
                          device=device) * float(spec.get("centre_scale", 1.0))
    if spec.get("unit_centres", False):
        centres /= centres.norm(dim=1, keepdim=True)
    rows = _rows(spec, centres, int(spec["rows"]), gen, device)
    qs = spec["queries"]
    if qs["from"] == "centres":
        base = centres[torch.randint(0, centres.shape[0], (n_queries,),
                                     generator=gen, device=device)]
    elif qs["from"] == "rows":
        base = rows[torch.randint(0, rows.shape[0], (n_queries,),
                                  generator=gen, device=device)]
    else:
        raise ValueError(f"queries.from must be 'centres' or 'rows': {qs['from']!r}")
    queries = base + float(qs["noise"]) * torch.randn(
        (n_queries, d), generator=gen, device=device)
    fresh = _rows(spec, centres, n_fresh, gen, device) if n_fresh else \
        torch.empty((0, d), dtype=torch.float32, device=device)
    out = Inputs(rows.cpu().numpy(), queries.cpu().numpy(), fresh.cpu().numpy())
    del rows, queries, fresh, centres, base
    return out
