"""The control: exact search computed one precision below the float32 the
configurations state, put in the program's place.

``BruteIndex`` keeps every row on the device and answers each query by a
full scan in the metric the configuration states, the way a plain float32
search computes it: under L2 squared distances expanded as
|q|^2 - 2 q.x + |x|^2, under COSINE the similarity q.x / (|q| |x|) (0 where
either norm is 0) as the score and 1 - similarity as the distance. The norms
are f32 and the products q.x take TF32 inputs (each f32 operand rounded to a
10-bit mantissa, as the card's TF32 tensor cores round them), accumulated in
f32. It serves the
calls the load generator makes (``add_all``, ``delete_all``,
``query_batch_arrays``), so a run with it in the program's place goes
through the same traffic and the same comparison. The comparison must find it not correct.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from portbench.reference.knn import METRICS, similarity


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class BruteIndex:
    def __init__(self, dim: int, capacity: int, device, block_rows: int = 1 << 20,
                 metric: str = "L2"):
        if metric not in METRICS:
            raise ValueError(f"the control computes {', '.join(METRICS)}, not {metric!r}")
        self.metric = metric
        self.device = torch.device(device)
        self.rows = torch.zeros((capacity, dim), dtype=torch.float32,
                                device=self.device)
        self.alive = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self.n = 0
        self.block_rows = block_rows
        self.lock = threading.Lock()

    def add_all(self, rows) -> list:
        x = torch.as_tensor(np.asarray(rows, np.float32), device=self.device)
        with self.lock:
            lo = self.n
            self.rows[lo : lo + len(x)] = x
            self.alive[lo : lo + len(x)] = True
            self.n += len(x)
        return list(range(lo, lo + len(x)))

    def delete_all(self, gids) -> None:
        g = torch.as_tensor(np.asarray(gids, np.int64), device=self.device)
        with self.lock:
            self.alive[g] = False

    def query_batch_arrays(self, qs, k: int, params=None):
        q = torch.as_tensor(np.asarray(qs, np.float32), device=self.device)
        with self.lock:
            n = self.n
            alive = self.alive[:n].clone()
        qn = (q * q).sum(1)[:, None]
        q = tf32(q)
        best_d = torch.full((len(q), k), float("inf"), device=self.device)
        best_g = torch.full((len(q), k), -1, dtype=torch.int64, device=self.device)
        for off in range(0, n, self.block_rows):
            x = self.rows[off : min(n, off + self.block_rows)]
            if self.metric == "L2":
                d2 = qn - 2.0 * (q @ tf32(x).T) + (x * x).sum(1)[None, :]
            else:
                d2 = 1.0 - similarity(q @ tf32(x).T, torch.sqrt(qn),
                                      torch.sqrt((x * x).sum(1))[None, :])
            d2 = torch.where(alive[off : off + len(x)][None, :], d2, float("inf"))
            v, i = torch.topk(d2, min(k, len(x)), dim=1, largest=False)
            v2, i2 = torch.topk(torch.cat([best_d, v], 1), k, dim=1, largest=False)
            best_g = torch.gather(torch.cat([best_g, i + off], 1), 1, i2)
            best_d = v2
        gids = torch.where(torch.isinf(best_d), -1, best_g).cpu().numpy()
        if self.metric == "COSINE":
            dists = best_d.cpu().numpy()
            return gids, 1.0 - dists, dists
        dists = torch.sqrt(best_d.clamp_min(0.0)).cpu().numpy()
        return gids, -dists, dists

    def close(self) -> None:
        self.rows = self.alive = None
