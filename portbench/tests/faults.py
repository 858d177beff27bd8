"""Faults planted under the port's public calls, so that a run of a cell
shows what the comparison reads when the timed path is broken: the tests
plant them at a tiny size on the CPU, and the upper readings of
``portbench/limits/<cell>.json`` were taken with them at the cell's own size
on the card:

    python3 -m portbench.tests.faults <fault> --workload <cell> --seed <n> \
        --seconds <s> --trace 0

Each fault wraps one method of ``VectorIndex``; ``install`` takes the
``setattr`` to do it with (pytest's ``monkeypatch.setattr`` in the tests).
"""

from __future__ import annotations

import sys

import numpy as np


def _wrap_answers(setattr_, fn, k_asked=lambda k: k):
    """Passes every answer of ``query_batch_arrays`` through ``fn(index, k,
    gids, scores, dists)``, the program having been asked for ``k_asked(k)``
    neighbours."""
    from vectorsearch_torch.core.index import VectorIndex

    orig = VectorIndex.query_batch_arrays

    def query_batch_arrays(self, qs, k, params=None):
        return fn(self, k, *orig(self, qs, k_asked(k), params))

    setattr_(VectorIndex, "query_batch_arrays", query_batch_arrays)


def swap_ends(setattr_):
    """The nearest and the k-th row swap names in every answer."""
    def fn(_index, _k, g, s, d):
        g = g.copy()
        g[:, [0, -1]] = g[:, [-1, 0]]
        return g, s, d

    _wrap_answers(setattr_, fn)


def half_batch(setattr_):
    """The second half of every batch left out (answered with nothing)."""
    def fn(_index, _k, g, s, d):
        g, d = g.copy(), d.copy()
        g[len(g) // 2 :] = -1
        d[len(d) // 2 :] = np.inf
        return g, s, d

    _wrap_answers(setattr_, fn)


def segment_out(setattr_):
    """The first segment (gids below ``max_segment_size``) left out of every
    search: the program is asked for 2k neighbours and those rows dropped."""
    def fn(index, k, g, s, d):
        drop = (g >= 0) & (g < index.config.max_segment_size)
        order = np.argsort(drop, axis=1, kind="stable")[:, :k]
        take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
        keep = ~take(drop)
        return (np.where(keep, take(g), -1), np.where(keep, take(s), -np.inf),
                np.where(keep, take(d), np.inf))

    _wrap_answers(setattr_, fn, k_asked=lambda k: 2 * k)


def adds_unapplied(setattr_):
    """Every add after the first call acknowledged, with gids no row holds,
    and never made searchable."""
    from vectorsearch_torch.core.index import VectorIndex

    orig = VectorIndex.add_all
    state = {"first": True, "next": 0}

    def add_all(self, rows, payloads=None):
        if state["first"]:
            state["first"] = False
            gids = orig(self, rows, payloads)
            state["next"] = int(max(gids)) + 1
            return gids
        lo = state["next"]
        state["next"] += len(rows)
        return list(range(lo, lo + len(rows)))

    setattr_(VectorIndex, "add_all", add_all)


def deletes_unapplied(setattr_):
    """Every delete acknowledged and never applied."""
    from vectorsearch_torch.core.index import VectorIndex

    setattr_(VectorIndex, "delete_all", lambda self, gids: None)


FAULTS = {f.__name__: f for f in (swap_ends, half_batch, segment_out,
                                  adds_unapplied, deletes_unapplied)}


def install(name: str, setattr_=setattr) -> None:
    FAULTS[name](setattr_)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in FAULTS:
        print(f"usage: faults.py {{{','.join(FAULTS)}}} <portbench.run arguments>",
              file=sys.stderr)
        return 2
    install(argv[0])
    from portbench import run

    return run.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
