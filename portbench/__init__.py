"""The benchmark of vectorsearch_torch, the PyTorch and CUDA port, on NVIDIA cards.

One command runs one cell once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is driven by data. ``BENCHMARK.json`` at the root of the checkout
names each cell's configuration and traffic mix; the harness finds the pieces
by those names:

- ``portbench/configs/<config>.json``: the deployment (data shape, index
  settings, guarantees, source, what was assumed or cut);
- ``portbench/traffic/<mix>.json``: the parameters that the one load
  generator (``portbench/load.py``) reads;
- ``portbench/metrics/<metric>.py``: one reader a per-layer metric;
- ``portbench/limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from.

``portbench/reference/`` holds the plain reference (exact neighbours in
float64) and the control (the same search in TF32 arithmetic), neither of
which imports anything of the program. Nothing here imports JAX or the JAX
package.
"""
