"""crdtbench — the benchmark of ``delta_crdt_ex_tpu_torch`` on one
NVIDIA H100.

``python3 -m crdtbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout and prints one JSON result line. Everything a cell is made of
is found by name: its configuration (``configs/<config>.json``, which
names its driver), its traffic mix (``traffic/<mix>.json``, read by the
one generator :mod:`crdtbench.gen`), its entry-point driver
(``drivers/<driver>.py``) and each per-layer metric
(``metrics/<metric>.py``). The yardstick lives here too: the plain
reference (:mod:`crdtbench.reference`), the trace reduction
(:mod:`crdtbench.trace`) and the byte counts and peaks
(:mod:`crdtbench.roofline`). The CPU tests are in ``tests/``
(``python -m pytest crdtbench/tests``)."""
