"""The benchmark of ``torcheval_tpu_torch`` on an NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) once: ``python evalbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Everything that belongs to one
configuration, traffic mix, cell or per-layer metric is a file of its own
that the harness finds by its name in ``BENCHMARK.json`` (see
:mod:`evalbench.spec`), so a new cell or metric is added without editing a
file that is there.
"""
