"""Analysis of the port's steps: the op counter, roofline terms on the
card's peaks, the dry-run records and the wire-contract checker.

* :mod:`.opcount` — counts one step's dot FLOPs, traffic, collective bytes
  and live bytes (the counterpart of :mod:`repro.analysis.hlo`);
* :mod:`.roofline` — :data:`~.roofline.HW_H100`, the roofline terms, the
  consensus update's cost, ``model_flops`` and the kernels' bounds;
* :mod:`.records` — the dry-run record's schema and loader;
* :mod:`.staticcheck` — certifies the wire contract of one executed step.
"""
