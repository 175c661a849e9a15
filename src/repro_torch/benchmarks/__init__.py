"""The paper's benchmarks on the port: one module per table or figure.

``python -m repro_torch.benchmarks.run fig1b`` runs one on the CUDA card
(``--device cpu`` on the CPU).  Every benchmark prints the JAX package's
``name,us_per_call,derived`` CSV rows (:mod:`.common`), so the two
packages' accuracy and consensus columns can be diffed.
"""
