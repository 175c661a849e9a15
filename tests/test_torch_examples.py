"""The port's examples (``repro_torch.examples``: ``serve_batched``,
``topology_study``, ``collaborative_lm_pretrain``, ported from
``examples/``) run on the CPU for 2-3 steps through ``main(argv)`` and
print the reference's lines, on one torch thread
(``torch_zoo_carry.one_torch_thread``)."""

import importlib

import pytest

pytest.importorskip("torch")

from torch_zoo_carry import one_torch_thread  # noqa: E402, F401

CASES = [
    ("serve_batched", ["--train-steps", "2", "--new-tokens", "3",
                       "--arch", "seamless-m4t-medium"],
     ["[serve] trained 2 steps, loss=", "[serve] 4 requests x 11 tokens in",
      "tok/s on CPU)", "[serve] req1: prompt="]),
    ("topology_study", ["--steps", "2"],
     ["== network size (fully connected, paper Fig 2a) ==",
      "== topology sparsity at N=8 (paper Fig 2b) ==", "gossip pairs (B-conn)",
      "trade-off: multi-round buys spectral gap"]),
    ("collaborative_lm_pretrain", ["--steps", "3", "--arch", "hymba-1.5b",
                                   "--exchange", "int8"],
     ["[e2e] hymba-1.5b-reduced: 2,125,056 params | 4 agents | ring | cdmsgd",
      "[e2e] exchange=int8:", "[e2e] train loss", "held-out (consensus model)"]),
]


@pytest.mark.parametrize("name,argv,lines", CASES, ids=[c[0] for c in CASES])
def test_example_runs_on_the_cpu(name, argv, lines, capsys):
    module = importlib.import_module(f"repro_torch.examples.{name}")
    module.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out[-2000:])
