"""Port parity: the paper's benchmark harness and its figures' rows.

``repro_torch.benchmarks.common.run_experiment`` against the JAX
package's ``benchmarks/common.py::run_experiment`` for 4 steps with
``eval_every=2``, from the JAX package's ``PRNGKey(0)`` weights carried
over (the port's ``base_params`` patched to them): the MLP with SGD,
CDSGD, CDMSGD, FedAvg and fused CDMSGD, and the image CNN with CDSGD.
The loss and consensus columns agree within 1e-5 (printed with ``-s``),
the training and validation accuracies are equal (the same correct
counts: a flipped argmax tie would move them by one sample, 1/320 or
1/1024, which the check would name); ``emit`` prints the same strings
for the same rows; the Proposition 1 (``consensus_radius``) and Table 1
(``table1_rates``) rows agree within 1e-5 relative in every number.
"""

import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import consensus_radius as jradius  # noqa: E402
from benchmarks import table1_rates as jrates  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.benchmarks import consensus_radius as tradius  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402
from repro_torch.benchmarks import table1_rates as trates  # noqa: E402
from repro_torch.nn.param import params_from_numpy  # noqa: E402

TOL = 1e-5
STEPS, EVAL_EVERY = 4, 2


@pytest.fixture
def carried(monkeypatch):
    def base_params(kind="flat", n_classes=10):
        return params_from_numpy(
            jax.tree.map(np.asarray, jcommon.base_params(kind, n_classes)), "cpu")
    monkeypatch.setattr(tcommon, "base_params", base_params)


CASES = [
    ("sgd", "flat", {}), ("cdsgd", "flat", {}), ("cdmsgd", "flat", {"mu": 0.9}),
    ("fedavg", "flat", {"mu": 0.9, "local_steps": 2}),
    ("cdmsgd", "flat", {"mu": 0.9, "fused": True}),
    ("cdsgd", "image", {"lr": 0.02}),
]


@pytest.mark.parametrize("opt,kind,kw", CASES,
                         ids=["sgd", "cdsgd", "cdmsgd", "fedavg", "cdmsgd-fused",
                              "cnn-cdsgd"])
def test_run_experiment_matches_jax(carried, opt, kind, kw):
    j = jcommon.run_experiment("x", opt, kind=kind, steps=STEPS,
                               eval_every=EVAL_EVERY, **kw)
    t = tcommon.run_experiment("x", opt, kind=kind, steps=STEPS,
                               eval_every=EVAL_EVERY, device="cpu", **kw)
    assert set(t) == set(j)
    gaps = {k: abs(t[k] - j[k]) for k in ("loss", "consensus")}
    print(f"{opt} {kind} {kw}: loss {t['loss']:.6f} / {j['loss']:.6f}, "
          + ", ".join(f"{k} gap {v:.2e}" for k, v in gaps.items())
          + f"; val_acc {t['val_acc']} / {j['val_acc']}, train_acc "
          f"{t['train_acc']} / {j['train_acc']}")
    assert max(gaps.values()) <= TOL, gaps
    for k in ("val_acc", "train_acc", "val_acc_var", "lambda2"):
        assert t[k] == pytest.approx(j[k], rel=0, abs=1e-6), (k, t[k], j[k])
    # the history: the same steps, eval rows after every EVAL_EVERY steps
    th, jh = t["history"].rows, j["history"].rows
    assert [sorted(r) for r in th] == [sorted(r) for r in jh]
    for tr, jr in zip(th, jh):
        for k in jr:
            assert tr[k] == pytest.approx(jr[k], rel=0, abs=1e-4), k


def test_emit_prints_the_reference_strings(capsys):
    rows = [{"name": "fig1b/cdmsgd", "us_per_call": 1234.56, "val_acc": 0.97123,
             "train_acc": 1.0, "consensus": 1.2345e-3, "val_acc_var": 3.3e-6},
            {"name": "fig1a/sgd", "us_per_call": 9.94, "val_acc": 0.5,
             "train_acc": float("nan"), "consensus": 0.0, "val_acc_var": 0.0}]
    jcommon.emit(rows)
    j = capsys.readouterr().out
    tcommon.emit(rows)
    t = capsys.readouterr().out
    assert t == j and t.count("\n") == 2


def _numbers(rows):
    return [(name, {k: v for k, v in re.findall(r"(\w+)=([^;]+)", derived)})
            for name, derived in rows]


@pytest.mark.parametrize("bench", ["prop1", "table1"])
def test_theory_benchmark_rows_match(bench, capsys):
    jmod, tmod = {"prop1": (jradius, tradius), "table1": (jrates, trates)}[bench]
    jrows, trows = jmod.run(), tmod.run(device="cpu")
    out = capsys.readouterr().out
    assert [n for n, _ in trows] == [n for n, _ in jrows]
    worst = 0.0
    for (name, tv), (_, jv) in zip(_numbers(trows), _numbers(jrows)):
        assert set(tv) == set(jv), name
        for k in jv:
            try:
                a, b = float(tv[k]), float(jv[k])
            except ValueError:          # regime=linear, ...
                assert tv[k] == jv[k], (name, k)
                continue
            rel = abs(a - b) / max(abs(b), 1e-30)
            worst = max(worst, rel)
            assert rel <= TOL, (name, k, a, b)
    print(f"{bench}: {len(trows)} rows, worst relative gap {worst:.2e}")
    assert out.count(f"{'prop1' if bench == 'prop1' else 'table1'}/") == 2 * len(trows)


def test_runner_device_and_names(capsys):
    trun.main(["prop1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[-1].startswith("benchmarks/total,") and out[-1].endswith("count=1")
    assert len([o for o in out if o.startswith("prop1/")]) == 9
    with pytest.raises(SystemExit, match="unknown benchmark"):
        trun.main(["no_such_benchmark", "--device", "cpu"])
    # the reference runner's names, the kernel microbenchmark and the
    # roofline table among them
    assert set(trun.BENCHES) == {"fig1a", "fig1b", "fig2a", "fig2b", "fig4", "fig5",
                                 "table1", "table1_methods", "prop1", "noniid",
                                 "kernels", "roofline"}


def test_benchmarks_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcommon.run_experiment("x", "cdsgd", steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tradius.run()
