"""Port parity: the VLM frontend (internvl2-2b, reduced) against the JAX
package.

* ``forward`` on numpy-drawn weights (``torch_zoo_carry.carried``) with a
  ``frontend`` batch of 8 stub patch embeddings of dim 64 projected and
  prepended to 16 text tokens: logits over frontend plus text, within 1e-5
  of max |logit| in float32 and the reference's 2e-2 in bfloat16.
* ``loss_fn`` scores the text tail only: total and ``ce`` within 1e-5
  (relative) of JAX's, with and without a mask, and equal to the cross
  entropy of the (training) forward's last 16 positions.
* The batch specs: ``train_batch_specs`` and ``prefill_batch_specs`` give a
  frontend model ``min(frontend_tokens, seq // 2)`` stub embeddings in
  bfloat16 and the rest of the sequence as text, the reference's shapes
  and dtypes (a 1 x 1 JAX mesh beside a one-agent port mesh).
* The train CLI feeds the reference's stub, ones for every patch, and
  ``serve`` decodes text without the frontend.

``pytest -s`` prints the gaps.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_zoo_carry import carried, one_torch_thread, rel  # noqa: E402, F401

from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch.serve import make_prompt, serve  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402

NAME = "internvl2-2b"
B, S = 2, 16


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            "frontend": rng.normal(size=(B, cfg.frontend_tokens,
                                         cfg.frontend_dim)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _j_forward(jc):
    return jax.jit(lambda p, b: jt.forward(jc, p, b)[0])


def test_vlm_template_has_the_projector():
    jc, tc, jp, tp = carried(NAME)
    assert tc.frontend_tokens == 8 and tc.frontend_dim == 64
    assert tuple(tp["frontend_proj"]["w"].shape) == (64, tc.d_model)
    assert [g[:2] for g in tt.layer_groups(tc)] == [g[:2] for g in jt.layer_groups(jc)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_forward_matches_jax(dtype, tol):
    jc, tc, jp, tp = carried(NAME, dtype)
    batch = _batch(tc)
    want = _j_forward(jc)(jp, {k: jnp.asarray(batch[k]) for k in ("inputs", "frontend")})
    with torch.no_grad():
        got, aux = tt.forward(tc, tp, {k: torch.from_numpy(batch[k])
                                       for k in ("inputs", "frontend")})
    assert got.shape == (B, tc.frontend_tokens + S, tc.vocab_size)
    assert got.dtype == tc.dtype and float(aux["moe_aux"]) == 0.0
    gap = rel(got.float().numpy(), want)
    print(f"forward {NAME} reduced {dtype}, {tc.frontend_tokens} patches + {S} tokens: "
          f"max |logit diff| / max |logit| {gap:.3e} (tol {tol:g})")
    assert gap <= tol


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_loss_scores_the_text_tail(masked):
    jc, tc, jp, tp = carried(NAME)
    batch = _batch(tc, seed=2)
    if masked:
        batch["mask"] = (np.arange(S)[None] < np.array([[S], [9]])).astype(np.float32)
    want, wm = jax.jit(lambda p, b: jt.loss_fn(jc, p, b))(
        jp, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got, gm = tt.loss_fn(tc, tp, tb)
        logits, _ = tt.forward(tc, tp, tb, differentiable=True)
        tail = tt.cross_entropy(logits[:, -S:], tb["targets"], tb.get("mask"))
    gap = abs(float(got) - float(want)) / abs(float(want))
    print(f"loss {NAME} reduced {'masked' if masked else 'unmasked'}: {float(got):.6f} "
          f"(JAX {float(want):.6f}), relative gap {gap:.2e}")
    assert gap <= 1e-5 and abs(float(gm["ce"]) - float(wm["ce"])) <= 1e-5 * float(wm["ce"])
    assert float(got) == float(gm["ce"]) == float(tail)


def _j_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _shapes(specs):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in specs.items()}


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("name", [NAME, NAME + "-reduced", "gemma3-1b"])
def test_batch_specs_carry_the_frontend_budget(name, shape_name):
    jc, tc = j_get_config(name), get_config(name)
    jshape, tshape = J_SHAPES[shape_name], INPUT_SHAPES[shape_name]
    tmesh = mesh_lib.AgentMesh(rank=0, size=1, backend="gloo", group=None,
                               device=torch.device("cpu"))
    if shape_name == "train_4k":
        want = jsh.train_batch_specs(jc, jshape, _j_mesh(), "train")
        got = tsh.train_batch_specs(tc, tshape, tmesh, "train")
    else:
        want = jsh.prefill_batch_specs(jc, jshape, _j_mesh())
        got = tsh.prefill_batch_specs(tc, tshape, tmesh)
    want = {k: (tuple(v.shape), jnp.dtype(v.dtype).name) for k, v in want.items()}
    assert _shapes(got) == want
    front = min(tc.frontend_tokens, tshape.seq_len // 2)
    assert ("frontend" in got) == bool(front)
    assert got["inputs"].shape[-1] == tshape.seq_len - front


def test_frontend_budget_at_a_short_sequence():
    """Half the sequence at most goes to the frontend."""
    tc = get_config(NAME)
    tmesh = mesh_lib.AgentMesh(rank=0, size=1, backend="gloo", group=None,
                               device=torch.device("cpu"))
    got = tsh.train_batch_specs(tc, InputShape("short", 300, 2, "train"), tmesh, "train")
    assert got["frontend"].shape == (1, 2, 150, 1024) and got["inputs"].shape == (1, 2, 150)


def test_train_cli_feeds_the_stub_frontend(capsys, monkeypatch):
    from repro_torch.launch import train as lm_train
    seen = []
    original = lm_train.loss_fn

    def loss_fn(cfg, p, batch, **kw):
        seen.append(tuple(batch["frontend"].shape))
        assert bool((batch["frontend"] == 1).all())
        return original(cfg, p, batch, **kw)

    monkeypatch.setattr(lm_train, "loss_fn", loss_fn)
    tr = lm_train.main(["--arch", NAME, "--preset", "tiny", "--device", "cpu", "--agents",
                        "2", "--steps", "2", "--batch", "2", "--seq", "16",
                        "--optimizer", "cdmsgd", "--fused", "--log-every", "0"])
    assert seen and seen[0] == (2, 8, 64)
    assert np.isfinite(tr.history.rows[-1]["loss"])
    assert "internvl2-2b-reduced" in capsys.readouterr().out


def test_serve_decodes_text_without_the_frontend():
    _, tc, _, tp = carried(NAME)
    prompt = make_prompt(tc, 2, 4, seed=3)
    seqs, stats = serve(tc, tp, prompt, 3, device="cpu")
    assert seqs.shape == (2, 7) and stats["decode_steps"] == 6
    np.testing.assert_array_equal(seqs[:, :4], prompt)
