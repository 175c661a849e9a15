"""The op counter (``repro_torch.analysis.opcount``) against the
reference's HLO analysis (``repro.analysis.hlo.analyze_hlo``) on the same
functions, exactly:

* the paper MLP's loss-and-grad, and the CNN's forward and gradient (the
  CNN's gradient matches too: ``convolution_backward`` counts the input and
  the weight gradient at the forward's rule, as XLA's two convolutions
  do), against the JAX-compiled HLO;
* reduced dense LMs' forward on the plain (differentiable) attention path,
  traced on ``meta``;
* a kernel's dispatcher reports its kernel's work, and the ops of its
  plain version are not counted again; flash's reported products equal the
  plain version's own count where nothing is masked;
* under ``torch.func.vmap`` the count is the agent count times one
  agent's;
* the collectives report their bytes and the live-byte peak follows the
  storages.
"""

import dataclasses
import functools
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# one torch thread: under the suite's -n 6, torch's thread per core stalls
from torch_zoo_carry import one_torch_thread  # noqa: E402, F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad, grad_and_value, vmap  # noqa: E402

from repro.analysis.hlo import analyze_hlo  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.nn import param as jparam  # noqa: E402
from repro.nn import paper_models as jpm  # noqa: E402
from repro.nn import transformer as jt  # noqa: E402
from repro_torch.analysis import opcount  # noqa: E402
from repro_torch.analysis.roofline import kernel_work  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.consensus_update import ops as kops  # noqa: E402
from repro_torch.kernels.consensus_update import ref as cref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.launch.dryrun import meta_tree  # noqa: E402
from repro_torch.nn import paper_models as tpm  # noqa: E402
from repro_torch.nn import transformer as tt  # noqa: E402


def _models(kind):
    rng = np.random.default_rng(0)
    if kind == "mlp":
        jtm = jpm.mlp_classifier_template(784, 10, depth=3)
        ttm = tpm.mlp_classifier_template(784, 10, depth=3)
        x = rng.standard_normal((16, 784)).astype(np.float32)
        ja, ta = jpm.mlp_classifier_apply, tpm.mlp_classifier_apply
    else:
        jtm, ttm = jpm.cnn_classifier_template(16, 3, 10), tpm.cnn_classifier_template(16, 3, 10)
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        ja, ta = jpm.cnn_classifier_apply, tpm.cnn_classifier_apply
    y = rng.integers(0, 10, x.shape[0]).astype(np.int32)
    # shapes are all either side counts: JAX lowers structs, the port
    # runs on meta
    jp = jax.tree.map(lambda pd: jax.ShapeDtypeStruct(pd.shape, jnp.float32),
                      jtm, is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    tp = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), jp)
    jl = functools.partial(jpm.classifier_loss, ja)
    tl = functools.partial(tpm.classifier_loss, ta)
    jb = {"x": jax.ShapeDtypeStruct(x.shape, jnp.float32),
          "y": jax.ShapeDtypeStruct(y.shape, jnp.int32)}
    tb = {"x": torch.empty(x.shape, device="meta"),
          "y": torch.empty(y.shape, dtype=torch.int32, device="meta")}
    return jl, tl, jp, tp, jb, tb


def _hlo_flops(fn, *args) -> int:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).dot_flops


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_loss_and_grad_match_the_hlo_count(kind):
    jl, tl, jp, tp, jb, tb = _models(kind)
    fwd = _hlo_flops(lambda p, b: jl(p, b)[0], jp, jb)
    grd = _hlo_flops(jax.grad(lambda p, b: jl(p, b)[0]), jp, jb)
    _, s_fwd = opcount.count(tl, tp, tb)
    _, s_grd = opcount.count(grad_and_value(tl, has_aux=True), tp, tb)
    print(f"{kind}: forward {s_fwd.dot_flops} (HLO {fwd}), loss and grad "
          f"{s_grd.dot_flops} (HLO {grd}, gap {s_grd.dot_flops - grd})")
    assert s_fwd.dot_flops == fwd
    assert s_grd.dot_flops == grd


@pytest.mark.parametrize("name", ["gemma3-1b", "granite-3-8b"])
def test_reduced_lm_forward_matches_the_hlo_count(name):
    jc = dataclasses.replace(jget(name + "-reduced"), param_dtype="float32")
    tc = dataclasses.replace(get_config(name + "-reduced"), param_dtype="float32")
    b, s = 2, 128
    jp = jax.tree.map(lambda pd: jax.ShapeDtypeStruct(pd.shape, jnp.float32),
                      jt.model_template(jc),
                      is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    want = _hlo_flops(lambda p, bt: jt.forward(jc, p, bt)[0], jp,
                      {"inputs": jax.ShapeDtypeStruct((b, s), jnp.int32)})
    tb = {"inputs": torch.empty((b, s), dtype=torch.int32, device="meta")}
    _, st = opcount.count(functools.partial(tt.forward, tc, differentiable=True),
                          meta_tree(tt.model_template(tc)), tb)
    assert st.dot_flops == want


def test_a_kernel_counts_its_reported_work_once():
    gen = torch.Generator().manual_seed(0)
    a, s, rows = 3, 3, 40
    w = torch.rand((a, s), generator=gen)
    nb = torch.randn((s, rows, 128), generator=gen)
    g = torch.randn((a, rows, 128), generator=gen)
    v = torch.randn((a, rows, 128), generator=gen)
    _, st = opcount.count(lambda: kops.cdmsgd_update_flat(nb, w, g.clone(),
                                                          v.clone(), 0.1, 0.9))
    nbytes, _ = kernel_work("cdmsgd_update", a, s, rows)
    # the two clones are the caller's; the plain version inside counts nothing
    assert st.traffic_bytes == nbytes + 2 * 2 * g.numel() * 4
    assert st.dot_flops == 0
    _, plain = opcount.count(lambda: cref.cdmsgd_update_ref(w, nb, g, v, 0.1, 0.9))
    assert plain.traffic_bytes > 0          # the plain version, counted alone
    # meta tensors report the same work
    m = {k: t.to("meta") for k, t in dict(nb=nb, w=w, g=g, v=v).items()}
    _, st_meta = opcount.count(lambda: kops.cdmsgd_update_flat(
        m["nb"], m["w"], m["g"].clone(), m["v"].clone(), 0.1, 0.9))
    assert st_meta.traffic_bytes == st.traffic_bytes


def test_flash_reports_the_plain_versions_products():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((2, 96, 4, 64), generator=gen)
    k = torch.randn((2, 80, 2, 64), generator=gen)
    v = torch.randn((2, 80, 2, 64), generator=gen)
    _, rep = opcount.count(lambda: fops.flash_attention_bshd(q, k, v, causal=False))
    _, plain = opcount.count(lambda: fref.attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False))
    assert rep.dot_flops == plain.dot_flops == 2 * 2 * 4 * 96 * 80 * (64 + 64)
    _, causal = opcount.count(lambda: fops.flash_attention_bshd(q, q[:, :, :2],
                                                                q[:, :, :2]))
    assert causal.dot_flops == 2 * 2 * 4 * (96 * 97 // 2) * 128


def test_vmap_counts_every_agent():
    gen = torch.Generator().manual_seed(2)
    w = torch.randn((5, 16, 8), generator=gen)
    x = torch.randn((5, 4, 16), generator=gen)

    def loss(w, x):
        return torch.tanh(x @ w).sum()

    _, one = opcount.count(grad(loss), w[0], x[0])
    _, all5 = opcount.count(vmap(grad(loss)), w, x)
    assert one.dot_flops > 0
    assert all5.dot_flops == 5 * one.dot_flops


def test_live_bytes_follow_the_storages():
    x = torch.ones((1024,))                  # 4 KiB

    def fn(x):
        a = x * 2                            # +4 KiB
        b = a.view(32, 32) + 1               # +4 KiB (the view adds nothing)
        del a
        return b.sum()

    _, st = opcount.count(fn, x, track_live=True)
    assert st.peak_live_bytes == 3 * 4096
    assert st.collective_count["collective-permute"] == 0
    with opcount.OpCounter() as c:
        with opcount.reported(collective=("collective-permute", 100, 2)):
            torch.ones(3) * 2                # not counted: reported region
    assert c.stats().collective_bytes["collective-permute"] == 100
    assert c.stats().total_collective_bytes == 100
    assert c.traffic_bytes == 0
