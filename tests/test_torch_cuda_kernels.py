"""The CUDA consensus-update, wire-quantize, flash-attention and WKV6
kernels on the card, against their plain versions, and the sharded mode's
staged exchange between two ranks sharing the card.

Card-only: every test carries the ``cuda`` marker and skips when no CUDA
device is present (decided inside the test).  This file imports no JAX,
so it also runs on a machine with PyTorch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance 1e-6 abs: kernel and plain version do the same float32
operations in the same order (no FMA contraction in the kernel), so they
are expected to agree exactly.  ``sr_quantize`` is held bit for bit: both
draw the same Philox4x32-10 stream.  On bf16 parameter buckets every
update form (dense, ``_q``, ``_qm`` and sparse, of CDSGD, CDMSGD, Nesterov
and CDAdam) and ``sr_quantize`` are held bit for bit (ragged, stencil and
path row counts, every neighbour and payload type), each launch counted
as a bf16 one.  The sparse (top-k wire) update
kernels are held against their ``index_add_`` plain versions on compact
stacks that ``topk_compress_2d`` makes on the card and on index layouts
that stress their persistent CTAs' carried cursors (clustered runs,
entries at the tiles' edges, dense tiles, 16 neighbours); the threshold
function (amax, thresholds, counts and pick, all on the card) must give
exact counts and ``tau`` equal bit for bit to the plain path, with one
count per call.  The flash
attention and WKV6 kernels sum in another order than their plain versions:
they are held at the reference's own tolerances, ``tol_for`` of
``tests/test_kernels.py`` for attention (2e-5 float32, 2e-2 bfloat16, abs
and rel) and 1e-4 for WKV6 (its bfloat16 ``y`` at 2e-2: one bfloat16
rounding step is 4e-3 relative).  WKV6 is held at lengths around and
inside its staged chunks, at prime BH, in the model's layout, at decays
near 0 and 1, on rows off 16 bytes, and to equal bits on a second
launch.  bfloat16 attention runs the tensor-core kernel (it also rounds P
to bfloat16 before the PV product), float32 the float32 kernel; each case
checks which ran on the per-kernel count, and covers D 64 / 120 / 128 / 256, GQA
groups 1 / 2 / 4, ragged and unequal lengths (through the model path's
any-length launch), both masks, b > 1 and the strided (b, s, heads, d)
view; the float32 kernel also where its key splits fall (one, many and
uneven splits, two calls giving the same bits); the MoE and VLM configs'
4 x 2048 prefill shapes at D 128, GQA groups 8 and 2; hymba-1.5b's GQA
group of 5 at D 64 with its window, and seamless-m4t-medium's non-causal
encoder (S 1024, also float32) and cross-attention (Sq 2048 over Sk 1024,
no window), both kernels.  The MoE layer (plain PyTorch, no kernel) routes
on the card as on the CPU, dropped pairs included, and its output agrees
within 1e-5 of max |y| (float32); mamba (plain PyTorch, no kernel) on the
card agrees with the CPU within 1e-5 of max |y| on both of its branches
(the chunked scan and the step recurrence with a carried state).
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.consensus_update import consensus_update as cu  # noqa: E402
from repro_torch.kernels.consensus_update import ops  # noqa: E402
from repro_torch.kernels.consensus_update import ref  # noqa: E402
from repro_torch.kernels.consensus_update import topk  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan import rwkv_scan as rs  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.nn import moe, ssm  # noqa: E402
from repro_torch.nn.param import init_params  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

ATOL = 1e-6
ALPHA, MU = 0.05, 0.9


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(dev, a_out, s, rows, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((a_out, s), generator=gen, device=dev)
    w = (w / w.sum(dim=1, keepdim=True)).contiguous()
    x = torch.randn((s, rows, 128), generator=gen, device=dev)
    g = torch.randn((a_out, rows, 128), generator=gen, device=dev)
    v = torch.randn((a_out, rows, 128), generator=gen, device=dev)
    return w, x, g, v


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows", [(5, 5, 16941), (1, 3, 777), (8, 8, 1),
                                          (3, 1, 2)])
def test_kernels_match_plain_versions_in_place(a_out, s, rows):
    dev = _card()
    w, x, g, v = _operands(dev, a_out, s, rows, seed=rows)
    want = ref.cdsgd_update_ref(w, x, g, ALPHA)
    g1 = g.clone()
    n = cu.cdsgd_update.launches
    out = cu.cdsgd_update(w, x, g1, ALPHA)
    torch.cuda.synchronize()
    assert out.data_ptr() == g1.data_ptr() and cu.cdsgd_update.launches == n + 1
    assert float((out - want).abs().max()) <= ATOL
    want_p, want_v = ref.cdmsgd_update_ref(w, x, g, v, ALPHA, MU)
    g2, v2 = g.clone(), v.clone()
    p, nv = cu.cdmsgd_update(w, x, g2, v2, ALPHA, MU)
    torch.cuda.synchronize()
    assert (p.data_ptr(), nv.data_ptr()) == (g2.data_ptr(), v2.data_ptr())
    assert float((p - want_p).abs().max()) <= ATOL
    assert float((nv - want_v).abs().max()) <= ATOL


@pytest.mark.cuda
def test_stencil_entry_point_on_card():
    dev = _card()
    w, x, g, v = _operands(dev, 1, 3, 300, seed=7)
    want = ref.cdsgd_update_ref(w, x, g, ALPHA)[0]
    out = ops.cdsgd_update_flat(x, w[0], g[0].clone(), ALPHA)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= ATOL


@pytest.mark.cuda
def test_kernel_rejects_bad_operands_on_card():
    dev = _card()
    w, x, g, v = _operands(dev, 2, 2, 8)
    with pytest.raises(TypeError, match="float32"):
        cu.cdsgd_update(w, x, g.half(), ALPHA)
    with pytest.raises(ValueError, match="on cpu"):
        cu.cdsgd_update(w.cpu(), x, g, ALPHA)
    with pytest.raises(ValueError, match="overlap"):
        cu.cdmsgd_update(w, x, g, g, ALPHA, MU)
    flat = torch.empty(2 * 8 * 128 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        cu.cdsgd_update(w, x, flat[1:].view(2, 8, 128), ALPHA)


PAYLOADS = (torch.int8, torch.float8_e4m3fn, torch.bfloat16, torch.float32)


def _bucket(dev, a, rows, seed):
    """(a, rows, 128) f32 over several decades, row 0 all zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((a, rows, 128), generator=gen, device=dev)
    x = x * 10.0 ** (6 * torch.rand((a, rows, 1), generator=gen, device=dev) - 3)
    x[:, 0] = 0.0
    return x.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["int8", "fp8"])
@pytest.mark.parametrize("a,rows", [(5, 16941), (1, 777), (3, 5)])
def test_sr_quantize_matches_plain_version_bitwise(exchange, a, rows):
    dev = _card()
    x = _bucket(dev, a, rows, seed=rows)
    n = cu.sr_quantize.launches
    q, sc = cu.sr_quantize(x, -7, exchange, agent_stride=104729)
    torch.cuda.synchronize()
    assert cu.sr_quantize.launches == n + 1
    want_q, want_sc = ref.sr_quantize_ref(x, -7, exchange, 104729)
    assert q.dtype == want_q.dtype and sc.dtype == torch.float32
    assert torch.equal(q.view(torch.uint8), want_q.view(torch.uint8))
    assert torch.equal(sc, want_sc)
    assert bool((sc[:, 0] == 1.0).all())              # the all-zero row


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**32 - 1, 2**32 - 3])
@pytest.mark.parametrize("exchange", ["int8", "fp8"])
@pytest.mark.parametrize("a,rows", [(7, 16941), (5, 1001)])
def test_sr_quantize_persistent_grid_matches_plain_version(exchange, a, rows,
                                                            seed):
    """The persistent grid's warps cross agent boundaries inside a block and
    its last sweep is partial at these shapes; seeds near 2^32 make the
    per-agent key ``seed + 104729 a`` wrap.  Codes and scales bit for bit."""
    dev = _card()
    x = _bucket(dev, a, rows, seed=a * rows)
    q, sc = cu.sr_quantize(x, seed, exchange, agent_stride=104729)
    torch.cuda.synchronize()
    want_q, want_sc = ref.sr_quantize_ref(x, seed, exchange, 104729)
    assert torch.equal(q.view(torch.uint8), want_q.view(torch.uint8))
    assert torch.equal(sc, want_sc)


def _q_operands(dev, a_out, s, rows, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((a_out, s + 1), generator=gen, device=dev)
    w = (w / w.sum(dim=1, keepdim=True)).contiguous()
    x = torch.randn((s, rows, 128), generator=gen, device=dev)
    if dtype in (torch.int8, torch.float8_e4m3fn):
        q, sc = cu.sr_quantize(x, seed,
                               "int8" if dtype == torch.int8 else "fp8")
    else:
        q = x.to(dtype)
        sc = torch.rand((s, rows, 1), generator=gen, device=dev) + 0.5
    slf, g, v = (torch.randn((a_out, rows, 128), generator=gen, device=dev)
                 for _ in range(3))
    return w, slf, q, sc, g, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PAYLOADS, ids=str)
@pytest.mark.parametrize("a_out,s,rows", [(5, 5, 16941), (1, 3, 777), (2, 1, 3)])
def test_q_kernels_match_plain_versions_in_place(dtype, a_out, s, rows):
    dev = _card()
    w, slf, q, sc, g, v = _q_operands(dev, a_out, s, rows, dtype, seed=rows)
    want = ref.cdsgd_update_q_ref(w, slf, q, sc, g, ALPHA)
    g1 = g.clone()
    n = cu.cdsgd_update_q.launches
    out = cu.cdsgd_update_q(w, slf, q, sc, g1, ALPHA)
    torch.cuda.synchronize()
    assert out.data_ptr() == g1.data_ptr()
    assert cu.cdsgd_update_q.launches == n + 1
    assert float((out - want).abs().max()) <= ATOL
    want_p, want_v = ref.cdmsgd_update_q_ref(w, slf, q, sc, g, v, ALPHA, MU)
    g2, v2 = g.clone(), v.clone()
    p, nv = cu.cdmsgd_update_q(w, slf, q, sc, g2, v2, ALPHA, MU)
    torch.cuda.synchronize()
    assert (p.data_ptr(), nv.data_ptr()) == (g2.data_ptr(), v2.data_ptr())
    assert float((p - want_p).abs().max()) <= ATOL
    assert float((nv - want_v).abs().max()) <= ATOL


@pytest.mark.cuda
def test_dense_kernels_take_bf16_neighbours():
    dev = _card()
    w, x, g, v = _operands(dev, 5, 5, 16941, seed=3)
    xb = x.bfloat16()
    out = cu.cdsgd_update(w, xb, g.clone(), ALPHA)
    p, nv = cu.cdmsgd_update(w, xb, g.clone(), v.clone(), ALPHA, MU)
    torch.cuda.synchronize()
    assert float((out - ref.cdsgd_update_ref(w, xb, g, ALPHA)).abs().max()) <= ATOL
    want_p, want_v = ref.cdmsgd_update_ref(w, xb, g, v, ALPHA, MU)
    assert float((p - want_p).abs().max()) <= ATOL
    assert float((nv - want_v).abs().max()) <= ATOL


@pytest.mark.cuda
def test_q_kernel_rejects_misaligned_payload_on_card():
    dev = _card()
    w, slf, q, sc, g, v = _q_operands(dev, 2, 2, 8, torch.int8, seed=1)
    flat = torch.empty(2 * 8 * 128 + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        cu.cdsgd_update_q(w, slf, flat[1:].view(2, 8, 128), sc, g, ALPHA)
    with pytest.raises(ValueError, match="on cpu"):
        cu.cdsgd_update_q(w, slf.cpu(), q, sc, g, ALPHA)


ADAM = (0.01, 0.9, 0.999, 1e-8, 0.271, 0.002997)
# kernel -> (plain version, number of in-place per-agent operands, form)
B4 = {
    "cdmsgd_update_qm": (ref.cdmsgd_update_qm_ref, 2, "qm"),
    "cdmsgd_nesterov_update": (ref.cdmsgd_nesterov_update_ref, 2, "dense"),
    "cdmsgd_nesterov_update_q": (ref.cdmsgd_nesterov_update_q_ref, 2, "q"),
    "cdmsgd_nesterov_update_qm": (ref.cdmsgd_nesterov_update_qm_ref, 2, "qm"),
    "cdadam_update": (ref.cdadam_update_ref, 3, "dense"),
    "cdadam_update_q": (ref.cdadam_update_q_ref, 3, "q"),
    "cdadam_update_qm": (ref.cdadam_update_qm_ref, 3, "qm"),
}


def _b4_operands(dev, name, a_out, s, rows, dtype, seed):
    """``(mix operands, per-agent operands, scalars)`` of one B4 kernel;
    every per-agent operand and payload has an all-zero row 0."""
    _, n_state, form = B4[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    if form == "dense":
        w, x, _, _ = _operands(dev, a_out, s, rows, seed)
        mix = [w, x.to(dtype)]
    else:
        w, slf, q, sc, _, _ = _q_operands(dev, a_out, s, rows, dtype, seed)
        mix = [w, slf, q, sc]
        if form == "qm":
            _, _, vq, vsc, _, _ = _q_operands(dev, a_out, s, rows, dtype,
                                              seed + 1)
            mix += [vq, vsc]
    state = [torch.randn((a_out, rows, 128), generator=gen, device=dev)
             for _ in range(n_state)]
    if n_state == 3:
        state[2] = state[2].abs() * 0.01          # Adam's second moment
    for t in state:
        t[:, 0] = 0.0
    scalars = ADAM if n_state == 3 else (ALPHA, MU)
    return mix, state, scalars


# the dense form takes f32 and bf16 neighbours, the others every payload
NEIGHBOR_DTYPES = (torch.float32, torch.bfloat16)
B4_CASES = [(name, dtype) for name, (_, _, form) in B4.items()
            for dtype in (NEIGHBOR_DTYPES if form == "dense" else PAYLOADS)]


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows", [(5, 5, 16941), (1, 3, 777), (2, 1, 3)],
                         ids=["stacked", "stencil", "ragged"])
@pytest.mark.parametrize("name,dtype", B4_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in B4_CASES])
def test_b4_kernels_match_plain_versions_in_place(name, dtype, a_out, s, rows):
    dev = _card()
    plain, n_state, _ = B4[name]
    mix, state, scalars = _b4_operands(dev, name, a_out, s, rows, dtype, rows)
    want = plain(*mix, *state, *scalars)
    outs = [t.clone() for t in state]
    n = cu.KERNELS[name].launches
    got = cu.KERNELS[name](*mix, *outs, *scalars)
    torch.cuda.synchronize()
    assert cu.KERNELS[name].launches == n + 1
    assert [t.data_ptr() for t in got[:n_state]] == [t.data_ptr() for t in outs]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= ATOL


QM = [name for name, (_, _, form) in B4.items() if form == "qm"]


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows", [(16, 15, 777), (9, 8, 33)],
                         ids=["fc16", "partial-tile"])
@pytest.mark.parametrize("dtype", PAYLOADS, ids=str)
@pytest.mark.parametrize("name", QM)
def test_qm_kernels_match_plain_versions_bitwise(name, dtype, a_out, s, rows):
    """The register-tiled _qm kernels at fig. 2(a)'s fully connected 16
    agents (two 4-output tiles of f32 payloads, 16 one-output tiles of
    narrow ones) and at 9 outputs (a partial tile): every output equal to
    the plain version's bits, written in place."""
    dev = _card()
    plain, n_state, _ = B4[name]
    mix, state, scalars = _b4_operands(dev, name, a_out, s, rows, dtype,
                                       a_out * 1000 + rows)
    want = plain(*mix, *state, *scalars)
    outs = [t.clone() for t in state]
    n = cu.KERNELS[name].launches
    got = cu.KERNELS[name](*mix, *outs, *scalars)
    torch.cuda.synchronize()
    assert cu.KERNELS[name].launches == n + 1
    assert [t.data_ptr() for t in got[:n_state]] == [t.data_ptr() for t in outs]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_b4_kernels_reject_overlap_and_misalignment_on_card():
    dev = _card()
    mix, (g, v), sc = _b4_operands(dev, "cdmsgd_update_qm", 2, 2, 8,
                                   torch.int8, 1)
    w, slf, q, qs, vq, vqs = mix
    with pytest.raises(ValueError, match="overlap"):
        cu.cdmsgd_update_qm(w, slf, q, qs, vq, vqs, g, g, *sc)
    with pytest.raises(ValueError, match="overlap"):      # the f32-wire trap
        vf = v.clone()
        cu.cdmsgd_nesterov_update_qm(w, slf, q.float(), qs, vf, qs, g, vf, *sc)
    flat = torch.empty(2 * 8 * 128 + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        cu.cdadam_update_qm(w, slf, q, qs, flat[1:].view(2, 8, 128), vqs, g,
                            v, v.clone(), *ADAM)
    with pytest.raises(ValueError, match="on cpu"):
        cu.cdadam_update_q(w, slf, q, qs, g, v, v.cpu(), *ADAM)


# sparse (top-k wire) kernels: plain version, in-place per-agent operands
SPARSE = {
    "cdsgd_update_sparse": (ref.cdsgd_update_sparse_ref, 1),
    "cdmsgd_update_sparse": (ref.cdmsgd_update_sparse_ref, 2),
    "cdmsgd_nesterov_update_sparse": (ref.cdmsgd_nesterov_update_sparse_ref, 2),
    "cdadam_update_sparse": (ref.cdadam_update_sparse_ref, 3),
}
RING5 = [[1 / 3, 0, 1 / 3, 0, 0, 1 / 3], [1 / 3, 1 / 3, 0, 1 / 3, 0, 0],
         [1 / 3, 0, 1 / 3, 0, 1 / 3, 0], [1 / 3, 0, 0, 1 / 3, 0, 1 / 3],
         [1 / 3, 1 / 3, 0, 0, 1 / 3, 0]]     # [diag | zero-diag Pi], ring of 5


def _layout_compact(dev, gen, s, rows, k_rows, layout):
    """Compact stacks (int8 values, float32 row scales) whose sorted unique
    positions stress the kernel's carried cursor: ``"clustered"`` puts each
    neighbour's entries in three runs, one in each third of the bucket (most
    1,024-element tiles hold none, a run may fill whole tiles);
    ``"boundaries"`` draws them near the tile edges (within 8 elements),
    where the persistent CTAs' ranges meet, a few elsewhere."""
    n, kk = rows * 128, k_rows * 128
    idx = []
    for _ in range(s):
        if layout == "clustered":
            cuts = [n * i // 3 for i in range(4)]
            runs = []
            for i in range(3):
                length = kk * (i + 1) // 3 - kk * i // 3
                seg = cuts[i + 1] - cuts[i]
                assert length <= seg
                start = cuts[i] + int(torch.randint(0, seg - length + 1, (1,),
                                                    generator=gen, device=dev))
                runs.append(torch.arange(start, start + length, device=dev))
            idx.append(torch.cat(runs))
        else:
            d = torch.arange(n, device=dev) % 1024
            w = torch.where(torch.minimum(d, 1024 - d) < 8, 1.0, 1e-3)
            pick = torch.multinomial(w, kk, replacement=False, generator=gen)
            idx.append(torch.sort(pick).values)
    idx = torch.stack(idx).to(torch.int32).view(s, k_rows, 128)
    vals = torch.randint(-127, 128, (s, k_rows, 128), generator=gen, device=dev,
                         dtype=torch.int8)
    sc = 1e-5 + 0.03 * torch.rand((s, k_rows, 1), generator=gen, device=dev)
    return vals, idx.contiguous(), sc


def _sparse_operands(dev, name, a_out, s, rows, k_rows, seed, ring=False,
                     layout="topk"):
    """Compact stacks of ``s`` random buckets (all-zero row 0; or of
    ``_layout_compact``'s layout), self and per-agent state, and the
    self-separated weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if layout == "topk":
        x = _bucket(dev, s, rows, seed)
        vals, idx, sc = topk.topk_compress_2d(x, k_rows, seed, agent_stride=104729)
    else:
        vals, idx, sc = _layout_compact(dev, gen, s, rows, k_rows, layout)
    if ring:
        w = torch.tensor(RING5, dtype=torch.float32, device=dev)
    else:
        w = torch.rand((a_out, s + 1), generator=gen, device=dev)
        w = (w / w.sum(dim=1, keepdim=True)).contiguous()
    slf = torch.randn((a_out, rows, 128), generator=gen, device=dev)
    n_state = SPARSE[name][1]
    state = [torch.randn((a_out, rows, 128), generator=gen, device=dev)
             for _ in range(n_state)]
    if n_state == 3:
        state[2] = state[2].abs() * 0.01          # Adam's second moment
    scalars = {1: (ALPHA,), 2: (ALPHA, MU), 3: ADAM}[n_state]
    return [w, slf, vals, idx, sc], state, scalars


# 16,885 rows: 2,111 tiles of 8 rows (a prime: no persistent grid smaller
# than the tile count divides it), the last tile 5 rows
PRIME_TILES_ROWS = 2111 * 8 - 3


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows,k_rows,ring,layout", [
    (5, 5, 16941, 170, False, "topk"), (5, 5, 16941, 170, True, "topk"),
    (5, 5, 1001, 11, True, "topk"), (1, 3, 1001, 1001, False, "topk"),
    (1, 1, 1, 1, False, "topk"), (12, 12, 300, 3, False, "topk"),
    (5, 5, 16941, 170, False, "clustered"), (1, 3, 16941, 170, False, "clustered"),
    (5, 5, PRIME_TILES_ROWS, 169, False, "boundaries"),
    (5, 5, PRIME_TILES_ROWS, 169, True, "topk"),
    (3, 3, 2001, 1000, False, "boundaries"), (16, 16, 1001, 11, False, "topk"),
    (16, 16, 1001, 11, False, "clustered")],
    ids=["path", "path-ring", "1001-ring", "stencil-full", "one-row",
         "agent-chunks", "clustered", "stencil-clustered", "boundaries",
         "prime-tiles-ring", "dense-boundaries", "s16", "s16-clustered"])
@pytest.mark.parametrize("name", list(SPARSE))
def test_sparse_kernels_match_plain_versions_in_place(name, a_out, s, rows,
                                                      k_rows, ring, layout):
    """Every output of the plain version, written in place, one launch a
    call; also on index layouts that stress the carried cursor (clustered
    runs with most tiles empty, entries on both sides of the persistent
    CTAs' range edges, a dense tile), a tile count that no persistent grid
    divides, and 16 neighbours over agent chunks."""
    dev = _card()
    plain, n_state = SPARSE[name]
    mix, state, scalars = _sparse_operands(dev, name, a_out, s, rows, k_rows,
                                           seed=rows + s, ring=ring,
                                           layout=layout)
    want = plain(*mix, *state, *scalars)
    want = want if isinstance(want, tuple) else (want,)
    outs = [t.clone() for t in state]
    fn = cu.KERNELS[name]
    n = fn.launches
    got = fn(*mix, *outs, *scalars)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert [t.data_ptr() for t in got[:n_state]] == [t.data_ptr() for t in outs]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= ATOL
    # the dense form on the same payloads: decompress, then _q, unit scales
    if name == "cdsgd_update_sparse":
        dense = topk.topk_decompress_2d(*mix[2:], rows)
        unit = torch.ones((s, rows, 1), device=dev)
        ref_q = cu.cdsgd_update_q(mix[0], mix[1], dense, unit,
                                  state[0].clone(), ALPHA)
        torch.cuda.synchronize()
        assert float((got[0] - ref_q).abs().max()) <= ATOL


@pytest.mark.cuda
def test_sparse_stencil_entry_point_on_card():
    dev = _card()
    mix, (g,), _ = _sparse_operands(dev, "cdsgd_update_sparse", 1, 3, 777, 7,
                                    seed=5)
    w, slf, vals, idx, sc = mix
    want = ref.cdsgd_update_sparse_ref(w, slf, vals, idx, sc, g, ALPHA)[0]
    out = ops.cdsgd_update_flat(ops.SparseNeighbors(vals, idx, sc), w[0],
                                g[0].clone(), ALPHA, self_buf=slf[0])
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= ATOL


@pytest.mark.cuda
def test_sparse_kernel_rejects_bad_operands_on_card():
    dev = _card()
    mix, (g, v), sc = _sparse_operands(dev, "cdmsgd_update_sparse", 2, 2, 8,
                                       1, seed=1)
    w, slf, vals, idx, scs = mix
    with pytest.raises(ValueError, match="overlap"):
        cu.cdmsgd_update_sparse(w, slf, vals, idx, scs, g, g, *sc)
    with pytest.raises(TypeError, match="int32"):
        cu.cdsgd_update_sparse(w, slf, vals, idx.long(), scs, g, ALPHA)
    with pytest.raises(ValueError, match="on cpu"):
        cu.cdsgd_update_sparse(w, slf, vals, idx, scs, g.cpu(), ALPHA)


@pytest.mark.cuda
@pytest.mark.parametrize("a,rows,k", [(5, 16941, 21760), (5, 1001, 1408),
                                      (1, 16941, 1), (3, 1, 128)],
                         ids=["path", "1001", "stencil", "one-row"])
def test_threshold_kernel_matches_plain_version(a, rows, k):
    dev = _card()
    x = _bucket(dev, a, rows, rows)
    x[-1] = 0.0                                   # an all-zero bucket
    x[0, 1:3] = 0.5                               # ties
    n = topk.topk_threshold.launches
    tau, counts = topk.topk_threshold(x, k)
    torch.cuda.synchronize()
    assert topk.topk_threshold.launches == n + 1
    taus = topk.threshold_taus(x)
    want = ref.topk_threshold_counts_ref(x, taus)
    assert torch.equal(counts, want.float())
    ok = (want <= k).sum(dim=1)
    want_tau = taus.gather(1, torch.clamp(ok - 1, min=0)[:, None])[:, 0]
    assert torch.equal(tau, want_tau)
    assert bool((counts[:, 1:] >= counts[:, :-1]).all())
    # fewer than 16 bins: the kernel pads with +inf thresholds
    tau8, counts8 = topk.topk_threshold(x, k, n_bins=8)
    taus8 = topk.threshold_taus(x, 8)
    want8 = ref.topk_threshold_counts_ref(x, taus8)
    assert torch.equal(counts8, want8.float())
    ok8 = (want8 <= k).sum(dim=1)
    assert torch.equal(tau8, taus8.gather(
        1, torch.clamp(ok8 - 1, min=0)[:, None])[:, 0])


def _threshold_plain(x, k, n_bins=16):
    """The plain path: thresholds, exact counts and the pick in PyTorch."""
    taus = topk.threshold_taus(x, n_bins)
    want = ref.topk_threshold_counts_ref(x, taus)
    idx = torch.clamp((want <= k).sum(dim=1) - 1, min=0)
    return taus.gather(1, idx[:, None])[:, 0], want.float()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 1001, 16941])
@pytest.mark.parametrize("a", [1, 5, 7, 16])
def test_threshold_function_on_device_matches_plain_path(a, rows):
    """The whole function on the card (amax, thresholds, counts, pick): tau
    and counts bit for bit, one count per call, at agent counts whose
    boundaries fall inside the blocks' chunks; an all-zero agent, elements
    equal to thresholds (both signs) and negative zeros; two calls in a
    row on one stream give the same bits (no stale scratch)."""
    dev = _card()
    x = _bucket(dev, a, rows + 1, 7 * a + rows)[:, 1:].contiguous() if rows == 1 \
        else _bucket(dev, a, rows, 7 * a + rows)
    if a > 1:
        x[a // 2] = 0.0                           # an all-zero agent
    taus = topk.threshold_taus(x)
    for b in (0, 3, 8, 15):                       # elements on tau_b
        x[0, -1, b] = taus[0, b]
        x[-1, -1, 16 + b] = -taus[-1, b]
    x[0, -1, 40:44] = -0.0
    for k in (1, rows * 16, rows * 128):
        n = topk.topk_threshold.launches
        tau, counts = topk.topk_threshold(x, k)
        tau2, counts2 = topk.topk_threshold(x, k)
        torch.cuda.synchronize()
        assert topk.topk_threshold.launches == n + 2
        want_tau, want = _threshold_plain(x, k)
        assert torch.equal(counts, want) and torch.equal(tau, want_tau), k
        assert torch.equal(counts2, counts) and torch.equal(tau2, tau)
    for n_bins in (1, 5):
        tau, counts = topk.topk_threshold(x, rows, n_bins=n_bins)
        want_tau, want = _threshold_plain(x, rows, n_bins)
        assert torch.equal(counts, want) and torch.equal(tau, want_tau)
    tau1, counts1 = topk.topk_threshold(x[0], rows)       # one (rows, 128) bucket
    want_tau, want = _threshold_plain(x[:1], rows)
    assert tau1.shape == () and torch.equal(counts1, want[0])
    assert torch.equal(tau1, want_tau[0])


def _tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


FLASH_CASES = [   # b, h, kv, sq, sk, d, causal, window, dtype
    (2, 4, 2, 256, 256, 64, True, None, torch.float32),
    (1, 4, 1, 256, 256, 128, True, 64, torch.float32),
    (1, 2, 2, 128, 128, 64, False, None, torch.float32),
    (1, 8, 2, 128, 128, 64, True, 32, torch.float32),
    (1, 4, 4, 256, 256, 64, True, None, torch.bfloat16),
    (1, 4, 1, 640, 640, 256, True, 512, torch.bfloat16),    # gemma3 local
    (1, 4, 1, 384, 384, 256, True, None, torch.float32),    # gemma3 global
    (2, 2, 1, 100, 100, 64, True, 16, torch.float32),       # one ragged tile
    (1, 2, 1, 64, 128, 128, False, 40, torch.float32),      # sq != sk
    # the tensor-core kernel: D 64 / 128 / 256, GQA groups 1 / 2 / 4 / 9,
    # ragged and unequal lengths, both masks, windows below a tile and off
    # its multiples, b > 1
    (2, 4, 2, 256, 256, 128, True, None, torch.bfloat16),   # group 2, b 2
    (1, 8, 2, 130, 130, 64, True, None, torch.bfloat16),    # group 4, ragged
    (1, 4, 1, 200, 200, 256, True, None, torch.bfloat16),   # ragged global
    (2, 4, 1, 200, 200, 256, True, 512, torch.bfloat16),    # ragged, window > s
    (1, 2, 1, 100, 100, 128, True, 16, torch.bfloat16),     # window < a tile
    (1, 4, 2, 384, 384, 64, True, 100, torch.bfloat16),     # window off 64s
    (1, 2, 2, 128, 128, 256, False, None, torch.bfloat16),  # non-causal
    (1, 4, 4, 100, 200, 64, False, 40, torch.bfloat16),     # sq < sk, window
    (2, 4, 1, 200, 130, 256, True, None, torch.bfloat16),   # sq > sk, causal
    (1, 4, 2, 64, 320, 128, True, None, torch.bfloat16),    # sq < sk, causal
    (1, 2, 1, 1, 1, 64, True, None, torch.bfloat16),        # one row
    # GQA group 9 (starcoder2-7b: 36 heads on 4), group 4 at D 128 (granite-3-8b)
    (1, 9, 1, 256, 256, 128, True, None, torch.bfloat16),
    (2, 18, 2, 200, 200, 128, True, None, torch.bfloat16),  # ragged, b 2
    (1, 8, 2, 256, 256, 128, True, None, torch.bfloat16),   # group 4
    (1, 9, 1, 256, 256, 128, True, None, torch.float32),
    # head dim 120 (h2o-danube-3-4b): the width-128 kernels, columns
    # 120-127 zero-filled and not stored
    (1, 8, 2, 256, 256, 120, True, None, torch.bfloat16),   # group 4
    (2, 4, 1, 200, 200, 120, True, 64, torch.bfloat16),     # ragged, window
    (1, 4, 4, 100, 200, 120, False, 40, torch.bfloat16),    # sq < sk
    (1, 8, 2, 256, 256, 120, True, None, torch.float32),
    (2, 4, 1, 200, 200, 120, True, 64, torch.float32),
    (1, 4, 4, 64, 320, 120, True, None, torch.float32),     # sq < sk
    # the MoE and VLM configs' prefill shapes at D 128: GQA group 8
    # (kimi-k2-1t-a32b: 64 heads on 8) and group 2 (internvl2-2b: 16 on 8)
    (1, 64, 8, 2048, 2048, 128, True, None, torch.bfloat16),
    (1, 16, 8, 2048, 2048, 128, True, None, torch.bfloat16),
    # hymba-1.5b: GQA group 5 (25 heads on 5) at D 64 with its 1024 window,
    # and smaller groups of 5 with windows off the tiles, ragged, both kernels
    (1, 25, 5, 2048, 2048, 64, True, 1024, torch.bfloat16),
    (2, 10, 2, 300, 300, 64, True, 64, torch.bfloat16),
    (2, 10, 2, 300, 300, 64, True, 64, torch.float32),
    # seamless-m4t-medium: the encoder's non-causal self-attention at S 1024
    # (16 heads on 16, D 64; float32 in the serve loop's encode), the
    # cross-attention's 2048 decoder queries over 1024 frames (non-causal,
    # no window, Sq > Sk), and a ragged Sq > Sk in both kernels
    (1, 16, 16, 1024, 1024, 64, False, None, torch.bfloat16),
    (1, 16, 16, 1024, 1024, 64, False, None, torch.float32),
    (1, 16, 16, 2048, 1024, 64, False, None, torch.bfloat16),
    (1, 16, 16, 2048, 1024, 64, False, None, torch.float32),
    (2, 4, 4, 300, 130, 64, False, None, torch.bfloat16),
    (2, 4, 4, 300, 130, 64, False, None, torch.float32),
]


def _variant(dtype) -> str:
    return "tc" if dtype == torch.bfloat16 else "f32"


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_version(b, h, kv, sq, sk, d, causal, window,
                                            dtype):
    """Each case through the public ``flash_attention`` where the reference
    kernel's blocks allow its lengths, else through the model path's
    ``flash_attention_any_length``; bfloat16 runs the tensor-core kernel,
    float32 the float32 one."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(sq + d)
    q = torch.randn((b, h, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kv, sk, d), generator=gen, device=dev).to(dtype)
    try:
        fa.check_blocks(sq, sk)
        fn = fa.flash_attention
    except ValueError:
        fn = fa.flash_attention_any_length
    n, by = fa.flash_attention.launches, dict(fa.flash_attention.launches_by_variant)
    out = fn(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1 and out.dtype == dtype
    by[_variant(dtype)] += 1
    assert fa.flash_attention.launches_by_variant == by
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [1, 16])
@pytest.mark.parametrize("window", [1, 63, 512, None])
@pytest.mark.parametrize("s", [64, 65, 640, 2048])
def test_flash_f32_key_splits_match_plain_version(s, window, bh):
    """The float32 kernel where its key splits fall: one key tile, one row
    past it, the split card-vs-CPU length and the prefill length, windows
    inside a tile, just under one, the model's and none, at b * h 1 and 16
    (4 query heads on one KV head); a second call gives the same bits."""
    dev = _card()
    b, h = (1, 1) if bh == 1 else (4, 4)
    gen = torch.Generator(device=dev).manual_seed(s + bh)
    q = torch.randn((b, h, s, 256), generator=gen, device=dev)
    k, v = (torch.randn((b, 1, s, 256), generator=gen, device=dev) for _ in range(2))
    by = dict(fa.flash_attention.launches_by_variant)
    out = fa.flash_attention_any_length(q, k, v, window=window)
    again = fa.flash_attention_any_length(q, k, v, window=window)
    torch.cuda.synchronize()
    by["f32"] += 2
    assert fa.flash_attention.launches_by_variant == by
    torch.testing.assert_close(out, attention_ref(q, k, v, window=window),
                               **_tol(torch.float32))
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24])
def test_flash_bshd_reads_strided_views_on_card(window):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 128, hh, 64), generator=gen, device=dev)
               for hh in (4, 2, 2))
    out = fa_ops.flash_attention_bshd(q, k, v, window=window)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.stride() == q.stride()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         window=window).transpose(1, 2)
    torch.testing.assert_close(out, want, **_tol(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("s,window", [(200, None), (200, 48), (2048, 512)])
def test_flash_bshd_takes_ragged_lengths_on_card(s, window, dtype):
    """The model path at gemma3-1b's head shape (4 query heads on 1 KV
    head of 256): strided (b, s, heads, d) views, s = 200 ragged, and the
    full prefill length."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(s)
    q, k, v = (torch.randn((2, s, hh, 256), generator=gen, device=dev).to(dtype)
               for hh in (4, 1, 1))
    by = dict(fa.flash_attention.launches_by_variant)
    out = fa_ops.flash_attention_bshd(q, k, v, window=window)
    torch.cuda.synchronize()
    by[_variant(dtype)] += 1
    assert fa.flash_attention.launches_by_variant == by
    assert out.shape == q.shape and out.stride() == q.stride() and out.dtype == dtype
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         window=window).transpose(1, 2)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_cannot_take_on_card():
    dev = _card()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 2, 200, 64), device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="must divide blocks"):
            fa.flash_attention(q, q, q)
        q = torch.zeros((1, 2, 128, 96), device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention(q, q, q)
        q = torch.zeros((1, 2, 200, 64), device=dev, dtype=dtype)
        shifted = torch.zeros(q.numel() + 1, device=dev, dtype=dtype)[1:].view(q.shape)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention_any_length(shifted, q, q)
    q = torch.zeros((1, 2, 128, 64), device=dev)
    with pytest.raises(TypeError, match="one type"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q.requires_grad_(), q, q)


def _wkv_operands(dev, shape, seed, dtype=torch.float32, scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = ((scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)
               for _ in range(3))
    w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)) * 0.5 + 0.45
    return r, k, v, w


# (shape, decay, scale): shape (bh, s, hs) folded or (b, s, n_h, hs) the
# model's layout; decay None draws w in (0.45, 0.95), a number fills w with
# it; r, k, v are drawn N(0, scale^2).  With w = 0.999 the state sums 200
# steps almost undecayed: at scale 1 (|y| in the hundreds) the float32
# plain version's own rounding of y nears the 1e-4 tolerance, so that case
# draws at scale 1/4
WKV_CASES = [
    ((4, 128, 64), None, 1.0), ((2, 96, 32), None, 1.0), ((1, 256, 64), None, 1.0),
    ((8, 64, 16), None, 1.0), ((3, 100, 64), None, 1.0),
    # around and inside the staged chunks of 16 and 32 steps; the last ragged
    ((2, 1, 64), None, 1.0), ((2, 31, 64), None, 1.0), ((3, 33, 64), None, 1.0),
    ((2, 65, 32), None, 1.0), ((3, 65, 16), None, 1.0),
    # BH prime: a multiple of no grouping of blocks
    ((7, 40, 64), None, 1.0), ((5, 33, 32), None, 1.0),
    ((1, 96, 32, 64), None, 1.0),   # the model's layout, b 1 x 32 heads
    ((2, 200, 64), 0.999, 0.25), ((2, 200, 64), 1e-3, 1.0),
]


def _wkv_case_id(case):
    shape, decay, scale = case
    return ("x".join(map(str, shape)) + ("" if decay is None else f"-w{decay:g}")
            + ("" if scale == 1.0 else f"-x{scale:g}"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CASES, ids=_wkv_case_id)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_wkv6_kernel_matches_plain_version(case, dtype):
    dev = _card()
    shape, decay, scale = case
    hs = shape[-1]
    r, k, v, w = _wkv_operands(dev, shape, shape[1] + hs, dtype, scale)
    if decay is not None:
        w = torch.full_like(w, decay)
    model_layout = len(shape) == 4
    u = 0.1 * torch.randn((shape[2] if model_layout else shape[0], hs), device=dev)
    n = rs.wkv6.launches
    y, state = rs.wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert rs.wkv6.launches == n + 1 and y.dtype == dtype and y.shape == r.shape
    if model_layout:
        b, s, n_h, _ = shape

        def fold(x):
            return x.transpose(1, 2).reshape(b * n_h, s, hs)

        r, k, v, w, y = map(fold, (r, k, v, w, y))
        u = u.repeat(b, 1)
    want_y, want_state = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(state, want_state, rtol=1e-4, atol=1e-4)
    y_tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else _tol(dtype)
    torch.testing.assert_close(y.float(), want_y.to(dtype).float(), **y_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_wkv6_kernel_is_deterministic(dtype):
    """Two launches on the same operands agree bit for bit: no atomics, and
    every sum has a fixed order."""
    dev = _card()
    shape = (2, 300, 32, 64)
    r, k, v, w = _wkv_operands(dev, shape, 12, dtype)
    u = 0.1 * torch.randn((32, 64), device=dev)
    y1, state1 = rs.wkv6(r, k, v, w, u)
    y2, state2 = rs.wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(state1, state2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_wkv6_takes_rows_off_16_bytes_on_card(dtype):
    """Operands whose rows do not start on 16 bytes (a storage offset of
    one element) give what their aligned copies give."""
    dev = _card()
    shape = (3, 70, 64)
    r, k, v, w = _wkv_operands(dev, shape, 4, dtype)
    u = 0.1 * torch.randn((3, 64), device=dev)

    def shifted(x):
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=dev)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    y, state = rs.wkv6(*map(shifted, (r, k, v, w)), u)
    want_y, want_state = rs.wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


@pytest.mark.cuda
def test_wkv6_bsnh_reads_the_model_layout_on_card():
    dev = _card()
    b, s, n_h, hs = 2, 70, 4, 64
    r, k, v = (t.bfloat16() for t in _wkv_operands(dev, (b, s, n_h, hs), 5)[:3])
    w = _wkv_operands(dev, (b, s, n_h, hs), 6)[3]
    u = 0.1 * torch.randn((n_h, hs), device=dev)
    y, state = wkv_ops.wkv6_bsnh(r, k, v, w, u)
    torch.cuda.synchronize()
    assert y.shape == r.shape and state.shape == (b, n_h, hs, hs)

    def fold(x):
        return x.transpose(1, 2).reshape(b * n_h, s, hs)

    want_y, want_state = wkv6_ref(fold(r), fold(k), fold(v), fold(w),
                                  u.repeat(b, 1))
    torch.testing.assert_close(state.reshape(b * n_h, hs, hs), want_state,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fold(y).float(), want_y.bfloat16().float(),
                               **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_wkv6_kernel_rejects_what_it_cannot_take_on_card():
    dev = _card()
    r = torch.zeros((2, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head sizes"):
        rs.wkv6(r, r, r, r, torch.zeros((2, 48), device=dev))
    r = torch.zeros((2, 8, 64), device=dev)
    with pytest.raises(TypeError, match="float32 u"):
        rs.wkv6(r, r, r, r, torch.zeros((2, 64), device=dev).bfloat16())
    with pytest.raises(TypeError, match="float32 w"):
        rs.wkv6(r, r, r, r.bfloat16(), torch.zeros((2, 64), device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        rs.wkv6(r.clone().requires_grad_(), r, r, r, torch.zeros((2, 64), device=dev))


def _masked_weight_rows(dev):
    """The fault path's device weight table of a time-varying program with
    dropped links: row ``t`` is what step ``t`` hands the ``_q`` kernels."""
    from repro_torch.core.consensus import make_mixing_program, stacked_flat_comm
    from repro_torch.core.faults import make_fault_schedule
    from repro_torch.core.topology import make_topology_schedule

    prog = make_mixing_program(
        make_topology_schedule("alternating:ring:fully_connected", 5),
        strategy="time_varying", exchange="int8", staleness=2,
        faults=make_fault_schedule("drop:0:2,droplink:3:1:1:2,straggler:4:1", 5))
    return stacked_flat_comm(None, program=prog, device=dev).strategy.fault_ops


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32], ids=str)
@pytest.mark.parametrize("name", ["cdsgd_update_q", "cdmsgd_update_q",
                                  "cdmsgd_nesterov_update_q", "cdadam_update_q"])
def test_q_kernels_take_a_step_indexed_masked_weight_row(name, dtype, step):
    """The ``(A, A+1)`` arrival-masked weight row that step ``step`` hands
    the kernels (one device tensor per period step, 16-byte aligned), its
    zero weights from dropped links and a masked straggler: the kernels
    agree with their plain versions."""
    dev = _card()
    fo = _masked_weight_rows(dev)
    w = fo.weights[step % fo.period]
    assert w.shape == (5, 6) and w.data_ptr() % 16 == 0
    assert float(w[0, 1 + 2]) == 0.0                  # link 0 <- 2 is down
    torch.testing.assert_close(w.sum(dim=1), torch.ones(5, device=dev))
    rows = 1001
    if name in B4:
        mix, state, scalars = _b4_operands(dev, name, 5, 5, rows, dtype, seed=step)
        plain = B4[name][0]
    else:
        _, slf, q, sc, g, v = _q_operands(dev, 5, 5, rows, dtype, seed=step)
        mix, state, scalars = [None, slf, q, sc], [g, v], (ALPHA, MU)
        plain = {"cdsgd_update_q": ref.cdsgd_update_q_ref,
                 "cdmsgd_update_q": ref.cdmsgd_update_q_ref}[name]
        if name == "cdsgd_update_q":
            state, scalars = [g], (ALPHA,)
    mix[0] = w
    want = plain(*mix, *state, *scalars)
    want = want if isinstance(want, tuple) else (want,)
    outs = [t.clone() for t in state]
    n = cu.KERNELS[name].launches
    got = cu.KERNELS[name](*mix, *outs, *scalars)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    assert cu.KERNELS[name].launches == n + 1
    for g, ww in zip(got, want):
        assert float((g - ww).abs().max()) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["int8", "fp8"])
@pytest.mark.parametrize("step", [0, 7, 2148, 2**31 - 5])
def test_sr_quantize_at_round_seeds_matches_plain_version(exchange, step):
    """The inner consensus rounds of a multi-round program quantize at
    ``wire_seed(step, rnd=r)`` (the round stride 611953, wrapping int32
    once): codes and scales bit for bit for rounds 0..2, and the rounds'
    int8 streams differ."""
    from repro_torch.core.consensus import wire_seed

    dev = _card()
    x = _bucket(dev, 5, 1001, seed=step % 977)
    codes = []
    for r in range(3):
        seed = wire_seed(step, rnd=r)
        assert seed == wire_seed(step + 611953 * r)
        q, sc = cu.sr_quantize(x, seed, exchange, agent_stride=104729)
        torch.cuda.synchronize()
        want_q, want_sc = ref.sr_quantize_ref(x, seed, exchange, 104729)
        assert torch.equal(q.view(torch.uint8), want_q.view(torch.uint8))
        assert torch.equal(sc, want_sc)
        codes.append(q)
    if exchange == "int8":
        assert not torch.equal(codes[0], codes[1])
        assert not torch.equal(codes[1], codes[2])


# bf16 parameter buckets: the dense and _q forms of CDSGD / CDMSGD and
# sr_quantize (the model zoo's training path)
BF16_ROWS = [(4, 4, 1001), (1, 3, 37), (4, 4, 16941)]


def _bf16_bucket(gen, shape, dev):
    """bf16 values whose rows span six decades, row 0 all zero."""
    x = torch.randn(shape, generator=gen, device=dev)
    x = x * 10.0 ** (6 * torch.rand(shape[:-1] + (1,), generator=gen,
                                    device=dev) - 3)
    x[..., 0, :] = 0.0
    return x.to(torch.bfloat16).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows", BF16_ROWS, ids=["ragged", "stencil", "path"])
@pytest.mark.parametrize("neighbors", NEIGHBOR_DTYPES, ids=str)
def test_dense_kernels_on_bf16_buckets_bitwise(neighbors, a_out, s, rows):
    """bf16 grad and momentum, f32 or bf16 neighbours: every output bit of
    the plain version, written in place, counted as a bf16 launch."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows + s)
    w = torch.rand((a_out, s), generator=gen, device=dev)
    w = (w / w.sum(dim=1, keepdim=True)).contiguous()
    x = _bf16_bucket(gen, (s, rows, 128), dev).to(neighbors)
    g, v = (_bf16_bucket(gen, (a_out, rows, 128), dev) for _ in range(2))
    n = cu.cdsgd_update.launches_by_bucket["bfloat16"]
    g1 = g.clone()
    out = cu.cdsgd_update(w, x, g1, ALPHA)
    torch.cuda.synchronize()
    assert out.data_ptr() == g1.data_ptr()
    assert cu.cdsgd_update.launches_by_bucket["bfloat16"] == n + 1
    assert torch.equal(out.view(torch.int16),
                       ref.cdsgd_update_ref(w, x, g, ALPHA).view(torch.int16))
    want_p, want_v = ref.cdmsgd_update_ref(w, x, g, v, ALPHA, MU)
    p, nv = cu.cdmsgd_update(w, x, g.clone(), v.clone(), ALPHA, MU)
    torch.cuda.synchronize()
    assert torch.equal(p.view(torch.int16), want_p.view(torch.int16))
    assert torch.equal(nv.view(torch.int16), want_v.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows", BF16_ROWS, ids=["ragged", "stencil", "path"])
@pytest.mark.parametrize("dtype", PAYLOADS, ids=str)
def test_q_kernels_on_bf16_buckets_bitwise(dtype, a_out, s, rows):
    """bf16 self, grad and momentum, every payload type."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows * 7 + s)
    w = torch.rand((a_out, s + 1), generator=gen, device=dev)
    w = (w / w.sum(dim=1, keepdim=True)).contiguous()
    x = _bf16_bucket(gen, (s, rows, 128), dev)
    if dtype in (torch.int8, torch.float8_e4m3fn):
        q, sc = cu.sr_quantize(x, rows, "int8" if dtype == torch.int8 else "fp8")
    else:
        q, sc = x.to(dtype), torch.ones((s, rows, 1), device=dev)
    slf, g, v = (_bf16_bucket(gen, (a_out, rows, 128), dev) for _ in range(3))
    out = cu.cdsgd_update_q(w, slf, q, sc, g.clone(), ALPHA)
    p, nv = cu.cdmsgd_update_q(w, slf, q, sc, g.clone(), v.clone(), ALPHA, MU)
    torch.cuda.synchronize()
    want = ref.cdsgd_update_q_ref(w, slf, q, sc, g, ALPHA)
    want_p, want_v = ref.cdmsgd_update_q_ref(w, slf, q, sc, g, v, ALPHA, MU)
    for got, exp in ((out, want), (p, want_p), (nv, want_v)):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), exp.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 16941])
@pytest.mark.parametrize("exchange", ["int8", "fp8"])
def test_sr_quantize_of_a_bf16_bucket_bitwise(exchange, rows):
    """A bf16 bucket quantizes to the codes and scales of its float32
    widening (the kernel widens as it loads), equal to the plain version."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows)
    x = _bf16_bucket(gen, (4, rows, 128), dev)
    n = cu.sr_quantize.launches_by_bucket["bfloat16"]
    q, sc = cu.sr_quantize(x, 99, exchange, agent_stride=104729)
    qf, scf = cu.sr_quantize(x.float(), 99, exchange, agent_stride=104729)
    torch.cuda.synchronize()
    assert cu.sr_quantize.launches_by_bucket["bfloat16"] == n + 1
    want_q, want_sc = ref.sr_quantize_ref(x, 99, exchange, 104729)
    assert torch.equal(q.view(torch.uint8), qf.view(torch.uint8))
    assert torch.equal(q.view(torch.uint8), want_q.view(torch.uint8))
    assert torch.equal(sc, scf) and torch.equal(sc, want_sc)


def _bf16_equal(got, want) -> bool:
    return (got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
            and torch.equal(got.view(torch.int16), want.view(torch.int16)))


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows", BF16_ROWS, ids=["ragged", "stencil", "path"])
@pytest.mark.parametrize("name,dtype", B4_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in B4_CASES])
def test_b4_kernels_on_bf16_buckets_bitwise(name, dtype, a_out, s, rows):
    """Nesterov, CDAdam (dense, ``_q``, ``_qm``) and ``cdmsgd_update_qm`` on
    bf16 self, grad, momentum, moments and lookahead: every output bit of
    the plain version (the lookahead and the Adam step from unrounded
    float32 values), written in place, counted as a bf16 launch."""
    dev = _card()
    plain, n_state, form = B4[name]
    mix, state, scalars = _b4_operands(dev, name, a_out, s, rows, dtype, rows + 3)
    state = [t.to(torch.bfloat16) for t in state]
    if form != "dense":
        mix[1] = mix[1].to(torch.bfloat16)                # the self bucket
    want = plain(*mix, *state, *scalars)
    outs = [t.clone() for t in state]
    fn = cu.KERNELS[name]
    n = fn.launches_by_bucket["bfloat16"]
    got = fn(*mix, *outs, *scalars)
    torch.cuda.synchronize()
    assert fn.launches_by_bucket["bfloat16"] == n + 1
    assert [t.data_ptr() for t in got[:n_state]] == [t.data_ptr() for t in outs]
    assert len(got) == len(want)
    assert all(_bf16_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("a_out,s,rows,k_rows,layout", [
    (4, 4, 16941, 170, "topk"), (1, 3, 1001, 11, "topk"), (12, 12, 300, 3, "topk"),
    (4, 4, 16941, 170, "clustered"), (4, 4, PRIME_TILES_ROWS, 169, "boundaries"),
    (4, 4, 1001, 1001, "topk"), (16, 16, 1001, 11, "clustered")],
    ids=["path", "stencil", "agent-chunks", "clustered", "boundaries",
         "full-density", "s16"])
@pytest.mark.parametrize("name", list(SPARSE))
def test_sparse_kernels_on_bf16_buckets_bitwise(name, a_out, s, rows, k_rows,
                                                layout):
    """The four sparse forms on bf16 self, grad and state (int8 compact
    values, float32 row scales): every output bit of the plain version,
    written in place, counted as a bf16 launch; also on the cursor layouts,
    at full density and at 16 neighbours."""
    dev = _card()
    plain, n_state = SPARSE[name]
    mix, state, scalars = _sparse_operands(dev, name, a_out, s, rows, k_rows,
                                           seed=rows + 2 * s, layout=layout)
    mix[1] = mix[1].to(torch.bfloat16)
    state = [t.to(torch.bfloat16) for t in state]
    want = plain(*mix, *state, *scalars)
    want = want if isinstance(want, tuple) else (want,)
    outs = [t.clone() for t in state]
    fn = cu.KERNELS[name]
    n = fn.launches_by_bucket["bfloat16"]
    got = fn(*mix, *outs, *scalars)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    assert fn.launches_by_bucket["bfloat16"] == n + 1
    assert [t.data_ptr() for t in got[:n_state]] == [t.data_ptr() for t in outs]
    assert len(got) == len(want)
    assert all(_bf16_equal(g, w) for g, w in zip(got, want))


# the sharded mode's top-k path: one output agent over U received compact
# stacks, its weights (1 + U,) in sender order (agent 1 of a ring of 3;
# an agent of pod 2 x data 2)
ONE_AGENT_WEIGHTS = {2: [1 / 3, 1 / 3, 1 / 3], 3: [0.25, 0.25, 0.25, 0.25]}
SPARSE_FLAT = {"cdsgd_update_sparse": ops.cdsgd_update_flat,
               "cdmsgd_update_sparse": ops.cdmsgd_update_flat,
               "cdmsgd_nesterov_update_sparse": ops.cdmsgd_nesterov_update_flat,
               "cdadam_update_sparse": ops.cdadam_update_flat}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1001, 16941])
@pytest.mark.parametrize("bucket", ["float32", "bfloat16"])
@pytest.mark.parametrize("u", sorted(ONE_AGENT_WEIGHTS))
@pytest.mark.parametrize("name", list(SPARSE))
def test_sparse_kernels_at_one_output_agent_bitwise(name, u, bucket, rows):
    """The four sparse forms through the stencil entry point the sharded
    mode calls (``ops.*_update_flat`` with ``SparseNeighbors`` and 1-D
    weights, so the kernel runs at ``A_out = 1`` over ``S = U`` senders):
    every output bit of the plain version, one launch, in place."""
    dev = _card()
    dtype = getattr(torch, bucket)
    plain, n_state = SPARSE[name]
    mix, state, scalars = _sparse_operands(dev, name, 1, u, rows,
                                           topk.topk_k_rows(rows, 0.01),
                                           seed=rows + 7 * u)
    w = torch.tensor([ONE_AGENT_WEIGHTS[u]], dtype=torch.float32, device=dev)
    slf = mix[1].to(dtype)
    state = [t.to(dtype) for t in state]
    want = plain(w, slf, *mix[2:], *state, *scalars)
    want = want if isinstance(want, tuple) else (want,)
    outs = [t[0].clone() for t in state]
    fn = cu.KERNELS[name]
    n = fn.launches_by_bucket[bucket]
    got = SPARSE_FLAT[name](ops.SparseNeighbors(*mix[2:]), w[0], *outs, *scalars,
                            self_buf=slf[0])
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    assert fn.launches_by_bucket[bucket] == n + 1
    assert [t.data_ptr() for t in got[:n_state]] == [t.data_ptr() for t in outs]
    assert len(got) == len(want)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and torch.equal(g.view(torch.uint8),
                                                   wt[0].view(torch.uint8))


@pytest.mark.cuda
def test_staged_exchange_and_q_stencil_update_on_card():
    """Two ``gloo`` ranks on the card (the sharded mode's one-card layout):
    a 1,001-row f32 bucket and its int8 wire (codes and row scales) cross
    through pinned host buffers in 64 KiB messages (8 + 2 + 1 of them), bit
    for bit, and each rank's ``_q`` stencil update of the received wire
    equals the plain version on the CPU, bit for bit."""
    _card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_sharded_ranks as ranks

    from repro_torch.launch.mesh import spawn_agents

    got = spawn_agents(ranks.staged_exchange, 2, args=(1001, 64 << 10),
                       backend="gloo", device="cuda", timeout=60,
                       join_timeout=300)
    for r in range(2):
        mine, peer = got[r], got[1 - r]
        assert torch.equal(mine["received"][0], peer["x"])
        assert torch.equal(mine["received_q"][0].view(torch.uint8),
                           peer["q"].view(torch.uint8))
        assert torch.equal(mine["received_sc"][0], peer["sc"])
        want = ref.cdsgd_update_q_ref(
            mine["weights"][None], mine["x"][None],
            torch.stack(mine["received_q"]), torch.stack(mine["received_sc"]),
            mine["grad"][None], ALPHA)[0]
        assert torch.equal(mine["update"], want)
        c = mine["census"]
        assert c["sends"] == 3 and c["messages"] == 8 + 2 + 1
        assert c["staged_bytes"] == 2 * (1001 * 128 * 5 + 1001 * 4)


@pytest.mark.cuda
def test_axis_collectives_staged_on_card():
    """Four ``gloo`` ranks on the card on ``data 2 x model 2`` (the serve
    mode's one-card layout): the collectives over named axes, staged
    through pinned host buffers, gather each line's values bit for bit and
    sum over ``model`` in float32, cast once."""
    _card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_sharded_ranks as ranks

    from repro_torch.launch.mesh import spawn_agents

    axes = {"data": 2, "model": 2}
    got = spawn_agents(ranks.axis_collectives, 4, backend="gloo", device="cuda",
                       timeout=60, join_timeout=300, axes=axes)
    ranks.check_axis_collectives(got, axes)


@pytest.mark.cuda
def test_tp_training_staged_on_card():
    """Four ``gloo`` ranks on the card on ``data 2 x model 2`` (training
    over the model axis): reduced granite-3-8b's tensor-parallel grad phase
    at remat, its collectives over ``model`` staged through pinned host
    buffers inside ``torch.func``, each rank's gradient blocks within 1e-5
    of max |g| of the agent's unsharded gradient on the card; a whole fused
    step counts its forward and backward collectives apart."""
    _card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_sharded_tp_ranks as tp_ranks

    from repro_torch.launch.mesh import spawn_agents

    got = spawn_agents(tp_ranks.card_tp_grads, 4, backend="gloo", device="cuda",
                       timeout=60, join_timeout=300, axes={"data": 2, "model": 2})
    for r, res in enumerate(got):
        for leaf, (gap, top) in res["gaps"].items():
            assert gap <= 1e-5 * top, (r, leaf, gap, top)
        by = res["census"]["by_axis"]
        assert by["model"]["calls"] > 0 and by["model:grad"]["calls"] > 0
        assert res["census"]["staged_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.5, 0.5], ids=["kept", "dropped"])
def test_moe_apply_on_card_matches_cpu(factor):
    """The same routing on the card as on the CPU (the indices and the
    dropped pairs), then the layer's output and aux term, float32."""
    dev = _card()
    d, ff, e, k, b, s = 256, 128, 8, 2, 4, 64
    params = init_params(moe.moe_template(d, ff, e, n_shared=1), seed=0)
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(1))
    card = tree_map(lambda t: t.to(dev), params)
    routes = [moe.route(p["router"], xx.reshape(b * s, d), k)[2].cpu()
              for p, xx in ((params, x), (card, x.to(dev)))]
    assert torch.equal(*routes)
    counts = torch.bincount(routes[0].reshape(-1), minlength=e)
    drops = int((counts - moe.capacity(b * s, k, e, factor)).clamp(min=0).sum())
    assert (drops > 0) == (factor < 1)
    with torch.no_grad():
        want_y, want_aux = moe.moe_apply(params, x, top_k=k, capacity_factor=factor)
        got_y, got_aux = moe.moe_apply(card, x.to(dev), top_k=k, capacity_factor=factor)
    gap = float((got_y.cpu() - want_y).abs().max() / want_y.abs().max())
    assert gap <= 1e-5 and abs(float(got_aux) - float(want_aux)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("s,state", [(128, False), (40, True)], ids=["chunked", "scan"])
def test_mamba_apply_on_card_matches_cpu(s, state):
    """``mamba_apply`` (float32) on the card and on the CPU from the same
    weights and input: the chunked scan at 128 steps, the step recurrence
    at 40 from a carried state; output and final state."""
    dev = _card()
    d, b = 256, 2
    params = init_params(ssm.mamba_template(d, n_state=16), seed=0)
    gen = torch.Generator().manual_seed(2)
    params["a_log"] = 0.3 * torch.randn(params["a_log"].shape, generator=gen)
    params["dt_bias"] = 0.3 * torch.randn(params["dt_bias"].shape, generator=gen)
    x = torch.randn((b, s, d), generator=gen)
    h0 = torch.randn((b, d, 16), generator=gen) if state else None
    card = tree_map(lambda t: t.to(dev), params)
    with torch.no_grad():
        want_y, want_h = ssm.mamba_apply(params, x, h0)
        got_y, got_h = ssm.mamba_apply(card, x.to(dev), None if h0 is None else h0.to(dev))
    for got, want in ((got_y, want_y), (got_h, want_h)):
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kernel_microbench_smoke_on_card(capsys):
    """``kernel_microbench --smoke`` on the card: every row timed with CUDA
    events, the kernel rows beside their bounds, no row marked as a CPU
    time."""
    _card()
    from repro_torch.benchmarks import kernel_microbench as kmb

    rows = kmb.run(smoke=True, device="cuda")
    assert len(rows) == 12
    for name, us, derived in rows:
        assert "device=cpu" not in derived, name
    for name in ("kernel/consensus_update", "kernel/consensus_update_momentum",
                 "kernel/consensus_update_momentum_int8", "kernel/sparse_update"):
        (_, us, derived), = [r for r in rows if r[0] == name]
        assert us > 0 and "bound_ms=" in derived, (name, derived)
    assert "JSON," in capsys.readouterr().out


def _counts_on(fn, dev, *tensors):
    from repro_torch.analysis import opcount

    args = [t.to(dev) for t in tensors]
    with opcount.OpCounter() as c:
        fn(*args)
    return c.dot_flops, c.traffic_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "q", "sparse"])
def test_op_counter_agrees_between_card_and_meta_for_the_updates(form):
    """The op counter's dot FLOPs and traffic of one update launch are the
    same on the card (the kernel reports its work) as on ``meta`` (the
    plain version, its ops not counted again)."""
    dev = _card()
    w, x, g, v = _operands(dev, 5, 5, 1001, seed=3)
    if form == "dense":
        def fn(w, x, g, v):
            ops.cdmsgd_update_flat(x, w, g.clone(), v.clone(), ALPHA, MU)
        args = (w, x, g, v)
    elif form == "q":
        q, sc = cu.sr_quantize(x, 7, "int8")
        wq = torch.cat([w, w[:, :1]], dim=1).contiguous()

        def fn(wq, sf, q, sc, g, v):
            ops.cdmsgd_update_flat(q, wq, g.clone(), v.clone(), ALPHA, MU,
                                   scales=sc, self_buf=sf)
        args = (wq, g.clone(), q, sc, g, v)
    else:
        vals, idx, scs = topk.topk_compress_2d(x, 20, 11, agent_stride=1)
        wq = torch.cat([w, w[:, :1]], dim=1).contiguous()

        def fn(wq, sf, vals, idx, scs, g):
            ops.cdsgd_update_flat(ops.SparseNeighbors(vals, idx, scs), wq,
                                  g.clone(), ALPHA, self_buf=sf)
        args = (wq, g.clone(), vals, idx, scs, g)
    card = _counts_on(fn, dev, *args)
    meta = _counts_on(fn, torch.device("meta"), *args)
    assert card == meta and card[1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_op_counter_agrees_between_card_and_meta_for_flash(dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 300, 8, 128), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, 300, 2, 128), generator=gen, device=dev).to(dtype)

    def fn(q, k):
        fa_ops.flash_attention_bshd(q, k, k, causal=True, window=128)

    card = _counts_on(fn, dev, q, k)
    meta = _counts_on(fn, torch.device("meta"), q, k)
    assert card == meta and card[0] > 0
