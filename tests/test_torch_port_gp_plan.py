"""The launch plan of the closed-form GP kernels
(``tpugan_torch.ops.mlp_gp.plan``), on the CPU.

At the WGAN-GP slice shape (64, 784, 512, 256), a batch of 1, a ragged small
shape and a batch of 65 (a second row tile of one row), in both directions:
every output element of every product is written by exactly one CTA; the
depth ranges of a cluster partition [0, K) in ascending rank order; clusters
stay within the portable 8 CTAs and shared memory within a CTA's 227 KB; and
at the slice shape every product runs at least 100 CTAs. A float32 emulation
of the plan's split-K order (each rank's partial product over its depth
range, the partials added in rank order, the column sum's rows in rank and
row order) matches the plain versions within the tolerances of
``tests/test_torch_port_mlp_gp.py``. The kernels themselves run only on the
card (``tests/test_torch_port_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from test_torch_port_mlp_gp import GRAD_ATOL, GRAD_RTOL, VALUE_RTOL
from tpugan_torch.ops import mlp_gp as gp

SHAPES = [(64, 784, 512, 256), (1, 784, 512, 256), (7, 13, 100, 36), (65, 784, 512, 256)]
SMEM_LIMIT = 227 * 1024  # a CTA's shared memory on the H100
STATIC_SMEM = 1024  # the kernels' own: the column-sum scratch (ptxas: 640 bytes)


def _ids(shape):
    return "x".join(map(str, shape))


def _k_ranges(p):
    return [(r * p.kc, min((r + 1) * p.kc, p.k)) for r in range(p.ks)]


def _row_ranges(p):
    return [(min(gp.BM, r * p.rows), min(gp.BM, (r + 1) * p.rows)) for r in range(p.ks)]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_every_output_element_is_written_once(shape, direction):
    """Walks the CTAs as the kernel does: CTA i is rank i % ks of tile
    i // ks; the tile's columns, its row tiles (all of them in turn for the
    column sum) and the rank's epilogue rows."""
    for p in gp.plan(*shape, direction).products:
        elems = np.zeros((p.m, p.n), np.int32)
        cols = np.zeros(p.n, np.int32)  # the column sum's outputs, written by rank 0
        for i in range(p.ctas):
            rank, tile = i % p.ks, i // p.ks
            c0 = (tile % p.tiles_n) * p.bn
            r_lo, r_hi = _row_ranges(p)[rank]
            for m0 in range((tile // p.tiles_n) * gp.BM, p.m, p.tiles_m * gp.BM):
                elems[m0 + r_lo:min(p.m, m0 + r_hi), c0:c0 + p.bn] += 1
            if p.colsum and rank == 0:
                cols[c0:c0 + p.bn] += 1
        assert (elems == 1).all(), (p.name, np.unique(elems))
        if p.colsum:
            assert (cols == 1).all(), p.name


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_depth_ranges_partition_k_in_rank_order(shape, direction):
    for p in gp.plan(*shape, direction).products:
        ranges = _k_ranges(p)
        assert ranges[0][0] == 0 and ranges[-1][1] == p.k, p.name
        for (lo, hi), (nlo, _) in zip(ranges, ranges[1:] + [(p.k, None)]):
            assert lo < hi and hi == nlo, (p.name, ranges)
        assert p.kc % gp.BK == 0
        rows = _row_ranges(p)
        assert rows[0][0] == 0 and rows[-1][1] == gp.BM, (p.name, rows)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_clusters_and_shared_memory_fit_the_card(shape, direction):
    p = gp.plan(*shape, direction)
    assert all(1 <= q.ks <= gp.CLUSTER_MAX for q in p.products)
    assert all(q.ctas == q.ks * q.tiles_m * q.tiles_n for q in p.products)
    assert all(smem + STATIC_SMEM <= SMEM_LIMIT for smem in p.smem)
    assert p.smem == tuple(gp.smem_bytes(bn) for bn in p.bn)
    if direction == "fwd":
        assert p.grid == tuple(q.ctas for q in p.products)
    else:  # the second product of a launch: no split, on whole clusters after the first
        s, dw1, dw3, dw2 = p.products
        assert dw1.ks == dw2.ks == 1 and dw3.colsum and (dw1.bn, dw2.bn) == p.bn
        assert p.grid == (s.ctas + -(-dw1.ctas // s.ks) * s.ks,
                          dw3.ctas + -(-dw2.ctas // dw3.ks) * dw3.ks)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_every_product_fills_the_card_at_the_slice_shape(direction):
    p = gp.plan(64, 784, 512, 256, direction)
    assert len(p.products) == 4 and len(p.grid) == (4 if direction == "fwd" else 2)
    for q in p.products:
        assert q.ctas >= 100, q


def test_plan_rejects_what_no_kernel_runs():
    with pytest.raises(ValueError):
        gp.plan(64, 784, 512, 256, "sideways")
    with pytest.raises(ValueError):
        gp.plan(0, 784, 512, 256, "fwd")


def _split_k(a, b, p):
    """op(A) (M, K) @ op(B) (K, N) as the plan's ranks compute it: one
    partial a rank over its depth range, added in rank order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for lo, hi in _k_ranges(p):
        acc = acc + a[:, lo:hi] @ b[lo:hi, :]
    return acc


def _col_sum(v, mask, p):
    """sum over rows of mask * v, as the column-sum epilogue adds them: row
    tiles in turn; in each, every rank's rows in ascending order, then the
    ranks in order."""
    total = torch.zeros(v.shape[1])
    for m0 in range(0, p.m, gp.BM):
        tile = torch.zeros(v.shape[1])
        for r_lo, r_hi in _row_ranges(p):
            part = torch.zeros(v.shape[1])
            for r in range(m0 + r_lo, min(p.m, m0 + r_hi)):
                part = part + mask[r] * v[r]
            tile = tile + part
        total = total + tile
    return total.reshape(1, -1)


def _emulate_fwd(x, w1, b1, w2, b2, w3):
    z1p, z2p, tp, gp_ = gp.plan(x.shape[0], x.shape[1], w1.shape[0], w2.shape[0], "fwd").products
    z1 = _split_k(x, w1.T, z1p) + b1
    m1 = torch.where(z1 >= 0, 1.0, gp.SLOPE)
    z2 = _split_k(z1 * m1, w2.T, z2p) + b2
    m2 = torch.where(z2 >= 0, 1.0, gp.SLOPE)
    u = m2 * w3.reshape(1, -1)
    t = _split_k(u, w2, tp) * m1
    return _split_k(t, w1, gp_), m1, m2, u, t


def _emulate_bwd(q, m1, m2, w1, w2, u, t):
    sp, dw1p, dw3p, dw2p = gp.plan(q.shape[0], q.shape[1], w1.shape[0], w2.shape[0],
                                   "bwd").products
    s = _split_k(q, w1.T, sp) * m1
    return (_split_k(t.T, q, dw1p), _split_k(u.T, s, dw2p),
            _col_sum(_split_k(s, w2.T, dw3p), m2, dw3p))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_split_k_order_matches_the_plain_versions(shape):
    b, n0, n1, n2 = shape
    rng = np.random.default_rng(7)
    u = lambda *dims, fan_in: torch.from_numpy(
        (rng.uniform(-1, 1, dims) / np.sqrt(fan_in)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 0.7, (b, n0)).astype(np.float32))
    ins = (x, u(n1, n0, fan_in=n0), u(n1, fan_in=n0), u(n2, n1, fan_in=n1), u(n2, fan_in=n1),
           u(1, n2, fan_in=n2))
    got = _emulate_fwd(*ins)
    want = gp.mlp_gp_fwd_ref(*ins)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])  # masks
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=VALUE_RTOL,
                                   atol=VALUE_RTOL * float(w.abs().max()))
    g, m1, m2, uu, t = want
    q = gp.q_from(g, gp.norm_penalty(g)[1], 1.0)
    res = (q, m1, m2, ins[1], ins[3], uu, t)
    for a, w in zip(_emulate_bwd(*res), gp.mlp_gp_bwd_ref(*res)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_the_c_struct_carries_the_plan():
    p, c, _ = gp._plan_arg(64, 784, 512, 256, "bwd", True)
    assert (c.b, c.n0, c.n1, c.n2, c.pdl) == (64, 784, 512, 256, 1)
    assert list(c.bn)[:2] == list(p.bn) and list(c.grid)[:2] == list(p.grid)
    assert [(c.prod[i].ks, c.prod[i].kc, c.prod[i].rows, c.prod[i].ctas) for i in range(4)] == [
        (q.ks, q.kc, q.rows, q.ctas) for q in p.products]


def test_launchers_refuse_cpu_tensors():
    """The launch path itself checks the device: a CPU tensor that reached
    it would raise, not run (the wrappers send CPU tensors to the plain
    versions before that)."""
    x = torch.randn(4, 16)
    w1, w2 = torch.randn(8, 16), torch.randn(8, 8)
    with pytest.raises(ValueError, match="expected all on cuda"):
        gp._launch_fwd(x, w1, torch.randn(8), w2, torch.randn(8), torch.randn(1, 8))
