"""The port's CUDA kernels on an NVIDIA card against their plain torch
versions on the same inputs (tolerance 0: exact integer arithmetic), the
rank path on the card against its own CPU run, and the factorization's
consumers and tools after a card factorization (chip_smoke.py's phase
8 at small size).

Every test here is marked `cuda` and skips without a card.  On a machine
with one (--noconftest: tests/conftest.py imports JAX, which these tests
do not need):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_checks import (b2_panel, b3_panel, combine_inputs,
                         deficient_panel, panel_block, random_waves,
                         scc_banded, upper_triangular)
from spasm_tpu_torch import (CSR, EchelonizeOptions, _cuda,
                             dulmage_mendelsohn, echelonize, gesv, kernel,
                             kernel_from_rref, rank_certificate_create,
                             rank_certificate_verify, rref, sio)
from spasm_tpu_torch.checkpoint import matrix_fingerprint
from spasm_tpu_torch.certificate import factorization_verify
from spasm_tpu_torch.dense import modp_matmul
from spasm_tpu_torch.dense.elim import (_submod, dense_lu_device,
                                        dense_rref_device)
from spasm_tpu_torch.dense.modp import (device_field, matmul_digits,
                                        modp_matmul_np, storage_dtype)
from spasm_tpu_torch.dense.reduced import (ReducedBasis, _ref_combine,
                                           gather_combine)
from spasm_tpu_torch.dense.panel import (CLUSTER_ROWS, _panel_plain,
                                         panel_pivots, panel_variant)
from spasm_tpu_torch.dense.rowrref import (CLUSTER_COLS, TILE_W,
                                           _row_sweep_plain,
                                           _row_sweep_tiles_plain,
                                           rref_rows_device, row_sweep,
                                           row_sweep_tiles, row_sweep_variant)
from spasm_tpu_torch.dense.subst import (SUBST_COLS, _subst_waves_plain,
                                         nred_for, nred_wide, subst_waves,
                                         wide_plan, wide_resident)
from spasm_tpu_torch.device_csr import DeviceCSR
from spasm_tpu_torch.field import Field
from spasm_tpu_torch.gen import matching_complex_boundary, synthetic_sparse
from spasm_tpu_torch.schur import _pack_nonzero_device
from spasm_tpu_torch.spmv import xApy

pytestmark = pytest.mark.cuda

MATRIX = pathlib.Path(__file__).parent / "Matrix"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    _cuda.lib()
    return torch.device("cuda")


def _b1_check(dev, waves, M, p, seed):
    """B1 on the card against its plain version, on R's storage for p
    (int16, or int32 above 65535: the "B1 wide" kernel): one launch per
    call, counted under its own name only."""
    rows, ptr, refs, coef, bounds = waves
    n = len(rows)
    rng = np.random.default_rng(seed)
    R0 = torch.from_numpy(
        rng.integers(-(p // 2), p // 2 + 1, (n + 64, M))).to(storage_dtype(p))
    R0[n:] = 0
    want = R0.to(dev)
    _subst_waves_plain(want, rows, ptr, refs, coef, bounds, p)
    got = R0.to(dev)
    before = dict(_cuda.launches), dict(_cuda.calls)
    subst_waves(got, rows, ptr, refs, coef, bounds, p)
    torch.cuda.synchronize()
    key, other = ("B1", "B1 wide") if p <= 65535 else ("B1 wide", "B1")
    assert _cuda.launches[key] - before[0][key] == 1
    assert _cuda.calls[key] - before[1][key] == 1
    assert _cuda.launches[other] == before[0][other]
    assert torch.equal(got, want)


@pytest.mark.parametrize("p", [257, 42013])
@pytest.mark.parametrize("M", [2048, 20480, 22528])
def test_b1_matches_plain(dev, p, M):
    rng = np.random.default_rng([p, M])
    _b1_check(dev, random_waves(rng, 3000, 40, 12, p), M, p, [p, M, 1])


@pytest.mark.parametrize("M", [2048, 20480, 22528])
def test_b1_one_row_waves_many_refs(dev, M):
    """Waves of one row each, rows with up to 12 references at p = 65269,
    where nred = 2: many reductions per row and one row per barrier."""
    p = 65269
    assert nred_for(p) == 2
    rng = np.random.default_rng([M, 11])
    waves = random_waves(rng, 300, 300, 12, p)
    assert np.all(np.diff(waves[4]) == 1)
    assert np.diff(waves[1]).max() > nred_for(p)
    _b1_check(dev, waves, M, p, [M, 12])


@pytest.mark.parametrize("p", [65521, 65537, 16711421, 16711427,
                               4294967291])
@pytest.mark.parametrize("M", [2048, 20480, 16896, 22528])
def test_b1_wide_matches_plain(dev, p, M):
    """Above the d = 2 tier: int16 storage at 65521 (the existing kernel,
    nred = 2), the int32 kernel above 65535 (64-bit products), at widths
    whose chunks all fit the card at once (16896 = 64 x 264: the old
    int32 kernel's two blocks per SM; 20480 and 22528 past it)."""
    rng = np.random.default_rng([p, M])
    _b1_check(dev, random_waves(rng, 3000, 40, 12, p), M, p, [p, M, 1])


@pytest.mark.parametrize("p", [65537, 4294967291, 16711427])
def test_b1_wide_one_row_waves_many_refs(dev, p):
    """One row per wave, up to 40 references, more than nred_wide (16 at
    65537 and 16711427; 2 at 2^32 - 5, with products near 2^62): a row
    reduces several times."""
    rng = np.random.default_rng([p, 11])
    waves = random_waves(rng, 300, 300, 40, p)
    waves[3][::2] = p // 2                  # the largest coefficients
    assert np.diff(waves[1]).max() > nred_wide(p)
    _b1_check(dev, waves, 20480, p, [p, 12])


@pytest.mark.parametrize("p", [65537, 4294967291])
def test_b1_wide_unit_coefficients(dev, p):
    """Coefficients +-1 and 0, as a boundary map's (mk12.b4's) are: the
    wrapper's nred is 16 at any p, and rows of up to 40 references
    reduce after every 16th product, at values up to p // 2."""
    rng = np.random.default_rng([p, 13])
    waves = random_waves(rng, 600, 200, 40, p)
    waves[3][:] = rng.integers(-1, 2, waves[3].size)
    assert nred_wide(p, 1) == 16 and np.diff(waves[1]).max() > 16
    _b1_check(dev, waves, 20480, p, [p, 13])


def test_b1_wide_resident_blocks(dev):
    """Three blocks of the int32 kernel fit an SM (56 registers), as the
    int16 kernel's do: the 320 chunks of mk12.b4's M = 20480 all run at
    once on an H100's 132 SMs."""
    bps, sms = wide_resident(torch.cuda.current_device())
    assert bps >= 3
    assert _cuda.lib().spasm_subst_blocks_per_sm(0) >= 3
    if sms >= 132:
        assert wide_plan(20480 // SUBST_COLS, bps * sms) == (320, 1)


@pytest.mark.parametrize("extra", [1, 5, -1])
@pytest.mark.parametrize("p", [65537, 4294967291])
def test_b1_wide_chunks_beyond_resident(dev, p, extra):
    """More chunks than resident blocks: every block owns two (extra = 1:
    one chunk past the resident ones, so the last block owns one) or
    three (extra = 5, from twice the resident count on), walked
    interleaved in each wave; extra = -1 fills every resident block
    once."""
    bps, sms = wide_resident(torch.cuda.current_device())
    res = bps * sms
    nchunks = res + extra if extra < 5 else 2 * res + extra
    grid, per = wide_plan(nchunks, res)
    assert grid <= res and per == (1 if extra < 0 else 2 if extra == 1
                                   else 3)
    rng = np.random.default_rng([p, extra + 1])
    _b1_check(dev, random_waves(rng, 1200, 30, 12, p), nchunks * SUBST_COLS,
              p, [p, extra + 1, 2])


@pytest.mark.parametrize("p", [65537, 4294967291])
def test_wide_routes_card_match_cpu(dev, p):
    """The d >= 3 routes on the card (the torch step sweep of
    rref_rows_device; the torch panels of dense_lu_device and of
    dense_rref_device, two 512-column blocks, int64 products) equal the
    same calls on the CPU, and launch no kernel."""
    rng = np.random.default_rng([p, 5])
    W = rng.integers(-3, 4, (256, 90))
    G = rng.integers(-(p // 2), p // 2 + 1, (90, 4096))
    X = (W @ G) % p
    X = np.where(X > p // 2, X - p, X)
    X[:, -1] = 0
    X = torch.from_numpy(X.astype(np.int32))
    before = dict(_cuda.launches)
    want = rref_rows_device(X.clone(), p, nb=128)
    got = rref_rows_device(X.to(dev), p, nb=128)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    want = dense_lu_device(X[:200, :700], p)
    got = dense_lu_device(X[:200, :700].to(dev), p)
    for a, b in zip(want[:2], got[:2]):
        assert np.array_equal(a, b)
    for a, b in zip(want[2:], got[2:]):
        assert torch.equal(a, b.cpu())
    assert want[0].size == 90
    R, pc = dense_rref_device(X[:200, :1100], p)
    Rd, pcd = dense_rref_device(X[:200, :1100].to(dev), p)
    assert np.array_equal(pc, pcd) and pc.size == 90
    assert torch.equal(Rd.cpu(), R)
    assert dict(_cuda.launches) == before


@pytest.mark.parametrize("p", [65521, 65537, 4294967291])
def test_d2_kernels_refuse_wide_primes(dev, p):
    """B2, B3 and B4 take the d = 2 tier only: a larger prime raises
    before any launch (the wide variants are ROADMAP B8)."""
    P = torch.zeros((64, 2048), dtype=torch.int32, device=dev)
    before = dict(_cuda.launches)
    with pytest.raises(NotImplementedError):
        row_sweep(P.clone(), p)
    with pytest.raises(NotImplementedError):
        row_sweep_tiles(P.clone(), p)
    with pytest.raises(NotImplementedError):
        panel_pivots(P[:, :64], torch.zeros(64, dtype=torch.bool,
                                            device=dev), p, 64, True)
    assert dict(_cuda.launches) == before


# the d >= 3 primes of tests/test_torch_reduced.py (65521 on int16 R)
WIDE = [65521, 65537, 16711421, 16711427, 67108859, 4294967291]
# (S, K, w, live share, zero_last): K = 8 (round 0's Schur blocks) on a
# full tile; K ~ 1,100 mostly dead (the finisher's rows at 2^32 - 5) on a
# ragged tile; a column shard (base > 0, its last column kept); S not a
# multiple of the kernel's 4 rows throughout
B12_SHAPES = {"k8": (301, 8, 2048, 0.9, True),
              "k1104": (301, 1104, 1088, 0.06, True),
              "shard": (130, 40, 640, 0.3, False),
              "k32808": (5, (1 << 15) + 40, 64, 0.5, True)}
B12_CASES = [(p, c) for p in WIDE for c in ("k8", "k1104", "shard")] + [
    (p, "k32808") for p in WIDE if device_field(p).ndigits == 3]


@pytest.mark.parametrize("p,case", B12_CASES)
def test_b12_matches_plain(dev, p, case):
    """Kernel B12 against its plain version (the torch slot loop on the
    CPU, then the balanced difference): bit-equal, one launch, with rows
    of dead slots only and the largest coefficients on every slot
    (chip_checks.combine_inputs)."""
    S, K, w, live, last = B12_SHAPES[case]
    X, V, R, refs = combine_inputs(np.random.default_rng([p, K, w]), S, K,
                                   w, p, live)
    Rt = torch.from_numpy(R).to(storage_dtype(p))
    want = _submod(torch.from_numpy(X), _ref_combine(
        torch.from_numpy(V), Rt, torch.from_numpy(refs), p), p)
    if last:
        want[:, -1] = 0
    before = dict(_cuda.launches)
    got = gather_combine(torch.from_numpy(X).to(dev),
                         torch.from_numpy(V).to(dev), Rt.to(dev),
                         torch.from_numpy(refs).to(dev), p, R.shape[0] - 1,
                         last)
    torch.cuda.synchronize()
    assert _cuda.launches["B12"] - before["B12"] == 1
    assert all(_cuda.launches[k] == before[k] for k in before if k != "B12")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("p", [65521, 4294967291])
@pytest.mark.parametrize("weighted", [False, True])
def test_b12_form_block_card_matches_cpu(dev, p, weighted):
    """ReducedBasis.form_block on the card (kernel B12, one launch a
    chunk of rows) equals the same block formed on the CPU (the slot
    loop), on mk10.b3's reduced basis: plain rows, and weighted
    combinations of three rows as the low-rank mode draws them."""
    from spasm_tpu_torch.echelonize import _Engine
    B = matching_complex_boundary(10, 3)
    A = CSR(B.n, B.m, Field(p), B.indptr, B.indices, B.data)
    eng = _Engine(A, EchelonizeOptions(), "cpu")
    eng.extract_structural(A)
    qfree = np.nonzero(eng.U.qinv < 0)[0]
    store = eng.U.flat_store()
    bases = []
    for d in ("cpu", dev):
        rb = ReducedBasis(A.m, p, qfree, eng.U.n, d)
        rb.build(*store)
        rb.set_entries(A.indices, A.data, A.nnz)
        bases.append(rb)
    rng = np.random.default_rng([p, weighted])
    rows = rng.integers(0, A.n, (1500, 3 if weighted else 1))
    coeffs = (rng.integers(-(p // 2), p // 2 + 1, rows.shape)
              if weighted else None)
    eidx, coeff = bases[0].flat_rows(A.indptr, rows, coeffs)
    rb = bases[1]
    rb._GATHER_BUDGET = 512 * rb.M               # chunks of 512 rows
    before = _cuda.launches["B12"]
    got = rb.form_block(eidx, coeff, Bp=2048)
    torch.cuda.synchronize()
    assert _cuda.launches["B12"] - before == 4
    assert torch.equal(got.cpu(), bases[0].form_block(eidx, coeff, Bp=2048))


@pytest.mark.parametrize("case", ["rank40", "zero", "full", "boundary"])
@pytest.mark.parametrize("nb", [1, 17, 64])
@pytest.mark.parametrize("M", [2048, 22528])
@pytest.mark.parametrize("p", [3, 42013, 65269])
def test_b2_matches_plain(dev, M, p, nb, case):
    """Both B2 variants (cluster at M = 2048, the pair beyond the cluster's
    capacity) bit-equal to the plain version, with their launch counts."""
    P0 = torch.from_numpy(b2_panel(np.random.default_rng([M, p, nb]), case,
                                   nb, M, p))
    want = P0.to(dev)
    piv_want = _row_sweep_plain(want, p)
    got = P0.to(dev)
    variant = row_sweep_variant(nb, M)
    assert variant == ("cluster" if M <= CLUSTER_COLS else "pair")
    before = dict(_cuda.launches)
    piv = row_sweep(got, p)
    torch.cuda.synchronize()
    n = 1 if variant == "cluster" else 2 * nb
    assert _cuda.launches["B2"] - before["B2"] == n
    assert _cuda.launches[f"B2 {variant}"] - before[f"B2 {variant}"] == n
    assert torch.equal(piv, piv_want)
    assert torch.equal(got, want)
    if case == "full":
        assert bool((piv >= 0).all())
    if case == "zero":
        assert bool((piv < 0).all())


@pytest.mark.parametrize("M", [2 * TILE_W, 22528])
@pytest.mark.parametrize("p", [3, 42013, 65269])
def test_b3_matches_plain(dev, M, p):
    P0 = torch.from_numpy(deficient_panel(np.random.default_rng([M, p, 3]),
                                          64, M, 40, p,
                                          empty_cols=TILE_W + 100))
    want = P0.to(dev)
    piv_want = _row_sweep_tiles_plain(want, p)
    got = P0.to(dev)
    piv = row_sweep_tiles(got, p)
    torch.cuda.synchronize()
    assert torch.equal(piv, piv_want)
    assert torch.equal(got, want)


B3_CASES = ["full", "rank40", "staircase", "zero", "empty_lead",
            "row_first_tile_empty"]


@pytest.mark.parametrize("case", B3_CASES)
@pytest.mark.parametrize("M", [1024, 22528])
@pytest.mark.parametrize("p", [3, 42013, 65269])
def test_b3_cases_match_plain(dev, case, M, p):
    """One launch per sweep, bit-equal to the plain version, and the
    live-tile histogram counts the sweep once."""
    from spasm_tpu_torch.dense.rowrref import live_tile_histogram
    P0 = torch.from_numpy(b3_panel(np.random.default_rng([p, M, 7]), case,
                                   M, p))
    want = P0.to(dev)
    piv_want = _row_sweep_tiles_plain(want, p)
    got = P0.to(dev)
    hist = live_tile_histogram(dev)
    hist.zero_()
    before = _cuda.launches["B3"]
    piv = row_sweep_tiles(got, p)
    torch.cuda.synchronize()
    assert _cuda.launches["B3"] - before == 1
    assert torch.equal(piv, piv_want)
    assert torch.equal(got, want)
    assert int(hist.sum()) == 1
    if case == "staircase":
        assert int(hist[M // TILE_W]) == 1
    if case == "zero":
        assert int(hist[0]) == 1


@pytest.mark.parametrize("rref", [True, False])
@pytest.mark.parametrize("n", [128, 1024, 4608, CLUSTER_ROWS,
                               CLUSTER_ROWS + 1])
@pytest.mark.parametrize("p", [3, 42013, 65269])
def test_b4_variants_match_plain(dev, n, p, rref):
    """Both B4 variants, across the threshold, bit-equal to the plain
    version; each call launches the variant that n selects, once."""
    X, is_piv = panel_block(np.random.default_rng([n, p, 5]), n, p)
    Xd = torch.from_numpy(X).to(dev)
    P0 = Xd[:, 64:128]
    ip = torch.from_numpy(is_piv).to(dev)
    want = _panel_plain(P0, ip, p, 64, rref)
    variant = panel_variant(n)
    assert variant == ("cluster" if n <= CLUSTER_ROWS else "cooperative")
    before = dict(_cuda.launches)
    got = panel_pivots(P0, ip, p, 64, rref)
    torch.cuda.synchronize()
    assert _cuda.launches[f"B4 {variant}"] - before[f"B4 {variant}"] == 1
    other = "cooperative" if variant == "cluster" else "cluster"
    assert _cuda.launches[f"B4 {other}"] == before[f"B4 {other}"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rref", [True, False])
@pytest.mark.parametrize("n", [1024, 4608])
@pytest.mark.parametrize("p", [3, 42013, 65269])
def test_b4_matches_plain(dev, n, p, rref):
    X, is_piv = panel_block(np.random.default_rng([n, p]), n, p)
    Xd = torch.from_numpy(X).to(dev)
    P0 = Xd[:, 64:128]                    # through the block's row stride
    ip = torch.from_numpy(is_piv).to(dev)
    want = _panel_plain(P0, ip, p, 64, rref)
    key = "B4 rref" if rref else "B4 lu"
    before = _cuda.launches[key]
    got = panel_pivots(P0, ip, p, 64, rref)
    torch.cuda.synchronize()
    assert _cuda.launches[key] - before == 1
    assert len(got) == len(want) == (4 if rref else 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(Xd.cpu(), torch.from_numpy(X))   # input untouched


@pytest.mark.parametrize("shape", [(300, 1000), (1100, 1500)])
def test_dense_elim_card_matches_cpu(dev, shape):
    """The column-sweep RREF and LU (B4 + digit matmuls) on the card
    against the same code on the CPU (plain B4)."""
    p = 42013
    rng = np.random.default_rng(list(shape))
    n, m = shape
    X = (rng.integers(0, p, (n, 200)) @ rng.integers(0, p, (200, m))) % p
    X = torch.from_numpy(np.where(X > p // 2, X - p, X).astype(np.int32))
    R, pc = dense_rref_device(X, p)
    Rd, pcd = dense_rref_device(X.to(dev), p)
    assert np.array_equal(pc, pcd) and pc.size == 200
    assert torch.equal(Rd.cpu(), R)
    want = dense_lu_device(X, p)
    got = dense_lu_device(X.to(dev), p)
    for a, b in zip(want[:2], got[:2]):
        assert np.array_equal(a, b)
    for a, b in zip(want[2:], got[2:]):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("name", ["mat364.sms", "trefethen_2000.sms"])
def test_complete_pluq_card_matches_cpu(dev, name):
    A, _ = sio.load_csr(MATRIX / name, 42013)
    opts = EchelonizeOptions(complete=True)
    want = echelonize(A, opts, device="cpu")
    got = echelonize(A, opts, device="cuda")
    assert got.r == want.r
    assert np.array_equal(got.qinv, want.qinv)
    assert np.array_equal(got.p, want.p)
    for a, b in ((got.U, want.U), (got.L, want.L)):
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
        assert np.array_equal(a.data[:a.nnz], b.data[:b.nnz])
    assert factorization_verify(A, got, 42)


@pytest.mark.parametrize("p", [42013, 65537, 16711427, 4294967291])
@pytest.mark.parametrize("shape", [(4, 8, 3), (17, 40, 9), (4096, 4096, 2048),
                                   (64, 64, 22528), (80, 80, 80),
                                   (40, 128, 512), (136, 24, 1024),
                                   (96, 40000, 64)])
def test_matmul_digits_card_matches_cpu(dev, shape, p):
    """All three digit tiers; k = 40000 crosses _k_chunk at d = 3 / 4."""
    n, k, m = shape
    rng = np.random.default_rng(list(shape))
    A = torch.from_numpy(rng.integers(-(p // 2), p // 2 + 1, (n, k))
                         .astype(np.int32))
    B = torch.from_numpy(rng.integers(-(p // 2), p // 2 + 1, (k, m))
                         ).to(storage_dtype(p))
    want = matmul_digits(A, B, p)
    got = matmul_digits(A.to(dev), B.to(dev), p)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("p", [42013, 4294967291])
@pytest.mark.parametrize("shape", [(33, 57, 29), (1024, 1024, 1024)])
def test_modp_matmul_card_matches_cpu(dev, shape, p):
    """The `dense` export on its default device (the card) against its
    CPU run, d = 2 and d = 4; numpy in, the product left on the card."""
    n, k, m = shape
    rng = np.random.default_rng([p % 1000, n])
    A = rng.integers(-(p // 2), p // 2 + 1, (n, k)).astype(np.int32)
    B = rng.integers(-(p // 2), p // 2 + 1, (k, m)).astype(np.int32)
    got = modp_matmul(A, B, p)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    want = modp_matmul(A, B, p, device="cpu")
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(modp_matmul_np(A, B, p), want.numpy())


@pytest.mark.parametrize("name", ["mat364.sms", "lower_trapeze.sms",
                                  "trefethen_500.sms"])
def test_echelonize_card_matches_cpu(dev, name):
    A, _ = sio.load_csr(MATRIX / name, 42013)
    opts = EchelonizeOptions(device_dense_min=0)
    want = echelonize(A, opts, device="cpu")
    before = _cuda.launches["B2"]
    got = echelonize(A, opts, device="cuda")
    assert got.r == want.r
    assert _cuda.launches["B2"] > before
    assert np.array_equal(got.qinv, want.qinv)
    Ug, Uw = got.U, want.U
    assert np.array_equal(Ug.indptr, Uw.indptr)
    assert np.array_equal(Ug.indices[:Ug.nnz], Uw.indices[:Uw.nnz])
    assert np.array_equal(Ug.data[:Ug.nnz], Uw.data[:Uw.nnz])


@pytest.mark.parametrize("name,opts,key", [
    ("trefethen_500.sms", dict(device_dense_min=0), "B2"),
    ("trefethen_2000.sms", dict(complete=True), "B4 lu")])
def test_cpu_checkpoint_resumes_on_card(dev, name, opts, key, tmp_path):
    """A file written by a CPU run preempted after its first save
    (PHASE_FINISH) resumes on the card bit-equal to the uninterrupted
    CPU run: trefethen_500 through the device finisher (B2 sweeps), and
    trefethen_2000's complete PLUQ through finish_dense (B4 LU); the
    restored chunk basis is composed on the card."""
    from spasm_tpu_torch import checkpoint as ckpt
    from spasm_tpu_torch.echelonize import _Engine
    A, _ = sio.load_csr(MATRIX / name, 42013)
    want = echelonize(A, EchelonizeOptions(**opts), device="cpu")
    ckfile = str(tmp_path / "cpu.ck")
    ck = EchelonizeOptions(checkpoint_file=ckfile, **opts)
    real = ckpt.save_checkpoint

    class Preempt(Exception):
        pass

    def preempted(*a, **kw):
        real(*a, **kw)
        raise Preempt

    ckpt.save_checkpoint = preempted
    try:
        with pytest.raises(Preempt):
            echelonize(A, ck, device="cpu")
    finally:
        ckpt.save_checkpoint = real
    state = ckpt.load_checkpoint(ckfile, ckpt.matrix_fingerprint(A),
                                 A.prime, ck.complete, ck.complete)
    assert int(state["phase"]) == ckpt.PHASE_FINISH
    eng = _Engine(A, EchelonizeOptions(L=ck.complete, **opts), dev)
    ckpt.restore_engine(eng, state)
    eng.elim.flush()
    assert all(t.device.type == "cuda" for run in eng.elim.runs
               for t in run if isinstance(t, torch.Tensor))
    before = _cuda.launches[key]
    got = echelonize(A, ck, device="cuda")
    assert _cuda.launches[key] > before
    assert not pathlib.Path(ckfile).exists()
    assert got.r == want.r and np.array_equal(got.qinv, want.qinv)
    assert _same_csr(got.U, want.U)
    if ck.complete:
        assert np.array_equal(got.p, want.p) and _same_csr(got.L, want.L)


@pytest.mark.parametrize("p", [257, 42013, 65269, 65537, 4294967291])
def test_densify_card_matches_cpu(dev, p):
    """DeviceCSR.densify on the card against the CPU: duplicate entries,
    the dead column, rows past len(rows)."""
    rng = np.random.default_rng(p)
    lens = rng.integers(0, 40, 3000)
    indptr = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    cols = rng.integers(0, 5000, int(indptr[-1])).astype(np.int32)
    cols[1::4] = cols[::4][:cols[1::4].size]
    vals = rng.integers(-(p // 2), p // 2 + 1, cols.size).astype(np.int32)
    A = CSR(3000, 5000, Field(p), indptr, cols, vals)
    rows = rng.permutation(3000)[:2000]
    want = DeviceCSR(A, device="cpu").densify(rows, Bp=2048)
    got = DeviceCSR(A, device=dev).densify(rows, Bp=2048)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(2048, 52224, 51975), (8192, 20480, 20107),
                                   (37, 64, 60)])
def test_pack_nonzero_card_matches_cpu(dev, shape):
    """The nonzero packing (row-major nonzero, one stacked copy) on the
    card against the CPU, at the main path's block
    shapes (L-mode Schur blocks, reduced-basis blocks)."""
    B, mp, m = shape
    gen = torch.Generator().manual_seed(B)
    X = torch.randint(-20000, 20001, (B, mp), dtype=torch.int32,
                      generator=gen)
    X[torch.rand((B, mp), generator=gen) < 0.99] = 0
    X[B - 5:] = 3                        # padded rows, left out below
    X = X.to(torch.int16)
    want = _pack_nonzero_device(X, B - 5, m)
    got = _pack_nonzero_device(X.to(dev), B - 5, m)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("opts", [dict(device_dense_width=0),
                                  dict(complete=True)])
def test_mk10_rounds_card_matches_cpu(dev, opts):
    """mk10.b3's round loop (round 0, the sparse Schur complement, round
    1, GPLU) on the card against its CPU run: rank, qinv, U (and L, p)."""
    A = matching_complex_boundary(10, 3)
    A = A.transpose() if A.n < A.m else A
    o = EchelonizeOptions(**opts)
    want = echelonize(A, o, device="cpu")
    got = echelonize(A, o, device="cuda")
    assert got.r == want.r == 2564 and got.rounds == want.rounds
    assert np.array_equal(got.qinv, want.qinv)
    pairs = [(got.U, want.U)]
    if o.complete:
        assert np.array_equal(got.p, want.p)
        pairs.append((got.L, want.L))
    for a, b in pairs:
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
        assert np.array_equal(a.data[:a.nnz], b.data[:b.nnz])


def _same_csr(a, b):
    return ((a.n, a.m) == (b.n, b.m) and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices[:a.nnz], b.indices[:b.nnz])
            and np.array_equal(a.data[:a.nnz], b.data[:b.nnz]))


@pytest.mark.parametrize("p", [42013, 4294967291])
def test_certificate_and_gesv_after_card_pluq(dev, p):
    """(a) / (e) of chip_smoke.py's tools phase: a complete PLUQ on the
    card (B4 LU at 42013) equal to the CPU one; its rank certificate the
    CPU one's and true; gesv on B = X.A plus one random row: the same
    X and ok as on the CPU factorization, X'.A == B where ok."""
    A = synthetic_sparse(1500, 1500, 8, p)
    opts = EchelonizeOptions(complete=True)
    want = echelonize(A, opts, device="cpu")
    got = echelonize(A, opts, device="cuda")
    assert got.r == want.r and np.array_equal(got.p, want.p)
    assert _same_csr(got.U, want.U) and _same_csr(got.L, want.L)
    h = matrix_fingerprint(A)
    cg, cw = (rank_certificate_create(A, h, f) for f in (got, want))
    for f in ("r", "i", "j", "x", "y"):
        assert np.array_equal(getattr(cg, f), getattr(cw, f))
    assert rank_certificate_verify(A, h, cg)
    rng = np.random.default_rng(1)
    rows = []
    for x in rng.integers(0, p, (16, A.n)):
        b = np.zeros(A.m, np.int32)
        xApy(A.field.narray(x).astype(np.int32), A, b)
        rows.append((np.nonzero(b)[0].astype(np.int32), b[b != 0]))
    b = A.field.narray(rng.integers(0, p, A.m)).astype(np.int32)
    rows.append((np.nonzero(b)[0].astype(np.int32), b[b != 0]))
    B = CSR.from_rows(17, A.m, p, rows)
    Xg, okg = gesv(got, B)
    Xw, okw = gesv(want, B)
    assert _same_csr(Xg, Xw) and np.array_equal(okg, okw)
    assert okg[:16].all() and okg[16] == (got.r == A.m)
    for i in np.nonzero(okg)[0]:
        x = np.zeros(Xg.m, np.int32)
        c, v = Xg.row(i)
        x[c] = v
        y = np.zeros(A.m, np.int32)
        xApy(x, A, y)
        w = np.zeros(A.m, np.int32)
        c, v = B.row(i)
        w[c] = v
        assert np.array_equal(y, w)


def test_kernel_after_card_echelonize(dev):
    """(b): the kernel basis of a wide rank-deficient synthetic matrix
    factored on the card with default options: equal to the CPU one's,
    kernel_from_rref(*rref(fact)) bit-equal to it, A.K^T = 0."""
    A = synthetic_sparse(1000, 1512, 8, 42013)
    got = echelonize(A, device="cuda")
    want = echelonize(A, device="cpu")
    K = kernel(got)
    assert K.n == A.m - got.r >= 512
    assert _same_csr(K, kernel(want))
    assert _same_csr(K, kernel_from_rref(*rref(got)))
    At = A.transpose()
    for i in range(K.n):
        x = np.zeros(K.m, np.int32)
        c, v = K.row(i)
        x[c] = v
        y = np.zeros(At.m, np.int32)
        xApy(x, At, y)
        assert not np.any(y)


def test_dm_and_certificate_on_config5_shapes(dev):
    """(c) at a tenth of bench.py config 5: DM of the banded SCC instance
    (n / 8 + 2 blocks) and the certificate of the upper-triangular one,
    factored on the card."""
    n = 12000
    assert dulmage_mendelsohn(scc_banded(n, 8, 4 * n, 42013)).nb == n // 8 + 2
    A = upper_triangular(n, 42013)
    fact = echelonize(A, EchelonizeOptions(L=True, complete=True),
                      device="cuda")
    h = matrix_fingerprint(A)
    proof = rank_certificate_create(A, h, fact)
    assert proof.r == n and rank_certificate_verify(A, h, proof)


def _tool(args, stdin=None):
    return subprocess.run(
        [sys.executable, "-m", f"spasm_tpu_torch.cli.{args[0]}"] + args[1:],
        input=stdin, capture_output=True, timeout=600,
        cwd=MATRIX.parent.parent)


def test_tools_fresh_processes_on_card(dev, tmp_path):
    """(d) on trefethen_500: rank -c certifies, check_cert accepts the
    certificate on the matrix and refuses it on another, echelonize
    --rref writes rref() of the CPU factorization, kernel and solve run."""
    t500 = MATRIX / "trefethen_500.sms"
    cert = tmp_path / "cert.txt"
    r = _tool(["rank", "-c", "-o", str(cert)], stdin=t500.read_bytes())
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.decode().strip() == "500"
    assert b"CORRECT certificate" in r.stderr
    assert _tool(["check_cert", "-c", str(cert), "--matrix",
                  str(t500)]).returncode == 0
    assert _tool(["check_cert", "-c", str(cert), "--matrix",
                  str(MATRIX / "small.sms")]).returncode == 1
    A, _ = sio.load_csr(t500, 42013)
    want = io.StringIO()
    sio.save_csr(rref(echelonize(A, device="cpu"))[0], want)
    r = _tool(["echelonize", "--rref", "--matrix", str(t500)])
    assert r.returncode == 0 and r.stdout == want.getvalue().encode()
    sing = str(MATRIX / "singular.sms")
    r = _tool(["kernel", "--modulus", "257", "--matrix", sing])
    assert r.returncode == 0
    assert sio.load_csr(io.BytesIO(r.stdout), 257)[0].n == 1
    assert _tool(["solve", "--modulus", "257", "--rhs", sing, "--matrix",
                  sing]).returncode == 0


# -- the mesh on the card (spasm_tpu_torch/parallel/) --------------------

def _card_mesh(dev, n=4):
    """n x cuda:0: on one card the mesh repeats its device, so every
    sharded stage, split shape and kernel launch runs on it."""
    from spasm_tpu_torch.parallel import make_mesh
    return make_mesh(devices=[dev] * n)


@pytest.mark.parametrize("shape", [(300, 1000), (1100, 1500)])
def test_mesh_eliminate_matches_single_card(dev, shape):
    """The column-sharded `_eliminate` ((2, 2) mesh of cuda:0, B4 on the
    owner shard of each 512-column block) in RREF and LU mode, through
    dense_rref_device / dense_lu_device, bit-equal to the single-card
    run; B4 launches in both modes."""
    from spasm_tpu_torch.parallel import use_mesh
    p = 42013
    rng = np.random.default_rng(list(shape))
    n, m = shape
    X = (rng.integers(0, p, (n, 200)) @ rng.integers(0, p, (200, m))) % p
    X = torch.from_numpy(np.where(X > p // 2, X - p, X).astype(np.int32))
    Xd = X.to(dev)
    want_r, want_lu = dense_rref_device(Xd, p), dense_lu_device(Xd, p)
    before = dict(_cuda.launches)
    with use_mesh(_card_mesh(dev)):
        got_r, got_lu = dense_rref_device(Xd, p), dense_lu_device(Xd, p)
    torch.cuda.synchronize()
    assert np.array_equal(got_r[1], want_r[1])
    assert torch.equal(got_r[0], want_r[0])
    for a, b in zip(want_lu[:2], got_lu[:2]):
        assert np.array_equal(a, b)
    for a, b in zip(want_lu[2:], got_lu[2:]):
        assert torch.equal(a, b)
    assert all(_cuda.launches[k] > before[k] for k in ("B4 rref", "B4 lu"))


@pytest.mark.parametrize("p", [42013, 4294967291])
def test_mesh_reduced_basis_matches_single_card(dev, p):
    """ReducedBasis.build under a (2, 2) mesh of cuda:0: B1 (B1 wide at
    2^32 - 5) once per column shard on the same schedule; the gathered R
    is the single-card R, and each shard is its plain version's."""
    from spasm_tpu_torch.dense.reduced import ReducedBasis
    from spasm_tpu_torch.echelonize import _Engine
    from spasm_tpu_torch.parallel import use_mesh
    B = matching_complex_boundary(10, 3)
    if B.n < B.m:                            # the rank tool's orientation
        B = B.transpose()
    A = CSR(B.n, B.m, Field(p), B.indptr, B.indices, B.data)
    eng = _Engine(A, EchelonizeOptions(), dev)
    eng.extract_structural(A)
    qfree = np.nonzero(eng.U.qinv < 0)[0]
    store = eng.U.flat_store()
    want = ReducedBasis(A.m, p, qfree, eng.U.n, dev)
    want.build(*store)
    key = "B1" if p <= 65535 else "B1 wide"
    before = _cuda.launches[key]
    with use_mesh(_card_mesh(dev)):
        rb = ReducedBasis(A.m, p, qfree, eng.U.n, dev)
        rb.build(*store)
    torch.cuda.synchronize()
    assert _cuda.launches[key] - before == 2          # cols = 2
    assert torch.equal(rb.R.gather(), want.R)
    plain = ReducedBasis(A.m, p, qfree, eng.U.n, "cpu")
    plain.build(*store)
    assert torch.equal(rb.R.shards[1].cpu(),
                       plain.R[:, rb.M // 2:])


@pytest.mark.parametrize("name,opts", [
    ("mat364.sms", dict()), ("trefethen_500.sms", dict(device_dense_min=0)),
    ("trefethen_2000.sms", dict(complete=True))])
def test_mesh_echelonize_matches_single_card(dev, name, opts):
    """The engine under a (2, 2) mesh of cuda:0 (the dense finisher, the
    rank finisher, the complete PLUQ): rank, qinv, U, and L and p,
    bit-equal to the single-card run."""
    from spasm_tpu_torch.parallel import use_mesh
    A, _ = sio.load_csr(MATRIX / name, 42013)
    o = EchelonizeOptions(**opts)
    want = echelonize(A, o, device="cuda")
    with use_mesh(_card_mesh(dev)):
        got = echelonize(A, o)
    assert got.r == want.r and np.array_equal(got.qinv, want.qinv)
    pairs = [(got.U, want.U)]
    if o.complete:
        assert np.array_equal(got.p, want.p)
        pairs.append((got.L, want.L))
    for a, b in pairs:
        assert _same_csr(a, b)


def _other_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: torch.cuda.device_count() is "
                    f"{torch.cuda.device_count()}")
    return torch.device("cuda", 1)


def test_kernels_launch_on_another_card(dev):
    """Every kernel wrapper on tensors of cuda:1 while the current device
    is cuda:0: each launch runs on its tensor's card (the wrappers set
    the device; the launchers keep their attributes per device) and
    equals its plain version."""
    d1 = _other_card()
    rng = np.random.default_rng(17)
    p = 42013
    with torch.cuda.device(0):
        waves = random_waves(rng, 2000, 30, 8, p)
        R0 = torch.from_numpy(rng.integers(-(p // 2), p // 2 + 1,
                                           (2064, 2048))).to(torch.int16)
        want = R0.clone()
        _subst_waves_plain(want, *waves, p)
        got = R0.to(d1)
        subst_waves(got, *waves, p)
        assert torch.equal(got.cpu(), want)
        for M in (2048, 22528):
            X = torch.from_numpy(b2_panel(rng, "rank40", 64, M, p))
            want = X.clone()
            wpc = _row_sweep_plain(want, p)
            got = X.to(d1)
            pc = row_sweep(got, p)
            assert torch.equal(got.cpu(), want) and torch.equal(pc.cpu(), wpc)
        X = torch.from_numpy(b3_panel(rng, "rank40", 8192, p))
        want = X.clone()
        wpc = _row_sweep_tiles_plain(want, p)
        got = X.to(d1)
        pc = row_sweep_tiles(got, p)
        assert torch.equal(got.cpu(), want) and torch.equal(pc.cpu(), wpc)
        for n in (1024, CLUSTER_ROWS + 1):
            Xb, is_piv = panel_block(rng, n, p)
            Xb = torch.from_numpy(Xb)
            ip = torch.from_numpy(is_piv)
            for rref in (True, False):
                w = _panel_plain(Xb[:, 64:128], ip, p, 64, rref)
                g = panel_pivots(Xb.to(d1)[:, 64:128], ip.to(d1), p, 64,
                                 rref)
                for a, b in zip(g, w):
                    assert torch.equal(a.cpu(), b)
        torch.cuda.synchronize(d1)


def test_mesh_over_distinct_cards(dev):
    """make_mesh() over every card: the engine's sharded stages with peer
    copies between cards, bit-equal to the single-card run."""
    from spasm_tpu_torch.parallel import make_mesh, use_mesh
    _other_card()
    for name, opts in (("mat364.sms", dict()),
                       ("trefethen_2000.sms", dict(complete=True))):
        A, _ = sio.load_csr(MATRIX / name, 42013)
        o = EchelonizeOptions(**opts)
        want = echelonize(A, o, device="cuda")
        with use_mesh(make_mesh()):
            got = echelonize(A, o)
        assert got.r == want.r and _same_csr(got.U, want.U)
        if o.complete:
            assert np.array_equal(got.p, want.p) and _same_csr(got.L, want.L)
