"""The row sweeps' plain versions (kernels B2, B3) and the port's
row-sweep RREF against the JAX package on the same numpy-made blocks
(tolerance 0: exact arithmetic; the leftmost-rule RREF is unique).
Eliminations use primes: 65269 is the largest prime of the d = 2 tier,
whose bound 65279 = 29 * 2251 is not one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.dense.modp import device_field
from spasm_tpu.dense.rowrref import _rref_rows as j_rref_rows

from chip_checks import b3_panel
from spasm_tpu_torch.dense.modp import dnorm64
from spasm_tpu_torch.dense.rowrref import (CLUSTER_COLS, CompactBasis,
                                           TILE_W, _jordan_step, _rref_rows,
                                           _row_sweep_plain,
                                           _row_sweep_tiles_plain,
                                           rref_rows_device, row_sweep,
                                           row_sweep_tiles, row_sweep_variant,
                                           step_sweep)

torch.set_num_threads(2)
# above the d = 2 tier (the sweeps take the torch step loop there)
WIDE = [65521, 65537, 16711421, 16711427, 67108859, 4294967291]


def _deficient(rng, B, M, r, p):
    """(B, M) balanced block of rank <= r with the last column dead."""
    W = rng.integers(-(p // 2), p // 2 + 1, (B, r)).astype(np.int64)
    W[rng.random((B, r)) < 0.6] = 0
    G = np.where(rng.random((r, M)) < 0.3,
                 rng.integers(-(p // 2), p // 2 + 1, (r, M)), 0)
    X = (W @ G) % p
    X = np.where(X > p // 2, X - p, X)
    X[:, -1] = 0
    X[::7] = 0                                   # some zero rows too
    return X.astype(np.int32)


def _deficient_wide(rng, B, M, r, p):
    """As _deficient for any p <= 2^32 - 5: small left factors keep the
    int64 products exact."""
    W = rng.integers(-3, 4, (B, r))
    W[rng.random((B, r)) < 0.6] = 0
    G = np.where(rng.random((r, M)) < 0.3,
                 rng.integers(-(p // 2), p // 2 + 1, (r, M)), 0)
    X = (W @ G) % p
    X = np.where(X > p // 2, X - p, X)
    X[:, -1] = 0
    X[::7] = 0
    return X.astype(np.int32)


def _jax_rref(X, p, nb):
    F = device_field(p)
    Xd, piv = j_rref_rows(jnp.asarray(X), jnp.int64(p),
                          jnp.asarray(F.weights), F.ndigits, nb,
                          p <= (1 << 23), False, p >= 1024, False)
    return np.asarray(Xd), np.asarray(piv)


@pytest.mark.parametrize("p", [3, 42013, 65269])
@pytest.mark.parametrize("nb", [64, 512])
def test_b2_plain_matches_jax(p, nb):
    rng = np.random.default_rng([p, nb])
    X = _deficient(rng, 512, 2048, 300, p)
    want_X, want_piv = _jax_rref(X, p, nb)
    got_X, got_piv = _rref_rows(torch.from_numpy(X.copy()), p, nb,
                                row_sweep)
    assert np.array_equal(got_piv.numpy(), want_piv)
    assert np.array_equal(got_X.numpy(), want_X)


def _check_rref(X, piv, p):
    """Unit pivots, zero elsewhere on pivot columns, zero non-pivot rows."""
    hit = np.nonzero(piv >= 0)[0]
    pc = piv[hit]
    assert len(set(pc.tolist())) == len(pc)
    assert np.array_equal(X[hit][:, pc], np.eye(len(hit), dtype=X.dtype))
    assert not X[piv < 0].any()
    return X[hit].astype(np.int64), pc


def _in_span(Y, R, pc, p):
    """Every row of Y reduces to zero against the RREF rows R."""
    res = (Y - (Y[:, pc] @ R) % p) % p
    return not res.any()


@pytest.mark.parametrize("p", [257, 42013])
def test_b3_plain_rref_valid_and_same_span(p):
    rng = np.random.default_rng(p + 3)
    X = _deficient(rng, 128, 4096, 90, p)
    X2, piv2 = _rref_rows(torch.from_numpy(X.copy()), p, 64, row_sweep)
    X3, piv3 = _rref_rows(torch.from_numpy(X.copy()), p, 64,
                          row_sweep_tiles)
    R2, pc2 = _check_rref(X2.numpy(), piv2.numpy(), p)
    R3, pc3 = _check_rref(X3.numpy(), piv3.numpy(), p)
    assert len(pc2) == len(pc3)                  # the same rank
    assert _in_span(R2, R3, pc3, p) and _in_span(R3, R2, pc2, p)
    assert _in_span(X.astype(np.int64), R3, pc3, p)


def test_b3_plain_sweep_contract():
    """One B3 sweep: pivot rows own their columns, other rows are zero
    there, unpivoted rows are zero; pivots follow the tile rule."""
    p = 42013
    rng = np.random.default_rng(5)
    P = _deficient(rng, 64, 2 * TILE_W, 40, p)
    P[3, :TILE_W] = 0                 # a row whose first tile is empty
    P[3, TILE_W + 5] = 9
    Pt = torch.from_numpy(P.copy())
    piv = _row_sweep_tiles_plain(Pt, p).numpy()
    Q = Pt.numpy()
    for k in np.nonzero(piv >= 0)[0]:
        col = Q[:, piv[k]]
        assert col[k] != 0 and np.count_nonzero(col) == 1
    assert not Q[piv < 0].any()
    # B2's leftmost rule on the same input finds the same rank
    piv2 = _row_sweep_plain(torch.from_numpy(P.copy()), p).numpy()
    assert (piv >= 0).sum() == (piv2 >= 0).sum()


@pytest.mark.parametrize("p", WIDE)
def test_rref_rows_wide_matches_jax(p):
    """rref_rows_device above the d = 2 tier (`step_sweep` on 64-row
    sub-panels, int64 products) against the JAX package's XLA step loop
    over whole 128-row panels: the leftmost-rule RREF is unique.  The
    rows stored as the prime's basis storage (int16 at 65521)."""
    rng = np.random.default_rng(p)
    X = _deficient_wide(rng, 256, 2048, 150, p)
    want_X, want_piv = _jax_rref(X, p, 128)
    dtype = torch.int16 if p <= 65535 else torch.int32
    got_X, got_piv = rref_rows_device(torch.from_numpy(X).to(dtype), p,
                                      nb=128)
    assert np.array_equal(got_piv.numpy(), want_piv)
    assert np.array_equal(got_X.numpy().astype(np.int32), want_X)
    assert 100 < (want_piv >= 0).sum() <= 150


@pytest.mark.parametrize("p", [65537, 4294967291])
def test_step_sweep_matches_b2_plain_rule(p):
    """One step_sweep of a (64, M) sub-panel: the leftmost rule, the same
    pivots and values as B2's plain version (exact in int64: int32 there
    would wrap above the d = 2 tier)."""
    rng = np.random.default_rng(p + 1)
    P = _deficient_wide(rng, 64, 512, 40, p)
    a, b = torch.from_numpy(P.copy()), torch.from_numpy(P.copy())
    pa = step_sweep(a, p)
    pb = _row_sweep_plain(b, p)
    assert torch.equal(pa, pb) and torch.equal(a, b)
    assert int((pa >= 0).sum()) == 40


@pytest.mark.parametrize("p", [65537, 4294967291])
def test_compact_basis_wide(p):
    """CompactBasis stores int32 rows above 65535 (not the JAX package's
    int16: ROADMAP C1); its apply and add go through the wide
    matmul_digits, and the basis eliminates its own block to zero."""
    rng = np.random.default_rng(p + 2)
    X = torch.from_numpy(_deficient_wide(rng, 128, 2048, 70, p))
    Xr, piv = rref_rows_device(X.clone(), p, nb=128)
    piv = piv.numpy()
    hit = np.nonzero(piv >= 0)[0]
    basis = CompactBasis(2048, p, 64, "cpu")
    assert basis.dtype == torch.int32
    half = hit.size // 2
    basis.add(Xr[torch.from_numpy(hit[:half])], piv[hit[:half]])
    basis.add(Xr[torch.from_numpy(hit[half:])], piv[hit[half:]])
    assert not basis.apply(X.clone()).any()
    R, jpos = basis.export()
    assert R.dtype == torch.int32
    Rn = R.numpy()
    assert np.array_equal(Rn[:, jpos], np.eye(hit.size, dtype=np.int32))


def test_rref_rows_device_dispatch_and_basis():
    p = 42013
    rng = np.random.default_rng(11)
    X = torch.from_numpy(_deficient(rng, 128, 2048, 70, p)).to(torch.int16)
    Xr, piv = rref_rows_device(X.clone(), p, nb=512)
    piv = piv.numpy()
    hit = np.nonzero(piv >= 0)[0]
    basis = CompactBasis(2048, p, 64, "cpu")
    assert basis.dtype == torch.int16
    basis.add(Xr[torch.from_numpy(hit)], piv[hit])
    # the basis eliminates the block it came from to zero
    assert not basis.apply(X.clone()).any()
    R, jpos = basis.export()
    assert R.shape[0] == len(hit) and np.array_equal(jpos, piv[hit])


def test_wrappers_check_inputs():
    with pytest.raises(ValueError):
        row_sweep(torch.zeros(4, 8, dtype=torch.int16), 257)
    with pytest.raises(ValueError):
        row_sweep_tiles(torch.zeros(32, TILE_W, dtype=torch.int32), 257)
    with pytest.raises(NotImplementedError):
        row_sweep(torch.zeros(4, 8, dtype=torch.int32), 65537)


@pytest.mark.parametrize("nb,M,want", [
    (64, 2048, "cluster"), (1, 2048, "cluster"), (17, 1, "cluster"),
    (64, CLUSTER_COLS, "cluster"), (64, CLUSTER_COLS + 1, "pair"),
    (64, 22528, "pair"), (65, 2048, "pair"), (1024, 2048, "pair")])
def test_row_sweep_variant(nb, M, want):
    """B2's variant by shape alone: the cluster at the main path's (64,
    2048), the pair beyond the cluster's capacity in rows or columns."""
    assert CLUSTER_COLS >= 2048
    assert row_sweep_variant(nb, M) == want


@pytest.mark.parametrize("case", ["no rows", "too many rows", "int16",
                                  "1-D", "strided", "meta device",
                                  "p too large"])
def test_row_sweep_rejects(case):
    """What neither B2 variant takes raises before any launch."""
    P = torch.zeros((64, 2048), dtype=torch.int32)
    p, exc = 42013, ValueError
    if case == "no rows":
        P = P[:0]
    elif case == "too many rows":
        P = torch.zeros((1025, 8), dtype=torch.int32)
    elif case == "int16":
        P = P.to(torch.int16)
    elif case == "1-D":
        P = P[0]
    elif case == "strided":
        P = P[:, ::2]
    elif case == "meta device":
        P = P.to("meta")
    else:
        p, exc = 65537, NotImplementedError
    with pytest.raises(exc):
        row_sweep(P, p)


def _tiles_right_looking(P: torch.Tensor, p: int) -> torch.Tensor:
    """The oracle: B3's first plain version, right-looking, in place.  Per
    tile in order, skipped when no row not yet pivoted has a nonzero
    there: sweep [tile | I] by the in-tile leftmost rule, write the tile
    back, and compose its transform Z into every other tile."""
    nb, M = P.shape
    tw = TILE_W
    pivoted = [False] * nb
    pivcol = torch.full((nb,), -1, dtype=torch.int32, device=P.device)
    for t in range(M // tw):
        c0 = t * tw
        tile = P[:, c0:c0 + tw]
        unp = torch.tensor([not f for f in pivoted], device=P.device)
        if not bool(((tile != 0).any(dim=1) & unp).any()):
            continue
        # aug = [tile | I_nb]; its right part accumulates the transform Z
        aug = torch.cat([tile, torch.eye(nb, dtype=torch.int32,
                                         device=P.device)], dim=1)
        for k in range(nb):
            if pivoted[k]:
                continue
            nz = torch.nonzero(aug[k, :tw])
            if nz.numel() == 0:
                continue
            j = int(nz[0, 0])
            _jordan_step(aug, k, j, p)
            pivoted[k] = True
            pivcol[k] = c0 + j
        P[:, c0:c0 + tw] = aug[:, :tw]
        Z = aug[:, tw:].to(torch.int64)[:, :, None]
        for tt in range(M // tw):
            if tt != t:
                sl = slice(tt * tw, (tt + 1) * tw)
                # Z @ tile as a broadcast sum: CUDA has no int64 matmul
                ZX = (Z * P[None, :, sl].to(torch.int64)).sum(dim=1)
                P[:, sl] = dnorm64(ZX, p).to(torch.int32)
    return pivcol


B3_CASES = ["full", "rank40", "staircase", "zero", "empty_lead",
            "row_first_tile_empty"]


@pytest.mark.parametrize("case", B3_CASES)
@pytest.mark.parametrize("M", [1024, 4096, 8192])
@pytest.mark.parametrize("p", [3, 257, 42013, 65269])
def test_b3_plain_matches_right_looking(p, M, case):
    """The left-looking plain B3 against the right-looking oracle:
    the same pivots and the same panel, bit for bit."""
    P0 = torch.from_numpy(b3_panel(np.random.default_rng([p, M]), case, M,
                                   p))
    want = P0.clone()
    piv_want = _tiles_right_looking(want, p)
    got = P0.clone()
    piv = _row_sweep_tiles_plain(got, p)
    assert torch.equal(piv, piv_want)
    assert torch.equal(got, want)
    if case == "zero":
        assert not got.any() and bool((piv == -1).all())
    if case == "staircase":
        assert int((piv >= 0).sum()) == min(M // TILE_W, 64)
