"""Host-side pieces of kernel B1 wide (csrc/subst.cu `subst_wide`), on
the CPU: its grid plan (`wide_plan`: which block owns which column
chunk), and the arithmetic envelope of its reduction (csrc/modp.cuh
`FpWide`: an FP64 quotient, partial sums within p/2 + 2560 between
every nred_wide products, as many as the coefficients' magnitude
allows), emulated with numpy float64 and held to Python integers at
every prime of tests/test_torch_reduced.py's WIDE."""
import numpy as np
import pytest

from spasm_tpu_torch.dense.subst import nred_wide, wide_plan

# the primes of tests/test_torch_reduced.py above the d = 2 tier
WIDE = [65521, 65537, 16711421, 16711427, 67108859, 4294967291]
PART_SLACK = 2560          # FpWide.part's bound past p/2 (csrc/modp.cuh)


def _owned(nchunks: int, grid: int):
    """The kernel's ownership: block b walks `mine` chunks, b + k grid
    (subst_wide's `mine`, next_wide_job's column)."""
    return [[b + k * grid for k in range((nchunks - 1 - b) // grid + 1)]
            for b in range(grid)]


@pytest.mark.parametrize("resident", [1, 7, 132, 264, 396, 528])
def test_wide_plan_owns_every_chunk_once(resident):
    for nchunks in range(1, 4 * resident + 40):
        grid, per = wide_plan(nchunks, resident)
        assert 1 <= grid <= min(resident, nchunks)
        owned = _owned(nchunks, grid)
        flat = sorted(c for blk in owned for c in blk)
        assert flat == list(range(nchunks))
        counts = [len(blk) for blk in owned]
        assert max(counts) == per and min(counts) >= per - 1
        # as few blocks as per allows: fewer than per of them own per - 1
        # (not 20 blocks with two chunks beside 376 with one)
        assert sum(c < per for c in counts) < per
        # no fewer chunks per block would fit the resident blocks
        assert (per - 1) * resident < nchunks <= per * resident


def test_wide_plan_main_path_and_refusals():
    # mk12.b4's M = 20480 on an H100's 132 SMs x 3 blocks: one chunk each
    assert wide_plan(320, 396) == (320, 1)
    # one chunk past the resident blocks: two each, the last block one
    assert wide_plan(397, 396) == (199, 2)
    for bad in ((0, 396), (320, 0)):
        with pytest.raises(ValueError):
            wide_plan(*bad)


def _part(x: int, p: int) -> int:
    """FpWide.part: x - rint(double(x) * (1 / p)) * p, as on the card
    (cvt.rn.f64.s64, mul.rn.f64, cvt.rni.s64.f64; int64 wraps nowhere)."""
    inv = np.float64(1.0) / np.float64(p)
    q = int(np.rint(np.float64(x) * inv))
    return x - q * p


def _red(x: int, p: int) -> int:
    """FpWide.red: `_part`, then one correction on each side."""
    r, half = _part(x, p), (p - 1) >> 1
    if r > half:
        r -= p
    if r < -half:
        r += p
    return r


def _balanced(x: int, p: int) -> int:
    r = x % p
    return r - p if r > p // 2 else r


@pytest.mark.parametrize("p", WIDE)
def test_fpwide_reduction_envelope(p):
    """|x| <= 2^63 - p is all FpWide takes: the extremes of a partial sum
    (a part's residue plus nred_wide(p) products of the largest balanced
    values, either sign) and random values reduce to x mod p, and part
    stays within p/2 + 2560."""
    half, nred = (p - 1) // 2, nred_wide(p)
    top = half + PART_SLACK + nred * half * half
    assert top <= (1 << 63) - p
    rng = np.random.default_rng(p)
    xs = [top, -top, (1 << 63) - p, -((1 << 63) - p), half, -half, 0,
          half * half, -half * half, p, -p]
    xs += [int(v) for v in rng.integers(-(1 << 63) + p, (1 << 63) - p,
                                        4000, dtype=np.int64)]
    xs += [int(v) for v in rng.integers(-top, top + 1, 4000, dtype=np.int64)]
    for x in xs:
        assert abs(_part(x, p)) <= half + 1 + PART_SLACK
        assert _red(x, p) == _balanced(x, p)


@pytest.mark.parametrize("p", WIDE)
def test_nred_wide_coefficient_rule(p):
    """nred_wide(p, cmax): the most products of coefficients |c| <= cmax
    and balanced values that keep a partial sum within 2^63 - p, capped
    at 16; the default is any balanced coefficient."""
    half = p // 2
    assert nred_wide(p) == nred_wide(p, half)
    for cmax in (0, 1, 2, 3, 1000, half // 7, half - 1, half):
        nred = nred_wide(p, cmax)
        assert 1 <= nred <= 16
        assert half + PART_SLACK + nred * cmax * half <= (1 << 63) - p
        if nred < 16:           # one more product could leave the range
            assert (nred + 1) * cmax * half > (1 << 63) - 2 * p
    assert nred_wide(p, 1) == 16


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("p", WIDE)
def test_wide_row_accumulation_matches_integers(p, unit):
    """subst_wide's per-column loop (start at R[k], subtract each
    coefficient x reference value in int64, `part` after every nred_wide
    products, `red` at the end) equals R[k] - sum c v mod p, for rows of
    1-40 references and values of either sign: with the largest
    coefficients (nred for any coefficient), or with +-1 and 0 (unit: the
    nred of a boundary map's entries, 16)."""
    half = (p - 1) // 2
    nred = nred_wide(p, 1 if unit else None)
    rng = np.random.default_rng([p, 1])
    for _ in range(400):
        k = int(rng.integers(1, 41))
        pick = rng.integers(0, 3, (2, k))
        extreme = np.array([half, -half])[rng.integers(0, 2, (2, k))]
        vals = np.where(pick == 0, rng.integers(-half, half + 1, (2, k)),
                        extreme)
        if unit:
            vals[0] = rng.integers(-1, 2, k)
        cs, vs = ([int(x) for x in row] for row in vals)
        raw = int(rng.choice([half, -half, int(rng.integers(-half, half))]))
        acc, cnt = raw, 0
        for c, v in zip(cs, vs):
            acc -= c * v
            assert abs(acc) <= (1 << 63) - p
            cnt += 1
            if cnt == nred:
                acc, cnt = _part(acc, p), 0
        want = _balanced(raw - sum(c * v for c, v in zip(cs, vs)), p)
        assert _red(acc, p) == want
