"""`matmul_digits` of the port against the JAX package's, on the same
numpy-made balanced operands (tolerance 0: exact GF(p) products),
including the int8-B variant and a contraction longer than one
_k_chunk(d) (65536 at d = 2, 2^15 at d = 3, 2^14 at d = 4), in all
three digit tiers: WIDE holds both ends of d = 3 (65521 still stored
int16, 65537 the first int32 one, 16711421 the last) and of d = 4
(16711427, 67108859 of the reference's grid, 2^32 - 5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.dense import modp as jm
from spasm_tpu_torch.dense import modp as tm

torch.set_num_threads(2)

PRIMES = [3, 257, 42013, 65279]
WIDE = [65521, 65537, 16711421, 16711427, 67108859, 4294967291]


def _jax_mm(A, B, p):
    F = jm.device_field(p)
    return np.asarray(jm.matmul_digits(jnp.asarray(A), jnp.asarray(B),
                                       jnp.int64(p),
                                       jnp.asarray(F.weights), F.ndigits))


def _bal(rng, shape, p):
    return rng.integers(-(p // 2), p // 2 + 1, shape).astype(np.int32)


@pytest.mark.parametrize("p", PRIMES + WIDE)
@pytest.mark.parametrize("shape", [(5, 7, 3), (40, 64, 24), (33, 130, 17)])
def test_matmul_digits_matches_jax(p, shape):
    n, k, m = shape
    rng = np.random.default_rng([p, n, k, m])
    A, B = _bal(rng, (n, k), p), _bal(rng, (k, m), p)
    got = tm.matmul_digits(torch.from_numpy(A), torch.from_numpy(B), p)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _jax_mm(A, B, p))
    # storage operands (the basis buffers: int16 up to 65535) give the
    # same product
    stored = B.astype(tm.storage_dtype(p) == torch.int16 and np.int16
                      or np.int32)
    gots = tm.matmul_digits(torch.from_numpy(A), torch.from_numpy(stored), p)
    assert np.array_equal(gots.numpy(), got.numpy())


@pytest.mark.parametrize("p", PRIMES + WIDE)
def test_matmul_digits_int8_B(p):
    rng = np.random.default_rng(p + 1)
    A = _bal(rng, (24, 96), p)
    B8 = rng.integers(-127, 128, (96, 40)).astype(np.int8)
    got = tm.matmul_digits(torch.from_numpy(A), torch.from_numpy(B8), p)
    assert np.array_equal(got.numpy(), _jax_mm(A, B8, p))
    ref = (A.astype(np.int64) @ B8.astype(np.int64)) % p
    assert np.array_equal(got.numpy().astype(np.int64) % p, ref)


@pytest.mark.parametrize("p", PRIMES + WIDE)
def test_matmul_digits_crosses_k_chunk(p):
    k = jm._k_chunk(jm.device_field(p).ndigits) + 40
    rng = np.random.default_rng(k + p)
    A, B = _bal(rng, (3, k), p), _bal(rng, (k, 8), p)
    got = tm.matmul_digits(torch.from_numpy(A), torch.from_numpy(B), p)
    assert np.array_equal(got.numpy(), _jax_mm(A, B, p))


def test_reduce_and_inverse():
    p = 42013
    rng = np.random.default_rng(3)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, 1000).astype(np.int32)
    r = tm._reduce31(torch.from_numpy(x), p).numpy().astype(np.int64)
    assert np.array_equal(r % p, x.astype(np.int64) % p)
    assert np.all(np.abs(r) <= p // 2)
    a = torch.from_numpy(_bal(rng, 500, p))
    inv = tm.modinv(a, p)
    prod = (a.to(torch.int64) * inv) % p
    assert torch.all(prod[a != 0] == 1) and torch.all(inv[a == 0] == 0)


def test_d3_tier_raises():
    """65537 (d = 3) no longer raises: matmul_digits equals the JAX
    package's there, int32 operands and the int8-B variant alike."""
    p = 65537
    rng = np.random.default_rng(p)
    A, B = _bal(rng, (48, 96), p), _bal(rng, (96, 40), p)
    got = tm.matmul_digits(torch.from_numpy(A), torch.from_numpy(B), p)
    assert np.array_equal(got.numpy(), _jax_mm(A, B, p))
    B8 = rng.integers(-127, 128, (96, 40)).astype(np.int8)
    got = tm.matmul_digits(torch.from_numpy(A), torch.from_numpy(B8), p)
    assert np.array_equal(got.numpy(), _jax_mm(A, B8, p))


def test_d4_digits_above_the_digit_reach():
    """At p = 2^32 - 5 the balanced values above _digit_reach(4) =
    2139062143 take the v - p remap: operands made of them (and of the
    most negative value) multiply exactly, as in the JAX package."""
    p = 4294967291
    reach = jm._digit_reach(4)
    rng = np.random.default_rng(4)
    A = rng.integers(reach + 1, p // 2 + 1, (40, 72))
    B = rng.integers(reach + 1, p // 2 + 1, (72, 33))
    A[::3, ::2] = -(p // 2)
    B[1::4] *= -1
    A, B = A.astype(np.int32), B.astype(np.int32)
    digits = tm._digits(torch.from_numpy(A), 4, p)
    recomb = sum(dg.to(torch.int64) * 256 ** s for s, dg in enumerate(digits))
    assert torch.equal(recomb % p, torch.from_numpy(A).to(torch.int64) % p)
    got = tm.matmul_digits(torch.from_numpy(A), torch.from_numpy(B), p)
    assert np.array_equal(got.numpy(), _jax_mm(A, B, p))
    want = [[sum(int(a) * int(b) for a, b in zip(A[i], B[:, j])) % p
             for j in range(3)] for i in range(3)]
    assert np.array_equal(got.numpy()[:3, :3].astype(np.int64) % p, want)


@pytest.mark.parametrize("p", WIDE)
def test_reduce_and_inverse_wide(p):
    rng = np.random.default_rng(p)
    x = rng.integers(-(1 << 62), 1 << 62, 1000)
    r = tm.dnorm64(torch.from_numpy(x), p).numpy()
    assert np.array_equal(r % p, x % p) and np.all(np.abs(r) <= p // 2)
    a = torch.from_numpy(_bal(rng, 500, p))
    inv = tm.modinv(a, p)
    prod = tm.mulmod(a, inv, p)
    assert torch.all(prod[a != 0] == 1) and torch.all(inv[a == 0] == 0)
