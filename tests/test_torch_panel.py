"""Kernel B4's plain version (spasm_tpu_torch/dense/panel.py) against the
JAX package's Pallas panel kernel in interpret mode and against its XLA
path (the oracle of tests/test_sweep_pallas.py), on the same numpy-made
panels.  Tolerance 0: every output is unique and exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spasm_tpu.dense import sweep_pallas as jsp
from spasm_tpu.dense.elim import (_discovery_sweep, _forward_factor,
                                  _jordan_inverse, _unit_upper_inverse_small)

from spasm_tpu_torch.dense.panel import NB, _panel_plain, panel_pivots

torch.set_num_threads(2)


def _panel(p: int, seed):
    rng = np.random.default_rng(seed)
    P0 = rng.integers(-(p // 2), p // 2 + 1, (256, NB)).astype(np.int32)
    P0[:, 7] = P0[:, 2]          # duplicate column -> rank deficiency
    P0[:, 40] = 0                # empty column
    return P0


def _xla_oracle(P0, is_piv, p, rref):
    """The JAX package's XLA path of one panel step (elim.py:219-241)."""
    nb = P0.shape[1]
    piv = _discovery_sweep(jnp.asarray(P0), jnp.asarray(is_piv),
                           jnp.int64(p), small=True, rounds=2)
    lrows, lhas = np.asarray(piv.lrows), np.asarray(piv.lhas)
    lsafe = np.where(lhas, lrows, 0)
    W = jnp.asarray(np.where(lhas[:, None] & lhas[None, :], P0[lsafe],
                             np.eye(nb, dtype=np.int32)))
    out = [lrows, lhas, np.asarray(piv.is_piv)]
    if rref:
        return out + [np.asarray(_jordan_inverse(W, jnp.int64(p), True, 2))]
    Zlu, Vup = _forward_factor(W, jnp.int64(p), True, 2)
    return out + [np.asarray(Zlu), np.asarray(
        _unit_upper_inverse_small(Vup, jnp.int64(p), True))]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("partly_pivotal", [False, True])
@pytest.mark.parametrize("rref", [True, False])
@pytest.mark.parametrize("p", [3, 257, 42013, 65279])
def test_plain_b4_matches_pallas_interpret(p, rref, partly_pivotal):
    P0 = _panel(p, p)
    n = P0.shape[0]
    is_piv = np.zeros(n, bool)
    if partly_pivotal:
        is_piv[np.random.default_rng(p + 1).random(n) < 0.3] = True
    out = jsp.panel_pivots_small_p(
        jnp.asarray(P0.T.copy()), jnp.asarray(is_piv.astype(np.int32))[None],
        jnp.full((1, 1), p, jnp.int32), NB, rref, interpret=True)
    want = [np.asarray(out[0]).ravel(), np.asarray(out[1]).ravel() == 1,
            np.asarray(out[2]).ravel() == 1] + [np.asarray(o)
                                                for o in out[3:]]
    _assert_same(_panel_plain(torch.from_numpy(P0),
                              torch.from_numpy(is_piv), p, NB, rref), want)


@pytest.mark.parametrize("rref", [True, False])
@pytest.mark.parametrize("p", [3, 257, 42013, 65279])
def test_plain_b4_matches_xla_oracle(p, rref):
    P0 = _panel(p, [p, 2])
    n = P0.shape[0]
    is_piv = np.random.default_rng([p, 3]).random(n) < 0.2
    _assert_same(_panel_plain(torch.from_numpy(P0), torch.from_numpy(is_piv),
                              p, NB, rref), _xla_oracle(P0, is_piv, p, rref))


def test_wrapper_on_cpu_takes_the_plain_version():
    p = 42013
    S = torch.from_numpy(np.random.default_rng(9).integers(
        -(p // 2), p // 2 + 1, (128, 3 * NB)).astype(np.int32))
    P0 = S[:, NB:2 * NB]                      # a strided column panel
    ip = torch.zeros(128, dtype=torch.bool)
    for rref in (True, False):
        got = panel_pivots(P0, ip, p, NB, rref)
        want = _panel_plain(P0.contiguous(), ip, p, NB, rref)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bad", ["nb", "dtype", "mask", "prime"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    P0 = torch.zeros((128, NB), dtype=torch.int32)
    ip = torch.zeros(128, dtype=torch.bool)
    p, nb = 42013, NB
    if bad == "nb":
        nb = 32
    elif bad == "dtype":
        P0 = P0.to(torch.int64)
    elif bad == "mask":
        ip = ip[:100]
    else:
        p = 65537
    with pytest.raises((ValueError, NotImplementedError)):
        panel_pivots(P0, ip, p, nb, True)
