"""The port's SMS / MatrixMarket parser where a file is not well formed:
a token that is not an integer before the SMS end marker, or among the
MatrixMarket header's 3 * nnz integers, raises ValueError naming its byte
offset (the JAX package's copy drops the rest of the chunk it was
reading, silently where the end marker lies in a later chunk); text
after the end marker is read and hashed as before.  Every fixture loads
equal to the JAX package's `load_csr`, with the same SHA-256 digest,
also when the file is read in small chunks."""
import hashlib
import io

import numpy as np
import pytest

from spasm_tpu import sio as jsio
from spasm_tpu_torch import sio as tsio
from tests.conftest import MATRIX

ALL_FIXTURES = sorted(p.name for p in MATRIX.glob("*.sms"))
# the default read size (32 MB: one chunk), and small ones, so that a bad
# token or the end marker falls in a later chunk than the first
CHUNKS = [1 << 25, 64, 7]


def _sms(nnz: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 50, nnz)
    cols = rng.integers(1, 40, nnz)
    vals = rng.integers(1, 257, nnz)
    body = "".join(f"{i} {j} {v}\n" for i, j, v in zip(rows, cols, vals))
    return f"50 40 M\n{body}0 0 0\n"


def _same(A, B):
    assert (A.n, A.m) == (B.n, B.m)
    assert np.array_equal(A.indptr, B.indptr)
    assert np.array_equal(A.indices[:A.nnz], B.indices[:B.nnz])
    assert np.array_equal(A.data[:A.nnz], B.data[:B.nnz])


def _corrupt(text: str, entry: int) -> str:
    """The text with the row index of entry `entry` (0-based) replaced by
    'x': the tokens before it stay a multiple of 3."""
    lines = text.split("\n")
    lines[1 + entry] = "x" + lines[1 + entry][lines[1 + entry].index(" "):]
    return "\n".join(lines)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("nnz,entry", [(3, 1), (400, 1), (400, 377)])
def test_corrupted_sms_body_raises(monkeypatch, chunk, nnz, entry):
    text = _corrupt(_sms(nnz), entry)
    monkeypatch.setattr(tsio, "_IO_CHUNK", chunk)
    with pytest.raises(ValueError,
                       match=f"at byte {text.index('x')} is not an integer"):
        tsio.load_csr(io.BytesIO(text.encode()), 257)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("tail", ["% a comment\n", "trailing words 1 2\n",
                                  "1 2 x\n", "\x00\xff binary\n"])
def test_text_after_end_marker_loads(monkeypatch, chunk, tail):
    text = _sms(120, seed=1) + tail
    data = text.encode("latin-1")
    want, jh = jsio.load_csr(io.BytesIO(data), 257, want_hash=True)
    monkeypatch.setattr(tsio, "_IO_CHUNK", chunk)
    got, th = tsio.load_csr(io.BytesIO(data), 257, want_hash=True)
    _same(want, got)
    assert th == jh == hashlib.sha256(data).digest()


@pytest.mark.parametrize("chunk", CHUNKS)
def test_matrix_market_stop_before_nnz_raises(monkeypatch, chunk):
    head = "%%MatrixMarket matrix coordinate integer general\n% c\n5 5 4\n"
    good = head + "1 1 1\n2 2 2\n3 3 3\n4 4 4\n"
    monkeypatch.setattr(tsio, "_IO_CHUNK", chunk)
    A, h = tsio.load_csr(io.BytesIO((good + "tail text\n").encode()), 257,
                         want_hash=True)
    assert A.nnz == 4
    assert h == hashlib.sha256((good + "tail text\n").encode()).digest()
    bad = head + "1 1 1\n2 2 2\n3 y 3\n4 4 4\n"
    with pytest.raises(ValueError, match=f"at byte {bad.index('y')} .*"
                       r"\(2 of 4 entries read\)"):
        tsio.load_csr(io.BytesIO(bad.encode()), 257)


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_fixture_loads_in_small_chunks(monkeypatch, name):
    """Read 4 KiB at a time, every fixture gives the JAX package's matrix
    and digest."""
    want, jh = jsio.load_csr(MATRIX / name, 42013, want_hash=True)
    monkeypatch.setattr(tsio, "_IO_CHUNK", 4096)
    got, th = tsio.load_csr(MATRIX / name, 42013, want_hash=True)
    _same(want, got)
    assert th == jh


def test_fast_ints_prefix_and_offset():
    assert tsio._fast_ints(b"1 2 3\n4 5 6")[1] is None
    flat, bad = tsio._fast_ints(b"1 2 3\n4x 5 6")
    assert flat.tolist() == [1, 2, 3, 4] and bad == 6
    flat, bad = tsio._fast_ints(b"0 0 0 % tail")
    assert flat.tolist() == [0, 0, 0] and bad == 6
