"""Matrix I/O: SMS and MatrixMarket load/save, SHA-256 fingerprints, bitmaps.

Mirrors SpaSM src/spasm_io.c:
  * auto-detects SMS vs MatrixMarket (`coordinate integer general`) input
  * 1-based -> 0-based index conversion; SMS end marker "0 0 0"
  * the fingerprint hashes *every byte read from the stream* — the reference
    streams each fgets() line into SHA-256 including trailing garbage after
    the end marker (spasm_io.c:116-141), so the digest equals SHA-256 of the
    whole file; we exploit that.
  * entries whose value reduces to 0 mod p are dropped at load time
    (spasm_add_entry, spasm_triplet.c:14-16)
  * PBM/PGM/PNM density bitmaps with Dulmage-Mendelsohn block coloring
"""
from __future__ import annotations

import hashlib
import io as _io
import re
import sys
import warnings
from typing import Optional, Tuple

import numpy as np

from .csr import COO, CSR


_IO_CHUNK = 1 << 25          # 32 MB read granularity


_TOKEN = re.compile(rb"\S+")
_INT = re.compile(rb"[+-]?\d+")


def _fast_ints(data: bytes) -> Tuple[np.ndarray, Optional[int]]:
    """Whitespace-separated integers via the C parser (~10x loadtxt).

    Returns (the integers, None), or, where a token is not an integer,
    (the integers before it, its offset in data).  numpy signals a parse
    that stops short with a DeprecationWarning (a ValueError in later
    versions) and returns the integers it read; that is made an error
    here, and the text is parsed again up to the bad token, keeping an
    integer that starts it ("4x" reads 4), as numpy does."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            return np.fromstring(data.decode("ascii", errors="replace"),
                                 dtype=np.int64, sep=" "), None
        except (DeprecationWarning, ValueError):
            pass
    bad = next((t.start() for t in _TOKEN.finditer(data)
                if not _INT.fullmatch(t.group())), len(data))
    lead = _INT.match(data, bad)
    end = lead.end() if lead else bad
    return (np.fromstring(data[:end].decode("ascii"), dtype=np.int64,
                          sep=" "), bad)


class _IntStream:
    """Chunked whitespace-separated integer reader with SHA-256 feed.

    Bounded memory: each chunk is parsed with the C fast path
    (np.fromstring, ~10x np.loadtxt) and handed to the caller; the file
    is never held whole (the reference streams with fgets,
    spasm_io.c:59-159).
    """

    def __init__(self, stream, hasher):
        self.stream = stream
        self.hasher = hasher
        self._carry = b""
        self.eof = False
        self.nread = 0              # bytes read from the stream
        self.stopped = None         # offset of a token next_ints refused

    def _read(self) -> bytes:
        buf = self.stream.read(_IO_CHUNK)
        if isinstance(buf, str):
            buf = buf.encode()
        if not buf:
            self.eof = True
        elif self.hasher is not None:
            self.hasher.update(buf)
        self.nread += len(buf)
        return buf

    def readline(self) -> str:
        while b"\n" not in self._carry and not self.eof:
            self._carry += self._read()
        nl = self._carry.find(b"\n")
        if nl < 0:
            line, self._carry = self._carry, b""
        else:
            line, self._carry = self._carry[:nl], self._carry[nl + 1:]
        return line.decode("ascii", errors="replace")

    def next_ints(self) -> Optional[np.ndarray]:
        """Next flat batch of integers (None at EOF).  Where a token is
        not an integer, the batch ends before it, the rest of the batch's
        text is dropped, and `stopped` holds the token's offset in the
        stream (else None); the caller decides whether the stop is an
        error."""
        while True:
            buf = self._read()
            if not buf:
                data, self._carry = self._carry, b""
                if not data.strip():
                    return None
            else:
                data = self._carry + buf
                # cut at the last whitespace so no token is split
                cut = max(data.rfind(b"\n"), data.rfind(b" "),
                          data.rfind(b"\t"), data.rfind(b"\r"))
                if cut < 0:
                    self._carry = data
                    continue
                data, self._carry = data[:cut], data[cut:]
            if data.strip():
                flat, bad = _fast_ints(data)
                self.stopped = None if bad is None else \
                    self.nread - len(self._carry) - len(data) + bad
                return flat

    def drain(self):
        """Consume the rest of the stream (fingerprint = whole file)."""
        if self.hasher is not None:
            while not self.eof:
                self._read()


def load_triplet(f, prime: int = 42013,
                 want_hash: bool = False) -> Tuple[COO, Optional[bytes]]:
    """Load an SMS or MatrixMarket matrix (streaming, bounded memory).

    `f` is a binary or text stream, or a filename.  prime == -1 loads the
    pattern only (no values).  Returns (COO, sha256 | None).
    """
    close = False
    if isinstance(f, (str, bytes)) or hasattr(f, "__fspath__"):
        f = open(f, "rb")
        close = True
    try:
        hasher = hashlib.sha256() if want_hash else None
        st = _IntStream(f, hasher)
        header = st.readline()

        batches = []
        got = 0
        if header.startswith("%%MatrixMarket"):
            fields = header.split()
            if len(fields) < 5:
                raise ValueError("incomplete MatrixMarket header")
            mtx, crd, dtyp, scheme = [s.lower() for s in fields[1:5]]
            if (mtx, crd, dtyp, scheme) != ("matrix", "coordinate",
                                            "integer", "general"):
                raise ValueError(
                    f"unsupported MatrixMarket flavor {fields[1:5]}")
            line = st.readline()
            while line.startswith("%"):
                line = st.readline()
            if not line.split():
                raise ValueError("premature EOF (expected matrix "
                                 "dimensions)")
            n, m, nnz = (int(t) for t in line.split()[:3])
            leftover = np.empty(0, np.int64)
            while got < 3 * nnz:
                flat = st.next_ints()
                if flat is None:
                    raise ValueError("premature end of MatrixMarket file")
                flat = np.concatenate((leftover, flat)) \
                    if leftover.size else flat
                take = min(flat.size - flat.size % 3, 3 * nnz - got)
                batches.append(flat[:take].reshape(-1, 3))
                leftover = flat[take:]
                got += take
                if got < 3 * nnz and st.stopped is not None:
                    raise ValueError(
                        f"MatrixMarket entry at byte {st.stopped} is not "
                        f"an integer ({got // 3} of {nnz} entries read)")
        else:
            fields = header.split()
            if len(fields) != 3:
                raise ValueError("bad SMS header")
            n, m = int(fields[0]), int(fields[1])
            if prime != -1 and fields[2] != "M":
                raise ValueError("only ``Modular'' SMS type supported")
            leftover = np.empty(0, np.int64)
            done = False
            while not done:
                flat = st.next_ints()
                if flat is None:
                    raise ValueError(
                        "premature end of SMS file (no end marker)")
                flat = np.concatenate((leftover, flat)) \
                    if leftover.size else flat
                k3 = flat.size - flat.size % 3
                tab = flat[:k3].reshape(-1, 3)
                leftover = flat[k3:]
                markers = np.nonzero(~tab.any(axis=1))[0]
                if markers.size:
                    tab = tab[:markers[0]]
                    done = True
                elif st.stopped is not None:
                    raise ValueError(
                        f"SMS entry at byte {st.stopped} is not an integer "
                        "(before the end marker)")
                batches.append(tab)
        st.drain()
        digest = hasher.digest() if hasher is not None else None
    finally:
        if close:
            f.close()

    table = batches[0] if len(batches) == 1 else \
        (np.vstack(batches) if batches else np.empty((0, 3), np.int64))
    T = COO.from_entries(n, m, prime, table[:, 0] - 1, table[:, 1] - 1,
                         table[:, 2] if prime != -1 else None)
    T.n = max(T.n, n)
    T.m = max(T.m, m)
    return T, digest


def load_csr(f, prime: int = 42013,
             want_hash: bool = False) -> Tuple[CSR, Optional[bytes]]:
    T, h = load_triplet(f, prime, want_hash)
    return T.tocsr(), h


def save_csr(A: CSR, f=sys.stdout):
    """Write a CSR matrix in SMS format (spasm_io.c:164-180)."""
    close = False
    if isinstance(f, (str, bytes)) or hasattr(f, "__fspath__"):
        f = open(f, "w")
        close = True
    try:
        f.write(f"{A.n} {A.m} M\n")
        rows = A.row_ids() + 1
        cols = A.indices[:A.nnz].astype(np.int64) + 1
        vals = (A.data[:A.nnz].astype(np.int64) if A.data is not None
                else np.ones(A.nnz, np.int64))
        buf = _io.StringIO()
        np.savetxt(buf, np.column_stack([rows, cols, vals]), fmt="%d")
        f.write(buf.getvalue())
        f.write("0 0 0\n")
    finally:
        if close:
            f.close()


def save_triplet(T: COO, f=sys.stdout):
    close = False
    if isinstance(f, (str, bytes)) or hasattr(f, "__fspath__"):
        f = open(f, "w")
        close = True
    try:
        f.write(f"{T.n} {T.m} M\n")
        vals = (T.val.astype(np.int64) if T.val is not None
                else np.ones(T.nz, np.int64))
        buf = _io.StringIO()
        np.savetxt(buf, np.column_stack(
            [T.row.astype(np.int64) + 1, T.col.astype(np.int64) + 1, vals]),
            fmt="%d")
        f.write(buf.getvalue())
        f.write("0 0 0\n")
    finally:
        if close:
            f.close()


def save_pnm(A: CSR, f, x: int, y: int, mode: int, DM=None):
    """Density bitmap of the pattern of A (spasm_io.c:198-312).

    mode 1 = PBM bitmap, 2 = PGM gray levels, 3 = PNM color with DM blocks.
    """
    n, m = A.n, A.m
    x = min(x, m)
    y = min(y, n)
    assert mode in (1, 2, 3)
    assert mode != 3 or DM is not None
    w = np.zeros((y, x), dtype=np.int64)
    rows = A.row_ids().astype(np.int64)
    cols = A.indices[:A.nnz].astype(np.int64)
    np.add.at(w, (rows * y // n, cols * x // m), 1)

    out = [f"P{mode}\n{x} {y}\n"]
    if mode > 1:
        out.append("255\n")

    tokens: list[str] = []
    if mode == 1:
        vals = (w > 0).astype(int).ravel()
        tokens = [str(v) for v in vals]
    elif mode == 2:
        mx = max(w.max(), 1)
        frac = w.ravel() / mx
        inten = np.where(frac > 0, 1.0 - np.exp(0.1 * np.log(
            np.where(frac > 0, frac, 1.0))), 1.0)
        tokens = [f"{255.0 * v:.0f}" for v in inten]
    else:
        bgcolor = [[0xFF0000, 0xCC0000, 0x990000],
                   [0xFFFFFF, 0xFFCC00, 0xCC9900],
                   [0xFFFFFF, 0xFFFFFF, 0x33CC00]]
        rr, cc = DM.rr, DM.cc
        lim_h = (cc[2] * x // m, cc[3] * x // m)
        lim_v = (rr[1] * y // n, rr[2] * y // n)
        r, c = DM.r, DM.c
        scc = 0
        scc_left = scc_right = scc_bot = 0
        for i in range(y):
            for j in range(x):
                bv = 0 if i < lim_v[0] else (1 if i < lim_v[1] else 2)
                bh = 0 if j < lim_h[0] else (1 if j < lim_h[1] else 2)
                bg = bgcolor[bv][bh]
                if bh == 1 and bv == 1:
                    while scc_bot <= i:
                        scc_left = scc_right
                        scc += 1
                        scc_right = int(c[scc]) * x // m
                        scc_bot = int(r[scc]) * y // n
                    if j < scc_left:
                        bg = 0xFFFFFF
                    elif j < scc_right:
                        bg += 0x003366
                pixel = 0 if w[i, j] > 0 else bg
                tokens.append(f"{(pixel >> 16) & 0xFF} {(pixel >> 8) & 0xFF} "
                              f"{pixel & 0xFF}")
    # 32 tokens per line for readability
    for k in range(0, len(tokens), 32):
        out.append(" ".join(tokens[k:k + 32]) + "\n")

    close = False
    if isinstance(f, (str, bytes)) or hasattr(f, "__fspath__"):
        f = open(f, "w")
        close = True
    try:
        f.write("".join(out))
    finally:
        if close:
            f.close()


def human_format(n: int) -> str:
    """8-char human-readable count (spasm_util.c:41-63)."""
    for limit, div, suffix in ((1_000, 1, ""), (1_000_000, 1e3, "k"),
                               (1_000_000_000, 1e6, "m"),
                               (10 ** 12, 1e9, "g"), (10 ** 15, 1e12, "t")):
        if n < limit:
            return f"{n}" if not suffix else f"{n / div:.1f}{suffix}"
    return f"{n / 1e15:.1f}p"
