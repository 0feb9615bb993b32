#!/usr/bin/env python3
"""Kernel B1 wide of this checkout against another one, on one card.

    python3 b1_wide_ab.py OTHER      # OTHER: another checkout's root

The schedule is mk12.b4's round-0 reduced basis, the one chip_smoke.py
times B1 wide on, at p = 65537 and 2^32 - 5, with R of its shape (int32,
seeded balanced values), at M = 20480 and cut to M = 16896 (64 x 264).
Each tree runs in a child process of its own, since both packages are
named spasm_tpu_torch (`python3 b1_wide_ab.py --child TREE`), in the
order OTHER, this, this, OTHER.  A child builds its tree's kernels,
times each case by CUDA events (5 calls after a warm one) through the
wrapper `subst_waves` (what chip_smoke.py times: the schedule's copy to
the card, which waits for the stream, and the launch) and through the C
entry alone on a schedule already on the card, and prints the registers
and spills ptxas gave the kernel and a SHA-256 of each result; both
trees must give the same results.  A tree whose wrapper sizes nred by
the coefficients (`nred_wide(p, cmax)`: 16 for mk12.b4's +-1) is timed
again at p = 2^32 - 5 with the nred any coefficient allows (2): the
cost of a schedule whose coefficients are not +-1.

First, on the host, the schedule's shape and an LRU model of the card's
50 MB L2 over the kernel's processing order (the waves in order, a
wave's rows in order, every block in step): of the rows' reads (each
row's own and each reference), how many miss it, in the schedule's
order and with a wave's rows sorted by their least reference, by their
latest-written reference, and by reverse Cuthill-McKee on the rows that
share references.
"""
import hashlib
import json
import pathlib
import subprocess
import sys
from collections import OrderedDict

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
PRIMES = (65537, 4294967291)
WIDTHS = (20480, 16896)
L2_BYTES = 50e6


def schedule(device: str):
    """(rows, ref_ptr, refs, coef, bounds) of mk12.b4's round 0, and
    (npad, M) of its R, through the importing tree's package."""
    from spasm_tpu_torch import EchelonizeOptions
    from spasm_tpu_torch.csr import CSR
    from spasm_tpu_torch.dense.reduced import ReducedBasis, subst_schedule
    from spasm_tpu_torch.echelonize import _Engine
    from spasm_tpu_torch.field import Field
    from spasm_tpu_torch.gen import matching_complex_boundary
    import torch
    B = matching_complex_boundary(12, 4)
    if B.n < B.m:                        # the rank tool's orientation
        B = B.transpose()
    p = PRIMES[-1]
    A = CSR(B.n, B.m, Field(p), B.indptr, B.indices, B.data)
    eng = _Engine(A, EchelonizeOptions(), torch.device(device))
    eng.extract_structural(A)
    qfree = np.nonzero(eng.U.qinv < 0)[0]
    rb = ReducedBasis(A.m, p, qfree, eng.U.n, device)
    offs, cols, vals, pivcols, groups = eng.U.flat_store()
    pivmap = np.full(A.m + 1, rb.npad - 1, np.int64)
    pivmap[pivcols] = np.arange(len(pivcols))
    waves = subst_schedule(offs, cols, vals, pivcols, groups, pivmap,
                           rb.npad)
    return waves, (rb.npad, rb.M)


def _misses(waves, order, cap: int) -> int:
    """Row reads that miss an LRU cache of cap rows; order(g, idx)
    permutes wave g's row positions."""
    rows, ref_ptr, refs, _, bounds = waves
    lru, miss = OrderedDict(), 0
    for g in range(len(bounds) - 1):
        for i in order(g, np.arange(bounds[g], bounds[g + 1])):
            for x in (rows[i], *refs[ref_ptr[i]:ref_ptr[i + 1]]):
                if x in lru:
                    lru.move_to_end(x)
                else:
                    miss += 1
                    lru[x] = True
                    if len(lru) > cap:
                        lru.popitem(last=False)
            lru[rows[i]] = True                 # the row's write
            lru.move_to_end(rows[i])
    return miss


def host_model() -> None:
    waves, (npad, M) = schedule("cpu")
    rows, ref_ptr, refs, _, bounds = waves
    sizes = np.diff(bounds)
    k = np.diff(ref_ptr)
    reads = rows.size + refs.size
    print(f"schedule: {rows.size} rows, {sizes.size} waves (median "
          f"{int(np.median(sizes))} rows, the last four {sizes[-4:].tolist()}"
          f"), {refs.size} references ({np.bincount(k).tolist()} rows by "
          f"count), {np.union1d(rows, refs).size} distinct rows read; R "
          f"{npad} x {M}", flush=True)
    cap = int(L2_BYTES // (M * 4))
    pos = np.full(npad, -1, np.int64)
    pos[rows] = np.arange(rows.size)
    least = np.minimum.reduceat(refs, ref_ptr[:-1])
    latest = np.maximum.reduceat(pos[refs], ref_ptr[:-1])

    def rcm(g, idx):
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        if idx.size < 50:
            return idx
        s0, s1 = ref_ptr[idx[0]], ref_ptr[idx[-1] + 1]
        r = np.repeat(np.arange(idx.size), k[idx])
        X = csr_matrix((np.ones(r.size), (r, refs[s0:s1])),
                       shape=(idx.size, npad))
        return idx[reverse_cuthill_mckee((X @ X.T).tocsr(),
                                         symmetric_mode=True)]

    orders = {"schedule": lambda g, idx: idx,
              "least reference": lambda g, idx: idx[np.argsort(
                  least[idx], kind="stable")],
              "latest-written reference": lambda g, idx: idx[np.argsort(
                  -latest[idx], kind="stable")],
              "reverse Cuthill-McKee": rcm}
    for name, order in orders.items():
        miss = _misses(waves, order, cap)
        gb = (miss + rows.size) * M * 4 / 1e9
        print(f"L2 model ({cap} rows of {M * 4} bytes), {name} order: "
              f"{miss} of {reads} row reads miss; with {rows.size} row "
              f"writes {gb:.2f} GB, {gb / 3.35:.3f} ms at 3.35 TB/s",
              flush=True)


def _kernel_alone(sched_d, waves, R, p: int, nred: int) -> None:
    """One launch of the importing tree's B1 wide C entry on R, the
    schedule already on the card (no wrapper: no schedule copy), on the
    grid that tree's wrapper takes."""
    import torch
    from spasm_tpu_torch import _cuda
    from spasm_tpu_torch.dense import subst
    rows, _, refs, _, bounds = waves
    args = [R.data_ptr(), R.shape[1], sched_d.data_ptr(), rows.size,
            refs.size, len(bounds) - 1, nred, p]
    if hasattr(subst, "wide_plan"):                 # the resident grid
        bps, sms = subst.wide_resident(torch.cuda.current_device())
        args.append(subst.wide_plan(R.shape[1] // subst.SUBST_COLS,
                                    bps * sms)[0])
    _cuda.check(_cuda.lib().spasm_subst_waves_wide(
        *args, _cuda.stream_ptr(R)), "B1 wide")


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import inspect
    import torch
    from chip_checks import cuda_ms
    from spasm_tpu_torch import _cuda
    from spasm_tpu_torch.dense import subst
    _cuda.lib()
    kernel, spills, ptxas = None, "", []
    for line in _cuda.build_log.splitlines():
        if "entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif ("Used" in line and kernel
              and ("Wide" in kernel or "subst_wide" in kernel)):
            ptxas.append(f"{line.split(':', 1)[1].strip()}; {spills}")
    waves, (npad, M0) = schedule("cuda")
    rows, ref_ptr, refs, coef, bounds = waves
    sched_d = torch.from_numpy(np.concatenate(
        [bounds, rows, ref_ptr, refs, coef]).astype(np.int32)).cuda()
    # the tree's wrapper's nred: by the coefficients' bound, or for any
    sized = "cmax" in inspect.signature(subst.nred_wide).parameters
    cmax = int(np.abs(np.asarray(coef, np.int64)).max())
    out = {"tree": tree, "ptxas": ptxas or ["(built before this run)"],
           "ms": {}, "sha256": {}}
    for p in PRIMES:
        nred = subst.nred_wide(p, cmax) if sized else subst.nred_wide(p)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(13)
        R0 = torch.randint(-(p // 2), p // 2 + 1, (npad, M0),
                           dtype=torch.int32, device="cuda", generator=gen)
        R0[-1] = 0
        for M in WIDTHS:
            R = R0[:, :M].clone(memory_format=torch.contiguous_format)
            subst.subst_waves(R, *waves, p)
            out["sha256"][f"{p} {M}"] = hashlib.sha256(
                R.cpu().numpy().tobytes()).hexdigest()
            ms = out["ms"]
            ms[f"{p} {M} wrapper"] = cuda_ms(
                lambda: subst.subst_waves(R, *waves, p), 5)
            ms[f"{p} {M} kernel (nred {nred})"] = cuda_ms(
                lambda: _kernel_alone(sched_d, waves, R, p, nred), 5)
            if sized and subst.nred_wide(p) != nred:
                ms[f"{p} {M} kernel, nred {subst.nred_wide(p)} (any "
                   f"coefficient)"] = cuda_ms(lambda: _kernel_alone(
                       sched_d, waves, R, p, subst.nred_wide(p)), 5)
            del R
        del R0
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1])
        return 0
    if len(argv) != 1:
        sys.exit(__doc__)
    other = str(pathlib.Path(argv[0]).resolve())
    host_model()
    runs = []
    for tree in (other, str(HERE), str(HERE), other):
        r = subprocess.run([sys.executable, __file__, "--child", tree],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            sys.exit(f"b1_wide_ab: the child on {tree} failed:\n"
                     f"{r.stderr[-3000:]}")
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    if any(r["sha256"] != runs[0]["sha256"] for r in runs):
        sys.exit("b1_wide_ab: the trees' results differ")
    for name, tree in (("other", other), ("this", str(HERE))):
        mine = [r for r in runs if r["tree"] == tree]
        print(f"{name} ({tree}): ptxas {mine[0]['ptxas']}")
        for case in mine[0]["ms"]:
            p, M, *how = case.split(maxsplit=2)
            print(f"  p = {p}, M = {M}{', ' if how else ''}{''.join(how)}: "
                  + " / ".join(f"{r['ms'][case]:.3f}" for r in mine) + " ms")
    print("every result equal in both trees (SHA-256)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
