#!/usr/bin/env python3
"""Smoke test of spasm_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (no failure is caught):
  1. device: requires torch.cuda; prints the card's name and power limit;
  2. build: compiles the CUDA kernels (csrc/*.cu, one nvcc per source, all
     at once) and the host native library (g++) from this checkout, and
     prints the seconds taken;
  3. kernels: B1 (substitution; on a synthetic schedule and on mk13.b5's
     own, from its structural pivots; its int32-storage kernel, "B1
     wide", on mk12.b4's round-0 schedule at p = 65537 and 2^32 - 5, at
     M = 20480 and cut to M = 16896, with its grid, resident blocks per
     SM and a bound by operations beside the one by bytes), B2 (leftmost
     row sweep: the cluster
     variant at M = 2048, the pair at M = 22528) and B3 (tiled row sweep,
     on a rank-40 and on a full-rank panel) and B4 (the panel kernel, RREF
     and LU mode, the variant its n selects) against their plain torch
     versions on the card at the main paths' shapes, bit-equal, with both
     times, launches per call and each kernel's bound (bytes over 3.35
     TB/s or operations over 67 T/s, whichever is larger); B4's phase
     split (its stamped build: preamble, discovery, minor steps, inverse,
     Vinv) in both variants, each also bit-equal; B12 (the
     gather-combine of the rank finisher's blocks at d >= 3) against its
     plain version (the torch slot loop, on the card) at mk12.b4's
     shapes at 2^32 - 5, the finisher's largest chunk (4096 rows x 1248
     slots, 4.7 % live, w = 14336, int32 R) and a round-0 Schur chunk
     (8 slots, w = 20480), and the finisher's shape at 65521 on int16 R,
     bit-equal, with its bound by bytes and by int32-pipe instructions;
     matmul_digits on the card against the CPU;
  4. the rank path, with the launch counts zeroed first: one tests/Matrix
     fixture (M = 2048, so B2 sweeps), bit-equal to the port's own CPU run;
     the `rank` CLI on mk12.b4; mk12.b4 and mk13.b5 (matching-complex
     boundary maps, oriented as the rank tool does) through `echelonize`
     on the card, cold and warm, held to their published ranks, with the
     histogram of B3's live tiles per sweep over one run (a counter on the
     card).  B1, B2
     and B3 must have launched in this phase, B1 once per reduced-basis
     build and B2 once per sweep;
  5. the dense finishers, with the launch counts zeroed again:
     trefethen_2000 with default options (round 0 leaves a dense Schur
     complement: finish_dense, RREF) and its complete PLUQ, each bit-equal
     to the port's own CPU run, the PLUQ verified; PLUQ16k, the complete
     PLUQ of synthetic_sparse(16000, 16000, 8, 42013) (bench.py config 4),
     cold and warm, rank 15997, then the warm run's L and U materialized (timed apart) and verified
     (factorization_verify); the same matrix's rank through finish_dense
     (device_dense_width=0).  B4 must have launched in both modes, and
     the variant each main-path panel height takes is printed;
  6. the rounds, with the launch counts zeroed again: mk12.b4 with
     device_dense_width=0 (the reference-shaped round loop: round 0, its
     sparse Schur complement through the reduced basis, round 1, then
     finish_dense and its low-rank tail), once, rank
     39535, with the pivots, sampled density and Schur nnz of each round
     and the finishers taken; its complete PLUQ (rank 39535, L and U
     materialized, factorization_verify); mk10.b3 with
     device_dense_width=0 through the native GPLU finisher, bit-equal to
     the port's own CPU run.  B1 must launch exactly once per
     reduced-basis build (counted apart) and B4 in both modes;
  7. the d = 3/4 prime tiers, with the launch counts zeroed again: (a)
     mk12.b4 at p = 2^32 - 5 with default options (20107 free columns
     pass the wide tiers' width cap of 16384: the rounds, round 0's sparse
     Schur complement through the int32 R and B1 wide, round 1, whose
     14284 free columns fit the cap, then the rank finisher on int32 basis
     rows and the torch step sweep), once; (b) the
     same with device_dense_width = 81920 (the rank finisher in rows mode
     from round 0) and (c) as (b) at 65537 (d = 3), once each, all
     three rank 39535 (a different rank is rerun on the host to tell the
     matrix from the port); (d) the complete PLUQ of
     synthetic_sparse(16000, 16000, 8, 2^32 - 5), once, its rank equal
     to the rank path's, L and U materialized and verified.  B1 wide
     must launch exactly once per reduced-basis build, B12 must launch,
     and B1 (int16), B2, B3 and B4 never;
  8. the tools, with the launch counts zeroed again: (a) phase 5's
     PLUQ16k factors: a rank certificate created, verified (r = 15997),
     saved and loaded back, refused on A with one entry changed, and
     gesv on B = X.A for 32 random X plus one random row (refused);
     (b) the kernel basis of synthetic_sparse(16000, 16512, 8, 42013)
     (bench.py config 4's rank-deficient shape) factored on the card
     with default options (the finishers taken are printed), A.K^T = 0,
     kernel_from_rref(*rref(fact)) bit-equal to it; (c) bench.py config 5
     at 120 000 rows: dulmage_mendelsohn on the banded SCC instance
     (15002 blocks, the native matching) and the certificate of the
     upper-triangular instance after a complete PLUQ on the card; (d) the
     tools in fresh processes on tests/Matrix fixtures: rank -c -o,
     check_cert (accepts, then refuses on another matrix), echelonize
     --rref (byte-equal to rref() of phase 5's CPU factorization, as is
     rref() of a card factorization in this process), kernel, solve and
     dm -v; (e) phase 7's complete PLUQ at 2^32 - 5: the certificate
     roundtrip and gesv on 32 rows.  Seconds of each step are printed;
     B4 (RREF) and the kernels of (b)'s route must have launched;
  9. checkpoint/resume, with the launch counts zeroed again: five runs
     preempted in child processes (`chip_smoke.py --preempted CASE
     FILE`), each killed by SIGKILL right after a save, each file then
     resumed in this process on the card: (a) mk12.b4, default options,
     after the PHASE_FINISH save (the rank finisher: B1, B3); (b) the
     mk12.b4 rounds (device_dense_width=0, a save after every dense
     block) after the first PHASE_DENSE save (finish_dense: B4 RREF),
     its qinv and U compared with phase 6's warm run;
     (c) PLUQ16k's complete PLUQ (a save after every dense block) after
     the first PHASE_DENSE save, resumed with the default 30 s interval
     (B4 LU), verified; (d) mat364 (device_dense_min=0), written on the
     CPU after its PHASE_FINISH save, resumed on the card bit-equal to
     the uninterrupted CPU run (B2, M = 2048); (e) (a) at 2^32 - 5 after
     its PHASE_ROUND save (B1 wide).  (c)'s child runs beside the
     others.  Each save's wall and size, each resume's wall against the
     uninterrupted run of phases 4-7, and each resume's launches are
     printed; every file must be removed;
 10. the mesh (spasm_tpu_torch/parallel/), with the launch counts and
     the mesh's site counters zeroed again: mesh A, make_mesh(devices=
     [cuda:0] * 4), (2, 2) on one card (and, where two or more cards
     exist, mesh B = make_mesh() over them; otherwise the script says it
     is not run).  First B1 at a column shard's shape (mk12.b4's own
     schedule, M / 2) against its plain version, and R built under mesh
     A bit-equal to the single-card R and to the plain wave loop's.
     Then, under each mesh, bit-equal to the same call's single-card run
     (phases 4-6 where they kept it, else run once here): (a) mk12.b4,
     default options (the rank finisher, B1 once per column shard, B3);
     (b) the same with device_dense_width=12288: 20107 free columns pass
     one card's cap but not cap x cols, so the SP axis alone lets the
     rank finisher in (a spy shows it), same factorization as (a); (c)
     trefethen_2000 (column-sharded finish_dense RREF, B4 RREF on the
     owner shards); (d) PLUQ16k's complete PLUQ (row-sharded Schur
     blocks, column-sharded LU, B4 LU), verified; (e) trefethen_2000 at
     2^32 - 5 (panel_steps); (f) mk10.b3's complete PLUQ (the sparse
     Schur round's device branch: DeviceCSR.densify row-sharded),
     verified; (g) the mk12.b4 rounds (device_dense_width=0: the
     reduced-basis Schur round, finish_dense, the low-rank tail with
     pad_block).  B1 must launch cols times per build, B3 and B4 in both
     modes, and every mesh site 1-7 must count a call; each run's wall
     beside the single card's, its peak device memory and moved bytes,
     and the calls and bytes per site, are printed; then mk12.b4 on 1, 2
     and 4 x cuda:0, the cost of sharding on one card (not scaling);
 11. the `dense` surface, with the launch counts zeroed again: (a)
     `dense.modp_matmul` at bench.py's bench_mxu shape (n = 8192 square,
     p = 42013, d = 2; balanced int32 from a seeded Generator) on the
     card, exact on 16 sampled rows (recomputed on the host, below), its
     CUDA-event time over 10 calls after a warm one beside that of one
     torch._int_mm of two 8192^2 int8 matrices: the GF(p) rate 2n^3 / t,
     the int8 rate, and the GF(p) rate x 4 as a share of the int8 rate
     (a d = 2 product costs four int8 products: bench.py's ceiling), with
     the card's name and power limit, and the int8 rate again with B
     column-major; (b) the same at p = 2^32 - 5 (d = 4), n = 4096; (c)
     `modp_matmul_np` on (a)'s inputs equal to (a)'s product; (d)
     `dense.dense_rref` and `dense.dense_lu` of a 1024 x 1024 matrix of
     rank 1000 at 42013 on the card equal to their CPU run (B4 must
     launch in both modes); (e) `profiling.start_trace` / `stop_trace`
     around one `modp_matmul`: the trace must parse as JSON and hold a
     CUDA kernel event.  The host check splits both operands into 16-bit
     limbs, takes the four limb products in float64 (exact: every partial
     sum is an integer below 2^53) and recombines them in Python ints;
 12. a JSON line of the kernels (launches summed over the paths), then
     the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX or of the JAX package `spasm_tpu`.
"""
import io
import json
import logging
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
P = 42013                                   # the tools' default modulus
MK = {"mk12.b4": (12, 4, 39535), "mk13.b5": (13, 5, 134211)}
PLUQ16K_RANK = 15997                        # BENCH_r05.json pluq16k_rank
# right-hand sides of the tools' gesv: bench.py config 4 solves 1024
# (bench.py:207), but on PLUQ16k's factors a row takes ~0.35 s on the
# card machine's host (PERF.md section 6), so 1024 would take six minutes
GESV_RHS = 32
N5 = 120_000                                # bench.py config 5's rows
DM_BLOCKS = 15002                           # BENCH_r05.json dm_blocks (seeded)
P4 = 4294967291                             # 2^32 - 5, the top of d = 4
P3 = 65537                                  # the first int32-stored prime
# bounds: device memory rate, and the float32 rate outside the tensor
# cores taken for the kernels' int32 CUDA-core work, NVIDIA H100 SXM;
# B1 wide's 64-bit arithmetic against the INT32 rate instead: 64 INT32
# lanes an SM x 132 SMs x 1.98 GHz, 16.7 T instructions/s (33.5 T INT32
# op/s with a multiply-add counted twice)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
INT32_INSTR_PER_S = 16.7e12
WIDE_PAIR_M = 16896                 # 64 x 264 columns: two 64-column
                                    # blocks on each of 132 SMs
WALLS = {}                                  # _timed_rank's walls by label


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return smi.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False")
    log(card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")
    return torch.cuda.get_device_name(0)


def build_phase() -> None:
    from spasm_tpu_torch import _cuda, native
    t0 = time.time()
    _cuda.lib()
    t1 = time.time()
    if not native.available():
        sys.exit("chip_smoke: the host pivot library did not build")
    log(f"build: CUDA kernels {t1 - t0:.1f} s "
        f"(nvcc {_cuda.build_seconds}), host pivot library "
        f"{time.time() - t1:.1f} s")
    kernel, spills = None, ""   # ptxas -v: registers, shared memory, spills
    for line in _cuda.build_log.splitlines():
        if "entry function" in line:
            mangled = line.split("'")[1]
            kernel = next((k for k in ("subst_waves", "subst_wide",
                                       "sweep_find",
                                       "sweep_update", "sweep_cluster",
                                       "tile_sweep", "panel_cluster",
                                       "panel_coop")
                           if k in mangled), mangled)
            if "ILb1E" in mangled:      # the template with phase stamps
                kernel += " (stamped)"
        elif kernel and "Used" in line:
            log(f"  {kernel}: {line.split(':', 1)[1].strip()}; {spills}")
        elif "spill stores" in line:
            spills = line.strip()


def _max_err(got, want) -> int:
    if got.shape != want.shape:
        sys.exit(f"chip_smoke: shapes {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _record(name, src, replaces, got, want, nbytes, ops,
            ops_per_s=CORE_OPS_PER_S):
    """Holds got against want (tolerance 0) and starts the kernel's JSON
    record, with its bound from this input's bytes and operations."""
    err = max(_max_err(g, w) for g, w in zip(got, want))
    if err:
        sys.exit(f"chip_smoke: {name} disagrees with its plain version "
                 f"(max abs err {err})")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": None, "plain_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}     # no single PyTorch call computes these


def _b4_ops(P0, is_piv, rref: bool) -> int:
    """Operations B4 needs on this panel, 3 per updated element (two
    products and a difference): the discovery steps' updates of the
    available rows with a nonzero in the step's column (counted on this
    data), the 64 steps on [W | I], the diagonal scaling and, in LU mode,
    the unit-upper inverse's products and sums."""
    from spasm_tpu_torch.dense.elim import _mulsub
    Pw, piv = P0.clone(), is_piv.clone()
    ops = 0
    for t in range(64):
        col = Pw[:, t]
        avail = ~piv & (col != 0)
        if not bool(avail.any()):
            continue
        r = int(torch.argmax(avail.to(torch.int32)))
        g = torch.where(avail, col, 0)
        g[r] = 0
        ops += 3 * int((g != 0).sum()) * (63 - t)
        Pw = _mulsub(col[r], Pw, g[:, None], Pw[r][None, :], P)
        piv[r] = True
    ops += sum(3 * (63 if rref else 63 - t) * 128 for t in range(64))
    ops += 64 * 64 * (1 if rref else 2)
    if not rref:
        ops += sum(2 * (63 - i) * 64 for i in range(64))
    return ops


B2_KERNELS = {"cluster": "sweep_cluster", "pair": "sweep_find+sweep_update"}
B4_PHASES = ("preamble copy", "discovery", "minor steps",
             "Fermat inverse + Z", "Vinv")


def b4_phase_split(P0, ip, rref: bool, variant: str, want, mode: str):
    """Prints B4's phase split on this panel (the stamped build of the
    kernel, lead block's clock64 and %globaltimer), after holding its
    outputs to the plain version's."""
    from spasm_tpu_torch.dense.panel import panel_phase_stamps
    stamps = None
    for _ in range(3):                  # the last of three calls
        got, stamps = panel_phase_stamps(P0, ip, P, rref, variant)
    torch.cuda.synchronize()
    if max(_max_err(g, w) for g, w in zip(got, want)):
        sys.exit(f"chip_smoke: B4 {variant} (stamped) disagrees with its "
                 f"plain version")
    st = stamps.cpu().tolist()
    cyc = [st[k + 1] - st[k] for k in range(5)]
    us = [(st[7 + k] - st[6 + k]) / 1e3 for k in range(5)]
    log(f"  B4 ({P0.shape[0]}, 64) {mode} {variant} phase split, lead "
        f"block: " + ", ".join(f"{name} {c} cycles / {u:.3f} us"
                               for name, c, u in zip(B4_PHASES, cyc, us))
        + f"; total {(st[11] - st[6]) / 1e3:.3f} us")


def _wide_ops(ref_ptr, coef, M: int, p: int) -> int:
    """The int32-pipe instructions B1 wide issues on this schedule: per
    column, 4 a product (a 32 x 32 -> 64 multiply, 2; a 64-bit subtract,
    2), 5 a partial reduction after every nred products (the wrapper's
    nred for these coefficients; a 64-bit multiply, 3; a subtract, 2) and
    11 a row's final one (two 64-bit corrections more); FpWide's
    conversions and FP64 multiply run on the FP64 pipe and are not
    counted."""
    from spasm_tpu_torch.dense.subst import nred_wide
    k = np.diff(np.asarray(ref_ptr, np.int64))
    nred = nred_wide(p, int(np.abs(np.asarray(coef, np.int64)).max(
        initial=0)))
    return M * int(4 * k.sum() + 5 * (k // nred).sum() + 11 * k.size)


def b1_line(label, R0, waves, reps: int, p: int = P) -> dict:
    """B1 (one launch per call) against its plain version on R0 and one
    schedule: held bit-equal, timed (each timed call re-substitutes a
    copy in place), with the bound from this schedule's own bytes: every
    live row read and written once, every referenced row read once, the
    schedule arrays read once; a product and a sum per reference and
    column.  R0's storage selects the kernel: int16 B1, or int32 "B1
    wide" (p > 65535), whose line adds its grid, its resident blocks per
    SM, a bound by its int32-pipe instructions (`_wide_ops`) and, at
    M > WIDE_PAIR_M, its time on R0's first WIDE_PAIR_M columns (held to
    the full result's: a column depends on the same column alone)."""
    from chip_checks import cuda_ms
    from spasm_tpu_torch import _cuda
    from spasm_tpu_torch.dense.subst import (SUBST_COLS, _subst_waves_plain,
                                             subst_waves, wide_plan,
                                             wide_resident)
    rows, ref_ptr, refs, coef, bounds = waves
    M = R0.shape[1]
    wide = R0.dtype != torch.int16
    key = "B1 wide" if wide else "B1"
    got = R0.clone()
    before = _cuda.launches[key]
    subst_waves(got, *waves, p)
    per_call = _cuda.launches[key] - before
    want = R0.clone()
    _subst_waves_plain(want, *waves, p)
    touched = np.union1d(rows, refs).size + rows.size
    nbytes = touched * M * R0.element_size() + sum(a.nbytes for a in waves)
    ops = _wide_ops(ref_ptr, coef, M, p) if wide else 2 * refs.size * M
    rec = _record(f"{key} subst_{'wide' if wide else 'waves'}",
                  "spasm_tpu_torch/csrc/subst.cu",
                  "spasm_tpu/dense/subst_pallas.py:68", [got], [want],
                  nbytes, ops,
                  INT32_INSTR_PER_S if wide else CORE_OPS_PER_S)
    extra = ""
    if wide:
        bps, sms = wide_resident(torch.cuda.current_device())
        grid, per = wide_plan(M // SUBST_COLS, bps * sms)
        extra = (f"; grid {grid} blocks ({per} chunk(s) of {SUBST_COLS} "
                 f"columns each at most), {bps} resident blocks per SM x "
                 f"{sms} SMs; bounds {nbytes / HBM_BYTES_PER_S * 1e3:.4f} "
                 f"ms by bytes, {ops / INT32_INSTR_PER_S * 1e3:.4f} ms by "
                 f"{ops} int32 instructions")
        if M > WIDE_PAIR_M:
            cut = R0[:, :WIDE_PAIR_M].contiguous()
            subst_waves(cut, *waves, p)
            if not torch.equal(cut, want[:, :WIDE_PAIR_M]):
                sys.exit(f"chip_smoke: {key} at M = {WIDE_PAIR_M} disagrees "
                         f"with the full result's columns")
            ms_cut = cuda_ms(lambda: subst_waves(cut, *waves, p), reps)
            g_cut, _ = wide_plan(WIDE_PAIR_M // SUBST_COLS, bps * sms)
            extra += (f"; at M = {WIDE_PAIR_M} (grid {g_cut}) {ms_cut:.3f} "
                      f"ms, bit-equal")
            del cut
    del want
    ms = cuda_ms(lambda: subst_waves(got, *waves, p), reps)
    plain_ms = cuda_ms(lambda: _subst_waves_plain(got, *waves, p), 1)
    log(f"{key} {label} at p = {p}: {rows.size} live rows, "
        f"{len(bounds) - 1} waves, "
        f"{refs.size / max(rows.size, 1):.2f} references per row, M={M}, "
        f"{R0.dtype}; one-launch variant, {per_call} launch per call; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), bit-equal{extra}")
    if per_call != 1:
        sys.exit(f"chip_smoke: {key} made {per_call} launches in one call")
    return dict(rec, ms=ms, plain_ms=plain_ms)


def b12_line(rng, S: int, K: int, w: int, p: int, live: float,
             npad: int, label: str) -> dict:
    """B12 (one launch a call) against its plain version on the card (the
    torch slot loop, the balanced difference, column w - 1 zeroed) on
    chip_checks.combine_inputs: held bit-equal, timed (each timed call
    combines into the last result in place: the same slots, the same
    work), with the bound the larger of its bytes over HBM (X read and
    written, refs and V read, each distinct referenced row of R read
    once) and its int32-pipe instructions over INT32_INSTR_PER_S, counted
    as `_wide_ops` counts B1 wide's: 4 a live product, 5 a fold after
    every nred_wide(p) of a row's products, 11 a row's final reduction,
    per column."""
    from chip_checks import combine_inputs, cuda_ms
    from spasm_tpu_torch import _cuda
    from spasm_tpu_torch.dense.elim import _submod
    from spasm_tpu_torch.dense.modp import storage_dtype
    from spasm_tpu_torch.dense.reduced import _ref_combine, gather_combine
    from spasm_tpu_torch.dense.subst import nred_wide
    dev = torch.device("cuda")
    X, V, R, refs = combine_inputs(rng, S, K, w, p, live, npad)
    Xd, Vd, refsd = (torch.from_numpy(a).to(dev) for a in (X, V, refs))
    Rd = torch.from_numpy(R).to(dev, storage_dtype(p))
    dead = npad - 1

    def plain():
        out = _submod(Xd, _ref_combine(Vd, Rd, refsd, p), p)
        out[:, w - 1] = 0
        return out

    got = Xd.clone()
    before = _cuda.launches["B12"]
    gather_combine(got, Vd, Rd, refsd, p, dead, True)
    per_call = _cuda.launches["B12"] - before
    ok = (refs != dead) & (V != 0)
    k = ok.sum(axis=1)
    nref = np.unique(refs[ok]).size
    nbytes = (2 * X.nbytes + refs.nbytes + V.nbytes
              + nref * w * Rd.element_size())
    ops = w * int(4 * k.sum() + 5 * (k // nred_wide(p)).sum() + 11 * S)
    rec = _record("B12 gather_combine", "spasm_tpu_torch/csrc/combine.cu",
                  "none (XLA gather, spasm_tpu/dense/reduced.py:54)", [got],
                  [plain()], nbytes, ops, INT32_INSTR_PER_S)
    ms = cuda_ms(lambda: gather_combine(got, Vd, Rd, refsd, p, dead, True),
                 5)
    plain_ms = cuda_ms(plain, 1)
    log(f"B12 {label} at p = {p}: ({S}, {w}), K = {K}, {Rd.dtype} R of "
        f"{npad} rows; {int(k.sum())} live slots ({k.sum() / ok.size:.2%}, "
        f"at most {int(k.max())} a row), {nref} distinct rows of R; "
        f"{per_call} launch per call; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bounds {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"by {nbytes} bytes, {ops / INT32_INSTR_PER_S * 1e3:.4f} ms by "
        f"{ops} int32 instructions ({rec['bound_by']}), bit-equal")
    if per_call != 1:
        sys.exit(f"chip_smoke: B12 made {per_call} launches in one call")
    del Xd, Vd, Rd, refsd, got
    torch.cuda.empty_cache()
    return dict(rec, ms=ms, plain_ms=plain_ms)


def b1_real_schedule(A, tag: str, opts, p: int = P, shards: int = 1) -> dict:
    """B1 on the schedule that round 0 of echelonize(A, opts) builds: its
    structural pivots, the reduced basis's waves (`subst_schedule`), R
    of the basis's shape and storage for p filled with seeded balanced
    values; with shards > 1, one column shard of that R (M / shards
    columns, the shape each shard of a mesh's 'cols' axis gives B1)."""
    from spasm_tpu_torch.csr import CSR
    from spasm_tpu_torch.dense.reduced import ReducedBasis, subst_schedule
    from spasm_tpu_torch.echelonize import _Engine
    from spasm_tpu_torch.field import Field
    dev = torch.device("cuda")
    A = CSR(A.n, A.m, Field(p), A.indptr, A.indices, A.data)   # +-1 entries
    eng = _Engine(A, opts, dev)
    eng.extract_structural(A)
    qfree = np.nonzero(eng.U.qinv < 0)[0]
    rb = ReducedBasis(A.m, p, qfree, eng.U.n, dev)
    offs, cols, vals, pivcols, groups = eng.U.flat_store()
    pivmap = np.full(A.m + 1, rb.npad - 1, np.int64)
    pivmap[pivcols] = np.arange(len(pivcols))
    waves = subst_schedule(offs, cols, vals, pivcols, groups, pivmap,
                           rb.npad)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    R0 = torch.randint(-(p // 2), p // 2 + 1, (rb.npad, rb.M // shards),
                       dtype=rb.dtype, device=dev, generator=gen)
    R0[-1] = 0
    rec = b1_line(f"on {tag}'s own schedule (R {rb.npad} x {rb.M}"
                  + (f", one of {shards} column shards" if shards > 1
                     else "") + ")", R0, waves, 3, p)
    del R0
    torch.cuda.empty_cache()
    return rec


def kernel_phase(mats) -> dict:
    from spasm_tpu_torch import EchelonizeOptions
    from chip_checks import (b3_panel, cuda_ms, deficient_panel, panel_block,
                             random_waves)
    from spasm_tpu_torch.dense.modp import matmul_digits
    from spasm_tpu_torch.dense.panel import (_panel_plain, panel_pivots,
                                             panel_variant)
    from spasm_tpu_torch import _cuda
    from spasm_tpu_torch.dense.rowrref import (_row_sweep_plain,
                                               _row_sweep_tiles_plain,
                                               row_sweep, row_sweep_tiles,
                                               row_sweep_variant)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    out = {}

    # B1: ~20k rows in 300 waves at the mk13.b5 finisher width
    M, n = 22528, 20000
    waves = random_waves(rng, n, 300, 8, P)
    R0 = torch.from_numpy(rng.integers(-(P // 2), P // 2 + 1, (n + 64, M),
                                       dtype=np.int16)).to(dev)
    R0[n:] = 0
    b1_line("synthetic", R0, waves, 3)
    del R0
    # the rank path's schedule (mk13.b5, default options) and the rounds
    # path's (mk12.b4's round 0 at device_dense_width=0)
    out["B1"] = b1_real_schedule(mats["mk13.b5"], "mk13.b5",
                                 EchelonizeOptions())
    b1_real_schedule(mats["mk12.b4"], "mk12.b4",
                     EchelonizeOptions(device_dense_width=0))
    # the int32-storage kernel on the same schedule, d = 3 and 4
    b1_real_schedule(mats["mk12.b4"], "mk12.b4",
                     EchelonizeOptions(device_dense_width=0), P3)
    out["B1 wide"] = b1_real_schedule(mats["mk12.b4"], "mk12.b4",
                                      EchelonizeOptions(), P4)
    # B12 at mk12.b4's shapes at 2^32 - 5: the finisher's largest chunk
    # (K = 1248, 4.7 % live slots over ~2310 rows of R) and a round-0
    # Schur chunk (the rows of A, K = 8); the finisher's at 65521 on
    # int16 R
    out["B12"] = b12_line(rng, 4096, 1248, 14336, P4, 0.047, 2312,
                          "the finisher's largest chunk")
    b12_line(rng, 4096, 8, 20480, P4, 0.406, 8192, "a round-0 chunk")
    b12_line(rng, 4096, 1248, 14336, 65521, 0.047, 2312,
             "the finisher's largest chunk")

    def sweeps(name, kern, plain, M, empty, replaces, full=False):
        X = (b3_panel(rng, "full", M, P) if full else
             deficient_panel(rng, 64, M, 40, P, empty_cols=empty))
        P0 = torch.from_numpy(X).to(dev)
        got, want = P0.clone(), P0.clone()
        before = dict(_cuda.launches)
        piv = kern(got, P)
        per_call = {k: v - before[k] for k, v in _cuda.launches.items()
                    if v != before[k]}
        piv_w = plain(want, P)
        # the panel read and written once; each pivot's Jordan step
        # updates every element (two products and a difference)
        npiv = int((piv_w >= 0).sum())
        rec = _record(name, "spasm_tpu_torch/csrc/row_sweep.cu", replaces,
                      [got, piv], [want, piv_w], 2 * P0.numel() * 4 + 64 * 4,
                      3 * npiv * 64 * M)
        work = P0.clone()
        ms = cuda_ms(lambda: kern(work.copy_(P0), P), 10)
        plain_ms = cuda_ms(lambda: plain(work.copy_(P0), P), 2)
        log(f"{name} (64, {M}){' full rank' if full else ''}: launches per "
            f"call {per_call}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
            f"(each with one panel copy), bound {rec['bound_ms']:.5f} ms "
            f"({rec['bound_by']}), {npiv} pivots, bit-equal")
        return dict(rec, ms=ms, plain_ms=plain_ms)

    for M in (2048, 22528):
        variant = row_sweep_variant(64, M)
        rec = sweeps(f"B2 {B2_KERNELS[variant]}", row_sweep,
                     _row_sweep_plain, M, 300 if M == 2048 else 3000,
                     "spasm_tpu/dense/rowrref.py:55")
        if M == 2048:                  # the main path's width
            out["B2"] = rec
    out["B3"] = sweeps("B3 tile_sweep", row_sweep_tiles,
                       _row_sweep_tiles_plain, 22528, 3000,
                       "spasm_tpu/dense/rowrref.py:126")
    sweeps("B3 tile_sweep", row_sweep_tiles, _row_sweep_tiles_plain, 22528,
           0, "spasm_tpu/dense/rowrref.py:126", full=True)

    # B4 at the dense finishers' panel heights: 4608 (PLUQ16k blocks, LU),
    # 1024 (trefethen_2000 blocks, RREF and LU) and 1536 (the mk12.b4
    # rounds: finish_dense's 1291-row blocks padded, RREF and LU)
    for n in (1024, 1536, 4608):
        X, is_piv = panel_block(rng, n, P)
        Xd = torch.from_numpy(X).to(dev)
        P0 = Xd[:, 64:128]                 # read through the row stride
        ip = torch.from_numpy(is_piv).to(dev)
        for rref in (True, False):
            mode = "RREF" if rref else "LU"
            got = panel_pivots(P0, ip, P, 64, rref)
            want = _panel_plain(P0, ip, P, 64, rref)
            nbytes = (P0.numel() * 4 + 2 * n + 64 * 5
                      + 64 * 64 * 4 * (1 if rref else 2))
            rec = _record("B4 panel_cluster", "spasm_tpu_torch/csrc/panel.cu",
                          "spasm_tpu/dense/sweep_pallas.py:77", list(got),
                          list(want), nbytes, _b4_ops(P0, ip, rref))
            ms = cuda_ms(lambda: panel_pivots(P0, ip, P, 64, rref), 20)
            plain_ms = cuda_ms(lambda: _panel_plain(P0, ip, P, 64, rref), 2)
            log(f"B4 ({n}, 64) {mode}, {panel_variant(n)} variant: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}), "
                f"{int(got[1].sum())} pivots, bit-equal")
            for variant in ("cluster", "cooperative"):
                b4_phase_split(P0, ip, rref, variant, want, mode)
            if n == 4608 and not rref:     # the PLUQ16k shape
                out["B4"] = dict(rec, ms=ms, plain_ms=plain_ms)

    A = torch.from_numpy(rng.integers(-(P // 2), P // 2 + 1, (512, 4096),
                                      dtype=np.int32))
    B = torch.from_numpy(rng.integers(-(P // 2), P // 2 + 1, (4096, 22528),
                                      dtype=np.int16))
    want = matmul_digits(A, B, P)
    Ad, Bd = A.to(dev), B.to(dev)
    got = matmul_digits(Ad, Bd, P).cpu()
    if not torch.equal(got, want):
        sys.exit("chip_smoke: matmul_digits on the card disagrees with CPU")
    ms = cuda_ms(lambda: matmul_digits(Ad, Bd, P), 5)
    log(f"matmul_digits (512x4096 @ 4096x22528, torch._int_mm): "
        f"{ms:.3f} ms on the card, equal to the CPU result")
    return out


def _same_csr(Ua, Ub) -> bool:
    return ((Ua.n, Ua.m) == (Ub.n, Ub.m)
            and np.array_equal(Ua.indptr, Ub.indptr)
            and np.array_equal(Ua.indices[:Ua.nnz], Ub.indices[:Ub.nnz])
            and np.array_equal(Ua.data[:Ua.nnz], Ub.data[:Ub.nnz]))


def _same_U(a, b) -> bool:
    return np.array_equal(a.qinv, b.qinv) and _same_csr(a.U, b.U)


def _timed_rank(A, want: int, label: str, opts=None):
    from spasm_tpu_torch import _cuda, echelonize
    before = dict(_cuda.launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    fact = echelonize(A, opts, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    WALLS[label] = wall
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if want is not None and fact.r != want:
        sys.exit(f"chip_smoke: {label} rank {fact.r} != {want}")
    runs = {k: v - before[k] for k, v in _cuda.launches.items()
            if v != before[k]}
    log(f"{label}: rank {fact.r}"
        + (f" (want {want})" if want is not None else "") + f", wall "
        f"{wall:.3f} s, "
        f"peak device memory {peak:.2f} GiB, launches {runs}")
    return fact


def _launched(counts: dict, keys, what: str) -> None:
    log(f"{what} launches: {counts}")
    missing = [k for k in keys if counts[k] == 0]
    if missing:
        sys.exit(f"chip_smoke: kernels never launched on {what}: {missing}")


def matching_complexes() -> dict:
    from spasm_tpu_torch.gen import matching_complex_boundary
    mats = {}
    for tag, (nn, j, _) in MK.items():
        t0 = time.time()
        B = matching_complex_boundary(nn, j)
        if B.n < B.m:                        # the rank tool's orientation
            B = B.transpose()
        mats[tag] = B
        log(f"{tag}: {B.n} x {B.m}, {B.nnz} nnz, generated in "
            f"{time.time() - t0:.1f} s")
    return mats


def rank_path_phase(mats) -> dict:
    from spasm_tpu_torch import EchelonizeOptions, _cuda, echelonize, sio
    from spasm_tpu_torch.dense.rowrref import live_tile_histogram
    fixture = HERE / "tests" / "Matrix" / "trefethen_500.sms"
    A, _ = sio.load_csr(fixture, P)
    small = EchelonizeOptions(device_dense_min=0)
    ref = echelonize(A, small, device="cpu")

    _cuda.reset_launches()
    fact = echelonize(A, small, device="cuda")
    if not (fact.r == ref.r == 500 and _same_U(fact, ref)):
        sys.exit("chip_smoke: trefethen_500 on the card differs from the CPU")
    log(f"trefethen_500: rank {fact.r}, qinv and U bit-equal to the CPU run, "
        f"{_cuda.calls['B2']} B2 sweeps, {_cuda.launches['B2']} B2 launches "
        f"({_cuda.launches['B2 cluster']} cluster, "
        f"{_cuda.launches['B2 pair']} pair)")
    if _cuda.launches["B2"] == 0:
        sys.exit("chip_smoke: B2 never launched on trefethen_500")
    # the rank tool, as a user runs it: the matrix on standard input
    sms = io.StringIO()
    sio.save_csr(mats["mk12.b4"], sms)
    t0 = time.time()
    cli = subprocess.run(
        [sys.executable, "-m", "spasm_tpu_torch.cli.rank", "--modulus",
         str(P)], input=sms.getvalue(), cwd=HERE, capture_output=True,
        text=True, timeout=600)
    want = str(MK["mk12.b4"][2])
    if cli.returncode != 0 or cli.stdout.strip() != want:
        sys.exit("chip_smoke: rank CLI failed:\n" + cli.stderr[-3000:])
    log(f"rank CLI on mk12.b4 (stdin): {want}, process wall "
        f"{time.time() - t0:.1f} s")
    hist = live_tile_histogram(torch.device("cuda"))
    for tag, (_, _, want) in MK.items():
        for run in ("cold", "warm"):
            hist.zero_()
            fact = _timed_rank(mats[tag], want, f"{tag} {run}")
            if tag == "mk12.b4" and run == "warm":
                mk12 = fact                # phase 10's single-card run
                mk12.U                     # on the host: frees the card
        h = hist.cpu().tolist()
        log(f"{tag}: B3 sweeps by live tiles (one run): "
            + json.dumps({t: c for t, c in enumerate(h) if c}))
    counts = dict(_cuda.launches)
    _launched(counts, ("B1", "B2", "B3"), "the rank path")
    calls = dict(_cuda.calls)
    log(f"the rank path: B1 {counts['B1']} launches over {calls['B1']} "
        f"reduced-basis builds, B2 {counts['B2']} launches over "
        f"{calls['B2']} sweeps")
    for k, what in (("B1", "build"), ("B2", "sweep")):
        if counts[k] > calls[k]:
            sys.exit(f"chip_smoke: {k} made more than one launch per {what}")
    return counts, mk12


def dense_finisher_phase() -> dict:
    from spasm_tpu_torch import EchelonizeOptions, _cuda, echelonize, sio
    from spasm_tpu_torch.dense.panel import panel_variant
    from spasm_tpu_torch.certificate import factorization_verify
    from spasm_tpu_torch.gen import synthetic_sparse
    A, _ = sio.load_csr(HERE / "tests" / "Matrix" / "trefethen_2000.sms", P)
    pluq = EchelonizeOptions(complete=True)
    ref_rank = echelonize(A, device="cpu")
    ref_pluq = echelonize(A, pluq, device="cpu")
    t0 = time.time()
    A16 = synthetic_sparse(16000, 16000, 8, P)
    log(f"PLUQ16k: {A16.n} x {A16.m}, {A16.nnz} nnz, generated in "
        f"{time.time() - t0:.1f} s")

    _cuda.reset_launches()
    fact = _timed_rank(A, 2000, "trefethen_2000 rank (finish_dense, RREF)")
    if not _same_U(fact, ref_rank):
        sys.exit("chip_smoke: trefethen_2000 rank on the card differs from "
                 "the CPU run")
    log(f"  qinv and U bit-equal to the CPU run; B4 RREF launches "
        f"{_cuda.launches['B4 rref']}")
    fact = _timed_rank(A, 2000, "trefethen_2000 complete PLUQ", pluq)
    if not (_same_U(fact, ref_pluq) and np.array_equal(fact.p, ref_pluq.p)
            and _same_csr(fact.L, ref_pluq.L)
            and factorization_verify(A, fact, 42)):
        sys.exit("chip_smoke: trefethen_2000 PLUQ differs from the CPU run "
                 "or fails factorization_verify")
    log(f"  L, U and p bit-equal to the CPU run, factorization_verify "
        f"true; B4 LU launches {_cuda.launches['B4 lu']}")

    lu0 = _cuda.launches["B4 lu"]
    for run in ("cold", "warm"):
        fact = None
        fact = _timed_rank(A16, PLUQ16K_RANK, f"PLUQ16k complete PLUQ {run}",
                           pluq)
    lu16 = _cuda.launches["B4 lu"] - lu0
    if lu16 == 0:
        sys.exit("chip_smoke: B4 (LU) never launched on PLUQ16k")
    log(f"  B4 LU launches over the two PLUQ16k runs: {lu16}")
    t0 = time.time()
    U, L = fact.U, fact.L
    t_mat = time.time() - t0
    t0 = time.time()
    ok = factorization_verify(A16, fact, 42)
    log(f"PLUQ16k factors on the host: U {U.nnz} nnz, L {L.nnz} nnz, "
        f"materialized in {t_mat:.1f} s; factorization_verify {ok} "
        f"({time.time() - t0:.1f} s)")
    if not ok:
        sys.exit("chip_smoke: PLUQ16k fails factorization_verify")
    pluq16k = (A16, fact)                  # the tools phase reuses it
    del U, L
    _timed_rank(A16, PLUQ16K_RANK, "PLUQ16k rank (finish_dense, RREF, "
                "device_dense_width=0)",
                EchelonizeOptions(device_dense_width=0))
    counts = dict(_cuda.launches)
    _launched(counts, ("B4 rref", "B4 lu", "B4 cluster"),
              "the dense finishers")
    log("B4 variants on the main path: " + ", ".join(
        f"n = {n} takes {panel_variant(n)}" for n in (1024, 1536, 4608))
        + f"; launches by variant {counts['B4 cluster']} cluster, "
        f"{counts['B4 cooperative']} cooperative")
    return counts, pluq16k, (A, ref_rank)


def _round_lines(fact) -> None:
    for k, r in enumerate(fact.rounds):
        log(f"  round {k}: {r['pivots']} structural pivots"
            + (f", sampled Schur density {100 * r['density']:.2f} %"
               if "density" in r else "")
            + (f", sparse Schur complement {r['schur_nnz']} nnz"
               if "schur_nnz" in r else ""))


def rounds_phase(mats) -> dict:
    """The reference-shaped round loop, with the launch counts zeroed
    first: mk12.b4 at device_dense_width=0 (round 0, its sparse Schur
    complement through the reduced basis and B1, round 1, finish_dense
    with B4 in RREF mode and its low-rank tail), once;
    mk12.b4's complete PLUQ (the L-mode Schur complement through the
    UEliminator, round 1, finish_dense with B4 in LU mode), verified; and
    mk10.b3 at device_dense_width=0 through the native GPLU finisher,
    bit-equal to the port's own CPU run."""
    from spasm_tpu_torch import EchelonizeOptions, _cuda, echelonize, native
    from spasm_tpu_torch.certificate import factorization_verify
    from spasm_tpu_torch.dense.reduced import ReducedBasis
    from spasm_tpu_torch.gen import matching_complex_boundary
    B, want = mats["mk12.b4"], MK["mk12.b4"][2]
    w0 = EchelonizeOptions(device_dense_width=0)
    A10 = matching_complex_boundary(10, 3)
    if A10.n < A10.m:
        A10 = A10.transpose()
    ref10 = echelonize(A10, w0, device="cpu")
    if not native.available():
        sys.exit("chip_smoke: the native GPLU finisher did not build")
    # independent counts of reduced-basis builds and native GPLU calls
    builds, gplu_calls = [0], [0]
    build, gplu = ReducedBasis.build, native.gplu

    def counted_build(self, *a):
        builds[0] += 1
        return build(self, *a)

    def counted_gplu(*a):
        gplu_calls[0] += 1
        return gplu(*a)

    ReducedBasis.build, native.gplu = counted_build, counted_gplu

    _cuda.reset_launches()
    # one run (the checkpoint phase runs the rounds twice more)
    fact, taken = _finishers_taken(lambda: _timed_rank(
        B, want, "mk12.b4 rounds", w0))
    _round_lines(fact)
    log(f"mk12.b4 rounds: finishers taken: {taken}")
    t0 = time.time()
    rounds_ref = (fact.qinv, fact.U)       # the checkpoint phase's (b)
    log(f"  its U: {rounds_ref[1].nnz} nnz, materialized in "
        f"{time.time() - t0:.1f} s")
    rb_builds = builds[0]
    fact = _timed_rank(B, want, "mk12.b4 complete PLUQ",
                       EchelonizeOptions(complete=True))
    _round_lines(fact)
    t0 = time.time()
    U, L = fact.U, fact.L
    t_mat = time.time() - t0
    t0 = time.time()
    ok = factorization_verify(B, fact, 42)
    log(f"mk12.b4 complete PLUQ factors on the host: U {U.nnz} nnz, L "
        f"{L.nnz} nnz, materialized in {t_mat:.1f} s; factorization_verify "
        f"{ok} ({time.time() - t0:.1f} s)")
    if not ok:
        sys.exit("chip_smoke: mk12.b4 complete PLUQ fails "
                 "factorization_verify")
    del fact, U, L
    gplu_calls[0] = 0
    fact = _timed_rank(A10, ref10.r, "mk10.b3 rounds (device_dense_width=0)",
                       w0)
    _round_lines(fact)
    if not (_same_U(fact, ref10) and gplu_calls[0] > 0):
        sys.exit("chip_smoke: mk10.b3 on the card differs from the CPU run "
                 "or skipped the native GPLU finisher")
    log(f"  qinv and U bit-equal to the CPU run; {gplu_calls[0]} native "
        f"GPLU calls")
    ReducedBasis.build, native.gplu = build, gplu
    counts = dict(_cuda.launches)
    _launched(counts, ("B1", "B4 rref", "B4 lu"), "the rounds")
    log(f"the rounds: B1 {counts['B1']} launches over {builds[0]} "
        f"reduced-basis builds ({rb_builds} in the mk12.b4 rank run)")
    if counts["B1"] != builds[0] or rb_builds != 1:
        sys.exit("chip_smoke: B1 did not launch exactly once per "
                 "reduced-basis build on the rounds")
    return counts, rounds_ref


def _wide_rank(A, want: int, label: str, opts):
    """_timed_rank for the wide tiers: a rank other than want is rerun on
    the card's host (device="cpu") before the script fails, so the
    message tells a prime dividing the matrix's elementary divisors (the
    host agrees) from a fault of the card path (it does not)."""
    from spasm_tpu_torch import echelonize
    fact = _timed_rank(A, None, label, opts)
    if fact.r != want:
        host = echelonize(A, opts, device="cpu").r
        sys.exit(f"chip_smoke: {label} rank {fact.r} on the card, {host} "
                 f"on the host, {want} wanted")
    return fact


def wide_phase(mats) -> dict:
    """The d = 3/4 prime tiers, with the launch counts zeroed first (see
    the module docstring, phase 7).  mk12.b4's +-1 entries make it the
    same matrix over any field."""
    from spasm_tpu_torch import EchelonizeOptions, _cuda, echelonize
    from spasm_tpu_torch.certificate import factorization_verify
    from spasm_tpu_torch.csr import CSR
    from spasm_tpu_torch.dense.reduced import ReducedBasis
    from spasm_tpu_torch.field import Field
    from spasm_tpu_torch.gen import synthetic_sparse
    B = mats["mk12.b4"]
    want = MK["mk12.b4"][2]
    over = {p: CSR(B.n, B.m, Field(p), B.indptr, B.indices, B.data)
            for p in (P4, P3)}
    t0 = time.time()
    A16 = synthetic_sparse(16000, 16000, 8, P4)
    log(f"PLUQ16k at p = {P4}: {A16.n} x {A16.m}, {A16.nnz} nnz, generated "
        f"in {time.time() - t0:.1f} s")
    builds = [0]
    build = ReducedBasis.build

    def counted_build(self, *a):
        builds[0] += 1
        return build(self, *a)

    ReducedBasis.build = counted_build
    _cuda.reset_launches()
    # (a) default options: the rounds (nfree 20107 > 65536 // 4); one
    # call, like (d), to keep the script near half its time limit
    fact = _wide_rank(over[P4], want, f"mk12.b4 at p = {P4} (a: default "
                      "options, the rounds)", None)
    _round_lines(fact)
    if len(fact.rounds) < 2 or "schur_nnz" not in fact.rounds[0]:
        sys.exit("chip_smoke: (a) did not take the sparse Schur rounds")
    # (b), (c): the rank finisher in rows mode on int32 basis rows; one
    # run each, to leave time for the checkpoint phase
    rows_mode = EchelonizeOptions(device_dense_width=4 * 20480)
    for case, p in (("b", P4), ("c", P3)):
        fact = _wide_rank(over[p], want, f"mk12.b4 at p = {p} ({case}: "
                          "device_dense_width=81920, rows mode)", rows_mode)
        _round_lines(fact)
        if fact.rounds[-1].get("schur_nnz") is not None:
            sys.exit(f"chip_smoke: ({case}) took a sparse Schur round")
    # (d) complete PLUQ, its rank held to the rank path's
    r0 = echelonize(A16, device="cuda").r
    log(f"PLUQ16k at p = {P4} (d): rank {r0} through echelonize without L")
    fact = _wide_rank(A16, r0, f"PLUQ16k at p = {P4} (d: complete PLUQ)",
                      EchelonizeOptions(complete=True))
    t0 = time.time()
    U, L = fact.U, fact.L
    t_mat = time.time() - t0
    t0 = time.time()
    ok = factorization_verify(A16, fact, 42)
    log(f"  (d) factors on the host: U {U.nnz} nnz, L {L.nnz} nnz, "
        f"materialized in {t_mat:.1f} s; factorization_verify {ok} "
        f"({time.time() - t0:.1f} s)")
    if not ok:
        sys.exit("chip_smoke: (d) fails factorization_verify")
    wide16k = (A16, fact)                  # the tools phase reuses it
    del U, L
    ReducedBasis.build = build
    counts = dict(_cuda.launches)
    calls = dict(_cuda.calls)
    log(f"the wide tiers: launches {counts}; B1 wide over "
        f"{calls['B1 wide']} calls, {builds[0]} reduced-basis builds")
    _launched(counts, ("B1 wide", "B12"), "the wide tiers")
    if not counts["B1 wide"] == calls["B1 wide"] == builds[0]:
        sys.exit("chip_smoke: B1 wide did not launch exactly once per "
                 "reduced-basis build")
    narrow = {k: v for k, v in counts.items()
              if v and k not in ("B1 wide", "B12")}
    if narrow:
        sys.exit(f"chip_smoke: d = 2 kernels launched at p > 65535: "
                 f"{narrow}")
    return counts, wide16k


def _finishers_taken(fn):
    """fn() and the names of the echelonize finishers it entered, in
    order."""
    from spasm_tpu_torch.echelonize import _Engine
    taken = []
    saved = {k: getattr(_Engine, k) for k in (
        "finish_device_dense", "finish_dense", "finish_dense_lowrank",
        "finish_gplu")}

    def spy(name, f):
        def run(self, *a, **kw):
            taken.append(name)
            return f(self, *a, **kw)
        return run

    for k, f in saved.items():
        setattr(_Engine, k, spy(k, f))
    out = fn()
    for k, f in saved.items():
        setattr(_Engine, k, f)
    return out, taken


def _certificate_roundtrip(A, fact, label: str) -> None:
    """rank_certificate_create -> rank_certificate_verify true with r =
    fact.r; certificate_save -> certificate_load the same fields; false
    against a copy of A with one entry changed.  The fingerprint is the
    CSR's own (checkpoint.matrix_fingerprint)."""
    from spasm_tpu_torch import (certificate_load, certificate_save,
                                 rank_certificate_create,
                                 rank_certificate_verify)
    from spasm_tpu_torch.checkpoint import matrix_fingerprint
    h = matrix_fingerprint(A)
    t0 = time.time()
    proof = rank_certificate_create(A, h, fact)
    t1 = time.time()
    ok = rank_certificate_verify(A, h, proof)
    t2 = time.time()
    if not ok or proof.r != fact.r:
        sys.exit(f"chip_smoke: {label}: the rank certificate (r = {proof.r}, "
                 f"rank {fact.r}) does not verify")
    buf = io.StringIO()
    certificate_save(proof, buf)
    buf.seek(0)
    back = certificate_load(buf)
    if back is None or not all(
            np.array_equal(getattr(back, f), getattr(proof, f))
            for f in ("r", "prime", "hash", "i", "j", "x", "y")):
        sys.exit(f"chip_smoke: {label}: certificate_load does not give back "
                 f"the saved certificate")
    bad = A.copy()
    bad.data[0] = A.field.normalize(int(bad.data[0]) + 1)
    if rank_certificate_verify(bad, h, proof):
        sys.exit(f"chip_smoke: {label}: the certificate verifies on a "
                 f"changed matrix")
    log(f"{label}: rank certificate r = {proof.r}: create {t1 - t0:.3f} s, "
        f"verify {t2 - t1:.3f} s, true; save / load the same fields "
        f"({len(buf.getvalue())} bytes); false on A with one entry changed")


def _gesv_check(A, fact, k: int, label: str, outside: bool) -> None:
    """gesv on B = X.A for k rows X drawn from default_rng(1) in [0, p)
    (B built on the host, one spmv.xApy per row), plus, when outside, one
    random row, which a rank-deficient A must refuse: every other row
    comes back ok, and X'.A == B on each."""
    from spasm_tpu_torch import gesv
    from spasm_tpu_torch.csr import CSR
    from spasm_tpu_torch.spmv import xApy
    rng = np.random.default_rng(1)
    X = rng.integers(0, A.prime, (k, A.n))
    t0 = time.time()
    rows = []
    for x in X:
        b = np.zeros(A.m, np.int32)
        xApy(A.field.narray(x).astype(np.int32), A, b)
        nz = np.nonzero(b)[0]
        rows.append((nz.astype(np.int32), b[nz]))
    if outside:
        b = A.field.narray(rng.integers(0, A.prime, A.m)).astype(np.int32)
        nz = np.nonzero(b)[0]
        rows.append((nz.astype(np.int32), b[nz]))
    B = CSR.from_rows(len(rows), A.m, A.prime, rows)
    t_b = time.time() - t0
    t0 = time.time()
    Xs, ok = gesv(fact, B)
    t_g = time.time() - t0
    if not ok[:k].all() or (outside and ok[k]):
        sys.exit(f"chip_smoke: {label}: gesv ok {int(ok[:k].sum())} of {k} "
                 f"solvable rows" + (f", random row ok {bool(ok[k])}"
                                     if outside else ""))
    for i in range(k):
        x = np.zeros(Xs.m, np.int32)
        c, v = Xs.row(i)
        x[c] = v
        got = np.zeros(A.m, np.int32)
        xApy(x, A, got)
        want = np.zeros(A.m, np.int32)
        c, v = B.row(i)
        want[c] = v
        if not np.array_equal(got, want):
            sys.exit(f"chip_smoke: {label}: gesv row {i}: X'.A != B")
    log(f"{label}: gesv on {B.n} right-hand sides: {t_g:.3f} s "
        f"({t_g / B.n * 1e3:.2f} ms a row; B built in {t_b:.1f} s), "
        f"{int(ok.sum())} ok, X'.A == B on every solvable row"
        + ("; the random row refused" if outside else ""))


def _tool(args, label: str, want_rc: int = 0, stdin=None):
    """One fresh process of a port tool, as a user runs it."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", f"spasm_tpu_torch.cli.{args[0]}"]
                       + args[1:], input=stdin, cwd=HERE, capture_output=True,
                       timeout=600)
    wall = time.time() - t0
    if r.returncode != want_rc:
        sys.exit(f"chip_smoke: {label} exited {r.returncode}, not {want_rc}:\n"
                 + r.stderr.decode()[-3000:])
    log(f"  {label}: exit {r.returncode}, process wall {wall:.1f} s")
    return r


def tools_phase(pluq16k, tref, wide16k) -> dict:
    """The factorization's consumers and the tools, with the launch counts
    zeroed first (see the module docstring, phase 8)."""
    from spasm_tpu_torch import (EchelonizeOptions, _cuda, dulmage_mendelsohn,
                                 echelonize, kernel, kernel_from_rref, native,
                                 rref, sio)
    from spasm_tpu_torch.gen import synthetic_sparse
    from spasm_tpu_torch.spmv import xApy
    from chip_checks import scc_banded, upper_triangular
    t_phase = time.time()
    if not native.available():
        sys.exit("chip_smoke: the native library (matching, solves) did "
                 "not build")
    Aw = synthetic_sparse(16000, 16512, 8, P)
    A5 = scc_banded(N5, 8, 4 * N5, P)
    Au = upper_triangular(N5, P)
    _cuda.reset_launches()

    # (a) PLUQ16k: phase 5's factorization, L and U already on the host
    A16, f16 = pluq16k
    _certificate_roundtrip(A16, f16, "(a) PLUQ16k")
    _gesv_check(A16, f16, GESV_RHS, "(a) PLUQ16k", outside=True)

    # (b) the kernel basis of bench.py config 4's rank-deficient shape
    fact, taken = _finishers_taken(lambda: _timed_rank(
        Aw, None, f"(b) synthetic_sparse(16000, 16512, 8, {P}), default "
        "options", None))
    log(f"  (b) finishers taken: {taken}")
    t0 = time.time()
    K = kernel(fact)
    t_k = time.time() - t0
    if K.n != Aw.m - fact.r or K.n < 512:
        sys.exit(f"chip_smoke: (b) kernel has {K.n} rows, rank {fact.r}")
    At = Aw.transpose()
    for i in range(K.n):
        x = np.zeros(K.m, np.int32)
        c, v = K.row(i)
        x[c] = v
        y = np.zeros(At.m, np.int32)
        xApy(x, At, y)
        if np.any(y):
            sys.exit(f"chip_smoke: (b) kernel row {i} does not annihilate A")
    t0 = time.time()
    R, Rqinv = rref(fact)
    t_r = time.time() - t0
    t0 = time.time()
    K2 = kernel_from_rref(R, Rqinv)
    t_kr = time.time() - t0
    if not _same_csr(K, K2):
        sys.exit("chip_smoke: (b) kernel_from_rref(*rref(fact)) != "
                 "kernel(fact)")
    log(f"(b) kernel: {K.n} x {K.m}, {K.nnz} nnz in {t_k:.3f} s, A.K^T = 0; "
        f"rref {R.nnz} nnz in {t_r:.3f} s; kernel_from_rref {t_kr:.3f} s, "
        f"bit-equal to kernel(fact)")
    del fact, K, K2, R

    # (c) bench.py config 5 at 120 000 rows
    t0 = time.time()
    dm = dulmage_mendelsohn(A5)
    t_dm = time.time() - t0
    if dm.nb != DM_BLOCKS:
        sys.exit(f"chip_smoke: (c) DM gives {dm.nb} blocks, not {DM_BLOCKS}")
    log(f"(c) dulmage_mendelsohn on scc_banded({N5}, 8, {4 * N5}): {dm.nb} "
        f"blocks in {t_dm:.3f} s (native matching)")
    fact = _timed_rank(Au, N5, f"(c) upper_triangular({N5}) complete PLUQ",
                       EchelonizeOptions(L=True, complete=True))
    _certificate_roundtrip(Au, fact, "(c) upper_triangular")
    del fact

    # (d) the tools in fresh processes, trefethen_2000 at the default
    # modulus; echelonize --rref held to rref() of phase 5's CPU run
    A, ref_rank = tref
    mat = HERE / "tests" / "Matrix"
    tfile = str(mat / "trefethen_2000.sms")
    cert = HERE / "build" / "chip_smoke" / "trefethen_2000.cert"
    cert.parent.mkdir(parents=True, exist_ok=True)
    log("(d) the tools, fresh processes:")
    r = _tool(["rank", "-c", "-o", str(cert)], "rank -c -o FILE < "
              "trefethen_2000.sms", stdin=pathlib.Path(tfile).read_bytes())
    if r.stdout.decode().strip() != "2000" or \
            b"CORRECT certificate" not in r.stderr:
        sys.exit("chip_smoke: (d) rank -c did not certify rank 2000")
    _tool(["check_cert", "-c", str(cert), "--matrix", tfile],
          "check_cert on trefethen_2000")
    _tool(["check_cert", "-c", str(cert), "--matrix",
           str(mat / "small.sms")], "check_cert on small.sms", want_rc=1)
    R, _ = rref(ref_rank)
    want = io.StringIO()
    sio.save_csr(R, want)
    r = _tool(["echelonize", "--rref", "--matrix", tfile],
              "echelonize --rref on trefethen_2000")
    if r.stdout != want.getvalue().encode():
        sys.exit("chip_smoke: (d) echelonize --rref differs from rref() of "
                 "the CPU factorization")
    fact = echelonize(A, device="cuda")
    if not _same_csr(rref(fact)[0], R):
        sys.exit("chip_smoke: (d) rref of the card factorization differs "
                 "from the CPU one")
    log(f"  echelonize --rref: {len(r.stdout)} bytes, equal to rref() of the "
        f"CPU factorization, and so is rref() of the card's in this process")
    r = _tool(["kernel", "--modulus", "257", "--matrix",
               str(mat / "singular.sms")], "kernel on singular.sms at 257")
    Ks, _ = sio.load_csr(io.BytesIO(r.stdout), 257)
    if Ks.n != 1:
        sys.exit(f"chip_smoke: (d) kernel of singular.sms has {Ks.n} rows")
    _tool(["solve", "--modulus", "257", "--rhs", str(mat / "singular.sms"),
           "--matrix", str(mat / "singular.sms")],
          "solve on singular.sms at 257")
    r = _tool(["dm", "-v", "--matrix", str(mat / "dm.sms")], "dm -v on dm.sms")
    if b"structural rank" not in r.stdout:
        sys.exit("chip_smoke: (d) dm -v printed no structural rank")

    # (e) d = 4: phase 7's complete PLUQ at 2^32 - 5, factors on the host
    Aw4, fw4 = wide16k
    _certificate_roundtrip(Aw4, fw4, f"(e) PLUQ16k at p = {P4}")
    _gesv_check(Aw4, fw4, GESV_RHS, f"(e) PLUQ16k at p = {P4}",
                outside=False)

    counts = dict(_cuda.launches)
    keys = ["B4 rref"] + (["B1", "B3"] if "finish_device_dense" in taken
                          else [])
    _launched(counts, keys, "the tools")
    log(f"the tools: {time.time() - t_phase:.1f} s in all")
    return counts


PHASE_NAMES = ("PHASE_ROUND", "PHASE_FINISH", "PHASE_DENSE")
# the uninterrupted card runs of phases 4-7 that each resumed case
# compares its wall with
UNINTERRUPTED = {
    "a": "mk12.b4 warm",
    "b": "mk12.b4 rounds",
    "c": "PLUQ16k complete PLUQ warm",
    "d": "(d) uninterrupted on the card",
    "e": f"mk12.b4 at p = {P4} (a: default options, the rounds)"}
# the kernels each resume must launch
RESUME_KERNELS = {"a": ("B1", "B3"), "b": ("B4 rref",), "c": ("B4 lu",),
                  "d": ("B2",), "e": ("B1 wide",)}


def _ckpt_case(case: str, path: str):
    """One preempted run of the checkpoint phase: (A, options, the device
    the preempted child runs on, the phase whose first save ends it, the
    rank wanted).  The matrix is made anew in each process.  (b) and (c)
    save after every dense block (checkpoint_interval_s=0): (c) resumes
    with the default interval (see checkpoint_phase)."""
    from spasm_tpu_torch import EchelonizeOptions, sio
    from spasm_tpu_torch import checkpoint as ckpt
    from spasm_tpu_torch.csr import CSR
    from spasm_tpu_torch.field import Field
    from spasm_tpu_torch.gen import matching_complex_boundary, synthetic_sparse
    ck = dict(checkpoint_file=path)
    if case == "c":
        return (synthetic_sparse(16000, 16000, 8, P),
                EchelonizeOptions(complete=True, checkpoint_interval_s=0.0,
                                  **ck), "cuda", ckpt.PHASE_DENSE,
                PLUQ16K_RANK)
    if case == "d":
        A, _ = sio.load_csr(HERE / "tests" / "Matrix" / "mat364.sms", P)
        return (A, EchelonizeOptions(device_dense_min=0, **ck), "cpu",
                ckpt.PHASE_FINISH, 364)
    B = matching_complex_boundary(12, 4)
    if B.n < B.m:                            # the rank tool's orientation
        B = B.transpose()
    want = MK["mk12.b4"][2]
    if case == "b":
        return (B, EchelonizeOptions(device_dense_width=0,
                                     checkpoint_interval_s=0.0, **ck),
                "cuda", ckpt.PHASE_DENSE, want)
    if case == "e":
        return (CSR(B.n, B.m, Field(P4), B.indptr, B.indices, B.data),
                EchelonizeOptions(**ck), "cuda", ckpt.PHASE_ROUND, want)
    return B, EchelonizeOptions(**ck), "cuda", ckpt.PHASE_FINISH, want


def preempted_child(case: str, path: str) -> None:
    """A preempted run of the checkpoint phase, in a process of its own
    (`chip_smoke.py --preempted CASE FILE`): the case's echelonize, each
    save printed as one JSON line, and the process killed by SIGKILL
    right after the first save of the case's kill phase."""
    import signal
    sys.path.insert(0, str(HERE))
    from spasm_tpu_torch import echelonize
    from spasm_tpu_torch import checkpoint as ckpt
    logging.getLogger("spasm_tpu_torch").setLevel(logging.WARNING)
    A, opts, device, kill_at, _ = _ckpt_case(case, path)
    real = ckpt.save_checkpoint
    t_run = time.time()
    saves = []

    def save(file, **kw):
        t0 = time.time()
        real(file, **kw)
        saves.append(kw["phase"])
        print(json.dumps({"save": len(saves), "phase": kw["phase"],
                          "wall_s": time.time() - t0,
                          "bytes": os.path.getsize(file),
                          "run_s": time.time() - t_run}), flush=True)
        if kw["phase"] == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)

    ckpt.save_checkpoint = save
    echelonize(A, opts, device=device)
    sys.exit(f"chip_smoke: ({case}) ended without a {PHASE_NAMES[kill_at]} "
             f"save (saves: {saves})")


def _saves_line(saves) -> str:
    return "; ".join(f"{PHASE_NAMES[ph]} {wall:.3f} s, {size / 1e6:.1f} MB"
                     for ph, wall, size in saves) or "none"


def checkpoint_phase(rounds_ref) -> dict:
    """Checkpoint/resume, with the launch counts zeroed first (see the
    module docstring, phase 9).  rounds_ref: (qinv, U) of phase 6's warm
    mk12.b4 rounds run."""
    import dataclasses
    import signal
    import tempfile
    from spasm_tpu_torch import EchelonizeOptions, _cuda, echelonize
    from spasm_tpu_torch import checkpoint as ckpt
    from spasm_tpu_torch.certificate import factorization_verify
    t_phase = time.time()
    real = ckpt.save_checkpoint
    work = HERE / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    _cuda.reset_launches()
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        def start(case):
            path = os.path.join(tmp, f"{case}.ck")
            errf = open(path + ".err", "w+")
            return path, time.time(), errf, subprocess.Popen(
                [sys.executable, str(HERE / "chip_smoke.py"), "--preempted",
                 case, path], cwd=HERE, stdout=subprocess.PIPE,
                stderr=errf, text=True)

        # (c)'s child saves for about a minute on one host core: it runs
        # beside (a), (b), (d) and (e), which run one after another
        children = {"c": start("c")}
        for case in "abdec":
            path, t0, errf, proc = children.pop(case, None) or start(case)
            out, _ = proc.communicate(timeout=900)
            t_child = time.time() - t0
            errf.seek(0)
            err = errf.read()
            errf.close()
            A, opts, child_dev, kill_at, want = _ckpt_case(case, path)
            if proc.returncode != -signal.SIGKILL or \
                    not os.path.exists(path):
                sys.exit(f"chip_smoke: ({case}) preempted child exited "
                         f"{proc.returncode}, file present "
                         f"{os.path.exists(path)}:\n" + err[-3000:])
            child = [json.loads(ln) for ln in out.splitlines()
                     if ln.startswith("{")]
            log(f"({case}) child on {child_dev}, SIGKILL after its "
                f"{PHASE_NAMES[kill_at]} save ({child[-1]['run_s']:.1f} s "
                f"into the run, process {t_child:.1f} s"
                + (", beside (a), (b), (d) and (e)" if case == "c" else "")
                + f"), {len(child)} saves: " + _saves_line(
                    [(c["phase"], c["wall_s"], c["bytes"]) for c in child]))
            if case == "c":
                # a save of PLUQ16k's U + L takes one to two minutes
                # (PERF.md): the resume keeps the default interval
                opts = dataclasses.replace(
                    opts, checkpoint_interval_s=EchelonizeOptions
                    .checkpoint_interval_s)
            resumed = []

            def timed(file, **kw):
                t1 = time.time()
                real(file, **kw)
                resumed.append((kw["phase"], time.time() - t1,
                                os.path.getsize(file)))

            ckpt.save_checkpoint = timed
            before = dict(_cuda.launches)
            label = f"({case}) resumed on the card"
            fact, taken = _finishers_taken(
                lambda: _timed_rank(A, want, label, opts))
            ckpt.save_checkpoint = real
            if os.path.exists(path):
                sys.exit(f"chip_smoke: ({case}) the file was not removed")
            missing = [k for k in RESUME_KERNELS[case]
                       if _cuda.launches[k] == before[k]]
            if missing:
                sys.exit(f"chip_smoke: ({case}) the resume never launched "
                         f"{missing}")
            if case == "d":
                plain = dataclasses.replace(opts, checkpoint_file=None)
                if not _same_U(fact, echelonize(A, plain, device="cpu")):
                    sys.exit("chip_smoke: (d) the resume on the card differs "
                             "from the uninterrupted CPU run")
                log("  (d) qinv and U bit-equal to the uninterrupted CPU "
                    "run")
                _timed_rank(A, want, UNINTERRUPTED["d"], plain)
            log(f"  ({case}) file removed; resume {len(resumed)} saves: "
                f"{_saves_line(resumed)}; resume wall {WALLS[label]:.3f} s, "
                f"uninterrupted {WALLS[UNINTERRUPTED[case]]:.3f} s")
            if case == "b":
                log(f"  (b) resume's finishers taken: {taken}")
                same = (np.array_equal(fact.qinv, rounds_ref[0])
                        and _same_csr(fact.U, rounds_ref[1]))
                log(f"  (b) qinv and U equal to phase 6's uninterrupted "
                    f"card run: {same}")
            if case == "c":
                t0 = time.time()
                U, L = fact.U, fact.L
                t_mat = time.time() - t0
                t0 = time.time()
                ok = factorization_verify(A, fact, 42)
                log(f"  (c) U {U.nnz} nnz, L {L.nnz} nnz, materialized in "
                    f"{t_mat:.1f} s; factorization_verify {ok} "
                    f"({time.time() - t0:.1f} s)")
                if not ok:
                    sys.exit("chip_smoke: (c) fails factorization_verify")
                del U, L
            del fact
    counts = dict(_cuda.launches)
    _launched(counts, ("B1", "B1 wide", "B2", "B3", "B4 rref", "B4 lu"),
              "checkpoint/resume")
    log(f"checkpoint/resume: {time.time() - t_phase:.1f} s in all")
    return counts


def _mesh_run(label, A, opts, mesh, single_wall=None):
    """echelonize(A, opts) under `mesh`, timed to a synchronize, with its
    peak device memory, launches and mesh counters printed."""
    from spasm_tpu_torch import _cuda, echelonize
    from spasm_tpu_torch.parallel import context as mesh_ctx
    from spasm_tpu_torch.parallel import use_mesh
    before = dict(_cuda.launches)
    moved0 = sum(mesh_ctx.moved_bytes.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with use_mesh(mesh):
        fact = echelonize(A, opts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = {k: v - before[k] for k, v in _cuda.launches.items()
            if v != before[k]}
    log(f"{label}: rank {fact.r}, wall {wall:.3f} s"
        + (f" (single card {single_wall:.3f} s)" if single_wall else "")
        + f", peak device memory {peak:.2f} GiB, moved "
        f"{(sum(mesh_ctx.moved_bytes.values()) - moved0) / 2 ** 20:.1f} MiB,"
        f" launches {runs}")
    return fact, wall


def mesh_phase(mats, mk12, tref, pluq16k, rounds_ref) -> dict:
    """The mesh, with the launch counts and the mesh's counters zeroed
    first (see the module docstring, phase 10).  mk12: phase 4's warm
    mk12.b4 factorization; tref: (trefethen_2000, its CPU run, which
    phase 5 held the card run to); pluq16k: (A, phase 5's complete
    PLUQ); rounds_ref: (qinv, U) of phase 6's mk12.b4 rounds run."""
    from spasm_tpu_torch import EchelonizeOptions, _cuda, echelonize
    from spasm_tpu_torch.certificate import factorization_verify
    from spasm_tpu_torch.csr import CSR
    from spasm_tpu_torch.dense import reduced
    from spasm_tpu_torch.dense.subst import _subst_waves_plain
    from spasm_tpu_torch.echelonize import _Engine
    from spasm_tpu_torch.field import Field
    from spasm_tpu_torch.gen import matching_complex_boundary
    from spasm_tpu_torch.parallel import context as mesh_ctx
    from spasm_tpu_torch.parallel import make_mesh, use_mesh
    t_phase = time.time()
    cuda0 = torch.device("cuda", 0)
    meshes = [("A", make_mesh(devices=[cuda0] * 4))]
    log("mesh A: (2, 2) of cuda:0 x 4; one card: the mesh repeats cuda:0")
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        meshes.append(("B", make_mesh()))
        log(f"mesh B: make_mesh() over {ncards} cards, shape "
            f"{meshes[1][1].shape}: " + ", ".join(
                f"{d} {torch.cuda.get_device_name(d)}"
                for d in meshes[1][1].devices.ravel()))
    else:
        log(f"mesh B (make_mesh() over distinct cards): not run, "
            f"torch.cuda.device_count() = {ncards}")
    B, want = mats["mk12.b4"], MK["mk12.b4"][2]
    A_t, tref_ref = tref
    A16, pluq_ref = pluq16k
    A_t4 = CSR(A_t.n, A_t.m, Field(P4), A_t.indptr, A_t.indices, A_t.data)
    A10 = matching_complex_boundary(10, 3)
    if A10.n < A10.m:
        A10 = A10.transpose()
    pluq = EchelonizeOptions(complete=True)

    # B1 at a column shard's shape, against its plain version, timed
    b1_real_schedule(B, "mk12.b4", EchelonizeOptions(), shards=2)
    # R under the mesh (B1 on each column shard) == the single-card R
    eng = _Engine(B, EchelonizeOptions(), cuda0)
    eng.extract_structural(B)
    qfree = np.nonzero(eng.U.qinv < 0)[0]
    store = eng.U.flat_store()
    rb1 = reduced.ReducedBasis(B.m, P, qfree, eng.U.n, cuda0)
    rb1.build(*store)
    with use_mesh(meshes[0][1]):
        rbm = reduced.ReducedBasis(B.m, P, qfree, eng.U.n, cuda0)
        rbm.build(*store)
    Rm = rbm.R.gather()
    if not torch.equal(Rm, rb1.R):
        sys.exit("chip_smoke: R under mesh A differs from the single-card R")
    # and the plain wave loop (torch ops on the card) gives the same R
    real_subst = reduced.subst_waves
    reduced.subst_waves = _subst_waves_plain
    rbp = reduced.ReducedBasis(B.m, P, qfree, eng.U.n, cuda0)
    rbp.build(*store)
    reduced.subst_waves = real_subst
    if not torch.equal(Rm, rbp.R):
        sys.exit("chip_smoke: R under mesh A differs from the plain build")
    log(f"mk12.b4's R ({rbm.npad} x {rbm.M}) under mesh A, B1 on 2 column "
        f"shards of {rbm.M // 2}: bit-equal to the single-card R and to "
        f"the plain wave loop's")
    del eng, rb1, rbm, rbp, Rm
    torch.cuda.empty_cache()

    # the single-card runs that phases 4-9 did not keep
    _cuda.reset_launches()
    mesh_ctx.reset_counts()
    ref_t4 = _timed_rank(A_t4, None, f"trefethen_2000 at p = {P4}, single "
                         "card")
    ref10 = _timed_rank(A10, None, "mk10.b3 complete PLUQ, single card", pluq)
    expect = {"B1": 0, "B1 wide": 0}   # col_quantum() launches per build
    build = reduced.ReducedBasis.build

    def counted_build(self, *a):
        if self.npiv:
            expect["B1" if self.prime <= 65535 else "B1 wide"] += \
                mesh_ctx.col_quantum()
        return build(self, *a)

    reduced.ReducedBasis.build = counted_build
    walls = {}
    for tag, mesh in meshes:
        c = mesh.shape["cols"]
        # (a) the rank finisher, default options
        fact, walls[f"{tag} a"] = _mesh_run(
            f"({tag}a) mk12.b4 default options under mesh {tag}", B, None,
            mesh, WALLS["mk12.b4 warm"])
        if not (fact.r == want and _same_U(fact, mk12)):
            sys.exit(f"chip_smoke: ({tag}a) differs from phase 4's run")
        # (b) the SP axis: past one card's width cap, within cap x cols
        w = 12288
        (fact, walls[f"{tag} b"]), taken = _finishers_taken(lambda: _mesh_run(
            f"({tag}b) mk12.b4 device_dense_width={w} under mesh {tag}", B,
            EchelonizeOptions(device_dense_width=w), mesh))
        nfree = B.m - fact.rounds[0]["pivots"]
        if not (w < nfree <= w * c and taken == ["finish_device_dense"]
                and fact.r == want and _same_U(fact, mk12)):
            sys.exit(f"chip_smoke: ({tag}b) nfree {nfree}, finishers "
                     f"{taken}, rank {fact.r}: not the SP axis's rank "
                     f"finisher, or not phase 4's factorization")
        log(f"  {nfree} free columns > {w}, <= {w} x {c}: the rank finisher "
            f"(spy: {taken}); qinv and U bit-equal to phase 4's run")
        # (c) finish_dense RREF, column-sharded
        fact, walls[f"{tag} c"] = _mesh_run(
            f"({tag}c) trefethen_2000 default options under mesh {tag}", A_t,
            None, mesh, WALLS["trefethen_2000 rank (finish_dense, RREF)"])
        if not _same_U(fact, tref_ref):
            sys.exit(f"chip_smoke: ({tag}c) differs from phase 5's run")
        # (d) the complete PLUQ: row-sharded Schur, column-sharded LU
        fact, walls[f"{tag} d"] = _mesh_run(
            f"({tag}d) PLUQ16k complete PLUQ under mesh {tag}", A16, pluq,
            mesh, WALLS["PLUQ16k complete PLUQ warm"])
        t0 = time.time()
        same = (_same_U(fact, pluq_ref) and np.array_equal(fact.p, pluq_ref.p)
                and _same_csr(fact.L, pluq_ref.L))
        t_cmp = time.time() - t0
        t0 = time.time()
        ok = factorization_verify(A16, fact, 42)
        if not (same and ok):
            sys.exit(f"chip_smoke: ({tag}d) L, U, p equal {same}, "
                     f"factorization_verify {ok}")
        log(f"  L, U and p bit-equal to phase 5's run (factors read and "
            f"compared in {t_cmp:.1f} s); factorization_verify true "
            f"({time.time() - t0:.1f} s)")
        del fact
        # (e) a d = 4 prime: panel_steps, the wide tier's torch sweep
        fact, walls[f"{tag} e"] = _mesh_run(
            f"({tag}e) trefethen_2000 at p = {P4} under mesh {tag}", A_t4,
            None, mesh, WALLS[f"trefethen_2000 at p = {P4}, single card"])
        if not _same_U(fact, ref_t4):
            sys.exit(f"chip_smoke: ({tag}e) differs from the single card")
        # (f) L mode's sparse Schur rounds: DeviceCSR.densify row-sharded
        fact, walls[f"{tag} f"] = _mesh_run(
            f"({tag}f) mk10.b3 complete PLUQ under mesh {tag}", A10, pluq,
            mesh, WALLS["mk10.b3 complete PLUQ, single card"])
        if not (_same_U(fact, ref10) and np.array_equal(fact.p, ref10.p)
                and _same_csr(fact.L, ref10.L)
                and factorization_verify(A10, fact, 42)):
            sys.exit(f"chip_smoke: ({tag}f) differs from the single card or "
                     f"fails factorization_verify")
        # (g) the rounds: reduced-basis Schur round, finish_dense, low rank
        fact, walls[f"{tag} g"] = _mesh_run(
            f"({tag}g) mk12.b4 rounds (device_dense_width=0) under mesh "
            f"{tag}", B, EchelonizeOptions(device_dense_width=0), mesh,
            WALLS["mk12.b4 rounds"])
        if not (fact.r == want and np.array_equal(fact.qinv, rounds_ref[0])
                and _same_csr(fact.U, rounds_ref[1])):
            sys.exit(f"chip_smoke: ({tag}g) differs from phase 6's run")
        log(f"  (b)-(g) bit-equal to the single card: qinv and U, and L and "
            f"p where present; (d) and (f) verified")
    reduced.ReducedBasis.build = build
    counts = dict(_cuda.launches)
    _launched(counts, ("B1", "B3", "B4 rref", "B4 lu"), "the mesh")
    for k in ("B1", "B1 wide"):
        if counts[k] != expect[k]:
            sys.exit(f"chip_smoke: {k} launched {counts[k]} times, not "
                     f"cols x builds = {expect[k]}")
    log(f"B1 {counts['B1']} and B1 wide {counts['B1 wide']} launches = "
        f"cols x reduced-basis builds, single-card builds counted once")
    missing = [s for s in mesh_ctx.SITES if mesh_ctx.site_calls[s] == 0]
    if missing:
        sys.exit(f"chip_smoke: mesh sites never called: {missing}")
    log("mesh site calls and moved bytes (all meshes of this phase):")
    for s_, what in mesh_ctx.SITES.items():
        log(f"  site {s_} {what}: {mesh_ctx.site_calls[s_]} calls, "
            f"{mesh_ctx.moved_bytes[s_]} bytes")
    log(f"  moved in all: {sum(mesh_ctx.moved_bytes.values())} bytes")
    # the cost of sharding on one card (every mesh repeats cuda:0): not
    # a scaling curve, which needs distinct cards
    log("the cost of sharding on one card, mk12.b4 default options "
        "(meshes repeating cuda:0; not scaling):")
    for n in (1, 2, 4):
        mesh = make_mesh(devices=[cuda0] * n)
        mesh_ctx.reset_counts()
        fact, wall = _mesh_run(f"  {n} x cuda:0, shape {mesh.shape}", B,
                               None, mesh)
        if fact.r != want:
            sys.exit(f"chip_smoke: mk12.b4 on {n} x cuda:0: rank {fact.r}")
        del fact
    log(f"the mesh phase: {time.time() - t_phase:.1f} s")
    return counts


def _exact_rows(A: np.ndarray, B: np.ndarray, rows: np.ndarray,
                p: int) -> np.ndarray:
    """(A[rows] @ B) mod p, balanced, computed exactly on the host: A and
    B (|values| < 2^31) split into 16-bit limbs, the four limb products
    in float64 (each partial sum an integer below k * 2^32 < 2^53) and
    recombined in Python ints."""
    def limbs(x):
        x = x.astype(np.int64)
        return (x >> 16).astype(np.float64), (x & 0xFFFF).astype(np.float64)
    ah, al = limbs(A[rows])
    bh, bl = limbs(B)
    big = [(u @ v).astype(np.int64).astype(object)
           for u, v in ((ah, bh), (ah, bl), (al, bh), (al, bl))]
    full = (big[0] << 32) + ((big[1] + big[2]) << 16) + big[3]
    r = full % p
    return np.where(r > p // 2, r - p, r).astype(np.int64)


def _gfp_check(label, A, B, Z, p, rng) -> None:
    rows = np.sort(rng.choice(A.shape[0], 16, replace=False))
    want = _exact_rows(A, B, rows, p)
    got = Z[torch.from_numpy(rows).to(Z.device)].cpu().numpy()
    if not np.array_equal(got.astype(np.int64), want):
        sys.exit(f"chip_smoke: {label} modp_matmul is not exact on its "
                 f"sampled rows")


def dense_surface_phase() -> dict:
    """The `dense` exports and start_trace / stop_trace, with the launch
    counts zeroed first (see the module docstring, phase 11)."""
    import tempfile
    from chip_checks import cuda_ms
    from spasm_tpu_torch import _cuda
    from spasm_tpu_torch.dense import dense_lu, dense_rref, modp_matmul
    from spasm_tpu_torch.dense.modp import modp_matmul_np
    from spasm_tpu_torch.profiling import start_trace, stop_trace
    t_phase = time.time()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    smi = card()
    _cuda.reset_launches()

    # (a) bench_mxu's shape (bench.py:369, :385): n = 8192, d = 2
    n = 8192
    A = rng.integers(-(P // 2), P // 2 + 1, (n, n), dtype=np.int32)
    B = rng.integers(-(P // 2), P // 2 + 1, (n, n), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    Z = modp_matmul(A, B, P)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _gfp_check("(a)", A, B, Z, P, rng)
    Ad, Bd = torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev)
    ms = cuda_ms(lambda: modp_matmul(Ad, Bd, P), 10)
    I8 = torch.from_numpy(rng.integers(-128, 128, (n, n),
                                       dtype=np.int8)).to(dev)
    ms8 = cuda_ms(lambda: torch._int_mm(I8, I8), 10)
    # the same product with B column-major (what _mm8 does not pass)
    I8c = I8.t().contiguous().t()
    ms8c = cuda_ms(lambda: torch._int_mm(I8, I8c), 10)
    gf, i8 = 2 * n ** 3 / ms / 1e9, 2 * n ** 3 / ms8 / 1e9   # T op/s
    log(f"(a) modp_matmul {n}^2 at p = {P} (d = 2): {ms:.3f} ms, GF(p) "
        f"{gf:.1f} T op/s, exact on 16 sampled rows, peak device memory "
        f"{peak:.2f} GiB; torch._int_mm int8 {n}^2 (B row-major, as "
        f"_mm8 passes it): {ms8:.3f} ms, {i8:.1f} T op/s "
        f"({100 * i8 / 1979:.1f} % of the 1979 T op/s int8 peak); GF(p) "
        f"x 4 = {100 * 4 * gf / i8:.1f} % of the int8 rate; B "
        f"column-major: {ms8c:.3f} ms, {2 * n ** 3 / ms8c / 1e9:.1f} T op/s "
        f"[{smi}]")
    # (c) the numpy wrapper on (a)'s inputs
    if not np.array_equal(modp_matmul_np(A, B, P), Z.cpu().numpy()):
        sys.exit("chip_smoke: (c) modp_matmul_np differs from (a)")
    log("(c) modp_matmul_np equal to (a)'s product")
    del Z, Bd, I8, I8c, B

    # (b) the d = 4 tier at n = 4096
    n4 = 4096
    A4 = rng.integers(-(P4 // 2), P4 // 2 + 1, (n4, n4), dtype=np.int64
                      ).astype(np.int32)
    B4 = rng.integers(-(P4 // 2), P4 // 2 + 1, (n4, n4), dtype=np.int64
                      ).astype(np.int32)
    Z4 = modp_matmul(A4, B4, P4)
    _gfp_check("(b)", A4, B4, Z4, P4, rng)
    A4d, B4d = torch.from_numpy(A4).to(dev), torch.from_numpy(B4).to(dev)
    ms4 = cuda_ms(lambda: modp_matmul(A4d, B4d, P4), 10)
    log(f"(b) modp_matmul {n4}^2 at p = 2^32 - 5 (d = 4): {ms4:.3f} ms, "
        f"GF(p) {2 * n4 ** 3 / ms4 / 1e9:.2f} T op/s, exact on 16 sampled "
        f"rows [{smi}]")
    del Z4, A4d, B4d

    # (d) dense_rref / dense_lu through the exports: 1024 x 1024, rank 1000
    X = rng.integers(-(P // 2), P // 2 + 1, (1024, 1024), dtype=np.int32)
    X[1000:] = X[:24]
    for name, fn in (("dense_rref", dense_rref), ("dense_lu", dense_lu)):
        t0 = time.time()
        want = fn(X, P, device="cpu")
        t_cpu = time.time() - t0
        fn(X, P)                                 # warm
        torch.cuda.synchronize()
        t0 = time.time()
        got = fn(X, P)
        t_card = time.time() - t0
        rank = len(got[1]) if name == "dense_rref" else got[0]
        if rank != 1000 or not all(np.array_equal(a, b)
                                   for a, b in zip(got, want)):
            sys.exit(f"chip_smoke: (d) {name} on the card differs from its "
                     f"CPU run (rank {rank})")
        log(f"(d) {name} 1024^2 rank 1000: {t_card:.3f} s on the card "
            f"(warm), {t_cpu:.1f} s on the CPU, equal")

    # (e) a profiler trace of one modp_matmul
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        start_trace(tmp)
        modp_matmul(Ad, Ad, P)
        torch.cuda.synchronize()
        stop_trace()
        path = pathlib.Path(tmp) / "trace.json"
        events = json.loads(path.read_text())["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        log(f"(e) start_trace / stop_trace: {path.stat().st_size} bytes, "
            f"{len(events)} events, {kernels} CUDA kernel events")
        if not kernels:
            sys.exit("chip_smoke: (e) the trace holds no CUDA kernel event")
    counts = dict(_cuda.launches)
    _launched(counts, ("B4 rref", "B4 lu"), "the dense surface")
    log(f"the dense surface: {time.time() - t_phase:.1f} s")
    return counts


def main(argv) -> int:
    if argv[:1] == ["--preempted"]:
        preempted_child(*argv[1:3])
    t0 = time.time()
    kind = device_phase()
    sys.path.insert(0, str(HERE))
    build_phase()
    logging.getLogger("spasm_tpu_torch").setLevel(logging.WARNING)
    mats = matching_complexes()
    kernels = kernel_phase(mats)
    counts, mk12 = rank_path_phase(mats)
    counts4, pluq16k, tref = dense_finisher_phase()
    counts5, rounds_ref = rounds_phase(mats)
    counts6, wide16k = wide_phase(mats)
    counts7 = tools_phase(pluq16k, tref, wide16k)
    del wide16k
    counts8 = checkpoint_phase(rounds_ref)
    counts9 = mesh_phase(mats, mk12, tref, pluq16k, rounds_ref)
    del pluq16k, mk12
    counts10 = dense_surface_phase()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "spasm_tpu"))
    if leaked:
        sys.exit(f"chip_smoke: JAX modules were imported: {leaked[:5]}")
    # launches: the sum over the paths (phases 4-11)
    paths = (counts, counts4, counts5, counts6, counts7, counts8, counts9,
             counts10)
    for k, keys in (("B1", ["B1"]), ("B1 wide", ["B1 wide"]), ("B2", ["B2"]),
                    ("B3", ["B3"]), ("B4", ["B4 rref", "B4 lu"]),
                    ("B12", ["B12"])):
        kernels[k]["launches"] = sum(c[key] for c in paths for key in keys)
    log(f"chip_smoke: {time.time() - t0:.1f} s in all, the build included")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
