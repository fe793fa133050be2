#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace] [--out FILE]
    python3 chip_smoke.py --walls N    # eager plan walls only (A/B runs)

Drives the port's paths on the card at the repo's bench scales (seed 0),
in phases that each raise on failure:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (sm_90a), and
   a one-thread probe of a dependent float64 add's latency, one nvcc per
   source, all started together;
3. hash-join kernels: each (build; probe count with its tile sums and
   offsets, segment lists and total; probe emit) against its plain
   PyTorch version on the card, for exact equality, the offsets and total
   also against `torch.cumsum` of the counts and the maps against the
   sort-based join,
   at q3's shapes and TPC-DS q3's INT32 ones, on a dtype/null/multi-key
   matrix, on duplicate build keys (up to 512 equal ones, past the emit's
   staging buffer), on probes with no row and with every row matched, at
   probe sizes on and off the kernels' tiles and rows a thread, and on key
   columns that are views one element into their buffers; two joins at
   once on two streams; then timed at q3's and TPC-DS q3's shapes, each
   kernel alone and the whole `inner_join_hash` call (every kernel, copy
   and memset it runs). `--join-profile` runs only that last timing, the
   one measurement that also runs against a tree with the earlier probe
   interface;
3b. the hash join's large route (tables over 1,024 slots): the build
   against its plain version at 513, 1,025 and 52,000 rows, on 600 equal
   keys, with nulls, INT32 and INT64 keys, one and two key columns and
   columns one element into their buffers, each case's count and emit
   against theirs and the whole `inner_join_hash` against a numpy join,
   with its rounds, device and one-call time, bound and one grid barrier
   timed alone; then 2^22 rows (the ceiling) taken and one more declined;
4. q3: NDS q3 at 10,000,000 store_sales rows through
   `PlanExecutor(optimize=False)` (the authored plan, as in earlier runs),
   launch counters zeroed before and read after; the result must equal an
   independent numpy q3 and the port's own run on the CPU;
4b. TPC-DS q3: q3 as TPC-DS writes it (INT32 keys, LIMIT 100) at the same
   scale through `PlanExecutor()`, optimizer on: two FusedSelects, two
   HashJoins and a TopK on their kernels, counters zeroed before and read
   after; equal to numpy q3's first 100 rows and the CPU run; the two
   FusedSelects of the executed plan, on its dates and items tables,
   against their plain version; and every group of the plan without its
   LIMIT against numpy q3;
4b'. q72: NDS q72 at 10,000,000 catalog_sales rows through
   `PlanExecutor(optimize=False)` and `PlanExecutor()`, counters zeroed
   before each and read after: five HashJoins, the inventory join (52,000
   build rows) on the large route, FusedSelects where the optimizer fuses
   the filters, no plain version run; equal to an independent numpy q72
   and to the CPU run; warm walls; then the inventory join's build, count
   and emit timed at its shape;
4b''. C4: a FLOAT64 column of 10M rows summed and averaged over 3 and
   1,000 groups through `PlanExecutor`, twice on the card, each run's
   bits equal to the CPU run's (the groupby kernel's fold), with
   `index_add_` on the card beside it; the fold timed at 3 groups;
4b'''' groupby: the groupby kernel against its plain version on the CPU,
   bit for bit: every op on INT8 to TIMESTAMP_US, with nulls and all-null
   groups, one group, all rows distinct, groups across tile edges, 0 to
   100,003 rows, NaN payloads that tell a fold's first NaN from its last,
   eager and capped (key_cap below, at and above the group count, alive
   masks), and q23's zipf keys at 10M rows; then timed at q23's two keyed
   aggregates and the C4 shapes beside `index_add_`, the plain version,
   the bytes bound and, for the fold, the chain bound from the probe;
4b'''. the capped tier: the capped hash join against its plain version
   (`ops.join.inner_join_capped`), all four outputs bit for bit, at the
   join shapes and alive masks of q3's two joins, q72's 20-row hd join
   (the small route) and its inventory join (recorded from a cold capped
   run of each plan), each at the plan's row_cap, the total, the total + 1
   and half the total (overflowing), and on a 2^22-row build with half its
   rows dead; the capped TopK against its plain version on
   kernel_bench.py's 10M-row table at k = 50, 100 and 4,099 (both routes,
   by the launch counters) with 60%, 0% and 100% of rows live; q3
   (authored), TPC-DS q3 (optimized) and q72 (both) at 10M rows through
   `PlanExecutor(mode="capped")`, counters zeroed before and read after
   the counted run: one attempt, every inner join on the capped kernels,
   the TopK on its kernels, no plain version run, `compact()` equal to the
   eager run on the card and to numpy; on a warm run the sync-debug
   warnings and the traced synchronize calls and device-to-host copies,
   each at most attempts + 1; warm walls and idle shares of the capped
   and eager TPC-DS q3 and q72; q3 at 100,000 rows from caps of 128 rows
   and 16 keys escalating to equal the eager run; the capped join timed
   at q72's inventory join and the capped TopK at k = 100;
4g. NDS q5 (20,166,666 input rows: Unions, semi joins to a date window,
   a rollup) and NDS q23 (17,500,000 rows: two shared subqueries, the
   scalar subquery `rev > 0.95 * MAX(rev)`) at scale 1 through
   `PlanExecutor(optimize=False)`, `PlanExecutor()` and both in the
   capped tier at the reference bench's key caps (2,048 and 8,192), every
   kernel counter zeroed just before each counted run and read just after:
   the groupby kernel is the one kernel on these paths, so it launches
   once per keyed aggregate, every other launch and every plain-run count
   reads 0 and no other stamp names a `cuda:` kernel; a traced run finds
   no scatter inside a keyed aggregate; each result
   equal to an independent numpy evaluation and to the port's CPU run,
   bit for bit; warm walls, one traced warm run's idle share, and the
   capped runs' attempts and host reads (at most attempts + 1);
4c. FusedSelect: the kernel against its plain version on every port dtype,
   with and without nulls, nineteen predicates (the four shapes, INT8/INT32
   wrap-around, 64-bit integer columns, float32/float64 arithmetic and
   promotion, a literal-only predicate, a right-nested chain) at 0, 1,
   1,000 and 1,000,003 rows, at row counts off the kernel's 4 rows a
   thread and 1,024 a step, and with every column a view one element into
   its buffers; then timed on benchmarks/kernel_bench.py's table (10M
   rows) with INT32 and with INT64 predicate columns, the count kernel by
   program nodes and the compaction alone by rows kept;
4d. TopK: the kernel against its plain version on seven key kinds with and
   without nulls at k = 1, 17, 100, 128, 129, 513, 1,000 and 4,099 (over
   a nullable key the tile sort takes 4,099), multi-key, k > rows and 0
   rows; then on kernel_bench.py's table (10M rows, keys [k DESC, v ASC]) at k = 50, 100
   and 1,000 and on each side of the route rule's boundary, and at 10M
   rows on keys in descending order (every row beats the threshold), all
   equal and all null, each against its plain version, the route checked
   by the launch counters and timed beside the tile route on the same
   call;
5. row hash: `bench.py`'s workload (10,000,000 rows x 2 INT64 columns)
   through `ops.murmur_hash3_32` + `ops.xxhash64` (two launches),
   `ops.fused_row_hash` (one) and `api.Hash`, counters zeroed before and
   read after; the kernel equals its plain version on the card, bit for
   bit, at that size and on a dtype/null/NaN/length matrix, and equals a
   numpy evaluation written here; then timed, with the headline
   `spark_row_hash_throughput` line;
6. partition: `benchmarks/bench_partition.py`'s ids (10,000,000 for P = 8
   and 64) and P = 200, Spark's default `spark.sql.shuffle.partitions`,
   through `parallel.partition_histogram`, and the shuffle chain
   murmur3 (seed 42) -> `partition_ids` -> histogram, `build_partition_map`
   and `build_partition_map_scan`; the kernel equals its plain version and
   `np.bincount`, the three counts agree and the two maps are identical,
   also on small cases for P from 1 to 13,000 (Spark's default 200 among
   them); then timed beside `torch.bincount`;
7. prints one `{"kernels": [...]}` line, then as the last line
   `{"ok": true, "device": {...}}`.

Each kernel is timed by its device time from torch.profiler's kernel
records, one wrapper call's time between CUDA events (the L2 flushed
before each call in both), its plain version's time, and its bound: the
larger of the bytes this run's data needs over 3.35 TB/s and its integer
operations over the card's integer rate. FusedSelect and TopK are also
timed beside the nearest PyTorch calls (`library_ms`).

It imports nothing of JAX or of `spark_rapids_tpu`. Without a CUDA device,
or outside the repo checkout, it exits non-zero and prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_SALES = 10_000_000               # the repo's q3 bench at scale 1
N_ROWS = 10_000_000                # bench.py and bench_partition.py
# bench_partition.py's bucket counts and Spark's default shuffle partitions
PARTITIONS = (8, 64, 200)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
# 32-bit integer instructions: 64 per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x 1.98 GHz boost (H100 SXM data sheet). The float32 rate outside the
# tensor cores (67 T/s) counts 128 lanes and a fused multiply-add as two.
PEAK_INT_OPS_PER_S = 64 * 132 * 1.98e9
# float64 outside the tensor cores: 34 T/s (H100 SXM data sheet)
PEAK_F64_OPS_PER_S = 34e12
# murmur3 integer operations per key column: mm_round is 11, the column's
# closing xor and fmix 9, and a wide key a second round plus a shift
HASH_OPS = {False: 20, True: 32}
# row-hash instructions, counted from csrc/row_hash.cu (its header): per
# 8-byte column murmur3 21, xxhash64 32, load/encode/null test 8 and the
# column loop 3; per row the index, seeds and stores, 9 (12 for both hashes)
RH_COL_OPS = {"murmur": 21 + 11, "xxhash": 32 + 11, "fused": 21 + 32 + 11}
RH_ROW_OPS = {"murmur": 9, "xxhash": 9, "fused": 12}
RH_OUT_BYTES = {"murmur": 4, "xxhash": 8, "fused": 12}
# histogram: per id a range compare and a shared-memory add
HIST_OPS = 2
# the count kernel's two forms: 32-bit values, 64-bit values
FS_COUNT = ("fs_count_kernel<int>", "fs_count_kernel<longlong>")
KERNEL_NAMES = {"build": "build_kernel", "count": "count_kernel<false>",
                "emit": "emit_kernel<false>",
                "build_large": "build_large_kernel",
                "count_large": "count_kernel<true>",
                "emit_large": "emit_kernel<true>",
                "segment_sum": ("gb_fold_short_kernel",
                                "gb_fold_long_kernel"),
                "groupby": ("gb_fill_kernel", "gb_reduce_kernel",
                            "gb_fold_short_kernel", "gb_fold_long_kernel"),
                "murmur": "row_hash_kernel<true,false>",
                "xxhash": "row_hash_kernel<false,true>",
                "fused": "row_hash_kernel<true,true>",
                "histogram": "hist_kernel",
                "fused_select": ("fs_count_kernel<int>",
                                 "fs_count_kernel<longlong>",
                                 "fs_compact_kernel"),
                "topk": ("tk_threshold_kernel", "tk_select_kernel",
                         "tk_merge_kernel")}
SOURCE = "spark_rapids_tpu_torch/ops/csrc/hash_join.cu"
RH_SOURCE = "spark_rapids_tpu_torch/ops/csrc/row_hash.cu"
HIST_SOURCE = "spark_rapids_tpu_torch/ops/csrc/partition_hist.cu"
FS_SOURCE = "spark_rapids_tpu_torch/ops/csrc/fused_select.cu"
TK_SOURCE = "spark_rapids_tpu_torch/ops/csrc/topk.cu"
GB_SOURCE = "spark_rapids_tpu_torch/ops/csrc/groupby.cu"
REPLACES = {
    "build": "spark_rapids_tpu/ops/join_pallas.py:122",
    "count": "spark_rapids_tpu/ops/join_pallas.py:209",
    "emit": "spark_rapids_tpu/ops/join_pallas.py:244",
    "row_hash": "spark_rapids_tpu/ops/hash_pallas.py:248",
    "histogram": "spark_rapids_tpu/parallel/partition_pallas.py:33",
    "fused_select": "spark_rapids_tpu/ops/select_pallas.py:179",
    "topk": "spark_rapids_tpu/ops/topk_pallas.py:88",
}
TPCDS_LIMIT = 100                  # TPC-DS q3's `limit 100`
TOPK_LIMITS = (50, 100)            # kernel_bench.py's 50 and TPC-DS's 100
TOPK_LARGE_LIMIT = 1000            # a limit past half of a sort tile


def log(msg=""):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---- phase 1 -----------------------------------------------------------------

def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), "
        f"{torch.cuda.get_device_name(0)}")
    return smi


# ---- phase 2 -----------------------------------------------------------------

# one thread's chain of dependent float64 adds: one add's latency, which
# bounds a row-order fold (a measuring probe, run by no path)
DADD_PROBE = r"""
#include <cuda_runtime.h>
__global__ void dadd_chain_kernel(long long rounds, double step,
                                  double* out) {
  double acc = out[0];
#pragma unroll 16
  for (long long r = 0; r < rounds; ++r) acc += step;
  out[0] = acc;
}
extern "C" int dadd_chain(long long rounds, double* out, void* stream) {
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, 1.0, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_phase():
    """Every source of the port, and the dependent-add probe, one nvcc
    each, started together; -> the probe's loaded library."""
    import ctypes
    from spark_rapids_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    # built beside the port's libraries (listed in .gitignore)
    src = cuda_build._BUILD_DIR / f"dadd_probe-{os.getpid()}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(DADD_PROBE)
    probe_lib = src.with_suffix(".so")
    probe = subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build._FLAGS, "-o", str(probe_lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    secs = cuda_build.build()
    probe_log, _ = probe.communicate()
    require(probe.returncode == 0, f"nvcc failed for the dependent-add "
            f"probe:\n{probe_log}")
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items()) or 'cached'})")
    for name in cuda_build.SOURCES:
        for line in cuda_build.compiler_report(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    lib = ctypes.CDLL(str(probe_lib))
    lib.dadd_chain.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.dadd_chain.restype = ctypes.c_int
    return lib


# ---- phase 3 -----------------------------------------------------------------

class Checks:
    def __init__(self):
        self.max_err = {"build": 0, "count": 0, "emit": 0, "row_hash": 0,
                        "histogram": 0, "fused_select": 0, "topk": 0,
                        "build_large": 0, "count_large": 0,
                        "emit_large": 0, "segment_sum": 0, "groupby": 0,
                        "capped_join": 0, "capped_topk": 0, "plans": 0}
        self.n = 0

    def equal(self, kernel, a, b, what):
        import torch
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: shape/dtype {tuple(a.shape)} "
                                 f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if not torch.equal(a, b):
            # the difference is a diagnostic only: in int64 it may wrap to
            # read 0 or less, so a mismatch records at least 1
            bad = int((a != b).sum())
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            self.max_err[kernel] = max(self.max_err[kernel], diff, 1)
            raise AssertionError(f"{what}: kernel differs from its plain "
                                 f"version in {bad} values (max abs err "
                                 f"{diff})")
        self.n += 1

    def tables(self, kernel, got, want, what):
        """Two tables equal: names, rows, every column's data (floats as
        their bits, so NaN rows compare) and validity."""
        import torch
        if got.names != want.names or got.num_rows != want.num_rows:
            self.max_err[kernel] = max(self.max_err[kernel], 1)
            raise AssertionError(f"{what}: {got.names} x {got.num_rows} vs "
                                 f"{want.names} x {want.num_rows}")
        for name, a, b in zip(got.names, got.columns, want.columns):
            if a.dtype.is_floating:
                bits = torch.int32 if a.data.dtype == torch.float32 \
                    else torch.int64
                self.equal(kernel, a.data.view(bits), b.data.view(bits),
                           f"{what} {name}")
            else:
                self.equal(kernel, a.data, b.data, f"{what} {name}")
            if (a.validity is None) != (b.validity is None):
                self.max_err[kernel] = max(self.max_err[kernel], 1)
                raise AssertionError(f"{what} {name}: validity present on "
                                     "one side only")
            if a.validity is not None:
                self.equal(kernel, a.validity, b.validity,
                           f"{what} {name} validity")


def check_case(chk, jc, join, pcols, bcols, what):
    """Every kernel of one join against its plain version on the card: the
    table, the counts, tile sums and offsets, segment sums, matched rows
    and lists, the total (the offsets and total also against torch.cumsum
    of the counts) and both maps (also against the sort-based fallback)."""
    import torch
    C = jc._capacity(bcols[0].length)
    tk = jc.build_table_cuda(bcols, C)
    tp = jc.build_table_plain(bcols, C)
    chk.equal("build", tk.slot_row, tp.slot_row, f"{what} slot_row")
    chk.equal("build", tk.slot_hash, tp.slot_hash, f"{what} slot_hash")
    pk = jc.probe_counts_cuda(pcols, tk, bcols)
    pp = jc.probe_counts_plain(pcols, tp, bcols)
    for name in ("counts", "tile_sums", "tile_offsets", "seg_sums",
                 "seg_matched", "total"):
        chk.equal("count", getattr(pk, name), getattr(pp, name),
                  f"{what} {name}")
    # each segment's list of matched rows, as far as the segment has them
    at = torch.arange(pk.counts.shape[0], device=pk.counts.device)
    listed = (at % pk.seg) < pk.seg_matched.index_select(0, at // pk.seg)
    chk.equal("count", pk.entries[listed], pp.entries[listed],
              f"{what} entries")
    c64 = pk.counts.to(torch.int64)
    incl = torch.cumsum(c64, 0)
    first = torch.arange(0, c64.shape[0], jc.TILE, device=c64.device)
    chk.equal("count", pk.tile_offsets, (incl - c64).index_select(0, first),
              f"{what} tile offsets vs cumsum")
    chk.equal("count", pk.total.reshape(1), incl[-1:],
              f"{what} total vs cumsum")
    total = int(pk.total)
    lk, rk = jc.probe_emit_cuda(pcols, tk, bcols, pk, total)
    lp, rp = jc.probe_emit_plain(pcols, tp, bcols, pp, total)
    chk.equal("emit", lk, lp, f"{what} left map")
    chk.equal("emit", rk, rp, f"{what} right map")
    fl, fr = join.inner_join(pcols, bcols)
    chk.equal("emit", lk, fl.data, f"{what} left map vs sort-based join")
    chk.equal("emit", rk, fr.data, f"{what} right map vs sort-based join")
    torch.cuda.synchronize()
    return total


def matrix_cases(torch, dt, Column, tile):
    rng = np.random.default_rng(1)
    nl, nr = 200_003, 500

    def col(arr, dtype, null_p=0.0):
        v = (rng.random(arr.shape[0]) > null_p) if null_p else None
        return Column.from_numpy(arr, dtype, v, device="cuda")

    specs = [("int64", np.int64, dt.INT64), ("int32", np.int32, dt.INT32),
             ("int16", np.int16, dt.INT16), ("int8", np.int8, dt.INT8),
             ("date32", np.int32, dt.DATE32),
             ("decimal32", np.int32, dt.decimal(9, 2)),
             ("decimal64", np.int64, dt.decimal(18, 2))]
    for name, npt, dtype in specs:
        for null_p in (0.0, 0.1):
            lk = rng.integers(-60, 60, nl).astype(npt)
            rk = rng.integers(-60, 60, nr).astype(npt)
            yield (f"{name} nulls={null_p}", [col(lk, dtype, null_p)],
                   [col(rk, dtype, null_p)])
    for null_p in (0.0, 0.1):
        yield (f"bool nulls={null_p}",
               [col(rng.integers(0, 2, nl).astype(bool), dt.BOOL, null_p)],
               [col(rng.integers(0, 2, 40).astype(bool), dt.BOOL, null_p)])
    yield ("int64+int32 key",
           [col(rng.integers(0, 40, nl).astype(np.int64), dt.INT64),
            col(rng.integers(0, 3, nl).astype(np.int32), dt.INT32, 0.05)],
           [col(rng.integers(0, 40, nr).astype(np.int64), dt.INT64),
            col(rng.integers(0, 3, nr).astype(np.int32), dt.INT32)])
    # six key columns: four staged in shared memory, two read from the
    # build columns
    kinds = [(np.int64, dt.INT64), (np.int32, dt.INT32), (np.int16, dt.INT16),
             (np.int8, dt.INT8), (np.int32, dt.DATE32), (np.int64, dt.INT64)]
    build = [rng.integers(0, 2, 300).astype(npt) for npt, _ in kinds]
    pick = rng.integers(0, 300, nl)
    yield ("six keys",
           [col(np.where(rng.random(nl) < 0.9, b[pick],
                         rng.integers(0, 2, nl)).astype(npt), dtype,
                0.02 if j == 5 else 0.0)
            for j, (b, (npt, dtype)) in enumerate(zip(build, kinds))],
           [col(b, dtype) for b, (_, dtype) in zip(build, kinds)])
    yield ("all-null probe",
           [col(rng.integers(0, 5, 3000).astype(np.int64), dt.INT64, 1.0)],
           [col(rng.integers(0, 5, 50).astype(np.int64), dt.INT64)])
    yield ("all-null build",
           [col(rng.integers(0, 5, 3000).astype(np.int64), dt.INT64)],
           [col(rng.integers(0, 5, 50).astype(np.int64), dt.INT64, 1.0)])
    rk = rng.integers(-2**40, 2**40, 512).astype(np.int64)
    lk = np.where(rng.random(nl) < 0.5, rng.choice(rk, nl),
                  rng.integers(-2**40, 2**40, nl)).astype(np.int64)
    yield ("build 512 rows", [col(lk, dt.INT64)], [col(rk, dt.INT64)])
    # duplicate build keys: 512 equal ones give 512 pairs a matched row, so
    # every segment with a match overflows the emit's staging buffer; 64
    # each of 8 keys overflow some segments
    same = np.full(512, 7, np.int64)
    yield ("512 equal build keys",
           [col(np.where(rng.random(20_011) < 0.3, 7, 8).astype(np.int64),
                dt.INT64, 0.05)], [col(same, dt.INT64)])
    eight = np.repeat(np.arange(8, dtype=np.int32), 64)
    yield ("64 each of 8 build keys",
           [col(rng.integers(0, 60, nl).astype(np.int32), dt.INT32)],
           [col(rng.permutation(eight), dt.INT32)])
    uniq = rng.permutation(1000).astype(np.int64)[:400]
    yield ("no row matched",
           [col(rng.integers(1000, 5000, nl).astype(np.int64), dt.INT64)],
           [col(uniq, dt.INT64)])
    yield ("every row matched",
           [col(rng.choice(uniq, nl), dt.INT64)], [col(uniq, dt.INT64)])
    # probe sizes on and off the tiles and a thread's 8 rows
    for n in (1, 7, 8, 9, tile - 1, tile, tile + 1, 3 * tile - 1, 3 * tile,
              3 * tile + 1):
        yield (f"{n} probe rows",
               [col(rng.choice(uniq, n), dt.INT64, 0.1)],
               [col(uniq, dt.INT64)])
    # key columns (and validity) one element into their buffers: the
    # kernels' vector loads must take the scalar path there
    for npt, dtype in ((np.int64, dt.INT64), (np.int32, dt.INT32),
                       (np.int16, dt.INT16), (np.int8, dt.INT8)):
        for n in (nl, 3 * tile + 5):
            pk = col(rng.integers(-30, 30, n + 1).astype(npt), dtype, 0.1)
            bk = col(rng.integers(-30, 30, 101).astype(npt), dtype)
            yield (f"{np.dtype(npt).name} views at offset 1, n={n}",
                   [Column(dtype, n, pk.data[1:], pk.validity[1:])],
                   [Column(dtype, 100, bk.data[1:], None)])


def time_cuda(torch, fn, iters):
    """Mean time of `fn` between one pair of CUDA events around `iters`
    back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = {}


def flush_l2(torch):
    """Overwrite 256 MB of device memory, five times the card's 50 MB L2, so
    that the next kernel reads its inputs from device memory, as the bound
    assumes."""
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(64 << 20, dtype=torch.int32,
                                    device="cuda")
    _FLUSH["buf"].fill_(1)


def call_ms(torch, fn, iters):
    """Median time of one call of `fn` between its own pair of CUDA events,
    the card idle and its L2 flushed before each: the kernel plus the
    host's launch of it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush_l2(torch)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, kernel, iters, attempts=3, per_call=1):
    """Mean device time per call of the kernel named `kernel` (or of the
    kernels of a tuple of names, summed) over `iters` calls of `fn`, the L2
    flushed before each, from torch.profiler's records of the kernels the
    card ran; a call launches `per_call` of them. A profile that comes back
    without every run's record (CUPTI sometimes drops a session's records)
    is taken again, at most `attempts` times; if none is whole, the time
    is the mean of the most complete profile's records times `per_call`,
    as long as it holds at least half of them, else one call's time
    between CUDA events (the log says which)."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = iters * per_call
    best = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush_l2(torch)
                fn()
            torch.cuda.synchronize()
        # demangled: "void probe_kernel<false>(Keys, ...)", "build_kernel(...)"
        us = [e.time_range.elapsed_us() for e in prof.events()
              if str(e.device_type).endswith("CUDA")
              and e.name.split("(")[0].removeprefix("void ").replace(" ", "")
              in names]
        if len(us) == want:
            return sum(us) / iters / 1e3
        log(f"  (the profiler recorded {len(us)} runs of {kernel} for "
            f"{iters} calls; profiling again)")
        if want >= len(us) > len(best):
            best = us
    if 2 * len(best) >= want:
        log(f"  (the time of {kernel} is the mean of {len(best)} of {want} "
            f"runs recorded)")
        return sum(best) / len(best) * per_call / 1e3
    log(f"  (the profiler kept too few runs of {kernel}: its time is one "
        f"call's between CUDA events, launch included)")
    return call_ms(torch, fn, iters)


def device_by_name(torch, fn, iters, attempts=3):
    """Per call of `fn` (the L2 flushed before each): the mean device time
    of everything it ran on the card, kernels, copies and memsets, and of
    each kernel by name, from torch.profiler's records; the flush's own
    kernel is left out. A profile that comes back without a record of every
    call (CUPTI sometimes drops a session's records) is taken again; if
    none is whole, each name's time is the mean of the most complete
    profile's records of it times its runs a call, and with no record at
    all one call's time between CUDA events (the log says which)."""
    from torch.profiler import ProfilerActivity, profile

    def device_events(body):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if str(e.device_type).endswith("CUDA")]

    if "names" not in _FLUSH:
        for _ in range(attempts):
            _FLUSH["names"] = {name for name, _ in
                               device_events(lambda: flush_l2(torch))}
            if _FLUSH["names"]:
                break
        require(_FLUSH["names"], "the profiler recorded no flush kernel")
    flush = _FLUSH["names"]
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(attempts):
        def body():
            for _ in range(iters):
                flush_l2(torch)
                fn()
        events = [(name, us) for name, us in device_events(body)
                  if name not in flush]
        by_name = {}
        for name, us in events:
            short = name.split("(")[0].removeprefix("void ").replace(" ", "")
            ms, k = by_name.get(short, (0.0, 0))
            by_name[short] = (ms + us / 1e3, k + 1)
        if all(k % iters == 0 for _, k in by_name.values()):
            per_call = {name: ms / iters for name, (ms, _) in by_name.items()}
            return sum(per_call.values()), per_call
        log(f"  (the profiler recorded {sorted(by_name.items())} for {iters} "
            f"calls; profiling again)")
        if sum(k for _, k in by_name.values()) > \
                sum(k for _, k in best.values()):
            best = by_name
    if best:
        per_call = {name: ms / k * max(1, round(k / iters))
                    for name, (ms, k) in best.items()}
        log(f"  (each kernel's time is the mean of its recorded runs: "
            f"{ {name: k for name, (_, k) in best.items()} } for {iters} "
            f"calls)")
        return sum(per_call.values()), per_call
    log("  (the profiler recorded no device event: the time is one call's "
        "between CUDA events, launch included)")
    return call_ms(torch, fn, iters), {}


def join_shapes(torch, q3_tables):
    """q3's two joins (INT64 keys) and TPC-DS q3's (the same keys as INT32,
    as q3_tpcds_inputs types them): (what, probe keys, build keys)."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import gather, join_cuda as jc
    sales, dates, items = (q3_tables[k] for k in ("sales", "dates", "items"))
    dates_f = gather.apply_boolean_mask(dates, dates["d_moy"].data == 11)
    items_f = gather.apply_boolean_mask(items,
                                        items["i_manufact"].data == 42)
    b1, b2 = [dates_f["d_date_sk"]], [items_f["i_item_sk"]]
    p1 = [sales["sold_date_sk"]]
    lmap, _ = jc.inner_join_hash(p1, b1)
    p2 = [gather.take(sales["item_sk"], lmap.data, _has_negative=False)]

    def int32(cols):
        return [Column(dt.INT32, c.length, c.data.to(torch.int32))
                for c in cols]
    return [("q3 join 1", p1, b1), ("q3 join 2", p2, b2),
            ("TPC-DS q3 join 1", int32(p1), int32(b1)),
            ("TPC-DS q3 join 2", int32(p2), int32(b2))]


def join_profile(torch, shapes, iters=30):
    """The device time of one whole `inner_join_hash` call at each shape,
    by kernel, and one call's time between CUDA events."""
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    out = {}
    for what, pc, bc in shapes:
        call = lambda: jc.inner_join_hash(pc, bc)     # noqa: E731
        total, by_name = device_by_name(torch, call, iters)
        cms = call_ms(torch, call, iters)
        out[what] = {"device_ms": total, "call_ms": cms, "by_name": by_name}
        log(f"  {what} inner_join_hash: device {total!r} ms "
            f"({', '.join(f'{k} {v!r}' for k, v in by_name.items())}), one "
            f"call {cms!r} ms")
    return out


def kernel_bounds(torch, jc, pcols, bcols, C, counts):
    """(bytes, operations) each kernel needs for this run's data: every
    input it reads once, every output written once. The count kernel reads
    the keys of valid probe rows only and writes every row's count and a
    4-byte list entry for each matched row, 8 bytes a segment (its sum and
    matched rows) and 16 a tile (its sum and offset); the emit reads the
    entries, segments and offsets and writes the pairs; both read the table
    and the build keys. Operations are the murmur3 hashes of the rows the
    count hashes; the chain walk is not counted. "emit_with_starts" is the
    bound of an emit that reads every row's count and the matched rows'
    keys and 8-byte starts, as the emit before tile offsets did."""
    n, nb = pcols[0].length, bcols[0].length
    key_width = sum(c.data.element_size() for c in pcols)
    hash_ops = sum(HASH_OPS[w] for w in jc._wide(pcols))
    valid = torch.ones(n, dtype=torch.bool, device=pcols[0].device)
    for c in pcols:
        if c.validity is not None:
            valid &= c.validity
    n_valid = int(valid.sum())
    n_matched = int((counts > 0).sum())
    total = int(counts.to(torch.int64).sum())
    validity_bytes = sum(n for c in pcols if c.validity is not None)
    build_in = sum(c.nbytes() for c in bcols)
    table = 8 * C                       # slot_row + slot_hash, int32 each
    per_tile = 8 * -(-n // (jc.TILE // jc.SEGMENTS)) + 16 * -(-n // jc.TILE)
    return {
        "build": (build_in + table, nb * hash_ops),
        "count": (validity_bytes + n_valid * key_width + build_in + table
                  + 4 * n + 4 * n_matched + per_tile, n_valid * hash_ops),
        "emit": (4 * n_matched + per_tile + build_in + table + 8 * total, 0),
        "emit_with_starts": (4 * n + n_matched * (key_width + 8) + build_in
                             + table + 8 * total, n_matched * hash_ops),
    }


def two_stream_joins(torch, jc, pc, bc, want, rounds=5):
    """Two joins at once, from two threads, each on its own stream: the
    calls share no device state, so every map equals `want`."""
    import threading
    bad = []

    def run():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for _ in range(rounds):
                lm, rm = jc.inner_join_hash(pc, bc)
                s.synchronize()
                if not (torch.equal(lm.data, want[0]) and
                        torch.equal(rm.data, want[1])):
                    bad.append("maps differ")

    torch.cuda.synchronize()            # the inputs, before other streams
    threads = [threading.Thread(target=run) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    require(not bad, f"joins on two streams at once: {bad[0] if bad else ''}")


def kernel_phase(torch, q3_tables):
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import join, join_cuda as jc
    from spark_rapids_tpu_torch.ops.registry import REGISTRY

    chk = Checks()
    shapes = join_shapes(torch, q3_tables)
    sales = q3_tables["sales"]
    (_, p1, b1), (_, _, b2) = shapes[0], shapes[1]
    t0 = time.perf_counter()
    for what, pc, bc in shapes + [
            ("10M item_sk vs 195 items", [sales["item_sk"]], b2)]:
        total = check_case(chk, jc, join, pc, bc, what)
        log(f"  {what}: probe {pc[0].length} x build {bc[0].length} -> "
            f"{total} pairs, kernels == plain")
    for what, pc, bc in matrix_cases(torch, dt, Column, jc.TILE):
        total = check_case(chk, jc, join, pc, bc, what)
        log(f"  {what}: {total} pairs, kernels == plain")
    fl, fr = join.inner_join(p1, b1)
    two_stream_joins(torch, jc, p1, b1, (fl.data, fr.data))
    log("  q3 join 1 on two streams at once, 2 x 5 calls: maps == plain")
    # empty sides launch nothing and give empty maps
    e = [Column.from_numpy(np.zeros(0, np.int64), dt.INT64, device="cuda")]
    before = dict(jc.LAUNCHES)
    el, er = jc.inner_join_hash(e, b1)
    require(el.length == er.length == 0 and jc.LAUNCHES == before,
            "an empty probe side launched a kernel or gave pairs")
    # 512 build rows are the small route's most; 513 take the large route
    big = [Column.from_numpy(np.arange(513, dtype=np.int64), dt.INT64,
                             device="cuda")]
    ch = REGISTRY.select("hash_join",
                         jc.make_signature(p1, big, "inner", "eager"),
                         backend="cuda")
    require(not ch.fallback and jc.is_large(jc._capacity(513))
            and not jc.is_large(jc._capacity(512)),
            f"a 513-row build was not taken on the large route: {ch}")
    log(f"kernels: {chk.n} exact comparisons on the card in "
        f"{time.perf_counter() - t0:.1f} s; 512-row build on the small "
        f"route, 513 on the large one")

    # timing at q3's shapes (summed into the kernels line) and TPC-DS q3's:
    # the kernels against the plain versions
    def zero():
        return {k: {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                    "ops": 0, "bytes_ms": 0.0, "ops_ms": 0.0,
                    "bound_ms": 0.0} for k in ("build", "count", "emit")}
    timing, timing_int32 = zero(), zero()
    old_emit_bound = 0.0
    for what, pc, bc in shapes:
        into = timing_int32 if what.startswith("TPC-DS") else timing
        C = jc._capacity(bc[0].length)
        tbl = jc.build_table_cuda(bc, C)
        probe = jc.probe_counts_cuda(pc, tbl, bc)
        total = int(probe.total)
        calls = {
            "build": (lambda: jc.build_table_cuda(bc, C),
                      lambda: jc.build_table_plain(bc, C)),
            "count": (lambda: jc.probe_counts_cuda(pc, tbl, bc),
                      lambda: jc.probe_counts_plain(pc, tbl, bc)),
            "emit": (lambda: jc.probe_emit_cuda(pc, tbl, bc, probe, total),
                     lambda: jc.probe_emit_plain(pc, tbl, bc, probe, total)),
        }
        bounds = kernel_bounds(torch, jc, pc, bc, C, probe.counts)
        for k, (kern, plain) in calls.items():
            ms = device_ms(torch, kern, KERNEL_NAMES[k], 50)
            cms = call_ms(torch, kern, 50)
            pms = time_cuda(torch, plain, 5)
            nbytes, ops = bounds[k]
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_INT_OPS_PER_S * 1e3
            t = into[k]
            t["ms"] += ms
            t["call_ms"] += cms
            t["plain_ms"] += pms
            t["bytes"] += nbytes
            t["ops"] += ops
            t["bytes_ms"] += bytes_ms
            t["ops_ms"] += ops_ms
            t["bound_ms"] += max(bytes_ms, ops_ms)
            log(f"  {what} {k}: device {ms!r} ms, one call {cms!r} ms, plain "
                f"{pms!r} ms; bound {max(bytes_ms, ops_ms)!r} ms ({nbytes} B "
                f"-> {bytes_ms!r} ms, {ops} ops -> {ops_ms!r} ms)")
        old = bounds["emit_with_starts"][0] / HBM_BYTES_PER_S * 1e3
        new = bounds["emit"][0] / HBM_BYTES_PER_S * 1e3
        if what.startswith("q3"):
            old_emit_bound += old
        log(f"  {what} emit bound: {new!r} ms from the count's lists, "
            f"{old!r} ms reading every count and the matched rows' keys "
            f"and 8-byte starts")
    timing["emit"]["bound_with_starts_ms"] = old_emit_bound
    timing["int32"] = timing_int32
    timing["join"] = join_profile(torch, shapes)
    return chk, timing


# ---- phase 4 -----------------------------------------------------------------

def numpy_q3(gen):
    """Independent q3 over the datagen arrays: filter, join by searchsorted
    on the unique dimension keys, group by np.unique + np.add.at, order by
    year ascending and revenue descending, ties by (d_year, i_brand)."""
    date_sk, d_year, d_moy, item_sk, i_brand, i_manufact, ss = gen
    dm, im = d_moy == 11, i_manufact == 42
    dk, dy = date_sk[dm], d_year[dm]
    ik, ib = item_sk[im], i_brand[im]

    def lookup(keys, probe):
        pos = np.searchsorted(keys, probe)
        pos_c = np.minimum(pos, len(keys) - 1)
        return pos_c, (pos < len(keys)) & (keys[pos_c] == probe)

    p1, ok1 = lookup(dk, ss["sold_date_sk"])
    p2, ok2 = lookup(ik, ss["item_sk"])
    keep = ok1 & ok2
    year, brand = dy[p1[keep]], ib[p2[keep]]
    price = ss["price_cents"][keep]
    groups, inv = np.unique(np.stack([year, brand], axis=1), axis=0,
                            return_inverse=True)
    rev = np.zeros(len(groups), np.int64)
    np.add.at(rev, inv.reshape(-1), price)
    order = np.lexsort((groups[:, 1], -rev, groups[:, 0]))
    return groups[order, 0], groups[order, 1], rev[order]


def trace_q3(torch, ex, plan, inputs, warm_ms):
    """One warm q3 run under torch.profiler: the device time of the kernels
    it ran (one stream, so they do not overlap) against the plan's wall
    time, and the kernels that took it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = ex.execute(plan, inputs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"trace: {len(kernels)} kernels, device busy {busy_ms:.3f} ms; "
        f"traced wall {res.wall_ms:.3f} ms ({100 * busy_ms / res.wall_ms:.1f}"
        f"% busy), untraced warm wall {warm_ms:.3f} ms "
        f"({100 * busy_ms / warm_ms:.1f}% busy)")
    for name, (ms, n) in top:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    return {"traced_wall_ms": res.wall_ms, "warm_wall_ms": warm_ms,
            "device_busy_ms": busy_ms, "n_kernels": len(kernels),
            "top": [(k, ms, n) for k, (ms, n) in top]}


def q3_phase(torch, inputs_cpu, gen, trace):
    from spark_rapids_tpu_torch import nds_q3
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.plan import PlanExecutor

    plan = nds_q3.q3_plan()
    # the authored plan, as PRs 1 and 2 ran it, so its times compare
    ex = PlanExecutor(optimize=False)                 # the card
    inputs = {k: t.to("cuda") for k, t in inputs_cpu.items()}
    torch.cuda.synchronize()
    jc.reset_counters()
    gc.reset_counters()
    res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    launches = dict(jc.LAUNCHES)
    log(f"q3 at {N_SALES} sales rows on {res.device}: "
        f"{res.wall_ms:.3f} ms, launches {launches}, groupby {gc.LAUNCHES}")
    log(res.profile_text())
    stamps = [m.kernel for m in res.metrics.values() if m.kind == "HashJoin"]
    require(stamps == ["cuda:hash_join"] * 2, f"join stamps {stamps}")
    require(launches == {"build": 2, "count": 2, "emit": 2},
            f"kernel launches on q3 {launches}")
    require(jc.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0},
            f"plain versions ran on the card path {jc.PLAIN_CALLS}")
    launches["groupby"] = require_groupby(gc, res, "q3")
    warm = [ex.execute(plan, inputs) for _ in range(3)]
    walls = [r.wall_ms for r in warm]
    log("q3 repeat wall ms: " + ", ".join(f"{w:.3f}" for w in walls))
    log("last repeat:")
    log(warm[-1].profile_text())
    traced = (trace_q3(torch, ex, plan, inputs, walls[-1]) if trace
              else None)

    got = res.table.to("cpu")
    require(got.names == ("d_year", "i_brand", "revenue"),
            f"q3 columns {got.names}")
    require(got.num_rows > 0 and all(c.validity is None or
                                     bool(c.validity.all())
                                     for c in got.columns),
            "q3 gave no rows or null values")
    ref = numpy_q3(gen)
    for name, want in zip(got.names, ref):
        have = got[name].data.numpy()
        if have.shape != want.shape or not np.array_equal(have, want):
            raise AssertionError(f"q3 {name} differs from the numpy q3")
    t0 = time.perf_counter()
    cpu = PlanExecutor(device="cpu", optimize=False).execute(plan, inputs_cpu)
    log(f"q3 on the CPU for comparison: {(time.perf_counter() - t0):.1f} s")
    for a, b in zip(got.columns, cpu.table.columns):
        if not torch.equal(a.data, b.data):
            raise AssertionError("q3 on the card differs from q3 on the CPU")
    log(f"q3: {got.num_rows} groups, equal to numpy q3 and to the CPU run")
    return res, launches, warm, traced


# ---- phase 4b ---------------------------------------------------------------

def tpcds_q3_phase(torch, chk, gen, trace):
    """TPC-DS q3 through `PlanExecutor()`: the main path of FusedSelect and
    TopK, with the hash join, counters zeroed just before and read just
    after."""
    from spark_rapids_tpu_torch import nds_q3
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.ops import select
    from spark_rapids_tpu_torch.ops import select_cuda as sc
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.plan import PlanExecutor
    from spark_rapids_tpu_torch.plan.nodes import FusedSelect, Scan

    plan = nds_q3.q3_tpcds_plan()
    inputs_cpu = nds_q3.q3_tpcds_inputs(N_SALES, seed=0, device="cpu")
    fact_bytes = inputs_cpu["sales"].nbytes()
    inputs = {k: t.to("cuda") for k, t in inputs_cpu.items()}
    ex = PlanExecutor()                               # the card, optimized
    torch.cuda.synchronize()
    for m in (jc, sc, tc, gc):
        m.reset_counters()
    res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    launches = {"hash_join": dict(jc.LAUNCHES),
                "fused_select": dict(sc.LAUNCHES), "topk": dict(tc.LAUNCHES),
                "groupby": dict(gc.LAUNCHES)}
    plain = {"hash_join": dict(jc.PLAIN_CALLS),
             "fused_select": dict(sc.PLAIN_CALLS),
             "topk": dict(tc.PLAIN_CALLS)}
    log(f"TPC-DS q3 at {N_SALES} sales rows ({fact_bytes} B of fact "
        f"columns) on {res.device}: {res.wall_ms:.3f} ms, launches "
        f"{launches}, plain runs {plain}")
    log(res.profile_text())
    log("optimizer: " + json.dumps(res.optimizer))
    stamps = sorted(m.kernel for m in res.metrics.values() if m.kernel)
    require(stamps == ["cuda:fused_select"] * 2 + ["cuda:groupby"]
            + ["cuda:hash_join"] * 2 + ["cuda:topk"],
            f"TPC-DS q3 stamps {stamps}")
    require_groupby(gc, res, "TPC-DS q3")
    # the TopK of the groups is one threshold launch and the gather
    require(launches["hash_join"]["build"] == 2
            and launches["fused_select"]["count"] == 2
            and launches["topk"] == {"threshold": 1, "select": 0,
                                     "merge": 0},
            f"kernel launches on TPC-DS q3 {launches}")
    require(all(v == 0 for d in plain.values() for v in d.values()),
            f"plain versions ran on the card path {plain}")

    # the FusedSelect kernel at the main path's shapes: each FusedSelect of
    # the executed plan on its own scan's table, against the plain version
    fused = [n for n in res.plan.nodes if isinstance(n, FusedSelect)]
    require(len(fused) == 2, f"executed plan has {len(fused)} FusedSelects")
    for node in fused:
        (scan,) = node.children
        require(isinstance(scan, Scan), f"{node.label} reads {scan.label}")
        t = inputs[scan.source]
        if scan.projection is not None:
            t = t.select(list(scan.projection))
        needed = select.needed_columns(t, node.exprs)
        got = sc.fused_select_cuda(t, node.predicate, needed)
        chk.tables("fused_select", got,
                   select.fused_select_plain(t, node.predicate, needed),
                   f"TPC-DS q3 {node.label} on {scan.source}")
        log(f"  {node.label} ({node.predicate!r} -> {needed}) on "
            f"{scan.source}, {t.num_rows} rows: {got.num_rows} kept, "
            f"kernel == plain")
    # every group before the LIMIT, against numpy q3: the first 100 rows
    # cover only the first year's groups
    ref = numpy_q3(gen)
    every = PlanExecutor().execute(nds_q3.q3_tpcds_plan(limit=None),
                                   inputs).table.to("cpu")
    for name, want in zip(every.names, ref):
        have = every[name].data.numpy()
        if have.shape != want.shape or not np.array_equal(have, want):
            raise AssertionError(f"TPC-DS q3 without LIMIT: {name} differs "
                                 f"from numpy q3")
    log(f"TPC-DS q3 without LIMIT: all {every.num_rows} groups equal numpy "
        f"q3")

    warm = [ex.execute(plan, inputs) for _ in range(3)]
    walls = [r.wall_ms for r in warm]
    log("TPC-DS q3 repeat wall ms: " + ", ".join(f"{w:.3f}" for w in walls))
    log("last repeat:")
    log(warm[-1].profile_text())
    traced = (trace_q3(torch, ex, plan, inputs, walls[-1]) if trace
              else None)

    got = res.table.to("cpu")
    require(got.names == ("d_year", "i_brand", "revenue")
            and got.num_rows == TPCDS_LIMIT,
            f"TPC-DS q3 gave {got.names} x {got.num_rows}")
    for name, want in zip(got.names, ref):
        have = got[name].data.numpy()
        if not np.array_equal(have, want[:TPCDS_LIMIT]):
            raise AssertionError(f"TPC-DS q3 {name} differs from numpy q3")
    t0 = time.perf_counter()
    cpu = PlanExecutor(device="cpu").execute(plan, inputs_cpu)
    log(f"TPC-DS q3 on the CPU for comparison: "
        f"{(time.perf_counter() - t0):.1f} s")
    for a, b in zip(got.columns, cpu.table.columns):
        if a.dtype != b.dtype or not torch.equal(a.data, b.data):
            raise AssertionError("TPC-DS q3 on the card differs from the "
                                 "CPU run")
    log(f"TPC-DS q3: {got.num_rows} rows, equal to numpy q3's first "
        f"{TPCDS_LIMIT} and to the CPU run")
    return res, launches, warm, traced


# ---- phase 4c ---------------------------------------------------------------

FS_SIZES = (0, 1, 1000, 1_000_003)
# the count kernel takes 4 rows a thread and 1,024 a step: sizes off those
# multiples, also with every column a view one element into its buffer
FS_EDGE_SIZES = (3, 1023, 1025, 2047, 2049, 4097, 1_000_001)


def fs_matrix(dt, Column, Table, col, lit, sizes=FS_SIZES, offset=0):
    """(what, table, predicate, needed) on the card: every port dtype with
    and without nulls, nineteen predicates, at `sizes` rows; with `offset`,
    every column a view that many elements into its buffers."""
    rng = np.random.default_rng(4)
    specs = [("bool", None, dt.BOOL), ("int8", np.int8, dt.INT8),
             ("int16", np.int16, dt.INT16), ("int32", np.int32, dt.INT32),
             ("date32", np.int32, dt.DATE32), ("int64", np.int64, dt.INT64),
             ("timestamp_us", np.int64, dt.TIMESTAMP_US),
             ("decimal32", np.int32, dt.decimal(9, 2)),
             ("decimal64", np.int64, dt.decimal(18, 2)),
             ("float32", np.float32, dt.FLOAT32),
             ("float64", np.float64, dt.FLOAT64)]
    preds = [("or", (col("sel") < 25) | (col("sel") > 48)),
             ("eq", col("sel") == 7),
             ("arith", (col("sel") + 3) * 2 > 40),
             ("not_and_or", ~(col("sel") >= 10) & (col("bool") |
                                                   (col("sel") != 3))),
             ("sub_lit", col("sel") - 60 < lit(-30)),
             ("int8 wrap", (col("int8") + 100) > 50),
             ("int32 wrap", col("int32") * 3 < col("int32")),
             ("64-bit", (col("int64") > 0) & (col("decimal64") < 0)
              | (col("timestamp_us") == col("int64"))),
             ("float32 arith", (col("float32") + col("int32")) * 0.1
              > col("float32")),
             ("int64 x float32", col("float32") * col("int64")
              < lit(-1.5e18)),
             ("int to float64", (col("int32") * 1.0) > lit(16777216.5)),
             ("bool to float64", (col("bool") + 0.25) * col("int8")
              >= col("float64")),
             ("float64 to float32", (col("int16") + 0.1) * col("float32")
              != col("float32")),
             ("subnormal", col("float32") * 1e-39 != lit(0.0)),
             ("nan", (col("float32") == col("float32")) | (col("sel") < 3)),
             ("float64 neg", -col("float64") * col("float32")
              <= col("decimal32")),
             ("float64 sub", col("float64") - col("float32") > lit(-0.25)),
             ("literal only", lit(2) + lit(3) > lit(4)),
             ("right-nested", col("sel") < (col("int8") + (col("int16") - (
                 col("int32") * (col("sel") + (col("int64") - 1))))))]
    def view(c):
        if not offset:
            return c
        v = None if c.validity is None else c.validity[offset:]
        return Column(c.dtype, c.length - offset, c.data[offset:], v)

    for n in sizes:
        n_buf = n + offset
        for null_p in (0.0, 0.15):
            cols, names = [], []
            for name, npt, dtype in specs:
                if npt is None:
                    a = rng.integers(0, 2, n_buf).astype(bool)
                elif np.issubdtype(npt, np.floating):
                    a = rng.standard_normal(n_buf).astype(npt)
                    a[rng.random(n_buf) < 0.05] = np.nan
                    a[:min(n_buf, 2)] = [0.0, -0.0][:min(n_buf, 2)]
                else:
                    ii = np.iinfo(npt)
                    a = rng.integers(ii.min, ii.max, n_buf, dtype=npt,
                                     endpoint=True)
                v = (rng.random(n_buf) > null_p) if null_p else None
                cols.append(view(Column.from_numpy(a, dtype, v,
                                                   device="cuda")))
                names.append(name)
            cols.append(view(Column.from_numpy(
                rng.integers(0, 50, n_buf).astype(np.int32), dt.INT32,
                device="cuda")))
            names.append("sel")
            t = Table(cols, names)
            for what, pred in preds:
                yield (f"{what} n={n} offset={offset} nulls={null_p}", t,
                       pred, names[:-1])


def fused_select_phase(torch, chk):
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import select
    from spark_rapids_tpu_torch.ops import select_cuda as sc
    from spark_rapids_tpu_torch.plan import col, lit

    t0 = time.perf_counter()
    n_cases = 0
    for sizes, offset in ((FS_SIZES, 0), (FS_EDGE_SIZES, 0),
                          (FS_EDGE_SIZES, 1)):
        for what, t, pred, needed in fs_matrix(dt, Column, Table, col, lit,
                                               sizes, offset):
            chk.tables("fused_select", sc.fused_select_cuda(t, pred, needed),
                       select.fused_select_plain(t, pred, needed), what)
            n_cases += 1
    torch.cuda.synchronize()
    log(f"fused_select: {n_cases} tables x predicates, kernel == plain, "
        f"also at {FS_EDGE_SIZES} rows and one element into every buffer "
        f"({time.perf_counter() - t0:.1f} s)")

    # kernel_bench.py's table (its lines 43-51), with INT32 and with INT64
    # predicate columns
    rng = np.random.default_rng(7)
    a_np = rng.integers(0, 100, N_ROWS).astype(np.int32)
    b_np = rng.integers(-5, 5, N_ROWS).astype(np.int32)
    v_np = rng.integers(-2**40, 2**40, N_ROWS).astype(np.int64)
    v_valid = rng.random(N_ROWS) > 0.1
    pred = (col("a") < 10) & (col("b") > 0)
    needed = ["a", "v"]
    # the count kernel interprets the predicate: its time per program node
    by_nodes = {3: col("a") < 10, 7: pred,
                15: pred | ((col("a") + col("b")) * 3 == 7)}
    timing = {}
    for form, kind, npt in (("int32", dt.INT32, np.int32),
                            ("int64", dt.INT64, np.int64)):
        t = Table([Column.from_numpy(a_np.astype(npt), kind, device="cuda"),
                   Column.from_numpy(b_np.astype(npt), kind, device="cuda"),
                   Column.from_numpy(v_np, dt.INT64, v_valid,
                                     device="cuda")], ["a", "b", "v"])
        got = sc.fused_select_cuda(t, pred, needed)
        chk.tables("fused_select", got,
                   select.fused_select_plain(t, pred, needed),
                   f"10M rows {form}")
        sel = got.num_rows
        w = np.dtype(npt).itemsize
        a, b, v, valid = t["a"].data, t["b"].data, t["v"].data, \
            t["v"].validity

        def library():
            m = (a < 10) & (b > 0)
            return a[m], v[m], valid[m]
        kern = lambda: sc.fused_select_cuda(t, pred, needed)   # noqa: E731
        ms = device_ms(torch, kern, KERNEL_NAMES["fused_select"], 50,
                       per_call=2)
        count_ms, compact_ms = (device_ms(torch, kern, name, 50)
                                for name in (FS_COUNT, "fs_compact_kernel"))
        node_ms = {nodes: device_ms(
            torch, lambda: sc.fused_select_cuda(t, p, needed),
            FS_COUNT, 20) for nodes, p in by_nodes.items()}
        cms = call_ms(torch, kern, 50)
        pms = time_cuda(torch, lambda: select.fused_select_plain(
            t, pred, needed), 5)
        lib = call_ms(torch, library, 50)
        # the predicate columns read once, the selected rows' v and its
        # validity read, the selected a, v and validity written
        nbytes = N_ROWS * 2 * w + sel * (8 + 1) + sel * (w + 8 + 1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        timing[form] = {"ms": ms, "call_ms": cms, "plain_ms": pms,
                        "library_ms": lib, "bytes": nbytes, "ops": 0,
                        "bytes_ms": bytes_ms, "ops_ms": 0.0,
                        "bound_ms": bytes_ms, "selected": sel,
                        "count_ms": count_ms, "compact_ms": compact_ms,
                        "count_ms_by_nodes": node_ms}
        log(f"  {form} predicate columns, {sel} of {N_ROWS} rows: device "
            f"{ms!r} ms (count {count_ms!r}, compact {compact_ms!r}; count "
            f"by program nodes {node_ms}), one "
            f"call {cms!r} ms, plain {pms!r} ms, torch mask "
            f"+ t[mask] {lib!r} ms; bound {bytes_ms!r} ms ({nbytes} B)")
        if form == "int32":
            timing[form]["compact_by_kept"] = compact_experiment(
                torch, sc, t, col)
    return timing


def compact_experiment(torch, sc, t, col):
    """fs_compact's device time alone by the share of rows kept and the
    columns it writes, on kernel_bench.py's table: what grows with what
    says which of its costs bounds it (PERF.md)."""
    out = {}
    for share, p in (("0.1%", (col("a") < 1) & (col("b") > 3)),
                     ("4%", (col("a") < 10) & (col("b") > 0)),
                     ("50%", col("a") < 50), ("100%", col("a") >= 0)):
        for cols in (["a"], ["a", "v"]):
            kept = sc.fused_select_cuda(t, p, cols).num_rows
            ms = device_ms(torch, lambda: sc.fused_select_cuda(t, p, cols),
                           "fs_compact_kernel", 20)
            out[f"{share} {'+'.join(cols)}"] = {"kept": kept, "ms": ms}
    log("  compaction alone: " + ", ".join(
        f"{k} ({v['kept']} rows) {v['ms']!r} ms" for k, v in out.items()))
    return out


# ---- phase 4d ---------------------------------------------------------------

TK_CASES = [(np.int64, True), (np.int64, False), (np.int32, True),
            (np.int16, False), (np.float32, True), (np.float64, False),
            (np.bool_, True)]


def topk_phase(torch, chk):
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import topk
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.ops.gather import take_table

    kinds = {np.int64: dt.INT64, np.int32: dt.INT32, np.int16: dt.INT16,
             np.float32: dt.FLOAT32, np.float64: dt.FLOAT64,
             np.bool_: dt.BOOL}
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    n_cases = 0
    n = 100_003
    for npt, asc in TK_CASES:
        for null_p in (0.0, 0.2):
            if npt is np.bool_:
                a = rng.integers(0, 2, n).astype(bool)
            elif np.issubdtype(npt, np.floating):
                a = rng.standard_normal(n).astype(npt)
                a[rng.random(n) < 0.05] = np.nan
                a[:2] = [0.0, -0.0]
            else:
                a = rng.integers(np.iinfo(npt).min, np.iinfo(npt).max, n,
                                 dtype=npt, endpoint=True)
            v = (rng.random(n) > null_p) if null_p else None
            t = Table([Column.from_numpy(a, kinds[npt], v, device="cuda"),
                       Column.from_numpy(rng.integers(0, 9, n)
                                         .astype(np.int32), dt.INT32,
                                         device="cuda")], ["k", "pay"])
            what = f"{np.dtype(npt).name} asc={asc} nulls={null_p}"
            for k in (1, 17, 100, 128, 129, 513, 1000, 4099):
                chk.tables("topk", tc.topk_table_cuda(t, ["k"], [asc], k),
                           topk.topk_plain(t, ["k"], [asc], k),
                           f"{what} k={k}")
                n_cases += 1
            keys, ascs = ["pay", "k"], [not asc, asc]
            chk.tables("topk", tc.topk_table_cuda(t, keys, ascs, 100),
                       topk.topk_plain(t, keys, ascs, 100),
                       f"{what} multi-key")
            small = topk.topk_plain(t, ["pay"], [True], 40)
            chk.tables("topk", tc.topk_table_cuda(small, ["k"], [asc], 100),
                       topk.topk_plain(small, ["k"], [asc], 100),
                       f"{what} k > rows")
            n_cases += 2
    empty = Table([Column.from_numpy(np.zeros(0, np.int64), dt.INT64,
                                     device="cuda")], ["k"])
    before = dict(tc.LAUNCHES)
    require(tc.topk_table_cuda(empty, ["k"], [True], 5).num_rows == 0
            and tc.LAUNCHES == before,
            "an empty table launched the topk kernel or gave rows")
    torch.cuda.synchronize()
    log(f"topk: {n_cases} cases, kernel == plain, 0 rows launch nothing "
        f"({time.perf_counter() - t0:.1f} s)")

    # kernel_bench.py's table (its lines 77-82): keys [k DESC, v ASC]
    rng = np.random.default_rng(8)
    t = Table([Column.from_numpy(rng.integers(-10**6, 10**6, N_ROWS)
                                 .astype(np.int64), dt.INT64,
                                 rng.random(N_ROWS) > 0.05, device="cuda"),
               Column.from_numpy(rng.standard_normal(N_ROWS)
                                 .astype(np.float32), dt.FLOAT32,
                                 device="cuda")], ["k", "v"])
    keys, asc = ["k", "v"], [False, True]
    n_words = topk.n_words(topk.make_signature(t, keys, asc, 1, "eager"))
    sms, smem_optin = tc.device_limits(torch.device("cuda"))
    edge = 1
    while topk.threshold_route(edge + 1, n_words, smem_optin):
        edge += 1
    log(f"  route rule: at {n_words} words k <= {edge} takes the threshold "
        f"kernel ({smem_optin} B of opt-in shared memory a block, {sms} "
        f"SMs)")
    for kk, ww in ((1, 2), (edge, n_words), (edge + 1, n_words), (100, 96)):
        require(tc._lib().tk_threshold_smem(kk, ww)
                == topk.threshold_smem(kk, ww),
                f"the kernel's shared-memory layout for k={kk}, W={ww} "
                f"differs from topk.threshold_smem")

    def tile_route(tbl, ks, asc_, k):
        """The tile-sort route on the same call: the sort of every tile
        (the words built from the keys) and the merges of its runs."""
        dev = tbl.device
        desc = tc._descriptor(tbl, ks, asc_)
        idx = tc._tile_sort(desc, tbl.num_rows, k, dev,
                            torch.cuda.current_stream(dev).cuda_stream)
        return take_table(tbl, idx[-1, :k], _has_negative=False)

    def counted(fn):
        before = dict(tc.LAUNCHES)
        fn()
        torch.cuda.synchronize()
        return {n: tc.LAUNCHES[n] - before[n] for n in before}

    def case(what, tbl, ks, asc_, k, route, full=False):
        """The kernel against topk_plain on one 10M-row call, the route
        the counters show, its times and its bound; with `full` the plain
        version's and torch.topk's times too. The tile route's device time
        on the same call is timed beside it."""
        want = topk.topk_plain(tbl, ks, asc_, k)
        kern = lambda: tc.topk_table_cuda(tbl, ks, asc_, k)   # noqa: E731
        chk.tables("topk", kern(), want, f"10M rows {what} k={k}")
        per_call = counted(kern)
        got_route = "threshold" if per_call["threshold"] else "tile"
        require(got_route == route and sum(per_call.values()) >= 1,
                f"{what} k={k}: launches {per_call}, expected the {route} "
                f"route")
        ms = device_ms(torch, kern, KERNEL_NAMES["topk"], 20,
                       per_call=sum(per_call.values()))
        cms = call_ms(torch, kern, 20)
        tile = lambda: tile_route(tbl, ks, asc_, k)           # noqa: E731
        chk.tables("topk", tile(), want, f"10M rows {what} k={k} tile")
        tile_ms = device_ms(torch, tile, KERNEL_NAMES["topk"], 5,
                            per_call=sum(counted(tile).values()))
        # the function: the key columns and validity read once, k rows of
        # every column written
        nbytes = (sum(tbl[c].nbytes() for c in ks) + k * sum(
            c.data.element_size() + (c.validity is not None)
            for c in tbl.columns))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out = {"ms": ms, "call_ms": cms, "bytes": nbytes, "ops": 0,
               "bytes_ms": bytes_ms, "ops_ms": 0.0, "bound_ms": bytes_ms,
               "route": route, "launches_per_call": per_call,
               "tile_route_ms": tile_ms}
        extra = ""
        if full:
            out["plain_ms"] = time_cuda(
                torch, lambda: topk.topk_plain(tbl, ks, asc_, k), 3)
            kd = tbl[ks[0]].data
            out["library_ms"] = call_ms(torch, lambda: torch.topk(
                kd, k, largest=not asc_[0], sorted=True), 20)
            extra = (f", plain {out['plain_ms']!r} ms, torch.topk of "
                     f"{ks[0]}'s values (no tie order, no nulls) "
                     f"{out['library_ms']!r} ms")
        log(f"  {what} k={k}: {route} route, device {ms!r} ms over "
            f"launches {per_call}, one call {cms!r} ms{extra}; the tile "
            f"route {tile_ms!r} ms; bound {bytes_ms!r} ms ({nbytes} B)")
        return out

    timing = {}
    for k in TOPK_LIMITS + (TOPK_LARGE_LIMIT,):
        timing[k] = case("random", t, keys, asc, k, "threshold", full=True)
    cases = timing["cases"] = {}
    cases["edge"] = case("random", t, keys, asc, edge, "threshold")
    cases["past edge"] = case("random", t, keys, asc, edge + 1, "tile")
    # the worst order: every row is below every block's threshold
    desc_rows = Table([Column.from_numpy(np.arange(N_ROWS, 0, -1,
                                                   dtype=np.int64),
                                         dt.INT64, device="cuda"), t["v"]],
                      ["k", "v"])
    cases["descending"] = case("descending", desc_rows, ["k"], [True],
                               TOPK_LIMITS[1], "threshold")
    equal = Table([Column.from_numpy(np.zeros(N_ROWS, np.int64), dt.INT64,
                                     device="cuda"), t["v"]], ["k", "v"])
    cases["all equal"] = case("all-equal", equal, ["k"], [True],
                              TOPK_LIMITS[1], "threshold")
    nulls = Table([Column.from_numpy(np.zeros(N_ROWS, np.int64), dt.INT64,
                                     np.zeros(N_ROWS, bool),
                                     device="cuda"), t["v"]], ["k", "v"])
    cases["all null"] = case("all-null", nulls, ["k"], [False],
                             TOPK_LIMITS[1], "threshold")
    return timing


# ---- phase 5 -----------------------------------------------------------------

_M32 = np.uint32(0xFFFFFFFF)
_XX = [np.uint64(c) for c in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                              0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                              0x27D4EB2F165667C5)]


def np_murmur3(cols, seed):
    """Spark murmur3_32 of rows of int64 columns, in numpy uint32: two
    rounds per column (low word, high word), then fmix(h ^ 8)."""
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    h = np.full(cols[0].shape[0], seed, np.uint32)
    for c in cols:
        u = c.view(np.uint64)
        for w in ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                  (u >> np.uint64(32)).astype(np.uint32)):
            k = rotl(w * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)
            h = rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ np.uint32(8)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h.view(np.int32)


def np_xxhash64(cols, seed):
    """Spark xxhash64 of rows of int64 columns, in numpy uint64: per column
    the 8-byte xxhash64 of the value, seeded with the running hash."""
    p1, p2, p3, p4, p5 = _XX

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))
    h = np.full(cols[0].shape[0], seed, np.uint64)
    for c in cols:
        k = rotl(c.view(np.uint64) * p2, 31) * p1
        h = h + p5 + np.uint64(8)
        h = rotl(h ^ k, 27) * p1 + p4
        h ^= h >> np.uint64(33)
        h *= p2
        h ^= h >> np.uint64(29)
        h *= p3
        h ^= h >> np.uint64(32)
    return h.view(np.int64)


def hash_matrix(torch, dt, Column):
    """(what, columns) on the card: every kind the kernel takes, with and
    without nulls, NaN/+-0.0/+-inf, lengths 0, 1 and off the block."""
    rng = np.random.default_rng(2)
    specs = [("bool", None, dt.BOOL), ("int8", np.int8, dt.INT8),
             ("int16", np.int16, dt.INT16), ("int32", np.int32, dt.INT32),
             ("date32", np.int32, dt.DATE32), ("int64", np.int64, dt.INT64),
             ("timestamp_us", np.int64, dt.TIMESTAMP_US),
             ("decimal32", np.int32, dt.decimal(9, 2)),
             ("decimal64", np.int64, dt.decimal(18, 2)),
             ("float32", np.float32, dt.FLOAT32),
             ("float64", np.float64, dt.FLOAT64)]
    for n in (0, 1, 1000, 1_000_003):
        for null_p in (0.0, 0.2):
            cols = []
            for name, npt, dtype in specs:
                if npt is None:
                    a = rng.integers(0, 2, n).astype(bool)
                elif np.issubdtype(npt, np.floating):
                    a = rng.standard_normal(n).astype(npt)
                    a[:min(n, 6)] = np.array(
                        [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf],
                        npt)[:min(n, 6)]
                else:
                    ii = np.iinfo(npt)
                    a = rng.integers(ii.min, ii.max, n, dtype=npt,
                                     endpoint=True)
                v = (rng.random(n) > null_p) if null_p else None
                cols.append((name, Column.from_numpy(a, dtype, v,
                                                     device="cuda")))
            for name, c in cols:
                yield f"{name} n={n} nulls={null_p}", [c]
            ints = [c for name, c in cols if not name.startswith("float")]
            yield f"all integer kinds n={n} nulls={null_p}", ints
            yield (f"44 columns (two launches) n={n} nulls={null_p}",
                   [c for _, c in cols] * 4)


def row_hash_bounds(form, n, ncols):
    """(bytes, operations) of one row-hash call over n rows of ncols INT64
    columns: every value read once, every hash written once."""
    nbytes = n * (8 * ncols + RH_OUT_BYTES[form])
    return nbytes, n * (ncols * RH_COL_OPS[form] + RH_ROW_OPS[form])


def row_hash_phase(torch, chk, smi):
    from spark_rapids_tpu_torch import api, ops
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import hash as plain
    from spark_rapids_tpu_torch.ops import hash_cuda as hc

    # bench.py's workload (bench.py:86-89)
    rng = np.random.default_rng(0)
    keys_np = rng.integers(-(2**62), 2**62, size=N_ROWS, dtype=np.int64)
    vals_np = rng.integers(-(2**31), 2**31, size=N_ROWS, dtype=np.int64)
    t = Table([Column.from_numpy(keys_np, dt.INT64, device="cuda"),
               Column.from_numpy(vals_np, dt.INT64, device="cuda")],
              ["keys", "vals"])
    torch.cuda.synchronize()

    # the main path, counters zeroed just before and read just after
    hc.reset_counters()
    h32 = ops.murmur_hash3_32(t, seed=42)
    h64 = ops.xxhash64(t)
    fm, fx = ops.fused_row_hash(t, mm_seed=42)
    am = api.Hash.murmurHash32(t.columns, 42)
    ax = api.Hash.xxhash64(t.columns)
    torch.cuda.synchronize()
    launches = dict(hc.LAUNCHES)
    plain_calls = dict(hc.PLAIN_CALLS)
    log(f"row hash at {N_ROWS} rows x 2 INT64: launches {launches}, "
        f"plain runs {plain_calls}")
    require(launches == {"murmur": 2, "xxhash": 2, "fused": 1},
            f"row-hash launches on the path {launches}")
    require(plain_calls == {"murmur": 0, "xxhash": 0, "fused": 0},
            f"plain row hashes ran on the card path {plain_calls}")

    t0 = time.perf_counter()
    want_mm = plain.murmur_hash3_32(t, 42).data
    want_xx = plain.xxhash64(t).data
    for what, got, want in (("murmur", h32.data, want_mm),
                            ("xxhash", h64.data, want_xx),
                            ("fused murmur", fm.data, want_mm),
                            ("fused xxhash", fx.data, want_xx),
                            ("api murmur", am.data, want_mm),
                            ("api xxhash", ax.data, want_xx)):
        chk.equal("row_hash", got, want, f"10M {what}")
    np_mm = np_murmur3([keys_np, vals_np], 42)
    np_xx = np_xxhash64([keys_np, vals_np], 42)
    require(np.array_equal(h32.data.cpu().numpy(), np_mm),
            "murmur3 at 10M rows differs from the numpy evaluation")
    require(np.array_equal(h64.data.cpu().numpy(), np_xx),
            "xxhash64 at 10M rows differs from the numpy evaluation")
    log(f"  10M rows: kernels == plain versions == numpy evaluation "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_cases = 0
    for what, cols in hash_matrix(torch, dt, Column):
        for seed in (0, 42):
            chk.equal("row_hash", hc.murmur_hash3_32_cuda(cols, seed).data,
                      plain.murmur_hash3_32(cols, seed).data,
                      f"{what} murmur seed {seed}")
            chk.equal("row_hash", hc.xxhash64_cuda(cols, seed).data,
                      plain.xxhash64(cols, seed).data,
                      f"{what} xxhash seed {seed}")
        if not any(c.dtype.is_floating for c in cols):
            m, x = hc.fused_row_hash_cuda(cols, mm_seed=42)
            chk.equal("row_hash", m.data, plain.murmur_hash3_32(cols, 42).data,
                      f"{what} fused murmur")
            chk.equal("row_hash", x.data, plain.xxhash64(cols).data,
                      f"{what} fused xxhash")
        n_cases += 1
    torch.cuda.synchronize()
    log(f"  dtype matrix: {n_cases} tables, kernel == plain "
        f"({time.perf_counter() - t0:.1f} s)")

    # timing at bench.py's shape
    calls = {"murmur": (lambda: hc.murmur_hash3_32_cuda(t, 42),
                        lambda: plain.murmur_hash3_32(t, 42)),
             "xxhash": (lambda: hc.xxhash64_cuda(t),
                        lambda: plain.xxhash64(t)),
             "fused": (lambda: hc.fused_row_hash_cuda(t, 42),
                       lambda: (plain.murmur_hash3_32(t, 42),
                                plain.xxhash64(t)))}
    timing = {}
    for form, (kern, pl) in calls.items():
        ms = device_ms(torch, kern, KERNEL_NAMES[form], 50)
        cms = call_ms(torch, kern, 50)
        pms = time_cuda(torch, pl, 5)
        nbytes, ops_ = row_hash_bounds(form, N_ROWS, 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_ / PEAK_INT_OPS_PER_S * 1e3
        timing[form] = {"ms": ms, "call_ms": cms, "plain_ms": pms,
                        "bytes": nbytes, "ops": ops_, "bytes_ms": bytes_ms,
                        "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms)}
        log(f"  {form}: device {ms!r} ms, one call {cms!r} ms, plain "
            f"{pms!r} ms; bound {max(bytes_ms, ops_ms)!r} ms ({nbytes} B "
            f"-> {bytes_ms!r} ms, {ops_} ops -> {ops_ms!r} ms)")

    # the headline, named as bench.py names it: a step of both hashes
    two = time_cuda(torch, lambda: (ops.murmur_hash3_32(t, seed=42),
                                    ops.xxhash64(t)), 20)
    one = time_cuda(torch, lambda: ops.fused_row_hash(t, mm_seed=42), 20)
    head = {"metric": "spark_row_hash_throughput",
            "value": N_ROWS / two / 1e3,
            "unit": "Mrows/s (murmur3_32+xxhash64, 2xint64, 10M rows)",
            "fused_value": N_ROWS / one / 1e3, "step_ms": two,
            "fused_step_ms": one, "backend": "cuda",
            "device": torch.cuda.get_device_name(0), "card": smi,
            "kernels": "cuda:row_hash"}
    log(json.dumps(head))
    return launches, timing, head


# ---- phase 6 -----------------------------------------------------------------

def partition_phase(torch, chk):
    from spark_rapids_tpu_torch import ops, parallel
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import hash_cuda as hc
    from spark_rapids_tpu_torch.parallel import partition_cuda as pc

    # benchmarks/bench_partition.py's ids, and bench.py's keys for the chain
    rng = np.random.default_rng(0)
    ids = {P: rng.integers(0, P, N_ROWS).astype(np.int32)
           for P in PARTITIONS}
    keys_np = np.random.default_rng(0).integers(-(2**62), 2**62,
                                                size=N_ROWS, dtype=np.int64)
    parts = {P: torch.from_numpy(a).cuda() for P, a in ids.items()}
    keys = Table([Column.from_numpy(keys_np, dt.INT64, device="cuda")])
    torch.cuda.synchronize()

    # the main path, counters zeroed just before and read just after
    hc.reset_counters()
    pc.reset_counters()
    counts = {P: parallel.partition_histogram(parts[P], P) for P in parts}
    chain = {}
    for P in PARTITIONS:
        cap = (N_ROWS // P) * 2
        h = ops.murmur_hash3_32(keys, seed=42)
        part = parallel.partition_ids(h.data, P)
        chain[P] = (part, parallel.partition_histogram(part, P),
                    parallel.build_partition_map(part, P, cap),
                    parallel.build_partition_map_scan(part, P, cap))
    torch.cuda.synchronize()
    launches = {"histogram": pc.LAUNCHES["histogram"],
                "murmur": hc.LAUNCHES["murmur"]}
    log(f"partition at {N_ROWS} ids, P = {PARTITIONS}: launches {launches}, "
        f"plain runs {pc.PLAIN_CALLS}")
    require(launches == {"histogram": 2 * len(PARTITIONS),
                         "murmur": len(PARTITIONS)},
            f"partition launches on the path {launches}")
    require(pc.PLAIN_CALLS == {"histogram": 0},
            f"the histogram ran plain on the card path {pc.PLAIN_CALLS}")

    t0 = time.perf_counter()
    for P, a in ids.items():
        want = np.bincount(a, minlength=P).astype(np.int32)
        chk.equal("histogram", counts[P], pc.histogram_plain(parts[P], P),
                  f"P={P} counts vs plain")
        require(np.array_equal(counts[P].cpu().numpy(), want),
                f"P={P} counts differ from np.bincount")
    np_h = np_murmur3([keys_np], 42).astype(np.int64)
    for P, (part, cnt, smap, scan) in chain.items():
        np_part = np.where(np.fmod(np_h, P) < 0, np.fmod(np_h, P) + P,
                           np.fmod(np_h, P))
        require(np.array_equal(part.cpu().numpy(), np_part),
                f"P={P} partition ids differ from numpy pmod of murmur3")
        want = np.bincount(np_part, minlength=P).astype(np.int32)
        require(np.array_equal(cnt.cpu().numpy(), want),
                f"P={P} chain counts differ from np.bincount")
        chk.equal("histogram", cnt, smap[2], f"P={P} histogram vs sort map")
        chk.equal("histogram", cnt, scan[2], f"P={P} histogram vs scan map")
        require(torch.equal(smap[1], scan[1]) and
                torch.equal(torch.where(smap[1], smap[0], 0), scan[0]),
                f"P={P} the sort map and the scan map differ")
    small = np.random.default_rng(3)
    n_cases = 0
    # 200 is Spark's default shuffle partition count; from 300 on a block
    # keeps fewer sub-histograms, and at 13000 none (global atomics)
    for P in (1, 8, 64, 128, 200, 300, 2000, 13000):
        for n in (0, 1, 1000, 1_000_003):
            a = small.integers(-2, P + 2, n).astype(np.int32)
            tp = torch.from_numpy(a).cuda()
            got = pc.histogram_cuda(tp, P)
            chk.equal("histogram", got, pc.histogram_plain(tp, P),
                      f"P={P} n={n} with ids outside [0, P)")
            inside = a[(a >= 0) & (a < P)]
            require(np.array_equal(got.cpu().numpy(),
                                   np.bincount(inside, minlength=P)),
                    f"P={P} n={n} differs from np.bincount")
            n_cases += 1
    torch.cuda.synchronize()
    log(f"  counts == plain == np.bincount, maps identical, {n_cases} small "
        f"cases ({time.perf_counter() - t0:.1f} s)")

    timing = {}
    for P, part in parts.items():
        kern = lambda: pc.histogram_cuda(part, P)            # noqa: E731
        ms = device_ms(torch, kern, KERNEL_NAMES["histogram"], 50)
        cms = call_ms(torch, kern, 50)
        pms = time_cuda(torch, lambda: pc.histogram_plain(part, P), 5)
        lib = call_ms(torch, lambda: torch.bincount(part, minlength=P), 50)
        nbytes, ops_ = 4 * N_ROWS + 4 * P, HIST_OPS * N_ROWS
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_ / PEAK_INT_OPS_PER_S * 1e3
        timing[P] = {"ms": ms, "call_ms": cms, "plain_ms": pms,
                     "library_ms": lib, "bytes": nbytes, "ops": ops_,
                     "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                     "bound_ms": max(bytes_ms, ops_ms)}
        log(f"  P={P}: device {ms!r} ms, one call {cms!r} ms, plain {pms!r} "
            f"ms, torch.bincount one call {lib!r} ms; bound "
            f"{max(bytes_ms, ops_ms)!r} ms ({nbytes} B -> {bytes_ms!r} ms)")
    return launches, timing


# ---- phase 3b: the hash join's large route ------------------------------------

def np_join(pkeys, pvalid, bkeys, bvalid):
    """Independent inner join of numpy key tuples: for each valid probe row
    in order, the valid build rows with equal keys, ascending (the hash
    join's chain order for equal keys)."""
    both = np.concatenate([np.stack(pkeys, 1), np.stack(bkeys, 1)])
    _, code = np.unique(both, axis=0, return_inverse=True)
    code = code.reshape(-1)
    pc, bc = code[:len(pkeys[0])], code[len(pkeys[0]):]
    pc = np.where(pvalid, pc, -1)
    brows = np.flatnonzero(bvalid)
    order = brows[np.argsort(bc[brows], kind="stable")]
    sk = bc[order]
    lo = np.searchsorted(sk, pc, "left")
    hi = np.searchsorted(sk, pc, "right")
    cnt = np.where(pvalid, hi - lo, 0)
    left = np.repeat(np.arange(len(pc)), cnt)
    first = np.cumsum(cnt) - cnt
    right = order[lo[left] + np.arange(len(left)) - first[left]]
    return left.astype(np.int32), right.astype(np.int32)


def large_cases(torch, dt, Column):
    """(what, probe keys, build keys) on the card for the large route: 513,
    1,025 and 52,000 build rows, 600 equal keys, nulls, INT32 and INT64,
    one and two key columns, columns that are views one element into their
    buffers; about a million probe rows each."""
    rng = np.random.default_rng(7)
    npb = 1_000_003

    def col(a, dtype, null_p=0.0, offset=0):
        v = (rng.random(a.shape[0] + offset) > null_p) if null_p else None
        c = Column.from_numpy(np.concatenate([a[:offset], a]), dtype, v,
                              device="cuda")
        return Column(dtype, a.shape[0], c.data[offset:],
                      None if v is None else c.validity[offset:])

    def probe_of(bk, npt, hit=0.8):
        pick = rng.integers(0, bk.shape[0], npb)
        return np.where(rng.random(npb) < hit, bk[pick],
                        bk[pick] + 1).astype(npt)

    k = rng.integers(0, 400, 513).astype(np.int64)
    yield ("513 INT64 rows with nulls", [col(probe_of(k, np.int64), dt.INT64,
                                             0.05)], [col(k, dt.INT64, 0.1)])
    k1 = rng.integers(0, 9, 1025).astype(np.int32)
    k2 = rng.integers(0, 200, 1025).astype(np.int64)
    pick = rng.integers(0, 1025, npb)
    yield ("1,025 rows, INT32 + INT64 keys",
           [col(k1[pick], dt.INT32), col(np.where(
               rng.random(npb) < 0.7, k2[pick], k2[pick] + 500), dt.INT64)],
           [col(k1, dt.INT32), col(k2, dt.INT64)])
    k = rng.integers(-600, 600, 1025).astype(np.int32)
    yield ("1,025 INT32 rows, views at offset 1",
           [col(probe_of(k, np.int32), dt.INT32, 0.1, offset=1)],
           [col(k, dt.INT32, 0.1, offset=1)])
    yield ("600 equal INT64 keys",
           [col(np.where(rng.random(npb) < 0.01, 7, 8).astype(np.int64),
                dt.INT64)], [col(np.full(600, 7, np.int64), dt.INT64)])
    items, weeks = np.meshgrid(np.arange(500), np.arange(104))
    yield ("52,000 rows, q72's inventory (item, week)",
           [col(rng.integers(0, 520, npb).astype(np.int64), dt.INT64, 0.02),
            col(rng.integers(0, 104, npb).astype(np.int64), dt.INT64)],
           [col(items.ravel().astype(np.int64), dt.INT64),
            col(weeks.ravel().astype(np.int64), dt.INT64)])
    k = rng.permutation(52_000).astype(np.int32)
    yield ("52,000 INT32 rows with nulls, views at offset 1",
           [col(probe_of(k, np.int32), dt.INT32, 0.02, offset=1)],
           [col(k, dt.INT32, 0.05, offset=1)])


def barrier_ms(torch, jc, rows, rounds=1000):
    """One grid-wide barrier alone, on the large build's grid for `rows`
    rows: (rounds barriers - none) / rounds, between CUDA events, the median
    of five."""
    def timed(r):
        jc.barrier_cuda(rows, r)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = jc.barrier_cuda(rows, r)
        end.record()
        torch.cuda.synchronize()
        require(int(out) == r, "the barrier kernel did not run")
        return start.elapsed_time(end)
    return float(np.median([(timed(rounds) - timed(0)) / rounds
                            for _ in range(5)]))


def large_bounds(torch, jc, pcols, bcols, C, counts):
    """kernel_bounds for the large route: the table is one 8-byte word a
    slot and a list entry 8 bytes; the build moves its keys and writes the
    table (its rows' hashes and distances are scratch, not counted)."""
    n, nb = pcols[0].length, bcols[0].length
    b = kernel_bounds(torch, jc, pcols, bcols, C, counts)
    n_matched = int((counts > 0).sum())
    build_in = sum(c.nbytes() for c in bcols)
    hash_ops = sum(HASH_OPS[w] for w in jc._wide(bcols))
    return {"build": (build_in + 8 * C, nb * hash_ops),
            "count": (b["count"][0] + 4 * n_matched, b["count"][1]),
            "emit": (b["emit"][0] + 4 * n_matched, 0)}


def large_route_phase(torch, chk):
    """The large build against its plain version, then whole joins against
    numpy; rounds, times and bounds per case."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import join, join_cuda as jc
    from spark_rapids_tpu_torch.ops.registry import REGISTRY

    t0 = time.perf_counter()
    out = []
    for what, pc, bc in large_cases(torch, dt, Column):
        nb = bc[0].length
        C = jc._capacity(nb)
        require(jc.is_large(C), f"{what}: C = {C} is not the large route")
        before = dict(jc.LARGE_LAUNCHES)
        tk = jc.build_table_cuda(bc, C)
        tp = jc.build_table_plain(bc, C)
        chk.equal("build_large", tk.slot_row, tp.slot_row, f"{what} slot_row")
        chk.equal("build_large", tk.slot_hash, tp.slot_hash,
                  f"{what} slot_hash")
        rounds = int(tk.rounds)
        pk = jc.probe_counts_cuda(pc, tk, bc)
        pp = jc.probe_counts_plain(pc, tp, bc)
        for name in ("counts", "tile_sums", "tile_offsets", "seg_sums",
                     "seg_matched", "total"):
            chk.equal("count_large", getattr(pk, name), getattr(pp, name),
                      f"{what} {name}")
        at = torch.arange(pk.counts.shape[0], device=pk.counts.device)
        listed = (at % pk.seg) < pk.seg_matched.index_select(0, at // pk.seg)
        chk.equal("count_large", pk.entries[listed], pp.entries[listed],
                  f"{what} entries")
        total = int(pk.total)
        lk, rk = jc.probe_emit_cuda(pc, tk, bc, pk, total)
        lp, rp = jc.probe_emit_plain(pc, tp, bc, pp, total)
        chk.equal("emit_large", lk, lp, f"{what} left map")
        chk.equal("emit_large", rk, rp, f"{what} right map")
        require(jc.LARGE_LAUNCHES == {k: v + 1 for k, v in before.items()},
                f"{what}: large-route launches {jc.LARGE_LAUNCHES}")
        # the whole join against an independent numpy join
        lm, rm = jc.inner_join_hash(pc, bc)

        def host(cols):
            keys = [c.data.cpu().numpy().astype(np.int64) for c in cols]
            valid = np.ones(cols[0].length, bool)
            for c in cols:
                if c.validity is not None:
                    valid &= c.validity.cpu().numpy()
            return keys, valid
        nl, nr = np_join(*host(pc), *host(bc))
        chk.equal("emit_large", lm.data.cpu(), torch.from_numpy(nl),
                  f"{what} inner_join_hash left map vs numpy")
        chk.equal("emit_large", rm.data.cpu(), torch.from_numpy(nr),
                  f"{what} inner_join_hash right map vs numpy")
        build = lambda: jc.build_table_cuda(bc, C)          # noqa: E731
        ms = device_ms(torch, build, KERNEL_NAMES["build_large"], 20)
        cms = call_ms(torch, build, 20)
        nbytes, ops = large_bounds(torch, jc, pc, bc, C, pk.counts)["build"]
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S) * 1e3
        bar = barrier_ms(torch, jc, nb)
        out.append({"what": what, "rows": nb, "capacity": C,
                    "rounds": rounds, "device_ms": ms, "call_ms": cms,
                    "bound_ms": bound, "barrier_ms": bar,
                    "rounds_x_barrier_ms": rounds * bar, "pairs": total})
        log(f"  {what}: C {C}, {rounds} rounds, {total} pairs; kernels == "
            f"plain, maps == numpy; build device {ms!r} ms, one call "
            f"{cms!r} ms, bound {bound!r} ms ({nbytes} B, {ops} ops); one "
            f"grid barrier {bar!r} ms, x rounds {rounds * bar!r} ms")
    # the new ceiling: MAX_BUILD rows are taken, one more declines
    n = jc.MAX_BUILD
    keys = Column.from_numpy(np.random.default_rng(3).permutation(n)
                             .astype(np.int64), dt.INT64, device="cuda")
    C = jc._capacity(n)
    tk = jc.build_table_cuda([keys], C)
    tp = jc.build_table_plain([keys], C)
    chk.equal("build_large", tk.slot_row, tp.slot_row, "2^22 rows slot_row")
    chk.equal("build_large", tk.slot_hash, tp.slot_hash,
              "2^22 rows slot_hash")
    rounds = int(tk.rounds)
    ms = device_ms(torch, lambda: jc.build_table_cuda([keys], C),
                   KERNEL_NAMES["build_large"], 5)
    one = [Column.from_numpy(np.zeros(4, np.int64), dt.INT64, device="cuda")]
    over = [Column.from_numpy(np.zeros(n + 1, np.int64), dt.INT64,
                              device="cuda")]
    ch = REGISTRY.select("hash_join",
                         jc.make_signature(one, over, "inner", "eager"),
                         backend="cuda")
    require(ch.fallback and ("cuda", "unsupported signature") in ch.declined,
            f"a build side over MAX_BUILD was not declined: {ch}")
    try:
        jc.build_table_cuda(over, jc.MAX_CAPACITY)
    except ValueError:
        pass
    else:
        raise AssertionError("a build side over MAX_BUILD ran the kernel")
    log(f"  {n} rows (the ceiling, C {C}): {rounds} rounds, device {ms!r} "
        f"ms, table == plain; {n + 1} rows decline")
    # large-route joins on two streams at once: each cooperative grid is
    # resident alone and the calls share no device state
    fl, fr = join.inner_join(pc, bc)
    two_stream_joins(torch, jc, pc, bc, (fl.data, fr.data))
    log(f"  {what} on two streams at once, 2 x 5 calls: maps == plain")
    log(f"large route: {time.perf_counter() - t0:.1f} s")
    return {"cases": out, "ceiling": {"rows": n, "capacity": C,
                                      "rounds": rounds, "device_ms": ms}}


# ---- phase 4d': NDS q72 -------------------------------------------------------

def numpy_q72(gen):
    """Independent q72 over the datagen arrays: the dimension filters, the
    joins as lookups on each dimension's keys, the two residuals, the
    composite (item, week) lookup into inventory, then counts by (item,
    warehouse, week) ordered by count descending and the keys ascending."""
    cs, inv, items, hd, wh, dates = gen
    hd_ok = np.isin(cs["hd_sk"], hd["hd_demo_sk"][hd["hd_buy_potential"]
                                                 == 3])
    item_ok = np.isin(cs["item_sk"], items["i_item_sk"])
    y1 = dates["d_year"] == 1
    d_pos = np.searchsorted(dates["d_date_sk"], cs["sold_date_sk"])
    d_pos = np.minimum(d_pos, len(dates["d_date_sk"]) - 1)
    date_ok = (dates["d_date_sk"][d_pos] == cs["sold_date_sk"]) & y1[d_pos]
    keep = hd_ok & item_ok & date_ok & (cs["ship_days"] > 5)
    item, qty = cs["item_sk"][keep], cs["qty"][keep]
    week = dates["d_week"][d_pos[keep]]
    inv_key = inv["inv_item_sk"] * 1024 + inv["inv_week"]
    order = np.argsort(inv_key, kind="stable")
    want = item * 1024 + week
    pos = np.minimum(np.searchsorted(inv_key[order], want), len(order) - 1)
    hit = inv_key[order][pos] == want
    row = order[pos]
    ok = hit & (inv["inv_qty"][row] < qty)
    wh_sk = inv["inv_wh_sk"][row]
    ok &= np.isin(wh_sk, wh["w_warehouse_sk"])
    groups, cnt = np.unique(np.stack([item[ok], wh_sk[ok], week[ok]], 1),
                            axis=0, return_counts=True)
    o = np.lexsort((groups[:, 2], groups[:, 1], groups[:, 0], -cnt))
    return groups[o, 0], groups[o, 1], groups[o, 2], cnt[o]


def q72_join_shape(torch, gen):
    """The inventory join of the authored q72 at this scale: the probe keys
    (i_item_sk, d_week) of the catalog_sales rows the earlier joins and
    ship_days keep, in row order, and inventory's (item, week)."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    cs, inv, items, hd, wh, dates = gen
    keep = (np.isin(cs["hd_sk"], hd["hd_demo_sk"][hd["hd_buy_potential"]
                                                   == 3])
            & (dates["d_year"][cs["sold_date_sk"]] == 1)
            & (cs["ship_days"] > 5))
    week = dates["d_week"][cs["sold_date_sk"][keep]]

    def c(a):
        return Column.from_numpy(np.ascontiguousarray(a), dt.INT64,
                                 device="cuda")
    return ([c(cs["item_sk"][keep]), c(week)],
            [c(inv["inv_item_sk"]), c(inv["inv_week"])])


def q72_phase(torch, chk):
    """NDS q72 at 10M catalog_sales rows through `PlanExecutor`, authored
    and optimized, counters zeroed just before each and read just after;
    both equal to numpy q72 and to the CPU run, bit for bit; then the
    inventory join's three kernels timed at its shape."""
    from spark_rapids_tpu_torch import nds_q72
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.ops import select_cuda as sc
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.plan import PlanExecutor

    t0 = time.perf_counter()
    gen = nds_q72.datagen(N_SALES, seed=0)
    inputs_cpu = nds_q72.q72_inputs(N_SALES, seed=0, device="cpu")
    log(f"q72 datagen: {N_SALES} catalog_sales rows in "
        f"{time.perf_counter() - t0:.1f} s")
    inputs = {k: t.to("cuda") for k, t in inputs_cpu.items()}
    ref = numpy_q72(gen)
    plan = nds_q72.q72_plan()
    out = {}
    for optimize in (False, True):
        what = "q72 optimized" if optimize else "q72 authored"
        ex = PlanExecutor(optimize=optimize)           # the card
        torch.cuda.synchronize()
        for m in (jc, sc, tc, gc):
            m.reset_counters()
        res = ex.execute(plan, inputs)
        torch.cuda.synchronize()
        launches = {"hash_join": dict(jc.LAUNCHES),
                    "hash_join_large": dict(jc.LARGE_LAUNCHES),
                    "fused_select": dict(sc.LAUNCHES),
                    "groupby": dict(gc.LAUNCHES)}
        plain = {"hash_join": dict(jc.PLAIN_CALLS),
                 "fused_select": dict(sc.PLAIN_CALLS),
                 "topk": dict(tc.PLAIN_CALLS),
                 "groupby": dict(gc.PLAIN_CALLS)}
        log(f"{what} at {N_SALES} rows on {res.device}: {res.wall_ms:.3f} "
            f"ms, launches {launches}, plain runs {plain}")
        log(res.profile_text())
        stamps = [m.kernel for m in res.metrics.values()
                  if m.kind == "HashJoin"]
        require(stamps == ["cuda:hash_join"] * 5, f"{what} stamps {stamps}")
        require(launches["hash_join"] == {"build": 5, "count": 5, "emit": 5}
                and launches["hash_join_large"] == {"build": 1, "count": 1,
                                                    "emit": 1},
                f"{what}: hash-join launches {launches}")
        fused = [m.kernel for m in res.metrics.values()
                 if m.kind == "FusedSelect"]
        require(all(k == "cuda:fused_select" for k in fused)
                and launches["fused_select"]["count"] == len(fused)
                and (len(fused) > 0) == optimize,
                f"{what}: FusedSelects {fused}, launches {launches}")
        require(all(v == 0 for d in plain.values() for v in d.values()),
                f"{what}: plain versions ran on the card path {plain}")
        require_groupby(gc, res, what)
        warm = [ex.execute(plan, inputs) for _ in range(3)]
        walls = [r.wall_ms for r in warm]
        log(f"{what} repeat wall ms: " + ", ".join(f"{w:.3f}" for w in walls))
        got = res.table.to("cpu")
        require(got.names == ("i_item_sk", "w_warehouse_sk", "d_week", "cnt")
                and got.num_rows > 0, f"{what} gave {got.names} x "
                f"{got.num_rows}")
        for name, want in zip(got.names, ref):
            have = got[name].data.numpy()
            if have.shape != want.shape or not np.array_equal(have, want):
                raise AssertionError(f"{what} {name} differs from numpy q72")
        t1 = time.perf_counter()
        cpu = PlanExecutor(device="cpu", optimize=optimize).execute(
            plan, inputs_cpu)
        log(f"{what} on the CPU for comparison: "
            f"{time.perf_counter() - t1:.1f} s")
        chk.tables("emit_large", got, cpu.table, f"{what} card vs CPU")
        log(f"{what}: {got.num_rows} groups, equal to numpy q72 and to the "
            f"CPU run")
        out[what] = {"res": res, "launches": launches, "plain": plain,
                     "warm_wall_ms": walls,
                     "optimizer": res.optimizer,
                     "profile": warm[-1].profile()}
    del inputs

    # the inventory join's kernels at its shape in the authored plan
    pc, bc = q72_join_shape(torch, gen)
    C = jc._capacity(bc[0].length)
    tbl = jc.build_table_cuda(bc, C)
    probe = jc.probe_counts_cuda(pc, tbl, bc)
    total = int(probe.total)
    calls = {
        "build": (lambda: jc.build_table_cuda(bc, C),
                  lambda: jc.build_table_plain(bc, C)),
        "count": (lambda: jc.probe_counts_cuda(pc, tbl, bc),
                  lambda: jc.probe_counts_plain(pc, tbl, bc)),
        "emit": (lambda: jc.probe_emit_cuda(pc, tbl, bc, probe, total),
                 lambda: jc.probe_emit_plain(pc, tbl, bc, probe, total)),
    }
    bounds = large_bounds(torch, jc, pc, bc, C, probe.counts)
    timing = {}
    for k, (kern, plain_fn) in calls.items():
        ms = device_ms(torch, kern, KERNEL_NAMES[k + "_large"], 30)
        cms = call_ms(torch, kern, 30)
        pms = time_cuda(torch, plain_fn, 3)
        nbytes, ops = bounds[k]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_INT_OPS_PER_S * 1e3
        timing[k] = {"ms": ms, "call_ms": cms, "plain_ms": pms,
                     "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
                     "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms)}
        log(f"  q72 inventory join {k} (large route): device {ms!r} ms, one "
            f"call {cms!r} ms, plain {pms!r} ms; bound "
            f"{max(bytes_ms, ops_ms)!r} ms ({nbytes} B, {ops} ops)")
    rounds = int(tbl.rounds)
    bar = barrier_ms(torch, jc, bc[0].length)
    timing["build"].update(rounds=rounds, barrier_ms=bar,
                           rounds_x_barrier_ms=rounds * bar)
    join_ms, by_name = device_by_name(
        torch, lambda: jc.inner_join_hash(pc, bc), 20)
    log(f"  q72 inventory join: probe {pc[0].length} x build "
        f"{bc[0].length} (C {C}) -> {total} pairs; {rounds} rounds, one "
        f"grid barrier {bar!r} ms, x rounds {rounds * bar!r} ms; whole "
        f"inner_join_hash device {join_ms!r} ms ({by_name})")
    timing["join"] = {"device_ms": join_ms, "by_name": by_name,
                      "probe_rows": pc[0].length, "pairs": total}
    return out, timing


# ---- phase 4e: keyed float sums on the card (ROADMAP queue C 4) ----------------

C4_GROUPS = (3, 1000)


def c4_phase(torch, chk, add_ms):
    """A FLOAT64 column of 10M rows summed and averaged over 3 and over 1,000
    groups through `PlanExecutor`, twice on the card, each run's bits held
    to the CPU run's (the groupby kernel's fold, one launch a run);
    `index_add_` on the card beside it, as the fault it repairs; then the
    fold alone (`segment_sum_cuda`) timed at 3 groups."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.ops import segment_sum_cuda as ssc
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor

    rng = np.random.default_rng(4)
    vals = rng.standard_normal(N_ROWS) * 10.0 ** rng.integers(-8, 12, N_ROWS)
    plan = (PlanBuilder().scan("t", schema=["g", "x"])
            .aggregate(["g"], [("x", "sum", "s"), ("x", "mean", "m")])
            .build())
    out = {"launches": 0}
    for groups in C4_GROUPS:
        g = rng.integers(0, groups, N_ROWS).astype(np.int64)
        t_cpu = Table([Column.from_numpy(g, dt.INT64, device="cpu"),
                       Column.from_numpy(vals, dt.FLOAT64,
                                         rng.random(N_ROWS) > 0.05,
                                         device="cpu")], ["g", "x"])
        t_gpu = {"t": t_cpu.to("cuda")}
        cpu = PlanExecutor(device="cpu", optimize=False).execute(
            plan, {"t": t_cpu}).table
        for run in (1, 2):
            gc.reset_counters()
            ssc.reset_counters()
            got = PlanExecutor(optimize=False).execute(plan, t_gpu).table
            torch.cuda.synchronize()
            require(gc.LAUNCHES == {"groupby": 1, "fold": 1}
                    and gc.PLAIN_CALLS["groupby"] == 0
                    and ssc.PLAIN_CALLS["segment_sum"] == 0,
                    f"C4 {groups} groups: groupby launches {gc.LAUNCHES}, "
                    f"plain {gc.PLAIN_CALLS} {ssc.PLAIN_CALLS}")
            out["launches"] += gc.LAUNCHES["fold"]
            chk.tables("segment_sum", got.to("cpu"), cpu,
                       f"C4 {groups} groups run {run}")
        # the fault: index_add_ on the card, against the CPU's row order
        seg = torch.from_numpy(np.sort(g))
        v = torch.from_numpy(vals)
        want = torch.zeros(groups, dtype=torch.float64).index_add_(0, seg, v)
        differ = []
        for _ in range(2):
            o = torch.zeros(groups, dtype=torch.float64,
                            device="cuda").index_add_(0, seg.cuda(),
                                                      v.cuda()).cpu()
            differ.append(int((o.view(torch.int64)
                               != want.view(torch.int64)).sum()))
        out[groups] = {"index_add_groups_differing": differ}
        log(f"C4, {groups} groups: sum and mean on the card equal the CPU "
            f"run's bits, twice; index_add_ on the card differs from the "
            f"CPU in {differ} of {groups} groups")
    # the kernel alone at 3 groups: 10M key-sorted values
    seg = torch.from_numpy(np.sort(rng.integers(0, 3, N_ROWS))).cuda()
    v = torch.from_numpy(vals).cuda()
    starts = torch.searchsorted(seg, torch.arange(3, device="cuda"))
    kern = lambda: ssc.segment_sum_cuda(v, starts)        # noqa: E731
    lib = lambda: torch.zeros(3, dtype=torch.float64,     # noqa: E731
                              device="cuda").index_add_(0, seg, v)
    want = ssc.segment_sum_plain(v.cpu(), seg.cpu(), 3)
    chk.equal("segment_sum", kern().cpu().view(torch.int64),
              want.view(torch.int64), "segment sum, 3 groups")
    ms = device_ms(torch, kern, KERNEL_NAMES["segment_sum"], 5, per_call=2)
    cms = call_ms(torch, kern, 5)
    lms = call_ms(torch, lib, 5)
    t0 = time.perf_counter()
    ssc.segment_sum_plain(v.cpu(), seg.cpu(), 3)
    pms = (time.perf_counter() - t0) * 1e3
    nbytes = 8 * N_ROWS + 8 * 3 + 8 * 3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = N_ROWS / PEAK_F64_OPS_PER_S * 1e3
    longest = int(torch.bincount(seg).max())
    out["timing"] = {"ms": ms, "call_ms": cms, "plain_ms": pms,
                     "library_ms": lms, "bytes": nbytes, "ops": N_ROWS,
                     "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "longest_group": longest,
                     "chain_ms": longest * add_ms}
    log(f"  segment sum (the groupby kernel's fold alone), 10M rows in 3 "
        f"groups: device {ms!r} ms, one call {cms!r} ms; plain (index_add_ "
        f"on the CPU, host clock) {pms!r} ms; index_add_ on the card "
        f"{lms!r} ms; bound {max(bytes_ms, ops_ms)!r} ms ({nbytes} B); "
        f"chain {longest * add_ms!r} ms ({longest} dependent adds)")
    return out


# ---- phase 4e': the groupby kernel ------------------------------------------

# the value kinds of the groupby matrix: (name, numpy type, kind name)
GB_KINDS = (("i8", np.int8, "int8"), ("i16", np.int16, "int16"),
            ("i32", np.int32, "int32"), ("i64", np.int64, "int64"),
            ("f32", np.float32, "float32"), ("f64", np.float64, "float64"),
            ("d32", np.int32, "date32"), ("ts", np.int64, "timestamp"))
GB_SIZES = (0, 1, 2047, 2048, 2049, 6145, 100_003)
GB_DADD_ROUNDS = 1 << 22


def gb_values(rng, name, npt, n):
    """Values over the kind's range: integer extremes (sums wrap), floats
    with -0.0, 0.0, NaN, both infinities and magnitudes from 1e-300 to
    1e300 (one NaN pattern: the CPU's NaN bits depend on which operand its
    compiler put first)."""
    if name.startswith("f"):
        pick = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf, 1.5, -2.25,
                         1e-300, -1e300, 3e38])
        v = np.where(rng.random(n) < 0.2, rng.choice(pick, n),
                     rng.standard_normal(n) * 10.0 ** rng.integers(-8, 12, n))
        with np.errstate(over="ignore"):
            return v.astype(npt)
    info = np.iinfo(npt)
    v = rng.integers(info.min, info.max, n, dtype=np.int64, endpoint=True)
    return np.where(rng.random(n) < 0.05, info.max, v).astype(npt)


def gb_table(rng, keys, null_p, device="cpu"):
    """A table of key column "k" and one value column per kind of
    GB_KINDS (nulls at rate null_p; the "i64" column also null in every
    group whose key is a multiple of 3, so all-null groups occur), and
    the aggregations of every op over it."""
    from spark_rapids_tpu_torch import table_from_numpy
    n = keys.shape[0]
    names, arrays, valid, kinds = ["k"], [keys], [None], ["int64"]
    aggs = [("k", "size")]
    for name, npt, kind in GB_KINDS:
        v = rng.random(n) >= null_p if null_p else None
        if name == "i64":
            v = (rng.random(n) >= null_p) & (keys % 3 != 0)
        names.append(name)
        arrays.append(gb_values(rng, name, npt, n))
        valid.append(v)
        kinds.append(kind)
        aggs += [(name, op) for op in ("count", "min", "max", "mean")]
        if kind not in ("date32", "timestamp"):
            aggs.append((name, "sum"))
    return table_from_numpy(names, arrays, valid, kinds, device=device), aggs


def gb_keys(rng, dist, n):
    if dist == "one group":
        return np.zeros(n, np.int64)
    if dist == "all distinct":
        return rng.permutation(n).astype(np.int64)
    if dist == "tile edges":
        # runs of lengths around the kernel's 2,048-row tile
        lens = rng.choice([1, 2, 2047, 2048, 2049, 4095, 4097, 6145], 64)
        return rng.permutation(np.resize(np.repeat(np.arange(lens.size),
                                                   lens), n)).astype(np.int64)
    return rng.integers(0, 40, n).astype(np.int64)


def gb_nan_table(rng):
    """Float sums that end NaN, on distinct payloads of both signs, so the
    first NaN of a group and its last give different bits: short groups (a
    thread a group) and long ones (a warp pair, several staged chunks),
    FLOAT64 with nulls and FLOAT32, and two groups whose only NaN is
    inf - inf; -> (table, aggregations)."""
    from spark_rapids_tpu_torch import table_from_numpy
    sizes = [5, 4, 3, 4, 40, 1500, 700, 33]
    n = sum(sizes)
    k = np.repeat(np.arange(len(sizes)), sizes).astype(np.int64)
    x = rng.standard_normal(n)
    f = rng.standard_normal(n).astype(np.float32)
    xb, fb = x.view(np.uint64), f.view(np.uint32)
    for lo, hi in zip(np.cumsum([0] + sizes[:-1]), np.cumsum(sizes)):
        at = rng.choice(np.arange(lo, hi), min(hi - lo, 6), replace=False)
        xb[at] = (np.uint64(0x7FF0000000000000)
                  | rng.integers(1, 1 << 51, at.size).astype(np.uint64)
                  | (rng.integers(0, 2, at.size).astype(np.uint64) << 63))
        fb[at] = (np.uint32(0x7F800000)
                  | rng.integers(1, 1 << 22, at.size).astype(np.uint32)
                  | (rng.integers(0, 2, at.size).astype(np.uint32) << 31))
    for g in (2, 7):
        lo = sum(sizes[:g])
        x[lo:lo + sizes[g]] = np.where(np.arange(sizes[g]) % 2, np.inf,
                                       -np.inf)
    t = table_from_numpy(["k", "x", "f"], [k, x, f],
                         [None, rng.random(n) >= 0.1, None],
                         ["int64", "float64", "float32"], device="cpu")
    return t, [("x", "sum"), ("x", "mean"), ("f", "sum"), ("f", "mean")]


def gb_case(torch, chk, gc, aggregate, t_cpu, aggs, what, cap=None,
            alive=None):
    """The kernel on the card against the plain version on the CPU, bit
    for bit; one launch a call with rows."""
    t_gpu = t_cpu.to("cuda")
    before = gc.LAUNCHES["groupby"]
    if cap is None:
        want = aggregate.groupby_aggregate(t_cpu, ["k"], aggs)
        got = aggregate.groupby_aggregate(t_gpu, ["k"], aggs)
        chk.tables("groupby", got.to("cpu"), want, what)
    else:
        want = aggregate.groupby_aggregate_capped(t_cpu, ["k"], aggs, cap,
                                                  alive)
        got = aggregate.groupby_aggregate_capped(
            t_gpu, ["k"], aggs, cap, None if alive is None else alive.cuda())
        chk.tables("groupby", got[0].to("cpu"), want[0], what)
        chk.equal("groupby", got[1].cpu(), want[1], f"{what} valid")
        chk.equal("groupby", got[2].cpu(), want[2], f"{what} overflow")
    torch.cuda.synchronize()
    launched = gc.LAUNCHES["groupby"] - before
    require(launched == (1 if t_cpu.num_rows else 0)
            and gc.PLAIN_CALLS["groupby"] == 0,
            f"{what}: {launched} launches, plain {gc.PLAIN_CALLS}")


def gb_sorted(torch, table, key):
    """(order, seg, per-row group, group count) of `table` by `key`, as
    `groupby_aggregate` computes them."""
    from spark_rapids_tpu_torch.ops.sort import _key_operands, lex_order
    ops_ = _key_operands(table[key], True, None)
    order = lex_order(ops_)
    n = table.num_rows
    boundary = torch.arange(n, device=table.device) == 0
    for o in ops_:
        s = o.index_select(0, order)
        boundary[1:] |= s[1:] != s[:-1]
    seg = torch.cumsum(boundary, 0) - 1
    gid = torch.empty_like(seg).scatter_(0, order, seg)
    return order, boundary, seg, gid, int(seg[-1]) + 1


def gb_bytes(specs, n, G, gc):
    """Bytes the groupby must move: `seg` read once, `order` read once
    (only at the groups' first rows when no job reads a row), each value
    and validity byte gathered once, every (G,) output written once."""
    jobs, _ = gc._jobs(specs)
    reads_rows = any(j.col is not None and (j.op != gc.OP_COUNT
                                            or j.col.validity is not None)
                     for j in jobs)
    total = 8 * n + (8 * n if reads_rows else 8 * G) + 8 * G
    for j in jobs:
        if j.col is not None and j.op != gc.OP_COUNT:
            total += j.col.data.element_size() * n
        if j.col is not None and j.col.validity is not None:
            total += n
        total += 8 * G
    return total


def dadd_latency_ms(torch, dadd, rounds=GB_DADD_ROUNDS):
    """One dependent float64 add alone, in one thread (`build_phase`'s
    probe): (rounds adds - none) / rounds between CUDA events, the median
    of five."""
    out = torch.zeros(1, dtype=torch.float64, device="cuda")

    def chain(r):
        require(dadd.dadd_chain(r, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
                == 0, "the dependent-add probe did not launch")

    def timed(r):
        chain(r)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(r)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    return float(np.median([(timed(rounds) - timed(0)) / rounds
                            for _ in range(5)]))


def gb_time(torch, chk, gc, aggregate, table, key, aggs, what, add_ms=None):
    """The groupby kernel timed at one keyed aggregate: its device time and
    one call's (the L2 flushed), the plain version on the CPU (host
    clock), `index_add_` on the card over the per-row group ids (the
    library call; for an integer sum or count the same bits, checked), the
    bytes bound and, for a float sum, the chain bound."""
    specs = aggregate._agg_specs(table, aggs)
    order, boundary, seg, gid, G = gb_sorted(torch, table, key)
    n = table.num_rows
    first, cols, _ = gc.groupby_reduce_cuda(specs, order, seg, G)
    fold = any(s.op == "mean" or (s.op == "sum" and s.col.dtype.is_floating)
               for s in specs)
    kern = lambda: gc.groupby_reduce_cuda(specs, order, seg, G)  # noqa: E731
    ms = device_ms(torch, kern, KERNEL_NAMES["groupby"], 20,
                   per_call=4 if fold else 2)
    cms = call_ms(torch, kern, 20)
    # the library call: index_add_ of each value where valid, by row
    (s0,) = [s for s in specs if s.op != "size"][:1] or [specs[0]]
    c = s0.col
    v = (c.null_mask.to(torch.int64) if s0.op == "count"
         else torch.where(c.null_mask, c.data.to(torch.float64 if fold
                                                 else torch.int64), 0))
    lib = lambda: torch.zeros(G, dtype=v.dtype,                # noqa: E731
                              device="cuda").index_add_(0, gid, v)
    lms = call_ms(torch, lib, 20)
    same = None
    if not fold:
        same = bool(torch.equal(lib(), cols[0].data.to(torch.int64)))
        require(same, f"{what}: index_add_ on the card differs from the "
                "kernel's integer result")
    cpu = table.to("cpu")
    o_c, b_c, s_c = order.cpu(), boundary.cpu(), seg.cpu()
    specs_c = aggregate._agg_specs(cpu, aggs)
    t0 = time.perf_counter()
    _, want, _ = aggregate._reduce_plain(specs_c, o_c, b_c, s_c, None, None)
    pms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(cols, want):
        chk.equal("groupby", (a.data.view(torch.int64) if fold
                              else a.data).cpu(),
                  b.data.view(torch.int64) if fold else b.data,
                  f"{what} kernel vs plain")
    nbytes = gb_bytes(specs, n, G, gc)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ = n if fold else 0           # float64 adds
    ops_ms = ops_ / PEAK_F64_OPS_PER_S * 1e3
    out = {"rows": n, "groups": G, "ms": ms, "call_ms": cms,
           "plain_ms": pms, "library_ms": lms,
           "library_same_bits": same, "bytes": nbytes, "ops": ops_,
           "bytes_ms": bytes_ms, "ops_ms": ops_ms,
           "bound_ms": max(bytes_ms, ops_ms)}
    if fold:
        # the fold's own bound: its longest chain of dependent adds
        longest = int(torch.bincount(seg).max())
        out.update(longest_group=longest, dadd_ms=add_ms,
                   chain_ms=longest * add_ms)
    log(f"  groupby {what} ({n} rows, {G} groups): device {ms!r} ms, one "
        f"call {cms!r} ms, plain (CPU, host clock) {pms!r} ms, index_add_ "
        f"on the card {lms!r} ms (same bits: {same}); bound "
        f"{out['bound_ms']!r} ms ({nbytes} B, {ops_} adds"
        + (f", chain {out['chain_ms']!r} ms over {out['longest_group']} "
           f"rows" if fold else "") + ")")
    return out


def groupby_phase(torch, chk, dadd):
    """The groupby kernel against its plain version on the CPU, bit for
    bit: every op on eight kinds, with and without nulls and with all-null
    groups, on one group, all rows distinct, groups across tile edges and
    40 random groups, at 0, 1, a tile - 1, + 0 and + 1, 6,145 and 100,003
    rows, eager and capped (key_cap below, at and above the group count,
    alive masks); at 10M rows on q23's zipf(1.3) % 2,000 and zipf(1.2) %
    5,000 keys, eager and capped; then timed at q23's two keyed aggregates
    and the C4 shapes."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch import nds_q23
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import aggregate
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc

    gc.reset_counters()
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    n_cases = 0
    for dist in ("one group", "all distinct", "tile edges", "40 groups"):
        for n in GB_SIZES:
            for null_p in (0.0, 0.3):
                keys = gb_keys(rng, dist, n)
                t, aggs = gb_table(rng, keys, null_p)
                what = f"groupby {dist}, {n} rows, nulls {null_p}"
                gb_case(torch, chk, gc, aggregate, t, aggs, what)
                n_cases += 1
                if n < 2049:
                    continue
                # key_cap below, at and above the group count, 60% of rows
                # live; at it also with no alive mask
                groups = len(np.unique(keys))
                for cap, live in ((max(groups // 2, 1), 0.6), (groups, 0.6),
                                  (groups + 7, 0.6), (groups, None)):
                    alive = (None if live is None else
                             torch.from_numpy(rng.random(n) < live))
                    gb_case(torch, chk, gc, aggregate, t, aggs,
                            f"{what} capped {cap} live {live}", cap, alive)
                    n_cases += 1
    t, aggs = gb_nan_table(rng)
    gb_case(torch, chk, gc, aggregate, t, aggs, "groupby NaN payloads")
    gb_case(torch, chk, gc, aggregate, t, aggs, "groupby NaN payloads "
            "capped 6", 6, torch.from_numpy(rng.random(t.num_rows) < 0.8))
    n_cases += 2
    log(f"groupby: {n_cases} small cases equal the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    # q23's skew at 10M rows
    t0 = time.perf_counter()
    for s, m in ((1.3, 2000), (1.2, 5000)):
        keys = (rng.zipf(s, N_SALES) % m).astype(np.int64)
        t, aggs = gb_table(rng, keys, 0.1)
        what = f"groupby zipf({s}) % {m}, {N_SALES} rows"
        gb_case(torch, chk, gc, aggregate, t, aggs, what)
        alive = torch.from_numpy(rng.random(N_SALES) < 0.7)
        gb_case(torch, chk, gc, aggregate, t, aggs, f"{what} capped 8192",
                8192, alive)
        n_cases += 2
        del t
    log(f"groupby: zipf keys at {N_SALES} rows equal the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    # timed: q23's two keyed aggregates over its 10M store rows
    store, _ = nds_q23.datagen(N_SALES, seed=0)
    q23 = Table([Column.from_numpy(store[c], dt.INT64, device="cuda")
                 for c in ("item_sk", "cust_sk", "qty")] +
                [Column.from_numpy(store["qty"] * store["price"], dt.INT64,
                                   device="cuda")],
                ["item_sk", "cust_sk", "qty", "rev"])
    del store
    add_ms = dadd_latency_ms(torch, dadd)
    log(f"  one dependent float64 add: {add_ms * 1e6!r} ns "
        f"({GB_DADD_ROUNDS} in one thread)")
    timing = {
        "q23 count(qty) by item_sk": gb_time(
            torch, chk, gc, aggregate, q23, "item_sk", [("qty", "count")],
            "q23 count(qty) by item_sk"),
        "q23 sum(rev) by cust_sk": gb_time(
            torch, chk, gc, aggregate, q23, "cust_sk", [("rev", "sum")],
            "q23 sum(rev) by cust_sk")}
    del q23
    # the C4 shapes: a FLOAT64 sum over 10M rows in 3 and 1,000 groups
    vals = rng.standard_normal(N_SALES) * 10.0 ** rng.integers(-8, 12,
                                                                N_SALES)
    for groups in C4_GROUPS:
        t = Table([Column.from_numpy(rng.integers(0, groups, N_SALES)
                                     .astype(np.int64), dt.INT64,
                                     device="cuda"),
                   Column.from_numpy(vals, dt.FLOAT64,
                                     rng.random(N_SALES) > 0.05,
                                     device="cuda")], ["g", "x"])
        what = f"C4 sum(x) in {groups} groups"
        timing[what] = gb_time(torch, chk, gc, aggregate, t, "g",
                               [("x", "sum")], what, add_ms)
        del t
    torch.cuda.empty_cache()
    return {"cases": n_cases, "dadd_ms": add_ms, "timing": timing}


# ---- phase 4f: the capped tier -----------------------------------------------

CAPPED_TOPK_LIMITS = (50, 100, 4099)   # both routes of the TopK kernels
CAPPED_ALIVE = (0.6, 0.0, 1.0)         # shares of live rows
ESCALATION_ROWS = 100_000
ESCALATION_CAPS = {"row_cap": 128, "key_cap": 16}
ESCALATION_ATTEMPTS = 14
REPEATS = 3


def device_intervals(prof):
    """(start, end) in us of every kernel, copy and memset of a
    torch.profiler run (not the device-side spans of record_function)."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and e.name != "traced_run")


def busy_us(intervals):
    """The union of the intervals' lengths: the card's busy time."""
    total, end = 0, None
    for s, e in intervals:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def traced_run(torch, fn):
    """One run of `fn` (returning a PlanResult) under torch.profiler: its
    wall, the card's busy time and idle share over that wall, and the
    synchronising records: host calls of cudaStreamSynchronize and
    cudaDeviceSynchronize and device-to-host copies on the card."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("traced_run"):
            res = fn()
    (span,) = [e.time_range for e in prof.events() if e.name == "traced_run"
               and not str(e.device_type).endswith("CUDA")]
    # the records that start inside the run (the profiler's own end is
    # outside it)
    names = [e.name for e in prof.events()
             if span.start <= e.time_range.start <= span.end]
    syncs = sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                for n in names)
    dtoh = sum("DtoH" in n for n in names)
    htod = sum("HtoD" in n for n in names)
    busy = busy_us(device_intervals(prof)) / 1e3
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and e.name != "traced_run":
            short = e.name.split("(")[0].removeprefix("void ")[:70]
            ms, k = by_name.get(short, (0.0, 0))
            by_name[short] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": res.wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / res.wall_ms,
            "n_device_events": len(device_intervals(prof)),
            "sync_calls": syncs, "dtoh_copies": dtoh, "htod_copies": htod,
            "attempts": res.attempts,
            "top": [(k, ms, n) for k, (ms, n) in top]}


# the torch ops and device kernels a keyed aggregate ran before the groupby
# kernel: the atomic scatters of the plain version
SCATTER_OPS = ("aten::index_add_", "aten::index_add", "aten::scatter_reduce",
               "aten::scatter_reduce_", "aten::bincount", "aten::scatter_")
SCATTER_KERNELS = ("indexFuncLargeIndex", "indexFuncSmallIndex",
                   "scatter_reduce", "scatter_fill",
                   # torch's scatter_ (gather's kernel has <false here)
                   "_scatter_gather_internal_kernel<true")


# the host calls that launch a kernel: CUPTI gives each the correlation id of
# its kernel's record
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def keyed_aggregate_trace(torch, fn, aggregate=None, attempts=6):
    """One run of `fn` under torch.profiler with every keyed aggregate
    (`aggregate.groupby_aggregate`, which the capped form calls too)
    inside a `keyed_aggregate` range: how many ranges ran, the torch ops
    inside them that scatter, and the device kernels the ranges launched,
    by name. `aggregate` is the port's module unless a stand-in is given.
    CUPTI drops a session's kernel records at times, so a profile is
    `complete` when every kernel launch call inside the ranges has a
    kernel record of its correlation id; an incomplete one is taken
    again, at most `attempts` times, and the last is returned."""
    for _ in range(attempts):
        out = _keyed_aggregate_trace(torch, fn, aggregate)
        if out["complete"]:
            break
    return out


def _keyed_aggregate_trace(torch, fn, aggregate):
    from torch.profiler import ProfilerActivity, profile, record_function
    if aggregate is None:
        from spark_rapids_tpu_torch.ops import aggregate
    real = aggregate.groupby_aggregate

    def ranged(*args, **kwargs):
        with record_function("keyed_aggregate"):
            return real(*args, **kwargs)

    aggregate.groupby_aggregate = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a few kernels before the traced work: the records of a
            # session's first launches are the ones CUPTI drops
            warm = torch.zeros(1024, device="cuda")
            for _ in range(8):
                warm.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    finally:
        aggregate.groupby_aggregate = real
    events = prof.events()
    cpu_ranges = [e.time_range for e in events
                  if e.name == "keyed_aggregate"
                  and not str(e.device_type).endswith("CUDA")]
    dev_ranges = [e.time_range for e in events
                  if e.name == "keyed_aggregate"
                  and str(e.device_type).endswith("CUDA")]

    def in_ranges(e, ranges):
        return any(r.start <= e.time_range.start <= r.end for r in ranges)

    host = [e for e in events if not str(e.device_type).endswith("CUDA")
            and in_ranges(e, cpu_ranges)]
    ops_in = sorted({e.name for e in host if e.name in SCATTER_OPS})
    # the launch calls inside the ranges and the kernel records, matched by
    # CUPTI's correlation id (the profiler's raw records keep it)
    raw = prof.profiler.kineto_results.events()
    spans = [(k.start_ns(), k.end_ns()) for k in raw
             if k.name() == "keyed_aggregate"
             and not str(k.device_type()).endswith("CUDA")]
    launched = {k.correlation_id() for k in raw
                if k.name() in LAUNCH_CALLS
                and not str(k.device_type()).endswith("CUDA")
                and any(a <= k.start_ns() <= b for a, b in spans)}
    recorded = {k.correlation_id() for k in raw
                if str(k.device_type()).endswith("CUDA")}
    # the device records inside a range's device-side span (every kernel,
    # copy and memset, the port's own launches included), else the kernels
    # the profiler links to a torch op inside a range; a scatter found by
    # either counts (a span can end before its last kernel's record starts)
    names = [e.name for e in events
             if str(e.device_type).endswith("CUDA")
             and e.name != "keyed_aggregate" and in_ranges(e, dev_ranges)]
    linked = [k.name for e in host for k in getattr(e, "kernels", ())]

    def short(name):
        return name.split("(")[0].removeprefix("void ")[:70]

    kernels = {}
    for name in names or linked:
        kernels[short(name)] = kernels.get(short(name), 0) + 1
    scatters = {short(name) for name in names + linked
                if any(x in name.replace(" ", "") for x in SCATTER_KERNELS)}
    return {"ranges": len(cpu_ranges), "device_spans": len(dev_ranges),
            "launch_calls": len(launched), "linked_kernels": len(linked),
            "missing_records": len(launched - recorded),
            "complete": bool(launched) and launched <= recorded,
            "scatter_ops": ops_in, "scatter_kernels": sorted(scatters),
            "kernels": kernels}


def sync_warnings(torch, fn):
    """(result, the Python lines that made a synchronising call) of `fn`
    under torch.cuda.set_sync_debug_mode("warn")."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def recording_joins(jc):
    """Wrap `join_cuda.inner_join_capped_hash` (the executor looks it up at
    each call) so that a run records every call's arguments; returns
    (calls, restore)."""
    calls = []
    real = jc.inner_join_capped_hash

    def rec(lkeys, rkeys, row_cap, *, lalive=None, ralive=None):
        calls.append((list(lkeys), list(rkeys), row_cap, lalive, ralive))
        return real(lkeys, rkeys, row_cap, lalive=lalive, ralive=ralive)

    jc.inner_join_capped_hash = rec

    def restore():
        jc.inner_join_capped_hash = real
    return calls, restore


def capped_join_cases(torch, chk, jc, join, lkeys, rkeys, row_cap, lalive,
                      ralive, what):
    """The capped join kernel against its plain version, all four outputs
    bit for bit, at `row_cap`, at the total and at half of it (overflowing)
    and at the total + 1; returns the total."""
    got = jc.inner_join_capped_hash(lkeys, rkeys, row_cap, lalive=lalive,
                                    ralive=ralive)
    total = int(got[2].sum())
    require(not bool(got[3]) or total == row_cap, f"{what}: overflow flag")
    caps = sorted({row_cap, total, total + 1, total // 2})
    for cap in caps:
        a = jc.inner_join_capped_hash(lkeys, rkeys, cap, lalive=lalive,
                                      ralive=ralive)
        b = join.inner_join_capped(lkeys, rkeys, cap, lalive=lalive,
                                   ralive=ralive)
        for part, x, y in zip(("lmap", "rmap", "valid", "overflow"), a, b):
            chk.equal("capped_join", x, y, f"{what} row_cap={cap} {part}")
    torch.cuda.synchronize()
    log(f"  capped join {what}: probe {lkeys[0].length} x build "
        f"{rkeys[0].length} -> {total} pairs; kernel == plain at row_cap "
        f"{caps}")
    return total


def capped_join_bound(jc, lkeys, rkeys, row_cap, lalive, ralive):
    """(bytes, operations) of the capped join for this run's data: the
    alive masks, validity and the live rows' keys read once, the maps and
    the valid mask written; murmur3 of every live row on both sides."""
    def side(cols, alive):
        n = cols[0].length
        live = alive.clone()
        for c in cols:
            if c.validity is not None:
                live &= c.validity
        n_live = int(live.sum())
        width = sum(c.data.element_size() for c in cols)
        vbytes = n * (1 + sum(c.validity is not None for c in cols))
        return vbytes + n_live * width, n_live * sum(
            HASH_OPS[w] for w in jc._wide(cols))
    lb, lo = side(lkeys, lalive)
    rb, ro = side(rkeys, ralive)
    return lb + rb + 9 * row_cap + 1, lo + ro


def capped_topk_phase(torch, chk):
    """The capped TopK kernel against its plain version on kernel_bench's
    10M-row table at each limit and share of live rows, the route held
    by the launch counters; timed at k = 100 with 60% of rows live."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import topk
    from spark_rapids_tpu_torch.ops import topk_cuda as tc

    rng = np.random.default_rng(8)
    t = Table([Column.from_numpy(rng.integers(-10**6, 10**6, N_ROWS)
                                 .astype(np.int64), dt.INT64,
                                 rng.random(N_ROWS) > 0.05, device="cuda"),
               Column.from_numpy(rng.standard_normal(N_ROWS)
                                 .astype(np.float32), dt.FLOAT32,
                                 device="cuda")], ["k", "v"])
    keys, asc = ["k", "v"], [False, True]
    sms, smem_optin = tc.device_limits(torch.device("cuda"))
    routes = set()
    timing = None
    for share in CAPPED_ALIVE:
        alive = torch.from_numpy(rng.random(N_ROWS) < share).cuda()
        words = topk.n_words(topk.make_signature(t, keys, asc, 1, "capped"))
        for k in CAPPED_TOPK_LIMITS:
            want = topk.topk_capped_plain(t, keys, asc, k, alive)
            before = dict(tc.LAUNCHES)
            got = tc.topk_capped_cuda(t, keys, asc, k, alive)
            torch.cuda.synchronize()
            per_call = {n: tc.LAUNCHES[n] - before[n] for n in before}
            route = ("threshold" if topk.threshold_route(k, words,
                                                         smem_optin)
                     else "tile")
            require((per_call["threshold"] == 1) == (route == "threshold")
                    and sum(per_call.values()) >= 1,
                    f"capped topk k={k}: launches {per_call}, expected the "
                    f"{route} route")
            routes.add(route)
            what = f"capped topk 10M rows, {share:.0%} live, k={k}"
            chk.tables("capped_topk", got[0], want[0], what)
            chk.equal("capped_topk", got[1], want[1], what + " alive")
            if share == CAPPED_ALIVE[0] and k == TPCDS_LIMIT:
                kern = lambda: tc.topk_capped_cuda(            # noqa: E731
                    t, keys, asc, k, alive)
                ms, by_name = device_by_name(torch, kern, 20)
                cms = call_ms(torch, kern, 20)
                pms = time_cuda(torch, lambda: topk.topk_capped_plain(
                    t, keys, asc, k, alive), 3)
                # one torch call on the first key's word with the dead
                # rows ranked last (no tie order, no nulls, one key)
                word = torch.where(alive, t["k"].data,
                                   torch.iinfo(torch.int64).min)
                lms = call_ms(torch, lambda: torch.topk(word, k,
                                                         sorted=True), 20)
                nbytes = (sum(t[c].nbytes() for c in keys) + N_ROWS
                          + k * (1 + sum(c.data.element_size()
                                         + (c.validity is not None)
                                         for c in t.columns)))
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                timing = {"ms": ms, "by_name": by_name, "call_ms": cms,
                          "plain_ms": pms, "library_ms": lms,
                          "bytes": nbytes, "ops": 0, "bytes_ms": bytes_ms,
                          "ops_ms": 0.0, "bound_ms": bytes_ms,
                          "route": route, "launches_per_call": per_call}
                log(f"  {what}: {route} route, device {ms!r} ms "
                    f"({by_name}), one call {cms!r} ms, plain {pms!r} ms, "
                    f"torch.topk of the alive-ranked first key {lms!r} "
                    f"ms; bound {bytes_ms!r} ms ({nbytes} B)")
    require(routes == {"threshold", "tile"}, f"capped topk routes {routes}")
    log(f"capped topk: {len(CAPPED_ALIVE) * len(CAPPED_TOPK_LIMITS)} cases "
        f"at 10M rows, kernel == plain, routes {sorted(routes)}")
    return timing


def capped_phase(torch, chk):
    """The capped tier on the card: the capped join kernel against its
    plain version at the plans' own join shapes (recorded from a cold run
    of each plan) and on a 2^22-row build half dead; the capped TopK's
    cases; q3 (authored), TPC-DS q3 (optimized) and q72 (both) at 10M
    rows through `PlanExecutor(mode="capped")`, counters zeroed just
    before and read just after the counted run, each equal to the eager
    run on the card and to numpy, with its syncs counted; escalation at
    100,000 rows from tiny caps; warm walls and idle shares of the capped
    and eager TPC-DS q3 and q72."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch import nds_q3, nds_q72
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.ops import join
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.ops import select_cuda as sc
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.plan import PlanExecutor
    from spark_rapids_tpu_torch.plan.nodes import HashJoin

    out = {"plans": {}, "join_launches": {}, "topk_launches": {},
           "groupby_launches": {}}
    t0 = time.perf_counter()
    gen3 = nds_q3.datagen(N_SALES, seed=0)
    ref3 = numpy_q3(gen3)
    gen72 = nds_q72.datagen(N_SALES, seed=0)
    ref72 = numpy_q72(gen72)
    del gen3, gen72
    paths = [
        ("q3", nds_q3.q3_plan(), nds_q3.q3_inputs, False, ref3),
        ("TPC-DS q3", nds_q3.q3_tpcds_plan(), nds_q3.q3_tpcds_inputs, True,
         [r[:TPCDS_LIMIT] for r in ref3]),
        ("q72 authored", nds_q72.q72_plan(), nds_q72.q72_inputs, False,
         ref72),
        ("q72 optimized", nds_q72.q72_plan(), nds_q72.q72_inputs, True,
         ref72)]
    log(f"capped: datagen and numpy references in "
        f"{time.perf_counter() - t0:.1f} s")
    recorded = {}
    for what, plan, make_inputs, optimize, ref in paths:
        inputs = make_inputs(N_SALES, seed=0, device="cuda")
        ex = PlanExecutor(mode="capped", optimize=optimize)
        eager = PlanExecutor(optimize=optimize)
        calls, restore = recording_joins(jc)
        try:
            cold = ex.execute(plan, inputs)          # records the joins
        finally:
            restore()
        torch.cuda.synchronize()
        recorded[what] = calls
        for m in (jc, sc, tc, gc):
            m.reset_counters()
        res = ex.execute(plan, inputs)               # the counted run
        torch.cuda.synchronize()
        joins = [n for n in res.plan.nodes
                 if isinstance(n, HashJoin) and n.how == "inner"]
        launches = {"hash_join": dict(jc.LAUNCHES),
                    "hash_join_large": dict(jc.LARGE_LAUNCHES),
                    "capped_join": dict(jc.CAPPED_CALLS),
                    "topk": dict(tc.LAUNCHES),
                    "groupby": dict(gc.LAUNCHES)}
        plain = {"hash_join": dict(jc.PLAIN_CALLS),
                 "fused_select": dict(sc.PLAIN_CALLS),
                 "topk": dict(tc.PLAIN_CALLS),
                 "groupby": dict(gc.PLAIN_CALLS)}
        log(f"capped {what} at {N_SALES} rows: {res.wall_ms:.3f} ms, "
            f"{res.attempts} attempt(s), caps {res.caps}, "
            f"{res.jit_cache_hits} program cache hit(s); launches "
            f"{launches}, plain runs {plain}")
        log(res.profile_text())
        require(cold.attempts == 1 and res.attempts == 1
                and res.jit_cache_hits == 1,
                f"capped {what}: attempts {cold.attempts}/{res.attempts}, "
                f"cache hits {res.jit_cache_hits}")
        n = len(joins)
        require(launches["capped_join"]["join"] == n
                and launches["hash_join"] == {"build": n, "count": n,
                                              "emit": n},
                f"capped {what}: {n} joins, launches {launches}")
        stamps = {m.label: m.kernel for m in res.metrics.values()
                  if m.kind in ("HashJoin", "TopK")}
        require(all(k in ("cuda:hash_join", "cuda:topk")
                    for k in stamps.values()), f"capped {what}: {stamps}")
        has_topk = any(n.kind == "TopK" for n in res.plan.nodes)
        require(sum(launches["topk"].values()) >= int(has_topk)
                and (has_topk or sum(launches["topk"].values()) == 0),
                f"capped {what}: topk launches {launches['topk']}")
        require(all(v == 0 for d in plain.values() for v in d.values()),
                f"capped {what}: plain versions ran on the card {plain}")
        require_groupby(gc, res, f"capped {what}")
        got = res.compact().to("cpu")
        want = eager.execute(plan, inputs).table.to("cpu")
        chk.tables("capped_join", got, want, f"capped {what} vs eager")
        for name, r in zip(got.names, ref):
            if not np.array_equal(got[name].data.numpy(), r):
                raise AssertionError(f"capped {what} {name} differs from "
                                     "numpy")
        # the host's reads of one warm run: at most one an attempt and one
        # for the counts
        _, at = sync_warnings(torch, lambda: ex.execute(plan, inputs))
        warned = len(at)
        trace = traced_run(torch, lambda: ex.execute(plan, inputs))
        limit = trace["attempts"] + 1
        log(f"  syncs of a warm run: {warned} sync-debug warnings, at "
            f"{at}; traced: "
            f"{trace['sync_calls']} stream/device synchronize calls, "
            f"{trace['dtoh_copies']} device-to-host copies (at most "
            f"{limit} each); idle share {trace['idle_share']!r} of "
            f"{trace['wall_ms']!r} ms")
        require(warned <= limit and trace["sync_calls"] <= limit
                and trace["dtoh_copies"] <= limit,
                f"capped {what}: {warned} warnings, {trace}")
        entry = {"wall_ms": res.wall_ms, "attempts": res.attempts,
                 "caps": res.caps, "launches": launches,
                 "sync_warnings": warned, "trace": trace,
                 "profile": res.profile()}
        if what != "q3":
            capped_walls = [ex.execute(plan, inputs).wall_ms
                            for _ in range(REPEATS)]
            eager_walls = [eager.execute(plan, inputs).wall_ms
                           for _ in range(REPEATS)]
            etrace = traced_run(torch, lambda: eager.execute(plan, inputs))
            log(f"  warm walls, capped: {capped_walls}; eager: "
                f"{eager_walls}; eager idle share "
                f"{etrace['idle_share']!r} of {etrace['wall_ms']!r} ms")
            entry.update(capped_walls=capped_walls, eager_walls=eager_walls,
                         eager_trace=etrace)
        out["plans"][what] = entry
        out["join_launches"][what] = launches["capped_join"]["join"]
        out["groupby_launches"][what] = launches["groupby"]["groupby"]
        out["topk_launches"][what] = sum(launches["topk"].values())
        log(f"capped {what}: {got.num_rows} rows, equal to the eager run "
            f"and to numpy")
        del inputs, res, cold

    # the kernel at the plans' join shapes, with the masks their filters give
    t0 = time.perf_counter()
    for what, i in (("q3", 0), ("q3", 1), ("q72 optimized", 0),
                    ("q72 optimized", None)):
        calls = recorded[what]
        if i is None:                 # the inventory join: two key columns
            (args,) = [c for c in calls if len(c[0]) == 2]
            label = f"{what} inventory join"
        else:
            args = calls[i]
            label = f"{what} join {i + 1}"
        capped_join_cases(torch, chk, jc, join, *args, label)
    inv = [c for c in recorded["q72 optimized"] if len(c[0]) == 2][0]
    # a 2^22-row build, half its rows dead
    rng = np.random.default_rng(11)
    nb = jc.MAX_BUILD
    bk = Column.from_numpy(rng.permutation(nb).astype(np.int64), dt.INT64,
                           device="cuda")
    pk = Column.from_numpy(rng.integers(0, 2 * nb, 4 * 10**6)
                           .astype(np.int64), dt.INT64, device="cuda")
    ralive = torch.from_numpy(rng.random(nb) < 0.5).cuda()
    lalive = torch.ones(pk.length, dtype=torch.bool, device="cuda")
    capped_join_cases(torch, chk, jc, join, [pk], [bk], pk.length, lalive,
                      ralive, "2^22-row build, half dead")
    del recorded
    log(f"capped join: kernel == plain on every case "
        f"({time.perf_counter() - t0:.1f} s)")

    # timed at q72's inventory join
    lkeys, rkeys, row_cap, lalive, ralive = inv
    kern = lambda: jc.inner_join_capped_hash(                 # noqa: E731
        lkeys, rkeys, row_cap, lalive=lalive, ralive=ralive)
    ms, by_name = device_by_name(torch, kern, 20)
    cms = call_ms(torch, kern, 20)
    pms = time_cuda(torch, lambda: join.inner_join_capped(
        lkeys, rkeys, row_cap, lalive=lalive, ralive=ralive), 3)
    nbytes, ops = capped_join_bound(jc, lkeys, rkeys, row_cap, lalive,
                                    ralive)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT_OPS_PER_S * 1e3
    out["join_timing"] = {"ms": ms, "by_name": by_name, "call_ms": cms,
                          "plain_ms": pms, "bytes": nbytes, "ops": ops,
                          "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                          "bound_ms": max(bytes_ms, ops_ms),
                          "probe_rows": lkeys[0].length,
                          "build_rows": rkeys[0].length,
                          "row_cap": row_cap}
    log(f"  capped join at q72's inventory join (probe {lkeys[0].length}, "
        f"build {rkeys[0].length}, row_cap {row_cap}): device {ms!r} ms "
        f"({by_name}), one call {cms!r} ms, plain (sort-based) {pms!r} ms; "
        f"bound {max(bytes_ms, ops_ms)!r} ms ({nbytes} B, {ops} ops)")
    del inv, lkeys, rkeys, lalive, ralive, kern

    out["topk_timing"] = capped_topk_phase(torch, chk)

    # escalation: q3 from tiny caps
    inputs = nds_q3.q3_inputs(ESCALATION_ROWS, seed=0, device="cuda")
    plan = nds_q3.q3_plan()
    ex = PlanExecutor(mode="capped", optimize=False, caps=ESCALATION_CAPS,
                      max_cap_attempts=ESCALATION_ATTEMPTS)
    jc.reset_counters()
    res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    want = PlanExecutor(optimize=False).execute(plan, inputs).table
    chk.tables("capped_join", res.compact().to("cpu"), want.to("cpu"),
               "capped q3 escalation vs eager")
    uses_cap = {m.label: m.escalations for m in res.metrics.values()
                if m.kind in ("HashJoin", "HashAggregate")}
    others = [m.escalations for m in res.metrics.values()
              if m.kind not in ("HashJoin", "HashAggregate")]
    require(res.attempts > 1 and res.caps["row_cap"] > 128
            and res.caps["key_cap"] > 16
            and set(uses_cap.values()) == {res.attempts - 1}
            and not any(others)
            and all(v == 0 for v in jc.PLAIN_CALLS.values()),
            f"capped q3 escalation: attempts {res.attempts}, caps "
            f"{res.caps}, escalations {uses_cap}, plain {jc.PLAIN_CALLS}")
    out["escalation"] = {"rows": ESCALATION_ROWS, "start": ESCALATION_CAPS,
                         "attempts": res.attempts, "caps": res.caps,
                         "escalations": uses_cap, "wall_ms": res.wall_ms}
    log(f"capped q3 escalation at {ESCALATION_ROWS} rows from "
        f"{ESCALATION_CAPS}: {res.attempts} attempts to {res.caps}, "
        f"escalations {uses_cap}, equal to the eager run")
    return out


# ---- phase 4g: NDS q5 and q23 (Union, scalar subqueries) ----------------------

Q5_CAPS = {"key_cap": 2048}        # bench_nds_q5.py's plan-tier caps
Q23_CAPS = {"key_cap": 8192}       # bench_nds_q23.py's


def numpy_q5(gen):
    """Independent q5 over the datagen arrays: per channel the sales and
    returns rows end to end, kept where the date is in the window
    (`np.isin`), summed by entity in sorted-key order; the per-channel
    subtotals and the grand total (channel -1) of those group sums,
    ordered by channel (one row each). Returns (columns, facts)."""
    from spark_rapids_tpu_torch import nds_q5
    chans, date_sk = gen
    window = date_sk[(date_sk >= nds_q5.DATE_LO) & (date_sk < nds_q5.DATE_HI)]
    rows = []                               # (channel, four sums)
    for ci, name in enumerate(nds_q5.CHANNELS):
        c = chans[name]
        zs, zr = (np.zeros(len(c["s_sk"]), np.int64),
                  np.zeros(len(c["r_sk"]), np.int64))
        sk = np.concatenate([c["s_sk"], c["r_sk"]])
        keep = np.isin(np.concatenate([c["s_date"], c["r_date"]]), window)
        vals = [np.concatenate(p)[keep] for p in (
            (c["s_price"], zr), (zs, c["r_amt"]), (c["s_profit"], zr),
            (zs, c["r_loss"]))]
        _, inv = np.unique(sk[keep], return_inverse=True)
        group_sums = []
        for v in vals:
            g = np.zeros(inv.max() + 1 if len(inv) else 0, np.int64)
            np.add.at(g, inv, v)
            group_sums.append(g)
        rows.append((ci, [int(g.sum()) for g in group_sums]))
    total = [sum(r[1][i] for r in rows) for i in range(4)]
    rows = [(-1, total)] + rows
    return (np.array([r[0] for r in rows], np.int64),
            *(np.array([r[1][i] for r in rows], np.int64)
              for i in range(4))), {}


def numpy_q23(gen):
    """Independent q23: the frequent items (more than FREQ_THRESHOLD store
    rows), the best customers (revenue over BEST_FRACTION x the largest
    customer revenue, compared in float64), and qty x price summed over
    the catalog and web rows whose item and customer are in those sets
    (`np.isin`)."""
    from spark_rapids_tpu_torch import nds_q23
    store, sides = gen
    items, cnt = np.unique(store["item_sk"], return_counts=True)
    freq = items[cnt > nds_q23.FREQ_THRESHOLD]
    order = np.argsort(store["cust_sk"], kind="stable")
    cust = store["cust_sk"][order]
    starts = np.flatnonzero(np.r_[True, cust[1:] != cust[:-1]])
    rev = np.add.reduceat((store["qty"] * store["price"])[order], starts)
    threshold = nds_q23.BEST_FRACTION * np.float64(rev.max())
    best = cust[starts][rev.astype(np.float64) > threshold]
    total = 0
    for name in nds_q23.SIDES:
        s = sides[name]
        hit = np.isin(s["item_sk"], freq) & np.isin(s["cust_sk"], best)
        total += int((s["qty"] * s["price"])[hit].sum())
    return (np.array([total], np.int64),), {"freq_items": len(freq),
                                            "best_customers": len(best)}


def kernel_counters():
    """Every kernel module's launch and plain-run counters, as one dict."""
    from spark_rapids_tpu_torch.ops import groupby_cuda, hash_cuda
    from spark_rapids_tpu_torch.ops import join_cuda, select
    from spark_rapids_tpu_torch.ops import segment_sum_cuda, select_cuda
    from spark_rapids_tpu_torch.ops import topk, topk_cuda
    from spark_rapids_tpu_torch.parallel import partition_cuda
    return {"groupby": dict(groupby_cuda.LAUNCHES),
            "hash_join": dict(join_cuda.LAUNCHES),
            "hash_join_large": dict(join_cuda.LARGE_LAUNCHES),
            "hash_join_capped": dict(join_cuda.CAPPED_CALLS),
            "fused_select": dict(select_cuda.LAUNCHES),
            "topk": dict(topk_cuda.LAUNCHES),
            "segment_sum": dict(segment_sum_cuda.LAUNCHES),
            "row_hash": dict(hash_cuda.LAUNCHES),
            "histogram": dict(partition_cuda.LAUNCHES),
            "plain": {"groupby": dict(groupby_cuda.PLAIN_CALLS),
                      "hash_join": dict(join_cuda.PLAIN_CALLS),
                      "fused_select": dict(select.PLAIN_CALLS),
                      "topk": dict(topk.PLAIN_CALLS),
                      "segment_sum": dict(segment_sum_cuda.PLAIN_CALLS),
                      "row_hash": dict(hash_cuda.PLAIN_CALLS),
                      "histogram": dict(partition_cuda.PLAIN_CALLS)}}


def reset_kernel_counters():
    from spark_rapids_tpu_torch.ops import groupby_cuda, hash_cuda
    from spark_rapids_tpu_torch.ops import join_cuda, segment_sum_cuda
    from spark_rapids_tpu_torch.ops import select_cuda, topk_cuda
    from spark_rapids_tpu_torch.parallel import partition_cuda
    for m in (groupby_cuda, hash_cuda, join_cuda, segment_sum_cuda,
              select_cuda, topk_cuda, partition_cuda):
        m.reset_counters()


def counted(counters):
    """The sum of every launch and plain-run count."""
    return sum(counted(v) if isinstance(v, dict) else v
               for v in counters.values())


def keyed_aggregates(res):
    """The keyed HashAggregates of a run's executed plan."""
    return [n for n in res.plan.nodes
            if n.kind == "HashAggregate" and n.keys]


def require_groupby(gc, res, what):
    """Every keyed aggregate of the run on the groupby kernel: one launch
    each (counters zeroed just before the run), the plain version never,
    each stamped `cuda:groupby`."""
    keyed = keyed_aggregates(res)
    stamps = [res.metrics[n.label].kernel for n in keyed]
    require(gc.LAUNCHES["groupby"] == len(keyed)
            and gc.PLAIN_CALLS["groupby"] == 0
            and stamps == ["cuda:groupby"] * len(keyed),
            f"{what}: {len(keyed)} keyed aggregates, groupby launches "
            f"{gc.LAUNCHES}, plain {gc.PLAIN_CALLS}, stamps {stamps}")
    return len(keyed)


def nds_union_phase(torch, chk):
    """NDS q5 and q23 at scale 1 on the card: through
    `PlanExecutor(optimize=False)` and `PlanExecutor()` in the eager tier
    and `PlanExecutor(mode="capped", ...)` in both forms at the reference
    bench's key caps, every kernel counter zeroed just before each counted
    run and read just after (the groupby kernel launches once per keyed
    aggregate, every other counter reads 0, and no plain version may
    run); each result equal to an independent numpy evaluation and to the
    port's CPU run on the same arrays, bit for bit; warm walls, one traced
    warm run's idle share, the keyed aggregates' kernels in one more traced
    run (no `index_add_` or `scatter_reduce` among them), and the capped
    runs' attempts and host reads (at most attempts + 1)."""
    from spark_rapids_tpu_torch import nds_q5, nds_q23
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.plan import PlanExecutor

    # the trace check is not vacuous: a stand-in aggregate that adds with
    # index_add_ and scatter_reduce_ is caught
    class Scattering:
        @staticmethod
        def groupby_aggregate():
            seg = torch.arange(1 << 20, device="cuda") % 7
            v = torch.ones(1 << 20, device="cuda")
            torch.zeros(7, device="cuda").index_add_(0, seg, v)
            torch.zeros(7, device="cuda").scatter_reduce_(0, seg, v, "amax")
    probe = keyed_aggregate_trace(
        torch, lambda: Scattering.groupby_aggregate(), Scattering)
    log(f"keyed-aggregate trace check on a scattering stand-in: {probe}")
    require(probe["ranges"] == 1 and len(probe["scatter_ops"]) == 2
            and probe["complete"] and len(probe["scatter_kernels"]) == 2,
            f"the keyed-aggregate trace misses scatters: {probe}")
    out = {}
    for q, mod, caps, numpy_fn in (
            ("q5", nds_q5, Q5_CAPS, numpy_q5),
            ("q23", nds_q23, Q23_CAPS, numpy_q23)):
        t0 = time.perf_counter()
        gen = mod.datagen(N_SALES, seed=0)
        ref, extra = numpy_fn(gen)
        del gen
        make = getattr(mod, f"{q}_inputs")
        plan = getattr(mod, f"{q}_plan")()
        inputs_cpu = make(N_SALES, seed=0, device="cpu")
        n_rows = sum(t.num_rows for t in inputs_cpu.values())
        n_bytes = sum(t.nbytes() for t in inputs_cpu.values())
        t1 = time.perf_counter()
        cpu = PlanExecutor(device="cpu", optimize=False).execute(
            plan, inputs_cpu).table
        cpu_s = time.perf_counter() - t1
        log(f"{q}: {n_rows} input rows ({n_bytes} B), numpy reference "
            f"{extra} and the CPU run ({cpu_s:.1f} s) in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, want in zip(cpu.names, ref):
            require(np.array_equal(cpu[name].data.numpy(), want),
                    f"{q} on the CPU: {name} differs from numpy")
        inputs = {k: t.to("cuda") for k, t in inputs_cpu.items()}
        del inputs_cpu
        entry = {"input_rows": n_rows, "input_bytes": n_bytes,
                 "numpy": {n: r.tolist() for n, r in zip(cpu.names, ref)},
                 **extra, "runs": {}}
        for mode in ("eager", "capped"):
            for optimize in (False, True):
                what = (f"{q} {mode} "
                        f"{'optimized' if optimize else 'authored'}")
                ex = PlanExecutor(mode=mode, optimize=optimize,
                                  caps=dict(caps) if mode == "capped"
                                  else None)
                cold = ex.execute(plan, inputs)
                torch.cuda.synchronize()
                reset_kernel_counters()
                res = ex.execute(plan, inputs)
                torch.cuda.synchronize()
                counters = kernel_counters()
                stamps = sorted({m.kernel for m in res.metrics.values()
                                 if m.kernel})
                log(f"{what} at {n_rows} rows: {res.wall_ms:.3f} ms "
                    f"(cold {cold.wall_ms:.3f}); stamps {stamps}; "
                    f"counters {counters}")
                log(res.profile_text())
                # the groupby is the one kernel on this path: every other
                # counter reads 0
                n_keyed = require_groupby(gc, res, what)
                others = {k: v for k, v in counters.items()
                          if k != "groupby"}
                require(counted(others) == 0 and n_keyed > 0,
                        f"{what}: a kernel other than the groupby or a "
                        f"plain version ran {counters}")
                require(all(s == "cuda:groupby" or not s.startswith("cuda:")
                            for s in stamps), f"{what}: stamps {stamps}")
                got = res.compact().to("cpu")
                chk.tables("plans", got, cpu, f"{what} card vs CPU")
                for name, want in zip(got.names, ref):
                    require(np.array_equal(got[name].data.numpy(), want),
                            f"{what}: {name} differs from numpy")
                run = {"wall_ms": res.wall_ms, "cold_wall_ms": cold.wall_ms,
                       "counters": counters, "stamps": stamps,
                       "profile": res.profile()}
                if mode == "capped":
                    _, at = sync_warnings(
                        torch, lambda: ex.execute(plan, inputs))
                    run.update(attempts=res.attempts, caps=res.caps,
                               sync_warnings=len(at), sync_at=at)
                walls = [ex.execute(plan, inputs).wall_ms
                         for _ in range(REPEATS)]
                trace = traced_run(torch, lambda: ex.execute(plan, inputs))
                agg_trace = keyed_aggregate_trace(
                    torch, lambda: ex.execute(plan, inputs))
                log(f"  keyed aggregates traced: {agg_trace}")
                # the torch ops always; the kernels where CUPTI kept them
                require(agg_trace["ranges"] == n_keyed
                        and not agg_trace["scatter_ops"]
                        and (not agg_trace["kernels"] or (
                            not agg_trace["scatter_kernels"]
                            and "gb_reduce_kernel" in agg_trace["kernels"])),
                        f"{what}: a keyed aggregate scattered: {agg_trace}")
                run.update(warm_walls=walls, trace=trace,
                           keyed_aggregates=agg_trace)
                log(f"  warm walls {walls}; traced: idle share "
                    f"{trace['idle_share']!r} ({trace['busy_ms']!r} busy of "
                    f"{trace['wall_ms']!r} ms), "
                    f"{trace['sync_calls']} synchronize calls, "
                    f"{trace['dtoh_copies']} device-to-host copies")
                if mode == "capped":
                    limit = res.attempts + 1
                    log(f"  capped: {res.attempts} attempt(s), caps "
                        f"{res.caps}; host reads of a warm run: "
                        f"{len(at)} sync-debug warnings at {at}, "
                        f"{trace['sync_calls']} synchronize calls, "
                        f"{trace['dtoh_copies']} device-to-host copies (at "
                        f"most {limit} each)")
                    require(res.attempts == 1 and len(at) <= limit
                            and trace["sync_calls"] <= limit
                            and trace["dtoh_copies"] <= limit,
                            f"{what}: attempts {res.attempts}, "
                            f"{len(at)} warnings {at}, {trace}")
                entry["runs"][what] = run
                log(f"{what}: {got.num_rows} rows, equal to numpy and to "
                    f"the CPU run")
        out[q] = entry
        del inputs, cpu
        torch.cuda.empty_cache()
    return out


def summed(timing, forms, **extra):
    """One kernels-line entry: the sums over the path's calls, each form's
    own numbers under `by_form`."""
    keys = ("ms", "call_ms", "plain_ms", "bytes", "ops", "bytes_ms",
            "ops_ms", "bound_ms")
    out = {k: sum(timing[f][k] for f in forms) for k in keys}
    out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["ops_ms"]
                       else "operations")
    out.update(extra)
    out["by_form"] = {str(f): timing[f] for f in forms}
    return out


def walls_phase(torch, runs):
    """Eager walls alone, to compare two trees in one call (this script
    run from each tree's root): q3 (authored), TPC-DS q3 (optimized) and
    q72 (both) at 10M rows, one cold run each, then `runs` rounds of one
    warm run of each plan in turn; per plan every warm wall, the summed
    wall of its HashAggregates and of each other operator kind."""
    from spark_rapids_tpu_torch import nds_q3, nds_q72
    from spark_rapids_tpu_torch.plan import PlanExecutor

    q3_in = nds_q3.q3_inputs(N_SALES, seed=0, device="cuda")
    tpcds_in = nds_q3.q3_tpcds_inputs(N_SALES, seed=0, device="cuda")
    q72_in = nds_q72.q72_inputs(N_SALES, seed=0, device="cuda")
    plans = {"q3": (PlanExecutor(optimize=False), nds_q3.q3_plan(), q3_in),
             "TPC-DS q3": (PlanExecutor(), nds_q3.q3_tpcds_plan(), tpcds_in),
             "q72 authored": (PlanExecutor(optimize=False),
                              nds_q72.q72_plan(), q72_in),
             "q72 optimized": (PlanExecutor(), nds_q72.q72_plan(), q72_in)}
    out = {w: {"walls": [], "by_kind": {}} for w in plans}
    for ex, plan, inputs in plans.values():
        ex.execute(plan, inputs)
    torch.cuda.synchronize()
    for _ in range(runs):
        for what, (ex, plan, inputs) in plans.items():
            res = ex.execute(plan, inputs)
            out[what]["walls"].append(res.wall_ms)
            kinds = {}
            for m in res.metrics.values():
                kinds[m.kind] = kinds.get(m.kind, 0.0) + (m.wall_ms or 0.0)
            for k, v in kinds.items():
                out[what]["by_kind"].setdefault(k, []).append(v)
    for what, r in out.items():
        r["median_ms"] = float(np.median(r["walls"]))
        r["min_ms"] = float(np.min(r["walls"]))
        r["median_by_kind"] = {k: float(np.median(v))
                               for k, v in r["by_kind"].items()}
        log(f"{what}: median {r['median_ms']!r} ms, least "
            f"{r['min_ms']!r}; operators' medians {r['median_by_kind']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="also profile one warm q3 run with torch.profiler")
    ap.add_argument("--out", default="",
                    help="also write the measurements to this JSON file")
    ap.add_argument("--join-profile", action="store_true",
                    help="only time whole inner_join_hash calls at q3's and "
                         "TPC-DS q3's join shapes, and print them")
    ap.add_argument("--walls", type=int, default=0, metavar="N",
                    help="only time N warm eager runs of q3, TPC-DS q3 and "
                         "q72 (authored, optimized), interleaved, and print "
                         "their walls and operator walls")
    args = ap.parse_args(argv)

    import torch
    smi = device_phase(torch)
    from spark_rapids_tpu_torch import nds_q3
    if args.walls:
        # the package's own sources only: an earlier tree has other ones
        from spark_rapids_tpu_torch.ops import cuda_build
        cuda_build.build()
        print(json.dumps({"card": smi,
                          "walls": walls_phase(torch, args.walls)}),
              flush=True)
        return 0
    dadd = build_phase()
    if args.join_profile:
        tables = nds_q3.q3_inputs(N_SALES, seed=0, device="cuda")
        print(json.dumps({"card": smi, "join_profile": join_profile(
            torch, join_shapes(torch, tables))}), flush=True)
        return 0

    t0 = time.perf_counter()
    gen = nds_q3.datagen(N_SALES, seed=0)
    inputs_cpu = nds_q3.q3_inputs(N_SALES, seed=0, device="cpu")
    log(f"datagen: {N_SALES} sales rows in "
        f"{time.perf_counter() - t0:.1f} s")
    q3_tables = {k: t.to("cuda") for k, t in inputs_cpu.items()}
    chk, timing = kernel_phase(torch, q3_tables)
    del q3_tables
    res, launches, warm, traced = q3_phase(torch, inputs_cpu, gen,
                                           args.trace)
    del inputs_cpu
    tres, t_launches, twarm, ttraced = tpcds_q3_phase(torch, chk, gen,
                                                      args.trace)
    del gen
    large = large_route_phase(torch, chk)
    q72, q72_timing = q72_phase(torch, chk)
    gb = groupby_phase(torch, chk, dadd)
    c4 = c4_phase(torch, chk, gb["dadd_ms"])
    capped = capped_phase(torch, chk)
    nds_union = nds_union_phase(torch, chk)
    fs_timing = fused_select_phase(torch, chk)
    tk_timing = topk_phase(torch, chk)
    rh_launches, rh_timing, headline = row_hash_phase(torch, chk, smi)
    pt_launches, pt_timing = partition_phase(torch, chk)

    kernels = []
    for k in ("build", "count", "emit"):
        t = timing[k]
        kernels.append({
            "name": f"hash_join_{k}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k], "launches": launches[k],
            "exact": chk.max_err[k] == 0, "max_abs_err": chk.max_err[k],
            "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "bytes": t["bytes"], "ops": t["ops"], "library_ms": None,
            "tpcds_int32": timing["int32"][k]})
        if k == "emit":
            kernels[-1]["bound_with_starts_ms"] = t["bound_with_starts_ms"]
    # the large route: timed at q72's inventory join (52,000 build rows, two
    # INT64 key columns); launches over the authored and optimized q72
    for k in ("build", "count", "emit"):
        t = q72_timing[k]
        by_path = {w: r["launches"]["hash_join_large"][k]
                   for w, r in q72.items()}
        entry = {
            "name": f"hash_join_{k}_large", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[k],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "exact": chk.max_err[k + "_large"] == 0,
            "max_abs_err": chk.max_err[k + "_large"],
            "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "bytes": t["bytes"], "ops": t["ops"], "library_ms": None}
        if k == "build":
            entry.update(rounds=t["rounds"], barrier_ms=t["barrier_ms"],
                         rounds_x_barrier_ms=t["rounds_x_barrier_ms"],
                         cases=large["cases"], ceiling=large["ceiling"])
        kernels.append(entry)
    # the groupby kernel: every keyed aggregate of the plans; timed at
    # q23's two keyed aggregates (summed; the C4 float shapes beside them)
    gb_launches = {"q3": launches["groupby"],
                   "TPC-DS q3": t_launches["groupby"]["groupby"],
                   **{w: r["launches"]["groupby"]["groupby"]
                      for w, r in q72.items()},
                   **{f"capped {w}": k
                      for w, k in capped["groupby_launches"].items()},
                   **{w: r["counters"]["groupby"]["groupby"]
                      for q in nds_union.values()
                      for w, r in q["runs"].items()},
                   "C4": c4["launches"]}
    q23_forms = ("q23 count(qty) by item_sk", "q23 sum(rev) by cust_sk")
    kernels.append({
        "name": "groupby", "route": "cuda", "source": GB_SOURCE,
        "replaces": "spark_rapids_tpu/ops/aggregate.py:55 (_groupby_kernel, "
                    "the registry op groupby; an XLA lowering, no "
                    "pallas_call)",
        "launches": sum(gb_launches.values()),
        "launches_by_path": gb_launches, "cases": gb["cases"],
        "exact": chk.max_err["groupby"] == 0,
        "max_abs_err": chk.max_err["groupby"], "dadd_ms": gb["dadd_ms"],
        "library": "index_add_ into zeros on the card over the per-row "
                   "group ids (the same integers; floats in its atomics' "
                   "order)",
        **summed(gb["timing"], q23_forms, library_ms=sum(
            gb["timing"][f]["library_ms"] for f in q23_forms)),
        "c4": {f: gb["timing"][f] for f in gb["timing"]
               if f not in q23_forms}})
    # the segment sum: the groupby kernel's fold alone, timed at 10M rows
    # in 3 groups; launches are the C4 path's folds
    t = c4["timing"]
    kernels.append({
        "name": "segment_sum", "route": "cuda", "source": GB_SOURCE,
        "replaces": "none: the groupby kernel's fold, keyed float sums in "
                    "the reference's row order (ROADMAP queue C 4)",
        "launches": c4["launches"], "exact": chk.max_err["segment_sum"] == 0,
        "max_abs_err": chk.max_err["segment_sum"],
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                     else "operations"),
        "bytes": t["bytes"], "ops": t["ops"], "chain_ms": t["chain_ms"],
        "library": "index_add_ into zeros on the card: the same sums in "
                   "its atomics' order, not the reference's bits",
        "library_ms": t["library_ms"]})
    # the row hash: the sums over its three forms, one call each, at
    # bench.py's shape; launches over the row-hash and partition paths
    kernels.append({
        "name": "row_hash", "route": "cuda", "source": RH_SOURCE,
        "replaces": REPLACES["row_hash"],
        "launches": sum(rh_launches.values()) + pt_launches["murmur"],
        "launches_by_path": {"row_hash": rh_launches,
                             "partition": {"murmur": pt_launches["murmur"]}},
        "exact": chk.max_err["row_hash"] == 0,
        "max_abs_err": chk.max_err["row_hash"],
        **summed(rh_timing, ("murmur", "xxhash", "fused"), library_ms=None)})
    # the histogram: the sums over P = 8, 64 and 200, one call each
    kernels.append({
        "name": "histogram", "route": "cuda", "source": HIST_SOURCE,
        "replaces": REPLACES["histogram"],
        "launches": pt_launches["histogram"],
        "exact": chk.max_err["histogram"] == 0,
        "max_abs_err": chk.max_err["histogram"],
        **summed(pt_timing, PARTITIONS, library_ms=sum(
            pt_timing[P]["library_ms"] for P in PARTITIONS))})
    # FusedSelect: the sums over the INT32 and INT64 tables, one call each;
    # launches (count + compact) on the TPC-DS q3 path
    kernels.append({
        "name": "fused_select", "route": "cuda", "source": FS_SOURCE,
        "replaces": REPLACES["fused_select"],
        "launches": sum(t_launches["fused_select"].values()),
        "launches_by_kernel": t_launches["fused_select"],
        "exact": chk.max_err["fused_select"] == 0,
        "max_abs_err": chk.max_err["fused_select"],
        "library": "no single PyTorch call; (a < 10) & (b > 0) by torch "
                   "ops, then t[mask] per needed column",
        **summed(fs_timing, ("int32", "int64"), library_ms=sum(
            fs_timing[f]["library_ms"] for f in ("int32", "int64")))})
    # TopK: the sums over k = 50 and 100, one call each (k = 1,000, which
    # merges, beside them); launches on the TPC-DS q3 path
    kernels.append({
        "name": "topk", "route": "cuda", "source": TK_SOURCE,
        "replaces": REPLACES["topk"],
        "launches": sum(t_launches["topk"].values()),
        "launches_by_kernel": t_launches["topk"],
        "k_1000": tk_timing[TOPK_LARGE_LIMIT],
        "cases": tk_timing["cases"],
        "exact": chk.max_err["topk"] == 0,
        "max_abs_err": chk.max_err["topk"],
        "library": "torch.topk(sorted=True) over the first key's values: "
                   "no tie order, no nulls, one key",
        **summed(tk_timing, TOPK_LIMITS, library_ms=sum(
            tk_timing[k]["library_ms"] for k in TOPK_LIMITS))})
    # the capped tier's two kernels: the join timed at q72's inventory join,
    # the TopK at k = 100 over 10M rows with 60% live; launches on the
    # capped plans' counted runs
    t = capped["join_timing"]
    kernels.append({
        "name": "hash_join_capped", "route": "cuda", "source": SOURCE,
        "replaces": "spark_rapids_tpu/ops/join_pallas.py:400",
        "launches": sum(capped["join_launches"].values()),
        "launches_by_path": capped["join_launches"],
        "exact": chk.max_err["capped_join"] == 0,
        "max_abs_err": chk.max_err["capped_join"],
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                     else "operations"),
        "bytes": t["bytes"], "ops": t["ops"], "by_name": t["by_name"],
        "library_ms": None})
    t = capped["topk_timing"]
    kernels.append({
        "name": "topk_capped", "route": "cuda", "source": TK_SOURCE,
        "replaces": "spark_rapids_tpu/ops/topk_pallas.py:179",
        "launches": sum(capped["topk_launches"].values()),
        "launches_by_path": capped["topk_launches"],
        "exact": chk.max_err["capped_topk"] == 0,
        "max_abs_err": chk.max_err["capped_topk"],
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "bytes": t["bytes"], "ops": t["ops"], "by_name": t["by_name"],
        "library": "torch.topk(sorted=True) over the first key's values "
                   "with the dead rows ranked last: no tie order, no nulls, "
                   "one key",
        "library_ms": t["library_ms"]})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "n_sales": N_SALES,
                       "kernels": kernels, "join_profile": timing["join"],
                       "q3_wall_ms": res.wall_ms,
                       "q3_repeat_wall_ms": [r.wall_ms for r in warm],
                       "profile": res.profile(),
                       "repeat_profile": warm[-1].profile(),
                       "trace": traced, "row_hash_headline": headline,
                       "tpcds_q3_wall_ms": tres.wall_ms,
                       "tpcds_q3_repeat_wall_ms": [r.wall_ms
                                                   for r in twarm],
                       "tpcds_q3_profile": tres.profile(),
                       "tpcds_q3_repeat_profile": twarm[-1].profile(),
                       "tpcds_q3_optimizer": tres.optimizer,
                       "tpcds_q3_launches": t_launches,
                       "tpcds_q3_trace": ttraced,
                       "large_route": large,
                       "q72": {w: {k: v for k, v in r.items() if k != "res"}
                               for w, r in q72.items()},
                       "q72_wall_ms": {w: r["res"].wall_ms
                                       for w, r in q72.items()},
                       "q72_inventory_join": q72_timing,
                       "c4": c4, "groupby": gb, "capped": capped,
                       "nds_q5_q23": nds_union},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
