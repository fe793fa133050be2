#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace] [--out FILE]

Drives the port's paths on the card at the repo's bench scales (seed 0),
in phases that each raise on failure:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (sm_90a), one
   nvcc per source, all started together;
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
KERNEL_NAMES = {"build": "build_kernel", "count": "count_kernel",
                "emit": "emit_kernel",
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

def build_phase():
    from spark_rapids_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    secs = cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items()) or 'cached'})")
    for name in cuda_build.SOURCES:
        for line in cuda_build.compiler_report(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ---- phase 3 -----------------------------------------------------------------

class Checks:
    def __init__(self):
        self.max_err = {"build": 0, "count": 0, "emit": 0, "row_hash": 0,
                        "histogram": 0, "fused_select": 0, "topk": 0}
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
    is taken again, at most `attempts` times."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
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
        if len(us) == iters * per_call:
            return sum(us) / iters / 1e3
        log(f"  (the profiler recorded {len(us)} runs of {kernel} for "
            f"{iters} calls; profiling again)")
    raise AssertionError(f"the profiler recorded {len(us)} runs of {kernel} "
                         f"for {iters} calls of {per_call}, {attempts} times")


def device_by_name(torch, fn, iters, attempts=3):
    """Per call of `fn` (the L2 flushed before each): the mean device time
    of everything it ran on the card, kernels, copies and memsets, and of
    each kernel by name, from torch.profiler's records; the flush's own
    kernel is left out. A profile that comes back without a record of every
    call (CUPTI sometimes drops a session's records) is taken again."""
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
            by_name[short] = (ms + us / 1e3 / iters, k + 1)
        if all(k % iters == 0 for _, k in by_name.values()):
            total = sum(ms for ms, _ in by_name.values())
            return total, {name: ms for name, (ms, _) in by_name.items()}
        log(f"  (the profiler recorded {sorted(by_name.items())} for {iters} "
            f"calls; profiling again)")
    raise AssertionError(f"the profiler recorded an uneven count of device "
                         f"events for {iters} calls, {attempts} times")


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
    # 513 build rows decline to the fallback and the kernel path refuses them
    big = [Column.from_numpy(np.arange(513, dtype=np.int64), dt.INT64,
                             device="cuda")]
    ch = REGISTRY.select("hash_join",
                         jc.make_signature(p1, big, "inner", "eager"),
                         backend="cuda")
    require(ch.fallback and ("cuda", "unsupported signature") in ch.declined,
            f"a 513-row build was not declined: {ch}")
    try:
        jc.build_table_cuda(big, jc._capacity(513))
    except ValueError:
        pass
    else:
        raise AssertionError("a 513-row build ran the kernel")
    log(f"kernels: {chk.n} exact comparisons on the card in "
        f"{time.perf_counter() - t0:.1f} s; 512-row build runs, 513 declines")

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
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.plan import PlanExecutor

    plan = nds_q3.q3_plan()
    # the authored plan, as PRs 1 and 2 ran it, so its times compare
    ex = PlanExecutor(optimize=False)                 # the card
    inputs = {k: t.to("cuda") for k, t in inputs_cpu.items()}
    torch.cuda.synchronize()
    jc.reset_counters()
    res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    launches = dict(jc.LAUNCHES)
    log(f"q3 at {N_SALES} sales rows on {res.device}: "
        f"{res.wall_ms:.3f} ms, launches {launches}")
    log(res.profile_text())
    stamps = [m.kernel for m in res.metrics.values() if m.kind == "HashJoin"]
    require(stamps == ["cuda:hash_join"] * 2, f"join stamps {stamps}")
    require(launches == {"build": 2, "count": 2, "emit": 2},
            f"kernel launches on q3 {launches}")
    require(jc.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0},
            f"plain versions ran on the card path {jc.PLAIN_CALLS}")
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
    for m in (jc, sc, tc):
        m.reset_counters()
    res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    launches = {"hash_join": dict(jc.LAUNCHES),
                "fused_select": dict(sc.LAUNCHES), "topk": dict(tc.LAUNCHES)}
    plain = {"hash_join": dict(jc.PLAIN_CALLS),
             "fused_select": dict(sc.PLAIN_CALLS),
             "topk": dict(tc.PLAIN_CALLS)}
    log(f"TPC-DS q3 at {N_SALES} sales rows ({fact_bytes} B of fact "
        f"columns) on {res.device}: {res.wall_ms:.3f} ms, launches "
        f"{launches}, plain runs {plain}")
    log(res.profile_text())
    log("optimizer: " + json.dumps(res.optimizer))
    stamps = sorted(m.kernel for m in res.metrics.values() if m.kernel)
    require(stamps == ["cuda:fused_select"] * 2 + ["cuda:hash_join"] * 2
            + ["cuda:topk"], f"TPC-DS q3 stamps {stamps}")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="also profile one warm q3 run with torch.profiler")
    ap.add_argument("--out", default="",
                    help="also write the measurements to this JSON file")
    ap.add_argument("--join-profile", action="store_true",
                    help="only time whole inner_join_hash calls at q3's and "
                         "TPC-DS q3's join shapes, and print them")
    args = ap.parse_args(argv)

    import torch
    smi = device_phase(torch)
    from spark_rapids_tpu_torch import nds_q3
    build_phase()
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
                       "tpcds_q3_trace": ttraced},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
