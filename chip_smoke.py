#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace] [--out FILE]

Drives the port's paths on the card at the repo's bench scales (seed 0),
in phases that each raise on failure:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (sm_90a), one
   nvcc per source, all started together;
3. hash-join kernels: each (build, probe count, probe emit) against its
   plain PyTorch version on the card, for exact equality, at q3's shapes
   and on a small dtype/null/multi-key matrix; then timed at q3's shapes;
4. q3: NDS q3 at 10,000,000 store_sales rows through `PlanExecutor()`,
   launch counters zeroed before and read after; the result must equal an
   independent numpy q3 and the port's own run on the CPU;
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
larger of the bytes this run's data needs over 3.35 TB/s and its integer operations over the card's integer rate.

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
KERNEL_NAMES = {"build": "build_kernel", "count": "probe_kernel<false>",
                "emit": "probe_kernel<true>",
                "murmur": "row_hash_kernel<true,false>",
                "xxhash": "row_hash_kernel<false,true>",
                "fused": "row_hash_kernel<true,true>",
                "histogram": "hist_kernel"}
SOURCE = "spark_rapids_tpu_torch/ops/csrc/hash_join.cu"
RH_SOURCE = "spark_rapids_tpu_torch/ops/csrc/row_hash.cu"
HIST_SOURCE = "spark_rapids_tpu_torch/ops/csrc/partition_hist.cu"
REPLACES = {
    "build": "spark_rapids_tpu/ops/join_pallas.py:122",
    "count": "spark_rapids_tpu/ops/join_pallas.py:209",
    "emit": "spark_rapids_tpu/ops/join_pallas.py:244",
    "row_hash": "spark_rapids_tpu/ops/hash_pallas.py:248",
    "histogram": "spark_rapids_tpu/parallel/partition_pallas.py:33",
}


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
                        "histogram": 0}
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


def check_case(chk, jc, join, pcols, bcols, what):
    """Every kernel of one join against its plain version on the card, and
    the maps against the sort-based fallback."""
    import torch
    C = jc._capacity(bcols[0].length)
    tk = jc.build_table_cuda(bcols, C)
    tp = jc.build_table_plain(bcols, C)
    chk.equal("build", tk.slot_row, tp.slot_row, f"{what} slot_row")
    chk.equal("build", tk.slot_hash, tp.slot_hash, f"{what} slot_hash")
    ck = jc.probe_counts_cuda(pcols, tk, bcols)
    cp = jc.probe_counts_plain(pcols, tp, bcols)
    chk.equal("count", ck, cp, f"{what} counts")
    c64 = ck.to(torch.int64)
    starts = torch.cumsum(c64, 0) - c64
    total = int(c64.sum())
    lk, rk = jc.probe_emit_cuda(pcols, tk, bcols, ck, starts, total)
    lp, rp = jc.probe_emit_plain(pcols, tp, bcols, cp, starts, total)
    chk.equal("emit", lk, lp, f"{what} left map")
    chk.equal("emit", rk, rp, f"{what} right map")
    fl, fr = join.inner_join(pcols, bcols)
    chk.equal("emit", lk, fl.data, f"{what} left map vs sort-based join")
    chk.equal("emit", rk, fr.data, f"{what} right map vs sort-based join")
    torch.cuda.synchronize()
    return total


def matrix_cases(torch, dt, Column):
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


def device_ms(torch, fn, kernel, iters, attempts=3):
    """Mean device time of the kernel named `kernel` over `iters` calls of
    `fn`, the L2 flushed before each, from torch.profiler's records of the
    kernels the card ran. A profile that comes back without every run's
    record (CUPTI sometimes drops a session's records) is taken again, at
    most `attempts` times."""
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
              == kernel]
        if len(us) == iters:
            return sum(us) / iters / 1e3
        log(f"  (the profiler recorded {len(us)} runs of {kernel} for "
            f"{iters} calls; profiling again)")
    raise AssertionError(f"the profiler recorded {len(us)} runs of {kernel} "
                         f"for {iters} calls, {attempts} times")


def kernel_bounds(torch, jc, pcols, bcols, C, counts):
    """(bytes, operations) each kernel needs for this run's data: every
    input it reads once, every output written once. The count kernel reads
    the keys of valid probe rows only; the emit reads every row's count, and
    keys and start only of rows with matches. Operations are the murmur3
    hashes of the rows each kernel hashes; the chain walk is not counted."""
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
    return {
        "build": (build_in + table, nb * hash_ops),
        "count": (validity_bytes + n_valid * key_width + build_in + table
                  + 4 * n, n_valid * hash_ops),
        "emit": (4 * n + n_matched * (key_width + 8) + build_in + table
                 + 8 * total, n_matched * hash_ops),
    }


def kernel_phase(torch, q3_tables):
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import gather, join, join_cuda as jc
    from spark_rapids_tpu_torch.ops.registry import REGISTRY

    chk = Checks()
    sales, dates, items = (q3_tables[k] for k in ("sales", "dates", "items"))
    dates_f = gather.apply_boolean_mask(dates, dates["d_moy"].data == 11)
    items_f = gather.apply_boolean_mask(items,
                                        items["i_manufact"].data == 42)
    b1, b2 = [dates_f["d_date_sk"]], [items_f["i_item_sk"]]
    p1 = [sales["sold_date_sk"]]
    lmap, _ = jc.inner_join_hash(p1, b1)
    p2 = [gather.take(sales["item_sk"], lmap.data, _has_negative=False)]
    q3_shapes = [("q3 join 1", p1, b1), ("q3 join 2", p2, b2)]
    t0 = time.perf_counter()
    for what, pc, bc in q3_shapes + [
            ("10M item_sk vs 195 items", [sales["item_sk"]], b2)]:
        total = check_case(chk, jc, join, pc, bc, what)
        log(f"  {what}: probe {pc[0].length} x build {bc[0].length} -> "
            f"{total} pairs, kernels == plain")
    for what, pc, bc in matrix_cases(torch, dt, Column):
        total = check_case(chk, jc, join, pc, bc, what)
        log(f"  {what}: {total} pairs, kernels == plain")
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

    # timing at q3's shapes: the kernels against the plain versions
    timing = {k: {"ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "bytes": 0,
                  "ops": 0, "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
              for k in ("build", "count", "emit")}
    for what, pc, bc in q3_shapes:
        C = jc._capacity(bc[0].length)
        tbl = jc.build_table_cuda(bc, C)
        counts = jc.probe_counts_cuda(pc, tbl, bc)
        c64 = counts.to(torch.int64)
        starts = torch.cumsum(c64, 0) - c64
        total = int(c64.sum())
        calls = {
            "build": (lambda: jc.build_table_cuda(bc, C),
                      lambda: jc.build_table_plain(bc, C)),
            "count": (lambda: jc.probe_counts_cuda(pc, tbl, bc),
                      lambda: jc.probe_counts_plain(pc, tbl, bc)),
            "emit": (lambda: jc.probe_emit_cuda(pc, tbl, bc, counts, starts,
                                                total),
                     lambda: jc.probe_emit_plain(pc, tbl, bc, counts, starts,
                                                 total)),
        }
        bounds = kernel_bounds(torch, jc, pc, bc, C, counts)
        for k, (kern, plain) in calls.items():
            ms = device_ms(torch, kern, KERNEL_NAMES[k], 50)
            cms = call_ms(torch, kern, 50)
            pms = time_cuda(torch, plain, 5)
            nbytes, ops = bounds[k]
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_INT_OPS_PER_S * 1e3
            t = timing[k]
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
    ex = PlanExecutor()                               # the card
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
    cpu = PlanExecutor(device="cpu").execute(plan, inputs_cpu)
    log(f"q3 on the CPU for comparison: {(time.perf_counter() - t0):.1f} s")
    for a, b in zip(got.columns, cpu.table.columns):
        if not torch.equal(a.data, b.data):
            raise AssertionError("q3 on the card differs from q3 on the CPU")
    log(f"q3: {got.num_rows} groups, equal to numpy q3 and to the CPU run")
    return res, launches, warm, traced


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
    args = ap.parse_args(argv)

    import torch
    smi = device_phase(torch)
    from spark_rapids_tpu_torch import nds_q3
    build_phase()

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
    del inputs_cpu, gen
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
            "bytes": t["bytes"], "ops": t["ops"], "library_ms": None})
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "n_sales": N_SALES,
                       "kernels": kernels, "q3_wall_ms": res.wall_ms,
                       "q3_repeat_wall_ms": [r.wall_ms for r in warm],
                       "profile": res.profile(),
                       "repeat_profile": warm[-1].profile(),
                       "trace": traced, "row_hash_headline": headline},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
