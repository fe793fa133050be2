#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace] [--out FILE]

Drives the port's main path, NDS q3 through the eager plan engine
(`spark_rapids_tpu_torch.plan.PlanExecutor`), on the card at the repo's q3
bench scale (10,000,000 store_sales rows, seed 0), in phases that each raise
on failure:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (sm_90a);
3. kernels: each hash-join kernel (build, probe count, probe emit) against
   its plain PyTorch version on the card, for exact equality, at q3's own
   shapes and on a small dtype/null/multi-key matrix; then each is timed
   at q3's shapes: its device time from torch.profiler's kernel records,
   one wrapper call's time between CUDA events, its plain version's time,
   and its bound (the larger of the bytes this run's data needs over
   3.35 TB/s and its hash operations over 67 T/s);
4. q3: the launch counters are zeroed, q3 runs once through
   `PlanExecutor()` on the card, the counters are read; the result must
   equal an independent numpy q3 and the port's own run on the CPU, both
   joins must be stamped `cuda:hash_join` and each kernel launched twice;
5. prints one `{"kernels": [...]}` line, then as the last line
   `{"ok": true, "device": {...}}`.

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
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
# The data sheet gives no rate for 32-bit integer work outside the tensor
# cores; its float32 rate there (67 T/s) is at least that, so time counted at
# it stays a lower bound.
PEAK_OPS_PER_S = 67e12
# murmur3 integer operations per key column: mm_round is 11, the column's
# closing xor and fmix 9, and a wide key a second round plus a shift
HASH_OPS = {False: 20, True: 32}
KERNEL_NAMES = {"build": "build_kernel", "count": "probe_kernel<false>",
                "emit": "probe_kernel<true>"}
SOURCE = "spark_rapids_tpu_torch/ops/csrc/hash_join.cu"
REPLACES = {
    "build": "spark_rapids_tpu/ops/join_pallas.py:122",
    "count": "spark_rapids_tpu/ops/join_pallas.py:209",
    "emit": "spark_rapids_tpu/ops/join_pallas.py:244",
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
        self.max_err = {"build": 0, "count": 0, "emit": 0}
        self.n = 0

    def equal(self, kernel, a, b, what):
        import torch
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: shape/dtype {tuple(a.shape)} "
                                 f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
        err = (int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0)
        self.max_err[kernel] = max(self.max_err[kernel], err)
        if err:
            raise AssertionError(f"{what}: kernel differs from its plain "
                                 f"version (max abs err {err})")
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


def call_ms(torch, fn, iters):
    """Median time of one call of `fn` between its own pair of CUDA events,
    the card idle before each: the kernel plus the host's launch of it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, kernel, iters):
    """Mean device time of the kernel named `kernel` over `iters` calls of
    `fn`, from torch.profiler's records of the kernels the card ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # demangled: "void probe_kernel<false>(Keys, ...)", "build_kernel(...)"
    us = [e.time_range.elapsed_us() for e in prof.events()
          if str(e.device_type).endswith("CUDA")
          and e.name.split("(")[0].removeprefix("void ") == kernel]
    require(len(us) == iters, f"the profiler recorded {len(us)} runs of "
            f"{kernel} for {iters} calls")
    return sum(us) / iters / 1e3


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
            ops_ms = ops / PEAK_OPS_PER_S * 1e3
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "n_sales": N_SALES,
                       "kernels": kernels, "q3_wall_ms": res.wall_ms,
                       "q3_repeat_wall_ms": [r.wall_ms for r in warm],
                       "profile": res.profile(),
                       "repeat_profile": warm[-1].profile(),
                       "trace": traced}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
