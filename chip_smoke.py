#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace] [--out FILE]
    python3 chip_smoke.py --walls N    # eager plan walls only (A/B runs)
    python3 chip_smoke.py --fuzz       # the plan fuzz corpus only
    python3 chip_smoke.py --strings    # phases 5c and 9 only
    python3 chip_smoke.py --row-hash   # the fixed-width row hash only (A/B)
    python3 chip_smoke.py --keys       # phase 10 only (string/decimal keys)
    python3 chip_smoke.py --union-walls N  # q5 and q23 walls only (A/B runs)
    python3 chip_smoke.py --join-profile   # whole joins' kernels (A/B runs)
    python3 chip_smoke.py --feedback   # phase 12 only (ranges, store, graphs)
    python3 chip_smoke.py --casts      # phase 13 only (CastStrings' casts)
    python3 chip_smoke.py --uri-json-bloom  # phase 14 only
    python3 chip_smoke.py --runtime    # phase 15 only (runtime arbitration)
    python3 chip_smoke.py --parquet    # phase 16 only (Parquet, streaming)
    python3 chip_smoke.py --datetime-zorder-histogram  # phase 17 only
    python3 chip_smoke.py --distributed  # phase 18 only (the mesh)
    python3 chip_smoke.py --plan-walls N --union-walls N [--tree DIR]
    python3 chip_smoke.py --script-ab DIR [DIR ...] [--out FILE]  # stamped

Drives the port's paths on the card at the repo's bench scales (seed 0),
in phases that each raise on failure:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (sm_90a), and
   a one-thread probe of a dependent float64 add's latency, one nvcc per
   source, all started together;
3. hash-join kernels: each (build, which computes the reference's
   insertion rounds' table without rounds; existence probe, also against
   the sort-based semi join; probe count with its tile sums and offsets,
   segment lists and total; probe emit) against its plain PyTorch version
   on the card, for exact equality, the offsets and total also against
   `torch.cumsum` of the counts and the maps against the sort-based join,
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
   columns one element into their buffers, each case's rounds, existence
   probe, count and emit against theirs and the whole `inner_join_hash`
   against a numpy join, with its rounds, device and one-call time and
   bound; then 2^22 rows (the ceiling) taken and one more declined;
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
4b'''' groupby: the hash-aggregation kernels against their plain version
   on the CPU, bit for bit: every op on INT8 to TIMESTAMP_US values, with
   nulls and all-null groups, one group, all rows distinct, groups across
   tile edges, 0 to 100,003 rows, NaN payloads that tell a fold's first
   NaN from its last, eager and capped (key_cap below, at and above the
   group count, alive masks); every key kind (BOOL, INT8-64, DATE32,
   TIMESTAMP, FLOAT32/64 with both zeros, NaN payloads and infinities,
   DECIMAL128, STRING with empty strings and STRING min/max) alone and in
   three-column sets at 2,049 and 100,003 rows, eager and capped; q23's
   zipf keys at 100,003 rows and 10M; then the whole keyed aggregate timed
   at q23's two aggregates, eager and capped (key_cap 8,192), and the C4
   shapes, beside the parent's n-row sort and boundaries alone,
   `index_add_`, the plain version, the least work's bound and, for the
   fold, the chain bound from the probe. `--groupby-ab` times only the
   whole op at q23's shapes (copied into an earlier tree's root it runs
   there too, for A/B runs); `--plan-walls N` the walls, busy time and
   idle share of q3, TPC-DS q3 (INT32 and STRING), q72 and q74;
4b'''. the capped tier: the capped hash join against its plain version
   (`ops.join.inner_join_capped`), all four outputs bit for bit, at the
   join shapes and alive masks of q3's two joins, q72's 20-row hd join
   (the small route) and its inventory join (recorded from a cold capped
   run of each plan), each at the plan's row_cap, the total, the total + 1
   and half the total (overflowing), and on a 2^22-row build with half its
   rows dead (the large-route phase also holds the capped probe against
   the plain maps at row_cap = the total); the capped TopK against its
   plain version on
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
   at q72's inventory join and the capped TopK at k = 100, each by kernel
   name; queue C 8's plans (a capped inner join over a TopK of 0 rows,
   either side, and over an empty table: 0 rows);
4g. NDS q5 (20,166,666 input rows: Unions, semi joins to a date window,
   a rollup) and NDS q23 (17,500,000 rows: two shared subqueries, the
   scalar subquery `rev > 0.95 * MAX(rev)`) at scale 1 through
   `PlanExecutor(optimize=False)`, `PlanExecutor()` and both in the
   capped tier at the reference bench's key caps (2,048 and 8,192), every
   kernel counter zeroed just before each counted run and read just after:
   the groupby kernel launches once per keyed aggregate and every semi
   join runs the hash join's build and existence probe once (no count,
   emit or plain version), every other launch and every plain-run count
   reads 0 and no other stamp names a `cuda:` kernel; a traced run finds
   no scatter inside a keyed aggregate; each authored run's semi joins,
   at their own shapes, held against the sort-based mask and timed (the
   first of each beside the plain versions and `torch.isin`); each result
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
5b. DECIMAL128: the entry step (`spark_rapids_tpu_torch.entry`, the
   counterpart of `__graft_entry__.entry()`) at 4,096 and 10,000,000 rows,
   counters zeroed before and read after each run (two row-hash launches
   and one decimal launch, no plain run), its murmur3, xxhash64 and product
   equal to the numpy hashes above and v * v; the decimal kernel against
   its plain version on the card, bit for bit, on 1,000,003 rows of
   random 38-digit values with nulls and zero divisors for every op and
   branch (each call through the entry points, counted), and on a
   20,000-row sample against Python integer arithmetic written here; then
   the entry's multiply at 10M rows and a divide and a remainder on the
   matrix timed;
5c. the row hash's byte path: a customer table of 10,000,000 rows made
   with numpy (seed 0: an INT64 key, a 16-char TPC-DS id, a 0-48-byte
   email with 5% nulls and two- and three-byte UTF-8, a DECIMAL(38,2) of
   1- to 16-byte BigDecimal forms) hashed by `api.Hash` murmur3 and
   xxhash64 (seed 42), one kernel launch each, counters zeroed before and
   read after; the first 1,000,003 rows against the plain version, 10,000
   strided rows against a Python Spark hash written here (the algorithm of
   tests/spark_hash_oracle.py), STRUCT<INT32, STRING>, LIST<INT32> of 0-8
   elements and LIST<STRING> at 1,000,003 rows against the plain version,
   and Spark's golden vectors of tests/test_hash.py (strings with the
   surrogate bytes, DECIMAL128, structs, chained tables, a list) through
   `api.Hash` on the card; then timed beside the bytes bound;
6. partition: `benchmarks/bench_partition.py`'s ids (10,000,000 for P = 8
   and 64) and P = 200, Spark's default `spark.sql.shuffle.partitions`,
   through `parallel.partition_histogram`, and the shuffle chain
   murmur3 (seed 42) -> `partition_ids` -> histogram, `build_partition_map`
   and `build_partition_map_scan`; the kernel equals its plain version and
   `np.bincount`, the three counts agree and the two maps are identical,
   also on small cases for P from 1 to 13,000 (Spark's default 200 among
   them); then timed beside `torch.bincount`;
8. fuzz: the port's plan fuzz corpus (`analysis/fuzz.py`), the tier-1
   corpus sizes (seeds 0-47 over the generator's tables, 0-23 over
   `fuzz.edge_tables`' edge values and nulls), each case eager and
   capped, authored and optimized, with SPARK_RAPIDS_TORCH_VERIFY_PLANS
   on and every kernel counter zeroed just before each card run and read
   just after: each result equal to the port's CPU run bit for bit (an
   error by its class), no plain version run on the card, and
   FusedSelect, the hash join, TopK and the groupby reached (their
   launches and the corpus's wall printed); queue C6's bool x float
   predicates through the FusedSelect kernel and FusedSelect plans; the
   joins of `ops/join.py` (left, full, capped left, null_equal both ways)
   on CUDA columns at 1M x 10,000 rows against the CPU run. Alone:
   `python3 chip_smoke.py --fuzz`;
9. row conversion: `benchmarks/bench_row_conversion.py`'s tables (the
   9-kind cycle, seed 7, 1,048,576 rows: 216 columns general, 24
   fixed-width-optimized, and the 24 with 10% nulls) through
   `api.RowConversion` to rows and back, counters zeroed before and read
   after (three launches of each kernel, no plain run); each image equal
   to the plain version's byte for byte, each table read back equal to
   the plain version's and to its input, validity included; then each
   direction timed beside its bytes bound and the plain version. Alone
   with 5c: `python3 chip_smoke.py --strings`;
10. string, DECIMAL128 and float keys: the hash join's variable-width
   kernels (`hj_*_var`) against their plain versions and the sort-based
   join on both routes (edge strings: empty, a NUL byte, shared
   prefixes, multi-byte UTF-8, bytes of 0x80 and up, an all-empty chars
   buffer; DECIMAL128 at +-(10^38 - 1); floats with +-0.0 and four NaN
   payloads; two-key mixes; the capped form with alive masks); TopK with
   STRING and DECIMAL128 keys (both directions, both routes, a 97-word
   tuple declining) and FusedSelect with STRING and DECIMAL128 payloads
   against their plain versions; queue C 7's float join through
   `PlanExecutor()`; STRING and DECIMAL128 group keys and string min/max
   through the groupby kernel against the CPU run; DECIMAL128 and float
   keys in the capped tier against the eager and CPU runs, and a STRING
   key raising there; TPC-DS q3 with its STRING i_brand at 10M rows and
   q74 at 10M + 2.5M sales rows and 500,000 customers, authored and
   optimized, every kernel counter zeroed just before each counted run:
   the variable-width join launched on q74's three string joins,
   FusedSelect and TopK on the optimized forms, no plain run; each equal
   to numpy and to the CPU run at a tenth of the rows; warm walls and
   idle shares; then the three kernels' new kinds timed at q74's and
   q3's shapes and the sort's cost in q74's store aggregate. Alone:
   `python3 chip_smoke.py --keys`;
12. the plan engine's feedback loop (`feedback_phase`): q72 eager at 10M
   rows with SPARK_RAPIDS_TORCH_TRACE=1 under torch.profiler, every
   operator in its `plan.<label>` range once, the card's records linked to
   the range by their launches' correlation ids, each operator's busy ms
   printed, the result bit-equal to the untraced run; under fresh stats
   stores, q3 capped at 100,000 rows from caps of 128/16 in one executor
   (escalating) and then in a new one (one attempt, from the store's
   caps, an equal table), and TPC-DS q3 and q72 eager twice (equal, their
   decision sources printed); for q3, TPC-DS q3 INT32 and STRING, q72, q5,
   q23 and q74 each run's certificate (`PlanResult.cert`) holding the
   observed rows (`footprint.check_observed`) on both tiers where they
   run, and every operator whose certified rows tightened a cap printed;
   and q3, TPC-DS q3 INT32, q72, q5 and q23 capped run cold (kernels
   launched from Python under `set_sync_debug_mode("error")`), captured
   (into a CUDA graph, then replayed) and replayed five times, counters
   zeroed before and read after each run: every run's table bit-equal to
   the cold run's, `PlanResult.graph` True, the capture counting each
   kernel as the cold run did and a replay none (it runs no wrapper; the
   executor's `GRAPH_COUNTS` counts it), no plain version run, host reads
   at most attempts + 1; a traced replay's kernel records, linked to its
   one graph launch inside `plan.capped.attempt`, equal by name and number
   to a traced launched run's; the device memory the capture reserved;
   TPC-DS q3, q5 and q23 replayed over seed 1's tables and then seed 0's
   again, equal to a new executor's launched run; the walls (median of 5)
   and a traced run's idle share with replay and without (a new
   executor's first run, same caps); then capped fuzz corpus cases, one
   executor each, replayed over redrawn tables of the same shape, each
   run equal to a new executor's launched run;
13. the casts (`casts_phase`): CastStrings' eight methods through
   `api.CastStrings` on the card (fifteen calls: integer types, strip,
   both bases, DECIMAL32/64/128, FLOAT32/64, format digits) over an edge
   corpus (tests/torch_cast_inputs.py: empty, NUL, high-byte, blank and
   control-char strings, null rows over chars, sliced offsets, the JAX
   tests' golden vectors) and 1,048,576 random rows each, counters zeroed
   just before and read just after: one launch a parse, two a string
   format, no plain run; each result equal to the plain version on the
   card's tensors and to the CPU run, byte for byte; the ANSI errors' rows
   and strings (integer, decimal, float) equal to the CPU run's; then the
   four kernels timed at 16,777,216 rows, each beside its plain version
   over the same rows in 4,194,304-row slices (the
   upstream string->float bench's printed FLOAT32 values, made here with
   numpy; decimal and integer strings printed by the port itself) and
   string->float at 100,000,000 rows (those strings tiled). Alone:
   `python3 chip_smoke.py --casts`;
14. parse_uri, from_json and the bloom filter (`ujb_phase`): the tests'
   corpora (tests/torch_uri_json_inputs.py: the JAX tests' URI suites,
   edge and fuzzed URIs with NUL, high, control and long rows, JSON
   goldens and edge rows, INT64 values with nulls at 1, 3 and 64 longs)
   on the card against the plain versions and the CPU run, the from_json
   errors' texts; then the main path once through `api.ParseURI` (five
   methods), `api.MapUtils` and `api.BloomFilter` (create, put, probe,
   probe and merge through the wire bytes) over bench_parse_uri.py's mix
   at hit rate 50 (1,048,576 rows), 1,048,576 JSON objects of 1-8 pairs
   and bench_bloom_filter.py's 150,000,000 rows at 1 MiB, plus a 1 MiB
   filter put from the first 2,097,152 of them (half its bits set) and
   probed by all, counters zeroed just before and read just after (two
   launches a parse and a from_json, one a put and a probe, no plain run);
   its outputs, the bench's random strings and mixes at hit rates 0 and
   100, and filters of 512 KiB to 8 MiB against the plain versions (their
   slices), each filter full and half full, the half-full one probed by
   rows never put (some must miss); then each kernel timed.
   Alone: `python3 chip_smoke.py --uri-json-bloom`;
15. runtime arbitration (`runtime_phase`): `native/resource_adaptor.cpp`
   built with g++ beside the nvcc builds (its seconds printed); q23 and
   q5 at scale 1 each alone through `PlanExecutor(session=...)` under an
   unbinding `DeviceSession` (equal to numpy; the reservations'
   high-water mark printed); four task threads, two a plan, five runs
   each, one task a run, on the default `PlanExecutor(session=...)`,
   sharing one `DeviceSession` of 1.5x the larger mark with the
   arbiter's watchdog on: every result equal to its solo run, at least
   one block or retry, every thread still registered and running (none
   blocked or on the BUFN path) when all have finished their runs, no
   plain version run, each task's `getAndResetNumRetryThrow`,
   `getAndResetNumSplitRetryThrow`, `getAndResetBlockTimeNs` and
   `getAndResetComputeTimeLostToRetryNs` printed with the wall; forced
   RetryOOMs, one more than `op_retries`, and a SplitAndRetryOOM on one
   operator of q23, each leaving `execute()` and the plan rerun on the
   card with the breaker closed, equal; a `SpillPool` spilling q23's store table
   to let a reservation through, restored bit for bit; seeded fault
   injection on authored q23: 50% asserts on the hash joins (retried,
   `backoff_ms` > 0, not degraded), a fatal fault on the groupby (the
   breaker trips, the rest on the degraded CPU tier, equal), then
   `reset_device()` and a half-open probe back onto the card's kernels,
   a fault before a captured program's third run (retried onto the same
   graph) and a fatal fault in a capped attempt (degraded, no program
   left half made, captured again after the reset); and degrade
   admission at a 1 MiB budget (the whole plan on the CPU tier, equal).
   Outside the named degraded runs no plain version runs. Alone:
   `python3 chip_smoke.py --runtime`;
16. Parquet IO and the streaming scan (`parquet_phase`): the Parquet
   footer and reader's host C++ built with g++ beside the nvcc builds
   (the codec libraries it links printed; snappy is its own); NDS q5 and
   q72 at N_SALES written by tests/torch_parquet_writer.py (row groups of
   1,048,576 rows, dictionary pages, each fact table uncompressed and
   GZIP) and run through `PlanExecutor` eager and capped, authored and
   optimized, and eager optimized over the GZIP files, counters zeroed
   just before each run and read just after (a groupby launch per keyed
   aggregate, a hash-join build per join, no plain version): each result
   equal to the plan over the materialized tables on the card and to
   numpy; store_sales ordered by date under q5's window through
   `scan(parquet=...)`, whose scan_pruning skips row groups (total,
   pruned and skipped bytes printed), equal to the materialized plan and
   numpy; q5 streamed at prefetch depths 0 and 2: decode, copy and
   overlap ms, rows decoded a second, the execute wall and a traced run's
   idle share; every fixture of tests/data/torch_parquet read onto the
   card and held to its seed values. Alone:
   `python3 chip_smoke.py --parquet`;
17. time zones, the calendar rebase, Z-order and percentiles
   (`dzh_phase`): the four sources' nvcc seconds and the card's tzdata
   version; the JAX tests' cases (tests/torch_datetime_inputs.py: the
   supported zones both ways, Kiritimati's skipped day, fixed offsets,
   short ids and Spark's legacy forms, an unsupported zone raising; the
   Julian oracle and gap dates; every Z-order type and the Hilbert shapes
   with their oracles, the 2-D order, zero rows; the percentile oracle,
   the negative-count case, empty batches) on the card, each equal to
   the CPU run bit for bit and to the oracle; then the main path once
   through `api.GpuTimeZoneDB` (four zones both ways over 16,777,216
   TIMESTAMP_US rows, one TIMESTAMP_MS pass), `api.DateTimeRebase` (both
   ways over 16,777,216 DATE32 and TIMESTAMP_US rows, a fifth before
   1582-10-15, and their round trip), `api.ZOrder` (interleaveBits over 4
   INT32, 2 INT64 and 3 FLOAT64 columns, hilbertIndex at 16 x 4 and
   32 x 2) and `api.Histogram` (createHistogramIfValid over about 34M
   values, then percentileFromHistogram over the 1,048,576 histograms
   they form, both output forms), counters zeroed just before and read
   just after each call (one launch a call, none for
   createHistogramIfValid, no plain run); every output against the plain
   version on the CPU copies of its inputs in slices (every slice
   checked, on a worker thread while the kernels are timed); each kernel
   timed. Alone: `python3 chip_smoke.py --datetime-zorder-histogram`;
18. the distributed tier on logical peers of the card (`dist_phase`):
   `px_exchange_map` against its plain version (run on the CPU, where it
   runs) over P of 1, 2, 8, 64 and the kernel's most (1,365), shards of
   0, 1, 31, 32, 33 and 10,000,000 rows, uniform, one-bucket and zipf
   ids and caps that overflow, and P = 1,366 declined; the map timed at
   10M ids over 8 peers beside its plain version and
   `torch.sort(stable=True)`; `dryrun_multichip(8)` on 8 peers of the
   card and on the CPU, the same lines from both; every NDS plan (q3, TPC-DS q3, q72, q5, q23; authored and
   optimized) on meshes of 2 and 8 peers, counters zeroed just before
   each run and read just after (the exchange-map and row-hash kernels
   launched, no plain version), each result equal to the single-device
   eager run on the card and to numpy where phase 4 has an oracle, each
   exchange edge's kind and logical and wire bytes, the warm wall and
   busy ms beside the single-device wall, the largest padded relation
   and the peak device memory; the async exchange's warm walls against
   the synchronous one's on one plan; q72 from Parquet files on 4 peers
   through one pruned read a scan. Each (plan, form) runs at its
   `DIST_N` sales rows: 10M where it fits the card, else cut by its own
   padding factor (the reference's capacities double a relation's padded
   rows at every join, aggregate and sort). Alone:
   `python3 chip_smoke.py --distributed`;
11. prints one `{"kernels": [...]}` line, then as the last line
   `{"ok": true, "device": {...}}`.

The phases before phase 12 run with no stats store (`scoped_store(None)`):
their checks of attempts and caps assume a cold engine. Phase 12 installs
its own stores. `--plan-walls` and `--union-walls` run as a user runs the
port, with its default store where the tree has one, and time both the
plan's wall and the whole `execute()` call; with `--tree DIR` they import
the port from the checkout at DIR, so that one script times two trees.

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
# a template kernel's record names its arguments: "count_kernel<false,Keys>"
KERNEL_NAMES = {"build": "build_kernel<Keys>",
                "count": "count_kernel<false,Keys>",
                "emit": "emit_kernel<false,Keys>",
                "exists": "exists_kernel<false,Keys>",
                "count_large": "count_kernel<true,Keys>",
                "emit_large": "emit_kernel<true,Keys>",
                "exists_large": "exists_kernel<true,Keys>",
                "segment_sum": ("gb_fold_short_kernel",
                                "gb_fold_long_kernel"),
                "groupby": ("gb_fill_kernel", "gb_insert_kernel<0>",
                            "gb_insert_kernel<4>", "gb_insert_kernel<8>",
                            "gb_words_kernel", "gb_sort_chunks_kernel",
                            "gb_merge_kernel", "gb_rank_kernel",
                            "gb_agg_kernel<true>", "gb_agg_kernel<false>",
                            "gb_fold_short_kernel", "gb_fold_long_kernel"),
                "murmur": "row_hash_kernel<true,false>",
                "xxhash": "row_hash_kernel<false,true>",
                "fused": "row_hash_kernel<true,true>",
                "row_hash_bytes": "row_hash_bytes_kernel",
                "histogram": "hist_kernel",
                "fused_select": ("fs_count_kernel<int>",
                                 "fs_count_kernel<longlong>",
                                 "fs_compact_kernel"),
                "topk": ("tk_threshold_kernel", "tk_select_kernel",
                         "tk_merge_kernel"),
                # the DECIMAL128 and STRING forms
                "fused_select_wide": ("fs_count_kernel<int>",
                                      "fs_count_kernel<longlong>",
                                      "fs_compact_wide_kernel"),
                "topk_var": ("tk_threshold_var_kernel",
                             "tk_select_var_kernel", "tk_merge_kernel"),
                "decimal128": tuple(f"decimal_kernel<{k}>"
                                    for k in range(4))}
SOURCE = "spark_rapids_tpu_torch/ops/csrc/hash_join.cu"
RH_SOURCE = "spark_rapids_tpu_torch/ops/csrc/row_hash.cu"
HIST_SOURCE = "spark_rapids_tpu_torch/ops/csrc/partition_hist.cu"
FS_SOURCE = "spark_rapids_tpu_torch/ops/csrc/fused_select.cu"
TK_SOURCE = "spark_rapids_tpu_torch/ops/csrc/topk.cu"
GB_SOURCE = "spark_rapids_tpu_torch/ops/csrc/groupby.cu"
REPLACES = {
    "build": "spark_rapids_tpu/ops/join_pallas.py:122",
    "exists": "none: the sort-based spark_rapids_tpu/ops/join.py:337 "
              "semi_join_mask, :366 left_semi_join, :375 left_anti_join "
              "(no pallas_call)",
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
    # the host C++ (the resource arbiter of phase 15, the Parquet footer
    # and reader of phase 16), compiled with g++ beside the nvcc builds
    import threading
    from spark_rapids_tpu_torch.native import build as native_build

    def native_builds():
        NATIVE_BUILD.update(seconds=native_build.build_seconds())
        for name in ("parquet_footer", "parquet_reader"):
            NATIVE_BUILD[name] = native_build.build_seconds(name)
    native = threading.Thread(target=native_builds)
    native.start()
    secs = cuda_build.build()
    NVCC_SECONDS.update(secs)
    native.join()
    require("parquet_reader" in NATIVE_BUILD, "a g++ build of the port's "
            f"host C++ failed: {NATIVE_BUILD}")
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
                        "capped_join": 0, "capped_topk": 0, "plans": 0,
                        "decimal128": 0, "fuzz": 0, "row_hash_bytes": 0,
                        "rc_to_rows": 0, "rc_from_rows": 0, "build_var": 0,
                        "count_var": 0, "emit_var": 0, "topk_keys": 0,
                        "fused_select_keys": 0, "exists": 0,
                        "exists_large": 0, "exists_var": 0,
                        "cast_string": 0, "cast_decimal": 0,
                        "cast_string_to_float": 0, "number_to_string": 0,
                        "parse_uri": 0, "map_utils": 0, "bloom_filter": 0,
                        "timezones": 0, "datetime_rebase": 0, "zorder": 0,
                        "percentile": 0, "exchange_map": 0}
        self.n = 0

    def equal(self, kernel, a, b, what):
        import torch
        if a.dtype == torch.uint32 and b.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)   # DECIMAL128
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
            if a.offsets is not None:
                self.equal(kernel, a.offsets, b.offsets,
                           f"{what} {name} offsets")
            if (a.validity is None) != (b.validity is None):
                self.max_err[kernel] = max(self.max_err[kernel], 1)
                raise AssertionError(f"{what} {name}: validity present on "
                                     "one side only")
            if a.validity is not None:
                self.equal(kernel, a.validity, b.validity,
                           f"{what} {name} validity")


def check_case(chk, jc, join, pcols, bcols, what, suffix=""):
    """Every kernel of one join against its plain version on the card: the
    table (and the large route's rounds), the existence probe (also against
    the sort-based semi join), the counts, tile sums and offsets, segment
    sums, matched rows and lists, the total (the offsets and total also
    against torch.cumsum of the counts) and both maps (also against the
    sort-based fallback). `suffix` names the kernels' instantiation in the
    checks' records."""
    import torch
    C = jc._capacity(bcols[0].length)
    tk = jc.build_table_cuda(bcols, C)
    tp = jc.build_table_plain(bcols, C)
    chk.equal("build" + suffix, tk.slot_row, tp.slot_row, f"{what} slot_row")
    chk.equal("build" + suffix, tk.slot_hash, tp.slot_hash, f"{what} slot_hash")
    if tk.rounds is not None:                   # the large route's
        chk.equal("build" + suffix, tk.rounds, tp.rounds, f"{what} rounds")
    # the existence probe: against its plain version and the sort-based
    # semi join
    ek = jc.probe_exists_cuda(pcols, tk, bcols)
    chk.equal("exists" + suffix, ek, jc.probe_exists_plain(pcols, tp, bcols),
              f"{what} exists")
    chk.equal("exists" + suffix, ek, join.semi_join_mask(pcols, bcols),
              f"{what} exists vs sort-based semi join")
    pk = jc.probe_counts_cuda(pcols, tk, bcols)
    pp = jc.probe_counts_plain(pcols, tp, bcols)
    for name in ("counts", "tile_sums", "tile_offsets", "seg_sums",
                 "seg_matched", "total"):
        chk.equal("count" + suffix, getattr(pk, name), getattr(pp, name),
                  f"{what} {name}")
    # each segment's list of matched rows, as far as the segment has them
    at = torch.arange(pk.counts.shape[0], device=pk.counts.device)
    listed = (at % pk.seg) < pk.seg_matched.index_select(0, at // pk.seg)
    chk.equal("count" + suffix, pk.entries[listed], pp.entries[listed],
              f"{what} entries")
    c64 = pk.counts.to(torch.int64)
    incl = torch.cumsum(c64, 0)
    first = torch.arange(0, c64.shape[0], jc.TILE, device=c64.device)
    chk.equal("count" + suffix, pk.tile_offsets, (incl - c64).index_select(0, first),
              f"{what} tile offsets vs cumsum")
    chk.equal("count" + suffix, pk.total.reshape(1), incl[-1:],
              f"{what} total vs cumsum")
    total = int(pk.total)
    lk, rk = jc.probe_emit_cuda(pcols, tk, bcols, pk, total)
    lp, rp = jc.probe_emit_plain(pcols, tp, bcols, pp, total)
    chk.equal("emit" + suffix, lk, lp, f"{what} left map")
    chk.equal("emit" + suffix, rk, rp, f"{what} right map")
    fl, fr = join.inner_join(pcols, bcols)
    chk.equal("emit" + suffix, lk, fl.data, f"{what} left map vs sort-based join")
    chk.equal("emit" + suffix, rk, fr.data, f"{what} right map vs sort-based join")
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
    as long as it holds at least half of them (the log says so), else the
    phase fails."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = iters * per_call
    best = []
    # profiles with less than half the records are taken again up to
    # twice as often
    for attempt in range(2 * attempts):
        if attempt >= attempts and 2 * len(best) >= want:
            break
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
    # one call's time between CUDA events is no device time: too few
    # records is no measurement
    require(False, f"the profiler kept {len(best)} of {want} runs of "
            f"{kernel} in {2 * attempts} profiles")


def device_by_name(torch, fn, iters, attempts=3):
    """Per call of `fn` (the L2 flushed before each): the mean device time
    of everything it ran on the card, kernels, copies and memsets, and of
    each kernel by name, from torch.profiler's records; the flush's own
    kernel is left out. A profile that comes back without a record of every
    call (CUPTI sometimes drops a session's records) is taken again; if
    none is whole, each name's time is the mean of the most complete
    profile's records of it times its runs a call (the log says so); with
    no record at all the phase fails."""
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
    # empty profiles are taken again up to twice as often as partial ones
    for attempt in range(2 * attempts):
        if attempt >= attempts and best:
            break

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
        # a profile with no record (CUPTI dropped the session) is no
        # measurement of 0 ms
        if by_name and all(k % iters == 0 for _, k in by_name.values()):
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
    # one call's time between CUDA events holds the launch and the host's
    # share: it is not a device time, so no profile is no measurement
    require(False, f"the profiler recorded no device event of the call in "
            f"{2 * attempts} profiles")


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
    by kernel, and one call's time between CUDA events; then the count and
    the emit each alone, the L2 flushed before each, on one table."""
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    out = {}
    for what, pc, bc in shapes:
        call = lambda: jc.inner_join_hash(pc, bc)     # noqa: E731
        total, by_name = device_by_name(torch, call, iters)
        cms = call_ms(torch, call, iters)
        C = jc._capacity(bc[0].length)
        tbl = jc.build_table_cuda(bc, C)
        probe = jc.probe_counts_cuda(pc, tbl, bc)
        pairs = int(probe.total)
        route = "_large" if jc.is_large(C) else ""
        alone = {
            "count": device_ms(torch, lambda: jc.probe_counts_cuda(
                pc, tbl, bc), KERNEL_NAMES["count" + route], iters),
            "emit": device_ms(torch, lambda: jc.probe_emit_cuda(
                pc, tbl, bc, probe, pairs), KERNEL_NAMES["emit" + route],
                iters)}
        out[what] = {"device_ms": total, "call_ms": cms, "by_name": by_name,
                     "alone": alone}
        log(f"  {what} inner_join_hash: device {total!r} ms "
            f"({', '.join(f'{k} {v!r}' for k, v in by_name.items())}), one "
            f"call {cms!r} ms; alone: count {alone['count']!r} ms, emit "
            f"{alone['emit']!r} ms")
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
    require(launches == {"build": 2, "count": 2, "emit": 2, "exists": 0,
                         "capped": 0},
            f"kernel launches on q3 {launches}")
    require(jc.PLAIN_CALLS == {"build": 0, "count": 0, "emit": 0, "exists": 0,
                               "capped": 0},
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
                                     "merge": 0, "final": 0},
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
    require(pc.PLAIN_CALLS == {"histogram": 0, "exchange_map": 0},
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
        chk.equal("build_large", tk.rounds, tp.rounds, f"{what} rounds")
        rounds = int(tk.rounds)
        pk = jc.probe_counts_cuda(pc, tk, bc)
        pp = jc.probe_counts_plain(pc, tp, bc)
        for name in ("counts", "tile_sums", "tile_offsets", "seg_sums",
                     "seg_matched", "total"):
            chk.equal("count_large", getattr(pk, name), getattr(pp, name),
                      f"{what} {name}")
        ek = jc.probe_exists_cuda(pc, tk, bc)
        chk.equal("exists_large", ek, jc.probe_exists_plain(pc, tp, bc),
                  f"{what} exists")
        chk.equal("exists_large", ek, pp.counts > 0,
                  f"{what} exists vs the counts")
        at = torch.arange(pk.counts.shape[0], device=pk.counts.device)
        listed = (at % pk.seg) < pk.seg_matched.index_select(0, at // pk.seg)
        chk.equal("count_large", pk.entries[listed], pp.entries[listed],
                  f"{what} entries")
        total = int(pk.total)
        lk, rk = jc.probe_emit_cuda(pc, tk, bc, pk, total)
        lp, rp = jc.probe_emit_plain(pc, tp, bc, pp, total)
        chk.equal("emit_large", lk, lp, f"{what} left map")
        chk.equal("emit_large", rk, rp, f"{what} right map")
        # the capped probe over the same table, at row_cap = the total
        cl, cr, cv, co = jc.probe_capped_cuda(pc, tk, bc, total)
        chk.equal("capped_join", cl, lp, f"{what} capped probe left map")
        chk.equal("capped_join", cr, rp, f"{what} capped probe right map")
        require(bool(cv.all()) and not bool(co),
                f"{what}: the capped probe's valid and overflow")
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
        ms, by_name = device_by_name(torch, build, 20)
        cms = call_ms(torch, build, 20)
        nbytes, ops = large_bounds(torch, jc, pc, bc, C, pk.counts)["build"]
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S) * 1e3
        out.append({"what": what, "rows": nb, "capacity": C,
                    "rounds": rounds, "device_ms": ms, "call_ms": cms,
                    "bound_ms": bound, "by_name": by_name, "pairs": total})
        log(f"  {what}: C {C}, {rounds} rounds, {total} pairs; kernels == "
            f"plain, maps == numpy; build device {ms!r} ms ({by_name}), one "
            f"call {cms!r} ms, bound {bound!r} ms ({nbytes} B, {ops} ops)")
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
    chk.equal("build_large", tk.rounds, tp.rounds, "2^22 rows rounds")
    rounds = int(tk.rounds)
    ms, _ = device_by_name(torch, lambda: jc.build_table_cuda([keys], C), 5)
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
    # large-route joins on two streams at once: each call's build and
    # probes keep their state in its own scratch
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
        require(launches["hash_join"] == {"build": 5, "count": 5, "emit": 5,
                                          "exists": 0, "capped": 0}
                and launches["hash_join_large"] == {"build": 1, "count": 1,
                                                    "emit": 1, "exists": 0,
                                                    "capped": 0},
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
        # the build: its six kernels and its memset
        ms = (device_by_name(torch, kern, 30)[0] if k == "build" else
              device_ms(torch, kern, KERNEL_NAMES[k + "_large"], 30))
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
    timing["build"]["rounds"] = rounds
    join_ms, by_name = device_by_name(
        torch, lambda: jc.inner_join_hash(pc, bc), 20)
    log(f"  q72 inventory join: probe {pc[0].length} x build "
        f"{bc[0].length} (C {C}) -> {total} pairs; {rounds} rounds; whole "
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
            require(gc.LAUNCHES == {"groupby": 1, "fold": 1, "sort": 0}
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
            alive=None, keys=("k",)):
    """The kernels on the card against the plain version on the CPU, bit
    for bit; one entry-point call a call with rows."""
    t_gpu = t_cpu.to("cuda")
    keys = list(keys)
    before = gc.LAUNCHES["groupby"]
    if cap is None:
        want = aggregate.groupby_aggregate(t_cpu, keys, aggs)
        got = aggregate.groupby_aggregate(t_gpu, keys, aggs)
        chk.tables("groupby", got.to("cpu"), want, what)
    else:
        want = aggregate.groupby_aggregate_capped(t_cpu, keys, aggs, cap,
                                                  alive)
        got = aggregate.groupby_aggregate_capped(
            t_gpu, keys, aggs, cap, None if alive is None else alive.cuda())
        chk.tables("groupby", got[0].to("cpu"), want[0], what)
        chk.equal("groupby", got[1].cpu(), want[1], f"{what} valid")
        chk.equal("groupby", got[2].cpu(), want[2], f"{what} overflow")
    torch.cuda.synchronize()
    launched = gc.LAUNCHES["groupby"] - before
    require(launched == (1 if t_cpu.num_rows else 0)
            and gc.PLAIN_CALLS["groupby"] == 0,
            f"{what}: {launched} launches, plain {gc.PLAIN_CALLS}")


# the key kinds of the matrix (every kind `_key_operands` orders)
GB_KEY_KINDS = ("bool", "int8", "int16", "int32", "int64", "date32",
                "timestamp", "float32", "float64", "decimal128", "string")
GB_WORDS = ("", "a", "a\x00", "ab", "abcdefgh", "abcdefghi", "日本",
            "pre_12", "Z")
GB_DECS = (0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64, -2 ** 64, 7)
GB_NANS = {np.float32: (np.uint32, (0x7FC00000, 0x7F800123, 0xFFC00042)),
           np.float64: (np.uint64, (0x7FF8000000000000, 0x7FF0000000000123,
                                    0xFFF8000000000456))}


def gb_key_column(rng, kind, n, null_p, groups):
    """A key column of `kind` on the CPU with about `groups` distinct
    values (both zeros, NaN payloads and infinities among the floats,
    integer extremes, empty strings), nulls at null_p."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    valid = rng.random(n) >= null_p
    if kind in ("string", "decimal128"):
        base = list(GB_WORDS if kind == "string" else GB_DECS)
        pool = base + [(f"k{i:07d}" if kind == "string" else i * 10 ** 20)
                       for i in range(max(groups - len(base), 0))]
        idx = rng.integers(0, len(pool), n)
        return Column.from_pylist(
            [pool[i] if v else None for i, v in zip(idx, valid)],
            dt.STRING if kind == "string" else dt.decimal(38, 2),
            device="cpu")
    npt = {"bool": np.bool_, "int8": np.int8, "int16": np.int16,
           "int32": np.int32, "int64": np.int64, "date32": np.int32,
           "timestamp": np.int64, "float32": np.float32,
           "float64": np.float64}[kind]
    dtype = {"bool": dt.BOOL, "int8": dt.INT8, "int16": dt.INT16,
             "int32": dt.INT32, "int64": dt.INT64, "date32": dt.DATE32,
             "timestamp": dt.TIMESTAMP_US, "float32": dt.FLOAT32,
             "float64": dt.FLOAT64}[kind]
    if kind == "bool":
        a = rng.random(n) < 0.5
    elif npt in GB_NANS:
        ut, bits = GB_NANS[npt]
        pool = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf], npt),
                               np.array(bits, ut).view(npt),
                               np.arange(groups, dtype=npt)])
        a = pool[rng.integers(0, pool.size, n)]
    else:
        info = np.iinfo(npt)
        pool = np.concatenate([np.array([info.min, info.max], npt),
                               np.arange(groups, dtype=npt)])
        a = pool[rng.integers(0, pool.size, n)]
    return Column.from_numpy(a, dtype, None if valid.all() else valid,
                             device="cpu")


def gb_key_table(rng, keys, strings):
    """The key columns and value columns beside them (INT64 for integer
    sums and extremes, FLOAT64 for sums and means, STRING for min/max in
    the eager tier), with their aggregations."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    n = keys[0].length
    cols = list(keys) + [
        Column.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n), dt.INT64,
                          rng.random(n) >= 0.2, device="cpu"),
        Column.from_numpy(rng.standard_normal(n), dt.FLOAT64,
                          rng.random(n) >= 0.2, device="cpu")]
    names = [f"k{i}" for i in range(len(keys))] + ["v", "x"]
    aggs = [("v", "sum"), ("v", "min"), ("v", "max"), ("v", "count"),
            ("x", "sum"), ("x", "mean"), ("v", "size")]
    if strings:
        idx = rng.integers(0, len(GB_WORDS), n)
        ok = rng.random(n) >= 0.3
        cols.append(Column.from_pylist([GB_WORDS[i] if o else None
                                        for i, o in zip(idx, ok)],
                                       dt.STRING, device="cpu"))
        names.append("s")
        aggs += [("s", "min"), ("s", "max")]
    return Table(cols, names), aggs


def gb_kind_cases(torch, chk, gc, aggregate, rng):
    """Every key kind alone and two three-column key sets, at 2,049 rows
    (40 groups) and 100,003 (6,000), with nulls: eager (with STRING
    min/max), and capped for the fixed-width kinds (key_cap below and
    above the live groups, 60% of rows live); q23's zipf(1.3) skew at
    100,003 rows. -> cases run."""
    cases = 0
    sets = [[k] for k in GB_KEY_KINDS] + [["int32", "string", "float64"],
                                          ["int16", "decimal128", "float32"]]
    for kinds in sets:
        for n, groups in ((2049, 40), (100_003, 6000)):
            keys = [gb_key_column(rng, k, n, 0.2, groups) for k in kinds]
            names = [f"k{i}" for i in range(len(kinds))]
            what = f"groupby keys {'+'.join(kinds)}, {n} rows"
            t, aggs = gb_key_table(rng, keys, True)
            gb_case(torch, chk, gc, aggregate, t, aggs, what, keys=names)
            cases += 1
            if "string" in kinds:
                continue
            t, aggs = gb_key_table(rng, keys, False)
            alive = torch.from_numpy(rng.random(n) < 0.6)
            live = int(aggregate.groupby_aggregate_capped(
                t, names, [("v", "size")], n, alive)[1].sum())
            for cap in (max(live // 2, 1), live + 3):
                gb_case(torch, chk, gc, aggregate, t, aggs,
                        f"{what} capped {cap}", cap, alive, keys=names)
                cases += 1
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    keys = [Column.from_numpy((rng.zipf(1.3, 100_003) % 2000).astype(
        np.int64), dt.INT64, device="cpu")]
    t, aggs = gb_key_table(rng, keys, True)
    gb_case(torch, chk, gc, aggregate, t, aggs, "groupby zipf keys, 100003 "
            "rows", keys=["k0"])
    return cases + 1


def gb_least_bytes(table, keys, specs, G):
    """Bytes the groupby must move: each key column, value and validity
    byte read once (a STRING key's offsets and chars), every (G,) output
    written once (the key columns' rows and each aggregation's values and
    validity)."""
    total = 0
    # a column only counted is read for its validity alone
    values = {id(s.col): s.col for s in specs
              if s.col is not None and s.op != "count"}
    counted = {id(s.col): s.col for s in specs
               if s.op == "count" and id(s.col) not in values}
    for c in [table[k] for k in keys] + list(values.values()):
        total += c.data.numel() * c.data.element_size()
        if c.offsets is not None:
            total += c.offsets.numel() * 4
        if c.validity is not None:
            total += c.length
    for c in counted.values():
        total += c.length if c.validity is not None else 0
    for c in (table[k] for k in keys):
        total += G * (c.data.element_size() * (c.data.numel() // max(
            c.length, 1)) + (c.validity is not None))
    for s in specs:
        total += G * (8 + (s.op != "count" and s.op != "size"))
    return total


def gb_sorted_part(torch, table, key):
    """What the parent's design ran before its kernel, which this one no
    longer runs: the stable sort of the n rows by the key's operands, the
    run boundaries (each operand gathered through the order) and the group
    ids (its `cumsum`)."""
    from spark_rapids_tpu_torch.ops.sort import _key_operands, lex_order
    ops_ = _key_operands(table[key], True, None)
    order = lex_order(ops_)
    boundary = torch.arange(table.num_rows, device=table.device) == 0
    for o in ops_:
        s = o.index_select(0, order)
        boundary[1:] |= s[1:] != s[:-1]
    return torch.cumsum(boundary, 0) - 1


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


def gb_time(torch, chk, gc, aggregate, table, key, aggs, what, add_ms=None,
            cap=None):
    """The whole keyed aggregate timed on the card (`groupby_aggregate`,
    or the capped form at key_cap `cap` with every row live): the device
    time of everything it runs (kernels, the G-row sort, memsets, copies)
    and the groupby kernels' share, one call's time (the L2 flushed; the
    eager tier's host read of G inside it), the sorted part of the
    parent's design that this one no longer runs (the n-row sort and run
    boundaries), the plain version on the CPU (host clock), `index_add_`
    on the card over the per-row group ids (the library call; for an
    integer sum or count the same bits, checked), the least work's bound
    and, for a float sum, the chain bound."""
    specs = aggregate._agg_specs(table, aggs)
    n = table.num_rows
    if cap is None:
        op = lambda: aggregate.groupby_aggregate(       # noqa: E731
            table, [key], aggs)
    else:
        live = torch.ones(n, dtype=torch.bool, device="cuda")
        op = lambda: aggregate.groupby_aggregate_capped(  # noqa: E731
            table, [key], aggs, cap, live)[0]
    got = op()
    cpu = table.to("cpu")
    t0 = time.perf_counter()
    want = (aggregate.groupby_aggregate(cpu, [key], aggs) if cap is None else
            aggregate.groupby_aggregate_capped(
                cpu, [key], aggs, cap, torch.ones(n, dtype=torch.bool))[0])
    pms = (time.perf_counter() - t0) * 1e3
    chk.tables("groupby", got.to("cpu"), want, f"{what} whole op")
    ms, by_name = device_by_name(torch, op, 10)
    kms = sum(v for k, v in by_name.items() if k in KERNEL_NAMES["groupby"])
    cms = call_ms(torch, op, 10)
    sort_ms, _ = device_by_name(torch, lambda: gb_sorted_part(
        torch, table, key), 5)
    _, gid = torch.unique(table[key].data, return_inverse=True)
    G = int(gid.max()) + 1
    fold = any(s.op == "mean" or (s.op == "sum" and s.col.dtype.is_floating)
               for s in specs)
    (s0,) = [s for s in specs if s.op != "size"][:1] or [specs[0]]
    c = s0.col
    v = (c.null_mask.to(torch.int64) if s0.op == "count"
         else torch.where(c.null_mask, c.data.to(torch.float64 if fold
                                                 else torch.int64), 0))
    lib = lambda: torch.zeros(G, dtype=v.dtype,                # noqa: E731
                              device="cuda").index_add_(0, gid, v)
    lms = call_ms(torch, lib, 10)
    same = None
    if not fold and cap is None:
        # index_add_ over the group ids in key order (torch.unique's)
        same = bool(torch.equal(lib(), got.columns[1].data.to(torch.int64)))
        require(same, f"{what}: index_add_ on the card differs from the "
                "kernel's integer result")
    nbytes = gb_least_bytes(table, [key], specs, G if cap is None else cap)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ = n if fold else 0           # float64 adds
    ops_ms = ops_ / PEAK_F64_OPS_PER_S * 1e3
    out = {"rows": n, "groups": G, "cap": cap, "ms": ms, "kernels_ms": kms,
           "by_name": by_name, "call_ms": cms, "sorted_part_ms": sort_ms,
           "plain_ms": pms, "library_ms": lms, "library_same_bits": same,
           "bytes": nbytes, "ops": ops_, "bytes_ms": bytes_ms,
           "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms)}
    if fold:
        # the fold's own bound: its longest chain of dependent adds
        longest = int(torch.bincount(gid).max())
        out.update(longest_group=longest, dadd_ms=add_ms,
                   chain_ms=longest * add_ms)
    log(f"  groupby {what} ({n} rows, {G} groups"
        + ("" if cap is None else f", key_cap {cap}")
        + f"): whole op device {ms!r} ms (groupby kernels {kms!r}), one "
        f"call {cms!r} ms; the parent's n-row sort and boundaries alone "
        f"{sort_ms!r} ms; plain (CPU, host clock) {pms!r} ms; index_add_ "
        f"on the card {lms!r} ms (same bits: {same}); bound "
        f"{out['bound_ms']!r} ms ({nbytes} B, {ops_} adds"
        + (f", chain {out['chain_ms']!r} ms over {out['longest_group']} "
           f"rows" if fold else "") + f"); by kernel {by_name}")
    return out


def q23_aggregate_table(torch):
    """q23's store rows at N_SALES on the card: item_sk, cust_sk, qty and
    rev = qty * price, the inputs of its two keyed aggregates."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch import nds_q23
    from spark_rapids_tpu_torch.columnar import Column, Table
    store, _ = nds_q23.datagen(N_SALES, seed=0)
    return Table([Column.from_numpy(store[c], dt.INT64, device="cuda")
                  for c in ("item_sk", "cust_sk", "qty")] +
                 [Column.from_numpy(store["qty"] * store["price"], dt.INT64,
                                    device="cuda")],
                 ["item_sk", "cust_sk", "qty", "rev"])


Q23_AGGREGATES = (("q23 count(qty) by item_sk", "item_sk", [("qty", "count")]),
                  ("q23 sum(rev) by cust_sk", "cust_sk", [("rev", "sum")]))


def groupby_phase(torch, chk, dadd):
    """The groupby kernels against their plain version on the CPU, bit for
    bit: every op on eight value kinds, with and without nulls and with
    all-null groups, on one group, all rows distinct, groups across tile
    edges and 40 random groups, at 0, 1, a tile - 1, + 0 and + 1, 6,145
    and 100,003 rows, eager and capped (key_cap below, at and above the
    group count, alive masks); every key kind and two three-column key
    sets (`gb_kind_cases`); at 10M rows on q23's zipf(1.3) % 2,000 and
    zipf(1.2) % 5,000 keys, eager and capped; then the whole op timed at
    q23's two keyed aggregates, eager and capped (key_cap 8,192), and the
    C4 shapes."""
    from spark_rapids_tpu_torch import dtypes as dt
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
    kinds = gb_kind_cases(torch, chk, gc, aggregate, rng)
    n_cases += kinds
    log(f"groupby: {n_cases} small cases equal the plain version, "
        f"{kinds} of them over the key kinds "
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

    # timed: q23's two keyed aggregates over its 10M store rows, eager and
    # capped at the plan's key_cap
    q23 = q23_aggregate_table(torch)
    add_ms = dadd_latency_ms(torch, dadd)
    log(f"  one dependent float64 add: {add_ms * 1e6!r} ns "
        f"({GB_DADD_ROUNDS} in one thread)")
    timing = {}
    for what, key, aggs in Q23_AGGREGATES:
        timing[what] = gb_time(torch, chk, gc, aggregate, q23, key, aggs,
                               what)
        timing[f"{what}, capped"] = gb_time(
            torch, chk, gc, aggregate, q23, key, aggs, f"{what}, capped",
            cap=Q23_CAPS["key_cap"])
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


def groupby_ab_phase(torch, iters=10):
    """q23's two keyed aggregates alone, eager and capped (key_cap 8,192,
    every row live), and two shapes with many groups (4M rows in 1M
    groups; 10M all-distinct rows), the whole op's device time and one
    call's, to compare two trees in one call (this script run from each
    tree's root: it calls only `groupby_aggregate` and its capped
    form)."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import aggregate
    q23 = q23_aggregate_table(torch)
    rng = np.random.default_rng(1)

    def keyed(keys):
        return Table([Column.from_numpy(keys, dt.INT64, device="cuda"),
                      Column.from_numpy(rng.integers(-100, 100, keys.size),
                                        dt.INT64, device="cuda")],
                     ["k", "v"])
    shapes = [(what, q23, key, aggs) for what, key, aggs in Q23_AGGREGATES]
    shapes += [("sum(v) by k, 4M rows in 1M groups",
                keyed(rng.integers(0, 1_000_000, 4_000_000)), "k",
                [("v", "sum")]),
               ("sum(v) by k, 10M distinct rows",
                keyed(rng.permutation(N_SALES)), "k", [("v", "sum")])]
    out = {}
    for what, t, key, aggs in shapes:
        live = torch.ones(t.num_rows, dtype=torch.bool, device="cuda")
        for cap in (None, Q23_CAPS["key_cap"]):
            form = what + ("" if cap is None else ", capped")
            if cap is None:
                op = lambda: aggregate.groupby_aggregate(  # noqa: E731
                    t, [key], aggs)
            else:
                op = lambda: aggregate.groupby_aggregate_capped(  # noqa
                    t, [key], aggs, cap, live)
            ms, by_name = device_by_name(torch, op, iters)
            out[form] = {"device_ms": ms, "call_ms": call_ms(torch, op,
                                                             iters),
                         "by_name": by_name}
            log(f"{form}: whole op device {ms!r} ms, one call "
                f"{out[form]['call_ms']!r} ms")
    return out


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
    ms, by_name = device_by_name(torch, lambda: jc.inner_join_capped_hash(
        lkeys, rkeys, row_cap, lalive=lalive, ralive=ralive), 5)
    log(f"  capped join {what}: probe {lkeys[0].length} x build "
        f"{rkeys[0].length} -> {total} pairs; kernel == plain at row_cap "
        f"{caps}; device {ms!r} ms at row_cap {row_cap} ({by_name})")
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


def capped_topk_inputs():
    """kernel_bench's 10M-row TopK table on the card (INT64 `k` with 5%
    nulls, FLOAT32 `v`), its keys and directions, and the generator that
    then draws the alive masks."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    rng = np.random.default_rng(8)
    t = Table([Column.from_numpy(rng.integers(-10**6, 10**6, N_ROWS)
                                 .astype(np.int64), dt.INT64,
                                 rng.random(N_ROWS) > 0.05, device="cuda"),
               Column.from_numpy(rng.standard_normal(N_ROWS)
                                 .astype(np.float32), dt.FLOAT32,
                                 device="cuda")], ["k", "v"])
    return t, ["k", "v"], [False, True], rng


def capped_topk_phase(torch, chk):
    """The capped TopK kernel against its plain version on kernel_bench's
    10M-row table at each limit and share of live rows, the route held
    by the launch counters; timed at k = 100 with 60% of rows live."""
    from spark_rapids_tpu_torch.ops import topk
    from spark_rapids_tpu_torch.ops import topk_cuda as tc

    t, keys, asc, rng = capped_topk_inputs()
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
    and eager TPC-DS q3 and q72; queue C 8's plans (`c8_plans`)."""
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
                    "capped_join": {"join": jc.LAUNCHES["capped"]},
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
        # a capped join is the build and the capped probe: no count, no
        # emit
        require(launches["capped_join"]["join"] == n
                and launches["hash_join"] == {"build": n, "count": 0,
                                              "emit": 0, "exists": 0,
                                              "capped": n},
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
    out["c8"] = c8_plans(torch)
    return out


def c8_plans(torch):
    """Queue C 8 on the card: a capped inner join over the zero-row frame
    of a TopK of 0 rows (Sort + Limit(0), optimized), the TopK on either
    side, and over an empty input table: 0 rows, no plain version run."""
    from spark_rapids_tpu_torch import table_from_numpy
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor

    def inputs(nl):
        k = np.array([0, 1, 2, 0, 1], np.int64)[:nl]
        return {"l": table_from_numpy(["k", "v"], [k, np.arange(
                    nl, dtype=np.int64)], [None, None], ["int64", "int64"],
                    device="cuda"),
                "r": table_from_numpy(["rk", "w"], [np.array(
                    [0, 1, 2, 0], np.int64), np.arange(4, dtype=np.int64)],
                    [None, None], ["int64", "int64"], device="cuda")}
    out = {}
    for side in ("topk left", "topk right", "empty left"):
        b = PlanBuilder()
        left = b.scan("l", schema=["k", "v"])
        if side != "empty left":
            left = left.sort(["v"]).limit(0)
        right = b.scan("r", schema=["rk", "w"])
        plan = (right.join(left, left_on="rk", right_on="k")
                if side == "topk right"
                else left.join(right, left_on="k", right_on="rk")).build()
        jc.reset_counters()
        tc.reset_counters()
        res = PlanExecutor(mode="capped").execute(
            plan, inputs(0 if side == "empty left" else 5))
        got = res.compact()
        torch.cuda.synchronize()
        kinds = [n.kind for n in res.plan.nodes]
        plain = sum(jc.PLAIN_CALLS.values()) + sum(tc.PLAIN_CALLS.values())
        require(got.num_rows == 0 and plain == 0
                and (side == "empty left" or "TopK" in kinds),
                f"C8 {side}: {got.num_rows} rows, nodes {kinds}, plain "
                f"runs {plain}")
        out[side] = {"rows": got.num_rows, "nodes": kinds}
    log(f"C8 on the card: {out}, 0 rows each")
    return out


def capped_kernels_phase(torch):
    """The capped tier's two kernels alone, to compare two trees in one
    call (this script run from each tree's root): the capped join at q3's
    two joins and q72's inventory join (their arguments recorded from a
    cold capped run of each plan) and the capped TopK at k = 50, 100 and
    4,099 over kernel_bench's 10M-row table with 60% of rows live: device
    ms by kernel name and one call's ms, the L2 flushed."""
    from spark_rapids_tpu_torch import nds_q3, nds_q72
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.plan import PlanExecutor
    out = {}

    def timed(label, fn, extra):
        ms, by_name = device_by_name(torch, fn, 20)
        cms = call_ms(torch, fn, 20)
        out[label] = {"ms": ms, "by_name": by_name, "call_ms": cms, **extra}
        log(f"  {label}: device {ms!r} ms ({by_name}), one call {cms!r} ms")

    for what, plan, make, optimize in (
            ("q3", nds_q3.q3_plan(), nds_q3.q3_inputs, False),
            ("q72", nds_q72.q72_plan(), nds_q72.q72_inputs, True)):
        inputs = make(N_SALES, seed=0, device="cuda")
        calls, restore = recording_joins(jc)
        try:
            PlanExecutor(mode="capped", optimize=optimize).execute(plan,
                                                                   inputs)
        finally:
            restore()
        torch.cuda.synchronize()
        chosen = ([("capped q3 join 1", calls[0]),
                   ("capped q3 join 2", calls[1])] if what == "q3" else
                  [("capped q72 inventory join",
                    next(c for c in calls if len(c[0]) == 2))])
        for label, (lk, rk, cap, la, ra) in chosen:
            timed(label, lambda: jc.inner_join_capped_hash(
                lk, rk, cap, lalive=la, ralive=ra),
                {"probe_rows": lk[0].length, "build_rows": rk[0].length,
                 "row_cap": cap})
        del inputs, calls
    t, keys, asc, rng = capped_topk_inputs()
    alive = torch.from_numpy(rng.random(N_ROWS) < CAPPED_ALIVE[0]).cuda()
    for k in CAPPED_TOPK_LIMITS:
        timed(f"capped topk k={k}", lambda: tc.topk_capped_cuda(
            t, keys, asc, k, alive), {"rows": N_ROWS, "live": 0.6})
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
    from spark_rapids_tpu_torch.ops import decimal_cuda, groupby_cuda
    from spark_rapids_tpu_torch.ops import hash_cuda, join_cuda, select
    from spark_rapids_tpu_torch.ops import segment_sum_cuda, select_cuda
    from spark_rapids_tpu_torch.ops import row_conversion_cuda
    from spark_rapids_tpu_torch.ops import cast_cuda, topk, topk_cuda
    from spark_rapids_tpu_torch.ops import (bloom_filter_cuda, map_utils_cuda,
                                            parse_uri_cuda)
    from spark_rapids_tpu_torch.ops import (datetime_rebase_cuda,
                                            histogram_cuda, timezones_cuda,
                                            zorder_cuda)
    from spark_rapids_tpu_torch.parallel import partition_cuda
    return {"groupby": dict(groupby_cuda.LAUNCHES),
            "hash_join": dict(join_cuda.LAUNCHES),
            "hash_join_large": dict(join_cuda.LARGE_LAUNCHES),
            "hash_join_var": dict(join_cuda.VAR_LAUNCHES),
            "hash_join_capped": {"join": join_cuda.LAUNCHES["capped"]},
            "fused_select": dict(select_cuda.LAUNCHES),
            "fused_select_strings": dict(select_cuda.STRING_LAUNCHES),
            "topk": dict(topk_cuda.LAUNCHES),
            "topk_strings": dict(topk_cuda.STRING_LAUNCHES),
            "segment_sum": dict(segment_sum_cuda.LAUNCHES),
            "row_hash": dict(hash_cuda.LAUNCHES),
            "histogram": dict(partition_cuda.LAUNCHES),
            "decimal128": dict(decimal_cuda.LAUNCHES),
            "row_conversion": dict(row_conversion_cuda.LAUNCHES),
            "casts": dict((k, v) for k, v in cast_cuda.LAUNCHES.items()
                          if v),
            "parse_uri": dict(parse_uri_cuda.LAUNCHES),
            "map_utils": dict(map_utils_cuda.LAUNCHES),
            "bloom_filter": dict(bloom_filter_cuda.LAUNCHES),
            "timezones": dict(timezones_cuda.LAUNCHES),
            "datetime_rebase": dict(datetime_rebase_cuda.LAUNCHES),
            "zorder": dict(zorder_cuda.LAUNCHES),
            "percentile": dict(histogram_cuda.LAUNCHES),
            "plain": {"groupby": dict(groupby_cuda.PLAIN_CALLS),
                      "hash_join": dict(join_cuda.PLAIN_CALLS),
                      "fused_select": dict(select.PLAIN_CALLS),
                      "topk": dict(topk.PLAIN_CALLS),
                      "segment_sum": dict(segment_sum_cuda.PLAIN_CALLS),
                      "row_hash": dict(hash_cuda.PLAIN_CALLS),
                      "histogram": dict(partition_cuda.PLAIN_CALLS),
                      "decimal128": dict(decimal_cuda.PLAIN_CALLS),
                      "row_conversion": dict(
                          row_conversion_cuda.PLAIN_CALLS),
                      "casts": dict(cast_cuda.PLAIN_CALLS),
                      "parse_uri": dict(parse_uri_cuda.PLAIN_CALLS),
                      "map_utils": dict(map_utils_cuda.PLAIN_CALLS),
                      "bloom_filter": dict(bloom_filter_cuda.PLAIN_CALLS),
                      "timezones": dict(timezones_cuda.PLAIN_CALLS),
                      "datetime_rebase": dict(
                          datetime_rebase_cuda.PLAIN_CALLS),
                      "zorder": dict(zorder_cuda.PLAIN_CALLS),
                      "percentile": dict(histogram_cuda.PLAIN_CALLS)}}


def reset_kernel_counters():
    from spark_rapids_tpu_torch.ops import decimal_cuda, groupby_cuda
    from spark_rapids_tpu_torch.ops import hash_cuda, join_cuda
    from spark_rapids_tpu_torch.ops import segment_sum_cuda, select_cuda
    from spark_rapids_tpu_torch.ops import row_conversion_cuda, topk_cuda
    from spark_rapids_tpu_torch.ops import cast_cuda
    from spark_rapids_tpu_torch.ops import (bloom_filter_cuda, map_utils_cuda,
                                            parse_uri_cuda)
    from spark_rapids_tpu_torch.ops import (datetime_rebase_cuda,
                                            histogram_cuda, timezones_cuda,
                                            zorder_cuda)
    from spark_rapids_tpu_torch.parallel import partition_cuda
    for m in (groupby_cuda, hash_cuda, join_cuda, segment_sum_cuda,
              select_cuda, topk_cuda, partition_cuda, decimal_cuda,
              row_conversion_cuda, cast_cuda, parse_uri_cuda, map_utils_cuda,
              bloom_filter_cuda, timezones_cuda, datetime_rebase_cuda,
              zorder_cuda, histogram_cuda):
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


def require_semi_joins(res, counters, what):
    """Every HashJoin of the run (q5's and q23's are semi joins) on the
    hash join's build and existence probe: one launch of each a join
    (counters zeroed just before the run), no count or emit, no plain
    version, each stamped `cuda:hash_join`; returns their number."""
    semis = [n for n in res.plan.nodes if n.kind == "HashJoin"]
    stamps = [res.metrics[n.label].kernel for n in semis]
    k = len(semis)
    require(k > 0 and all(n.how in ("left_semi", "left_anti")
                          for n in semis)
            and counters["hash_join"] == {"build": k, "count": 0,
                                          "emit": 0, "exists": k, "capped": 0}
            and counters["hash_join_large"]["build"]
            == counters["hash_join_large"]["exists"]
            and counted(counters["plain"]["hash_join"]) == 0
            and stamps == ["cuda:hash_join"] * k,
            f"{what}: {k} semi joins, hash-join launches "
            f"{counters['hash_join']}, large {counters['hash_join_large']}, "
            f"plain {counters['plain']['hash_join']}, stamps {stamps}")
    return k


def recording_semis(jc):
    """Wrap `join_cuda.semi_join_mask_hash` (the executor's semi and anti
    joins reach it in both tiers) so that a run records every call's
    arguments; returns (calls, restore)."""
    calls = []
    real = jc.semi_join_mask_hash

    def rec(lkeys, rkeys, *, lalive=None, ralive=None):
        calls.append((list(lkeys), list(rkeys), lalive, ralive))
        return real(lkeys, rkeys, lalive=lalive, ralive=ralive)

    jc.semi_join_mask_hash = rec

    def restore():
        jc.semi_join_mask_hash = real
    return calls, restore


def semi_timing(torch, chk, jc, lkeys, rkeys, lalive, ralive, what,
                full=False):
    """One semi join of a plan at its own shape: the build and the
    existence probe against their plain versions and the sort-based mask,
    then timed: the build's device ms (its kernels and memset), the
    probe's device ms, one whole `semi_join_mask_hash` call, and their
    bounds (bytes: the build reads its keys and validity and writes the
    8-byte table; the probe reads its validity, its live rows' keys, the
    build keys and the table and writes a byte a row; operations: their
    rows' murmur3); with `full`, also the plain versions and `torch.isin`
    on the first key (the same mask where no key is null and every row
    live)."""
    from spark_rapids_tpu_torch.ops import join
    lcols = jc._with_alive(lkeys, lalive)
    rcols = jc._with_alive(rkeys, ralive)
    nl, nr = lcols[0].length, rcols[0].length
    C = jc._capacity(nr)
    table = jc.build_table_cuda(rcols, C)
    want = join.semi_join_mask(lkeys, rkeys, lalive=lalive, ralive=ralive)
    suffix = "_large" if jc.is_large(C) else ""
    chk.equal("exists" + suffix, jc.semi_join_mask_hash(
        lkeys, rkeys, lalive=lalive, ralive=ralive), want,
        f"{what} mask vs sort-based")
    chk.equal("exists" + suffix, jc.probe_exists_cuda(lcols, table, rcols),
              jc.probe_exists_plain(lcols, table, rcols),
              f"{what} exists vs plain")

    def live(cols):
        v = torch.ones(cols[0].length, dtype=torch.bool, device="cuda")
        for c in cols:
            if c.validity is not None:
                v &= c.validity
        return int(v.sum())
    width = sum(c.data.element_size() for c in lcols)
    hash_ops = sum(HASH_OPS[w] for w in jc._wide(lcols))
    vbytes = sum(c.length for c in lcols if c.validity is not None)
    build_in = sum(c.nbytes() for c in rcols)
    bounds = {"build": (build_in + 8 * C, live(rcols) * hash_ops),
              "exists": (vbytes + live(lcols) * width + build_in + 8 * C
                         + nl, live(lcols) * hash_ops)}
    build = lambda: jc.build_table_cuda(rcols, C)             # noqa: E731
    probe = lambda: jc.probe_exists_cuda(lcols, table, rcols)  # noqa: E731
    name = KERNEL_NAMES["exists" + suffix]
    out = {"probe_rows": nl, "build_rows": nr, "capacity": C,
           "large": jc.is_large(C), "matched": int(want.sum()),
           "build_ms": (device_by_name(torch, build, 20)[0] if suffix
                        else device_ms(torch, build, KERNEL_NAMES["build"],
                                       20)),
           "ms": device_ms(torch, probe, name, 20),
           "call_ms": call_ms(torch, lambda: jc.semi_join_mask_hash(
               lkeys, rkeys, lalive=lalive, ralive=ralive), 20)}
    for k, (nbytes, ops) in bounds.items():
        out[k + "_bytes"], out[k + "_ops"] = nbytes, ops
        out[k + "_bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[k + "_ops_ms"] = ops / PEAK_INT_OPS_PER_S * 1e3
        out[k + "_bound_ms"] = max(out[k + "_bytes_ms"], out[k + "_ops_ms"])
    if full:
        out["plain_ms"] = time_cuda(
            torch, lambda: jc.probe_exists_plain(lcols, table, rcols), 2)
        out["plain_build_ms"] = time_cuda(
            torch, lambda: jc.build_table_plain(rcols, C), 2)
        lk, rk = lkeys[0].data, rkeys[0].data
        out["library_ms"] = call_ms(torch, lambda: torch.isin(lk, rk), 20)
    log(f"  {what}: {nl} x {nr} rows (C {C}), {out['matched']} matched; "
        f"mask == sort-based, exists == plain; build {out['build_ms']!r} "
        f"ms (bound {out['build_bound_ms']!r}), exists {out['ms']!r} ms "
        f"(bound {out['exists_bound_ms']!r}), one call {out['call_ms']!r} "
        f"ms" + (f", plain {out['plain_ms']!r} ms, torch.isin "
                 f"{out['library_ms']!r} ms" if full else ""))
    return out


def nds_union_phase(torch, chk):
    """NDS q5 and q23 at scale 1 on the card: through
    `PlanExecutor(optimize=False)` and `PlanExecutor()` in the eager tier
    and `PlanExecutor(mode="capped", ...)` in both forms at the reference
    bench's key caps, every kernel counter zeroed just before each counted
    run and read just after (the groupby kernel launches once per keyed
    aggregate, every semi join runs the hash join's build and existence
    probe once, every other counter reads 0, and no plain version may
    run); each result equal to an independent numpy evaluation and to the
    port's CPU run on the same arrays, bit for bit; warm walls, one traced
    warm run's idle share, the keyed aggregates' kernels in one more traced
    run (no `index_add_` or `scatter_reduce` among them), the capped
    runs' attempts and host reads (at most attempts + 1), and each authored
    run's semi joins checked and timed at their shapes (`semi_timing`)."""
    from spark_rapids_tpu_torch import nds_q5, nds_q23
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.ops import join_cuda as jc
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
                def make():
                    return PlanExecutor(mode=mode, optimize=optimize,
                                        caps=dict(caps) if mode == "capped"
                                        else None)

                def launched():
                    # a run whose kernels launch from Python, where the
                    # wrappers below can see them: a new executor's (an
                    # executor's later capped runs replay a CUDA graph)
                    return make().execute(plan, inputs)
                ex = make()
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
                # the groupby and the semi joins' build and existence
                # probe are the kernels on this path: every other counter
                # reads 0
                n_keyed = require_groupby(gc, res, what)
                n_semi = require_semi_joins(res, counters, what)
                others = {k: v for k, v in counters.items()
                          if k not in ("groupby", "hash_join",
                                       "hash_join_large")}
                require(counted(others) == 0 and n_keyed > 0,
                        f"{what}: another kernel or a plain version ran "
                        f"{counters}")
                require(all(s in ("cuda:groupby", "cuda:hash_join")
                            or not s.startswith("cuda:") for s in stamps),
                        f"{what}: stamps {stamps}")
                got = res.compact().to("cpu")
                chk.tables("plans", got, cpu, f"{what} card vs CPU")
                for name, want in zip(got.names, ref):
                    require(np.array_equal(got[name].data.numpy(), want),
                            f"{what}: {name} differs from numpy")
                run = {"wall_ms": res.wall_ms, "cold_wall_ms": cold.wall_ms,
                       "counters": counters, "stamps": stamps,
                       "semi_joins": n_semi, "profile": res.profile()}
                if not optimize:
                    # the semi joins' shapes, recorded from one more run,
                    # their kernels timed there
                    calls, restore = recording_semis(jc)
                    try:
                        launched()
                    finally:
                        restore()
                    run["semi_timing"] = [
                        semi_timing(torch, chk, jc, *c,
                                    f"{what} semi join {i + 1}",
                                    full=i == 0)
                        for i, c in enumerate(calls)]
                if mode == "capped":
                    _, at = sync_warnings(
                        torch, lambda: ex.execute(plan, inputs))
                    run.update(attempts=res.attempts, caps=res.caps,
                               sync_warnings=len(at), sync_at=at)
                walls = [ex.execute(plan, inputs).wall_ms
                         for _ in range(REPEATS)]
                trace = traced_run(torch, lambda: ex.execute(plan, inputs))
                agg_trace = keyed_aggregate_trace(torch, launched)
                log(f"  keyed aggregates traced: {agg_trace}")
                # the torch ops always; the kernels where CUPTI kept them
                require(agg_trace["ranges"] == n_keyed
                        and not agg_trace["scatter_ops"]
                        and (not agg_trace["kernels"] or (
                            not agg_trace["scatter_kernels"]
                            and any(k.startswith("gb_insert_kernel")
                                    for k in agg_trace["kernels"])
                            and any(k in agg_trace["kernels"] for k in (
                                "gb_agg_kernel<true>",
                                "gb_agg_kernel<false>")))),
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


# ---- phase 5b: DECIMAL128 ------------------------------------------------------

DEC_SOURCE = "spark_rapids_tpu_torch/ops/csrc/decimal128.cu"
DEC_MATRIX_ROWS = 1_000_003
DEC_SAMPLE_ROWS = 20_000
DEC_ENTRY_SIZES = (4096, N_ROWS)
# (op, a scale, b scale, output scale, flag): every branch of the kernel
# (divide's three n_shift_exp branches, the remainder's d_shift_exp ones,
# the SPARK-40129 interim rounding, the integer divide)
DEC_CASES = (
    ("add", 2, 2, 2, False), ("add", 2, 5, 5, False), ("add", 10, 3, 6, False),
    ("add", 0, 38, 38, False), ("sub", 2, 5, 3, True),
    ("multiply", 2, 2, 4, True), ("multiply", 10, 10, 6, True),
    ("multiply", 10, 10, 6, False), ("multiply", 0, 0, 2, True),
    ("multiply", 3, 2, 1, True), ("multiply", -1, 0, 1, True),
    ("divide", 10, 2, 2, False), ("divide", 0, 38, 6, False),
    ("divide", 10, 10, 6, False), ("divide", 2, 2, 0, False),
    ("divide", 2, 2, 0, True), ("divide", 4, 1, 0, True),
    ("divide", 0, 38, 6, True), ("remainder", 2, 5, 3, False),
    ("remainder", 2, 1, 3, False), ("remainder", 1, 1, 1, False),
    ("remainder", 0, 5, 3, False))
# the matrix cases timed: Spark's decimal(38,10) / decimal(38,10) at
# quotient scale 6 (one division and its rounding) and a remainder of
# equal scales (one division); the kernel runs one 256-step long division
# a row in each
DEC_TIMED = {"divide": ("divide", 10, 10, 6, False),
             "remainder": ("remainder", 1, 1, 1, False)}
# The least integer work of a row of each timed op, in 32-bit integer
# instructions (PEAK_INT_OPS_PER_S's unit), counted for the function on
# 64-bit words and not for the kernel's algorithm: a 64 x 64 -> 128-bit
# product is 4 32-bit products' low and high halves and 4 adds (12), a
# carried 64-bit add 2.
# - multiply, 128 x 128 -> 256 bits at exponent 0 (the entry's): both
#   magnitudes 16, 4 word products 48 and their carried sums 12, the sign
#   8, the compare against 10^38 8: 92.
# - a division of a 3-word dividend by a 2-word divisor (Knuth D, base
#   2^64; |a| * 10^6 is at most 148 bits): normalising both (a count of
#   leading zeros, 5 double-word shifts) 20, the divisor's reciprocal once
#   30, per quotient word (2) an estimate by the reciprocal (2 products, 14
#   adds: 38) and a 2-word multiply-subtract (2 products, 4 carried
#   subtracts: 32), the remainder shifted back 6: 196; a 2-word dividend
#   (the equal-scale remainder) has one quotient word: 126.
# - divide at quotient scale 6: magnitudes 16, the dividend times 10^6 12,
#   the division 196, HALF_UP (2|r| >= |d|, an increment) 16, the sign 16,
#   the zero divisor 4, the compare 8: 268.
# - remainder at equal scales: magnitudes 16, the division 126 (its
#   remainder is the result), the sign 8, the zero divisor 4, the compare
#   8: 162.
# A row of narrower values needs fewer words, so these err high.
DEC_ROW_OPS = {"multiply": 92, "divide": 268, "remainder": 162}
# Integer-pipe instructions of one step of the kernel's 256-step binary
# long division, read off its compiled SASS (`cuobjdump -sass`,
# decimal_kernel<2>'s loop: 53 of 65): the algorithm's own chain, reported
# beside the bound and not in it
DEC_DIV_STEP_OPS = 53
_M256 = (1 << 256) - 1


def _u_neg(u):
    return (-u) & _M256


def _u_isneg(u):
    return u >> 255 == 1


def _u_abs(u):
    return _u_neg(u) if _u_isneg(u) else u


def _p10(k):
    return 10 ** min(max(k, 0), 76)


def _u_div(n, d):
    """Signed truncating division of 256-bit two's complement values, the
    remainder with n's sign; a zero divisor gives the all-ones quotient
    and the remainder n, as a binary long division by 0 does."""
    an, ad = _u_abs(n), _u_abs(d)
    q, r = (_M256, an) if ad == 0 else divmod(an, ad)
    if _u_isneg(n) != _u_isneg(d):
        q = _u_neg(q)
    return q, (_u_neg(r) if _u_isneg(n) else r)


def _u_round(q, r, d):
    """HALF_UP: |q| one further from zero when 2|r| >= |d|, in the
    direction sign(r) ^ sign(d)."""
    if ((_u_abs(r) << 1) & _M256) < _u_abs(d):
        return q
    return (q + (-1 if _u_isneg(r) != _u_isneg(d) else 1)) & _M256


def _u_div_round(n, d):
    return _u_round(*_u_div(n, d), d)


def _u_prec10(u):
    """The first i in [0, 76] with 10^i >= |u|, 77 if none."""
    a = _u_abs(u)
    i = len(str(a)) - 1
    return min(i + (10 ** i < a), 77)


def _u_rescale(v, old, new):
    if new < old:
        return (v * _p10(old - new)) & _M256
    if new > old:
        return _u_div_round(v, _p10(new - old))
    return v


def py_decimal(op, a, b, sa, sb, so, flag):
    """One row of a decimal op in Python integers, from Spark's semantics
    as the reference's decimal_utils.cu states them (cudf scales are the
    negated Spark ones): -> (overflow, result mod 2^256)."""
    a, b = a & _M256, b & _M256
    gt38 = lambda u: _u_abs(u) >= 10 ** 38   # noqa: E731
    if op in ("add", "sub"):
        inter = min(-sa, -sb)
        a, b = _u_rescale(a, -sa, inter), _u_rescale(b, -sb, inter)
        s = _u_rescale((a + (_u_neg(b) if flag else b)) & _M256, inter, -so)
        return gt38(s), s
    if op == "multiply":
        p = (a * b) & _M256
        scale = -sa - sb
        if flag and _u_prec10(p) > 38:
            first = _u_prec10(p) - 38
            p, scale = _u_div_round(p, _p10(first)), scale + first
        e = -so - scale
        if e < 0:
            r = (p * _p10(-e)) & _M256
            return _u_prec10(p) - e > 38 or gt38(r), r
        r = _u_div_round(p, _p10(e)) if e > 0 else p
        return gt38(r), r
    zero = b == 0
    d = 1 if zero else b
    if op == "divide":
        shift = -so + sa - sb
        if shift > 0:
            q1 = _u_div(a, d)[0]
            r = (_u_div(q1, _p10(shift))[0] if flag
                 else _u_div_round(q1, _p10(shift)))
        elif shift < -38:
            q1, r1 = _u_div((a * _p10(38)) & _M256, d)
            m = _p10(-shift - 38)
            q2, r2 = _u_div((r1 * m) & _M256, d)
            r = (q1 * m + q2) & _M256
            if not flag:
                r = _u_round(r, r2, d)
        else:
            num = (a * _p10(-shift)) & _M256 if shift else a
            r = _u_div(num, d)[0] if flag else _u_div_round(num, d)
        r = 0 if zero else r
        return zero or gt38(r), r
    # remainder
    an, ad = _u_abs(a), _u_abs(d)
    d_shift, n_shift = -so + sb, -so + sa
    if d_shift > 0:
        ad = _u_div_round(ad, _p10(d_shift))
    else:
        n_shift -= d_shift
    if n_shift > 0:
        q = _u_div(_u_div(an, ad)[0], _p10(n_shift))[0]
    else:
        if n_shift < 0:
            an = (an * _p10(-n_shift)) & _M256
        q = _u_div(an, ad)[0]
    less = (q * ad) & _M256
    if d_shift < 0:
        less = (less * _p10(-d_shift)) & _M256
    rem = (an - less) & _M256
    ovf = zero or gt38(rem)
    rem = _u_neg(rem) if _u_isneg(a) else rem
    return ovf, (0 if zero else rem)


def dec_column(rng, n, zero_every=0):
    """(n,) random values as Python ints: 38-digit ones (an int64 times
    10^19 plus up to 10^19), 6-digit ones and the 128-bit edges."""
    big = (rng.integers(-(2**63) + 1, 2**63 - 1, n).astype(object) * 10**19
           + rng.integers(0, 10**19, n, dtype=np.uint64).astype(object))
    small = rng.integers(-(10**6), 10**6, n).astype(object)
    edges = np.array([0, 1, -1, 10**38 - 1, -(10**38 - 1), 10**38,
                      -(10**38), 2**127 - 1, -(2**127)], dtype=object)
    pick = rng.random(n)
    vals = np.where(pick < 0.6, big, small)
    at = pick < 0.05
    vals[at] = edges[rng.integers(0, len(edges), int(at.sum()))]
    if zero_every:
        vals[::zero_every] = 0
    return vals


def dec_bits(torch, t):
    """uint32 limbs by their int32 bits: torch's CUDA ops take few
    unsigned dtypes."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def dec_equal(torch, chk, got, want, what):
    """Two (overflow, result) pairs equal: every row's bits and the
    validity."""
    for part, g, w in zip(("overflow", "result"), got, want):
        require(g.dtype == w.dtype, f"{what} {part}: {g.dtype} vs {w.dtype}")
        chk.equal("decimal128", dec_bits(torch, g.data),
                  dec_bits(torch, w.data), f"{what} {part}")
        require((g.validity is None) == (w.validity is None),
                f"{what} {part}: validity on one side only")
        if g.validity is not None:
            chk.equal("decimal128", g.validity, w.validity,
                      f"{what} {part} validity")


def dec_timing(torch, fn, plain, n, op, in_bytes, divisions):
    """Device ms (profiler records, L2 flushed), one call's ms, the plain
    version's ms and the bound of one call over n rows: `in_bytes` a row of
    distinct input buffers read once, 16 B of limbs and the overflow byte
    written, and DEC_ROW_OPS[op] integer instructions a row; beside it the
    chain of the kernel's own `divisions` 256-step long divisions a row."""
    ms = device_ms(torch, fn, KERNEL_NAMES["decimal128"], 20)
    cms = call_ms(torch, fn, 20)
    pms = time_cuda(torch, plain, 1)
    nbytes = n * (in_bytes + 16 + 1)
    ops_ = n * DEC_ROW_OPS[op]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / PEAK_INT_OPS_PER_S * 1e3
    chain = n * divisions * 256 * DEC_DIV_STEP_OPS
    return {"ms": ms, "call_ms": cms, "plain_ms": pms, "bytes": nbytes,
            "ops": ops_, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "algorithm_chain_ms": chain / PEAK_INT_OPS_PER_S * 1e3}


def decimal_phase(torch, chk):
    """The entry step (`spark_rapids_tpu_torch.entry`) at 4,096 and
    10,000,000 rows, every counter zeroed just before and read just after
    (two row-hash launches and one decimal launch, no plain run), equal to
    numpy's hashes and v * v; the kernel against its plain version on a
    1,000,003-row matrix of every op and branch, bit for bit, and a
    20,000-row sample against Python integers; then timed."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.entry import decimal_limbs, entry
    from spark_rapids_tpu_torch.ops import decimal_utils as du

    launches, out = {}, {"entry": {}, "matrix": {}}
    for n in DEC_ENTRY_SIZES:
        step, (keys, vals) = entry(n)
        torch.cuda.synchronize()
        reset_kernel_counters()
        h32, h64, product, overflow = step(keys, vals)
        torch.cuda.synchronize()
        counters = kernel_counters()
        want = {"murmur": 1, "xxhash": 1, "multiply": 1}
        got = {"murmur": counters["row_hash"]["murmur"],
               "xxhash": counters["row_hash"]["xxhash"],
               "multiply": counters["decimal128"]["multiply"]}
        require(got == want and counted(counters) == 3,
                f"entry at {n} rows: counters {counters}")
        launches[f"entry {n}"] = got
        k, v = keys.cpu().numpy(), vals.cpu().numpy()
        t0 = time.perf_counter()
        require(np.array_equal(h32.cpu().numpy(), np_murmur3([k, v], 42)),
                f"entry at {n} rows: murmur3 differs from numpy")
        require(np.array_equal(h64.cpu().numpy(), np_xxhash64([k, v], 42)),
                f"entry at {n} rows: xxhash64 differs from numpy")
        words = product.cpu().numpy().view(np.uint64)
        require(np.array_equal(words[:, 0], (v * v).view(np.uint64))
                and not words[:, 1].any() and not overflow.cpu().numpy().any(),
                f"entry at {n} rows: the product differs from v * v")
        log(f"entry at {n} rows: murmur3, xxhash64 and v * v equal numpy "
            f"({time.perf_counter() - t0:.1f} s); launches {got}")
        if n == N_ROWS:     # the multiply's operand, timed below
            dec = Column(dt.decimal(38, 2), n, decimal_limbs(vals))
        del keys, h32, h64, product, overflow
    out["entry"]["launches"] = launches

    # the matrix: every op and branch, kernel == plain, sample == Python
    rng = np.random.default_rng(5)
    n = DEC_MATRIX_ROWS
    t0 = time.perf_counter()
    av, bv = dec_column(rng, n), dec_column(rng, n, zero_every=9)
    a_valid, b_valid = rng.random(n) > 0.1, rng.random(n) > 0.1
    sample = np.sort(rng.choice(n, DEC_SAMPLE_ROWS, replace=False))
    # every row's value stays in the limbs, nulls' too (the kernel computes
    # them); each scale is a view of the same limbs
    base = {"a": (Column.from_pylist(av, dt.decimal(38, 0), device="cuda"),
                  torch.as_tensor(a_valid, device="cuda")),
            "b": (Column.from_pylist(bv, dt.decimal(38, 0), device="cuda"),
                  torch.as_tensor(b_valid, device="cuda"))}
    log(f"decimal matrix: {n} rows made in {time.perf_counter() - t0:.1f} s")

    def column(side, scale):
        c, valid = base[side]
        return Column(dt.DType(dt.Kind.DECIMAL128, 38, scale), n, c.data,
                      valid)
    matrix_launches = 0
    for case in DEC_CASES:
        op, sa, sb, so, flag = case
        a, b = column("a", sa), column("b", sb)
        torch.cuda.synchronize()
        reset_kernel_counters()
        got = du.decimal128_op(op, a, b, so, flag)
        torch.cuda.synchronize()
        counters = kernel_counters()
        require(counters["decimal128"][op] == 1 and counted(counters) == 1,
                f"decimal {case}: counters {counters}")
        matrix_launches += 1
        t1 = time.perf_counter()
        dec_equal(torch, chk, got,
                  du.decimal128_op(op, a, b, so, flag, plain=True),
                  f"decimal {case}")
        plain_s = time.perf_counter() - t1
        ovf = got[0].data.cpu().numpy()
        res = got[1].data.cpu().numpy()
        int64_out = op == "divide" and flag
        t1 = time.perf_counter()
        bad = 0
        for i in sample:
            w_ovf, w_res = py_decimal(op, int(av[i]), int(bv[i]), sa, sb,
                                      so, flag)
            if int64_out:
                lo = w_res & (2**64 - 1)
                g_res = int(res[i]) & (2**64 - 1)
                bad += bool(ovf[i]) != w_ovf or g_res != lo
            else:
                g_res = sum(int(res[i, j]) << (32 * j) for j in range(4))
                bad += (bool(ovf[i]) != w_ovf
                        or g_res != w_res & ((1 << 128) - 1))
        require(bad == 0, f"decimal {case}: {bad} of {len(sample)} sampled "
                f"rows differ from Python integers")
        out["matrix"][str(case)] = {"overflow_rows": int(ovf.sum()),
                                    "plain_check_s": plain_s}
        log(f"  decimal {case}: kernel == plain ({plain_s:.1f} s), "
            f"{len(sample)} rows == Python ints "
            f"({time.perf_counter() - t1:.1f} s); {int(ovf.sum())} rows "
            f"overflow")
    out["matrix"]["launches"] = matrix_launches

    # timing: the entry's multiply at 10M rows (one input buffer, read as
    # both operands), divide and remainder on the matrix (two)
    timing = {"multiply": dec_timing(
        torch, lambda: du.multiply_decimal128(dec, dec, 4),
        lambda: du.multiply_decimal128_plain(dec, dec, 4), N_ROWS,
        "multiply", 16, 0)}
    for name, case in DEC_TIMED.items():
        op, sa, sb, so, flag = case
        a, b = column("a", sa), column("b", sb)
        timing[name] = dec_timing(
            torch, lambda: du.decimal128_op(op, a, b, so, flag),
            lambda: du.decimal128_op(op, a, b, so, flag, plain=True), n,
            op, 32, 1)
        timing[name]["case"] = list(case)
    for name, t in timing.items():
        log(f"  decimal {name}: device {t['ms']!r} ms, one call "
            f"{t['call_ms']!r} ms, plain {t['plain_ms']!r} ms; bound "
            f"{t['bound_ms']!r} ms ({t['bytes']} B -> {t['bytes_ms']!r} ms, "
            f"{t['ops']} ops -> {t['ops_ms']!r} ms); the kernel's "
            f"long-division chain {t['algorithm_chain_ms']!r} ms")
    out["timing"] = timing
    del base, dec
    torch.cuda.empty_cache()
    return out


# ---- phase 5c ----------------------------------------------------------------

CUST_ROWS = 10_000_000             # the customer table hashed at full size
CUST_CHECK_ROWS = 1_000_003        # held against the plain version
CUST_ORACLE_ROWS = 10_000          # strided rows held against Python
CUST_SEED = 42                     # both hashes' seed
RH_BYTES_REPLACES = ("spark_rapids_tpu/ops/hash.py:85 (_mm_var; _xx_var "
                     ":178, java_bigdecimal_bytes :342, _murmur_element "
                     ":408: XLA ops, no pallas_call), beside the Pallas row "
                     "hash spark_rapids_tpu/ops/hash_pallas.py:316")
# Least integer instructions of Spark's byte hashes, counted as for
# RH_COL_OPS (a 32-bit multiply, rotate, xor or add one instruction; a
# 64-bit multiply by a constant 3, a 64-bit add, xor or rotate 2):
# murmur3 is 6 a 4-byte block or tail byte (two multiplies, two rotates, the
# xor and h * 5 + c) and 9 a value (the length xor and fmix); xxhash64 is
# 10 an 8-byte stripe lane (multiply, add, rotate, multiply), 76 to merge
# the four lanes, 17 an 8-byte step, 12 the 4-byte step, 10 a tail byte
# and 17 a value (the seed and length adds and the avalanche).
MM_BLOCK_OPS, MM_VALUE_OPS = 6, 9
XX_LANE_OPS, XX_MERGE_OPS, XX_VALUE_OPS = 10, 76, 17
XX_STEP8_OPS, XX_STEP4_OPS, XX_BYTE_OPS = 17, 12, 10

# tests/test_hash.py's Spark vectors (from real Spark runs): the fifth
# string holds the unpaired UTF-16 surrogates U+D720 U+D721 as Spark stores
# them, 3 bytes each
GOLD_STRINGS5 = [b"", b"The quick brown fox", b"jumps over the lazy dog.",
                 b"All work and no play makes Jack a dull boy",
                 b"!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
                 b"\xed\x9c\xa0\xed\x9c\xa1"]
GOLD_DEC128 = [0, 100, -1,
               int.from_bytes(bytes.fromhex("FFFFFFFFFCC4D1C3602F7FC318000001"),
                              "big", signed=True),
               int.from_bytes(bytes.fromhex("0785EE10D5DA46D900F4369FFFFFFFFF"),
                              "big", signed=True)]
GOLD_V8 = [True] * 5 + [False] + [True] * 2


def py_murmur32(data, seed):
    """Spark murmur3_32 of a byte string in Python integers (the algorithm
    of tests/spark_hash_oracle.py): 4-byte blocks, then each tail byte as a
    signed char, then fmix(h ^ length); the int32 result."""
    m = 0xFFFFFFFF

    def rnd(h, k):
        k = (k * 0xCC9E2D51) & m
        k = ((k << 15) | (k >> 17)) & m
        k = (k * 0x1B873593) & m
        h ^= k
        h = ((h << 13) | (h >> 19)) & m
        return (h * 5 + 0xE6546B64) & m
    h = seed & m
    nb = len(data) // 4
    for i in range(nb):
        h = rnd(h, int.from_bytes(data[4 * i:4 * i + 4], "little"))
    for b in data[4 * nb:]:
        h = rnd(h, (b - 256 if b >= 128 else b) & m)
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h


def py_xxhash64(data, seed):
    """Spark xxhash64 of a byte string in Python integers (the algorithm of
    tests/spark_hash_oracle.py); the int64 result."""
    m = (1 << 64) - 1
    p1, p2, p3, p4, p5 = (int(c) for c in _XX)

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    def word(o, k):
        return int.from_bytes(data[o:o + k], "little")
    seed &= m
    n, off = len(data), 0
    if n >= 32:
        v = [(seed + p1 + p2) & m, (seed + p2) & m, seed, (seed - p1) & m]
        while off + 32 <= n:
            for k in range(4):
                v[k] = (rotl((v[k] + word(off + 8 * k, 8) * p2) & m, 31)
                        * p1) & m
            off += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12)
             + rotl(v[3], 18)) & m
        for x in v:
            h ^= (rotl((x * p2) & m, 31) * p1) & m
            h = (h * p1 + p4) & m
    else:
        h = (seed + p5) & m
    h = (h + n) & m
    while off + 8 <= n:
        h ^= (rotl((word(off, 8) * p2) & m, 31) * p1) & m
        h = (rotl(h, 27) * p1 + p4) & m
        off += 8
    if off + 4 <= n:
        h ^= (word(off, 4) * p1) & m
        h = (rotl(h, 23) * p2 + p3) & m
        off += 4
    for b in data[off:]:
        h ^= (b * p5) & m
        h = (rotl(h, 11) * p1) & m
    h ^= h >> 33
    h = (h * p2) & m
    h ^= h >> 29
    h = (h * p3) & m
    h ^= h >> 32
    return h - (1 << 64) if h >= 1 << 63 else h


def py_bigdecimal_bytes(v):
    """java.math.BigDecimal.unscaledValue().toByteArray() of an int."""
    return v.to_bytes((v if v >= 0 else ~v).bit_length() // 8 + 1, "big",
                      signed=True)


def customer_arrays(n, seed=0):
    """The customer table's host buffers, made with numpy from `seed`:
    c_customer_sk (INT64, 1..n); c_customer_id (16 chars, TPC-DS's form:
    "AAAAAAAA", then the key's eight base-16 digits as the letters A-P,
    least significant first); c_email_address (0-48 bytes, 5% null, 3% of
    rows starting with U+00E9 and 1% holding U+65E5, two- and three-byte
    UTF-8); a DECIMAL(38,2) of 1- to 16-byte magnitudes, negatives and a
    zero every 101st row, as (n, 4) uint32 limbs."""
    rng = np.random.default_rng(seed)
    sk = np.arange(1, n + 1, dtype=np.int64)
    ids = np.full((n, 16), ord("A"), np.uint8)
    ids[:, 8:] += ((sk[:, None] >> (4 * np.arange(8))) & 15).astype(np.uint8)
    lens = rng.integers(0, 49, n)
    valid = rng.random(n) >= 0.05
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789._@",
                             np.uint8)
    chars = alphabet[rng.integers(0, len(alphabet), int(offs[-1]),
                                  dtype=np.uint8)]
    two = (rng.random(n) < 0.03) & (lens >= 2)
    at = offs[:-1][two]
    chars[at], chars[at + 1] = 0xC3, 0xA9
    three = (rng.random(n) < 0.01) & (lens >= 5) & ~two
    at = offs[:-1][three] + 2
    chars[at], chars[at + 1], chars[at + 2] = 0xE6, 0x97, 0xA5
    hi = rng.integers(-(2 ** 60), 2 ** 60, n) >> rng.integers(0, 61, n)
    lo = rng.integers(0, 2 ** 63, n) >> np.where(
        (hi == 0) | (hi == -1), rng.integers(0, 63, n), 0)
    hi[::101], lo[::101] = 0, 0
    limbs = np.stack([lo & 0xFFFFFFFF, lo >> 32, hi & 0xFFFFFFFF,
                      (hi >> 32) & 0xFFFFFFFF], axis=1).astype(np.uint32)
    return {"sk": sk, "ids": ids, "email_offs": offs.astype(np.int32),
            "email_chars": chars, "email_valid": valid, "dec": limbs}


def customer_table(torch, a, device):
    """The port Table of `customer_arrays` on `device`."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.columnar import make_string_column

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    n = a["sk"].shape[0]
    id_offs = np.arange(0, 16 * (n + 1), 16, dtype=np.int64).astype(np.int32)
    return Table([
        Column(dt.INT64, n, t(a["sk"])),
        make_string_column(t(a["ids"].reshape(-1)), t(id_offs)),
        make_string_column(t(a["email_chars"]), t(a["email_offs"]),
                           t(a["email_valid"])),
        Column(dt.decimal(38, 2), n, t(a["dec"]))],
        ["c_customer_sk", "c_customer_id", "c_email_address", "c_balance"])


def decimal_values(limbs):
    """Python ints of (n, 4) uint32 limbs."""
    out = []
    for row in limbs:
        u = sum(int(w) << (32 * j) for j, w in enumerate(row))
        out.append(u - (1 << 128) if u >= 1 << 127 else u)
    return out


def decimal_byte_lengths(limbs):
    """The BigDecimal byte length of each row, in numpy: bit length of the
    magnitude (of ~v for negatives) // 8 + 1."""
    w = limbs.astype(np.uint64)
    hi = (w[:, 3] << np.uint64(32)) | w[:, 2]
    lo = (w[:, 1] << np.uint64(32)) | w[:, 0]
    neg = (hi >> np.uint64(63)).astype(bool)
    hi = np.where(neg, ~hi, hi)
    lo = np.where(neg, ~lo, lo)

    def bitlen(x):             # exact: float64 log2 of 32-bit halves
        h = (x >> np.uint64(32)).astype(np.float64)
        low = (x & np.uint64(0xFFFFFFFF)).astype(np.float64)
        with np.errstate(divide="ignore"):
            bh = np.where(h > 0, np.floor(np.log2(h)) + 33, 0)
            bl = np.where(low > 0, np.floor(np.log2(low)) + 1, 0)
        return np.where(h > 0, bh, bl).astype(np.int64)
    bits = np.where(hi > 0, bitlen(hi) + 64, bitlen(lo))
    return bits // 8 + 1


def mm_ops(lens):
    return (lens // 4 + lens % 4) * MM_BLOCK_OPS + MM_VALUE_OPS


def xx_ops(lens):
    rem = lens % 32
    return (np.where(lens >= 32, (lens // 32) * 4 * XX_LANE_OPS
                     + XX_MERGE_OPS, 0)
            + (rem // 8) * XX_STEP8_OPS + ((rem % 8) // 4) * XX_STEP4_OPS
            + (rem % 4) * XX_BYTE_OPS + XX_VALUE_OPS)


def customer_bounds(a):
    """(bytes, murmur3 ops, xxhash64 ops) of one hash of the customer
    table: every buffer read once (the key, both strings' chars and
    offsets, the email's validity, the limbs) and the hashes written; the
    instructions of each row's valid values, from this data's lengths."""
    n = a["sk"].shape[0]
    email = np.diff(a["email_offs"].astype(np.int64))
    dec = decimal_byte_lengths(a["dec"])
    valid = a["email_valid"]
    read = (a["sk"].nbytes + a["ids"].nbytes + 4 * (n + 1)
            + a["email_chars"].nbytes + a["email_offs"].nbytes + valid.nbytes
            + a["dec"].nbytes)
    mm = (n * (2 * MM_BLOCK_OPS + MM_VALUE_OPS + 4 * MM_BLOCK_OPS
               + MM_VALUE_OPS) + int(mm_ops(email)[valid].sum())
          + int(mm_ops(dec).sum()))
    xx = (n * (32 + int(xx_ops(np.array([16]))[0]))
          + int(xx_ops(email)[valid].sum()) + int(xx_ops(dec).sum()))
    return {"murmur": (read + 4 * n, mm + RH_ROW_OPS["murmur"] * n),
            "xxhash": (read + 8 * n, xx + RH_ROW_OPS["xxhash"] * n)}


def oracle_rows(a, rows):
    """Python murmur3 and xxhash64 (seed CUST_SEED) of the given rows."""
    decs = decimal_values(a["dec"][rows])
    offs, chars = a["email_offs"], a["email_chars"]
    mm, xx = [], []
    for k, i in enumerate(rows):
        vals = [int(a["sk"][i]).to_bytes(8, "little", signed=True),
                a["ids"][i].tobytes()]
        if a["email_valid"][i]:
            vals.append(chars[offs[i]:offs[i + 1]].tobytes())
        vals.append(py_bigdecimal_bytes(decs[k]))
        h, x = CUST_SEED, CUST_SEED
        for v in vals:
            h = py_murmur32(v, h)
            x = py_xxhash64(v, x)
        mm.append(h)
        xx.append(x)
    return np.array(mm, np.int32), np.array(xx, np.int64)


def nested_hash_table(torch, n, seed=5):
    """STRUCT<INT32, STRING>, LIST<INT32> of 0-8 elements and LIST<STRING>
    on the card, nulls at every level."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, make_string_column
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to("cuda")

    def strings(m, hi):
        lens = rng.integers(0, hi + 1, m)
        offs = np.zeros(m + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        chars = rng.integers(32, 127, int(offs[-1])).astype(np.uint8)
        return make_string_column(t(chars), t(offs.astype(np.int32)),
                                  t(rng.random(m) > 0.1))

    def offsets(m):
        lens = rng.integers(0, 9, m)
        offs = np.zeros(m + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        return t(offs.astype(np.int32)), int(offs[-1])
    st = Column.make_struct(
        t(rng.random(n) > 0.1),
        a=Column(dt.INT32, n, t(rng.integers(-2**31, 2**31, n,
                                             dtype=np.int32)),
                 t(rng.random(n) > 0.1)),
        b=strings(n, 40))
    o, m = offsets(n)
    li = Column.make_list(o, Column(dt.INT32, m, t(rng.integers(
        -2**31, 2**31, m, dtype=np.int32)), t(rng.random(m) > 0.1)),
        t(rng.random(n) > 0.1))
    o, m = offsets(n)
    ls = Column.make_list(o, strings(m, 20), t(rng.random(n) > 0.1))
    return [st, li, ls]


def golden_phase(torch, chk):
    """Spark's golden vectors of tests/test_hash.py through `api.Hash` on
    the card: strings with the surrogate bytes, DECIMAL128, structs, the
    chained tables of every kind."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    f32, f64 = np.finfo(np.float32), np.finfo(np.float64)
    i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)

    def col(vals, d):
        return Column.from_pylist(vals, d, device="cuda")

    def colv(vals, d):
        return col([v if GOLD_V8[i] else None for i, v in enumerate(vals)],
                   d)

    def struct5():
        return Column.make_struct(
            a=col([0, 100, -100, 0x12345678, -0x76543210], dt.INT32),
            b=col(["a", "bc", "def", "ghij", "klmno"], dt.STRING),
            c=Column.make_struct(
                x=col([0., 100., -100., np.inf, -np.inf], dt.FLOAT32),
                y=col([0, 100, -100, 0x0123456789ABCDEF,
                       -0x0123456789ABCDEF], dt.INT64)))
    ts = ([0, 100, -100, -(i64.min // -1000000), i64.max // 1000000],
          dt.TIMESTAMP_US)
    mm_chain = [
        struct5(), col(GOLD_STRINGS5, dt.STRING),
        col([0., -0., -np.nan, f64.min, f64.max], dt.FLOAT64), col(*ts),
        col([0, 100, -100, -999999999999999999, 999999999999999999],
            dt.decimal(18, 7)),
        col([0, 100, -100, i64.min, i64.max], dt.INT64),
        col([0., -0., -np.nan, f32.min, f32.max], dt.FLOAT32),
        col([0, 100, -100, -((2**31) // 100), (2**31 - 1) // 100],
            dt.DATE32),
        col([0, 100, -100, -999999999, 999999999], dt.decimal(9, 3)),
        col([0, 100, -100, i32.min, i32.max], dt.INT32),
        col([0, 100, -100, -32768, 32767], dt.INT16),
        col([0, 100, -100, -128, 127], dt.INT8),
        col([False, True, True, True, False], dt.BOOL),
        col(GOLD_DEC128, dt.decimal(38, 11))]
    xx_dec = [0, 100, -1, GOLD_DEC128[3], GOLD_DEC128[4], 0, GOLD_DEC128[3],
              GOLD_DEC128[4]]
    xx_chain = [
        colv(GOLD_STRINGS5 + [b"", b"abcdefgh", b"abcdefghi"], dt.STRING),
        colv([0., -0., -np.nan, f64.min, f64.max, 0., 100., 200.],
             dt.FLOAT64),
        colv(ts[0] + [0, 200, 300], dt.TIMESTAMP_US),
        colv([0, 100, -100, -999999999999999999, 999999999999999999, 0, 123,
              432], dt.decimal(18, 7)),
        colv([0, 100, -100, i64.min, i64.max, 0, 0x123456789ABCDEF,
              -0x123456789ABCDEF], dt.INT64),
        colv([0., -0., -np.nan, f32.min, f32.max, 0., np.inf, -np.inf],
             dt.FLOAT32),
        colv([0, 100, -100, -((2**31) // 100), (2**31 - 1) // 100, 0, -200,
              -300], dt.DATE32),
        colv([0, 100, -100, -999999999, 999999999, 0, -200, -300],
             dt.decimal(9, 3)),
        colv([0, 100, -100, i32.min, i32.max, 0, -200, -300], dt.INT32),
        colv([0, 100, -100, -32768, 32767, 0, -200, -300], dt.INT16),
        colv([0, 100, -100, -128, 127, 0, -90, -80], dt.INT8),
        colv([False, True, True, True, False, False, False, False], dt.BOOL),
        colv(xx_dec, dt.decimal(38, 11))]
    cases = [
        ("strings", api.Hash.murmurHash32, [col(GOLD_STRINGS5, dt.STRING)],
         42, [142593372, 1217302703, -715697185, -2061143941, -111635966]),
        ("strings seed 314", api.Hash.murmurHash32,
         [col(GOLD_STRINGS5, dt.STRING)], 314,
         [1467149710, 723257560, -1620282500, -2001858707, 1588473657]),
        ("decimal128", api.Hash.murmurHash32,
         [col(GOLD_DEC128, dt.decimal(38, 11))], 42,
         [-783713497, -295670906, 1398487324, -52622807, -1359749815]),
        ("structs", api.Hash.murmurHash32, [struct5()], 42,
         [-105406170, 90479889, -678041645, 1667387937, 301478567]),
        ("combined chained", api.Hash.murmurHash32, mm_chain, 42,
         [401603227, 588162166, 552160517, 1132537411, -326043017]),
        ("xxhash64 strings", api.Hash.xxhash64, xx_chain[:1], 42,
         [-7444071767201028348, -3617261401988713833, 8198945020833482635,
          -5346617152005100141, 6614298085531227868, 42,
          2470326616177429180, -7093207067522615973]),
        ("xxhash64 decimal128", api.Hash.xxhash64, xx_chain[-1:], 42,
         [-8959994473701255385, 4409375254388155230, -4006032525457443936,
          -5423362182451591024, 7041733194569950081, 42,
          -5423362182451591024, 7041733194569950081]),
        ("xxhash64 combined", api.Hash.xxhash64, xx_chain, 42,
         [541735645035655239, 9011982951766246298, 3834379147931449211,
          -5406325166887725795, 7797509897614041972, 42,
          -9032872913521304524, -604070008711895908])]
    for what, fn, cols, seed, want in cases:
        got = fn(cols, seed).to_pylist()
        if got != want:
            chk.max_err["row_hash_bytes"] = max(chk.max_err["row_hash_bytes"],
                                                1)
            raise AssertionError(f"golden {what}: {got} != Spark's {want}")
        chk.n += 1
    lst = Column.make_list(torch.tensor([0, 2, 2, 6], dtype=torch.int32,
                                        device="cuda"),
                           col([1, 2, 3, 4, 5, 6], dt.INT32))
    want = []
    for vals in ([1, 2], [], [3, 4, 5, 6]):
        h = 42
        for v in vals:
            h = py_murmur32(v.to_bytes(4, "little", signed=True), h)
        want.append(h)
    require(api.Hash.murmurHash32([lst], 42).to_pylist() == want,
            "a list of ints does not hash as the chain of its elements")
    return len(cases) + 1


def customer_hash_phase(torch, chk):
    """Phase 5c: Spark's murmur3 and xxhash64 (seed 42) of a 10M-row
    customer table (INT64 key, 16-char id, 0-48-byte email with nulls and
    non-ASCII bytes, DECIMAL(38,2)) through `api.Hash`, one kernel launch
    each, counters zeroed just before and read just after; the main path's
    outputs held against the plain version on every row and a Python
    oracle on 10,000 strided rows, then both seeds against the plain
    version at 1,000,003 rows; timed; the nested case and Spark's golden
    vectors."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch.ops import copying
    from spark_rapids_tpu_torch.ops import hash as plain
    from spark_rapids_tpu_torch.ops import hash_cuda as hc

    t0 = time.perf_counter()
    a = customer_arrays(CUST_ROWS, seed=0)
    t = customer_table(torch, a, "cuda")
    torch.cuda.synchronize()
    log(f"customer table: {CUST_ROWS} rows, "
        f"{t.nbytes() / 1e9:.3f} GB on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    reset_kernel_counters()
    mm = api.Hash.murmurHash32(t.columns, CUST_SEED)
    xx = api.Hash.xxhash64(t.columns, CUST_SEED)
    torch.cuda.synchronize()
    counters = kernel_counters()
    launches = {"murmur": counters["row_hash"]["murmur"],
                "xxhash": counters["row_hash"]["xxhash"]}
    require(launches == {"murmur": 1, "xxhash": 1}
            and counted(counters) == 2,
            f"customer hash: counters {counters}")
    log(f"  main path: launches {launches}, plain runs "
        f"{counters['plain']['row_hash']}")

    # the main path's own outputs against the plain version, every row
    t0 = time.perf_counter()
    chk.equal("row_hash_bytes", mm.data, plain.murmur_hash3_32(t, CUST_SEED)
              .data, f"customer {CUST_ROWS} murmur3 (main path)")
    chk.equal("row_hash_bytes", xx.data, plain.xxhash64(t, CUST_SEED).data,
              f"customer {CUST_ROWS} xxhash64 (main path)")
    torch.cuda.synchronize()
    log(f"  main path's {CUST_ROWS} rows == plain version "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    rows = np.arange(0, CUST_ROWS, CUST_ROWS // CUST_ORACLE_ROWS)
    want_mm, want_xx = oracle_rows(a, rows)
    idx = torch.from_numpy(rows).to("cuda")
    got_mm = mm.data.index_select(0, idx).cpu().numpy()
    got_xx = xx.data.index_select(0, idx).cpu().numpy()
    for what, got, want in (("murmur3", got_mm, want_mm),
                            ("xxhash64", got_xx, want_xx)):
        if not np.array_equal(got, want):
            chk.max_err["row_hash_bytes"] = max(
                chk.max_err["row_hash_bytes"], 1)
            raise AssertionError(
                f"customer {what}: {int((got != want).sum())} of "
                f"{len(rows)} strided rows differ from the Python oracle")
        chk.n += 1
    log(f"  {len(rows)} strided rows == the Python oracle "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    small = copying.slice_table(t, 0, CUST_CHECK_ROWS)
    for seed in (0, CUST_SEED):
        chk.equal("row_hash_bytes", hc.murmur_hash3_32_cuda(small, seed).data,
                  plain.murmur_hash3_32(small, seed).data,
                  f"customer {CUST_CHECK_ROWS} murmur3 seed {seed}")
        chk.equal("row_hash_bytes", hc.xxhash64_cuda(small, seed).data,
                  plain.xxhash64(small, seed).data,
                  f"customer {CUST_CHECK_ROWS} xxhash64 seed {seed}")
    nested = nested_hash_table(torch, CUST_CHECK_ROWS)
    for cols, what in ((nested, "struct, list<int32>, list<string>"),
                       (nested[:1], "struct<int32, string>"),
                       (nested[1:2], "list<int32>"),
                       (nested[2:], "list<string>")):
        chk.equal("row_hash_bytes", hc.murmur_hash3_32_cuda(cols, 42).data,
                  plain.murmur_hash3_32(cols, 42).data,
                  f"nested {what} at {CUST_CHECK_ROWS} rows")
    gold = golden_phase(torch, chk)
    torch.cuda.synchronize()
    log(f"  {CUST_CHECK_ROWS} rows and the nested case == plain version; "
        f"{gold} Spark golden vectors equal ({time.perf_counter() - t0:.1f} "
        f"s)")

    bounds = customer_bounds(a)
    del small, nested
    timing = {}
    for form, kern, pl in (
            ("murmur", lambda: hc.murmur_hash3_32_cuda(t, CUST_SEED),
             lambda: plain.murmur_hash3_32(t, CUST_SEED)),
            ("xxhash", lambda: hc.xxhash64_cuda(t, CUST_SEED),
             lambda: plain.xxhash64(t, CUST_SEED))):
        ms = device_ms(torch, kern, KERNEL_NAMES["row_hash_bytes"], 20)
        cms = call_ms(torch, kern, 20)
        pms = time_cuda(torch, pl, 2)
        nbytes, ops_ = bounds[form]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_ / PEAK_INT_OPS_PER_S * 1e3
        timing[form] = {"ms": ms, "call_ms": cms, "plain_ms": pms,
                        "bytes": nbytes, "ops": ops_, "bytes_ms": bytes_ms,
                        "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms)}
        log(f"  {form}: device {ms!r} ms, one call {cms!r} ms, plain "
            f"{pms!r} ms; bound {max(bytes_ms, ops_ms)!r} ms ({nbytes} B "
            f"-> {bytes_ms!r} ms, {ops_} ops -> {ops_ms!r} ms)")
    del t
    torch.cuda.empty_cache()
    return {"launches": launches, "timing": timing, "golden": gold,
            "oracle_rows": len(rows)}


# ---- phase 9 -----------------------------------------------------------------

RC_ROWS = 1_048_576                # bench_row_conversion.py's large size
RC_SOURCE = "spark_rapids_tpu_torch/ops/csrc/row_conversion.cu"
RC_REPLACES = {
    "to_rows": "spark_rapids_tpu/ops/row_conversion.py:165 (_to_rows_kernel;"
               " _to_rows_concat_kernel :225: XLA ops, no pallas_call)",
    "from_rows": "spark_rapids_tpu/ops/row_conversion.py:351 "
                 "(_from_rows_kernel; _from_rows_slice_kernel :317: XLA ops, "
                 "no pallas_call)"}
# least instructions of the conversion: a load and a store per 4-byte word
# of the row image
RC_WORD_OPS = 2


def rc_bench_table(torch, ncols, n, null_p=0.0):
    """benchmarks/bench_row_conversion.py's table: the 9-kind cycle, values
    drawn as `benchmarks/common.py` `random_fixed_table` draws them (seed
    7); with `null_p`, every column a validity drawn from seed 8."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    cycle = [dt.INT8, dt.INT32, dt.INT16, dt.INT64, dt.INT32, dt.BOOL,
             dt.INT16, dt.INT8, dt.INT64]
    rng = np.random.default_rng(7)
    vrng = np.random.default_rng(8)
    cols = []
    for i in range(ncols):
        d = cycle[i % len(cycle)]
        if d.kind == dt.Kind.BOOL:
            arr = rng.integers(0, 2, size=n).astype(bool)
        else:
            npt = np.dtype(str(d.storage_dtype()).removeprefix("torch."))
            info = np.iinfo(npt)
            arr = rng.integers(info.min, info.max, size=n, dtype=npt,
                               endpoint=True)
        v = None
        if null_p:
            v = torch.from_numpy(vrng.random(n) >= null_p).to("cuda")
        cols.append(Column(d, n, torch.from_numpy(arr).to("cuda"), v))
    return Table(cols)


def rc_bounds(table):
    """(to_rows, from_rows) (bytes, ops) of one call: each column's values
    and validity read (written) once, the image written (read) once."""
    from spark_rapids_tpu_torch.ops import row_conversion as rc
    n = table.num_rows
    schema = [c.dtype for c in table.columns]
    _, _, size = rc.row_layout(schema)
    widths = sum(d.itemsize() for d in schema)
    with_valid = sum(c.validity is not None for c in table.columns)
    ops_ = n * (size // 4) * RC_WORD_OPS
    return ((n * (widths + with_valid + size), ops_),
            (n * (size + widths + len(schema)), ops_))


def row_conversion_phase(torch, chk):
    """Phase 9: the reference bench's tables (216 columns general, 24
    fixed-width-optimized, and the 24 with 10% nulls; 1,048,576 rows)
    through `api.RowConversion` both ways, counters zeroed just before and
    read just after; each image equal to the plain version's byte for byte,
    each round trip equal to its input, validity included; timed."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch.ops import row_conversion as rc
    from spark_rapids_tpu_torch.ops import row_conversion_cuda as rcc

    t0 = time.perf_counter()
    tables = {"general 216": (rc_bench_table(torch, 216, RC_ROWS), False),
              "optimized 24": (rc_bench_table(torch, 24, RC_ROWS), True),
              "optimized 24, 10% nulls": (
                  rc_bench_table(torch, 24, RC_ROWS, 0.1), True)}
    torch.cuda.synchronize()
    log(f"row conversion: tables made ({time.perf_counter() - t0:.1f} s)")
    reset_kernel_counters()
    out = {}
    for what, (t, optimized) in tables.items():
        schema = [c.dtype for c in t.columns]
        if optimized:
            (rows,) = api.RowConversion.convertToRowsFixedWidthOptimized(t)
            back = api.RowConversion.convertFromRowsFixedWidthOptimized(
                rows, *schema)
        else:
            (rows,) = api.RowConversion.convertToRows(t)
            back = api.RowConversion.convertFromRows(rows, *schema)
        out[what] = (rows, back)
    torch.cuda.synchronize()
    counters = kernel_counters()
    launches = dict(counters["row_conversion"])
    require(launches == {"to_rows": 3, "from_rows": 3}
            and counted(counters) == 6,
            f"row conversion: counters {counters}")
    log(f"  main path: launches {launches}, plain runs "
        f"{counters['plain']['row_conversion']}")

    t0 = time.perf_counter()
    for what, (t, _) in tables.items():
        rows, back = out[what]
        schema = [c.dtype for c in t.columns]
        _, _, size = rc.row_layout(schema)
        image = rows.children[0].data
        chk.equal("rc_to_rows", image, rc.to_rows_plain(t), f"{what} image")
        want = rc.from_rows_plain(image.reshape(-1, size), schema)
        for i, (got, w, orig) in enumerate(zip(back.columns, want.columns,
                                               t.columns)):
            chk.equal("rc_from_rows", got.data, w.data, f"{what} column {i}")
            chk.equal("rc_from_rows", got.validity, w.validity,
                      f"{what} column {i} validity")
            chk.equal("rc_from_rows", got.data, orig.data,
                      f"{what} column {i} round trip")
            chk.equal("rc_from_rows", got.validity, orig.null_mask,
                      f"{what} column {i} round-trip validity")
    del out
    torch.cuda.synchronize()
    log(f"  images == plain version byte for byte, round trips == inputs "
        f"({time.perf_counter() - t0:.1f} s)")

    timing = {"to_rows": {}, "from_rows": {}}
    for what, (t, _) in tables.items():
        schema = [c.dtype for c in t.columns]
        _, _, size = rc.row_layout(schema)
        image = rcc.to_rows(t).reshape(-1, size)
        calls = {"to_rows": (lambda: rcc.to_rows(t),
                             lambda: rc.to_rows_plain(t)),
                 "from_rows": (lambda: rcc.from_rows(image, schema),
                               lambda: rc.from_rows_plain(image, schema))}
        for (direction, (kern, pl)), (nbytes, ops_) in zip(
                calls.items(), rc_bounds(t)):
            ms = device_ms(torch, kern, f"rc_{direction}_kernel", 20)
            cms = call_ms(torch, kern, 20)
            pms = time_cuda(torch, pl, 3)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_ / PEAK_INT_OPS_PER_S * 1e3
            timing[direction][what] = {
                "ms": ms, "call_ms": cms, "plain_ms": pms, "bytes": nbytes,
                "ops": ops_, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms)}
            log(f"  {what} {direction}: device {ms!r} ms, one call {cms!r} "
                f"ms, plain {pms!r} ms; bound {max(bytes_ms, ops_ms)!r} ms "
                f"({nbytes} B, {ops_} ops)")
        del image
    del tables
    torch.cuda.empty_cache()
    return {"launches": launches, "timing": timing}


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


def kernels_ms(torch, fn, prefix, iters):
    """Device ms a call of `fn` spends in the kernels whose names start
    with `prefix` (`device_by_name`, the L2 flushed before each call)."""
    _, by_name = device_by_name(torch, fn, iters)
    return sum(ms for name, ms in by_name.items() if name.startswith(prefix))


def select_topk_phase(torch, iters=30):
    """The fixed-width FusedSelect and TopK kernels' device ms at
    kernel_bench.py's 10M-row tables (as `fused_select_phase` and
    `topk_phase` build them) and at TPC-DS q3's own calls (recorded from
    one optimized run of the plan). Uses only what earlier trees' packages
    have too, so that one tree's script times another tree's kernels."""
    from spark_rapids_tpu_torch import dtypes as dt, nds_q3
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import select_cuda as sc
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.plan import PlanExecutor, col
    out = {}
    rng = np.random.default_rng(7)
    a_np = rng.integers(0, 100, N_ROWS).astype(np.int32)
    b_np = rng.integers(-5, 5, N_ROWS).astype(np.int32)
    v = Column.from_numpy(rng.integers(-2**40, 2**40, N_ROWS), dt.INT64,
                          rng.random(N_ROWS) > 0.1, device="cuda")
    pred = (col("a") < 10) & (col("b") > 0)
    for form, kind, npt in (("int32", dt.INT32, np.int32),
                            ("int64", dt.INT64, np.int64)):
        t = Table([Column.from_numpy(a_np.astype(npt), kind, device="cuda"),
                   Column.from_numpy(b_np.astype(npt), kind, device="cuda"),
                   v], ["a", "b", "v"])
        out[f"fused_select {form}"] = kernels_ms(
            torch, lambda: sc.fused_select_cuda(t, pred, ["a", "v"]), "fs_",
            iters)
    rng = np.random.default_rng(8)
    t = Table([Column.from_numpy(rng.integers(-10**6, 10**6, N_ROWS)
                                 .astype(np.int64), dt.INT64,
                                 rng.random(N_ROWS) > 0.05, device="cuda"),
               Column.from_numpy(rng.standard_normal(N_ROWS)
                                 .astype(np.float32), dt.FLOAT32,
                                 device="cuda")], ["k", "v"])
    for k in TOPK_LIMITS + (TOPK_LARGE_LIMIT,):
        out[f"topk k={k}"] = kernels_ms(
            torch, lambda: tc.topk_table_cuda(t, ["k", "v"], [False, True],
                                              k), "tk_", iters)
    del t, v
    # TPC-DS q3's own calls: its two FusedSelects and its TopK
    calls = []
    fs, tk = sc.fused_select_cuda, tc.topk_table_cuda

    def recording(name, fn):
        def call(*a, **kw):
            calls.append((name, fn, a, kw))
            return fn(*a, **kw)
        return call
    inputs = nds_q3.q3_tpcds_inputs(N_SALES, seed=0, device="cuda")
    sc.fused_select_cuda = recording("fs_", fs)
    tc.topk_table_cuda = recording("tk_", tk)
    try:
        PlanExecutor().execute(nds_q3.q3_tpcds_plan(), inputs)
    finally:
        sc.fused_select_cuda, tc.topk_table_cuda = fs, tk
    require([c[0] for c in calls].count("fs_") == 2
            and [c[0] for c in calls].count("tk_") == 1,
            f"TPC-DS q3 made {[c[0] for c in calls]}")
    for i, (prefix, fn, a, kw) in enumerate(calls):
        out[f"TPC-DS q3 {prefix}{i} ({a[0].num_rows} rows)"] = kernels_ms(
            torch, lambda: fn(*a, **kw), prefix, iters)
    log("  " + json.dumps(out))
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


def union_walls_phase(torch, runs):
    """NDS q5 and q23 at scale 1 alone, to compare two trees in one call
    (this script run from each tree's root): eager and capped, authored and
    optimized, one cold run each, then `runs` rounds of one warm run of
    each in turn, then one traced warm run each: the warm walls, the
    card's busy time, idle share and kernels by time."""
    from spark_rapids_tpu_torch import nds_q5, nds_q23
    from spark_rapids_tpu_torch.plan import PlanExecutor
    runs_of = {}
    for q, mod, caps in (("q5", nds_q5, Q5_CAPS), ("q23", nds_q23,
                                                   Q23_CAPS)):
        inputs = getattr(mod, f"{q}_inputs")(N_SALES, seed=0,
                                             device="cuda")
        plan = getattr(mod, f"{q}_plan")()
        for mode in ("eager", "capped"):
            for optimize in (False, True):
                ex = PlanExecutor(mode=mode, optimize=optimize,
                                  caps=dict(caps) if mode == "capped"
                                  else None)
                what = (f"{q} {mode} "
                        f"{'optimized' if optimize else 'authored'}")
                runs_of[what] = (ex, plan, inputs)
    return timed_walls(torch, runs_of, runs)


def timed_walls(torch, runs_of, runs):
    """{what: (executor, plan, inputs)}: one cold run each, then `runs`
    rounds of one warm run of each in turn, then one traced warm run each.
    Per plan: the warm walls (`PlanResult.wall_ms`), the whole `execute()`
    calls on the host's clock (`execute_ms`: the optimizer, the certifier
    and the store's recording included), their medians, and the traced
    run's busy ms, idle share and kernels by time."""
    out = {w: {"walls": [], "execute_ms": []} for w in runs_of}
    for ex, plan, inputs in runs_of.values():
        ex.execute(plan, inputs)
    torch.cuda.synchronize()
    for _ in range(runs):
        for what, (ex, plan, inputs) in runs_of.items():
            t0 = time.perf_counter()
            res = ex.execute(plan, inputs)
            out[what]["execute_ms"].append((time.perf_counter() - t0) * 1e3)
            out[what]["walls"].append(res.wall_ms)
    for what, (ex, plan, inputs) in runs_of.items():
        r = out[what]
        r["trace"] = traced_run(torch, lambda: ex.execute(plan, inputs))
        r["median_ms"] = float(np.median(r["walls"]))
        r["execute_median_ms"] = float(np.median(r["execute_ms"]))
        log(f"{what}: warm walls {r['walls']}, median {r['median_ms']!r} "
            f"ms; execute() {r['execute_ms']}, median "
            f"{r['execute_median_ms']!r} ms; traced: idle share "
            f"{r['trace']['idle_share']!r} ({r['trace']['busy_ms']!r} busy "
            f"of {r['trace']['wall_ms']!r} ms), top {r['trace']['top'][:5]}")
    return out


def plan_walls_phase(torch, runs):
    """The plans with keyed aggregates other than q5's and q23's alone, to
    compare two trees in one call (this script run from each tree's root):
    q3 (authored), TPC-DS q3 with INT32 keys and with its STRING i_brand,
    q72 and q74 (optimized) eager, and q3, TPC-DS q3 and q72 capped (the
    string plans raise there); one cold run each, then `runs` rounds of one
    warm run of each in turn, then one traced warm run each: the warm
    walls, the card's busy time, idle share and kernels by time."""
    from spark_rapids_tpu_torch import nds_q3, nds_q72, nds_q74
    from spark_rapids_tpu_torch.plan import PlanExecutor
    q3_in = nds_q3.q3_inputs(N_SALES, seed=0, device="cuda")
    tpcds_in = nds_q3.q3_tpcds_inputs(N_SALES, seed=0, device="cuda")
    str_in = {k: t.to("cuda") for k, t in nds_q3.q3_tpcds_strings_inputs(
        N_SALES, device="cpu").items()}
    q72_in = nds_q72.q72_inputs(N_SALES, seed=0, device="cuda")
    q74_in = nds_q74.q74_inputs(device="cuda", gen=nds_q74.datagen(seed=0))
    runs_of = {}
    for mode in ("eager", "capped"):
        for what, plan, inputs, optimize in (
                ("q3", nds_q3.q3_plan(), q3_in, False),
                ("TPC-DS q3", nds_q3.q3_tpcds_plan(), tpcds_in, True),
                ("TPC-DS q3 strings", nds_q3.q3_tpcds_strings_plan(), str_in,
                 True),
                ("q72", nds_q72.q72_plan(), q72_in, True),
                ("q74", nds_q74.q74_plan(), q74_in, True)):
            if mode == "capped" and what in ("TPC-DS q3 strings", "q74"):
                continue
            runs_of[f"{what} {mode}"] = (
                PlanExecutor(mode=mode, optimize=optimize), plan, inputs)
    return timed_walls(torch, runs_of, runs)


# ---- phase 12: the plan engine's feedback loop -------------------------------

FEEDBACK_RUNS = 5                  # replays (and eager-launch runs) timed
RANGE_CALLS = LAUNCH_CALLS + ("cudaMemsetAsync", "cudaMemcpyAsync")
KERNEL_KINDS = ("Filter", "FusedSelect", "HashJoin", "HashAggregate", "Sort",
                "TopK")            # the kinds that always launch on the card


def static_engine():
    """No stats store (where the package has one): the engine this
    script's earlier checks of attempts and caps were written for."""
    import contextlib
    try:
        from spark_rapids_tpu_torch.plan import stats
    except ImportError:            # an earlier tree, for A/B runs
        return contextlib.nullcontext()
    return stats.scoped_store(None)


def operator_trace(torch, fn, attempts=6):
    """The second of two runs of `fn` (a PlanResult) in one profiler
    session (`_traced_second_run`): per `plan.<label>` range, the launch
    calls inside it and the card's records of their correlation ids
    (kernels, copies, memsets), their busy ms (the union of their
    intervals) and kernel names. CUPTI drops a session's records at
    times: a trace is complete when every launch call inside a range has
    its record; an incomplete one is taken again, at most `attempts`
    times."""
    for _ in range(attempts):
        out = _operator_trace(torch, fn)
        if out["complete"]:
            break
    return out


def _traced_second_run(torch, fn):
    """`fn()` twice under one torch.profiler session with
    SPARK_RAPIDS_TORCH_TRACE=1, the second inside a `measured_run` range,
    since CUPTI keeps no record of some of a session's first launches:
    (the second run's result, the host events inside its range, the card's
    records by correlation id as (start ns, end ns, name))."""
    from torch.profiler import ProfilerActivity, profile, record_function
    prev = os.environ.get("SPARK_RAPIDS_TORCH_TRACE")
    os.environ["SPARK_RAPIDS_TORCH_TRACE"] = "1"
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("measured_run"):
                res = fn()
                torch.cuda.synchronize()
    finally:
        if prev is None:
            os.environ.pop("SPARK_RAPIDS_TORCH_TRACE", None)
        else:
            os.environ["SPARK_RAPIDS_TORCH_TRACE"] = prev
    dev, host = {}, []
    for k in prof.profiler.kineto_results.events():
        if str(k.device_type()).endswith("CUDA"):
            dev.setdefault(k.correlation_id(), []).append(
                (k.start_ns(), k.end_ns(), k.name()))
        else:
            host.append(k)
    (span,) = [(k.start_ns(), k.end_ns()) for k in host
               if k.name() == "measured_run"]
    host = [k for k in host if span[0] <= k.start_ns() <= span[1]]
    return res, host, dev


def _operator_trace(torch, fn):
    res, host, dev = _traced_second_run(torch, fn)
    ranges = [(k.name()[len("plan."):], k.start_ns(), k.end_ns())
              for k in host if k.name().startswith("plan.")]
    calls = [(k.start_ns(), k.correlation_id()) for k in host
             if k.name() in RANGE_CALLS]
    ops, missing = {}, 0
    for label, a, b in ranges:
        corr = [c for t, c in calls if a <= t <= b]
        recs = sorted(r for c in corr for r in dev.get(c, ()))
        missing += sum(c not in dev for c in corr)
        op = ops.setdefault(label, {"ranges": 0, "launches": 0,
                                    "records": 0, "busy_ms": 0.0,
                                    "kernels": {}})
        op["ranges"] += 1
        op["launches"] += len(corr)
        op["records"] += len(recs)
        op["busy_ms"] += busy_us([(s_ / 1e3, e_ / 1e3)
                                  for s_, e_, _ in recs]) / 1e3
        for _, _, name in recs:
            short = name.split("(")[0].removeprefix("void ")[:60]
            op["kernels"][short] = op["kernels"].get(short, 0) + 1
    return {"res": res, "ops": ops, "missing_records": missing,
            "complete": missing == 0 and any(o["launches"]
                                             for o in ops.values())}


def launch_counts():
    """Every kernel counter, flattened, with the plain-run counters apart."""
    c = kernel_counters()
    plain = c.pop("plain")
    return c, sum(v for d in plain.values() for v in d.values())


GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
# capped fuzz corpus cases that run (tests/test_torch_graphs.py's): joins,
# keyed aggregates, TopK, unions; each with its plain and edge tables
FUZZ_GRAPH_SEEDS = (0, 4, 6, 8, 17, 18)


def attempt_kernels(torch, fn, want=None, attempts=6):
    """The second of two runs of `fn` (a PlanResult) in one profiler
    session (`_traced_second_run`): the card's kernel records linked by
    correlation id to the calls inside the `plan.capped.attempt` ranges,
    by name, apart for kernel launches (`launched`) and graph launches
    (`graphed`), with the number of calls of each kind. Copies and memsets are left out. A trace
    is complete when every call has a record; an incomplete one is taken
    again, at most `attempts` times. CUPTI also drops some of a graph's
    records at times, which no call shows: with `want`, a trace whose
    `graphed` records differ from it is taken again too (a replay that
    launches other kernels never matches)."""
    for i in range(attempts):
        out = _attempt_kernels(torch, fn)
        if out["complete"] and (want is None or out["graphed"] == want):
            break
    out["tries"] = i + 1
    return out


def _attempt_kernels(torch, fn):
    res, host, dev = _traced_second_run(torch, fn)
    spans = [(k.start_ns(), k.end_ns()) for k in host
             if k.name() == "plan.capped.attempt"]
    out = {"launched": {}, "graphed": {}, "kernel_calls": 0,
           "graph_launches": 0, "missing": 0, "attempt_ranges": len(spans)}
    for k in host:
        name = k.name()
        if name in LAUNCH_CALLS:
            kind = "launched"
            out["kernel_calls"] += 1
        elif name in GRAPH_LAUNCH_CALLS:
            kind = "graphed"
            out["graph_launches"] += 1
        else:
            continue
        if not any(a <= k.start_ns() <= b for a, b in spans):
            continue
        recs = [r[2] for r in dev.get(k.correlation_id(), [])]
        out["missing"] += not recs
        for r in recs:
            if r.startswith(("Memcpy", "Memset")):
                continue
            short = r.split("(")[0].removeprefix("void ")[:70]
            out[kind][short] = out[kind].get(short, 0) + 1
    out["res"] = res
    out["complete"] = (out["missing"] == 0 and bool(spans)
                       and bool(out["launched"] or out["graphed"]))
    return out


def redraw_tables(tables, seed):
    """Tables of the same shape and layout with other rows, on the same
    device: each column's values drawn again from its own values, a
    validity drawn again where the column has one."""
    from spark_rapids_tpu_torch.columnar import Column, Table
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(tables):
        t = tables[name]
        cols = []
        for c in t.columns:
            data = c.data.cpu().numpy()
            valid = (None if c.validity is None
                     else rng.random(c.length) >= 0.15)
            cols.append(Column.from_numpy(rng.choice(data, c.length),
                                          c.dtype, valid, c.data.device))
        out[name] = Table(cols, names=list(t.names))
    return out


def graph_fuzz_new_data(torch):
    """Capped corpus cases on the card, one executor each: the case's
    tables three times (launched, captured, replayed), then two redraws of
    the same shape; each run bit-equal to a new executor's launched run of
    its tables at its final caps. Returns the runs that replayed."""
    from spark_rapids_tpu_torch.analysis import fuzz
    from spark_rapids_tpu_torch.plan import PlanExecutor
    from spark_rapids_tpu_torch.plan import stats
    out = {}
    with stats.scoped_store(None):
        for seed in FUZZ_GRAPH_SEEDS:
            for edge in (False, True):
                case = fuzz.gen_case(seed, device="cpu")
                tabs = (fuzz.edge_tables(case, device="cpu") if edge
                        else dict(case.tables))
                tabs = {k: t.to("cuda") for k, t in tabs.items()}
                opt = bool(seed % 2)
                ex = PlanExecutor(mode="capped", optimize=opt)
                what = f"fuzz seed {seed}{' edge' if edge else ''}"
                graphs = []
                for tables in (tabs, tabs, tabs, redraw_tables(tabs, 1),
                               redraw_tables(tabs, 2)):
                    r = ex.execute(case.plan, tables)
                    want = PlanExecutor(mode="capped", optimize=opt,
                                        caps=dict(r.caps)).execute(
                                            case.plan, tables)
                    require(not want.graph, f"{what}: a new executor "
                            "replayed")
                    same_tables(torch, r.compact(), want.compact(),
                                f"{what} run {len(graphs) + 1} vs a new "
                                "executor's launched run")
                    graphs.append(r.graph)
                require(graphs[:3] == [False, True, True],
                        f"{what}: graphs {graphs} ({r.graph_reason})")
                out[what] = graphs
    log(f"capped fuzz cases replayed over new tables of the same shape, "
        f"each run equal to a new executor's launched run (graph per run: "
        f"launched, captured, replayed, redraw 1, redraw 2): {out}")
    return out


def feedback_phase(torch, chk):
    """Phase 12 (module docstring): tracing ranges, the stats store, the
    resource certifier and each capped program replayed as a CUDA graph,
    at the existing scales."""
    from spark_rapids_tpu_torch import nds_q23, nds_q3, nds_q5, nds_q72
    from spark_rapids_tpu_torch import nds_q74
    from spark_rapids_tpu_torch.analysis import footprint
    from spark_rapids_tpu_torch.plan import PlanExecutor
    from spark_rapids_tpu_torch.plan import executor, stats
    out = {}

    # -- tracing: q72 eager, every operator in its range
    q72_in = nds_q72.q72_inputs(N_SALES, seed=0, device="cuda")
    with stats.scoped_store(None):
        ex = PlanExecutor()
        plain = ex.execute(nds_q72.q72_plan(), q72_in)
        tr = operator_trace(torch, lambda: ex.execute(nds_q72.q72_plan(),
                                                      q72_in))
    res = tr["res"]
    same_tables(torch, res.table, plain.table, "traced q72 vs untraced")
    labels = list(res.metrics)
    require(sorted(tr["ops"]) == sorted(labels)
            and all(o["ranges"] == 1 for o in tr["ops"].values()),
            f"q72 ranges {sorted(tr['ops'])} vs operators {labels}")
    require(tr["complete"], f"q72 trace: {tr['missing_records']} launches "
            "without their records")
    for label, m in res.metrics.items():
        o = tr["ops"][label]
        require(m.kind not in KERNEL_KINDS or o["records"] > 0,
                f"q72 {label}: no kernel linked to its range")
    out["trace_q72"] = {lbl: {k: v for k, v in o.items()}
                        for lbl, o in tr["ops"].items()}
    log("q72 eager, busy ms by operator (plan.<label> ranges, records "
        "linked by correlation id): " + ", ".join(
            f"{lbl} {o['busy_ms']:.4f} ({o['records']} records)"
            for lbl, o in tr["ops"].items()))
    for lbl, o in tr["ops"].items():
        log(f"  {lbl}: {o['busy_ms']!r} ms, kernels {o['kernels']}")

    # -- the store: q3 capped escalates once, a new executor starts warm
    inputs = nds_q3.q3_inputs(ESCALATION_ROWS, seed=0, device="cuda")
    with stats.scoped_store(stats.StatsStore(path="")):
        mk = lambda: PlanExecutor(mode="capped", optimize=False,  # noqa
                                  caps=dict(ESCALATION_CAPS),
                                  max_cap_attempts=ESCALATION_ATTEMPTS)
        first = mk().execute(nds_q3.q3_plan(), inputs)
        second = mk().execute(nds_q3.q3_plan(), inputs)
    require(first.attempts > 1 and second.attempts == 1
            and second.caps == first.caps,
            f"q3 from the store: attempts {first.attempts} then "
            f"{second.attempts}, caps {first.caps} then {second.caps}")
    chk.tables("plans", second.compact().to("cpu"),
               first.compact().to("cpu"), "q3 capped from the store")
    out["store_q3"] = {"rows": ESCALATION_ROWS,
                       "cold": {"attempts": first.attempts,
                                "caps": first.caps},
                       "warm": {"attempts": second.attempts,
                                "caps": second.caps}}
    log(f"q3 capped at {ESCALATION_ROWS} rows from {ESCALATION_CAPS}: "
        f"{first.attempts} attempts to {first.caps}; a new executor under "
        f"the same store: {second.attempts} attempt, equal table")
    tpcds_in = nds_q3.q3_tpcds_inputs(N_SALES, seed=0, device="cuda")
    out["store_eager"] = {}
    for what, plan_fn, ins in (("TPC-DS q3", nds_q3.q3_tpcds_plan,
                                tpcds_in),
                               ("q72", nds_q72.q72_plan, q72_in)):
        with stats.scoped_store(stats.StatsStore(path="")):
            r1 = PlanExecutor().execute(plan_fn(), ins)
            r2 = PlanExecutor().execute(plan_fn(), ins)
        same_tables(torch, r2.table, r1.table, f"{what} eager, warm vs cold")
        out["store_eager"][what] = [r1.optimizer["decision_sources"],
                                    r2.optimizer["decision_sources"]]
        log(f"{what} eager twice under a fresh store, equal; decision "
            f"sources cold {r1.optimizer['decision_sources']}, warm "
            f"{r2.optimizer['decision_sources']} (stats driven "
            f"{r2.optimizer['stats_driven']})")

    # -- the certifier and the graphs
    q5_in = nds_q5.q5_inputs(N_SALES, seed=0, device="cuda")
    q23_in = nds_q23.q23_inputs(N_SALES, seed=0, device="cuda")
    str_in = {k: t.to("cuda") for k, t in nds_q3.q3_tpcds_strings_inputs(
        N_SALES, device="cpu").items()}
    q74_in = nds_q74.q74_inputs(device="cuda", gen=nds_q74.datagen(seed=0))
    plans = (
        ("q3", nds_q3.q3_plan, nds_q3.q3_inputs(N_SALES, seed=0,
                                                device="cuda"), False, None),
        ("TPC-DS q3", nds_q3.q3_tpcds_plan, tpcds_in, True, None),
        ("q72", nds_q72.q72_plan, q72_in, True, None),
        ("q5", nds_q5.q5_plan, q5_in, True, Q5_CAPS),
        ("q23", nds_q23.q23_plan, q23_in, True, Q23_CAPS),
        ("TPC-DS q3 strings", nds_q3.q3_tpcds_strings_plan, str_in, True,
         None),
        ("q74", nds_q74.q74_plan, q74_in, True, None))
    # the plans replayed over seed 1's tables too, of the same shape
    new_inputs = {
        "TPC-DS q3": lambda seed: nds_q3.q3_tpcds_inputs(N_SALES, seed=seed,
                                                         device="cuda"),
        "q5": lambda seed: nds_q5.q5_inputs(N_SALES, seed=seed,
                                            device="cuda"),
        "q23": lambda seed: nds_q23.q23_inputs(N_SALES, seed=seed,
                                               device="cuda")}
    out["cert"], out["graphs"] = {}, {}
    for what, plan_fn, ins, opt, caps in plans:
        eager = PlanExecutor(optimize=opt).execute(plan_fn(), ins)
        bad = footprint.check_observed(eager.cert, eager)
        require(eager.cert is not None and bad is None,
                f"{what} eager: {bad}")
        cert = {"eager_root_rows": [eager.cert.root.rows_lo,
                                    eager.cert.root.rows_hi],
                "peak_bytes_hi": eager.cert.peak_bytes_hi,
                "unbounded": len(eager.cert.unbounded)}
        out["cert"][what] = cert
        if what in ("TPC-DS q3 strings", "q74"):
            log(f"{what} eager: observed rows inside the certificate "
                f"(capped: STRING keys raise there); {cert}")
            continue
        store = stats.StatsStore(path="")

        def make():
            return PlanExecutor(mode="capped", optimize=opt,
                                caps=None if caps is None else dict(caps))
        with stats.scoped_store(store):
            ex = make()
            reset_kernel_counters()
            cold = ex.execute(plan_fn(), ins)
            torch.cuda.synchronize()
            c_cold, p_cold = launch_counts()
            bad = footprint.check_observed(cold.cert, cold)
            require(bad is None, f"{what} capped: {bad}")
            tightened = {}
            for k, v in cold.caps.items():
                if ":" not in k:
                    continue
                i = int(k.split(":")[1])
                node = cold.plan.nodes[i]
                b = cold.cert.by_index[i]
                if getattr(node, k.split(":")[0]) is None \
                        and b.rows_hi == v:
                    tightened[node.label] = {"cap": k, "rows_hi": v}
            cert["capped_tightened"] = tightened
            log(f"{what}: observed rows inside the certificate on both "
                f"tiers; caps the certified rows tightened: "
                f"{tightened or 'none'} (caps {cold.caps})")
            want = cold.compact()
            require(not cold.graph and cold.attempts == 1 and p_cold == 0,
                    f"{what} cold: graph {cold.graph}, attempts "
                    f"{cold.attempts}, plain runs {p_cold}")
            # the capture: the wrappers run once, inside it, and count
            torch.cuda.synchronize()
            mem0 = (torch.cuda.memory_reserved(),
                    torch.cuda.memory_allocated())
            reset_kernel_counters()
            warm = ex.execute(plan_fn(), ins)
            torch.cuda.synchronize()
            mem1 = (torch.cuda.memory_reserved(),
                    torch.cuda.memory_allocated())
            c, p = launch_counts()
            require(warm.graph and warm.attempts == 1 and p == 0
                    and c == c_cold,
                    f"{what} capture: graph {warm.graph} "
                    f"({warm.graph_reason}), attempts {warm.attempts}, "
                    f"plain {p}, launches {c} vs cold {c_cold}")
            same_tables(torch, warm.compact(), want,
                        f"{what} captured run vs its launched run")
            # the replays run no wrapper: no launch from Python
            replays = []
            for i in range(FEEDBACK_RUNS):
                reset_kernel_counters()
                n0 = executor.GRAPH_COUNTS["replays"]
                r = ex.execute(plan_fn(), ins)
                torch.cuda.synchronize()
                c, p = launch_counts()
                require(r.graph and r.attempts == 1 and p == 0
                        and counted(c) == 0
                        and executor.GRAPH_COUNTS["replays"] == n0 + 1,
                        f"{what} replay {i + 1}: graph {r.graph} "
                        f"({r.graph_reason}), attempts {r.attempts}, plain "
                        f"{p}, launches from Python {c}")
                same_tables(torch, r.compact(), want,
                            f"{what} replay {i + 1} vs its launched run")
                replays.append(r)
            # what a replay launches, from the trace: the kernels the
            # launched run launched, each as often, all from one graph
            # launch inside the attempt's range
            k_launch = attempt_kernels(torch, lambda: make().execute(
                plan_fn(), ins))
            k_replay = attempt_kernels(torch, lambda: ex.execute(
                plan_fn(), ins), want=k_launch["launched"])
            require(k_launch["complete"] and k_replay["complete"]
                    and not k_launch["res"].graph and k_replay["res"].graph
                    and k_launch["launched"] and not k_launch["graphed"]
                    and k_replay["graph_launches"] == 1
                    and not k_replay["launched"]
                    and k_replay["graphed"] == k_launch["launched"],
                    f"{what}: a replay's kernels "
                    f"{ {k: v for k, v in k_replay.items() if k != 'res'} } "
                    f"vs a launched run's "
                    f"{ {k: v for k, v in k_launch.items() if k != 'res'} }")
            same_tables(torch, k_replay["res"].compact(), want,
                        f"{what} traced replay vs its launched run")
            launch_walls = []
            for _ in range(FEEDBACK_RUNS):
                e = make().execute(plan_fn(), ins)
                require(not e.graph and e.attempts == 1,
                        f"{what}: a new executor's run replayed")
                same_tables(torch, e.compact(), want,
                            f"{what} launched by a new executor")
                launch_walls.append(e.wall_ms)
            t_replay = traced_run(torch, lambda: ex.execute(plan_fn(), ins))
            t_launch = traced_run(torch, lambda: make().execute(plan_fn(),
                                                                ins))
            new_data = None
            if what in new_inputs:
                # other tables of the same shape replay the same graph
                ins1 = new_inputs[what](1)
                r1 = ex.execute(plan_fn(), ins1)
                with stats.scoped_store(None):
                    w1 = PlanExecutor(mode="capped", optimize=opt,
                                      caps=dict(r1.caps)).execute(
                                          plan_fn(), ins1)
                require(r1.graph and not w1.graph,
                        f"{what} seed 1: graph {r1.graph} "
                        f"({r1.graph_reason})")
                same_tables(torch, r1.compact(), w1.compact(),
                            f"{what} seed 1 replayed vs launched")
                r0 = ex.execute(plan_fn(), ins)
                require(r0.graph, f"{what} seed 0 again: {r0.graph_reason}")
                same_tables(torch, r0.compact(), want,
                            f"{what} seed 0 after seed 1, replayed")
                new_data = {"seed1_rows": r1.compact().num_rows,
                            "seed0_rows": want.num_rows,
                            "replayed_ms": r1.wall_ms,
                            "launched_ms": w1.wall_ms}
                del ins1
        require(t_replay["sync_calls"] <= t_replay["attempts"] + 1
                and t_replay["dtoh_copies"] <= t_replay["attempts"] + 1,
                f"{what}: a replayed run's host reads {t_replay}")
        replay_walls = [r.wall_ms for r in replays]
        g = {"cold_ms": cold.wall_ms, "capture_ms": warm.wall_ms,
             "replay_walls": replay_walls,
             "launch_walls": launch_walls,
             "replay_median_ms": float(np.median(replay_walls)),
             "launch_median_ms": float(np.median(launch_walls)),
             "capture_reserved_bytes": mem1[0] - mem0[0],
             "capture_allocated_bytes": mem1[1] - mem0[1],
             "replay_trace": t_replay, "launch_trace": t_launch,
             "launches": c_cold,
             "replay_kernels": k_replay["graphed"],
             "trace_tries": [k_launch["tries"], k_replay["tries"]],
             "new_data": new_data}
        out["graphs"][what] = g
        log(f"{what} capped: cold {cold.wall_ms!r} ms (launched), capture "
            f"{warm.wall_ms!r} (captured, replayed once), replays "
            f"{g['replay_walls']} median {g['replay_median_ms']!r}; "
            f"launched by a new executor {launch_walls} median "
            f"{g['launch_median_ms']!r}; idle share replayed "
            f"{t_replay['idle_share']!r} ({t_replay['busy_ms']!r} busy of "
            f"{t_replay['wall_ms']!r} ms), launched "
            f"{t_launch['idle_share']!r} ({t_launch['busy_ms']!r} of "
            f"{t_launch['wall_ms']!r}); host reads replayed "
            f"{t_replay['sync_calls']} syncs, {t_replay['dtoh_copies']} "
            f"copies; the capture reserved {g['capture_reserved_bytes']} "
            f"bytes (allocated {g['capture_allocated_bytes']}); a replay's "
            f"kernels from the trace, all in one graph launch and equal to "
            f"the launched run's: {k_replay['graphed']}; new tables: "
            f"{new_data}")
        del ex
    out["fuzz_new_data"] = graph_fuzz_new_data(torch)
    return out


# ---- phase 8: the plan fuzz corpus ------------------------------------------

FUZZ_PLAIN_SEEDS = range(48)       # tests/test_torch_fuzz_plain_{a,b,c,d}.py
FUZZ_EDGE_SEEDS = range(24)        # tests/test_torch_fuzz_edge_{a,b}.py
FUZZ_RUNS = tuple((mode, opt) for mode in ("eager", "capped")
                  for opt in (False, True))
FUZZ_JOIN_ROWS = (1_000_000, 10_000)   # left, right rows of the join check


def fuzz_run(case, tables, mode, optimize, device):
    """("ok", compacted Table on the CPU) or ("err", "Class: message")."""
    from spark_rapids_tpu_torch.plan import PlanExecutor
    try:
        res = PlanExecutor(mode=mode, optimize=optimize,
                           device=device).execute(case.plan, dict(tables))
        return "ok", res.compact().to("cpu")
    except Exception as e:       # parity includes error parity
        return "err", f"{type(e).__name__}: {e}"


def fuzz_add(total, counters):
    for k, v in counters.items():
        if isinstance(v, dict):
            fuzz_add(total.setdefault(k, {}), v)
        else:
            total[k] = total.get(k, 0) + v


def fuzz_c6(torch, chk):
    """Queue C6 on the card: `*` of a bool and a float (NaN, ±inf, -0.0)
    through FusedSelect plans, eager, authored and optimized (the
    optimizer fuses the Filter and Project), equal to the CPU run bit for
    bit; the kernel called directly against its plain version; False rows
    of b * f == 0.0 all kept."""
    from spark_rapids_tpu_torch import dtypes as tdt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import select, select_cuda
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col
    from spark_rapids_tpu_torch.plan import lit
    rng = np.random.default_rng(6)
    n = 100_003
    f = rng.choice(np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5]), n)
    b = rng.integers(0, 2, n).astype(bool)

    def table(device):
        return Table([Column.from_numpy(b, tdt.BOOL, device=device),
                      Column.from_numpy(f, tdt.FLOAT64, device=device),
                      Column.from_numpy(f.astype(np.float32), tdt.FLOAT32,
                                        device=device),
                      Column.from_numpy(np.arange(n, dtype=np.int64),
                                        tdt.INT64, device=device)],
                     ["b", "f", "g", "i"])
    preds = [col("b") * col("f") == 0.0, col("f") * col("b") <= lit(0.0),
             col("b") * col("g") == 0.0, col("g") * col("b") + 1.0 > 0,
             lit(False) * col("f") == 0.0,
             (col("b") * lit(float("nan"))) == 0.0]
    t_gpu, t_cpu = table("cuda"), table("cpu")
    launches = 0
    for k, pred in enumerate(preds):
        got = select_cuda.fused_select_cuda(t_gpu, pred, ["i", "f"])
        chk.tables("fused_select", got,
                   select.fused_select_plain(t_gpu, pred, ["i", "f"]),
                   f"C6 kernel {pred!r}")
        plan = (PlanBuilder().scan("t", schema=["b", "f", "g", "i"])
                .filter(pred).project([("i", col("i")),
                                       ("y", col("b") * col("f"))])
                .build())
        for opt in (False, True):
            reset_kernel_counters()
            res = PlanExecutor(optimize=opt).execute(plan, {"t": t_gpu})
            launches += select_cuda.LAUNCHES["count"]
            require(counted(kernel_counters()["plain"]) == 0,
                    f"C6 plan {pred!r}: a plain version ran")
            want = PlanExecutor(optimize=opt, device="cpu").execute(
                plan, {"t": t_cpu})
            chk.tables("fuzz", res.table.to("cpu"), want.table,
                       f"C6 plan {pred!r} optimize={opt}")
            if k == 0:
                kept = res.table["i"].data.cpu().numpy()
                require(np.array_equal(kept, np.nonzero(~b | (f == 0))[0]),
                        "C6: b * f == 0.0 must keep every False row")
                y = res.table["y"].data.cpu().numpy()
                require(not np.signbit(y[~b[kept]]).any(),
                        "C6: False * x must be +0.0")
    require(launches >= len(preds), f"C6 plans ran {launches} FusedSelect "
            f"counts, expected one per optimized plan")
    log(f"fuzz C6: {len(preds)} bool x float predicates, kernel and "
        f"plans equal to the CPU; {launches} FusedSelect count launches")
    return launches


def fuzz_joins(torch, chk):
    """The torch-op joins of ops/join.py (left, full, the capped left join,
    and every join's null_equal both ways) on CUDA tensors at 1M left rows
    against 10,000 right rows, with null keys and alive masks, each equal
    to the CPU run element for element."""
    from spark_rapids_tpu_torch import dtypes as tdt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import join
    nl, nr = FUZZ_JOIN_ROWS
    rng = np.random.default_rng(21)
    lk = rng.integers(0, 2 * nr, nl).astype(np.int64)
    rk = rng.integers(0, 2 * nr, nr).astype(np.int64)
    # 5% null left keys, 1% right: under null_equal 50,000 x 100 pairs
    lv, rv = rng.random(nl) > 0.05, rng.random(nr) > 0.01
    la, ra = rng.random(nl) > 0.2, rng.random(nr) > 0.2
    out = {}
    t0 = time.perf_counter()
    for fn in ("inner_join", "left_join", "full_join", "left_semi_join",
               "left_anti_join", "inner_join_capped", "left_join_capped",
               "semi_join_mask"):
        for ne in (False, True):
            res = {}
            for device in ("cuda", "cpu"):
                lc = [Column.from_numpy(lk, tdt.INT64, lv, device=device)]
                rc = [Column.from_numpy(rk, tdt.INT64, rv, device=device)]
                f = getattr(join, fn)
                alive = dict(lalive=torch.tensor(la, device=device),
                             ralive=torch.tensor(ra, device=device),
                             null_equal=ne)
                if fn.endswith("_capped"):
                    r = f(lc, rc, 2 * nl, **alive)
                elif fn == "semi_join_mask":
                    r = (f(lc, rc, **alive),)
                else:
                    r = f(lc, rc, ne)
                    r = r if isinstance(r, tuple) else (r,)
                res[device] = [x.data if isinstance(x, Column) else x
                               for x in r]
            for i, (g, w) in enumerate(zip(res["cuda"], res["cpu"])):
                require(g.is_cuda, f"{fn}: output {i} left the card")
                chk.equal("fuzz", g.cpu(), w,
                          f"{fn}(null_equal={ne}) output {i}")
            out[f"{fn} null_equal={ne}"] = int(res["cuda"][0].shape[0])
    log(f"fuzz joins: {len(out)} calls at {nl:,} x {nr:,} rows equal to "
        f"the CPU in {time.perf_counter() - t0:.1f} s; output rows {out}")
    return out


def fuzz_phase(torch, chk):
    """The port's plan fuzz corpus on the card (`analysis/fuzz.py`): the
    tier-1 corpus, seeds 0-47 over the generator's tables and 0-23 over
    `edge_tables`, each case eager and capped, authored and optimized,
    with SPARK_RAPIDS_TORCH_VERIFY_PLANS on, every kernel counter zeroed
    just before each card run and read just after. Each card run equals
    the port's CPU run of the same case bit for bit (an error by its
    class), and no plain version runs on the card. Then C6 and the join
    functions."""
    from spark_rapids_tpu_torch.analysis import fuzz
    prev = os.environ.get("SPARK_RAPIDS_TORCH_VERIFY_PLANS")
    os.environ["SPARK_RAPIDS_TORCH_VERIFY_PLANS"] = "1"
    try:
        launches = {"eager": {}, "capped": {}}
        outcomes = {"ok": 0, "err": 0, "empty": 0}
        failures = []          # every differing run, reported together
        t0 = time.perf_counter()
        card_s = 0.0
        for edge, seeds in ((False, FUZZ_PLAIN_SEEDS),
                            (True, FUZZ_EDGE_SEEDS)):
            for seed in seeds:
                cpu_case = fuzz.gen_case(seed, device="cpu")
                cpu_tabs = (fuzz.edge_tables(cpu_case, device="cpu")
                            if edge else cpu_case.tables)
                gpu_tabs = {k: t.to("cuda") for k, t in cpu_tabs.items()}
                for mode, opt in FUZZ_RUNS:
                    what = (f"fuzz seed {seed}{' edge' if edge else ''} "
                            f"{mode} optimize={opt}")
                    want = fuzz_run(cpu_case, cpu_tabs, mode, opt, "cpu")
                    reset_kernel_counters()
                    c0 = time.perf_counter()
                    got = fuzz_run(cpu_case, gpu_tabs, mode, opt, "cuda")
                    torch.cuda.synchronize()
                    card_s += time.perf_counter() - c0
                    counters = kernel_counters()
                    require(counted(counters["plain"]) == 0,
                            f"{what}: a plain version ran on the card: "
                            f"{counters['plain']}")
                    fuzz_add(launches[mode],
                             {k: v for k, v in counters.items()
                              if k != "plain"})
                    outcomes[got[0]] += 1
                    if got[0] != want[0] or (got[0] == "err" and (
                            got[1].split(":")[0] != want[1].split(":")[0])):
                        failures.append(
                            f"{what}: card {got[0]} "
                            f"{got[1] if got[0] == 'err' else ''} vs CPU "
                            f"{want[0]} {want[1] if want[0] == 'err' else ''}")
                    elif got[0] == "ok":
                        outcomes["empty"] += got[1].num_rows == 0
                        try:
                            chk.tables("fuzz", got[1], want[1], what)
                        except AssertionError as e:
                            failures.append(str(e))
        wall = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop("SPARK_RAPIDS_TORCH_VERIFY_PLANS", None)
        else:
            os.environ["SPARK_RAPIDS_TORCH_VERIFY_PLANS"] = prev
    runs = (len(FUZZ_PLAIN_SEEDS) + len(FUZZ_EDGE_SEEDS)) * len(FUZZ_RUNS)
    for f in failures:
        log(f"FUZZ MISMATCH {f}")
    require(not failures, f"fuzz: {len(failures)} of {runs} card runs "
            f"differ from the CPU run")
    e, c = launches["eager"], launches["capped"]
    reached = {"fused_select": e.get("fused_select", {}),
               "hash_join": e.get("hash_join", {}),
               "hash_join_capped": c.get("hash_join_capped", {}),
               "topk": e.get("topk", {}), "topk_capped": c.get("topk", {}),
               "groupby": {"eager": e.get("groupby", {}).get("groupby", 0),
                           "capped": c.get("groupby", {}).get("groupby",
                                                              0)}}
    log(f"fuzz: {runs} card runs of {len(FUZZ_PLAIN_SEEDS)} plain and "
        f"{len(FUZZ_EDGE_SEEDS)} edge cases, each equal to its CPU run "
        f"({outcomes}); corpus wall {wall:.1f} s, card runs "
        f"{card_s:.1f} s; no plain version ran")
    log(f"fuzz launches: {json.dumps(reached)}")
    require(sum(reached["fused_select"].values()) > 0
            and sum(reached["hash_join"].values()) > 0
            and sum(reached["topk"].values()) > 0
            and sum(reached["groupby"].values()) > 0,
            f"the fuzz corpus did not reach every kernel: {reached}")
    c6 = fuzz_c6(torch, chk)
    joins = fuzz_joins(torch, chk)
    return {"runs": runs, "outcomes": outcomes, "wall_s": wall,
            "card_s": card_s, "launches": launches, "reached": reached,
            "c6_fused_select_counts": c6, "joins": joins}


# ---- phase 10: string, DECIMAL128 and float keys ------------------------------

KEYS_LIMIT_ROWS = 100                  # TPC-DS q3's and q74's `limit 100`
KEYS_CPU_SCALE = 10                    # the CPU comparisons at 1/10 scale
EDGE_STRINGS = ["", "a", "a\x00", "ab", "abc", "abcd", "abcdefgh",
                "abcdefghi", "é", "é", "日本語", "日本", "prefix_1",
                "prefix_12", "prefix_123", b"\xff\xfe", b"\x80", b"\x7f",
                "x" * 100, "y" * 33, "Z"]
DEC_EDGES = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64, -2 ** 64,
             2 ** 96 + 5, 2 ** 32 - 1, -2 ** 32]
# floats by their bits: +-0.0, NaNs of four payloads (quiet and signalling,
# both signs), +-inf, and ordinary values
F32_EDGES = (0x00000000, 0x80000000, 0x7FC00000, 0x7FC00001, 0xFFC00000,
             0x7F800001, 0x7F800000, 0xFF800000, 0x3FC00000, 0xBFC00000,
             0x40500000)
F64_EDGES = (0x0, 0x8000000000000000, 0x7FF8000000000000,
             0x7FF8000000000001, 0xFFF8000000000000, 0x7FF0000000000001,
             0x7FF0000000000000, 0xFFF0000000000000, 0x3FF8000000000000,
             0xBFF8000000000000, 0x400A000000000000)
# a string hashes one murmur3 round a 4-byte block or tail byte (about 10
# integer instructions each, csrc/hash_join.cu mm_round) and an fmix (12)
MM_ROUND_OPS, MM_FMIX_OPS = 10, 12


def vocab_strings(torch, vocab, idx, valid=None, device="cuda"):
    """A STRING column: row i holds vocab[idx[i]]'s bytes (a null row
    keeps them too), null where `valid` is False."""
    import dataclasses
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops.gather import take
    words = Column.from_pylist(list(vocab), dt.STRING, device=device)
    col = take(words, torch.from_numpy(np.asarray(idx, np.int64)).to(device),
               _has_negative=False)
    return dataclasses.replace(col, validity=None if valid is None else
                               torch.from_numpy(valid).to(device))


def float_column(torch, bits, idx, valid, width):
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    u = np.array(bits, np.uint32 if width == 4 else np.uint64)[idx]
    f = u.view(np.float32 if width == 4 else np.float64)
    return Column.from_numpy(f, dt.FLOAT32 if width == 4 else dt.FLOAT64,
                             valid, device="cuda")


def decimal_column(torch, values, idx, valid):
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    u = np.array([int(v) % (1 << 128) for v in values], dtype=object)
    limbs = np.stack([((u >> (32 * j)) & 0xFFFFFFFF).astype(np.uint32)
                      for j in range(4)], axis=1).reshape(len(values), 4)
    return Column.from_numpy(limbs[idx], dt.decimal(38, 2), valid,
                             device="cuda")


def random_decimals(rng, n):
    """n distinct-ish 38-digit values of every magnitude, both signs."""
    mag = rng.integers(1, 10 ** 18, n).astype(object) * 10 ** 18 \
        + rng.integers(0, 10 ** 18, n).astype(object)
    shift = rng.integers(0, 38, n)
    vals = [int(m) // 10 ** int(s) for m, s in zip(mag, shift)]
    return [v if rng.random() < 0.5 else -v for v in vals] + DEC_EDGES


def var_join_cases(torch, chk, rng):
    """The variable-width hash-join kernels against their plain versions
    and the sort-based join on the card, both routes: `check_case` on
    every edge the kernels must get right."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import join
    from spark_rapids_tpu_torch.ops import join_cuda as jc

    def draws(nb, npr, nv, nmiss, null_p):
        bi = rng.integers(0, nv, nb)
        pi = rng.integers(0, nv + nmiss, npr)
        return (bi, rng.random(nb) >= null_p, pi, rng.random(npr) >= null_p)

    cases = []
    # strings, small route: the edge strings, some twice, nulls both sides
    vocab = EDGE_STRINGS + [f"miss{i}" for i in range(40)]
    bi, bv, pi, pv = draws(300, 100_003, len(EDGE_STRINGS), 40, 0.05)
    cases.append(("strings, small route",
                  [vocab_strings(torch, vocab, pi, pv)],
                  [vocab_strings(torch, vocab, bi, bv)]))
    # strings, large route: 50,000 customer ids and 2,000 repeats, probed
    # by 1,000,003 rows, a sixth of them misses
    ids = [f"AAAAAAAA{i:08X}" for i in range(60_000)]
    bi = np.concatenate([np.arange(50_000), rng.integers(0, 50_000, 2_000)])
    pi = rng.integers(0, 60_000, 1_000_003)
    cases.append(("strings, large route",
                  [vocab_strings(torch, ids, pi, rng.random(pi.shape[0])
                                 >= 0.05)],
                  [vocab_strings(torch, ids, bi, rng.random(bi.shape[0])
                                 >= 0.05)]))
    # an all-empty chars buffer (its pointer may be null)
    bi, bv, pi, pv = draws(100, 1_000, 1, 0, 0.1)
    cases.append(("empty strings", [vocab_strings(torch, [""], pi, pv)],
                  [vocab_strings(torch, [""], bi, bv)]))
    for width, edges in ((4, F32_EDGES), (8, F64_EDGES)):
        bi, bv, pi, pv = draws(300, 100_003, len(edges) - 2, 2, 0.05)
        cases.append((f"float{8 * width} +-0.0 and NaN payloads, small route",
                      [float_column(torch, edges, pi, pv, width)],
                      [float_column(torch, edges, bi, bv, width)]))
        vals = np.concatenate([np.array(edges, np.uint64),
                               rng.integers(0, 2 ** 20, 60_000).astype(
                                   np.uint64) << np.uint64(32 if width == 8
                                                           else 8)])
        if width == 4:
            vals &= np.uint64(0xFFFFFFFF)
        bi, bv, pi, pv = draws(52_000, 1_000_003, 50_000, 10_000, 0.05)
        cases.append((f"float{8 * width}, large route",
                      [float_column(torch, vals, pi, pv, width)],
                      [float_column(torch, vals, bi, bv, width)]))
    dvals = DEC_EDGES + [3, -3, 10 ** 20]
    bi, bv, pi, pv = draws(300, 100_003, len(DEC_EDGES), 3, 0.05)
    cases.append(("DECIMAL128 +-(10^38 - 1), small route",
                  [decimal_column(torch, dvals, pi, pv)],
                  [decimal_column(torch, dvals, bi, bv)]))
    dvals = random_decimals(rng, 60_000)
    bi, bv, pi, pv = draws(52_000, 1_000_003, 50_000, 10_000, 0.05)
    cases.append(("DECIMAL128, large route",
                  [decimal_column(torch, dvals, pi, pv)],
                  [decimal_column(torch, dvals, bi, bv)]))
    # two keys of the new kinds with an integer, both routes
    bi, bv, pi, pv = draws(400, 100_003, len(EDGE_STRINGS), 10, 0.05)
    ints = np.arange(len(EDGE_STRINGS) + 10, dtype=np.int32) % 3
    cases.append(("(STRING, INT32), small route",
                  [vocab_strings(torch, vocab, pi, pv),
                   Column.from_numpy(ints[pi], dt.INT32, device="cuda")],
                  [vocab_strings(torch, vocab, bi, bv),
                   Column.from_numpy(ints[bi], dt.INT32, device="cuda")]))
    bi, bv, pi, pv = draws(52_000, 1_000_003, 50_000, 10_000, 0.05)
    f64 = rng.integers(0, 2 ** 10, 60_000).astype(np.uint64) << np.uint64(50)
    cases.append(("(DECIMAL128, FLOAT64), large route",
                  [decimal_column(torch, dvals, pi, pv),
                   float_column(torch, f64, pi, None, 8)],
                  [decimal_column(torch, dvals, bi, bv),
                   float_column(torch, f64, bi, None, 8)]))
    for what, p, b in cases:
        jc.reset_counters()
        total = check_case(chk, jc, join, p, b, what, suffix="_var")
        require(jc.VAR_LAUNCHES == {"build": 1, "count": 1, "emit": 1,
                                    "exists": 1, "capped": 0} or total == 0,
                f"{what}: launches {jc.VAR_LAUNCHES}")
        log(f"  hash join {what}: {p[0].length} x {b[0].length} -> "
            f"{total} pairs, large route "
            f"{jc.is_large(jc._capacity(b[0].length))}; kernel == plain "
            f"== sort-based join")
    # the capped form: the live masks read beside the keys
    for what, p, b in cases[:2] + cases[3:4] + cases[7:8]:
        la = torch.rand(p[0].length, device="cuda") < 0.7
        ra = torch.rand(b[0].length, device="cuda") < 0.7
        capped_join_cases(torch, chk, jc, join, p, b, p[0].length, la, ra,
                          f"{what}, alive masks")
    return len(cases)


def key_topk_cases(torch, chk, rng):
    """The TopK kernels with STRING and DECIMAL128 keys against the plain
    version (the stable sort and slice) on the card: both directions,
    with nulls, mixed with an integer key, both routes; a string key past
    the word limit declines."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import topk
    from spark_rapids_tpu_torch.ops import topk_cuda as tc

    n = 1_000_003
    vocab = EDGE_STRINGS + [f"AAAAAAAA{i:08X}" for i in range(20_000)]
    t = Table([vocab_strings(torch, vocab, rng.integers(0, len(vocab), n),
                             rng.random(n) >= 0.05),
               decimal_column(torch, random_decimals(rng, 5_000),
                              rng.integers(0, 5_010, n),
                              rng.random(n) >= 0.05),
               Column.from_numpy(rng.integers(0, 4, n).astype(np.int32),
                                 dt.INT32, device="cuda")],
              ["s", "d", "i"])
    runs = 0
    routes = {}
    for keys, asc in ((["s"], [True]), (["s"], [False]), (["d"], [False]),
                      (["d"], [True]), (["d", "s"], [True, False]),
                      (["i", "s"], [True, True])):
        for k in (1, 100, 3_000):
            tc.reset_counters()
            got = tc.topk_table_cuda(t, keys, asc, k)
            route = "threshold" if tc.LAUNCHES["threshold"] else "tile"
            routes[f"{keys} {asc} k={k}"] = route
            chk.tables("topk_keys", got, topk.topk_plain(t, keys, asc, k),
                       f"topk {keys} {asc} k={k}")
            runs += 1
    torch.cuda.synchronize()
    require("tile" in routes.values() and "threshold" in routes.values(),
            f"string/decimal TopK took one route only: {routes}")
    # one key of 8 * (MAX_WORDS - 2) + 1 bytes: 95 chars words, its length
    # and the row index are 97 words
    long = Table([Column.from_pylist(["q" * (8 * (topk.MAX_WORDS - 2) + 1)],
                                     dt.STRING, device="cuda")], ["s"])
    sig = topk.make_signature(long, ["s"], [True], 1, "eager")
    require(not topk.supports(sig), "a 97-word tuple is taken")
    try:
        tc.topk_table_cuda(long, ["s"], [True], 1)
        raise AssertionError("a 97-word tuple launched")
    except ValueError:
        pass
    log(f"  TopK with STRING and DECIMAL128 keys: {runs} calls at "
        f"{n} rows equal the plain version (routes {sorted(set(routes.values()))}); "
        f"a 97-word tuple declines")
    return runs


def key_select_cases(torch, chk, rng):
    """FusedSelect with STRING and DECIMAL128 payloads against the plain
    version on the card, at row counts off the kernel's tiling."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import select
    from spark_rapids_tpu_torch.ops import select_cuda as sc
    from spark_rapids_tpu_torch.plan import col

    runs = 0
    vocab = EDGE_STRINGS + [f"name{i}" for i in range(1000)]
    for n in (1, 1023, 2049, 1_000_003):
        t = Table([Column.from_numpy(rng.integers(0, 1000, n).astype(
                       np.int32), dt.INT32, device="cuda"),
                   vocab_strings(torch, vocab, rng.integers(0, len(vocab), n),
                                 rng.random(n) >= 0.05),
                   decimal_column(torch, random_decimals(rng, 100),
                                  rng.integers(0, 110, n),
                                  rng.random(n) >= 0.05),
                   Column.from_numpy(rng.integers(-5, 5, n), dt.INT64,
                                     device="cuda")],
                  ["p", "s", "d", "v"])
        for pred in (col("p") < 500, col("p") >= 0, col("p") < -1):
            for needed in (["s", "d", "v"], ["s"], ["d", "p"]):
                got = sc.fused_select_cuda(t, pred, needed)
                chk.tables("fused_select_keys", got,
                           select.fused_select_plain(t, pred, needed),
                           f"fused_select {pred!r} -> {needed} at {n} rows")
                runs += 1
    torch.cuda.synchronize()
    log(f"  FusedSelect with STRING and DECIMAL128 payloads: {runs} calls "
        f"equal the plain version")
    return runs


def float_join_plan(torch):
    """Queue C 7: an inner join on FLOAT64 keys through `PlanExecutor()` on
    the card, [0.0, -0.0, NaN, 1.5] x [-0.0, NaN, 2.0]: three pairs, as the
    CPU run gives them."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor

    def inputs(device):
        return {"a": Table([Column.from_pylist([0.0, -0.0, float("nan"), 1.5],
                                               dt.FLOAT64, device=device)],
                           ["x"]),
                "b": Table([Column.from_pylist([-0.0, float("nan"), 2.0],
                                               dt.FLOAT64, device=device)],
                           ["y"])}
    b = PlanBuilder()
    plan = b.scan("a", schema=["x"]).join(b.scan("b", schema=["y"]),
                                          left_on="x", right_on="y").build()
    jc.reset_counters()
    res = PlanExecutor().execute(plan, inputs("cuda"))
    torch.cuda.synchronize()
    cpu = PlanExecutor(device="cpu").execute(plan, inputs("cpu"))
    require(res.table.num_rows == 3 == cpu.table.num_rows
            and jc.VAR_LAUNCHES["count"] == 1
            and [m.kernel for m in res.metrics.values()
                 if m.kind == "HashJoin"] == ["cuda:hash_join"],
            f"float-key join: {res.table.num_rows} rows, var launches "
            f"{jc.VAR_LAUNCHES}")
    for a, c in zip(res.table.columns, cpu.table.columns):
        require(torch.equal(a.data.cpu().view(torch.int64),
                            c.data.view(torch.int64)),
                "float-key join differs from the CPU run")
    log("  queue C 7: the FLOAT64 inner join [0.0, -0.0, NaN, 1.5] x "
        "[-0.0, NaN, 2.0] runs on the hash-join kernels: 3 pairs, equal to "
        "the CPU run")


def same_tables(torch, got, want, what):
    """Two tables equal on the host: names, rows, every column's buffers
    (floats as their bits, so NaN payloads compare) and null masks."""
    require(got.names == want.names and got.num_rows == want.num_rows,
            f"{what}: {got.names} x {got.num_rows} vs {want.names} x "
            f"{want.num_rows}")
    bits = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.uint32: torch.int32}
    for name, a, b in zip(got.names, got.columns, want.columns):
        a, b = a.to("cpu"), b.to("cpu")
        for x, y in ((a.data, b.data), (a.offsets, b.offsets),
                     (a.null_mask, b.null_mask)):
            if x is not None and x.dtype in bits:
                x, y = x.view(bits[x.dtype]), y.view(bits[y.dtype])
            require((x is None) == (y is None)
                    and (x is None or torch.equal(x, y)),
                    f"{what}: column {name} differs")


def capped_keys_plans(torch, chk):
    """DECIMAL128 and float keys through the capped tier on the card (a
    join on a DECIMAL128 key, a FLOAT64-keyed aggregate, TopK on a
    DECIMAL128 key), equal to the eager run on the card and the CPU's
    capped run; a STRING key raises TypeError there, naming the limit."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch import nds_q74
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col

    rng = np.random.default_rng(31)
    n, m = 200_000, 5_000
    dvals = random_decimals(rng, m - len(DEC_EDGES))
    fk = rng.integers(0, 50, n).astype(np.uint64) << np.uint64(52)

    def inputs(device):
        di = rng_f.integers(0, m + 100, n)
        dv = rng_f.random(n) >= 0.05
        f = torch.from_numpy(fk.view(np.float64).copy())
        f[::7] = -0.0
        f[::11] = float("nan")
        fact = Table([decimal_column(torch, dvals + [7] * 100, di, dv
                                     ).to(device),
                      Column(dt.FLOAT64, n, f.to(device)),
                      Column.from_numpy(rng_f.integers(0, 100, n), dt.INT64,
                                        device=device)], ["k", "f", "v"])
        dim = Table([decimal_column(torch, dvals, np.arange(m), None
                                    ).to(device),
                     Column.from_numpy(np.arange(m), dt.INT64,
                                       device=device)], ["dk", "w"])
        return {"fact": fact, "dim": dim}
    b = PlanBuilder()
    j = b.scan("fact", schema=["k", "f", "v"]).join(
        b.scan("dim", schema=["dk", "w"]), left_on="k", right_on="dk")
    plans = {"join + float-keyed aggregate": j.aggregate(
                 ["f"], [("v", "sum", "s"), ("w", "max", "mw")]).build(),
             "join + DECIMAL128 TopK": j.filter(col("v") > 10).sort(
                 ["k", "v"], ascending=[False, True]).limit(100).build()}
    out = {}
    for what, plan in plans.items():
        rng_f = np.random.default_rng(32)
        card = inputs("cuda")
        rng_f = np.random.default_rng(32)
        host = inputs("cpu")
        reset_kernel_counters()
        capped = PlanExecutor(mode="capped").execute(plan, card)
        torch.cuda.synchronize()
        counters = kernel_counters()
        require(counted(counters["plain"]) == 0
                and counters["hash_join_capped"]["join"] >= 1,
                f"capped {what}: counters {counters}")
        eager = PlanExecutor().execute(plan, card)
        cpu = PlanExecutor(mode="capped", device="cpu").execute(plan, host)
        got = capped.compact()
        same_tables(torch, got, eager.table, f"capped {what} vs eager")
        same_tables(torch, got, cpu.compact(), f"capped {what} vs CPU")
        out[what] = {"rows": got.num_rows, "attempts": capped.attempts,
                     "stamps": sorted(m.kernel for m in
                                      capped.metrics.values() if m.kernel)}
        log(f"  capped {what}: {got.num_rows} rows in {capped.attempts} "
            f"attempt(s), equal to the eager run and the CPU's capped run; "
            f"stamps {out[what]['stamps']}")
    small = nds_q74.q74_inputs(20_000, 5_000, 1_000, seed=3, device="cuda")
    try:
        PlanExecutor(mode="capped").execute(nds_q74.q74_plan(), small)
        raise AssertionError("a capped STRING key ran")
    except TypeError as e:
        require("max_string_length" in str(e), f"capped string key: {e}")
        out["string key"] = str(e)
    log("  capped STRING key: TypeError naming the reference's limit")
    return out


def keyed_aggregates_card(torch):
    """Group keys of the new kinds and string min/max on the card: STRING
    and DECIMAL128 keys, a string column's min, max and both (one group
    all null), through the groupby kernel, equal to the CPU run."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column, Table
    from spark_rapids_tpu_torch.ops import aggregate
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    rng = np.random.default_rng(41)
    n = 200_003
    vocab = EDGE_STRINGS + [f"name{i}" for i in range(500)]
    key = rng.integers(0, 50, n)
    sv = rng.random(n) >= 0.1
    sv[key == 7] = False                        # an all-null group
    t = Table([vocab_strings(torch, vocab, rng.integers(0, len(vocab), n),
                             rng.random(n) >= 0.05),
               decimal_column(torch, random_decimals(rng, 40),
                              rng.integers(0, 50, n), None),
               Column.from_numpy(key, dt.INT64, device="cuda"),
               vocab_strings(torch, vocab, rng.integers(0, len(vocab), n),
                             sv)], ["s", "d", "k", "v"])
    host = Table([c.to("cpu") for c in t.columns], list(t.names))
    cases = ((["s"], [("k", "sum"), ("v", "min")]),
             (["d"], [("v", "max"), ("k", "count")]),
             (["k"], [("v", "min"), ("v", "max"), ("v", "count")]),
             (["s", "d"], [("v", "max"), ("v", "min")]))
    for keys, aggs in cases:
        gc.reset_counters()
        got = aggregate.groupby_aggregate(t, keys, aggs)
        require(gc.LAUNCHES["groupby"] == 1
                and gc.PLAIN_CALLS["groupby"] == 0,
                f"groupby {keys} {aggs}: {gc.LAUNCHES} {gc.PLAIN_CALLS}")
        same_tables(torch, got, aggregate.groupby_aggregate(host, keys, aggs),
                    f"groupby {keys} {aggs}")
    log(f"  groupby on STRING and DECIMAL128 keys and string min/max: "
        f"{len(cases)} cases at {n} rows, one kernel launch each, equal to "
        f"the CPU run")
    return len(cases)


def plan_runs(torch, plan, inputs, optimize):
    """One counted run of `plan` on the card (every kernel counter zeroed
    just before and read just after), three warm runs and a traced one:
    (result, counters, warm walls, trace)."""
    from spark_rapids_tpu_torch.plan import PlanExecutor
    ex = PlanExecutor(optimize=optimize)
    torch.cuda.synchronize()
    reset_kernel_counters()
    res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    counters = kernel_counters()
    require(counted(counters["plain"]) == 0,
            f"plain versions ran on the card path {counters['plain']}")
    walls = [ex.execute(plan, inputs).wall_ms for _ in range(3)]
    trace = traced_run(torch, lambda: ex.execute(plan, inputs))
    return res, counters, walls, trace


def q3_strings_path(torch, chk):
    """TPC-DS q3 with its STRING i_brand at N_SALES rows, authored and
    optimized: equal to numpy q3 (brand ids mapped to their names) and to
    the CPU run at 1/KEYS_CPU_SCALE of the rows."""
    from spark_rapids_tpu_torch import nds_q3
    gen = nds_q3.datagen(N_SALES, seed=0)
    ref = numpy_q3(gen)
    inputs = {k: t.to("cuda") for k, t in
              nds_q3.q3_tpcds_strings_inputs(N_SALES, device="cpu").items()}
    plan = nds_q3.q3_tpcds_strings_plan()
    out = {}
    for form, optimize in (("authored", False), ("optimized", True)):
        res, counters, walls, trace = plan_runs(torch, plan, inputs,
                                                optimize)
        got = res.table.to("cpu")
        require(got.names == ("d_year", "i_brand", "i_brand_id", "revenue")
                and got.num_rows == KEYS_LIMIT_ROWS,
                f"q3 strings {form}: {got.names} x {got.num_rows}")
        for name, want in (("d_year", ref[0]), ("i_brand_id", ref[1]),
                           ("revenue", ref[2])):
            require(np.array_equal(got[name].data.numpy(),
                                   want[:KEYS_LIMIT_ROWS]),
                    f"q3 strings {form}: {name} differs from numpy q3")
        require(got["i_brand"].to_pylist() ==
                [nds_q3.brand_name(b) for b in ref[1][:KEYS_LIMIT_ROWS]],
                f"q3 strings {form}: i_brand differs from numpy q3")
        stamps = sorted(m.kernel for m in res.metrics.values() if m.kernel)
        require(counters["hash_join"]["count"] == 2
                and counters["groupby"]["groupby"] == 1
                and (not optimize or (counters["fused_select"]["count"] == 2
                                      and counters["fused_select_strings"][
                                          "compact"] >= 1
                                      and counters["topk"]["threshold"]
                                      + counters["topk"]["select"] == 1
                                      and counted(counters["topk_strings"])
                                      == 0)),
                f"q3 strings {form}: launches {counters}")
        out[form] = {"wall_ms": res.wall_ms, "warm_wall_ms": walls,
                     "trace": trace, "stamps": stamps,
                     "launches": {k: counters[k] for k in
                                  ("hash_join", "hash_join_var",
                                   "fused_select", "fused_select_strings",
                                   "topk", "topk_strings", "groupby")},
                     "profile": res.profile()}
        log(f"  q3 strings {form} at {N_SALES} rows: {res.wall_ms:.3f} ms "
            f"cold, warm {', '.join(f'{w:.3f}' for w in walls)} ms, idle "
            f"share {trace['idle_share']:.3f}; stamps {stamps}; equal to "
            f"numpy q3")
    every = plan_runs(torch, nds_q3.q3_tpcds_strings_plan(limit=None),
                      inputs, True)[0].table.to("cpu")
    require(np.array_equal(every["revenue"].data.numpy(), ref[2])
            and np.array_equal(every["i_brand_id"].data.numpy(), ref[1]),
            "q3 strings without LIMIT differs from numpy q3")
    del inputs
    n = N_SALES // KEYS_CPU_SCALE
    host = nds_q3.q3_tpcds_strings_inputs(n, device="cpu")
    from spark_rapids_tpu_torch.plan import PlanExecutor
    for optimize in (False, True):
        card = PlanExecutor(optimize=optimize).execute(
            plan, {k: t.to("cuda") for k, t in host.items()})
        cpu = PlanExecutor(device="cpu", optimize=optimize).execute(plan,
                                                                    host)
        same_tables(torch, card.table, cpu.table,
                    f"q3 strings at {n} rows, optimize={optimize}")
    log(f"  q3 strings: all {every.num_rows} groups equal numpy q3; at {n} "
        f"rows the card equals the CPU run (authored, optimized)")
    out["groups"] = every.num_rows
    return out


def q74_path(torch, chk):
    """TPC-DS q74 at its full sizes, authored and optimized: equal to numpy
    q74 and to the CPU run at 1/KEYS_CPU_SCALE of the rows."""
    from spark_rapids_tpu_torch import nds_q74
    from spark_rapids_tpu_torch.plan import PlanExecutor
    t0 = time.perf_counter()
    gen = nds_q74.datagen(seed=0)
    inputs = nds_q74.q74_inputs(device="cuda", gen=gen)
    log(f"  q74 datagen: {time.perf_counter() - t0:.1f} s")
    ref = nds_q74.numpy_q74(gen)
    c = gen["customer"]

    def names(which, sk):
        chars, offs, valid = c[which]
        return [bytes(chars[offs[i - 1]:offs[i]]).decode()
                if valid[i - 1] else None for i in sk]
    want = {"customer_id": [bytes(x).decode()
                            for x in nds_q74.customer_ids(ref)],
            "customer_first_name": names("first", ref),
            "customer_last_name": names("last", ref)}
    plan = nds_q74.q74_plan()
    out = {}
    for form, optimize in (("authored", False), ("optimized", True)):
        res, counters, walls, trace = plan_runs(torch, plan, inputs,
                                                optimize)
        got = res.table.to("cpu")
        require(got.num_rows == len(ref) and all(
            got[k].to_pylist() == v for k, v in want.items()),
            f"q74 {form} differs from numpy q74")
        stamps = sorted(m.kernel for m in res.metrics.values() if m.kernel)
        require(counters["hash_join_var"] == {"build": 3, "count": 3,
                                              "emit": 3, "exists": 0,
                                              "capped": 0}
                and counters["hash_join"]["count"] == 7
                and counters["groupby"]["groupby"] == 2
                and (not optimize or (counters["fused_select"]["count"] >= 4
                                      and counters["fused_select_strings"][
                                          "compact"] >= 1
                                      and counters["topk"]["threshold"]
                                      + counters["topk"]["select"] == 1
                                      and counters["topk_strings"]
                                      == counters["topk"])),
                f"q74 {form}: launches {counters}")
        out[form] = {"wall_ms": res.wall_ms, "warm_wall_ms": walls,
                     "trace": trace, "stamps": stamps,
                     "launches": {k: counters[k] for k in
                                  ("hash_join", "hash_join_var",
                                   "hash_join_large", "fused_select",
                                   "fused_select_strings", "topk",
                                   "topk_strings", "groupby")},
                     "profile": res.profile()}
        log(f"  q74 {form}: {res.wall_ms:.3f} ms cold, warm "
            f"{', '.join(f'{w:.3f}' for w in walls)} ms, idle share "
            f"{trace['idle_share']:.3f}; stamps {stamps}; equal to numpy "
            f"q74 ({len(ref)} rows)")
    out["inputs"] = inputs
    out["gen"] = gen
    g = nds_q74.datagen(nds_q74.N_STORE_SALES // KEYS_CPU_SCALE,
                        nds_q74.N_WEB_SALES // KEYS_CPU_SCALE,
                        nds_q74.N_CUSTOMERS // KEYS_CPU_SCALE, seed=1)
    host = nds_q74.q74_inputs(device="cpu", gen=g)
    for optimize in (False, True):
        card = PlanExecutor(optimize=optimize).execute(
            plan, {k: t.to("cuda") for k, t in host.items()})
        cpu = PlanExecutor(device="cpu", optimize=optimize).execute(plan,
                                                                    host)
        same_tables(torch, card.table, cpu.table,
                    f"q74 at 1/{KEYS_CPU_SCALE}, optimize={optimize}")
    log(f"  q74 at 1/{KEYS_CPU_SCALE} of its rows: the card equals the CPU "
        f"run (authored, optimized)")
    return out


def string_bytes(col):
    """(offsets + chars bytes, validity bytes) of a STRING column."""
    return (4 * (col.length + 1) + col.data.numel(),
            0 if col.validity is None else col.length)


def var_join_timing(torch, chk, p, b, what):
    """The variable-width join kernels at one shape, first held against
    their plain versions and the sort-based join there (`check_case`,
    recorded under the "_var" kernels): device ms by kernel,
    one whole call, the plain versions' ms, and the bounds: the build
    reads the build keys and writes the table; the count reads the probe
    keys and validity, the build keys of the rows it compares (about one
    a matched probe row) and the table, and writes the counts and lists;
    the emit reads the lists and the build keys it compares and writes
    the pairs. Operations: murmur3 rounds of the hashed bytes."""
    from spark_rapids_tpu_torch.ops import join
    from spark_rapids_tpu_torch.ops import join_cuda as jc
    jc.reset_counters()
    pairs = check_case(chk, jc, join, p, b, what, suffix="_var")
    require(jc.VAR_LAUNCHES == {"build": 1, "count": 1, "emit": 1,
                                "exists": 1, "capped": 0}
            and jc.is_large(jc._capacity(b[0].length)),
            f"{what}: launches {jc.VAR_LAUNCHES}, not the large var route")
    log(f"  hash join {what}: {p[0].length} x {b[0].length} -> {pairs} "
        f"pairs, large route; kernel == plain == sort-based join")
    C = jc._capacity(b[0].length)
    table = jc.build_table_cuda(b, C)
    probe = jc.probe_counts_cuda(p, table, b)
    total = int(probe.total)
    n_matched = int((probe.counts > 0).sum())
    _, by_name = device_by_name(torch, lambda: jc.inner_join_hash(p, b), 10)
    ms = {k: sum(v for name, v in by_name.items() if name.startswith(
        f"{k}_kernel")) for k in ("count", "emit")}
    # the build alone: its six kernels and its memset
    ms["build"], build_by_name = device_by_name(
        torch, lambda: jc.build_table_cuda(b, C), 10)
    call = call_ms(torch, lambda: jc.inner_join_hash(p, b), 10)

    def plain():
        tp = jc.build_table_plain(b, C)
        pp = jc.probe_counts_plain(p, tp, b)
        jc.probe_emit_plain(p, tp, b, pp, int(pp.total))
    plain_ms = call_ms(torch, plain, 2)
    pk, pv = string_bytes(p[0])
    bk, bv = string_bytes(b[0])
    per_build = bk / max(b[0].length, 1)
    mean_len = lambda c: c.data.numel() / max(c.length, 1)  # noqa: E731
    rounds = lambda c: c.length * (mean_len(c) / 4 + 1)     # noqa: E731
    bounds = {
        "build": (bk + bv + 8 * C,
                  rounds(b[0]) * MM_ROUND_OPS + b[0].length * MM_FMIX_OPS),
        "count": (pk + pv + 8 * C + n_matched * per_build + 4 * p[0].length
                  + 8 * n_matched,
                  rounds(p[0]) * MM_ROUND_OPS + p[0].length * MM_FMIX_OPS),
        "emit": (8 * n_matched + 8 * C + total * per_build + 8 * total, 0)}
    out = {}
    for k, (nbytes, ops) in bounds.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_INT_OPS_PER_S * 1e3
        out[k] = {"ms": ms[k], "bytes": nbytes, "ops": ops,
                  "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                  "bound_ms": max(bytes_ms, ops_ms)}
    log(f"  var hash join at {what} ({p[0].length} x {b[0].length}, "
        f"{total} pairs): device ms {ms}, call {call:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bounds "
        f"{ {k: round(v['bound_ms'], 4) for k, v in out.items()} }")
    return {"by_kernel": out, "call_ms": call, "plain_ms": plain_ms,
            "pairs": total, "probe_rows": p[0].length,
            "build_rows": b[0].length, "rounds": int(table.rounds),
            "build_by_name": build_by_name}


def q74_join_shape(torch, gen):
    """q74's first string join, s2 |x| s1 on customer_id: the customers
    with store sales in 2002 (probe) and in 2001 (build), in customer_id
    order as the aggregate leaves them."""
    from spark_rapids_tpu_torch import nds_q74
    s = gen["store"]
    yr = gen["dates"]["d_year"][s["sold_date_sk"] - nds_q74.FIRST_DATE_SK]
    sides = []
    for year in nds_q74.YEARS[::-1]:
        sk = np.unique(s["customer_sk"][s["customer_valid"] & (yr == year)])
        ids = nds_q74.customer_ids(sk)
        ids = ids[np.lexsort(ids.T[::-1])]
        offs = np.arange(0, 16 * (len(sk) + 1), 16, dtype=np.int32)
        from spark_rapids_tpu_torch.columnar import make_string_column
        sides.append([make_string_column(
            torch.from_numpy(ids.reshape(-1).copy()).cuda(),
            torch.from_numpy(offs).cuda())])
    return sides


def year_total_table(torch, inputs):
    """q74's store year_total before its filters: the aggregate's input
    (the joined rows) and its output, run on the card."""
    from spark_rapids_tpu_torch import nds_q74
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col
    b = PlanBuilder()
    dates = (b.scan("date_dim", schema=["d_date_sk", "d_year"])
             .filter((col("d_year") == nds_q74.YEARS[0])
                     | (col("d_year") == nds_q74.YEARS[1])))
    joined = (b.scan("store_sales", schema=["ss_sold_date_sk",
                                            "ss_customer_sk", "ss_net_paid"])
              .join(dates, left_on="ss_sold_date_sk", right_on="d_date_sk")
              .join(b.scan("customer", schema=["c_customer_sk",
                                               "c_customer_id",
                                               "c_first_name",
                                               "c_last_name"]),
                    left_on="ss_customer_sk", right_on="c_customer_sk"))
    ex = PlanExecutor(optimize=False)
    rows = ex.execute(joined.build(), inputs).table
    agg = ex.execute(joined.aggregate(
        ["c_customer_id", "c_first_name", "c_last_name", "d_year"],
        [("ss_net_paid", "sum", "total")]).build(), inputs).table
    return rows, agg


def keys_timing(torch, chk, q74, q3_items):
    """The three kernels' new kinds timed at q74's and q3's shapes, and the
    sort's cost in q74's store aggregate."""
    from spark_rapids_tpu_torch import nds_q74
    from spark_rapids_tpu_torch.ops import aggregate, select, sort, topk
    from spark_rapids_tpu_torch.ops import select_cuda as sc
    from spark_rapids_tpu_torch.ops import topk_cuda as tc
    from spark_rapids_tpu_torch.plan import PlanExecutor, col
    inputs, gen = q74["inputs"], q74["gen"]
    out = {}
    p, b = q74_join_shape(torch, gen)
    out["hash_join"] = var_join_timing(torch, chk, p, b, "q74's s2 |x| s1")
    rows, agg = year_total_table(torch, inputs)
    keys = ["c_customer_id", "c_first_name", "c_last_name", "d_year"]

    def operands():
        ops = []
        for k in keys:
            ops.extend(sort._key_operands(rows[k], True, None))
        return ops
    ops = operands()
    out["sort"] = {
        "rows": rows.num_rows, "operands": len(ops),
        "operands_ms": call_ms(torch, operands, 5),
        "lex_order_ms": call_ms(torch, lambda: sort.lex_order(ops), 5),
        "groupby_ms": call_ms(torch, lambda: aggregate.groupby_aggregate(
            rows, keys, [("ss_net_paid", "sum")]), 5)}
    log(f"  q74's store aggregate: {rows.num_rows} rows, {len(ops)} sort "
        f"operands: operands {out['sort']['operands_ms']:.3f} ms, "
        f"lex_order {out['sort']['lex_order_ms']:.3f} ms, the whole keyed "
        f"aggregate {out['sort']['groupby_ms']:.3f} ms")
    # FusedSelect: q74's year filter over the aggregate (STRING payloads)
    # and q3's item filter (i_brand)
    fs = {}
    for what, t, pred, needed in (
            ("q74 year_total, d_year = 2002", agg,
             col("d_year") == nds_q74.YEARS[1],
             ["c_customer_id", "c_first_name", "c_last_name", "total"]),
            ("q3 items, i_manufact = 42", q3_items,
             col("i_manufact") == 42, ["i_item_sk", "i_brand_id",
                                       "i_brand"])):
        got = sc.fused_select_cuda(t, pred, needed)
        want = select.fused_select_plain(t, pred, needed)
        same_tables(torch, got, want, f"fused_select at {what}")
        ms = device_ms(torch, lambda: sc.fused_select_cuda(t, pred, needed),
                       KERNEL_NAMES["fused_select_wide"], 10, per_call=2)
        call = call_ms(torch, lambda: sc.fused_select_cuda(t, pred, needed),
                       10)
        plain = call_ms(torch, lambda: select.fused_select_plain(
            t, pred, needed), 5)
        # what the two kernels move: the predicate column read, the kept
        # rows of each fixed-width payload read and written, and for the
        # STRING payloads the kept rows' 8-byte indices written once
        pred_bytes = t[next(iter(pred.references()))].nbytes()
        fixed = sum(got[c].nbytes() for c in needed
                    if not got[c].dtype.is_string)
        strings = any(got[c].dtype.is_string for c in needed)
        nbytes = pred_bytes + 2 * fixed + 8 * got.num_rows * strings
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # the whole call's function, paired with call_ms: every kept
        # payload read and written, the strings' offsets and chars too
        call_bytes = pred_bytes + 2 * got.nbytes()
        fs[what] = {"rows": t.num_rows, "kept": got.num_rows, "ms": ms,
                    "call_ms": call, "plain_ms": plain, "bytes": nbytes,
                    "ops": 0, "bytes_ms": bytes_ms, "ops_ms": 0.0,
                    "bound_ms": bytes_ms, "call_bytes": call_bytes,
                    "call_bound_ms": call_bytes / HBM_BYTES_PER_S * 1e3}
        log(f"  FusedSelect at {what}: {t.num_rows} -> {got.num_rows} rows, "
            f"kernels {ms:.4f} ms (bound {bytes_ms:.4f} ms, {nbytes} B); "
            f"call {call:.3f} ms (bound "
            f"{fs[what]['call_bound_ms']:.4f} ms, {call_bytes} B); plain "
            f"{plain:.3f} ms")
    out["fused_select"] = fs
    # TopK: q74's order by customer_id limit 100 over the qualifying rows
    every = PlanExecutor().execute(nds_q74.q74_plan(limit=None),
                                   inputs).table
    perm = torch.randperm(every.num_rows, device="cuda")
    from spark_rapids_tpu_torch.ops.gather import take_table
    t = take_table(every, perm, _has_negative=False)
    args = (t, ["customer_id"], [True], KEYS_LIMIT_ROWS)
    same_tables(torch, tc.topk_table_cuda(*args), topk.topk_plain(*args),
                "topk at q74")
    tc.reset_counters()
    tc.topk_table_cuda(*args)
    names = ("tk_threshold_var_kernel" if tc.LAUNCHES["threshold"]
             else ("tk_select_var_kernel", "tk_merge_kernel"))
    ms = device_ms(torch, lambda: tc.topk_table_cuda(*args), names, 10)
    call = call_ms(torch, lambda: tc.topk_table_cuda(*args), 10)
    plain = call_ms(torch, lambda: topk.topk_plain(*args), 5)
    kb, kv = string_bytes(t["customer_id"])
    nbytes = kb + kv + 8 * KEYS_LIMIT_ROWS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out["topk"] = {"rows": t.num_rows, "words": topk.n_words(
        topk.make_signature(*args, "eager")), "route": names, "ms": ms,
        "call_ms": call, "plain_ms": plain, "bytes": nbytes, "ops": 0,
        "bytes_ms": bytes_ms, "ops_ms": 0.0, "bound_ms": bytes_ms}
    log(f"  TopK at q74 (customer_id, {t.num_rows} rows, k = "
        f"{KEYS_LIMIT_ROWS}): device {ms:.4f} ms, call {call:.3f} ms, plain "
        f"{plain:.3f} ms, bound {bytes_ms:.4f} ms")
    return out


def keys_phase(torch, chk):
    """Phase 10: the three kernels' new kinds against their plain versions,
    queue C 7, the capped tier's key kinds, and TPC-DS q3 with its STRING
    i_brand and q74 end to end."""
    from spark_rapids_tpu_torch import nds_q3
    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    log("phase 10: string, DECIMAL128 and float keys")
    out = {"join_cases": var_join_cases(torch, chk, rng),
           "topk_cases": key_topk_cases(torch, chk, rng),
           "select_cases": key_select_cases(torch, chk, rng)}
    float_join_plan(torch)
    out["aggregate_cases"] = keyed_aggregates_card(torch)
    out["capped"] = capped_keys_plans(torch, chk)
    out["q3_strings"] = q3_strings_path(torch, chk)
    q74 = q74_path(torch, chk)
    items = nds_q3.q3_tpcds_strings_inputs(1, device="cuda")["items"]
    out["timing"] = keys_timing(torch, chk, q74, items)
    out["q74"] = {k: v for k, v in q74.items() if k not in ("inputs", "gen")}
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return out


def keys_kernels(keys):
    """The kernels-line entries of the three kernels' new kinds: launches
    on the q3-strings and q74 paths (both forms), times at q74's and q3's
    shapes."""
    def launches(kernel, sub=None):
        by = {}
        for path in ("q3_strings", "q74"):
            for form in ("authored", "optimized"):
                d = keys[path][form]["launches"][kernel]
                by[f"{path} {form}"] = d[sub] if sub else sum(d.values())
        return by
    t = keys["timing"]
    out = []
    for k in ("build", "count", "emit"):
        h = t["hash_join"]["by_kernel"][k]
        by = launches("hash_join_var", k)
        out.append({
            "name": f"hash_join_{k}_var", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k], "launches": sum(by.values()),
            "launches_by_path": by,
            "exact": keys["max_err"][k + "_var"] == 0,
            "max_abs_err": keys["max_err"][k + "_var"], "ms": h["ms"],
            "call_ms": t["hash_join"]["call_ms"],
            "plain_ms": t["hash_join"]["plain_ms"],
            "bound_ms": h["bound_ms"],
            "bound_by": ("bytes" if h["bytes_ms"] >= h["ops_ms"]
                         else "operations"),
            "bytes": h["bytes"], "ops": h["ops"], "library_ms": None,
            "shape": "q74's s2 |x| s1 on customer_id (call and plain: "
                     "the whole join)"})
    by = launches("topk_strings")
    out.append({"name": "topk_string_keys", "route": "cuda",
                "source": TK_SOURCE, "replaces": REPLACES["topk"],
                "launches": by["q74 optimized"], "launches_by_path": by,
                "exact": keys["max_err"]["topk_keys"] == 0,
                "max_abs_err": keys["max_err"]["topk_keys"],
                "library_ms": None, "bound_by": "bytes",
                **{k: t["topk"][k] for k in ("ms", "call_ms", "plain_ms",
                                             "bound_ms", "bytes", "ops",
                                             "words", "rows")},
                "library": "none: torch.topk takes no strings"})
    by = launches("fused_select_strings")
    out.append({"name": "fused_select_string_payloads", "route": "cuda",
                "source": FS_SOURCE, "replaces": REPLACES["fused_select"],
                "launches": sum(by.values()), "launches_by_path": by,
                "exact": keys["max_err"]["fused_select_keys"] == 0,
                "max_abs_err": keys["max_err"]["fused_select_keys"],
                "library": "none: no PyTorch call compacts a string column",
                **summed(t["fused_select"], tuple(t["fused_select"]),
                         library_ms=None, call_bound_ms=sum(
                             f["call_bound_ms"]
                             for f in t["fused_select"].values()))})
    return out


# ---- phase 13: the casts (CastStrings) --------------------------------------

CAST_N = 1 << 20                   # random rows a method and type, checked
CAST_TIMED_N = 16_777_216          # the upstream string->float bench's rows
CAST_TOP_N = 100_000_000           # its top size, string->float only
CAST_SOURCES = {k: f"spark_rapids_tpu_torch/ops/csrc/{k}.cu"
                for k in ("cast_string", "cast_decimal",
                          "cast_string_to_float", "number_to_string")}
CAST_KERNEL_NAMES = {"cast_string": "cast_int_kernel",
                     "cast_decimal": "cast_decimal_kernel",
                     "cast_string_to_float": "cast_float_kernel",
                     "number_to_string": "number_to_string_kernel"}
CAST_REPLACES = {
    "cast_string": "none: spark_rapids_tpu/ops/cast_string.py:99 "
                   "(string_to_integer), :400 (string_to_integer_with_base)"
                   " (XLA ops, no pallas_call)",
    "cast_decimal": "none: spark_rapids_tpu/ops/cast_decimal.py:67 "
                    "(string_to_decimal) (XLA ops, no pallas_call)",
    "cast_string_to_float": "none: spark_rapids_tpu/ops/cast_string.py:224 "
                            "(string_to_float) (XLA ops, no pallas_call)",
    "number_to_string": "none: spark_rapids_tpu/ops/"
                        "cast_float_to_string.py:483 (float_to_string), "
                        "format_float.py:188, cast_decimal_to_string.py:67,"
                        " cast_string.py:459 (integer_to_string_with_base)"
                        " (XLA ops, no pallas_call)"}
# csrc/number_to_string.cu serves the four to-string ops; the other ops'
# kernels by name
CAST_OP_SOURCE = {"to_integer": "cast_string",
                  "to_integer_base": "cast_string",
                  "to_decimal": "cast_decimal",
                  "to_float": "cast_string_to_float"}
# The least integer work, for the bound, in 32-bit instructions (what
# PEAK_INT_OPS_PER_S counts), from the timed call's own inputs and outputs:
# - a parse: a load, two compares and a multiply-add a char (4);
# - a printed digit: a division by 10 and its remainder at 32 bits (a high
#   product and a shift, a product and a subtract: 4); a 64-bit value
#   (INT64, DECIMAL64, a FLOAT64's digits) first splits into 32-bit parts
#   by two divisions by 10^9 (18 each, as below): 36 a valid row;
# - Ryu, each valid row that is not NaN, infinite or zero: three
#   multiply-shifts, FLOAT32's each two 32 x 32 -> 64-bit products (2
#   instructions: the low and the high word), a 64-bit add and a 64-bit
#   shift (2 each): 8; FLOAT64's each two 64 x 64 -> 128-bit products
#   (four 32 x 32 -> 64-bit products and four carrying adds: 12), a
#   128-bit add (4) and a funnel shift over three words (6): 34. Then the
#   removal turns the plain version reports for the same rows
#   (`cast_float_to_string.ryu_removed`): a turn tested divides vp and vm
#   by 10, takes vm's remainder and compares (FLOAT32's values fit 32
#   bits: 2 + 2 + 2 + 1 = 7; FLOAT64's: a division a 64-bit high product
#   and a shift, 14, a remainder 4 more, a compare 2: 34), a turn taken
#   also divides vr and takes its remainder (4; 18); a row tests the turns
#   it takes and one more, up to the loop's cap (11; 20). Its printed
#   digits, at most its shortest digits (padding zeros need no division),
#   count as printed digits.
# Stores and the other chars count as bytes only. Bytes: each input buffer
# read once (offsets, chars, validity, data), each output written once
# (a parse's value and validity; the timed calls run outside ANSI, where
# no error flag is written).
CAST_CHAR_OPS = 4
DIGIT_OPS = 4
SPLIT_OPS = 36
RYU_OPS = {4: {"mul": 8, "tested": 7, "taken": 4, "cap": 11},
           8: {"mul": 34, "tested": 34, "taken": 18, "cap": 20}}
# the plain version's rows a call: its padded planes for 16,777,216 rows
# do not fit on the card for every form
PLAIN_CHUNK = 4_194_304


def cast_corpus(torch, n, seed, device):
    """The edge corpus of tests/torch_cast_inputs.py (empty, NUL,
    high-byte, blank and control-char strings and the JAX tests' golden
    vectors) and `n` random rows shaped like numbers, as one STRING column
    on `device`."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_cast_inputs import (EDGE, GOLDEN, random_number_strings,
                                   with_nulls)
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    vals = EDGE + GOLDEN + with_nulls(
        random_number_strings(seed, n, max_digits=40), seed + 1)
    return Column.from_pylist(vals, dt.STRING, device=device)


def printed_floats(torch, n, seed=3):
    """The upstream bench's strings (benchmarks/common.py:360-367, after
    cast_string_to_float.cpp:29-34): random FLOAT32 values times 1e-3, 1,
    1e4 or 1e20, printed with %g, as a STRING column on the card."""
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e4, 1e20],
                                                size=n)).astype(np.float32)
    return printed_column(torch, np.char.mod("%g", vals).astype("S"))


def printed_column(torch, txt, valid=None, device="cuda"):
    """A STRING column of a numpy bytes array (no NUL in any string)."""
    from spark_rapids_tpu_torch.columnar import make_string_column
    n = txt.shape[0]
    mat = np.frombuffer(txt.tobytes(), np.uint8).reshape(n, -1)
    keep = mat != 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(keep.sum(1), out=offsets[1:])
    v = None if valid is None else torch.from_numpy(valid).to(device)
    return make_string_column(
        torch.from_numpy(mat[keep]).to(device),
        torch.from_numpy(offsets.astype(np.int32)).to(device), v)


def tiled_strings(torch, col, n):
    """A STRING column of `n` rows: `col`'s rows over and over."""
    from spark_rapids_tpu_torch.columnar import make_string_column
    reps = -(-n // col.length)
    lens = col.string_lengths().repeat(reps)[:n]
    total = int(col.offsets[-1])
    chars = col.data.repeat(reps)[:int(lens.sum())]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(lens, 0, out=offsets[1:])
    require(int(offsets[-1]) < 2**31 and total > 0, "tiled strings overflow")
    return make_string_column(chars, offsets.to(torch.int32))


def cast_same(torch, chk, kernel, got, want, what):
    """Two cast results equal, bit for bit: data (floats by their bits),
    validity and, for strings, offsets and chars."""
    require(got.dtype == want.dtype and got.length == want.length,
            f"{what}: {got.dtype!r} x {got.length} vs {want.dtype!r} x "
            f"{want.length}")
    a, b = got.data, want.data.to(got.data.device)
    if a.dtype in (torch.float32, torch.float64):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int64
        a, b = a.view(bits), b.view(bits)
    elif a.dtype == torch.uint64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    chk.equal(kernel, a, b, f"{what} data")
    if got.offsets is not None:
        chk.equal(kernel, got.offsets, want.offsets.to(got.data.device),
                  f"{what} offsets")
    require((got.validity is None) == (want.validity is None),
            f"{what}: validity on one side only")
    if got.validity is not None:
        chk.equal(kernel, got.validity, want.validity.to(got.data.device),
                  f"{what} validity")


def cast_methods(torch, strings, numbers):
    """(name, source, op, kernel call, plain call, column) for each of
    CastStrings' eight methods: the call through `api.CastStrings`, the
    plain version on the same tensors."""
    import importlib
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.ops import (cast_decimal,
                                            cast_decimal_to_string,
                                            cast_float_to_string,
                                            cast_string)
    ff = importlib.import_module("spark_rapids_tpu_torch.ops.format_float")
    cs, CS = cast_string, api.CastStrings
    s = strings
    return [
        ("toInteger INT32", "cast_string", "to_integer",
         lambda c: CS.toInteger(c, False, dt.INT32),
         lambda c: cs.string_to_integer_plain(c, dt.INT32)[0], s),
        ("toInteger INT64 no strip", "cast_string", "to_integer",
         lambda c: CS.toInteger(c, False, dt.INT64, False),
         lambda c: cs.string_to_integer_plain(c, dt.INT64, strip=False)[0],
         s),
        ("toIntegersWithBase 16 INT64", "cast_string", "to_integer_base",
         lambda c: CS.toIntegersWithBase(c, 16, False, dt.INT64),
         lambda c: cs.string_to_integer_with_base_plain(c, dt.INT64, 16), s),
        ("toDecimal(9, 2)", "cast_decimal", "to_decimal",
         lambda c: CS.toDecimal(c, False, 9, 2),
         lambda c: cast_decimal.string_to_decimal_plain(c, 9, 2)[0], s),
        ("toDecimal(38, 10)", "cast_decimal", "to_decimal",
         lambda c: CS.toDecimal(c, False, 38, 10),
         lambda c: cast_decimal.string_to_decimal_plain(c, 38, 10)[0], s),
        ("toFloat FLOAT32", "cast_string_to_float", "to_float",
         lambda c: CS.toFloat(c, False, dt.FLOAT32),
         lambda c: cs.string_to_float_plain(c, dt.FLOAT32)[0], s),
        ("toFloat FLOAT64", "cast_string_to_float", "to_float",
         lambda c: CS.toFloat(c, False, dt.FLOAT64),
         lambda c: cs.string_to_float_plain(c, dt.FLOAT64)[0], s),
        ("fromFloat FLOAT32", "number_to_string", "from_float",
         CS.fromFloat, cast_float_to_string.float_to_string_plain,
         numbers["float32"]),
        ("fromFloat FLOAT64", "number_to_string", "from_float",
         CS.fromFloat, cast_float_to_string.float_to_string_plain,
         numbers["float64"]),
        ("fromFloatWithFormat FLOAT32 3", "number_to_string", "format_float",
         lambda c: CS.fromFloatWithFormat(c, 3),
         lambda c: ff.format_float_plain(c, 3), numbers["float32"]),
        ("fromFloatWithFormat FLOAT64 0", "number_to_string", "format_float",
         lambda c: CS.fromFloatWithFormat(c, 0),
         lambda c: ff.format_float_plain(c, 0), numbers["float64_mid"]),
        ("fromDecimal(18, 4)", "number_to_string", "from_decimal",
         CS.fromDecimal,
         cast_decimal_to_string.decimal_to_non_ansi_string_plain,
         numbers["dec64"]),
        ("fromDecimal(38, 6)", "number_to_string", "from_decimal",
         CS.fromDecimal,
         cast_decimal_to_string.decimal_to_non_ansi_string_plain,
         numbers["dec128"]),
        ("fromIntegersWithBase 10 INT64", "number_to_string",
         "from_integer_base", lambda c: CS.fromIntegersWithBase(c, 10),
         lambda c: cs.integer_to_string_with_base_plain(c, 10),
         numbers["int64"]),
        ("fromIntegersWithBase 16 INT8", "number_to_string",
         "from_integer_base", lambda c: CS.fromIntegersWithBase(c, 16),
         lambda c: cs.integer_to_string_with_base_plain(c, 16),
         numbers["int8"]),
    ]


def cast_numbers(torch, n, seed, device):
    """Random numbers for the to-string methods: float bit patterns over
    every exponent with the specials, FLOAT64 of moderate size (for
    format_float's full-width rows), DECIMAL64/128, INT64 and INT8, with
    nulls."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.05
    f32 = rng.integers(0, 2**32, n).astype(np.uint32)
    f32[:6] = [0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 1]
    f64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    f64[:6] = [0, 1 << 63, 0x7FF0000000000000, 0xFFF0000000000000,
               0x7FF8000000000000, 1]
    mid = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 15, n)
    dec = rng.integers(-10**17, 10**17, n) // 10 ** rng.integers(0, 17, n)
    lo = rng.integers(0, 2**32, (n, 4)).astype(np.uint32)
    lo[:, 3] = (rng.integers(-2**31, 2**31, n) >> rng.integers(0, 31, n)
                ).astype(np.int32).view(np.uint32)
    return {
        "float32": Column.from_numpy(f32.view(np.float32), dt.FLOAT32,
                                     valid, device=device),
        "float64": Column.from_numpy(f64.view(np.float64), dt.FLOAT64,
                                     valid, device=device),
        "float64_mid": Column.from_numpy(mid, dt.FLOAT64, valid,
                                         device=device),
        "dec64": Column.from_numpy(dec, dt.decimal(18, 4), valid,
                                   device=device),
        "dec128": Column.from_numpy(lo, dt.decimal(38, 6), valid,
                                    device=device),
        "int64": Column.from_numpy(rng.integers(-2**63, 2**63 - 1, n),
                                   dt.INT64, valid, device=device),
        "int8": Column.from_numpy(rng.integers(-128, 128, n).astype(np.int8),
                                  dt.INT8, valid, device=device)}


def cast_checks(torch, chk):
    """Every method through `api.CastStrings` on the card, counters zeroed
    just before and read just after: one launch each, no plain run; each
    result equal to the plain version on the card's tensors and to the
    CPU run, byte for byte; the edge corpus and the random rows; ANSI
    errors equal to the CPU run's. -> (launches by kernel, by method)."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.ops import cast_cuda, cast_decimal, cast_string
    cards = {"strings": cast_corpus(torch, CAST_N, 41, "cuda"),
             "numbers": cast_numbers(torch, CAST_N, 42, "cuda")}
    methods = cast_methods(torch, cards["strings"], cards["numbers"])
    # the edge corpus alone, small, so that every edge row's result is
    # looked at without the random rows around it
    from spark_rapids_tpu_torch.columnar import Column
    edge = cast_corpus(torch, 0, 43, "cuda")
    small = cast_numbers(torch, 4099, 44, "cuda")
    # the corpus without its first 7 rows (offsets that do not start at
    # 0) and a column of empty strings (an empty chars buffer)
    sliced = Column(dt.STRING, edge.length - 7, edge.data,
                    edge.validity[7:], edge.offsets[7:])
    empty = Column.from_pylist([b"", None, b""], dt.STRING, device="cuda")
    for strings in (edge, sliced, empty):
        for what, source, op, call, plain, col in cast_methods(
                torch, strings, small):
            if strings is not edge and not col.dtype.is_string:
                continue
            cast_same(torch, chk, source, call(col), plain(col),
                      f"{what} edge")
            cast_same(torch, chk, source, call(col), call(col.to("cpu")),
                      f"{what} edge vs cpu")
    torch.cuda.synchronize()
    reset_kernel_counters()
    results, by_method = [], {}
    for m in methods:
        before = sum(cast_cuda.LAUNCHES.values())
        results.append((m, m[3](m[5])))
        by_method[m[0]] = sum(cast_cuda.LAUNCHES.values()) - before
    torch.cuda.synchronize()
    counters = kernel_counters()
    # a string format launches its two passes; a parse one kernel
    want = {}
    for m in methods:
        per = 2 if m[1] == "number_to_string" else 1
        want[m[2]] = want.get(m[2], 0) + per
        require(by_method[m[0]] == per,
                f"{m[0]}: {by_method[m[0]]} launches, want {per}")
    require(counters["casts"] == want
            and counted(counters) == sum(want.values()),
            f"phase 13 counters {counters}, want casts {want}")
    by_kernel = {}
    for op, v in counters["casts"].items():
        src = CAST_OP_SOURCE.get(op, "number_to_string")
        by_kernel[src] = by_kernel.get(src, 0) + v
    for (what, source, op, call, plain, col), got in results:
        cast_same(torch, chk, source, got, plain(col), what)
        cast_same(torch, chk, source, got, call(col.to("cpu")),
                  f"{what} vs cpu")
        log(f"  {what}: {col.length} rows equal to the plain version and "
            f"the CPU run")
    require(cast_cuda.PLAIN_CALLS["to_integer"] > 0, "no CPU run counted")
    # ANSI: 1,048,576 printed numbers with nulls and one bad row deep in:
    # its row and string, on the card as the CPU run raises them
    rng = np.random.default_rng(46)
    valid = rng.random(CAST_N) > 0.05
    ints = np.char.mod("%d", rng.integers(-2**31, 2**31, CAST_N)).astype("S")
    floats = np.char.mod("%g", rng.standard_normal(CAST_N)).astype("S")
    decs = ints.copy()
    for what, txt, bad, fn in (
            ("toInteger", ints, 700_001, lambda c: cast_string.
             string_to_integer(c, dt.INT32, ansi_mode=True)),
            ("toDecimal", decs, 800_001, lambda c: cast_decimal.
             string_to_decimal(c, 18, 0, ansi_mode=True)),
            ("toFloat", floats, 900_001, lambda c: cast_string.
             string_to_float(c, dt.FLOAT64, ansi_mode=True))):
        txt[bad], valid[bad] = b"12x", True
        col = printed_column(torch, txt, valid)
        errs = []
        for c in (col, col.to("cpu")):
            try:
                fn(c)
                errs.append(None)
            except cast_string.CastError as e:
                errs.append((e.row_number, e.string_with_error))
        require(errs[0] == errs[1] == (bad, "12x"),
                f"ANSI {what}: card {errs[0]}, cpu {errs[1]}, want row "
                f"{bad}")
        log(f"  ANSI {what}: row {errs[0][0]} {errs[0][1]!r} on both")
        chk.n += 1
    return by_kernel, by_method


def digit_counts(torch, out):
    """The digit chars ('0'-'9') of each row of a STRING column (int64)."""
    isd = ((out.data >= 48) & (out.data <= 57)).to(torch.int64)
    cs = torch.zeros(isd.numel() + 1, dtype=torch.int64,
                     device=out.data.device)
    torch.cumsum(isd, 0, out=cs[1:])
    off = out.offsets.to(torch.int64)
    return cs[off[1:]] - cs[off[:-1]]


def ryu_ops(torch, col, digits):
    """Ryu's operations over a float column and its rows' printed digits
    (RYU_OPS), from the plain version's shortest digits and removal turns
    on the same values, PLAIN_CHUNK rows at a time."""
    from spark_rapids_tpu_torch.ops.cast_float_to_string import ryu_removed
    c = RYU_OPS[col.data.element_size()]
    wide = col.data.element_size() == 8
    total = 0
    for a in range(0, col.length, PLAIN_CHUNK):
        part = slice(a, a + PLAIN_CHUNK)
        _, _, olength, _, nan, inf, zero, removed = ryu_removed(
            col.data[part])
        live = ~(nan | inf | zero)
        if col.validity is not None:
            live &= col.validity[part]
        r = removed.to(torch.int64)
        per = (3 * c["mul"] + c["tested"] * torch.clamp(r + 1, max=c["cap"])
               + c["taken"] * r + (SPLIT_OPS if wide else 0)
               + DIGIT_OPS * torch.minimum(digits[part],
                                           olength.to(torch.int64)))
        total += int(torch.where(live, per, 0).sum())
    return total


def cast_bounds(torch, col, out):
    """(bytes, operations) of one call outside ANSI: inputs read once,
    outputs written once, the least integer work (CAST_CHAR_OPS,
    DIGIT_OPS, SPLIT_OPS, RYU_OPS) counted from `col` and `out`."""
    n = col.length
    valid_bytes = n if col.validity is not None else 0
    if col.dtype.is_string:
        chars = int(col.offsets[-1]) - int(col.offsets[0])
        in_bytes = 4 * (n + 1) + chars + valid_bytes
        ops_ = CAST_CHAR_OPS * chars
    else:
        in_bytes = col.data.numel() * col.data.element_size() + valid_bytes
        ops_ = 0
    if out.dtype.is_string:
        out_bytes = 4 * (n + 1) + int(out.offsets[-1])
        digits = digit_counts(torch, out)
        if col.dtype.is_floating:
            ops_ += ryu_ops(torch, col, digits)
        else:
            row_bytes = col.data.numel() * col.data.element_size() // n
            valid = n if col.validity is None else int(col.validity.sum())
            ops_ += (DIGIT_OPS * int(digits.sum())
                     + (SPLIT_OPS * valid if row_bytes >= 8 else 0))
    else:
        out_bytes = out.data.numel() * out.data.element_size() + n
    return in_bytes + out_bytes, ops_


def cast_timing(torch, source, fn, plain, col, iters=10):
    """Device ms (profiler records, L2 flushed; the launches a call makes
    read off the counters), one call's ms, the plain version's ms over the
    same rows (PLAIN_CHUNK rows a call, summed) and the bound."""
    from spark_rapids_tpu_torch.ops import cast_cuda
    cast_cuda.reset_counters()
    out = fn(col)
    torch.cuda.synchronize()
    per_call = sum(cast_cuda.LAUNCHES.values())
    ms = device_ms(torch, lambda: fn(col), CAST_KERNEL_NAMES[source], iters,
                   per_call=per_call)
    cms = call_ms(torch, lambda: fn(col), iters)
    nbytes, ops_ = cast_bounds(torch, col, out)
    del out
    pms = 0.0
    for a in range(0, col.length, PLAIN_CHUNK):
        part = cast_slice(torch, col, min(PLAIN_CHUNK, col.length - a), a)
        pms += time_cuda(torch, lambda: plain(part), 1)
        torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_ / PEAK_INT_OPS_PER_S * 1e3
    return {"rows": col.length, "launches_per_call": per_call, "ms": ms,
            "call_ms": cms, "plain_ms": pms, "plain_chunk": PLAIN_CHUNK,
            "bytes": nbytes, "ops": ops_, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "library_ms": None}


def cast_slice(torch, col, rows, start=0):
    """`rows` rows of a column from row `start`."""
    from spark_rapids_tpu_torch.columnar import Column
    end = start + rows
    v = None if col.validity is None else col.validity[start:end]
    if col.dtype.is_string:
        return Column(col.dtype, rows, col.data, v, col.offsets[start:end + 1])
    return Column(col.dtype, rows, col.data[start:end], v)


def casts_phase(torch, chk):
    """Phase 13: the checks, then each kernel timed at the upstream
    bench's 16,777,216 rows (string -> float also at 100,000,000)."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.ops import cast_string
    t0 = time.perf_counter()
    by_kernel, by_method = cast_checks(torch, chk)
    log(f"casts: checks in {time.perf_counter() - t0:.1f} s")
    CS = api.CastStrings
    n = CAST_TIMED_N
    t0 = time.perf_counter()
    floats = printed_floats(torch, n)
    log(f"  {n} printed floats made in {time.perf_counter() - t0:.1f} s")
    nums = cast_numbers(torch, n, 45, "cuda")
    ints = CS.fromIntegersWithBase(
        cast_slice(torch, nums["int64"], n), 10)         # decimal strings
    decs = CS.fromDecimal(nums["dec64"])
    timing = {"cast_string": {}, "cast_decimal": {},
              "cast_string_to_float": {}, "number_to_string": {}}
    import importlib
    ff = importlib.import_module("spark_rapids_tpu_torch.ops.format_float")
    from spark_rapids_tpu_torch.ops import (cast_decimal,
                                            cast_decimal_to_string,
                                            cast_float_to_string)
    cases = [
        ("cast_string", "toInteger INT64", ints,
         lambda c: CS.toInteger(c, False, dt.INT64),
         lambda c: cast_string.string_to_integer_plain(c, dt.INT64)[0]),
        ("cast_string", "toIntegersWithBase 10 INT64", ints,
         lambda c: CS.toIntegersWithBase(c, 10, False, dt.INT64),
         lambda c: cast_string.string_to_integer_with_base_plain(
             c, dt.INT64, 10)),
        ("cast_decimal", "toDecimal(18, 4)", decs,
         lambda c: CS.toDecimal(c, False, 18, 4),
         lambda c: cast_decimal.string_to_decimal_plain(c, 18, 4)[0]),
        ("cast_decimal", "toDecimal(38, 10)", decs,
         lambda c: CS.toDecimal(c, False, 38, 10),
         lambda c: cast_decimal.string_to_decimal_plain(c, 38, 10)[0]),
        ("cast_string_to_float", "toFloat FLOAT32", floats,
         lambda c: CS.toFloat(c, False, dt.FLOAT32),
         lambda c: cast_string.string_to_float_plain(c, dt.FLOAT32)[0]),
        ("number_to_string", "fromFloat FLOAT32", nums["float32"],
         CS.fromFloat, cast_float_to_string.float_to_string_plain),
        ("number_to_string", "fromFloatWithFormat FLOAT64 2",
         nums["float64_mid"], lambda c: CS.fromFloatWithFormat(c, 2),
         lambda c: ff.format_float_plain(c, 2)),
        ("number_to_string", "fromDecimal(18, 4)", nums["dec64"],
         CS.fromDecimal,
         cast_decimal_to_string.decimal_to_non_ansi_string_plain),
        ("number_to_string", "fromIntegersWithBase 10 INT64",
         nums["int64"], lambda c: CS.fromIntegersWithBase(c, 10),
         lambda c: cast_string.integer_to_string_with_base_plain(c, 10))]
    for source, what, col, fn, plain in cases:
        t = cast_timing(torch, source, fn, plain, col)
        timing[source][what] = t
        log(f"  {what} at {col.length} rows: device {t['ms']:.3f} ms "
            f"({t['launches_per_call']} launches), one call "
            f"{t['call_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms (bytes {t['bytes_ms']:.4f}, operations "
            f"{t['ops_ms']:.4f})")
    # string -> float at the upstream bench's top size: its printed floats
    # tiled to 100,000,000 rows
    top = tiled_strings(torch, floats, CAST_TOP_N)
    fn = next(c[3] for c in cases if c[1] == "toFloat FLOAT32")
    out = fn(top)
    torch.cuda.synchronize()
    ms = device_ms(torch, lambda: fn(top), "cast_float_kernel", 5)
    nbytes, ops_ = cast_bounds(torch, top, out)
    want = fn(cast_slice(torch, top, floats.length))
    cast_same(torch, chk, "cast_string_to_float",
              cast_slice(torch, out, floats.length), want,
              "toFloat at 100M rows, its first rows")
    top_t = {"rows": CAST_TOP_N, "ms": ms, "bytes": nbytes, "ops": ops_,
             "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                             ops_ / PEAK_INT_OPS_PER_S) * 1e3}
    log(f"  toFloat FLOAT32 at {CAST_TOP_N} rows: device {ms:.3f} ms, bound "
        f"{top_t['bound_ms']:.4f} ms")
    return {"launches": by_kernel, "launches_by_method": by_method,
            "timing": timing, "to_float_100m": top_t}


def casts_kernels(casts, chk):
    """The four kernels' entries of the `kernels` line."""
    out = []
    for source, forms in casts["timing"].items():
        entry = {"name": source, "route": "cuda",
                 "source": CAST_SOURCES[source],
                 "replaces": CAST_REPLACES[source],
                 "launches": casts["launches"][source],
                 "exact": chk.max_err[source] == 0,
                 "max_abs_err": chk.max_err[source],
                 "library": "none: no PyTorch call parses or prints "
                            "Spark's numbers",
                 **summed(forms, tuple(forms), library_ms=None)}
        if source == "cast_string_to_float":
            entry["rows_100m"] = casts["to_float_100m"]
        out.append(entry)
    return out


# ---- phase 14: parse_uri, from_json and the bloom filter --------------------

UJB_N = 1 << 20                    # bench_parse_uri.py's rows; the JSON rows
URI_HIT_RATES = (0, 50, 100)       # bench_parse_uri.py's hit_rate axis
BLOOM_ROWS = 150_000_000           # the upstream bloom_filter.cu bench's rows
BLOOM_HASHES = 3
BLOOM_BYTES = (512 << 10, 1 << 20, 2 << 20, 4 << 20, 8 << 20)
BLOOM_SLICES = 4                   # the plain version's slices of those rows
# 150,000,000 rows x 3 hashes set every bit of a filter up to 2 MiB, where
# a probe is all True and a put all ones whatever the hash: so each filter
# is also built from its first bits / BLOOM_FILL rows (1 - e^-0.75, about
# 53% of its bits set) and probed by every row, most of them never put
BLOOM_FILL = 4
URI_CHUNK = 131_072                # the plain versions' rows a call (their
JSON_CHUNK = 32_768                # (n, L) planes)
JSON_PAIRS = 65_536                # generated pairs the JSON objects draw
JSON_PAIR_BYTES = 120              # 8 pairs stay within 1,024 bytes a row
# tests/torch_uri_json_inputs.py `json_objects`' spacing styles:
# (between pairs, between a key and its value)
JSON_SEPS = ((", ", ": "), (",", ":"), (" , ", " : "))
UJB_SOURCES = {k: f"spark_rapids_tpu_torch/ops/csrc/{k}.cu"
               for k in ("parse_uri", "map_utils", "bloom_filter")}
UJB_REPLACES = {
    "parse_uri": "none: spark_rapids_tpu/ops/parse_uri.py:215 "
                 "(_parse_kernel), :509 (_find_param_kernel) (XLA ops, no "
                 "pallas_call)",
    "map_utils": "none: spark_rapids_tpu/ops/map_utils.py:42 "
                 "(_structure_kernel), :199 (_extract_pairs) (XLA ops, no "
                 "pallas_call)",
    "bloom_filter": "none: spark_rapids_tpu/ops/bloom_filter.py:67 "
                    "(_spark_bit_indexes), :80 (bloom_filter_put), :132 "
                    "(bloom_filter_probe) (XLA ops, no pallas_call)"}
# The least integer work, for the bound, in 32-bit instructions:
# - a URI or JSON byte: its load and the compares that classify it (the
#   charset and UTF-8 tests or the automaton and the depth, then the
#   grammar's or the trim's class test): 8;
# - a bloom row: two murmur3 hashes of a long (two rounds of two multiplies,
#   two rotates, two xors and a multiply-add, then fmix's three shifts and
#   xors and two multiplies: 19 each), then a bit index (a multiply-add,
#   the sign test and flip, the modulo by the filter's constant size as a
#   high product, a multiply and a subtract, the word index and bit: 11)
#   a hash: 38 + 11 k. The atomics' and the probe loads' trips to the L2
#   count as bytes of the filter only.
# Bytes: each input buffer read once (offsets, chars, validity, data, the
# filter), each output written once (offsets, chars, validity, the
# filter's words, the probe's bools).
URI_CHAR_OPS = 8
JSON_CHAR_OPS = 8
BLOOM_HASH_OPS = 38
BLOOM_INDEX_OPS = 11

# bench_parse_uri.py's inputs (benchmarks/common.py:371-385 `uri_mix` and
# its pools, and `_random_strings`), copied: this script imports nothing
# of the benchmarks
URI_VALID = (b"https://www.example.com/s/query?param0=0&param1=1&param2=2"
             b"&param3=3&param4=4&param5=5&param6=6&param7=7&param8=8")
URI_GARBAGE = [
    b"abcdefghijklmnopqrstuvwxyz 01234" * 8,
    b"",
    "AbcéDEFGHIJKLMNOPQRSTUVWXYZ 01".encode() * 8,
    b"9876543210,abcdefghijklmnopqrstU" * 8,
]
URI_RANDOM_ALPHABET = b"abcdefghijklmnopqrstuvwxyz0123456789:/?.&=%"


def tests_on_path():
    """The repo's tests/ on sys.path, for its JAX-free input helpers."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if d not in sys.path:
        sys.path.insert(0, d)


def pooled_strings(torch, pool, idx, device="cuda"):
    """A STRING column whose row i is pool[idx[i]] (bytes), gathered on
    the card."""
    from spark_rapids_tpu_torch.columnar import make_string_column
    lens = np.array([len(p) for p in pool], np.int64)
    starts = np.zeros(len(pool), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    chars = torch.from_numpy(np.frombuffer(b"".join(pool) or b"\0",
                                           np.uint8).copy()).to(device)
    idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
    row_lens = torch.from_numpy(lens).to(device)[idx_t]
    offsets = torch.zeros(idx_t.numel() + 1, dtype=torch.int64, device=device)
    torch.cumsum(row_lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    row = torch.repeat_interleave(torch.arange(idx_t.numel(), device=device),
                                  row_lens, output_size=total)
    src = (torch.from_numpy(starts).to(device)[idx_t][row]
           + torch.arange(total, device=device) - offsets[:-1][row])
    return make_string_column(chars[src], offsets.to(torch.int32))


def uri_mix(torch, n, hit_rate, seed=6):
    """bench_parse_uri.py's mix: hit_rate% of URI_VALID, the rest drawn
    from the garbage pool (the bench's draws, seed 6)."""
    rng = np.random.default_rng(seed)
    hits = rng.random(n) < hit_rate / 100.0
    pick = rng.integers(0, len(URI_GARBAGE), size=n)
    return pooled_strings(torch, [URI_VALID] + URI_GARBAGE,
                          np.where(hits, 0, pick + 1))


def random_uri_strings(torch, n, seed=5):
    """bench_parse_uri.py's random strings: 0-31 bytes of its alphabet, a
    row (its distribution, drawn in one call)."""
    from spark_rapids_tpu_torch.columnar import make_string_column
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 32, size=n)
    alpha = np.frombuffer(URI_RANDOM_ALPHABET, np.uint8)
    chars = alpha[rng.integers(0, alpha.size, size=int(lens.sum()))]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    return make_string_column(torch.from_numpy(chars).to("cuda"),
                              torch.from_numpy(offsets).to("cuda"))


def uri_param_column(torch, n, seed=8):
    """A parameter a row for the column form: the mix's keys param0-param8,
    a key it lacks, '' and nulls."""
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    pool = [f"param{i}".encode() for i in range(9)] + [b"zz", b""]
    rng = np.random.default_rng(seed)
    col = pooled_strings(torch, pool, rng.integers(0, len(pool), n))
    valid = torch.from_numpy(rng.random(n) >= 0.05).to("cuda")
    return Column(dt.STRING, n, col.data, valid, col.offsets)


def json_rows(torch, n, seed=12, device="cuda"):
    """n JSON objects of 1-8 pairs, each drawn on its own: a spacing style
    of tests/torch_uri_json_inputs.py `json_objects`, then its pairs from
    JSON_PAIRS generated pairs printed in that style (keys k0-k11, so some
    repeat within a row; values nested to 8 levels by its `json_value`),
    put together on the card."""
    tests_on_path()
    from torch_uri_json_inputs import json_value
    from spark_rapids_tpu_torch.columnar import make_string_column
    rng = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < JSON_PAIRS:
        key = json.dumps(f"k{int(rng.integers(0, 12))}")
        value = json.dumps(json_value(rng, 1))
        if len(key) + len(value) + 3 <= JSON_PAIR_BYTES:
            pairs.append((key, value))
    # tokens: "{", "}", the three pair separators, then the pairs in each
    # style; a row is "{", pair, separator, ..., pair, "}"
    pool = [b"{", b"}"] + [sep.encode() for sep, _ in JSON_SEPS] + [
        (key + kv + value).encode() for _, kv in JSON_SEPS
        for key, value in pairs]
    k = rng.integers(1, 9, n)
    style = rng.integers(0, len(JSON_SEPS), n)
    ntok = 2 * k + 1
    first = np.zeros(n + 1, np.int64)
    np.cumsum(ntok, out=first[1:])
    row = np.repeat(np.arange(n), ntok)
    j = np.arange(first[-1]) - first[:-1][row]
    draw = rng.integers(0, JSON_PAIRS, int(first[-1]))
    idx = np.where(j % 2 == 1, 5 + style[row] * JSON_PAIRS + draw,
                   2 + style[row])
    idx[j == 0] = 0
    idx[j == ntok[row] - 1] = 1
    toks = pooled_strings(torch, pool, idx, device)
    return make_string_column(
        toks.data, toks.offsets[torch.from_numpy(first).to(device)])


def rows_of(col, a, b):
    """Rows [a, b) of a STRING column (its chars buffer shared)."""
    from spark_rapids_tpu_torch.columnar import Column
    v = None if col.validity is None else col.validity[a:b]
    return Column(col.dtype, b - a, col.data, v, col.offsets[a:b + 1])


def same_string_rows(torch, chk, kernel, got, a, b, want, what):
    """Rows [a, b) of `got` equal `want` (a column of those rows): offsets
    (rebased), chars and validity."""
    off = got.offsets[a:b + 1].to(torch.int64)
    chk.equal(kernel, (off - off[0]).to(torch.int32), want.offsets,
              f"{what} offsets")
    chk.equal(kernel, got.data[int(off[0]):int(off[-1])], want.data,
              f"{what} chars")
    chk.equal(kernel, got.null_mask[a:b], want.null_mask, f"{what} validity")


def same_map_rows(torch, chk, got, a, b, want, what):
    """Rows [a, b) of a from_json result equal `want`: list offsets
    (rebased), validity, keys and values."""
    off = got.offsets[a:b + 1].to(torch.int64)
    p0, p1 = int(off[0]), int(off[-1])
    chk.equal("map_utils", (off - p0).to(torch.int32), want.offsets,
              f"{what} list offsets")
    chk.equal("map_utils", got.null_mask[a:b], want.null_mask,
              f"{what} validity")
    for g, w, name in zip(got.children[0].children,
                          want.children[0].children, ("keys", "values")):
        same_string_rows(torch, chk, "map_utils", g, p0, p1, w,
                         f"{what} {name}")


def uri_calls(params):
    """(form, kernel call through api.ParseURI, plain call) of the five
    methods; the column form against `params` (same rows)."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch.ops import parse_uri as pu
    P = api.ParseURI
    return [
        ("protocol", P.parseURIProtocol, pu.parse_uri_to_protocol_plain),
        ("host", P.parseURIHost, pu.parse_uri_to_host_plain),
        ("query", P.parseURIQuery, pu.parse_uri_to_query_plain),
        ("query_literal", lambda c: P.parseURIQueryWithLiteral(c, "param4"),
         lambda c: pu.parse_uri_to_query_literal_plain(c, "param4")),
        ("query_column",
         lambda c, p=params: P.parseURIQueryWithColumn(c, p),
         None)]


def uri_check(torch, chk, col, params, outs, what):
    """Each of the five forms' output on `col` (`outs`, by form) against
    the plain version over URI_CHUNK-row slices."""
    from spark_rapids_tpu_torch.ops import parse_uri as pu
    for form, _, plain in uri_calls(params):
        for a in range(0, col.length, URI_CHUNK):
            b = min(a + URI_CHUNK, col.length)
            part = rows_of(col, a, b)
            want = (plain(part) if plain is not None else
                    pu.parse_uri_to_query_column_plain(
                        part, rows_of(params, a, b)))
            same_string_rows(torch, chk, "parse_uri", outs[form], a, b, want,
                             f"{what} {form} rows {a}-{b}")
        torch.cuda.empty_cache()


def json_check(torch, chk, col, got, what):
    from spark_rapids_tpu_torch.ops import map_utils as mu
    for a in range(0, col.length, JSON_CHUNK):
        b = min(a + JSON_CHUNK, col.length)
        same_map_rows(torch, chk, got, a, b,
                      mu.from_json_plain(rows_of(col, a, b)),
                      f"{what} rows {a}-{b}")
    torch.cuda.empty_cache()


def bloom_plain_put(torch, bf, col):
    """The plain put over BLOOM_SLICES slices of the rows, ORed."""
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import bloom_filter as bfm
    words = bf.words.clone()
    step = -(-col.length // BLOOM_SLICES)
    for a in range(0, col.length, step):
        b = min(a + step, col.length)
        v = None if col.validity is None else col.validity[a:b]
        part = Column(col.dtype, b - a, col.data[a:b], v)
        words |= bfm.bloom_filter_put_plain(bf, part).words
        torch.cuda.empty_cache()
    return words


def head_rows(col, n):
    """The first n rows of a fixed-width column."""
    from spark_rapids_tpu_torch.columnar import Column
    v = None if col.validity is None else col.validity[:n]
    return Column(col.dtype, n, col.data[:n], v)


def bloom_fill(torch, words):
    """The share of a filter's bits that are set."""
    table = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64, device=words.device)
    return int(table[words.view(torch.uint8).long()].sum()) / (
        64 * words.numel())


def bloom_partial_check(torch, chk, col, rows, part, found, what):
    """A filter put from `col`'s first `rows` rows (`part`) and probed by
    all of them (`found`): the words equal the plain put's (its slices
    ORed) and leave bits clear, the probe equals the plain probe, finds
    every valid put row and misses some of the others -> the share of
    those others found."""
    from spark_rapids_tpu_torch.ops import bloom_filter as bfm
    empty = bfm.bloom_filter_create(part.num_hashes, part.num_longs,
                                    part.words.device)
    chk.equal("bloom_filter", part.words,
              bloom_plain_put(torch, empty, head_rows(col, rows)),
              f"{what} put of {rows} rows")
    fill = bloom_fill(torch, part.words)
    require(0 < fill < 1 and bool((part.words != -1).any()),
            f"{what}: {fill} of the bits set by {rows} rows")
    chk.equal("bloom_filter", found.data, bloom_plain_probe(torch, part, col),
              f"{what} probe by {col.length} rows")
    valid = (torch.ones(col.length, dtype=torch.bool, device=col.data.device)
             if col.validity is None else col.validity)
    require(bool(found.data[:rows][valid[:rows]].all()),
            f"{what}: a put row not found")
    rest = found.data[rows:][valid[rows:]]
    hits = int(rest.sum())
    require(0 < hits < rest.numel(), f"{what}: {hits} of {rest.numel()} "
            f"rows never put found")
    return fill, hits / rest.numel()


def bloom_plain_probe(torch, bf, col):
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import bloom_filter as bfm
    step = -(-col.length // BLOOM_SLICES)
    found = []
    for a in range(0, col.length, step):
        b = min(a + step, col.length)
        found.append(bfm.bloom_filter_probe_plain(
            Column(col.dtype, b - a, col.data[a:b]), bf).data)
        torch.cuda.empty_cache()
    return torch.cat(found)


def ujb_corpus_checks(torch, chk):
    """The tests' corpora on the card: every form against the plain
    version on the card's tensors and the CPU run; the from_json errors'
    texts; the bloom filter with nulls at 1, 3 and 64 longs."""
    tests_on_path()
    from torch_uri_json_inputs import (int64_values, json_corpus, uri_corpus,
                                       uri_params)
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import bloom_filter as bfm
    from spark_rapids_tpu_torch.ops import map_utils as mu
    from spark_rapids_tpu_torch.ops import parse_uri as pu
    col = Column.from_pylist(uri_corpus(), dt.STRING, device="cuda")
    params = Column.from_pylist(uri_params(3, col.length), dt.STRING,
                                device="cuda")
    for form, call, plain in uri_calls(params):
        got = call(col)
        if form == "query_column":
            want_plain = pu.parse_uri_to_query_column_plain(col, params)
            want_cpu = api.ParseURI.parseURIQueryWithColumn(
                col.to("cpu"), params.to("cpu"))
        else:
            want_plain, want_cpu = plain(col), call(col.to("cpu"))
        for want, how in ((want_plain, "plain"), (want_cpu, "cpu")):
            same_string_rows(torch, chk, "parse_uri", got, 0, col.length,
                             want.to("cuda"), f"URI corpus {form} vs {how}")
    # offsets that start past 0, every row null, every row empty
    edge = {"sliced": rows_of(col, 7, col.length),
            "nulls": Column.from_pylist([None] * 5, dt.STRING,
                                        device="cuda"),
            "empty": Column.from_pylist([b""] * 5, dt.STRING, device="cuda")}
    for name, c in edge.items():
        for form, call, plain in uri_calls(params)[:4]:
            same_string_rows(torch, chk, "parse_uri", call(c), 0, c.length,
                             plain(c), f"URI {name} {form} vs plain")
    js = Column.from_pylist(json_corpus(), dt.STRING, device="cuda")
    got = api.MapUtils.extractRawMapFromJsonString(js)
    for want, how in ((mu.from_json_plain(js), "plain"),
                      (mu.from_json(js.to("cpu")), "cpu")):
        same_map_rows(torch, chk, got, 0, js.length, want.to("cuda"),
                      f"JSON corpus vs {how}")
    for name, c in {**edge, "sliced": rows_of(js, 7, js.length)}.items():
        same_map_rows(torch, chk, api.MapUtils.extractRawMapFromJsonString(c),
                      0, c.length, mu.from_json_plain(c),
                      f"JSON {name} vs plain")
    for rows in (['{"a": 1}', '{"a": 1', '{"a" 1}'], ['{"k": 1}', '{k: 2}'],
                 ['{"a" 1}', None, '{"a": "x}']):
        msgs = []
        for dev in ("cuda", "cpu"):
            try:
                mu.from_json(Column.from_pylist(rows, dt.STRING, device=dev))
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        require(msgs[0] is not None and msgs[0] == msgs[1],
                f"from_json errors: card {msgs[0]!r}, cpu {msgs[1]!r}")
        chk.n += 1
    v, valid = int64_values(9, 100_003)
    vals = Column.from_numpy(v, dt.INT64, valid, device="cuda")
    none = Column.from_numpy(v[:9], dt.INT64, np.zeros(9, bool),
                             device="cuda")
    chk.equal("bloom_filter", api.BloomFilter.put(
        bfm.bloom_filter_create(BLOOM_HASHES, 3, "cuda"), none).words,
              torch.zeros(3, dtype=torch.int64, device="cuda"),
              "bloom put of every row null")
    for num_longs in (1, 3, 64):
        bf = api.BloomFilter.put(
            bfm.bloom_filter_create(BLOOM_HASHES, num_longs, "cuda"), vals)
        cpu = bfm.bloom_filter_put(
            bfm.bloom_filter_create(BLOOM_HASHES, num_longs, "cpu"),
            vals.to("cpu"))
        chk.equal("bloom_filter", bf.words,
                  bfm.bloom_filter_put_plain(bf, vals).words,
                  f"bloom {num_longs} longs put vs plain")
        chk.equal("bloom_filter", bf.words.cpu(), cpu.words,
                  f"bloom {num_longs} longs put vs cpu")
        found = api.BloomFilter.probe(bf, vals)
        chk.equal("bloom_filter", found.data,
                  bfm.bloom_filter_probe_plain(vals, bf).data,
                  f"bloom {num_longs} longs probe vs plain")
        chk.equal("bloom_filter", bfm.bloom_filter_serialize(bf).cpu(),
                  bfm.bloom_filter_serialize(cpu),
                  f"bloom {num_longs} longs wire bytes vs cpu")
        # 100,003 rows fill these filters: a filter of the first rows only
        rows = num_longs * 64 // BLOOM_FILL
        part = api.BloomFilter.put(
            bfm.bloom_filter_create(BLOOM_HASHES, num_longs, "cuda"),
            head_rows(vals, rows))
        found = api.BloomFilter.probe(part, vals)
        bloom_partial_check(torch, chk, vals, rows, part, found,
                            f"bloom {num_longs} longs")
        cpu = bfm.bloom_filter_put(
            bfm.bloom_filter_create(BLOOM_HASHES, num_longs, "cpu"),
            head_rows(vals.to("cpu"), rows))
        chk.equal("bloom_filter", part.words.cpu(), cpu.words,
                  f"bloom {num_longs} longs put of {rows} rows vs cpu")
        chk.equal("bloom_filter", found.data.cpu(),
                  bfm.bloom_filter_probe(vals.to("cpu"), cpu).data,
                  f"bloom {num_longs} longs probe of {rows} rows vs cpu")
    torch.cuda.synchronize()


def ujb_inputs(torch):
    """The phase's data, made here from seeds: bench_parse_uri.py's random
    strings and its mix at hit rates 0, 50 and 100 (1,048,576 rows each),
    a parameter column, 1,048,576 JSON objects, and the bloom bench's
    150,000,000 rows (xxhash64 of random INT64 values, seed 11, as
    bench_bloom_filter.py makes them)."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    cols = {"random": random_uri_strings(torch, UJB_N)}
    for rate in URI_HIT_RATES:
        cols[f"mix{rate}"] = uri_mix(torch, UJB_N, rate)
    cols["params"] = uri_param_column(torch, UJB_N)
    cols["json"] = json_rows(torch, UJB_N)
    rng = np.random.default_rng(11)
    raw = rng.integers(-2**63, 2**63 - 1, size=BLOOM_ROWS, dtype=np.int64,
                       endpoint=True)
    src = Column.from_numpy(raw, dt.INT64, device="cuda")
    del raw
    cols["bloom"] = api.Hash.xxhash64([src])
    torch.cuda.synchronize()
    return cols


def ujb_main_path(torch, cols):
    """The main path once through the api, every counter zeroed just
    before and read just after: ParseURI's five methods over the mix at
    hit rate 50, from_json over the JSON rows, and a 1 MiB filter created,
    put, probed (also through its wire bytes) and merged with its wire
    bytes at 150,000,000 rows, and a 1 MiB filter put from the first
    rows that fill about half of it (a join's build side) and probed by
    all 150,000,000 -> (outputs, counters)."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch.ops import bloom_filter as bfm
    B = api.BloomFilter
    torch.cuda.synchronize()
    reset_kernel_counters()
    outs = {form: call(cols["mix50"])
            for form, call, _ in uri_calls(cols["params"])}
    jmap = api.MapUtils.extractRawMapFromJsonString(cols["json"])
    bits, dev = (1 << 20) * 8, cols["bloom"].device
    bf = B.put(B.create(BLOOM_HASHES, bits, device=dev), cols["bloom"])
    found = B.probe(bf, cols["bloom"])
    wire = bfm.bloom_filter_serialize(bf)
    found_wire = B.probe(wire, cols["bloom"])
    merged = B.merge([bf, wire])
    part = B.put(B.create(BLOOM_HASHES, bits, device=dev),
                 head_rows(cols["bloom"], bits // BLOOM_FILL))
    found_part = B.probe(part, cols["bloom"])
    torch.cuda.synchronize()
    return ((outs, jmap, bf, found, found_wire, merged, part, found_part),
            kernel_counters())


def once_ms(torch, fn):
    """One call's time between CUDA events (no warm-up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def string_bytes_of(col):
    """(rows, chars, validity bytes) of a STRING column."""
    n = col.length
    return (n, int(col.offsets[-1]) - int(col.offsets[0]),
            n if col.validity is not None else 0)


def ujb_timing(torch, module, names, fn, plain_parts, nbytes, ops, iters=10):
    """Device ms (profiler records, L2 flushed; the launches a call makes
    read off the module's counters), one call's ms, the plain version's ms
    over the same rows (a call a part, summed) and the bound."""
    module.reset_counters()
    fn()
    torch.cuda.synchronize()
    per_call = sum(module.LAUNCHES.values())
    ms = device_ms(torch, fn, names, iters, per_call=per_call)
    # everything the call runs on the card, by kernel (its scans and
    # copies too)
    whole_ms, by_name = device_by_name(torch, fn, iters)
    cms = call_ms(torch, fn, iters)
    pms = 0.0
    for part in plain_parts:
        pms += once_ms(torch, part)
        torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT_OPS_PER_S * 1e3
    return {"launches_per_call": per_call, "ms": ms, "call_ms": cms,
            "whole_ms": whole_ms, "by_name": by_name,
            "plain_ms": pms, "plain_parts": len(plain_parts),
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "library_ms": None}


def uri_needed_chars(torch, col):
    """The chars a parse must read: a row up to its first byte that is
    never legal (below 0x21, or 0x7F), where it becomes invalid, else all
    of it."""
    off = col.offsets.to(torch.int64)
    lens = off[1:] - off[:-1]
    chars = col.data[int(off[0]):int(off[-1])]
    row = torch.repeat_interleave(torch.arange(col.length,
                                               device=chars.device), lens,
                                  output_size=chars.numel())
    pos = torch.arange(chars.numel(), device=chars.device) - (
        off[:-1] - off[0])[row]
    bad = (chars < 0x21) | (chars == 0x7F)
    first = lens.clone().scatter_reduce_(0, row[bad], pos[bad] + 1, "amin")
    return int(first.sum())


def uri_bound(torch, col, out):
    """(bytes, operations): offsets and validity, the chars a parse must
    read (`uri_needed_chars`), the output's offsets, chars and validity;
    URI_CHAR_OPS a char read."""
    n, _, vbytes = string_bytes_of(col)
    chars = uri_needed_chars(torch, col)
    nbytes = (4 * (n + 1) + chars + vbytes + 4 * (n + 1)
              + int(out.offsets[-1]) + n)
    return nbytes, URI_CHAR_OPS * chars


def json_bound(col, out):
    n, chars, vbytes = string_bytes_of(col)
    pairs = int(out.offsets[-1])
    keys, values = out.children[0].children
    nbytes = (4 * (n + 1) + chars + vbytes + 4 * (n + 1)
              + (n if out.validity is not None else 0)
              + 8 * (pairs + 1) + int(keys.offsets[-1])
              + int(values.offsets[-1]))
    return nbytes, JSON_CHAR_OPS * chars


def bloom_bound(col, num_longs, probe):
    n = col.length
    valid = n if col.validity is None else int(col.validity.sum())
    nbytes = 8 * n + 8 * num_longs + (n if probe else 8 * num_longs)
    if not probe and col.validity is not None:
        nbytes += n
    rows = n if probe else valid
    return nbytes, rows * (BLOOM_HASH_OPS + BLOOM_INDEX_OPS * BLOOM_HASHES)


def ujb_phase(torch, chk):
    """Phase 14: the corpora, the main path once (counted), its outputs and
    the other bench inputs against the plain versions, then each kernel
    timed at the benches' sizes."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import bloom_filter as bfm
    from spark_rapids_tpu_torch.ops import (bloom_filter_cuda, map_utils_cuda,
                                            parse_uri_cuda)
    from spark_rapids_tpu_torch.ops import map_utils as mu
    from spark_rapids_tpu_torch.ops import parse_uri as pu
    t0 = time.perf_counter()
    ujb_corpus_checks(torch, chk)
    log(f"  corpora: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    cols = ujb_inputs(torch)
    json_distinct = int(torch.unique(
        api.Hash.xxhash64([cols["json"]]).data).numel())
    log(f"  inputs made in {time.perf_counter() - t1:.1f} s; "
        f"{json_distinct} distinct JSON rows of {UJB_N} (by xxhash64)")
    (outs, jmap, bf, found, found_wire, merged, half,
     found_half), counters = ujb_main_path(torch, cols)
    want = {"parse_uri": {f: 2 for f in parse_uri_cuda.OPS},
            "map_utils": {"from_json": 2},
            "bloom_filter": {"put": 2, "probe": 3}}
    for k, v in want.items():
        require(counters[k] == v, f"phase 14 {k} launches {counters[k]}, "
                f"want {v}")
    require(counted(counters) == sum(sum(v.values()) for v in want.values()),
            f"phase 14 counters {counters}: another kernel or a plain run")
    launches = {k: sum(counters[k].values()) for k in want}
    log(f"  main path: launches {launches}, no plain run")
    t1 = time.perf_counter()
    uri_check(torch, chk, cols["mix50"], cols["params"], outs, "mix 50")
    del outs
    for name in ("random", "mix0", "mix100"):
        got = {form: call(cols[name])
               for form, call, _ in uri_calls(cols["params"])}
        uri_check(torch, chk, cols[name], cols["params"], got, name)
    log(f"  URIs checked in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    json_check(torch, chk, cols["json"], jmap, "JSON")
    log(f"  JSON checked in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    chk.equal("bloom_filter", found_wire.data, found.data,
              "probe through the wire bytes")
    chk.equal("bloom_filter", merged.words, bf.words, "merge with its wire")
    require(bool(found.data.all()), "a put row not found")
    timing = {"parse_uri": {}, "map_utils": {}, "bloom_filter": {}}
    fills = {}
    for size in BLOOM_BYTES:
        num_longs = size // 8
        empty = bfm.bloom_filter_create(BLOOM_HASHES, num_longs, "cuda")
        col = cols["bloom"]
        rows = num_longs * 64 // BLOOM_FILL
        if size == 1 << 20:
            part, found_part = half, found_half
            half = found_half = None
        else:
            part = bfm.bloom_filter_put(empty, head_rows(col, rows))
            found_part = bfm.bloom_filter_probe(col, part)
        fill, fp = bloom_partial_check(torch, chk, col, rows, part,
                                       found_part, f"{size} B")
        fills[size] = {"rows": rows, "bits_set": fill, "found_never_put": fp,
                       "full_put_bits_set": None}
        del part, found_part
        got = bf if size == 1 << 20 else bfm.bloom_filter_put(empty, col)
        chk.equal("bloom_filter", got.words,
                  bloom_plain_put(torch, empty, col), f"put {size} B")
        fills[size]["full_put_bits_set"] = bloom_fill(torch, got.words)
        probe = found if size == 1 << 20 else bfm.bloom_filter_probe(col, got)
        chk.equal("bloom_filter", probe.data,
                  bloom_plain_probe(torch, got, col), f"probe {size} B")
        back = bfm.bloom_filter_deserialize(bfm.bloom_filter_serialize(got))
        chk.equal("bloom_filter", back.words, got.words,
                  f"wire round trip {size} B")
        step = -(-col.length // BLOOM_SLICES)
        parts = [Column(col.dtype, min(step, col.length - a),
                        col.data[a:a + step])
                 for a in range(0, col.length, step)]
        label = f"{size >> 10} KiB"
        timing["bloom_filter"][f"put {label}"] = ujb_timing(
            torch, bloom_filter_cuda, "bf_put_kernel",
            lambda e=empty: bfm.bloom_filter_put(e, col),
            [lambda p=p, e=empty: bfm.bloom_filter_put_plain(e, p)
             for p in parts], *bloom_bound(col, num_longs, False))
        timing["bloom_filter"][f"probe {label}"] = ujb_timing(
            torch, bloom_filter_cuda, "bf_probe_kernel",
            lambda g=got: bfm.bloom_filter_probe(col, g),
            [lambda p=p, g=got: bfm.bloom_filter_probe_plain(p, g)
             for p in parts], *bloom_bound(col, num_longs, True))
        del got, probe, back
        torch.cuda.empty_cache()
    for size, f in fills.items():
        log(f"  bloom {size} B: {f['rows']} rows set {f['bits_set']:.6f} of "
            f"the bits and find {f['found_never_put']:.6f} of the rows "
            f"never put; all {BLOOM_ROWS} rows set "
            f"{f['full_put_bits_set']:.6f}")
    log(f"  bloom filters checked and timed in "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    uri_forms = [("protocol random", "random", pu.parse_uri_to_protocol,
                  pu.parse_uri_to_protocol_plain)]
    uri_forms += [(f"protocol hit {r}", f"mix{r}", pu.parse_uri_to_protocol,
                   pu.parse_uri_to_protocol_plain) for r in URI_HIT_RATES]
    uri_forms += [("query_literal param4 hit 100", "mix100",
                   lambda c: pu.parse_uri_to_query_literal(c, "param4"),
                   lambda c: pu.parse_uri_to_query_literal_plain(c,
                                                                 "param4"))]
    for form, name, fn, plain in uri_forms:
        col = cols[name]
        out = fn(col)
        parts = [lambda a=a, col=col, plain=plain: plain(
            rows_of(col, a, min(a + URI_CHUNK, col.length)))
            for a in range(0, col.length, URI_CHUNK)]
        timing["parse_uri"][form] = ujb_timing(
            torch, parse_uri_cuda, ("pu_spans_kernel", "pu_copy_kernel"),
            lambda col=col, fn=fn: fn(col), parts,
            *uri_bound(torch, col, out))
    col = cols["json"]
    parts = [lambda a=a: mu.from_json_plain(
        rows_of(col, a, min(a + JSON_CHUNK, col.length)))
        for a in range(0, col.length, JSON_CHUNK)]
    timing["map_utils"]["from_json"] = ujb_timing(
        torch, map_utils_cuda, ("mu_rows_kernel", "mu_pairs_kernel"),
        lambda: mu.from_json(col), parts, *json_bound(col, jmap))
    log(f"  URI and JSON kernels timed in {time.perf_counter() - t1:.1f} s")
    for source, forms in timing.items():
        for form, t in forms.items():
            log(f"  {source} {form}: device {t['ms']:.6f} ms "
                f"({t['launches_per_call']} launches), one call "
                f"{t['call_ms']:.6f} ms, plain {t['plain_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.6f} ms (bytes {t['bytes_ms']:.6f}, "
                f"operations {t['ops_ms']:.6f}); the call's device work "
                f"{t['whole_ms']:.6f} ms: " + ", ".join(
                    f"{k} {v:.6f}" for k, v in t["by_name"].items()))
    return {"launches": launches, "counters": counters, "timing": timing,
            "bloom_fill": fills,
            "rows": {"uri": UJB_N, "json": UJB_N, "bloom": BLOOM_ROWS,
                     "json_distinct": json_distinct,
                     "json_chars": string_bytes_of(cols["json"])[1],
                     "uri_chars": {k: string_bytes_of(cols[k])[1]
                                   for k in ("random", "mix0", "mix50",
                                             "mix100")}},
            "seconds": time.perf_counter() - t0}


def ujb_kernels(ujb, chk):
    """The three kernels' entries of the `kernels` line."""
    out = []
    for source, forms in ujb["timing"].items():
        out.append({"name": source, "route": "cuda",
                    "source": UJB_SOURCES[source],
                    "replaces": UJB_REPLACES[source],
                    "launches": ujb["launches"][source],
                    "exact": chk.max_err[source] == 0,
                    "max_abs_err": chk.max_err[source],
                    "library": "none: no PyTorch call computes it",
                    **summed(forms, tuple(forms), library_ms=None)})
    return out


# ---- phase 15: runtime arbitration --------------------------------------------

# the g++ builds of the host C++, timed in build_phase beside nvcc: the
# resource arbiter's under "seconds", the Parquet libraries' by name
NATIVE_BUILD = {}
RT_RUNS = 5                       # runs per task thread
RT_TASKS = ("q23", "q5", "q23", "q5")
RT_FACTOR = 1.5                   # shared limit over the larger high-water


def rt_plain_calls():
    """The plain versions' counters of every kernel module, summed."""
    return counted(kernel_counters()["plain"])


class _HighWater:
    """A MemoryEventHandler keeping the budget's high-water mark."""

    def __init__(self, rt):
        outer = self
        self.mark = 0

        class H(rt.MemoryEventHandler):
            def on_allocated(self, total_used):
                outer.mark = max(outer.mark, total_used)

        self.handler = H()


def rt_task(rt, arbiter, ex, plan, inputs):
    """One task's plan run, as a Spark task's retry loop would make it: a
    RetryOOM or SplitAndRetryOOM that leaves `execute()` (a plan cannot be
    split) drops what the attempt held and reruns it once the arbiter lets
    the thread go. Returns (result, reruns)."""
    import gc
    reruns = 0
    while True:
        try:
            return ex.execute(plan, inputs), reruns
        except (rt.RetryOOM, rt.SplitAndRetryOOM):
            reruns += 1
        gc.collect()                 # the failed attempt's outputs go
        try:
            arbiter.block_thread_until_ready()
        except (rt.RetryOOM, rt.SplitAndRetryOOM):
            pass


def rt_same(torch, got, want, what):
    same_tables(torch, got.compact(), want.compact(), what)


def rt_card_run(torch, res, what, counted_run=False):
    """A run on the card: not degraded, no plain version run, and for a
    `counted_run` (counters zeroed just before it) kernels launched."""
    require(not res.degraded and res.device.type == "cuda",
            f"{what}: degraded {res.degraded} on {res.device}")
    plain = rt_plain_calls()
    require(plain == 0, f"{what}: {plain} plain runs on the card")
    if counted_run:
        n = counted({k: v for k, v in kernel_counters().items()
                     if k != "plain"})
        require(n > 0, f"{what}: no kernel launched")
        return n


def runtime_phase(torch, chk, smi):
    """Phase 15: several tasks share one card through the plan engine (the
    resource arbiter, memory budgets, admission, spill, fault injection,
    the health breaker and the degraded CPU tier), at bench scale."""
    import gc
    import threading
    from spark_rapids_tpu_torch import faultinj, nds_q5, nds_q23
    from spark_rapids_tpu_torch import runtime as rt
    from spark_rapids_tpu_torch.plan import PlanExecutor
    t_phase = time.perf_counter()
    out = {"card": smi, "native_build_s": NATIVE_BUILD.get("seconds")}
    log(f"phase 15: runtime arbitration ({smi}); resource_adaptor built "
        f"with g++ in {out['native_build_s']} s")

    # the plans and their tables at bench scale, the numpy references
    plans = {}
    for q, mod, numpy_fn in (("q23", nds_q23, numpy_q23),
                             ("q5", nds_q5, numpy_q5)):
        t0 = time.perf_counter()
        gen = mod.datagen(N_SALES, seed=0)
        ref, _ = numpy_fn(gen)
        del gen
        inputs = getattr(mod, f"{q}_inputs")(N_SALES, seed=0, device="cuda")
        plans[q] = {"plan": getattr(mod, f"{q}_plan")(), "inputs": inputs,
                    "numpy": ref,
                    "rows": sum(t.num_rows for t in inputs.values())}
        log(f"  {q}: {plans[q]['rows']} rows in "
            f"{time.perf_counter() - t0:.1f} s")

    # 1-2. each plan alone under an unbinding budget: its result and the
    # reservations' high-water mark
    solo = {}
    me = rt.current_thread_id()
    for q, p in plans.items():
        hw = _HighWater(rt)
        with rt.DeviceSession(1 << 50, event_handler=hw.handler) as sess:
            sess.arbiter.current_thread_is_dedicated_to_task(1000)
            ex = PlanExecutor(session=sess)
            ex.execute(p["plan"], p["inputs"])         # warm
            reset_kernel_counters()
            t0 = time.perf_counter()
            res = ex.execute(p["plan"], p["inputs"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rt_card_run(torch, res, f"{q} solo", counted_run=True)
            for name, want in zip(res.table.names, p["numpy"]):
                require(np.array_equal(
                    res.table[name].data.cpu().numpy(), want),
                    f"{q} solo: {name} differs from numpy")
            solo[q] = res
            del res
            gc.collect()
            held = sess.device.used
            sess.arbiter.task_done(1000)
        require(hw.mark > 0, f"{q} solo: no reservation")
        out[f"{q}_high_water_bytes"] = hw.mark
        out[f"{q}_solo_ms"] = wall * 1e3
        log(f"  {q} solo: {wall * 1e3:.3f} ms, reservations' high-water "
            f"mark {hw.mark} B, {held} B held by its result")

    # 3. four task threads, two per plan, five runs each, on one budget of
    # 1.5x the larger high-water mark: they must block and be escalated
    limit = int(RT_FACTOR * max(out["q23_high_water_bytes"],
                                out["q5_high_water_bytes"]))
    shared = rt.DeviceSession(limit)
    results, errors, tids = {}, [], {}
    task_metrics = {}
    # every task thread waits here after its last run, still registered
    # with the arbiter, while the main thread reads their states
    ran = threading.Barrier(len(RT_TASKS) + 1)
    read = threading.Event()

    def worker(i, q):
        try:
            tids[i] = rt.current_thread_id()
            # the default executor (op_retries 2, degrade "cpu"): the
            # arbiter's RetryOOM and SplitAndRetryOOM leave execute(), so
            # the task drops every output it holds before it blocks
            ex = PlanExecutor(session=shared)
            metrics = {"retry": 0, "split": 0, "block_ns": 0, "lost_ns": 0,
                       "reruns": 0, "plan_retries": 0}
            for r in range(RT_RUNS):
                task = r * len(RT_TASKS) + i + 1     # older runs first
                shared.arbiter.current_thread_is_dedicated_to_task(task)
                res, reruns = rt_task(rt, shared.arbiter, ex,
                                      plans[q]["plan"], plans[q]["inputs"])
                arb = shared.arbiter
                metrics["retry"] += arb.get_and_reset_num_retry_throw(task)
                metrics["split"] += arb.get_and_reset_num_split_retry_throw(
                    task)
                metrics["block_ns"] += arb.get_and_reset_block_time_ns(task)
                metrics["lost_ns"] += \
                    arb.get_and_reset_computation_time_lost_ns(task)
                metrics["reruns"] += reruns
                metrics["plan_retries"] += res.retries
                results[(i, r)] = (q, res.degraded, res.compact())
                del res
                if r == RT_RUNS - 1:
                    gc.collect()         # hold no reservation while waiting
                    ran.wait(timeout=300)
                    read.wait(timeout=300)
                arb.task_done(task)
            task_metrics[i] = metrics
        except BaseException as e:           # relayed to the main thread
            errors.append((i, repr(e)))
            ran.abort()

    reset_kernel_counters()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i, q), daemon=True)
               for i, q in enumerate(RT_TASKS)]
    for t in threads:
        t.start()
    # every thread has finished its runs (or one failed, or one is stuck
    # in the arbiter): each must be registered and running, none blocked
    # or waiting on the BUFN path
    try:
        ran.wait(timeout=300)
    except threading.BrokenBarrierError:
        pass
    states = {i: shared.arbiter.get_state_name_of(tid)
              for i, tid in sorted(tids.items())}
    read.set()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads),
            "a task thread did not finish in 600 s")
    require(not errors, f"task threads failed: {errors}")
    require(len(states) == len(RT_TASKS)
            and all(s == "THREAD_RUNNING" for s in states.values()),
            f"a thread was left blocked or unregistered: {states}")
    require(rt_plain_calls() == 0, "a plain version ran in the task runs")
    for (i, r), (q, degraded, table) in sorted(results.items()):
        require(not degraded, f"task {i} run {r}: degraded")
        same_tables(torch, table, solo[q].compact(), f"task {i} run {r}")
    contention = sum(m["retry"] + m["split"] + m["reruns"] + m["plan_retries"]
                     for m in task_metrics.values()) + sum(
        1 for m in task_metrics.values() if m["block_ns"] > 0)
    require(contention > 0, f"no retry and no block under a {limit} B "
            f"budget: {task_metrics}")
    del results
    gc.collect()
    out["shared_limit_bytes"] = limit
    out["tasks"] = {f"thread {i} ({RT_TASKS[i]})": {
        "getAndResetNumRetryThrow": m["retry"],
        "getAndResetNumSplitRetryThrow": m["split"],
        "getAndResetBlockTimeNs": m["block_ns"],
        "getAndResetComputeTimeLostToRetryNs": m["lost_ns"],
        "plan_reruns": m["reruns"], "operator_retries": m["plan_retries"]}
        for i, m in sorted(task_metrics.items())}
    out["tasks_wall_ms"] = wall * 1e3
    out["thread_states_after_runs"] = states
    log(f"  four tasks x {RT_RUNS} runs on {limit} B: {wall * 1e3:.1f} ms, "
        f"{json.dumps(out['tasks'])}, states after the runs {states}")
    shared.close()

    # 4. forced OOMs on one operator of q23 (eager), and a spill
    p = plans["q23"]
    with rt.DeviceSession(1 << 50) as sess:
        arb = sess.arbiter
        arb.current_thread_is_dedicated_to_task(2000)
        ex = PlanExecutor(session=sess)
        # more RetryOOMs in a row than op_retries: memory pressure, never
        # a device fault, so each leaves execute() and the plan reruns
        # on the card, with the breaker closed
        n_oom = ex.op_retries + 1
        arb.force_retry_oom(me, n_oom, rt.OomInjectionType.GPU, 3)
        reset_kernel_counters()
        res, reruns = rt_task(rt, arb, ex, p["plan"], p["inputs"])
        rt_card_run(torch, res, "q23 after forced RetryOOMs")
        rt_same(torch, res, solo["q23"], "q23 after forced RetryOOMs")
        require(reruns == n_oom and res.retries == 0
                and res.breaker["state"] == "closed"
                and res.breaker["trips"] == 0,
                f"forced RetryOOMs: {reruns} reruns, retries {res.retries}, "
                f"breaker {res.breaker}")
        out["forced_retry_oom"] = {"forced": n_oom, "reruns": reruns,
                                   "breaker": res.breaker["state"],
                                   "num_retry": arb.
                                   get_and_reset_num_retry_throw(2000)}
        del res
        arb.force_split_and_retry_oom(me, 1, rt.OomInjectionType.GPU, 3)
        res, reruns = rt_task(rt, arb, ex, p["plan"], p["inputs"])
        rt_card_run(torch, res, "q23 after a forced SplitAndRetryOOM")
        rt_same(torch, res, solo["q23"], "q23 after a forced split")
        require(reruns == 1, f"forced SplitAndRetryOOM: {reruns} reruns")
        out["forced_split_oom"] = {
            "reruns": reruns,
            "num_split": arb.get_and_reset_num_split_retry_throw(2000)}
        del res
        arb.task_done(2000)
    log(f"  forced OOMs: {out['forced_retry_oom']}, "
        f"{out['forced_split_oom']}")
    store = p["inputs"]["store"]
    keep = [c.data.clone() for c in store.columns]
    nbytes = store.nbytes()
    pool = rt.SpillPool()
    with rt.DeviceSession(nbytes + nbytes // 2) as sess:
        pool.attach(sess.device)
        sess.arbiter.current_thread_is_dedicated_to_task(3000)
        st = rt.SpillableTable(pool, store)
        st.protect()
        t0 = time.perf_counter()
        r = sess.device.acquire(nbytes)          # fits only after a spill
        spill_ms = (time.perf_counter() - t0) * 1e3
        require(pool.spill_count >= 1 and pool.spilled_bytes >= nbytes // 2,
                f"spill: {pool.spill_count} spills, {pool.spilled_bytes} B")
        sess.device.release(r)
        t0 = time.perf_counter()
        with st.use() as back:
            restore_ms = (time.perf_counter() - t0) * 1e3
            for a, b in zip(back.columns, keep):
                require(a.data.device == b.device
                        and torch.equal(a.data, b),
                        "the spilled table came back different")
        st.close()
        pool.close()
        sess.arbiter.task_done(3000)
    del keep
    out["spill"] = {"bytes": nbytes, "spilled_bytes": pool.spilled_bytes,
                    "spill_ms": spill_ms, "restore_ms": restore_ms}
    log(f"  spill: {out['spill']}")

    # 5. fault injection, with seeded configs (authored q23)
    import shutil
    import tempfile
    from spark_rapids_tpu_torch.ops import cuda_build
    # the configs live beside the builds (listed in .gitignore)
    cuda_build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cfg_dir = tempfile.mkdtemp(prefix="faultinj-",
                               dir=str(cuda_build._BUILD_DIR))

    def install(name, cfg):
        path = os.path.join(cfg_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        return faultinj.install(path)

    faults = {}
    ex = PlanExecutor(optimize=False)
    ref = ex.execute(p["plan"], p["inputs"])
    try:
        # a nonfatal assert at 50% on the hash join: retried, not degraded
        inj = install("assert", {"seed": 3, "computeFaults": {
            "plan.HashJoin": {"percent": 50, "injectionType": 1}}})
        reset_kernel_counters()
        res = ex.execute(p["plan"], p["inputs"])
        rt_card_run(torch, res, "q23 under 50% join asserts")
        rt_same(torch, res, ref, "q23 under 50% join asserts")
        require(res.retries > 0 and res.backoff_ms > 0,
                f"asserts: retries {res.retries}, {res.backoff_ms} ms")
        faults["assert_50"] = {"injected": inj.get_and_reset_injected(),
                               "retries": res.retries,
                               "backoff_ms": res.backoff_ms,
                               "degraded": res.degraded}
        # a fatal fault on the groupby: the breaker trips, the rest of the
        # plan runs on the degraded CPU tier (a named run)
        inj = install("fatal", {"computeFaults": {"plan.HashAggregate": {
            "percent": 100, "injectionType": 0, "interceptionCount": 1}}})
        t0 = time.perf_counter()
        res = ex.execute(p["plan"], p["inputs"])
        fatal_ms = (time.perf_counter() - t0) * 1e3
        require(res.degraded and res.breaker["state"] == "open"
                and res.breaker["reason"] == "fatal",
                f"fatal: degraded {res.degraded}, breaker {res.breaker}")
        rt_same(torch, res, ref, "q23 after a fatal fault")
        faults["fatal_groupby"] = {
            "degraded": res.degraded, "breaker": res.breaker,
            "on_card": [m.label for m in res.metrics.values()
                        if not m.degraded],
            "wall_ms": fatal_ms}
        # reset_device() and a half-open probe on the card: back on it
        ex.health.reset_device()
        reset_kernel_counters()
        res = ex.execute(p["plan"], p["inputs"])
        n = rt_card_run(torch, res, "q23 after reset_device",
                        counted_run=True)
        rt_same(torch, res, ref, "q23 after reset_device")
        require(res.breaker["state"] == "closed",
                f"after the probe: {res.breaker}")
        faults["after_reset"] = {"degraded": res.degraded, "launches": n,
                                 "breaker": res.breaker["state"]}
        faultinj.uninstall()
        del res
        # the capped tier: a program captured into a graph, then a fault
        # before its third run's replay, retried onto the same graph
        cex = PlanExecutor(mode="capped", optimize=False,
                           caps=dict(Q23_CAPS))
        first = cex.execute(p["plan"], p["inputs"])
        second = cex.execute(p["plan"], p["inputs"])
        require(second.graph, f"no graph: {second.graph_reason}")
        inj = install("capped_assert", {"computeFaults": {"plan.Scan": {
            "percent": 100, "injectionType": 1, "interceptionCount": 1}}})
        reset_kernel_counters()
        third = cex.execute(p["plan"], p["inputs"])
        require(third.graph and third.retries == 1 and not third.degraded,
                f"capped run 3: graph {third.graph}, retries "
                f"{third.retries}")
        rt_same(torch, third, ref, "capped q23 run 3 after a fault")
        require(rt_plain_calls() == 0, "a plain version ran in capped run 3")
        # the same fatal fault during a capped attempt: degraded, and no
        # program left half made
        cex2 = PlanExecutor(mode="capped", optimize=False,
                            caps=dict(Q23_CAPS))
        inj = install("capped_fatal", {"computeFaults": {
            "plan.HashAggregate": {"percent": 100, "injectionType": 0,
                                   "interceptionCount": 1}}})
        res = cex2.execute(p["plan"], p["inputs"])
        require(res.degraded and res.mode == "capped",
                f"capped fatal: degraded {res.degraded}")
        rt_same(torch, res, ref, "capped q23 after a fatal fault")
        require(len(cex2._programs) == 0,
                f"{len(cex2._programs)} programs left by the failed attempt")
        bad = [pr.reason for pr in list(cex._programs.values())
               + list(cex2._programs.values())
               if pr.reason.startswith("its capture failed")]
        require(not bad, f"a broken graph in a program cache: {bad}")
        cex2.health.reset_device()
        faultinj.uninstall()
        again = [cex2.execute(p["plan"], p["inputs"]) for _ in range(2)]
        require(not again[-1].degraded and again[-1].graph,
                f"capped after reset: {again[-1].graph_reason}")
        rt_same(torch, again[-1], ref, "capped q23 after reset")
        faults["capped"] = {"graph_after_fault": third.graph,
                            "retries": third.retries,
                            "fatal_degraded": res.degraded,
                            "programs_after_fatal": 0,
                            "graph_after_reset": again[-1].graph}
        del first, second, third, res, again
    finally:
        faultinj.uninstall()
        shutil.rmtree(cfg_dir, ignore_errors=True)
    log(f"  faults: {json.dumps(faults, default=str)}")
    out["faults"] = faults

    # 6. degrade admission under a budget that is too small (a named run)
    prev = os.environ.get("SPARK_RAPIDS_TORCH_CERT_ADMISSION")
    os.environ["SPARK_RAPIDS_TORCH_CERT_ADMISSION"] = "degrade"
    try:
        t0 = time.perf_counter()
        res = PlanExecutor(optimize=False, cert_budget=1 << 20).execute(
            p["plan"], p["inputs"])
        admit_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if prev is None:
            os.environ.pop("SPARK_RAPIDS_TORCH_CERT_ADMISSION", None)
        else:
            os.environ["SPARK_RAPIDS_TORCH_CERT_ADMISSION"] = prev
    require(res.degraded and res.device.type == "cpu"
            and all(m.degraded for m in res.metrics.values()),
            f"degrade admission: degraded {res.degraded} on {res.device}")
    rt_same(torch, res, ref, "q23 under degrade admission")
    out["degrade_admission"] = {"degraded": True, "wall_ms": admit_ms}
    log(f"  degrade admission: the CPU tier in {admit_ms:.1f} ms")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['seconds']:.1f} s")
    return out


# ---- phase 16: Parquet IO and the streaming scan -------------------------------

PQ_ROW_GROUP = 1 << 20            # rows a row group of the written files holds
PQ_CODECS = ("UNCOMPRESSED", "GZIP")
PQ_DEPTHS = (0, 2)                # prefetch depths timed on q5
PQ_TIMED = 3                      # warm runs timed at each depth


def pq_inputs(q, gen):
    """{table: {column: INT64 numpy array}} of q5's or q72's inputs from
    their datagen, named as `q5_inputs` / `q72_inputs` bind them."""
    from spark_rapids_tpu_torch import nds_q72
    if q == "q72":
        return {name: dict(d) for name, d in zip(nds_q72.TABLES, gen)}
    chans, date_sk = gen
    out = {"dates": {"d_date_sk": date_sk}}
    for name, c in chans.items():
        out[f"{name}_sales"] = dict(zip(
            ("sk", "date_sk", "sales_price", "profit"),
            (c["s_sk"], c["s_date"], c["s_price"], c["s_profit"])))
        out[f"{name}_returns"] = dict(zip(
            ("sk", "date_sk", "return_amt", "net_loss"),
            (c["r_sk"], c["r_date"], c["r_amt"], c["r_loss"])))
    return out


def pq_write(q, tables, directory):
    """Every table written by tests/torch_parquet_writer.py in row groups
    of PQ_ROW_GROUP rows, a fact table once a codec and a dimension table
    once (bound with either): ({codec: {table: path}}, seconds, {codec:
    bytes})."""
    import torch_parquet_writer as pw
    paths = {c: {} for c in PQ_CODECS}
    sizes = {c: 0 for c in PQ_CODECS}
    t0 = time.perf_counter()
    for name, cols in tables.items():
        fact = (name == "cs" if q == "q72"
                else name.endswith(("_sales", "_returns")))
        for codec in PQ_CODECS if fact else PQ_CODECS[:1]:
            path = os.path.join(directory,
                                f"{q}_{name}_{codec.lower()}.parquet")
            sizes[codec] += pw.write_table(path, list(cols),
                                           list(cols.values()),
                                           PQ_ROW_GROUP, codec)
            paths[codec][name] = path
        paths["GZIP"].setdefault(name, paths["UNCOMPRESSED"][name])
    return paths, time.perf_counter() - t0, sizes


def pq_counted(torch, ex, plan, inputs, what):
    """One run with every kernel counter zeroed just before and read just
    after; no plain version may run. -> (result, the counters that are
    not 0)."""
    torch.cuda.synchronize()
    reset_kernel_counters()
    res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    counters = kernel_counters()
    require(counted(counters["plain"]) == 0,
            f"{what}: a plain version ran: {counters['plain']}")
    launched = {k: {n: v for n, v in c.items() if v}
                for k, c in counters.items() if k != "plain"}
    return res, {k: c for k, c in launched.items() if c}


def pq_scan_io(res):
    """The run's Parquet scans' counters, summed over its Scans."""
    scans = [m for m in res.metrics.values()
             if m.kind == "Scan" and m.io_row_groups_total]
    return {"scans": len(scans),
            "row_groups": sum(m.io_row_groups_total for m in scans),
            "pruned": sum(m.io_row_groups_pruned for m in scans),
            "bytes_skipped": sum(m.io_bytes_skipped for m in scans),
            "rows": sum(m.rows_out for m in scans),
            "decode_ms": sum(m.io_decode_ms for m in scans),
            "h2d_ms": sum(m.io_h2d_ms for m in scans),
            "overlap_ms": sum(m.io_overlap_ms for m in scans)}


def pq_equal(chk, got, want, what):
    """`Checks.tables` with validity compared as the rows it marks: a
    streamed aggregate's merged counts and sums carry an all-valid mask
    where the one-pass aggregate has none, as in the reference."""
    import torch
    require(got.names == want.names and got.num_rows == want.num_rows,
            f"{what}: {got.names} x {got.num_rows} vs {want.names} x "
            f"{want.num_rows}")
    for name, a, b in zip(got.names, got.columns, want.columns):
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        chk.equal("plans", a.data.view(bits.get(a.data.dtype, a.data.dtype)),
                  b.data.view(bits.get(b.data.dtype, b.data.dtype)),
                  f"{what} {name}")
        chk.equal("plans", a.null_mask, b.null_mask,
                  f"{what} {name} validity")


def pq_numpy_check(got, ref, what):
    for name, want in zip(got.names, ref):
        require(np.array_equal(got[name].data.numpy(), want),
                f"{what}: {name} differs from numpy")


def pq_pruning(torch, chk, gen, directory):
    """store_sales ordered by date (as a date-clustered fact table is),
    scanned through `PlanBuilder.scan(parquet=...)` under q5's 14-day
    window: scan_pruning must skip row groups by their footer statistics;
    the result equals the plan over the materialized table on the card
    and numpy."""
    import torch_parquet_writer as pw
    from spark_rapids_tpu_torch import nds_q5, table_from_numpy
    from spark_rapids_tpu_torch.plan import PlanBuilder, PlanExecutor, col
    c = gen[0]["store"]
    order = np.argsort(c["s_date"], kind="stable")
    names = ("sk", "date_sk", "sales_price", "profit")
    arrays = [c[k][order] for k in ("s_sk", "s_date", "s_price",
                                    "s_profit")]
    path = os.path.join(directory, "q5_store_sales_by_date.parquet")
    file_bytes = pw.write_table(path, names, arrays, PQ_ROW_GROUP)

    def plan(**scan):
        return (PlanBuilder().scan("ss", **scan)
                .filter((col("date_sk") >= nds_q5.DATE_LO)
                        & (col("date_sk") < nds_q5.DATE_HI))
                .aggregate(["sk"], [("sales_price", "sum", "s"),
                                    ("sales_price", "count", "c")])
                .sort(["sk"]).build())
    what = "q5 store_sales window by date"
    res, counters = pq_counted(torch, PlanExecutor(), plan(parquet=path),
                               None, what)
    io = pq_scan_io(res)
    table = table_from_numpy(list(names), arrays, [None] * 4,
                             ["int64"] * 4, device="cuda")
    mat = PlanExecutor().execute(plan(schema=list(names)), {"ss": table})
    got = res.table.to("cpu")
    pq_equal(chk, got, mat.table.to("cpu"),
             f"{what} vs the materialized run")
    keep = (arrays[1] >= nds_q5.DATE_LO) & (arrays[1] < nds_q5.DATE_HI)
    sk, inv = np.unique(arrays[0][keep], return_inverse=True)
    sums = np.zeros(len(sk), np.int64)
    np.add.at(sums, inv, arrays[2][keep])
    pq_numpy_check(got, (sk, sums, np.bincount(inv).astype(np.int64)), what)
    kept = io["row_groups"] - io["pruned"]
    log(f"{what}: {io['row_groups']} row groups, {io['pruned']} pruned, "
        f"{io['bytes_skipped']} of {file_bytes} B skipped; "
        f"{res.optimizer['rules_fired']}; groupby launches "
        f"{counters['groupby']}")
    require(res.optimizer["rules_fired"].get("scan_pruning") == 1
            and io["row_groups"] == -(-len(order) // PQ_ROW_GROUP)
            and 0 < io["pruned"] < io["row_groups"]
            and io["bytes_skipped"] > 0,
            f"{what}: pruning {io}")
    # the tail aggregate merges per-chunk partials: one launch a kept
    # chunk and one for the merge
    launches = counters.get("groupby", {}).get("groupby", 0)
    require(0 < launches <= kept + 1,
            f"{what}: groupby launches {counters['groupby']} for {kept} "
            "chunks")
    return {"file_bytes": file_bytes, **io,
            "rules_fired": res.optimizer["rules_fired"],
            "wall_ms": res.wall_ms, "counters": counters}


def pq_depths(torch, plan, sources, what):
    """The plan streamed at each prefetch depth: warm runs' walls, the
    scans' decode, copy and overlap, rows decoded per decode second, and a
    traced run's idle share."""
    from spark_rapids_tpu_torch.plan import PlanExecutor
    prev = os.environ.get("SPARK_RAPIDS_TORCH_IO_PREFETCH")
    out = {}
    try:
        for depth in PQ_DEPTHS:
            os.environ["SPARK_RAPIDS_TORCH_IO_PREFETCH"] = str(depth)
            ex = PlanExecutor()
            ex.execute(plan, sources)
            walls, ios, table = [], [], None
            for _ in range(PQ_TIMED):
                t0 = time.perf_counter()
                res = ex.execute(plan, sources)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                ios.append(pq_scan_io(res))
                table = res.table
            trace = traced_run(torch, lambda: ex.execute(plan, sources))
            med = sorted(range(PQ_TIMED), key=lambda i: walls[i])[
                PQ_TIMED // 2]
            io = ios[med]
            entry = {"execute_ms": walls, "median_execute_ms": walls[med],
                     **io,
                     "rows_per_s": io["rows"] / (io["decode_ms"] / 1e3),
                     "decode_share": io["decode_ms"] / walls[med],
                     "idle_share": trace["idle_share"],
                     "traced_wall_ms": trace["wall_ms"],
                     "busy_ms": trace["busy_ms"],
                     "htod_copies": trace["htod_copies"]}
            out[depth] = (entry, table)
            log(f"{what} at prefetch depth {depth}: execute "
                f"{walls[med]:.1f} ms (runs {[round(w, 1) for w in walls]}),"
                f" decode {io['decode_ms']:.1f} ms, H2D "
                f"{io['h2d_ms']:.1f} ms, overlap {io['overlap_ms']:.1f} ms, "
                f"{entry['rows_per_s']:.4g} rows/s decoded, idle share "
                f"{trace['idle_share']!r} ({trace['busy_ms']!r} busy of "
                f"{trace['wall_ms']!r} ms)")
    finally:
        if prev is None:
            os.environ.pop("SPARK_RAPIDS_TORCH_IO_PREFETCH", None)
        else:
            os.environ["SPARK_RAPIDS_TORCH_IO_PREFETCH"] = prev
    return out


def parquet_phase(torch, chk, smi):
    """Phase 16: NDS q5 and q72 at N_SALES from Parquet files that
    tests/torch_parquet_writer.py writes here (row groups of 1,048,576
    rows; each fact table once uncompressed and once GZIP, with dictionary
    pages), through `PlanExecutor` eager and capped, authored and
    optimized (and eager optimized over the GZIP files), every kernel
    counter zeroed just before each run and read just after (the plans'
    groupby and hash-join kernels launched, no plain version): each result
    equal to the same plan over the materialized tables on the card and
    to numpy; a date-window plan whose scan_pruning skips row groups; q5
    streamed at prefetch depths 0 and 2 with its decode, copy, overlap,
    decode rate, wall and idle share; every committed fixture
    (tests/data/torch_parquet) read onto the card and held to its seed
    values."""
    import tempfile
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_parquet_writer as pw
    from spark_rapids_tpu_torch import nds_q5, nds_q72
    from spark_rapids_tpu_torch.io import ParquetSource, read_parquet
    from spark_rapids_tpu_torch.native import build as native_build
    from spark_rapids_tpu_torch.ops import groupby_cuda as gc
    from spark_rapids_tpu_torch.plan import PlanExecutor
    t_phase = time.perf_counter()
    flags = native_build.link_flags("parquet_reader")
    out = {"card": smi, "native_build_s": dict(NATIVE_BUILD),
           "reader_link_flags": list(flags), "queries": {}}
    log(f"phase 16: Parquet IO and the streaming scan ({smi}); the reader "
        f"links {list(flags)}; snappy is decoded in the reader itself")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parquet_") as tmp:
        for q, mod, numpy_fn, caps in (("q5", nds_q5, numpy_q5, Q5_CAPS),
                                       ("q72", nds_q72, numpy_q72, None)):
            gen = mod.datagen(N_SALES, seed=0)
            ref = numpy_fn(gen)
            if q == "q5":
                ref = ref[0]
            tables = pq_inputs(q, gen)
            paths, write_s, sizes = pq_write(q, tables, tmp)
            n_rows = sum(len(next(iter(c.values())))
                         for c in tables.values())
            log(f"{q}: {n_rows} rows written in {write_s:.1f} s "
                f"({sizes} B)")
            del tables
            plan = getattr(mod, f"{q}_plan")()
            mat_in = getattr(mod, f"{q}_inputs")(N_SALES, seed=0,
                                                 device="cuda")
            mat = PlanExecutor().execute(plan, mat_in).table.to("cpu")
            del mat_in
            pq_numpy_check(mat, ref, f"{q} materialized")
            sources = {codec: {n: ParquetSource(p) for n, p in ps.items()}
                       for codec, ps in paths.items()}
            entry = {"rows": n_rows, "write_s": write_s, "bytes": sizes,
                     "runs": {}}
            for mode, optimize, codec in (
                    ("eager", False, "UNCOMPRESSED"),
                    ("eager", True, "UNCOMPRESSED"),
                    ("capped", False, "UNCOMPRESSED"),
                    ("capped", True, "UNCOMPRESSED"),
                    ("eager", True, "GZIP")):
                what = (f"{q} {mode} "
                        f"{'optimized' if optimize else 'authored'} from "
                        f"{codec} Parquet")
                ex = PlanExecutor(mode=mode, optimize=optimize,
                                  caps=dict(caps) if caps and
                                  mode == "capped" else None)
                t0 = time.perf_counter()
                res, counters = pq_counted(torch, ex, plan,
                                           sources[codec], what)
                call_ms = (time.perf_counter() - t0) * 1e3
                got = (res.compact() if mode == "capped"
                       else res.table).to("cpu")
                pq_equal(chk, got, mat, f"{what} vs the materialized run")
                pq_numpy_check(got, ref, what)
                n_keyed = require_groupby(gc, res, what)
                joins = [n for n in res.plan.nodes if n.kind == "HashJoin"]
                require(n_keyed > 0 and counters.get("hash_join", {}).get(
                            "build", 0) >= len(joins) > 0,
                        f"{what}: {len(joins)} joins, counters {counters}")
                io = pq_scan_io(res)
                require(io["scans"] == len(plan.scans)
                        and io["rows"] == n_rows,
                        f"{what}: scans {io}")
                log(f"{what}: {res.wall_ms:.1f} ms plan wall, "
                    f"{call_ms:.1f} ms execute(); {io}; equal to the "
                    f"materialized run and numpy")
                entry["runs"][what] = {"wall_ms": res.wall_ms,
                                       "execute_ms": call_ms, **io,
                                       "counters": counters,
                                       "attempts": res.attempts}
            if q == "q5":
                depths = pq_depths(torch, plan, sources["UNCOMPRESSED"],
                                   "q5 eager optimized")
                for depth, (e, table) in depths.items():
                    pq_equal(chk, table.to("cpu"), mat,
                             f"q5 at prefetch depth {depth}")
                entry["depths"] = {d: e for d, (e, _) in depths.items()}
                out["pruning"] = pq_pruning(torch, chk, gen, tmp)
            out["queries"][q] = entry
            del gen, sources, mat
            torch.cuda.empty_cache()
    fixtures = {}
    for name in pw.FIXTURES:
        t = read_parquet(os.path.join(pw.DATA_DIR, name + ".parquet"))
        want = pw.fixture_values(name)
        require(t.device.type == "cuda" and list(t.names) == list(want),
                f"fixture {name}: {t.device} {t.names}")
        for c, rows in want.items():
            require(t[c].to_pylist() == rows,
                    f"fixture {name}: column {c} differs from its seed")
        fixtures[name] = {c: str(t[c].dtype) for c in want}
    log(f"fixtures read on the card, equal to their seeds: {fixtures}")
    out["fixtures"] = fixtures
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['seconds']:.1f} s")
    return out


# ---- phase 17: time zones, the calendar rebase, Z-order, percentiles --------

DZH_N = 16_777_216                 # rows a main-path call (the casts' size)
DZH_HISTS = 1_048_576              # histograms of 1-64 values each
DZH_MAX_LEN = 64
DZH_ZONES = ("Asia/Shanghai", "Asia/Kolkata", "Pacific/Kiritimati", "+05:30")
DZH_PCTS = [0.0, 0.25, 0.5, 0.75, 0.99, 1.0]
DZH_SLICE = 262_144                # rows a CPU plain run (its tensors in L2)
DZH_HIST_SLICE = 65_536            # histograms a CPU plain run
DZH_ITERS = 5
DZH_SOURCES = {k: f"spark_rapids_tpu_torch/ops/csrc/{k}.cu"
               for k in ("timezones", "datetime_rebase", "zorder",
                         "histogram")}
DZH_REPLACES = {
    "timezones": "none: spark_rapids_tpu/ops/timezones.py:296 "
                 "(_convert_kernel) (XLA ops, no pallas_call)",
    "datetime_rebase": "none: spark_rapids_tpu/ops/datetime_rebase.py:89 "
                       "(_greg_to_julian_days), :97 (_julian_to_greg_days), "
                       ":113 (_rebase_micros) (XLA ops, no pallas_call)",
    "zorder": "none: spark_rapids_tpu/ops/zorder.py:59 (interleave_bits), "
              ":84 (hilbert_index) (XLA ops, no pallas_call)",
    "histogram": "none: spark_rapids_tpu/ops/histogram.py:153 "
                 "(_percentile_kernel) (XLA ops, no pallas_call)"}
# The least work of each function, for the bound, in 32-bit integer
# instructions (a 64-bit add, compare or select counts two, a division by
# a constant a multiply-high, a shift and a sign fix-up):
# - a time-zone row: the truncating division to seconds (6), the offset's
#   gather, scaling and 64-bit add or subtract (6), and a search step a
#   transition bit (a 64-bit compare and the bound's select: 4) over
#   ceil(log2(k + 1)) steps;
# - a rebase row: the compare with the switch (2); a row before it adds
#   the calendar arithmetic, two day algorithms of about 13 floor
#   divisions by constants (6 each) and 25 64-bit adds, multiplies and
#   selects (2 each): 128;
# - an interleaved output bit: one bit-field insert;
# - a Hilbert bit of a column: Skilling's test and exchange-or-invert (4),
#   its share of the Gray code (1) and its deposit (1): 6;
# - a histogram element: its 64-bit running sum and a compare (4); the
#   bound counts no sorting.
# Bytes: each input buffer read once (data, validity where the column has
# one, a zone's 12-byte transitions, list offsets), each output written
# once (data, offsets, a percentile's validity).
TZ_ROW_OPS = 12
TZ_STEP_OPS = 4
REBASE_ROW_OPS = 2
REBASE_EARLY_OPS = 128
INTERLEAVE_BIT_OPS = 1
HILBERT_BIT_OPS = 6
PCT_ELEM_OPS = 4
NVCC_SECONDS = {}                  # build_phase's nvcc seconds by source


def dzh_bits(torch, t):
    """A tensor as integers of its width (floats by their bits), on the
    CPU."""
    t = t.cpu()
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def dzh_same(torch, chk, kernel, got, want, what):
    """Two port columns equal in every buffer: data (every row, by its
    bits), validity (None on both sides or equal), offsets and children."""
    if (got.validity is None) != (want.validity is None) or \
            got.length != want.length or got.dtype != want.dtype:
        chk.max_err[kernel] = max(chk.max_err[kernel], 1)
        raise AssertionError(f"{what}: {got.dtype!r} x {got.length}, "
                             f"validity {got.validity is not None} vs "
                             f"{want.dtype!r} x {want.length}, "
                             f"{want.validity is not None}")
    for a, b, part in ((got.data, want.data, "data"),
                       (got.validity, want.validity, "validity"),
                       (got.offsets, want.offsets, "offsets")):
        if a is not None:
            chk.equal(kernel, dzh_bits(torch, a), dzh_bits(torch, b),
                      f"{what} {part}")
    for i, (g, w) in enumerate(zip(got.children, want.children)):
        dzh_same(torch, chk, kernel, g, w, f"{what} child {i}")


def dzh_corpus_checks(torch, chk):
    """The JAX tests' cases on the card: each result equal to the CPU run
    (the plain version), bit for bit, and to the oracle."""
    tests_on_path()
    import torch_datetime_inputs as di
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column
    tzdb = api.GpuTimeZoneDB
    cases = [0]

    def card_and_cpu(kernel, fn, cols, what):
        got = fn(*[c.to("cuda") for c in cols])
        dzh_same(torch, chk, kernel, got, fn(*cols), what)
        cases[0] += 1
        return got

    def us(values, dtype=dt.TIMESTAMP_US):
        return Column.from_numpy(np.array(values, np.int64), dtype,
                                 device="cpu")
    rand_v, rand_ok = di.timestamps(9, 4096)
    rand = Column.from_numpy(rand_v, dt.TIMESTAMP_US, rand_ok, device="cpu")
    for zone in di.SUPPORTED_ZONES:
        if not tzdb.isSupportedTimeZone(zone):
            log(f"  {zone} has recurring rules in this tzdata: skipped")
            continue
        for fn, micros, oracle in (
                (tzdb.fromTimestampToUtcTimestamp, di.ZONE_TO_UTC_MICROS,
                 di.wall_to_utc_oracle),
                (tzdb.fromUtcTimestampToTimestamp, di.UTC_TO_ZONE_MICROS,
                 di.utc_to_wall_oracle)):
            card_and_cpu("timezones", lambda c: fn(c, zone), [rand],
                         f"{zone} random")
            got = card_and_cpu("timezones", lambda c: fn(c, zone),
                               [us(micros)], f"{zone} oracle")
            require(got.to_pylist() == oracle(micros, zone),
                    f"{zone}: the card differs from zoneinfo")
    got = card_and_cpu("timezones", lambda c: tzdb.fromTimestampToUtcTimestamp(
        c, "Pacific/Kiritimati"), [us([di.KIRITIMATI_GAP_WALL])],
        "Kiritimati's skipped day")
    require(got.to_pylist() == di.wall_to_utc_oracle(
        [di.KIRITIMATI_GAP_WALL], "Pacific/Kiritimati"),
        "Kiritimati's skipped day differs from zoneinfo")
    for zone, offset in di.FIXED_ZONES:
        for fn, sign in ((tzdb.fromTimestampToUtcTimestamp, -1),
                         (tzdb.fromUtcTimestampToTimestamp, 1)):
            got = card_and_cpu("timezones", lambda c: fn(c, zone),
                               [us(di.FIXED_MICROS)], f"{zone}")
            require(got.to_pylist() == [m + sign * offset * 1_000_000
                                        for m in di.FIXED_MICROS],
                    f"{zone}: not the fixed offset")
    for kind, scale in ((dt.TIMESTAMP_S, 1), (dt.TIMESTAMP_MS, 1000)):
        v, ok = di.timestamps(10, 4096, scale=scale)
        col = Column.from_numpy(v, kind, ok, device="cpu")
        for fn in (tzdb.fromTimestampToUtcTimestamp,
                   tzdb.fromUtcTimestampToTimestamp):
            card_and_cpu("timezones", lambda c: fn(c, "Asia/Tokyo"), [col],
                         f"{kind!r} Asia/Tokyo")
    if not tzdb.isSupportedTimeZone(di.UNSUPPORTED_ZONE):
        try:
            tzdb.fromUtcTimestampToTimestamp(us([0]).to("cuda"),
                                             di.UNSUPPORTED_ZONE)
            raise AssertionError(f"{di.UNSUPPORTED_ZONE} did not raise")
        except ValueError:
            cases[0] += 1
    # the calendars
    R = api.DateTimeRebase

    def days(values):
        return Column.from_numpy(np.array(values, np.int32), dt.DATE32,
                                 device="cpu")
    got = card_and_cpu("datetime_rebase", R.rebaseGregorianToJulian, [days(
        [di.greg_days(*d) for d, _ in di.GREG_TO_JULIAN])], "oracle dates")
    require(got.to_pylist() == [w for _, w in di.GREG_TO_JULIAN],
            "Gregorian to Julian differs from the oracle")
    got = card_and_cpu("datetime_rebase", R.rebaseJulianToGregorian, [days(
        [d for d, _ in di.JULIAN_TO_GREG])], "Julian oracle dates")
    require(got.to_pylist() == [w for _, w in di.JULIAN_TO_GREG],
            "Julian to Gregorian differs from the oracle")
    got = card_and_cpu("datetime_rebase", R.rebaseGregorianToJulian,
                       [days(di.GAP_DAYS)], "gap dates")
    require(got.to_pylist() == [di.GREGORIAN_START_DAYS] * len(di.GAP_DAYS),
            "the gap dates do not go to the Gregorian start")
    base = di.greg_days(1500, 1, 1)
    got = card_and_cpu("datetime_rebase", R.rebaseGregorianToJulian, [us(
        [base * di.DAY_US + t for t in di.TIMES_OF_DAY])], "times of day")
    require(got.to_pylist() == [di.julian_days_from_ymd(1500, 1, 1) *
                                di.DAY_US + t for t in di.TIMES_OF_DAY],
            "micros lose their time of day")
    for make, kind in ((di.rebase_days, dt.DATE32),
                       (di.rebase_micros, dt.TIMESTAMP_US)):
        v, ok = make(3, 20_000)
        col = Column.from_numpy(v, kind, ok, device="cpu")
        for fn in (R.rebaseGregorianToJulian, R.rebaseJulianToGregorian):
            card_and_cpu("datetime_rebase", fn, [col], f"random {kind!r}")
    # Z-order
    Z = api.ZOrder
    for name, np_type in di.ZORDER_TYPES:
        kind = dt.DType(dt.Kind[name])
        for ncols in (1, 4):
            cols = [Column.from_numpy(v, kind, ok, device="cpu")
                    for v, ok in di.zorder_columns(0, np_type, ncols, 300)]
            got = card_and_cpu("zorder", lambda *c: Z.interleaveBits(
                300, *c), cols, f"interleave {name} x {ncols}")
            nbits = kind.itemsize() * 8
            vals = [di.unsigned_bits(v, ok, nbits) for v, ok in
                    di.zorder_columns(0, np_type, ncols, 300)]
            require(got.to_pylist() == di.oracle_interleave(
                list(zip(*vals)), nbits), f"interleave {name}: the oracle")
    for bits, ncols in di.HILBERT_SHAPES:
        raw = di.zorder_columns(bits, np.int32, ncols, 300)
        cols = [Column.from_numpy(v, dt.INT32, ok, device="cpu")
                for v, ok in raw]
        got = card_and_cpu("zorder", lambda *c: Z.hilbertIndex(
            bits, 300, *c), cols, f"hilbert {bits} x {ncols}")
        vals = [di.unsigned_bits(v, ok, 32) for v, ok in raw]
        require(got.to_pylist() == [di.oracle_hilbert(list(p), bits)
                                    for p in zip(*vals)],
                f"hilbert {bits} x {ncols}: the oracle")
    xs, ys = (Column.from_pylist(v, dt.INT32, device="cuda")
              for v in di.HILBERT_2D)
    require(sorted(Z.hilbertIndex(1, 4, xs, ys).to_pylist()) == [0, 1, 2, 3],
            "the 2-D curve's order")
    empty = Column.from_numpy(np.zeros(0, np.int32), dt.INT32, device="cuda")
    got = Z.interleaveBits(0, empty, empty)
    require(got.length == 0 and got.offsets.tolist() == [0],
            "interleave over zero rows")
    # histograms
    H = api.Histogram
    values, valid, counts, offsets = [], [], [], [0]
    for h in di.ORACLE_HISTOGRAMS:
        for v, f in h:
            values.append(0 if v is None else v)
            valid.append(v is not None)
            counts.append(f)
        offsets.append(len(values))

    def hist_col(values, valid, counts, offsets, kind=dt.INT32):
        st = Column.make_struct(
            value=Column.from_numpy(np.asarray(values), kind,
                                    np.asarray(valid), device="cpu"),
            freq=Column.from_numpy(np.asarray(counts, np.int64), dt.INT64,
                                   device="cpu"))
        return Column.make_list(torch.tensor(np.asarray(offsets, np.int32)),
                                st)
    col = hist_col(np.array(values, np.int32), valid, counts, offsets)
    for pcts in di.PERCENTAGES:
        for as_list in (True, False):
            got = card_and_cpu("percentile", lambda c: H.percentileFromHistogram(
                c, pcts, as_list), [col], f"oracle histograms {pcts}")
            if as_list:
                for g, h in zip(got.to_pylist(), di.ORACLE_HISTOGRAMS):
                    want = di.percentile_oracle(h, pcts)
                    require((g is None) == (want is None) and (
                        g is None or np.allclose(g, want, rtol=1e-14,
                                                 atol=1e-12)),
                            f"percentile {g} against Spark's {want}")
    v, c, pcts, want = di.NEGATIVE_COUNT
    neg = hist_col(np.array(v), [True] * 4, c, [0, 4], dt.FLOAT64)
    got = card_and_cpu("percentile", lambda c_: H.percentileFromHistogram(
        c_, pcts, False), [neg], "negative count")
    require(got.to_pylist() == want, f"negative count: {got.to_pylist()}")
    for kind_name, np_type in (("FLOAT64", np.float64), ("INT64", np.int64),
                               ("INT8", np.int8), ("BOOL", np.bool_)):
        hv, hok, hc, ho = di.random_histograms(5, 3000, 80, null_p=0.05,
                                               max_count=9,
                                               value_kind=np_type)
        col = hist_col(hv, hok, hc, ho, dt.DType(dt.Kind[kind_name]))
        for as_list in (True, False):
            card_and_cpu("percentile", lambda c_: H.percentileFromHistogram(
                c_, DZH_PCTS, as_list), [col], f"random {kind_name}")
        neg = hist_col(hv, hok, hc - 5, ho, dt.DType(dt.Kind[kind_name]))
        card_and_cpu("percentile", lambda c_: H.percentileFromHistogram(
            c_, DZH_PCTS, False), [neg], f"random {kind_name} negative")
    for offs in ([0, 0, 0], [0]):
        col = hist_col(np.zeros(0, np.int32), np.zeros(0, bool),
                       np.zeros(0, np.int64), offs)
        for as_list in (True, False):
            card_and_cpu("percentile", lambda c_: H.percentileFromHistogram(
                c_, [0.5], as_list), [col], f"empty batch {offs}")
    fv, fok, ff, _ = di.random_histograms(6, 1000, 3, null_p=0.1,
                                          max_count=3)
    for as_lists in (True, False):
        card_and_cpu("percentile", lambda a, b: H.createHistogramIfValid(
            a, b, as_lists), [Column.from_numpy(fv, dt.FLOAT64, fok,
                                                device="cpu"),
                              Column.from_numpy(ff, dt.INT64, device="cpu")],
            "createHistogramIfValid")
    torch.cuda.synchronize()
    return cases[0]


def dzh_inputs(torch):
    """The main path's data, made with numpy from seeds (host copies kept
    for the CPU checks): 16,777,216 timestamps (us and ms) of 1900-2100,
    days and micros of 0001-2100 with a fifth before the switch, 4 INT32,
    2 INT64 and 3 FLOAT64 columns, each with 1% nulls, and 1,048,576
    histograms of 1-64 FLOAT64 values (1% null) and counts 0-1,000."""
    tests_on_path()
    import torch_datetime_inputs as di
    from spark_rapids_tpu_torch import dtypes as dt
    from spark_rapids_tpu_torch.columnar import Column

    def pair(v, ok, kind):
        cpu = Column.from_numpy(v, kind, ok, device="cpu")
        return cpu, cpu.to("cuda")
    cols = {"us": pair(*di.timestamps(21, DZH_N), dt.TIMESTAMP_US),
            "ms": pair(*di.timestamps(22, DZH_N, scale=1000),
                       dt.TIMESTAMP_MS),
            "days": pair(*di.rebase_days(23, DZH_N), dt.DATE32),
            "micros": pair(*di.rebase_micros(24, DZH_N), dt.TIMESTAMP_US)}
    for name, seed, np_type, kind, ncols in (
            ("int32", 25, np.int32, dt.INT32, 4),
            ("int64", 26, np.int64, dt.INT64, 2),
            ("float64", 27, np.float64, dt.FLOAT64, 3)):
        cols[name] = [pair(v, ok, kind) for v, ok in di.zorder_columns(
            seed, np_type, ncols, DZH_N, null_p=0.01)]
    hv, hok, hc, ho = di.random_histograms(28, DZH_HISTS, DZH_MAX_LEN,
                                           null_p=0.01, max_count=1000,
                                           min_len=1)
    cols["hist_values"] = pair(hv, hok, dt.FLOAT64)
    cols["hist_freqs"] = pair(hc, None, dt.INT64)
    cols["hist_rows"] = torch.from_numpy(ho.astype(np.int64))
    torch.cuda.synchronize()
    return cols


def dzh_call(torch, fn, want, what):
    """One main-path call, every counter zeroed just before and read just
    after: `want` the launches by counter and op; nothing else counted."""
    torch.cuda.synchronize()
    reset_kernel_counters()
    out = fn()
    torch.cuda.synchronize()
    counters = kernel_counters()
    for key, ops in want.items():
        got = {op: k for op, k in counters[key].items() if k}
        require(got == ops, f"{what}: launches {got}, want {ops}")
    require(counted(counters) == sum(sum(v.values()) for v in want.values()),
            f"{what}: counters {counters}: another kernel or a plain run")
    return out


def dzh_main_path(torch, cols):
    """The main path once through the api -> (outputs on the card, by
    name; launches by kernel)."""
    from spark_rapids_tpu_torch import api
    from spark_rapids_tpu_torch.columnar import Column
    T, R, Z, H = (api.GpuTimeZoneDB, api.DateTimeRebase, api.ZOrder,
                  api.Histogram)
    outs, launches = {}, {k: 0 for k in DZH_SOURCES}
    calls = []
    for zone in DZH_ZONES:
        calls += [(f"to_utc {zone}", "timezones", {"to_utc": 1},
                   lambda z=zone: T.fromTimestampToUtcTimestamp(
                       cols["us"][1], z)),
                  (f"from_utc {zone}", "timezones", {"from_utc": 1},
                   lambda z=zone: T.fromUtcTimestampToTimestamp(
                       cols["us"][1], z))]
    calls += [("to_utc Asia/Shanghai ms", "timezones", {"to_utc": 1},
               lambda: T.fromTimestampToUtcTimestamp(cols["ms"][1],
                                                     "Asia/Shanghai")),
              ("from_utc Asia/Shanghai ms", "timezones", {"from_utc": 1},
               lambda: T.fromUtcTimestampToTimestamp(cols["ms"][1],
                                                     "Asia/Shanghai"))]
    for name in ("days", "micros"):
        calls += [(f"to_julian {name}", "datetime_rebase", {"to_julian": 1},
                   lambda n=name: R.rebaseGregorianToJulian(cols[n][1])),
                  (f"to_gregorian {name}", "datetime_rebase",
                   {"to_gregorian": 1},
                   lambda n=name: R.rebaseJulianToGregorian(cols[n][1]))]
    for name in ("int32", "int64", "float64"):
        calls.append((f"interleave {name}", "zorder", {"interleave": 1},
                      lambda n=name: Z.interleaveBits(
                          DZH_N, *[c for _, c in cols[n]])))
    for bits, ncols in ((16, 4), (32, 2)):
        calls.append((f"hilbert {bits} x {ncols}", "zorder", {"hilbert": 1},
                      lambda b=bits, k=ncols: Z.hilbertIndex(
                          b, DZH_N, *[c for _, c in cols["int32"][:k]])))
    for what, kernel, ops, fn in calls:
        outs[what] = dzh_call(torch, fn, {kernel: ops}, what)
        launches[kernel] += 1
    created = dzh_call(torch, lambda: H.createHistogramIfValid(
        cols["hist_values"][1], cols["hist_freqs"][1], True), {},
        "createHistogramIfValid")
    outs["createHistogramIfValid"] = created
    # the merged histograms: each histogram's rows of the created lists
    offs = created.offsets[cols["hist_rows"].to(created.offsets.device)]
    hists = Column.make_list(offs, created.children[0])
    for as_list in (True, False):
        what = f"percentile {'lists' if as_list else 'flat'}"
        outs[what] = dzh_call(torch, lambda a=as_list: H.percentileFromHistogram(
            hists, DZH_PCTS, a), {"percentile": {"percentile": 1}}, what)
        launches["histogram"] += 1
    outs["hists"] = hists
    return outs, launches


def dzh_cpu(torch, outs):
    """The outputs' host copies (taken on the main thread, before the CPU
    checks start, so that no copy lands in a timed profile)."""
    return {k: v.to("cpu") for k, v in outs.items()}


def dzh_slices(n, step=DZH_SLICE):
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def dzh_rows(col, a, b):
    """Rows [a, b) of a fixed-width column."""
    from spark_rapids_tpu_torch.columnar import Column
    v = None if col.validity is None else col.validity[a:b]
    return Column(col.dtype, b - a, col.data[a:b], v)


def dzh_cpu_checks(torch, cols, got):
    """Every main-path output against the plain version on the CPU copies
    of its inputs, in slices (every slice checked) -> (Checks, seconds).
    Runs on a worker thread beside the timing."""
    from spark_rapids_tpu_torch.columnar import Column
    from spark_rapids_tpu_torch.ops import datetime_rebase as drm
    from spark_rapids_tpu_torch.ops import histogram as hm
    from spark_rapids_tpu_torch.ops import timezones as tzm
    from spark_rapids_tpu_torch.ops import zorder as zm
    chk = Checks()
    t0 = time.perf_counter()
    for what, out in got.items():
        head = what.split(" ")[0]
        if head in ("to_utc", "from_utc"):
            zone = what.split(" ")[1]
            src = cols["ms" if what.endswith(" ms") else "us"][0]
            fn = (tzm.from_timestamp_to_utc_timestamp if head == "to_utc"
                  else tzm.from_utc_timestamp_to_timestamp)
            kernel = "timezones"
        elif head in ("to_julian", "to_gregorian"):
            src = cols[what.split(" ")[1]][0]
            fn = (drm.rebase_gregorian_to_julian if head == "to_julian"
                  else drm.rebase_julian_to_gregorian)
            zone, kernel = None, "datetime_rebase"
        else:
            continue
        for a, b in dzh_slices(DZH_N):
            part = dzh_rows(src, a, b)
            want = fn(part, zone) if zone else fn(part)
            dzh_same(torch, chk, kernel, dzh_rows(out, a, b), want,
                     f"{what} rows {a}-{b}")
    for name in ("int32", "int64", "float64"):
        out = got[f"interleave {name}"]
        size = cols[name][0][0].dtype.itemsize() * len(cols[name])
        chk.equal("zorder", out.offsets, torch.arange(
            DZH_N + 1, dtype=torch.int32) * size, f"interleave {name} offsets")
        data = out.children[0].data.reshape(DZH_N, size)
        for a, b in dzh_slices(DZH_N):
            want = zm.interleave_bits([dzh_rows(c, a, b)
                                       for c, _ in cols[name]])
            chk.equal("zorder", data[a:b].reshape(-1),
                      want.children[0].data, f"interleave {name} rows {a}-{b}")
    for bits, ncols in ((16, 4), (32, 2)):
        out = got[f"hilbert {bits} x {ncols}"]
        for a, b in dzh_slices(DZH_N):
            want = zm.hilbert_index(bits, [dzh_rows(c, a, b)
                                           for c, _ in cols["int32"][:ncols]])
            chk.equal("zorder", out.data[a:b], want.data,
                      f"hilbert {bits} x {ncols} rows {a}-{b}")
    created = got["createHistogramIfValid"]
    want = hm.create_histogram_if_valid(cols["hist_values"][0],
                                        cols["hist_freqs"][0], True)
    dzh_same(torch, chk, "percentile", created, want,
             "createHistogramIfValid")
    hists = got["hists"]
    offs = hists.offsets.to(torch.int64)
    values, freqs = hists.children[0].children
    n_pct = len(DZH_PCTS)
    flat, lists = got["percentile flat"], got["percentile lists"]
    lo = lists.offsets.to(torch.int64)
    all_valid = True
    for a, b in dzh_slices(DZH_HISTS, DZH_HIST_SLICE):
        e0, e1 = int(offs[a]), int(offs[b])
        part = Column.make_list(
            (offs[a:b + 1] - e0).to(torch.int32), Column.make_struct(
                value=dzh_rows(values, e0, e1), freq=dzh_rows(freqs, e0, e1)))
        want = hm.percentile_from_histogram(part, DZH_PCTS, False)
        valid = want.null_mask[::n_pct]
        all_valid &= bool(valid.all())
        what = f"percentile histograms {a}-{b}"
        chk.equal("percentile", dzh_bits(torch, flat.data[a * n_pct:b * n_pct]),
                  dzh_bits(torch, want.data), f"{what} flat")
        chk.equal("percentile", flat.null_mask[a * n_pct:b * n_pct],
                  want.null_mask, f"{what} flat validity")
        chk.equal("percentile", (lo[a + 1:b + 1] - lo[a:b]).to(torch.int32),
                  torch.where(valid, n_pct, 0).to(torch.int32),
                  f"{what} list sizes")
        chk.equal("percentile", lists.null_mask[a:b], valid,
                  f"{what} list validity")
        chk.equal("percentile", dzh_bits(torch, lists.children[0].data[
            int(lo[a]):int(lo[b])]), dzh_bits(torch, want.data.reshape(
                -1, n_pct)[valid].reshape(-1)), f"{what} list values")
    require((flat.validity is None) == all_valid and
            (lists.validity is None) == all_valid,
            "a percentile's validity is there where every histogram has a "
            "value, or missing where one has none")
    return chk, time.perf_counter() - t0


def dzh_bounds(torch, cols, outs):
    """(bytes, operations) of each timed form, from this run's data."""
    from spark_rapids_tpu_torch.ops import timezones as tzm
    n = DZH_N
    k = len(tzm.TimeZoneDB.instance().tables_on(
        "Asia/Shanghai", torch.device("cpu"))[2])
    steps = int(np.ceil(np.log2(k + 1)))
    out = {"from_utc Asia/Shanghai": (16 * n + 12 * k,
                                      n * (TZ_ROW_OPS + TZ_STEP_OPS * steps))}
    out["to_utc Asia/Shanghai"] = out["from_utc Asia/Shanghai"]
    for name, width, switch in (("days", 4, -141427),
                                ("micros", 8, -12219292800000000)):
        early = int((cols[name][1].data < switch).sum())
        out[f"to_julian {name}"] = (2 * width * n, n * REBASE_ROW_OPS +
                                    early * REBASE_EARLY_OPS)
    for name in ("int32", "float64"):
        width = cols[name][0][0].dtype.itemsize()
        ncols = len(cols[name])
        nulls = sum(n for c, _ in cols[name] if c.validity is not None)
        out[f"interleave {name}"] = (2 * n * ncols * width + nulls +
                                     4 * (n + 1), 8 * n * ncols * width *
                                     INTERLEAVE_BIT_OPS)
    for bits, ncols in ((16, 4), (32, 2)):
        nulls = sum(n for c, _ in cols["int32"][:ncols]
                    if c.validity is not None)
        out[f"hilbert {bits} x {ncols}"] = (4 * n * ncols + nulls + 8 * n,
                                            n * bits * ncols *
                                            HILBERT_BIT_OPS)
    hists = outs["hists"]
    m = hists.children[0].length
    lists = outs["percentile lists"]
    n_out = lists.children[0].length
    out["percentile lists"] = (m * (8 + 1 + 8) + 4 * (DZH_HISTS + 1) +
                               4 * (DZH_HISTS + 1) + 8 * n_out +
                               (DZH_HISTS if lists.validity is not None
                                else 0), m * PCT_ELEM_OPS)
    return out


def dzh_timing(torch, module, prefix, fn, plain, nbytes, ops):
    """Device ms of the kernels named `prefix...` (profiler records, L2
    flushed), everything the call ran by name, one call's ms, the plain
    version's ms on the card's tensors and the bound."""
    module.reset_counters()
    fn()
    torch.cuda.synchronize()
    per_call = sum(module.LAUNCHES.values())
    whole_ms, by_name = device_by_name(torch, fn, DZH_ITERS)
    ms = sum(v for k, v in by_name.items() if k.startswith(prefix))
    require(ms > 0, f"no record of a {prefix} kernel: {by_name}")
    cms = call_ms(torch, fn, DZH_ITERS)
    pms = once_ms(torch, plain)
    torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT_OPS_PER_S * 1e3
    return {"launches_per_call": per_call, "ms": ms, "call_ms": cms,
            "whole_ms": whole_ms, "by_name": by_name, "plain_ms": pms,
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "library_ms": None}


def dzh_timings(torch, cols, outs):
    from spark_rapids_tpu_torch.ops import datetime_rebase as drm
    from spark_rapids_tpu_torch.ops import (datetime_rebase_cuda,
                                            histogram_cuda, timezones_cuda,
                                            zorder_cuda)
    from spark_rapids_tpu_torch.ops import histogram as hm
    from spark_rapids_tpu_torch.ops import timezones as tzm
    from spark_rapids_tpu_torch.ops import zorder as zm
    bounds = dzh_bounds(torch, cols, outs)
    timing = {k: {} for k in DZH_SOURCES}
    us = cols["us"][1]
    utc, loc, offs = tzm.TimeZoneDB.instance().tables_on("Asia/Shanghai",
                                                         us.device)
    for form, fn, keys, to_utc in (
            ("from_utc Asia/Shanghai", tzm.from_utc_timestamp_to_timestamp,
             utc, False),
            ("to_utc Asia/Shanghai", tzm.from_timestamp_to_utc_timestamp,
             loc, True)):
        timing["timezones"][form] = dzh_timing(
            torch, timezones_cuda, "tz_convert_kernel",
            lambda f=fn: f(us, "Asia/Shanghai"),
            lambda k=keys, t=to_utc: tzm.convert_plain(us.data, k, offs, t,
                                                       1_000_000),
            *bounds[form])
    for name in ("days", "micros"):
        col = cols[name][1]
        timing["datetime_rebase"][f"to_julian {name}"] = dzh_timing(
            torch, datetime_rebase_cuda, "dr_rebase_kernel",
            lambda c=col: drm.rebase_gregorian_to_julian(c),
            lambda c=col: drm.rebase_plain(c, True),
            *bounds[f"to_julian {name}"])
    for name in ("int32", "float64"):
        cs = [c for _, c in cols[name]]
        timing["zorder"][f"interleave {name}"] = dzh_timing(
            torch, zorder_cuda, "zo_interleave_kernel",
            lambda c=cs: zm.interleave_bits(c),
            lambda c=cs: zm.interleave_plain(c), *bounds[f"interleave {name}"])
    for bits, ncols in ((16, 4), (32, 2)):
        cs = [c for _, c in cols["int32"][:ncols]]
        timing["zorder"][f"hilbert {bits} x {ncols}"] = dzh_timing(
            torch, zorder_cuda, "zo_hilbert_kernel",
            lambda b=bits, c=cs: zm.hilbert_index(b, c),
            lambda b=bits, c=cs: zm.hilbert_plain(b, c),
            *bounds[f"hilbert {bits} x {ncols}"])
    hists = outs["hists"]
    values, freqs = hists.children[0].children
    pct = torch.tensor(DZH_PCTS, dtype=torch.float64, device=values.device)
    timing["histogram"]["percentile lists"] = dzh_timing(
        torch, histogram_cuda, "hg_percentile_kernel",
        lambda: hm.percentile_from_histogram(hists, DZH_PCTS, True),
        lambda: hm.percentile_plain(values.data, values.null_mask,
                                    freqs.data, hists.offsets, pct),
        *bounds["percentile lists"])
    return timing


def dzh_build():
    """The four sources' nvcc seconds: build_phase's where it built them,
    else built here."""
    from spark_rapids_tpu_torch.ops import cuda_build
    secs = {k: NVCC_SECONDS[k] for k in DZH_SOURCES if k in NVCC_SECONDS}
    secs.update(cuda_build.build(tuple(DZH_SOURCES)))
    return secs


def dzh_phase(torch, chk):
    """Phase 17: the four kernels built, the tests' corpora, the main path
    once through the api (counted), its outputs against the plain version
    on the CPU copies (on a worker thread beside the timing), and each
    kernel timed."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    out = {"nvcc_seconds": dzh_build()}
    log("  nvcc: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                               out["nvcc_seconds"].items()) +
        (" (built before this phase)" if not out["nvcc_seconds"] else ""))
    zi = "/usr/share/zoneinfo/tzdata.zi"
    out["tzdata"] = (open(zi).readline().strip() if os.path.exists(zi)
                     else "no tzdata.zi")
    log(f"  zoneinfo: {out['tzdata']}")
    t1 = time.perf_counter()
    out["corpus_cases"] = dzh_corpus_checks(torch, chk)
    log(f"  corpora: {out['corpus_cases']} cases in "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    cols = dzh_inputs(torch)
    log(f"  inputs made in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    outs, launches = dzh_main_path(torch, cols)
    out["launches"] = launches
    log(f"  main path: launches {launches}, no plain run, in "
        f"{time.perf_counter() - t1:.1f} s")
    # the rebase's round trip on the card: every value of 0001-2100 off
    # the 1582-10-05..14 gap comes back
    from spark_rapids_tpu_torch import api
    for name in ("days", "micros"):
        x = cols[name][1].data
        back = api.DateTimeRebase.rebaseJulianToGregorian(
            outs[f"to_julian {name}"]).data
        day = x if name == "days" else torch.div(x, 86_400_000_000,
                                                 rounding_mode="floor")
        keep = ((day < -141427 - 10) | (day >= -141427)) & \
            (day >= -719162) & (day <= 47846)
        require(bool((back[keep] == x[keep]).all()),
                f"the {name} round trip changed a value")
    got = dzh_cpu(torch, outs)
    out["hist_elements"] = outs["hists"].children[0].length
    del outs["createHistogramIfValid"]
    for k in [k for k in outs if k.split(" ")[0] in (
            "to_utc", "from_utc", "to_julian", "to_gregorian")]:
        del outs[k]
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(max_workers=1) as pool:
        checking = pool.submit(dzh_cpu_checks, torch, cols, got)
        t1 = time.perf_counter()
        out["timing"] = dzh_timings(torch, cols, outs)
        log(f"  timed in {time.perf_counter() - t1:.1f} s")
        cpu_chk, cpu_s = checking.result()
    chk.n += cpu_chk.n
    for k, v in cpu_chk.max_err.items():
        chk.max_err[k] = max(chk.max_err[k], v)
    out["cpu_check_seconds"] = cpu_s
    log(f"  every output equal to the plain version on the CPU copies "
        f"({cpu_chk.n} slices and buffers, {cpu_s:.1f} s on a worker)")
    for source, forms in out["timing"].items():
        for form, t in forms.items():
            log(f"  {source} {form}: device {t['ms']:.6f} ms "
                f"({t['launches_per_call']} launches), one call "
                f"{t['call_ms']:.6f} ms, plain {t['plain_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.6f} ms (bytes {t['bytes_ms']:.6f}, "
                f"operations {t['ops_ms']:.6f}); the call's device work "
                f"{t['whole_ms']:.6f} ms: " + ", ".join(
                    f"{k} {v:.6f}" for k, v in t["by_name"].items()))
    del cols, outs, got
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17: {out['seconds']:.1f} s")
    return out


def dzh_kernels(dzh, chk):
    """The four kernels' entries of the `kernels` line."""
    names = {"timezones": "timezones", "datetime_rebase": "datetime_rebase",
             "zorder": "zorder", "histogram": "percentile"}
    out = []
    for source, forms in dzh["timing"].items():
        out.append({"name": names[source], "route": "cuda",
                    "source": DZH_SOURCES[source],
                    "replaces": DZH_REPLACES[source],
                    "launches": dzh["launches"][source],
                    "exact": chk.max_err[names[source]] == 0,
                    "max_abs_err": chk.max_err[names[source]],
                    "library": "none: no PyTorch call computes it",
                    **summed(forms, tuple(forms), library_ms=None)})
    return out


# ---- phase 18: the distributed tier on logical peers of the card -------------

XM_SOURCE = "spark_rapids_tpu_torch/ops/csrc/partition_hist.cu"
XM_REPLACES = ("none: no pallas_call; spark_rapids_tpu/parallel/"
               "shuffle.py:67 (build_partition_map: stable argsort + two "
               "searchsorted) and :103 (the tiled all_to_all)")
XM_ROWS = 10_000_000               # the timed map: 10M ids at P = 8
XM_PEERS = 8
XM_BIG_SHARD = 10_000_000          # the corpus's largest shard
DIST_PEERS = (2, 8)
# sales rows of each (plan, form) on the mesh: N_SALES where its
# relations fit the card on both meshes. The reference's fixed capacities
# double a relation's padded rows at every exchange, join, aggregate and
# sort (`DistContext._default_cap`, the exchange's slack), so each form
# pads by its own factor (the largest padded relation over the sales
# rows, which `dist_counted` measures and prints with the run's peak
# device memory): authored q3, TPC-DS q3 and q5 64x, optimized q5 32x,
# optimized q3 and TPC-DS q3 16x at 1-3M rows and 32x at 5-10M, q23 2x on 2 peers and 4x on 8, q72 authored 4,096x and 8,192x,
# optimized 256x. A form is cut only as far as its peak on 8 peers stays
# within DIST_PEAK_BYTES (optimized q3 at 10M: 47 GiB on 2 peers, out of
# memory on 8).
DIST_PEAK_BYTES = 48 << 30
DIST_N = {("q3", "authored"): 2_400_000, ("q3", "optimized"): 5_000_000,
          ("tpcds_q3", "authored"): 2_400_000,
          ("tpcds_q3", "optimized"): 5_000_000,
          ("q5", "authored"): 3_000_000, ("q5", "optimized"): 5_000_000,
          ("q23", "authored"): N_SALES, ("q23", "optimized"): N_SALES,
          ("q72", "authored"): 25_000, ("q72", "optimized"): 800_000}
# the plan whose async exchange is timed against the synchronous one
DIST_ASYNC = ("q3", "optimized")
DIST_ASYNC_RUNS = 2
DIST_PQ_N = 20_000                 # q72 from Parquet on 4 peers
DIST_PQ_PEERS = 4
DIST_DEV = "cuda"                  # the card (a CPU rehearsal sets "cpu")


def xm_case_ids(rng, P, s, dist):
    if dist == "one":
        return np.full((P, s), P - 1, np.int32)
    if dist == "zipf":
        return ((rng.zipf(1.3, (P, s)) - 1) % P).astype(np.int32)
    return rng.integers(-1, P + 1, (P, s)).astype(np.int32)


def xm_corpus(torch, chk):
    """`px_exchange_map` against its plain version (on the CPU, where it
    runs) over the corpus: P of 1, 2, 8, 64 and the kernel's most; shards
    of 0, 1, 31, 32, 33 and 10,000,000 rows; uniform ids with some out of
    range, every id in one bucket, zipf ids; a cap that fits and one that
    overflows. Then P past its most declined. -> cases checked."""
    from spark_rapids_tpu_torch import parallel
    from spark_rapids_tpu_torch.ops.registry import KernelDeclinedError
    from spark_rapids_tpu_torch.parallel import partition_cuda as pc
    rng = np.random.default_rng(18)
    cases = [(P, s, "uniform") for P in (1, 2, 8, 64)
             for s in (0, 1, 31, 32, 33)]
    cases += [(P, 33, d) for P in (2, 8, 64) for d in ("one", "zipf")]
    cases += [(2, XM_BIG_SHARD, d) for d in ("uniform", "one", "zipf")]
    cases += [(pc.MAX_PARTITIONS, s, d) for s in (1, 33)
              for d in ("uniform", "zipf")]
    n = 0
    for P, s, dist in cases:
        part = xm_case_ids(rng, P, s, dist)
        live = int(((part >= 0) & (part < P)).sum())
        fits = max(1, -(-live // (P * P)) * 2)
        for cap in sorted({fits, max(1, fits // 4)}):
            t = torch.from_numpy(part)
            want = pc.exchange_map_plain(t, cap)
            pc.reset_counters()
            got = parallel.exchange_map(t.to(DIST_DEV), cap)
            torch.cuda.synchronize()
            require(pc.LAUNCHES["exchange_map"] == (1 if s else 0)
                    and pc.PLAIN_CALLS["exchange_map"] == 0,
                    f"exchange map P={P} s={s}: {pc.LAUNCHES} "
                    f"{pc.PLAIN_CALLS}")
            for g, w, what in zip(got, want, ("map", "counts")):
                chk.equal("exchange_map", g.cpu(), w,
                          f"exchange map {what} P={P} s={s} {dist} cap={cap}")
            n += 1
    try:
        parallel.exchange_map(torch.zeros((pc.MAX_PARTITIONS + 1, 4),
                                          dtype=torch.int32,
                                          device=DIST_DEV), 1)
        require(False, "P past the kernel's most was not declined")
    except KernelDeclinedError:
        pass
    log(f"phase 18: exchange map == plain version in {n} cases (P up to "
        f"{pc.MAX_PARTITIONS}, shards up to 10,000,000 rows, caps that "
        "overflow); P past it declined")
    return n


def xm_timing(torch):
    """The map at XM_ROWS ids over XM_PEERS peers (capacity the tier's
    2x slack): device ms (its three kernels, L2 flushed), one call's ms,
    the plain version's ms (the reference's sort route, run on the card
    for the timing only), torch.sort(stable=True) of the same ids along
    each peer, and the bound."""
    from spark_rapids_tpu_torch.parallel import partition_cuda as pc
    P = XM_PEERS
    s = XM_ROWS // P
    cap = -(-s // P) * 2
    rng = np.random.default_rng(0)
    part = torch.from_numpy(rng.integers(0, P, (P, s)).astype(
        np.int32)).to(DIST_DEV)
    fn = lambda: pc.exchange_map_cuda(part, cap)   # noqa: E731
    gidx, counts = fn()
    live = int(counts.clamp(max=cap).sum())
    byts = 4 * P * s + 4 * live + 4 * P * P
    t = {"rows": P * s, "peers": P, "cap": cap, "live_entries": live,
         "ms": device_ms(torch, fn, ("xm_count", "xm_scan", "xm_rank"), 10,
                         per_call=3),
         "call_ms": call_ms(torch, fn, 10),
         "plain_ms": time_cuda(
             torch, lambda: pc.exchange_map_plain(part, cap), 3),
         "library_ms": time_cuda(
             torch, lambda: torch.sort(part, dim=1, stable=True), 10),
         "bytes": byts, "ops": 0,
         "bytes_ms": byts / 3.35e12 * 1e3, "ops_ms": 0.0}
    t["bound_ms"] = t["bytes_ms"]
    log(f"  exchange map at {P * s} ids, P = {P}, cap {cap}: device "
        f"{t['ms']:.4f} ms, call {t['call_ms']:.4f} ms, plain (sort route) "
        f"{t['plain_ms']:.4f} ms, torch.sort(stable) {t['library_ms']:.4f} "
        f"ms, bound {t['bound_ms']:.4f} ms (bytes)")
    return t


def dist_inputs(torch, name, n):
    """(plan, its inputs on DIST_DEV, numpy oracle columns or None)."""
    from spark_rapids_tpu_torch import nds_q23, nds_q3, nds_q5, nds_q72
    if name == "q3":
        return (nds_q3.q3_plan(), nds_q3.q3_inputs(n, device=DIST_DEV),
                numpy_q3(nds_q3.datagen(n, seed=0)))
    if name == "tpcds_q3":
        return (nds_q3.q3_tpcds_plan(),
                nds_q3.q3_tpcds_inputs(n, device=DIST_DEV), None)
    if name == "q72":
        return (nds_q72.q72_plan(), nds_q72.q72_inputs(n, device=DIST_DEV),
                numpy_q72(nds_q72.datagen(n, seed=0)))
    if name == "q5":
        return (nds_q5.q5_plan(), nds_q5.q5_inputs(n, device=DIST_DEV),
                numpy_q5(nds_q5.datagen(n, seed=0))[0])
    return (nds_q23.q23_plan(), nds_q23.q23_inputs(n, device=DIST_DEV),
            numpy_q23(nds_q23.datagen(n, seed=0))[0])


class DistPadProbe:
    """The largest padded relation the mesh made while open: every
    `ShardedRel` the distributed tier builds is seen here (its table's
    rows, live and dead slots)."""

    def __enter__(self):
        from spark_rapids_tpu_torch.plan import distributed as dist
        self.rows = 0
        self._cls = dist.ShardedRel
        self._init = init = dist.ShardedRel.__init__
        probe = self

        def seen(rel, table, *a, **kw):
            init(rel, table, *a, **kw)
            probe.rows = max(probe.rows, table.num_rows)
        self._cls.__init__ = seen
        return self

    def __exit__(self, *exc):
        self._cls.__init__ = self._init


def dist_equal(chk, got, want, plan, what):
    """`pq_equal` of a meshed result with the single-device one. Where the
    plan ends in a Sort whose keys leave ties (q3 sorts its groups by year
    and revenue alone), tied rows come in the order they reach the range
    partition on the mesh, as in the reference, and in group order on one
    device: then the sort keys must be equal row by row, and each run of
    tied rows hold the same rows. -> the rows of such runs that came in
    another order (0 when the tables are equal as they stand)."""
    import torch
    root = plan.root
    keys = list(root.keys) if type(root).__name__ == "Sort" else []

    def planes(t):
        out = []
        for c in t.columns:
            d = c.data
            if d.dtype.is_floating_point:
                d = d.view(torch.int32 if d.dtype == torch.float32
                           else torch.int64)
            out += [d.cpu().numpy().astype(np.int64),
                    c.null_mask.cpu().numpy().astype(np.int64)]
        return out
    if not keys or got.names != want.names or \
            got.num_rows != want.num_rows:
        pq_equal(chk, got, want, what)
        return 0
    gp, wp = planes(got), planes(want)
    if all(np.array_equal(x, y) for x, y in zip(gp, wp)):
        pq_equal(chk, got, want, what)
        return 0
    kidx = [got.names.index(k) for k in keys]
    for i in kidx:
        for j in (0, 1):
            chk.equal("plans", torch.from_numpy(gp[2 * i + j]),
                      torch.from_numpy(wp[2 * i + j]),
                      f"{what} sort key {got.names[i]} row by row")
    kp = np.stack([gp[2 * i + j] for i in kidx for j in (0, 1)])
    run = np.concatenate([[0], np.cumsum(
        (kp[:, 1:] != kp[:, :-1]).any(axis=0))])
    # both tables' rows in one canonical order: by run, then every column
    g_ord = np.lexsort(gp[::-1] + [run])
    w_ord = np.lexsort(wp[::-1] + [run])
    for k, (x, y) in enumerate(zip(gp, wp)):
        chk.equal("plans", torch.from_numpy(x[g_ord]),
                  torch.from_numpy(y[w_ord]),
                  f"{what} {got.names[k // 2]} "
                  f"{('data', 'validity')[k % 2]} within tied runs")
    return int(sum((x != y).any() for x, y in
                   zip(np.stack(gp).T, np.stack(wp).T)))


def dist_counted(torch, ex, plan, inputs, what):
    """One run, every kernel counter zeroed just before and read just
    after: the exchange-map and row-hash kernels launched, no plain
    version. -> (result, exchange-map launches, murmur launches, the
    largest padded relation's rows, the run's peak device bytes above
    what was allocated before it)."""
    from spark_rapids_tpu_torch.ops import hash_cuda
    from spark_rapids_tpu_torch.parallel import partition_cuda as pc
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counters()
    with DistPadProbe() as pad:
        res = ex.execute(plan, inputs)
    torch.cuda.synchronize()
    counters = kernel_counters()
    peak = torch.cuda.max_memory_allocated() - base
    require(counted(counters["plain"]) == 0,
            f"{what}: a plain version ran: {counters['plain']}")
    xm, mm = pc.LAUNCHES["exchange_map"], hash_cuda.LAUNCHES["murmur"]
    require(xm > 0 and mm > 0, f"{what}: exchange map {xm}, row hash {mm} "
            "launches")
    require(any(m.n_peers for m in res.metrics.values()),
            f"{what}: no operator ran on the mesh")
    require(peak <= DIST_PEAK_BYTES,
            f"{what}: peak {peak} B past DIST_PEAK_BYTES (the largest "
            f"relation padded to {pad.rows} rows): cut its DIST_N")
    return res, xm, mm, pad.rows, peak


def dist_plans(torch, chk):
    """Every NDS plan, authored and optimized, on meshes of 2 and 8 logical
    peers of the card, each form at its DIST_N: equal to the single-device
    eager run (and to numpy where phase 4 has an oracle), the counters,
    the edges, the padding factor and peak device memory, and the warm
    walls and busy ms beside the single-device wall."""
    from spark_rapids_tpu_torch.parallel import make_mesh
    from spark_rapids_tpu_torch.plan import PlanExecutor
    out, launches = {}, {"exchange_map": 0, "murmur": 0}
    made = {}
    for (name, form), n in DIST_N.items():
        if (name, n) not in made:
            made.clear()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            made[(name, n)] = dist_inputs(torch, name, n)
            log(f"  {name} inputs and oracle at {n} sales rows in "
                f"{time.perf_counter() - t0:.1f} s")
        plan, inputs, ref = made[(name, n)]
        optimize = form == "optimized"
        what = f"{name} {form}"
        t0 = time.perf_counter()
        single = PlanExecutor(optimize=optimize, device=DIST_DEV)
        want = single.execute(plan, inputs)
        warm = single.execute(plan, inputs)
        if ref is not None:
            for col, arr in zip(want.table.names, ref):
                require(np.array_equal(want.table[col].data.cpu().numpy(),
                                       arr),
                        f"{what}: {col} differs from numpy")
        row = {"rows": n, "single_wall_ms": warm.wall_ms, "meshes": {}}
        for P in DIST_PEERS:
            mesh = make_mesh(P, devices=[torch.device(DIST_DEV)] * P)
            ex = PlanExecutor(optimize=optimize, mesh=mesh, device=DIST_DEV)
            res, xm, mm, pad, peak = dist_counted(
                torch, ex, plan, inputs, f"{what} on {P} peers")
            launches["exchange_map"] += xm
            launches["murmur"] += mm
            # validity as the rows it marks: the single-device
            # aggregate carries an all-valid mask where the mesh's
            # carries none (as in the reference)
            tied = dist_equal(chk, res.table, want.table, plan,
                              f"{what} on {P} peers")
            edges = [(m.label, m.exchange_how, m.exchange_bytes_logical,
                      m.exchange_bytes) for m in res.metrics.values()
                     if m.exchange_how]
            cold = res.wall_ms
            escalations = sum(m.escalations for m in res.metrics.values())
            del res
            tr = traced_run(torch, lambda: ex.execute(plan, inputs))
            row["meshes"][P] = {
                "exchange_map_launches": xm, "murmur_launches": mm,
                "tied_rows_reordered": tied,
                "padded_rows": pad, "pad_factor": pad / n,
                "peak_bytes": peak,
                "cold_wall_ms": cold, "warm_wall_ms": tr["wall_ms"],
                "busy_ms": tr["busy_ms"], "idle_share": tr["idle_share"],
                "escalations": escalations,
                "edges": edges}
            log(f"  {what} on {P} peers ({n} rows): == single device"
                f"{' and numpy' if ref is not None else ''}"
                f"{f' ({tied} rows tied on the sort keys, in another order)' if tied else ''}; exchange "
                f"map {xm}, row hash {mm} launches; largest padded "
                f"relation {pad} rows ({pad / n:.2f}x), peak "
                f"{peak / 2**30:.2f} GiB; warm wall {tr['wall_ms']:.1f} "
                f"ms, busy {tr['busy_ms']:.1f} ms, idle "
                f"{tr['idle_share']:.3f} (single device "
                f"{warm.wall_ms:.1f} ms)")
            for e in edges:
                log(f"    {e[0]}: {e[1]} {e[2]} B logical, {e[3]} B wire")
        if (name, form) == DIST_ASYNC:
            row["async"] = dist_async(torch, chk, plan, inputs, want.table,
                                      what, n)
        row["seconds"] = time.perf_counter() - t0
        out[what] = row
    made.clear()
    torch.cuda.empty_cache()
    return out, launches


def dist_async(torch, chk, plan, inputs, want, what, n):
    """The async exchange (SPARK_RAPIDS_TORCH_EXCHANGE_ASYNC=on) against
    the synchronous one, on the widest mesh: the first synchronous result
    `dist_equal` to the single-device run, every later one, async or not,
    equal to it as it stands; warm walls interleaved off, on, on, off for
    DIST_ASYNC_RUNS rounds, and the edges' summed exchange_overlap_ms."""
    from spark_rapids_tpu_torch.parallel import make_mesh
    from spark_rapids_tpu_torch.plan import PlanExecutor
    P = DIST_PEERS[-1]
    ex = PlanExecutor(optimize=what.endswith("optimized"), device=DIST_DEV,
                      mesh=make_mesh(P, devices=[torch.device(DIST_DEV)] * P))
    walls = {"off": [], "on": []}
    overlap = []
    sync = None
    for _ in range(DIST_ASYNC_RUNS):
        for mode in ("off", "on", "on", "off"):
            os.environ["SPARK_RAPIDS_TORCH_EXCHANGE_ASYNC"] = mode
            try:
                res = ex.execute(plan, inputs)
            finally:
                del os.environ["SPARK_RAPIDS_TORCH_EXCHANGE_ASYNC"]
            walls[mode].append(res.wall_ms)
            if sync is None:
                dist_equal(chk, res.table, want, plan, f"{what} async off")
                sync = res.table
            else:
                pq_equal(chk, res.table, sync, f"{what} async {mode}")
            if mode == "on":
                overlap.append(sum(m.exchange_overlap_ms
                                   for m in res.metrics.values()))
            del res
    out = {"peers": P, "off_wall_ms": walls["off"],
           "on_wall_ms": walls["on"],
           "off_median_ms": float(np.median(walls["off"])),
           "on_median_ms": float(np.median(walls["on"])),
           "overlap_ms": overlap}
    log(f"  {what} on {P} peers ({n} rows), async exchange: warm wall "
        f"median off {out['off_median_ms']:.1f} ms, on "
        f"{out['on_median_ms']:.1f} ms (off {walls['off']}, on "
        f"{walls['on']}); summed exchange_overlap_ms {overlap}; results "
        "equal")
    return out


def dist_parquet(torch, chk):
    """q72 from Parquet files (tests/torch_parquet_writer.py) on a mesh of
    DIST_PQ_PEERS logical peers: each scan one pruned, projected read,
    then sharded; equal to the materialized single-device run."""
    import tempfile
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from spark_rapids_tpu_torch import nds_q72
    from spark_rapids_tpu_torch.io import ParquetSource
    from spark_rapids_tpu_torch.parallel import make_mesh
    from spark_rapids_tpu_torch.plan import PlanExecutor
    gen = nds_q72.datagen(DIST_PQ_N, seed=0)
    want = PlanExecutor(device=DIST_DEV).execute(nds_q72.q72_plan(),
                                  nds_q72.q72_inputs(DIST_PQ_N,
                                                     device=DIST_DEV))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        paths, _, _ = pq_write("q72", pq_inputs("q72", gen), tmp)
        sources = {k: ParquetSource(p)
                   for k, p in paths["UNCOMPRESSED"].items()}
        mesh = make_mesh(DIST_PQ_PEERS,
                         devices=[torch.device(DIST_DEV)] * DIST_PQ_PEERS)
        res, xm, mm, _, _ = dist_counted(
            torch, PlanExecutor(mesh=mesh, device=DIST_DEV),
            nds_q72.q72_plan(), sources,
            f"q72 from Parquet on {DIST_PQ_PEERS} peers")
    pq_equal(chk, res.table, want.table, "q72 from Parquet on a mesh")
    io = pq_scan_io(res)
    require(io["scans"] == len(paths["UNCOMPRESSED"]) and
            all(m.sharding == f"rows@{DIST_PQ_PEERS}"
                for m in res.metrics.values()
                if m.kind == "Scan" and m.io_row_groups_total),
            f"q72 from Parquet: the scans did not read and shard: {io}")
    log(f"  q72 from Parquet on {DIST_PQ_PEERS} peers: == the materialized "
        f"run; {io['scans']} pruned reads, {io['rows']} rows; exchange map "
        f"{xm} launches")
    return {"rows": DIST_PQ_N, "peers": DIST_PQ_PEERS, "io": io,
            "exchange_map_launches": xm, "murmur_launches": mm,
            "wall_ms": res.wall_ms}


def dist_phase(torch, chk):
    """Phase 18: the distributed tier on logical peers of the card."""
    import contextlib
    import io
    from spark_rapids_tpu_torch.entry import dryrun_multichip
    from spark_rapids_tpu_torch.parallel import partition_cuda as pc
    t0 = time.perf_counter()
    log("phase 18: the distributed tier (mesh, exchange, keys, relational "
        "ops, transport, the meshed executor) on logical peers of the card")
    steps = {}

    def step(name, fn):
        t1 = time.perf_counter()
        got = fn()
        steps[name] = time.perf_counter() - t1
        log(f"  ({name}: {steps[name]:.1f} s)")
        return got

    cases = step("corpus", lambda: xm_corpus(torch, chk))
    timing = step("map timing", lambda: xm_timing(torch))

    def dry_run(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun_multichip(8, device=device)
        return buf.getvalue().splitlines()

    def dry_runs():
        reset_kernel_counters()
        lines = dry_run(DIST_DEV)
        torch.cuda.synchronize()
        got = {"lines": lines,
               "exchange_map_launches": pc.LAUNCHES["exchange_map"],
               "plain_calls": pc.PLAIN_CALLS["exchange_map"]}
        got["cpu_lines"] = dry_run("cpu")
        return got
    dry = step("dry run", dry_runs)
    for line in dry["lines"]:
        log("  " + line)
    require(len(dry["lines"]) == 4 and dry["exchange_map_launches"] > 0
            and dry["plain_calls"] == 0,
            f"dryrun_multichip(8): {dry}")
    require(dry["lines"] == dry["cpu_lines"],
            f"dryrun_multichip(8) on the card and on the CPU differ: {dry}")
    log("  dryrun_multichip(8): the same 4 lines on the card and on the CPU")
    plans, launches = step("plans", lambda: dist_plans(torch, chk))
    parquet = step("parquet", lambda: dist_parquet(torch, chk))
    launches["exchange_map"] += parquet["exchange_map_launches"]
    launches["murmur"] += parquet["murmur_launches"]
    seconds = time.perf_counter() - t0
    log(f"phase 18: {seconds:.1f} s; main-path launches {launches}")
    return {"cases": cases, "timing": timing, "dryrun": dry, "plans": plans,
            "parquet": parquet, "launches": launches, "steps": steps,
            "seconds": seconds}


def dist_kernels(dist, chk):
    """The exchange map's entry of the `kernels` line."""
    t = dist["timing"]
    return [{"name": "exchange_map", "route": "cuda", "source": XM_SOURCE,
             "entry_point": "px_exchange_map", "replaces": XM_REPLACES,
             "launches": dist["launches"]["exchange_map"],
             "exact": chk.max_err["exchange_map"] == 0,
             "max_abs_err": chk.max_err["exchange_map"],
             "ms": t["ms"], "call_ms": t["call_ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": "bytes", "bytes": t["bytes"], "ops": t["ops"],
             "library": "torch.sort(stable=True) of the same (P, s) ids "
                        "along each peer: the sort the kernel replaces, "
                        "without its searchsorteds and map",
             "library_ms": t["library_ms"],
             "shape": f"{t['rows']} ids over {t['peers']} peers, cap "
                      f"{t['cap']}"}]


def script_ab(trees, log_dir, gap_s=5.0):
    """`python3 chip_smoke.py` from each checkout in `trees`, one after
    another, each line of its merged output stamped with the seconds since
    it started (`<log_dir>/script_ab_<i>.log`). Prints, per run, its exit
    code, seconds and every top-level line (one not indented) that came
    `gap_s` or more after the one before it, with that gap: the phases
    that took the time, to be lined up between two trees by their text.
    Exits non-zero if any run did."""
    import torch
    device_phase(torch)
    os.makedirs(log_dir, exist_ok=True)
    out = []
    for i, tree in enumerate(trees):
        path = os.path.join(log_dir, f"script_ab_{i}.log")
        t0 = time.perf_counter()
        last_t, last_line, gaps = 0.0, "(start)", []
        with open(path, "w") as f, subprocess.Popen(
                [sys.executable, "chip_smoke.py"], cwd=tree,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, bufsize=1) as proc:
            for line in proc.stdout:
                t = time.perf_counter() - t0
                f.write(f"{t:10.3f} {line}")
                if line[:1] not in (" ", "\t", "\n", ""):
                    if t - last_t >= gap_s:
                        gaps.append([round(t, 3), round(t - last_t, 3),
                                     last_line[:120]])
                    last_t, last_line = t, line.rstrip()
            rc = proc.wait()
        secs = time.perf_counter() - t0
        out.append({"tree": tree, "rc": rc, "seconds": secs,
                    "log": path, "gaps": gaps})
        log(f"{tree}: rc {rc}, {secs:.1f} s")
    print(json.dumps({"script_ab": out}), flush=True)
    return 0 if all(r["rc"] == 0 for r in out) else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="also profile one warm q3 run with torch.profiler")
    ap.add_argument("--out", default="",
                    help="also write the measurements to this JSON file")
    ap.add_argument("--join-profile", action="store_true",
                    help="only time whole inner_join_hash calls at q3's, "
                         "TPC-DS q3's and q72's inventory join shapes, and "
                         "print them; runs from an earlier tree's root too")
    ap.add_argument("--fuzz", action="store_true",
                    help="only run the plan fuzz corpus on the card "
                         "(phase 8) and print its summary")
    ap.add_argument("--strings", action="store_true",
                    help="only run the row hash's byte path (phase 5c) and "
                         "the row conversion (phase 9) and print them")
    ap.add_argument("--row-hash", action="store_true",
                    help="only run the fixed-width row hash (phase 5) and "
                         "print its times and headline; runs from an "
                         "earlier tree's root too, for A/B runs")
    ap.add_argument("--select-topk", action="store_true",
                    help="only time the fixed-width FusedSelect and TopK "
                         "kernels at kernel_bench.py's tables and TPC-DS "
                         "q3's calls; runs from an earlier tree's root too, "
                         "for A/B runs")
    ap.add_argument("--keys", action="store_true",
                    help="only run phase 10 (string, DECIMAL128 and float "
                         "keys: the three kernels' new kinds, TPC-DS q3 with "
                         "its string i_brand and q74) and print it")
    ap.add_argument("--union-walls", type=int, default=0, metavar="N",
                    help="only time N warm runs of q5 and q23 in both tiers "
                         "and forms, interleaved, and one traced run each, "
                         "and print their walls and idle shares; runs from "
                         "an earlier tree's root too, for A/B runs")
    ap.add_argument("--walls", type=int, default=0, metavar="N",
                    help="only time N warm eager runs of q3, TPC-DS q3 and "
                         "q72 (authored, optimized), interleaved, and print "
                         "their walls and operator walls")
    ap.add_argument("--plan-walls", type=int, default=0, metavar="N",
                    help="only time N warm runs of q3, TPC-DS q3 (INT32 "
                         "and STRING i_brand), q72 and q74, eager and (the "
                         "first three) capped, interleaved, then a traced "
                         "run of each: walls, busy time and idle share; "
                         "runs from an earlier tree's root too")
    ap.add_argument("--capped-kernels", action="store_true",
                    help="only time the capped join at q3's joins and q72's "
                         "inventory join and the capped TopK at k = 50, 100 "
                         "and 4,099 (device ms by kernel, one call); runs "
                         "from an earlier tree's root too, for A/B runs")
    ap.add_argument("--feedback", action="store_true",
                    help="only run phase 12: the tracing ranges, the stats "
                         "store, the certifier and the capped programs' "
                         "CUDA graphs")
    ap.add_argument("--casts", action="store_true",
                    help="only run phase 13: CastStrings' eight methods on "
                         "the cast kernels, against their plain versions "
                         "and the CPU run, and the kernels timed")
    ap.add_argument("--uri-json-bloom", action="store_true",
                    help="only run phase 14: ParseURI, MapUtils and "
                         "BloomFilter on their kernels, against their plain "
                         "versions and the CPU run, and the kernels timed")
    ap.add_argument("--runtime", action="store_true",
                    help="only run phase 15: several tasks sharing the card "
                         "through the resource arbiter, forced OOMs, spill, "
                         "fault injection and the degraded CPU tier")
    ap.add_argument("--parquet", action="store_true",
                    help="only run phase 16: NDS q5 and q72 from Parquet "
                         "files through the streaming scan, row-group "
                         "pruning, prefetch depths and the fixtures")
    ap.add_argument("--datetime-zorder-histogram", action="store_true",
                    help="only run phase 17: GpuTimeZoneDB, DateTimeRebase, "
                         "ZOrder and Histogram on their kernels, against "
                         "their plain versions on the CPU and the oracles, "
                         "and the kernels timed")
    ap.add_argument("--distributed", action="store_true",
                    help="only run phase 18: the exchange-map kernel "
                         "against its plain version, dryrun_multichip(8) "
                         "and every NDS plan on meshes of 2 and 8 logical "
                         "peers of the card, and q72 from Parquet on 4")
    ap.add_argument("--groupby-ab", action="store_true",
                    help="only time the whole keyed aggregate at q23's two "
                         "aggregates, eager and capped; runs from an "
                         "earlier tree's root too")
    ap.add_argument("--tree", default="", metavar="DIR",
                    help="with --plan-walls or --union-walls: import the "
                         "port from the checkout at DIR (an earlier tree, "
                         "for A/B runs by this script's code)")
    ap.add_argument("--script-ab", nargs="+", default=[], metavar="DIR",
                    help="only run the whole script from each checkout "
                         "DIR in turn, stamp every line of its output with "
                         "its seconds, write the stamped logs beside --out "
                         "(else here) and print each run's seconds and "
                         "its gaps of 5 s or more between top-level lines")
    args = ap.parse_args(argv)
    if args.script_ab:
        return script_ab(args.script_ab,
                         os.path.dirname(os.path.abspath(args.out))
                         if args.out else os.getcwd())
    walls = bool(args.plan_walls or args.union_walls)
    if args.tree:
        if not walls:
            ap.error("--tree goes with --plan-walls or --union-walls")
        sys.path.insert(0, os.path.abspath(args.tree))
    # the walls run as a user runs the port: its default stats store on
    # where the tree has one; every other phase without one
    import contextlib
    with contextlib.nullcontext() if walls else static_engine():
        return _run(args)


def _run(args):
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
    if (args.plan_walls or args.union_walls or args.groupby_ab
            or args.capped_kernels):
        import spark_rapids_tpu_torch
        from spark_rapids_tpu_torch.ops import cuda_build
        cuda_build.build()
        out = {"card": smi, "package": os.path.dirname(
            spark_rapids_tpu_torch.__file__)}
        log(f"the port from {out['package']}")
        if args.capped_kernels:
            out["capped_kernels"] = capped_kernels_phase(torch)
        if args.groupby_ab:
            out["groupby_ab"] = groupby_ab_phase(torch)
        if args.plan_walls:
            out["plan_walls"] = plan_walls_phase(torch, args.plan_walls)
        if args.union_walls:
            out["union_walls"] = union_walls_phase(torch, args.union_walls)
        print(json.dumps(out), flush=True)
        return 0
    if args.select_topk:
        from spark_rapids_tpu_torch.ops import cuda_build
        cuda_build.build()
        print(json.dumps({"card": smi,
                          "select_topk": select_topk_phase(torch)}),
              flush=True)
        return 0
    if args.row_hash:
        from spark_rapids_tpu_torch.ops import cuda_build
        cuda_build.build()
        chk = Checks()
        _, rh_timing, headline = row_hash_phase(torch, chk, smi)
        print(json.dumps({"card": smi, "row_hash": rh_timing,
                          "headline": headline, "checks": chk.n}),
              flush=True)
        return 0
    if args.datetime_zorder_histogram:
        chk = Checks()
        dzh = dzh_phase(torch, chk)
        print(json.dumps({"card": smi, "kernels": dzh_kernels(dzh, chk),
                          "datetime_zorder_histogram": dzh,
                          "checks": chk.n}, default=str), flush=True)
        return 0
    dadd = build_phase()
    if args.distributed:
        chk = Checks()
        dist = dist_phase(torch, chk)
        out = {"card": smi, "kernels": dist_kernels(dist, chk),
               "distributed": dist, "checks": chk.n}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1, default=str)
        print(json.dumps(out, default=str), flush=True)
        return 0
    if args.feedback:
        chk = Checks()
        fb = feedback_phase(torch, chk)
        print(json.dumps({"card": smi, "feedback": fb, "checks": chk.n},
                         default=str), flush=True)
        return 0
    if args.casts:
        chk = Checks()
        casts = casts_phase(torch, chk)
        print(json.dumps({"card": smi, "kernels": casts_kernels(casts, chk),
                          "casts": casts, "checks": chk.n}, default=str),
              flush=True)
        return 0
    if args.uri_json_bloom:
        chk = Checks()
        ujb = ujb_phase(torch, chk)
        print(json.dumps({"card": smi, "kernels": ujb_kernels(ujb, chk),
                          "uri_json_bloom": ujb, "checks": chk.n},
                         default=str), flush=True)
        return 0
    if args.parquet:
        chk = Checks()
        out = parquet_phase(torch, chk, smi)
        print(json.dumps({"card": smi, "parquet": out, "checks": chk.n},
                         default=str), flush=True)
        return 0
    if args.runtime:
        chk = Checks()
        out = runtime_phase(torch, chk, smi)
        print(json.dumps({"card": smi, "runtime": out, "checks": chk.n},
                         default=str), flush=True)
        return 0
    if args.fuzz:
        chk = Checks()
        fz = fuzz_phase(torch, chk)
        print(json.dumps({"card": smi, "fuzz": fz, "checks": chk.n,
                          "max_err": chk.max_err}), flush=True)
        return 0
    if args.strings:
        chk = Checks()
        out = {"customer_hash": customer_hash_phase(torch, chk),
               "row_conversion": row_conversion_phase(torch, chk)}
        print(json.dumps({"card": smi, **out, "checks": chk.n,
                          "max_err": chk.max_err}), flush=True)
        return 0
    if args.keys:
        chk = Checks()
        keys = keys_phase(torch, chk)
        keys["max_err"] = chk.max_err
        print(json.dumps({"card": smi, "kernels": keys_kernels(keys),
                          "keys": keys, "checks": chk.n}, default=str),
              flush=True)
        return 0
    if args.join_profile:
        from spark_rapids_tpu_torch import nds_q72
        tables = nds_q3.q3_inputs(N_SALES, seed=0, device="cuda")
        shapes = join_shapes(torch, tables)
        pc, bc = q72_join_shape(torch, nds_q72.datagen(N_SALES, seed=0))
        shapes.append(("q72 inventory join", pc, bc))
        print(json.dumps({"card": smi, "join_profile": join_profile(
            torch, shapes)}), flush=True)
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
    dec = decimal_phase(torch, chk)
    cust = customer_hash_phase(torch, chk)
    pt_launches, pt_timing = partition_phase(torch, chk)
    fz = fuzz_phase(torch, chk)
    fz_e, fz_c = fz["launches"]["eager"], fz["launches"]["capped"]
    rconv = row_conversion_phase(torch, chk)
    keys = keys_phase(torch, chk)
    keys["max_err"] = chk.max_err
    feedback = feedback_phase(torch, chk)
    casts = casts_phase(torch, chk)
    log("phase 14: parse_uri, from_json and the bloom filter")
    ujb = ujb_phase(torch, chk)
    log(f"phase 14: {ujb['seconds']:.1f} s")
    runtime = runtime_phase(torch, chk, smi)
    parquet = parquet_phase(torch, chk, smi)
    log("phase 17: GpuTimeZoneDB, DateTimeRebase, ZOrder and Histogram")
    dzh = dzh_phase(torch, chk)
    dist = dist_phase(torch, chk)

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
            "tpcds_int32": timing["int32"][k],
            "fuzz_launches": fz_e.get("hash_join", {}).get(k, 0)})
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
            entry.update(rounds=t["rounds"], cases=large["cases"],
                         ceiling=large["ceiling"])
        kernels.append(entry)
    # the existence probe: launches on q5's and q23's semi joins (both
    # tiers and forms); the small route timed at q5's first eager semi join
    # (the 14-day window), the large one at q23's first capped semi join
    # (the frequent items, padded to key_cap)
    semi_runs = {w: r["counters"] for q in nds_union.values()
                 for w, r in q["runs"].items()}
    for suffix, q, run in (("", "q5", "q5 eager authored"),
                           ("_large", "q23", "q23 capped authored")):
        t = nds_union[q]["runs"][run]["semi_timing"][0]
        large_by = {w: c["hash_join_large"]["exists"]
                    for w, c in semi_runs.items()}
        by = large_by if suffix else {
            w: c["hash_join"]["exists"] - large_by[w]
            for w, c in semi_runs.items()}
        fz_large = fz_e.get("hash_join_large", {}).get("exists", 0)
        kernels.append({
            "name": f"hash_join_exists{suffix}", "route": "cuda",
            "entry_point": "hj_exists", "source": SOURCE,
            "replaces": REPLACES["exists"],
            "launches": sum(by.values()), "launches_by_path": by,
            "fuzz_launches": (fz_large if suffix else
                              fz_e.get("hash_join", {}).get("exists", 0)
                              - fz_large),
            "exact": chk.max_err["exists" + suffix] == 0,
            "max_abs_err": chk.max_err["exists" + suffix],
            "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["exists_bound_ms"],
            "bound_by": ("bytes" if t["exists_bytes_ms"]
                         >= t["exists_ops_ms"] else "operations"),
            "bytes": t["exists_bytes"], "ops": t["exists_ops"],
            "library_ms": t["library_ms"],
            "library": "torch.isin(probe key, build key) on the card: the "
                       "same mask where no key is null and every row live",
            "build_ms": t["build_ms"], "build_bound_ms": t["build_bound_ms"],
            "plain_build_ms": t["plain_build_ms"],
            "shape": f"{run}'s first semi join: {t['probe_rows']} x "
                     f"{t['build_rows']} rows (call: build and probe)"})
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
                   **{f"{q} {form}": keys[q][form]["launches"]["groupby"][
                       "groupby"] for q in ("q3_strings", "q74")
                      for form in ("authored", "optimized")},
                   "C4": c4["launches"]}
    q23_forms = ("q23 count(qty) by item_sk", "q23 sum(rev) by cust_sk")
    kernels.append({
        "name": "groupby", "route": "cuda", "source": GB_SOURCE,
        "replaces": "spark_rapids_tpu/ops/aggregate.py:55 (_groupby_kernel, "
                    "the registry op groupby; an XLA lowering, no "
                    "pallas_call)",
        "launches": sum(gb_launches.values()),
        "launches_by_path": gb_launches, "cases": gb["cases"],
        "fuzz_launches": fz["reached"]["groupby"],
        "exact": chk.max_err["groupby"] == 0,
        "max_abs_err": chk.max_err["groupby"], "dadd_ms": gb["dadd_ms"],
        "timed": "the whole keyed aggregate (groupby_aggregate): every "
                 "kernel, the G-row sort, memsets and copies it runs",
        "library": "index_add_ into zeros on the card over the per-row "
                   "group ids (the same integers; floats in its atomics' "
                   "order)",
        **summed(gb["timing"], q23_forms, library_ms=sum(
            gb["timing"][f]["library_ms"] for f in q23_forms),
                 kernels_ms=sum(gb["timing"][f]["kernels_ms"]
                                for f in q23_forms),
                 sorted_part_ms=sum(gb["timing"][f]["sorted_part_ms"]
                                    for f in q23_forms)),
        "others": {f: gb["timing"][f] for f in gb["timing"]
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
    # bench.py's shape; launches over the row-hash, partition and entry
    # paths and the meshed plans' partition hash (phase 18)
    entry_launches = dec["entry"]["launches"]
    rh_entry = {"murmur": sum(e["murmur"] for e in entry_launches.values()),
                "xxhash": sum(e["xxhash"] for e in entry_launches.values())}
    kernels.append({
        "name": "row_hash", "route": "cuda", "source": RH_SOURCE,
        "replaces": REPLACES["row_hash"],
        "launches": (sum(rh_launches.values()) + pt_launches["murmur"]
                     + sum(rh_entry.values())
                     + dist["launches"]["murmur"]),
        "launches_by_path": {"row_hash": rh_launches,
                             "partition": {"murmur": pt_launches["murmur"]},
                             "entry": rh_entry,
                             "meshed plans": {
                                 "murmur": dist["launches"]["murmur"]}},
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
        "fuzz_launches": fz["reached"]["fused_select"],
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
        "fuzz_launches": fz["reached"]["topk"],
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
        "status": "redesigned: the build and one capped probe",
        "launches": sum(capped["join_launches"].values()),
        "launches_by_path": capped["join_launches"],
        "fuzz_launches": fz["reached"]["hash_join_capped"],
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
        "status": "redesigned: dead rows no candidates",
        "launches": sum(capped["topk_launches"].values()),
        "launches_by_path": capped["topk_launches"],
        "fuzz_launches": fz["reached"]["topk_capped"],
        "exact": chk.max_err["capped_topk"] == 0,
        "max_abs_err": chk.max_err["capped_topk"],
        "ms": t["ms"], "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "bytes": t["bytes"], "ops": t["ops"], "by_name": t["by_name"],
        "library": "torch.topk(sorted=True) over the first key's values "
                   "with the dead rows ranked last: no tie order, no nulls, "
                   "one key",
        "library_ms": t["library_ms"]})
    # the decimal kernel: launches on the entry step's two runs (the
    # matrix's are checks against the plain version); timed at the entry's
    # multiply (10M rows) and a divide and a remainder on the matrix
    kernels.append({
        "name": "decimal128", "route": "cuda", "source": DEC_SOURCE,
        "replaces": "spark_rapids_tpu/ops/decimal_utils.py:81 "
                    "(multiply_decimal128; add :58, sub :77, divide :115, "
                    "remainder :175: XLA ops, no pallas_call)",
        "launches": sum(e["multiply"] for e in entry_launches.values()),
        "launches_by_path": {**{w: e["multiply"]
                                for w, e in entry_launches.items()},
                             "matrix (checks)": dec["matrix"]["launches"]},
        "exact": chk.max_err["decimal128"] == 0,
        "max_abs_err": chk.max_err["decimal128"],
        "library": "none: no PyTorch call computes a decimal128 op",
        **summed(dec["timing"], ("multiply", "divide", "remainder"),
                 library_ms=None, algorithm_chain_ms=sum(
                     t["algorithm_chain_ms"]
                     for t in dec["timing"].values()))})
    # the row hash's byte path: the customer table's two calls (phase 5c)
    kernels.append({
        "name": "row_hash_bytes", "route": "cuda", "source": RH_SOURCE,
        "replaces": RH_BYTES_REPLACES,
        "launches": sum(cust["launches"].values()),
        "launches_by_path": {"customer hash": cust["launches"]},
        "exact": chk.max_err["row_hash_bytes"] == 0,
        "max_abs_err": chk.max_err["row_hash_bytes"],
        **summed(cust["timing"], ("murmur", "xxhash"), library_ms=None)})
    # the row conversion: the sums over the three bench tables, one call
    # each (phase 9)
    rc_forms = tuple(rconv["timing"]["to_rows"])
    for direction in ("to_rows", "from_rows"):
        kernels.append({
            "name": f"rc_{direction}", "route": "cuda", "source": RC_SOURCE,
            "replaces": RC_REPLACES[direction],
            "launches": rconv["launches"][direction],
            "exact": chk.max_err[f"rc_{direction}"] == 0,
            "max_abs_err": chk.max_err[f"rc_{direction}"],
            "library": "none: no single PyTorch call computes the JCUDF "
                       "row image",
            **summed(rconv["timing"][direction], rc_forms,
                     library_ms=None)})
    # the three kernels' new kinds (phase 10): launches on the q3-strings
    # and q74 paths, timed at their shapes
    kernels.extend(keys_kernels(keys))
    # the cast kernels (phase 13): launches on CastStrings' eight methods,
    # timed at the upstream bench's 16,777,216 rows
    kernels.extend(casts_kernels(casts, chk))
    # parse_uri, from_json and the bloom filter (phase 14): launches on the
    # main path's run, timed at the benches' sizes
    kernels.extend(ujb_kernels(ujb, chk))
    # the time-zone, rebase, Z-order and percentile kernels (phase 17):
    # launches on the main path's run, timed at its sizes
    kernels.extend(dzh_kernels(dzh, chk))
    # the exchange map (phase 18): launches on the meshed plans, the dry run
    # excluded; timed at 10M ids over 8 peers
    kernels.extend(dist_kernels(dist, chk))
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
                       "nds_q5_q23": nds_union, "decimal128": dec,
                       "fuzz": fz, "customer_hash": cust,
                       "row_conversion": rconv, "keys": keys,
                       "feedback": feedback, "casts": casts,
                       "uri_json_bloom": ujb, "runtime": runtime,
                       "parquet": parquet, "datetime_zorder_histogram": dzh,
                       "distributed": dist},
                      f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
