#!/usr/bin/env python3
"""Drive arrowtpu_torch on one NVIDIA GPU and hold it to its references.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then non-zero):
  1. the card's name and power limit, versions, and the nvcc build of the
     CUDA kernels from the repository's sources, with the `-Xptxas -v`
     lines (registers, spills, shared memory) of every instantiation of
     tile_compact_kernel (the kernel of K1, K2 and K3; K2's uint8 ones
     included) and of compact16_kernel (K1's 16-byte words in the
     look-back frame; the ones the stage ablation launches too), of
     tile_gather's round
     trip and staged sublane gather, of lane_roll_kernel and of
     dense_agg_kernel;
  2. every kernel against its plain PyTorch version on the card, bit-exact:
     K1 (kernels/compact3.py) at uint32 with P in {1, 2, 4, 8, 16}, at
     uint64 with P in {1, 2} and at 16-byte words ((P, n, 4) int32, P in
     {1, 2, 4}, also at 5.5 % kept), with tile offsets and without
     (look-back);
     K2 (kernels/compact.py) at uint8 and uint32, with tile offsets and
     without (the count then written on the card), count included;
     keep densities {0, 0.02, 0.5, 0.96, 1}; n in {65,536, 8,000,000} (the
     second is not a multiple of the kernels' 4096-row tile);
  3. the main path: the flagship step (arrowtpu_torch.entry.step) at
     8,000,000 rows with BASELINE's null densities (10 % on a, b, v; 5 % on
     c), at 64 and at 1,000,000 keys, held exactly against a numpy oracle;
     each kernel's launch count is set to 0 just before the step and must
     have risen just after, and every K1 and K2 call of the step is held
     bit for bit against the kernel's plain version on the same inputs
     (`held_to_plain`: all of each output, zero tail included); the
     count kernel's launches are counted on the same run: the filter's
     plan is the one, K2 is one launch, and each of the group-by's K1
     calls passes no tile offsets and makes one K1 launch and no count
     kernel launch;
  4. timing: the step and its three stages at both cardinalities with
     CUDA events (warm-up, then the median of 30 runs; the step again three
     times, the cardinalities in turns, for the spread of the host's
     clock), a torch.profiler breakdown of the step with the device's busy
     share, and each kernel at the main path's largest call (the filter)
     beside its bound, its plain version and the PyTorch library call that
     computes the same function; then K1 at the step's two group-by
     calls, replayed on their operands (a profile of each must show no
     count or scan kernel); K2's byte tiles at 0.5 to 50 % kept, each
     held to the plain version, beside the bound and the 32-byte sectors
     the kept bytes touch; K1 and K2 at 50 and 96 % kept with full outputs, K2 beside a
     `stream` copy of the same bytes.  Kernel, plain and library times are
     CUDA events on the card: the median of 30 calls, each after an L2 flush,
     queued behind a wait so that the host's launch time is hidden
     (`probes.cold_ms`); the kernel's back-to-back time (`warm_ms`) is
     printed beside them;
  5. K3 (kernels/compact2.py, single pass) against its plain version and
     against K1 (the same function), bit-exact with the zero tail, at P in
     {1, 2, 4, 8, 16}, the five densities and both n, each case on two
     masks in a row (the second launch must find its look-back state
     reset);
  6. the distributed join step (arrowtpu_torch.entry.join_step: exchange
     -> hash join -> two-phase group-by, BASELINE config 5) at one card's
     share of config 5's published scale, 1B x 100M rows over 16 chips:
     62,500,000 probe rows x 6,250,000 build rows, world size 1 over NCCL
     (the only cut: 16 chips -> 1 card).  Held exactly against a numpy
     oracle, with the launch counts set to 0 just before and read just
     after (K1 must have run) and every K1 and K2 call of the step held
     against the plain version on its own inputs, as in phase 3 (the
     group-by's compactions of the joined batch); K1 timed at its largest
     call (the group extraction over the joined rows) as in phase 4; then
     the step's time (CUDA events, median), its
     stages, its probing rounds, its peak memory and a torch.profiler busy
     share;
  6b. the skewed join step (BASELINE config 5's skewed-key join): phase
     6's share and nulls, probe keys Zipf(1.0) over the key range,
     `join_step(..., skew_threshold=0.01, probe_chunks=4)`.  Held exactly
     against the numpy oracle, the launch counts set to 0 just before and
     read just after: K1 and K2 must launch inside the skew path's four
     filters (`_filter_bool`, counted around each call), and every K1 and
     K2 call is held to the plain version as in phase 3.  Then the hot
     buckets and rows (no hot overflow), the step's time (CUDA events,
     median), its stages, peak memory and busy share, beside the unskewed
     step on the same data (exact against the oracle too) and its stages;
  7. K3's own path, its entry point compact_planes, at the shape the JAX
     filter gave it: the flagship batch's five int64 columns as 10 u32
     planes x 8,000,000 rows under the flagship mask, counted, then timed
     beside its bound, its plain version, the library call and K1, and
     again at 50 % and 96 % kept;
  8. `dryrun_multichip(1)`: the dryrun's own tiny shapes on the card;
  9. the probe kernels (kernels/probes.py, the counterparts of the TPU
     probes P1-P8) against their plain versions, bit for bit: stream at
     P in {1, 2, 16} and n in {65,536, 8,060,928, 8,000,001}, with and
     without keep; lane_roll at (k, nsel) in {(7, 0), (14, 14), (56, 56),
     (28, 14), (13, 5), (20, 1), (64, 0), (71, 70)} under both masks, at
     62,976, 1, 3 and 1001 rows and one word into the buffers;
     tile_gather, every pattern at W in {128, 256}; compaction_stages, every stage of K3 and K1 at densities {0, 0.055,
     0.5, 1} (P = 2, n = 8,000,001); the round trip also against the
     identity;
  10. `probes.run_probes()` at the probes' own shapes, its launch counts
     set to 0 just before and read just after (every probe kernel must
     have run): one line per H100 function with the probe bodies it
     answers, then the measured copy floor; then the stage ablation of K3
     and K1 at phase 7's flagship call.  Every line's kernel is held bit
     for bit to its plain version at the shape it is timed at;
  11. BASELINE config 3 (`entry.lexsort_step`, the lexsort of int32,
     float64 and dictionary-utf8 columns) at its full 100,000,000 rows:
     held to np.lexsort at 1,000,000 rows, then at full size to the host
     check (a permutation under which the key tuples never decrease and
     ties keep row order), its time (CUDA events, median of 5), its
     stages (encode, pack read-back and sort_permutation by CUDA events;
     each stable sort pass's device time from a torch.profiler trace of
     the step), the words pack forms, its peak memory and a
     torch.profiler busy share.  It
     runs no kernel of the port: PyTorch's sort does the work;
  12. BASELINE config 4 as `bench.py` config4_hash_agg runs it, at its
     full 8,000,000 rows (int32 key in [0, 100) and [0, 1,000,000), int64
     value in [-1000, 1000), seed 3; sum, count and min): the plan
     (`entry.agg_plan`, plan_group_by) must choose the dense engine at 128
     buckets at 100 keys and the sort pipeline at 1,000,000, as the
     reference does; the launch counts set to 0 just before the step
     (`entry.agg_step`) and read just after: one dense_agg launch and no
     K1 at 100 keys, K1 and no dense_agg at 1,000,000; the output exact
     against the numpy oracle (`entry.check_agg`: keys, sums, counts,
     mins), every dense_agg call of the step bit for bit equal to
     `dense_aggregate_plain` on its own inputs and every K1 call to its
     plain version, and unplanned `group_by` equal to the plan's output.
     Then the step's time (CUDA events, warm-up, median of 30 with its
     min and max), peak memory and torch.profiler busy share; dense_agg
     at the step's call beside its bytes bound (at 3.35 TB/s and at the
     measured copy floor), its plain version and the library calls
     (bincount + index_add_ + two scatter_reduce, one sequence); K1 at
     the high-cardinality step's calls as in phase 4;
  13. TPC-H Q6 (`entry.q6_step`: the predicate on a Date32 and two
     Decimal128(15, 2) columns, `filter_record_batch` of all 16 `lineitem`
     columns by one plan, the revenue by decimal limb arithmetic) over a
     whole `lineitem` at SF10 (`entry.example_lineitem_arrays`, about 60M
     rows by TPC-H Clause 4.2.3, nothing cut): the launch counts set to 0
     just before the step and read just after, K1 launched at 16-, 8- and
     4-byte words (counted by `_build.launch_words`), every K1 call held to
     its plain version; exact against `entry.q6_oracle` (every kept column
     and the revenue as an integer); the profiler's kernels of the filter
     past its plan (K1 alone: no transpose or copy feeds it); the step's
     time (CUDA events, median of 10), its stages (predicate, plan,
     filter, revenue), busy share and peak memory; K1's 16-byte launch at
     its call shape held to plain in both frames on poisoned outputs and
     timed beside its bytes bound (3.35 TB/s and the copy floor), its
     sector floor, its plain version and the library's boolean index, and
     at 50 / 96 % kept; the stage ablation at that call (rank, kept, full
     of compact16_kernel and of tile_compact_kernel<uint4>, each held to
     its plain stage; compact16_kernel's kept stage at P = 1 too); then
     `take_record_batch` of 1,000,000 uniform
     ids (1 % null, 1 % past the end) held to a numpy gather of every
     column, and timed;
  14. the nested classes at config 1's 8,000,000 rows
     (list_view<int64> of 0-7 items, struct<i: int32, s: utf8> with
     strings of 0-20 bytes, fixed_size_list<float32, 4>, bool; 10 % nulls
     on every top-level column and on the struct's children): a mask
     keeping 50 % with 10 % null rows through `filter_record_batch`, its
     launches counted (K1 and K2 must both launch) and by word size,
     every K1 and K2 call held to its plain version, and
     `take_record_batch` of 4,000,000 ids (1 % null, 1 % past the end),
     both held to numpy gathers of the inputs' own arrays, and timed;
  15. (run right after phase 13, on its arrays and batch, which are then
     freed) TPC-H Q1 (`entry.q1_step`: l_shipdate <= 1998-09-02, the
     filter of the six columns Q1 reads, disc_price and charge by decimal
     limb arithmetic, the group-by of the two one-letter string flags
     with four decimal sums, three means and a count, the sort by the
     flags) over the whole SF10 `lineitem`: the launch counts set to 0
     just before the step and read just after, K1 at 16-byte words in the
     filter and at 16 and 8 bytes in the group-by's extraction (counted
     by `_build.launch_words` and by calling module), every K1 call held
     to its plain version; exact against `entry.q1_oracle` (4 groups, the
     sums as integers, the means bit for bit, the counts); the step's time
     (CUDA events, median of 5 with min and max), its stages (predicate,
     plan, filter, prices, group-by with its encode, sort, limb prefix
     sums and extraction, final sort), busy share and peak memory; K1 at
     the filter call and at the group-by's calls beside their bounds,
     plain versions and library calls; then `sort_to_indices` of SF1's
     `l_comment` (about 6M strings of 10-43 bytes), which must run the
     grouped sort and equal numpy's stable argsort of the bytes, timed;
  16. (run after phase 6b) config 5's join step at phase 6's share with k
     carried as TPC-H's c_name, "Customer#%09d" (18 bytes, in the arena),
     on both sides and rv as a Decimal128(15, 2)
     (`entry.text_join_batches`): the string hash, the exchange of string
     views and decimals, string-key probing and a decimal partial sum
     through the exchange of the two-phase group-by by the text key.  The
     launch counts set to 0 just before the step and read just after (K1
     must run, by module and word size; no dense_agg), every K1 and K2
     call held to its plain version, the group-by's K1 calls read as in
     phase 6; exact against `entry.join_oracle` on the integer keys
     (`entry.check_text_join_output`); the step's time (CUDA events,
     median of 3), its stages (the key hash of both sides, exchange,
     build, probe, expand + take, group-by), peak memory and busy share;
  17. (run after phase 15, on its lineitem and oracle) the lineitem
     through `entry.lineitem_exchange` (hash partition on l_orderkey,
     world size 1 over NCCL: every column class of the batch moves),
     which must give the batch back row for row, bit for bit
     (`entry.check_same_rows`), then TPC-H Q1 as a distributed group-by
     on the exchanged batch (`entry.q1_distributed_step`), its sums and
     count_order exact against `q1_oracle`, the launch counts set to 0
     before and read after (K1 at 16 bytes in the filter and at 16 and 8
     bytes in the group-by), every K1 and K2 call held to plain; the
     exchange's time (median of 3), its stages (the plan, then each
     column class through it), peak and busy share, and the distributed
     Q1's.  Phases 6, 6b and 15 time their steps over 5 runs (10 before
     phases 16-17 were added), so that the run stays within its earlier
     time;
  18. (after phase 17, on the card beside phase 13's lineitem) TPC-H's
     `part` at SF10 (`entry.example_part_arrays`, 2,000,000 rows by Clause
     4.2.3, `entry.part_batch`: utf8 views), then the LIKE family with
     TPC-H's own patterns (Q2's p_type LIKE '%BRASS', Q9's p_name LIKE
     '%green%', Q16's p_type NOT LIKE 'MEDIUM POLISHED%', Q20's p_name
     LIKE 'forest%', Q19's p_brand = 'Brand#12' and p_type ILIKE
     'promo%'), each count exact against numpy on the host strings, each
     line with its time (CUDA events, median of 10) and the bytes of its
     byte matrix;
  19. TPC-H Q14 (`entry.q14_step`: the month's lineitem filtered, hash
     join with part, disc_price through `ops.numeric`, zip_ of p_type
     LIKE 'PROMO%') and Q19 (`entry.q19_step`: both sides' conjuncts
     pushed down, the join, the three-way predicate again, the revenue)
     over phase 13's lineitem and phase 18's part, each exact against its
     oracle (`q14_oracle`, `q19_oracle`); the launch counts set to 0 just
     before each step and read just after (K1 must launch in the lineitem
     filter), counted by calling module and word size, every K1 and K2
     call held to plain; then each step's time (CUDA events, median of
     5), its stages, peak memory and busy share, and Q14's promo revenue;
  20. (after phase 19, on phase 13's lineitem less its two dictionary
     columns, which `interleave` does not take: 14 columns) an external
     sort, `entry.sorted_runs_step`: the table cut into 8 runs
     (`slice_batch`), each sorted by (l_shipdate, l_extendedprice desc,
     l_orderkey, l_linenumber), a unique key, then `merge_batches`; it
     must equal one `sort_batch` of the whole (`equal_batches` on the card)
     and, on its key columns, numpy's lexsort of the arrays, row for row.
     Then the RowConverter round trip of (l_returnflag, l_linestatus,
     l_shipdate desc, l_extendedprice, l_shipmode, l_comment) over the
     whole table, each column back by `equal_columns` on the card (numpy's
     lexsort runs on a host thread from the end of phase 13 on).  The
     launch counts are read around the sort (it runs no port kernel); the
     stages are timed (CUDA events, median of 3: the cut, the run sorts,
     `merge_indices`, `interleave` per column class, `merge_batches`, the
     whole step, one `sort_batch`, `convert_columns`, `convert_rows`) with
     the step's busy share and peak memory;
  21. TPC-H Q3 (`entry.q3_step`: customer filtered on c_mktsegment =
     'BUILDING' by `like` on its dictionary, orders on o_orderdate and
     lineitem on l_shipdate, customer ⋈ orders and lineitem ⋈ that by
     `hash_join`, revenue through `ops.numeric`, the group-by on
     (l_orderkey, o_orderdate, o_shippriority) with a Date32 key, the top
     ten by `sort_batch`) over phase 13's lineitem and SF10 orders (15M
     rows) and customer (1.5M) drawn by `entry.example_orders_arrays` /
     `example_customer_arrays` and built on the card: exact against
     `entry.q3_oracle`, the launch counts set to 0 just before the step and
     read just after (K1 must launch in the filters), every K1 and K2 call
     held to plain; the step's time (median of 5), its stages, peak memory
     and busy share;
  22. ClickBench's queries 1-8 (`entry.clickbench_step`, each by its text
     in ClickBench's queries.sql: COUNT with AdvEngineID <> 0; SUM of a
     UInt8 cast to uint64, COUNT and AVG; AVG of the uint64 UserID cast
     to float64; COUNT(DISTINCT UserID); MIN and MAX of a Date32; the
     filtered GROUP BY AdvEngineID; COUNT(DISTINCT UserID) by RegionID,
     top ten; the top ten UserIDs by rows) over `hits` drawn at its
     published 99,997,497 rows (`entry.example_hits_arrays`: UserID
     uint64, RegionID uint32, ResolutionWidth uint16, AdvEngineID uint8,
     EventDate Date32, the five of 105 columns these queries read, about
     1.9 GB on the card): the engine `plan_group_by` picks for each
     group-by; per query the launch counts set to 0 just before the step
     and read just after (K1 must launch at 8 bytes in queries 4, 7 and 8
     and K2 at one byte in query 6's filter), every K1 and K2 call held to
     plain and every dense_agg call to `dense_aggregate_plain` (and timed
     at its call beside its plain version); every
     query exact against `entry.clickbench_oracle` (numpy on a host
     thread; AVG(UserID) within a relative 1e-12 of the exact mean); each
     step's time (CUDA events, median of 5 with min and max), its stages,
     peak memory and busy share;
  23. ClickBench's query 43 (`entry.q43_step`: CounterID = 62 and
     EventDate in 2013-07-14..15 compared on the runs of their run-end
     encodings and decoded to rows, IsRefresh = 0, DontCountHits = 0, the
     filter of EventTime, DATE_TRUNC('minute') as EventTime less its
     Europe/Moscow second, the group-by, ORDER BY, OFFSET 1000 LIMIT 10)
     over `hits` in its primary-key order, drawn at 99,997,497 rows
     (`entry.example_hits_pk_arrays`: CounterID uint32, EventDate Date32,
     EventTime Timestamp("s", "Europe/Moscow"), IsRefresh and
     DontCountHits uint8, the 5 of 105 columns it reads): the two
     `run_end_encode`s of `entry.hits_pk_batch` against numpy's runs and
     decoded back bit for bit (K1 must launch at 4 bytes), `take_run` of
     1,000,000 ids (1 % null) against numpy's gather, year, month and day
     of EventTime under Europe/Moscow equal to EventDate's on every row,
     the query exact against `entry.q43_oracle` (K1 at 8 bytes; its run
     predicates' mask once against the decoded columns'), then the host
     boundary: `pretty_format_batches` of the result, `iter_rows`, and the
     C Data round trip of the result and of 1,000,000-row slices of the
     plain columns onto the card.  The launch counts are set to 0 just
     before each step and read just after, every K1 / K2 call held to
     plain, every dense_agg call to `dense_aggregate_plain`; the encodes,
     decodes, take_run, the date_part passes, the query and the round
     trip timed (CUDA events, median of 5 with min and max), the query's
     stages, peak memory and busy share;
  24. (after phase 21, on phase 13's lineitem) the batch written by
     `entry.lineitem_ipc` as an Arrow IPC file and as a stream of
     1,048,576-row record batches (`slice_batch`, 58 of them) into host
     memory, read back onto the card by `entry.read_lineitem_ipc` with
     validate=True (core/validate.py: the UTF-8 check over all 60M
     l_comment strings, the key bounds of both dictionaries) and
     concatenated: held to the batch by `entry.check_same_rows`
     (dictionaries by value); Q6 on it exact against `entry.q6_oracle`,
     the launch counts set to 0 just before the step and read just after
     (K1 at 16, 8 and 4 bytes), every K1 call held to plain; batches 1 and
     57 by the file's footer against `slice_batch`; the stream read the
     same; a 0xFF byte in an l_comment, then an l_shipmode key of 7, in the
     stream's first batch must raise ValidationError naming
     l_comment.invalid_utf8 / l_shipmode.dict_key_out_of_bounds (the bytes
     read without validate must not raise); an lz4 round trip of the
     first 65,536 rows.  Timed on the host's clock with the card
     synchronized: both writes (the writer's pieces, then their join
     into one buffer), the validated reads of the file and the
     stream, the stream read without validate (parse, copies,
     concatenation), `check_batch` over the read table and its UTF-8
     check of l_comment alone, Q6 on the read batch (CUDA events, median
     of 3), GB/s over the file's bytes and peak memory.
  25. (after phase 23, on its `hits` arrays; freed after it) the table
     written to one Parquet file in host memory by `entry.hits_pk_parquet`
     (formats/parquet.py: 96 row groups of 1,048,576 rows, data pages of
     20,000 rows, statistics, the page index and a CounterID bloom filter,
     dictionaries on, uncompressed; NOT NULL; EventTime cast on the card
     from Timestamp("s", "Europe/Moscow") to Timestamp("us") first, since
     the writer labels a timestamp microseconds and keeps no zone), then
     scanned onto the card by `formats.parquet_scan.scan_parquet` with
     query 43's predicates pushed down (`entry.q43_predicates`: row groups
     pruned by statistics and the bloom filter, pages by the page index,
     the predicates on the card, each mask read back once, the final
     `filter_record_batch`): its rows equal, in order, those a numpy mask
     of the same predicates selects from the arrays, and `entry.q43_step`
     on them (EventTime cast back to its zone, `entry.hits_from_parquet`)
     exact against phase 23's `q43_oracle`; the full scan with
     DontCountHits = 0 alone (every row group and page decoded), its
     count and its EventTime and CounterID exact against numpy; one row
     group through `parquet_push.decode_with_reader` equal to
     `ParquetFile.read_row_group`'s; a GZIP round trip of one row group.
     K1 and K2 must launch in each scan's filters (K1 at 4 and 8 bytes, K2
     at one byte), counted by calling module and word size, every call
     held to plain.  Timed on the host's clock with the card synchronized:
     the write, each scan end to end and by stage (footer, pruning, host
     decode, upload, predicates with their read-backs, filter), Q43 on the
     scanned batch (CUDA events, median of 5), GB/s over the bytes each
     scan decoded, peak memory and busy share.  Cut: none of the table's
     rows; the scans' stages are timed on their own run, with a
     synchronization around each stage.
  26. (right after phase 22, on its `hits` arrays; freed after it) the
     row formats.  (a) The first 16,777,216 rows as one Avro OCF (null
     codec, 65,536-row blocks, every field a ["null", T] union as the
     port's `write_avro` writes a batch's nullable fields), built by a
     numpy encoder of the zigzag varints (`hits_avro_ocf`) whose header
     and first block must equal `write_avro`'s bytes with the sync marker
     in place; read back by `formats.avro.read_avro`'s halves (the native
     flat decoder on the host, `decode_flat`, then one upload a column,
     `upload_flat`, timed apart) and given back ClickHouse's types
     (UserID from the long's int64 bits, ROADMAP C.3 fault 19; the narrow
     ones by `ops.cast`), equal to the arrays; queries 1-8 exact against
     `clickbench_oracle` over those rows (numpy on a host thread), K1 at 8
     bytes in queries 4, 7, 8, K2 at one byte and dense_agg in query 6,
     every call held to plain.  (c) `flightsql.execute_select` of
     FLIGHTSQL over that batch on the card (K1 at 4 and 8 bytes and K2 at
     one byte in its filter, held to plain), framed as DoGet frames it
     (`flight.encode_batches`) and decoded onto the card
     (`flight.decode_batches`), equal to numpy's selection; the card's
     machine has no grpc, so this is all of Flight that runs there.  (b)
     The first 1,048,576 rows as TSV (hits.tsv's layout) and as NDJSON,
     written by the port's writers and read back under the hits schema
     in 65,536-row batches (the parse and the column building timed
     apart), equal to the arrays, then queries 1-8 as in (a).  For each
     format: write and read s, MB/s over the file's bytes, the card's busy
     share of the read, peak memory, each query's ms (CUDA events, median
     of 3) and the K1 / K2 / dense_agg calls by calling module.  Cuts:
     16,777,216 and 1,048,576 rows of the 99,997,497, for the host's
     decode and parse times.
  27. (last, after phase 14) JSONBench's Bluesky events as a shredded
     Variant column (`jsonbench_phase`): 524,288 documents of Jetstream's
     shape drawn by `entry.example_bluesky_docs` (the cut: JSONBench's 1m
     size less its host time, the Python parse and shred), parsed and
     encoded on the host (`variant.batch_json_to_variant`) and shredded to
     (kind, did, time_us, commit.operation, commit.collection)
     (`variant.shred_variant`), the stages' host seconds, uploads and busy
     shares apart; `variant_get` of the five paths, each the shredded
     typed column itself with no row decoded, and commit.rkey from the
     residual by the host fallback; JSONBench's five queries exact against
     `entry.jsonbench_oracle` (Python's json), K1 at 16 and 8 bytes in
     Q2-Q5, every K1 / K2 / dense_agg call held to plain, each query's ms;
     the column through Parquet and back (its columns equal, Q1 exact) and
     `python -m arrowtpu_torch.cli` rowcount / schema / cat over the file;
     65,536 rows through the archery JSON format and `json-integration`
     (the cut: a conformance format, not a data path); `cli bench` on the
     card (K1 / K2 held to plain); a FixedShapeTensor over phase 14's
     fixed_size_list<float32, 4> as a Tensor (n, 2, 2), equal to numpy.

The line before the last lists the kernels as JSON (`launches` from the
flagship step for K1 and K2, from K3's entry point for K3, from
run_probes for the probe kernels, from config 4 at 100 keys for
dense_agg and from the Q6 step for K1's 16-byte words; every path's counts under `launches_by_path`, the skewed
step's filters as a path of their own, TPC-H Q1, the text join step, the
lineitem exchange, the distributed Q1, Q14, Q19, the external sort, Q3,
ClickBench's eight queries, phases 23's and 25's steps, phase 26's
queries and FlightSQL statement and phase 27's variant_get, JSONBench
queries and `cli bench` too; the
flagship, join
and skewed join steps, int64-keyed, must launch no dense_agg; K1's 16-byte
row carries its Q1 calls), after the Q1 step's, the l_comment sort's,
the LIKE lines', the Q14 and Q19 steps', the external sort's, the Q3
step's, phase 24's, the eight ClickBench steps', phase 23's, phase
25's, phase 26's and phase 27's JSON lines and the card's line; the last
line is
{"ok": true, "device": {...}}.
Without a CUDA device the script exits with an error and prints no
result.
"""

import collections
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_MAIN = 8_000_000
CARDINALITIES = (64, 1_000_000)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
REPS = 30
# config 5 (1B probe x 100M build rows over 16 chips), one chip's share;
# probe keys over 1.25x the build keys, so about one probe row in five
# misses
PROBE_ROWS = 62_500_000
BUILD_ROWS = 6_250_000
PROBE_KEY_RANGE = 7_812_500
JOIN_REPS = 5  # 10 before phases 16-17 were added
JOIN_AGGS = [("rv", "sum"), ("rv", "count")]
# the skewed join step: the same share and nulls, probe keys Zipf(1.0)
# over the key range, the skew path at 1 % and four probe chunks
SKEW_ZIPF = 1.0
SKEW = {"skew_threshold": 0.01, "probe_chunks": 4}
# the text-keyed join step (phase 16) and the lineitem exchange (phase 17)
TEXT_REPS = 3
EXCHANGE_REPS = 3
LEXSORT_ROWS = 100_000_000  # BASELINE config 3, nothing cut
LEXSORT_CHECK_ROWS = 1_000_000  # held to np.lexsort itself
LEXSORT_REPS = 5
# BASELINE config 4 as bench.py config4_hash_agg runs it, nothing cut: the
# plan's engine and bucket count expected at each cardinality
AGG_ROWS = 8_000_000
AGG_CASES = (("low_card", 100, "dense", 128), ("high_card", 1_000_000,
                                               "sort", 0))


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_times_ms(fn, reps=REPS, warmup=3) -> list:
    """`reps` CUDA-event timings of fn() (each a separate run, after
    `warmup` runs), ascending."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def median_ms(fn, reps=REPS, warmup=3) -> float:
    """Median of `reps` CUDA-event timings of fn() (each a separate run)."""
    return statistics.median(run_times_ms(fn, reps, warmup))


def _profiled(fn, reps):
    """Run fn() `reps` times under torch.profiler (after one warm-up run);
    -> (key_averages, wall seconds of the window)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.key_averages(), wall


def _device_us(rows) -> float:
    return sum(r.self_device_time_total for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA)


def cold_ms(fn, reps=REPS) -> float:
    """Median time of one call of fn() on the card after an L2 flush, the
    host's launch time hidden (arrowtpu_torch.probes.cold_ms)."""
    from arrowtpu_torch.probes import cold_ms as timed

    return timed(fn, reps)


def warm_ms(fn, reps=REPS) -> float:
    """Mean time per call of back-to-back calls of fn() on the card
    (arrowtpu_torch.probes.warm_ms)."""
    from arrowtpu_torch.probes import warm_ms as timed

    return timed(fn, reps)


def profile(fn, reps=5):
    """Device time by kernel over `reps` runs of fn(), and the device's
    busy share of the window's wall time."""
    rows, wall = _profiled(fn, reps)
    busy_us = _device_us(rows)
    log(rows.table(sort_by="self_device_time_total", row_limit=14,
                   max_name_column_width=60))
    return {"wall_ms_per_run": wall / reps * 1e3,
            "device_ms_per_run": busy_us / reps / 1e3,
            "device_busy_share": busy_us / (wall * 1e6)}


def bytes_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


WORDS = {"h": "u8", "j": "u32", "m": "u64", "y": "u64", "5uint4": "16 B"}
KEYS = {"a": "i8", "s": "i16", "i": "i32", "h": "u8", "t": "u16", "j": "u32"}
FRAMES = {"0": "offs", "1": "look-back"}
STAGE_NAMES = {"0": "copy", "1": "rank", "2": "lookback", "3": "kept",
               "4": "full"}


def _kernel_label(mangled: str):
    """The instantiation a ptxas report is of, for the kernels whose
    resources chip_smoke prints, else None."""
    import re

    t = re.search(r"tile_compact_kernelI(5uint4|\w)Li(\d)ELi(\d)E", mangled)
    if t:
        return (f"tile_compact_kernel<{WORDS.get(t[1], t[1])}, "
                f"{FRAMES[t[2]]}, {STAGE_NAMES[t[3]]}>")
    t = re.search(r"compact16_kernelILi(\d)ELi(\d)E", mangled)
    if t:
        return f"compact16_kernel<{FRAMES[t[1]]}, {STAGE_NAMES[t[2]]}>"
    t = re.search(r"sublane_gather_kernelILi(\d+)E", mangled)
    if t:
        return f"sublane_gather_kernel<W={t[1]}>"
    if re.search(r"tile_gather_kernelILi8ELi256E", mangled):
        return "tile_gather_kernel<roundtrip, 256>"
    if "lane_roll_kernel" in mangled:
        return "lane_roll_kernel"
    t = re.search(r"dense_agg_kernelI(\w)E", mangled)
    if t:
        return f"dense_agg_kernel<{KEYS.get(t[1], t[1])} key>"
    return None


def ptxas_reports(build_log: str):
    """The `-Xptxas -v` report of each instantiation of tile_compact_kernel
    and compact16_kernel, of tile_gather's round trip and staged sublane
    gather, of
    lane_roll_kernel and of dense_agg_kernel: [(label, [its register /
    spill / shared memory lines])]."""
    import re

    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = _kernel_label(m[1])
            cur = None if label is None else (label, [])
            if cur:
                out.append(cur)
        elif cur and ("registers" in line or "spill" in line):
            cur[1].append(line.strip())
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(k1, k2, dev) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [("K1", torch.int32, P) for P in (1, 2, 4, 8, 16)]
    cases += [("K1", torch.int64, P) for P in (1, 2)]
    cases += [("K2", torch.uint8, 4), ("K2", torch.int32, 1)]
    # K1's 16-byte word: (P, n, 4) int32 planes, a word a row
    cases += [("K1", "16 B", P) for P in (1, 2, 4)]
    for n in (65_536, N_MAIN):
        for kernel, dtype, P in cases:
            wide = dtype == "16 B"
            dtype = torch.int32 if wide else dtype
            info = torch.iinfo(dtype)
            planes = torch.randint(info.min, info.max,
                                   (P, n, 4) if wide else (P, n),
                                   dtype=dtype, device=dev, generator=g)
            for density in ((0.0, 0.02, 0.055, 0.5, 0.96, 1.0) if wide
                            else (0.0, 0.02, 0.5, 0.96, 1.0)):
                keep = torch.rand(n, device=dev, generator=g) < density
                if kernel == "K1":
                    got = k1.compact_planes(planes, keep)
                    want = k1.compact_planes_plain(planes, keep)
                    cnt = wcnt = 0
                    offs = k1.tile_offsets(keep)
                    if not torch.equal(k1.compact_planes(planes, keep, offs),
                                       want):
                        raise AssertionError(
                            f"K1 {dtype} P={P} n={n} density={density}: "
                            "differs from its plain version with offs")
                else:
                    keep = keep.to(torch.uint8)
                    offs = k2.tile_info(keep)
                    got, cnt = k2.compact_planes_info(planes, keep)
                    want, wcnt = k2.compact_planes_info_plain(planes, keep)
                    got_o, cnt_o = k2.compact_planes_info(planes, keep, offs)
                    if not torch.equal(got_o, want) or int(cnt_o) != int(wcnt):
                        raise AssertionError(
                            f"K2 {dtype} P={P} n={n} density={density}: "
                            "differs from its plain version with offs")
                torch.cuda.synchronize()
                if not torch.equal(got, want) or int(cnt) != int(wcnt):
                    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
                    raise AssertionError(
                        f"{kernel} {dtype} P={P} n={n} density={density}: "
                        f"differs from its plain version (max |diff| "
                        f"{int(diff.max())}, count {int(cnt)} vs {int(wcnt)})")
                kept = int(keep.sum())
                if got[:, kept:].any():
                    raise AssertionError(f"{kernel}: tail past count not zero")
                # an output cut to fewer rows (at least the count), as the
                # filter and the group extraction ask for
                rows = min(n, kept + 100)
                shorts = ([k1.compact_planes(planes, keep, o, rows)
                           for o in (None, offs)] if kernel == "K1" else
                          [k2.compact_planes_info(planes, keep, o, rows)[0]
                           for o in (None, offs)])
                if not all(torch.equal(x, want[:, :rows]) for x in shorts):
                    raise AssertionError(
                        f"{kernel} {dtype} P={P} n={n} density={density}: "
                        f"out_rows={rows} differs from its plain version")
        log(f"kernels: bit-exact against plain at n={n} "
            f"({len(cases)} shapes x 5 densities, 6 for 16-byte words; K1 "
            "with tile offsets and with the look-back, at 4-, 8- and "
            "16-byte words; K2 in both frames, count included)")


def k2_density_sweep(k1, k2, planes, dev) -> None:
    """K2's byte tiles (the filter's four validity planes, tile offsets,
    output cut to the count rounded to 64 rows) at 0.5, 2, 5.5, 12.5, 25
    and 50 % kept, on both sides of the dense threshold (a fifth of a
    tile's rows kept): each held bit for bit to the plain version, then
    timed (cold_ms) beside the bound and the bytes of the 32-byte sectors
    that the kept bytes touch (mask + touched sectors of every plane +
    output), at 3.35 TB/s."""
    from arrowtpu_torch.probes import fresh_call

    n = planes[0].shape[0]
    g = torch.Generator(device=dev).manual_seed(5)
    for density in (0.005, 0.02, 0.055, 0.125, 0.25, 0.5):
        keep = torch.rand(n, device=dev, generator=g) < density
        kept = int(keep.sum())
        rows = -(-max(kept, 1) // 64) * 64
        offs = k1.tile_offsets(keep)
        want = k2.compact_planes_info_plain(planes, keep, rows)[0]
        sectors = int(keep[: n - n % 32].view(-1, 32).any(1).sum())
        sector_bytes = n + len(planes) * (32 * sectors + rows)
        bound = n + len(planes) * (kept + rows)

        def run():
            return k2.compact_planes_info(planes, keep, offs, rows)[0]

        got = fresh_call(run, want)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K2 at {density:.1%} kept: differs from "
                                 "its plain version")
        log(f"  K2 u8 sweep, {density:.1%} kept ({kept} rows, {sectors} "
            f"of {n // 32} sectors touched): {cold_ms(run):.4f} ms; bound "
            f"{bytes_bound_ms(bound):.4f} ms, sectors "
            f"{bytes_bound_ms(sector_bytes):.4f} ms")


# ---------------------------------------------------------------------------
# phase 3: the main path against a numpy oracle
# ---------------------------------------------------------------------------

# the wrappers a main-path run holds to the plain version at every call:
# (the module attribute the port calls, the plain version)
HELD = {"K1": ("compact_planes", "compact_planes_plain"),
        "K2": ("compact_planes_info", "compact_planes_info_plain")}

# one wrapper call on a main-path run: its operands (offs: the tile offsets
# it was given, or None), the module that called it, and the launches it
# made ({kernel: n, "tile_counts": n})
Call = collections.namedtuple(
    "Call", "planes keep offs out_rows caller launched")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _tensors(y)]


@contextlib.contextmanager
def held_to_plain(modules, args=None):
    """While active, every call of the wrappers of `modules` ({"K1": ...,
    "K2": ...}) is computed again by the kernel's plain version on the same
    inputs and must equal it bit for bit: every output word (the zero tail
    and the rows past what the caller reads included) and K2's count.  The
    plain version launches nothing, so the launch counts stay the path's.
    Yields {kernel: [(P, n, kept, out_rows) of each call]}; `args`, a dict,
    gets {kernel: [Call of each call]}: its operands, the module that made
    it, and the launches of the kernel and of the count kernel
    (tile_counts_kernel) that the wrapper made, read from their counters
    around the call on the path's own run."""
    from arrowtpu_torch.kernels import _build

    seen = {name: [] for name in modules}
    saved = []

    def hold(name, mod):
        wrapper, plain = (getattr(mod, attr) for attr in HELD[name])

        def checked(planes, keep, pre=None, out_rows=None):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            before = (mod.launches, _build.count_launches)
            got = wrapper(planes, keep, pre, out_rows)
            launched = {name: mod.launches - before[0],
                        "tile_counts": _build.count_launches - before[1]}
            want = plain(planes, keep, out_rows)
            a, b = _tensors(got), _tensors(want)
            shape = (len(planes), keep.shape[0], int(keep.sum()),
                     keep.shape[0] if out_rows is None else out_rows)
            if len(a) != len(b) or not all(
                    torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name} call {shape} on the path "
                                     "differs from its plain version")
            seen[name].append(shape)
            if args is not None:
                args.setdefault(name, []).append(Call(
                    planes, keep, pre, out_rows, caller, launched))
            return got

        saved.append((mod, HELD[name][0], wrapper))
        setattr(mod, HELD[name][0], checked)

    try:
        for name, mod in modules.items():
            hold(name, mod)
        yield seen
    finally:
        for mod, attr, wrapper in saved:
            setattr(mod, attr, wrapper)


def oracle(arrays):
    """Kleene mask, filter, then per key sum / count / min of valid v."""
    (a, av), (b, bv), (c, cv) = arrays["a"], arrays["b"], arrays["c"]
    (k, kv), (v, vv) = arrays["k"], arrays["v"]
    if kv is not None:
        raise ValueError("the oracle takes a key without nulls")
    keep = av & bv & (a > b) & cv & (np.fmod(c, 7) == 0)
    kf, vf, okf = k[keep], v[keep], vv[keep]
    keys, inv = np.unique(kf, return_inverse=True)
    g = len(keys)
    count = np.bincount(inv[okf], minlength=g).astype(np.int64)
    sums = np.zeros(g, np.int64)
    np.add.at(sums, inv[okf], vf[okf])
    mins = np.full(g, np.iinfo(np.int64).max)
    np.minimum.at(mins, inv[okf], vf[okf])
    has = count > 0
    return {"k": (keys, None), "sum_v": (np.where(has, sums, 0), has),
            "count_v": (count, None), "min_v": (np.where(has, mins, 0), has)}


def check_against_oracle(out, want, bm):
    g = len(want["k"][0])
    if out.length != g:
        raise AssertionError(f"{out.length} groups, oracle {g}")
    if out.schema.names != ["k", "sum_v", "count_v", "min_v"]:
        raise AssertionError(f"output columns {out.schema.names}")
    for name, (vals, valid) in want.items():
        c = out[name]
        got = c.values.cpu().numpy()
        if not np.array_equal(got[:g], vals):
            raise AssertionError(f"{name}: values differ from the oracle")
        if got[g:].any():
            raise AssertionError(f"{name}: padding past the length not zero")
        if valid is None:
            if c.validity is not None:
                raise AssertionError(f"{name}: unexpected validity")
        else:
            ok = bm.unpack(c.validity).cpu().numpy()
            if not (np.array_equal(ok[:g], valid) and not ok[g:].any()):
                raise AssertionError(f"{name}: validity differs")


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------


def time_kernel(name, wrapper, plain, library, planes, keep, out_rows):
    """The kernel wrapper, its plain version and the library call on the
    same inputs: the card's time per call after an L2 flush (cold_ms), and
    the wrapper's back-to-back (warm_ms), beside the function's bound for this run's data: the mask read once, the kept
    words read once, the out_rows words of every output plane written once
    (the zero tail is part of the output).  There is no arithmetic to bound
    it."""
    P, n = len(planes), keep.shape[0]
    from arrowtpu_torch.kernels import _build

    w = _build.word_bytes(planes[0])
    kept = int(keep.sum())
    nbytes = n * keep.element_size() + P * w * kept + P * w * out_rows
    row = {"ms": cold_ms(wrapper), "warm_ms": warm_ms(wrapper),
           "plain_ms": cold_ms(plain), "library_ms": cold_ms(library),
           "bound_ms": bytes_bound_ms(nbytes), "bound_by": "bytes",
           "shape": f"P={P} x n={n} x {w} B -> {out_rows} rows, "
                    f"kept {kept}"}
    log(f"  {name}: {row}")
    return row


def device_kernel_names(fn, reps=3) -> list:
    """The names of the kernels (and memsets) fn() runs on the card, from a
    torch.profiler trace of `reps` calls."""
    rows, _ = _profiled(fn, reps)
    return sorted({r.key for r in rows
                   if r.device_type == torch.autograd.DeviceType.CUDA})


def group_by_calls(args, tile_counts, label):
    """The K1 calls that the group-by (ops/groupby.py, group extraction)
    made on a main-path run, from held_to_plain's record of that run: there
    must be some, and each must have passed no tile offsets and made
    ceil(P / 16) K1 launches and no count kernel launch.  `tile_counts`,
    the run's count-kernel launches, must be one for each set of tile
    offsets the run's compactions shared (the filter's plan) plus those the
    wrappers made themselves.  -> the group-by's calls."""
    calls = [c for c in args.get("K1", [])
             if c.caller == "arrowtpu_torch.ops.groupby"]
    if not calls:
        raise AssertionError(f"{label}: the group-by made no K1 call")
    for i, c in enumerate(calls):
        want = {"K1": -(-len(c.planes) // 16), "tile_counts": 0}
        if c.offs is not None or c.launched != want:
            raise AssertionError(
                f"{label}: group-by call {i} passed offsets "
                f"{c.offs is not None} and launched {c.launched}, "
                f"expected no offsets and {want}")
    every = [c for cs in args.values() for c in cs]
    plans = {id(c.offs) for c in every if c.offs is not None}
    made = sum(c.launched["tile_counts"] for c in every)
    if tile_counts != len(plans) + made:
        raise AssertionError(
            f"{label}: {tile_counts} count-kernel launches for {len(plans)} "
            f"shared tile offsets and {made} inside the wrappers")
    return calls


def time_k1_group_calls(k1, label, calls):
    """K1 at the group-by's calls of a main-path run (group_by_calls),
    replayed on their own operands: each replay equal to the plain version
    and its profile without a count, scan or cumsum kernel; then its times,
    as time_kernel gives them, and the launches the call made on the
    path's run.  -> [row of each call]."""
    if not calls:
        raise AssertionError(f"K1 {label}: no call to time")
    rows = []
    for i, c in enumerate(calls):
        plist, keep = list(c.planes), c.keep
        rows_out = keep.shape[0] if c.out_rows is None else c.out_rows

        def fn():
            return k1.compact_planes(plist, keep, None, rows_out)

        def plain():
            return k1.compact_planes_plain(plist, keep, rows_out)

        if not all(torch.equal(a, b) for a, b in zip(fn(), plain())):
            raise AssertionError(f"K1 {label} call {i}: differs from plain")
        names = device_kernel_names(fn)
        if any(w in nm.lower() for nm in names
               for w in ("tile_counts", "scan", "cumsum")):
            raise AssertionError(f"K1 {label} call {i}: a count or scan "
                                 f"kernel runs: {names}")
        stacked = torch.stack(plist)
        row = time_kernel(f"K1 {label} call {i}", fn, plain,
                          lambda: stacked[:, keep], plist, keep, rows_out)
        del stacked
        row.update(max_abs_err=0.0, device_kernels=names,
                   launches_on_path=c.launched)
        log(f"    on the path: {c.launched}; kernels on the card: {names}")
        rows.append(row)
    return rows


def check_k3(k1, k3, dev) -> None:
    """Phase 5: K3 against its plain version and K1, two masks in a row."""
    g = torch.Generator(device=dev).manual_seed(2)
    info = torch.iinfo(torch.int32)
    for n in (65_536, N_MAIN):
        for P in (1, 2, 4, 8, 16):
            planes = torch.randint(info.min, info.max, (P, n),
                                   dtype=torch.int32, device=dev, generator=g)
            for density in (0.0, 0.02, 0.5, 0.96, 1.0):
                masks = [torch.rand(n, device=dev, generator=g) < density
                         for _ in range(2)]
                got = [k3.compact_planes(planes, keep) for keep in masks]
                for i, (out, keep) in enumerate(zip(got, masks)):
                    want = k3.compact_planes_plain(planes, keep)
                    torch.cuda.synchronize()
                    where = f"K3 P={P} n={n} density={density} call {i + 1}"
                    if not torch.equal(out, want):
                        raise AssertionError(f"{where}: differs from plain")
                    if not torch.equal(out, k1.compact_planes(planes, keep)):
                        raise AssertionError(f"{where}: differs from K1")
                    if out[:, int(keep.sum()):].any():
                        raise AssertionError(f"{where}: tail not zero")
        log(f"K3: bit-exact against plain and K1 at n={n} (5 P x 5 "
            "densities, two masks in a row each)")


def stage_ms(fn, reps=JOIN_REPS):
    return median_ms(fn, reps=reps, warmup=1)


def join_stages(left, right, group, reps=JOIN_REPS):
    """The unskewed join step's stages on one rank (CUDA-event medians):
    the key hash of both sides (the exchange's partition of each row, the
    string keys at the step's width), the exchange of both sides, build,
    probe, expand + take, the two-phase group-by.  -> (stages, row and
    round counts)."""
    from arrowtpu_torch.ops import join as jn
    from arrowtpu_torch.parallel import distributed as pd
    from arrowtpu_torch.parallel import shuffle

    widths = pd._key_widths(left, right, ["k"])
    r_ex = shuffle.exchange(right, ["k"], group, widths)
    l_ex = shuffle.exchange(left, ["k"], group, widths)
    table = jn.build_table([r_ex["k"]], widths)
    match, probe_rounds = jn.probe_table(table, [l_ex["k"]])
    joined, _ = jn.join_matches(l_ex, r_ex, ["k"], table, match)

    def hash_both():
        for b in (right, left):
            shuffle.partition_ids(b, ["k"], group.world_size, widths)

    def exchange_both():
        shuffle.exchange(right, ["k"], group, widths)
        shuffle.exchange(left, ["k"], group, widths)

    stages = {
        "hash_ms": stage_ms(hash_both, reps),
        "exchange_ms": stage_ms(exchange_both, reps),
        "build_ms": stage_ms(lambda: jn.build_table([r_ex["k"]], widths),
                             reps),
        "probe_ms": stage_ms(lambda: jn.probe_table(table, [l_ex["k"]]),
                             reps),
        "expand_take_ms": stage_ms(lambda: jn.join_matches(
            l_ex, r_ex, ["k"], table, match), reps),
        "group_by_ms": stage_ms(lambda: pd.distributed_group_by(
            joined, ["k"], JOIN_AGGS, group=group), reps),
    }
    counts = {"probe_rows": l_ex.length, "build_rows": r_ex.length,
              "join_rows": joined.length, "build_rounds": table.rounds,
              "probe_rounds": probe_rounds}
    return stages, counts


def join_phase(pe, k1, k2, k3, build, dev):
    """Phase 6: the join step at one card's share of config 5.
    -> (the launch counts of its run, K1's rows at its group-by's largest
    calls)."""
    from arrowtpu_torch.interop.numpy_bridge import batch_from_numpy
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.parallel import mesh

    t0 = time.perf_counter()
    shards = pe.example_join_shards(
        0, 1, PROBE_ROWS, BUILD_ROWS, key_range=PROBE_KEY_RANGE,
        key_nulls=0.05, rv_nulls=0.1, permute_build=True)
    want = pe.join_oracle([shards])
    left, right = (batch_from_numpy(a, device=dev) for a in shards)
    torch.cuda.synchronize()
    log(f"join: data and oracle in {time.perf_counter() - t0:.1f} s; "
        f"{PROBE_ROWS} probe x {BUILD_ROWS} build rows, world size 1, "
        "cut: 16 chips -> 1 card")
    with mesh.process_group(0, 1, dev) as group:
        args = {}
        with held_to_plain({"K1": k1, "K2": k2}, args) as calls:
            k1.launches = k2.launches = k3.launches = dk.launches = 0
            build.count_launches = 0
            out = pe.join_step(left, right, group)
            torch.cuda.synchronize()
            launches = {"K1": k1.launches, "K2": k2.launches,
                        "K3": k3.launches, "dense_agg": dk.launches,
                        "tile_counts": build.count_launches}
        if launches["K1"] <= 0 or not calls["K1"]:
            raise AssertionError("K1 was not launched by the join step")
        if launches["dense_agg"]:
            raise AssertionError("the join's int64 key took the dense engine")
        groups = pe.check_join_output([out], want)
        extraction = group_by_calls(args, launches["tile_counts"], "join")
        log(f"join: {groups} groups exact against the numpy oracle; "
            f"launches {launches}; calls held to plain (P, n, kept, "
            f"out_rows): {calls}; the group-by's {len(extraction)} K1 "
            f"calls each {[c.launched for c in extraction]}")
        # K1 at its largest calls: the extraction over the joined rows
        top = max(c.keep.shape[0] for c in extraction)
        k1_rows = time_k1_group_calls(
            k1, "join extraction",
            [c for c in extraction if c.keep.shape[0] == top])
        del args, extraction

        step_ms = median_ms(lambda: pe.join_step(left, right, group),
                            reps=JOIN_REPS, warmup=1)
        stages, counts = join_stages(left, right, group)
        counts["groups"] = groups
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pe.join_step(left, right, group)
        peak = torch.cuda.max_memory_allocated()
        log(f"join timing: step {step_ms:.3f} ms (median of {JOIN_REPS}); "
            f"stages {stages}; {counts}; peak {peak / 2**30:.2f} GiB "
            f"({base / 2**30:.2f} GiB held before the step)")
        log(f"join profile: "
            f"{profile(lambda: pe.join_step(left, right, group), reps=3)}")
    return launches, k1_rows


def skew_stages(left, right, group):
    """The skewed step's stages on one rank (CUDA-event medians): detect
    (histogram, all_reduce, both sides' hot rows; and the probe keys' hash
    alone), split (the four filters), cold join (exchange and chunked
    join of the cold rows; and in one chunk), replicate (shrink and
    all_gather of the hot build rows), hot join, concat, group-by.
    -> (stages, counts)."""
    from arrowtpu_torch.ops import join as jn
    from arrowtpu_torch.ops.concat import concat_batches
    from arrowtpu_torch.parallel import distributed as pd

    on = ["k"]

    def detect():
        hot, l_hot = pd.detect_hot_buckets(
            left, on, group=group, threshold_frac=SKEW["skew_threshold"])
        return hot, l_hot, pd._hot_rows(right, on, hot)

    def split():
        return [pd._filter_bool(b, m) for b, m in (
            (left, ~l_hot), (right, ~r_hot), (right, r_hot), (left, l_hot))]

    hot, l_hot, r_hot = detect()
    l_cold, r_cold, r_hot_b, l_hot_b = split()
    hcap = pd.default_hot_capacity(right)

    def cold_join():
        return pd.distributed_hash_join(
            l_cold, r_cold, on, group=group,
            probe_chunks=SKEW["probe_chunks"])[0]

    def replicate():
        return pd._replicate(pd._shrink(r_hot_b, hcap), group)

    cold, r_all = cold_join(), replicate()
    hot_out = jn.hash_join(l_hot_b, r_all, on)[0]
    joined = concat_batches([cold, hot_out])
    stages = {
        "detect_ms": stage_ms(detect),
        # of which the probe keys' hash (the skew buckets)
        "detect_hash_ms": stage_ms(lambda: pd._hot_buckets_of(
            left, on, pd.HOT_BUCKETS)),
        "split_ms": stage_ms(split),
        "cold_join_ms": stage_ms(cold_join),
        # the same cold rows in one probe chunk: what chunking costs
        "cold_join_one_chunk_ms": stage_ms(lambda: pd.distributed_hash_join(
            l_cold, r_cold, on, group=group)),
        "replicate_ms": stage_ms(replicate),
        "hot_join_ms": stage_ms(lambda: jn.hash_join(l_hot_b, r_all, on)),
        "concat_ms": stage_ms(lambda: concat_batches([cold, hot_out])),
        "group_by_ms": stage_ms(lambda: pd.distributed_group_by(
            joined, on, JOIN_AGGS, group=group)),
    }
    counts = {"hot_buckets": int(hot.sum()), "hot_probe_rows": l_hot_b.length,
              "hot_probe_share": l_hot_b.length / left.length,
              "hot_build_rows": r_hot_b.length, "hot_capacity": hcap,
              "replicated_rows": r_all.length, "cold_probe_rows":
              l_cold.length, "cold_join_rows": cold.length,
              "hot_join_rows": hot_out.length, "join_rows": joined.length}
    return stages, counts


def skew_phase(pe, k1, k2, k3, build, dev):
    """Phase 6b: the skewed join step at phase 6's share, probe keys Zipf
    over the key range, `join_step(..., **SKEW)`; the same data through
    the unskewed step beside it.  -> (the launch counts of its run, the
    launches its filters made)."""
    from arrowtpu_torch.interop.numpy_bridge import batch_from_numpy
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.parallel import distributed as pd
    from arrowtpu_torch.parallel import mesh

    t0 = time.perf_counter()
    shards = pe.example_join_shards(
        0, 1, PROBE_ROWS, BUILD_ROWS, key_range=PROBE_KEY_RANGE,
        key_nulls=0.05, rv_nulls=0.1, permute_build=True, zipf=SKEW_ZIPF,
        device=dev)
    want = pe.join_oracle([shards])
    left, right = (batch_from_numpy(a, device=dev) for a in shards)
    torch.cuda.synchronize()
    log(f"skewed join: data and oracle in {time.perf_counter() - t0:.1f} s; "
        f"{PROBE_ROWS} probe x {BUILD_ROWS} build rows, probe keys "
        f"Zipf({SKEW_ZIPF}) over {PROBE_KEY_RANGE}, {SKEW}, world size 1, "
        "cut: 16 chips -> 1 card")
    # the launches made inside the skew path's filters (_filter_bool)
    filters = {"calls": 0, "K1": 0, "K2": 0, "tile_counts": 0}
    filter_bool = pd._filter_bool

    def counters():
        return k1.launches, k2.launches, build.count_launches

    def counted(batch, keep):
        before = counters()
        out = filter_bool(batch, keep)
        filters["calls"] += 1
        for name, a, b in zip(("K1", "K2", "tile_counts"), before,
                              counters()):
            filters[name] += b - a
        return out

    with mesh.process_group(0, 1, dev) as group:
        args = {}
        pd._filter_bool = counted
        try:
            with held_to_plain({"K1": k1, "K2": k2}, args) as calls:
                k1.launches = k2.launches = k3.launches = dk.launches = 0
                build.count_launches = 0
                out = pe.join_step(left, right, group, **SKEW)
                torch.cuda.synchronize()
                launches = {"K1": k1.launches, "K2": k2.launches,
                            "K3": k3.launches, "dense_agg": dk.launches,
                            "tile_counts": build.count_launches}
        finally:
            pd._filter_bool = filter_bool
        if launches["dense_agg"]:
            raise AssertionError("the skewed join's int64 key took the dense "
                                 "engine")
        if filters["calls"] != 4 or filters["K1"] <= 0 or filters["K2"] <= 0:
            raise AssertionError(f"the skew path's filters launched "
                                 f"{filters}: K1 and K2 must both run")
        groups = pe.check_join_output([out], want)
        extraction = group_by_calls(args, launches["tile_counts"],
                                    "skewed join")
        log(f"skewed join: {groups} groups exact against the numpy oracle; "
            f"launches {launches}, of which its 4 filters {filters}; calls "
            f"held to plain (P, n, kept, out_rows): {calls}; the "
            f"group-by's {len(extraction)} K1 calls each "
            f"{[c.launched for c in extraction]}")
        del args, extraction, out
        joined, info = pd.distributed_hash_join(left, right, ["k"],
                                                group=group, **SKEW)
        if info.overflow:
            raise AssertionError("the hot build rows overflowed")
        del joined
        plain_groups = pe.check_join_output(
            [pe.join_step(left, right, group)], want)
        log(f"skewed data, unskewed step: {plain_groups} groups exact "
            "against the numpy oracle")

        step_ms = median_ms(lambda: pe.join_step(left, right, group, **SKEW),
                            reps=JOIN_REPS, warmup=1)
        plain_ms = median_ms(lambda: pe.join_step(left, right, group),
                             reps=JOIN_REPS, warmup=1)
        stages, counts = skew_stages(left, right, group)
        plain_stages, plain_counts = join_stages(left, right, group)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pe.join_step(left, right, group, **SKEW)
        peak = torch.cuda.max_memory_allocated()
        log(f"skewed join timing: step {step_ms:.3f} ms (median of "
            f"{JOIN_REPS}); stages {stages}; {counts}; peak "
            f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held before "
            "the step)")
        log(f"skewed data, unskewed step: {plain_ms:.3f} ms (median of "
            f"{JOIN_REPS}); stages {plain_stages}; {plain_counts}")
        log("skewed join profile: " + str(profile(
            lambda: pe.join_step(left, right, group, **SKEW), reps=3)))
    return launches, filters


def by_caller(args, build):
    """{(kernel, calling module, word bytes): calls} of held_to_plain's
    record of a run."""
    return dict(collections.Counter(
        (name, c.caller.rsplit(".", 1)[-1], build.word_bytes(c.planes[0]))
        for name, calls in args.items() for c in calls))


def check_q1_k1_calls(callers, label):
    """Q1's K1 calls (`by_caller`) must include 16-byte words in the
    filter and 16- and 8-byte words in the group-by."""
    if not all(callers.get(("K1", m, w)) for m, w in
               (("filter", 16), ("groupby", 16), ("groupby", 8))):
        raise AssertionError(f"{label}: K1 calls by module and word size "
                             f"{callers}; expected 16-byte words in the "
                             "filter and 16- and 8-byte words in the "
                             "group-by")


def text_join_phase(pe, k1, k2, k3, build, dev):
    """Phase 16: the join step at phase 6's share with k carried as TPC-H's
    c_name text on both sides and rv as a Decimal128(15, 2).  -> (the
    launch counts of its run, its timing line)."""
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.parallel import mesh

    t0 = time.perf_counter()
    shards = pe.example_join_shards(
        0, 1, PROBE_ROWS, BUILD_ROWS, key_range=PROBE_KEY_RANGE,
        key_nulls=0.05, rv_nulls=0.1, permute_build=True)
    want = pe.join_oracle([shards])
    left, right = pe.text_join_batches(shards, dev)
    del shards
    torch.cuda.synchronize()
    log(f"text join: data and oracle in {time.perf_counter() - t0:.1f} s; "
        f"{PROBE_ROWS} probe x {BUILD_ROWS} build rows, k as "
        f"'Customer#%09d' ({pe.TEXT_KEY_BYTES} bytes, in the arena) on "
        "both sides, rv as Decimal128(15, 2); world size 1, cut: 16 chips "
        "-> 1 card")
    with mesh.process_group(0, 1, dev) as group:
        args = {}
        with held_to_plain({"K1": k1, "K2": k2}, args) as calls, \
                build.launch_words() as words:
            k1.launches = k2.launches = k3.launches = dk.launches = 0
            build.count_launches = 0
            out = pe.join_step(left, right, group)
            torch.cuda.synchronize()
            launches = {"K1": k1.launches, "K2": k2.launches,
                        "K3": k3.launches, "dense_agg": dk.launches,
                        "tile_counts": build.count_launches,
                        **{f"{k}_{w}": words.count((k, w))
                           for k, w in sorted(set(words))}}
        if launches["K1"] <= 0 or not calls["K1"]:
            raise AssertionError("K1 was not launched by the text join step")
        if launches["dense_agg"]:
            raise AssertionError("the text key took the dense engine")
        groups = pe.check_text_join_output([out], want)
        extraction = group_by_calls(args, launches["tile_counts"],
                                    "text join")
        log(f"text join: {groups} groups exact against the numpy oracle; "
            f"launches {launches}; K1 / K2 calls by module and word bytes "
            f"{by_caller(args, build)}; every call held to plain (P, n, "
            f"kept, out_rows): {calls}; the group-by's {len(extraction)} "
            f"K1 calls each {[c.launched for c in extraction]}")
        del args, extraction, out
        times = run_times_ms(lambda: pe.join_step(left, right, group),
                             reps=TEXT_REPS, warmup=1)
        stages, counts = join_stages(left, right, group, reps=TEXT_REPS)
        counts["groups"] = groups
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        pe.join_step(left, right, group)
        peak = torch.cuda.max_memory_allocated()
        busy = profile(lambda: pe.join_step(left, right, group), reps=2)
    line = {"step_ms": statistics.median(times), "min_ms": times[0],
            "max_ms": times[-1], "reps": len(times), **stages, **counts,
            "peak_gib": peak / 2**30, "held_before_gib": held / 2**30,
            **busy}
    log(f"text join timing: {line}")
    return launches, line


def exchange_stages(pe, batch, group):
    """The lineitem exchange's stages (CUDA-event medians): the plan (the
    key hash, the destination sort and the split sizes' read-back), then
    each class of column through the plan: the int64, int32 and Date32
    columns, the four decimals ((n, 4) rows), the flags and the comments
    (their byte matrices), the dictionaries (their keys)."""
    from arrowtpu_torch.parallel import mesh as pm
    from arrowtpu_torch.parallel import shuffle

    norm = pm.normalize_batch(batch)
    bounds = dict(zip(norm.schema.names,
                      shuffle.shared_bounds(norm.columns)))
    plan = shuffle.build_exchange_plan(norm, ["l_orderkey"], group)
    groups = {
        "ints": ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber"],
        "dates": list(pe.LINEITEM_DATES),
        "decimals": ["l_quantity", "l_extendedprice", "l_discount", "l_tax"],
        "flags": ["l_returnflag", "l_linestatus"],
        "dictionaries": ["l_shipinstruct", "l_shipmode"],
        "comments": ["l_comment"]}

    def move(names):
        return [shuffle.exchange_column(norm[n], plan, bounds[n])
                for n in names]

    out = {"plan_ms": stage_ms(lambda: shuffle.build_exchange_plan(
        norm, ["l_orderkey"], group), EXCHANGE_REPS)}
    for label, names in groups.items():
        out[f"{label}_ms"] = stage_ms(lambda: move(names), EXCHANGE_REPS)
    return out


def lineitem_exchange_phase(pe, ops, k1, k2, build, dev, arrays, batch,
                            want):
    """Phase 17: phase 13's SF10 lineitem through `exchange(batch,
    ["l_orderkey"])` at world size 1 (it must come back row for row, bit
    for bit), then TPC-H Q1 as a distributed query on the exchanged batch
    (`entry.q1_distributed_step`), its sums and count_order held to
    q1_oracle (`want`, phase 15's).  -> ({path: launches}, its timing
    line)."""
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.parallel import mesh

    with mesh.process_group(0, 1, dev) as group:
        args = {}
        with held_to_plain({"K1": k1, "K2": k2}, args):
            k1.launches = k2.launches = dk.launches = 0
            build.count_launches = 0
            ex = pe.lineitem_exchange(batch, group)
            torch.cuda.synchronize()
            ex_launches = {"K1": k1.launches, "K2": k2.launches,
                           "dense_agg": dk.launches,
                           "tile_counts": build.count_launches}
        rows = pe.check_same_rows(ex, batch)
        log(f"lineitem exchange: {rows} rows x {len(batch.columns)} "
            "columns back row for row, bit for bit (values, decimal limbs, "
            "dates, string bytes, lengths and len_bound, dictionary keys "
            f"and the same dictionary); launches {ex_launches}")
        args = {}
        with held_to_plain({"K1": k1, "K2": k2}, args) as calls, \
                build.launch_words() as words:
            k1.launches = k2.launches = dk.launches = 0
            build.count_launches = 0
            out = pe.q1_distributed_step(ex, group)
            torch.cuda.synchronize()
            q1_launches = {"K1": k1.launches, "K2": k2.launches,
                           "dense_agg": dk.launches,
                           "tile_counts": build.count_launches,
                           **{f"{k}_{w}": words.count((k, w))
                              for k, w in sorted(set(words))}}
        counted = pe.check_q1(out, arrays, want, pe.Q1_DISTRIBUTED_AGGS)
        callers = by_caller(args, build)
        check_q1_k1_calls(callers, "distributed Q1")
        extraction = group_by_calls(args, q1_launches["tile_counts"],
                                    "distributed Q1")
        log(f"distributed Q1 on the exchanged lineitem: exact against "
            f"q1_oracle's sums and counts ({counted} rows in "
            f"{out.length} groups); launches {q1_launches}; K1 / K2 calls "
            f"by module and word bytes {callers}; every call held to plain "
            f"(P, n, kept, out_rows): {calls}; the group-by's "
            f"{len(extraction)} K1 calls each "
            f"{[c.launched for c in extraction]}")
        del args, extraction, out
        ex_times = run_times_ms(lambda: pe.lineitem_exchange(batch, group),
                                reps=EXCHANGE_REPS, warmup=1)
        stages = exchange_stages(pe, batch, group)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        pe.lineitem_exchange(batch, group)
        ex_peak = torch.cuda.max_memory_allocated()
        ex_busy = profile(lambda: pe.lineitem_exchange(batch, group), reps=2)
        q1_times = run_times_ms(lambda: pe.q1_distributed_step(ex, group),
                                reps=EXCHANGE_REPS, warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        q1_held = torch.cuda.memory_allocated()
        pe.q1_distributed_step(ex, group)
        q1_peak = torch.cuda.max_memory_allocated()
        q1_busy = profile(lambda: pe.q1_distributed_step(ex, group), reps=2)
    line = {"exchange_ms": statistics.median(ex_times),
            "exchange_min_ms": ex_times[0], "exchange_max_ms": ex_times[-1],
            "reps": len(ex_times), "rows": rows,
            "exchange_stages": stages,
            "exchange_peak_gib": ex_peak / 2**30,
            "exchange_held_before_gib": held / 2**30,
            "exchange_busy": ex_busy,
            "q1_ms": statistics.median(q1_times), "q1_min_ms": q1_times[0],
            "q1_max_ms": q1_times[-1], "q1_peak_gib": q1_peak / 2**30,
            "q1_held_before_gib": q1_held / 2**30, "q1_busy": q1_busy}
    log(f"lineitem exchange and distributed Q1 timing: {line}")
    return {"lineitem exchange": ex_launches,
            "distributed TPC-H Q1": q1_launches}, line


# phases 18-19: TPC-H part, the LIKE family, Q14 and Q19
PART_SF = 10  # 2,000,000 parts, beside phase 13's SF10 lineitem
LIKE_REPS = 10
QUERY_REPS = 5
# TPC-H's own patterns: (label, column, op, pattern, the host test of a
# string as numpy bytes)
LIKE_LINES = [
    ("Q2 p_type LIKE '%BRASS'", "p_type", "like", "%BRASS",
     lambda s: np.strings.endswith(s, b"BRASS")),
    ("Q9 p_name LIKE '%green%'", "p_name", "like", "%green%",
     lambda s: np.strings.find(s, b"green") >= 0),
    ("Q16 p_type NOT LIKE 'MEDIUM POLISHED%'", "p_type", "nlike",
     "MEDIUM POLISHED%",
     lambda s: ~np.strings.startswith(s, b"MEDIUM POLISHED")),
    ("Q20 p_name LIKE 'forest%'", "p_name", "like", "forest%",
     lambda s: np.strings.startswith(s, b"forest")),
    ("Q19 p_brand = 'Brand#12'", "p_brand", "like", "Brand#12",
     lambda s: s == b"Brand#12"),
    ("p_type ILIKE 'promo%'", "p_type", "ilike", "promo%",
     lambda s: np.strings.startswith(np.strings.lower(s), b"promo"))]


def host_strings(pe, arrays, name):
    """A part string column as a numpy bytes array (S<longest>), built
    from its bytes, starts and lengths on the host."""
    buf, starts, lens = pe.part_strings(arrays, name)
    width = int(lens.max())
    idx = starts[:, None] + np.arange(width)
    raw = np.where(np.arange(width) < lens[:, None],
                   buf[np.minimum(idx, len(buf) - 1)], 0).astype(np.uint8)
    return raw.view(f"S{width}").ravel()


def like_matrix_bytes(c, op, pattern):
    """-> (the bytes of the byte matrix a LIKE line builds, its kind)."""
    from arrowtpu_torch.ops import strings as ps

    compiled = ps.compile_like(pattern.lower() if op == "ilike"
                               else pattern)
    return c.capacity * ps.like_width(c, compiled), compiled.kind


def part_like_phase(pe, ops, dev):
    """Phase 18: TPC-H part at SF10 built on the card, then the LIKE
    family over it with TPC-H's patterns, each count exact against numpy
    on the host strings, timed (CUDA events, median).  -> (the part arrays
    and batch, the lines)."""
    t0 = time.perf_counter()
    arrays = pe.example_part_arrays(PART_SF)
    t_gen = time.perf_counter() - t0
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    part = pe.part_batch(arrays, dev)
    torch.cuda.synchronize()
    part_gib = (torch.cuda.memory_allocated() - held) / 2**30
    log(f"part at SF{PART_SF}: {part.length} rows drawn in {t_gen:.1f} s, "
        f"{part_gib:.3f} GiB on the card; len_bound p_name "
        f"{part['p_name'].len_bound}, p_type {part['p_type'].len_bound}")
    hosts, lines = {}, []
    for label, name, op, pattern, host_test in LIKE_LINES:
        if name not in hosts:
            hosts[name] = host_strings(pe, arrays, name)
        c = part[name]
        got = getattr(ops, op)(c, pattern)
        count = int(got.values_bool()[:got.length].sum())
        want = int(host_test(hosts[name]).sum())
        if count != want or got.validity is not None:
            raise AssertionError(f"{label}: {count} rows, numpy {want}")
        nbytes, kind = like_matrix_bytes(c, op, pattern)
        times = run_times_ms(lambda: getattr(ops, op)(c, pattern),
                             reps=LIKE_REPS, warmup=2)
        line = {"line": label, "kind": kind, "count": count,
                "ms": statistics.median(times), "min_ms": times[0],
                "max_ms": times[-1], "matrix_bytes": nbytes}
        log(f"LIKE: {line}")
        lines.append(line)
    return arrays, part, lines


def q14_stages(pe, ops, batch, part):
    """Q14's stages, each timed alone (CUDA events, median)."""
    from arrowtpu_torch.core import batch as bt

    sub = bt.record_batch({n: batch[n] for n in pe.Q14_READS})
    mask = pe.q14_predicate(batch)
    kept = ops.filter_record_batch(sub, mask)
    right = bt.record_batch({n: part[n] for n in ("p_partkey", "p_type")})
    joined, _ = ops.hash_join(kept, right, ["l_partkey"],
                              right_on=["p_partkey"])
    promo_mask = ops.like(joined["p_type"], "PROMO%")
    price = pe._disc_price(joined)
    promo = ops.zip_(promo_mask, price, 0)
    reps = dict(reps=QUERY_REPS, warmup=2)
    return {
        "predicate_ms": median_ms(lambda: pe.q14_predicate(batch), **reps),
        "filter_ms": median_ms(lambda: ops.filter_record_batch(sub, mask),
                               **reps),
        "join_ms": median_ms(lambda: ops.hash_join(
            kept, right, ["l_partkey"], right_on=["p_partkey"]), **reps),
        "like_ms": median_ms(lambda: ops.like(joined["p_type"], "PROMO%"),
                             **reps),
        "prices_ms": median_ms(lambda: pe._disc_price(joined), **reps),
        "zip_ms": median_ms(lambda: ops.zip_(promo_mask, price, 0), **reps),
        "sums_ms": median_ms(lambda: (pe._sum_decimal(promo),
                                      pe._sum_decimal(price)), **reps),
        "kept": kept.length, "joined": joined.length}


def q19_stages(pe, ops, batch, part):
    """Q19's stages, each timed alone (CUDA events, median)."""
    from arrowtpu_torch.core import batch as bt

    lsub = bt.record_batch({n: batch[n] for n in pe.Q19_LINEITEM})
    psub = bt.record_batch({n: part[n] for n in pe.Q19_PART})
    lmask, pmask = pe.q19_lineitem_predicate(batch), pe.q19_part_predicate(
        part)
    li = ops.filter_record_batch(lsub, lmask)
    pa = ops.filter_record_batch(psub, pmask)
    joined, _ = ops.hash_join(li, pa, ["l_partkey"], right_on=["p_partkey"])
    jmask = pe.q19_joined_predicate(joined)
    kept = ops.filter_record_batch(joined, jmask)
    reps = dict(reps=QUERY_REPS, warmup=2)
    return {
        "lineitem_predicate_ms": median_ms(
            lambda: pe.q19_lineitem_predicate(batch), **reps),
        "part_predicate_ms": median_ms(
            lambda: pe.q19_part_predicate(part), **reps),
        "filters_ms": median_ms(lambda: (
            ops.filter_record_batch(lsub, lmask),
            ops.filter_record_batch(psub, pmask)), **reps),
        "join_ms": median_ms(lambda: ops.hash_join(
            li, pa, ["l_partkey"], right_on=["p_partkey"]), **reps),
        "joined_predicate_ms": median_ms(
            lambda: pe.q19_joined_predicate(joined), **reps),
        "joined_filter_ms": median_ms(
            lambda: ops.filter_record_batch(joined, jmask), **reps),
        "prices_and_sum_ms": median_ms(
            lambda: pe._sum_decimal(pe._disc_price(kept)), **reps),
        "lineitem_kept": li.length, "parts_kept": pa.length,
        "joined": joined.length, "kept": kept.length}


def query_phase(pe, ops, k1, k2, build, dev, arrays, batch, part_arrays,
                part):
    """Phase 19: TPC-H Q14 and Q19 over phase 13's SF10 lineitem and phase
    18's part, each exact against its oracle, the launch counts set to 0
    just before the step and read just after (K1 must launch in the
    lineitem filter), every K1 and K2 call held to its plain version,
    then the step's time, stages, peak memory and busy share.  -> ({path:
    launches}, {query: timing line})."""
    from arrowtpu_torch.kernels import dense_agg as dk

    runs = {"Q14": (pe.q14_step, pe.q14_oracle, q14_stages),
            "Q19": (pe.q19_step, pe.q19_oracle, q19_stages)}
    launches, timing = {}, {}
    for name, (step, oracle_fn, stages_fn) in runs.items():
        t0 = time.perf_counter()
        want = oracle_fn(arrays, part_arrays)
        t_oracle = time.perf_counter() - t0
        args = {}
        with held_to_plain({"K1": k1, "K2": k2}, args) as calls, \
                build.launch_words() as words:
            k1.launches = k2.launches = dk.launches = 0
            build.count_launches = 0
            got = step(batch, part)
            torch.cuda.synchronize()
            run = {"K1": k1.launches, "K2": k2.launches,
                   "dense_agg": dk.launches,
                   "tile_counts": build.count_launches,
                   **{f"{k}_{w}": words.count((k, w))
                      for k, w in sorted(set(words))}}
        pe.check_query(got, want, name)
        callers = by_caller(args, build)
        in_filter = [c for c in args.get("K1", [])
                     if c.caller == "arrowtpu_torch.ops.filter"
                     and c.keep.shape[0] == batch.capacity]
        if not in_filter or run["K1"] <= 0:
            raise AssertionError(f"{name}: K1 did not launch in the "
                                 f"lineitem filter ({callers})")
        log(f"{name}: exact against its oracle ({t_oracle:.1f} s on the "
            f"host): {got}; launches {run}; K1 / K2 calls by module and "
            f"word bytes {callers}; every call held to plain (P, n, kept, "
            f"out_rows): {calls}")
        del args, in_filter
        stages = stages_fn(pe, ops, batch, part)
        times = run_times_ms(lambda: step(batch, part), reps=QUERY_REPS,
                             warmup=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        step(batch, part)
        peak = torch.cuda.max_memory_allocated()
        busy = profile(lambda: step(batch, part), reps=3)
        line = {"step_ms": statistics.median(times), "min_ms": times[0],
                "max_ms": times[-1], "reps": len(times), **stages,
                "result": {k: str(v) for k, v in got.items()},
                "peak_gib": peak / 2**30, "held_before_gib": held / 2**30,
                "step_adds_gib": (peak - held) / 2**30, **busy}
        log(f"{name} timing: {line}")
        launches[f"TPC-H {name}"] = run
        timing[name] = line
    log(f"Q14 promo revenue: {timing['Q14']['result']['promo_revenue']} % "
        "(p_type uniform over 150 types: about 1/6 of the revenue)")
    return launches, timing


RUNS = 8  # phase 20: the external sort's runs
LEXSORT_CHECK = 1_000_000  # rows of phase 20's host key held to np.lexsort
SORT_REPS = 3
SORT_BY = ["l_shipdate", "l_extendedprice", "l_orderkey", "l_linenumber"]
ROW_COLUMNS = ["l_returnflag", "l_linestatus", "l_shipdate",
               "l_extendedprice", "l_shipmode", "l_comment"]


def _sort_options():
    from arrowtpu_torch.config import SortOptions

    return [SortOptions(), SortOptions(descending=True), SortOptions(),
            SortOptions()]


def _packed_order(date, price) -> np.ndarray:
    """The rows' order by (date, price desc, row): one numpy sort of the
    three packed into an int64 (the row index makes the key unique, so an
    unstable sort gives the stable order)."""
    n = len(date)
    date = date.astype(np.int64) - int(date.min())
    price = int(price.max()) - price.astype(np.int64)
    pb, rb = int(price.max()).bit_length(), max(n - 1, 1).bit_length()
    if int(date.max()).bit_length() + pb + rb > 63:
        raise AssertionError("the sort key does not fit 63 bits")
    packed = (date << (pb + rb)) | (price << rb) | np.arange(n)
    packed.sort()
    return packed & ((1 << rb) - 1)


def lexsorted_keys(arrays) -> dict:
    """The key columns of the arrays in numpy's lexsort order.  The arrays
    come in (l_orderkey, l_linenumber) order (checked), so a stable
    lexsort by (l_shipdate, -l_extendedprice) orders them by the whole
    key.  np.lexsort's two stable argsorts take ~40 s at 60M rows; one
    numpy sort of the packed key gives the same order in a few seconds,
    and is held to np.lexsort on the first LEXSORT_CHECK rows."""
    okey, line = arrays["l_orderkey"], arrays["l_linenumber"]
    dk, dl = np.diff(okey), np.diff(line)
    if not np.all((dk > 0) | ((dk == 0) & (dl > 0))):
        raise AssertionError("lineitem rows are not in key order")
    date, price = arrays["l_shipdate"], arrays["l_extendedprice"]
    m = LEXSORT_CHECK
    if not np.array_equal(_packed_order(date[:m], price[:m]),
                          np.lexsort((-price[:m], date[:m]))):
        raise AssertionError("the packed sort differs from np.lexsort")
    order = _packed_order(date, price)
    return {name: arrays[name][order] for name in SORT_BY}


def check_sorted_keys(want: dict, merged) -> None:
    """The merged batch's key columns against `lexsorted_keys`, row for
    row."""
    n = merged.length
    price = merged["l_extendedprice"].values[:n, :2].contiguous().view(
        torch.int64).reshape(-1)
    got = {"l_shipdate": merged["l_shipdate"].values[:n],
           "l_extendedprice": price,
           "l_orderkey": merged["l_orderkey"].values[:n],
           "l_linenumber": merged["l_linenumber"].values[:n]}
    if merged["l_extendedprice"].values[:n, 2:].any():
        raise AssertionError("an extended price has high limbs")
    for name, values in got.items():
        if not np.array_equal(values.cpu().numpy(), want[name]):
            raise AssertionError(f"external sort: {name} differs from "
                                 "numpy's lexsort")


def external_sort_phase(pe, ops, k1, k2, build, dev, arrays, batch):
    """Phase 20: phase 13's lineitem less its two dictionary columns
    sorted as RUNS runs and merged (`entry.sorted_runs_step`), equal by
    `equal_batches` on the card to one `sort_batch` of the whole and, on
    its key columns, to numpy's lexsort of the arrays (`lexsorted_keys`);
    then the RowConverter round trip of ROW_COLUMNS over the whole table,
    each column equal by `equal_columns` on the card.  The path runs no
    kernel of the port: the counts are read around it, and any K1 or K2
    call in it would be held to plain.  The stages are timed (CUDA events,
    median of SORT_REPS).  -> ({"K1": .., "K2": ..}, timing line)."""
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.rowformat.decode import RowConverter
    from arrowtpu_torch.config import SortOptions

    t0 = time.perf_counter()
    names = [f.name for f in batch.schema.fields
             if f.name not in ("l_shipinstruct", "l_shipmode")]
    table = bt.record_batch({n: batch[n] for n in names})
    opts = _sort_options()
    with held_to_plain({"K1": k1, "K2": k2}) as calls:
        k1.launches = k2.launches = 0
        build.count_launches = 0
        merged, stages = pe.sorted_runs_step(table, SORT_BY, opts, RUNS)
        torch.cuda.synchronize()
        launches = {"K1": k1.launches, "K2": k2.launches,
                    "tile_counts": build.count_launches}
    whole = ops.sort_batch(table, SORT_BY, opts)
    if not bool(ops.equal_batches(merged, whole)):
        raise AssertionError("external sort: the merge differs from one "
                             "sort_batch of the whole")
    del whole
    t1 = time.perf_counter()
    check_sorted_keys(lexsorted_keys(arrays), merged)
    t_host = time.perf_counter() - t1
    n = merged.length
    del merged
    slices, ordered = stages["slices"], stages["sorted"]
    reps = dict(reps=SORT_REPS, warmup=1)
    timing = {
        "rows": table.length, "columns": len(names), "runs": RUNS,
        "slice_ms": median_ms(lambda: [ops.slice_batch(
            table, i * slices[0].length, slices[0].length)
            for i in range(RUNS)], **reps),
        "run_sorts_ms": median_ms(lambda: [ops.sort_batch(r, SORT_BY, opts)
                                           for r in slices], **reps)}
    del slices, stages
    keys = [[r[n] for n in SORT_BY] for r in ordered]
    timing["merge_indices_ms"] = median_ms(
        lambda: ops.merge_indices(keys, opts), **reps)
    src, row = ops.merge_indices(keys, opts)
    classes = {"int64": "l_orderkey", "int32": "l_linenumber",
               "date32": "l_shipdate", "decimal128": "l_extendedprice",
               "utf8 flag": "l_returnflag", "utf8 comment": "l_comment"}
    timing["interleave_ms"] = {
        label: median_ms(lambda: ops.interleave(
            [r[name] for r in ordered], src, row), **reps)
        for label, name in classes.items()}
    timing["concat_batches_ms"] = median_ms(
        lambda: ops.concat_batches(ordered), **reps)
    timing["merge_batches_ms"] = median_ms(
        lambda: ops.merge_batches(ordered, SORT_BY, opts), **reps)
    del keys, src, row
    timing["step_ms"] = median_ms(lambda: pe.sorted_runs_step(
        table, SORT_BY, opts, RUNS), **reps)
    timing["whole_sort_batch_ms"] = median_ms(
        lambda: ops.sort_batch(table, SORT_BY, opts), **reps)
    del ordered
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pe.sorted_runs_step(table, SORT_BY, opts, RUNS)
    torch.cuda.synchronize()
    timing.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  held_before_gib=held / 2**30)
    timing.update(profile(lambda: pe.sorted_runs_step(table, SORT_BY, opts,
                                                      RUNS), reps=1))

    # the RowConverter round trip over the whole table
    cols = [batch[n] for n in ROW_COLUMNS]
    rc = RowConverter([SortOptions(descending=n == "l_shipdate")
                       for n in ROW_COLUMNS])
    planes = rc.convert_columns(cols)
    back = rc.convert_rows(planes, batch.length)
    for name, a, b in zip(ROW_COLUMNS, cols, back):
        if not bool(ops.equal_columns(a, b)):
            raise AssertionError(f"RowConverter: {name} does not come back")
    timing["row_planes"] = len(planes)
    timing["row_planes_gib"] = sum(p.nbytes for p in planes) / 2**30
    del back
    timing["convert_columns_ms"] = median_ms(
        lambda: rc.convert_columns(cols), **reps)
    timing["convert_rows_ms"] = median_ms(
        lambda: rc.convert_rows(planes, batch.length), **reps)
    del planes
    torch.cuda.empty_cache()
    log(f"RowConverter round trip of {ROW_COLUMNS} over {batch.length} rows:"
        f" every column back (equal_columns on the card)")
    log(f"external sort: {n} rows x {len(names)} columns in {RUNS} runs, "
        f"equal to one sort_batch (equal_batches on the card) and, on its "
        f"keys, to numpy's lexsort ({t_host:.1f} s on the host); launches "
        f"{launches}, K1 / K2 calls held to plain {calls} (its path runs no "
        "kernel of the port)")
    log(f"external sort timing ({time.perf_counter() - t0:.1f} s with the "
        f"checks): {timing}")
    return launches, timing


Q3_SF = 10


def q3_stages(pe, ops, customer, orders, lineitem):
    """Q3's stages, each timed alone (CUDA events, median), and the
    group-by's encode and sort."""
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.rowformat import encode as rf
    from arrowtpu_torch.rowformat import pack as rp

    cust, ords, li = pe.q3_filters(customer, orders, lineitem)
    co, _ = ops.hash_join(ords, cust, ["o_custkey"], right_on=["c_custkey"])
    joined = pe.q3_joins(cust, ords, li)
    grouped = pe.q3_group(joined)
    keys = [joined[k] for k in pe.Q3_KEYS]
    planes = rf.encode_columns(keys)
    reps = dict(reps=QUERY_REPS, warmup=2)
    day = pe._days(pe.Q3_DATE)
    out = {
        "customer_filter_ms": median_ms(lambda: ops.filter_record_batch(
            bt.record_batch({"c_custkey": customer["c_custkey"]}),
            ops.like(customer["c_mktsegment"], pe.Q3_SEGMENT)), **reps),
        "orders_filter_ms": median_ms(lambda: ops.filter_record_batch(
            bt.record_batch({n: orders[n] for n in pe.Q3_ORDERS}),
            ops.lt(orders["o_orderdate"], day)), **reps),
        "lineitem_filter_ms": median_ms(lambda: ops.filter_record_batch(
            bt.record_batch({n: lineitem[n] for n in pe.Q3_LINEITEM}),
            ops.gt(lineitem["l_shipdate"], day)), **reps),
        "customer_orders_join_ms": median_ms(lambda: ops.hash_join(
            ords, cust, ["o_custkey"], right_on=["c_custkey"]), **reps),
        "lineitem_join_ms": median_ms(lambda: ops.hash_join(
            li, co, ["l_orderkey"], right_on=["o_orderkey"]), **reps),
        "revenue_ms": median_ms(lambda: pe._disc_price(joined), **reps),
        "group_by_ms": median_ms(lambda: pe.q3_group(joined), **reps),
        "group_by_encode_ms": median_ms(lambda: rf.encode_columns(keys),
                                        **reps),
        "group_by_sort_ms": median_ms(lambda: rp.sort_permutation(
            planes, joined.capacity, joined.length), **reps),
        "top10_ms": median_ms(lambda: pe.q3_top(grouped), **reps),
        "customers_kept": cust.length, "orders_kept": ords.length,
        "lineitem_kept": li.length, "customer_orders": co.length,
        "joined": joined.length, "groups": grouped.length}
    return out


def q3_phase(pe, ops, k1, k2, build, dev, arrays, batch):
    """Phase 21: TPC-H Q3 at SF10 over phase 13's lineitem and new SF10
    orders and customer tables built on the card, exact against
    `entry.q3_oracle`; the launch counts set to 0 just before the step and
    read just after (K1 must launch in the filters), counted by calling
    module and word size, every K1 and K2 call held to plain; then the
    step's time, stages, peak memory and busy share.  -> (launches,
    timing line)."""
    from arrowtpu_torch.kernels import dense_agg as dk

    t0 = time.perf_counter()
    orders_arrays = pe.example_orders_arrays(Q3_SF, lineitem=arrays)
    customer_arrays = pe.example_customer_arrays(Q3_SF)
    orders = pe.orders_batch(orders_arrays, dev)
    customer = pe.customer_batch(customer_arrays, dev)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = pe.q3_oracle(customer_arrays, orders_arrays, arrays)
    t_oracle = time.perf_counter() - t0
    del orders_arrays, customer_arrays
    args = {}
    with held_to_plain({"K1": k1, "K2": k2}, args) as calls, \
            build.launch_words() as words:
        k1.launches = k2.launches = dk.launches = 0
        build.count_launches = 0
        got = pe.q3_step(customer, orders, batch)
        torch.cuda.synchronize()
        run = {"K1": k1.launches, "K2": k2.launches, "dense_agg": dk.launches,
               "tile_counts": build.count_launches,
               **{f"{k}_{w}": words.count((k, w))
                  for k, w in sorted(set(words))}}
    result = pe.check_q3(got, want)
    callers = by_caller(args, build)
    in_filter = [c for c in args.get("K1", [])
                 if c.caller == "arrowtpu_torch.ops.filter"]
    if not in_filter or run["K1"] <= 0:
        raise AssertionError(f"Q3: K1 did not launch in the filters "
                             f"({callers})")
    log(f"Q3: orders {orders.length} and customer {customer.length} rows "
        f"built on the card in {t_data:.1f} s; exact against its oracle "
        f"({t_oracle:.1f} s on the host): {result}; launches {run}; K1 / K2 "
        f"calls by module and word bytes {callers}; every call held to "
        f"plain (P, n, kept, out_rows): {calls}")
    del args, in_filter
    stages = q3_stages(pe, ops, customer, orders, batch)
    times = run_times_ms(lambda: pe.q3_step(customer, orders, batch),
                         reps=QUERY_REPS, warmup=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pe.q3_step(customer, orders, batch)
    peak = torch.cuda.max_memory_allocated()
    busy = profile(lambda: pe.q3_step(customer, orders, batch), reps=3)
    line = {"step_ms": statistics.median(times), "min_ms": times[0],
            "max_ms": times[-1], "reps": len(times), **stages,
            "groups": result["groups"], "top": result["rows"][:3],
            "peak_gib": peak / 2**30, "held_before_gib": held / 2**30,
            "step_adds_gib": (peak - held) / 2**30, **busy}
    log(f"Q3 timing: {line}")
    return {"TPC-H Q3": run}, line


# ---------------------------------------------------------------------------
# phase 24: lineitem through an Arrow IPC file, validated on the card
# ---------------------------------------------------------------------------

IPC_BATCH_ROWS = 1 << 20  # 1,048,576 rows a record batch: 58 at SF10
IPC_LZ4_ROWS = 65_536  # the lz4 round trip: the frame decoder is Python
IPC_REPS = 3


def host_s(fn):
    """-> (fn()'s result, its seconds on the host's clock, the card
    synchronized before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _corrupted_read_raises(pe, ps, buf, flag):
    """read_lineitem_ipc(validate=True) of the patched bytes must raise
    ValidationError naming `flag`; -> its seconds."""
    t0 = time.perf_counter()
    try:
        pe.read_lineitem_ipc(buf, validate=True)
    except ps.ValidationError as e:
        if flag not in str(e):
            raise AssertionError(f"IPC: {flag} expected, got {e}") from e
        return time.perf_counter() - t0
    raise AssertionError(f"IPC: the corrupted bytes read with validate=True "
                         f"raised nothing ({flag} expected)")


def _ipc_spans():
    """`tests/ipc_spans.py`, which finds each column's buffers in IPC
    bytes (the corruptions below patch them)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "ipc_spans.py")
    spec = importlib.util.spec_from_file_location("ipc_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ipc_phase(pe, ops, k1, k2, build, dev, arrays, batch):
    """Phase 24: phase 13's SF10 lineitem written as an IPC file and as a
    stream of 1,048,576-row record batches into host memory, read back
    onto the card with validate=True (the UTF-8 check over every
    l_comment, the key bounds of both dictionaries) and concatenated:
    held row for row to the batch written (dictionaries by value); Q6 on
    it exact against `entry.q6_oracle`, the launch counts set to 0 just
    before and read just after (K1 at 16, 8 and 4 bytes), every K1 call
    held to plain; two batches by the file's footer against
    `slice_batch`; the stream read the same; a 0xFF byte in an l_comment,
    an l_shipmode key of 7 and an l_comment offset past the data must
    raise ValidationError naming their flags (the first bytes read
    without validate must not; the bad offset's batch read without
    validate must fail the full check on its views); an lz4 round trip
    of the first 65,536 rows.  Times: writes, reads, validate (the UTF-8
    check apart), Q6 on the read batch, GB/s over the file's bytes, peak
    memory.  -> (launches, timing line)."""
    from arrowtpu_torch import schema as ps
    from arrowtpu_torch.core import validate
    from arrowtpu_torch.formats import ipc
    from arrowtpu_torch.ops.coalesce import slice_batch

    n = batch.length
    line = {"rows": n, "batch_rows": IPC_BATCH_ROWS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    written = {}
    for kind in ("file", "stream"):
        # the writer's pieces (buffers read to the host, framing), then
        # one copy into a writable buffer (the stream is patched below)
        pieces = ipc.Pieces()
        _, s = host_s(lambda: pe.lineitem_ipc(
            batch, IPC_BATCH_ROWS, stream=kind == "stream", sink=pieces))
        line[f"write_{kind}_ms"] = s * 1e3
        written[kind], s = host_s(lambda: bytearray().join(pieces))
        line[f"join_{kind}_ms"] = s * 1e3
        del pieces
    data, stream = written["file"], written["stream"]
    del written
    nbatches = -(-n // IPC_BATCH_ROWS)
    line.update(file_bytes=len(data), stream_bytes=len(stream),
                record_batches=nbatches)
    log(f"IPC: lineitem written as a file of {len(data)} bytes and a "
        f"stream of {len(stream)} bytes, {nbatches} record batches")

    got, s = host_s(lambda: pe.read_lineitem_ipc(data, validate=True))
    line["read_validated_ms"] = s * 1e3
    line["read_validated_gb_per_s"] = len(data) / s / 1e9
    pe.check_same_rows(got, batch, same_dictionary=False)
    want = pe.q6_oracle(arrays)
    args = {}
    with held_to_plain({"K1": k1}, args) as calls, \
            build.launch_words() as words:
        k1.launches = k2.launches = 0
        build.count_launches = 0
        out = pe.q6_step(got)
        torch.cuda.synchronize()
        run = {"K1": k1.launches, "K2": k2.launches,
               "tile_counts": build.count_launches,
               **{f"{k}_{w}": words.count((k, w))
                  for k, w in sorted(set(words))}}
    if not all(run.get(f"K1_{w}", 0) >= 1 for w in (16, 8, 4)):
        raise AssertionError(f"IPC Q6: K1 launches by word size {run}, "
                             "expected 16-, 8- and 4-byte words")
    kept = pe.check_q6(out, arrays, want)
    del out, args
    line["q6_ms"] = median_ms(lambda: pe.q6_step(got), reps=IPC_REPS,
                              warmup=1)
    line["q6_kept"] = kept
    log(f"IPC: the file read with validate=True holds the batch's rows "
        f"(check_same_rows, dictionaries by value); Q6 on it exact against "
        f"q6_oracle, {kept} rows kept; launches {run}; every K1 call held "
        f"to plain: {calls['K1']}")
    # the checks alone, on the read table (its UTF-8 check in chunks),
    # and the UTF-8 check of l_comment apart
    _, s = host_s(lambda: validate.check_batch(got))
    line["validate_ms"] = s * 1e3
    c = got["l_comment"]
    _, s = host_s(lambda: bool(validate.utf8_invalid_rows(
        c, c.valid_bool()).any()))
    line["utf8_check_ms"] = s * 1e3
    del got, c
    torch.cuda.empty_cache()

    reader = ipc.FileReader(data)
    for k in (1, nbatches - 1):
        pe.check_same_rows(reader.get_batch(k), slice_batch(
            batch, k * IPC_BATCH_ROWS, IPC_BATCH_ROWS),
            same_dictionary=False)
    del reader
    got, s = host_s(lambda: pe.read_lineitem_ipc(stream, validate=True))
    line["read_stream_validated_ms"] = s * 1e3
    pe.check_same_rows(got, batch, same_dictionary=False)
    del got
    torch.cuda.empty_cache()
    log(f"IPC: batches 1 and {nbatches - 1} by the footer equal slice_batch; "
        f"the stream read with validate=True holds the same rows")

    spans = _ipc_spans().batch_buffers(stream)
    off = spans[0]["l_comment"][2][0] + 7
    saved = stream[off]
    stream[off] = 0xFF
    line["bad_utf8_raise_ms"] = _corrupted_read_raises(
        pe, ps, stream, "l_comment.invalid_utf8") * 1e3
    # the same bytes without validate: the read alone (parse, host to
    # card, concatenation)
    unchecked, s = host_s(lambda: pe.read_lineitem_ipc(stream,
                                                       validate=False))
    line["read_stream_ms"] = s * 1e3
    if unchecked.length != n:
        raise AssertionError("IPC: the corrupted bytes did not read")
    del unchecked
    stream[off] = saved
    off = spans[0]["l_shipmode"][1][0]
    saved = bytes(stream[off:off + 4])
    stream[off:off + 4] = np.int32(len(pe.SHIPMODE)).tobytes()
    line["bad_key_raise_ms"] = _corrupted_read_raises(
        pe, ps, stream, "l_shipmode.dict_key_out_of_bounds") * 1e3
    stream[off:off + 4] = saved
    # an l_comment offset past the data: the offsets decrease after it,
    # flagged on the host before a view is built
    off = spans[0]["l_comment"][1][0] + 4 * 1000
    saved = bytes(stream[off:off + 4])
    stream[off:off + 4] = np.int32(1 << 30).tobytes()
    line["bad_offset_raise_ms"] = _corrupted_read_raises(
        pe, ps, stream, "l_comment.offsets_decreasing") * 1e3
    # its batch read without validate: the full check (UTF-8 included)
    # flags the views those offsets give, and reads no byte past the data
    first = next(ipc.StreamReader(stream, dev))
    try:
        validate.check_batch(first)
    except ps.ValidationError as e:
        if "l_comment.view_out_of_bounds, l_comment.negative_length" \
                not in str(e):
            raise AssertionError(f"IPC: bad views expected, got {e}") from e
    else:
        raise AssertionError("IPC: the views of a bad offset were not "
                             "flagged")
    del first
    stream[off:off + 4] = saved
    torch.cuda.synchronize()
    log("IPC: a 0xFF byte in an l_comment raised l_comment.invalid_utf8 "
        "(and read without validate), an l_shipmode key of 7 raised "
        "l_shipmode.dict_key_out_of_bounds, an l_comment offset of 2**30 "
        "raised l_comment.offsets_decreasing (and, read without validate, "
        "the full check flagged view_out_of_bounds and negative_length)")
    torch.cuda.empty_cache()

    head = slice_batch(batch, 0, IPC_LZ4_ROWS)
    packed, s = host_s(lambda: pe.lineitem_ipc(head, IPC_LZ4_ROWS,
                                               compression="lz4"))
    line["lz4_write_ms"] = s * 1e3
    back, s = host_s(lambda: pe.read_lineitem_ipc(packed))
    line["lz4_read_ms"] = s * 1e3
    pe.check_same_rows(back, head, same_dictionary=False)
    line["lz4_bytes"] = len(packed)
    line["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    line["held_before_gib"] = held / 2**30
    log(f"IPC: lz4 round trip of {IPC_LZ4_ROWS} rows ({len(packed)} bytes) "
        f"holds their rows")
    del data, stream
    return {"IPC Q6": run}, line


# ---------------------------------------------------------------------------
# phase 22: ClickBench's queries 1-8 over `hits`
# ---------------------------------------------------------------------------

HITS_ROWS = 99_997_497  # the published table, nothing cut
CLICKBENCH_REPS = 5


def clickbench_plans(pe, ops, batch) -> dict:
    """The engine `plan_group_by` picks for each group-by of queries 4 and
    6-8 (query 6's on the filtered batch, query 7's second on the first's
    output)."""
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.ops import groupby as gb

    def plan(b, keys, aggs):
        p = gb.plan_group_by(b, keys, aggs)
        return f"{p.engine}" + (f" at {p.buckets} buckets" if p.buckets
                                else "")

    kept = ops.filter_record_batch(
        bt.record_batch({"AdvEngineID": batch["AdvEngineID"]}),
        ops.neq(batch["AdvEngineID"], 0))
    pairs = gb.group_by(bt.record_batch({n: batch[n] for n in
                                         ("RegionID", "UserID")}),
                        ["RegionID", "UserID"], [])
    return {"Q4 (UserID)": plan(batch, ["UserID"], []),
            "Q6 (AdvEngineID, filtered)": plan(
                kept, ["AdvEngineID"], [("AdvEngineID", "count")]),
            "Q7 (RegionID, UserID)": plan(batch, ["RegionID", "UserID"], []),
            "Q7 (RegionID) over the pairs": plan(
                pairs, ["RegionID"], [("UserID", "count")]),
            "Q8 (UserID)": plan(batch, ["UserID"], [("UserID", "count")])}


def clickbench_stages(pe, ops, batch, q) -> dict:
    """The stages of the group-by queries, each timed alone (CUDA events,
    median of 3)."""
    from arrowtpu_torch.config import SortOptions
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.ops import groupby as gb

    reps = dict(reps=3, warmup=1)
    desc = [SortOptions(descending=True), SortOptions()]

    def pick(b, names):
        return bt.record_batch({n: b[n] for n in names})

    if q == 4:
        return {"group_by_ms": median_ms(lambda: gb.group_by(
            pick(batch, ["UserID"]), ["UserID"], []), **reps)}
    if q == 6:
        mask = ops.neq(batch["AdvEngineID"], 0)
        kept = ops.filter_record_batch(pick(batch, ["AdvEngineID"]), mask)
        grouped = gb.group_by(kept, ["AdvEngineID"],
                              [("AdvEngineID", "count")])
        return {"predicate_ms": median_ms(
                    lambda: ops.neq(batch["AdvEngineID"], 0), **reps),
                "filter_ms": median_ms(lambda: ops.filter_record_batch(
                    pick(batch, ["AdvEngineID"]), mask), **reps),
                "group_by_ms": median_ms(lambda: gb.group_by(
                    kept, ["AdvEngineID"], [("AdvEngineID", "count")]),
                    **reps),
                "order_by_ms": median_ms(lambda: ops.sort_batch(
                    grouped, ["count_AdvEngineID", "AdvEngineID"], desc),
                    **reps),
                "kept_rows": kept.length}
    if q == 7:
        two = pick(batch, ["RegionID", "UserID"])
        pairs = gb.group_by(two, ["RegionID", "UserID"], [])
        grouped = gb.group_by(pairs, ["RegionID"], [("UserID", "count")])
        return {"pairs_group_by_ms": median_ms(lambda: gb.group_by(
                    two, ["RegionID", "UserID"], []), **reps),
                "region_group_by_ms": median_ms(lambda: gb.group_by(
                    pairs, ["RegionID"], [("UserID", "count")]), **reps),
                "top10_ms": median_ms(lambda: ops.sort_batch(
                    grouped, ["count_UserID", "RegionID"], desc, limit=10),
                    **reps),
                "pairs": pairs.length, "regions": grouped.length}
    if q == 8:
        one = pick(batch, ["UserID"])
        grouped = gb.group_by(one, ["UserID"], [("UserID", "count")])
        return {"group_by_ms": median_ms(lambda: gb.group_by(
                    one, ["UserID"], [("UserID", "count")]), **reps),
                "top10_ms": median_ms(lambda: ops.sort_batch(
                    grouped, ["count_UserID", "UserID"], desc, limit=10),
                    **reps),
                "groups": grouped.length}
    return {}


def clickbench_phase(pe, ops, k1, k2, build, dev):
    """Phase 22: ClickBench queries 1-8 (`entry.clickbench_step`) over
    `hits` drawn at 99,997,497 rows (`entry.example_hits_arrays`, five
    columns in ClickHouse's types, built on the card by
    `entry.hits_batch`), each exact against `entry.clickbench_oracle`
    (computed on a host thread meanwhile); the engine `plan_group_by`
    picks for each group-by; per query, the launch counts set to 0 just
    before the step and read just after, K1 at 8 bytes in queries 4, 7 and
    8 and K2 at one byte in query 6 (`_build.launch_words`), every K1 and
    K2 call held to plain, every dense_agg call to `dense_aggregate_plain`;
    then each step's time (CUDA events, median of 5 with min and max), its
    stages, peak memory and busy share.  -> ({path: launches}, {query:
    timing line}, the arrays, for phase 26)."""
    import concurrent.futures
    from arrowtpu_torch.kernels import dense_agg as dk

    t0 = time.perf_counter()
    arrays = pe.example_hits_arrays(HITS_ROWS)
    t_draw = time.perf_counter() - t0
    pool = concurrent.futures.ThreadPoolExecutor(1)
    oracle_at = time.perf_counter()
    want_f = pool.submit(pe.clickbench_oracle, arrays)
    t0 = time.perf_counter()
    batch = pe.hits_batch(arrays, dev)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in arrays.values())
    log(f"ClickBench hits: {batch.length} rows, {nbytes / 1e9:.3f} GB, "
        f"drawn in {t_draw:.1f} s, on the card in {t_batch:.1f} s; "
        f"columns {[(f.name, str(f.dtype)) for f in batch.schema.fields]}")
    log(f"ClickBench group-by engines (plan_group_by): "
        f"{clickbench_plans(pe, ops, batch)}")
    launches, got, callers = {}, {}, {}
    for q in sorted(pe.CLICKBENCH_QUERIES):
        args = {}
        with held_to_plain({"K1": k1, "K2": k2}, args) as calls, \
                build.launch_words() as words, \
                recorded(dk, "dense_aggregate") as dense_calls:
            k1.launches = k2.launches = dk.launches = 0
            build.count_launches = 0
            got[q] = pe.clickbench_step(batch, q)
            torch.cuda.synchronize()
            run = {"K1": k1.launches, "K2": k2.launches,
                   "dense_agg": dk.launches,
                   "tile_counts": build.count_launches,
                   **{f"{k}_{w}": words.count((k, w))
                      for k, w in sorted(set(words))}}
        for d_args, out in dense_calls:
            plain = dk.dense_aggregate_plain(*d_args)
            if not all(torch.equal(a, b) for a, b in zip(out, plain)):
                raise AssertionError(f"ClickBench Q{q}: dense_agg differs "
                                     "from its plain version")
            saved = dk.launches
            log(f"  dense_agg at ClickBench Q{q}'s call (n={d_args[5]}, "
                f"{d_args[0].dtype} key, {d_args[4]} buckets, "
                f"{len(d_args[6])} value column(s)): "
                f"{cold_ms(lambda: dk.dense_aggregate(*d_args)):.4f} ms, "
                f"plain "
                f"{cold_ms(lambda: dk.dense_aggregate_plain(*d_args)):.4f} "
                f"ms")
            dk.launches = saved
        if q in (4, 7, 8) and not run.get("K1_8"):
            raise AssertionError(f"ClickBench Q{q}: K1 did not launch at 8 "
                                 f"bytes ({run})")
        if q == 6 and not run.get("K2_1"):
            raise AssertionError(f"ClickBench Q6: K2 did not launch at one "
                                 f"byte ({run})")
        launches[f"ClickBench Q{q}"] = run
        callers[q] = by_caller(args, build)
        log(f"ClickBench Q{q} counted: launches {run}; K1 / K2 calls by "
            f"module and word bytes {callers[q]}; every call held to plain "
            f"(P, n, kept, out_rows): {calls}; {len(dense_calls)} dense_agg "
            "call(s) equal to dense_aggregate_plain")
        del args, dense_calls
    want = want_f.result()
    t_oracle = time.perf_counter() - oracle_at
    pool.shutdown()
    for q in sorted(pe.CLICKBENCH_QUERIES):
        pe.check_clickbench(got[q], want[q], q)
    log(f"ClickBench: all 8 queries exact against clickbench_oracle (numpy, "
        f"{t_oracle:.1f} s on a host thread); AVG(UserID) {got[3]!r} "
        f"against the exact {want[3]!r}")
    del want
    lines = {}
    for q in sorted(pe.CLICKBENCH_QUERIES):
        times = run_times_ms(lambda: pe.clickbench_step(batch, q),
                             reps=CLICKBENCH_REPS, warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        pe.clickbench_step(batch, q)
        peak = torch.cuda.max_memory_allocated()
        if q in (7, 8):
            busy = profile(lambda: pe.clickbench_step(batch, q), reps=3)
        else:
            rows, wall = _profiled(lambda: pe.clickbench_step(batch, q), 3)
            busy_us = _device_us(rows)
            busy = {"wall_ms_per_run": wall / 3 * 1e3,
                    "device_ms_per_run": busy_us / 3 / 1e3,
                    "device_busy_share": busy_us / (wall * 1e6)}
        result = got[q] if q not in (6, 7, 8) else got[q][:3]
        lines[q] = {"query": pe.CLICKBENCH_QUERIES[q],
                    "step_ms": statistics.median(times), "min_ms": times[0],
                    "max_ms": times[-1], "reps": len(times),
                    **clickbench_stages(pe, ops, batch, q),
                    "rows": batch.length,
                    "rows_per_s": batch.length / statistics.median(times)
                    * 1e3, "result": result, "peak_gib": peak / 2**30,
                    "held_before_gib": held / 2**30,
                    "step_adds_gib": (peak - held) / 2**30, **busy}
        log(f"ClickBench Q{q} timing: {lines[q]}")
    return launches, lines, arrays


# ---------------------------------------------------------------------------
# phase 26: phase 22's `hits` through the row formats (Avro, TSV, NDJSON),
# then queries 1-8 on each, and a FlightSQL statement framed for DoGet
# ---------------------------------------------------------------------------

AVRO_ROWS = 1 << 24  # 16,777,216 of the 99,997,497 rows: the host decode
TEXT_ROWS = 1 << 20  # 1,048,576 rows through TSV and NDJSON: the parse
ROW_BATCH = 65_536  # rows an Avro block (write_avro's default), a batch
ENCODE_CHUNK = 1 << 20  # rows the numpy Avro encoder takes at a time
ROW_QUERY_REPS = 3
FLIGHTSQL = ("SELECT UserID, RegionID FROM hits WHERE AdvEngineID <> 0 "
             "AND RegionID < 300 LIMIT 100000")


def _zigzag_varints(v: np.ndarray):
    """int64 values -> ((n, 10) uint8 bytes of each zigzag varint, (n, 10)
    bools of the bytes it uses), every row at once."""
    u = ((v << 1) ^ (v >> 63)).view(np.uint64)
    shifts = np.arange(10, dtype=np.uint64) * np.uint64(7)
    groups = ((u[:, None] >> shifts) & np.uint64(0x7F)).astype(np.uint8)
    more = np.zeros(groups.shape, bool)
    more[:, :9] = (u[:, None] >> (shifts[:9] + np.uint64(7))) != 0
    used = np.ones(groups.shape, bool)
    used[:, 1:] = more[:, :9]
    return groups | (more.astype(np.uint8) << 7), used


def hits_avro_ocf(avro, arrays, names, schema_json, sync) -> bytes:
    """`hits` as one OCF with the null codec and ROW_BATCH-row blocks,
    encoded in numpy: each row is, for every field of `schema_json`, the
    union's branch 1 (its fields are ["null", T]) and the value's zigzag
    varint, uint64 as its int64 bits (write_avro's encoding, row by row in
    Python there)."""
    n = len(arrays[names[0]])
    bodies, lengths = [], []
    for lo in range(0, n, ENCODE_CHUNK):
        parts, masks = [], []
        for name in names:
            x = arrays[name][lo:lo + ENCODE_CHUNK]
            v = x.view(np.int64) if x.dtype == np.uint64 else \
                x.astype(np.int64)
            groups, used = _zigzag_varints(v)
            parts += [np.full((len(v), 1), 2, np.uint8), groups]
            masks += [np.ones((len(v), 1), bool), used]
        mat, mask = np.hstack(parts), np.hstack(masks)
        bodies.append(mat[mask])
        lengths.append(mask.sum(1))
    body = np.concatenate(bodies)
    ends = np.concatenate([[0], np.cumsum(np.concatenate(lengths))])
    out = [avro.ocf_header(schema_json, "null", sync)]
    for start in range(0, n, ROW_BATCH):
        stop = min(start + ROW_BATCH, n)
        head = bytearray()
        avro.write_long(head, stop - start)
        avro.write_long(head, int(ends[stop] - ends[start]))
        out += [bytes(head), body[ends[start]:ends[stop]].tobytes(), sync]
    return b"".join(out)


def hits_from_avro(pe, ops, batch):
    """The read's longs and ints in ClickHouse's types, NOT NULL: UserID
    as the uint64 its int64 bits are, the narrow ones by `ops.cast` (whose
    range check leaves a bitmap, dropped where every row is valid)."""
    import dataclasses

    from arrowtpu_torch.core import batch as bt

    cols = {"UserID": dataclasses.replace(batch["UserID"],
                                          dtype=pe.HITS_TYPES["UserID"]),
            "EventDate": batch["EventDate"]}
    for name in ("RegionID", "ResolutionWidth", "AdvEngineID"):
        c = ops.cast(batch[name], pe.HITS_TYPES[name])
        cols[name] = (dataclasses.replace(c, validity=None)
                      if c.null_count() == 0 else c)
    return bt.record_batch({n: cols[n] for n in pe.HITS_COLUMNS})


def same_as_arrays(pe, batch, arrays, what):
    n = len(arrays["UserID"])
    if batch.length != n:
        raise AssertionError(f"{what}: {batch.length} rows, {n} written")
    for name in pe.HITS_COLUMNS:
        x = arrays[name]
        c = batch[name]
        got = c.values[:n].cpu().numpy().view(x.dtype)
        if c.dtype != pe.HITS_TYPES[name] or c.validity is not None \
                or not np.array_equal(got, x):
            raise AssertionError(f"{what}: {name} differs from the arrays")


def profiled_once(fn):
    """fn() once under torch.profiler, the card synchronized around it ->
    (its result, wall seconds, the card's busy share of them)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, _device_us(prof.key_averages()) / (wall * 1e6)


@contextlib.contextmanager
def stage_seconds(mod, attr, sync=True):
    """Yields a dict whose "s" adds up the seconds spent in mod.<attr> and
    "calls" counts them (the card synchronized after each call, unless
    the calls are host work: sync=False)."""
    fn, total = getattr(mod, attr), {"s": 0.0, "calls": 0}

    def timed_call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        total["s"] += time.perf_counter() - t0
        total["calls"] += 1
        return out

    setattr(mod, attr, timed_call)
    try:
        yield total
    finally:
        setattr(mod, attr, fn)


def row_format_queries(pe, k1, k2, build, dk, batch, want, label):
    """Queries 1-8 on a batch read from a row format, each exact against
    `want` (clickbench_oracle over the same rows), the launch counts set
    to 0 just before each step and read just after, every K1 / K2 call
    held to plain, every dense_agg call to its plain version; then each
    step's time (CUDA events, median of ROW_QUERY_REPS).  -> ({path:
    launches}, {query: ms}, {query: calls by module and word bytes})."""
    launches, ms, callers = {}, {}, {}
    for q in sorted(pe.CLICKBENCH_QUERIES):
        args = {}
        with counted(k1, k2, build, dk, args) as run:
            got = pe.clickbench_step(batch, q)
        pe.check_clickbench(got, want[q], q)
        if q in (4, 7, 8) and not run.get("K1_8"):
            raise AssertionError(f"{label} Q{q}: K1 did not launch at 8 "
                                 f"bytes ({run})")
        if q == 6 and not (run.get("K2_1") and run["dense_agg"]):
            raise AssertionError(f"{label} Q6: K2 at one byte and dense_agg "
                                 f"must launch ({run})")
        launches[f"{label} Q{q}"] = run
        callers[q] = {f"{k}.{m}.{w}B": c for (k, m, w), c in
                      by_caller(args, build).items()}
        if run["dense_agg"]:
            callers[q]["dense_agg"] = run["dense_agg"]
        ms[q] = timed(lambda: pe.clickbench_step(batch, q),
                      reps=ROW_QUERY_REPS)["ms"]
    return launches, ms, callers


def row_formats_phase(pe, ops, k1, k2, build, dev, arrays):
    """Phase 26: phase 22's `hits` arrays through the row formats onto
    the card.  (a) The first AVRO_ROWS rows as one OCF (the null codec,
    ROW_BATCH-row blocks) built by the numpy encoder `hits_avro_ocf`,
    its header and first block held to the port's `write_avro` (the sync
    marker put in place), read back by `read_avro` (the native flat
    decoder on the host, then one upload a column, timed apart), the
    columns given back ClickHouse's types (`hits_from_avro`) and held to
    the arrays.  (b) The first TEXT_ROWS rows as TSV (hits.tsv's layout:
    tab-delimited, no header) and as NDJSON, written by the port's
    writers and read back under the hits schema in ROW_BATCH-row batches
    (the parse and the column building timed apart), held to the arrays.
    After each read, queries 1-8 exact against `clickbench_oracle` over
    the same rows (numpy, on a host thread).  (c) The FlightSQL statement
    FLIGHTSQL by `execute_select` over (a)'s batch on the card, framed as
    DoGet frames it (`flight.encode_batches`) and decoded onto the card
    (`flight.decode_batches`): equal to numpy's selection of the rows.
    -> ({path: launches}, {format: line})."""
    import concurrent.futures

    from arrowtpu_torch import flight, flightsql
    from arrowtpu_torch import schema as st
    from arrowtpu_torch.formats import avro, csv
    from arrowtpu_torch.formats import json as ndjson
    from arrowtpu_torch.kernels import dense_agg as dk

    names = pe.HITS_COLUMNS
    avro_arrays = {n: arrays[n][:AVRO_ROWS] for n in names}
    text_arrays = {n: arrays[n][:TEXT_ROWS] for n in names}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    want_f = {"avro": pool.submit(pe.clickbench_oracle, avro_arrays),
              "text": pool.submit(pe.clickbench_oracle, text_arrays)}
    launches, lines = {}, {}

    # (a) Avro
    first = pe.hits_batch({n: avro_arrays[n][:ROW_BATCH] for n in names},
                          dev)
    t0 = time.perf_counter()
    by_writer = avro.write_avro(first)
    writer_s = time.perf_counter() - t0
    sync = avro.AvroFile(by_writer, device=dev).sync
    schema_json = avro.schema_to_avro_json(first.schema)
    t0 = time.perf_counter()
    data = hits_avro_ocf(avro, avro_arrays, names, schema_json, sync)
    write_s = time.perf_counter() - t0
    if data[:len(by_writer)] != by_writer:
        raise AssertionError("avro: the numpy encoder's header and first "
                             "block differ from write_avro's")
    del first
    log(f"avro: {AVRO_ROWS} hits rows as {len(data)} bytes in "
        f"{write_s:.2f} s (numpy encoder; write_avro took {writer_s:.2f} s "
        f"for the first {ROW_BATCH} rows, whose bytes the encoder's equal)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    f = avro.AvroFile(data, device=dev)

    def read():
        blocks, decode_s = host_s(lambda: avro.decode_flat(f))
        out, upload_s = host_s(lambda: avro.upload_flat(f, blocks, dev))
        return out, decode_s, upload_s

    (read_batch, decode_s, upload_s), read_s, busy = profiled_once(read)
    batch = hits_from_avro(pe, ops, read_batch)
    del read_batch
    same_as_arrays(pe, batch, avro_arrays, "avro")
    peak = torch.cuda.max_memory_allocated()
    run_l, ms, callers = row_format_queries(
        pe, k1, k2, build, dk, batch, want_f["avro"].result(), "avro")
    launches.update(run_l)
    lines["avro"] = {
        "rows": AVRO_ROWS, "bytes": len(data), "blocks": AVRO_ROWS //
        ROW_BATCH, "write_s": write_s, "write_avro_first_block_s": writer_s,
        "read_s": read_s, "host_decode_s": decode_s, "upload_s": upload_s,
        "MBps_read": len(data) / read_s / 1e6,
        "MBps_written": len(data) / write_s / 1e6,
        "read_busy_share": busy, "peak_gib": peak / 2**30,
        "held_before_gib": held / 2**30, "query_ms": ms,
        "launches_by_caller": callers}
    log(f"avro: read {read_s:.2f} s (decode {decode_s:.2f}, upload "
        f"{upload_s:.2f}); columns equal the arrays; queries 1-8 exact "
        f"against clickbench_oracle; {json.dumps(lines['avro'])}")

    # (c) the FlightSQL statement on (a)'s batch, framed for DoGet
    args = {}
    with counted(k1, k2, build, dk, args) as run:
        result = flightsql.execute_select({"hits": batch}, FLIGHTSQL)
    if not (run.get("K1_4") and run.get("K1_8") and run.get("K2_1")):
        raise AssertionError(f"FlightSQL: K1 at 4 and 8 bytes and K2 at one "
                             f"byte must launch in the filter ({run})")
    launches["FlightSQL statement"] = run
    messages, frame_s = host_s(
        lambda: list(flight.encode_batches(result.schema, [result])))
    (_, back), decode_s = host_s(
        lambda: flight.decode_batches(messages, device=dev))
    keep = ((avro_arrays["AdvEngineID"] != 0)
            & (avro_arrays["RegionID"] < 300))
    want = {n: avro_arrays[n][keep][:100_000] for n in ("UserID",
                                                        "RegionID")}
    got = back[0]
    if got.device != dev or got.length != len(want["UserID"]) or \
            any(not np.array_equal(got[n].values[:got.length].cpu().numpy()
                                   .view(w.dtype), w)
                for n, w in want.items()):
        raise AssertionError("FlightSQL: the decoded batch differs from "
                             "numpy's selection")
    lines["FlightSQL"] = {
        "sql": FLIGHTSQL, "rows_in": AVRO_ROWS, "rows_out": got.length,
        "statement_ms": timed(lambda: flightsql.execute_select(
            {"hits": batch}, FLIGHTSQL), reps=ROW_QUERY_REPS)["ms"],
        "frame_s": frame_s, "decode_s": decode_s,
        "flight_data_bytes": sum(len(m) for m in messages),
        "launches_by_caller": {f"{k}.{m}.{w}B": c for (k, m, w), c in
                               by_caller(args, build).items()}}
    log(f"FlightSQL statement on the card, framed and decoded onto the "
        f"card: equal to numpy's selection; launches {run}; "
        f"{json.dumps(lines['FlightSQL'])}")
    del batch, result, back, got, f, data
    torch.cuda.empty_cache()

    # (b) TSV and NDJSON
    schema = st.Schema(tuple(st.Field(n, pe.HITS_TYPES[n], False)
                             for n in names))
    source = pe.hits_batch(text_arrays, dev)
    want = want_f["text"].result()
    pool.shutdown()
    formats = {
        "tsv": (csv, "upload_columns",
                lambda: csv.write_csv(source, delimiter="\t",
                                      has_header=False),
                lambda text: csv.read_csv(
                    text, schema=schema, delimiter="\t", has_header=False,
                    batch_size=ROW_BATCH, device=dev)),
        "ndjson": (ndjson, "upload_columns",
                   lambda: ndjson.write_json(source),
                   lambda text: ndjson.read_json(
                       text, schema=schema, batch_size=ROW_BATCH,
                       device=dev))}
    for label, (mod, stage, write, read_text) in formats.items():
        text, write_s = host_s(write)
        nbytes = len(text.encode())
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with stage_seconds(mod, stage) as up:
            batch, read_s, busy = profiled_once(lambda: read_text(text))
        same_as_arrays(pe, batch, text_arrays, label)
        peak = torch.cuda.max_memory_allocated()
        run_l, ms, callers = row_format_queries(
            pe, k1, k2, build, dk, batch, want, label)
        launches.update(run_l)
        lines[label] = {
            "rows": TEXT_ROWS, "bytes": nbytes, "batches": up["calls"],
            "write_s": write_s, "read_s": read_s,
            "host_decode_s": read_s - up["s"], "upload_s": up["s"],
            "MBps_read": nbytes / read_s / 1e6,
            "MBps_written": nbytes / write_s / 1e6,
            "read_busy_share": busy, "peak_gib": peak / 2**30,
            "held_before_gib": held / 2**30, "query_ms": ms,
            "launches_by_caller": callers}
        log(f"{label}: columns equal the arrays; queries 1-8 exact against "
            f"clickbench_oracle; {json.dumps(lines[label])}")
        del batch, text
    del source
    torch.cuda.empty_cache()
    return launches, lines


# ---------------------------------------------------------------------------
# phase 23: ClickBench's query 43 over `hits` in primary-key order
# ---------------------------------------------------------------------------

HITS_PK_REPS = 5
TAKE_RUN_IDS = 1_000_000
CDATA_SLICE_ROWS = 1_000_000


def hits_pk_oracle(pe, arrays) -> dict:
    """numpy on the host: each run column's run ends and values, the
    Moscow-date invariant by MSK's fixed +4 h of 2013 (no tzdb), and query
    43's result."""
    runs = {}
    for name in pe.HITS_RUN_COLUMNS:
        x = arrays[name]
        starts = np.flatnonzero(np.diff(x)) + 1
        runs[name] = (np.append(starts, len(x)).astype(np.int32),
                      x[np.append(0, starts)])
    days = (arrays["EventTime"] + pe.MSK_2013_OFFSET_S) // 86_400
    return {"runs": runs,
            "invariant": bool((days == arrays["EventDate"]).all()),
            "q43": pe.q43_oracle(arrays)}


@contextlib.contextmanager
def counted(k1, k2, build, dk, args=None):
    """The launch counts set to 0 on entry and read on exit (into the
    yielded dict), every K1 / K2 call held to plain, every dense_agg call
    recorded (under "dense_calls")."""
    run = {}
    with held_to_plain({"K1": k1, "K2": k2}, args) as calls, \
            build.launch_words() as words, \
            recorded(dk, "dense_aggregate") as dense_calls:
        k1.launches = k2.launches = dk.launches = 0
        build.count_launches = 0
        yield run
        torch.cuda.synchronize()
        run.update({"K1": k1.launches, "K2": k2.launches,
                    "dense_agg": dk.launches,
                    "tile_counts": build.count_launches,
                    **{f"{k}_{w}": words.count((k, w))
                       for k, w in sorted(set(words))}})
    for d_args, out in dense_calls:
        plain = dk.dense_aggregate_plain(*d_args)
        if not all(torch.equal(a, b) for a, b in zip(out, plain)):
            raise AssertionError("dense_agg differs from its plain version")
    run["calls_held_to_plain"] = {k: len(v) for k, v in calls.items()}
    run["dense_calls_held_to_plain"] = len(dense_calls)


_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def same_rows(a, b, n) -> bool:
    """Two port columns' first n rows: values (uint16 / uint32 by their
    bits: the card compares neither) and validity as bools."""
    def bits(t):
        return t.view(_SIGNED_TWIN.get(t.dtype, t.dtype))[:n]
    return (a.dtype == b.dtype and torch.equal(bits(a.values), bits(b.values))
            and torch.equal(a.valid_bool()[:n], b.valid_bool()[:n]))


def timed(fn, reps=HITS_PK_REPS) -> dict:
    times = run_times_ms(fn, reps=reps, warmup=1)
    return {"ms": statistics.median(times), "min_ms": times[0],
            "max_ms": times[-1], "reps": len(times)}


def q43_stages(pe, ops, batch) -> dict:
    """Query 43's stages, each timed alone (CUDA events, median of 3)."""
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.ops import groupby as gb

    reps = dict(reps=3, warmup=1)
    rows = batch["EventTime"].capacity
    cid, date = batch["CounterID"], batch["EventDate"]
    lo, hi = (pe._days(d) for d in pe.Q43_DAYS)

    def runs():
        return (pe.runs_predicate(cid, ops.eq(cid.values, pe.HITS_TOP_COUNTER),
                                  rows),
                pe.runs_predicate(date, ops.and_(
                    ops.gt_eq(date.values, lo), ops.lt_eq(date.values, hi)),
                    rows))
    on_counter, in_days = runs()
    mask = pe.q43_mask(batch)
    kept = ops.filter_(batch["EventTime"], mask)
    minute = pe.minute_trunc(kept)
    keyed = bt.record_batch({"M": minute})
    grouped = gb.group_by(keyed, ["M"], [("M", "count")])
    plan = gb.plan_group_by(keyed, ["M"], [("M", "count")])
    return {
        "run_predicates_and_decode_ms": median_ms(runs, **reps),
        "mask_ms": median_ms(lambda: ops.and_(
            ops.and_(on_counter, in_days),
            ops.and_(ops.eq(batch["IsRefresh"], 0),
                     ops.eq(batch["DontCountHits"], 0))), **reps),
        "filter_ms": median_ms(lambda: ops.filter_(batch["EventTime"], mask),
                               **reps),
        "trunc_ms": median_ms(lambda: pe.minute_trunc(kept), **reps),
        "group_by_ms": median_ms(lambda: gb.group_by(
            keyed, ["M"], [("M", "count")]), **reps),
        "top_ms": median_ms(lambda: ops.slice_batch(ops.sort_batch(
            grouped, ["M"], limit=pe.Q43_OFFSET + pe.Q43_LIMIT),
            pe.Q43_OFFSET, pe.Q43_LIMIT), **reps),
        "kept_rows": kept.length, "minutes": grouped.length,
        "group_by_engine": plan.engine + (f" at {plan.buckets} buckets"
                                          if plan.buckets else "")}


def cdata_round_trip(cdata, c, dev) -> str:
    """Export a column through the C Data Interface and import it onto the
    card: it must come back row for row, its type (a zone included) too.
    -> the format string."""
    schema, array = cdata.export_column(c, "c")
    fmt = schema.format.decode()
    back, field = cdata.import_column(ctypes.addressof(array),
                                      ctypes.addressof(schema), dev)
    if field.dtype != c.dtype or back.length != c.length or not same_rows(
            back, c, c.length) or back.device.type != dev.type:
        raise AssertionError(f"C Data round trip of {c.dtype} differs")
    return fmt


def hits_pk_phase(pe, ops, k1, k2, build, dev):
    """Phase 23: ClickBench's query 43 over `hits` in primary-key order,
    drawn at 99,997,497 rows (`entry.example_hits_pk_arrays`): the two
    run-end encodes of `entry.hits_pk_batch` against numpy's runs and
    decoded back bit for bit, `take_run` of 1,000,000 ids (1 % null)
    against numpy's gather, the Moscow-date invariant on every row,
    `entry.q43_step` exact against `entry.q43_oracle` (its run predicates'
    mask against the decoded columns' once), then the host boundary
    (`pretty_format_batches`, `iter_rows`, the C Data round trip of the
    result and of a 1,000,000-row slice of the plain columns onto the
    card).  The launch counts are set to 0 just before each step and read
    just after; every K1 / K2 call is held to plain and every dense_agg
    call to `dense_aggregate_plain`.  -> ({path: launches}, {step: timing
    line})."""
    import concurrent.futures
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.core.accessor import iter_rows
    from arrowtpu_torch.core import column as col
    from arrowtpu_torch.interop import cdata
    from arrowtpu_torch.interop.numpy_bridge import column_from_numpy
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.utils import buffer_memory_size, pretty_format_batches

    t0 = time.perf_counter()
    arrays = pe.example_hits_pk_arrays(HITS_ROWS)
    t_draw = time.perf_counter() - t0
    pool = concurrent.futures.ThreadPoolExecutor(1)
    want_f = pool.submit(hits_pk_oracle, pe, arrays)
    launches, lines = {}, {}

    # step 1: the batch, its two run-end encodes on the card
    args = {}
    with counted(k1, k2, build, dk, args) as run:
        batch = pe.hits_pk_batch(arrays, dev)
    if not run.get("K1_4"):
        raise AssertionError(f"hits_pk_batch: no K1 launch at 4 bytes "
                             f"({run})")
    launches["hits_pk_batch (run_end_encode x2)"] = run
    plain = {n: column_from_numpy(arrays[n], None,
                                  dtype=pe.HITS_PK_TYPES[n], device=dev)
             for n in pe.HITS_RUN_COLUMNS}
    t = batch["EventTime"]
    rows, cap = t.length, t.capacity
    want = want_f.result()
    sizes = {}
    for name in pe.HITS_RUN_COLUMNS:
        r = batch[name]
        ends, values = want["runs"][name]
        got_values = r.values.values[:r.n_runs].cpu().numpy()
        if (r.n_runs != len(ends) or not np.array_equal(
                r.run_ends[:r.n_runs].cpu().numpy(), ends)
                or not np.array_equal(got_values.view(values.dtype), values)
                or not bool((r.run_ends[r.n_runs:] == rows).all())):
            raise AssertionError(f"{name}: runs differ from numpy's")
        back = ops.run_end_decode_to(r, cap)
        if not same_rows(back, plain[name], rows):
            raise AssertionError(f"{name}: decode differs from the column")
        sizes[name] = {"runs": r.n_runs,
                       "plain_bytes": buffer_memory_size(plain[name]),
                       "encoded_bytes": buffer_memory_size(r)}
        lines[f"encode {name}"] = dict(timed(
            lambda: ops.run_end_encode(plain[name])), runs=r.n_runs,
            rows=rows)
        lines[f"decode {name}"] = timed(
            lambda: ops.run_end_decode_to(r, cap))
    log(f"hits pk: {rows} rows, {sum(a.nbytes for a in arrays.values()) / 1e9:.3f} "
        f"GB, drawn in {t_draw:.1f} s; runs equal numpy's and decode bit "
        f"for bit: {sizes}; launches {run}; K1 / K2 calls by module and "
        f"word bytes {by_caller(args, build)}")

    # step 2: take_run of 1,000,000 ids, 1 % null
    rng = np.random.default_rng(23)
    ids = rng.integers(0, rows, TAKE_RUN_IDS)
    ok = rng.random(TAKE_RUN_IDS) >= 0.01
    idx = col.primitive(ids, pe.st.int64, validity=ok, device=dev)
    for name in pe.HITS_RUN_COLUMNS:
        with counted(k1, k2, build, dk) as run:
            got = ops.take_run(batch[name], idx)
        launches[f"take_run {name}"] = run
        vals = got.values[:TAKE_RUN_IDS].cpu().numpy()
        valid = got.valid_bool()[:TAKE_RUN_IDS].cpu().numpy()
        x = arrays[name]
        if not (np.array_equal(valid, ok) and np.array_equal(
                vals[ok].view(x.dtype), x[ids[ok]])):
            raise AssertionError(f"take_run {name} differs from numpy")
        lines[f"take_run {name}"] = dict(timed(
            lambda: ops.take_run(batch[name], idx)), ids=TAKE_RUN_IDS)
    log(f"hits pk: take_run of {TAKE_RUN_IDS} ids (1 % null) exact against "
        "numpy's gather, both columns")

    # step 3: the Moscow dates of EventTime are EventDate, every row
    with counted(k1, k2, build, dk) as run:
        date = ops.run_end_decode_to(batch["EventDate"], cap)
        for part in ("year", "month", "day"):
            if not torch.equal(ops.date_part(t, part).values,
                               ops.date_part(date, part).values):
                raise AssertionError(f"invariant: {part} of EventTime in "
                                     "Moscow differs from EventDate's")
    if not want["invariant"]:
        raise AssertionError("the draw's EventDate is not EventTime + 4 h")
    launches["date_part invariant"] = run
    lines["date_part day, Europe/Moscow"] = dict(timed(
        lambda: ops.date_part(t, "day")), rows=rows)
    lines["date_part year, month, day, Europe/Moscow"] = timed(
        lambda: [ops.date_part(t, p) for p in ("year", "month", "day")])
    log(f"hits pk: year, month and day of EventTime under {pe.HITS_TZ} "
        f"equal EventDate's on all {rows} rows (host: EventDate is "
        "EventTime + 4 h, MSK's fixed offset of 2013)")

    # step 4: query 43
    args = {}
    with counted(k1, k2, build, dk, args) as run:
        got = pe.q43_step(batch)
    if not run.get("K1_8"):
        raise AssertionError(f"Q43: no K1 launch at 8 bytes ({run})")
    launches["ClickBench Q43"] = run
    pe.check_q43(got, want["q43"])
    mask = pe.q43_mask(batch)
    lo, hi = (pe._days(d) for d in pe.Q43_DAYS)
    direct = ops.and_(ops.and_(
        ops.eq(plain["CounterID"], pe.HITS_TOP_COUNTER),
        ops.and_(ops.gt_eq(plain["EventDate"], lo),
                 ops.lt_eq(plain["EventDate"], hi))),
        ops.and_(ops.eq(batch["IsRefresh"], 0),
                 ops.eq(batch["DontCountHits"], 0)))
    if not torch.equal(mask.values_bool() & mask.valid_bool(),
                       direct.values_bool() & direct.valid_bool()):
        raise AssertionError("Q43: the run predicates' mask differs from "
                             "the decoded columns'")
    del direct, mask, plain
    stages = q43_stages(pe, ops, batch)
    log(f"ClickBench Q43 exact against q43_oracle: {got}; launches {run}; "
        f"K1 / K2 calls by module and word bytes {by_caller(args, build)}; "
        f"stages {stages}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pe.q43_step(batch)
    peak = torch.cuda.max_memory_allocated()
    lines["ClickBench Q43"] = dict(
        timed(lambda: pe.q43_step(batch)), query=pe.Q43, **stages,
        rows=rows, result=got, peak_gib=peak / 2**30,
        held_before_gib=held / 2**30, step_adds_gib=(peak - held) / 2**30,
        **profile(lambda: pe.q43_step(batch), reps=3))

    # step 5: the host boundary
    with counted(k1, k2, build, dk) as run:
        result = pe.q43_result(batch)
        text = pretty_format_batches(result)
        rows_out = list(iter_rows(result, window=4))
        if rows_out != [dict(zip(("M", "PageViews"), r)) for r in got]:
            raise AssertionError("iter_rows differs from the result")
        formats = [cdata_round_trip(cdata, c, dev) for c in result.columns]
        for name in pe.HITS_PK_COLUMNS[2:]:
            formats.append(cdata_round_trip(
                cdata, ops.slice_(batch[name], 0, CDATA_SLICE_ROWS), dev))
        for name in pe.HITS_RUN_COLUMNS:
            formats.append(cdata_round_trip(cdata, ops.slice_(
                ops.run_end_decode_to(batch[name], cap), 0,
                CDATA_SLICE_ROWS), dev))
    if "tss:Europe/Moscow" not in formats:
        raise AssertionError(f"no zoned timestamp format in {formats}")
    launches["host boundary"] = run
    log("ClickBench Q43 result:\n" + text)
    log(f"hits pk: iter_rows equal to the result; C Data round trips onto "
        f"the card equal row for row, formats {formats}")
    sliced = bt.record_batch({n: ops.slice_(batch[n], 0, CDATA_SLICE_ROWS)
                              for n in pe.HITS_PK_COLUMNS[2:]})
    lines["C Data export + import"] = dict(timed(
        lambda: [cdata_round_trip(cdata, c, dev) for c in sliced.columns],
        reps=3), rows=CDATA_SLICE_ROWS, columns=pe.HITS_PK_COLUMNS[2:])
    pool.shutdown()
    return launches, lines, arrays, want["q43"]


# phase 25: phase 23's hits through a Parquet file, scanned with pushdown
PARQUET_SCAN_REPS = 3
PARQUET_STAGES = {"prune_row_groups": "prune",
                  "decode_row_group": "decode", "decode_column": "decode",
                  "upload_columns": "upload",
                  "evaluate_predicates": "predicates",
                  "filter_row_group": "filter", "concat_batches": "concat"}


@contextlib.contextmanager
def scan_stages(ps):
    """While active, the scan's stage functions (PARQUET_STAGES, patched in
    `formats.parquet_scan` and `ops.concat`) run with the card
    synchronized around each, and the outermost call of each adds its
    seconds to its stage; yields {stage: seconds}."""
    import importlib

    oc = importlib.import_module("arrowtpu_torch.ops.concat")

    spent = collections.defaultdict(float)
    depth = [0]
    saved = []

    def wrap(mod, name, stage):
        real = getattr(mod, name)

        def staged(*args, **kw):
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                torch.cuda.synchronize()
                depth[0] -= 1
                if not depth[0]:
                    spent[stage] += time.perf_counter() - t0

        saved.append((mod, name, real))
        setattr(mod, name, staged)

    for name, stage in PARQUET_STAGES.items():
        wrap(oc if name == "concat_batches" else ps, name, stage)
    try:
        yield spent
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def scan_line(pq, ps, data, preds, dev) -> dict:
    """One scan of `data` on the card: end to end, then by stage (its own
    run; the footer parsed first), peak memory and GB/s over the bytes it
    decoded."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, m = ps.scan_parquet(data, predicates=preds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rows = out.length
    del out
    with scan_stages(ps) as spent:
        t0 = time.perf_counter()
        pf = pq.ParquetFile(data, device=dev)
        spent["footer"] = time.perf_counter() - t0
        ps.scan_parquet(pf, predicates=preds)
        staged = time.perf_counter() - t0
    return {"ms": wall * 1e3, "rows": rows, "metrics": m.asdict(),
            "GBps_decoded": m.bytes_decompressed / wall / 1e9,
            "staged_ms": staged * 1e3,
            "stages_ms": {k: v * 1e3 for k, v in spent.items()},
            "peak_gib": peak / 2**30, "step_adds_gib": (peak - held) / 2**30}


def parquet_phase(pe, ops, k1, k2, build, dev, arrays, q43_want):
    """Phase 25: phase 23's `hits` arrays written to one Parquet file in
    host memory and scanned back onto the card with query 43's predicates
    pushed down, then in full; query 43 on the scanned rows.  The launch
    counts are set to 0 just before each scan and read just after, every
    K1 / K2 call held to plain.  -> ({path: launches}, {step: line})."""
    from arrowtpu_torch.formats import parquet as pq
    from arrowtpu_torch.formats import parquet_push as pp
    from arrowtpu_torch.formats import parquet_scan as ps
    from arrowtpu_torch.kernels import dense_agg as dk

    launches, lines = {}, {}
    names = pe.HITS_PK_COLUMNS

    # step 1: the file
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = pe.hits_pk_parquet(arrays, device=dev)
    write_s = time.perf_counter() - t0
    pf = pq.ParquetFile(data, device=dev)
    n_rg = len(pf.row_groups)
    pages = sum(len(pf.offset_index(rg, n)) for rg in range(n_rg)
                for n in names)
    lines["write"] = {"s": write_s, "bytes": len(data), "row_groups": n_rg,
                      "data_pages": pages,
                      "GBps_written": len(data) / write_s / 1e9}
    log(f"parquet: {len(arrays['EventTime'])} hits rows written in "
        f"{write_s:.2f} s, {len(data)} bytes, {n_rg} row groups, {pages} "
        "data pages")

    # numpy's rows of each scan
    lo, hi = (pe._days(d) for d in pe.Q43_DAYS)
    want_q43 = ((arrays["CounterID"] == pe.HITS_TOP_COUNTER)
                & (arrays["EventDate"] >= lo) & (arrays["EventDate"] <= hi)
                & (arrays["IsRefresh"] == 0) & (arrays["DontCountHits"] == 0))
    want_full = arrays["DontCountHits"] == 0

    def same_as_numpy(batch, mask, cols, what):
        got_rows = batch.length
        if got_rows != int(mask.sum()):
            raise AssertionError(f"{what}: {got_rows} rows, numpy "
                                 f"{int(mask.sum())}")
        for name in cols:
            x = arrays[name]
            got = batch[name].values[:got_rows].cpu().numpy()
            if not np.array_equal(got.view(x.dtype), x[mask]):
                raise AssertionError(f"{what}: {name} differs from numpy's")

    # step 2: query 43's predicates pushed down
    preds = pe.q43_predicates()
    args = {}
    with counted(k1, k2, build, dk, args) as run:
        scanned, m = ps.scan_parquet(data, predicates=preds, device=dev)
    if not (run.get("K1_4") and run.get("K1_8") and run.get("K2_1")):
        raise AssertionError(f"pruned scan: K1 at 4 and 8 bytes and K2 at "
                             f"one byte must launch ({run})")
    launches["parquet scan, Q43 pushed down"] = run
    back = pe.hits_from_parquet(scanned)
    same_as_numpy(back, want_q43, names, "pruned scan")
    log(f"parquet pruned scan: {m.asdict()}; rows equal numpy's in order; "
        f"launches {run}; K1 / K2 calls by module and word bytes "
        f"{by_caller(args, build)}")
    with counted(k1, k2, build, dk) as run:
        got = pe.q43_step(back)
    launches["ClickBench Q43 on the scanned rows"] = run
    pe.check_q43(got, q43_want)
    lines["Q43 on the scanned rows"] = dict(
        timed(lambda: pe.q43_step(back)), rows=back.length, result=got)
    lines["scan, Q43 pushed down"] = dict(
        scan_line(pq, ps, data, preds, dev),
        **profile(lambda: ps.scan_parquet(data, predicates=preds,
                                          device=dev),
                  reps=PARQUET_SCAN_REPS))
    log(f"ClickBench Q43 on the scanned rows exact against q43_oracle: {got}")
    del scanned, back

    # step 3: the full scan
    preds = pe.q43_predicates(all_four=False)
    args = {}
    with counted(k1, k2, build, dk, args) as run:
        full, m = ps.scan_parquet(data, predicates=preds, device=dev)
    if not (run.get("K1_4") and run.get("K1_8") and run.get("K2_1")):
        raise AssertionError(f"full scan: K1 at 4 and 8 bytes and K2 at "
                             f"one byte must launch ({run})")
    launches["parquet scan, DontCountHits = 0"] = run
    same_as_numpy(pe.hits_from_parquet(full), want_full,
                  ["CounterID", "EventTime"], "full scan")
    log(f"parquet full scan: {m.asdict()}; {full.length} rows, count, "
        f"CounterID and EventTime equal numpy's; launches {run}; K1 / K2 "
        f"calls by module and word bytes {by_caller(args, build)}")
    del full
    torch.cuda.empty_cache()
    lines["scan, DontCountHits = 0"] = dict(
        scan_line(pq, ps, data, preds, dev),
        **profile(lambda: ps.scan_parquet(data, predicates=preds,
                                          device=dev), reps=1))

    # step 4: the push decoder and a GZIP round trip, one row group each
    def read_fn(off, ln):
        return data[off:off + ln]
    gen = pp.decode_with_reader(read_fn, len(data), device=dev)
    first = next(gen)
    gen.close()
    want = pf.read_row_group(0)
    if first.length != want.length or not all(
            same_rows(first[n], want[n], want.length) for n in names):
        raise AssertionError("decode_with_reader's first row group "
                             "differs from read_row_group's")
    t0 = time.perf_counter()
    gz = pq.write_parquet(want, props=pe.hits_parquet_props(
        compression="gzip"))
    gz_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    gz_back = pq.read_parquet(gz, device=dev)
    gz_read = time.perf_counter() - t0
    if not all(same_rows(gz_back[n], want[n], want.length) for n in names):
        raise AssertionError("GZIP round trip of a row group differs")
    lines["one row group, GZIP"] = {
        "rows": want.length, "bytes": len(gz), "write_s": gz_write,
        "read_s": gz_read}
    log(f"parquet: decode_with_reader's first row group equals "
        f"read_row_group's; a GZIP round trip of it ({want.length} rows, "
        f"{len(gz)} bytes) exact")
    return launches, lines


def check_probes(kp, probes, dev) -> None:
    """Phase 9: every probe kernel and stage variant against its plain
    version on the same inputs, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(4)
    info = torch.iinfo(torch.int32)

    def words(*shape):
        return torch.randint(info.min, info.max, shape, dtype=torch.int32,
                             device=dev, generator=g)

    def same(kernel, plain, where):
        """kernel() against plain(), the plain version first, so that the
        kernel's outputs land on blocks poisoned by fresh_call."""
        want = plain()
        got = probes.fresh_call(kernel, want)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a, b)):
                raise AssertionError(f"{where}: differs from its plain "
                                     "version")

    for n in (65_536, 8_060_928, 8_000_001):
        for P in (1, 2, 16):
            planes = words(P, n)
            keep = (torch.rand(n, device=dev, generator=g) < 0.5).to(
                torch.uint8)
            for k in (None, keep):
                same(lambda: kp.stream(planes, k),
                     lambda: kp.stream_plain(planes, k),
                     f"stream P={P} n={n} keep={k is not None}")
    rows = 62_976
    x, mask = words(rows, 128), words(rows, 128)
    small = x % 16  # so that x > 7 is false on half the words
    # one word into their buffers: no 16-byte accesses
    odd = (words(1001 * 128 + 1) % 16)[1:].view(1001, 128)
    odd_mask = words(1001 * 128 + 1)[1:].view(1001, 128)
    # row counts that leave the last warp's rows part filled
    roll_inputs = ((x, mask), (small, None), (x[:1], mask[:1]),
                   (small[:3], None), (small[:1001], mask[:1001]),
                   (odd, None), (odd, odd_mask))
    # selected and unselected rolls in one call, and remainders of the
    # shifts' period of 7
    roll_pairs = ((7, 0), (14, 14), (56, 56), (28, 14), (13, 5), (20, 1),
                  (64, 0), (71, 70))
    for k, nsel in roll_pairs:
        for data, m in roll_inputs:
            same(lambda: kp.lane_roll(data, k, nsel, m),
                 lambda: kp.lane_roll_plain(data, k, nsel, m),
                 f"lane_roll k={k} nsel={nsel} rows={data.shape[0]} "
                 f"mask={m is not None}")
    patterns = [(p, W) for p in ("lanes", "sublanes", "table", "chained",
                                 "rowmove") for W in (128, 256)]
    patterns += [("deinterleave", 256), ("reinterleave", 256),
                 ("pairs", 256), ("roundtrip", 256)]
    for pattern, W in patterns:
        data = words(2, rows, 128) if pattern == "reinterleave" \
            else words(rows, W)
        extent = {"sublanes": kp.TILE_ROWS, "pairs": 128}.get(pattern, W)
        idx = None
        if pattern == "roundtrip":  # the identity, in one launch
            same(lambda: kp.tile_gather(data, pattern), data.clone,
                 "tile_gather roundtrip against the identity")
        if pattern not in ("rowmove", "deinterleave", "reinterleave",
                           "roundtrip"):
            idx = torch.randint(0, extent, (rows, 128 if pattern == "pairs"
                                            else W), dtype=torch.int32,
                                device=dev, generator=g)
        same(lambda: kp.tile_gather(data, pattern, idx),
             lambda: kp.tile_gather_plain(data, pattern, idx),
             f"tile_gather {pattern} W={W}")
    n = 8_000_001
    planes = words(2, n)
    for density in (0.0, 0.055, 0.5, 1.0):
        keep = torch.rand(n, device=dev, generator=g) < density
        count = int(keep.sum())
        for kernel in kp.KERNELS:
            for stage in kp.STAGES:
                if (stage, kernel) == ("lookback", "k1"):
                    continue
                words_ = count if stage == "kept" else n

                def cut(run):
                    out, aux = run(planes, keep, stage, kernel)
                    return out[:, :words_], aux

                same(lambda: cut(kp.compaction_stages),
                     lambda: cut(kp.compaction_stages_plain),
                     f"{kernel} stage {stage} density {density}")
    log(f"probe kernels: bit-exact against plain (stream 18 cases, "
        f"lane_roll {len(roll_pairs) * len(roll_inputs)}, tile_gather "
        f"{len(patterns)}, compaction stages 9 x 4 densities)")


def sort_passes_ms(fn, passes, reps=3):
    """Device ms of each stable sort pass of fn() in launch order: the
    top-level aten::sort ops of a torch.profiler trace of `reps` runs, each
    op's time that of the kernels it launched (CUPTI), averaged by pass.
    fn() must run `passes` sorts."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    sorts = sorted((e for e in prof.events() if e.name == "aten::sort" and (
        e.cpu_parent is None or e.cpu_parent.name != "aten::sort")),
        key=lambda e: e.time_range.start)
    if len(sorts) != reps * passes:
        raise AssertionError(f"{len(sorts)} sorts in {reps} runs, expected "
                             f"{passes} a run")
    return [sum(e.device_time_total for e in sorts[i::passes]) / reps / 1e3
            for i in range(passes)]


def lexsort_phase(pe, dev) -> dict:
    """Phase 11: config 3 at 100M rows.  -> its numbers."""
    from arrowtpu_torch.core import bitmap as bm
    from arrowtpu_torch.rowformat import encode as rf
    from arrowtpu_torch.rowformat import pack as rp

    t0 = time.perf_counter()
    arrays = pe.example_lexsort_arrays(LEXSORT_ROWS)
    sort_keys = pe.lexsort_keys(*arrays)
    log(f"lexsort: {LEXSORT_ROWS} rows and their host keys in "
        f"{time.perf_counter() - t0:.1f} s")

    m = LEXSORT_CHECK_ROWS
    head = pe.lexsort_columns(*(a[:m] for a in arrays[:3]), arrays[3],
                              device=dev)
    got = pe.lexsort_step(head).values[:m].cpu().numpy()
    if not np.array_equal(got, np.lexsort(tuple(k[:m]
                                                for k in sort_keys[::-1]))):
        raise AssertionError(f"lexsort differs from np.lexsort at {m} rows")
    log(f"lexsort: equal to np.lexsort at {m} rows")
    del head

    cols = pe.lexsort_columns(*arrays, device=dev)
    torch.cuda.synchronize()
    inputs = sum(c.values.nbytes for c in (cols[0], cols[1], cols[2].keys))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    idx = pe.lexsort_step(cols)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    pe.check_lexsort(idx.values[:idx.length].cpu().numpy(), sort_keys)
    log(f"lexsort: {idx.length} rows checked on the host in "
        f"{time.perf_counter() - t1:.1f} s (permutation, keys never "
        "decrease, ties in row order)")
    del idx

    step_ms = median_ms(lambda: pe.lexsort_step(cols), reps=LEXSORT_REPS,
                        warmup=1)

    def stage(fn):
        return median_ms(fn, reps=LEXSORT_REPS, warmup=1)

    first = cols[0]
    stages = {"encode_ms": stage(lambda: rf.encode_columns(cols))}
    planes = rf.encode_columns(cols)
    live = bm.row_mask_bool(first.capacity, first.length, dev)
    stages["pack_readback_ms"] = stage(lambda: rp.packed_words(planes, live))
    words = rp.packed_words(planes, live)
    layout = []
    for w in words:
        lo, hi = int(w.min()), int(w.max())
        layout.append("raw 64-bit" if lo < 0 else f"{hi.bit_length()} bits")
    n_words = len(words)
    del words
    stages["sort_permutation_ms"] = stage(lambda: rp.sort_permutation(
        planes, first.capacity, first.length))
    stages["sort_pass_device_ms (least significant word first)"] = \
        sort_passes_ms(lambda: pe.lexsort_step(cols), n_words)
    del planes, live
    row = {"rows": LEXSORT_ROWS, "step_ms": step_ms, "stages": stages,
           "words": layout, "inputs_gb": inputs / 1e9,
           "peak_gib": peak / 2**30, "held_before_gib": held / 2**30,
           "rows_per_s": LEXSORT_ROWS / step_ms * 1e3}
    log(f"lexsort timing: {row}")
    log(f"lexsort profile: "
        f"{profile(lambda: pe.lexsort_step(cols), reps=3)}")
    return row


@contextlib.contextmanager
def recorded(mod, attr):
    """While active, every call of mod.<attr> is kept: yields a list that
    gets (args, result) of each call."""
    fn, calls = getattr(mod, attr), []

    def kept(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    setattr(mod, attr, kept)
    try:
        yield calls
    finally:
        setattr(mod, attr, fn)


def dense_library(key, key_validity, kmin, off, nb, n, values):
    """The PyTorch library calls that compute dense_agg's outputs on a key
    and values without nulls: bincount + index_add_ + two scatter_reduce,
    one sequence."""
    if key_validity is not None or any(ok is not None for _, ok in values):
        raise ValueError("the library sequence takes no validity")
    b = key[:n].to(torch.int64) - kmin.reshape(()) + off
    rows = torch.bincount(b, minlength=nb)
    out = []
    for v, _ in values:
        x = v[:n].to(torch.int64)
        out.append(torch.stack([
            rows, torch.zeros(nb, dtype=torch.int64, device=b.device
                              ).index_add_(0, b, x),
            torch.full((nb,), torch.iinfo(torch.int64).max, device=b.device
                       ).scatter_reduce_(0, b, x, "amin"),
            torch.full((nb,), torch.iinfo(torch.int64).min, device=b.device
                       ).scatter_reduce_(0, b, x, "amax")]))
    return rows, torch.stack(out)


def batches_equal(a, b) -> bool:
    """Two port batches with the same names, lengths, values and
    validity, bit for bit."""
    return a.schema == b.schema and a.length == b.length and all(
        torch.equal(x.values, y.values)
        and (x.validity is None) == (y.validity is None)
        and (x.validity is None or torch.equal(x.validity, y.validity))
        for x, y in zip(a.columns, b.columns))


def agg_phase(pe, k1, dk, build, dev, floor_bytes_per_s):
    """Phase 12: BASELINE config 4 at 8,000,000 rows, both cardinalities.
    -> (the launch counts of each case's step, the dense kernel's row, K1's
    rows at the high-cardinality step's group extraction)."""
    from arrowtpu_torch.ops import groupby as gb

    launches, dense_row, k1_rows = {}, None, []
    for label, cardinality, engine, buckets in AGG_CASES:
        t0 = time.perf_counter()
        arrays = pe.example_agg_arrays(AGG_ROWS, cardinality)
        want = pe.agg_oracle(arrays)
        batch = pe.batch_from_numpy(arrays, device=dev)
        plan = pe.agg_plan(batch)
        log(f"config 4 {label} ({cardinality} keys, {AGG_ROWS} rows): plan "
            f"engine {plan.engine}, {plan.buckets} buckets; data and oracle "
            f"in {time.perf_counter() - t0:.1f} s")
        if (plan.engine, plan.buckets) != (engine, buckets):
            raise AssertionError(f"config 4 {label}: the plan chose "
                                 f"{plan.engine} at {plan.buckets} buckets, "
                                 f"the reference {engine} at {buckets}")
        torch.cuda.synchronize()
        args = {}
        with held_to_plain({"K1": k1}, args) as calls, \
                recorded(dk, "dense_aggregate") as dense_calls:
            k1.launches = dk.launches = 0
            build.count_launches = 0
            out = pe.agg_step(plan, batch)
            torch.cuda.synchronize()
            run = {"K1": k1.launches, "dense_agg": dk.launches,
                   "tile_counts": build.count_launches}
        launches[label] = run
        expect = ({"dense_agg": 1, "K1": 0} if engine == "dense"
                  else {"dense_agg": 0})
        if any(run[k] != v for k, v in expect.items()) or (
                engine == "sort" and run["K1"] <= 0):
            raise AssertionError(f"config 4 {label}: launches {run}, "
                                 f"expected {expect} (and K1 > 0 on the "
                                 "sort pipeline)")
        groups = pe.check_agg(out, want)
        for d_args, got in dense_calls:
            plain = dk.dense_aggregate_plain(*d_args)
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"config 4 {label}: dense_agg differs "
                                     "from its plain version on the step")
        unplanned = gb.group_by(batch, ["k"], pe.AGG_AGGS)
        if not batches_equal(unplanned, out):
            raise AssertionError(f"config 4 {label}: group_by differs from "
                                 "the plan's output")
        log(f"config 4 {label}: {groups} groups exact against the numpy "
            f"oracle (keys, sums, counts, mins); launches {run}; K1 calls "
            f"held to plain (P, n, kept, out_rows): {calls['K1']}; "
            f"{len(dense_calls)} dense_agg call(s) bit-exact against "
            "dense_aggregate_plain; unplanned group_by equal to the plan")

        times = run_times_ms(lambda: pe.agg_step(plan, batch))
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        pe.agg_step(plan, batch)
        peak = torch.cuda.max_memory_allocated()
        step = {"step_ms": statistics.median(times), "min_ms": times[0],
                "max_ms": times[-1], "reps": len(times),
                "group_by_unplanned_ms": median_ms(
                    lambda: gb.group_by(batch, ["k"], pe.AGG_AGGS)),
                "peak_gib": peak / 2**30, "held_before_gib": held / 2**30,
                "rows_per_s": AGG_ROWS / statistics.median(times) * 1e3}
        log(f"config 4 {label} timing: {step}")
        log(f"config 4 {label} profile: "
            f"{profile(lambda: pe.agg_step(plan, batch))}")

        if engine == "sort":
            extraction = group_by_calls(args, run["tile_counts"],
                                        f"config 4 {label}")
            k1_rows = [dict(row, config4=label) for row in
                       time_k1_group_calls(k1, f"config 4 {label}",
                                           extraction)]
            continue
        (d_args, got), = dense_calls
        key, key_validity, kmin, off, nb, n, values = d_args
        bitmaps = [ok for ok in [key_validity] + [ok for _, ok in values]
                   if ok is not None]
        nbytes = (n * key.element_size()
                  + sum(n * v.element_size() for v, _ in values)
                  + len(bitmaps) * -(-n // 8)
                  + (1 + 4 * len(values)) * nb * 8)
        err = max(int((a - b).abs().max())
                  for a, b in zip(got, dk.dense_aggregate_plain(*d_args)))
        dense_row = {
            "ms": cold_ms(lambda: dk.dense_aggregate(*d_args)),
            "warm_ms": warm_ms(lambda: dk.dense_aggregate(*d_args)),
            "plain_ms": cold_ms(lambda: dk.dense_aggregate_plain(*d_args)),
            "library_ms": cold_ms(lambda: dense_library(*d_args)),
            "library": "bincount + index_add_ + 2 scatter_reduce, one "
                       "sequence",
            "bound_ms": bytes_bound_ms(nbytes), "bound_by": "bytes",
            "floor_ms": nbytes / floor_bytes_per_s * 1e3,
            "max_abs_err": float(err),
            "shape": f"n={n} int32 key -> {nb} buckets, "
                     f"{len(values)} int64 value column(s), "
                     f"{nbytes} bytes"}
        if err:
            raise AssertionError("dense_agg differs at the main shape")
        log(f"  dense_agg at config 4 {label}: {dense_row}")
        del dense_calls
    return launches, dense_row, k1_rows


# ---------------------------------------------------------------------------
# phase 13: TPC-H Q6 over lineitem; phase 14: the nested classes
# ---------------------------------------------------------------------------

Q6_SF = 10  # 60M rows, the whole of lineitem at SF10 on one card
Q6_REPS = 10
TAKE_IDS = 1_000_000
NESTED_ROWS = 8_000_000  # BASELINE config 1's rows
NESTED_TAKE_IDS = 4_000_000


def _host(t):
    return t.cpu().numpy()


def check_gather(out, src, rows, ok, what, bm, col):
    """A filter's or take's output column against a numpy gather of its
    input's own arrays: output row r is input row rows[r] (clipped), valid
    where the input row is and ok[r]; values under nulls included; zero
    padding past the length; shared children and arenas are the same
    objects.  Recursive over the nested classes."""
    n = len(rows)
    if out.length != n:
        raise AssertionError(f"{what}: length {out.length}, expected {n}")

    def same(got, want, name):
        g = _host(got)
        if not np.array_equal(g[:n], want):
            raise AssertionError(f"{what}: {name} differs from numpy")
        if g[n:].any():
            raise AssertionError(f"{what}: {name} padding not zero")

    src_ok = (np.ones(src.capacity, bool) if src.validity is None
              else bm.to_numpy_bools(src.validity, src.capacity))
    want_ok = src_ok[rows] & ok
    if out.validity is None:
        if not want_ok.all():
            raise AssertionError(f"{what}: no bitmap, but null rows")
    else:
        same(bm.unpack(out.validity), want_ok, "validity")
    if isinstance(src, col.StructColumn):
        for i, (a, b) in enumerate(zip(out.children, src.children)):
            check_gather(a, b, rows, ok, f"{what}.{i}", bm, col)
    elif isinstance(src, col.FixedSizeListColumn):
        k = src.dtype.size
        check_gather(out.child, src.child,
                     (rows[:, None] * k + np.arange(k)).ravel(),
                     np.repeat(ok, k), f"{what}.child", bm, col)
    elif isinstance(src, col.ListViewColumn):
        same(out.starts, _host(src.starts)[rows], "starts")
        same(out.sizes, _host(src.sizes)[rows], "sizes")
        if out.child is not src.child:
            raise AssertionError(f"{what}: the child is not shared")
    elif isinstance(src, col.StringViewColumn):
        same(out.views, _host(src.views)[rows], "views")
        if out.arena is not src.arena:
            raise AssertionError(f"{what}: the arena is not shared")
    elif isinstance(src, col.BooleanColumn):
        same(bm.unpack(out.values), _host(bm.unpack(src.values))[rows],
             "values")
    else:
        same(out.values, _host(src.values)[rows], "values")


def q6_stages(pe, ops, batch):
    """The Q6 step's stages, each timed alone (CUDA events, median)."""
    from arrowtpu_torch.ops import decimal as dec
    from arrowtpu_torch.ops import filter as flt

    mask = pe.q6_predicate(batch)
    plan = flt.build_plan(mask)
    kept = flt.filter_record_batch(batch, mask)

    def revenue():
        product = dec.mul(kept["l_extendedprice"], kept["l_discount"])
        return dec.to_decimal(dec.sum_(product)[0], product.dtype.scale)

    reps = dict(reps=Q6_REPS, warmup=2)
    return {"predicate_ms": median_ms(lambda: pe.q6_predicate(batch), **reps),
            "plan_ms": median_ms(lambda: flt.build_plan(mask), **reps),
            "filter_ms": median_ms(
                lambda: flt._apply(batch.columns, plan), **reps),
            "revenue_ms": median_ms(revenue, **reps)}, mask, plan


def q6_phase(pe, ops, k1, k2, build, dev, floor_bytes_per_s):
    """Phase 13: TPC-H Q6 over lineitem at SF10.  -> (the launches of the
    step, the 16-byte K1 row, the lineitem arrays and batch, which phase
    15 reuses)."""
    from arrowtpu_torch.core import bitmap as bm
    from arrowtpu_torch.core import column as col
    from arrowtpu_torch.ops import filter as flt

    t0 = time.perf_counter()
    arrays = pe.example_lineitem_arrays(Q6_SF, 6)
    n = len(arrays["l_orderkey"])
    t_gen = time.perf_counter() - t0
    want = pe.q6_oracle(arrays)
    t_oracle = time.perf_counter() - t0 - t_gen
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    batch = pe.lineitem_batch(arrays, device=dev)
    torch.cuda.synchronize()
    batch_gib = (torch.cuda.memory_allocated() - held_before) / 2**30
    log(f"Q6: lineitem at SF{Q6_SF}, {n} rows: drawn in {t_gen:.1f} s, "
        f"oracle {t_oracle:.1f} s, batch on the card in "
        f"{time.perf_counter() - t0 - t_gen - t_oracle:.1f} s "
        f"({batch_gib:.2f} GiB, {batch_gib * 2**30 / n:.1f} bytes a row)")

    args = {}
    with held_to_plain({"K1": k1}, args) as calls, \
            build.launch_words() as words:
        k1.launches = k2.launches = 0
        build.count_launches = 0
        out = pe.q6_step(batch)
        torch.cuda.synchronize()
        run = {"K1": k1.launches, "K2": k2.launches,
               "tile_counts": build.count_launches,
               **{f"{k}_{w}": words.count((k, w))
                  for k, w in sorted(set(words))}}
    for w in (4, 8, 16):
        run.setdefault(f"K1_{w}", 0)
    if not (run["K1_16"] >= 1 and run["K1_8"] >= 1 and run["K1_4"] >= 1):
        raise AssertionError(f"Q6: K1 launches by word size {run}, expected "
                             "16-, 8- and 4-byte words")
    kept = pe.check_q6(out, arrays, want)
    log(f"Q6: exact against q6_oracle, {kept} rows kept ({kept / n:.3%}), "
        f"all 16 columns and the revenue {out[1]}; launches {run}; every K1 "
        f"call held to plain (P, n, kept, out_rows or row words): "
        f"{calls['K1']}")

    stages, mask, plan = q6_stages(pe, ops, batch)
    # what feeds K1: the plan's planes reach it as views, so the filter
    # past its plan runs K1 alone (no transpose, no copy)
    moved = device_kernel_names(lambda: flt._apply(batch.columns, plan))
    extra = [nm for nm in moved if "tile_compact_kernel" not in nm]
    if any("transpose" in nm.lower() or "copy" in nm.lower() for nm in moved):
        raise AssertionError(f"Q6: a transpose or copy kernel feeds K1: "
                             f"{moved}")
    log(f"Q6: the filter past its plan runs {moved} (other kernels: "
        f"{extra}); the plan runs "
        f"{device_kernel_names(lambda: flt.build_plan(mask))}")

    times = run_times_ms(lambda: pe.q6_step(batch), reps=Q6_REPS, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pe.q6_step(batch)
    peak = torch.cuda.max_memory_allocated()
    step = {"step_ms": statistics.median(times), "min_ms": times[0],
            "max_ms": times[-1], "reps": len(times), **stages,
            "rows": n, "kept": kept, "rows_per_s":
            n / statistics.median(times) * 1e3,
            "peak_gib": peak / 2**30, "held_before_gib": held / 2**30}
    log(f"Q6 timing: {step}")
    log(f"Q6 profile: {profile(lambda: pe.q6_step(batch), reps=3)}")

    # K1's 16-byte launch at its call shape on the step
    (call,) = [c for c in args["K1"] if build.word_bytes(c.planes[0]) == 16]
    planes, keep, offs = list(call.planes), call.keep, call.offs
    rows = call.out_rows
    stacked = torch.stack(planes)
    row = time_kernel("K1 16-byte words, Q6 filter",
                      lambda: k1.compact_planes(planes, keep, offs, rows),
                      lambda: k1.compact_planes_plain(planes, keep, rows),
                      lambda: stacked[:, keep], planes, keep, rows)
    del stacked
    nbytes = (keep.shape[0] + 16 * len(planes) * (int(keep.sum()) + rows))
    row.update(launches=run["K1_16"], floor_ms=nbytes / floor_bytes_per_s
               * 1e3, shape=f"P={len(planes)} x n={keep.shape[0]} x 16 B "
               f"-> {rows} rows, kept {int(keep.sum())}")
    from arrowtpu_torch.probes import fresh_call

    want = k1.compact_planes_plain(planes, keep, rows)
    err = 0
    for o in (offs, None):  # both frames, on poisoned outputs
        got = fresh_call(lambda: k1.compact_planes(planes, keep, o, rows),
                         want)
        torch.cuda.synchronize()
        err = max([err] + [int((a.to(torch.int64) - b.to(torch.int64)
                                ).abs().max()) for a, b in zip(got, want)])
    del want, got
    if err:
        raise AssertionError("K1 16-byte: differs at the Q6 call")
    row["max_abs_err"] = float(err)
    kept16 = int(keep.sum())
    row["sector_floor_ms"] = bytes_bound_ms(
        keep.shape[0] + 32 * len(planes) * kept16 + 16 * len(planes) * rows)
    log(f"  K1 16-byte at the Q6 call: both frames bit-exact against plain; "
        f"bound at the copy floor {row['floor_ms']:.4f} ms, sector floor "
        f"{row['sector_floor_ms']:.4f} ms")
    row["stages"] = k1_16_stages(planes, keep, offs, rows)
    for density in (0.5, 0.96):  # the same planes, denser masks
        dense = torch.rand(keep.shape[0], device=dev) < density
        offs_d = k1.tile_offsets(dense)
        cnt = int(offs_d[-1])
        out_rows = -(-cnt // 64) * 64
        bound = bytes_bound_ms(keep.shape[0]
                               + 16 * len(planes) * (cnt + out_rows))
        log(f"  K1 16-byte at {density:.0%} kept: "
            f"{cold_ms(lambda: k1.compact_planes(planes, dense, offs_d, out_rows)):.4f}"
            f" ms, bound {bound:.4f} ms")

    # take_record_batch: 1M uniform ids, 1 % null, 1 % past the end
    rng = np.random.default_rng(7)
    ids = rng.integers(0, n, TAKE_IDS)
    ids[rng.random(TAKE_IDS) < 0.01] = n + 5
    id_ok = rng.random(TAKE_IDS) > 0.01
    index = col.primitive(ids, validity=id_ok, device=dev)
    taken = ops.take_record_batch(batch, index)
    ok = id_ok & (ids < n)
    rows_idx = np.minimum(ids, batch.capacity - 1)
    for name in pe.LINEITEM_COLUMNS:
        c = batch[name]
        check_gather(taken[name].keys if isinstance(c, col.DictionaryColumn)
                     else taken[name],
                     c.keys if isinstance(c, col.DictionaryColumn) else c,
                     rows_idx, ok, f"take {name}", bm, col)
    take_ms = median_ms(lambda: ops.take_record_batch(batch, index),
                        reps=Q6_REPS, warmup=2)
    log(f"Q6 batch take_record_batch: {TAKE_IDS} ids (1 % null, 1 % past "
        f"the end), exact against a numpy gather of every column; "
        f"{take_ms:.3f} ms")
    del taken, out
    return run, row, arrays, batch


def k1_16_stages(planes, keep, offs, rows) -> dict:
    """K1's 16-byte word at one call cut after each stage (kernels/probes.py
    compaction_stages: rank, kept, full, given the call's tile offsets),
    for compact16_kernel ("k1") and the tile body it replaced ("k1_tile"),
    each held to its plain stage (rank's tile counts; kept's first `count`
    rows; full) and timed (cold_ms) beside the stage's bytes at 3.35 TB/s:
    rank reads the mask; kept also reads and writes the kept words; full
    also writes the rest of the rows.  -> {"kernel stage": ms}."""
    from arrowtpu_torch.kernels import probes as kp

    stacked = torch.stack(planes)
    n, P, count = keep.shape[0], len(planes), int(keep.sum())
    nbytes = {"rank": n, "kept": n + 32 * P * count,
              "full": n + 16 * P * (count + rows)}
    saved = kp.launches["stages_k1"]
    out = {}
    for kernel in kp.KERNELS16:
        for stage in kp.STAGES16:
            def fn():
                return kp.compaction_stages(stacked, keep, stage, kernel,
                                            rows, offs)

            got, aux = fn()
            want, waux = kp.compaction_stages_plain(stacked, keep, stage,
                                                    kernel, rows)
            torch.cuda.synchronize()
            ok = (torch.equal(aux, waux) if stage == "rank" else
                  torch.equal(got[:, :count], want[:, :count])
                  if stage == "kept" else torch.equal(got, want))
            if not ok:
                raise AssertionError(f"K1 16-byte stage {kernel} {stage}: "
                                     "differs from its plain version")
            del got, want
            ms = cold_ms(fn)
            out[f"{kernel} {stage}"] = ms
            log(f"  K1 16-byte stage {kernel} {stage}: {ms:.4f} ms, bytes "
                f"bound {bytes_bound_ms(nbytes[stage]):.4f} ms")
    # the kept stage at one plane: the gather's share grows with the kept
    # words
    one = stacked[:1]
    got, _ = kp.compaction_stages(one, keep, "kept", "k1", rows, offs)
    want, _ = kp.compaction_stages_plain(one, keep, "kept", "k1", rows)
    torch.cuda.synchronize()
    if not torch.equal(got[:, :count], want[:, :count]):
        raise AssertionError("K1 16-byte stage k1 kept P=1: differs from its "
                             "plain version")
    del got, want
    ms = cold_ms(lambda: kp.compaction_stages(one, keep, "kept", "k1", rows,
                                              offs))
    out["k1 kept P=1"] = ms
    log(f"  K1 16-byte stage k1 kept P=1: {ms:.4f} ms, bytes bound "
        f"{bytes_bound_ms(n + 32 * count):.4f} ms")
    kp.launches["stages_k1"] = saved
    del stacked, one
    return out


Q1_REPS = 5  # 10 before phases 16-17 were added
COMMENT_SF = 1  # the string sort check: SF1's l_comment, about 6M rows
COMMENT_REPS = 5


def q1_stages(pe, ops, batch):
    """The Q1 step's stages, each timed alone (CUDA events, median): the
    predicate, the plan, the filter past its plan, the two prices, the
    group-by and, inside it, the key encode, the key sort, the gathers of
    the value rows (`gather_rows`, and beside it PyTorch's indexing of the
    same rows) and the limb prefix sums (K1's extraction is timed by its
    calls), then the final sort."""
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.ops import filter as flt
    from arrowtpu_torch.ops.take import gather_rows
    from arrowtpu_torch.rowformat import encode as rf
    from arrowtpu_torch.rowformat import pack as rp

    sub = bt.record_batch({n: batch[n] for n in pe.Q1_READS})
    mask = pe.q1_predicate(batch)
    plan = flt.build_plan(mask)
    kept = flt.filter_record_batch(sub, mask)
    prices = pe.q1_prices(kept)
    grouped = pe.q1_group(kept, *prices)
    keys = [kept[k] for k in pe.Q1_KEYS]
    cap, n = kept.capacity, kept.length

    def encode():
        return [p for c in keys for p in rf.encode_column(c)]

    planes = encode()
    live = torch.arange(cap, device=planes[0].device) < n
    words = len(rp.packed_words(planes, live))
    if words != 1:
        raise AssertionError(f"Q1's flag keys pack to {words} sort words")
    perm = rp.sort_permutation(planes, cap, n)
    values = [kept["l_quantity"], kept["l_extendedprice"], prices[0],
              prices[1], kept["l_discount"]]

    def gathers():
        return [gather_rows(v.values, perm) for v in values]

    rows = gathers()

    def sums():
        return [torch.where(live, r[:, j].to(torch.int64) & 0xFFFFFFFF,
                            0).cumsum(0)
                for r in rows for j in range(r.shape[1])]

    reps = dict(reps=Q1_REPS, warmup=2)
    return {"predicate_ms": median_ms(lambda: pe.q1_predicate(batch), **reps),
            "plan_ms": median_ms(lambda: flt.build_plan(mask), **reps),
            "filter_ms": median_ms(
                lambda: flt._apply(sub.columns, plan), **reps),
            "prices_ms": median_ms(lambda: pe.q1_prices(kept), **reps),
            "group_by_ms": median_ms(lambda: pe.q1_group(kept, *prices),
                                     **reps),
            "group_by_encode_ms": median_ms(encode, **reps),
            "group_by_sort_words": words,
            "group_by_sort_ms": median_ms(
                lambda: rp.sort_permutation(planes, cap, n), **reps),
            "group_by_value_gathers_ms": median_ms(gathers, **reps),
            # the same rows by PyTorch's own indexing of (n, 4) int32 rows
            "group_by_value_gathers_by_indexing_ms": median_ms(
                lambda: [v.values[perm] for v in values], **reps),
            "group_by_sums_ms": median_ms(sums, **reps),
            "final_sort_ms": median_ms(
                lambda: ops.sort_batch(grouped, pe.Q1_KEYS), **reps)}


def comment_sort(pe, dev):
    """sort_to_indices of SF1's l_comment (10-43 bytes: L = 48, so the
    grouped sort runs, a 16-byte prefix and refinement groups) against
    numpy's stable argsort of the same bytes as an S43 array; timed.
    -> its line."""
    from arrowtpu_torch.ops import sortmod as srt
    from arrowtpu_torch.rowformat import pack as rp

    t0 = time.perf_counter()
    pool, starts, lengths = pe.example_lineitem_arrays(COMMENT_SF,
                                                       6)["l_comment"]
    n = len(starts)
    c = pe.string_view_from_numpy(pool, starts, lengths, device=dev)
    idx = starts[:, None] + np.arange(43)
    raw = np.where(np.arange(43) < lengths[:, None],
                   pool[np.minimum(idx, len(pool) - 1)], 0).astype(np.uint8)
    want = np.argsort(raw.view("S43").ravel(), kind="stable")
    del idx, raw
    t_host = time.perf_counter() - t0
    with recorded(rp, "sort_by_plane_groups") as grouped:
        got = srt.sort_to_indices(c)
        torch.cuda.synchronize()
    if len(grouped) != 1 or len(grouped[0][0][0]) < 2:
        raise AssertionError(f"l_comment: the grouped sort ran "
                             f"{len(grouped)} times")
    groups = [len(g) for g in grouped[0][0][0]]
    if got.length != n or not np.array_equal(
            got.values[:n].cpu().numpy(), want):
        raise AssertionError("l_comment: sort_to_indices differs from "
                             "numpy's stable argsort")
    times = run_times_ms(lambda: srt.sort_to_indices(c), reps=COMMENT_REPS,
                         warmup=1)
    line = {"rows": n, "len_bound": c.len_bound, "plane_groups": groups,
            "sort_ms": statistics.median(times), "min_ms": times[0],
            "max_ms": times[-1], "reps": len(times),
            "host_argsort_s": t_host}
    log(f"l_comment sort at SF{COMMENT_SF}: equal to numpy's stable argsort "
        f"of S43 bytes; {line}")
    return line


def q1_phase(pe, ops, k1, k2, build, dev, arrays, batch):
    """Phase 15: TPC-H Q1 over phase 13's SF10 lineitem, then the string
    sort check.  -> (the launches of the step, K1's rows at its calls)."""

    t0 = time.perf_counter()
    want = pe.q1_oracle(arrays)
    t_oracle = time.perf_counter() - t0
    n = batch.length
    args = {}
    with held_to_plain({"K1": k1}, args) as calls, \
            build.launch_words() as words:
        k1.launches = k2.launches = 0
        build.count_launches = 0
        out = pe.q1_step(batch)
        torch.cuda.synchronize()
        run = {"K1": k1.launches, "K2": k2.launches,
               "tile_counts": build.count_launches,
               **{f"{k}_{w}": words.count((k, w))
                  for k, w in sorted(set(words))}}
    rows = pe.check_q1(out, arrays, want)
    callers = by_caller(args, build)
    check_q1_k1_calls(callers, "Q1")
    extraction = group_by_calls(args, run["tile_counts"], "Q1")
    log(f"Q1: exact against q1_oracle ({t_oracle:.1f} s on the host), "
        f"{out.length} groups {want['keys']}, {rows} of {n} rows kept "
        f"({rows / n:.3%}), counts {want['count_order']}; launches {run}; "
        f"K1 calls by module and word bytes {callers}; every K1 call "
        f"held to plain (P, n, kept, out_rows): {calls['K1']}")
    log(f"Q1 output: {out.to_pydict()}")

    # K1 at the step's filter call (16-byte words, the plan's offsets) and
    # at its group-by calls, replayed on their operands; then the operands
    # go, before the step is timed
    (call,) = [c for c in args["K1"]
               if c.caller == "arrowtpu_torch.ops.filter"]
    planes, keep, offs, out_rows = (list(call.planes), call.keep, call.offs,
                                    call.out_rows)
    stacked = torch.stack(planes)
    row = time_kernel("K1 16-byte words, Q1 filter",
                      lambda: k1.compact_planes(planes, keep, offs, out_rows),
                      lambda: k1.compact_planes_plain(planes, keep, out_rows),
                      lambda: stacked[:, keep], planes, keep, out_rows)
    del stacked, planes, keep, offs, call
    row.update(launches=1, max_abs_err=0.0, call="Q1 filter")
    k1_rows = [row] + [dict(r, call="Q1 group-by extraction") for r in
                       time_k1_group_calls(k1, "Q1 group-by", extraction)]
    del args, out, calls, extraction
    torch.cuda.empty_cache()

    stages = q1_stages(pe, ops, batch)
    times = run_times_ms(lambda: pe.q1_step(batch), reps=Q1_REPS, warmup=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    pe.q1_step(batch)
    peak = torch.cuda.max_memory_allocated()
    step = {"step_ms": statistics.median(times), "min_ms": times[0],
            "max_ms": times[-1], "reps": len(times), **stages,
            "rows": n, "kept": rows, "rows_per_s":
            n / statistics.median(times) * 1e3,
            "peak_gib": peak / 2**30, "held_before_gib": held / 2**30,
            "step_adds_gib": (peak - held) / 2**30}
    log(f"Q1 timing: {step}")
    log(f"Q1 profile: {profile(lambda: pe.q1_step(batch), reps=3)}")
    comment = comment_sort(pe, dev)
    return run, k1_rows, step, comment, want


def nested_batch(n, dev, rng):
    """Phase 14's batch: list_view<int64> (sizes 0-7), struct<i: int32, s:
    utf8> (strings of 0-20 bytes), fixed_size_list<float32, 4>, bool; 10 %
    nulls on every top-level column and on the struct's children."""
    from arrowtpu_torch import schema as st
    from arrowtpu_torch.core import column as col
    from arrowtpu_torch.interop.numpy_bridge import string_view_from_numpy

    def valid():
        return rng.random(n) > 0.1

    sizes = rng.integers(0, 8, n).astype(np.int32)
    starts = (np.cumsum(sizes, dtype=np.int64) - sizes).astype(np.int32)
    child = col.primitive(rng.integers(-2**40, 2**40, int(sizes.sum())),
                          device=dev)
    cap = -(-n // 64) * 64

    def padded(a):
        out = np.zeros(cap, a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    from arrowtpu_torch.core import bitmap as bm
    lv = col.ListViewColumn(padded(starts), padded(sizes), child,
                            bm.from_numpy_bools(valid(), cap, dev), n,
                            st.List(st.int64))
    pool = rng.integers(97, 123, 1 << 20).astype(np.uint8)
    slen = rng.integers(0, 21, n)
    s_ok = valid()
    strs = string_view_from_numpy(pool, rng.integers(0, len(pool) - 21, n),
                                  slen, s_ok, device=dev)
    ints = col.primitive(rng.integers(-10**9, 10**9, n).astype(np.int32),
                         validity=valid(), device=dev)
    struct = col.StructColumn((ints, strs), bm.from_numpy_bools(
        valid(), cap, dev), n, st.Struct((st.Field("i", st.int32),
                                          st.Field("s", st.utf8))))
    fl = col.FixedSizeListColumn(
        col.primitive(torch.from_numpy(np.pad(
            rng.standard_normal(n * 4).astype(np.float32),
            (0, (cap - n) * 4))).to(dev), length=n * 4),
        bm.from_numpy_bools(valid(), cap, dev), n,
        st.FixedSizeList(st.float32, 4))
    b = col.boolean(rng.random(n) < 0.5, validity=valid(), device=dev)
    from arrowtpu_torch.core import batch as bt
    return bt.record_batch({"lv": lv, "st": struct, "fl": fl, "b": b})


def nested_phase(ops, k1, k2, build, dev):
    """Phase 14: the nested classes at config 1's 8M rows through
    filter_record_batch and take_record_batch.  -> the launches of the
    filter and of the take."""
    from arrowtpu_torch.core import bitmap as bm
    from arrowtpu_torch.core import column as col

    t0 = time.perf_counter()
    rng = np.random.default_rng(8)
    batch = nested_batch(NESTED_ROWS, dev, rng)
    keep = rng.random(NESTED_ROWS) < 0.5
    keep_ok = rng.random(NESTED_ROWS) > 0.1
    mask = col.boolean(keep, validity=keep_ok, device=dev)
    torch.cuda.synchronize()
    with held_to_plain({"K1": k1, "K2": k2}) as calls, \
            build.launch_words() as words:
        k1.launches = k2.launches = 0
        build.count_launches = 0
        out = ops.filter_record_batch(batch, mask)
        torch.cuda.synchronize()
        run = {"K1": k1.launches, "K2": k2.launches,
               "tile_counts": build.count_launches,
               **{f"{k}_{w}": words.count((k, w))
                  for k, w in sorted(set(words))}}
    if run["K1"] <= 0 or run["K2"] <= 0 or not (calls["K1"] and calls["K2"]):
        raise AssertionError(f"nested filter: launches {run}, K1 and K2 "
                             "must both launch")
    log(f"nested filter: every K1 and K2 call held to plain (P, n, kept, "
        f"out_rows): {calls}")
    rows = np.flatnonzero(keep & keep_ok)
    for name, c in zip(batch.schema.names, batch.columns):
        check_gather(out[name], c, rows, np.ones(len(rows), bool),
                     f"filter {name}", bm, col)
    ids = rng.integers(0, NESTED_ROWS, NESTED_TAKE_IDS)
    ids[rng.random(NESTED_TAKE_IDS) < 0.01] = NESTED_ROWS + 3
    id_ok = rng.random(NESTED_TAKE_IDS) > 0.01
    index = col.primitive(ids, validity=id_ok, device=dev)
    k1.launches = k2.launches = 0
    taken = ops.take_record_batch(batch, index)
    torch.cuda.synchronize()
    take_run = {"K1": k1.launches, "K2": k2.launches}
    ok = id_ok & (ids < NESTED_ROWS)
    for name, c in zip(batch.schema.names, batch.columns):
        check_gather(taken[name], c, np.minimum(ids, batch.capacity - 1), ok,
                     f"take {name}", bm, col)
    timing = {
        "filter_ms": median_ms(lambda: ops.filter_record_batch(batch, mask),
                               reps=Q6_REPS, warmup=2),
        "take_ms": median_ms(lambda: ops.take_record_batch(batch, index),
                             reps=Q6_REPS, warmup=2)}
    log(f"nested batch, {NESTED_ROWS} rows (list_view<int64>, struct<i, s>, "
        f"fixed_size_list<float32, 4>, bool; 10 % nulls): filter keeps "
        f"{len(rows)} rows, launches {run}; take of {NESTED_TAKE_IDS} ids "
        f"launches {take_run}; both exact against numpy gathers; {timing} "
        f"({time.perf_counter() - t0:.1f} s)")
    return run



# ---------------------------------------------------------------------------
# phase 27: JSONBench's Bluesky events as a shredded Variant column
# 524,288 of JSONBench's 1,000,000 documents (entry.JSONBENCH_DOCS): the
# only cut, for the host's parse, encode and shred, which are Python (the
# phase took 280.7 s at 1,000,000 on the H100's host)
JSONBENCH_DOCS = 1 << 19
JSONBENCH_REPS = 3
INTEGRATION_ROWS = 65_536  # a conformance format, not a data path
CLI_BENCH_ROWS = 8_388_608
CLI_MAX_ROWS = 40  # `cat`'s default


@contextlib.contextmanager
def copies_to_card():
    """Yields a dict of the host-to-card copies made by Tensor.to while
    active: "s" (each copy synchronized), "bytes" and "calls"."""
    real, total = torch.Tensor.to, {"s": 0.0, "bytes": 0, "calls": 0}

    def to(self, *args, **kwargs):
        if self.device.type != "cpu":
            return real(self, *args, **kwargs)
        t0 = time.perf_counter()
        out = real(self, *args, **kwargs)
        if out.device.type == "cuda":
            torch.cuda.synchronize()
            total["s"] += time.perf_counter() - t0
            total["bytes"] += self.numel() * self.element_size()
            total["calls"] += 1
        return out

    torch.Tensor.to = to
    try:
        yield total
    finally:
        torch.Tensor.to = real


def typed_leaf(vc, path):
    """The typed_value column of a shredded path (its group's own)."""
    c = vc.typed_value
    for name in path:
        c = c.field(name).field("typed_value")
    return c


def cli_out(cli, argv) -> str:
    """`python -m arrowtpu_torch.cli ARGV` in this process: its stdout."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def jsonbench_phase(pe, ops, k1, k2, build, dev):
    """Phase 27: JSONBench's Bluesky events (JSONBENCH_DOCS documents,
    `example_bluesky_docs`; cut from JSONBench's 1m size for the host's
    Python parse and shred) as a Variant column on the card.  (a) The JSON
    texts parsed and encoded on the host (`batch_json_to_variant`), then
    shredded to pe.JSONBENCH_SHRED (`shred_variant`): each stage's host
    seconds, its parse and host-to-card copies apart, and the card's busy
    share.  (b) `bluesky_batch`: variant_get of the five paths, each of
    which must be the shredded typed column itself with no row decoded
    (no metadata read); commit.rkey, in the residual, by the host fallback,
    equal to the texts.  (c) JSONBench's five queries (`jsonbench_step`)
    exact against `jsonbench_oracle` (Python's json and plain Python), the
    launch counts set to 0 around each, every K1 / K2 / dense_agg call held
    to plain, K1 in Q2-Q5 at 16 bytes (the views) and 8 bytes in Q2-Q5's
    filters that move time_us; each query's ms (CUDA events, median of
    JSONBENCH_REPS).  (d) The shredded column through Parquet
    (`write_parquet`, a VARIANT-annotated group) read back onto the card
    into a VariantColumn: variant_get's five columns again by the columnar
    path, equal to (b)'s on the card, and Q1 on them exact; `rowcount`,
    `schema` and `cat` of `python -m arrowtpu_torch.cli` over the file
    against the batch written.  (e) The first INTEGRATION_ROWS rows of
    (b)'s batch as an archery JSON file, `json-integration` JSON_TO_ARROW
    then VALIDATE (equal_batches on the card), and the file read back equal
    to those rows; `cli bench --rows CLI_BENCH_ROWS` on the card (its K1 /
    K2 calls held to plain on one run, its line from another); a
    FixedShapeTensor (2, 2) over phase 14's fixed_size_list<float32, 4>
    column as a Tensor (n, 2, 2) on the card, equal to numpy's reshape,
    and with the permutation (1, 0) to numpy's transpose.  -> ({path:
    launches}, {part: line})."""
    import os
    import shutil
    import tempfile

    from arrowtpu_torch import cli, extension, integration, tensor, variant
    from arrowtpu_torch import schema as st
    from arrowtpu_torch.core import batch as bt
    from arrowtpu_torch.formats import parquet
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.utils.pretty import pretty_format_batches
    from arrowtpu_torch.variant import get as vget
    from arrowtpu_torch.variant import json as vjson

    n = JSONBENCH_DOCS
    launches, lines = {}, {}
    texts, draw_s = host_s(lambda: pe.example_bluesky_docs(n))
    text_bytes = sum(len(t) for t in texts)
    log(f"jsonbench: {n} Bluesky documents drawn in {draw_s:.2f} s, "
        f"{text_bytes} bytes of JSON text")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    # (a) parse and encode, then shred, on the host; the columns uploaded
    with stage_seconds(vjson, "json_to_variant", sync=False) as parse, \
            copies_to_card() as up1:
        vc, encode_s, encode_busy = profiled_once(
            lambda: variant.batch_json_to_variant(texts, dev))
    arena_bytes = sum(c.arena.numel() + c.views.numel() * 4
                      for c in (vc.metadata, vc.value))
    with copies_to_card() as up2:
        sh, shred_s, shred_busy = profiled_once(
            lambda: variant.shred_variant(vc, pe.JSONBENCH_SHRED))
    del vc
    lines["shred"] = {
        "docs": n, "json_text_bytes": text_bytes,
        "variant_arena_bytes": arena_bytes, "draw_s": draw_s,
        "json_to_variant_s": encode_s, "parse_s": parse["s"],
        "encode_s": encode_s - parse["s"] - up1["s"], "upload_s": up1["s"],
        "upload_bytes": up1["bytes"], "busy_share": encode_busy,
        "shred_variant_s": shred_s, "shred_upload_s": up2["s"],
        "shred_upload_bytes": up2["bytes"],
        "shred_host_s": shred_s - up2["s"], "shred_busy_share": shred_busy}
    log(f"jsonbench (a): {json.dumps(lines['shred'])}")

    # (b) the five columns by the columnar path, rkey by the fallback
    with stage_seconds(vget, "MetadataNames", sync=False) as meta_reads, \
            counted(k1, k2, build, dk) as run:
        batch, get_s = host_s(lambda: pe.bluesky_batch(sh))
    if meta_reads["calls"]:
        raise AssertionError("variant_get decoded rows on a shredded path")
    for name, (path, _) in pe.JSONBENCH_COLUMNS.items():
        leaf = typed_leaf(sh, path)
        if batch[name] is not leaf:
            raise AssertionError(f"variant_get of {path}: not the typed "
                                 "column itself")
    launches["JSONBench variant_get"] = run
    with stage_seconds(vget, "MetadataNames", sync=False) as meta_reads:
        rkey, rkey_s = host_s(lambda: vget.variant_get(
            sh, ["commit", "rkey"], as_dtype=st.utf8))
    want_rkey = []
    for t in texts:
        at = t.find('"rkey":"')
        want_rkey.append(None if at < 0 else t[at + 8:t.index('"', at + 8)])
    if meta_reads["calls"] != 1 or rkey.to_pylist() != want_rkey:
        raise AssertionError("variant_get of commit.rkey (the residual) "
                             "differs from the documents")
    lines["variant_get"] = {"columnar_s": get_s, "residual_rkey_s": rkey_s,
                            "launches": run}
    log(f"jsonbench (b): the five columns are the shredded typed columns "
        f"(no row decoded); commit.rkey by the host fallback equal to the "
        f"texts; {json.dumps(lines['variant_get'])}")
    del rkey, want_rkey

    # (c) the five queries
    want, oracle_s = host_s(lambda: pe.jsonbench_oracle(texts))
    ms, callers = {}, {}
    for q in sorted(pe.JSONBENCH_QUERIES):
        args = {}
        with counted(k1, k2, build, dk, args) as run:
            got = pe.jsonbench_step(batch, q)
        pe.check_jsonbench(got, want[q], q)
        if q >= 2 and not (run.get("K1_16") and run.get("K1_8")):
            raise AssertionError(f"JSONBench Q{q}: K1 must launch at 16 "
                                 f"and 8 bytes ({run})")
        launches[f"JSONBench Q{q}"] = run
        callers[q] = {f"{k}.{m}.{w}B": c for (k, m, w), c in
                      by_caller(args, build).items()}
        if run["dense_agg"]:
            callers[q]["dense_agg"] = run["dense_agg"]
        ms[q] = timed(lambda: pe.jsonbench_step(batch, q),
                      reps=JSONBENCH_REPS)
    lines["queries"] = {
        "oracle_s": oracle_s, "query_ms": ms, "launches_by_caller": callers,
        "rows": {q: len(r) for q, r in want.items()},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "held_before_gib": held / 2**30}
    log(f"jsonbench (c): Q1-Q5 exact against jsonbench_oracle; "
        f"{json.dumps(lines['queries'])}")

    # (d) through Parquet, then the CLI over the file
    written = bt.RecordBatch(st.Schema((variant.variant_field(
        "v", sh.typed_value.dtype),)), (sh.inner,))
    data, write_s = host_s(lambda: parquet.write_parquet(written))
    read, read_s = host_s(lambda: parquet.read_parquet(data, device=dev))
    back = variant.VariantColumn(read["v"])
    with stage_seconds(vget, "MetadataNames", sync=False) as meta_reads:
        scanned = pe.bluesky_batch(back)
    if meta_reads["calls"] or scanned.device != dev or \
            not bool(ops.equal_batches(scanned, batch)):
        raise AssertionError("Parquet: the scanned variant's columns "
                             "differ or were decoded")
    args = {}
    with counted(k1, k2, build, dk, args) as run:
        got = pe.jsonbench_step(scanned, 1)
    pe.check_jsonbench(got, want[1], 1)
    launches["JSONBench Q1 after Parquet"] = run
    tmp = tempfile.mkdtemp(prefix="jsonbench")
    try:
        path = os.path.join(tmp, "bluesky.parquet")
        with open(path, "wb") as f:
            f.write(data)
        first = ops.take_record_batch(written, pe.column_from_numpy(
            np.arange(CLI_MAX_ROWS), None, device=dev))
        expect = {
            "rowcount": f"{n}\n",
            "schema": "".join(f"{f.name}: {f.dtype}"
                              f"{'' if f.nullable else ' NOT NULL'}\n"
                              for f in written.schema.fields),
            "cat": pretty_format_batches(first, CLI_MAX_ROWS) + "\n"}
        cli_s = {}
        for cmd, text in expect.items():
            out, cli_s[cmd] = host_s(lambda: cli_out(cli, [cmd, path]))
            if out != text:
                raise AssertionError(f"cli {cmd}: {out[:300]!r} != "
                                     f"{text[:300]!r}")
        lines["parquet"] = {"bytes": len(data), "write_s": write_s,
                            "read_s": read_s, "cli_s": cli_s}
        log(f"jsonbench (d): the shredded column through Parquet, read "
            f"back: the five columns equal (columnar path), Q1 exact; "
            f"rowcount, schema, cat equal the batch; "
            f"{json.dumps(lines['parquet'])}")
        del read, back, scanned, written, first, data

        # (e) the integration format, cli bench, FixedShapeTensor
        head = ops.slice_batch(batch, 0, INTEGRATION_ROWS)
        jpath, apath = (os.path.join(tmp, x) for x in ("t.json", "t.arrow"))
        _, json_s = host_s(lambda: integration.write_json_file([head], jpath))
        to_arrow = cli_out(cli, ["json-integration", "--mode",
                                 "JSON_TO_ARROW", "--json", jpath, "--arrow",
                                 apath])
        valid_out = cli_out(cli, ["json-integration", "--mode", "VALIDATE",
                                  "--json", jpath, "--arrow", apath])
        _, from_json = integration.read_json_file(jpath, dev)
        if not to_arrow.startswith("wrote") or \
                valid_out.strip() != "validation OK" or \
                not bool(ops.equal_batches(from_json[0], head)):
            raise AssertionError("json-integration: the round trip differs")
        lines["integration"] = {"rows": INTEGRATION_ROWS,
                                "json_bytes": os.path.getsize(jpath),
                                "write_json_s": json_s}
        log(f"jsonbench (e): {INTEGRATION_ROWS} rows through the archery "
            f"JSON format: JSON_TO_ARROW, VALIDATE OK, equal on the card; "
            f"{json.dumps(lines['integration'])}")
        del head, from_json
    finally:
        shutil.rmtree(tmp)

    bench_argv = ["bench", "--rows", str(CLI_BENCH_ROWS)]
    args = {}
    with counted(k1, k2, build, dk, args) as run:
        cli_out(cli, bench_argv)
    if not run.get("K1_8"):
        raise AssertionError(f"cli bench: K1 did not launch at 8 bytes "
                             f"({run})")
    launches["cli bench"] = run
    bench = json.loads(cli_out(cli, bench_argv).strip().splitlines()[-1])
    if bench["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"cli bench ran on {bench['device']}")
    lines["cli_bench"] = dict(bench, launches_by_caller={
        f"{k}.{m}.{w}B": c for (k, m, w), c in by_caller(args, build).items()})
    log(f"jsonbench (e): cli bench, every K1 / K2 call held to plain: "
        f"{json.dumps(lines['cli_bench'])}")

    fl = nested_batch(NESTED_ROWS, dev, np.random.default_rng(8))["fl"]
    flat = fl.child.values[:NESTED_ROWS * 4].cpu().numpy()
    for perm, want_t in ((None, flat.reshape(-1, 2, 2)),
                         ((1, 0), flat.reshape(-1, 2, 2).transpose(0, 2, 1))):
        field = extension.extension_field("fl", extension.FixedShapeTensor(
            st.float32, (2, 2), perm))
        ext = extension.REGISTRY.lookup(field)
        t = tensor.from_fixed_shape_tensor(fl, ext)
        if t.device != dev or t.shape != (NESTED_ROWS, 2, 2) or \
                not np.array_equal(t.to_numpy(), want_t) or not torch.equal(
                    t.as_strided().cpu(), torch.from_numpy(want_t)):
            raise AssertionError(f"FixedShapeTensor (permutation {perm}): "
                                 "the Tensor differs from numpy")
    log(f"jsonbench (e): FixedShapeTensor (2, 2) over phase 14's "
        f"fixed_size_list<float32, 4> ({NESTED_ROWS} rows) as a Tensor "
        f"{t.shape} on {t.device}, equal to numpy (permutations none and "
        f"(1, 0))")
    del fl, t, flat, batch, sh
    torch.cuda.empty_cache()
    return launches, lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from arrowtpu_torch import entry as pe
    from arrowtpu_torch import ops
    from arrowtpu_torch.core import bitmap as bm
    from arrowtpu_torch.kernels import _build
    from arrowtpu_torch.kernels import compact as k2
    from arrowtpu_torch.kernels import compact2 as k3
    from arrowtpu_torch.kernels import compact3 as k1
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.kernels import probes as kp
    from arrowtpu_torch.ops import groupby as gb
    from arrowtpu_torch import probes

    dev = torch.device("cuda:0")
    card = smi_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # phase 1: build
    path, secs, build_log = _build.build()
    _build.library()
    log(f"build: {path.name} in {secs:.2f} s"
        + (" (cached)" if secs == 0 else ""))
    reports = ptxas_reports(build_log)
    labels = " ".join(label for label, _ in reports)
    for want in ("tile_compact_kernel<u8, offs, full>",
                 "tile_compact_kernel<u8, look-back, full>",
                 "compact16_kernel<offs, full>",
                 "compact16_kernel<look-back, full>",
                 "tile_compact_kernel<16 B, offs, full>",
                 "sublane_gather_kernel", "tile_gather_kernel<roundtrip",
                 "lane_roll_kernel", "dense_agg_kernel<i32 key>"):
        if want not in labels:
            raise AssertionError(f"no ptxas report of {want}")
    for label, lines in reports:
        log(f"  ptxas {label}: " + " | ".join(lines))

    # phase 2
    t0 = time.perf_counter()
    check_kernels(k1, k2, dev)
    log(f"phase 2 (kernels vs plain): {time.perf_counter() - t0:.1f} s")

    # phase 3 + 4 per cardinality
    main_runs = {}
    for card_keys in CARDINALITIES:
        t0 = time.perf_counter()
        arrays = pe.example_arrays(N_MAIN, 0, 0.1, card_keys)
        batch = pe.batch_from_numpy(arrays, device=dev)
        want = oracle(arrays)
        torch.cuda.synchronize()
        args = {}
        with held_to_plain({"K1": k1, "K2": k2}, args) as calls:
            k1.launches = 0
            k2.launches = 0
            dk.launches = 0
            _build.count_launches = 0
            out = pe.step(batch)
            torch.cuda.synchronize()
            launches = {"K1": k1.launches, "K2": k2.launches,
                        "dense_agg": dk.launches,
                        "tile_counts": _build.count_launches}
        for name in ("K1", "K2"):
            if launches[name] <= 0 or not calls[name]:
                raise AssertionError(f"{name} was not launched by the step")
        if launches["dense_agg"]:
            raise AssertionError("the flagship's int64 key took the dense "
                                 "engine")
        check_against_oracle(out, want, bm)
        # the filter's plan is the step's one count kernel launch, and its
        # byte planes one K2 launch
        if launches["tile_counts"] != 1 or launches["K2"] != 1:
            raise AssertionError(f"{launches['tile_counts']} count-kernel "
                                 f"and {launches['K2']} K2 launches on the "
                                 "step, expected the filter's one of each")
        extraction = group_by_calls(args, launches["tile_counts"],
                                    f"step, {card_keys} keys")
        log(f"main path, {card_keys} keys: {out.length} groups exact "
            f"against the numpy oracle; launches {launches}; calls held "
            f"to plain (P, n, kept, out_rows): {calls}; the group-by's "
            f"{len(extraction)} K1 calls each "
            f"{[c.launched for c in extraction]} "
            f"({time.perf_counter() - t0:.1f} s with data generation)")
        main_runs[card_keys] = (batch, launches, extraction)
        del args

    kernels_rows = {}
    group_by_rows = []
    for card_keys, (batch, launches, k1_calls) in main_runs.items():
        mask = ops.and_kleene(ops.gt(batch["a"], batch["b"]),
                              ops.eq(ops.rem(batch["c"], 7), 0))
        filtered = ops.filter_record_batch(batch, mask)
        stage = {
            "step_ms": median_ms(lambda: pe.step(batch)),
            "predicate_ms": median_ms(lambda: ops.and_kleene(
                ops.gt(batch["a"], batch["b"]),
                ops.eq(ops.rem(batch["c"], 7), 0))),
            "filter_ms": median_ms(
                lambda: ops.filter_record_batch(batch, mask)),
            "group_by_ms": median_ms(lambda: gb.group_by(
                filtered, ["k"], [("v", "sum"), ("v", "count"),
                                  ("v", "min")])),
        }
        torch.cuda.reset_peak_memory_stats()
        pe.step(batch)
        stage["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"timing, {card_keys} keys: {stage}")
        log(f"profile, {card_keys} keys: {profile(lambda: pe.step(batch))}")
        # K1 at the step's group-by calls (group extraction, no offsets)
        group_by_rows += [dict(row, keys=card_keys) for row in
                          time_k1_group_calls(
                              k1, f"group-by, {card_keys} keys", k1_calls)]

        if card_keys != CARDINALITIES[0]:
            continue
        # the kernels at the main path's largest call of each: the filter
        plan = ops.build_plan(mask)
        keep, offs, rows = plan.keep, plan.offs, plan.out_capacity
        p8 = [batch[c].values for c in ("a", "b", "c", "k", "v")]
        p1 = [bm.unpack(batch[c].validity) for c in ("a", "b", "c", "v")]
        s8, s1 = torch.stack(p8), torch.stack(p1)
        log(f"  tile offsets (count kernel + cumsum): "
            f"{cold_ms(lambda: k1.tile_offsets(keep)):.4f} ms")
        calls = {
            "K1": (lambda: k1.compact_planes(p8, keep, offs, rows),
                   lambda: k1.compact_planes_plain(p8, keep, rows),
                   lambda: s8[:, keep], p8),
            "K2": (lambda: k2.compact_planes_info(p1, keep, offs, rows)[0],
                   lambda: k2.compact_planes_info_plain(p1, keep, rows)[0],
                   lambda: s1[:, keep], p1),
        }
        for name, (fn, plain, library, planes) in calls.items():
            kernels_rows[name] = time_kernel(f"{name} filter", fn, plain,
                                             library, planes, keep, rows)
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      for a, b in zip(fn(), plain()))
            if err:
                raise AssertionError(f"{name}: differs at the main shape")
            kernels_rows[name]["max_abs_err"] = float(err)

        k2_density_sweep(k1, k2, p1, dev)

        # the same planes under denser masks with full outputs: how the
        # kernels fare when the writes are not cut by the count
        g = torch.Generator(device=dev).manual_seed(1)
        for density in (0.5, 0.96):
            dense = torch.rand(N_MAIN, device=dev, generator=g) < density
            kept, offs_d = int(dense.sum()), k1.tile_offsets(dense)
            for name, planes, fn in (
                    ("K1", p8, lambda: k1.compact_planes(p8, dense, offs_d)),
                    ("K2", p1,
                     lambda: k2.compact_planes_info(p1, dense, offs_d))):
                w = planes[0].element_size()
                nbytes = N_MAIN + len(planes) * w * (kept + N_MAIN)
                line = (f"  {name} at {density:.0%} kept, full output: "
                        f"{cold_ms(fn):.4f} ms, bound "
                        f"{bytes_bound_ms(nbytes):.4f} ms")
                if name == "K2":
                    # a copy that reads and writes the same bytes
                    words = torch.zeros((1, nbytes // 8), dtype=torch.int32,
                                        device=dev)
                    line += (f", stream copy of the same bytes "
                             f"{cold_ms(lambda: kp.stream(words)):.4f} ms")
                    del words
                log(line)

    # the step is host-bound and host clocks vary on a shared machine: its
    # time again, the two cardinalities in turns, for the spread
    for rep in range(3):
        log(f"step, repeat {rep}: " + ", ".join(
            f"{c} keys {median_ms(lambda: pe.step(b)):.3f} ms"
            for c, (b, _, _) in main_runs.items()))

    # phase 5
    t0 = time.perf_counter()
    check_k3(k1, k3, dev)
    log(f"phase 5 (K3 vs plain and K1): {time.perf_counter() - t0:.1f} s")

    # phase 6
    t0 = time.perf_counter()
    join_launches, join_k1_rows = join_phase(pe, k1, k2, k3, _build, dev)
    log(f"phase 6 (join step): {time.perf_counter() - t0:.1f} s")

    # phase 6b
    t0 = time.perf_counter()
    skew_launches, skew_filters = skew_phase(pe, k1, k2, k3, _build, dev)
    log(f"phase 6b (skewed join step): {time.perf_counter() - t0:.1f} s")

    # phase 16
    t0 = time.perf_counter()
    text_launches, text_timing = text_join_phase(pe, k1, k2, k3, _build,
                                                 dev)
    torch.cuda.empty_cache()
    log(f"phase 16 (text-keyed join step): {time.perf_counter() - t0:.1f} s")

    # phase 7: K3's entry point on the flagship batch's int64 columns as
    # u32 planes (lo, hi of each) under the flagship mask
    batch = main_runs[CARDINALITIES[0]][0]
    keep = ops.build_plan(ops.and_kleene(
        ops.gt(batch["a"], batch["b"]),
        ops.eq(ops.rem(batch["c"], 7), 0))).keep
    s10 = torch.cat([batch[c].values.view(torch.int32).view(-1, 2).t()
                     for c in ("a", "b", "c", "k", "v")]).contiguous()
    k1.launches = k2.launches = k3.launches = 0
    k3.compact_planes(s10, keep)
    torch.cuda.synchronize()
    k3_launches = {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches}
    if k3_launches["K3"] <= 0:
        raise AssertionError("K3 was not launched by its entry point")
    log(f"K3 path (compact2.compact_planes, {tuple(s10.shape)} u32): "
        f"launches {k3_launches}")
    count = int(keep.sum())

    def k3_library():
        out = torch.zeros(s10.shape, dtype=s10.dtype, device=dev)
        out[:, :count] = s10[:, keep]
        return out

    kernels_rows["K3"] = time_kernel(
        "K3 flagship mask", lambda: k3.compact_planes(s10, keep),
        lambda: k3.compact_planes_plain(s10, keep), k3_library, s10, keep,
        N_MAIN)
    err = int((k3.compact_planes(s10, keep).to(torch.int64)
               - k3.compact_planes_plain(s10, keep).to(torch.int64)
               ).abs().max())
    if err:
        raise AssertionError("K3: differs at the main shape")
    kernels_rows["K3"]["max_abs_err"] = float(err)
    offs10 = k1.tile_offsets(keep)
    log(f"  K1 on the same call: look-back "
        f"{cold_ms(lambda: k1.compact_planes(s10, keep)):.4f} ms, given "
        f"the tile offsets "
        f"{cold_ms(lambda: k1.compact_planes(s10, keep, offs10)):.4f} ms")
    g = torch.Generator(device=dev).manual_seed(3)
    for density in (0.5, 0.96):
        dense = torch.rand(N_MAIN, device=dev, generator=g) < density
        kept = int(dense.sum())
        bound = bytes_bound_ms(N_MAIN + 4 * len(s10) * (kept + N_MAIN))
        log(f"  K3 at {density:.0%} kept: "
            f"{cold_ms(lambda: k3.compact_planes(s10, dense)):.4f} ms, "
            f"K1 {cold_ms(lambda: k1.compact_planes(s10, dense)):.4f} "
            f"ms, bound {bound:.4f} ms")

    # phase 8
    pe.dryrun_multichip(1)

    # phase 9
    t0 = time.perf_counter()
    check_probes(kp, probes, dev)
    log(f"phase 9 (probe kernels vs plain): {time.perf_counter() - t0:.1f} s")

    # phase 10: the probes' path, then the stage ablation at the flagship
    # call of phase 7
    for name in kp.launches:
        kp.launches[name] = 0
    result = probes.run_probes(dev)
    probe_launches = dict(kp.launches)
    for name, count in probe_launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by run_probes")
    floor = result["floor_GBps"]
    log(f"run_probes: {len(result['lines'])} lines in "
        f"{result['seconds']:.1f} s; launches {probe_launches}")
    log(f"copy floor: {floor:.1f} GB/s ({floor * 1e9 / HBM_BYTES_PER_S:.1%} "
        "of 3.35 TB/s), stream copying 16 planes of 8,060,928 u32")
    log("stage ablation at the flagship call (10 u32 planes x 8M, "
        "flagship mask):")
    ablation = probes.ProbeRun(REPS, log, floor * 1e9)
    probes.compaction_ablation(ablation, "flagship", s10, keep)
    # ProbeRun.probe raises on a difference; every line is read once more
    for line in result["lines"] + ablation.lines:
        if line["max_abs_err"] != 0:
            raise AssertionError(f"{line['id']} {line['label']}: differs "
                                 "from its plain version")
    log(f"probe lines: {len(result['lines']) + len(ablation.lines)}, every "
        "kernel bit-exact against its plain version at its timed shape")

    # phase 11
    t0 = time.perf_counter()
    k1.launches = k2.launches = k3.launches = dk.launches = 0
    for name in kp.launches:
        kp.launches[name] = 0
    lexsort = lexsort_phase(pe, dev)
    lexsort_launches = {"K1": k1.launches, "K2": k2.launches,
                        "K3": k3.launches, "dense_agg": dk.launches,
                        **kp.launches}
    log(f"phase 11 (config 3 lexsort): {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {lexsort_launches} (its path runs none)")
    log(f"config 3: {json.dumps(lexsort)}")

    # phase 12
    t0 = time.perf_counter()
    agg_launches, dense_row, agg_k1_rows = agg_phase(
        pe, k1, dk, _build, dev, floor * 1e9)
    log(f"phase 12 (config 4): {time.perf_counter() - t0:.1f} s")

    # phase 13
    t0 = time.perf_counter()
    q6_launches, k1_16_row, arrays, batch = q6_phase(
        pe, ops, k1, k2, _build, dev, floor * 1e9)
    log(f"phase 13 (TPC-H Q6, SF{Q6_SF}): {time.perf_counter() - t0:.1f} s")

    # phase 15, on phase 13's lineitem; its memory is freed before phase 14
    t0 = time.perf_counter()
    q1_launches, q1_k1_rows, q1_timing, comment, q1_want = q1_phase(
        pe, ops, k1, k2, _build, dev, arrays, batch)
    log(f"phase 15 (TPC-H Q1, SF{Q6_SF}; l_comment sort): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 17, on the same lineitem and phase 15's oracle
    t0 = time.perf_counter()
    lineitem_launches, lineitem_timing = lineitem_exchange_phase(
        pe, ops, k1, k2, _build, dev, arrays, batch, q1_want)
    log(f"phase 17 (lineitem exchange, distributed Q1): "
        f"{time.perf_counter() - t0:.1f} s")
    del q1_want
    torch.cuda.empty_cache()

    # phase 18: part at SF10 and the LIKE family
    t0 = time.perf_counter()
    part_arrays, part, like_lines = part_like_phase(pe, ops, dev)
    log(f"phase 18 (part, LIKE family): {time.perf_counter() - t0:.1f} s")

    # phase 19: Q14 and Q19 over lineitem and part
    t0 = time.perf_counter()
    query_launches, query_timing = query_phase(
        pe, ops, k1, k2, _build, dev, arrays, batch, part_arrays, part)
    log(f"phase 19 (TPC-H Q14, Q19): {time.perf_counter() - t0:.1f} s")
    del part_arrays, part
    torch.cuda.empty_cache()

    # phase 20: the external sort of lineitem, the RowConverter round trip
    t0 = time.perf_counter()
    sort_launches, sort_timing = external_sort_phase(
        pe, ops, k1, k2, _build, dev, arrays, batch)
    torch.cuda.empty_cache()
    log(f"phase 20 (external sort, RowConverter): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 21: TPC-H Q3 over customer, orders and lineitem
    t0 = time.perf_counter()
    q3_launches, q3_timing = q3_phase(pe, ops, k1, k2, _build, dev, arrays,
                                      batch)
    log(f"phase 21 (TPC-H Q3, SF{Q3_SF}): {time.perf_counter() - t0:.1f} s")

    # phase 24: lineitem through an IPC file and stream, validated, then Q6
    t0 = time.perf_counter()
    ipc_launches, ipc_timing = ipc_phase(pe, ops, k1, k2, _build, dev,
                                         arrays, batch)
    log(f"phase 24 (lineitem through Arrow IPC, validated; Q6): "
        f"{time.perf_counter() - t0:.1f} s")
    del arrays, batch
    torch.cuda.empty_cache()

    # phase 22: ClickBench's queries 1-8 over hits
    t0 = time.perf_counter()
    clickbench_launches, clickbench_timing, hits = clickbench_phase(
        pe, ops, k1, k2, _build, dev)
    torch.cuda.empty_cache()
    log(f"phase 22 (ClickBench, {HITS_ROWS} rows): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 26: those rows through Avro, TSV and NDJSON, then queries 1-8
    # on each, and a FlightSQL statement framed for DoGet
    t0 = time.perf_counter()
    row_launches, row_timing = row_formats_phase(pe, ops, k1, k2, _build,
                                                 dev, hits)
    del hits
    torch.cuda.empty_cache()
    log(f"phase 26 (hits through Avro, TSV and NDJSON; FlightSQL): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 23: query 43 over hits in primary-key order
    t0 = time.perf_counter()
    hits_pk_launches, hits_pk_timing, hits_arrays, q43_want = hits_pk_phase(
        pe, ops, k1, k2, _build, dev)
    torch.cuda.empty_cache()
    log(f"phase 23 (ClickBench Q43, hits in primary-key order, {HITS_ROWS} "
        f"rows): {time.perf_counter() - t0:.1f} s")

    # phase 25: those rows through a Parquet file, scanned with pushdown
    t0 = time.perf_counter()
    parquet_launches, parquet_timing = parquet_phase(
        pe, ops, k1, k2, _build, dev, hits_arrays, q43_want)
    del hits_arrays
    torch.cuda.empty_cache()
    log(f"phase 25 (hits through Parquet, scanned with pushdown; Q43): "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 14
    t0 = time.perf_counter()
    nested_launches = nested_phase(ops, k1, k2, _build, dev)
    log(f"phase 14 (nested classes): {time.perf_counter() - t0:.1f} s")

    # phase 27: JSONBench's Bluesky events as a shredded Variant column
    t0 = time.perf_counter()
    jsonbench_launches, jsonbench_timing = jsonbench_phase(
        pe, ops, k1, k2, _build, dev)
    log(f"phase 27 (JSONBench, {JSONBENCH_DOCS} Bluesky documents as a "
        f"shredded Variant; Parquet, integration format, CLI, Tensor): "
        f"{time.perf_counter() - t0:.1f} s")

    kernels_rows["K1"]["group_by_calls"] = group_by_rows
    kernels_rows["K1"]["join_calls"] = join_k1_rows
    kernels_rows["K1"]["config4_calls"] = agg_k1_rows
    kernels_rows["dense_agg"] = dense_row
    kernels_rows["K1_16"] = k1_16_row
    kernels_rows["K1_16"]["q1_calls"] = q1_k1_rows
    source = {"K1": "arrowtpu_torch/csrc/compact.cu",
              "K1_16": "arrowtpu_torch/csrc/compact.cu",
              "K2": "arrowtpu_torch/csrc/compact.cu",
              "K3": "arrowtpu_torch/csrc/compact2.cu",
              "stream": "arrowtpu_torch/csrc/probes.cu",
              "lane_roll": "arrowtpu_torch/csrc/probes.cu",
              "tile_gather": "arrowtpu_torch/csrc/probes.cu",
              "stages_k3": "arrowtpu_torch/csrc/compact2.cu",
              "stages_k1": "arrowtpu_torch/csrc/compact.cu",
              "dense_agg": "arrowtpu_torch/csrc/dense_agg.cu"}
    replaces = {"K1": "arrowtpu/pallas/compact3.py:126",
                "K1_16": "arrowtpu/pallas/compact3.py:126 (a (n, 4) u32 "
                         "value as four planes, arrowtpu/ops/filter.py:141)",
                "K2": "arrowtpu/pallas/compact.py:158",
                "K3": "arrowtpu/pallas/compact2.py:93",
                "stream": "scripts/prof_floor.py:35, :82; "
                          "scripts/prof_gather.py:23 (copy)",
                "lane_roll": "scripts/prof_gather.py:23 (rolls); "
                             "scripts/prof_v3.py:110",
                "tile_gather": "scripts/prof_gather.py:23; "
                               "scripts/prof_gather256.py:29; "
                               "scripts/prof_deint.py:55; "
                               "scripts/prof_pairlayout.py:78; "
                               "scripts/prof_epi3.py:47; "
                               "scripts/prof_v3.py:140, :174",
                "stages_k3": "scripts/prof_v3.py:65-78 "
                             "(arrowtpu/pallas/compact2.py:95 stages)",
                "stages_k1": "scripts/prof_kernel.py:147",
                "dense_agg": "arrowtpu/ops/groupby.py:599 (_dense_agg_column, "
                             "XLA-fused; no pallas_call)"}
    names = {"K1": "compact3 (tile_compact_kernel, u32/u64, tile offsets "
                   "or look-back)",
             "K1_16": "compact3 16-byte words (tile_compact_kernel<uint4> "
                      "with tile offsets, compact16_kernel in the look-back "
                      "frame)",
             "K2": "compact (tile_compact_kernel, u8/u32, tile offsets "
                   "or look-back)",
             "K3": "compact2 (tile_compact_kernel, u32, look-back)",
             "stream": "stream (stream_kernel)",
             "lane_roll": "lane_roll (lane_roll_kernel)",
             "tile_gather": "tile_gather (tile_gather_kernel)",
             "stages_k3": "compaction_stages K3 "
                          "(tile_compact_kernel<u32, look-back, stage>)",
             "stages_k1": "compaction_stages K1 "
                          "(tile_compact_kernel<u32, offs, stage>)",
             "dense_agg": "dense_agg (dense_agg_kernel)"}
    # each probe kernel's row in the JSON: its line at one probe shape
    shown = {"stream": ("P4", "x + keep, P=2"),
             "lane_roll": ("P1", "14 roll+where"),
             "tile_gather": ("P1", "lane gather (u32 data; i32 data)"),
             "stages_k3": ("P7", "K3 full P=2"),
             "stages_k1": ("P8", "K1 full P=2")}
    for key, (pid, label) in shown.items():
        line = next(x for x in result["lines"]
                    if x["id"] == pid and x["label"].startswith(label))
        kernels_rows[key] = dict(line, bound_by="bytes",
                                 shape=f"{pid} {line['label']}: "
                                       f"{line['shape']}")
        if line.get("select_ms", 0) > line["bound_ms"]:
            kernels_rows[key].update(bound_ms=line["select_ms"],
                                     bound_by="operations")
    # tile_gather's redesigned lines: the staged sublane gather, P3's round
    # trip in one launch
    kernels_rows["tile_gather"]["redesigned_lines"] = [
        {k: x.get(k) for k in ("id", "label", "ms", "warm_ms", "bound_ms",
                               "floor_ms", "plain_ms", "library_ms")}
        for x in result["lines"] if x["kernel"] == "tile_gather"
        and ("sublane" in x["label"] or x["label"].startswith("deint"))]
    # lane_roll's redesigned lines: every roll chain, with its issue bounds
    kernels_rows["lane_roll"]["redesigned_lines"] = [
        {k: x.get(k) for k in ("id", "label", "ms", "warm_ms", "bound_ms",
                               "floor_ms", "select_ms", "shuffle_ms",
                               "plain_ms", "library_ms")}
        for x in result["lines"] if x["kernel"] == "lane_roll"]
    flagship = main_runs[CARDINALITIES[0]][1]
    launches = {"K1": flagship["K1"], "K2": flagship["K2"],
                "K3": k3_launches["K3"], **probe_launches,
                "dense_agg": agg_launches["low_card"]["dense_agg"],
                "K1_16": q6_launches["K1_16"]}
    by_path = {"flagship step": flagship, "join step": join_launches,
               "skewed join step": skew_launches,
               "skewed join step, its filters": skew_filters,
               "compact2.compact_planes": k3_launches,
               "run_probes": probe_launches,
               "config 3 lexsort": lexsort_launches,
               **{f"config 4 {label}": c
                  for label, c in agg_launches.items()},
               "TPC-H Q6": q6_launches, "TPC-H Q1": q1_launches,
               "nested batch filter": nested_launches,
               "text join step": text_launches, **lineitem_launches,
               **query_launches, "external sort": sort_launches,
               **q3_launches, **ipc_launches, **clickbench_launches,
               **{f"hits pk: {p}": c for p, c in hits_pk_launches.items()},
               **parquet_launches, **row_launches, **jsonbench_launches}
    kernels = []
    for key in ("K1", "K2", "K3", *shown, "dense_agg", "K1_16"):
        row = kernels_rows[key]
        kernels.append({
            "name": names[key], "route": "cuda", "source": source[key],
            "replaces": replaces[key], "launches": launches[key],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "warm_ms": row["warm_ms"], "shape": row["shape"],
            "launches_by_path": {p: c.get(key, 0)
                                 for p, c in by_path.items()
                                 if isinstance(c.get(key, 0), int)},
            **({"count_kernel_launches_by_path": {
                p: c["tile_counts"] for p, c in by_path.items()
                if "tile_counts" in c}} if key == "K1" else {}),
            **{k: row[k] for k in ("group_by_calls", "join_calls",
                                   "config4_calls", "q1_calls",
                                   "redesigned_lines", "stages",
                                   "sector_floor_ms",
                                   "library", "floor_ms") if k in row}})
    log(f"TPC-H Q1 step: {json.dumps(q1_timing)}")
    log(f"text join step: {json.dumps(text_timing)}")
    log(f"lineitem exchange, distributed Q1: {json.dumps(lineitem_timing)}")
    log(f"l_comment sort: {json.dumps(comment)}")
    log(f"LIKE family over SF{PART_SF} part: {json.dumps(like_lines)}")
    for name, line in query_timing.items():
        log(f"TPC-H {name} step: {json.dumps(line)}")
    log(f"external sort of lineitem: {json.dumps(sort_timing)}")
    log(f"TPC-H Q3 step: {json.dumps(q3_timing)}")
    log(f"lineitem through Arrow IPC: {json.dumps(ipc_timing)}")
    for q, line in clickbench_timing.items():
        log(f"ClickBench Q{q} step: {json.dumps(line)}")
    for step, line in hits_pk_timing.items():
        log(f"hits pk {step}: {json.dumps(line)}")
    for step, line in parquet_timing.items():
        log(f"hits through Parquet, {step}: {json.dumps(line)}")
    for fmt, line in row_timing.items():
        log(f"hits through {fmt}: {json.dumps(line)}")
    for part, line in jsonbench_timing.items():
        log(f"JSONBench {part}: {json.dumps(line)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
