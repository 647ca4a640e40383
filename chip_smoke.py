#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one CUDA card (an H100 is the
target).  Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the card's name and power
   limit and the CUDA toolkit version.
2. The full-size DR loop: ``StreamingJob`` on 8 stacked workers, 32
   partitions, 8 x 262,144 state rows, over 8 drifting-Zipf batches of
   4 Mi records, by each of its three drivers: serial, overlapped at depth
   1 (through ``process_batch``) and at depth 2 (through ``run``).  Each
   run asserts zero overflow, at least one repartition that lowers the mean
   imbalance, exact counts of 64 sampled keys, and that both kernels were
   launched by that run (counts set to 0 just before it); the three
   trajectories must be equal (walls, ``state_rows`` and the drivers' flags
   apart) and the final states equal.  Every batch there repartitions, so
   the same three jobs then go on over the same batches with the policies
   off (steady state: no action drains the pipeline): equal again, every
   depth-2 batch after the first consumes a staged start, and the host-sync
   audit stays at 0 at depth 2.  Then two more serial batches are traced
   (one repartitioning, one not): each host step's wall by
   ``time.perf_counter`` and its device time by ``torch.profiler``; and the
   card's idle share over 4 steady-state depth-1 batches.
3. Each kernel against its plain PyTorch version on the card, on inputs
   from phase 2 (split replicas on and off, invalid sentinel records, an
   empty heavy table, a capacity that overflows), and on the edges of the
   one-pass rank and the 16-byte fill: n below one tile and 3 tiles + 1,
   35 stacked rows, 1024 lanes, 3 x 5 x 200,001 cells (ragged tails, no
   lane full), capacity 0, every record invalid, no records, each with its
   outputs handed out dirty: every output must be equal exactly.  Both
   route kernels also with a load vector (the two-choice least-load
   replica pick): one of many equal entries (ties keep the first hash) and
   one with a split key's replica at 1e9.
   And route_bucketize into a recycled send-buffer set (an earlier call's,
   dirtied), as the overlapped driver's pool hands one out.  Then
   route_bucketize at phase 2's shapes on four streams at once beside a
   busy copy: every output bit-equal to an idle card's.
4. The phase-2 configuration on a small stream, on the card and on the
   CPU, by each of the three drivers: identical per-batch metrics (but the
   walls and ``overlap_fraction``, a ratio of walls) and final state.
5. Times: each kernel and its plain version (CUDA events around one call,
   median of 20 after 3 warm-ups) beside the kernel's byte bound, and the
   kernel's own device time (``torch.profiler``, its kernels and memsets by
   name over 20 calls, an L2 flush between calls for route_bucketize; for
   lookup_dispatch both without and with the flush), split by device
   kernel; each route kernel with a split table without and with a load
   vector, in turns (the ``kernels`` line's ``device_ms_with_loads``);
   the device time of one state merge; each driver's wall per
   batch (the run and one drain, synchronized, over the batch count) and
   median count-phase wall of steady-state batches, with phase 2's traces
   and idle share.  The median count-phase wall of steady-state depth-1
   batches must lie below the merge's device time: the overlap keeps the
   merge out of the count sync.
6. The batch path at the paper's size (Fig. 4, as
   ``benchmarks/bench_spark_like.py`` records it): 10,000,000-record Zipf
   jobs over 1,000,000 keys, 35 partitions, exponents 1.0 to 2.0, a 10%
   prefix sample and ``DRConfig(mode="batch", lam=4.0, eps=0.003)``.  Each
   ``BatchJob`` on the card must equal the same job on the CPU in every
   field and the host ``Partitioner.lookup_np``; the replayed buffer is
   bucketized into its 35 partitions without a slot (zero overflow, every
   record exactly once); ``ops.count_sketch`` at widths 2048 and 8192 must
   equal the host ``CountMinSketch`` (a check: no entry point of either
   package calls the sketch, so its launches there are counted apart and
   its path count is 0).  ``partition_apply`` and ``dispatch_count`` must
   have been launched by that run.
7. Each batch kernel against its plain version on the card (heavy tables
   full, empty and hit by sentinel keys, 35 stacked rows, a key view 4
   bytes past a 16-byte boundary; out-of-range and invalid destinations,
   1 to 1024 parts, n below one tile and 3 tiles + 1, every record
   invalid, no records, outputs handed out dirty; sketch widths 1 to 8192
   over depths 1 to 8 (rows split over a cluster at depth 8, width 8192),
   invalid records, one key for every record, exponent 2.0, keys 4 bytes
   past 16 with flags 1 byte past 4, n of 1, 15, 17 and 3 blocks' steps +
   1, 35 stacked rows, nothing valid, no records, outputs handed out
   dirty): every output equal exactly.  Then dispatch_count and
   sketch_update (depth 4 x 2048 and 8 x 8192) at phase 6's shape on four
   streams at once beside a busy copy: every output bit-equal to an idle
   card's.
8. Times of the batch kernels at phase 6's shapes (exponent 1.2), as in
   phase 5 (an L2 flush between calls for dispatch_count's device time;
   partition_apply's and sketch_update's both without and with the flush,
   sketch_update's also flushed at width 8192, at exponent 2.0 and at
   depth 8 x 8192; its bound the larger of its bytes and its integer
   operations, each pipe's at its lanes an SM and the highest SM clock),
   and the median ``BatchJob.run`` wall per job, split into the host
   planning, the upload and the device passes.
9. Serving at gemma-2b's full published width and depth (18 layers, bf16
   parameters and compute, random weights from a seeded generator on the
   card): 32 requests with the traffic of the reference launcher
   (``src/repro/launch/serve.py``: session 7 with probability 0.3, else
   uniform over [0, 1000)), prompts of 256-2048 tokens, 16 new tokens,
   routed by ``DRScheduler.route`` to 4 replicas, each a 4-slot
   ``ServeEngine`` with ``max_len`` 2064, then ``checkpoint``.  Asserts 16
   tokens in the vocabulary for every request, finite logits, one
   flash-kernel launch per layer per prefill (576), the checkpoint's
   schema, and the first prefill's layer-0 flash output equal bit for bit
   to a launch that also writes lse (training's).
10. The flash kernel against its plain version on the card: gemma-2b's
    prefill shapes (G = 1, P = 8, hd = 256, Sq = Sk in 1, 100, 512, 2048)
    and hd 16, 64, 128, 192 with G > 1, P in 1, 2; causal, non-causal and
    window 96; in both ``p_bf16`` modes; and bf16 q rows at positions
    120-169 over 170 k rows (causal; non-causal with window 40).  float32
    within 2e-5, bf16 within 2e-2 and, with ``p_bf16=False``, 8e-3;
    ``p_bf16=True`` rounds the weights to bf16 in both versions, so 2e-2
    for float32 inputs too.  And float32 weights through the bf16 tensor
    cores keep float32 precision: the bf16 outputs lie within half an ulp
    plus 2e-4 of the float32 plain version on the same inputs, where the
    plain version with bf16 weights (the control, which must fail that
    limit) does not.
11. The card against the CPU: gemma-2b at full width but depth 2 in
    float32 (TF32 off), both from the same CPU-initialised weights; four
    prompts of 128-256 tokens, 8 teacher-forced steps: logits within 1e-3,
    greedy tokens equal wherever the CPU's top-two margin exceeds 1e-2.
12. Times: the bf16 flash kernel (tensor cores) at gemma-2b's prefill
    shapes (Sq 512, 1024, 2048, causal), in both ``p_bf16`` modes, beside
    its bound, its plain version and ``scaled_dot_product_attention`` on
    the same inputs (k, v expanded to the 8 heads; timed only): each with
    CUDA events around one call (the ``ms`` of every kernel), and the
    kernel and SDPA also as device time over 20 calls (:func:`device_ms`:
    queued behind a spin kernel, no host time in it); the float32 kernel
    at 2048; the prefill wall at those lengths and the kernel's share of
    it; at each length the output without lse (serving's launch) equal
    bit for bit to a launch that also writes lse (training's); a profile
    of a 1024-token prefill and of 8 decode steps;
    phase 9's median prefill wall per request, decode wall per token and
    tokens per second.

13. Hot-key splitting at phase 2's size: the phase-2 job with
    ``split_keys_enabled=True`` over ``hotspot_flip(12, 4_194_304,
    num_keys=1_000_000, exponent=1.3, flip_at=6)``, by each of the three
    drivers.  Asserts a ``Split`` before batch 6 and an ``Unsplit`` after
    it (its migration's lanes hold the whole state table), zero overflow,
    exact counts of 64 sampled keys and of every key ever split, equal
    trajectories and states, both kernels launched by each run; and, on
    the depth-1 run, in each batch with a split installed: the telemetry's
    replica rows equal ``split_replica_rows``, the loads the card counted
    equal the home rows plus those replica rows, and each split key's rows
    lie on its d partitions.  route_bucketize with the live split table and
    lookup_dispatch on the unsplit's inputs against their plain versions;
    the walls per batch, the repartition count, every migration (the
    serial driver's synchronized) and lookup_dispatch's time on the
    unsplit's inputs.  The same configuration over 16,384-record batches
    on the card and on the CPU by each driver: identical.
14. Elastic resize at phase 2's size: 8 workers from 16 partitions,
    ``DRConfig(elastic=True, min_partitions=16, max_partitions=32,
    grow_trigger=4.0, shrink_trigger=2.5, resize_patience=2, ...)`` over
    ``sawtooth_skew(12, 4_194_304, num_keys=1_000_000, exponent=1.8,
    period=4)``, batches 0-9 with ``resize(24)`` requested after batch 7,
    by each driver: the grow 16 -> 32 at batch 1, the shrink 32 -> 16 at
    batch 5 and the requested 16 -> 24 at batch 8, each migration routed
    by lookup_dispatch; zero overflow, exact counts, equal drivers; each
    resize batch's wall and migration rows.  Then the snapshot after batch
    9 restored onto 4 workers x 524,288 rows on the card and batches 10-11
    run there: zero overflow, counts exact over all 12 batches.  The same
    configuration over 16,384-record batches on the card and on the CPU
    by each driver: identical.

15. The least-load pick, the BackendPolicy and the ragged transport at
    phase 2's size.  (a) Phase 13's job and batches with
    ``split_least_load=True``, by each driver: equal trajectories and
    states, zero overflow, exact counts of the sampled and split keys fed
    fewer than 2**24 times, no host twin; the max / mean of the loads on
    each split key's replica partitions beside phase 13's hash pick; the
    walls beside phase 13's; route_bucketize with the live split table and
    load vector against its plain version, and its device time without and
    with the vector in turns; card == CPU over 16,384-record batches.
    (b) Phase 2's stream with ``DRConfig(auto_backend=True,
    backend_patience=2, backend_cooldown=50, imbalance_trigger=1e9)``: one
    switch to ragged, the padding fraction by safe point, equal drivers.
    (c) Ragged-pinned jobs beside dense ones, policies off in turns (dense,
    ragged, ragged, dense) and with phase 2's policies (ragged migrations):
    shipped rows below the provision, trajectories and states equal the
    dense jobs', and (b)'s final state equals the dense-pinned job's.
    (d) Non-integer payloads (``payload_dim=2``) over 16,384-record
    batches on the card and on the CPU: keys equal, each key's sum within
    1e-6 of its sum of |values| (``scatter_add_`` adds in no fixed order on
    the card), the largest difference printed.

16. Failure domains at phase 2's size.  (a) Phase 2's three jobs and
    batches, each on ``FaultyBackend("dense", FaultPlan())``: every metric
    but the walls, and the final state, equal to phase 2's own run.  (b)
    The reference's Fig. 6 at full size: ``DRConfig(imbalance_trigger=1e9,
    snapshot_interval=3)`` with ``LaneFault(4, 5, "kill")`` over phase 2's
    batches, by each driver: one recovery, an eviction of lane 5 onto 7
    workers; sampled counts exact, the float64 sum of all counts equal to
    the records fed, zero overflow, every key on its home worker
    (``lookup_np(k) % 7``); the recovery's wall and the walls before and
    after; card == CPU (trajectories, recoveries, lane ids, state) over
    16,384-record batches.  Then the same loss under phase 2's policies at
    depth 1: repartitions at 7 lanes, both route kernels launched after the
    loss.  (d) On the evicted depth-1 job's tables, state and last batch,
    route_bucketize and lookup_dispatch at 7 lanes (rows of 599,187 keys,
    starting off 16 bytes) against their plain versions, outputs handed out
    dirty, and their times.  (c) Lane health over 12 batches of the same
    stream shape, ``health_straggler_ms=50, health_patience=2,
    health_recover_after=3, snapshot_interval=3``: lane 2 straggles 80 ms a
    tick for 4 ticks, lane 6 fails once a tick for 5 ticks: Quarantine,
    Recover and Evict at the batches of the CPU run over 16,384-record
    batches (card == CPU there too), exact counts, zero overflow, each
    lane-change batch's wall.  (e) Fresh depth-1 jobs, policies off,
    without and with ``snapshot_interval=3`` in turns: the walls per batch
    and each snapshot's wall.

17. The lane topology at phase 2's size, on two hosts of four lanes
    (``ExchangeTopology(8, 4)``).  (a) Phase 2's job with the topology on
    the dense and on the hierarchical transport, by each driver: every
    metric but the walls and the traffic (dense: its shipped rows too),
    and the state, equal to phase 2's run; the rows by class sum to
    ``shipped_rows`` in every batch, zero overflow, exact counts, 0 host
    syncs outside safe points at depths 1 and 2, every hierarchical ship
    two-hop; the two transports equal but for the traffic, the drivers
    equal, and hierarchical's inter-host rows above 0 and below dense's in
    every batch; fresh depth-1 jobs with the
    policies off in turns (flat, dense with the topology, hierarchical,
    and back), each equal to the flat job but the walls and the traffic,
    with their walls; one ship of phase 2's send buffers, two hops against
    the flat transpose, in device time; card == CPU over 16,384-record
    batches, the classes included.  (b) Every lane its own host at 400x
    (``ExchangeTopology(8, 1, (0.0, 1.0, 400.0))``) beside the two-host
    and the blind (phase 2) jobs: the repartitions taken, the imbalance
    per batch and the reasons of the declines.  (c) Phase 16 (b)'s loss
    at depth 1 on ``FaultyBackend("hierarchical", ...)``: one eviction
    onto 7 lanes (hosts of 4 and 3), two-hop ships before it and flat
    ones after it, zero rows lost, the recovery's wall.  The ``kernels``
    line's route kernels carry their launches in (a)'s depth-1 runs
    (``launches_phase_17``).

18. Llama 4 Scout at its full published width (d 5120, 40 q heads over 8
    kv heads, head_dim 128, 16 experts top-1 with a shared expert,
    d_ff_expert 8192, vocab 202,048), cut to 8 of its 48 layers, bf16,
    over 4 stacked EP shards (``Policy(ep_shards=4)``, the dense
    transport).  (b) One MoE layer on 1,024 tokens at capacity 8.0:
    ``moe_apply`` against ``moe_ref`` on the card within 2e-2 x max(1,
    |ref|), counts equal, no drops, the dense and ragged transports' ``y``
    bit-identical.  (a) Phase 9's serving mix (32 requests, prompts of
    256-2048 tokens, both multiples of 4 and not, 16 new tokens, 4
    replicas x 4 slots) at the config's capacity 1.25: every request
    served, per prefill ``moe_apply`` (2 dispatch_count launches a layer)
    or ``moe_apply_replicated`` (1), 8 flash launches, per decoded token 8
    dispatch_count launches; walls, drops, shipped and occupied rows per
    prefill.  (d) ``PlacementController(16, 4)`` on each prefill's
    ``moe_counts`` at the safe point between prefills (a ``Replace``
    permutes every MoE layer's experts on the card; the calls then pass
    the new ``inv_place``), and one with ``expert_weight_bytes`` of one
    expert in bf16 beside it: every decision logged, each move's wall and
    the next prefill's shard imbalance and drops.  (c) dispatch_count on
    hop 1's, hop 2's and a decode step's inputs bit-equal to its plain
    version, flash on layer 0's prefill inputs (G 8, P 5, hd 128) within
    8e-3 and equal bit for bit to a launch that also writes lse, with
    times, bounds and SDPA's; a profile of a 1,024-token
    prefill and 8 decode steps.  (d) A fixed permutation at capacity 8.0:
    prefill and decode logits within 2e-2 x max(1, |ref|) of the
    placement before.  The ``kernels`` line's dispatch_count and flash
    rows carry ``launches_phase_18`` and ``phase_18``.
19. Training.  (a) gemma-2b at full width and depth (bf16, float32 AdamW
    moments), 8 steps of 4 x 1,024 ``lm_token_stream`` tokens through
    ``make_train_step``: finite loss and grad norm, 18 flash forward and
    18 backward launches a step; walls, tokens/s, peak memory, one
    profiled step (idle share, top device ops) and the AdamW update alone;
    then 8 steps on one batch at ``OptConfig(lr=1e-3, warmup=1)``, the last
    loss below the first.  (b) Llama 4 Scout at full width over 2 of its
    48 layers and 4 stacked EP shards (bf16 moments), 12 steps of 2 x
    1,024 tokens with ``PlacementController(16, 4)`` at each step
    boundary: every decision logged, each move (``wi``, ``wo`` and both
    moments of every MoE layer, in place) timed, ``expert_counts`` summing
    to the batch's pairs, 2 dispatch_count launches a MoE layer a step.
    (c) The float32 smoke configs of gemma-2b and of Scout at 4 shards, 3
    steps on the card and the CPU: counts and overflow equal, loss and
    grad norm within 1e-4 relative, then a fixed re-placement and one more
    step with equal counts.  (a) and (b) launch the bf16 backward's
    tensor-core kernels with the forward's lse and never its stats pass
    (the launch count of calls that ran it, and the profiled step's
    kernel names).  (d) The flash backward kernels against their plain
    version on layer 0's inputs of (a) and (b), bf16 (with the forward's
    lse, and by the stats pass) and float32, Sq 1,000 and window 512, each
    gradient within its limit times its own largest entry (a 5% error
    refused), outputs handed out dirty, two calls bit-equal; the forward's
    lse within 1e-5 of ``torch.logsumexp`` of the plain masked scores; the
    bf16 times beside the bound and SDPA's backward, the device time split
    by kernel (D, dkdv, reduce, dq).  The
    ``kernels`` line gains the ``flash_attention_bwd`` row (with ptxas's
    registers and spills of its kernels), and the flash and dispatch_count
    rows ``launches_phase_19``.
20. The paper's partitioner comparison, every table routed on the card by
    ``partition_apply`` (``replay_partition``), each id equal to the
    host's ``lookup_np`` and each ``torch.bincount`` load vector to
    ``np.bincount``'s.  (a) Fig. 2 (``benchmarks/bench_partitioners.py``)
    at phase 6's size: ``zipf_keys(10,000,000, num_keys=1,000,000,
    exponent=1.0, seed=0)``, N in 4-64, lambda 2, Hash, Readj, Redist,
    Scan, Mixed, KIP and tight KIP: the imbalance beside the floor N * f1,
    whether the bench's two orderings hold (logged, not gated), the host
    update's microseconds on ``hist.top(64)`` at N=32, ``partition_apply``
    by events around one call (and the device time of the empty and KIP
    tables).  (b) Fig. 3 (``bench_migration.py``):
    ``drifting_zipf(20, 1,048,576, num_keys=100,000, drift_every=4,
    drift_fraction=0.3)``, N 20, 4 workers, Hash, Scan, Readj, KIP updated
    every batch over a 5-batch state window: mean imbalance, relative
    migration and ``migration_capacity``'s lane fraction.  (c) The §6 web
    crawl: ``host_skew_keys(10,000,000, num_hosts=960, giants=16,
    giant_mass=0.5, seed=49)`` through ``BatchJob(24, eps=0.003)``, every
    ``BatchResult`` field equal to the CPU job's, and each baseline on the
    job's prefix histogram.  (d) A Redist table of 1,536 rows (the
    binary search above the probe's 1,024) on (a)'s stream, its device
    time beside a 128-row table's.  Cut from the benches: 1 repetition,
    no lambda sweep, a 1 Mi-record batch in (b).  The ``partition_apply``
    row gains ``launches_phase_20`` and ``phase_20`` (each call's times).
21. The xLSTM family and activation checkpointing.  (a) xlstm-125m at
    full width and depth (12 layers alternating mLSTM / sLSTM, d 768, 4
    heads, vocab 50,304; bf16, float32 recurrent state) served through
    ``DRScheduler(4)`` and ``ServeEngine(4 slots)``: 16 requests of 256,
    512, 1,024 or 2,048 tokens, 16 new each, phase 9's session keys;
    every request served with finite logits; a 300-token prompt makes
    ``model.prefill`` raise ``ValueError`` (the reference's chunk
    contract); teacher-forced in float32, 255 prefilled + 1 decoded
    against a 256-token prefill and 256 + 256 against 512 (a 511-token
    prefill is off the contract), within 2e-3 x (1 + |logit|); walls by
    prompt length, device operations a 1,024-token prefill and a decoded
    token, idle shares.  (b) 3 train steps of 4 x 1,024 tokens at 6 of
    the 12 layers (bf16, float32 moments; the depth cut keeps the whole run
    inside its time limit): finite loss and grad norm, walls, tokens/s, peak
    memory, one profiled step, one sLSTM layer's forward and backward
    alone (its device operations a time step, the layers' share of the
    step); then 8 steps on one batch of 4 x 256 at ``OptConfig(lr=1e-3,
    warmup=1)``, the last loss below the first.  (c) The float32 smoke
    config card against CPU: prefill and 4 decode steps within 1e-4 x
    max(1, |cpu|), 3 train steps' loss and grad norm within 1e-4
    relative.  (d) gemma-2b at full width and depth and (e) Scout at 2 of
    48 layers over 4 stacked EP shards, 2 steps from one state (a host
    copy of the parameters, moments made afresh) without remat and under
    ``Policy(remat=True)`` (Scout: ``"nothing"`` and ``"save_moe"``):
    losses, grad norms and final parameters equal bit for bit; peak
    memory, walls; flash forward 2 a layer a step under remat (backward
    1), ``dispatch_count`` 2 a MoE layer a step, 4 under ``"nothing"``.
    The flash, flash-backward and dispatch_count rows gain
    ``launches_phase_21`` (a step, by run).
22. The enc-dec family: whisper-base at its full published width and
    depth (6 encoder and 6 decoder layers, d 512, 8 heads over 8 kv heads,
    head_dim 64, d_ff 2,048, vocab 51,865 padded to 51,968, tied
    embeddings; the audio frontend stubbed by seeded frame embeddings of
    1,500 rows).  (a) Served in bf16 through ``model.prefill`` /
    ``model.decode_step`` (``ServeEngine.admit`` passes no frames, as the
    reference's): 16 utterances with 4-token prompts, routed by
    ``DRScheduler(4)`` over phase 9's first 16 session keys, each
    replica's utterances one batch, prefilled at ``max_len`` 448 and
    decoded greedily for 60 tokens; finite logits, 18 flash launches a
    prefill (6 encoder, 6 decoder self, 6 cross), none a decoded token;
    the encoder's share of the prefill wall, the decode wall a token, the
    device operations and idle share of a profiled prefill and of 8
    decode steps; teacher-forced in float32 (4 + 60 against 64, 447 + 1
    against 448) within 2e-3 x (1 + |logit|).  (b) 8 train steps of 16 x
    (1,500 frames, 448 tokens), bf16 with float32 moments: finite loss
    and grad norm, 18 flash forward and 18 backward launches a step (none
    through the stats pass), walls, tokens/s, peak memory, one profiled
    step; 8 steps on one batch at ``OptConfig(lr=1e-3, warmup=1)`` (the
    last loss below the first); 2 steps from one state without and with
    ``Policy(remat=True)``: bit-equal, flash forward 36 a step under
    remat, backward 18, peaks.  (c) The float32 smoke config card against
    CPU: prefill and 4 decode steps within 1e-4 x max(1, |cpu|), 3 train
    steps' loss and grad norm within 1e-4 relative.  (d) Both flash
    kernels at whisper's three shapes (B 16, G 8, P 1, hd 64: encoder
    1,500 x 1,500 non-causal, decoder 448 x 448 causal, cross 448 over
    1,500 non-causal) against their plain versions, bf16 and float32
    (phase 10's and 19 (d)'s limits, a 5%-off gradient refused, dirty
    outputs, two calls bit-equal, the forward's bits with and without
    lse), timed beside the bound and SDPA (forward and backward).  The
    flash and flash-backward rows gain ``launches_phase_22`` and
    ``phase_22`` (each shape's errors and times).
23. M-RoPE and vision tokens: qwen2-vl-7b at full width and depth, bf16.
    (a) Served text only through ``DRScheduler(4)`` x ``ServeEngine(4
    slots)`` (28 flash launches a prefill, none a token), a 1,024-token
    prompt with 256 seeded patches, a 128-token one refused; (b) trained
    2 x 1,024 under remat with bf16 moments; (c) the smoke config with
    patches card against CPU; (d) both flash kernels at G 4, P 7, hd 128.
    The flash rows gain ``launches_phase_23`` and ``phase_23``.
24. The Mamba mixer and the hybrid family: jamba-1.5-large at its
    published widths (d 8,192, Mamba d_inner 16,384 d_state 16, 64 q / 8
    kv heads, d_ff 24,576, 16 experts top-2 without a shared expert).
    (a) The period's first four layers ((Mamba, dense), (Mamba, MoE),
    (Mamba, dense), (attention, MoE); 23 B parameters, bf16) at 4 stacked
    EP shards, served through ``DRScheduler(4)`` x ``ServeEngine(4
    slots)``: 16 requests of 256-2,048 tokens (the chunk contract), 16
    new each; finite logits, 1 flash and 4 ``dispatch_count`` launches a
    prefill, 0 and 2 a token; a 300-token prompt refused (``ValueError``);
    walls by prompt length, a profiled prefill and 8 decode steps.  (b)
    One Mamba mixer alone at ``[2, 1,024]`` bf16: forward and backward
    walls and busy time, device operations a chunk, the chunk loop's
    share, the peak, a decoded token's operations.  (c) Teacher-forced in
    float32 on one (Mamba, dense) layer (255 + 1 against 256, 256 + 256
    against 512) within 2e-3 x (1 + |logit|).  (d) Two (Mamba, dense)
    layers trained at 2 x 1,024 under remat (bf16 parameters, float32
    moments): finite loss and grad norm, walls, tokens/s, peak, a profiled
    step; 8 steps on one batch at the first rate of ``JAMBA_OVERFIT_LRS``
    where the loss falls.  (e) The float32 smoke config card against CPU
    at 0 and 4 shards, and remat (``"nothing"``, ``"save_moe"``) bit-equal
    to the steps without it.  (f) Both flash kernels at G 8, P 8, hd 128,
    1,024 causal, B 1 and B 2 (as 23 (d)), and ``dispatch_count`` on (a)'s
    top-2 hop inputs, timed.  The flash, flash-backward and dispatch_count
    rows gain ``launches_phase_24`` and ``phase_24``.
25. The ``torch.distributed`` transport, one worker a process, at phase
    2's deployment.  The parent saves phase 2's batches under the
    git-ignored ``build/phase25/`` and spawns the ranks (the spawn start
    method, a ``file://`` store there; the kernels were built by phase 1,
    so the ranks load that library); each rank saves its metrics, the
    gathered state and its launch counts beside the store, and the parent
    compares.  (a) 8 gloo processes sharing the card, ``StreamingJob(
    group=...)`` with phase 2's job and batches by the serial, depth-1 and
    depth-2 drivers: every metric but the walls and ``overlap_fraction``
    equal to phase 2's run by the same driver, the gathered state equal,
    no overflow, phase 2's 64 exact counts, every rank's ``DecisionLog``
    equal, both route kernels launched on every rank; rank 0's
    ``route_bucketize`` at ``[1, 524,288]``, L 8, against its plain
    version; the walls a batch (max over ranks) beside phase 2's, one
    dense ship (``a2a_finish``) beside phase 2's stacked transpose, the
    bytes handed to gloo, the card's memory with all 8 up, rank 0's idle
    share, and 0 host syncs at depth 2 with the policies off.  (b) Native
    ragged, ragged with ``REPRO_DISABLE_NATIVE_RAGGED=1`` and hierarchical
    with ``lanes_per_host=4``, 4 batches, serial: each equal to the
    stacked run of its backend on the card; shipped rows and bytes, the
    ship's wall, the native ship's compaction and scatter; the topology
    ``exchange_topology_of(group=)`` reads (one host).  (c) A one-rank
    nccl group (NCCL refuses two ranks on one card), W=1, dense and native
    ragged, 4 batches: equal to the stacked W=1 run.  The route kernels'
    and ``dispatch_count``'s rows gain ``launches_phase_25``.  Alone:
    build the library, run phase 2's three drivers (``drive``) for the
    ``phase2`` dict and ``exact`` pairs, then ``chip_smoke.dist_phase(
    dev, card, batches, phase2, exact)`` from a script under ``build/``.
26. Training over the process group: stablelm-1.6b at its full published
    width (d 2,048, 32 heads MHA, hd 64, d_ff 5,632, vocab 100,352,
    untied), cut to 12 of its 24 layers (1.03 B parameters) to keep the
    whole run inside its time once phase 28 came.  (a) Two gloo ranks share
    the card, ``default_options``' dtypes (bf16 parameters, float32 Adam
    moments), float32 error feedback, remat, each rank its own seeded 2 x
    1,024 tokens; 2 steps of grads, ``compressed_grad_sync`` over the
    group, ``apply_updates``: the ranks' parameters equal bit for bit after
    each step (sha256), the error-feedback identity on the last layer's
    ``attn/wo`` within 1e-5; walls (grads, sync, AdamW), bytes handed to
    gloo, peaks, flash launches; then ``compressed_grad_sync`` over a
    one-rank nccl group and a one-rank gloo group in this process equal to
    the sync with no group, bit for bit.  (b) The GPipe pipeline
    (``make_pp_loss``, M 4 microbatches of 1 x 1,024) over 2 and 4 gloo
    stages (12 and 6 layers each): in float32 with TF32 off the loss
    within rtol 2e-4 of the plain model's ``loss_fn`` on this process and
    every gradient within 1e-3 by relative norm; then bf16 forward and
    backward walls beside the plain model's and the bubble share (S - 1) /
    (M + S - 1); flash launches a step (2 forwards under remat and 1
    backward a layer a tick).  (c) Both flash kernels at stablelm's shape
    (G 32, P 1, hd 64, 1,024 causal, B 1 and 2) against their plain
    versions, bf16 and float32, timed beside SDPA.  (d) The sharding rules
    (``param_shardings`` over ``model.abstract_params``, no storage) of
    every registry architecture at both production meshes, with each one's
    parameter bytes a device (host only).  The flash and flash-backward
    rows gain ``launches_phase_26`` and ``phase_26``.  Alone: build the
    library, set TF32 off, then ``chip_smoke.train_dist_phase(torch.device(
    "cuda"), chip_smoke.card_line())`` from a script under ``build/``.
27. ``Policy.mesh``: four gloo ranks share the card, each a device of a
    ``ProcessMesh`` (``launch/mesh.py``) under ``make_policy``, holding
    the dense leaves whole and its own expert slots
    (``carry.init_rank_params``).  (a) Llama 4 Scout at full width, 6 of
    48 layers, bf16, at (1, 4): phase 9's mix cut to 12 requests through
    ``DRScheduler(4)`` x ``ServeEngine(4 slots)`` on every rank, under
    phase 18's final placement, against the same requests served by
    ``Policy(ep_shards=4)`` in this process first (freed before the
    spawn): every rank's tokens and logits equal (sha256); logits within
    0.125 x max(1, |stacked|) wherever the router's counts and drops agree
    (the calls where it sent a token elsewhere are logged), tokens equal
    but within 2 x 0.125 of a tie; launches a rank.  (a') The same in
    float32 at 2 layers, two prompts (1,024 and 1,022 tokens) and 8
    teacher-forced decode steps each: logits within 1e-3, greedy tokens
    equal but within 2e-3 of a tie.  (b) One MoE layer at full width,
    float32, 2 x 512 tokens, capacity 8.0, at (1, 4) and (2, 2):
    ``moe_apply`` dense, native ragged and masked ragged
    (``REPRO_DISABLE_NATIVE_RAGGED=1``) and ``moe_apply_replicated``
    against the stacked path and ``moe_ref``: counts, drops and occupied
    rows equal (shipped rows at (1, 4)), ``y`` within 1e-4 x max(1,
    |ref|), every rank's equal.  (c) At (2, 2), 2 layers, capacity 8.0: a
    B 2 x 1,024 prefill and a decode step against ``Policy(ep_shards=2)``
    within 0.125, and a B 1 prefill refused (the reference's data-axis
    contract).  (d) ``dispatch_count`` on every rank's own hop 1, hop 2
    and decode inputs, bit for bit against its plain version, timed on
    rank 0.  (e) Per rank: prefill and decode walls (the slowest rank's
    median) beside the stacked run's and phase 18's, bytes handed to gloo
    by collective, peak memory beside the reckoning, the card's use.  The
    dispatch_count and flash rows gain ``launches_phase_27`` (a rank).
    Alone: set TF32 off, ``build.library()``, then
    ``chip_smoke.mesh_phase(torch.device("cuda"), chip_smoke.card_line())``
    from a script under ``build/`` (a fixed placement stands in for phase
    18's).
28. Training under ``Policy.mesh``.  (a) One MoE layer of Llama 4 Scout
    at full width, float32, capacity 8.0, slots permuted, on four gloo
    ranks at (1, 4) and (2, 2): ``moe_apply`` on the dense and native
    ragged transports (2 x 512 tokens, loss ``sum(y * C)``) and
    ``moe_apply_replicated`` (2 x 511, no model axis divides it; ``+ 0.5
    aux``): every gradient a rank holds (``x``, router, shared expert, its
    ``wi`` / ``wo`` slots) within 1e-4 x max(1, |stacked|) of the stacked
    ``Policy(ep_shards=4)`` gradients computed in this process first
    (saved under the git-ignored ``build/phase28/`` a quarter of the slots
    a file, freed before the spawn); counts, drops and occupied rows
    equal; the whole leaves' gradients equal on every rank and the slots'
    on each model coordinate's data replicas; walls, peaks, gloo bytes.
    (b) Scout at full width, 1 of 48 layers (the reckoning: 4 ranks at one
    layer need 88.7 GB), bf16, ``make_policy(cfg, mesh, "train",
    default_options)`` (remat ``"nothing"``, bf16 moments) at (1, 2) on
    two gloo ranks, 2 x 1,024 tokens repeated for 3 steps at
    ``OptConfig(lr=1e-3, warmup=1)``: each rank's loss and ``grad_norm``
    equal on both ranks and within 1e-2 / 5e-2 of the stacked
    ``Policy(ep_shards=2)`` step run first in this process; every dense
    leaf equal on both ranks after every step (sha256); the loss falls;
    then the safe point: both controllers' decision digests equal, the
    controller's move (or, if it keeps every expert on its rank, a forced
    swap across ranks) applied to ``wi``, ``wo`` and both moments, each
    equal after it to the gathered tensor from before it, permuted, bit for
    bit.  (c) The walls a step (the slowest rank): the whole step, AdamW,
    the collectives with autograd off; the stacked step's; gloo bytes by
    collective; peak memory a rank and the card's use beside the
    reckoning; ``dispatch_count`` and flash forward and backward launches
    a step on each rank, which the rows gain as ``launches_phase_28``.
    Alone: set TF32 off, ``build.library()``, then
    ``chip_smoke.mesh_train_phase(torch.device("cuda"),
    chip_smoke.card_line())`` from a script under ``build/``.

The last two lines of standard output are the ``kernels`` JSON line and
the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

SENT = 2**31 - 1  # repro_torch.core.hashing.KEY_SENTINEL: a padded or empty key
F32_EXACT = 2**24  # float32 state counts are exact below this
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak (at the 700 W limit)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor cores; f32
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCES = {
    "route_bucketize": "src/repro_torch/kernels/csrc/route_kernels.cu",
    "lookup_dispatch": "src/repro_torch/kernels/csrc/route_kernels.cu",
    "partition_apply": "src/repro_torch/kernels/csrc/batch_kernels.cu",
    "dispatch_count": "src/repro_torch/kernels/csrc/batch_kernels.cu",
    "sketch_update": "src/repro_torch/kernels/csrc/sketch_kernels.cu",
}
# H100, an SM each clock: 4 partitions x 16 lanes of the integer ALU pipe
# (LOP3, SHF, LEA, IADD3, ISETP), 4 x 16 of the FMA pipe that also runs the
# integer multiplies (IMAD, IMUL), and one warp instruction a partition
PIPE_LANES_PER_SM = {"alu": 64, "fma": 64, "issue": 128}
# records per tile of each kernel's one-pass lane rank (csrc/lane_rank.cuh, kTileOf)
TILES = {"lookup_dispatch": 4096, "route_bucketize": 4096, "dispatch_count": 8192}
# each kernel's own device work, by the profiler's names for it
DEVICE_NAMES = {
    "route_bucketize": ("fill_kernel", "route_rank_kernel"),
    "lookup_dispatch": ("route_rank_kernel", "Memset"),
    "partition_apply": ("partition_apply_kernel",),
    "dispatch_count": ("dispatch_rank_kernel", "Memset"),
    "sketch_update": ("sketch_rows_kernel", "Memset"),
}
REPLACES = {
    "route_bucketize": "src/repro/kernels/route_bucketize.py:155",
    "lookup_dispatch": "src/repro/kernels/lookup_dispatch.py:136",
    "partition_apply": "src/repro/kernels/partition_apply.py:72",
    "dispatch_count": "src/repro/kernels/dispatch_count.py:60",
    "sketch_update": "src/repro/kernels/sketch_update.py:50",
    "flash_attention": "src/repro/kernels/flash_attention.py:73",
}
# phase 2's three streaming drivers: DRConfig fields beside the job's own
DRIVERS = {"serial": dict(overlap_exchange=False), "depth 1": {},
           "depth 2": dict(pipeline_depth=2)}
# phase 6: the paper's Fig. 4 batch jobs (benchmarks/bench_spark_like.py)
BATCH_RECORDS = 10_000_000
BATCH_KEYS = 1_000_000
BATCH_PARTS = 35
EXPONENTS = (1.0, 1.2, 1.4, 1.6, 1.8, 2.0)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, *, warmup=3, reps=20) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# own_device_time's sessions, and those that kept none of the kernels
# they timed and ran again
PROFILER = {"sessions": 0, "empty": 0, "fallback": 0}


def device_ms(fn, *, n=20) -> float:
    """Device time of ``fn()`` in ms: ``n`` calls queued behind a spin
    kernel (``torch.cuda._sleep``), CUDA events on the card around the
    ``n`` calls, divided by ``n``.  The spin holds the stream until the
    host has launched every call, so the host's launches are not in the
    time: the event before the calls must still be pending when the last
    call is queued, else the spin is doubled and the calls run again, and
    a ``fn()`` whose launches outlast eight doublings (one that waits for
    the card) raises.  The time is the stream's span: the card's kernels,
    copies and memsets back to back, with the gaps between them.  Not the
    profiler: its sessions now and then keep no device operation
    (:func:`own_device_time`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 23  # about 4 ms at the H100's clock
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / n
        cycles *= 2
    raise AssertionError(f"the launches of {n} calls outlasted a spin of {cycles // 2:,} cycles")


def own_device_time(fn, names, *, flush=None, n=20):
    """``(ms, {device kernel: ms}, device operations per call)`` of the
    card's kernels and memsets whose names contain one of ``names``, over
    ``n`` calls of ``fn()`` after a warm-up (``torch.profiler``): each
    kernel's mean duration times its launches a call (its events over
    ``n``, rounded), so a session that loses a few events (seen: 18 of 20)
    does not bias the time.  ``flush()``, run before each call and not
    counted, evicts the inputs from the L2 cache.  The device operations
    are read from the kineto results (:func:`device_ops`) of a session
    that records the host too.  Now and then a session keeps the host's
    launches and no device operation at all (seen on an H100: about one
    in five late in a long run, none when its phase runs alone, and a
    session run straight after such one mostly keeps them all; once, five
    in a row in phase 20); it is run again, up to five times.  Then,
    without ``flush``, the time is :func:`device_ms`'s (every kernel of
    the call, by events behind a spin; no split, 0 operations); with it,
    this raises."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        PROFILER["sessions"] += 1
        total: dict[str, float] = {}  # ms and events by full kernel name
        seen: dict[str, int] = {}
        for name, start, end in device_ops(prof):
            if any(s in name for s in names):
                total[name] = total.get(name, 0.0) + (end - start) / 1e3
                seen[name] = seen.get(name, 0) + 1
        by_name: dict[str, float] = {}
        ops = 0
        for full, ms in total.items():
            per_call = max(1, round(seen[full] / n))
            short = next(s for s in names if s in full)
            by_name[short] = by_name.get(short, 0.0) + ms / seen[full] * per_call
            ops += per_call
        if by_name:
            return sum(by_name.values()), by_name, ops
        PROFILER["empty"] += 1
        log(f"profiler: session {attempt + 1} recorded none of {names}"
            + ("; running it again" if attempt < 4 else ""))
    if flush is not None:
        raise AssertionError(f"the profiler saw none of {names} in five sessions")
    # the sessions keep losing the device's events: time the calls' device
    # work by CUDA events behind a spin instead (device_ms: every kernel fn
    # launches, not only the named ones), and say so
    PROFILER["fallback"] += 1
    ms = device_ms(fn)
    log(f"profiler: five sessions recorded none of {names}; device time by events behind a "
        f"spin instead: {ms:.4f} ms")
    return ms, {"device_ms, all of the call's kernels": ms}, 0


def device_op_count(fn, *, tries=6) -> int:
    """The device operations (kernels, copies, memsets) of one ``fn()``
    call, counted in ``torch.profiler`` sessions of one call each.  A
    session may keep none of them, or only a few (:func:`own_device_time`),
    so the count is taken when two sessions agree; after ``tries``
    sessions without two that agree this raises."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        PROFILER["sessions"] += 1
        n = len(device_ops(prof))
        if not n:
            PROFILER["empty"] += 1
        elif n in seen:
            return n
        seen.append(n)
    raise AssertionError(f"no two of {tries} profiler sessions kept the same device "
                         f"operations: {seen}")


def l2_flush(dev):
    """A write over 128 MiB, more than the H100's 50 MB L2 (an elementwise
    kernel, so no name in DEVICE_NAMES matches it)."""
    buf = torch.zeros(32 << 20, dtype=torch.int32, device=dev)
    return lambda: buf.add_(1)


@contextlib.contextmanager
def dirty_outputs():
    """Inside, every tensor that ``torch.empty`` and ``torch.empty_like``
    make starts as 0x5A bytes, so an output cell a kernel forgets to write
    shows (the wrappers allocate their outputs and scratch with them)."""
    empty, empty_like = torch.empty, torch.empty_like

    def dirty(t):
        if t.numel():
            t.view(-1).view(torch.uint8).fill_(0x5A)
        return t

    torch.empty = lambda *a, **k: dirty(empty(*a, **k))
    torch.empty_like = lambda *a, **k: dirty(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def differ_under_load(dev, fn, want, *, rounds=3, streams=4) -> tuple[int, int]:
    """``(outputs that differ, outputs)``: ``fn()`` launched on ``streams``
    streams at once, ``rounds`` times, beside a 256 MiB copy looping on
    another stream; each output tuple is held bit for bit to ``want``, an
    idle card's."""
    torch.cuda.synchronize()
    src = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    side = [torch.cuda.Stream() for _ in range(streams + 1)]
    differ = total = 0
    for _ in range(rounds):
        outs = []
        with torch.cuda.stream(side[-1]):
            for _ in range(4):
                dst.copy_(src)
        for st in side[:-1]:
            with torch.cuda.stream(st):
                outs.append(fn())
        torch.cuda.synchronize()
        differ += sum(not all(torch.equal(g, w) for g, w in zip(o, want)) for o in outs)
        total += len(outs)
        del outs
    return differ, total


def excess_over_bf16_rounding(got, ref) -> float:
    """The most by which bf16 ``got`` lies farther from the float32 ``ref``
    than half a bf16 ulp (the output's own rounding): what the computation
    before the final rounding got wrong, in absolute terms."""
    got = got.float()
    _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
    half_ulp = torch.ldexp(torch.ones_like(ref), e - 9)  # bf16 keeps 8 significant bits
    return float(((got - ref).abs() - half_ulp).max())


def sm_clocks_per_s() -> float:
    """The card's SMs x the highest SM clock that nvidia-smi reads (Hz)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6


def ops_ms(ops: dict) -> float:
    """The least time of integer operations ``{"alu": n, "fma": n}`` on the
    card: the slowest of the ALU pipe, the FMA pipe and the issue of one
    instruction a lane, each at its lanes an SM (``PIPE_LANES_PER_SM``)."""
    alu, fma = ops["alu"], ops["fma"]
    lanes = PIPE_LANES_PER_SM
    clocks = max(alu / lanes["alu"], fma / lanes["fma"], (alu + fma) / lanes["issue"])
    return clocks / sm_clocks_per_s() * 1e3


def sketch_ops(n, n_valid, depth) -> dict:
    """Integer operations of sketch_update over n records (n_valid valid)
    into depth rows of a power-of-two width, by pipe: on the ALU pipe 1 a
    record (the flag test), 2 a valid record (the hash's first step, a
    shift and an xor) and 6 a valid record-row (the xor with the row's
    seed, none for row 0; two shift-xors, the column's mask fused into the
    last; the address, one LEA from the row's base); on the FMA pipe the
    hash's two multiplies a valid record-row.  At depth 4: 26 ALU and 8 FMA
    a valid record (``sketch_ab.py --sass`` holds the loop's SASS to it).
    The shared atomic adds are not counted."""
    return {"alu": n + n_valid * (2 + 6 * depth - 1), "fma": n_valid * 2 * depth}


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.dtype}{list(g.shape)} vs {w.dtype}{list(w.shape)}")
        if g.numel():
            err = max(err, float((g.to(torch.float64) - w.to(torch.float64)).abs().max()))
    return err


def route_bytes(keys, vals, tables, num_lanes, capacity=None, split=False) -> int:
    """Bytes the function must move: each input read once, each output
    written once (every send-buffer cell, fills included)."""
    w, n = keys.shape
    b = tables[0].numel()
    nbytes = w * n * (4 + 1)                       # keys, valid
    nbytes += b * 4 * (3 if split else 2) + tables[2].numel() * 4
    nbytes += w * n * 8 + w * num_lanes * 4        # part, slot, counts
    if capacity is not None:
        dim = vals.shape[2]
        nbytes += w * n * 4 * dim                  # vals
        nbytes += w * num_lanes * capacity * (1 + 4 + 4 + 4 * dim)
    return nbytes


def kernel_rows(timing, launches, errs, equal, *, phase, path_phase, flushed=None,
                int_ops=None) -> list[dict]:
    """The ``kernels`` line's entries: ``timing[name] = (ms, plain_ms,
    bytes, (device ms, by device kernel, device operations per call))``; no
    single PyTorch call computes any of these functions, so ``library_ms``
    is null.  ``flushed[name]``, where given, is the kernel's device time
    with an L2 flush between calls, kept beside the unflushed one as
    ``device_ms_flushed``.  ``int_ops[name]``, where given, is the integer
    operations the call does by pipe (``sketch_ops``): its bound is then
    the larger of bytes over the memory rate and ``ops_ms`` of them
    (``bound_by``); elsewhere the bound is the bytes'."""
    rows = []
    flushed, int_ops = flushed or {}, int_ops or {}
    for name, (k_ms, p_ms, nbytes, (d_ms, split, ops)) in timing.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops_ms(int_ops[name]) if name in int_ops else 0.0
        bound_ms = max(bytes_ms, op_ms)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name], "equal": all(equal[name]),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if op_ms > bytes_ms else "bytes",
            "bytes": nbytes, "library_ms": None, "device_ms": d_ms,
            "device_split_ms": split, "device_ops_per_call": ops,
        })
        if name in int_ops:
            rows[-1].update(int_ops=int_ops[name], bound_bytes_ms=bytes_ms, bound_ops_ms=op_ms)
        cold = ""
        if name in flushed:
            rows[-1]["device_ms_flushed"] = flushed[name]
            cold = (f"; with an L2 flush between calls {flushed[name]:.4f} ms "
                    f"({100 * bound_ms / flushed[name]:.1f}%)")
        log(f"phase {phase}: {name}: {k_ms:.4f} ms by events around one call, device time "
            f"{d_ms:.4f} ms ({100 * bound_ms / d_ms:.1f}% of the bound {bound_ms:.4f} ms by "
            f"{rows[-1]['bound_by']}, {nbytes} bytes; by device kernel "
            f"{', '.join(f'{k} {v:.4f}' for k, v in split.items())}; "
            f"{ops:g} device operations a call{cold}), plain {p_ms:.4f} ms; launches in phase "
            f"{path_phase}: {launches[name]}"
            + (f"; bounds: bytes {bytes_ms:.4f} ms, integer operations {int_ops[name]} "
               f"{op_ms:.4f} ms" if name in int_ops else ""))
    return rows


def phase_walls(job) -> dict:
    """Sums of the count, ship and hidden walls (s) the job's telemetry
    records from here on (the per-window sums reset at each safe point)."""
    sums = {"count": 0.0, "ship": 0.0, "hidden": 0.0}
    record = job.telemetry.record_exchange

    def recording(stats):
        for k in sums:
            v = getattr(stats, f"{k}_wall_s")
            if v is not None:
                sums[k] += v
        record(stats)

    job.telemetry.record_exchange = recording
    return sums


def device_ops(prof) -> list[tuple[str, float, float]]:
    """``(name, start_us, end_us)`` of every device operation (kernels,
    copies, memsets) of a finished profile, read from its kineto results:
    the profiler's own event tree (``prof.events()``) takes minutes to
    build for a step of 400,000 launches."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def busy_ms(prof) -> float:
    """The union of the card's kernels, copies and memsets in a profile (ms)."""
    spans = sorted((a, b) for _, a, b in device_ops(prof))
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def drive(job, name, batches, kernels, *, phase=2, after=None) -> dict:
    """Run ``batches`` through ``job`` (depth 1 batch by batch through
    ``process_batch``, the others through ``run``) with the kernels' launch
    counts and the host-sync audit set to 0 just before; time the run and
    one drain, synchronized, per batch (a synchronize after each batch
    would fold the in-flight merge into every batch's wall).  ``after``,
    where given, is ``(i, fn)``: ``fn(job)`` runs between batch ``i`` and
    the next (``run`` is then called on each side of it).  Logs each
    batch, the telemetry's phase walls and the count walls of steady-state
    batches (no action at the batch or the one before); returns the
    metrics, the wall per batch, the launches and the audit."""
    from repro_torch import compat

    walls = phase_walls(job)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    compat.reset_host_sync_count()
    t = time.perf_counter()
    ms = feed(job, name, batches, after)
    job.state_keys  # the drain
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / len(batches) * 1e3
    syncs = compat.host_sync_count()
    launches = {k.__name__: k.launches for k in kernels}
    for m in ms:
        log(f"  {name} batch {m.batch}: imbalance {m.imbalance:.4f} worker "
            f"{m.worker_imbalance:.4f} {m.action} ({m.reason}) partitions {m.num_partitions} "
            f"split keys {m.split_keys} rel_mig {m.relative_migration:.4f} "
            f"migration rows {m.migration_rows} overflow {m.overflow} state_rows "
            f"{m.state_rows} shipped {m.shipped_rows} pipelined {m.pipelined} exchange wall "
            f"{m.exchange_wall_s * 1e3:.2f} ms host wall {m.wall_time_s * 1e3:.2f} ms "
            f"overlap_fraction {m.overlap_fraction:.4f}")
    assert all(m.overlapped == (not name.startswith("serial")) for m in ms), name
    steady = [m.exchange_wall_s * 1e3 for i, m in enumerate(ms)
              if i and m.action == "noop" and ms[i - 1].action == "noop"]
    shown = walls["hidden"] + walls["ship"]
    log(f"phase {phase}: {name}: wall per batch {wall_ms:.2f} ms (run + one drain, "
        f"synchronized, / {len(batches)}); host syncs outside safe points {syncs}; telemetry "
        f"walls: count {walls['count'] * 1e3:.2f} ms, ship {walls['ship'] * 1e3:.2f} ms, hidden "
        f"{walls['hidden'] * 1e3:.2f} ms, hidden / (hidden + ship) "
        f"{walls['hidden'] / shown if shown else 0.0:.4f}; steady-state count walls (ms) "
        f"{[round(x, 3) for x in steady]}")
    return dict(job=job, ms=ms, wall_ms=wall_ms, launches=launches, syncs=syncs)


def assert_same_drivers(runs, phase=2) -> None:
    """Serial, depth 1 and depth 2 (``runs[name]["ms"]`` / ``["job"]``): equal
    metrics but for the walls, ``overlap_fraction`` (a ratio of walls) and,
    against serial, ``state_rows`` (overlapped: as of the last drain) and
    the drivers' own flags; equal final state."""
    skip = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
    pairs = [("serial", "depth 1", skip | {"state_rows", "overlapped", "pipelined"}),
             ("serial", "depth 2", skip | {"state_rows", "overlapped", "pipelined"}),
             ("depth 1", "depth 2", skip | {"pipelined"})]
    for x, y, other in pairs:
        for a, b in zip(runs[x]["ms"], runs[y]["ms"], strict=True):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            diff = {k: (da[k], db[k]) for k in da if k not in other and da[k] != db[k]}
            assert not diff, (x, y, a.batch, diff)
        for t in ("state_keys", "state_vals"):
            assert torch.equal(getattr(runs[x]["job"], t), getattr(runs[y]["job"], t)), (x, y, t)
    log(f"phase {phase}: serial, depth 1 and depth 2: {len(runs['serial']['ms'])} batches, "
        f"trajectories equal (walls, state_rows and the drivers' flags apart; depth 1 == "
        f"depth 2 in state_rows too), final states equal")


def trace_serial_batch(job, batch) -> dict:
    """One serial batch with ``time.perf_counter`` marks around each host
    step of ``process_batch`` and CUDA events around the work each step
    enqueues (its device span: from the card reaching the step to the end
    of the step's work), the outermost step only, so nothing counts twice;
    then a second batch under ``torch.profiler`` (CUDA) for the card's busy
    time and its largest kernels.  The steps: the upload, the shuffle step,
    the merge, host fetches (the first waits for the batch's device work),
    the telemetry record, the DR master's observe and evaluate, the
    telemetry snapshot, the state-row count (a sync) and a migration."""
    import repro_torch.core.streaming as streaming
    from torch.profiler import ProfilerActivity, profile

    host: dict[str, float] = {}
    spans: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
    depth = [0]

    def timed(name, fn):
        def run(*a, **k):
            depth[0] += 1
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                end.record()
                if depth[0] == 0:
                    host[name] = host.get(name, 0.0) + (time.perf_counter() - t) * 1e3
                    spans.append((name, start, end))

        return run

    patches = [(job, "_upload"), (job, "_shuffle"), (streaming, "merge_into"),
               (streaming, "host_fetch"), (streaming, "shuffle_stats"), (job.drm, "observe"),
               (job.telemetry, "snapshot"), (job, "_state_rows"), (job.drm, "evaluate"),
               (job, "_migrate_state")]
    # (object, name, what it held, whether it held it itself or by its class)
    saved = [(obj, name, getattr(obj, name), name in vars(obj)) for obj, name in patches]
    try:
        for obj, name, fn, _ in saved:
            setattr(obj, name, timed(name, fn))
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = job.process_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for obj, name, fn, own in saved:
            if own:
                setattr(obj, name, fn)
            else:
                delattr(obj, name)
    device: dict[str, float] = {}
    for name, start, end in spans:
        device[name] = device.get(name, 0.0) + start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        job.process_batch(batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name[:60]] = kernels.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    top = dict(sorted(((k, round(v, 3)) for k, v in kernels.items()), key=lambda kv: -kv[1])[:8])
    return {"action": m.action, "host": {k: round(v, 3) for k, v in host.items()},
            "wall_ms": wall_ms, "steps_ms": sum(host.values()), "prof_wall_ms": prof_wall_ms,
            "busy_ms": busy_ms(prof), "device": {k: round(v, 3) for k, v in device.items()},
            "kernels": top}


def device_idle_share(job, batches) -> dict:
    """The card's idle share over ``job.run(batches)`` and one drain under
    ``torch.profiler`` (CUDA only): 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        job.run(batches)
        job.state_keys
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy = busy_ms(prof)
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle": 1.0 - busy / wall_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.hashing import KEY_SENTINEL
    from repro_torch.core.partitioner import uniform_partitioner
    from repro_torch.core.state import merge_into
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.lookup_dispatch import (RANK_KERNELS, lookup_dispatch,
                                                     lookup_dispatch_plain)
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sent = int(KEY_SENTINEL)

    # ---- phase 1: build and describe -----------------------------------
    t = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t
    card = card_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    built = ", ".join(p.name for p in build.sources())
    log(f"phase 1: built {built} in {build_s:.2f} s; card {card}; "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; {nvcc}")

    # ---- phase 2: the full-size DR loop, three drivers -------------------
    job_kw = dict(num_workers=8, num_partitions=32, state_capacity=262_144,
                  capacity_factor=2.0)
    dr_kw = dict(imbalance_trigger=1.2, migration_cost_weight=0.2)
    t = time.perf_counter()
    batches = list(drifting_zipf(8, 4_194_304, num_keys=1_000_000, exponent=1.3,
                                 drift_every=3, drift_fraction=0.3, seed=0))
    log(f"phase 2: generated 8 x 4,194,304 keys in {time.perf_counter() - t:.1f} s")
    all_keys = torch.as_tensor(np.concatenate(batches), device=dev)
    uniq, counts = torch.unique(all_keys, return_counts=True)
    assert int(counts.max()) < 2**24
    rng = np.random.default_rng(0)
    pick = np.concatenate([[int(torch.argmax(counts))],
                           rng.choice(len(uniq), 63, replace=False)])
    exact = [(int(uniq[i]), float(counts[i])) for i in pick]  # for phase 25
    # warm-up, untimed: the caching allocators' device blocks and pinned
    # blocks, so that no timed run pays for them first
    for extra in DRIVERS.values():
        StreamingJob(device="cuda", dr=DRConfig(**dr_kw, **extra), **job_kw).run(batches[:2])
    runs, steady = {}, {}
    for name, extra in DRIVERS.items():
        job = StreamingJob(device="cuda", dr=DRConfig(**dr_kw, **extra), **job_kw)
        r = runs[name] = drive(job, name, batches, (route_bucketize, lookup_dispatch))
        r["final"] = (job.state_keys.clone(), job.state_vals.clone())  # for phase 16 (a)
        ms = r["ms"]
        assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
        reps = [i for i, m in enumerate(ms) if m.repartitioned]
        assert reps, "no repartition was taken"
        before = np.mean([m.imbalance for m in ms[: reps[0] + 1]])
        after = np.mean([m.imbalance for m in ms[reps[0] + 1:]])
        assert after < before, (before, after)
        for i in pick:
            key, want = int(uniq[i]), float(counts[i])
            got = job.state_count(key)
            assert got == want, (name, key, got, want)
        assert all(v > 0 for v in r["launches"].values()), (name, r["launches"])
        log(f"phase 2: {name}: repartitions at batches {reps}; mean imbalance {before:.4f} -> "
            f"{after:.4f}; 64 exact counts; launches {r['launches']}")
    assert_same_drivers(runs)
    # steady state: the same jobs go on over the same batches with the
    # policies off, so no action drains the pipeline (every batch above
    # repartitions: the heaviest key alone outweighs a partition's share)
    for name, r in runs.items():
        r["job"].dr_enabled = False
        steady[name] = drive(r["job"], name + " steady", batches,
                             (route_bucketize, lookup_dispatch))
        assert all(m.action == "noop" and m.overflow == 0 for m in steady[name]["ms"])
    assert_same_drivers(steady)
    assert all(m.pipelined for m in steady["depth 2"]["ms"][1:])
    assert steady["depth 2"]["syncs"] == 0, steady["depth 2"]["syncs"]
    phase2 = {name: dict(ms=r["ms"], final=r.pop("final"), wall_ms=r["wall_ms"])
              for name, r in runs.items()}
    steady_walls = {name: r["wall_ms"] for name, r in steady.items()}
    launches = runs["depth 1"]["launches"]
    job = runs["serial"]["job"]
    # serial batches traced: host steps by perf_counter, then their device
    # time by the profiler, each on a batch of its own; one that takes the
    # repartition phase 2 takes at every batch, one with the policies off
    job.dr_enabled = True
    traces = [trace_serial_batch(job, batches[-1])]
    job.dr_enabled = False
    traces.append(trace_serial_batch(job, batches[-1]))
    idle = device_idle_share(runs["depth 1"]["job"], batches[:4])
    for rs in (runs, steady):
        for name in ("depth 1", "depth 2"):
            del rs[name]["job"]
    torch.cuda.empty_cache()

    # ---- phase 3: each kernel against its plain version ----------------
    part = job.drm.partitioner
    w = job.num_workers
    keys = torch.as_tensor(batches[-1].astype(np.int32), device=dev).reshape(w, -1)
    valid = keys != sent
    vals = torch.ones(keys.shape + (1,), dtype=torch.float32, device=dev)
    cap = job._shuffle_spec.capacity
    state_keys = job.state_keys.clone()
    state_valid = state_keys != sent
    top = int(uniq[pick[0]])
    split = part.with_splits({top: 4})
    empty = uniform_partitioner(job.num_partitions, part.num_hosts, part.seed)

    def padded(p, *, n_part, pad_empty):
        return ops.pad_heavy_tables(p.tables(dev), num_partitions=n_part, pad_empty=pad_empty)

    equal = {"route_bucketize": [], "lookup_dispatch": []}
    errs = {"route_bucketize": 0.0, "lookup_dispatch": 0.0}
    # the same keys with a seeded tenth turned into invalid sentinel records
    gen = torch.Generator(device=dev).manual_seed(0)
    holes = torch.rand(keys.shape, generator=gen, device=dev) < 0.1
    keys_holed = keys.masked_fill(holes, sent)
    valid_holed = keys_holed != sent
    # the least-load pick's load vectors over the 32 partitions: many equal
    # entries (ties keep the first hash), and the split key's home, where
    # its first replica lies, at 1e9
    tied = torch.arange(8, dtype=torch.float32, device=dev).repeat_interleave(4)
    home = int(split.lookup_np(np.asarray([top], np.int32))[0])
    hot_replica = torch.ones(32, dtype=torch.float32, device=dev)
    hot_replica[home] = 1e9
    rb_cases = [
        ("main path, splits on", part, 32, cap, True, keys, valid, None),
        ("splits off", part, 0, cap, True, keys, valid, None),
        ("split key x4", split, 32, cap, True, keys, valid, None),
        ("invalid sentinel records", split, 32, cap, True, keys_holed, valid_holed, None),
        ("empty heavy table, tile padded", empty, 32, cap, True, keys, valid, None),
        ("empty heavy table, unpadded", empty, 0, cap, False, keys, valid, None),
        ("capacity overflow", split, 32, 4096, True, keys, valid, None),
        ("least-load pick, tied loads", split, 32, cap, True, keys_holed, valid_holed, tied),
        ("least-load pick, a replica at 1e9", split, 32, cap, True, keys, valid, hot_replica),
    ]
    for name, p, n_part, c, pad_empty, k, v, loads in rb_cases:
        hk, hp, hr = padded(p, n_part=n_part, pad_empty=pad_empty)
        args = (k, v, vals, hk, hp, p.tables(dev).host_to_part, hr)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=w, capacity=c,
                  key_fill=sent, num_partitions=n_part, part_loads=loads)
        got = route_bucketize(*args, **kw)
        want = route_bucketize_plain(*args, **kw)
        torch.cuda.synchronize()
        ok = all(torch.equal(g, x) for g, x in zip(got, want))
        errs["route_bucketize"] = max(errs["route_bucketize"], max_abs_err(got, want))
        equal["route_bucketize"].append(ok)
        dropped = int((got[2] - c).clamp(min=0).sum())
        log(f"phase 3: route_bucketize [{name}] B={hk.numel()} cap={c} "
            f"invalid={int((~v).sum())} dropped={dropped} equal={ok}")
    ld_cases = [
        ("migrate path (final state)", part, 0, state_keys, state_valid, None),
        ("split key x4", split, 32, state_keys, state_valid, None),
        ("empty heavy table", empty, 0, keys, valid, None),
        ("least-load pick, tied loads", split, 32, keys, valid, tied),
        ("least-load pick, a replica at 1e9", split, 32, keys, valid, hot_replica),
    ]
    for name, p, n_part, k, v, loads in ld_cases:
        hk, hp, hr = padded(p, n_part=n_part, pad_empty=False)
        args = (k, v, hk, hp, p.tables(dev).host_to_part, hr)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=w, num_partitions=n_part,
                  part_loads=loads)
        got = lookup_dispatch(*args, **kw)
        want = lookup_dispatch_plain(*args, **kw)
        torch.cuda.synchronize()
        ok = all(torch.equal(g, x) for g, x in zip(got, want))
        errs["lookup_dispatch"] = max(errs["lookup_dispatch"], max_abs_err(got, want))
        equal["lookup_dispatch"].append(ok)
        log(f"phase 3: lookup_dispatch [{name}] B={hk.numel()} n={k.shape[1]} equal={ok}")

    # the edges of the one-pass rank and of the fill, outputs handed out dirty
    lib = build.library()
    assert {k: lib.rk_tile_records(i) for k, i in RANK_KERNELS.items()} == TILES
    tile = TILES["route_bucketize"]  # lookup_dispatch's too
    wide = uniform_partitioner(1030, part.num_hosts, part.seed)  # parts over all 1024 lanes
    n35 = keys.numel() // 35
    rows35 = keys.reshape(-1)[: 35 * n35].view(35, -1)
    none = torch.full_like(keys, sent)
    edge_cases = [
        ("below one tile", split, 32, keys[:, :1000], w, cap),
        ("3 tiles + 1", split, 32, keys[:, : 3 * tile + 1], w, cap),
        ("35 stacked rows", split, 32, rows35, w, 2 * n35 // w),
        ("1024 lanes", wide, 0, keys, 1024, 4096),
        ("3 x 5 x 200,001 cells", split, 32, keys[:3], 5, 200_001),
        ("capacity 0", split, 32, keys, w, 0),
        ("every record invalid", split, 32, none, w, cap),
        ("no records", split, 32, keys[:, :0], w, cap),
    ]
    for name, p, n_part, k, lanes, c in edge_cases:
        k = k.contiguous()
        v = k != sent
        x = torch.ones(k.shape + (1,), dtype=torch.float32, device=dev)
        hk, hp, hr = padded(p, n_part=n_part, pad_empty=True)
        h2p = p.tables(dev).host_to_part
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=lanes, num_partitions=n_part)
        for kname, run, plain, extra in [
                ("lookup_dispatch", lookup_dispatch, lookup_dispatch_plain, {}),
                ("route_bucketize", route_bucketize, route_bucketize_plain,
                 dict(capacity=c, key_fill=sent))]:
            args = (k, v) + ((x,) if kname == "route_bucketize" else ()) + (hk, hp, h2p, hr)
            want = plain(*args, **kw, **extra)
            with dirty_outputs():
                got = run(*args, **kw, **extra)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, x_) for g, x_ in zip(got, want))
            errs[kname] = max(errs[kname], max_abs_err(got, want))
            equal[kname].append(ok)
            log(f"phase 3: {kname} [{name}] W={k.shape[0]} n={k.shape[1]} L={lanes}"
                f"{f' cap={c}' if extra else ''} invalid={int((~v).sum())} dirty outputs "
                f"equal={ok}")
    del none, rows35
    # into a recycled set, as the overlapped driver's pool hands one out: an
    # earlier call's send buffers, dirtied; the holed keys leave cells empty
    hk, hp, hr = padded(part, n_part=32, pad_empty=True)
    h2p = part.tables(dev).host_to_part
    kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, capacity=cap,
              key_fill=sent, num_partitions=32)
    out = route_bucketize(keys, valid, vals, hk, hp, h2p, hr, **kw)[3:]
    for b in out:
        b.view(-1).view(torch.uint8).fill_(0x5A)
    args = (keys_holed, valid_holed, vals, hk, hp, h2p, hr)
    want = route_bucketize_plain(*args, **kw)
    got = route_bucketize(*args, **kw, out=out)
    torch.cuda.synchronize()
    ok = (all(g is o for g, o in zip(got[3:], out))
          and all(torch.equal(g, x_) for g, x_ in zip(got, want)))
    errs["route_bucketize"] = max(errs["route_bucketize"], max_abs_err(got, want))
    equal["route_bucketize"].append(ok)
    log(f"phase 3: route_bucketize [recycled dirty out= set, invalid sentinel records] "
        f"W={w} n={keys.shape[1]} cap={cap} equal={ok}")
    del out, got, want
    assert all(all(v) for v in equal.values()), equal

    # the look-back's timing differs under load; the ranks must not
    hk, hp, hr = padded(part, n_part=32, pad_empty=True)
    main_args = (keys, valid, vals, hk, hp, part.tables(dev).host_to_part, hr)
    main_kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, capacity=cap,
                   key_fill=sent, num_partitions=32)
    want = route_bucketize(*main_args, **main_kw)
    differ, total = differ_under_load(dev, lambda: route_bucketize(*main_args, **main_kw), want)
    assert all(torch.equal(g, x_) for g, x_ in zip(
        want, route_bucketize_plain(*main_args, **main_kw)))
    assert differ == 0, (differ, total)
    log(f"phase 3: route_bucketize at phase 2's shapes on 4 streams beside a busy copy: "
        f"{differ} of {total} outputs differ from an idle card's")
    del want
    torch.cuda.empty_cache()

    # ---- phase 4: card against CPU -------------------------------------
    small = list(drifting_zipf(6, 65_536, num_keys=50_000, exponent=1.3,
                               drift_every=2, seed=1))
    card_equals_cpu(lambda device, driver: StreamingJob(
        device=device, dr=DRConfig(**dr_kw, **DRIVERS[driver]), **job_kw), small, 4)

    # ---- phase 5: times --------------------------------------------------
    hk, hp, hr = padded(part, n_part=32, pad_empty=True)
    h2p = part.tables(dev).host_to_part
    rb_args = (keys, valid, vals, hk, hp, h2p, hr)
    rb_kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, capacity=cap,
                 key_fill=sent, num_partitions=32)
    lk, lp, _ = padded(part, n_part=0, pad_empty=False)
    ld_args = (state_keys, state_valid, lk, lp, h2p, None)
    ld_kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, num_partitions=0)
    flush = l2_flush(dev)
    timing = {
        "route_bucketize": (
            cuda_ms(lambda: route_bucketize(*rb_args, **rb_kw)),
            cuda_ms(lambda: route_bucketize_plain(*rb_args, **rb_kw)),
            route_bytes(keys, vals, (hk, hp, h2p), w, cap, split=True),
            own_device_time(lambda: route_bucketize(*rb_args, **rb_kw),
                            DEVICE_NAMES["route_bucketize"], flush=flush)),
        "lookup_dispatch": (
            cuda_ms(lambda: lookup_dispatch(*ld_args, **ld_kw)),
            cuda_ms(lambda: lookup_dispatch_plain(*ld_args, **ld_kw)),
            route_bytes(state_keys, None, (lk, lp, h2p), w),
            own_device_time(lambda: lookup_dispatch(*ld_args, **ld_kw),
                            DEVICE_NAMES["lookup_dispatch"])),
    }
    flushed = {"lookup_dispatch": own_device_time(lambda: lookup_dispatch(*ld_args, **ld_kw),
                                                  DEVICE_NAMES["lookup_dispatch"],
                                                  flush=flush)[0]}
    # the least-load pick's cost: each route kernel with the split table
    # (top key x4) at its row's shapes, without and with a load vector, in
    # turns (without, with, with, without); route_bucketize flushed as in
    # its row
    loads32 = torch.rand(32, generator=gen, device=dev)
    sk, sp, sr = padded(split, n_part=32, pad_empty=True)
    sh = split.tables(dev).host_to_part
    pick_args = {
        "route_bucketize": ((keys, valid, vals, sk, sp, sh, sr), rb_kw, flush),
        "lookup_dispatch": ((state_keys, state_valid, sk, sp, sh, sr),
                            dict(ld_kw, num_partitions=32), None),
    }
    with_loads = {}
    for name, (args, kw, fl) in pick_args.items():
        fn = route_bucketize if name == "route_bucketize" else lookup_dispatch
        pick_ms = {"without": [], "with": []}
        for turn in ("without", "with", "with", "without"):
            extra = {"part_loads": loads32} if turn == "with" else {}
            pick_ms[turn].append(own_device_time(lambda: fn(*args, **kw, **extra),
                                              DEVICE_NAMES[name], flush=fl)[0])
        with_loads[name] = {
            "ms_with_loads": cuda_ms(lambda: fn(*args, **kw, part_loads=loads32)),
            "device_ms_with_loads": statistics.mean(pick_ms["with"]),
            "device_ms_split_without_loads": statistics.mean(pick_ms["without"]),
        }
        log(f"phase 5: {name} with the split table, device time without a load vector "
            f"{pick_ms['without']} ms, with one {pick_ms['with']} ms (in turns"
            f"{', L2 flushed' if fl else ''}): "
            f"{100 * (with_loads[name]['device_ms_with_loads'] / with_loads[name]['device_ms_split_without_loads'] - 1):+.2f}%; "
            f"card {card}")
    del flush
    assert timing["route_bucketize"][3][2] <= 2, timing["route_bucketize"][3]
    res = job._shuffle(part.tables(dev), keys, vals, valid)
    merge_ms = cuda_ms(lambda: merge_into(job.state_keys, job.state_vals, res.keys,
                                          res.values, res.valid), warmup=1, reps=5)
    kernels = kernel_rows(timing, launches, errs, equal, phase=5, path_phase="2 (depth 1)",
                          flushed=flushed)
    for row in kernels:
        row.update(with_loads[row["name"]])
    log(f"phase 5: state merge {merge_ms:.3f} ms on the device (events around one call, "
        f"median of 5); card {card}")
    for label, rs in (("phase 2", runs), ("policies off", steady)):
        for name, r in rs.items():
            ex = statistics.median(m.exchange_wall_s * 1e3 for m in r["ms"][1:])
            log(f"phase 5: {label}, {name}: wall per batch {r['wall_ms']:.2f} ms; median "
                f"exchange wall (count phase when overlapped) of the batches after the first "
                f"{ex:.2f} ms; card {card}")
    for tr in traces:
        log(f"phase 5: traced serial batch ({tr['action']}), host steps by perf_counter "
            f"(ms): {tr['host']}; wall {tr['wall_ms']:.2f} ms, in the steps "
            f"{tr['steps_ms']:.2f} ms, other host {tr['wall_ms'] - tr['steps_ms']:.2f} ms; "
            f"device span by step (CUDA events, ms) {tr['device']}; the profiled batch: wall "
            f"{tr['prof_wall_ms']:.2f} ms, device busy {tr['busy_ms']:.2f} ms; by device "
            f"kernel, largest first: {tr['kernels']}; card {card}")
    log(f"phase 5: depth 1, policies off, 4 batches and a drain under the profiler: wall "
        f"{idle['wall_ms']:.2f} ms, device busy {idle['busy_ms']:.2f} ms, idle "
        f"{100 * idle['idle']:.1f}%; card {card}")
    # phase 2 repartitions at every batch, each one the same work: its
    # batches after the first are its steady state.  Their count walls must
    # leave the in-flight merge out.  (With the policies off the card is
    # the bound: the count wall is the rest of the previous merge plus the
    # start phase, logged above.)
    d1 = [m.exchange_wall_s * 1e3 for m in runs["depth 1"]["ms"][1:]]
    log(f"phase 5: depth 1, phase 2's batches after the first: median count-phase wall "
        f"{statistics.median(d1):.2f} ms against the merge's {merge_ms:.2f} ms")
    assert statistics.median(d1) < merge_ms, (d1, merge_ms)
    del job, runs, res, all_keys
    torch.cuda.empty_cache()

    kernels += batch_phases(dev, sent)
    torch.cuda.empty_cache()
    kernels += serve_phases(dev, card)
    torch.cuda.empty_cache()
    flips = split_phase(dev, card)
    elastic_phase(dev, card)
    least_load_phase(dev, card, flips)
    del flips
    torch.cuda.empty_cache()
    float_payload_phase(dev)
    kernels += failure_phase(dev, card, batches, phase2, steady_walls)
    topo_launches = topology_phase(dev, card, batches, phase2, steady_walls)
    for row in kernels:
        if row["name"] in ("route_bucketize", "lookup_dispatch"):
            row["launches_phase_17"] = {job: n[row["name"]] for job, n in topo_launches.items()}
    # earlier phases' jobs hold tensors in reference cycles: collect them,
    # so that the phases that report peak memory start from their own state
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(dev, card)
    for row in kernels:
        if row["name"] in ("dispatch_count", "flash_attention"):
            row.update(moe[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(dev, card)
    for row in kernels:
        if row["name"] in ("dispatch_count", "flash_attention"):
            row.update(train[row["name"]])
    kernels.append(train["row"])
    torch.cuda.empty_cache()
    fig = baselines_phase(dev, card)
    next(r for r in kernels if r["name"] == "partition_apply").update(fig)
    gc.collect()
    torch.cuda.empty_cache()
    xl = xlstm_phase(dev, card)
    for row in kernels:
        if row["name"] in ("dispatch_count", "flash_attention", "flash_attention_bwd"):
            row.update(xl[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    wh = whisper_phase(dev, card)
    for row in kernels:
        if row["name"] in ("flash_attention", "flash_attention_bwd"):
            row.update(wh[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    vl = vlm_phase(dev, card)
    for row in kernels:
        if row["name"] in ("flash_attention", "flash_attention_bwd"):
            row.update(vl[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    jb = jamba_phase(dev, card)
    for row in kernels:
        if row["name"] in ("dispatch_count", "flash_attention", "flash_attention_bwd"):
            row.update(jb[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    dp = dist_phase(dev, card, batches, phase2, exact)
    for row in kernels:
        if row["name"] in dp:
            row.update(dp[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    td = train_dist_phase(dev, card)
    for row in kernels:
        if row["name"] in td:
            row.update(td[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    mp = mesh_phase(dev, card, moe["serving"])
    for row in kernels:
        if row["name"] in mp:
            row.update(mp[row["name"]])
    gc.collect()
    torch.cuda.empty_cache()
    mt = mesh_train_phase(dev, card)
    for row in kernels:
        if row["name"] in mt:
            row.update(mt[row["name"]])
    log(f"profiler: {PROFILER['sessions']} sessions timed kernels, {PROFILER['empty']} of them "
        f"recorded none of the kernels they timed and ran again; {PROFILER['fallback']} "
        f"timings fell back to events behind a spin after five such sessions")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def capture_signals(job) -> list:
    """``(partitioner, loads, exchange_replica_rows, padding fraction)`` of
    each safe point the job's telemetry snapshots from here on: the
    partitioner that routed the batch, the loads the card counted, the
    replica rows the host twin recorded, the window's occupied / provisioned
    exchange rows."""
    seen = []
    snapshot = job.telemetry.snapshot

    def recording(*a, **k):
        sig = snapshot(*a, **k)
        seen.append((job.drm.partitioner, sig.loads, sig.exchange_replica_rows,
                     sig.exchange_padding_fraction))
        return sig

    job.telemetry.snapshot = recording
    return seen


def record_migrations(job, *, sync: bool) -> list:
    """One record a migration from here on: the batch, whether its lanes had
    the whole state table (an unsplit), its buffer and planned rows, the
    lookup_dispatch launches it made and, with ``sync``, its wall with the
    card synchronized before and after (state fetch, plan, route, ship and
    merge); the unsplit's inputs ride along for timing lookup_dispatch."""
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch

    out = []
    migrate = job._migrate_state

    def recording(old, **kw):
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        launched = lookup_dispatch.launches
        inputs = (job.drm.partitioner, job.state_keys.clone()) if kw.get("full_lanes") else None
        res = migrate(old, **kw)
        if sync:
            torch.cuda.synchronize()
        out.append(dict(batch=len(job.metrics), full_lanes=bool(kw.get("full_lanes")),
                        ms=(time.perf_counter() - t) * 1e3 if sync else None,
                        rows=res[2], plan_rows=res[3],
                        launches=lookup_dispatch.launches - launched, inputs=inputs))
        return res

    job._migrate_state = recording
    return out


def feed(job, name, batches, after=None) -> list:
    """``job``'s metrics over ``batches``: depth 1 batch by batch through
    ``process_batch``, the other drivers through ``run``; ``after`` as in
    ``drive``."""
    segments = [batches] if after is None else [batches[: after[0] + 1],
                                                batches[after[0] + 1:]]
    ms = []
    for i, seg in enumerate(segments):
        if i:
            after[1](job)
        if name.startswith("depth 1"):
            ms += [job.process_batch(b) for b in seg]
        else:
            ms += job.run(seg)
    return ms


def card_equals_cpu(make, batches, phase, after=None) -> dict:
    """``make(device, driver)``'s job over ``batches`` on the card and on the
    CPU, by each of the three drivers: identical per-batch metrics (but the
    walls and ``overlap_fraction``, a ratio of walls), recoveries (but their
    walls), lane ids and final state.  Returns each driver's CPU job."""
    skip = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
    out = {}
    for driver in DRIVERS:
        pair = {device: make(device, driver) for device in ("cuda", "cpu")}
        runs = {device: feed(job, driver, batches, after) for device, job in pair.items()}
        for a, b in zip(runs["cuda"], runs["cpu"], strict=True):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            diff = {k: (da[k], db[k]) for k in da if k not in skip and da[k] != db[k]}
            assert not diff, (phase, driver, a.batch, diff)
        assert ([dataclasses.replace(r, wall_s=0.0) for r in pair["cuda"].recoveries]
                == [dataclasses.replace(r, wall_s=0.0) for r in pair["cpu"].recoveries]), phase
        assert pair["cuda"]._lane_ids == pair["cpu"]._lane_ids, phase
        for t in ("state_keys", "state_vals"):
            assert torch.equal(getattr(pair["cuda"], t).cpu(), getattr(pair["cpu"], t)), (
                phase, driver, t)
        actions = [m.action for m in runs["cpu"]]
        log(f"phase {phase}: {driver}: card and CPU trajectories identical over {len(batches)} "
            f"batches of {len(batches[0]):,} records (actions "
            f"{ {a: actions.count(a) for a in sorted(set(actions))} }, pipelined "
            f"{sum(m.pipelined for m in runs['cpu'])}, recoveries "
            f"{len(pair['cpu'].recoveries)}), state equal")
        out[driver] = pair["cpu"]
    return out


def sample_keys(batches, dev, n=64):
    """``(keys, counts)`` of the stream's heaviest key and ``n - 1`` others
    drawn with a seeded generator, counted on the card."""
    uniq, counts = torch.unique(torch.as_tensor(np.concatenate(batches), device=dev),
                                return_counts=True)
    pick = np.concatenate([[int(torch.argmax(counts))],
                           np.random.default_rng(0).choice(len(uniq), n - 1, replace=False)])
    return [(int(uniq[i]), float(counts[i])) for i in pick]


def count_of(batches, key) -> float:
    return float(sum(int((b == key).sum()) for b in batches))


def replica_spread(seen) -> list[float]:
    """max / mean of the loads on each split key's d replica partitions, one
    value a batch and split key, from ``capture_signals``'s records (the
    partitioner that routed the batch, the loads the card counted)."""
    out = []
    for part, loads, *_ in seen:
        n = part.num_partitions
        for key, d in part.split_map().items():
            home = int(part.lookup_np(np.asarray([key], np.int32))[0])
            reps = np.asarray(loads, np.float64)[[(home + r) % n for r in range(d)]]
            if reps.mean() > 0:
                out.append(float(reps.max() / reps.mean()))
    return out


def spread_text(spread) -> str:
    return (f"median {statistics.median(spread):.4f}, {min(spread):.4f}-{max(spread):.4f} "
            f"over {len(spread)} batch-keys")


def split_phase(dev, card) -> dict:
    """Phase 13: hot-key splitting at phase 2's size.  Returns what phase 15
    reuses: the batches, the depth-1 run's replica spread (the hash pick)
    and the walls per batch."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.partitioner import split_replica_rows
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import hotspot_flip
    from repro_torch.kernels import ops
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch, lookup_dispatch_plain
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

    kernels = (route_bucketize, lookup_dispatch)
    job_kw = dict(num_workers=8, num_partitions=32, state_capacity=262_144,
                  capacity_factor=2.0)
    dr_kw = dict(imbalance_trigger=1.2, migration_cost_weight=0.2, split_keys_enabled=True)
    stream = dict(num_keys=1_000_000, exponent=1.3, flip_at=6, seed=0)
    t = time.perf_counter()
    batches = list(hotspot_flip(12, 4_194_304, **stream))
    log(f"phase 13: generated 12 x 4,194,304 keys (hot set flips at batch 6) in "
        f"{time.perf_counter() - t:.1f} s")
    sampled = sample_keys(batches, dev)
    runs, migrations = {}, {}
    for name, extra in DRIVERS.items():
        job = StreamingJob(device="cuda", dr=DRConfig(**dr_kw, **extra), **job_kw)
        seen = capture_signals(job)
        migrations[name] = record_migrations(job, sync=name == "serial")
        r = runs[name] = drive(job, name, batches, kernels, phase=13)
        ms = r["ms"]
        actions = [m.action for m in ms]
        assert any(a == "split" for a in actions[:6]), actions
        assert any(a == "unsplit" for a in actions[6:]), actions
        assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
        ever_split = sorted({h["split"][1] for h in job.drm.history if "split" in h})
        for key, want in sampled + [(k, count_of(batches, k)) for k in ever_split]:
            got = job.state_count(key)
            assert got == want, (name, key, got, want)
        assert all(v > 0 for v in r["launches"].values()), (name, r["launches"])
        unsplits = [mg for mg in migrations[name] if mg["full_lanes"]]
        assert unsplits and all(mg["rows"] == 8 * job.state_capacity for mg in unsplits)
        assert all(m.migration_rows == 8 * job.state_capacity
                   for m in ms if m.action == "unsplit")
        log(f"phase 13: {name}: splits at batches "
            f"{[i for i, a in enumerate(actions) if a == 'split']}, unsplits at "
            f"{[i for i, a in enumerate(actions) if a == 'unsplit']}, repartitions at "
            f"{[i for i, a in enumerate(actions) if a == 'repartition']} "
            f"({actions.count('repartition')} of {len(ms)}; phase 2: 8 of 8); keys split "
            f"{ever_split}; exact counts of {len(sampled)} sampled keys and every key ever "
            f"split; launches {r['launches']}")
        if name == "depth 1":
            # the card's route against the host twin, batch by batch: the
            # loads the card counted are the home rows of the unsplit keys
            # plus the split keys' replica rows, and each split key's rows
            # land on exactly its d partitions
            checked = spread_keys = 0
            twin_ms = []
            for i, (part, loads, replica_rows, _) in enumerate(seen):
                smap = part.split_map()
                if not smap:
                    assert replica_rows is None, i
                    continue
                keys = batches[i].astype(np.int32)
                t = time.perf_counter()
                want = split_replica_rows(part, keys, 8, keys != SENT)  # as the driver calls it
                twin_ms.append((time.perf_counter() - t) * 1e3)
                assert np.array_equal(replica_rows, want), i
                home = part.lookup_np(keys)
                plain = ~np.isin(keys, np.asarray(list(smap), np.int32))
                n = part.num_partitions
                assert np.array_equal(
                    loads, np.bincount(home[plain], minlength=n) + want), i
                for key, d in smap.items():
                    rows = split_replica_rows(part, keys, 8, keys == key)
                    at = int(part.lookup_np(np.asarray([key], np.int32))[0])
                    spread = {(at + r) % n for r in range(d)}
                    assert set(np.flatnonzero(rows)) <= spread, (i, key, d, rows)
                    if rows.sum() >= 100 * d:  # a key gone cold may miss a replica
                        assert np.count_nonzero(rows) == d, (i, key, d, rows)
                        spread_keys += 1
                checked += 1
            assert checked and spread_keys, (checked, spread_keys)
            hash_spread = replica_spread(seen)
            log(f"phase 13: depth 1: in each of the {checked} batches with splits installed "
                f"the telemetry's replica rows equal split_replica_rows, the card's loads equal "
                f"the home rows plus the replica rows, and each split key's rows lie on its d "
                f"partitions ({spread_keys} batch-keys with at least 100 rows a replica on all "
                f"d of them); the host twin over a batch: median {statistics.median(twin_ms):.2f} "
                f"ms, {min(twin_ms):.2f}-{max(twin_ms):.2f} ms")
    assert_same_drivers(runs, phase=13)
    job = runs["serial"]["job"]
    part = job.drm.partitioner
    # the live split table at a batch's shape: kernel against plain version
    hk, hp, hr = ops.pad_heavy_tables(part.tables(dev), num_partitions=32, pad_empty=True)
    w = job.num_workers
    keys = torch.as_tensor(batches[-1].astype(np.int32), device=dev).reshape(w, -1)
    valid = keys != SENT
    vals = torch.ones(keys.shape + (1,), dtype=torch.float32, device=dev)
    args = (keys, valid, vals, hk, hp, part.tables(dev).host_to_part, hr)
    kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w,
              capacity=job._shuffle_spec.capacity, key_fill=SENT, num_partitions=32)
    got, want = route_bucketize(*args, **kw), route_bucketize_plain(*args, **kw)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    del got, want
    log(f"phase 13: route_bucketize with the live split table {part.split_map()} at W={w} "
        f"n={keys.shape[1]}: equal to its plain version")
    unsplit = [mg for mg in migrations["serial"] if mg["full_lanes"]][0]
    upart, ukeys = unsplit["inputs"]
    lk, lp, _ = ops.pad_heavy_tables(upart.tables(dev), num_partitions=0, pad_empty=False)
    ld_args = (ukeys, ukeys != SENT, lk, lp, upart.tables(dev).host_to_part, None)
    ld_kw = dict(seed=upart.seed, num_hosts=upart.num_hosts, num_lanes=w, num_partitions=0)
    got, want = lookup_dispatch(*ld_args, **ld_kw), lookup_dispatch_plain(*ld_args, **ld_kw)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    ld_ms = cuda_ms(lambda: lookup_dispatch(*ld_args, **ld_kw))
    ld_dev = own_device_time(lambda: lookup_dispatch(*ld_args, **ld_kw),
                             DEVICE_NAMES["lookup_dispatch"])[0]
    for name in DRIVERS:
        mgs = migrations[name]
        log(f"phase 13: {name}: migrations (batch, full lanes, buffer rows, planned rows, "
            f"lookup_dispatch launches"
            f"{', ms synchronized' if name == 'serial' else ''}): "
            f"{[(mg['batch'], mg['full_lanes'], mg['rows'], mg['plan_rows'], mg['launches']) + ((round(mg['ms'], 2),) if mg['ms'] is not None else ()) for mg in mgs]}")
    log(f"phase 13: the unsplit migration at batch {unsplit['batch']} (serial): lane capacity "
        f"{unsplit['rows'] // w:,} rows ({unsplit['rows']:,} buffer rows a worker), wall "
        f"{unsplit['ms']:.2f} ms synchronized; lookup_dispatch on its inputs (W={w}, "
        f"n={ukeys.shape[1]:,}) equal to its plain version, {ld_ms:.4f} ms by events around "
        f"one call, device time {ld_dev:.4f} ms; card {card}")
    for name, r in runs.items():
        log(f"phase 13: {name}: wall per batch {r['wall_ms']:.2f} ms over {len(batches)} "
            f"batches; card {card}")
    log(f"phase 13: depth 1: max / mean of the loads on each split key's replica "
        f"partitions (the hash pick): {spread_text(hash_spread)}")
    walls = {name: r["wall_ms"] for name, r in runs.items()}
    imbalance = [m.imbalance for m in runs["depth 1"]["ms"]]
    del runs, migrations, job, upart, ukeys, ld_args, got, want
    torch.cuda.empty_cache()

    small = list(hotspot_flip(12, 16_384, **stream))
    card_equals_cpu(lambda device, driver: StreamingJob(
        device=device, dr=DRConfig(**dr_kw, **DRIVERS[driver]), **job_kw), small, 13)
    return dict(batches=batches, spread=hash_spread, walls=walls, sampled=sampled,
                imbalance=imbalance, stream=stream)


def elastic_phase(dev, card) -> None:
    """Phase 14: elastic grow and shrink at phase 2's size, then a restore
    across worker counts."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import sawtooth_skew
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch
    from repro_torch.kernels.route_bucketize import route_bucketize

    kernels = (route_bucketize, lookup_dispatch)
    job_kw = dict(num_workers=8, num_partitions=16, state_capacity=262_144,
                  capacity_factor=2.0)
    # examples/streaming_wordcount.py's elastic knobs, partition bounds for 8
    # workers; triggers 4.0 / 2.5 (the example's 1.6 / 1.3 never shrink here:
    # the grow leaves the heavy keys' 16 partitions without hash hosts, so
    # the flat batches read an imbalance of 2.0)
    dr_kw = dict(elastic=True, min_partitions=16, max_partitions=32, grow_trigger=4.0,
                 shrink_trigger=2.5, resize_patience=2, imbalance_trigger=1.2,
                 migration_cost_weight=0.1)
    stream = dict(num_keys=1_000_000, exponent=1.8, period=4, seed=0)
    after = (7, lambda job: job.resize(24))  # applied at batch 8's safe point
    t = time.perf_counter()
    batches = list(sawtooth_skew(12, 4_194_304, **stream))
    log(f"phase 14: generated 12 x 4,194,304 keys (hard Zipf 0-3 and 8-11, flat 4-7) in "
        f"{time.perf_counter() - t:.1f} s")
    first = batches[:10]
    sampled = sample_keys(first, dev)
    runs, migrations = {}, {}
    for name, extra in DRIVERS.items():
        job = StreamingJob(device="cuda", dr=DRConfig(**dr_kw, **extra), **job_kw)
        migrations[name] = record_migrations(job, sync=name == "serial")
        r = runs[name] = drive(job, name, first, kernels, phase=14, after=after)
        ms = r["ms"]
        resized = [(m.batch, m.reason) for m in ms if m.resized]
        assert resized == [(1, "resize 16->32"), (5, "resize 32->16"), (8, "resize 16->24")], (
            name, resized)
        assert [m.num_partitions for m in ms] == [16] + [32] * 4 + [16] * 3 + [24] * 2, name
        mgs = {mg["batch"]: mg for mg in migrations[name]}
        assert all(mgs[b]["launches"] >= 1 for b, _ in resized), (name, migrations[name])
        assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
        for key, want in sampled:
            got = job.state_count(key)
            assert got == want, (name, key, got, want)
        assert all(v > 0 for v in r["launches"].values()), (name, r["launches"])
        log(f"phase 14: {name}: resizes {resized}; exact counts of {len(sampled)} sampled "
            f"keys; launches {r['launches']}")
        for b, reason in resized:
            m, mg = ms[b], mgs[b]
            log(f"phase 14: {name}: batch {b} ({reason}): host wall {m.wall_time_s * 1e3:.2f} "
                f"ms, migration rows {m.migration_rows:,} (planned {m.migration_plan_rows:,}, "
                f"relative migration {m.relative_migration:.4f}), lookup_dispatch launches "
                f"{mg['launches']}"
                + (f", migration wall {mg['ms']:.2f} ms synchronized" if mg["ms"] else "")
                + f"; card {card}")
    assert_same_drivers(runs, phase=14)
    for name, r in runs.items():
        log(f"phase 14: {name}: wall per batch {r['wall_ms']:.2f} ms over {len(first)} batches; "
            f"card {card}")
    # the 8-worker job's state after batch 9, at 24 partitions, onto 4
    # workers (about 1M live keys do not fit 4 x 262,144 rows)
    snap = runs["depth 1"]["job"].snapshot()
    del runs, migrations
    torch.cuda.empty_cache()
    live = int((np.asarray(snap["state_keys"]) != SENT).sum())
    t = time.perf_counter()
    job = StreamingJob(device="cuda", dr=DRConfig(**dr_kw), num_workers=4, num_partitions=16,
                       state_capacity=524_288, capacity_factor=2.0)
    job.restore(snap)
    restore_ms = (time.perf_counter() - t) * 1e3
    assert job.num_partitions == 24 and job._last_state_rows == live, (job.num_partitions, live)
    ms = [job.process_batch(b) for b in batches[10:]]
    assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
    # a float32 count is exact up to 2**24; past it adding a record's 1.0
    # no longer changes it (the state's payload is float32, as in the
    # reference), so keys fed more often are logged, not compared
    sampled = sample_keys(batches, dev)
    beyond = [(key, want, job.state_count(key)) for key, want in sampled if want >= F32_EXACT]
    for key, want in sampled:
        if want < F32_EXACT:
            got = job.state_count(key)
            assert got == want, ("restored", key, got, want)
    log(f"phase 14: restored the 8-worker snapshot ({live:,} live keys, 24 partitions) onto 4 "
        f"workers x 524,288 rows in {restore_ms:.1f} ms, then batches 10-11 "
        f"({[(m.action, m.num_partitions) for m in ms]}): zero overflow, exact counts over all "
        f"12 batches of the {len(sampled) - len(beyond)} sampled keys fed fewer than 2**24 "
        f"times; past float32's exact range (key, records, state): {beyond}")
    del job, snap
    torch.cuda.empty_cache()

    small = list(sawtooth_skew(12, 16_384, **stream))[:10]
    card_equals_cpu(lambda device, driver: StreamingJob(
        device=device, dr=DRConfig(**dr_kw, **DRIVERS[driver]), **job_kw), small, 14,
        after=after)


def least_load_phase(dev, card, flips) -> None:
    """Phase 15 (a)-(c): the least-load pick over phase 13's stream, the
    BackendPolicy and the ragged transport over phase 2's, at phase 2's
    size."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf, hotspot_flip
    from repro_torch.kernels import ops
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

    kernels = (route_bucketize, lookup_dispatch)
    job_kw = dict(num_workers=8, num_partitions=32, state_capacity=262_144,
                  capacity_factor=2.0)

    # ---- (a) the two-choice least-load pick, phase 13's job and stream ----
    dr_kw = dict(imbalance_trigger=1.2, migration_cost_weight=0.2, split_keys_enabled=True,
                 split_least_load=True)
    batches = flips["batches"]
    runs = {}
    for name, extra in DRIVERS.items():
        job = StreamingJob(device="cuda", dr=DRConfig(**dr_kw, **extra), **job_kw)
        seen = capture_signals(job)
        r = runs[name] = drive(job, name, batches, kernels, phase=15)
        ms = r["ms"]
        actions = [m.action for m in ms]
        assert "split" in actions, actions
        assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
        # under the pick the driver never calls the host twin
        assert all(rows is None for _, _, rows, _ in seen)
        ever_split = sorted({h["split"][1] for h in job.drm.history if "split" in h})
        keys = [(k, w) for k, w in flips["sampled"] + [(k, count_of(batches, k))
                                                       for k in ever_split] if w < F32_EXACT]
        for key, want in keys:
            got = job.state_count(key)
            assert got == want, (name, key, got, want)
        assert all(v > 0 for v in r["launches"].values()), (name, r["launches"])
        log(f"phase 15 (a): {name}: splits at "
            f"{[i for i, a in enumerate(actions) if a == 'split']}, unsplits at "
            f"{[i for i, a in enumerate(actions) if a == 'unsplit']}, repartitions at "
            f"{[i for i, a in enumerate(actions) if a == 'repartition']}; keys split "
            f"{ever_split}; exact counts of {len(keys)} sampled and split keys fed fewer than "
            f"2**24 times; launches {r['launches']}")
        if name == "depth 1":
            spread = replica_spread(seen)
            imbalance = [m.imbalance for m in ms]
    assert_same_drivers(runs, phase=15)
    log(f"phase 15 (a): depth 1: max / mean of the loads on each split key's replica "
        f"partitions: least-load pick {spread_text(spread)}; phase 13's hash pick "
        f"{spread_text(flips['spread'])}")
    log(f"phase 15 (a): depth 1: imbalance per batch, least-load pick "
        f"{[round(x, 4) for x in imbalance]}, hash pick "
        f"{[round(x, 4) for x in flips['imbalance']]}")
    for name, r in runs.items():
        log(f"phase 15 (a): {name}: wall per batch {r['wall_ms']:.2f} ms (phase 13, the hash "
            f"pick: {flips['walls'][name]:.2f} ms) over {len(batches)} batches; card {card}")
    # the route at phase 2's shapes with the serial job's live split table and
    # load vector: against its plain version, then without and with the
    # vector in turns (L2 flushed between calls)
    job = runs["serial"]["job"]
    part, loads = job.drm.partitioner, job._part_loads
    hk, hp, hr = ops.pad_heavy_tables(part.tables(dev), num_partitions=32, pad_empty=True)
    keys = torch.as_tensor(batches[-1].astype(np.int32), device=dev).reshape(8, -1)
    vals = torch.ones(keys.shape + (1,), dtype=torch.float32, device=dev)
    args = (keys, keys != SENT, vals, hk, hp, part.tables(dev).host_to_part, hr)
    kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=8,
              capacity=job._shuffle_spec.capacity, key_fill=SENT, num_partitions=32)
    got = route_bucketize(*args, **kw, part_loads=loads)
    want = route_bucketize_plain(*args, **kw, part_loads=loads)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    del got, want
    flush = l2_flush(dev)
    times = {"without": [], "with": []}
    for turn in ("without", "with", "with", "without"):
        extra = {"part_loads": loads} if turn == "with" else {}
        times[turn].append(own_device_time(lambda: route_bucketize(*args, **kw, **extra),
                                           DEVICE_NAMES["route_bucketize"], flush=flush)[0])
    del flush
    log(f"phase 15 (a): route_bucketize with the live split table {part.split_map()} at W=8 "
        f"n={keys.shape[1]:,}: equal to its plain version with the load vector; device time "
        f"without the vector {times['without']} ms, with it {times['with']} ms (in turns, L2 "
        f"flushed): {100 * (statistics.mean(times['with']) / statistics.mean(times['without']) - 1):+.2f}%; "
        f"card {card}")
    del runs, job, part, loads, args, keys, vals
    torch.cuda.empty_cache()
    small = list(hotspot_flip(12, 16_384, **flips["stream"]))
    card_equals_cpu(lambda device, driver: StreamingJob(
        device=device, dr=DRConfig(**dr_kw, **DRIVERS[driver]), **job_kw), small, 15)

    # ---- (b) the BackendPolicy, phase 2's stream -------------------------
    t = time.perf_counter()
    batches = list(drifting_zipf(8, 4_194_304, num_keys=1_000_000, exponent=1.3,
                                 drift_every=3, drift_fraction=0.3, seed=0))
    log(f"phase 15 (b): generated phase 2's 8 x 4,194,304 keys in "
        f"{time.perf_counter() - t:.1f} s")
    sampled = sample_keys(batches, dev)
    auto = dict(auto_backend=True, backend_patience=2, backend_cooldown=50,
                imbalance_trigger=1e9)
    runs = {}
    for name, extra in DRIVERS.items():
        job = StreamingJob(device="cuda", dr=DRConfig(**auto, **extra), **job_kw)
        seen = capture_signals(job)
        r = runs[name] = drive(job, name, batches, kernels, phase=15)
        ms = r["ms"]
        switches = [m.batch for m in ms if m.action == "switch_backend"]
        assert len(switches) == 1, [m.action for m in ms]
        sw = switches[0]
        assert [m.backend for m in ms] == ["dense"] * (sw + 1) + ["ragged"] * (7 - sw)
        assert all(m.action in ("noop", "switch_backend") and m.overflow == 0 for m in ms)
        assert all(m.shipped_rows < m.padded_rows for m in ms[sw + 1:])
        assert r["launches"]["route_bucketize"] == len(batches) or name == "depth 2"
        log(f"phase 15 (b): {name}: the switch to ragged at batch {sw} "
            f"({ms[sw].reason}); padding fraction by safe point "
            f"{[round(f, 6) for *_, f in seen]}; shipped rows a worker by batch "
            f"{[m.shipped_rows for m in ms]} against {ms[0].padded_rows:,} provisioned; "
            f"launches {r['launches']}")
    assert_same_drivers(runs, phase=15)
    auto_state = (runs["depth 1"]["job"].state_keys, runs["depth 1"]["job"].state_vals)
    for name, r in runs.items():
        log(f"phase 15 (b): {name}: wall per batch {r['wall_ms']:.2f} ms; card {card}")
    del runs
    torch.cuda.empty_cache()

    # ---- (c) ragged-pinned jobs, and dense beside them in turns -----------
    # policies off (the steady state), then phase 2's policies (a migration
    # every batch, through the ragged transport too)
    pinned = {}
    for label, backend, kw in (("dense, policies off", "dense", dict(imbalance_trigger=1e9)),
                               ("ragged, policies off", "ragged", dict(imbalance_trigger=1e9)),
                               ("ragged, policies off", "ragged", dict(imbalance_trigger=1e9)),
                               ("dense, policies off", "dense", dict(imbalance_trigger=1e9)),
                               ("dense, phase 2's policies", "dense",
                                dict(imbalance_trigger=1.2, migration_cost_weight=0.2)),
                               ("ragged, phase 2's policies", "ragged",
                                dict(imbalance_trigger=1.2, migration_cost_weight=0.2))):
        job = StreamingJob(device="cuda", dr=DRConfig(**kw), exchange_backend=backend, **job_kw)
        r = drive(job, "depth 1 " + label, batches, kernels, phase=15)
        ms = r["ms"]
        assert all(m.backend == backend and m.overflow == 0 for m in ms)
        if backend == "ragged":
            assert all(m.shipped_rows < m.padded_rows for m in ms), [
                (m.shipped_rows, m.padded_rows) for m in ms]
        for key, want in sampled:
            assert job.state_count(key) == want, (label, key)
        state = (job.state_keys, job.state_vals)
        if label in pinned:
            pinned[label]["walls"].append(r["wall_ms"])
        else:
            pinned[label] = dict(walls=[r["wall_ms"]], state=state, ms=ms)
        del job, r
    for a, b in (("dense, policies off", "ragged, policies off"),
                 ("dense, phase 2's policies", "ragged, phase 2's policies")):
        # a declined repartition's reason prices the plan by the transport's rule
        skip = {"wall_time_s", "exchange_wall_s", "overlap_fraction", "backend",
                "shipped_rows", "reason"}
        for x, y in zip(pinned[a]["ms"], pinned[b]["ms"], strict=True):
            dx, dy = dataclasses.asdict(x), dataclasses.asdict(y)
            diff = {k: (dx[k], dy[k]) for k in dx if k not in skip and dx[k] != dy[k]}
            assert not diff, (a, b, x.batch, diff)
        assert all(torch.equal(u, v) for u, v in zip(pinned[a]["state"], pinned[b]["state"]))
    dense = pinned["dense, policies off"]["state"]
    assert all(torch.equal(u, v) for u, v in zip(auto_state, dense))
    mig = pinned["ragged, phase 2's policies"]["ms"]
    log(f"phase 15 (c): the ragged jobs equal the dense jobs (trajectories but for the "
        f"backend and the shipped rows, and state), and the auto-switched job's state equals "
        f"the dense-pinned job's; with phase 2's policies the ragged job repartitions at "
        f"{[m.batch for m in mig if m.repartitioned]}, shipped rows a worker "
        f"{[m.shipped_rows for m in mig]} against {[m.padded_rows for m in mig]} provisioned")
    for label, p in pinned.items():
        log(f"phase 15 (c): depth 1, {label}: wall per batch "
            f"{' / '.join(f'{w:.2f}' for w in p['walls'])} ms (in turns: dense, ragged, "
            f"ragged, dense; then dense, ragged with the policies); card {card}")
    del pinned, auto_state, dense, mig, batches
    torch.cuda.empty_cache()


def float_payload_phase(dev) -> None:
    """Phase 15 (d): non-integer payloads through the merge, the card against
    the CPU.  ``merge_into``'s ``scatter_add_`` adds in no fixed order on
    the card, so each key's sum may differ from the CPU's in its last bits:
    held to 1e-6 of the key's sum of |values| (float32 keeps about 6e-8)."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf

    batches = list(drifting_zipf(6, 16_384, num_keys=50_000, exponent=1.3, drift_every=2,
                                 seed=1))
    rng = np.random.default_rng(0)
    values = [rng.normal(size=(len(b), 2)).astype(np.float32) for b in batches]
    jobs = {}
    for device in ("cuda", "cpu"):
        job = jobs[device] = StreamingJob(
            device=device, payload_dim=2, num_workers=8, num_partitions=32,
            state_capacity=262_144,
            dr=DRConfig(imbalance_trigger=1.2, migration_cost_weight=0.2))
        for b, v in zip(batches, values):
            job.process_batch(b, v)
    skip = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
    for a, b in zip(jobs["cuda"].metrics, jobs["cpu"].metrics, strict=True):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert {k: v for k, v in da.items() if k not in skip} == {
            k: v for k, v in db.items() if k not in skip}, a.batch
    keys = jobs["cuda"].state_keys.cpu()
    assert torch.equal(keys, jobs["cpu"].state_keys)
    live = (keys != SENT).numpy()
    card = jobs["cuda"].state_vals.cpu().numpy()[live].astype(np.float64)
    cpu = jobs["cpu"].state_vals.numpy()[live].astype(np.float64)
    # each key's sum of |values| over the fed batches, on the host
    fed = np.concatenate(batches)
    uniq, inv = np.unique(fed, return_inverse=True)
    mass = np.zeros((len(uniq), 2))
    np.add.at(mass, inv, np.abs(np.concatenate(values)).astype(np.float64))
    at = np.searchsorted(uniq, keys.numpy()[live])
    diff = np.abs(card - cpu)
    assert (diff <= 1e-6 * mass[at]).all(), float((diff / np.maximum(mass[at], 1e-30)).max())
    repartitions = sum(m.repartitioned for m in jobs["cpu"].metrics)
    log(f"phase 15 (d): payload_dim=2 non-integer values, {len(batches)} batches of 16,384 "
        f"records ({repartitions} repartitions), card against CPU: trajectories and keys "
        f"equal; {int((diff > 0).any(axis=1).sum())} of {int(live.sum())} keys' sums differ, "
        f"largest difference {diff.max():.3e}, largest against the key's sum of |values| "
        f"{float((diff / np.maximum(mass[at], 1e-30)).max()):.3e} (held to 1e-6)")


def exact_after_loss(job, name, sampled, fed, phase) -> None:
    """Zero loss after lane changes: every sampled key's count is its fed
    count, the float64 sum of the live rows' counts is the records fed (a
    migration leaves its moved rows' values in the sentinel row, as in the
    reference), and each worker holds only keys whose home partition lies
    on it (``lookup_np(k) % W``)."""
    for key, want in sampled:
        got = job.state_count(key)
        assert got == want, (phase, name, key, got, want)
    keys = job.state_keys.cpu().numpy()
    total = float(job.state_vals.cpu().numpy()[keys != SENT].astype(np.float64).sum())
    assert total == fed, (phase, name, total, fed)
    part, w = job.drm.partitioner, job.num_workers
    for worker in range(w):
        live = keys[worker][keys[worker] != SENT]
        homes = part.lookup_np(live.astype(np.int32)) % w
        assert (homes == worker).all(), (phase, name, worker, int((homes != worker).sum()))


def failure_phase(dev, card, batches, phase2, steady_walls) -> list[dict]:
    """Phase 16: failure domains at phase 2's size.  Returns the ``kernels``
    line's rows of the two route kernels at 7 lanes."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf
    from repro_torch.exchange import FaultPlan, FaultyBackend, LaneFault
    from repro_torch.kernels import ops
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch, lookup_dispatch_plain
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

    kernels = (route_bucketize, lookup_dispatch)
    job_kw = dict(num_workers=8, num_partitions=32, state_capacity=262_144,
                  capacity_factor=2.0)
    dr_kw = dict(imbalance_trigger=1.2, migration_cost_weight=0.2)
    skip = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
    stream = dict(num_keys=1_000_000, exponent=1.3, drift_every=3, drift_fraction=0.3, seed=0)
    fed = float(sum(len(b) for b in batches))
    sampled = sample_keys(batches, dev)

    def job_of(device, dr, plan, driver):
        return StreamingJob(device=device, dr=DRConfig(**dr, **DRIVERS[driver]),
                            exchange_backend=FaultyBackend("dense", plan), **job_kw)

    # ---- (a) the seam, never firing: phase 2's jobs, equal -----------------
    for name in DRIVERS:
        job = job_of("cuda", dr_kw, FaultPlan(), name)
        r = drive(job, name, batches, kernels, phase=16)
        ref = phase2[name]
        for a, b in zip(r["ms"], ref["ms"], strict=True):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            diff = {k: (da[k], db[k]) for k in da if k not in skip and da[k] != db[k]}
            assert not diff, ("16 (a)", name, a.batch, diff)
        assert torch.equal(job.state_keys, ref["final"][0])
        assert torch.equal(job.state_vals, ref["final"][1])
        seam = job.exchange_backend
        assert (seam.transients, seam.retries, seam.kills, seam.injected_sleep_s) == (0, 0, 0, 0.0)
        assert all(v > 0 for v in r["launches"].values()), (name, r["launches"])
        log(f"phase 16 (a): {name}: FaultyBackend('dense', FaultPlan()) on phase 2's job and "
            f"batches: every metric but the walls and the state equal to phase 2's run; wall "
            f"per batch {r['wall_ms']:.2f} ms (phase 2: {ref['wall_ms']:.2f} ms); launches "
            f"{r['launches']}; card {card}")
        del job, r
    torch.cuda.empty_cache()

    # ---- (b) a hard loss, the reference's Fig. 6 at full size --------------
    kill = FaultPlan(faults=(LaneFault(4, 5, "kill"),))
    quiet = dict(imbalance_trigger=1e9, snapshot_interval=3)
    evicted = None
    for name in DRIVERS:
        job = job_of("cuda", quiet, kill, name)
        r = drive(job, name, batches, kernels, phase=16)
        ms = r["ms"]
        assert [(x.lane, x.kind, x.workers) for x in job.recoveries] == [(5, "evict", 7)], (
            job.recoveries)
        assert job.num_workers == 7 and job._lane_ids == [0, 1, 2, 3, 4, 6, 7]
        assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
        assert all(m.action == "noop" for m in ms)
        exact_after_loss(job, name, sampled, fed, "16 (b)")
        rec = job.recoveries[0]
        before = [round(m.wall_time_s * 1e3, 2) for m in job.metrics if m.lanes == 8]
        after = [round(m.wall_time_s * 1e3, 2) for m in job.metrics if m.lanes == 7]
        log(f"phase 16 (b): {name}: the kill of lane 5 at tick 4 evicted onto 7 workers: "
            f"recovery wall {rec.wall_s * 1e3:.2f} ms (drain, restore of the batch-2 snapshot "
            f"re-folded onto 7 workers, {rec.replayed} batch(es) replayed, the retry); "
            f"{len(job.metrics)} batches processed for {len(batches)} fed (replays "
            f"included); host wall per batch at 8 workers "
            f"{before} ms, at 7 {after} ms; wall per batch {r['wall_ms']:.2f} ms (recovery "
            f"included); 0 overflow; {len(sampled)} sampled counts exact, sum of all counts "
            f"{fed:.0f} = records fed; every key on its home worker (lookup_np % 7); "
            f"launches {r['launches']}; card {card}")
        if name == "depth 1":
            evicted = job
        del job, r
    cpu = card_equals_cpu(lambda device, driver: job_of(device, quiet, kill, driver),
                          list(drifting_zipf(8, 16_384, **stream)), "16 (b)")
    for name, job in cpu.items():
        assert [(x.lane, x.kind, x.workers) for x in job.recoveries] == [(5, "evict", 7)], name

    # the same loss under phase 2's policies: repartitions at 7 lanes after it
    job = job_of("cuda", dict(dr_kw, snapshot_interval=3), kill, "depth 1")
    at_loss = {}
    recover = job._recover_from_loss

    def recording(loss):
        at_loss.update({k.__name__: k.launches for k in kernels})
        return recover(loss)

    job._recover_from_loss = recording
    r = drive(job, "depth 1", batches, kernels, phase=16)
    ms = r["ms"]
    launches7 = {k: r["launches"][k] - at_loss[k] for k in at_loss}
    assert job.num_workers == 7 and [x.kind for x in job.recoveries] == ["evict"]
    assert all(m.overflow == 0 for m in ms)
    assert launches7["lookup_dispatch"] > 0 and launches7["route_bucketize"] > 0, launches7
    exact_after_loss(job, "depth 1, phase 2's policies", sampled, fed, "16 (b)")
    log(f"phase 16 (b): depth 1 under phase 2's policies: the loss at tick 4 (batch 2: a "
        f"migration takes a tick too) evicted onto 7 workers, recovery wall "
        f"{job.recoveries[0].wall_s * 1e3:.2f} ms, {job.recoveries[0].replayed} replayed; "
        f"repartitions at 7 lanes {sum(m.repartitioned and m.lanes == 7 for m in ms)}; "
        f"launches after the loss {launches7} (all at 7 lanes); wall per batch "
        f"{r['wall_ms']:.2f} ms; exact; card {card}")
    del job, r, ms
    torch.cuda.empty_cache()

    # ---- (d) the route kernels at 7 lanes, on the evicted job's inputs -----
    job = evicted
    part, w = job.drm.partitioner, job.num_workers
    keys, vals, valid = job._upload(batches[-1], None)
    torch.cuda.synchronize()
    assert keys.shape == (7, -(-len(batches[-1]) // 7)) and keys[1].data_ptr() % 16 != 0
    cap = job._shuffle_spec.capacity
    hk, hp, hr = ops.pad_heavy_tables(part.tables(dev), num_partitions=32, pad_empty=True)
    h2p = part.tables(dev).host_to_part
    rb_args = (keys, valid, vals, hk, hp, h2p, hr)
    rb_kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, capacity=cap,
                 key_fill=SENT, num_partitions=32)
    state_keys = job.state_keys.clone()
    state_valid = state_keys != SENT
    lk, lp, _ = ops.pad_heavy_tables(part.tables(dev), num_partitions=0, pad_empty=False)
    ld_args = (state_keys, state_valid, lk, lp, h2p, None)
    ld_kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=w, num_partitions=0)
    errs, equal = {}, {}
    for name, fn, plain, args, kw in (
            ("route_bucketize", route_bucketize, route_bucketize_plain, rb_args, rb_kw),
            ("lookup_dispatch", lookup_dispatch, lookup_dispatch_plain, ld_args, ld_kw)):
        want = plain(*args, **kw)
        with dirty_outputs():
            got = fn(*args, **kw)
        torch.cuda.synchronize()
        equal[name] = [all(torch.equal(g, x) for g, x in zip(got, want))]
        errs[name] = max_abs_err(got, want)
        log(f"phase 16 (d): {name} at 7 lanes (W=7, n={args[0].shape[1]:,}, rows starting "
            f"off 16 bytes{f', cap={cap:,}' if 'capacity' in kw else ''}), outputs handed "
            f"out dirty: equal to its plain version {equal[name][0]}")
        del got, want
    assert all(v[0] for v in equal.values()), equal
    flush = l2_flush(dev)
    timing = {
        "route_bucketize": (
            cuda_ms(lambda: route_bucketize(*rb_args, **rb_kw)),
            cuda_ms(lambda: route_bucketize_plain(*rb_args, **rb_kw)),
            route_bytes(keys, vals, (hk, hp, h2p), w, cap, split=True),
            own_device_time(lambda: route_bucketize(*rb_args, **rb_kw),
                            DEVICE_NAMES["route_bucketize"], flush=flush)),
        "lookup_dispatch": (
            cuda_ms(lambda: lookup_dispatch(*ld_args, **ld_kw)),
            cuda_ms(lambda: lookup_dispatch_plain(*ld_args, **ld_kw)),
            route_bytes(state_keys, None, (lk, lp, h2p), w),
            own_device_time(lambda: lookup_dispatch(*ld_args, **ld_kw),
                            DEVICE_NAMES["lookup_dispatch"])),
    }
    flushed = {"lookup_dispatch": own_device_time(lambda: lookup_dispatch(*ld_args, **ld_kw),
                                                  DEVICE_NAMES["lookup_dispatch"],
                                                  flush=flush)[0]}
    del flush
    rows = kernel_rows(timing, launches7, errs, equal, phase="16 (d)",
                       path_phase="16 (b), depth 1 under phase 2's policies, after the loss",
                       flushed=flushed)
    for row in rows:
        row["name"] += " at 7 lanes"
        row["lanes"] = 7
    del evicted, job, keys, vals, valid, state_keys, state_valid, rb_args, ld_args
    torch.cuda.empty_cache()

    # ---- (c) lane health: Quarantine, Recover, Evict -----------------------
    t = time.perf_counter()
    long = list(drifting_zipf(12, 4_194_304, **stream))
    log(f"phase 16 (c): generated 12 x 4,194,304 keys in {time.perf_counter() - t:.1f} s")
    health = dict(imbalance_trigger=1e9, health_enabled=True, health_straggler_ms=50.0,
                  health_patience=2, health_recover_after=3, snapshot_interval=3)
    # lane 2 straggles 80 ms a tick for ticks 0-3; lane 6 fails once a tick at
    # ticks 6-10 (patience 2 over a threshold of 3 failed windows needs four
    # in a row; depth 2's lookahead starts put its ticks a batch ahead)
    plan = FaultPlan(faults=(LaneFault(0, 2, "latency", delay_s=0.08, span=4),)
                     + tuple(LaneFault(t, 6, "transient") for t in range(6, 11)))
    cpu = card_equals_cpu(lambda device, driver: job_of(device, health, plan, driver),
                          list(drifting_zipf(12, 16_384, **stream)), "16 (c)")
    want = {name: [(m.batch, m.action) for m in job.metrics
                   if m.action in ("quarantine", "recover", "evict")]
            for name, job in cpu.items()}
    del cpu
    sampled12 = sample_keys(long, dev)
    fed12 = float(sum(len(b) for b in long))
    for name in DRIVERS:
        job = job_of("cuda", health, plan, name)
        r = drive(job, name, long, kernels, phase=16)
        ms = r["ms"]
        lane_changes = [(m.batch, m.action) for m in ms
                        if m.action in ("quarantine", "recover", "evict")]
        assert [a for _, a in lane_changes] == ["quarantine", "recover", "evict"], lane_changes
        assert lane_changes == want[name], (name, lane_changes, want[name])
        assert not job.recoveries and job.num_workers == 7
        assert all(m.overflow == 0 for m in ms), [m.overflow for m in ms]
        exact_after_loss(job, name, sampled12, fed12, "16 (c)")
        walls = {f"{a} at {b}": round(ms[b].wall_time_s * 1e3, 2) for b, a in lane_changes}
        noop = statistics.median(m.wall_time_s * 1e3 for m in ms if m.action == "noop")
        log(f"phase 16 (c): {name}: {lane_changes} (the CPU run over 16,384-record batches: "
            f"the same batches), reasons {[ms[b].reason for b, _ in lane_changes]}; lanes "
            f"{job._lane_ids}; host wall of each lane-change batch (the host re-fold of the "
            f"state included) {walls} ms against a median noop batch's {noop:.2f} ms; wall "
            f"per batch {r['wall_ms']:.2f} ms; injected sleep "
            f"{job.exchange_backend.injected_sleep_s:.2f} s; 0 overflow, exact; card {card}")
        del job, r, ms
    del long
    torch.cuda.empty_cache()

    # ---- (e) the auto-snapshot's cost: depth 1, no fault, in turns ---------
    walls = {"without": [], "with": []}
    snap_ms = []
    for turn in ("without", "with", "with", "without"):
        kw = dict(imbalance_trigger=1e9) | ({"snapshot_interval": 3} if turn == "with" else {})
        job = job_of("cuda", kw, FaultPlan(), "depth 1")
        if turn == "with":
            take = job.snapshot

            def timed(take=take):
                t = time.perf_counter()
                out = take()
                snap_ms.append((time.perf_counter() - t) * 1e3)
                return out

            job.snapshot = timed
        r = drive(job, "depth 1", batches, kernels, phase=16)
        assert all(m.action == "noop" and m.overflow == 0 for m in r["ms"])
        walls[turn].append(round(r["wall_ms"], 2))
        del job, r
    log(f"phase 16 (e): depth 1, policies off, fresh jobs in turns: wall per batch without "
        f"auto-snapshots {walls['without']} ms, with snapshot_interval=3 {walls['with']} ms "
        f"({statistics.mean(walls['with']) - statistics.mean(walls['without']):+.2f} ms a "
        f"batch); each snapshot (a drain and the state's copy to the host) "
        f"{[round(x, 2) for x in snap_ms]} ms; phase 2's policies-off depth-1 wall "
        f"{steady_walls['depth 1']:.2f} ms; card {card}")
    torch.cuda.empty_cache()
    return rows


def topology_phase(dev, card, batches, phase2, steady_walls) -> dict:
    """Phase 17: the lane topology at phase 2's size.  Returns the route
    kernels' launches in (a)'s depth-1 runs, by job, for the ``kernels``
    line."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.data.generators import drifting_zipf
    from repro_torch.exchange import ExchangeTopology, FaultPlan, FaultyBackend, LaneFault
    from repro_torch.exchange.backends import _transposed, _two_hop_a2a
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch
    from repro_torch.kernels.route_bucketize import route_bucketize

    t_phase = time.perf_counter()
    kernels = (route_bucketize, lookup_dispatch)
    job_kw = dict(num_workers=8, num_partitions=32, state_capacity=262_144,
                  capacity_factor=2.0)
    dr_kw = dict(imbalance_trigger=1.2, migration_cost_weight=0.2)
    skip = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
    traffic = skip | {"shipped_rows", "shipped_rows_by_class", "backend"}
    stream = dict(num_keys=1_000_000, exponent=1.3, drift_every=3, drift_fraction=0.3, seed=0)
    two_hosts = ExchangeTopology(8, 4)
    transports = {"dense + topology": "dense", "hierarchical": "hierarchical"}
    sampled = sample_keys(batches, dev)
    fed = float(sum(len(b) for b in batches))

    def job_of(device, backend, driver, dr=dr_kw, topology=two_hosts, **kw):
        return StreamingJob(device=device, dr=DRConfig(**dr, **DRIVERS[driver]),
                            topology=topology, exchange_backend=backend, **job_kw, **kw)

    # ---- (a) the transports under the topology, by each driver -------------
    # Each run is held to phase 2's (every field but the walls and the
    # traffic: dense's shipped rows too; and the state: at this size the
    # two-host price declines no repartition phase 2 takes, where at
    # 1,048,576 records it declines three), the drivers to each other, and
    # the two transports to each other; with the policies off (below) both
    # are held to a flat job's run.
    runs = {label: {} for label in transports}
    launches = {}
    for label, backend in transports.items():
        for name in DRIVERS:
            job = job_of("cuda", backend, name)
            r = drive(job, f"{name} ({label})", batches, kernels, phase=17)
            other = traffic - ({"shipped_rows"} if backend == "dense" else set())
            for m, p in zip(r["ms"], phase2[name]["ms"], strict=True):
                assert sum(m.shipped_rows_by_class) == m.shipped_rows, (label, name, m.batch)
                assert m.overflow == 0, (label, name, m.batch)
                dm, dp = dataclasses.asdict(m), dataclasses.asdict(p)
                diff = {k: (dm[k], dp[k]) for k in dm if k not in other and dm[k] != dp[k]}
                assert not diff, ("17 (a)", label, name, m.batch, diff)
            assert torch.equal(job.state_keys, phase2[name]["final"][0]), (label, name)
            assert torch.equal(job.state_vals, phase2[name]["final"][1]), (label, name)
            for key, want in sampled:
                assert job.state_count(key) == want, ("17 (a)", label, name, key)
            assert all(v > 0 for v in r["launches"].values()), (label, name, r["launches"])
            if name != "serial":
                assert r["syncs"] == 0, (label, name, r["syncs"])
            ships = ""
            if backend == "hierarchical":
                be = job.exchange_backend
                assert be.flat_ships == 0 < be.two_hop_ships, (be.two_hop_ships, be.flat_ships)
                ships = f"; ships two-hop {be.two_hop_ships}, flat {be.flat_ships}"
            final = types.SimpleNamespace(state_keys=job.state_keys.clone(),
                                          state_vals=job.state_vals.clone())
            runs[label][name] = dict(ms=r["ms"], job=final)
            if name == "depth 1":
                launches[label] = r["launches"]
            ref = phase2[name]["ms"]
            log(f"phase 17 (a): {name}, {label}, phase 2's policies: every metric but the "
                f"walls and the traffic, and the state, equal to phase 2's run; repartitions at "
                f"{[m.batch for m in r['ms'] if m.repartitioned]} (phase 2: "
                f"{[m.batch for m in ref if m.repartitioned]}); classes sum to shipped_rows "
                f"each batch; shipped per worker {[m.shipped_rows for m in r['ms']]} (phase 2: "
                f"{[m.shipped_rows for m in ref]}); host syncs outside safe points "
                f"{r['syncs']}; launches {r['launches']}{ships}; 0 overflow, 64 exact counts; "
                f"wall per batch {r['wall_ms']:.2f} ms (phase 2: {phase2[name]['wall_ms']:.2f} "
                f"ms); card {card}")
            del job, r
        assert_same_drivers(runs[label], phase=f"17 (a), {label}")
    for name in DRIVERS:
        dense, hier = runs["dense + topology"][name], runs["hierarchical"][name]
        for d, h in zip(dense["ms"], hier["ms"], strict=True):
            dd, dh = dataclasses.asdict(d), dataclasses.asdict(h)
            diff = {k: (dd[k], dh[k]) for k in dd if k not in traffic and dd[k] != dh[k]}
            assert not diff, ("17 (a)", name, d.batch, diff)
            assert 0 < h.shipped_rows_by_class[2] < d.shipped_rows_by_class[2], (name, d, h)
        for t in ("state_keys", "state_vals"):
            assert torch.equal(getattr(dense["job"], t), getattr(hier["job"], t)), (name, t)
    for label in transports:
        ms = runs[label]["depth 1"]["ms"]
        log(f"phase 17 (a): depth 1, {label}: rows by class (self, intra-host, inter-host) a "
            f"worker, batch by batch {[m.shipped_rows_by_class for m in ms]}; inter-host share "
            f"{[round(m.shipped_rows_by_class[2] / m.shipped_rows, 4) for m in ms]}")
    log("phase 17 (a): dense + topology and hierarchical: equal trajectories but the "
        "traffic, and equal states, by each driver; hierarchical's inter-host rows above 0 and "
        "below dense's in every batch")
    torch.cuda.empty_cache()

    # the walls with the policies off, fresh depth-1 jobs in turns, each held
    # to the first flat job: every field but the walls and the traffic (and
    # dense's traffic too), and the state
    walls = {"flat": [], "dense + topology": [], "hierarchical": []}
    flat_run = None
    for label in ("flat", "dense + topology", "hierarchical", "hierarchical",
                  "dense + topology", "flat"):
        job = job_of("cuda", transports.get(label, "dense"), "depth 1",
                     topology=None if label == "flat" else two_hosts, dr_enabled=False)
        r = drive(job, f"depth 1 ({label}, policies off)", batches, kernels, phase=17)
        assert all(m.action == "noop" and m.overflow == 0 for m in r["ms"])
        assert r["syncs"] == 0, (label, r["syncs"])
        if flat_run is None:
            flat_run = (r["ms"], job.state_keys.clone(), job.state_vals.clone())
        other = traffic if label == "hierarchical" else skip | {"shipped_rows_by_class"}
        for a, b in zip(r["ms"], flat_run[0], strict=True):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            diff = {k: (da[k], db[k]) for k in da if k not in other and da[k] != db[k]}
            assert not diff, ("17 (a)", label, a.batch, diff)
        assert torch.equal(job.state_keys, flat_run[1]) and torch.equal(job.state_vals,
                                                                         flat_run[2])
        walls[label].append(round(r["wall_ms"], 2))
        del job, r
    log(f"phase 17 (a): depth 1, policies off, fresh jobs in turns (flat, dense + topology, "
        f"hierarchical, hierarchical, dense + topology, flat), each equal to the first flat "
        f"job but the walls and the traffic, state equal: wall per batch {walls} ms; phase "
        f"2's policies-off depth-1 wall {steady_walls['depth 1']:.2f} ms; card {card}")
    del flat_run

    # one ship's device time on phase 2's send buffers: two hops against
    # the flat transpose, in turns
    job = job_of("cuda", "hierarchical", "depth 1", dr=dict(imbalance_trigger=1e9))
    job.process_batch(batches[0])
    pending, _ = job._shuffle.start(job._tables(), *job._upload(batches[-1], None), None)
    torch.cuda.synchronize()
    send = (pending.buffers.valid, *pending.buffers.payloads)
    nbytes = sum(t.numel() * t.element_size() for t in send)

    def two_hop():
        return [_two_hop_a2a(t, 2, 4) for t in send]

    def flat():
        return [_transposed(t) for t in send]

    assert all(torch.equal(a, b) for a, b in zip(two_hop(), flat()))
    ship = {"flat": [], "two-hop": []}
    for label in ("flat", "two-hop", "two-hop", "flat"):
        fn = flat if label == "flat" else two_hop
        ship[label].append((round(device_ms(fn), 4), round(cuda_ms(fn), 4)))
    bound = {k: c * nbytes / HBM_BYTES_PER_S * 1e3 for k, c in (("flat", 2), ("two-hop", 4))}
    log(f"phase 17 (a): one ship of phase 2's send buffers ({tuple(send[0].shape)}, mask and "
        f"three payloads, {nbytes:,} bytes), in turns: (device ms over 20 calls, events ms "
        f"around one call) flat transpose {ship['flat']}, two hops {ship['two-hop']}; bounds "
        f"(each hop reads and writes every byte) flat {bound['flat']:.4f} ms, two hops "
        f"{bound['two-hop']:.4f} ms; outputs equal; card {card}")
    del job, pending, send
    torch.cuda.empty_cache()

    # card against CPU, by-class included, on small batches
    small = list(drifting_zipf(8, 16_384, **stream))
    for label, backend in transports.items():
        cpu = card_equals_cpu(lambda device, driver, backend=backend: job_of(device, backend,
                                                                            driver),
                              small, f"17 (a), {label}")
        for job in cpu.values():
            assert all(sum(m.shipped_rows_by_class) == m.shipped_rows for m in job.metrics)

    # ---- (b) locality pricing at full size: every lane its own host, 400x --
    dear = ExchangeTopology(8, 1, (0.0, 1.0, 400.0))
    job = job_of("cuda", "dense", "depth 1", topology=dear)
    r = drive(job, "depth 1 (all inter-host, 400x)", batches, kernels, phase=17)
    ms, blind = r["ms"], phase2["depth 1"]["ms"]
    assert all(m.overflow == 0 for m in ms)
    for key, want in sampled:
        assert job.state_count(key) == want, ("17 (b)", key)
    two_host = runs["dense + topology"]["depth 1"]["ms"]
    for tag, run in (("aware, every lane its own host, 400x", ms),
                     ("aware, two hosts of 4, 10x (17 (a))", two_host),
                     ("blind (phase 2)", blind)):
        log(f"phase 17 (b): {tag}: repartitions at batches "
            f"{[m.batch for m in run if m.repartitioned]}; imbalance per batch "
            f"{[round(m.imbalance, 4) for m in run]}; declines "
            f"{[(m.batch, m.reason) for m in run if not m.repartitioned]}")
    log(f"phase 17 (b): aware: inter-host share of the shipped rows "
        f"{[round(m.shipped_rows_by_class[2] / m.shipped_rows, 4) for m in ms]}; wall per batch "
        f"{r['wall_ms']:.2f} ms; 0 overflow; 64 exact counts; card {card}")
    del job, r, ms
    torch.cuda.empty_cache()

    # ---- (c) a loss under hierarchical: phase 16 (b)'s, at depth 1 ---------
    kill = FaultPlan(faults=(LaneFault(4, 5, "kill"),))
    job = job_of("cuda", FaultyBackend("hierarchical", kill), "depth 1",
                 dr=dict(imbalance_trigger=1e9, snapshot_interval=3))
    before = {}
    recover = job._recover_from_loss

    def recording(loss):
        inner = job.exchange_backend.inner
        before.update(two_hop=inner.two_hop_ships, flat=inner.flat_ships)
        return recover(loss)

    job._recover_from_loss = recording
    r = drive(job, "depth 1 (hierarchical, a lane killed)", batches, kernels, phase=17)
    ms = r["ms"]
    assert [(x.lane, x.kind, x.workers) for x in job.recoveries] == [(5, "evict", 7)], (
        job.recoveries)
    assert job.num_workers == 7 and job._lane_ids == [0, 1, 2, 3, 4, 6, 7]
    assert all(m.overflow == 0 and m.action == "noop" for m in ms)
    assert before["two_hop"] > 0 and before["flat"] == 0, before
    after = job.exchange_backend.inner
    assert after.two_hop_ships == 0 < after.flat_ships, (after.two_hop_ships, after.flat_ships)
    assert job._shuffle_spec.topology == ExchangeTopology(7, 4)
    exact_after_loss(job, "depth 1, hierarchical", sampled, fed, "17 (c)")
    rec = job.recoveries[0]
    log(f"phase 17 (c): depth 1, hierarchical, lane 5 killed at tick 4: evicted onto 7 lanes "
        f"(hosts of 4 and 3), recovery wall {rec.wall_s * 1e3:.2f} ms, {rec.replayed} "
        f"replayed; ships before the loss two-hop {before['two_hop']}, flat {before['flat']}; "
        f"after it two-hop {after.two_hop_ships}, flat {after.flat_ships}; rows by class at 7 "
        f"lanes {[m.shipped_rows_by_class for m in ms if m.lanes == 7]}; 0 overflow, exact, "
        f"the sum of all counts {fed:.0f} = records fed; wall per batch {r['wall_ms']:.2f} ms; "
        f"launches {r['launches']}; card {card}")
    del job, r, ms
    torch.cuda.empty_cache()
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s in all")
    return launches


def assert_same_batch_result(got, want, keys, dev, tag) -> None:
    """Every ``BatchResult`` field of the card's job equals the CPU job's,
    and the card's assignments equal the host's ``lookup_np``."""
    assert (got.imbalance_before, got.imbalance_after, got.replayed_records,
            got.sample_fraction) == (want.imbalance_before, want.imbalance_after,
                                     want.replayed_records, want.sample_fraction), tag
    gp, wp = got.partitioner, want.partitioner
    assert (gp.num_partitions, gp.seed, gp.heavy_repl) == (wp.num_partitions, wp.seed,
                                                           wp.heavy_repl), tag
    for tab in ("heavy_keys", "heavy_parts", "host_to_part"):
        assert np.array_equal(getattr(gp, tab), getattr(wp, tab)), (tag, tab)
    assign = got.assignments
    assert assign.device.type == dev.type and assign.dtype == torch.int32
    assert torch.equal(assign.cpu(), want.assignments), tag
    assert np.array_equal(assign.cpu().numpy(), gp.lookup_np(keys)), tag


def batch_phases(dev, sent) -> list[dict]:
    """Phases 6-8: the batch replay path and its three kernels."""
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.histogram import CountMinSketch, Histogram
    from repro_torch.core.partitioner import kip_update, uniform_partitioner
    from repro_torch.core.replay import BatchJob, replay_partition
    from repro_torch.data.generators import zipf_keys
    from repro_torch.exchange import ExchangeSpec, Payload, make_exchange
    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
    from repro_torch.kernels.partition_apply import partition_apply, partition_apply_plain
    from repro_torch.kernels.sketch_update import THREADS, sketch_update, sketch_update_plain

    names = ("partition_apply", "dispatch_count", "sketch_update")
    dr = DRConfig(mode="batch", lam=4.0, eps=0.003)

    # ---- phase 6: the batch path at the paper's size -------------------
    jobs, run_walls = {}, []
    partition_apply.launches = dispatch_count.launches = sketch_update.launches = 0
    sketch_checks = 0
    for e in EXPONENTS:
        keys = zipf_keys(BATCH_RECORDS, num_keys=BATCH_KEYS, exponent=e, seed=int(e * 10))
        t = time.perf_counter()
        got = BatchJob(BATCH_PARTS, dr=dr, device=dev).run(keys)
        torch.cuda.synchronize()
        run_walls.append(time.perf_counter() - t)
        want = BatchJob(BATCH_PARTS, dr=dr, device="cpu").run(keys)
        assert_same_batch_result(got, want, keys, dev, e)
        gp, assign = got.partitioner, got.assignments
        assert got.imbalance_after <= got.imbalance_before, e

        # the shuffle reads the replayed buffer: bucketize it, no slot given
        dkeys = torch.as_tensor(keys.astype(np.int32), device=dev)
        loads = torch.bincount(assign, minlength=BATCH_PARTS)
        cap = int(loads.max())
        valid = torch.ones((1, BATCH_RECORDS), dtype=torch.bool, device=dev)
        res = make_exchange(ExchangeSpec(num_lanes=BATCH_PARTS, capacity=cap)).bucketize(
            assign[None], valid, [Payload(dkeys[None], sent)])
        assert int(res.send.overflow.sum()) == 0 and bool(res.send.ok.all())
        assert int(res.valid.sum()) == BATCH_RECORDS
        cell_keys = res.payloads[0][0][assign.long(), res.send.slot[0].long()]
        assert torch.equal(cell_keys, dkeys), e       # every record in its own cell
        assert torch.equal(res.valid[0].sum(dim=1), loads), e

        # count-min sketches of the job's keys: a check, not the path (no
        # entry point of either package calls count_sketch), so their
        # launches are counted apart
        sketch_max = 0.0
        path_sketches = sketch_update.launches
        for width in (2048, 8192):
            sk = ops.count_sketch(dkeys, depth=4, width=width)
            cms = CountMinSketch(4, width)
            cms.update(keys)
            sketch_max = max(sketch_max, float(sk.max()))
            assert sketch_max < 2**24
            assert np.array_equal(sk.cpu().numpy().astype(np.float64), cms.table), (e, width)
        sketch_checks += sketch_update.launches - path_sketches
        sketch_update.launches = path_sketches
        jobs[e] = (keys, got)
        log(f"phase 6: exponent {e}: imbalance {got.imbalance_before:.4f} -> "
            f"{got.imbalance_after:.4f}, replayed {got.replayed_records}, heavy keys "
            f"{gp.num_heavy}, largest partition {cap}, largest sketch cell {sketch_max:.0f}; "
            f"card == CPU == lookup_np; bucketize overflow 0; sketches == CountMinSketch; "
            f"run wall {run_walls[-1]:.3f} s")
    launches = {"partition_apply": partition_apply.launches,
                "dispatch_count": dispatch_count.launches,
                "sketch_update": sketch_update.launches}
    assert launches["partition_apply"] > 0 and launches["dispatch_count"] > 0, launches
    assert sketch_checks == 2 * len(EXPONENTS), sketch_checks
    assert jobs[1.2][1].imbalance_after < jobs[1.2][1].imbalance_before
    log(f"phase 6: {len(EXPONENTS)} jobs of {BATCH_RECORDS:,} records; launches on the path "
        f"{launches}; sketch_update in the sketch checks {sketch_checks}")

    # ---- phase 7: each batch kernel against its plain version ----------
    keys, job = jobs[1.2]
    dkeys = torch.as_tensor(keys.astype(np.int32), device=dev)
    assign = job.assignments
    kip = job.partitioner
    uhp = uniform_partitioner(BATCH_PARTS)
    gen = torch.Generator(device=dev).manual_seed(0)
    holes = torch.rand(dkeys.shape, generator=gen, device=dev) < 0.1
    rows = BATCH_PARTS * (BATCH_RECORDS // BATCH_PARTS)
    equal = {n: [] for n in names}
    errs = {n: 0.0 for n in names}

    def hold(name, label, got, want):
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        errs[name] = max(errs[name], max_abs_err(got, want))
        equal[name].append(ok)
        log(f"phase 7: {name} [{label}] equal={ok}")

    for label, p, k in [("KIP table", kip, dkeys), ("empty heavy table", uhp, dkeys),
                        ("10% sentinel keys", kip, dkeys.masked_fill(holes, sent)),
                        ("35 stacked rows", kip, dkeys[:rows].view(BATCH_PARTS, -1)),
                        ("keys 4 bytes past 16", kip, dkeys[1:])]:
        hk, hp, _ = ops.pad_heavy_tables(p.tables(dev), num_partitions=0, pad_empty=False)
        args = (k, hk, hp, p.tables(dev).host_to_part)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts)
        hold("partition_apply", f"{label}, B={hk.numel()}", partition_apply(*args, **kw),
             partition_apply_plain(*args, **kw))
    ones = torch.ones_like(dkeys, dtype=torch.bool)
    wild = assign.clone()
    wild[holes] = torch.where(dkeys[holes] % 2 == 0, -3, BATCH_PARTS + 5).to(torch.int32)
    some = ~(torch.rand(dkeys.shape, generator=gen, device=dev) < 0.2)
    tile = TILES["dispatch_count"]
    for label, d, v, n in [
            ("replay assignments", assign, ones, BATCH_PARTS),
            ("out-of-range destinations", wild, ones, BATCH_PARTS),
            ("out-of-range + invalid", wild, some, BATCH_PARTS),
            ("1 part", (dkeys % 3 - 1).to(torch.int32), some, 1),
            ("1024 parts", (dkeys % 1030 - 2).to(torch.int32), some, 1024),
            ("35 stacked rows", wild[:rows].view(BATCH_PARTS, -1),
             some[:rows].view(BATCH_PARTS, -1), BATCH_PARTS),
            ("below one tile", wild[:1000], some[:1000], BATCH_PARTS),
            ("3 tiles + 1", wild[: 3 * tile + 1], some[: 3 * tile + 1], BATCH_PARTS),
            ("every record invalid", wild, torch.zeros_like(some), BATCH_PARTS),
            ("no records", wild[:0], some[:0], BATCH_PARTS)]:
        with dirty_outputs():
            got = dispatch_count(d, v, num_parts=n)
        hold("dispatch_count", f"{label}, dirty outputs", got,
             dispatch_count_plain(d, v, num_parts=n))
    for depth, width, v in [(4, 2048, ones), (4, 8192, ones), (8, 8192, some),
                            (1, 1000, some), (8, 1000, ones), (8, 2048, some)]:
        got = sketch_update(dkeys, v, depth=depth, width=width)
        assert float(got.max()) < 2**24
        hold("sketch_update", f"depth {depth}, width {width}, invalid {int((~v).sum())}",
             got, sketch_update_plain(dkeys, v, depth=depth, width=width))
    # the sketch's edges: skew, views off 16 and 4 bytes, ragged n, stacked
    # rows, nothing valid, nothing at all, rows split over a cluster
    step = THREADS * 4  # records a block of the sketch takes a step
    e2 = torch.as_tensor(jobs[2.0][0].astype(np.int32), device=dev)
    for label, k, v, depth, width in [
            ("one key for every record", torch.full_like(dkeys, 123_456_789), ones, 4, 2048),
            ("exponent 2.0", e2, some, 4, 2048),
            ("exponent 2.0, width 1000", e2, some, 4, 1000),
            ("keys 4 bytes past 16, valid 1 byte past 4", dkeys[1:], some[1:], 4, 2048),
            ("n = 1", dkeys[:1], some[:1], 4, 2048),
            ("n = 15", dkeys[1:16], ones[1:16], 4, 2048),
            ("n = 17, width 3", dkeys[:17], ones[:17], 3, 3),
            ("3 steps of a block + 1", dkeys[: 3 * step + 1], some[: 3 * step + 1], 4, 2048),
            ("35 stacked rows", dkeys[:rows].view(BATCH_PARTS, -1),
             some[:rows].view(BATCH_PARTS, -1), 4, 2048),
            ("every record invalid", dkeys, torch.zeros_like(some), 4, 2048),
            ("no records", dkeys[:0], some[:0], 4, 2048),
            ("rows split over 2 blocks, keys 4 bytes past 16", dkeys[1:], some[1:], 8, 8192)]:
        with dirty_outputs():
            got = sketch_update(k, v, depth=depth, width=width)
        hold("sketch_update", f"{label}, depth {depth}, width {width}, dirty outputs", got,
             sketch_update_plain(k, v, depth=depth, width=width))
    del e2
    assert all(all(v) for v in equal.values()), equal
    want = dispatch_count(assign, ones, num_parts=BATCH_PARTS)
    differ, total = differ_under_load(
        dev, lambda: dispatch_count(assign, ones, num_parts=BATCH_PARTS), want)
    assert differ == 0, (differ, total)
    log(f"phase 7: dispatch_count at phase 6's shape on 4 streams beside a busy copy: "
        f"{differ} of {total} outputs differ from an idle card's")
    for depth, width in ((4, 2048), (8, 8192)):
        want = (sketch_update(dkeys, ones, depth=depth, width=width),)
        differ, total = differ_under_load(
            dev, lambda: (sketch_update(dkeys, ones, depth=depth, width=width),), want)
        assert differ == 0, (depth, width, differ, total)
        log(f"phase 7: sketch_update depth {depth} width {width} at phase 6's shape on 4 "
            f"streams beside a busy copy: {differ} of {total} outputs differ from an idle "
            "card's")
    del want

    # ---- phase 8: times ------------------------------------------------
    hk, hp, _ = ops.pad_heavy_tables(kip.tables(dev), num_partitions=0, pad_empty=False)
    h2p = kip.tables(dev).host_to_part
    pa_args, pa_kw = (dkeys, hk, hp, h2p), dict(seed=kip.seed, num_hosts=kip.num_hosts)
    n = BATCH_RECORDS
    flush = l2_flush(dev)
    timing = {
        "partition_apply": (
            cuda_ms(lambda: partition_apply(*pa_args, **pa_kw)),
            cuda_ms(lambda: partition_apply_plain(*pa_args, **pa_kw)),
            n * (4 + 4) + (hk.numel() + hp.numel() + h2p.numel()) * 4,
            own_device_time(lambda: partition_apply(*pa_args, **pa_kw),
                            DEVICE_NAMES["partition_apply"])),
        "dispatch_count": (
            cuda_ms(lambda: dispatch_count(assign, ones, num_parts=BATCH_PARTS)),
            cuda_ms(lambda: dispatch_count_plain(assign, ones, num_parts=BATCH_PARTS)),
            n * (4 + 1 + 4) + BATCH_PARTS * 4,
            own_device_time(lambda: dispatch_count(assign, ones, num_parts=BATCH_PARTS),
                            DEVICE_NAMES["dispatch_count"], flush=flush)),
        "sketch_update": (
            cuda_ms(lambda: sketch_update(dkeys, ones, depth=4, width=2048)),
            cuda_ms(lambda: sketch_update_plain(dkeys, ones, depth=4, width=2048)),
            n * (4 + 1) + 4 * 2048 * 4,
            own_device_time(lambda: sketch_update(dkeys, ones, depth=4, width=2048),
                            DEVICE_NAMES["sketch_update"])),
    }
    flushed = {"partition_apply": own_device_time(lambda: partition_apply(*pa_args, **pa_kw),
                                                  DEVICE_NAMES["partition_apply"],
                                                  flush=flush)[0]}

    def sketch_cold(k, depth, width):
        return own_device_time(lambda: sketch_update(k, ones, depth=depth, width=width),
                               DEVICE_NAMES["sketch_update"], flush=flush)[0]

    e2 = torch.as_tensor(jobs[2.0][0].astype(np.int32), device=dev)
    flushed["sketch_update"] = sketch_cold(dkeys, 4, 2048)
    sketch_more = {"device_ms_flushed_width_8192": sketch_cold(dkeys, 4, 8192),
                   "device_ms_flushed_exponent_2": sketch_cold(e2, 4, 2048),
                   "device_ms_flushed_depth_8_width_8192": sketch_cold(dkeys, 8, 8192)}
    del flush, e2
    kernels = kernel_rows(timing, launches, errs, equal, phase=8, path_phase=6,
                          flushed=flushed, int_ops={"sketch_update": sketch_ops(n, n, 4)})
    next(r for r in kernels if r["name"] == "sketch_update").update(sketch_more)
    log("phase 8: sketch_update flushed device ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sketch_more.items()))

    # one job's wall, split: host planning, upload, device passes (exponent 1.2)
    plan, upload, passes = [], [], []
    for _ in range(5):
        t = time.perf_counter()
        u = uniform_partitioner(BATCH_PARTS)
        hist = Histogram.exact(keys[: int(0.1 * n)]).top(int(dr.lam * BATCH_PARTS))
        k = kip_update(u, hist, eps=dr.eps)
        t1 = time.perf_counter()
        buf = torch.as_tensor(keys.astype(np.int32), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for p in (u, k):
            torch.bincount(replay_partition(p, buf), minlength=BATCH_PARTS).cpu()
        t3 = time.perf_counter()
        plan.append(t1 - t)
        upload.append(t2 - t1)
        passes.append(t3 - t2)
    log(f"phase 8: BatchJob.run median wall per job {statistics.median(run_walls) * 1e3:.1f} ms "
        f"over {len(EXPONENTS)} exponents; at exponent 1.2: host planning (prefix histogram "
        f"+ kip_update) {statistics.median(plan) * 1e3:.1f} ms, upload (int32 cast + copy) "
        f"{statistics.median(upload) * 1e3:.1f} ms, device passes (2 x partition_apply + "
        f"load counts) {statistics.median(passes) * 1e3:.2f} ms (medians of 5)")
    return kernels


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def same_bits_with_lse(q, k, v, kw) -> bool:
    """Does the bf16 flash kernel give the same output bits when it also
    writes lse (the training path) as without (serving's)?  q ``[B, Sq, G,
    P, hd]``, k, v ``[B, Sk, G, hd]``."""
    from repro_torch.kernels.flash_attention import flash_attention_seq_major

    plain = flash_attention_seq_major(q, k, v, **kw)
    with_lse, _ = flash_attention_seq_major(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    return torch.equal(plain, with_lse)


def flash_cost(b, g, p, sq, sk, hd, causal, dtype):
    """(bytes, FLOPs) of flash attention's forward: q, k, v read once and
    the output written once; 4 * hd FLOPs per visible (q, k) pair and head
    (q row i at i, k row j at j)."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * (2 * g * p * sq * hd + 2 * g * sk * hd) * size
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return nbytes, 4 * hd * pairs * b * g * p


def profile_serving(model, params, cfg, pol, rng, dev, max_len, *, phase=12, inv_place=None,
                    names=(), reps=3) -> dict:
    """Device time by kernel (``torch.profiler``) of one 1024-token prefill
    and of 8 decode steps, beside the same work's wall clock unprofiled;
    ``names`` are kernels whose summed device time is logged beside the
    largest six.  Returns each case's wall, device operations (kernels,
    copies, memsets), busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1024)), device=dev)
    one = torch.zeros((1, 1), dtype=torch.int64, device=dev)

    def prefill(_=None):
        return model.prefill(params, {"tokens": toks}, cfg, pol, max_len=max_len,
                             inv_place=inv_place)[1]

    def decode(cache):
        for _ in range(8):
            model.decode_step(params, cache, one, cfg, pol, inv_place=inv_place)

    cases = {"prefill of 1024 tokens": (lambda: None, prefill),
             "8 decode steps after it": (prefill, decode)}
    out = {}
    for name, (setup, work) in cases.items():
        walls = []
        for _ in range(reps):
            state = setup()
            torch.cuda.synchronize()
            t = time.perf_counter()
            work(state)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        for attempt in range(5):  # a session that kept no device operation runs again
            state = setup()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                work(state)
                torch.cuda.synchronize()
            PROFILER["sessions"] += 1
            kern = device_ops(prof)
            if kern:
                break
            PROFILER["empty"] += 1
            log(f"phase {phase}: profile, {name}: session {attempt + 1} kept no device operation")
        else:
            raise AssertionError(f"phase {phase}: five profiler sessions of {name} kept no "
                                 f"device operation")
        busy: dict[str, float] = {}
        for kname, a, b in kern:
            busy[kname] = busy.get(kname, 0.0) + (b - a) / 1e3
        total = sum(busy.values())
        wall = statistics.median(walls) * 1e3
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        log(f"phase {phase}: profile, {name}: wall {wall:.2f} ms unprofiled (median of {reps}); "
            f"{len(kern)} kernel launches, device busy {total:.2f} ms "
            f"({100 * total / wall:.1f}% of the wall, idle {100 - 100 * total / wall:.1f}%)")
        for kname, ms in top:
            log(f"phase {phase}:   {ms:8.3f} ms {100 * ms / max(total, 1e-9):5.1f}%  {kname[:90]}")
        for want in names:
            ms = sum(v for k, v in busy.items() if want in k)
            n = sum(1 for kname, _, _ in kern if want in kname)
            log(f"phase {phase}:   {want}: {ms:.4f} ms over {n} launches "
                f"({100 * ms / max(total, 1e-9):.2f}% of the device busy time)")
        out[name] = {"wall_ms": wall, "device_ops": len(kern), "busy_ms": total,
                     "idle": 1 - total / wall}
    return out


def _timed_serving(model, engines, queues, tag) -> dict:
    """Run each replica's queue through its engine with ``model.prefill``
    and ``model.decode_step`` wrapped: ``{"prefill": [...], "decode": [...],
    "serve_s": s}``, one record a call with its wall (synchronized), its
    tokens, its flash and ``dispatch_count`` launches, and whether its
    logits are finite (the serving phases 9, 21, 23 and 24)."""
    rec = {"prefill": [], "decode": []}
    orig = {"prefill": model.prefill, "decode": model.decode_step}

    def timed(kind):
        def call(*a, **k):
            before = _launch_counts()
            t0 = time.perf_counter()
            logits, cache = orig[kind](*a, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            now = _launch_counts()
            rec[kind].append({
                "wall": wall, "len": a[1]["tokens"].shape[1] if kind == "prefill" else 1,
                "flash": now["flash_attention"] - before["flash_attention"],
                "dispatch": now["dispatch_count"] - before["dispatch_count"],
                "finite": bool(torch.isfinite(logits).all())})
            return logits, cache
        return call

    model.prefill, model.decode_step = timed("prefill"), timed("decode")
    try:
        t = time.perf_counter()
        for r, (eng, q) in enumerate(zip(engines, queues)):
            eng.run(q, max_ticks=200)
            log(f"phase {tag}: replica {r}: {len(q)} requests, {eng.tokens_out} tokens, "
                f"{eng.steps} ticks")
        torch.cuda.synchronize()
        rec["serve_s"] = time.perf_counter() - t
    finally:
        model.prefill, model.decode_step = orig["prefill"], orig["decode"]
    return rec


def serve_phases(dev, card) -> list[dict]:
    """Phases 9-12: DR-routed serving of gemma-2b and the flash kernel."""
    import repro_torch.models.model as model
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import DRScheduler

    bf16 = torch.bfloat16
    cfg = get_config("gemma-2b")
    pol = Policy(param_dtype=bf16, compute_dtype=bf16)

    # ---- phase 9: full-width serving through DRScheduler + ServeEngine ----
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"phase 9: gemma-2b: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} q heads "
        f"over {cfg.num_kv_heads} kv head, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB bf16), "
        f"initialised on the card in {time.perf_counter() - t:.1f} s")
    n_req, max_new, n_rep, slots, max_len = 32, 16, 4, 4, 2064
    rng = np.random.default_rng(0)
    sessions = np.where(rng.random(n_req) < 0.3, 7, rng.integers(0, 1000, n_req))
    lens = rng.integers(256, 2049, n_req)
    sched = DRScheduler(n_rep)
    engines = [ServeEngine(cfg, params, pol, slots=slots, max_len=max_len, device=dev)
               for _ in range(n_rep)]
    queues: list[list] = [[] for _ in range(n_rep)]
    for i in range(n_req):
        req = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32),
                      max_new_tokens=max_new, session_key=int(sessions[i]))
        queues[sched.route(req.session_key, cost_tokens=max_new)].append(req)

    first_flash = []  # the first prefill's layer-0 flash inputs
    orig_flash = kflash.flash_attention_seq_major

    def flash_capture(q, k, v, **kw):
        if not first_flash:
            first_flash.append((q.clone(), k.clone(), v.clone(), kw))
        return orig_flash(q, k, v, **kw)

    # time each prefill and decode step the engines make, and check their logits
    kflash.flash_attention_seq_major = flash_capture
    try:
        flash_attention.launches = 0
        rec = _timed_serving(model, engines, queues, "9")
        launches = flash_attention.launches
    finally:
        kflash.flash_attention_seq_major = orig_flash
    serve_s = rec["serve_s"]
    info = sched.checkpoint(sessions)
    reqs = [r for q in queues for r in q]
    assert len(reqs) == n_req
    for r in reqs:
        assert len(r.out_tokens) == max_new and r.done, (r.rid, r.out_tokens)
        assert all(0 <= x < cfg.vocab_size for x in r.out_tokens), (r.rid, r.out_tokens)
    calls = rec["prefill"] + rec["decode"]
    assert calls and all(c["finite"] for c in calls), "non-finite logits"
    assert launches == cfg.num_layers * n_req, launches
    assert set(info) == {"repartitioned", "resized", "num_replicas", "imbalance",
                         "moved_sessions", "reason", "backend", "overlapped"}, info
    tokens = sum(len(r.out_tokens) for r in reqs)
    prefill_ms = statistics.median(c["wall"] for c in rec["prefill"]) * 1e3
    decode_ms = statistics.median(c["wall"] for c in rec["decode"]) * 1e3
    log(f"phase 9: routed={sched.routed} imbalance={sched.imbalance():.2f}; prompts "
        f"{int(lens.min())}-{int(lens.max())} tokens (mean {lens.mean():.1f}); {tokens} tokens "
        f"in {serve_s:.2f} s ({tokens / serve_s:.1f} tokens/s); flash launches {launches} "
        f"(= {cfg.num_layers} layers x {n_req} prefills); all logits finite")
    log(f"phase 9: DR checkpoint: {info}")
    q9, k9, v9, kw9 = first_flash[0]
    assert same_bits_with_lse(q9, k9, v9, kw9), kw9
    log(f"phase 9: the first prefill's layer-0 flash (Sq={q9.shape[1]}) gives the same bits "
        f"with and without lse")
    del engines, first_flash, q9, k9, v9
    torch.cuda.empty_cache()

    # ---- phase 10: the flash kernel against its plain version -------------
    # p_bf16 rounds the weights to bf16 in both versions, so a last-bit
    # difference in a score may flip a rounding: 2e-2 for float32 inputs too
    errs = {(dt, pb): 0.0 for dt in (torch.float32, bf16) for pb in (False, True)}
    # bf16 outputs with float32 weights, held to the float32 plain version on
    # the same (bf16) inputs beyond the output's own rounding: P_hi + P_lo
    # keeps P to about 2**-17, so the excess is float32 noise; weights rounded
    # to bf16 (plain p_bf16=True, the control) leave ~1e-3
    excess = {"kernel": -1.0, "control": -1.0}
    EXCESS_LIMIT = 2e-4
    tol = {(torch.float32, False): 2e-5, (torch.float32, True): 2e-2,
           (bf16, False): 2e-2, (bf16, True): 2e-2}
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(1, 8, sq, 256) for sq in (1, 100, 512, 2048)]
    cases += [(g, p, sq, hd) for hd, g, p in ((16, 3, 2), (64, 2, 1), (128, 4, 2), (192, 2, 2))
              for sq in (7, 300)]
    n_cases = 0
    for g, p, sq, hd in cases:
        for dtype in (torch.float32, bf16):
            q = torch.randn((g, p, sq, hd), generator=gen, device=dev).to(dtype)
            k = torch.randn((g, sq, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((g, sq, hd), generator=gen, device=dev).to(dtype)
            for causal, window in ((True, 0), (False, 0), (True, 96)):
                for pb in (False, True):
                    got = flash_attention(q, k, v, causal=causal, window=window, p_bf16=pb)
                    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                                 p_bf16=pb)
                    torch.cuda.synchronize()
                    assert got.dtype == dtype and got.shape == q.shape
                    err = float((got.float() - want.float()).abs().max())
                    errs[dtype, pb] = max(errs[dtype, pb], err)
                    n_cases += 1
                    assert err <= tol[dtype, pb], (g, p, sq, hd, dtype, causal, window, pb, err)
                    if dtype == bf16 and not pb:
                        ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                                    causal=causal, window=window)
                        control = flash_attention_plain(q, k, v, causal=causal, window=window,
                                                        p_bf16=True)
                        excess["kernel"] = max(excess["kernel"],
                                               excess_over_bf16_rounding(got, ref))
                        excess["control"] = max(excess["control"],
                                                excess_over_bf16_rounding(control, ref))
    # bf16 (the wgmma kernel) off the diagonal: q rows at positions 120-169
    # over 170 k rows, as a chunked prefill would call it
    q = torch.randn((2, 3, 50, 64), generator=gen, device=dev).to(bf16)
    k = torch.randn((2, 170, 64), generator=gen, device=dev).to(bf16)
    v = torch.randn((2, 170, 64), generator=gen, device=dev).to(bf16)
    for causal, window in ((True, 0), (False, 40)):
        got = flash_attention(q, k, v, causal=causal, window=window, q_offset=120)
        want = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=120)
        torch.cuda.synchronize()
        assert got.dtype == bf16 and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        errs[bf16, False] = max(errs[bf16, False], err)
        n_cases += 1
        assert err <= tol[bf16, False], ("q_offset 120, Sk 170", causal, window, err)
    # float32 weights through the bf16 tensor cores (P_hi + P_lo) keep
    # float32-level precision: the check tells bf16 weights apart (control)
    assert errs[bf16, False] <= 8e-3, errs
    assert excess["kernel"] <= EXCESS_LIMIT < excess["control"], excess
    log(f"phase 10: flash_attention: {n_cases} cases within tolerance; max abs error with "
        f"p_bf16=False: {errs[torch.float32, False]:.3g} in float32 (<= 2e-5), "
        f"{errs[bf16, False]:.3g} in bf16 (<= 8e-3); with p_bf16=True: "
        f"{errs[torch.float32, True]:.3g} in float32, {errs[bf16, True]:.3g} in bf16 (<= 2e-2)")
    log(f"phase 10: bf16 outputs against the float32 plain version beyond the output's own "
        f"rounding: kernel (p_bf16=False) {excess['kernel']:.3g} (<= {EXCESS_LIMIT:g}); "
        f"control, plain with p_bf16=True {excess['control']:.3g} (> {EXCESS_LIMIT:g})")

    # ---- phase 11: card against CPU, full width, depth 2, float32 ---------
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    pol32 = Policy()
    cpu_params = model.init_params(cfg2, 1, pol32, device="cpu")
    card_params = _to(cpu_params, dev)
    rng = np.random.default_rng(1)
    worst, checked, margins_skipped = 0.0, 0, 0
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(128, 257)))
        toks = torch.as_tensor(prompt[None].astype(np.int64))
        lc, cc = model.prefill(cpu_params, {"tokens": toks}, cfg2, pol32, max_len=272)
        lg, cg = model.prefill(card_params, {"tokens": toks.to(dev)}, cfg2, pol32, max_len=272)
        for step in range(8):
            a = lc[0, -1, :cfg.vocab_size]
            b = lg[0, -1, :cfg.vocab_size].cpu()
            assert bool(torch.isfinite(b).all())
            worst = max(worst, float((a - b).abs().max()))
            checked += 1
            top2 = torch.topk(a.double(), 2).values
            nxt = int(torch.argmax(a))
            if float(top2[0] - top2[1]) > 1e-2:
                assert int(torch.argmax(b)) == nxt, (i, step)
            else:
                margins_skipped += 1
            if step == 7:
                break
            lc, cc = model.decode_step(cpu_params, cc, torch.tensor([[nxt]]), cfg2, pol32)
            lg, cg = model.decode_step(card_params, cg, torch.tensor([[nxt]], device=dev),
                                       cfg2, pol32)
    assert worst <= 1e-3, worst
    log(f"phase 11: gemma-2b depth 2, float32, TF32 off: {checked} teacher-forced steps over 4 "
        f"prompts; max |logit card - CPU| {worst:.3g} (<= 1e-3); greedy tokens equal "
        f"({margins_skipped} steps with a top-two margin <= 1e-2 not compared)")
    del cpu_params, card_params, cc, cg
    torch.cuda.empty_cache()

    # ---- phase 12: times ----------------------------------------------------
    import torch.nn.functional as F

    rows = {}
    for sq in (512, 1024, 2048):
        q = torch.randn((1, 8, sq, 256), generator=gen, device=dev).to(bf16)
        k = torch.randn((1, sq, 256), generator=gen, device=dev).to(bf16)
        v = torch.randn((1, sq, 256), generator=gen, device=dev).to(bf16)
        ke, ve = (x[:, None].expand(1, 8, sq, 256).contiguous() for x in (k, v))
        # ms: CUDA events around one call (as every kernel's ms); dev: the
        # device's own time over 20 calls (device_ms), no host in it
        k_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
        kb_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, p_bf16=True))
        p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True))
        l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
        k_dev = device_ms(lambda: flash_attention(q, k, v, causal=True))
        kb_dev = device_ms(lambda: flash_attention(q, k, v, causal=True, p_bf16=True))
        assert same_bits_with_lse(q.permute(2, 0, 1, 3)[None], k.permute(1, 0, 2)[None],
                                  v.permute(1, 0, 2)[None], dict(causal=True)), sq
        l_dev = device_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
        nbytes, flops = flash_cost(1, 1, 8, sq, sq, 256, True, bf16)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[bf16]) * 1e3
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, sq)), device=dev)
        pre = []
        for _ in range(4):
            t = time.perf_counter()
            model.prefill(params, {"tokens": toks}, cfg, pol, max_len=max_len)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t)
        pre_ms = statistics.median(pre[1:]) * 1e3
        rows[sq] = (k_ms, p_ms, l_ms, k_dev, l_dev, bound_ms, nbytes, flops)
        log(f"phase 12: flash_attention G=1 P=8 hd=256 Sq=Sk={sq} bf16 causal, events around "
            f"one call: kernel {k_ms:.4f} ms, p_bf16=True {kb_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"SDPA {l_ms:.4f} ms; device time: kernel {k_dev:.4f} ms ({flops / k_dev / 1e9:.1f} "
            f"TFLOP/s, {100 * bound_ms / k_dev:.1f}% of the bound {bound_ms:.4f} ms by "
            f"operations: {flops:,} FLOP, {nbytes:,} bytes), p_bf16=True {kb_dev:.4f} ms, SDPA "
            f"{l_dev:.4f} ms (kernel / SDPA {k_dev / l_dev:.2f}); the output equal bit for bit "
            f"with and without lse; prefill of {sq} tokens "
            f"{pre_ms:.2f} ms, of which flash {cfg.num_layers} x {k_ms:.4f} ms = "
            f"{100 * cfg.num_layers * k_ms / pre_ms:.1f}% (by device time "
            f"{100 * cfg.num_layers * k_dev / pre_ms:.1f}%)")
    q32, k32, v32 = (x.float() for x in (q, k, v))
    f32_ms = cuda_ms(lambda: flash_attention(q32, k32, v32, causal=True))
    f32_dev = device_ms(lambda: flash_attention(q32, k32, v32, causal=True), n=5)
    log(f"phase 12: flash_attention float32 (scalar kernel) at Sq=Sk=2048: {f32_ms:.4f} ms "
        f"(events around one call), device time {f32_dev:.4f} ms "
        f"({flops / f32_dev / 1e9:.1f} TFLOP/s)")
    profile_serving(model, params, cfg, pol, rng, dev, max_len)
    log(f"phase 12: phase 9 medians: prefill {prefill_ms:.2f} ms per request "
        f"({len(rec['prefill'])} prefills), decode {decode_ms:.2f} ms per token "
        f"({len(rec['decode'])} steps, one slot each); {tokens / serve_s:.1f} tokens/s; "
        f"card {card}")
    k_ms, p_ms, l_ms, k_dev, l_dev, bound_ms, nbytes, flops = rows[2048]
    return [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": REPLACES["flash_attention"], "launches": launches,
        "max_abs_err": max(errs.values()), "max_abs_err_f32": errs[torch.float32, False],
        "max_abs_err_bf16": errs[bf16, False],
        "p_bf16_max_abs_err": max(errs[torch.float32, True], errs[bf16, True]),
        "p_bf16_max_abs_err_f32": errs[torch.float32, True],
        "p_bf16_max_abs_err_bf16": errs[bf16, True],
        "excess_over_bf16_rounding": excess["kernel"], "ms": k_ms, "plain_ms": p_ms,
        "device_ms": k_dev, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_FLOPS[bf16] > nbytes / HBM_BYTES_PER_S
        else "bytes", "bytes": nbytes, "flops": flops, "library_ms": l_ms,
        "library_device_ms": l_dev,
        "shape": "G=1 P=8 Sq=Sk=2048 hd=256 bf16 causal",
    }]


# phase 18: Llama 4 Scout at its full published width, cut in depth only
SCOUT_LAYERS = 8      # of its 48 (PERF.md §4: 16 would not fit beside the cache)
EP_SHARDS = 4         # the model axis of the reference's own test mesh
EXPERT_BYTES = 3 * 5120 * 8192 * 2  # one expert's wi [d, 2, f] and wo [f, d] in bf16
BF16_REL = 2e-2       # |a - b| <= 2e-2 * max(1, |b|): two bf16 paths of one function


def bf16_rel_err(got, want) -> float:
    """max |got - want| / max(1, |want|) over all elements, in float64."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / w.abs().clamp(min=1.0)).max())


def _place_after(place: np.ndarray, perm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(place, inv_place)`` once the weights at slots ``place`` (slot p
    holds logical expert place[p]) are permuted by ``perm`` (new slot p
    takes old slot perm[p])."""
    new = np.asarray(place)[np.asarray(perm)].astype(np.int32)
    inv = np.zeros_like(new)
    inv[new] = np.arange(len(new), dtype=np.int32)
    return new, inv


def moe_phase(dev, card) -> dict:
    """Phase 18: Llama 4 Scout at full width (8 of 48 layers, bf16) over 4
    stacked EP shards: DR-routed serving with KIP re-placement between
    prefills, one layer's dispatch against its oracle, the two path
    kernels on the path's own inputs, and a fixed re-placement.  Returns
    the ``kernels`` line's phase-18 entries by kernel name."""
    import torch.nn.functional as F

    import repro_torch.models.model as model
    import repro_torch.models.transformer as transformer
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.models.modules import Policy
    from repro_torch.moe.kip_placement import PlacementController, apply_placement_to_weights
    from repro_torch.moe.layer import moe_apply, moe_ref
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import DRScheduler

    bf16 = torch.bfloat16
    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, num_layers=SCOUT_LAYERS)
    spec = cfg.moe
    pol = Policy(param_dtype=bf16, compute_dtype=bf16, ep_shards=EP_SHARDS,
                 exchange_backend="dense")
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    moe_idx = [i for i, blk in enumerate(transformer.layers(cfg)) if blk.ffn == "moe"]
    assert len(moe_idx) == SCOUT_LAYERS
    log(f"phase 18: {full.name}: {cfg.num_layers} of {full.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads, head_dim "
        f"{cfg.head_dim}, {spec.num_experts} experts top-{spec.top_k} (d_ff_expert "
        f"{spec.d_ff_expert}, shared expert, capacity factor {spec.capacity_factor}), vocab "
        f"{cfg.vocab_size}: {n_params:,} parameters ({n_params * 2 / 1e9:.2f} GB bf16), "
        f"initialised on the card in {time.perf_counter() - t:.1f} s; {EP_SHARDS} stacked EP "
        f"shards of {spec.num_experts // EP_SHARDS} experts, dense transport; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    identity = torch.arange(spec.num_experts, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)

    # ---- (b) one MoE layer against its oracle, nothing dropped ------------
    p0 = params["layers"][moe_idx[0]]["moe"]
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device=dev).to(bf16)
    pol8 = dataclasses.replace(pol, moe_capacity_factor=8.0)
    want = moe_ref(p0, x, spec, cfg.ffn_kind, pol8)
    outs = {be: moe_apply(p0, x, spec, cfg.ffn_kind,
                          dataclasses.replace(pol8, exchange_backend=be), identity)
            for be in ("dense", "ragged")}
    torch.cuda.synchronize()
    got = outs["dense"]
    err = bf16_rel_err(got.y, want.y)
    assert got.y.dtype == bf16 and got.y.shape == x.shape and bool(torch.isfinite(got.y).all())
    assert torch.equal(got.counts, want.counts), (got.counts, want.counts)
    assert float(got.overflow) == 0.0 == float(outs["ragged"].overflow)
    assert err <= BF16_REL, err
    assert torch.equal(got.y, outs["ragged"].y)
    assert torch.equal(got.counts, outs["ragged"].counts)
    log(f"phase 18 (b): one MoE layer, 1,024 tokens, capacity 8.0: moe_apply against moe_ref "
        f"on the card max |diff| / max(1, |ref|) {err:.3g} (<= {BF16_REL:g}), max abs diff "
        f"{float((got.y.float() - want.y.float()).abs().max()):.3g}; counts equal "
        f"{got.counts.int().tolist()}, overflow 0; dense and ragged y bit-identical (shipped "
        f"rows {int(got.shipped_rows)} dense, {int(outs['ragged'].shipped_rows)} ragged; "
        f"occupied {int(got.occupied_rows)} both)")
    del x, want, outs, got
    torch.cuda.empty_cache()

    # ---- (a) serving through DRScheduler + ServeEngine --------------------
    n_req, max_new, n_rep, slots, max_len = 32, 16, 4, 4, 2064
    rng = np.random.default_rng(0)
    sessions = np.where(rng.random(n_req) < 0.3, 7, rng.integers(0, 1000, n_req))
    lens = rng.integers(256, 2049, n_req)
    assert (lens % EP_SHARDS == 0).any() and (lens % EP_SHARDS != 0).any(), lens
    sched = DRScheduler(n_rep)
    engines = [ServeEngine(cfg, params, pol, slots=slots, max_len=max_len, device=dev)
               for _ in range(n_rep)]
    queues: list[list] = [[] for _ in range(n_rep)]
    for i in range(n_req):
        req = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32),
                      max_new_tokens=max_new, session_key=int(sessions[i]))
        queues[sched.route(req.session_key, cost_tokens=max_new)].append(req)

    ctl = PlacementController(spec.num_experts, EP_SHARDS)
    costed = PlacementController(spec.num_experts, EP_SHARDS, expert_weight_bytes=EXPERT_BYTES)
    state = {"inv": identity}
    prefills, decodes, finite, moves = [], [], [], []
    per_call: dict = {}
    orig = {"prefill": model.prefill, "decode": model.decode_step,
            "backbone": transformer.backbone, "moe_apply": transformer.moe_apply,
            "moe_apply_replicated": transformer.moe_apply_replicated}

    def backbone(*a, **k):
        out = orig["backbone"](*a, **k)
        per_call["counts"], per_call["overflow"] = out[2], out[3]
        return out

    def dispatch(name):
        def call(*a, **k):
            out = orig[name](*a, **k)
            per_call.setdefault("paths", []).append(name)
            if out.shipped_rows is not None:
                per_call["shipped"] = per_call.get("shipped", 0) + int(out.shipped_rows)
                per_call["occupied"] = per_call.get("occupied", 0) + int(out.occupied_rows)
            return out
        return call

    def timed(kind):
        def call(params_, batch_or_cache, *a, **k):
            per_call.clear()
            launches = (dispatch_count.launches, flash_attention.launches)
            t0 = time.perf_counter()
            logits, cache = orig[kind](params_, batch_or_cache, *a, inv_place=state["inv"], **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            finite.append(bool(torch.isfinite(logits).all()))
            rec = {"wall": wall, "dc": dispatch_count.launches - launches[0],
                   "fa": flash_attention.launches - launches[1],
                   "paths": sorted(set(per_call.get("paths", []))),
                   "overflow": float(per_call["overflow"])}
            if kind == "decode":
                decodes.append(rec)
                return logits, cache
            counts = per_call["counts"].cpu().numpy()
            s = batch_or_cache["tokens"].shape[1]
            assert counts.sum() == s * SCOUT_LAYERS * spec.top_k, (counts.sum(), s)
            sl = counts[ctl.placement.place].reshape(EP_SHARDS, -1).sum(axis=1)
            rec.update(len=s, counts=counts, imbalance=float(sl.max() / sl.mean()),
                       shipped=per_call.get("shipped"), occupied=per_call.get("occupied"))
            prefills.append(rec)
            # the safe point between prefills: the router's counts feed the
            # controllers; a Replace permutes every MoE layer's experts
            for c in (ctl, costed):
                c.observe(counts)
            changed, _, perm = ctl.maybe_update()
            costed.maybe_update()
            if changed:
                t1 = time.perf_counter()
                for i in moe_idx:
                    params["layers"][i]["moe"] = apply_placement_to_weights(
                        params["layers"][i]["moe"], perm)
                state["inv"] = torch.as_tensor(ctl.placement.inv_place, device=dev)
                torch.cuda.synchronize()
                moves.append({"after_prefill": len(prefills) - 1,
                              "moved": int((perm != np.arange(len(perm))).sum()),
                              "wall_ms": (time.perf_counter() - t1) * 1e3})
            return logits, cache
        return call

    model.prefill, model.decode_step = timed("prefill"), timed("decode")
    transformer.backbone = backbone
    transformer.moe_apply = dispatch("moe_apply")
    transformer.moe_apply_replicated = dispatch("moe_apply_replicated")
    try:
        dispatch_count.launches = flash_attention.launches = 0
        t = time.perf_counter()
        for r, (eng, q) in enumerate(zip(engines, queues)):
            eng.run(q, max_ticks=200)
            log(f"phase 18 (a): replica {r}: {len(q)} requests, {eng.tokens_out} tokens, "
                f"{eng.steps} ticks")
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        path_launches = {"dispatch_count": dispatch_count.launches,
                         "flash_attention": flash_attention.launches}
    finally:
        model.prefill, model.decode_step = orig["prefill"], orig["decode"]
        transformer.backbone = orig["backbone"]
        transformer.moe_apply = orig["moe_apply"]
        transformer.moe_apply_replicated = orig["moe_apply_replicated"]
    reqs = [r for q in queues for r in q]
    assert len(reqs) == n_req == len(prefills)
    for r in reqs:
        assert len(r.out_tokens) == max_new and r.done, (r.rid, r.out_tokens)
        assert all(0 <= x < cfg.vocab_size for x in r.out_tokens), (r.rid, r.out_tokens)
    assert finite and all(finite), "non-finite logits"
    assert all(v > 0 for v in path_launches.values()), path_launches
    for rec in prefills:
        split = rec["len"] % EP_SHARDS == 0
        assert rec["paths"] == (["moe_apply"] if split else ["moe_apply_replicated"]), rec
        assert rec["dc"] == SCOUT_LAYERS * (2 if split else 1), rec
        assert rec["fa"] == SCOUT_LAYERS, rec
    assert all(d["paths"] == ["moe_apply_replicated"] and d["dc"] == SCOUT_LAYERS
               and d["fa"] == 0 for d in decodes), decodes[:3]
    assert path_launches["dispatch_count"] == sum(p["dc"] for p in prefills + decodes)
    tokens = sum(len(r.out_tokens) for r in reqs)
    split_pre = [p for p in prefills if p["len"] % EP_SHARDS == 0]
    repl_pre = [p for p in prefills if p["len"] % EP_SHARDS]
    prefill_ms = statistics.median(p["wall"] for p in prefills) * 1e3
    decode_ms = statistics.median(d["wall"] for d in decodes) * 1e3
    dropped = sum(p["overflow"] for p in prefills) + sum(d["overflow"] for d in decodes)
    # for phase 27: the placement the serving run ended with, and its walls
    served = {"place": np.asarray(ctl.placement.place).copy(), "prefill_ms": prefill_ms,
              "decode_ms": decode_ms}
    log(f"phase 18 (a): routed={sched.routed} imbalance={sched.imbalance():.2f}; prompts "
        f"{int(lens.min())}-{int(lens.max())} tokens, {len(split_pre)} a multiple of "
        f"{EP_SHARDS} (moe_apply), {len(repl_pre)} not (moe_apply_replicated); {tokens} tokens "
        f"in {serve_s:.2f} s ({tokens / serve_s:.1f} tokens/s); launches in the serving run: "
        f"{path_launches}; per prefill dispatch_count {SCOUT_LAYERS * 2} (moe_apply) or "
        f"{SCOUT_LAYERS} (replicated) and flash {SCOUT_LAYERS}; per decoded token "
        f"dispatch_count {SCOUT_LAYERS}, flash 0; all logits finite")
    log(f"phase 18 (a): walls: prefill median {prefill_ms:.2f} ms ({len(prefills)} prefills; "
        f"moe_apply {statistics.median(p['wall'] for p in split_pre) * 1e3:.2f} ms, "
        f"replicated {statistics.median(p['wall'] for p in repl_pre) * 1e3:.2f} ms), decode "
        f"median {decode_ms:.2f} ms per token ({len(decodes)} steps, one slot each); dropped "
        f"(token, expert) pairs: {dropped:g} in all, prefills {[p['overflow'] for p in prefills]}"
        f"; card {card}")
    log("phase 18 (a): per prefill (length: shipped / occupied rows, dropped, shard "
        "imbalance): " + "; ".join(
            f"{p['len']}: {p['shipped']} / {p['occupied']}, {p['overflow']:g}, "
            f"{p['imbalance']:.3f}" for p in prefills))

    # ---- (d) placement: every decision, the moves and their effect --------
    for name, c in (("PlacementController(16, 4)", ctl),
                    (f"PlacementController(16, 4, expert_weight_bytes={EXPERT_BYTES})", costed)):
        taken, declined = c.decisions.counts()
        log(f"phase 18 (d): {name}: {taken} taken, {declined} declined; history {c.history}")
        for d in c.decisions.records:
            log(f"phase 18 (d):   tick {d.tick} {d.kind} taken={d.taken} imbalance "
                f"{d.imbalance:.4f}: {d.reason} {d.detail or ''}")
    for mv in moves:
        i = mv["after_prefill"]
        nxt = prefills[i + 1] if i + 1 < len(prefills) else None
        log(f"phase 18 (d): Replace after prefill {i}: {mv['moved']} experts moved, "
            f"apply_placement_to_weights over {SCOUT_LAYERS} layers {mv['wall_ms']:.2f} ms; "
            f"shard imbalance {prefills[i]['imbalance']:.4f} / dropped "
            f"{prefills[i]['overflow']:g} (length {prefills[i]['len']}) before, "
            + (f"{nxt['imbalance']:.4f} / {nxt['overflow']:g} (length {nxt['len']}) at the "
               f"next prefill" if nxt else "no prefill after it"))
    if not moves:
        log("phase 18 (d): no Replace was taken in the serving run")

    # ---- (c) the path kernels on the path's own inputs --------------------
    captured = {"dispatch": [], "flash": []}
    orig_slots, orig_flash = ops.dispatch_slots, kflash.flash_attention_seq_major

    def slots_capture(dest, valid=None, *, num_parts):
        captured["dispatch"].append((dest.clone(), None if valid is None else valid.clone(),
                                     num_parts))
        return orig_slots(dest, valid, num_parts=num_parts)

    def flash_capture(q, k, v, **kw):
        captured["flash"].append((q.clone(), k.clone(), v.clone(), kw))
        return orig_flash(q, k, v, **kw)

    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1024)), device=dev)
    ops.dispatch_slots, kflash.flash_attention_seq_major = slots_capture, flash_capture
    try:
        logits, cache = model.prefill(params, {"tokens": toks}, cfg, pol, max_len=1040,
                                      inv_place=state["inv"])
        hop = captured["dispatch"][:2]
        captured["dispatch"].clear()
        model.decode_step(params, cache, torch.zeros((1, 1), dtype=torch.int64, device=dev),
                          cfg, pol, inv_place=state["inv"])
        dec = captured["dispatch"][:1]
    finally:
        ops.dispatch_slots, kflash.flash_attention_seq_major = orig_slots, orig_flash
    del cache
    out = {}
    dc_rows = {}
    for name, (dest, valid, parts) in zip(("hop 1", "hop 2", "decode"), hop + dec):
        valid = torch.ones_like(dest, dtype=torch.bool) if valid is None else valid
        dest = dest.to(torch.int32).contiguous()
        got = dispatch_count(dest, valid, num_parts=parts)
        want = dispatch_count_plain(dest, valid, num_parts=parts)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        w, n = dest.shape
        nbytes = w * n * (4 + 1) + w * n * 4 + w * parts * 4
        k_ms = cuda_ms(lambda: dispatch_count(dest, valid, num_parts=parts))
        p_ms = cuda_ms(lambda: dispatch_count_plain(dest, valid, num_parts=parts))
        d_ms, split, n_ops = own_device_time(lambda: dispatch_count(dest, valid, num_parts=parts),
                                             DEVICE_NAMES["dispatch_count"])
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        dc_rows[name] = {"shape": f"W={w} n={n} L={parts}", "ms": k_ms, "plain_ms": p_ms,
                         "device_ms": d_ms, "device_split_ms": split, "bound_ms": bound,
                         "bytes": nbytes, "equal": True,
                         "valid": int(valid.sum())}
        log(f"phase 18 (c): dispatch_count [{name}] W={w} n={n} L={parts} "
            f"({int(valid.sum())} valid): bit-equal to its plain version; {k_ms:.4f} ms by "
            f"events around one call, device time {d_ms:.4f} ms ({split}), plain "
            f"{p_ms:.4f} ms, bound {bound:.6f} ms by bytes ({nbytes} bytes); card {card}")
    out["dispatch_count"] = {"launches_phase_18": path_launches["dispatch_count"],
                             "phase_18": dc_rows}
    q, k, v, kw = captured["flash"][0]
    b, sq, g, pp, hd = q.shape
    assert (g, pp, hd, q.dtype) == (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                                    cfg.head_dim, bf16), (q.shape, q.dtype)
    got = kflash.flash_attention_seq_major(q, k, v, **kw)
    qp = q.permute(0, 2, 3, 1, 4).reshape(b * g, pp, sq, hd)
    kp = k.permute(0, 2, 1, 3).reshape(b * g, -1, hd)
    vp = v.permute(0, 2, 1, 3).reshape(b * g, -1, hd)
    plain = lambda: flash_attention_plain(qp, kp, vp, causal=kw["causal"], window=kw["window"],
                                          q_offset=kw["q_offset"], p_bf16=kw["p_bf16"])
    want = plain().reshape(b, g, pp, sq, hd).permute(0, 3, 1, 2, 4).reshape(b, sq, -1)
    torch.cuda.synchronize()
    f_err = float((got.float() - want.float()).abs().max())
    assert kw["causal"] and not kw["p_bf16"] and f_err <= 8e-3, (f_err, kw)
    assert same_bits_with_lse(q, k, v, kw)
    # SDPA on the same inputs, the kv heads expanded to the 40 q heads
    qs = q.reshape(b, sq, g * pp, hd).transpose(1, 2)
    ks = k.repeat_interleave(pp, dim=2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(pp, dim=2).transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    s_err = float((sdpa().transpose(1, 2).reshape(b, sq, -1).float() - want.float()).abs().max())
    fk = lambda: kflash.flash_attention_seq_major(q, k, v, **kw)
    k_ms, p_ms, l_ms = cuda_ms(fk), cuda_ms(plain), cuda_ms(sdpa)
    k_dev, l_dev = device_ms(fk), device_ms(sdpa)
    nbytes, flops = flash_cost(1, g, pp, sq, sq, hd, True, bf16)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[bf16]) * 1e3
    out["flash_attention"] = {"launches_phase_18": path_launches["flash_attention"], "phase_18": {
        "shape": f"G={g} P={pp} Sq=Sk={sq} hd={hd} bf16 causal (Scout layer 0's prefill)",
        "max_abs_err": f_err, "ms": k_ms, "plain_ms": p_ms, "device_ms": k_dev,
        "bound_ms": bound, "bound_by": "operations" if flops / PEAK_FLOPS[bf16]
        > nbytes / HBM_BYTES_PER_S else "bytes", "bytes": nbytes, "flops": flops,
        "library_ms": l_ms, "library_device_ms": l_dev}}
    log(f"phase 18 (c): flash_attention on layer 0's prefill inputs G={g} P={pp} Sq=Sk={sq} "
        f"hd={hd} bf16 causal: max abs error against its plain version {f_err:.3g} (<= 8e-3; "
        f"bit-equal with and without lse; "
        f"SDPA against the plain version {s_err:.3g}); events around one call: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms; device time: kernel "
        f"{k_dev:.4f} ms ({100 * bound / k_dev:.1f}% of the bound {bound:.4f} ms: {flops:,} "
        f"FLOP, {nbytes:,} bytes), SDPA {l_dev:.4f} ms (kernel / SDPA {k_dev / l_dev:.2f}); "
        f"card {card}")
    del captured, q, k, v, qs, ks, vs, got, want

    profile_serving(model, params, cfg, pol, rng, dev, 1040, phase=18, inv_place=state["inv"],
                    names=("dispatch_rank_kernel", "flash"))

    # ---- (d) a fixed re-placement at capacity 8.0 changes no output --------
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1024)), device=dev)
    one = torch.zeros((1, 1), dtype=torch.int64, device=dev)

    def logits_of(inv):
        lg, cache = model.prefill(params, {"tokens": toks}, cfg, pol8, max_len=1040,
                                  inv_place=inv)
        ld, _ = model.decode_step(params, cache, one, cfg, pol8, inv_place=inv)
        return lg.float(), ld.float()

    before = logits_of(state["inv"])
    perm = np.arange(spec.num_experts, dtype=np.int32)[::-1].copy()  # every expert moves shard
    t = time.perf_counter()
    for i in moe_idx:
        params["layers"][i]["moe"] = apply_placement_to_weights(params["layers"][i]["moe"], perm)
    torch.cuda.synchronize()
    permute_ms = (time.perf_counter() - t) * 1e3
    _, inv = _place_after(ctl.placement.place, perm)
    after = logits_of(torch.as_tensor(inv, device=dev))
    errs = [bf16_rel_err(a, b) for a, b in zip(after, before)]
    assert all(bool(torch.isfinite(a).all()) for a in after)
    assert max(errs) <= BF16_REL, errs
    log(f"phase 18 (d): a fixed permutation (experts reversed: each to another shard), "
        f"apply_placement_to_weights over {SCOUT_LAYERS} layers {permute_ms:.2f} ms; at capacity "
        f"8.0 the 1,024-token prefill's and the next decode step's logits against the "
        f"placement before: max |diff| / max(1, |ref|) {errs[0]:.3g} and {errs[1]:.3g} "
        f"(<= {BF16_REL:g}); card {card}")
    log(f"phase 18: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {card}")
    del params, engines
    out["serving"] = served
    return out



# phase 19: training at full width
TRAIN_SEQ = 1024
GEMMA_BATCH = 4
SCOUT_TRAIN_LAYERS = 2   # of its 48: 4 would not fit beside the optimizer state on 80 GB
SCOUT_BATCH = 2
FLASH_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
BWD_EXCESS = 1e-3        # bf16 gradients: excess over their own rounding <= 1e-3 x max |ref|
BWD_F32_REL = 1e-4       # float32 gradients: |diff| <= 1e-4 x max |ref|
LSE_ABS = 1e-5           # the forward's lse against torch.logsumexp (natural-log units)
# the backward's device kernels, by the profiler's names: D, the stats pass
# (float32, or bf16 without the forward's lse), dk and dv, the reduce of
# split partials, dq
BWD_DEVICE_NAMES = ("flash_bwd_dsum", "flash_bwd_stats", "flash_bwd_dkdv", "flash_bwd_reduce",
                    "flash_bwd_dq")


def _lm_batch(toks, dev):
    t = torch.as_tensor(toks, device=dev)
    return {"tokens": t[:, :-1], "labels": t[:, 1:],
            "mask": torch.ones(t.shape[0], t.shape[1] - 1, device=dev)}


def _launch_counts():
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.dispatch_count import dispatch_count

    return {"flash_attention": kflash.flash_attention.launches,
            "flash_attention_bwd": kflash.flash_attention_bwd_seq_major.launches,
            "flash_attention_bwd_stats": kflash.flash_attention_bwd_seq_major.stats_launches,
            "dispatch_count": dispatch_count.launches}


def _zero_launch_counts():
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels.dispatch_count import dispatch_count

    for fn in (kflash.flash_attention, kflash.flash_attention_bwd_seq_major, dispatch_count):
        fn.launches = 0
    kflash.flash_attention_bwd_seq_major.stats_launches = 0


def _profiled_step(fn):
    """``fn()`` (one train step) under ``torch.profiler``: its wall, the
    card's busy time (the union of its kernels, copies and memsets), the
    idle share, the six device operations that took longest, the names of
    every device operation and their count."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = busy_ms(prof)
    by: dict[str, float] = {}
    ops = device_ops(prof)
    for name, a, b in ops:
        by[name] = by.get(name, 0.0) + (b - a) / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall, "top": top,
            "names": sorted(by), "device_ops": len(ops)}


def assert_bwd_kernels(tag, prof, phase=19):
    """The profiled bf16 train step ran the backward's tensor-core kernels
    (D, dkdv, dq) and neither the stats pass nor the float32 kernels."""
    names = prof["names"]
    for want in ("flash_bwd_dsum", "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"):
        assert any(want in n for n in names), (tag, want, names)
    for never in ("flash_bwd_stats", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
        assert not any(never in n for n in names), (tag, never, names)
    ran = sorted({m for n in names for m in re.findall(r"flash_bwd_\w+?_kernel", n)})
    log(f"phase {phase} {tag}: the profiled step's backward kernels: {ran} (no flash_bwd_stats)")


def _log_profile(tag, prof, card):
    log(f"phase 19 {tag}: one profiled step: wall {prof['wall_ms']:.2f} ms (profiled), device "
        f"busy {prof['busy_ms']:.2f} ms, idle {100 * prof['idle']:.1f}%; card {card}")
    for name, ms in prof["top"]:
        log(f"phase 19 {tag}:   {ms:9.3f} ms {100 * ms / prof['busy_ms']:5.1f}%  {name[:90]}")


def _bwd_cost(b, g, p, sq, sk, hd, causal, window, dtype):
    """(bytes, FLOPs) of the attention backward: q, k, v, o, dO read once,
    dq, dk, dv written once; five products (S, dV, dP, dK, dQ) of 2 * hd
    FLOPs per visible (q, k) pair and head."""
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = b * (4 * g * p * sq * hd + 4 * g * sk * hd) * size
    return nbytes, 5 * 2 * hd * int(ok.sum()) * b * g * p


def bwd_errors(q, k, v, o, dout, mask, lse=None) -> dict:
    """Phase 19 (d)'s reading of the backward kernels on one input (the
    models' layout, one type; ``lse`` the forward's, or None for the stats
    pass): each gradient's error on its own scale (:func:`_bwd_error`)
    against the plain version on the float32 copies, the same gradient 5%
    off read the same way, the largest |ref| and |diff|, and whether two
    calls (the first with its outputs handed out dirty) give equal bits."""
    from repro_torch.kernels import flash_attention as kflash

    extra = {} if lse is None else {"lse": lse}
    with dirty_outputs():
        got = kflash.flash_attention_bwd_seq_major(q, k, v, o, dout, **mask, **extra)
    again = kflash.flash_attention_bwd_seq_major(q, k, v, o, dout, **mask, **extra)
    torch.cuda.synchronize()
    want = kflash.flash_attention_bwd_seq_major_plain(*(t.float() for t in (q, k, v, o, dout)),
                                                      **mask)
    out = {"errs": [], "controls": [], "scales": [], "abs_err": 0.0,
           "equal": all(torch.equal(a, a2) for a, a2 in zip(got, again))}
    for a, w in zip(got, want):
        out["abs_err"] = max(out["abs_err"], float((a.float() - w).abs().max()))
        out["errs"].append(_bwd_error(a, w))
        out["controls"].append(_bwd_error((a.float() * 1.05).to(a.dtype), w))
        out["scales"].append(float(w.abs().max()))
    return out


def _bwd_error(got, ref) -> float:
    """A gradient's error on its own scale: bf16 ``got``'s excess over its
    rounding, float32's |diff|, each over the largest |entry| of ``ref``.
    The captured dO of a mean loss over thousands of tokens is tiny, so a
    limit that takes max(1, |ref|) would bind on nothing."""
    scale = float(ref.abs().max())
    assert scale > 0, "a gradient of zeros checks nothing"
    if got.dtype == torch.bfloat16:
        return excess_over_bf16_rounding(got, ref) / scale
    return float((got - ref).abs().max()) / scale


def check_flash_backward(captured, card) -> dict:
    """Phase 19 (d): the backward kernels against ``flash_attention_bwd_plain``
    on layer 0's inputs of (a) and (b), bf16 (with the forward's lse, as
    training runs it, and without, by the stats pass) and float32, at Sq =
    1,000, with window 512, outputs handed out dirty; two calls bit-equal;
    the forward's lse against ``torch.logsumexp`` of the plain masked
    scores; times at the captured shapes.  Each gradient is held to its own
    largest entry (:func:`_bwd_error`), and the same check must refuse that
    gradient 5% off, so the limit is seen to bind."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash

    rows, lse_errs = {}, {}
    for name, (q, k, v, o, dout, lse, kw) in captured.items():
        b, sq, g, p, hd = q.shape
        variants = {"as trained": (q, k, v, o, lse, dout, kw)}
        cut = dict(kw)
        qc, kc, vc, dc = q[:, :1000], k[:, :1000], v[:, :1000], dout.reshape(q.shape)[:, :1000]
        variants["Sq = Sk = 1,000"] = (qc, kc, vc, None, None, dc, cut)
        variants["window 512"] = (q, k, v, None, None, dout, dict(kw, window=512))
        for vname, (vq, vk, vv, vo, vl, vd, vkw) in variants.items():
            for dtype in (torch.bfloat16, torch.float32):
                tq, tk, tv, td = (t.to(dtype).contiguous() for t in (vq, vk, vv, vd))
                mask = {key: vkw[key] for key in ("causal", "window", "q_offset")}
                bf = dtype == torch.bfloat16
                if vo is not None and dtype == vo.dtype:
                    to, tl = vo, vl
                elif bf:
                    to, tl = kflash.flash_attention_seq_major(tq, tk, tv, return_lse=True, **vkw)
                else:
                    to, tl = kflash.flash_attention_seq_major(tq, tk, tv, **vkw), None
                if bf:  # the forward's lse against the plain masked scores' logsumexp
                    ref = kflash.flash_lse_plain(
                        tq.float().permute(0, 2, 3, 1, 4).reshape(-1, p, tq.shape[1], hd),
                        tk.float().permute(0, 2, 1, 3).reshape(-1, tk.shape[1], hd), **mask)
                    lse_errs[(name, vname)] = float(
                        (tl - ref.reshape(tl.shape)).abs().max())
                    assert lse_errs[(name, vname)] <= LSE_ABS, (name, vname, lse_errs)
                limit = BWD_EXCESS if bf else BWD_F32_REL
                for mode, ml in ((("lse", tl), ("stats", None)) if bf else (("stats", None),)):
                    r = bwd_errors(tq, tk, tv, to, td, mask, ml)
                    assert r["equal"], (name, vname, dtype, mode)
                    for grad, e, c in zip(("dq", "dk", "dv"), r["errs"], r["controls"]):
                        assert e <= limit, (name, vname, dtype, mode, grad, e)
                        assert c > limit, (name, vname, dtype, mode, grad, c)
                    dt = str(dtype).split(".")[-1] + (f" {mode}" if bf else "")
                    rows[(name, vname, dt)] = {
                        "checked": max(r["errs"]), "max_abs_err": r["abs_err"],
                        "max_abs_ref": dict(zip(("dq", "dk", "dv"), r["scales"]))}
                    log(f"phase 19 (d): flash_attention_bwd [{name}, {vname}, {dt}] "
                        f"B={tq.shape[0]} G={g} P={p} Sq={tq.shape[1]} hd={hd} "
                        f"window={vkw['window']}: dq, dk, dv against the plain version, "
                        f"{'excess over bf16 rounding' if bf else 'max |diff|'} / max |ref| "
                        f"{[f'{x:.3g}' for x in r['errs']]} (<= {limit:g}; max |ref| "
                        f"{[f'{x:.3g}' for x in r['scales']]}; the same gradients 5% off read "
                        f"{[f'{x:.3g}' for x in r['controls']]}, refused); two calls "
                        f"bit-equal; outputs handed out dirty"
                        + (f"; the forward's lse within {lse_errs[(name, vname)]:.3g} of "
                           f"logsumexp (<= {LSE_ABS:g})" if bf and mode == "lse" else ""))
        del variants

    timing = {}
    for name, (q, k, v, o, dout, lse, kw) in captured.items():
        b, sq, g, p, hd = q.shape
        mask = {key: kw[key] for key in ("causal", "window", "q_offset")}
        fk = lambda: kflash.flash_attention_bwd_seq_major(q, k, v, o, dout, lse=lse, **mask)
        plain = lambda: kflash.flash_attention_bwd_seq_major_plain(q, k, v, o, dout, **mask)
        # SDPA's backward on the same inputs, the kv heads expanded to G * P
        qs = q.reshape(b, sq, g * p, hd).transpose(1, 2).detach().requires_grad_()
        ks = k.repeat_interleave(p, dim=2).transpose(1, 2).contiguous().requires_grad_()
        vs = v.repeat_interleave(p, dim=2).transpose(1, 2).contiguous().requires_grad_()
        so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        sd = dout.reshape(b, sq, g * p, hd).transpose(1, 2)
        sdpa = lambda: torch.autograd.grad(so, (qs, ks, vs), sd, retain_graph=True)
        k_ms, p_ms, l_ms = cuda_ms(fk), cuda_ms(plain, warmup=1, reps=5), cuda_ms(sdpa)
        k_dev, split, _ = own_device_time(fk, BWD_DEVICE_NAMES)
        assert "flash_bwd_stats" not in split, split
        l_dev = device_ms(sdpa)
        nbytes, flops = _bwd_cost(b, g, p, sq, sq, hd, mask["causal"], mask["window"],
                                  q.dtype)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.bfloat16]) * 1e3
        timing[name] = {
            "shape": f"B={b} G={g} P={p} Sq=Sk={sq} hd={hd} bf16 causal ({name} layer 0)",
            "ms": k_ms, "plain_ms": p_ms, "device_ms": k_dev, "device_split_ms": split,
            "bound_ms": bound, "bound_by": "operations" if flops / PEAK_FLOPS[torch.bfloat16]
            > nbytes / HBM_BYTES_PER_S else "bytes", "bytes": nbytes, "flops": flops,
            "library_ms": l_ms, "library_device_ms": l_dev,
            "splits": kflash.bwd_splits(b, g, p, sq, torch.cuda.get_device_properties(
                q.device).multi_processor_count)}
        log(f"phase 19 (d): flash_attention_bwd at {timing[name]['shape']}: events around one "
            f"call {k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA's backward {l_ms:.4f} ms; device "
            f"time: kernels {k_dev:.4f} ms ({split}; {timing[name]['splits']} head split(s); "
            f"{flops / k_dev / 1e9:.1f} TFLOP/s of the essential work, "
            f"{100 * bound / k_dev:.2f}% of the bound {bound:.4f} ms by "
            f"{timing[name]['bound_by']}: {flops:,} FLOP, {nbytes:,} bytes), "
            f"SDPA's backward {l_dev:.4f} ms (kernels / SDPA {k_dev / l_dev:.2f}); card {card}")
        del qs, ks, vs, so
    return {"errors": rows, "lse_errors": lse_errs, "timing": timing}


def adamw_ms(params, opt, opt_cfg) -> tuple[float, float, int]:
    """One ``apply_updates`` over every parameter (zero grads: the same
    passes), by CUDA events around the call, median of 3 after one
    warm-up: the optimizer's share of a train step.  Returns ``(ms,
    bound_ms, bytes)``: the bound reads g twice (the norm, the update)
    and p, m, v once, and writes p, m, v once, at the card's memory rate."""
    from repro_torch.train.optimizer import apply_updates, leaves, tree_map

    grads = tree_map(lambda p: torch.zeros_like(p, requires_grad=False), params)
    ms = cuda_ms(lambda: apply_updates(params, grads, opt, opt_cfg), warmup=1, reps=3)
    nbytes = sum(2 * (p.nbytes + g.nbytes + m.nbytes + v.nbytes)
                 for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt.m),
                                       leaves(opt.v)))
    del grads
    return ms, nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def train_phase(dev, card) -> dict:
    """Phase 19: training.  (a) gemma-2b at full width and depth, (b) Llama
    4 Scout at full width over 2 layers and 4 stacked EP shards with KIP
    re-placement at the step boundaries, (c) the smoke configs card
    against CPU, (d) the backward kernels against their plain version.
    Returns the ``kernels`` line's flash_attention_bwd row and the
    phase-19 entries of the flash and dispatch_count rows."""
    import repro_torch.models.model as model
    import repro_torch.models.transformer as transformer
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.data.generators import lm_token_stream
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models.modules import Policy
    from repro_torch.moe.kip_placement import PlacementController, apply_placement_in_place
    from repro_torch.train.optimizer import OptConfig, init_opt, leaves, tree_map
    from repro_torch.train.train_step import make_train_step, moe_state

    bf16 = torch.bfloat16
    captured: dict = {}
    orig_bwd = kflash.flash_attention_bwd_seq_major

    def capture_into(name):
        def bwd(q, k, v, o, dout, **kw):  # the last call of a step's backward is layer 0's
            lse = kw.get("lse")
            mask = {key: kw[key] for key in ("causal", "window", "q_offset")}
            captured[name] = (q.detach().clone(), k.detach().clone(), v.detach().clone(),
                              o.detach().clone(), dout.detach().clone(),
                              None if lse is None else lse.clone(),
                              dict(mask, p_bf16=False, q_chunk=256, kv_chunk=512,
                                   block_skip=True))
            return orig_bwd(q, k, v, o, dout, **kw)
        return bwd

    def run_steps(step, params, opt, batches, tag, per_step, inv_of=lambda: None,
                  after=lambda i, m: None):
        walls, metrics = [], []
        for i, batch in enumerate(batches):
            before = _launch_counts()
            if i == 0:  # the wrapper holds the launch counts while it stands in
                kflash.flash_attention_bwd_seq_major = capture_into(tag)
                kflash.flash_attention_bwd_seq_major.launches = orig_bwd.launches
                kflash.flash_attention_bwd_seq_major.stats_launches = orig_bwd.stats_launches
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, opt, m = step(params, opt, batch, inv_of())
                m = {k: v.cpu() for k, v in m.items()}  # the safe point's fetch
                walls.append((time.perf_counter() - t) * 1e3)
            finally:
                orig_bwd.launches = kflash.flash_attention_bwd_seq_major.launches
                orig_bwd.stats_launches = kflash.flash_attention_bwd_seq_major.stats_launches
                kflash.flash_attention_bwd_seq_major = orig_bwd
            now = _launch_counts()
            diff = {k: now[k] - before[k] for k in now}
            assert diff == per_step, (tag, i, diff, per_step)
            assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"])), m
            metrics.append(m)
            after(i, m)
        return params, opt, walls, metrics

    # ---- (a) gemma-2b, full width and depth -----------------------------
    cfg = get_config("gemma-2b")
    pol = Policy(param_dtype=bf16, compute_dtype=bf16)
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    opt_cfg = OptConfig()
    opt = init_opt(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(params))
    log(f"phase 19 (a): {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} q "
        f"heads over {cfg.num_kv_heads} kv head, head_dim {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}: {n_params:,} parameters bf16 ({n_params * 2 / 1e9:.2f} GB), AdamW "
        f"moments float32 ({n_params * 8 / 1e9:.2f} GB), made on the card in "
        f"{time.perf_counter() - t:.1f} s; batch {GEMMA_BATCH} x {TRAIN_SEQ} tokens from "
        f"lm_token_stream; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    step = make_train_step(cfg, pol, opt_cfg)
    batches = [_lm_batch(x, dev) for x in
               lm_token_stream(8, GEMMA_BATCH, TRAIN_SEQ + 1, cfg.vocab_size, seed=19)]
    per_step = {"flash_attention": cfg.num_layers, "flash_attention_bwd": cfg.num_layers,
                "flash_attention_bwd_stats": 0, "dispatch_count": 0}
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    params, opt, walls, ms = run_steps(step, params, opt, batches, "gemma-2b", per_step)
    gemma_launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = statistics.median(walls[1:])
    log(f"phase 19 (a): 8 steps through make_train_step: losses "
        f"{[round(float(m['loss']), 4) for m in ms]}, grad_norm "
        f"{[round(float(m['grad_norm']), 3) for m in ms]}; step walls (ms) "
        f"{[round(w, 1) for w in walls]}: median of steps 2-8 {wall:.1f} ms, "
        f"{GEMMA_BATCH * TRAIN_SEQ / wall * 1e3:,.0f} tokens/s; peak memory {peak:.2f} GB; "
        f"launches {gemma_launches} ({cfg.num_layers} flash forward and {cfg.num_layers} "
        f"backward a step, none through the stats pass); card {card}")
    prof = _profiled_step(lambda: step(params, opt, batches[1]))
    _log_profile("(a)", prof, card)
    assert_bwd_kernels("(a)", prof)
    opt_ms, opt_bound, opt_bytes = adamw_ms(params, opt, opt_cfg)
    log(f"phase 19 (a): AdamW alone (apply_updates over {n_params:,} parameters, float32 "
        f"moments): {opt_ms:.2f} ms of the {wall:.1f} ms step; its bound {opt_bound:.2f} ms "
        f"({opt_bytes:,} bytes: g read twice, p, m, v read and written once); card {card}")
    gemma_prof = dict(prof, wall_ms_unprofiled=wall, peak_gb=peak, adamw_ms=opt_ms,
                      adamw_bound_ms=opt_bound)
    del opt
    torch.cuda.empty_cache()
    over_cfg = OptConfig(lr=1e-3, warmup=1)
    opt = init_opt(params, over_cfg)
    over = make_train_step(cfg, pol, over_cfg)
    losses = []
    for _ in range(8):
        params, opt, m = over(params, opt, batches[0])
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    log(f"phase 19 (a): one batch repeated for 8 steps at OptConfig(lr=1e-3, warmup=1): losses "
        f"{[round(x, 4) for x in losses]} (the last below the first)")
    del params, opt, step, over, batches
    torch.cuda.empty_cache()

    # ---- (b) Llama 4 Scout, full width, 2 layers, 4 EP shards, KIP ---------
    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, num_layers=SCOUT_TRAIN_LAYERS)
    spec = cfg.moe
    pol = Policy(param_dtype=bf16, compute_dtype=bf16, ep_shards=EP_SHARDS,
                 exchange_backend="dense")
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    opt_cfg = OptConfig(moment_dtype=bf16)
    opt = init_opt(params, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(params))
    moe_layers = sum(blk.ffn == "moe" for blk in transformer.layers(cfg))
    log(f"phase 19 (b): {full.name}: {cfg.num_layers} of {full.num_layers} layers (cut in depth "
        f"only: 4 would not fit with the optimizer state on 80 GB), d {cfg.d_model}, "
        f"{cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads, head_dim {cfg.head_dim}, "
        f"{spec.num_experts} experts top-{spec.top_k} + shared (d_ff_expert "
        f"{spec.d_ff_expert}, capacity {spec.capacity_factor}), vocab {cfg.vocab_size}: "
        f"{n_params:,} parameters bf16, moments bf16 (OptConfig(moment_dtype=bfloat16)): "
        f"{n_params * 6 / 1e9:.2f} GB of state, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, made in {time.perf_counter() - t:.1f} s; {EP_SHARDS} stacked EP shards, "
        f"dense transport; batch {SCOUT_BATCH} x {TRAIN_SEQ}")
    step = make_train_step(cfg, pol, opt_cfg)
    batches = [_lm_batch(x, dev) for x in
               lm_token_stream(12, SCOUT_BATCH, TRAIN_SEQ + 1, cfg.vocab_size, seed=191)]
    ctl = PlacementController(spec.num_experts, EP_SHARDS)
    state = {"inv": torch.as_tensor(ctl.placement.inv_place, device=dev)}
    per_step = {"flash_attention": cfg.num_layers, "flash_attention_bwd": cfg.num_layers,
                "flash_attention_bwd_stats": 0, "dispatch_count": 2 * moe_layers}
    steps_log, moves = [], []

    def safe_point(i, m):
        counts = m["expert_counts"].numpy()
        want = SCOUT_BATCH * TRAIN_SEQ * spec.top_k * moe_layers
        assert counts.sum() == want, (counts.sum(), want)
        sl = ctl.shard_loads(counts.astype(np.float64))
        steps_log.append({"loss": float(m["loss"]), "overflow": float(m["overflow"]),
                          "imbalance": float(sl.max() / sl.mean())})
        ctl.observe(counts)
        changed, _, perm = ctl.maybe_update()
        if changed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply_placement_in_place(moe_state(params_ref["p"], params_ref["o"]), perm)
            torch.cuda.synchronize()
            moves.append({"after_step": i, "moved": int((perm != np.arange(len(perm))).sum()),
                          "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "planned": ctl.history[-1]["imbalance_planned"]})
            state["inv"] = torch.as_tensor(ctl.placement.inv_place, device=dev)

    params_ref = {"p": params, "o": opt}  # the same tensors, permuted in place
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    params, opt, walls, ms = run_steps(step, params, opt, batches, "Scout", per_step,
                                       inv_of=lambda: state["inv"], after=safe_point)
    scout_launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = statistics.median(walls[1:])
    log(f"phase 19 (b): 12 steps: step walls (ms) {[round(w, 1) for w in walls]}: median of "
        f"steps 2-12 {wall:.1f} ms, {SCOUT_BATCH * TRAIN_SEQ / wall * 1e3:,.0f} tokens/s; peak "
        f"memory {peak:.2f} GB; launches {scout_launches} ({cfg.num_layers} flash forward, "
        f"{cfg.num_layers} backward (none through the stats pass) and {2 * moe_layers} "
        f"dispatch_count a step); card {card}")
    log("phase 19 (b): per step (loss, dropped pairs, shard imbalance of its counts): " +
        "; ".join(f"{i}: {s['loss']:.4f}, {s['overflow']:g}, {s['imbalance']:.3f}"
                  for i, s in enumerate(steps_log)))
    taken, declined = ctl.decisions.counts()
    log(f"phase 19 (b): PlacementController(16, 4): {taken} taken, {declined} declined; "
        f"history {ctl.history}")
    for d in ctl.decisions.records:
        log(f"phase 19 (b):   tick {d.tick} {d.kind} taken={d.taken} imbalance "
            f"{d.imbalance:.4f}: {d.reason} {d.detail or ''}")
    for mv in moves:
        i = mv["after_step"]
        nxt = steps_log[i + 1]["imbalance"] if i + 1 < len(steps_log) else None
        log(f"phase 19 (b): Replace after step {i}: {mv['moved']} experts moved, wi / wo and "
            f"both moments of {moe_layers} layers permuted in {mv['wall_ms']:.2f} ms; shard "
            f"imbalance {steps_log[i]['imbalance']:.4f} before, planned {mv['planned']:.4f}, "
            + (f"{nxt:.4f} at the next step" if nxt is not None else "no step after it"))
    prof = _profiled_step(lambda: step(params, opt, batches[1], state["inv"]))
    _log_profile("(b)", prof, card)
    assert_bwd_kernels("(b)", prof)
    opt_ms, opt_bound, opt_bytes = adamw_ms(params, opt, opt_cfg)
    log(f"phase 19 (b): AdamW alone (apply_updates over {n_params:,} parameters, bf16 "
        f"moments): {opt_ms:.2f} ms of the {wall:.1f} ms step; its bound {opt_bound:.2f} ms "
        f"({opt_bytes:,} bytes: g read twice, p, m, v read and written once); card {card}")
    scout_prof = dict(prof, wall_ms_unprofiled=wall, peak_gb=peak, adamw_ms=opt_ms,
                      adamw_bound_ms=opt_bound)
    del params, opt, params_ref, step, batches
    torch.cuda.empty_cache()

    # ---- (c) the smoke configs, card against CPU ---------------------------
    for arch, shards in (("gemma-2b", 0), ("llama4-scout-17b-a16e", EP_SHARDS)):
        scfg = reduce_for_smoke(get_config(arch))
        spol = Policy(ep_shards=shards, exchange_backend="dense" if shards else None)
        sopt = OptConfig(lr=1e-3, warmup=1)
        cpu = model.init_params(scfg, 0, spol, device="cpu")
        card_p = tree_map(lambda x: x.to(dev, copy=True), cpu)
        runs = {"cpu": [cpu, init_opt(cpu, sopt)], "card": [card_p, init_opt(card_p, sopt)]}
        where = {"cpu": torch.device("cpu"), "card": dev}
        sstep = make_train_step(scfg, spol, sopt)
        rng = np.random.default_rng(19)
        toks = [rng.integers(0, scfg.vocab_size, (2, 65)) for _ in range(4)]
        worst = 0.0
        e = scfg.moe.num_experts if scfg.moe else 0
        inv = {d: None for d in runs}
        for i, tk in enumerate(toks):
            if i == 3 and e:  # a fixed re-placement on both devices first
                perm = np.arange(e, dtype=np.int32)[::-1].copy()
                for d, (p, o) in runs.items():
                    apply_placement_in_place(moe_state(p, o), perm)
                    inv[d] = torch.as_tensor(np.argsort(perm).astype(np.int32), device=where[d])
            elif i == 3:
                break
            out = {}
            for d, (p, o) in runs.items():
                p, o, m = sstep(p, o, _lm_batch(tk, where[d]), inv[d])
                runs[d] = [p, o]
                out[d] = {k: v.cpu() for k, v in m.items()}
            assert float(out["card"]["overflow"]) == float(out["cpu"]["overflow"]), out
            if e:
                assert torch.equal(out["card"]["expert_counts"], out["cpu"]["expert_counts"])
            for key in ("loss", "grad_norm"):
                a, b = float(out["card"][key]), float(out["cpu"][key])
                assert abs(a - b) <= 1e-4 * abs(b), (arch, i, key, a, b)
                worst = max(worst, abs(a - b) / abs(b))
        log(f"phase 19 (c): {scfg.name} float32{f' at {shards} EP shards' if shards else ''}: 3 "
            f"train steps on the card and the CPU: overflow and expert counts equal, loss and "
            f"grad_norm within {worst:.3g} relative (<= 1e-4)"
            + ("; after a fixed re-placement (experts reversed, weights and moments) one more "
               "step: counts equal" if e else ""))
        del runs, cpu, card_p

    # ---- (d) the backward kernels against their plain version ----------------
    checked = check_flash_backward(captured, card)
    del captured
    torch.cuda.empty_cache()
    log(f"phase 19: gemma-2b {gemma_prof['wall_ms_unprofiled']:.1f} ms a step (AdamW "
        f"{gemma_prof['adamw_ms']:.1f}, peak {gemma_prof['peak_gb']:.2f} GB, idle "
        f"{100 * gemma_prof['idle']:.1f}%), Scout 2 layers "
        f"{scout_prof['wall_ms_unprofiled']:.1f} ms a step (AdamW {scout_prof['adamw_ms']:.1f}, "
        f"peak {scout_prof['peak_gb']:.2f} GB, idle {100 * scout_prof['idle']:.1f}%); card "
        f"{card}")
    tm = checked["timing"]["gemma-2b"]
    launches = {"gemma-2b": gemma_launches, "Scout": scout_launches}
    from repro_torch.kernels import build

    ptxas = build.ptxas_report("flash_attention_bwd")
    log(f"phase 19 (d): ptxas, csrc/flash_attention_bwd.cu: " + "; ".join(
        f"{k} {v.get('registers')} registers, spills {v.get('spill_stores')} / "
        f"{v.get('spill_loads')} bytes" for k, v in ptxas.items() if k != "warnings")
        + f"; serialised wgmma: {ptxas['warnings'] or 'none'}")
    row = {"name": "flash_attention_bwd", "route": "cuda", "source": FLASH_BWD_SOURCE,
           "replaces": "src/repro/kernels/flash_attention.py:73 (the gradient of "
                       "flash_attention_tpu; no Pallas backward exists: the reference "
                       "differentiates its jnp flash, src/repro/models/attention.py:154)",
           "launches": gemma_launches["flash_attention_bwd"] + scout_launches["flash_attention_bwd"],
           "launches_phase_19": {k: v["flash_attention_bwd"] for k, v in launches.items()},
           "stats_launches_phase_19": {k: v["flash_attention_bwd_stats"]
                                       for k, v in launches.items()},
           "max_abs_err": max(e["max_abs_err"] for e in checked["errors"].values()),
           "errors": {" / ".join(k): v for k, v in checked["errors"].items()},
           **{k: tm[k] for k in ("ms", "plain_ms", "device_ms", "device_split_ms",
                                 "bound_ms", "bound_by", "bytes", "flops",
                                 "library_ms", "library_device_ms", "shape")},
           "lse_max_abs_err": max(checked["lse_errors"].values()),
           "ptxas": ptxas,
           "library": "scaled_dot_product_attention backward, k/v expanded to the q heads",
           "phase_19": checked["timing"]}
    return {"row": row,
            "flash_attention": {"launches_phase_19": {k: v["flash_attention"]
                                                      for k, v in launches.items()}},
            "dispatch_count": {"launches_phase_19": {k: v["dispatch_count"]
                                                     for k, v in launches.items()}}}


# phase 20: the paper's partitioner comparison (benchmarks/bench_partitioners.py,
# bench_migration.py, bench_webcrawl.py), every table routed by partition_apply
FIG2_PARTS = (4, 8, 16, 32, 64)
FIG2_METHODS = ("hash", "readj", "redist", "scan", "mixed", "kip", "kip_tight")
FIG3_PARTS, FIG3_WORKERS, FIG3_BATCHES, FIG3_BATCH = 20, 4, 20, 1_048_576
FIG3_METHODS = ("hash", "scan", "readj", "kip")
CRAWL_PARTS = 24  # bench_webcrawl.py: 3 partitions a worker, 8 workers
SEARCH_ROWS = 1_536  # above the probe's 1,024 rows (csrc/route_common.cuh, kMaxProbeRows)


def fig2_partitioner(method, hist, n, lam=2.0):
    """bench_partitioners.py's ``_build``: a method's table from UHP on the
    top ``lam * n`` keys."""
    from repro_torch.core.baselines import make_baseline
    from repro_torch.core.partitioner import kip_update, uniform_partitioner

    if method in ("kip", "kip_tight"):
        return kip_update(uniform_partitioner(n), hist.top(int(lam * n)),
                          tight=method == "kip_tight")
    update, prev = make_baseline(method, n)
    return update(prev, hist.top(int(lam * n)), n)


class RouteCheck:
    """Routes a key buffer on the card under a partitioner (``replay_partition``:
    one ``partition_apply`` launch) and holds the ids to the host's
    ``lookup_np`` and the card's ``torch.bincount`` loads to ``np.bincount``'s,
    both by equality.  Sums the walls of the two sides."""

    def __init__(self):
        self.card_s = self.host_s = 0.0
        self.tables = 0

    def __call__(self, part, dkeys, keys, tag) -> np.ndarray:
        from repro_torch.core.replay import replay_partition

        t = time.perf_counter()
        ids = replay_partition(part, dkeys)
        loads = torch.bincount(ids, minlength=part.num_partitions).cpu().numpy()
        got = ids.cpu().numpy()
        t1 = time.perf_counter()
        want = part.lookup_np(keys)
        want_loads = np.bincount(want, minlength=part.num_partitions)
        self.card_s += t1 - t
        self.host_s += time.perf_counter() - t1
        self.tables += 1
        assert ids.device == dkeys.device and ids.dtype == torch.int32, tag
        assert np.array_equal(got, want), tag
        assert np.array_equal(loads, want_loads), tag
        return loads


def imbalance_of(loads) -> float:
    """``load_imbalance``'s max / mean, on integer loads."""
    loads = np.asarray(loads, np.int64)
    return float(loads.max() / max(loads.mean(), 1e-12))


def partition_apply_call(part, dkeys):
    """``(call, bound_ms, rows)``: one ``partition_apply`` launch on
    ``part``'s tables, padded as ``ops.apply_partitioner`` pads them; the
    bound (keys read, ids written, tables read, over the memory rate); the
    heavy rows the kernel is given."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.partition_apply import partition_apply

    tabs = part.tables(dkeys.device)
    hk, hp, _ = ops.pad_heavy_tables(tabs, num_partitions=0, pad_empty=False)

    def call():
        return partition_apply(dkeys, hk, hp, tabs.host_to_part, seed=part.seed,
                               num_hosts=part.num_hosts)

    nbytes = dkeys.numel() * (4 + 4) + (hk.numel() + hp.numel() + tabs.host_to_part.numel()) * 4
    return call, nbytes / HBM_BYTES_PER_S * 1e3, hk.numel()


def baselines_phase(dev, card) -> dict:
    """Phase 20: the paper's baselines beside KIP, every table routed on the
    card by ``partition_apply``.  Returns what the ``partition_apply`` row
    gains: the phase's launches and its calls' times."""
    from repro_torch.core.baselines import make_baseline, redist_update
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.histogram import Histogram
    from repro_torch.core.migration import migration_capacity, plan_migration
    from repro_torch.core.partitioner import kip_update, uniform_partitioner
    from repro_torch.core.replay import BatchJob
    from repro_torch.data.generators import drifting_zipf, host_skew_keys, zipf_keys
    from repro_torch.kernels import build
    from repro_torch.kernels.partition_apply import partition_apply

    t_phase = time.perf_counter()
    route = RouteCheck()
    lib = build.library()
    partition_apply.launches = 0

    # ---- (a) Fig. 2 at phase 6's size -----------------------------------
    t = time.perf_counter()
    keys = zipf_keys(BATCH_RECORDS, num_keys=BATCH_KEYS, exponent=1.0, seed=0)
    hist = Histogram.exact(keys)
    dkeys = torch.as_tensor(keys.astype(np.int32), device=dev)
    f1 = float(hist.freqs[0])
    log(f"phase 20 (a): zipf_keys({BATCH_RECORDS:,}, num_keys={BATCH_KEYS:,}, exponent=1.0, "
        f"seed=0) and its exact histogram ({len(hist):,} keys, f1 {f1:.6f}) in "
        f"{time.perf_counter() - t:.1f} s")
    imb, tables = {}, {}
    for n in FIG2_PARTS:
        for m in FIG2_METHODS:
            tables[m, n] = fig2_partitioner(m, hist, n)
            imb[m, n] = imbalance_of(route(tables[m, n], dkeys, keys, ("fig 2", m, n)))
    # ---- (d) the search branch: a table above the probe's rows ----------
    big = redist_update(uniform_partitioner(64), hist.top(SEARCH_ROWS), 64)
    big_imb = imbalance_of(route(big, dkeys, keys, "search"))
    path = partition_apply.launches
    assert path == len(FIG2_PARTS) * len(FIG2_METHODS) + 1, path
    log(f"phase 20 (a), (d): {route.tables} tables routed and checked: card (route, loads, "
        f"copies back) {route.card_s:.1f} s, the host twin {route.host_s:.1f} s")

    timed = {}
    for n in FIG2_PARTS:
        for m in FIG2_METHODS:
            call, bound, rows = partition_apply_call(tables[m, n], dkeys)
            assert rows == 0 or lib.rk_probe_slots(rows) > 0, (m, n, rows)  # the probe
            tm = timed[f"{m} N={n}"] = {"ms": cuda_ms(call), "bound_ms": bound, "rows": rows}
            if m in ("hash", "kip"):  # the empty table, and the probe as N grows
                tm["device_ms"] = own_device_time(call, DEVICE_NAMES["partition_apply"])[0]
            log(f"phase 20 (a): {m} N={n}: imbalance {imb[m, n]:.6f} (floor max(1, N * f1) "
                f"{max(1.0, n * f1):.6f}); {tables[m, n].num_heavy} heavy keys; "
                f"partition_apply {tm['ms']:.4f} ms by events around one call"
                + (f", device {tm['device_ms']:.4f} ms" if "device_ms" in tm else "")
                + f" (bound {bound:.4f} ms)")
        best = min(imb[m, n] for m in FIG2_METHODS if not m.startswith("kip"))
        log(f"phase 20 (a): N={n}: kip {imb['kip', n]:.6f} <= best baseline {best:.6f} + 0.05: "
            f"{imb['kip', n] <= best + 0.05}{'' if n <= 32 else ' (the bench asks it for N <= 32)'}"
            f"; kip_tight {imb['kip_tight', n]:.6f} <= kip + 0.02: "
            f"{imb['kip_tight', n] <= imb['kip', n] + 0.02}")
    cost = {}
    for m in ("kip", "readj", "redist", "scan", "mixed"):
        best = float("inf")
        for _ in range(3):  # benchmarks/common.py's timer: the best of 3
            t = time.perf_counter()
            fig2_partitioner(m, hist.top(64), 32)
            best = min(best, time.perf_counter() - t)
        cost[m] = best * 1e6
    log("phase 20 (a): host update on hist.top(64) at N=32 (best of 3): "
        + ", ".join(f"{m} {us:.1f} us" for m, us in cost.items()))
    # the search against the probe on the same stream at N=64 (Redist's 128 rows)
    for name, part in (("search", big), ("redist N=64", tables["redist", 64])):
        call, bound, rows = partition_apply_call(part, dkeys)
        timed.setdefault(name, {"ms": cuda_ms(call), "bound_ms": bound, "rows": rows})
        timed[name]["device_ms"] = own_device_time(call, DEVICE_NAMES["partition_apply"])[0]
    tm = timed["search"]
    assert tm["rows"] == SEARCH_ROWS and lib.rk_probe_slots(SEARCH_ROWS) == 0
    log(f"phase 20 (d): redist_update on hist.top({SEARCH_ROWS}) at N=64: {big.num_heavy} heavy "
        f"rows, the binary search (probe slots 0): card ids == lookup_np, loads equal; "
        f"imbalance {big_imb:.6f}; partition_apply {tm['ms']:.4f} ms by events around one call, "
        f"device {tm['device_ms']:.4f} ms (bound {tm['bound_ms']:.4f} ms); Redist's 128-row "
        f"table at N=64, the probe: device {timed['redist N=64']['device_ms']:.4f} ms")
    partition_apply.launches = path
    del dkeys, keys, hist, tables, big

    # ---- (b) Fig. 3: drift, migration, the exchange lanes ---------------
    t = time.perf_counter()
    batches = list(drifting_zipf(FIG3_BATCHES, FIG3_BATCH, num_keys=100_000, exponent=1.0,
                                 drift_every=4, drift_fraction=0.3, seed=0))
    hists, windows, window = [], [], []
    for batch in batches:
        hists.append(Histogram.exact(batch).top(2 * FIG3_PARTS))
        window = (window + [batch])[-5:]  # the state: a sliding window of 5 batches
        live, counts = np.unique(np.concatenate(window), return_counts=True)
        windows.append((live, counts.astype(np.float64)))
    log(f"phase 20 (b): drifting_zipf({FIG3_BATCHES}, {FIG3_BATCH:,}, num_keys=100,000, "
        f"drift_every=4, drift_fraction=0.3), histograms and windows in "
        f"{time.perf_counter() - t:.1f} s")
    dbatches = [torch.as_tensor(batch.astype(np.int32), device=dev) for batch in batches]
    drift = {}
    for m in FIG3_METHODS:
        if m == "kip":
            part = uniform_partitioner(FIG3_PARTS)
            update = lambda prev, h, n=FIG3_PARTS: kip_update(prev, h.top(2 * FIG3_PARTS))
        else:
            update, part = make_baseline(m, FIG3_PARTS)
        imbs, migs, lanes = [], [], []
        for b, batch in enumerate(batches):
            new = update(part, hists[b], FIG3_PARTS)
            live, counts = windows[b]
            plan = plan_migration(part, new, live, counts)
            migs.append(plan.relative_migration)
            lanes.append(migration_capacity(plan, num_workers=FIG3_WORKERS) / max(len(live), 1))
            part = new
            imbs.append(imbalance_of(route(part, dbatches[b], batch, ("fig 3", m, b))))
        drift[m] = tuple(float(np.mean(x[1:])) for x in (imbs, migs, lanes))
        log(f"phase 20 (b): {m}: mean imbalance {drift[m][0]:.6f}, mean relative migration "
            f"{drift[m][1]:.6f}, migration lane fraction {drift[m][2]:.6f} (batches 1-"
            f"{FIG3_BATCHES - 1}); heavy keys at the end {part.num_heavy}")
    log(f"phase 20 (b): KIP's imbalance improvement over hash / scan / readj "
        + " / ".join(f"{1 - drift['kip'][0] / drift[m][0]:.4f}" for m in ("hash", "scan", "readj"))
        + f" (paper: 41% / 29% / 26%); readj's migration over KIP's "
        f"{drift['readj'][1] / max(drift['kip'][1], 1e-9):.4f} (paper: about 4x)")
    del batches, dbatches, hists, windows, window

    # ---- (c) the §6 web crawl through the batch path ---------------------
    t = time.perf_counter()
    keys = host_skew_keys(BATCH_RECORDS, num_hosts=960, giants=16, giant_mass=0.5, seed=49)
    log(f"phase 20 (c): host_skew_keys({BATCH_RECORDS:,}, num_hosts=960, giants=16, "
        f"giant_mass=0.5, seed=49) in {time.perf_counter() - t:.1f} s")
    dr = DRConfig(mode="batch", eps=0.003)
    job = BatchJob(CRAWL_PARTS, dr=dr, device=dev)
    t = time.perf_counter()
    got = job.run(keys)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    assert_same_batch_result(got, BatchJob(CRAWL_PARTS, dr=dr, device="cpu").run(keys), keys,
                             dev, "web crawl")
    log(f"phase 20 (c): BatchJob({CRAWL_PARTS}, eps=0.003): imbalance {got.imbalance_before:.6f} "
        f"-> {got.imbalance_after:.6f}, replayed {got.replayed_records:,}; every BatchResult "
        f"field == the CPU job's; run wall {wall:.3f} s")
    cut = max(1, int(job.sample_fraction * len(keys)))
    prefix = Histogram.exact(keys[:cut]).top(int(dr.lam * CRAWL_PARTS))
    dkeys = torch.as_tensor(keys.astype(np.int32), device=dev)
    for m in ("readj", "redist", "scan", "mixed"):
        update, prev = make_baseline(m, CRAWL_PARTS)
        after = imbalance_of(route(update(prev, prefix, CRAWL_PARTS), dkeys, keys,
                                   ("web crawl", m)))
        log(f"phase 20 (c): {m} on the job's prefix histogram (top {len(prefix)}): imbalance "
            f"{got.imbalance_before:.6f} -> {after:.6f}")
    del keys, dkeys, job, got

    launches = partition_apply.launches
    want = len(FIG2_PARTS) * len(FIG2_METHODS) + 1 + len(FIG3_METHODS) * FIG3_BATCHES + 2 + 4
    assert launches == want, (launches, want)
    log(f"phase 20: partition_apply launches {launches}; {route.tables} tables routed: card "
        f"(route, loads, copies back) {route.card_s:.1f} s, the host twin (lookup_np, "
        f"np.bincount) {route.host_s:.1f} s; {time.perf_counter() - t_phase:.1f} s in all; "
        f"card {card}")
    return {"launches_phase_20": launches, "phase_20": timed}



# phase 21: activation checkpointing and the xLSTM family
XLSTM_PROMPTS = (256, 512, 1024, 2048)   # multiples of 256: the mLSTM's chunk contract
XLSTM_REQUESTS, XLSTM_NEW, XLSTM_REPLICAS, XLSTM_SLOTS = 16, 16, 4, 4
XLSTM_BATCH = 4
# cut from 8 steps, and the one-batch check from 4 x 1,024 tokens: the
# sLSTM's per-time-step loop takes 6-10 s a step at 1,024 time steps
# (PERF.md §5), which would put the script past its 1,200 s
XLSTM_STEPS, XLSTM_OVERFIT_SEQ = 3, 256
XLSTM_TRAIN_LAYERS = 6   # (b) trains 6 of the 12 layers: the whole run's time limit
TEACHER_TOL = 2e-3       # the reference's teacher-forced limit (tests/test_models_smoke.py)
CARD_CPU_TOL = 1e-4      # smoke config, float32: x max(1, |cpu|)


def _teacher_forced(model, params, cfg, pol, dev, rng, prefix, total, extra=None) -> float:
    """Largest excess over ``TEACHER_TOL * (1 + |full|)`` of the logits of
    ``prefix`` prompt tokens prefilled then ``total - prefix`` decoded
    teacher-forced, against the ``total``-token prefill's last logits;
    ``extra`` joins both prefills' batches (an enc-dec model's frames)."""
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, total)), device=dev)
    extra = extra or {}
    full, _ = model.prefill(params, {"tokens": toks, **extra}, cfg, pol, max_len=total)
    logits, cache = model.prefill(params, {"tokens": toks[:, :prefix], **extra}, cfg, pol,
                                  max_len=total)
    for t in range(prefix, total):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], cfg, pol)
    a, b = logits[..., :cfg.vocab_size].double(), full[..., :cfg.vocab_size].double()
    excess = float(((a - b).abs() - TEACHER_TOL * (1 + b.abs())).max())
    assert bool(torch.isfinite(a).all()) and excess <= TEACHER_TOL, (prefix, total, excess)
    return float((a - b).abs().max())


def smoke_card_against_cpu(dev, scfg, rng, prompt, seq, phase, spol=None) -> None:
    """Phases 21 (c), 22 (c), 23 (c) and 24 (e): the float32 smoke config
    ``scfg`` under ``spol`` (default ``Policy()``), its parameters made on
    the CPU and copied to the card: a ``prompt``-token prefill of 2 rows
    and 4 decode steps, logits within ``CARD_CPU_TOL`` x max(1, |cpu|); 3
    train steps of 2 x ``seq`` tokens, loss and grad norm within
    ``CARD_CPU_TOL`` relative.  An enc-dec config's batches carry frame
    embeddings from ``rng`` too, a vision config's patch embeddings."""
    import repro_torch.models.model as model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import OptConfig, init_opt, tree_map
    from repro_torch.train.train_step import make_train_step

    spol = spol or Policy()
    cpu = model.init_params(scfg, 0, spol, device="cpu")
    card_p = tree_map(lambda v: v.to(dev, copy=True), cpu)
    where = {"cpu": torch.device("cpu"), "card": dev}
    sides = {"cpu": cpu, "card": card_p}

    def frames():
        return rng.standard_normal((2, scfg.enc_len, scfg.d_model)).astype(np.float32)

    def extras():
        out = {"enc_embeds": frames()} if scfg.encdec else {}
        if scfg.vision_tokens:
            out["vision_embeds"] = rng.standard_normal(
                (2, scfg.vision_tokens, scfg.d_model)).astype(np.float32)
        return out

    def on(side, batch):
        return {k: torch.as_tensor(v, device=where[side]) for k, v in batch.items()}

    first = {"tokens": rng.integers(0, scfg.vocab_size, (2, prompt)), **extras()}
    caches, logits = {}, {"cpu": [], "card": []}
    for side, p in sides.items():
        lg, caches[side] = model.prefill(p, on(side, first), scfg, spol, max_len=prompt + 8)
        logits[side].append(lg.cpu())
    for _ in range(4):
        nxt = rng.integers(0, scfg.vocab_size, (2, 1))
        for side, p in sides.items():
            lg, caches[side] = model.decode_step(
                p, caches[side], torch.as_tensor(nxt, device=where[side]), scfg, spol)
            logits[side].append(lg.cpu())
    worst = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                for a, b in zip(logits["card"], logits["cpu"]))
    assert worst <= CARD_CPU_TOL, worst
    sopt = OptConfig(lr=1e-3, warmup=1)
    runs = {"cpu": [cpu, init_opt(cpu, sopt)], "card": [card_p, init_opt(card_p, sopt)]}
    sstep = make_train_step(scfg, spol, sopt)
    train_worst = 0.0
    for i in range(3):
        tk = rng.integers(0, scfg.vocab_size, (2, seq + 1))
        extra = extras()
        out = {}
        for side, (p, o) in runs.items():
            p, o, m = sstep(p, o, {**_lm_batch(tk, where[side]), **on(side, extra)})
            runs[side] = [p, o]
            out[side] = {k: v.cpu() for k, v in m.items()}
        for key in ("loss", "grad_norm"):
            a, b = float(out["card"][key]), float(out["cpu"][key])
            assert abs(a - b) <= CARD_CPU_TOL * abs(b), (i, key, a, b)
            train_worst = max(train_worst, abs(a - b) / abs(b))
    log(f"phase {phase}: {scfg.name} float32{' with patches' if scfg.vision_tokens else ''}"
        + (f" at {spol.ep_shards} stacked EP shards" if spol.ep_shards else "") + ": "
        f"prefill and 4 decode steps, logits within "
        f"{worst:.3g} x max(1, |cpu|) (<= {CARD_CPU_TOL}); 3 train steps, loss and grad_norm "
        f"within {train_worst:.3g} relative (<= {CARD_CPU_TOL})")


def _remat_runs(dev, cfg, base: dict, variants: dict, opt_cfg, batches, tag, card,
                phase=21) -> dict:
    """Train ``len(batches)`` steps from one state under each policy of
    ``variants`` (name -> extra ``Policy`` fields; the first is the
    reference run): the parameters are made once, kept as a host copy and
    copied back before each run, the moments made afresh.  Every run's
    metrics and final parameters must equal the first run's bit for bit
    (or, where a library call is not deterministic, within 1e-6 of each
    tensor's largest entry, its largest difference logged).  Returns each
    run's walls, peak memory and launches a step."""
    import repro_torch.models.model as model
    from repro_torch.models.modules import Policy
    from repro_torch.train.optimizer import init_opt, leaves
    from repro_torch.train.train_step import make_train_step

    params = model.init_params(cfg, 0, Policy(**base), device=dev)
    start = [t.detach().to("cpu", copy=True) for t in leaves(params)]
    out, first = {}, None
    for name, extra in variants.items():
        with torch.no_grad():
            for t, h in zip(leaves(params), start):
                t.copy_(h)
        opt = init_opt(params, opt_cfg)
        step = make_train_step(cfg, Policy(**base, **extra), opt_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        walls, metrics = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            m = {k: v.cpu() for k, v in m.items()}
            walls.append((time.perf_counter() - t) * 1e3)
            assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"])), m
            metrics.append(m)
        launches = {k: v / len(batches) for k, v in _launch_counts().items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        del opt, step
        final = [t.detach().to("cpu", copy=True) for t in leaves(params)]
        run = {"walls_ms": walls, "peak_gb": peak, "launches_a_step": launches,
               "losses": [float(m["loss"]) for m in metrics],
               "grad_norms": [float(m["grad_norm"]) for m in metrics]}
        if first is None:
            first = (metrics, final)
        else:
            for a, b in zip(metrics, first[0]):
                assert sorted(a) == sorted(b), (tag, name)
                for k in a:
                    assert torch.equal(a[k], b[k]), (tag, name, k, a[k], b[k])
            worst, unequal = 0.0, 0
            for a, b in zip(final, first[1]):
                if not torch.equal(a, b):
                    unequal += 1
                    diff = float((a.float() - b.float()).abs().max())
                    worst = max(worst, diff / max(float(b.float().abs().max()), 1e-30))
            assert worst <= 1e-6, (tag, name, unequal, worst)
            run["unequal_tensors"], run["largest_rel_diff"] = unequal, worst
        out[name] = run
        log(f"phase {phase} ({tag}): {name}: {len(batches)} steps: losses {run['losses']}, grad_norm "
            f"{run['grad_norms']}; step walls (ms) {[round(w, 1) for w in walls]}; peak memory "
            f"{peak:.2f} GB; launches a step {launches}"
            + ("" if name == next(iter(variants)) else
               f"; metrics equal bit for bit to the first run's, final parameters: "
               f"{run['unequal_tensors']} of {len(final)} tensors differ (largest difference "
               f"{run['largest_rel_diff']:.3g} of the tensor's largest entry)")
            + f"; card {card}")
        del final
    del params, start
    torch.cuda.empty_cache()
    return out


def xlstm_phase(dev, card) -> dict:
    """Phase 21: the xLSTM family and activation checkpointing.  (a)
    xlstm-125m served at full width and depth, (b) trained at 6 of its 12
    layers, (c) its smoke
    config card against CPU, (d) remat on gemma-2b at full width and depth,
    (e) remat on Scout at 2 of 48 layers over 4 stacked EP shards.  Returns
    the phase-21 entries of the flash, flash-backward and dispatch_count
    rows."""
    import repro_torch.models.model as model
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.data.generators import lm_token_stream
    from repro_torch.models import xlstm
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import DRScheduler
    from repro_torch.train.optimizer import OptConfig, init_opt, leaves
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    cfg = get_config("xlstm-125m")
    pol = Policy(param_dtype=bf16, compute_dtype=bf16)

    # ---- (a) serving at full width and depth ------------------------------
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(params))
    log(f"phase 21 (a): {cfg.name}: {cfg.num_layers} layers alternating mLSTM / sLSTM, d "
        f"{cfg.d_model}, {cfg.num_heads} heads (mLSTM head dim {2 * cfg.d_model // cfg.num_heads}, "
        f"sLSTM {cfg.d_model // cfg.num_heads}), vocab {cfg.vocab_size}: {n_params:,} parameters "
        f"bf16 (the config's own count {cfg.param_count():,}), float32 recurrent state; made on "
        f"the card in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(21)
    sessions = np.where(rng.random(XLSTM_REQUESTS) < 0.3, 7,
                        rng.integers(0, 1000, XLSTM_REQUESTS))
    lens = rng.choice(XLSTM_PROMPTS, XLSTM_REQUESTS)
    sched = DRScheduler(XLSTM_REPLICAS)
    engines = [ServeEngine(cfg, params, pol, slots=XLSTM_SLOTS, max_len=2064, device=dev)
               for _ in range(XLSTM_REPLICAS)]
    queues: list[list] = [[] for _ in range(XLSTM_REPLICAS)]
    for i in range(XLSTM_REQUESTS):
        req = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32),
                      max_new_tokens=XLSTM_NEW, session_key=int(sessions[i]))
        queues[sched.route(req.session_key, cost_tokens=XLSTM_NEW)].append(req)
    rec = _timed_serving(model, engines, queues, "21 (a)")
    serve_s = rec["serve_s"]
    reqs = [r for q in queues for r in q]
    assert len(reqs) == XLSTM_REQUESTS
    for r in reqs:
        assert len(r.out_tokens) == XLSTM_NEW and r.done, (r.rid, r.out_tokens)
        assert all(0 <= x < cfg.vocab_size for x in r.out_tokens), (r.rid, r.out_tokens)
    calls = rec["prefill"] + rec["decode"]
    assert calls and all(c["finite"] for c in calls), "non-finite logits"
    tokens = sum(len(r.out_tokens) for r in reqs)
    by_len: dict[int, list] = {}
    for c in rec["prefill"]:
        by_len.setdefault(c["len"], []).append(c["wall"])
    prefill_ms = statistics.median(c["wall"] for c in rec["prefill"]) * 1e3
    decode_ms = statistics.median(c["wall"] for c in rec["decode"]) * 1e3
    log(f"phase 21 (a): DRScheduler({XLSTM_REPLICAS}) x ServeEngine({XLSTM_SLOTS} slots): "
        f"{XLSTM_REQUESTS} requests served, prompts {sorted(lens.tolist())} tokens, "
        f"{XLSTM_NEW} new each: {tokens} tokens in {serve_s:.2f} s ({tokens / serve_s:.1f} "
        f"tokens/s); prefill wall a request median {prefill_ms:.2f} ms (by length: "
        + ", ".join(f"{n}: {statistics.median(w) * 1e3:.1f}" for n, w in sorted(by_len.items()))
        + f" ms), decode wall a token median {decode_ms:.2f} ms; routed {sched.routed}, "
        f"imbalance {sched.imbalance():.2f}; card {card}")
    bad = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 300)), device=dev)
    try:
        model.prefill(params, {"tokens": bad}, cfg, pol, max_len=304)
    except ValueError as e:
        log(f"phase 21 (a): a 300-token prompt: model.prefill raised ValueError ({e})")
    else:
        raise AssertionError("a 300-token prompt was prefilled: the chunk contract is gone")
    t = time.perf_counter()
    prof = profile_serving(model, params, cfg, pol, rng, dev, 1040, phase="21 (a)", reps=1)
    dec = prof["8 decode steps after it"]
    log(f"phase 21 (a): {prof['prefill of 1024 tokens']['device_ops']:,} device operations a "
        f"1,024-token prefill, {dec['device_ops'] / 8:,.0f} a decoded token; idle "
        f"{100 * prof['prefill of 1024 tokens']['idle']:.1f}% / {100 * dec['idle']:.1f}%; the "
        f"profile took {time.perf_counter() - t:.1f} s")
    del engines, queues, reqs
    # teacher-forced at full width in float32: 255 + 1 against 256 (the
    # reference's check), and 256 + 256 decoded against a 512-token prefill
    # (two chunks carried); a 511-token prefill is refused by the contract
    t = time.perf_counter()
    f32 = Policy()
    p32 = model.init_params(cfg, 0, f32, device=dev)
    tf = {(p, n): _teacher_forced(model, p32, cfg, f32, dev, rng, p, n)
          for p, n in ((255, 256), (256, 512))}
    log(f"phase 21 (a): teacher-forced, float32 at full width: " + "; ".join(
        f"{p} prefilled + {n - p} decoded against {n} prefilled: largest logit difference "
        f"{d:.3g} (limit {TEACHER_TOL} x (1 + |logit|))" for (p, n), d in tf.items())
        + f"; {time.perf_counter() - t:.1f} s")
    log(f"phase 21 (a): {time.perf_counter() - t_phase:.1f} s so far")
    del p32, params
    torch.cuda.empty_cache()

    # ---- (b) training at full width, half depth ---------------------------
    tcfg = dataclasses.replace(cfg, num_layers=XLSTM_TRAIN_LAYERS)
    params = model.init_params(tcfg, 0, pol, device=dev)
    opt_cfg = OptConfig()
    opt = init_opt(params, opt_cfg)
    step = make_train_step(tcfg, pol, opt_cfg)
    batches = [_lm_batch(x, dev) for x in lm_token_stream(
        XLSTM_STEPS, XLSTM_BATCH, TRAIN_SEQ + 1, cfg.vocab_size, seed=21)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        m = {k: v.cpu() for k, v in m.items()}
        walls.append((time.perf_counter() - t) * 1e3)
        assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"])), m
        ms.append(m)
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = statistics.median(walls[1:])
    log(f"phase 21 (b): {tcfg.num_layers} of {cfg.num_layers} layers, {XLSTM_STEPS} steps of "
        f"{XLSTM_BATCH} x {TRAIN_SEQ} lm_token_stream tokens through make_train_step (bf16 "
        f"parameters, float32 moments): losses "
        f"{[round(float(m['loss']), 4) for m in ms]}, grad_norm "
        f"{[round(float(m['grad_norm']), 3) for m in ms]}; step walls (ms) "
        f"{[round(w, 1) for w in walls]}: median of steps 2-{XLSTM_STEPS} {wall:.1f} ms, "
        f"{XLSTM_BATCH * TRAIN_SEQ / wall * 1e3:,.0f} tokens/s; peak memory {peak:.2f} GB; "
        f"card {card}")
    t = time.perf_counter()
    prof = _profiled_step(lambda: step(params, opt, batches[1]))
    log(f"phase 21 (b): one profiled step: wall {prof['wall_ms']:.2f} ms (profiled), device busy "
        f"{prof['busy_ms']:.2f} ms, idle {100 * prof['idle']:.1f}%, {prof['device_ops']:,} "
        f"device operations; the profile took {time.perf_counter() - t:.1f} s; card {card}")
    for name, t_ms in prof["top"]:
        log(f"phase 21 (b):   {t_ms:9.3f} ms {100 * t_ms / prof['busy_ms']:5.1f}%  {name[:90]}")
    # the sLSTM layers' share: one sLSTM layer's forward and backward on the
    # step's shape, on layer 1's weights, timed alone and under the profiler
    sp = {k: v.detach() for k, v in params["layers"][1]["slstm"].items()}
    for v in sp.values():
        v.requires_grad_(True)
    x = torch.randn((XLSTM_BATCH, TRAIN_SEQ, cfg.d_model), device=dev, dtype=bf16,
                    requires_grad=True)
    cot = torch.randn((XLSTM_BATCH, TRAIN_SEQ, cfg.d_model), device=dev, dtype=bf16)

    def slstm_layer():
        y, _ = xlstm.slstm_forward(sp, x, pol)
        torch.autograd.grad(y, [x, *sp.values()], cot)

    slstm_walls = []
    for _ in range(3):  # the first warms up
        torch.cuda.synchronize()
        t = time.perf_counter()
        slstm_layer()
        torch.cuda.synchronize()
        slstm_walls.append((time.perf_counter() - t) * 1e3)
    one = statistics.median(slstm_walls[1:])
    sprof = _profiled_step(slstm_layer)
    n_slstm = sum(blk.mixer == "slstm" for blk in tcfg.pattern) * tcfg.num_periods
    share = n_slstm * one / wall
    log(f"phase 21 (b): one sLSTM layer's forward and backward at [{XLSTM_BATCH}, {TRAIN_SEQ}, "
        f"{cfg.d_model}] alone: {one:.1f} ms (median of 2), {sprof['device_ops']:,} device "
        f"operations ({sprof['device_ops'] / TRAIN_SEQ:.1f} a time step), device busy "
        f"{sprof['busy_ms']:.2f} ms of {sprof['wall_ms']:.1f} (idle {100 * sprof['idle']:.1f}%); "
        f"x {n_slstm} layers = {100 * share:.1f}% of the {wall:.1f} ms step; card {card}")
    del opt, sp, x, cot, batches
    torch.cuda.empty_cache()
    over_cfg = OptConfig(lr=1e-3, warmup=1)
    opt = init_opt(params, over_cfg)
    over = make_train_step(tcfg, pol, over_cfg)
    one_batch = _lm_batch(next(iter(lm_token_stream(
        1, XLSTM_BATCH, XLSTM_OVERFIT_SEQ + 1, cfg.vocab_size, seed=22))), dev)
    losses = []
    for _ in range(8):
        params, opt, m = over(params, opt, one_batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    log(f"phase 21 (b): one batch of {XLSTM_BATCH} x {XLSTM_OVERFIT_SEQ} repeated for 8 steps at "
        f"OptConfig(lr=1e-3, warmup=1): losses {[round(v, 4) for v in losses]} (the last below "
        f"the first); {time.perf_counter() - t_phase:.1f} s so far")
    del params, opt, step, over, one_batch
    torch.cuda.empty_cache()

    # ---- (c) the smoke config, card against CPU ---------------------------
    smoke_card_against_cpu(dev, reduce_for_smoke(cfg), rng, 24, 64, "21 (c)")
    log(f"phase 21 (c): {time.perf_counter() - t_phase:.1f} s so far")

    # ---- (d) remat on gemma-2b, full width and depth ----------------------
    gemma = get_config("gemma-2b")
    gb = [_lm_batch(x, dev) for x in
          lm_token_stream(2, GEMMA_BATCH, TRAIN_SEQ + 1, gemma.vocab_size, seed=211)]
    remat_d = _remat_runs(dev, gemma, dict(param_dtype=bf16, compute_dtype=bf16),
                          {"no remat": {}, "remat": dict(remat=True)}, OptConfig(), gb, "d",
                          card)
    want = {"no remat": 1, "remat": 2}
    for name, run in remat_d.items():
        got = run["launches_a_step"]
        assert got["flash_attention"] == want[name] * gemma.num_layers, (name, got)
        assert got["flash_attention_bwd"] == gemma.num_layers, (name, got)
        assert got["flash_attention_bwd_stats"] == 0, (name, got)
    log(f"phase 21 (d): gemma-2b, 2 steps of {GEMMA_BATCH} x {TRAIN_SEQ}: peak memory "
        f"{remat_d['no remat']['peak_gb']:.2f} GB without remat, "
        f"{remat_d['remat']['peak_gb']:.2f} GB with Policy(remat=True) (phase 19 (a) trains the "
        f"same model and batch shape); flash forward launches a step "
        f"{remat_d['no remat']['launches_a_step']['flash_attention']:g} / "
        f"{remat_d['remat']['launches_a_step']['flash_attention']:g}, backward "
        f"{remat_d['remat']['launches_a_step']['flash_attention_bwd']:g}; "
        f"{time.perf_counter() - t_phase:.1f} s so far; card {card}")
    del gb
    torch.cuda.empty_cache()

    # ---- (e) remat on Scout, 2 of 48 layers, 4 stacked EP shards ------------
    scout = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                                num_layers=SCOUT_TRAIN_LAYERS)
    sb = [_lm_batch(x, dev) for x in
          lm_token_stream(2, SCOUT_BATCH, TRAIN_SEQ + 1, scout.vocab_size, seed=212)]
    remat_e = _remat_runs(
        dev, scout, dict(param_dtype=bf16, compute_dtype=bf16, ep_shards=EP_SHARDS,
                         exchange_backend="dense"),
        {"no remat": {}, "nothing": dict(remat=True, remat_policy="nothing"),
         "save_moe": dict(remat=True, remat_policy="save_moe")},
        OptConfig(moment_dtype=bf16), sb, "e", card)
    moe_layers = sum(blk.ffn == "moe" for blk in scout.pattern) * scout.num_periods
    want = {"no remat": 2, "nothing": 4, "save_moe": 2}  # dispatch_count a MoE layer a step
    for name, run in remat_e.items():
        got = run["launches_a_step"]
        assert got["dispatch_count"] == want[name] * moe_layers, (name, got)
        assert got["flash_attention"] == (1 if name == "no remat" else 2) * scout.num_layers, got
    log(f"phase 21 (e): Scout, 2 steps of {SCOUT_BATCH} x {TRAIN_SEQ}, no remat / 'nothing' / "
        f"'save_moe': peak memory "
        + " / ".join(f"{r['peak_gb']:.2f}" for r in remat_e.values())
        + " GB; dispatch_count launches a step "
        + " / ".join(f"{r['launches_a_step']['dispatch_count']:g}" for r in remat_e.values())
        + "; step walls (ms) "
        + " / ".join(f"{statistics.median(r['walls_ms']):.1f}" for r in remat_e.values())
        + f"; card {card}")
    del sb
    torch.cuda.empty_cache()
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s in all; card {card}")

    def per_step(kname):
        return {f"{model_name} {name}": run["launches_a_step"][kname]
                for model_name, runs in (("gemma-2b", remat_d), ("Scout", remat_e))
                for name, run in runs.items()}

    return {"flash_attention": {"launches_phase_21": per_step("flash_attention")},
            "flash_attention_bwd": {"launches_phase_21": per_step("flash_attention_bwd")},
            "dispatch_count": {"launches_phase_21": per_step("dispatch_count")}}


# phase 22: the enc-dec family, whisper-base at its full published width and depth
WHISPER_UTTERANCES = 16
WHISPER_REPLICAS = 4
WHISPER_PROMPT = 4          # prompt tokens an utterance (the task and language tokens' count)
WHISPER_NEW = 60            # greedy tokens decoded an utterance
WHISPER_MAX_LEN = 448       # the decoder's context (whisper's n_text_ctx)
WHISPER_BATCH = 16
WHISPER_STEPS = 8
# phase 22 (d): flash forward against its plain version (phase 10's limits)
FWD_BF16_ABS = 8e-3
FWD_F32_ABS = 2e-5


def _whisper_batch(toks, frames, dev):
    batch = _lm_batch(toks, dev)
    batch["enc_embeds"] = frames
    return batch


def check_whisper_flash(dev, card, cfg) -> dict:
    """Phase 22 (d): both flash kernels at whisper-base's three attention
    shapes (B 16, G 8, P 1, hd 64): the encoder's 1,500 x 1,500 and the
    decoder's 448 x 448 causal self-attention, the cross-attention's 448
    q rows over 1,500 k rows (see :func:`check_flash_shapes`)."""
    b, g, hd = WHISPER_BATCH, cfg.num_kv_heads, cfg.head_dim
    p = cfg.num_heads // g
    shapes = {"encoder": (b, g, p, cfg.enc_len, cfg.enc_len, hd, False),
              "decoder self": (b, g, p, WHISPER_MAX_LEN, WHISPER_MAX_LEN, hd, True),
              "cross": (b, g, p, WHISPER_MAX_LEN, cfg.enc_len, hd, False)}
    return check_flash_shapes(dev, card, shapes, "22 (d)", seed=22)


def check_flash_shapes(dev, card, shapes, tag, *, seed) -> dict:
    """Both flash kernels at each of ``shapes`` (name -> ``(B, G, P, Sq,
    Sk, hd, causal)``), seeded inputs: bf16 and float32 against the plain
    versions, outputs handed out dirty, two calls bit-equal, the forward
    without lse bit-equal to the launch that writes it; the backward with
    the forward's lse and by the stats pass, each gradient on its own scale
    with a 5%-off control refused, at the head splits ``bwd_splits`` gives
    the shape (logged); times beside the bound and SDPA's (k and v expanded
    to the q heads).  Logged as phase ``tag``; returns each shape's
    forward and backward rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (b, g, p, sq, sk, hd, causal) in shapes.items():
        mask = dict(causal=causal, window=0, q_offset=0)
        q = torch.randn((b, sq, g, p, hd), generator=gen, device=dev)
        k = torch.randn((b, sk, g, hd), generator=gen, device=dev)
        v = torch.randn((b, sk, g, hd), generator=gen, device=dev)
        dout = torch.randn((b, sq, g * p * hd), generator=gen, device=dev)
        shape = (f"B={b} G={g} P={p} Sq={sq} Sk={sk} hd={hd} "
                 f"{'causal' if causal else 'non-causal'} ({name})")
        splits = kflash.bwd_splits(b, g, p, sk, kflash._sm_count(dev))
        heads = [(i + 1) * p // splits - i * p // splits for i in range(splits)]
        row = {"fwd": {"shape": shape}, "bwd": {"shape": shape, "bwd_splits_bf16": splits,
                                                "heads_a_split": heads}}
        log(f"phase {tag}: flash_attention_bwd at {shape}: bwd_splits gives the bf16 dk/dv "
            f"kernel {splits} block(s) over the group's {p} heads, {heads} heads each "
            f"({b * g * -(-sk // 64) * splits} blocks on {kflash._sm_count(dev)} SMs); float32 "
            f"runs 1")
        for dtype in (torch.bfloat16, torch.float32):
            tq, tk, tv, td = (t.to(dtype) for t in (q, k, v, dout))
            bf = dtype == torch.bfloat16
            dt = "bf16" if bf else "float32"
            with dirty_outputs():
                got = kflash.flash_attention_seq_major(tq, tk, tv, **mask)
            again = kflash.flash_attention_seq_major(tq, tk, tv, **mask)
            torch.cuda.synchronize()
            want = kflash.flash_attention_seq_major_plain(tq, tk, tv, **mask)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            limit = FWD_BF16_ABS if bf else FWD_F32_ABS
            assert torch.equal(got, again), (name, dt)
            assert err <= limit, (name, dt, err)
            row["fwd"][f"max_abs_err_{dt}"] = err
            assert not bf or same_bits_with_lse(tq, tk, tv, mask), (name, dt)
            log(f"phase {tag}: flash_attention [{shape}, {dt}]: max |kernel - plain| "
                f"{err:.3g} (<= {limit:g}); two calls bit-equal; outputs handed out dirty"
                + ("; the output equal bit for bit with and without lse" if bf else ""))
            modes = [("stats", None)]
            if bf:
                o, lse = kflash.flash_attention_seq_major(tq, tk, tv, return_lse=True, **mask)
                modes.insert(0, ("lse", lse))
            else:
                o = got
            blimit = BWD_EXCESS if bf else BWD_F32_REL
            for mode, ml in modes:
                r = bwd_errors(tq, tk, tv, o, td, mask, ml)
                assert r["equal"], (name, dt, mode)
                for grad, e, c in zip(("dq", "dk", "dv"), r["errs"], r["controls"]):
                    assert e <= blimit, (name, dt, mode, grad, e)
                    assert c > blimit, (name, dt, mode, grad, c)
                row["bwd"][f"errors_{dt}_{mode}"] = {"checked": max(r["errs"]),
                                                     "max_abs_err": r["abs_err"]}
                log(f"phase {tag}: flash_attention_bwd [{shape}, {dt}"
                    + (f" {mode}" if bf else "") + "]: dq, dk, dv against the plain version, "
                    f"{'excess over bf16 rounding' if bf else 'max |diff|'} / max |ref| "
                    f"{[f'{x:.3g}' for x in r['errs']]} (<= {blimit:g}; the same gradients 5% "
                    f"off read {[f'{x:.3g}' for x in r['controls']]}, refused); two calls "
                    f"bit-equal; outputs handed out dirty")
            del got, again, want, o
        # times, bf16 (the models' type)
        tq, tk, tv, td = (t.to(torch.bfloat16) for t in (q, k, v, dout))
        o, lse = kflash.flash_attention_seq_major(tq, tk, tv, return_lse=True, **mask)
        fwd = lambda: kflash.flash_attention_seq_major(tq, tk, tv, **mask)
        fwd_plain = lambda: kflash.flash_attention_seq_major_plain(tq, tk, tv, **mask)
        bwd = lambda: kflash.flash_attention_bwd_seq_major(tq, tk, tv, o, td, lse=lse, **mask)
        bwd_plain = lambda: kflash.flash_attention_bwd_seq_major_plain(tq, tk, tv, o, td, **mask)
        qs = tq.reshape(b, sq, g * p, hd).transpose(1, 2).contiguous().requires_grad_()
        ks, vs = (t.repeat_interleave(p, dim=2) if p > 1 else t for t in (tk, tv))  # P 1: as is
        ks, vs = (t.transpose(1, 2).contiguous().requires_grad_() for t in (ks, vs))
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        so = sdpa()
        sd = td.reshape(b, sq, g * p, hd).transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(so, (qs, ks, vs), sd, retain_graph=True)
        nbytes, flops = flash_cost(b, g, p, sq, sk, hd, causal, torch.bfloat16)
        bbytes, bflops = _bwd_cost(b, g, p, sq, sk, hd, causal, 0, torch.bfloat16)
        peak = PEAK_FLOPS[torch.bfloat16]
        for kind, (kern, plain, lib, nb, fl) in {
                "fwd": (fwd, fwd_plain, sdpa, nbytes, flops),
                "bwd": (bwd, bwd_plain, sdpa_bwd, bbytes, bflops)}.items():
            k_ms, p_ms, l_ms = cuda_ms(kern), cuda_ms(plain, warmup=1, reps=5), cuda_ms(lib)
            k_dev, l_dev = device_ms(kern), device_ms(lib)
            bound = max(nb / HBM_BYTES_PER_S, fl / peak) * 1e3
            row[kind].update({"ms": k_ms, "plain_ms": p_ms, "device_ms": k_dev, "bound_ms": bound,
                         "bound_by": "operations" if fl / peak > nb / HBM_BYTES_PER_S
                         else "bytes", "bytes": nb, "flops": fl, "library_ms": l_ms,
                         "library_device_ms": l_dev})
            log(f"phase {tag}: flash_attention{'_bwd' if kind == 'bwd' else ''} at "
                f"{shape} bf16: events around one call {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, SDPA{' backward' if kind == 'bwd' else ''} {l_ms:.4f} ms; "
                f"device time {k_dev:.4f} ms ({fl / k_dev / 1e9:.1f} TFLOP/s, "
                f"{100 * bound / k_dev:.2f}% of the bound {bound:.4f} ms by "
                f"{row[kind]['bound_by']}: {fl:,} FLOP, {nb:,} bytes), SDPA {l_dev:.4f} ms "
                f"(kernel / SDPA {k_dev / l_dev:.2f}); card {card}")
        out[name] = row
        del q, k, v, dout, tq, tk, tv, td, o, lse, qs, ks, vs, so, sd
        torch.cuda.empty_cache()
    return out


def whisper_phase(dev, card) -> dict:
    """Phase 22: the enc-dec family.  (a) whisper-base served at full
    width and depth, (b) trained, with remat on and off, (c) its smoke
    config card against CPU, (d) both flash kernels at its three attention
    shapes against their plain versions.  Returns the phase-22 entries of
    the flash and flash-backward rows."""
    import repro_torch.models.model as model
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.data.generators import lm_token_stream
    from repro_torch.models import encdec
    from repro_torch.models.modules import Policy
    from repro_torch.serve.scheduler import DRScheduler
    from repro_torch.train.optimizer import OptConfig, init_opt, leaves
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    cfg = get_config("whisper-base")
    pol = Policy(param_dtype=bf16, compute_dtype=bf16)
    n_layers = cfg.enc_layers + 2 * cfg.num_layers  # flash calls a forward
    gen = torch.Generator(device=dev).manual_seed(22)

    # ---- (a) serving at full width and depth ------------------------------
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(params))
    log(f"phase 22 (a): {cfg.name}: {cfg.enc_layers} encoder and {cfg.num_layers} decoder "
        f"layers, d {cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} kv heads, "
        f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, enc_len "
        f"{cfg.enc_len} (the audio frontend stubbed: seeded frame embeddings): {n_params:,} "
        f"parameters bf16 (tied embeddings; the learned position table {encdec.MAX_DEC_POS} "
        f"rows); made on the card in {time.perf_counter() - t:.1f} s")
    keys9 = np.random.default_rng(0)  # phase 9's session keys
    sessions = np.where(keys9.random(32) < 0.3, 7, keys9.integers(0, 1000, 32))
    sessions = sessions[:WHISPER_UTTERANCES]
    sched = DRScheduler(WHISPER_REPLICAS)
    groups: list[list[int]] = [[] for _ in range(WHISPER_REPLICAS)]
    for i, key in enumerate(sessions):
        groups[sched.route(int(key), cost_tokens=WHISPER_NEW)].append(i)
    frames = torch.randn((WHISPER_UTTERANCES, cfg.enc_len, cfg.d_model), generator=gen,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (WHISPER_UTTERANCES, WHISPER_PROMPT),
                            generator=gen, device=dev)
    batches = {r: {"tokens": prompts[idx], "enc_embeds": frames[idx]}
               for r, idx in enumerate(groups) if idx}

    def synced_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # untimed warm-up: a prefill and a decode step of each replica's batch, so
    # no timed wall below is its shape's first call
    for batch in batches.values():
        _, cache = model.prefill(params, batch, cfg, pol, max_len=WHISPER_MAX_LEN)
        model.decode_step(params, cache, batch["tokens"][:, -1:], cfg, pol)
    del cache
    # the encoder alone on each batch, warm, outside the timed serving below
    enc_ms = {r: 1e3 * statistics.median(
                  synced_s(lambda: encdec.encode(params, batch["enc_embeds"], cfg, pol))
                  for _ in range(5))
              for r, batch in batches.items()}
    prefill_ms, decode_ms, outs, finite = {}, {}, {}, []
    t = time.perf_counter()
    for r, batch in batches.items():
        _zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cfg, pol, max_len=WHISPER_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms[r] = (time.perf_counter() - t0) * 1e3
        n_pre = _launch_counts()["flash_attention"]
        assert n_pre == n_layers, (r, n_pre)
        finite.append(bool(torch.isfinite(logits).all()))
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        toks, walls = [nxt], []
        for _ in range(WHISPER_NEW - 1):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, nxt[:, None], cfg, pol)
            nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            finite.append(bool(torch.isfinite(logits).all()))
            toks.append(nxt)
        decode_ms[r] = statistics.median(walls) * 1e3
        assert _launch_counts()["flash_attention"] == n_pre, "a decoded token ran flash"
        outs[r] = torch.stack(toks, dim=1).cpu()
        log(f"phase 22 (a): replica {r}: utterances {groups[r]} in one batch: {n_pre} flash "
            f"launches in the prefill, 0 in {WHISPER_NEW - 1} decode steps")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    del cache
    assert finite and all(finite), "non-finite logits"
    assert sum(len(g) for g in groups) == WHISPER_UTTERANCES
    for r, o in outs.items():
        assert o.shape == (len(groups[r]), WHISPER_NEW), o.shape
        assert int(o.min()) >= 0 and int(o.max()) < cfg.vocab_size
    tokens = WHISPER_UTTERANCES * WHISPER_NEW
    log(f"phase 22 (a): DRScheduler({WHISPER_REPLICAS}) over phase 9's first "
        f"{WHISPER_UTTERANCES} session keys: replicas' batches {[len(g) for g in groups]}; "
        f"{WHISPER_UTTERANCES} utterances of {cfg.enc_len} frames, {WHISPER_PROMPT}-token "
        f"prompts, {WHISPER_NEW} greedy tokens each: {tokens} tokens in {serve_s:.2f} s "
        f"({tokens / serve_s:.1f} tokens/s, after an untimed warm-up of each batch); routed "
        f"{sched.routed}, imbalance {sched.imbalance():.2f}; all logits finite; card {card}")
    for r in batches:
        log(f"phase 22 (a): batch of {len(groups[r])}: prefill wall {prefill_ms[r]:.3f} ms, "
            f"the encoder alone (median of 5, warm) {enc_ms[r]:.3f} ms = "
            f"{100 * enc_ms[r] / prefill_ms[r]:.1f}% of it; decode wall a token median "
            f"{decode_ms[r]:.3f} ms; card {card}")
    big = max(range(WHISPER_REPLICAS), key=lambda r: len(groups[r]))
    batch = batches[big]
    prof_pre = _profiled_step(lambda: model.prefill(params, batch, cfg, pol,
                                                    max_len=WHISPER_MAX_LEN))
    _, cache = model.prefill(params, batch, cfg, pol, max_len=WHISPER_MAX_LEN)
    one = torch.zeros((len(groups[big]), 1), dtype=torch.int64, device=dev)

    def decode8():
        for _ in range(8):
            model.decode_step(params, cache, one, cfg, pol)

    prof_dec = _profiled_step(decode8)
    for label, pr, plain in (("a prefill", prof_pre, prefill_ms[big]),
                             ("8 decode steps", prof_dec, 8 * decode_ms[big])):
        log(f"phase 22 (a): profile of {label} (replica {big}, {len(groups[big])} utterances): "
            f"wall {pr['wall_ms']:.2f} ms (profiled), {pr['device_ops']:,} device operations, "
            f"device busy {pr['busy_ms']:.2f} ms, idle {100 * pr['idle']:.1f}% of the profiled "
            f"wall, {100 * (1 - pr['busy_ms'] / plain):.1f}% of the unprofiled {plain:.2f} ms")
        for name, ms in pr["top"]:
            log(f"phase 22 (a):   {ms:9.3f} ms {100 * ms / pr['busy_ms']:5.1f}%  {name[:90]}")
    del cache, batch
    # teacher-forced at full width in float32
    t = time.perf_counter()
    f32 = Policy()
    p32 = model.init_params(cfg, 0, f32, device=dev)
    rng = np.random.default_rng(22)
    one = {"enc_embeds": torch.randn((1, cfg.enc_len, cfg.d_model), generator=gen, device=dev)}
    tf = {(p, n): _teacher_forced(model, p32, cfg, f32, dev, rng, p, n, one)
          for p, n in ((WHISPER_PROMPT, 64), (WHISPER_MAX_LEN - 1, WHISPER_MAX_LEN))}
    log(f"phase 22 (a): teacher-forced, float32 at full width: " + "; ".join(
        f"{p} prefilled + {n - p} decoded against {n} prefilled: largest logit difference "
        f"{d:.3g} (limit {TEACHER_TOL} x (1 + |logit|))" for (p, n), d in tf.items())
        + f"; {time.perf_counter() - t:.1f} s; {time.perf_counter() - t_phase:.1f} s so far")
    del p32, params, frames, batches
    torch.cuda.empty_cache()

    # ---- (b) training at full width and depth -----------------------------
    params = model.init_params(cfg, 0, pol, device=dev)
    opt_cfg = OptConfig()
    opt = init_opt(params, opt_cfg)
    step = make_train_step(cfg, pol, opt_cfg)
    batches = [_whisper_batch(x, torch.randn((WHISPER_BATCH, cfg.enc_len, cfg.d_model),
                                             generator=gen, device=dev), dev)
               for x in lm_token_stream(WHISPER_STEPS, WHISPER_BATCH, WHISPER_MAX_LEN + 1,
                                        cfg.vocab_size, seed=22)]
    per_step = {"flash_attention": n_layers, "flash_attention_bwd": n_layers,
                "flash_attention_bwd_stats": 0, "dispatch_count": 0}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    walls, ms = [], []
    for i, batch in enumerate(batches):
        before = _launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        m = {k: v.cpu() for k, v in m.items()}
        walls.append((time.perf_counter() - t) * 1e3)
        now = _launch_counts()
        assert {k: now[k] - before[k] for k in now} == per_step, (i, now, before)
        assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"])), m
        ms.append(m)
    train_launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = statistics.median(walls[1:])
    dec_tokens = WHISPER_BATCH * WHISPER_MAX_LEN
    log(f"phase 22 (b): {WHISPER_STEPS} steps of {WHISPER_BATCH} x ({cfg.enc_len} frames, "
        f"{WHISPER_MAX_LEN} lm_token_stream tokens) through make_train_step (bf16 parameters, "
        f"float32 moments): losses {[round(float(m['loss']), 4) for m in ms]}, grad_norm "
        f"{[round(float(m['grad_norm']), 3) for m in ms]}; step walls (ms) "
        f"{[round(w, 1) for w in walls]}: median of steps 2-{WHISPER_STEPS} {wall:.1f} ms, "
        f"{dec_tokens / wall * 1e3:,.0f} decoder tokens/s "
        f"({WHISPER_BATCH * cfg.enc_len / wall * 1e3:,.0f} frames/s); peak memory {peak:.2f} GB; "
        f"launches {train_launches} ({n_layers} flash forward and {n_layers} backward a step, "
        f"none through the stats pass); card {card}")
    # three profiled steps: the profiler slows the host's launches, so each
    # one's idle share is also given against the unprofiled median wall
    profs = [_profiled_step(lambda: step(params, opt, batches[1])) for _ in range(3)]
    for i, pr in enumerate(profs):
        log(f"phase 22 (b): profiled step {i + 1} of 3: wall {pr['wall_ms']:.2f} ms (profiled), "
            f"device busy {pr['busy_ms']:.2f} ms, idle {100 * pr['idle']:.1f}% of the profiled "
            f"wall, {100 * (1 - pr['busy_ms'] / wall):.1f}% of the unprofiled median "
            f"{wall:.1f} ms; {pr['device_ops']:,} device operations; card {card}")
    prof = profs[0]
    for name, t_ms in prof["top"]:
        log(f"phase 22 (b):   {t_ms:9.3f} ms {100 * t_ms / prof['busy_ms']:5.1f}%  {name[:90]}")
    assert_bwd_kernels("(b)", prof, phase=22)
    del opt
    torch.cuda.empty_cache()
    over_cfg = OptConfig(lr=1e-3, warmup=1)
    opt = init_opt(params, over_cfg)
    over = make_train_step(cfg, pol, over_cfg)
    losses = []
    for _ in range(8):
        params, opt, m = over(params, opt, batches[0])
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    log(f"phase 22 (b): one batch repeated for 8 steps at OptConfig(lr=1e-3, warmup=1): losses "
        f"{[round(v, 4) for v in losses]} (the last below the first); "
        f"{time.perf_counter() - t_phase:.1f} s so far")
    del params, opt, step, over
    torch.cuda.empty_cache()
    remat = _remat_runs(dev, cfg, dict(param_dtype=bf16, compute_dtype=bf16),
                        {"no remat": {}, "remat": dict(remat=True)}, OptConfig(), batches[:2],
                        "b", card, phase=22)
    want = {"no remat": 1, "remat": 2}
    for name, run in remat.items():
        got = run["launches_a_step"]
        assert got["flash_attention"] == want[name] * n_layers, (name, got)
        assert got["flash_attention_bwd"] == n_layers, (name, got)
        assert got["flash_attention_bwd_stats"] == 0, (name, got)
        assert run.get("unequal_tensors", 0) == 0, (name, run)
    log(f"phase 22 (b): 2 steps from one state without and with Policy(remat=True): losses, "
        f"grad norms and all parameters equal bit for bit; peak memory "
        f"{remat['no remat']['peak_gb']:.2f} / {remat['remat']['peak_gb']:.2f} GB; flash forward "
        f"launches a step {remat['no remat']['launches_a_step']['flash_attention']:g} / "
        f"{remat['remat']['launches_a_step']['flash_attention']:g}, backward "
        f"{remat['remat']['launches_a_step']['flash_attention_bwd']:g}; step walls (ms) "
        + " / ".join(f"{statistics.median(r['walls_ms']):.1f}" for r in remat.values())
        + f"; card {card}")
    del batches
    torch.cuda.empty_cache()

    # ---- (c) the smoke config, card against CPU ---------------------------
    smoke_card_against_cpu(dev, reduce_for_smoke(cfg), np.random.default_rng(22), 12, 32,
                           "22 (c)")
    log(f"phase 22 (c): {time.perf_counter() - t_phase:.1f} s so far")

    # ---- (d) the flash kernels at whisper's three shapes -------------------
    checked = check_whisper_flash(dev, card, cfg)
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    per_step = {name: run["launches_a_step"] for name, run in remat.items()}
    return {"flash_attention": {
                "launches_phase_22": {"a prefill": n_layers, "a decoded token": 0,
                                      "a train step": per_step["no remat"]["flash_attention"],
                                      "a train step under remat":
                                          per_step["remat"]["flash_attention"],
                                      "(b) in all": train_launches["flash_attention"]},
                "phase_22": {k: v["fwd"] for k, v in checked.items()}},
            "flash_attention_bwd": {
                "launches_phase_22": {"a train step": per_step["no remat"]["flash_attention_bwd"],
                                      "a train step under remat":
                                          per_step["remat"]["flash_attention_bwd"],
                                      "(b) in all": train_launches["flash_attention_bwd"]},
                "phase_22": {k: v["bwd"] for k, v in checked.items()}}}


# phase 23: M-RoPE and vision tokens, qwen2-vl-7b at its full published width and depth
VLM_REQUESTS, VLM_NEW, VLM_REPLICAS, VLM_SLOTS = 16, 16, 4, 4
VLM_MAX_LEN = 2064
VLM_PATCH_PROMPT = 1024     # the prompt model.prefill takes with 256 patches
VLM_BATCH = 2               # training: 2 x 1,024 tokens under remat
VLM_STEPS = 4
VLM_OVERFIT_STEPS = 6
# the one-batch check's learning rate: the first AdamW steps move each weight
# by about lr (a 3,584-wide layer's init scale is 0.0167); at phases 19 and
# 22's 1e-3 the loss went from 10.24 up to 20.52, at 1e-4 up to 15.36, while
# (b)'s warm-up steps at 3e-6 to 1.5e-5 brought it from 12.57 to 10.24
VLM_OVERFIT_LR = 1e-5


def vlm_phase(dev, card) -> dict:
    """Phase 23: qwen2-vl-7b (M-RoPE, 256 vision tokens).  (a) served in
    bf16 at full width and depth, text only through DRScheduler x
    ServeEngine, then through model.prefill / decode_step with seeded
    patches, and the short-prompt contract; (b) trained under remat with
    bf16 moments and seeded patches (zero patches' gradient norm is NaN at
    this depth, as the reference's); (c) its smoke config with patches, card against CPU; (d)
    both flash kernels at its grouping (G 4, P 7, hd 128) at B 1 and B 2
    against their plain versions.  Returns the phase-23 entries of the
    flash and flash-backward rows."""
    import repro_torch.models.model as model
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.data.generators import lm_token_stream
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import DRScheduler
    from repro_torch.train.optimizer import OptConfig, global_norm, init_opt, leaves
    from repro_torch.train.train_step import make_train_step, trainable

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    cfg = get_config("qwen2-vl-7b")
    pol = Policy(param_dtype=bf16, compute_dtype=bf16)
    n_layers = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(23)

    # ---- (a) serving at full width and depth ------------------------------
    n_cfg = cfg.param_count()
    log(f"phase 23 (a): {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} q heads over {cfg.num_kv_heads} kv heads (G {cfg.num_kv_heads}, P "
        f"{cfg.num_heads // cfg.num_kv_heads}), head_dim {cfg.head_dim}, SwiGLU d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} (untied lm_head), M-RoPE theta {cfg.rope_theta:g}, "
        f"{cfg.vision_tokens} vision tokens (the frontend stubbed: patch embeddings); reckoned "
        f"from the config: {n_cfg:,} parameters, {2 * n_cfg / 1e9:.2f} GB in bf16")
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(params))
    log(f"phase 23 (a): {n_params:,} parameters bf16 ({2 * n_params / 1e9:.2f} GB) made on the "
        f"card from a seeded generator in {time.perf_counter() - t:.1f} s; memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(23)  # phase 9's mix: key 7 at 0.3, prompts of 256-2,048
    sessions = np.where(rng.random(VLM_REQUESTS) < 0.3, 7, rng.integers(0, 1000, VLM_REQUESTS))
    lens = rng.integers(256, 2049, VLM_REQUESTS)
    sched = DRScheduler(VLM_REPLICAS)
    engines = [ServeEngine(cfg, params, pol, slots=VLM_SLOTS, max_len=VLM_MAX_LEN, device=dev)
               for _ in range(VLM_REPLICAS)]
    queues: list[list] = [[] for _ in range(VLM_REPLICAS)]
    for i in range(VLM_REQUESTS):
        req = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32),
                      max_new_tokens=VLM_NEW, session_key=int(sessions[i]))
        queues[sched.route(req.session_key, cost_tokens=VLM_NEW)].append(req)
    # an untimed warm-up prefill and decode step, so no timed wall is a first call
    warm = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)), device=dev)
    _, cache = model.prefill(params, {"tokens": warm}, cfg, pol, max_len=264)
    model.decode_step(params, cache, warm[:, -1:], cfg, pol)
    del cache
    _zero_launch_counts()
    rec = _timed_serving(model, engines, queues, "23 (a)")
    serve_s = rec["serve_s"]
    serve_launches = _launch_counts()["flash_attention"]
    reqs = [r for q in queues for r in q]
    assert len(reqs) == VLM_REQUESTS
    for r in reqs:
        assert len(r.out_tokens) == VLM_NEW and r.done, (r.rid, r.out_tokens)
        assert all(0 <= x < cfg.vocab_size for x in r.out_tokens), (r.rid, r.out_tokens)
    calls = rec["prefill"] + rec["decode"]
    assert calls and all(c["finite"] for c in calls), "non-finite logits"
    assert {c["flash"] for c in rec["prefill"]} == {n_layers}, rec["prefill"]
    assert {c["flash"] for c in rec["decode"]} == {0}, "a decoded token ran flash"
    assert serve_launches == n_layers * VLM_REQUESTS, serve_launches
    tokens = sum(len(r.out_tokens) for r in reqs)
    prefill_ms = statistics.median(c["wall"] for c in rec["prefill"]) * 1e3
    decode_ms = statistics.median(c["wall"] for c in rec["decode"]) * 1e3
    by_len = sorted((c["len"], c["wall"] * 1e3) for c in rec["prefill"])
    log(f"phase 23 (a): DRScheduler({VLM_REPLICAS}) x ServeEngine({VLM_SLOTS} slots), text only "
        f"(the engine passes no patches, as the reference's): {VLM_REQUESTS} requests, prompts "
        f"{int(lens.min())}-{int(lens.max())} tokens (mean {lens.mean():.1f}), {VLM_NEW} new "
        f"each: {tokens} tokens in {serve_s:.2f} s ({tokens / serve_s:.1f} tokens/s); prefill "
        f"wall a request median {prefill_ms:.2f} ms (shortest {by_len[0][0]} tokens "
        f"{by_len[0][1]:.1f} ms, longest {by_len[-1][0]} tokens {by_len[-1][1]:.1f} ms), decode "
        f"wall a token median {decode_ms:.2f} ms over {len(rec['decode'])} decode steps; "
        f"flash launches {serve_launches} ({n_layers} a prefill, 0 a decoded token); routed "
        f"{sched.routed}, imbalance {sched.imbalance():.2f}; all logits finite; card {card}")
    del engines, queues, reqs
    t = time.perf_counter()
    prof = profile_serving(model, params, cfg, pol, rng, dev, 1040, phase="23 (a)", reps=1)
    dec = prof["8 decode steps after it"]
    log(f"phase 23 (a): {prof['prefill of 1024 tokens']['device_ops']:,} device operations a "
        f"1,024-token prefill, {dec['device_ops'] / 8:,.0f} a decoded token; idle "
        f"{100 * prof['prefill of 1024 tokens']['idle']:.1f}% / {100 * dec['idle']:.1f}%; the "
        f"profile took {time.perf_counter() - t:.1f} s")
    # model.prefill with seeded patches, then 16 greedy tokens
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, VLM_PATCH_PROMPT)), device=dev)
    patches = model.vision_embeds(cfg, 1, pol, gen, device=dev)
    max_len = VLM_PATCH_PROMPT + VLM_NEW
    text, _ = model.prefill(params, {"tokens": toks}, cfg, pol, max_len=max_len)
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": toks, "vision_embeds": patches}, cfg, pol,
                                  max_len=max_len)
    torch.cuda.synchronize()
    patch_pre_ms = (time.perf_counter() - t0) * 1e3
    assert _launch_counts()["flash_attention"] == n_layers, _launch_counts()
    assert bool(torch.isfinite(logits).all())
    moved = float((logits.float() - text.float()).abs().max())
    assert moved > 0, "the patches did not reach the logits"
    nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
    out, dwalls = [int(nxt)], []
    for _ in range(VLM_NEW - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, nxt[:, None], cfg, pol)
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        dwalls.append(time.perf_counter() - t0)
        assert bool(torch.isfinite(logits).all())
        out.append(int(nxt))
    assert _launch_counts()["flash_attention"] == n_layers, "a decoded token ran flash"
    assert all(0 <= x < cfg.vocab_size for x in out) and int(cache["pos"][0]) == max_len - 1
    log(f"phase 23 (a): model.prefill of a {VLM_PATCH_PROMPT}-token prompt with "
        f"{cfg.vision_tokens} seeded patch embeddings (model.vision_embeds, bf16) in its first "
        f"rows: wall {patch_pre_ms:.2f} ms, {n_layers} flash launches; the last logits differ "
        f"from the text-only prefill's by up to {moved:.3g}; {VLM_NEW} greedy tokens "
        f"{out} (decode wall a token median {statistics.median(dwalls) * 1e3:.2f} ms, no flash "
        f"launch); all logits finite; card {card}")
    del cache, logits, text
    short = toks[:, :128]
    try:
        model.prefill(params, {"tokens": short, "vision_embeds": patches}, cfg, pol,
                      max_len=136)
    except ValueError as e:
        assert "cannot take 256 patch embeddings" in str(e), e
        log(f"phase 23 (a): a 128-token prompt with 256 patches: model.prefill raised "
            f"ValueError ({e})")
    else:
        raise AssertionError("a 128-token prompt took 256 patches: the contract is gone")
    log(f"phase 23 (a): {time.perf_counter() - t_phase:.1f} s so far")
    del params, patches, toks, short
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) training at full width and depth -----------------------------
    tpol = Policy(param_dtype=bf16, compute_dtype=bf16, remat=True)
    opt_cfg = OptConfig(moment_dtype=bf16)
    total = torch.cuda.get_device_properties(dev).total_memory
    bf16_state, f32_state = 8 * n_cfg, 12 * n_cfg
    log(f"phase 23 (b): reckoned state: weights {2 * n_cfg / 1e9:.1f} + grads "
        f"{2 * n_cfg / 1e9:.1f} + two moments {4 * n_cfg / 1e9:.1f} GB = {bf16_state / 1e9:.1f} GB "
        f"with bf16 moments; with float32 moments {f32_state / 1e9:.1f} GB, over the card's "
        f"{total / 1e9:.1f} GB, so it cannot train with them; bf16 moments "
        f"(OptConfig(moment_dtype=bfloat16)), no depth cut, Policy(remat=True) to hold the "
        f"activations at one layer's")
    assert f32_state > total > bf16_state, (f32_state, total, bf16_state)
    params = model.init_params(cfg, 0, tpol, device=dev)
    batches = [_lm_batch(x, dev) for x in lm_token_stream(VLM_STEPS, VLM_BATCH, TRAIN_SEQ + 1,
                                                          cfg.vocab_size, seed=23)]
    # zero patches, as launch/train.py builds them (and the reference's
    # launcher): their rows stay exactly zero through every layer, and each
    # RMSNorm's backward multiplies their gradient by eps**-0.5 = 1,000, so at
    # 28 layers it overflows and the gradient norm is NaN, in both packages
    # (tests/test_torch_vlm.py, ROADMAP.md queue 3).  Shown once, without an
    # update; the steps below take seeded patches.
    zero = {**batches[0], "vision_embeds": torch.zeros(
        (VLM_BATCH, cfg.vision_tokens, cfg.d_model), device=dev)}
    flat = leaves(trainable(params))
    loss, _ = model.loss_fn(params, zero, cfg, tpol)
    gnorm = global_norm(torch.autograd.grad(loss, flat))
    assert bool(torch.isfinite(loss)) and not bool(torch.isfinite(gnorm)), (loss, gnorm)
    log(f"phase 23 (b): zero patches (the launchers' stub) at full depth: loss "
        f"{float(loss.detach()):.4f}, gradient norm {float(gnorm)} (the zero rows' gradient overflows "
        f"through every RMSNorm backward, as in the reference); the steps take seeded patches")
    del flat, loss, gnorm, zero
    gc.collect()
    torch.cuda.empty_cache()
    for batch in batches:
        batch["vision_embeds"] = model.vision_embeds(cfg, VLM_BATCH, tpol, gen, device=dev)
    opt = init_opt(params, opt_cfg)
    step = make_train_step(cfg, tpol, opt_cfg)
    per_step = {"flash_attention": 2 * n_layers, "flash_attention_bwd": n_layers,
                "flash_attention_bwd_stats": 0, "dispatch_count": 0}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    walls, ms = [], []
    for i, batch in enumerate(batches):
        before = _launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        m = {k: v.cpu() for k, v in m.items()}
        walls.append((time.perf_counter() - t) * 1e3)
        now = _launch_counts()
        assert {k: now[k] - before[k] for k in now} == per_step, (i, now, before)
        assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"])), m
        ms.append(m)
    train_launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = statistics.median(walls[1:])
    tok = VLM_BATCH * TRAIN_SEQ
    log(f"phase 23 (b): {VLM_STEPS} steps of {VLM_BATCH} x {TRAIN_SEQ} lm_token_stream tokens "
        f"with seeded patches through make_train_step (bf16 parameters and moments, "
        f"Policy(remat=True)): losses {[round(float(m['loss']), 4) for m in ms]}, grad_norm "
        f"{[round(float(m['grad_norm']), 3) for m in ms]}; step walls (ms) "
        f"{[round(w, 1) for w in walls]}: median of steps 2-{VLM_STEPS} {wall:.1f} ms, "
        f"{tok / wall * 1e3:,.0f} tokens/s; peak memory {peak:.2f} GB of {total / 1e9:.1f}; "
        f"launches {train_launches} ({2 * n_layers} flash forward (each layer's again in the "
        f"recomputation) and {n_layers} backward a step, none through the stats pass); "
        f"card {card}")
    prof = _profiled_step(lambda: step(params, opt, batches[1]))
    log(f"phase 23 (b): one profiled step: wall {prof['wall_ms']:.2f} ms (profiled), device busy "
        f"{prof['busy_ms']:.2f} ms, idle {100 * prof['idle']:.1f}% of the profiled wall, "
        f"{100 * (1 - prof['busy_ms'] / wall):.1f}% of the unprofiled median {wall:.1f} ms; "
        f"{prof['device_ops']:,} device operations; card {card}")
    for name, t_ms in prof["top"]:
        log(f"phase 23 (b):   {t_ms:9.3f} ms {100 * t_ms / prof['busy_ms']:5.1f}%  {name[:90]}")
    assert_bwd_kernels("(b)", prof, phase=23)
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    over_cfg = OptConfig(lr=VLM_OVERFIT_LR, warmup=1, moment_dtype=bf16)
    opt = init_opt(params, over_cfg)
    over = make_train_step(cfg, tpol, over_cfg)
    losses = []
    for _ in range(VLM_OVERFIT_STEPS):
        params, opt, m = over(params, opt, batches[0])
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    log(f"phase 23 (b): one batch repeated for {VLM_OVERFIT_STEPS} steps at "
        f"OptConfig(lr={VLM_OVERFIT_LR:g}, warmup=1, bf16 moments): losses {[round(v, 4) for v in losses]} (the last below the "
        f"first); {time.perf_counter() - t_phase:.1f} s so far")
    del params, opt, step, over, batches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the smoke config with patches, card against CPU ---------------
    smoke_card_against_cpu(dev, reduce_for_smoke(cfg), np.random.default_rng(23), 12, 32,
                           "23 (c)")
    log(f"phase 23 (c): {time.perf_counter() - t_phase:.1f} s so far")

    # ---- (d) the flash kernels at qwen2-vl's grouping ----------------------
    g, hd = cfg.num_kv_heads, cfg.head_dim
    p = cfg.num_heads // g
    checked = check_flash_shapes(
        dev, card, {f"B {b}": (b, g, p, TRAIN_SEQ, TRAIN_SEQ, hd, True) for b in (1, 2)},
        "23 (d)", seed=23)
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return {"flash_attention": {
                "launches_phase_23": {"a prefill": n_layers, "a decoded token": 0,
                                      "(a) serving in all": serve_launches,
                                      "a train step under remat": 2 * n_layers,
                                      "(b) in all": train_launches["flash_attention"]},
                "phase_23": {k: v["fwd"] for k, v in checked.items()}},
            "flash_attention_bwd": {
                "launches_phase_23": {"a train step under remat": n_layers,
                                      "(b) in all": train_launches["flash_attention_bwd"]},
                "phase_23": {k: v["bwd"] for k, v in checked.items()}}}



# phase 24: the Mamba mixer and the hybrid family, jamba-1.5-large at full width
JAMBA_SERVE_LAYERS = 4      # the period's first four: (M, dense), (M, MoE), (M, dense), (A, MoE)
JAMBA_TRAIN_LAYERS = 2      # (M, dense) twice: one MoE FFN alone is 9.66 B parameters
JAMBA_PROMPTS = (256, 512, 1024, 2048)   # the chunk contract: <= 256 or a multiple of 256
JAMBA_REQUESTS, JAMBA_NEW, JAMBA_REPLICAS, JAMBA_SLOTS = 16, 16, 4, 4
JAMBA_MAX_LEN = 2064
JAMBA_BATCH = 2
JAMBA_STEPS = 3
JAMBA_PEAK_LIMIT = 75e9     # (d)'s training peak must stay under it
JAMBA_OVERFIT_STEPS = 8
JAMBA_OVERFIT_LRS = (1e-5, 1e-6, 1e-4)   # tried in turn until the loss falls


def _mixer_param_counts(cfg) -> tuple[int, int]:
    """One Mamba mixer's parameters as ``init_mamba`` makes them, and as
    ``ArchConfig.param_count`` reckons them."""
    d, di, ds, k = cfg.d_model, cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state, cfg.mamba_conv
    r = -(-d // 16)
    made = 2 * d * di + k * di + di + di * (r + 2 * ds) + r * di + di + di * ds + di + di * d
    return made, 2 * d * di + di * k + di * (2 * ds + 2) + di * d


def mamba_alone(dev, card, cfg) -> dict:
    """Phase 24 (b): one Mamba mixer at jamba's width (d 8,192, d_inner
    16,384, d_state 16, bf16) on ``[2, 1,024]``: forward and backward walls,
    device times (:func:`cuda_ms`), the host's time to queue them, device
    operations (:func:`device_op_count`) and a chunk's, the chunk loop's
    share of the no-grad forward's device time, the peak memory of a forward
    and backward, and a decoded token's device time and operations."""
    from repro_torch.models import ssm
    from repro_torch.models.modules import Policy

    bf16 = torch.bfloat16
    pol = Policy(param_dtype=bf16, compute_dtype=bf16)
    gen = torch.Generator(device=dev).manual_seed(24)
    p = ssm.init_mamba(gen, cfg.d_model, expand=cfg.mamba_expand, d_state=cfg.mamba_d_state,
                       d_conv=cfg.mamba_conv, dtype=bf16)
    for v in p.values():
        v.requires_grad_(True)
    b, s, ds = JAMBA_BATCH, TRAIN_SEQ, cfg.mamba_d_state
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(bf16).requires_grad_()
    cot = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(bf16)
    wrt = [x, *p.values()]

    def fwd():
        return ssm.mamba_forward(p, x, pol, d_state=ds, chunk=min(256, s))[0]

    walls = {"forward": [], "backward": []}
    for _ in range(4):  # the first warms up
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = fwd()
        torch.cuda.synchronize()
        walls["forward"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        torch.autograd.grad(y, wrt, cot)
        torch.cuda.synchronize()
        walls["backward"].append((time.perf_counter() - t) * 1e3)
        del y
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.autograd.grad(fwd(), wrt, cot)
    torch.cuda.synchronize()
    gc.collect()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    y = fwd()
    bwd = lambda: torch.autograd.grad(y, wrt, cot, retain_graph=True)  # noqa: E731
    # device_ms's spin could not hold five forwards' launches (eight
    # doublings to 2^30 cycles; five calls queue 1,920 or more), so events
    # around one call each; and the host's time to queue one call, the
    # card not waited for
    queue_ms = {}
    for name, fn in (("forward", fwd), ("backward", bwd)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        queue_ms[name] = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
    f_ms, b_ms = cuda_ms(fwd, warmup=1, reps=5), cuda_ms(bwd, warmup=1, reps=5)
    f_ops, b_ops = device_op_count(fwd), device_op_count(bwd)
    del y, bwd
    # the chunk loop alone on the forward's own inputs, without autograd
    with torch.no_grad():
        xm, z = ssm._ssm_inputs(p, x, pol, ds)
        xc, _ = ssm._conv_causal(xm, p["conv_w"], p["conv_b"], None)
        dt, bm, cm = ssm._dt_b_c(p, xc, ds, bf16)
        a = -torch.exp(p["a_log"].float())
        h0 = torch.zeros((b, xc.shape[-1], ds), dtype=torch.float32, device=dev)

        def chunks():
            h = h0
            for j in range(0, s, 256):
                h, _ = ssm._chunk(h, xc[:, j:j + 256], dt[:, j:j + 256], bm[:, j:j + 256],
                                  cm[:, j:j + 256], a)

        c_ms, nf_ms = cuda_ms(chunks, warmup=1, reps=5), cuda_ms(fwd, warmup=1, reps=5)
        c_ops = device_op_count(chunks)
        state = {"conv": torch.zeros((1, cfg.mamba_conv - 1, xc.shape[-1]), dtype=bf16,
                                     device=dev), "ssm": h0[:1].clone()}
        one = x[:1, :1].detach()
        dec = lambda: ssm.mamba_decode(p, one, pol, d_state=ds, state=state)  # noqa: E731
        d_ms, d_ops = cuda_ms(dec), device_op_count(dec)
    n_chunks = s // 256
    out = {"forward_wall_ms": statistics.median(walls["forward"][1:]),
           "backward_wall_ms": statistics.median(walls["backward"][1:]),
           "forward_device_ms": f_ms, "backward_device_ms": b_ms,
           "forward_ops": f_ops, "backward_ops": b_ops, "ops_a_chunk": c_ops / n_chunks,
           "scan_share": c_ms / nf_ms, "peak_gb": peak, "decode_ops": d_ops,
           "decode_device_ms": d_ms, "queue_ms": queue_ms}
    log(f"phase 24 (b): one Mamba mixer (d {cfg.d_model}, d_inner {xc.shape[-1]}, d_state {ds}, "
        f"dt_rank {p['dt_proj'].shape[0]}, bf16) on [{b}, {s}] ({n_chunks} chunks of 256): "
        f"forward wall {out['forward_wall_ms']:.2f} ms (median of 3), device time "
        f"{f_ms:.2f} ms, {f_ops:,} device operations, queued by the host in "
        f"{queue_ms['forward']:.2f} ms; backward wall {out['backward_wall_ms']:.2f} ms, device "
        f"time {b_ms:.2f} ms, {b_ops:,} operations, queued in {queue_ms['backward']:.2f} ms; "
        f"the chunk loop (conv, projections and SiLU gate excluded) {c_ms:.2f} ms of the "
        f"no-grad forward's {nf_ms:.2f} ({100 * out['scan_share']:.1f}%), "
        f"{out['ops_a_chunk']:.0f} device operations a chunk; peak memory above the inputs "
        f"{peak:.2f} GB; a decoded token (B 1) {d_ops} device operations, device time "
        f"{d_ms:.3f} ms (device times: CUDA events around one call, the median of 5, a "
        f"token's of 20; operations: two profiler sessions that agree); card {card}")
    return out


def jamba_phase(dev, card) -> dict:
    """Phase 24: the Mamba mixer and the hybrid family.  (a) jamba-1.5-large
    served in bf16 at full width over the period's first four layers
    (every block kind) at 4 stacked EP shards, (b) one Mamba mixer alone,
    (c) teacher-forced in float32 on one (Mamba, dense) layer, (d) trained
    over two (Mamba, dense) layers under remat, (e) the smoke config card
    against CPU at 0 and 4 shards and remat bit-equal, (f) both flash
    kernels at G 8, P 8, hd 128 and ``dispatch_count`` on (a)'s top-2 hop
    inputs.  Returns the phase-24 entries of the flash, flash-backward and
    dispatch_count rows."""
    import repro_torch.models.model as model
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.data.generators import lm_token_stream
    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import DRScheduler
    from repro_torch.train.optimizer import OptConfig, init_opt, leaves
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    full = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, num_layers=JAMBA_SERVE_LAYERS,
                              pattern=full.pattern[:JAMBA_SERVE_LAYERS])
    pol = Policy(param_dtype=bf16, compute_dtype=bf16, ep_shards=EP_SHARDS,
                 exchange_backend="dense")
    kinds = [f"({blk.mixer}, {blk.ffn})" for blk in cfg.pattern]
    moe_layers = sum(blk.ffn == "moe" for blk in cfg.pattern)
    attn_layers = sum(blk.mixer == "attn" for blk in cfg.pattern)

    # ---- (a) serving at full width, cut in depth ---------------------------
    log(f"phase 24 (a): {full.name}: cut to its period's first {JAMBA_SERVE_LAYERS} of "
        f"{full.num_layers} layers, {', '.join(kinds)} (every block kind at its published "
        f"width): d {cfg.d_model}, Mamba d_inner {cfg.mamba_expand * cfg.d_model} d_state "
        f"{cfg.mamba_d_state} conv {cfg.mamba_conv}, {cfg.num_heads} q heads over "
        f"{cfg.num_kv_heads} kv heads, hd {cfg.head_dim}, SwiGLU d_ff {cfg.d_ff}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} without a shared expert (d_ff_expert "
        f"{cfg.moe.d_ff_expert}), vocab {cfg.vocab_size} untied")
    t = time.perf_counter()
    params = model.init_params(cfg, 0, pol, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(params))
    made, reckoned = _mixer_param_counts(cfg)
    n_mamba = sum(blk.mixer == "mamba" for blk in cfg.pattern)
    mixer_real = sum(v.numel() for v in params["layers"][0]["mamba"].values())
    assert mixer_real == made, (mixer_real, made)
    log(f"phase 24 (a): {n_params:,} parameters bf16 ({2 * n_params / 1e9:.2f} GB) made on the "
        f"card in {time.perf_counter() - t:.1f} s; the config's param_count() of the cut "
        f"{cfg.param_count():,} ({n_params - cfg.param_count():+,}): a Mamba mixer holds "
        f"{made:,} where the formula reckons {reckoned:,} ({made - reckoned:+,}: x_proj's dt "
        f"columns, dt_proj, a_log and conv_b), x {n_mamba} mixers = "
        f"{n_mamba * (made - reckoned):+,}; memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; {EP_SHARDS} stacked EP shards of "
        f"{cfg.moe.num_experts // EP_SHARDS} experts, dense transport")
    rng = np.random.default_rng(24)  # phase 9's session mix: key 7 at 0.3
    sessions = np.where(rng.random(JAMBA_REQUESTS) < 0.3, 7,
                        rng.integers(0, 1000, JAMBA_REQUESTS))
    lens = rng.choice(JAMBA_PROMPTS, JAMBA_REQUESTS)
    sched = DRScheduler(JAMBA_REPLICAS)
    engines = [ServeEngine(cfg, params, pol, slots=JAMBA_SLOTS, max_len=JAMBA_MAX_LEN, device=dev)
               for _ in range(JAMBA_REPLICAS)]
    queues: list[list] = [[] for _ in range(JAMBA_REPLICAS)]
    for i in range(JAMBA_REQUESTS):
        req = Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lens[i]).astype(np.int32),
                      max_new_tokens=JAMBA_NEW, session_key=int(sessions[i]))
        queues[sched.route(req.session_key, cost_tokens=JAMBA_NEW)].append(req)
    warm = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)), device=dev)
    _, cache = model.prefill(params, {"tokens": warm}, cfg, pol, max_len=264)
    model.decode_step(params, cache, warm[:, -1:], cfg, pol)  # untimed warm-up
    del cache
    _zero_launch_counts()
    rec = _timed_serving(model, engines, queues, "24 (a)")
    serve_launches = _launch_counts()
    reqs = [r for q in queues for r in q]
    assert len(reqs) == JAMBA_REQUESTS
    for r in reqs:
        assert len(r.out_tokens) == JAMBA_NEW and r.done, (r.rid, r.out_tokens)
        assert all(0 <= x < cfg.vocab_size for x in r.out_tokens), (r.rid, r.out_tokens)
    calls = rec["prefill"] + rec["decode"]
    assert calls and all(c["finite"] for c in calls), "non-finite logits"
    assert {c["flash"] for c in rec["prefill"]} == {attn_layers}, rec["prefill"]
    assert {c["flash"] for c in rec["decode"]} == {0}, "a decoded token ran flash"
    assert {c["dispatch"] for c in rec["prefill"]} == {2 * moe_layers}, rec["prefill"]
    assert {c["dispatch"] for c in rec["decode"]} == {moe_layers}, rec["decode"]
    tokens = sum(len(r.out_tokens) for r in reqs)
    by_len: dict[int, list] = {}
    for c in rec["prefill"]:
        by_len.setdefault(c["len"], []).append(c["wall"] * 1e3)
    decode_ms = statistics.median(c["wall"] for c in rec["decode"]) * 1e3
    log(f"phase 24 (a): DRScheduler({JAMBA_REPLICAS}) x ServeEngine({JAMBA_SLOTS} slots): "
        f"{JAMBA_REQUESTS} requests served, prompts {sorted(lens.tolist())} tokens, "
        f"{JAMBA_NEW} new each: {tokens} tokens in {rec['serve_s']:.2f} s "
        f"({tokens / rec['serve_s']:.1f} tokens/s); prefill wall by prompt length (median ms): "
        + ", ".join(f"{n}: {statistics.median(w):.1f} (x{len(w)})" for n, w in sorted(by_len.items()))
        + f"; decode wall a token median {decode_ms:.2f} ms over {len(rec['decode'])} steps; "
        f"launches a prefill: flash {attn_layers}, dispatch_count {2 * moe_layers} (moe_apply: "
        f"two hops a MoE layer); a decoded token: flash 0, dispatch_count {moe_layers} "
        f"(moe_apply_replicated); in all {serve_launches}; routed {sched.routed}, imbalance "
        f"{sched.imbalance():.2f}; all logits finite; card {card}")
    del engines, queues, reqs
    bad = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 300)), device=dev)
    try:
        model.prefill(params, {"tokens": bad}, cfg, pol, max_len=304)
    except ValueError as e:
        assert "chunk contract" in str(e), e
        log(f"phase 24 (a): a 300-token prompt: model.prefill raised ValueError ({e})")
    else:
        raise AssertionError("a 300-token prompt was prefilled: the chunk contract is gone")
    t = time.perf_counter()
    prof = profile_serving(model, params, cfg, pol, rng, dev, 1040, phase="24 (a)", reps=1,
                           names=("dispatch_rank_kernel", "flash"))
    pre, dec = prof["prefill of 1024 tokens"], prof["8 decode steps after it"]
    log(f"phase 24 (a): {pre['device_ops']:,} device operations a 1,024-token prefill "
        f"(busy {pre['busy_ms']:.2f} ms, idle {100 * pre['idle']:.1f}%), "
        f"{dec['device_ops'] / 8:,.0f} a decoded token (busy {dec['busy_ms'] / 8:.2f} ms a "
        f"token, idle {100 * dec['idle']:.1f}%); the profile took "
        f"{time.perf_counter() - t:.1f} s; card {card}")
    # the top-2 hops' dispatch_count inputs of a 1,024-token prefill and a
    # decoded token, for (f)
    hops = []
    orig_slots = ops.dispatch_slots

    def slots_capture(dest, valid=None, *, num_parts):
        hops.append((dest.clone(), None if valid is None else valid.clone(), num_parts))
        return orig_slots(dest, valid, num_parts=num_parts)

    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 1024)), device=dev)
    ops.dispatch_slots = slots_capture
    try:
        _, cache = model.prefill(params, {"tokens": toks}, cfg, pol, max_len=1040)
        hops = hops[:2]
        model.decode_step(params, cache, toks[:, -1:], cfg, pol)
        hops = hops[:3]
    finally:
        ops.dispatch_slots = orig_slots
    del cache, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 24 (a): {time.perf_counter() - t_phase:.1f} s so far; memory allocated after "
        f"freeing the cut {torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # ---- (b) one Mamba mixer alone at full width ---------------------------
    mamba_alone(dev, card, full)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) teacher-forced in float32 on one (Mamba, dense) layer ---------
    t = time.perf_counter()
    one = dataclasses.replace(full, num_layers=1, pattern=full.pattern[:1])
    f32 = Policy()
    p32 = model.init_params(one, 0, f32, device=dev)
    n32 = sum(x.numel() for x in leaves(p32))
    tf = {(pf, n): _teacher_forced(model, p32, one, f32, dev, rng, pf, n)
          for pf, n in ((255, 256), (256, 512))}
    log(f"phase 24 (c): teacher-forced, float32 at full width on one (mamba, dense) layer "
        f"({n32:,} parameters, {4 * n32 / 1e9:.1f} GB): " + "; ".join(
            f"{pf} prefilled + {n - pf} decoded against {n} prefilled: largest logit difference "
            f"{d:.3g} (limit {TEACHER_TOL} x (1 + |logit|))" for (pf, n), d in tf.items())
        + f"; {time.perf_counter() - t:.1f} s")
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) training two (Mamba, dense) layers at full width --------------
    tcfg = dataclasses.replace(full, num_layers=JAMBA_TRAIN_LAYERS, pattern=full.pattern[:1])
    tpol = Policy(param_dtype=bf16, compute_dtype=bf16, remat=True)
    opt_cfg = OptConfig()
    params = model.init_params(tcfg, 0, tpol, device=dev)
    n_train = sum(x.numel() for x in leaves(params))
    opt = init_opt(params, opt_cfg)
    step = make_train_step(tcfg, tpol, opt_cfg)
    stream = list(lm_token_stream(JAMBA_STEPS, JAMBA_BATCH, TRAIN_SEQ + 1, tcfg.vocab_size,
                                  seed=24))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    walls, ms = [], []
    for toks in stream:
        batch = _lm_batch(toks, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        m = {k: v.cpu() for k, v in m.items()}
        walls.append((time.perf_counter() - t) * 1e3)
        assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"])), m
        ms.append(m)
    train_launches = _launch_counts()
    # the training cut holds no attention layer: neither flash kernel runs
    assert train_launches["flash_attention"] == train_launches["flash_attention_bwd"] == 0, \
        train_launches
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert peak < JAMBA_PEAK_LIMIT / 1e9, f"(d)'s training peak {peak:.2f} GB"
    wall = statistics.median(walls[1:])
    tok = JAMBA_BATCH * TRAIN_SEQ
    log(f"phase 24 (d): {tcfg.name} cut to {JAMBA_TRAIN_LAYERS} (mamba, dense) layers at full "
        f"width ({n_train:,} parameters bf16, float32 moments, Policy(remat=True)): "
        f"{JAMBA_STEPS} steps of {JAMBA_BATCH} x {TRAIN_SEQ} lm_token_stream tokens: losses "
        f"{[round(float(m['loss']), 4) for m in ms]}, grad_norm "
        f"{[round(float(m['grad_norm']), 3) for m in ms]}; step walls (ms) "
        f"{[round(w, 1) for w in walls]}: median of steps 2-{JAMBA_STEPS} {wall:.1f} ms, "
        f"{tok / wall * 1e3:,.0f} tokens/s; peak memory {peak:.2f} GB (limit "
        f"{JAMBA_PEAK_LIMIT / 1e9:.0f}); launches in the {JAMBA_STEPS} steps {train_launches} "
        f"(no attention layer, so no flash forward or backward); card {card}")
    prof = _profiled_step(lambda: step(params, opt, _lm_batch(stream[1], dev)))
    log(f"phase 24 (d): one profiled step: wall {prof['wall_ms']:.2f} ms (profiled), device "
        f"busy {prof['busy_ms']:.2f} ms, idle {100 * prof['idle']:.1f}%, "
        f"{prof['device_ops']:,} device operations; card {card}")
    for name, t_ms in prof["top"]:
        log(f"phase 24 (d):   {t_ms:9.3f} ms {100 * t_ms / prof['busy_ms']:5.1f}%  {name[:90]}")
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    start = [v.detach().to("cpu", copy=True) for v in leaves(params)]
    one_batch = _lm_batch(stream[0], dev)
    tried = {}
    for lr in JAMBA_OVERFIT_LRS:
        with torch.no_grad():
            for v, h in zip(leaves(params), start):
                v.copy_(h)
        over_cfg = OptConfig(lr=lr, warmup=1)
        opt = init_opt(params, over_cfg)
        over = make_train_step(tcfg, tpol, over_cfg)
        losses = []
        for _ in range(JAMBA_OVERFIT_STEPS):
            params, opt, m = over(params, opt, one_batch)
            losses.append(float(m["loss"]))
        tried[lr] = losses
        del opt, over
        if all(np.isfinite(losses)) and losses[-1] < losses[0]:
            break
    log(f"phase 24 (d): one batch of {JAMBA_BATCH} x {TRAIN_SEQ} repeated for "
        f"{JAMBA_OVERFIT_STEPS} steps from (d)'s parameters, fresh moments, "
        f"OptConfig(lr, warmup=1), the rates in turn: " + "; ".join(
            f"lr {lr:g}: {[round(v, 4) for v in ls]}" for lr, ls in tried.items())
        + f"; {time.perf_counter() - t_phase:.1f} s so far")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], tried
    del params, start, one_batch, step, stream
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) the smoke config, card against CPU; remat bit-equal -----------
    scfg = reduce_for_smoke(full)
    for shards in (0, EP_SHARDS):
        spol = Policy(ep_shards=shards, exchange_backend="dense" if shards else None)
        smoke_card_against_cpu(dev, scfg, rng, 12, 32, "24 (e)", spol)
    sb = [_lm_batch(x, dev) for x in lm_token_stream(2, 2, 33, scfg.vocab_size, seed=241)]
    remat = _remat_runs(dev, scfg, dict(ep_shards=EP_SHARDS, exchange_backend="dense"),
                        {"no remat": {}, "nothing": dict(remat=True, remat_policy="nothing"),
                         "save_moe": dict(remat=True, remat_policy="save_moe")},
                        OptConfig(lr=1e-3, warmup=1), sb, "e", card, phase=24)
    log(f"phase 24 (e): {time.perf_counter() - t_phase:.1f} s so far")

    # ---- (f) the kernels at jamba's shapes --------------------------------
    g, hd = full.num_kv_heads, full.head_dim
    pp = full.num_heads // g
    checked = check_flash_shapes(
        dev, card, {f"B {b}": (b, g, pp, TRAIN_SEQ, TRAIN_SEQ, hd, True) for b in (1, 2)},
        "24 (f)", seed=24)
    dc_rows = {}
    for name, (dest, valid, parts) in zip(("hop 1", "hop 2", "decode"), hops):
        valid = torch.ones_like(dest, dtype=torch.bool) if valid is None else valid
        dest = dest.to(torch.int32).contiguous()
        got = dispatch_count(dest, valid, num_parts=parts)
        want = dispatch_count_plain(dest, valid, num_parts=parts)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        w, n = dest.shape
        nbytes = w * n * (4 + 1) + w * n * 4 + w * parts * 4
        fn = lambda: dispatch_count(dest, valid, num_parts=parts)
        k_ms, d_ms = cuda_ms(fn), device_ms(fn)
        p_ms = cuda_ms(lambda: dispatch_count_plain(dest, valid, num_parts=parts))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        dc_rows[name] = {"shape": f"W={w} n={n} L={parts}", "ms": k_ms, "plain_ms": p_ms,
                         "device_ms": d_ms, "bound_ms": bound, "bound_by": "bytes",
                         "bytes": nbytes, "valid": int(valid.sum()), "library_ms": None}
        log(f"phase 24 (f): dispatch_count [{name}, top-2] W={w} n={n} L={parts} "
            f"({int(valid.sum())} valid): bit-equal to its plain version; {k_ms:.4f} ms by events "
            f"around one call, device time {d_ms:.4f} ms (20 calls behind a spin), plain "
            f"{p_ms:.4f} ms, bound {bound:.6f} ms by bytes ({nbytes} bytes); card {card}")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    trained = f"(d) {JAMBA_STEPS} train steps (no attention layer)"
    launches = {"a prefill": attn_layers, "a decoded token": 0,
                "(a) serving in all": serve_launches["flash_attention"],
                trained: train_launches["flash_attention"]}
    return {"flash_attention": {"launches_phase_24": launches,
                                "phase_24": {k: v["fwd"] for k, v in checked.items()}},
            "flash_attention_bwd": {
                "launches_phase_24": {trained: train_launches["flash_attention_bwd"]},
                "phase_24": {k: v["bwd"] for k, v in checked.items()}},
            "dispatch_count": {
                "launches_phase_24": {
                    "a prefill": 2 * moe_layers, "a decoded token": moe_layers,
                    "(a) serving in all": serve_launches["dispatch_count"],
                    "(e) a smoke step at 4 shards, by run": {
                        k: v["launches_a_step"]["dispatch_count"] for k, v in remat.items()}},
                "phase_24": dc_rows}}


# phase 25: the torch.distributed transport, one worker a process, at phase
# 2's deployment: 8 gloo ranks sharing the card, then a one-rank nccl group
# (NCCL refuses two ranks on one card: dist_probe.py)
DIST_DIR = Path(__file__).resolve().parent / "build" / "phase25"
DIST_WORLD = 8
DIST_JOB = dict(num_partitions=32, state_capacity=262_144, capacity_factor=2.0)
DIST_DR = dict(imbalance_trigger=1.2, migration_cost_weight=0.2)
DIST_BATCHES_B = 4          # (b) and (c): the first 4 of phase 2's batches
NCCL_STATE = 1 << 20        # (c) at W=1: every key of 4 batches on one worker
DIST_SKIP = {"wall_time_s", "exchange_wall_s", "overlap_fraction"}
DIST_TIMEOUT_S = 600.0


def _dist_kernels():
    from repro_torch.kernels.dispatch_count import dispatch_count
    from repro_torch.kernels.lookup_dispatch import lookup_dispatch
    from repro_torch.kernels.route_bucketize import route_bucketize
    return route_bucketize, lookup_dispatch, dispatch_count


def _dist_drive(g, job, name, batches) -> dict:
    """One rank's run of ``batches`` (as ``drive``): launches and the audit
    set to 0 just before, the wall of the run and one drain per batch, the
    telemetry's phase walls, the bytes handed to the group, the metrics."""
    from repro_torch import compat

    kernels = _dist_kernels()
    walls = phase_walls(job)
    traffic = dict(g.traffic)
    g.barrier()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    compat.reset_host_sync_count()
    t = time.perf_counter()
    ms = feed(job, name, batches)
    job._drain_inflight()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / len(batches) * 1e3
    return dict(
        metrics=[dataclasses.asdict(m) for m in ms], wall_ms=wall_ms,
        syncs=compat.host_sync_count(), walls=dict(walls),
        launches={k.__name__: k.launches for k in kernels},
        traffic={k: g.traffic[k] - traffic[k] for k in traffic})


def _dist_record(g, job, rec: dict, keep_state: bool) -> dict:
    """The gathered final state (kept by rank 0) and this rank's decisions."""
    keys, vals = job.state_keys.cpu().numpy(), job.state_vals.cpu().numpy()
    if keep_state:
        rec["keys"], rec["vals"] = keys, vals
    rec["decisions"] = [(d.tick, d.kind, d.taken, d.reason, d.imbalance,
                         sorted(d.detail.items())) for d in job.drm.decisions.records]
    return rec


def _dist_ship_ms(g, job, batch, reps=5) -> tuple[list, int]:
    """Walls (ms) of the shuffle's ``a2a_finish`` alone on one started
    batch, synchronized, the ranks lined up by a barrier before each; and
    the bytes one ship hands the group."""
    step = job._shuffle
    pending, _ = step.start(job._tables(), *job._upload(batch, None), None)
    torch.cuda.synchronize()
    before = sum(g.traffic.values())
    out = []
    for _ in range(reps):
        g.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.exchange.finish(pending)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out, (sum(g.traffic.values()) - before) // reps


def _ragged_plain_ms(job, batch) -> dict:
    """Events ms of the native ragged ship's two plain torch steps on one
    started batch's send set, without the collective: the compaction of
    each lane's counted rows, and the scatter of as many rows into receive
    buffers filled with each payload's fill."""
    from repro_torch.compat import host_fetch

    pending, _ = job._shuffle.start(job._tables(), *job._upload(batch, None), None)
    b = pending.buffers
    counts = b.lane_counts[0]
    slots = torch.arange(b.valid.shape[2], device=counts.device, dtype=torch.int32)
    live = slots[None, :] < counts[:, None]
    rows = [p[0][live] for p in b.payloads]

    def compact():
        m = slots[None, :] < counts[:, None]
        return [p[0][m] for p in b.payloads]

    def scatter():
        m = slots[None, :] < counts[:, None]
        for p, f, r in zip(b.payloads, b.fills, rows):
            full = torch.full_like(p[0], f)
            full[m] = r
        return m

    n = int(host_fetch(counts.sum()))
    return {"rows": n, "compact_ms": cuda_ms(compact), "scatter_ms": cuda_ms(scatter)}


def _route_check(job, batch, lanes) -> dict:
    """This rank's ``route_bucketize`` on its chunk of ``batch`` (``[1,
    n]``) under the job's partitioner, splits on, against its plain
    version: equal bit for bit?"""
    from repro_torch.kernels import ops
    from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain

    k, v, valid = job._upload(batch, None)
    part, tables = job.drm.partitioner, job._tables()
    hk, hp, hr = ops.pad_heavy_tables(tables, num_partitions=job.num_partitions,
                                      pad_empty=True)
    args = (k, valid, v, hk, hp, tables.host_to_part, hr)
    kw = dict(seed=part.seed, num_hosts=part.num_hosts, num_lanes=lanes,
              capacity=job._shuffle_spec.capacity, key_fill=SENT,
              num_partitions=job.num_partitions)
    got, want = route_bucketize(*args, **kw), route_bucketize_plain(*args, **kw)
    torch.cuda.synchronize()
    return dict(shape=tuple(k.shape), lanes=lanes, capacity=kw["capacity"],
                heavy=part.num_heavy, equal=all(torch.equal(a, b) for a, b in zip(got, want)),
                max_abs_err=max_abs_err(got, want))


def dist_rank(rank: int, world: int, plan: dict) -> None:
    """Phase 25's rank ``rank`` of ``world``: joins the ``plan["backend"]``
    group through a ``file://`` store in the git-ignored build directory,
    loads the library the parent built, runs the jobs of ``plan["part"]``
    over phase 2's batches (saved by the parent) and saves what it saw
    beside the store; the parent compares.  A failure raises, and the
    parent re-raises it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.set_num_threads(1)
    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.exchange.dist import WorkerGroup
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import exchange_topology_of

    build.library()
    g = WorkerGroup.init(backend=plan["backend"], rank=rank, world_size=world,
                         init_method=f"file://{plan['store']}", device="cuda")
    batches = np.load(plan["batches"], mmap_mode="r")
    batches = [np.array(b) for b in batches[: plan["num_batches"]]]
    out = {"rank": rank, "jobs": {}}

    def job_of(backend="dense", topology=None, **extra):
        return StreamingJob(group=g, dr=DRConfig(**DIST_DR, **extra), exchange_backend=backend,
                            topology=topology, **plan["job"])

    if plan["part"] == "ab":
        # warm-up, untimed: the first collectives and the caching allocators
        job_of(overlap_exchange=False).run(batches[:1])
        for name, extra in DRIVERS.items():
            job = job_of(**extra)
            rec = _dist_drive(g, job, name, batches)
            out["jobs"][f"(a) {name}"] = _dist_record(g, job, rec, rank == 0)
            if name == "serial":
                g.barrier()
                if rank == 0:
                    out["memory"] = dict(
                        smi=subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total",
                                            "--format=csv,noheader"], capture_output=True,
                                           text=True).stdout.strip(),
                        mem_get_info=torch.cuda.mem_get_info())
                    out["route check"] = _route_check(job, batches[0], world)
                rec["ship_ms"], rec["ship_bytes"] = _dist_ship_ms(g, job, batches[-1])
            if name == "depth 1":
                # the card's idle share over 2 steady batches, seen from rank 0
                job.dr_enabled = False
                if rank == 0:
                    out["idle"] = device_idle_share(job, batches[:2])
                else:
                    job.run(batches[:2])
                    job.state_keys
            if name == "depth 2":
                # the audit's contract at depth 2: no sync outside a safe
                # point once no action drains the pipeline
                job.dr_enabled = False
                rec["steady"] = _dist_drive(g, job, name, batches[:3])
            del job
        # (b) the other backends, serial, 4 batches
        out["topology"] = exchange_topology_of(group=g)
        for name, backend, masked, g_host in (
                ("ragged, native", "ragged", False, None),
                ("ragged, REPRO_DISABLE_NATIVE_RAGGED=1", "ragged", True, None),
                ("hierarchical, lanes_per_host=4", "hierarchical", False, 4)):
            if masked:
                os.environ["REPRO_DISABLE_NATIVE_RAGGED"] = "1"
            topo = None if g_host is None else exchange_topology_of(group=g, lanes_per_host=g_host)
            job = job_of(backend, topo, overlap_exchange=False)
            rec = _dist_drive(g, job, "serial", batches[:DIST_BATCHES_B])
            rec["ship_ms"], rec["ship_bytes"] = _dist_ship_ms(g, job, batches[DIST_BATCHES_B - 1])
            if name == "ragged, native":  # its start phase is collective: every rank
                out["ragged plain"] = _ragged_plain_ms(job, batches[DIST_BATCHES_B - 1])
            out["jobs"][f"(b) {name}"] = _dist_record(g, job, rec, rank == 0)
            if backend == "ragged":
                # depth 2, policies off, 3 batches: the host syncs outside a
                # safe point this ship costs (the native one fetches its
                # split sizes)
                del job
                job = job_of(backend, None, pipeline_depth=2)
                job.dr_enabled = False
                rec["depth 2"] = _dist_drive(g, job, "depth 2", batches[:3])
            os.environ.pop("REPRO_DISABLE_NATIVE_RAGGED", None)
            del job
    else:
        for backend in ("dense", "ragged"):
            job = job_of(backend, overlap_exchange=False)
            rec = _dist_drive(g, job, "serial", batches)
            rec["ship_ms"], rec["ship_bytes"] = _dist_ship_ms(g, job, batches[-1])
            out["jobs"][f"(c) {backend}"] = _dist_record(g, job, rec, rank == 0)
            del job
    g.close()
    torch.save(out, Path(plan["store"]).with_name(f"{Path(plan['store']).name}.rank{rank}.pt"))


def _same_metrics(want, got: list[dict], tag) -> None:
    """``got`` (dicts) equal to ``want`` (BatchMetrics) but the walls."""
    assert len(want) == len(got), (tag, len(want), len(got))
    for a, b in zip(want, got):
        da = {k: v for k, v in dataclasses.asdict(a).items() if k not in DIST_SKIP}
        db = {k: v for k, v in b.items() if k not in DIST_SKIP}
        diff = {k: (da[k], db[k]) for k in da if da[k] != db[k]}
        assert not diff, (tag, a.batch, diff)


def _same_state(rec, keys, vals, tag) -> None:
    assert torch.equal(torch.from_numpy(rec["keys"]), keys.cpu()), (tag, "keys")
    assert torch.equal(torch.from_numpy(rec["vals"]), vals.cpu()), (tag, "vals")


def _ranks_agree(ranks, job) -> None:
    """Every rank logged the same decisions and the same metrics but the
    walls."""
    first = ranks[0]["jobs"][job]
    for r in ranks[1:]:
        rec = r["jobs"][job]
        assert rec["decisions"] == first["decisions"], (job, r["rank"])
        for a, b in zip(first["metrics"], rec["metrics"], strict=True):
            assert ({k: v for k, v in a.items() if k not in DIST_SKIP}
                    == {k: v for k, v in b.items() if k not in DIST_SKIP}), (job, r["rank"])


def dist_phase(dev, card, batches, phase2, exact) -> dict:
    """Phase 25: phase 2's deployment over 8 gloo processes sharing the
    card, one worker each, by the three drivers, then the other backends,
    then a one-rank nccl group.  Returns the route kernels' and
    dispatch_count's ``launches_phase_25``."""
    import shutil

    from repro_torch.core.drm import DRConfig
    from repro_torch.core.streaming import StreamingJob
    from repro_torch.exchange import ExchangeTopology
    from repro_torch.exchange.backends import _transposed

    t_phase = time.perf_counter()
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    np.save(DIST_DIR / "batches.npy", np.stack(batches))
    names = ("route_bucketize", "lookup_dispatch", "dispatch_count")
    launches = {k: {} for k in names}

    # the stacked runs (b) and (c) are held to, on the card
    stacked = {}
    for name, backend, topo, w, state in (
            ("ragged", "ragged", None, DIST_WORLD, DIST_JOB["state_capacity"]),
            ("hierarchical", "hierarchical", ExchangeTopology(8, 4), DIST_WORLD,
             DIST_JOB["state_capacity"]),
            ("W=1 dense", "dense", None, 1, NCCL_STATE),
            ("W=1 ragged", "ragged", None, 1, NCCL_STATE)):
        job = StreamingJob(device="cuda", num_workers=w, exchange_backend=backend, topology=topo,
                           dr=DRConfig(**DIST_DR, overlap_exchange=False),
                           **{**DIST_JOB, "state_capacity": state})
        job.run(batches[:DIST_BATCHES_B])
        stacked[name] = (job.metrics, job.state_keys.cpu(), job.state_vals.cpu())
        del job
    # phase 2's flat transpose of one batch's send set, for the ship walls
    job = StreamingJob(device="cuda", num_workers=DIST_WORLD,
                       dr=DRConfig(**DIST_DR, overlap_exchange=False), **DIST_JOB)
    job.process_batch(batches[0])
    pending, _ = job._shuffle.start(job._tables(), *job._upload(batches[-1], None), None)
    send = (pending.buffers.valid, *pending.buffers.payloads)
    transpose_ms = cuda_ms(lambda: [_transposed(t) for t in send])
    send_bytes = sum(t.numel() * t.element_size() for t in send)
    del job, pending, send
    torch.cuda.empty_cache()
    log(f"phase 25: stacked runs for (b) and (c) and phase 2's transpose in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ---- (a) and (b): 8 gloo ranks on the one card ----------------------
    t = time.perf_counter()
    ranks = spawn_ranks(dist_rank, DIST_WORLD, dict(
        backend="gloo", part="ab", store=str(DIST_DIR / "gloo8"), job=DIST_JOB,
        batches=str(DIST_DIR / "batches.npy"), num_batches=len(batches)), DIST_TIMEOUT_S, 25)
    log(f"phase 25: 8 gloo ranks spawned, ran (a) and (b) and joined in "
        f"{time.perf_counter() - t:.1f} s (gloo takes the CUDA tensors and stages them "
        f"through host memory inside each collective); card memory in use with all 8 up "
        f"{ranks[0]['memory']['smi']} (nvidia-smi memory.used, memory.total); "
        f"topology read by exchange_topology_of(group=) with no override: "
        f"{ranks[0]['topology']}")
    assert ranks[0]["topology"].lanes_per_host == DIST_WORLD, ranks[0]["topology"]
    rc = ranks[0]["route check"]
    assert rc["equal"], rc
    log(f"phase 25 (a): rank 0's route_bucketize at {rc['shape']}, L {rc['lanes']}, cap "
        f"{rc['capacity']:,}, {rc['heavy']} heavy keys, splits on: equal to its plain version "
        f"bit for bit (max abs err {rc['max_abs_err']})")
    for name in DRIVERS:
        job = f"(a) {name}"
        rec = ranks[0]["jobs"][job]
        _same_metrics(phase2[name]["ms"], rec["metrics"], job)
        _same_state(rec, *phase2[name]["final"], job)
        _ranks_agree(ranks, job)
        ms = rec["metrics"]
        assert all(m["overflow"] == 0 for m in ms), job
        for key, want in exact:
            got = float(rec["vals"][rec["keys"] == key].sum())
            assert got == want, (job, key, got, want)
        per_rank = [r["jobs"][job]["launches"] for r in ranks]
        assert all(x["route_bucketize"] > 0 and x["lookup_dispatch"] > 0 for x in per_rank), \
            (job, per_rank)
        for k in names:
            launches[k][job] = [x[k] for x in per_rank]
        wall_max = [max(r["jobs"][job]["metrics"][i]["wall_time_s"] for r in ranks) * 1e3
                    for i in range(len(ms))]
        run_ms = max(r["jobs"][job]["wall_ms"] for r in ranks)
        walls = {k: max(r["jobs"][job]["walls"][k] for r in ranks) * 1e3
                 for k in ("count", "ship", "hidden")}
        syncs = [r["jobs"][job]["syncs"] for r in ranks]
        sent = sum(r["jobs"][job]["traffic"]["all_to_all"] for r in ranks) / len(ms)
        log(f"phase 25 (a): {name}, 8 processes x 1 worker, gloo: every metric but the walls "
            f"equal to phase 2's {name} run, state equal, 64 exact counts, no overflow, every "
            f"rank's DecisionLog equal; repartitions at "
            f"{[m['batch'] for m in ms if m['repartitioned']]}; wall per batch {run_ms:.2f} "
            f"ms (run + one drain / {len(ms)}, max over ranks; phase 2: "
            f"{phase2[name]['wall_ms']:.2f} ms); host walls a batch, max over ranks "
            f"{[round(x, 2) for x in wall_max]} ms; telemetry walls, max over ranks: count "
            f"{walls['count']:.2f} ms, ship {walls['ship']:.2f} ms, hidden "
            f"{walls['hidden']:.2f} ms; all_to_all bytes a batch, all ranks {sent:,.0f}; "
            f"host syncs outside safe points by rank {syncs}; launches a rank "
            f"{ {k: launches[k][job] for k in names} }")
        if name == "serial":
            ship = [max(r["jobs"][job]["ship_ms"][i] for r in ranks) for i in range(5)]
            log(f"phase 25 (a): the dense ship (a2a_finish) of one batch: mask, keys, values "
                f"and partitions, {rec['ship_bytes']:,} bytes a rank through gloo ("
                f"{rec['ship_bytes'] * DIST_WORLD:,} in all), synchronized walls, max over "
                f"ranks, {[round(x, 2) for x in ship]} ms; phase 2's stacked transpose of the "
                f"same {send_bytes:,} bytes {transpose_ms:.4f} ms (events)")
        if name == "depth 2":
            steady = [r["jobs"][job]["steady"] for r in ranks]
            assert all(s["syncs"] == 0 for s in steady), [s["syncs"] for s in steady]
            assert all(all(m["pipelined"] for m in s["metrics"][1:]) for s in steady)
            log(f"phase 25 (a): depth 2, policies off, 3 more batches: 0 host syncs outside "
                f"safe points on every rank, every batch after the first pipelined; wall per "
                f"batch {max(s['wall_ms'] for s in steady):.2f} ms (max over ranks)")
    idle = ranks[0]["idle"]
    log(f"phase 25 (a): depth 1, policies off, 2 batches and a drain under the profiler on rank "
        f"0: wall {idle['wall_ms']:.2f} ms, rank 0's device busy {idle['busy_ms']:.2f} ms, idle "
        f"{100 * idle['idle']:.1f}% (seen from one rank: the other 7 share the card); card "
        f"{card}")
    for name, ref in (("ragged, native", "ragged"),
                      ("ragged, REPRO_DISABLE_NATIVE_RAGGED=1", "ragged"),
                      ("hierarchical, lanes_per_host=4", "hierarchical")):
        job = f"(b) {name}"
        rec = ranks[0]["jobs"][job]
        ms, keys, vals = stacked[ref]
        _same_metrics(ms, rec["metrics"], job)
        _same_state(rec, keys, vals, job)
        _ranks_agree(ranks, job)
        for k in names:
            launches[k][job] = [r["jobs"][job]["launches"][k] for r in ranks]
        traffic = {k: sum(r["jobs"][job]["traffic"][k] for r in ranks) / DIST_BATCHES_B
                   for k in ("all_to_all", "all_to_all_uneven")}
        ship = [max(r["jobs"][job]["ship_ms"][i] for r in ranks) for i in range(5)]
        log(f"phase 25 (b): {name}, serial, {DIST_BATCHES_B} batches: every metric but the "
            f"walls and the state equal to the stacked {ref} run on the card; shipped rows a "
            f"worker {[m['shipped_rows'] for m in rec['metrics']]} (padded "
            f"{[m['padded_rows'] for m in rec['metrics']]}), by class "
            f"{[m['shipped_rows_by_class'] for m in rec['metrics']]}; bytes a batch, all "
            f"ranks: dense all_to_all {traffic['all_to_all']:,.0f}, uneven all_to_all "
            f"{traffic['all_to_all_uneven']:,.0f}; one ship {ranks[0]['jobs'][job]['ship_bytes']:,} "
            f"bytes a rank, walls (max over ranks) {[round(x, 2) for x in ship]} ms; wall per "
            f"batch {max(r['jobs'][job]['wall_ms'] for r in ranks):.2f} ms")
        if ref == "ragged":
            deep = [r["jobs"][job]["depth 2"] for r in ranks]
            syncs = [d["syncs"] for d in deep]
            if "DISABLE" in name:  # the masked ship keeps depth 2's contract
                assert all(x == 0 for x in syncs), (job, syncs)
            log(f"phase 25 (b): {name}, depth 2, policies off, 3 batches: host syncs outside "
                f"safe points by rank {syncs}; pipelined "
                f"{[m['pipelined'] for m in deep[0]['metrics']]}; wall per batch "
                f"{max(d['wall_ms'] for d in deep):.2f} ms (max over ranks)")
    rp = ranks[0]["ragged plain"]
    log(f"phase 25 (b): the native ragged ship's plain steps on rank 0 ({rp['rows']:,} counted "
        f"rows of one batch): compaction {rp['compact_ms']:.4f} ms, scatter into filled receive "
        f"buffers {rp['scatter_ms']:.4f} ms (events); card {card}")
    del ranks

    # ---- (c) a one-rank nccl group -------------------------------------
    t = time.perf_counter()
    ranks = spawn_ranks(dist_rank, 1, dict(
        backend="nccl", part="c", store=str(DIST_DIR / "nccl1"),
        job={**DIST_JOB, "state_capacity": NCCL_STATE},
        batches=str(DIST_DIR / "batches.npy"), num_batches=DIST_BATCHES_B), DIST_TIMEOUT_S, 25)
    for backend in ("dense", "ragged"):
        job = f"(c) {backend}"
        rec = ranks[0]["jobs"][job]
        ms, keys, vals = stacked[f"W=1 {backend}"]
        _same_metrics(ms, rec["metrics"], job)
        _same_state(rec, keys, vals, job)
        for k in names:
            launches[k][job] = [rec["launches"][k]]
        log(f"phase 25 (c): {backend}, one nccl rank, W=1, {DIST_BATCHES_B} batches: every "
            f"metric but the walls and the state equal to the stacked W=1 run on the card; "
            f"wall per batch {rec['wall_ms']:.2f} ms; one ship {rec['ship_bytes']:,} bytes, "
            f"walls {[round(x, 2) for x in rec['ship_ms']]} ms; launches "
            f"{ {k: rec['launches'][k] for k in names} }")
    log(f"phase 25 (c): joined in {time.perf_counter() - t:.1f} s")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return {k: {"launches_phase_25": launches[k]} for k in names}


# phase 26: int8 gradient sync, the GPipe pipeline and the sharding rules over
# the process group, training stablelm-1.6b at full width, 12 of 24 layers
TRAIN_DIST_DIR = Path(__file__).resolve().parent / "build" / "phase26"
STABLELM = "stablelm-1.6b"
STABLELM_LAYERS = 12       # of its 24: the whole run's time limit, once phase 28 came
DP_WORLD = 2
DP_BATCH = 2               # a rank's own seeded 2 x 1,024 tokens
DP_STEPS = 2
PP_STAGES = (2, 4)
PP_MICRO = 4
PP_BATCH = 4               # 4 microbatches of 1 x 1,024 tokens
PP_LOSS_RTOL = 2e-4        # the reference's own test's limit (tests/test_pipeline.py)
PP_GRAD_REL = 1e-3         # a leaf's |pipelined - plain| / |plain|
PP_BF16_STEPS = 2          # timed bf16 steps after one untimed
EF_TOL = 1e-5              # the error-feedback identity (tests/test_compression_elastic.py)
TRAIN_DIST_TIMEOUT_S = 420.0


def _stablelm_policy(dtype):
    from repro_torch.models.modules import Policy

    return Policy(param_dtype=dtype, compute_dtype=dtype, remat=True)


def _leaf_paths(tree, offset=0) -> list[str]:
    """The paths of ``tree``'s leaves in ``leaves`` order; a stage's local
    layer ``i`` is named by its global index ``offset + i``."""
    from repro_torch.launch.sharding import _tree_paths

    out = []
    for path, _ in _tree_paths(tree):
        parts = path.split("/")
        if parts[0] == "layers":
            parts[1] = str(int(parts[1]) + offset)
        out.append("/".join(parts))
    return out


def _ef_leaf(cfg) -> str:
    """The leaf (a) reads the error-feedback identity on: the last layer's
    attention output projection."""
    return f"layers/{cfg.num_layers - 1}/attn/wo"


def _digest(tensors) -> str:
    """sha256 over the bytes of ``tensors`` (copied to the host)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def _dp_rank(g, out: dict) -> None:
    """(a): stablelm-1.6b at full width, 12 of 24 layers, default_options' dtypes,
    this rank's own seeded batches; each step grads, compressed_grad_sync,
    apply_updates."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import default_options
    from repro_torch.models import model
    from repro_torch.train.compression import compressed_grad_sync, init_error_feedback
    from repro_torch.train.optimizer import OptConfig, apply_updates, init_opt, leaves
    from repro_torch.train.train_step import trainable

    cfg = dataclasses.replace(get_config(STABLELM), num_layers=STABLELM_LAYERS)
    opts = default_options(cfg)
    pol = _stablelm_policy(opts.param_dtype)
    opt_cfg = OptConfig(moment_dtype=opts.moment_dtype)
    params = trainable(model.init_params(cfg, 0, pol))
    flat = leaves(params)
    li = _leaf_paths(params).index(_ef_leaf(cfg))
    opt = init_opt(params, opt_cfg)
    err = init_error_feedback(params)
    sync = compressed_grad_sync(g, MeshShape((g.world_size,), ("data",)))
    rng = np.random.default_rng(1000 + g.rank)
    true_sum = torch.zeros_like(flat[li], dtype=torch.float32)
    synced_sum = torch.zeros_like(true_sum)
    steps = []
    _zero_launch_counts()
    for _ in range(DP_STEPS):
        batch = _lm_batch(rng.integers(0, cfg.vocab_size, (DP_BATCH, TRAIN_SEQ + 1)), g.device)
        g.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(params, batch, cfg, pol)
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        true_sum += grads[li].float()
        before = g.traffic["all_reduce"]
        mean, err = sync(grads, err)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads
        synced_sum += mean[li]
        params, opt, metrics = apply_updates(params, mean, opt, opt_cfg)
        del mean
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        steps.append(dict(loss=float(loss.detach()), grad_norm=float(metrics["grad_norm"]),
                          grads_ms=(t1 - t0) * 1e3, sync_ms=(t2 - t1) * 1e3,
                          update_ms=(t3 - t2) * 1e3, step_ms=(t3 - t0) * 1e3,
                          bytes=g.traffic["all_reduce"] - before, digest=_digest(flat)))
    out.update(steps=steps, launches=_launch_counts(), peak=torch.cuda.max_memory_allocated(),
               true_sum=true_sum.cpu(), synced_sum=synced_sum.cpu(),
               final_error=leaves(err)[li].cpu(), n_params=sum(p.numel() for p in flat))


def _pp_batch(vocab: int, dev):
    return _lm_batch(np.random.default_rng(26).integers(0, vocab, (PP_BATCH, TRAIN_SEQ + 1)),
                     dev)


def _pp_rank(g, plan: dict, out: dict) -> None:
    """(b): one stage a rank at full width, 12 of 24 layers; float32 (TF32 off)
    against the parent's plain loss and gradients, then bf16 steps timed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.pipeline import make_pp_loss, stack_stage_params, stage_params
    from repro_torch.models import model
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import trainable

    cfg = dataclasses.replace(get_config(STABLELM), num_layers=STABLELM_LAYERS)
    n, r = g.world_size, g.rank
    per_stage = cfg.num_layers // n
    batch = _pp_batch(cfg.vocab_size, g.device)

    def stage(dtype):
        params = model.init_params(cfg, 1, _stablelm_policy(dtype))
        mine = trainable(stage_params(stack_stage_params(cfg, params, n), r))
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return mine

    def step(mine, pol):
        loss_fn = make_pp_loss(cfg, pol, g, microbatches=PP_MICRO)
        g.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = loss_fn(mine, batch)
        grads = torch.autograd.grad(loss, leaves(mine))
        torch.cuda.synchronize()
        return loss.detach(), grads, (time.perf_counter() - t) * 1e3

    mine = stage(torch.float32)
    before = g.traffic["shift"]
    _zero_launch_counts()
    loss, grads, wall = step(mine, _stablelm_policy(torch.float32))
    out["f32"] = dict(loss=float(loss), wall_ms=wall, launches=_launch_counts(),
                      shift_bytes=g.traffic["shift"] - before,
                      peak=torch.cuda.max_memory_allocated())
    plain = torch.load(plan["plain"], mmap=True, weights_only=True)
    rel = {}
    for path, got in zip(_leaf_paths(mine, r * per_stage), grads):
        want = plain[path].to(g.device)
        rel[path] = float((got - want).norm() / want.norm().clamp(min=1e-30))
    out["f32"]["rel"] = rel
    del mine, grads, plain
    gc.collect()
    torch.cuda.empty_cache()
    mine = stage(torch.bfloat16)
    pol = _stablelm_policy(torch.bfloat16)
    step(mine, pol)  # untimed: the allocators' blocks
    walls = []
    for _ in range(PP_BF16_STEPS):
        _zero_launch_counts()
        before = dict(g.traffic)
        loss, grads, wall = step(mine, pol)
        walls.append(wall)
    traffic = {k: g.traffic[k] - before[k] for k in ("shift", "all_reduce")}
    # the replicated leaves' gradient sum alone (the backward's one
    # all-reduce: the embedding, the final norm, the head), as the step ran it
    rep = [x for path, x in zip(_leaf_paths(mine), grads) if not path.startswith("layers/")]
    del grads
    sum_ms = []
    for _ in range(2):
        g.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        g.sum(*rep, dtype=rep[0].dtype)
        torch.cuda.synchronize()
        sum_ms.append((time.perf_counter() - t) * 1e3)
    out["bf16"] = dict(loss=float(loss), walls_ms=walls, launches=_launch_counts(),
                       peak=torch.cuda.max_memory_allocated(), traffic=traffic,
                       replicated_sum_ms=sum_ms,
                       replicated_bytes=sum(x.numel() * x.element_size() for x in rep))


def train_dist_rank(rank: int, world: int, plan: dict) -> None:
    """Phase 26's rank ``rank`` of ``world``: joins the gloo group through a
    ``file://`` store in the git-ignored build directory, loads the library
    the parent built, runs ``plan["part"]`` (``dp`` or ``pp``) and saves
    what it saw beside the store; the parent checks.  A failure raises, and
    the parent re-raises it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.exchange.dist import WorkerGroup
    from repro_torch.kernels import build

    build.library()
    g = WorkerGroup.init(backend="gloo", rank=rank, world_size=world,
                         init_method=f"file://{plan['store']}", device="cuda")
    out = {"rank": rank}
    if plan["part"] == "dp":
        _dp_rank(g, out)
    else:
        _pp_rank(g, plan, out)
    g.close()
    torch.save(out, Path(plan["store"]).with_name(f"{Path(plan['store']).name}.rank{rank}.pt"))


def spawn_ranks(target, world: int, plan: dict, timeout_s: float, phase: int) -> list[dict]:
    """Spawn ``world`` ranks of ``target(rank, world, plan)`` (phase 25's
    :func:`dist_rank`, 26's :func:`train_dist_rank`, 27's
    :func:`mesh_rank`) under the spawn start method, wait and return
    what each saved beside ``plan["store"]``; a rank that raises, or a run
    past ``timeout_s`` (a rank waiting on a collective another never
    calls), fails the phase."""
    import torch.multiprocessing as mp

    store = Path(plan["store"])
    store.unlink(missing_ok=True)
    ctx = mp.start_processes(target, args=(world, plan), nprocs=world, start_method="spawn",
                             join=False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"phase {phase}: {world} ranks did not finish in "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(store.with_name(f"{store.name}.rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _sync_world_one(dev, backend: str, store: Path, grads: list, error: list):
    """``compressed_grad_sync`` over a one-rank ``backend`` group in this
    process: ``(mean, error)`` on the card."""
    from repro_torch.exchange.dist import WorkerGroup
    from repro_torch.train.compression import compressed_grad_sync

    store.unlink(missing_ok=True)
    g = WorkerGroup.init(backend=backend, rank=0, world_size=1, init_method=f"file://{store}",
                         device=dev)
    try:
        err = [e.clone() for e in error]
        mean, err = compressed_grad_sync(g)(grads, err)
        torch.cuda.synchronize()
    finally:
        g.close()
    return list(mean), err


def _bytes_per_device(params, specs) -> int:
    """Each leaf's bytes over the product of the mesh axes its spec names."""
    from repro_torch.launch.sharding import _tree_paths

    shard = dict(_tree_paths(specs))
    total = 0
    for path, leaf in _tree_paths(params):
        s = shard[path]
        div = 1
        for ax in s.spec:
            for a in (ax if isinstance(ax, tuple) else (() if ax is None else (ax,))):
                div *= s.mesh.shape[a]
        total += leaf.numel() * leaf.element_size() // div
    return total


def train_dist_phase(dev, card) -> dict:
    """Phase 26: (a) two gloo ranks train stablelm-1.6b data-parallel with
    the int8 error-feedback sync, (b) the GPipe pipeline over 2 and 4 gloo
    stages against the plain model, (c) both flash kernels at stablelm's
    shape, (d) the sharding rules of every registry architecture at both
    production meshes (host only).  Returns the flash rows'
    ``launches_phase_26`` and ``phase_26``."""
    import shutil

    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.launch.mesh import make_production_mesh, tp_size
    from repro_torch.launch.sharding import default_options, param_shardings
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.train.compression import compressed_grad_sync
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.train_step import trainable

    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_DIST_DIR, ignore_errors=True)
    TRAIN_DIST_DIR.mkdir(parents=True)
    cfg = dataclasses.replace(get_config(STABLELM), num_layers=STABLELM_LAYERS)
    launches = {"flash_attention": {}, "flash_attention_bwd": {}}

    # ---- (a) data parallelism with the int8 error-feedback sync ---------
    t = time.perf_counter()
    ranks = spawn_ranks(train_dist_rank, DP_WORLD,
                        dict(part="dp", store=str(TRAIN_DIST_DIR / "dp")), TRAIN_DIST_TIMEOUT_S, 26)
    n_params = ranks[0]["n_params"]
    log(f"phase 26 (a): {STABLELM} at full width ({cfg.num_layers} of 24 layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads}, hd {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size:,}; {n_params:,} parameters, bf16, float32 moments "
        f"and error feedback, remat) on {DP_WORLD} gloo ranks sharing the card, each its own "
        f"seeded {DP_BATCH} x {TRAIN_SEQ} tokens a step; spawned, {DP_STEPS} steps and joined in "
        f"{time.perf_counter() - t:.1f} s; card {card}")
    for i in range(DP_STEPS):
        st = [r["steps"][i] for r in ranks]
        assert len({s["digest"] for s in st}) == 1, [s["digest"] for s in st]
        assert all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"]) for s in st), st
        log(f"phase 26 (a): step {i}: losses by rank {[round(s['loss'], 4) for s in st]}, grad "
            f"norm {st[0]['grad_norm']:.4f} (the synced mean's); parameters equal bit for bit on "
            f"every rank (sha256 {st[0]['digest'][:16]}); walls (max over ranks): step "
            f"{max(s['step_ms'] for s in st):.1f} ms = grads {max(s['grads_ms'] for s in st):.1f} "
            f"+ sync {max(s['sync_ms'] for s in st):.1f} + AdamW "
            f"{max(s['update_ms'] for s in st):.1f}; float32 handed to gloo's all-reduce "
            f"{st[0]['bytes']:,} bytes a rank ({st[0]['bytes'] / n_params:.1f} a parameter); "
            f"card {card}")
    lhs = sum(r["synced_sum"] for r in ranks) / DP_WORLD + \
        sum(r["final_error"] for r in ranks) / DP_WORLD
    rhs = sum(r["true_sum"] for r in ranks) / DP_WORLD
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=EF_TOL, atol=EF_TOL)
    gap = float((lhs - rhs).abs().max())
    log(f"phase 26 (a): error feedback on {_ef_leaf(cfg)} ({rhs.numel():,} elements): the synced "
        f"gradients summed over the steps plus the ranks' mean final error equal the ranks' mean "
        f"true gradient sum within {gap:.3g} (<= {EF_TOL:g} + {EF_TOL:g} x |sum|, largest |sum| "
        f"{float(rhs.abs().max()):.4g})")
    log(f"phase 26 (a): peak memory by rank {[round(r['peak'] / 1e9, 2) for r in ranks]} GB; "
        f"flash launches over the {DP_STEPS} steps by rank "
        f"{[r['launches']['flash_attention'] for r in ranks]} forward, "
        f"{[r['launches']['flash_attention_bwd'] for r in ranks]} backward "
        f"({cfg.num_layers} layers x 2 forwards under remat, 1 backward, a step)")
    for r in ranks:
        assert r["launches"]["flash_attention"] == 2 * cfg.num_layers * DP_STEPS, r["launches"]
        assert r["launches"]["flash_attention_bwd"] == cfg.num_layers * DP_STEPS, r["launches"]
    launches["flash_attention"]["(a) a data-parallel step, by rank"] = [
        r["launches"]["flash_attention"] // DP_STEPS for r in ranks]
    launches["flash_attention_bwd"]["(a) a data-parallel step, by rank"] = [
        r["launches"]["flash_attention_bwd"] // DP_STEPS for r in ranks]
    del ranks
    # one rank: nccl and gloo give the same sync as no group
    gen = torch.Generator(device=dev).manual_seed(260)
    shapes = [(cfg.d_model, cfg.num_heads, cfg.head_dim), (cfg.d_ff, cfg.d_model),
              (cfg.d_model,), (4096, cfg.d_model)]
    grads = [torch.randn(s, generator=gen, device=dev).to(torch.bfloat16) for s in shapes]
    error = [1e-3 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    err0 = [e.clone() for e in error]
    none_mean, none_err = compressed_grad_sync()(grads, err0)
    by = {b: _sync_world_one(dev, b, TRAIN_DIST_DIR / f"{b}1", grads, error)
          for b in ("gloo", "nccl")}
    for b, (mean, err) in by.items():
        assert all(torch.equal(a, c) for a, c in zip(mean, none_mean)), b
        assert all(torch.equal(a, c) for a, c in zip(err, none_err)), b
    log(f"phase 26 (a): one rank: compressed_grad_sync over an nccl group and over a gloo group "
        f"of one, and with no group, give the same means and errors bit for bit on "
        f"{len(shapes)} leaves {shapes}")
    del grads, error, err0, none_mean, none_err, by
    torch.cuda.empty_cache()

    # ---- (b) the pipeline: the plain model first, on this process -------
    t = time.perf_counter()
    pol32 = _stablelm_policy(torch.float32)
    batch = _pp_batch(cfg.vocab_size, dev)
    params = trainable(model.init_params(cfg, 1, pol32))
    flat = leaves(params)
    loss, _ = model.loss_fn(params, batch, cfg, pol32)
    grads = torch.autograd.grad(loss, flat)
    plain_loss = float(loss.detach())
    torch.save({p: x.cpu() for p, x in zip(_leaf_paths(params), grads)},
               TRAIN_DIST_DIR / "plain.pt")
    del params, flat, grads, loss
    gc.collect()
    torch.cuda.empty_cache()
    pol16 = _stablelm_policy(torch.bfloat16)
    params = trainable(model.init_params(cfg, 1, pol16))
    flat = leaves(params)
    plain_walls = []
    for i in range(PP_BF16_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(params, batch, cfg, pol16)
        torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        if i:
            plain_walls.append((time.perf_counter() - t0) * 1e3)
    del params, flat, loss
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 26 (b): the plain model, one process, {PP_BATCH} x {TRAIN_SEQ} tokens under "
        f"remat: float32 (TF32 off) loss {plain_loss:.6f}, gradients saved for the stages; bf16 "
        f"forward and backward {[round(w, 1) for w in plain_walls]} ms; "
        f"{time.perf_counter() - t:.1f} s")
    pp = {}
    for n in PP_STAGES:
        t = time.perf_counter()
        ranks = spawn_ranks(train_dist_rank, n,
                            dict(part="pp", store=str(TRAIN_DIST_DIR / f"pp{n}"),
                                 plain=str(TRAIN_DIST_DIR / "plain.pt")),
                            TRAIN_DIST_TIMEOUT_S, 26)
        joined = time.perf_counter() - t
        losses = [r["f32"]["loss"] for r in ranks]
        assert len(set(losses)) == 1, losses
        assert abs(losses[0] - plain_loss) <= PP_LOSS_RTOL * abs(plain_loss), (losses, plain_loss)
        rel = {k: v for r in ranks for k, v in r["f32"]["rel"].items()}
        assert len(rel) == len(leaves(model.abstract_params(cfg, pol32))), len(rel)
        worst = max(rel, key=rel.get)
        assert rel[worst] <= PP_GRAD_REL, (worst, rel[worst])
        ticks = PP_MICRO + n - 1
        layers = cfg.num_layers // n
        for r in ranks:
            for dt in ("f32", "bf16"):
                lc = r[dt]["launches"]
                assert lc["flash_attention"] == 2 * ticks * layers, (n, dt, lc)
                assert lc["flash_attention_bwd"] == ticks * layers, (n, dt, lc)
        walls = [max(r["bf16"]["walls_ms"][i] for r in ranks) for i in range(PP_BF16_STEPS)]
        bubble = (n - 1) / ticks
        shift = [r["f32"]["shift_bytes"] for r in ranks]
        log(f"phase 26 (b): {n} gloo stages of {layers} layers, M {PP_MICRO} microbatches of "
            f"{PP_BATCH // PP_MICRO} x {TRAIN_SEQ}, {ticks} ticks: spawned, run and joined in "
            f"{joined:.1f} s; float32 (TF32 off) loss {losses[0]:.6f} on every rank against the "
            f"plain {plain_loss:.6f} (rel {abs(losses[0] - plain_loss) / abs(plain_loss):.3g} <= "
            f"{PP_LOSS_RTOL:g}); every one of {len(rel)} gradients within "
            f"{rel[worst]:.3g} of the plain one by relative norm (<= {PP_GRAD_REL:g}; worst "
            f"{worst}); bytes handed to the shifts by rank (float32, forward and backward) "
            f"{shift}; float32 step wall by rank "
            f"{[round(r['f32']['wall_ms'], 1) for r in ranks]} ms; card {card}")
        log(f"phase 26 (b): {n} stages, bf16: forward and backward {[round(w, 1) for w in walls]} "
            f"ms (max over ranks) against the plain model's {[round(w, 1) for w in plain_walls]} "
            f"ms on one process ({statistics.median(walls) / statistics.median(plain_walls):.2f}x); "
            f"bubble share (S - 1) / (M + S - 1) = {bubble:.3f}; bf16 losses "
            f"{sorted({round(r['bf16']['loss'], 4) for r in ranks})}; flash launches a step on "
            f"each rank {ranks[0]['bf16']['launches']['flash_attention']} forward ({ticks} ticks x "
            f"{layers} layers x 2 under remat), "
            f"{ranks[0]['bf16']['launches']['flash_attention_bwd']} backward; peaks by rank "
            f"{[round(r['bf16']['peak'] / 1e9, 2) for r in ranks]} GB (float32 run "
            f"{[round(r['f32']['peak'] / 1e9, 2) for r in ranks]}); card {card}")
        log(f"phase 26 (b): {n} stages, bf16, one step's bytes a rank: shifts "
            f"{[r['bf16']['traffic']['shift'] for r in ranks]}, the replicated leaves' gradient "
            f"sum (embedding, final norm, head; one all-reduce in bf16) "
            f"{[r['bf16']['traffic']['all_reduce'] for r in ranks]}; that sum alone "
            f"({ranks[0]['bf16']['replicated_bytes']:,} bytes a rank) takes "
            f"{[round(max(r['bf16']['replicated_sum_ms'][i] for r in ranks), 1) for i in range(2)]}"
            f" ms (max over ranks); the float32 step above is each process's first (its "
            f"warm-up included); card {card}")
        key = f"(b) a pipelined step, S={n}, M={PP_MICRO}, on each rank"
        launches["flash_attention"][key] = ranks[0]["bf16"]["launches"]["flash_attention"]
        launches["flash_attention_bwd"][key] = ranks[0]["bf16"]["launches"]["flash_attention_bwd"]
        pp[n] = dict(walls=walls, bubble=bubble)
        del ranks
    shutil.rmtree(TRAIN_DIST_DIR, ignore_errors=True)

    # ---- (c) both flash kernels at stablelm's shape ----------------------
    g, hd = cfg.num_kv_heads, cfg.head_dim
    p = cfg.num_heads // g
    checked = check_flash_shapes(
        dev, card, {"B 1 (a pipeline microbatch)": (1, g, p, TRAIN_SEQ, TRAIN_SEQ, hd, True),
                    "B 2 (a data-parallel rank's batch)": (2, g, p, TRAIN_SEQ, TRAIN_SEQ, hd,
                                                           True)},
        "26 (c)", seed=26)

    # ---- (d) the sharding rules at the production meshes (host) ---------
    t = time.perf_counter()
    for arch in ARCH_IDS:
        acfg = get_config(arch)
        opts = default_options(acfg)
        line = []
        for multi_pod in (False, True):
            mesh = make_production_mesh(multi_pod=multi_pod)
            params = model.abstract_params(acfg, Policy(tp=tp_size(mesh),
                                                       param_dtype=opts.param_dtype))
            specs = param_shardings(params, mesh, opts)
            total = sum(x.numel() * x.element_size() for x in leaves(params))
            line.append(f"{'x'.join(map(str, mesh.dims))}: {_bytes_per_device(params, specs):,} "
                        f"bytes a device of {total:,}")
        log(f"phase 26 (d): {arch} (fsdp {opts.fsdp}, moments {opts.moment_dtype}): parameters "
            f"at {'; '.join(line)}")
    log(f"phase 26 (d): {len(ARCH_IDS)} architectures' specs at both production meshes in "
        f"{time.perf_counter() - t:.1f} s (host)")
    log(f"phase 26: {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return {"flash_attention": {"launches_phase_26": launches["flash_attention"],
                                "phase_26": {k: v["fwd"] for k, v in checked.items()}},
            "flash_attention_bwd": {"launches_phase_26": launches["flash_attention_bwd"],
                                    "phase_26": {k: v["bwd"] for k, v in checked.items()}}}


# phase 27: Policy.mesh, both MoE paths over a process mesh's model axis
MESH_DIR = Path(__file__).resolve().parent / "build" / "phase27"
MESH_WORLD = 4
MESH_LAYERS = 6          # Scout's layers served at (1, 4): the reckoning in the phase's log
MESH_CUT_LAYERS = 2      # (c) at (2, 2)
MESH_REQUESTS = 12       # phase 9's mix, cut in request count
MESH_NEW = 16
MESH_SEED = 27
MESH_LAYER_TOKENS = (2, 512)   # (b): 1,024 tokens, B 2 so that (2, 2)'s data axis splits it
# bf16 logits, mesh against stacked: |diff| <= 0.125 x max(1, |stacked|) where the router's
# counts and drops agree.  Two bf16 summation orders of one model: the replicated path sums
# float32 partials over the ranks and slices the shared expert over F, the stacked path sums
# bf16 partials and runs the whole shared FFN, and moe_apply runs the shared expert on a
# rank's block; rounding differences grow through the layers (0.0898 at 6 layers, 0.0352
# at 2 on an H100 80GB HBM3 at 700 W).  The sharp check of the same path is (a') in float32.
MESH_LOGIT_TOL = 0.125
MESH_F32_TOL = 1e-4            # (b), float32: |mesh - ref| <= 1e-4 x max(1, |ref|)
MESH_TF_TOL = 1e-3             # (a'), float32 logits: phase 11's card-against-CPU limit
MESH_TF_LAYERS = 2             # (a'): float32 at full width, 4 ranks' 13.8 GB each
MESH_TF_PROMPTS = (1024, 1022)  # moe_apply, then the replicated path
MESH_TF_STEPS = 8
MESH_ROUTER_MARGIN = 1e-5      # (b)'s top-two router logits apart by more (float64 reading)
MESH_TIMEOUT_S = 600.0
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


class _Tape(list):
    """A request's ``out_tokens`` that tags the serving call which made
    each token with the request and the token's place."""

    def __init__(self, rid, calls):
        super().__init__()
        self.rid, self.calls = rid, calls

    def append(self, tok):
        self.calls[-1].update(rid=self.rid, step=len(self))
        super().append(tok)


def _mesh_serve(cfg, params, pol, inv, plan, dev, *, keep_logits) -> dict:
    """Phase 27 (a)'s serving run: the plan's requests routed by
    ``DRScheduler(4)`` to four 4-slot ``ServeEngine``s, ``model.prefill``
    and ``model.decode_step`` wrapped to pass ``inv_place`` and to record
    each call's wall (synchronized), launches and last-position logits
    (bf16 on the host when ``keep_logits``, else a digest)."""
    import hashlib

    import repro_torch.models.model as model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import DRScheduler

    import repro_torch.models.transformer as transformer

    calls: list = []
    orig = {"prefill": model.prefill, "decode": model.decode_step,
            "backbone": transformer.backbone}
    moe_out: dict = {}

    def backbone(*a, **k):
        res = orig["backbone"](*a, **k)
        moe_out["counts"], moe_out["overflow"] = res[2], res[3]
        return res

    def timed(kind):
        def call(*a, **k):
            before = _launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = orig[kind](*a, inv_place=inv, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            now = _launch_counts()
            last = logits[0, -1, : cfg.vocab_size].cpu()
            rec = {"kind": kind, "wall": wall,
                   "len": a[1]["tokens"].shape[1] if kind == "prefill" else 1,
                   "dc": now["dispatch_count"] - before["dispatch_count"],
                   "fa": now["flash_attention"] - before["flash_attention"],
                   "finite": bool(torch.isfinite(last).all()),
                   "counts": moe_out["counts"].cpu(), "overflow": float(moe_out["overflow"]),
                   "digest": hashlib.sha256(last.view(torch.int16).numpy().tobytes()).hexdigest()}
            if keep_logits:
                rec["logits"] = last
            calls.append(rec)
            return logits, cache
        return call

    sched = DRScheduler(4)
    engines = [ServeEngine(cfg, params, pol, slots=4, max_len=2064, device=dev) for _ in range(4)]
    queues: list[list] = [[] for _ in range(4)]
    for i, (prompt, session) in enumerate(zip(plan["prompts"], plan["sessions"])):
        req = Request(rid=i, prompt=prompt, max_new_tokens=MESH_NEW, session_key=int(session),
                      out_tokens=_Tape(i, calls))
        queues[sched.route(req.session_key, cost_tokens=MESH_NEW)].append(req)
    model.prefill, model.decode_step = timed("prefill"), timed("decode")
    transformer.backbone = backbone
    try:
        t = time.perf_counter()
        for eng, q in zip(engines, queues):
            eng.run(q, max_ticks=200)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
    finally:
        model.prefill, model.decode_step = orig["prefill"], orig["decode"]
        transformer.backbone = orig["backbone"]
    reqs = sorted((r for q in queues for r in q), key=lambda r: r.rid)
    assert all(r.done and len(r.out_tokens) == MESH_NEW for r in reqs)
    return {"calls": calls, "tokens": [list(r.out_tokens) for r in reqs], "serve_s": serve_s,
            "queues": [[r.rid for r in q] for q in queues]}


def _mesh_teacher_forced(cfg, params, pol, inv, dev) -> list:
    """(a')'s float32 last-position logits on the host, one a call: each of
    ``MESH_TF_PROMPTS`` prefilled, then ``MESH_TF_STEPS`` decode steps fed
    seeded tokens, the same in every run."""
    import repro_torch.models.model as model

    rng = np.random.default_rng(MESH_SEED + 5)
    out = []
    for n in MESH_TF_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)
        feed = rng.integers(0, cfg.vocab_size, MESH_TF_STEPS)
        logits, cache = model.prefill(params, {"tokens": toks}, cfg, pol,
                                      max_len=n + MESH_TF_STEPS + 8, inv_place=inv)
        out.append(logits[0, -1, : cfg.vocab_size].float().cpu())
        for t in feed:
            tok = torch.full((1, 1), int(t), dtype=torch.int64, device=dev)
            logits, cache = model.decode_step(params, cache, tok, cfg, pol, inv_place=inv)
            out.append(logits[0, -1, : cfg.vocab_size].float().cpu())
    return out


def _mesh_layer_inputs(cfg, dev, experts=None):
    """(b)'s float32 layer (``experts``: a rank's logical experts, ``None``
    all) and its input, drawn from seeded generators on the card."""
    from repro_torch.moe.layer import init_moe

    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 1)
    p = init_moe(gen, cfg.d_model, cfg.moe, cfg.ffn_kind, torch.float32, experts)
    gx = torch.Generator(device=dev).manual_seed(MESH_SEED + 2)
    x = torch.randn(MESH_LAYER_TOKENS + (cfg.d_model,), generator=gx, device=dev)
    return p, x


def _moe_record(out, keep_y: bool) -> dict:
    import hashlib

    rec = {"counts": out.counts.cpu(), "overflow": float(out.overflow),
           "aux": float(out.aux_loss),
           "y_digest": hashlib.sha256(out.y.float().cpu().numpy().tobytes()).hexdigest()}
    if out.shipped_rows is not None:
        rec["shipped"], rec["occupied"] = int(out.shipped_rows), int(out.occupied_rows)
    if keep_y:
        rec["y"] = out.y.float().cpu()
    return rec


def _mesh_tokens(plan_key: str, vocab: int, shape):
    return np.random.default_rng(MESH_SEED + len(plan_key)).integers(0, vocab, shape)


def mesh_rank(rank: int, world: int, plan: dict) -> None:
    """Phase 27's rank ``rank`` of ``world``: joins the gloo group through a
    ``file://`` store in the git-ignored build directory, lays the (1, 4)
    and (2, 2) meshes over it, runs (a)-(d) as the same calls on every
    rank, and saves what it saw beside the store; the parent checks.  A
    failure raises, and the parent re-raises it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.models.model as model
    import repro_torch.models.transformer as transformer
    from repro_torch.carry import init_rank_params, rank_slots
    from repro_torch.configs.registry import get_config
    from repro_torch.exchange.dist import WorkerGroup
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
    from repro_torch.launch.mesh import MeshShape, ProcessMesh
    from repro_torch.launch.sharding import ShardingOptions, make_policy
    from repro_torch.moe.layer import moe_apply, moe_apply_replicated

    build.library()
    dev = torch.device("cuda")
    g = WorkerGroup.init(backend="gloo", rank=rank, world_size=world,
                         init_method=f"file://{plan['store']}", device="cuda")
    meshes = {name: ProcessMesh(MeshShape(dims, ("data", "model")), g)
              for name, dims in MESHES.items()}
    bf16 = torch.bfloat16
    opts = ShardingOptions(compute_dtype=bf16, param_dtype=bf16)
    full = get_config("llama4-scout-17b-a16e")
    out: dict = {"rank": rank, "coords": {n: m.coords for n, m in meshes.items()}}

    # ---- (a) serving at (1, 4) --------------------------------------------
    cfg = dataclasses.replace(full, num_layers=plan["layers"])
    pm = meshes["1x4"]
    pol = make_policy(cfg, pm, "prefill", opts)
    t = time.perf_counter()
    params = init_rank_params(cfg, MESH_SEED, pol, place=plan["place"], device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["slots"] = rank_slots(pm, cfg.moe.num_experts, plan["place"])
    out["experts_held"] = int(params["layers"][0]["moe"]["wi"].shape[0])
    out["param_bytes"] = sum(x.numel() * x.element_size() for x in _leaves(params))
    inv = torch.as_tensor(plan["inv"], device=dev)
    g.barrier()
    torch.cuda.reset_peak_memory_stats()
    before = dict(g.traffic)
    _zero_launch_counts()
    rec = _mesh_serve(cfg, params, pol, inv, plan, dev, keep_logits=rank == 0)
    out["launches"] = {k: v for k, v in _launch_counts().items()
                       if k in ("dispatch_count", "flash_attention")}
    out["traffic"] = {k: v - before[k] for k, v in g.traffic.items()}
    out["peak"] = torch.cuda.max_memory_allocated()
    g.barrier()  # every rank holds its parameters and caches' high water
    free, total = torch.cuda.mem_get_info()
    out["card_used"] = total - free
    out["serve"] = rec

    # ---- (d) dispatch_count on this rank's own inputs ----------------------
    captured = []
    orig_slots = ops.dispatch_slots

    def slots_capture(dest, valid=None, *, num_parts):
        captured.append((dest.clone(), None if valid is None else valid.clone(), num_parts))
        return orig_slots(dest, valid, num_parts=num_parts)

    toks = torch.as_tensor(_mesh_tokens("d", cfg.vocab_size, (1, 1024)), device=dev)
    ops.dispatch_slots = slots_capture
    try:
        _, cache = model.prefill(params, {"tokens": toks}, cfg, pol, max_len=1040,
                                 inv_place=inv)
        hops = captured[:2]
        captured.clear()
        model.decode_step(params, cache, toks[:, :1], cfg, pol, inv_place=inv)
        dec = captured[:1]
    finally:
        ops.dispatch_slots = orig_slots
    del cache
    dc = {}
    for name, (dest, valid, parts) in zip(("hop 1", "hop 2", "decode"), hops + dec):
        valid = torch.ones_like(dest, dtype=torch.bool) if valid is None else valid
        dest = dest.to(torch.int32).contiguous()
        got = dispatch_count(dest, valid, num_parts=parts)
        want = dispatch_count_plain(dest, valid, num_parts=parts)
        torch.cuda.synchronize()
        w, n = dest.shape
        dc[name] = {"equal": all(torch.equal(a, b) for a, b in zip(got, want)),
                    "shape": f"W={w} n={n} L={parts}", "valid": int(valid.sum()),
                    "bytes": w * n * (4 + 1) + w * n * 4 + w * parts * 4}
    # times on rank 0 alone, the other ranks waiting at a barrier
    if rank == 0:
        for name, (dest, valid, parts) in zip(("hop 1", "hop 2", "decode"), hops + dec):
            valid = torch.ones_like(dest, dtype=torch.bool) if valid is None else valid
            dest = dest.to(torch.int32).contiguous()
            dc[name].update(
                ms=cuda_ms(lambda: dispatch_count(dest, valid, num_parts=parts)),
                plain_ms=cuda_ms(lambda: dispatch_count_plain(dest, valid, num_parts=parts)),
                device_ms=device_ms(lambda: dispatch_count(dest, valid, num_parts=parts)))
    g.barrier()
    out["dispatch_count"] = dc
    del params, captured, hops, dec
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (a') float32, teacher-forced, at (1, 4) ---------------------------
    import hashlib

    tcfg = dataclasses.replace(full, num_layers=MESH_TF_LAYERS)
    tpol = make_policy(tcfg, meshes["1x4"], "prefill", ShardingOptions(
        compute_dtype=torch.float32, param_dtype=torch.float32))
    params = init_rank_params(tcfg, MESH_SEED + 4, tpol, place=plan["place"], device=dev)
    tf = _mesh_teacher_forced(tcfg, params, tpol, inv, dev)
    out["tf"] = {"logits": tf if rank == 0 else None,
                 "digests": [hashlib.sha256(t.numpy().tobytes()).hexdigest() for t in tf]}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) one MoE layer at full width, float32, at both meshes ----------
    layer = {}
    for mname, pm in meshes.items():
        p, x = _mesh_layer_inputs(full, dev, rank_slots(pm, full.moe.num_experts))
        for be, flag in (("dense", None), ("ragged", ""), ("ragged masked", "1")):
            if flag is not None:
                os.environ["REPRO_DISABLE_NATIVE_RAGGED"] = flag
            try:
                pol = make_policy(full, pm, "prefill", ShardingOptions(
                    compute_dtype=torch.float32, param_dtype=torch.float32, moe_cf=8.0))
                pol = dataclasses.replace(pol, exchange_backend=be.split()[0])
                for path, fn in (("apply", moe_apply), ("replicated", moe_apply_replicated)):
                    if path == "replicated" and be != "dense":
                        continue  # no exchange on the replicated path
                    t0 = time.perf_counter()
                    got = fn(p, x, full.moe, full.ffn_kind, pol)
                    torch.cuda.synchronize()
                    rec = _moe_record(got, keep_y=rank == 0)
                    rec["wall"] = time.perf_counter() - t0
                    layer[f"{mname}/{path}/{be}"] = rec
            finally:
                os.environ.pop("REPRO_DISABLE_NATIVE_RAGGED", None)
        del p, x
        torch.cuda.empty_cache()
    out["layer"] = layer

    # ---- (c) the model at (2, 2): B 2 prefill and a decode step ------------
    pm = meshes["2x2"]
    cfg2 = dataclasses.replace(full, num_layers=MESH_CUT_LAYERS)
    pol = make_policy(cfg2, pm, "prefill", dataclasses.replace(opts, moe_cf=8.0))
    params = init_rank_params(cfg2, MESH_SEED + 3, pol, device=dev)
    toks = torch.as_tensor(_mesh_tokens("c", cfg2.vocab_size, (2, 1024)), device=dev)
    stats, paths = [], []
    orig_bb = transformer.backbone
    orig_fn = {n: getattr(transformer, n) for n in ("moe_apply", "moe_apply_replicated")}

    def backbone(*a, **k):
        res = orig_bb(*a, **k)
        stats.append(float(res[3]))
        return res

    transformer.backbone = backbone
    for n, fn in orig_fn.items():
        setattr(transformer, n, lambda *a, _fn=fn, _n=n, **k: (paths.append(_n), _fn(*a, **k))[1])
    try:
        lp, cache = model.prefill(params, {"tokens": toks}, cfg2, pol, max_len=1040)
        ld, _ = model.decode_step(params, cache, toks[:, :1], cfg2, pol)
        torch.cuda.synchronize()
        served_paths = list(paths)  # the refused prefill below enters moe_apply too
        try:
            model.prefill(params, {"tokens": toks[:1]}, cfg2, pol, max_len=1040)
            refused = None
        except ValueError as e:
            refused = str(e)
    finally:
        transformer.backbone = orig_bb
        for n, fn in orig_fn.items():
            setattr(transformer, n, fn)
    out["cut"] = {"logits": [lp[:, -1, : cfg2.vocab_size].cpu(),
                             ld[:, -1, : cfg2.vocab_size].cpu()] if rank == 0 else None,
                  "overflow": stats, "paths": served_paths, "refused": refused,
                  "experts_held": int(params["layers"][0]["moe"]["wi"].shape[0])}
    del params, cache
    g.close()
    torch.save(out, Path(plan["store"]).with_name(f"{Path(plan['store']).name}.rank{rank}.pt"))


def _top_two_margin(logits) -> tuple[float, float]:
    """(top logit, top - second) of a float vector."""
    top = torch.topk(logits.float(), 2).values
    return float(top[0]), float(top[0] - top[1])


def _rank_bytes(cfg, ntp: int) -> tuple[int, int]:
    """(bytes a rank holds outside the layers, bytes a layer a rank) in
    bf16, experts over ``ntp`` model ranks: the reckoning of phase 27."""
    from repro_torch.launch.sharding import _tree_paths
    from repro_torch.models import model
    from repro_torch.models.modules import Policy

    params = model.abstract_params(dataclasses.replace(cfg, num_layers=1),
                                   Policy(param_dtype=torch.bfloat16))
    outside = per_layer = 0
    for path, leaf in _tree_paths(params):
        n = leaf.numel() * leaf.element_size()
        if path.startswith("layers/"):
            per_layer += n // ntp if re.search(r"moe/w[io]$", path) else n
        else:
            outside += n
    return outside, per_layer


def mesh_phase(dev, card, served=None) -> dict:
    """Phase 27: ``Policy.mesh`` over four gloo ranks sharing the card.  (a)
    Llama 4 Scout at full width (``MESH_LAYERS`` of 48 layers, bf16) served
    at (1, 4) under ``make_policy`` against the stacked run
    (``Policy(ep_shards=4)``) on the same weights, placement and requests;
    (b) one MoE layer at full width, float32, at (1, 4) and (2, 2), both
    paths on every transport, against the stacked path and ``moe_ref``;
    (a') the same in float32 at 2 layers, teacher-forced; (c)
    ``model.prefill`` at B 2 and a decode step at (2, 2), two layers, and
    the B 1 refusal; (d) ``dispatch_count`` on each rank's own hop inputs;
    (e) walls, bytes by collective and memory a rank.  ``served``
    is phase 18's serving record (its placement and walls; ``None``: a
    fixed placement, phase 27 run alone).  Returns the ``kernels`` line's
    phase-27 entries by kernel name."""
    import repro_torch.models.model as model
    import repro_torch.models.transformer as transformer
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import ShardingOptions, policy_fields
    from repro_torch.models.modules import Policy
    from repro_torch.moe.kip_placement import apply_placement_to_weights
    from repro_torch.moe.layer import moe_apply, moe_apply_replicated, moe_ref

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, num_layers=MESH_LAYERS)
    e = full.moe.num_experts
    place = (np.asarray(served["place"], np.int64) if served is not None
             else np.roll(np.arange(e), 5))
    inv = np.zeros(e, np.int32)
    inv[place] = np.arange(e, dtype=np.int32)
    opts = ShardingOptions(compute_dtype=bf16, param_dtype=bf16)
    outside, per_layer = _rank_bytes(full, 4)
    reckoned = MESH_WORLD * (outside + MESH_LAYERS * per_layer)
    log(f"phase 27: reckoning at (1, 4), bf16: a rank holds {outside / 1e9:.2f} GB outside the "
        f"layers (embedding, head, norm) and {per_layer / 1e9:.3f} GB a layer (attention, "
        f"shared expert, router, {e // 4} of {e} experts); {MESH_WORLD} ranks x {MESH_LAYERS} "
        f"layers = {reckoned / 1e9:.2f} GB of parameters on the card, before caches and "
        f"contexts; (2, 2) holds {e // 2} experts a rank")

    # ---- (a) the stacked run first, in this process -------------------------
    rng = np.random.default_rng(MESH_SEED)
    sessions = np.where(rng.random(MESH_REQUESTS) < 0.3, 7, rng.integers(0, 1000, MESH_REQUESTS))
    lens = rng.integers(256, 2049, MESH_REQUESTS)
    assert (lens % 4 == 0).any() and (lens % 4 != 0).any(), lens
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    plan = {"store": str(MESH_DIR / "store"), "layers": MESH_LAYERS, "place": place,
            "inv": inv, "prompts": prompts, "sessions": sessions}
    spol = Policy(ep_shards=4, **policy_fields(MeshShape((1, 4), ("data", "model")), opts))
    params = model.init_params(cfg, MESH_SEED, spol, device=dev)
    for lay in params["layers"]:
        lay["moe"] = apply_placement_to_weights(lay["moe"], place)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stacked = _mesh_serve(cfg, params, spol, torch.as_tensor(inv, device=dev), plan, dev,
                          keep_logits=True)
    stacked_peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(full, num_layers=MESH_TF_LAYERS)
    tpol = Policy(ep_shards=4, **policy_fields(MeshShape((1, 4), ("data", "model")),
                                               ShardingOptions(compute_dtype=torch.float32,
                                                               param_dtype=torch.float32)))
    params = model.init_params(tcfg, MESH_SEED + 4, tpol, device=dev)
    for lay in params["layers"]:
        lay["moe"] = apply_placement_to_weights(lay["moe"], place)
    tf_want = _mesh_teacher_forced(tcfg, params, tpol, torch.as_tensor(inv, device=dev), dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) and (c)'s stacked runs and the oracle -------------------------
    p, x = _mesh_layer_inputs(full, dev)
    spec = full.moe
    margins = torch.topk((x.reshape(-1, full.d_model).double() @ p["router"].double()), 2).values
    margin = float((margins[:, 0] - margins[:, 1]).min())
    assert margin > MESH_ROUTER_MARGIN, margin
    f32 = Policy(moe_capacity_factor=8.0)
    layer_want = {"ref": _moe_record(moe_ref(p, x, spec, full.ffn_kind, f32), True)}
    for mname, (_, ntp) in MESHES.items():
        for be in ("dense", "ragged"):
            spol_b = dataclasses.replace(f32, tp=ntp, ep_shards=ntp, exchange_backend=be)
            layer_want[f"{mname}/apply/{be}"] = _moe_record(
                moe_apply(p, x, spec, full.ffn_kind, spol_b), True)
        layer_want[f"{mname}/replicated/dense"] = _moe_record(moe_apply_replicated(
            p, x, spec, full.ffn_kind, dataclasses.replace(f32, tp=ntp, ep_shards=ntp)), True)
    torch.cuda.synchronize()
    del p, x
    cfg2 = dataclasses.replace(full, num_layers=MESH_CUT_LAYERS)
    spol2 = Policy(ep_shards=2, **policy_fields(MeshShape((2, 2), ("data", "model")),
                                                dataclasses.replace(opts, moe_cf=8.0)))
    params = model.init_params(cfg2, MESH_SEED + 3, spol2, device=dev)
    toks = torch.as_tensor(_mesh_tokens("c", cfg2.vocab_size, (2, 1024)), device=dev)
    lp, cache = model.prefill(params, {"tokens": toks}, cfg2, spol2, max_len=1040)
    ld, _ = model.decode_step(params, cache, toks[:, :1], cfg2, spol2)
    cut_want = [lp[:, -1, : cfg2.vocab_size].cpu(), ld[:, -1, : cfg2.vocab_size].cpu()]
    del params, cache, lp, ld
    gc.collect()
    torch.cuda.empty_cache()
    pre_s = time.perf_counter() - t_phase
    log(f"phase 27: the stacked runs in this process took {pre_s:.1f} s (peak "
        f"{stacked_peak / 1e9:.2f} GB serving); (b)'s router inputs keep their top two "
        f"logits {margin:.3g} apart (> {MESH_ROUTER_MARGIN:g})")

    # ---- the ranks --------------------------------------------------------
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    ranks = spawn_ranks(mesh_rank, MESH_WORLD, plan, MESH_TIMEOUT_S, 27)
    spawn_s = time.perf_counter() - t

    # (a): every rank the same tokens and logits; rank 0 against the stacked run
    r0 = ranks[0]["serve"]
    for r in ranks:
        assert r["serve"]["tokens"] == r0["tokens"], r["rank"]
        assert [c["digest"] for c in r["serve"]["calls"]] == [c["digest"] for c in r0["calls"]]
        assert all(c["finite"] for c in r["serve"]["calls"])
        assert r["experts_held"] == e // 4 and sorted(r["slots"]) == sorted(
            place[4 * r["coords"]["1x4"]["model"]: 4 * r["coords"]["1x4"]["model"] + 4].tolist())
    assert r0["queues"] == stacked["queues"]
    by_req: dict = {}
    for kind, run in (("stacked", stacked), ("mesh", r0)):
        for c in run["calls"]:
            by_req.setdefault(c["rid"], {}).setdefault(kind, []).append(c)
    errs, diverged = [], []
    for rid, runs in sorted(by_req.items()):
        for sc, mc in zip(runs["stacked"], runs["mesh"]):
            assert (sc["step"], sc["kind"], sc["len"]) == (mc["step"], mc["kind"], mc["len"])
            top, gap = _top_two_margin(sc["logits"])
            x = {"rid": rid, "step": sc["step"], "len": sc["len"],
                 "err": bf16_rel_err(mc["logits"], sc["logits"]),
                 "same_routing": torch.equal(sc["counts"], mc["counts"])
                 and sc["overflow"] == mc["overflow"],
                 "drops": (sc["overflow"], mc["overflow"]), "gap": gap,
                 "near": gap <= 2 * MESH_LOGIT_TOL * max(1.0, abs(top))}
            errs.append(x)
            if stacked["tokens"][rid][sc["step"]] != r0["tokens"][rid][sc["step"]]:
                diverged.append(x)
                break  # the runs decode different tokens from here on
    held = [x for x in errs if x["same_routing"]]
    flips = [x for x in errs if not x["same_routing"]]
    worst = max(x["err"] for x in held)
    log(f"phase 27 (a): against the stacked run, {len(errs)} calls compared up to each "
        f"request's first differing token: {len(held)} with the router's counts and drops "
        f"equal, logits max |diff| / max(1, |stacked|) {worst:.3g} (<= {MESH_LOGIT_TOL:g}); "
        f"{len(flips)} where the router sent a token elsewhere (not held to it): "
        + ", ".join(f"request {x['rid']} call {x['step']} {x['err']:.3g}" for x in flips)
        + "; worst held calls: " + "; ".join(
            f"request {x['rid']} call {x['step']} ({x['len']} tokens, drops {x['drops'][0]:g})"
            f": {x['err']:.3g}" for x in sorted(held, key=lambda x: -x["err"])[:5])
        + f"; first differing tokens (request, call, stacked top-two margin, routing equal): "
        + (", ".join(f"({x['rid']}, {x['step']}, {x['gap']:.4g}, {x['same_routing']})"
                     for x in diverged) or "none")
        + f"; calls with a stacked top-two margin within 2 x {MESH_LOGIT_TOL:g} x max(1, "
        f"|top|): {sum(x['near'] for x in errs)}")
    assert worst <= MESH_LOGIT_TOL, worst
    assert all(x["near"] or not x["same_routing"] for x in diverged), diverged

    # (a'): float32, teacher-forced, against the stacked run
    tf_errs, tf_near = [], 0
    for got, want in zip(ranks[0]["tf"]["logits"], tf_want):
        top, gap = _top_two_margin(want)
        tf_errs.append(bf16_rel_err(got, want))
        if gap > 2 * MESH_TF_TOL * max(1.0, abs(top)):
            assert int(torch.argmax(got)) == int(torch.argmax(want)), (len(tf_errs), gap)
        else:
            tf_near += 1
    assert len(tf_errs) == len(MESH_TF_PROMPTS) * (MESH_TF_STEPS + 1)
    assert all(r["tf"]["digests"] == ranks[0]["tf"]["digests"] for r in ranks)
    assert max(tf_errs) <= MESH_TF_TOL, tf_errs
    log(f"phase 27 (a'): float32 at full width, {MESH_TF_LAYERS} layers, the same placement: "
        f"prompts of {MESH_TF_PROMPTS} tokens (moe_apply, then the replicated path) and "
        f"{MESH_TF_STEPS} teacher-forced decode steps each on the (1, 4) mesh against "
        f"Policy(ep_shards=4): logits max |diff| / max(1, |stacked|) {max(tf_errs):.3g} (<= "
        f"{MESH_TF_TOL:g}), by call {[float(f'{e:.3g}') for e in tf_errs]}; greedy tokens "
        f"equal at every call but {tf_near} within 2 x {MESH_TF_TOL:g} of a tie; every rank's "
        f"logits equal")
    calls = r0["calls"]
    pre = [c for c in calls if c["kind"] == "prefill"]
    dec = [c for c in calls if c["kind"] == "decode"]
    for c in pre:
        split = c["len"] % 4 == 0
        assert c["dc"] == MESH_LAYERS * (2 if split else 1) and c["fa"] == MESH_LAYERS, c
    assert all(c["dc"] == MESH_LAYERS and c["fa"] == 0 for c in dec)
    launches = {k: [r["launches"][k] for r in ranks] for k in ("dispatch_count",
                                                               "flash_attention")}
    assert all(n > 0 for v in launches.values() for n in v), launches
    assert launches["dispatch_count"][0] == sum(c["dc"] for c in calls)
    tokens = sum(len(t) for t in r0["tokens"])
    med = lambda run, kind: statistics.median(c["wall"] for c in run["calls"]
                                              if c["kind"] == kind) * 1e3
    walls = {kind: max(med(r["serve"], kind) for r in ranks) for kind in ("prefill", "decode")}
    swalls = {kind: med(stacked, kind) for kind in ("prefill", "decode")}
    serve_s = max(r["serve"]["serve_s"] for r in ranks)
    log(f"phase 27 (a): {full.name} at full width, {MESH_LAYERS} of {full.num_layers} layers, "
        f"bf16, make_policy on a (1, 4) ProcessMesh of {MESH_WORLD} gloo ranks on the card, "
        f"each holding experts {[r['slots'] for r in ranks]} under phase 18's placement "
        f"{place.tolist()}: {MESH_REQUESTS} requests (prompts {sorted(lens.tolist())}), "
        f"{tokens} tokens in {serve_s:.2f} s (slowest rank); every rank's tokens and logits "
        f"equal (sha256); card {card}")
    log(f"phase 27 (a): launches a rank in the serving run {launches}; a prefill "
        f"dispatch_count {2 * MESH_LAYERS} (moe_apply) or {MESH_LAYERS} (replicated), flash "
        f"{MESH_LAYERS}; a decoded token dispatch_count {MESH_LAYERS}, flash 0")

    # (b): integers equal to the stacked path at the same model axis, y within tolerance
    blines = []
    for key, got in ranks[0]["layer"].items():
        mname, path, be = key.split("/")
        ntp = MESHES[mname][1]
        digests = {r["layer"][key]["y_digest"] for r in ranks}
        assert len(digests) == 1, key
        want = layer_want[f"{mname}/{path}/{be.split()[0]}"]
        ref = layer_want["ref"]
        assert torch.equal(got["counts"], want["counts"]) and torch.equal(got["counts"],
                                                                         ref["counts"]), key
        assert got["overflow"] == want["overflow"] == 0.0, key
        e_stack = bf16_rel_err(got["y"], want["y"])
        e_ref = bf16_rel_err(got["y"], ref["y"])
        assert max(e_stack, e_ref) <= MESH_F32_TOL, (key, e_stack, e_ref)
        assert abs(got["aux"] - want["aux"]) <= MESH_F32_TOL * max(1.0, abs(want["aux"])) or (
            MESHES[mname][0] > 1), key
        if path == "apply":
            assert got["occupied"] == want["occupied"], key
            if mname == "1x4":
                assert got["shipped"] == want["shipped"], key
        walls_b = max(r["layer"][key]["wall"] for r in ranks) * 1e3
        blines.append(f"{key}: y against stacked {e_stack:.3g}, against moe_ref {e_ref:.3g}; "
                      f"shipped {got.get('shipped')} / occupied {got.get('occupied')} (stacked "
                      f"{want.get('shipped')} / {want.get('occupied')}); {walls_b:.1f} ms")
    for k in ("1x4/apply/ragged", "2x2/apply/ragged"):
        a, b = ranks[0]["layer"][k], ranks[0]["layer"][k + " masked"]
        assert torch.equal(a["y"], b["y"]) and a["shipped"] == b["shipped"], k
    log(f"phase 27 (b): one MoE layer at full width, float32, {MESH_LAYER_TOKENS[0]} x "
        f"{MESH_LAYER_TOKENS[1]} tokens, capacity 8.0 (nothing dropped), counts equal to the "
        f"stacked path's and moe_ref's, every rank's y equal, native and masked ragged equal; "
        + "; ".join(blines) + f" (<= {MESH_F32_TOL:g} x max(1, |ref|)); card {card}")

    # (c): the (2, 2) model against its stacked run
    cut = ranks[0]["cut"]
    errs = [bf16_rel_err(g_, w_) for g_, w_ in zip(cut["logits"], cut_want)]
    assert max(errs) <= MESH_LOGIT_TOL, errs
    assert all(r["cut"]["paths"] == cut["paths"] for r in ranks)
    assert cut["paths"] == ["moe_apply"] * MESH_CUT_LAYERS + ["moe_apply_replicated"] * (
        MESH_CUT_LAYERS), cut["paths"]
    assert all(v == 0.0 for v in cut["overflow"]) and cut["experts_held"] == e // 2
    assert cut["refused"] and "do not divide the batch" in cut["refused"], cut["refused"]
    log(f"phase 27 (c): (2, 2), {MESH_CUT_LAYERS} layers, capacity 8.0: a B 2 x 1,024 prefill "
        f"(moe_apply, each rank a 1 x 512 block, {e // 2} experts a rank) and a decode step "
        f"(replicated, F split over the data axis) against Policy(ep_shards=2): logits max "
        f"|diff| / max(1, |stacked|) {errs[0]:.3g} and {errs[1]:.3g} (<= {MESH_LOGIT_TOL:g}); "
        f"a B 1 prefill raised ValueError ({cut['refused']})")

    # (d): the kernel on each rank's own inputs
    dc_rows = ranks[0]["dispatch_count"]
    for r in ranks:
        assert all(v["equal"] for v in r["dispatch_count"].values()), r["rank"]
    for name, row in dc_rows.items():
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"phase 27 (d): dispatch_count [{name}] {row['shape']} ({row['valid']} valid) on "
            f"every rank's own inputs: bit-equal to its plain version; rank 0: {row['ms']:.4f} "
            f"ms by events around one call, device time {row['device_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms by bytes ({row['bytes']} "
            f"bytes); card {card}")

    # (e): walls, bytes and memory a rank
    traffic = {k: max(r["traffic"][k] for r in ranks) for k in ranks[0]["traffic"]}
    peak = max(r["peak"] for r in ranks)
    log(f"phase 27 (e): walls a rank (the slowest rank's median): prefill {walls['prefill']:.2f} "
        f"ms, decode {walls['decode']:.2f} ms a token; the stacked run at the same depth "
        f"{swalls['prefill']:.2f} / {swalls['decode']:.2f} ms"
        + (f"; phase 18's (8 layers, KIP moves) {served['prefill_ms']:.2f} / "
           f"{served['decode_ms']:.2f} ms" if served is not None else "")
        + f"; bytes handed to gloo by the serving run, the largest rank: {traffic}; peak "
        f"allocated {peak / 1e9:.2f} GB a rank (parameters "
        f"{max(r['param_bytes'] for r in ranks) / 1e9:.2f} GB; reckoned "
        f"{(outside + MESH_LAYERS * per_layer) / 1e9:.2f}), the card's use with all ranks up "
        f"{ranks[0]['card_used'] / 1e9:.2f} GB (reckoned parameters {reckoned / 1e9:.2f} GB); "
        f"rank init {max(r['init_s'] for r in ranks):.1f} s; the ranks' run {spawn_s:.1f} s; "
        f"card {card}")
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    launch_rows = {"prefill_moe_apply": 2 * MESH_LAYERS, "prefill_replicated": MESH_LAYERS,
                   "decoded_token": MESH_LAYERS}
    return {"dispatch_count": {"launches_phase_27": launches["dispatch_count"],
                               "launches_phase_27_per_call": launch_rows,
                               "phase_27": dc_rows},
            "flash_attention": {"launches_phase_27": launches["flash_attention"],
                                "launches_phase_27_per_call": {"prefill": MESH_LAYERS,
                                                               "decoded_token": 0}}}



MT_DIR = Path(__file__).resolve().parent / "build" / "phase28"
MT_SEED = 28
MT_APPLY_TOKENS = (2, 512)     # (a) moe_apply: 1,024 tokens; both meshes' axes divide them
MT_REP_TOKENS = (2, 511)       # (a) the replicated path: 1,022 tokens no model axis divides
MT_AUX_W = 0.5                 # (a) the replicated path's loss: sum(y * C) + 0.5 aux
MT_GRAD_RTOL = 1e-4            # (a) float32 gradients: x max(1, |stacked|) ...
MT_GRAD_ATOL = 1e-5            # ... + this x the leaf's largest |stacked| (sums in another order)
MT_ROUTER_MARGIN = 1e-5        # (a) top-two router logits apart by more (float64 reading)
MT_PLACE_ROLL = 5              # (a) slot p holds logical expert (p - 5) mod 16
MT_WORLD_A = 4
MT_TRAIN_MESH = (1, 2)         # (b): 4 ranks at one layer would need 88.7 GB (the reckoning)
MT_TRAIN_LAYERS = 1
MT_TRAIN_BATCH = (2, 1024)
MT_STEPS = 3
MT_LR = 1e-3                   # OptConfig(lr=1e-3, warmup=1), phase 19's one-batch rate
MT_LOSS_RTOL = 1e-2            # (b) bf16: each rank's loss against the stacked step's
MT_GNORM_RTOL = 5e-2           # (b) bf16: grad_norm against the stacked step's
MT_TIMEOUT_S = 600.0


def _mt_layer(cfg, dev, experts=None):
    """(a)'s float32 layer (``experts``: a rank's slots, ``None`` all), its
    two inputs and a cotangent each, drawn from seeded generators on the
    card."""
    from repro_torch.moe.layer import init_moe

    gen = torch.Generator(device=dev).manual_seed(MT_SEED)
    p = init_moe(gen, cfg.d_model, cfg.moe, cfg.ffn_kind, torch.float32, experts)
    gx = torch.Generator(device=dev).manual_seed(MT_SEED + 1)
    xs = {"apply": torch.randn(MT_APPLY_TOKENS + (cfg.d_model,), generator=gx, device=dev),
          "replicated": torch.randn(MT_REP_TOKENS + (cfg.d_model,), generator=gx, device=dev)}
    cots = {k: torch.randn(v.shape, generator=gx, device=dev) for k, v in xs.items()}
    return p, xs, cots


def _mt_grads(fn, p, x, cot, spec, ffn_kind, pol, inv, path):
    """One forward and backward of (a)'s loss, timed (synchronized): the
    output, the loss, ``{leaf: grad}`` and the wall in ms."""
    leaves = {"router": p["router"], "wi": p["wi"], "wo": p["wo"],
              "shared/wi": p["shared"]["wi"], "shared/wo": p["shared"]["wo"]}
    leaves = {k: v.requires_grad_(True) for k, v in leaves.items()}
    xg = x.requires_grad_(True)
    q = {"router": leaves["router"], "wi": leaves["wi"], "wo": leaves["wo"],
         "shared": {"wi": leaves["shared/wi"], "wo": leaves["shared/wo"]}}
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(q, xg, spec, ffn_kind, pol, inv)
    loss = (out.y * cot).sum()
    if path == "replicated":
        loss = loss + MT_AUX_W * out.aux_loss
    grads = torch.autograd.grad(loss, list(leaves.values()) + [xg])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    names = list(leaves) + ["x"]
    return out, float(loss.detach()), dict(zip(names, grads)), wall


def _grad_err(got, want) -> tuple[float, float, float]:
    """``(max |got - want| / max(1, |want|), max |got - want| / max |want|,
    the largest excess of |got - want| over MT_GRAD_RTOL x max(1, |want|)
    + MT_GRAD_ATOL x max |want|)``, in float32 slices of 2^26 elements (the
    gradients of 8 experts are 2.7 GB a tensor).  A float32 gradient sums
    a term a token: two summation orders part by more than 1e-4 x max(1,
    |want|) where the sum cancels to near 0 from terms of the leaf's scale,
    hence the share of the leaf's largest entry."""
    assert got.shape == want.shape, (got.shape, want.shape)
    g, w = got.reshape(-1), want.reshape(-1)
    sl = [slice(i, i + (1 << 26)) for i in range(0, g.numel(), 1 << 26)]
    top = max(float(w[s_].abs().max()) for s_ in sl)
    rel = diff = excess = torch.full((), -float("inf"), device=got.device)
    for s_ in sl:
        dd, ww = (g[s_] - w[s_]).abs(), w[s_].abs()
        rel = torch.maximum(rel, (dd / ww.clamp(min=1.0)).max())
        diff = torch.maximum(diff, dd.max())
        excess = torch.maximum(excess, (dd - MT_GRAD_RTOL * ww.clamp(min=1.0)
                                        - MT_GRAD_ATOL * top).max())
    return float(rel), float(diff) / max(top, 1e-30), float(excess)


def _bits_fingerprint(t) -> tuple[int, int]:
    """Two position-weighted int64 sums of a float32 tensor's bits, on the
    card: equal tensors give equal pairs, and a change that keeps both
    takes a contrived pattern (4 GB of slot gradients a rank would take
    seconds to hash on the host)."""
    flat = t.detach().contiguous().view(-1).view(torch.int32)
    a = b = torch.zeros((), dtype=torch.int64, device=t.device)
    for i in range(0, flat.numel(), 1 << 26):
        bits = flat[i: i + (1 << 26)].to(torch.int64)
        pos = torch.arange(i, i + bits.numel(), device=t.device, dtype=torch.int64)
        a = a + (bits * (pos % 65521 + 1)).sum()
        b = b + (bits * (pos % 65519 + 7)).sum()
    return int(a), int(b)


def _dense_sha(params) -> list:
    """sha256 of every dense leaf's bits (host copies, one leaf at a time)."""
    import hashlib

    from repro_torch.train.optimizer import expert_flags, leaves

    return [hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                           .tobytes()).hexdigest()
            for t, f in zip(leaves(params), expert_flags(params)) if not f]


class _CollectiveWalls:
    """The group's collectives timed (synchronized before and after) by
    kind, split into the backward (autograd off inside a train step's
    backward) and AdamW (``inside``); installed on the class, so every
    subgroup's view is counted."""

    def __init__(self):
        from repro_torch.exchange.dist import WorkerGroup

        self.cls, self.saved = WorkerGroup, {}
        self.ms = {}
        self.phase = "forward"
        for name in ("_reduce", "_all_to_all", "_all_to_all_uneven", "_gather_rows"):
            fn = self.saved[name] = getattr(WorkerGroup, name)
            setattr(WorkerGroup, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def call(group, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(group, *a, **k)
            torch.cuda.synchronize()
            phase = self.phase if self.phase != "forward" or torch.is_grad_enabled() else (
                "backward")
            key = f"{phase}/{name.lstrip('_')}"
            self.ms[key] = self.ms.get(key, 0.0) + (time.perf_counter() - t) * 1e3
            return res
        return call

    def undo(self):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def mesh_train_rank(rank: int, world: int, plan: dict) -> None:
    """Phase 28's rank ``rank`` of ``world``: (a) at (1, 4) and (2, 2) the
    float32 layer's gradients on its own slots against the stacked ones the
    parent saved, (b) at (1, 2) the training steps and the safe point; saves
    what it saw beside the store.  A failure raises, and the parent
    re-raises it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.exchange.dist import WorkerGroup
    from repro_torch.kernels import build

    build.library()
    g = WorkerGroup.init(backend="gloo", rank=rank, world_size=world,
                         init_method=f"file://{plan['store']}", device="cuda")
    out = {"rank": rank}
    if plan["part"] == "layer":
        _mt_layer_rank(g, plan, out)
    else:
        _mt_train_rank(g, plan, out)
    g.close()
    torch.save(out, Path(plan["store"]).with_name(f"{Path(plan['store']).name}.rank{rank}.pt"))


def _mt_layer_rank(g, plan, out) -> None:
    import hashlib

    from repro_torch.carry import rank_slots
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import MeshShape, ProcessMesh
    from repro_torch.launch.sharding import ShardingOptions, make_policy
    from repro_torch.moe.layer import moe_apply, moe_apply_replicated

    dev = torch.device("cuda")
    full = get_config("llama4-scout-17b-a16e")
    e = full.moe.num_experts
    inv = torch.as_tensor(plan["inv"], device=dev)
    for mname, dims in MESHES.items():
        pm = ProcessMesh(MeshShape(dims, ("data", "model")), g)
        slots = rank_slots(pm, e, plan["place"])
        p, xs, cots = _mt_layer(full, dev, slots)
        j, ntp = pm.coords["model"], dims[1]
        quarters = range(j * (4 // ntp), (j + 1) * (4 // ntp))
        opts = ShardingOptions(compute_dtype=torch.float32, param_dtype=torch.float32, moe_cf=8.0)
        for path, fn, backends in (("apply", moe_apply, ("dense", "ragged")),
                                   ("replicated", moe_apply_replicated, ("dense",))):
            want = torch.load(MT_DIR / f"a_{path}_common.pt", map_location=dev)
            slot_want = [torch.load(MT_DIR / f"a_{path}_q{q}.pt", mmap=True) for q in quarters]
            for be in backends:
                pol = dataclasses.replace(make_policy(full, pm, "train", opts),
                                          exchange_backend=be)
                before = dict(g.traffic)
                g.barrier()
                torch.cuda.reset_peak_memory_stats()
                res, loss, grads, wall = _mt_grads(fn, p, xs[path], cots[path], full.moe,
                                                   full.ffn_kind, pol, inv, path)
                rec = {"wall_ms": wall, "peak": torch.cuda.max_memory_allocated(),
                       "loss": loss, "counts": res.counts.cpu(),
                       "overflow": float(res.overflow),
                       "traffic": {k: v - before[k] for k, v in g.traffic.items()},
                       "errs": {}, "sha": {}}
                if res.occupied_rows is not None:
                    rec["occupied"] = int(res.occupied_rows)
                for leaf in ("x", "router", "shared/wi", "shared/wo"):
                    rec["errs"][leaf] = _grad_err(grads[leaf], want[leaf])
                    rec["sha"][leaf] = hashlib.sha256(
                        grads[leaf].cpu().numpy().tobytes()).hexdigest()
                parts = {"wi": [], "wo": []}
                at = 0
                for part in slot_want:
                    n = part["wi"].shape[0]
                    for name in ("wi", "wo"):
                        parts[name].append(_grad_err(grads[name][at: at + n],
                                                     part[name].to(dev)))
                    at += n
                for name, errs in parts.items():   # over the quarters' largest entries
                    rec["errs"][name] = tuple(max(e_[i] for e_ in errs) for i in range(3))
                rec["sha"]["wi/wo"] = [_bits_fingerprint(grads[n]) for n in ("wi", "wo")]
                out[f"{mname}/{path}/{be}"] = rec
                del res, grads
                torch.cuda.empty_cache()
            del want, slot_want
        out[f"{mname}/held"] = sum(t.numel() * t.element_size() for t in _leaves(p))
        del p, xs, cots
        torch.cuda.empty_cache()


def _mt_train_setup(dev, mesh=None):
    """(b)'s configuration, options, optimizer config and batch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.sharding import default_options
    from repro_torch.train.optimizer import OptConfig

    full = get_config("llama4-scout-17b-a16e")
    cfg = dataclasses.replace(full, num_layers=MT_TRAIN_LAYERS)
    opts = default_options(full)   # fsdp (a layout the port does not execute), bf16 moments
    ocfg = OptConfig(lr=MT_LR, warmup=1, moment_dtype=opts.moment_dtype)
    rng = np.random.default_rng(MT_SEED + 3)
    toks = rng.integers(0, cfg.vocab_size, (MT_TRAIN_BATCH[0], MT_TRAIN_BATCH[1] + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
             "labels": torch.as_tensor(toks[:, 1:], device=dev),
             "mask": torch.ones(MT_TRAIN_BATCH, dtype=torch.float32, device=dev)}
    return full, cfg, opts, ocfg, batch


def _mt_train_rank(g, plan, out) -> None:
    from repro_torch.carry import gather_rank_params, init_rank_params
    from repro_torch.launch.mesh import MeshShape, ProcessMesh
    from repro_torch.launch.sharding import make_policy
    from repro_torch.moe.kip_placement import PlacementController, apply_placement_in_place
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import init_opt

    dev = torch.device("cuda")
    full, cfg, opts, ocfg, batch = _mt_train_setup(dev)
    pm = ProcessMesh(MeshShape(MT_TRAIN_MESH, ("data", "model")), g)
    pol = make_policy(cfg, pm, "train", opts)
    out["policy"] = {"remat": pol.remat, "remat_policy": pol.remat_policy,
                     "param_dtype": str(pol.param_dtype), "fsdp": opts.fsdp,
                     "moment_dtype": str(ocfg.moment_dtype)}
    t = time.perf_counter()
    params = init_rank_params(cfg, MT_SEED + 2, pol, device=dev)
    opt = init_opt(params, ocfg)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t
    out["param_bytes"] = sum(x.numel() * x.element_size() for x in _leaves(params))
    out["opt_bytes"] = sum(x.numel() * x.element_size() for x in _leaves([opt.m, opt.v]))
    step = ts.make_train_step(cfg, pol, ocfg)
    walls = _CollectiveWalls()
    orig_apply = ts.apply_updates
    adamw = []

    def timed_apply(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walls.phase = "adamw"
        try:
            res = orig_apply(*a, **k)
            torch.cuda.synchronize()
        finally:
            walls.phase = "forward"
        adamw.append((time.perf_counter() - t0) * 1e3)
        return res

    from repro_torch.kernels import ops
    from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain

    captured = []
    orig_slots = ops.dispatch_slots

    def slots_capture(dest, valid=None, *, num_parts):
        if len(captured) < 2:   # the first step's hop 1 and hop 2
            captured.append((dest.clone(), None if valid is None else valid.clone(), num_parts))
        return orig_slots(dest, valid, num_parts=num_parts)

    ts.apply_updates = timed_apply
    ops.dispatch_slots = slots_capture
    steps = []
    try:
        for i in range(MT_STEPS):
            walls.ms = {}
            before = dict(g.traffic)
            _zero_launch_counts()
            g.barrier()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            steps.append({"wall_ms": wall, "adamw_ms": adamw[-1], "coll_ms": dict(walls.ms),
                          "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "lr": float(m["lr"]), "overflow": float(m["overflow"]),
                          "counts": m["expert_counts"].cpu(),
                          "launches": _launch_counts(),
                          "traffic": {k: v - before[k] for k, v in g.traffic.items()},
                          "peak": torch.cuda.max_memory_allocated(),
                          "dense": _dense_sha(params)})
    finally:
        ts.apply_updates = orig_apply
        ops.dispatch_slots = orig_slots
        walls.undo()
    out["steps"] = steps
    # dispatch_count on this rank's own hop inputs, timed on rank 0 alone
    dc = {}
    for name, (dest, valid, parts) in zip(("hop 1", "hop 2"), captured):
        valid = torch.ones_like(dest, dtype=torch.bool) if valid is None else valid
        dest = dest.to(torch.int32).contiguous()
        got = dispatch_count(dest, valid, num_parts=parts)
        want = dispatch_count_plain(dest, valid, num_parts=parts)
        torch.cuda.synchronize()
        w, n = dest.shape
        dc[name] = {"equal": all(torch.equal(a, b) for a, b in zip(got, want)),
                    "shape": f"W={w} n={n} L={parts}", "valid": int(valid.sum()),
                    "bytes": w * n * (4 + 1) + w * n * 4 + w * parts * 4}
        if g.rank == 0:
            dc[name].update(
                ms=cuda_ms(lambda: dispatch_count(dest, valid, num_parts=parts)),
                plain_ms=cuda_ms(lambda: dispatch_count_plain(dest, valid, num_parts=parts)),
                device_ms=device_ms(lambda: dispatch_count(dest, valid, num_parts=parts)))
    g.barrier()
    out["dispatch_count"] = dc
    del captured
    g.barrier()   # every rank holds its parameters and moments
    free, total = torch.cuda.mem_get_info()
    out["card_used"] = total - free

    # ---- the safe point -------------------------------------------------
    e = cfg.moe.num_experts
    e_loc = e // MT_TRAIN_MESH[1]
    ctl = PlacementController(e, MT_TRAIN_MESH[1])
    ctl.observe(steps[-1]["counts"].numpy())
    changed, _, perm = ctl.maybe_update()
    digest = ctl.check_agreement(g)
    perm = np.asarray(perm, np.int64)
    crossing = (perm // e_loc != np.arange(e) // e_loc).any()
    forced = not (changed and crossing)
    if forced:   # the controller kept every expert on its rank: swap one across
        perm = np.arange(e)
        perm[[0, e_loc]] = perm[[e_loc, 0]]
    mine = perm[pm.coords["model"] * e_loc: (pm.coords["model"] + 1) * e_loc]
    moved, move_ms, before = True, 0.0, dict(g.traffic)
    for tree in ts.moe_state(params, opt):
        whole = gather_rank_params(tree, pm)
        g.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_placement_in_place([tree], perm, pm)
        torch.cuda.synchronize()
        move_ms += (time.perf_counter() - t0) * 1e3
        idx = torch.as_tensor(mine, device=dev)
        moved &= all(torch.equal(tree[n], whole[n].index_select(0, idx)) for n in ("wi", "wo"))
        del whole
        torch.cuda.empty_cache()
    out["safe_point"] = {"changed": bool(changed), "forced": bool(forced), "digest": digest,
                         "perm": perm.tolist(), "moved_equal": bool(moved), "move_ms": move_ms,
                         "crossing_slots": int((perm // e_loc != np.arange(e) // e_loc).sum()),
                         "traffic": {k: v - before[k] for k, v in g.traffic.items()},
                         "leaf": bool(params["layers"][0]["moe"]["wi"].requires_grad)}
    del params, opt


def mesh_train_phase(dev, card) -> dict:
    """Phase 28: training under ``Policy.mesh``.  (a) One MoE layer of
    Llama 4 Scout at full width, float32, on four gloo ranks at (1, 4) and
    (2, 2): ``moe_apply`` (dense, native ragged) and
    ``moe_apply_replicated``, every gradient (``x``, router, shared
    expert, each rank's ``wi`` / ``wo`` slots) against the stacked
    ``Policy(ep_shards=4)`` path's on the same weights, computed here first
    and freed before the spawn.  (b) Scout at full width, one layer, bf16,
    under ``make_policy(..., "train", default_options)`` at (1, 2) on two
    gloo ranks: three steps on one batch against the stacked
    ``Policy(ep_shards=2)`` step, then the safe point's move across ranks.
    (c) Walls, gloo bytes, memory and launches.  Returns the ``kernels``
    line's phase-28 entries by kernel name."""
    import shutil

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import policy_fields
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.moe.kip_placement import apply_placement_to_weights
    from repro_torch.moe.layer import moe_apply, moe_apply_replicated
    from repro_torch.train.optimizer import init_opt
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    full = get_config("llama4-scout-17b-a16e")
    spec, e, d = full.moe, full.moe.num_experts, full.d_model
    place = np.roll(np.arange(e), MT_PLACE_ROLL)
    inv = np.zeros(e, np.int32)
    inv[place] = np.arange(e, dtype=np.int32)
    MT_DIR.mkdir(parents=True, exist_ok=True)

    # ---- (a) the stacked gradients, saved for the ranks --------------------
    p, xs, cots = _mt_layer(full, dev)
    p = apply_placement_to_weights(p, place)
    for path, x in xs.items():
        logits = x.reshape(-1, d).double() @ p["router"].double()
        top = torch.topk(logits, 2).values
        margin = float((top[:, 0] - top[:, 1]).min())
        assert margin > MT_ROUTER_MARGIN, (path, margin)
    spol = Policy(moe_capacity_factor=8.0, tp=4, ep_shards=4)
    stacked = {}
    for path, fn in (("apply", moe_apply), ("replicated", moe_apply_replicated)):
        torch.cuda.reset_peak_memory_stats()
        res, loss, grads, wall = _mt_grads(fn, p, xs[path], cots[path], spec, full.ffn_kind,
                                           spol, torch.as_tensor(inv, device=dev), path)
        stacked[path] = {"wall_ms": wall, "loss": loss, "counts": res.counts.cpu(),
                         "overflow": float(res.overflow),
                         "occupied": None if res.occupied_rows is None else int(
                             res.occupied_rows),
                         "peak": torch.cuda.max_memory_allocated()}
        torch.save({k: grads[k].cpu() for k in ("x", "router", "shared/wi", "shared/wo")},
                   MT_DIR / f"a_{path}_common.pt")
        for q in range(4):   # quarters of the slots: a (1, 4) rank's, or half a (2, 2) rank's
            torch.save({n: grads[n][q * (e // 4): (q + 1) * (e // 4)].cpu()
                        for n in ("wi", "wo")}, MT_DIR / f"a_{path}_q{q}.pt")
        del res, grads
    whole_bytes = sum(t.numel() * t.element_size() for t in _leaves(p))
    del p, xs, cots
    gc.collect()
    torch.cuda.empty_cache()
    pre_s = time.perf_counter() - t_phase
    log(f"phase 28 (a): the stacked Policy(ep_shards=4) gradients in this process, "
        f"{pre_s:.1f} s with saving them under build/phase28 ({whole_bytes / 1e9:.2f} GB of "
        f"float32 layer; forward + backward {stacked['apply']['wall_ms']:.1f} ms moe_apply, "
        f"{stacked['replicated']['wall_ms']:.1f} ms replicated; peaks "
        f"{stacked['apply']['peak'] / 1e9:.2f} / {stacked['replicated']['peak'] / 1e9:.2f} GB)")

    t = time.perf_counter()
    plan = {"store": str(MT_DIR / "store"), "part": "layer", "place": place, "inv": inv}
    ranks = spawn_ranks(mesh_train_rank, MT_WORLD_A, plan, MT_TIMEOUT_S, 28)
    spawn_a = time.perf_counter() - t
    lines = []
    for key in ranks[0]:
        if key.count("/") != 2:
            continue
        mname, path, be = key.split("/")
        want = stacked[path]
        recs = [r[key] for r in ranks]
        for rec in recs:
            assert torch.equal(rec["counts"], want["counts"]), key
            assert rec["overflow"] == want["overflow"] == 0.0, key
            if path == "apply":
                assert rec["occupied"] == want["occupied"], key
            assert max(e_[2] for e_ in rec["errs"].values()) <= 0.0, (key, rec["errs"])
            for leaf in ("x", "router", "shared/wi", "shared/wo"):
                assert rec["sha"][leaf] == recs[0]["sha"][leaf], (key, leaf)
        errs = {leaf: tuple(max(rec["errs"][leaf][i] for rec in recs) for i in range(2))
                for leaf in recs[0]["errs"]}
        wall = max(rec["wall_ms"] for rec in recs)
        peak = max(rec["peak"] for rec in recs)
        traffic = {k: v for k, v in recs[0]["traffic"].items() if v}
        lines.append(f"{key}: gradients against stacked (max |diff| / max(1, |stacked|), / the "
                     f"leaf's max |stacked|) "
                     f"{', '.join(f'{k} {v[0]:.3g} / {v[1]:.3g}' for k, v in errs.items())}; "
                     f"forward + backward {wall:.1f} ms (stacked {want['wall_ms']:.1f}); peak "
                     f"{peak / 1e9:.2f} GB a rank; gloo bytes rank 0 {traffic}")
    for mname, dims in MESHES.items():
        reps = {}
        for r in ranks:
            coord = (r["rank"] // dims[1], r["rank"] % dims[1])
            for key in (k for k in r if k.startswith(mname) and k.count("/") == 2):
                reps.setdefault((key, coord[1]), set()).add(tuple(r[key]["sha"]["wi/wo"]))
        assert all(len(v) == 1 for v in reps.values()), mname
    held = {m: max(r[f"{m}/held"] for r in ranks) for m in MESHES}
    log(f"phase 28 (a): {full.name}'s MoE layer at full width (d {d}, {e} experts top-"
        f"{spec.top_k}, d_ff {spec.d_ff_expert}, shared expert), float32, capacity 8.0, slots "
        f"permuted (slot p holds expert (p - {MT_PLACE_ROLL}) mod {e}), moe_apply on "
        f"{MT_APPLY_TOKENS[0]} x {MT_APPLY_TOKENS[1]} tokens (loss sum(y * C): its aux is the "
        f"mean over the mesh's blocks, another blocking than the stacked path's at (2, 2)) and "
        f"the replicated path on {MT_REP_TOKENS[0]} x {MT_REP_TOKENS[1]} (sum(y * C) + "
        f"{MT_AUX_W} aux), {MT_WORLD_A} gloo ranks: counts, drops (0) and occupied rows equal "
        f"to the stacked path's, every gradient within {MT_GRAD_RTOL:g} x max(1, |stacked|) + "
        f"{MT_GRAD_ATOL:g} x the leaf's max |stacked|, x / "
        f"router / shared equal on every rank (sha256) and the slot gradients on each model "
        f"coordinate's data replicas (a fingerprint of their bits); " + "; ".join(lines) + f"; a rank holds "
        f"{held['1x4'] / 1e9:.2f} GB (1, 4) and {held['2x2'] / 1e9:.2f} GB (2, 2) of float32 "
        f"layer (reckoned: {whole_bytes / 1e9:.2f} GB x (1 / 4 or 1 / 2 of the experts, all of "
        f"the shared expert and router)), with its gradients twice that before activations; "
        f"the ranks' run {spawn_a:.1f} s; card {card}")
    shutil.rmtree(MT_DIR, ignore_errors=True)
    MT_DIR.mkdir(parents=True, exist_ok=True)

    # ---- (b) the stacked training step first, in this process --------------
    _, cfg, opts, ocfg, batch = _mt_train_setup(dev)
    spol = Policy(ep_shards=MT_TRAIN_MESH[1],
                  **policy_fields(MeshShape(MT_TRAIN_MESH, ("data", "model")), opts))
    params = model.init_params(cfg, MT_SEED + 2, spol, device=dev)
    opt = init_opt(params, ocfg)
    step = make_train_step(cfg, spol, ocfg)
    torch.cuda.reset_peak_memory_stats()
    want = []
    for _ in range(MT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        want.append({"wall_ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "counts": m["expert_counts"].cpu()})
    stacked_peak = torch.cuda.max_memory_allocated()
    del params, opt, step, m
    gc.collect()
    torch.cuda.empty_cache()
    outside, per_layer = _rank_bytes(full, MT_TRAIN_MESH[1])
    p_rank = outside + MT_TRAIN_LAYERS * per_layer
    reckoned = 4 * p_rank    # bf16 parameters, gradients and both moments
    outside4, per_layer4 = _rank_bytes(full, 4)
    log(f"phase 28 (b): reckoning at {MT_TRAIN_MESH}, bf16 at 8 bytes a parameter "
        f"(parameter, gradient, bf16 m and v): a rank holds {outside / 2e9:.3f} B parameters "
        f"outside the layers and {per_layer / 2e9:.3f} B a layer ({e // MT_TRAIN_MESH[1]} of "
        f"{e} experts) = {reckoned / 1e9:.2f} GB before activations, "
        f"{MT_TRAIN_MESH[1] * reckoned / 1e9:.2f} GB for both ranks; at (1, 4) four ranks "
        f"would hold {4 * 4 * (outside4 + per_layer4) / 1e9:.2f} GB at one layer (more than "
        f"the card's 80 GB)")

    t = time.perf_counter()
    plan = {"store": str(MT_DIR / "store"), "part": "train"}
    ranks = spawn_ranks(mesh_train_rank, MT_TRAIN_MESH[0] * MT_TRAIN_MESH[1], plan,
                        MT_TIMEOUT_S, 28)
    spawn_b = time.perf_counter() - t
    r0 = ranks[0]
    for r in ranks:
        assert r["policy"] == r0["policy"] and r["policy"]["remat_policy"] == "nothing"
        for i, (s_, s0) in enumerate(zip(r["steps"], r0["steps"])):
            assert (s_["loss"], s_["grad_norm"], s_["lr"]) == (s0["loss"], s0["grad_norm"],
                                                                s0["lr"]), (r["rank"], i)
            assert s_["dense"] == s0["dense"], ("dense leaves differ", r["rank"], i)
            assert torch.equal(s_["counts"], s0["counts"]), (r["rank"], i)
            assert s_["launches"] == s0["launches"], (r["rank"], i)
        sp = r["safe_point"]
        assert sp["digest"] == r0["safe_point"]["digest"] and sp["perm"] == r0["safe_point"]["perm"]
        assert sp["moved_equal"] and sp["leaf"] and sp["crossing_slots"] > 0, sp
    losses = [s_["loss"] for s_ in r0["steps"]]
    errs = []
    for s_, w in zip(r0["steps"], want):
        assert np.isfinite(s_["loss"]) and np.isfinite(s_["grad_norm"])
        le = abs(s_["loss"] - w["loss"]) / abs(w["loss"])
        ge = abs(s_["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
        errs.append((le, ge, bool(torch.equal(s_["counts"], w["counts"]))))
        assert le <= MT_LOSS_RTOL and ge <= MT_GNORM_RTOL, errs
    assert losses[-1] < losses[0], losses
    launches = r0["steps"][-1]["launches"]
    assert launches["dispatch_count"] > 0 and launches["flash_attention"] > 0 and (
        launches["flash_attention_bwd"] > 0), launches
    dc_rows = r0["dispatch_count"]
    assert len(dc_rows) == 2 and all(v["equal"] for r in ranks
                                     for v in r["dispatch_count"].values()), dc_rows
    for name, row in dc_rows.items():
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"phase 28 (c): dispatch_count [{name}] {row['shape']} ({row['valid']} valid) on "
            f"every rank's own inputs of a training step: bit-equal to its plain version; rank "
            f"0: {row['ms']:.4f} ms by events around one call, device time "
            f"{row['device_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.6f} ms by bytes ({row['bytes']} bytes); card {card}")
    wall = [max(r["steps"][i]["wall_ms"] for r in ranks) for i in range(MT_STEPS)]
    adamw = [max(r["steps"][i]["adamw_ms"] for r in ranks) for i in range(MT_STEPS)]
    coll = {}
    for r in ranks:
        for k, v in r["steps"][-1]["coll_ms"].items():
            coll[k] = max(coll.get(k, 0.0), v)
    bwd_sums = sum(v for k, v in coll.items() if k.startswith("backward/"))
    peak = max(s_["peak"] for r in ranks for s_ in r["steps"])
    sp = r0["safe_point"]
    log(f"phase 28 (b): {full.name} at full width, {MT_TRAIN_LAYERS} of {full.num_layers} "
        f"layers, make_policy(cfg, mesh, 'train', default_options) on a {MT_TRAIN_MESH} "
        f"ProcessMesh of 2 gloo ranks ({r0['policy']}), {MT_TRAIN_BATCH[0]} x "
        f"{MT_TRAIN_BATCH[1]} tokens repeated, OptConfig(lr={MT_LR:g}, warmup=1): losses "
        f"{[round(v, 5) for v in losses]} (falling), grad norms "
        f"{[round(s_['grad_norm'], 5) for s_ in r0['steps']]}; against Policy(ep_shards=2) in "
        f"this process (losses {[round(w['loss'], 5) for w in want]}, norms "
        f"{[round(w['grad_norm'], 5) for w in want]}): loss / grad_norm relative differences "
        f"{[(float(f'{a:.3g}'), float(f'{b:.3g}'), c) for a, b, c in errs]} (<= "
        f"{MT_LOSS_RTOL:g} / {MT_GNORM_RTOL:g}; the last: expert counts equal); both ranks' "
        f"loss, grad_norm, lr, counts and every dense leaf (sha256) equal after every step; "
        f"card {card}")
    log(f"phase 28 (b): the safe point: the controllers' digests equal ({sp['digest']}), "
        f"{'no move crossing ranks from the controller, so a forced swap' if sp['forced'] else 'the controller moved experts across ranks'}"
        f" (perm {sp['perm']}, {sp['crossing_slots']} slots cross ranks); wi, wo, m and v "
        f"after the move equal the gathered tensors from before it, permuted, bit for bit on "
        f"both ranks; move {max(r['safe_point']['move_ms'] for r in ranks):.1f} ms (the slowest "
        f"rank; gloo bytes rank 0 {({k: v for k, v in sp['traffic'].items() if v})})")
    fwd_bwd = [max(s_["wall_ms"] - s_["adamw_ms"] for s_ in (r["steps"][i] for r in ranks))
               for i in range(MT_STEPS)]
    log(f"phase 28 (c): walls a step (the slowest rank): {[round(w, 1) for w in wall]} ms: "
        f"forward + backward {[round(w, 1) for w in fwd_bwd]} ms, AdamW "
        f"{[round(a, 1) for a in adamw]} ms; in the last step, collectives "
        f"with autograd off (the backward's gradient sums and hop transposes, and the remat "
        f"recompute's hops) {bwd_sums:.1f} ms, by kind "
        f"{({k: round(v, 1) for k, v in coll.items()})}; the stacked step "
        f"{[round(w['wall_ms'], 1) for w in want]} ms; gloo bytes a step rank 0 "
        f"{({k: v for k, v in r0['steps'][-1]['traffic'].items() if v})}; peak allocated "
        f"{peak / 1e9:.2f} GB a rank (parameters {r0['param_bytes'] / 1e9:.2f} GB, moments "
        f"{r0['opt_bytes'] / 1e9:.2f} GB; reckoned {reckoned / 1e9:.2f} GB before "
        f"activations), the card's use with both ranks up {r0['card_used'] / 1e9:.2f} GB, the "
        f"stacked step's peak {stacked_peak / 1e9:.2f} GB; launches a step a rank {launches}; "
        f"rank init {max(r['init_s'] for r in ranks):.1f} s; the ranks' run {spawn_b:.1f} s; "
        f"card {card}")
    shutil.rmtree(MT_DIR, ignore_errors=True)
    log(f"phase 28: {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return {"dispatch_count": {"launches_phase_28": [r["steps"][-1]["launches"]["dispatch_count"]
                                                     for r in ranks], "phase_28": dc_rows},
            "flash_attention": {"launches_phase_28": [r["steps"][-1]["launches"][
                "flash_attention"] for r in ranks]},
            "flash_attention_bwd": {"launches_phase_28": [r["steps"][-1]["launches"][
                "flash_attention_bwd"] for r in ranks]}}


if __name__ == "__main__":
    sys.exit(main())
