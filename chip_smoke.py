"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

    python3 chip_smoke.py

The Recommendation path: ALS trains on ML-20M-shaped ratings (137,931
users x 27,027 items, 20M ratings, rank 64) through ``pio train``'s
workflow (``run_train`` of an engine whose DataSource hands over the
ratings made in memory) and the hand-written CUDA Gauss-Jordan solve
kernel (one warp per system at rank 64); a ``QueryService`` serves the
stored instance, and 64 ``POST /queries.json`` requests are checked
against a float64 numpy top-10 of the same factors. The same ratings
train again at rank 128 (``[als-wide]``), where every solve takes the
blocked kernel (A in the registers of one thread block a system).

The Two-Tower path: the towers train the same way on the JAX package
bench's planted-preference pairs (1M pairs over 20,000 users x 10,000
items, dim 64, batch 8192, 10 epochs) through the hand-written CUDA fused
in-batch softmax-CE kernels (forward and backward), and the stored towers
answer 64 queries, checked against a float64 numpy top-10 with the seen
filter.

The quickstart path: ``pio app new``, ``pio import`` of the ML-100K
replica's 100,000 ``rate`` events as an NDJSON file into the port's event
store (sqlite), ``pio train`` of the Recommendation engine (rank 64, so
the CUDA solve is on the path) through the DASE spine, ``pio deploy`` as a
subprocess answering 64 ``POST /queries.json`` checked against a float64
numpy top-10 of the stored model, then ``pio eval`` of the engine with
``PrecisionAtK(10)`` over two folds.

The Two-Tower quickstart path: the same verbs for the Two-Tower engine
on 100,000 planted-preference ``view`` events (2,000 users x 1,000 items)
in the columnar event store, at dim 64, batch 8192, 10 epochs, so the
fused-CE kernels run in ``pio train`` and in ``pio eval``
(``RecallAtK(10)``).

The workflow path (the JAX package's ``bench.py::_bench_workflow`` at the
ML-20M shape, cut to half its ratings to hold the script's length):
10,000,000 ``rate`` events written into a columnar store,
``pio train`` of the Recommendation engine (rank 64, 10 sweeps), 200,000
new events through ``pio eventserver``'s bulk route, a second ``pio
train`` that reads only the new segments and tail lines through the
incremental training cache, ``pio deploy`` and ``pio app compact``.

The serving path, on the workflow's store and its warm instance (69,965
users x 13,563 items from its 10M ratings, rank 64): ``pio deploy`` per
request against ``pio deploy --batching --pin-model --result-cache --coalesce --feedback`` under
32 keep-alive clients, ``pio train --warm-start``, ``POST /reload`` under
load and a degraded one, ``pio undeploy``, ``pio batchpredict``, reloads
of an in-process ``QueryService``; and a ``--batching --pin-model``
deploy of the Two-Tower quickstart's instance.

The online path, on the same warm instance: ``pio deploy`` against ``pio
deploy --online`` under 8 keep-alive clients while 500 events/s arrive
through ``pio eventserver``'s bulk route, the online one probed for
freshness with new users' events; then the same events folded in process
and held to float64 numpy; and the Two-Tower quickstart's instance served
with online learning while 256 view events stream into its towers.

The templates path: SimilarProduct and ECommerce (implicit ALS through
the same solve kernel at rank 32), Classification and Text-Classification,
each through ``pio template get``, ``pio import``, ``pio train``, ``pio
deploy`` and (the classifiers) ``pio eval``.

The sharded path: ``pio deploy --shard-factors`` — each factor table
row-sharded over an 8-way mesh on the card — alone and with ``--quantize
int8``, ``--ann`` and ``--online``, against the replicated tiers, and the
JAX bench's sharded sweep up to 1,048,576 items.

The training mesh and the multi-process tier (``[multihost]``): the ALS
path's ratings trained on a ``(data=2, model=4)`` mesh of the card
repeated, held to the single-device factors, with a checkpointed run
resumed on ``(4, 2)``; two ranks sharing the card through the
``PIO_COORDINATOR_*`` triplet (gloo), each with its round-robin half of
the ratings, and a one-rank NCCL group; ``pio export --sharded 2`` and two
``pio train --mesh data=1`` processes on the quickstart's events; a
Two-Tower epoch on a ``(2, 4)`` mesh.

The approximate and int8 retrieval path: ``pio deploy --ann`` and
``--quantize int8`` on the same warm instance and on the Two-Tower
quickstart's, the full probe held to exact retrieval to the bit, an
online fold into int8 tables and their IVF index, and the JAX bench's IVF
and int8 sweeps over catalogs of up to 262,144 items.

Phases, in order; any failure exits non-zero and prints no result:

1. device — the card's name, power limit and count; no CUDA device fails.
2. build  — every kernel built from ``predictionio_tpu_torch/ops/csrc``, one
   ``nvcc`` per source, all at once (``-Xptxas -v``: register and
   shared-memory lines printed; a spill in any function fails), and the
   count of tensor-core ``HMMA`` instructions in the built fused-CE
   library (``cuobjdump -sass``).
3. kernel — each kernel held against its plain PyTorch version and the
   library call at the shapes its path gives it, on inputs made on the
   card; times by CUDA events, and the host's time to issue a call. A
   solve row adds the launch plan (kernel, shared bytes per block,
   threads, cluster, warps per SM, grid, registers) and the achieved
   GB/s; above K = 64 (``SOLVE_SHAPES``: ``[4096,128,128]`` and
   ``[64,256,256]``, where the first port's kernel was measured, the
   chunk cap at K = 128, the JAX package's on-chip acceptance shape
   ``[8000,128,128]`` and a rank-256 chunk) the plain version is
   ``gj_solve_wide_reference``. Then the K <= 64 kernel is timed per
   system at each of ``SOLVE_WIDTHS`` (K = 8 is the [chaos] drills').
   The fused-CE forward is one call (both sums), the backward one call of
   two launches (``d_ue``, then ``d_ie`` with the towers swapped); each
   row adds the achieved tensor-core FLOP/s and exponentials/s. Two of
   ``FUSED_CE_SHAPES`` are wider than the kernels' full-width path
   (D = 512 and 264), which take the chunked wide kernels.
4. ALS    — in a temporary ``PIO_FS_BASEDIR``: the launch counts are set to
   0, ``run_train`` trains on the card, a ``QueryService`` of the stored
   instance answers 64 queries over HTTP, and the counts are read and
   checked against the bucket plan; ``ALSConfig.bucketing="auto"`` must
   bucket both sides on the card (``build_buckets_device``, each timed to
   a synchronise; sweep 1 timed from its end). ``[bucketing]``: both
   sides bucketed on the host and on the card from the same arrays, every
   array ``torch.equal``, the host and device seconds, the bytes sent up
   and the readbacks (an aten-level count). Then one user half-sweep is
   held against the same half-sweep with the plain solve, and one more
   sweep runs under torch.profiler: device time by kernel and busy share.
   ``[als-config]``: small trains on the quickstart's ratings with
   ``solver="cholesky"`` (0 launches, the cross-solver band of "auto"),
   ``rank_pad_multiple=8`` at rank 10 (K 16, launches = plan) and
   ``precision="high"`` (train RMSE within 1e-3 of "highest"), the matmul
   settings as they were after each. ``[als-wide]`` (``phase_als_wide``):
   the counts set to 0, ``run_train`` of the same ratings at rank
   ``WIDE_RANK`` (128) for ``WIDE_SWEEPS`` (3) with every solve's shape
   recorded, 64 queries over HTTP, the counts read: launches = the plan,
   every solve at K = 128, the RMSE falling, the top-10s float64
   numpy's; one steady sweep under torch.profiler; the kernel timed at
   the largest and smallest batch the train gave it; and the same train
   with ``solver="cholesky"`` (0 launches), its sweep times printed and
   its factors within ``KNOB_RTOL``/``KNOB_ATOL`` of the kernel's.
4b. multihost — (a) with (d) (``phase_mh_group``), (b) and (c) in child
   processes started with phase 6's once phase 8's cold train is in, and
   joined with them before the fleets. (a) ``train_als(mesh=)`` of phase 4's
   ratings on ``MH_MESH`` over ``(cuda:0,)*8``: train RMSE within
   ``MH_RMSE_RTOL`` (relative) of phase 4's stored factors, the top-10 of
   64 users under the near-tie rule at ``MH_TIE_RTOL`` (the two sum in
   other orders; the largest gap printed), the largest relative factor
   difference printed, ``gj_solve`` launches = the mesh plan
   (``planned_solves(data=)``), each position's bytes of both tables =
   ``sharded_table_bytes``; a 4-sweep run checkpointing every 2 sweeps,
   resumed to 6 on ``MH_RESUME_MESH``, within ``MH_CKPT_RTOL`` of the
   uninterrupted run's sweep 6. (b) ``phase_mh_rank`` twice with the
   triplet on a free port: the rule takes gloo (two ranks, one card),
   each rank its ``rows[r::2]``, launches = the multi-process plan, the
   bytes it receives at most ``MH_TRAFFIC_SLACK`` × the ratings it owns;
   rank 0's factors held to phase 4's as in (a); ``phase_mh_nccl``, a
   one-rank group that the rule puts on NCCL, runs one all-gather; an
   NCCL request for two ranks on one card raises. (c) ``phase_mh_cli``:
   the quickstart's 100,000 events in sqlite, ``pio export --sharded 2``
   (the shard files complete), a single-process ``pio train`` and two
   ``pio train --mesh data=1`` processes (launches = their plans), process
   0's blob against the single one for every user's top-10 (near-tie
   rule at ``MH_TIE_RTOL``), its
   ``mesh_conf`` naming 2 processes and gloo. (d) one Two-Tower epoch on
   ``MH_TT_MESH``: 0 fused-CE launches, every logged loss within
   ``MH_TT_LOSS_RTOL`` of the single-device unfused run's; the towers'
   difference printed, and again for both runs with float32 logit
   products, which must stay in the band of ``MH_TT_TOWER_*``.
   ``[multihost]`` lines.
5. Two-Tower — the same for the towers: the counts checked against the
   step plan; the stored loss must fall below 0.8x its first value and
   recall@10 on held-out pairs exceed 5x random (the user's top-10 over
   every item; a held-out pair may repeat a training pair, so the share
   of such pairs and the recall of the others are printed beside it);
   64 queries; one steady training step runs under torch.profiler.
6. quickstart — in a child process (``phase_quickstart_group``, with the grid,
   the A/B fleet and the bandit loop of phase 14) started once phase 8's
   cold train is in, beside phase 7's and phase 12's children and joined before the fleets
   of phase 13, so it runs beside the workflow's phases; in a temporary ``PIO_FS_BASEDIR``: ``console.main(["app",
   "new", ...])``; ``console.main(["import", ...])`` of the events' NDJSON
   file, timed; the counts set to 0, ``console.main(["train", ...])`` on
   the default device, the counts read and checked against the plan; the
   stored blob loaded through ``loads_model`` and its train RMSE held
   below the mean rating's; ``deploy --port 0`` started as a subprocess,
   64 queries held against float64 numpy, ``GET /`` checked for the device
   and the instance, and SIGTERM must stop it; the counts set to 0,
   ``console.main(["eval", ...])``, the counts checked against both folds'
   plans (from the port's ``read_eval``), the score above the precision of
   a random ranking, the ``EvaluationInstance`` EVALCOMPLETED; one
   ``[quickstart]`` line.
7. Two-Tower quickstart — in a child process (``phase_tt_group``, with
   the Two-Tower tiers of phases 9, 10, 11, 11b and 15), started and
   joined with phase 6's: the same verbs for the Two-Tower engine in its
   own temporary ``PIO_FS_BASEDIR``, the fused-CE launches of ``train`` and
   of ``eval`` checked against their step plans, the stored loss and
   recall@10 held to phase 5's bars, the deploy's top-10s to float64 numpy
   without the seen items; the eval's recall held to RecallAtK computed in
   float64 numpy from towers trained here on each of the port's folds
   with the same params, and printed beside the recall of a random and of
   a popularity ranking; one ``[tt-quickstart]`` line. The events live in
   the columnar store. Then (``phase_tt_wide``) one epoch of phase 5's
   pairs and batch at D = 512, past the fused-CE kernels' full-width
   path: the fused-CE launches = the step plan, every logged loss within
   ``TT_WIDE_LOSS_RTOL`` of the same epoch with ``fused_ce="off"``; one
   ``[tt-wide]`` line.
8. workflow — in a temporary ``PIO_FS_BASEDIR`` with the columnar event
   store: ``app new``; ``ml20m_shaped(10_000_000, seed=5)`` written through
   ``PEvents.write_columns`` (timed); ``pio train`` cold, its ``gj_solve``
   launches held to the plan of a full read (``incremental=False``), the
   train RMSE below the mean rating's; ``pio eventserver --port 0`` as a
   subprocess with the app's access key: 200,000 ``rate`` events with
   client ids through ``POST /events/bulk.json`` (re-rates of stored
   pairs, new pairs, events of 1,000 new users and 50 new items), the
   last 10,000 lines sent again and reported duplicates, the store grown
   by exactly 200,000, 3 ``POST /events.json`` read back through ``GET
   /events/<id>.json``, SIGTERM; ``pio train`` warm, which must log
   "Incremental re-index: merged", leave a new cache manifest equal to
   the store's ``scan_state``, give the TrainingData of a full read and
   launch that read's plan; ``pio deploy`` of the warm instance, 64
   queries (8 of users only the event server brought) against float64
   numpy; ``pio app compact``, after which the tail is empty and a full
   read is unchanged; one ``[workflow]`` line.
9. serving — on the workflow's store (``phase_serving``): a per-request
   ``pio deploy`` and a ``--batching --max-batch-size 32
   --max-batch-delay-ms 2 --pin-model --result-cache --coalesce
   --feedback`` one (warmed on every bucket; feedback into a ``pio
   eventserver`` on the same store) under the same 32 x 25 uniform load,
   then a Zipf(1.2) load: queries/s, p50, p99, the batch histogram,
   ``bucketMisses`` 0, the cache hit ratio, ``bytesPinned`` equal to the
   tables' bytes and the share of batched answers bit-equal to the
   per-request ones; ``pio train --warm-start`` at 3 sweeps (launches =
   plan, the carried rows from its log, the RMSE not above the
   predecessor's, ``warm_start_from`` in the lineage); ``POST /reload``
   under 32 clients (all 200, generation 2, answers after the swap held
   to the new instance); a third instance without its blob, whose
   ``/reload`` must answer 503 ``degraded`` while queries go on; one
   ``predict`` event in the store for each computed answer; ``pio
   undeploy`` (exit 0 within 10 s); ``pio batchpredict`` of 100,000
   queries (1,000 lines checked); ``SRV_RELOADS`` reloads of an in-process
   ``QueryService`` with ``torch.cuda.memory_allocated`` flat within 1 MiB
   and TF32 off on its serving thread. In the Two-Tower quickstart's
   store, a ``--batching --pin-model`` deploy under 8 x 50 queries held
   to float64 numpy without the seen items. Every answer checked is held
   to float64 numpy under the near-tie rule; ``[serving]`` lines.
10. online — on the workflow's store and the serving phase's warm
   instance (``phase_online``): a ``pio eventserver``; ``pio deploy``,
   then ``pio deploy --online --online-interval-s 0.25 --online-batch
   2048``, each under 8 keep-alive clients of top-10 queries to uniform
   stored users for 6 s while 500 events/s (25 every 50 ms) go through
   ``/events/bulk.json``; the online one also gets a freshness probe about
   every second (3 rate events of a new user, its query polled every
   100 ms until non-empty; a probe past 30 s fails the run). Every answer
   must be 200, and the online deploy's ``eventsSeen`` must equal the
   events the event server stored during its run. Printed: queries/s,
   p50/p99 of both and p99 online/baseline, freshness p50/max,
   ``foldMs`` p50/p95, ``eventToVisibleSeconds``, and the deploy start
   with and without ``--online``. Then in process, the events of the
   online run (read by a follower anchored when that deploy started)
   fold in batches of 2048 into a ``QueryService`` of the instance
   through the template's hooks: 32 rows of the last fold within a
   relative 1e-4 of the float64 numpy solve of their anchored normal
   equations over the tables read back from the card, 64 moved users'
   top-10s equal to float64 numpy over the live tables (near-tie rule),
   ``torch.cuda.memory_allocated`` grown by at most the appended rows'
   bytes and 1 MiB, and no kernel launched (the fold solves with
   Cholesky, as the reference does). In the Two-Tower quickstart's store
   (``phase_tt_online``): its instance in a ``QueryService`` with online
   learning behind ``QueryServer``, 256 ``view`` events (8 of new users)
   through the bulk route; the trainer must train every pair, each
   streamed row keep norm 1 within 1e-5, and no user's top-10 hold the
   item the user just viewed; the trainer's loss is printed. ``[online]``
   lines.
11. ann — approximate and int8 retrieval. On the workflow's store and
   warm instance (``phase_ann``): ``pio deploy --ann --ann-nprobe 8``,
   ``--quantize int8`` and ``--ann --quantize int8 --batching
   --pin-model``, each under the serving phase's 32 x 25 uniform top-10
   load (all 200; queries/s, p50/p99, recall@10 against float64 numpy,
   the ``/stats.json`` ``ann`` and ``quant`` sections; int8
   ``bytesPinned`` must be (users + items) x (rank + 4)); in process, a
   full-probe ``QueryService`` (``nprobe >= nlist``) must answer 1,000
   users' ``handle_batch`` equal to the exact one's to the bit, ``ANN_RELOADS``
   ``/reload``s with ``--ann`` must leave ``memory_allocated`` flat within
   1 MiB, the online phase's events fold into an ``--ann --quantize
   int8`` service (the touched int8 rows ``quantize_table_host`` of the
   folded rows, ``itemsFolded`` above 0, every item in one lane, moved
   users' full-probe top-10s equal to float64 numpy over the live int8
   tables), and an incrementally updated index must keep recall@10 within
   0.02 of a rebuild on the same factors. In the Two-Tower quickstart's
   store (``phase_tt_ann``): ``--ann --quantize int8`` under 8 x 50, no
   seen item in an answer. The JAX bench's sweeps (``phase_sweeps``, a
   child process beside phase 15's export, which leaves the card idle,
   joined before its deploys; ``phase_ann_sweep``) over clustered catalogs of 27,000, 65,536 and
   262,144 items at dim 64: exact against IVF (nprobe 8) on 8,192 queries
   in chunks of 512, recall@10 at least 0.95 and the full probe equal to
   exact to the bit; the two-stage int8 top-10 (recall@10 at least 0.99
   against f32 exact), int8-slab against f32-slab IVF (recall@10 within
   0.01), served bytes at least 3.5x smaller. No kernel is on this path:
   every count must read 0. ``[ann]`` lines.
11b. sharded — ``--shard-factors`` on an 8-way mesh over the one card
   (``sharding.local_devices([cuda:0] * 8)``, the reference's 8 host
   devices), and over the real cards where there are two or more. The
   JAX bench's sweep (``phase_sharded_sweep``; after ``[ann]``'s): 65,536
   / 262,144 / 1,048,576 items, users max(1024, items / 2), rank 64,
   4,096 queries in chunks of 512, k 16, seed 17, ``vf[1] = vf[0]``,
   through the template's shard and quantize hooks: a mesh position's
   bytes equal to ``sharded_table_bytes`` and at most replicated / 8 x
   1.1 (int8: / (8 x 3.5)); sharded exact against the replicated
   ``top_k_items_batch`` (ids equal, scores within rtol 1e-6, the bits
   that differ counted), sharded int8 against replicated int8 and the
   sharded full probe against exact (to the bit), sharded IVF at nprobe 8
   against the unsharded probe (ids); queries/s of each; the plain GEMM's
   bits whole against per shard (why the exact path scores through
   ``ops/als.score_rows``); BENCH_r01's table as shape math. What
   ``score_rows`` costs the replicated path (``phase_score_cost``): at
   27,077 and 1,048,576 items the scoring and ``top_k_items_batch`` of a
   512- and a 32-query batch, and one user's ``top_k_items``, against one
   product; a slice's ``score_rows`` bit-equal to the whole table's at 1
   to 512 queries. On the
   workflow's store and warm instance (``phase_sharded_service``, after
   ``[ann]``): first the serving phase's 32 x 25 load on a plain pinned
   service with ``score_rows`` and with one product (legs A B B A); an
   in-process ``QueryService`` with
   ``CacheConfig(shard_factors=True, pin_model=True)`` behind
   ``QueryServer`` under the serving phase's 32 x 25 load, each answer
   float64 numpy's top-10 (near-tie rule) and a plain pinned service's
   ids; ``factorShards`` 8, ``bytesPinned`` the padded tables; the load's
   peak ``max_memory_allocated`` under the shards plus a replicated copy;
   ``SHD_RELOADS`` reloads (each superseded generation's sharded tables collected,
   ``memory_allocated`` flat within 1 MiB); ``--quantize int8`` and
   ``--ann`` with shards under the same clients (25 and 10 queries a
   client, ``SHD_INT8_REQUESTS`` and ``SHD_ANN_REQUESTS``; the unsharded tier's ids;
   recall@10 at the ``[ann]`` sweep's bars, 0.99 and 0.95, or at the
   unsharded tier's where it misses them here); ``--online`` under
   the online phase's traffic, then by ``/online/fold.json`` a fresh user
   into a padding slot, a burst past the padding into one re-layout, a
   known user's update into its row alone (every other row bit-equal);
   ``pio deploy --shard-factors --pin-model`` as a subprocess (one card:
   the reference's one-device warning, ``factorShards`` 0). In the
   Two-Tower quickstart's store (``phase_tt_sharded``): its instance
   sharded under 8 x 50 queries against a plain pinned service and
   float64 numpy without the seen items. No kernel is on this path.
   ``[sharded]`` lines.
12. templates — the four templates beside Recommendation and Two-Tower
   (``phase_templates``, in a child process started before the workflow
   phase and joined before the fleets, so it runs beside the workflow,
   serving, online, ann and sharded phases), through
   the console verbs in one temporary
   columnar store, each engine.json the one ``pio template get`` writes.
   SimilarProduct and ECommerce on one app: ``ml20m_shaped(2_500_000,
   seed=5)``'s pairs as ``view`` events and every 20th again as a ``buy``
   (``write_columns``), a ``$set`` of one of 20 categories per item and a
   ``constraint``/``unavailableItems`` of 100 popular items (``pio
   import``); ``pio train`` of each at rank 32, 10 sweeps (implicit ALS):
   ``gj_solve`` launches must equal the plan of the TrainingData its
   DataSource reads and the implicit loss (float64 on the card after every
   sweep) must fall; ``pio deploy`` and 64 queries under 1 and under 8
   keep-alive clients — baskets of 1 and 3 items, categories, whiteLists
   and blackLists; known users, whose viewed and bought items must be
   absent, and cold users ranked by popularity, whose ties must come in
   ascending order — each held to float64 numpy over the stored factors
   and the rules written out plainly (near-tie rule; none for popularity),
   with no unavailable item answered though some sit in the unfiltered
   top-10; ``handle_query`` in process, the ECommerce query timed apart
   into its two ``LEventStore`` lookups and the rest; SimilarProduct with
   ``--ann``, whose blackLists of the whole exact top-10 must still
   answer 10 items. The solve kernel is timed at the largest ``[B,32,32]``
   batch the sweeps launched. Classification: 100,000 ``$set`` users with
   ``attr0..attr2`` and a 3-class ``plan``; Text-Classification: 20,000
   documents in 20 classes at 4,096 hashed features; each trained as its
   NB and its LR variant, both deployed, 64 queries each: an NB label must
   be float64 numpy's argmax and an LR probability within 1e-3 of a
   float64 run of the same descent (scipy.sparse for the text matrix);
   ``pio eval`` of ``Accuracy`` over the two classifiers must beat the
   majority-class rate, and the text answers' accuracy 1/20; no kernel may
   launch on these paths. ``[templates]`` lines.
13. fleet — ``pio deploy --replicas N`` (``phase_fleet``) of the
   workflow's warm instance at N = 1, 2 and 4 under the [serving] phase's
   32 x 25 uniform load: queries/s, p50 and p99 beside the single-process
   deploy's, the router's ``/stats.json``, the card memory by process;
   each fleet's ring must hold N healthy replicas before the load, and
   ``pio undeploy`` of the router must stop every replica. On the
   2-replica fleet the JAX bench's SIGKILL drill (16 clients, one replica
   killed at 2 s, the clients on until its respawn is back in the ring:
   no failed query; p99 before and after, seconds to rejoin) and a
   rolling ``POST /reload`` under 16 clients (no failed query, no scope
   answered by an older generation after a newer one, one generation
   after it). Every answer through a router is held to float64 numpy.
   On the quickstart's store (``phase_fleet_ab``): ``--replicas 2
   --variants control:1,treatment:1`` under 8 clients x 40 users twice
   (a share within 0.05 of 0.5, a user on one variant, every
   ``X-PIO-Variant`` the port's ``TrafficSplit`` assignment), then ``pio
   eval --grid --promote-to`` of a 2-candidate grid rolls the fleet onto
   the winner under the same clients with no failed query. No kernel is
   on these paths. ``[fleet]`` lines.
14. experiments — the JAX bench's closed loop (16 arms, 400 queries, a
   retrain every 25) with the port's ``Explorer`` on the card: Thompson's
   cumulative regret must be below exploit-only's. ``pio deploy`` against
   ``pio deploy --explore thompson`` of the warm instance under the
   [serving] load (each answer's items, by score, float64 numpy's
   top-10), 64 rewards through ``POST /experiments/reward.json``, then
   ``--explore thompson --online``, whose follower must fold the 48
   reward events written to the store. On the quickstart's store (``phase_grid``):
   ``pio eval --grid`` of 16 candidates (lambda 0.01, 0.05, 0.1, 0.5 x
   seed 0-3, rank 64, 10 sweeps, ``PrecisionAtK(10)``, 2 folds padded to
   1,024 x 2,048) as one batched program a fold (no fallback, no kernel
   launch): seconds, seconds a candidate, peak memory; the grid again in
   float64 on the card from the same draw (each score within 2e-3, the
   winner the same unless the best two are within 2e-3); the sequential
   ``pio eval`` of the first 2 candidates (``gj_solve`` launches = plan);
   one batched call against 16 single-candidate calls at the JAX bench's
   size (48 x 48, rank 8, 3 sweeps; at least 2x) and at full size.
   ``[experiments]`` lines.
15. aot — on the workflow's store (``phase_aot``, after every other
   phase there): ``pio train --aot`` (``gj_solve`` launches = the plan;
   the export's seconds, programs, bytes and fingerprint), ``pio status``
   saying ``present``; a ``pio deploy --aot`` subprocess beside a plain
   ``--pin-model`` one (start seconds of both; ``/stats.json`` ``aot``
   tier 1 with every program loaded) under the bench's serving traffic,
   32 clients x 25 uniform top-10 (the bench's 100), legs A B B A: every answer byte-equal to
   the plain deploy's and float64 numpy's top-10, ``hits`` > 0,
   ``serveTimeCompiles`` 0; in process, the programs against the eager
   pinned path to the bit at 1, 3, 8, 13, 32 and 512 queries and for 64
   single queries, one ``handle_batch`` of 1,000 users byte-equal,
   ``handle_query`` p50 of both (A B B A); a foreign-fingerprint and a
   corrupted copy of the set booting on the fallback tier with the
   warning and the eager bytes; ``AOT_RELOADS`` reloads on tier 1 with
   ``memory_allocated`` within 1 MiB and no extracted package left
   behind; no kernel launch on the serving path. The same on the
   Two-Tower quickstart's store (``phase_tt_aot``: fused-CE launches =
   the plan, 8 x 50 queries, answers without seen items). ``[aot]``
   lines.
16. storage — in a child process beside the workflow's phases
   (``phase_storage``): (a) the JAX bench's partitioned drill's layout,
   a columnar store with ``PARTITIONS=4``, ``REPLICATION=2``,
   ``ACK_QUORUM=2``, ``FSYNC=true``, holding 100,000 ML-20M-shaped
   ratings written as columns; ``pio train`` at rank 64 (``gj_solve``
   launches = the plan, train RMSE below the mean rating's); ``pio
   eventserver --stats`` taking the workflow's 200,000-event bulk delta
   and then all of it again (all duplicates), each partition's leader
   then holding exactly its crc32-routed share, ``/stats.json`` with
   ``partitions.count`` 4 and every quorum met, ``/readyz`` 200 with its
   ``replication`` check, the followers' catch-up seconds; then on a
   ``PARTITIONS=4`` store of the same ratings (a second process that
   opens a replicated store writes its followers too, so the deploy
   does not share one with the event server) ``pio deploy --online``
   with 4 followers under the [online] traffic (8 clients, 500
   events/s): every answer 200, no freshness probe past 30 s,
   ``eventsSeen`` = the events stored, the same events folded in process
   within 1e-4 of float64 numpy with no kernel launch. (b) ``pio storageserver`` over sqlite with all three roles
   ``TYPE=remote``: ``pio import`` of the quickstart's 100,000 events,
   ``pio train`` (launches = the plan; the read's pages), ``pio deploy``
   answering 64 queries with float64 numpy's top-10; then the JAX bench's
   outage drill (retries 1, breaker 3, reset 0.5 s): the server killed
   for 3 s and restarted on its port under 8 query clients, every answer
   200 and float64's, ``/readyz`` 503 and 200 again, a ``/reload`` in
   the outage 503 ``degraded``. (c) ``MODELDATA`` on a ``TYPE=sharedfs``
   path: ``pio train`` in one process, ``pio deploy`` in another, 64
   answers float64 numpy's top-10. ``[storage]`` lines.
17. chaos — in two child processes (``phase_chaos``), joined before the
   fleets: ``chaos-serve --aot`` from the end of phase 3, the others
   with phase 6's children, beside the workflow's phases. The operator's drills
   through the port's console (``CHAOS_DRILLS``), every process each
   starts marked in its environment: ``chaos-ingest`` on sqlite (3
   SIGKILL cycles under retrying writers, the bulk stream, the drain);
   the kill-one-partition and kill-a-replica drill (``--partitions 4
   --replication 2 --ack-quorum 2``); ``chaos-serve --sharded-point``
   and ``chaos-serve --aot --reloads 1 --seconds 3`` (16 clients, a
   replica SIGKILLed, a rolling ``/reload``, the aggregate queries/s at 1
   and 2 replicas; on one card the sharded point's replicas fall back to
   ``--pin-model``, ``factorShards`` 0); ``chaos-fleet`` (a host's fleet
   SIGKILLed behind an HA router pair, the autoscaler, stale-while-down);
   the serving drills train and deploy on the card. A report not ``ok``,
   a failed query in a kill, rolling or host-kill window, a
   cross-generation answer, a serve-time compile in the AOT rotation, a
   partition or replica not caught up, or a marked process alive after
   its drill fails the run; a serving drill's ``ok`` is read term by term
   (its report's ``verdicts``), and the reference's scaling gate (≥ 1.5×
   the queries/s at 2 replicas), which the drill's own clients and router
   cannot show on a multi-core host in either package, is printed, not
   failed (ROADMAP.md queue 3). Then the drills' ``pio train`` in process on
   the kept store of ``chaos-serve --sharded-point``: every solve at K =
   8, ``gj_solve`` launches = the plan. ``[chaos]`` lines.
18. every process the phases left running stopped (the script is the
   reaper of its descendants' orphans from its start), listed on a
   ``[cleanup]`` line; a ``[summary]`` line, the ``{"kernels": [...]}`` line, the card's
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Imports only the port, torch, numpy and the standard library (and
scipy.sparse, for one float64 reference of phase 12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime as dt
import json
import logging
import os
import queue
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from predictionio_tpu_torch.controller.context import local_context, mesh_context
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.event import format_event_time
from predictionio_tpu_torch.data.storage import Storage
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.als import (
    ALSConfig,
    als_sweep,
    build_buckets,
    build_buckets_device,
    half_sweep,
    planned_solves,
    rated_row_mask,
    to_device_buckets,
    train_als,
)
from predictionio_tpu_torch.ops.fused_ce import (
    fused_ce_bwd_cuda,
    fused_ce_bwd_reference,
    fused_ce_fwd_cuda,
    fused_ce_fwd_reference,
    fused_inbatch_ce,
)
from predictionio_tpu_torch.ops.solve import (
    cholesky_solve,
    cholesky_solve_ex,
    gj_solve_cuda,
    gj_solve_plain,
    gj_solve_plan,
    gj_solve_reference,
)
from predictionio_tpu_torch.ops.twotower import (
    AdamState,
    TwoTowerConfig,
    inbatch_loss,
    l2_normalize,
    train_step,
    train_two_tower,
)
from predictionio_tpu_torch.online import OnlineConfig
from predictionio_tpu_torch.online.foldin import MAX_WIDTH
from predictionio_tpu_torch.online.follower import TailFollower, to_deltas
from predictionio_tpu_torch.templates import twotower as tt
from predictionio_tpu_torch.templates.recommendation.engine import ALSAlgorithm, TrainingData
from predictionio_tpu_torch.tools import console
from predictionio_tpu_torch.utils.checkpoint import CheckpointManager
from predictionio_tpu_torch.utils.movielens import ml20m_shaped, synthesize_ml100k
from predictionio_tpu_torch.utils.serialization import loads_model
from predictionio_tpu_torch.utils.synthetic import distinct_pairs, planted_pairs
from predictionio_tpu_torch.workflow import load_engine_variant, run_train
from predictionio_tpu_torch.workflow.serving import QueryServer, QueryService

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_arrays_engine import arrays_variant  # noqa: E402  (tests/, shared with the port's tests)

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
#: (non-tensor-core) FLOP/s and dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

#: exponentials per SM per clock on compute capability 9.0 (the MUFU's
#: base-2 exponential; CUDA C++ Programming Guide, arithmetic instruction
#: throughput table); times SMs and the max SM clock read on the card
MUFU_PER_SM_PER_CLOCK = 16

#: the main path: ML-20M's 20M ratings, the flagship 10 sweeps at rank 64
#: (K % 8 == 0, so the kernel is on the path), 64 queries of top-10
NNZ = 20_000_000
SWEEPS = 10
RANK = 64
QUERIES = 64
TOP_K = 10
#: the rest of ALSConfig on the quickstart's ratings: 3 sweeps, as the
#: JAX package's cross-solver test (tests/test_als.py), and its band
KNOB_SWEEPS = 3
KNOB_RTOL, KNOB_ATOL = 5e-3, 5e-4
#: [als-wide]: the ALS path's ratings at rank 128, where every solve
#: takes the blocked kernel; 3 sweeps, then the same train with
#: solver="cholesky" held to it at the [als-config] band
WIDE_RANK = 128
WIDE_SWEEPS = 3

#: the quickstart path: the ML-100K replica (synthesize_ml100k(42), the
#: data of tests/test_ml100k_parity.py) imported into the event store,
#: trained at the width the ALS path runs (rank 64, 10 sweeps, lambda
#: 0.01, seed 3) and evaluated over QS_EVAL_K folds by precision@10; the
#: deploy must bind within QS_DEPLOY_TIMEOUT_S seconds
QS_APP = "quickstart"
#: the longest a child process of phases (the quickstart's, the
#: templates') may run past the phases beside it
CHILD_TIMEOUT_S = 300
QS_RANK = 64
QS_SWEEPS = 10
QS_EVAL_K = 2
QS_DEPLOY_TIMEOUT_S = 240
QS_FACTORY = "predictionio_tpu.templates.recommendation:engine_factory"

#: the Two-Tower quickstart path on the columnar event store: the
#: planted-preference workload at 100,000 pairs (2,000 users x 1,000
#: items, 5,000 held out), at the Two-Tower path's width. ``pio eval``
#: queries every user for the full ranking in Python, which grows as users
#: x items: 200,000 pairs (4,000 x 2,000, PRs 5-13) cost it ~39 s on the
#: card's host, so the size was cut again to hold the script's length
TTQ_APP = "ttquickstart"
TTQ_NNZ = 100_000
TTQ_FACTORY = "predictionio_tpu.templates.twotower:engine_factory"

#: the workflow path (bench.py::_bench_workflow at the ML-20M shape, cut
#: from 20M ratings to 10M to hold the script's length): the
#: ratings written into a columnar store, ``pio train`` cold, new events
#: through ``pio eventserver``'s bulk route, ``pio train`` warm (the
#: incremental re-index), ``pio deploy`` and ``pio app compact``
WF_APP = "wf"
WF_NNZ = 10_000_000
WF_RANK = 64
WF_SWEEPS = 10
WF_LAMBDA = 0.05
WF_SEED = 7
WF_FACTORY = "predictionio_tpu.templates.recommendation:engine_factory"
#: the bulk delta: re-rates of stored pairs, new pairs of stored users,
#: then events of WF_NEW_USERS users and WF_NEW_ITEMS items the store
#: does not hold (WF_NEW_EVENTS of them); the last WF_RESEND lines are
#: sent twice; WF_DELTA_QUERIES of the deploy's queries go to new users
WF_BULK = {"rerates": 100_000, "new_pairs": 90_000, "new_users": 1_000, "new_items": 50,
           "new_events": 10_000, "resend": 10_000}
WF_SINGLES = 3
WF_DELTA_QUERIES = 8
WF_SERVER_TIMEOUT_S = 120
#: the serving phase, on the workflow's store and warm instance: the JAX
#: bench's serving traffic (bench.py:740, :4155-4172: 32 keep-alive
#: clients x 100 requests, max batch 32, 2 ms delay, Zipf(1.2) users), at
#: 25 requests a client in every phase (cut from 50, and [aot]'s from
#: 100, to hold the script's length); a 3-sweep warm start; 100,000 batchpredict queries,
#: 1,000 of them checked; 2 in-process reloads (as in [ann], [sharded] and
#: [aot]: cut from 3 to hold the script's length beside [als-wide]); the Two-Tower deploy at
#: 8 x 50
SRV_CLIENTS = 32
SRV_REQUESTS = 25
SRV_MAX_BATCH = 32
SRV_MAX_DELAY_MS = 2
SRV_ZIPF_A = 1.2
SRV_WARM_SWEEPS = 3
SRV_RELOAD_LEAD_S = 1.5
SRV_BATCHPREDICT = 100_000
SRV_BATCHPREDICT_SAMPLE = 1_000
SRV_RELOADS = 2
SRV_TT_CLIENTS = 8
SRV_TT_REQUESTS = 50
#: the app the batched deploy's feedback posts its ``predict`` events to,
#: in the workflow's store: a fresh stream. In the workflow app's stream
#: (10M events, client ids over many segments) a single insert with a
#: client id takes the exact id lookup, about 50 ms an event on the chip
#: host (PR 8 run 1: 1,704 events in about 90 s)
SRV_FEEDBACK_APP = "wf-feedback"
#: the online phase (bench.py::_bench_online_freshness's traffic, on the
#: serving phase's warm instance): 8 keep-alive clients of top-10 queries
#: to uniform stored users, 500 events/s through the event server's bulk
#: route (25 events every 50 ms), phases of 6 s, ``--online-interval-s
#: 0.25 --online-batch 2048``; a freshness probe about every second (3
#: rate events of a new user, its query polled every 100 ms, 30 s at
#: most); 32 folded rows held to float64 numpy at a relative 1e-4 and 64
#: moved users' top-10s; the Two-Tower part posts 256 view events
ONL_CLIENTS = 8
ONL_PHASE_S = 6.0
ONL_INGEST_EPS = 500
ONL_INGEST_EVERY_S = 0.05
ONL_INTERVAL_S = 0.25
ONL_BATCH = 2048
ONL_PROBE_EVERY_S = 1.0
ONL_PROBE_EVENTS = 3
ONL_PROBE_POLL_S = 0.1
ONL_PROBE_TIMEOUT_S = 30.0
ONL_CATCH_UP_S = 30.0
ONL_CHECK_ROWS = 32
ONL_CHECK_USERS = 64
ONL_FOLD_RTOL = 1e-4
ONL_TT_EVENTS = 256
ONL_TT_NEW_USERS = 8
ONL_TT_NORM_ATOL = 1e-5

#: approximate and int8 retrieval (``[ann]``): the JAX bench's sweeps
#: (``bench.py::_bench_ann_retrieval`` and ``_bench_quantized_serving``):
#: clustered catalogs at rank 64, nlist auto (~sqrt(items)), nprobe 8,
#: queries in chunks of 512; top-128 for the IVF sweep (recall@10 and
#: @100), top-10 for the int8 one, whose catalogs carry lognormal(0, 0.3)
#: norms. Bars: the reference's (``tests/test_ci_guards.py:1088``,
#: ``:1135``, ``:1140-1170``)
ANN_SIZES = (27_000, 65_536, 262_144)
ANN_DIM = 64
ANN_NPROBE = 8
ANN_QUERIES = 8192
ANN_CHUNK = 512
ANN_K = 128
ANN_RECALL_BAR = 0.95
QZ_QUERIES = 4096
QZ_K = 10
QZ_NORM_SIGMA = 0.3
QZ_RECALL_BAR = 0.99
QZ_IVF_RECALL_DELTA = 0.01
QZ_BYTES_RATIO = 3.5
ANN_INC_RECALL_DELTA = 0.02
ANN_FULL_PROBE_USERS = 1000
ANN_FOLD_CHECK_USERS = 64
ANN_RELOADS = 2

#: sharded factor serving (``[sharded]``): the JAX bench's sweep
#: (``bench.py::_bench_scale_sharded``, ``bench.py:3351-3530``): items
#: 65,536 / 262,144 / 1,048,576, users max(1024, items / 2), rank 64,
#: 4,096 queries in 512-query chunks, k 16, seed 17, ``vf[1] = vf[0]``;
#: an 8-way mesh (the reference's 8 host devices, ``tests/conftest.py:23-25``)
#: over the one card, and once more over the real devices where there are
#: two or more. Bars: a mesh position holds at most replicated / S x 1.1
#: (int8: replicated / (S x 3.5)); sharded exact scores within rtol 1e-6
#: of the replicated ones (``tests/test_sharded.py:87-103``). BENCH_r01's
#: table (``f32[64761856,64]`` against 17 GB) is shape math only
SHD_SIZES = (65_536, 262_144, 1_048_576)
SHD_RANK = 64
SHD_QUERIES = 4096
SHD_CHUNK = 512
SHD_K = 16
SHD_SEED = 17
SHD_SHARDS = 8
SHD_BYTES_SLACK = 1.1
SHD_SCORE_RTOL = 1e-6
SHD_IVF_ITERS = 4
SHD_OOM_ROWS = 64_761_856
SHD_OOM_HBM = 17 * 2**30
SHD_RELOADS = 2
SHD_FOLD_EVENTS = 2
#: queries a client of the ``--shard-factors --quantize int8`` and
#: ``--ann`` loads (the [serving] traffic's 32 clients at a quarter and a
#: tenth of its ``SRV_REQUESTS``, to hold the script's length: on the one
#: card a sharded int8 query holds the device thread ~10 ms and a sharded
#: probe ~20 ms, 8 shards of launches each)
SHD_INT8_REQUESTS = 25
SHD_ANN_REQUESTS = 10
#: what ``ops/als.score_rows`` costs the replicated exact path
#: (``phase_score_cost``): the warm instance's catalog and the sweep's
#: largest; a 512-query chunk (the sweep's) and a 32-query batch (the
#: batcher's largest), each timed ``SCORE_COST_REPS`` calls twice a
#: version (5 at a million items); ``SCORE_COST_CALLS`` single queries
#: a version, interleaved; its contract held at SCORE_COST_CHECK_M queries
SCORE_COST_ITEMS = (27_077, 1_048_576)
SCORE_COST_BATCHES = (512, 32)
SCORE_COST_REPS = 20
SCORE_COST_CALLS = 200
SCORE_COST_CHECK_M = (1, 3, 8, 13, 32, 100, 512)

#: the templates phase (``[templates]``): SimilarProduct and ECommerce on
#: one columnar app at the ML-20M shape (``ml20m_shaped``'s pairs as
#: ``view`` events, every TPL_BUY_EVERY-th again as a ``buy``; one
#: category of TPL_CATEGORIES an item; TPL_UNAVAILABLE unavailable items),
#: trained with the engine.json ``pio template get`` writes (rank 32, 10
#: sweeps, lambda 0.01; alpha 1.0, the default, written out); queries under
#: each of TPL_CLIENTS clients; TPL_ANN_QUERIES ``--ann`` blackLists.
#: Classification: TPL_CLS_USERS users drawn as
#: tests/test_classification_template.py:35-60 draws them. Text:
#: TPL_TEXT_DOCS documents in TPL_TEXT_CLASSES classes (a class's own
#: Zipf vocabulary, a shared one) at 4,096 hashed features
TPL_APP = "tpl"
#: cut from 5M to hold the script's length
TPL_NNZ = 2_500_000
TPL_BUY_EVERY = 20
TPL_CATEGORIES = 20
TPL_UNAVAILABLE = 100
TPL_RANK = 32
TPL_SWEEPS = 10
TPL_CLIENTS = (1, 8)
TPL_ANN_QUERIES = 16
TPL_CLS_APP = "tplcls"
TPL_CLS_USERS = 100_000
TPL_CLS_LABELS = ("basic", "premium", "gold")
TPL_TEXT_APP = "tpltext"
TPL_TEXT_DOCS = 20_000
TPL_TEXT_CLASSES = 20
TPL_TEXT_VOCAB = 300
TPL_TEXT_SHARED = 3000
TPL_TEXT_LEN = 40
TPL_TEXT_OWN_SHARE = 0.3
TPL_TEXT_FEATURES = 4096
#: an LR confidence's largest distance from the float64 descent's
TPL_LR_ATOL = 1e-3

#: an evaluation module as a user writes one: an Evaluation of the
#: engine.json at ``path`` with one metric
EVAL_MODULE = """
from predictionio_tpu_torch.controller import Evaluation
from predictionio_tpu_torch.templates.{template} import {metric}, engine_factory
from predictionio_tpu_torch.workflow import load_engine_variant

ENGINE = engine_factory()
evaluation = Evaluation(engine=ENGINE, metric={metric}({k}))
evaluation.engine_params_list = [load_engine_variant({path!r}).engine_params(ENGINE)]
"""

#: kernel-vs-plain tolerances (the JAX package's on-TPU solve checks)
MAX_REL_ERR = 1e-4
MAX_RESIDUAL = 1e-4

#: [B, K] solve shapes: the ALS chunk cap (chunk_rows), a width-192 user
#: chunk of the ML-20M run, a hot group; above K = 64 the blocked kernel:
#: [4096,128,128] and [64,256,256] (where the first port's kernel was
#: measured), the chunk cap at K = 128, the JAX package's on-chip
#: acceptance shape (tests/test_pallas_tpu.py) and a rank-256 chunk
SOLVE_SHAPES = ((32768, 64), (21840, 64), (2049, 64), (4096, 128), (64, 256), (32768, 128), (8000, 128),
                (32768, 256))

#: widths of the one-warp-per-system kernel timed at the ALS chunk cap;
#: 8 is the [chaos] drills' rank
SOLVE_WIDTHS = (8, 16, 32, 48, 64)

#: the Two-Tower path: the JAX package bench's configuration
#: (bench.py::_bench_twotower at its accelerator scale)
TT_NNZ = 1_000_000
TT_DIM = 64
TT_BATCH = 8192
TT_EPOCHS = 10
TT_INV_TEMP = 10.0  # temperature 0.1
TT_RECALL_PROBE = 2048

#: [B, D] fused-CE shapes: the main path, the JAX package's on-TPU test
#: (tests/test_pallas_tpu.py), twice the main path's batch, and two
#: widths past the kernels' full-width path (NARROW_KERNEL_D = 256): the
#: wide Two-Tower epoch's, and a D that is not a multiple of 16
FUSED_CE_SHAPES = ((8192, 64), (1024, 32), (16384, 64), (8192, 512), (4096, 264))

#: the wide Two-Tower epoch in the Two-Tower group's child: the path's
#: pairs and batch at this width, fused_ce="auto" against "off" from the
#: same draw, each logged loss within the fused loss's on-TPU bar
#: (tests/test_pallas_tpu.py, as phase_fused_kernel holds it)
TT_WIDE_DIM = 512
TT_WIDE_EPOCHS = 1
TT_WIDE_LOSS_RTOL = 5e-3

#: fused CE kernel vs plain: row sums relative (largest and mean), gradient
#: passes against max|plain|. The kernel and cuBLAS sum a logit's dot
#: product in different orders, so a logit on a bf16 rounding boundary may
#: round to the other neighbour and move its exponential by up to 6.5 %
#: (tests/test_torch_gpu.py)
FUSED_SUM_RTOL = 2e-3
FUSED_SUM_MEAN_RTOL = 5e-5
FUSED_GRAD_ATOL = 5e-3

#: [multihost]: the training mesh and the multi-process tier. (a) the ALS
#: path's ML-20M-shaped ratings on an in-process (data, model) mesh of the
#: one card repeated, a checkpointed run resumed on another shape; (b) two
#: ranks through the PIO_COORDINATOR_* triplet sharing the card (gloo),
#: each with its round-robin half of the ratings, and a one-rank NCCL
#: group; (c) `pio export --sharded` and two `pio train --mesh data=1`
#: processes on the quickstart's ML-100K store; (d) a Two-Tower epoch on
#: the (data, model) mesh. (b) and (c) run as child processes beside (a)
#: and (d) and the Two-Tower path.
MH_MESH = (2, 4)
MH_RESUME_MESH = (4, 2)
MH_CKPT_SWEEPS = 4
MH_CKPT_EVERY = 2
MH_RESUME_SWEEPS = 6
MH_RANKS = 2
MH_TOP_USERS = 64
#: train RMSE of the mesh's factors against the single device's, relative
MH_RMSE_RTOL = 1e-5
#: the near-tie rule between two trains of one problem whose sums run in
#: other orders (a mesh or processes against one device): they agree to
#: rounding, which the sweeps amplify, so their top-10s may swap two
#: items whose float64 scores are this close (relative). The JAX
#: package's own multi-process band on the factors (rtol 2e-4,
#: tests/test_multihost_als.py), taken for both factors of a score u.v
MH_TIE_RTOL = 4e-4
#: a resumed run's factors against the uninterrupted run's: the largest
#: difference over the largest value
MH_CKPT_RTOL = 1e-5
#: bytes a rank may receive in the re-partition, over the bytes of the
#: ratings it owns (two int64 ids and a float32 each)
MH_TRAFFIC_SLACK = 1.1
MH_TT_MESH = (2, 4)
MH_TT_EPOCHS = 1
MH_TT_LOSS_RTOL = 1e-3
#: the CPU test's band for the mesh's towers (tests/test_torch_mesh_train.py),
#: held with float32 logit products: the largest difference within RTOL of
#: the largest value, and at most SHARE of the entries outside the band
#: (an entry whose gradient sums near 0 takes another Adam step; with
#: bf16 operands three quarters move: an f32 ulp from another sum order
#: turns into a bf16 ulp at a rounding boundary)
MH_TT_TOWER_RTOL, MH_TT_TOWER_ATOL, MH_TT_TOWER_SHARE = 1e-3, 1e-4, 1e-4
MH_CHILD_TIMEOUT_S = 600
MH_ENGINE_APP = "mhqs"

#: [storage]: the distributed storage drivers, in a child process beside
#: the workflow's phases. (1) the JAX bench's partitioned drill's layout
#: (bench.py:2485-2640: 4 partitions, 2 replicas, ack quorum 2, fsync) at
#: the ML-20M shape, cut to STG_NNZ ratings (0.5 % of ML-20M): every process
#: that opens a replicated store replays the leader's whole stream into
#: its replicas through decoded events (replication.py's catch-up), whose
#: seconds the phase reports, and writes them there, so one process at a
#: time holds it; the workflow's bulk delta through the event server, and
#: the [online] traffic on a PARTITIONS=4 store of the same ratings;
#: (2) the quickstart's events on TYPE=remote through a pio storageserver
#: process, with the JAX bench's storage outage drill (bench.py:1232-1512:
#: retries 1, breaker threshold 3, reset 0.5 s); (3) a TYPE=sharedfs model
#: mount between a pio train and a pio deploy process
STG_APP = "stg"
STG_REMOTE_APP = "stgremote"
STG_SHARED_APP = "stgshared"
STG_NNZ = 100_000
STG_PARTITIONS = 4
STG_REPLICATION = 2
STG_ACK_QUORUM = 2
STG_REMOTE_RETRIES = 1
STG_BREAKER_THRESHOLD = 3
STG_BREAKER_RESET_S = 0.5
STG_OUTAGE_S = 3.0
STG_CLIENTS = 8
STG_RECOVER_TIMEOUT_S = 60.0
STG_CHILD_TIMEOUT_S = 600
STG_CATCH_UP_TIMEOUT_S = 300.0

#: [chaos]: the operator's drills through the port's console, in two
#: child processes, joined before the fleets: serve-aot from the end of
#: the kernels phase, the others beside the workflow's phases (in the order
#: ingest, ingest-partitioned, fleet, serve-sharded); each at its
#: defaults but where it says: chaos-ingest on sqlite (3 kill cycles); the kill-one-partition
#: and kill-a-replica drill on a columnar store of 4 partitions x 2
#: replicas, ack quorum 2; chaos-serve with its sharded point (on one card
#: each replica falls back to --pin-model: factorShards 0); chaos-serve
#: AOT-on, its kill phase cut from 6 s to 3 s; chaos-fleet. The serving
#: drills train and deploy on the phase's device (``--device`` is added)
CHAOS_DRILLS = (
    ("ingest", ["chaos-ingest", "--backend", "sqlite", "--cycles", "3"]),
    ("ingest-partitioned", ["chaos-ingest", "--backend", "columnar", "--partitions", "4", "--replication", "2",
                            "--ack-quorum", "2"]),
    ("serve-sharded", ["chaos-serve", "--sharded-point", "--keep"]),
    ("serve-aot", ["chaos-serve", "--aot", "--reloads", "1", "--seconds", "3"]),
    ("fleet", ["chaos-fleet"]),
)
#: the drills' ALS (resilience/chaos.py: ServeChaosConfig.rank, .iterations)
CHAOS_RANK = 8
CHAOS_ITERATIONS = 2
CHAOS_APP = "chaosapp"
#: one drill's time limit, and the child's
CHAOS_DRILL_TIMEOUT_S = 600
CHAOS_CHILD_TIMEOUT_S = 900
#: the environment variable that marks every process a drill starts
CHAOS_MARK = "PIO_CHAOS_DRILL"
#: niceness added to the background groups that run in child processes
#: beside the workflow's phases (and to every process they start): they
#: finished 150-200 s before their join, while the script's own phases,
#: which they slow, are its length. The [chaos] drills take CHAOS_NICE:
#: their verdicts are timed (a drain's deadline, a degraded /readyz seen
#: while a replica is down). Children that a phase of the script joins
#: at once (the multihost ranks, the sweeps) keep 0
CHILD_NICE = 10
CHAOS_NICE = 5

#: the kernels of both paths: wrapper, plain version, library call
KERNELS = {
    "gj_solve": {
        "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/gj_solve.cu",
        "replaces": "predictionio_tpu/ops/solve.py:95",
        "wrapper": gj_solve_cuda,
    },
    # the same wrapper and count above K = 64 (gj_solve_tile_kernel), on
    # the [als-wide] path
    "gj_solve_wide": {
        "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/gj_solve.cu",
        "replaces": "predictionio_tpu/ops/solve.py:95",
        "wrapper": gj_solve_cuda,
    },
    "fused_ce_fwd": {
        "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/fused_ce.cu",
        "replaces": "predictionio_tpu/ops/fused_ce.py:82",
        "wrapper": fused_ce_fwd_cuda,
    },
    "fused_ce_bwd": {
        "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/fused_ce.cu",
        "replaces": "predictionio_tpu/ops/fused_ce.py:111",
        "wrapper": fused_ce_bwd_cuda,
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


#: ``prctl`` options that make a process the parent of its descendants'
#: orphans, and read that back (Linux 3.4+)
PR_SET_CHILD_SUBREAPER = 36
PR_GET_CHILD_SUBREAPER = 37

#: the environment variable that marks every process this script starts:
#: set once at start and inherited, it finds a descendant that was
#: reparented elsewhere, where the sandbox does not honour the subreaper
RUN_MARK = "PIO_CHIP_SMOKE_RUN"

#: whether the kernel took :func:`adopt_orphans`' subreaper (None where
#: the script was not run as the main program)
SUBREAPER: bool | None = None


def adopt_orphans() -> bool:
    """Make this script the reaper of its descendants' orphans, so a
    process that outlives the process that started it (a compile worker
    of a ``deploy`` killed by signal, say) stays under this script, where
    :func:`stop_descendants` finds it; and mark this run in the
    environment that every process it starts inherits. Returns whether
    the kernel took the subreaper."""
    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        flag = ctypes.c_int(0)
        libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)
        libc.prctl(PR_GET_CHILD_SUBREAPER, ctypes.byref(flag), 0, 0, 0)
        return flag.value == 1
    except (OSError, AttributeError):
        return False


def _marked(pid: int, mark: bytes) -> bool:
    try:
        with open(f"/proc/{pid}/environ", "rb") as fh:
            return mark in fh.read().split(b"\0")
    except OSError:
        return False


def _descendants() -> list[int]:
    """Every live process below this one, from ``/proc``, and every other
    live process that carries this run's :data:`RUN_MARK`."""
    me = os.getpid()
    value = os.environ.get(RUN_MARK)
    mark = f"{RUN_MARK}={value}".encode() if value else None
    children: dict = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry))
    found, todo = [], [me]
    while todo:
        for pid in children.get(todo.pop(), ()):
            found.append(pid)
            todo.append(pid)
    if mark is not None:
        seen = set(found) | {me}
        found += [pid for kids in children.values() for pid in kids
                  if pid not in seen and _marked(pid, mark)]
    return found


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return fh.read().replace(b"\0", b" ").decode(errors="replace").strip()[:160]
    except OSError:
        return "?"


def _reap() -> None:
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                return
        except ChildProcessError:
            return


def stop_descendants() -> list[str]:
    """Stop every process this script started that still runs, and
    return their command lines: Inductor's compile workers and
    multiprocessing's resource tracker (which ignores SIGTERM) their own
    way first, then SIGTERM, then SIGKILL after 5 s; every exited child
    reaped. Nothing that runs after it may start a process, which is why
    the script ends in :func:`exit_clean`."""
    import gc
    from multiprocessing import resource_tracker, util

    lines = [f"{pid} {_cmdline(pid)}" for pid in _descendants()]
    compile_pool = sys.modules.get("torch._inductor.async_compile")
    if compile_pool is not None:
        with contextlib.suppress(Exception):
            compile_pool.shutdown_compile_workers()
    # what exit would run, run now while the tracker lives: a semaphore
    # finalized after the tracker stopped would start a new one
    gc.collect()
    util._run_finalizers(0)
    with contextlib.suppress(Exception):
        resource_tracker._resource_tracker._stop()
    left = _descendants()
    # a killed process that held the card can take a while to go
    for sig, wait_s in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 60.0)):
        for pid in left:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, sig)
        deadline = time.monotonic() + wait_s
        while True:
            _reap()
            left = _descendants()
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if not left:
            break
    _reap()
    if left:
        print(f"chip_smoke: processes still running after SIGKILL: "
              f"{[f'{pid} {_cmdline(pid)}' for pid in left]}", file=sys.stderr, flush=True)
    return lines


@contextlib.contextmanager
def temporary_store(prefix: str, driver: str = "sqlite", extra: dict | None = None):
    """A fresh ``PIO_FS_BASEDIR`` for the block, removed after it, and the
    storage registry pointed at it: metadata in sqlite and models in
    localfs, the events in sqlite or, with ``driver="columnar"``, in a
    columnar store under ``<base>/events``; ``extra`` settings on top. The
    settings go into ``os.environ``, so the ``deploy`` and ``eventserver``
    subprocesses see the same store."""
    base = tempfile.mkdtemp(prefix=prefix)
    env = {"PIO_FS_BASEDIR": base}
    if driver == "columnar":
        env.update({
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "COL",
            "PIO_STORAGE_SOURCES_COL_TYPE": "columnar",
            "PIO_STORAGE_SOURCES_COL_PATH": os.path.join(base, "events"),
        })
    elif driver != "sqlite":
        raise ValueError(f"unknown event store {driver!r}")
    env.update(extra or {})
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    Storage.configure(None)
    try:
        yield Path(base)
    finally:
        Storage.configure(None)
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(base, ignore_errors=True)


def stored_model(instance_id: str):
    """The model of a stored instance, as host arrays."""
    (kind, model), = loads_model(Storage.get_model_data_models().get(instance_id).models)
    if kind != "pickle":
        raise RuntimeError(f"instance {instance_id} stored a {kind} model")
    return model


def reset_launch_counts() -> None:
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def read_launch_counts() -> dict:
    return {name: int(spec["wrapper"].launches) for name, spec in KERNELS.items()}


# --------------------------------------------------------------- 1. device
def _smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script runs on the card only")
    max_sm_mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "smi": _smi("name,power.limit"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "sms": sms,
        "max_sm_mhz": max_sm_mhz,
        "exp_per_s": MUFU_PER_SM_PER_CLOCK * sms * max_sm_mhz * 1e6,
    }
    log(f"[device] {info['kind']} x{info['count']}  torch {info['torch']}  cuda {info['cuda']}  "
        f"{sms} SMs, max SM clock {max_sm_mhz:g} MHz")
    log(info["smi"])  # nvidia-smi: name, power.limit
    return info


# ---------------------------------------------------------------- 2. build
def ptxas_spills(out: str) -> list:
    """(function, spill store bytes, spill load bytes) for every function
    in nvcc's ``-Xptxas -v`` output: "N bytes spill stores" stands on a
    line of its own after "Function properties for <function>"."""
    spills, current = [], "?"
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills.append((current, int(m.group(1)), int(m.group(2))))
    return spills


def phase_build() -> None:
    t0 = time.perf_counter()
    names = sorted(_build.SOURCES)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        outputs = list(pool.map(_build.build, names))
    for name, out in zip(names, outputs):
        for line in out.splitlines():
            if "spill" in line or ("ptxas" in line and ("registers" in line or "smem" in line or "Compiling" in line)):
                log(f"[build] {name}: {line.strip()}")
        if not out:
            log(f"[build] {name}: library was built already; no ptxas lines")
        spilled = [s for s in ptxas_spills(out) if s[1] or s[2]]
        if spilled:
            raise RuntimeError(f"build: ptxas spills registers in {name}: {spilled}")
    log(f"[build] {names} built in {time.perf_counter() - t0:.3f} s into {_build.BUILD_DIR}; no spills")
    # the fused-CE kernels' products run on the tensor cores: count HMMA
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass", str(_build.lib_path("fused_ce"))],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    hmma = sum(1 for line in sass.splitlines() if "HMMA" in line)
    log(f"[build] fused_ce: {hmma} HMMA instructions in the built library (cuobjdump -sass)")
    if hmma == 0:
        raise RuntimeError("build: the fused-CE library has no tensor-core (HMMA) instruction")


# ---------------------------------------------------------------- 3. kernel
def spd_batch(batch: int, k: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """ALS-shaped SPD systems made on the device: QQᵀ/K + 0.1·I."""
    gen = torch.Generator(device=device).manual_seed(seed)
    Q = torch.randn((batch, k, k), generator=gen, device=device)
    A = torch.bmm(Q, Q.transpose(1, 2)) / k
    A.diagonal(dim1=-2, dim2=-1).add_(0.1)
    b = torch.randn((batch, k), generator=gen, device=device)
    return A.contiguous(), b


def rel_err(xa: torch.Tensor, xb: torch.Tensor) -> float:
    num = (xa - xb).abs().amax(dim=-1)
    den = xb.abs().amax(dim=-1).clamp_min(1e-6)
    return float((num / den).max())


def residual(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    r = torch.bmm(A.double(), x.double()[..., None])[..., 0] - b.double()
    return float((r.norm(dim=-1) / b.double().norm(dim=-1).clamp_min(1e-6)).max())


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after one warm-up call. The calls are issued back to back, so where a
    call's host work outlasts its kernels (small shapes) the host's pace
    sets this time: :func:`host_ms` says how much."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time to issue one call (the wrapper's Python, allocation
    and launches, not waiting for the card), over ``reps`` calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued * 1e3 / reps


def solve_bytes(batch: int, k: int) -> float:
    """Bytes a solve must move: A and b read once, x written once."""
    return 4.0 * batch * (k * k + 2 * k)


def solve_bound(batch: int, k: int) -> tuple[float, str]:
    """Least time for the solve on the card: :func:`solve_bytes` over the
    memory rate; Cholesky's K³/3 + 2K² FLOP per system over the f32 peak.
    Returns (ms, which bound)."""
    byte_ms = solve_bytes(batch, k) / PEAK_BYTES_PER_S * 1e3
    flop_ms = batch * (k**3 / 3 + 2 * k**2) / PEAK_F32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")


def solve_row(batch: int, k: int, seed: int, device) -> dict:
    """The solve kernel at ``[batch,k,k]`` on ALS-shaped SPD systems made on
    the card: held against its plain version (``gj_solve_plain``) and the
    library Cholesky
    (relative error and residual), timed beside both, with its launch
    plan, bound and achieved rate. Raises on a disagreement."""
    A, b = spd_batch(batch, k, seed=seed, device=device)
    x = gj_solve_cuda(A, b)
    torch.cuda.synchronize()
    x_plain = gj_solve_plain(A, b)
    x_chol = cholesky_solve(A, b)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"gj_solve: non-finite solution at [{batch},{k},{k}]")
    err_plain = rel_err(x, x_plain)
    err_chol = rel_err(x, x_chol)
    res = residual(A, x, b)
    res_plain = residual(A, x_plain, b)
    max_abs = float((x - x_plain).abs().max())
    reps = 20 if batch * k * k <= (1 << 28) else 10
    ms = time_ms(lambda: gj_solve_cuda(A, b), reps)
    issue_ms = host_ms(lambda: gj_solve_cuda(A, b), reps)
    plain_ms = time_ms(lambda: gj_solve_plain(A, b), 3)
    library_ms = time_ms(lambda: cholesky_solve(A, b), 5)
    bound_ms, bound_by = solve_bound(batch, k)
    row = {
        "shape": [batch, k, k], "plan": gj_solve_plan(batch, k, device),
        "rel_err_plain": err_plain, "rel_err_cholesky": err_chol,
        "residual": res, "residual_plain": res_plain, "max_abs_err": max_abs, "ms": ms, "host_ms": issue_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        # A and b read once, x written once, over the kernel's time
        "gb_per_s": solve_bytes(batch, k) / ms / 1e6, "bound_share": bound_ms / ms,
    }
    log(f"[kernel] gj_solve {json.dumps(row)}")
    if not (err_plain < MAX_REL_ERR and err_chol < MAX_REL_ERR and res < MAX_RESIDUAL):
        raise RuntimeError(
            f"gj_solve disagrees at [{batch},{k},{k}]: rel err vs plain {err_plain:.3g}, "
            f"vs cholesky {err_chol:.3g}, residual {res:.3g} (limit {MAX_REL_ERR:g})"
        )
    del A, b, x, x_plain, x_chol
    torch.cuda.empty_cache()
    return row


def phase_kernel(device) -> list:
    return [solve_row(batch, k, 100 + i, device) for i, (batch, k) in enumerate(SOLVE_SHAPES)]


def phase_solve_widths(device) -> list:
    """The K <= 64 kernel at B = 32768 for each of ``SOLVE_WIDTHS``: time
    per system and FMA instructions a warp issues per ns, beside the plain
    mirror's agreement and time, the bound and the library Cholesky's time. The register kernel's code grows as K², so a time
    per system that rises faster than its instructions from K = 32 to K = 64
    points at instruction fetch."""
    rows = []
    batch = SOLVE_SHAPES[0][0]
    for k in SOLVE_WIDTHS:
        A, b = spd_batch(batch, k, seed=300 + k, device=device)
        err = rel_err(gj_solve_cuda(A, b), gj_solve_reference(A, b))
        ms = time_ms(lambda: gj_solve_cuda(A, b), 20)
        # a lane holds ceil(K/32) rows: each pivot p is that many FMA
        # instructions per column to its right (and b)
        fma_instr = -(-k // 32) * k * (k + 1) // 2 * batch
        bound_ms, bound_by = solve_bound(batch, k)
        row = {"shape": [batch, k, k], "rel_err_plain": err, "ms": ms, "ns_per_system": ms * 1e6 / batch,
               "fma_instr_per_ns": fma_instr / (ms * 1e6), "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(lambda: cholesky_solve(A, b), 10),
               "plain_ms": time_ms(lambda: gj_solve_reference(A, b), 3)}
        log(f"[kernel] gj_solve width {json.dumps(row)}")
        if not err < MAX_REL_ERR:
            raise RuntimeError(f"gj_solve disagrees at [{batch},{k},{k}]: rel err vs plain {err:.3g}")
        rows.append(row)
        del A, b
        torch.cuda.empty_cache()
    return rows


def unit_towers(B: int, D: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-normalised random towers ``[B, D]`` made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ue = l2_normalize(torch.randn((B, D), generator=gen, device=device))
    ie = l2_normalize(torch.randn((B, D), generator=gen, device=device))
    return ue.contiguous(), ie.contiguous()


def fused_ce_bound(B: int, D: int, backward: bool, exp_per_s: float) -> tuple[float, str, str]:
    """Least time for one call of the TPU kernel's work (its CostEstimate:
    2·B²·D FLOP forward, 6·B²·D backward, B² exponentials each), the
    larger of FLOP over the bf16 tensor-core peak, exponentials over the
    MUFU rate, and bytes (towers and sums read once, outputs written once)
    over the memory rate. Returns (ms, "bytes"/"operations", the term)."""
    nbytes = 4 * (2 * B * D + 2 * B + (2 * B * D if backward else 0))
    terms = {
        "bytes": nbytes / PEAK_BYTES_PER_S,
        "flop": (6 if backward else 2) * B * B * D / PEAK_BF16_FLOPS,
        "exp": B * B / exp_per_s,
    }
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def loss_and_grads(ue: torch.Tensor, ie: torch.Tensor, loss_fn) -> tuple[float, tuple]:
    u = ue.clone().requires_grad_(True)
    i = ie.clone().requires_grad_(True)
    loss = loss_fn(u, i)
    return float(loss.detach()), torch.autograd.grad(loss, (u, i))


def phase_fused_kernel(device, exp_per_s: float) -> list:
    """Both fused-CE kernels against their plain versions, and the fused
    loss against the unfused path, at each of ``FUSED_CE_SHAPES``."""
    T = TT_INV_TEMP
    rows = []
    for n, (B, D) in enumerate(FUSED_CE_SHAPES):
        ue, ie = unit_towers(B, D, 200 + n, device)
        rs, cs = fused_ce_fwd_cuda(ue, ie, T)
        due, die = fused_ce_bwd_cuda(ue, ie, rs, cs, T)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (rs, cs, due, die)):
            raise RuntimeError(f"fused_ce: non-finite output at [{B},{D}]")
        sums = list(zip((rs, cs), fused_ce_fwd_reference(ue, ie, T)))
        grads = list(zip((due, die), fused_ce_bwd_reference(ue, ie, rs, cs, T)))
        sum_rel = max(float(((k - p).abs() / p.abs()).max()) for k, p in sums)
        sum_mean_rel = max(float(((k - p).abs() / p.abs()).mean()) for k, p in sums)
        grad_rel = max(float((k - p).abs().max() / p.abs().max()) for k, p in grads)
        fwd_abs = max(float((k - p).abs().max()) for k, p in sums)
        bwd_abs = max(float((k - p).abs().max()) for k, p in grads)
        del sums, grads
        # the loss and its gradients against the unfused path, at the JAX
        # package's on-TPU bar (tests/test_pallas_tpu.py)
        loss, g = loss_and_grads(ue, ie, lambda u, i: fused_inbatch_ce(u, i, T))
        ref, g_ref = loss_and_grads(ue, ie, lambda u, i: inbatch_loss(u, i, T, "bfloat16", "off"))
        loss_ok = abs(loss - ref) < 5e-3 * max(1.0, abs(ref))
        grads_ok = all(
            bool(torch.allclose(a, b, rtol=5e-2, atol=5e-3 * float(b.abs().max()))) for a, b in zip(g, g_ref)
        )
        off_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g, g_ref))
        del g, g_ref
        torch.cuda.empty_cache()

        reps = 20 if B <= 8192 else 10
        fwd_ms = time_ms(lambda: fused_ce_fwd_cuda(ue, ie, T), reps)
        bwd_ms = time_ms(lambda: fused_ce_bwd_cuda(ue, ie, rs, cs, T), reps)
        fwd_host_ms = host_ms(lambda: fused_ce_fwd_cuda(ue, ie, T), reps)
        bwd_host_ms = host_ms(lambda: fused_ce_bwd_cuda(ue, ie, rs, cs, T), reps)
        fwd_plain_ms = time_ms(lambda: fused_ce_fwd_reference(ue, ie, T), 3)
        bwd_plain_ms = time_ms(lambda: fused_ce_bwd_reference(ue, ie, rs, cs, T), 3)
        # the library calls: the unfused loss (two logit products and two
        # cross-entropies), and its backward by autograd
        fwd_lib_ms = time_ms(lambda: inbatch_loss(ue, ie, T, "bfloat16", "off"), 5)
        u, i = ue.clone().requires_grad_(True), ie.clone().requires_grad_(True)
        lib_loss = inbatch_loss(u, i, T, "bfloat16", "off")
        bwd_lib_ms = time_ms(lambda: torch.autograd.grad(lib_loss, (u, i), retain_graph=True), 5)
        del lib_loss, u, i
        torch.cuda.empty_cache()

        row = {"shape": [B, D], "loss": loss, "loss_unfused": ref, "grad_err_vs_unfused": off_err,
               "sum_mean_rel_err": sum_mean_rel}
        # what the kernels execute: the logit product over D padded to 16
        # (2·B²·Dp) once forward and in each of the two backward launches,
        # which add dL·b (2·B²·Dp); B² exponentials a launch
        dp = -(-D // 16) * 16
        for key, ms, issue_ms, plain_ms, lib_ms, err_abs, err_rel, backward, flop, exps in (
            ("fwd", fwd_ms, fwd_host_ms, fwd_plain_ms, fwd_lib_ms, fwd_abs, sum_rel, False, 2 * B * B * dp, B * B),
            ("bwd", bwd_ms, bwd_host_ms, bwd_plain_ms, bwd_lib_ms, bwd_abs, grad_rel, True, 8 * B * B * dp,
             2 * B * B),
        ):
            bound_ms, bound_by, term = fused_ce_bound(B, D, backward, exp_per_s)
            row[key] = {
                "max_abs_err": err_abs, "max_rel_err": err_rel, "ms": ms, "host_ms": issue_ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_term": term, "tc_tflops": flop / ms / 1e9, "exp_per_s": exps / ms * 1e3,
            }
        log(f"[kernel] fused_ce {json.dumps(row)}")
        if not (sum_rel <= FUSED_SUM_RTOL and sum_mean_rel <= FUSED_SUM_MEAN_RTOL and grad_rel <= FUSED_GRAD_ATOL
                and loss_ok and grads_ok):
            raise RuntimeError(
                f"fused_ce disagrees at [{B},{D}]: sums rel err {sum_rel:.3g}, mean {sum_mean_rel:.3g} "
                f"(limits {FUSED_SUM_RTOL:g}, {FUSED_SUM_MEAN_RTOL:g}), "
                f"gradient passes {grad_rel:.3g} of max (limit {FUSED_GRAD_ATOL:g}), loss {loss} vs unfused "
                f"{ref}, gradients within the on-TPU bar: {grads_ok}"
            )
        rows.append(row)
        del ue, ie, rs, cs, due, die
        torch.cuda.empty_cache()
    return rows


def rmse_f64(U64: np.ndarray, V64: np.ndarray, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
             device) -> float:
    """The float64 RMSE of ``U64[rows] . V64[cols]`` against ``vals``, on
    ``device`` in chunks of 4M ratings (the host's float64 gathers of 18M
    rows take tens of seconds a call); the blocks it cached are returned."""
    U = torch.as_tensor(U64, dtype=torch.float64, device=device)
    V = torch.as_tensor(V64, dtype=torch.float64, device=device)
    se = torch.zeros((), dtype=torch.float64, device=device)
    step = 1 << 22
    for lo in range(0, len(rows), step):
        r = torch.as_tensor(rows[lo:lo + step], dtype=torch.int64, device=device)
        c = torch.as_tensor(cols[lo:lo + step], dtype=torch.int64, device=device)
        v = torch.as_tensor(vals[lo:lo + step], dtype=torch.float64, device=device)
        se += (((U[r] * V[c]).sum(dim=-1) - v) ** 2).sum()
    out = float(torch.sqrt(se / len(rows)))
    del U, V, r, c, v, se
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- 4. ALS train
def train_rmse(U: torch.Tensor, V: torch.Tensor, r: torch.Tensor, c: torch.Tensor, v: torch.Tensor) -> float:
    se = torch.zeros((), dtype=torch.float64, device=U.device)
    step = 1 << 22
    for lo in range(0, r.numel(), step):
        pred = (U[r[lo : lo + step]] * V[c[lo : lo + step]]).sum(dim=-1)
        se += ((pred - v[lo : lo + step]).double() ** 2).sum()
    return float(torch.sqrt(se / r.numel()))


@contextlib.contextmanager
def timed_bucketing(device, spans: list):
    """``(seconds, end)`` of every ``build_buckets_device`` call that
    ``ops.als`` makes in the block, each ended by a synchronise (its name
    there is swapped for a timer that calls it)."""
    from predictionio_tpu_torch.ops import als as als_module

    real = als_module.build_buckets_device

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize(device)
        spans.append((time.perf_counter() - t0, time.perf_counter()))
        return out

    als_module.build_buckets_device = timed
    try:
        yield spans
    finally:
        als_module.build_buckets_device = real


class Transfers(TorchDispatchMode):
    """The copies between the host and the card that the block's aten ops
    make: readbacks (device to host, a scalar's included) and the bytes
    that go up."""

    def __init__(self):
        super().__init__()
        self.readbacks, self.up_bytes = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        copy = func is torch.ops.aten.copy_.default
        if copy or func is torch.ops.aten._to_copy.default:
            src, dst = (args[1], args[0]) if copy else (args[0], out)
            if src.device.type == "cuda" and dst.device.type == "cpu":
                self.readbacks += 1
            elif src.device.type == "cpu" and dst.device.type == "cuda":
                self.up_bytes += src.nbytes
        elif func is torch.ops.aten._local_scalar_dense.default and args[0].device.type == "cuda":
            self.readbacks += 1
        return out


def ratings_training_data(rows, cols, vals, num_users: int, num_items: int) -> TrainingData:
    """The Recommendation template's training data for COO ratings whose
    users and items are named by their indices."""
    return TrainingData(
        rows=rows, cols=cols, vals=vals,
        user_index=BiMap.string_index(str(i) for i in range(num_users)),
        item_index=BiMap.string_index(str(i) for i in range(num_items)),
    )


def phase_train(device, nnz: int, sweeps: int, rank: int, label: str = "train", data: tuple | None = None) -> dict:
    """``run_train`` of the ALS arrays engine on the card into the current
    store, with the train RMSE after every sweep (``[label]`` lines), on
    ``data`` (rows, cols, vals, users, items) or ``ml20m_shaped(nnz)``."""
    t0 = time.perf_counter()
    rows, cols, vals, num_users, num_items = ml20m_shaped(nnz, seed=5) if data is None else data
    td = ratings_training_data(rows, cols, vals, num_users, num_items)
    log(f"[{label}] data: {num_users} users x {num_items} items, {rows.size} ratings "
        f"({time.perf_counter() - t0:.3f} s)")
    cfg = ALSConfig(rank=rank)
    expected = sweeps * (
        planned_solves(rows, num_users, cfg) + planned_solves(cols, num_items, cfg)
    )
    r_d = torch.as_tensor(rows, device=device)
    c_d = torch.as_tensor(cols, device=device)
    v_d = torch.as_tensor(vals, device=device)
    marks: list = []  # (step, time at sweep end, rmse)
    clock = {"t": None}
    spans: list = []  # (seconds, end) of each side's build_buckets_device

    def on_sweep(step: int, U: torch.Tensor, V: torch.Tensor) -> None:
        torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        rmse = train_rmse(U, V, r_d, c_d, v_d)
        # sweep 1 from the end of the bucketing
        sweep_s = t_end - (spans[-1][1] if clock["t"] is None else clock["t"])
        marks.append({"sweep": step + 1, "seconds": sweep_s, "rmse": rmse})
        log(f"[{label}] sweep {step + 1}: rmse {rmse:.6f}, {sweep_s:.4f} s")
        clock["t"] = time.perf_counter()

    class SweepLoggedALS(ALSAlgorithm):
        def __init__(self, params, device=None):
            super().__init__(params, device)
            self.on_sweep = on_sweep

    variant = arrays_variant("als", td, SweepLoggedALS,
                             {"rank": rank, "numIterations": sweeps, "lambda": 0.01, "seed": 3})
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    with timed_bucketing(device, spans):
        instance = run_train(variant, local_context(device))
    wall_s = time.perf_counter() - t1
    if len(spans) != 2:
        raise RuntimeError(f"{label}: bucketing='auto' bucketed {len(spans)} sides on the card, not 2")
    peak = torch.cuda.max_memory_allocated(device)
    timings = json.loads(instance.env["phase_timings"])
    model = stored_model(instance.id)
    U, V = model.user_factors, model.item_factors
    if not (np.isfinite(U).all() and np.isfinite(V).all()):
        raise RuntimeError(f"{label}: non-finite factors")
    if U.shape != (num_users, rank) or V.shape != (num_items, rank):
        raise RuntimeError(f"{label}: factor shapes {U.shape}, {V.shape}")
    if not marks[-1]["rmse"] < marks[0]["rmse"]:
        raise RuntimeError(f"{label}: rmse did not fall ({marks[0]['rmse']} -> {marks[-1]['rmse']})")
    steady = [m["seconds"] for m in marks[1:]]
    train_s = timings["train:"]
    bucketing_s = [t for t, _ in spans]
    log(f"[{label}] {sweeps} sweeps at rank {rank} in {train_s:.3f} s: bucketing on the card (build_buckets_device, "
        f"synchronised) users {bucketing_s[0]:.4f} s, items {bucketing_s[1]:.4f} s; sweep 1 after it "
        f"{marks[0]['seconds']:.4f} s; later sweeps {steady}; run_train {wall_s:.3f} s with the blob stored; "
        f"peak device memory {peak / 2**30:.3f} GiB")
    return {
        "variant": variant, "instance": instance, "model": model, "td": td, "expected_launches": expected,
        "sweeps": marks, "train_s": train_s, "run_train_s": wall_s, "peak_bytes": peak, "bucketing_s": bucketing_s,
        "ratings_per_s": rows.size * len(steady) / sum(steady) if steady else None,
    }


# ----------------------------------------------------------------- 4. ALS serve
def reference_top(
    U64: np.ndarray, V64: np.ndarray, uidx: int, k: int, exclude: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The float64 top-k of one user, ties to the lower index, without the
    items in ``exclude``; and all the user's scores."""
    scores = V64 @ U64[uidx]
    order = np.lexsort((np.arange(scores.size), -scores))
    if exclude is not None and exclude.size:
        order = order[~np.isin(order, exclude)]
    return order[:k], scores


def check_ranking(got: list, ref: np.ndarray, scores: np.ndarray, rtol: float = 1e-5) -> bool:
    """Item ids equal the reference's, except where the two differing
    items' float64 scores are within ``rtol`` (relative) — a near-tie."""
    if len(got) != len(ref):
        return False
    for g, r in zip(got, ref):
        if g != r and abs(scores[g] - scores[r]) > rtol * max(abs(scores[r]), 1e-12):
            return False
    return True


def phase_serve(service: QueryService, td, U64: np.ndarray, V64: np.ndarray, n_queries: int, k: int,
                card: str, seed: int = 11) -> dict:
    """``n_queries`` single queries of top-``k`` over HTTP to ``service``
    for distinct random users (ids ``str(i)`` for index ``i``), each held
    against the float64 numpy top-``k`` of ``U64``/``V64`` without the
    user's seen items (``td.seen``, where the template filters them); then
    the same queries through ``handle_query`` alone."""
    seen = getattr(td, "seen", None)
    rng = np.random.default_rng(seed)
    users = rng.choice(len(td.user_index), size=n_queries, replace=False)
    lat = []
    bad = []
    with QueryServer(service) as server:
        for u in users:
            t0 = time.perf_counter()
            status, payload = _http_json(server.url + "/queries.json", {"user": str(u), "num": k})
            lat.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise RuntimeError(f"serve: status {status} for user {u}")
            got = [td.item_index[s["item"]] for s in payload["itemScores"]]
            exclude = None
            if seen is not None:
                exclude = np.array([td.item_index[i] for i in seen.get(str(u), ())], dtype=np.int64)
            ref, scores = reference_top(U64, V64, int(u), k, exclude)
            if not check_ranking(got, ref, scores):
                bad.append((int(u), got, ref.tolist()))
    if bad:
        raise RuntimeError(f"serve: {len(bad)} of {n_queries} top-{k} lists differ from float64 numpy: {bad[:3]}")
    # the same queries through the service alone, on this thread: the part
    # of the HTTP latency that scoring and top-k take
    pred = []
    for u in users:
        t0 = time.perf_counter()
        service.handle_query({"user": str(u), "num": k})
        pred.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = np.percentile(lat, [50, 99])
    pp50, pp99 = np.percentile(pred, [50, 99])
    log(f"[serve] {service.variant.id} instance {service.instance.id} on {service.device}: {n_queries} "
        f"POST /queries.json, all 200, top-{k} equal float64 numpy"
        f"{' without seen items' if seen is not None else ''}; p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
        f"handle_query alone p50 {pp50:.3f} ms, p99 {pp99:.3f} ms on {card}")
    return {"p50_ms": float(p50), "p99_ms": float(p99),
            "predict_p50_ms": float(pp50), "predict_p99_ms": float(pp99)}


def phase_als_serve(trained: dict, device, n_queries: int, k: int, card: str) -> dict:
    """The stored ALS instance, loaded by a ``QueryService`` on the card."""
    service = QueryService(trained["variant"], local_context(device), instance_id=trained["instance"].id)
    U64 = trained["model"].user_factors.astype(np.float64)
    V64 = trained["model"].item_factors.astype(np.float64)
    return phase_serve(service, trained["td"], U64, V64, n_queries, k, card)


def same_buckets(a, b) -> bool:
    """Every array of two sides' buckets equal (``torch.equal``), and their counts."""
    arrays = [(x, y) for ca, cb in zip(a.normal + a.hot, b.normal + b.hot) for x, y in zip(ca, cb)]
    arrays += list(zip(a.hot_rows, b.hot_rows))
    return ((a.nnz, a.padded_nnz, len(a.normal), len(a.hot)) == (b.nnz, b.padded_nnz, len(b.normal), len(b.hot))
            and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in arrays))


def phase_bucketing(td, device, kw: dict, smi: str) -> tuple:
    """Both sides of the ratings bucketed on the host (``build_buckets``,
    then ``to_device_buckets``) and on the card (``build_buckets_device``
    of the same numpy arrays, synchronised; its copies counted in a
    second call): every array, ``nnz``, ``padded_nnz`` and the rated
    masks equal. Returns the host path's device buckets."""
    U, I = len(td.user_index), len(td.item_index)
    out, sides = {"card": smi}, []
    for side, args in (("user", (td.rows, td.cols, td.vals, U, I)), ("item", (td.cols, td.rows, td.vals, I, U))):
        t0 = time.perf_counter()
        host_b = build_buckets(*args, **kw)
        t1 = time.perf_counter()
        host = to_device_buckets(host_b, device)
        torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        got, rated = build_buckets_device(*args, **kw, device=device)
        torch.cuda.synchronize(device)
        t3 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(device) - base
        if not (same_buckets(got, host) and np.array_equal(rated, rated_row_mask(host_b))):
            raise RuntimeError(f"bucketing: the {side} side's device buckets differ from the host's")
        # counted in a call of its own: a dispatch mode's first entry
        # costs seconds of one-time setup
        with Transfers() as moved:
            build_buckets_device(*args, **kw, device=device)
        out[side] = {"host_s": t1 - t0, "upload_s": t2 - t1, "device_s": t3 - t2, "up_bytes": moved.up_bytes,
                     "readbacks": moved.readbacks, "peak_bytes_over_start": peak,
                     "nnz": got.nnz, "padded_nnz": got.padded_nnz, "buckets": [len(got.normal), len(got.hot)]}
        sides.append(host)
        del got, host_b
    log(f"[bucketing] both sides at the ML-20M shape, device buckets torch.equal to the host's: {json.dumps(out)}")
    return tuple(sides)


def phase_half_sweep(trained: dict, device, rank: int, smi: str) -> tuple:
    """One user half-sweep from the trained factors: kernel solve vs the
    plain solve on the card (rtol 5e-3, atol 5e-4). Returns the factor
    tables (with the zero sentinel row) and both sides' device buckets."""
    td = trained["td"]
    cfg = ALSConfig(rank=rank)
    kw = dict(widths=cfg.bucket_widths, chunk_entries=cfg.chunk_entries,
              hot_group_slots=cfg.hot_group_slots)
    ub, ib = phase_bucketing(td, device, kw, smi)
    model = trained["model"]
    zero = torch.zeros((1, rank), device=device)
    uf = torch.cat([torch.as_tensor(model.user_factors, device=device), zero])
    vf = torch.cat([torch.as_tensor(model.item_factors, device=device), zero])
    with torch.no_grad():
        got = half_sweep(uf.clone(), vf, ub, 0.01, False, 1.0, "auto")
        ref = half_sweep(uf.clone(), vf, ub, 0.01, False, 1.0, "plain")
    torch.cuda.synchronize(device)
    torch.testing.assert_close(got, ref, rtol=5e-3, atol=5e-4)
    log(f"[train] user half-sweep, kernel vs plain solve: max abs diff {float((got - ref).abs().max()):.3g}")
    return uf, vf, ub, ib


def phase_knobs(device, smi: str) -> dict:
    """The rest of ``ALSConfig`` on the quickstart's ratings at rank
    ``RANK`` and ``KNOB_SWEEPS`` sweeps, through ``train_als`` on the card:
    "auto" launches its plan; ``solver="cholesky"`` no ``gj_solve`` and
    factors within ``KNOB_RTOL``/``KNOB_ATOL`` of "auto";
    ``rank_pad_multiple=8`` at rank 10 trains at K = 16 with the plan's
    launches; ``precision="high"`` a train RMSE within 1e-3 (relative)
    of "highest"; the matmul precision and TF32 flag as before each run."""
    u, i, r, _ = synthesize_ml100k(42)
    U, I = int(u.max()) + 1, int(i.max()) + 1
    base = ALSConfig(rank=RANK, iterations=KNOB_SWEEPS, reg=0.1, seed=1)
    plan = KNOB_SWEEPS * (planned_solves(u, U, base) + planned_solves(i, I, base))
    r_d, c_d, v_d = (torch.as_tensor(a, device=device) for a in (u, i, r))
    out, runs = {"card": smi, "plan": plan}, {}
    for label, cfg in (("auto", base), ("cholesky", dataclasses.replace(base, solver="cholesky")),
                       ("rank_pad_multiple", dataclasses.replace(base, rank=10, rank_pad_multiple=8)),
                       ("high", dataclasses.replace(base, precision="high"))):
        before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
        reset_launch_counts()
        t0 = time.perf_counter()
        runs[label] = f = train_als(u, i, r, U, I, cfg, device=device)
        torch.cuda.synchronize(device)
        out[label] = {"train_s": time.perf_counter() - t0, "gj_solve_launches": read_launch_counts()["gj_solve"],
                      "K": int(f.user.shape[1]), "rmse": train_rmse(f.user, f.item, r_d, c_d, v_d)}
        after = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
        if after != before:
            raise RuntimeError(f"als-config {label}: matmul settings {before} became {after}")
    diff = max(float((runs["cholesky"].user - runs["auto"].user).abs().max()),
               float((runs["cholesky"].item - runs["auto"].item).abs().max()))
    out["cholesky"]["max_abs_diff_to_auto"] = diff
    out["high"]["rmse_rel_diff"] = abs(out["high"]["rmse"] - out["auto"]["rmse"]) / out["auto"]["rmse"]
    log(f"[als-config] {json.dumps(out)}")
    if not out["auto"]["gj_solve_launches"] == plan == out["high"]["gj_solve_launches"]:
        raise RuntimeError(f"als-config: launches {out}, plan {plan}")
    if out["cholesky"]["gj_solve_launches"] or not all(
        torch.allclose(runs["cholesky"][k], runs["auto"][k], rtol=KNOB_RTOL, atol=KNOB_ATOL) for k in (0, 1)
    ):
        raise RuntimeError("als-config: solver='cholesky' launched the kernel or left the band of 'auto'")
    if (out["rank_pad_multiple"]["K"], out["rank_pad_multiple"]["gj_solve_launches"]) != (16, plan):
        raise RuntimeError(f"als-config: rank_pad_multiple=8 at rank 10 gave {out['rank_pad_multiple']}")
    if not out["high"]["rmse_rel_diff"] <= 1e-3:
        raise RuntimeError(f"als-config: precision='high' RMSE {out['high']['rmse_rel_diff']} from 'highest'")
    return out


def profile_once(fn, label: str) -> dict:
    """Device time by kernel and the device's busy share of the wall time
    of one call of ``fn`` (which ends in a synchronise) under
    torch.profiler, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us > 0:
            kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in kernels)
    if not kernels:
        log(f"[profile] {label} wall {wall_ms:.3f} ms; device time not measured (the profiler saw no CUDA kernels)")
        return {"wall_ms": wall_ms, "busy_share": None}
    out = {
        "what": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
        "device_ops": sum(n for _, n, _ in kernels),
        "top": [{"kernel": name[:90], "ms": ms, "calls": n, "share": ms / busy_ms}
                for ms, n, name in kernels[:8]],
    }
    log(f"[profile] {json.dumps(out)}")
    return out


def phase_profile(uf, vf, ub, ib, device) -> dict:
    """Where one steady ALS sweep spends the card's time."""

    def sweep() -> None:
        als_sweep(uf.clone(), vf.clone(), ub, ib, 0.01, False, 1.0)
        torch.cuda.synchronize(device)

    return profile_once(sweep, "one steady ALS sweep")


def phase_als_wide(device, trained: dict, info: dict) -> tuple:
    """The Recommendation path at rank ``WIDE_RANK`` on the ALS phase's
    ratings, where every solve is at K = 128 and takes the blocked kernel:
    ``run_train`` of ``WIDE_SWEEPS`` sweeps with its solves recorded and
    the counts read against the plan, 64 queries held to float64 numpy,
    one steady sweep under torch.profiler, the solve kernel at the chunk
    cap and the hot groups' batch the train gave it, and the same train
    with ``solver="cholesky"`` (0 launches; its factors within
    ``KNOB_RTOL``/``KNOB_ATOL`` of the kernel's). Returns the phase's
    numbers and the launch counts of its train and serve."""
    td = trained["td"]
    data = (td.rows, td.cols, td.vals, len(td.user_index), len(td.item_index))
    shapes: list = []
    with temporary_store("pio-als-wide-"):
        reset_launch_counts()
        with recorded_solves(shapes):
            wide = phase_train(device, NNZ, WIDE_SWEEPS, WIDE_RANK, label="als-wide", data=data)
        served = phase_als_serve(wide, device, QUERIES, TOP_K, info["kind"])
        launches = read_launch_counts()
    check_launches("als-wide", launches, {"gj_solve": wide["expected_launches"]})
    batches: dict = {}
    for batch, k in shapes:
        batches.setdefault(k, {}).setdefault(batch, 0)
        batches[k][batch] += 1
    log(f"[als-wide] solves the train gave spd_solve, K -> {{B: calls}}: {json.dumps(batches)}")
    if set(batches) != {WIDE_RANK} or len(shapes) != launches["gj_solve"]:
        raise RuntimeError(f"als-wide: solves at K {sorted(batches)}, {len(shapes)} calls, "
                           f"{launches['gj_solve']} launches: not every launch at K = {WIDE_RANK}")

    # one steady sweep under the profiler, from the trained factors
    cfg = ALSConfig(rank=WIDE_RANK)
    kw = dict(widths=cfg.bucket_widths, chunk_entries=cfg.chunk_entries, hot_group_slots=cfg.hot_group_slots)
    ub, _ = build_buckets_device(*data, **kw, device=device)
    ib, _ = build_buckets_device(data[1], data[0], data[2], data[4], data[3], **kw, device=device)
    zero = torch.zeros((1, WIDE_RANK), device=device)
    uf = torch.cat([torch.as_tensor(wide["model"].user_factors, device=device), zero])
    vf = torch.cat([torch.as_tensor(wide["model"].item_factors, device=device), zero])
    profile = phase_profile(uf, vf, ub, ib, device)
    del ub, ib, uf, vf

    # the kernel at the batches of this path not in SOLVE_SHAPES: the
    # largest (the chunk cap) and the smallest (a hot group)
    rows = [solve_row(batch, WIDE_RANK, 200 + i, device)
            for i, batch in enumerate(sorted({min(batches[WIDE_RANK]), max(batches[WIDE_RANK])}))
            if (batch, WIDE_RANK) not in SOLVE_SHAPES]

    # the same train with the library Cholesky, from the same seeded start
    marks: list = []
    clock = [time.perf_counter()]

    def on_sweep(step: int, U: torch.Tensor, V: torch.Tensor) -> None:
        torch.cuda.synchronize(device)
        marks.append(time.perf_counter() - clock[0])
        clock[0] = time.perf_counter()

    reset_launch_counts()
    chol_cfg = ALSConfig(rank=WIDE_RANK, iterations=WIDE_SWEEPS, reg=0.01, seed=3, solver="cholesky")
    clock[0] = time.perf_counter()
    chol = train_als(*data, chol_cfg, device=device, on_sweep=on_sweep)
    torch.cuda.synchronize(device)
    chol_launches = read_launch_counts()["gj_solve"]
    U = torch.as_tensor(wide["model"].user_factors, device=device)
    V = torch.as_tensor(wide["model"].item_factors, device=device)
    diff = max(float((chol.user - U).abs().max()), float((chol.item - V).abs().max()))
    in_band = bool(torch.allclose(chol.user, U, rtol=KNOB_RTOL, atol=KNOB_ATOL)
                   and torch.allclose(chol.item, V, rtol=KNOB_RTOL, atol=KNOB_ATOL))
    steady = [m["seconds"] for m in wide["sweeps"][1:]]
    out = {
        "card": info["smi"], "rank": WIDE_RANK, "sweeps": WIDE_SWEEPS, "launches": launches["gj_solve"],
        "plan": wide["expected_launches"], "solve_batches": batches[WIDE_RANK],
        "rmse_first": wide["sweeps"][0]["rmse"], "rmse_last": wide["sweeps"][-1]["rmse"],
        "train_s": wide["train_s"], "bucketing_s": wide["bucketing_s"], "sweep_s": [m["seconds"] for m in wide["sweeps"]],
        "steady_sweep_s": min(steady), "cholesky_sweep_s": marks, "cholesky_steady_sweep_s": min(marks[1:]),
        "cholesky_launches": chol_launches, "cholesky_max_abs_diff": diff, "cholesky_in_band": in_band,
        "ratings_per_s": wide["ratings_per_s"], "peak_gib": wide["peak_bytes"] / 2**30,
        "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"], "sweep_busy_share": profile["busy_share"],
        "kernel_rows": [{k: r[k] for k in ("shape", "ms", "library_ms", "bound_ms")} for r in rows],
    }
    log(f"[als-wide] {json.dumps(out)}")
    if chol_launches or not in_band:
        raise RuntimeError(f"als-wide: solver='cholesky' launched the kernel {chol_launches} times or left the "
                           f"band of the kernel's train (largest difference {diff})")
    return out, launches


# ------------------------------------------------------------ 5. Two-Tower
def tt_training_data(nnz: int):
    """The bench's planted pairs, deduplicated as the Two-Tower DataSource
    does, as a ``TrainingData`` (ids ``str(i)`` for every index) with each
    user's seen items; and the held-out pairs."""
    r_tr, c_tr, r_te, c_te, num_users, num_items = planted_pairs(nnz, seed=11)
    rows, cols = distinct_pairs(r_tr, c_tr, num_items)
    starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    item_ids = np.array([str(i) for i in range(num_items)], dtype=object)
    seen = {
        str(u): set(group)
        for u, group in zip(rows[starts].tolist(), np.split(item_ids[cols], starts[1:]))
    }
    td = tt.TrainingData(
        rows=rows, cols=cols,
        user_index=BiMap.string_index(str(u) for u in range(num_users)),
        item_index=BiMap.string_index(item_ids.tolist()),
        seen=seen,
    )
    return td, r_te, c_te, num_items


def probe_recall(model, users: list, items: list, device) -> dict:
    """recall@10 of held-out (user, item) id pairs by a stored Two-Tower
    model: the share whose item is in the user's top-10 over every item
    (bench.py::_bench_twotower); a pair whose user or item the model does
    not know is a miss. ``planted_pairs`` draws with repeats, so a held-out
    pair may be one the towers trained on: the share of those and the
    recall of the others come with it."""
    pu = np.array([model.user_index.get(u, -1) for u in users])
    pi = np.array([model.item_index.get(i, -1) for i in items])
    known = (pu >= 0) & (pi >= 0)
    hits = np.zeros(len(users), dtype=bool)
    uv = torch.as_tensor(model.user_vecs, device=device)
    iv = torch.as_tensor(model.item_vecs, device=device)
    top = torch.topk(uv[torch.as_tensor(pu[known], device=device)] @ iv.T, 10, dim=1).indices
    hits[known] = (top == torch.as_tensor(pi[known], device=device)[:, None]).any(dim=1).cpu().numpy()
    repeat = np.array([i in model.seen.get(u, ()) for u, i in zip(users, items)])
    return {"recall_at_10": float(hits.mean()), "heldout_repeat_share": float(repeat.mean()),
            "recall_at_10_new_pairs": float(hits[~repeat].mean())}


def phase_tt_train(device, nnz: int, dim: int, batch: int, epochs: int) -> dict:
    """``run_train`` of the Two-Tower arrays engine on the card into the
    current store; the stored loss and recall@10 held to their bars."""
    t0 = time.perf_counter()
    td, r_te, c_te, num_items = tt_training_data(nnz)
    n = td.rows.size
    log(f"[tt-train] data: {len(td.user_index)} users x {num_items} items, {nnz} pairs, {n} distinct "
        f"({time.perf_counter() - t0:.3f} s)")
    params = {"embeddingDim": dim, "batchSize": batch, "epochs": epochs, "learningRate": 0.05,
              "temperature": 1.0 / TT_INV_TEMP, "seed": 2}
    loop: dict = {}  # the training loop's own seconds (TwoTowerModel.timings)

    class LoopTimedTwoTower(tt.TwoTowerAlgorithm):
        def train(self, ctx, pd):
            model = super().train(ctx, pd)
            loop.update(self.train_timings)
            return model

    variant = arrays_variant("tt", td, LoopTimedTwoTower, params)
    steps = epochs * -(-n // batch)
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    instance = run_train(variant, local_context(device))
    wall_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(device)
    model = stored_model(instance.id)
    if not (np.isfinite(model.user_vecs).all() and np.isfinite(model.item_vecs).all()):
        raise RuntimeError("tt-train: non-finite towers")
    if model.user_vecs.shape != (len(td.user_index), dim) or model.item_vecs.shape != (num_items, dim):
        raise RuntimeError(f"tt-train: tower shapes {model.user_vecs.shape}, {model.item_vecs.shape}")
    hist = model.loss_history
    loss_first, loss_last = hist[0][1], hist[-1][1]
    if not loss_last < 0.8 * loss_first:
        raise RuntimeError(f"tt-train: loss did not fall below 0.8x its first value ({loss_first} -> {loss_last})")
    probe = min(TT_RECALL_PROBE, r_te.size)
    recall = probe_recall(model, [str(u) for u in r_te[:probe].tolist()], [str(i) for i in c_te[:probe].tolist()],
                          device)
    random_recall = 10.0 / num_items
    if not recall["recall_at_10"] > 5 * random_recall:
        raise RuntimeError(f"tt-train: recall@10 {recall['recall_at_10']} is not above 5x random ({random_recall})")
    timings = json.loads(instance.env["phase_timings"])
    # the rates read the epoch loop's seconds, as in earlier runs; the
    # engine's train: span adds the upload, the TrainingData handling and
    # the readback
    train_s = loop["train_seconds"]
    out = {
        "pairs": n, "steps": steps, "train_s": train_s, "train_span_s": timings["train:"],
        "ingest_s": loop["ingest_seconds"], "finalize_s": loop["finalize_seconds"], "run_train_s": wall_s,
        "interactions_per_s": n * epochs / train_s, "steps_per_s": steps / train_s,
        "loss_first": loss_first, "loss_last": loss_last, **recall,
        "random_recall_at_10": random_recall, "peak_gib": peak / 2**30, "timings": timings,
    }
    log(f"[tt-train] {json.dumps(out)}")
    return dict(out, variant=variant, instance=instance, model=model, td=td, params=params,
                expected_launches={"fused_ce_fwd": steps, "fused_ce_bwd": 2 * steps})


def phase_tt_serve(trained: dict, device, n_queries: int, k: int, card: str) -> dict:
    """The stored Two-Tower instance, loaded by a ``QueryService`` on the card."""
    service = QueryService(trained["variant"], local_context(device), instance_id=trained["instance"].id)
    U64 = trained["model"].user_vecs.astype(np.float64)
    V64 = trained["model"].item_vecs.astype(np.float64)
    return phase_serve(service, trained["td"], U64, V64, n_queries, k, card, seed=12)


def phase_tt_profile(trained: dict, device) -> dict:
    """Where one steady Two-Tower training step spends the card's time: a
    step on a random batch of the pairs, from the trained towers."""
    p, model, td = trained["params"], trained["model"], trained["td"]
    cfg = TwoTowerConfig(dim=p["embeddingDim"], batch_size=p["batchSize"], learning_rate=p["learningRate"],
                         temperature=p["temperature"], seed=p["seed"])
    tables = [torch.as_tensor(model.user_vecs, device=device).clone().requires_grad_(True),
              torch.as_tensor(model.item_vecs, device=device).clone().requires_grad_(True)]
    state = AdamState(tables)
    gen = torch.Generator(device=device).manual_seed(3)
    pick = torch.randint(0, td.rows.size, (p["batchSize"],), generator=gen, device=device)
    u_ids = torch.as_tensor(td.rows, device=device)[pick]
    i_ids = torch.as_tensor(td.cols, device=device)[pick]

    def step() -> None:
        train_step(tables, state, u_ids, i_ids, cfg)
        torch.cuda.synchronize(device)

    return profile_once(step, "one steady Two-Tower training step")


# ---------------------------------------------------------- 6. quickstart
def _http_json(url: str, body: dict | None = None) -> tuple[int, dict]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}, method="GET" if body is None else "POST"
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _await_line(lines: "queue.Queue", prefix: str, timeout_s: float) -> str:
    deadline = time.perf_counter() + timeout_s
    while True:
        left = deadline - time.perf_counter()
        if left <= 0:
            raise RuntimeError(f"no '{prefix}' line within {timeout_s} s")
        try:
            line = lines.get(timeout=left)
        except queue.Empty:
            continue
        if line is None:
            raise RuntimeError(f"the server exited before printing '{prefix}'")
        if line.startswith(prefix):
            return line


def write_ndjson(path: Path, lines) -> float:
    """Write one JSON object a line; returns the seconds it took."""
    t0 = time.perf_counter()
    with open(path, "w") as f:
        f.writelines(json.dumps(line) + "\n" for line in lines)
    return time.perf_counter() - t0


def console_ok(label: str, argv: list) -> float:
    """``console.main(argv)``, which must exit 0; returns its seconds."""
    t0 = time.perf_counter()
    if console.main(argv) != 0:
        raise RuntimeError(f"{label}: pio {argv[0]} failed")
    return time.perf_counter() - t0


def start_console_server(label: str, base: Path, argv: list, err_path: Path, timeout_s: float) -> tuple:
    """``python -m predictionio_tpu_torch.tools.console <argv> --ip
    127.0.0.1 --port 0`` as a subprocess (``PYTHONPATH`` the repo root,
    the store of ``os.environ`` at ``base``, stderr to ``err_path``);
    returns the process and the port it printed as ``Bound port N``."""
    return bound_console_server(*spawn_console_server(label, base, argv, err_path), timeout_s)


def spawn_console_server(label: str, base: Path, argv: list, err_path: Path) -> tuple:
    """:func:`start_console_server` up to the spawn, so that several servers
    start at once; :func:`bound_console_server` waits for one's port."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PIO_FS_BASEDIR=str(base),
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.console", *argv, "--ip", "127.0.0.1", "--port", "0"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
        )
    lines: queue.Queue = queue.Queue()

    def pump() -> None:
        for line in proc.stdout:
            lines.put(line.strip())
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return label, argv, err_path, proc, lines


def bound_console_server(label: str, argv: list, err_path: Path, proc, lines: "queue.Queue",
                         timeout_s: float) -> tuple:
    """The process of :func:`spawn_console_server` and the port it bound."""
    try:
        bound = _await_line(lines, "Bound port", timeout_s)
    except RuntimeError as e:
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError(f"{label}: {e}; {argv[0]} stderr: {err_path.read_text()[-2000:]}") from None
    return proc, int(bound.split()[-1])


def deploy_and_query(label: str, base: Path, engine_json: Path, dev_args: list, instance_id: str,
                     index: tuple, U64: np.ndarray, V64: np.ndarray, seen: dict | None, n_queries: int,
                     k: int, seed: int, device, picks: np.ndarray | None = None) -> dict:
    """``pio deploy --port 0`` as a subprocess (``PYTHONPATH`` the repo
    root); ``n_queries`` top-``k`` queries for distinct random users (or
    the user rows ``picks``) held against the float64 numpy top-``k`` of
    ``U64``/``V64`` (rows by ``index``, the stored model's user and item
    ``BiMap``s) without each user's ``seen`` items; ``GET /`` must report
    the device and the instance; SIGTERM must stop it with exit 0."""
    user_index, item_index = index
    err_path = base / "deploy.stderr"
    proc = None
    try:
        t0 = time.perf_counter()
        proc, port = start_console_server(
            label, base, ["deploy", "--engine-json", str(engine_json), *dev_args], err_path, QS_DEPLOY_TIMEOUT_S)
        deploy_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        if picks is None:
            picks = np.random.default_rng(seed).choice(len(user_index), size=n_queries, replace=False)
        lat, bad = [], []
        for uidx in picks.tolist():
            user = user_index.inverse(uidx)
            t1 = time.perf_counter()
            status, payload = _http_json(url + "/queries.json", {"user": user, "num": k})
            lat.append((time.perf_counter() - t1) * 1e3)
            if status != 200:
                raise RuntimeError(f"{label}: status {status} for user {user}")
            got = [item_index[s["item"]] for s in payload["itemScores"]]
            exclude = None
            if seen is not None:
                exclude = np.array([item_index[i] for i in seen.get(user, ())], dtype=np.int64)
            ref, scores = reference_top(U64, V64, uidx, k, exclude)
            if not check_ranking(got, ref, scores):
                bad.append((user, got, ref.tolist()))
        if bad:
            raise RuntimeError(
                f"{label}: {len(bad)} of {n_queries} top-{k} lists differ from float64 numpy: {bad[:3]}")
        _, status_body = _http_json(url + "/")
        want_device = "cuda:0" if device.type == "cuda" else "cpu"
        if status_body.get("device") != want_device or status_body.get("engineInstanceId") != instance_id:
            raise RuntimeError(f"{label}: GET / answered {status_body}, expected {want_device} and {instance_id}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        proc = None
        if rc != 0:
            raise RuntimeError(f"{label}: the deploy exited {rc} on SIGTERM; stderr: {err_path.read_text()[-2000:]}")
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(timeout=30)
    p50, p99 = np.percentile(lat, [50, 99])
    return {"deploy_start_s": deploy_s, "p50_ms": float(p50), "p99_ms": float(p99),
            "status_device": status_body["device"]}


def run_eval(label: str, base: Path, module: str, template: str, metric: str, k: int, engine_json: Path,
             dev_args: list, source: str | None = None) -> tuple[float, dict, float]:
    """``pio eval`` of an evaluation module written into ``base`` as a user
    writes one (:data:`EVAL_MODULE`, or ``source``); the launch counts set
    to 0 before it and read after it. Returns the best score, the counts
    and the seconds, once the ``EvaluationInstance`` is EVALCOMPLETED."""
    (base / f"{module}.py").write_text(
        source or EVAL_MODULE.format(template=template, metric=metric, k=k, path=str(engine_json)))
    sys.path.insert(0, str(base))
    try:
        reset_launch_counts()
        eval_s = console_ok(label, ["eval", f"{module}:evaluation", "--output-path", str(base / "best.json"),
                                    *dev_args])
        launches = read_launch_counts()
    finally:
        sys.path.remove(str(base))
        sys.modules.pop(module, None)
    (instance,) = Storage.get_meta_data_evaluation_instances().get_all()
    if instance.status != "EVALCOMPLETED":
        raise RuntimeError(f"{label}: evaluation instance {instance.id} is {instance.status}")
    score = json.loads((base / "best.json").read_text())["bestScore"]["score"]
    if not np.isfinite(score):
        raise RuntimeError(f"{label}: the eval scored {score}")
    return score, launches, eval_s


def phase_quickstart(device, n_queries: int, k: int, smi: str, then=None) -> dict:
    """``app new`` -> ``import`` -> ``train`` -> ``deploy`` -> queries ->
    ``eval``, all through the port's console, in a temporary
    ``PIO_FS_BASEDIR``; ``then(ctx)``, given the store, runs before it is
    removed."""
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
        RecommendationDataSource,
    )

    t_phase = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    with temporary_store("pio-quickstart-") as base:
        console_ok("quickstart", ["app", "new", QS_APP])
        users, items, ratings, stamps = synthesize_ml100k(42)
        events = base / "events.json"
        file_s = write_ndjson(events, (
            {"event": "rate", "entityType": "user", "entityId": str(u), "targetEntityType": "item",
             "targetEntityId": str(i), "properties": {"rating": float(r)},
             "eventTime": format_event_time(dt.datetime.fromtimestamp(t, dt.timezone.utc))}
            for u, i, r, t in zip(users.tolist(), items.tolist(), ratings.tolist(), stamps.tolist())
        ))
        import_s = console_ok("quickstart", ["import", "--appname", QS_APP, "--input", str(events)])
        engine_json = base / "engine.json"
        body = {
            "id": QS_APP, "version": "1", "engineFactory": QS_FACTORY,
            "datasource": {"params": {"appName": QS_APP, "evalK": QS_EVAL_K}},
            "algorithms": [{"name": "als", "params": {
                "rank": QS_RANK, "numIterations": QS_SWEEPS, "lambda": 0.01, "seed": 3}}],
        }
        engine_json.write_text(json.dumps(body))

        reset_launch_counts()
        train_wall_s = console_ok("quickstart", ["train", "--engine-json", str(engine_json), *dev_args])
        launches = read_launch_counts()
        (instance,) = Storage.get_meta_data_engine_instances().get_all()
        if instance.status != "COMPLETED":
            raise RuntimeError(f"quickstart: engine instance {instance.id} is {instance.status}")
        timings = json.loads(instance.env["phase_timings"])
        # the plan from the training data as the DataSource reads it
        source = RecommendationDataSource(DataSourceParams(app_name=QS_APP, eval_k=QS_EVAL_K))
        td = source.read_training(local_context(device))
        cfg = ALSConfig(rank=QS_RANK)

        def plan(t) -> int:
            return QS_SWEEPS * (planned_solves(t.rows, len(t.user_index), cfg)
                                + planned_solves(t.cols, len(t.item_index), cfg))

        expected = plan(td)
        if device.type == "cuda":
            check_launches("quickstart", launches, {"gj_solve": expected})

        model = stored_model(instance.id)
        U64 = np.asarray(model.user_factors, np.float64)
        V64 = np.asarray(model.item_factors, np.float64)
        if not (np.isfinite(U64).all() and np.isfinite(V64).all()):
            raise RuntimeError("quickstart: the stored model is not finite host factors")
        pred = np.einsum("nk,nk->n", U64[td.rows], V64[td.cols])
        rmse = float(np.sqrt(np.mean((pred - td.vals) ** 2)))
        mean_rmse = float(np.sqrt(np.mean((td.vals.mean() - td.vals) ** 2)))
        if not rmse < mean_rmse:
            raise RuntimeError(f"quickstart: train RMSE {rmse} is not below the mean rating's {mean_rmse}")

        served = deploy_and_query("quickstart", base, engine_json, dev_args, instance.id,
                                  (model.user_index, model.item_index), U64, V64, None, n_queries, k, 13, device)

        # pio eval: precision@10 over QS_EVAL_K folds; the plan and the
        # precision of a random ranking from the port's own folds
        folds = source.read_eval(local_context(device))
        eval_plan = sum(plan(fold_td) for fold_td, _, _ in folds)
        random_units = []
        for fold_td, _, qa in folds:
            known = set(fold_td.item_index)
            for q, actual in qa:
                if q.user in fold_td.user_index:
                    candidates = known - set(actual.seen)
                    random_units.append(len(candidates & set(actual.items)) / len(candidates))
        random_precision = float(np.mean(random_units))
        score, eval_launches, eval_s = run_eval("quickstart", base, "qs_eval", "recommendation", "PrecisionAtK",
                                                TOP_K, engine_json, dev_args)
        if device.type == "cuda":
            check_launches("quickstart eval", eval_launches, {"gj_solve": eval_plan})
        if not score > random_precision:
            raise RuntimeError(f"quickstart: precision@{TOP_K} {score} is not above a random ranking's "
                               f"{random_precision}")
        out = {
            "events": int(users.size), "users": len(td.user_index), "items": len(td.item_index),
            "rank": QS_RANK, "sweeps": QS_SWEEPS, "file_s": file_s, "import_s": import_s,
            "events_per_s_imported": users.size / import_s, "read_s": timings["read"],
            "prepare_s": timings["prepare"], "train_als_s": timings["train:als"], "train_wall_s": train_wall_s,
            "deploy_start_s": served["deploy_start_s"], "gj_solve_launches": launches["gj_solve"],
            "planned": expected, "train_rmse": rmse, "mean_rmse": mean_rmse, "queries": n_queries,
            "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"], "status_device": served["status_device"],
            "instance": instance.id, "eval_k": QS_EVAL_K, "eval_s": eval_s,
            "eval_gj_solve_launches": eval_launches["gj_solve"], "eval_planned": eval_plan,
            f"precision_at_{TOP_K}": score, f"random_precision_at_{TOP_K}": random_precision,
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }
        log(f"[quickstart] {json.dumps(out)}")
        if then is not None:
            out["then"] = then({"base": base, "engine_json": engine_json, "dev_args": dev_args,
                                "instance": instance, "model": model})
        return out


def recall_units(user_vecs, item_vecs, td, qa, k: int) -> list:
    """RecallAtK's units over a fold's ``(query, actual)`` pairs in float64
    numpy: each user's top-``k`` of the items it did not see in ``td``."""
    U = np.asarray(user_vecs, np.float64)
    V = np.asarray(item_vecs, np.float64)
    units = []
    for q, actual in qa:
        s = V @ U[td.user_index[q.user]]
        s[[td.item_index[i] for i in td.seen[q.user]]] = -np.inf
        top = {td.item_index.inverse(int(j)) for j in np.argsort(-s, kind="stable")[:k]}
        units.append(len(top & set(actual)) / len(set(actual)))
    return units


def eval_reference(engine_json: Path, td, model, folds: list, k: int, device) -> dict:
    """What ``pio eval`` of the Two-Tower engine must score, from towers
    trained here with the engine.json's params on each of the port's
    ``read_eval`` folds (the eval keeps none of its own): RecallAtK in
    float64 numpy, each fold's and the mean of all units as the metric
    takes it. Also the recall of ranking each user's unseen items by
    their count in the fold, and how far a retraining on ``td`` lands
    from the stored towers (0 when training on the card repeats itself)."""
    variant = load_engine_variant(str(engine_json))
    (_, params), = variant.engine_params(tt.engine_factory()).algorithms
    ctx = local_context(device)
    units, fold_recalls, popular = [], [], []
    for fold_td, _, qa in folds:
        towers = tt.TwoTowerAlgorithm(params, device).train(ctx, fold_td)
        fold_units = recall_units(towers.user_vecs, towers.item_vecs, fold_td, qa, k)
        units += fold_units
        fold_recalls.append(float(np.mean(fold_units)))
        # popularity as a product: every user's vector is 1, every item's
        # its count in the fold's training pairs
        counts = np.bincount(fold_td.cols, minlength=len(fold_td.item_index)).astype(np.float64)
        popular += recall_units(np.ones((len(fold_td.user_index), 1)), counts[:, None], fold_td, qa, k)
    again = tt.TwoTowerAlgorithm(params, device).train(ctx, td)
    diff = max(float(np.abs(again.user_vecs - model.user_vecs).max()),
               float(np.abs(again.item_vecs - model.item_vecs).max()))
    return {"reference": float(np.mean(units)), "folds": fold_recalls, "popularity": float(np.mean(popular)),
            "retrain_max_abs_diff": diff}


def phase_tt_quickstart(device, nnz: int, dim: int, batch: int, epochs: int, n_queries: int, k: int,
                        smi: str, then=None) -> dict:
    """The quickstart of the Two-Tower engine: ``app new`` -> ``import`` of
    ``nnz`` planted ``view`` pairs -> ``train`` -> ``deploy`` -> queries ->
    ``eval``, all through the port's console, in a temporary
    ``PIO_FS_BASEDIR`` whose events live in the columnar store.
    ``then(ctx)``, when given, runs last in the store; its result is the
    output's ``"serving"``."""
    t_phase = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    with temporary_store("pio-tt-quickstart-", "columnar") as base:
        console_ok("tt-quickstart", ["app", "new", TTQ_APP])
        r_tr, c_tr, r_te, c_te, num_users, num_items = planted_pairs(nnz, seed=11)
        events = base / "events.json"
        file_s = write_ndjson(events, (
            {"event": "view", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
             "targetEntityId": f"i{i}", "eventTime": "2021-01-01T00:00:00.000Z"}
            for u, i in zip(r_tr.tolist(), c_tr.tolist())
        ))
        import_s = console_ok("tt-quickstart", ["import", "--appname", TTQ_APP, "--input", str(events)])
        engine_json = base / "engine.json"
        engine_json.write_text(json.dumps({
            "id": TTQ_APP, "version": "1", "engineFactory": TTQ_FACTORY,
            "datasource": {"params": {"appName": TTQ_APP, "eventNames": ["view"], "evalK": QS_EVAL_K}},
            "algorithms": [{"name": "twotower", "params": {
                "embeddingDim": dim, "batchSize": batch, "epochs": epochs, "learningRate": 0.05,
                "temperature": 1.0 / TT_INV_TEMP, "seed": 2}}],
        }))

        reset_launch_counts()
        train_wall_s = console_ok("tt-quickstart", ["train", "--engine-json", str(engine_json), *dev_args])
        launches = read_launch_counts()
        (instance,) = Storage.get_meta_data_engine_instances().get_all()
        if instance.status != "COMPLETED":
            raise RuntimeError(f"tt-quickstart: engine instance {instance.id} is {instance.status}")
        timings = json.loads(instance.env["phase_timings"])
        # the step plan from the pairs as the DataSource reads them
        source = tt.TwoTowerDataSource(tt.DataSourceParams(app_name=TTQ_APP, event_names=("view",),
                                                           eval_k=QS_EVAL_K))
        td = source.read_training(local_context(device))

        def plan(t) -> dict:
            steps = epochs * -(-t.rows.size // batch)
            return {"fused_ce_fwd": steps, "fused_ce_bwd": 2 * steps}

        expected = plan(td)
        if device.type == "cuda":
            check_launches("tt-quickstart", launches, expected)

        model = stored_model(instance.id)
        if not (np.isfinite(model.user_vecs).all() and np.isfinite(model.item_vecs).all()):
            raise RuntimeError("tt-quickstart: the stored towers are not finite")
        if model.user_vecs.shape != (len(td.user_index), dim):
            raise RuntimeError(f"tt-quickstart: user tower shape {model.user_vecs.shape}")
        loss_first, loss_last = model.loss_history[0][1], model.loss_history[-1][1]
        if not loss_last < 0.8 * loss_first:
            raise RuntimeError(f"tt-quickstart: loss did not fall below 0.8x its first value "
                               f"({loss_first} -> {loss_last})")
        probe = min(TT_RECALL_PROBE, r_te.size)
        recall = probe_recall(model, [f"u{u}" for u in r_te[:probe].tolist()],
                              [f"i{i}" for i in c_te[:probe].tolist()], device)
        random_recall = 10.0 / len(model.item_index)
        if not recall["recall_at_10"] > 5 * random_recall:
            raise RuntimeError(f"tt-quickstart: recall@10 {recall['recall_at_10']} is not above 5x random "
                               f"({random_recall})")

        served = deploy_and_query(
            "tt-quickstart", base, engine_json, dev_args, instance.id, (model.user_index, model.item_index),
            model.user_vecs.astype(np.float64), model.item_vecs.astype(np.float64), model.seen, n_queries, k, 14,
            device)

        # pio eval: recall@10 over QS_EVAL_K folds; the plan and the recall
        # of a random ranking from the port's own folds
        folds = source.read_eval(local_context(device))
        eval_plan = {"fused_ce_fwd": 0, "fused_ce_bwd": 0}
        random_units = []
        for fold_td, _, qa in folds:
            for name, n in plan(fold_td).items():
                eval_plan[name] += n
            for q, actual in qa:
                candidates = len(fold_td.item_index) - len(fold_td.seen[q.user])
                in_model = sum(1 for i in actual if i in fold_td.item_index)
                random_units.append(min(1.0, 10 / candidates) * in_model / len(actual))
        random_eval = float(np.mean(random_units))
        score, eval_launches, eval_s = run_eval("tt-quickstart", base, "tt_eval", "twotower", "RecallAtK",
                                                TOP_K, engine_json, dev_args)
        if device.type == "cuda":
            check_launches("tt-quickstart eval", eval_launches, eval_plan)
        check = eval_reference(engine_json, td, model, folds, TOP_K, device)
        if not (check["reference"] > 0 and abs(score - check["reference"]) <= 0.1 * check["reference"]):
            raise RuntimeError(f"tt-quickstart: eval recall@{TOP_K} {score} is not within 10% of "
                               f"{check['reference']}, float64 numpy over towers trained on the same folds")
        out = {
            "pairs_imported": int(r_tr.size), "pairs": int(td.rows.size), "users": len(td.user_index),
            "items": len(td.item_index), "dim": dim, "batch": batch, "epochs": epochs, "file_s": file_s,
            "import_s": import_s, "events_per_s_imported": r_tr.size / import_s, "read_s": timings["read"],
            "train_tt_s": timings["train:twotower"], "train_wall_s": train_wall_s,
            "deploy_start_s": served["deploy_start_s"], "launches": {n: launches[n] for n in expected},
            "planned": expected, "loss_first": loss_first, "loss_last": loss_last, **recall,
            "random_recall_at_10": random_recall, "queries": n_queries, "p50_ms": served["p50_ms"],
            "p99_ms": served["p99_ms"], "status_device": served["status_device"], "instance": instance.id,
            "eval_k": QS_EVAL_K, "eval_s": eval_s, "eval_launches": {n: eval_launches[n] for n in eval_plan},
            "eval_planned": eval_plan, f"eval_recall_at_{TOP_K}": score,
            f"reference_eval_recall_at_{TOP_K}": check["reference"], "reference_fold_recalls": check["folds"],
            f"random_eval_recall_at_{TOP_K}": random_eval,
            f"popularity_eval_recall_at_{TOP_K}": check["popularity"],
            "retrain_max_abs_diff": check["retrain_max_abs_diff"], "phase_s": time.perf_counter() - t_phase,
            "card": smi,
        }
        log(f"[tt-quickstart] {json.dumps(out)}")
        if then is not None:
            out["serving"] = then({"base": base, "engine_json": engine_json, "dev_args": dev_args,
                                   "model": model, "instance": instance.id, "plan": expected,
                                   "deploy_start_s": served["deploy_start_s"]})
        return out


# ------------------------------------------------------------ 8. workflow
def _post_bytes(url: str, data: bytes, ctype: str) -> tuple[int, bytes]:
    """POST ``data``; the whole response body, read to its end."""
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.read()


def bulk_delta(rows: np.ndarray, cols: np.ndarray, num_users: int, num_items: int, bulk: dict,
               seed: int) -> list:
    """The eventserver's delta as NDJSON objects, each with a client
    ``eventId`` and a time after every stored event: re-rates of stored
    pairs, new pairs of stored users and items, then events of users and
    items the store does not hold (``n<j>`` rates ``m<i>``, distinct pairs)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(rows.size, size=bulk["rerates"], replace=False)
    pairs = [(str(u), str(i)) for u, i in zip(rows[pick].tolist(), cols[pick].tolist())]
    stored = np.unique(rows * num_items + cols)
    fresh = np.empty(0, np.int64)
    while fresh.size < bulk["new_pairs"]:
        cand = rng.integers(0, num_users, 2 * bulk["new_pairs"]) * num_items + rng.integers(
            0, num_items, 2 * bulk["new_pairs"])
        fresh = np.unique(np.concatenate([fresh, cand[~np.isin(cand, stored)]]))
    fresh = rng.permutation(fresh)[: bulk["new_pairs"]]
    pairs += [(str(k // num_items), str(k % num_items)) for k in fresh.tolist()]
    per_user = bulk["new_events"] // bulk["new_users"]
    pairs += [(f"n{j}", f"m{i}") for j in range(bulk["new_users"])
              for i in rng.choice(bulk["new_items"], size=per_user, replace=False).tolist()]
    stars = rng.integers(1, 11, len(pairs)) / 2.0
    t0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
    return [
        {"event": "rate", "entityType": "user", "entityId": u, "targetEntityType": "item", "targetEntityId": i,
         "properties": {"rating": float(r)}, "eventId": f"wf-{n}",
         "eventTime": format_event_time(t0 + dt.timedelta(milliseconds=n))}
        for n, ((u, i), r) in enumerate(zip(pairs, stars.tolist()))
    ]


def same_training_data(a, b) -> bool:
    return (np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols) and np.array_equal(a.vals, b.vals)
            and a.user_index.to_dict() == b.user_index.to_dict()
            and a.item_index.to_dict() == b.item_index.to_dict())


class RecordHandler(logging.Handler):
    """Keeps the messages of the log records it receives."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


def phase_workflow(device, nnz: int, bulk: dict, n_queries: int, k: int, smi: str, then=None,
                   after_cold=None) -> dict:
    """``bench.py::_bench_workflow`` through the port's verbs, in a
    temporary columnar store: ``app new``; ``nnz`` ML-20M-shaped ``rate``
    events through ``PEvents.write_columns``; ``pio train`` cold; ``pio
    eventserver`` taking the ``bulk`` delta through ``POST
    /events/bulk.json`` (and a retransmit of its tail, absorbed) and
    ``WF_SINGLES`` events through ``POST /events.json``; ``pio train``
    warm, which must take the incremental path and equal a full read;
    ``pio deploy`` of the warm instance with queries of stored and of new
    users held to float64 numpy; ``pio app compact``, after which a full
    read is unchanged. Each train's ``gj_solve`` launches must equal the
    plan of the TrainingData a full read gives. ``after_cold()``, when
    given, runs once the cold train is checked; ``then(ctx)``, when
    given, runs last in the store (the serving phase); its result is the
    output's ``"serving"``."""
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
        RecommendationDataSource,
    )
    from predictionio_tpu_torch.templates.recommendation import engine as rec_engine

    t_phase = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    cfg = ALSConfig(rank=WF_RANK)

    def full_read():
        source = RecommendationDataSource(DataSourceParams(app_name=WF_APP, incremental=False))
        td = source.read_training(local_context(device))
        return td, WF_SWEEPS * (planned_solves(td.rows, len(td.user_index), cfg)
                                + planned_solves(td.cols, len(td.item_index), cfg))

    def train(label: str) -> dict:
        handler = RecordHandler()
        logger = logging.getLogger(rec_engine.__name__)
        level = logger.level
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        try:
            reset_launch_counts()
            wall_s = console_ok(label, ["train", "--engine-json", str(engine_json), *dev_args])
            launches = read_launch_counts()
        finally:
            logger.removeHandler(handler)
            logger.setLevel(level)
        instance = max(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
        if instance.status != "COMPLETED":
            raise RuntimeError(f"{label}: engine instance {instance.id} is {instance.status}")
        timings = json.loads(instance.env["phase_timings"])
        return {"instance": instance, "wall_s": wall_s, "read_s": timings["read"],
                "train_als_s": timings["train:als"], "launches": launches["gj_solve"], "log": handler.messages}

    with temporary_store("pio-workflow-", "columnar") as base:
        console_ok("workflow", ["app", "new", WF_APP])
        app = Storage.get_meta_data_apps().get_by_name(WF_APP)
        (access_key,) = Storage.get_meta_data_access_keys().get_by_appid(app.id)

        # 1. the ratings, written as columns
        rows, cols, vals, num_users, num_items = ml20m_shaped(nnz, seed=5)
        t_us = (1_600_000_000_000_000 + np.random.default_rng(9).integers(0, 10**9, nnz)).astype(np.int64)
        t0 = time.perf_counter()
        written = Storage.get_p_events().write_columns(
            app.id, event="rate", entity_type="user", entity_codes=rows,
            entity_vocab=np.asarray([str(i) for i in range(num_users)]), target_entity_type="item",
            target_codes=cols, target_vocab=np.asarray([str(i) for i in range(num_items)]),
            event_time_us=t_us, props={"rating": vals.astype(np.float64)},
        )
        write_s = time.perf_counter() - t0
        if written != nnz:
            raise RuntimeError(f"workflow: write_columns wrote {written} of {nnz} events")
        store_bytes = sum(f.stat().st_size for f in (base / "events").rglob("*") if f.is_file())
        log(f"[workflow] wrote {nnz} events in {write_s:.3f} s ({nnz / write_s:.1f} events/s), "
            f"{store_bytes / 2**20:.1f} MiB on disk")

        # 2. pio train, cold
        engine_json = base / "engine.json"
        engine_json.write_text(json.dumps({
            "id": WF_APP, "version": "1", "engineFactory": WF_FACTORY,
            "datasource": {"params": {"appName": WF_APP}},
            "algorithms": [{"name": "als", "params": {
                "rank": WF_RANK, "numIterations": WF_SWEEPS, "lambda": WF_LAMBDA, "seed": WF_SEED}}],
        }))
        cold = train("workflow cold train")
        td_cold, cold_plan = full_read()
        if device.type == "cuda":
            check_launches("workflow cold train", {"gj_solve": cold["launches"]}, {"gj_solve": cold_plan})
        if any("Incremental re-index" in m for m in cold["log"]):
            raise RuntimeError(f"workflow: the cold train read incrementally: {cold['log']}")
        model = stored_model(cold["instance"].id)
        U64 = np.asarray(model.user_factors, np.float64)
        V64 = np.asarray(model.item_factors, np.float64)
        if not (np.isfinite(U64).all() and np.isfinite(V64).all()):
            raise RuntimeError("workflow: the cold model is not finite")
        if model.user_index.to_dict() != td_cold.user_index.to_dict():
            raise RuntimeError("workflow: the cold model's users differ from a full read's")
        rmse = rmse_f64(U64, V64, td_cold.rows, td_cold.cols, td_cold.vals, device)
        mean_rmse = float(np.sqrt(np.mean((td_cold.vals.mean() - td_cold.vals) ** 2)))
        if not rmse < mean_rmse:
            raise RuntimeError(f"workflow: train RMSE {rmse} is not below the mean rating's {mean_rmse}")
        del U64, V64, model
        cache_json = next((base / "train_cache").glob("*.json"))
        cold_payload = json.loads(cache_json.read_text())["payload_id"]
        log(f"[workflow] cold train: read {cold['read_s']:.3f} s, train:als {cold['train_als_s']:.3f} s, "
            f"wall {cold['wall_s']:.3f} s, {cold['launches']} gj_solve launches (plan {cold_plan}), "
            f"rmse {rmse:.6f} (mean rating's {mean_rmse:.6f})")
        if after_cold is not None:
            after_cold()

        # 3. pio eventserver: the bulk delta, a retransmit, single events
        delta = bulk_delta(rows, cols, num_users, num_items, bulk, seed=21)
        lines = [(json.dumps(obj) + "\n").encode() for obj in delta]
        singles = [
            {"event": "rate", "entityType": "user", "entityId": f"n{j}", "targetEntityType": "item",
             "targetEntityId": f"m{j}", "properties": {"rating": 4.5},
             "eventTime": format_event_time(dt.datetime(2021, 2, 1, 0, 0, j, 250000, tzinfo=dt.timezone.utc))}
            for j in range(WF_SINGLES)
        ]
        del rows, cols, vals, t_us
        proc = None
        try:
            t0 = time.perf_counter()
            proc, port = start_console_server("workflow", base, ["eventserver", "--drain-deadline-s", "30"],
                                              base / "eventserver.stderr", WF_SERVER_TIMEOUT_S)
            server_start_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            t0 = time.perf_counter()
            status, body = _post_bytes(f"{url}/events/bulk.json?accessKey={access_key.key}", b"".join(lines),
                                       "application/x-ndjson")
            bulk_s = time.perf_counter() - t0
            summary = json.loads(body.splitlines()[-1])
            if status != 200 or not summary.get("ok") or summary["stored"] != len(lines) or summary["duplicates"]:
                raise RuntimeError(f"workflow: the bulk POST answered {status} {summary}")
            status, body = _post_bytes(f"{url}/events/bulk.json?accessKey={access_key.key}",
                                       b"".join(lines[-bulk["resend"]:]), "application/x-ndjson")
            resent = json.loads(body.splitlines()[-1])
            if status != 200 or resent["stored"] != 0 or resent["duplicates"] != bulk["resend"]:
                raise RuntimeError(f"workflow: the retransmit answered {status} {resent}")
            grown = len(Storage.get_p_events().find_columns(app.id)) - nnz
            if grown != len(lines):
                raise RuntimeError(f"workflow: the store grew by {grown} events, not {len(lines)}")
            for obj in singles:
                status, created = _http_json(f"{url}/events.json?accessKey={access_key.key}", obj)
                got_status, got = _http_json(f"{url}/events/{created['eventId']}.json?accessKey={access_key.key}")
                if status != 201 or got_status != 200 or any(got.get(key) != value for key, value in obj.items()):
                    raise RuntimeError(f"workflow: single event {obj} read back as {got_status} {got}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            proc = None
            if rc != 0:
                raise RuntimeError(f"workflow: the eventserver exited {rc} on SIGTERM: "
                                   f"{(base / 'eventserver.stderr').read_text()[-2000:]}")
        finally:
            if proc is not None:
                proc.kill()
                proc.wait(timeout=30)
        state = Storage.get_p_events().scan_state(app.id)
        if state["tail_lines"] != WF_SINGLES:
            raise RuntimeError(f"workflow: the tail holds {state['tail_lines']} lines, not {WF_SINGLES}")
        log(f"[workflow] eventserver: {len(lines)} events in {bulk_s:.3f} s through /events/bulk.json "
            f"({len(lines) / bulk_s:.1f} events/s), {resent['duplicates']} resent duplicates absorbed, "
            f"{WF_SINGLES} single events read back")

        # 4. pio train, warm: the incremental path
        warm = train("workflow warm train")
        meta = json.loads(cache_json.read_text())
        if not any("Incremental re-index: merged" in m for m in warm["log"]):
            raise RuntimeError(f"workflow: the warm train did not read incrementally: {warm['log']}")
        if (meta["segments"], meta["tail_lines"]) != (state["segments"], state["tail_lines"]) or (
                meta["payload_id"] == cold_payload):
            raise RuntimeError(f"workflow: the cache manifest {meta} does not record the store's state {state}")
        td_warm, warm_plan = full_read()
        cached = RecommendationDataSource(DataSourceParams(app_name=WF_APP)).read_training(local_context(device))
        warm_model = stored_model(warm["instance"].id)
        if not same_training_data(cached, td_warm) or (
                warm_model.user_index.to_dict() != td_warm.user_index.to_dict()) or (
                warm_model.item_index.to_dict() != td_warm.item_index.to_dict()):
            raise RuntimeError("workflow: the incremental read differs from a full read")
        if device.type == "cuda":
            check_launches("workflow warm train", {"gj_solve": warm["launches"]}, {"gj_solve": warm_plan})
        log(f"[workflow] warm train: read {warm['read_s']:.3f} s (cold {cold['read_s']:.3f} s), "
            f"train:als {warm['train_als_s']:.3f} s, wall {warm['wall_s']:.3f} s; {warm['launches']} gj_solve "
            f"launches (plan {warm_plan}); {warm['log'][-1]}")

        # 5. pio deploy of the warm instance: stored users and new ones
        U64 = np.asarray(warm_model.user_factors, np.float64)
        V64 = np.asarray(warm_model.item_factors, np.float64)
        rng = np.random.default_rng(17)
        new_rows = [warm_model.user_index[f"n{j}"] for j in rng.choice(bulk["new_users"], WF_DELTA_QUERIES,
                                                                        replace=False).tolist()]
        old_rows = [warm_model.user_index[str(u)] for u in rng.choice(num_users, n_queries - WF_DELTA_QUERIES,
                                                                       replace=False).tolist()]
        served = deploy_and_query("workflow", base, engine_json, dev_args, warm["instance"].id,
                                  (warm_model.user_index, warm_model.item_index), U64, V64, None, n_queries, k, 0,
                                  device, picks=np.asarray(new_rows + old_rows))
        del U64, V64, warm_model

        # 6. pio app compact: the tail goes into a segment, the data stays
        console_ok("workflow", ["app", "compact", WF_APP])
        after = Storage.get_p_events().scan_state(app.id)
        td_after, _ = full_read()
        if after["tail_lines"] != 0 or after["compactions"] != state["compactions"] + 1 or not same_training_data(
                td_after, td_warm):
            raise RuntimeError(f"workflow: after the compaction the store is {after} and a full read "
                               f"{'equals' if same_training_data(td_after, td_warm) else 'differs from'} the one before")
        out = {
            "events": nnz, "pairs_cold": int(td_cold.rows.size), "pairs_warm": int(td_warm.rows.size),
            "users_warm": len(td_warm.user_index), "items_warm": len(td_warm.item_index), "rank": WF_RANK,
            "sweeps": WF_SWEEPS, "write_s": write_s, "write_events_per_s": nnz / write_s,
            "store_mib": store_bytes / 2**20, "eventserver_start_s": server_start_s, "bulk_events": len(lines),
            "bulk_s": bulk_s, "bulk_events_per_s": len(lines) / bulk_s, "duplicates_absorbed": resent["duplicates"],
            "singles": WF_SINGLES, "cold_read_s": cold["read_s"], "cold_train_als_s": cold["train_als_s"],
            "cold_wall_s": cold["wall_s"], "cold_launches": cold["launches"], "cold_planned": cold_plan,
            "warm_read_s": warm["read_s"], "warm_train_als_s": warm["train_als_s"], "warm_wall_s": warm["wall_s"],
            "warm_launches": warm["launches"], "warm_planned": warm_plan, "train_rmse": rmse, "mean_rmse": mean_rmse,
            "deploy_start_s": served["deploy_start_s"], "queries": n_queries, "delta_user_queries": WF_DELTA_QUERIES,
            "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"], "status_device": served["status_device"],
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }
        log(f"[workflow] {json.dumps(out)}")
        if then is not None:
            out["serving"] = then({"base": base, "engine_json": engine_json, "dev_args": dev_args,
                                   "instance": warm["instance"], "full_read": full_read})
        return out


# ------------------------------------------------------------- 9. serving
def load_picks(n: int, num_users: int, seed: int, zipf_a: float | None = None) -> np.ndarray:
    """``n`` user rows: uniform over the stored users, or Zipf(``zipf_a``)
    the way ``bench.py::_bench_serving_cache`` draws them."""
    rng = np.random.default_rng(seed)
    if zipf_a is None:
        return rng.integers(0, num_users, n)
    return (rng.zipf(zipf_a, n) - 1) % num_users


def run_load(url: str, picks: np.ndarray, user_index, clients: int, k: int,
             stop: threading.Event | None = None, seed: int = 0) -> dict:
    """``clients`` threads, each on one keep-alive connection, POST
    ``/queries.json`` top-``k`` for its share of ``picks`` (client ``c``
    takes ``picks[c::clients]``), or, given ``stop``, for random stored
    users until it is set. Returns every answer as ``(user row, status,
    payload, start, end)`` and the rate and latencies."""
    import http.client

    host, port = url.removeprefix("http://").split(":")
    records: list = []
    lock = threading.Lock()
    errors: list = []

    def client(c: int) -> None:
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        rng = np.random.default_rng(seed * 1000 + c)
        mine = iter(picks[c::clients].tolist()) if stop is None else None
        out = []
        try:
            while True:
                if stop is None:
                    uidx = next(mine, None)
                    if uidx is None:
                        break
                elif stop.is_set():
                    break
                else:
                    uidx = int(rng.integers(0, len(user_index)))
                body = json.dumps({"user": user_index.inverse(uidx), "num": k}).encode()
                t0 = time.perf_counter()
                conn.request("POST", "/queries.json", body=body, headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read())
                out.append((uidx, resp.status, payload, t0, time.perf_counter()))
        except Exception as e:  # reported below; a failed client fails the phase
            errors.append(repr(e))
        finally:
            conn.close()
            with lock:
                records.extend(out)

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"serving: {len(errors)} clients failed: {errors[:3]}")
    lat = [(end - start) * 1e3 for _, _, _, start, end in records]
    p50, p99 = np.percentile(lat, [50, 99]) if lat else (float("nan"), float("nan"))
    return {"records": records, "wall_s": wall, "queries": len(records), "queries_per_s": len(records) / wall,
            "p50_ms": float(p50), "p99_ms": float(p99)}


def check_answers(label: str, answers: list, U64: np.ndarray, V64: np.ndarray, item_index, k: int,
                  seen: dict | None = None, user_index=None) -> int:
    """Every ``(user row, payload)`` answer's top-``k`` against the float64
    numpy top-``k`` of ``U64``/``V64`` (without the user's ``seen``
    items) under the near-tie rule (:func:`check_ranking`); raises on any
    difference. Scores in chunks of 512 users."""
    bad = []
    for lo in range(0, len(answers), 512):
        part = answers[lo:lo + 512]
        S = U64[[u for u, _ in part]] @ V64.T
        for (uidx, payload), scores in zip(part, S):
            got = [item_index[s["item"]] for s in payload["itemScores"]]
            masked = scores
            if seen is not None:
                drop = [item_index[i] for i in seen.get(user_index.inverse(uidx), ())]
                masked = scores.copy()
                masked[drop] = -np.inf
            top = np.argpartition(-masked, k - 1)[:k]
            ref = top[np.lexsort((top, -masked[top]))]
            if not check_ranking(got, ref, scores):
                bad.append((uidx, got, ref.tolist()))
    if bad:
        raise RuntimeError(f"{label}: {len(bad)} of {len(answers)} top-{k} lists differ from float64 numpy: {bad[:3]}")
    return len(answers)


def ok_answers(label: str, load: dict) -> list:
    """The ``(user row, payload)`` of a load's answers, all of which must be 200."""
    statuses = {}
    for _, status, _, _, _ in load["records"]:
        statuses[status] = statuses.get(status, 0) + 1
    if set(statuses) != {200}:
        raise RuntimeError(f"{label}: answers other than 200: {statuses}")
    return [(u, payload) for u, _, payload, _, _ in load["records"]]


def load_line(label: str, load: dict, clients: int, card: str) -> None:
    log(f"[serving] {label}: {load['queries']} queries from {clients} keep-alive clients in "
        f"{load['wall_s']:.3f} s, {load['queries_per_s']:.1f} queries/s, p50 {load['p50_ms']:.3f} ms, "
        f"p99 {load['p99_ms']:.3f} ms on {card}")


def phase_serving(device, ctx: dict, clients: int, per_client: int, k: int, batchpredict_n: int,
                  smi: str) -> dict:
    """The serving tier of ``pio deploy`` on the workflow's store and warm
    instance (ML-20M shape, rank 64): a per-request deploy against a
    ``--batching --pin-model --result-cache --coalesce --feedback`` one
    (feedback into a ``pio eventserver`` on the same store) under the
    same uniform load, then a Zipf load; ``pio train --warm-start``
    (``SRV_WARM_SWEEPS`` sweeps, launches held to the plan) and ``POST
    /reload`` under load; a degraded ``/reload``; ``pio undeploy``; ``pio
    batchpredict``; ``SRV_RELOADS`` reloads of an in-process ``QueryService`` with
    the card's allocated memory flat. Every answer checked is held to
    float64 numpy under the near-tie rule."""
    from predictionio_tpu_torch.templates.recommendation import engine as rec_engine

    t_phase = time.perf_counter()
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    first = ctx["instance"]
    model = stored_model(first.id)
    user_index, item_index = model.user_index, model.item_index
    U64 = np.asarray(model.user_factors, np.float64)
    V64 = np.asarray(model.item_factors, np.float64)
    rank = model.user_factors.shape[1]
    pinned_bytes = (len(user_index) + len(item_index)) * rank * 4
    n = clients * per_client
    uniform = load_picks(n, len(user_index), seed=31)
    warm_query = json.dumps({"user": user_index.inverse(0), "num": k})
    out: dict = {"users": len(user_index), "items": len(item_index), "rank": rank, "clients": clients,
                 "requests_per_client": per_client, "card": smi}

    # 1. the per-request deploy (no tiers)
    proc, port = start_console_server("serving", base, ["deploy", "--engine-json", str(engine_json), *dev_args],
                                      base / "deploy-plain.stderr", QS_DEPLOY_TIMEOUT_S)
    try:
        plain = run_load(f"http://127.0.0.1:{port}", uniform, user_index, clients, k)
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    plain_answers = ok_answers("serving per-request", plain)
    check_answers("serving per-request", plain_answers, U64, V64, item_index, k)
    load_line("per-request deploy, uniform users", plain, clients, smi)

    # 2. the batched, cached, pinned deploy with feedback into an event server
    console_ok("serving", ["app", "new", SRV_FEEDBACK_APP])
    fb_app = Storage.get_meta_data_apps().get_by_name(SRV_FEEDBACK_APP)
    (fb_key,) = Storage.get_meta_data_access_keys().get_by_appid(fb_app.id)
    es_proc = dep_proc = None
    try:
        es_proc, es_port = start_console_server("serving", base, ["eventserver"], base / "es-srv.stderr",
                                                WF_SERVER_TIMEOUT_S)
        t0 = time.perf_counter()
        dep_proc, port = start_console_server(
            "serving", base,
            ["deploy", "--engine-json", str(engine_json), *dev_args, "--batching",
             "--max-batch-size", str(SRV_MAX_BATCH), "--max-batch-delay-ms", str(SRV_MAX_DELAY_MS),
             "--batch-warmup-query", warm_query, "--pin-model", "--result-cache", "--coalesce",
             "--feedback", "--event-server-ip", "127.0.0.1", "--event-server-port", str(es_port),
             f"--accesskey={fb_key.key}"],  # one word: a key may begin with "-"
            base / "deploy-srv.stderr", QS_DEPLOY_TIMEOUT_S)
        out["deploy_start_s"] = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        batched = run_load(url, uniform, user_index, clients, k)
        batched_answers = ok_answers("serving batched", batched)
        check_answers("serving batched", batched_answers, U64, V64, item_index, k)
        load_line("batched+cached+pinned deploy, uniform users", batched, clients, smi)
        plain_by_user = {}
        for u, payload in plain_answers:
            plain_by_user.setdefault(u, payload["itemScores"])
        same = sum(1 for u, payload in batched_answers if payload["itemScores"] == plain_by_user[u])
        same_order = sum(1 for u, payload in batched_answers if [s["item"] for s in payload["itemScores"]] == [
            s["item"] for s in plain_by_user[u]])
        _, stats_uniform = _http_json(url + "/stats.json")
        zipf = run_load(url, load_picks(n, len(user_index), seed=32, zipf_a=SRV_ZIPF_A), user_index, clients, k)
        zipf_answers = ok_answers("serving zipf", zipf)
        check_answers("serving zipf", zipf_answers, U64, V64, item_index, k)
        load_line(f"batched+cached+pinned deploy, Zipf({SRV_ZIPF_A}) users", zipf, clients, smi)
        _, stats = _http_json(url + "/stats.json")
        batcher, cache = stats["batcher"], stats["cache"]
        if batcher["bucketMisses"] != 0:
            raise RuntimeError(f"serving: {batcher['bucketMisses']} bucket misses after the warm-up")
        if cache["bytesPinned"] != pinned_bytes:
            raise RuntimeError(f"serving: bytesPinned {cache['bytesPinned']}, the tables hold {pinned_bytes}")
        zipf_hits = cache["hits"] - stats_uniform["cache"]["hits"]
        zipf_misses = cache["misses"] - stats_uniform["cache"]["misses"]
        out.update({
            "per_request": {key: plain[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")},
            "batched_uniform": {key: batched[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms",
                                                               "p99_ms")},
            "batched_zipf": {key: zipf[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")},
            "bit_equal_share": same / len(batched_answers),
            "same_order_share": same_order / len(batched_answers),
            "batch_size_hist": batcher["batchSizeHist"], "bucket_hist": batcher["bucketHist"],
            "mean_batch_size": batcher["meanBatchSize"], "bucket_misses": batcher["bucketMisses"],
            "warmed_buckets": batcher["warmedBuckets"], "batcher_latency_ms": batcher["latencyMs"],
            "cache_hit_ratio_uniform": stats_uniform["cache"]["hits"] / max(
                1, stats_uniform["cache"]["hits"] + stats_uniform["cache"]["misses"]),
            "cache_hit_ratio_zipf": zipf_hits / max(1, zipf_hits + zipf_misses),
            "coalesced": cache["coalesced"], "bytes_pinned": cache["bytesPinned"],
            "bytes_pinned_expected": pinned_bytes,
        })
        log(f"[serving] batcher: batch sizes {batcher['batchSizeHist']}, buckets {batcher['bucketHist']}, "
            f"bucketMisses {batcher['bucketMisses']}; cache hit ratio {out['cache_hit_ratio_uniform']:.4f} uniform, "
            f"{out['cache_hit_ratio_zipf']:.4f} Zipf; bytesPinned {cache['bytesPinned']}; "
            f"{same} of {len(batched_answers)} batched answers bit-equal to the per-request deploy's, "
            f"{same_order} with the same items in the same order, on {smi}")

        # 3. pio train --warm-start, then /reload under load
        warm_json = base / "engine-warm.json"
        spec = json.loads(engine_json.read_text())
        spec["algorithms"][0]["params"]["numIterations"] = SRV_WARM_SWEEPS
        warm_json.write_text(json.dumps(spec))
        handler = RecordHandler()
        logger = logging.getLogger(rec_engine.__name__)
        level = logger.level
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        try:
            reset_launch_counts()
            warm_s = console_ok("serving warm train", ["train", "--engine-json", str(warm_json), "--warm-start",
                                                       *dev_args])
            warm_launches = read_launch_counts()
        finally:
            logger.removeHandler(handler)
            logger.setLevel(level)
        second = max(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
        if second.status != "COMPLETED" or second.env.get("warm_start_from") != first.id:
            raise RuntimeError(f"serving: the warm train {second.id} is {second.status}, warm_start_from "
                               f"{second.env.get('warm_start_from')}, not {first.id}")
        td = ctx["full_read"]()[0]
        cfg = ALSConfig(rank=rank)
        plan = SRV_WARM_SWEEPS * (planned_solves(td.rows, len(td.user_index), cfg)
                                  + planned_solves(td.cols, len(td.item_index), cfg))
        if device.type == "cuda":
            check_launches("serving warm train", {"gj_solve": warm_launches["gj_solve"]}, {"gj_solve": plan})
        carried = next((m for m in handler.messages if m.startswith("Warm start: carried")), "")
        both_users = len(set(user_index.keys()) & set(td.user_index.keys()))
        both_items = len(set(item_index.keys()) & set(td.item_index.keys()))
        want = (f"Warm start: carried {both_users}/{len(td.user_index)} user and "
                f"{both_items}/{len(td.item_index)} item vectors")
        if carried != want:
            raise RuntimeError(f"serving: the warm train logged {carried!r}, expected {want!r}")
        new_model = stored_model(second.id)
        U2 = np.asarray(new_model.user_factors, np.float64)
        V2 = np.asarray(new_model.item_factors, np.float64)

        def rmse(U, V, m) -> float:
            r = np.asarray([m.user_index[u] for u in td.user_index.keys()])[td.rows]
            c = np.asarray([m.item_index[i] for i in td.item_index.keys()])[td.cols]
            return rmse_f64(U, V, r, c, td.vals, device)

        rmse_before, rmse_after = rmse(U64, V64, model), rmse(U2, V2, new_model)
        if not rmse_after <= rmse_before:
            raise RuntimeError(f"serving: the warm train's RMSE {rmse_after} exceeds its predecessor's {rmse_before}")
        log(f"[serving] pio train --warm-start: {SRV_WARM_SWEEPS} sweeps in {warm_s:.3f} s, "
            f"{warm_launches['gj_solve']} gj_solve launches (plan {plan}), {carried}, train RMSE "
            f"{rmse_before:.6f} -> {rmse_after:.6f}, warm_start_from {first.id}")
        stop = threading.Event()
        box: dict = {}
        loader = threading.Thread(target=lambda: box.update(
            run_load(url, np.zeros(0, np.int64), user_index, clients, k, stop=stop, seed=33)), daemon=True)
        loader.start()
        time.sleep(SRV_RELOAD_LEAD_S)
        t_reload = time.perf_counter()
        status, body = _http_json(url + "/reload", {})
        t_reloaded = time.perf_counter()
        time.sleep(SRV_RELOAD_LEAD_S)
        stop.set()
        loader.join()
        if status != 200:
            raise RuntimeError(f"serving: POST /reload answered {status} {body}")
        under_load = ok_answers("serving reload under load", box)
        before = [(u, p) for (u, _, p, _, end) in box["records"] if end < t_reload]
        after = [(u, p) for (u, _, p, start, _) in box["records"] if start > t_reloaded]
        check_answers("serving before the reload", before, U64, V64, item_index, k)
        check_answers("serving after the reload", after, U2, V2, new_model.item_index, k)
        _, stats = _http_json(url + "/stats.json")
        if stats["generation"] != 2:
            raise RuntimeError(f"serving: /stats.json reports generation {stats['generation']} after the reload")
        out["reload_under_load"] = {"queries": len(under_load), "before": len(before), "after": len(after),
                                    "non_200": 0, "reload_s": t_reloaded - t_reload,
                                    "queries_per_s": box["queries_per_s"], "p99_ms": box["p99_ms"],
                                    "generation": stats["generation"]}
        log(f"[serving] POST /reload under {clients} clients: {len(under_load)} answers, all 200 "
            f"({len(before)} before the swap held to generation 1, {len(after)} after it to generation 2), "
            f"reload {t_reloaded - t_reload:.3f} s, generation {stats['generation']} on {smi}")
        out.update({"warm_start_s": warm_s, "warm_start_launches": warm_launches["gj_solve"],
                    "warm_start_planned": plan, "warm_start_carried": carried, "rmse_before": rmse_before,
                    "rmse_after": rmse_after})

        # 4. degraded: a third instance whose blob is gone
        models = Storage.get_model_data_models()
        third = dataclasses.replace(second, id=f"{second.id}-noblob", start_time=dt.datetime.now(dt.timezone.utc))
        Storage.get_meta_data_engine_instances().insert(third)
        models.insert(dataclasses.replace(models.get(second.id), id=third.id))
        models.delete(third.id)
        req = urllib.request.Request(url + "/reload", data=b"{}", headers={"Content-Type": "application/json"},
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=60)
            raise RuntimeError("serving: /reload to an instance without a blob answered 200")
        except urllib.error.HTTPError as e:
            degraded = (e.code, json.loads(e.read()), e.headers.get("Retry-After"))
        _, root = _http_json(url + "/")
        if degraded[0] != 503 or degraded[1].get("degraded") is not True or not root["degraded"]:
            raise RuntimeError(f"serving: the broken reload answered {degraded}, GET / {root}")
        still = run_load(url, load_picks(4 * clients, len(user_index), seed=34), user_index, clients, k)
        check_answers("serving degraded", ok_answers("serving degraded", still), U2, V2, new_model.item_index, k)
        out["degraded"] = {"status": degraded[0], "retry_after": degraded[2], "queries": still["queries"],
                           "last_reload_error": root["lastReloadError"]}
        log(f"[serving] degraded: POST /reload answered {degraded[0]} degraded={degraded[1]['degraded']} "
            f"(Retry-After {degraded[2]}); GET / degraded={root['degraded']}; {still['queries']} queries "
            f"answered 200 from generation 2")

        # feedback: one predict event for each answered (computed) query
        deadline = time.perf_counter() + 60
        while True:
            _, stats = _http_json(url + "/stats.json")
            fb = stats["feedback"]
            if fb["sent"] + fb["failed"] + fb["dropped"] >= stats["queryCount"] or time.perf_counter() > deadline:
                break
            time.sleep(0.1)
        answered_ids = {payload["prId"] for rec in (batched, zipf, box, still) for _, _, payload, _, _ in rec["records"]}
        cols = Storage.get_p_events().find_columns(fb_app.id, entity_type="pio_pr", event_names=["predict"])
        stored_ids = set(cols.entity_vocab[cols.entity_code].tolist())
        if fb["failed"] or fb["dropped"] or fb["sent"] != stats["queryCount"] or len(cols) != stats["queryCount"] or (
                stored_ids != answered_ids):
            raise RuntimeError(f"serving: feedback {fb}, queryCount {stats['queryCount']}, {len(cols)} predict "
                               f"events stored, {len(answered_ids)} answered prIds, "
                               f"{len(stored_ids ^ answered_ids)} differ")
        out["feedback"] = {**fb, "query_count": stats["queryCount"], "predict_events": len(cols)}
        log(f"[serving] feedback: {len(cols)} predict events in the event server's store (app "
            f"{SRV_FEEDBACK_APP}) = queryCount "
            f"{stats['queryCount']} (the answers' {len(answered_ids)} prIds; the rest were cache hits)")

        # 5. pio undeploy
        t0 = time.perf_counter()
        console_ok("serving undeploy", ["undeploy", "--port", str(port)])
        rc = dep_proc.wait(timeout=10)
        out["undeploy_s"] = time.perf_counter() - t0
        dep_proc = None
        if rc != 0:
            raise RuntimeError(f"serving: the deploy exited {rc} after pio undeploy")
        log(f"[serving] pio undeploy: the deploy exited 0 in {out['undeploy_s']:.3f} s")
    finally:
        for p in (dep_proc, es_proc):
            if p is not None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)

    # 6. pio batchpredict of stored users
    picks = load_picks(batchpredict_n, len(td.user_index), seed=35)
    query_file = base / "bp-queries.json"
    write_ndjson(query_file, ({"user": td.user_index.inverse(u), "num": k} for u in picks.tolist()))
    bp_s = console_ok("serving batchpredict", ["batchpredict", "--engine-json", str(warm_json), "--input",
                                               str(query_file), "--output", str(base / "bp-out.json"),
                                               "--engine-instance-id", second.id, *dev_args])
    with open(base / "bp-out.json") as f:
        lines = [json.loads(line) for line in f]
    if len(lines) != batchpredict_n:
        raise RuntimeError(f"serving: batchpredict wrote {len(lines)} lines for {batchpredict_n} queries")
    sample = np.random.default_rng(36).choice(batchpredict_n, min(SRV_BATCHPREDICT_SAMPLE, batchpredict_n),
                                              replace=False)
    check_answers("serving batchpredict", [(new_model.user_index[lines[j]["query"]["user"]], lines[j]["prediction"])
                                           for j in sample.tolist()], U2, V2, new_model.item_index, k)
    out["batchpredict"] = {"queries": batchpredict_n, "wall_s": bp_s, "queries_per_s": batchpredict_n / bp_s,
                           "sample_checked": int(sample.size)}
    log(f"[serving] pio batchpredict: {batchpredict_n} queries in {bp_s:.3f} s ({batchpredict_n / bp_s:.1f} "
        f"queries/s, the load included); {sample.size} sampled lines equal float64 numpy on {smi}")

    # 7. in process: ``SRV_RELOADS`` reloads, the card's allocated memory flat
    service = QueryService(load_engine_variant(str(warm_json)), local_context(device), instance_id=second.id)
    try:
        if device.type == "cuda":
            tf32 = service.run_on_device(lambda: torch.backends.cuda.matmul.allow_tf32)
            if tf32:
                raise RuntimeError("serving: TF32 is on on the serving thread")
            torch.cuda.synchronize(device)
        first_mem = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        for _ in range(SRV_RELOADS):
            service.reload()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        last_mem = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        status, payload = service.handle_query({"user": new_model.user_index.inverse(0), "num": k})
        check_answers("serving in-process", [(0, payload)], U2, V2, new_model.item_index, k)
    finally:
        service.close()
    if service.model_generation != 1 + SRV_RELOADS or abs(last_mem - first_mem) > 1 << 20:
        raise RuntimeError(f"serving: after {SRV_RELOADS} reloads generation {service.model_generation}, "
                           f"memory_allocated {first_mem} -> {last_mem}")
    out["reloads"] = {"count": SRV_RELOADS, "memory_allocated_first": first_mem, "memory_allocated_last": last_mem,
                      "tf32_on_serving_thread": False if device.type == "cuda" else None}
    log(f"[serving] in-process QueryService: {SRV_RELOADS} reloads, torch.cuda.memory_allocated {first_mem} "
        f"after the first load, {last_mem} after the last (flat within 1 MiB); TF32 off on the serving thread "
        f"on {smi}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[serving] {json.dumps(out)}")
    return out


def phase_tt_serving(device, ctx: dict, clients: int, per_client: int, k: int, smi: str) -> dict:
    """``pio deploy --batching --pin-model`` of the Two-Tower quickstart's
    instance: ``clients`` x ``per_client`` queries, each held to the
    float64 numpy top-``k`` without the user's seen items."""
    model = ctx["model"]
    proc, port = start_console_server(
        "tt-serving", ctx["base"],
        ["deploy", "--engine-json", str(ctx["engine_json"]), *ctx["dev_args"], "--batching", "--pin-model",
         "--batch-warmup-query", json.dumps({"user": model.user_index.inverse(0), "num": k})],
        ctx["base"] / "deploy-tt-srv.stderr", QS_DEPLOY_TIMEOUT_S)
    try:
        url = f"http://127.0.0.1:{port}"
        load = run_load(url, load_picks(clients * per_client, len(model.user_index), seed=37), model.user_index,
                        clients, k)
        _, stats = _http_json(url + "/stats.json")
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    checked = check_answers("tt-serving", ok_answers("tt-serving", load), model.user_vecs.astype(np.float64),
                            model.item_vecs.astype(np.float64), model.item_index, k, model.seen, model.user_index)
    pinned = (len(model.user_index) + len(model.item_index)) * model.user_vecs.shape[1] * 4
    if stats["batcher"]["bucketMisses"] != 0 or stats["cache"]["bytesPinned"] != pinned:
        raise RuntimeError(f"tt-serving: bucketMisses {stats['batcher']['bucketMisses']}, bytesPinned "
                           f"{stats['cache']['bytesPinned']} (tables {pinned})")
    load_line("Two-Tower batched+pinned deploy, uniform users", load, clients, smi)
    out = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
    out.update({"checked": checked, "batch_size_hist": stats["batcher"]["batchSizeHist"],
                "bytes_pinned": stats["cache"]["bytesPinned"], "card": smi})
    log(f"[serving] two-tower: {json.dumps(out)}")
    return out


# -------------------------------------------------------------- 10. online
def bulk_post(es_url: str, key: str, objs: list) -> int:
    """``objs`` as one NDJSON ``POST /events/bulk.json``; every line must be
    stored. Returns the count stored."""
    status, body = _post_bytes(f"{es_url}/events/bulk.json?accessKey={key}",
                               b"".join((json.dumps(o) + "\n").encode() for o in objs), "application/x-ndjson")
    summary = json.loads(body.splitlines()[-1])
    if status != 200 or not summary.get("ok") or summary["stored"] != len(objs):
        raise RuntimeError(f"online: the bulk POST of {len(objs)} events answered {status} {summary}")
    return int(summary["stored"])


def rate_events(rng, users, items, n: int, user: str | None = None, event: str = "rate") -> list:
    """``n`` events of random stored users (or ``user``) on random stored
    items, event-server shaped, with a rating for ``rate``."""
    out = []
    for _ in range(n):
        obj = {"event": event, "entityType": "user",
               "entityId": user if user is not None else users[int(rng.integers(0, len(users)))],
               "targetEntityType": "item", "targetEntityId": items[int(rng.integers(0, len(items)))]}
        if event == "rate":
            obj["properties"] = {"rating": float(rng.integers(1, 6))}
        out.append(obj)
    return out


def online_traffic(url: str, es_url: str, key: str, user_index, item_index, probe: bool, seed: int) -> dict:
    """``bench.py::_bench_online_freshness``'s phase against a deploy at
    ``url``: ``ONL_CLIENTS`` keep-alive clients of top-10 queries to
    uniform stored users and ``ONL_INGEST_EPS`` events/s through the event
    server's bulk route for ``ONL_PHASE_S`` s; with ``probe``, about every
    second ``ONL_PROBE_EVENTS`` rate events of a new user and its query
    polled every ``ONL_PROBE_POLL_S`` s until the answer is non-empty
    (``ONL_PROBE_TIMEOUT_S`` at most; a probe started runs to its end)."""
    users, items = user_index.keys(), item_index.keys()
    stop = threading.Event()
    errors: list = []
    counts = {"ingested": 0, "probe_events": 0}
    fresh: list = []
    timeouts: list = []
    box: dict = {}

    def guarded(fn):
        def run() -> None:
            try:
                fn()
            except Exception as e:  # reported below; a failed thread fails the phase
                errors.append(repr(e))
        return run

    def ingest() -> None:
        rng = np.random.default_rng(seed * 1000 + 501)
        chunk = max(1, int(ONL_INGEST_EPS * ONL_INGEST_EVERY_S))
        due = time.perf_counter()
        while True:
            due += ONL_INGEST_EVERY_S  # on a fixed clock: a slow POST does not lower the rate
            if stop.wait(max(0.0, due - time.perf_counter())):
                break
            counts["ingested"] += bulk_post(es_url, key, rate_events(rng, users, items, chunk))

    def prober() -> None:
        rng = np.random.default_rng(seed * 1000 + 502)
        n = 0
        while not stop.is_set():
            n += 1
            uid = f"online-fresh-{seed}-{n}"
            t0 = time.perf_counter()
            counts["probe_events"] += bulk_post(es_url, key, rate_events(rng, users, items, ONL_PROBE_EVENTS, uid))
            while True:
                status, body = _http_json(url + "/queries.json", {"user": uid, "num": TOP_K})
                if status != 200:
                    raise RuntimeError(f"online: the probe's query answered {status} {body}")
                if body.get("itemScores"):
                    fresh.append(time.perf_counter() - t0)
                    break
                if time.perf_counter() - t0 > ONL_PROBE_TIMEOUT_S:
                    timeouts.append(uid)
                    break
                time.sleep(ONL_PROBE_POLL_S)
            stop.wait(max(0.0, ONL_PROBE_EVERY_S - (time.perf_counter() - t0)))

    threads = [threading.Thread(target=guarded(lambda: box.update(run_load(
        url, np.zeros(0, np.int64), user_index, ONL_CLIENTS, TOP_K, stop=stop, seed=seed))), daemon=True),
               threading.Thread(target=guarded(ingest), daemon=True)]
    if probe:
        threads.append(threading.Thread(target=guarded(prober), daemon=True))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(ONL_PHASE_S)
    stop.set()
    for t in threads:
        t.join(timeout=ONL_PROBE_TIMEOUT_S + 60)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"online: {len(errors)} traffic threads failed: {errors[:3]}")
    ok_answers("online queries", box)
    out = {key_: box[key_] for key_ in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
    out.update({"ingested": counts["ingested"], "ingest_events_per_s": counts["ingested"] / wall,
                "probe_events": counts["probe_events"]})
    if probe:
        out["freshness"] = {"samples": len(fresh), "timeouts": len(timeouts),
                            "p50_s": float(np.percentile(fresh, 50)) if fresh else None,
                            "max_s": max(fresh) if fresh else None}
    return out


def fold_reference(model, side: str, ent: str, reg: float, prior_weight: float, own: np.ndarray,
                   opp: np.ndarray) -> np.ndarray:
    """The float64 numpy solve of the anchored normal equations a fold of
    ``ent`` (``side`` "users" or "items") solves: its online history
    (``model._pio_online``) against the opposite table ``opp``, anchored to
    its row of ``own`` when the model knows it (``online/foldin.py``)."""
    own_index, opp_index = ((model.user_index, model.item_index) if side == "users"
                            else (model.item_index, model.user_index))
    pairs = [(opp_index[o], r) for o, (_, r) in model._pio_online[side][ent].items() if o in opp_index]
    pairs = pairs[-MAX_WIDTH:]
    Y = opp[[ix for ix, _ in pairs]]
    r = np.asarray([v for _, v in pairs], np.float64)
    row = own_index.get(ent)
    w = prior_weight if row is not None and row < own.shape[0] else 0.0
    prior = own[row] if w else np.zeros(own.shape[1])
    A = Y.T @ Y + (reg * max(len(pairs), 1) + w) * np.eye(own.shape[1])
    return np.linalg.solve(A, Y.T @ r + w * prior)


def phase_online(device, ctx: dict, smi: str) -> dict:
    """``pio deploy`` against ``pio deploy --online --online-interval-s 0.25
    --online-batch 2048`` of the workflow's warm instance under the same
    load and ingest (:func:`online_traffic`), the online one with the
    freshness probe; its ``eventsSeen`` must equal the events the event
    server stored during its run. Then, in process, the same events fold
    into a ``QueryService`` of the instance through the template's hooks
    (``ONL_BATCH`` a fold): 32 folded rows of the last fold held to the
    float64 numpy solve of their normal equations over the tables read
    back from the card, 64 moved users' top-10s to float64 numpy over the
    live tables, and the card's allocated memory grown by at most the
    appended rows and 1 MiB."""
    t_phase = time.perf_counter()
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    first = ctx["instance"]
    stored = stored_model(first.id)
    user_index, item_index = stored.user_index, stored.item_index
    rank = stored.user_factors.shape[1]
    del stored
    app = Storage.get_meta_data_apps().get_by_name(WF_APP)
    (access_key,) = Storage.get_meta_data_access_keys().get_by_appid(app.id)
    deploy = ["deploy", "--engine-json", str(engine_json), "--engine-instance-id", first.id, *dev_args]
    online_flags = ["--online", "--online-interval-s", str(ONL_INTERVAL_S), "--online-batch", str(ONL_BATCH)]
    out: dict = {"users": len(user_index), "items": len(item_index), "rank": rank, "clients": ONL_CLIENTS,
                 "phase_seconds": ONL_PHASE_S, "target_ingest_eps": ONL_INGEST_EPS, "card": smi}
    es_proc = dep_proc = None
    try:
        es_proc, es_port = start_console_server("online", base, ["eventserver"], base / "es-online.stderr",
                                                WF_SERVER_TIMEOUT_S)
        es_url = f"http://127.0.0.1:{es_port}"
        runs = {}
        for label, flags in (("baseline", []), ("online", online_flags)):
            if label == "online":
                # anchored now, as the deploy's follower is: it sees exactly
                # the events of the online run
                follower = TailFollower(WF_APP, state_dir=str(base / "online-check"))
            t0 = time.perf_counter()
            dep_proc, port = start_console_server("online", base, deploy + flags, base / f"deploy-{label}.stderr",
                                                  QS_DEPLOY_TIMEOUT_S)
            start_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            warm = 0
            for u in range(10):
                _http_json(url + "/queries.json", {"user": user_index.inverse(u), "num": TOP_K})
            if label == "online":
                warm = bulk_post(es_url, access_key.key, rate_events(
                    np.random.default_rng(40), user_index.keys(), item_index.keys(), 4, "online-warm"))
                status, body = _http_json(url + "/online/fold.json", {})
                if status != 200:
                    raise RuntimeError(f"online: the warm-up fold answered {status} {body}")
            run = online_traffic(url, es_url, access_key.key, user_index, item_index, label == "online",
                                 seed=41 if label == "baseline" else 42)
            run["deploy_start_s"] = start_s
            if label == "online":
                accepted = warm + run["ingested"] + run["probe_events"]
                deadline = time.perf_counter() + ONL_CATCH_UP_S
                while True:
                    _, stats = _http_json(url + "/stats.json")
                    if stats["online"]["eventsSeen"] >= accepted or time.perf_counter() > deadline:
                        break
                    time.sleep(0.1)
                _, root = _http_json(url + "/")
                onl = stats["online"]
                run.update({"accepted": accepted, "events_seen": onl["eventsSeen"], "folds": onl["folds"],
                            "updates_applied": onl["updatesApplied"], "fold_ms": onl["foldMs"],
                            "event_to_visible_s": onl["eventToVisibleSeconds"], "watermark": onl["watermark"],
                            "last_error": onl["lastError"], "status_online": root["online"]})
            dep_proc.send_signal(signal.SIGTERM)
            rc = dep_proc.wait(timeout=60)
            dep_proc = None
            if rc != 0:
                raise RuntimeError(f"online: the {label} deploy exited {rc} on SIGTERM")
            runs[label] = run
            log(f"[online] {label} deploy: started in {start_s:.3f} s; {run['queries']} queries from "
                f"{ONL_CLIENTS} keep-alive clients, {run['queries_per_s']:.1f} queries/s, p50 {run['p50_ms']:.3f} "
                f"ms, p99 {run['p99_ms']:.3f} ms, all 200; {run['ingested']} events ingested "
                f"({run['ingest_events_per_s']:.1f} events/s) through /events/bulk.json on {smi}")
    finally:
        for p in (dep_proc, es_proc):
            if p is not None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)
    online = runs["online"]
    fr = online["freshness"]
    if fr["timeouts"] or not fr["samples"]:
        raise RuntimeError(f"online: freshness probes {fr}")
    if online["events_seen"] != online["accepted"] or online["last_error"] or online["status_online"] is not True:
        raise RuntimeError(f"online: eventsSeen {online['events_seen']}, the event server stored "
                           f"{online['accepted']} during the run; lastError {online['last_error']}")
    p99_ratio = online["p99_ms"] / runs["baseline"]["p99_ms"]
    log(f"[online] --online run: freshness p50 {fr['p50_s']:.3f} s, max {fr['max_s']:.3f} s over {fr['samples']} "
        f"probes, 0 timeouts; eventsSeen {online['events_seen']} = {online['accepted']} events stored during "
        f"the run; {online['folds']} folds, foldMs p50 {online['fold_ms']['p50']} p95 {online['fold_ms']['p95']}, "
        f"eventToVisibleSeconds p50 {online['event_to_visible_s']['p50']} p95 "
        f"{online['event_to_visible_s']['p95']}; p99 online/baseline {p99_ratio:.3f}; deploy start "
        f"{online['deploy_start_s']:.3f} s with --online, {runs['baseline']['deploy_start_s']:.3f} s without, "
        f"on {smi}")

    # in process: the same events folded through the hooks, checked
    events = follower.poll()
    if len(events) != online["accepted"]:
        raise RuntimeError(f"online: the store holds {len(events)} events of the online run, the event server "
                           f"stored {online['accepted']}")
    deltas = to_deltas(events)
    ctx["online_deltas"] = deltas  # the [ann] phase folds them again
    ds_params = json.loads(first.datasource_params)
    config = OnlineConfig(enabled=True, interval_s=ONL_INTERVAL_S, batch_size=ONL_BATCH)
    service = QueryService(load_engine_variant(str(engine_json)), local_context(device), instance_id=first.id)
    try:
        (algo, model), = service.snapshot_pairs()[0]
        generation = service.model_generation
        n_users, n_items = len(model.user_index), len(model.item_index)
        def read_back(table) -> np.ndarray:
            """A live table as float64 on the host, read on the device thread."""
            return service.run_on_device(
                lambda: (table.cpu().numpy() if isinstance(table, torch.Tensor) else np.asarray(table)).astype(
                    np.float64))

        reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mem_first = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        moved: list = []
        fold_ms: list = []
        worst = 0.0
        for lo in range(0, len(deltas), ONL_BATCH):
            t0 = time.perf_counter()
            upd = algo.online_foldin(model, deltas[lo:lo + ONL_BATCH], ds_params, config, run=service.run_on_device)
            fold_ms.append((time.perf_counter() - t0) * 1e3)
            if lo + ONL_BATCH >= len(deltas):
                # the last fold's rows against float64 numpy over the tables
                # read back from the card (the apply below has not run yet)
                U, V = read_back(model.user_factors), read_back(model.item_factors)
                rng = np.random.default_rng(43)
                for side, ids, rows, own, opp in (("users", upd.user_ids, upd.user_rows, U, V),
                                                  ("items", upd.item_ids, upd.item_rows, V, U)):
                    for j in rng.choice(len(ids), min(ONL_CHECK_ROWS // 2, len(ids)), replace=False).tolist():
                        ref = fold_reference(model, side, ids[j], algo.params.lambda_, config.prior_weight, own, opp)
                        err = float(np.linalg.norm(rows[j] - ref) / np.linalg.norm(ref))
                        worst = max(worst, err)
                        if err > ONL_FOLD_RTOL:
                            raise RuntimeError(f"online: the fold of {side[:-1]} {ids[j]} is {err:.3g} from "
                                               f"float64 numpy (limit {ONL_FOLD_RTOL:g})")
            res = service.apply_online_update([(0, upd)], generation=generation)
            if not res["applied"]:
                raise RuntimeError(f"online: the in-process fold was not applied: {res}")
            moved += list(upd.user_ids)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        mem_last = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        added = len(model.user_index) - n_users + len(model.item_index) - n_items
        if mem_last - mem_first > added * rank * 4 + (1 << 20):
            raise RuntimeError(f"online: memory_allocated {mem_first} -> {mem_last} for {added} appended rows")
        U, V = read_back(model.user_factors), read_back(model.item_factors)
        picks = np.random.default_rng(44).choice(sorted(set(moved)), ONL_CHECK_USERS, replace=False).tolist()
        answers = [(model.user_index[u], service.handle_query({"user": u, "num": TOP_K})[1]) for u in picks]
        check_answers("online moved users", answers, U, V, model.item_index, TOP_K)
        launches = read_launch_counts()
        # the fold's solve: the error check's host sync (cholesky) against
        # none (cholesky_ex), each read back, at one chunk's shape
        A, b = spd_batch(128, rank, 45, device)
        times = {}
        for name, fn in (("cholesky_solve", lambda: cholesky_solve(A, b).cpu()),
                         ("cholesky_solve_ex", lambda: [t.cpu() for t in cholesky_solve_ex(A, b)])):
            fn()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            times[name] = (time.perf_counter() - t0) * 1e3 / 50
    finally:
        service.close()
    out.update({
        "baseline": runs["baseline"], "online": runs["online"], "p99_ratio": p99_ratio,
        "in_process": {"events": len(deltas), "folds": len(fold_ms), "fold_ms": fold_ms,
                       "rows_checked": ONL_CHECK_ROWS, "worst_rel_err": worst, "users_checked": len(picks),
                       "appended_rows": added, "memory_allocated_first_last": [mem_first, mem_last],
                       "launches": launches, "solve_round_trip_ms": times},
    })
    log(f"[online] in process: {len(deltas)} events folded in {len(fold_ms)} folds ({fold_ms} ms), "
        f"{ONL_CHECK_ROWS} folded rows within {worst:.3g} of float64 numpy (limit {ONL_FOLD_RTOL:g}), "
        f"{len(picks)} moved users' top-{TOP_K} equal float64 numpy over the live tables; memory_allocated "
        f"{mem_first} -> {mem_last} for {added} appended rows; launches {json.dumps(launches)}; a [128,{rank},"
        f"{rank}] solve read back in {times['cholesky_solve']:.3f} ms with the error check's sync, "
        f"{times['cholesky_solve_ex']:.3f} ms without, on {smi}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[online] {json.dumps(out)}")
    return out


def phase_tt_online(device, ctx: dict, smi: str) -> dict:
    """The Two-Tower quickstart's instance in a ``QueryService`` with
    online learning behind ``QueryServer`` (the ``--online`` deploy):
    ``ONL_TT_EVENTS`` ``view`` events through the event server's bulk route
    (``ONL_TT_NEW_USERS`` of them by users the model does not hold), the
    streaming trainer's steps awaited; every streamed row must have norm
    1 within ``ONL_TT_NORM_ATOL``, and no user's answer may hold an item
    the user just viewed."""
    t_phase = time.perf_counter()
    model = ctx["model"]
    app = Storage.get_meta_data_apps().get_by_name(TTQ_APP)
    (access_key,) = Storage.get_meta_data_access_keys().get_by_appid(app.id)
    rng = np.random.default_rng(46)
    items = model.item_index.keys()
    known = rng.choice(len(model.user_index), ONL_TT_EVENTS - ONL_TT_NEW_USERS, replace=False).tolist()
    pairs = []
    for u in [model.user_index.inverse(j) for j in known] + [f"online-u{j}" for j in range(ONL_TT_NEW_USERS)]:
        seen = model.seen.get(u, set())
        pairs.append((u, next(i for i in (items[int(k)] for k in rng.permutation(len(items))) if i not in seen)))
    es_proc = None
    streamed = {"users": set(), "items": set()}
    service = QueryService(load_engine_variant(str(ctx["engine_json"])), local_context(device),
                           instance_id=ctx["instance"],
                           online=OnlineConfig(enabled=True, interval_s=ONL_INTERVAL_S, batch_size=ONL_BATCH))
    apply = service.apply_online_update

    def recording_apply(updates, generation=None):
        res = apply(updates, generation=generation)
        if res.get("applied"):
            for _, upd in updates:
                streamed["users"].update(upd.user_ids)
                streamed["items"].update(upd.item_ids)
        return res

    service.apply_online_update = recording_apply
    try:
        es_proc, es_port = start_console_server("tt-online", ctx["base"], ["eventserver"],
                                                ctx["base"] / "es-tt-online.stderr", WF_SERVER_TIMEOUT_S)
        with QueryServer(service) as server:
            t0 = time.perf_counter()
            posted = bulk_post(f"http://127.0.0.1:{es_port}", access_key.key, [
                {"event": "view", "entityType": "user", "entityId": u, "targetEntityType": "item",
                 "targetEntityId": i} for u, i in pairs])
            deadline = time.perf_counter() + ONL_CATCH_UP_S
            while True:
                _, stats = _http_json(server.url + "/stats.json")
                trainer = stats["online"].get("trainers", {}).get("0", {})
                if (trainer.get("pairsTrained", 0) >= posted and not trainer.get("queued")) or (
                        time.perf_counter() > deadline):
                    break
                time.sleep(0.05)
            trained_s = time.perf_counter() - t0
            answers = {u: _http_json(server.url + "/queries.json", {"user": u, "num": TOP_K})[1] for u, _ in pairs}
        (_, live), = service.snapshot_pairs()[0]
        def row_norms(table, ids, index) -> np.ndarray:
            rows = torch.as_tensor(table)
            picked = rows.index_select(0, torch.as_tensor([index[x] for x in ids], device=rows.device))
            return torch.linalg.norm(picked.to(torch.float64), dim=1).cpu().numpy()

        norms = {side: service.run_on_device(row_norms, table, sorted(streamed[side]), index)
                 for side, table, index in (("users", live.user_vecs, live.user_index),
                                            ("items", live.item_vecs, live.item_index))}
    finally:
        service.close()
        if es_proc is not None:
            es_proc.send_signal(signal.SIGTERM)
            try:
                es_proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                es_proc.kill()
                es_proc.wait(timeout=30)
    onl = stats["online"]
    if posted != ONL_TT_EVENTS or trainer.get("pairsTrained") != posted or onl["eventsSeen"] != posted or (
            onl["lastError"]):
        raise RuntimeError(f"tt-online: {posted} events stored, trainer {trainer}, eventsSeen {onl['eventsSeen']}, "
                           f"lastError {onl['lastError']}")
    if not {u for u, _ in pairs} <= streamed["users"] or not {i for _, i in pairs} <= streamed["items"]:
        raise RuntimeError("tt-online: the streamed updates do not name every user and item of the events")
    worst = max(float(np.abs(n - 1.0).max()) for n in norms.values())
    if worst > ONL_TT_NORM_ATOL:
        raise RuntimeError(f"tt-online: a streamed row's norm is {worst:.3g} off 1 (limit {ONL_TT_NORM_ATOL:g})")
    leaked = [(u, i) for u, i in pairs if i in {s["item"] for s in answers[u]["itemScores"]}]
    short = [u for u, _ in pairs if len(answers[u]["itemScores"]) != TOP_K]
    if leaked or short:
        raise RuntimeError(f"tt-online: {len(leaked)} answers hold an item the user just viewed ({leaked[:3]}), "
                           f"{len(short)} answers have fewer than {TOP_K} items")
    out = {"events": posted, "new_users": ONL_TT_NEW_USERS, "steps": trainer["steps"],
           "pairs_trained": trainer["pairsTrained"], "last_loss": trainer["lastLoss"],
           "dropped_batches": trainer["droppedBatches"], "streamed_users": len(streamed["users"]),
           "streamed_items": len(streamed["items"]), "worst_norm_err": worst, "trained_s": trained_s,
           "event_to_visible_s": onl["eventToVisibleSeconds"], "phase_s": time.perf_counter() - t_phase,
           "card": smi}
    log(f"[online] two-tower: {posted} view events streamed in {trainer['steps']} trainer steps ({trained_s:.3f} s "
        f"from the POST), loss {trainer['lastLoss']}; {len(streamed['users'])} user and {len(streamed['items'])} "
        f"item rows streamed, norms within {worst:.3g} of 1; no answer holds an item its user just viewed; "
        f"on {smi}")
    log(f"[online] two-tower: {json.dumps(out)}")
    return out


# ------------------------------------------------------------- 11. ann
def clustered_rows(rng, centers: np.ndarray, n: int, unit: bool, norm_sigma: float = 0.0) -> np.ndarray:
    """``n`` rows of a Gaussian mixture around ``centers`` (spread 0.25),
    unit-norm or with lognormal(0, ``norm_sigma``) norms — the JAX
    bench's catalogs."""
    draw = centers[rng.integers(0, centers.shape[0], n)]
    draw = draw + 0.25 * rng.standard_normal((n, centers.shape[1])).astype(np.float32)
    if unit:
        draw = draw / np.linalg.norm(draw, axis=1, keepdims=True)
    elif norm_sigma:
        draw = draw * rng.lognormal(0.0, norm_sigma, n)[:, None]
    return draw.astype(np.float32)


def recall_at(truth: np.ndarray, got: np.ndarray, n: int) -> float:
    """Mean share of each row's first ``n`` true ids among its first ``n``
    retrieved ones."""
    hits = sum(len(set(t[:n].tolist()) & set(g[:n].tolist())) for t, g in zip(truth, got))
    return hits / (n * truth.shape[0])


def timed_chunks(fn, queries: torch.Tensor, chunk: int) -> tuple[dict, np.ndarray]:
    """``fn`` over ``queries`` a chunk at a time after one warm chunk, each
    dispatch timed to its ids on the host; the rate and p50/p99 a
    dispatch, and every row's ids."""
    fn(queries[:chunk])[0].cpu()
    lat, ids = [], []
    t0 = time.perf_counter()
    for lo in range(0, queries.shape[0], chunk):
        t1 = time.perf_counter()
        out = fn(queries[lo:lo + chunk])[0].cpu().numpy()
        lat.append((time.perf_counter() - t1) * 1e3)
        ids.append(out)
    wall = time.perf_counter() - t0
    p50, p99 = np.percentile(lat, [50, 99])
    return ({"queries_per_s": queries.shape[0] / wall, "dispatch_p50_ms": float(p50),
             "dispatch_p99_ms": float(p99)}, np.concatenate(ids))


def phase_ann_sweep(device, smi: str) -> dict:
    """The JAX bench's IVF sweep on the card: per catalog size, exact
    top-``ANN_K`` (``top_k_items_batch``) against the IVF probe
    (``ivf_topk_users``, nprobe ``ANN_NPROBE``) over the same query
    chunks; recall@10 below ``ANN_RECALL_BAR`` fails the run, and so does
    a full probe (``nprobe >= nlist``) whose ids or scores are not those
    of the exact top-k, to the bit. Then the int8 sweep: the two-stage
    int8 top-10 against f32 exact (recall@10 below ``QZ_RECALL_BAR``
    fails), int8-slab IVF against f32-slab IVF of one build (recall@10
    more than ``QZ_IVF_RECALL_DELTA`` below fails), the served bytes
    (less than ``QZ_BYTES_RATIO`` times smaller fails)."""
    from predictionio_tpu_torch.ops import ivf, quant
    from predictionio_tpu_torch.ops.als import top_k_items_batch

    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    uidx = torch.arange(ANN_CHUNK, device=device)
    sweep = []
    for n_items in ANN_SIZES:
        centers = rng.standard_normal((4 * ivf.auto_nlist(n_items), ANN_DIM)).astype(np.float32)
        items = torch.as_tensor(clustered_rows(rng, centers, n_items, unit=True), device=device)
        queries = torch.as_tensor(clustered_rows(rng, centers, ANN_QUERIES, unit=True), device=device)
        index, info = ivf.build_ivf(items, nlist=0, seed=0, iters=8, device=device)
        exact_stats, exact_ids = timed_chunks(lambda q: top_k_items_batch(uidx, q, items, ANN_K), queries, ANN_CHUNK)
        ann_stats, ann_ids = timed_chunks(
            lambda q: ivf.ivf_topk_users(uidx, q, index, ANN_K, ANN_NPROBE), queries, ANN_CHUNK)
        # the full probe against the exact top-k, to the bit, on two chunks
        for lo in (0, ANN_QUERIES - ANN_CHUNK):
            q = queries[lo:lo + ANN_CHUNK]
            want = top_k_items_batch(uidx, q, items, ANN_K)
            for nprobe in (index.nlist, index.nlist + 7):
                got = ivf.ivf_topk_users(uidx, q, index, ANN_K, nprobe)
                if not (torch.equal(got[0].long(), want[0].long()) and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"ann: the full probe (nprobe {nprobe}, nlist {index.nlist}) at {n_items} "
                                       "items is not the exact top-k to the bit")
        point = {
            "catalog_items": n_items, "nlist": index.nlist, "nprobe": ANN_NPROBE, "slab_width": index.slab_width,
            "build_s": info["buildSeconds"], "bytes_index": info["bytesIndex"],
            "fraction_of_catalog_scored": min(1.0, ANN_NPROBE * index.slab_width / n_items),
            "exact": exact_stats, "ivf": ann_stats,
            "speedup": ann_stats["queries_per_s"] / exact_stats["queries_per_s"],
            "recall_at_10": recall_at(exact_ids, ann_ids, 10), "recall_at_100": recall_at(exact_ids, ann_ids, 100),
            "full_probe_bit_equal": True,
        }
        del index, items, queries
        sweep.append(point)
        log(f"[ann] ivf {n_items} items: nlist {point['nlist']}, slab width {point['slab_width']}, built in "
            f"{point['build_s']} s; exact {exact_stats['queries_per_s']:.1f} queries/s (dispatch p50 "
            f"{exact_stats['dispatch_p50_ms']:.3f} p99 {exact_stats['dispatch_p99_ms']:.3f} ms), ivf nprobe "
            f"{ANN_NPROBE} {ann_stats['queries_per_s']:.1f} queries/s (p50 {ann_stats['dispatch_p50_ms']:.3f} p99 "
            f"{ann_stats['dispatch_p99_ms']:.3f} ms), speedup {point['speedup']:.3f}; recall@10 "
            f"{point['recall_at_10']:.4f}, @100 {point['recall_at_100']:.4f}; {point['fraction_of_catalog_scored']:.4f}"
            f" of the catalog scored; full probe bit-equal to exact; on {smi}")
        if point["recall_at_10"] < ANN_RECALL_BAR:
            raise RuntimeError(f"ann: recall@10 {point['recall_at_10']:.4f} < {ANN_RECALL_BAR} at {n_items} items")

    rng = np.random.default_rng(13)
    uidx = torch.arange(ANN_CHUNK, device=device)
    qz = []
    for n_items in ANN_SIZES:
        centers = rng.standard_normal((4 * ivf.auto_nlist(n_items), ANN_DIM)).astype(np.float32)
        items_np = clustered_rows(rng, centers, n_items, unit=False, norm_sigma=QZ_NORM_SIGMA)
        items = torch.as_tensor(items_np, device=device)
        queries = torch.as_tensor(clustered_rows(rng, centers, QZ_QUERIES, unit=False), device=device)
        exact_stats, exact_ids = timed_chunks(lambda q: top_k_items_batch(uidx, q, items, QZ_K), queries, ANN_CHUNK)
        table = quant.quantize_table(items_np, device)
        kp = quant.overfetch(QZ_K, n_items)
        q_stats, q_ids = timed_chunks(
            lambda q: quant.quantized_topk_batch(q, table.codes, table.scales, QZ_K, kp, n_items), queries, ANN_CHUNK)
        idx_f, info_f = ivf.build_ivf(items, nlist=0, seed=0, iters=8, device=device)
        idx_q, info_q = ivf.build_ivf(items, nlist=0, seed=0, iters=8, quantize=True, device=device, table=table)
        f_stats, f_ids = timed_chunks(lambda q: ivf.ivf_topk_batch(q, idx_f, QZ_K, ANN_NPROBE), queries, ANN_CHUNK)
        i_stats, i_ids = timed_chunks(lambda q: ivf.ivf_topk_batch(q, idx_q, QZ_K, ANN_NPROBE), queries, ANN_CHUNK)
        point = {
            "catalog_items": n_items, "nlist": idx_f.nlist, "nprobe": ANN_NPROBE, "overfetch": kp,
            "exact_f32": exact_stats, "exact_int8": q_stats,
            "recall_at_10_exact_int8": recall_at(exact_ids, q_ids, QZ_K),
            "bytes_f32": int(items_np.nbytes), "bytes_int8": table.nbytes_codes + table.nbytes_scales,
            "ivf_f32": dict(f_stats, recall_at_10=recall_at(exact_ids, f_ids, QZ_K), bytes_index=info_f["bytesIndex"],
                            build_s=info_f["buildSeconds"]),
            "ivf_int8": dict(i_stats, recall_at_10=recall_at(exact_ids, i_ids, QZ_K), bytes_index=info_q["bytesIndex"],
                             build_s=info_q["buildSeconds"]),
        }
        point["bytes_ratio"] = point["bytes_f32"] / point["bytes_int8"]
        del idx_f, idx_q, table, items, queries
        qz.append(point)
        log(f"[ann] int8 {n_items} items: exact f32 {exact_stats['queries_per_s']:.1f} queries/s, two-stage int8 "
            f"{q_stats['queries_per_s']:.1f} queries/s (over-fetch {kp}) recall@10 "
            f"{point['recall_at_10_exact_int8']:.4f}; ivf f32 slabs {f_stats['queries_per_s']:.1f} queries/s recall@10 "
            f"{point['ivf_f32']['recall_at_10']:.4f}, int8 slabs {i_stats['queries_per_s']:.1f} queries/s recall@10 "
            f"{point['ivf_int8']['recall_at_10']:.4f}; table bytes {point['bytes_f32']} f32 / {point['bytes_int8']} "
            f"int8 = {point['bytes_ratio']:.3f}, index bytes {point['ivf_f32']['bytes_index']} / "
            f"{point['ivf_int8']['bytes_index']}; on {smi}")
        delta = point["ivf_f32"]["recall_at_10"] - point["ivf_int8"]["recall_at_10"]
        if (point["recall_at_10_exact_int8"] < QZ_RECALL_BAR or delta > QZ_IVF_RECALL_DELTA
                or point["bytes_ratio"] < QZ_BYTES_RATIO
                or point["ivf_f32"]["bytes_index"] <= 3.0 * point["ivf_int8"]["bytes_index"]):
            raise RuntimeError(f"ann: the int8 sweep at {n_items} items misses a bar: {point}")
    return {"ivf": sweep, "int8": qz, "phase_s": time.perf_counter() - t_phase, "card": smi}


def recall_vs_float64(answers: list, U64: np.ndarray, V64: np.ndarray, item_index, k: int,
                      seen: dict | None = None, user_index=None) -> float:
    """recall@``k`` of ``(user row, payload)`` answers against the float64
    numpy top-``k`` of ``U64``/``V64`` (without the user's ``seen``
    items)."""
    hits = 0
    for lo in range(0, len(answers), 512):
        part = answers[lo:lo + 512]
        S = U64[[u for u, _ in part]] @ V64.T
        for (uidx, payload), scores in zip(part, S):
            if seen is not None:
                drop = [item_index[i] for i in seen.get(user_index.inverse(uidx), ())]
                scores = scores.copy()
                scores[drop] = -np.inf
            top = set(np.argpartition(-scores, k - 1)[:k].tolist())
            hits += len(top & {item_index[s["item"]] for s in payload["itemScores"]})
    return hits / (k * len(answers))


def phase_ann(device, ctx: dict, smi: str) -> dict:
    """``pio deploy --ann`` and ``--quantize int8`` on the workflow's warm
    instance (``phase_serving``'s 32 x 25 uniform top-10 load on each of
    ``--ann --ann-nprobe 8``, ``--quantize int8`` and ``--ann --quantize
    int8 --batching --pin-model``; every answer 200; int8 ``bytesPinned``
    must be the codes and scales), then in process: a full-probe
    ``QueryService`` (``nprobe >= nlist``) against the exact one on 1,000
    users' ``handle_batch`` (equal to the bit); the ``[online]`` phase's
    events folded into an ``--ann --quantize int8`` service (touched int8
    rows ``quantize_table_host`` of the folded rows, ``itemsFolded`` above
    0, every item in the index once, full-probe answers equal to float64
    numpy over the live tables); the incremental index's recall@10 within
    ``ANN_INC_RECALL_DELTA`` of a rebuild on the same factors; three
    ``/reload``s with ``--ann`` and ``memory_allocated`` flat within 1 MiB."""
    from predictionio_tpu_torch.ops import ivf, quant
    from predictionio_tpu_torch.serving import AnnConfig, CacheConfig

    t_phase = time.perf_counter()
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    first = ctx["instance"]
    model = stored_model(first.id)
    user_index, item_index = model.user_index, model.item_index
    U64 = np.asarray(model.user_factors, np.float64)
    V64 = np.asarray(model.item_factors, np.float64)
    rank = model.user_factors.shape[1]
    del model
    n_rows = len(user_index) + len(item_index)
    int8_bytes, f32_bytes = n_rows * (rank + 4), n_rows * rank * 4
    picks = load_picks(SRV_CLIENTS * SRV_REQUESTS, len(user_index), seed=51)
    deploy = ["deploy", "--engine-json", str(engine_json), "--engine-instance-id", first.id, *dev_args]
    warm_query = json.dumps({"user": user_index.inverse(0), "num": TOP_K})
    out: dict = {"users": len(user_index), "items": len(item_index), "rank": rank, "card": smi}
    reset_launch_counts()
    deploys = {}
    for label, flags in (("ann", ["--ann", "--ann-nprobe", str(ANN_NPROBE)]),
                         ("int8", ["--quantize", "int8"]),
                         ("ann_int8_batched", ["--ann", "--quantize", "int8", "--batching", "--pin-model",
                                               "--max-batch-size", str(SRV_MAX_BATCH), "--max-batch-delay-ms",
                                               str(SRV_MAX_DELAY_MS), "--batch-warmup-query", warm_query])):
        t0 = time.perf_counter()
        proc, port = start_console_server("ann", base, deploy + flags, base / f"deploy-{label}.stderr",
                                          QS_DEPLOY_TIMEOUT_S)
        try:
            start_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            load = run_load(url, picks, user_index, SRV_CLIENTS, TOP_K)
            _, stats = _http_json(url + "/stats.json")
            _, root = _http_json(url + "/")
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        answers = ok_answers(f"ann {label}", load)
        run = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
        run.update({"deploy_start_s": start_s, "recall_at_10": recall_vs_float64(answers, U64, V64, item_index, TOP_K),
                    "ann": stats.get("ann"), "quant": stats.get("quant"), "cache": stats.get("cache"),
                    "quantize": root["quantize"], "status_ann": root["ann"]})
        if "--quantize" in flags:
            pinned = stats["cache"]["bytesPinned"]
            if pinned != int8_bytes or set(stats["cache"]["bytesByDtype"]) != {"int8", "scalesFloat32"}:
                raise RuntimeError(f"ann {label}: bytesPinned {pinned} ({stats['cache']['bytesByDtype']}), the "
                                   f"codes and scales are {int8_bytes} bytes")
        if ("--ann" in flags) != (stats.get("ann") is not None):
            raise RuntimeError(f"ann {label}: /stats.json ann section {stats.get('ann')}")
        deploys[label] = run
        log(f"[ann] deploy {' '.join(flags[:4])}: started in {start_s:.3f} s; {load['queries']} queries from "
            f"{SRV_CLIENTS} keep-alive clients, {load['queries_per_s']:.1f} queries/s, p50 {load['p50_ms']:.3f} ms, "
            f"p99 {load['p99_ms']:.3f} ms, all 200; recall@10 against float64 numpy {run['recall_at_10']:.4f}; "
            f"ann {json.dumps(stats.get('ann'))}; quant {json.dumps(stats.get('quant'))}; bytesPinned "
            f"{(stats.get('cache') or {}).get('bytesPinned')} (f32 tables {f32_bytes}); on {smi}")
    out["deploys"] = deploys

    # in process: the full probe against exact on 1,000 users' handle_batch
    variant = load_engine_variant(str(engine_json))
    bodies = [{"user": user_index.inverse(int(u)), "num": TOP_K}
              for u in np.random.default_rng(52).choice(len(user_index), ANN_FULL_PROBE_USERS, replace=False)]
    exact = QueryService(variant, local_context(device), instance_id=first.id)
    try:
        want = exact.handle_batch(bodies)
    finally:
        exact.close()
    full = QueryService(variant, local_context(device), instance_id=first.id,
                        ann=AnnConfig(enabled=True, nprobe=1 << 30))
    try:
        got = full.handle_batch(bodies)
        if got != want:
            differ = sum(1 for a, b in zip(got, want) if a != b)
            raise RuntimeError(f"ann: the full-probe service differs from the exact one on {differ} of "
                               f"{len(bodies)} answers")
        full_nlist = full.stats_json()["ann"]["nlist"]
        # ANN_RELOADS /reloads with --ann: the card's allocated memory stays flat
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(device)
        mem_first = torch.cuda.memory_allocated(device) if on_card else 0
        for _ in range(ANN_RELOADS):
            full.reload()
        if on_card:
            torch.cuda.synchronize(device)
        mem_last = torch.cuda.memory_allocated(device) if on_card else 0
    finally:
        full.close()
    if abs(mem_last - mem_first) > 1 << 20:
        raise RuntimeError(f"ann: {ANN_RELOADS} reloads moved memory_allocated {mem_first} -> {mem_last}")
    log(f"[ann] in process: a full-probe QueryService (nlist {full_nlist}) answered {len(bodies)} users' "
        f"handle_batch equal to the exact service's, to the bit; {ANN_RELOADS} reloads moved memory_allocated "
        f"{mem_first} -> {mem_last}; on {smi}")

    # in process: the [online] phase's events folded into --ann --quantize int8
    deltas = ctx["online_deltas"]
    ds_params = json.loads(first.datasource_params)
    config = OnlineConfig(enabled=True, interval_s=ONL_INTERVAL_S, batch_size=ONL_BATCH)
    service = QueryService(variant, local_context(device), instance_id=first.id,
                           cache=CacheConfig(quantize="int8"), ann=AnnConfig(enabled=True, nprobe=ANN_NPROBE))
    try:
        (algo, live), = service.snapshot_pairs()[0]
        generation = service.model_generation
        touched = {"user_factors": {}, "item_factors": {}}
        for lo in range(0, len(deltas), ONL_BATCH):
            upd = algo.online_foldin(live, deltas[lo:lo + ONL_BATCH], ds_params, config, run=service.run_on_device)
            res = service.apply_online_update([(0, upd)], generation=generation)
            if not res["applied"]:
                raise RuntimeError(f"ann: the int8 fold was not applied: {res}")
            for attr, ids, rows in (("user_factors", upd.user_ids, upd.user_rows),
                                    ("item_factors", upd.item_ids, upd.item_rows)):
                touched[attr].update(zip(ids, np.asarray(rows, np.float32)))

        def host_state():
            tables = {attr: [t.cpu().numpy() for t in (getattr(live, attr).codes, getattr(live, attr).scales)]
                      for attr in touched}
            idx = live._pio_ann.index
            return tables, idx.slab_ids.cpu().numpy(), int(idx.num_items), idx.nlist

        tables, slab_ids, capacity, nlist = service.run_on_device(host_state)
        for attr, rows_by_id in touched.items():
            index = live.user_index if attr == "user_factors" else live.item_index
            ids = list(rows_by_id)
            want_codes, want_scales = quant.quantize_table_host(np.stack([rows_by_id[e] for e in ids]))
            rows = [index[e] for e in ids]
            codes, scales = tables[attr]
            if not (np.array_equal(codes[rows], want_codes) and np.array_equal(scales[rows], want_scales)):
                raise RuntimeError(f"ann: the folded int8 rows of {attr} are not quantize_table_host of the folded "
                                   "rows")
        n_items_live = len(live.item_index)
        real = slab_ids[slab_ids < capacity]
        if real.size != n_items_live or np.unique(real).size != n_items_live:
            raise RuntimeError(f"ann: the folded index holds {real.size} lanes ({np.unique(real).size} distinct) "
                               f"for {n_items_live} items")
        ann_stats = service.stats_json()["ann"]["models"][0]
        if ann_stats["itemsFolded"] <= 0:
            raise RuntimeError(f"ann: itemsFolded {ann_stats['itemsFolded']} after the fold")
        # full-probe answers over the live int8 tables, against float64 numpy
        Uq = quant.dequantize(*tables["user_factors"]).astype(np.float64)
        Vq = quant.dequantize(*tables["item_factors"]).astype(np.float64)
        moved = sorted(touched["user_factors"])
        check = np.random.default_rng(53).choice(moved, min(ANN_FOLD_CHECK_USERS, len(moved)), replace=False)
        uidx = [live.user_index[u] for u in check.tolist()]

        def full_probe():
            ids, _ = ivf.ivf_topk_batch(live.user_factors[np.asarray(uidx)], live._pio_ann.index, TOP_K, nlist)
            return ids.cpu().numpy()

        got_ids = service.run_on_device(full_probe)
        bad = []
        for u, row in zip(uidx, got_ids):
            ref, scores = reference_top(Uq, Vq, u, TOP_K)
            if not check_ranking(row.tolist(), ref, scores):
                bad.append((u, row.tolist(), ref.tolist()))
        if bad:
            raise RuntimeError(f"ann: {len(bad)} full-probe answers after the fold differ from float64 numpy over "
                               f"the live tables: {bad[:2]}")
    finally:
        service.close()
    folded = {attr: len(v) for attr, v in touched.items()}
    log(f"[ann] in process: {len(deltas)} events folded into an --ann --quantize int8 service: {folded} rows "
        f"re-quantized as quantize_table_host of the folded rows; index {ann_stats['incrementalUpdates']} "
        f"incremental updates, itemsFolded {ann_stats['itemsFolded']}, every one of {n_items_live} items in one lane; "
        f"{len(uidx)} moved users' full-probe top-{TOP_K} equal float64 numpy over the live int8 tables; on {smi}")

    # the incremental index against a rebuild on the same factors (the JAX
    # bench's fold simulation: 5 % of the rows re-solved, 2 % new items)
    rng = np.random.default_rng(54)
    n_cat = len(item_index)
    centers = rng.standard_normal((64, rank)).astype(np.float32)
    base_items = clustered_rows(rng, centers, n_cat, unit=True)
    idx0, info0 = ivf.build_ivf(base_items, nlist=0, seed=0, iters=8, device=device)
    rt = ivf.AnnRuntime(idx0, nprobe=ANN_NPROBE, build_info=info0)
    n_upd, n_new = n_cat // 20, n_cat // 50
    upd_ids = rng.choice(n_cat, n_upd, replace=False)
    upd_vecs = clustered_rows(rng, centers, n_upd, unit=True)
    new_vecs = clustered_rows(rng, centers, n_new, unit=True)
    t0 = time.perf_counter()
    rt.update_items(upd_ids, upd_vecs, total_items=n_cat)
    rt.update_items(np.arange(n_cat, n_cat + n_new), new_vecs, total_items=n_cat + n_new)
    update_s = time.perf_counter() - t0
    final = np.concatenate([base_items, new_vecs])
    final[upd_ids] = upd_vecs
    rebuilt, _ = ivf.build_ivf(final, nlist=0, seed=0, iters=8, device=device)
    queries = clustered_rows(rng, centers, 512, unit=True)
    truth = np.argsort(-(queries.astype(np.float64) @ final.astype(np.float64).T), axis=1, kind="stable")[:, :TOP_K]
    qd = torch.as_tensor(queries, device=device)
    inc = recall_at(truth, ivf.ivf_topk_batch(qd, rt.index, TOP_K, ANN_NPROBE)[0].cpu().numpy(), TOP_K)
    full_rebuild = recall_at(truth, ivf.ivf_topk_batch(qd, rebuilt, TOP_K, ANN_NPROBE)[0].cpu().numpy(), TOP_K)
    launches = read_launch_counts()
    if abs(inc - full_rebuild) > ANN_INC_RECALL_DELTA:
        raise RuntimeError(f"ann: the incremental index's recall@10 {inc:.4f} is more than {ANN_INC_RECALL_DELTA} "
                           f"from the rebuild's {full_rebuild:.4f}")
    if any(launches.values()):
        raise RuntimeError(f"ann: launches {launches}; the retrieval path has no kernel")
    log(f"[ann] incremental index over {n_cat} items (+{n_upd} re-solved, +{n_new} new, updated in {update_s:.3f} s): "
        f"recall@10 {inc:.4f} against {full_rebuild:.4f} for a rebuild on the same factors; launches "
        f"{json.dumps(launches)}; on {smi}")
    out.update({"full_probe_users": len(bodies), "full_probe_bit_equal": True, "reload_memory": [mem_first, mem_last],
                "fold": {"events": len(deltas), "rows": folded, "items_folded": ann_stats["itemsFolded"],
                         "users_checked": len(uidx)},
                "incremental": {"items": n_cat + n_new, "updated": n_upd, "new": n_new, "update_s": update_s,
                                "recall_at_10": inc, "rebuild_recall_at_10": full_rebuild},
                "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return out


def phase_tt_ann(device, ctx: dict, smi: str) -> dict:
    """``pio deploy --ann --quantize int8`` of the Two-Tower quickstart's
    instance under ``SRV_TT_CLIENTS`` x ``SRV_TT_REQUESTS`` top-10
    queries: every answer 200, ``TOP_K`` items long and free of the user's
    seen items (the seen filter's over-fetch under both tiers)."""
    model = ctx["model"]
    proc, port = start_console_server(
        "tt-ann", ctx["base"],
        ["deploy", "--engine-json", str(ctx["engine_json"]), *ctx["dev_args"], "--ann", "--quantize", "int8"],
        ctx["base"] / "deploy-tt-ann.stderr", QS_DEPLOY_TIMEOUT_S)
    try:
        url = f"http://127.0.0.1:{port}"
        load = run_load(url, load_picks(SRV_TT_CLIENTS * SRV_TT_REQUESTS, len(model.user_index), seed=55),
                        model.user_index, SRV_TT_CLIENTS, TOP_K)
        _, stats = _http_json(url + "/stats.json")
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    answers = ok_answers("tt-ann", load)
    leaked = [u for u, payload in answers
              if {s["item"] for s in payload["itemScores"]} & set(model.seen.get(model.user_index.inverse(u), ()))]
    short = [u for u, payload in answers if len(payload["itemScores"]) != TOP_K]
    if leaked or short:
        raise RuntimeError(f"tt-ann: {len(leaked)} answers hold a seen item, {len(short)} are short")
    recall = recall_vs_float64(answers, model.user_vecs.astype(np.float64), model.item_vecs.astype(np.float64),
                               model.item_index, TOP_K, model.seen, model.user_index)
    out = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
    out.update({"recall_at_10": recall, "ann": stats["ann"], "quant": stats["quant"], "card": smi})
    log(f"[ann] two-tower --ann --quantize int8: {load['queries']} queries from {SRV_TT_CLIENTS} keep-alive clients, "
        f"{load['queries_per_s']:.1f} queries/s, p50 {load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms, all 200, "
        f"no seen item in an answer; recall@10 against float64 numpy {recall:.4f}; on {smi}")
    return out


# ----------------------------------------------------------- 11b. sharded
def sharded_meshes(device) -> list:
    """The device lists of the ``[sharded]`` phase: ``SHD_SHARDS`` mesh
    positions on the one card, then the real devices where there are two
    or more."""
    meshes = [("one card", [device] * SHD_SHARDS)]
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        meshes.append(("devices", [torch.device("cuda", i) for i in range(torch.cuda.device_count())]))
    return meshes


def timed_topk(fn, uidx: np.ndarray) -> tuple[dict, np.ndarray, np.ndarray]:
    """``bench.py``'s ``timed()``: ``fn`` on one warm chunk, then on every
    ``SHD_CHUNK``-query chunk of ``uidx``, each chunk's ids and scores to
    the host; queries/s, and every row's ids and scores."""
    fn(uidx[:SHD_CHUNK])[0].cpu()
    ids, scores = [], []
    t0 = time.perf_counter()
    for lo in range(0, len(uidx), SHD_CHUNK):
        i, s = fn(uidx[lo:lo + SHD_CHUNK])
        ids.append(i.cpu().numpy().astype(np.int64))
        scores.append(s.cpu().numpy())
    wall = time.perf_counter() - t0
    return {"queries_per_s": len(uidx) / wall, "wall_s": wall}, np.concatenate(ids), np.concatenate(scores)


def bit_differences(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """How many float32 entries of ``a`` and ``b`` differ in their bits, and
    the most units in the last place between two of them."""
    ai, bi = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    differ = ai != bi
    return int(differ.sum()), int(np.abs(ai - bi)[differ].max()) if differ.any() else 0


def phase_sharded_sweep(device, smi: str) -> dict:
    """The JAX bench's sharded sweep on the card (``SHD_*``): at each size
    the tables through the template's ``shard_model_for_serving`` and
    ``quantize_model_for_serving(shard=True)`` hooks, each mesh position's
    bytes against ``sharded_table_bytes``; sharded exact against the
    replicated ``top_k_items_batch`` (ids equal, scores within rtol 1e-6;
    the bit differences counted), sharded int8 against replicated int8
    (ids and scores to the bit), sharded IVF at nprobe ``ANN_NPROBE``
    against the unsharded probe (ids) and at ``nprobe = nlist`` against
    the replicated exact answer (to the bit); queries/s of each. The
    plain ``[B,K]@[K,I]`` GEMM is compared with its per-shard products on
    the first chunk: the input of the finding ``ops/als.score_rows``
    answers. BENCH_r01's table is printed as shape math."""
    from predictionio_tpu_torch.ops import ivf, quant
    from predictionio_tpu_torch.ops.als import top_k_items_batch
    from predictionio_tpu_torch.parallel import sharding
    from predictionio_tpu_torch.templates.recommendation.engine import ALSAlgorithmParams, ALSModel

    t_phase = time.perf_counter()
    repl_oom = sharding.table_bytes(SHD_OOM_ROWS, SHD_RANK)
    shard_oom = sharding.sharded_table_bytes(SHD_OOM_ROWS, SHD_RANK, SHD_SHARDS)
    oom = {"rows": SHD_OOM_ROWS, "rank": SHD_RANK, "replicated_gib": repl_oom / 2**30,
           "per_device_gib_8way": shard_oom / 2**30, "replicated_fits_17gb": 2 * repl_oom < SHD_OOM_HBM,
           "sharded_fits_17gb": 2 * shard_oom < SHD_OOM_HBM}
    log(f"[sharded] BENCH_r01 shape math (not allocated): f32[{SHD_OOM_ROWS},{SHD_RANK}] is "
        f"{oom['replicated_gib']:.3f} GiB replicated, {oom['per_device_gib_8way']:.3f} GiB a device 8-way; two "
        f"tables fit 17 GiB replicated: {oom['replicated_fits_17gb']}, sharded: {oom['sharded_fits_17gb']}")
    algo = ALSAlgorithm(ALSAlgorithmParams(), device=device)
    empty = BiMap.from_dict({})
    points = []
    for mesh_label, devs in sharded_meshes(device):
        rng = np.random.default_rng(SHD_SEED)
        with sharding.local_devices(devs):
            for n_items in SHD_SIZES:
                n_users = max(1024, n_items // 2)
                uf = rng.standard_normal((n_users, SHD_RANK)).astype(np.float32)
                vf = rng.standard_normal((n_items, SHD_RANK)).astype(np.float32)
                vf[1] = vf[0]  # an exact tie must merge as the replicated path merges it
                uidx = rng.integers(0, n_users, SHD_QUERIES)
                point = {"mesh": mesh_label, "catalog_items": n_items, "catalog_users": n_users, "rank": SHD_RANK}
                model, bytes_sharded = algo.shard_model_for_serving(ALSModel(uf, vf, empty, empty))
                info = model._pio_shards
                S = info.num_shards
                repl = uf.nbytes + vf.nbytes
                per_pos = sharding.per_device_bytes(model.user_factors) + sharding.per_device_bytes(model.item_factors)
                math = sum(sharding.sharded_table_bytes(n, SHD_RANK, S) for n in (n_users, n_items))
                if per_pos != math or per_pos > repl / S * SHD_BYTES_SLACK:
                    raise RuntimeError(f"sharded: a mesh position holds {per_pos} bytes, sharded_table_bytes says "
                                       f"{math}, replicated / {S} is {repl / S}")
                # the plain GEMM across the two layouts, first chunk
                uf_d, vf_d = torch.as_tensor(uf, device=device), torch.as_tensor(vf, device=device)
                q = uf_d[torch.as_tensor(uidx[:SHD_CHUNK], device=device)]
                whole = (q @ vf_d.T).cpu().numpy()
                parts = torch.cat([(q.to(t.device) @ t.T).to(device) for t in model.item_factors.shards], 1)
                plain = bit_differences(whole, parts[:, :n_items].cpu().numpy())
                del whole, parts
                shard_stats, s_ids, s_scores = timed_topk(lambda c: sharding.sharded_topk_users(
                    c, model.user_factors, model.item_factors, SHD_K, n_items), uidx)
                repl_stats, r_ids, r_scores = timed_topk(lambda c: top_k_items_batch(
                    torch.as_tensor(c, device=device), uf_d, vf_d, SHD_K), uidx)
                exact_bits = bit_differences(s_scores, r_scores)
                if not np.array_equal(s_ids, r_ids) or not np.allclose(s_scores, r_scores, rtol=SHD_SCORE_RTOL, atol=0):
                    raise RuntimeError(f"sharded: {int((s_ids != r_ids).sum())} ids of the sharded exact top-{SHD_K} "
                                       f"differ from the replicated ones at {n_items} items ({mesh_label})")
                # int8: sharded codes and scales against replicated ones
                model_q, bytes_q = algo.quantize_model_for_serving(ALSModel(uf, vf, empty, empty), shard=True)
                per_pos_q = (sharding.per_device_bytes_quantized(model_q.user_factors)
                             + sharding.per_device_bytes_quantized(model_q.item_factors))
                if per_pos_q > repl / (S * QZ_BYTES_RATIO):
                    raise RuntimeError(f"sharded: an int8 mesh position holds {per_pos_q} bytes, over replicated / "
                                       f"({S} x {QZ_BYTES_RATIO})")
                ur, ir = quant.quantize_table(uf, device), quant.quantize_table(vf, device)
                rrt = quant.QuantRuntime("int8", {}, 0)
                q_stats, qs_ids, qs_scores = timed_topk(lambda c: quant.run_topk(
                    model_q._pio_quant, model_q.user_factors, model_q.item_factors, c, SHD_K,
                    shards=model_q._pio_shards), uidx)
                q_repl_stats, qr_ids, qr_scores = timed_topk(lambda c: quant.run_topk(rrt, ur, ir, c, SHD_K), uidx)
                if not np.array_equal(qs_ids, qr_ids) or bit_differences(qs_scores, qr_scores)[0]:
                    raise RuntimeError(f"sharded: the sharded int8 top-{SHD_K} is not the replicated int8 one to the "
                                       f"bit at {n_items} items ({mesh_label})")
                algo.release_pinned_model(model_q)
                del ur, ir, model_q
                # IVF: the index laid out over the mesh, the model's sharded
                # item table its full probe's
                index, binfo = ivf.build_ivf(vf, nlist=0, seed=0, iters=SHD_IVF_ITERS, device=device, table=vf_d)
                rt = ivf.AnnRuntime(index, ANN_NPROBE, binfo)
                layout = ivf.shard_runtime(rt, info.mesh, model.item_factors, n_items)
                ivf_stats, si_ids, _ = timed_topk(lambda c: sharding.sharded_ivf_topk(
                    sharding.gather_rows(c, model.user_factors), rt.index, SHD_K, ANN_NPROBE), uidx)
                ivf_repl_stats, ui_ids, _ = timed_topk(lambda c: ivf.ivf_topk_users(
                    torch.as_tensor(c, device=device), uf_d, index, SHD_K, ANN_NPROBE), uidx)
                full_stats, fi_ids, fi_scores = timed_topk(lambda c: sharding.sharded_ivf_topk(
                    sharding.gather_rows(c, model.user_factors), rt.index, SHD_K, index.nlist), uidx)
                if not np.array_equal(si_ids, ui_ids):
                    raise RuntimeError(f"sharded: {int((si_ids != ui_ids).sum())} ids of the sharded IVF probe "
                                       f"differ from the unsharded one at {n_items} items ({mesh_label})")
                if not np.array_equal(fi_ids, r_ids) or bit_differences(fi_scores, r_scores)[0]:
                    raise RuntimeError(f"sharded: the sharded full probe is not the exact top-{SHD_K} to the bit at "
                                       f"{n_items} items ({mesh_label})")
                point.update({
                    "shards": S, "replicated_bytes": repl, "sharded_bytes_total": bytes_sharded,
                    "per_position_bytes": per_pos, "sharded_table_bytes": math,
                    "int8_bytes_total": bytes_q, "int8_per_position_bytes": per_pos_q,
                    "plain_gemm_bits_differ": plain[0], "plain_gemm_max_ulps": plain[1],
                    "exact_scores_bits_differ": exact_bits[0],
                    "exact": {"sharded": shard_stats, "replicated": repl_stats},
                    "int8": {"sharded": q_stats, "replicated": q_repl_stats},
                    "ivf": {"nlist": index.nlist, "nprobe": ANN_NPROBE, "sharded": ivf_stats,
                            "unsharded": ivf_repl_stats, "full_probe_sharded": full_stats,
                            "bytes_index_per_position": layout["bytesIndexPerDevice"]},
                })
                log(f"[sharded] {mesh_label} x{S}, {n_items} items x {n_users} users, rank {SHD_RANK}: a position "
                    f"holds {per_pos} bytes = sharded_table_bytes {math} (replicated {repl}, /S {repl / S:.0f}), int8 "
                    f"{per_pos_q}; plain GEMM whole against per shard: {plain[0]} of {SHD_CHUNK * n_items} scores "
                    f"differ (up to {plain[1]} ulps); exact sharded {shard_stats['queries_per_s']:.1f} queries/s, "
                    f"replicated {repl_stats['queries_per_s']:.1f}: ids equal, {exact_bits[0]} scores differ in "
                    f"their bits; int8 sharded {q_stats['queries_per_s']:.1f}, replicated "
                    f"{q_repl_stats['queries_per_s']:.1f}: equal to the bit; IVF nlist {index.nlist} nprobe "
                    f"{ANN_NPROBE} sharded {ivf_stats['queries_per_s']:.1f}, unsharded "
                    f"{ivf_repl_stats['queries_per_s']:.1f}: ids equal; full probe sharded "
                    f"{full_stats['queries_per_s']:.1f}: the exact answer to the bit; on {smi}")
                algo.release_pinned_model(model)
                del model, rt, index, uf_d, vf_d
                points.append(point)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"oom_shape": oom, "sweep": points, "queries": SHD_QUERIES, "k": SHD_K, "card": smi,
            "phase_s": time.perf_counter() - t_phase}


def one_product(q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The scoring of the port before ``ops/als.score_rows``: one
    ``[M, K] @ [K, n]`` product, whose kernel (and bits) cuBLAS picks by
    ``n``."""
    return q @ table.T


def copied_windows(q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``score_rows``' first design, kept here to time it: a fresh
    ``[M, SCORE_BLOCK]`` product a window, copied into the output, the
    last window overlapping the one before, a short table padded."""
    from predictionio_tpu_torch.ops.als import SCORE_BLOCK

    n = table.shape[0]
    if n <= SCORE_BLOCK:
        pad = torch.cat([table, table.new_zeros((SCORE_BLOCK - n, table.shape[1]))])
        return (q @ pad.T)[:, :n]
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=q.device)
    for lo in [*range(0, n - SCORE_BLOCK, SCORE_BLOCK), n - SCORE_BLOCK]:
        out[:, lo:lo + SCORE_BLOCK] = q @ table[lo:lo + SCORE_BLOCK].T
    return out


def phase_score_cost(device, smi: str) -> dict:
    """What ``ops/als.score_rows`` (every exact score of the port, in
    products of ``SCORE_BLOCK`` rows written in place) costs the replicated
    exact path against one product (``one_product``) and against its
    first design (``copied_windows``), at the warm instance's catalog and
    the sweep's largest (``SCORE_COST_ITEMS``): the scoring alone and
    ``top_k_items_batch`` at a 512-query chunk and a 32-query batch (CUDA
    events, each version timed twice, in the order A B C C B A), and one
    user's ``top_k_items`` with its answer copied to the host, as a
    per-request deploy asks (host clock, the versions interleaved call by
    call, medians). First ``score_rows``' contract at ``SCORE_COST_CHECK_M``
    queries: the scores of a slice of the table (one block; three and a
    short one; a short one alone; the last rows) equal to the bit the
    same items' scores in the whole table, whatever the batch count of
    its products."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops.topk import top_k_scores

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SHD_SEED)
    points = []
    for n_items in SCORE_COST_ITEMS:
        n_users = max(1024, n_items // 2)
        uf = torch.as_tensor(rng.standard_normal((n_users, SHD_RANK)).astype(np.float32), device=device)
        vf = torch.as_tensor(rng.standard_normal((n_items, SHD_RANK)).astype(np.float32), device=device)
        point = {"catalog_items": n_items, "catalog_users": n_users, "rank": SHD_RANK, "batches": {}}
        block = als.SCORE_BLOCK
        slices = [(0, block), (0, 3 * block + 100), (block + 7, block + 7 + 3385), (n_items - 5000, n_items)]
        for m in SCORE_COST_CHECK_M:
            q = uf[:m]
            whole = als.score_rows(q, vf)
            for lo, hi in slices:
                bits = int((als.score_rows(q, vf[lo:hi]).view(torch.int32)
                            != whole[:, lo:hi].contiguous().view(torch.int32)).sum())
                if bits:
                    raise RuntimeError(f"score cost: {bits} scores of score_rows over rows {lo}:{hi} of {n_items} "
                                       f"differ in their bits from the whole table's at M = {m}")
            del whole
        for m in SCORE_COST_BATCHES:
            idx = torch.as_tensor(rng.integers(0, n_users, m), device=device)
            q = uf[idx]
            reps = SCORE_COST_REPS if n_items < 10**6 else 5
            score_fns = {"one_product": lambda: one_product(q, vf), "copied_windows": lambda: copied_windows(q, vf),
                         "score_rows": lambda: als.score_rows(q, vf)}
            topk_fns = {"one_product": lambda: top_k_scores(one_product(uf[idx], vf), SHD_K),
                        "score_rows": lambda: als.top_k_items_batch(idx, uf, vf, SHD_K)}
            row = {}
            for label, fns in (("score_ms", score_fns), ("top_k_items_batch_ms", topk_fns)):
                order = list(fns) + list(fns)[::-1]
                times = {name: [] for name in fns}
                for name in order:
                    times[name].append(time_ms(fns[name], reps))
                row[label] = {name: sum(t) / len(t) for name, t in times.items()}
            point["batches"][m] = row
        # one user a call, its answer to the host: a per-request deploy's query
        users = rng.integers(0, n_users, SCORE_COST_CALLS)
        walls = {"one_product": [], "score_rows": []}
        fns = {"one_product": lambda u: top_k_scores(vf @ uf[u], TOP_K),
               "score_rows": lambda u: als.top_k_items(uf[u], vf, TOP_K)}
        for name, fn in fns.items():
            fn(int(users[0]))[0].cpu()
        for i, u in enumerate(users):
            for name in (("one_product", "score_rows") if i % 2 == 0 else ("score_rows", "one_product")):
                t0 = time.perf_counter()
                fns[name](int(u))[0].cpu()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        point["per_request_ms_p50"] = {name: float(np.median(w)) for name, w in walls.items()}
        b512, b32 = point["batches"][512], point["batches"][32]
        log(f"[sharded] score_rows cost, {n_items} items, rank {SHD_RANK}: scoring a 512-query chunk "
            f"{b512['score_ms']['score_rows']:.4f} ms against one product {b512['score_ms']['one_product']:.4f} "
            f"(copied windows {b512['score_ms']['copied_windows']:.4f}); top_k_items_batch at 512 "
            f"{b512['top_k_items_batch_ms']['score_rows']:.4f} ms against {b512['top_k_items_batch_ms']['one_product']:.4f}, "
            f"at 32 {b32['top_k_items_batch_ms']['score_rows']:.4f} against "
            f"{b32['top_k_items_batch_ms']['one_product']:.4f}; one user's top_k_items to the host p50 "
            f"{point['per_request_ms_p50']['score_rows']:.4f} ms against {point['per_request_ms_p50']['one_product']:.4f} "
            f"({SCORE_COST_CALLS} calls each, interleaved); score_rows over 4 slices bit-equal to the whole "
            f"table's at M = {', '.join(map(str, SCORE_COST_CHECK_M))}; on {smi}")
        points.append(point)
        del uf, vf
    torch.cuda.empty_cache()
    return {"points": points, "card": smi, "phase_s": time.perf_counter() - t_phase}


def padded_table_bytes(rows: int, rank: int, shards: int, itemsize: int) -> int:
    from predictionio_tpu_torch.parallel import sharding

    return sharding.padded_rows(rows, shards) * rank * itemsize


def sharded_load(label: str, service: QueryService, picks: np.ndarray, user_index, clients: int, smi: str) -> dict:
    """``clients`` x ``len(picks)/clients`` top-10 queries to ``service``
    behind the port's HTTP server (``QueryServer``); every answer 200."""
    with QueryServer(service) as server:
        load = run_load(server.url, picks, user_index, clients, TOP_K)
    load["answers"] = ok_answers(f"sharded {label}", load)
    log(f"[sharded] {label}: {load['queries']} queries from {clients} keep-alive clients, "
        f"{load['queries_per_s']:.1f} queries/s, p50 {load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms, all 200; "
        f"on {smi}")
    return load


def score_rows_ab(service: QueryService, picks: np.ndarray, user_index, smi: str) -> dict:
    """The ``[serving]`` uniform load (``SRV_CLIENTS`` clients, ``picks``)
    on a per-request pinned ``service``, with the exact path's scoring as
    it is (``ops/als.score_rows``) and as one product (``one_product``
    patched in for ``als.score_rows``, the scoring before it): four legs
    of half the picks in the order A B B A, so each version answers every
    pick once, all 200. Returns each version's queries/s (its queries
    over its legs' wall) and each leg's p50 / p99."""
    from predictionio_tpu_torch.ops import als

    original, half = als.score_rows, len(picks) // 2
    legs = (("one_product", picks[:half]), ("score_rows", picks[:half]), ("score_rows", picks[half:]),
            ("one_product", picks[half:]))
    runs: dict = {"one_product": [], "score_rows": []}
    with QueryServer(service) as server:
        for name, part in legs:
            als.score_rows = one_product if name == "one_product" else original
            try:
                load = run_load(server.url, part, user_index, SRV_CLIENTS, TOP_K)
            finally:
                als.score_rows = original
            ok_answers(f"score_rows A/B {name}", load)
            runs[name].append({key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")})
    out = {name: {"queries": sum(r["queries"] for r in legs_),
                  "queries_per_s": sum(r["queries"] for r in legs_) / sum(r["wall_s"] for r in legs_),
                  "legs": legs_} for name, legs_ in runs.items()}
    p50 = {name: " / ".join(f"{r['p50_ms']:.3f}" for r in legs_) for name, legs_ in runs.items()}
    log(f"[sharded] score_rows A/B on the plain pinned service, {SRV_CLIENTS} clients x {len(picks) // SRV_CLIENTS} "
        f"uniform queries a version (legs A B B A): score_rows {out['score_rows']['queries_per_s']:.1f} queries/s "
        f"(p50 {p50['score_rows']} ms), one product {out['one_product']['queries_per_s']:.1f} (p50 "
        f"{p50['one_product']} ms), all 200; on {smi}")
    return out


def same_as_plain(label: str, answers: list, plain: QueryService, user_index, k: int) -> list:
    """Every ``(user row, payload)`` answer's item ids equal to ``plain``'s
    ``handle_query`` for the same body; raises otherwise. Returns
    ``plain``'s answers, as ``(user row, payload)``."""
    bad, theirs = [], []
    for uidx, payload in answers:
        status, want = plain.handle_query({"user": user_index.inverse(uidx), "num": k})
        theirs.append((uidx, want))
        if status != 200 or [s["item"] for s in payload["itemScores"]] != [s["item"] for s in want["itemScores"]]:
            bad.append(uidx)
    if bad:
        raise RuntimeError(f"{label}: {len(bad)} of {len(answers)} answers differ from the plain pinned service's")
    return theirs


def spare_blas_handles(device, n: int = 2) -> None:
    """Leave ``n`` cuBLAS handles with their workspaces free for the next
    threads' first products: a thread that finds none takes a new handle,
    whose workspace (32 MiB here) comes from the caching allocator and
    would count in a load's peak. ``n`` threads hold one each at once;
    a thread's handles go back to the pool when it ends."""
    together = threading.Barrier(n)

    def product() -> None:
        torch.ones(8, 8, device=device) @ torch.ones(8, 8, device=device)
        together.wait(timeout=60)

    workers = [threading.Thread(target=product, daemon=True) for _ in range(n)]
    for worker in workers:
        worker.start()
    for worker in workers:
        worker.join()


def phase_sharded_service(device, ctx: dict, smi: str) -> dict:
    """``CacheConfig(shard_factors=True, pin_model=True)`` on the workflow's
    warm instance, an 8-way mesh over the card (``SHD_SHARDS``), behind the
    port's HTTP server. First the ``[serving]`` uniform load on the plain
    ``--pin-model`` service with and without ``score_rows``
    (:func:`score_rows_ab`). Then the sharded tier under that load
    (``SRV_CLIENTS`` x ``SRV_REQUESTS``), every answer float64 numpy's
    top-10 (near-tie rule) and the item ids of the plain service's for the
    same user; ``factorShards`` and ``bytesPinned`` (the padded tables);
    the load's peak ``max_memory_allocated`` below the shards plus a
    replicated copy; ``SHD_RELOADS`` reloads, each generation's
    ``ShardedTable``\\ s collectable after the next and
    ``memory_allocated`` flat within 1 MiB; ``--quantize int8``
    (``SHD_INT8_REQUESTS`` queries a client) and ``--ann``
    (``SHD_ANN_REQUESTS``) with shards (the unsharded tier's ids; recall@10
    at the ``[ann]`` sweep's bars, or at the unsharded tier's where it
    misses them here); ``--online`` under
    the ``[online]`` traffic through the event server's bulk route, then
    three folds: a
    fresh user into a padding slot, a burst past the padding into one
    re-layout, a known user's update into its row alone (every other row
    bit-equal); then ``pio deploy --shard-factors --pin-model`` as a
    subprocess (one card: the JAX package's warning and ``factorShards``
    0; more: the real mesh and each card's memory). No kernel launches."""
    import gc
    import weakref

    from predictionio_tpu_torch.parallel import sharding
    from predictionio_tpu_torch.serving import AnnConfig, CacheConfig

    t_phase = time.perf_counter()
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    first = ctx["instance"]
    stored = stored_model(first.id)
    user_index, item_index = stored.user_index, stored.item_index
    U64 = np.asarray(stored.user_factors, np.float64)
    V64 = np.asarray(stored.item_factors, np.float64)
    rank = stored.user_factors.shape[1]
    del stored
    n_users, n_items = len(user_index), len(item_index)
    variant = load_engine_variant(str(engine_json))
    picks = load_picks(SRV_CLIENTS * SRV_REQUESTS, n_users, seed=71)
    out: dict = {"users": n_users, "items": n_items, "rank": rank, "shards": SHD_SHARDS, "card": smi}
    reset_launch_counts()
    plain = QueryService(variant, local_context(device), instance_id=first.id, cache=CacheConfig(pin_model=True))
    on_card = device.type == "cuda"
    try:
        out["score_rows_ab"] = score_rows_ab(plain, picks, user_index, smi)
        with sharding.local_devices([device] * SHD_SHARDS):
            # the sharded exact tier; the load's peak on the card: the
            # shards alone (no replicated pin before them)
            if on_card:
                spare_blas_handles(device)
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            mem_before = torch.cuda.memory_allocated(device) if on_card else 0
            service = QueryService(variant, local_context(device), instance_id=first.id,
                                   cache=CacheConfig(shard_factors=True, pin_model=True))
            if on_card:
                torch.cuda.synchronize(device)
            load_peak = torch.cuda.max_memory_allocated(device) - mem_before if on_card else 0
            replicated_bytes = (n_users + n_items) * rank * 4
            try:
                load = sharded_load("--shard-factors --pin-model, uniform users", service, picks, user_index,
                                    SRV_CLIENTS, smi)
                checked = check_answers("sharded", load["answers"], U64, V64, item_index, TOP_K)
                same = len(same_as_plain("sharded", load["answers"], plain, user_index, TOP_K))
                stats, root = service.stats_json()["cache"], service.status_json()
                want_bytes = sum(padded_table_bytes(n, rank, SHD_SHARDS, 4) for n in (n_users, n_items))
                if stats["factorShards"] != SHD_SHARDS or stats["bytesPinned"] != want_bytes or not root["shardFactors"]:
                    raise RuntimeError(f"sharded: factorShards {stats['factorShards']}, bytesPinned "
                                       f"{stats['bytesPinned']} (padded tables {want_bytes}), shardFactors "
                                       f"{root['shardFactors']}")
                if load_peak >= want_bytes + replicated_bytes:
                    raise RuntimeError(f"sharded: the load's peak {load_peak} bytes holds the shards ({want_bytes}) "
                                       f"and a replicated copy ({replicated_bytes})")
                # reloads: each generation's shards collectable, memory flat
                # (earlier phases' garbage collected first: the loop's
                # collections must not count it)
                gc.collect()
                if on_card:
                    torch.cuda.synchronize(device)
                mem_first = torch.cuda.memory_allocated(device) if on_card else 0
                refs = []
                for _ in range(SHD_RELOADS):
                    (_, model), = service.snapshot_pairs()[0]
                    refs += [weakref.ref(model.user_factors), weakref.ref(model.item_factors)]
                    del model
                    service.reload()
                    gc.collect()
                    alive = sum(r() is not None for r in refs)
                    if alive:
                        raise RuntimeError(f"sharded: {alive} ShardedTables of a superseded generation are alive "
                                           "after /reload")
                if on_card:
                    torch.cuda.synchronize(device)
                mem_last = torch.cuda.memory_allocated(device) if on_card else 0
                if abs(mem_last - mem_first) > 1 << 20:
                    raise RuntimeError(f"sharded: {SHD_RELOADS} reloads moved memory_allocated {mem_first} -> "
                                       f"{mem_last}")
            finally:
                service.close()
            run = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
            out["exact"] = dict(run, checked=checked, same_as_plain=same, factor_shards=stats["factorShards"],
                                bytes_pinned=stats["bytesPinned"], reload_memory=[mem_first, mem_last],
                                load_peak_bytes=load_peak, replicated_bytes=replicated_bytes)
            log(f"[sharded] exact: {checked} answers float64 numpy's top-{TOP_K}, {same} the plain pinned "
                f"service's ids; factorShards {stats['factorShards']}, bytesPinned {stats['bytesPinned']} = the "
                f"padded tables; the load's peak max_memory_allocated {load_peak} bytes (the replicated tables "
                f"{replicated_bytes}); {SHD_RELOADS} reloads: every superseded generation's shards collected, "
                f"memory_allocated {mem_first} -> {mem_last}; on {smi}")
            # int8 and IVF composed with shards, each against its unsharded tier
            for label, flags, ann, bar, n in (
                ("int8", {"quantize": "int8"}, None, QZ_RECALL_BAR, SRV_CLIENTS * SHD_INT8_REQUESTS),
                ("ann", {"pin_model": True}, AnnConfig(enabled=True, nprobe=ANN_NPROBE), ANN_RECALL_BAR,
                 SRV_CLIENTS * SHD_ANN_REQUESTS),
            ):
                service = QueryService(variant, local_context(device), instance_id=first.id,
                                       cache=CacheConfig(shard_factors=True, **flags), ann=ann)
                try:
                    load = sharded_load(f"--shard-factors --{'quantize int8' if ann is None else 'ann'}", service,
                                        picks[:n], user_index, SRV_CLIENTS, smi)
                    stats = service.stats_json()
                finally:
                    service.close()
                unsharded = QueryService(variant, local_context(device), instance_id=first.id,
                                         cache=CacheConfig(**flags), ann=ann)
                try:
                    theirs = same_as_plain(f"sharded {label}", load["answers"], unsharded, user_index, TOP_K)
                finally:
                    unsharded.close()
                recall = recall_vs_float64(load["answers"], U64, V64, item_index, TOP_K)
                recall_unsharded = recall_vs_float64(theirs, U64, V64, item_index, TOP_K)
                shards = stats["cache"]["factorShards"]
                ann_shards = stats["ann"]["models"][0]["shards"] if ann is not None else SHD_SHARDS
                # the [ann] sweep's bar, or the unsharded tier's own recall
                # where that tier misses the bar on this instance
                if recall < min(bar, recall_unsharded) or shards != SHD_SHARDS or ann_shards != SHD_SHARDS:
                    raise RuntimeError(f"sharded {label}: recall@10 {recall:.4f} (bar {bar}, the unsharded tier "
                                       f"{recall_unsharded:.4f}), factorShards {shards}, index shards {ann_shards}")
                run = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
                out[label] = dict(run, recall_at_10=recall, recall_at_10_unsharded=recall_unsharded,
                                  same_as_unsharded=len(theirs), bytes_pinned=stats["cache"]["bytesPinned"])
                log(f"[sharded] {label} with shards: {len(theirs)} answers the unsharded tier's ids; recall@10 "
                    f"against float64 numpy {recall:.4f}, the unsharded tier's {recall_unsharded:.4f} (the [ann] "
                    f"sweep's bar {bar}: {'met' if recall >= bar else 'missed by both tiers on this instance'}); "
                    f"factorShards {shards}; bytesPinned {stats['cache']['bytesPinned']}; on {smi}")
            out["online"] = sharded_online(device, ctx, variant, user_index, item_index, rank, smi)
    finally:
        plain.close()
    out["launches"] = read_launch_counts()
    out["cli"] = sharded_cli(device, ctx, user_index, U64, V64, item_index, rank, smi)
    if any(out["launches"].values()):
        raise RuntimeError(f"sharded: launches {out['launches']}; the sharded path has no kernel")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def sharded_online(device, ctx: dict, variant, user_index, item_index, rank: int, smi: str) -> dict:
    """``--online`` on sharded tables (inside ``phase_sharded_service``'s
    mesh): the ``[online]`` traffic (``ONL_CLIENTS`` clients, known users;
    ``ONL_INGEST_EPS`` events/s through the bulk route) against an
    in-process ``QueryService(cache=CacheConfig(shard_factors=True,
    pin_model=True), online=...)``, then its follower stopped and three
    folds by ``POST /online/fold.json`` of events posted to the bulk
    route, each held to its contract."""
    from predictionio_tpu_torch.parallel import sharding
    from predictionio_tpu_torch.serving import CacheConfig

    base, first = ctx["base"], ctx["instance"]
    app = Storage.get_meta_data_apps().get_by_name(WF_APP)
    (access_key,) = Storage.get_meta_data_access_keys().get_by_appid(app.id)
    rng = np.random.default_rng(72)
    items = item_index.keys()
    es_proc = None
    service = QueryService(variant, local_context(device), instance_id=first.id,
                           cache=CacheConfig(shard_factors=True, pin_model=True),
                           online=OnlineConfig(enabled=True, interval_s=ONL_INTERVAL_S, batch_size=ONL_BATCH))
    try:
        es_proc, es_port = start_console_server("sharded", base, ["eventserver"], base / "es-sharded.stderr",
                                                WF_SERVER_TIMEOUT_S)
        es_url = f"http://127.0.0.1:{es_port}"
        with QueryServer(service) as server:
            traffic = online_traffic(server.url, es_url, access_key.key, user_index, item_index, False, seed=73)
        service.online.stop()

        def fold() -> dict:
            response = service.dispatch("POST", "/online/fold.json", {}, None)
            if response.status != 200:
                raise RuntimeError(f"sharded online: /online/fold.json answered {response.status}")
            return response.body

        def user_table():
            def read():
                (_, model), = service.snapshot_pairs()[0]
                return np.asarray(model.user_factors), model._pio_shards.rows["user"], model.user_index
            return service.run_on_device(read)

        fold()  # what the follower had not folded yet
        before, logical, _ = user_table()
        padded = before.shape[0]
        # a fresh user: one padding slot, no re-layout
        bulk_post(es_url, access_key.key, rate_events(rng, [], items, SHD_FOLD_EVENTS, "sharded-fresh-0"))
        fold()
        after, logical_1, index = user_table()
        row = index["sharded-fresh-0"]
        if (after.shape[0] != padded or logical_1 != logical + 1 or row != logical or not np.abs(after[row]).sum()
                or not np.array_equal(after[:logical], before[:logical])):
            raise RuntimeError(f"sharded online: the fresh user's fold: rows {before.shape[0]} -> {after.shape[0]}, "
                               f"logical {logical} -> {logical_1}, its row {row}")
        # a burst past the padding: one re-layout, GROW_STEP headroom
        burst = padded - logical_1 + 1
        bulk_post(es_url, access_key.key, [e for j in range(burst) for e in rate_events(
            rng, [], items, SHD_FOLD_EVENTS, f"sharded-burst-{j}")])
        fold()
        grown, logical_2, _ = user_table()
        want_rows = sharding.padded_rows(logical_1 + burst + sharding.GROW_STEP, SHD_SHARDS)
        if (logical_2 != logical_1 + burst or grown.shape[0] != want_rows
                or not np.array_equal(grown[:logical_1], after[:logical_1])):
            raise RuntimeError(f"sharded online: the burst of {burst} users: logical {logical_2}, rows "
                               f"{grown.shape[0]} (want {want_rows})")
        # a known user's update: its row alone
        known = user_index.inverse(7)
        bulk_post(es_url, access_key.key, rate_events(rng, [], items, SHD_FOLD_EVENTS, known))
        fold()
        updated, _, _ = user_table()
        r = user_index[known]
        others = np.ones(updated.shape[0], bool)
        others[r] = False
        if np.array_equal(updated[r], grown[r]) or not np.array_equal(updated[others], grown[others]):
            raise RuntimeError("sharded online: a known user's fold moved other rows, or not its own")
        stats = service.stats_json()["online"]
    finally:
        service.close()
        if es_proc is not None:
            es_proc.send_signal(signal.SIGTERM)
            try:
                es_proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                es_proc.kill()
                es_proc.wait(timeout=30)
    out = {key: traffic[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms", "ingested",
                                         "ingest_events_per_s")}
    out.update({"padded_rows": padded, "logical_rows": logical, "burst": burst, "relayout_rows": grown.shape[0],
                "events_seen": stats["eventsSeen"], "folds": stats["folds"]})
    log(f"[sharded] --online: {traffic['queries']} queries from {ONL_CLIENTS} keep-alive clients, "
        f"{traffic['queries_per_s']:.1f} queries/s, p50 {traffic['p50_ms']:.3f} ms, p99 {traffic['p99_ms']:.3f} ms, "
        f"all 200, while {traffic['ingested']} events ({traffic['ingest_events_per_s']:.1f}/s) arrived through "
        f"/events/bulk.json; folds: a fresh user into padding slot {logical} of {padded} rows, a burst of {burst} "
        f"users into one re-layout of {grown.shape[0]} rows, a known user's update into its row alone (every other "
        f"row bit-equal); on {smi}")
    return out


def sharded_cli(device, ctx: dict, user_index, U64: np.ndarray, V64: np.ndarray, item_index, rank: int,
                smi: str) -> dict:
    """``pio deploy --shard-factors --pin-model`` as a subprocess: on one
    card the JAX package's warning in its log and ``factorShards`` 0; on
    two or more the real mesh (``factorShards`` the card count) and each
    card's memory from ``nvidia-smi`` beside ``sharded_table_bytes``. 64
    answers float64 numpy's top-10."""
    from predictionio_tpu_torch.parallel import sharding

    base, first = ctx["base"], ctx["instance"]
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    err = base / "deploy-sharded.stderr"
    t0 = time.perf_counter()
    proc, port = start_console_server(
        "sharded", base, ["deploy", "--engine-json", str(ctx["engine_json"]), "--engine-instance-id", first.id,
                          *ctx["dev_args"], "--shard-factors", "--pin-model"], err, QS_DEPLOY_TIMEOUT_S)
    try:
        start_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        load = run_load(url, load_picks(64, len(user_index), seed=74), user_index, 4, TOP_K)
        _, stats = _http_json(url + "/stats.json")
        _, root = _http_json(url + "/")
        memory = _smi("memory.used") if cards else ""
        if cards >= 2:
            memory = subprocess.run(["nvidia-smi", "--query-gpu=index,memory.used", "--format=csv,noheader"],
                                    capture_output=True, text=True, timeout=60).stdout.strip().replace("\n", "; ")
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    checked = check_answers("sharded cli", ok_answers("sharded cli", load), U64, V64, item_index, TOP_K)
    warned = "only one device is visible; falling back to --pin-model replication" in err.read_text()
    want_shards = cards if cards >= 2 else 0
    if stats["cache"]["factorShards"] != want_shards or not root["shardFactors"] or warned != (cards < 2):
        raise RuntimeError(f"sharded cli: {cards} cards, factorShards {stats['cache']['factorShards']}, "
                           f"shardFactors {root['shardFactors']}, the one-device warning logged: {warned}")
    per_card = sum(sharding.sharded_table_bytes(n, rank, max(cards, 1)) for n in (len(user_index), len(item_index)))
    log(f"[sharded] pio deploy --shard-factors --pin-model on {cards} card(s): started in {start_s:.3f} s, "
        f"factorShards {stats['cache']['factorShards']}, the one-device warning logged: {warned}; {checked} answers "
        f"float64 numpy's top-{TOP_K}; nvidia-smi memory.used {memory} beside sharded_table_bytes {per_card} a card; "
        f"on {smi}")
    return {"cards": cards, "factor_shards": stats["cache"]["factorShards"], "warned": warned, "start_s": start_s,
            "memory_used": memory, "sharded_table_bytes": per_card}


def phase_tt_sharded(device, ctx: dict, smi: str) -> dict:
    """The Two-Tower quickstart's instance with ``CacheConfig(shard_factors=
    True, pin_model=True)`` on the 8-way mesh behind the port's HTTP
    server: ``SRV_TT_CLIENTS`` x ``SRV_TT_REQUESTS`` top-10 queries, each
    float64 numpy's (without seen items; near-tie rule) and the item ids
    of a plain pinned service's answer."""
    from predictionio_tpu_torch.parallel import sharding
    from predictionio_tpu_torch.serving import CacheConfig

    model = ctx["model"]
    variant = load_engine_variant(str(ctx["engine_json"]))
    picks = load_picks(SRV_TT_CLIENTS * SRV_TT_REQUESTS, len(model.user_index), seed=75)
    plain = QueryService(variant, local_context(device), cache=CacheConfig(pin_model=True))
    try:
        with sharding.local_devices([device] * SHD_SHARDS):
            service = QueryService(variant, local_context(device), cache=CacheConfig(shard_factors=True,
                                                                                       pin_model=True))
            try:
                load = sharded_load("two-tower --shard-factors", service, picks, model.user_index, SRV_TT_CLIENTS,
                                    smi)
                shards = service.stats_json()["cache"]["factorShards"]
            finally:
                service.close()
        same = len(same_as_plain("tt sharded", load["answers"], plain, model.user_index, TOP_K))
    finally:
        plain.close()
    checked = check_answers("tt sharded", load["answers"], model.user_vecs.astype(np.float64),
                            model.item_vecs.astype(np.float64), model.item_index, TOP_K, model.seen, model.user_index)
    if shards != SHD_SHARDS:
        raise RuntimeError(f"tt sharded: factorShards {shards}")
    log(f"[sharded] two-tower: {checked} answers float64 numpy's top-{TOP_K} without seen items, {same} the plain "
        f"pinned service's ids; factorShards {shards}; on {smi}")
    out = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
    out.update({"checked": checked, "same_as_plain": same, "card": smi})
    return out


# ---------------------------------------------------------- 12. templates
def run_bodies(url: str, bodies: list, clients: int) -> dict:
    """``clients`` threads, each on one keep-alive connection, POST
    ``/queries.json`` with its share of ``bodies`` (client ``c`` takes
    ``bodies[c::clients]``). Returns every answer as ``(body index,
    status, payload)`` in body order, and the rate and latencies."""
    import http.client

    host, port = url.removeprefix("http://").split(":")
    answers: dict = {}
    lat: list = []
    lock = threading.Lock()
    errors: list = []

    def client(c: int) -> None:
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            for j in range(c, len(bodies), clients):
                t0 = time.perf_counter()
                conn.request("POST", "/queries.json", body=json.dumps(bodies[j]).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = json.loads(resp.read())
                with lock:
                    answers[j] = (j, resp.status, payload)
                    lat.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # reported below; a failed client fails the phase
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"templates: {len(errors)} clients failed: {errors[:3]}")
    bad = {j: status for j, status, _ in answers.values() if status != 200}
    if bad or len(answers) != len(bodies):
        raise RuntimeError(f"templates: {len(bad)} answers other than 200 ({list(bad.items())[:3]}), "
                           f"{len(answers)} of {len(bodies)} answered")
    p50, p99 = np.percentile(lat, [50, 99])
    return {"answers": [answers[j] for j in range(len(bodies))], "wall_s": wall,
            "queries_per_s": len(bodies) / wall, "p50_ms": float(p50), "p99_ms": float(p99)}


def template_engine_json(base: Path, name: str, app: str, edit=None) -> Path:
    """``pio template get NAME <base>/<name>-<n> --appname APP``: the
    engine.json the port's console writes, with ``edit(variant)`` applied
    when given."""
    n = len(list(base.glob(f"{name}-*")))
    directory = base / f"{name}-{n}"
    console_ok("templates", ["template", "get", name, str(directory), "--appname", app])
    path = directory / "engine.json"
    if edit is not None:
        variant = json.loads(path.read_text())
        edit(variant)
        path.write_text(json.dumps(variant))
    return path


def implicit_loss(U: torch.Tensor, V: torch.Tensor, r: torch.Tensor, c: torch.Tensor, v: torch.Tensor,
                  n_u: torch.Tensor, n_i: torch.Tensor, reg: float, alpha: float) -> float:
    """The objective implicit ALS descends, in float64 on the tables'
    device: over every (user, item) pair ``c·(p − x·y)²`` with ``c = 1 +
    α·v`` and ``p = [v > 0]`` on the stored pairs (``c = 1``, ``p = 0``
    elsewhere), plus ``λ·(Σ n_u·|x_u|² + Σ n_i·|y_i|²)`` (the ridge the
    solve adds, ``n`` the positive pairs of each row). The unobserved
    pairs' sum comes from the two Gramians: ``Σ (x·y)² = Σ (XᵀX)∘(YᵀY)``."""
    Ud, Vd = U.double(), V.double()
    total = ((Ud.T @ Ud) * (Vd.T @ Vd)).sum()
    step = 1 << 21
    for lo in range(0, r.numel(), step):
        s = (Ud[r[lo:lo + step]] * Vd[c[lo:lo + step]]).sum(dim=-1)
        val = v[lo:lo + step]
        pref = (val > 0).double()
        total += ((1.0 + alpha * val) * (pref - s) ** 2 - s ** 2).sum()
    total += reg * ((n_u * Ud.pow(2).sum(dim=-1)).sum() + (n_i * Vd.pow(2).sum(dim=-1)).sum())
    return float(total)


@contextlib.contextmanager
def recorded_solves(shapes: list):
    """Record the ``[B, K]`` of every batched solve the ALS sweep hands
    ``spd_solve`` in the block (``ops.als``'s name for it is swapped for a
    recorder that calls it: the kernel wrapper and its launch count are
    untouched)."""
    from predictionio_tpu_torch.ops import als as als_module

    real = als_module.spd_solve

    def recording(A, b, method="auto"):
        shapes.append(tuple(b.shape))
        return real(A, b, method=method)

    als_module.spd_solve = recording
    try:
        yield shapes
    finally:
        als_module.spd_solve = real


def train_template_als(label: str, algo_class, engine_json: Path, td, device, dev_args: list) -> dict:
    """``pio train`` of an ALS template with its launch counts set to 0
    before it and read after it, the implicit loss after every sweep (the
    algorithm class's ``on_sweep`` hook) and the solve shapes recorded.
    On the card, ``gj_solve`` must launch exactly the plan of ``td`` (the
    TrainingData its DataSource reads), and nothing else may launch."""
    p = json.loads(engine_json.read_text())["algorithms"][0]["params"]
    reg, alpha = float(p.get("lambda", 0.01)), float(p.get("alpha", 1.0))
    cfg = ALSConfig(rank=int(p["rank"]))
    plan = int(p["numIterations"]) * (planned_solves(td.rows, len(td.user_index), cfg)
                                     + planned_solves(td.cols, len(td.item_index), cfg))
    r = torch.as_tensor(td.rows, device=device)
    c = torch.as_tensor(td.cols, device=device)
    v = torch.as_tensor(td.vals, dtype=torch.float64, device=device)
    n_u = torch.bincount(r[v > 0], minlength=len(td.user_index)).double()
    n_i = torch.bincount(c[v > 0], minlength=len(td.item_index)).double()
    losses: list = []
    # a class attribute: the algorithm is built inside pio train
    algo_class.on_sweep = staticmethod(
        lambda step, U, V: losses.append(implicit_loss(U, V, r, c, v, n_u, n_i, reg, alpha)))
    shapes: list = []
    try:
        with recorded_solves(shapes):
            reset_launch_counts()
            wall_s = console_ok(label, ["train", "--engine-json", str(engine_json), *dev_args])
            launches = read_launch_counts()
    finally:
        algo_class.on_sweep = None
    del r, c, v
    instance = max(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
    if instance.status != "COMPLETED":
        raise RuntimeError(f"{label}: engine instance {instance.id} is {instance.status}")
    timings = json.loads(instance.env["phase_timings"])
    solves = [b for b, k in shapes if k == cfg.rank]
    if len(solves) != plan or len(shapes) != plan:
        raise RuntimeError(f"{label}: the sweeps made {len(shapes)} solves ({len(solves)} at K={cfg.rank}), "
                           f"the plan says {plan}")
    if device.type == "cuda":
        check_launches(label, launches, {"gj_solve": plan})
        if launches["fused_ce_fwd"] or launches["fused_ce_bwd"]:
            raise RuntimeError(f"{label}: the fused-CE kernels launched on an ALS path: {launches}")
    if len(losses) != int(p["numIterations"]) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{label}: the implicit loss did not fall over the sweeps: {losses}")
    algo = next(name for name in timings if name.startswith("train:"))
    return {"instance": instance, "wall_s": wall_s, "read_s": timings["read"], "train_s": timings[algo],
            "launches": launches["gj_solve"], "plan": plan, "losses": losses, "loss_ratio": losses[-1] / losses[0],
            "solve_batches": sorted(set(solves))}


def deploy_pair(label: str, base: Path, engine_json: Path, ids: dict, extra: list, dev_args: list) -> dict:
    """One ``pio deploy --engine-instance-id`` subprocess per entry of
    ``ids`` (name -> instance id), all started at once; returns name ->
    ``(process, url, start seconds)``. The caller stops them."""
    def start(name: str):
        t0 = time.perf_counter()
        proc, port = start_console_server(
            f"{label} {name}", base,
            ["deploy", "--engine-json", str(engine_json), "--engine-instance-id", ids[name], *extra, *dev_args],
            base / f"deploy-{label}-{name}.stderr", QS_DEPLOY_TIMEOUT_S)
        return proc, f"http://127.0.0.1:{port}", time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(ids)) as pool:
        futures = {name: pool.submit(start, name) for name in ids}
        started, failed = {}, []
        for name, fut in futures.items():
            try:
                started[name] = fut.result()
            except Exception as e:  # every started one is stopped before raising
                failed.append(e)
    if failed:
        stop_deploys(label, started, check=False)
        raise failed[0]
    return started


def stop_deploys(label: str, started: dict, device=None, check: bool = True) -> None:
    """SIGTERM every deploy; with ``check``, ``GET /`` must first report the
    device, and each must exit 0."""
    errors = []
    for name, (proc, url, _) in started.items():
        try:
            if check:
                _, body = _http_json(url + "/")
                want = "cuda:0" if device.type == "cuda" else "cpu"
                if body.get("device") != want:
                    errors.append(f"{name}: GET / answered device {body.get('device')}, expected {want}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            if rc != 0 and check:
                errors.append(f"{name}: the deploy exited {rc} on SIGTERM")
        except Exception as e:
            errors.append(f"{name}: {e!r}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    if errors:
        raise RuntimeError(f"{label}: {errors}")


def reference_masked_top(scores: np.ndarray, allowed: np.ndarray, num: int) -> np.ndarray:
    """The float64 answer: the top ``min(num, allowed)`` allowed rows by
    descending score, ties to the lower row, non-finite scores dropped."""
    order = np.lexsort((np.arange(scores.size), -scores))
    order = order[allowed[order]][: max(0, min(int(num), int(allowed.sum())))]
    return order[np.isfinite(scores[order])]


def rule_mask(n: int, index, cat_of_row: np.ndarray, exclude_rows, body: dict) -> np.ndarray:
    """The reference's business rules over ``n`` rows, written out plainly:
    the excluded rows out, only ``whiteList`` items, no ``blackList``
    item, only items of one of ``categories``."""
    allowed = np.ones(n, dtype=bool)
    allowed[list(exclude_rows)] = False
    if body.get("whiteList"):
        listed = np.zeros(n, dtype=bool)
        listed[[index[i] for i in body["whiteList"] if i in index]] = True
        allowed &= listed
    if body.get("blackList"):
        allowed[[index[i] for i in body["blackList"] if i in index]] = False
    if body.get("categories"):
        allowed &= np.isin(cat_of_row, body["categories"])
    return allowed


def check_item_answers(label: str, answers: list, refs: list, strict: list) -> int:
    """Each answer's items (rows through ``index``) against its float64
    reference ``(rows, scores)``: equal, except where two differing items'
    float64 scores are within a relative 1e-5 (:func:`check_ranking`) —
    no slack where ``strict`` (popularity: ties must keep ascending
    rows). Raises on a difference; returns the answers checked."""
    bad = []
    for (j, _, payload), (rows, scores, index, forbidden), exact in zip(answers, refs, strict):
        got = [index[s["item"]] for s in payload["itemScores"]]
        if set(got) & forbidden:
            bad.append((j, "forbidden", sorted(set(got) & forbidden)[:5]))
        elif exact and (got != rows.tolist()
                        or [s["score"] for s in payload["itemScores"]] != scores[rows].tolist()):
            bad.append((j, got, rows.tolist()))
        elif not exact and not check_ranking(got, rows, scores):
            bad.append((j, got, rows.tolist()))
    if bad:
        raise RuntimeError(f"{label}: {len(bad)} of {len(answers)} answers differ from float64 numpy: {bad[:3]}")
    return len(answers)


def served_line(name: str, deploy_start_s: float, runs: dict, handle: dict, smi: str) -> dict:
    out = {"deploy_start_s": deploy_start_s,
           **{f"clients_{n}": {key: run[key] for key in ("queries_per_s", "p50_ms", "p99_ms")}
              for n, run in runs.items()},
           "handle_query_p50_ms": handle["p50_ms"]}
    log(f"[templates] {name} served: {json.dumps(out)} on {smi}")
    return out


def handle_p50(engine_json: Path, instance_id: str, bodies: list, device, timers: dict | None = None) -> dict:
    """``handle_query`` alone for ``bodies`` in an in-process ``QueryService``
    of the instance; ``timers`` (method name -> list) wraps those methods
    of the served algorithm to time them per query."""
    service = QueryService(load_engine_variant(str(engine_json)), local_context(device), instance_id=instance_id)
    try:
        (algo, _), = service._algo_model_pairs
        for name, spent in (timers or {}).items():
            fn = getattr(algo, name)

            def timed(*args, _fn=fn, _spent=spent):
                t0 = time.perf_counter()
                try:
                    return _fn(*args)
                finally:
                    _spent.append((time.perf_counter() - t0) * 1e3)

            setattr(algo, name, timed)
        lat = []
        for body in bodies:
            t0 = time.perf_counter()
            status, _ = service.handle_query(body)
            lat.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise RuntimeError(f"templates: handle_query answered {status} for {body}")
    finally:
        service.close()
    return {"p50_ms": float(np.percentile(lat, 50)), "lat_ms": lat}


def phase_templates(device, smi: str, nnz: int, cls_users: int, text_docs: int, n_queries: int) -> dict:
    """Similar-Product, E-Commerce, Classification and Text-Classification
    through the port's console verbs, in one temporary columnar store; see
    the module docstring, phase 12."""
    t_phase = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    out: dict = {}
    with temporary_store("pio-templates-", "columnar") as base:
        out["similarproduct"], out["ecommerce"], out["solve_row"] = phase_tpl_als(device, base, smi, nnz, n_queries,
                                                                              dev_args)
        out["classification"] = phase_tpl_classification(device, base, smi, cls_users, n_queries, dev_args)
        out["textclassification"] = phase_tpl_text(device, base, smi, text_docs, n_queries, dev_args)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[templates] phase {out['phase_s']:.3f} s on {smi}")
    return out


#: a phase function in a child process: ``python -c`` with this script
#: imported; its arguments the function's name, the device, the card's
#: line, the result file and the function's integer arguments
# ------------------------------------------------------------ 15. storage
def http_status(url: str, body: dict | None = None) -> tuple[int, dict]:
    """:func:`_http_json` that returns an error status with its body
    instead of raising."""
    try:
        return _http_json(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def stop_server(label: str, proc, sig: int = signal.SIGTERM) -> None:
    """Stop a console server; with SIGTERM it must exit 0."""
    proc.send_signal(sig)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError(f"{label}: the server did not stop on signal {sig}") from None
    if sig == signal.SIGTERM and rc != 0:
        raise RuntimeError(f"{label}: the server exited {rc} on SIGTERM")


def start_storage_server(base: Path, port: int = 0) -> tuple:
    """``pio storageserver`` over a sqlite+localfs store at ``base`` (the
    registry's default), as a subprocess whose environment names no other
    store; ``port`` 0 binds a free one. Returns the process and its port
    once it accepts connections."""
    root = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=str(base), PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    with open(base / "storageserver.stderr", "a") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "storageserver", "--ip", "127.0.0.1",
             "--port", str(port), "--drain-deadline-s", "5"], cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    lines: queue.Queue = queue.Queue()

    def pump() -> None:
        for line in proc.stdout:
            lines.put(line.strip())
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    try:
        line = _await_line(lines, "Bound port" if port == 0 else "Storage server is listening", WF_SERVER_TIMEOUT_S)
        port = port or int(line.split()[-1])
        deadline = time.perf_counter() + 30
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
                return proc, port
            except OSError:
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"nothing accepts on port {port}") from None
                time.sleep(0.05)
    except RuntimeError as e:
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError(f"storage: the storage server: {e}; stderr: "
                           f"{(base / 'storageserver.stderr').read_text()[-2000:]}") from None


def storage_engine_json(base: Path, app: str, rank: int, sweeps: int, reg: float, seed: int) -> Path:
    path = base / "engine.json"
    path.write_text(json.dumps({
        "id": app, "version": "1", "engineFactory": WF_FACTORY, "datasource": {"params": {"appName": app}},
        "algorithms": [{"name": "als", "params": {"rank": rank, "numIterations": sweeps, "lambda": reg,
                                                 "seed": seed}}],
    }))
    return path


def storage_train(label: str, app: str, engine_json: Path, sweeps: int, rank: int, device, dev_args: list) -> dict:
    """``pio train`` in process with its launch count, the plan of a full
    read's TrainingData, and the stored model's train RMSE (float64, on
    the card) against the mean rating's, which it must be below."""
    from predictionio_tpu_torch.templates.recommendation.engine import DataSourceParams, RecommendationDataSource

    reset_launch_counts()
    wall_s = console_ok(label, ["train", "--engine-json", str(engine_json), *dev_args])
    launches = read_launch_counts()["gj_solve"]
    instance = max(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
    if instance.status != "COMPLETED":
        raise RuntimeError(f"{label}: engine instance {instance.id} is {instance.status}")
    timings = json.loads(instance.env["phase_timings"])
    td = RecommendationDataSource(DataSourceParams(app_name=app, incremental=False)).read_training(
        local_context(device))
    cfg = ALSConfig(rank=rank)
    plan = sweeps * (planned_solves(td.rows, len(td.user_index), cfg) + planned_solves(td.cols, len(td.item_index), cfg))
    if device.type == "cuda":
        check_launches(label, {"gj_solve": launches}, {"gj_solve": plan})
    model = stored_model(instance.id)
    U64, V64 = np.asarray(model.user_factors, np.float64), np.asarray(model.item_factors, np.float64)
    if model.user_index.to_dict() != td.user_index.to_dict() or not (np.isfinite(U64).all() and np.isfinite(V64).all()):
        raise RuntimeError(f"{label}: the stored model is not finite or not a full read's users")
    rmse = rmse_f64(U64, V64, td.rows, td.cols, td.vals, device)
    mean_rmse = float(np.sqrt(np.mean((td.vals.mean() - td.vals) ** 2)))
    if not rmse < mean_rmse:
        raise RuntimeError(f"{label}: train RMSE {rmse} is not below the mean rating's {mean_rmse}")
    return {"instance": instance, "model": model, "U64": U64, "V64": V64, "wall_s": wall_s,
            "read_s": timings["read"], "train_als_s": timings["train:als"], "launches": launches, "plan": plan,
            "train_rmse": rmse, "mean_rmse": mean_rmse, "pairs": int(td.rows.size)}


def fold_rows_check(device, engine_json: Path, instance, events: list) -> dict:
    """The events folded in process through the template's hooks
    (``ONL_BATCH`` a fold): ``ONL_CHECK_ROWS`` rows of the last fold held
    to the float64 numpy solve of their normal equations
    (:func:`fold_reference`); returns the worst error and the launches."""
    deltas = to_deltas(events)
    config = OnlineConfig(enabled=True, interval_s=ONL_INTERVAL_S, batch_size=ONL_BATCH)
    service = QueryService(load_engine_variant(str(engine_json)), local_context(device), instance_id=instance.id)
    try:
        (algo, model), = service.snapshot_pairs()[0]
        generation = service.model_generation
        ds_params = json.loads(instance.datasource_params)
        reset_launch_counts()
        worst = 0.0
        for lo in range(0, len(deltas), ONL_BATCH):
            upd = algo.online_foldin(model, deltas[lo:lo + ONL_BATCH], ds_params, config, run=service.run_on_device)
            if lo + ONL_BATCH >= len(deltas):
                U, V = (service.run_on_device(lambda t=t: (t.cpu().numpy() if isinstance(t, torch.Tensor)
                                                           else np.asarray(t)).astype(np.float64))
                        for t in (model.user_factors, model.item_factors))
                rng = np.random.default_rng(53)
                for side, ids, rows, own, opp in (("users", upd.user_ids, upd.user_rows, U, V),
                                                  ("items", upd.item_ids, upd.item_rows, V, U)):
                    for j in rng.choice(len(ids), min(ONL_CHECK_ROWS // 2, len(ids)), replace=False).tolist():
                        ref = fold_reference(model, side, ids[j], algo.params.lambda_, config.prior_weight, own, opp)
                        worst = max(worst, float(np.linalg.norm(rows[j] - ref) / np.linalg.norm(ref)))
            if not service.apply_online_update([(0, upd)], generation=generation)["applied"]:
                raise RuntimeError("storage: an in-process fold was not applied")
        launches = read_launch_counts()
    finally:
        service.close()
    if worst > ONL_FOLD_RTOL:
        raise RuntimeError(f"storage: a folded row is {worst:.3g} from float64 numpy (limit {ONL_FOLD_RTOL:g})")
    if any(launches.values()):
        raise RuntimeError(f"storage: the fold launched kernels {launches}; its path has none")
    return {"events": len(deltas), "worst_rel_err": worst, "launches": launches}


def in_sync(health: list) -> bool:
    """Every follower replica of every partition caught up with its leader."""
    return all(h.get("lag") and all(v["inSync"] for v in h["lag"].values()) for h in health)


def write_ml20m_shaped(app_id: int, nnz: int) -> tuple:
    """``nnz`` ML-20M-shaped ratings (seed 5) written as columns into the
    registry's event store; returns the seconds, the ratings' user codes
    and the user and item counts."""
    rows, cols, vals, num_users, num_items = ml20m_shaped(nnz, seed=5)
    t_us = (1_600_000_000_000_000 + np.random.default_rng(9).integers(0, 10**9, nnz)).astype(np.int64)
    t0 = time.perf_counter()
    written = Storage.get_p_events().write_columns(
        app_id, event="rate", entity_type="user", entity_codes=rows,
        entity_vocab=np.asarray([str(i) for i in range(num_users)]), target_entity_type="item",
        target_codes=cols, target_vocab=np.asarray([str(i) for i in range(num_items)]),
        event_time_us=t_us, props={"rating": vals.astype(np.float64)})
    write_s = time.perf_counter() - t0
    if written != nnz:
        raise RuntimeError(f"storage: write_columns wrote {written} of {nnz} events")
    return write_s, rows, cols, num_users, num_items


def storage_replicated(device, smi: str) -> dict:
    """(1) ``bench.py:2485-2640``'s layout, ``pio chaos-ingest --partitions
    4 --replication 2 --ack-quorum 2``: a columnar store with
    ``PARTITIONS``, ``REPLICATION``, ``ACK_QUORUM`` and ``FSYNC``, holding
    ``STG_NNZ`` ML-20M-shaped ratings written as columns; ``pio train``;
    then, with this process's handle closed (a process that opens a
    replicated store writes its followers), ``pio eventserver --stats``
    taking the workflow's bulk delta and its whole retransmit (all
    duplicates): each partition's leader then holds exactly its
    crc32-routed share, ``/stats.json`` has ``partitions`` and
    ``replication`` with every quorum met, ``/readyz`` its
    ``replication`` check; the event server's catch-up seconds."""
    from predictionio_tpu_torch.data.storage.columnar import _ColumnarEvents
    from predictionio_tpu_torch.data.storage.partitioned import partition_of

    t_part = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    P, R = STG_PARTITIONS, STG_REPLICATION
    props = {"PIO_STORAGE_SOURCES_COL_PARTITIONS": str(P), "PIO_STORAGE_SOURCES_COL_REPLICATION": str(R),
             "PIO_STORAGE_SOURCES_COL_ACK_QUORUM": str(STG_ACK_QUORUM), "PIO_STORAGE_SOURCES_COL_FSYNC": "true"}
    with temporary_store("pio-stg-rep-", "columnar", props) as base:
        console_ok("storage", ["app", "new", STG_APP])
        app = Storage.get_meta_data_apps().get_by_name(STG_APP)
        (access_key,) = Storage.get_meta_data_access_keys().get_by_appid(app.id)
        key = access_key.key
        le = Storage.get_l_events()
        if le.partition_count != P or len(le.replication_health()) != P:
            raise RuntimeError(f"storage: the store opened with {le.partition_count} partitions")
        write_s, rows, cols, num_users, num_items = write_ml20m_shaped(app.id, STG_NNZ)
        user_part = np.fromiter((partition_of("user", str(u), P) for u in range(num_users)), np.int64, num_users)
        expected = np.bincount(user_part[rows], minlength=P)
        delta = bulk_delta(rows, cols, num_users, num_items, WF_BULK, seed=21)
        for obj in delta:
            expected[partition_of("user", obj["entityId"], P)] += 1
        del rows, cols
        lines = [(json.dumps(obj) + "\n").encode() for obj in delta]
        engine_json = storage_engine_json(base, STG_APP, WF_RANK, WF_SWEEPS, WF_LAMBDA, WF_SEED)
        trained = storage_train("storage train", STG_APP, engine_json, WF_SWEEPS, WF_RANK, device, dev_args)
        Storage.configure(None)  # closes the store: its catch-up threads stop
        log(f"[storage] replicated: {STG_NNZ} events written as columns in {write_s:.3f} s into {P} partitions x "
            f"{R} replicas (ack quorum {STG_ACK_QUORUM}, fsync); pio train: read {trained['read_s']:.3f} s (cold), "
            f"train:als {trained['train_als_s']:.3f} s, wall {trained['wall_s']:.3f} s, {trained['launches']} "
            f"gj_solve launches (plan {trained['plan']}), rmse {trained['train_rmse']:.6f} (mean rating's "
            f"{trained['mean_rmse']:.6f}) on {smi}")
        es_proc = None
        try:
            t_es = time.perf_counter()
            es_proc, es_port = start_console_server("storage", base, ["eventserver", "--stats", "--drain-deadline-s",
                                                                      "30"], base / "es.stderr", WF_SERVER_TIMEOUT_S)
            es_url = f"http://127.0.0.1:{es_port}"

            def caught_up(since: float) -> tuple:
                """Seconds since ``since`` until the event server's followers
                are in sync (its catch-up replays the leaders' streams;
                report, not gate), and its last ``/stats.json``."""
                while True:
                    _, stats = _http_json(f"{es_url}/stats.json?accessKey={key}")
                    if in_sync(stats.get("replication") or []):
                        return time.perf_counter() - since, stats
                    if time.perf_counter() - since > STG_CATCH_UP_TIMEOUT_S:
                        raise RuntimeError(f"storage: the replicas did not catch up in {STG_CATCH_UP_TIMEOUT_S} s: "
                                           f"{stats.get('replication')}")
                    time.sleep(0.2)

            replay_s, _ = caught_up(t_es)
            t0 = time.perf_counter()
            status, body = _post_bytes(f"{es_url}/events/bulk.json?accessKey={key}", b"".join(lines),
                                       "application/x-ndjson")
            bulk_s = time.perf_counter() - t0
            summary = json.loads(body.splitlines()[-1])
            if status != 200 or not summary.get("ok") or summary["stored"] != len(lines) or summary["duplicates"]:
                raise RuntimeError(f"storage: the bulk POST answered {status} {summary}")
            t0 = time.perf_counter()
            status, body = _post_bytes(f"{es_url}/events/bulk.json?accessKey={key}", b"".join(lines),
                                       "application/x-ndjson")
            resend_s = time.perf_counter() - t0
            resent = json.loads(body.splitlines()[-1])
            if status != 200 or resent["stored"] != 0 or resent["duplicates"] != len(lines):
                raise RuntimeError(f"storage: the retransmit answered {status} {resent}")
            t_sent = time.perf_counter()
            catchup_s, stats = caught_up(t_sent)
            rep = stats.get("replication") or []
            status, ready = http_status(es_url + "/readyz")
            if (stats.get("partitions", {}).get("count") != P or len(rep) != P
                    or not all(r.get("quorumOk") for r in rep) or status != 200
                    or ready["checks"].get("replication", {}).get("ok") is not True):
                raise RuntimeError(f"storage: /stats.json partitions {stats.get('partitions', {}).get('count')}, "
                                   f"replication {rep}; /readyz {status} {ready}; a quorum lost with no replica "
                                   "killed fails the run")
            stop_server("storage eventserver", es_proc)
            es_proc = None
        finally:
            if es_proc is not None:
                es_proc.kill()
                es_proc.wait(timeout=30)
        # each partition's leader, read as a plain stream (no replication threads)
        held = [len(_ColumnarEvents(str(base / "events" / "pio_events" / f"part_{p:02d}" / f"replica_{p % R}"),
                                    STG_NNZ, False).find_columns(app.id)) for p in range(P)]
        if held != expected.tolist():
            raise RuntimeError(f"storage: the partitions hold {held} events, their routed shares are "
                               f"{expected.tolist()}")
        log(f"[storage] replicated: eventserver {len(lines)} events in {bulk_s:.3f} s through /events/bulk.json "
            f"({len(lines) / bulk_s:.1f} events/s), the retransmit all {resent['duplicates']} duplicates in "
            f"{resend_s:.3f} s; the event server's followers in sync {replay_s:.3f} s after its start and "
            f"{catchup_s:.3f} s after the retransmit; the "
            f"leaders hold {held} = their crc32-routed shares; /stats.json partitions.count {P}, every quorum "
            f"met; /readyz 200 with its replication check on {smi}")
        return {"events": STG_NNZ, "partitions": P, "replication": R, "ack_quorum": STG_ACK_QUORUM,
                "write_s": write_s, "cold_read_s": trained["read_s"], "train_als_s": trained["train_als_s"],
                "train_wall_s": trained["wall_s"], "gj_solve_launches": trained["launches"],
                "plan": trained["plan"], "train_rmse": trained["train_rmse"], "mean_rmse": trained["mean_rmse"],
                "bulk_events": len(lines), "bulk_events_per_s": len(lines) / bulk_s, "resend_s": resend_s,
                "duplicates": resent["duplicates"], "replay_s": replay_s, "catchup_s": catchup_s, "held": held,
                "phase_s": time.perf_counter() - t_part}


def storage_followers(device, smi: str) -> dict:
    """(1, served) ``pio deploy --online`` over a ``PARTITIONS=4`` store
    of ``STG_NNZ`` ML-20M-shaped ratings, one follower a partition, under
    the [online] traffic through ``pio eventserver``: every answer 200,
    freshness probes, ``eventsSeen`` = the events stored; the same events
    folded in process."""
    t_part = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    P = STG_PARTITIONS
    with temporary_store("pio-stg-part-", "columnar", {"PIO_STORAGE_SOURCES_COL_PARTITIONS": str(P)}) as base:
        console_ok("storage", ["app", "new", STG_APP])
        app = Storage.get_meta_data_apps().get_by_name(STG_APP)
        (access_key,) = Storage.get_meta_data_access_keys().get_by_appid(app.id)
        write_ml20m_shaped(app.id, STG_NNZ)
        engine_json = storage_engine_json(base, STG_APP, WF_RANK, WF_SWEEPS, WF_LAMBDA, WF_SEED)
        trained = storage_train("storage online train", STG_APP, engine_json, WF_SWEEPS, WF_RANK, device, dev_args)
        user_index, item_index = trained["model"].user_index, trained["model"].item_index
        es_proc = dep_proc = None
        try:
            es_proc, es_port = start_console_server("storage", base, ["eventserver", "--drain-deadline-s", "30"],
                                                    base / "es.stderr", WF_SERVER_TIMEOUT_S)
            es_url = f"http://127.0.0.1:{es_port}"
            # anchored now, as the deploy's followers are
            followers = [TailFollower(STG_APP, state_dir=str(base / "online-check"), partition=p) for p in range(P)]
            t0 = time.perf_counter()
            dep_proc, port = start_console_server(
                "storage", base, ["deploy", "--engine-json", str(engine_json), *dev_args, "--online",
                                  "--online-interval-s", str(ONL_INTERVAL_S), "--online-batch", str(ONL_BATCH)],
                base / "deploy.stderr", QS_DEPLOY_TIMEOUT_S)
            start_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            for u in range(10):
                _http_json(url + "/queries.json", {"user": user_index.inverse(u), "num": TOP_K})
            run = online_traffic(url, es_url, access_key.key, user_index, item_index, True, seed=51)
            accepted = run["ingested"] + run["probe_events"]
            deadline = time.perf_counter() + ONL_CATCH_UP_S
            while True:
                _, dstats = _http_json(url + "/stats.json")
                if dstats["online"]["eventsSeen"] >= accepted or time.perf_counter() > deadline:
                    break
                time.sleep(0.1)
            onl = dstats["online"]
            fr = run["freshness"]
            marks = [w.get("partition") for w in onl.get("watermarks", ())]
            if (onl["eventsSeen"] != accepted or onl["lastError"] or marks != list(range(P)) or fr["timeouts"]
                    or not fr["samples"]):
                raise RuntimeError(f"storage: --online eventsSeen {onl['eventsSeen']} of {accepted} stored, "
                                   f"followers {marks}, lastError {onl['lastError']}, freshness {fr}")
            stop_server("storage deploy", dep_proc)
            dep_proc = None
            stop_server("storage eventserver", es_proc)
            es_proc = None
        finally:
            for p in (dep_proc, es_proc):
                if p is not None:
                    p.kill()
                    p.wait(timeout=30)
        events = [e for f in followers for e in f.poll()]
        if len(events) != accepted:
            raise RuntimeError(f"storage: the partitions hold {len(events)} events of the online run, the event "
                               f"server stored {accepted}")
        fold = fold_rows_check(device, engine_json, trained["instance"], events)
        log(f"[storage] followers: pio deploy --online with {P} followers started in {start_s:.3f} s; "
            f"{run['queries']} queries from {ONL_CLIENTS} keep-alive clients, {run['queries_per_s']:.1f} queries/s, "
            f"p50 {run['p50_ms']:.3f} ms, p99 {run['p99_ms']:.3f} ms, all 200; {run['ingested']} events ingested "
            f"({run['ingest_events_per_s']:.1f} events/s); freshness p50 {fr['p50_s']:.3f} s, max "
            f"{fr['max_s']:.3f} s over {fr['samples']} probes; eventsSeen {onl['eventsSeen']} = {accepted} events "
            f"stored; foldMs p50 {onl['foldMs']['p50']} p95 {onl['foldMs']['p95']}; in process {fold['events']} "
            f"events folded, rows within {fold['worst_rel_err']:.3g} of float64 numpy, launches "
            f"{json.dumps(fold['launches'])}; train launches {trained['launches']} (plan {trained['plan']}) on {smi}")
        return {"events": STG_NNZ, "partitions": P, "gj_solve_launches": trained["launches"], "plan": trained["plan"],
                "deploy_start_s": start_s, "queries_per_s": run["queries_per_s"], "p50_ms": run["p50_ms"],
                "p99_ms": run["p99_ms"], "freshness": fr, "fold_ms": onl["foldMs"], "events_seen": onl["eventsSeen"],
                "accepted": accepted, "fold": fold, "phase_s": time.perf_counter() - t_part}


def storage_remote(device, smi: str) -> dict:
    """(2) All three roles ``TYPE=remote`` on a ``pio storageserver``
    process over sqlite: ``pio import`` of the quickstart's events, ``pio
    train`` (the read paged through the server), ``pio deploy`` reading
    the blob through it and answering float64 numpy's top-10; then
    ``bench.py:1232-1512``'s outage drill: the server killed for
    ``STG_OUTAGE_S`` seconds and restarted on its port while
    ``STG_CLIENTS`` clients query: every answer 200, ``/readyz`` 503 then
    200, a ``/reload`` inside the outage 503 ``degraded``."""
    from predictionio_tpu_torch.data.storage import remote

    t_part = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    srv_base = Path(tempfile.mkdtemp(prefix="pio-stg-srv-"))
    srv, srv_port = start_storage_server(srv_base)
    net = {f"PIO_STORAGE_REPOSITORIES_{role}_SOURCE": "NET" for role in ("METADATA", "EVENTDATA", "MODELDATA")}
    net.update({"PIO_STORAGE_SOURCES_NET_TYPE": "remote", "PIO_STORAGE_SOURCES_NET_HOSTS": "127.0.0.1",
                "PIO_STORAGE_SOURCES_NET_PORTS": str(srv_port),
                "PIO_STORAGE_SOURCES_NET_RETRIES": str(STG_REMOTE_RETRIES),
                "PIO_STORAGE_SOURCES_NET_BREAKER_THRESHOLD": str(STG_BREAKER_THRESHOLD),
                "PIO_STORAGE_SOURCES_NET_BREAKER_RESET_S": str(STG_BREAKER_RESET_S)})
    dep_proc = None
    try:
        with temporary_store("pio-stg-remote-", "sqlite", net) as base:
            console_ok("storage remote", ["app", "new", STG_REMOTE_APP])
            users, items, ratings, stamps = synthesize_ml100k(42)
            write_ndjson(base / "events.json", (
                {"event": "rate", "entityType": "user", "entityId": str(u), "targetEntityType": "item",
                 "targetEntityId": str(i), "properties": {"rating": float(r)},
                 "eventTime": format_event_time(dt.datetime.fromtimestamp(t, dt.timezone.utc))}
                for u, i, r, t in zip(users.tolist(), items.tolist(), ratings.tolist(), stamps.tolist())))
            import_s = console_ok("storage remote", ["import", "--appname", STG_REMOTE_APP, "--input",
                                                     str(base / "events.json")])
            engine_json = storage_engine_json(base, STG_REMOTE_APP, QS_RANK, QS_SWEEPS, 0.01, 3)
            pages = []
            call = remote._Rpc.call

            def counted(self, repo, method, *args, **kw):
                if method == "find_page":
                    pages.append(1)
                return call(self, repo, method, *args, **kw)

            remote._Rpc.call = counted
            try:
                trained = storage_train("storage remote train", STG_REMOTE_APP, engine_json, QS_SWEEPS, QS_RANK,
                                        device, dev_args)
            finally:
                remote._Rpc.call = call
            train_pages = len(pages) // 2  # the train's read, then the plan's full read
            model, U64, V64 = trained["model"], trained["U64"], trained["V64"]
            log(f"[storage] remote: pio import {users.size} events in {import_s:.3f} s through the storage server; "
                f"pio train read {trained['read_s']:.3f} s in {train_pages} pages, train:als "
                f"{trained['train_als_s']:.3f} s, {trained['launches']} gj_solve launches (plan {trained['plan']}), "
                f"rmse {trained['train_rmse']:.6f} on {smi}")

            t0 = time.perf_counter()
            dep_proc, port = start_console_server("storage remote", base, ["deploy", "--engine-json",
                                                                             str(engine_json), *dev_args],
                                                  base / "deploy.stderr", QS_DEPLOY_TIMEOUT_S)
            start_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            picks = np.random.default_rng(13).choice(len(model.user_index), QUERIES, replace=False)
            check_answers("storage remote deploy", ok_answers("storage remote deploy", run_load(
                url, picks, model.user_index, 1, TOP_K)), U64, V64, model.item_index, TOP_K)
            if http_status(url + "/readyz")[0] != 200:
                raise RuntimeError("storage: the remote deploy is not ready before the outage")

            # the outage drill
            stop = threading.Event()
            box: dict = {}
            loader = threading.Thread(target=lambda: box.update(run_load(
                url, np.zeros(0, np.int64), model.user_index, STG_CLIENTS, TOP_K, stop=stop, seed=61)), daemon=True)
            loader.start()
            time.sleep(1.0)
            t_down = time.perf_counter()
            stop_server("storage server", srv, signal.SIGKILL)
            unready_s = None
            while time.perf_counter() - t_down < STG_OUTAGE_S + 10:
                if http_status(url + "/readyz")[0] == 503:
                    unready_s = time.perf_counter() - t_down
                    break
                time.sleep(0.05)
            reload_status, reload_body = http_status(url + "/reload", {})
            time.sleep(max(0.0, STG_OUTAGE_S - (time.perf_counter() - t_down)))
            srv, _ = start_storage_server(srv_base, srv_port)
            t_up = time.perf_counter()
            recovered_s = None
            while time.perf_counter() - t_up < STG_RECOVER_TIMEOUT_S:
                if http_status(url + "/readyz")[0] == 200:
                    recovered_s = time.perf_counter() - t_up
                    break
                time.sleep(0.05)
            time.sleep(0.5)
            stop.set()
            loader.join(timeout=120)
            load = box
            answers = ok_answers("storage outage", load)
            check_answers("storage outage", answers, U64, V64, model.item_index, TOP_K)
            inside = sum(1 for _, _, _, start, _ in load["records"] if t_down <= start < t_up)
            _, root = _http_json(url + "/")
            if (unready_s is None or recovered_s is None or reload_status != 503
                    or reload_body.get("degraded") is not True or root.get("engineInstanceId") != trained["instance"].id):
                raise RuntimeError(f"storage: outage drill: /readyz 503 after {unready_s} s, 200 again after "
                                   f"{recovered_s} s; /reload {reload_status} {reload_body}; GET / {root}")
            stop_server("storage remote deploy", dep_proc)
            dep_proc = None
            log(f"[storage] remote: pio deploy started in {start_s:.3f} s, {QUERIES} answers float64 numpy's "
                f"top-{TOP_K}; outage {t_up - t_down:.3f} s: /readyz 503 after {unready_s:.3f} s, 200 again "
                f"{recovered_s:.3f} s after the restart; /reload inside it 503 degraded; {load['queries']} queries "
                f"from {STG_CLIENTS} clients all 200 and float64 numpy's top-{TOP_K}, {inside} inside the outage "
                f"({inside / (t_up - t_down):.1f} queries/s) on {smi}")
            return {"events": int(users.size), "import_s": import_s, "read_s": trained["read_s"],
                    "pages": train_pages, "train_als_s": trained["train_als_s"],
                    "gj_solve_launches": trained["launches"], "plan": trained["plan"],
                    "train_rmse": trained["train_rmse"], "deploy_start_s": start_s, "unready_s": unready_s,
                    "recovered_s": recovered_s, "outage_s": t_up - t_down, "queries": load["queries"],
                    "goodput_in_outage_qps": inside / (t_up - t_down), "reload_status": reload_status,
                    "phase_s": time.perf_counter() - t_part}
    finally:
        if dep_proc is not None:
            dep_proc.kill()
            dep_proc.wait(timeout=30)
        stop_server("storage server", srv)
        shutil.rmtree(srv_base, ignore_errors=True)


def storage_sharedfs(device, smi: str) -> dict:
    """(3) ``MODELDATA`` on a ``TYPE=sharedfs`` path: ``pio train`` in one
    process, ``pio deploy`` in another with its own registry onto the
    path, answering float64 numpy's top-10 of the blob a fresh driver
    reads there."""
    from predictionio_tpu_torch.data.storage.base import StorageClientConfig
    from predictionio_tpu_torch.data.storage.sharedfs import StorageClient as SharedFsClient

    t_part = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    names = ("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "PIO_STORAGE_SOURCES_SHARED_TYPE",
             "PIO_STORAGE_SOURCES_SHARED_PATH")
    with temporary_store("pio-stg-shared-", "columnar") as base, saved_env(*names):
        shared = base / "shared-models"
        os.environ.update(dict(zip(names, ("SHARED", "sharedfs", str(shared)))))
        Storage.configure(None)
        console_ok("storage sharedfs", ["app", "new", STG_SHARED_APP])
        app = Storage.get_meta_data_apps().get_by_name(STG_SHARED_APP)
        users, items, ratings, _ = synthesize_ml100k(42)
        uv, uc = np.unique(users, return_inverse=True)
        iv, ic = np.unique(items, return_inverse=True)
        Storage.get_p_events().write_columns(
            app.id, event="rate", entity_type="user", entity_codes=uc, entity_vocab=uv.astype(str),
            target_entity_type="item", target_codes=ic, target_vocab=iv.astype(str),
            event_time_us=np.full(users.size, 1_600_000_000_000_000, np.int64),
            props={"rating": ratings.astype(np.float64)})
        engine_json = storage_engine_json(base, STG_SHARED_APP, QS_RANK, QS_SWEEPS, 0.01, 3)
        root = str(Path(__file__).resolve().parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.console", "train", "--engine-json",
                               str(engine_json), *dev_args], cwd=root, env=env, capture_output=True, text=True,
                              timeout=QS_DEPLOY_TIMEOUT_S)
        train_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"storage sharedfs: pio train exited {proc.returncode}: {proc.stderr[-2000:]}")
        instance = max(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
        fresh = SharedFsClient(StorageClientConfig("S2", "sharedfs", {"path": str(shared)}))
        (kind, model), = loads_model(fresh.get_models().get(instance.id).models)
        blobs = sorted(p.name for p in shared.iterdir())
        U64, V64 = np.asarray(model.user_factors, np.float64), np.asarray(model.item_factors, np.float64)
        served = deploy_and_query("storage sharedfs", base, engine_json, dev_args, instance.id,
                                  (model.user_index, model.item_index), U64, V64, None, QUERIES, TOP_K, 17, device)
        log(f"[storage] sharedfs: pio train in its own process {train_s:.3f} s, the blob {blobs} read by a fresh "
            f"sharedfs driver; pio deploy in another started in {served['deploy_start_s']:.3f} s, {QUERIES} answers "
            f"float64 numpy's top-{TOP_K}, p50 {served['p50_ms']:.3f} ms on {smi}")
        return {"train_s": train_s, "deploy_start_s": served["deploy_start_s"], "p50_ms": served["p50_ms"],
                "blobs": len(blobs), "phase_s": time.perf_counter() - t_part}


def phase_storage(device, smi: str) -> dict:
    """The distributed storage drivers: the partitioned, quorum-replicated
    columnar store, one online follower a partition, ``TYPE=remote`` on
    ``pio storageserver`` and a ``TYPE=sharedfs`` model mount
    (:func:`storage_replicated`, :func:`storage_followers`,
    :func:`storage_remote`, :func:`storage_sharedfs`)."""
    t_phase = time.perf_counter()
    out = {"replicated": storage_replicated(device, smi), "followers": storage_followers(device, smi),
           "remote": storage_remote(device, smi), "sharedfs": storage_sharedfs(device, smi)}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[storage] {json.dumps(out)}")
    log(f"[timing] storage {out['phase_s']:.1f} s in a child process beside the workflow's phases")
    return out


def marked_alive(value: str) -> list:
    """Live (not zombie) processes whose environment holds
    ``CHAOS_MARK=value``, as command lines."""
    mark = f"{CHAOS_MARK}={value}".encode()
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and _marked(int(entry), mark):
            found.append(f"{entry} {_cmdline(int(entry))}")
    return found


def run_drill(label: str, argv: list) -> dict:
    """One drill through the port's console (``python -m
    predictionio_tpu_torch.tools.console <argv>``), every process it
    starts marked with a fresh ``CHAOS_MARK``: its JSON report, its
    seconds, and the marked processes still alive once it has returned
    (the drills end every process they start)."""
    root = str(Path(__file__).resolve().parent)
    value = f"{label}-{os.getpid()}-{time.time_ns()}"
    env = dict(os.environ, **{CHAOS_MARK: value},
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.console", *argv], cwd=root, env=env,
                          capture_output=True, text=True, timeout=CHAOS_DRILL_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    alive = marked_alive(value)
    try:
        report = json.loads(proc.stdout[proc.stdout.index("{"):])
    except ValueError:
        raise RuntimeError(f"chaos {label}: rc {proc.returncode}, no report; stderr: {proc.stderr[-3000:]}") from None
    return {"report": report, "rc": proc.returncode, "seconds": seconds, "alive": alive}


def _p99s(report: dict) -> list:
    kill = report.get("kill") or {}
    return [(kill.get("baselineWindow") or {}).get("p99Ms"), (kill.get("recoveredWindow") or {}).get("p99Ms")]


def chaos_faults(label: str, run: dict) -> list:
    """What fails the run in one drill's report: ``ok`` false, a failed
    query in a kill or rolling window, a cross-generation answer, a
    serve-time compile in the AOT rotation, a partition not caught up, a
    process left alive. A serving drill's ``ok`` is read term by term
    (``verdicts``): every term but ``throughputScales`` fails the run.
    That one (the reference's ≥ 1.5× queries/s at 2 replicas on a
    multi-core host) is printed instead: the drill's 16 in-process
    clients and its one router process cap both fleet sizes near one
    rate in both packages (ROADMAP.md queue 3, "The serving drill's
    scaling gate")."""
    r = run["report"]
    if r.get("ok") is not True:
        log(f"[chaos] {label} report: {json.dumps(r)}")
    verdicts = r.get("verdicts")
    if verdicts is not None and "error" not in r:
        failed = [name for name, held in verdicts.items() if not held and name != "throughputScales"]
        faults = [f"verdicts not held: {failed}"] if failed else []
        if not verdicts.get("throughputScales"):
            log(f"[chaos] {label}: the reference's scaling gate not met, a property of the reference and not a "
                f"failure of this run: {json.dumps((r.get('throughput') or {}).get('points'))}, "
                f"scaling {r['throughput'].get('scaling')}")
        elif run["rc"] != 0:
            faults.append(f"rc {run['rc']} with every verdict held")
    else:
        faults = [] if r.get("ok") is True and run["rc"] == 0 else [f"ok {r.get('ok')}, rc {run['rc']}: {r.get('error')}"]
    for phase in ("kill", "rolling"):
        if phase in r and r[phase].get("failedQueries") != 0:
            faults.append(f"{r[phase].get('failedQueries')} failed queries in the {phase} window")
    if "rolling" in r and r["rolling"].get("crossGenerationViolations") != 0:
        faults.append(f"{r['rolling'].get('crossGenerationViolations')} cross-generation answers")
    if r.get("aot") and (r.get("rolling", {}).get("aot") or {}).get("serveTimeCompiles") != 0:
        faults.append(f"the AOT rotation compiled at serve time: {r.get('rolling', {}).get('aot')}")
    for phase in ("hostKill", "autoscale"):
        if phase in r and r[phase].get("failedQueries") != 0:
            faults.append(f"{r[phase].get('failedQueries')} failed queries in {phase}")
    part = r.get("partitioned")
    if label == "ingest-partitioned" and not (part and part.get("killedPartitionCaughtUp")
                                              and part.get("replicaCatchUp") and part.get("ackedLost") == 0
                                              and part.get("duplicates") == 0):
        faults.append(f"the killed partition or replica did not catch up clean: {part}")
    if run["alive"]:
        faults.append(f"processes alive after the drill: {run['alive']}")
    return faults


def chaos_headline(label: str, run: dict) -> dict:
    """The numbers a ``[chaos]`` line prints for one drill."""
    r = run["report"]
    out = {"drill": label, "ok": r.get("ok"), "seconds": run["seconds"], "alive": len(run["alive"])}
    if label.startswith("ingest"):
        out.update(acked=r.get("ackedTotal"), acked_lost=r.get("ackedLost"), duplicates=r.get("duplicates"),
                   recovery_s=r.get("recoverySeconds"), drain_exit=(r.get("drain") or {}).get("exitCode"))
        if "partitioned" in r:
            part = r["partitioned"]
            out.update({key: part.get(key) for key in (
                "ackedLost", "duplicates", "killedPartitionPresent", "killedPartitionExpected",
                "killedPartitionCaughtUp", "replicaCatchUp", "recoverySeconds")})
    elif label.startswith("serve"):
        kill, rolling = r.get("kill") or {}, r.get("rolling") or {}
        out.update(
            failed_queries={"kill": kill.get("failedQueries"), "rolling": rolling.get("failedQueries")},
            respawn_s=[k.get("respawnSeconds") for k in kill.get("kills", [])],
            p99_ms_before_after=_p99s(r), cross_generation=rolling.get("crossGenerationViolations"),
            qps_by_replicas={p["replicas"]: p["qps"] for p in (r.get("throughput") or {}).get("points", [])},
            scaling=(r.get("throughput") or {}).get("scaling"), setup_s=r.get("setupSeconds"))
        if r.get("aot"):
            out["aot_serve_time_compiles"] = (rolling.get("aot") or {}).get("serveTimeCompiles")
        if "shardedReplica" in r:
            out["sharded"] = {k: r["shardedReplica"].get(k) for k in ("qps", "failed", "factorShards", "note")}
    else:
        host = r.get("hostKill") or {}
        out.update(
            failed_queries={"hostKill": host.get("failedQueries"),
                            "autoscale": (r.get("autoscale") or {}).get("failedQueries")},
            absorb_s=host.get("absorbSeconds"), evict_s=host.get("evictSeconds"), rejoin_s=host.get("rejoinSeconds"),
            router_failovers=host.get("routerFailovers"), p99_ms=(host.get("overall") or {}).get("p99Ms"),
            qps=(host.get("overall") or {}).get("qps"),
            scale_up_s=(r.get("autoscale") or {}).get("scaleUpSeconds"),
            scale_down_s=(r.get("autoscale") or {}).get("scaleDownSeconds"),
            stale_ok=(r.get("staleWhileDown") or {}).get("ok"), setup_s=r.get("setupSeconds"))
    return out


def chaos_train(device, base: str) -> dict:
    """The drills' ``pio train`` in this process on the kept store of
    ``serve-sharded`` (its engine.json and events): the solves all at
    K = ``CHAOS_RANK``, ``gj_solve`` launched = the plan of the
    TrainingData the drill's DataSource reads. The drills' own trains run
    the same engine.json on the same events in a subprocess, where this
    script cannot count."""
    from predictionio_tpu_torch.resilience import chaos
    from predictionio_tpu_torch.templates.recommendation.engine import DataSourceParams, RecommendationDataSource

    env = {k: v for k, v in chaos._storage_env(base, "sqlite").items() if k.startswith("PIO_")}
    Storage.configure(env)
    try:
        td = RecommendationDataSource(DataSourceParams(app_name=CHAOS_APP)).read_training(local_context(device))
        cfg = ALSConfig(rank=CHAOS_RANK)
        plan = CHAOS_ITERATIONS * (planned_solves(td.rows, len(td.user_index), cfg)
                                   + planned_solves(td.cols, len(td.item_index), cfg))
        shapes: list = []
        with recorded_solves(shapes):
            reset_launch_counts()
            train_s = console_ok("chaos train", ["train", "--engine-json", os.path.join(base, "engine.json"),
                                                 "--mesh", "none", "--device", device.type])
            launches = read_launch_counts()
    finally:
        Storage.configure(None)
    widths = sorted({k for _, k in shapes})
    if widths != [CHAOS_RANK] or len(shapes) != plan:
        raise RuntimeError(f"chaos train: {len(shapes)} solves at K {widths}, the plan says {plan} at K {CHAOS_RANK}")
    if device.type == "cuda":
        check_launches("chaos-train", launches, {"gj_solve": plan})
    return {"ratings": int(td.rows.size), "solves": len(shapes), "k": CHAOS_RANK, "launches": launches["gj_solve"],
            "plan": plan, "batch_max": max(b for b, _ in shapes), "train_s": train_s}


def phase_chaos(device, smi: str, *drills: int) -> dict:
    """The operator's drills ``CHAOS_DRILLS[i]`` for each ``i`` of
    ``drills``, in that order, through the port's console, each report
    held to its verdicts (:func:`chaos_faults`); after ``serve-sharded``
    the drills' train in this process (:func:`chaos_train`). ``[chaos]``
    lines."""
    t_phase = time.perf_counter()
    out: dict = {"drills": {}}
    faults = []
    kept = None
    try:
        for label, argv in (CHAOS_DRILLS[i] for i in drills):
            if not label.startswith("ingest"):
                argv = [*argv, "--device", device.type]
            run = run_drill(label, argv)
            if "--keep" in argv:
                kept = run["report"].get("storageDir")
            head = chaos_headline(label, run)
            log(f"[chaos] {json.dumps(head)} on {smi}")
            out["drills"][label] = head
            faults += [f"{label}: {f}" for f in chaos_faults(label, run)]
        if faults:
            raise RuntimeError(f"chaos: {faults}")
        if kept:
            out["train"] = chaos_train(device, kept)
            log(f"[chaos] train in process on the drills' store: {json.dumps(out['train'])}")
    finally:
        if kept:
            shutil.rmtree(kept, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[timing] chaos {', '.join(out['drills'])} {out['phase_s']:.1f} s in a child process")
    return out


CHILD_PHASES = """\
import json, os, sys, torch, chip_smoke as c
name, device, smi, path = sys.argv[1], torch.device(sys.argv[2]), sys.argv[3], sys.argv[4]
os.nice(int(sys.argv[5]))
out = getattr(c, name)(device, smi, *(int(a) for a in sys.argv[6:]))
with open(path, "w") as fh:
    json.dump(out, fh, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o))
"""


def phase_quickstart_group(device, smi: str) -> dict:
    """The quickstart, the grid and the A/B fleet on its store, then the
    bandit loop."""
    qs = phase_quickstart(device, QUERIES, TOP_K, smi,
                          then=lambda ctx: (phase_grid(device, ctx, smi), phase_fleet_ab(device, ctx, smi)))
    return {"qs": qs, "loop": phase_explore_loop(device, smi)}


def phase_tt_group(device, smi: str) -> dict:
    """The Two-Tower quickstart, then on its store its serving tiers and
    its AOT serving (``"serving"``: the five phases' outputs)."""
    def on_store(ctx: dict) -> tuple:
        return (phase_tt_serving(device, ctx, SRV_TT_CLIENTS, SRV_TT_REQUESTS, TOP_K, smi),
                phase_tt_online(device, ctx, smi), phase_tt_ann(device, ctx, smi),
                phase_tt_sharded(device, ctx, smi), phase_tt_aot(device, ctx, smi))

    out = phase_tt_quickstart(device, TTQ_NNZ, TT_DIM, TT_BATCH, TT_EPOCHS, QUERIES, TOP_K, smi, then=on_store)
    out["wide"] = phase_tt_wide(device, smi)
    return out


def phase_tt_wide(device, smi: str) -> dict:
    """``TT_WIDE_EPOCHS`` Two-Tower epoch at ``TT_WIDE_DIM``, past the
    fused-CE kernels' full-width path, on the path's pairs and batch:
    ``fused_ce="auto"`` launches the kernels as planned (one forward, two
    backward a step), and every logged loss is within ``TT_WIDE_LOSS_RTOL``
    of the same epoch with ``fused_ce="off"`` from the same draw."""
    t_phase = time.perf_counter()
    td, _, _, num_items = tt_training_data(TT_NNZ)
    num_users = len(td.user_index)
    cfg = TwoTowerConfig(dim=TT_WIDE_DIM, batch_size=TT_BATCH, epochs=TT_WIDE_EPOCHS, learning_rate=0.05,
                         temperature=1.0 / TT_INV_TEMP, seed=2, fused_ce="auto")
    steps = TT_WIDE_EPOCHS * -(-td.rows.size // TT_BATCH)
    runs = {}
    for mode in ("auto", "off"):
        reset_launch_counts()
        t0 = time.perf_counter()
        model = train_two_tower(td.rows, td.cols, num_users, num_items, dataclasses.replace(cfg, fused_ce=mode),
                                device=device)
        runs[mode] = (model, time.perf_counter() - t0, read_launch_counts())
    fused, off = runs["auto"][0], runs["off"][0]
    check_launches("tt-wide", runs["auto"][2], {"fused_ce_fwd": steps, "fused_ce_bwd": 2 * steps})
    if any(runs["off"][2].values()):
        raise RuntimeError(f"tt-wide: fused_ce=\"off\" launched kernels {runs['off'][2]}")
    if [s for s, _ in fused.loss_history] != [s for s, _ in off.loss_history]:
        raise RuntimeError("tt-wide: the logged steps differ")
    loss_rel = max(abs(a - b) / max(1.0, abs(b)) for (_, a), (_, b) in zip(fused.loss_history, off.loss_history))
    if not (np.isfinite(fused.user_vecs).all() and np.isfinite(fused.item_vecs).all()):
        raise RuntimeError("tt-wide: non-finite towers")
    out = {"dim": TT_WIDE_DIM, "batch": TT_BATCH, "pairs": int(td.rows.size), "steps": steps,
           "launches": {k: v for k, v in runs["auto"][2].items() if v}, "loss_first": fused.loss_history[0][1],
           "loss_last": fused.loss_history[-1][1], "loss_rel_vs_off": loss_rel, "train_s": runs["auto"][1],
           "off_train_s": runs["off"][1], "phase_s": time.perf_counter() - t_phase, "card": smi}
    log(f"[tt-wide] {json.dumps(out)}")
    if not loss_rel <= TT_WIDE_LOSS_RTOL:
        raise RuntimeError(f"tt-wide: losses {fused.loss_history} against the unfused {off.loss_history}")
    return out


def phase_sweeps(device, smi: str) -> dict:
    """The JAX bench's IVF and int8 sweeps, its sharded sweep and what
    ``score_rows`` costs, each path held to 0 kernel launches."""
    out = {}
    for label, run in (("ann", lambda: {"ann_sweep": phase_ann_sweep(device, smi)}),
                       ("sharded", lambda: {"shd_sweep": phase_sharded_sweep(device, smi),
                                            "score_cost": phase_score_cost(device, smi)})):
        reset_launch_counts()
        out.update(run())
        launches = read_launch_counts()
        if any(launches.values()):
            raise RuntimeError(f"{label}: the sweeps launched kernels {launches}; their path has none")
        log(f"[{label}] launches on the sweeps' path: {json.dumps(launches)}; {torch.cuda.device_count()} card(s)")
    return out


#: [tooling]: the analysis package over the quickstart's data at rank 64
#: (its store, QS_SWEEPS sweeps) and a batchpredict of TOOL_QUERIES of its
#: users; the child's time limit
TOOL_QUERIES = 2_000
TOOL_CHILD_TIMEOUT_S = 600


def _console_quiet(argv: list) -> tuple:
    """``console.main(argv)`` with its standard output kept; returns the
    exit code, the seconds and the output."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = console.main(argv)
    return rc, time.perf_counter() - t0, buf.getvalue()


def _lint_json(label: str, argv: list) -> tuple:
    """``pio lint --format json ARGV``: its JSON document and seconds;
    raises unless it exits 0 with a clean tree."""
    rc, seconds, out = _console_quiet(["lint", "--format", "json", *argv])
    doc = json.loads(out)
    if rc != 0 or not doc["ok"] or doc["newFindings"]:
        raise RuntimeError(f"{label}: pio lint exited {rc}: {json.dumps(doc)[:3000]}")
    return doc, seconds


def phase_tooling(device, smi: str) -> dict:
    """[tooling]: the port's ``pio lint``, ``pio jitwitness`` and ``pio
    tsan`` (``predictionio_tpu_torch/analysis``) over the quickstart's data
    in a store of their own: a rank-64 ``pio train`` and a ``pio
    batchpredict``, each once plain and once witnessed, on ``device``.
    Fails unless the lint is clean, the witnessed train launches the solve
    its plan's number of times, the witnessed commands compile what the
    plain ones do and batchpredict writes the same bytes, no compile budget
    is exceeded, nothing constructs a compiled program per call, no lock
    order inverts, and every witnessed lock order is a static edge with
    no unwaived static cycle."""
    from predictionio_tpu_torch.analysis.jit_witness import compile_counts
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
        RecommendationDataSource,
    )

    t_phase = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    out: dict = {"card": smi}
    with temporary_store("pio-tooling-") as base:
        console_ok("tooling", ["app", "new", QS_APP])
        users, items, ratings, stamps = synthesize_ml100k(42)
        events = base / "events.json"
        write_ndjson(events, (
            {"event": "rate", "entityType": "user", "entityId": str(u), "targetEntityType": "item",
             "targetEntityId": str(i), "properties": {"rating": float(r)},
             "eventTime": format_event_time(dt.datetime.fromtimestamp(t, dt.timezone.utc))}
            for u, i, r, t in zip(users.tolist(), items.tolist(), ratings.tolist(), stamps.tolist())
        ))
        console_ok("tooling", ["import", "--appname", QS_APP, "--input", str(events)])
        engine_json = base / "engine.json"
        engine_json.write_text(json.dumps({
            "id": QS_APP, "version": "1", "engineFactory": QS_FACTORY,
            "datasource": {"params": {"appName": QS_APP}},
            "algorithms": [{"name": "als", "params": {
                "rank": QS_RANK, "numIterations": QS_SWEEPS, "lambda": 0.01, "seed": 3}}],
        }))
        td = RecommendationDataSource(DataSourceParams(app_name=QS_APP)).read_training(local_context(device))
        cfg = ALSConfig(rank=QS_RANK)
        plan = QS_SWEEPS * (planned_solves(td.rows, len(td.user_index), cfg)
                            + planned_solves(td.cols, len(td.item_index), cfg))
        train_argv = ["train", "--engine-json", str(engine_json), *dev_args]

        def run(argv: list) -> dict:
            """One console command: its exit code, seconds, solve launches,
            the process's compiles by kind over it, and the newest instance."""
            before = compile_counts()
            reset_launch_counts()
            rc, seconds, _ = _console_quiet(argv)
            launches = read_launch_counts()
            after = compile_counts()
            if rc != 0:
                raise RuntimeError(f"tooling: {' '.join(argv[:3])} exited {rc}")
            instances = sorted(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
            return {"s": seconds, "launches": launches["gj_solve"], "instance": instances[-1],
                    "compiles": {k: after[k] - before[k] for k in after}}

        def timings(instance) -> dict:
            t = json.loads(instance.env["phase_timings"])
            return {"read_s": t["read"], "train_als_s": t["train:als"]}

        # 1. pio train: plain (the process's first, cold), then legs
        # under pio jitwitness and plain in turns (W P P W)
        first = run(train_argv)
        legs = []
        for n, witness in enumerate((True, False, False, True)):
            path = base / f"jw-train-{n}.json"
            got = run(["jitwitness", "--report", str(path), "--", *train_argv] if witness else train_argv)
            got["report"] = json.loads(path.read_text()) if witness else None
            legs.append(got)
        witnessed, plain = legs[0], legs[1]
        jw = witnessed["report"]
        for n, got in enumerate([first, *legs]):
            if device.type == "cuda":
                check_launches(f"tooling train {n}", {"gj_solve": got["launches"]}, {"gj_solve": plan})
            if got["compiles"] != first["compiles"]:
                raise RuntimeError(f"tooling: train {n} compiled {got['compiles']}, the first {first['compiles']}")
            rep = got.get("report")
            if rep is not None and (rep["exitCode"] != 0 or not rep["ok"] or rep["budget"]["violations"]
                                    or rep["witness"]["totalConstructions"]):
                raise RuntimeError(f"tooling: pio jitwitness -- train: {json.dumps(rep['budget'])}, "
                                   f"constructions {rep['witness']['jitConstructions']}")
        wrep = jw["witness"]
        fm, pm, wm = (stored_model(r["instance"].id) for r in (first, plain, witnessed))

        def factor_diff(a, b) -> float:
            return max(float(np.abs(np.asarray(a.user_factors) - np.asarray(b.user_factors)).max()),
                       float(np.abs(np.asarray(a.item_factors) - np.asarray(b.item_factors)).max()))

        def side(witness: bool, key: str) -> list:
            return [timings(g["instance"])[key] for g in legs if (g["report"] is not None) == witness]

        out["train"] = {
            "plan": plan, "launches_plain": plain["launches"], "launches_witnessed": witnessed["launches"],
            "compiles_plain": plain["compiles"], "compiles_witnessed": witnessed["compiles"],
            "compiles_by_site": {k: {"count": v["count"], "kinds": v["kinds"], "ms": v["totalCompileMs"]}
                                 for k, v in wrep["compiles"].items()},
            "transfers_by_site": {k: {"count": v["count"], "bytes": v["bytes"], "kinds": v["kinds"]}
                                  for k, v in wrep["transfers"].items()},
            "transfers": wrep["totalTransfers"], "transfer_bytes": wrep["totalTransferBytes"],
            "constructions": wrep["totalConstructions"], "unbudgeted": jw["budget"]["unbudgeted"],
            "static_findings": len(jw["staticCompileFindings"]),
            "first": timings(first["instance"]),
            # the legs in turns, W P P W: the engine's train:als seconds,
            # and the command's (witnessed: the nested command alone)
            "train_als_s_plain": side(False, "train_als_s"), "train_als_s_witnessed": side(True, "train_als_s"),
            "command_s_plain": [g["s"] for g in legs if g["report"] is None],
            "command_s_witnessed": [g["report"]["commandSeconds"] for g in legs if g["report"] is not None],
            # ALS on the card is not bitwise repeatable (index_add_'s
            # atomics): the witnessed train's distance to a plain one
            # beside two plain trains' own
            "factor_max_abs_diff_plain_plain": factor_diff(fm, pm),
            "factor_max_abs_diff_plain_witnessed": factor_diff(pm, wm),
        }

        # 2. pio batchpredict of the witnessed train's instance, plain and witnessed
        picks = load_picks(TOOL_QUERIES, len(td.user_index), seed=37)
        queries = base / "tool-queries.json"
        write_ndjson(queries, ({"user": td.user_index.inverse(u), "num": TOP_K} for u in picks.tolist()))
        instance_id = witnessed["instance"].id

        def bp_argv(name: str) -> list:
            return ["batchpredict", "--engine-json", str(engine_json), "--input", str(queries),
                    "--output", str(base / name), "--engine-instance-id", instance_id, *dev_args]

        bp_plain = run(bp_argv("bp-plain.json"))
        jwb_path = base / "jw-batchpredict.json"
        bp_wit = run(["jitwitness", "--report", str(jwb_path), "--", *bp_argv("bp-witnessed.json")])
        jwb = json.loads(jwb_path.read_text())
        plain_bytes, wit_bytes = (base / "bp-plain.json").read_bytes(), (base / "bp-witnessed.json").read_bytes()
        if plain_bytes != wit_bytes or plain_bytes.count(b"\n") != TOOL_QUERIES:
            raise RuntimeError(f"tooling: batchpredict under the witness wrote other bytes "
                               f"({len(wit_bytes)} against {len(plain_bytes)})")
        if bp_wit["compiles"] != bp_plain["compiles"]:
            raise RuntimeError(f"tooling: the witnessed batchpredict compiled {bp_wit['compiles']}, "
                               f"the plain one {bp_plain['compiles']}")
        brep = jwb["witness"]
        if jwb["exitCode"] != 0 or not jwb["ok"] or jwb["budget"]["violations"] or brep["totalConstructions"]:
            raise RuntimeError(f"tooling: pio jitwitness -- batchpredict: {json.dumps(jwb['budget'])}, "
                               f"constructions {brep['jitConstructions']}")
        out["batchpredict"] = {
            "queries": TOOL_QUERIES, "byte_equal": True, "bytes": len(plain_bytes),
            "compiles_plain": bp_plain["compiles"], "compiles_witnessed": bp_wit["compiles"],
            "transfers_by_site": {k: {"count": v["count"], "bytes": v["bytes"], "kinds": v["kinds"]}
                                  for k, v in brep["transfers"].items()},
            "transfers": brep["totalTransfers"], "transfer_bytes": brep["totalTransferBytes"],
            "constructions": brep["totalConstructions"], "violations": len(jwb["budget"]["violations"]),
            "wall_s_plain": bp_plain["s"], "wall_s_witnessed": bp_wit["s"], "command_s_witnessed": jwb["commandSeconds"],
        }

        # 3. pio tsan over both, then pio lint --witness of each report
        tsan = {}
        for label, argv in (("batchpredict", bp_argv("bp-tsan.json")), ("train", train_argv)):
            path = base / f"tsan-{label}.json"
            got = run(["tsan", "--report", str(path), "--", *argv])
            rep = json.loads(path.read_text())
            if label == "train" and device.type == "cuda":
                check_launches("tooling tsan train", {"gj_solve": got["launches"]}, {"gj_solve": plan})
            if rep["exitCode"] != 0 or not rep["ok"] or rep["witness"]["inversions"]:
                raise RuntimeError(f"tooling: pio tsan -- {label}: inversions {rep['witness']['inversions']}")
            lint, lint_s = _lint_json(f"tooling lint --witness {label}", ["--witness", str(path)])
            cc = lint["witnessCrosscheck"]
            if cc["gaps"] or cc["unwaivedStaticCycles"]:
                raise RuntimeError(f"tooling: lint --witness {label}: {json.dumps(cc)[:3000]}")
            tsan[label] = {
                "wall_s": got["s"], "command_s": rep["commandSeconds"], "locks": len(rep["witness"]["locks"]),
                "edges": len(rep["witness"]["edges"]), "inversions": 0,
                "long_holds": sum(v["longHolds"] for v in rep["witness"]["locks"].values()),
                "sleeps_under_lock": len(rep["witness"]["sleepsUnderLock"]),
                "renames": len(rep["witness"]["fsync"]["renames"]),
                "static_cycles": len(rep["staticLockCycles"]),
                "gaps": 0, "unmapped_edges": len(cc["unmappedEdges"]), "unwaived_cycles": 0,
                "static_edges": cc["staticEdges"],
                "lint": {"ok": lint["ok"], "files": lint["filesScanned"], "findings": len(lint["newFindings"]),
                         "seconds": lint_s},
            }
        out["tsan"] = tsan
        out["lint"] = tsan["batchpredict"]["lint"]
    out["entry"] = tooling_entry(device, smi)
    out["dryrun"] = tooling_dryrun(device, smi)
    out["launchers"] = tooling_launchers(device, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[tooling] {json.dumps(out)}")
    return out


#: [entry]: the forward's calls timed after a warm-up; [dryrun]: the mesh's
#: positions (every one the card)
ENTRY_CALLS = 20
DRYRUN_POSITIONS = 8


def tooling_entry(device, smi: str) -> dict:
    """[entry]: ``__graft_entry_torch__.entry()`` on ``device`` (the card by
    default): its outputs' device, its top-10 ids against a float64 numpy
    top-10 of the same arrays (near-tie rule, relative 1e-5), and the
    forward's p50 over ``ENTRY_CALLS`` calls after a warm-up (CUDA events
    a call; the host's clock on the CPU)."""
    import __graft_entry_torch__ as graft

    forward, args = graft.entry() if device.type == "cuda" else graft.entry(device)
    ids, values = forward(*args)
    if ids.device.type != device.type or values.device.type != device.type:
        raise RuntimeError(f"entry: outputs on {ids.device} / {values.device}, not {device.type}")
    U64, V64 = (a.double().cpu().numpy() for a in args[:2])
    users = args[2].cpu().numpy()
    got = ids.cpu().numpy()
    bad = [n for n, u in enumerate(users.tolist())
           if not check_ranking(got[n].tolist(), *reference_top(U64, V64, u, got.shape[1]))]
    if bad or not np.isfinite(values.cpu().numpy()).all():
        raise RuntimeError(f"entry: rows {bad} are not float64's top-{got.shape[1]}")
    times = []
    for n in range(ENTRY_CALLS + 1):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            forward(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            forward(*args)
            ms = (time.perf_counter() - t0) * 1e3
        if n:  # the first call is the warm-up
            times.append(ms)
    out = {"device": str(ids.device), "ids": list(got.shape), "rows_checked": len(users),
           "p50_ms": float(np.percentile(times, 50)), "calls": ENTRY_CALLS, "card": smi}
    log(f"[entry] {json.dumps(out)}")
    return out


def tooling_dryrun(device, smi: str) -> dict:
    """[dryrun]: ``__graft_entry_torch__.dryrun_multichip(DRYRUN_POSITIONS)``
    on that many positions of ``device``, a ``(4, 2)`` mesh: its shape and
    finiteness checks, the ``gj_solve`` launches against the mesh plan of
    both objectives' sweep with every solve at K = 16, no fused-CE launch
    (the mesh's Two-Tower epoch takes the unfused loss), its seconds."""
    import __graft_entry_torch__ as graft

    rows, cols, _, num_users, num_items = graft.dryrun_ratings()
    cfg = ALSConfig(**graft.DRYRUN_ALS)
    data = DRYRUN_POSITIONS // 2
    plan = 2 * cfg.iterations * (planned_solves(rows, num_users, cfg, data=data)
                                 + planned_solves(cols, num_items, cfg, data=data))
    shapes: list = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_solves(shapes):
        got = graft.dryrun_multichip(DRYRUN_POSITIONS) if device.type == "cuda" else \
            graft.dryrun_multichip(DRYRUN_POSITIONS, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    widths = sorted({k for _, k in shapes})
    if got["mesh"] != {"data": data, "model": 2} or widths != [cfg.rank] or len(shapes) != plan:
        raise RuntimeError(f"dryrun: mesh {got['mesh']}, {len(shapes)} solves at widths {widths}, plan {plan}")
    if device.type == "cuda":
        check_launches("dryrun", {"gj_solve": launches["gj_solve"]}, {"gj_solve": plan})
        if launches["fused_ce_fwd"] or launches["fused_ce_bwd"]:
            raise RuntimeError(f"dryrun: the mesh's Two-Tower epoch launched fused CE {launches}")
    out = {"mesh": got["mesh"], "positions": DRYRUN_POSITIONS, "plan": plan, "solves": len(shapes),
           "gj_solve_launches": launches["gj_solve"], "solve_widths": widths,
           "fused_ce_launches": launches["fused_ce_fwd"] + launches["fused_ce_bwd"], "seconds": seconds,
           "card": smi}
    log(f"[dryrun] {json.dumps(out)}")
    return out


def process_gone(pid: int) -> bool:
    """The process has exited (a zombie not yet reaped counts as exited)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] == "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return True


def tooling_launchers(device, smi: str) -> dict:
    """[launchers]: ``bin/pio-torch version`` is the port's version;
    ``bin/pio-torch-daemon`` starts the port's event server on a free port
    in a temporary store, one event is POSTed and read back, and
    ``bin/pio-stop-all`` stops it, leaving no process behind."""
    from predictionio_tpu_torch import __version__

    root = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    with temporary_store("pio-launchers-") as base:
        env = dict(os.environ, PIO_FS_BASEDIR=str(base), PIO_RUN_DIR=str(base / "run"))

        def bin_run(*argv: str) -> str:
            proc = subprocess.run([str(root / "bin" / argv[0]), *argv[1:]], env=env, capture_output=True,
                                  text=True, timeout=120, cwd=root)
            if proc.returncode != 0:
                raise RuntimeError(f"launchers: bin/{' '.join(argv)} exited {proc.returncode}: {proc.stderr[-2000:]}")
            return proc.stdout

        version = bin_run("pio-torch", "version").strip()
        if version != __version__:
            raise RuntimeError(f"launchers: bin/pio-torch version printed {version!r}, the port's is {__version__}")
        key = re.search(r"Access Key: (\S+)", bin_run("pio-torch", "app", "new", "launchers")).group(1)
        pidfile = base / "run" / "eventserver.pid"
        t0 = time.perf_counter()
        bin_run("pio-torch-daemon", str(pidfile), "eventserver", "--ip", "127.0.0.1", "--port", "0",
                "--drain-deadline-s", "5")
        pid = int(pidfile.read_text())
        log_path, found = base / "logs" / "pio-eventserver.log", None
        while found is None and time.perf_counter() - t0 < 120:
            time.sleep(0.1)
            found = re.search(r"Bound port (\d+)", log_path.read_text() if log_path.exists() else "")
        if found is None:
            raise RuntimeError(f"launchers: the daemon's event server printed no port: {log_path.read_text()[-2000:]}")
        start_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{found.group(1)}"
        event = {"event": "rate", "entityType": "user", "entityId": "u1", "targetEntityType": "item",
                 "targetEntityId": "i1", "properties": {"rating": 4.5},
                 "eventTime": "2024-01-02T03:04:05.000+00:00"}
        status, created = _http_json(f"{url}/events.json?accessKey={key}", event)
        _, found = _http_json(f"{url}/events.json?accessKey={key}&entityType=user&entityId=u1")
        if status != 201 or [e["eventId"] for e in found] != [created["eventId"]] or \
                {k: found[0][k] for k in event} != event:
            raise RuntimeError(f"launchers: POST {status} {created}, read back {found}")
        t0 = time.perf_counter()
        stopped = bin_run("pio-stop-all")
        while not process_gone(pid) and time.perf_counter() - t0 < 30:
            time.sleep(0.1)
        stop_s = time.perf_counter() - t0
        if f"Stopped eventserver (pid {pid})" not in stopped or not process_gone(pid) or pidfile.exists():
            raise RuntimeError(f"launchers: bin/pio-stop-all left pid {pid}: {stopped}")
    out = {"version": version, "daemon_start_s": start_s, "event_round_trip": True, "stop_s": stop_s,
           "left_running": 0, "phase_s": time.perf_counter() - t_phase, "card": smi}
    log(f"[launchers] {json.dumps(out)}")
    return out


def start_child(name: str, device, smi: str, *args: int, env: dict | None = None, nice: int = 0,
                environ: dict | None = None) -> tuple:
    """Start the phase function ``name`` in a child process, so that it
    runs beside the phases that follow: its own stores, CUDA context and
    launch counts (its launch checks run there), with ``env`` added to its
    environment and ``nice`` to its niceness (and so to every process it
    starts). Its lines go to a file that :func:`join_child` prints.
    ``environ`` replaces ``os.environ`` as the environment ``env`` is
    added to (a child started inside a ``temporary_store`` block must not
    inherit that store). Returns the name, the process and its directory."""
    root = str(Path(__file__).resolve().parent)
    workdir = Path(tempfile.mkdtemp(prefix=f"pio-{name}-"))
    env = dict(os.environ if environ is None else environ, **(env or {}),
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    with open(workdir / "out.log", "w") as out, open(workdir / "err.log", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", CHILD_PHASES, name, str(device), smi, str(workdir / "result.json"), str(nice),
             *(str(a) for a in args)],
            cwd=root, env=env, stdout=out, stderr=err,
        )
    return name, proc, workdir


def join_child(name: str, proc, workdir: Path, timeout_s: float) -> dict:
    """Wait for :func:`start_child`'s process, print its lines, and return
    its result; raises when it failed."""
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        rc = None
    try:
        sys.stdout.write((workdir / "out.log").read_text())
        sys.stdout.flush()
        if rc != 0:
            raise RuntimeError(f"{name}: the child process ended with {rc}; stderr: "
                               f"{(workdir / 'err.log').read_text()[-3000:]}")
        return json.loads((workdir / "result.json").read_text())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_tpl_als(device, base: Path, smi: str, nnz: int, n_queries: int, dev_args: list) -> tuple:
    """SimilarProduct and ECommerce on one app: ``nnz`` ML-20M-shaped view
    pairs and every ``TPL_BUY_EVERY``-th again as a buy, written as
    columns; item categories and the unavailable items through ``pio
    import``; ``pio train`` of each with the engine.json ``pio template
    get`` writes; deploys under 1 and 8 clients; SimilarProduct again
    with ``--ann``."""
    from predictionio_tpu_torch.templates.ecommerce import engine as ec_engine
    from predictionio_tpu_torch.templates.similarproduct import engine as sp_engine

    console_ok("templates", ["app", "new", TPL_APP])
    app = Storage.get_meta_data_apps().get_by_name(TPL_APP)
    rows, cols, _, num_users, num_items = ml20m_shaped(nnz, seed=5)
    buys = slice(0, None, TPL_BUY_EVERY)
    t_us = (1_600_000_000_000_000 + np.random.default_rng(9).integers(0, 10**9, nnz)).astype(np.int64)
    user_vocab = np.asarray([str(i) for i in range(num_users)])
    item_vocab = np.asarray([str(j) for j in range(num_items)])
    t0 = time.perf_counter()
    written = 0
    for event, sel in (("view", slice(None)), ("buy", buys)):
        written += Storage.get_p_events().write_columns(
            app.id, event=event, entity_type="user", entity_codes=rows[sel], entity_vocab=user_vocab,
            target_entity_type="item", target_codes=cols[sel], target_vocab=item_vocab, event_time_us=t_us[sel])
    write_s = time.perf_counter() - t0
    # the ECommerce popularity: a view weighs 1, a buy 5; the unavailable
    # items: every other one of the 2 * TPL_UNAVAILABLE most popular
    popularity = (np.bincount(cols, minlength=num_items)
                  + 5 * np.bincount(cols[buys], minlength=num_items)).astype(np.float64)
    by_pop = np.lexsort((np.arange(num_items), -popularity))
    unavailable = {str(j) for j in by_pop[1: 2 * TPL_UNAVAILABLE: 2].tolist()}
    sets = [{"event": "$set", "entityType": "item", "entityId": str(j),
             "properties": {"categories": [f"c{j % TPL_CATEGORIES}"]}} for j in range(num_items)]
    sets.append({"event": "$set", "entityType": "constraint", "entityId": "unavailableItems",
                 "properties": {"items": sorted(unavailable)}})
    write_ndjson(base / "sets.json", sets)
    import_s = console_ok("templates", ["import", "--appname", TPL_APP, "--input", str(base / "sets.json")])
    events = written + len(sets)
    log(f"[templates] similarproduct/ecommerce app: {written} view and buy events by write_columns in "
        f"{write_s:.3f} s, {len(sets)} $set events by pio import in {import_s:.3f} s")
    if written != nnz + len(rows[buys]):
        raise RuntimeError(f"templates: write_columns wrote {written} events")

    def als_params(variant: dict) -> None:
        params = variant["algorithms"][0]["params"]
        if params != {"rank": TPL_RANK, "numIterations": TPL_SWEEPS, "lambda": 0.01}:
            raise RuntimeError(f"templates: pio template get wrote {params}")
        params["alpha"] = 1.0

    sp_json = template_engine_json(base, "similarproduct", TPL_APP, als_params)

    def ec_params(variant: dict) -> None:
        als_params(variant)
        # the serving-time lookups need the app (the README of `get` says
        # to edit appName in)
        variant["algorithms"][0]["params"]["appName"] = TPL_APP

    ec_json = template_engine_json(base, "ecommerce", TPL_APP, ec_params)
    ctx = local_context(device)
    t0 = time.perf_counter()
    sp_td = sp_engine.SimilarProductDataSource(sp_engine.DataSourceParams(app_name=TPL_APP)).read_training(ctx)
    sp_read_s = time.perf_counter() - t0
    sp = train_template_als("templates similarproduct train", sp_engine.ALSAlgorithm, sp_json, sp_td, device,
                            dev_args)
    t0 = time.perf_counter()
    ec_td = ec_engine.ECommerceDataSource(ec_engine.DataSourceParams(app_name=TPL_APP)).read_training(ctx)
    ec_read_s = time.perf_counter() - t0
    ec = train_template_als("templates ecommerce train", ec_engine.ECommAlgorithm, ec_json, ec_td, device, dev_args)
    for name, trained, td, read_s in (("similarproduct", sp, sp_td, sp_read_s), ("ecommerce", ec, ec_td, ec_read_s)):
        log(f"[templates] {name} train: {events} events, read {read_s:.3f} s in process, {trained['read_s']:.3f} s "
            f"in pio train; {len(td.user_index)} users x {len(td.item_index)} items, {td.rows.size} pairs; "
            f"train {trained['train_s']:.3f} s, pio train wall {trained['wall_s']:.3f} s; {trained['launches']} "
            f"gj_solve launches (plan {trained['plan']}), batches [B,{TPL_RANK},{TPL_RANK}] up to "
            f"{max(trained['solve_batches'])}; implicit loss last/first {trained['loss_ratio']:.6f} "
            f"({trained['losses'][0]:.6g} -> {trained['losses'][-1]:.6g}) on {smi}")
    sp_model = stored_model(sp["instance"].id)
    ec_model = stored_model(ec["instance"].id)
    if not np.array_equal(ec_model.popularity, popularity[[int(i) for i in ec_model.item_index.keys()]]):
        raise RuntimeError("templates: the ECommerce model's popularity is not the events' weighted counts")
    del sp_td, ec_td

    rng = np.random.default_rng(31)
    sp_out = tpl_similarproduct(device, base, smi, sp, sp_json, sp_model, rng, n_queries, dev_args)
    ec_out = tpl_ecommerce(device, base, smi, ec, ec_json, ec_model, rows, cols, unavailable, rng, n_queries,
                           dev_args)
    del rows, cols
    bmax = max(sp["solve_batches"] + ec["solve_batches"])
    solve = solve_row(bmax, TPL_RANK, 400, device) if device.type == "cuda" else None
    for out, trained, read_s in ((sp_out, sp, sp_read_s), (ec_out, ec, ec_read_s)):
        out.update({key: trained[key] for key in ("wall_s", "read_s", "train_s", "launches", "plan", "loss_ratio")},
                   events=events, read_in_process_s=read_s, losses=trained["losses"],
                   solve_batch_max=max(trained["solve_batches"]))
    return sp_out, ec_out, solve


def tpl_similarproduct(device, base: Path, smi: str, trained: dict, engine_json: Path, model, rng,
                       n_queries: int, dev_args: list) -> dict:
    """64 SimilarProduct queries (1- and 3-item baskets, categories,
    whiteList, blackList) under 1 and 8 clients, each held to float64
    numpy over the stored unit item table; then ``--ann`` with blackLists
    that exclude the whole exact top-10."""
    index = model.item_index
    n = len(index)
    unit64 = np.asarray(model.item_factors, np.float64)
    if not np.isfinite(unit64).all():
        raise RuntimeError("templates: the SimilarProduct item table is not finite")
    cat_of_row = np.asarray([f"c{int(index.inverse(r)) % TPL_CATEGORIES}" for r in range(n)])
    ids = index.keys()

    def scores_of(items: list) -> np.ndarray:
        target = unit64[[index[i] for i in items]].sum(axis=0)
        return unit64 @ (target / np.linalg.norm(target))

    bodies = []
    for q in range(n_queries):
        kind = q % 5
        basket = [ids[int(j)] for j in rng.choice(n, size=3 if kind == 1 else 1, replace=False)]
        body = {"items": basket, "num": TOP_K}
        if kind == 2:
            body["categories"] = [f"c{int(c)}" for c in rng.choice(TPL_CATEGORIES, size=2, replace=False)]
        elif kind == 3:
            body["whiteList"] = [ids[int(j)] for j in rng.choice(n, size=40, replace=False)]
        elif kind == 4:
            # the basket's own top-5 and two random items
            allowed = rule_mask(n, index, cat_of_row, [index[i] for i in basket], {})
            top = reference_masked_top(scores_of(basket), allowed, 5)
            body["blackList"] = [ids[int(j)] for j in top] + [ids[int(j)] for j in rng.choice(n, size=2)]
        bodies.append(body)
    refs = []
    for body in bodies:
        basket_rows = [index[i] for i in body["items"]]
        scores = scores_of(body["items"])
        allowed = rule_mask(n, index, cat_of_row, basket_rows, body)
        forbidden = set(basket_rows) | {index[i] for i in body.get("blackList", ())}
        forbidden |= set(np.flatnonzero(~allowed).tolist())
        refs.append((reference_masked_top(scores, allowed, body["num"]), scores, index, forbidden))
    deployed = deploy_pair("similarproduct", base, engine_json, {"exact": trained["instance"].id}, [], dev_args)
    try:
        url = deployed["exact"][1]
        runs = {}
        for clients in TPL_CLIENTS:
            runs[clients] = run_bodies(url, bodies, clients)
            check_item_answers(f"templates similarproduct x{clients}", runs[clients]["answers"], refs,
                               [False] * len(refs))
    finally:
        stop_deploys("similarproduct", deployed, device)
    handle = handle_p50(engine_json, trained["instance"].id, bodies, device)
    out = {"queries": len(bodies), **served_line("similarproduct", deployed["exact"][2], runs, handle, smi)}

    # --ann: blackLists of the whole exact top-10 still answer TOP_K items
    ann_bodies = []
    for q in range(TPL_ANN_QUERIES):
        basket = [ids[int(rng.integers(n))]]
        allowed = rule_mask(n, index, cat_of_row, [index[basket[0]]], {})
        top = reference_masked_top(scores_of(basket), allowed, TOP_K)
        ann_bodies.append({"items": basket, "num": TOP_K, "blackList": [ids[int(j)] for j in top]})
    deployed = deploy_pair("similarproduct-ann", base, engine_json, {"ann": trained["instance"].id}, ["--ann"],
                           dev_args)
    try:
        run = run_bodies(deployed["ann"][1], ann_bodies, 1)
        _, ann_stats = _http_json(deployed["ann"][1] + "/stats.json")
    finally:
        stop_deploys("similarproduct-ann", deployed, device)
    for (j, _, payload), body in zip(run["answers"], ann_bodies):
        got = [s["item"] for s in payload["itemScores"]]
        if len(got) != TOP_K or set(got) & (set(body["blackList"]) | set(body["items"])):
            raise RuntimeError(f"templates: --ann answered {got} to a blackList of the exact top-{TOP_K} {body}")
    out["ann"] = {"deploy_start_s": deployed["ann"][2], "queries": len(ann_bodies), "p50_ms": run["p50_ms"],
                  "p99_ms": run["p99_ms"], "nlist": ann_stats["ann"]["models"][0].get("nlist")}
    log(f"[templates] similarproduct --ann: {len(ann_bodies)} blackLists of the exact top-{TOP_K}, each answered "
        f"{TOP_K} other items; {json.dumps(out['ann'])} on {smi}")
    return out


def tpl_ecommerce(device, base: Path, smi: str, trained: dict, engine_json: Path, model, rows: np.ndarray,
                  cols: np.ndarray, unavailable: set, rng, n_queries: int, dev_args: list) -> dict:
    """``n_queries`` ECommerce queries — known users (their viewed and bought items
    must be absent), cold users ranked by popularity (ties by ascending
    row; a whiteList of tied items), categories and blackLists — under 1
    and 8 clients, each held to float64 numpy over the stored factors;
    then ``handle_query`` in process, timed apart into the two
    ``LEventStore`` lookups and the rest."""
    uindex, index = model.user_index, model.item_index
    n = len(index)
    U64 = np.asarray(model.user_factors, np.float64)
    V64 = np.asarray(model.item_factors, np.float64)
    pop64 = np.asarray(model.popularity, np.float64)
    if not (np.isfinite(U64).all() and np.isfinite(V64).all()):
        raise RuntimeError("templates: the ECommerce factors are not finite")
    cat_of_row = np.asarray([f"c{int(index.inverse(r)) % TPL_CATEGORIES}" for r in range(n)])
    ids = index.keys()
    unavailable_rows = {index[i] for i in unavailable if i in index}
    # a popularity value shared by many items: a whiteList of those ties
    values, counts = np.unique(pop64, return_counts=True)
    tied_rows = np.flatnonzero(pop64 == values[np.argmax(counts)])[:30]
    known = rng.choice(len(uindex), size=n_queries // 2, replace=False)
    known_users = [uindex.inverse(int(u)) for u in known]
    wanted = np.isin(rows, np.asarray([int(u) for u in known_users]))
    seen: dict = {}
    for u, i in zip(rows[wanted].tolist(), cols[wanted].tolist()):
        seen.setdefault(str(u), set()).add(index[str(i)])
    bodies, refs, strict, unfiltered_hits = [], [], [], 0
    for q in range(n_queries):
        cold = q >= len(known_users)
        body = {"user": f"cold{q}" if cold else known_users[q], "num": TOP_K}
        kind = q % 4
        if kind == 1:
            body["categories"] = [f"c{int(rng.integers(TPL_CATEGORIES))}"]
        elif kind == 2 and cold:
            body["whiteList"] = [ids[int(j)] for j in tied_rows]
        elif kind == 3:
            body["blackList"] = [ids[int(j)] for j in rng.choice(n, size=5, replace=False)]
        scores = pop64 if cold else V64 @ U64[uindex[body["user"]]]
        user_seen = set() if cold else seen[body["user"]]
        allowed = rule_mask(n, index, cat_of_row, user_seen | unavailable_rows, body)
        unfiltered = reference_masked_top(scores, rule_mask(n, index, cat_of_row, (), body), TOP_K)
        unfiltered_hits += bool(set(unfiltered.tolist()) & unavailable_rows)
        forbidden = user_seen | unavailable_rows | {index[i] for i in body.get("blackList", ())}
        bodies.append(body)
        refs.append((reference_masked_top(scores, allowed, TOP_K), scores, index, forbidden))
        strict.append(cold)
    if not unfiltered_hits:
        raise RuntimeError("templates: no ECommerce query has an unavailable item in its unfiltered top-10")
    deployed = deploy_pair("ecommerce", base, engine_json, {"exact": trained["instance"].id}, [], dev_args)
    try:
        runs = {}
        for clients in TPL_CLIENTS:
            runs[clients] = run_bodies(deployed["exact"][1], bodies, clients)
            check_item_answers(f"templates ecommerce x{clients}", runs[clients]["answers"], refs, strict)
    finally:
        stop_deploys("ecommerce", deployed, device)
    timers = {"_seen_items": [], "_unavailable_items": []}
    handle = handle_p50(engine_json, trained["instance"].id, bodies, device, timers)
    split = {
        "seen_lookup_p50_ms": float(np.percentile(timers["_seen_items"], 50)),
        "unavailable_lookup_p50_ms": float(np.percentile(timers["_unavailable_items"], 50)),
        "rest_p50_ms": float(np.percentile(np.asarray(handle["lat_ms"]) - np.asarray(timers["_seen_items"])
                                           - np.asarray(timers["_unavailable_items"]), 50)),
    }
    out = {"queries": len(bodies), "cold_queries": sum(strict), "unfiltered_top10_with_unavailable": unfiltered_hits,
           **served_line("ecommerce", deployed["exact"][2], runs, handle, smi), "split": split}
    log(f"[templates] ecommerce: {unfiltered_hits} queries had an unavailable item in the unfiltered top-{TOP_K}, "
        f"none in an answer; no seen, blacklisted or unavailable item answered; {sum(strict)} popularity answers "
        f"in ascending-row tie order; handle_query split {json.dumps(split)} on {smi}")
    return out


def tpl_classifiers(label: str, engine_jsons: dict, device, dev_args: list) -> dict:
    """``pio train`` of each engine.json (name -> path) with the launch
    counts set to 0 before it and read after it: nothing may launch."""
    trained = {}
    for name, path in engine_jsons.items():
        reset_launch_counts()
        wall_s = console_ok(label, ["train", "--engine-json", str(path), *dev_args])
        launches = read_launch_counts()
        if any(launches.values()):
            raise RuntimeError(f"{label} {name}: kernels launched on a classifier's path: {launches}")
        instance = max(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
        if instance.status != "COMPLETED":
            raise RuntimeError(f"{label} {name}: engine instance {instance.id} is {instance.status}")
        timings = json.loads(instance.env["phase_timings"])
        algo = next(key for key in timings if key.startswith("train:"))
        trained[name] = {"instance": instance, "wall_s": wall_s, "read_s": timings["read"],
                         "train_s": timings[algo], "launches": launches}
    return trained


def nb_reference(x, y: np.ndarray, classes: int, smoothing: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Multinomial NB in float64 numpy: (log_prior [C], log_theta [C, F]);
    ``x`` dense or scipy.sparse."""
    one_hot = np.eye(classes)[y]
    feat = np.asarray((x.T @ one_hot).T, np.float64)
    counts = one_hot.sum(axis=0)
    log_prior = np.log(counts + smoothing) - np.log(counts.sum() + classes * smoothing)
    log_theta = np.log(feat + smoothing) - np.log(feat.sum(axis=1, keepdims=True) + smoothing * x.shape[1])
    return log_prior, log_theta


def lr_reference(x, y: np.ndarray, classes: int, iterations: int, lr: float = 1.0,
                 reg: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
    """The reference's full-batch descent in float64 numpy: zero init,
    ``g = (p − one_hot)/n``, ``w -= lr·(xᵀg + reg·w)``, ``b -= lr·Σg``."""
    n, f = x.shape
    one_hot = np.eye(classes)[y]
    w = np.zeros((f, classes))
    b = np.zeros(classes)
    for _ in range(iterations):
        logits = np.asarray(x @ w) + b
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        g = (p - one_hot) / n
        w, b = w - lr * (np.asarray(x.T @ g) + reg * w), b - lr * g.sum(axis=0)
    return w, b


def softmax64(z: np.ndarray) -> np.ndarray:
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def check_labels(label: str, answers: list, field: str, names: list, ref_scores: np.ndarray, kind: str,
                 truth: list | None = None) -> dict:
    """Each answer's label against the float64 argmax of ``ref_scores``
    (``[Q, C]`` log-posteriors for NB, probabilities for LR); a differing
    label passes only on a near-tie of the two (relative 1e-5 for NB,
    1e-3 for LR); an LR confidence must be within 1e-3 of its float64
    probability. Returns the worst gaps and, with ``truth``, the accuracy."""
    bad, worst_conf = [], 0.0
    for (j, _, payload), row in zip(answers, ref_scores):
        got, want = names.index(payload[field]), int(np.argmax(row))
        if got != want:
            tol = 1e-5 * abs(row[want]) if kind == "nb" else 1e-3
            if abs(row[got] - row[want]) > tol:
                bad.append((j, payload[field], names[want]))
        if kind == "lr":
            worst_conf = max(worst_conf, abs(payload["confidence"] - row[got]))
    if bad or worst_conf > TPL_LR_ATOL:
        raise RuntimeError(f"{label}: {len(bad)} labels differ from float64 numpy's argmax ({bad[:3]}); "
                           f"worst LR confidence gap {worst_conf:.3g} (limit {TPL_LR_ATOL:g})")
    out = {"worst_confidence_gap": worst_conf}
    if truth is not None:
        out["accuracy"] = float(np.mean([p[field] == t for (_, _, p), t in zip(answers, truth)]))
    return out


def phase_tpl_classification(device, base: Path, smi: str, users: int, n_queries: int, dev_args: list) -> dict:
    """``users`` ``$set`` users with ``attr0..attr2`` and a 3-class ``plan``
    (the draw of tests/test_classification_template.py's fixture) through
    ``pio import``; ``pio train`` of the NB and of the LR variant; both
    deployed, 64 queries each held to float64 numpy; ``pio eval`` of
    ``Accuracy`` over both, each above the majority-class rate."""
    console_ok("templates", ["app", "new", TPL_CLS_APP])
    rng = np.random.default_rng(41)
    cls = np.arange(users) % 3
    attrs = rng.poisson(1, size=(users, 3))
    attrs[np.arange(users), cls] += rng.poisson(6, size=users) + 2
    write_ndjson(base / "cls.json", (
        {"event": "$set", "entityType": "user", "entityId": f"u{n}",
         "properties": {"attr0": int(a[0]), "attr1": int(a[1]), "attr2": int(a[2]), "plan": TPL_CLS_LABELS[c]}}
        for n, (a, c) in enumerate(zip(attrs.tolist(), cls.tolist()))))
    import_s = console_ok("templates", ["import", "--appname", TPL_CLS_APP, "--input", str(base / "cls.json")])
    nb_json = template_engine_json(base, "classification", TPL_CLS_APP)

    def lr_variant(variant: dict) -> None:
        variant["algorithms"] = [{"name": "lr", "params": {"iterations": 200}}]

    lr_json = template_engine_json(base, "classification", TPL_CLS_APP, lr_variant)
    trained = tpl_classifiers("templates classification train", {"nb": nb_json, "lr": lr_json}, device,
                              dev_args)
    # the training rows in the DataSource's order (sorted entity ids)
    order = sorted(range(users), key=lambda n: f"u{n}")
    x = attrs[order].astype(np.float32)
    y_names = [TPL_CLS_LABELS[c] for c in cls[order].tolist()]
    names = list(dict.fromkeys(y_names))
    y = np.asarray([names.index(name) for name in y_names])
    nb_model = stored_model(trained["nb"]["instance"].id)
    lr_model = stored_model(trained["lr"]["instance"].id)
    for model in (nb_model, lr_model):
        if model["label_index"].keys() != names:
            raise RuntimeError(f"templates: the classifier's labels {model['label_index'].keys()} are not {names}")
    log_prior, log_theta = nb_reference(x.astype(np.float64), y, 3)
    x64 = x.astype(np.float64)
    mean, std = x64.mean(axis=0), x64.std(axis=0)
    w64, b64 = lr_reference((x64 - mean) / std, y, 3, 200)
    w_gap = float(np.abs(np.asarray(lr_model["lr"].w, np.float64) - w64).max())
    picks = rng.choice(users, size=n_queries, replace=False)
    qx = attrs[picks].astype(np.float64)
    bodies = [{f"attr{a}": int(v) for a, v in enumerate(row)} for row in attrs[picks].tolist()]
    truth = [TPL_CLS_LABELS[c] for c in cls[picks].tolist()]
    deployed = deploy_pair("classification", base, nb_json,
                           {"nb": trained["nb"]["instance"].id, "lr": trained["lr"]["instance"].id}, [], dev_args)
    try:
        runs = {name: run_bodies(deployed[name][1], bodies, 1) for name in ("nb", "lr")}
    finally:
        stop_deploys("classification", deployed, device)
    checks = {
        "nb": check_labels("templates classification nb", runs["nb"]["answers"], "label", names,
                           log_prior + qx @ log_theta.T, "nb", truth),
        "lr": check_labels("templates classification lr", runs["lr"]["answers"], "label", names,
                           softmax64(((qx - mean) / std) @ w64 + b64), "lr", truth),
    }
    # pio eval: Accuracy over both algorithms, 3 folds
    source = (
        "from predictionio_tpu_torch.controller import Evaluation\n"
        "from predictionio_tpu_torch.templates.classification import Accuracy, engine_factory\n"
        "from predictionio_tpu_torch.workflow import load_engine_variant\n"
        "ENGINE = engine_factory()\n"
        "evaluation = Evaluation(engine=ENGINE, metric=Accuracy())\n"
        f"evaluation.engine_params_list = [load_engine_variant(p).engine_params(ENGINE) "
        f"for p in {[str(nb_json), str(lr_json)]!r}]\n")
    _, eval_launches, eval_s = run_eval("templates classification", base, "cls_eval", "", "", 0, nb_json, dev_args,
                                        source)
    if any(eval_launches.values()):
        raise RuntimeError(f"templates: pio eval of the classifiers launched kernels {eval_launches}")
    scores = [s["score"] for s in json.loads((base / "best.json").read_text())["engineParamsScores"]]
    majority = float(np.bincount(cls).max() / users)
    if len(scores) != 2 or not min(scores) > majority:
        raise RuntimeError(f"templates: classification accuracy {scores} not above the majority rate {majority}")
    out = {"events": users, "import_s": import_s, "eval_s": eval_s, "accuracy_nb": scores[0],
           "accuracy_lr": scores[1], "majority_rate": majority, "lr_w_gap_vs_float64": w_gap,
           **{name: {"deploy_start_s": deployed[name][2], "p50_ms": runs[name]["p50_ms"],
                     "p99_ms": runs[name]["p99_ms"], "read_s": trained[name]["read_s"],
                     "train_s": trained[name]["train_s"], "wall_s": trained[name]["wall_s"],
                     "served_accuracy": checks[name]["accuracy"],
                     "worst_confidence_gap": checks[name]["worst_confidence_gap"]} for name in ("nb", "lr")}}
    for name in ("nb", "lr"):
        out[name]["handle_query_p50_ms"] = handle_p50(nb_json, trained[name]["instance"].id, bodies, device)["p50_ms"]
    log(f"[templates] classification: {json.dumps(out)}; no kernel launched in train, deploy or eval; on {smi}")
    return out


def text_corpus(docs: int, seed: int, offset: int = 0) -> tuple[list, list]:
    """``docs`` synthetic documents in ``TPL_TEXT_CLASSES`` classes: each
    token from the class's own Zipf(1.3) vocabulary with probability
    ``TPL_TEXT_OWN_SHARE``, else from a Zipf(1.3) vocabulary every class
    shares. Returns (texts, labels)."""
    rng = np.random.default_rng(seed)
    cls = (np.arange(docs) + offset) % TPL_TEXT_CLASSES
    own = rng.random((docs, TPL_TEXT_LEN)) < TPL_TEXT_OWN_SHARE
    own_rank = (rng.zipf(1.3, (docs, TPL_TEXT_LEN)) - 1) % TPL_TEXT_VOCAB
    shared_rank = (rng.zipf(1.3, (docs, TPL_TEXT_LEN)) - 1) % TPL_TEXT_SHARED
    texts = [
        " ".join(f"w{c}x{o}" if m else f"s{s}" for m, o, s in zip(mask, orow, srow))
        for c, mask, orow, srow in zip(cls.tolist(), own.tolist(), own_rank.tolist(), shared_rank.tolist())
    ]
    return texts, [f"topic{c}" for c in cls.tolist()]


def phase_tpl_text(device, base: Path, smi: str, docs: int, n_queries: int, dev_args: list) -> dict:
    """``docs`` labelled documents through ``pio import``; ``pio train`` of
    the NB and the LR variant at ``numFeatures`` 4,096; both deployed and
    held to float64 numpy on 64 new documents, whose accuracy must beat
    1/``TPL_TEXT_CLASSES``."""
    import scipy.sparse

    console_ok("templates", ["app", "new", TPL_TEXT_APP])
    texts, labels = text_corpus(docs, seed=51)
    write_ndjson(base / "text.json", (
        {"event": "$set", "entityType": "content", "entityId": f"d{n}", "properties": {"text": t, "category": c}}
        for n, (t, c) in enumerate(zip(texts, labels))))
    import_s = console_ok("templates", ["import", "--appname", TPL_TEXT_APP, "--input", str(base / "text.json")])

    def nb_variant(variant: dict) -> None:
        variant["preparator"] = {"params": {"numFeatures": TPL_TEXT_FEATURES}}

    def lr_variant(variant: dict) -> None:
        nb_variant(variant)
        variant["algorithms"] = [{"name": "lr", "params": {"iterations": 300}}]

    nb_json = template_engine_json(base, "textclassification", TPL_TEXT_APP, nb_variant)
    lr_json = template_engine_json(base, "textclassification", TPL_TEXT_APP, lr_variant)
    trained = tpl_classifiers("templates textclassification train", {"nb": nb_json, "lr": lr_json}, device,
                              dev_args)
    order = sorted(range(docs), key=lambda n: f"d{n}")
    nb_model = stored_model(trained["nb"]["instance"].id)
    featurizer = nb_model["featurizer"]
    names = nb_model["label_index"].keys()
    x = scipy.sparse.csr_matrix(featurizer.transform([texts[n] for n in order]).astype(np.float64))
    y = np.asarray([names.index(labels[n]) for n in order])
    log_prior, log_theta = nb_reference(x, y, len(names))
    w64, b64 = lr_reference(x, y, len(names), 300)
    lr_model = stored_model(trained["lr"]["instance"].id)
    w_gap = float(np.abs(np.asarray(lr_model["lr"].w, np.float64) - w64).max())
    q_texts, q_labels = text_corpus(n_queries, seed=52, offset=7)
    qx = featurizer.transform(q_texts).astype(np.float64)
    bodies = [{"text": t} for t in q_texts]
    deployed = deploy_pair("textclassification", base, nb_json,
                           {"nb": trained["nb"]["instance"].id, "lr": trained["lr"]["instance"].id}, [], dev_args)
    try:
        runs = {name: run_bodies(deployed[name][1], bodies, 1) for name in ("nb", "lr")}
    finally:
        stop_deploys("textclassification", deployed, device)
    checks = {
        "nb": check_labels("templates text nb", runs["nb"]["answers"], "category", names,
                           log_prior + qx @ log_theta.T, "nb", q_labels),
        "lr": check_labels("templates text lr", runs["lr"]["answers"], "category", names,
                           softmax64(qx @ w64 + b64), "lr", q_labels),
    }
    chance = 1.0 / TPL_TEXT_CLASSES
    if not min(checks[name]["accuracy"] for name in checks) > chance:
        raise RuntimeError(f"templates: text accuracy {checks} not above 1/{TPL_TEXT_CLASSES}")
    out = {"events": docs, "import_s": import_s, "num_features": TPL_TEXT_FEATURES, "nnz": int(x.nnz),
           "lr_w_gap_vs_float64": w_gap, "chance": chance,
           **{name: {"deploy_start_s": deployed[name][2], "p50_ms": runs[name]["p50_ms"],
                     "p99_ms": runs[name]["p99_ms"], "read_s": trained[name]["read_s"],
                     "train_s": trained[name]["train_s"], "wall_s": trained[name]["wall_s"],
                     "accuracy": checks[name]["accuracy"],
                     "worst_confidence_gap": checks[name]["worst_confidence_gap"]} for name in ("nb", "lr")}}
    for name in ("nb", "lr"):
        out[name]["handle_query_p50_ms"] = handle_p50(nb_json, trained[name]["instance"].id, bodies, device)["p50_ms"]
    log(f"[templates] textclassification: {json.dumps(out)}; no kernel launched in train or deploy; on {smi}")
    return out


# ------------------------------------------------------------- 13. fleet
#: ``pio deploy --replicas N`` at each N under the [serving] phase's 32 x
#: 100 uniform load; the JAX bench's SIGKILL drill (``bench.py:2052-2077``:
#: 2 replicas, 16 clients for 6 s, one SIGKILL at 2 s); a rolling
#: ``/reload`` under 16 clients; its A/B drill (``bench.py:3027-3028``: 8
#: clients x 40 queries, ``control:1,treatment:1``)
FLT_REPLICAS = (1, 2, 4)
FLT_PROBE_S = 0.1
FLT_READY_TIMEOUT_S = 240
FLT_DRILL_CLIENTS = 16
FLT_DRILL_S = 6.0
FLT_KILL_AT_S = 2.0
FLT_ROLL_LEAD_S = 1.0
FLT_AB_SPLIT = "control:1,treatment:1"
FLT_AB_CLIENTS = 8
FLT_AB_QUERIES = 40
FLT_AB_SHARE_TOL = 0.05

#: [experiments]: the JAX bench's closed loop (``bench.py:3021-3100``: 16
#: arms, 400 queries, a retrain every 25); ``pio deploy --explore
#: thompson`` under the [serving] load, 64 rewards posted, 48 through the
#: follower; ``pio eval --grid`` on the quickstart's ML-100K store (16
#: candidates: 4 lambdas x 4 seeds, rank 64, 10 sweeps, precision@10, 2
#: folds); the bench's batched-against-sequential size (``bench.py:3112-3130``)
EXP_ARMS = 16
EXP_QUERIES = 400
EXP_RETRAIN = 25
EXP_REWARDS_POSTED = 64
EXP_REWARDS_FOLLOWED = 48
EXP_FOLLOW_TIMEOUT_S = 30.0
EXP_GRID_LAMBDAS = (0.01, 0.05, 0.1, 0.5)
EXP_GRID_SEEDS = (0, 1, 2, 3)
EXP_GRID_RANK = 64
EXP_GRID_SWEEPS = 10
EXP_SEQ_CANDIDATES = 2
EXP_F64_ATOL = 2e-3
EXP_BENCH = {"users": 48, "candidates": 16, "rank": 8, "iterations": 3, "k": 3, "reps": 3}
EXP_BENCH_MIN_RATIO = 2.0

GRID_MODULE = """
from predictionio_tpu_torch.controller import EngineParams, Evaluation
from predictionio_tpu_torch.templates.recommendation import ALSAlgorithmParams, DataSourceParams, engine_factory
from predictionio_tpu_torch.templates.recommendation.engine import PrecisionAtK

evaluation = Evaluation(engine=engine_factory(), metric=PrecisionAtK({k}))
evaluation.engine_params_list = [
    EngineParams(datasource=DataSourceParams(app_name={app!r}, eval_k={folds}),
                 algorithms=(("als", ALSAlgorithmParams(rank={rank}, num_iterations={sweeps}, lambda_=lam,
                                                        seed=seed)),))
    for lam, seed in {candidates!r}
]
"""


def smi_processes() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory``: the processes
    that hold a context on the card and their memory (where process ids
    are hidden, every one shows as pid 1 with the card's total)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def smi_memory_used_mib() -> int:
    return int(_smi("memory.used").split()[0])


def console_processes() -> list:
    """``(pid, verb)`` of every live ``predictionio_tpu_torch.tools.console``
    process on the host (``/proc/*/cmdline``): what else holds the host's
    cores and the card while a phase measures."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        with contextlib.suppress(OSError):
            argv = Path(f"/proc/{entry}/cmdline").read_bytes().split(b"\0")
            if b"predictionio_tpu_torch.tools.console" in argv:
                verb = argv[argv.index(b"predictionio_tpu_torch.tools.console") + 1].decode()
                found.append((int(entry), verb))
    return sorted(found)


def cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of a live process (``/proc/<pid>/stat``)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


@contextlib.contextmanager
def busy_shares(pids: dict, device):
    """The cores each process of ``pids`` (name -> pid) and this one (the
    load's clients, ``"clients"``) kept busy over the block, and the mean
    of ``nvidia-smi``'s ``utilization.gpu`` sampled every 0.25 s in it;
    filled into the yielded dict when the block ends."""
    out: dict = {}
    samples: list = []
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(0.25):
            with contextlib.suppress(Exception):
                samples.append(float(_smi("utilization.gpu").split()[0]))

    sampler = threading.Thread(target=sample, daemon=True) if device.type == "cuda" else None
    before = {name: cpu_seconds(pid) for name, pid in pids.items()}
    client0, t0 = time.process_time(), time.perf_counter()
    if sampler is not None:
        sampler.start()
    try:
        yield out
    finally:
        stop.set()
        if sampler is not None:
            sampler.join(timeout=10)
        wall = time.perf_counter() - t0
        for name, pid in pids.items():
            with contextlib.suppress(OSError):
                out[name] = (cpu_seconds(pid) - before[name]) / wall
        out["clients"] = (time.process_time() - client0) / wall
        out["gpu_utilization_pct"] = float(np.mean(samples)) if samples else None


def start_fleet(label: str, base: Path, deploy: list, n: int) -> dict:
    """``pio deploy --replicas n`` (the router on port 0, its own endpoint
    registry under ``base``) until the router's ring holds ``n`` healthy
    replicas; a failure stops the fleet before raising."""
    registry = base / f"endpoints-{label.replace(' ', '-')}-{n}"
    t0 = time.perf_counter()
    proc, port = start_console_server(
        label, base, [*deploy, "--replicas", str(n), "--probe-interval-s", str(FLT_PROBE_S),
                      "--endpoint-registry", str(registry)],
        base / f"fleet-{label.replace(' ', '-')}-{n}.stderr", FLT_READY_TIMEOUT_S)
    fleet = {"proc": proc, "port": port, "url": f"http://127.0.0.1:{port}", "n": n,
             "state": base / "deployments" / f"fleet-{port}.json", "label": label}
    try:
        deadline = time.perf_counter() + FLT_READY_TIMEOUT_S
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"{label}: the router exited {proc.returncode} before its ring was full")
            _, root = _http_json(fleet["url"] + "/")
            reps = root["replicas"]
            if root.get("role") == "router" and len(reps) == n and all(r["healthy"] for r in reps):
                break
            if time.perf_counter() > deadline:
                raise RuntimeError(f"{label}: {n} healthy replicas not in the ring within {FLT_READY_TIMEOUT_S} s: "
                                   f"{reps}")
            time.sleep(0.1)
    except BaseException:
        stop_fleet(fleet, check=False)
        raise
    fleet["ready_s"] = time.perf_counter() - t0
    return fleet


def fleet_pids(fleet: dict) -> list:
    try:
        return [int(r["pid"]) for r in json.loads(fleet["state"].read_text())["replicas"] if r.get("pid")]
    except (OSError, ValueError, KeyError):
        return []


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def stop_fleet(fleet: dict, check: bool = True) -> float:
    """``pio undeploy`` of the router, which must stop the whole fleet:
    the router exits 0, every replica pid on file is gone and the state
    file removed. Without ``check``, SIGTERM and then SIGKILL whatever
    is left. Returns the seconds it took."""
    proc, pids = fleet["proc"], fleet_pids(fleet)
    t0 = time.perf_counter()
    try:
        if check:
            console_ok(fleet["label"], ["undeploy", "--port", str(fleet["port"])])
            rc = proc.wait(timeout=60)
            if rc != 0:
                raise RuntimeError(f"{fleet['label']}: the router exited {rc} after pio undeploy")
            deadline = time.perf_counter() + 30
            while any(pid_alive(p) for p in pids) and time.perf_counter() < deadline:
                time.sleep(0.05)
            left = [p for p in pids if pid_alive(p)]
            if left or fleet["state"].exists():
                raise RuntimeError(f"{fleet['label']}: after pio undeploy replicas {left} live on, state file "
                                   f"{'kept' if fleet['state'].exists() else 'removed'}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        for pid in pids:
            if pid_alive(pid):
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
    return time.perf_counter() - t0


class DrillClients:
    """Keep-alive clients that never retry (zero failed queries means the
    router absorbed every fault): client ``c`` queries the user rows
    ``rows[c::clients]`` in turn, so each scope belongs to one client and
    its answers arrive in order. Records ``(start, end, status, row,
    generation, variant, payload)``; a transport error is status 0."""

    def __init__(self, url: str, rows: np.ndarray, user_index, clients: int, k: int, passes: int | None = None):
        import http.client

        host, port = url.removeprefix("http://").split(":")
        self.records: list = []
        self._lock = threading.Lock()
        self._passes = passes
        self.stop = threading.Event()

        def client(c: int) -> None:
            mine = rows[c::clients].tolist()
            conn = http.client.HTTPConnection(host, int(port), timeout=120)
            out = []
            n = 0
            while mine and not self.stop.is_set() and (passes is None or n < passes * len(mine)):
                uidx = mine[n % len(mine)]
                n += 1
                body = json.dumps({"user": user_index.inverse(uidx), "num": TOP_K}).encode()
                t0 = time.perf_counter()
                try:
                    conn.request("POST", "/queries.json", body=body, headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    payload = json.loads(resp.read())
                    out.append((t0, time.perf_counter(), resp.status, uidx,
                                int(resp.headers.get("X-PIO-Generation") or 0), resp.headers.get("X-PIO-Variant"),
                                payload))
                except Exception:  # counted as failed: the drills allow none
                    out.append((t0, time.perf_counter(), 0, uidx, 0, None, None))
                    conn.close()
                    conn = http.client.HTTPConnection(host, int(port), timeout=120)
            conn.close()
            with self._lock:
                self.records.extend(out)

        self._threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
        for t in self._threads:
            t.start()

    def join(self) -> list:
        """Stop the clients (with ``passes``, let them finish them) and
        return the records in the order they ended."""
        if self._passes is None:
            self.stop.set()
        for t in self._threads:
            t.join(timeout=300)
        return sorted(self.records, key=lambda r: r[1])

    @staticmethod
    def failed(records: list) -> list:
        return [r for r in records if r[2] != 200]

    @staticmethod
    def p99_ms(records: list) -> float:
        lat = [(r[1] - r[0]) * 1e3 for r in records]
        return float(np.percentile(lat, 99)) if lat else float("nan")

    @staticmethod
    def cross_generation(records: list) -> int:
        """Answers of a scope served by an older generation than one it
        was served before (the scope's answers in arrival order)."""
        last: dict = {}
        bad = 0
        for r in records:
            if r[2] != 200 or r[4] <= 0:
                continue
            if r[4] < last.get(r[3], 0):
                bad += 1
            else:
                last[r[3]] = r[4]
        return bad


def phase_fleet(device, ctx: dict, plain: dict, smi: str) -> dict:
    """``pio deploy --replicas N`` of the workflow's warm instance at each
    ``FLT_REPLICAS`` under the [serving] phase's 32 x 25 uniform load,
    beside its single-process deploy (``plain``); on the 2-replica fleet
    the SIGKILL drill and a rolling ``POST /reload`` under 16 clients.
    Every answer through a router is held to float64 numpy; the fleet
    paths launch no kernel."""
    t_phase = time.perf_counter()
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    first = ctx["instance"]
    model = stored_model(first.id)
    user_index, item_index = model.user_index, model.item_index
    U64 = np.asarray(model.user_factors, np.float64)
    V64 = np.asarray(model.item_factors, np.float64)
    del model
    deploy = ["deploy", "--engine-json", str(engine_json), "--engine-instance-id", first.id, *dev_args]
    clients, per_client = SRV_CLIENTS, SRV_REQUESTS
    uniform = load_picks(clients * per_client, len(user_index), seed=31)  # the [serving] phase's picks
    out: dict = {"single_process": {key: plain[key] for key in ("queries_per_s", "p50_ms", "p99_ms")},
                 "scaling": {}, "card": smi}
    checked = 0
    idle_mib = smi_memory_used_mib() if device.type == "cuda" else 0
    deadline = time.perf_counter() + 15
    while (others := console_processes()) and time.perf_counter() < deadline:
        time.sleep(0.1)
    log(f"[fleet] before the fleets: card memory used {idle_mib} MiB, load average {os.getloadavg()}, other "
        f"console processes {others}")
    if others:
        raise RuntimeError(f"fleet: console processes of earlier phases still run: {others}")
    reset_launch_counts()
    for n in FLT_REPLICAS:
        fleet = start_fleet("fleet", base, deploy, n)
        done = False
        try:
            memory = smi_processes() if device.type == "cuda" else []
            used = smi_memory_used_mib() if device.type == "cuda" else 0
            pids = {"router": fleet["proc"].pid, **{f"replica{i}": pid for i, pid in enumerate(fleet_pids(fleet))}}
            with busy_shares(pids, device) as busy:
                load = run_load(fleet["url"], uniform, user_index, clients, TOP_K)
            checked += check_answers(f"fleet x{n}", ok_answers(f"fleet x{n}", load), U64, V64, item_index, TOP_K)
            _, stats = _http_json(fleet["url"] + "/stats.json")
            run = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
            run.update({"ready_s": fleet["ready_s"], "router": stats["router"],
                        "forwarded": {r["id"]: r["forwarded"] for r in stats["replicas"]},
                        "card_memory_used_mib": used, "mib_per_replica": (used - idle_mib) / n,
                        "contexts": len(memory), "per_process_memory": memory, "cores_busy": busy})
            out["scaling"][n] = run
            log(f"[fleet] pio deploy --replicas {n}: ring full in {fleet['ready_s']:.3f} s; {load['queries']} "
                f"queries from {clients} keep-alive clients, {load['queries_per_s']:.1f} queries/s, p50 "
                f"{load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms (single-process deploy "
                f"{plain['queries_per_s']:.1f} queries/s, p50 {plain['p50_ms']:.3f} ms, p99 {plain['p99_ms']:.3f} "
                f"ms); router {json.dumps(stats['router'])}; forwarded {json.dumps(run['forwarded'])}; card memory "
                f"used {used} MiB, {run['mib_per_replica']:.1f} MiB a replica above the {idle_mib} MiB before the "
                f"fleets; nvidia-smi lists {len(memory)} contexts: {memory}; cores busy during the load "
                f"{json.dumps({key: round(v, 3) if isinstance(v, float) else v for key, v in busy.items()})} on "
                f"{smi}")
            if n == 2:
                out["sigkill"], answers = fleet_sigkill_drill(fleet, user_index, smi)
                checked += check_answers("fleet sigkill", answers, U64, V64, item_index, TOP_K)
                out["rolling"], answers = fleet_rolling_reload(fleet, user_index, smi)
                checked += check_answers("fleet rolling reload", answers, U64, V64, item_index, TOP_K)
            done = True
        finally:
            out["scaling"].setdefault(n, {})["stop_s"] = stop_fleet(fleet, check=done)
    launches = read_launch_counts()
    if any(launches.values()):
        raise RuntimeError(f"fleet: the fleet paths launched kernels {launches}; they have none")
    out.update({"answers_checked": checked, "launches": launches, "phase_s": time.perf_counter() - t_phase})
    log(f"[fleet] {checked} answers through the routers equal float64 numpy's top-{TOP_K} (near-tie rule); "
        f"launches {json.dumps(launches)}")
    log(f"[fleet] {json.dumps(out)}")
    return out


def fleet_sigkill_drill(fleet: dict, user_index, smi: str) -> tuple[dict, list]:
    """16 clients for ``FLT_DRILL_S`` seconds, one replica SIGKILLed at
    ``FLT_KILL_AT_S``; the clients go on until the supervisor's respawn
    is back in the ring. No query may fail."""
    rows = np.random.default_rng(37).permutation(len(user_index))[:FLT_DRILL_CLIENTS * 64]
    state = json.loads(fleet["state"].read_text())
    victim = state["replicas"][0]
    drill = DrillClients(fleet["url"], rows, user_index, FLT_DRILL_CLIENTS, TOP_K)
    time.sleep(FLT_KILL_AT_S)
    t_kill = time.perf_counter()
    os.kill(int(victim["pid"]), signal.SIGKILL)
    rejoin_s = None
    deadline = t_kill + FLT_READY_TIMEOUT_S
    while time.perf_counter() < deadline:
        doc = json.loads(fleet["state"].read_text())
        rep = next(r for r in doc["replicas"] if r["id"] == victim["id"])
        if rep.get("alive") and rep.get("pid") != victim["pid"]:
            _, root = _http_json(fleet["url"] + "/")
            if any(r["id"] == victim["id"] and r["healthy"] for r in root["replicas"]):
                rejoin_s = time.perf_counter() - t_kill
                break
        time.sleep(0.05)
    t_rejoin = time.perf_counter()
    time.sleep(max(1.0, FLT_DRILL_S - (t_rejoin - t_kill + FLT_KILL_AT_S)))
    records = drill.join()
    failed = DrillClients.failed(records)
    if rejoin_s is None or failed:
        raise RuntimeError(f"fleet: SIGKILL drill: rejoin {rejoin_s} s, {len(failed)} failed queries of "
                           f"{len(records)}: {[r[:4] for r in failed[:5]]}")
    before = [r for r in records if r[1] < t_kill]
    after = [r for r in records if r[0] > t_rejoin]
    _, stats = _http_json(fleet["url"] + "/stats.json")
    out = {"clients": FLT_DRILL_CLIENTS, "queries": len(records), "failed": 0, "killed": victim["id"],
           "rejoin_s": rejoin_s, "p99_ms_before": DrillClients.p99_ms(before),
           "p99_ms_after": DrillClients.p99_ms(after), "p99_ms_all": DrillClients.p99_ms(records),
           "failovers": stats["router"]["failovers"], "wall_s": records[-1][1] - records[0][0]}
    log(f"[fleet] SIGKILL drill: {FLT_DRILL_CLIENTS} clients, replica {victim['id']} (pid {victim['pid']}) "
        f"SIGKILLed at {FLT_KILL_AT_S:g} s; {len(records)} queries, 0 failed; respawn back in the ring in "
        f"{rejoin_s:.3f} s; p99 {out['p99_ms_before']:.3f} ms before the kill, {out['p99_ms_after']:.3f} ms after "
        f"the rejoin; router failovers {out['failovers']} on {smi}")
    return out, [(r[3], r[6]) for r in records]


def fleet_rolling_reload(fleet: dict, user_index, smi: str) -> tuple[dict, list]:
    """A rolling ``POST /reload`` through the router under 16 clients: no
    failed query, no scope answered by an older generation after a newer
    one, and every replica on one generation after it."""
    rows = np.random.default_rng(38).permutation(len(user_index))[:FLT_DRILL_CLIENTS * 64]
    drill = DrillClients(fleet["url"], rows, user_index, FLT_DRILL_CLIENTS, TOP_K)
    time.sleep(FLT_ROLL_LEAD_S)
    t0 = time.perf_counter()
    status, report = _http_json(fleet["url"] + "/reload", {})
    reload_s = time.perf_counter() - t0
    time.sleep(FLT_ROLL_LEAD_S)
    records = drill.join()
    failed = DrillClients.failed(records)
    cross = DrillClients.cross_generation(records)
    gens = sorted({r[4] for r in records if r[0] > t0 + reload_s})
    if status != 200 or not report.get("ok") or not report.get("converged") or failed or cross or len(gens) != 1:
        raise RuntimeError(f"fleet: rolling reload answered {status} {report}; {len(failed)} failed queries, {cross} "
                           f"cross-generation answers, generations after it {gens}")
    out = {"queries": len(records), "failed": 0, "cross_generation": 0, "reload_s": reload_s,
           "generations": report["generations"], "p99_ms": DrillClients.p99_ms(records)}
    log(f"[fleet] rolling POST /reload under {FLT_DRILL_CLIENTS} clients: {len(records)} queries, 0 failed, 0 "
        f"cross-generation answers; converged on generation {report['generations']} in {reload_s:.3f} s on {smi}")
    return out, [(r[3], r[6]) for r in records]


def console_eval(label: str, base: Path, module: str, source: str, extra: list) -> tuple[dict, dict, float]:
    """``pio eval module:evaluation`` of a module written into ``base``;
    the launch counts set to 0 before it and read after. Returns the
    result JSON, the counts and the seconds."""
    (base / f"{module}.py").write_text(source)
    sys.path.insert(0, str(base))
    try:
        reset_launch_counts()
        try:
            eval_s = console_ok(label, ["eval", f"{module}:evaluation", "--output-path", str(base / f"{module}.json"),
                                        *extra])
        except SystemExit as e:  # --promote-to's refusals
            raise RuntimeError(f"{label}: {e}") from None
        launches = read_launch_counts()
    finally:
        sys.path.remove(str(base))
        sys.modules.pop(module, None)
    (instance,) = [i for i in Storage.get_meta_data_evaluation_instances().get_all()
                   if i.evaluation_class == f"{module}:evaluation"]
    if instance.status != "EVALCOMPLETED":
        raise RuntimeError(f"{label}: evaluation instance {instance.id} is {instance.status}")
    return json.loads((base / f"{module}.json").read_text()), launches, eval_s


def phase_fleet_ab(device, ctx: dict, smi: str) -> dict:
    """On the quickstart's store: ``pio deploy --replicas 2 --variants
    control:1,treatment:1``; 8 clients x 40 users, twice: each variant's
    share within 0.05 of 0.5, a user keeps its variant, every
    ``X-PIO-Variant`` answered the port's ``TrafficSplit`` assignment;
    then ``pio eval --grid --promote-to`` of a 2-candidate grid under the
    same clients rolls the fleet onto the winner with no failed query."""
    from predictionio_tpu_torch.experiments.split import SplitConfig, TrafficSplit
    from predictionio_tpu_torch.serving.cache import affinity_key

    t_phase = time.perf_counter()
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    model = ctx["model"]
    user_index, item_index = model.user_index, model.item_index
    U64 = np.asarray(model.user_factors, np.float64)
    V64 = np.asarray(model.item_factors, np.float64)
    split = TrafficSplit(SplitConfig.parse(FLT_AB_SPLIT))
    deploy = ["deploy", "--engine-json", str(engine_json), *dev_args, "--variants", FLT_AB_SPLIT]
    rows = np.arange(FLT_AB_CLIENTS * FLT_AB_QUERIES)
    reset_launch_counts()
    fleet = start_fleet("fleet ab", base, deploy, 2)
    done = False
    try:
        records = DrillClients(fleet["url"], rows, user_index, FLT_AB_CLIENTS, TOP_K, passes=2).join()
        want = {r: split.assign(affinity_key({"user": user_index.inverse(r), "num": TOP_K}, "user"))
                for r in rows.tolist()}
        seen: dict = {}
        bad = [r[:6] for r in records if r[2] != 200 or r[5] != want[r[3]] or seen.setdefault(r[3], r[5]) != r[5]]
        share = sum(1 for v in want.values() if v == "control") / len(want)
        if bad or len(records) != 2 * len(rows) or abs(share - 0.5) > FLT_AB_SHARE_TOL:
            raise RuntimeError(f"fleet ab: {len(bad)} answers failed, off their variant or changed it "
                               f"({bad[:5]}); {len(records)} answers; control share {share}")
        _, before = _http_json(fleet["url"] + "/experiments.json")
        # the promotion: a 2-candidate grid, one candidate a variant, under load
        drill = DrillClients(fleet["url"], rows, user_index, FLT_AB_CLIENTS, TOP_K)
        source = GRID_MODULE.format(k=TOP_K, app=QS_APP, folds=QS_EVAL_K, rank=EXP_GRID_RANK, sweeps=EXP_GRID_SWEEPS,
                                    candidates=[(0.01, 0), (0.5, 0)])
        result, launches, eval_s = console_eval("fleet ab", base, "qs_ab", source,
                                                ["--grid", "--promote-to", fleet["url"], *dev_args])
        time.sleep(0.5)
        during = drill.join()
        winner = split.variant_names()[result["bestIdx"]]
        failed = DrillClients.failed(during)
        _, after = _http_json(fleet["url"] + "/experiments.json")
        registry = json.loads((base / "fleet" / "model-registry.json").read_text())["current"]
        post = DrillClients(fleet["url"], rows[:FLT_AB_CLIENTS * 4], user_index, FLT_AB_CLIENTS, TOP_K,
                            passes=1).join()
        if (failed or (after.get("promoted") or {}).get("variant") != winner
                or registry.get("meta", {}).get("variant") != winner
                or any(r[2] != 200 or r[5] != winner for r in post) or any(launches.values())):
            raise RuntimeError(f"fleet ab: promotion of {winner}: {len(failed)} failed queries of {len(during)}; "
                               f"experiments {after}; registry {registry}; after it "
                               f"{sorted({r[5] for r in post})}; grid launches {launches}")
        _, stats = _http_json(fleet["url"] + "/stats.json")
        # every answer is the one instance's: promotion reloads it
        checked = check_answers("fleet ab", [(r[3], r[6]) for r in records + during + post], U64, V64, item_index,
                                TOP_K)
        done = True
    finally:
        stop_s = stop_fleet(fleet, check=done)
    routed = {v["name"]: v["routed"] for v in before["variants"]}
    out = {"queries": len(records), "control_share": share, "routed": routed, "winner": winner,
           "grid_eval_s": eval_s, "promotion_queries": len(during), "promotion_failed": 0,
           "registry_generation": registry["generation"], "ready_s": fleet["ready_s"], "stop_s": stop_s,
           "answers_checked": checked,
           "variant_p99_ms": {v["name"]: v["p99Ms"] for v in stats["experiments"]["variants"]},
           "phase_s": time.perf_counter() - t_phase, "card": smi}
    log(f"[fleet] A/B {FLT_AB_SPLIT}: {len(records)} answers from {FLT_AB_CLIENTS} clients x {FLT_AB_QUERIES} users "
        f"twice, control share {share:.4f}, every user on one variant and every X-PIO-Variant the split's; pio eval "
        f"--grid --promote-to in {eval_s:.3f} s promoted {winner} (registry generation {registry['generation']}) "
        f"under {len(during)} queries, 0 failed; {checked} answers equal float64 numpy's top-{TOP_K} on {smi}")
    log(f"[fleet] {json.dumps(out)}")
    return out


# ------------------------------------------------------- 14. experiments
def phase_explore_loop(device, smi: str) -> dict:
    """The JAX bench's closed loop (``bench.py:3021-3100``) with the
    port's ``Explorer`` on ``device``: the true-best arm hides below a
    mediocre arm whose prior overstates it; Thompson's cumulative regret
    must be below exploit-only's."""
    from predictionio_tpu_torch.experiments.explore import ExploreConfig, Explorer

    rng_true = np.random.default_rng(7)
    p_true = 0.05 + 0.25 * rng_true.random(EXP_ARMS)
    best_arm, greedy_arm = 1, 0
    p_true[greedy_arm] = 0.40
    p_true[best_arm] = 0.75
    prior = 0.05 + 0.30 * rng_true.random(EXP_ARMS)
    prior[greedy_arm] = 0.55
    prior[best_arm] = 0.22
    p_best = float(p_true.max())

    def run_policy(config: ExploreConfig) -> dict:
        ex = Explorer(config, device)
        rng = np.random.default_rng(config.seed + 13)
        scores = prior.copy()
        pulls = np.zeros(EXP_ARMS, np.int64)
        reward_sum = np.zeros(EXP_ARMS, np.float64)
        regret = 0.0
        t0 = time.perf_counter()
        for q in range(EXP_QUERIES):
            order = np.argsort(-scores)
            served = int(ex.rerank([{"item": str(i), "score": float(scores[i])} for i in order])[0]["item"])
            reward = float(rng.random() < p_true[served])
            pulls[served] += 1
            reward_sum[served] += reward
            regret += p_best - float(p_true[served])
            ex.note_reward_events([{"event": config.reward_event, "targetEntityId": str(served),
                                    "properties": {"value": reward}}])
            if (q + 1) % EXP_RETRAIN == 0:
                obs = pulls > 0
                scores = np.where(obs, (reward_sum + 2.0 * prior) / (pulls + 2.0), prior)
        stats = ex.stats_json()
        if stats["lastError"] is not None:
            raise RuntimeError(f"experiments: the explorer failed: {stats['lastError']}")
        return {"cumulative_regret": regret, "best_arm_frac": float(pulls[best_arm]) / EXP_QUERIES,
                "explored": stats["explored"], "rerank_ms": (time.perf_counter() - t0) * 1e3 / EXP_QUERIES,
                "reward_events": stats["rewards"]["events"]}

    exploit = run_policy(ExploreConfig(policy="epsilon", epsilon=0.0, seed=0))
    thompson = run_policy(ExploreConfig(policy="thompson", seed=0, prior_scale=0.5))
    if not thompson["cumulative_regret"] < exploit["cumulative_regret"]:
        raise RuntimeError(f"experiments: Thompson's regret {thompson['cumulative_regret']} is not below "
                           f"exploit-only's {exploit['cumulative_regret']}")
    out = {"arms": EXP_ARMS, "queries": EXP_QUERIES, "exploit": exploit, "thompson": thompson, "card": smi}
    log(f"[experiments] closed loop, {EXP_ARMS} arms, {EXP_QUERIES} queries on {device}: cumulative regret Thompson "
        f"{thompson['cumulative_regret']:.3f} (best arm {thompson['best_arm_frac']:.4f} of pulls), exploit-only "
        f"{exploit['cumulative_regret']:.3f} ({exploit['best_arm_frac']:.4f}); rerank {thompson['rerank_ms']:.3f} ms "
        f"(Thompson), {exploit['rerank_ms']:.3f} ms (epsilon) a query on {smi}")
    return out


def phase_explore_deploy(device, ctx: dict, smi: str) -> dict:
    """On the workflow's warm instance: ``pio deploy`` against ``pio
    deploy --explore thompson`` under the [serving] load (each answer's
    items, by their score, the float64 top-10 under the near-tie rule),
    rewards through ``POST /experiments/reward.json``; then ``--explore
    thompson --online``, whose follower must fold exactly the reward
    events written to the store."""
    from predictionio_tpu_torch.data.event import DataMap, Event

    t_phase = time.perf_counter()
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    first = ctx["instance"]
    model = stored_model(first.id)
    user_index, item_index = model.user_index, model.item_index
    U64 = np.asarray(model.user_factors, np.float64)
    V64 = np.asarray(model.item_factors, np.float64)
    del model
    deploy = ["deploy", "--engine-json", str(engine_json), "--engine-instance-id", first.id, *dev_args]
    picks = load_picks(SRV_CLIENTS * SRV_REQUESTS, len(user_index), seed=31)
    out: dict = {"card": smi}
    reset_launch_counts()
    for label, flags in (("plain", []), ("thompson", ["--explore", "thompson"])):
        t0 = time.perf_counter()
        proc, port = start_console_server(f"explore {label}", base, deploy + flags,
                                          base / f"deploy-explore-{label}.stderr", QS_DEPLOY_TIMEOUT_S)
        try:
            start_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            with busy_shares({"deploy": proc.pid}, device) as busy:
                load = run_load(url, picks, user_index, SRV_CLIENTS, TOP_K)
            answers = ok_answers(f"explore {label}", load)
            greedy = [(u, {"itemScores": sorted(p["itemScores"], key=lambda s: -s["score"])}) for u, p in answers]
            check_answers(f"explore {label}", greedy, U64, V64, item_index, TOP_K)
            run = {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")}
            run.update({"deploy_start_s": start_s, "cores_busy": busy})
            if label == "thompson":
                reordered = sum(1 for (_, p), (_, g) in zip(answers, greedy) if p["itemScores"] != g["itemScores"])
                served = [p["itemScores"][0]["item"] for _, p in answers[:EXP_REWARDS_POSTED]]
                status, body = _http_json(url + "/experiments/reward.json", [
                    {"event": "reward", "entityType": "user", "entityId": user_index.inverse(u),
                     "targetEntityType": "item", "targetEntityId": item, "properties": {"value": 1.0}}
                    for (u, _), item in zip(answers, served)])
                _, stats = _http_json(url + "/stats.json")
                explore = stats["explore"]
                if (status != 200 or body["matched"] != EXP_REWARDS_POSTED or explore["lastError"] is not None
                        or explore["queries"] != load["queries"] or explore["rewards"]["events"] != EXP_REWARDS_POSTED
                        or not 0 < explore["explored"] <= load["queries"]):
                    raise RuntimeError(f"experiments: --explore thompson answered the rewards {status} {body}; "
                                       f"/stats.json explore {explore}")
                run.update({"reordered": reordered, "explore": explore})
            out[label] = run
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        log(f"[experiments] pio deploy {' '.join(flags) or '(plain)'}: {load['queries']} queries from {SRV_CLIENTS} "
            f"keep-alive clients, {load['queries_per_s']:.1f} queries/s, p50 {load['p50_ms']:.3f} ms, p99 "
            f"{load['p99_ms']:.3f} ms, cores busy {json.dumps(run['cores_busy'])}; every answer float64 numpy's "
            f"top-{TOP_K} as a set"
            + (f"; {run['reordered']} reordered, explored {run['explore']['explored']}, regret "
               f"{run['explore']['regret']}, {EXP_REWARDS_POSTED} rewards posted and matched" if label == "thompson"
               else "") + f" on {smi}")
    # rewards through the online follower
    app = Storage.get_meta_data_apps().get_by_name(WF_APP)
    proc, port = start_console_server(
        "explore online", base, deploy + ["--explore", "thompson", "--online", "--online-interval-s",
                                          str(ONL_INTERVAL_S)], base / "deploy-explore-online.stderr",
        QS_DEPLOY_TIMEOUT_S)
    try:
        url = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(52)
        users = rng.choice(len(user_index), EXP_REWARDS_FOLLOWED, replace=False).tolist()
        items = rng.choice(len(item_index), EXP_REWARDS_FOLLOWED).tolist()
        t0 = time.perf_counter()
        Storage.get_l_events().insert_batch([
            Event(event="reward", entity_type="user", entity_id=user_index.inverse(u), target_entity_type="item",
                  target_entity_id=item_index.inverse(i), properties=DataMap({"value": 1.0}))
            for u, i in zip(users, items)], app.id)
        while True:
            _, stats = _http_json(url + "/stats.json")
            if stats["explore"]["rewards"]["events"] >= EXP_REWARDS_FOLLOWED:
                break
            if time.perf_counter() - t0 > EXP_FOLLOW_TIMEOUT_S:
                break
            time.sleep(0.05)
        follow_s = time.perf_counter() - t0
        rewards = stats["explore"]["rewards"]
        if rewards["events"] != EXP_REWARDS_FOLLOWED or rewards["matched"] != EXP_REWARDS_FOLLOWED:
            raise RuntimeError(f"experiments: the follower folded rewards {rewards}, {EXP_REWARDS_FOLLOWED} written")
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    launches = read_launch_counts()
    if any(launches.values()):
        raise RuntimeError(f"experiments: the explore deploys launched kernels {launches}; they have none")
    out["online"] = {"rewards": rewards, "follow_s": follow_s, "events_seen": stats["online"]["eventsSeen"]}
    out["ratio"] = out["thompson"]["queries_per_s"] / out["plain"]["queries_per_s"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[experiments] --explore thompson at {out['ratio']:.4f}x the plain deploy's queries/s; --online follower "
        f"folded {rewards['events']} of {EXP_REWARDS_FOLLOWED} reward events in {follow_s:.3f} s")
    log(f"[experiments] {json.dumps(out)}")
    return out


def bench_fold(users: int, seed: int) -> dict:
    """``bench.py``'s sweep fold: two halves of the catalog, 10 liked
    items a user, 7 observed and 3 held out."""
    rng = np.random.default_rng(seed)
    R = np.zeros((users, users), np.float32)
    T = np.zeros((users, users), np.float32)
    centers = rng.integers(0, 2, users)
    for u in range(users):
        half = np.arange(users // 2) + (users // 2) * centers[u]
        liked = rng.choice(half, size=10, replace=False)
        R[u, liked[:7]] = 1.0
        T[u, liked[7:]] = 1.0
    return {"R": R, "M": R.copy(), "T": T, "seen": R.copy(), "user_w": np.ones(users, np.float32),
            "item_valid": np.ones(users, np.float32)}


def timed_grid(device, arrays: dict, regs, alphas, seeds, statics: dict, single: bool) -> float:
    """Seconds of one batched :func:`grid_train_eval` call over every
    candidate, or (``single``) of one call per candidate, the scores
    read back."""
    from predictionio_tpu_torch.experiments.sweep import grid_train_eval

    args = [torch.as_tensor(arrays[key], device=device) for key in ("R", "M", "T", "seen", "user_w", "item_valid")]
    t0 = time.perf_counter()
    if single:
        for c in range(len(regs)):
            grid_train_eval(*args, regs[c:c + 1], alphas[c:c + 1], seeds[c:c + 1], **statics, device=device).cpu()
    else:
        grid_train_eval(*args, regs, alphas, seeds, **statics, device=device).cpu()
    return time.perf_counter() - t0


def phase_grid(device, ctx: dict, smi: str) -> dict:
    """``pio eval --grid`` on the quickstart's store; see the module
    docstring, phase 14."""
    from predictionio_tpu_torch.experiments.sweep import MAX_GRID_CELLS, fold_arrays, grid_train_eval
    from predictionio_tpu_torch.templates.recommendation.engine import DataSourceParams, RecommendationDataSource

    t_phase = time.perf_counter()
    base, dev_args = ctx["base"], ctx["dev_args"]
    candidates = [(lam, seed) for lam in EXP_GRID_LAMBDAS for seed in EXP_GRID_SEEDS]
    C = len(candidates)
    source = GRID_MODULE.format(k=TOP_K, app=QS_APP, folds=QS_EVAL_K, rank=EXP_GRID_RANK, sweeps=EXP_GRID_SWEEPS,
                                candidates=candidates)
    handler = RecordHandler()
    sweep_log = logging.getLogger("predictionio_tpu_torch.experiments.sweep")
    level = sweep_log.level
    sweep_log.addHandler(handler)
    sweep_log.setLevel(logging.INFO)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        grid, grid_launches, grid_s = console_eval("grid", base, "qs_grid", source, ["--grid", *dev_args])
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        sweep_log.removeHandler(handler)
        sweep_log.setLevel(level)
    if not any("in one batched program per fold" in m for m in handler.messages) or any(grid_launches.values()):
        raise RuntimeError(f"grid: the grid did not run as one batched program ({handler.messages}) or launched "
                           f"kernels {grid_launches}")
    scores32 = np.asarray([s["score"] for s in grid["engineParamsScores"]])
    program_s = grid["engineParamsScores"][0]["seconds"] * C

    # the same grid in float64 on the card, from the same draw
    folds = RecommendationDataSource(DataSourceParams(app_name=QS_APP, eval_k=QS_EVAL_K)).read_eval(
        local_context(device))
    prepared = [fold_arrays(td, qa, TOP_K) for td, _, qa in folds]
    cells = [C * a["R"].size for a, _, _ in prepared]
    regs = np.float32([lam for lam, _ in candidates])
    alphas = np.ones(C, np.float32)
    seeds = np.int64([seed for _, seed in candidates])
    statics = dict(rank=EXP_GRID_RANK, iterations=EXP_GRID_SWEEPS, implicit=False)
    num, den = np.zeros(C), 0.0
    t0 = time.perf_counter()
    for arrays, n_eval, k_eff in prepared:
        f64 = {key: value.astype(np.float64) for key, value in arrays.items()}
        s = grid_train_eval(*f64.values(), regs.astype(np.float64), alphas.astype(np.float64), seeds, **statics,
                            k=k_eff, device=device)
        num += s.cpu().numpy() * n_eval
        den += n_eval
    f64_s = time.perf_counter() - t0
    scores64 = num / den
    worst = float(np.abs(scores32 - scores64).max())
    best32, best64 = int(np.argmax(scores32)), int(np.argmax(scores64))
    top2 = np.sort(scores64)[-2:]
    if worst > EXP_F64_ATOL or (best32 != best64 and top2[1] - top2[0] > EXP_F64_ATOL) or (
            grid["bestIdx"] != best32 or max(cells) > MAX_GRID_CELLS):
        raise RuntimeError(f"grid: f32 scores {scores32.tolist()} against float64 {scores64.tolist()} (worst "
                           f"{worst}), winners {grid['bestIdx']}/{best32}/{best64}; cells {cells}")

    # the sequential pio eval of the first candidates, its solves on the kernel
    seq_source = GRID_MODULE.format(k=TOP_K, app=QS_APP, folds=QS_EVAL_K, rank=EXP_GRID_RANK,
                                    sweeps=EXP_GRID_SWEEPS, candidates=candidates[:EXP_SEQ_CANDIDATES])
    seq, seq_launches, seq_s = console_eval("grid sequential", base, "qs_seq", seq_source, dev_args)
    cfg = ALSConfig(rank=EXP_GRID_RANK)
    plan = EXP_SEQ_CANDIDATES * EXP_GRID_SWEEPS * sum(
        planned_solves(td.rows, len(td.user_index), cfg) + planned_solves(td.cols, len(td.item_index), cfg)
        for td, _, _ in folds)
    if device.type == "cuda":
        check_launches("grid sequential eval", seq_launches, {"gj_solve": plan})

    # batched against one call a candidate: the JAX bench's size, then full size
    b = EXP_BENCH
    bench = bench_fold(b["users"], 3)
    b_regs = torch.as_tensor(np.geomspace(0.01, 100.0, b["candidates"]).astype(np.float32))
    b_alphas = torch.zeros(b["candidates"])
    b_seeds = torch.zeros(b["candidates"], dtype=torch.int64)
    b_statics = dict(rank=b["rank"], iterations=b["iterations"], implicit=False, k=b["k"])
    timings = {}
    for single in (False, True):
        timed_grid(device, bench, b_regs, b_alphas, b_seeds, b_statics, single)  # warm
        timings[single] = min(timed_grid(device, bench, b_regs, b_alphas, b_seeds, b_statics, single)
                              for _ in range(b["reps"]))
    bench_ratio = timings[True] / timings[False]
    if bench_ratio < EXP_BENCH_MIN_RATIO:
        raise RuntimeError(f"grid: at the JAX bench's size one batched call took {timings[False]} s against "
                           f"{timings[True]} s for {b['candidates']} single calls ({bench_ratio:.3f}x, "
                           f"the reference asks {EXP_BENCH_MIN_RATIO}x)")
    arrays0, _, k0 = prepared[0]
    full_args = (torch.as_tensor(regs), torch.as_tensor(alphas), torch.as_tensor(seeds), {**statics, "k": k0})
    full = {single: timed_grid(device, arrays0, *full_args[:3], full_args[3], single) for single in (False, True)}
    full_ratio = full[True] / full[False]
    out = {
        "candidates": C, "folds": len(prepared), "fold_shapes": [list(a["R"].shape) for a, _, _ in prepared],
        "cells": cells, "grid_eval_s": grid_s, "grid_program_s": program_s, "grid_s_per_candidate": grid_s / C,
        "grid_peak_gib": peak / 2**30, "scores": scores32.tolist(), "best_idx": grid["bestIdx"],
        "f64_scores": scores64.tolist(), "f64_worst_abs": worst, "f64_s": f64_s,
        "sequential_candidates": EXP_SEQ_CANDIDATES, "sequential_eval_s": seq_s,
        "sequential_s_per_candidate": seq_s / EXP_SEQ_CANDIDATES, "sequential_launches": seq_launches["gj_solve"],
        "sequential_plan": plan, "sequential_best": seq["bestScore"]["score"],
        "grid_launches": grid_launches, "bench_batched_s": timings[False], "bench_single_s": timings[True],
        "bench_ratio": bench_ratio, "full_batched_s": full[False], "full_single_s": full[True],
        "full_ratio": full_ratio, "phase_s": time.perf_counter() - t_phase, "card": smi,
    }
    log(f"[experiments] pio eval --grid: {C} candidates x {len(prepared)} folds (padded "
        f"{out['fold_shapes']}, {max(cells)} cells) in {grid_s:.3f} s, {grid_s / C:.3f} s a candidate "
        f"({program_s:.3f} s in the batched programs), peak {peak / 2**30:.3f} GiB, 0 launches; best candidate "
        f"{grid['bestIdx']} precision@{TOP_K} {scores32[grid['bestIdx']]:.6f}; float64 from the same draw within "
        f"{worst:.3g} (bar {EXP_F64_ATOL:g}), best {best64}; sequential pio eval of {EXP_SEQ_CANDIDATES} candidates "
        f"{seq_s:.3f} s, {seq_s / EXP_SEQ_CANDIDATES:.3f} s a candidate, {seq_launches['gj_solve']} gj_solve "
        f"launches (plan {plan}); one batched call against {b['candidates']} single calls: {timings[False]:.4f} s "
        f"vs {timings[True]:.4f} s ({bench_ratio:.2f}x) at the JAX bench's size, {full[False]:.3f} s vs "
        f"{full[True]:.3f} s ({full_ratio:.2f}x) at full size on {smi}")
    log(f"[experiments] {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ 16. aot
#: the query counts the tier-1 programs are held to the eager path at
AOT_CHECK_QUERIES = (1, 3, 8, 13, 32, 512)
#: users of the in-process handle_batch held to the eager service's
AOT_BATCH_USERS = 1000
#: single queries timed through each in-process service (legs A B B A)
AOT_HANDLE_QUERIES = 400
#: requests a client of the [aot] load (the bench's 100)
AOT_REQUESTS = 25
AOT_RELOADS = 2
AOT_RELOAD_SLACK = 1 << 20
AOT_FALLBACK_USERS = 64


@contextlib.contextmanager
def saved_env(*names: str):
    """The variables ``names`` as they were before the block, after it."""
    saved = {name: os.environ.get(name) for name in names}
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def extracted_packages() -> int:
    """Entries under the temporary directory, where ``aoti_load_package``
    unpacks each program in some torch versions."""
    return sum(1 for _ in Path(tempfile.gettempdir()).iterdir())


def aot_train(label: str, ctx: dict, plan: dict, device) -> dict:
    """``pio train --aot`` in process on the phase's store: its kernel
    launches held to ``plan``, the artifact set's manifest read back and
    ``pio status`` (``aot_artifact_status``) saying ``present`` for the
    new generation."""
    from predictionio_tpu_torch.fleet.registry import aot_artifact_dir, read_aot_manifest
    from predictionio_tpu_torch.tools import commands

    reset_launch_counts()
    wall_s = console_ok(label, ["train", "--engine-json", str(ctx["engine_json"]), "--aot", *ctx["dev_args"]])
    launches = read_launch_counts()
    if device.type == "cuda":
        check_launches(label, launches, plan)
    instance = max(Storage.get_meta_data_engine_instances().get_all(), key=lambda i: i.start_time)
    root = ctx["base"] / "fleet" / "aot"
    manifest = read_aot_manifest(aot_artifact_dir(str(root), instance.id))
    if manifest is None:
        raise RuntimeError(f"{label}: pio train --aot wrote no artifact set for {instance.id}")
    console_ok(label, ["status", *ctx["dev_args"]])
    rows = commands.aot_artifact_status(out=lambda line: None, device=str(device))
    row = next((r for r in rows or () if r["engineInstanceId"] == instance.id), None)
    if row is None or row["artifacts"] != "present":
        raise RuntimeError(f"{label}: pio status reports {row} for the exported generation")
    entries = manifest["entries"]
    out = {"instance": instance, "root": root, "manifest": manifest, "train_wall_s": wall_s,
           "launches": {name: launches[name] for name in plan}, "planned": plan, "programs": len(entries),
           "artifact_bytes": sum(e["bytes"] for e in entries), "export_s": manifest["exportSeconds"],
           "export_workers": manifest.get("exportWorkers"), "fingerprint": manifest["fingerprint"],
           "status": row["artifacts"]}
    log(f"[aot] {label}: pio train --aot {wall_s:.3f} s, export {out['export_s']} s in "
        f"{out['export_workers']} processes, {out['programs']} programs, {out['artifact_bytes']} bytes, "
        f"slowest program {max(e['exportSeconds'] for e in entries)} s; launches {json.dumps(out['launches'])} "
        f"(plan {json.dumps(plan)}); fingerprint {json.dumps(out['fingerprint'])}; pio status: {row['artifacts']}")
    return out


def aot_deploys_ab(label: str, ctx: dict, user_index, picks: np.ndarray, clients: int, k: int,
                   expect_programs: int) -> dict:
    """A plain ``--pin-model`` deploy and a ``--aot`` one of the phase's
    instance, side by side, under ``clients`` keep-alive clients: four
    legs of half the picks in the order A B B A (plain, aot, aot, plain),
    so each answers every pick once. The ``--aot`` deploy must say tier 1
    with every program loaded, answer every pick byte for byte as the
    plain one, and have served through its programs (hits) with no
    serve-time compile. Returns each deploy's start seconds, queries/s,
    per-leg p50 / p99, its answers and the ``aot`` block."""
    base, engine_json, dev_args = ctx["base"], ctx["engine_json"], ctx["dev_args"]
    procs: dict = {}
    try:
        # both start at once: they serve side by side anyway
        starts, urls, spawned = {}, {}, {}
        t0 = time.perf_counter()
        for name, extra in (("plain", ["--pin-model"]), ("aot", ["--aot"])):
            spawned[name] = spawn_console_server(label, base, ["deploy", "--engine-json", str(engine_json),
                                                               *dev_args, *extra],
                                                 base / f"deploy-{label}-{name}.stderr")
            procs[name] = spawned[name][3]
        for name, started in spawned.items():
            _, port = bound_console_server(*started, QS_DEPLOY_TIMEOUT_S)
            starts[name] = time.perf_counter() - t0
            urls[name] = f"http://127.0.0.1:{port}"
        _, booted = _http_json(urls["aot"] + "/stats.json")
        block = booted.get("aot") or {}
        if block.get("tier") != 1 or block.get("loaded") != expect_programs or block.get("problems"):
            raise RuntimeError(f"{label}: the --aot deploy booted {block}, not tier 1 with {expect_programs} programs")
        _, root_status = _http_json(urls["aot"] + "/")
        if root_status.get("aot") is not True:
            raise RuntimeError(f"{label}: GET / of the --aot deploy says aot {root_status.get('aot')}")
        half = len(picks) // 2
        runs: dict = {"plain": [], "aot": []}
        answers: dict = {"plain": [], "aot": []}
        for name, part in (("plain", picks[:half]), ("aot", picks[:half]), ("aot", picks[half:]),
                           ("plain", picks[half:])):
            load = run_load(urls[name], part, user_index, clients, k)
            answers[name] += ok_answers(f"{label} {name}", load)
            runs[name].append({key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")})
        _, served = _http_json(urls["aot"] + "/stats.json")
        block = served["aot"]
        for name, proc in list(procs.items()):
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            del procs[name]
            if rc != 0:
                raise RuntimeError(f"{label}: the {name} deploy exited {rc} on SIGTERM")
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=30)
    plain_by_user = {u: json.dumps(p) for u, p in answers["plain"]}
    differ = [u for u, p in answers["aot"] if json.dumps(p) != plain_by_user[u]]
    if differ:
        raise RuntimeError(f"{label}: {len(differ)} of {len(answers['aot'])} --aot answers differ from the plain "
                           f"pinned deploy's bytes, users {differ[:5]}")
    if block["hits"] <= 0 or block["serveTimeCompiles"] != 0 or block["disabled"] != 0:
        raise RuntimeError(f"{label}: after the load the --aot deploy reports {block}")
    out = {"deploy_start_s": starts, "block": block, "answers": answers["aot"]}
    for name, legs in runs.items():
        out[name] = {"queries": sum(r["queries"] for r in legs),
                     "queries_per_s": sum(r["queries"] for r in legs) / sum(r["wall_s"] for r in legs),
                     "p50_ms": [r["p50_ms"] for r in legs], "p99_ms": [r["p99_ms"] for r in legs]}
    log(f"[aot] {label}: deploy start --aot {starts['aot']:.3f} s, --pin-model {starts['plain']:.3f} s; "
        f"{clients} clients x {len(picks) // clients} uniform top-{k} a deploy (legs A B B A): --aot "
        f"{out['aot']['queries_per_s']:.1f} queries/s (p50 {out['aot']['p50_ms']} ms, p99 {out['aot']['p99_ms']} ms), "
        f"plain {out['plain']['queries_per_s']:.1f} (p50 {out['plain']['p50_ms']} ms, p99 {out['plain']['p99_ms']} ms); "
        f"every --aot answer byte-equal to the plain deploy's; aot {json.dumps(block)}")
    return out


def aot_programs_vs_eager(label: str, eager_model, runtime, chunk: int, n_users: int, k: int) -> dict:
    """The loaded programs against the eager pinned path on the same
    tables: ``chunked_topk`` with and without ``aot=`` at
    ``AOT_CHECK_QUERIES`` queries, and 64 single queries through
    ``aot_predict``; ids and score bits must be equal."""
    from predictionio_tpu_torch.ops.als import predict_scores
    from predictionio_tpu_torch.ops.topk import top_k_scores
    from predictionio_tpu_torch.templates.serving_util import aot_predict, chunked_topk

    two_tower = hasattr(eager_model, "user_vecs")
    users = eager_model.user_vecs if two_tower else eager_model.user_factors
    items = eager_model.item_vecs if two_tower else eager_model.item_factors
    rng = np.random.default_rng(43)
    hits = runtime.stats()["hits"]
    for n in AOT_CHECK_QUERIES:
        valid = [(j, int(u), k) for j, u in enumerate(rng.integers(0, n_users, n))]
        eager = list(chunked_topk(users, items, valid, chunk=chunk))
        tier1 = list(chunked_topk(users, items, valid, chunk=chunk, aot=runtime))
        if [i for _, i, _ in tier1] != [i for _, i, _ in eager] or [
                np.asarray(s, np.float32).view(np.int32).tolist() for _, _, s in tier1] != [
                np.asarray(s, np.float32).view(np.int32).tolist() for _, _, s in eager]:
            raise RuntimeError(f"{label}: the batch program at {n} queries differs from the eager product")
    n_items = int(items.shape[0])
    for u in rng.integers(0, n_users, 64).tolist():
        want = top_k_scores(predict_scores(users[u], items), k)
        got = aot_predict(runtime, users[u], items, k, n_items)
        if not (torch.equal(got[0], want[0][:k]) and torch.equal(got[1].view(torch.int32), want[1][:k].view(torch.int32))):
            raise RuntimeError(f"{label}: the single-query programs differ from the eager path for user row {u}")
    used = runtime.stats()["hits"] - hits
    if used < len(AOT_CHECK_QUERIES) + 64 or runtime.stats()["disabled"]:
        raise RuntimeError(f"{label}: the checks ran {used} programs, runtime {runtime.stats()}")
    log(f"[aot] {label}: the programs equal the eager pinned path to the bit at {list(AOT_CHECK_QUERIES)} queries "
        f"a batch and for 64 single queries")
    return {"checked_batches": list(AOT_CHECK_QUERIES), "checked_singles": 64}


def aot_handle_ab(services: dict, bodies: list) -> dict:
    """``handle_query`` of ``bodies`` through each in-process service in
    legs A B B A (eager, aot, aot, eager): p50 and queries/s each."""
    half = len(bodies) // 2
    lat: dict = {name: [] for name in services}
    wall: dict = {name: 0.0 for name in services}
    for name, part in (("eager", bodies[:half]), ("aot", bodies[:half]), ("aot", bodies[half:]),
                       ("eager", bodies[half:])):
        t_leg = time.perf_counter()
        for body in part:
            t0 = time.perf_counter()
            status, _ = services[name].handle_query(body)
            lat[name].append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise RuntimeError(f"aot: handle_query answered {status}")
        wall[name] += time.perf_counter() - t_leg
    return {name: {"p50_ms": float(np.percentile(v, 50)), "p99_ms": float(np.percentile(v, 99)),
                   "queries_per_s": len(v) / wall[name]} for name, v in lat.items()}


def aot_fallback_drills(label: str, ctx: dict, variant, instance_id: str, root: Path, eager, user_index,
                        device) -> dict:
    """A foreign-fingerprint copy and a corrupted copy of the artifact
    set: each boots an in-process ``--aot`` service on the fallback tier
    with the loud warning, and serves ``AOT_FALLBACK_USERS`` queries with
    the eager pinned service's bytes."""
    from predictionio_tpu_torch.fleet.registry import aot_artifact_dir
    from predictionio_tpu_torch.workflow.aot import AotConfig

    out = {}
    for kind in ("foreign", "corrupt"):
        drill_root = ctx["base"] / f"aot-{kind}"
        shutil.copytree(aot_artifact_dir(str(root), instance_id), aot_artifact_dir(str(drill_root), instance_id))
        adir = Path(aot_artifact_dir(str(drill_root), instance_id))
        manifest = json.loads((adir / "manifest.json").read_text())
        if kind == "foreign":
            manifest["fingerprint"]["torchVersion"] = "0.0.0-foreign"
            (adir / "manifest.json").write_text(json.dumps(manifest))
        else:
            victim = adir / manifest["entries"][0]["file"]
            blob = bytearray(victim.read_bytes())
            blob[-8:] = bytes(8 * [0x5A])
            victim.write_bytes(bytes(blob))
        handler = RecordHandler()
        aot_logger = logging.getLogger("predictionio_tpu_torch.workflow.aot")
        aot_logger.addHandler(handler)
        try:
            service = QueryService(variant, local_context(device), instance_id=instance_id,
                                   aot=AotConfig(enabled=True, root=str(drill_root)))
        finally:
            aot_logger.removeHandler(handler)
        try:
            block = service.stats_json()["aot"]
            warned = [m for m in handler.messages if "falling back to tier" in m]
            if block.get("tier") not in (2, 3) or not warned:
                raise RuntimeError(f"{label} {kind}: booted {block}, warnings {handler.messages}")
            rng = np.random.default_rng(47)
            for u in rng.integers(0, len(user_index), AOT_FALLBACK_USERS).tolist():
                body = {"user": user_index.inverse(u), "num": TOP_K}
                if json.dumps(service.handle_query(dict(body))) != json.dumps(eager.handle_query(dict(body))):
                    raise RuntimeError(f"{label} {kind}: the fallback tier changed the answer for user row {u}")
        finally:
            service.close()
        out[kind] = {"tier": block["tier"], "problems": block["problems"], "warning": warned[0][:200]}
        log(f"[aot] {label}: {kind} artifact set: tier {block['tier']} with the warning, "
            f"{AOT_FALLBACK_USERS} answers byte-equal to the eager pinned service's; problems {block['problems']}")
    return out


def aot_reload_memory(label: str, service, device) -> dict:
    """``AOT_RELOADS`` reloads of an in-process ``--aot`` service: each on
    tier 1, every superseded generation's ``AotRuntime`` collected (its
    loaded programs remove their unpacked package directories with
    them), ``memory_allocated`` within ``AOT_RELOAD_SLACK`` of the first
    generation's, and no entry added under the temporary directory."""
    import gc
    import weakref

    def settled() -> int:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated(device)
        return 0

    first, dirs_first = settled(), extracted_packages()
    for _ in range(AOT_RELOADS):
        (_, model), = service.snapshot_pairs()[0]
        old = weakref.ref(model._pio_aot)
        del model
        service.reload()
        gc.collect()
        if old() is not None or service.stats_json()["aot"]["tier"] != 1:
            raise RuntimeError(f"{label}: after a reload the superseded runtime is "
                               f"{'alive' if old() is not None else 'gone'}, {service.stats_json()['aot']}")
    last, dirs_last = settled(), extracted_packages()
    if abs(last - first) > AOT_RELOAD_SLACK or dirs_last > dirs_first:
        raise RuntimeError(f"{label}: after {AOT_RELOADS} reloads memory_allocated {first} -> {last}, entries "
                           f"under the temporary directory {dirs_first} -> {dirs_last}")
    log(f"[aot] {label}: {AOT_RELOADS} reloads on tier 1, each superseded generation's programs collected; "
        f"memory_allocated {first} -> {last} bytes, entries under the temporary directory {dirs_first} -> "
        f"{dirs_last}")
    return {"memory_allocated_first": first, "memory_allocated_last": last, "packages_first": dirs_first,
            "packages_last": dirs_last}


def release_card_memory(device) -> None:
    """Collect the phase's garbage and return its cached blocks, so no
    later phase's memory reading counts them."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def phase_aot(device, ctx: dict, smi: str, after_export=None) -> dict:
    """AOT serving of the workflow's warm instance (ML-20M shape, rank 64):
    ``pio train --aot`` (``gj_solve`` launches = the plan of a full read),
    ``pio status`` saying ``present``; a ``--aot`` deploy beside a plain
    ``--pin-model`` one under the bench's serving load (32 x AOT_REQUESTS uniform
    top-10, legs A B B A), every answer byte-equal to the plain deploy's
    and float64 numpy's top-10 under the near-tie rule, tier 1, hits, no
    serve-time compile; in process, the programs against the eager pinned
    path to the bit, one ``handle_batch`` of 1,000 users, ``handle_query``
    p50 of both; the fallback drills; AOT_RELOADS reloads with memory flat. No
    kernel launches on the in-process serving path. ``after_export()``,
    when given, runs once the export is done, before the deploys."""
    from predictionio_tpu_torch.serving import CacheConfig
    from predictionio_tpu_torch.workflow.aot import AotConfig

    t_phase = time.perf_counter()
    # the plan of a full read now: the online and explore phases wrote
    # events to the store since the warm train
    _, plan = ctx["full_read"]()
    with saved_env("PIO_COMPILATION_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        trained = aot_train("als", ctx, {"gj_solve": plan}, device)
        if after_export is not None:
            after_export()
        instance = trained["instance"]
        model = stored_model(instance.id)
        user_index, item_index = model.user_index, model.item_index
        U64 = np.asarray(model.user_factors, np.float64)
        V64 = np.asarray(model.item_factors, np.float64)
        picks = load_picks(SRV_CLIENTS * AOT_REQUESTS, len(user_index), seed=41)
        served = aot_deploys_ab("als", ctx, user_index, picks, SRV_CLIENTS, TOP_K, trained["programs"])
        checked = check_answers("aot als", served.pop("answers"), U64, V64, item_index, TOP_K)
        del U64, V64

        variant = load_engine_variant(str(ctx["engine_json"]))
        reset_launch_counts()
        eager = QueryService(variant, local_context(device), instance_id=instance.id,
                             cache=CacheConfig(pin_model=True))
        tier1 = QueryService(variant, local_context(device), instance_id=instance.id,
                             aot=AotConfig(enabled=True, root=str(trained["root"])))
        try:
            algo, tmodel = tier1._algo_model_pairs[0]
            _, emodel = eager._algo_model_pairs[0]
            runtime = tmodel._pio_aot
            if runtime is None or tier1.stats_json()["aot"]["tier"] != 1:
                raise RuntimeError(f"aot als: the in-process service booted {tier1.stats_json()['aot']}")
            programs = aot_programs_vs_eager("als", emodel, runtime, algo.BATCH_PREDICT_CHUNK, len(user_index),
                                             TOP_K)
            rng = np.random.default_rng(45)
            bodies = [{"user": user_index.inverse(u), "num": TOP_K}
                      for u in rng.integers(0, len(user_index), AOT_BATCH_USERS).tolist()]
            if json.dumps(tier1.handle_batch(bodies)) != json.dumps(eager.handle_batch(bodies)):
                raise RuntimeError("aot als: handle_batch of the tier-1 service differs from the eager service's")
            handle = aot_handle_ab({"eager": eager, "aot": tier1}, bodies[:AOT_HANDLE_QUERIES])
            log(f"[aot] als: handle_batch of {AOT_BATCH_USERS} users byte-equal; handle_query p50 tier 1 "
                f"{handle['aot']['p50_ms']:.4f} ms ({handle['aot']['queries_per_s']:.1f} queries/s), eager "
                f"{handle['eager']['p50_ms']:.4f} ms ({handle['eager']['queries_per_s']:.1f} queries/s), legs A B B A; "
                f"on {smi}")
            drills = aot_fallback_drills("als", ctx, variant, instance.id, trained["root"], eager, user_index, device)
            del algo, tmodel, emodel, runtime  # the generation's last references here: a reload frees it
            reloads = aot_reload_memory("als", tier1, device)
            block = tier1.stats_json()["aot"]
            if block["serveTimeCompiles"] != 0:
                raise RuntimeError(f"aot als: the in-process service compiled at serve time: {block}")
        finally:
            tier1.close()
            eager.close()
            del tier1, eager
            release_card_memory(device)
        launches = read_launch_counts()
        if any(launches.values()):
            raise RuntimeError(f"aot als: the serving path launched kernels {launches}; it has none")
    out = {key: trained[key] for key in ("train_wall_s", "launches", "planned", "programs", "artifact_bytes",
                                         "export_s", "export_workers", "fingerprint", "status")}
    out.update({"deploy_start_s": served["deploy_start_s"], "aot": served["aot"], "plain": served["plain"],
                "block": served["block"], "checked": checked, "programs_vs_eager": programs, "handle": handle,
                "fallback": drills, "reloads": reloads, "serving_launches": launches,
                "phase_s": time.perf_counter() - t_phase, "card": smi})
    log(f"[aot] als: {json.dumps(out)}")
    return out


def phase_tt_aot(device, ctx: dict, smi: str) -> dict:
    """AOT serving of the Two-Tower quickstart's instance: ``pio train
    --aot`` (fused-CE launches = the plan), ``pio status`` ``present``; a
    ``--aot`` deploy under the Two-Tower serving load (8 x 50), tier 1
    with every program loaded, every answer byte-equal to the eager pinned
    service's in process and float64 numpy's top-10 without the seen
    items, ``hits`` > 0, no serve-time compile; in process, the programs
    against the eager pinned path to the bit. Its start is printed beside
    the quickstart's plain deploy's (the card pins without a flag)."""
    from predictionio_tpu_torch.serving import CacheConfig
    from predictionio_tpu_torch.templates.serving_util import TOPK_CHUNK
    from predictionio_tpu_torch.workflow.aot import AotConfig

    t_phase = time.perf_counter()
    with saved_env("PIO_COMPILATION_CACHE_DIR", "TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        trained = aot_train("two-tower", ctx, ctx["plan"], device)
        instance = trained["instance"]
        model = stored_model(instance.id)
        picks = load_picks(SRV_TT_CLIENTS * SRV_TT_REQUESTS, len(model.user_index), seed=49)
        t0 = time.perf_counter()
        proc, port = start_console_server(
            "aot two-tower", ctx["base"], ["deploy", "--engine-json", str(ctx["engine_json"]), *ctx["dev_args"],
                                           "--aot"], ctx["base"] / "deploy-tt-aot.stderr", QS_DEPLOY_TIMEOUT_S)
        start_s = time.perf_counter() - t0
        try:
            url = f"http://127.0.0.1:{port}"
            _, booted = _http_json(url + "/stats.json")
            if booted["aot"].get("tier") != 1 or booted["aot"].get("loaded") != trained["programs"]:
                raise RuntimeError(f"aot two-tower: the --aot deploy booted {booted['aot']}")
            load = run_load(url, picks, model.user_index, SRV_TT_CLIENTS, TOP_K)
            answers = ok_answers("aot two-tower", load)
            _, served = _http_json(url + "/stats.json")
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        block = served["aot"]
        if block["hits"] <= 0 or block["serveTimeCompiles"] != 0 or block["disabled"] != 0:
            raise RuntimeError(f"aot two-tower: after the load the --aot deploy reports {block}")
        checked = check_answers("aot two-tower", answers, model.user_vecs.astype(np.float64),
                                model.item_vecs.astype(np.float64), model.item_index, TOP_K, model.seen,
                                model.user_index)
        variant = load_engine_variant(str(ctx["engine_json"]))
        reset_launch_counts()
        eager = QueryService(variant, local_context(device), instance_id=instance.id,
                             cache=CacheConfig(pin_model=True))
        tier1 = QueryService(variant, local_context(device), instance_id=instance.id,
                             aot=AotConfig(enabled=True, root=str(trained["root"])))
        try:
            differ = [u for u, payload in answers if json.dumps(payload) != json.dumps(
                eager.handle_query({"user": model.user_index.inverse(u), "num": TOP_K})[1])]
            if differ:
                raise RuntimeError(f"aot two-tower: {len(differ)} of {len(answers)} --aot answers differ from the "
                                   f"eager pinned service's bytes, users {differ[:5]}")
            _, tmodel = tier1._algo_model_pairs[0]
            _, emodel = eager._algo_model_pairs[0]
            if tmodel._pio_aot is None:
                raise RuntimeError(f"aot two-tower: the in-process service booted {tier1.stats_json()['aot']}")
            programs = aot_programs_vs_eager("two-tower", emodel, tmodel._pio_aot, TOPK_CHUNK,
                                             len(model.user_index), TOP_K)
            del tmodel, emodel
        finally:
            tier1.close()
            eager.close()
            del tier1, eager
            release_card_memory(device)
        launches = read_launch_counts()
        if any(launches.values()):
            raise RuntimeError(f"aot two-tower: the serving path launched kernels {launches}; it has none")
    out = {key: trained[key] for key in ("train_wall_s", "launches", "planned", "programs", "artifact_bytes",
                                         "export_s", "export_workers", "fingerprint", "status")}
    out.update({"deploy_start_s": {"aot": start_s, "plain": ctx["deploy_start_s"]}, "block": block,
                "aot": {key: load[key] for key in ("queries", "wall_s", "queries_per_s", "p50_ms", "p99_ms")},
                "checked": checked, "programs_vs_eager": programs, "serving_launches": launches,
                "phase_s": time.perf_counter() - t_phase, "card": smi})
    log(f"[aot] two-tower: deploy start --aot {start_s:.3f} s (the quickstart's plain deploy "
        f"{ctx['deploy_start_s']:.3f} s); {SRV_TT_CLIENTS} clients x {SRV_TT_REQUESTS} uniform top-{TOP_K}: "
        f"{load['queries_per_s']:.1f} queries/s, p50 {load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms, every answer "
        f"byte-equal to the eager pinned service's; aot {json.dumps(block)}")
    log(f"[aot] two-tower: {json.dumps(out)}")
    return out


# ----------------------------------------------------------- 17. multihost
def rel_diff(a: np.ndarray, b: np.ndarray) -> float:
    """The largest difference over the largest value of ``b``."""
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


def tie_gaps(U_ref: np.ndarray, V_ref: np.ndarray, U: np.ndarray, V: np.ndarray, users) -> dict:
    """For each of ``users`` whose top-10 by ``(U, V)`` is not the float64
    top-10 of ``(U_ref, V_ref)``: the largest relative gap between the
    reference scores of two items the two place differently."""
    U64, V64 = np.asarray(U_ref, np.float64), np.asarray(V_ref, np.float64)
    Ug, Vg = np.asarray(U, np.float64), np.asarray(V, np.float64)
    gaps = {}
    for u in users:
        ref, scores = reference_top(U64, V64, int(u), TOP_K)
        got, _ = reference_top(Ug, Vg, int(u), TOP_K)
        diff = [abs(scores[g] - scores[r]) / max(abs(scores[r]), 1e-12) for g, r in zip(got, ref) if g != r]
        if diff:
            gaps[int(u)] = max(diff)
    return gaps


def top_disagreements(label: str, U_ref, V_ref, U, V, users) -> dict:
    """The top-10s of ``users`` by ``(U, V)`` held to ``(U_ref, V_ref)``'s
    under the near-tie rule at ``MH_TIE_RTOL``; raises beyond it. Returns
    how many differ and the largest gap."""
    gaps = tie_gaps(U_ref, V_ref, U, V, users)
    bad = sorted(u for u, g in gaps.items() if g > MH_TIE_RTOL)
    if bad:
        raise RuntimeError(f"{label}: top-10 of users {bad[:8]} differ from the single device's beyond near-ties "
                           f"(gaps {[gaps[u] for u in bad[:8]]}, limit {MH_TIE_RTOL})")
    return {"top10_users": len(users), "top10_differing": len(gaps), "tie_gap_max": max(gaps.values(), default=0.0)}


def held_to_single(label: str, U: np.ndarray, V: np.ndarray, single, td, device) -> dict:
    """A mesh or multi-process run's factors against the single-device
    run's: train RMSE within ``MH_RMSE_RTOL`` (relative), the top-10 of
    ``MH_TOP_USERS`` users under the near-tie rule, the largest relative
    factor difference reported."""
    if not (np.isfinite(U).all() and np.isfinite(V).all()) or U.shape != single.user_factors.shape \
            or V.shape != single.item_factors.shape:
        raise RuntimeError(f"{label}: factors {U.shape}, {V.shape} not finite or not the single run's shapes")
    r, c, v = (torch.as_tensor(a, device=device) for a in (td.rows, td.cols, td.vals))
    rmse = train_rmse(torch.as_tensor(U, device=device), torch.as_tensor(V, device=device), r, c, v)
    rmse_single = train_rmse(torch.as_tensor(single.user_factors, device=device),
                             torch.as_tensor(single.item_factors, device=device), r, c, v)
    del r, c, v
    users = np.random.default_rng(13).choice(U.shape[0], MH_TOP_USERS, replace=False)
    out = {
        "rmse": rmse, "rmse_single": rmse_single, "rmse_rel_diff": abs(rmse - rmse_single) / rmse_single,
        "factor_rel_diff": max(rel_diff(U, single.user_factors), rel_diff(V, single.item_factors)),
    }
    if out["rmse_rel_diff"] > MH_RMSE_RTOL:
        raise RuntimeError(f"{label}: train RMSE {rmse} against the single device's {rmse_single}")
    out.update(top_disagreements(label, single.user_factors, single.item_factors, U, V, users))
    return out


def phase_mh_mesh(device, trained: dict, smi: str) -> dict:
    """(a) The ALS path's ratings on an in-process ``MH_MESH`` mesh of the
    card repeated: the factors held to ``phase_train``'s, the solve
    launches to the mesh plan, each position's bytes to its part of the
    tables; a run checkpointed every ``MH_CKPT_EVERY`` sweeps for
    ``MH_CKPT_SWEEPS``, resumed to ``MH_RESUME_SWEEPS`` on
    ``MH_RESUME_MESH``, against the uninterrupted run at that sweep."""
    from predictionio_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    td, single = trained["td"], trained["model"]
    rows, cols, vals = td.rows, td.cols, td.vals
    num_users, num_items = len(td.user_index), len(td.item_index)
    cfg = ALSConfig(rank=RANK, iterations=SWEEPS, reg=0.01, seed=3)

    def mesh_of(shape):
        with sharding.local_devices([device] * (shape[0] * shape[1])):
            return mesh_context(shape).mesh

    def plan(sweeps: int, data: int) -> int:
        return sweeps * (planned_solves(rows, num_users, cfg, data=data)
                         + planned_solves(cols, num_items, cfg, data=data))

    held: dict = {}

    def on_sweep(step: int, user, item) -> None:
        if step == 0:
            held["bytes"] = (sharding.per_device_bytes(user), sharding.per_device_bytes(item), len(user.shards))
        if step + 1 == MH_RESUME_SWEEPS:
            held["resume_point"] = (np.asarray(user)[:num_users], np.asarray(item)[:num_items])

    mesh = mesh_of(MH_MESH)
    reset_launch_counts()
    t0 = time.perf_counter()
    factors = train_als(rows, cols, vals, num_users, num_items, cfg, mesh=mesh, on_sweep=on_sweep)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mesh_s = time.perf_counter() - t0
    launches = read_launch_counts()
    if device.type == "cuda":
        check_launches("multihost mesh", launches, {"gj_solve": plan(SWEEPS, MH_MESH[0])})
    held_single = held_to_single("multihost mesh", factors.user.numpy(), factors.item.numpy(), single, td, device)
    want = (sharding.sharded_table_bytes(num_users + 1, RANK, MH_MESH[1]),
            sharding.sharded_table_bytes(num_items + 1, RANK, MH_MESH[1]), MH_MESH[1])
    if held["bytes"] != want:
        raise RuntimeError(f"multihost mesh: a position holds {held['bytes']} (bytes, bytes, shards), want {want}")

    ckdir = tempfile.mkdtemp(prefix="pio-mh-ckpt-")
    try:
        ck = dict(rank=RANK, reg=0.01, seed=3, checkpoint_dir=ckdir, checkpoint_interval=MH_CKPT_EVERY)
        t0 = time.perf_counter()
        train_als(rows, cols, vals, num_users, num_items, ALSConfig(iterations=MH_CKPT_SWEEPS, **ck), mesh=mesh)
        ckpt_s = time.perf_counter() - t0
        steps = CheckpointManager(ckdir).all_steps()
        if steps != list(range(MH_CKPT_EVERY, MH_CKPT_SWEEPS + 1, MH_CKPT_EVERY)):
            raise RuntimeError(f"multihost checkpoint: steps {steps}")
        reset_launch_counts()
        t0 = time.perf_counter()
        resumed = train_als(rows, cols, vals, num_users, num_items, ALSConfig(iterations=MH_RESUME_SWEEPS, **ck),
                            mesh=mesh_of(MH_RESUME_MESH))
        resume_s = time.perf_counter() - t0
        if device.type == "cuda":
            check_launches("multihost resume", read_launch_counts(),
                           {"gj_solve": plan(MH_RESUME_SWEEPS - MH_CKPT_SWEEPS, MH_RESUME_MESH[0])})
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    U6, V6 = held["resume_point"]
    resume_rel = max(rel_diff(resumed.user.numpy(), U6), rel_diff(resumed.item.numpy(), V6))
    if not resume_rel <= MH_CKPT_RTOL:
        raise RuntimeError(f"multihost checkpoint: the resumed run is {resume_rel} from the uninterrupted one")
    out = {
        "mesh": list(MH_MESH), "sweeps": SWEEPS, "train_s": mesh_s, "single_train_s": trained["train_s"],
        "gj_solve_launches": launches["gj_solve"], "plan": plan(SWEEPS, MH_MESH[0]),
        "position_bytes": list(held["bytes"][:2]),
        "replicated_bytes": [sharding.table_bytes(num_users + 1, RANK), sharding.table_bytes(num_items + 1, RANK)],
        **held_single,
        "checkpoint_steps": steps, "checkpoint_run_s": ckpt_s, "resume_mesh": list(MH_RESUME_MESH),
        "resume_s": resume_s, "resume_rel_diff": resume_rel, "phase_s": time.perf_counter() - t_phase, "card": smi,
    }
    log(f"[multihost] mesh {json.dumps(out)}")
    return out


def tower_diff(got, ref) -> dict:
    """Both towers of ``got`` against ``ref``'s: the largest difference over
    the largest value, and the entries outside ``MH_TT_TOWER_RTOL`` /
    ``MH_TT_TOWER_ATOL``."""
    pairs = ((got.user_vecs, ref.user_vecs), (got.item_vecs, ref.item_vecs))
    outside = sum(int((np.abs(a - b) > MH_TT_TOWER_ATOL + MH_TT_TOWER_RTOL * np.abs(b)).sum()) for a, b in pairs)
    return {"rel": max(rel_diff(a, b) for a, b in pairs), "outside_band": outside,
            "entries": sum(int(b.size) for _, b in pairs)}


def phase_mh_tt(device, smi: str) -> dict:
    """(d) One Two-Tower epoch at the path's width on an in-process
    ``MH_TT_MESH`` mesh against the single-device unfused run from the
    same draw: no fused-CE launch on the mesh, every logged loss within
    ``MH_TT_LOSS_RTOL``."""
    from predictionio_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    td, _, _, num_items = tt_training_data(TT_NNZ)
    num_users = len(td.user_index)
    cfg = TwoTowerConfig(dim=TT_DIM, batch_size=TT_BATCH, epochs=MH_TT_EPOCHS, learning_rate=0.05,
                         temperature=1.0 / TT_INV_TEMP, seed=2, fused_ce="off")
    t0 = time.perf_counter()
    single = train_two_tower(td.rows, td.cols, num_users, num_items, cfg, device=device)
    single_s = time.perf_counter() - t0
    with sharding.local_devices([device] * (MH_TT_MESH[0] * MH_TT_MESH[1])):
        mesh = mesh_context(MH_TT_MESH).mesh
    reset_launch_counts()
    t0 = time.perf_counter()
    meshed = train_two_tower(td.rows, td.cols, num_users, num_items, dataclasses.replace(cfg, fused_ce="auto"),
                             mesh=mesh)
    mesh_s = time.perf_counter() - t0
    launches = read_launch_counts()
    if launches["fused_ce_fwd"] or launches["fused_ce_bwd"]:
        raise RuntimeError(f"multihost two-tower: the mesh launched the fused CE {launches}")
    steps = [s for s, _ in meshed.loss_history]
    if steps != [s for s, _ in single.loss_history]:
        raise RuntimeError("multihost two-tower: the logged steps differ")
    loss_rel = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(meshed.loss_history, single.loss_history))
    if not loss_rel <= MH_TT_LOSS_RTOL:
        raise RuntimeError(f"multihost two-tower: losses {meshed.loss_history} against {single.loss_history}")
    # the same two epochs with float32 logit products: what is left of
    # the towers' difference without bf16's rounding
    f32 = dataclasses.replace(cfg, gemm_dtype="float32")
    single32 = train_two_tower(td.rows, td.cols, num_users, num_items, f32, device=device)
    meshed32 = train_two_tower(td.rows, td.cols, num_users, num_items, f32, mesh=mesh)
    out = {
        "mesh": list(MH_TT_MESH), "pairs": int(td.rows.size), "epochs": MH_TT_EPOCHS, "steps": steps[-1] + 1,
        "loss_first": meshed.loss_history[0][1], "loss_last": meshed.loss_history[-1][1], "loss_rel_diff": loss_rel,
        "tower_rel_diff": tower_diff(meshed, single), "tower_rel_diff_f32": tower_diff(meshed32, single32),
        "fused_ce_launches": launches["fused_ce_fwd"] + launches["fused_ce_bwd"], "train_s": mesh_s,
        "single_train_s": single_s, "phase_s": time.perf_counter() - t_phase, "card": smi,
    }
    log(f"[multihost] two-tower {json.dumps(out)}")
    f32_diff = out["tower_rel_diff_f32"]
    if not (f32_diff["rel"] <= MH_TT_TOWER_RTOL and f32_diff["outside_band"] <= MH_TT_TOWER_SHARE * f32_diff["entries"]):
        raise RuntimeError(f"multihost two-tower: float32 towers {f32_diff} from one device's")
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def triplet_env(port: int, processes: int, rank: int, **extra: str) -> dict:
    return {"PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "PIO_NUM_PROCESSES": str(processes),
            "PIO_PROCESS_ID": str(rank), **extra}


def phase_mh_rank(device, smi: str, nnz: int, sweeps: int, rank: int) -> dict:
    """(b) One rank of the two sharing the card: the process group from the
    triplet (the rule takes gloo), its round-robin share of the ALS path's
    ratings, ``sweeps`` at ``rank`` on the job's ``data`` axis (one
    position a rank); the launches against the multi-process plan, the
    exchange's bytes against the ratings the rank owns; rank 0 writes its
    factors to ``$PIO_MH_FACTORS``."""
    from predictionio_tpu_torch.parallel import distributed, exchange

    t_phase = time.perf_counter()
    if not distributed.initialize_from_env(device=device):
        raise RuntimeError("multihost rank: PIO_COORDINATOR_* is not set")
    P, me = distributed.process_count(), distributed.process_index()
    rows, cols, vals, num_users, num_items = ml20m_shaped(nnz, seed=5)
    owned = 20 * int(np.count_nonzero(rows % P == me) + np.count_nonzero(cols % P == me))
    ctx = mesh_context(device=device)
    cfg = ALSConfig(rank=rank, iterations=sweeps, reg=0.01, seed=3)
    plan = sweeps * (planned_solves(rows, num_users, cfg, data=1, processes=P)
                     + planned_solves(cols, num_items, cfg, data=1, processes=P))
    exchange.reset_exchange_traffic()
    reset_launch_counts()
    t0 = time.perf_counter()
    factors = train_als(rows[me::P], cols[me::P], vals[me::P], num_users, num_items, cfg, mesh=ctx.mesh)
    train_s = time.perf_counter() - t0
    launches = read_launch_counts()["gj_solve"]
    traffic = exchange.exchange_traffic()
    out = {
        "process": me, "processes": P, "backend": distributed.backend(), "device": str(distributed.local_device()),
        "mesh_conf": ctx.mesh_conf(), "ratings": int(rows[me::P].size), "train_s": train_s,
        "gj_solve_launches": launches, "plan": plan, "traffic": traffic, "owned_bytes": owned,
        "received_over_owned": traffic["p2p_received"] / owned, "phase_s": time.perf_counter() - t_phase,
    }
    if me == 0:
        np.savez(os.environ["PIO_MH_FACTORS"], user=factors.user.numpy(), item=factors.item.numpy())
    distributed.shutdown()
    log(f"[multihost] rank {json.dumps(out)}")
    if device.type == "cuda" and (launches != plan or launches == 0):
        raise RuntimeError(f"multihost rank {me}: gj_solve launched {launches} times, the plan says {plan}")
    if not 0 < traffic["p2p_received"] <= MH_TRAFFIC_SLACK * owned or traffic["allgather_received"]:
        raise RuntimeError(f"multihost rank {me}: received {traffic} for {owned} bytes of owned ratings")
    return out


def phase_mh_nccl(device, smi: str) -> dict:
    """(b) A one-rank group on the card: the rule takes NCCL (every rank
    drives a card of its own), and one all-gather runs through it."""
    from predictionio_tpu_torch.parallel import distributed

    if not distributed.initialize_from_env(device=device):
        raise RuntimeError("multihost nccl: PIO_COORDINATOR_* is not set")
    backend = distributed.backend()
    got = distributed.all_gather_tensor(torch.arange(4.0, device=device) + 1)
    distributed.shutdown()
    out = {"backend": backend, "gathered": [t.tolist() for t in got]}
    if backend != "nccl" or out["gathered"] != [[1.0, 2.0, 3.0, 4.0]]:
        raise RuntimeError(f"multihost nccl: {out}")
    log(f"[multihost] nccl {json.dumps(out)}")
    return out


def phase_mh_cli_rank(device, smi: str) -> dict:
    """(c) One ``pio train --mesh data=1`` process of the two: the console
    in this process (so its launches are counted here)."""
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    reset_launch_counts()
    console_ok("multihost cli", ["train", "--engine-json", os.environ["PIO_MH_ENGINE_JSON"], "--mesh", "data=1",
                                 *dev_args])
    return {"gj_solve_launches": read_launch_counts()["gj_solve"]}


def phase_mh_cli(device, smi: str) -> dict:
    """(c) The quickstart's ML-100K events in a sqlite store: ``pio export
    --sharded 2`` (the shard files complete), a single-process ``pio
    train``, then two ``pio train --mesh data=1`` processes through the
    triplet. Process 0's blob held to the single-process one (the same
    BiMaps, every user's top-10 under the near-tie rule), both trains'
    launches to their plans, the lineage recording the processes and the
    backend."""
    from predictionio_tpu_torch.parallel.reader import read_event_shards, shard_paths
    from predictionio_tpu_torch.templates.recommendation.engine import DataSourceParams, RecommendationDataSource

    t_phase = time.perf_counter()
    dev_args = [] if device.type == "cuda" else ["--device", device.type]
    with temporary_store("pio-mh-cli-") as base:
        console_ok("multihost cli", ["app", "new", MH_ENGINE_APP])
        users, items, ratings, stamps = synthesize_ml100k(42)
        events = base / "events.json"
        write_ndjson(events, (
            {"event": "rate", "entityType": "user", "entityId": str(u), "targetEntityType": "item",
             "targetEntityId": str(i), "properties": {"rating": float(r)},
             "eventTime": format_event_time(dt.datetime.fromtimestamp(t, dt.timezone.utc))}
            for u, i, r, t in zip(users.tolist(), items.tolist(), ratings.tolist(), stamps.tolist())
        ))
        console_ok("multihost cli", ["import", "--appname", MH_ENGINE_APP, "--input", str(events)])
        t0 = time.perf_counter()
        console_ok("multihost cli", ["export", "--appname", MH_ENGINE_APP, "--output", str(base / "shards"),
                                     "--sharded", str(MH_RANKS)])
        export_s = time.perf_counter() - t0
        shard_counts = [sum(1 for _ in read_event_shards(str(base / "shards"), h, MH_RANKS)) for h in range(MH_RANKS)]
        if len(shard_paths(str(base / "shards"))) != MH_RANKS or sum(shard_counts) != users.size:
            raise RuntimeError(f"multihost cli: shard files hold {shard_counts} events of {users.size}")
        engine_json = base / "engine.json"
        engine_json.write_text(json.dumps({
            "id": MH_ENGINE_APP, "version": "1", "engineFactory": QS_FACTORY,
            "datasource": {"params": {"appName": MH_ENGINE_APP}},
            "algorithms": [{"name": "als", "params": {
                "rank": QS_RANK, "numIterations": QS_SWEEPS, "lambda": 0.01, "seed": 3}}],
        }))
        td = RecommendationDataSource(DataSourceParams(app_name=MH_ENGINE_APP)).read_training(local_context(device))
        if td.user_index.keys() != sorted(td.user_index.keys()) or td.item_index.keys() != sorted(td.item_index.keys()):
            raise RuntimeError("multihost cli: the single-process BiMaps are not the sorted vocabularies")
        cfg = ALSConfig(rank=QS_RANK)
        U, I = len(td.user_index), len(td.item_index)
        plan_single = QS_SWEEPS * (planned_solves(td.rows, U, cfg) + planned_solves(td.cols, I, cfg))
        plan_rank = QS_SWEEPS * (planned_solves(td.rows, U, cfg, data=1, processes=MH_RANKS)
                                 + planned_solves(td.cols, I, cfg, data=1, processes=MH_RANKS))

        reset_launch_counts()
        single_s = console_ok("multihost cli", ["train", "--engine-json", str(engine_json), *dev_args])
        if device.type == "cuda":
            check_launches("multihost cli single", read_launch_counts(), {"gj_solve": plan_single})
        (first,) = Storage.get_meta_data_engine_instances().get_all()

        port = free_port()
        t0 = time.perf_counter()
        ranks = [start_child("phase_mh_cli_rank", device, smi,
                             env=triplet_env(port, MH_RANKS, r, PIO_MH_ENGINE_JSON=str(engine_json)))
                 for r in range(MH_RANKS)]
        results = [join_child(*child, MH_CHILD_TIMEOUT_S) for child in ranks]
        ranks_s = time.perf_counter() - t0
        if device.type == "cuda":
            for r, res in enumerate(results):
                check_launches(f"multihost cli rank {r}", {"gj_solve": res["gj_solve_launches"]},
                               {"gj_solve": plan_rank})
        instances = [i for i in Storage.get_meta_data_engine_instances().get_all() if i.id != first.id]
        if len(instances) != 1 or instances[0].status != "COMPLETED":
            raise RuntimeError(f"multihost cli: process 0 wrote {[(i.id, i.status) for i in instances]}")
        (second,) = instances
        conf = second.mesh_conf
        if conf.get("processes") != str(MH_RANKS) or conf.get("backend") != "gloo":
            raise RuntimeError(f"multihost cli: mesh_conf {conf}")
        one, two = stored_model(first.id), stored_model(second.id)
        if one.user_index.keys() != two.user_index.keys() or one.item_index.keys() != two.item_index.keys():
            raise RuntimeError("multihost cli: the two blobs' BiMaps differ")
        tops = top_disagreements("multihost cli", one.user_factors, one.item_factors, two.user_factors,
                                 two.item_factors, range(U))
        out = {
            "events": int(users.size), "shards": shard_counts, "export_s": export_s, "single_train_s": single_s,
            "ranks_wall_s": ranks_s, "rank_launches": [r["gj_solve_launches"] for r in results],
            "plan_rank": plan_rank, "plan_single": plan_single, "mesh_conf": conf, **tops,
            "factor_rel_diff": max(rel_diff(two.user_factors, one.user_factors),
                                   rel_diff(two.item_factors, one.item_factors)),
            "phase_s": time.perf_counter() - t_phase, "card": smi,
        }
        log(f"[multihost] cli {json.dumps(out)}")
        return out


def phase_mh_group(device, smi: str, nnz: int, sweeps: int, rank: int) -> dict:
    """(a) and the Two-Tower mesh (:func:`phase_mh_mesh`, :func:`phase_mh_tt`)
    in a child process beside the workflow's phases: the ALS phase's ratings made again from their
    seed at the parent's ``NNZ``, ``SWEEPS`` and ``RANK`` (given, as a
    child starts from this module's defaults), its single-device factors
    and seconds read from ``$PIO_MH_SINGLE`` (the parent writes them)."""
    from types import SimpleNamespace

    global NNZ, SWEEPS, RANK
    NNZ, SWEEPS, RANK = nnz, sweeps, rank
    rows, cols, vals, num_users, num_items = ml20m_shaped(NNZ, seed=5)
    with np.load(os.environ["PIO_MH_SINGLE"]) as z:
        trained = {"td": ratings_training_data(rows, cols, vals, num_users, num_items),
                   "model": SimpleNamespace(user_factors=z["user"], item_factors=z["item"]),
                   "train_s": float(z["train_s"])}
    return {"mesh": phase_mh_mesh(device, trained, smi), "tt": phase_mh_tt(device, smi)}


def start_multihost(device, trained: dict, smi: str, workdir: Path, environ: dict | None = None) -> list:
    """Start (b)'s two ranks and its one-rank NCCL group (on a card), (c),
    and (a) with the Two-Tower mesh (:func:`phase_mh_group`) as child
    processes at ``CHILD_NICE`` (joined with the other children before
    the fleets), in ``environ`` (:func:`start_child`); returns them for
    :func:`join_multihost`."""
    port = free_port()
    factors = workdir / "rank0.npz"
    single = workdir / "single.npz"
    np.savez(single, user=trained["model"].user_factors, item=trained["model"].item_factors,
             train_s=trained["train_s"])
    children = [start_child("phase_mh_rank", device, smi, NNZ, SWEEPS, RANK,
                            env=triplet_env(port, MH_RANKS, r, PIO_MH_FACTORS=str(factors)), nice=CHILD_NICE,
                            environ=environ)
                for r in range(MH_RANKS)]
    children.append(start_child("phase_mh_cli", device, smi, nice=CHILD_NICE, environ=environ))
    if device.type == "cuda":
        children.append(start_child("phase_mh_nccl", device, smi, env=triplet_env(free_port(), 1, 0),
                                    nice=CHILD_NICE, environ=environ))
    children.append(start_child("phase_mh_group", device, smi, NNZ, SWEEPS, RANK, env={"PIO_MH_SINGLE": str(single)},
                                nice=CHILD_NICE, environ=environ))
    return children


def join_multihost(children: list, trained: dict, device, workdir: Path) -> dict:
    """Join :func:`start_multihost`'s children and hold rank 0's factors to
    the single-device run's."""
    from predictionio_tpu_torch.parallel import distributed

    results = [join_child(*child, MH_CHILD_TIMEOUT_S) for child in children]
    ranks, cli, group = results[:MH_RANKS], results[MH_RANKS], results[-1]
    nccl = results[MH_RANKS + 1] if len(results) > MH_RANKS + 2 else {"backend": "not run on the CPU"}
    if any(r["backend"] != "gloo" for r in ranks):
        raise RuntimeError(f"multihost: two ranks on one card ran {[r['backend'] for r in ranks]}, not gloo")
    with np.load(workdir / "rank0.npz") as z:
        held = held_to_single("multihost ranks", z["user"], z["item"], trained["model"], trained["td"], device)
    # the rule refuses NCCL for two ranks on one card
    published = [{"host": "h", "type": "cuda", "index": None, "count": 1}] * MH_RANKS
    try:
        distributed.choose_backend(published, require_nccl=True)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise RuntimeError("multihost: an NCCL request on a shared card was not refused")
    out = {"ranks": ranks, "rank0": held, "nccl": nccl, "nccl_on_shared_card": refused, "cli": cli,
           "mesh": group["mesh"], "tt": group["tt"]}
    log(f"[multihost] ranks {json.dumps({'rank0': held, 'backend': [r['backend'] for r in ranks], 'traffic': [r['traffic'] for r in ranks], 'received_over_owned': [r['received_over_owned'] for r in ranks], 'nccl_on_shared_card': refused})}")
    return out


def check_launches(path: str, launches: dict, expected: dict) -> None:
    log(f"[{path}] launches on the path: {json.dumps({k: launches[k] for k in expected})}, "
        f"plan {json.dumps(expected)}")
    for name, want in expected.items():
        if launches[name] != want or launches[name] == 0:
            raise RuntimeError(f"{path}: {name} launched {launches[name]} times, the plan says {want}")


def kernel_row(name: str, launches: int, m: dict) -> dict:
    spec = KERNELS[name]
    return {
        "name": name, "route": spec["route"], "source": spec["source"], "replaces": spec["replaces"],
        "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
    }


def main() -> int:
    t_start = time.perf_counter()
    last = [t_start]

    def mark(label: str) -> None:
        """A ``[timing]`` line: the seconds since the previous one, and into the run."""
        now = time.perf_counter()
        log(f"[timing] {label} {now - last[0]:.1f} s; {now - t_start:.1f} s into the run")
        last[0] = now

    info = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    mark("device and build")
    solve_rows = phase_kernel(device)
    phase_solve_widths(device)
    fused_rows = phase_fused_kernel(device, info["exp_per_s"])
    mark("kernels")
    # [chaos]: the AOT serving drill in a child from here, once the kernels
    # are built and timed: its chaos-serve --aot has 360 s for its pio train
    # --aot, whose export spawns a compile process a core but one, and it
    # exports beside the main path alone until the other children start
    # (below). The other four drills start with those children
    chaos_children = [start_child("phase_chaos", device, info["smi"], 3, nice=CHAOS_NICE)]

    # the Recommendation path
    with temporary_store("pio-als-"):
        reset_launch_counts()
        trained = phase_train(device, NNZ, SWEEPS, RANK)
        served = phase_als_serve(trained, device, QUERIES, TOP_K, info["kind"])
        als_launches = read_launch_counts()
    check_launches("train", als_launches, {"gj_solve": trained["expected_launches"]})
    profile = phase_profile(*phase_half_sweep(trained, device, RANK, info["smi"]), device)
    phase_knobs(device, info["smi"])
    mark("als")
    als_wide, wide_launches = phase_als_wide(device, trained, info)
    mark("als-wide")
    mh_dir = Path(tempfile.mkdtemp(prefix="pio-mh-"))

    # the Two-Tower path
    with temporary_store("pio-tt-"):
        reset_launch_counts()
        tt_trained = phase_tt_train(device, TT_NNZ, TT_DIM, TT_BATCH, TT_EPOCHS)
        tt_launches = read_launch_counts()
        check_launches("tt-train", tt_launches, tt_trained["expected_launches"])
        tt_served = phase_tt_serve(tt_trained, device, QUERIES, TOP_K, info["kind"])
    tt_profile = phase_tt_profile(tt_trained, device)
    mark("two-tower")

    # the quickstart paths with the grid, the A/B fleet and the bandit
    # loop, the Two-Tower quickstart with its serving tiers and AOT serving,
    # the four other templates, [storage], [tooling], the training mesh and
    # the multi-process tier ((a) the mesh with the Two-Tower mesh, (b) the
    # two ranks and the NCCL group, (c) the CLI's processes) and the other
    # four drills run in child processes beside the workflow's phases (their
    # own stores and launch counts), started once its cold train is in: till
    # then [chaos]'s AOT drill exports beside the main path alone. Started
    # inside the workflow's store, they get the environment from before it.
    # Joined before the fleets count the console processes on the host
    started: dict = {}
    outside = dict(os.environ)

    def start_children() -> None:
        started["groups"] = [
            start_child("phase_quickstart_group", device, info["smi"], nice=CHILD_NICE, environ=outside),
            start_child("phase_tt_group", device, info["smi"], nice=CHILD_NICE, environ=outside),
            start_child("phase_templates", device, info["smi"], TPL_NNZ, TPL_CLS_USERS, TPL_TEXT_DOCS, QUERIES,
                        nice=CHILD_NICE, environ=outside)]
        started["storage"] = start_child("phase_storage", device, info["smi"], nice=CHILD_NICE, environ=outside)
        started["tooling"] = start_child("phase_tooling", device, info["smi"], nice=CHILD_NICE, environ=outside)
        chaos_children.append(start_child("phase_chaos", device, info["smi"], 0, 1, 4, 2, nice=CHAOS_NICE,
                                          environ=outside))
        started["multihost"] = start_multihost(device, trained, info["smi"], mh_dir, environ=outside)

    joined: list = []

    # the serving tier, online learning, retrieval, the fleet and the
    # exploring deploys run on the workflow's store and warm instance
    # (their own launch counts inside)
    def on_workflow(ctx: dict) -> tuple:
        mark("workflow")
        srv = phase_serving(device, ctx, SRV_CLIENTS, SRV_REQUESTS, TOP_K, SRV_BATCHPREDICT, info["smi"])
        mark("serving")
        onl = phase_online(device, ctx, info["smi"])
        mark("online")
        ann = phase_ann(device, ctx, info["smi"])
        mark("ann")
        shd = phase_sharded_service(device, ctx, info["smi"])
        mark("sharded")
        joined.extend(join_child(*child, CHILD_TIMEOUT_S) for child in started["groups"])
        joined.append(join_child(*started["storage"], STG_CHILD_TIMEOUT_S))
        joined.append(join_child(*started["tooling"], TOOL_CHILD_TIMEOUT_S))
        joined.append(join_multihost(started["multihost"], trained, device, mh_dir))
        shutil.rmtree(mh_dir, ignore_errors=True)
        mark("waiting for the quickstart's, the Two-Tower's, the templates', the storage, the tooling and the "
             "multihost child processes")
        chaos_joined = [join_child(*child, CHAOS_CHILD_TIMEOUT_S) for child in chaos_children]
        joined.append({"drills": {k: v for c in chaos_joined for k, v in c["drills"].items()},
                       "train": next(c["train"] for c in chaos_joined if "train" in c),
                       "phase_s": [c["phase_s"] for c in chaos_joined]})
        mark("waiting for the chaos child processes")
        flt = phase_fleet(device, ctx, srv["per_request"], info["smi"])
        mark("fleet")
        exp = phase_explore_deploy(device, ctx, info["smi"])
        mark("explore deploys")
        # last: pio train --aot makes the newest instance of the store; the
        # bench's sweeps run in a child process beside its export, which
        # leaves the card idle, and are joined before its deploys
        sweeps_child = start_child("phase_sweeps", device, info["smi"])
        aot = phase_aot(device, ctx, info["smi"],
                        after_export=lambda: joined.append(join_child(*sweeps_child, CHILD_TIMEOUT_S)))
        mark("aot, the sweeps beside its export")
        return srv, onl, ann, shd, flt, exp, aot

    wf = phase_workflow(device, WF_NNZ, WF_BULK, QUERIES, TOP_K, info["smi"], then=on_workflow,
                        after_cold=start_children)
    srv, onl, ann, shd, flt, exp, aot = wf["serving"]
    online_launches = onl["in_process"]["launches"]
    if any(online_launches.values()):
        raise RuntimeError(f"online: the fold launched kernels {online_launches}; its path has none")
    log(f"[ann] launches on the deploys' and in-process path: {json.dumps(ann['launches'])}; [sharded] on the "
        f"services' path: {json.dumps(shd['launches'])}")
    quickstart, ttq, tpl, stg, tooling, mh_procs, chaos_out, sweeps = joined
    mh_mesh, mh_tt = mh_procs["mesh"], mh_procs["tt"]
    qs, loop = quickstart["qs"], quickstart["loop"]
    grid, fleet_ab = qs["then"]
    tt_srv, tt_onl, tt_ann, tt_shd, tt_aot = ttq["serving"]
    ann_sweep, shd_sweep, score_cost = sweeps["ann_sweep"], sweeps["shd_sweep"], sweeps["score_cost"]

    main_fused = fused_rows[0]  # [8192, 64], the Two-Tower path's shape
    wide_row = next(r for r in solve_rows if r["shape"] == [32768, WIDE_RANK, WIDE_RANK])
    kernels = [
        kernel_row("gj_solve", als_launches["gj_solve"], solve_rows[0]),
        kernel_row("gj_solve_wide", wide_launches["gj_solve"], wide_row),
        kernel_row("fused_ce_fwd", tt_launches["fused_ce_fwd"], main_fused["fwd"]),
        kernel_row("fused_ce_bwd", tt_launches["fused_ce_bwd"], main_fused["bwd"]),
    ]
    summary = {
        "card": info["smi"], "nnz": NNZ, "rank": RANK, "sweeps": len(trained["sweeps"]),
        "rmse_first": trained["sweeps"][0]["rmse"], "rmse_last": trained["sweeps"][-1]["rmse"],
        "train_s": trained["train_s"], "run_train_s": trained["run_train_s"],
        "bucketing_s": trained["bucketing_s"], "sweep1_s": trained["sweeps"][0]["seconds"],
        "ratings_per_s": trained["ratings_per_s"],
        "peak_gib": trained["peak_bytes"] / 2**30,
        "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"],
        "predict_p50_ms": served["predict_p50_ms"], "predict_p99_ms": served["predict_p99_ms"],
        "sweep_busy_share": profile["busy_share"],
        "als_wide": als_wide,
        "tt": {
            "pairs": tt_trained["pairs"], "dim": TT_DIM, "batch": TT_BATCH, "epochs": TT_EPOCHS,
            "steps": tt_trained["steps"], "train_s": tt_trained["train_s"],
            "train_span_s": tt_trained["train_span_s"], "interactions_per_s": tt_trained["interactions_per_s"], "steps_per_s": tt_trained["steps_per_s"],
            "loss_first": tt_trained["loss_first"], "loss_last": tt_trained["loss_last"],
            "recall_at_10": tt_trained["recall_at_10"], "heldout_repeat_share": tt_trained["heldout_repeat_share"],
            "recall_at_10_new_pairs": tt_trained["recall_at_10_new_pairs"], "peak_gib": tt_trained["peak_gib"],
            "p50_ms": tt_served["p50_ms"], "p99_ms": tt_served["p99_ms"],
            "predict_p50_ms": tt_served["predict_p50_ms"], "predict_p99_ms": tt_served["predict_p99_ms"],
            "step_busy_share": tt_profile["busy_share"],
        },
        "qs": {key: qs[key] for key in (
            "events", "import_s", "read_s", "train_als_s", "train_wall_s", "deploy_start_s",
            "gj_solve_launches", "train_rmse", "mean_rmse", "p50_ms", "p99_ms", "eval_s",
            "eval_gj_solve_launches", f"precision_at_{TOP_K}", "phase_s")},
        "tt_qs": {key: ttq[key] for key in (
            "pairs", "import_s", "read_s", "train_tt_s", "train_wall_s", "deploy_start_s", "launches",
            "loss_first", "loss_last", "recall_at_10", "recall_at_10_new_pairs", "p50_ms", "p99_ms", "eval_s",
            "eval_launches", f"eval_recall_at_{TOP_K}", f"reference_eval_recall_at_{TOP_K}",
            f"random_eval_recall_at_{TOP_K}", "phase_s")},
        "wf": {key: wf[key] for key in (
            "events", "pairs_warm", "write_events_per_s", "bulk_events_per_s", "duplicates_absorbed",
            "cold_read_s", "cold_train_als_s", "cold_wall_s", "cold_launches", "warm_read_s", "warm_train_als_s",
            "warm_wall_s", "warm_launches", "train_rmse", "deploy_start_s", "p50_ms", "p99_ms", "phase_s")},
        "srv": {
            **{key: srv[key] for key in (
                "per_request", "batched_uniform", "batched_zipf", "bit_equal_share", "same_order_share",
                "bucket_misses",
                "cache_hit_ratio_zipf", "bytes_pinned", "warm_start_launches", "rmse_before", "rmse_after",
                "undeploy_s", "phase_s")},
            "batchpredict_queries_per_s": srv["batchpredict"]["queries_per_s"],
            "reload_non_200": srv["reload_under_load"]["non_200"], "degraded_status": srv["degraded"]["status"],
            "predict_events": srv["feedback"]["predict_events"],
            "memory_allocated_first_last": [srv["reloads"]["memory_allocated_first"],
                                            srv["reloads"]["memory_allocated_last"]],
            "tt": {key: tt_srv[key] for key in ("queries_per_s", "p50_ms", "p99_ms")},
        },
        "online": {
            **{label: {key: onl[label][key] for key in ("queries_per_s", "p50_ms", "p99_ms", "deploy_start_s",
                                                         "ingest_events_per_s")}
               for label in ("baseline", "online")},
            "p99_ratio": onl["p99_ratio"], "freshness": onl["online"]["freshness"],
            "fold_ms": onl["online"]["fold_ms"], "event_to_visible_s": onl["online"]["event_to_visible_s"],
            "events_seen": onl["online"]["events_seen"], "worst_rel_err": onl["in_process"]["worst_rel_err"],
            "launches": online_launches, "phase_s": onl["phase_s"],
            "tt": {key: tt_onl[key] for key in ("events", "steps", "last_loss", "worst_norm_err", "phase_s")},
        },
        "ann": {
            "ivf": [{key: p[key] for key in ("catalog_items", "nlist", "slab_width", "build_s", "speedup",
                                               "recall_at_10", "recall_at_100", "fraction_of_catalog_scored")}
                    | {"exact_qps": p["exact"]["queries_per_s"], "ivf_qps": p["ivf"]["queries_per_s"]}
                    for p in ann_sweep["ivf"]],
            "int8": [{key: p[key] for key in ("catalog_items", "recall_at_10_exact_int8", "bytes_ratio")}
                     | {"exact_f32_qps": p["exact_f32"]["queries_per_s"],
                        "exact_int8_qps": p["exact_int8"]["queries_per_s"],
                        "ivf_f32_qps": p["ivf_f32"]["queries_per_s"], "ivf_int8_qps": p["ivf_int8"]["queries_per_s"],
                        "ivf_f32_recall": p["ivf_f32"]["recall_at_10"], "ivf_int8_recall": p["ivf_int8"]["recall_at_10"]}
                     for p in ann_sweep["int8"]],
            "deploys": {label: {key: run[key] for key in ("queries_per_s", "p50_ms", "p99_ms", "recall_at_10",
                                                           "deploy_start_s")}
                        for label, run in ann["deploys"].items()},
            "bytes_pinned_int8": ann["deploys"]["int8"]["cache"]["bytesPinned"],
            "full_probe_bit_equal": ann["full_probe_bit_equal"], "reload_memory": ann["reload_memory"],
            "incremental": ann["incremental"], "fold": ann["fold"],
            "tt": {key: tt_ann[key] for key in ("queries_per_s", "p50_ms", "p99_ms", "recall_at_10")},
            "launches": ann["launches"], "phase_s": ann["phase_s"] + ann_sweep["phase_s"],
        },
        "templates": {
            **{name: {key: tpl[name][key] for key in (
                "events", "read_s", "train_s", "wall_s", "launches", "plan", "loss_ratio", "solve_batch_max",
                "deploy_start_s", "clients_1", "clients_8", "handle_query_p50_ms")}
               for name in ("similarproduct", "ecommerce")},
            "similarproduct_ann": tpl["similarproduct"]["ann"], "ecommerce_split": tpl["ecommerce"]["split"],
            "solve_row": {key: tpl["solve_row"][key] for key in ("shape", "ms", "bound_ms", "library_ms")},
            "classification": {key: tpl["classification"][key] for key in (
                "accuracy_nb", "accuracy_lr", "majority_rate", "nb", "lr")},
            "textclassification": {key: tpl["textclassification"][key] for key in ("chance", "nb", "lr")},
            "phase_s": tpl["phase_s"],
        },
        "sharded": {
            "sweep": [{key: p[key] for key in ("mesh", "catalog_items", "shards", "per_position_bytes",
                                                "sharded_table_bytes", "replicated_bytes", "int8_per_position_bytes",
                                                "plain_gemm_bits_differ", "plain_gemm_max_ulps",
                                                "exact_scores_bits_differ")}
                      | {"exact_qps": p["exact"]["sharded"]["queries_per_s"],
                         "replicated_qps": p["exact"]["replicated"]["queries_per_s"],
                         "int8_qps": p["int8"]["sharded"]["queries_per_s"],
                         "int8_replicated_qps": p["int8"]["replicated"]["queries_per_s"],
                         "ivf_qps": p["ivf"]["sharded"]["queries_per_s"],
                         "ivf_unsharded_qps": p["ivf"]["unsharded"]["queries_per_s"],
                         "full_probe_qps": p["ivf"]["full_probe_sharded"]["queries_per_s"]}
                      for p in shd_sweep["sweep"]],
            "oom_shape": shd_sweep["oom_shape"],
            "service": {label: {key: shd[label][key] for key in ("queries_per_s", "p50_ms", "p99_ms")}
                        for label in ("exact", "int8", "ann", "online")},
            "recall_at_10": {label: shd[label]["recall_at_10"] for label in ("int8", "ann")},
            "reload_memory": shd["exact"]["reload_memory"], "bytes_pinned": shd["exact"]["bytes_pinned"],
            "online": {key: shd["online"][key] for key in ("padded_rows", "logical_rows", "burst", "relayout_rows")},
            "tt": {key: tt_shd[key] for key in ("queries_per_s", "p50_ms", "p99_ms", "checked")},
            "cli": shd["cli"], "launches": shd["launches"],
            "load_peak_bytes": shd["exact"]["load_peak_bytes"],
            "score_rows_cost": [{key: p[key] for key in ("catalog_items", "batches", "per_request_ms_p50")}
                                for p in score_cost["points"]],
            "score_rows_ab": {name: run["queries_per_s"] for name, run in shd["score_rows_ab"].items()},
            "phase_s": shd["phase_s"] + shd_sweep["phase_s"] + score_cost["phase_s"],
        },
        "fleet": {
            "single_process": flt["single_process"],
            "scaling": {n: {key: run[key] for key in ("queries_per_s", "p50_ms", "p99_ms", "ready_s",
                                                      "mib_per_replica")}
                        for n, run in flt["scaling"].items()},
            "sigkill": {key: flt["sigkill"][key] for key in ("queries", "failed", "rejoin_s", "p99_ms_before",
                                                             "p99_ms_after")},
            "rolling": {key: flt["rolling"][key] for key in ("queries", "failed", "cross_generation", "reload_s")},
            "ab": {key: fleet_ab[key] for key in ("control_share", "winner", "promotion_queries", "promotion_failed")},
            "launches": flt["launches"], "phase_s": flt["phase_s"] + fleet_ab["phase_s"],
        },
        "experiments": {
            "regret": {"thompson": loop["thompson"]["cumulative_regret"],
                       "exploit": loop["exploit"]["cumulative_regret"]},
            "explore_qps": {label: exp[label]["queries_per_s"] for label in ("plain", "thompson")},
            "explore_ratio": exp["ratio"], "rewards_followed": exp["online"]["rewards"]["events"],
            **{key: grid[key] for key in ("grid_eval_s", "grid_s_per_candidate", "grid_peak_gib", "f64_worst_abs",
                                          "sequential_s_per_candidate", "sequential_launches", "bench_ratio",
                                          "full_ratio")},
            "phase_s": exp["phase_s"] + grid["phase_s"],
        },
        "aot": {
            **{label: {key: run[key] for key in ("programs", "artifact_bytes", "export_s", "export_workers",
                                                 "deploy_start_s", "launches")}
                      | {"aot_qps": run["aot"]["queries_per_s"], "aot_p50_ms": run["aot"]["p50_ms"],
                         "hits": run["block"]["hits"], "serve_time_compiles": run["block"]["serveTimeCompiles"]}
               for label, run in (("als", aot), ("two_tower", tt_aot))},
            "plain_qps": aot["plain"]["queries_per_s"], "plain_p50_ms": aot["plain"]["p50_ms"],
            "handle_query_p50_ms": {name: aot["handle"][name]["p50_ms"] for name in ("aot", "eager")},
            "fallback_tiers": {kind: aot["fallback"][kind]["tier"] for kind in ("foreign", "corrupt")},
            "reload_memory": [aot["reloads"]["memory_allocated_first"], aot["reloads"]["memory_allocated_last"]],
            "phase_s": aot["phase_s"] + tt_aot["phase_s"],
        },
        "storage": {
            "replicated": {key: stg["replicated"][key] for key in (
                "events", "write_s", "cold_read_s", "train_als_s", "train_wall_s", "gj_solve_launches", "plan",
                "bulk_events_per_s", "resend_s", "duplicates", "replay_s", "catchup_s", "held", "phase_s")},
            "followers": {key: stg["followers"][key] for key in (
                "gj_solve_launches", "plan", "deploy_start_s", "queries_per_s", "p50_ms", "p99_ms", "freshness",
                "fold_ms", "events_seen", "accepted", "phase_s")},
            "workflow_cold_read_s": wf["cold_read_s"],
            "remote": {key: stg["remote"][key] for key in (
                "import_s", "read_s", "pages", "gj_solve_launches", "plan", "unready_s", "recovered_s",
                "outage_s", "goodput_in_outage_qps", "phase_s")},
            "sharedfs": stg["sharedfs"], "phase_s": stg["phase_s"],
        },
        "chaos": {**chaos_out["drills"], "train": chaos_out["train"], "phase_s": chaos_out["phase_s"]},
        "tooling": {
            "lint": tooling["lint"],
            "train": {key: tooling["train"][key] for key in (
                "plan", "launches_witnessed", "compiles_witnessed", "transfers", "transfer_bytes", "constructions",
                "train_als_s_plain", "train_als_s_witnessed")},
            "batchpredict": {key: tooling["batchpredict"][key] for key in (
                "byte_equal", "transfers", "transfer_bytes", "violations", "wall_s_plain", "command_s_witnessed")},
            "tsan": {label: {key: run[key] for key in ("edges", "inversions", "gaps", "unwaived_cycles", "wall_s")}
                     for label, run in tooling["tsan"].items()},
            "entry": {key: tooling["entry"][key] for key in ("device", "p50_ms")},
            "dryrun": {key: tooling["dryrun"][key] for key in (
                "mesh", "plan", "gj_solve_launches", "solve_widths", "fused_ce_launches", "seconds")},
            "launchers": {key: tooling["launchers"][key] for key in ("daemon_start_s", "stop_s", "phase_s")},
            "phase_s": tooling["phase_s"],
        },
        "tt_wide": {key: ttq["wide"][key] for key in (
            "dim", "steps", "launches", "loss_last", "loss_rel_vs_off", "train_s", "off_train_s")},
        "multihost": {
            "mesh": {key: mh_mesh[key] for key in (
                "mesh", "train_s", "gj_solve_launches", "plan", "position_bytes", "replicated_bytes", "rmse",
                "rmse_single", "rmse_rel_diff", "top10_differing", "tie_gap_max", "factor_rel_diff", "resume_mesh",
                "resume_rel_diff", "phase_s")},
            "ranks": [{key: r[key] for key in ("backend", "train_s", "gj_solve_launches", "plan",
                                                "received_over_owned")} for r in mh_procs["ranks"]],
            "rank0": mh_procs["rank0"], "nccl": mh_procs["nccl"]["backend"],
            "cli": {key: mh_procs["cli"][key] for key in (
                "shards", "single_train_s", "ranks_wall_s", "rank_launches", "plan_rank", "top10_differing",
                "tie_gap_max", "factor_rel_diff", "phase_s")},
            "tt": {key: mh_tt[key] for key in ("mesh", "steps", "loss_rel_diff", "tower_rel_diff",
                                               "tower_rel_diff_f32", "fused_ce_launches", "train_s",
                                               "single_train_s")},
        },
        "wall_s": time.perf_counter() - t_start,
    }
    stopped = stop_descendants()
    log(f"[cleanup] {len(stopped)} processes left running by the phases, now stopped: {json.dumps(stopped)}; "
        f"this script the subreaper of its orphans: {SUBREAPER}")
    summary["stopped_at_end"] = len(stopped)
    log(f"[summary] {json.dumps(summary)}")
    log(json.dumps({"kernels": kernels}))
    log(info["smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


def exit_clean(code: int) -> None:
    """Run the exit handlers now, stop whatever they or the phases left,
    and end the process without the interpreter's own exit: a handler or
    a finalizer that ran after the last check could start a process (a
    semaphore's finalizer restarts multiprocessing's resource tracker)."""
    import atexit
    import gc

    with contextlib.suppress(BaseException):
        atexit._run_exitfuncs()
    gc.collect()
    stop_descendants()
    if _descendants():
        code = code or 1
    with contextlib.suppress(BaseException):
        sys.stdout.flush()
        sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    SUBREAPER = adopt_orphans()
    code = 1
    try:
        code = main()
    except SystemExit as exc:
        if exc.code is not None and not isinstance(exc.code, int):
            print(exc.code, file=sys.stderr)
        code = exc.code if isinstance(exc.code, int) else 1
    except BaseException:
        import traceback

        traceback.print_exc()
    finally:
        exit_clean(code)
