#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``predictionio_tpu_torch``) on
one NVIDIA GPU: the quickest proof that the port builds, trains and serves
there.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero:

1. Header: the card's name and power limit (nvidia-smi), the torch/CUDA
   versions, and the build of every kernel from ``csrc/`` (one nvcc per
   source, all started together).
2. K3 (``ops/topn.py``, ``csrc/topn.cu``) against its plain twin on the
   card, at the full-width serving shape (N=26,744 items, rank 32, B in
   {8, 32, 128}, n=16) and at edge shapes (n=1, n=N, n > the tile, ragged
   catalogs, rank above the staging chunk, exact ties from duplicated item
   rows, zero query rows, whose top n must be items 0..n-1). Scores agree
   to rtol 1e-5 / atol 1e-6 (the two sum in different orders); ids are
   equal except inside near-tie runs, where the id sets agree; with exact
   ties ids and scores are equal. Times: the kernel, the
   plain twin, and one library call for the same function
   (``torch.topk(q @ Y.T, n)``, a yardstick the port never calls), each by
   CUDA events over many calls, beside the bound.
3. Training on ML-20M-shaped ratings (138,493 users x 26,744 items,
   20,000,000 ratings from a copy of the bench's generator), rank 32, 10
   sweeps, reg 0.05 weighted, float32:
   a. K4, K5a and K5b (``ops/device_pack.py``, ``csrc/device_pack.cu``)
      against their twins on the card, every output bit for bit: on the
      ML-20M wire (``build_host_wire``; uint16 ids, nibble-packed values,
      uploaded in two chunks as the streaming trainer uploads it); on small
      wires of the other tiers (int32 ids, float32 values, int8 values with
      a negative rating, offsets lengthened by ``aux_pad``, an empty COO),
      uploaded in three chunks so K4 writes at unaligned offsets; and K5b's
      sort alone at 2, 3 and 4 passes, also against numpy's stable order.
      Then K1 (``ops/normal_eq.py``) and K2 (``ops/spd_solve.py``) against
      their twins on the real sides, packed on the card from the wire: the
      first half-step, then both half-steps of sweep 4; K1 also on random
      packs and K2 on random SPD batches at k in {1, 7, 32, 33, 64 or 70},
      both forms of each (K2 also against float64 numpy). Tolerances: K1
      within 1e-4 of its row's scale (a row sums up to 1.09M products in
      float32, the two forms in different orders); K2 within 1e-4 of the
      row's largest entry (one algorithm, rounded in different places).
   b. The main path, with every launch count set to 0 just before and read
      just after: ``ALSAlgorithm.train(device)`` on
      ``StreamingTrainingData`` over a ``ColumnarStream`` of the ratings
      (ids as strings, 20 batches of 1M events) → ``train_als_streaming``,
      then RMSE on the training ratings through K7: K4 = 2 (one per upload
      chunk), K5a = K5b = 1, K1 = K2 = 2 x sweeps, K7 = one per
      1,048,576-pair chunk, K12 and every twin 0.
   c. The streaming wire against ``build_host_wire`` over the relabelled
      COO, byte for byte; a second streaming training, with its timings,
      and the direct route (``train_als`` on the relabelled COO, with its
      timings): factors bit-identical to (b)'s. The host-pack route
      (``pack_segments``, ``device_pack``) on the same COO, timed beside
      them; its user planes equal K5a's over the real segments.
   d. The same 10 sweeps with the twins, driven by this script, against the
      kernels' loop on the same packs: factors within 2e-3 of the largest
      entry and telemetry rows within rtol 2e-3 (float32 rounding carried
      through 20 half-steps).
   e. K7 against its twin on all 20M pairs (within 1e-5 of Σ|x·y|).
   f. Times: each kernel and twin at the main path's shapes by CUDA events,
      each kernel's device time, the library call for K2
      (``torch.cholesky_solve`` after ``torch.linalg.cholesky``) and, for
      K5b, ``torch.sort(stable=True)`` of its keys (the sort only: no one
      PyTorch call computes K4, K5a or K5b), bounds, and the loop's device
      busy share (its time on the card alone over its wall time). Device
      times are CUDA-event times of calls queued behind a spin kernel, so
      the card runs them with no wait for the host (``device_ms``).
3r. Delta retraining (after 3), the path of every retrain after the
   first (``pio train --continuous``; the reference's ``bench_delta_train``,
   ``bench.py:2195``): first K8 (``ops/delta_scatter.py``,
   ``csrc/delta_scatter.cu``: ``delta_counts_prefix``, ``move_and_append``,
   ``shift_offsets``) against its twins bit for bit on random packs (uint16
   and int32 ids, int8 and float32 values, old padding dropped past the new
   length, the tail past the moved padding filled, a 600-row run, an empty
   delta, 2M slots). Then the same ML-20M ratings as a store that grows by
   appended 10,000-event deltas (``DeltaStore``: a ``ColumnarStream`` with
   a fingerprint, cache key, weakref-able scope, cursor and
   ``delta_factory``), through ``train_als_streaming`` with
   ``set_resident_training(True)``, ``warm_sweeps=2``, each round counted
   from 0: a cold round (``miss``, ``resident=cold``, the pack parked on the
   card); a hit (factors bit-equal to the cold round's, no K4, an upload
   smaller than the wire); two chained scatter rounds on existing ids whose
   counts avoid ``count % L == 0`` (``bench.py:2280``): ``fold``,
   ``scatter``, K8a = K8b = K8c = 1, K5a = K5b = 1, K4 = 0, K1 = K2 = 4,
   twins 0, K8's outputs bit-equal to its twins' on the round's own inputs,
   the resident wire byte-equal to ``build_host_wire`` of the grown store,
   an upload of at most 10x the delta rows' encoded size (7 B a row). Then
   the same data with residency off (a cold round and two host folds):
   factors bit-equal to the scatter rounds'; a cold 10-sweep ``train_als``
   of the grown store and the RMSE gap of the warm model over it on the
   training ratings (at most 1e-3, the reference's gate). Then a random
   delta with 1 % new users: ``fold``, ``fallback``, 0 resident bytes, the
   folded wire byte-equal to a cold rescan's; a hit parks the pack again
   and ``release_resident_packs()`` returns 1, leaves 0 resident bytes and
   restores the rescan's host wire. Printed per round: the wall clock,
   ``delta_scan_s``, ``fold_exposed_s``, ``device_put_exposed_s``,
   ``device_loop_s``, ``delta_upload_bytes``, the resident bytes and the
   launches; K8's kernel, device and plain times and bounds at round 2's
   inputs (``delta_training``).
3i. Implicit training (``implicit_prefs=True``, alpha 1.0) on the same
   ratings read as confidences, same rank, sweeps and reg:
   a. The main path, counted from 0: ``ALSAlgorithm.train`` on the same
      stream: K4 = 2, K5a = K5b = 1, K1 = K2 = 2 x sweeps, K12a = 4 x
      sweeps (one Gramian before each half-step, two in each sweep's
      objective), K12b = sweeps, K3, K7, K14 and every twin 0. A second
      streaming training (its timings and per-sweep telemetry, objective
      included, printed as ``implicit_telemetry``) and the direct route
      (``train_als``): factors and telemetry bit-identical.
   b. K1 (implicit weights), K2 (+G), K12a and K12b against their twins on
      the path's packs and factors: the first half-steps and sweep 4's
      (K1 and K2 at 3a's tolerances, b's scale from the implicit weights;
      K12a within 1e-4 of G's largest diagonal entry, symmetric; K12b
      within 1e-4 of its largest term's magnitude, computed in float64,
      and bit for bit against a second launch).
   c. Three sweeps driven by this script with the twins against the
      kernels' loop: factors within 2e-3 of the largest entry, objectives
      rtol 2e-3.
   d. Times of K1 and K2 in implicit mode, K12a (users, items) and K12b
      (with its two Gramians) at the path's shapes, their twins, the
      library call for K12a (``X.T @ X``, TF32 off; K12b has none), bounds
      and the implicit loop's busy share (``implicit_training``).
3p. iALS++ at full width: first K11a (``ops/subspace.py``,
   ``csrc/subspace.cu``: ``subspace_accumulate``) and K11b
   (``subspace_block_solve``) against their twins on random packs (a row
   of many segments, an empty row, dislikes) at k in {8, 32, 64} and b in
   {1, 2, 4, 8, k}, explicit and implicit (K11a within 1e-4 of each row's
   scale as K1, K11b's rows within 1e-4 of their largest entry as K2, both
   bit for bit against a second launch): with b < k a whole half-step with
   each slot's score carried across the blocks (``check_subspace_block``
   at blocks 0, 1 and the last: the scores within 1e-4 of each slot's
   Σ|y_c x_c| of the twin's, K11b's Δ bit for bit the kernel's own change
   of X; then the half-step against the twins', within 2e-3 of the
   largest entry); with b = k one subspace half-step against K1 and K2's
   exact half-step at K2's tolerance. Then
   the main path, counted from 0: ``ALSAlgorithm.train`` with
   ``implicit_prefs=True``, ``solver="subspace"``, rank 64, block 8 (the
   reference's bench setting), 10 sweeps, on the same stream: K11a = K11b
   = 2 x 8 x sweeps, K11a's combine once per K11a launch on a side with
   multi-group rows, K12a = 4 x sweeps, K12b = sweeps, K1 = K2 = 0, every
   twin 0. A second streaming training and the direct route: factors,
   per-sweep and per-block telemetry bit-identical; the objective printed
   per sweep, never gated on its sign. K11a and K11b against their twins
   on the path's packs (blocks 0, 1 and 7 of sweep 4's user and item
   half-steps, the score carried, each half-step whole against the
   twins'; the checked user half-step bit for bit ``_solve_side_subspace``'s);
   two sweeps driven by the twins (carrying the score too) against the
   kernels' loop (within 2e-3 of the largest entry). The same stream
   trained with ``solver="exact"`` at rank 64: the two loops'
   ``device_loop_s`` and hit-rate@10 of both models over the ratings >=
   4.0 of 2,000 seeded users (``bench.py:2573``, in matrix), recorded, not
   gated. Times at the path's shapes: K11a at blocks 0, 1 and 7 of both
   half-steps and the mean a launch over a half-step (its row's time), a
   whole half-step of K11a and K11b, K11b at block 0; the twins at block
   0, the library call for K11b (batched ``torch.linalg.cholesky`` +
   ``cholesky_solve`` of the block systems; K11a has none), bounds and the
   loop's busy share (``subspace_training``).
3s. Similar Product training, reduced to the stream's first 2,000,000
   events as views (all 138,493 users, all 26,744 items with 1-3 of 24
   seeded categories) and the next 500,000 as likes and dislikes (30 %
   dislikes, the last fifth repeating the first fifth's pairs later): the
   reference's ``_ratings`` deduplicates in a Python dict, and 20M event
   objects would take most of the script's time. ``ALSAlgorithm.train``
   and ``LikeAlgorithm.train`` (rank 32, 10 sweeps, lambda 0.01, alpha
   1.0), each counted from 0: K1 = K2 = 20, K12a = 40, K12b = 10, K5a =
   K5b = 1, K4 at most 1, K14 and every twin 0. After each training, K1
   (implicit), K2 (+G), K12a and K12b against their twins on that
   training's packs (built from the algorithm's own deduplicated values;
   LikeAlgorithm's hold dislikes, r = -1) as in 3i b. Then R3's traffic
   (``sp_traffic``, 320 queries) through the host path of
   ``SPModel.similar`` (no retriever) of each model, counted from 0: K14
   once per query with a known item, nothing else; every answer against
   the twin-driven host path (ids outside near-tie runs, scores rtol 1e-5
   / atol 1e-6); ALSAlgorithm's also against the retriever-served answers
   of the same model; then ``release_serving`` and a straggler query,
   answered by the host path (K14 + 1). K14
   against its twin at Q = 4, 8, 16 over the trained catalog (within 1e-5
   of Σ_q |q·y|), and timed at Q = 16 through the host path's launch
   (``SimilarityScorer.sums``, a shard table of one) beside
   ``(q @ Y.T).sum(0)``, with the host side of the call part by part
   (``host_breakdown``) (``similarproduct_training``).
3d. DIMSUM on 3s's TrainingData: ``DIMSUMAlgorithm.train`` at thresholds
   0.0 and 0.5, each counted from 0: K19a (``ops/cooccurrence.py``,
   ``csrc/cooccurrence.cu``: ``cooccur_counts``) = K19b
   (``cosine_from_counts``) = 1, twins 0. K19a bit for bit against its twin
   (and its counts summing to the pairs i >= j of every user's distinct
   items), both models bit for bit against the twins'; every row within
   1e-6 of float64 cosines from the counts, and against the dense float32
   ``Rn @ Rn.T`` of the reference (TF32 off; one call, the library time)
   at rtol 1e-5 / atol 1e-6 wherever the dense product's own rounding
   allows it (co-view counts up to 167), its gap elsewhere printed; the
   0.5 model is the 0.0 model filtered. R3's 320 queries through
   ``predict`` at each threshold, equal to the twin model's answers. The
   seconds of the host dedup, the kernels and the device-to-host copy;
   times of K19a and K19b, their twins and bounds (``dimsum``).
3e. Grid evaluation (after 3d): first K13a (``ops/grid.py``,
   ``csrc/grid.cu``: ``normal_eq_variants``) and K13b
   (``spd_solve_variants``) on random packs (a row of many segments, an
   empty row, dislikes) at k in {1, 8, 16, 24, 33}, V in {1, 2, 3, 4, 5},
   explicit and implicit: variant v bit for bit against K1 and K2 run on it alone,
   and against the twins at K1's and K2's tolerances. Then the main path,
   counted from 0: ``run_evaluation(RecommendationEvaluation(k=10),
   ParamsGrid().engine_params_list)`` with ``grid_train="auto"`` on the
   ML-20M ratings as one app's ``EventColumns`` (ids indexed in sorted
   string order, as ``find_columns`` indexes them), 3 folds (seed 3), 10
   queries' worth per user, ranks 8 and 16 x regs 0.01 and 0.1, 10 sweeps:
   6 ``train_grid`` calls and 0 ``train`` calls, K13a = K13b = 120, K1 =
   K2 = 0, K3 once per 16,384-query chunk, every twin 0, 4 variants scored.
   Fold 0 at rank 16 against the serial path: ``train_als_grid`` on the
   fold's ratings in the wire's user order bit for bit equal to
   ``train_als`` per regularizer; the run's own grid factors (the host
   pack's scan order) compared for the record; fold 0's Precision@10 of
   grid and serial models within 0.02. K13a and K13b against K1, K2 and
   their twins on fold 0's packs (first user and item half-steps, ranks 8
   and 16). Times at fold 0's user side, rank 16: each kernel, its device
   time, twin and bound, K13b's library call (batched
   ``torch.linalg.cholesky`` + ``cholesky_solve`` over V x R rows), K1
   and K2 per variant; K13a at ranks 8 and 16 on both sides beside its
   bound, K1 on one variant at k = 8, 16 and 32 on the user side, and
   K13b and K2 (one variant) at ranks 8 and 16 on the user side (the
   solve sized to the rank) beside their bounds; the
   evaluation's wall clock, each stage's wall and
   thread-summed seconds (``read_eval``, host pack, upload, device loop,
   serving, metric), serving chunks, the process's RSS through the run
   and Precision@10 per variant (``evaluation``).
3h. bfloat16 training (right after 3; its grid after 3e), the reference's
   headline config (``bench.py:772-775``, :1123-1125: rank 32, 10 sweeps,
   reg 0.05, ``compute_dtype="bfloat16"``; phase 3's seed 3, so the dtype
   is the only difference):
   a. The four bf16 forms on random packs (a row of many segments, an
      empty row, ratings off the bf16 grid, dislikes in implicit mode):
      K1-bf16 (``normal_eq_bf16``) at k in {1, 7, 32, 33, 70}, explicit and
      implicit, within K1_RTOL (1e-4) of each row's scale of its twin's
      bf16 form; K13a-bf16 at (k, V) in {(8, 2), (16, 2), (33, 3)} bit for
      bit against K1-bf16 per variant; K11a-bf16 at k in {8, 32, 64} x b in
      {1, 2, 8, k} within 1e-4 of each row's scale plus, for r, one bf16
      step of the residual weight times the slot's largest |y_B| for every
      slot whose weight lies within the two summation orders' gap of a
      bf16 rounding boundary (the kernel and its twin sum d in different
      orders, so such a weight may round one step apart; the rows this
      admits are counted); K12b-bf16 at k in {8, 32}, four factor draws
      each, within BF16_OBJ_RTOL (1e-6) of its largest term's magnitude;
      each bit for bit against a second launch and not equal to its
      float32 form. Each check is also shown to fail every form that skips
      one of the reference's roundings: for K1-bf16 the float32 form, Y
      unrounded and the weights unrounded; for K11a-bf16 the float32 form
      and y, x, A's weight or the residual's weight unrounded, at the same
      per-row limits, the flip allowance included; in some row each lies
      more than ROUNDING_MARGIN (2) limits off the twin. For K12b-bf16 the
      float32 kernel's value and the forms rounding only x, only y or
      neither lie more than the limit plus twice one float32 evaluation's
      summation error (K12b-bf16's own distance from the twin, at least
      one float32 step of the value) off on some draw (a rounding moves
      the scalar by terms of either sign). A form whose skipped rounding
      changes no value (weights exact in bf16) is named, not gated.
   b. The main path, counted from 0: ``train_als_streaming`` over phase
      3's stream, then ``train_als`` on the relabelled COO: factors bit for
      bit; K4 = 2, K5a = K5b = 1, K1-bf16 = K2 = 20, float32 K1 = 0, twins
      0. Training RMSE within 5e-4 of phase 3's float32 model's. K1-bf16
      against its twin at both half-steps of sweep 4 (K1_RTOL), and its
      skipped-rounding forms outside that limit in some row there; the
      kernels' 10 sweeps on the wire's packs (equal to the main path's
      factors) against 10 sweeps of the twins by training RMSE within
      1e-4 (bf16 rounding flips compound, so factors are not gated).
   c. Implicit (alpha 1.0), counted: K1-bf16 = K2 = 20, K12a = 40,
      K12b-bf16 = 10, float32 K12b = 0; routes bit for bit; then ten
      one-sweep loops on its packs (bit for bit the main path's factors),
      K12b-bf16 against its twin after each sweep at BF16_OBJ_RTOL (and
      equal to the loop's own value), K1-bf16 implicit against its twin
      at sweep 4 with its skipped-rounding forms gated as in b; after
      sweep 4 the float32 K12b's value on the same inputs lies more than
      K12b-bf16's limit plus twice its summation error off the twin (the
      other forms' margins are printed).
   d. iALS++ (3p's config: implicit, rank 64, block 8) in bf16, counted:
      K11a-bf16 = K11b = 160, K12a = 40, K12b-bf16 = 10, K1 = 0; routes
      bit for bit; K11a-bf16 and K11b against their twins at blocks 0, 1
      and 7 of sweep 4's user and item half-steps (the score carried), each
      half-step whole against the twins', K11a-bf16's skipped-rounding
      forms gated as in a at block 0; K11a-bf16's times by block.
   e. The grid: ``train_als_grid`` in bf16 over the template's grid (ranks
      8 and 16 x regs 0.01 and 0.1) on 3e's fold-0 training ratings in the
      wire's order, each variant bit for bit equal to ``train_als`` in bf16
      of that variant, counted (K13a-bf16 = 20 per rank, float32 K13a =
      0); K13a-bf16 against K1-bf16 and its twin on fold 0's first user
      half-step at rank 16.
   f. Times: each bf16 form beside its float32 form on the same inputs
      (sweep 4's user side; K13a at fold 0's user side, rank 16, V = 2),
      device times, twins, bounds (the bf16 inputs at 2 B an entry, the
      products at the bf16 tensor-core peak; K12b-bf16 reads the float32
      factors for its regularizer); each training's wall clock,
      ``device_loop_s`` and ms per sweep beside phase 3's float32 ones
      (``bf16_training``, ``bf16_grid``).
3c. Checkpoint/resume (after 3h) through the template's route,
   ``ALSAlgorithm.train`` on phase 3's stream with ``checkpoint_dir`` (a
   temporary directory) and ``checkpoint_every=5``: 5 sweeps (one save);
   10 sweeps on the same directory, which log "resuming ALS from
   iteration 5", launch K1 10 times and equal phase 3's uninterrupted
   model bit for bit; 10 again, which resume at 10 with no K1 launch; the
   bf16 config of 3h through ``train_als_streaming`` on the same
   directory, which logs "different run", trains fresh (K1-bf16 = 20) and
   equals 3h's model bit for bit. Each save's seconds and the bytes on
   disk (``checkpoint``).
4. Serving: the model just trained is saved with ``save_model`` and served
   by ``tools.cli deploy --device cuda`` (max_batch 128, 2 ms window). 32
   concurrent clients on keep-alive connections send 320
   ``POST /queries.json`` (mostly num=10, some num 1..40, 4 unknown users,
   and up to 8 users without ratings, whose zero factors tie every item at
   0; a streamed model has none, so phase 2 holds that tie with zero query
   rows); then unknown users are sent one at a time. Every answer is held
   against the plain twin on the card; users without ratings must get
   items 0..num-1.
   K3 must launch once per served batch that held a known user, never for
   a batch of unknown users only, and the plain twin's count must stay 0.
   Latency, qps and batch fill are printed for the record, beside the
   card; the clients share the server's interpreter, so they are a floor
   of what the server can do.
5. R1, the retriever's kernels (run after phase 2): kernel A
   (``ops/masked_topn.py``, ``csrc/masked_topn.cu``: ``candidate_mask``,
   then ``masked_topn``) and kernel B (``ops/rescore.py``,
   ``csrc/rescore.cu``: ``rescore_topn``) against their twins on the card,
   on the bench's quantized catalog (a copy of ``bench.py:3044-3050``:
   50,000 items, rank 64, seed 37) through ``ItemRetriever`` operands: B in
   {8, 64, 128}, n = 16, the three tiers (float32, bf16, int8) x
   (positive_only, normalize) in {(F,F), (T,F), (T,T)}, a resident
   exclusion of 500 ids, per-query exclude widths 1, 16 and 64, include
   lists (one empty, one of 7 items: fewer live candidates than n); edge
   shapes: n = 1, n = 40 (a quantized shortlist of 1,024), a ragged catalog
   of 40 (smaller than the shortlist), exact ties from duplicated rows,
   zero query rows (items 0..n-1), and n = N over 20,000 integer rows
   whose every sum is exact (the merges and kernel B's sort in device
   memory). The candidate bits are bit-equal; A's int8 scores and ids bit
   for bit; A's f32/bf16 and B's scores to rtol 1e-5 / atol 1e-6 with ids
   equal outside near-tie runs (B on A's shortlist). Then the bench's gates
   with ItemRetriever on the card over 8 batches of 64 queries at n = 10:
   recall@10 >= 0.999 for int8 and bf16 against the float32 retriever,
   every returned score equal to ``Y[id]·q`` within rtol 1e-5 / atol 1e-5,
   a resident-bytes reduction >= 3x for int8. Times: each kernel, twin and
   library yardstick (f32 ``topk(where(mask, q @ Y.T, -inf))``, int8
   ``torch._int_mm`` + epilogue + ``topk``, bf16 ``q.bfloat16() @ Y.T`` +
   ``topk``; none is called by the port) beside its bound.
6. R2, quantized recommendation: the model phase 4 served is saved again
   with ``precision="int8"`` and with ``"bf16"``, each deployed through
   ``tools.cli deploy --device cuda`` and sent the float32 deployment's 320
   queries; every answer equals the float32 deployment's (ids outside
   near-tie runs, scores rtol 1e-5), users without ratings get items
   0..num-1, ``status.json`` says ``servingPrecision == ["int8"]`` (or
   ``["bf16"]``), and per deployment candidate_mask = masked_topn =
   rescore_topn = one launch per served batch that held a known user, K3
   and every twin 0. Then kernels A and B against their twins at this
   path's shapes (the trained catalog at int8 and bf16, user rows at B=8
   and 128, n=16, the deployment's flags; int8 stage 1 bit for bit, B at
   rtol 1e-5 / atol 1e-6), and timed there (B=128, int8).
7. R3, Similar Product: the trained item factors carried into an
   ``SPModel`` (``sp_model_from_numpy``) with seeded categories (24, 1-3 per
   item), saved, deployed through the CLI and sent 320 queries (1-10 query
   items; 30 % with categories, 10 % a whitelist, 20 % a blacklist; 4 with
   unknown items only); every answer equals the same retriever's driven by
   the plain twins on the card (through the summed-score ``Serving``);
   candidate_mask = masked_topn = one per batch with a known item,
   rescore_topn, K3 and every twin 0.
8. The ``kernels`` JSON line (kernels A and B: launches summed over R2 and
   R3, times at R2's shape, errors the largest over R1 and R2; K1 and K2:
   launches summed over the explicit, implicit and Similar Product
   trainings, times at the explicit path's user side; K12a and K12b:
   launches over the implicit and Similar Product trainings, times at the
   implicit path's user side; K14: launches on both host paths' traffic;
   K11a and K11b: launches on 3p's main path, times at its user side,
   errors the largest over 3p and the small shapes; K19a and K19b:
   launches over both DIMSUM trainings, the dense product as K19b's
   library time; K13a and K13b: launches on 3e's main path, times at its
   fold 0 user side, errors the largest over 3e and the small shapes; K8a,
   K8b and K8c: launches over 3r's scatter rounds, times at round 2's
   inputs, K1 and K2 also summed over 3r's rounds; K1-bf16, K11a-bf16 and
   K12b-bf16: launches over 3h's bf16 main paths, times at sweep 4's user
   side, K2 and K12a also summed over them; K13a-bf16: launches on 3h's
   grid; errors the largest over 3h's random packs and paths; no library
   time, as for their float32 forms; K15a, K15b and K18: launches on 3n's
   main path, times at the reference's shape, errors the largest over
   3n's checks; K16, K17a, K17b and lsq: launches on 3x's paths, lsq's
   over the backtest and the regression template, times at K22's shape;
   K20a and K20b: launches over 3y's three SimRank trainings, times at
   the Wiki-Vote-sized graph, the sparse library call where it runs;
   K3c: launches over 3y's two ``measure_compute_ms`` calls, its ms the
   bench call's time a pass, its bound and library call K3's at that
   shape; 3m's: K3s (``topn_packed_sharded``) launches on the float32 mesh
   deployment, times per batch of its launch over the shard table at B =
   128; the
   row-shard forms and K9m launches over the int8 and Similar Product mesh
   deployments, times at K10s's int8 shape, one shard; K14s
   (``cosine_sum_sharded``) launches on the mesh host path), the card
   line, then the last line ``{"ok": true, "device": {...}}``.
3n. Classification (after R3), the reference's config 2 at its shape
   (``bench.py:1841-1874``: 50,000 points of 3 Poisson-count attributes in
   4 classes, seed 13, lambda 1.0, accuracy on the first 2,048 rows).
   First K15a (``ops/naive_bayes.py``, ``csrc/naive_bayes.cu``:
   ``naive_bayes_fit``) against its twin on that data (counts and sums
   bit for bit and equal to float64 sums, pi and theta within 2e-6) and on
   200,000 x 64 float features in 10 classes and 20,000 x 1,000 in 2
   (counts bit for bit, sums within 1e-5 of float64 sums relative, pi
   within 2e-6, theta within 1e-5), each one launch, bit for bit against
   a second launch and against a launch of a third of the grid (each
   block walking about three work items); at 20,000 x 1,000 (1,280 items,
   more than the card holds blocks) a grid one block past the occupancy
   query's capacity must raise; K15b
   (``naive_bayes_scores``) at B in {1, 7, 2048} and on a lambda = 0
   model's NaN rows and a tie model's rows: labels equal to the twin's
   (first NaN, else first maximum), scores within 1e-5; K18
   (``ops/softmax_regression.py``, ``csrc/softmax_regression.cu``) at
   (lr, l2) in {(0.1, 0), (0.05, 0.01)}, 200 steps: W and b within 1e-5
   of the twin's largest entry, bit for bit against a second launch. Then
   the main path, counted from 0: ``NaiveBayesAlgorithm.train`` and
   ``batch_predict`` of the 2,048 rows, ``LogisticRegressionAlgorithm.train``
   and ``batch_predict``, each model saved and deployed through ``tools.cli
   deploy --device cuda`` and sent 64 ``POST /queries.json`` from 8
   clients, every answer equal to ``batch_predict``'s: K15a = 1, K15b = 2 +
   the naive deployment's served batches, K18 = 400 (two launches a step),
   twins 0, and one placement of pi and theta (the deployment's; the
   trained model keeps its fit's). Train wall clocks and accuracies, the
   twins' accuracies equal; K15a's and K15b's host µs by part;
   times of each kernel (K18 as one 200-step training), device times,
   twins, library calls (K15a: ``index_add_`` of the sums alone; K15b:
   ``addmm`` + ``argmax``, two calls; K18 none) and bounds
   (``classification``).
3x. The e2 library and the least-squares templates (after 3n), each path
   counted from 0:
   a. K17 (``ops/categorical_nb.py``, ``csrc/categorical_nb.cu``) at UCI
      Adult's categorical shape scaled to 1,000,000 rows (8 slots of 9, 16,
      7, 15, 6, 5, 2 and 42 values, 2 labels, a seeded class-conditional
      model): ``CategoricalNaiveBayes.train``, ``predict_batch`` of 2,048
      rows, then of 256 rows with unknown values (one row all unknown,
      label 0): K17a = 1, K17b = 2, twins 0. K17a's counts bit for bit
      against a second launch, the twin (``bincount``) and numpy, the
      model's logs equal numpy's on them; K17b's scores within 1e-6
      (relative) of the twin's with -inf in the same places, labels equal
      outside ties (1e-5), a second launch bit for bit (``categorical_nb``).
   b. K16 (``ops/markov.py``, ``csrc/markov.cu``): ``MarkovChain.train`` on
      1,000,000 seeded Zipf-skewed tally entries over 100,000 states, top
      10, then 100 ``predict`` calls: K16 = 100, twin 0; each answer within
      rtol 1e-6 / atol 1e-7 of the twin, bit for bit against a second
      launch, the first against float64 numpy (``markov``).
   c. K21 (``ops/lstsq.py``, ``csrc/lstsq.cu``): ``backtest`` with
      ``RegressionStrategy`` on a 500-ticker synthetic panel of 600 days
      over the DataSource's 4 default windows: lsq = 4 (one a window),
      twin 0; every window's coefficients within 1e-5 of float64 numpy;
      then lsq against its twin and float64 numpy on conditioned batches,
      30 and 64 columns, m < n, a duplicated column, a zero column, a zero
      matrix and an empty one (ranks equal, every system converged, a
      second launch bit for bit), and a solve cut at one Jacobi sweep must
      report -1 sweeps and make ``require_converged`` raise (``stock``).
   d. K22: a 200,000-line x 10-feature file; ``OLSAlgorithm.train``, then
      ``run_evaluation`` with ``MeanSquareError`` over 5 folds: lsq = 6,
      twin 0; the coefficients within 1e-5 of float64 numpy, the MSE within
      1e-4 of float64 fits of the same folds; the model saved, deployed
      through ``tools.cli deploy --device cuda`` and sent 64 queries from 8
      clients, every answer equal to ``batch_predict``'s (``regression``).
   Times: each kernel, its device time, its twin and library call (K16:
   the float32 ``index_add_`` of the products, the scatter alone; K17a:
   ``bincount``; K17b none; lsq: ``torch.linalg.lstsq``, whose CUDA form
   takes full-rank systems only) and bounds, at the paths' shapes; the
   host wall clocks of each path.
3y. SimRank friend recommendation, K3c and the five experimental templates
   that need no event store (after 3x), each path counted from 0:
   a. K20a (``ops/simrank.py``, ``csrc/simrank.cu``: ``simrank_propagate``,
      U = P S) and K20b (``simrank_contract``, decay · U Pᵀ with the
      diagonal 1) against their twins (dense float32 products, TF32 off) on
      a seeded graph of SNAP Wiki-Vote's size (7,115 vertices, 103,689
      edges: power-law out-degrees up to about 900, 5 % of the vertices
      without out-edges, repeated edges, self-loops), 5 iterations: every
      entry within rtol 1e-5 / atol 1e-6; each kernel against its twin on
      the 4th iteration's state and bit for bit against a second launch;
      every vertex without out-edges exactly 0 off the diagonal. The same
      on a 1,000-vertex graph and on a graph of repeated edges and
      self-loops, also against float64 numpy; on n = 0, n = 1 and n in {2,
      257, 1,031, 3,001, 5,003, 9,001} (off every tile; K20b's 8, 4, 2 and 1
      rows a block), 2 iterations; and on a graph where 550 of 600 vertices
      have no out-edges.
   b. The main path: the edge list written to a file, then
      ``SimRankDataSource`` -> ``SimRankAlgorithm.train(cuda)``: K20a =
      K20b = 5, twins 0, the scores bit for bit (a)'s; the same for
      ``NodeSamplingDataSource`` and ``ForestFireSamplingDataSource`` at
      ``sample_fraction=0.5`` (their scores against the twins as in a).
      The train's wall clock split into the host CSR build, the upload,
      the loop and the one device-to-host copy of the [n, n] scores. The
      model saved (engine ``"simrank"``), deployed through ``tools.cli
      deploy --device cuda`` and sent 64 ``POST /queries.json`` from 8
      clients (``{"item1": a, "item2": b}``; the diagonal and high
      off-diagonal pairs among them), each answer the model's score.
      Times of K20a and K20b at the 5th iteration, device times, twins,
      bounds (each [n, n] input read and output written once, the CSR once;
      2·nnz·n operations) and the library calls (the dense product, TF32
      off, and ``torch.sparse.mm`` with a CSR P where it runs; the port
      calls neither) (``simrank``).
   c. K3c (``ops/topn.py`` ``topn_chain``, ``csrc/topn.cu`` ``topn_f32``
      with ``n_iters`` passes): ``ServingFactors.measure_compute_ms`` at the
      bench's call (phase 3's model, its first 32 users, n = 10,
      ``iters=4096``) and at phase 2's shape (a seeded catalog of 26,744 x
      32, B = 128, n = 16): 1 + 2 x 5 chain launches each, K3 and twins 0;
      a 4,096-pass chain's output bit for bit K3's on the query offset by
      the last pass, a 3-pass chain against its twin (ids outside near-tie
      runs, scores rtol 1e-5 / atol 1e-6). The measured ms a pass printed
      beside K3's time on the card alone at the same shape and phase 2's,
      not gated (``k3c``).
   d. The five templates on ML-100K-shaped ratings (a copy of the bench's
      ``synth_ml100k``: 943 x 1,682, 100,000 ratings, written as
      ``user::item::rate`` lines), rank 10, 10 sweeps, lambda 0.05, each
      training K1 = K2 = 20 with every twin 0: ``custom_datasource`` (the
      file source) and ``movielens_filtering`` (the same ratings as event
      columns) train factors bit for bit the recommendation template's and
      answer its 33 queries equal (the filter dropping exactly the ids of
      two blacklists, the file edited between them); ``refactor_test``'s
      model and ``VanillaEvaluator``; ``similarproduct_localmodel`` trains
      factors bit for bit the Similar Product template's (the lines as
      views, 24 categories) and answers 22 queries, with no launch, within
      rtol 1e-5 / atol 1e-6 of that template's host path (K14);
      ``run_standalone`` with ``persist_model=True``, its model saved by
      ``make_serializable_models`` as one ``.npz`` and reloaded by
      ``prepare_deploy`` bit for bit, 64 predictions (K7) equal
      (``templates``).
3m. Serving on a device mesh (after R3): a ``parallel.Mesh`` of 4 LOGICAL
   shards of the card (``[cuda:0] * 4``; with several cards also a mesh of
   distinct cards, the same gates); phase 3's model and R1's catalog, no
   training. Logical shards of one card run one after another, so these
   are not multi-GPU times.
   a. K3s (``ServingFactors(mesh)``, one K3 launch per distinct device
      over its shards' table): phase 4's 320 served queries' user rows in
      batches of 1 to 128, bit for bit the single-device K3's answers; K3
      over a table whose blocks are out of order and over the first
      device's table of an interleaved mesh (``0,1,0,1``), each placed row
      bit for bit K3 on the whole batch; K3c's mesh form
      (``measure_compute_ms``'s chain over the tables) bit for bit one
      device's chain.
   b. K9s + K9m (``ItemRetriever(mesh)``, float32): the ML-20M item factors
      under R3's Similar Product traffic (cosine, positive_only, its
      exclude and include lists), bit for bit the single-device
      retriever's; on one batch each shard's mask (``id_offset``) bit for
      bit its twin, kernel A within RTOL/ATOL of its twin and bit for bit
      the single-device form with ids plus the offset, K9m on the
      ``[S, B, 2L]`` buffer bit for bit its twin (into a caller's ``out``
      too) and equal to the answer.
   c. K10s: the quantized catalog in int8 and bf16, B = 8 and 128, n = 10:
      each row bit for bit the single-device retriever's, or (a shard's
      own shortlist brought other candidates to the host refinement) its
      exact scores no lower, position by position; recall@10 against the
      float64 top 10 no lower than the single device's; the shard forms and
      K9m as in b (int8 stage 1 bit for bit its twin, kernel B within
      RTOL/ATOL).
   d. K14s (``SimilarityScorer(mesh)``, one launch per distinct device
      over its shards' table): Q = 4, 8, 16, every row bit for bit K14's.
   e. The main path, counted from 0: phase 3's model at float32 and int8
      and R3's Similar Product model deployed through ``tools.cli deploy
      --serving-devices 0,0,0,0``, each sent its single-device deployment's
      320 queries from 32 clients: every answer equal to that
      deployment's (int8: equal, or no lower as in c); K3 = 1 per batch
      (one per distinct device),
      the mask, kernel A and kernel B (their row-shard forms count under
      their own names) 4 per merge and none on the float32 deployment, K9m
      one per batch with a known query, K14 and every twin 0; p50, p99,
      q/s. Then
      64 of R3's queries through the Similar Product host path on the mesh
      (K14s = 1 per query with a known item and distinct device), against
      the single device's.
   Times: K3s per batch through serving's launch over the shard table
   beside K3 (B = 8, 32, 128), both with their device times, K3s with its
   one fetch, and at B = 128 both host sides part by part
   (``host_breakdown``); K14s's launch with its fetch and its host side
   part by part; one shard's mask, kernel A and kernel B at B = 128 (K9s's
   f32 cosine and K10s's tiers); K9m per call on the retriever's buffer
   into its ``out``, with its bytes bound, ``torch.topk`` over the
   concatenated scores as the library call and its host side part by part;
   K14s; launches per served batch (``mesh_serving``).
3t. ALS training on a device mesh (after 3h's grid): a ``parallel.Mesh``
   of 4 LOGICAL shards of the card (``[cuda:0] * 4``; with several cards
   also the visible cards, which must give phase 3's model). Logical
   shards of one card run one after another, so these are not multi-GPU
   times.
   a. The row-shard forms on the real ML-20M sides (rank 32), packed as
      ``train_als``'s mesh route packs them: each shard's K1 systems and
      K2 rows (``out=``) bit for bit one device's launch on the wire
      route's packs, at the first half-steps and sweep 4's (also with G);
      K12a over the replica bit for bit one device's G; the sharded K12b
      (every shard's partials, one finish) within 1e-6 of one device's
      objective, of its scale (the same terms summed in another order);
      K11a (its score carried, a buffer a shard) and K11b (its Δ) at 3p's
      rank 64, b = 8, block by block, and K13a and
      K13b at 3e's fold-0 shape (rank 16, V = 2, ``row0=``/``out=``), bit
      for bit. Edge cases on small ratings: a user heavier than a shard's
      share, so that shards are empty and one holds padding rows only, at
      2, 3 and 4 shards, both modes: bit for bit one device's training.
   b. The main path, every launch count set to 0 just before:
      ``Engine.train`` of the recommendation template with
      ``WorkflowContext(mesh=...)`` on phase 3's ratings (rank 32, 10
      sweeps, reg 0.05 weighted, float32): K1 = K2 = 2 x 10 x 4 = 80, K4,
      K5, K12, K3 and every twin 0; every factor bit for bit phase 3's
      model; telemetry rows within rtol 1e-6 of phase 3's (the padded rows
      are the same at ML-20M; the cross-shard sums change order).
   c. The other forms, each counted and bit for bit its single-device
      phase: implicit (3i: K12a = 40, K12b 4 shard partials and one finish
      a sweep), bf16 (3h), iALS++ (3p: K11a = K11b = 640), Similar
      Product's ``ALSAlgorithm.train(mesh)`` (3s's item factors), and a
      run checkpointed after sweep 5 and resumed to 10 (phase 3's model;
      a one-device run of the same data does not resume it).
   d. K13s: ``train_als_grid(mesh=)`` on 3e's fold 0 (rank 16, regs 0.01
      and 0.1) bit for bit ``train_als_grid(device)``; ``run_evaluation``
      at ML-100K's shape (3 folds, 4 variants, ``train_grid`` only, K13a
      = K13b = 4 x 2 x 10 a grid): every model and Precision@10 equal to
      one device's.
   e. Times: ms per sweep on the mesh beside phase 3's and 3i's; each
      shard's K1 and K2 at sweep 4 and the shards' sum beside one
      device's launch; the K12b, K11 and K13 shard forms the same way
      (K13s per grid half-step); the mesh route's host pack beside the
      direct and streaming routes'; the per-shard slot and rating skew;
      the phase's wall clock (``mesh_training``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import http.client
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

ML20M_USERS, ML20M_ITEMS, RANK = 138_493, 26_744, 32
RTOL, ATOL = 1e-5, 1e-6
BF16 = "bfloat16"  # ALSConfig.compute_dtype of the bfloat16 phases


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time per call on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
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


# about 50 ms at the H100's boost clock: longer than the host takes to
# enqueue any timed batch of calls here
SPIN_CYCLES = 100_000_000


def device_ms(fn, calls: int = 20) -> float:
    """Time per call on the card alone, by CUDA events: a spin kernel holds
    the stream while the host enqueues the ``calls`` calls, so they run
    back to back with no wait for the host. Raises if the spin ended
    before the host had enqueued them all. torch.profiler is not used for
    device times: on the chip machine its traces lose kernel records (the
    first of a session, more as the process ages, torch's own cuBLAS
    kernels as much as the port's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    caught_up = start.query()
    torch.cuda.synchronize()
    if caught_up:
        raise AssertionError("the card caught up with the host: the spin is too short")
    return start.elapsed_time(end) / calls


def _timing_shim(orig, acc, part, context=False):
    """``orig`` with its host time added to ``acc[part]``; a context-manager
    class (``context``) stays a class (torch checks ``isinstance`` against
    ``torch.cuda.device``), its construction, enter and exit timed."""
    def timed(fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[part] += time.perf_counter() - t
        return run

    if context:
        return type(orig.__name__, (orig,), {
            "__init__": timed(orig.__init__), "__enter__": timed(orig.__enter__),
            "__exit__": timed(orig.__exit__)})
    return timed(orig)


def wrapper_parts(module):
    """What a kernel wrapper of ``module`` (an ``ops`` module with a
    ``_LIBRARY`` and ``LAUNCHES``) may spend its host time on, as (part,
    owner, attribute, is a context manager): each is patched with a timer
    by ``host_breakdown``. Whatever a call spends outside them (its checks,
    its arithmetic on shapes, building its arguments) is the residual,
    "validation and the wrapper's own lines"."""
    import ctypes

    import torch

    from predictionio_tpu_torch.ops import native

    lib = module._LIBRARY.get()
    parts = [("allocation", torch, "empty", False),
             ("device switch", torch.cuda, "device", True),
             ("stream lookup", torch.cuda, "current_stream", False),
             ("library lookup", module._LIBRARY, "get", False),
             ("error check and launch counter", module._LIBRARY, "check", False),
             ("error check and launch counter", module.LAUNCHES, "add", False),
             ("stream lookup", native, "current_stream", False)]
    if hasattr(module, "fit_plan"):
        parts.append(("plan", module, "fit_plan", False))
    parts += [("ctypes call", lib, name, False) for name, f in list(vars(lib).items())
              if isinstance(f, ctypes._CFuncPtr)]
    return parts


def _patch(parts, acc):
    saved = []
    for name, owner, attr, context in parts:
        saved.append((owner, attr, attr in vars(owner), vars(owner).get(attr)))
        setattr(owner, attr, _timing_shim(getattr(owner, attr), acc, name, context))
    return saved


def _unpatch(saved):
    for owner, attr, own, value in reversed(saved):
        if own:
            setattr(owner, attr, value)
        else:
            delattr(owner, attr)


def _enqueue_s(call, calls: int) -> float:
    """Host seconds for ``calls`` calls of ``call`` queued behind a spin
    kernel (twice device_ms's); raises if the spin ended first."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2 * SPIN_CYCLES)
    start.record()
    t = time.perf_counter()
    for _ in range(calls):
        call()
    elapsed = time.perf_counter() - t
    caught_up = start.query()
    torch.cuda.synchronize()
    if caught_up:
        raise AssertionError(f"host_breakdown: the spin ended before the calls were enqueued "
                             f"({elapsed * 1e3:.2f} ms for {calls} calls)")
    return elapsed


def host_breakdown(call, parts, calls: int = 100, reps: int = 3):
    """The host side of ``call``, in µs per call, from ``calls`` back-to-back
    calls (``time.perf_counter``; few enough that their launches stay well
    inside the launch queue) while a spin kernel holds the stream, so every
    launch only enqueues: ``whole`` is the call as it is, and each
    part of ``parts`` (``wrapper_parts``) the time spent inside it during as
    many calls with every part's function wrapped by a timer; the residual
    is ``whole`` less the parts. The median of ``reps`` runs of each."""
    import statistics

    import torch

    names = list(dict.fromkeys(p[0] for p in parts))
    call()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        row = {"whole": _enqueue_s(call, calls) / calls * 1e6}
        acc = dict.fromkeys(names, 0.0)
        saved = _patch(parts, acc)
        try:
            _enqueue_s(call, calls)
        finally:
            _unpatch(saved)
        row.update({name: acc[name] / calls * 1e6 for name in names})
        row["validation and the wrapper's own lines"] = row["whole"] - sum(acc.values()) / calls * 1e6
        runs.append(row)
    return {key: statistics.median(r[key] for r in runs) for key in runs[0]}


def roofline(nbytes: float, flops: float, peak_ops: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): bytes over the memory rate vs operations over
    their type's peak (fp32 unless ``peak_ops`` says otherwise), whichever
    takes longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_ops
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def bound(B: int, N: int, k: int, n: int):
    """K3's (bound_ms, bound_by): q, Y and the packed output each moved
    once vs the product's 2·B·N·k fp32 operations."""
    return roofline(4 * (B * k + N * k + B * 2 * n), 2 * B * N * k)


def kernel_phase(rng, device):
    """K3 against its plain twin on the card; returns (max_abs_err,
    per-shape timing rows)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops.als import _unpack_indices
    from predictionio_tpu_torch.ops.topn import (
        check_topn_agreement,
        topn_packed,
        topn_packed_plain,
    )

    def unpack(packed, n):
        p = packed.cpu().numpy()
        return p[:, :n], _unpack_indices(p, n)

    def compare(name, q_np, Y_np, n, exact=False):
        q = torch.from_numpy(q_np).to(device)
        Y = torch.from_numpy(Y_np).to(device)
        got = topn_packed(q, Y, n)
        ref = topn_packed_plain(q, Y, n)
        torch.cuda.synchronize()
        gs, gi = unpack(got, n)
        rs, ri = unpack(ref, n)
        if exact:
            if not (np.array_equal(gi, ri) and np.array_equal(gs, rs)):
                raise AssertionError(f"{name}: exact-tie case differs from the plain twin")
            err = 0.0
        else:
            err = check_topn_agreement(gs, gi, rs, ri, RTOL, ATOL, q=q_np, Y=Y_np)
        print(f"  {name}: B={q_np.shape[0]} N={Y_np.shape[0]} "
              f"k={Y_np.shape[1]} n={n} max_abs_err={err:.3g} ok", flush=True)
        return err

    def normal(*shape, k):
        return rng.normal(0.0, 1.0 / np.sqrt(k), size=shape).astype(np.float32)

    Y_full = normal(ML20M_ITEMS, RANK, k=RANK)
    errs = []
    for B in (8, 32, 128):
        errs.append(compare(f"full width B={B}", normal(B, RANK, k=RANK), Y_full, 16))
    errs.append(compare("n=1", normal(8, RANK, k=RANK), Y_full, 1))
    errs.append(compare("n=64 (num up to 40)", normal(128, RANK, k=RANK), Y_full, 64))
    errs.append(compare("n > tile", normal(8, RANK, k=RANK), Y_full, 1000))
    small = normal(1000, 10, k=10)
    errs.append(compare("n=N, ragged N", normal(8, 10, k=10), small, 1000))
    errs.append(compare("N < tile, B not pow2", normal(5, 10, k=10), small[:100], 100))
    errs.append(compare("rank above chunk", normal(16, 100, k=100), normal(5000, 100, k=100), 32))
    ties = rng.integers(-3, 4, size=(1000, 8)).astype(np.float32)
    ties = np.concatenate([ties, ties, ties[:300]])  # every row repeated
    q_ties = rng.integers(-3, 4, size=(16, 8)).astype(np.float32)
    for n in (16, 300, len(ties)):
        errs.append(compare(f"exact ties n={n}", q_ties, ties, n, exact=True))
    # a user without ratings: zero factors, every item ties at 0, so the
    # top n are items 0..n-1
    zero_q = np.zeros((8, RANK), np.float32)
    errs.append(compare("zero query rows", zero_q, Y_full, 16, exact=True))
    _, zi = unpack(topn_packed(torch.from_numpy(zero_q).to(device), torch.from_numpy(Y_full).to(device), 16), 16)
    if not (zi == np.arange(16)).all():
        raise AssertionError(f"zero query rows got items {zi[0]}, not 0..15")

    rows = []
    Yd = torch.from_numpy(Y_full).to(device)
    for B, n in ((8, 16), (32, 16), (128, 16), (128, 64)):
        q = torch.from_numpy(normal(B, RANK, k=RANK)).to(device)
        k_ms = time_ms(lambda: topn_packed(q, Yd, n))
        p_ms = time_ms(lambda: topn_packed_plain(q, Yd, n))
        l_ms = time_ms(lambda: torch.topk(q @ Yd.T, n))
        k_ms2 = time_ms(lambda: topn_packed(q, Yd, n))
        dev_ms = device_ms(lambda: topn_packed(q, Yd, n), calls=200)
        b_ms, b_by = bound(B, ML20M_ITEMS, RANK, n)
        rows.append({
            "B": B, "N": ML20M_ITEMS, "k": RANK, "n": n,
            "ms": (k_ms + k_ms2) / 2, "ms_runs": [k_ms, k_ms2],
            "device_ms": dev_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        })
    print("k3_timing " + json.dumps(rows), flush=True)
    return max(errs), rows


ML20M_RATINGS, SWEEPS, REG = 20_000_000, 10, 0.05
PAIR_CHUNK = 1_048_576
K1_RTOL = 1e-4  # of the row's scale; a row sums up to 1.09M products
K2_RTOL = 1e-4  # of the row's largest entry
TRAIN_RTOL = 2e-3  # kernels' vs twins' 10 sweeps, of the largest entry
K7_RTOL = 1e-5  # of Σ|x·y|


def synth_ml20m(n_users, n_items, n_ratings, seed=41):
    """MovieLens-20M-shaped synthetic ratings, a copy of the bench's
    generator (``bench.py synth_ml20m``): low-rank-plus-noise scores on a
    lognormal-activity x zipf-popularity long tail, snapped to ML-20M's
    0.5-step 0.5..5.0 rating scale."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k0 = 12
    U = (rng.standard_normal((n_users, k0)) / np.sqrt(k0)).astype(np.float32)
    V = (rng.standard_normal((n_items, k0)) / np.sqrt(k0)).astype(np.float32)
    u_p = rng.lognormal(0, 1.1, n_users)
    u_p /= u_p.sum()
    i_p = 1.0 / np.arange(1, n_items + 1) ** 0.9
    i_p /= i_p.sum()
    u = rng.choice(n_users, size=n_ratings, p=u_p).astype(np.int32)
    i = rng.choice(n_items, size=n_ratings, p=i_p).astype(np.int32)
    raw = np.empty(n_ratings, np.float32)
    for s in range(0, n_ratings, 4_000_000):  # chunk the 20M-row gather
        e = min(s + 4_000_000, n_ratings)
        raw[s:e] = np.einsum("nk,nk->n", U[u[s:e]], V[i[s:e]])
    scores = 3.0 + 1.3 * raw + 0.5 * rng.standard_normal(n_ratings)
    r = np.clip(np.round(scores * 2.0) / 2.0, 0.5, 5.0).astype(np.float32)
    return u, i, r


_RATINGS = []


def ml20m_ratings():
    """The ML-20M-shaped ratings (``synth_ml20m`` at ML20M_USERS x
    ML20M_ITEMS, ML20M_RATINGS), made once per process and shared by the
    training phases."""
    if not _RATINGS:
        _RATINGS.append(synth_ml20m(ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS))
    return _RATINGS[0]


def k1_bound(pack, n_ratings: int, Y_rows: int, k: int, bf16: bool = False):
    """K1's (bound_ms, bound_by) for one side: each rating's id and value
    (8 B; the kernel reads only the ``rem[s]`` real slots of a segment,
    never the padding), each segment's int32 count, Y, A and b each moved
    once vs the k(k+1)/2 + k FMAs per rating that the symmetric A and b
    need (2 operations each). K1-bf16 (``bf16``): Y's rows are bfloat16
    inputs (2 B an entry) and the products run at the bf16 tensor-core
    peak."""
    R = pack.n_sys_rows
    nbytes = (
        n_ratings * 8 + pack.rem.numel() * 4 + Y_rows * k * (2 if bf16 else 4)
        + R * (k * k + k) * 4
    )
    return roofline(nbytes, 2 * n_ratings * (k * (k + 1) // 2 + k),
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def lower_triangle_bytes(k: int) -> int:
    """Bytes the card reads for the lower triangle of one row-major float32
    k x k matrix: the 32-byte sectors that hold any of its entries (exact
    when the matrix starts on a sector, as every matrix of a [R, k, k]
    batch does for k a multiple of 4)."""
    return 32 * len({
        s for i in range(k) for s in range(4 * i * k // 32, (4 * (i * k + i) + 3) // 32 + 1)
    })


def k2_bound(R: int, R_obs: int, k: int):
    """K2's (bound_ms, bound_by): lam, has_obs, X_prev and X for every row,
    the lower triangle of A (all that Cholesky reads) and b for the rows it
    solves, vs k³/3 + 2k² operations per solve."""
    nbytes = R * (4 + 1 + 8 * k) + R_obs * (lower_triangle_bytes(k) + 4 * k)
    return roofline(nbytes, R_obs * (k ** 3 / 3 + 2 * k * k))


def k7_bound(P: int, n_users: int, n_items: int, k: int):
    """K7's (bound_ms, bound_by): two ids and one result per pair and both
    factor matrices once vs 2·k operations per pair."""
    return roofline(12 * P + 4 * k * (n_users + n_items), 2 * k * P)


def k1_limits(A2, pack, implicit=False, alpha=1.0):
    """Each row's limits (for A, for b) on K1's distance from its twin's
    A2: K1_RTOL of the row's scale. The largest diagonal bounds every
    Σ|w_a y_i y_j| of the row (w_a >= 0), sqrt(Σ w_b² · it) every
    Σ|w_b y_i| (Cauchy-Schwarz; w_b is the rating, or 1(v>0)(1 + α|v|) in
    implicit mode)."""
    import torch

    diag = A2.diagonal(dim1=1, dim2=2).amax(dim=1)
    w_b = pack.vals
    if implicit:
        w_b = (pack.vals > 0).to(torch.float32) * (1.0 + alpha * pack.vals.abs())
    vsq = torch.zeros(pack.n_sys_rows, dtype=torch.float32, device=A2.device).index_add_(
        0, pack.seg_rows.reshape(-1).long(), w_b.square().sum(-1).reshape(-1)
    )
    return 1e-6 + K1_RTOL * diag, 1e-6 + K1_RTOL * (vsq * diag).sqrt()


def check_k1(A, b, A2, b2, pack, label, errs, implicit=False, alpha=1.0, name="normal_eq"):
    """Hold K1's A, b against the twin's A2, b2 within ``k1_limits`` in
    every row. Returns the largest differences."""
    la, lb = k1_limits(A2, pack, implicit, alpha)
    ea = (A - A2).abs().amax(dim=(1, 2))
    eb = (b - b2).abs().amax(dim=1)
    if not bool((ea <= la).all()) or not bool((eb <= lb).all()):
        raise AssertionError(
            f"K1 {label}: differs from its twin (max |dA| {ea.max().item()}, "
            f"|db| {eb.max().item()})"
        )
    ea, eb = ea.max().item(), eb.max().item()
    errs[name] = max(errs.get(name, 0.0), ea, eb)
    return ea, eb


ROUNDING_MARGIN = 2.0  # a form that skips a rounding must lie this many limits off the twin


class PartialRounding:
    """Applies or skips one form's roundings, and records whether a skipped
    one would have changed a value: if none would, the form computes the
    bfloat16 function itself on these inputs."""

    def __init__(self):
        self.changes = False

    def __call__(self, t, do_round):
        from predictionio_tpu_torch.ops.precision import round_bf16

        r = round_bf16(t)
        if do_round:
            return r
        self.changes = self.changes or not bool((r == t).all())
        return t


def k1_partial_rounding(Y, pack, implicit, alpha, round_y, round_w):
    """K1's function with only some of K1-bf16's roundings, in the twin's
    order: Y's rows when ``round_y``, the weights when ``round_w`` (both:
    K1-bf16's twin; neither: the float32 form). What a K1-bf16 that skipped
    a rounding would compute. Returns A, b and whether a skipped rounding
    changed any value."""
    import torch

    rnd = PartialRounding()
    Yc = rnd(Y, round_y)
    R, k, L = pack.n_sys_rows, Y.shape[1], pack.cols.shape[-1]
    iota = torch.arange(L, device=Y.device)
    A = torch.zeros((R, k, k), dtype=torch.float32, device=Y.device)
    b = torch.zeros((R, k), dtype=torch.float32, device=Y.device)
    for c in range(pack.seg_rows.shape[0]):
        rows = pack.seg_rows[c].long()
        mask = (iota[None, :] < pack.rem[c][:, None]).to(torch.float32)
        v = pack.vals[c]
        Yg = Yc[pack.cols[c].long()]
        if implicit:
            conf = alpha * v.abs()
            aw = rnd(conf * mask, round_w)
            bw = rnd((v > 0).to(torch.float32) * mask * (1.0 + conf), round_w)
        else:
            aw, bw = mask, rnd(v * mask, round_w)
        A.index_add_(0, rows, torch.einsum("slk,sl,slj->skj", Yg, aw, Yg))
        b.index_add_(0, rows, torch.einsum("slk,sl->sk", Yg, bw))
    return A, b, rnd.changes


def rounding_verdict(label, form, ratio, has_rows, gate):
    """One skipped-rounding form against the twin: ``ratio`` is each row's
    distance over its limit. Gated (``gate``): some row lies more than
    ROUNDING_MARGIN limits off, so a kernel computing that form fails its
    check whatever order it sums in. Returns the printed summary."""
    worst = ratio.max().item()
    outside = int((ratio > 1.0).sum().item())
    if gate and not worst > ROUNDING_MARGIN:
        raise AssertionError(f"{label}: the form with {form} lies within {worst:.3g} limits of "
                             f"the twin; the check would not fail it")
    return f"{form}: {outside}/{has_rows} rows outside, up to {worst:.3g}x"


def check_k1_rounds(Y, pack, A2, b2, implicit, alpha, label, gate=True):
    """K1-bf16's check tells apart each form that skips a rounding: the
    float32 form, Y unrounded and the weights unrounded, each held against
    the bfloat16 twin's A2, b2 within the rows' ``k1_limits``. A form whose
    skipped rounding changes no value computes K1-bf16's function on these
    inputs (a half-step rating and its weights are exact in bfloat16) and
    is named, not gated."""
    import torch

    la, lb = k1_limits(A2, pack, implicit, alpha)
    has_rows = int((A2.diagonal(dim1=1, dim2=2).amax(dim=1) > 0).sum().item())
    out = []
    for form, ry, rw in (("float32", False, False), ("Y unrounded", False, True),
                         ("weights unrounded", True, False)):
        Am, bm, changes = k1_partial_rounding(Y, pack, implicit, alpha, ry, rw)
        if not changes:
            out.append(f"{form}: the same function here")
            continue
        ratio = torch.maximum((Am - A2).abs().amax(dim=(1, 2)) / la,
                              (bm - b2).abs().amax(dim=1) / lb)
        out.append(rounding_verdict(label, form, ratio, has_rows, gate))
    print(f"  {label}, forms that skip a rounding{'' if gate else ' (not gated)'}: "
          f"{'; '.join(out)} ok", flush=True)


def check_half_step(X_prev, Y, pack, lam, has_obs, label, errs, implicit=False,
                    alpha=1.0, G=None, compute_dtype="float32", rounds=None):
    """K1 (K1-bf16 in bfloat16 compute) and K2 against their twins on one
    real half-step (in implicit mode with the implicit weights and the
    Gramian ``G`` of Y); in bfloat16 with ``rounds`` ("gate" or "print"),
    also ``check_k1_rounds``. Returns K2's X."""
    import torch

    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2

    R = pack.n_sys_rows
    A, b = k1.normal_eq(Y, pack, implicit, alpha, compute_dtype)
    A2, b2 = k1.normal_eq_plain(Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, R,
                                implicit, alpha, compute_dtype)
    name = "normal_eq_bf16" if compute_dtype == BF16 else "normal_eq"
    ea, eb = check_k1(A, b, A2, b2, pack, label, errs, implicit, alpha, name)
    if rounds is not None and compute_dtype == BF16:
        check_k1_rounds(Y, pack, A2, b2, implicit, alpha, label, rounds == "gate")

    s1 = torch.zeros(2, dtype=torch.float32, device=Y.device)
    X1 = k2.spd_solve(A, b, lam, has_obs, X_prev, s1, G)
    X2, s2 = k2.spd_solve_plain(A, b, lam, has_obs, X_prev, G)
    ex = (X1 - X2).abs().amax(dim=1)
    if not bool((ex <= 1e-6 + K2_RTOL * X2.abs().amax(dim=1)).all()):
        raise AssertionError(f"K2 {label}: differs from its twin (max |dx| {ex.max().item()})")
    # Σ X² bounds both sums' rounding (the delta sum can be ~0)
    if not torch.allclose(s1, s2, rtol=K2_RTOL, atol=K2_RTOL * s2[1].item()):
        raise AssertionError(f"K2 {label}: telemetry sums {s1.tolist()} vs {s2.tolist()}")
    errs["spd_solve"] = max(errs.get("spd_solve", 0.0), ex.max().item())
    print(f"  {label}: K1 max |dA| {ea:.3g} |db| {eb:.3g}, "
          f"K2 max |dx| {ex.max().item():.3g} ok", flush=True)
    return X1


MMA_RANKS = (17, 20, 24, 31, 32)  # K1's warp-MMA form (17 <= k <= 32), both modes


def check_k1_sizes(rng, device, errs):
    """K1 on random packs at edge ranks (its three forms: k <= 16, the
    warp-MMA form at 17 <= k <= 32 and the block form above), with a row of
    many segments and an empty row, against its twin; at MMA_RANKS in
    implicit mode too, and against a second launch, bit for bit. (b's bits
    against the CUDA-core form the MMA form replaced: compare_wrappers.py,
    which builds the parent checkout.)"""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import normal_eq as k1

    for k in (1, 7, 8, 16, 17, 20, 24, 31, 32, 33, 70):
        n_rows, n_cols, nnz = 300, 200, 60_000
        u = rng.integers(0, n_rows, nnz).astype(np.int32)
        u[: nnz // 3] = 2  # many segments: partials and a combine
        u[u == 5] = 6  # an empty row
        i = rng.integers(0, n_cols, nnz).astype(np.int32)
        r = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
        side = als.pack_segments(u, i, r, n_rows, 64, 1, 65_536)
        R, n_y = als._padded_rows(n_rows, 1), als._padded_rows(n_cols, 1)
        pack = als.device_pack(side, R, n_y, device)
        Y = torch.from_numpy(rng.normal(size=(n_y, k)).astype(np.float32)).to(device)
        for implicit in (False, True) if k in MMA_RANKS else (False,):
            label = f"k={k}{' implicit' if implicit else ''}"
            A, b = k1.normal_eq(Y, pack, implicit, ALPHA)
            A2, b2 = k1.normal_eq_plain(Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, R,
                                        implicit, ALPHA)
            ea, eb = check_k1(A, b, A2, b2, pack, label, errs, implicit, ALPHA)
            if A[5].any() or b[5].any():
                raise AssertionError(f"K1 {label}: an empty row is not zero")
            again = ""
            if k in MMA_RANKS:
                A_again, b_again = k1.normal_eq(Y, pack, implicit, ALPHA)
                if not (bits_equal(A, A_again) and bits_equal(b, b_again)):
                    raise AssertionError(f"K1 {label}: a second launch differs")
                again = ", a second launch bit for bit"
            print(f"  K1 {label}: {pack.plan.n_partials} partials, max |dA| {ea:.3g} "
                  f"|db| {eb:.3g}{again} ok", flush=True)


def check_k2_sizes(rng, device, errs):
    """K2 on random SPD batches at edge ranks, against its twin and float64."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import spd_solve as k2

    for k in (1, 7, 32, 33, 64):
        R = 4096
        M = rng.standard_normal((R, k, k)).astype(np.float32)
        A = np.einsum("rij,rkj->rik", M, M)
        b = rng.standard_normal((R, k)).astype(np.float32)
        lam = rng.uniform(0.5, 2.5, R).astype(np.float32)
        obs = rng.random(R) < 0.9
        Xp = rng.standard_normal((R, k)).astype(np.float32)
        t = [torch.from_numpy(a).to(device) for a in (A, b, lam, obs, Xp)]
        X1 = k2.spd_solve(*t)
        X2, _ = k2.spd_solve_plain(*t)
        x1 = X1.cpu().numpy()
        exact = np.linalg.solve(
            A.astype(np.float64) + lam[:, None, None] * np.eye(k), b[..., None].astype(np.float64)
        )[..., 0]
        exact = np.where(obs[:, None], exact, Xp)
        ex = (X1 - X2).abs().amax(dim=1)
        if not bool((ex <= 1e-6 + K2_RTOL * X2.abs().amax(dim=1)).all()):
            raise AssertionError(f"K2 k={k}: differs from its twin ({ex.max().item()})")
        np.testing.assert_allclose(x1, exact, rtol=2e-3, atol=2e-4)
        errs["spd_solve"] = max(errs.get("spd_solve", 0.0), ex.max().item())
        print(f"  K2 k={k}: max |dx| twin {ex.max().item():.3g}, "
              f"float64 {np.abs(x1 - exact).max():.3g} ok", flush=True)


def check_k13(Y, pack, lam, has_obs, X_prev, implicit, label, errs, alpha=1.0,
              compute_dtype="float32"):
    """K13a and K13b (``ops/grid.py``) on one half-step of V variants:
    variant v bit for bit against K1 and K2 run on variant v alone (the
    same kernels and order, so no tolerance), and against the twins at K1's
    and K2's tolerances. In implicit mode each variant's G is its K12a
    Gramian. In bfloat16 compute K13a-bf16 against K1-bf16 and the twins'
    bfloat16 forms. Returns K13b's X."""
    import torch

    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import grid as k13
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2

    V = Y.shape[0]
    G = torch.stack([k12.gramian(Y_v) for Y_v in Y]) if implicit else None
    A, b = k13.normal_eq_variants(Y, pack, implicit, alpha, compute_dtype)
    A2, b2 = k13.normal_eq_variants_plain(Y, pack, implicit, alpha, compute_dtype)
    X = k13.spd_solve_variants(A, b, lam, has_obs, X_prev, G)
    X2 = k13.spd_solve_variants_plain(A, b, lam, has_obs, X_prev, G)
    ea = ex = 0.0
    for v in range(V):
        A1, b1 = k1.normal_eq(Y[v], pack, implicit, alpha, compute_dtype)
        if not (torch.equal(A[v], A1) and torch.equal(b[v], b1)):
            raise AssertionError(f"K13a {label}: variant {v} is not bit-equal to K1 on it")
        X1 = k2.spd_solve(A[v], b[v], lam[v], has_obs, X_prev[v], None,
                          None if G is None else G[v])
        if not torch.equal(X[v], X1):
            raise AssertionError(f"K13b {label}: variant {v} is not bit-equal to K2 on it")
        sub = {}
        ea = max(ea, *check_k1(A[v], b[v], A2[v], b2[v], pack, f"K13a {label} v={v}", sub,
                               implicit, alpha))
        e = (X[v] - X2[v]).abs().amax(dim=1)
        if not bool((e <= 1e-6 + K2_RTOL * X2[v].abs().amax(dim=1)).all()):
            raise AssertionError(f"K13b {label}: variant {v} differs from its twin ({e.max().item()})")
        ex = max(ex, e.max().item())
    name = "normal_eq_variants_bf16" if compute_dtype == BF16 else "normal_eq_variants"
    errs[name] = max(errs.get(name, 0.0), ea)
    errs["spd_solve_variants"] = max(errs.get("spd_solve_variants", 0.0), ex)
    print(f"  {label}: V={V} K13a = K1 and K13b = K2 per variant ({compute_dtype}), bit for bit; against "
          f"the twins max |dA|,|db| {ea:.3g}, |dx| {ex:.3g} ok", flush=True)
    return X


def check_k13_sizes(rng, device, errs):
    """K13a and K13b on random packs (a row of many segments, an empty row,
    dislikes in implicit mode) at k in {1, 8, 16, 24, 32, 33} (K1's three
    forms), V in {1, 2, 3, 4, 5} (at k = 16 with V = 4 and at k = 8 with
    V = 5 a group's variants take two warps), explicit and implicit, through
    ``check_k13``."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als

    n_rows, n_cols, nnz = 300, 200, 60_000
    u = rng.integers(0, n_rows, nnz).astype(np.int32)
    u[: nnz // 3] = 2
    u[u == 5] = 6
    i = rng.integers(0, n_cols, nnz).astype(np.int32)
    r = (rng.integers(-2, 11, nnz) / 2).astype(np.float32)
    side = als.pack_segments(u, i, r, n_rows, 64, 1, 65_536)
    R, n_y = als._padded_rows(n_rows, 1), als._padded_rows(n_cols, 1)
    pack = als.device_pack(side, R, n_y, device)
    has_obs = torch.from_numpy(np.r_[side.counts, np.zeros(R - n_rows, np.int32)] > 0).to(device)
    for k, V, implicit in ((1, 2, False), (8, 1, False), (8, 2, True), (16, 3, False),
                           (16, 2, True), (16, 4, True), (8, 5, False), (24, 2, False),
                           (24, 3, False), (24, 3, True), (32, 2, False), (32, 2, True),
                           (33, 2, False), (33, 3, True)):
        Y = torch.from_numpy(rng.normal(size=(V, n_y, k)).astype(np.float32) * 0.3).to(device)
        X_prev = torch.from_numpy(rng.normal(size=(V, R, k)).astype(np.float32)).to(device)
        lam = torch.from_numpy(rng.uniform(0.5, 2.5, (V, R)).astype(np.float32)).to(device)
        check_k13(Y, pack, lam, has_obs, X_prev, implicit,
                  f"k={k} {'implicit' if implicit else 'explicit'}", errs, alpha=0.7)


STREAM_BATCH = 1_000_000  # events per batch of the columnar stream
SHIP_CHUNKS = 2  # the streaming trainer's upload chunks: K4 launches


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (float32 compared as its int32 bits)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def wire_bounds(wire):
    """(bound_ms, bound_by) of K4, K5a and K5b on one wire: each input
    read once and each output written once (they do no arithmetic to
    speak of)."""
    n = len(wire.iw)
    v_bytes = n * (4 if wire.vw.dtype == "float32" else 1)  # the unpacked plane
    aux_u = wire.aux["su"].nbytes + wire.aux["bu"].nbytes
    aux_i = wire.aux["si"].nbytes + wire.aux["bi"].nbytes
    return {
        "unpack_nibbles": roofline(3 * wire.vw.nbytes, 0),
        "device_pack_presorted": roofline(
            wire.iw.nbytes + v_bytes + aux_u + 4 * n + 8 * wire.geo_u.total * wire.L_u, 0),
        "device_scatter_pack": roofline(
            wire.iw.nbytes + 4 * n + v_bytes + aux_i + 8 * wire.geo_i.total * wire.L_i, 0),
    }


def check_wire_kernels(wire, device, label, ship_chunks=1):
    """K4 (through the chunked upload), K5a and K5b against their twins on
    the card on one wire, every output bit for bit (the padding segments
    the wire's sentinel tail lands in included). Returns the uploaded wire
    and the user keys."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import device_pack as k5

    i_dev, v_dev, aux = als.upload_wire(wire, device, n_chunks=ship_chunks)
    if wire.nibble:
        ref = k5.unpack_nibbles_plain(torch.from_numpy(wire.vw).to(device))
        if not bits_equal(v_dev, ref):
            raise AssertionError(f"K4 {label}: differs from its twin")
        if not np.array_equal(v_dev.cpu().numpy(), als._unpack_nibbles_host(wire.vw)):
            raise AssertionError(f"K4 {label}: differs from the host unpack")
    args_u = (aux["su"], aux["bu"], wire.geo_u.total, wire.L_u, wire.v_scale)
    args_i = (aux["si"], aux["bi"], wire.geo_i.total, wire.L_i, wire.v_scale)
    keys, pcu, pvu = k5.device_pack_presorted(i_dev, v_dev, *args_u)
    keys2, pcu2, pvu2 = k5.device_pack_presorted_plain(i_dev, v_dev, *args_u)
    pci, pvi = k5.device_scatter_pack(i_dev, keys, v_dev, *args_i, key_bound=wire.n_items + 1)
    pci2, pvi2 = k5.device_scatter_pack_plain(i_dev, keys2, v_dev, *args_i)
    torch.cuda.synchronize()
    for name, got, ref in (
        ("K5a keys", keys, keys2), ("K5a cols", pcu, pcu2), ("K5a vals", pvu, pvu2),
        ("K5b cols", pci, pci2), ("K5b vals", pvi, pvi2),
    ):
        if not bits_equal(got, ref):
            raise AssertionError(f"{name} {label}: differs from its twin")
    tail = len(wire.iw) - int(wire.counts_u.sum())
    print(f"  {label}: n={len(wire.iw)} (tail {tail}), ids {wire.iw.dtype}, values "
          f"{'nibbles' if wire.nibble else wire.vw.dtype}, {len(wire.aux['su'])} user offsets "
          f"for {wire.n_users + 1}, {k5.radix_passes(wire.n_items + 1)} sort passes, "
          f"{ship_chunks} upload chunks: K4/K5a/K5b bit-equal to their twins", flush=True)
    return (i_dev, v_dev, aux), keys


def check_wire_tiers(rng, device):
    """K4, K5a and K5b on small wires that reach the tiers the ML-20M wire
    does not: int32 ids, float32 values, int8 values with a negative
    rating, offsets lengthened by aux_pad, an empty COO; uploaded in three
    chunks, so K4 writes at offsets that are not 16-byte aligned."""
    import numpy as np

    from predictionio_tpu_torch.ops import als

    cfg = als.ALSConfig(rank=RANK, segment_length=16, chunk_slots=65_536)

    def half_steps(nnz):
        return (rng.integers(1, 11, nnz) / 2).astype(np.float32)

    cases = [
        ("int32 ids", 800, 70_000, 60_000, half_steps),
        ("float32 values", 1000, 300, 40_000,
         lambda nnz: rng.uniform(0.0, 5.0, nnz).astype(np.float32)),
        ("int8 with a negative rating", 1000, 300, 40_000,
         lambda nnz: np.concatenate([[-1.0], half_steps(nnz - 1)]).astype(np.float32)),
        ("aux_pad lengthens the offsets", 1000, 1000, 30_000, half_steps),
        ("n = 0", 5, 3, 0, half_steps),
    ]
    for label, n_users, n_items, nnz, values in cases:
        u = rng.integers(0, n_users, nnz).astype(np.int32)
        i = rng.integers(0, n_items, nnz).astype(np.int32)
        if nnz:
            i[0] = n_items - 1
        wire = als.build_host_wire(u, i, values(nnz), n_users, n_items, cfg)
        check_wire_kernels(wire, device, label, ship_chunks=3)
    return wire


def check_radix_sort(rng, device):
    """K5b's stable sort alone at 2, 3 and 4 passes: with one CSR row (S = 1)
    and L = 1 the cols plane holds the cols in sorted order, here the
    permutation, held against the twin and numpy's stable argsort."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import device_pack as k5

    n = 1_000_003  # a ragged last tile
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    dup = rng.integers(0, 50, n)  # long runs of equal keys: stability shows
    cases = (
        ("uint16 keys", np.uint16, None, rng.integers(0, 1 << 16, n)),
        ("int32 keys below 2^17", np.int32, 1 << 17, np.where(dup < 25, dup, rng.integers(0, 1 << 17, n))),
        ("int32 keys below 2^31", np.int32, None, np.where(dup < 25, dup << 24, rng.integers(0, 2**31 - 1, n))),
    )
    for label, dt, key_bound, keys in cases:
        keys = keys.astype(dt)
        kd = torch.from_numpy(keys).to(device)
        cols = torch.arange(n, dtype=torch.int32, device=device)
        vals = torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)).to(device)
        got = k5.device_scatter_pack(kd, cols, vals, zero, zero, n, 1, 0.5, key_bound=key_bound)
        ref = k5.device_scatter_pack_plain(kd, cols, vals, zero, zero, n, 1, 0.5)
        if not (bits_equal(got[0], ref[0]) and bits_equal(got[1], ref[1])):
            raise AssertionError(f"K5b sort, {label}: differs from its twin")
        if not np.array_equal(got[0].cpu().numpy(), np.argsort(keys.astype(np.int64), kind="stable")):
            raise AssertionError(f"K5b sort, {label}: not numpy's stable order")
        print(f"  K5b sort, {label}: {k5.radix_passes(key_bound or (1 << 16 if dt == np.uint16 else 2**31))} "
              f"passes, n={n}: stable, equal to its twin", flush=True)


def ml20m_stream(u, i, r, names, n_users):
    """The ratings as a ColumnarStream of STREAM_BATCH-event batches, in
    one code space: code c < n_users is user "u<c>", the rest item
    "i<c - n_users>" (``names``)."""
    import numpy as np

    from predictionio_tpu_torch.data.storage.columnar import ColumnarStream

    t = (i + np.int32(n_users)).astype(np.int32)
    batches = [
        (u[s:s + STREAM_BATCH], t[s:s + STREAM_BATCH], r[s:s + STREAM_BATCH])
        for s in range(0, len(r), STREAM_BATCH)
    ]
    return ColumnarStream(iter(batches), lambda: names)


def train_phase(rng, device):
    """Check K4, K5a and K5b on the ML-20M wire and small ones, train the
    ML-20M-shaped model through the main path (``ALSAlgorithm.train`` on a
    streaming scan), hold it against the direct route, check K1, K2 and K7
    on it, and time every kernel. Returns (trained ALSModel, kernel rows,
    training stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Preparator,
        StreamingTrainingData,
    )
    from predictionio_tpu_torch.ops import als, streaming
    from predictionio_tpu_torch.ops import device_pack as k5
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import predict_pairs as k7
    from predictionio_tpu_torch.ops import spd_solve as k2
    from predictionio_tpu_torch.ops import topn as k3

    t0 = time.perf_counter()
    n_users, n_items, k = ML20M_USERS, ML20M_ITEMS, RANK
    u, i, r = ml20m_ratings()
    print(f"  ratings: {len(r)} in {time.perf_counter() - t0:.2f} s", flush=True)
    params = ALSAlgorithmParams(rank=k, num_iterations=SWEEPS, lambda_=REG)
    config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, seed=params.seed)

    # a. K4, K5a and K5b against their twins: the ML-20M wire, uploaded as
    # the streaming trainer uploads it, small wires of the other tiers, and
    # the sort alone at every pass count
    errs = {}
    t = time.perf_counter()
    wire0 = als.build_host_wire(u, i, r, n_users, n_items, config)
    build_wire_s = time.perf_counter() - t
    (i_dev, v_dev, aux), u_keys = check_wire_kernels(wire0, device, "ML-20M wire", SHIP_CHUNKS)
    check_wire_tiers(rng, device)
    check_radix_sort(rng, device)
    for name in ("unpack_nibbles", "device_pack_presorted", "device_scatter_pack"):
        errs[name] = 0.0  # every check above is bit for bit

    # K1 and K2 against their twins on the real sides, packed on the card
    up, ip = als.device_pack_from_wire(wire0, device)
    R_u, R_i = up.n_sys_rows, ip.n_sys_rows
    state = als.init_factor_state_single(
        wire0.counts_u, wire0.counts_i, n_users, n_items, config, device=device)
    X0, Y0, lam_u, lam_i, obs_u, obs_i = state
    print(f"  packed on the card: users L={wire0.L_u} grid {tuple(up.cols.shape)} groups "
          f"{up.plan.groups.shape[1]} partials {up.plan.n_partials}; items L={wire0.L_i} "
          f"grid {tuple(ip.cols.shape)} groups {ip.plan.groups.shape[1]} partials "
          f"{ip.plan.n_partials}; heaviest item {int(wire0.counts_i.max())} ratings; "
          f"wire {wire0.wire_mb} MB", flush=True)
    check_half_step(X0, Y0, up, lam_u, obs_u, "user side, first half-step", errs)
    X3, Y3, _ = als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, 3)
    check_half_step(X3, Y3, up, lam_u, obs_u, "user side of sweep 4", errs)
    X4 = als._solve_side(X3, Y3, up, lam_u, obs_u)
    check_half_step(Y3, X4, ip, lam_i, obs_i, "item side of sweep 4", errs)
    check_k1_sizes(rng, device, errs)
    check_k2_sizes(rng, device, errs)

    # b. the main path, counted: ALSAlgorithm.train on a streaming scan of
    # the ratings with string ids, then RMSE through K7
    names = np.array([f"u{n}" for n in range(n_users)] + [f"i{n}" for n in range(n_items)], dtype=object)

    def stream_factory():
        return ml20m_stream(u, i, r, names, n_users)

    def loader():
        raise AssertionError("the streaming path materialized the training data")

    alg = ALSAlgorithm(params)
    pd = Preparator().prepare(device, StreamingTrainingData(stream_factory, loader))
    counters = (k1.LAUNCHES, k2.LAUNCHES, k5.LAUNCHES, k7.LAUNCHES, k3.LAUNCHES, k12.LAUNCHES)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    model = alg.train(device, pd)
    train_s = time.perf_counter() - t
    # the streaming model's dense ids: sorted-name order
    remap_u = np.array([model.user_index.get(f"u{n}", -1) for n in range(n_users)], np.int32)
    remap_i = np.array([model.item_index.get(f"i{n}", -1) for n in range(n_items)], np.int32)
    u_rel, i_rel = remap_u[u], remap_i[i]
    n_u, n_i = len(model.user_index), len(model.item_index)
    t = time.perf_counter()
    rmse = als.rmse(model.arrays, u_rel, i_rel, r, device=device)
    rmse_s = time.perf_counter() - t
    counts = {}
    for c in counters:
        counts.update(c.snapshot())
    n_chunks = -(-len(r) // PAIR_CHUNK)
    want = {
        "unpack_nibbles": SHIP_CHUNKS, "device_pack_presorted": 1, "device_scatter_pack": 1,
        "normal_eq": 2 * SWEEPS, "spd_solve": 2 * SWEEPS, "predict_pairs": n_chunks,
        "gramian": 0, "implicit_objective": 0,
    }
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times on the main path, not {n}")
    if any(v for name, v in counts.items() if name.endswith("_plain")):
        raise AssertionError(f"a plain twin ran on the main path: {counts}")
    if not (np.isfinite(model.arrays.user_factors).all() and np.isfinite(model.arrays.item_factors).all()):
        raise AssertionError("trained factors are not finite")
    if model.arrays.user_factors.shape != (n_u, k) or model.arrays.item_factors.shape != (n_i, k):
        raise AssertionError("trained factors have the wrong shape")
    if (remap_u[np.unique(u)] < 0).any() or (remap_i[np.unique(i)] < 0).any():
        raise AssertionError("a rated user or item is missing from the streaming model's index")
    if not (0.0 < rmse < 1.5):
        raise AssertionError(f"training RMSE {rmse} out of range")
    print(f"  ALSAlgorithm.train (streaming): {train_s:.2f} s, {n_u} users x {n_i} items, "
          f"RMSE {rmse:.6f}, launches {counts}", flush=True)

    # the streaming wire against build_host_wire over the relabelled COO
    t_scan = {}
    wait = None
    try:
        s_wire, _, _, wait, _ = streaming._scan_and_pack(stream_factory(), config, t_scan, device)
    finally:
        if wait is not None:
            wait()
    t = time.perf_counter()
    d_wire = als.build_host_wire(u_rel, i_rel, r, n_u, n_i, config)
    build_rel_s = time.perf_counter() - t
    same = (
        s_wire.iw.dtype == d_wire.iw.dtype and s_wire.iw.tobytes() == d_wire.iw.tobytes()
        and s_wire.vw.dtype == d_wire.vw.dtype and s_wire.vw.tobytes() == d_wire.vw.tobytes()
        and (s_wire.nibble, s_wire.v_scale, s_wire.L_u, s_wire.L_i) == (d_wire.nibble, d_wire.v_scale, d_wire.L_u, d_wire.L_i)
        and all(s_wire.aux[a].tobytes() == d_wire.aux[a].tobytes() for a in ("su", "bu", "si", "bi"))
        and np.array_equal(s_wire.counts_u, d_wire.counts_u) and np.array_equal(s_wire.counts_i, d_wire.counts_i)
    )
    if not same:
        raise AssertionError("the streaming wire differs from build_host_wire over the relabelled COO")
    print(f"  streaming wire == build_host_wire(relabelled COO), byte for byte ({d_wire.wire_mb} MB)", flush=True)

    def same_factors(a, b):
        return all(
            np.array_equal(x.view(np.uint32), y.view(np.uint32))
            for x, y in ((a.user_factors, b.user_factors), (a.item_factors, b.item_factors))
        )

    # c. the streaming trainer again with its timings, and the direct
    # route on the relabelled COO: the factors bit-identical to (b)'s
    t_stream = {}
    again = streaming.train_als_streaming(stream_factory(), config, device=device, timings=t_stream)
    if not same_factors(again.arrays, model.arrays):
        raise AssertionError("two streaming trainings from one seed differ")
    timings = {}
    direct = als.train_als(u_rel, i_rel, r, n_u, n_i, config, device=device, timings=timings)
    if not same_factors(direct, model.arrays):
        raise AssertionError("the direct route's factors differ from the streaming route's")
    print("  second streaming training and the direct route: bit-identical factors", flush=True)
    # the host-pack route (the reference's mesh-branch packer, kept in the
    # port for the multi-GPU route), timed beside the wire route on the
    # same COO; over the real segments its user planes equal K5a's
    t = time.perf_counter()
    hs_u = als.pack_segments(u_rel, i_rel, r, n_u, d_wire.L_u, 1, config.chunk_slots)
    hs_i = als.pack_segments(i_rel, u_rel, r, n_i, d_wire.L_i, 1, config.chunk_slots)
    host_pack_s = time.perf_counter() - t
    t = time.perf_counter()
    R_u2, R_i2 = als._padded_rows(n_u, 1), als._padded_rows(n_i, 1)
    hp_u = als.device_pack(hs_u, R_u2, R_i2, device)
    als.device_pack(hs_i, R_i2, R_u2, device)
    torch.cuda.synchronize()
    host_put_s = time.perf_counter() - t
    wp_u, _ = als.device_pack_from_wire(d_wire, device)
    m = d_wire.geo_u.n_segs * d_wire.L_u
    if not (bits_equal(hp_u.cols.reshape(-1)[:m], wp_u.cols.reshape(-1)[:m])
            and bits_equal(hp_u.vals.reshape(-1)[:m], wp_u.vals.reshape(-1)[:m])):
        raise AssertionError("K5a's user planes differ from pack_segments' over the real segments")
    host_pack_route = {"pack_s": host_pack_s, "device_put_s": host_put_s}
    print(f"  host-pack route on the same COO: pack {host_pack_s:.2f} s, upload {host_put_s:.3f} s; "
          f"its user planes equal K5a's over the {d_wire.geo_u.n_segs} real segments", flush=True)
    del hs_u, hs_i, hp_u, wp_u
    stream_keys = ("scan_s", "fold_s", "pack_s", "pack_exposed_s", "device_put_exposed_s", "wire_mb",
                   "compile_s", "compile_exposed_s", "device_pack_dispatch_s", "device_loop_s",
                   "stream_wall_s", "pack_cache")
    print("streaming_timings " + json.dumps({key: t_stream[key] for key in stream_keys}), flush=True)

    # d. the same sweeps with the twins, driven by this script, against the
    # kernels' loop on the same packs
    Xk, Yk, tel_k = als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, SWEEPS)
    rows = als._telemetry_rows(tel_k, SWEEPS, Xk.numel(), Yk.numel())[:, :4].astype(np.float64)
    X, Y = X0, Y0
    tel = np.zeros((SWEEPS, 4), np.float64)
    t = time.perf_counter()
    for it in range(SWEEPS):
        A, b = k1.normal_eq_plain(Y, up.seg_rows, up.cols, up.vals, up.rem, R_u)
        X, sx = k2.spd_solve_plain(A, b, lam_u, obs_u, X)
        A, b = k1.normal_eq_plain(X, ip.seg_rows, ip.cols, ip.vals, ip.rem, R_i)
        Y, sy = k2.spd_solve_plain(A, b, lam_i, obs_i, Y)
        sx, sy = sx.cpu().numpy(), sy.cpu().numpy()
        tel[it] = [np.sqrt(sx[0] / X.numel()), np.sqrt(sy[0] / Y.numel()),
                   np.sqrt(sx[1] / X.numel()), np.sqrt(sy[1] / Y.numel())]
    twin_loop_s = time.perf_counter() - t
    Xt, Yt = X[:n_users].cpu().numpy(), Y[:n_items].cpu().numpy()
    dX = np.abs(Xt - Xk[:n_users].cpu().numpy()).max()
    dY = np.abs(Yt - Yk[:n_items].cpu().numpy()).max()
    if dX > TRAIN_RTOL * np.abs(Xt).max() or dY > TRAIN_RTOL * np.abs(Yt).max():
        raise AssertionError(f"twin training differs: max |dX| {dX}, |dY| {dY}")
    np.testing.assert_allclose(rows, tel, rtol=TRAIN_RTOL)
    print(f"  twin-driven training ({twin_loop_s:.2f} s): max |dX| {dX:.3g}, |dY| {dY:.3g}, "
          f"telemetry max rel diff {np.abs(rows / tel - 1).max():.3g} ok", flush=True)

    # e. K7 on every training pair
    Xd = torch.from_numpy(model.arrays.user_factors).to(device)
    Yd = torch.from_numpy(model.arrays.item_factors).to(device)
    ud = torch.from_numpy(u_rel).to(device)
    idd = torch.from_numpy(i_rel).to(device)
    k7_err = 0.0
    for s in range(0, len(u), PAIR_CHUNK):
        uc, ic = ud[s:s + PAIR_CHUNK], idd[s:s + PAIR_CHUNK]
        got = k7.predict_pairs(Xd, Yd, uc, ic)
        ref = k7.predict_pairs_plain(Xd, Yd, uc, ic)
        scale = k7.predict_pairs_plain(Xd.abs(), Yd.abs(), uc, ic)
        e = (got - ref).abs()
        if not bool((e <= 1e-6 + K7_RTOL * scale).all()):
            raise AssertionError(f"K7 differs from its twin at chunk {s // PAIR_CHUNK}")
        k7_err = max(k7_err, e.max().item())
    errs["predict_pairs"] = k7_err
    print(f"  K7 on {len(u)} pairs: max |d| {k7_err:.3g} ok", flush=True)

    # f. times at the main path's shapes: K4, K5a and K5b on the ML-20M
    # wire, K1 and K2 per side, K2 with its telemetry sums, K7 per chunk
    raw_v = torch.from_numpy(wire0.vw).to(device)
    args_u = (aux["su"], aux["bu"], wire0.geo_u.total, wire0.L_u, wire0.v_scale)
    args_i = (aux["si"], aux["bi"], wire0.geo_i.total, wire0.L_i, wire0.v_scale)
    A_u, b_u = k1.normal_eq(Y3, up)
    A_i, b_i = k1.normal_eq(X3, ip)
    A_reg = A_u + lam_u[:, None, None] * torch.eye(k, device=device)
    sums = torch.zeros(2, dtype=torch.float32, device=device)
    uc, ic = ud[:PAIR_CHUNK], idd[:PAIR_CHUNK]
    calls = {
        "unpack_nibbles": {"wire": lambda: k5.unpack_nibbles(raw_v)},
        "device_pack_presorted": {"user": lambda: k5.device_pack_presorted(i_dev, v_dev, *args_u)},
        "device_scatter_pack": {
            "item": lambda: k5.device_scatter_pack(i_dev, u_keys, v_dev, *args_i, key_bound=n_items + 1),
        },
        "normal_eq": {"user": lambda: k1.normal_eq(Y3, up), "item": lambda: k1.normal_eq(X3, ip)},
        "spd_solve": {
            "user": lambda: k2.spd_solve(A_u, b_u, lam_u, obs_u, X3, sums),
            "item": lambda: k2.spd_solve(A_i, b_i, lam_i, obs_i, Y3, sums),
        },
    }
    t_k = {n: {side: time_ms(f, iters=20, warmup=2) for side, f in c.items()} for n, c in calls.items()}
    dev = {n: {side: device_ms(f, calls=10) for side, f in c.items()} for n, c in calls.items()}
    t_k4_plain = time_ms(lambda: k5.unpack_nibbles_plain(raw_v), iters=10, warmup=2)
    t_k5a_plain = time_ms(lambda: k5.device_pack_presorted_plain(i_dev, v_dev, *args_u), iters=5, warmup=1)
    t_k5b_plain = time_ms(lambda: k5.device_scatter_pack_plain(i_dev, u_keys, v_dev, *args_i), iters=5, warmup=1)
    keys_i32 = i_dev.to(torch.int32)
    t_sort_only = time_ms(lambda: torch.sort(keys_i32, stable=True), iters=10, warmup=2)
    t_k1_plain = time_ms(lambda: k1.normal_eq_plain(Y3, up.seg_rows, up.cols, up.vals, up.rem, R_u), iters=3, warmup=1)
    t_k2_plain = time_ms(lambda: k2.spd_solve_plain(A_u, b_u, lam_u, obs_u, X3), iters=3, warmup=1)
    t_k2_lib = time_ms(lambda: torch.cholesky_solve(b_u[..., None], torch.linalg.cholesky(A_reg)), iters=5, warmup=1)
    # as predict_ratings calls it: the ids checked once on the host
    def k7_call():
        return k7.predict_pairs(Xd, Yd, uc, ic, check_ids=False)

    t_k["predict_pairs"] = time_ms(k7_call, iters=50, warmup=5)
    dev["predict_pairs"] = device_ms(k7_call, calls=50)
    t_k7_plain = time_ms(lambda: k7.predict_pairs_plain(Xd, Yd, uc, ic), iters=50, warmup=5)
    wb = wire_bounds(wire0)
    bounds = {
        "unpack_nibbles": {"wire": wb["unpack_nibbles"]},
        "device_pack_presorted": {"user": wb["device_pack_presorted"]},
        "device_scatter_pack": {"item": wb["device_scatter_pack"]},
        "normal_eq": {"user": k1_bound(up, len(r), R_i, k), "item": k1_bound(ip, len(r), R_u, k)},
        "spd_solve": {
            "user": k2_bound(R_u, int(obs_u.sum()), k),
            "item": k2_bound(R_i, int(obs_i.sum()), k),
        },
        "predict_pairs": k7_bound(PAIR_CHUNK, n_u, n_i, k),
    }

    # the loop's device busy share: its time on the card alone over its
    # wall time when the host launches it onto an idle card, as training does
    def loop():
        return als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, SWEEPS)

    loop()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    loop_wall_ms = (time.perf_counter() - t) * 1e3
    loop_device_ms = device_ms(loop, calls=1)
    stats = {
        "card": card_line(),
        "build_host_wire_s": build_wire_s, "build_host_wire_relabelled_s": build_rel_s,
        "direct": {key: timings[key] for key in (
            "pack_s", "device_put_s", "wire_mb", "device_pack_dispatch_s", "compile_s",
            "device_loop_s", "padded_slots")},
        "streaming": {key: t_stream[key] for key in stream_keys},
        "host_pack_route": host_pack_route,
        "ms_per_sweep": timings["device_loop_s"] * 1e3 / SWEEPS,
        "train_s": train_s,
        "rmse": rmse, "rmse_s": rmse_s, "telemetry": timings["sweep_telemetry"],
        "launches": counts,
        "loop_wall_ms": loop_wall_ms,
        "loop_device_ms": loop_device_ms,
        "device_busy_share": loop_device_ms / loop_wall_ms,
        "kernel_ms": t_k,
        "plain_ms": {
            "unpack_nibbles": t_k4_plain, "device_pack_presorted": t_k5a_plain,
            "device_scatter_pack": t_k5b_plain, "normal_eq_user": t_k1_plain,
            "spd_solve_user": t_k2_plain, "predict_pairs_chunk": t_k7_plain,
        },
        "library_ms": {"spd_solve_user": t_k2_lib, "device_scatter_pack_sort_only": t_sort_only},
        "device_ms": dev, "bound": bounds,
        "bound_ms_per_sweep": sum(bounds[n][side][0] for n in ("normal_eq", "spd_solve") for side in ("user", "item")),
        "twin_loop_s": twin_loop_s,
    }
    print("training " + json.dumps(stats), flush=True)

    def row(name, source, replaces, ms, plain_ms, bnd, lib):
        return {
            "name": name, "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": counts[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": lib,
        }

    kernels = [
        row("unpack_nibbles", "device_pack.cu", "predictionio_tpu/ops/als.py:407",
            t_k["unpack_nibbles"]["wire"], t_k4_plain, bounds["unpack_nibbles"]["wire"], None),
        row("device_pack_presorted", "device_pack.cu", "predictionio_tpu/ops/als.py:416",
            t_k["device_pack_presorted"]["user"], t_k5a_plain,
            bounds["device_pack_presorted"]["user"], None),
        row("device_scatter_pack", "device_pack.cu", "predictionio_tpu/ops/als.py:449",
            t_k["device_scatter_pack"]["item"], t_k5b_plain,
            bounds["device_scatter_pack"]["item"], None),
        row("normal_eq", "normal_eq.cu", "predictionio_tpu/ops/als.py:481",
            t_k["normal_eq"]["user"], t_k1_plain, bounds["normal_eq"]["user"], None),
        row("spd_solve", "spd_solve.cu", "predictionio_tpu/ops/als.py:549",
            t_k["spd_solve"]["user"], t_k2_plain, bounds["spd_solve"]["user"], t_k2_lib),
        row("predict_pairs", "predict_pairs.cu", "predictionio_tpu/ops/als.py:2330",
            t_k["predict_pairs"], t_k7_plain, bounds["predict_pairs"], None),
    ]
    return model, kernels, stats


ALPHA = 1.0  # the implicit phases' confidence scale (MLlib's default)
K12_RTOL = 1e-4  # of the Gramian's largest diagonal entry; a sum of up to 147,456 products
OBJ_RTOL = 1e-4  # of the objective's largest term magnitude; sums of up to 20M terms
# K12b-bf16 against its twin, of the same scale: tight enough that a form
# skipping a rounding fails on the random packs (objective_rounds);
# the ML-20M readings on an H100 reached 7e-8 of it (12 of 1.725e8)
BF16_OBJ_RTOL = 1e-6
OBJ_DRAWS = 4  # random factor draws per rank of K12b-bf16's random-pack check
TWIN_SWEEPS = 3  # sweeps of the twin-driven loop the implicit phase runs


def objective_scale(X, Y, pack, lam_u, lam_i, alpha):
    """The magnitudes of the implicit objective's three terms (Σ_obs of
    the terms' absolute values, Σ|XᵀX ∘ YᵀY| and the regularizer), in
    float64 on the card: the scale its float32 sums round at."""
    import torch

    Xd, Yd = X.double(), Y.double()
    L = pack.cols.shape[-1]
    iota = torch.arange(L, device=X.device)
    obs = torch.zeros((), dtype=torch.float64, device=X.device)
    for c in range(pack.seg_rows.shape[0]):
        mask = (iota[None, :] < pack.rem[c][:, None]).double()
        s = torch.einsum("slk,sk->sl", Yd[pack.cols[c].long()], Xd[pack.seg_rows[c].long()])
        v = pack.vals[c].double()
        cw = alpha * v.abs() * mask
        p = (v > 0).double() * mask
        obs += (cw * s * s + 2 * (1 + cw) * p * s.abs() + (1 + cw) * p).sum()
    all_sq = ((Xd.T @ Xd) * (Yd.T @ Yd)).abs().sum()
    reg = (lam_u.double() * (Xd * Xd).sum(-1)).sum() + (lam_i.double() * (Yd * Yd).sum(-1)).sum()
    return max(obs.item(), all_sq.item(), reg.item())


def check_gramian(F, label, errs):
    """K12a against its twin on one factor array, within K12_RTOL of the
    twin's largest diagonal entry (it bounds every Σ|f_i f_j|)."""
    from predictionio_tpu_torch.ops import gramian as k12

    G, G2 = k12.gramian(F), k12.gramian_plain(F)
    e = (G - G2).abs().max().item()
    if not e <= 1e-6 + K12_RTOL * G2.diagonal().max().item():
        raise AssertionError(f"K12a {label}: differs from its twin (max |dG| {e})")
    if not bool((G == G.T).all()):
        raise AssertionError(f"K12a {label}: not symmetric")
    errs["gramian"] = max(errs.get("gramian", 0.0), e)
    print(f"  K12a {label} ({F.shape[0]} x {F.shape[1]}): max |dG| {e:.3g} ok", flush=True)
    return G


def observed_term64(X, Y, pack, alpha):
    """The implicit objective's observed term, Σ_obs cw·s² − 2(1+cw)·p·s
    + (1+cw)·p over the user pack, in float64 on the card from the factors
    as given."""
    import torch

    Xd, Yd = X.double(), Y.double()
    L = pack.cols.shape[-1]
    iota = torch.arange(L, device=X.device)
    obs = torch.zeros((), dtype=torch.float64, device=X.device)
    for c in range(pack.seg_rows.shape[0]):
        mask = (iota[None, :] < pack.rem[c][:, None]).double()
        s = torch.einsum("slk,sk->sl", Yd[pack.cols[c].long()], Xd[pack.seg_rows[c].long()])
        v = pack.vals[c].double()
        cw = alpha * v.abs() * mask
        p = (v > 0).double() * mask
        obs += (cw * s * s - 2 * (1 + cw) * p * s + (1 + cw) * p).sum()
    return obs.item()


def objective_rounds(X, Y, pack, lam_u, lam_i, label):
    """How far each form that skips one of K12b-bf16's roundings lies from
    the bfloat16 twin's value on these inputs: the float32 kernel's value,
    and the forms that round only x, only y or neither (the twin's value
    moved by their observed term's float64 difference from the rounded
    one). Returns each form's margin in units of K12b-bf16's limit,
    (distance − 2·noise) / limit, where the noise is one float32
    evaluation's summation error, taken as K12b-bf16's own distance from
    the twin here (at least one float32 step of the value): a kernel that
    computed a form with a margin above 1 would fail the check, whatever
    order it summed in."""
    import numpy as np

    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops.precision import round_bf16

    want = k12.implicit_objective_plain(
        X, Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, lam_u, lam_i, ALPHA,
        compute_dtype=BF16).item()
    got = k12.implicit_objective(X, Y, pack, lam_u, lam_i, ALPHA, compute_dtype=BF16).item()
    noise = max(abs(got - want), float(np.spacing(np.float32(want))))
    limit = BF16_OBJ_RTOL * objective_scale(X, Y, pack, lam_u, lam_i, ALPHA)
    Xr, Yr = round_bf16(X), round_bf16(Y)
    base = observed_term64(Xr, Yr, pack, ALPHA)
    gaps = {"float32 kernel": abs(k12.implicit_objective(X, Y, pack, lam_u, lam_i, ALPHA).item()
                                  - want)}
    for form, Xm, Ym in (("x only", Xr, Y), ("y only", X, Yr), ("neither", X, Y)):
        gaps[f"rounding {form}"] = abs(observed_term64(Xm, Ym, pack, ALPHA) - base)
    print(f"  K12b-bf16 {label}, forms that skip a rounding: "
          f"{', '.join(f'{n} {g:.6g}' for n, g in gaps.items())} from the twin's value "
          f"(limit {limit:.4g}, noise {noise:.4g})", flush=True)
    return {n: (g - 2 * noise) / limit for n, g in gaps.items()}


def gate_objective_rounds(label, margins, forms=None):
    """Fails unless the margin (``objective_rounds``) of every form in
    ``forms`` (default: all) is above 1: the check fails a kernel that
    computes any of them."""
    gated = {n: g for n, g in margins.items() if forms is None or n in forms}
    worst = min(gated.values())
    if not worst > 1.0:
        raise AssertionError(f"K12b-bf16 {label}: a form that skips a rounding stays within "
                             f"{worst:.3g} limits of the twin ({margins}); the check would not "
                             f"fail it")
    print(f"  K12b-bf16 {label}: {'every form' if forms is None else ', '.join(gated)} "
          f"fails the check (margins {', '.join(f'{n} {g:.3g}' for n, g in margins.items())} "
          f"limits) ok", flush=True)


def check_objective(X, Y, pack, lam_u, lam_i, label, errs, compute_dtype="float32", got=None):
    """K12b against its twin at OBJ_RTOL of its largest term's magnitude
    (K12b-bf16 at BF16_OBJ_RTOL), and bit for bit against a second launch
    (and against ``got``, a value the loop's own launch wrote, when given).
    Returns the kernel's value."""
    from predictionio_tpu_torch.ops import gramian as k12

    cdt = compute_dtype
    first = k12.implicit_objective(X, Y, pack, lam_u, lam_i, ALPHA, compute_dtype=cdt).item()
    again = k12.implicit_objective(X, Y, pack, lam_u, lam_i, ALPHA, compute_dtype=cdt).item()
    want = k12.implicit_objective_plain(
        X, Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, lam_u, lam_i, ALPHA,
        compute_dtype=cdt).item()
    scale = objective_scale(X, Y, pack, lam_u, lam_i, ALPHA)
    limit = (BF16_OBJ_RTOL if cdt == BF16 else OBJ_RTOL) * scale
    e = abs(first - want)
    if not e <= limit or first != again or (got is not None and got != first):
        raise AssertionError(f"K12b {label}: {first} (again {again}, the loop's {got}) vs the "
                             f"twin's {want}, limit {limit} (scale {scale})")
    name = "implicit_objective_bf16" if cdt == BF16 else "implicit_objective"
    errs[name] = max(errs.get(name, 0.0), e)
    print(f"  K12b ({cdt}) {label}: {first:.9g} vs twin {want:.9g} (|d| {e:.3g}, limit "
          f"{limit:.4g}, scale {scale:.4g}) ok", flush=True)
    return first


def gramian_bound(n: int, k: int):
    """K12a's (bound_ms, bound_by): the [n, k] array read once and G
    written once vs the k(k+1) operations per row a symmetric G needs."""
    return roofline(4 * (n * k + k * k), n * k * (k + 1))


def objective_bound(pack, n_obs: int, R_u: int, R_i: int, k: int, bf16: bool = False):
    """K12b's (bound_ms, bound_by): each observed slot's id and rating, each
    segment's row and count, both factor arrays and regularizers once vs
    2k + 10 operations per slot and 3 per factor entry. K12b-bf16
    (``bf16``): the same bytes (the regularizer reads the float32 factors),
    the operations at the bf16 tensor-core peak."""
    S = pack.rem.numel()
    nbytes = 8 * n_obs + 8 * S + 4 * (R_u + R_i) * (k + 1)
    return roofline(nbytes, n_obs * (2 * k + 10) + 3 * k * (R_u + R_i),
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def check_implicit_sweeps(up, ip, state, label, errs):
    """K1 (implicit), K2 (+G), K12a and K12b against their twins on one
    training's packs: the first half-steps from ``state`` (the init), then
    sweep TWIN_SWEEPS + 1's after TWIN_SWEEPS kernel-driven sweeps, and the
    objective after it. Returns (X3, Y3, X4, Y4, the loop's telemetry)."""
    from predictionio_tpu_torch.ops import als

    X0, Y0, lam_u, lam_i, obs_u, obs_i = state
    s = TWIN_SWEEPS + 1
    Gy = check_gramian(Y0, f"{label}items, the init", errs)
    X1 = check_half_step(X0, Y0, up, lam_u, obs_u, f"{label}implicit user side, first half-step",
                         errs, True, ALPHA, Gy)
    Gx = check_gramian(X1, f"{label}users, after the first half-step", errs)
    check_half_step(Y0, X1, ip, lam_i, obs_i, f"{label}implicit item side, first half-step", errs,
                    True, ALPHA, Gx)
    X3, Y3, tel3 = als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, TWIN_SWEEPS,
                                       implicit=True, alpha=ALPHA)
    Gy = check_gramian(Y3, f"{label}items of sweep {s}", errs)
    X4 = check_half_step(X3, Y3, up, lam_u, obs_u, f"{label}implicit user side of sweep {s}",
                         errs, True, ALPHA, Gy)
    Gx = check_gramian(X4, f"{label}users of sweep {s}", errs)
    Y4 = check_half_step(Y3, X4, ip, lam_i, obs_i, f"{label}implicit item side of sweep {s}",
                         errs, True, ALPHA, Gx)
    check_objective(X4, Y4, up, lam_u, lam_i, f"{label}sweep {s}", errs)
    return X3, Y3, X4, Y4, tel3


def implicit_train_phase(rng, device):
    """The recommendation template with implicit_prefs=True on the ML-20M
    stream: the main path counted, the telemetry with its objective, the
    streaming and direct routes bit-identical, K1 (implicit), K2 (+G),
    K12a and K12b against their twins at the path's shapes, a twin-driven
    loop, and times. Returns (kernel rows, launches, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Preparator,
        StreamingTrainingData,
    )
    from predictionio_tpu_torch.ops import als, streaming
    from predictionio_tpu_torch.ops import device_pack as k5
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import predict_pairs as k7
    from predictionio_tpu_torch.ops import similarity as k14
    from predictionio_tpu_torch.ops import spd_solve as k2
    from predictionio_tpu_torch.ops import topn as k3

    n_users, n_items, k = ML20M_USERS, ML20M_ITEMS, RANK
    u, i, r = ml20m_ratings()
    params = ALSAlgorithmParams(rank=k, num_iterations=SWEEPS, lambda_=REG, alpha=ALPHA,
                                implicit_prefs=True)
    config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, alpha=ALPHA, implicit_prefs=True,
                           seed=params.seed)
    names = np.array([f"u{n}" for n in range(n_users)] + [f"i{n}" for n in range(n_items)], dtype=object)

    def stream_factory():
        return ml20m_stream(u, i, r, names, n_users)

    def loader():
        raise AssertionError("the streaming path materialized the training data")

    # the main path, counted: ALSAlgorithm.train on the stream
    alg = ALSAlgorithm(params)
    pd = Preparator().prepare(device, StreamingTrainingData(stream_factory, loader))
    counters = (k1.LAUNCHES, k2.LAUNCHES, k5.LAUNCHES, k12.LAUNCHES, k7.LAUNCHES, k3.LAUNCHES,
                k14.LAUNCHES)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    model = alg.train(device, pd)
    train_s = time.perf_counter() - t
    counts = snapshot(counters)
    want = {
        "unpack_nibbles": SHIP_CHUNKS, "device_pack_presorted": 1, "device_scatter_pack": 1,
        "normal_eq": 2 * SWEEPS, "spd_solve": 2 * SWEEPS,
        # one Gramian before each half-step, two inside each sweep's objective
        "gramian": 4 * SWEEPS, "implicit_objective": SWEEPS,
        "predict_pairs": 0, "topn_packed": 0, "cosine_sum": 0,
    }
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times on the implicit path, not {n}")
    if any(v for name, v in counts.items() if name.endswith("_plain")):
        raise AssertionError(f"a plain twin ran on the implicit path: {counts}")
    Xm, Ym = model.arrays.user_factors, model.arrays.item_factors
    n_u, n_i = len(model.user_index), len(model.item_index)
    if Xm.shape != (n_u, k) or Ym.shape != (n_i, k):
        raise AssertionError("implicit factors have the wrong shape")
    if not (np.isfinite(Xm).all() and np.isfinite(Ym).all()):
        raise AssertionError("implicit factors are not finite")
    print(f"  ALSAlgorithm.train (streaming, implicit, alpha {ALPHA}): {train_s:.2f} s, "
          f"{n_u} users x {n_i} items, launches {counts}", flush=True)

    # a second streaming training with its timings (the per-sweep telemetry
    # with the objective), and the direct route: bit-identical factors
    t_stream = {}
    again = streaming.train_als_streaming(stream_factory(), config, device=device, timings=t_stream)
    remap_u = np.array([model.user_index.get(f"u{n}", -1) for n in range(n_users)], np.int32)
    remap_i = np.array([model.item_index.get(f"i{n}", -1) for n in range(n_items)], np.int32)
    u_rel, i_rel = remap_u[u], remap_i[i]
    timings = {}
    direct = als.train_als(u_rel, i_rel, r, n_u, n_i, config, device=device, timings=timings)
    for name, other in (("a second streaming training", again.arrays), ("the direct route", direct)):
        if not all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                   for a, b in ((other.user_factors, Xm), (other.item_factors, Ym))):
            raise AssertionError(f"{name}'s implicit factors differ from the main path's")
    tel = t_stream["sweep_telemetry"]
    if len(tel) != SWEEPS or any(sorted(row) != ["dx", "dy", "objective", "x_rms", "y_rms"] for row in tel):
        raise AssertionError(f"implicit telemetry rows {tel}")
    if tel != timings["sweep_telemetry"] or not np.isfinite([row["objective"] for row in tel]).all():
        raise AssertionError("the routes' telemetry differs or an objective is not finite")
    print("  a second streaming training and the direct route: bit-identical factors and telemetry",
          flush=True)
    print("implicit_telemetry " + json.dumps(tel), flush=True)

    # K1 (implicit), K2 (+G), K12a and K12b against their twins on the
    # path's packs and factors: the first half-steps, and sweep 4's
    errs = {}
    wire = als.build_host_wire(u_rel, i_rel, r, n_u, n_i, config)
    up, ip = als.device_pack_from_wire(wire, device)
    state = als.init_factor_state_single(wire.counts_u, wire.counts_i, n_u, n_i, config, device=device)
    X0, Y0, lam_u, lam_i, obs_u, obs_i = state
    X3, Y3, X4, Y4, tel3 = check_implicit_sweeps(up, ip, state, "", errs)

    # the same sweeps with the twins, driven by this script
    X, Y = X0, Y0
    rows = []
    t = time.perf_counter()
    for it in range(TWIN_SWEEPS):
        A, b = k1.normal_eq_plain(Y, up.seg_rows, up.cols, up.vals, up.rem, up.n_sys_rows, True, ALPHA)
        X, _ = k2.spd_solve_plain(A, b, lam_u, obs_u, X, k12.gramian_plain(Y))
        A, b = k1.normal_eq_plain(X, ip.seg_rows, ip.cols, ip.vals, ip.rem, ip.n_sys_rows, True, ALPHA)
        Y, _ = k2.spd_solve_plain(A, b, lam_i, obs_i, Y, k12.gramian_plain(X))
        rows.append(k12.implicit_objective_plain(
            X, Y, up.seg_rows, up.cols, up.vals, up.rem, lam_u, lam_i, ALPHA).item())
    twin_loop_s = time.perf_counter() - t
    Xt, Yt = X[:n_u].cpu().numpy(), Y[:n_i].cpu().numpy()
    dX = np.abs(Xt - X3[:n_u].cpu().numpy()).max()
    dY = np.abs(Yt - Y3[:n_i].cpu().numpy()).max()
    if dX > TRAIN_RTOL * np.abs(Xt).max() or dY > TRAIN_RTOL * np.abs(Yt).max():
        raise AssertionError(f"implicit twin training differs: max |dX| {dX}, |dY| {dY}")
    obj_k = als._telemetry_rows(tel3, TWIN_SWEEPS, X3.numel(), Y3.numel())[:, 4].astype(np.float64)
    np.testing.assert_allclose(obj_k, rows, rtol=TRAIN_RTOL)
    print(f"  twin-driven implicit training, {TWIN_SWEEPS} sweeps ({twin_loop_s:.2f} s): max |dX| "
          f"{dX:.3g}, |dY| {dY:.3g}, objective max rel diff {np.abs(obj_k / rows - 1).max():.3g} ok",
          flush=True)

    # times at the path's shapes (sweep 4's factors)
    A_u, b_u = k1.normal_eq(Y3, up, True, ALPHA)
    A_i, b_i = k1.normal_eq(X4, ip, True, ALPHA)
    Gy, Gx = k12.gramian(Y3), k12.gramian(X4)
    sums = torch.zeros(2, dtype=torch.float32, device=device)
    calls = {
        "normal_eq": {"user": lambda: k1.normal_eq(Y3, up, True, ALPHA),
                      "item": lambda: k1.normal_eq(X4, ip, True, ALPHA)},
        "spd_solve": {"user": lambda: k2.spd_solve(A_u, b_u, lam_u, obs_u, X3, sums, Gy),
                      "item": lambda: k2.spd_solve(A_i, b_i, lam_i, obs_i, Y3, sums, Gx)},
        "gramian": {"user": lambda: k12.gramian(X4), "item": lambda: k12.gramian(Y3)},
        "implicit_objective": {"user": lambda: k12.implicit_objective(X4, Y4, up, lam_u, lam_i, ALPHA)},
    }
    t_k = {n: {side: time_ms(f, iters=20, warmup=2) for side, f in c.items()} for n, c in calls.items()}
    dev = {n: {side: device_ms(f, calls=10) for side, f in c.items()} for n, c in calls.items()}
    plain_ms = {
        "normal_eq_user": time_ms(lambda: k1.normal_eq_plain(
            Y3, up.seg_rows, up.cols, up.vals, up.rem, up.n_sys_rows, True, ALPHA), iters=3, warmup=1),
        "spd_solve_user": time_ms(lambda: k2.spd_solve_plain(A_u, b_u, lam_u, obs_u, X3, Gy),
                                  iters=3, warmup=1),
        "gramian_user": time_ms(lambda: k12.gramian_plain(X4), iters=50, warmup=5),
        "implicit_objective": time_ms(lambda: k12.implicit_objective_plain(
            X4, Y4, up.seg_rows, up.cols, up.vals, up.rem, lam_u, lam_i, ALPHA), iters=3, warmup=1),
    }
    library_ms = {"gramian_user": time_ms(lambda: X4.T @ X4, iters=50, warmup=5)}
    R_u, R_i = up.n_sys_rows, ip.n_sys_rows
    bounds = {
        "normal_eq": {"user": k1_bound(up, len(r), R_i, k), "item": k1_bound(ip, len(r), R_u, k)},
        "spd_solve": {"user": k2_bound(R_u, int(obs_u.sum()), k),
                      "item": k2_bound(R_i, int(obs_i.sum()), k)},
        "gramian": {"user": gramian_bound(R_u, k), "item": gramian_bound(R_i, k)},
        "implicit_objective": {"user": objective_bound(up, len(r), R_u, R_i, k)},
    }

    def loop():
        return als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, SWEEPS,
                                   implicit=True, alpha=ALPHA)

    loop()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    loop_wall_ms = (time.perf_counter() - t) * 1e3
    loop_device_ms = device_ms(loop, calls=1)
    stream_keys = ("scan_s", "fold_s", "pack_s", "pack_exposed_s", "device_put_exposed_s", "wire_mb",
                   "compile_s", "compile_exposed_s", "device_pack_dispatch_s", "device_loop_s",
                   "stream_wall_s", "pack_cache")
    stats = {
        "card": card_line(), "alpha": ALPHA, "train_s": train_s,
        "streaming": {key: t_stream[key] for key in stream_keys},
        "direct": {key: timings[key] for key in (
            "pack_s", "device_put_s", "wire_mb", "device_pack_dispatch_s", "compile_s",
            "device_loop_s", "padded_slots")},
        "ms_per_sweep": timings["device_loop_s"] * 1e3 / SWEEPS,
        "loop_wall_ms": loop_wall_ms, "loop_device_ms": loop_device_ms,
        "device_busy_share": loop_device_ms / loop_wall_ms,
        "launches": counts, "kernel_ms": t_k, "device_ms": dev, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound": bounds, "errors": errs, "twin_loop_s": twin_loop_s,
    }
    print("implicit_training " + json.dumps(stats), flush=True)
    return counts, errs, stats, model


SP_VIEWS = 2_000_000  # view events of the Similar Product phase (the ML-20M stream's first)
SP_LIKES = 500_000  # like/dislike events, the next ones of the stream
SP_REG = 0.01


def sp_traffic(rng, ids, n_queries=320):
    """The Similar Product traffic of R3: 1-10 query items; 30 % with 1-2 of
    24 categories, 10 % a whitelist of 200, 20 % a blacklist of 20, 4 with
    unknown items only; num 10 (85 %) or 1..40. Returns (bodies, the
    unknown-only queries)."""
    N = len(ids)
    unknown_at = set(rng.choice(n_queries, size=4, replace=False).tolist())
    bodies = []
    for q in range(n_queries):
        body = {"items": [ids[j] for j in rng.integers(0, N, rng.integers(1, 11))],
                "num": int(10 if rng.random() < 0.85 else rng.integers(1, 41))}
        x = rng.random(3)
        if x[0] < 0.3:
            body["categories"] = [f"c{c}" for c in rng.integers(0, 24, rng.integers(1, 3))]
        if x[1] < 0.1:
            body["white_list"] = [ids[j] for j in rng.integers(0, N, 200)]
        if x[2] < 0.2:
            body["black_list"] = [ids[j] for j in rng.integers(0, N, 20)]
        if q in unknown_at:
            body["items"] = [f"unknown{q}", "nothing"]
        bodies.append(body)
    return bodies, unknown_at


@contextlib.contextmanager
def plain_cosine_sum():
    """SimilarityScorer driven by K14's plain twin, on whatever device its
    tensors are on: every table's shards scored by the twin into their
    blocks (no launch). Raises if a K14 launch was counted inside."""
    import torch

    from predictionio_tpu_torch.ops import similarity

    def plain(q, table, out=None):
        if out is None:
            out = torch.empty(table.size, dtype=torch.float32, device=table.device)
        for y, off in zip(table.ys, table.offsets):
            out[off:off + y.shape[0]] = similarity.cosine_sum_plain(q, y)
        return out

    saved = similarity.cosine_sum_table
    before = similarity.LAUNCHES.snapshot()["cosine_sum"]
    similarity.cosine_sum_table = plain
    try:
        yield
    finally:
        similarity.cosine_sum_table = saved
    if similarity.LAUNCHES.snapshot()["cosine_sum"] != before:
        raise AssertionError("K14 launched while the scorer was to run its twin")


def check_sp_answers(got, want, item_row, label):
    """Two runs' answers to one query list: equal lengths, ids equal
    outside near-tie runs, scores at RTOL / ATOL."""
    import numpy as np

    from predictionio_tpu_torch.ops.topn import check_topn_agreement

    for q, res in want.items():
        g = got[q].item_scores
        if len(g) != len(res.item_scores):
            raise AssertionError(f"{label}, query {q}: {len(g)} items, not {len(res.item_scores)}")
        if g:
            check_topn_agreement(
                np.array([[x.score for x in g]]), np.array([[item_row[x.item] for x in g]]),
                np.array([[x.score for x in res.item_scores]]),
                np.array([[item_row[x.item] for x in res.item_scores]]), RTOL, ATOL)


def sp_train_phase(rng, device):
    """Similar Product training on the card: ALSAlgorithm over the view
    counts of the ML-20M stream's first SP_VIEWS events (all 138,493 users,
    all 26,744 items with seeded categories) and LikeAlgorithm over the next
    SP_LIKES as likes and dislikes; the host scoring path (K14) over R3's
    traffic against its twin and against the retriever; K14 against its
    twin at Q = 4, 8, 16; a query after release_serving. Returns (the
    trainings' launches, the host path's launches, errors, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.similarproduct import engine as psp
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import device_pack as k5
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import similarity as k14
    from predictionio_tpu_torch.ops import spd_solve as k2

    n_users, n_items, k = ML20M_USERS, ML20M_ITEMS, RANK
    u, i, _ = ml20m_ratings()
    print(f"  reduced: {SP_VIEWS} view events and {SP_LIKES} like/dislike events, not the "
          f"stream's {len(u)}: _ratings deduplicates in a Python dict, as the reference does",
          flush=True)
    t = time.perf_counter()
    un = [f"u{n}" for n in range(n_users)]
    inm = [f"i{n}" for n in range(n_items)]
    cats = [tuple(sorted({f"c{c}" for c in rng.integers(0, 24, rng.integers(1, 4))}))
            for _ in range(n_items)]
    users = {name: {} for name in un}
    items = {name: psp.Item(categories=c) for name, c in zip(inm, cats)}
    views = [psp.ViewEvent(user=un[a], item=inm[b], t=float(n))
             for n, (a, b) in enumerate(zip(u[:SP_VIEWS].tolist(), i[:SP_VIEWS].tolist()))]
    lu, li = u[SP_VIEWS:SP_VIEWS + SP_LIKES].copy(), i[SP_VIEWS:SP_VIEWS + SP_LIKES].copy()
    rep = SP_LIKES // 5  # the last fifth repeats the first fifth's pairs, later
    lu[-rep:], li[-rep:] = lu[:rep], li[:rep]
    like = rng.random(SP_LIKES) < 0.7
    likes = [psp.LikeEvent(user=un[a], item=inm[b], t=float(n), like=bool(x))
             for n, (a, b, x) in enumerate(zip(lu.tolist(), li.tolist(), like.tolist()))]
    td = psp.TrainingData(users=users, items=items, view_events=views, like_events=likes)
    td.sanity_check()
    events_s = time.perf_counter() - t
    params = psp.ALSAlgorithmParams(rank=k, num_iterations=SWEEPS, lambda_=SP_REG, alpha=ALPHA)
    counters = (k1.LAUNCHES, k2.LAUNCHES, k5.LAUNCHES, k12.LAUNCHES, k14.LAUNCHES)
    counts, train_s, models, errs = {}, {}, {}, {}
    for name in ("ALSAlgorithm", "LikeAlgorithm"):
        alg = getattr(psp, name)(params)
        for c in counters:
            c.reset()
        t = time.perf_counter()
        m = alg.train(device, psp.Preparator().prepare(device, td))
        train_s[name] = time.perf_counter() - t
        counts[name] = snapshot(counters)
        want = {"normal_eq": 2 * SWEEPS, "spd_solve": 2 * SWEEPS, "gramian": 4 * SWEEPS,
                "implicit_objective": SWEEPS, "device_pack_presorted": 1,
                "device_scatter_pack": 1, "cosine_sum": 0}
        for kname, n in want.items():
            if counts[name][kname] != n:
                raise AssertionError(f"{name}: {kname} launched {counts[name][kname]} times, not {n}")
        if counts[name]["unpack_nibbles"] > 1 or any(
                v for kname, v in counts[name].items() if kname.endswith("_plain")):
            raise AssertionError(f"{name}: launches {counts[name]}")
        if m.item_factors.shape != (n_items, k) or not np.isfinite(m.item_factors).all():
            raise AssertionError(f"{name}: item factors {m.item_factors.shape} not finite or misshapen")
        models[name] = m
        print(f"  similarproduct.{name}.train: {train_s[name]:.2f} s, launches {counts[name]}",
              flush=True)
        # K1 (implicit), K2 (+G), K12a and K12b against their twins on this
        # training's packs: its deduplicated values (LikeAlgorithm's with
        # dislikes, r = -1: w_a = alpha, w_b = 0) from the same init
        user_index, _, su, si, sr = alg.training_arrays(td)
        config = alg.als_config()
        n_u = len(user_index)
        wire = als.build_host_wire(su, si, sr, n_u, n_items, config)
        up, ip = als.device_pack_from_wire(wire, device)
        state = als.init_factor_state_single(wire.counts_u, wire.counts_i, n_u, n_items, config,
                                             device=device)
        n_neg = int((sr < 0).sum())
        if name == "LikeAlgorithm" and not (0 < n_neg < len(sr)):
            raise AssertionError(f"LikeAlgorithm: {n_neg} dislikes of {len(sr)} values")
        if name == "LikeAlgorithm" and not bool((up.vals < 0).any() and (ip.vals < 0).any()):
            raise AssertionError("LikeAlgorithm: the packs carry no dislike")
        print(f"  similarproduct.{name}: {len(sr)} (user, item) values, {n_neg} negative; "
              f"its kernels against their twins:", flush=True)
        check_implicit_sweeps(up, ip, state, f"{name}: ", errs)
    model = models["ALSAlgorithm"]
    alg = psp.ALSAlgorithm(params)

    # the host path (no retriever) over R3's traffic, counted, against the
    # twin-driven host path and the retriever-served answers
    bodies, unknown_at = sp_traffic(rng, inm)
    queries = [(q, psp.Query(**b)) for q, b in enumerate(bodies)]
    host, host_s, host_counts = {}, {}, {}
    for name in ("ALSAlgorithm", "LikeAlgorithm"):
        a, m = getattr(psp, name)(params), models[name]
        for c in counters:
            c.reset()
        t = time.perf_counter()
        host[name] = dict(a.batch_predict(m, queries))
        host_s[name] = time.perf_counter() - t
        host_counts[name] = snapshot(counters)
        if host_counts[name]["cosine_sum"] != len(queries) - len(unknown_at) or any(
                v for kname, v in host_counts[name].items() if kname != "cosine_sum"):
            raise AssertionError(f"{name} host path launches {host_counts[name]} "
                                 f"for {len(queries)} queries")
        if any(host[name][q].item_scores for q in unknown_at):
            raise AssertionError(f"{name}: an unknown-only query was answered")
        if not any(res.item_scores for res in host[name].values()):
            raise AssertionError(f"{name}: the host path answered no query")
        with plain_cosine_sum():
            twin = dict(a.batch_predict(m, queries))
        check_sp_answers(host[name], twin, m.item_index, f"{name} host path vs its twin")
        print(f"  {name} host path: {len(queries)} queries in {host_s[name]:.2f} s, K14 launches "
              f"{host_counts[name]['cosine_sum']}; equal to its twin", flush=True)
    host = host["ALSAlgorithm"]
    alg.prepare_serving(device, model)
    served = {}
    for s in range(0, len(queries), 64):
        served.update(dict(alg.batch_predict(model, queries[s:s + 64])))
    check_sp_answers(host, served, model.item_index, "host path vs the retriever")
    # a straggler after release_serving: answered by the host path
    alg.release_serving(model)
    q0 = next(q for q in range(len(queries)) if q not in unknown_at)
    before = k14.LAUNCHES.snapshot()["cosine_sum"]
    straggler = alg.predict(model, queries[q0][1])
    if k14.LAUNCHES.snapshot()["cosine_sum"] != before + 1 or model._retriever is not None:
        raise AssertionError("the straggler did not take the host path")
    check_sp_answers({q0: straggler}, {q0: host[q0]}, model.item_index, "straggler")
    print("  ALSAlgorithm host path equal to the retriever; the straggler after "
          "release_serving answered by the host path", flush=True)

    # K14 against its twin on the trained catalog at every query width the
    # traffic reaches, within 1e-5 of Σ_q |q·y| (unit rows)
    scorer = model.scorer
    Yn = scorer._shards[0]
    for Q in (4, 8, 16):
        q = torch.from_numpy(scorer.normed[rng.integers(0, n_items, Q)]).to(device)
        got, want_ = scorer.sums(q), k14.cosine_sum_plain(q, Yn)
        scale = k14.cosine_sum_plain(q.abs(), Yn.abs())
        e = (got - want_).abs()
        if not bool((e <= 1e-6 + 1e-5 * scale).all()):
            raise AssertionError(f"K14 Q={Q}: differs from its twin ({e.max().item()})")
        errs["cosine_sum"] = max(errs.get("cosine_sum", 0.0), e.max().item())
        print(f"  K14 Q={Q} over {n_items} x {k}: max |d| {e.max().item():.3g} ok", flush=True)
    # times at Q = 16 through the host path's launch (the scorer's device
    # part, a table of one shard), and the host side of that call part by
    # part
    q16 = torch.from_numpy(scorer.normed[rng.integers(0, n_items, 16)]).to(device)
    timing = {
        "ms": time_ms(lambda: scorer.sums(q16), iters=200, warmup=10),
        "device_ms": device_ms(lambda: scorer.sums(q16), calls=50),
        "plain_ms": time_ms(lambda: k14.cosine_sum_plain(q16, Yn), iters=200, warmup=10),
        "library_ms": time_ms(lambda: (q16 @ Yn.T).sum(0), iters=200, warmup=10),
        "bound": roofline(4 * (16 * k + n_items * k + n_items), 2 * 16 * n_items * k),
        "Q": 16,
        "host_us": host_breakdown(lambda: scorer.sums(q16), wrapper_parts(k14)),
    }
    print(f"  K14 at Q = 16: {timing['ms']:.4f} ms a call ({timing['device_ms']:.4f} on the card), "
          f"host µs {json.dumps(timing['host_us'])}", flush=True)
    stats = {"card": card_line(), "events_s": events_s, "train_s": train_s, "launches": counts,
             "host_path": {"queries": len(queries), "seconds": host_s, "launches": host_counts},
             "cosine_sum": timing, "reduced": {"views": SP_VIEWS, "likes": SP_LIKES}}
    print("similarproduct_training " + json.dumps(stats), flush=True)
    return counts, host_counts, errs, stats, (td, queries, model)


def np_bits_equal(a, b) -> bool:
    """Two numpy arrays of one dtype and shape with the same bits."""
    import numpy as np

    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


SUB_RANK, SUB_BLOCK = 64, 8  # phase 3p: the reference's bench setting (bench.py:2596, :2674)
HIT_USERS = 2_000  # seeded users of 3p's hit-rate@10


def k11_scales(Y, X, pack, s0, b, implicit, alpha, A2, compute_dtype="float32"):
    """Per-row scales of K11a's outputs, as K1's: the largest diagonal of
    the twin's A bounds every Σ|w_a y_i y_j|; sqrt(Σ c²/w_a · that
    diagonal) bounds every Σ|c·y_i| (Cauchy-Schwarz, c = w_b − w_a·d, every
    w_a > 0 here). Third, each row's allowance for bfloat16 rounding flips
    (0 in float32): K11a-bf16 rounds c to bfloat16 after forming d in
    float32, and the kernel and its twin sum d in different orders, so
    where c lies within the two orders' rounding gap of a bfloat16 rounding
    boundary (|Δd| <= 2^-22·k·Σ_j |y_j x_j| bounds the gap) the two may
    round c one bfloat16 step apart; the allowance adds that step times
    the slot's largest |y_B| for every such slot of the row."""
    import torch

    from predictionio_tpu_torch.ops.precision import round_bf16

    bf16 = compute_dtype == BF16
    L = pack.cols.shape[-1]
    k = Y.shape[1]
    iota = torch.arange(L, device=X.device)
    csq = torch.zeros(pack.n_sys_rows, dtype=torch.float32, device=X.device)
    flips = torch.zeros(pack.n_sys_rows, dtype=torch.float32, device=X.device)
    Yc, Xc = (round_bf16(Y), round_bf16(X)) if bf16 else (Y, X)
    for c in range(pack.seg_rows.shape[0]):
        rows = pack.seg_rows[c].long()
        mask = (iota[None, :] < pack.rem[c][:, None]).to(torch.float32)
        v = pack.vals[c]
        Yg = Yc[pack.cols[c].long()]
        d = torch.einsum("slk,sk->sl", Yg, Xc[rows])
        if implicit:
            wa = alpha * v.abs()
            wb = (v > 0).to(torch.float32) * (1.0 + wa)
        else:
            wa, wb = torch.ones_like(v), v
        coef = (wb - wa * d) * mask
        csq.index_add_(0, rows, (coef * coef / wa.clamp_min(1e-30)).sum(-1))
        if bf16:
            gap = wa * (2.0 ** -22) * k * torch.einsum("slk,sk->sl", Yg.abs(), Xc[rows].abs())
            step = (round_bf16(coef + gap) - round_bf16(coef - gap)) * mask
            yb = Yg[:, :, s0:s0 + b].abs().amax(dim=-1)
            flips.index_add_(0, rows, (step * yb).sum(-1))
    diag = A2.diagonal(dim1=1, dim2=2).amax(dim=1)
    return diag, (csq * diag).sqrt(), flips


def k11a_partial_rounding(Y, X, pack, s0, b, implicit, alpha, rounds):
    """K11a's block accumulation with only the roundings named in
    ``rounds`` (of "y", "x", "w_a", "residual"; all four: K11a-bf16's twin;
    none: the float32 form), in the twin's order. What a K11a-bf16 that
    skipped a rounding would compute. Returns A, r and whether a skipped
    rounding changed any value."""
    import torch

    rnd = PartialRounding()
    Yc = rnd(Y, "y" in rounds)
    R, L = pack.n_sys_rows, pack.cols.shape[-1]
    iota = torch.arange(L, device=Y.device)
    A = torch.zeros((R, b, b), dtype=torch.float32, device=Y.device)
    r = torch.zeros((R, b), dtype=torch.float32, device=Y.device)
    for c in range(pack.seg_rows.shape[0]):
        rows = pack.seg_rows[c].long()
        mask = (iota[None, :] < pack.rem[c][:, None]).to(torch.float32)
        v = pack.vals[c]
        Yg = Yc[pack.cols[c].long()]
        Yb = Yg[:, :, s0:s0 + b]
        d = torch.einsum("slk,sk->sl", Yg, rnd(X[rows], "x" in rounds))
        if implicit:
            aw = alpha * v.abs() * mask
            bw = (v > 0).to(torch.float32) * mask * (1.0 + alpha * v.abs())
        else:
            aw, bw = mask, v * mask
        A.index_add_(0, rows, torch.einsum("slb,sl,slc->sbc", Yb, rnd(aw, "w_a" in rounds), Yb))
        r.index_add_(0, rows, torch.einsum("sl,slb->sb", rnd(bw - aw * d, "residual" in rounds),
                                           Yb))
    return A, r, rnd.changes


def check_k11a_rounds(Y, X, pack, s0, b, implicit, A2, r2, la, lr, label, gate=True):
    """K11a-bf16's check tells apart each form that skips a rounding (the
    float32 form; y, x, A's weight or the residual's weight unrounded),
    each held against the bfloat16 twin's A2, r2 within the same per-row
    limits ``la``, ``lr`` as the kernel (``lr`` with the rounding-flip
    allowance). A form whose skipped rounding changes no value computes
    K11a-bf16's function on these inputs and is named, not gated."""
    import torch

    has_rows = int((A2.diagonal(dim1=1, dim2=2).amax(dim=1) > 0).sum().item())
    every = ("y", "x", "w_a", "residual")
    out = []
    for form, rounds in (("float32", ()),) + tuple(
            (f"{n} unrounded", tuple(m for m in every if m != n)) for n in every):
        Am, rm, changes = k11a_partial_rounding(Y, X, pack, s0, b, implicit, ALPHA, rounds)
        if not changes:
            out.append(f"{form}: the same function here")
            continue
        ratio = torch.maximum((Am - A2).abs().amax(dim=(1, 2)) / la,
                              (rm - r2).abs().amax(dim=1) / lr)
        out.append(rounding_verdict(label, form, ratio, has_rows, gate))
    print(f"  {label}, forms that skip a rounding{'' if gate else ' (not gated)'}: "
          f"{'; '.join(out)} ok", flush=True)


def score_scale(Y, X, pack, compute_dtype="float32"):
    """Per slot Σ_c |y_c x_c| over all k columns (shaped like ``pack.vals``),
    which bounds the rounding of the slot's score d = y·x, formed or
    carried."""
    import torch

    from predictionio_tpu_torch.ops.precision import round_bf16

    bf16 = compute_dtype == BF16
    Yc, Xc = (round_bf16(Y), round_bf16(X)) if bf16 else (Y, X)
    out = torch.empty(pack.vals.shape, dtype=torch.float32, device=X.device)
    for c in range(pack.seg_rows.shape[0]):
        out[c] = torch.einsum("slk,sk->sl", Yc[pack.cols[c].long()].abs(),
                              Xc[pack.seg_rows[c].long()].abs())
    return out


def check_subspace_block(X, Y, pack, lam, has_obs, G, s0, b, implicit, label, errs, last,
                         compute_dtype="float32", rounds=None, carry=None):
    """K11a (K11a-bf16 in bfloat16 compute) and K11b on one block against
    their twins (K11a at K1_RTOL of each row's scale, plus in bfloat16 the
    row's rounding-flip allowance of ``k11_scales``; K11b's updated rows at
    K2_RTOL of each row's largest entry, both given the kernel's A and r)
    and against a second launch, bit for bit. In bfloat16 with ``rounds``
    ("gate" or "print"), also ``check_k11a_rounds`` at the same limits.
    With ``carry`` (the half-step's score and Δ buffers), K11a writes the
    slots' scores (block 0) or carries them (later blocks; the last block
    writes none), each against the twin's at K1_RTOL of the slot's
    Σ|y_c x_c|, and K11b writes Δ (not in the last block): bit for bit the
    kernel's own change of X (in the compute type), and at K2_RTOL of the
    twin's rows against the twin's. Both launches and the twin get the
    same score and Δ. Leaves the kernel's update, score and Δ in X and
    ``carry``."""
    import torch

    from predictionio_tpu_torch.ops import subspace as k11
    from predictionio_tpu_torch.ops.precision import in_cdt

    R = pack.n_sys_rows
    cdt = compute_dtype
    score, delta = carry if carry is not None else (None, None)
    dl = delta if carry is not None and s0 > 0 else None
    write = not last  # the last block's score is read by no block: not written
    score_in = score.clone() if score is not None else None
    A, r = k11.subspace_accumulate(Y, X, pack, s0, b, implicit, ALPHA, cdt, score, dl)
    score_out = score.clone() if score is not None else None
    if score is not None:
        score.copy_(score_in)
    A_again, r_again = k11.subspace_accumulate(Y, X, pack, s0, b, implicit, ALPHA, cdt, score, dl)
    if score is not None and not bits_equal(score, score_out):
        raise AssertionError(f"K11a {label}: a second launch writes other scores")
    score_twin = score_in.clone() if score is not None else None
    A2, r2 = k11.subspace_accumulate_plain(Y, X, pack.seg_rows, pack.cols, pack.vals, pack.rem,
                                           R, s0, b, implicit, ALPHA, cdt, score_twin, dl)
    es = 0.0
    if score is not None and write:
        valid = (torch.arange(pack.cols.shape[-1], device=X.device)[None, None, :]
                 < pack.rem[..., None])
        gap = (score - score_twin).abs()[valid]
        lim = 1e-6 + K1_RTOL * score_scale(Y, X, pack, cdt)[valid]
        if not bool((gap <= lim).all()):
            raise AssertionError(f"K11a {label}: scores differ from the twin's (max "
                                 f"{gap.max().item()})")
        es = gap.max().item()
    diag, rscale, flips = k11_scales(Y, X, pack, s0, b, implicit, ALPHA, A2, cdt)
    la, lr = 1e-6 + K1_RTOL * diag, 1e-6 + K1_RTOL * rscale + flips
    ea = (A - A2).abs().amax(dim=(1, 2))
    er = (r - r2).abs().amax(dim=1)
    if not bool((ea <= la).all()) or not bool((er <= lr).all()):
        raise AssertionError(f"K11a {label}: differs from its twin (max |dA| {ea.max().item()}, "
                             f"|dr| {er.max().item()})")
    # the rows whose r the flip allowance admitted, for the record
    flipped = int((er > 1e-6 + K1_RTOL * rscale).sum().item())
    if not (bits_equal(A, A_again) and bits_equal(r, r_again)):
        raise AssertionError(f"K11a {label}: a second launch differs")
    if rounds is not None and cdt == BF16:
        check_k11a_rounds(Y, X, pack, s0, b, implicit, A2, r2, la, lr, label, rounds == "gate")
    X_twin = X.clone()
    X_again = X.clone()
    X_before = X.clone()
    s1 = torch.zeros(2, dtype=torch.float32, device=X.device)
    s_again = torch.zeros(2, dtype=torch.float32, device=X.device)
    Gb = G if implicit else None
    d_out = delta if delta is not None and not last else None
    d_again = torch.empty_like(d_out) if d_out is not None else None
    d_twin = torch.empty_like(d_out) if d_out is not None else None
    k11.subspace_block_solve(A, r, X, lam, has_obs, s0, Gb, s1, last, d_out, cdt)
    k11.subspace_block_solve(A, r, X_again, lam, has_obs, s0, Gb, s_again, last, d_again, cdt)
    _, s2 = k11.subspace_block_solve_plain(A, r, X_twin, lam, has_obs, s0, Gb, d_twin, cdt)
    row_lim = 1e-6 + K2_RTOL * X_twin.abs().amax(dim=1)
    ex = (X - X_twin).abs().amax(dim=1)
    if not bool((ex <= row_lim).all()):
        raise AssertionError(f"K11b {label}: differs from its twin (max |dx| {ex.max().item()})")
    if not (bits_equal(X, X_again) and bits_equal(s1, s_again)):
        raise AssertionError(f"K11b {label}: a second launch differs")
    if d_out is not None:
        bf = cdt == BF16
        change = in_cdt(X[:, s0:s0 + b], bf) - in_cdt(X_before[:, s0:s0 + b], bf)
        if not (bits_equal(d_out, change) and bits_equal(d_out, d_again)):
            raise AssertionError(f"K11b {label}: Δ is not the kernel's own change of X, or a "
                                 "second launch's")
        # Δ's entries lie within two of X's limits of the twin's; in
        # bfloat16 compute plus one bfloat16 step of x (at most 2^-7 of |x|:
        # 7 stored bits), where the two x's round to neighbouring values
        lim_d = 2 * row_lim[:, None] + (2.0 ** -7 * X_twin[:, s0:s0 + b].abs() if bf else 0.0)
        if not bool(((d_out - d_twin).abs() <= lim_d).all()):
            raise AssertionError(f"K11b {label}: Δ differs from its twin's")
    # each sum against its own twin value: the block's Σδ² is a small
    # share of ΣX², so one tolerance off ΣX² would not hold it
    got_d2, want_d2 = s1[0].item(), s2[0].item()
    if not abs(got_d2 - want_d2) <= K2_RTOL * want_d2 + 1e-30:
        raise AssertionError(f"K11b {label}: block sum of squared updates {got_d2} vs {want_d2}")
    if last:
        if not abs(s1[1].item() - s2[1].item()) <= K2_RTOL * s2[1].item() + 1e-30:
            raise AssertionError(f"K11b {label}: sum of squared factors {s1[1].item()} vs "
                                 f"{s2[1].item()}")
    elif s1[1].item() != 0.0:
        raise AssertionError(f"K11b {label}: a sum of squared factors before the last block")
    name = "subspace_accumulate_bf16" if cdt == BF16 else "subspace_accumulate"
    errs[name] = max(errs.get(name, 0.0), ea.max().item(), er.max().item())
    errs["subspace_block_solve"] = max(errs.get("subspace_block_solve", 0.0), ex.max().item())
    print(f"  {label}: K11a ({cdt}{', carried' if dl is not None else ''}) max |dA| "
          f"{ea.max().item():.3g} |dr| {er.max().item():.3g}"
          f"{f', |d score| {es:.3g}' if score is not None and write else ''}"
          f"{f' ({flipped} rows by a bf16 rounding flip)' if cdt == BF16 else ''}, "
          f"K11b max |dx| {ex.max().item():.3g}, Σδ² {got_d2:.6g} vs twin {want_d2:.6g} "
          f"(rel {abs(got_d2 - want_d2) / max(want_d2, 1e-30):.3g}; Σδ²/ΣX² "
          f"{want_d2 / max(s2[1].item(), 1e-30):.3g}) ok", flush=True)
    return X


def twin_half_step(X, Y, pack, lam, has_obs, G, b, implicit, compute_dtype="float32"):
    """One subspace half-step by the plain twins, in place on ``X``, with
    the score carried across the blocks as ``ops/als._solve_side_subspace``
    carries it."""
    from predictionio_tpu_torch.ops import subspace as k11

    k = X.shape[1]
    nb = k // b
    score = delta = None
    if k11.carries(k, b):
        score, delta = k11.CarryBuffers([pack], b).views(pack)
    for j in range(nb):
        s0, last = j * b, j == nb - 1
        A, r = k11.subspace_accumulate_plain(
            Y, X, pack.seg_rows, pack.cols, pack.vals, pack.rem, pack.n_sys_rows, s0, b, implicit,
            ALPHA, compute_dtype, score, None if j == 0 else delta)
        k11.subspace_block_solve_plain(A, r, X, lam, has_obs, s0, G if implicit else None,
                                       None if last else delta, compute_dtype)
    return X


def check_subspace_half_step(X, Y, pack, lam, has_obs, G, b, implicit, label, errs, blocks,
                             compute_dtype="float32", rounds=None):
    """A whole subspace half-step by the kernels, block by block, in place
    on ``X``, with the score carried across the blocks where the kernels
    carry it (``ops/subspace.carries``); the blocks in ``blocks`` checked
    against their twins (and in bfloat16 against the forms that skip a
    rounding, ``rounds``); then the whole half-step against the twins'
    half-step from the same X, at TRAIN_RTOL of the largest entry."""
    from predictionio_tpu_torch.ops import subspace as k11

    k = X.shape[1]
    nb = k // b
    X0 = X.clone()
    carry = k11.CarryBuffers([pack], b).views(pack) if k11.carries(k, b) else None
    score, delta = carry if carry is not None else (None, None)
    for j in range(nb):
        s0, last = j * b, j == nb - 1
        if j in blocks:  # the forms that skip a rounding: at block 0, which forms d
            check_subspace_block(X, Y, pack, lam, has_obs, G, s0, b, implicit,
                                 f"{label}, block {j}", errs, last, compute_dtype,
                                 rounds if j == 0 else None, carry)
        else:
            A, r = k11.subspace_accumulate(Y, X, pack, s0, b, implicit, ALPHA, compute_dtype,
                                           score, None if j == 0 else delta)
            k11.subspace_block_solve(A, r, X, lam, has_obs, s0, G if implicit else None,
                                     last=last, delta=None if last else delta,
                                     compute_dtype=compute_dtype)
    Xt = twin_half_step(X0, Y, pack, lam, has_obs, G, b, implicit, compute_dtype)
    dx = (X - Xt).abs().max().item()
    if dx > TRAIN_RTOL * Xt.abs().max().item():
        raise AssertionError(f"{label}: the kernels' half-step differs from the twins' "
                             f"(max |dx| {dx})")
    name = "subspace_accumulate_bf16" if compute_dtype == BF16 else "subspace_accumulate"
    errs[f"{name}_half_step"] = max(errs.get(f"{name}_half_step", 0.0), dx)
    print(f"  {label}: the kernels' whole half-step against the twins' ({compute_dtype}"
          f"{', score carried' if carry is not None else ''}), max |dx| {dx:.3g} of "
          f"{Xt.abs().max().item():.3g} ok", flush=True)
    return X


def check_k11_sizes(rng, device, errs):
    """K11a and K11b on random packs (a row of many segments, an empty
    row) at k in {8, 32, 64} and b in {1, 2, 4, 8, k}, explicit and implicit,
    against their twins: with b < k a whole half-step with the score
    carried (blocks 0, 1 and the last checked, then the half-step against
    the twins'); with b = k one subspace half-step against K1 and K2's
    exact half-step, at K2's tolerance."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2

    n_rows, n_cols, nnz = 300, 200, 40_000
    u = rng.integers(0, n_rows, nnz).astype(np.int32)
    u[: nnz // 3] = 2  # many segments: partials and a combine
    u[u == 5] = 6  # an empty row
    i = rng.integers(0, n_cols, nnz).astype(np.int32)
    r = (rng.integers(1, 11, nnz) / 2).astype(np.float32)
    r[rng.random(nnz) < 0.1] *= -1  # dislikes (implicit: confidence, no preference)
    side = als.pack_segments(u, i, r, n_rows, 64, 1, 65_536)
    R, n_y = als._padded_rows(n_rows, 1), als._padded_rows(n_cols, 1)
    pack = als.device_pack(side, R, n_y, device)
    counts = np.bincount(u, minlength=n_rows)
    for k in (8, 32, 64):
        Y = torch.from_numpy((0.3 * rng.standard_normal((n_y, k))).astype(np.float32)).to(device)
        X0 = torch.from_numpy((0.3 * rng.standard_normal((R, k))).astype(np.float32)).to(device)
        G = Y.T @ Y
        for implicit in (False, True):
            cfg = als.ALSConfig(rank=k, reg=0.05)
            lam, obs = (torch.from_numpy(a).to(device)
                        for a in als._lam_obs_host(counts, n_rows, R, cfg))
            for b in sorted({1, 2, 4, 8, k}):
                X = X0.clone()
                mode = "implicit" if implicit else "explicit"
                if b < k:
                    check_subspace_half_step(X, Y, pack, lam, obs, G, b, implicit,
                                             f"K11 k={k} b={b} {mode}", errs, {0, 1, k // b - 1})
                    continue
                check_subspace_block(X, Y, pack, lam, obs, G, 0, b, implicit,
                                     f"K11 k={k} b={b} {mode}, block 0", errs, True)
                if b == k:  # one block: the exact half-step
                    A, bb = k1.normal_eq(Y, pack, implicit, ALPHA)
                    Xe = k2.spd_solve(A, bb, lam, obs, X0, None, G if implicit else None)
                    ex = (X - Xe).abs().amax(dim=1)
                    if not bool((ex <= 1e-6 + K2_RTOL * Xe.abs().amax(dim=1)).all()):
                        raise AssertionError(f"K11 k={k} b=k {mode}: differs from K1+K2 "
                                             f"({ex.max().item()})")
                    if not bits_equal(X[5], X0[5]):
                        raise AssertionError(f"K11 k={k} {mode}: the empty row moved")
                    print(f"  K11 k={k} b=k {mode}: the exact half-step, max |dx| "
                          f"{ex.max().item():.3g} ok", flush=True)


def hit_rate_at_10(X, Y, u, i, r, users, device):
    """bench.py:2573 ``_implicit_hit_rate`` over ``users``, in matrix: per
    user, the share of the items rated >= 4.0 in the model's top 10
    (float64 scores on the card)."""
    import numpy as np
    import torch

    Xd = torch.from_numpy(X[users]).to(device).double()
    Yd = torch.from_numpy(Y).to(device).double()
    top = torch.topk(Xd @ Yd.T, 10, dim=1).indices.cpu().numpy()
    keep = (r >= 4.0) & np.isin(u, users)
    row = {int(uu): n for n, uu in enumerate(users)}
    liked = {}
    for uu, ii in zip(u[keep].tolist(), i[keep].tolist()):
        liked.setdefault(uu, set()).add(ii)
    hits = total = 0
    for uu, items in liked.items():
        hits += len(items & set(top[row[uu]].tolist()))
        total += min(len(items), 10)
    return hits / total


def subspace_train_phase(rng, device):
    """iALS++ at full width (phase 3p): the recommendation template with
    implicit_prefs=True, solver="subspace", rank 64, block 8 on the ML-20M
    stream, counted; the routes bit-identical; K11a and K11b against their
    twins on the path's packs; a twin-driven loop; the exact solver at rank
    64 on the same stream for the loop's time and hit-rate@10; times.
    Returns (launches, errors, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Preparator,
        StreamingTrainingData,
    )
    from predictionio_tpu_torch.ops import als, streaming
    from predictionio_tpu_torch.ops import device_pack as k5
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2
    from predictionio_tpu_torch.ops import subspace as k11

    n_users, n_items, k, b = ML20M_USERS, ML20M_ITEMS, SUB_RANK, SUB_BLOCK
    nb = k // b
    u, i, r = ml20m_ratings()
    params = ALSAlgorithmParams(rank=k, num_iterations=SWEEPS, lambda_=REG, alpha=ALPHA,
                                implicit_prefs=True, solver="subspace", block_size=b)
    config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, alpha=ALPHA, implicit_prefs=True,
                           seed=params.seed, solver="subspace", block_size=b)
    names = np.array([f"u{n}" for n in range(n_users)] + [f"i{n}" for n in range(n_items)], dtype=object)

    def stream_factory():
        return ml20m_stream(u, i, r, names, n_users)

    def loader():
        raise AssertionError("the streaming path materialized the training data")

    alg = ALSAlgorithm(params)
    pd = Preparator().prepare(device, StreamingTrainingData(stream_factory, loader))
    counters = (k1.LAUNCHES, k2.LAUNCHES, k5.LAUNCHES, k11.LAUNCHES, k12.LAUNCHES)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    model = alg.train(device, pd)
    train_s = time.perf_counter() - t
    counts = snapshot(counters)
    Xm, Ym = model.arrays.user_factors, model.arrays.item_factors
    n_u, n_i = len(model.user_index), len(model.item_index)
    if Xm.shape != (n_u, k) or Ym.shape != (n_i, k) or not (
            np.isfinite(Xm).all() and np.isfinite(Ym).all()):
        raise AssertionError("subspace factors misshapen or not finite")

    # the packs the path trained on, for the counts and the checks
    remap_u = np.array([model.user_index.get(f"u{n}", -1) for n in range(n_users)], np.int32)
    remap_i = np.array([model.item_index.get(f"i{n}", -1) for n in range(n_items)], np.int32)
    u_rel, i_rel = remap_u[u], remap_i[i]
    wire = als.build_host_wire(u_rel, i_rel, r, n_u, n_i, config)
    up, ip = als.device_pack_from_wire(wire, device)
    combines = SWEEPS * nb * (int(up.plan.combine_rows.numel() > 0)
                              + int(ip.plan.combine_rows.numel() > 0))
    want = {
        "unpack_nibbles": SHIP_CHUNKS, "device_pack_presorted": 1, "device_scatter_pack": 1,
        "subspace_accumulate": 2 * nb * SWEEPS, "subspace_block_solve": 2 * nb * SWEEPS,
        "subspace_combine": combines, "normal_eq": 0, "spd_solve": 0,
        "gramian": 4 * SWEEPS, "implicit_objective": SWEEPS,
    }
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times on the subspace path, not {n}")
    if any(v for name, v in counts.items() if name.endswith("_plain")):
        raise AssertionError(f"a plain twin ran on the subspace path: {counts}")
    print(f"  ALSAlgorithm.train (streaming, implicit, subspace rank {k} block {b}): "
          f"{train_s:.2f} s, launches {counts}", flush=True)

    # a second streaming training (timings, telemetry) and the direct route
    t_stream, timings = {}, {}
    again = streaming.train_als_streaming(stream_factory(), config, device=device, timings=t_stream)
    direct = als.train_als(u_rel, i_rel, r, n_u, n_i, config, device=device, timings=timings)
    for name, other in (("a second streaming training", again.arrays), ("the direct route", direct)):
        if not all(np_bits_equal(a, bb) for a, bb in ((other.user_factors, Xm), (other.item_factors, Ym))):
            raise AssertionError(f"{name}'s subspace factors differ from the main path's")
    for key in ("sweep_telemetry", "block_telemetry"):
        if t_stream[key] != timings[key]:
            raise AssertionError(f"the routes' {key} differ")
    tel, btel = timings["sweep_telemetry"], timings["block_telemetry"]
    if len(tel) != SWEEPS or len(btel) != SWEEPS * nb or not np.isfinite(
            [row[c] for row in tel for c in row]).all():
        raise AssertionError(f"subspace telemetry: {len(tel)} sweep rows, {len(btel)} block rows")
    print("  a second streaming training and the direct route: bit-identical factors and "
          "telemetry", flush=True)
    print("subspace_telemetry " + json.dumps({"sweep": tel, "block": btel}), flush=True)
    print("  objective per sweep (never gated on its sign): "
          + ", ".join(f"{row['objective']:.7g}" for row in tel), flush=True)

    # K11a and K11b against their twins on the path's packs: blocks 0, 1
    # and nb-1 of sweep 4's user and item half-steps (the score carried
    # from block 0 on), each whole half-step against the twins'
    errs = {}
    state = als.init_factor_state_single(wire.counts_u, wire.counts_i, n_u, n_i, config, device=device)
    X0, Y0, lam_u, lam_i, obs_u, obs_i = state
    X3, Y3, tel3 = als._run_iterations(X0.clone(), Y0.clone(), up, ip, lam_u, lam_i, obs_u, obs_i,
                                       3, implicit=True, alpha=ALPHA, solver="subspace",
                                       block_size=b)
    X4 = als._solve_side_subspace(X3.clone(), Y3, k12.gramian(Y3), up, lam_u, obs_u, ALPHA, True, b)
    checked = check_subspace_half_step(X3.clone(), Y3, up, lam_u, obs_u, k12.gramian(Y3), b, True,
                                       "sweep 4, user side", errs, (0, 1, nb - 1))
    if not bits_equal(checked, X4):
        raise AssertionError("3p: the checked user half-step differs from _solve_side_subspace's")
    check_subspace_half_step(Y3.clone(), X4, ip, lam_i, obs_i, k12.gramian(X4), b, True,
                             "sweep 4, item side", errs, (0, 1, nb - 1))

    # two sweeps driven by the twins (the score carried, as the kernels'
    # loop carries it) against the kernels' loop
    X2, Y2, _ = als._run_iterations(X0.clone(), Y0.clone(), up, ip, lam_u, lam_i, obs_u, obs_i,
                                    2, implicit=True, alpha=ALPHA, solver="subspace", block_size=b)
    X, Y = X0.clone(), Y0.clone()
    t = time.perf_counter()
    for _ in range(2):
        for F, H, pack, lam, obs in ((X, Y, up, lam_u, obs_u), (Y, X, ip, lam_i, obs_i)):
            twin_half_step(F, H, pack, lam, obs, k12.gramian_plain(H), b, True)
    torch.cuda.synchronize()
    twin_loop_s = time.perf_counter() - t
    dX = (X - X2).abs().max().item()
    dY = (Y - Y2).abs().max().item()
    if dX > TRAIN_RTOL * X.abs().max().item() or dY > TRAIN_RTOL * Y.abs().max().item():
        raise AssertionError(f"twin-driven subspace training differs: max |dX| {dX}, |dY| {dY}")
    print(f"  twin-driven subspace training, 2 sweeps ({twin_loop_s:.2f} s): max |dX| {dX:.3g}, "
          f"|dY| {dY:.3g} ok", flush=True)

    # the exact solver at rank 64 on the same stream: the loop's time and
    # hit-rate@10 of both models (recorded, not gated)
    exact_cfg = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, alpha=ALPHA, implicit_prefs=True,
                              seed=params.seed)
    t_exact = {}
    exact = streaming.train_als_streaming(stream_factory(), exact_cfg, device=device,
                                          timings=t_exact)
    users = np.sort(np.random.default_rng(SUB_RANK).choice(n_u, HIT_USERS, replace=False))
    hit = {
        "subspace": hit_rate_at_10(Xm, Ym, u_rel, i_rel, r, users, device),
        "exact": hit_rate_at_10(exact.arrays.user_factors, exact.arrays.item_factors, u_rel, i_rel,
                                r, users, device),
    }
    loop_ratio = t_exact["device_loop_s"] / t_stream["device_loop_s"]
    print(f"  exact solver at rank {k}: device_loop_s {t_exact['device_loop_s']:.4f} s against "
          f"subspace {t_stream['device_loop_s']:.4f} s (exact / subspace {loop_ratio:.3f}); "
          f"hit-rate@10 over {HIT_USERS} users: subspace {hit['subspace']:.4f}, exact "
          f"{hit['exact']:.4f}", flush=True)

    # times at the path's shapes, sweep 4 of the user and item half-steps:
    # K11a at block 0 (d over all k columns, written to the score buffer),
    # block 1 (d carried and written back) and the last block (carried, not
    # written), the mean a launch over the half-step's nb blocks (blocks 1
    # to nb-2 do block 1's work), and a whole half-step of K11a and K11b
    A_u, r_u = k11.subspace_accumulate(Y3, X3, up, 0, b, True, ALPHA)
    A_i, r_i = k11.subspace_accumulate(X4, Y3, ip, 0, b, True, ALPHA)
    Gy3, Gx4 = k12.gramian(Y3), k12.gramian(X4)
    Xs, Ys = X3.clone(), Y3.clone()
    sums = torch.zeros(2, dtype=torch.float32, device=device)
    sides = {"user": (Y3, X3, up, lam_u, obs_u, Gy3), "item": (X4, Y3, ip, lam_i, obs_i, Gx4)}
    block_ms, block_dev, half_step_ms = k11a_block_times(sides, k, b)
    calls = {
        # in place on scratch copies: each call adds its δ again, which
        # changes no instruction it runs
        "subspace_block_solve": {
            "user": lambda: k11.subspace_block_solve(A_u, r_u, Xs, lam_u, obs_u, 0, Gy3, sums),
            "item": lambda: k11.subspace_block_solve(A_i, r_i, Ys, lam_i, obs_i, 0, Gx4, sums)},
    }
    t_k = {n: {side: time_ms(f, iters=20, warmup=2) for side, f in c.items()} for n, c in calls.items()}
    dev = {n: {side: device_ms(f, calls=10) for side, f in c.items()} for n, c in calls.items()}
    # K11a's row: the mean a launch over the half-step's blocks
    t_k["subspace_accumulate"] = {side: t["mean"] for side, t in block_ms.items()}
    dev["subspace_accumulate"] = {side: t["mean"] for side, t in block_dev.items()}
    print(f"  K11a by block (ms): {json.dumps(block_ms)}; device ms {json.dumps(block_dev)}; a "
          f"whole half-step of K11a and K11b: {json.dumps(half_step_ms)}", flush=True)
    Xp = X3.clone()
    plain_ms = {
        "subspace_accumulate_user": time_ms(lambda: k11.subspace_accumulate_plain(
            Y3, X3, up.seg_rows, up.cols, up.vals, up.rem, up.n_sys_rows, 0, b, True, ALPHA),
            iters=3, warmup=1),
        "subspace_block_solve_user": time_ms(lambda: k11.subspace_block_solve_plain(
            A_u, r_u, Xp, lam_u, obs_u, 0, Gy3), iters=3, warmup=1),
    }
    eye = torch.eye(b, dtype=torch.float32, device=device)

    def library_solve():
        M = A_u + Gy3[:b, :b][None] + lam_u[:, None, None] * eye
        rhs = r_u - X3 @ Gy3[:b].T - lam_u[:, None] * X3[:, :b]
        return torch.cholesky_solve(rhs[..., None], torch.linalg.cholesky(M))

    library_ms = {"subspace_block_solve_user": time_ms(library_solve, iters=20, warmup=2)}
    R_u, R_i = up.n_sys_rows, ip.n_sys_rows
    bounds = {
        "subspace_accumulate": {"user": k11a_bound(up, len(r), R_i, k, b),
                                "item": k11a_bound(ip, len(r), R_u, k, b)},
        "subspace_block_solve": {"user": k11b_bound(R_u, int(obs_u.sum()), k, b),
                                 "item": k11b_bound(R_i, int(obs_i.sum()), k, b)},
    }

    def loop():
        return als._run_iterations(X0.clone(), Y0.clone(), up, ip, lam_u, lam_i, obs_u, obs_i,
                                   SWEEPS, implicit=True, alpha=ALPHA, solver="subspace",
                                   block_size=b)

    loop()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    loop_wall_ms = (time.perf_counter() - t) * 1e3
    loop_device_ms = device_ms(loop, calls=1)
    stats = {
        "card": card_line(), "rank": k, "block_size": b, "train_s": train_s,
        "streaming": {key: t_stream[key] for key in (
            "fold_s", "pack_exposed_s", "device_put_exposed_s", "compile_s", "compile_exposed_s",
            "device_pack_dispatch_s", "device_loop_s", "stream_wall_s")},
        "exact_streaming": {key: t_exact[key] for key in ("device_loop_s", "stream_wall_s")},
        "exact_over_subspace_loop": loop_ratio, "hit_rate_at_10": hit, "hit_users": HIT_USERS,
        "k11a_blocks_ms": block_ms, "k11a_blocks_device_ms": block_dev,
        "half_step_ms": half_step_ms,
        "ms_per_sweep": t_stream["device_loop_s"] * 1e3 / SWEEPS,
        "loop_wall_ms": loop_wall_ms, "loop_device_ms": loop_device_ms,
        "device_busy_share": loop_device_ms / loop_wall_ms,
        "launches": counts, "kernel_ms": t_k, "device_ms": dev, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound": bounds, "errors": errs, "twin_loop_s": twin_loop_s,
        "packs": {"L_u": wire.L_u, "L_i": wire.L_i, "slots_u": up.cols.numel(),
                  "slots_i": ip.cols.numel(), "real_slots_u": int(up.rem.sum().item()),
                  "real_slots_i": int(ip.rem.sum().item()), "partials_u": up.plan.n_partials,
                  "partials_i": ip.plan.n_partials},
    }
    print("subspace_training " + json.dumps(stats), flush=True)
    return counts, errs, stats, model


def k11a_block_times(sides, k, b, compute_dtype="float32", half_step=True):
    """K11a's times (ms, and device ms) at a half-step's blocks on each side
    of ``sides`` (side: (H, F, pack, lam, has_obs, G): the counter side's
    factors, the side's, its pack and K11b's inputs): block 0 (d over all k
    columns, written to the score buffer), block 1 (d carried and written
    back) and the last block (carried, not written), with ``mean`` the
    mean a launch over the nb blocks (blocks 1 to nb-2 do block 1's work);
    with ``half_step``, a whole half-step of K11a and K11b
    (``_solve_side_subspace``) a side. The carried blocks read a Δ that
    block 0's K11b wrote."""
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import subspace as k11

    nb = k // b
    carry = k11.CarryBuffers([side[2] for side in sides.values()], b)
    block_ms, block_dev, half_ms = {}, {}, {}
    for side, (H, F, pack, lam, obs, G) in sides.items():
        score, delta = carry.views(pack)
        Fs = F.clone()
        k11.subspace_block_solve(*k11.subspace_accumulate(H, Fs, pack, 0, b, True, ALPHA,
                                                          compute_dtype, score),
                                 Fs, lam, obs, 0, G, delta=delta, compute_dtype=compute_dtype)
        calls = {
            "block0": lambda: k11.subspace_accumulate(H, F, pack, 0, b, True, ALPHA,
                                                      compute_dtype, score),
            "block1": lambda: k11.subspace_accumulate(H, Fs, pack, b, b, True, ALPHA,
                                                      compute_dtype, score, delta),
            "last": lambda: k11.subspace_accumulate(H, Fs, pack, k - b, b, True, ALPHA,
                                                    compute_dtype, score, delta),
        }
        block_ms[side] = {n: time_ms(f, iters=20, warmup=2) for n, f in calls.items()}
        block_dev[side] = {n: device_ms(f, calls=10) for n, f in calls.items()}
        for t_side in (block_ms[side], block_dev[side]):
            t_side["mean"] = (t_side["block0"] + (nb - 2) * t_side["block1"] + t_side["last"]) / nb
        if half_step:
            half_ms[side] = time_ms(lambda: als._solve_side_subspace(
                F.clone(), H, G, pack, lam, obs, ALPHA, True, b, None, compute_dtype, carry),
                iters=5, warmup=1)
    return block_ms, block_dev, half_ms


def k11a_bound(pack, n_ratings: int, Y_rows: int, k: int, b: int, bf16: bool = False):
    """K11a's (bound_ms, bound_by) for one block: each rating's id and
    value once (8 B; only the ``rem[s]`` real slots of a segment are read,
    never the padding), each segment's int32 count, the counter side's and
    the side's factors once, A and r written once, vs k + b(b+1)/2 + b
    FMAs per rating (d, the triangle, r). K11a-bf16 (``bf16``): both
    factor arrays are bfloat16 inputs (2 B an entry), the products at the
    bf16 tensor-core peak."""
    R = pack.n_sys_rows
    nbytes = (n_ratings * 8 + pack.rem.numel() * 4 + (Y_rows + R) * k * (2 if bf16 else 4)
              + R * (b * b + b) * 4)
    return roofline(nbytes, 2 * n_ratings * (k + b * (b + 1) // 2 + b),
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def k11b_bound(R: int, R_obs: int, k: int, b: int):
    """K11b's (bound_ms, bound_by) for one block: lam, has_obs and x_B of
    every row, A (its lower triangle), r and x's other columns (for G x)
    of the solved rows, x_B written back, vs b³/3 + 2b² + k·b operations
    per solve."""
    nbytes = R * (4 + 1 + 8 * b) + R_obs * (4 * b * (b + 1) // 2 + 4 * b + 4 * (k - b))
    return roofline(nbytes, R_obs * (b ** 3 / 3 + 2 * b * b + 2 * k * b))


DIMSUM_THRESHOLDS = (0.0, 0.5)
# co-view counts up to which the dense float32 Rn @ Rn.T rounds within
# rtol 1e-5: a sum of C equal positive terms errs by at most C·2⁻²⁴ of it
DENSE_COUNT = 167


def dimsum_phase(device, td, queries):
    """DIMSUM on 3s's TrainingData (phase 3d): ``DIMSUMAlgorithm.train``
    counted (K19a = K19b = 1) at two thresholds; the model bit for bit
    against the twins' on the same upload; against float64 cosines from
    the counts and the dense float32 ``Rn @ Rn.T`` (TF32 off, also the
    library time); R3's queries through ``predict`` against the twin
    model's; host dedup, K19 and copy seconds; times. Returns (launches,
    errors, stats)."""
    import dataclasses

    import numpy as np
    import torch

    from predictionio_tpu_torch.models.similarproduct import engine as psp
    from predictionio_tpu_torch.ops import cooccurrence as k19

    errs = {"cooccur_counts": 0.0, "cosine_from_counts": 0.0}  # bit for bit, or it raises
    counts, train_s, models = {}, {}, {}
    for thr in DIMSUM_THRESHOLDS:
        alg = psp.DIMSUMAlgorithm(psp.DIMSUMAlgorithmParams(threshold=thr))
        k19.LAUNCHES.reset()
        t = time.perf_counter()
        models[thr] = alg.train(device, psp.Preparator().prepare(device, td))
        train_s[thr] = time.perf_counter() - t
        counts[thr] = k19.LAUNCHES.snapshot()
        if counts[thr] != {"cooccur_counts": 1, "cosine_from_counts": 1,
                           "cooccur_counts_plain": 0, "cosine_from_counts_plain": 0}:
            raise AssertionError(f"DIMSUM threshold {thr}: launches {counts[thr]}")
        print(f"  DIMSUMAlgorithm.train threshold {thr}: {train_s[thr]:.2f} s, launches "
              f"{counts[thr]}", flush=True)
    alg = psp.DIMSUMAlgorithm(psp.DIMSUMAlgorithmParams(threshold=0.0))
    item_index, u, i = alg.view_arrays(td)
    I = len(item_index)
    timings = {}
    k19.item_cosine(u, i, I, 0.0, device=device, timings=timings)
    print(f"  host dedup {timings['dedup_s']:.3f} s, upload + K19 {timings['device_s']:.3f} s, "
          f"device-to-host copy {timings['d2h_s']:.3f} s ({I} x {I} float32)", flush=True)
    user_ptr, items = k19.dedup_views(u, i, I)
    rinv_np = k19.inverse_norms(items, I)
    ptr_d, items_d = torch.from_numpy(user_ptr).to(device), torch.from_numpy(items).to(device)
    rinv = torch.from_numpy(rinv_np).to(device)
    C = k19.cooccur_counts(ptr_d, items_d, I)
    C2 = k19.cooccur_counts_plain(ptr_d, items_d, I)
    if not bits_equal(C, C2):
        raise AssertionError("K19a differs from its twin")
    del C2
    pairs = int(((user_ptr[1:] - user_ptr[:-1]) * (user_ptr[1:] - user_ptr[:-1] + 1) // 2).sum())
    if int(C.sum(dtype=torch.int64).item()) != pairs:
        raise AssertionError("K19a's counts do not sum to the pair count")
    n_seen = int((rinv_np > 0).sum())
    print(f"  K19a bit-equal to its twin: {len(items)} distinct (user, item) pairs over "
          f"{len(user_ptr) - 1} users, {n_seen} of {I} items viewed, {pairs} pairs i >= j",
          flush=True)
    twin_models = {}
    for thr in DIMSUM_THRESHOLDS:
        S2 = k19.cosine_from_counts_plain(C, rinv, thr)
        if not np_bits_equal(models[thr].similarities, S2.cpu().numpy()):
            raise AssertionError(f"DIMSUM threshold {thr}: the model differs from the twins'")
        twin_models[thr] = dataclasses.replace(models[thr], similarities=S2.cpu().numpy())
        del S2
    print("  both models bit-equal to the twins' (K19b)", flush=True)

    # against float64 cosines from the counts, and the dense float32
    # Rn @ Rn.T of the reference (TF32 off), over every row
    S = torch.from_numpy(models[0.0].similarities).to(device)
    Rn = torch.zeros((I, len(user_ptr) - 1), dtype=torch.float32, device=device)
    owner = torch.repeat_interleave(torch.arange(len(user_ptr) - 1, device=device),
                                    ptr_d[1:] - ptr_d[:-1])
    Rn[items_d.long(), owner] = rinv[items_d.long()]
    dense = Rn @ Rn.T
    library_ms = time_ms(lambda: Rn @ Rn.T, iters=1, warmup=0)
    rd = rinv.double()
    e64 = e_dense = e_dense_all = e_dense_exact = 0.0
    n_many = 0
    for s in range(0, I, 2048):
        rows = slice(s, min(I, s + 2048))
        Cs = C[rows].double()
        CT = C[:, rows].T.double()
        idx = torch.arange(rows.start, rows.stop, device=device)[:, None]
        col = torch.arange(I, device=device)[None, :]
        full = torch.where(col < idx, Cs, torch.where(col > idx, CT, torch.zeros_like(Cs)))
        ex = full * rd[None, :] * rd[rows, None]
        got = S[rows].double()
        d64 = (got - ex).abs()
        if not bool((d64 <= 1e-6 * ex.abs() + 1e-7).all()):
            raise AssertionError(f"DIMSUM rows {rows}: off the float64 cosine by {d64.max().item()}")
        e64 = max(e64, d64.max().item())
        dd = dense[rows].double().clone()
        dd[idx.expand_as(dd) == col.expand_as(dd)] = 0.0
        dd_abs = (got - dd).abs()
        # the dense product sums C[i, j] equal float32 terms: its own
        # rounding is within rtol 1e-5 only where C[i, j] <= DENSE_COUNT
        few = full <= DENSE_COUNT
        if not bool((dd_abs <= 1e-5 * dd.abs() + 1e-6)[few].all()):
            raise AssertionError(f"DIMSUM rows {rows}: off the dense Rn @ Rn.T by "
                                 f"{dd_abs[few].max().item()} where C <= {DENSE_COUNT}")
        e_dense = max(e_dense, dd_abs[few].max().item())
        e_dense_all = max(e_dense_all, dd_abs.max().item())
        e_dense_exact = max(e_dense_exact, (dd - ex).abs().max().item())
        n_many += int((~few).sum().item())
    del dense
    print(f"  every row against float64 cosines from the counts (max |d| {e64:.3g}); against the "
          f"dense Rn @ Rn.T, TF32 off ({library_ms:.2f} ms a call), max |d| {e_dense:.3g} where "
          f"C <= {DENSE_COUNT}, {e_dense_all:.3g} over all ({n_many} entries with more "
          f"co-views; the dense product is off the float64 cosines by {e_dense_exact:.3g}) ok",
          flush=True)
    # K19a's library call: the counts alone are Rb @ Rb.T of the binary
    # view matrix (TF32 off; exact in float32 below 2^24 co-views)
    Rn[items_d.long(), owner] = 1.0
    dense_counts = Rn @ Rn.T
    if not torch.equal(torch.tril(dense_counts).to(torch.int32), C):
        raise AssertionError("K19a differs from the dense binary Rb @ Rb.T")
    del dense_counts
    counts_library_ms = time_ms(lambda: Rn @ Rn.T, iters=1, warmup=0)
    del Rn
    print(f"  K19a equal to the dense binary Rb @ Rb.T, TF32 off ({counts_library_ms:.2f} ms a "
          "call) ok", flush=True)
    # the 0.5 model: only values at or above the threshold stay
    S0, S5 = models[0.0].similarities, models[0.5].similarities
    if not np_bits_equal(S5, np.where(S0 >= 0.5, S0, np.float32(0))):
        raise AssertionError("DIMSUM threshold 0.5: not the 0.0 model filtered at 0.5")

    # R3's queries through predict, against the twin model's answers
    answers, answered = {}, {}
    for thr in DIMSUM_THRESHOLDS:
        a = psp.DIMSUMAlgorithm(psp.DIMSUMAlgorithmParams(threshold=thr))
        t = time.perf_counter()
        got = {q: a.predict(models[thr], query) for q, query in queries}
        answers[thr] = time.perf_counter() - t
        want = {q: a.predict(twin_models[thr], query) for q, query in queries}
        if got != want:
            raise AssertionError(f"DIMSUM threshold {thr}: answers differ from the twin model's")
        answered[thr] = sum(bool(res.item_scores) for res in got.values())
    if not answered[0.0]:
        raise AssertionError("DIMSUM threshold 0.0: no query answered")
    print(f"  {len(queries)} queries through predict, equal to the twin model's answers: "
          + ", ".join(f"threshold {thr}: {answered[thr]} answered in {sec:.2f} s"
                      for thr, sec in answers.items()), flush=True)

    # times: each kernel, its twin, the library call, bounds
    nnz = len(items)
    t_k = {"cooccur_counts": time_ms(lambda: k19.cooccur_counts(ptr_d, items_d, I), iters=5, warmup=1),
           "cosine_from_counts": time_ms(lambda: k19.cosine_from_counts(C, rinv, 0.0), iters=5,
                                         warmup=1)}
    dev = {"cooccur_counts": device_ms(lambda: k19.cooccur_counts(ptr_d, items_d, I), calls=3),
           "cosine_from_counts": device_ms(lambda: k19.cosine_from_counts(C, rinv, 0.0), calls=3)}
    plain_ms = {"cooccur_counts": time_ms(lambda: k19.cooccur_counts_plain(ptr_d, items_d, I),
                                          iters=2, warmup=1),
                "cosine_from_counts": time_ms(lambda: k19.cosine_from_counts_plain(C, rinv, 0.0),
                                              iters=2, warmup=1)}
    bounds = {
        # the CSR in, C written once (its I² int32 entries)
        "cooccur_counts": roofline(8 * len(user_ptr) + 4 * nnz + 4 * I * I, pairs),
        # C's lower triangle and rinv in, S written once
        "cosine_from_counts": roofline(4 * I * (I + 1) // 2 + 4 * I + 4 * I * I, 2 * I * I),
    }
    stats = {"card": card_line(), "items": I, "distinct_pairs": nnz, "pairs": pairs,
             "train_s": train_s, "item_cosine": timings, "predict_s": answers,
             "answered": answered,
             "launches": counts, "kernel_ms": t_k, "device_ms": dev, "plain_ms": plain_ms,
             "library_ms": {"cooccur_counts": counts_library_ms,
                            "cosine_from_counts": library_ms}, "bound": bounds,
             "errors": {"float64": e64, "dense_few": e_dense, "dense_all": e_dense_all,
                        "dense_vs_float64": e_dense_exact, "entries_over_count": n_many}}
    print("dimsum " + json.dumps(stats), flush=True)
    launches = {name: sum(c[name] for c in counts.values())
                for name in ("cooccur_counts", "cosine_from_counts")}
    return launches, errs, stats


EVAL_K, EVAL_QUERY_NUM, EVAL_SEED = 3, 10, 3  # folds, num per query, the fold seed
EVAL_GRID_RTOL, EVAL_GRID_ATOL = 2e-4, 2e-5  # the reference's grid tolerance (tests/test_als.py:394)
EVAL_PRECISION_ATOL = 0.02  # tie flips (tests/test_recommendation_eval.py:113)


def ml20m_event_columns():
    """The ML-20M-shaped ratings as one app's EventColumns, ids indexed in
    sorted string order as ``PEventStore.find_columns`` indexes them (users
    "u<j>", items "i<j>")."""
    import numpy as np

    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.data.store import EventColumns

    u, i, r = ml20m_ratings()

    def index(codes, n, prefix):
        present = np.flatnonzero(np.bincount(codes, minlength=n))
        names = np.array([f"{prefix}{j}" for j in present])
        order = np.argsort(names, kind="stable")
        row = np.full(n, -1, np.int32)
        row[present[order]] = np.arange(len(present), dtype=np.int32)
        return BiMap({name: j for j, name in enumerate(names[order].tolist())}), row

    user_index, user_row = index(u, ML20M_USERS, "u")
    item_index, item_row = index(i, ML20M_ITEMS, "i")
    return EventColumns(user_index, item_index, user_row[u], item_row[i], r)


def k13a_bound(pack, n_ratings: int, Y_rows: int, k: int, V: int, bf16: bool = False):
    """K13a's (bound_ms, bound_by) for one side: the pack read once for all
    variants (8 B a rating, 4 B a segment), each variant's Y, A and b moved
    once vs V x K1's k(k+1)/2 + k FMAs per rating. K13a-bf16 (``bf16``):
    Y in bfloat16 (2 B an entry), the products at the bf16 peak."""
    R = pack.n_sys_rows
    nbytes = (n_ratings * 8 + pack.rem.numel() * 4
              + V * (Y_rows * k * (2 if bf16 else 4) + R * (k * k + k) * 4))
    return roofline(nbytes, V * 2 * n_ratings * (k * (k + 1) // 2 + k),
                    PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)


def k13b_bound(R: int, R_obs: int, k: int, V: int):
    """K13b's (bound_ms, bound_by): has_obs once, each variant's lam,
    X_prev and X for every row, the lower triangle of A and b for the rows
    it solves, vs V x k³/3 + 2k² operations per solve."""
    nbytes = R + V * (R * (4 + 8 * k) + R_obs * (lower_triangle_bytes(k) + 4 * k))
    return roofline(nbytes, V * R_obs * (k ** 3 / 3 + 2 * k * k))


def eval_phase(device):
    """Phase 3e: ``run_evaluation(RecommendationEvaluation(k=10),
    ParamsGrid().engine_params_list)`` on the ML-20M-shaped ratings, counted
    from 0; the grid held against the serial path on fold 0 at rank 16;
    K13a and K13b against K1, K2 and their twins at fold 0's packs; times.
    Returns (launch counts, errors, stats)."""
    import threading

    import numpy as np
    import torch

    from predictionio_tpu_torch.controller import engine as engine_mod
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.models.recommendation.evaluation import (
        ParamsGrid,
        PrecisionAtK,
        RecommendationEvaluation,
    )
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import grid as k13
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2
    from predictionio_tpu_torch.ops import topn as k3
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
    from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

    t = time.perf_counter()
    cols = ml20m_event_columns()
    print(f"  EventColumns: {cols.n} ratings, {len(cols.entity_index)} users x "
          f"{len(cols.target_index)} items ({time.perf_counter() - t:.2f} s)", flush=True)
    ctx = WorkflowContext(device, {"default": cols})
    grid = ParamsGrid().engine_params_list
    # every variant: eval_k 3, 10 sweeps, seed 3, explicit; the fold seed
    # and query num as the data source params default them
    ds_params = grid[0].data_source_params[1]
    assert (ds_params.eval_k, ds_params.eval_query_num, ds_params.seed) == (
        EVAL_K, EVAL_QUERY_NUM, EVAL_SEED)
    for ep in grid:
        p = ep.algorithm_params_list[0][1]
        assert p.num_iterations == SWEEPS and not p.implicit_prefs and p.seed == EVAL_SEED

    # instruments: calls, each stage's intervals on the wall clock (the
    # grid's threads overlap, so a stage's wall seconds are the union of
    # its intervals, its busy seconds their sum), the folds read and the
    # grid's models, kept for the checks
    lock = threading.Lock()
    rec_stats = {"train_grid": 0, "train": 0}
    spans = {key: [] for key in ("read_eval", "pack", "device_put", "device_loop", "serve", "metric")}
    folds, grid_models = [], []
    orig = {
        "read_eval": rec.DataSource.read_eval, "train_grid": rec.ALSAlgorithm.__dict__["train_grid"],
        "train": rec.ALSAlgorithm.train, "train_als_grid": rec.train_als_grid,
        "serve_fold": engine_mod.Engine.__dict__["serve_fold"],
    }

    def add(key, value):
        with lock:
            rec_stats[key] += value

    def span(key, t_start, seconds=None):
        with lock:
            spans[key].append((t_start, t_start + seconds if seconds is not None
                               else time.perf_counter()))

    def read_eval(self, ctx_):
        t = time.perf_counter()
        out = orig["read_eval"](self, ctx_)
        span("read_eval", t)
        folds.append(out)
        return out

    def train_grid(cls, device_, pd, algos):
        add("train_grid", 1)
        models = orig["train_grid"].__func__(cls, device_, pd, algos)
        with lock:
            grid_models.append((pd.td, [a.params for a in algos], models))
        return models

    def train(self, device_, pd):
        add("train", 1)
        return orig["train"](self, device_, pd)

    def train_als_grid(*args, **kwargs):
        timings = {}
        t = time.perf_counter()
        out = orig["train_als_grid"](*args, timings=timings, **kwargs)
        for key in ("pack", "device_put", "device_loop"):  # consecutive phases
            span(key, t, timings[f"{key}_s"])
            t += timings[f"{key}_s"]
        return out

    def serve_fold(algorithms, models, serving, qa_pairs):
        t = time.perf_counter()
        out = orig["serve_fold"].__func__(algorithms, models, serving, qa_pairs)
        span("serve", t)
        return out

    evaluation = RecommendationEvaluation(k=10)
    metric = evaluation.evaluator.metric
    metric_calculate = metric.calculate

    def calculate(ctx_, eval_data_set):
        t = time.perf_counter()
        out = metric_calculate(ctx_, eval_data_set)
        span("metric", t)
        return out

    # the process's resident set sampled every 0.25 s through the run
    rss_samples, sampling = [rss_mb()], threading.Event()

    def sample_rss():
        while not sampling.wait(0.25):
            rss_samples.append(rss_mb())

    sampler = threading.Thread(target=sample_rss, daemon=True)
    sampler.start()
    rec.DataSource.read_eval = read_eval
    rec.ALSAlgorithm.train_grid = classmethod(train_grid)
    rec.ALSAlgorithm.train = train
    rec.train_als_grid = train_als_grid
    engine_mod.Engine.serve_fold = staticmethod(serve_fold)
    metric.calculate = calculate
    try:
        for m in (k1, k2, k3, k13):
            m.LAUNCHES.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = run_evaluation(evaluation, grid, ctx=ctx,
                                workflow_params=WorkflowParams(grid_train="auto"))
        eval_s = time.perf_counter() - t
        counts = {**k1.LAUNCHES.snapshot(), **k2.LAUNCHES.snapshot(),
                  **k3.LAUNCHES.snapshot(), **k13.LAUNCHES.snapshot()}
    finally:
        rec.DataSource.read_eval = orig["read_eval"]
        rec.ALSAlgorithm.train_grid = orig["train_grid"]
        rec.ALSAlgorithm.train = orig["train"]
        rec.train_als_grid = orig["train_als_grid"]
        engine_mod.Engine.serve_fold = orig["serve_fold"]
        del metric.calculate
        sampling.set()
        sampler.join()
    rss_samples.append(rss_mb())

    # the run: 2 ranks x 3 folds grid trainings of 2 variants each, no
    # per-variant training, 10 sweeps x 2 sides of K13a and K13b each
    [fold_sets] = folds
    n_queries = [len(qa) for _, _, qa in fold_sets]
    chunks = 4 * sum(-(-q // als.MAX_QUERY_ROWS) for q in n_queries)
    want = {"normal_eq_variants": 2 * EVAL_K * SWEEPS * 2, "spd_solve_variants": 2 * EVAL_K * SWEEPS * 2,
            "normal_eq": 0, "spd_solve": 0, "topn_packed": chunks,
            "normal_eq_variants_plain": 0, "spd_solve_variants_plain": 0, "normal_eq_plain": 0,
            "spd_solve_plain": 0, "topn_packed_plain": 0}
    got = {key: counts[key] for key in want}
    if got != want or rec_stats["train_grid"] != 2 * EVAL_K or rec_stats["train"] != 0:
        raise AssertionError(
            f"3e launches {got} (want {want}), train_grid {rec_stats['train_grid']} "
            f"(want {2 * EVAL_K}), train {rec_stats['train']} (want 0)")
    scores = [ms.score for _, ms in result.engine_params_scores]
    if len(scores) != 4 or not all(0.0 <= s <= 1.0 for s in scores):
        raise AssertionError(f"3e: scores {scores}")
    if scores[result.best_idx] != max(scores):
        raise AssertionError(f"3e: best index {result.best_idx} of {scores}")
    print(f"  run_evaluation: {eval_s:.2f} s; Precision@10 per variant (rank, reg) "
          f"{[(ep.algorithm_params_list[0][1].rank, ep.algorithm_params_list[0][1].lambda_, round(s, 6)) for ep, s in zip(grid, scores)]}, "
          f"best {result.best_idx}; queries per fold {n_queries}; launches {got}; "
          f"train_grid {rec_stats['train_grid']}, train 0", flush=True)

    # held against the serial path: fold 0 at rank 16, each regularizer
    # trained alone by train_als (the wire route). The wire packs the item
    # side in user order, the grid's host pack in scan order, so the two
    # sum each item's ratings in different orders: train_als_grid on the
    # fold's ratings stably sorted by user packs them as the wire does and
    # must give the serial factors bit for bit; the run's own grid models
    # (scan order) are compared for the record, and their fold 0
    # Precision@10 held within 0.02 of the serial models'
    errs = {}
    td0, _, qa0 = fold_sets[0]
    [(_, params16, models16)] = [g for g in grid_models if g[0] is td0 and g[1][0].rank == 16]
    n_u, n_i = len(td0.user_index), len(td0.item_index)
    algo = rec.ALSAlgorithm(params16[0])
    point = PrecisionAtK(k=10)

    def fold_precision(model):
        served = engine_mod.Engine.serve_fold([algo], [model], rec.Serving(), qa0)
        return point.calculate(ctx, [({}, served)])

    by_user = np.argsort(td0.user_idx, kind="stable")
    config16 = als.ALSConfig(rank=16, iterations=SWEEPS, reg=0.0, seed=EVAL_SEED)
    sorted_grid = als.train_als_grid(
        td0.user_idx[by_user], td0.item_idx[by_user], td0.ratings[by_user], n_u, n_i,
        config16, [p.lambda_ for p in params16], device=device)
    serial = {}
    for p, gm, sg in zip(params16, models16, sorted_grid):
        config = als.ALSConfig(rank=16, iterations=SWEEPS, reg=p.lambda_, seed=p.seed)
        sm = als.train_als(td0.user_idx, td0.item_idx, td0.ratings, n_u, n_i, config, device=device)
        if not (np.array_equal(sm.user_factors, sg.user_factors)
                and np.array_equal(sm.item_factors, sg.item_factors)):
            raise AssertionError(f"3e: the grid on the wire's order is not bit-equal to "
                                 f"train_als at reg {p.lambda_}")
        d = np.concatenate([(gm.arrays.user_factors - sm.user_factors).ravel(),
                            (gm.arrays.item_factors - sm.item_factors).ravel()])
        ref = np.concatenate([sm.user_factors.ravel(), sm.item_factors.ravel()])
        outside = int((np.abs(d) > EVAL_GRID_ATOL + EVAL_GRID_RTOL * np.abs(ref)).sum())
        p_grid = fold_precision(gm)
        p_serial = fold_precision(rec.ALSModel(sm, td0.user_index, td0.item_index, p, _device=device))
        if abs(p_grid - p_serial) > EVAL_PRECISION_ATOL:
            raise AssertionError(f"3e: fold 0 Precision@10 grid {p_grid} vs serial {p_serial}")
        serial[str(p.lambda_)] = {
            "wire_order_bit_equal": True, "scan_order_max_abs_diff": float(np.abs(d).max()),
            "scan_order_outside_tol": outside, "entries": int(d.size),
            "precision_grid": p_grid, "precision_serial": p_serial,
        }
        print(f"  fold 0, rank 16, reg {p.lambda_}: train_als_grid on the wire's order = serial "
              f"train_als bit for bit; the run's grid (scan order) max |d| {np.abs(d).max():.3g}, "
              f"{outside} of {d.size} outside rtol 2e-4 / atol 2e-5; Precision@10 {p_grid:.6f} "
              f"vs serial {p_serial:.6f} ok", flush=True)

    # K13a and K13b against K1, K2 and their twins at fold 0's packs: the
    # first user half-step (Y the seeded init) and the item half-step after
    # it, for both ranks; timed at rank 16's user side
    t = time.perf_counter()
    user_side = als.pack_segments(td0.user_idx, td0.item_idx, td0.ratings, n_u,
                                  als.auto_segment_length(td0.user_idx, n_u, 128))
    item_side = als.pack_segments(td0.item_idx, td0.user_idx, td0.ratings, n_i,
                                  als.auto_segment_length(td0.item_idx, n_i, 128))
    R_u, R_i = als._padded_rows(n_u, 1), als._padded_rows(n_i, 1)
    up = als.device_pack(user_side, R_u, R_i, device)
    ip = als.device_pack(item_side, R_i, R_u, device)
    regs = [p.lambda_ for p in params16]
    V = len(regs)

    def lam_obs(side, R):
        lams = [als._lam_obs_host(side.counts, side.n_rows, R, als.ALSConfig(reg=reg))[0] for reg in regs]
        obs = als._lam_obs_host(side.counts, side.n_rows, R, als.ALSConfig())[1]
        return torch.from_numpy(np.stack(lams)).to(device), torch.from_numpy(obs).to(device)

    lam_u, obs_u = lam_obs(user_side, R_u)
    lam_i, obs_i = lam_obs(item_side, R_i)
    print(f"  fold 0 packs ({time.perf_counter() - t:.2f} s): users {tuple(up.cols.shape)}, items "
          f"{tuple(ip.cols.shape)}, {len(td0.ratings)} ratings", flush=True)
    swept = {}  # rank: (users, items) after the first sweep
    for k in (8, 16):
        _, Y0 = als._factor_init_host(n_u, n_i, als.ALSConfig(rank=k, seed=EVAL_SEED), 1)
        Y = torch.from_numpy(np.broadcast_to(Y0, (V, R_i, k)).copy()).to(device)
        X0 = torch.zeros((V, R_u, k), dtype=torch.float32, device=device)
        X = check_k13(Y, up, lam_u, obs_u, X0, False, f"fold 0 users, rank {k}", errs)
        swept[k] = (X, check_k13(X, ip, lam_i, obs_i, Y, False, f"fold 0 items, rank {k}", errs))
    # timed at rank 16's user side of sweep 2: Y the items solved in sweep 1
    k, Yt = 16, swept[16][1]
    X0 = torch.zeros((V, R_u, k), dtype=torch.float32, device=device)
    A, b = k13.normal_eq_variants(Yt, up)
    A_reg = A + lam_u[..., None, None] * torch.eye(k, device=device)
    calls = {
        "normal_eq_variants": lambda: k13.normal_eq_variants(Yt, up),
        "spd_solve_variants": lambda: k13.spd_solve_variants(A, b, lam_u, obs_u, X0),
    }
    kernel_ms = {n: time_ms(f, iters=20, warmup=2) for n, f in calls.items()}
    dev_ms = {n: device_ms(f, calls=10) for n, f in calls.items()}
    plain_ms = {
        "normal_eq_variants": time_ms(lambda: k13.normal_eq_variants_plain(Yt, up), iters=3, warmup=1),
        "spd_solve_variants": time_ms(
            lambda: k13.spd_solve_variants_plain(A, b, lam_u, obs_u, X0), iters=3, warmup=1),
    }
    # K13b's yardstick: one batched Cholesky factor and solve over V x R rows
    library_ms = {
        "normal_eq_variants": None,
        "spd_solve_variants": time_ms(lambda: torch.cholesky_solve(
            b.reshape(-1, k, 1), torch.linalg.cholesky(A_reg.reshape(-1, k, k))), iters=5, warmup=1),
    }
    bounds = {
        "normal_eq_variants": k13a_bound(up, len(td0.ratings), R_i, k, V),
        "spd_solve_variants": k13b_bound(R_u, int(obs_u.sum()), k, V),
    }
    # per variant, K1 and K2 at the same shapes (the serial path's cost)
    kernel_ms["normal_eq_per_variant"] = time_ms(lambda: k1.normal_eq(Yt[0], up), iters=20, warmup=2)
    kernel_ms["spd_solve_per_variant"] = time_ms(
        lambda: k2.spd_solve(A[0], b[0], lam_u[0], obs_u, X0[0]), iters=20, warmup=2)
    for n in calls:
        print(f"  {n} (fold 0 users, rank {k}, V={V}): kernel {kernel_ms[n]:.4f} ms, device "
              f"{dev_ms[n]:.4f}, plain {plain_ms[n]:.3f}, library {library_ms[n]}, bound "
              f"{bounds[n][0]:.4f} ({bounds[n][1]})", flush=True)
    # K13a at both ranks on both sides of sweep 2 (the counter side solved in
    # sweep 1), and K1 on one variant at k = 8, 16 and 32 on the user side
    by_rank = {}
    for kk, (Xs, Ys) in swept.items():
        for side, fac, pack, n_ratings, n_y in (("users", Ys, up, len(td0.ratings), R_i),
                                                 ("items", Xs, ip, len(td0.ratings), R_u)):
            f = (lambda fac=fac, pack=pack: k13.normal_eq_variants(fac, pack))
            by_rank[f"rank{kk}_{side}"] = {
                "ms": time_ms(f, iters=20, warmup=2), "device_ms": device_ms(f, calls=10),
                "bound": k13a_bound(pack, n_ratings, n_y, kk, V)}
    k1_ms = {}
    for kk in (8, 16, 32):
        _, Yk = als._factor_init_host(n_u, n_i, als.ALSConfig(rank=kk, seed=EVAL_SEED), 1)
        Yk = torch.from_numpy(Yk).to(device)
        f = (lambda Yk=Yk: k1.normal_eq(Yk, up))
        k1_ms[f"k{kk}"] = {"ms": time_ms(f, iters=20, warmup=2),
                           "device_ms": device_ms(f, calls=10),
                           "bound": k1_bound(up, len(td0.ratings), R_i, kk)}
    print(f"  K13a (V={V}) by rank and side: {json.dumps(by_rank)}; K1 on one variant, user side: "
          f"{json.dumps(k1_ms)}", flush=True)
    # K13b (V variants) and K2 (one variant) at both grid ranks on the user
    # side of sweep 2: the solve sized to the rank (ops/spd_solve.solve_form)
    solve_by_rank = {}
    n_obs_u = int(obs_u.sum())
    for kk, (_, Ys) in swept.items():
        Ak, bk = k13.normal_eq_variants(Ys, up)
        Xk0 = torch.zeros((V, R_u, kk), dtype=torch.float32, device=device)
        f13 = (lambda Ak=Ak, bk=bk, Xk0=Xk0: k13.spd_solve_variants(Ak, bk, lam_u, obs_u, Xk0))
        f2 = (lambda Ak=Ak, bk=bk, Xk0=Xk0: k2.spd_solve(Ak[0], bk[0], lam_u[0], obs_u, Xk0[0]))
        solve_by_rank[f"rank{kk}"] = {
            "form": list(k2.solve_form(kk)),
            "spd_solve_variants": {"ms": time_ms(f13, iters=20, warmup=2),
                                   "device_ms": device_ms(f13, calls=10),
                                   "bound": k13b_bound(R_u, n_obs_u, kk, V)},
            "spd_solve": {"ms": time_ms(f2, iters=20, warmup=2), "device_ms": device_ms(f2, calls=10),
                          "bound": k2_bound(R_u, n_obs_u, kk)}}
        del Ak, bk
    print(f"  K13b (V={V}) and K2 (one variant) by rank, fold 0 users: {json.dumps(solve_by_rank)}",
          flush=True)
    stats = {
        "card": card_line(),
        "eval_s": eval_s,
        # per stage: wall seconds in which some thread was in it, and the
        # seconds summed over the threads
        "stages_s": {key: {"wall": union_s(v), "busy": sum(e - b for b, e in v)}
                     for key, v in spans.items()},
        "serving_chunks": chunks,
        "queries_per_fold": n_queries,
        "rss_mb": {"before": rss_samples[0], "peak": max(rss_samples), "after": rss_samples[-1]},
        "precision_at_10": {f"rank{ep.algorithm_params_list[0][1].rank}_reg{ep.algorithm_params_list[0][1].lambda_}": s
                            for ep, s in zip(grid, scores)},
        "best_idx": result.best_idx,
        "serial_fold0_rank16": serial,
        "launches": got,
        "kernel_ms": kernel_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound": bounds,
        "normal_eq_variants_by_rank": by_rank, "normal_eq_fold0_users": k1_ms,
        "solve_by_rank": solve_by_rank,
    }
    print("evaluation " + json.dumps(stats), flush=True)
    return got, errs, stats, td0


# --- 3h: bfloat16 training; 3c: checkpoint/resume ---

K13_BF16_RANKS = (8, 16)  # the template's grid ranks (models/recommendation/evaluation.py ParamsGrid)
BF16_RMSE_TOL = 1e-4  # the kernels' bf16 loop against the twins' by training RMSE
BF16_F32_RMSE_GAP = 5e-4  # the bf16 model's training RMSE against phase 3's float32 model's
CKPT_EVERY = 5  # 3c's checkpoint cadence


def check_bf16_sizes(rng, device, errs):
    """The four bfloat16 forms on random packs (a row of many segments, an
    empty row; ratings off the bfloat16 grid, half steps plus 0.2, and in
    implicit mode a tenth dislikes), against their twins' bfloat16 forms
    and against a second launch, bit for bit: K1-bf16 at k in {1, 7, 8,
    16, 17, 20, 24, 31, 32, 33, 70} (K1's three forms) at K1_RTOL of each
    row's scale; K13a-bf16 bit for bit against K1-bf16 per variant (V = 2,
    3; the warp-MMA form at (24, 3) and (32, 2), both modes); K11a-bf16 at k in
    {8, 32, 64} x b in {1, 2, 8, k} (both forms) at K1_RTOL plus the
    rounding-flip allowance; K12b-bf16 at k in {8, 32} at OBJ_RTOL. Each
    also differs from its float32 form: the rounding happens."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import normal_eq as k1

    n_rows, n_cols, nnz = 300, 200, 60_000
    u = rng.integers(0, n_rows, nnz).astype(np.int32)
    u[: nnz // 3] = 2  # many segments: partials and a combine
    u[u == 5] = 6  # an empty row
    i = rng.integers(0, n_cols, nnz).astype(np.int32)
    r = (rng.integers(1, 10, nnz) / 2 + 0.2).astype(np.float32)
    r_imp = np.where(rng.random(nnz) < 0.1, np.float32(-1.0), r).astype(np.float32)
    R, n_y = als._padded_rows(n_rows, 1), als._padded_rows(n_cols, 1)
    packs = {imp: als.device_pack(als.pack_segments(u, i, v, n_rows, 64, 1, 65_536), R, n_y, device)
             for imp, v in ((False, r), (True, r_imp))}
    counts = np.bincount(u, minlength=n_rows)
    has_obs = torch.from_numpy(np.r_[counts, np.zeros(R - n_rows, np.int64)] > 0).to(device)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(device)

    for k in (1, 7, 8, 16, *MMA_RANKS, 33, 70):
        Y = normal(n_y, k)
        for implicit in (False, True):
            pack = packs[implicit]
            label = f"K1-bf16 k={k} {'implicit' if implicit else 'explicit'}"
            A, b = k1.normal_eq(Y, pack, implicit, ALPHA, BF16)
            A_again, b_again = k1.normal_eq(Y, pack, implicit, ALPHA, BF16)
            A2, b2 = k1.normal_eq_plain(Y, pack.seg_rows, pack.cols, pack.vals, pack.rem, R,
                                        implicit, ALPHA, BF16)
            ea, eb = check_k1(A, b, A2, b2, pack, label, errs, implicit, ALPHA, "normal_eq_bf16")
            if not (bits_equal(A, A_again) and bits_equal(b, b_again)):
                raise AssertionError(f"{label}: a second launch differs")
            check_k1_rounds(Y, pack, A2, b2, implicit, ALPHA, label)
            A32, b32 = k1.normal_eq(Y, pack, implicit, ALPHA)
            gap = max((A32 - A).abs().max().item(), (b32 - b).abs().max().item())
            if gap == 0.0:
                raise AssertionError(f"{label}: equal to the float32 form")
            print(f"  {label}: max |dA| {ea:.3g} |db| {eb:.3g} against the twin; float32 form "
                  f"{gap:.3g} away ok", flush=True)
    for k, V, implicit in ((8, 2, False), (16, 2, True), (24, 3, False), (24, 3, True),
                           (32, 2, False), (32, 2, True), (33, 3, False)):
        Y = normal(V, n_y, k, scale=0.3)
        X_prev = normal(V, R, k)
        lam = torch.from_numpy(rng.uniform(0.5, 2.5, (V, R)).astype(np.float32)).to(device)
        check_k13(Y, packs[implicit], lam, has_obs, X_prev, implicit,
                  f"K13a-bf16 k={k} {'implicit' if implicit else 'explicit'}", errs, ALPHA, BF16)
    for k in (8, 32, 64):
        Y = normal(n_y, k, scale=0.3)
        X0 = normal(R, k, scale=0.3)
        G = Y.T @ Y
        for implicit in (False, True):
            lam, obs = (torch.from_numpy(a).to(device) for a in als._lam_obs_host(
                counts, n_rows, R, als.ALSConfig(rank=k, reg=0.05)))
            for b in sorted({1, 2, 8, k}):
                X = X0.clone()
                mode = "implicit" if implicit else "explicit"
                check_subspace_block(X, Y, packs[implicit], lam, obs, G, 0, b, implicit,
                                     f"K11-bf16 k={k} b={b} {mode}, block 0", errs, b == k, BF16,
                                     "gate")
                X32 = X0.clone()
                check_subspace_block(X32, Y, packs[implicit], lam, obs, G, 0, b, implicit,
                                     f"K11 k={k} b={b} {mode}, block 0", {}, b == k)
                if bits_equal(X, X32):
                    raise AssertionError(f"K11a-bf16 k={k} b={b} {mode}: equal to the float32 form")
    lam_u = torch.from_numpy(rng.uniform(0.1, 1.0, R).astype(np.float32)).to(device)
    lam_i = torch.from_numpy(rng.uniform(0.1, 1.0, n_y).astype(np.float32)).to(device)
    for k in (8, 32):
        # a rounding moves the scalar by a sum of terms of either sign, so
        # each form must fail the check on at least one of a few draws
        best = {}
        for draw in range(OBJ_DRAWS):
            X, Y = normal(R, k, scale=0.5), normal(n_y, k, scale=0.5)
            label = f"k={k} random pack, draw {draw}"
            got = check_objective(X, Y, packs[True], lam_u, lam_i, label, errs, BF16)
            if got == k12.implicit_objective(X, Y, packs[True], lam_u, lam_i, ALPHA).item():
                raise AssertionError(f"K12b-bf16 {label}: equal to the float32 form")
            for form, g in objective_rounds(X, Y, packs[True], lam_u, lam_i, label).items():
                best[form] = max(best.get(form, -np.inf), g)
        gate_objective_rounds(f"k={k}, the best of {OBJ_DRAWS} draws", best)


def bf16_train_phase(device, f32_stats):
    """Phase 3h: bfloat16 training at full width on the ML-20M ratings,
    the reference's headline config (``bench.py:772-775``, :1123-1125):
    the streaming and direct routes counted and bit-identical, K1-bf16
    against its twin at sweep 4, the twins' 10-sweep loop against the
    kernels' by RMSE, the RMSE against phase 3's float32 model; implicit
    (K1-bf16 implicit, K12b-bf16 against its twin per sweep) and iALS++ at
    rank 64, block 8 (K11a-bf16 against its twin at block 0 of sweep 4's
    half-steps); times and bounds. Returns (launches, errors, stats, the
    explicit model's factors)."""
    import dataclasses

    import numpy as np
    import torch

    from predictionio_tpu_torch.models.recommendation.engine import ALSAlgorithmParams
    from predictionio_tpu_torch.ops import als, streaming
    from predictionio_tpu_torch.ops import device_pack as k5
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import predict_pairs as k7
    from predictionio_tpu_torch.ops import spd_solve as k2
    from predictionio_tpu_torch.ops import subspace as k11

    n_users, n_items, k = ML20M_USERS, ML20M_ITEMS, RANK
    u, i, r = ml20m_ratings()
    names = np.array([f"u{n}" for n in range(n_users)] + [f"i{n}" for n in range(n_items)], dtype=object)
    # the bench's config; phase 3's seed, so the dtype is the only difference
    config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, seed=ALSAlgorithmParams().seed,
                           compute_dtype=BF16)
    counters = (k1.LAUNCHES, k2.LAUNCHES, k5.LAUNCHES, k7.LAUNCHES, k11.LAUNCHES, k12.LAUNCHES)
    errs, stats, launches = {}, {"card": card_line()}, {}

    def main_path(cfg, label, want):
        """``train_als_streaming`` over the ML-20M stream, counted from 0,
        then the direct route on the relabelled COO: bit-identical."""
        for c in counters:
            c.reset()
        t_s = {}
        t = time.perf_counter()
        res = streaming.train_als_streaming(ml20m_stream(u, i, r, names, n_users), cfg,
                                            device=device, timings=t_s)
        wall = time.perf_counter() - t
        counts = snapshot(counters)
        want = {"unpack_nibbles": SHIP_CHUNKS, "device_pack_presorted": 1, "device_scatter_pack": 1,
                "normal_eq": 0, "subspace_accumulate": 0, "implicit_objective": 0,
                "predict_pairs": 0, **want}
        for name, n in want.items():
            if counts[name] != n:
                raise AssertionError(f"3h {label}: {name} launched {counts[name]} times, not {n}")
        if any(v for name, v in counts.items() if name.endswith("_plain")):
            raise AssertionError(f"3h {label}: a plain twin ran on the main path: {counts}")
        n_u, n_i = len(res.user_index), len(res.item_index)
        remap_u = np.array([res.user_index.get(f"u{n}", -1) for n in range(n_users)], np.int32)
        remap_i = np.array([res.item_index.get(f"i{n}", -1) for n in range(n_items)], np.int32)
        u_rel, i_rel = remap_u[u], remap_i[i]
        t_d = {}
        t = time.perf_counter()
        direct = als.train_als(u_rel, i_rel, r, n_u, n_i, cfg, device=device, timings=t_d)
        direct_wall = time.perf_counter() - t
        X, Y = res.arrays.user_factors, res.arrays.item_factors
        if X.shape != (n_u, cfg.rank) or not (np.isfinite(X).all() and np.isfinite(Y).all()):
            raise AssertionError(f"3h {label}: factors misshapen or not finite")
        if not (np_bits_equal(X, direct.user_factors) and np_bits_equal(Y, direct.item_factors)):
            raise AssertionError(f"3h {label}: the direct route's factors differ from the streaming route's")
        launches[label] = counts
        stats[label] = {
            "stream_wall_s": wall, "direct_wall_s": direct_wall,
            "streaming": {key: t_s[key] for key in ("scan_s", "fold_s", "pack_exposed_s",
                                                    "device_put_exposed_s", "compile_s",
                                                    "device_pack_dispatch_s", "device_loop_s",
                                                    "stream_wall_s")},
            "direct": {key: t_d[key] for key in ("pack_s", "device_put_s", "device_pack_dispatch_s",
                                                 "compile_s", "device_loop_s")},
            "ms_per_sweep": {"streaming": t_s["device_loop_s"] * 1e3 / SWEEPS,
                             "direct": t_d["device_loop_s"] * 1e3 / SWEEPS},
            "telemetry_last": t_s["sweep_telemetry"][-1],
            "launches": counts,
        }
        print(f"  {label}: train_als_streaming {wall:.2f} s (device loop "
              f"{t_s['device_loop_s']:.4f} s, {t_s['device_loop_s'] * 1e3 / SWEEPS:.3f} ms per "
              f"sweep), train_als {direct_wall:.2f} s: bit-identical factors; launches "
              f"{ {name: n for name, n in counts.items() if n} }", flush=True)
        return res.arrays, u_rel, i_rel, n_u, n_i

    # a. explicit: the main path, then the packs it trained on
    model, u_rel, i_rel, n_u, n_i = main_path(config, "explicit", {
        "normal_eq_bf16": 2 * SWEEPS, "spd_solve": 2 * SWEEPS, "gramian": 0})
    rmse = als.rmse(model, u_rel, i_rel, r, device=device)
    gap = rmse - f32_stats["rmse"]
    if not abs(gap) <= BF16_F32_RMSE_GAP:
        raise AssertionError(f"3h: bf16 RMSE {rmse} vs float32 {f32_stats['rmse']}")
    stats["explicit"].update(rmse=rmse, rmse_f32=f32_stats["rmse"], rmse_gap=gap, f32={
        "train_s": f32_stats["train_s"], "ms_per_sweep": f32_stats["ms_per_sweep"],
        "streaming_device_loop_s": f32_stats["streaming"]["device_loop_s"],
        "direct_device_loop_s": f32_stats["direct"]["device_loop_s"]})
    print(f"  explicit bf16 RMSE {rmse:.6f} vs phase 3's float32 {f32_stats['rmse']:.6f} "
          f"(gap {gap:.3g}) ok", flush=True)
    wire = als.build_host_wire(u_rel, i_rel, r, n_u, n_i, config)
    up, ip = als.device_pack_from_wire(wire, device)
    R_u, R_i = up.n_sys_rows, ip.n_sys_rows
    state = als.init_factor_state_single(wire.counts_u, wire.counts_i, n_u, n_i, config, device=device)
    X0, Y0, lam_u, lam_i, obs_u, obs_i = state

    # b. K1-bf16 against its twin at both half-steps of sweep 4
    X3, Y3, _ = als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, 3, compute_dtype=BF16)
    X4 = check_half_step(X3, Y3, up, lam_u, obs_u, "bf16 user side of sweep 4", errs,
                         compute_dtype=BF16, rounds="gate")
    check_half_step(Y3, X4, ip, lam_i, obs_i, "bf16 item side of sweep 4", errs, compute_dtype=BF16,
                    rounds="gate")

    # c. the whole loop: the kernels' 10 sweeps (equal to the main path's
    # factors) against the twins' 10, by training RMSE
    Xk, Yk, _ = als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, SWEEPS,
                                    compute_dtype=BF16)
    if not (bits_equal(Xk[:n_u].cpu(), torch.from_numpy(model.user_factors))
            and bits_equal(Yk[:n_i].cpu(), torch.from_numpy(model.item_factors))):
        raise AssertionError("3h: the loop on the wire's packs differs from the main path")
    X, Y = X0, Y0
    t = time.perf_counter()
    for _ in range(SWEEPS):
        A, b = k1.normal_eq_plain(Y, up.seg_rows, up.cols, up.vals, up.rem, R_u, False, 1.0, BF16)
        X, _ = k2.spd_solve_plain(A, b, lam_u, obs_u, X)
        A, b = k1.normal_eq_plain(X, ip.seg_rows, ip.cols, ip.vals, ip.rem, R_i, False, 1.0, BF16)
        Y, _ = k2.spd_solve_plain(A, b, lam_i, obs_i, Y)
    twin_loop_s = time.perf_counter() - t
    twin = als.ALSModelArrays(X[:n_u].cpu().numpy(), Y[:n_i].cpu().numpy())
    rmse_twin = als.rmse(twin, u_rel, i_rel, r, device=device)
    d_max = max(np.abs(twin.user_factors - model.user_factors).max() / np.abs(model.user_factors).max(),
                np.abs(twin.item_factors - model.item_factors).max() / np.abs(model.item_factors).max())
    if not abs(rmse_twin - rmse) <= BF16_RMSE_TOL:
        raise AssertionError(f"3h: the twins' bf16 loop RMSE {rmse_twin} vs the kernels' {rmse}")
    stats["explicit"].update(twin_loop_s=twin_loop_s, rmse_twin=rmse_twin,
                             twin_factor_gap_of_largest=float(d_max))
    print(f"  twin-driven bf16 loop ({twin_loop_s:.2f} s): RMSE {rmse_twin:.6f} vs the kernels' "
          f"{rmse:.6f}; factors {d_max:.3g} of the largest entry apart (rounding flips, not gated) "
          f"ok", flush=True)

    # d. times at sweep 4's inputs: K1-bf16 beside K1 on the same inputs
    calls = {
        "normal_eq_bf16": {"user": lambda: k1.normal_eq(Y3, up, False, 1.0, BF16),
                           "item": lambda: k1.normal_eq(X4, ip, False, 1.0, BF16)},
        "normal_eq": {"user": lambda: k1.normal_eq(Y3, up), "item": lambda: k1.normal_eq(X4, ip)},
    }
    kernel_ms = {n: {s: time_ms(f, iters=20, warmup=2) for s, f in c.items()} for n, c in calls.items()}
    dev_ms = {n: {s: device_ms(f, calls=10) for s, f in c.items()} for n, c in calls.items()}
    plain_ms = {"normal_eq_bf16": time_ms(lambda: k1.normal_eq_plain(
        Y3, up.seg_rows, up.cols, up.vals, up.rem, R_u, False, 1.0, BF16), iters=3, warmup=1)}
    bounds = {"normal_eq_bf16": {"user": k1_bound(up, len(r), R_i, k, bf16=True),
                                 "item": k1_bound(ip, len(r), R_u, k, bf16=True)}}
    del A, b, X, Y, Xk, Yk

    # e. implicit: the main path, then sweep by sweep on its packs with
    # K12b-bf16 (the loop's own objective) against its twin after each
    cfg_i = dataclasses.replace(config, implicit_prefs=True, alpha=ALPHA)
    model_i, *_ = main_path(cfg_i, "implicit", {
        "normal_eq_bf16": 2 * SWEEPS, "spd_solve": 2 * SWEEPS, "gramian": 4 * SWEEPS,
        "implicit_objective_bf16": SWEEPS})
    X, Y = X0, Y0
    objectives = []
    for s in range(1, SWEEPS + 1):
        if s == 4:
            check_half_step(X, Y, up, lam_u, obs_u, "bf16 implicit user side of sweep 4", errs,
                            True, ALPHA, k12.gramian(Y), BF16, "gate")
        X, Y, tel = als._run_iterations(X, Y, up, ip, lam_u, lam_i, obs_u, obs_i, 1, implicit=True,
                                        alpha=ALPHA, compute_dtype=BF16)
        objectives.append(check_objective(X, Y, up, lam_u, lam_i, f"implicit sweep {s}", errs, BF16,
                                          got=tel[0, 4].item()))
        if s == 4:
            # the float32 kernel gated here; the forms rounding only x or
            # only y are gated on 3h a.'s random packs and printed here
            margins = objective_rounds(X, Y, up, lam_u, lam_i, "implicit sweep 4")
            gate_objective_rounds("implicit sweep 4", margins, ("float32 kernel",))
            stats["implicit_objective_rounds"] = margins
    if not (bits_equal(X[:n_u].cpu(), torch.from_numpy(model_i.user_factors))
            and bits_equal(Y[:n_i].cpu(), torch.from_numpy(model_i.item_factors))):
        raise AssertionError("3h: ten one-sweep loops differ from the implicit main path")
    Xi, Yi = X, Y
    kernel_ms["implicit_objective_bf16"] = time_ms(
        lambda: k12.implicit_objective(Xi, Yi, up, lam_u, lam_i, ALPHA, compute_dtype=BF16),
        iters=20, warmup=2)
    kernel_ms["implicit_objective"] = time_ms(
        lambda: k12.implicit_objective(Xi, Yi, up, lam_u, lam_i, ALPHA), iters=20, warmup=2)
    dev_ms["implicit_objective_bf16"] = device_ms(
        lambda: k12.implicit_objective(Xi, Yi, up, lam_u, lam_i, ALPHA, compute_dtype=BF16), calls=10)
    plain_ms["implicit_objective_bf16"] = time_ms(lambda: k12.implicit_objective_plain(
        Xi, Yi, up.seg_rows, up.cols, up.vals, up.rem, lam_u, lam_i, ALPHA, compute_dtype=BF16),
        iters=3, warmup=1)
    bounds["implicit_objective_bf16"] = objective_bound(up, len(r), R_u, R_i, k, bf16=True)
    stats["implicit"]["objectives"] = objectives
    print(f"  implicit: K12b-bf16 per sweep against its twin, and 10 one-sweep loops = the main "
          f"path bit for bit; objectives {objectives}", flush=True)
    del X, Y, Xi, Yi

    # f. iALS++ at rank 64, block 8, implicit (3p's config) in bf16
    kp, bp = SUB_RANK, SUB_BLOCK
    cfg_p = dataclasses.replace(cfg_i, rank=kp, solver="subspace", block_size=bp)
    model_p, *_ = main_path(cfg_p, "subspace", {
        "subspace_accumulate_bf16": 2 * (kp // bp) * SWEEPS,
        "subspace_block_solve": 2 * (kp // bp) * SWEEPS, "normal_eq_bf16": 0, "spd_solve": 0,
        "gramian": 4 * SWEEPS, "implicit_objective_bf16": SWEEPS})
    state_p = als.init_factor_state_single(wire.counts_u, wire.counts_i, n_u, n_i, cfg_p, device=device)
    Xp, Yp = state_p[0].clone(), state_p[1].clone()
    lam_pu, lam_pi = state_p[2], state_p[3]
    Xp, Yp, _ = als._run_iterations(Xp, Yp, up, ip, lam_pu, lam_pi, obs_u, obs_i, 3, implicit=True,
                                    alpha=ALPHA, solver="subspace", block_size=bp,
                                    compute_dtype=BF16)
    Xp3, Yp3 = Xp.clone(), Yp.clone()
    Gy = k12.gramian(Yp)
    last_p = kp // bp - 1
    check_subspace_half_step(Xp, Yp, up, lam_pu, obs_u, Gy, bp, True, "bf16 subspace user side of "
                             "sweep 4", errs, {0, 1, last_p}, BF16, "gate")
    Gx = k12.gramian(Xp)
    check_subspace_half_step(Yp, Xp, ip, lam_pi, obs_i, Gx, bp, True, "bf16 subspace item side of "
                             "sweep 4", errs, {0, 1, last_p}, BF16, "gate")
    # K11a-bf16 by block (the mean a launch over the half-step is its row's
    # time), and the float32 K11a on the user side in the same run
    sides_p = {"user": (Yp3, Xp3, up, lam_pu, obs_u, k12.gramian(Yp3)),
               "item": (Xp, Yp3, ip, lam_pi, obs_i, k12.gramian(Xp))}
    blocks_bf16, blocks_bf16_dev, _ = k11a_block_times(sides_p, kp, bp, BF16, half_step=False)
    blocks_f32, _, _ = k11a_block_times({"user": sides_p["user"]}, kp, bp, half_step=False)
    kernel_ms["subspace_accumulate_bf16"] = {side: t["mean"] for side, t in blocks_bf16.items()}
    kernel_ms["subspace_accumulate"] = {"user": blocks_f32["user"]["mean"]}
    dev_ms["subspace_accumulate_bf16"] = {"user": blocks_bf16_dev["user"]["mean"]}
    stats["k11a_bf16_blocks_ms"] = blocks_bf16
    stats["k11a_bf16_blocks_device_ms"] = blocks_bf16_dev
    stats["k11a_f32_blocks_ms"] = blocks_f32
    plain_ms["subspace_accumulate_bf16"] = time_ms(lambda: k11.subspace_accumulate_plain(
        Yp3, Xp3, up.seg_rows, up.cols, up.vals, up.rem, R_u, 0, bp, True, ALPHA, BF16),
        iters=3, warmup=1)
    bounds["subspace_accumulate_bf16"] = {
        "user": k11a_bound(up, len(r), R_i, kp, bp, bf16=True),
        "item": k11a_bound(ip, len(r), R_u, kp, bp, bf16=True)}
    stats.update(kernel_ms=kernel_ms, device_ms=dev_ms, plain_ms=plain_ms, bound=bounds)
    for name, row in kernel_ms.items():
        print(f"  {name}: kernel {row} ms, device {dev_ms.get(name)}, plain {plain_ms.get(name)}, "
              f"bound {bounds.get(name)}", flush=True)
    counts = {}
    for c in launches.values():
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
    print("bf16_training " + json.dumps(stats), flush=True)
    return counts, errs, stats, model


def bf16_grid_phase(device, td0):
    """Phase 3h's grid: ``train_als_grid`` in bfloat16 over the template's
    grid (ranks 8 and 16 x regs 0.01 and 0.1) on 3e's fold-0 training
    ratings in the wire's order, each variant bit for bit equal to
    ``train_als`` in bfloat16 of that variant, counted from 0 (K13a-bf16 =
    2 x sweeps per rank, float32 K13a = 0); K13a-bf16 against K1-bf16 per
    variant and its twin on fold 0's first half-steps at rank 16; times.
    Returns (launches, errors, stats)."""
    import dataclasses

    import numpy as np
    import torch

    from predictionio_tpu_torch.models.recommendation.evaluation import ParamsGrid
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import grid as k13
    from predictionio_tpu_torch.ops import normal_eq as k1

    regs = sorted({ep.algorithm_params_list[0][1].lambda_ for ep in ParamsGrid().engine_params_list})
    ranks = sorted({ep.algorithm_params_list[0][1].rank for ep in ParamsGrid().engine_params_list})
    assert tuple(ranks) == K13_BF16_RANKS and len(regs) == 2
    n_u, n_i = len(td0.user_index), len(td0.item_index)
    by_user = np.argsort(td0.user_idx, kind="stable")
    u, i, r = td0.user_idx[by_user], td0.item_idx[by_user], td0.ratings[by_user]
    errs, counts = {}, {"normal_eq_variants_bf16": 0, "normal_eq_variants": 0}
    walls = {}
    for k in ranks:
        config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=0.0, seed=EVAL_SEED, compute_dtype=BF16)
        k13.LAUNCHES.reset()
        t_g = {}
        t = time.perf_counter()
        grid = als.train_als_grid(u, i, r, n_u, n_i, config, regs, device=device, timings=t_g)
        walls[f"rank{k}"] = {"grid_s": time.perf_counter() - t, **t_g}
        c = k13.LAUNCHES.snapshot()
        if (c["normal_eq_variants_bf16"], c["normal_eq_variants"]) != (2 * SWEEPS, 0) or any(
                v for name, v in c.items() if name.endswith("_plain")):
            raise AssertionError(f"3h grid rank {k}: launches {c}")
        for name in counts:
            counts[name] += c[name]
        for reg, gm in zip(regs, grid):
            sm = als.train_als(u, i, r, n_u, n_i, dataclasses.replace(config, reg=reg), device=device)
            if not (np_bits_equal(sm.user_factors, gm.user_factors)
                    and np_bits_equal(sm.item_factors, gm.item_factors)):
                raise AssertionError(f"3h grid: rank {k} reg {reg} is not bit-equal to bf16 train_als")
        print(f"  bf16 grid, fold 0, rank {k}: {walls[f'rank{k}']['grid_s']:.2f} s, each of regs "
              f"{regs} bit-equal to bf16 train_als; launches {c}", flush=True)
    # K13a-bf16 against K1-bf16 and the twins on fold 0's packs at rank 16
    k = 16
    user_side = als.pack_segments(u, i, r, n_u, als.auto_segment_length(u, n_u, 128))
    R_u, R_i = als._padded_rows(n_u, 1), als._padded_rows(n_i, 1)
    up = als.device_pack(user_side, R_u, R_i, device)
    lam = torch.from_numpy(np.stack([als._lam_obs_host(user_side.counts, n_u, R_u, als.ALSConfig(reg=g))[0]
                                     for g in regs])).to(device)
    obs = torch.from_numpy(als._lam_obs_host(user_side.counts, n_u, R_u, als.ALSConfig())[1]).to(device)
    _, Y0 = als._factor_init_host(n_u, n_i, als.ALSConfig(rank=k, seed=EVAL_SEED), 1)
    Y = torch.from_numpy(np.broadcast_to(Y0, (len(regs), R_i, k)).copy()).to(device)
    X0 = torch.zeros((len(regs), R_u, k), dtype=torch.float32, device=device)
    check_k13(Y, up, lam, obs, X0, False, "bf16 fold 0 users, rank 16", errs, compute_dtype=BF16)
    kernel_ms = {
        "normal_eq_variants_bf16": time_ms(lambda: k13.normal_eq_variants(Y, up, False, 1.0, BF16),
                                           iters=20, warmup=2),
        "normal_eq_variants": time_ms(lambda: k13.normal_eq_variants(Y, up), iters=20, warmup=2),
        "normal_eq_bf16_per_variant": time_ms(lambda: k1.normal_eq(Y[0], up, False, 1.0, BF16),
                                              iters=20, warmup=2),
    }
    dev_ms = {"normal_eq_variants_bf16": device_ms(
        lambda: k13.normal_eq_variants(Y, up, False, 1.0, BF16), calls=10)}
    plain_ms = {"normal_eq_variants_bf16": time_ms(
        lambda: k13.normal_eq_variants_plain(Y, up, False, 1.0, BF16), iters=3, warmup=1)}
    bounds = {"normal_eq_variants_bf16": k13a_bound(up, len(r), R_i, k, len(regs), bf16=True)}
    stats = {"card": card_line(), "walls": walls, "launches": counts, "kernel_ms": kernel_ms,
             "device_ms": dev_ms, "plain_ms": plain_ms, "bound": bounds}
    print("bf16_grid " + json.dumps(stats), flush=True)
    return counts, errs, stats


def checkpoint_phase(device, f32_model, bf16_model):
    """Phase 3c: checkpoint/resume through the template's route,
    ``ALSAlgorithm.train`` on the ML-20M stream with ``checkpoint_dir`` (a
    temporary directory) and ``checkpoint_every=5``: 5 sweeps; then 10 on
    the same directory, which resume at 5 and equal phase 3's
    uninterrupted model bit for bit; 10 again, which resume at 10 with no
    K1 launch; then the bfloat16 config on the same directory, which is
    another run: it logs "different run", starts fresh and equals 3h's
    bf16 model bit for bit. Records each save's seconds and the bytes on
    disk. Returns stats."""
    import dataclasses
    import logging

    import numpy as np

    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        Preparator,
        StreamingTrainingData,
    )
    from predictionio_tpu_torch.ops import als, streaming
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.workflow import checkpoint

    n_users, n_items = ML20M_USERS, ML20M_ITEMS
    u, i, r = ml20m_ratings()
    names = np.array([f"u{n}" for n in range(n_users)] + [f"i{n}" for n in range(n_items)], dtype=object)

    def stream_factory():
        return ml20m_stream(u, i, r, names, n_users)

    def loader():
        raise AssertionError("the streaming path materialized the training data")

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    saves = []
    orig_save = checkpoint.StepCheckpointer.maybe_save

    def timed_save(self, step, state, force=False):
        t = time.perf_counter()
        out = orig_save(self, step, state, force)
        saves.append((step, time.perf_counter() - t))
        return out

    lines = Lines()
    logger = logging.getLogger("predictionio_tpu_torch.ops.als")
    level = logger.level
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    checkpoint.StepCheckpointer.maybe_save = timed_save
    runs = []
    try:
        with tempfile.TemporaryDirectory() as d:
            ckdir = os.path.join(d, "ckpt")
            base = ALSAlgorithmParams(rank=RANK, num_iterations=SWEEPS, lambda_=REG,
                                      checkpoint_dir=ckdir, checkpoint_every=CKPT_EVERY)

            def run(label, params=None, config=None):
                lines.lines.clear()
                k1.LAUNCHES.reset()
                n_saves = len(saves)
                t = time.perf_counter()
                if config is None:
                    pd = Preparator().prepare(device, StreamingTrainingData(stream_factory, loader))
                    arrays = ALSAlgorithm(params).train(device, pd).arrays
                else:
                    arrays = streaming.train_als_streaming(
                        stream_factory(), config, device=device, checkpoint_dir=ckdir,
                        checkpoint_every=CKPT_EVERY).arrays
                wall = time.perf_counter() - t
                files = sorted(os.listdir(ckdir))
                row = {"label": label, "wall_s": wall, "log": list(lines.lines),
                       "launches": k1.LAUNCHES.snapshot(), "saves": saves[n_saves:],
                       "files": files,
                       "bytes_on_disk": sum(os.path.getsize(os.path.join(ckdir, f)) for f in files)}
                runs.append(row)
                print(f"  {label}: {wall:.2f} s, log {row['log']}, K1 launches "
                      f"{row['launches']}, saves {row['saves']}, on disk {files} "
                      f"({row['bytes_on_disk']} B)", flush=True)
                return arrays, row

            def same(a, b):
                return (np_bits_equal(a.user_factors, b.user_factors)
                        and np_bits_equal(a.item_factors, b.item_factors))

            _, row = run("5 sweeps", dataclasses.replace(base, num_iterations=CKPT_EVERY))
            if row["launches"]["normal_eq"] != 2 * CKPT_EVERY or len(row["saves"]) != 1:
                raise AssertionError(f"3c: the 5-sweep run {row}")
            arrays, row = run("10 sweeps, resumed", base)
            if not any("resuming ALS from iteration 5" in m for m in row["log"]):
                raise AssertionError(f"3c: the 10-sweep run did not resume at 5: {row['log']}")
            if row["launches"]["normal_eq"] != 2 * (SWEEPS - CKPT_EVERY):
                raise AssertionError(f"3c: the resumed run launched K1 {row['launches']}")
            if not same(arrays, f32_model.arrays):
                raise AssertionError("3c: the resumed model differs from phase 3's uninterrupted one")
            arrays, row = run("10 sweeps again", base)
            if not any("resuming ALS from iteration 10" in m for m in row["log"]) or \
                    row["launches"]["normal_eq"] != 0 or not same(arrays, f32_model.arrays):
                raise AssertionError(f"3c: the finished run did not short-circuit: {row}")
            bf16_cfg = als.ALSConfig(rank=RANK, iterations=SWEEPS, reg=REG, seed=base.seed,
                                     compute_dtype=BF16)
            arrays, row = run("bf16 config", config=bf16_cfg)
            if not any("different run" in m for m in row["log"]) or \
                    row["launches"]["normal_eq_bf16"] != 2 * SWEEPS or not same(arrays, bf16_model):
                raise AssertionError(f"3c: the bf16 config did not start a fresh run: {row}")
    finally:
        checkpoint.StepCheckpointer.maybe_save = orig_save
        logger.removeHandler(lines)
        logger.setLevel(level)
    stats = {"card": card_line(), "runs": runs,
             "save_s": [s for row in runs for _, s in row["saves"]]}
    print("checkpoint " + json.dumps(stats), flush=True)
    return stats


# --- 3r: delta retraining rounds ---

DELTA_EVENTS = 10_000  # events of a delta round (bench.py:2241)
WARM_SWEEPS = 2  # the warm rounds' sweeps (bench.py:2241, ALSAlgorithmParams.delta_sweeps)
DELTA_RMSE_GAP = 1e-3  # the warm model's RMSE over a cold retrain's (bench.py:2200-2215)
DELTA_UPLOAD_RATIO = 10  # a scatter round uploads at most 10x the delta rows' encoded size
K8_NAMES = ("delta_counts_prefix", "move_and_append", "shift_offsets")


def k8_case(rng, n_users, n_items, nnz, d, int32_ids, f32_vals, weighted, device, one_user=False):
    """Consistent K8 inputs: a resident pack's planes and geometry from a
    random COO of ``nnz`` ratings, and a user-sorted delta of ``d`` rows on
    its existing ids. Returns (planes, du, di, dv, P_new, init_id, lam)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als

    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    counts_u = np.bincount(u, minlength=n_users).astype(np.int32)
    counts_i = np.bincount(i, minlength=n_items).astype(np.int32)
    geo_u = als._segment_geometry(counts_u, n_users, 8, 1, 1 << 22)
    geo_i = als._segment_geometry(counts_i, n_items, 8, 1, 1 << 22)
    P_old = als._bucket_count(nnz)
    id_t, val_t = (np.int32 if int32_ids else np.uint16), (np.float32 if f32_vals else np.int8)
    i_plane = np.full(P_old, n_items, id_t)
    i_plane[:nnz] = rng.integers(0, n_items, nnz)
    v_plane = np.zeros(P_old, val_t)
    v_plane[:nnz] = rng.uniform(0, 5, nnz) if f32_vals else rng.integers(1, 11, nnz)
    users, items = np.flatnonzero(counts_u), np.flatnonzero(counts_i)
    du = np.sort(np.full(d, users[0]) if one_user else rng.choice(users, d)).astype(np.int32)
    di = rng.choice(items, d).astype(id_t)
    dv = (rng.uniform(0, 5, d) if f32_vals else rng.integers(1, 11, d)).astype(val_t)
    P_new = als._bucket_count(nnz + d)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    planes = {
        "i_plane": up(i_plane), "v_plane": up(v_plane),
        "su": up(als.aux_pad(geo_u.starts.astype(np.int32))),
        "si": up(als.aux_pad(geo_i.starts.astype(np.int32))),
        "bu": up(als.aux_pad(geo_u.seg_base.astype(np.int32))),
        "bi": up(als.aux_pad(geo_i.seg_base.astype(np.int32))),
        "seg_rows_u": up(geo_u.seg_rows), "rem_u": up(geo_u.rem),
        "seg_rows_i": up(geo_i.seg_rows), "rem_i": up(geo_i.rem),
    }
    lam = None
    if weighted:
        rows_u, rows_i = np.unique(du).astype(np.int32), np.unique(di.astype(np.int64)).astype(np.int32)
        lam = {
            "lam_u": up(rng.uniform(0.1, 9, als._padded_rows(n_users, 1)).astype(np.float32)),
            "rows_u": up(rows_u), "vals_u": up(rng.uniform(0.1, 9, len(rows_u)).astype(np.float32)),
            "lam_i": up(rng.uniform(0.1, 9, als._padded_rows(n_items, 1)).astype(np.float32)),
            "rows_i": up(rows_i), "vals_i": up(rng.uniform(0.1, 9, len(rows_i)).astype(np.float32)),
        }
    init_id = n_items if P_new > nnz + d else 0
    return planes, up(du), up(di), up(dv), P_new, init_id, lam


def check_k8(args, n_users, n_items, label):
    """K8a, K8b and K8c (``apply_delta``) against their twins on the same
    inputs, every output bit for bit."""
    import torch

    from predictionio_tpu_torch.ops import delta_scatter as k8

    planes, du, di, dv, P_new, init_id, lam = args
    got = k8.apply_delta(planes, du, di, dv, n_users, n_items, P_new, init_id, lam)
    ref = k8.apply_delta(planes, du, di, dv, n_users, n_items, P_new, init_id, lam, plain=True)
    torch.cuda.synchronize()
    if set(got) != set(ref):
        raise AssertionError(f"K8 {label}: outputs {sorted(got)} vs the twins' {sorted(ref)}")
    for name in got:
        if not bits_equal(got[name], ref[name]):
            raise AssertionError(f"K8 {label}: {name} differs from the twins'")


def check_k8_sizes(rng, device):
    """K8 on random packs that reach what the ML-20M rounds do not: int32
    ids and float32 values, plain regularization, old padding dropped past
    P_new, the tail past the moved padding filled, one user's long run, an
    empty delta, and planes of 2M slots."""
    cases = [
        ("uint16/int8, weighted, padding dropped", 300, 150, 1000, 20, False, False, True, False),
        ("int32/float32, plain, tail filled", 500, 70_000, 65_536, 3, True, True, False, False),
        ("one user's run of 600", 50, 40, 5000, 600, False, False, True, True),
        ("an empty delta", 80, 60, 3000, 0, False, True, True, False),
        ("2M slots, weighted", 138_493, 26_744, 2_000_000, 10_000, False, False, True, False),
    ]
    for label, nu, ni, nnz, d, i32, f32, weighted, one in cases:
        args = k8_case(rng, nu, ni, nnz, d, i32, f32, weighted, device, one_user=one)
        check_k8(args, nu, ni, label)
        print(f"  K8 {label}: P {args[0]['i_plane'].shape[0]} -> {args[4]}, d={d}: "
              f"bit-equal to the twins", flush=True)


def k8_bounds(args, n_users, n_items):
    """(bound_ms, bound_by) of K8a, K8b, K8c and the three together: each
    input read once and each output written once (integer copy work)."""
    planes, du, di, dv, P_new, _, lam = args

    def b(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    d_bytes = b(du, di, dv)
    out_a = 4 * 2 * (n_users + 1) + 4 * 2 * (n_items + 1)  # dense and sh, both sides
    plane_slot = planes["i_plane"].element_size() + planes["v_plane"].element_size()
    k8a = b(du, di) + out_a
    k8b = (b(planes["i_plane"], planes["v_plane"], planes["su"]) + 4 * (n_users + 1)
           + d_bytes + P_new * plane_slot)
    lam_in = b(*lam.values()) if lam else 0
    lam_out = b(lam["lam_u"], lam["lam_i"]) if lam else 0
    geo = b(planes["su"], planes["si"], planes["bu"], planes["bi"], planes["seg_rows_u"],
            planes["rem_u"], planes["seg_rows_i"], planes["rem_i"])
    k8c = (geo + out_a + lam_in + b(planes["su"], planes["si"], planes["rem_u"], planes["rem_i"])
           + lam_out)
    return {"delta_counts_prefix": roofline(k8a, 0), "move_and_append": roofline(k8b, 0),
            "shift_offsets": roofline(k8c, 0), "k8": roofline(k8a + k8b + k8c, 0)}


class DeltaStore:
    """The ML-20M ratings as a store that grows by appended deltas, read
    through ColumnarStreams with a cache identity: the base in
    STREAM_BATCH-event batches and each delta as one batch, in one code
    space (code c < n_users is user "u<c>", the next n_items item
    "i<c - n_users>", new ids coded after them); the fingerprint and the
    cursor are the events covered, and ``delta_factory(cursor)`` streams
    the batches after it. The store is its own cache scope."""

    def __init__(self, u, i, r, n_users, n_items, key):
        import numpy as np

        self.key = key
        self.names = [f"u{n}" for n in range(n_users)] + [f"i{n}" for n in range(n_items)]
        self.code = {nm: c for c, nm in enumerate(self.names)}
        t = (i + np.int32(n_users)).astype(np.int32)
        self.batches = [
            (s, (u[s:s + STREAM_BATCH], t[s:s + STREAM_BATCH], r[s:s + STREAM_BATCH]))
            for s in range(0, len(r), STREAM_BATCH)
        ]
        self.events = len(r)

    def code_of(self, name: str) -> int:
        """The code of a user or item id, a new one after every earlier
        code for an id the store has not seen."""
        if name not in self.code:
            self.code[name] = len(self.names)
            self.names.append(name)
        return self.code[name]

    def add(self, e_codes, t_codes, r) -> None:
        self.batches.append((self.events, (e_codes, t_codes, r)))
        self.events += len(r)

    def stream(self, lo: int = 0):
        import numpy as np

        from predictionio_tpu_torch.data.storage.columnar import ColumnarStream

        hi = self.events
        names = np.array(self.names, dtype=object)
        batches = [b for s, b in self.batches if s >= lo]
        s = ColumnarStream(iter(batches), lambda: names, fingerprint=(hi,),
                           cache_key=self.key, cache_scope=self, cursor_fn=lambda: hi)
        s.delta_factory = self.stream
        return s

    def coo(self, user_index, item_index):
        """Every rating as (dense user, dense item, value) in
        ``user_index``/``item_index`` ids (the trained model's)."""
        import numpy as np

        lut = np.array([user_index.get(nm, item_index.get(nm, -1)) for nm in self.names], np.int64)
        e = np.concatenate([b[0] for _, b in self.batches])
        t = np.concatenate([b[1] for _, b in self.batches])
        r = np.concatenate([b[2] for _, b in self.batches])
        return lut[e].astype(np.int32), lut[t].astype(np.int32), r


def existing_delta(cnt_u, cnt_i, L_u, L_i, n):
    """``make_existing_events`` (bench.py:2280): n events on EXISTING ids
    whose counts avoid ``count % L == 0`` (no row crosses a segment
    boundary), half-step ratings; updates the counts."""
    import numpy as np

    users, items = np.flatnonzero(cnt_u), np.flatnonzero(cnt_i)
    e = np.empty(n, np.int32)
    t = np.empty(n, np.int32)
    ui = ii = 0
    for j in range(n):
        while cnt_u[users[ui % len(users)]] % L_u == 0:
            ui += 1
        while cnt_i[items[ii % len(items)]] % L_i == 0:
            ii += 1
        uu, it = int(users[ui % len(users)]), int(items[ii % len(items)])
        cnt_u[uu] += 1
        cnt_i[it] += 1
        ui += 1
        ii += 1
        e[j], t[j] = uu, len(cnt_u) + it
    r = ((np.arange(n) % 10) + 1).astype(np.float32) / 2
    return e, t, r


def wire_identity(w):
    """Everything of a host wire that a cold rescan must reproduce."""
    return (
        w.n_users, w.n_items, w.L_u, w.L_i, w.nibble, w.v_scale, w.iw.dtype.str,
        w.iw.tobytes(), w.vw.dtype.str, w.vw.tobytes(),
        tuple((k, a.tobytes()) for k, a in sorted(w.aux.items())),
        w.counts_u.tobytes(), w.counts_i.tobytes(),
    )


def delta_phase(device):
    """Phase 3r: delta retraining rounds of the recommendation template on
    the ML-20M stream (module docstring). Returns (launches summed over
    the rounds, K8 errors, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import als, streaming
    from predictionio_tpu_torch.ops import delta_scatter as k8
    from predictionio_tpu_torch.ops import device_pack as k5
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2

    n_users, n_items, k = ML20M_USERS, ML20M_ITEMS, RANK
    u, i, r = ml20m_ratings()
    config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, seed=3)
    counters = (k1.LAUNCHES, k2.LAUNCHES, k5.LAUNCHES, k8.LAUNCHES, k12.LAUNCHES)
    cnt_u = np.bincount(u, minlength=n_users).astype(np.int64)
    cnt_i = np.bincount(i, minlength=n_items).astype(np.int64)
    recorded = []
    plain_apply = k8.apply_delta

    def recording(planes, du, di, dv, nu, ni, P_new, init_id, lam=None, plain=False):
        out = plain_apply(planes, du, di, dv, nu, ni, P_new, init_id, lam, plain)
        recorded.append(((dict(planes), du, di, dv, P_new, init_id, lam and dict(lam)), out))
        return out

    rounds = {}

    def run(label, store, want, warm_sweeps=WARM_SWEEPS):
        """One round through train_als_streaming, counted from 0."""
        for c in counters:
            c.reset()
        t = {}
        t0 = time.perf_counter()
        res = streaming.train_als_streaming(store.stream(), config, device=device, timings=t,
                                            warm_sweeps=warm_sweeps)
        wall = time.perf_counter() - t0
        counts = {}
        for c in counters:
            counts.update(c.snapshot())
        for key, v in want.items():
            got = t.get(key) if key in ("pack_cache", "resident") else counts[key]
            if got != v:
                raise AssertionError(f"3r {label}: {key} = {got}, not {v} ({t}, {counts})")
        if any(v for name, v in counts.items() if name.endswith("_plain")):
            raise AssertionError(f"3r {label}: a plain twin ran on the main path: {counts}")
        if not (np.isfinite(res.arrays.user_factors).all() and np.isfinite(res.arrays.item_factors).all()):
            raise AssertionError(f"3r {label}: factors are not finite")
        row = {"wall_s": wall, **{key: t.get(key) for key in (
            "pack_cache", "resident", "delta_events", "delta_scan_s", "fold_exposed_s",
            "device_put_exposed_s", "device_loop_s", "delta_upload_bytes", "warm_sweeps")},
            "resident_bytes": streaming.resident_pack_bytes(),
            "launches": {n: v for n, v in counts.items() if v}}
        rounds[label] = row
        print(f"  {label}: {json.dumps(row)}", flush=True)
        return res, t

    def same(a, b):
        return all(np_bits_equal(x, y) for x, y in
                   ((a.user_factors, b.user_factors), (a.item_factors, b.item_factors)))

    def entry_of(store):
        [entry] = [e for key, e in streaming._PACK_CACHE.items() if key[0] == store.key]
        return entry

    loop_counts = 2 * SWEEPS
    warm_counts = 2 * WARM_SWEEPS
    streaming.pack_cache_clear()
    prev = streaming.set_resident_training(True)
    streaming._k8.apply_delta = recording
    try:
        store = DeltaStore(u, i, r, n_users, n_items, ("ml20m", "resident"))
        # 1. cold: the pack parks on the card
        cold, _ = run("cold", store, {"pack_cache": "miss", "resident": "cold",
                                      "unpack_nibbles": SHIP_CHUNKS, "normal_eq": loop_counts,
                                      "move_and_append": 0})
        if streaming.resident_pack_bytes() <= 0 or not entry_of(store).wire.stripped:
            raise AssertionError("3r cold: no pack was parked on the card")
        entry = entry_of(store)
        L_u, L_i = entry.wire.L_u, entry.wire.L_i
        P = entry.resident.plane_len
        wire_bytes = P * entry.wire.iw.itemsize + (
            P // 2 if entry.wire.nibble else P * entry.resident.v_plane.element_size())
        # 2. hit: the resident planes, no wire upload, the same factors
        hit, t_hit = run("hit", store, {"pack_cache": "hit", "resident": "scatter",
                                        "unpack_nibbles": 0, "device_pack_presorted": 1,
                                        "normal_eq": loop_counts, "move_and_append": 0})
        if not same(hit.arrays, cold.arrays):
            raise AssertionError("3r hit: factors differ from the cold round's")
        if t_hit["delta_upload_bytes"] >= wire_bytes:
            raise AssertionError(f"3r hit: uploaded {t_hit['delta_upload_bytes']} B, a wire's worth")
        # 3. two chained scatter rounds of existing-id deltas
        deltas, scatter = [], []
        for rnd in (1, 2):
            e, t_, rr = existing_delta(cnt_u, cnt_i, L_u, L_i, DELTA_EVENTS)
            deltas.append((e, t_, rr))
            store.add(e, t_, rr)
            res, t = run(f"scatter {rnd}", store, {
                "pack_cache": "fold", "resident": "scatter", "unpack_nibbles": 0,
                "delta_counts_prefix": 1, "move_and_append": 1, "shift_offsets": 1,
                "device_pack_presorted": 1, "device_scatter_pack": 1,
                "normal_eq": warm_counts, "spd_solve": warm_counts})
            scatter.append(res)
            encoded = DELTA_EVENTS * (4 + 2 + 1)
            if t["delta_upload_bytes"] > DELTA_UPLOAD_RATIO * encoded:
                raise AssertionError(f"3r scatter {rnd}: uploaded {t['delta_upload_bytes']} B "
                                     f"for a {encoded} B delta")
            args, out = recorded[-1]
            check_k8(args, n_users, n_items, f"scatter round {rnd}")
            entry = entry_of(store)
            got = wire_identity(streaming._reconstruct_wire(entry))
            u_rel, i_rel, r_all = store.coo(res.user_index, res.item_index)
            cold_wire = als.build_host_wire(u_rel, i_rel, r_all, len(res.user_index),
                                            len(res.item_index), config)
            if got != wire_identity(cold_wire):
                raise AssertionError(f"3r scatter {rnd}: the resident wire differs from build_host_wire")
            print(f"  scatter {rnd}: K8 bit-equal to its twins; the resident wire == "
                  f"build_host_wire(grown store), byte for byte", flush=True)
        # K8 at this shape, on round 2's own inputs
        args, _ = recorded[-1]
        planes, du, di, dv, P_new, init_id, lam = args

        def k8_all(plain=False):
            return plain_apply(planes, du, di, dv, n_users, n_items, P_new, init_id, lam, plain)

        dense_u, dense_i, sh_u, sh_i = k8.delta_counts_prefix(du, di, n_users, n_items)
        calls = {
            "delta_counts_prefix": lambda: k8.delta_counts_prefix(du, di, n_users, n_items),
            "move_and_append": lambda: k8.move_and_append(
                planes["i_plane"], planes["v_plane"], planes["su"], sh_u, du, di, dv,
                n_users, P_new, init_id),
            "shift_offsets": lambda: k8.shift_offsets(
                planes["su"], planes["si"], sh_u, sh_i, dense_u, dense_i, n_users, n_items,
                planes["bu"], planes["bi"], planes["seg_rows_u"], planes["rem_u"],
                planes["seg_rows_i"], planes["rem_i"], *(lam[x] for x in (
                    "lam_u", "rows_u", "vals_u", "lam_i", "rows_i", "vals_i"))),
            "k8": k8_all,
        }
        plains = {
            "delta_counts_prefix": lambda: k8.delta_counts_prefix_plain(du, di, n_users, n_items),
            "move_and_append": lambda: k8.move_and_append_plain(
                planes["i_plane"], planes["v_plane"], planes["su"], sh_u, du, di, dv,
                n_users, P_new, init_id),
            "shift_offsets": lambda: k8.shift_offsets_plain(
                planes["su"], planes["si"], sh_u, sh_i, dense_u, dense_i, n_users, n_items,
                planes["bu"], planes["bi"], planes["seg_rows_u"], planes["rem_u"],
                planes["seg_rows_i"], planes["rem_i"], *(lam[x] for x in (
                    "lam_u", "rows_u", "vals_u", "lam_i", "rows_i", "vals_i"))),
            "k8": lambda: k8_all(plain=True),
        }
        k8_ms = {n: time_ms(f, iters=50, warmup=5) for n, f in calls.items()}
        k8_dev = {n: device_ms(f, calls=20) for n, f in calls.items()}
        k8_plain = {n: time_ms(f, iters=5, warmup=1) for n, f in plains.items()}
        k8_bound = k8_bounds(args, n_users, n_items)
        for c in counters:
            c.reset()
        for n in calls:
            print(f"  {n} (ML-20M pack, d={DELTA_EVENTS}): kernel {k8_ms[n]:.4f} ms, device "
                  f"{k8_dev[n]:.4f}, plain {k8_plain[n]:.3f}, bound {k8_bound[n][0]:.4f} "
                  f"({k8_bound[n][1]})", flush=True)
        del recorded[:], planes, du, di, dv, lam, args

        # 5. the same data with residency off: the host fold, bit for bit
        streaming.set_resident_training(False)
        host = DeltaStore(u, i, r, n_users, n_items, ("ml20m", "host"))
        hcold, _ = run("host cold", host, {"pack_cache": "miss", "normal_eq": loop_counts})
        if not same(hcold.arrays, cold.arrays):
            raise AssertionError("3r host cold: factors differ from the resident cold round's")
        for rnd, (e, t_, rr) in enumerate(deltas, 1):
            host.add(e, t_, rr)
            hres, _ = run(f"host fold {rnd}", host, {
                "pack_cache": "fold", "unpack_nibbles": SHIP_CHUNKS, "move_and_append": 0,
                "normal_eq": warm_counts})
            if not same(hres.arrays, scatter[rnd - 1].arrays):
                raise AssertionError(f"3r host fold {rnd}: factors differ from scatter round {rnd}'s")
        print("  host folds: factors bit-equal to the scatter rounds'", flush=True)
        # 6. a cold 10-sweep retrain of the grown store, and the RMSE gap
        u_rel, i_rel, r_all = store.coo(hres.user_index, hres.item_index)
        t0 = time.perf_counter()
        retrain = als.train_als(u_rel, i_rel, r_all, len(hres.user_index), len(hres.item_index),
                                config, device=device)
        retrain_s = time.perf_counter() - t0
        rmse_warm = als.rmse(scatter[-1].arrays, u_rel, i_rel, r_all, device=device)
        rmse_cold = als.rmse(retrain, u_rel, i_rel, r_all, device=device)
        gap = rmse_warm - rmse_cold
        print(f"  cold retrain of the grown store: {retrain_s:.2f} s; RMSE warm {rmse_warm:.6f}, "
              f"cold {rmse_cold:.6f}, gap {gap:.3g}", flush=True)
        if gap > DELTA_RMSE_GAP:
            raise AssertionError(f"3r: the warm model's RMSE is {gap} over a cold retrain's")
        del host, hcold, hres, retrain
        streaming.set_resident_training(True)

        # 4. a random delta with new ids: the pack falls back to the host
        drng = np.random.default_rng(23)
        nu2 = int(n_users * 1.01)
        du_new = drng.integers(0, nu2, DELTA_EVENTS)
        di_new = drng.integers(0, n_items, DELTA_EVENTS)
        e = np.array([store.code_of(f"u{x}") for x in du_new], np.int32)
        t_ = (di_new + n_users).astype(np.int32)
        store.add(e, t_, (drng.integers(1, 11, DELTA_EVENTS) / 2).astype(np.float32))
        run("fallback", store, {"pack_cache": "fold", "resident": "fallback",
                                "unpack_nibbles": SHIP_CHUNKS, "move_and_append": 0,
                                "normal_eq": warm_counts})
        if streaming.resident_pack_bytes() != 0:
            raise AssertionError("3r fallback: the pack was not released")
        t0 = time.perf_counter()
        rescan = streaming._scan_and_pack(store.stream(), config, {}, device)
        rescan[3]()
        rescan_s = time.perf_counter() - t0
        rescan_id = wire_identity(rescan[0])
        if wire_identity(entry_of(store).wire) != rescan_id:
            raise AssertionError("3r fallback: the folded wire differs from a cold rescan's")
        print(f"  fallback: the host-folded wire == a cold rescan's ({rescan_s:.2f} s), byte for byte",
              flush=True)
        # 7. a hit parks the pack again; release restores the host wire
        run("re-park", store, {"pack_cache": "hit", "resident": "cold",
                               "unpack_nibbles": SHIP_CHUNKS, "normal_eq": loop_counts})
        parked = streaming.resident_pack_bytes()
        released = streaming.release_resident_packs()
        entry = entry_of(store)
        if (released, streaming.resident_pack_bytes()) != (1, 0) or entry.wire.stripped:
            raise AssertionError(f"3r release: {released} released, {streaming.resident_pack_bytes()} B left")
        if wire_identity(entry.wire) != rescan_id:
            raise AssertionError("3r release: the restored host wire differs from a cold rescan's")
        print(f"  release: 1 pack ({parked} B) released, 0 B resident, the host wire restored "
              f"byte for byte", flush=True)
    finally:
        streaming._k8.apply_delta = plain_apply
        streaming.set_resident_training(prev)
        streaming.pack_cache_clear()

    stats = {
        "card": card_line(),
        "rounds": rounds,
        "cold_retrain_s": retrain_s,
        "rmse": {"warm": rmse_warm, "cold": rmse_cold, "gap": gap},
        "delta_encoded_bytes": DELTA_EVENTS * (4 + 2 + 1),
        "kernel_ms": k8_ms, "device_ms": k8_dev, "plain_ms": k8_plain, "bound": k8_bound,
    }
    print("delta_training " + json.dumps(stats), flush=True)
    # launches over every round, for the kernels line (K8 runs only in the
    # scatter rounds)
    launches = {
        name: sum(row["launches"].get(name, 0) for row in rounds.values())
        for name in K8_NAMES + ("normal_eq", "spd_solve", "gramian", "implicit_objective")
    }
    return launches, {n: 0.0 for n in K8_NAMES}, stats


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for b, e in sorted(intervals):
        if e > reach:
            total += e - max(b, reach)
            reach = e
    return total


def rss_mb() -> float:
    """This process's resident set now, in MB (Linux /proc)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url, body=None, timeout=60.0):
    req = urllib.request.Request(
        url, data=body, method="POST" if body is not None else "GET",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    try:
        return json.loads(raw)
    except ValueError:
        return raw.decode()


class Deployment:
    """``tools.cli deploy --model path --device cuda`` (max_batch 128, 2 ms
    window, plus ``extra`` arguments) on a thread of this process, up and
    answering on ``port``."""

    def __init__(self, path, device, extra=()):
        from predictionio_tpu_torch.tools import cli

        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.failure = []

        def serve():
            try:
                cli.main([
                    "deploy", "--model", path, "--ip", "127.0.0.1",
                    "--port", str(self.port), "--device", str(device),
                    "--max-batch", "128", "--batch-window-ms", "2.0", *extra,
                ])
            except BaseException as e:  # reported by the main thread
                self.failure.append(e)

        t0 = time.perf_counter()
        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 300
        while True:
            if self.failure:
                raise RuntimeError("deploy failed") from self.failure[0]
            try:
                http_json(self.base + "/status.json", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError):
                if time.monotonic() > deadline:
                    raise RuntimeError("server did not come up within 300 s")
                time.sleep(0.2)
        self.deploy_s = time.perf_counter() - t0

    def status(self):
        return http_json(self.base + "/status.json")

    def query(self, body):
        return http_json(self.base + "/queries.json", json.dumps(body).encode())

    def send(self, bodies, n_clients=32):
        """POST every body from ``n_clients`` concurrent clients, each on
        one keep-alive connection; returns ([(i, latency_s, answer)], wall
        seconds)."""
        def client(c):
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
            out = []
            try:
                for i in range(c, len(bodies), n_clients):
                    t = time.perf_counter()
                    conn.request("POST", "/queries.json", json.dumps(bodies[i]),
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    raw = resp.read()
                    if resp.status != 200:
                        raise AssertionError(f"query {i}: HTTP {resp.status} {raw!r}")
                    out.append((i, time.perf_counter() - t, json.loads(raw)))
            finally:
                conn.close()
            return out

        t_start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(n_clients) as pool:
            answers = [a for part in pool.map(client, range(n_clients)) for a in part]
        return sorted(answers, key=lambda a: a[0]), time.perf_counter() - t_start

    def stop(self):
        try:
            http_json(self.base + "/stop")
        except (urllib.error.URLError, ConnectionError):
            pass
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("server did not stop after GET /stop")
        if self.failure:
            raise RuntimeError("server failed") from self.failure[0]


def latency_stats(answers, wall):
    import numpy as np

    lat = np.sort([a[1] for a in answers]) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "qps": len(answers) / wall}


def slice_phase(rng, device, workdir, model):
    """Serve the trained model through the CLI; returns (K3 launches on
    the main path, serving stats, the traffic and its answers for the
    quantized deployments)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops.topn import (
        LAUNCHES,
        check_topn_agreement,
        topn_packed_plain,
    )
    from predictionio_tpu_torch.utils.serialize import save_model

    uf, itf = model.arrays.user_factors, model.arrays.item_factors
    user_of_row = model.user_index.inverse()
    unrated = np.flatnonzero(~uf.any(axis=1))
    path = os.path.join(workdir, "ml20m_trained.npz")
    save_model(path, model)

    server = Deployment(path, device)
    print(f"  deploy (load, upload, warm, bind): {server.deploy_s:.2f} s", flush=True)
    try:
        # the main path: counts start at 0 here, after deploy's warm-up
        LAUNCHES.reset()
        n_queries, n_clients = 320, 32
        users = [user_of_row[int(row)] for row in rng.integers(0, len(uf), size=n_queries)]
        nums = np.where(rng.random(n_queries) < 0.85, 10, rng.integers(1, 41, size=n_queries))
        picked = rng.choice(n_queries, size=12, replace=False).tolist()
        unknown_at = set(picked[:4])
        for i in unknown_at:
            users[i] = f"nobody{i}"
        # users without ratings: zero factors, every item ties at 0
        unrated_at = set(picked[4:4 + min(8, len(unrated))])
        for i, row in zip(sorted(unrated_at), unrated):
            users[i] = user_of_row[int(row)]
        bodies = [{"user": users[i], "num": int(nums[i])} for i in range(n_queries)]
        answers, wall = server.send(bodies, n_clients)
        status = server.status()
        counts = LAUNCHES.snapshot()
        # one launch per served batch, except a batch of unknown users only
        # (at most one such batch per unknown query)
        batches = status["batches"]
        if not batches - len(unknown_at) <= counts["topn_packed"] <= batches or batches < 1:
            raise AssertionError(
                f"K3 launched {counts['topn_packed']} times for {batches} "
                f"served batches ({len(unknown_at)} unknown-user queries)"
            )
        launches, fill = counts["topn_packed"], status["batchFillMean"]
        server_avg_ms = status["avgServingSec"] * 1e3
        if status["servingPrecision"] != ["float32"]:
            raise AssertionError(f"servingPrecision {status['servingPrecision']}")

        # unknown users one at a time: each is a batch of its own, which
        # must not launch K3
        check_unknown_users(server, LAUNCHES, "topn_packed", batches)
        if LAUNCHES.snapshot()["topn_packed_plain"] != 0:
            raise AssertionError("the plain twin ran on the serving path")
    finally:
        server.stop()

    # every answer against the plain twin on the card
    Yd = torch.from_numpy(itf).to(device)
    rows = [0 if i in unknown_at else model.user_index[users[i]] for i in range(n_queries)]
    q_np = uf[rows]
    ref = topn_packed_plain(torch.from_numpy(q_np).to(device), Yd, 40).cpu().numpy()
    ref_s, ref_i = ref[:, :40], ref[:, 40:].copy().view(np.int32)
    for i, _, res in answers:
        num = int(nums[i])
        if res.get("modelVersion") != "ml20m_trained":
            raise AssertionError(f"modelVersion {res.get('modelVersion')!r}")
        items = res["itemScores"]
        if i in unknown_at:
            if items != []:
                raise AssertionError(f"unknown user {users[i]!r} got {items}")
            continue
        if len(items) != num:
            raise AssertionError(f"query {i}: {len(items)} items for num={num}")
        got_i = np.array([[model.item_index[x["item"]] for x in items]])
        got_s = np.array([[x["score"] for x in items]])
        if i in unrated_at and got_i[0].tolist() != list(range(num)):
            raise AssertionError(f"user without ratings {users[i]!r} got {got_i[0]}")
        check_topn_agreement(got_s, got_i, ref_s[i:i + 1, :num], ref_i[i:i + 1, :num],
                             RTOL, ATOL, q=q_np[i:i + 1], Y=itf)
    stats = {
        "queries": n_queries, "clients": n_clients, **latency_stats(answers, wall),
        "batches": batches, "batch_fill_mean": fill, "server_avg_ms": server_avg_ms,
        "unrated_queries": len(unrated_at),
        "k3_launches": counts["topn_packed"],
        "plain_launches": counts["topn_packed_plain"],
        "card": card_line(),
    }
    print("serving " + json.dumps(stats), flush=True)
    traffic = {"bodies": bodies, "answers": answers, "unknown_at": unknown_at,
               "unrated_at": unrated_at}
    return counts["topn_packed"], stats, traffic


def check_unknown_users(server, counts, name, batches):
    """Unknown users one at a time: each is a batch of its own, which must
    answer empty and launch no kernel (``counts[name]`` unchanged)."""
    before = counts.snapshot()[name]
    unknown = ["nobody", "u-1", f"u{ML20M_USERS}", "i0"]
    for u in unknown:
        res = server.query({"user": u, "num": 10})
        if res.get("itemScores") != []:
            raise AssertionError(f"unknown user {u!r} got {res}")
    status = server.status()
    if counts.snapshot()[name] != before:
        raise AssertionError(f"a batch of unknown users launched {name}")
    if status["batches"] != batches + len(unknown):
        raise AssertionError(f"unexpected batch count {status['batches']}")


PEAK_INT8_OPS = 1979e12
RET_ITEMS, RET_RANK, RET_SEED = 50_000, 64, 37
TIER_PEAK = {"float32": PEAK_FP32_FLOPS, "bf16": PEAK_BF16_FLOPS, "int8": PEAK_INT8_OPS}
TIER_BYTES = {"float32": 4, "bf16": 2, "int8": 1}


def quantized_catalog(n_items=RET_ITEMS, rank=RET_RANK, seed=RET_SEED):
    """The bench's quantized catalog (a copy of ``bench.py:3044-3050``):
    clustered rows, so near-duplicates crowd every top-n boundary."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.standard_normal((256, rank)).astype(np.float32)
    return (
        base[rng.integers(0, 256, n_items)]
        + 0.3 * rng.standard_normal((n_items, rank))
    ).astype(np.float32)


def check_ranked(got, ref, label, exact=False):
    """Two packed [B, 2m] results: the same dead (-inf) slots with the same
    ids, and the live prefix equal (``exact``) or within RTOL/ATOL with ids
    equal outside near-tie runs. Returns the largest score difference."""
    import numpy as np

    from predictionio_tpu_torch.ops.retrieval import unpack_topn
    from predictionio_tpu_torch.ops.topn import check_topn_agreement

    m = got.shape[1] // 2
    gs, gi = unpack_topn(got.cpu().numpy(), m)
    rs, ri = unpack_topn(ref.cpu().numpy(), m)
    if exact:
        if not (np.array_equal(gs.view(np.uint32), rs.view(np.uint32)) and np.array_equal(gi, ri)):
            raise AssertionError(f"{label}: not bit-equal to the plain twin")
        return 0.0
    live = np.isfinite(rs)
    if not np.array_equal(np.isfinite(gs), live) or not np.array_equal(
            np.where(live, 0, gi), np.where(live, 0, ri)):
        raise AssertionError(f"{label}: dead slots differ from the plain twin")
    err = 0.0
    for r in range(rs.shape[0]):
        k = int(live[r].sum())
        if k:
            err = max(err, check_topn_agreement(gs[r:r + 1, :k], gi[r:r + 1, :k],
                                                rs[r:r + 1, :k], ri[r:r + 1, :k], RTOL, ATOL))
    return err


def retriever_operands(r, q_np, exclude, include, device):
    """The device operands one ItemRetriever.topn batch builds."""
    import torch

    from predictionio_tpu_torch.utils.shapes import pad_rows_pow2

    qp = pad_rows_pow2(q_np, 8)
    b, b_pad = q_np.shape[0], qp.shape[0]
    excl, _ = r._assemble_idx(list(exclude) + [None] * (b_pad - b), b_pad)
    incl, has = r._assemble_idx(list(include) + [None] * (b_pad - b), b_pad)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(qp), t(excl), t(incl), t(has)


def check_retriever_kernels(r, q_np, n, exclude, include, positive_only, normalize, device, label,
                            errs, exact=False):
    """Kernel A (mask, then score/select) and, for a quantized tier, kernel
    B against their twins on the card, on one ItemRetriever batch; bit for
    bit where ``exact`` (or, for kernel A, in int8)."""
    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops import rescore as kb

    q, excl, incl, has = retriever_operands(r, q_np, exclude, include, device)
    bits = ka.candidate_mask(r._allow_dev, excl, incl, has)
    bits_ref = ka.candidate_mask_plain(r._allow_dev, excl, incl, has)
    if not bits_equal(bits, bits_ref):
        raise AssertionError(f"candidate_mask {label}: differs from its twin")
    rn = r._rn_dev if normalize else None
    quant = r.precision != "float32"
    n_dev = r._shortlist_width(n, r.n_items) if quant else n
    m = r._shortlist_width(n_dev, r._n_pad) if quant else n
    args = (q, r._y_dev, r._scale_dev, rn, bits, m, positive_only, normalize)
    s1 = ka.masked_topn_packed(*args)
    s1_ref = ka.masked_topn_plain(*args)
    e = check_ranked(s1, s1_ref, f"masked_topn {label}", exact=exact or r.precision == "int8")
    errs["masked_topn"] = max(errs.get("masked_topn", 0.0), e)
    errs.setdefault("candidate_mask", 0.0)
    if quant:
        args2 = (q, r._y_dev, r._scale_dev, rn, s1, n_dev, positive_only, normalize)
        e2 = check_ranked(kb.rescore_topn(*args2), kb.rescore_topn_plain(*args2),
                          f"rescore_topn {label}", exact=exact)
        errs["rescore_topn"] = max(errs.get("rescore_topn", 0.0), e2)
    return bits, s1


def retrieval_kernel_phase(rng, device):
    """R1: kernel A (candidate_mask, masked_topn) and kernel B (rescore_topn)
    against their twins on the card, on the bench's 50,000 x 64 quantized
    catalog and edge shapes; the bench's own gates through ItemRetriever;
    times at the catalog's shapes. Returns (max errors, timing rows)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops.retrieval import ItemRetriever

    Y = quantized_catalog()
    N, k = Y.shape
    resident = rng.choice(N, size=500, replace=False)
    retrievers = {}
    for prec in ("float32", "bf16", "int8"):
        r = ItemRetriever(Y, device=device, precision=prec, component=f"r1-{prec}")
        r.set_excluded_ids(resident)
        retrievers[prec] = r
    errs = {}
    n = 16
    for B in (8, 64, 128):
        for ew in (1, 16, 64):
            q_np = rng.standard_normal((B, k)).astype(np.float32)
            exclude = [rng.choice(N, size=ew, replace=False) for _ in range(B)]
            include = [None] * B
            include[0] = np.zeros(0, np.int64)  # an empty include: no candidates
            include[1 % B] = np.sort(rng.choice(N, size=N // 10, replace=False))
            include[B // 2] = np.arange(7)  # fewer live candidates than n
            for prec, r in retrievers.items():
                for po, nz in ((False, False), (True, False), (True, True)):
                    check_retriever_kernels(r, q_np, n, exclude, include, po, nz, device,
                                            f"{prec} B={B} excl={ew} po={po} nz={nz}", errs)
        print(f"  B={B}: 3 tiers x 3 flag pairs x exclude widths 1/16/64, resident "
              f"exclusion of 500, include lists (one empty): kernels equal their twins "
              f"(int8 bit for bit)", flush=True)
    # edge shapes: n = 1; a ragged catalog smaller than the shortlist;
    # exact ties from duplicated rows; zero query rows (items 0..n-1)
    ties = rng.integers(-3, 4, size=(700, 8)).astype(np.float32)
    ties = np.concatenate([ties, ties, ties[:211]])
    edges = [("n=1", Y, 1, rng.standard_normal((8, k)).astype(np.float32)),
             ("n=40 (quantized shortlist 1,024: a two-level merge)", Y, 40,
              rng.standard_normal((8, k)).astype(np.float32)),

             ("ragged N=40 < shortlist", Y[:40, :10].copy(), 16,
              rng.standard_normal((5, 10)).astype(np.float32)),
             ("exact ties", ties, 40, rng.integers(-3, 4, size=(16, 8)).astype(np.float32)),
             ("zero query rows", Y, 16, np.zeros((8, k), np.float32))]
    for label, Yc, nn, q_np in edges:
        for prec in ("float32", "bf16", "int8"):
            r = ItemRetriever(Yc, device=device, precision=prec, component="r1-edge")
            for po, nz in ((False, False), (True, True)):
                check_retriever_kernels(r, q_np, nn, [None] * len(q_np), [None] * len(q_np),
                                        po, nz, device, f"{label} {prec}", errs)
                if label == "zero query rows" and not po:
                    _, idx = r.topn(q_np, nn, normalize=nz)
                    if not (idx == np.arange(nn)).all():
                        raise AssertionError(f"zero query rows ({prec}) got {idx[0]}")
            r.free()
        print(f"  {label}: every tier equal to its twins", flush=True)
    # n = N over integer rows, each with one entry of magnitude 127: every
    # tier's rows and query are then exact (int8 scale 1, bf16 integers),
    # every sum an exact integer, so kernels and twins agree bit for bit
    # whatever their summation order. 20,000 rows: the merge of 79 lists of
    # 256 and kernel B's sort of 32,768 keys both run in device memory.
    Yi = rng.integers(-20, 21, size=(20_000, 8)).astype(np.float32)
    Yi[np.arange(len(Yi)), rng.integers(0, 8, len(Yi))] = rng.choice([-127.0, 127.0], len(Yi))
    qi = rng.integers(-20, 21, size=(4, 8)).astype(np.float32)
    qi[:, 0] = 127.0
    for prec in ("float32", "bf16", "int8"):
        r = ItemRetriever(Yi, device=device, precision=prec, component="r1-wide")
        for po, nz in ((False, False), (True, True)):
            check_retriever_kernels(r, qi, len(Yi), [None] * 4, [None] * 4, po, nz, device,
                                    f"n=N wide {prec}", errs, exact=True)
        r.free()
    print("  n=N=20,000 (device-memory merge, kernel B's device-memory sort): every tier "
          "bit-equal to its twins", flush=True)

    # the bench's gates (bench.py bench_retrieval_quantized), on the card
    exact = ItemRetriever(Y, device=device, component="bench-exact")
    gates = {}
    for prec in ("int8", "bf16"):
        quant = ItemRetriever(Y, device=device, precision=prec, component="bench-quant")
        grng = np.random.default_rng(RET_SEED + 1)
        hits = total = parity_fail = 0
        for _ in range(8):
            q = grng.standard_normal((64, k)).astype(np.float32)
            _, ei = exact.topn(q, 10)
            qs, qi = quant.topn(q, 10)
            for row in range(64):
                hits += len(set(ei[row].tolist()) & set(qi[row].tolist()))
                total += 10
                if not np.allclose(qs[row], Y[qi[row]] @ q[row], rtol=1e-5, atol=1e-5):
                    parity_fail += 1
        recall = hits / total
        reduction = exact.resident_bytes / quant.resident_bytes
        if recall < 0.999 or parity_fail:
            raise AssertionError(f"{prec}: recall@10 {recall}, {parity_fail} score-parity failures")
        if prec == "int8" and reduction < 3.0:
            raise AssertionError(f"int8 resident-bytes reduction {reduction} < 3")
        gates[prec] = {"recall_at_10": recall, "score_parity_failures": parity_fail,
                       "bytes_reduction_x": reduction,
                       "bytes_per_item": quant.resident_bytes / N}
        quant.free()
    gates["float32_bytes_per_item"] = exact.resident_bytes / N
    exact.free()
    print("retrieval_gates " + json.dumps(gates), flush=True)

    rows = []
    for B in (8, 64, 128):
        q_np = rng.standard_normal((B, k)).astype(np.float32)
        for prec, r in retrievers.items():
            rows.append(time_retriever_kernels(r, q_np, 16, False, False, device,
                                               {"catalog": "quantized 50,000 x 64"}))
    for r in retrievers.values():
        r.free()
    print("retrieval_timing " + json.dumps(rows), flush=True)
    return errs, rows


def time_retriever_kernels(r, q_np, n, positive_only, normalize, device, extra):
    """Each kernel of one ItemRetriever batch, its twin and its library
    yardstick, by CUDA events (``time_ms``) and on the card alone
    (``device_ms``), beside its bound."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops import rescore as kb

    q, excl, incl, has = retriever_operands(r, q_np, [None] * len(q_np), [None] * len(q_np), device)
    B, k = q.shape
    N = r._n_pad
    rn = r._rn_dev if normalize else None
    quant = r.precision != "float32"
    n_dev = r._shortlist_width(n, r.n_items) if quant else n
    m = r._shortlist_width(n_dev, N) if quant else n
    bits = ka.candidate_mask(r._allow_dev, excl, incl, has)
    a_args = (q, r._y_dev, r._scale_dev, rn, bits, m, positive_only, normalize)
    s1 = ka.masked_topn_packed(*a_args)
    W = ka.mask_words(N)
    row = {"precision": r.precision, "B": B, "N": N, "k": k, "n": n, "m": m, **extra}
    mask_call = lambda: ka.candidate_mask(r._allow_dev, excl, incl, has)
    row["candidate_mask"] = {
        "ms": time_ms(mask_call), "device_ms": device_ms(mask_call, calls=200),
        "plain_ms": time_ms(lambda: ka.candidate_mask_plain(r._allow_dev, excl, incl, has), iters=20),
        "bound": roofline(N + 4 * B * (excl.shape[1] + incl.shape[1]) + B + 4 * B * W, 0),
        "library_ms": None,
    }
    a_call = lambda: ka.masked_topn_packed(*a_args)
    a_bytes = 4 * B * k + TIER_BYTES[r.precision] * N * k + (4 * N if r.precision == "int8" else 0) \
        + (4 * N if normalize else 0) + 4 * B * W + 8 * B * m
    row["masked_topn"] = {
        "ms": time_ms(a_call), "device_ms": device_ms(a_call, calls=100),
        "plain_ms": time_ms(lambda: ka.masked_topn_plain(*a_args), iters=20),
        "bound": roofline(a_bytes, 2 * B * N * k, TIER_PEAK[r.precision]),
        "library_ms": library_topn_ms(r, q, m),
    }
    if quant:
        b_args = (q, r._y_dev, r._scale_dev, rn, s1, n_dev, positive_only, normalize)
        b_call = lambda: kb.rescore_topn(*b_args)
        b_bytes = 4 * B * k + B * m * k * TIER_BYTES[r.precision] + 8 * B * m + 8 * B * n_dev \
            + (4 * B * m if r.precision == "int8" else 0) + (4 * B * m if normalize else 0)
        row["rescore_topn"] = {
            "ms": time_ms(b_call), "device_ms": device_ms(b_call, calls=100),
            "plain_ms": time_ms(lambda: kb.rescore_topn_plain(*b_args), iters=20),
            "bound": roofline(b_bytes, 2 * B * m * k),
            "library_ms": None,
        }
    row["card"] = card_line()
    return row


def library_topn_ms(r, q, m):
    """One PyTorch call for kernel A's function in its tier, the
    yardstick (the port never calls it): f32 ``topk(where(mask, q @ Y.T,
    -inf), m)``; int8 ``torch._int_mm`` of the quantized query, the
    epilogue and ``topk``; bf16 ``q.bfloat16() @ Y.T`` and ``topk``. None
    where the call is refused on this card (printed)."""
    import torch

    Y, allow = r._y_dev, r._allow_dev
    if r.precision == "float32":
        ninf = torch.tensor(float("-inf"), device=q.device)
        fn = lambda: torch.topk(torch.where(allow, q @ Y.T, ninf), m)
    elif r.precision == "bf16":
        fn = lambda: torch.topk(q.to(torch.bfloat16) @ Y.T, m)
    else:
        scale = r._scale_dev

        def fn():
            qs = q.abs().amax(dim=1) / 127.0
            qs = torch.where(qs > 0, qs, torch.ones_like(qs))
            qi = torch.clamp(torch.round(q / qs[:, None]), -127, 127).to(torch.int8)
            acc = torch._int_mm(qi, Y.T)
            return torch.topk(acc.to(torch.float32) * qs[:, None] * scale[None, :], m)
    try:
        return time_ms(fn, iters=50)
    except RuntimeError as e:
        print(f"  library yardstick for {r.precision} at B={q.shape[0]} refused: {e}", flush=True)
        return None


@contextlib.contextmanager
def plain_retrieval_kernels():
    """ItemRetriever driven by its kernels' plain twins, on whatever device
    its tensors are on (the twins count no launches)."""
    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops import rescore as kb
    from predictionio_tpu_torch.ops import retrieval

    saved = (retrieval.candidate_mask, retrieval.masked_topn_packed, retrieval.rescore_topn)
    retrieval.candidate_mask = ka.candidate_mask_plain
    retrieval.masked_topn_packed = ka.masked_topn_plain
    retrieval.rescore_topn = kb.rescore_topn_plain
    try:
        yield
    finally:
        (retrieval.candidate_mask, retrieval.masked_topn_packed, retrieval.rescore_topn) = saved


def retrieval_counts():
    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops import rescore as kb
    from predictionio_tpu_torch.ops import topn as k3

    return (ka.LAUNCHES, kb.LAUNCHES, k3.LAUNCHES)


def snapshot(counters):
    out = {}
    for c in counters:
        out.update(c.snapshot())
    return out


def check_retrieval_launches(counts, batches, n_unknown, quantized, label):
    """Kernel A (mask and select) once per served batch that held a known
    query (a batch of unknown queries only launches nothing), kernel B as
    often on a quantized deployment and never otherwise, K3 and every twin
    never."""
    a = counts["masked_topn"]
    if not batches - n_unknown <= a <= batches or batches < 1:
        raise AssertionError(f"{label}: masked_topn launched {a} times for {batches} batches")
    if counts["candidate_mask"] != a or counts["rescore_topn"] != (a if quantized else 0):
        raise AssertionError(f"{label}: launches {counts}")
    if counts["topn_packed"] or any(v for name, v in counts.items() if name.endswith("_plain")):
        raise AssertionError(f"{label}: K3 or a plain twin ran: {counts}")


def quantized_serving_phase(rng, device, workdir, model, traffic):
    """R2: the trained model saved with precision int8 and bf16, each
    deployed through the CLI and sent the float32 deployment's traffic;
    every answer held against the float32 deployment's; kernels A and B
    held against their twins at the path's shapes. Returns (launches per
    deployment, stats, kernel timing row at the path's shape, the
    kernels' largest errors there, each deployment's answers)."""
    import dataclasses

    import numpy as np

    from predictionio_tpu_torch.models.recommendation.engine import ALSModel
    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops.retrieval import ItemRetriever
    from predictionio_tpu_torch.ops.topn import check_topn_agreement
    from predictionio_tpu_torch.utils.serialize import save_model

    counters = retrieval_counts()
    unknown_at, unrated_at = traffic["unknown_at"], traffic["unrated_at"]
    f32 = {i: res["itemScores"] for i, _, res in traffic["answers"]}
    launches, stats, served = {}, {}, {}
    for prec in ("int8", "bf16"):
        qmodel = ALSModel(arrays=model.arrays, user_index=model.user_index,
                          item_index=model.item_index,
                          params=dataclasses.replace(model.params, precision=prec))
        name = f"ml20m_{prec}"
        path = os.path.join(workdir, f"{name}.npz")
        save_model(path, qmodel)
        server = Deployment(path, device)
        try:
            for c in counters:
                c.reset()
            answers, wall = server.send(traffic["bodies"])
            status = server.status()
            counts = snapshot(counters)
            batches = status["batches"]
            check_retrieval_launches(counts, batches, len(unknown_at), True, name)
            if status["servingPrecision"] != [prec]:
                raise AssertionError(f"{name}: servingPrecision {status['servingPrecision']}")
            check_unknown_users(server, ka.LAUNCHES, "masked_topn", batches)
        finally:
            server.stop()
        for i, _, res in answers:
            got, ref = res["itemScores"], f32[i]
            if res.get("modelVersion") != name:
                raise AssertionError(f"modelVersion {res.get('modelVersion')!r}")
            if len(got) != len(ref) or (i in unknown_at and got):
                raise AssertionError(f"{name} query {i}: {len(got)} items, float32 gave {len(ref)}")
            got_i = np.array([[model.item_index[x["item"]] for x in got]])
            if i in unrated_at and got_i[0].tolist() != list(range(len(got))):
                raise AssertionError(f"{name}: user without ratings got {got_i[0]}")
            if got:
                check_topn_agreement(
                    np.array([[x["score"] for x in got]]), got_i,
                    np.array([[x["score"] for x in ref]]),
                    np.array([[model.item_index[x["item"]] for x in ref]]), RTOL, ATOL)
        launches[prec] = counts
        served[prec] = answers
        stats[prec] = {"queries": len(answers), **latency_stats(answers, wall),
                       "batches": batches, "batch_fill_mean": status["batchFillMean"],
                       "server_avg_ms": status["avgServingSec"] * 1e3,
                       "deploy_s": server.deploy_s, "launches": counts}
        print(f"  {name}: {len(answers)} answers equal the float32 deployment's "
              f"(ids outside near-tie runs, scores rtol {RTOL}); launches {counts}", flush=True)
    stats["card"] = card_line()
    print("quantized_serving " + json.dumps(stats), flush=True)
    # the kernels against their twins at this path's shapes: the trained
    # catalog in each tier as the deployment holds it, user rows at the
    # usual and the full batch, num=10's n=16 and the deployment's flags
    uf, itf = model.arrays.user_factors, model.arrays.item_factors
    errs = {}
    for prec in ("int8", "bf16"):
        r = ItemRetriever(itf, device=device, precision=prec,
                          shortlist_mult=model.params.shortlist_mult)
        for B in (8, 128):
            q_np = uf[rng.integers(0, len(uf), B)]
            check_retriever_kernels(r, q_np, 16, [None] * B, [None] * B, False, False, device,
                                    f"ML-20M {prec} B={B}", errs)
        r.free()
    print(f"  ML-20M catalog, B=8 and 128, n=16: kernel A equal to its twin (int8 bit for "
          f"bit), kernel B within rtol {RTOL} / atol {ATOL}; errors {errs}", flush=True)
    # the kernels' times at this path's shape: a full batch
    r = ItemRetriever(itf, device=device, precision="int8")
    q_np = uf[rng.integers(0, len(uf), 128)]
    row = time_retriever_kernels(r, q_np, 16, False, False, device,
                                 {"catalog": "ML-20M items, trained"})
    r.free()
    print("retrieval_path_timing " + json.dumps(row), flush=True)
    print("batch_wall " + json.dumps(batch_wall_ms(rng, device, uf, itf)), flush=True)
    return launches, stats, row, errs, served


def batch_wall_ms(rng, device, uf, itf):
    """One serving batch's wall time on the host clock (upload, kernels,
    the result's copy back and, for a quantized tier, the host refinement),
    median of 50 after a warm-up, at B=8 (the served batches' usual size)
    and B=128: K3 through ServingFactors, and ItemRetriever in each tier."""
    import numpy as np

    from predictionio_tpu_torch.ops.als import ServingFactors
    from predictionio_tpu_torch.ops.retrieval import ItemRetriever

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(50):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return float(np.median(times) * 1e3)

    sf = ServingFactors(uf, itf, device=device)
    retrievers = {p: ItemRetriever(itf, device=device, precision=p) for p in ("float32", "bf16", "int8")}
    out = {"card": card_line()}
    for B in (8, 128):
        q = uf[rng.integers(0, len(uf), B)]
        out[f"B={B}"] = {"k3_serving_factors": median_ms(lambda: sf.topn_by_rows(q, 16)),
                         **{f"retriever_{p}": median_ms(lambda: r.topn(q, 16))
                            for p, r in retrievers.items()}}
    for r in retrievers.values():
        r.free()
    return out


def similarproduct_phase(rng, device, workdir, model):
    """R3: the trained item factors carried into a Similar Product model
    with seeded categories, saved, deployed through the CLI and sent 320
    queries; every answer held against the same retriever driven by the
    plain twins on the card. Returns (launches, stats, the deployment: its
    model file, catalog ids and categories, queries and answers)."""
    import numpy as np

    from predictionio_tpu_torch.models.similarproduct import engine as psp
    from predictionio_tpu_torch.ops.retrieval import ItemRetriever
    from predictionio_tpu_torch.ops.topn import check_topn_agreement
    from predictionio_tpu_torch.utils.serialize import save_model

    itf = model.arrays.item_factors
    N = len(itf)
    inv = model.item_index.inverse()
    ids = [inv[r] for r in range(N)]
    cats = [sorted({f"c{c}" for c in rng.integers(0, 24, rng.integers(1, 4))}) for _ in range(N)]
    params = psp.ALSAlgorithmParams(rank=itf.shape[1])
    path = os.path.join(workdir, "ml20m_similar.npz")
    save_model(path, psp.sp_model_from_numpy(itf, ids, cats, params))

    n_queries = 320
    unknown_at = set(rng.choice(n_queries, size=4, replace=False).tolist())
    bodies = []
    for i in range(n_queries):
        body = {"items": [ids[j] for j in rng.integers(0, N, rng.integers(1, 11))],
                "num": int(10 if rng.random() < 0.85 else rng.integers(1, 41))}
        u = rng.random(3)
        if u[0] < 0.3:
            body["categories"] = [f"c{c}" for c in rng.integers(0, 24, rng.integers(1, 3))]
        if u[1] < 0.1:
            body["white_list"] = [ids[j] for j in rng.integers(0, N, 200)]
        if u[2] < 0.2:
            body["black_list"] = [ids[j] for j in rng.integers(0, N, 20)]
        if i in unknown_at:
            body["items"] = [f"unknown{i}", "nothing"]
        bodies.append(body)

    counters = retrieval_counts()
    server = Deployment(path, device)
    try:
        for c in counters:
            c.reset()
        answers, wall = server.send(bodies)
        status = server.status()
        counts = snapshot(counters)
        check_retrieval_launches(counts, status["batches"], len(unknown_at), False, "similar product")
        if status["servingPrecision"] != ["float32"]:
            raise AssertionError(f"servingPrecision {status['servingPrecision']}")
    finally:
        server.stop()

    ref_model = psp.sp_model_from_numpy(itf, ids, cats, params)
    alg = psp.ALSAlgorithm(params)
    alg.prepare_serving(device, ref_model)
    queries = [(i, psp.Query(**b)) for i, b in enumerate(bodies)]
    with plain_retrieval_kernels():
        ref = dict(ref_model.similar_batch(queries))
    alg.release_serving(ref_model)
    serving = psp.Serving()
    for i, _, res in answers:
        if res.get("modelVersion") != "ml20m_similar":
            raise AssertionError(f"modelVersion {res.get('modelVersion')!r}")
        got = res["itemScores"]
        want = serving.serve(queries[i][1], [ref[i]]).item_scores
        if len(got) != len(want) or (i in unknown_at and got):
            raise AssertionError(f"similar product query {i}: {len(got)} items, the twins gave {len(want)}")
        if got:
            check_topn_agreement(
                np.array([[x["score"] for x in got]]),
                np.array([[model.item_index[x["item"]] for x in got]]),
                np.array([[x.score for x in want]]),
                np.array([[model.item_index[x.item] for x in want]]), RTOL, ATOL)
    stats = {"queries": n_queries, **latency_stats(answers, wall),
             "batches": status["batches"], "batch_fill_mean": status["batchFillMean"],
             "server_avg_ms": status["avgServingSec"] * 1e3, "deploy_s": server.deploy_s,
             "launches": counts, "empty_answers": sum(not a[2]["itemScores"] for a in answers),
             "card": card_line()}
    print("similarproduct_serving " + json.dumps(stats), flush=True)
    # kernel A at this path's shape: float32 cosine, positive_only
    r = ItemRetriever(itf, device=device)
    q_np = ref_model.normed_host[rng.integers(0, N, 128)]
    row = time_retriever_kernels(r, q_np, 16, True, True, device,
                                 {"catalog": "ML-20M items, trained (cosine)"})
    r.free()
    print("similarproduct_path_timing " + json.dumps(row), flush=True)
    return counts, stats, {"path": path, "ids": ids, "cats": cats, "params": params,
                           "bodies": bodies, "answers": answers}


# the classification phase (3n): the reference's shape (bench.py:1842-1846)
CLS_N, CLS_F, CLS_C, CLS_QUERIES, CLS_SEED = 50_000, 3, 4, 2_048, 13
CLS_FLOAT = (200_000, 64, 10)  # a float-feature case for K15a: rows, features, classes
# a wide feature set with more work items (40 row blocks x 32 F tiles) than
# the card holds blocks of the fit at once: K15a's blocks walk several items
CLS_WIDE = (20_000, 1_000, 2)
CLS_BATCHES = (1, 7, 2_048)  # K15b's batch sizes
LR_CASES = ((0.1, 0.0), (0.05, 0.01))  # K18's (learning rate, l2)
LR_STEPS = 200  # LogisticRegressionAlgorithmParams.iterations' default
NB_TOL = 2e-6  # pi and theta against the twin, absolute (logf against torch.log)
NB_FLOAT_TOL = 1e-5  # float sums in two orders: sums relative, theta absolute
SCORE_TOL = 1e-5  # K15b's scores against the twin, absolute
LR_TOL = 1e-5  # K18's W and b against the twin, of the largest entry
CLS_SERVED, CLS_CLIENTS = 64, 8  # POST /queries.json per deployed model, clients


def bench_classification_data():
    """A copy of the reference's config 2 data (``bench.py:1841-1846``):
    class-conditional Poisson counts, seed 13; returns (labels, features)."""
    import numpy as np

    rng = np.random.default_rng(CLS_SEED)
    means = rng.uniform(1.0, 8.0, size=(CLS_C, CLS_F))
    labels = rng.integers(0, CLS_C, CLS_N)
    return labels, rng.poisson(means[labels]).astype(np.float32)


def check_k15a(X, y, C, lam, exact, label):
    """K15a against its twin on the card (and a second launch, bit for bit);
    counts bit for bit, sums bit for bit where ``exact`` (integer features)
    else within NB_FLOAT_TOL of float64 sums, pi and theta within NB_TOL
    (theta NB_FLOAT_TOL for float features). One launch a fit, and a launch
    of a third of the grid (each block walking about three work items) bit
    for bit the same; where the fit has more items than the card holds
    blocks, a grid one block larger than the card holds must raise, not
    fall back. Returns the largest |d| of pi and theta, the outputs the
    reference returns."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import naive_bayes as k15
    from predictionio_tpu_torch.ops.native import KernelError

    before = k15.LAUNCHES.snapshot()
    fit = k15.naive_bayes_fit(X, y, C, lam)
    ran = {k: v - before[k] for k, v in k15.LAUNCHES.snapshot().items() if v != before[k]}
    again = k15.naive_bayes_fit(X, y, C, lam)
    twin = k15.fit_plain(X, y, C, lam)
    if not all(bits_equal(a, b) for a, b in zip(fit, again)):
        raise AssertionError(f"K15a {label}: a second launch differs")
    if ran != {"naive_bayes_fit": 1}:
        raise AssertionError(f"K15a {label}: launches {ran}, not one fit")
    nblk, _, Ft, _, Ct = k15.fit_plan(X.shape[0], C, X.shape[1])
    items = nblk * -(-X.shape[1] // Ft) * -(-C // Ct)
    capacity = k15.fit_capacity(X.device, 1, k15.fit_smem(C, X.shape[1]))
    real_capacity = k15.fit_capacity
    try:
        k15.fit_capacity = lambda *a: max(1, min(items, capacity) // 3)
        third = k15.naive_bayes_fit(X, y, C, lam)
        refused = items <= capacity
        if not refused:
            k15.fit_capacity = lambda *a: capacity + 1
            try:
                k15.naive_bayes_fit(X, y, C, lam)
            except KernelError:
                refused = True
    finally:
        k15.fit_capacity = real_capacity
    if not all(bits_equal(a, b) for a, b in zip(fit, third)):
        raise AssertionError(f"K15a {label}: a third of the grid differs from the full grid")
    if not refused:
        raise AssertionError(f"K15a {label}: a grid of {capacity + 1} blocks on a card that "
                             f"holds {capacity} launched")
    print(f"  K15a {label}: one launch of {min(items, capacity)} blocks over {items} items "
          f"(the card holds {capacity}); a third of the grid bit for bit"
          + ("; a grid past the card's capacity refused" if items > capacity else ""), flush=True)
    if not torch.equal(fit.counts, twin.counts):
        raise AssertionError(f"K15a {label}: counts differ from the twin's")
    yn = y.cpu().numpy()
    s64 = np.zeros((C, X.shape[1]))
    np.add.at(s64, yn, X.cpu().numpy().astype(np.float64))
    if exact:
        if not (bits_equal(fit.sums, twin.sums) and np.array_equal(fit.sums.cpu().numpy(), s64)):
            raise AssertionError(f"K15a {label}: sums differ from the twin's or the exact sums")
    else:
        for name, s in (("kernel", fit.sums), ("twin", twin.sums)):
            d = np.abs(s.cpu().numpy() - s64).max() / np.abs(s64).max()
            if not d <= NB_FLOAT_TOL:
                raise AssertionError(f"K15a {label}: the {name}'s sums {d:.3g} off float64")
    d_pi = (fit.pi - twin.pi).abs().max().item()
    d_theta = (fit.theta - twin.theta).abs().max().item()
    if not (d_pi <= NB_TOL and d_theta <= (NB_TOL if exact else NB_FLOAT_TOL)):
        raise AssertionError(f"K15a {label}: pi {d_pi:.3g}, theta {d_theta:.3g} off the twin")
    sums_d = ((fit.sums - twin.sums).abs().max() / twin.sums.abs().max()).item()
    print(f"  K15a {label}: counts{' and sums' if exact else ''} bit for bit, a second launch "
          f"bit for bit, sums |d| {sums_d:.3g} of the largest, pi |d| {d_pi:.3g}, theta |d| "
          f"{d_theta:.3g} ok", flush=True)
    return max(d_pi, d_theta)


def check_k15b(Q, pi, theta, label):
    """K15b against the twin on the card: labels equal, scores within
    SCORE_TOL (bit for bit expected: one product and add order). Returns
    (the largest |d|, whether the scores were bit-equal)."""
    import torch

    from predictionio_tpu_torch.ops import naive_bayes as k15

    idx, scores = k15.naive_bayes_scores(Q, pi, theta, with_scores=True)
    idx_only, _ = k15.naive_bayes_scores(Q, pi, theta)
    ref = k15.scores_plain(Q, pi, theta)
    want = k15.argmax_first_nan(ref)
    if not (torch.equal(idx, want) and torch.equal(idx_only, want)):
        raise AssertionError(f"K15b {label}: labels differ from the twin's")
    inf = torch.isinf(ref)
    if not (torch.equal(torch.isnan(scores), torch.isnan(ref))
            and torch.equal(torch.isinf(scores), inf) and torch.equal(scores[inf], ref[inf])):
        raise AssertionError(f"K15b {label}: NaN or infinite scores differ from the twin's")
    both = ref.isfinite()
    d = (scores[both] - ref[both]).abs().max().item() if bool(both.any()) else 0.0
    if not d <= SCORE_TOL:
        raise AssertionError(f"K15b {label}: scores {d:.3g} off the twin")
    return d, bits_equal(scores, ref)


def nan_and_tie_models(device):
    """(pi, theta, queries) of a lam = 0 model whose class 5.0 has feature 1
    at 0 (theta -inf, so 0·(-inf) = NaN scores), and of a lam = 1 model
    whose classes 2.0 and 4.0 saw the same points (a tie on every row)."""
    import numpy as np

    from predictionio_tpu_torch.ops import naive_bayes as k15

    X = np.asarray([[2, 0, 1], [1, 0, 3], [0, 2, 2], [1, 4, 0], [3, 1, 1], [0, 0, 5]], np.float32)
    Q = np.asarray([[1, 0, 0], [0, 0, 0], [0, 1, 1], [2, 0, 3], [0, 0, 1]], np.float32)
    nan_model = k15.train_naive_bayes(X, np.asarray([5, 5, 1, 1, 3, 3], np.float32), lam=0.0,
                                      device=device)
    X2 = np.concatenate([X[:2], X[:2], X[2:4]])
    tie_model = k15.train_naive_bayes(X2, np.asarray([4, 4, 2, 2, 9, 9], np.float32), lam=1.0,
                                      device=device)
    return [(m, Q) for m in (nan_model, tie_model)]


def classification_phase(device, workdir):
    """Phase 3n: the classification template (BASELINE.json config 2) at
    the reference's shape. K15a, K15b and K18 against their twins; the main
    path counted from 0 (``NaiveBayesAlgorithm.train`` and
    ``batch_predict`` of 2,048 rows, ``LogisticRegressionAlgorithm.train``
    and ``batch_predict``, both models deployed through the CLI and sent
    64 queries each from 8 clients, answers equal to ``batch_predict``'s);
    train wall clocks and accuracies beside the twins'; times. Returns
    (launches, errors, stats, what 3k reuses: the data, the naive Bayes
    model and its served answers)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.classification import engine as clf
    from predictionio_tpu_torch.ops import naive_bayes as k15
    from predictionio_tpu_torch.ops import softmax_regression as k18
    from predictionio_tpu_torch.utils.serialize import save_model

    labels, features = bench_classification_data()
    X = torch.from_numpy(features).to(device)
    y = torch.from_numpy(labels.astype(np.int32)).to(device)
    errs = {"naive_bayes_fit": 0.0, "naive_bayes_scores": 0.0, "softmax_regression": 0.0}

    # K15a: the bench's integer features, then a float case
    errs["naive_bayes_fit"] = check_k15a(X, y, CLS_C, 1.0, True, "bench 50,000 x 3, C = 4")
    rng = np.random.default_rng(CLS_SEED + 1)
    n_f, F_f, C_f = CLS_FLOAT
    Xf = torch.from_numpy(rng.uniform(0.0, 3.0, size=(n_f, F_f)).astype(np.float32)).to(device)
    yf = torch.from_numpy(rng.integers(0, C_f, n_f).astype(np.int32)).to(device)
    errs["naive_bayes_fit"] = max(errs["naive_bayes_fit"], check_k15a(
        Xf, yf, C_f, 0.7, False, f"float {n_f:,} x {F_f}, C = {C_f}"))
    n_w, F_w, C_w = CLS_WIDE
    Xw = torch.from_numpy(rng.uniform(0.0, 3.0, size=(n_w, F_w)).astype(np.float32)).to(device)
    yw = torch.from_numpy(rng.integers(0, C_w, n_w).astype(np.int32)).to(device)
    errs["naive_bayes_fit"] = max(errs["naive_bayes_fit"], check_k15a(
        Xw, yw, C_w, 0.7, False, f"wide {n_w:,} x {F_w:,}, C = {C_w}"))
    del Xf, yf, Xw, yw

    # K15b at B in {1, 7, 2048} on the bench model, and the NaN and tie rows
    fit = k15.naive_bayes_fit(X, y, CLS_C, 1.0)
    bit_equal = True
    for B in CLS_BATCHES:
        d, same = check_k15b(X[:B].contiguous(), fit.pi, fit.theta, f"B = {B}")
        errs["naive_bayes_scores"] = max(errs["naive_bayes_scores"], d)
        bit_equal &= same
    odd_models = nan_and_tie_models(device)
    for m, Q in odd_models:
        Qd = torch.from_numpy(Q).to(device)
        pi, theta = torch.from_numpy(m.pi).to(device), torch.from_numpy(m.theta).to(device)
        d, same = check_k15b(Qd, pi, theta, "lam = 0 / tie model")
        errs["naive_bayes_scores"] = max(errs["naive_bayes_scores"], d)
        bit_equal &= same
    nan_labels = k15.predict_naive_bayes(*odd_models[0])
    print(f"  K15b at B = {CLS_BATCHES} and on the NaN (lam = 0) and tie rows: labels equal to "
          f"the twin's (NaN model labels {nan_labels.tolist()}), scores |d| "
          f"{errs['naive_bayes_scores']:.3g}, bit for bit: {bit_equal} ok", flush=True)

    # K18 against the twin, 200 steps, both (lr, l2)
    for lr, l2 in LR_CASES:
        W, b = k18.softmax_regression(X, y, CLS_C, lr, l2, LR_STEPS)
        W2, b2 = k18.softmax_regression(X, y, CLS_C, lr, l2, LR_STEPS)
        if not (bits_equal(W, W2) and bits_equal(b, b2)):
            raise AssertionError(f"K18 ({lr}, {l2}): a second launch differs")
        Wt, bt = k18.softmax_regression_plain(X, y, CLS_C, lr, l2, LR_STEPS)
        dW = (W - Wt).abs().max().item() / Wt.abs().max().item()
        db = (b - bt).abs().max().item() / max(bt.abs().max().item(), 1e-30)
        if not (dW <= LR_TOL and db <= LR_TOL):
            raise AssertionError(f"K18 ({lr}, {l2}): W {dW:.3g}, b {db:.3g} of the largest "
                                 "entry off the twin")
        errs["softmax_regression"] = max(errs["softmax_regression"], (W - Wt).abs().max().item(),
                                         (b - bt).abs().max().item())
        print(f"  K18 lr {lr}, l2 {l2}, {LR_STEPS} steps: W {dW:.3g}, b {db:.3g} of the largest "
              "entry off the twin, a second launch bit for bit ok", flush=True)

    # the main path, counted from 0
    td = clf.TrainingData(labels=labels.astype(np.float32), features=features)
    pd = clf.Preparator().prepare(device, td)
    nb_algo = clf.NaiveBayesAlgorithm(clf.NaiveBayesAlgorithmParams(lambda_=1.0))
    lr_algo = clf.LogisticRegressionAlgorithm(clf.LogisticRegressionAlgorithmParams())
    queries = [(j, clf.Query(features=tuple(features[j]))) for j in range(CLS_QUERIES)]
    bodies = [{"features": [float(v) for v in features[j]]} for j in range(CLS_SERVED)]
    k15.LAUNCHES.reset()
    k15.PLACEMENTS.reset()
    k18.LAUNCHES.reset()
    train_s, accuracy, answers_s, served = {}, {}, {}, {}
    models = {}
    for name, algo in (("naive", nb_algo), ("logisticregression", lr_algo)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        models[name] = algo.train(device, pd)
        train_s[name] = time.perf_counter() - t
        t = time.perf_counter()
        preds = algo.batch_predict(models[name], queries)
        answers_s[name] = time.perf_counter() - t
        accuracy[name] = float(np.mean([p.label == labels[j] for j, p in preds]))
        path = os.path.join(workdir, f"classification_{name}.npz")
        save_model(path, models[name])
        server = Deployment(path, device)
        try:
            answers, wall = server.send(bodies, CLS_CLIENTS)
            status = server.status()
        finally:
            server.stop()
        want = algo.batch_predict(models[name], [(i, clf.Query(**b)) for i, b in enumerate(bodies)])
        if name == "naive":
            nb_answers = [res for _, _, res in answers]
        for (i, _, res), (_, p) in zip(answers, want):
            if res.get("label") != p.label or res.get("modelVersion") != f"classification_{name}":
                raise AssertionError(f"{name} deployment: query {i} answered {res}, "
                                     f"batch_predict {p}")
        served[name] = {"queries": len(answers), "batches": status["batches"],
                        **latency_stats(answers, wall), "deploy_s": server.deploy_s}
    counts = {**k15.LAUNCHES.snapshot(), **k18.LAUNCHES.snapshot()}
    # K15b: batch_predict of the 2,048 rows, one per served batch, and
    # batch_predict of the served queries
    want_counts = {name: 0 for name in counts}
    want_counts.update({"naive_bayes_fit": 1, "naive_bayes_scores": 2 + served["naive"]["batches"],
                        "softmax_regression": 2 * lr_algo.params.iterations})
    if counts != want_counts:
        raise AssertionError(f"classification launches {counts}, expected {want_counts}")
    # pi and theta placed once on the path: the trained model keeps its
    # fit's, the deployment places its loaded model's; a batch uploads its
    # rows only
    placements = k15.PLACEMENTS.snapshot()["naive_bayes_place"]
    if placements != 1:
        raise AssertionError(f"classification: {placements} placements of pi and theta, not 1")
    print(f"  main path: NaiveBayesAlgorithm.train {train_s['naive']:.4f} s, "
          f"LogisticRegressionAlgorithm.train {train_s['logisticregression']:.4f} s; launches "
          f"{counts}; both deployments answered {CLS_SERVED} queries from {CLS_CLIENTS} clients "
          "equal to batch_predict ok", flush=True)

    # the twins' models, and their accuracy on the same rows
    twin_fit = k15.fit_plain(X, y, CLS_C, 1.0)
    Q = X[:CLS_QUERIES]
    twin_pred = k15.argmax_first_nan(k15.scores_plain(Q, twin_fit.pi, twin_fit.theta))
    twin_acc = {"naive": float((twin_pred.cpu().numpy() == labels[:CLS_QUERIES]).mean())}
    p = lr_algo.params
    Wt, bt = k18.softmax_regression_plain(X, y, CLS_C, p.learning_rate, p.l2, p.iterations)
    lr_pred = (features[:CLS_QUERIES] @ Wt.cpu().numpy().T + bt.cpu().numpy()).argmax(1)
    twin_acc["logisticregression"] = float((lr_pred == labels[:CLS_QUERIES]).mean())
    if twin_acc != accuracy:
        raise AssertionError(f"train accuracy {accuracy} differs from the twins' {twin_acc}")
    print(f"  train accuracy on {CLS_QUERIES} rows: {accuracy} (the twins' equal)", flush=True)

    # times at the main path's shapes: K15a on the bench data, K15b at
    # B = 2,048, K18 as one 200-step training
    Qp = X[:CLS_QUERIES].contiguous()
    calls = {
        "naive_bayes_fit": (lambda: k15.naive_bayes_fit(X, y, CLS_C, 1.0),
                            lambda: k15.fit_plain(X, y, CLS_C, 1.0)),
        "naive_bayes_scores": (lambda: k15.naive_bayes_scores(Qp, fit.pi, fit.theta),
                               lambda: k15.argmax_first_nan(
                                   k15.scores_plain(Qp, fit.pi, fit.theta))),
        "softmax_regression": (lambda: k18.softmax_regression(X, y, CLS_C, 0.1, 0.0, LR_STEPS),
                               lambda: k18.softmax_regression_plain(X, y, CLS_C, 0.1, 0.0,
                                                                    LR_STEPS)),
    }
    y_long = y.long()
    library = {
        # K15a: the sums alone, one index_add_ (its counts and logs are more calls)
        "naive_bayes_fit": lambda: torch.zeros((CLS_C, CLS_F), device=device).index_add_(
            0, y_long, X),
        # K15b: two calls, the scores and the argmax (no NaN rule)
        "naive_bayes_scores": lambda: torch.addmm(fit.pi, Qp, fit.theta.T).argmax(1),
    }
    iters = {"naive_bayes_fit": 200, "naive_bayes_scores": 200, "softmax_regression": 20}
    t_k, dev_ms, plain_ms, lib_ms = {}, {}, {}, {}
    for name, (kern, plain) in calls.items():
        t_k[name] = time_ms(kern, iters=iters[name], warmup=3)
        # one K18 call is 400 launches: more calls behind the spin would fill
        # the launch queue, and the host would wait for the spin to end
        dev_ms[name] = device_ms(kern, calls=20 if name != "softmax_regression" else 1)
        plain_ms[name] = time_ms(plain, iters=max(2, iters[name] // 10), warmup=1)
        lib_ms[name] = time_ms(library[name], iters=200, warmup=3) if name in library else None
    n, F, C, B = CLS_N, CLS_F, CLS_C, CLS_QUERIES
    bounds = {
        # features and labels in; counts, sums, pi and theta out
        "naive_bayes_fit": roofline(4 * (n * F + n + 2 * C + 2 * C * F), n * F),
        # the queries, pi and theta in; the labels out
        "naive_bayes_scores": roofline(4 * (B * F + C + C * F + B), 2 * B * C * F + B * C),
        # X and y read once, W and b written once; per step the logits and
        # R^T X (2·n·C·F each), the softmax (about 6 a row and class) and the update
        "softmax_regression": roofline(
            4 * (n * F + n + C * F + C),
            LR_STEPS * (4 * n * C * F + 6 * n * C + 4 * C * (F + 1))),
    }
    host_us = host_breakdown(calls["naive_bayes_fit"][0], wrapper_parts(k15))
    print(f"  K15a host µs a call: {json.dumps(host_us)}", flush=True)
    scores_host_us = host_breakdown(calls["naive_bayes_scores"][0], wrapper_parts(k15))
    print(f"  K15b host µs a call (B = {B}): {json.dumps(scores_host_us)}", flush=True)
    stats = {"card": card_line(), "shape": {"n": n, "features": F, "classes": C,
                                            "queries": B, "lr_steps": LR_STEPS},
             "naive_bayes_fit_host_us": host_us, "naive_bayes_scores_host_us": scores_host_us,
             "placements": placements,
             "train_s": train_s, "batch_predict_s": answers_s, "train_accuracy": accuracy,
             "twin_accuracy": twin_acc, "served": served, "launches": counts,
             "kernel_ms": t_k, "device_ms": dev_ms, "plain_ms": plain_ms,
             "library_ms": lib_ms, "bound": bounds, "errors": errs,
             "k15b_bit_equal": bit_equal}
    print("classification " + json.dumps(stats), flush=True)
    launches = {name: counts[name] for name in errs}
    return launches, errs, stats, {"labels": labels, "features": features,
                                   "model": models["naive"], "bodies": bodies,
                                   "answers": nb_answers, "train_s": train_s["naive"]}


# phase 3x (after 3n): the e2 library (K16, K17a, K17b) and the
# least-squares templates (K21, K22: one kernel pair, ``lsq``)
ADULT_CARDS = (9, 16, 7, 15, 6, 5, 2, 42)  # UCI Adult's categorical slots' value counts
ADULT_POSITIVE = 0.24  # Adult's share of the ">50K" label
CNB_N, CNB_QUERIES, CNB_UNKNOWN, CNB_SEED = 1_000_000, 2_048, 256, 23
CNB_SCORE_RTOL, CNB_TIE_GAP = 1e-6, 1e-5  # K17b's scores; a tie two sum orders may split
MC_STATES, MC_ENTRIES, MC_TOP, MC_PREDICTS, MC_SEED = 100_000, 1_000_000, 10, 100, 31
MC_RTOL, MC_ATOL = 1e-6, 1e-7  # K16 against its twin (both sum in float64)
STOCK_TICKERS, STOCK_DAYS = 500, 600
REG_ROWS, REG_FEATURES, REG_FOLDS, REG_SEED = 200_000, 10, 5, 41
LSQ_TOL = 1e-5  # lsq against float64 numpy and its twin, of the largest entry
MSE_RTOL = 1e-4  # the evaluation's MSE against float64 fits of the same folds
X_SERVED, X_CLIENTS = 64, 8  # POST /queries.json to the OLS deployment, clients
PEAK_FP64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores (NVIDIA data sheet)


def adult_points():
    """UCI Adult's categorical shape at CNB_N rows: 8 slots with Adult's
    value counts, 2 labels, drawn from a seeded class-conditional model.
    Returns (LabeledPoints, label codes [N], value codes [N, 8], value names
    per slot)."""
    import numpy as np

    from predictionio_tpu_torch.e2 import LabeledPoint

    rng = np.random.default_rng(CNB_SEED)
    labels = (rng.random(CNB_N) < ADULT_POSITIVE).astype(np.int64)
    codes = np.empty((CNB_N, len(ADULT_CARDS)), np.int64)
    for s, c in enumerate(ADULT_CARDS):
        cdf = np.cumsum(rng.dirichlet(np.full(c, 0.7), size=2), axis=1)
        u = rng.random(CNB_N)
        codes[:, s] = np.minimum((u[:, None] > cdf[labels]).sum(1), c - 1)
    names = [np.asarray([f"s{s}v{v}" for v in range(c)], dtype=object)
             for s, c in enumerate(ADULT_CARDS)]
    label_names = np.asarray(["<=50K", ">50K"], dtype=object)[labels].tolist()
    slots = [names[s][codes[:, s]].tolist() for s in range(len(ADULT_CARDS))]
    points = [LabeledPoint(l, f) for l, f in zip(label_names, zip(*slots))]
    return points, labels, codes, names


def check_k17b(model, rows, label):
    """K17b against its twin on the card for ``rows``: scores within
    CNB_SCORE_RTOL with -inf in the same places, labels equal except where
    a row's two best twin scores lie within CNB_TIE_GAP, a second launch bit
    for bit. Returns (the largest relative |d| of the finite scores, the
    kernel's labels)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import categorical_nb as k17
    from predictionio_tpu_torch.ops.naive_bayes import argmax_first_nan

    dev = model.device
    enc, known = model.encode(rows)
    ll, prior = model._device_arrays(dev)
    e, k = torch.from_numpy(enc).to(dev), torch.from_numpy(known).to(dev)
    labels, scores = k17.cnb_scores_argmax(ll, prior, e, k)
    labels2, scores2 = k17.cnb_scores_argmax(ll, prior, e, k)
    if not (bits_equal(scores, scores2) and torch.equal(labels, labels2)):
        raise AssertionError(f"K17b {label}: a second launch differs")
    ref = k17.scores_plain(ll, prior, e, k)
    want = argmax_first_nan(ref)
    inf = torch.isinf(ref)
    if not (torch.equal(torch.isinf(scores), inf) and torch.equal(scores[inf], ref[inf])):
        raise AssertionError(f"K17b {label}: infinite scores differ from the twin's")
    fin = ~inf
    rel = ((scores[fin] - ref[fin]).abs() / ref[fin].abs().clamp(min=1e-30)).max().item() \
        if bool(fin.any()) else 0.0
    if not rel <= CNB_SCORE_RTOL:
        raise AssertionError(f"K17b {label}: scores {rel:.3g} off the twin, relative")
    srt = torch.sort(ref, dim=1).values.cpu().numpy()
    with np.errstate(invalid="ignore"):
        gap = srt[:, -1] - srt[:, -2]
    differ = (labels != want).cpu().numpy()
    if (differ & ~(gap <= CNB_TIE_GAP)).any():
        raise AssertionError(f"K17b {label}: labels differ from the twin's outside ties")
    print(f"  K17b {label}: {len(rows)} rows, scores {rel:.3g} of the twin's (relative), "
          f"{int(inf.sum())} -inf equal, labels equal ({int(differ.sum())} tie flips), a second "
          "launch bit for bit ok", flush=True)
    return rel, labels.cpu().numpy()


def cnb_phase(device):
    """K17 at UCI Adult's categorical shape scaled to 1,000,000 rows: K17a
    against its twin and float64 numpy, the main path counted from 0
    (``CategoricalNaiveBayes.train``, ``predict_batch`` of 2,048 rows, then
    of a batch with unknown values: K17a = 1, K17b = 2, twins 0), K17b
    against its twin on both batches, times. Returns (launches, errors,
    stats, what 3k reuses: the points, the model, both batches and their
    answers)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.e2 import CategoricalNaiveBayes
    from predictionio_tpu_torch.ops import categorical_nb as k17

    t = time.perf_counter()
    points, labels, codes, names = adult_points()
    data_s = time.perf_counter() - t
    rows = [p.features for p in points[:CNB_QUERIES]]
    rng = np.random.default_rng(CNB_SEED + 1)
    unknown_rows = [tuple("unseen" if rng.random() < 0.2 else v for v in p.features)
                    for p in points[-CNB_UNKNOWN:]]
    unknown_rows[0] = tuple("unseen" for _ in ADULT_CARDS)  # every score -inf: label 0

    k17.LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = CategoricalNaiveBayes.train(points, device=device)
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    served = model.predict_batch(rows)
    predict_s = time.perf_counter() - t
    t = time.perf_counter()
    served_unknown = model.predict_batch(unknown_rows)
    predict_unknown_s = time.perf_counter() - t
    counts = k17.LAUNCHES.snapshot()
    want_counts = {name: 0 for name in counts}
    want_counts.update({"cnb_count": 1, "cnb_scores_argmax": 2})
    if counts != want_counts:
        raise AssertionError(f"categorical NB launches {counts}, expected {want_counts}")
    inv = model.label_index.inverse()
    if served_unknown[0] != inv[0]:
        raise AssertionError(f"a row of unknown values got {served_unknown[0]!r}, not label 0")

    # K17a: the train's keys, rebuilt from the model's indexes
    L, S, V = model.log_likelihoods.shape
    lab = np.asarray([model.label_index[n] for n in ("<=50K", ">50K")])[labels]
    keys = np.concatenate([
        (s * L + lab) * V + np.asarray([model.value_indexes[s][n] for n in names[s]])[codes[:, s]]
        for s in range(S)]).astype(np.int32)
    n_keys = S * L * V
    keys_dev = torch.from_numpy(keys).to(device)
    got = k17.cnb_count(keys_dev, n_keys)
    again = k17.cnb_count(keys_dev, n_keys)
    twin = k17.count_plain(keys_dev, n_keys)
    c64 = np.bincount(keys, minlength=n_keys).astype(np.float64)
    if not (torch.equal(got, again) and torch.equal(got, twin)
            and np.array_equal(got.cpu().numpy().astype(np.float64), c64)):
        raise AssertionError("K17a: counts differ from a second launch, the twin or numpy")
    # the model from the exact counts, as the reference's numpy turns them into logs
    label_counts = np.bincount(lab, minlength=L).astype(np.float64)
    with np.errstate(divide="ignore"):
        ll64 = np.where(c64.reshape(S, L, V) > 0,
                        np.log(c64.reshape(S, L, V) / label_counts[None, :, None]),
                        float("-inf")).transpose(1, 0, 2).astype(np.float32)
    if not (np.array_equal(model.log_likelihoods, ll64) and np.array_equal(
            model.log_priors, np.log(label_counts / CNB_N).astype(np.float32))):
        raise AssertionError("K17a: the model's logs differ from numpy's on the exact counts")
    print(f"  K17a: {len(keys):,} keys into {n_keys} counts (largest {int(c64.max()):,}) bit for "
          "bit against a second launch, the twin (bincount) and numpy; the model's logs equal "
          "numpy's on them ok", flush=True)
    errs = {"cnb_count": 0.0, "cnb_scores_argmax": 0.0}
    for rs, name, path_labels in ((rows, f"{CNB_QUERIES} rows", served),
                                  (unknown_rows, f"{CNB_UNKNOWN} rows with unknowns",
                                   served_unknown)):
        d, kl = check_k17b(model, rs, name)
        errs["cnb_scores_argmax"] = max(errs["cnb_scores_argmax"], d)
        if [inv[int(i)] for i in kl] != path_labels:
            raise AssertionError(f"K17b {name}: the path's labels differ from the kernel's")
    accuracy = float(np.mean(np.asarray(served) == np.asarray(
        [p.label for p in points[:CNB_QUERIES]])))

    # times at the path's shapes
    keys_long = keys_dev.long()
    enc, known = model.encode(rows)
    ll, prior = model._device_arrays(device)
    e, k = torch.from_numpy(enc).to(device), torch.from_numpy(known).to(device)
    calls = {
        "cnb_count": (lambda: k17.cnb_count(keys_dev, n_keys),
                      lambda: k17.count_plain(keys_dev, n_keys),
                      lambda: torch.bincount(keys_long, minlength=n_keys)),
        "cnb_scores_argmax": (lambda: k17.cnb_scores_argmax(ll, prior, e, k),
                              lambda: k17.scores_plain(ll, prior, e, k).argmax(1), None),
    }
    t_k, dev_ms, plain_ms, lib_ms = {}, {}, {}, {}
    for name, (kern, plain, lib) in calls.items():
        t_k[name] = time_ms(kern, iters=100, warmup=3)
        dev_ms[name] = device_ms(kern)
        plain_ms[name] = time_ms(plain, iters=20, warmup=2)
        lib_ms[name] = time_ms(lib, iters=100, warmup=3) if lib else None
    M, N = len(keys), CNB_QUERIES
    bounds = {
        # the keys in, the counts out; one add a key
        "cnb_count": roofline(4 * M + 4 * n_keys, M),
        # codes, masks, priors and likelihoods in; scores and labels out
        "cnb_scores_argmax": roofline(4 * N * S + N * S + 4 * L + 4 * L * S * V + 4 * N * L
                                      + 4 * N, N * L * S),
    }
    stats = {"card": card_line(), "shape": {"points": CNB_N, "slots": list(ADULT_CARDS),
                                            "labels": L, "keys": M, "n_keys": n_keys},
             "data_s": data_s, "train_s": train_s, "predict_s": predict_s,
             "predict_unknown_s": predict_unknown_s, "train_accuracy": accuracy,
             "launches": counts, "kernel_ms": t_k, "device_ms": dev_ms, "plain_ms": plain_ms,
             "library_ms": lib_ms, "bound": bounds, "errors": errs}
    print("categorical_nb " + json.dumps(stats), flush=True)
    refs = {"points": points, "model": model, "rows": rows, "unknown_rows": unknown_rows,
            "served": served, "served_unknown": served_unknown, "train_s": train_s,
            "keys": keys}
    return {n: counts[n] for n in errs}, errs, stats, refs


def markov_tally():
    """MC_ENTRIES seeded (from, to, count) triples over MC_STATES states:
    sources uniform, targets Zipf-skewed (exponent 1.2, ranks scattered
    over the states), counts 1..5."""
    import numpy as np

    rng = np.random.default_rng(MC_SEED)
    src = rng.integers(0, MC_STATES, MC_ENTRIES)
    dst = rng.permutation(MC_STATES)[(rng.zipf(1.2, MC_ENTRIES) - 1) % MC_STATES]
    cnt = rng.integers(1, 6, MC_ENTRIES).astype(np.float64)
    return list(zip(src.tolist(), dst.tolist(), cnt.tolist()))


def markov_phase(device):
    """K16: ``MarkovChain.train`` on 1,000,000 Zipf-skewed tally entries over
    100,000 states, top 10, then 100 ``predict`` calls counted from 0 (K16 =
    100, twin 0); each answer within MC_RTOL / MC_ATOL of the twin and bit
    for bit against a second launch, the first against float64 numpy;
    times. Returns (launches, errors, stats, what 3k reuses: the model, the
    state vectors and their answers)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.e2 import MarkovChain
    from predictionio_tpu_torch.ops import markov as k16

    entries = markov_tally()
    t = time.perf_counter()
    model = MarkovChain.train(entries, MC_STATES, MC_TOP, device=device)
    train_s = time.perf_counter() - t
    del entries
    rng = np.random.default_rng(MC_SEED + 1)
    curs = [rng.dirichlet(np.ones(MC_STATES)).astype(np.float32) for _ in range(MC_PREDICTS)]
    t = time.perf_counter()
    placed = model._device_transitions(device)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t

    k16.LAUNCHES.reset()
    t = time.perf_counter()
    outs = [model.predict(cur) for cur in curs]
    predict_s = time.perf_counter() - t
    counts = k16.LAUNCHES.snapshot()
    if counts != {name: MC_PREDICTS if name == "markov_step" else 0 for name in counts}:
        raise AssertionError(f"K16 launches {counts}, expected {MC_PREDICTS} and the rest 0")

    err = 0.0
    for i, (cur, out) in enumerate(zip(curs, outs)):
        cur_t = torch.from_numpy(cur).to(device)
        again = k16.markov_step(cur_t, placed).cpu().numpy()
        got = np.asarray(out, np.float32)
        if not np.array_equal(got.view(np.int32), again.view(np.int32)):
            raise AssertionError(f"K16 predict {i}: a second launch differs")
        twin = k16.markov_step_plain(cur_t, placed).cpu().numpy()
        if not np.allclose(got, twin, rtol=MC_RTOL, atol=MC_ATOL):
            raise AssertionError(f"K16 predict {i}: {np.abs(got - twin).max():.3g} off the twin")
        err = max(err, float(np.abs(got - twin).max()))
    contrib = (model.probs * curs[0][:, None]).astype(np.float32).ravel().astype(np.float64)
    n64 = np.bincount(model.targets.ravel(), weights=contrib, minlength=MC_STATES)
    d64 = np.abs(np.asarray(outs[0], np.float64) - n64).max() / np.abs(n64).max()
    if not d64 <= MC_RTOL:
        raise AssertionError(f"K16: {d64:.3g} of the largest entry off float64 numpy")
    indeg = np.diff(placed.target_chunk.cpu().numpy())
    print(f"  K16: {MC_PREDICTS} predicts over {MC_STATES:,} states ({placed.src.numel():,} kept "
          f"transitions, {placed.n_chunks:,} chunks, a target's chunks at most {int(indeg.max())}) "
          f"each within rtol {MC_RTOL} of the twin (|d| {err:.3g}) and bit for bit against a "
          f"second launch; the first {d64:.3g} of the largest entry off float64 ok", flush=True)

    cur_t = torch.from_numpy(curs[0]).to(device)
    t_keep = k16.entry_targets(placed)
    contrib_t = placed.prob * cur_t[placed.src.long()]
    t_k = time_ms(lambda: k16.markov_step(cur_t, placed), iters=200, warmup=5)
    dev_ms = device_ms(lambda: k16.markov_step(cur_t, placed))
    plain_ms = time_ms(lambda: k16.markov_step_plain(cur_t, placed), iters=50, warmup=3)
    # the scatter alone, given the products: one float32 index_add_
    lib_ms = time_ms(lambda: torch.zeros(MC_STATES, device=device).index_add_(
        0, t_keep, contrib_t), iters=200, warmup=5)
    E = placed.src.numel()
    stats = {"card": card_line(), "shape": {"states": MC_STATES, "tally_entries": MC_ENTRIES,
                                            "top_n": MC_TOP, "kept": E,
                                            "chunks": placed.n_chunks},
             "train_s": train_s, "place_s": place_s, "predict_s": predict_s,
             "predicts": MC_PREDICTS, "launches": counts, "kernel_ms": t_k,
             "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             # the state vector in, the kept transitions (source, probability), the next state out
             "bound": roofline(4 * MC_STATES + 8 * E + 4 * MC_STATES, 2 * E),
             "error": err}
    print("markov " + json.dumps(stats), flush=True)
    return counts["markov_step"], err, stats, {"model": model, "curs": curs, "outs": outs,
                                               "predict_s": predict_s}


def lsq_oracle(A, b):
    """float64 numpy at JAX's cutoff, per system of A [N, m, n]: x [N, n]."""
    import numpy as np

    N, m, n = A.shape
    return np.stack([np.linalg.lstsq(A[i].astype(np.float64), b[i].astype(np.float64),
                                     rcond=float(np.finfo(np.float32).eps) * max(m, n))[0]
                     for i in range(N)])


def max_sweeps(res) -> int:
    """The most Jacobi sweeps a system of an lsq result took (0 from the
    twin, which reports none)."""
    return 0 if res.sweeps is None else int(res.sweeps.max())


def check_lsq(A, b, label):
    """lsq on the card against its twin and float64 numpy (x within LSQ_TOL
    of each system's largest entry, ranks equal, singular values within
    LSQ_TOL) and a second launch bit for bit. Returns (the largest |d| of x
    against the twin, the kernel's result)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import lstsq as k21

    got = k21.require_converged(k21.lstsq(A, b))
    again = k21.lstsq(A, b)
    if not all(bits_equal(p, q) for p, q in zip(got[:3], again[:3])):
        raise AssertionError(f"lsq {label}: a second launch differs")
    twin = k21.lstsq_plain(A, b)
    x64 = lsq_oracle(A.cpu().numpy(), b.cpu().numpy())
    x = got.x.cpu().numpy().astype(np.float64)
    scale = np.maximum(np.abs(x64).max(axis=1), 1e-30)
    d64 = (np.abs(x - x64).max(axis=1) / scale).max()
    dt = (np.abs(x - twin.x.cpu().numpy()).max(axis=1) / scale).max()
    if not (d64 <= LSQ_TOL and dt <= LSQ_TOL):
        raise AssertionError(f"lsq {label}: x {d64:.3g} off float64, {dt:.3g} off the twin")
    if not torch.equal(got.rank, twin.rank):
        raise AssertionError(f"lsq {label}: ranks {got.rank.tolist()[:8]} differ from the "
                             f"twin's {twin.rank.tolist()[:8]}")
    ds = ((got.s - twin.s).abs().max() / twin.s.abs().max().clamp(min=1e-30)).item() \
        if got.s.numel() else 0.0
    if not ds <= LSQ_TOL:
        raise AssertionError(f"lsq {label}: singular values {ds:.3g} off the twin's")
    print(f"  lsq {label}: x {d64:.3g} off float64 and {dt:.3g} off the twin (of the largest "
          f"entry), ranks {sorted(set(got.rank.tolist()))} equal, s {ds:.3g}, sweeps "
          f"{max_sweeps(got)} at most, a second launch bit for bit ok", flush=True)
    return float(np.abs(x - twin.x.cpu().numpy()).max()), got


def check_lsq_edges(device):
    """lsq at the card on the CPU tests' cases: conditioned batches at the
    stock and regression widths, a duplicated column, a zero column, both,
    m < n, 30 and 64 columns (more than a block's 256 Gram slots; the solve
    past 48 KB of shared memory), a zero matrix and an empty one. Returns
    the largest |d| against the twin."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import lstsq as k21

    rng = np.random.default_rng(97)

    def conditioned(m, n, cond):
        u, _ = np.linalg.qr(rng.standard_normal((m, n)))
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        return ((u * np.logspace(0, -np.log10(cond), n)) @ v.T).astype(np.float32)

    cases = {
        "3 x 173 x 5, cond 1e3": np.stack([conditioned(173, 5, 1e3) for _ in range(3)]),
        "3 x 300 x 10, cond 1e3": np.stack([conditioned(300, 10, 1e3) for _ in range(3)]),
        "2 x 2,000 x 30": rng.standard_normal((2, 2_000, 30)).astype(np.float32),
        "1 x 500 x 64": rng.standard_normal((1, 500, 64)).astype(np.float32),
        "m < n, 2 x 6 x 9": rng.standard_normal((2, 6, 9)).astype(np.float32),
    }
    A = rng.standard_normal((4, 50, 6)).astype(np.float32)
    A[0, :, 4] = A[0, :, 1]  # a duplicated column
    A[1, :, 2] = 0.0  # a zero column
    A[2, :, 4] = A[2, :, 1]
    A[2, :, 0] = 0.0  # both
    A[3] = 0.0  # a zero matrix: rank 0, x = 0
    cases["rank-deficient 4 x 50 x 6"] = A
    err = 0.0
    for label, a in cases.items():
        b = rng.standard_normal(a.shape[:2]).astype(np.float32)
        d, got = check_lsq(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device), label)
        err = max(err, d)
        if label.startswith("rank"):
            if got.rank.tolist() != [5, 5, 4, 0] or got.x[3].any():
                raise AssertionError(f"lsq {label}: ranks {got.rank.tolist()}, zero matrix x "
                                     f"{got.x[3].tolist()}")
    empty = k21.lstsq(torch.zeros((0, 3), device=device), torch.zeros(0, device=device))
    if empty.x.shape != (3,) or empty.x.any() or int(empty.rank) != 0:
        raise AssertionError("lsq: the empty matrix's answer is not JAX's zeros")
    # a Jacobi loop cut at one sweep reports -1 sweeps, and the check raises
    a = torch.from_numpy(rng.standard_normal((2, 300, 10)).astype(np.float32)).to(device)
    cut = k21._lstsq_cuda(a, a[:, :, 0].contiguous(), max_sweeps=1)
    if cut.sweeps.tolist() != [-1, -1]:
        raise AssertionError(f"lsq cut at one sweep: sweeps {cut.sweeps.tolist()}, not -1")
    try:
        k21.require_converged(cut)
    except ArithmeticError as exc:
        print(f"  lsq cut at one sweep: sweeps -1, require_converged raised ({exc}) ok",
              flush=True)
    else:
        raise AssertionError("lsq cut at one sweep: require_converged did not raise")
    return err


def lsq_times(A, b, peak_sweeps):
    """lsq's kernel, device, twin and library (``torch.linalg.lstsq``, gels:
    full-rank systems only) times on A [N, m, n], b [N, m], and its bound:
    A, b in and x out vs the Gram's and the Jacobi sweeps' float64
    operations (``peak_sweeps`` sweeps of n(n-1)/2 rotations, 12n each)."""
    import torch

    from predictionio_tpu_torch.ops import lstsq as k21

    N, m, n = A.shape
    w = n + 1
    b3 = b[:, :, None]
    ops = 2 * N * m * w * (w + 1) / 2 + N * peak_sweeps * n * (n - 1) / 2 * 12 * n
    return {
        "ms": time_ms(lambda: k21.lstsq(A, b), iters=100, warmup=3),
        "device_ms": device_ms(lambda: k21.lstsq(A, b)),
        "plain_ms": time_ms(lambda: k21.lstsq_plain(A, b), iters=20, warmup=2),
        "library_ms": time_ms(lambda: torch.linalg.lstsq(A, b3), iters=50, warmup=3),
        "bound": roofline(4 * N * m * w + 4 * N * n, ops, PEAK_FP64_FLOPS),
        "shape": [N, m, n],
    }


def stock_phase(device):
    """K21: ``backtest(RegressionStrategy())`` on a 500-ticker synthetic panel
    of 600 days with the DataSource's default windows, counted from 0 (lsq =
    4, one per window; twin 0); each window's coefficients against float64
    numpy and the twin; then lsq's edge cases; times at the path's shape.
    Returns (launches, errors, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.experimental import stock
    from predictionio_tpu_torch.ops import lstsq as k21
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    tickers = ("SPY",) + tuple(f"T{j:03d}" for j in range(STOCK_TICKERS - 1))

    class Recording(stock.RegressionStrategy):
        def train(self, device, td):
            model = super().train(device, td)
            self.windows.append((td, model))
            return model

    algo = Recording()
    algo.windows = []
    params = stock.DataSourceParams(n_days=STOCK_DAYS, tickers=tickers)
    k21.LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = stock.backtest(algo, params, ctx=WorkflowContext(device))
    backtest_s = time.perf_counter() - t
    counts = k21.LAUNCHES.snapshot()
    if counts != {"lsq": 4, "lsq_plain": 0} or len(algo.windows) != 4:
        raise AssertionError(f"stock launches {counts} over {len(algo.windows)} windows, "
                             "expected lsq = 4 and twin 0")
    err = 0.0
    for w, (td, model) in enumerate(algo.windows):
        X, y, _ = algo.design(td)
        coef = np.stack([model[t] for t in tickers]).astype(np.float64)
        x64 = lsq_oracle(X, y)
        d = (np.abs(coef - x64).max(axis=1) / np.abs(x64).max(axis=1)).max()
        if not d <= LSQ_TOL:
            raise AssertionError(f"K21 window {w}: coefficients {d:.3g} off float64")
        err = max(err, float(d))
    print(f"  K21: backtest over {STOCK_TICKERS} tickers, 4 windows of [{STOCK_TICKERS}, "
          f"{X.shape[1]}, {X.shape[2]}] in {backtest_s:.2f} s, lsq = 4; coefficients within "
          f"{err:.3g} of float64 (of each ticker's largest) ok; {result.overall.days} days, "
          f"Sharpe {result.overall.sharpe:.4f}", flush=True)
    X, y, _ = algo.design(algo.windows[0][0])
    A, b = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)
    d_path, got = check_lsq(A, b, f"stock window 0, {list(X.shape)}")
    d_edges = check_lsq_edges(device)
    times = lsq_times(A, b, max_sweeps(got))
    stats = {"card": card_line(), "tickers": STOCK_TICKERS, "days": STOCK_DAYS,
             "backtest_s": backtest_s, "launches": counts, "coef_vs_float64": err,
             "sharpe": result.overall.sharpe, "sweeps_max": max_sweeps(got), **times}
    print("stock " + json.dumps(stats), flush=True)
    return counts["lsq"], max(d_path, d_edges), stats


def regression_phase(device, workdir):
    """K22: a 200,000-line x 10-feature file; ``OLSAlgorithm.train``, then
    ``run_evaluation`` with ``MeanSquareError`` over 5 folds, counted from 0
    (lsq = 6, twin 0); the model saved, deployed through ``tools.cli deploy
    --device cuda`` and sent 64 queries from 8 clients, every answer equal to
    ``batch_predict``'s; the coefficients and the MSE against float64 numpy;
    times at the path's shape. Returns (launches, errors, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.controller import EmptyParams
    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.controller.evaluation import Evaluation
    from predictionio_tpu_torch.models.experimental import regression as reg
    from predictionio_tpu_torch.ops import lstsq as k21
    from predictionio_tpu_torch.utils.serialize import save_model
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation

    rng = np.random.default_rng(REG_SEED)
    Xw = rng.standard_normal((REG_ROWS, REG_FEATURES))
    yw = Xw @ rng.uniform(-2.0, 2.0, REG_FEATURES) + 0.1 * rng.standard_normal(REG_ROWS)
    path = os.path.join(workdir, "regression.txt")
    np.savetxt(path, np.column_stack([yw, Xw]), fmt="%.9g")

    k21.LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    td = reg.DataSource(reg.DataSourceParams(filepath=path)).read_training(None)
    read_s = time.perf_counter() - t
    t = time.perf_counter()
    model = reg.OLSAlgorithm().train(device, reg.Preparator().prepare(device, td))
    train_s = time.perf_counter() - t
    t = time.perf_counter()
    result = run_evaluation(
        Evaluation().set_engine_metric(reg.regression_engine(), reg.MeanSquareError()),
        [EngineParams(data_source_params=("", reg.DataSourceParams(filepath=path,
                                                                   eval_k=REG_FOLDS)),
                      algorithm_params_list=(("ols", EmptyParams()),))],
        ctx=WorkflowContext(device),
    )
    eval_s = time.perf_counter() - t
    model_path = os.path.join(workdir, "ols.npz")
    save_model(model_path, model)
    bodies = [{"features": [float(v) for v in td.x[j]]} for j in range(X_SERVED)]
    server = Deployment(model_path, device)
    try:
        answers, wall = server.send(bodies, X_CLIENTS)
        status = server.status()
    finally:
        server.stop()
    counts = k21.LAUNCHES.snapshot()
    if counts != {"lsq": 1 + REG_FOLDS, "lsq_plain": 0}:
        raise AssertionError(f"regression launches {counts}, expected lsq = {1 + REG_FOLDS} "
                             "and twin 0")
    want = reg.OLSAlgorithm().batch_predict(model, [(i, reg.Query(**b))
                                                    for i, b in enumerate(bodies)])
    for (i, _, res), (_, p) in zip(answers, want):
        if res.get("prediction") != p.prediction or res.get("modelVersion") != "ols":
            raise AssertionError(f"OLS deployment: query {i} answered {res}, batch_predict {p}")

    x64 = lsq_oracle(td.x[None], td.y[None])[0]
    d_coef = np.abs(model - x64).max() / np.abs(x64).max()
    if not d_coef <= LSQ_TOL:
        raise AssertionError(f"K22: coefficients {d_coef:.3g} off float64")
    sq = []
    for fold in range(REG_FOLDS):
        sel = np.arange(len(td.y)) % REG_FOLDS == fold
        c64 = lsq_oracle(td.x[~sel][None], td.y[~sel][None])[0]
        sq.append((td.x[sel].astype(np.float64) @ c64 - td.y[sel]) ** 2)
    mse64 = float(np.concatenate(sq).mean())
    mse = result.best_score.score
    if not abs(mse - mse64) <= MSE_RTOL * mse64:
        raise AssertionError(f"K22: MSE {mse} against float64 folds' {mse64}")
    print(f"  K22: OLSAlgorithm.train {train_s:.4f} s (the file read {read_s:.2f} s), "
          f"coefficients {d_coef:.3g} of the largest off float64; run_evaluation over "
          f"{REG_FOLDS} folds {eval_s:.2f} s, MSE {mse:.6g} (float64 folds {mse64:.6g}); the "
          f"deployment answered {X_SERVED} queries from {X_CLIENTS} clients equal to "
          f"batch_predict; lsq = {counts['lsq']} ok", flush=True)
    A = torch.from_numpy(td.x).to(device)
    b = torch.from_numpy(td.y).to(device)
    d_path, got = check_lsq(A[None], b[None], f"regression [1, {REG_ROWS}, {REG_FEATURES}]")
    times = lsq_times(A[None].contiguous(), b[None].contiguous(), max_sweeps(got))
    stats = {"card": card_line(), "rows": REG_ROWS, "features": REG_FEATURES,
             "folds": REG_FOLDS, "read_s": read_s, "train_s": train_s, "eval_s": eval_s,
             "mse": mse, "mse_float64": mse64, "coef_vs_float64": float(d_coef),
             "served": {"queries": len(answers), "batches": status["batches"],
                        **latency_stats(answers, wall), "deploy_s": server.deploy_s},
             "launches": counts, "sweeps_max": max_sweeps(got), **times}
    print("regression " + json.dumps(stats), flush=True)
    return counts["lsq"], d_path, stats


def experimental_phase(device, workdir):
    """Phase 3x: K17 (``cnb_phase``), K16 (``markov_phase``), K21
    (``stock_phase``) and K22 (``regression_phase``), each counted from 0.
    Returns (launches, errors, stats) keyed by kernel, and what 3k reuses
    of K17's and K16's paths."""
    t = time.perf_counter()
    c_counts, c_errs, c_stats, c_refs = cnb_phase(device)
    m_launches, m_err, m_stats, m_refs = markov_phase(device)
    s_launches, s_err, s_stats = stock_phase(device)
    r_launches, r_err, r_stats = regression_phase(device, workdir)
    launches = {**c_counts, "markov_step": m_launches, "lsq": s_launches + r_launches}
    errs = {**c_errs, "markov_step": m_err, "lsq": max(s_err, r_err)}
    print(f"  3x: launches {launches} in {time.perf_counter() - t:.1f} s", flush=True)
    return launches, errs, {"cnb": c_stats, "markov": m_stats, "stock": s_stats,
                            "regression": r_stats}, {"cnb": c_refs, "markov": m_refs}


# phase 3k (after 3x): classification and the e2 models on a mesh (K15s,
# K16s, K17s) over 3n's and 3x's data
E2_SHARDS = 4  # 3k: logical shards of the card (every shard on the card)


def e2_counters():
    from predictionio_tpu_torch.ops import categorical_nb, markov, naive_bayes

    return naive_bayes.LAUNCHES, categorical_nb.LAUNCHES, markov.LAUNCHES


def check_e2_counts(counts, want, label):
    """Every named count as wanted, every other kernel and twin 0."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"3k {label}: {name} launched {n} times, not {want.get(name, 0)}"
                                 f" ({ {k: v for k, v in counts.items() if v} })")


def float_steps(a, b):
    """(the largest distance in float32 steps, the entries that differ) of
    two non-negative float32 vectors."""
    import numpy as np

    d = np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
               - np.asarray(b, np.float32).view(np.int32).astype(np.int64))
    return int(d.max()) if d.size else 0, int(np.count_nonzero(d))


def mesh_e2_edges(device, mesh):
    """Each program's edge cases on the card against one device: fewer rows
    than shards, a row count that does not divide the shards, a mesh of one
    shard (no shard launch), a 2-D mesh (``ValueError``)."""
    import numpy as np

    from predictionio_tpu_torch.e2 import CategoricalNaiveBayes, LabeledPoint, MarkovChain
    from predictionio_tpu_torch.ops import naive_bayes as k15
    from predictionio_tpu_torch.parallel.mesh import Mesh

    S = mesh.size
    one = Mesh([device], {"data": 1})
    two_d = Mesh([device] * S, {"data": S // 2, "model": 2})
    counters = e2_counters()
    rng = np.random.default_rng(CLS_SEED + 7)
    for n, F, C in ((3, 3, 2), (1_283, 3, 4), (50_001, 3, 4)):
        X = rng.poisson(3.0, size=(n, F)).astype(np.float32)
        y = rng.integers(0, C, n).astype(np.float32)
        want = k15.train_naive_bayes(X, y, device=device)
        for m in (mesh, one):
            got = k15.train_naive_bayes(X, y, mesh=m)
            if not (same_bits(got.pi, want.pi) and same_bits(got.theta, want.theta)):
                raise AssertionError(f"3k edges: K15s's fit of {n} rows on {m.size} shards differs")
        Q = X[: min(n, 7)]
        for m in (mesh, one):
            if not np.array_equal(k15.predict_naive_bayes(want, Q, mesh=m),
                                  k15.predict_naive_bayes(want, Q)):
                raise AssertionError(f"3k edges: K15s's labels of {len(Q)} rows differ")
    pts = [LabeledPoint(str(rng.integers(0, 2)), (str(rng.integers(0, 5)), str(rng.integers(0, 3))))
           for _ in range(12_345)]
    for few in (pts[:2], pts):
        want = CategoricalNaiveBayes.train(few, device=device)
        for m in (mesh, one):
            got = CategoricalNaiveBayes.train(few, mesh=m)
            if not same_bits(got.log_likelihoods, want.log_likelihoods):
                raise AssertionError(f"3k edges: K17s on {len(few)} points differs")
    for n_states in (3, 21):
        chain = MarkovChain.train([(int(a), int(b), 1.0) for a, b in rng.integers(0, n_states, (60, 2))],
                                  n_states, 2, device=device)
        cur = rng.dirichlet(np.ones(n_states)).astype(np.float32)
        want = chain.predict(cur)
        if float_steps(chain.predict(cur, mesh=mesh), want)[0] > 1:
            raise AssertionError(f"3k edges: K16s on {n_states} states is a step off")
        if not same_bits(np.asarray(chain.predict(cur, mesh=one), np.float32),
                         np.asarray(want, np.float32)):
            raise AssertionError("3k edges: K16s on a mesh of one shard differs")
    for c in counters:
        c.reset()
    X = rng.poisson(3.0, size=(700, 3)).astype(np.float32)
    y = rng.integers(0, 3, 700).astype(np.float32)
    m1 = k15.train_naive_bayes(X, y, mesh=one)
    k15.predict_naive_bayes(m1, X, mesh=one)
    CategoricalNaiveBayes.train(pts[:50], mesh=one)
    chain.predict(cur, mesh=one)
    counts = snapshot(counters)
    check_e2_counts(counts, {"naive_bayes_fit": 1, "naive_bayes_scores": 1, "cnb_count": 1,
                             "markov_step": 1}, "a mesh of one shard")
    for call in (lambda: k15.train_naive_bayes(X, y, mesh=two_d),
                 lambda: k15.predict_naive_bayes(m1, X, mesh=two_d),
                 lambda: CategoricalNaiveBayes.train(pts[:50], mesh=two_d),
                 lambda: chain.predict(cur, mesh=two_d)):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("3k edges: a 2-D mesh did not raise")
    print(f"  edge cases (fewer rows than shards, counts that do not divide {S}, a mesh of one "
          "shard on the single-device kernels, a 2-D mesh raising) on every program ok", flush=True)


def mesh_e2_phase(device, workdir, cls_refs, x_refs):
    """3k: classification and the e2 models on a mesh of E2_SHARDS logical
    shards of the card (``[cuda:0] * 4``; with several cards also on the
    visible cards), over 3n's and 3x's data. The main path
    (``Engine.train`` of the classification template on
    ``WorkflowContext(mesh=...)`` at config 2's shape) counted from 0 and
    bit for bit 3n's model, then deployed by ``tools.cli deploy`` and its
    HTTP answers equal to 3n's; K15s's scores at B = 2,048 and on the NaN
    and tie models, every label one device's; K17s
    (``CategoricalNaiveBayes.train(mesh=)`` on 3x's 1M Adult rows) bit for
    bit 3x's model, its answers 3x's; K16s (100 ``predict(mesh=)`` on 3x's
    chain) within one float32 step of 3x's answers, with the count of
    entries that differ, and the first against float64 numpy; the edge
    cases; times of each shard form beside one device's launch and the
    library call. Returns (launches, errors, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.e2 import CategoricalNaiveBayes
    from predictionio_tpu_torch.models.classification import engine as clf
    from predictionio_tpu_torch.ops import categorical_nb as k17
    from predictionio_tpu_torch.ops import markov as k16
    from predictionio_tpu_torch.ops import naive_bayes as k15
    from predictionio_tpu_torch.parallel.mesh import Mesh, cut_rows
    from predictionio_tpu_torch.utils.serialize import save_model
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

    t_phase = time.perf_counter()
    S = E2_SHARDS
    mesh = Mesh([device] * S, {"data": S})
    note = ("logical shards of one card run one after another on its stream: "
            "these are not multi-GPU times")
    print(f"  {S} logical shards of {device}: {note}", flush=True)
    counters = e2_counters()
    errs, launches = {}, {}
    stats = {"card": card_line(), "note": note, "shards": S}

    # a. the main path: Engine.train of the classification template on the
    # workflow's mesh, then its model deployed
    labels, features, nb_one = cls_refs["labels"], cls_refs["features"], cls_refs["model"]
    props = {f"u{j}": {"plan": float(labels[j]), "attr0": float(features[j, 0]),
                       "attr1": float(features[j, 1]), "attr2": float(features[j, 2])}
             for j in range(CLS_N)}
    ctx = WorkflowContext(device, properties={("default", "user"): props}, mesh=mesh)
    ep = EngineParams(
        data_source_params=("", clf.DataSourceParams(app_name="default")),
        algorithm_params_list=(("naive", clf.NaiveBayesAlgorithmParams(lambda_=1.0)),),
    )
    fit_bounds = k15.fit_shard_bounds(CLS_N, CLS_C, CLS_F, S)
    filled = int(np.count_nonzero(np.diff(fit_bounds)))
    for c in counters:
        c.reset()
    fits, real_fit_shards = [], k15.naive_bayes_fit_shards
    k15.naive_bayes_fit_shards = lambda X, *a, **kw: fits.append(len(X)) or real_fit_shards(
        X, *a, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        [nb_mesh] = clf.classification_engine().train(ctx, ep, WorkflowParams())
    finally:
        k15.naive_bayes_fit_shards = real_fit_shards
    train_s = time.perf_counter() - t
    counts = snapshot(counters)
    # every shard on the card: one launch over their table, reached through
    # the mesh's shard fit
    check_e2_counts(counts, {"naive_bayes_fit": 1}, "Engine.train")
    if fits != [S]:
        raise AssertionError(f"3k: Engine.train's shard fits {fits}, not one of {S} shards")
    launches["Engine.train"] = {k: v for k, v in counts.items() if v}
    if not (same_bits(nb_mesh.pi, nb_one.pi) and same_bits(nb_mesh.theta, nb_one.theta)
            and np.array_equal(nb_mesh.labels, nb_one.labels) and nb_mesh.device == device):
        raise AssertionError("3k: the mesh's naive Bayes model differs from 3n's")
    errs["naive_bayes_fit_sharded"] = float(max(np.abs(nb_mesh.pi - nb_one.pi).max(),
                                                np.abs(nb_mesh.theta - nb_one.theta).max()))
    path = os.path.join(workdir, "classification_naive_mesh.npz")
    save_model(path, nb_mesh)
    server = Deployment(path, device)
    try:
        answers, wall = server.send(cls_refs["bodies"], CLS_CLIENTS)
    finally:
        server.stop()
    for (i, _, res), want in zip(answers, cls_refs["answers"]):
        if res.get("label") != want.get("label"):
            raise AssertionError(f"3k deployment: query {i} answered {res}, 3n's {want}")
    print(f"  main path: Engine.train on the mesh {train_s:.4f} s (3n's NaiveBayesAlgorithm.train "
          f"on one device {cls_refs['train_s']:.4f} s), rows per shard "
          f"{np.diff(fit_bounds).tolist()}, "
          f"launches { {k: v for k, v in counts.items() if v} }; pi and theta bit for bit 3n's; "
          f"deployed, {len(answers)} HTTP answers from {CLS_CLIENTS} clients equal to 3n's ok",
          flush=True)
    stats["classification"] = {"train_s": train_s, "one_device_train_s": cls_refs["train_s"],
                               "shard_rows": np.diff(fit_bounds).tolist(),
                               "served": {"queries": len(answers), "deploy_s": server.deploy_s,
                                          **latency_stats(answers, wall)}}

    # b. K15s's scores at B = 2,048 and on the NaN and tie models
    Qn = features[:CLS_QUERIES]
    for c in counters:
        c.reset()
    got = k15.predict_naive_bayes(nb_mesh, Qn, mesh=mesh)
    counts = snapshot(counters)
    # every shard on the card: one launch over their table
    check_e2_counts(counts, {"naive_bayes_scores": 1}, "predict_naive_bayes")
    launches["predict_naive_bayes"] = {k: v for k, v in counts.items() if v}
    if not np.array_equal(got, k15.predict_naive_bayes(nb_one, Qn)):
        raise AssertionError("3k: K15s's labels differ from one device's")
    for m, Q in nan_and_tie_models(device):
        if not np.array_equal(k15.predict_naive_bayes(m, Q, mesh=mesh),
                              k15.predict_naive_bayes(m, Q)):
            raise AssertionError("3k: K15s's labels on the NaN or tie model differ")
    errs["naive_bayes_scores_sharded"] = 0.0
    print(f"  K15s scores: {CLS_QUERIES} rows on {S} shards (one launch over their table) and "
          "the NaN (lam = 0) and tie models' rows: every label one device's ok", flush=True)

    # c. K17s: CategoricalNaiveBayes.train on 3x's 1M Adult rows
    cr = x_refs["cnb"]
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    cnb_mesh = CategoricalNaiveBayes.train(cr["points"], mesh=mesh)
    cnb_train_s = time.perf_counter() - t
    counts = snapshot(counters)
    L, S_slots, V = cnb_mesh.log_likelihoods.shape
    n_keys, M = S_slots * L * V, CNB_N * S_slots
    key_bounds = k17.count_shard_bounds(M, n_keys, S)
    check_e2_counts(counts, {"cnb_count_shard": int(np.count_nonzero(np.diff(key_bounds))),
                             "cnb_count_finish": 1}, "CategoricalNaiveBayes.train")
    launches["CategoricalNaiveBayes.train"] = {k: v for k, v in counts.items() if v}
    cnb_one = cr["model"]
    if not (same_bits(cnb_mesh.log_likelihoods, cnb_one.log_likelihoods)
            and same_bits(cnb_mesh.log_priors, cnb_one.log_priors)):
        raise AssertionError("3k: K17s's model differs from 3x's")
    if (cnb_mesh.predict_batch(cr["rows"]) != cr["served"]
            or cnb_mesh.predict_batch(cr["unknown_rows"]) != cr["served_unknown"]):
        raise AssertionError("3k: the mesh model's answers differ from 3x's")
    errs["cnb_count_sharded"] = 0.0
    print(f"  K17s: CategoricalNaiveBayes.train(mesh) on {CNB_N:,} rows {cnb_train_s:.3f} s "
          f"(3x on one device {cr['train_s']:.3f} s), keys per shard "
          f"{np.diff(key_bounds).tolist()}; counts and log-likelihoods bit for bit 3x's, "
          "predict_batch's answers 3x's ok", flush=True)

    # d. K16s: 100 predicts on 3x's chain
    mr = x_refs["markov"]
    chain, curs, outs = mr["model"], mr["curs"], mr["outs"]
    t = time.perf_counter()
    placed = chain._mesh_transitions(mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t
    for c in counters:
        c.reset()
    t = time.perf_counter()
    mesh_outs = [chain.predict(cur, mesh=mesh) for cur in curs]
    predict_s = time.perf_counter() - t
    counts = snapshot(counters)
    n_work = sum(sh is not None for sh in placed.shards)
    check_e2_counts(counts, {"markov_step_shard": n_work * MC_PREDICTS,
                             "markov_step_finish": MC_PREDICTS}, "MarkovChainModel.predict")
    launches["MarkovChainModel.predict"] = {k: v for k, v in counts.items() if v}
    steps, differ, err = 0, 0, 0.0
    for got, want in zip(mesh_outs, outs):
        st, nd = float_steps(got, want)
        steps, differ = max(steps, st), differ + nd
        err = max(err, float(np.abs(np.asarray(got, np.float64) - np.asarray(want)).max()))
    if steps > 1:
        raise AssertionError(f"3k: K16s lies {steps} float32 steps from one device's answers")
    contrib = (chain.probs * curs[0][:, None]).astype(np.float32).ravel().astype(np.float64)
    n64 = np.bincount(chain.targets.ravel(), weights=contrib, minlength=MC_STATES)
    d64 = np.abs(np.asarray(mesh_outs[0], np.float64) - n64).max() / np.abs(n64).max()
    if not d64 <= MC_RTOL:
        raise AssertionError(f"3k: K16s {d64:.3g} of the largest entry off float64 numpy")
    errs["markov_step_sharded"] = err
    print(f"  K16s: {MC_PREDICTS} predicts on {S} shards ({predict_s:.4f} s; 3x on one device "
          f"{mr['predict_s']:.4f} s; placement {place_s:.3f} s), sources per shard "
          f"{np.diff(placed.bounds).tolist()}: at most {steps} float32 step from one device's "
          f"answers, {differ} of {MC_PREDICTS * MC_STATES:,} entries differ; the first "
          f"{d64:.3g} of the largest entry off float64 numpy ok", flush=True)

    mesh_e2_edges(device, mesh)

    # e. times: each shard's launch (K15s's fit: its one launch over every
    # shard), the shards with any finish together, one device's launch, the
    # twins on the shards, the library call per shard
    X, y = torch.from_numpy(features).to(device), torch.from_numpy(labels.astype(np.int32)).to(device)
    rows = k15.fit_plan(CLS_N, CLS_C, CLS_F)[1]
    Xs = cut_rows(mesh, features, fit_bounds)
    ys = cut_rows(mesh, labels.astype(np.int32), fit_bounds)
    fit_shards = [(int(a) // rows, -(-int(b - a) // rows), Xi, yi)
                  for a, b, Xi, yi in zip(fit_bounds[:-1], fit_bounds[1:], Xs, ys) if b > a]
    pi1, th1 = torch.from_numpy(nb_one.pi).to(device), torch.from_numpy(nb_one.theta).to(device)
    q_bounds = np.linspace(0, CLS_QUERIES, S + 1).astype(np.int64)
    Qs = cut_rows(mesh, Qn, q_bounds)
    Qd = torch.from_numpy(np.ascontiguousarray(Qn)).to(device)
    out_idx = torch.empty(CLS_QUERIES, dtype=torch.int32, device=device)
    # the device part of predict_naive_bayes(mesh=) on the card: one upload,
    # every shard's rows and block in one table
    score_table = [k15.ScoresShard(Qd[a:b], out_idx[a:b]) for a, b in zip(q_bounds[:-1], q_bounds[1:])]
    keys = cr["keys"]  # 3x's keys of the same points: the mesh model's indexes are 3x's
    keys_d = torch.from_numpy(keys).to(device)
    per_block = k17.count_plan(M, n_keys)[1]
    key_shards = cut_rows(mesh, keys, key_bounds)
    kparts = [(int(a) // per_block, Ki) for a, b, Ki in zip(key_bounds[:-1], key_bounds[1:],
                                                            key_shards) if b > a]
    kpartial = torch.empty((k17.count_plan(M, n_keys)[0], n_keys), dtype=torch.int32, device=device)
    one_placed = k16.place_transitions(chain.targets, chain.probs, MC_STATES, device)
    cur0 = curs[0]
    cur_d = torch.from_numpy(cur0).to(device)
    cur_s = cut_rows(mesh, cur0, placed.bounds)
    mparts = torch.empty((n_work, MC_STATES), dtype=torch.float64, device=device)
    mwork = [(c_, sh) for c_, sh in zip(cur_s, placed.shards) if sh is not None]
    contrib_s = [(k16.entry_targets(sh), (sh.prob * c_[sh.src.long()]).double()) for c_, sh in mwork]

    def each(calls):
        def run():
            for f in calls:
                f()
        return run

    forms = {
        "naive_bayes_fit_sharded": {
            "shards": [],  # one launch over the shard table: no call a shard
            "all": lambda: k15.naive_bayes_fit_shards(Xs, ys, CLS_C, 1.0, device),
            "one": lambda: k15.naive_bayes_fit(X, y, CLS_C, 1.0),
            "plain": lambda: k15.fit_finish_plain(*(torch.cat(t) for t in zip(*(
                k15.fit_partial_plain(Xi, yi, CLS_C, rows) for _, _, Xi, yi in fit_shards))), 1.0),
            "library": [lambda Xi=Xi, yi=yi: torch.zeros((CLS_C, CLS_F), device=device).index_add_(
                0, yi.long(), Xi) for _, _, Xi, yi in fit_shards],
            "bound": roofline(4 * (CLS_N * CLS_F + CLS_N + 2 * CLS_C + 2 * CLS_C * CLS_F),
                              CLS_N * CLS_F),
        },
        "naive_bayes_scores_sharded": {
            "shards": [],  # one launch over the shard table: no call a shard
            "all": lambda: k15.naive_bayes_scores_table(score_table, pi1, th1),
            "one": lambda: k15.naive_bayes_scores(Qd, pi1, th1),
            "plain": lambda: [k15.argmax_first_nan(k15.scores_plain(Qi, pi1, th1)) for Qi in Qs],
            "library": [lambda Qi=Qi: torch.addmm(pi1, Qi, th1.T).argmax(1) for Qi in Qs],
            "bound": roofline(4 * (CLS_QUERIES * CLS_F + CLS_C + CLS_C * CLS_F + CLS_QUERIES),
                              2 * CLS_QUERIES * CLS_C * CLS_F + CLS_QUERIES * CLS_C),
        },
        "cnb_count_sharded": {
            "shards": [lambda b0=b0, Ki=Ki: k17.cnb_count_partial(
                Ki, n_keys, per_block, out=kpartial[b0:b0 + -(-Ki.shape[0] // per_block)])
                for b0, Ki in kparts],
            "all": lambda: k17.cnb_count_shards(key_shards, n_keys, device),
            "one": lambda: k17.cnb_count(keys_d, n_keys),
            "plain": lambda: torch.cat([k17.count_partial_plain(Ki, n_keys, per_block)
                                        for _, Ki in kparts]).sum(0, dtype=torch.int64),
            "library": [lambda Ki=Ki: torch.bincount(Ki, minlength=n_keys) for _, Ki in kparts],
            "bound": roofline(4 * M + 4 * n_keys, M),
        },
        "markov_step_sharded": {
            "shards": [lambda k=k, c_=c_, sh=sh: k16.markov_step_partial(c_, sh, out=mparts[k])
                       for k, (c_, sh) in enumerate(mwork)],
            "all": lambda: k16.markov_step_shards(cur_s, placed),
            "one": lambda: k16.markov_step(cur_d, one_placed),
            "plain": lambda: k16.sum_shards_plain(torch.stack(
                [k16.markov_partial_plain(c_, sh) for c_, sh in mwork])),
            "library": [lambda te=te, ce=ce: torch.zeros(MC_STATES, dtype=torch.float64,
                                                        device=device).index_add_(0, te, ce)
                        for te, ce in contrib_s],
            "bound": roofline(8 * MC_STATES + 8 * placed_entries(placed), 2 * placed_entries(placed)),
        },
    }
    times = {}
    for name, f in forms.items():
        whole = f.get("all", each(f["shards"]))
        times[name] = {
            "per_shard_ms": [time_ms(c, iters=100, warmup=3) for c in f["shards"]],
            "shards_ms": time_ms(whole, iters=100, warmup=3),
            "shards_device_ms": device_ms(whole),
            "one_device_ms": time_ms(f["one"], iters=100, warmup=3),
            "plain_shards_ms": time_ms(f["plain"], iters=5, warmup=1),
            "library_shards_ms": time_ms(each(f["library"]), iters=100, warmup=3),
            "library_per_shard_ms": [time_ms(c, iters=100, warmup=3) for c in f["library"]],
            "bound": f["bound"],
        }
        print(f"  {name}: {json.dumps(times[name])}", flush=True)
    times["naive_bayes_fit_sharded"]["host_us"] = host_breakdown(
        forms["naive_bayes_fit_sharded"]["all"], wrapper_parts(k15))
    print(f"  K15s fit host µs a call: {json.dumps(times['naive_bayes_fit_sharded']['host_us'])}",
          flush=True)
    times["naive_bayes_scores_sharded"]["host_us"] = host_breakdown(
        forms["naive_bayes_scores_sharded"]["all"], wrapper_parts(k15))
    print(f"  K15s scores host µs a call: "
          f"{json.dumps(times['naive_bayes_scores_sharded']['host_us'])}", flush=True)
    stats.update({
        "cnb": {"train_s": cnb_train_s, "one_device_train_s": cr["train_s"],
                "shard_keys": np.diff(key_bounds).tolist()},
        "markov": {"predict_s": predict_s, "one_device_predict_s": mr["predict_s"],
                   "place_s": place_s, "shard_sources": np.diff(placed.bounds).tolist(),
                   "max_steps": steps, "entries_differing": differ, "vs_float64": d64},
        "kernel_ms": times, "launches": launches, "errors": errs,
    })
    # an N-card mesh, under the same checks, where the machine has cards
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", c) for c in range(min(S, n_cards))]
        cmesh = Mesh(cards, {"data": len(cards)})
        got = clf.NaiveBayesAlgorithm(clf.NaiveBayesAlgorithmParams(lambda_=1.0)).train(
            cmesh, clf.Preparator().prepare(device, clf.TrainingData(
                labels=labels.astype(np.float32), features=features)))
        if not (same_bits(got.pi, nb_one.pi) and same_bits(got.theta, nb_one.theta)):
            raise AssertionError("3k: K15s on distinct cards differs from 3n's model")
        if not np.array_equal(k15.predict_naive_bayes(nb_one, Qn, mesh=cmesh),
                              k15.predict_naive_bayes(nb_one, Qn)):
            raise AssertionError("3k: K15s's labels on distinct cards differ")
        if not same_bits(CategoricalNaiveBayes.train(cr["points"], mesh=cmesh).log_likelihoods,
                         cnb_one.log_likelihoods):
            raise AssertionError("3k: K17s on distinct cards differs from 3x's model")
        if float_steps(chain.predict(curs[0], mesh=cmesh), outs[0])[0] > 1:
            raise AssertionError("3k: K16s on distinct cards is a step off")
        print(f"  a mesh of {len(cards)} cards: K15s, K17s bit for bit, K16s within a step",
              flush=True)
    else:
        print("  one card: no mesh of distinct cards to run", flush=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    print("mesh_e2 " + json.dumps(stats), flush=True)
    return launches, errs, stats


def placed_entries(placed) -> int:
    """The kept transitions of a ``MeshTransitions`` over every shard."""
    return sum(int(sh.src.numel()) for sh in placed.shards if sh is not None)


# phase 3y (after 3x): SimRank friend recommendation (K20a, K20b), K3c
# (ServingFactors.measure_compute_ms) and the five experimental templates
# that need no event store
WV_VERTICES, WV_EDGES, WV_SEED = 7_115, 103_689, 43  # SNAP Wiki-Vote's size
SR_ITERS, SR_DECAY = 5, 0.8  # SimRankParams' defaults
SR_SERVED, SR_CLIENTS = 64, 8
K3C_ITERS, K3C_REPS = 4096, 5  # the bench's call (bench.py:447), measure_compute_ms' reps
ML100K_USERS, ML100K_ITEMS, ML100K_RATINGS = 943, 1682, 100_000
ML100K_ALS = {"rank": 10, "num_iterations": 10, "lambda_": 0.05}  # bench.py:70, :431


def wiki_vote_edges(seed=WV_SEED, n=WV_VERTICES, m=WV_EDGES):
    """A seeded directed edge list of SNAP Wiki-Vote's size (7,115 vertices,
    103,689 edges): out-degrees drawn by Pareto-1.6 weights (the largest
    about 900, as Wiki-Vote's 893), targets by Pareto-2.0 popularity (the
    largest in-degree about 500, as its 457), 5 % of the vertices without
    out-edges, 1 % of the edges repeated, 300 self-loops (n/10 on a smaller
    graph); vertex n-1 is a
    target, so the file reads back n vertices."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dup, n_loop = m // 100, min(300, n // 10)
    out_w = rng.pareto(1.6, n) + 1.0
    out_w[rng.choice(n, n // 20, replace=False)] = 0.0
    deg = rng.multinomial(m - n_dup - n_loop - 1, out_w / out_w.sum())
    src = np.repeat(np.arange(n), deg)
    pop = rng.pareto(2.0, n) + 1.0
    dst = rng.choice(n, len(src), p=pop / pop.sum())
    edges = np.stack([src, dst], 1)
    loops = rng.choice(np.flatnonzero(deg), n_loop, replace=False)
    sources = np.flatnonzero(deg)
    edges = np.concatenate([
        edges, edges[rng.choice(len(edges), n_dup, replace=False)],
        np.stack([loops, loops], 1), [[sources[0], n - 1]],
    ])
    return edges[rng.permutation(len(edges))].astype(np.int64)


def simrank64(edges, n, iters, decay):
    """SimRank in float64 numpy, dense: the reference's fixpoint with a
    float64 P."""
    import numpy as np

    P = np.zeros((n, n))
    if len(edges):
        deg = np.bincount(edges[:, 0], minlength=n).astype(np.float64)
        np.add.at(P, (edges[:, 0], edges[:, 1]), 1.0 / deg[edges[:, 0]])
    S = np.eye(n)
    for _ in range(iters):
        S = decay * (P @ S @ P.T)
        np.fill_diagonal(S, 1.0)
    return S


def simrank_bound(n: int, nnz: int):
    """K20a's or K20b's (bound_ms, bound_by): the [n, n] input read and the
    [n, n] output written once, the CSR once, against 2·nnz·n fp32
    operations."""
    return roofline(8.0 * n * n + 4.0 * (n + 1) + 8.0 * nnz, 2.0 * nnz * n)


def within(got, want, rtol=RTOL, atol=ATOL):
    """The largest |got - want| and whether every entry lies within atol +
    rtol·|want|."""
    import numpy as np

    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(g - w)
    return (float(d.max()) if d.size else 0.0), bool((d <= atol + rtol * np.abs(w)).all())


def check_simrank(edges, n, label, device, iters=SR_ITERS, against64=False):
    """K20a and K20b against their twins on the card (TF32 off): the loop of
    ``iters`` iterations against the dense loop; each kernel against its
    twin on the loop's state after ``iters - 1`` iterations, and bit for bit
    against a second launch; a vertex without out-edges exactly 0 off the
    diagonal; with ``against64`` the loop also against float64 numpy.
    Returns ({kernel: max_abs_err}, the loop's scores on the host)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import simrank as k20

    csr = k20.place_csr(*k20.build_transition_csr(edges, n), device)
    S = k20.simrank(csr, iters, SR_DECAY)
    ref = k20.simrank_plain(k20.simrank_csr_to_dense(csr), iters, SR_DECAY)
    torch.cuda.synchronize()
    S_np = S.cpu().numpy()
    err, ok = within(S_np, ref.cpu().numpy())
    if not ok:
        raise AssertionError(f"K20 {label}: the loop lies {err:.3g} off the dense twin")
    errs = {"simrank_propagate": 0.0, "simrank_contract": err}
    if n:
        S_prev = k20.simrank(csr, iters - 1, SR_DECAY)
        U = k20.simrank_propagate(S_prev, csr)
        U_ref = k20.simrank_propagate_plain(S_prev, csr)
        out = k20.simrank_contract(U, csr, SR_DECAY)
        out_ref = k20.simrank_contract_plain(U, csr, SR_DECAY)
        for name, got, want, again in (
                ("simrank_propagate", U, U_ref, lambda: k20.simrank_propagate(S_prev, csr)),
                ("simrank_contract", out, out_ref, lambda: k20.simrank_contract(U, csr, SR_DECAY))):
            e, ok = within(got.cpu().numpy(), want.cpu().numpy())
            if not ok:
                raise AssertionError(f"K20 {label}: {name} lies {e:.3g} off its twin")
            if not bits_equal(got, again()):
                raise AssertionError(f"K20 {label}: a second {name} launch differs")
            errs[name] = max(errs[name], e)
    if S_np.shape != (n, n) or not np.isfinite(S_np).all() or not (np.diag(S_np) == 1).all():
        raise AssertionError(f"K20 {label}: scores not finite of shape [{n}, {n}] with a unit diagonal")
    sinks = np.setdiff1d(np.arange(n), np.asarray(edges).reshape(-1, 2)[:, 0])
    off = ~np.eye(n, dtype=bool)
    if not ((S_np[sinks][off[sinks]] == 0).all() and (S_np[:, sinks][off[:, sinks]] == 0).all()):
        raise AssertionError(f"K20 {label}: a vertex without out-edges scores off the diagonal")
    note = ""
    if against64:
        e64, ok = within(S_np, simrank64(np.asarray(edges).reshape(-1, 2), n, iters, SR_DECAY))
        if not ok:
            raise AssertionError(f"K20 {label}: the loop lies {e64:.3g} off float64")
        note = f", {e64:.3g} off float64 numpy"
    print(f"  K20 {label}: n {n}, {int(csr.indptr[-1]) if n else 0} CSR entries, {iters} "
          f"iterations within rtol {RTOL} / atol {ATOL} of the twin (|d| {err:.3g}){note}; each "
          f"kernel against its twin and bit for bit against a second launch; {len(sinks)} "
          "vertices without out-edges 0 off the diagonal ok", flush=True)
    return errs, S_np


def simrank_times(csr, S, device):
    """Each K20 kernel, its device time, its twin and the library calls at
    the main path's shapes: dense ``torch.matmul`` of the product (TF32 off)
    and ``torch.sparse.mm`` with P as a CSR tensor, where it builds."""
    import torch

    from predictionio_tpu_torch.ops import simrank as k20

    U = k20.simrank_propagate(S, csr)
    P = k20.simrank_csr_to_dense(csr)
    try:
        P_sp = torch.sparse_csr_tensor(csr.indptr.long(), csr.cols.long(), csr.vals,
                                       size=(csr.n, csr.n))
        torch.sparse.mm(P_sp, S)
    except (RuntimeError, NotImplementedError) as e:
        print(f"  torch.sparse.mm with a CSR P does not run here: {e}", flush=True)
        P_sp = None
    nnz = int(csr.cols.shape[0])
    out = {}
    for name, kern, plain, dense, sparse in (
            ("simrank_propagate", lambda: k20.simrank_propagate(S, csr),
             lambda: k20.simrank_propagate_plain(S, csr), lambda: P @ S,
             lambda: torch.sparse.mm(P_sp, S)),
            ("simrank_contract", lambda: k20.simrank_contract(U, csr, SR_DECAY),
             lambda: k20.simrank_contract_plain(U, csr, SR_DECAY), lambda: U @ P.T,
             lambda: torch.sparse.mm(P_sp, U.T))):
        ms = time_ms(kern, iters=50, warmup=3)
        out[name] = {
            "ms": ms, "device_ms": device_ms(kern, calls=10),
            "plain_ms": time_ms(plain, iters=5, warmup=1),
            "library_dense_ms": time_ms(dense, iters=5, warmup=1),
            "library_sparse_ms": None if P_sp is None else time_ms(sparse, iters=10, warmup=2),
            "bound": simrank_bound(csr.n, nnz),
        }
    return out


def simrank_phase(device, workdir):
    """3y a-b: K20 against its twins on the Wiki-Vote-sized graph, a
    1,000-vertex graph (also against float64) and the edge graphs; then the
    main path, counted from 0: ``SimRankDataSource`` -> ``SimRankAlgorithm.train``
    and the node and forest-fire sources at ``sample_fraction=0.5``, K20a =
    K20b = 5 each, twins 0; the train's wall clock split; the model saved,
    deployed through ``tools.cli deploy --device cuda`` and sent 64 queries
    from 8 clients, each answer the model's score. Returns (launches,
    errors, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.experimental import friend_recommendation as fr
    from predictionio_tpu_torch.ops import simrank as k20
    from predictionio_tpu_torch.utils.serialize import save_model

    edges = wiki_vote_edges()
    errs = {"simrank_propagate": 0.0, "simrank_contract": 0.0}

    def merge(e):
        for k, v in e.items():
            errs[k] = max(errs[k], v)

    e, wiki_S = check_simrank(edges, WV_VERTICES, "Wiki-Vote-sized graph", device)
    merge(e)
    rng = np.random.default_rng(WV_SEED + 1)
    small = wiki_vote_edges(seed=WV_SEED + 1, n=1_000, m=14_000)
    merge(check_simrank(small, 1_000, "1,000 vertices", device, against64=True)[0])
    # the edges: n = 0, n = 1 (a self-loop), n off every tile (K20b's R = 8,
    # 4, 2 and 1), duplicates only, a sink-heavy graph
    merge(check_simrank(np.zeros((0, 2), np.int64), 0, "n = 0", device)[0])
    merge(check_simrank(np.array([[0, 0]]), 1, "n = 1", device)[0])
    for n in (2, 257, 1_031, 3_001, 5_003, 9_001):
        g = np.stack([rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)], 1)
        g = np.concatenate([g, [[0, n - 1]]])
        merge(check_simrank(g, n, f"n = {n}", device, iters=2)[0])
    dup = np.array([[0, 1]] * 5 + [[0, 2], [1, 1], [1, 1], [2, 0], [2, 1], [2, 1], [2, 3]])
    merge(check_simrank(dup, 5, "duplicates and self-loops", device, against64=True)[0])
    sinky = np.stack([rng.integers(0, 50, 400), rng.integers(0, 600, 400)], 1)
    merge(check_simrank(sinky, 600, "550 of 600 vertices without out-edges", device)[0])

    path = os.path.join(workdir, "wiki_vote.txt")
    with open(path, "w") as f:
        f.write("# a Wiki-Vote-sized seeded graph: src dst\n")
        f.write("".join(f"{s} {d}\n" for s, d in edges.tolist()))
    stats = {"card": card_line(), "vertices": WV_VERTICES, "edges": WV_EDGES,
             "iterations": SR_ITERS, "decay": SR_DECAY, "sources": {}}
    launches = {"simrank_propagate": 0, "simrank_contract": 0}
    models = {}
    for label, ds in (
            ("default", fr.SimRankDataSource(fr.SimRankDataSourceParams(graph_edgelist_path=path))),
            ("node", fr.NodeSamplingDataSource(fr.NodeSamplingDSParams(
                graph_edgelist_path=path, sample_fraction=0.5))),
            ("forest", fr.ForestFireSamplingDataSource(fr.ForestFireDSParams(
                graph_edgelist_path=path, sample_fraction=0.5)))):
        k20.LAUNCHES.reset()
        t = time.perf_counter()
        td = ds.read_training(None)
        read_s = time.perf_counter() - t
        t = time.perf_counter()
        model = fr.SimRankAlgorithm().train(device, td)
        train_s = time.perf_counter() - t
        counts = k20.LAUNCHES.snapshot()
        want = {"simrank_propagate": SR_ITERS, "simrank_contract": SR_ITERS,
                "simrank_propagate_plain": 0, "simrank_contract_plain": 0}
        if counts != want:
            raise AssertionError(f"SimRank {label}: launches {counts}, want {want}")
        for k in launches:
            launches[k] += counts[k]
        if td.n_vertices != WV_VERTICES or model.scores.shape != (WV_VERTICES, WV_VERTICES):
            raise AssertionError(f"SimRank {label}: {td.n_vertices} vertices, scores "
                                 f"{model.scores.shape}")
        if label == "default":
            if not np_bits_equal(model.scores, wiki_S):
                raise AssertionError("SimRank: the main path's scores differ from the checked loop's")
        else:
            if not 0 < len(td.edges) < len(edges):
                raise AssertionError(f"SimRank {label}: {len(td.edges)} sampled edges")
            merge(check_simrank(td.edges, td.n_vertices, f"{label} sample", device)[0])
        models[label] = model
        stats["sources"][label] = {"edges": int(len(td.edges)), "read_s": read_s,
                                   "train_s": train_s}
        print(f"  main path {label}: {len(td.edges)} edges read in {read_s:.2f} s, "
              f"SimRankAlgorithm.train {train_s:.3f} s, launches {counts} ok", flush=True)

    # the train's wall clock split: its own steps, timed one by one
    td = fr.SimRankDataSource(fr.SimRankDataSourceParams(graph_edgelist_path=path)).read_training(None)
    t = time.perf_counter()
    host_csr = k20.build_transition_csr(td.edges, td.n_vertices)
    csr_s = time.perf_counter() - t
    t = time.perf_counter()
    csr = k20.place_csr(*host_csr, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    t = time.perf_counter()
    S = k20.simrank(csr, SR_ITERS, SR_DECAY)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    t = time.perf_counter()
    scores = S.cpu().numpy()
    fetch_s = time.perf_counter() - t
    if not np_bits_equal(scores, wiki_S):
        raise AssertionError("SimRank: the timed steps' scores differ from the main path's")
    stats["split_s"] = {"csr_build": csr_s, "upload": upload_s, "loop": loop_s, "fetch": fetch_s}
    stats["csr_entries"] = int(len(host_csr[1]))
    stats["max_out_degree"] = int(np.diff(host_csr[0]).max())
    stats.update(simrank_times(csr, S, device))

    model_path = os.path.join(workdir, "simrank.npz")
    t = time.perf_counter()
    save_model(model_path, models["default"])
    save_s = time.perf_counter() - t
    pairs = rng.integers(0, WV_VERTICES, (SR_SERVED, 2))
    pairs[:4, 1] = pairs[:4, 0]  # the diagonal
    best = wiki_S[4:12].copy()
    best[np.arange(8), np.arange(4, 12)] = -1.0
    pairs[4:12] = np.stack([np.arange(4, 12), best.argmax(1)], 1)  # high off-diagonal scores
    bodies = [{"item1": int(a), "item2": int(b)} for a, b in pairs]
    server = Deployment(model_path, device)
    try:
        answers, wall = server.send(bodies, SR_CLIENTS)
        status = server.status()
    finally:
        server.stop()
    for i, _, res in answers:
        a, b = bodies[i]["item1"], bodies[i]["item2"]
        if res != float(models["default"].scores[a, b]):
            raise AssertionError(f"SimRank deployment: query {bodies[i]} answered {res}")
    if not any(res > 0 for _, _, res in answers[4:12]):
        raise AssertionError("SimRank deployment: no positive off-diagonal score served")
    stats["served"] = {"queries": len(answers), "batches": status["batches"],
                       **latency_stats(answers, wall), "deploy_s": server.deploy_s,
                       "save_s": save_s}
    print(f"  SimRank: the model saved in {save_s:.2f} s ({os.path.getsize(model_path)} B), "
          f"deployed through the CLI, {len(answers)} queries from {SR_CLIENTS} clients each "
          "answered the model's score ok", flush=True)
    print("simrank " + json.dumps(stats), flush=True)
    return launches, errs, stats


def k3c_phase(device, model, k3_rows):
    """3y c: ``ServingFactors.measure_compute_ms`` at the bench's call (phase
    3's model, its first 32 users, n = 10, ``iters=4096``) and at phase 2's
    shape (N = 26,744, rank 32, B = 128, n = 16), each counted from 0 (one
    warm-up chain call and two a sample: 11 K3c launches, K3 and twins 0);
    at each, the chain's output bit for bit K3's on the query offset by the
    last pass, and a 3-pass chain against its twin. The measured ms are
    printed beside K3's device time at the same shape, not gated. Returns
    (launches, error, stats)."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import topn as k3
    from predictionio_tpu_torch.ops.als import ServingFactors, _unpack_indices
    from predictionio_tpu_torch.ops.topn import (
        chain_offset,
        check_topn_agreement,
        topn_chain,
        topn_chain_plain,
        topn_packed,
    )

    rng = np.random.default_rng(47)
    Y2 = (rng.standard_normal((ML20M_ITEMS, RANK)) / np.sqrt(RANK)).astype(np.float32)
    q2 = (rng.standard_normal((128, RANK)) / np.sqrt(RANK)).astype(np.float32)
    cases = (
        ("bench call", model.arrays.user_factors, model.arrays.item_factors,
         model.arrays.user_factors[:32], 10),
        ("phase 2 shape", q2, Y2, q2, 16),
    )
    launches, err, stats = 0, 0.0, {"card": card_line(), "iters": K3C_ITERS, "reps": K3C_REPS}
    for label, uf, itf, rows, n in cases:
        sf = ServingFactors(uf, itf, device=device)
        k3.LAUNCHES.reset()
        t = time.perf_counter()
        ms = sf.measure_compute_ms(rows, n, iters=K3C_ITERS, reps=K3C_REPS)
        wall = time.perf_counter() - t
        counts = k3.LAUNCHES.snapshot()
        want = {"topn_packed": 0, "topn_packed_plain": 0, "topn_chain": 1 + 2 * K3C_REPS,
                "topn_chain_plain": 0}
        if counts != want:
            raise AssertionError(f"K3c {label}: launches {counts}, want {want}")
        launches += counts["topn_chain"]
        q = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)
        Y = sf._if_dev
        out = topn_chain(q, Y, n, K3C_ITERS)
        off = torch.tensor(float(chain_offset(K3C_ITERS - 1)), dtype=torch.float32, device=device)
        last = topn_packed(q + off, Y, n)
        if not bits_equal(out, last):
            raise AssertionError(f"K3c {label}: the chain's output is not K3's on the last "
                                 "pass's offset query")
        got = topn_chain(q, Y, n, 3).cpu().numpy()
        ref = topn_chain_plain(q, Y, n, 3).cpu().numpy()
        e = check_topn_agreement(got[:, :n], _unpack_indices(got, n), ref[:, :n],
                                 _unpack_indices(ref, n), RTOL, ATOL)
        err = max(err, e)
        k3_dev = device_ms(lambda: topn_packed(q, Y, n), calls=200)
        B, N, k = q.shape[0], Y.shape[0], Y.shape[1]
        row = {"B": B, "N": N, "k": k, "n": n, "measure_compute_ms": ms, "wall_s": wall,
               "k3_device_ms": k3_dev,
               "plain_ms": time_ms(lambda: topn_chain_plain(q, Y, n, 8), iters=5) / 8,
               "library_ms": time_ms(lambda: torch.topk(q @ Y.T, n)),
               "bound": bound(B, N, k, n), "launches": counts}
        phase2 = [r["device_ms"] for r in k3_rows if (r["B"], r["n"]) == (B, 16)]
        if phase2:
            row["phase2_k3_device_ms_n16"] = phase2[0]
        stats[label] = row
        print(f"  K3c {label}: B {B} N {N} k {k} n {n}: measure_compute_ms {ms:.5f} ms a pass "
              f"({K3C_ITERS} passes, {K3C_REPS} reps, {wall:.2f} s); K3 on the card alone "
              f"{k3_dev:.5f} ms{'; phase 2 K3 device %.5f ms at n = 16' % phase2[0] if phase2 else ''}"
              f"; the chain equals K3 on the last offset query bit for bit, a 3-pass chain "
              f"against its twin |d| {e:.3g} ok", flush=True)
    print("k3c " + json.dumps(stats), flush=True)
    return launches, err, stats


def synth_ml100k(seed=7):
    """ML-100K-shaped synthetic ratings, a copy of the bench's generator
    (``bench.py synth_ml100k``): 943 users x 1,682 items, 100,000 ratings
    on a lognormal-activity x zipf-popularity long tail, 1..5."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = 6
    U = rng.standard_normal((ML100K_USERS, k)) / np.sqrt(k)
    V = rng.standard_normal((ML100K_ITEMS, k)) / np.sqrt(k)
    u_p = rng.lognormal(0, 1, ML100K_USERS)
    u_p /= u_p.sum()
    i_p = 1.0 / np.arange(1, ML100K_ITEMS + 1) ** 0.8
    i_p /= i_p.sum()
    u = rng.choice(ML100K_USERS, size=ML100K_RATINGS, p=u_p).astype(np.int32)
    i = rng.choice(ML100K_ITEMS, size=ML100K_RATINGS, p=i_p).astype(np.int32)
    raw = (U[u] * V[i]).sum(-1)
    r = np.clip(np.round(3.0 + 1.2 * raw + 0.4 * rng.standard_normal(ML100K_RATINGS)), 1, 5)
    return u, i, r.astype(np.float32)


def template_counts():
    from predictionio_tpu_torch.ops import (
        device_pack, gramian, normal_eq, predict_pairs, similarity, spd_solve, topn,
    )

    return (device_pack.LAUNCHES, normal_eq.LAUNCHES, spd_solve.LAUNCHES, topn.LAUNCHES,
            predict_pairs.LAUNCHES, gramian.LAUNCHES, similarity.LAUNCHES)


def counted(label, want, fn):
    """``fn()`` with every template kernel's count from 0; raises unless each
    count in ``want`` is met and every twin stayed at 0."""
    counters = template_counts()
    for c in counters:
        c.reset()
    out = fn()
    counts = snapshot(counters)
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, not {n}")
    if any(v for name, v in counts.items() if name.endswith("_plain")):
        raise AssertionError(f"{label}: a plain twin ran: {counts}")
    return out, {n: v for n, v in counts.items() if v}


def templates_phase(device, workdir):
    """3y d: the five templates on the card at ML-100K shape (the bench's
    ``synth_ml100k`` written as ``user::item::rate`` lines), through their
    entry points, each counted from 0. Returns stats."""
    import numpy as np

    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.controller.persistent_model import PersistentModelManifest
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.data.store import EventColumns
    from predictionio_tpu_torch.models.experimental import custom_datasource as cds
    from predictionio_tpu_torch.models.experimental import movielens_filtering as mlf
    from predictionio_tpu_torch.models.experimental import refactor_test as rft
    from predictionio_tpu_torch.models.experimental import similarproduct_localmodel as lcl
    from predictionio_tpu_torch.models.experimental import standalone_recommendations as sar
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.ops.topn import check_topn_agreement
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

    u, i, r = synth_ml100k()
    path = os.path.join(workdir, "ml100k.dat")
    with open(path, "w") as f:
        f.write("".join(f"{a}::{b}::{int(c)}\n" for a, b, c in zip(u.tolist(), i.tolist(),
                                                                     r.tolist())))
    sweeps = ML100K_ALS["num_iterations"]
    train_want = {"normal_eq": 2 * sweeps, "spd_solve": 2 * sweeps}
    stats = {"card": card_line(), "ratings": ML100K_RATINGS, **ML100K_ALS}
    als = rec.ALSAlgorithmParams(**ML100K_ALS)
    users = [str(x) for x in range(0, ML100K_USERS, 29)]
    queries = [(n, rec.Query(user=x, num=10)) for n, x in enumerate(users)]

    # the recommendation template on the same ratings, read as event columns
    # (ids indexed in sorted string order, as the file source indexes them)
    su, si = [str(x) for x in u.tolist()], [str(x) for x in i.tolist()]
    ui, ii = BiMap.string_int(su), BiMap.string_int(si)
    cols = EventColumns(ui, ii, np.asarray([ui[x] for x in su], np.int32),
                        np.asarray([ii[x] for x in si], np.int32), r)
    ctx = WorkflowContext(device, {"ml100k": cols})
    rec_ep = EngineParams(data_source_params=("", rec.DataSourceParams(app_name="ml100k")),
                          algorithm_params_list=(("als", als),))
    t = time.perf_counter()
    [rec_model], c = counted("recommendation", train_want, lambda: rec.recommendation_engine().train(
        ctx, rec_ep, WorkflowParams()))
    stats["recommendation_train_s"] = time.perf_counter() - t
    rec_answers = dict(rec_model.recommend_many(queries))

    # a. custom_datasource: the file source, the same model bit for bit
    ep = EngineParams(data_source_params=("", cds.FileDataSourceParams(filepath=path)),
                      algorithm_params_list=(("als", als),))
    t = time.perf_counter()
    [m], c = counted("custom_datasource", train_want, lambda: cds.custom_datasource_engine().train(
        WorkflowContext(device), ep, WorkflowParams()))
    stats["custom_datasource"] = {"train_s": time.perf_counter() - t, "launches": c}
    if not (np_bits_equal(m.arrays.user_factors, rec_model.arrays.user_factors)
            and np_bits_equal(m.arrays.item_factors, rec_model.arrays.item_factors)):
        raise AssertionError("custom_datasource: factors differ from the recommendation template's")
    _, _, algos, serving = cds.custom_datasource_engine().make_components(ep)
    got, c = counted("custom_datasource serving", {"topn_packed": 1},
                     lambda: algos[0].batch_predict(m, queries))
    for (n, p), q in zip(got, queries):
        if serving.serve(q[1], [p]) != rec_answers[n]:
            raise AssertionError(f"custom_datasource: query {q} answered unlike the template")
    print(f"  custom_datasource: {ML100K_RATINGS} lines, factors bit for bit the recommendation "
          f"template's, {len(queries)} answers equal ok", flush=True)

    # b. movielens_filtering: TempFilter re-reads its blacklist per query
    blacklist = os.path.join(workdir, "blacklist.txt")
    flt_ep = EngineParams(data_source_params=("", mlf.DataSourceParams(app_name="ml100k")),
                          algorithm_params_list=(("als", als),),
                          serving_params=("", mlf.TempFilterParams(filepath=blacklist)))
    t = time.perf_counter()
    [m], c = counted("movielens_filtering", train_want, lambda: mlf.filtering_engine().train(
        ctx, flt_ep, WorkflowParams()))
    stats["movielens_filtering"] = {"train_s": time.perf_counter() - t, "launches": c}
    if not np_bits_equal(m.arrays.item_factors, rec_model.arrays.item_factors):
        raise AssertionError("movielens_filtering: factors differ from the template's")
    _, _, algos, serving = mlf.filtering_engine().make_components(flt_ep)
    head = [s.item for s in max(rec_answers.values(), key=lambda a: len(a.item_scores)).item_scores]
    for blocked in (head[:3], head[3:5] + [head[0]]):
        with open(blacklist, "w") as f:
            f.write("".join(f"{b}\n" for b in blocked))
        for n, q in queries:
            got = serving.serve(q, [algos[0].predict(m, q)])
            want = tuple(s for s in rec_answers[n].item_scores if s.item not in blocked)
            if got.item_scores != want:
                raise AssertionError(f"movielens_filtering: {q} with {blocked} blocked")
    print(f"  movielens_filtering: factors bit for bit the template's; two blacklists, the file "
          f"edited between them, drop exactly their ids from {len(queries)} answers ok", flush=True)

    # c. refactor_test: the vanilla engine and evaluator (host code)
    vctx = WorkflowContext(device)
    [vm] = rft.refactor_test_engine().train(vctx, rft.default_engine_params(2), WorkflowParams())
    result = rft.VanillaEvaluator().evaluate_base(vctx, None, rft.refactor_test_engine().batch_eval(
        vctx, [rft.default_engine_params(1)], WorkflowParams()), WorkflowParams())
    if vm.mc != 9900 or (result.n_sets, result.total) != (3, -3 * 20 * 4950):
        raise AssertionError(f"refactor_test: model {vm}, evaluator {result.to_one_liner()}")
    print(f"  refactor_test: model {vm.mc}, {result.to_one_liner()} ok", flush=True)

    # d. similarproduct_localmodel: the Similar Product ALS on the card, then
    # host dictionaries and numpy cosines, against the template's host path
    items = {f"i{x}": sp.Item(categories=(f"c{x % 24}",)) for x in range(ML100K_ITEMS)}
    td = sp.TrainingData(users={f"u{x}": {} for x in range(ML100K_USERS)}, items=items,
                         view_events=[sp.ViewEvent(user=f"u{a}", item=f"i{b}", t=float(n))
                                      for n, (a, b) in enumerate(zip(u.tolist(), i.tolist()))])
    pd = sp.PreparedData(td=td)
    sp_params = sp.ALSAlgorithmParams(rank=10, num_iterations=10, lambda_=0.01, seed=1)
    t = time.perf_counter()
    local, c = counted("similarproduct_localmodel", {**train_want, "gramian": 4 * sweeps},
                       lambda: lcl.ALSLocalAlgorithm(sp_params).train(device, pd))
    stats["similarproduct_localmodel"] = {"train_s": time.perf_counter() - t, "launches": c}
    sp_model = sp.ALSAlgorithm(sp_params).train(device, pd)
    local_rows = np.stack([local.product_features[j] for j in range(ML100K_ITEMS)])
    if not np_bits_equal(local_rows, sp_model.item_factors):
        raise AssertionError("similarproduct_localmodel: factors differ from the template's")
    sp_queries = [sp.Query(items=(f"i{x}",), num=10) for x in range(0, 400, 25)] + [
        sp.Query(items=(f"i{x}", f"i{x + 7}"), num=8, categories=("c3", "c5"))
        for x in range(0, 200, 40)] + [sp.Query(items=("nope",), num=5)]
    algo = lcl.ALSLocalAlgorithm(sp_params)
    t = time.perf_counter()
    got, c = counted("similarproduct_localmodel serving", {"cosine_sum": 0},
                     lambda: algo.batch_predict(local, list(enumerate(sp_queries))))
    local_s = time.perf_counter() - t
    want, c_sp = counted("similar product host path", {"cosine_sum": len(sp_queries) - 1},
                         lambda: [sp_model.similar(q) for q in sp_queries])
    err = 0.0
    for (_, g), w, q in zip(got, want, sp_queries):
        if len(g.item_scores) != len(w.item_scores):
            raise AssertionError(f"similarproduct_localmodel: {q}: {len(g.item_scores)} items, "
                                 f"the template {len(w.item_scores)}")
        if not w.item_scores:
            continue
        err = max(err, check_topn_agreement(
            np.array([[s.score for s in g.item_scores]]),
            np.array([[local.item_index[s.item] for s in g.item_scores]]),
            np.array([[s.score for s in w.item_scores]]),
            np.array([[local.item_index[s.item] for s in w.item_scores]]), RTOL, ATOL))
    stats["similarproduct_localmodel"]["predict_s_per_query"] = local_s / len(sp_queries)
    print(f"  similarproduct_localmodel: factors bit for bit the template's; {len(sp_queries)} "
          f"answers (host numpy, {local_s / len(sp_queries) * 1e3:.2f} ms a query) within rtol "
          f"{RTOL} / atol {ATOL} of the template's host path (K14), |d| {err:.3g} ok", flush=True)

    # e. standalone_recommendations: run_standalone, persisted as .npz,
    # reloaded through make_serializable_models / prepare_deploy
    old = os.environ.get("PIO_FS_BASEDIR")
    os.environ["PIO_FS_BASEDIR"] = os.path.join(workdir, "fs")
    try:
        t = time.perf_counter()
        [sm], c = counted("standalone_recommendations", train_want, lambda: sar.run_standalone(
            path, **ML100K_ALS, persist_model=True, device=device))
        stats["standalone_recommendations"] = {"train_s": time.perf_counter() - t, "launches": c}
        engine = sar.standalone_recommendations_engine()
        ep = sar.standalone_engine_params(path, **ML100K_ALS, persist_model=True)
        [kept] = engine.make_serializable_models(device, "ml100k", ep, [sm])
        if not isinstance(kept, PersistentModelManifest):
            raise AssertionError(f"standalone_recommendations: kept {kept!r}")
        saved = os.listdir(os.path.join(workdir, "fs", "pmodels"))
        if saved != ["ml100k-PMatrixFactorizationModel.npz"]:
            raise AssertionError(f"standalone_recommendations: saved {saved}")
        [loaded] = engine.prepare_deploy(device, ep, [kept], engine_instance_id="ml100k")
    finally:
        if old is None:
            del os.environ["PIO_FS_BASEDIR"]
        else:
            os.environ["PIO_FS_BASEDIR"] = old
    if not (np_bits_equal(loaded.user_features, sm.user_features)
            and np_bits_equal(loaded.product_features, sm.product_features)):
        raise AssertionError("standalone_recommendations: the reloaded factors differ")
    algo = sar.ALSAlgorithm(ep.algorithm_params_list[0][1])
    pairs = [(int(a), int(b)) for a, b in zip(u[:64].tolist(), i[:64].tolist())]
    got, c = counted("standalone predict", {"predict_pairs": 2 * len(pairs)},
                     lambda: [(algo.predict(loaded, p), algo.predict(sm, p)) for p in pairs])
    if any(a != b for a, b in got):
        raise AssertionError("standalone_recommendations: the reloaded model predicts otherwise")
    print(f"  standalone_recommendations: run_standalone, persisted as one .npz, reloaded through "
          f"prepare_deploy bit for bit; {len(pairs)} predictions (K7) equal ok", flush=True)
    print("templates " + json.dumps(stats), flush=True)
    return stats


def phase_3y(device, workdir, model, k3_rows):
    """Phase 3y: SimRank (``simrank_phase``), K3c (``k3c_phase``) and the five
    templates (``templates_phase``). Returns (launches, errors, stats)."""
    t = time.perf_counter()
    s_counts, s_errs, s_stats = simrank_phase(device, workdir)
    c_launches, c_err, c_stats = k3c_phase(device, model, k3_rows)
    t_stats = templates_phase(device, workdir)
    launches = {**s_counts, "topn_chain": c_launches}
    errs = {**s_errs, "topn_chain": c_err}
    print(f"  3y: launches {launches} in {time.perf_counter() - t:.1f} s", flush=True)
    return launches, errs, {"simrank": s_stats, "k3c": c_stats, "templates": t_stats}


# --- phase 3m: serving on a device mesh ---

MESH_SHARDS = 4  # logical shards of the one-card mesh (every shard on the card)
MESH_HOST_QUERIES = 64  # R3's queries sent through the host path's K14s
MESH_BATCHES = (1, 7, 8, 13, 32, 57, 128, 3)  # K3s's batch sizes, in turn


def mesh_counters():
    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops import merge_topn as k9m
    from predictionio_tpu_torch.ops import rescore as kb
    from predictionio_tpu_torch.ops import similarity as k14
    from predictionio_tpu_torch.ops import topn as k3

    return (ka.LAUNCHES, kb.LAUNCHES, k9m.LAUNCHES, k3.LAUNCHES, k14.LAUNCHES)


def same_bits(a, b) -> bool:
    """Two numpy arrays equal bit for bit (float32 compared as uint32)."""
    import numpy as np

    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    return bool(np.array_equal(a, b))


def exact_top10(Y64, q):
    """Ids of the exact top 10 of ``Y·q`` in float64 (ties to the lower
    id): the recall reference."""
    import numpy as np

    return np.argsort(-(q.astype(np.float64) @ Y64.T), axis=1, kind="stable")[:, :10]


def no_lower(got_s, want_s, label):
    """A quantized answer that differs from the single device's: the same
    live slots, and each exact score no lower than the single device's at
    its position (within rtol 1e-6)."""
    import numpy as np

    live = np.isfinite(want_s)
    if not np.array_equal(np.isfinite(got_s), live):
        raise AssertionError(f"{label}: live slots differ from the single device's")
    if np.any(got_s[live] < want_s[live] - 1e-6 * np.abs(want_s[live])):
        raise AssertionError(f"{label}: a score below the single device's: "
                             f"{got_s[:8]} vs {want_s[:8]}")


def check_quantized_rows(got, want, label):
    """The sharded retriever's answer against the single device's in a
    quantized tier: each row bit for bit, or, where a shard's own shortlist
    (c·n_local of its rows, wider than its share of the single device's)
    brought other candidates to the host refinement, ``no_lower``. Returns
    the rows that differ."""
    (gs, gi), (ws, wi) = got, want
    differ = 0
    for r in range(gs.shape[0]):
        if not (same_bits(gs[r], ws[r]) and same_bits(gi[r], wi[r])):
            differ += 1
            no_lower(gs[r], ws[r], f"{label} row {r}")
    return differ


def check_offset_form(shard, single, off, label):
    """A row-shard launch against the single-device launch on the same
    shard: the scores bit for bit, the ids plus ``off``."""
    import numpy as np

    m = shard.shape[1] // 2
    a, b = shard.cpu().numpy(), single.cpu().numpy()
    if not same_bits(a[:, :m], b[:, :m]) or not np.array_equal(
            a[:, m:].view(np.int32), b[:, m:].view(np.int32) + off):
        raise AssertionError(f"{label}: not the single-device form with ids + {off}")


def shard_kernel_checks(r, q_np, n, exclude, include, positive_only, normalize, device, label,
                        errs):
    """On one batch of the sharded retriever ``r``, each shard's row-shard
    forms against their twins on the card (the mask bit for bit, kernel A
    bit for bit in int8 and within RTOL/ATOL otherwise, kernel B within
    RTOL/ATOL, as R1 holds them) and against the kernels' single-device
    forms on the same shard (scores bit for bit, ids plus the shard's
    offset); then K9m on the shards' candidates bit for bit against its
    twin. Returns the merged (scores, ids) of the padded batch."""
    import torch

    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops import merge_topn as k9m
    from predictionio_tpu_torch.ops import rescore as kb
    from predictionio_tpu_torch.ops.retrieval import unpack_topn

    q, excl, incl, has = retriever_operands(r, q_np, exclude, include, device)
    quant = r.precision != "float32"
    rows = r._n_pad // r._n_shards
    n_dev = r._shortlist_width(n, r.n_items) if quant else n
    n_local = min(n_dev, rows)
    m = r._shortlist_width(n_local, rows) if quant else n_local
    cands = []
    for p in r._parts:
        bits = ka.candidate_mask(p.allow, excl, incl, has, id_offset=p.off)
        if not bits_equal(bits, ka.candidate_mask_plain(p.allow, excl, incl, has, p.off)):
            raise AssertionError(f"candidate_mask_shard {label} off={p.off}: differs from its twin")
        errs.setdefault("candidate_mask_shard", 0.0)
        rn = p.rn if normalize else None
        a_off = 0 if quant else p.off  # K10s's stage 1 keeps local ids
        a_args = (q, p.y, p.scale, rn, bits, m, positive_only, normalize)
        a = ka.masked_topn_packed(*a_args, id_offset=a_off)
        e = check_ranked(a, ka.masked_topn_plain(*a_args, id_offset=a_off),
                         f"masked_topn_shard {label} off={p.off}", exact=r.precision == "int8")
        errs["masked_topn_shard"] = max(errs.get("masked_topn_shard", 0.0), e)
        check_offset_form(a, ka.masked_topn_packed(*a_args), a_off,
                          f"masked_topn_shard {label} off={p.off}")
        if quant:
            b_args = (q, p.y, p.scale, rn, a, n_local, positive_only, normalize)
            c = kb.rescore_topn(*b_args, id_offset=p.off)
            e = check_ranked(c, kb.rescore_topn_plain(*b_args, id_offset=p.off),
                             f"rescore_topn_shard {label} off={p.off}")
            errs["rescore_topn_shard"] = max(errs.get("rescore_topn_shard", 0.0), e)
            check_offset_form(c, kb.rescore_topn(*b_args), p.off,
                              f"rescore_topn_shard {label} off={p.off}")
            a = c
        cands.append(a)
    cand = torch.stack(cands)  # [S, B, 2L], as the retriever lays it out
    merged = k9m.merge_topn(cand, n_dev)
    twin = k9m.merge_topn_plain(cand, n_dev)
    if not bits_equal(merged, twin):
        raise AssertionError(f"merge_topn {label}: differs from its twin")
    out = torch.full_like(merged, float("nan"))
    if k9m.merge_topn(cand, n_dev, out=out) is not out or not bits_equal(out, twin):
        raise AssertionError(f"merge_topn {label}: into a caller's out, not its twin")
    errs.setdefault("merge_topn", 0.0)
    return unpack_topn(merged.cpu().numpy(), n_dev)


def k3s_table_gates(rng, device, uf, sharded):
    """On the card, at B = 128: K3 over a shard table whose blocks are out of
    order (n = 16, and n = 1,000, whose merge runs in levels) and over the
    first device's table of an interleaved mesh (``0,1,0,1``: shards 0 and
    2, gaps between their blocks; n = 16), each placed row bit for bit K3 on
    the whole batch and every other row left as it was; then K3c's mesh form
    (``ServingFactors(mesh)``'s chain over its tables, as
    ``measure_compute_ms`` times it) bit for bit one device's chain at 16
    passes. Returns what was checked."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import topn as k3

    B, per = 128, 32
    q = uf[rng.integers(0, len(uf), B)].astype(np.float32)
    Yd = sharded._if_dev
    qd = torch.from_numpy(q).to(device)
    checked = {}
    for name, shards, blocks, n in (("out of order", [0, 1, 2, 3], [2, 0, 3, 1], 16),
                                    ("out of order, in levels", [0, 1, 2, 3], [2, 0, 3, 1], 1000),
                                    ("interleaved", [0, 2], [0, 2], 16)):
        whole = k3.topn_packed(qd, Yd, n).cpu().numpy()
        upload = torch.from_numpy(np.concatenate([q[s * per:(s + 1) * per] for s in shards]))
        table = k3.TopnTable(device, [per] * len(shards), [b * per for b in blocks], B)
        res = torch.full((B, 2 * n), float("nan"), device=device)
        k3.topn_packed(upload.to(device), Yd, n, out=res, table=table)
        got = res.cpu().numpy()
        for s, b in zip(shards, blocks):
            if not same_bits(got[b * per:(b + 1) * per], whole[s * per:(s + 1) * per]):
                raise AssertionError(f"K3 over the {name} table: shard {s}'s rows are not "
                                     "K3's on the whole batch")
        rest = sorted(set(range(B // per)) - set(blocks))
        if rest and not all(np.isnan(got[b * per:(b + 1) * per]).all() for b in rest):
            raise AssertionError(f"K3 over the {name} table wrote outside its blocks")
        checked[name] = {"shards": shards, "blocks": blocks, "n": n}
    chained = sharded._launch(sharded._place(q), 16, 16).cpu().numpy()[:B]
    if not same_bits(chained, k3.topn_chain(qd, Yd, 16, 16).cpu().numpy()):
        raise AssertionError("K3c on the mesh: not one device's chain bit for bit")
    checked["k3c_mesh_passes"] = 16
    print("  K3 over out-of-order (n = 16, 1,000) and interleaved tables and K3c's mesh "
          "form: bit for bit one device's", flush=True)
    return checked


def shard_times(rng, r, Y, positive_only, normalize, device):
    """At B = 128 and n = 16: one shard's mask, kernel A (and B) in their
    row-shard forms, and K9m over every shard's candidates, each timed with
    its device time, twin and library call beside its bound."""
    import types

    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import masked_topn as ka
    from predictionio_tpu_torch.ops import merge_topn as k9m
    from predictionio_tpu_torch.ops import rescore as kb

    B, n, k = 128, 16, Y.shape[1]
    q_np = Y[rng.integers(0, len(Y), B)].astype(np.float32)
    if normalize:
        q_np = q_np / np.linalg.norm(q_np, axis=1, keepdims=True)
    q, excl, incl, has = retriever_operands(r, q_np, [None] * B, [None] * B, device)
    quant = r.precision != "float32"
    S, rows = r._n_shards, r._n_pad // r._n_shards
    n_dev = r._shortlist_width(n, r.n_items) if quant else n
    n_local = min(n_dev, rows)
    m = r._shortlist_width(n_local, rows) if quant else n_local
    p = r._parts[1]  # a shard with a non-zero offset
    W = ka.mask_words(rows)
    row = {"precision": r.precision, "B": B, "S": S, "rows_per_shard": rows, "k": k, "n": n,
           "n_local": n_local, "m": m, "shard_offset": p.off}
    mask_call = lambda: ka.candidate_mask(p.allow, excl, incl, has, id_offset=p.off)
    row["candidate_mask_shard"] = {
        "ms": time_ms(mask_call), "device_ms": device_ms(mask_call, calls=200),
        "plain_ms": time_ms(lambda: ka.candidate_mask_plain(p.allow, excl, incl, has, p.off),
                            iters=20),
        "bound": roofline(rows + 4 * B * (excl.shape[1] + incl.shape[1]) + B + 4 * B * W, 0),
        "library_ms": None,
    }
    bits = mask_call()
    rn = p.rn if normalize else None
    a_off = 0 if quant else p.off
    a_args = (q, p.y, p.scale, rn, bits, m, positive_only, normalize)
    a_call = lambda: ka.masked_topn_packed(*a_args, id_offset=a_off)
    a_bytes = 4 * B * k + TIER_BYTES[r.precision] * rows * k \
        + (4 * rows if r.precision == "int8" else 0) + (4 * rows if normalize else 0) \
        + 4 * B * W + 8 * B * m
    shard = types.SimpleNamespace(precision=r.precision, _y_dev=p.y, _allow_dev=p.allow,
                                  _scale_dev=p.scale)
    row["masked_topn_shard"] = {
        "ms": time_ms(a_call), "device_ms": device_ms(a_call, calls=100),
        "plain_ms": time_ms(lambda: ka.masked_topn_plain(*a_args, id_offset=a_off), iters=20),
        "bound": roofline(a_bytes, 2 * B * rows * k, TIER_PEAK[r.precision]),
        "library_ms": library_topn_ms(shard, q, m),
    }
    if quant:
        b_args = (q, p.y, p.scale, rn, a_call(), n_local, positive_only, normalize)
        b_call = lambda: kb.rescore_topn(*b_args, id_offset=p.off)
        b_bytes = 4 * B * k + B * m * k * TIER_BYTES[r.precision] + 8 * B * m + 8 * B * n_local \
            + (4 * B * m if r.precision == "int8" else 0) + (4 * B * m if normalize else 0)
        row["rescore_topn_shard"] = {
            "ms": time_ms(b_call), "device_ms": device_ms(b_call, calls=100),
            "plain_ms": time_ms(lambda: kb.rescore_topn_plain(*b_args, id_offset=p.off), iters=20),
            "bound": roofline(b_bytes, 2 * B * m * k),
            "library_ms": None,
        }
    # K9m over the shards' candidate lists, laid out as the retriever lays
    # them: [S, B, 2L] on the first shard's device
    cand = torch.empty((S, B, 2 * n_local), dtype=torch.float32, device=device)
    for s, part in enumerate(r._parts):
        prn = part.rn if normalize else None
        bits_s = ka.candidate_mask(part.allow, excl, incl, has, id_offset=part.off)
        got = ka.masked_topn_packed(q, part.y, part.scale, prn, bits_s, m, positive_only,
                                    normalize, id_offset=0 if quant else part.off)
        if quant:
            got = kb.rescore_topn(q, part.y, part.scale, prn, got, n_local, positive_only,
                                  normalize, id_offset=part.off)
        cand[s].copy_(got)
    # as the retriever merges: the buffer as it lies, into its own out
    merged = torch.empty((B, 2 * n_dev), dtype=torch.float32, device=device)
    merge_call = lambda: k9m.merge_topn(cand, n_dev, out=merged)
    flat = cand[:, :, :n_local].permute(1, 0, 2).reshape(B, S * n_local).contiguous()
    row["merge_topn"] = {
        "S": S, "L": n_local, "n": n_dev,
        "ms": time_ms(merge_call), "device_ms": device_ms(merge_call, calls=200),
        "plain_ms": time_ms(lambda: k9m.merge_topn_plain(cand, n_dev), iters=20),
        "bound": roofline(4 * B * S * 2 * n_local + 4 * B * 2 * n_dev, 0),
        "library_ms": time_ms(lambda: torch.topk(flat, n_dev)),
        "host_us": host_breakdown(merge_call, wrapper_parts(k9m)),
    }
    row["card"] = card_line()
    return row


def mesh_serving_checks(rng, device, mesh, model, traffic, sp_deploy, errs, timed):
    """3m's comparisons on one mesh (see ``mesh_phase``); with ``timed`` (a
    mesh of logical shards of ``device``) also the times."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.similarproduct import engine as psp
    from predictionio_tpu_torch.ops import similarity as k14
    from predictionio_tpu_torch.ops import topn as k3
    from predictionio_tpu_torch.ops.als import ServingFactors
    from predictionio_tpu_torch.ops.retrieval import ItemRetriever
    from predictionio_tpu_torch.ops.similarity import SimilarityScorer
    from predictionio_tpu_torch.utils.shapes import pad_rows_pow2, pow2_topk_width

    S = mesh.shape["data"]
    uf, itf = model.arrays.user_factors, model.arrays.item_factors
    N, k = itf.shape
    out = {"shards": S, "devices": [str(d) for d in mesh.devices]}
    # K3s: the 320 served queries' user rows in batches of 1-128, bit for
    # bit K3 on the whole batch
    known = [b for b in traffic["bodies"] if b["user"] in model.user_index]
    rows = [model.user_index[b["user"]] for b in known]
    nums = [b["num"] for b in known]
    single, sharded = ServingFactors(uf, itf, device=device), ServingFactors(uf, itf, mesh=mesh)
    at = batches = 0
    while at < len(rows):
        B = min(MESH_BATCHES[batches % len(MESH_BATCHES)], len(rows) - at)
        q, n = uf[rows[at:at + B]], pow2_topk_width(max(nums[at:at + B]), N)
        got, want = sharded.topn_by_rows(q, n), single.topn_by_rows(q, n)
        if not (same_bits(got[0], want[0]) and same_bits(got[1], want[1])):
            raise AssertionError(f"K3s batch of {B} at {at}: not K3's answer bit for bit")
        at, batches = at + B, batches + 1
    out["k3s_batches"] = batches
    print(f"  K3s on {S} shards: {len(rows)} user rows in {batches} batches of 1-128, "
          "bit for bit K3's", flush=True)
    out["k3s_tables"] = k3s_table_gates(rng, device, uf, sharded)
    if timed:
        out["k3s"] = []
        Yd = sharded._if_dev
        for B in (8, 32, 128):
            q = pad_rows_pow2(uf[rng.integers(0, len(uf), B)], 8)
            qd = torch.from_numpy(q).to(device)
            one = lambda: k3.topn_packed(qd, Yd, 16)
            # as ServingFactors serves: one launch per distinct device over
            # its shards' table, the uploads made once (one here: every
            # shard on the card)
            placed = sharded._place(q)
            k3s = lambda: sharded._launch(placed, 16)
            q0, table0, _ = placed[0]
            row = {
                "B": B, "n": 16, "launches_per_batch": len(placed),
                "k3_ms": time_ms(one), "k3_device_ms": device_ms(one, calls=100),
                "k3s_ms": time_ms(k3s), "k3s_device_ms": device_ms(k3s, calls=100),
                # the launch and its one fetch
                "k3s_fetch_once_ms": time_ms(lambda: k3s().cpu(), iters=50),
                "plain_ms": time_ms(lambda: k3.topn_table_plain(
                    k3.topn_packed_plain(q0, Yd, 16), table0), iters=20),
                "bound": bound(B, N, k, 16),
                "library_ms": time_ms(lambda: torch.topk(qd @ Yd.T, 16)),
            }
            if B == 128:
                row["k3_host_us"] = host_breakdown(one, wrapper_parts(k3))
                row["k3s_host_us"] = host_breakdown(k3s, wrapper_parts(k3))
            out["k3s"].append(row)
        print(f"  K3s times: {json.dumps(out['k3s'])}", flush=True)
    del single, sharded

    # K9s + K9m: the ML-20M item factors (float32, cosine, positive_only)
    # under the Similar Product traffic's exclude and include lists
    sp_model = psp.sp_model_from_numpy(itf, sp_deploy["ids"], sp_deploy["cats"],
                                       sp_deploy["params"])
    specs = [(i, sp_model._retrieval_spec(psp.Query(**b)))
             for i, b in enumerate(sp_deploy["bodies"])]
    specs = [(i, s) for i, s in specs if s is not None]
    r1, rS = ItemRetriever(itf, device=device), ItemRetriever(itf, mesh=mesh)
    for at in range(0, len(specs), 128):
        part = specs[at:at + 128]
        q = np.stack([s[0] for _, s in part]).astype(np.float32)
        ex, inc = [s[1] for _, s in part], [s[2] for _, s in part]
        n = pow2_topk_width(max(sp_deploy["bodies"][i]["num"] for i, _ in part), N)
        kw = dict(exclude=ex, include=inc, positive_only=True, normalize=True)
        got, want = rS.topn(q, n, **kw), r1.topn(q, n, **kw)
        if not (same_bits(got[0], want[0]) and same_bits(got[1], want[1])):
            raise AssertionError(f"K9s batch at {at}: not the single-device retriever's answer")
        if at == 0:
            ms, mi = shard_kernel_checks(rS, q, n, ex, inc, True, True, device,
                                         f"K9s {S} shards", errs)
            if not (same_bits(ms[:len(q)], want[0]) and same_bits(mi[:len(q)], want[1])):
                raise AssertionError("K9s: the kernels' merged candidates are not the answer")
    print(f"  K9s + K9m on {S} shards: {len(specs)} Similar Product queries bit for bit the "
          "single-device retriever's; the shard forms and K9m against their twins", flush=True)
    if timed:
        out["k9s"] = shard_times(rng, rS, itf, True, True, device)
    r1.free()
    rS.free()

    # K10s: the quantized catalog at int8 and bf16, B = 8 and 128
    Yq = quantized_catalog()
    Y64 = Yq.astype(np.float64)
    out["k10s"] = {}
    for prec in ("int8", "bf16"):
        r1 = ItemRetriever(Yq, device=device, precision=prec)
        rS = ItemRetriever(Yq, mesh=mesh, precision=prec)
        hits = {"sharded": 0, "single": 0}
        total = differ = 0
        for B in (8, 128):
            for rep in range(4):
                q = rng.standard_normal((B, Yq.shape[1])).astype(np.float32)
                got, want = rS.topn(q, 10), r1.topn(q, 10)
                differ += check_quantized_rows(got, want, f"K10s {prec} B={B}")
                ref = exact_top10(Y64, q)
                for name, (_, ids) in (("sharded", got), ("single", want)):
                    hits[name] += sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(), ref.tolist()))
                total += ref.shape[0]
                if rep == 0:
                    shard_kernel_checks(rS, q, 10, [None] * B, [None] * B, False, False, device,
                                        f"K10s {prec} B={B}", errs)
        recall = {name: h / (10 * total) for name, h in hits.items()}
        if recall["sharded"] < recall["single"]:
            raise AssertionError(f"K10s {prec}: recall@10 {recall} below the single device's")
        out["k10s"][prec] = {"queries": total, "rows_differing": differ, "recall@10": recall}
        print(f"  K10s {prec} on {S} shards: {total} queries, {differ} rows not bit for bit the "
              f"single device's (each no lower), recall@10 {recall}", flush=True)
        if timed:
            out["k10s"][prec]["times"] = shard_times(rng, rS, Yq, False, False, device)
        r1.free()
        rS.free()

    # K14s: the host path's scorer at Q = 4, 8, 16, every row K14's bit for
    # bit (a row's arithmetic does not depend on its shard or its table)
    sc1, scS = SimilarityScorer(itf, device=device), SimilarityScorer(itf, mesh=mesh)
    for Q in (4, 8, 16):
        q = sc1.normed[rng.integers(0, N, Q)]
        a, b = scS.cosine_sum(q), sc1.cosine_sum(q)
        if not same_bits(a, b):
            raise AssertionError(f"K14s Q={Q}: {int((a != b).sum())} rows differ from K14's "
                                 f"(largest {float(np.abs(a - b).max())})")
    errs["cosine_sum_sharded"] = max(errs.get("cosine_sum_sharded", 0.0), 0.0)
    out["k14s"] = {"largest_difference": 0.0, "bit_equal_calls": 3}
    print(f"  K14s on {S} shards: every row bit for bit K14's at Q = 4, 8, 16", flush=True)
    if timed:
        q = torch.from_numpy(sc1.normed[rng.integers(0, N, 8)].astype(np.float32)).to(device)
        # as SimilarityScorer scores: one launch per distinct device over
        # its shards' table, each shard into its block of one sum vector
        call = lambda: scS.sums(q)
        out["k14s"].update({
            "Q": 8, "ms": time_ms(call), "device_ms": device_ms(call, calls=100),
            "fetch_once_ms": time_ms(lambda: call().cpu(), iters=50),
            "k14_ms": time_ms(lambda: sc1.sums(q)),
            "k14_device_ms": device_ms(lambda: sc1.sums(q), calls=100),
            "plain_ms": time_ms(lambda: [k14.cosine_sum_plain(q, y) for y in scS._shards],
                                iters=20),
            "bound": roofline(4 * (8 * k + N * k + N), 2 * 8 * N * k),
            "library_ms": time_ms(lambda: (q @ sc1._shards[0].T).sum(0)),
            "host_us": host_breakdown(call, wrapper_parts(k14)),
        })
        print(f"  K14s times: {json.dumps(out['k14s'])}", flush=True)
    return out


def mesh_deployments(device, spec, traffic, q_served, sp_deploy, workdir):
    """Phase 3's model (float32, int8) and R3's Similar Product model
    deployed through ``tools.cli deploy --serving-devices <spec>``, each
    sent its single-device deployment's queries from 32 clients, counted
    from 0: every answer equal to the single-device deployment's (float32
    and Similar Product exactly; int8 exactly or ``no_lower``), every launch
    a row-shard form (K3 one per distinct device per batch, over its
    shards' table). Returns (launches per deployment, stats)."""
    import numpy as np

    counters = mesh_counters()
    S = len(spec.split(","))
    n_dev = len(set(spec.split(",")))
    runs = (("ml20m_trained", traffic["bodies"], traffic["answers"]),
            ("ml20m_int8", traffic["bodies"], q_served["int8"]),
            ("ml20m_similar", sp_deploy["bodies"], sp_deploy["answers"]))
    launches, stats = {}, {"serving_devices": spec}
    for name, bodies, single_answers in runs:
        server = Deployment(os.path.join(workdir, f"{name}.npz"), device,
                            ("--serving-devices", spec))
        try:
            for c in counters:
                c.reset()
            answers, wall = server.send(bodies, 32)
            status = server.status()
            counts = snapshot(counters)
        finally:
            server.stop()
        batches = status["batches"]
        if any(v for c, v in counts.items() if c.endswith("_plain")) or counts["cosine_sum"]:
            raise AssertionError(f"{name} on the mesh: a twin or the host path ran: {counts}")
        # every mask, kernel A and kernel B launch is one shard's: S of
        # each per merged batch (the single-device retriever merges none)
        merges = counts["merge_topn"]
        if name == "ml20m_trained":
            ok = counts["topn_packed"] % n_dev == 0 \
                and 1 <= counts["topn_packed"] // n_dev <= batches \
                and merges == counts["masked_topn"] == 0
        else:
            quant = name == "ml20m_int8"
            ok = (1 <= merges <= batches and counts["topn_packed"] == 0
                  and counts["candidate_mask"] == counts["masked_topn"] == S * merges
                  and counts["rescore_topn"] == (S * merges if quant else 0))
        if not ok:
            raise AssertionError(f"{name} on the mesh: launches {counts} for {batches} batches")
        want = {i: res["itemScores"] for i, _, res in single_answers}
        differ = 0
        for i, _, res in answers:
            got = res["itemScores"]
            if got == want[i]:
                continue
            if name != "ml20m_int8" or len(got) != len(want[i]):
                raise AssertionError(f"{name} query {i} on the mesh: {got[:3]} != {want[i][:3]}")
            differ += 1
            no_lower(np.array([x["score"] for x in got]), np.array([x["score"] for x in want[i]]),
                     f"{name} query {i}")
        launches[name] = counts
        stats[name] = {"queries": len(answers), **latency_stats(answers, wall), "batches": batches,
                       "batch_fill_mean": status["batchFillMean"],
                       "server_avg_ms": status["avgServingSec"] * 1e3,
                       "deploy_s": server.deploy_s, "answers_differing": differ,
                       "launches": {c: v for c, v in counts.items() if v},
                       "launches_per_batch": {c: v / batches for c, v in counts.items() if v}}
        print(f"  {name} over --serving-devices {spec}: {len(answers) - differ} of "
              f"{len(answers)} answers equal the single-device deployment's; p50 "
              f"{stats[name]['p50_ms']:.2f} ms, p99 {stats[name]['p99_ms']:.2f} ms, "
              f"{stats[name]['qps']:.1f} q/s; launches {stats[name]['launches']}", flush=True)
    return launches, stats


def mesh_host_path(rng, device, mesh, itf, sp_deploy):
    """The Similar Product host path (a model without a retriever) over the
    mesh, K14s: ``MESH_HOST_QUERIES`` of R3's queries, counted from 0
    (cosine_sum = one per distinct device per query with a known item,
    twins 0), each answer against the single-device host path's (ids
    outside near-tie runs, scores rtol 1e-6). Returns the launches."""
    import numpy as np

    from predictionio_tpu_torch.models.similarproduct import engine as psp
    from predictionio_tpu_torch.ops import similarity as k14
    from predictionio_tpu_torch.ops.topn import check_topn_agreement

    args = (itf, sp_deploy["ids"], sp_deploy["cats"], sp_deploy["params"])
    alg = psp.ALSAlgorithm(sp_deploy["params"])
    single, sharded = psp.sp_model_from_numpy(*args), psp.sp_model_from_numpy(*args)
    single.attach_device(device)
    sharded.attach_serving_mesh(mesh)
    bodies = sp_deploy["bodies"]
    queries = [(int(i), psp.Query(**bodies[i]))
               for i in rng.choice(len(bodies), MESH_HOST_QUERIES, replace=False)]
    want = dict(alg.batch_predict(single, queries))
    k14.LAUNCHES.reset()
    got = dict(alg.batch_predict(sharded, queries))
    counts = k14.LAUNCHES.snapshot()
    known = sum(any(i in sharded.item_index for i in q.items) for _, q in queries)
    S, n_dev = mesh.shape["data"], len(mesh.distinct_devices())
    if counts["cosine_sum"] != n_dev * known or counts["cosine_sum_plain"]:
        raise AssertionError(f"host path on the mesh: {counts} for {known} queries on "
                             f"{n_dev} devices")
    for i, _ in queries:
        g, w = got[i].item_scores, want[i].item_scores
        if len(g) != len(w):
            raise AssertionError(f"host path query {i}: {len(g)} items, one device gave {len(w)}")
        if g:
            check_topn_agreement(np.array([[x.score for x in g]]),
                                 np.array([[single.item_index[x.item] for x in g]]),
                                 np.array([[x.score for x in w]]),
                                 np.array([[single.item_index[x.item] for x in w]]), 1e-6, 1e-6)
    print(f"  Similar Product host path on {S} shards of {n_dev} devices: {len(queries)} queries "
          f"equal the single device's (rtol 1e-6); cosine_sum {counts['cosine_sum']} "
          f"({known} with a known item)", flush=True)
    return counts


def mesh_phase(rng, device, workdir, model, traffic, q_served, sp_deploy):
    """3m: serving on a mesh of MESH_SHARDS logical shards of the card (and,
    with several cards, on a mesh of distinct cards): K3s, K9s + K9m, K10s
    and K14s against the single-device serving structures, the row-shard
    forms and K9m against their twins, then the main path: the HTTP
    deployments over the mesh and the host path, counted from 0. Logical
    shards of one card run one after another, so no time here is a
    multi-GPU time. Returns (launches, largest errors, stats)."""
    import torch

    from predictionio_tpu_torch.parallel.mesh import make_mesh

    errs = {}
    spec = ",".join([str(device.index or 0)] * MESH_SHARDS)
    mesh = make_mesh({"data": MESH_SHARDS}, [device] * MESH_SHARDS)
    stats = {"logical": mesh_serving_checks(rng, device, mesh, model, traffic, sp_deploy, errs,
                                            timed=True)}
    counts, stats["http"] = mesh_deployments(device, spec, traffic, q_served, sp_deploy, workdir)
    counts["host_path"] = mesh_host_path(rng, device, mesh, model.arrays.item_factors, sp_deploy)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = list(range(min(MESH_SHARDS, n_cards)))
        cmesh = make_mesh({"data": len(cards)}, [torch.device("cuda", c) for c in cards])
        stats["cards"] = mesh_serving_checks(rng, device, cmesh, model, traffic, sp_deploy, errs,
                                             timed=False)
        _, stats["cards_http"] = mesh_deployments(device, ",".join(map(str, cards)), traffic,
                                                  q_served, sp_deploy, workdir)
        mesh_host_path(rng, device, cmesh, model.arrays.item_factors, sp_deploy)
    else:
        print("  one card: no mesh of distinct cards to run", flush=True)
    stats["card"] = card_line()
    stats["note"] = ("logical shards of one card run one after another on its stream: "
                     "these are not multi-GPU times")
    print("mesh_serving " + json.dumps(stats), flush=True)
    return counts, errs, stats


TRAIN_SHARDS = 4  # 3t: logical shards of the card that train (every shard on the card)
OBJ_MESH_RTOL = 1e-6  # 3t: the sharded objective against one device's, of its scale
TEL_MESH_RTOL = 1e-6  # 3t: mesh telemetry rows against one device's (cross-shard sums regrouped)


def train_counters():
    from predictionio_tpu_torch.ops import (
        device_pack, gramian, grid, normal_eq, predict_pairs, spd_solve, subspace, topn,
    )

    return (normal_eq.LAUNCHES, spd_solve.LAUNCHES, device_pack.LAUNCHES, gramian.LAUNCHES,
            subspace.LAUNCHES, grid.LAUNCHES, topn.LAUNCHES, predict_pairs.LAUNCHES)


def check_counts(counts, want, label):
    """Every named count as wanted, every other kernel and twin 0."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"3t {label}: {name} launched {n} times, not {want.get(name, 0)}"
                                 f" ({ {k: v for k, v in counts.items() if v} })")


def shard_rows(side, R1):
    """(shard, first row, end row, rows one device has too, pack) of each
    shard with rows."""
    for s, _, r0, r1, pack in side.shards():
        yield s, r0, r1, max(0, min(r1, R1) - r0), pack


def check_shard_half_step(Y, one, side, X_prev, lam, obs, G, implicit, label):
    """K1 and K2 on each shard against one device's launch on the whole
    side (``one``), bit for bit: the systems of every row both have, then
    the rows K2 writes into one next array."""
    import torch

    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2

    R1 = one.n_sys_rows
    A1, b1 = k1.normal_eq(Y, one, implicit, ALPHA)
    X1 = k2.spd_solve(A1, b1, lam[:R1], obs[:R1], X_prev[:R1], None, G)
    X = torch.empty_like(X_prev)
    for s, r0, r1, n, pack in shard_rows(side, R1):
        A, b = k1.normal_eq(Y, pack, implicit, ALPHA)
        if not (bits_equal(A[:n], A1[r0:r0 + n]) and bits_equal(b[:n], b1[r0:r0 + n])):
            raise AssertionError(f"3t {label}: shard {s}'s K1 systems differ from one device's")
        k2.spd_solve(A, b, lam[r0:r1], obs[r0:r1], X_prev[r0:r1], None, G, out=X[r0:r1])
    if not bits_equal(X[:R1], X1):
        raise AssertionError(f"3t {label}: the shards' K2 rows differ from one device's")
    print(f"  {label}: K1 systems and K2 rows of {len(list(side.shards()))} shards bit for bit "
          f"one device's", flush=True)
    return X1


def mesh_edge_cases(device):
    """Small ratings on the card where a user holds more ratings than the
    other users together: at 2, 3 and 4 shards the split leaves shards
    empty and one holding padding rows only, and every row trains as on
    one device, in both modes."""
    import numpy as np

    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(23)
    # users 0-149 light, user 150 heavy, users 151-299 without ratings
    n_u, n_i = 300, 120
    u = np.concatenate([rng.integers(0, 150, 1000), np.full(9000, 150)]).astype(np.int32)
    i = rng.integers(0, n_i, len(u)).astype(np.int32)
    r = rng.integers(1, 11, len(u)).astype(np.float32) / 2
    seen = {"empty": False, "unobserved": False}
    for S in (2, 3, 4):
        for implicit in (False, True):
            cfg = als.ALSConfig(rank=RANK, iterations=3, reg=REG, implicit_prefs=implicit,
                                segment_length=16)
            t = {}
            got = als.train_als(u, i, r, n_u, n_i, cfg, mesh=make_mesh({"data": S}, [device] * S),
                                timings=t)
            one = als.train_als(u, i, r, n_u, n_i, cfg, device=device)
            if not (same_bits(got.user_factors, one.user_factors)
                    and same_bits(got.item_factors, one.item_factors)):
                raise AssertionError(f"3t edge cases: {S} shards (implicit {implicit}) differ "
                                     "from one device")
            rows_, ratings_ = t["shard_rows"]["user"], t["shard_ratings"]["user"]
            seen["empty"] |= 0 in rows_
            seen["unobserved"] |= any(n > 0 and m == 0 for n, m in zip(rows_, ratings_))
    if not all(seen.values()):
        raise AssertionError(f"3t edge cases: not every case arose ({seen})")
    print("  edge cases (a user heavier than a shard's share; empty shards and a shard of "
          "padding rows only; 2, 3 and 4 shards; both modes): bit for bit one device", flush=True)


class PackCache:
    """3t's host packs, once for each distinct input: while installed,
    ``ops/als.py``'s ``mesh_pack_sides`` (the mesh route's host pack of both
    sides) returns the pack it made before for the same COO (by a digest of
    its bytes) and the same geometry, so the trainings on phase 3's ratings
    share one pack. A training's own ``pack_s`` then times a hit."""

    def __init__(self, als):
        self.als, self.real = als, als.mesh_pack_sides
        self.entries, self.hits, self.misses = {}, 0, 0

    def __enter__(self):
        self.als.mesh_pack_sides = self.packed
        return self

    def __exit__(self, *exc):
        self.als.mesh_pack_sides = self.real
        self.entries.clear()

    def packed(self, u, i, r, *geometry):
        import hashlib

        import numpy as np

        h = hashlib.blake2b(digest_size=16)
        for a in (u, i, r):
            h.update(np.ascontiguousarray(a).view(np.uint8))
        key = (h.hexdigest(),) + tuple(int(g) for g in geometry)
        if key in self.entries:
            self.hits += 1
        else:
            self.misses += 1
            self.entries[key] = self.real(u, i, r, *geometry)
        return self.entries[key]


def mesh_train_phase(rng, device, refs):
    """3t with its host packs shared (``PackCache``)."""
    from predictionio_tpu_torch.ops import als

    with PackCache(als) as packs:
        return _mesh_train_phase(rng, device, refs, packs)


def _mesh_train_phase(rng, device, refs, packs):
    """3t: ALS training on a mesh of TRAIN_SHARDS logical shards of the
    card (``[cuda:0] * 4``; with several cards also on the visible cards):
    the row-shard forms of K1, K2, K12, K11 and K13 against one device's
    launches, bit for bit; the main path (``Engine.train`` of the
    recommendation template on ``WorkflowContext(mesh=...)``) counted from
    0 and bit for bit phase 3's model; the implicit, bf16, iALS++, Similar
    Product and checkpointed forms bit for bit their single-device phases;
    the grid (K13s) and ``run_evaluation`` on the mesh; times. ``refs``
    holds the earlier phases' models and stats. The main path packs phase
    3's ratings; the shard forms and the other trainings on them reuse that
    pack (``packs``). Logical shards of one card run one after another, so
    no time here is a multi-GPU time. Returns (launches, errors, stats)."""
    import dataclasses

    import numpy as np
    import torch

    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.data.store import EventColumns
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.models.recommendation.evaluation import (
        ParamsGrid,
        RecommendationEvaluation,
    )
    from predictionio_tpu_torch.models.similarproduct import engine as psp
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.ops import gramian as k12
    from predictionio_tpu_torch.ops import grid as k13
    from predictionio_tpu_torch.ops import normal_eq as k1
    from predictionio_tpu_torch.ops import spd_solve as k2
    from predictionio_tpu_torch.ops import subspace as k11
    from predictionio_tpu_torch.parallel.mesh import Mesh
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
    from predictionio_tpu_torch.workflow.workflow_params import WorkflowParams

    t_phase = time.perf_counter()
    S = TRAIN_SHARDS
    mesh = Mesh([device] * S, {"data": S})
    note = ("logical shards of one card run one after another on its stream: "
            "these are not multi-GPU times")
    print(f"  {S} logical shards of {device}: {note}", flush=True)
    counters = train_counters()
    errs, stats, launches = {}, {"card": card_line(), "note": note}, {}
    model, f32_stats = refs["model"], refs["f32_stats"]
    u, i, r = ml20m_ratings()
    n_users, n_items, k = ML20M_USERS, ML20M_ITEMS, RANK
    remap_u = np.array([model.user_index.get(f"u{n}", -1) for n in range(n_users)], np.int32)
    remap_i = np.array([model.item_index.get(f"i{n}", -1) for n in range(n_items)], np.int32)
    u_rel, i_rel = remap_u[u], remap_i[i]
    n_u, n_i = len(model.user_index), len(model.item_index)
    seed = rec.ALSAlgorithmParams().seed
    config = als.ALSConfig(rank=k, iterations=SWEEPS, reg=REG, seed=seed)
    R_u, R_i = als._padded_rows(n_u, S), als._padded_rows(n_i, S)
    if (R_u, R_i) != (als._padded_rows(n_u, 1), als._padded_rows(n_i, 1)):
        raise AssertionError("3t: the ML-20M sides pad to other rows on the mesh; the checks "
                             "below compare one device's state row for row")

    # a. the main path: Engine.train of the recommendation template on the
    # workflow's mesh, every launch count from 0; its host pack is the one
    # the shard forms and the other trainings on these ratings reuse
    cols = EventColumns(model.user_index, model.item_index, u_rel, i_rel, r)
    ctx = WorkflowContext(device, {"default": cols}, mesh=mesh)
    ep = EngineParams(
        data_source_params=("", rec.DataSourceParams(app_name="default")),
        algorithm_params_list=(("als", rec.ALSAlgorithmParams(rank=k, num_iterations=SWEEPS,
                                                              lambda_=REG)),),
    )
    t_main = {}
    train_als = rec.train_als
    rec.train_als = lambda *a, **kw: train_als(*a, timings=t_main, **kw)
    try:
        for c in counters:
            c.reset()
        t = time.perf_counter()
        [mesh_model] = rec.recommendation_engine().train(ctx, ep, WorkflowParams())
        main_s = time.perf_counter() - t
        counts = snapshot(counters)
    finally:
        rec.train_als = train_als
    check_counts(counts, {"normal_eq": 2 * SWEEPS * S, "spd_solve": 2 * SWEEPS * S}, "main path")
    if (packs.misses, packs.hits) != (1, 0):
        raise AssertionError(f"3t: the main path packed {packs.misses} times, hit {packs.hits}")
    launches["main"] = counts
    if not (same_bits(mesh_model.arrays.user_factors, model.arrays.user_factors)
            and same_bits(mesh_model.arrays.item_factors, model.arrays.item_factors)):
        raise AssertionError("3t: the mesh's model differs from phase 3's")
    tel_mesh = np.array([[row[c] for c in ("dx", "dy", "x_rms", "y_rms")] for row in t_main["sweep_telemetry"]])
    tel_one = np.array([[row[c] for c in ("dx", "dy", "x_rms", "y_rms")] for row in f32_stats["telemetry"]])
    errs["telemetry"] = float(np.max(np.abs(tel_mesh - tel_one) / np.abs(tel_one)))
    if errs["telemetry"] > TEL_MESH_RTOL:
        raise AssertionError(f"3t: telemetry rows off by {errs['telemetry']} of one device's")
    print(f"  main path: Engine.train on the mesh {main_s:.2f} s (host pack {t_main['pack_s']:.2f} s, "
          f"upload {t_main['device_put_s']:.2f} s, loop {t_main['device_loop_s']:.4f} s, "
          f"{t_main['device_loop_s'] * 1e3 / SWEEPS:.3f} ms per sweep); factors bit for bit phase "
          f"3's; telemetry within {errs['telemetry']:.2e}; launches "
          f"{ {n: v for n, v in counts.items() if v} }", flush=True)

    # b. the row-shard forms on the real sides, the main path's packs,
    # against one device's launches on the wire route's packs
    wire = als.build_host_wire(u_rel, i_rel, r, n_u, n_i, config)
    up, ip = als.device_pack_from_wire(wire, device)
    X0, Y0, lam_u, lam_i, obs_u, obs_i = als.init_factor_state_single(
        wire.counts_u, wire.counts_i, n_u, n_i, config, device=device)
    order = np.argsort(u_rel, kind="stable")
    us, is_, rs = u_rel[order], i_rel[order], r[order]
    hits = packs.hits
    host_u, host_i = als.mesh_pack_sides(us, is_, rs, n_u, n_i, R_u, R_i, wire.L_u, wire.L_i,
                                         config.chunk_slots, S)
    if packs.hits != hits + 1:
        raise AssertionError("3t: the shard forms' packs are not the main path's")
    user = als.upload_mesh_side(*host_u[:2], mesh.devices, R_u, R_i, R_u)
    item = als.upload_mesh_side(*host_i[:2], mesh.devices, R_i, R_u, R_i)
    for (bounds, _, slots, ratings), name in ((host_u, "user"), (host_i, "item")):
        print(f"  {name} side: rows per shard {np.diff(bounds).tolist()}, segment slots "
              f"{slots} (skew {max(slots) / np.mean(slots):.4f}), ratings {ratings} (skew "
              f"{max(ratings) / np.mean(ratings):.4f})", flush=True)
    del host_u, host_i
    X1 = check_shard_half_step(Y0, up, user, X0, lam_u, obs_u, None, False,
                               "first half-step, users")
    check_shard_half_step(X1, ip, item, Y0, lam_i, obs_i, None, False, "first half-step, items")
    X3, Y3, _ = als._run_iterations(X0, Y0, up, ip, lam_u, lam_i, obs_u, obs_i, 3)
    X4 = check_shard_half_step(Y3, up, user, X3, lam_u, obs_u, None, False, "sweep 4, users")
    check_shard_half_step(X4, ip, item, Y3, lam_i, obs_i, None, False, "sweep 4, items")
    # K12a: each device forms G over the replica's first gram_rows rows
    G = k12.gramian(Y3)
    if not bits_equal(k12.gramian(Y3[: item.gram_rows]), G):
        raise AssertionError("3t: K12a over the replica's rows differs from one device's G")
    check_shard_half_step(Y3, up, user, X3, lam_u, obs_u, G, True, "sweep 4, users, implicit (+G)")
    # K12b: every shard's partials and one finish against one device's launch
    out = torch.zeros(1, dtype=torch.float32, device=device)
    Xr, Yr = {device: X4}, {device: Y3}
    lr_u, lr_i = {device: lam_u}, {device: lam_i}

    def objective_mesh():
        als._objective_mesh(Xr, Yr, user, item, lr_u, lr_i, ALPHA, out, "float32")
        return out

    want = k12.implicit_objective(X4, Y3, up, lam_u, lam_i, ALPHA).item()
    got = objective_mesh().item()
    scale = objective_scale(X4, Y3, up, lam_u, lam_i, ALPHA)
    errs["implicit_objective_shard"] = abs(got - want) / scale
    if errs["implicit_objective_shard"] > OBJ_MESH_RTOL:
        raise AssertionError(f"3t: the sharded objective {got} vs one device's {want} "
                             f"(scale {scale})")
    print(f"  K12b on {S} shards {got} vs one device {want}: {errs['implicit_objective_shard']:.2e} "
          f"of its scale (<= {OBJ_MESH_RTOL})", flush=True)
    # K11a and K11b at 3p's rank and block, block by block
    kb, bb = SUB_RANK, SUB_BLOCK
    g = np.random.default_rng(31)
    Y64 = torch.from_numpy((np.abs(g.standard_normal((R_i, kb))) / np.sqrt(kb)).astype(np.float32)).to(device)
    Y64[n_i:] = 0
    X64 = torch.from_numpy((g.standard_normal((R_u, kb)) / np.sqrt(kb)).astype(np.float32)).to(device)
    X64[n_u:] = 0
    G64 = k12.gramian(Y64)
    X_one, X_mesh = X64.clone(), X64.clone()
    # the score carried across the blocks: one device's buffers, and a pair
    # a shard (here block by block, the shards take turns within a block)
    sc_one, dl_one = k11.CarryBuffers([up], bb).views(up)
    shard_carry = {s: k11.CarryBuffers([pack], bb).views(pack)
                   for s, *_, pack in shard_rows(user, R_u)}
    for s0 in range(0, kb, bb):
        first, last = s0 == 0, s0 == kb - bb
        A1, r1_ = k11.subspace_accumulate(Y64, X_one, up, s0, bb, True, ALPHA, "float32", sc_one,
                                          None if first else dl_one)
        k11.subspace_block_solve(A1, r1_, X_one, lam_u, obs_u, s0, G64,
                                 delta=None if last else dl_one)
        for s, r0, r1, n, pack in shard_rows(user, R_u):
            sc, dl = shard_carry[s]
            A, rv = k11.subspace_accumulate(Y64, X_mesh[r0:r1], pack, s0, bb, True, ALPHA,
                                            "float32", sc, None if first else dl)
            if not (bits_equal(A[:n], A1[r0:r0 + n]) and bits_equal(rv[:n], r1_[r0:r0 + n])):
                raise AssertionError(f"3t: K11a of shard {s}, block {s0 // bb}, differs")
            k11.subspace_block_solve(A, rv, X_mesh[r0:r1], lam_u[r0:r1], obs_u[r0:r1], s0, G64,
                                     delta=None if last else dl)
            if not last and not bits_equal(dl[:n], dl_one[r0:r0 + n]):
                raise AssertionError(f"3t: K11b's Δ of shard {s}, block {s0 // bb}, differs")
        if not bits_equal(X_mesh, X_one):
            raise AssertionError(f"3t: K11b's rows after block {s0 // bb} differ")
    print(f"  K11a (score carried) and K11b at rank {kb}, b = {bb}, every block of a user "
          f"half-step on {S} shards: bit for bit one device's, Δ too", flush=True)
    # K13a and K13b at 3e's fold-0 shape (rank 16, V = 2)
    td0 = refs["td0"]
    fu, fi, fr = (np.asarray(a) for a in (td0.user_idx, td0.item_idx, td0.ratings))
    fn_u, fn_i = len(td0.user_index), len(td0.item_index)
    fR_u, fR_i = als._padded_rows(fn_u, S), als._padded_rows(fn_i, S)
    if (fR_u, fR_i) != (als._padded_rows(fn_u, 1), als._padded_rows(fn_i, 1)):
        raise AssertionError("3t: fold 0's sides pad to other rows on the mesh")
    L0 = als.auto_segment_length(fu, fn_u, config.segment_length)
    one0 = als.device_pack(als.pack_segments(fu, fi, fr, fn_u, L0, 1, config.chunk_slots),
                           fR_u, fR_i, device)
    user0 = als.upload_mesh_side(
        *als.mesh_pack_side(fu, fi, fr, fn_u, fR_u, L0, config.chunk_slots, S)[:2],
        mesh.devices, fR_u, fR_i, fR_u)
    V, k16 = 2, 16
    Yv = torch.from_numpy((np.abs(g.standard_normal((V, fR_i, k16))) / 4).astype(np.float32)).to(device)
    Xv = torch.zeros((V, fR_u, k16), dtype=torch.float32, device=device)
    counts0 = np.bincount(fu, minlength=fn_u)
    lam_v = torch.from_numpy(np.stack([als._lam_obs_host(counts0, fn_u, fR_u, als.ALSConfig(reg=reg))[0]
                                       for reg in (0.01, 0.1)])).to(device)
    obs_v = torch.from_numpy(als._lam_obs_host(counts0, fn_u, fR_u, als.ALSConfig())[1]).to(device)
    A1, b1 = k13.normal_eq_variants(Yv, one0)
    Xv1 = k13.spd_solve_variants(A1, b1, lam_v, obs_v, Xv)
    Xv_mesh = torch.empty_like(Xv)
    for s, r0, r1, n, pack in shard_rows(user0, fR_u):
        A, b = k13.normal_eq_variants(Yv, pack)
        if not (bits_equal(A[:, :n], A1[:, r0:r0 + n]) and bits_equal(b[:, :n], b1[:, r0:r0 + n])):
            raise AssertionError(f"3t: K13a of shard {s} differs from one device's")
        k13.spd_solve_variants(A, b, lam_v, obs_v, Xv, out=Xv_mesh, row0=r0)
    if not bits_equal(Xv_mesh, Xv1):
        raise AssertionError("3t: the shards' K13b rows differ from one device's")
    print(f"  K13a and K13b on fold 0's users (rank {k16}, V = {V}) on {S} shards: bit for bit "
          "one device's", flush=True)
    for name in ("normal_eq_shard", "spd_solve_shard", "subspace_accumulate_shard",
                 "subspace_block_solve_shard", "normal_eq_variants_shard",
                 "spd_solve_variants_shard"):
        errs[name] = 0.0  # every check above is bit for bit
    mesh_edge_cases(device)

    # c. the other forms, each against its single-device phase
    def form(label, cfg, want_arrays, want_counts, **kw):
        for c in counters:
            c.reset()
        t_f = {}
        t = time.perf_counter()
        got = als.train_als(u_rel, i_rel, r, n_u, n_i, cfg, mesh=mesh, timings=t_f, **kw)
        wall = time.perf_counter() - t
        counts = snapshot(counters)
        check_counts(counts, want_counts, label)
        if want_arrays is not None and not (
                same_bits(got.user_factors, want_arrays.user_factors)
                and same_bits(got.item_factors, want_arrays.item_factors)):
            raise AssertionError(f"3t {label}: factors differ from the single-device phase's")
        launches[label] = counts
        print(f"  {label}: {wall:.2f} s (pack {t_f['pack_s']:.2f} s, loop {t_f['device_loop_s']:.4f} "
              f"s){' bit for bit its phase' if want_arrays is not None else ''}", flush=True)
        return got, t_f, wall

    nobj = {"gramian": 4 * SWEEPS, "implicit_objective_shard": S * SWEEPS,
            "implicit_objective_finish": SWEEPS}
    _, t_imp, _ = form("implicit (3i)", dataclasses.replace(config, alpha=ALPHA, implicit_prefs=True),
                       refs["implicit"].arrays,
                       {"normal_eq": 2 * SWEEPS * S, "spd_solve": 2 * SWEEPS * S, **nobj})
    form("bf16 (3h)", dataclasses.replace(config, compute_dtype=BF16), refs["bf16"],
         {"normal_eq_bf16": 2 * SWEEPS * S, "spd_solve": 2 * SWEEPS * S})
    nb = SUB_RANK // SUB_BLOCK
    sub_cfg = dataclasses.replace(config, rank=SUB_RANK, alpha=ALPHA, implicit_prefs=True,
                                  solver="subspace", block_size=SUB_BLOCK)
    sub_want = {"subspace_accumulate": 2 * SWEEPS * S * nb, "subspace_block_solve": 2 * SWEEPS * S * nb,
                **nobj}
    # K11a's combine kernel runs inside its call for shards with multi-group rows
    for c in counters:
        c.reset()
    t_f = {}
    got = als.train_als(u_rel, i_rel, r, n_u, n_i, sub_cfg, mesh=mesh, timings=t_f)
    counts = snapshot(counters)
    sub_want["subspace_combine"] = counts["subspace_combine"]
    check_counts(counts, sub_want, "iALS++ (3p)")
    if not (same_bits(got.user_factors, refs["subspace"].arrays.user_factors)
            and same_bits(got.item_factors, refs["subspace"].arrays.item_factors)):
        raise AssertionError("3t iALS++: factors differ from 3p's")
    launches["iALS++ (3p)"] = counts
    print(f"  iALS++ (3p, rank {SUB_RANK}, b = {SUB_BLOCK}): loop {t_f['device_loop_s']:.4f} s, bit "
          "for bit 3p's", flush=True)
    sp_td, sp_model = refs["sp"]
    sp_params = psp.ALSAlgorithmParams(rank=k, num_iterations=SWEEPS, lambda_=SP_REG, alpha=ALPHA)
    for c in counters:
        c.reset()
    got = psp.ALSAlgorithm(sp_params).train(mesh, psp.Preparator().prepare(device, sp_td))
    counts = snapshot(counters)
    check_counts(counts, {"normal_eq": 2 * SWEEPS * S, "spd_solve": 2 * SWEEPS * S, **nobj},
                 "Similar Product (3s)")
    if not same_bits(got.item_factors, sp_model.item_factors):
        raise AssertionError("3t: Similar Product's ALSAlgorithm on the mesh differs from 3s's")
    launches["Similar Product (3s)"] = counts
    print("  Similar Product ALSAlgorithm.train(mesh): item factors bit for bit 3s's", flush=True)
    with tempfile.TemporaryDirectory() as d:
        _, t_c, _ = form("checkpoint, sweeps 1-5", dataclasses.replace(config, iterations=CKPT_EVERY),
                         None, {"normal_eq": 2 * CKPT_EVERY * S, "spd_solve": 2 * CKPT_EVERY * S},
                         checkpoint_dir=d, checkpoint_every=CKPT_EVERY)
        _, t_c, _ = form("checkpoint, resumed to 10", config, model.arrays,
                         {"normal_eq": 2 * (SWEEPS - CKPT_EVERY) * S,
                          "spd_solve": 2 * (SWEEPS - CKPT_EVERY) * S},
                         checkpoint_dir=d, checkpoint_every=CKPT_EVERY)
        if t_c["checkpoint_resumed_at"] != CKPT_EVERY:
            raise AssertionError(f"3t: the mesh run resumed at {t_c['checkpoint_resumed_at']}")
        t_one = {}
        als.train_als(u_rel, i_rel, r, n_u, n_i, config, device=device, checkpoint_dir=d,
                      checkpoint_every=CKPT_EVERY, timings=t_one)
        if t_one["checkpoint_resumed_at"] != 0:
            raise AssertionError("3t: one device resumed the 4-shard mesh's checkpoint")
    print("  a one-device run of the same data and config did not resume the mesh's checkpoint",
          flush=True)

    # d. K13s: the grid on fold 0, then run_evaluation at ML-100K's shape
    cfg16 = als.ALSConfig(rank=k16, iterations=SWEEPS, reg=0.0, seed=EVAL_SEED)
    grid_one = als.train_als_grid(fu, fi, fr, fn_u, fn_i, cfg16, [0.01, 0.1], device=device)
    for c in counters:
        c.reset()
    t_g = {}
    grid_mesh = als.train_als_grid(fu, fi, fr, fn_u, fn_i, cfg16, [0.01, 0.1], mesh=mesh, timings=t_g)
    counts = snapshot(counters)
    check_counts(counts, {"normal_eq_variants": 2 * SWEEPS * S, "spd_solve_variants": 2 * SWEEPS * S},
                 "grid on fold 0")
    if not all(same_bits(a.user_factors, b.user_factors) and same_bits(a.item_factors, b.item_factors)
               for a, b in zip(grid_mesh, grid_one)):
        raise AssertionError("3t: train_als_grid on the mesh differs from one device's")
    launches["grid fold 0"] = counts
    print(f"  train_als_grid(mesh) on fold 0 (rank {k16}, regs 0.01 and 0.1): bit for bit one "
          f"device's (pack {t_g['pack_s']:.2f} s, loop {t_g['device_loop_s']:.4f} s)", flush=True)
    mu, mi, mr = synth_ml100k()
    mcols = EventColumns(BiMap({f"u{n}": n for n in range(ML100K_USERS)}),
                         BiMap({f"i{n}": n for n in range(ML100K_ITEMS)}), mu, mi, mr)
    grid_eps = ParamsGrid().engine_params_list
    captured = {}
    real_grid = rec.ALSAlgorithm.__dict__["train_grid"]

    def train_grid(cls, target, pd, algos):
        models = real_grid.__func__(cls, target, pd, algos)
        captured[(type(target).__name__, algos[0].params.rank, len(pd.td.ratings))] = models
        return models

    def evaluate(ctx_):
        return run_evaluation(RecommendationEvaluation(k=10), grid_eps, ctx=ctx_,
                              workflow_params=WorkflowParams(grid_train="always"))

    rec.ALSAlgorithm.train_grid = classmethod(train_grid)
    try:
        one_eval = evaluate(WorkflowContext(device, {"default": mcols}))
        for c in counters:
            c.reset()
        t = time.perf_counter()
        mesh_eval = evaluate(WorkflowContext(device, {"default": mcols}, mesh=mesh))
        eval_s = time.perf_counter() - t
        counts = snapshot(counters)
    finally:
        rec.ALSAlgorithm.train_grid = real_grid
    n_grids = EVAL_K * 2  # 3 folds x the grid's 2 ranks
    grid_counts = {"normal_eq_variants": 2 * SWEEPS * S * n_grids,
                   "spd_solve_variants": 2 * SWEEPS * S * n_grids,
                   "topn_packed": counts["topn_packed"]}
    check_counts(counts, grid_counts, "run_evaluation")
    launches["run_evaluation"] = counts
    keys = sorted(key[1:] for key in captured if key[0] == "Mesh")
    if len(keys) != n_grids or keys != sorted(key[1:] for key in captured if key[0] != "Mesh"):
        raise AssertionError(f"3t: run_evaluation's grids {sorted(captured)}")
    for key in keys:
        for a, b in zip(captured[("Mesh",) + key], captured[("device",) + key]):
            if not (same_bits(a.arrays.user_factors, b.arrays.user_factors)
                    and same_bits(a.arrays.item_factors, b.arrays.item_factors)):
                raise AssertionError(f"3t: run_evaluation's model {key} differs on the mesh")
    p_mesh = [ms.score for _, ms in mesh_eval.engine_params_scores]
    p_one = [ms.score for _, ms in one_eval.engine_params_scores]
    if p_mesh != p_one:
        raise AssertionError(f"3t: Precision@10 {p_mesh} on the mesh, {p_one} on one device")
    print(f"  run_evaluation (ML-100K shape, {EVAL_K} folds, 4 variants) on the mesh: {eval_s:.2f} s, "
          f"every model and Precision@10 {p_mesh} equal to one device's", flush=True)

    # e. times: the shards' K1 and K2 at sweep 4, the K12b and K11 shard
    # forms, K13s per half-step, each beside one device's launch
    A_u, b_u = k1.normal_eq(Y3, up)
    shard_calls = {"normal_eq": {}, "spd_solve": {}}
    X_out = torch.empty_like(X3)
    systems = {}
    for s, r0, r1, n, pack in shard_rows(user, R_u):
        systems[s] = k1.normal_eq(Y3, pack)
        shard_calls["normal_eq"][s] = (lambda p=pack: k1.normal_eq(Y3, p))
        shard_calls["spd_solve"][s] = (
            lambda s=s, r0=r0, r1=r1: k2.spd_solve(*systems[s], lam_u[r0:r1], obs_u[r0:r1],
                                                   X3[r0:r1], None, None, out=X_out[r0:r1]))

    def all_shards(name):
        def run():
            for f in shard_calls[name].values():
                f()
        return run

    times = {}
    for name, one_call in (("normal_eq", lambda: k1.normal_eq(Y3, up)),
                           ("spd_solve", lambda: k2.spd_solve(A_u, b_u, lam_u, obs_u, X3))):
        times[name] = {
            "per_shard_ms": {s: time_ms(f, iters=20, warmup=2) for s, f in shard_calls[name].items()},
            "shards_ms": time_ms(all_shards(name), iters=20, warmup=2),
            "shards_device_ms": device_ms(all_shards(name), calls=5),
            "one_device_ms": time_ms(one_call, iters=20, warmup=2),
        }
    times["normal_eq"]["plain_shards_ms"] = time_ms(lambda: [
        k1.normal_eq_plain(Y3, p.seg_rows, p.cols, p.vals, p.rem, p.n_sys_rows)
        for *_, p in shard_rows(user, R_u)], iters=2, warmup=1)
    times["spd_solve"]["plain_shards_ms"] = time_ms(lambda: [
        k2.spd_solve_plain(*systems[s], lam_u[r0:r1], obs_u[r0:r1], X3[r0:r1])
        for s, r0, r1, _, _ in shard_rows(user, R_u)], iters=2, warmup=1)
    times["implicit_objective_shard"] = {
        "shards_ms": time_ms(objective_mesh, iters=20, warmup=2),
        "shards_device_ms": device_ms(objective_mesh, calls=5),
        "one_device_ms": time_ms(lambda: k12.implicit_objective(X4, Y3, up, lam_u, lam_i, ALPHA),
                                 iters=20, warmup=2),
        "plain_shards_ms": time_ms(lambda: sum(
            k12.observed_plain(X4[r0:r1], Y3, p.seg_rows, p.cols, p.vals, p.rem, ALPHA)
            for _, r0, r1, _, p in shard_rows(user, R_u)), iters=2, warmup=1),
    }
    Xk = X64.clone()

    def k11_shards(fn):
        def run():
            for _, r0, r1, _, p in shard_rows(user, R_u):
                fn(r0, r1, p)
        return run

    acc = {s: k11.subspace_accumulate(Y64, Xk[r0:r1], p, 0, bb, True, ALPHA)
           for s, r0, r1, _, p in shard_rows(user, R_u)}
    # K11a by block, the score carried (the Δ the check above left), and the
    # mean a launch over the half-step, as 3p's row
    by_start = {r0: s for s, r0, *_ in shard_rows(user, R_u)}

    nbk = kb // bb

    def k11a_at(j, r0, r1, p):
        sc, dl = shard_carry[by_start[r0]]
        return k11.subspace_accumulate(Y64, Xk[r0:r1], p, j * bb, bb, True, ALPHA, "float32", sc,
                                       None if j == 0 else dl)

    k11a_blocks = {}
    for name, j in (("block0", 0), ("block1", 1), ("last", nbk - 1)):
        fn = k11_shards(lambda r0, r1, p, j=j: k11a_at(j, r0, r1, p))
        k11a_blocks[name] = {
            "shards_ms": time_ms(fn, iters=20, warmup=2),
            "shards_device_ms": device_ms(fn, calls=5),
            "one_device_ms": time_ms(lambda j=j: k11.subspace_accumulate(
                Y64, Xk, up, j * bb, bb, True, ALPHA, "float32", sc_one, None if j == 0 else dl_one),
                iters=20, warmup=2)}
    times["subspace_accumulate"] = {
        key: (k11a_blocks["block0"][key] + (nbk - 2) * k11a_blocks["block1"][key]
              + k11a_blocks["last"][key]) / nbk
        for key in ("shards_ms", "shards_device_ms", "one_device_ms")}
    times["subspace_accumulate"].update(
        blocks=k11a_blocks,
        plain_shards_ms=time_ms(k11_shards(lambda r0, r1, p: k11.subspace_accumulate_plain(
            Y64, Xk[r0:r1], p.seg_rows, p.cols, p.vals, p.rem, r1 - r0, 0, bb, True, ALPHA)),
            iters=2, warmup=1))
    starts = {r0: s for s, r0, *_ in shard_rows(user, R_u)}
    k11b = k11_shards(lambda r0, r1, p: k11.subspace_block_solve(
        *acc[starts[r0]], Xk[r0:r1], lam_u[r0:r1], obs_u[r0:r1], 0, G64))
    A_one, r_one = k11.subspace_accumulate(Y64, Xk, up, 0, bb, True, ALPHA)
    times["subspace_block_solve"] = {
        "shards_ms": time_ms(k11b, iters=20, warmup=2),
        "shards_device_ms": device_ms(k11b, calls=5),
        "one_device_ms": time_ms(lambda: k11.subspace_block_solve(A_one, r_one, Xk, lam_u, obs_u,
                                                                  0, G64), iters=20, warmup=2),
        "plain_shards_ms": time_ms(k11_shards(lambda r0, r1, p: k11.subspace_block_solve_plain(
            *acc[starts[r0]], Xk[r0:r1].clone(), lam_u[r0:r1], obs_u[r0:r1], 0, G64)),
            iters=2, warmup=1),
    }
    sys13 = {s: k13.normal_eq_variants(Yv, p) for s, *_, p in shard_rows(user0, fR_u)}

    def k13_shards(fn):
        def run():
            for s, r0, r1, _, p in shard_rows(user0, fR_u):
                fn(s, r0, p)
        return run

    k13a = k13_shards(lambda s, r0, p: k13.normal_eq_variants(Yv, p))
    k13b = k13_shards(lambda s, r0, p: k13.spd_solve_variants(*sys13[s], lam_v, obs_v, Xv,
                                                               out=Xv_mesh, row0=r0))
    times["normal_eq_variants"] = {
        "shards_ms": time_ms(k13a, iters=20, warmup=2),
        "shards_device_ms": device_ms(k13a, calls=5),
        "one_device_ms": time_ms(lambda: k13.normal_eq_variants(Yv, one0), iters=20, warmup=2),
        "plain_shards_ms": time_ms(k13_shards(lambda s, r0, p: k13.normal_eq_variants_plain(Yv, p)),
                                   iters=2, warmup=1),
    }
    times["spd_solve_variants"] = {
        "shards_ms": time_ms(k13b, iters=20, warmup=2),
        "shards_device_ms": device_ms(k13b, calls=5),
        "one_device_ms": time_ms(lambda: k13.spd_solve_variants(A1, b1, lam_v, obs_v, Xv),
                                 iters=20, warmup=2),
        "plain_shards_ms": time_ms(k13_shards(lambda s, r0, p: k13.spd_solve_variants_plain(
            *sys13[s], lam_v[:, r0:r0 + p.n_sys_rows], obs_v[r0:r0 + p.n_sys_rows],
            Xv[:, r0:r0 + p.n_sys_rows])), iters=2, warmup=1),
    }
    times["grid_half_step"] = {
        "shards_ms": time_ms(lambda: (k13a(), k13b()), iters=10, warmup=2),
        "one_device_ms": time_ms(lambda: k13.spd_solve_variants(*k13.normal_eq_variants(Yv, one0),
                                                                lam_v, obs_v, Xv), iters=10, warmup=2),
    }
    n_obs_u = int(obs_u.sum())
    n_obs0 = int(obs_v.sum())
    bounds = {
        "normal_eq": k1_bound(up, len(r), R_i, k),
        "spd_solve": k2_bound(R_u, n_obs_u, k),
        "implicit_objective_shard": objective_bound(up, len(r), R_u, R_i, k),
        "subspace_accumulate": k11a_bound(up, len(r), R_i, kb, bb),
        "subspace_block_solve": k11b_bound(R_u, n_obs_u, kb, bb),
        "normal_eq_variants": k13a_bound(one0, len(fr), fR_i, k16, V),
        "spd_solve_variants": k13b_bound(fR_u, n_obs0, k16, V),
    }
    for name, row in times.items():
        print(f"  {name}: {json.dumps(row)}; bound {bounds.get(name)}", flush=True)
    stats.update({
        "shards": S, "devices": [str(d) for d in mesh.devices],
        "shard_rows": t_main["shard_rows"], "shard_slots": t_main["shard_slots"],
        "shard_ratings": t_main["shard_ratings"],
        "slot_skew": {side: max(v) / float(np.mean(v)) for side, v in t_main["shard_slots"].items()},
        "rating_skew": {side: max(v) / float(np.mean(v)) for side, v in t_main["shard_ratings"].items()},
        "ms_per_sweep": {"mesh": t_main["device_loop_s"] * 1e3 / SWEEPS,
                         "one_device": f32_stats["ms_per_sweep"],
                         "mesh_implicit": t_imp["device_loop_s"] * 1e3 / SWEEPS,
                         "one_device_implicit": refs["implicit_stats"]["ms_per_sweep"]},
        "host": {"mesh_pack_s": t_main["pack_s"], "mesh_device_put_s": t_main["device_put_s"],
                 "pack_cache": {"misses": packs.misses, "hits": packs.hits},
                 "direct_pack_s": f32_stats["direct"]["pack_s"],
                 "streaming": f32_stats["streaming"]},
        "main_path_s": main_s, "evaluation_s": eval_s,
        "kernel_ms": times, "bound": bounds,
        "launches": launches, "errors": errs,
    })
    # an N-card mesh, under the same checks, where the machine has cards
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", c) for c in range(min(S, n_cards))]
        cmesh = Mesh(cards, {"data": len(cards)})
        got = als.train_als(u_rel, i_rel, r, n_u, n_i, config, mesh=cmesh)
        if not (same_bits(got.user_factors, model.arrays.user_factors)
                and same_bits(got.item_factors, model.arrays.item_factors)):
            raise AssertionError("3t: the mesh of distinct cards differs from phase 3's model")
        print(f"  a mesh of {len(cards)} cards: bit for bit phase 3's model", flush=True)
    else:
        print("  one card: no mesh of distinct cards to run", flush=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    print("mesh_training " + json.dumps(stats), flush=True)
    total = {}
    for c in launches.values():
        for name, n in c.items():
            total[name] = total.get(name, 0) + n
    return total, errs, stats


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.ops import (
        categorical_nb,
        cooccurrence,
        delta_scatter,
        device_pack,
        gramian,
        grid,
        lstsq,
        markov,
        masked_topn,
        merge_topn,
        naive_bayes,
        native,
        normal_eq,
        predict_pairs,
        rescore,
        similarity,
        simrank,
        softmax_regression,
        spd_solve,
        subspace,
        topn,
    )

    # the reference holds parity in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} nvcc {native.nvcc_path()}", flush=True)
    t0 = time.perf_counter()
    kernel_modules = (topn, device_pack, normal_eq, spd_solve, predict_pairs, masked_topn, rescore,
                      gramian, similarity, subspace, cooccurrence, grid, delta_scatter, naive_bayes,
                      softmax_regression, markov, categorical_nb, lstsq, simrank, merge_topn)
    sources = [m.SOURCE for m in kernel_modules]
    native.build_sources(sources)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for {sources}", flush=True)
    for s in sources:
        for line in native.build_log(s).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas[{s}]: {line.strip()}", flush=True)
    for m in kernel_modules:
        m.load_library()

    rng = np.random.default_rng(args.seed)
    print(f"phase kernels (at {time.perf_counter() - t0:.1f} s)", flush=True)
    max_err, rows = kernel_phase(rng, device)
    print(f"phase retrieval kernels (R1) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    ret_errs, _ = retrieval_kernel_phase(rng, device)
    print(f"phase train (at {time.perf_counter() - t0:.1f} s)", flush=True)
    model, kernels, f32_stats = train_phase(rng, device)
    print(f"phase bf16 kernels and training (3h) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    h_errs = {}
    check_bf16_sizes(rng, device, h_errs)
    h_counts, h_path_errs, h_stats, bf16_arrays = bf16_train_phase(device, f32_stats)
    print(f"phase checkpoint/resume (3c) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    checkpoint_phase(device, model, bf16_arrays)
    print(f"phase delta retraining (3r) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    check_k8_sizes(rng, device)
    r_counts, r_errs, r_stats = delta_phase(device)
    print(f"phase implicit train (at {time.perf_counter() - t0:.1f} s)", flush=True)
    i_counts, i_errs, i_stats, i_model = implicit_train_phase(rng, device)
    print(f"phase subspace train (3p) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    k11_errs = {}
    check_k11_sizes(rng, device, k11_errs)
    p_counts, p_errs, p_stats, p_model = subspace_train_phase(rng, device)
    print(f"phase similar product train (at {time.perf_counter() - t0:.1f} s)", flush=True)
    sp_counts, host_counts, sp_errs, sp_stats, (sp_td, sp_queries, sp_model) = sp_train_phase(
        rng, device)
    print(f"phase dimsum (3d) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    d_counts, d_errs, d_stats = dimsum_phase(device, sp_td, sp_queries)
    print(f"phase grid evaluation (3e) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    e_errs = {}
    check_k13_sizes(rng, device, e_errs)
    e_counts, e_path_errs, e_stats, td0 = eval_phase(device)
    print(f"phase bf16 grid (3h) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    g_counts, g_errs, g_stats = bf16_grid_phase(device, td0)
    print(f"phase training on a mesh (3t) (at {time.perf_counter() - t0:.1f} s)", flush=True)
    t_counts, t_errs, t_stats = mesh_train_phase(rng, device, {
        "model": model, "f32_stats": f32_stats, "implicit": i_model, "implicit_stats": i_stats,
        "bf16": bf16_arrays, "subspace": p_model, "sp": (sp_td, sp_model), "td0": td0})
    del td0, sp_td, sp_model, bf16_arrays, i_model, p_model
    print(f"phase slice (at {time.perf_counter() - t0:.1f} s)", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        launches, _, traffic = slice_phase(rng, device, workdir, model)
        print(f"phase quantized recommendation (R2) (at {time.perf_counter() - t0:.1f} s)",
              flush=True)
        q_launches, _, path_row, path_errs, q_served = quantized_serving_phase(
            rng, device, workdir, model, traffic)
        print(f"phase similar product (R3) (at {time.perf_counter() - t0:.1f} s)", flush=True)
        sp_launches, _, sp_deploy = similarproduct_phase(rng, device, workdir, model)
        print(f"phase serving on a mesh (3m) (at {time.perf_counter() - t0:.1f} s)", flush=True)
        m_counts, m_errs, m_stats = mesh_phase(rng, device, workdir, model, traffic,
                                               q_served, sp_deploy)
        print(f"phase classification (3n) (at {time.perf_counter() - t0:.1f} s)", flush=True)
        n_counts, n_errs, n_stats, n_refs = classification_phase(device, workdir)
        print(f"phase e2 and least squares (3x) (at {time.perf_counter() - t0:.1f} s)",
              flush=True)
        x_counts, x_errs, x_stats, x_refs = experimental_phase(device, workdir)
        print(f"phase classification and e2 on a mesh (3k) (at {time.perf_counter() - t0:.1f} s)",
              flush=True)
        k_counts, k_errs, k_stats = mesh_e2_phase(device, workdir, n_refs, x_refs)
        del n_refs, x_refs
        print(f"phase SimRank, K3c and the templates (3y) (at {time.perf_counter() - t0:.1f} s)",
              flush=True)
        y_counts, y_errs, y_stats = phase_3y(device, workdir, model, rows)

    full = rows[2]  # B=128, n=16: the full-width batch at num=10
    kernels += [{
        "name": "topn_packed",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topn.cu",
        "replaces": "predictionio_tpu/ops/als.py:2354",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": full["library_ms"],
    }]
    # this slice's kernels: launches summed over the three retriever
    # paths (each counted from 0), times at the int8 path's shape, errors
    # the largest over R1's shapes and R2's
    replaces = {
        "candidate_mask": ("masked_topn.cu", "predictionio_tpu/ops/retrieval.py:164"),
        "masked_topn": ("masked_topn.cu", "predictionio_tpu/ops/retrieval.py:280"),
        "rescore_topn": ("rescore.cu", "predictionio_tpu/ops/retrieval.py:316"),
    }
    for name, (source, where) in replaces.items():
        n_launch = q_launches["int8"][name] + q_launches["bf16"][name] + sp_launches[name]
        if n_launch < 1:
            raise AssertionError(f"{name} never launched on the retriever paths")
        t = path_row[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"predictionio_tpu_torch/csrc/{source}", "replaces": where,
            "launches": n_launch, "max_abs_err": max(ret_errs[name], path_errs[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
    # K1 and K2 on every training path; K12 on the implicit ones (each
    # path's counts from 0); K14 on the Similar Product host path; 3h's
    # bf16 trainings launch K2 and K12a, never float32 K1 or K12b
    train_counts = [i_counts, p_counts, r_counts, h_counts] + list(sp_counts.values())
    for row in kernels:
        if row["name"] in ("normal_eq", "spd_solve"):
            row["launches"] += sum(c[row["name"]] for c in train_counts)
            row["max_abs_err"] = max(row["max_abs_err"], i_errs[row["name"]], sp_errs[row["name"]])
    for name, where in (("gramian", "predictionio_tpu/ops/als.py:742"),
                        ("implicit_objective", "predictionio_tpu/ops/als.py:752")):
        kernels.append({
            "name": name, "route": "cuda", "source": "predictionio_tpu_torch/csrc/gramian.cu",
            "replaces": where, "launches": sum(c[name] for c in train_counts),
            "max_abs_err": max(i_errs[name], sp_errs[name]), "ms": i_stats["kernel_ms"][name]["user"],
            "plain_ms": i_stats["plain_ms"][f"{name}_user" if name == "gramian" else name],
            "bound_ms": i_stats["bound"][name]["user"][0],
            "bound_by": i_stats["bound"][name]["user"][1],
            "library_ms": i_stats["library_ms"].get(f"{name}_user"),
        })
    t14 = sp_stats["cosine_sum"]
    kernels.append({
        "name": "cosine_sum", "route": "cuda", "source": "predictionio_tpu_torch/csrc/cosine_sum.cu",
        "replaces": "predictionio_tpu/ops/similarity.py:63", "launches": sum(c["cosine_sum"] for c in host_counts.values()),
        "max_abs_err": sp_errs["cosine_sum"], "ms": t14["ms"], "plain_ms": t14["plain_ms"],
        "bound_ms": t14["bound"][0], "bound_by": t14["bound"][1], "library_ms": t14["library_ms"],
    })
    # this slice's kernels: K11 on the subspace path (3p; errors the
    # largest over 3p and the small shapes), K19 on DIMSUM's (3d, both
    # thresholds)
    for name in ("subspace_accumulate", "subspace_block_solve"):
        kernels.append({
            "name": name, "route": "cuda", "source": "predictionio_tpu_torch/csrc/subspace.cu",
            "replaces": "predictionio_tpu/ops/als.py:640", "launches": p_counts[name],
            "max_abs_err": max(p_errs[name], k11_errs[name]),
            "ms": p_stats["kernel_ms"][name]["user"],
            "plain_ms": p_stats["plain_ms"][f"{name}_user"],
            "bound_ms": p_stats["bound"][name]["user"][0],
            "bound_by": p_stats["bound"][name]["user"][1],
            "library_ms": p_stats["library_ms"].get(f"{name}_user"),
        })
    kernels[-2]["combine_launches"] = p_counts["subspace_combine"]
    for name in ("cooccur_counts", "cosine_from_counts"):
        kernels.append({
            "name": name, "route": "cuda", "source": "predictionio_tpu_torch/csrc/cooccurrence.cu",
            "replaces": "predictionio_tpu/models/similarproduct/engine.py:615",
            "launches": d_counts[name], "max_abs_err": d_errs[name],
            "ms": d_stats["kernel_ms"][name], "plain_ms": d_stats["plain_ms"][name],
            "bound_ms": d_stats["bound"][name][0], "bound_by": d_stats["bound"][name][1],
            # K19a: the dense binary Rb @ Rb.T; K19b: Rn @ Rn.T, the whole
            # function of the reference, K19a's share included
            "library_ms": d_stats["library_ms"][name],
        })
    # K13 on the grid evaluation's path (3e; errors the largest over 3e's
    # fold packs and the small shapes)
    for name in ("normal_eq_variants", "spd_solve_variants"):
        kernels.append({
            "name": name, "route": "cuda", "source": "predictionio_tpu_torch/csrc/grid.cu",
            "replaces": "predictionio_tpu/ops/als.py:942", "launches": e_counts[name],
            "max_abs_err": max(e_errs[name], e_path_errs[name]),
            "ms": e_stats["kernel_ms"][name], "plain_ms": e_stats["plain_ms"][name],
            "bound_ms": e_stats["bound"][name][0], "bound_by": e_stats["bound"][name][1],
            "library_ms": e_stats["library_ms"][name],
        })
    # K8 on the delta rounds' path (3r: launches over the two scatter
    # rounds, times at round 2's inputs); no one PyTorch call moves the
    # planes and appends the delta, so no library time
    for name in K8_NAMES:
        kernels.append({
            "name": name, "route": "cuda", "source": "predictionio_tpu_torch/csrc/delta_scatter.cu",
            "replaces": "predictionio_tpu/ops/streaming.py:1036", "launches": r_counts[name],
            "max_abs_err": r_errs[name], "ms": r_stats["kernel_ms"][name],
            "plain_ms": r_stats["plain_ms"][name], "bound_ms": r_stats["bound"][name][0],
            "bound_by": r_stats["bound"][name][1], "library_ms": None,
        })
    # the bf16 forms (3h): K1-bf16, K11a-bf16 and K12b-bf16 on the bf16
    # main paths (launches summed over them), times at sweep 4's user side;
    # K13a-bf16 on the bf16 grid's path, times at fold 0's user side, rank
    # 16; errors the largest over the random packs and the paths. No one
    # PyTorch call computes any of them (as for their float32 forms)
    errs_h = {n: max(h_errs.get(n, 0.0), h_path_errs.get(n, 0.0), g_errs.get(n, 0.0))
              for n in ("normal_eq_bf16", "subspace_accumulate_bf16", "implicit_objective_bf16",
                        "normal_eq_variants_bf16")}
    for name, source, where, stats_h, launched in (
            ("normal_eq_bf16", "normal_eq.cu", "predictionio_tpu/ops/als.py:481", h_stats,
             h_counts["normal_eq_bf16"]),
            ("subspace_accumulate_bf16", "subspace.cu", "predictionio_tpu/ops/als.py:640", h_stats,
             h_counts["subspace_accumulate_bf16"]),
            ("implicit_objective_bf16", "gramian.cu", "predictionio_tpu/ops/als.py:752", h_stats,
             h_counts["implicit_objective_bf16"]),
            ("normal_eq_variants_bf16", "grid.cu", "predictionio_tpu/ops/als.py:942", g_stats,
             g_counts["normal_eq_variants_bf16"])):
        ms, bnd = stats_h["kernel_ms"][name], stats_h["bound"][name]
        if isinstance(ms, dict):
            ms, bnd = ms["user"], bnd["user"]
        if launched < 1:
            raise AssertionError(f"{name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": where, "launches": launched, "max_abs_err": errs_h[name],
            "ms": ms, "plain_ms": stats_h["plain_ms"][name], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None,
        })
    # the classification template (3n): launches on its main path, times at
    # the reference's shape (K15a on the bench data, K15b at B = 2,048, K18
    # as one 200-step training); errors the largest over 3n's checks
    for name, where in (("naive_bayes_fit", "predictionio_tpu/ops/naive_bayes.py:56"),
                        ("naive_bayes_scores", "predictionio_tpu/ops/naive_bayes.py:73"),
                        ("softmax_regression",
                         "predictionio_tpu/models/classification/engine.py:231")):
        if n_counts[name] < 1:
            raise AssertionError(f"{name} never launched on its path")
        source = "naive_bayes.cu" if name.startswith("naive") else "softmax_regression.cu"
        kernels.append({
            "name": name, "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": where, "launches": n_counts[name], "max_abs_err": n_errs[name],
            "ms": n_stats["kernel_ms"][name], "plain_ms": n_stats["plain_ms"][name],
            "bound_ms": n_stats["bound"][name][0], "bound_by": n_stats["bound"][name][1],
            "library_ms": n_stats["library_ms"][name],
        })
    # the e2 library and the least-squares templates (3x): launches on their
    # main paths (lsq over the stock backtest and the regression template),
    # times at the paths' shapes (lsq at K22's 200,000 x 10; K21's shape in
    # the phase's stock line), errors the largest over 3x's checks
    rows_3x = (
        ("markov_step", "markov.cu", "predictionio_tpu/e2/markov_chain.py:127", x_stats["markov"]),
        ("cnb_count", "categorical_nb.cu", "predictionio_tpu/e2/naive_bayes.py:49",
         x_stats["cnb"]),
        ("cnb_scores_argmax", "categorical_nb.cu", "predictionio_tpu/e2/naive_bayes.py:160",
         x_stats["cnb"]),
        ("lsq", "lstsq.cu", "predictionio_tpu/models/experimental/stock.py:325",
         x_stats["regression"]),
    )
    for name, source, where, st in rows_3x:
        if x_counts[name] < 1:
            raise AssertionError(f"{name} never launched on its path")
        pick = (lambda v: v[name]) if name.startswith("cnb") else (lambda v: v)
        row = {
            "name": name, "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": where, "launches": x_counts[name], "max_abs_err": x_errs[name],
        }
        if name == "lsq":
            row.update(ms=st["ms"], plain_ms=st["plain_ms"], bound_ms=st["bound"][0],
                       bound_by=st["bound"][1], library_ms=st["library_ms"],
                       also_replaces="predictionio_tpu/models/experimental/regression.py:139")
        else:
            row.update(ms=pick(st["kernel_ms"]), plain_ms=pick(st["plain_ms"]),
                       bound_ms=pick(st["bound"])[0], bound_by=pick(st["bound"])[1],
                       library_ms=pick(st["library_ms"]))
        kernels.append(row)
    # SimRank (3y): K20a and K20b launched on the three sources' main paths,
    # times at the Wiki-Vote-sized graph's 5th iteration; K3c launched by
    # both measure_compute_ms calls, its ms the bench call's per-pass time
    # (its bound and library call K3's at that shape, per pass)
    sr = y_stats["simrank"]
    for name in ("simrank_propagate", "simrank_contract"):
        if y_counts[name] < 1:
            raise AssertionError(f"{name} never launched on its path")
        t = sr[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "predictionio_tpu_torch/csrc/simrank.cu",
            "replaces": "predictionio_tpu/models/experimental/friend_recommendation.py:433",
            "launches": y_counts[name], "max_abs_err": y_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": (t["library_sparse_ms"] if t["library_sparse_ms"] is not None
                           else t["library_dense_ms"]),
            "library_dense_ms": t["library_dense_ms"], "device_ms": t["device_ms"],
        })
    c3 = y_stats["k3c"]["bench call"]
    kernels.append({
        "name": "topn_chain", "route": "cuda", "source": "predictionio_tpu_torch/csrc/topn.cu",
        "replaces": "predictionio_tpu/ops/als.py:2382", "launches": y_counts["topn_chain"],
        "max_abs_err": y_errs["topn_chain"], "ms": c3["measure_compute_ms"],
        "plain_ms": c3["plain_ms"], "bound_ms": c3["bound"][0], "bound_by": c3["bound"][1],
        "library_ms": c3["library_ms"],
    })
    # serving on a mesh (3m): launches on its main path (the HTTP
    # deployments over --serving-devices and the host path), times on the
    # 4-shard mesh of the one card (the shards run one after another)
    lg = m_stats["logical"]
    k3s = lg["k3s"][-1]  # B = 128
    if m_counts["ml20m_trained"]["topn_packed"] < 1:
        raise AssertionError("K3s never launched on the mesh deployment")
    kernels.append({
        "name": "topn_packed_sharded", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topn.cu",
        "replaces": "predictionio_tpu/ops/als.py:2369",
        "launches": m_counts["ml20m_trained"]["topn_packed"], "max_abs_err": 0.0,
        "ms": k3s["k3s_ms"], "plain_ms": k3s["plain_ms"], "bound_ms": k3s["bound"][0],
        "bound_by": k3s["bound"][1], "library_ms": k3s["library_ms"],
        "device_ms": k3s["k3s_device_ms"], "one_device_ms": k3s["k3_ms"],
    })
    # the row-shard forms count under their kernels' names: on these
    # deployments every launch of them is one shard's
    for name, counter, source, where in (
            ("candidate_mask_shard", "candidate_mask", "masked_topn.cu",
             "predictionio_tpu/ops/retrieval.py:397"),
            ("masked_topn_shard", "masked_topn", "masked_topn.cu",
             "predictionio_tpu/ops/retrieval.py:397"),
            ("rescore_topn_shard", "rescore_topn", "rescore.cu",
             "predictionio_tpu/ops/retrieval.py:366"),
            ("merge_topn", "merge_topn", "merge_topn.cu", "predictionio_tpu/ops/retrieval.py:425")):
        n_launch = m_counts["ml20m_int8"][counter] + m_counts["ml20m_similar"][counter]
        if n_launch < 1:
            raise AssertionError(f"{name} never launched on the mesh deployments")
        t = lg["k10s"]["int8"]["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": where, "launches": n_launch, "max_abs_err": m_errs.get(name, 0.0),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        })
    t14s = lg["k14s"]
    if m_counts["host_path"]["cosine_sum"] < 1:
        raise AssertionError("K14s never launched on the mesh host path")
    kernels.append({
        "name": "cosine_sum_sharded", "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/cosine_sum.cu",
        "replaces": "predictionio_tpu/ops/similarity.py:63",
        "launches": m_counts["host_path"]["cosine_sum"],
        "max_abs_err": m_errs["cosine_sum_sharded"], "ms": t14s["ms"],
        "plain_ms": t14s["plain_ms"], "bound_ms": t14s["bound"][0],
        "bound_by": t14s["bound"][1], "library_ms": t14s["library_ms"],
    })
    # training on a mesh (3t): the row-shard forms' launches on their main
    # paths (K1 and K2 on Engine.train's; K12b on the implicit form's; K11
    # on the iALS++ form's; K13 on run_evaluation's), times of the shards'
    # launches of one user half-step together (4 logical shards of the
    # card, one after another) beside the whole side's bound
    tl, tk, tb = t_stats["launches"], t_stats["kernel_ms"], t_stats["bound"]
    for name, counter, form, source, where, kid, lib in (
            ("normal_eq", "normal_eq", "main", "normal_eq.cu", ":883", "K6s", None),
            ("spd_solve", "spd_solve", "main", "spd_solve.cu", ":883", "K6s",
             f32_stats["library_ms"]["spd_solve_user"]),
            ("implicit_objective_shard", "implicit_objective_shard", "implicit (3i)", "gramian.cu",
             ":908", "K6s", None),
            ("subspace_accumulate", "subspace_accumulate", "iALS++ (3p)", "subspace.cu", ":887",
             "K6s", None),
            ("subspace_block_solve", "subspace_block_solve", "iALS++ (3p)", "subspace.cu", ":887",
             "K6s", p_stats["library_ms"].get("subspace_block_solve_user")),
            ("normal_eq_variants", "normal_eq_variants", "run_evaluation", "grid.cu", ":999",
             "K13s", None),
            ("spd_solve_variants", "spd_solve_variants", "run_evaluation", "grid.cu", ":999",
             "K13s", e_stats["library_ms"]["spd_solve_variants"])):
        if tl[form][counter] < 1:
            raise AssertionError(f"{name} never launched on a shard in 3t's {form}")
        t = tk[name]
        kernels.append({
            "name": f"{name}_sharded" if not name.endswith("_shard") else f"{name}ed",
            "id": kid, "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": f"predictionio_tpu/ops/als.py{where}", "launches": tl[form][counter],
            "max_abs_err": t_errs.get(f"{name}_shard", t_errs.get(name, 0.0)),
            "ms": t["shards_ms"], "plain_ms": t["plain_shards_ms"],
            "bound_ms": tb[name][0], "bound_by": tb[name][1], "library_ms": lib,
            "device_ms": t["shards_device_ms"], "one_device_ms": t["one_device_ms"],
        })
    # classification and the e2 models on a mesh (3k): the shard forms'
    # launches on their main paths (K15s's fit on Engine.train's, its scores
    # on predict_naive_bayes(mesh=)'s, K17s on CategoricalNaiveBayes.train's,
    # K16s over the 100 predicts), times of the shards' launches together
    # with the finish (4 logical shards of the card, one after another)
    # beside the whole work's bound and the library call on every shard
    for name, kid, path, counter, finish, source, where in (
            ("naive_bayes_fit_sharded", "K15s", "Engine.train", "naive_bayes_fit",
             None, "naive_bayes.cu", "predictionio_tpu/ops/naive_bayes.py:103"),
            ("naive_bayes_scores_sharded", "K15s", "predict_naive_bayes", "naive_bayes_scores",
             None, "naive_bayes.cu", "predictionio_tpu/ops/naive_bayes.py:144"),
            ("cnb_count_sharded", "K17s", "CategoricalNaiveBayes.train", "cnb_count_shard",
             "cnb_count_finish", "categorical_nb.cu", "predictionio_tpu/e2/naive_bayes.py:208"),
            ("markov_step_sharded", "K16s", "MarkovChainModel.predict", "markov_step_shard",
             "markov_step_finish", "markov.cu", "predictionio_tpu/e2/markov_chain.py:83")):
        counted = k_counts[path]
        if counted.get(counter, 0) < 1:
            raise AssertionError(f"{name} never launched on 3k's {path}")
        t = k_stats["kernel_ms"][name]
        row = {
            "name": name, "id": kid,
            "route": "cuda", "source": f"predictionio_tpu_torch/csrc/{source}",
            "replaces": where, "launches": counted[counter], "max_abs_err": k_errs[name],
            "ms": t["shards_ms"], "plain_ms": t["plain_shards_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_shards_ms"],
            "device_ms": t["shards_device_ms"], "one_device_ms": t["one_device_ms"],
            "per_shard_ms": t["per_shard_ms"],
        }
        if finish is not None:
            row["finish_launches"] = counted[finish]
        kernels.append(row)
    print(f"phases done (at {time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
