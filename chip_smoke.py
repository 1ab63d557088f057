#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neurec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

from the root of a checkout, on a machine with a CUDA device. Phases (any
failure exits non-zero before the result line):

1. device and build: prints the card's name and power limit, builds every
   kernel from ``neurec_tpu_torch/csrc`` (nvcc, one process per source, all
   at once, into ``build/neurec_tpu_torch``);
2. LightGCN serving set-up at the north-star configuration: gowalla
   (``dataset/gowalla.rating``, ratio 0.8 split cached under
   ``dataset/_tmp_gowalla``), embed_size 64, 3 layers, adj_type pre, top-20
   Recall/NDCG, eval batch 2048; random weights from a numpy seed;
3. kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them, with time, roofline bound, plain-version time
   and a library call's time: K1 in both mask modes, K2 over the plan of A
   (forward) and of A^T (``plan_spmm[bwd]``), in f32 and bf16. K1's records
   also carry its device time, its tensor-core bound (three TF32 products,
   or the bytes) beside the f32 bound (``bound_f32_ms``), its largest error
   scaled by |u_b| |item_i| and each side's distance from the f64 product
   (the kernel's may be no larger), and the time of cuBLAS's product alone,
   without the mask (``matmul_ms``, ``matmul_device_ms``); the int8 row's
   library call builds its
   mask from the train rows as K1 does, and the record splits K1's mask
   build (``mask_build_ms``) from its launch (``kernel_ms``). K1 also runs
   at a ragged d and at a bit-plane width whose tiles straddle two planes
   (``phase: kernel_case``). A SpMM call
   is a few hundredths of a millisecond, so its records also carry the
   device time from ``torch.profiler`` (``phase: kernel_device``, by
   kernel), which a back-to-back loop paced by the host does not show,
   and the host's time to issue a call (``host_ms``);
   ``schedule_bytes`` and ``scratch_bytes`` are what the kernels move
   beyond the bound's bytes. K1 takes f32 FMAs up to d = 40 and the 3xTF32
   split above (``path``): on the f32 path each score must lie within
   d 2^-24 sum |u_k i_k| of the f64 product (``err_over_f32_bound`` <= 1),
   and its bound is the bytes or the f32 FMAs. Every f32-path K1 check is
   also held bit for bit to the fmaf chain a thread a score
   (``k1.fma_chain_scores``, with -inf where the plain version has it:
   ``chain_mismatches`` 0) and times K1, cuBLAS's product alone and matmul +
   ``where`` in turns, K1 first and last (``turns_ms``, ``k1_over_matmul``,
   ``phase: kernel_f32_path``). K1 also runs at d 40 on randn
   factors (``masked_scores[d40]``, the f32 path's edge, on no path). Before them,
   the skew of each plan (``phase: skew``: its tiles, the heaviest tile's
   and the heaviest warp's edges under a row-tile split with 16 warps
   owning ``row % 16``, and the spans of the edge-balanced schedule that
   K2 and K3 walk); after them, K2 and K3 on a power-law graph with a hub
   row cut across spans and on a ``NEUREC_SPMM_TILE=1024`` plan of the
   north star (``phase: kernel_case``): against their plain versions, the
   same bits twice, K3 == K2, and the tile-1024 plan == the tile-256 one.
   Last, the top-K at the evaluation shape (2048 x 38,546, k 20):
   ``ops/topk.py`` (``torch.topk`` and the tie fix-up) and the stable sort
   it replaced, timed in the same call, with equal ids and values, also on
   rows where ranks 10-39 are set to the 20th value (``phase: breakdown``);
4. the serving path, with every launch count set to 0 just before and
   read just after: full evaluation of every test user (twice: cold, then
   warm) and 4 ``batch_topk`` requests of 512 users (k=20, consumed items
   masked), plus a k-clamp request; then one evaluation on the ``pallas``
   tier (K1's int8 mode, ``NEUREC_EVAL_PREMASK=0``), counted apart. Every
   evaluation and export of every phase runs as CUDA graphs kept across
   calls (phase 34): an evaluator's first call of a program runs eagerly
   and captures it, later calls replay it, and each call counts a kernel's
   launches as an eager call does;
5. the same path through the plain versions: metrics within 1e-5 and
   top-20 ids agreeing in >= 99.9% of positions, near-ties the only
   difference;
6. the training path, counted the same way (every training phase runs
   its epochs' steps as CUDA-graph replays, phases 32-33; each replay adds
   the launches its graph took at capture): ``run.main`` trains the
   north star (batch 2048, lr 0.001, reg 1e-4, Adam) for 2 epochs with an
   evaluation after each, writing a checkpoint after each
   (``--ckpt_dir``, under ``build/ckpt``). It fails on a non-finite loss, an epoch-2 loss
   not below epoch 1's, a trained Recall@20 not above phase 4's random
   weights, K2 launch counts other than 3 forward + 3 backward per step
   and 3 forward per evaluation, or losses and Recall@20 more than
   ``RECORDED_RTOL`` from the values recorded with the row-owning kernels;
7. where a training step's time goes: CUDA-event times of the step, its
   forward, Adam and one step's negative draw (``--profile`` adds a
   ``torch.profiler`` table of device time per kernel);
8. 5 training steps from the trained state through the kernels and again
   through the plain versions, on the same draws: params within
   ``TRAIN_PARAM_ATOL``, step losses within ``TRAIN_LOSS_RTOL``;
9. path A, K3: the north star under ``NEUREC_SPMM_CHUNK=512`` and
   ``NEUREC_SPMM_PACK=2`` (``benchmarks/ab_spmm_epoch.py``'s
   ``chunk512_pack2``): K3 against its plain version (pack 2 and 4, f32
   and bf16, the same bits as K2), one full evaluation of phase 2's
   weights, ``run.main`` for 2 epochs; exactly 3 K3 forward per step and
   per evaluation, 3 K3 backward per step, no K2; the loss checks of phase
   6, losses and metrics equal to phase 6's digit for digit (the schedule
   does not depend on the chunk, and K3 sums in K2's order), and the 5
   steps of phase 8 against K3's plain version;
10. the other SpMM variants as paths of their own, each one evaluation and
   2 training steps from path A's trained state: pack 4, pack 2 in bf16,
   pack 4 in bf16, and K2 in bf16 (``NEUREC_SPMM_DTYPE=bf16``);
11. path B, NGCF at its published widths (Wang et al., SIGIR 2019,
   "Parameter Settings": embedding 64, layers [64, 64, 64], ``norm``
   adjacency, message dropout 0.1, batch 1024, lr 1e-4, reg 1e-5, Adam;
   no node dropout) on the same gowalla split: K1 at d = 256 and K3's
   backward over the non-symmetric ``plan_t`` against their plain
   versions, a full evaluation of random weights, ``run.main`` for
   ``NGCF_EPOCHS`` (5) epochs; 3 K2 forward and 3 K2 backward per step, 3
   K2 forward per evaluation; the loss checks (the first 2 epochs against
   the recorded losses), the trained model's evaluation through K1's plain
   version (metrics within ``NGCF_EVAL_ATOL``), the band check (the same
   ``run.main`` through K2's and K1's plain versions, on the same draws:
   Recall@20 and NDCG@20 after every epoch within ``NGCF_BAND``,
   ``phase: ngcf_band``), and 5 steps against the plain path, with the
   same seeded dropout draws;
12. K4, the copy-rate probe (``python -m neurec_tpu_torch.benchmarks.dma_rate``,
   65,536 offsets, repeat 8, 3 rounds), then each mode and size against its
   plain version: the rows written must be the same;
13. path C, NeuMF at the widths of ``conf/NeuMF.properties`` (embedding 16,
   layers [64, 32, 16], pointwise cross_entropy, num_neg 4, batch 256, Adam
   at lr 0.001) on the same split, through ``Trainer``: an MF at embedding
   16 and an MLP at ``conf/MLP.properties`` train ``PRETRAIN_STEPS`` steps
   each and are written with ``pretrain.save_pretrain`` (under
   ``build/pretrained``); NeuMF loads both ("load pretrained params
   successful!"), trains ``NEUMF_STEPS`` steps and evaluates all test users
   on the ``bits`` predict tier. It fails on a non-finite loss, a
   Recall@20 not above the same model's with random weights, or a chunked
   ``predict`` more than ``ATOL`` from an unchunked one;
14. path D, the other seven models at their ``conf/*.properties`` widths,
   each through ``Trainer`` for ``ZOO_STEPS`` steps and one evaluation:
   APR (K1 at d 64) and FISM (K1 at d 17, its bias folded in: the cp.async
   path) evaluate all test users with exactly one K1 launch a batch, again
   through K1's plain version (metrics within 1e-5), and K1 is held to
   its plain version at their own factors (FISM's a kernel record,
   ``masked_scores[d17]``); NAIS and DeepICF warm-start from FISM's
   pickle and evaluate all test users over their batches' train edges, a
   cold call (eager, then the captures) and a warm one (``edge_eval``:
   seconds, device ms, idle share, users/s, the capacity E_max against
   the batches' exact edge count, pool bytes; the warm metric string the
   cold one's); ConvNCF warm-starts from an MF's at embedding 64; it and
   DMF evaluate the first ``ZOO_EVAL_USERS`` test users;
15. ``run.main`` (``python -m neurec_tpu_torch.run``) on the card for each
   model of paths C to F (``RUN_MODELS``): one epoch (Pop and ItemKNN: none)
   and an evaluation at its ``conf/*.properties`` widths on a rating file
   made from the seed (``RUN_USERS`` x ``RUN_ITEMS``, under
   ``build/run_main``), then for each sequential model (``RUN_SEQ_MODELS``)
   on a timestamped one (``RUN_SEQ_USERS`` x ``RUN_SEQ_ITEMS``, under
   ``build/run_main_seq``), split by time (loo);
16. path E, the rest of the general zoo at their ``conf/*.properties``
   widths on the same split, each through ``Trainer``: Pop and ItemKNN
   evaluate only, WRMF takes 2 ALS epochs, MultiDAE, MultiVAE, DAE, CDAE,
   JCA, CFGAN and IRGAN the first ``ZOO_STEPS`` steps of an epoch (IRGAN's
   generator warm-started from an MF at 20 factors, written by
   ``save_pretrain`` in IRGAN's layout). The models K1 ranks (Pop at d 1,
   MultiDAE and MultiVAE at 33, CDAE at 65, WRMF at 16, IRGAN at 21)
   evaluate all test users with one K1 launch a batch, again through K1's
   plain version (metrics within 1e-5), and give K1's record at their
   width; ItemKNN, DAE, CFGAN (all users) and JCA (``ZOO_EVAL_USERS``) rank
   on the bits predict tier with no K1 launch. It fails on a non-finite
   loss, WRMF's epoch-2 loss not below epoch 1's, Pop's or WRMF's Recall@20
   not above phase 4's random weights', or IRGAN's warm start not logged;
17. path F, SpectralCF at its ``conf`` widths (embedding 100, 2 layers,
   BPR, batch 256) on a rating set made from the seed at ml-100k's shape
   (``ML_USERS`` x ``ML_ITEMS``, ``ML_RATINGS``, ratio 0.8 split, under
   ``build/ml100k_seeded``): ``ZOO_STEPS`` steps, a full evaluation through
   K1 at d 300 (one launch) and through K1's plain version (within 1e-5),
   and K1's record at that shape;
18. path G, the sequential family, on a timestamped rating set made from
   the seed at ml-1m's published shape (``ML1M_USERS`` x ``ML1M_ITEMS``,
   ``ML1M_RATINGS``, at least 20 a user; each user's items a Markov walk
   without repeats over seeded successors and a Zipf-like popularity;
   under ``build/ml1m_seeded``), split by time (loo): each model of
   ``SEQ_MODELS`` at its ``conf/*.properties`` widths through ``Trainer``
   for its cut, a full evaluation of the 6,040 test users, the step's
   device time from the profiler. The models K1 ranks (FPMC at d 32,
   Fossil 17, HRM 16, NPE 64, SASRec 50, Caser 100, GRU4Rec and GRU4RecPlus
   101) take one K1 launch a batch, give the same metrics through K1's
   plain version (within 1e-5) and top-20 ids agreeing in >= 99.9% of
   positions on the first batch, and K1's record at their width and the
   first batch's factors; FPMCplus, TransRec and SRGNN rank on the bits
   predict tier with no K1 launch. It fails on a non-finite loss, FPMC's
   (on its pairwise BPR form, see ``SEQ_MODELS``), SASRec's or GRU4Rec's
   Recall@20 not above its random weights', or a GRU4Rec pad step (no
   valid entry) that changes the params or Adam;
19. path H, the social family on the gowalla split, over a friendship
   graph made from the seed (``social_graph``: power-law degrees with
   SNAP loc-Gowalla's mean, capped at ``SOCIAL_MAX_DEGREE``, every edge
   both ways, under ``build/social``): SBPR and DiffNet at their
   ``conf/*.properties`` widths through ``Trainer``, each a full
   evaluation of random weights, ``SOCIAL_STEPS`` steps, a full evaluation
   with exactly one K1 launch (d 16) a batch, the same evaluation through
   K1's plain version (the same metric string, and the top-20 ids of every
   test user in every position), K1 at the model's factors against its
   plain version, the step's device time from the profiler, SBPR's
   ``max_s`` and table bytes (equal to those reckoned from ``max_s``). It
   fails on a non-finite loss or SBPR's Recall@20 not above its random
   weights';
20. the sampled-candidates protocol: gowalla with ``rec.evaluate.neg=99``
   (the generation's seconds), the north star's trained LightGCN and path
   D's MF evaluated on each test user's positives and 99 negatives, and
   again with the same scores ranked on the host (the CPU path): metrics
   within 1e-6; no bits table built;
21. the streamed bits tier: ``NEUREC_EVAL_BITS_BUDGET`` one byte below the
   gowalla table, the trained LightGCN evaluated twice (cold, warm) with
   one K1 launch a batch: the metric string and the top-20 ids of every
   batch identical to the resident table's;
22. path I, the Bloom sampler: a rating set at ml-10m's published shape
   (``ML10M_USERS`` x ``ML10M_ITEMS``, ``ML10M_RATINGS``, made on the card
   in memory, ``ml10m_seeded``), MF at its conf through ``Trainer`` on the
   pair Bloom filter (the padded table would be 2.06 GB): the epoch's
   pre-draw, ``BLOOM_STEPS`` steps, and every negative of the epoch
   checked on the card against the train CSR: the train positives among
   them at most the ``BLOOM_TAIL`` upper quantile of a Poisson at their
   expected count, sum over the draws of (d + 0.031)^R d / (d + 0.031);
23. checkpoint and resume: the north star through ``run.main`` for 1
   epoch into a second directory, then a fresh ``run.main`` resumes it to
   epoch 2 (``--ckpt_dir``; phase 6 is the uninterrupted run). The state
   restored must equal the params and Adam state saved at epoch 1 bit for
   bit, the resumed epoch-2 loss be within ``RECORDED_RTOL`` of phase 6's
   (the embedding gathers' backward adds in another order on the card),
   and a third ``run.main`` on phase 6's finished directory must log the
   final-epoch line with phase 6's metric string, character for character
   (K1 and the top-K are deterministic). It prints a checkpoint's bytes and
   the save and restore seconds, and each run's launches (K1 one a batch,
   K2 3 forward a step and an evaluation, 3 backward a step);
24. the device trace: the resumed run above ran with ``--trace_dir``
   (``build/trace``); the Chrome trace is parsed and its kernel events of
   K1, K2 and K2 backward counted against the run's launch counts (a
   replayed step's K2 kernels, launched by a ``cudaGraphLaunch``, are
   forward and backward alike: counted together, ``plan_spmm[replayed]``,
   against the forward and backward launches). A trace
   with no kernel event fails; a shortfall (the profiler can lose kernel
   records) is printed as ``dropped``, with the trace's bytes;
25. the native host backend: the trained north star evaluated over every
   test user with ``eval_backend=native`` (``num_thread`` 8: the scores
   from ``predict`` on the card, ranked on the host's C++ thread pool) and
   with the device backend (K1): every metric within 1e-5, ``eval_s`` of
   both and the bytes copied to the host;
26. the exact segment top-K (``benchmarks/topk_ab.py``): ``top_k``,
   ``exact_topk_indices`` and a row-max read on one evaluation batch
   (2048 x 38,546) of randn scores and of K1's masked scores of the
   trained north star, at K 20 and 50: the ids equal to ``top_k``'s
   wherever the overflow is 0 (an overflow is printed), ms and device ms;
27. ``mesh1``: the north star through ``run.main`` inside a one-rank NCCL
   group on a (1, 1) mesh, as on a machine with a card a rank: its losses,
   metric string and K1 / K2 launches equal phase 6's;
28. ``dp2``: two ranks (``mesh_rank``, spawned; a free port, a timeout)
   share the card through gloo, which stages the collectives through the
   host; on a (2, 1) mesh LightGCN at the north star with
   ``graph_shard=on`` takes ``MESH_STEPS`` steps and one evaluation
   (``bits_dp``), held to a one-rank run on the same draws (params within
   1e-5, losses 1e-4, the metric string equal, metrics within 1e-6) and to
   the replicated tier on rank 0's params (the string equal); every K2
   launch has the block's rows, every K2 backward the graph's, every K1
   the rank's half of a batch. Two ranks on one card measure no
   multi-device speed;
29. ``itemshard2``: the same ranks on a (1, 2) mesh, ``eval_item_shard=on``,
   premask auto (``item_shard_bits``: K1 on a rank's 19,456 items against
   its own per-block table) and 0 (``item_shard_rows``: K1's int8 mask):
   the strings and every test user's top-20 ids equal the replicated
   tier's. Then K1 at a rank's rows (1,024 x 38,546) and item block
   (2,048 x 19,456) and K2 both ways on a block plan against their plain
   versions, timed as in phase 3 (``masked_scores[dp]``,
   ``masked_scores[block]``, ``plan_spmm[block]``,
   ``plan_spmm[bwd,block]``);
30. ``tp2``: two ranks (``tp_rank``, spawned as in phase 28) on a (1, 2)
   mesh, where the trainer row-shards every id table over 'model': each
   rank holds 14,929 of ``user_emb``'s 29,858 rows and 19,273 of
   ``item_emb``'s 38,546 (``parallel/tables.py``: ID-partitioned lookups,
   the whole tables gathered for the propagation and the scores).
   LightGCN at the north star with ``graph_shard=off`` takes
   ``MESH_STEPS`` steps and two evaluations (``eval_item_shard`` auto:
   ``bits_dp`` on the whole table; on: ``item_shard_bits``), and MF at
   ``conf/MF.properties`` (``tp2_mf``: the lookups alone) its steps and one
   evaluation. Each is held to a one-rank run on the same draws (params
   gathered within 1e-5, losses 1e-4, every metric string equal); each
   rank's K2 and K2 backward launches over the whole graph equal the
   one-rank run's, K1 runs once an evaluation batch, and a rank's bytes of
   params and of Adam moments are half the one-rank run's (printed beside
   them);
31. ``dp2_custom``: two ranks (``custom_rank``, spawned as in phase 28) on
   a (2, 1) mesh, where every step of the custom epochs is split over
   'data': SBPR (over path H's friendship graph) and Caser (on path G's
   ml-1m-shaped set) take ``MESH_STEPS`` steps, SRGNN (path G's set), JCA,
   CFGAN's D and G sub-epochs and IRGAN's D and G passes (gowalla, IRGAN
   warm-started from path E's generator) ``CUSTOM_STEPS`` steps of each
   pass, at their ``conf/*.properties`` widths, then one evaluation (JCA
   2,048 users). Each is held to a one-rank run on the same draws
   (``custom_run``): the epoch loss within 1e-5 (relative), the params
   within 1e-5 and the two ranks' equal, the metric string equal, and each
   rank's loss methods fed half the one-rank run's rows. K1 runs once an
   evaluation batch at the rank's 1,024 rows for SBPR (d 16), IRGAN (d 21)
   and Caser (d 100), never for the predict-tier models; then K1 at those
   shapes on the trained factors against its plain version, timed as in
   phase 3 (``masked_scores[d16,dp]``, ``[d21,dp]``, ``[d100,dp]``);
32. ``graph``: every phase that trains runs the built-in epochs' steps
   as CUDA-graph replays (``Trainer``'s default; ``step_graph.py``), and
   beside each path's trainer (``graph_vs_eager``, a ``graph_check`` line
   each) ``KEPT_CALLS`` (3) epoch calls of the same steps (call ``c``
   rotated by ``c`` steps, as epoch ``c + 1``) run eagerly
   (``Trainer(graphs=False)``), twice, and through the trainer's kept
   program (``step_graph.KeptSteps``: captured at the first call,
   replayed at the later ones), from copies of one state: the north star
   ``GRAPH_NORTHSTAR_STEPS`` (50) steps of epoch 3's draws at
   ``scan_unroll`` 1 and 8, with each run's ms a step past the first (CUDA
   events around steps 1..49 of its first call: the eager steps, or the
   replays), its ms a step over the later calls' replays, its device ms a
   step from the profiler (``GRAPH_SHORT_STEPS`` steps) and the card's
   idle share; NGCF at path B's widths (message dropout 0.1) 20 steps and
   path A (K3, pack 2) 10, the same way; every other built-in-epoch model
   (paths C-H: MF, MLP, NeuMF, APR, FISM, NAIS, DeepICF, ConvNCF, DMF,
   MultiDAE, MultiVAE, DAE, CDAE, SpectralCF, FPMC, FPMCplus, Fossil, HRM,
   NPE, TransRec, DiffNet) ``GRAPH_ZOO_STEPS`` (5) at its ``conf`` widths
   on its path's data at ``scan_unroll`` 3. Where the steps do not divide
   by ``scan_unroll`` the first call captures the graph of ``scan_unroll``
   steps, its own remainder and a later call's (the zoo: 3, 1 and 2; the
   north star at 8: 8, 1 and 2), and the later calls replay the graphs of
   3 and 2 (8 and 2), out of their capture order. A kept run's epoch
   losses, params and optimizer state must equal the eager run's bit for
   bit, or, where the two eager runs differ too, lie within 1e-6; its
   second and third calls capture no graph (each call's graphs captured,
   the step counts of the graphs held, wall ms a step and pool bytes are
   printed); K2
   (K3 on path A) runs 3 forward and 3 backward a step in every call. APR
   also runs its kept program with ``adv_epoch`` 2 and again without the
   adversarial term: the first call's losses equal, the later calls'
   differ. The summary line ``phase: graph`` names the 23 models checked.
   ``kept_train``: the north star at full width through ``Trainer.train``,
   ``KEPT_TRAIN_EPOCHS`` (3) whole epochs, twice from one seed: each
   epoch's wall ms a step, graphs captured (none past epoch 1) and loss,
   then, under the profiler, its device ms a step, and the idle share of
   the unprofiled epoch;
33. ``graph_custom``: every phase that trains a custom epoch runs its
   steps as CUDA-graph replays too (SBPR, SASRec, Caser, SRGNN, GRU4Rec,
   GRU4RecPlus, JCA, CFGAN's sub-epochs, IRGAN's D and G passes; WRMF's ALS
   epoch has no steps), and beside each such path's trainer
   (``custom_graph_check``, a ``graph_custom_check`` line each)
   ``KEPT_CALLS`` (3) calls of the epoch (epochs 2, 3 and 4), each cut to
   ``GRAPH_CUSTOM_STEPS`` (24) steps of each pass, run eagerly, twice, and
   through the trainer's kept programs (one a run of steps: the epoch's,
   or CFGAN's and IRGAN's D and G passes) at ``scan_unroll`` 1 and 3, from
   copies of one state, at the model's ``conf`` widths on its path's data
   (paths E, G and H). A kept run's losses, params and optimizer state
   must equal the eager run's bit for bit, or, where the two eager runs
   differ too, lie within 1e-6, and its second and third calls capture no
   graph where each pass takes the same steps in every call. Each call
   gives its graphs captured, wall ms a step and pool bytes; each run its
   ms a step past the first (CUDA events around the eager steps 1..n-1 or
   the replays, summed over the passes) and over the later calls'
   replays, the kept run the device ms a step and the kernels a step from
   the profiler, and each run its idle share.
   Phase 31's runs stay eager. The summary line ``phase: graph_custom``
   names the nine models checked;
34. ``eval_graph``: beside the north star's, path A's, path B's, path C's
   (NeuMF), NAIS's and DeepICF's (path D) and GRU4Rec's (path G) trainers
   (``eval_graph_check``, an ``eval_graph_check`` line each), the trained
   params evaluated by two fresh evaluators, ``graphs=False`` and the
   default (``step_graph.KeptProgram``: a prologue graph, the hoisted
   tables, and a body graph a batch), a cold and ``EVAL_GRAPH_WARM`` warm
   calls each: ``eval_cold_s`` and ``eval_warm_s``, the device ms of a warm
   call and the card's idle share over it (profiler), the kernels'
   launches a call (equal in both modes), the graph launches a warm call
   (one a batch plus the prologue, every model) and each program's pool
   bytes; the metric strings and every recorded top-K id must be equal.
   On the north star a warm replay also runs under
   ``torch.cuda.set_sync_debug_mode("error")``, and the phase-4 requests
   go through ``batch_topk`` both ways from an empty export cache
   (``serving_graph_check``: ``serving_request_s``, device ms, graph
   launches a request, pool bytes; the ids and scores equal); so does one
   request of 512 users to NAIS's export, made twice
   (``NAIS_SERVING_REQUESTS``: the second replays). The
   summary line ``phase: eval_graph`` gathers them. The captured calls'
   launches count in the kernels line (paths ``eval_graph_*``,
   ``serve_graph`` and ``serve_graph_nais``).

Cuts, against a real run: the north star and path A train 2 epochs (the
JAX record ran 120), path B 5; path C's MF and MLP train 200 steps and
NeuMF 300 (an epoch is 3,670); path D trains 20-100 steps of its models'
first epochs, and ConvNCF (32 users) and DMF (2,048) evaluate a subset
of the 14,821 test users (NAIS and DeepICF all of them); path E trains 59-200
steps (WRMF 2 of its 300 epochs) and JCA evaluates 2,048 users; path F
trains 100 of 315 steps of one epoch of its 300; path G trains 200-2,000
steps of epochs of thousands (SASRec 8 epochs of 48 steps; GRU4Rec's cut
in steps of its schedule); path H trains 300 steps of SBPR's 367 and of
DiffNet's 4,037 (of 500 and 300 epochs), on a seeded graph, not Ciao's;
path I trains 300 of MF's ~15,600 steps of one epoch, the pre-draw whole;
phase 31 trains 5-20 steps of each pass of one epoch, phase 33 24 of each
pass of epochs 2-4; phase 34 evaluates NeuMF's, NAIS's and DeepICF's first
4,096 test users (two batches of 2,048) and GRU4Rec's first 2,048
(``EVAL_GRAPH_USERS``).

Float32 matrix products run in full f32 (TF32 off) everywhere, as in the
JAX package on the CPU.

The last lines: ``{"kernels": [...]}`` (every kernel and variant, with the
``device_ms`` of the SpMM kernels and
``launches_by_path``), the ``nvidia-smi`` name/power-limit line, and
``{"ok": true, "device": {...}}``. ``run.main`` (phase 15) also runs
SBPR and DiffNet on the seeded rating file with a seeded friendship file.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import glob
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
PROPS = os.path.join(REPO, "NeuRec.properties")

# published H100 SXM peaks (NVIDIA data sheet), at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
# K1 forms each product from three TF32 products (a 3xTF32 split)
K1_TF32_PRODUCTS = 3
# the split keeps 22 of f32's 24 significand bits of each operand and drops
# lo * lo: each term of a score is off by at most 3 * 2^-22 of |u_k i_k|,
# and K1 adds the d terms in f32 (d * 2^-24 of sum |u_k i_k|)
K1_SPLIT_REL = 3 * 2.0 ** -22
# K1's f32 path (d <= 40): one fmaf chain a score, within d * 2^-24 of
# sum |u_k i_k| of the exact product
K1_F32_REL = 2.0 ** -24

SEED = 2024
EVAL_USERS_PER_BATCH = 2048
SERVING_REQUESTS, SERVING_USERS, SERVING_K = 4, 512, 20
# both sides compute in f32 with another summation order (d = 64 terms)
ATOL = RTOL = 1e-5

DATA_ARGS = [
    "--config_dir=%s" % os.path.join(REPO, "conf"),
    "--data.input.path=%s" % os.path.join(REPO, "dataset"),
    "--data.cache.path=%s" % os.path.join(REPO, "dataset"),
    "--data.input.dataset=gowalla",
    "--data.column.format=UI",
    "--data.convert.separator=','",
    "--splitter=ratio",
    "--ratio=0.8",
    "--by_time=False",
    "--topk=[20]",
    "--metric=[\"Recall\",\"NDCG\"]",
    "--test_batch_size=%d" % EVAL_USERS_PER_BATCH,
]
NORTHSTAR_ARGS = ["--recommender=LightGCN"] + DATA_ARGS + ["--embed_size=64", "--n_layers=3", "--adj_type=pre"]
# the north star's training hyperparameters (benchmarks/gowalla_northstar.py:34-37)
TRAIN_EPOCHS = 2
TRAIN_ARGS = NORTHSTAR_ARGS + [
    "--epochs=%d" % TRAIN_EPOCHS, "--verbose=1", "--learner=adam",
    "--batch_size=2048", "--lr=0.001", "--reg=1e-4",
]
PLAIN_STEPS = 5
# Kernel and plain SpMM sum in other orders, so the gradients differ by f32
# noise (~1e-7 relative). Adam passes it on as lr * d(g / (sqrt(v) + 1e-8)):
# ~1e-7 of a step where |g| >> 1e-8, at most ~1e-4 of a step (lr = 1e-3)
# where g is itself cancellation noise near 1e-8. Over 5 steps that stays
# below 1e-6; 1e-5 leaves room, and is still 1% of one Adam step.
TRAIN_PARAM_ATOL = 1e-5
TRAIN_LOSS_RTOL = 1e-5

# path A: the repo's lane-packed configuration (benchmarks/ab_spmm_epoch.py:34)
PACK2_ENV = {"NEUREC_SPMM_CHUNK": "512", "NEUREC_SPMM_PACK": "2"}
# the other variants: (path, NEUREC_SPMM_PACK, NEUREC_SPMM_DTYPE)
VARIANT_PATHS = (("pack4", "4", "f32"), ("pack2_bf16", "2", "bf16"),
                 ("pack4_bf16", "4", "bf16"), ("bf16", "1", "bf16"))
VARIANT_STEPS = 2
# bf16 features move the metrics by rounding, not by a fault
BF16_METRIC_ATOL = 1e-2
# the trained NGCF's evaluation through K1 and through its plain version:
# at d = 256 the two f32 orders differ by ~1e-6 of a score, which reorders
# near-ties at the 20th place of a few users (~1e-5 of Recall@20 each); a
# masking fault would move the metrics by orders of magnitude more
NGCF_EVAL_ATOL = 1e-3

# path B's band check: NGCF trained through the kernels and through their
# plain versions on the same draws, its Recall@20 and NDCG@20 after every
# epoch held to NGCF_BAND of each other. The band is twice the largest gap
# two runs showed (1.3e-3 of Recall@20, ~6% of it at epochs 3-5): f32
# rounding alone moves the trained metrics that far, since the plain
# path's index_add_ sums in another order on every run (its own two runs
# were 6.7e-4 apart) while the kernels give the same bits each time; a
# masking or SpMM fault moves them by ~2e-2
NGCF_EPOCHS = 5
NGCF_BAND = 2.5e-3
# path B: NGCF's published settings (Wang et al., SIGIR 2019, "Parameter Settings")
NGCF_ARGS = ["--recommender=NGCF"] + DATA_ARGS + [
    "--embedding_size=64", "--layer_size=[64,64,64]", "--adj_type=norm", "--alg_type=ngcf",
    "--mess_dropout_ratio=0.1", "--node_dropout_flag=False",
]
NGCF_TRAIN_ARGS = NGCF_ARGS + [
    "--epochs=%d" % NGCF_EPOCHS, "--verbose=1", "--learner=adam",
    "--batch_size=1024", "--learning_rate=0.0001", "--reg=1e-5",
]

PROBE_N, PROBE_REPEAT, PROBE_ROUNDS = 65536, 8, 3


# path C: NeuMF at conf/NeuMF.properties (embedding 16, layers [64, 32, 16],
# pointwise cross_entropy, num_neg 4, batch 256, Adam at lr 0.001), warm-started
# from an MF at embedding 16 and an MLP at conf/MLP.properties, each trained
# PRETRAIN_STEPS steps; NeuMF then trains NEUMF_STEPS of its 3,670 a epoch
PRETRAIN_STEPS = 200
NEUMF_STEPS = 300
# users of the chunked-against-unchunked predict check
CHUNK_CHECK_USERS = 8
# path D: the other models at their conf/*.properties, each for a few steps
# of its first epoch; ConvNCF and DMF evaluate the first ZOO_EVAL_USERS
# test users (their predict is per pair: ConvNCF ~3 MFLOP a pair); NAIS and
# DeepICF evaluate all 14,821 over their batches' train edges
# path E: the rest of the general zoo at their conf/*.properties, a few steps
# each (None: the whole epoch; each pass of a custom epoch is cut alike:
# CFGAN's D and G sub-epochs, IRGAN's D batches and G users); WRMF takes 2
# whole ALS epochs, Pop and ItemKNN train nothing; JCA evaluates the first
# 2,048 test users (its predict runs the (I, U) item decoder every batch)
ZOO_STEPS = {"APR": 50, "FISM": 100, "NAIS": 30, "DeepICF": 30, "MF": 50, "ConvNCF": 20, "DMF": 20,
             "MultiDAE": 59, "MultiVAE": 59, "DAE": 117, "CDAE": 100, "JCA": 100, "CFGAN": 100, "IRGAN": 200,
             "SpectralCF": 100}
ZOO_EVAL_USERS = {"ConvNCF": 32, "DMF": 2048, "JCA": 2048}
# (model, K1 record at its width, epochs) of the path-E models K1 ranks; the
# others rank on the bits predict tier
E_FACTORIZED = (("Pop", "masked_scores[d1]", 1), ("MultiDAE", "masked_scores[d33]", 1), ("MultiVAE", None, 1),
                ("CDAE", "masked_scores[d65]", 1), ("WRMF", "masked_scores[d16]", 2),
                ("IRGAN", "masked_scores[d21]", 1))
E_PREDICT = ("ItemKNN", "DAE", "JCA", "CFGAN")
# IRGAN's generator warm-starts from an MF at its conf's 20 factors
IRGAN_FACTORS = 20
# K1's f32 path at its widest d, on randn factors: a record on no path
K1_EDGE_D = 40
# path F: a rating set at ml-100k's published shape (GroupLens MovieLens 100K:
# 943 users, 1,682 items, 100,000 ratings), made from the seed; gowalla's
# 68,404 nodes are past SpectralCF's 20,000-node eigendecomposition guard
ML_USERS, ML_ITEMS, ML_RATINGS = 943, 1682, 100_000
ML_DIR = os.path.join(REPO, "build", "ml100k_seeded")
ML_ARGS = [
    "--config_dir=%s" % os.path.join(REPO, "conf"), "--data.input.path=%s" % ML_DIR,
    "--data.cache.path=%s" % ML_DIR, "--data.input.dataset=ml100k_seeded", "--data.column.format=UIR",
    "--data.convert.separator=','", "--splitter=ratio", "--ratio=0.8", "--by_time=False", "--topk=[20]",
    "--metric=[\"Recall\",\"NDCG\"]", "--test_batch_size=%d" % EVAL_USERS_PER_BATCH,
]
# the run entry point for each model of paths C to F, one epoch at its
# conf/*.properties widths on a rating file made from the seed (an epoch of
# gowalla is 3,670 steps for the pointwise models)
RUN_MODELS = ("MLP", "NeuMF", "APR", "FISM", "NAIS", "DeepICF", "DMF", "ConvNCF", "Pop", "ItemKNN", "MultiDAE",
              "MultiVAE", "DAE", "CDAE", "SpectralCF", "WRMF", "JCA", "CFGAN", "IRGAN")
RUN_USERS, RUN_ITEMS = 300, 400

# path G: a timestamped rating set at ml-1m's published shape (GroupLens
# MovieLens 1M: 6,040 users, 3,706 rated items, 1,000,209 ratings, at least
# 20 a user; the data of the SASRec and Caser papers), made from the seed.
# Each user's items are a Markov walk without repeats: every item has
# ML1M_SUCCESSORS seeded successors, one taken with probability
# ML1M_FOLLOW, else an item drawn by a Zipf-like popularity (rank^-ML1M_ZIPF)
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS, ML1M_MIN_PER_USER = 6040, 3706, 1_000_209, 20
ML1M_MAX_PER_USER = 2314  # ml-1m's most active user
ML1M_SUCCESSORS, ML1M_FOLLOW, ML1M_ZIPF = 4, 0.5, 0.9
ML1M_DIR = os.path.join(REPO, "build", "ml1m_seeded")
ML1M_ARGS = [
    "--config_dir=%s" % os.path.join(REPO, "conf"), "--data.input.path=%s" % ML1M_DIR,
    "--data.cache.path=%s" % ML1M_DIR, "--data.input.dataset=ml1m_seeded", "--data.column.format=UIRT",
    "--data.convert.separator=','", "--splitter=loo", "--by_time=True", "--user_min=0", "--item_min=0",
    "--topk=[20]", "--metric=[\"Recall\",\"NDCG\"]", "--test_batch_size=%d" % EVAL_USERS_PER_BATCH,
]
# each sequential model at its conf/*.properties widths on path G: (path,
# model, flags over its conf, steps of an epoch, epochs, K1's
# record at its evaluation width (None: the predict tier), whether its
# Recall@20 must beat its random weights'). FPMC's conf (pointwise, the mean
# cross-entropy against reg_mf 0.01 summed over the batch's lookups) decays
# its factors to zero on this data, the L2 gradient ~10x the data's: its
# order is learned on its pairwise BPR form (the model's default, and the
# form of the JAX package's test_fpmc_learns) at the same widths. FPMC's
# epoch is 9,650 steps (1,930 pairwise), SASRec's 48 (6,040 users, batch
# 128), GRU4Rec's schedule ~3,900; its cut is in schedule steps
SEQ_MODELS = (
    ("fpmc", "FPMC", [], 200, 1, "masked_scores[d32]", False),
    ("fpmc_bpr", "FPMC", ["--is_pairwise=True", "--loss_function=bpr"], 1000, 1, "masked_scores[d32]", True),
    ("fpmcplus", "FPMCplus", [], 200, 1, None, False),
    ("transrec", "TransRec", [], 200, 1, None, False),
    ("fossil", "Fossil", [], 200, 1, "masked_scores[d17,ml1m]", False),
    ("hrm", "HRM", [], 200, 1, "masked_scores[d16,ml1m]", False),
    ("npe", "NPE", [], 200, 1, "masked_scores[d64,ml1m]", False),
    ("sasrec", "SASRec", [], 48, 8, "masked_scores[d50]", True),
    ("caser", "Caser", [], 200, 1, "masked_scores[d100]", False),
    ("gru4rec", "GRU4Rec", [], 2000, 1, "masked_scores[d101]", True),
    ("gru4recplus", "GRU4RecPlus", [], 200, 1, "masked_scores[d101]", False),
    ("srgnn", "SRGNN", [], 200, 1, None, False),
)
# the run entry point for each sequential model, one epoch on a small
# timestamped rating file made from the seed, split by time (loo)
RUN_SEQ_MODELS = ("FPMC", "FPMCplus", "TransRec", "Fossil", "HRM", "NPE", "SASRec", "Caser", "GRU4Rec",
                  "GRU4RecPlus", "SRGNN")
RUN_SEQ_USERS, RUN_SEQ_ITEMS = 300, 400
# the social models' run entry point: one epoch on the rating file of
# RUN_MODELS with a friendship file made from the seed (5 friends a user)
RUN_SOCIAL_MODELS = ("SBPR", "DiffNet")

# path H: the social family on gowalla at their conf/*.properties widths
# (embedding 16, batch 512, Adam at lr 0.001; reg_mf 0.01 / 1e-5; DiffNet
# pointwise with 10 negatives and no feature file, as its conf's files are
# not in the repo), each for SOCIAL_STEPS steps of its first epoch, over a
# friendship graph made from the seed: each user's degree from a discrete
# power law on [1, SOCIAL_MAX_DEGREE] whose mean is SNAP loc-Gowalla's
# (950,327 undirected edges over 196,591 users, Cho et al., KDD 2011: 9.67
# friends a user), the degrees wired by a configuration model (stubs paired
# at random, self-loops and repeated pairs dropped), every edge written
# both ways as SNAP's edge file lists it. (path, model, flags, whether its
# Recall@20 must beat its random weights')
SOCIAL_EDGES, SOCIAL_NODES, SOCIAL_MAX_DEGREE = 950_327, 196_591, 1000
SOCIAL_STEPS = 300
SOCIAL_DIR = os.path.join(REPO, "build", "social")
SOCIAL_MODELS = (("sbpr", "SBPR", [], True), ("diffnet", "DiffNet", [], False))
# the sampled-candidates phase: gowalla with rec.evaluate.neg = CAND_NEG
# (the NCF papers' protocol: each test user's items against 99 negatives)
CAND_NEG = 99
# path I: a rating set at ml-10m's published shape (GroupLens MovieLens 10M:
# 69,878 users that rated, 10,677 items, 10,000,054 ratings, at least 20 a
# user, the most active 7,359), made on the card from the seed: user counts
# a log-normal tail as path G's, each user's items drawn without repeats by
# a Zipf-like popularity (Gumbel top-k over rank^-ML10M_ZIPF), 80% of each
# user's items to train. Its padded exclusion table is 4 B x 69,878 x 7,360
# (2.06 GB), over the 64 MB budget: MF trains on the Bloom sampler.
ML10M_USERS, ML10M_ITEMS, ML10M_RATINGS, ML10M_MIN_PER_USER = 69_878, 10_677, 10_000_054, 20
ML10M_MAX_PER_USER, ML10M_ZIPF = 7359, 0.9
BLOOM_STEPS = 300
# phases 23-24: the uninterrupted north star's checkpoints (phase 6), the
# 1-epoch run's that a fresh run.main resumes, and the resumed run's trace
CKPT_WHOLE = os.path.join(REPO, "build", "ckpt", "northstar")
CKPT_CUT = os.path.join(REPO, "build", "ckpt", "northstar_cut")
TRACE_DIR = os.path.join(REPO, "build", "trace")
# phase 25: the native backend's threads (the card's host has 8 cores)
NATIVE_THREADS = 8
# phase 26: the top-K probe's K
FAST_TOPK_KS = (20, 50)
# the Bloom contract: train positives among the epoch's negatives at most
# the 1e-6 upper quantile of a Poisson at their expected count
BLOOM_TAIL = 1e-6

# 2-epoch losses and Recall@20 recorded in PERF.md with the kernels whose
# warps owned whole rows (one fmaf chain per row). The edge-balanced
# schedule sums a hub row as pieces, so rounding may move these, no more.
RECORDED_RTOL = 1e-4
RECORDED_NORTHSTAR = {"loss": [1347.209839, 964.667725], "recall20": [0.08464802, 0.08635982]}
RECORDED_NGCF_LOSS = [699.8136, 652.5689]
# the row-tile split the skew phase reports beside the schedule: 16 warps
# a tile, warp w owning the rows with row % 16 == w
SKEW_WARPS = 16
# the hub-graph case: nodes, Zipf exponent, degree cap, the hub's degree
HUB_NODES, HUB_ZIPF, HUB_CAP, HUB_DEGREE = 20000, 1.8, 200, 3000


# phases 27-29: the mesh. mesh1: the north star through run.main in a one-rank
# NCCL group on a (1, 1) mesh. dp2 and itemshard2: two ranks sharing the one
# card through gloo (NCCL refuses two ranks on one device), LightGCN at the
# north star with graph_shard=on, MESH_STEPS steps on a (2, 1) mesh and one
# evaluation (bits_dp), then the evaluation on a (1, 2) mesh with
# eval_item_shard=on, premask auto (item_shard_bits) and 0 (item_shard_rows)
MESH_STEPS = 20
MESH_DIR = os.path.join(REPO, "build", "mesh")
MESH_TIMEOUT_S = 600
MESH_PARAM_ATOL, MESH_LOSS_RTOL, MESH_METRIC_ATOL = 1e-5, 1e-4, 1e-6
# phase 30, tp2: the same two ranks on a (1, 2) mesh, every id table
# row-sharded over 'model' (a rank holds half of each, and of its Adam
# moments): LightGCN at the north star with the graph whole (graph_shard=off)
# and MF at conf/MF.properties (the lookups alone), MESH_STEPS steps each
TP_DIR = os.path.join(REPO, "build", "tp")
TP_RUNS = {"tp2": TRAIN_ARGS + ["--graph_shard=off"], "tp2_mf": ["--recommender=MF"] + DATA_ARGS}
# phase 31, dp2_custom: the same two ranks on a (2, 1) mesh, every step of
# the custom epochs split over 'data' (SBPR, Caser, SRGNN, JCA, CFGAN's D and
# G sub-steps, IRGAN's D pass; DeepICF with batch norm runs whole, its
# Trainer's ``dp_split`` False); each model at its conf/*.properties widths
# on the data of its earlier phase: (path, model, data, flags, steps of each pass, eval
# users (None: every test user), K1's record at the rank's rows of its
# bits_dp evaluation (None: the predict tier)). SBPR and Caser, the slice's
# full-width path, take MESH_STEPS steps, the others CUSTOM_STEPS
CUSTOM_DIR = os.path.join(REPO, "build", "custom_dp")
CUSTOM_STEPS = 5
SOCIAL_FILE = os.path.join(SOCIAL_DIR, "gowalla_seeded.uu")
IRGAN_GEN = os.path.join(REPO, "build", "pretrained", "gowalla_irgan_gen.pkl")
CUSTOM_RUNS = (
    ("dp2_sbpr", "SBPR", "gowalla", ["--social_file=%s" % SOCIAL_FILE], MESH_STEPS, None, "masked_scores[d16,dp]"),
    ("dp2_caser", "Caser", "ml1m", [], MESH_STEPS, None, "masked_scores[d100,dp]"),
    ("dp2_srgnn", "SRGNN", "ml1m", [], CUSTOM_STEPS, None, None),
    ("dp2_jca", "JCA", "gowalla", [], CUSTOM_STEPS, ZOO_EVAL_USERS["JCA"], None),
    ("dp2_cfgan", "CFGAN", "gowalla", [], CUSTOM_STEPS, None, None),
    ("dp2_irgan", "IRGAN", "gowalla", ["--pretrain_file=%s" % IRGAN_GEN], CUSTOM_STEPS, None,
     "masked_scores[d21,dp]"),
)
# the loss methods a step calls, their batch rows the first tensor after the params
CUSTOM_LOSSES = {"SBPR": ("sbpr_loss",), "Caser": ("caser_loss",), "SRGNN": ("batch_loss",), "JCA": ("step_loss",),
                 "CFGAN": ("d_loss", "g_loss"), "IRGAN": ("_d_loss",)}
CUSTOM_LOSS_RTOL = 1e-5
# phases 32 and 33: each trainer runs KEPT_CALLS epoch calls, from one state,
# eagerly and through the programs it keeps (captured at the first call,
# replayed at the later ones)
KEPT_CALLS = 3
# kept_train: the north star through Trainer.train, whole epochs
KEPT_TRAIN_EPOCHS = 3
# phase 32, graph: the built-in epochs' steps captured as CUDA graphs
# against the same steps run eagerly (graphs=False), from one state on the
# same draws: the north star GRAPH_NORTHSTAR_STEPS steps at scan_unroll 1 and
# 8 (and GRAPH_SHORT_STEPS under the profiler for the device time a step),
# NGCF at path B's widths GRAPH_NGCF_STEPS, path A GRAPH_PACK2_STEPS, every
# other built-in-epoch model GRAPH_ZOO_STEPS at scan_unroll 3 (at the first
# call a warm-up step, then the graph of 3, the remainder of 1 and the
# remainder of 2 that the later calls take are captured: the later calls
# replay the graphs of 3 and 2, out of capture order, and capture
# nothing). Where two eager runs
# differ (an op that adds in no fixed order) a kept run is held within
# GRAPH_ATOL (params) and GRAPH_LOSS_RTOL; else to the bit
GRAPH_NORTHSTAR_STEPS, GRAPH_SHORT_STEPS = 50, 10
GRAPH_NGCF_STEPS, GRAPH_PACK2_STEPS, GRAPH_ZOO_STEPS = 20, 10, 5
GRAPH_UNROLLS, GRAPH_ZOO_UNROLLS = (1, 8), (3,)
GRAPH_ATOL, GRAPH_LOSS_RTOL = 1e-6, 1e-6
BUILT_IN_KINDS = ("pairwise", "pointwise", "time_pairwise", "time_pointwise", "dense_row")
GRAPH_MODELS = 23
# phase 33, graph_custom: the custom epochs' steps captured as CUDA graphs
# against the same steps run eagerly (graphs=False), beside each path's
# trainer, from copies of its state, epochs GRAPH_CUSTOM_EPOCH .. + 2:
# GRAPH_CUSTOM_STEPS steps of each pass at scan_unroll 1 and 3 (a warm-up
# step, graphs of 3 and a remainder of 2 at the first call); the device ms a step past the
# first from the profiler over the captured run of GRAPH_CUSTOM_STEPS steps
# less a 1-step one (the epoch's own draws and step 0 cancel). WRMF's epoch,
# one ALS solve, has no steps and stays eager
GRAPH_CUSTOM_MODELS = ("SBPR", "SASRec", "Caser", "SRGNN", "GRU4Rec", "GRU4RecPlus", "JCA", "CFGAN", "IRGAN")
GRAPH_CUSTOM_STEPS, GRAPH_CUSTOM_EPOCH = 24, 2
GRAPH_CUSTOM_UNROLLS = (1, 3)
# phase 34, eval_graph: each path's evaluation as CUDA graphs kept across
# calls (the default) against graphs=False, on fresh evaluators: a cold
# call (captured: eager, then the captures) and EVAL_GRAPH_WARM warm ones,
# the metric strings and the recorded ids equal; the predict-heavy models
# evaluate their first EVAL_GRAPH_USERS test users (the only cut: two
# batches or more, so the body replays); NAIS's export serves one request
# of SERVING_USERS users NAIS_SERVING_REQUESTS times both ways
EVAL_GRAPH_WARM = 3
EVAL_GRAPH_USERS = {"NeuMF": 4096, "GRU4Rec": 2048, "NAIS": 4096, "DeepICF": 4096}
EVAL_GRAPH_PATHS = ("northstar", "pack2", "ngcf", "neumf", "gru4rec", "nais", "deepicf")
NAIS_SERVING_REQUESTS = 2


class SmokeFailure(RuntimeError):
    pass


class SilentLogger:
    path = None

    def info(self, msg):
        pass

    debug = warning = error = critical = info


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mesh_steps(trainer, draws, steps):
    """``steps`` steps of ``trainer`` on ``draws``, one ``run_epoch`` a step:
    each step's whole-batch loss."""
    return [float(trainer.run_epoch(trainer.params, trainer.opt_state, draws.inst[s:s + 1], draws.w[s:s + 1],
                                    draws.negs[s:s + 1], draws.seeds[s:s + 1], epoch=1)[2]) for s in range(steps)]


def spy_launch_shapes(k1, k2) -> dict:
    """Wrap the K1 and K2 wrappers of this process so that every K2 launch
    records its output rows and every K1 launch its (B, I); returns the
    sets, by launch counter name."""
    shapes = {"plan_spmm": set(), "plan_spmm_t": set(), "masked_scores": set()}
    real_scatter, real_bits, real_int8 = k2.plan_scatter, k1.masked_scores_bits, k1.masked_scores

    def scatter(plan, x):
        shapes["plan_spmm_t" if plan.transposed else "plan_spmm"].add(plan.n_rows)
        return real_scatter(plan, x)

    def bits_k1(u, items, bits, width, num_items):
        shapes["masked_scores"].add((u.shape[0], num_items))
        return real_bits(u, items, bits, width, num_items)

    def int8_k1(u, items, rows):
        shapes["masked_scores"].add((u.shape[0], items.shape[0]))
        return real_int8(u, items, rows)

    k2.plan_scatter, k1.masked_scores_bits, k1.masked_scores = scatter, bits_k1, int8_k1
    return shapes


def mesh_rank(rank: int, port: int, out_dir: str, train_args=None, device: str = "cuda"):
    """One rank of phases 28-29 (a spawned process; the parent has built
    every kernel): joins the gloo group of two ranks on the card, runs the
    (2, 1) data-parallel steps and evaluation and the (1, 2) item-sharded
    evaluations of ``train_args`` (``TRAIN_ARGS`` when None), and pickles
    what it saw to ``out_dir/rank<r>.pkl``."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, REPO)
    os.chdir(REPO)
    out = {}
    try:
        from neurec_tpu_torch.bridge import params_to_numpy
        from neurec_tpu_torch.config import Config
        from neurec_tpu_torch.data.dataset import Dataset
        from neurec_tpu_torch.eval import Evaluator
        from neurec_tpu_torch.models import get_model
        from neurec_tpu_torch.ops import _build
        from neurec_tpu_torch.ops import masked_scores as k1
        from neurec_tpu_torch.ops import spmm as k2
        from neurec_tpu_torch.parallel.distributed import initialize_multihost, shutdown
        from neurec_tpu_torch.parallel.mesh import make_mesh
        from neurec_tpu_torch.trainer import Trainer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        # two ranks and the parent share the host's cores: threads that
        # spin on a busy core slow every collective
        torch.set_num_threads(2)
        if device == "cuda":
            torch.cuda.set_device(0)
        train_args = TRAIN_ARGS if train_args is None else train_args
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        initialize_multihost("127.0.0.1:%d" % port, 2, rank, backend="gloo", timeout_s=MESH_TIMEOUT_S)
        shapes = spy_launch_shapes(k1, k2)

        t = time.perf_counter()
        conf = Config(PROPS, cmd_args=train_args + ["--graph_shard=on"])
        dataset = Dataset(conf)
        model = get_model("LightGCN")(dataset, conf, device=device)
        mesh = make_mesh(n_data=2, n_model=1)
        trainer = Trainer(model, dataset, conf, logger=SilentLogger(), device=device, mesh=mesh)
        trainer.initialize()
        draws = trainer.draw_epoch(trainer.epoch_generator(1))
        sync()
        setup_s = time.perf_counter() - t
        _build.reset_launches()
        t = time.perf_counter()
        losses = mesh_steps(trainer, draws, MESH_STEPS)
        sync()
        steps_s = time.perf_counter() - t
        t = time.perf_counter()
        result = trainer.evaluate()
        sync()
        out["dp2"] = {"setup_s": setup_s, "steps_s": steps_s, "eval_s": time.perf_counter() - t,
                      "losses": losses, "result": result, "launches": dict(_build.LAUNCHES),
                      "tier": trainer.evaluator.evaluator._get_program(model.predict).plan.name,
                      "block": model._adj_sharded.block, "n_nodes": model.adj.n_nodes,
                      "k2_rows": sorted(shapes["plan_spmm"]), "k2_t_rows": sorted(shapes["plan_spmm_t"]),
                      "k1_shapes": sorted(shapes["masked_scores"])}
        if rank == 0:
            out["params"] = params_to_numpy(trainer.params)

        mesh2 = make_mesh(n_data=1, n_model=2)
        for key, premask in (("itemshard2", None), ("itemshard2_rows", "0")):
            if premask is None:
                os.environ.pop("NEUREC_EVAL_PREMASK", None)
            else:
                os.environ["NEUREC_EVAL_PREMASK"] = premask
            ev = Evaluator.from_dataset(dataset, Config(PROPS, cmd_args=train_args + ["--eval_item_shard=on"]),
                                        device=device, mesh=mesh2)
            ev.evaluator.record_ids = True
            for name in shapes:
                shapes[name] = set()
            _build.reset_launches()
            t = time.perf_counter()
            result = ev.evaluate(model.predict, trainer.params)
            sync()
            out[key] = {"eval_s": time.perf_counter() - t, "result": result, "launches": dict(_build.LAUNCHES),
                        "tier": ev.evaluator._get_program(model.predict).plan.name,
                        "ids": ev.evaluator.last_ids[:, :20].cpu().numpy(),
                        "k1_shapes": sorted(shapes["masked_scores"])}
        os.environ.pop("NEUREC_EVAL_PREMASK", None)
        shutdown()
    except Exception:  # reported to the parent through the result file
        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as fout:
        pickle.dump(out, fout)


def resident_bytes(tensors) -> int:
    """The bytes of the storages of ``tensors`` (what a rank holds)."""
    return sum(t.untyped_storage().nbytes() for t in tensors)


def adam_moments(trainer):
    """The Adam moments (``exp_avg``, ``exp_avg_sq``) of ``trainer``'s params."""
    from neurec_tpu_torch.bridge import param_leaves

    state = trainer.opt_state.state
    return [state[p][k] for _, p in param_leaves(trainer.params) if p in state for k in ("exp_avg", "exp_avg_sq")]


def tp_rank(rank: int, port: int, out_dir: str, device: str = "cuda"):
    """One rank of phase 30 (a spawned process; the parent has built every
    kernel): joins the gloo group of two ranks on the card, makes a (1, 2)
    mesh, on which the trainer row-shards every id table over 'model', and
    for each of ``TP_RUNS`` takes ``MESH_STEPS`` steps and its evaluations
    (``eval_item_shard`` auto, and on for LightGCN); pickles what it saw,
    the params gathered whole on rank 0, to ``out_dir/rank<r>.pkl``."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, REPO)
    os.chdir(REPO)
    out = {}
    try:
        from neurec_tpu_torch.bridge import param_leaves, params_to_numpy
        from neurec_tpu_torch.config import Config
        from neurec_tpu_torch.data.dataset import Dataset
        from neurec_tpu_torch.eval import Evaluator
        from neurec_tpu_torch.models import get_model
        from neurec_tpu_torch.ops import _build
        from neurec_tpu_torch.ops import masked_scores as k1
        from neurec_tpu_torch.ops import spmm as k2
        from neurec_tpu_torch.parallel.distributed import initialize_multihost, shutdown
        from neurec_tpu_torch.parallel.mesh import make_mesh
        from neurec_tpu_torch.trainer import Trainer

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torch.set_num_threads(2)  # as mesh_rank: spinning threads slow the collectives
        if device == "cuda":
            torch.cuda.set_device(0)
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        initialize_multihost("127.0.0.1:%d" % port, 2, rank, backend="gloo", timeout_s=MESH_TIMEOUT_S)
        shapes = spy_launch_shapes(k1, k2)
        mesh = make_mesh(n_data=1, n_model=2)
        dataset = None
        for key, args in TP_RUNS.items():
            t = time.perf_counter()
            conf = Config(PROPS, cmd_args=args)
            dataset = dataset or Dataset(conf)
            model = get_model(conf["recommender"])(dataset, conf, device=device)
            trainer = Trainer(model, dataset, conf, logger=SilentLogger(), device=device, mesh=mesh)
            trainer.initialize()
            draws = trainer.draw_epoch(trainer.epoch_generator(1))
            sync()
            rec = {"setup_s": time.perf_counter() - t,
                   "shards": {path[0]: [s.lo, s.block, s.rows] for path, s in model.shards.items()},
                   "param_bytes": resident_bytes(p for _, p in param_leaves(trainer.params))}
            for name in shapes:
                shapes[name] = set()
            _build.reset_launches()
            t = time.perf_counter()
            rec["losses"] = mesh_steps(trainer, draws, MESH_STEPS)
            sync()
            rec.update(steps_s=time.perf_counter() - t, launches=dict(_build.LAUNCHES),
                       adam_bytes=resident_bytes(adam_moments(trainer)), k2_rows=sorted(shapes["plan_spmm"]),
                       k2_t_rows=sorted(shapes["plan_spmm_t"]))
            for mode in ("auto", "on") if conf["recommender"] == "LightGCN" else ("auto",):
                ev = trainer.evaluator if mode == "auto" else Evaluator.from_dataset(
                    dataset, Config(PROPS, cmd_args=args + ["--eval_item_shard=on"]), device=device, mesh=mesh)
                for name in shapes:
                    shapes[name] = set()
                _build.reset_launches()
                t = time.perf_counter()
                result = ev.evaluate(model.predict, trainer.params)
                sync()
                rec["eval_" + mode] = {"eval_s": time.perf_counter() - t, "result": result,
                                       "launches": dict(_build.LAUNCHES),
                                       "tier": ev.evaluator._get_program(model.predict).plan.name,
                                       "k1_shapes": sorted(shapes["masked_scores"])}
            params = params_to_numpy(trainer.params, model.shards)  # a gather: every rank
            if rank == 0:
                rec["params"] = params
            out[key] = rec
            del trainer, model, draws
        shutdown()
    except Exception:  # reported to the parent through the result file
        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as fout:
        pickle.dump(out, fout)


def tp_phase(dataset, n_batches_eval: int, I_m: int, paths: dict, device: str = "cuda", start_method: str = "spawn"):
    """Phase 30: ``tp_rank`` on two spawned ranks, the one-rank runs of
    ``TP_RUNS`` on the same draws meanwhile, then the checks; emits a
    line a run and adds its launches to ``paths`` (``tp2``,
    ``tp2_item_shard``, ``tp2_mf``). ``dataset`` is the gowalla split the
    ranks load, ``n_batches_eval`` its evaluation batches, ``I_m`` a
    'model' rank's item block on the item-sharded tier."""
    import pickle

    import torch
    import torch.multiprocessing as mp

    from neurec_tpu_torch.bridge import param_leaves, params_from_numpy
    from neurec_tpu_torch.config import Config
    from neurec_tpu_torch.models import get_model
    from neurec_tpu_torch.ops import _build
    from neurec_tpu_torch.trainer import Trainer

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    I = dataset.num_items
    os.makedirs(TP_DIR, exist_ok=True)
    for f in glob.glob(os.path.join(TP_DIR, "rank*.pkl")):
        os.unlink(f)
    t_tp = time.perf_counter()
    ctx = mp.start_processes(tp_rank, args=(_free_port(), TP_DIR, device), nprocs=2, join=False,
                             start_method=start_method)
    # the one-rank runs on the same draws, while the ranks start
    one_rank = {}
    for key, args in TP_RUNS.items():
        conf_1 = Config(PROPS, cmd_args=args)
        trainer_1 = Trainer(get_model(conf_1["recommender"])(dataset, conf_1, device=device), dataset, conf_1,
                            logger=SilentLogger(), device=device)
        trainer_1.initialize()
        draws_1 = trainer_1.draw_epoch(trainer_1.epoch_generator(1))
        bytes_1 = resident_bytes(p for _, p in param_leaves(trainer_1.params))
        _build.reset_launches()
        losses_1 = mesh_steps(trainer_1, draws_1, MESH_STEPS)
        sync()
        one_rank[key] = {"losses": losses_1, "launches": dict(_build.LAUNCHES), "param_bytes": bytes_1,
                         "adam_bytes": resident_bytes(adam_moments(trainer_1)), "result": trainer_1.evaluate(),
                         "params": trainer_1.params, "n_nodes": getattr(getattr(trainer_1.model, "adj", None),
                                                                         "n_nodes", None)}
        del trainer_1, draws_1
    try:
        while not ctx.join(timeout=5.0):
            require(time.perf_counter() - t_tp < MESH_TIMEOUT_S, "the two tp2 ranks did not finish")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(2):
        with open(os.path.join(TP_DIR, "rank%d.pkl" % r), "rb") as fin:
            ranks.append(pickle.load(fin))
        require("error" not in ranks[r], "tp2 rank %d failed:\n%s" % (r, ranks[r].get("error")))
    tp_s = time.perf_counter() - t_tp
    for key in TP_RUNS:
        want = one_rank[key]
        params_r0 = params_from_numpy(ranks[0][key]["params"], device)
        with torch.no_grad():
            param_err_tp = max(float((params_r0[k] - want["params"][k]).abs().max()) for k in params_r0)
        loss_rel_tp = [max(abs(a - b) / abs(b) for a, b in zip(rk[key]["losses"], want["losses"])) for rk in ranks]
        modes = [m for m in ("auto", "on") if "eval_" + m in ranks[0][key]]
        emit({"phase": key, "mesh": [1, 2], "backend": "gloo, staged through the host", "steps": MESH_STEPS,
              "seconds": tp_s, "losses": ranks[0][key]["losses"], "one_rank_losses": want["losses"],
              "loss_max_rel_diff": loss_rel_tp, "param_max_abs_diff": param_err_tp,
              "results": {m: ranks[0][key]["eval_" + m]["result"] for m in modes}, "one_rank_result": want["result"],
              "bytes": {"one_rank": {"params": want["param_bytes"], "adam": want["adam_bytes"]},
                        "ranks": [{"params": rk[key]["param_bytes"], "adam": rk[key]["adam_bytes"]} for rk in ranks]},
              "one_rank_launches": want["launches"],
              "ranks": [dict({k: rk[key][k] for k in ("setup_s", "steps_s", "shards", "launches", "k2_rows",
                                                       "k2_t_rows")},
                             **{"eval_" + m: rk[key]["eval_" + m] for m in modes}) for rk in ranks],
              "tol": "params atol %g, losses rtol %g, strings equal; a rank's bytes half the one rank's"
                     % (MESH_PARAM_ATOL, MESH_LOSS_RTOL)})
        for r, rk in enumerate(ranks):
            got = rk[key]
            tables = {"user_emb": dataset.num_users, "item_emb": dataset.num_items}
            require(got["shards"] == {k: [r * n // 2, n // 2, n] for k, n in tables.items()},
                    "%s rank %d holds %s" % (key, r, got["shards"]))
            require(2 * got["param_bytes"] == want["param_bytes"] and 2 * got["adam_bytes"] == want["adam_bytes"],
                    "%s rank %d holds %d + %d bytes, one rank %d + %d" % (
                        key, r, got["param_bytes"], got["adam_bytes"], want["param_bytes"], want["adam_bytes"]))
            require(loss_rel_tp[r] <= MESH_LOSS_RTOL, "%s rank %d: losses %g from the one-rank run"
                    % (key, r, loss_rel_tp[r]))
            require(all(got["launches"][k] == want["launches"][k] for k in ("plan_spmm", "plan_spmm_t"))
                    and got["k2_rows"] == got["k2_t_rows"] == ([want["n_nodes"]] if want["n_nodes"] else []),
                    "%s rank %d: K2 %s at %s, %s; one rank %s" % (key, r, got["launches"], got["k2_rows"],
                                                                 got["k2_t_rows"], want["launches"]))
            for mode, tier, cols in (("auto", "bits_dp", I), ("on", "item_shard_bits", I_m)):
                if mode not in modes:
                    continue
                ev_got = got["eval_" + mode]
                require(ev_got["tier"] == tier and ev_got["result"] == want["result"],
                        "%s rank %d eval %s: %s %r, one rank %r" % (key, r, mode, ev_got["tier"], ev_got["result"],
                                                                 want["result"]))
                require(ev_got["launches"]["masked_scores"] == n_batches_eval
                        and ev_got["k1_shapes"] == [(EVAL_USERS_PER_BATCH, cols)],
                        "%s rank %d eval %s: K1 %s, %s" % (key, r, mode, ev_got["k1_shapes"], ev_got["launches"]))
        require(param_err_tp <= MESH_PARAM_ATOL, "%s params differ from the one-rank run by %g" % (key, param_err_tp))
        train_eval = ranks[0][key]
        paths[key] = {k: train_eval["launches"].get(k, 0) + train_eval["eval_auto"]["launches"].get(k, 0)
                      for k in set(train_eval["launches"]) | set(train_eval["eval_auto"]["launches"])}
        if "on" in modes:
            paths[key + "_item_shard"] = train_eval["eval_on"]["launches"]
    del one_rank, ranks, params_r0


def custom_run(name, data, flags, steps, n_eval, datasets, device="cuda", mesh=None):
    """``name`` at conf/<name>.properties and ``flags`` on ``data``
    ("gowalla" or "ml1m", its Dataset kept in ``datasets``): initialized,
    one epoch cut to ``steps`` steps of each pass, one evaluation of the
    first ``n_eval`` test users (every one when None), with every launch
    count set to 0 before the steps and read after the evaluation. Returns
    ``(trainer, record)``; the record holds the batch rows each loss method
    of ``CUSTOM_LOSSES`` saw, the epoch loss, the string and the times."""
    import torch

    from neurec_tpu_torch.config import Config
    from neurec_tpu_torch.data.dataset import Dataset
    from neurec_tpu_torch.models import get_model
    from neurec_tpu_torch.ops import _build
    from neurec_tpu_torch.trainer import Trainer

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t = time.perf_counter()
    conf = Config(PROPS, cmd_args=["--recommender=%s" % name] + (DATA_ARGS if data == "gowalla" else ML1M_ARGS)
                  + flags)
    if data not in datasets:
        datasets[data] = Dataset(conf)
    ds = datasets[data]
    # eager steps on both sides of the comparison (a mesh of two ranks captures nothing)
    trainer = Trainer(get_model(name)(ds, conf, device=device), ds, conf, logger=SilentLogger(), device=device,
                      mesh=mesh, graphs=False)
    trainer.initialize()
    sync()
    rec = {"setup_s": time.perf_counter() - t, "batch_rows": {}}
    model = trainer.model
    for method in CUSTOM_LOSSES[name]:
        def spy(params, *rest, _real=getattr(model, method), _key=method):
            rows = next(a for a in rest if isinstance(a, torch.Tensor))
            rec["batch_rows"].setdefault(_key, set()).add(int(rows.shape[0]))
            return _real(params, *rest)

        setattr(model, method, spy)
    _build.reset_launches()
    t = time.perf_counter()
    trainer.params, trainer.opt_state, loss = trainer.train_epoch(1, max_steps=steps)
    rec["loss"] = float(loss)
    sync()
    rec["steps_s"] = time.perf_counter() - t
    ev = trainer.evaluator.evaluator
    users = ev.test_users if n_eval is None else ev.test_users[:n_eval]
    t = time.perf_counter()
    rec["result"] = ev.evaluate(model.predict, trainer.params, users)
    sync()
    rec.update(eval_s=time.perf_counter() - t, eval_users=len(users), launches=dict(_build.LAUNCHES),
               tier=ev._get_program(model.predict).plan.name, num_items=ds.num_items)
    return trainer, rec


def custom_rank(rank: int, port: int, out_dir: str, device: str = "cuda"):
    """One rank of phase 31 (a spawned process; the parent has built every
    kernel): joins the gloo group of two ranks on the card, makes a (2, 1)
    mesh and runs each of ``CUSTOM_RUNS`` split over 'data'
    (``custom_run``); records the K1 shapes of its evaluation and how far
    its params lie from rank 0's, and pickles what it saw, rank 0's params
    too, to ``out_dir/rank<r>.pkl``."""
    import pickle
    import traceback

    import torch

    sys.path.insert(0, REPO)
    os.chdir(REPO)
    out = {}
    try:
        from neurec_tpu_torch.bridge import param_leaves, params_to_numpy
        from neurec_tpu_torch.ops import masked_scores as k1
        from neurec_tpu_torch.ops import spmm as k2
        from neurec_tpu_torch.parallel.distributed import initialize_multihost, shutdown
        from neurec_tpu_torch.parallel.mesh import all_sum_many, make_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torch.set_num_threads(2)  # as mesh_rank: spinning threads slow the collectives
        if device == "cuda":
            torch.cuda.set_device(0)
        initialize_multihost("127.0.0.1:%d" % port, 2, rank, backend="gloo", timeout_s=MESH_TIMEOUT_S)
        shapes = spy_launch_shapes(k1, k2)
        mesh = make_mesh(n_data=2, n_model=1)
        datasets = {}
        for key, name, data, flags, steps, n_eval, _ in CUSTOM_RUNS:
            for kernel in shapes:
                shapes[kernel] = set()
            trainer, rec = custom_run(name, data, flags, steps, n_eval, datasets, device, mesh)
            rec["k1_shapes"] = sorted(shapes["masked_scores"])
            # rank 0's params on both ranks (a sum of them and zeros)
            leaves = [p.detach() for _, p in param_leaves(trainer.params)]
            theirs = all_sum_many([p if rank == 0 else torch.zeros_like(p) for p in leaves], mesh, "data")
            rec["param_max_abs_diff_to_rank0"] = max(float((a - b).abs().max()) for a, b in zip(leaves, theirs))
            if rank == 0:
                rec["params"] = params_to_numpy(trainer.params)
            out[key] = rec
            del trainer, leaves, theirs
        shutdown()
    except Exception:  # reported to the parent through the result file
        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as fout:
        pickle.dump(out, fout)


def custom_dp_phase(dataset, paths: dict, device: str = "cuda", start_method: str = "spawn"):
    """Phase 31: ``custom_rank`` on two spawned ranks, the one-rank runs of
    ``CUSTOM_RUNS`` on the same draws meanwhile, then the checks: each
    rank's epoch loss within ``CUSTOM_LOSS_RTOL`` of the one-rank run's,
    rank 0's params within ``MESH_PARAM_ATOL`` and rank 1's equal to rank
    0's, the strings equal, each loss method fed half the one-rank run's
    rows, K1 once an evaluation batch at the rank's 1,024 rows on the
    models it ranks and never on the others. Emits a line a model and adds
    its launches to ``paths`` under its key; returns the one-rank trainers
    of the K1 models, by key."""
    import pickle

    import torch
    import torch.multiprocessing as mp

    from neurec_tpu_torch.bridge import param_leaves

    os.makedirs(CUSTOM_DIR, exist_ok=True)
    for f in glob.glob(os.path.join(CUSTOM_DIR, "rank*.pkl")):
        os.unlink(f)
    t_phase = time.perf_counter()
    ctx = mp.start_processes(custom_rank, args=(_free_port(), CUSTOM_DIR, device), nprocs=2, join=False,
                             start_method=start_method)
    # the one-rank runs on the same draws, while the ranks start
    datasets = {"gowalla": dataset}
    one_rank, kept = {}, {}
    for key, name, data, flags, steps, n_eval, record in CUSTOM_RUNS:
        trainer_1, rec_1 = custom_run(name, data, flags, steps, n_eval, datasets, device)
        rec_1["params"] = {path: p.detach() for path, p in param_leaves(trainer_1.params)}
        one_rank[key] = rec_1
        if record is not None:
            kept[key] = trainer_1
        del trainer_1
    try:
        while not ctx.join(timeout=5.0):
            require(time.perf_counter() - t_phase < MESH_TIMEOUT_S, "the two dp2_custom ranks did not finish")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(2):
        with open(os.path.join(CUSTOM_DIR, "rank%d.pkl" % r), "rb") as fin:
            ranks.append(pickle.load(fin))
        require("error" not in ranks[r], "dp2_custom rank %d failed:\n%s" % (r, ranks[r].get("error")))
    phase_s = time.perf_counter() - t_phase
    for key, name, data, flags, steps, n_eval, record in CUSTOM_RUNS:
        want = one_rank[key]
        got0 = ranks[0][key]
        with torch.no_grad():
            param_err = max(float((torch.as_tensor(v).to(device) - want["params"][path]).abs().max())
                            for path, v in param_leaves(got0["params"]))
        loss_rel = [abs(rk[key]["loss"] - want["loss"]) / abs(want["loss"]) for rk in ranks]
        rows_want = {m: sorted(b // 2 for b in rows) for m, rows in want["batch_rows"].items()}
        n_batches = -(-want["eval_users"] // EVAL_USERS_PER_BATCH)
        k1_want = ([(EVAL_USERS_PER_BATCH // 2, want["num_items"])], n_batches) if record else ([], 0)
        emit({"phase": key, "model": name, "mesh": [2, 1], "backend": "gloo, staged through the host",
              "steps": steps, "loss": got0["loss"], "one_rank_loss": want["loss"], "loss_max_rel_diff": loss_rel,
              "param_max_abs_diff": param_err, "result": got0["result"], "one_rank_result": want["result"],
              "eval_users": want["eval_users"], "tier": got0["tier"], "one_rank_tier": want["tier"],
              "one_rank_rows": {m: sorted(v) for m, v in want["batch_rows"].items()},
              "one_rank_steps_s": want["steps_s"], "one_rank_eval_s": want["eval_s"],
              "ranks": [{"setup_s": rk[key]["setup_s"], "steps_s": rk[key]["steps_s"], "eval_s": rk[key]["eval_s"],
                         "rows_per_rank": {m: sorted(v) for m, v in rk[key]["batch_rows"].items()},
                         "launches": rk[key]["launches"], "k1_shapes": rk[key]["k1_shapes"],
                         "param_max_abs_diff_to_rank0": rk[key]["param_max_abs_diff_to_rank0"]} for rk in ranks],
              "tol": "params atol %g, loss rtol %g, strings equal, each loss method half the rows"
                     % (MESH_PARAM_ATOL, CUSTOM_LOSS_RTOL)})
        for r, rk in enumerate(ranks):
            got = rk[key]
            require(got["result"] == want["result"], "%s rank %d: %r, one rank %r" % (key, r, got["result"],
                                                                                    want["result"]))
            require(loss_rel[r] <= CUSTOM_LOSS_RTOL, "%s rank %d: loss %r, one rank %r" % (key, r, got["loss"],
                                                                                         want["loss"]))
            rows_got = {m: sorted(v) for m, v in got["batch_rows"].items()}
            require(rows_got == rows_want and all(rows_want.values()),
                    "%s rank %d: the loss saw rows %s, half the one rank's is %s" % (key, r, rows_got, rows_want))
            require(got["param_max_abs_diff_to_rank0"] <= MESH_PARAM_ATOL,
                    "%s rank %d: params %g from rank 0's" % (key, r, got["param_max_abs_diff_to_rank0"]))
            require((got["k1_shapes"], got["launches"]["masked_scores"]) == k1_want,
                    "%s rank %d: K1 %s, launches %s" % (key, r, got["k1_shapes"], got["launches"]))
        require(param_err <= MESH_PARAM_ATOL, "%s params differ from the one-rank run by %g" % (key, param_err))
        paths[key] = ranks[0][key]["launches"]
    emit({"phase": "dp2_custom", "seconds": phase_s, "models": [run[1] for run in CUSTOM_RUNS]})
    del one_rank, ranks
    return kept


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also carries the seconds since the
    script started (``at_s``)."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def env_vars(values):
    """Set environment variables (None: unset) and restore them afterwards."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def traced(torch, fn, n, activities=("CPU", "CUDA")):
    """``(profiler, wall ms)``: ``torch.profiler`` over ``n`` calls of
    ``fn``, after a warm-up step of ``n`` calls that it traces and drops
    (its schedule's ``warmup``, as the profiler's documentation advises);
    the wall time is the counted step's."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [getattr(ProfilerActivity, a) for a in activities]
    torch.cuda.synchronize()
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            prof.step()
    return prof, wall_ms


def device_ms(torch, fn, n=20, tries=6):
    """``(total, by_kernel)``: the device time of one call of ``fn``, the
    summed time of its CUDA kernels under ``torch.profiler`` (``traced``),
    and each kernel's share, per call; ``(None, {})`` where no window was
    whole. Unlike ``time_ms`` it leaves out the host's time, which sets a
    back-to-back loop's pace when a call's kernels are shorter.

    On the card a window now and then keeps the host's events and loses
    some or all of its kernels' records (17 of 20 K1 launches, or none; how
    often varies from run to run, and why is not known), so a window is
    kept only when every kernel in it ran a whole number of times a call.
    Another is opened otherwise, up to ``tries``, and each one dropped is
    reported (``phase: profiler_window``)."""
    from torch.autograd import DeviceType

    fn()
    for attempt in range(tries):
        events = traced(torch, fn, n)[0].key_averages()
        kernels = [e for e in events
                   if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        if kernels and all(e.count % n == 0 for e in kernels):
            by_kernel = {}
            for e in kernels:
                name = e.key.split("<")[0].split("(")[0][-40:]
                by_kernel[name] = by_kernel.get(name, 0.0) + e.self_device_time_total / n / 1e3
            return sum(by_kernel.values()), by_kernel
        emit({"phase": "profiler_window", "dropped": True, "attempt": attempt, "calls": n,
              "kernels": {e.key[:60]: e.count for e in kernels},
              "host_events": {e.key[:40]: e.count for e in list(events) if e.device_type != DeviceType.CUDA}})
    return None, {}


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_bounds(k1, n_bytes: float, n_flops: float, d: int):
    """K1's bound for the path width ``d`` takes: the bytes or the f32
    FMAs (f32 path), the bytes or three TF32 products on the tensor cores
    (split path); beside it the f32 bound."""
    f32 = bound_ms(n_bytes, n_flops)
    if k1.k1_path(d) == "fma":
        ms, by = f32
    else:
        ms, by = bound_ms(n_bytes, K1_TF32_PRODUCTS * n_flops, PEAK_TF32_FLOPS)
    return {"path": k1.k1_path(d), "bound_ms": ms, "bound_by": by, "bound_f32_ms": f32[0]}


def k1_errors(torch, got, u, items):
    """K1's error beside its plain version: the largest difference scaled
    by |u_b| |item_i|, the largest distance of each from the f64 product
    (finite entries), and K1's distance from it over the f32 path's bound,
    d 2^-24 sum_k |u_bk i_ik|, and over the split's, (K1_SPLIT_REL +
    d 2^-24) sum_k |u_bk i_ik| (at most 1 on the path that ran)."""
    want = u @ items.T
    exact = u.double() @ items.double().T
    finite = torch.isfinite(got)
    scale = u.norm(dim=1)[:, None] * items.norm(dim=1)[None, :]
    scaled = ((got - want).abs() / scale.clamp_min(1e-30))[finite]
    abs_sum = u.double().abs() @ items.double().abs().T
    err = (got.double() - exact).abs()
    d = u.shape[1]
    out = {"max_scaled_err": float(scaled.max()) if scaled.numel() else 0.0,
           "err_vs_f64": float(err[finite].max()),
           "plain_err_vs_f64": float((want.double() - exact)[finite].abs().max()),
           "err_over_f32_bound": float((err / (d * K1_F32_REL * abs_sum).clamp_min(1e-300))[finite].max()),
           "err_over_split_bound": float(
               (err / ((K1_SPLIT_REL + d * K1_F32_REL) * abs_sum).clamp_min(1e-300))[finite].max())}
    del exact, abs_sum, err
    return out


def k1_chain_mismatches(torch, k1, got, want, u, items) -> int:
    """K1's f32 path against the fmaf chain a thread a score
    (``k1.fma_chain_scores``, the f32 path's arithmetic without its tiles)
    with -inf where the plain version ``want`` has it: the number of scores
    whose bits differ, 0 where the path keeps its bits."""
    chain = k1.fma_chain_scores(u, items[: got.shape[1]])
    oracle = torch.where(torch.isneginf(want), float("-inf"), chain)
    n = int((got.view(torch.int32) != oracle.view(torch.int32)).sum())
    del chain, oracle
    return n


def k1_turns(torch, fns, iters=50):
    """CUDA-event ms of each of ``fns`` (name -> call), timed in turns in
    one call, A B C C B A: ``{name: [first, second]}``."""
    order = list(fns) + list(reversed(list(fns)))
    out = {name: [] for name in fns}
    for name in order:
        out[name].append(time_ms(torch, fns[name], iters=iters, warmup=10))
    return out


def compare(torch, got, want):
    """(max_abs_err, ok): -inf at the same places, finite values within
    ATOL + RTOL * |want|."""
    inf_got, inf_want = torch.isinf(got), torch.isinf(want)
    same_inf = bool(torch.equal(inf_got, inf_want))
    finite = ~inf_want
    diff = torch.where(finite, (got - want).abs(), torch.zeros_like(got))
    err = float(diff.max()) if diff.numel() else 0.0
    ok = same_inf and bool(torch.isfinite(got[finite]).all()) and bool(
        (diff <= ATOL + RTOL * torch.where(finite, want.abs(), torch.zeros_like(want))).all()
    )
    return err, ok


def glorot_numpy(rng, shape):
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return rng.uniform(-limit, limit, size=shape).astype("float32")


def parse_metrics(line: str):
    return [float(x) for x in line.split("\t")]


def sparse_csr(torch, np, matrix):
    return torch.sparse_csr_tensor(
        torch.from_numpy(matrix.indptr.astype(np.int64)), torch.from_numpy(matrix.indices.astype(np.int64)),
        torch.from_numpy(matrix.data), size=matrix.shape, check_invariants=True,
    ).cuda()


def adjacency_csr(torch, np, sp, adj, transpose=False):
    """The adjacency (or its transpose) as a CUDA CSR tensor, for the library call."""
    rows, cols, vals = (t.cpu().numpy() for t in (adj.rows, adj.cols, adj.vals))
    m = sp.csr_matrix((vals, (rows, cols)), shape=(adj.n_nodes,) * 2)
    return sparse_csr(torch, np, m.T.tocsr() if transpose else m)


def plan_skew(torch, k2, label, p):
    """How the plan's edges fall on a row-tile split (one block per tile,
    warps owning ``row % SKEW_WARPS``) and on the schedule's spans."""
    real = p.vals != 0
    tile = p.chunk_tile.long()[:, None].expand_as(p.rows)[real]
    warp = tile * SKEW_WARPS + p.rows[real].long() % SKEW_WARPS
    sched = k2.spmm_schedule(p)
    span_edges = (sched.spans[:, 1] - sched.spans[:, 0]).float()
    pieces = int((sched.split[:, 2] - sched.split[:, 1]).sum())
    out = {"phase": "skew", "plan": label, "tile_r": p.tile_r, "chunk": int(p.rows.shape[1]),
           "tiles": p.n_tiles, "edges": int(real.sum()), "rows": p.n_rows,
           "heaviest_tile_edges": int(torch.bincount(tile, minlength=p.n_tiles).max()),
           "heaviest_warp_edges": int(torch.bincount(warp, minlength=p.n_tiles * SKEW_WARPS).max()),
           "max_row_degree": int((sched.row_ptr[1:] - sched.row_ptr[:-1]).max()),
           "spans": int(sched.spans.shape[0]), "span_size": k2.SPAN,
           "span_mean_edges": float(span_edges.mean()), "span_max_edges": int(span_edges.max()),
           "cut_rows": int(sched.split.shape[0]), "cut_pieces": pieces, "schedule_bytes": sched.nbytes}
    emit(out)


def hub_coo(np):
    """A square power-law graph made from the seed: Zipf row degrees capped
    at HUB_CAP, one hub row of HUB_DEGREE edges (~94 spans), values
    N(0, 1/degree) as a normalized adjacency scales a hub's."""
    rng = np.random.default_rng(SEED)
    deg = np.minimum(rng.zipf(HUB_ZIPF, HUB_NODES), HUB_CAP)
    deg[HUB_NODES // 3] = HUB_DEGREE
    rows = np.repeat(np.arange(HUB_NODES), deg).astype(np.int32)
    cols = rng.integers(0, HUB_NODES, rows.size).astype(np.int32)
    vals = (rng.standard_normal(rows.size) / np.sqrt(deg[rows])).astype(np.float32)
    return rows, cols, vals


def profile_steps(torch, step, n=10, tries=6):
    """``torch.profiler`` over ``n`` calls of ``step`` (``traced``): device
    time per kernel (their sum is the device's busy time; one stream, so
    kernels do not overlap) and host time per operator, per step, the
    largest first. A window that shows no kernel (the card's profiler now
    and then loses a window's kernel records, as ``device_ms`` says) is
    dropped and reported (``phase: profiler_window``) and another opened,
    up to ``tries``; None where none shows a kernel."""
    from torch.autograd import DeviceType

    for attempt in range(tries):
        prof, wall_ms = traced(torch, step, n)
        events = list(prof.key_averages())
        kernels, ops = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                # a user range on the device (Optimizer.step) spans kernels counted on their own
                if not getattr(e, "is_user_annotation", False):
                    kernels.append((e.self_device_time_total, e.key, e.count))
            elif e.self_cpu_time_total > 0:
                ops.append((e.self_cpu_time_total, e.key, e.count))
        if kernels:
            break
        emit({"phase": "profiler_window", "dropped": True, "attempt": attempt, "calls": n, "kernels": {},
              "host_events": {e.key[:40]: e.count for e in events if e.device_type != DeviceType.CUDA}})
    else:
        return None

    def top(rows):
        return [{"name": key[:90], "ms_per_step": us / n / 1e3, "calls_per_step": count / n}
                for us, key, count in sorted(rows, reverse=True)[:12]]

    return {"steps": n, "wall_ms_per_step_profiled": wall_ms / n,
            "device_ms_per_step": sum(k[0] for k in kernels) / n / 1e3,
            "kernel_launches_per_step": sum(k[2] for k in kernels) / n,
            "kernels": top(kernels), "host_ops": top(ops)}


def clone_state(trainer, params=None, opt=None):
    """A copy of the trainer's params and optimizer state (of ``params``
    and ``opt`` where given)."""
    from neurec_tpu_torch.bridge import map_params

    params_c = map_params(lambda v: v.detach().clone().requires_grad_(True),
                          trainer.params if params is None else params)
    opt_c = trainer.init_opt_state(params_c)
    opt_c.load_state_dict(copy.deepcopy((trainer.opt_state if opt is None else opt).state_dict()))
    return params_c, opt_c


def run_records(trainer):
    with open(trainer.logger.path + ".metrics.jsonl") as fin:
        return [json.loads(line) for line in fin]


def check_training(np, records, what, epochs=TRAIN_EPOCHS):
    """The loss checks of a run.main training: finite, falling."""
    losses = [r["loss"] for r in records]
    require(len(records) == epochs, "%s: run.main trained %d epochs" % (what, len(records)))
    require(all(np.isfinite(losses)), "%s: non-finite epoch loss: %s" % (what, losses))
    require(losses[-1] < losses[0], "%s: the epoch-%d loss %g is not below epoch 1's %g"
            % (what, len(losses), losses[-1], losses[0]))
    return losses


def train_summary(trainer, records, run_s, launches):
    steps, B = trainer.steps, trainer.model.batch_size
    epoch_s = [r["time_s"] for r in records]
    return {"epochs": len(records), "steps_per_epoch": steps, "batch_size": B,
            "train_interactions": trainer.n_positives, "pad_slots": steps * B - trainer.n_instances,
            "epoch_loss": [r["loss"] for r in records], "epoch_s": epoch_s,
            "train_examples_per_s": [trainer.n_positives / s for s in epoch_s],
            "epoch_ms_per_step": [1e3 * s / steps for s in epoch_s],
            "result_after_epoch": [r["metrics"]["values"] for r in records if "metrics" in r],
            "run_main_s": run_s, "launches": launches}


def kernel_vs_plain_steps(torch, trainer, draws, patches):
    """PLAIN_STEPS steps from the trainer's state through the kernels and
    again with ``patches`` (the plain versions), on the same draws (the
    step seeds included); fails beyond the tolerances."""
    from neurec_tpu_torch.bridge import param_leaves

    def some_steps():
        params_c, opt_c = clone_state(trainer)
        step_losses = []
        for s in range(PLAIN_STEPS):
            sl = slice(s, s + 1)
            step_losses.append(float(trainer.run_epoch(
                params_c, opt_c, draws.inst[sl], draws.w[sl], draws.negs[sl], draws.seeds[sl])[2]))
        return dict(param_leaves(params_c)), step_losses

    params_k, losses_k = some_steps()
    with contextlib.ExitStack() as stack:
        for obj, name, fn in patches:
            stack.enter_context(mock.patch.object(obj, name, fn))
        params_p, losses_p = some_steps()
    start = dict(param_leaves(trainer.params))
    with torch.no_grad():
        param_err = max(float((params_k[n] - params_p[n]).abs().max()) for n in params_k)
        moved = max(float((params_k[n] - start[n]).abs().max()) for n in params_k)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    out = {"steps": PLAIN_STEPS, "losses": losses_k, "plain_losses": losses_p,
           "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err, "param_max_abs_move": moved,
           "tol": "params atol %g, losses rtol %g" % (TRAIN_PARAM_ATOL, TRAIN_LOSS_RTOL)}
    require(all(torch.isfinite(torch.tensor(losses_k))) and moved > 0, "the kernel steps did not train")
    require(param_err <= TRAIN_PARAM_ATOL, "params differ from the plain path by %g" % param_err)
    require(loss_rel <= TRAIN_LOSS_RTOL, "step losses differ from the plain path by %g" % loss_rel)
    return out


def graph_draws(torch, trainer, steps, seed):
    """Draws for ``steps`` steps of the trainer's built-in epoch, made as
    ``draw_epoch`` makes them (one negative a slot from the exclusion
    sampler, a seed a step) over instances drawn from the whole epoch's,
    without drawing the whole epoch."""
    from neurec_tpu_torch.trainer import EpochDraws

    dev = trainer.device
    g = torch.Generator(device=dev).manual_seed(seed)
    B = trainer.model.batch_size
    inst = torch.randint(0, trainer.n_instances, (steps, B), generator=g, device=dev, dtype=torch.int32)
    w = torch.ones((steps, B), device=dev)
    if trainer._dense_row:
        negs = torch.zeros((steps, 0), dtype=torch.int32, device=dev)
    else:
        from neurec_tpu_torch.ops.sampling import sample_negatives

        users = trainer._users_flat[trainer._base(inst)]
        negs = torch.stack([sample_negatives(g, trainer._padded_items[users[s]], trainer.model.num_items, ())
                            for s in range(steps)])
    seeds = torch.randint(0, 2**62, (steps,), generator=g, device=dev).cpu()
    return EpochDraws(inst, w, negs, seeds)


def kept_calls_draws(torch, draws, call):
    """The draws of call ``call`` (from 0) of a kept-program check: the
    steps of ``draws`` rotated by ``call``, so that each call copies other
    tensors into the program's buffers."""
    from neurec_tpu_torch.trainer import EpochDraws

    return EpochDraws(*(torch.roll(a, call, 0) for a in draws))


def kept_record(trainer):
    """What a call leaves in the trainer's kept runs: the graphs they
    captured in it, the step counts of the graphs they hold and their
    pools' bytes (nothing where it ran eagerly)."""
    if not trainer._captures():
        return {}
    return {"captured": sum(k.captured for k in trainer.kept.values()),
            "held": sorted(c for k in trainer.kept.values() for c in k.graphs.graphs),
            "pool_bytes": sum(k.pool_bytes for k in trainer.kept.values())}


def graph_vs_eager(torch, label, trainer, draws, unrolls, counts=None, timing=False):
    """Phase 32 on one trainer: KEPT_CALLS epoch calls of the steps of
    ``draws`` (call ``c`` takes them rotated by ``c``, as epoch ``c + 1``)
    from a copy of the trainer's state, eagerly twice (``graphs=False``;
    the second a control) and as the trainer's kept program at each
    ``scan_unroll`` of ``unrolls`` (captured at the first call, replayed at
    the later ones). A kept run's losses, params and optimizer state must
    be the eager run's bit for bit, or, where the two eager runs differ
    too, within GRAPH_LOSS_RTOL and GRAPH_ATOL; its calls past the first
    must capture no graph (the first captures the remainder graph that the
    later calls of the same steps take).
    ``counts`` ``(fwd, bwd, n)``: each call launches
    ``n`` of each kernel a step. Each call gives its wall ms a step, the
    graphs it captured and the pools' bytes; each run its ms a step past
    the first step of its first call (CUDA events before the second step
    (eager) or the first replay and after the last, so the span holds
    steps 1..n-1 as the device ran them, any wait for the host included)
    and, over its later calls, its ms a step as replayed. ``timing`` adds
    the device ms a step (``torch.profiler`` over GRAPH_SHORT_STEPS steps,
    the kernels' summed time) and the card's idle share of a step past the
    first. APR also runs its kept program with ``adv_epoch`` 2 and without
    the adversarial term: the first call's losses equal, the later ones
    differ. The launch counts, the trainer's settings and its kept
    programs are put back or released."""
    from torch.autograd import DeviceType

    from neurec_tpu_torch import step_graph
    from neurec_tpu_torch.bridge import param_leaves
    from neurec_tpu_torch.ops import _build
    from neurec_tpu_torch.trainer import EpochDraws

    steps = int(draws.inst.shape[0])
    saved = dict(_build.LAUNCHES), trainer.graphs, trainer.scan_unroll
    t_check = time.perf_counter()

    def run(graphs, unroll, n, state=None, calls=KEPT_CALLS, start=0, record=None):
        trainer.graphs, trainer.scan_unroll = graphs, unroll
        params_c, opt_c = state or clone_state(trainer)
        losses, per_call, spans = [], [], []
        for c in range(start, start + calls):
            if record is not None:  # the state before each call, and after the last
                record.append(clone_state(trainer, params_c, opt_c))
            marks = []

            def mark():
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)

            if graphs:
                real_replay = step_graph._CudaGraphs.replay

                def replay(graph):
                    if not marks:
                        mark()
                    real_replay(graph)
                    mark()
                hook = mock.patch.object(step_graph._CudaGraphs, "replay", staticmethod(replay))
                spanned = n - 1 if c == 0 else n
            else:
                real_step, taken = trainer._step, []

                def step(*args):
                    if len(taken) == 1:
                        mark()
                    real_step(*args)
                    taken.append(1)
                    if len(taken) > 1:
                        mark()
                hook = mock.patch.object(trainer, "_step", step)
                spanned = n - 1
            _build.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with hook:
                loss = trainer.run_epoch(params_c, opt_c, *EpochDraws(*(a[:n] for a in kept_calls_draws(
                    torch, draws, c))), epoch=c + 1)[2]
            torch.cuda.synchronize()
            losses.append(loss)
            span = marks[0].elapsed_time(marks[-1]) / spanned if len(marks) > 1 else None
            spans.append(span)
            per_call.append(dict(wall_ms_per_step=(time.perf_counter() - t) * 1e3 / n, ms_per_step_spanned=span,
                                 launches=dict(_build.LAUNCHES), **kept_record(trainer)))
        if record is not None:
            record.append(clone_state(trainer, params_c, opt_c))
        out = {"loss": torch.stack(losses), **result_of(params_c, opt_c), "calls": per_call, "span_ms": spans[0],
               "kept_span_ms": (sum(spans[1:]) / len(spans[1:])) if len(spans) > 1 and None not in spans else None}
        trainer.release_kept()
        return out

    def result_of(params, opt):
        return {"params": dict(param_leaves(params)), "opt": opt.state_dict()["state"]}

    def diff(a, b):
        floats = [(x, b["opt"][i][k]) for i, st in a["opt"].items() for k, x in st.items()
                  if isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim()]
        pairs = [(a["params"][k], b["params"][k]) for k in a["params"]] + floats
        rel = (a["loss"].double() - b["loss"].double()).abs() / b["loss"].double().abs().clamp(min=1e-30)
        return {"equal_bits": bool(torch.equal(a["loss"], b["loss"]) and all(torch.equal(x, y) for x, y in pairs)
                                   and all(float(x.get("step", 0)) == float(b["opt"][i].get("step", 0))
                                           for i, x in a["opt"].items())),
                "loss_rel_diff": float(rel.max()),
                "param_max_abs_diff": max(float((x.float() - y.float()).abs().max()) for x, y in pairs if x.numel())}

    configs = [("eager", False, 1)] + [("graph_u%d" % u, True, u) for u in unrolls]
    rec = {"phase": "graph_check", "path": label, "model": trainer.model.name, "data_kind": trainer.model.data_kind,
           "steps": steps, "calls": KEPT_CALLS, "batch_size": trainer.model.batch_size,
           "steps_per_epoch": trainer.steps}
    try:
        runs = {"eager": run(False, 1, steps)}
        control = diff(run(False, 1, steps), runs["eager"])
        states = {}
        for name, g, u in configs[1:]:
            # where eager runs differ, each call is held to an eager call
            # from the kept run's state before it: the calls' sums compound
            states[name] = None if control["equal_bits"] else []
            runs[name] = run(g, u, steps, record=states[name])
        rec["eager_vs_eager"] = control
        rec["loss"] = [float(x) for x in runs["eager"]["loss"]]
        for name, g, u in configs:
            r = runs[name]
            rec[name] = {"wall_ms_per_step": r["calls"][0]["wall_ms_per_step"],
                         "ms_per_step_past_first": r["span_ms"], "ms_per_step_kept": r["kept_span_ms"],
                         "calls": [{k: v for k, v in call.items() if k != "launches"} for call in r["calls"]]}
            if counts is not None:
                fwd, bwd, n = counts
                rec[name]["launches"] = [{fwd: call["launches"][fwd], bwd: call["launches"][bwd]}
                                         for call in r["calls"]]
                for call in r["calls"]:
                    require((call["launches"][fwd], call["launches"][bwd]) == (n * steps, n * steps),
                            "%s %s: launches %s, expected %d %s and %d %s a step"
                            % (label, name, call["launches"], n, fwd, n, bwd))
            if g:
                d = rec[name]["vs_eager"] = diff(r, runs["eager"])
                later = [call["captured"] for call in r["calls"][1:]]
                require(r["calls"][0]["captured"] > 0 or steps == 1, "%s %s: the first call captured no graph"
                        % (label, name))
                require(not any(later), "%s %s: calls past the first captured %s graphs" % (label, name, later))
                if control["equal_bits"]:
                    require(d["equal_bits"], "%s %s: the kept program's calls differ from the eager ones (%s) "
                            "where two eager runs agree to the bit" % (label, name, d))
                else:
                    rec[name]["differs"] = ("eager runs differ as well: an op that adds in no fixed order; each "
                                            "call held to an eager call from the kept run's state before it")
                    by_call = rec[name]["vs_eager_by_call"] = [
                        diff({"loss": r["loss"][c:c + 1], **result_of(*states[name][c + 1])},
                             run(False, 1, steps, clone_state(trainer, *states[name][c]), calls=1, start=c))
                        for c in range(KEPT_CALLS)]
                    require(all(x["loss_rel_diff"] <= GRAPH_LOSS_RTOL and x["param_max_abs_diff"] <= GRAPH_ATOL
                                for x in by_call),
                            "%s %s: the kept program's calls are %s from eager calls from the same states"
                            % (label, name, by_call))
            if timing:
                states = [clone_state(trainer) for _ in range(2)]  # the profiled window copies nothing
                prof = traced(torch, lambda: run(g, u, GRAPH_SHORT_STEPS, states.pop(), calls=1), 1)[0]
                kernels = [e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
                device = sum(e.self_device_time_total for e in kernels) / 1e3 / GRAPH_SHORT_STEPS if kernels else None
                rec[name].update(device_ms_per_step=device,
                                 kernels_per_step=sum(e.count for e in kernels) / GRAPH_SHORT_STEPS,
                                 idle_share=None if device is None else 1.0 - device / r["span_ms"])
        model = trainer.model
        if getattr(model, "adver", False) and hasattr(model, "adv_epoch"):
            keep = model.adv_epoch, model.reg_adv
            try:
                model.adv_epoch = 2
                on = run(True, 1, steps)["loss"]
                model.reg_adv = 0.0
                off = run(True, 1, steps)["loss"]
            finally:
                model.adv_epoch, model.reg_adv = keep
            rec["adv_switch"] = {"adv_epoch": 2, "losses": [float(x) for x in on],
                                 "losses_without_adv": [float(x) for x in off]}
            require(torch.equal(on[0], off[0]) and not torch.equal(on[1], off[1])
                    and not torch.equal(on[2], off[2]),
                    "%s: the kept program's adversarial term is not off at epoch 1 and on at 2 and 3: %s"
                    % (label, rec["adv_switch"]))
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved[0])
        trainer.graphs, trainer.scan_unroll = saved[1], saved[2]
        trainer.release_kept()
    rec["seconds"] = time.perf_counter() - t_check
    emit(rec)
    return rec


def kept_train(torch, trainer):
    """The north star's ``Trainer.train`` for KEPT_TRAIN_EPOCHS whole
    epochs from the seed of ``trainer`` (its model, data and config; one
    evaluation, after the last epoch), twice: each epoch's wall ms a step,
    graphs captured, pool bytes and loss, then again under
    ``torch.profiler`` for each epoch's device ms a step (the kernels'
    summed time), and the idle share of the unprofiled epoch. The first
    epoch must capture and the later ones must not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import numpy as np

    from neurec_tpu_torch.trainer import Trainer

    model = trainer.model
    saved = model.epochs, model.verbose
    t_check = time.perf_counter()

    def train(profiled):
        t = Trainer(model, trainer.dataset, trainer.config, logger=SilentLogger(), seed=trainer.seed,
                    device=trainer.device)
        epochs, real = [], t.train_epoch

        def train_epoch(epoch, max_steps=None):
            torch.cuda.synchronize()
            start = time.perf_counter()
            if profiled:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out = real(epoch, max_steps)
                    torch.cuda.synchronize()
                kernels = [e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
                rec = {"device_ms_per_step": sum(e.self_device_time_total for e in kernels) / 1e3 / t.steps,
                       "kernels_per_step": sum(e.count for e in kernels) / t.steps}
            else:
                out = real(epoch, max_steps)
                torch.cuda.synchronize()
                rec = {"wall_ms_per_step": (time.perf_counter() - start) * 1e3 / t.steps}
            kept = t.kept["epoch"]
            rec.update(epoch=epoch, captured=kept.captured, calls=kept.calls, pool_bytes=kept.pool_bytes,
                       loss=float(out[2]))
            epochs.append(rec)
            return out

        t.train_epoch = train_epoch
        result = t.train()
        t.release_kept()
        return epochs, result, t.steps

    try:
        model.epochs = model.verbose = KEPT_TRAIN_EPOCHS
        plain, result, steps = train(False)
        profiled, result_p, _ = train(True)
    finally:
        model.epochs, model.verbose = saved
    for rec, prof in zip(plain, profiled):
        rec.update(device_ms_per_step=prof["device_ms_per_step"], kernels_per_step=prof["kernels_per_step"],
                   idle_share=1.0 - prof["device_ms_per_step"] / rec["wall_ms_per_step"],
                   profiled_wall_loss_equal=rec["loss"] == prof["loss"])
    out = {"phase": "kept_train", "model": model.name, "steps_per_epoch": steps, "batch_size": model.batch_size,
           "epochs": plain, "result": result, "profiled_result_equal": result == result_p,
           "seconds": time.perf_counter() - t_check}
    emit(out)
    captured = [r["captured"] for r in plain + profiled]
    require(len(plain) == KEPT_TRAIN_EPOCHS and all(np.isfinite(r["loss"]) for r in plain),
            "kept_train: epochs %s" % plain)
    require(plain[0]["captured"] > 0 and profiled[0]["captured"] > 0 and not any(
        r["captured"] for r in plain[1:] + profiled[1:]), "kept_train: graphs captured by epoch: %s" % captured)
    require(all(0 <= float(v) <= 1 for v in parse_metrics(result)), "kept_train: result %s" % result)
    return out


def clone_custom_state(trainer, params=None, opt=None):
    """A copy of a custom-epoch trainer's params and of its optimizer (a
    dict of them: CFGAN's ``{"g", "d"}``, IRGAN's none); of ``params`` and
    ``opt`` where given."""
    from neurec_tpu_torch.bridge import map_params

    params_c = map_params(lambda v: v.detach().clone().requires_grad_(v.is_floating_point()),
                          trainer.params if params is None else params)
    opt_c = trainer.init_opt_state(params_c)
    opt = trainer.opt_state if opt is None else opt
    pairs = zip(opt_c.values(), opt.values()) if isinstance(opt_c, dict) else [(opt_c, opt)]
    for mine, theirs in pairs:
        mine.load_state_dict(copy.deepcopy(theirs.state_dict()))
    return params_c, opt_c


def custom_graph_check(torch, label, trainer):
    """Phase 33 on one custom-epoch trainer: KEPT_CALLS calls of its epoch
    (epochs GRAPH_CUSTOM_EPOCH, GRAPH_CUSTOM_EPOCH + 1, ...), each cut to
    GRAPH_CUSTOM_STEPS steps of each pass (``train_epoch(max_steps)``),
    from copies of the trainer's state, eagerly twice (``graphs=False``;
    the second a control) and through the trainer's kept programs at each
    of GRAPH_CUSTOM_UNROLLS (a program a run of steps, captured at its
    first call). A kept run's losses, params and optimizer state must be
    the eager run's bit for bit, or, where the two eager runs differ too
    (a backward that adds through atomics), within GRAPH_LOSS_RTOL and
    GRAPH_ATOL; its calls past the first must capture no graph where every
    pass takes the same steps in every call (a remainder graph of a count
    not seen before is captured when it is first needed). Each call gives its wall ms a
    step (the whole epoch call: its draws, the warm-up steps and the
    captures included), the graphs captured and the pools' bytes; each run
    its ms a step past the first of its first call (CUDA events before
    each pass's second step (eager) or first replay (kept) and after its
    last, summed over the passes) and, over its later calls, as replayed.
    The kept run at scan_unroll 1 also gives the device ms a step past the
    first (``torch.profiler``: the kernels' summed time over the cut epoch
    less a 1-step one) and the kernels a step; the eager steps run the
    same kernels (bit-equal results), so each run's idle share reads that
    device time against its ms a step past the first; a replay holds
    ``scan_unroll`` steps' kernels. The launch counts, the trainer's
    settings and its kept programs are put back or released."""
    from torch.autograd import DeviceType

    from neurec_tpu_torch import step_graph
    from neurec_tpu_torch.bridge import param_leaves
    from neurec_tpu_torch.ops import _build

    saved = dict(_build.LAUNCHES), trainer.graphs, trainer.scan_unroll
    t_check = time.perf_counter()
    real_run, real_kept_run = step_graph.run_steps, step_graph._StepGraphs.run
    real_replay = step_graph._CudaGraphs.replay

    def marker(marks):
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        return mark

    def timed(passes):
        """``step_graph.run_steps`` (eager) and ``_StepGraphs.run`` (kept)
        with CUDA events around steps 1..n-1, or around every step of a
        later call's replays; each pass's ``(marks, steps spanned, n)``."""
        def run_steps(step, n, seeds, device):
            marks, taken = [], []
            mark = marker(marks)

            def timed_step(gen):
                if len(taken) == 1:
                    mark()
                step(gen)
                taken.append(1)
                if len(taken) > 1:
                    mark()
            real_run(timed_step, n, seeds, device)
            passes.append((marks, n - 1, n))

        def kept_run(self, n, seeds):
            marks = []
            mark = marker(marks)
            spanned = n - 1 if self.width is None else n

            def replay(graph):
                if not marks:
                    mark()
                real_replay(graph)
                mark()
            with mock.patch.object(step_graph._CudaGraphs, "replay", staticmethod(replay)):
                real_kept_run(self, n, seeds)
            passes.append((marks, spanned, n))
        return [mock.patch.object(step_graph, "run_steps", run_steps),
                mock.patch.object(step_graph._StepGraphs, "run", kept_run)]

    def opt_tensors(opt):
        opts = opt.values() if isinstance(opt, dict) else [opt]
        return [v for o in opts for p in o.state for v in o.state[p].values() if isinstance(v, torch.Tensor)]

    def run(graphs, unroll, steps, state=None, timing=True, calls=KEPT_CALLS, start=0, record=None):
        trainer.graphs, trainer.scan_unroll = graphs, unroll
        params_c, opt_c = state or clone_custom_state(trainer)
        losses, per_call, spans = [], [], []
        for c in range(start, start + calls):
            if record is not None:  # the state before each call, and after the last
                record.append(clone_custom_state(trainer, params_c, opt_c))
            passes = []
            _build.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for patch in timed(passes) if timing else []:
                    stack.enter_context(patch)
                epoch = GRAPH_CUSTOM_EPOCH + c
                params_c, opt_c, loss = trainer._epoch_fn(params_c, opt_c, trainer.epoch_generator(epoch), epoch,
                                                          max_steps=steps)
            torch.cuda.synchronize()
            losses.append(loss)
            done = [(m[0].elapsed_time(m[-1]), k) for m, k, _ in passes if len(m) > 1]
            spans.append(sum(ms for ms, _ in done) / max(sum(k for _, k in done), 1) if done else None)
            pass_steps = [n for _, _, n in passes]
            per_call.append(dict(pass_steps=pass_steps,
                                 wall_ms_per_step=(time.perf_counter() - t) * 1e3 / max(sum(pass_steps), 1),
                                 ms_per_step_spanned=spans[-1],
                                 launches={k: v for k, v in _build.LAUNCHES.items() if v}, **kept_record(trainer)))
        if record is not None:
            record.append(clone_custom_state(trainer, params_c, opt_c))
        later = [x for x in spans[1:] if x is not None]
        trainer.release_kept()
        return {"loss": torch.stack(losses), "tensors": tensors_of(params_c, opt_c),
                "calls": per_call, "span_ms": spans[0], "kept_span_ms": sum(later) / len(later) if later else None}

    def tensors_of(params, opt):
        return [p.detach() for _, p in param_leaves(params)] + opt_tensors(opt)

    def diff(a, b):
        pairs = list(zip(a["tensors"], b["tensors"]))
        rel = (a["loss"].double() - b["loss"].double()).abs() / b["loss"].double().abs().clamp(min=1e-30)
        return {"equal_bits": bool(len(a["tensors"]) == len(b["tensors"]) and torch.equal(a["loss"], b["loss"])
                                   and all(torch.equal(x, y) for x, y in pairs)),
                "loss_rel_diff": float(rel.max()),
                "param_max_abs_diff": max(float((x.float() - y.float()).abs().max()) for x, y in pairs if x.numel())}

    def device(graphs, unroll, pass_steps):
        """Device ms and kernels a step past the first, from the profiler."""
        out = []
        for steps in (GRAPH_CUSTOM_STEPS, 1):
            states = [clone_custom_state(trainer) for _ in range(2)]  # the profiled window copies nothing
            prof = traced(torch, lambda: run(graphs, unroll, steps, states.pop(), timing=False, calls=1), 1)[0]
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
            out.append((sum(e.self_device_time_total for e in kernels) / 1e3, sum(e.count for e in kernels)))
        past_first = sum(pass_steps) - len(pass_steps)
        return (out[0][0] - out[1][0]) / past_first, (out[0][1] - out[1][1]) / past_first

    configs = [("eager", False, 1)] + [("graph_u%d" % u, True, u) for u in GRAPH_CUSTOM_UNROLLS]
    rec = {"phase": "graph_custom_check", "path": label, "model": trainer.model.name, "steps": GRAPH_CUSTOM_STEPS,
           "epochs": [GRAPH_CUSTOM_EPOCH + c for c in range(KEPT_CALLS)]}
    try:
        runs = {"eager": run(False, 1, GRAPH_CUSTOM_STEPS)}
        control = diff(run(False, 1, GRAPH_CUSTOM_STEPS), runs["eager"])
        states = {}
        for name, g, u in configs[1:]:
            # where eager runs differ, each call is held to an eager call
            # from the kept run's state before it: the calls' sums compound
            # (IRGAN's through its sampled negatives and samples)
            states[name] = None if control["equal_bits"] else []
            runs[name] = run(g, u, GRAPH_CUSTOM_STEPS, record=states[name])
        eager_steps = [c["pass_steps"] for c in runs["eager"]["calls"]]
        rec.update(eager_vs_eager=control, loss=[float(x) for x in runs["eager"]["loss"]], pass_steps=eager_steps)
        for name, g, u in configs:
            r = runs[name]
            rec[name] = {"wall_ms_per_step": r["calls"][0]["wall_ms_per_step"],
                         "ms_per_step_past_first": r["span_ms"], "ms_per_step_kept": r["kept_span_ms"],
                         "calls": [{k: v for k, v in c.items() if k != "pass_steps"} for c in r["calls"]]}
            got_steps = [c["pass_steps"] for c in r["calls"]]
            require(got_steps == eager_steps and min(eager_steps[0]) > 1,
                    "%s %s: passes of %s steps, eager %s" % (label, name, got_steps, eager_steps))
            if g:
                d = rec[name]["vs_eager"] = diff(r, runs["eager"])
                later = [c["captured"] for c in r["calls"][1:]]
                require(r["calls"][0]["captured"] > 0, "%s %s: the first call captured no graph" % (label, name))
                if all(call == got_steps[0] for call in got_steps):  # no count of steps new past the first call
                    require(not any(later), "%s %s: calls past the first captured %s graphs" % (label, name, later))
                if control["equal_bits"]:
                    require(d["equal_bits"], "%s %s: the kept programs' calls differ from the eager ones (%s) where "
                            "two eager runs agree to the bit" % (label, name, d))
                else:
                    rec[name]["differs"] = ("eager runs differ as well: an op that adds in no fixed order; each "
                                            "call held to an eager call from the kept run's state before it")
                    by_call = rec[name]["vs_eager_by_call"] = [
                        diff({"loss": r["loss"][c:c + 1], "tensors": tensors_of(*states[name][c + 1])},
                             run(False, 1, GRAPH_CUSTOM_STEPS, clone_custom_state(trainer, *states[name][c]),
                                 timing=False, calls=1, start=c))
                        for c in range(KEPT_CALLS)]
                    require(all(x["loss_rel_diff"] <= GRAPH_LOSS_RTOL and x["param_max_abs_diff"] <= GRAPH_ATOL
                                for x in by_call),
                            "%s %s: the kept programs' calls are %s from eager calls from the same states"
                            % (label, name, by_call))
        dev_ms, kernels = device(True, 1, eager_steps[0])
        rec.update(device_ms_per_step=dev_ms, kernels_per_step=kernels)
        for name, g, u in configs:
            rec[name]["idle_share"] = 1.0 - dev_ms / rec[name]["ms_per_step_past_first"]
            if g:
                rec[name]["kernels_per_replay"] = kernels * u
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved[0])
        trainer.graphs, trainer.scan_unroll = saved[1], saved[2]
        trainer.release_kept()
    rec["seconds"] = time.perf_counter() - t_check
    emit(rec)
    return rec


def _replay_counter(step_graph):
    """A patch of ``_CudaGraphs.replay`` that counts the graph launches in
    a list it returns beside it."""
    real, replays = step_graph._CudaGraphs.replay, []

    def replay(graph):
        replays.append(1)
        real(graph)
    return mock.patch.object(step_graph._CudaGraphs, "replay", staticmethod(replay)), replays


def _device_ms(torch, fn):
    """The summed device time of the CUDA kernels of one call of ``fn``
    (``traced``), or None where the window kept none."""
    from torch.autograd import DeviceType

    kernels = [e for e in traced(torch, fn, 1)[0].key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sum(e.self_device_time_total for e in kernels) / 1e3 if kernels else None


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def eval_graph_check(torch, label, trainer, paths, n_users=None, sync_check=False):
    """Phase 34 beside a path's trainer: its evaluation by two fresh
    evaluators, ``graphs=False`` and the default (CUDA graphs kept across
    calls where the model allows), a cold call and ``EVAL_GRAPH_WARM`` warm
    ones each, over all test users or the first ``n_users``. Each mode's
    seconds a call, its kernels' launches a call, its graph launches a
    warm call, the device ms of a warm call (profiler), the card's idle
    share over it (1 - device ms / the warm call's median wall ms) and its
    programs' pool bytes; the metric strings and every recorded top-K id
    must be equal and the captured mode's kernels launched as often as the
    eager mode's. The captured mode's launches are the path
    ``eval_graph_<label>``. With ``sync_check`` a warm replay runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import numpy as np

    from neurec_tpu_torch import step_graph
    from neurec_tpu_torch.eval import Evaluator
    from neurec_tpu_torch.ops import _build

    t_check = time.perf_counter()
    saved = dict(_build.LAUNCHES)
    model, params = trainer.model, trainer.params
    counting, replays = _replay_counter(step_graph)
    rec = {"phase": "eval_graph_check", "path": label, "model": model.name}
    runs = {}
    try:
        with counting:
            for mode, graphs in (("eager", False), ("graph", True)):
                ev = Evaluator.from_dataset(trainer.dataset, trainer.config, graphs=graphs).evaluator
                users = None if n_users is None else ev.test_users[:n_users]
                ev.record_ids = True

                def call():
                    return ev.evaluate(model.predict, params, users)

                _build.reset_launches()
                secs, launches, graph_launches = [], [], []
                for _ in range(1 + EVAL_GRAPH_WARM):
                    before, n_replays = dict(_build.LAUNCHES), len(replays)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    result = call()
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t)
                    launches.append(_delta(_build.LAUNCHES, before))
                    graph_launches.append(len(replays) - n_replays)
                if graphs:
                    paths["eval_graph_" + label] = dict(_build.LAUNCHES)
                warm_ms = float(np.median(secs[1:])) * 1e3
                device = _device_ms(torch, call)
                n_batches = sum(k.batches[0].shape[0] for k in ev._kept.values())
                runs[mode] = {"result": result, "ids": ev.last_ids.cpu(), "n_batches": n_batches}
                rec[mode] = {"eval_cold_s": secs[0], "eval_warm_s": secs[1:], "launches_cold": launches[0],
                             "launches_warm": launches[1], "graph_launches_per_warm_call": graph_launches[1],
                             "device_ms": device, "idle_share": None if device is None else 1.0 - device / warm_ms,
                             "pool_bytes": [k.program.pool_bytes for k in ev._kept.values()]}
                if graphs and sync_check:
                    (kept,) = ev._kept.values()
                    kept.args["params"] = params
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        kept.program.run(n_batches)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                        kept.args["params"] = None
                    torch.cuda.synchronize()
                    rec[mode]["sync_debug"] = "quiet over a warm replay"
                del ev
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)
    eager, graph = runs["eager"], runs["graph"]
    rec.update(eval_users=int(eager["ids"].shape[0]), n_batches=eager["n_batches"], result=graph["result"],
               equal=graph["result"] == eager["result"] and torch.equal(graph["ids"], eager["ids"]),
               seconds=time.perf_counter() - t_check)
    emit(rec)
    require(rec["equal"], "%s: the captured evaluation differs from the eager one" % label)
    require(rec["graph"]["launches_warm"] == rec["eager"]["launches_warm"] == rec["eager"]["launches_cold"]
            == rec["graph"]["launches_cold"], "%s: kernel launches a call differ: %s" % (label, rec))
    want = eager["n_batches"] + 1
    require(rec["graph"]["graph_launches_per_warm_call"] == want and rec["eager"]["graph_launches_per_warm_call"] == 0,
            "%s: %d graph launches a warm call, expected %d" % (label, rec["graph"]["graph_launches_per_warm_call"],
                                                               want))
    return rec


def serving_graph_check(torch, model, params, requests, train_matrix, paths, label="serve_graph"):
    """Phase 34's serving: ``requests`` (the phase-4 ones, or NAIS's)
    through ``batch_topk`` with ``graphs=False`` and by default (the export
    captured per request size and kept per model), from an empty cache:
    seconds a request (the first cold), device ms of a warm request, graph
    launches a warm request, pool bytes a program; the ids and scores
    equal. The captured mode's launches are the path ``label``."""
    import numpy as np

    from neurec_tpu_torch import recommend, step_graph
    from neurec_tpu_torch.ops import _build
    from neurec_tpu_torch.recommend import batch_topk

    saved = dict(_build.LAUNCHES)
    counting, replays = _replay_counter(step_graph)
    rec, outs = {"phase": "serving_graph_check", "path": label, "model": model.name, "requests": len(requests),
                 "users_per_request": SERVING_USERS, "k": SERVING_K}, {}
    try:
        with counting:
            for mode, graphs in (("eager", False), ("graph", True)):
                for key in [k for k in recommend._EXPORT_CACHE if k[0] == id(model)]:
                    recommend._release(key)

                def serve(req):
                    return batch_topk(model, params, SERVING_K, users=req, train_matrix=train_matrix,
                                      batch_size=SERVING_USERS, graphs=graphs)

                _build.reset_launches()
                secs, out, graph_launches = [], [], []
                for req in requests:
                    n_replays = len(replays)
                    t = time.perf_counter()
                    out.append(serve(req))
                    secs.append(time.perf_counter() - t)
                    graph_launches.append(len(replays) - n_replays)
                if graphs:
                    paths[label] = dict(_build.LAUNCHES)
                warm_ms = float(np.median(secs[1:])) * 1e3
                device = _device_ms(torch, lambda: serve(requests[-1]))
                exports = [e for k, e in recommend._EXPORT_CACHE.items() if k[0] == id(model)]
                outs[mode] = out
                rec[mode] = {"serving_request_s": secs, "graph_launches_per_request": graph_launches,
                             "device_ms": device, "idle_share": None if device is None else 1.0 - device / warm_ms,
                             "programs": len(exports), "pool_bytes": [e.program.pool_bytes for e in exports]}
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)
    rec["equal"] = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                       for a, b in zip(outs["eager"], outs["graph"]))
    emit(rec)
    require(rec["equal"], "%s: the captured export differs from the eager one" % label)
    return rec


def edge_eval(torch, trainer, result_cold, cold_s):
    """Path D's NAIS or DeepICF over all test users, scored over their
    batches' train edges: after the cold call (``result_cold`` in
    ``cold_s``: eager, then the captures) a warm call (replays) and the
    device ms of another (profiler), the idle share, users/s, the
    capacity E_max against the batches' exact edge count (the real users'
    train pairs) and the slots the padding adds, and the program's pool
    bytes; the warm call's metric string must be the cold one's."""
    import numpy as np

    ev, model, params = trainer.evaluator.evaluator, trainer.model, trainer.params

    def call():
        return ev.evaluate(model.predict, params)

    torch.cuda.synchronize()
    t = time.perf_counter()
    result = call()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    device = _device_ms(torch, call)
    (kept,) = ev._kept.values()
    users_b, valid = kept.batches[0].cpu().numpy(), kept.batches[2].cpu().numpy()
    capacity = model.predict_capacity(users_b, valid)
    exact = int((model._lens_host[users_b] * valid).sum())
    rec = {"eval_users": len(ev.test_users), "n_batches": int(users_b.shape[0]), "batch_size": int(users_b.shape[1]),
           "eval_cold_s": cold_s, "eval_warm_s": warm_s, "device_ms": device,
           "idle_share": None if device is None else 1.0 - device / (warm_s * 1e3),
           "eval_users_per_s": len(ev.test_users) / warm_s, "e_max": capacity,
           "edges_exact": exact, "edge_slots": capacity * int(users_b.shape[0]),
           "slots_per_edge": capacity * int(users_b.shape[0]) / max(exact, 1),
           "captured": kept.program.capture and kept.program._graphs is not None,
           "pool_bytes": kept.program.pool_bytes, "warm_equals_cold": result == result_cold}
    require(rec["captured"], "%s: its evaluation was not captured" % model.name)
    require(rec["warm_equals_cold"], "%s: the warm evaluation differs from the cold one" % model.name)
    return rec


def step_ms(torch, trainer, draws):
    """CUDA-event time of one training step (forward, backward, Adam)."""
    params_c, opt_c = clone_state(trainer)
    sl = slice(0, 1)
    return time_ms(torch, lambda: trainer.run_epoch(params_c, opt_c, draws.inst[sl], draws.w[sl],
                                                    draws.negs[sl], draws.seeds[sl]), iters=10)


def ml1m_seeded_rows(np):
    """Path G's rating rows ``(users, items, ratings, times)``: per-user
    counts of a log-normal tail from ML1M_MIN_PER_USER to ML1M_MAX_PER_USER
    summing to ML1M_RATINGS, each user's items a seeded Markov walk without
    repeats (see ML1M_FOLLOW), times increasing along the walk."""
    rng = np.random.RandomState(SEED)
    U, I, R = ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS
    counts = lognormal_counts(np, rng, U, R, ML1M_MIN_PER_USER, ML1M_MAX_PER_USER)
    cdf = np.cumsum(1.0 / np.arange(1, I + 1) ** ML1M_ZIPF)
    item_of_rank = rng.permutation(I)
    successors = rng.randint(0, I, (I, ML1M_SUCCESSORS))
    pool = item_of_rank[np.searchsorted(cdf / cdf[-1], rng.rand(8 * R))].tolist()
    follow = (rng.rand(R) < ML1M_FOLLOW).tolist()
    pick = rng.randint(0, ML1M_SUCCESSORS, R).tolist()
    succ = successors.tolist()
    seen = [-1] * I
    items, p, k = [], 0, 0
    for u, n in enumerate(counts.tolist()):
        cur = -1
        for _ in range(n):
            nxt = succ[cur][pick[k]] if cur >= 0 and follow[k] else -1
            k += 1
            while nxt < 0 or seen[nxt] == u:  # a popularity draw, not yet in the walk
                if p == len(pool):
                    pool, p = item_of_rank[np.searchsorted(cdf / cdf[-1], rng.rand(R))].tolist(), 0
                nxt = pool[p]
                p += 1
            seen[nxt] = u
            items.append(nxt)
            cur = nxt
    users = np.repeat(np.arange(U), counts)
    times = 978_300_000 + np.arange(R)
    return users, np.asarray(items), rng.randint(1, 6, R), times


def lognormal_counts(np, rng, users, ratings, low, high):
    """Per-user rating counts of a log-normal tail from ``low`` to ``high``
    summing to ``ratings`` (path G's draw)."""
    raw = rng.lognormal(0.0, 1.2, users)
    counts = np.minimum(low + np.floor(raw / raw.sum() * (ratings - low * users)).astype(np.int64), high)
    while counts.sum() < ratings:  # the floors' remainder, to users below the cap
        room = np.flatnonzero(counts < high)
        counts[rng.choice(room, min(int(ratings - counts.sum()), len(room)), replace=False)] += 1
    return counts


def social_graph(np, user_keys):
    """Path H's friendship edges over ``user_keys``, both ways: degrees from
    a discrete power law on [1, SOCIAL_MAX_DEGREE] with loc-Gowalla's mean,
    its exponent found by bisection, wired by a configuration model."""
    k = np.arange(1, SOCIAL_MAX_DEGREE + 1, dtype=np.float64)
    target = 2.0 * SOCIAL_EDGES / SOCIAL_NODES
    lo, hi = 1.0, 4.0
    for _ in range(60):
        alpha = (lo + hi) / 2
        p = k ** -alpha
        lo, hi = (alpha, hi) if (k * p).sum() / p.sum() > target else (lo, alpha)
    rng = np.random.RandomState(SEED)
    deg = rng.choice(k.astype(np.int64), size=len(user_keys), p=p / p.sum())
    stubs = rng.permutation(np.repeat(np.arange(len(user_keys)), deg))
    pairs = stubs[: len(stubs) // 2 * 2].reshape(-1, 2)
    pairs = np.unique(np.sort(pairs[pairs[:, 0] != pairs[:, 1]], axis=1), axis=0)
    keys = np.asarray(user_keys)
    both = np.concatenate([pairs, pairs[:, ::-1]])
    realized = np.bincount(both[:, 0], minlength=len(user_keys))
    return keys[both[:, 0]], keys[both[:, 1]], {
        "alpha": alpha, "target_mean_degree": target, "drawn_mean_degree": float(deg.mean()),
        "mean_degree": float(realized.mean()), "max_degree": int(realized.max()),
        "undirected_edges": int(len(pairs)), "lines": int(len(both))}


def ml10m_seeded(torch, np, sp, device="cuda"):
    """Path I's (train, test) CSR matrices, made on the card in chunks of
    users: Gumbel top-k over the items' log-popularity draws each user's
    items without repeats, a second uniform key takes 80% of them (rounded
    up) to train."""
    rng = np.random.RandomState(SEED)
    U, I = ML10M_USERS, ML10M_ITEMS
    counts = lognormal_counts(np, rng, U, ML10M_RATINGS, ML10M_MIN_PER_USER, ML10M_MAX_PER_USER)
    logp = torch.from_numpy(-ML10M_ZIPF * np.log(np.arange(1, I + 1))[rng.permutation(I)]).float().to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    parts = {True: [], False: []}
    for lo in range(0, U, 2048):
        c = torch.from_numpy(counts[lo:lo + 2048]).to(device)
        n = c.shape[0]
        gumbel = -torch.log(-torch.log(torch.rand((n, I), generator=gen, device=device).clamp_min(1e-30)))
        order = torch.argsort(logp + gumbel, dim=1, descending=True)
        chosen = torch.arange(I, device=device)[None, :] < c[:, None]
        r2 = torch.where(chosen, torch.rand((n, I), generator=gen, device=device), 2.0)
        rank2 = torch.argsort(torch.argsort(r2, dim=1), dim=1)
        train = rank2 < torch.ceil(0.8 * c.double()).long()[:, None]
        users = torch.arange(lo, lo + n, device=device)[:, None].expand(n, I)
        for flag, sel in ((True, chosen & train), (False, chosen & ~train)):
            parts[flag].append((users[sel].cpu().numpy(), order[sel].cpu().numpy()))

    def csr(flag):
        rows = np.concatenate([r for r, _ in parts[flag]])
        cols = np.concatenate([c for _, c in parts[flag]])
        return sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(U, I))

    return csr(True), csr(False), counts


def trace_events(path):
    """What the Chrome trace at ``path`` holds: its events, its kernel
    events, those of K1 (``masked_scores``, any of its kernels) and K2
    (``span_spmm_kernel``) by name, K2's split into forward and backward
    (``plan_spmm[bwd]``: its launch, found by the runtime event of the same
    ``correlation``, inside an ``autograd`` range of ``PlanSpmmBackward`` on
    the launching thread), the K2 kernels of CUDA-graph replays
    (``plan_spmm[replayed]``: launched by a ``cudaGraphLaunch``, forward
    and backward alike, as a replay has no autograd range), and the K2
    kernels whose launch was not found."""
    with open(path) as fin:
        events = json.load(fin)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    bwd = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "PlanSpmmBackward" in e.get("name", ""):
            bwd.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e.get("dur", 0)))
    by_name = {"masked_scores": 0, "plan_spmm": 0, "plan_spmm[bwd]": 0, "plan_spmm[replayed]": 0}
    unattributed = 0
    for k in kernels:
        name = k.get("name", "")
        if "masked_scores" in name:
            by_name["masked_scores"] += 1
        elif "span_spmm_kernel" in name:
            r = launch.get(k.get("args", {}).get("correlation"))
            if r is None:
                unattributed += 1
                by_name["plan_spmm"] += 1
            elif "GraphLaunch" in r.get("name", ""):
                by_name["plan_spmm[replayed]"] += 1
            elif any(a <= r["ts"] <= b for a, b in bwd.get(r["tid"], ())):
                by_name["plan_spmm[bwd]"] += 1
            else:
                by_name["plan_spmm"] += 1
    return {"events": len(events), "kernels": len(kernels), "by_name": by_name, "k2_unattributed": unattributed}


class LogLines(logging.Handler):
    """Collects the messages of a logger (the warm starts' "load pretrained
    params successful!" lines)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "neurec_tpu_torch", "csrc")):
        print("chip_smoke: neurec_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)  # the run logger writes under ./log
    profile = "--profile" in sys.argv[1:]

    import numpy as np
    import scipy.sparse as sp

    from neurec_tpu_torch import checkpoint, pretrain, run
    from neurec_tpu_torch.benchmarks import dma_rate, topk_ab
    from neurec_tpu_torch.bridge import param_leaves, params_from_numpy
    from neurec_tpu_torch.config import Config
    from neurec_tpu_torch.data.dataset import Dataset
    from neurec_tpu_torch.data.synthetic import InMemoryDataset
    from neurec_tpu_torch.eval import Evaluator, tiers
    from neurec_tpu_torch.eval.tiers import global_bits_width
    from neurec_tpu_torch.models import get_model
    from neurec_tpu_torch.ops import _build
    from neurec_tpu_torch.ops import masked_scores as k1
    from neurec_tpu_torch.ops import spmm as k2
    from neurec_tpu_torch.ops.sampling import sample_negatives
    from neurec_tpu_torch.ops.topk import top_k
    from neurec_tpu_torch.pretrain import save_pretrain
    from neurec_tpu_torch.recommend import batch_topk
    from neurec_tpu_torch.trainer import EpochDraws, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the plain f32 geometry for phases 1-8 and path B, whatever the caller's shell holds
    stack = contextlib.ExitStack()
    stack.enter_context(env_vars({name: None for name in (
        "NEUREC_SPMM_TILE", "NEUREC_SPMM_CHUNK", "NEUREC_SPMM_PACK", "NEUREC_SPMM_DTYPE", "NEUREC_EVAL_PREMASK")}))

    # -- 1. device and build ------------------------------------------------
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    ptxas = {
        name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        for name, text in reports.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    # -- 2. set-up ----------------------------------------------------------
    t0 = time.perf_counter()
    conf = Config(PROPS, cmd_args=NORTHSTAR_ARGS)
    dataset = Dataset(conf)
    model = get_model("LightGCN")(dataset, conf)  # device=None: cuda
    rng = np.random.RandomState(SEED)
    params = params_from_numpy({
        "user_emb": glorot_numpy(rng, (dataset.num_users, model.emb_dim)),
        "item_emb": glorot_numpy(rng, (dataset.num_items, model.emb_dim)),
    })
    evaluator = Evaluator.from_dataset(dataset, conf)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "num_users": dataset.num_users, "num_items": dataset.num_items,
          "train_nnz": int(dataset.train_matrix.nnz),
          "eval_users": len(evaluator.evaluator.test_users)})

    # -- 3. kernels against their plain versions -----------------------------
    I, d = dataset.num_items, model.emb_dim
    width = global_bits_width(I)
    plan = model.adj.plan
    ego = torch.cat([params["user_emb"], params["item_emb"]], dim=0).contiguous()
    with torch.no_grad():
        u_table, item_table = model.propagate(params)
    users = torch.from_numpy(evaluator.evaluator.test_users[:EVAL_USERS_PER_BATCH]).long().cuda()
    u = u_table[users].contiguous()
    train_rows = torch.from_numpy(
        evaluator.evaluator._host_rows(users.cpu().numpy())
    ).cuda()
    bits = k1.pack_train_bits(train_rows, I, block_items=width)
    mask8 = k1.build_train_mask(train_rows, I)
    B = u.shape[0]

    records = {}

    def check(name, source, replaces, run_fn, plain, library, n_bytes, n_flops, extra=None, iters=20):
        got, want = run_fn(), plain()
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want)
        rec = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "tol": "atol %g + rtol %g, -inf identical" % (ATOL, RTOL),
            "ms": time_ms(torch, run_fn, iters=iters, warmup=iters // 2), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library, iters=iters, warmup=iters // 2) if library is not None else None,
        }
        rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_flops)
        rec.update(extra or {})
        emit({"phase": "kernel", **rec})
        require(ok, "%s disagrees with its plain version: max_abs_err %g" % (name, err))
        records[name] = rec
        return rec

    out_bytes = B * I * 4
    factor_bytes = u.numel() * 4 + I * d * 4

    def k1_check(name, run_fn, plain, library, n_bytes, uu, items, extra):
        """K1 against its plain version: time, bounds, device time from the
        profiler, errors scaled and against f64, the same bits twice."""
        n_flops = 2.0 * uu.shape[0] * items.shape[0] * uu.shape[1]
        rec = check(name, "neurec_tpu_torch/csrc/masked_scores.cu", "neurec_tpu/ops/pallas_kernels.py:37",
                    run_fn, plain, library, n_bytes, n_flops, dict(extra, **k1_bounds(k1, n_bytes, n_flops,
                                                                                   uu.shape[1])))
        got = run_fn()
        rec.update(k1_errors(torch, got, uu, items))
        rec["device_ms"], rec["device_ms_by_kernel"] = device_ms(torch, run_fn)
        rec["library_device_ms"] = device_ms(torch, library)[0]
        # cuBLAS's product alone, no mask: less work than K1's function
        product = lambda: torch.matmul(uu, items.T)  # noqa: E731
        rec["matmul_ms"] = time_ms(torch, product, iters=20, warmup=10)
        rec["matmul_device_ms"] = device_ms(torch, product)[0]
        emit({"phase": "kernel_device", "name": name, **{k: rec.get(k) for k in (
            "path", "ms", "device_ms", "device_ms_by_kernel", "library_ms", "library_device_ms", "matmul_ms",
            "matmul_device_ms", "max_scaled_err",
            "err_vs_f64", "plain_err_vs_f64", "err_over_f32_bound", "err_over_split_bound", "mask_build_ms",
            "kernel_ms")}})
        require(torch.equal(got, run_fn()), "%s is not deterministic" % name)
        if rec["path"] == "fma":
            # f32 FMAs: every score within d 2^-24 sum |u_k i_k| of the f64 product
            require(rec["err_over_f32_bound"] <= 1.0,
                    "%s is %g of the f32 bound from the f64 product" % (name, rec["err_over_f32_bound"]))
            # and the fmaf chain a thread a score, bit for bit
            rec["chain_mismatches"] = k1_chain_mismatches(torch, k1, got, plain(), uu, items)
            # K1, cuBLAS's product alone and matmul + where, in turns in this call
            turns = k1_turns(torch, {"k1": run_fn, "matmul": product, "library": library})
            rec["turns_ms"] = turns
            rec["k1_over_matmul"] = sum(turns["k1"]) / sum(turns["matmul"])
            emit({"phase": "kernel_f32_path", "name": name, "shape": rec.get("shape"),
                  "chain_mismatches": rec["chain_mismatches"], "turns_ms": turns,
                  "k1_over_matmul": rec["k1_over_matmul"], "device_ms": rec["device_ms"],
                  "matmul_device_ms": rec["matmul_device_ms"], "bound_ms": rec["bound_ms"]})
            require(rec["chain_mismatches"] == 0,
                    "%s: %d scores differ from the fmaf chain's bits" % (name, rec["chain_mismatches"]))
        else:
            # the split: no farther from the f64 product than the plain f32
            # product (d 64, 256), or within the split's own bound
            require(rec["err_vs_f64"] <= rec["plain_err_vs_f64"] or rec["max_abs_err"] == 0.0
                    or rec["err_over_split_bound"] <= 1.0,
                    "%s is farther from the f64 product than its plain version and its split's bound" % name)
        return rec

    k1_check(
        "masked_scores",
        lambda: k1.masked_scores_bits(u, item_table, bits, width, I),
        lambda: k1.masked_scores_bits_reference(u, item_table, bits, width, I),
        lambda: torch.where(mask8 != 0, float("-inf"), torch.matmul(u, item_table.T)),
        factor_bytes + bits.numel() + out_bytes, u, item_table,
        {"mode": "bits", "shape": [B, I, d], "library_call": "matmul + where on a prebuilt int8 mask"},
    )
    # K1's own function from train_rows: the library call builds its mask
    # too; the record splits the kernel's mask build from its launch
    mask_w = k1._mask_width(I)
    mask_prebuilt = k1.build_train_mask(train_rows, mask_w)
    k1_check(
        "masked_scores[int8]",
        lambda: k1.masked_scores(u, item_table, train_rows),
        lambda: k1.masked_scores_reference(u, item_table, train_rows),
        lambda: torch.where(k1.build_train_mask(train_rows, I) != 0, float("-inf"),
                            torch.matmul(u, item_table.T)),
        factor_bytes + train_rows.numel() * 4 + out_bytes, u, item_table,
        {"mode": "int8", "shape": [B, I, d], "library_call": "build_train_mask + matmul + where",
         "mask_build_ms": time_ms(torch, lambda: k1.build_train_mask(train_rows, mask_w)),
         "kernel_ms": time_ms(torch, lambda: k1._launch(u, item_table, mask_prebuilt, I, mask_w, 1, mode=0))},
    )
    del mask_prebuilt

    # K1 off the main path's shapes: a ragged d (4-byte copies, a partial
    # slab) and a bit-plane width W/8 = 4825 bytes, not a multiple of the
    # 128-item tile, so tiles straddle two planes
    for case, d_c, w_c in (("ragged_d", 33, width), ("straddling_w", d, width - 8 * 39)):
        rng_c = np.random.RandomState(SEED + 3)
        u_c = torch.from_numpy(rng_c.standard_normal((B, d_c)).astype(np.float32)).cuda()
        i_c = torch.from_numpy(rng_c.standard_normal((I, d_c)).astype(np.float32)).cuda()
        bits_c = k1.pack_train_bits(train_rows, I, block_items=w_c)
        got_c = k1.masked_scores_bits(u_c, i_c, bits_c, w_c, I)
        err_c, ok_c = compare(torch, got_c, k1.masked_scores_bits_reference(u_c, i_c, bits_c, w_c, I))
        got8_c = k1.masked_scores(u_c, i_c, train_rows)
        err8_c, ok8_c = compare(torch, got8_c, k1.masked_scores_reference(u_c, i_c, train_rows))
        emit({"phase": "kernel_case", "case": "masked_scores[%s]" % case, "shape": [B, I, d_c],
              "width": w_c, "plane_bytes": w_c // 8, "max_abs_err": {"bits": err_c, "int8": err8_c},
              "tol": "atol %g + rtol %g, -inf identical" % (ATOL, RTOL),
              "same_bits_twice": bool(torch.equal(got_c, k1.masked_scores_bits(u_c, i_c, bits_c, w_c, I))),
              "path": "f32" if k1.k1_path(d_c) == "fma" else "split, cp.async",
              "ms": time_ms(torch, lambda: k1.masked_scores_bits(u_c, i_c, bits_c, w_c, I))})
        require(ok_c and ok8_c, "K1 %s disagrees with its plain version: %g, %g" % (case, err_c, err8_c))
        if k1.k1_path(d_c) == "fma":
            mism_c = (k1_chain_mismatches(torch, k1, got_c, k1.masked_scores_bits_reference(u_c, i_c, bits_c, w_c, I),
                                          u_c, i_c)
                      + k1_chain_mismatches(torch, k1, got8_c, k1.masked_scores_reference(u_c, i_c, train_rows),
                                            u_c, i_c))
            emit({"phase": "kernel_case", "case": "masked_scores[%s]" % case, "chain_mismatches": mism_c})
            require(mism_c == 0, "K1 %s: %d scores differ from the fmaf chain's bits" % (case, mism_c))
        require(torch.equal(got_c, k1.masked_scores_bits(u_c, i_c, bits_c, w_c, I)),
                "K1 %s is not deterministic" % case)
    # K1 at the f32 path's widest d, 40, on randn factors: a width no model
    # of the repo evaluates at (a record on no path)
    rng_40 = np.random.RandomState(SEED + 4)
    u_40, i_40 = (torch.from_numpy(rng_40.standard_normal((n, K1_EDGE_D)).astype(np.float32)).cuda()
                  for n in (B, I))
    k1_check("masked_scores[d40]", lambda: k1.masked_scores_bits(u_40, i_40, bits, width, I),
             lambda: k1.masked_scores_bits_reference(u_40, i_40, bits, width, I),
             lambda: torch.where(mask8 != 0, float("-inf"), torch.matmul(u_40, i_40.T)),
             (B + I) * K1_EDGE_D * 4 + bits.numel() + out_bytes, u_40, i_40,
             {"mode": "bits", "shape": [B, I, K1_EDGE_D], "factors": "randn",
              "library_call": "matmul + where on a prebuilt int8 mask"})
    del u_40, i_40
    csr = adjacency_csr(torch, np, sp, model.adj)
    csr_t = adjacency_csr(torch, np, sp, model.adj, transpose=True)
    plan_skew(torch, k2, "pre", model.adj.plan)
    plan_skew(torch, k2, "pre_t", model.adj.plan_t)

    def plan_bytes(p, pack=1):
        if pack > 1:
            rows_p, vals_p = k2.packed_layout(p, pack)
            return sum(t.numel() * 4 for t in (rows_p, p.cols, vals_p, p.chunk_tile))
        return sum(t.numel() * 4 for t in (p.rows, p.cols, p.vals, p.chunk_tile))

    def spmm_check(name, source, replaces, p, x, pack, lib_csr, lib_x, extra=None):
        """A plan SpMM kernel (K2 at pack 1, K3 above) against its plain
        version on the same (f32 or bf16) input."""
        nnz = int((p.vals != 0).sum())
        sched = k2.spmm_schedule(p)
        pieces = int((sched.split[:, 2] - sched.split[:, 1]).sum())
        # beyond the bound's bytes: the schedule, and each piece of a cut
        # row written to scratch and read back by the fix-up
        extra = dict({"schedule_bytes": sched.nbytes, "scratch_bytes": 2 * pieces * x.shape[1] * 4}, **(extra or {}))
        if pack > 1:
            run_fn, plain = (lambda: k2.plan_spmm_packed(p, x, pack)), (lambda: k2.plan_spmm_packed_reference(p, x, pack))
        else:
            run_fn, plain = (lambda: k2.plan_scatter(p, x)), (lambda: k2.plan_spmm_reference(p, x))
        library = lambda: torch.sparse.mm(lib_csr, lib_x)  # noqa: E731
        # a call is ~0.04 ms of kernels: 100 back to back, after 50, so
        # that the card's clocks have risen; device_ms beside, from the
        # profiler, as the host can set the pace of such a loop
        rec = check(name, source, replaces, run_fn, plain, library,
                    plan_bytes(p, pack) + x.numel() * x.element_size() + p.n_rows * x.shape[1] * 4,
                    2.0 * nnz * x.shape[1],
                    dict({"shape": [p.n_rows, int(p.rows.shape[0]), int(p.rows.shape[1]), x.shape[1]],
                          "nnz": nnz, "pack": pack, "dtype": str(x.dtype).replace("torch.", ""),
                          "library_call": "torch.sparse.mm, CSR, float32"}, **(extra or {})), iters=100)
        rec["device_ms"], rec["device_ms_by_kernel"] = device_ms(torch, run_fn)
        rec["library_device_ms"] = device_ms(torch, library)[0]
        # the host's time to issue one call (50 calls, no wait: the device
        # runs behind them or idles)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            run_fn()
        rec["host_ms"] = (time.perf_counter() - t) / 50 * 1e3
        torch.cuda.synchronize()
        emit({"phase": "kernel_device", "name": name, **{k: rec[k] for k in (
            "ms", "device_ms", "device_ms_by_kernel", "host_ms", "library_ms", "library_device_ms")}})
        require(torch.equal(run_fn(), run_fn()), "%s is not deterministic" % name)
        return rec

    k2_src, k3_src = "neurec_tpu_torch/csrc/plan_spmm.cu", "neurec_tpu_torch/csrc/plan_spmm_packed.cu"
    spmm_check("plan_spmm", k2_src, "neurec_tpu/ops/pallas_spmm.py:144", plan, ego, 1, csr, ego)
    # the backward of the propagation: K2 over the plan of A^T, on a
    # gradient-sized input made from the numpy seed
    plan_t = model.adj.plan_t
    g = torch.from_numpy(
        np.random.RandomState(SEED + 1).standard_normal((model.adj.n_nodes, d)).astype(np.float32)
    ).cuda()
    spmm_check("plan_spmm[bwd]", k2_src, "neurec_tpu/ops/pallas_spmm.py:504", plan_t, g, 1, csr_t, g)
    # bf16 features, compared in the working type: both sides take the same
    # bf16 input and round the edge values to bf16
    spmm_check("plan_spmm[bf16]", k2_src, "neurec_tpu/ops/pallas_spmm.py:144", plan, ego.bfloat16(), 1,
               csr, ego)
    spmm_check("plan_spmm[bwd,bf16]", k2_src, "neurec_tpu/ops/pallas_spmm.py:504", plan_t, g.bfloat16(), 1,
               csr_t, g)

    def kernel_case(case, p, x, same_as=None):
        """K2 and K3 (pack 2, 4) against their plain versions, the same bits
        twice, K3 == K2, and (``same_as``) K2's bits over another plan."""
        got = k2.plan_scatter(p, x)
        err, ok = compare(torch, got, k2.plan_spmm_reference(p, x))
        require(ok, "%s: K2 disagrees with its plain version: max_abs_err %g" % (case, err))
        require(torch.equal(got, k2.plan_scatter(p, x)), "%s: K2 is not deterministic" % case)
        errs = {"plan_spmm": err}
        for pack in (2, 4):
            got3 = k2.plan_spmm_packed(p, x, pack)
            err3, ok3 = compare(torch, got3, k2.plan_spmm_packed_reference(p, x, pack))
            require(ok3, "%s: K3 pack %d disagrees with its plain version: %g" % (case, pack, err3))
            require(torch.equal(got3, k2.plan_spmm_packed(p, x, pack)) and torch.equal(got3, got),
                    "%s: K3 pack %d is not deterministic or not K2's bits" % (case, pack))
            errs["plan_spmm_packed[pack%d]" % pack] = err3
        if same_as is not None:
            require(torch.equal(got, same_as), "%s: K2's bits differ from the tile-256 plan's" % case)
        emit({"phase": "kernel_case", "case": case, "dtype": str(x.dtype).replace("torch.", ""),
              "shape": [p.n_rows, int(p.rows.shape[0]), int(p.rows.shape[1]), x.shape[1]],
              "tile_r": p.tile_r, "max_abs_err": errs, "tol": "atol %g + rtol %g" % (ATOL, RTOL),
              "cut_rows": int(k2.spmm_schedule(p).split.shape[0]),
              "plan_spmm_ms": time_ms(torch, lambda: k2.plan_scatter(p, x))})

    hub_rows, hub_cols, hub_vals = hub_coo(np)
    x_hub = torch.from_numpy(np.random.RandomState(SEED + 2).standard_normal((HUB_NODES, d)).astype(np.float32)).cuda()
    for label, (r_, c_) in (("hub", (hub_rows, hub_cols)), ("hub_t", (hub_cols, hub_rows))):
        p_hub = k2.build_spmm_plan(r_, c_, hub_vals, HUB_NODES).to("cuda")
        plan_skew(torch, k2, label, p_hub)
        require(label == "hub_t" or k2.spmm_schedule(p_hub).split.shape[0] > 0, "the hub row was not cut")
        for x in (x_hub, x_hub.bfloat16()):
            kernel_case(label, p_hub, x)
    adj_rows, adj_cols, adj_vals = (t.cpu().numpy() for t in (model.adj.rows, model.adj.cols, model.adj.vals))
    plan_1024 = k2.build_spmm_plan(adj_rows, adj_cols, adj_vals, model.adj.n_nodes, tile_r=1024).to("cuda")
    for x in (ego, ego.bfloat16()):
        kernel_case("tile1024", plan_1024, x, same_as=k2.plan_scatter(plan, x))
    # where an eval batch and a serving request spend their time besides
    # the kernels: the lowest-id-first top-K, torch.topk with the tie fix-up
    # (ops/topk.py) against the stable sort of each row it replaced, in one
    # call; the same ids and values, also where ties are forced across the
    # K-th place (ranks 10-39 of every row set to the 20th value)
    masked = k1.masked_scores_bits(u, item_table, bits, width, I)

    def stable_sort_topk(x, k):
        values, ids = torch.sort(x, dim=-1, descending=True, stable=True)
        return values[:, :k], ids[:, :k]

    tied = masked.clone()
    order = torch.sort(tied, dim=-1, descending=True, stable=True)[1]
    tied.scatter_(1, order[:, 10:40], tied.gather(1, order[:, SERVING_K - 1 : SERVING_K]).expand(-1, 30))
    for x in (masked, tied):
        (v_new, i_new), (v_old, i_old) = top_k(x, SERVING_K), stable_sort_topk(x, SERVING_K)
        require(torch.equal(i_new, i_old) and torch.equal(v_new, v_old),
                "top_k and the stable sort disagree on %d rows" % int((i_new != i_old).any(1).sum()))
    emit({"phase": "breakdown", "shape": [B, I], "k": SERVING_K, "ids_equal_to_stable_sort": True,
          "tied_rows": B, "eval_batch_topk_ms": time_ms(torch, lambda: top_k(masked, SERVING_K)),
          "eval_batch_sort_ms": time_ms(torch, lambda: stable_sort_topk(masked, SERVING_K)),
          "eval_batch_topk_tied_ms": time_ms(torch, lambda: top_k(tied, SERVING_K)),
          "serving_batch_topk_ms": time_ms(torch, lambda: top_k(masked[:SERVING_USERS], SERVING_K)),
          "serving_batch_sort_ms": time_ms(torch, lambda: stable_sort_topk(masked[:SERVING_USERS], SERVING_K)),
          "serving_batch_scores_ms": time_ms(torch, lambda: u[:SERVING_USERS] @ item_table.T)})
    del tied, order

    # -- 4. the main path, counted ------------------------------------------
    users_all = rng.choice(dataset.num_users, SERVING_REQUESTS * SERVING_USERS, replace=False)
    requests = users_all.reshape(SERVING_REQUESTS, SERVING_USERS)

    def serve():
        out, secs = [], []
        for req in requests:
            t = time.perf_counter()
            items, scores = batch_topk(
                model, params, SERVING_K, users=req, train_matrix=dataset.train_matrix,
                batch_size=SERVING_USERS,
            )
            secs.append(time.perf_counter() - t)
            out.append((items, scores))
        return out, secs

    paths = {}
    _build.reset_launches()
    t = time.perf_counter()
    eval_cold = evaluator.evaluate(model.predict, params)
    torch.cuda.synchronize()
    eval_cold_s = time.perf_counter() - t
    t = time.perf_counter()
    eval_warm = evaluator.evaluate(model.predict, params)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t
    served, serve_s = serve()
    clamp_items, clamp_scores = batch_topk(model, params, I + 5, users=requests[0][:2])
    launches = paths["serve"] = dict(_build.LAUNCHES)

    n_eval = len(evaluator.evaluator.test_users)
    emit({"phase": "main_path", "metrics": evaluator.metrics_info(), "result": eval_warm,
          "eval_users": n_eval, "eval_cold_s": eval_cold_s, "eval_warm_s": eval_warm_s,
          "eval_users_per_s": n_eval / eval_warm_s,
          "serving_request_s": serve_s,
          "serving_users_per_s": SERVING_REQUESTS * SERVING_USERS / sum(serve_s),
          "launches": launches})
    for name in ("masked_scores", "plan_spmm"):
        require(launches[name] > 0, "kernel %s was not launched on the main path" % name)
    require(eval_cold == eval_warm, "two evaluations of the same params differ")
    metrics = parse_metrics(eval_warm)
    require(all(np.isfinite(metrics)) and all(0.0 <= m <= 1.0 for m in metrics),
            "metrics out of range: %s" % eval_warm)
    train = dataset.train_matrix.tocsr()
    for req, (items, scores) in zip(requests, served):
        require(items.shape == (SERVING_USERS, SERVING_K) and items.dtype == np.int32,
                "batch_topk returned %s %s" % (items.shape, items.dtype))
        require(np.isfinite(scores).all(), "non-finite serving scores")
        require((np.diff(scores, axis=1) <= 0).all(), "serving scores not non-increasing")
        for uid, row in zip(req, items):
            consumed = train.indices[train.indptr[uid]:train.indptr[uid + 1]]
            require(not np.intersect1d(row, consumed).size, "consumed item served to user %d" % uid)
    require(clamp_items.shape == (2, I), "k clamp: got %s" % (clamp_items.shape,))

    # the pallas tier (K1's int8 mode), a path of its own
    with env_vars({"NEUREC_EVAL_PREMASK": "0"}):
        evaluator_int8 = Evaluator.from_dataset(dataset, conf)
        _build.reset_launches()
        eval_int8 = evaluator_int8.evaluate(model.predict, params)
        paths["serve_int8"] = dict(_build.LAUNCHES)
    int8_err = max(abs(a - b) for a, b in zip(metrics, parse_metrics(eval_int8)))
    emit({"phase": "serve_int8", "result": eval_int8, "metric_max_abs_diff": int8_err,
          "launches": paths["serve_int8"]})
    require(paths["serve_int8"]["masked_scores"] > 0, "the pallas tier did not launch K1")
    require(int8_err <= 1e-5, "the pallas tier's metrics differ from the bits tier's by %g" % int8_err)

    # -- 5. the same path through the plain versions ------------------------
    with mock.patch.object(k2, "plan_spmm", k2.plan_spmm_reference), \
            mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference), \
            mock.patch.object(k1, "masked_scores", k1.masked_scores_reference):
        eval_plain = evaluator.evaluate(model.predict, params)
        served_plain, _ = serve()
    metric_err = max(abs(a - b) for a, b in zip(metrics, parse_metrics(eval_plain)))
    ids_k = np.stack([s[0] for s in served])
    ids_p = np.stack([s[0] for s in served_plain])
    sc_k = np.stack([s[1] for s in served])
    sc_p = np.stack([s[1] for s in served_plain])
    differ = ids_k != ids_p
    agree = 1.0 - differ.mean()
    near_tie = np.abs(sc_k - sc_p)[differ].max(initial=0.0)
    emit({"phase": "plain_path", "result": eval_plain, "metric_max_abs_diff": metric_err,
          "top20_id_agreement": agree, "differing_positions": int(differ.sum()),
          "max_score_gap_where_ids_differ": float(near_tie)})
    require(metric_err <= 1e-5, "metrics differ from the plain path by %g" % metric_err)
    require(agree >= 0.999, "top-20 ids agree in only %.5f of positions" % agree)
    require(near_tie <= ATOL + RTOL * np.abs(sc_p).max(), "ids differ beyond a near-tie")

    # -- 6. the training path, counted --------------------------------------
    # (with a checkpoint each epoch: the uninterrupted run of phase 23)
    shutil.rmtree(CKPT_WHOLE, ignore_errors=True)
    _build.reset_launches()
    t = time.perf_counter()
    trainer, train_result = run.main(PROPS, cmd_args=TRAIN_ARGS + ["--ckpt_dir=%s" % CKPT_WHOLE])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_launches = paths["train"] = dict(_build.LAUNCHES)

    tmodel = trainer.model
    recs = run_records(trainer)
    steps = trainer.steps
    n_evals = sum("metrics" in r for r in recs)
    trained = parse_metrics(train_result)
    emit({"phase": "train", **train_summary(trainer, recs, train_s, train_launches),
          "metrics": evaluator.metrics_info(), "random_init_result": eval_warm})
    check_training(np, recs, "LightGCN")
    require(trained[0] > metrics[0], "Recall@20 after training %g is not above random weights' %g"
            % (trained[0], metrics[0]))
    recalls = [float(r["metrics"]["values"][0]) for r in recs if "metrics" in r]
    recorded_rel = max(abs(a - b) / abs(b) for a, b in zip(
        [r["loss"] for r in recs] + recalls, RECORDED_NORTHSTAR["loss"] + RECORDED_NORTHSTAR["recall20"]))
    emit({"phase": "train_vs_recorded", "losses": [r["loss"] for r in recs], "recall20": recalls,
          "recorded": RECORDED_NORTHSTAR, "max_rel_diff": recorded_rel, "tol": RECORDED_RTOL})
    require(recorded_rel <= RECORDED_RTOL, "north star moved from its recorded results by %g" % recorded_rel)
    n_fwd = tmodel.n_layers * (steps * TRAIN_EPOCHS + n_evals)
    n_bwd = tmodel.n_layers * steps * TRAIN_EPOCHS
    require((train_launches["plan_spmm"], train_launches["plan_spmm_t"]) == (n_fwd, n_bwd),
            "K2 launches %s, expected %d forward and %d backward" % (train_launches, n_fwd, n_bwd))

    # -- 7. where a training step's time goes --------------------------------
    draw_ms = time_ms(torch, lambda: trainer.draw_epoch(trainer.epoch_generator(3)), iters=3, warmup=1)
    draws = trainer.draw_epoch(trainer.epoch_generator(3))
    params_b, opt_b = clone_state(trainer)
    batch, w0 = trainer._batch(draws.inst[0], draws.negs[0]), draws.w[0]
    rows0 = trainer._padded_items[batch["users"]]
    gen = trainer.epoch_generator(4)

    def step():
        opt_b.zero_grad(set_to_none=True)
        tmodel.loss(params_b, batch, w0).backward()
        opt_b.step()

    one_step_ms = time_ms(torch, step)
    forward_ms = time_ms(torch, lambda: tmodel.loss(params_b, batch, w0))
    adam_ms = time_ms(torch, opt_b.step)
    epoch_steps_ms = time_ms(torch, lambda: trainer.run_epoch(params_b, opt_b, *draws), iters=2, warmup=1)
    k2_fwd_ms = tmodel.n_layers * records["plan_spmm"]["ms"]
    k2_bwd_ms = tmodel.n_layers * records["plan_spmm[bwd]"]["ms"]
    prof = profile_steps(torch, step) if profile else None
    if prof is not None:
        # the profiler slows the host, not the kernels: the device's share
        # of an unprofiled step
        prof["device_busy_share_of_step"] = prof["device_ms_per_step"] / one_step_ms
    emit({"phase": "train_breakdown", "step_ms": one_step_ms,
          "run_epoch_ms_per_step": epoch_steps_ms / steps,
          "draw_epoch_ms_per_step": draw_ms / steps,
          "sampler_ms_per_step": time_ms(torch, lambda: sample_negatives(gen, rows0, I, ())),
          "forward_ms": forward_ms, "backward_ms": one_step_ms - forward_ms - adam_ms, "adam_ms": adam_ms,
          "k2_forward_ms": k2_fwd_ms, "k2_backward_ms": k2_bwd_ms,
          "rest_ms": one_step_ms - k2_fwd_ms - k2_bwd_ms - adam_ms,
          "profile": prof if profile else "not run (--profile)"})

    # -- 8. training steps through the plain versions ------------------------
    emit({"phase": "train_plain_path", **kernel_vs_plain_steps(
        torch, trainer, draws, [(k2, "plan_spmm", k2.plan_spmm_reference)])})
    # phase 32 on the north star: 3 whole epochs through Trainer.train, then
    # the trained state, epoch 3's draws
    kept_train(torch, trainer)
    graph_checks, custom_checks = [], []
    graph_checks.append(graph_vs_eager(
        torch, "northstar", trainer, EpochDraws(*(a[:GRAPH_NORTHSTAR_STEPS] for a in draws)), GRAPH_UNROLLS,
        ("plan_spmm", "plan_spmm_t", tmodel.n_layers), timing=True))
    # phase 34 on the north star: the trained state's evaluation and serving
    eval_checks = [eval_graph_check(torch, "northstar", trainer, paths, sync_check=True)]
    serving_checks = [serving_graph_check(torch, tmodel, trainer.params, requests, dataset.train_matrix, paths)]

    # -- 9. path A: LightGCN chunk512_pack2 (K3) -----------------------------
    with env_vars(PACK2_ENV):
        t0 = time.perf_counter()
        model_a = get_model("LightGCN")(dataset, conf)  # plans built under the variables
        plan_a = model_a.adj.plan
        torch.cuda.synchronize()
        setup_a_s = time.perf_counter() - t0
        require(plan_a.rows.shape[1] == 512 and k2.pack_factor(d, 512) == 2,
                "path A: chunk %d, pack %d" % (plan_a.rows.shape[1], k2.pack_factor(d, plan_a.rows.shape[1])))
        plan_skew(torch, k2, "pre_chunk512", plan_a)
        plan_skew(torch, k2, "pre_t_chunk512", model_a.adj.plan_t)
        for pack in (2, 4):
            for x in (ego, ego.bfloat16()):
                dt = "" if x.dtype == torch.float32 else ",bf16"
                spmm_check("plan_spmm_packed[pack%d%s]" % (pack, dt), k3_src, "neurec_tpu/ops/pallas_spmm.py:222",
                           plan_a, x, pack, csr, ego)
                require(torch.equal(k2.plan_spmm_packed(plan_a, x, pack), k2.plan_scatter(plan_a, x)),
                        "K3 (pack %d, %s) and K2 differ over the same plan" % (pack, x.dtype))

        _build.reset_launches()
        t = time.perf_counter()
        eval_a = evaluator.evaluate(model_a.predict, params)
        torch.cuda.synchronize()
        eval_a_s = time.perf_counter() - t
        t = time.perf_counter()
        trainer_a, result_a = run.main(PROPS, cmd_args=TRAIN_ARGS)
        torch.cuda.synchronize()
        train_a_s = time.perf_counter() - t
        launches_a = paths["pack2"] = dict(_build.LAUNCHES)

        recs_a = run_records(trainer_a)
        emit({"phase": "pack2", "setup_s": setup_a_s, "result": eval_a, "eval_s": eval_a_s,
              "eval_users_per_s": n_eval / eval_a_s, **train_summary(trainer_a, recs_a, train_a_s, launches_a)})
        eval_a_err = max(abs(a - b) for a, b in zip(metrics, parse_metrics(eval_a)))
        require(eval_a_err <= 1e-5, "path A's evaluation differs from phase 4's by %g" % eval_a_err)
        check_training(np, recs_a, "path A")
        require([r["loss"] for r in recs_a] == [r["loss"] for r in recs] and result_a == train_result,
                "path A's losses %s and metrics %s differ from phase 6's %s, %s"
                % ([r["loss"] for r in recs_a], result_a, [r["loss"] for r in recs], train_result))
        steps_a = trainer_a.steps
        n_evals_a = sum("metrics" in r for r in recs_a)
        want_a = {"plan_spmm_packed": 3 * (1 + steps_a * TRAIN_EPOCHS + n_evals_a),
                  "plan_spmm_packed_t": 3 * steps_a * TRAIN_EPOCHS, "plan_spmm": 0, "plan_spmm_t": 0}
        require(all(launches_a[k] == v for k, v in want_a.items()),
                "path A launches %s, expected %s" % (launches_a, want_a))
        draws_a = trainer_a.draw_epoch(trainer_a.epoch_generator(3))
        emit({"phase": "pack2_breakdown", "step_ms": step_ms(torch, trainer_a, draws_a),
              "k3_forward_ms": 3 * records["plan_spmm_packed[pack2]"]["ms"]})
        emit({"phase": "pack2_plain_path", **kernel_vs_plain_steps(
            torch, trainer_a, draws_a, [(k2, "plan_spmm_packed", k2.plan_spmm_packed_reference),
                                        (k2, "plan_scatter", k2.plan_spmm_reference)])})
        graph_checks.append(graph_vs_eager(
            torch, "pack2", trainer_a, EpochDraws(*(a[:GRAPH_PACK2_STEPS] for a in draws_a)), GRAPH_UNROLLS,
            ("plan_spmm_packed", "plan_spmm_packed_t", 3)))
        eval_checks.append(eval_graph_check(torch, "pack2", trainer_a, paths))

        # -- 10. the other variants, each a path ------------------------------
        some = EpochDraws(*(a[:VARIANT_STEPS] for a in draws_a))
        for path, pack, dtype in VARIANT_PATHS:
            with env_vars({"NEUREC_SPMM_PACK": pack, "NEUREC_SPMM_DTYPE": dtype}):
                params_v, opt_v = clone_state(trainer_a)
                _build.reset_launches()
                result_v = evaluator.evaluate(trainer_a.model.predict, params_v)
                loss_v = float(trainer_a.run_epoch(params_v, opt_v, *some)[2])
                paths[path] = dict(_build.LAUNCHES)
            fwd, bwd = ("plan_spmm", "plan_spmm_t") if pack == "1" else ("plan_spmm_packed", "plan_spmm_packed_t")
            want_v = {k: 0 for k in ("plan_spmm", "plan_spmm_t", "plan_spmm_packed", "plan_spmm_packed_t")}
            want_v.update({fwd: 3 * (1 + VARIANT_STEPS), bwd: 3 * VARIANT_STEPS})
            diff_v = max(abs(a - b) for a, b in zip(parse_metrics(result_a), parse_metrics(result_v)))
            emit({"phase": "variant", "path": path, "pack": pack, "dtype": dtype, "result": result_v,
                  "metric_max_abs_diff_vs_pack2_f32": diff_v, "step_loss": loss_v, "launches": paths[path]})
            require(all(paths[path][k] == v for k, v in want_v.items()),
                    "path %s launches %s, expected %s" % (path, paths[path], want_v))
            require(np.isfinite(loss_v), "path %s: non-finite loss" % path)
            if dtype == "f32":  # K3 sums in K2's order: the same bits, the same metrics
                require(result_v == result_a, "path %s: %s against %s" % (path, result_v, result_a))
            else:
                require(diff_v <= BF16_METRIC_ATOL, "path %s: metrics moved by %g" % (path, diff_v))

    # -- 11. path B: NGCF at its published widths -----------------------------
    t0 = time.perf_counter()
    conf_b = Config(PROPS, cmd_args=NGCF_ARGS)
    model_b = get_model("NGCF")(dataset, conf_b)
    params_b0 = model_b.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    setup_b_s = time.perf_counter() - t0
    with torch.no_grad():
        u_tab_b, i_tab_b = model_b.propagate(params_b0)
    u_b = u_tab_b[users].contiguous()
    d_b = u_b.shape[1]
    require(d_b == 256, "NGCF evaluates at width %d" % d_b)
    k1_check(
        "masked_scores[d256]",
        lambda: k1.masked_scores_bits(u_b, i_tab_b, bits, width, I),
        lambda: k1.masked_scores_bits_reference(u_b, i_tab_b, bits, width, I),
        lambda: torch.where(mask8 != 0, float("-inf"), torch.matmul(u_b, i_tab_b.T)),
        u_b.numel() * 4 + I * d_b * 4 + bits.numel() + out_bytes, u_b, i_tab_b,
        {"mode": "bits", "shape": [B, I, d_b], "library_call": "matmul + where on a prebuilt int8 mask"},
    )
    # K3's backward over NGCF's norm plan_t, a structure of its own
    plan_bt = model_b.adj.plan_t
    plan_skew(torch, k2, "norm", model_b.adj.plan)
    plan_skew(torch, k2, "norm_t", plan_bt)
    csr_bt = adjacency_csr(torch, np, sp, model_b.adj, transpose=True)
    for pack in (2, 4):
        for x in (g, g.bfloat16()):
            dt = "" if x.dtype == torch.float32 else ",bf16"
            spmm_check("plan_spmm_packed[bwd,pack%d%s]" % (pack, dt), k3_src, "neurec_tpu/ops/pallas_spmm.py:504",
                       plan_bt, x, pack, csr_bt, g, {"adjacency": "norm, transposed"})

    _build.reset_launches()
    t = time.perf_counter()
    eval_b0 = evaluator.evaluate(model_b.predict, params_b0)
    torch.cuda.synchronize()
    eval_b0_s = time.perf_counter() - t
    t = time.perf_counter()
    trainer_b, result_b = run.main(PROPS, cmd_args=NGCF_TRAIN_ARGS)
    torch.cuda.synchronize()
    train_b_s = time.perf_counter() - t
    launches_b = paths["ngcf"] = dict(_build.LAUNCHES)

    recs_b = run_records(trainer_b)
    emit({"phase": "ngcf", "setup_s": setup_b_s, "random_init_result": eval_b0, "eval_s": eval_b0_s,
          "eval_users_per_s": n_eval / eval_b0_s, "nnz": int((model_b.adj.vals != 0).sum()),
          **train_summary(trainer_b, recs_b, train_b_s, launches_b)})
    metrics_b0 = parse_metrics(eval_b0)
    require(all(np.isfinite(metrics_b0)) and all(0.0 <= m <= 1.0 for m in metrics_b0),
            "NGCF metrics out of range: %s" % eval_b0)
    check_training(np, recs_b, "path B", NGCF_EPOCHS)
    ngcf_rel = max(abs(r["loss"] - b) / b for r, b in zip(recs_b, RECORDED_NGCF_LOSS))
    emit({"phase": "ngcf_vs_recorded", "losses": [r["loss"] for r in recs_b], "recorded": RECORDED_NGCF_LOSS,
          "max_rel_diff": ngcf_rel, "tol": RECORDED_RTOL})
    require(ngcf_rel <= RECORDED_RTOL, "NGCF moved from its recorded losses by %g" % ngcf_rel)
    steps_b = trainer_b.steps
    n_evals_b = sum("metrics" in r for r in recs_b)
    want_b = {"plan_spmm": 3 * (1 + steps_b * NGCF_EPOCHS + n_evals_b),
              "plan_spmm_t": 3 * steps_b * NGCF_EPOCHS, "plan_spmm_packed": 0, "plan_spmm_packed_t": 0}
    require(all(launches_b[k] == v for k, v in want_b.items()),
            "path B launches %s, expected %s" % (launches_b, want_b))
    require(launches_b["masked_scores"] > 0, "path B did not launch K1")
    with mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference):
        eval_b_plain = evaluator.evaluate(trainer_b.model.predict, trainer_b.params)
    ngcf_eval_err = max(abs(a - b) for a, b in zip(parse_metrics(result_b), parse_metrics(eval_b_plain)))
    emit({"phase": "ngcf_plain_eval", "result": result_b, "plain_result": eval_b_plain,
          "metric_max_abs_diff": ngcf_eval_err, "tol": NGCF_EVAL_ATOL})
    require(ngcf_eval_err <= NGCF_EVAL_ATOL, "NGCF's metrics differ from K1's plain version by %g" % ngcf_eval_err)
    # the band check: the same run.main through K2's and K1's plain versions,
    # on the same draws (the same seeds), the metrics after every epoch
    t = time.perf_counter()
    with mock.patch.object(k2, "plan_scatter", k2.plan_spmm_reference), \
            mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference):
        trainer_bp, _ = run.main(PROPS, cmd_args=NGCF_TRAIN_ARGS)
    plain_b_s = time.perf_counter() - t
    recs_bp = run_records(trainer_bp)
    curve = {name: [[float(r["metrics"]["values"][i]) for r in recs if "metrics" in r] for recs in (recs_b, recs_bp)]
             for i, name in enumerate(("recall20", "ndcg20"))}
    band_diff = max(abs(a - b) for name in curve for a, b in zip(*curve[name]))
    emit({"phase": "ngcf_band", "epochs": NGCF_EPOCHS, "kernels": {k: v[0] for k, v in curve.items()},
          "plain": {k: v[1] for k, v in curve.items()}, "losses": [r["loss"] for r in recs_b],
          "plain_losses": [r["loss"] for r in recs_bp], "max_abs_diff": band_diff, "band": NGCF_BAND,
          "plain_run_s": plain_b_s})
    check_training(np, recs_bp, "path B, plain", NGCF_EPOCHS)
    require(len(curve["recall20"][0]) == len(curve["recall20"][1]) == NGCF_EPOCHS, "path B: evaluations missing")
    require(band_diff <= NGCF_BAND, "NGCF's kernel and plain runs left the band: %g" % band_diff)
    del trainer_bp

    draws_b = trainer_b.draw_epoch(trainer_b.epoch_generator(3))
    emit({"phase": "ngcf_breakdown", "step_ms": step_ms(torch, trainer_b, draws_b),
          "k2_forward_ms_on_pre_plan": 3 * records["plan_spmm"]["ms"]})
    emit({"phase": "ngcf_plain_path", **kernel_vs_plain_steps(
        torch, trainer_b, draws_b, [(k2, "plan_scatter", k2.plan_spmm_reference)])})
    graph_checks.append(graph_vs_eager(
        torch, "ngcf", trainer_b, EpochDraws(*(a[:GRAPH_NGCF_STEPS] for a in draws_b)), GRAPH_UNROLLS,
        ("plan_spmm", "plan_spmm_t", 3), timing=True))
    eval_checks.append(eval_graph_check(torch, "ngcf", trainer_b, paths))

    # -- 12. K4, the copy-rate probe -------------------------------------------
    _build.reset_launches()
    t = time.perf_counter()
    probe = dma_rate.main(["--n", str(PROBE_N), "--repeat", str(PROBE_REPEAT), "--rounds", str(PROBE_ROUNDS)])
    probe_s = time.perf_counter() - t
    paths["probe"] = dict(_build.LAUNCHES)
    emit({"phase": "probe", "seconds": probe_s, "launches": paths["probe"]})
    offs = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, dma_rate.OUT_ROWS - max(dma_rate.ROWS_LIST), PROBE_N).astype(np.int32)).cuda()
    n_total = PROBE_N * PROBE_REPEAT
    lib_buf = dma_rate.new_buffer()
    for rows in dma_rate.ROWS_LIST:
        idx = (offs.long()[:, None] + torch.arange(rows, device=offs.device)).reshape(-1)
        for mode in dma_rate.MODES:
            name = "dma_rate[%s,%dB]" % (mode, rows * 512)
            got = dma_rate.dma_copies(offs, n_total, rows, mode, dma_rate.new_buffer())
            want = dma_rate.dma_copies_reference(offs, n_total, rows)
            torch.cuda.synchronize()
            res = probe["%dB_%s" % (rows * 512, mode)]
            rec = {"name": name, "route": "cuda", "source": "neurec_tpu_torch/csrc/dma_rate.cu",
                   "replaces": "benchmarks/dma_rate.py:%d" % (51 if mode == "serial" else 75),
                   "launches": None, "max_abs_err": float((got - want).abs().max()),
                   "tol": "the same rows written (exact)",
                   "ms": res["s_per_call_min"] * 1e3,
                   "plain_ms": time_ms(torch, lambda: dma_rate.dma_copies_reference(offs, n_total, rows),
                                       iters=5, warmup=1),
                   "library_ms": time_ms(torch, lambda: lib_buf.index_fill_(0, idx, 1.0), iters=5, warmup=1),
                   "bound_ms": n_total * rows * 512 / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "dmas_per_s": res["dmas_per_s"], "effective_GBps": res["effective_GBps"],
                   "floor_ms": res["floor_s"] * 1e3, "n_dmas_per_call": n_total,
                   "library_call": "index_fill_ of the written rows"}
            emit({"phase": "kernel", **rec})
            require(torch.equal(got, want), "%s writes other rows than its plain version" % name)
            records[name] = rec

    # -- 13. path C: NeuMF at full width, warm-started from MF and MLP pickles ----
    said = LogLines()
    pretrain.log.addHandler(said)
    pre_dir = os.path.join(REPO, "build", "pretrained")
    eval_users = evaluator.evaluator.test_users

    def zoo_trainer(name, args, steps, epochs=1, data=None):
        """A model at conf/<name>.properties (and ``args``) through Trainer:
        initialized, then ``epochs`` epochs cut to their first ``steps``
        steps (a custom epoch: each of its passes; ``None``: whole). A
        ``none`` model trains nothing."""
        data = data or dataset
        conf_z = Config(PROPS, cmd_args=["--recommender=%s" % name] + DATA_ARGS + args)
        trainer_z = Trainer(get_model(name)(data, conf_z), data, conf_z)
        trainer_z.initialize()
        kind = trainer_z.model.data_kind
        losses = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for epoch in range(1, epochs + 1 if kind != "none" else 1):
            trainer_z.params, trainer_z.opt_state, loss_z = trainer_z.train_epoch(epoch, max_steps=steps)
            losses.append(float(loss_z))
        torch.cuda.synchronize()
        train_z_s = time.perf_counter() - t
        require(all(np.isfinite(losses)), "%s: non-finite loss %s" % (name, losses))
        if kind in BUILT_IN_KINDS and name not in {c["model"] for c in graph_checks}:
            graph_checks.append(graph_vs_eager(torch, name.lower(), trainer_z,
                                               graph_draws(torch, trainer_z, GRAPH_ZOO_STEPS, SEED),
                                               GRAPH_ZOO_UNROLLS))
        elif name in GRAPH_CUSTOM_MODELS and name not in {c["model"] for c in custom_checks}:
            custom_checks.append(custom_graph_check(torch, name.lower(), trainer_z))
        return trainer_z, {"model": name, "data_kind": kind, "steps": steps, "epochs": len(losses),
                           "steps_per_epoch": trainer_z.steps, "batch_size": trainer_z.model.batch_size,
                           "loss": losses[-1] if losses else None, "epoch_losses": losses, "train_s": train_z_s,
                           "ms_per_step": 1e3 * train_z_s / steps / len(losses) if steps and losses else None}

    def zoo_eval(trainer_z, params_z, n_users=None):
        """``(result, seconds)`` of one evaluation of all test users, or of
        the first ``n_users``; fails on metrics outside [0, 1]."""
        users_z = None if n_users is None else trainer_z.evaluator.evaluator.test_users[:n_users]
        torch.cuda.synchronize()
        t = time.perf_counter()
        result_z = trainer_z.evaluator.evaluator.evaluate(trainer_z.model.predict, params_z, users_z)
        torch.cuda.synchronize()
        values = parse_metrics(result_z)
        require(all(np.isfinite(values)) and all(0.0 <= m <= 1.0 for m in values),
                "%s: metrics out of range: %s" % (trainer_z.model.name, result_z))
        return result_z, time.perf_counter() - t

    def warm_started(path):
        return any(line.startswith("load pretrained params successful!") and path in line for line in said.lines)

    mf_path, mlp_path = os.path.join(pre_dir, "gowalla_mf16.pkl"), os.path.join(pre_dir, "gowalla_mlp.pkl")
    _build.reset_launches()
    trainer_mf, rec_mf = zoo_trainer("MF", ["--embedding_size=16"], PRETRAIN_STEPS)
    save_pretrain("MF", trainer_mf.params, mf_path)
    trainer_mlp, rec_mlp = zoo_trainer("MLP", [], PRETRAIN_STEPS)
    save_pretrain("MLP", trainer_mlp.params, mlp_path)
    del trainer_mf, trainer_mlp
    # the same NeuMF with random weights (no warm start), the quality bar
    conf_c = Config(PROPS, cmd_args=["--recommender=NeuMF"] + DATA_ARGS + ["--mf_pretrain=", "--mlp_pretrain="])
    model_r = get_model("NeuMF")(dataset, conf_c)
    params_r = model_r.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    t = time.perf_counter()
    result_r = evaluator.evaluate(model_r.predict, params_r)
    torch.cuda.synchronize()
    random_c_s = time.perf_counter() - t
    del model_r, params_r
    trainer_c, rec_c = zoo_trainer("NeuMF", ["--mf_pretrain=%s" % mf_path, "--mlp_pretrain=%s" % mlp_path],
                                   NEUMF_STEPS)
    require(warm_started(mf_path) and warm_started(mlp_path), "NeuMF did not load its pretrain pickles")
    result_c, eval_c_s = zoo_eval(trainer_c, trainer_c.params)
    paths["neumf"] = dict(_build.LAUNCHES)
    eval_checks.append(eval_graph_check(torch, "neumf", trainer_c, paths, EVAL_GRAPH_USERS["NeuMF"]))
    model_c = trainer_c.model
    few = torch.from_numpy(eval_users[:CHUNK_CHECK_USERS]).long().cuda()
    with torch.no_grad():
        chunked = model_c.predict(trainer_c.params, few)
        model_c.predict_chunk = I
        whole = model_c.predict(trainer_c.params, few)
        model_c.predict_chunk = 4096
    chunk_err = float((chunked - whole).abs().max())
    emit({"phase": "neumf", "pretrain": [rec_mf, rec_mlp], **rec_c, "widths": {
              "embedding_size": model_c.embedding_size, "layers": model_c.layers,
              "loss_function": model_c.loss_function, "num_neg": model_c.num_negatives},
          "warm_start": [line for line in said.lines if "successful" in line], "result": result_c,
          "eval_s": eval_c_s, "eval_users_per_s": n_eval / eval_c_s, "random_init_result": result_r,
          "random_init_eval_s": random_c_s, "chunked_vs_unchunked_max_abs_diff": chunk_err,
          "launches": paths["neumf"]})
    require(parse_metrics(result_c)[0] > parse_metrics(result_r)[0],
            "NeuMF's Recall@20 after training %s is not above random weights' %s" % (result_c, result_r))
    require(chunk_err <= ATOL, "NeuMF's chunked predict differs from the unchunked one by %g" % chunk_err)
    del trainer_c, chunked, whole

    # -- 14. path D: the other seven models on the same split -----------------
    def factorized_path(name, record, args=(), epochs=1):
        """A model K1 ranks (APR, FISM; path E's Pop, MultiDAE, MultiVAE,
        CDAE, WRMF, IRGAN): steps, a full evaluation with one K1 launch a
        batch, again through K1's plain version (metrics within 1e-5), and
        K1 at the model's own factors against its plain version."""
        _build.reset_launches()
        trainer_z, rec_z = zoo_trainer(name, list(args), ZOO_STEPS.get(name), epochs)
        result_z, eval_z_s = zoo_eval(trainer_z, trainer_z.params)
        paths[name.lower()] = dict(_build.LAUNCHES)
        n_batches = -(-n_eval // EVAL_USERS_PER_BATCH)
        require(paths[name.lower()]["masked_scores"] == n_batches,
                "%s: %d K1 launches for %d eval batches" % (name, paths[name.lower()]["masked_scores"], n_batches))
        with mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference):
            result_p, _ = zoo_eval(trainer_z, trainer_z.params)
        diff = max(abs(a - b) for a, b in zip(parse_metrics(result_z), parse_metrics(result_p)))
        with torch.no_grad():
            u_z, items_z = trainer_z.model.eval_embeddings(trainer_z.params, users)
        d_z = u_z.shape[1]
        if record is None:
            got = k1.masked_scores_bits(u_z, items_z, bits, width, I)
            err_z, ok_z = compare(torch, got, k1.masked_scores_bits_reference(u_z, items_z, bits, width, I))
            emit({"phase": "kernel_case", "case": "masked_scores[%s]" % name.lower(), "shape": [B, I, d_z],
                  "max_abs_err": err_z, "tol": "atol %g + rtol %g, -inf identical" % (ATOL, RTOL)})
            require(ok_z, "K1 at %s's factors disagrees with its plain version: %g" % (name, err_z))
        else:
            k1_check(record, lambda: k1.masked_scores_bits(u_z, items_z, bits, width, I),
                     lambda: k1.masked_scores_bits_reference(u_z, items_z, bits, width, I),
                     lambda: torch.where(mask8 != 0, float("-inf"), torch.matmul(u_z, items_z.T)),
                     u_z.numel() * 4 + items_z.numel() * 4 + bits.numel() + out_bytes, u_z, items_z,
                     {"mode": "bits", "shape": [B, I, d_z], "model": name,
                      "library_call": "matmul + where on a prebuilt int8 mask"})
        emit({"phase": name.lower(), **rec_z, "eval_width": d_z, "k1_path": k1.k1_path(d_z), "result": result_z,
              "eval_s": eval_z_s, "eval_users_per_s": n_eval / eval_z_s, "plain_result": result_p,
              "metric_max_abs_diff": diff, "k1_launches_per_batch": paths[name.lower()]["masked_scores"] / n_batches,
              "launches": paths[name.lower()]})
        require(diff <= 1e-5, "%s: metrics differ from K1's plain version by %g" % (name, diff))
        return trainer_z, rec_z, result_z

    factorized_path("APR", None)
    trainer_f = factorized_path("FISM", "masked_scores[d17]")[0]
    require(trainer_f.model.embedding_size + 1 == records["masked_scores[d17]"]["shape"][2],
            "FISM evaluates at d %d" % records["masked_scores[d17]"]["shape"][2])
    fism_path = os.path.join(pre_dir, "gowalla_fism.pkl")
    save_pretrain("FISM", trainer_f.params, fism_path)
    del trainer_f
    mf64_path = os.path.join(pre_dir, "gowalla_mf64.pkl")
    # kept for the sampled-candidates phase
    trainer_mf64, rec_mf64 = zoo_trainer("MF", [], ZOO_STEPS["MF"])
    save_pretrain("MF", trainer_mf64.params, mf64_path)
    for name, args, warm in (("NAIS", ["--pretrain_file=%s" % fism_path], fism_path),
                             ("DeepICF", ["--pretrain_file=%s" % fism_path], fism_path),
                             ("ConvNCF", ["--mf_pretrain=%s" % mf64_path], mf64_path),
                             ("DMF", [], None)):
        _build.reset_launches()
        trainer_z, rec_z = zoo_trainer(name, args, ZOO_STEPS[name])
        n_z = ZOO_EVAL_USERS.get(name, n_eval)
        result_z, eval_z_s = zoo_eval(trainer_z, trainer_z.params, ZOO_EVAL_USERS.get(name))
        paths[name.lower()] = dict(_build.LAUNCHES)
        edges_z = edge_eval(torch, trainer_z, result_z, eval_z_s) if name in ("NAIS", "DeepICF") else None
        if name in EVAL_GRAPH_USERS:
            eval_checks.append(eval_graph_check(torch, name.lower(), trainer_z, paths, EVAL_GRAPH_USERS[name]))
        if name == "NAIS":
            users_n = np.asarray(trainer_z.evaluator.evaluator.test_users)
            serving_checks.append(serving_graph_check(
                torch, trainer_z.model, trainer_z.params, [users_n[:SERVING_USERS]] * NAIS_SERVING_REQUESTS,
                dataset.train_matrix, paths, "serve_graph_nais"))
        emit({"phase": name.lower(), **rec_z, "warm_start": warm, "eval_users": n_z,
              "result": result_z, "eval_s": eval_z_s, "eval_users_per_s": n_z / eval_z_s,
              "launches": paths[name.lower()], **({"edge_eval": edges_z} if edges_z else {}),
              **({"warm_start_from_mf": rec_mf64} if name == "ConvNCF" else {})})
        require(warm is None or warm_started(warm), "%s did not load %s" % (name, warm))
        del trainer_z

    # -- 16. path E: the rest of the general zoo on the same split -------------
    random_recall = metrics[0]  # phase 4: LightGCN with random weights
    gen_path = os.path.join(pre_dir, "gowalla_irgan_gen.pkl")
    trainer_mf, rec_mf20 = zoo_trainer("MF", ["--embedding_size=%d" % IRGAN_FACTORS], PRETRAIN_STEPS)
    mf = trainer_mf.params
    save_pretrain("IRGAN", {"gen": {"user_emb": mf["user_emb"], "item_emb": mf["item_emb"],
                                    "item_bias": torch.zeros(I, device="cuda")}}, gen_path)
    del trainer_mf, mf
    zoo_e = {}
    for name, record, epochs in E_FACTORIZED:
        args = ["--pretrain_file=%s" % gen_path] if name == "IRGAN" else []
        _, rec_z, result_z = factorized_path(name, record, args, epochs)
        zoo_e[name] = (rec_z, parse_metrics(result_z))
    wrmf_losses = zoo_e["WRMF"][0]["epoch_losses"]
    require(len(wrmf_losses) == 2 and wrmf_losses[1] < wrmf_losses[0], "WRMF's ALS losses do not fall: %s"
            % wrmf_losses)
    for name in ("Pop", "WRMF"):
        require(zoo_e[name][1][0] > random_recall, "%s's Recall@20 %g is not above random weights' %g"
                % (name, zoo_e[name][1][0], random_recall))
    require(warm_started(gen_path), "IRGAN did not load its generator pickle")
    emit({"phase": "path_e_checks", "random_recall20": random_recall, "wrmf_epoch_losses": wrmf_losses,
          "recall20": {k: v[1][0] for k, v in zoo_e.items()}, "irgan_warm_start": gen_path,
          "irgan_generator_from_mf": rec_mf20})
    for name in E_PREDICT:
        _build.reset_launches()
        trainer_z, rec_z = zoo_trainer(name, [], ZOO_STEPS.get(name))
        n_z = ZOO_EVAL_USERS.get(name)
        result_z, eval_z_s = zoo_eval(trainer_z, trainer_z.params, n_z)
        paths[name.lower()] = dict(_build.LAUNCHES)
        emit({"phase": name.lower(), **rec_z, "eval_users": n_z or n_eval, "result": result_z, "eval_s": eval_z_s,
              "eval_users_per_s": (n_z or n_eval) / eval_z_s, "launches": paths[name.lower()]})
        require(paths[name.lower()]["masked_scores"] == 0, "%s ranks on the predict tier, yet K1 ran" % name)
        del trainer_z
    pretrain.log.removeHandler(said)

    # -- 17. path F: SpectralCF at ml-100k's shape -----------------------------
    os.makedirs(ML_DIR, exist_ok=True)
    rng_m = np.random.RandomState(SEED)
    cells = rng_m.choice(ML_USERS * ML_ITEMS, ML_RATINGS, replace=False)
    with open(os.path.join(ML_DIR, "ml100k_seeded.rating"), "w") as fout:
        fout.write("".join("%d,%d,%d\n" % (c // ML_ITEMS, c % ML_ITEMS, r)
                           for c, r in zip(cells, rng_m.randint(1, 6, ML_RATINGS))))
    t = time.perf_counter()
    dataset_m = Dataset(Config(PROPS, cmd_args=["--recommender=SpectralCF"] + ML_ARGS))
    require((dataset_m.num_users, dataset_m.num_items) == (ML_USERS, ML_ITEMS),
            "path F: %d users, %d items" % (dataset_m.num_users, dataset_m.num_items))
    trainer_m, rec_m = zoo_trainer("SpectralCF", [], ZOO_STEPS["SpectralCF"], data=dataset_m)
    setup_m_s = time.perf_counter() - t - rec_m["train_s"]
    ev_m = trainer_m.evaluator.evaluator
    _build.reset_launches()
    result_m, eval_m_s = zoo_eval(trainer_m, trainer_m.params)
    paths["spectralcf"] = dict(_build.LAUNCHES)
    n_batches_m = -(-len(ev_m.test_users) // EVAL_USERS_PER_BATCH)
    require(paths["spectralcf"]["masked_scores"] == n_batches_m, "SpectralCF: %d K1 launches for %d eval batches"
            % (paths["spectralcf"]["masked_scores"], n_batches_m))
    with mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference):
        result_mp, _ = zoo_eval(trainer_m, trainer_m.params)
    diff_m = max(abs(a - b) for a, b in zip(parse_metrics(result_m), parse_metrics(result_mp)))
    # K1 at d 300 (the split) at path F's evaluation shape, on the trained tables
    I_m = dataset_m.num_items
    width_m = global_bits_width(I_m)
    with torch.no_grad():
        u_tab_m, i_tab_m = trainer_m.model.eval_tables(trainer_m.params)
    u_m = u_tab_m[torch.from_numpy(ev_m.test_users).long().cuda()].contiguous()
    bits_m = ev_m._get_bits_table(width_m, width_m)
    mask8_m = k1.build_train_mask(torch.from_numpy(ev_m._host_rows(ev_m.test_users)).cuda(), I_m)
    k1_check("masked_scores[d300]", lambda: k1.masked_scores_bits(u_m, i_tab_m, bits_m, width_m, I_m),
             lambda: k1.masked_scores_bits_reference(u_m, i_tab_m, bits_m, width_m, I_m),
             lambda: torch.where(mask8_m != 0, float("-inf"), torch.matmul(u_m, i_tab_m.T)),
             (u_m.numel() + i_tab_m.numel()) * 4 + bits_m.numel() + u_m.shape[0] * I_m * 4, u_m, i_tab_m,
             {"mode": "bits", "shape": [u_m.shape[0], I_m, u_m.shape[1]], "model": "SpectralCF",
              "library_call": "matmul + where on a prebuilt int8 mask"})
    emit({"phase": "spectralcf", **rec_m, "setup_s": setup_m_s, "num_users": ML_USERS, "num_items": ML_ITEMS,
          "train_nnz": int(dataset_m.train_matrix.nnz), "eval_users": len(ev_m.test_users),
          "eval_width": u_m.shape[1], "result": result_m, "eval_s": eval_m_s, "plain_result": result_mp,
          "metric_max_abs_diff": diff_m, "launches": paths["spectralcf"]})
    require(diff_m <= 1e-5, "SpectralCF: metrics differ from K1's plain version by %g" % diff_m)
    require(u_m.shape[1] == 300, "SpectralCF evaluates at width %d" % u_m.shape[1])
    del trainer_m, u_tab_m, i_tab_m, u_m, bits_m, mask8_m

    # -- 18. path G: the sequential family at ml-1m's shape ---------------------
    os.makedirs(ML1M_DIR, exist_ok=True)
    t = time.perf_counter()
    cols_g = ml1m_seeded_rows(np)
    with open(os.path.join(ML1M_DIR, "ml1m_seeded.rating"), "w") as fout:
        fout.write("".join("%d,%d,%d,%d\n" % row for row in zip(*(c.tolist() for c in cols_g))))
    gen_g_s = time.perf_counter() - t
    t = time.perf_counter()
    dataset_g = Dataset(Config(PROPS, cmd_args=["--recommender=FPMC"] + ML1M_ARGS))
    load_g_s = time.perf_counter() - t
    require((dataset_g.num_users, dataset_g.num_items, dataset_g.num_ratings) == (ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS),
            "path G: %d users, %d items, %d ratings" % (dataset_g.num_users, dataset_g.num_items,
                                                         dataset_g.num_ratings))
    emit({"phase": "ml1m_seeded", "generate_s": gen_g_s, "load_s": load_g_s, "users": dataset_g.num_users,
          "items": dataset_g.num_items, "ratings": dataset_g.num_ratings, "train_nnz": int(dataset_g.train_matrix.nnz),
          "test_nnz": int(dataset_g.test_matrix.nnz),
          "per_user": [int(x) for x in np.percentile(np.bincount(cols_g[0]), [0, 50, 99, 100])]})
    del cols_g
    I_g = dataset_g.num_items
    width_g = global_bits_width(I_g)
    seq_results, not_learned = {}, []
    for key, name, flags, steps, epochs, record, must_learn in SEQ_MODELS:
        conf_g = Config(PROPS, cmd_args=["--recommender=%s" % name] + ML1M_ARGS + flags)
        t = time.perf_counter()
        trainer_g = Trainer(get_model(name)(dataset_g, conf_g), dataset_g, conf_g)
        trainer_g.initialize()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        model_g, ev_g = trainer_g.model, trainer_g.evaluator.evaluator
        n_eval_g = len(ev_g.test_users)
        random_result = zoo_eval(trainer_g, trainer_g.params)[0] if must_learn else None
        losses, n_steps = [], 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for epoch in range(1, epochs + 1):
            trainer_g.params, trainer_g.opt_state, loss_g = trainer_g.train_epoch(epoch, max_steps=steps)
            losses.append(float(loss_g))
            n_steps += steps
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        require(all(np.isfinite(losses)), "%s: non-finite loss %s" % (name, losses))
        if model_g.data_kind in BUILT_IN_KINDS:
            graph_checks.append(graph_vs_eager(torch, key, trainer_g, graph_draws(torch, trainer_g, GRAPH_ZOO_STEPS,
                                                                                  SEED), GRAPH_ZOO_UNROLLS))
        else:
            custom_checks.append(custom_graph_check(torch, key, trainer_g))
        _build.reset_launches()
        result_g, eval_g_s = zoo_eval(trainer_g, trainer_g.params)
        paths[key] = dict(_build.LAUNCHES)
        if name in EVAL_GRAPH_USERS:
            eval_checks.append(eval_graph_check(torch, key, trainer_g, paths, EVAL_GRAPH_USERS[name]))
        n_batches_g = -(-n_eval_g // EVAL_USERS_PER_BATCH)
        rec_g = {"phase": key, "model": name, "flags": flags, "setup_s": setup_s, "data_kind": model_g.data_kind, "steps": n_steps, "epochs": epochs,
                 "batch_size": model_g.batch_size, "epoch_losses": losses, "train_s": train_s,
                 "ms_per_step": 1e3 * train_s / n_steps, "result": result_g, "eval_users": n_eval_g,
                 "eval_s": eval_g_s, "eval_users_per_s": n_eval_g / eval_g_s, "random_init_result": random_result,
                 "launches": paths[key]}
        if record is None:
            require(paths[key]["masked_scores"] == 0, "%s ranks on the predict tier, yet K1 ran" % name)
        else:
            require(paths[key]["masked_scores"] == n_batches_g, "%s: %d K1 launches for %d eval batches"
                    % (name, paths[key]["masked_scores"], n_batches_g))
            with mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference):
                result_p, _ = zoo_eval(trainer_g, trainer_g.params)
            diff = max(abs(a - b) for a, b in zip(parse_metrics(result_g), parse_metrics(result_p)))
            # K1 at the model's own factors, the first eval batch, against its plain version
            users_g = torch.from_numpy(ev_g.test_users[:EVAL_USERS_PER_BATCH]).long().cuda()
            with torch.no_grad():
                u_g, items_g = model_g.eval_embeddings(trainer_g.params, users_g)
            u_g, items_g = u_g.detach().contiguous(), items_g.detach().contiguous()
            d_g = u_g.shape[1]
            bits_g = ev_g._get_bits_table(width_g, width_g)[: u_g.shape[0]]
            mask8_g = k1.build_train_mask(torch.from_numpy(ev_g._host_rows(ev_g.test_users[: u_g.shape[0]])).cuda(),
                                          I_g)
            got_g = k1.masked_scores_bits(u_g, items_g, bits_g, width_g, I_g)
            want_g = k1.masked_scores_bits_reference(u_g, items_g, bits_g, width_g, I_g)
            (v_k, i_k), (v_p, i_p) = top_k(got_g, 20), top_k(want_g, 20)
            differ = (i_k != i_p).cpu().numpy()
            agree = 1.0 - differ.mean()
            near_tie = float((v_k - v_p).abs().max())
            if record in records:  # a width an earlier model of the path gave K1
                err_g, ok_g = compare(torch, got_g, want_g)
                mism_g = k1_chain_mismatches(torch, k1, got_g, want_g, u_g, items_g) \
                    if k1.k1_path(d_g) == "fma" else None
                emit({"phase": "kernel_case", "case": "%s[%s]" % (record, key), "shape": [u_g.shape[0], I_g, d_g],
                      "max_abs_err": err_g, "tol": "atol %g + rtol %g, -inf identical" % (ATOL, RTOL),
                      "chain_mismatches": mism_g})
                require(ok_g, "K1 at %s's factors disagrees with its plain version: %g" % (name, err_g))
                require(not mism_g, "K1 at %s's factors: %s scores differ from the fmaf chain's bits" % (name, mism_g))
            else:
                k1_check(record, lambda: k1.masked_scores_bits(u_g, items_g, bits_g, width_g, I_g),
                         lambda: k1.masked_scores_bits_reference(u_g, items_g, bits_g, width_g, I_g),
                         lambda: torch.where(mask8_g != 0, float("-inf"), torch.matmul(u_g, items_g.T)),
                         (u_g.numel() + items_g.numel()) * 4 + bits_g.numel() + u_g.shape[0] * I_g * 4, u_g, items_g,
                         {"mode": "bits", "shape": [u_g.shape[0], I_g, d_g], "model": name,
                          "library_call": "matmul + where on a prebuilt int8 mask"})
            rec_g.update({"eval_width": d_g, "k1_path": k1.k1_path(d_g), "plain_result": result_p,
                          "metric_max_abs_diff": diff, "top20_id_agreement": agree,
                          "max_top20_value_diff": near_tie})
            require(diff <= 1e-5, "%s: metrics differ from K1's plain version by %g" % (name, diff))
            require(agree >= 0.999, "%s: top-20 ids agree in only %.5f of positions" % (name, agree))
            del u_g, items_g, bits_g, mask8_g, got_g, want_g
        if must_learn:
            rec_g["learned_order"] = {"recall20": parse_metrics(result_g)[0],
                                      "random_recall20": parse_metrics(random_result)[0]}
            if parse_metrics(result_g)[0] <= parse_metrics(random_result)[0]:
                not_learned.append("%s: Recall@20 after training %s, random weights' %s"
                                   % (key, result_g, random_result))
        # one step's device time (the profiler) and wall time, over 5 steps
        if model_g.data_kind == "custom":
            prof = profile_steps(torch, lambda: trainer_g.train_epoch(epochs + 1, max_steps=5), n=1)
        else:
            draws_g = trainer_g.draw_epoch(trainer_g.epoch_generator(epochs + 1))
            params_c, opt_c = clone_state(trainer_g)
            prof = profile_steps(torch, lambda: trainer_g.run_epoch(params_c, opt_c, *(a[:5] for a in draws_g)), n=1)
            del draws_g, params_c, opt_c
        require(prof is not None, "%s: the profiler shows no kernel" % name)
        rec_g.update({"device_ms_per_step": prof["device_ms_per_step"] / 5,
                      "wall_ms_per_step_profiled": prof["wall_ms_per_step_profiled"] / 5,
                      "kernel_launches_per_step": prof["kernel_launches_per_step"] / 5,
                      "top_kernels": prof["kernels"][:5]})
        if name == "GRU4Rec":
            # a pad step (no valid entry) leaves the params and Adam as they were
            B_g = model_g.batch_size
            pad = (np.zeros((1, B_g), np.int32), np.zeros((1, B_g), np.int32), np.ones((1, B_g), bool),
                   np.zeros((1, B_g), bool))
            before = {path: p.detach().clone() for path, p in param_leaves(trainer_g.params)}
            adam_steps = {int(st["step"]) for st in trainer_g.opt_state.state.values()}
            _, _, pad_loss = model_g.run_schedule(trainer_g.params, trainer_g.opt_state, *pad,
                                                  torch.Generator(device="cuda"))
            same = all(torch.equal(p, before[path]) for path, p in param_leaves(trainer_g.params))
            rec_g["pad_step"] = {"params_bit_equal": same, "loss": float(pad_loss), "adam_steps": sorted(adam_steps)}
            require(same and {int(st["step"]) for st in trainer_g.opt_state.state.values()} == adam_steps,
                    "GRU4Rec's pad step changed the params or the optimizer")
        emit(rec_g)
        seq_results[key] = rec_g
        del trainer_g, model_g, ev_g
    emit({"phase": "path_g_checks", "learned_order": {k: v["learned_order"] for k, v in seq_results.items()
                                                      if "learned_order" in v},
          "eval_widths": {k: v.get("eval_width") for k, v in seq_results.items()}})
    require(not not_learned, "path G: not above random weights: %s" % "; ".join(not_learned))
    del dataset_g

    # -- 19. path H: the social family on gowalla -------------------------------
    os.makedirs(SOCIAL_DIR, exist_ok=True)
    t = time.perf_counter()
    src, dst, graph_h = social_graph(np, list(dataset.userids))
    social_path = os.path.join(SOCIAL_DIR, "gowalla_seeded.uu")
    with open(social_path, "w") as fout:
        fout.write("".join("%s,%s\n" % e for e in zip(src.tolist(), dst.tolist())))
    emit({"phase": "social_graph", **graph_h, "users": len(dataset.userids), "generate_s": time.perf_counter() - t})
    del src, dst
    n_batches = -(-n_eval // EVAL_USERS_PER_BATCH)
    for key, name, flags, must_learn in SOCIAL_MODELS:
        conf_h = Config(PROPS, cmd_args=["--recommender=%s" % name] + DATA_ARGS
                        + ["--social_file=%s" % social_path] + flags)
        t = time.perf_counter()
        trainer_h = Trainer(get_model(name)(dataset, conf_h), dataset, conf_h)
        trainer_h.initialize()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        model_h, ev_h = trainer_h.model, trainer_h.evaluator.evaluator
        random_result = zoo_eval(trainer_h, trainer_h.params)[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer_h.params, trainer_h.opt_state, loss_h = trainer_h.train_epoch(1, max_steps=SOCIAL_STEPS)
        loss_h = float(loss_h)
        train_s = time.perf_counter() - t
        require(np.isfinite(loss_h), "%s: non-finite loss %g" % (name, loss_h))
        if model_h.data_kind in BUILT_IN_KINDS:
            graph_checks.append(graph_vs_eager(torch, key, trainer_h, graph_draws(torch, trainer_h, GRAPH_ZOO_STEPS,
                                                                                  SEED), GRAPH_ZOO_UNROLLS))
        else:
            custom_checks.append(custom_graph_check(torch, key, trainer_h))
        _build.reset_launches()
        result_h, eval_h_s = zoo_eval(trainer_h, trainer_h.params)
        paths[key] = dict(_build.LAUNCHES)
        require(paths[key]["masked_scores"] == n_batches, "%s: %d K1 launches for %d eval batches"
                % (name, paths[key]["masked_scores"], n_batches))
        with mock.patch.object(k1, "masked_scores_bits", k1.masked_scores_bits_reference):
            result_p, _ = zoo_eval(trainer_h, trainer_h.params)
        # the top-20 ids of every test user through K1 and its plain version
        with torch.no_grad():
            tables = model_h.eval_tables(trainer_h.params) if hasattr(model_h, "eval_tables") else None
            bits_h = ev_h._get_bits_table(width, width)
            differ = 0
            for lo in range(0, n_eval, EVAL_USERS_PER_BATCH):
                users_h = torch.from_numpy(ev_h.test_users[lo:lo + EVAL_USERS_PER_BATCH]).long().cuda()
                u_h, items_h = (tables[0][users_h], tables[1]) if tables is not None else \
                    model_h.eval_embeddings(trainer_h.params, users_h)
                u_h, items_h = u_h.contiguous(), items_h.contiguous()
                bits_b = bits_h[lo:lo + EVAL_USERS_PER_BATCH]
                got_h = k1.masked_scores_bits(u_h, items_h, bits_b, width, I)
                want_h = k1.masked_scores_bits_reference(u_h, items_h, bits_b, width, I)
                differ += int((top_k(got_h, 20)[1] != top_k(want_h, 20)[1]).sum())
                if lo == 0:
                    err_h, ok_h = compare(torch, got_h, want_h)
                    d_h = u_h.shape[1]
                    mism_h = k1_chain_mismatches(torch, k1, got_h, want_h, u_h, items_h) \
                        if k1.k1_path(d_h) == "fma" else None
            del tables, got_h, want_h
        emit({"phase": "kernel_case", "case": "masked_scores[d16][%s]" % key, "shape": [EVAL_USERS_PER_BATCH, I, d_h],
              "max_abs_err": err_h, "tol": "atol %g + rtol %g, -inf identical" % (ATOL, RTOL),
              "chain_mismatches": mism_h})
        require(ok_h, "K1 at %s's factors disagrees with its plain version: %g" % (name, err_h))
        require(not mism_h, "K1 at %s's factors: %s scores differ from the fmaf chain's bits" % (name, mism_h))
        # one step's device time (the profiler) and wall time, over 5 steps
        if model_h.data_kind == "custom":
            prof = profile_steps(torch, lambda: trainer_h.train_epoch(2, max_steps=5), n=1)
        else:
            draws_h = trainer_h.draw_epoch(trainer_h.epoch_generator(2))
            params_c, opt_c = clone_state(trainer_h)
            prof = profile_steps(torch, lambda: trainer_h.run_epoch(params_c, opt_c, *(a[:5] for a in draws_h)), n=1)
            del draws_h, params_c, opt_c
        require(prof is not None, "%s: the profiler shows no kernel" % name)
        rec_h = {"phase": key, "model": name, "setup_s": setup_s, "data_kind": model_h.data_kind,
                 "embedding_size": model_h.embedding_size, "batch_size": model_h.batch_size,
                 "steps": SOCIAL_STEPS, "loss": loss_h, "train_s": train_s,
                 "ms_per_step": 1e3 * train_s / SOCIAL_STEPS,
                 "device_ms_per_step": prof["device_ms_per_step"] / 5,
                 "wall_ms_per_step_profiled": prof["wall_ms_per_step_profiled"] / 5,
                 "kernel_launches_per_step": prof["kernel_launches_per_step"] / 5, "top_kernels": prof["kernels"][:5],
                 "result": result_h, "plain_result": result_p, "random_init_result": random_result,
                 "eval_users": n_eval, "eval_s": eval_h_s, "eval_users_per_s": n_eval / eval_h_s,
                 "eval_width": d_h, "k1_path": k1.k1_path(d_h), "top20_ids_differing": differ,
                 "launches": paths[key]}
        if name == "SBPR":
            tb = model_h.table_bytes
            l_max_h = max(int(np.diff(dataset.train_matrix.indptr).max()), 8)
            l_pad = l_max_h + (-l_max_h) % 8
            reckoned = {"soc": 4 * dataset.num_users * model_h.max_s, "suk": 4 * dataset.num_users * model_h.max_s,
                        "excl": 4 * dataset.num_users * (l_pad + model_h.max_s)}
            rec_h.update({"max_s": model_h.max_s, "table_bytes": tb, "table_bytes_reckoned": reckoned,
                          "table_gb": sum(tb.values()) / 1e9, "positives_with_social": int(model_h._users_flat.shape[0]),
                          "steps_per_epoch": -(-int(model_h._users_flat.shape[0]) // model_h.batch_size)})
            require(tb == reckoned, "SBPR's tables hold %s bytes, reckoned %s" % (tb, reckoned))
        else:
            rec_h.update({"social_edges": int(model_h._soc_edges.cols.shape[0]), "steps_per_epoch": trainer_h.steps,
                          "item_features": bool(model_h._has_item_feat)})
        emit(rec_h)
        require(result_h == result_p, "%s: metrics %s through K1, %s through its plain version"
                % (name, result_h, result_p))
        require(differ == 0, "%s: %d top-20 ids differ from K1's plain version" % (name, differ))
        if must_learn:
            require(parse_metrics(result_h)[0] > parse_metrics(random_result)[0],
                    "%s: Recall@20 after training %s, random weights' %s" % (name, result_h, random_result))
        del trainer_h, model_h, ev_h
        torch.cuda.empty_cache()

    # -- 20. the sampled-candidates protocol on gowalla -------------------------
    t = time.perf_counter()
    conf_n = Config(PROPS, cmd_args=NORTHSTAR_ARGS + ["--rec.evaluate.neg=%d" % CAND_NEG])
    dataset_n = Dataset(conf_n)
    gen_n_s = time.perf_counter() - t
    neg_dict = dataset_n.get_user_test_neg_dict()
    train_d, test_d = dataset_n.get_user_train_dict(), dataset_n.get_user_test_dict()
    require(all(len(v) == CAND_NEG and not set(v) & (set(train_d.get(u, ())) | set(test_d.get(u, ())))
                for u, v in neg_dict.items()) and set(test_d) <= set(neg_dict),
            "the generated negatives are not %d unrated items a test user" % CAND_NEG)
    t = time.perf_counter()
    ev_n = Evaluator.from_dataset(dataset_n, conf_n)
    ev_n_cpu = Evaluator.from_dataset(dataset_n, conf_n, device="cpu")
    cand_setup_s = time.perf_counter() - t
    cand = {}
    for key, (model_n, params_n) in (("lightgcn", (tmodel, trainer.params)),
                                     ("mf", (trainer_mf64.model, trainer_mf64.params))):
        _build.reset_launches()
        t = time.perf_counter()
        result_n = ev_n.evaluate(model_n.predict, params_n)
        torch.cuda.synchronize()
        eval_n_s = time.perf_counter() - t
        paths["cand_" + key] = dict(_build.LAUNCHES)

        # the plain path: the same scores, the candidates ranked on the host
        def host_predict(p, users, model_n=model_n):
            return model_n.predict(p, users.cuda()).cpu()

        t = time.perf_counter()
        result_np = ev_n_cpu.evaluate(host_predict, params_n)
        plain_n_s = time.perf_counter() - t
        diff_n = max(abs(a - b) for a, b in zip(parse_metrics(result_n), parse_metrics(result_np)))
        cand[key] = {"result": result_n, "plain_result": result_np, "metric_max_abs_diff": diff_n,
                     "eval_s": eval_n_s, "plain_eval_s": plain_n_s, "launches": paths["cand_" + key]}
        require(diff_n <= 1e-6, "candidates, %s: metrics differ from the plain path by %g" % (key, diff_n))
        require(ev_n.evaluator._bits_tables == {}, "the candidate protocol built a bits table")
        values = parse_metrics(result_n)
        require(all(np.isfinite(values)) and all(0.0 <= m <= 1.0 for m in values),
                "candidates, %s: metrics out of range: %s" % (key, result_n))
    emit({"phase": "candidates", "neg": CAND_NEG, "generate_s": gen_n_s, "setup_s": cand_setup_s,
          "test_users": len(test_d), "tol": "metrics within 1e-6 (the per-user sums in another order)", **cand})
    del dataset_n, ev_n, ev_n_cpu, trainer_mf64, neg_dict, train_d, test_d

    # -- 21. the streamed bits tier ----------------------------------------------
    table_bytes = n_eval * width // 8
    with env_vars({"NEUREC_EVAL_BITS_BUDGET": str(table_bytes - 1)}):
        ev_s = Evaluator.from_dataset(dataset, conf)
        _build.reset_launches()
        t = time.perf_counter()
        result_s = ev_s.evaluate(tmodel.predict, trainer.params)
        torch.cuda.synchronize()
        eval_s_cold = time.perf_counter() - t
        t = time.perf_counter()
        result_s2 = ev_s.evaluate(tmodel.predict, trainer.params)
        torch.cuda.synchronize()
        eval_s_warm = time.perf_counter() - t
        paths["stream"] = dict(_build.LAUNCHES)
        plan_s = ev_s.evaluator._get_program(tmodel.predict).plan
    require(plan_s.stream and ev_s.evaluator._bits_tables == {}, "the streamed tier did not engage")
    t = time.perf_counter()
    result_t = evaluator.evaluate(tmodel.predict, trainer.params)
    torch.cuda.synchronize()
    eval_t_s = time.perf_counter() - t
    # the top-20 ids of every test user, on the packed planes and the
    # table's rows (a pad slot of the last batch packs no pair)
    users_sb, sel_sb, valid_sb = ev_s.evaluator._default_batches
    e_items, e_slots = ev_s.evaluator._edges[None]
    pack = tiers.make_edge_pack(plan_s.pack_block, plan_s.bits_width)
    with torch.no_grad():
        u_tab, i_tab = tmodel.eval_tables(trainer.params)
        ids_differ = 0
        for j in range(users_sb.shape[0]):
            u_j = u_tab[users_sb[j]].contiguous()
            planes = pack(e_items[j], e_slots[j], users_sb.shape[1])
            ids_s = top_k(k1.masked_scores_bits(u_j, i_tab, planes, width, I), 20)[1]
            ids_t = top_k(k1.masked_scores_bits(u_j, i_tab, evaluator.evaluator._get_bits_table(width, width)[sel_sb[j]],
                                                width, I), 20)[1]
            ids_differ += int((ids_s != ids_t)[valid_sb[j] > 0].sum())
        pack_ms = time_ms(torch, lambda: pack(e_items[0], e_slots[0], users_sb.shape[1]))
    emit({"phase": "stream", "budget": table_bytes - 1, "table_bytes": table_bytes, "result": result_s,
          "table_result": result_t, "eval_s_cold": eval_s_cold, "eval_s": eval_s_warm, "table_eval_s": eval_t_s,
          "edges_shape": list(e_items.shape), "edge_bytes": 2 * e_items.numel() * e_items.element_size(),
          "pack_ms": pack_ms, "top20_ids_differing": ids_differ, "launches": paths["stream"]})
    require(result_s == result_t == result_s2, "streamed metrics %s, the table's %s" % (result_s, result_t))
    require(ids_differ == 0, "%d streamed top-20 ids differ from the table's" % ids_differ)
    require(paths["stream"]["masked_scores"] == 2 * n_batches, "stream: %d K1 launches for %d eval batches"
            % (paths["stream"]["masked_scores"], 2 * n_batches))
    del ev_s, u_tab, i_tab

    # -- 22. path I: the Bloom sampler at ml-10m's shape -------------------------
    t = time.perf_counter()
    train_i, test_i, counts_i = ml10m_seeded(torch, np, sp)
    gen_i_s = time.perf_counter() - t
    ds_i = InMemoryDataset(train_i, test_i, name="ml10m_seeded")
    require((ds_i.num_users, ds_i.num_items, ds_i.num_ratings) == (ML10M_USERS, ML10M_ITEMS, ML10M_RATINGS),
            "path I: %d users, %d items, %d ratings" % (ds_i.num_users, ds_i.num_items, ds_i.num_ratings))
    conf_i = Config(PROPS, cmd_args=["--recommender=MF", "--config_dir=%s" % os.path.join(REPO, "conf"),
                                     "--topk=[20]", "--metric=[\"Recall\",\"NDCG\"]",
                                     "--test_batch_size=%d" % EVAL_USERS_PER_BATCH])
    t = time.perf_counter()
    trainer_i = Trainer(get_model("MF")(ds_i, conf_i), ds_i, conf_i)
    trainer_i.initialize()
    torch.cuda.synchronize()
    setup_i_s = time.perf_counter() - t
    require(trainer_i._excl_bloom is not None and not hasattr(trainer_i, "_padded_items"),
            "path I: the Bloom sampler did not engage")
    lens_i = np.diff(train_i.indptr)
    l_max_i = max(int(lens_i.max()), 8)
    padded_i = 4 * ML10M_USERS * (l_max_i + (-l_max_i) % 8)
    torch.cuda.synchronize()
    t = time.perf_counter()
    draws_i = trainer_i.draw_epoch(trainer_i.epoch_generator(1))
    torch.cuda.synchronize()
    draw_i_s = time.perf_counter() - t
    users_i = trainer_i._users_flat[trainer_i._base(draws_i.inst)].reshape(-1)
    t = time.perf_counter()
    trainer_i.bloom_negatives(torch.Generator(device="cuda").manual_seed(SEED), users_i)
    torch.cuda.synchronize()
    predraw_i_s = time.perf_counter() - t
    t = time.perf_counter()
    trainer_i.params, trainer_i.opt_state, loss_i = trainer_i.run_epoch(
        trainer_i.params, trainer_i.opt_state, *(a[:BLOOM_STEPS] for a in draws_i))
    loss_i = float(loss_i)
    steps_i_s = time.perf_counter() - t
    require(np.isfinite(loss_i), "path I: non-finite loss %g" % loss_i)
    # every negative of the epoch against the train CSR, on the card
    keys_train = torch.from_numpy(np.repeat(np.arange(ML10M_USERS, dtype=np.int64), lens_i) * ML10M_ITEMS
                                  + train_i.indices.astype(np.int64)).cuda().sort()[0]
    keys_neg = users_i * ML10M_ITEMS + draws_i.negs.reshape(-1).long()
    at = torch.searchsorted(keys_train, keys_neg).clamp_max(keys_train.numel() - 1)
    real = draws_i.w.reshape(-1) > 0
    positive = (keys_train[at] == keys_neg) & real
    kept = int(positive.sum())
    kept_cut = int(positive[: BLOOM_STEPS * draws_i.inst.shape[1]].sum())
    rounds = trainer_i._bloom_rounds
    dens = torch.from_numpy(lens_i / ML10M_ITEMS).cuda()[users_i][real]
    fp = 0.031
    expected = float(((dens + fp) ** rounds * dens / (dens + fp)).sum())
    from scipy.stats import poisson

    bound_i = float(poisson.isf(BLOOM_TAIL, expected))
    steps_i = trainer_i.steps
    rec_i = {"phase": "bloom", "users": ML10M_USERS, "items": ML10M_ITEMS, "ratings": ds_i.num_ratings,
             "train_nnz": int(train_i.nnz), "per_user": [int(x) for x in np.percentile(counts_i, [0, 50, 99, 100])],
             "generate_s": gen_i_s, "setup_s": setup_i_s, "padded_table_bytes": padded_i,
             "bloom_table_bytes": int(trainer_i._excl_bloom[0].numel()), "bloom_bits": trainer_i._excl_bloom[1],
             "k_hash": trainer_i._excl_bloom[2], "bloom_rounds": rounds, "d_max": float(lens_i.max() / ML10M_ITEMS),
             "steps_per_epoch": steps_i, "steps": BLOOM_STEPS, "loss": loss_i, "draw_epoch_s": draw_i_s,
             "predraw_s": predraw_i_s, "steps_s": steps_i_s, "ms_per_step": 1e3 * steps_i_s / BLOOM_STEPS,
             "predraw_ms_per_step": 1e3 * predraw_i_s / steps_i,
             "predraw_share_of_epoch": predraw_i_s / (draw_i_s + steps_i * steps_i_s / BLOOM_STEPS),
             "negatives_checked": int(real.sum()), "train_positives_kept": kept, "kept_in_cut_steps": kept_cut,
             "expected_kept": expected, "poisson_bound": bound_i, "tail": BLOOM_TAIL}
    emit(rec_i)
    require(kept <= bound_i, "path I: %d train positives among the negatives, over the bound %g (expected %g)"
            % (kept, bound_i, expected))
    del trainer_i, ds_i, train_i, test_i, draws_i, users_i, keys_train, keys_neg, at, positive, dens
    torch.cuda.empty_cache()

    # -- 23. checkpoint and resume: the north star through run.main --------------
    # phase 6 ran 2 epochs uninterrupted into CKPT_WHOLE; here 1 epoch into
    # CKPT_CUT, then a fresh run.main resumes it to epoch 2 (traced, phase 24)
    for path in (CKPT_CUT, TRACE_DIR):
        shutil.rmtree(path, ignore_errors=True)
    one_epoch = [a for a in TRAIN_ARGS if not a.startswith("--epochs=")] + ["--epochs=1"]
    _build.reset_launches()
    t = time.perf_counter()
    trainer_c, _ = run.main(PROPS, cmd_args=one_epoch + ["--ckpt_dir=%s" % CKPT_CUT])
    torch.cuda.synchronize()
    cut_s = time.perf_counter() - t
    paths["cut"] = dict(_build.LAUNCHES)
    saved = {"params": {n: v.detach().clone() for n, v in param_leaves(trainer_c.params)},
             "opt": copy.deepcopy(trainer_c.opt_state.state_dict())}
    ckpt_bytes = os.path.getsize(checkpoint.CheckpointManager(CKPT_CUT).path(1))
    scratch = checkpoint.CheckpointManager(os.path.join(CKPT_CUT, "timing"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    scratch.save(1, trainer_c.params, trainer_c.opt_state)
    save_s = time.perf_counter() - t
    del trainer_c

    restored = {}
    real_attach = checkpoint.attach_to_trainer

    def timed_attach(trainer_r, directory, every=1):
        """attach_to_trainer, its restore timed and the state it restored kept."""
        trainer_r.initialize()
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        start_r = real_attach(trainer_r, directory, every)
        torch.cuda.synchronize()
        restored.update(restore_s=time.perf_counter() - t_r, start=start_r,
                        params={n: v.detach().clone() for n, v in param_leaves(trainer_r.params)},
                        opt=copy.deepcopy(trainer_r.opt_state.state_dict()))
        return start_r

    _build.reset_launches()
    t = time.perf_counter()
    with mock.patch.object(checkpoint, "attach_to_trainer", timed_attach):
        trainer_r, result_r = run.main(PROPS, cmd_args=TRAIN_ARGS + ["--ckpt_dir=%s" % CKPT_CUT,
                                                                     "--trace_dir=%s" % TRACE_DIR])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    paths["resume"] = dict(_build.LAUNCHES)
    recs_r = run_records(trainer_r)
    # bit for bit: the params and Adam's moments and steps saved at epoch 1
    same_params = all(torch.equal(saved["params"][n], restored["params"][n]) for n in saved["params"])
    same_opt = saved["opt"]["param_groups"] == restored["opt"]["param_groups"] and all(
        torch.equal(st[key], restored["opt"]["state"][i][key])
        for i, st in saved["opt"]["state"].items() for key in st)
    loss_rel = abs(recs_r[0]["loss"] - recs[1]["loss"]) / abs(recs[1]["loss"])

    # a third run.main on the uninterrupted run's finished directory: it
    # evaluates the epoch-2 checkpoint and logs the final-epoch line
    _build.reset_launches()
    t = time.perf_counter()
    trainer_f, result_f = run.main(PROPS, cmd_args=TRAIN_ARGS + ["--ckpt_dir=%s" % CKPT_WHOLE])
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t
    paths["final_eval"] = dict(_build.LAUNCHES)
    with open(trainer_f.logger.path) as fin:
        final_line = "checkpoint already at final epoch %d; evaluating" % TRAIN_EPOCHS in fin.read()
    emit({"phase": "checkpoint", "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
          "restore_s": restored["restore_s"], "resumed_at_epoch": restored["start"],
          "restored_equal_to_saved": {"params": same_params, "adam": same_opt},
          "loss_uninterrupted": recs[1]["loss"], "loss_resumed": recs_r[0]["loss"], "loss_rel_diff": loss_rel,
          "tol": "resumed epoch-2 loss rtol %g; final evaluation's string identical" % RECORDED_RTOL,
          "result_uninterrupted": train_result, "result_resumed": result_r, "result_final_run": result_f,
          "final_epoch_line_logged": final_line, "run_main_s": {"cut": cut_s, "resume": resume_s, "final": final_s},
          "launches": {k: paths[k] for k in ("cut", "resume", "final_eval")}})
    require(restored["start"] == 2 and len(recs_r) == 1 and recs_r[0]["epoch"] == 2,
            "the resumed run started at %s with records %s" % (restored["start"], recs_r))
    require(same_params and same_opt, "the restored state differs from the one saved at epoch 1")
    require(loss_rel <= RECORDED_RTOL, "the resumed epoch-2 loss is %g from the uninterrupted run's" % loss_rel)
    require(final_line and result_f == train_result, "the finished run's evaluation %s is not the uninterrupted "
            "run's %s (final-epoch line logged: %s)" % (result_f, train_result, final_line))
    steps_r = trainer_r.steps
    for key, fwd, bwd, k1_n in (("cut", 3 * (steps_r + 1), 3 * steps_r, n_batches),
                                ("resume", 3 * (steps_r + 1), 3 * steps_r, n_batches),
                                ("final_eval", 3, 0, n_batches)):
        got = paths[key]
        require((got["plan_spmm"], got["plan_spmm_t"], got["masked_scores"]) == (fwd, bwd, k1_n),
                "%s: launches %s, expected K2 %d forward, %d backward, K1 %d" % (key, got, fwd, bwd, k1_n))
    del trainer_f

    # -- 24. the resumed run's device trace ---------------------------------------
    (trace_path,) = glob.glob(os.path.join(TRACE_DIR, "*.pt.trace.json"))
    trace = trace_events(trace_path)
    want_k = {"masked_scores": paths["resume"]["masked_scores"],
              "plan_spmm": paths["resume"]["plan_spmm"], "plan_spmm[bwd]": paths["resume"]["plan_spmm_t"]}
    got_k = trace["by_name"]
    emit({"phase": "trace", "trace_bytes": os.path.getsize(trace_path), "events": trace["events"],
          "kernel_events": trace["kernels"], "by_name": got_k, "launches": want_k,
          # a replayed K2 kernel is forward or backward: the two counted together
          "dropped": {"masked_scores": want_k["masked_scores"] - got_k["masked_scores"],
                      "plan_spmm, both ways": want_k["plan_spmm"] + want_k["plan_spmm[bwd]"]
                      - got_k["plan_spmm"] - got_k["plan_spmm[bwd]"] - got_k["plan_spmm[replayed]"]},
          "k2_unattributed": trace["k2_unattributed"], "path": os.path.relpath(trace_path, REPO)})
    require(trace["kernels"] > 0, "the device trace holds no kernel event")
    del trace

    # -- 25. the native host backend against the device backend -------------------
    conf_nat = Config(PROPS, cmd_args=NORTHSTAR_ARGS + ["--eval_backend=native", "--num_thread=%d" % NATIVE_THREADS])
    ev_nat = Evaluator.from_dataset(dataset, conf_nat)
    require(ev_nat.evaluator.backend == "native" and ev_nat.evaluator.num_thread == NATIVE_THREADS,
            "eval_backend=native was not taken")
    _build.reset_launches()
    t = time.perf_counter()
    result_nat = ev_nat.evaluate(tmodel.predict, trainer.params)
    nat_s = time.perf_counter() - t
    paths["native"] = dict(_build.LAUNCHES)
    _build.reset_launches()
    t = time.perf_counter()
    result_dev = evaluator.evaluate(tmodel.predict, trainer.params)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    paths["native_device"] = dict(_build.LAUNCHES)
    nat_diff = max(abs(a - b) for a, b in zip(parse_metrics(result_nat), parse_metrics(result_dev)))
    emit({"phase": "native", "result": result_nat, "device_result": result_dev, "metric_max_abs_diff": nat_diff,
          "tol": "metrics within 1e-5 (tests/test_native.py's bar between the backends)",
          "eval_s": nat_s, "device_eval_s": dev_s, "num_thread": NATIVE_THREADS, "eval_users": n_eval,
          "host_bytes": n_eval * I * 4, "launches": {"native": paths["native"], "device": paths["native_device"]}})
    require(nat_diff <= 1e-5, "native metrics differ from the device backend's by %g" % nat_diff)
    require(paths["native"]["masked_scores"] == 0 and paths["native"]["plan_spmm"] == 3 * n_batches,
            "native: launches %s" % paths["native"])
    require(paths["native_device"]["masked_scores"] == n_batches, "native_device: %s" % paths["native_device"])
    del ev_nat

    # -- 26. the exact segment top-K against top_k --------------------------------
    rng_f = np.random.RandomState(SEED + 5)
    x_randn = torch.from_numpy(rng_f.standard_normal((EVAL_USERS_PER_BATCH, I)).astype(np.float32)).cuda()
    users_0, sel_0, _ = (b[0] for b in evaluator.evaluator._default_batches)
    with torch.no_grad():
        u_tab, i_tab = tmodel.eval_tables(trainer.params)
        x_k1 = k1.masked_scores_bits(u_tab[users_0].contiguous(), i_tab,
                                     evaluator.evaluator._get_bits_table(width, width)[sel_0], width, I)
    del u_tab, i_tab
    topk_rep = topk_ab.run({"randn": x_randn, "northstar_k1": x_k1}, ks=FAST_TOPK_KS, iters=20,
                           device_ms=lambda fn: device_ms(torch, fn)[0])
    emit({"phase": "fast_topk", "results": topk_rep,
          "tol": "ids equal to top_k's wherever the overflow is 0 (a non-zero overflow is reported)"})
    del x_randn, x_k1

    # -- 15. ``python -m neurec_tpu_torch.run`` for each model of paths C and D
    run_dir = os.path.join(REPO, "build", "run_main")
    os.makedirs(run_dir, exist_ok=True)
    rng_r = np.random.RandomState(SEED)
    with open(os.path.join(run_dir, "synthetic.rating"), "w") as fout:
        fout.write("".join("%d,%d,%d\n" % (u, i, rng_r.randint(1, 6)) for u in range(RUN_USERS)
                           for i in rng_r.choice(RUN_ITEMS, rng_r.randint(5, 30), replace=False)))
    run_args = ["--config_dir=%s" % os.path.join(REPO, "conf"), "--data.input.path=%s" % run_dir,
                "--data.cache.path=%s" % run_dir, "--data.input.dataset=synthetic", "--data.column.format=UIR",
                "--data.convert.separator=','", "--topk=[20]", "--metric=[\"Recall\",\"NDCG\"]", "--epochs=1",
                "--pretrain_file=", "--mf_pretrain=", "--mlp_pretrain="]
    run_seq_dir = os.path.join(REPO, "build", "run_main_seq")
    os.makedirs(run_seq_dir, exist_ok=True)
    rng_s = np.random.RandomState(SEED + 1)
    with open(os.path.join(run_seq_dir, "synthetic_seq.rating"), "w") as fout:
        fout.write("".join("%d,%d,%d,%d\n" % (u, i, rng_s.randint(1, 6), 1000 + t) for u in range(RUN_SEQ_USERS)
                           for t, i in enumerate(rng_s.choice(RUN_SEQ_ITEMS, rng_s.randint(10, 40), replace=False))))
    run_seq_args = ["--config_dir=%s" % os.path.join(REPO, "conf"), "--data.input.path=%s" % run_seq_dir,
                    "--data.cache.path=%s" % run_seq_dir, "--data.input.dataset=synthetic_seq",
                    "--data.column.format=UIRT", "--data.convert.separator=','", "--splitter=loo", "--by_time=True",
                    "--user_min=0", "--item_min=0", "--topk=[20]", "--metric=[\"Recall\",\"NDCG\"]", "--epochs=1"]
    rng_u = np.random.RandomState(SEED + 2)
    run_social = os.path.join(run_dir, "synthetic.uu")
    with open(run_social, "w") as fout:
        fout.write("".join("%d,%d\n" % (u, f) for u in range(RUN_USERS) for f in rng_u.choice(RUN_USERS, 5, replace=False)))
    run_social_args = run_args + ["--social_file=%s" % run_social, "--num_epochs=1", "--user_feature_file=",
                                  "--item_feature_file="]
    for name, args in ([(m, run_args) for m in RUN_MODELS] + [(m, run_seq_args) for m in RUN_SEQ_MODELS]
                       + [(m, run_social_args) for m in RUN_SOCIAL_MODELS]):
        t = time.perf_counter()
        trainer_r, result_r = run.main(PROPS, cmd_args=["--recommender=%s" % name] + args)
        torch.cuda.synchronize()
        trains = trainer_r.model.data_kind != "none"  # Pop and ItemKNN evaluate only
        recs_r = run_records(trainer_r) if trains else []
        values = parse_metrics(result_r)
        emit({"phase": "run_main", "model": name, "device": str(trainer_r.device), "steps": trainer_r.steps,
              "loss": recs_r[-1]["loss"] if recs_r else None, "result": result_r,
              "seconds": time.perf_counter() - t})
        require(trainer_r.device.type == "cuda" and (not trains or (len(recs_r) == 1 and np.isfinite(
            recs_r[0]["loss"]))), "run.main %s: %s on %s" % (name, recs_r, trainer_r.device))
        require(all(np.isfinite(values)) and all(0.0 <= m <= 1.0 for m in values),
                "run.main %s: metrics out of range: %s" % (name, result_r))
        del trainer_r

    # -- 27. mesh1: the north star through run.main on a one-rank mesh -------
    from types import SimpleNamespace

    from neurec_tpu_torch.bridge import params_to_numpy
    from neurec_tpu_torch.ops.graph import shard_adjacency
    from neurec_tpu_torch.parallel.distributed import initialize_multihost, shutdown
    from neurec_tpu_torch.parallel.mesh import make_mesh

    initialize_multihost("127.0.0.1:%d" % _free_port(), 1, 0, backend="nccl")
    mesh1 = make_mesh(n_data=1, n_model=1)
    _build.reset_launches()
    t = time.perf_counter()
    trainer_mesh1, result_mesh1 = run.main(PROPS, cmd_args=TRAIN_ARGS, mesh=mesh1)
    torch.cuda.synchronize()
    paths["mesh1"] = dict(_build.LAUNCHES)
    recs_mesh1 = run_records(trainer_mesh1)
    loss_rel_mesh1 = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(recs_mesh1, recs))
    emit({"phase": "mesh1", "mesh": repr(mesh1), "device": str(trainer_mesh1.device),
          "tier": trainer_mesh1.evaluator.evaluator._get_program(trainer_mesh1.model.predict).plan.name,
          "result": result_mesh1, "phase6_result": train_result, "losses": [r["loss"] for r in recs_mesh1],
          "phase6_losses": [r["loss"] for r in recs], "loss_max_rel_diff": loss_rel_mesh1,
          "run_main_s": time.perf_counter() - t, "launches": paths["mesh1"],
          "tol": "metric string equal, losses rtol %g" % TRAIN_LOSS_RTOL})
    require(len(recs_mesh1) == len(recs) and loss_rel_mesh1 <= TRAIN_LOSS_RTOL,
            "mesh1: losses %s, phase 6's %s" % (recs_mesh1, recs))
    require(result_mesh1 == train_result, "mesh1: %r, phase 6: %r" % (result_mesh1, train_result))
    require(all(paths["mesh1"][k] == train_launches[k] for k in ("masked_scores", "plan_spmm", "plan_spmm_t")),
            "mesh1 launches %s, phase 6's %s" % (paths["mesh1"], train_launches))
    del trainer_mesh1
    shutdown()

    # -- 28-29. dp2 and itemshard2: two ranks sharing the card (gloo) --------
    import pickle

    import torch.multiprocessing as mp

    os.makedirs(MESH_DIR, exist_ok=True)
    for f in glob.glob(os.path.join(MESH_DIR, "rank*.pkl")):
        os.unlink(f)
    t_mesh = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(_free_port(), MESH_DIR), nprocs=2, join=False, start_method="spawn")
    # the one-rank run on the same draws, while the ranks start
    conf_dp = Config(PROPS, cmd_args=TRAIN_ARGS + ["--graph_shard=on"])
    model_dp = get_model("LightGCN")(dataset, conf_dp)
    trainer_dp = Trainer(model_dp, dataset, conf_dp, logger=SilentLogger())
    trainer_dp.initialize()
    losses_dp = mesh_steps(trainer_dp, trainer_dp.draw_epoch(trainer_dp.epoch_generator(1)), MESH_STEPS)
    result_dp = trainer_dp.evaluate()
    try:
        while not ctx.join(timeout=5.0):
            require(time.perf_counter() - t_mesh < MESH_TIMEOUT_S, "the two ranks did not finish")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = []
    for r in range(2):
        with open(os.path.join(MESH_DIR, "rank%d.pkl" % r), "rb") as fin:
            ranks.append(pickle.load(fin))
        require("error" not in ranks[r], "mesh rank %d failed:\n%s" % (r, ranks[r].get("error")))
    mesh_s = time.perf_counter() - t_mesh
    params_r0 = params_from_numpy(ranks[0]["params"])
    with torch.no_grad():
        param_err_dp = max(float((params_r0[k] - trainer_dp.params[k]).abs().max()) for k in params_r0)
    # the replicated tier (phase 2's evaluator) on rank 0's trained params
    ev_rep = evaluator.evaluator
    ev_rep.record_ids = True
    result_rep = ev_rep.evaluate(model.predict, params_r0)
    ids_rep = ev_rep.last_ids[:, :20].cpu().numpy()
    ev_rep.record_ids = False
    n_test = len(ev_rep.test_users)
    n_batches_eval = -(-n_test // EVAL_USERS_PER_BATCH)
    block_dp = ranks[0]["dp2"]["block"]
    I_m, _ = tiers.shard_bits_geometry(I, 2)
    paths["dp2"], paths["itemshard2"], paths["itemshard2_rows"] = (
        ranks[0][k]["launches"] for k in ("dp2", "itemshard2", "itemshard2_rows"))
    loss_rel_dp = [max(abs(a - b) / abs(b) for a, b in zip(rk["dp2"]["losses"], losses_dp)) for rk in ranks]
    metric_err_dp = [max(abs(a - b) for a, b in zip(parse_metrics(rk["dp2"]["result"]), parse_metrics(result_dp)))
                     for rk in ranks]
    emit({"phase": "dp2", "mesh": [2, 1], "backend": "gloo, staged through the host", "steps": MESH_STEPS,
          "seconds": mesh_s, "losses": ranks[0]["dp2"]["losses"], "one_rank_losses": losses_dp,
          "loss_max_rel_diff": loss_rel_dp, "param_max_abs_diff": param_err_dp, "result": ranks[0]["dp2"]["result"],
          "one_rank_result": result_dp, "replicated_result_same_params": result_rep,
          "metric_max_abs_diff": metric_err_dp, "block": block_dp,
          "ranks": [{k: rk["dp2"][k] for k in ("setup_s", "steps_s", "eval_s", "tier", "launches", "k2_rows",
                                                "k2_t_rows", "k1_shapes")} for rk in ranks],
          "tol": "params atol %g, losses rtol %g, metrics atol %g, strings equal"
                 % (MESH_PARAM_ATOL, MESH_LOSS_RTOL, MESH_METRIC_ATOL)})
    for r, rk in enumerate(ranks):
        got = rk["dp2"]
        require(got["tier"] == "bits_dp", "dp2 rank %d evaluated on %s" % (r, got["tier"]))
        require(got["result"] == result_dp and got["result"] == result_rep,
                "dp2 rank %d: %r, the one-rank run %r, replicated %r" % (r, got["result"], result_dp, result_rep))
        require(loss_rel_dp[r] <= MESH_LOSS_RTOL and metric_err_dp[r] <= MESH_METRIC_ATOL,
                "dp2 rank %d: losses %g, metrics %g from the one-rank run" % (r, loss_rel_dp[r], metric_err_dp[r]))
        require(got["k2_rows"] == [block_dp] and got["k2_t_rows"] == [got["n_nodes"]]
                and block_dp == -(-got["n_nodes"] // 2), "dp2 rank %d: K2 rows %s, %s" % (r, got["k2_rows"],
                                                                                          got["k2_t_rows"]))
        n_layers = model_dp.n_layers
        require((got["launches"]["plan_spmm"], got["launches"]["plan_spmm_t"], got["launches"]["masked_scores"])
                == (n_layers * (MESH_STEPS + 1), n_layers * MESH_STEPS, n_batches_eval),
                "dp2 rank %d launches %s" % (r, got["launches"]))
        require(got["k1_shapes"] == [(EVAL_USERS_PER_BATCH // 2, I)], "dp2 rank %d K1 shapes %s"
                % (r, got["k1_shapes"]))
    require(param_err_dp <= MESH_PARAM_ATOL, "dp2 params differ from the one-rank run by %g" % param_err_dp)
    for key, tier, k1_cols in (("itemshard2", "item_shard_bits", I_m), ("itemshard2_rows", "item_shard_rows",
                                                                        -(-I // 2))):
        ids_differ = [int((rk[key]["ids"][:n_test] != ids_rep[:n_test]).sum()) for rk in ranks]
        emit({"phase": key, "mesh": [1, 2], "tier": tier, "result": ranks[0][key]["result"],
              "replicated_result": result_rep, "top20_ids_differing": ids_differ, "block_items": k1_cols,
              "ranks": [{k: rk[key][k] for k in ("eval_s", "tier", "launches", "k1_shapes")} for rk in ranks]})
        for r, rk in enumerate(ranks):
            got = rk[key]
            require(got["tier"] == tier and got["result"] == result_rep and ids_differ[r] == 0,
                    "%s rank %d: %s %r, replicated %r, %d ids differ" % (key, r, got["tier"], got["result"],
                                                                       result_rep, ids_differ[r]))
            require(got["k1_shapes"] == [(EVAL_USERS_PER_BATCH, k1_cols)]
                    and got["launches"]["masked_scores"] == n_batches_eval,
                    "%s rank %d: K1 %s, %s" % (key, r, got["k1_shapes"], got["launches"]))
    del trainer_dp, model_dp, params_r0, ranks

    # the mesh paths' kernel shapes against their plain versions: K1 on a
    # rank's half of a batch and on a rank's item block, K2 both ways on a
    # rank's block plan
    with torch.no_grad():
        u_table_m, item_table_m = model.propagate(params)
    u_full = u_table_m[users].contiguous()
    half = EVAL_USERS_PER_BATCH // 2
    u_half, bits_half, mask8_half = u_full[:half].contiguous(), bits[:half].contiguous(), mask8[:half]
    k1_check("masked_scores[dp]", lambda: k1.masked_scores_bits(u_half, item_table_m, bits_half, width, I),
             lambda: k1.masked_scores_bits_reference(u_half, item_table_m, bits_half, width, I),
             lambda: torch.where(mask8_half != 0, float("-inf"), torch.matmul(u_half, item_table_m.T)),
             (half + I) * d * 4 + bits_half.numel() + half * I * 4, u_half, item_table_m,
             {"mode": "bits", "shape": [half, I, d], "library_call": "matmul + where on a prebuilt int8 mask",
              "mesh": "bits_dp, a rank's rows of a batch on a (2, 1) mesh"})
    items_blk = tiers._item_block(item_table_m, 0, I_m)
    bits_blk = k1.pack_train_bits(train_rows, I, block_items=I_m)[:, : I_m // 8].contiguous()
    mask8_blk = k1.build_train_mask(train_rows, I_m)
    k1_check("masked_scores[block]", lambda: k1.masked_scores_bits(u_full, items_blk, bits_blk, I_m, I_m),
             lambda: k1.masked_scores_bits_reference(u_full, items_blk, bits_blk, I_m, I_m),
             lambda: torch.where(mask8_blk != 0, float("-inf"), torch.matmul(u_full, items_blk.T)),
             (B + I_m) * d * 4 + bits_blk.numel() + B * I_m * 4, u_full, items_blk,
             {"mode": "bits", "shape": [B, I_m, d], "library_call": "matmul + where on a prebuilt int8 mask",
              "mesh": "item_shard_bits, 'model' block 0 of 2, its own (B, I_m/8) table packed per block"})
    blk = shard_adjacency(model.adj, SimpleNamespace(shape={"data": 2, "model": 1},
                                                     coordinate={"data": 0, "model": 0}))
    blk_r, blk_c, blk_v = (t.cpu().numpy() for t in (blk.rows_local, blk.cols, blk.vals))
    real = blk_v != 0
    blk_edges = sp.csr_matrix((blk_v[real], (blk_r[real], blk_c[real])), shape=(blk.block, model.adj.n_nodes))
    ego_m = torch.cat([params["user_emb"], params["item_emb"]], dim=0).contiguous()
    g_blk = torch.from_numpy(
        np.random.RandomState(SEED + 5).standard_normal((blk.block, d)).astype(np.float32)).cuda()
    spmm_check("plan_spmm[block]", k2_src, "neurec_tpu/ops/pallas_spmm.py:144", blk.plan, ego_m, 1,
               sparse_csr(torch, np, blk_edges), ego_m, {"mesh": "a 'data' rank's row block of 2"})
    spmm_check("plan_spmm[bwd,block]", k2_src, "neurec_tpu/ops/pallas_spmm.py:504", blk.plan_t, g_blk, 1,
               sparse_csr(torch, np, blk_edges.T.tocsr()), g_blk, {"mesh": "a 'data' rank's row block of 2"})
    del u_table_m, item_table_m, u_full, items_blk, bits_blk, mask8_blk, blk, ego_m, g_blk

    # -- 30. tp2: the id tables row-sharded over 'model' (two ranks, gloo) ---
    tp_phase(dataset, n_batches_eval, I_m, paths)

    # -- 31. dp2_custom: the custom epochs split over 'data' (two ranks) -----
    kept = custom_dp_phase(dataset, paths)
    half = EVAL_USERS_PER_BATCH // 2
    for key, name, data, flags, steps, n_eval, record in CUSTOM_RUNS:
        if record is None:
            continue
        # K1 at a rank's rows of the first evaluation batch, the model's trained factors
        trainer_k = kept.pop(key)
        ev_k = trainer_k.evaluator.evaluator
        with torch.no_grad():
            u_k, items_k = trainer_k.model.eval_embeddings(
                trainer_k.params, torch.from_numpy(ev_k.test_users[:half]).long().cuda())
        u_k, items_k = u_k.detach().contiguous(), items_k.detach().contiguous()
        I_k, d_k = items_k.shape[0], u_k.shape[1]
        width_k = global_bits_width(I_k)
        bits_k = ev_k._get_bits_table(width_k, width_k)[:half]
        mask8_k = k1.build_train_mask(torch.from_numpy(ev_k._host_rows(ev_k.test_users[:half])).cuda(), I_k)
        k1_check(record, lambda: k1.masked_scores_bits(u_k, items_k, bits_k, width_k, I_k),
                 lambda: k1.masked_scores_bits_reference(u_k, items_k, bits_k, width_k, I_k),
                 lambda: torch.where(mask8_k != 0, float("-inf"), torch.matmul(u_k, items_k.T)),
                 (u_k.numel() + items_k.numel()) * 4 + bits_k.numel() + half * I_k * 4, u_k, items_k,
                 {"mode": "bits", "shape": [half, I_k, d_k], "model": name,
                  "library_call": "matmul + where on a prebuilt int8 mask",
                  "mesh": "bits_dp, a rank's rows of a batch on a (2, 1) mesh"})
        del trainer_k, ev_k, u_k, items_k, bits_k, mask8_k
    del kept

    # -- 32. graph: the built-in epochs' steps as CUDA-graph replays ------------
    # (each check ran beside its path's trainer: the graph_check lines above)
    graph_models = sorted({c["model"] for c in graph_checks})
    emit({"phase": "graph", "checks": len(graph_checks), "models": graph_models,
          "equal_bits": {c["path"]: all(c[k]["vs_eager"]["equal_bits"] for k in c if k.startswith("graph_u"))
                         for c in graph_checks},
          "eager_runs_equal_bits": {c["path"]: c["eager_vs_eager"]["equal_bits"] for c in graph_checks},
          "seconds": sum(c["seconds"] for c in graph_checks),
          "captured_by_call": {c["path"]: {k: [call["captured"] for call in c[k]["calls"]] for k in c
                                           if k.startswith("graph_u")} for c in graph_checks},
          "ms_per_step_past_first": {c["path"]: {k: c[k]["ms_per_step_past_first"] for k in c
                                                 if k == "eager" or k.startswith("graph_u")} for c in graph_checks},
          "ms_per_step_kept": {c["path"]: {k: c[k]["ms_per_step_kept"] for k in c
                                           if k == "eager" or k.startswith("graph_u")} for c in graph_checks},
          "device_ms_per_step": {c["path"]: {k: (c[k]["device_ms_per_step"], c[k]["idle_share"]) for k in c
                                             if k == "eager" or k.startswith("graph_u")}
                                 for c in graph_checks if "device_ms_per_step" in c["eager"]},
          "card": smi})
    require(len(graph_models) == GRAPH_MODELS, "phase 32 checked %d built-in-epoch models: %s"
            % (len(graph_models), graph_models))

    # -- 33. graph_custom: the custom epochs' steps as CUDA-graph replays -------
    # (each check ran beside its path's trainer: the graph_custom_check lines above)
    custom_models = sorted(c["model"] for c in custom_checks)
    modes = ("eager",) + tuple("graph_u%d" % u for u in GRAPH_CUSTOM_UNROLLS)
    emit({"phase": "graph_custom", "checks": len(custom_checks), "models": custom_models,
          "equal_bits": {c["path"]: all(c[k]["vs_eager"]["equal_bits"] for k in modes[1:]) for c in custom_checks},
          "eager_runs_equal_bits": {c["path"]: c["eager_vs_eager"]["equal_bits"] for c in custom_checks},
          "seconds": sum(c["seconds"] for c in custom_checks),
          "captured_by_call": {c["path"]: {k: [call["captured"] for call in c[k]["calls"]] for k in modes[1:]}
                               for c in custom_checks},
          "ms_per_step_past_first": {c["path"]: {k: c[k]["ms_per_step_past_first"] for k in modes}
                                     for c in custom_checks},
          "ms_per_step_kept": {c["path"]: {k: c[k]["ms_per_step_kept"] for k in modes} for c in custom_checks},
          "device_ms_per_step": {c["path"]: c["device_ms_per_step"] for c in custom_checks},
          "idle_share": {c["path"]: {k: c[k]["idle_share"] for k in modes} for c in custom_checks},
          "card": smi})
    require(custom_models == sorted(GRAPH_CUSTOM_MODELS), "phase 33 checked the custom epochs of %s, not %s"
            % (custom_models, sorted(GRAPH_CUSTOM_MODELS)))
    require(len(graph_models) + len(custom_models) == GRAPH_MODELS + len(GRAPH_CUSTOM_MODELS) == 32,
            "phases 32 and 33 checked %d stepped models, not 32" % (len(graph_models) + len(custom_models)))

    # -- 34. eval_graph: the evaluation and the serving export as CUDA graphs ---
    # (each check ran beside its path's trainer: the eval_graph_check lines above)
    by_mode = lambda f: {c["path"]: {m: f(c[m]) for m in ("eager", "graph")} for c in eval_checks}  # noqa: E731
    emit({"phase": "eval_graph", "checks": len(eval_checks), "paths": [c["path"] for c in eval_checks],
          "eval_users": {c["path"]: c["eval_users"] for c in eval_checks},
          "equal": dict({c["path"]: c["equal"] for c in eval_checks + serving_checks}),
          "eval_cold_s": by_mode(lambda r: r["eval_cold_s"]),
          "eval_warm_s": by_mode(lambda r: float(np.median(r["eval_warm_s"]))),
          "device_ms": by_mode(lambda r: r["device_ms"]), "idle_share": by_mode(lambda r: r["idle_share"]),
          "graph_launches_per_warm_call": by_mode(lambda r: r["graph_launches_per_warm_call"]),
          "pool_bytes": {c["path"]: c["graph"]["pool_bytes"] for c in eval_checks},
          "serving_request_s": {c["path"]: {m: c[m]["serving_request_s"] for m in ("eager", "graph")}
                                for c in serving_checks},
          "serving_device_ms": {c["path"]: {m: c[m]["device_ms"] for m in ("eager", "graph")} for c in serving_checks},
          "serving_idle_share": {c["path"]: {m: c[m]["idle_share"] for m in ("eager", "graph")}
                                 for c in serving_checks},
          "serving_pool_bytes": {c["path"]: c["graph"]["pool_bytes"] for c in serving_checks},
          "seconds": sum(c["seconds"] for c in eval_checks), "card": smi})
    require(sorted(c["path"] for c in eval_checks) == sorted(EVAL_GRAPH_PATHS),
            "phase 34 checked %s, not %s" % ([c["path"] for c in eval_checks], list(EVAL_GRAPH_PATHS)))

    # -- the kernels line ----------------------------------------------------
    lightgcn_paths = ("serve", "train", "pack2") + tuple(v[0] for v in VARIANT_PATHS)
    entry_paths = {
        "masked_scores": ("masked_scores", lightgcn_paths + ("apr", "stream", "cut", "resume", "final_eval",
                                                             "native_device", "mesh1", "tp2", "tp2_mf",
                                                             "eval_graph_northstar")),
        "masked_scores[dp]": ("masked_scores", ("dp2",)),
        "masked_scores[d16,dp]": ("masked_scores", ("dp2_sbpr",)),
        "masked_scores[d21,dp]": ("masked_scores", ("dp2_irgan",)),
        "masked_scores[d100,dp]": ("masked_scores", ("dp2_caser",)),
        "masked_scores[block]": ("masked_scores", ("itemshard2", "tp2_item_shard")),
        "masked_scores[d17]": ("masked_scores", ("fism",)),
        "masked_scores[int8]": ("masked_scores", ("serve_int8", "itemshard2_rows")),
        "masked_scores[d256]": ("masked_scores", ("ngcf", "eval_graph_ngcf")),
        "masked_scores[d1]": ("masked_scores", ("pop",)),
        "masked_scores[d16]": ("masked_scores", ("wrmf", "sbpr", "diffnet")),
        "masked_scores[d21]": ("masked_scores", ("irgan",)),
        "masked_scores[d33]": ("masked_scores", ("multidae", "multivae")),
        "masked_scores[d40]": ("masked_scores", ()),
        "masked_scores[d65]": ("masked_scores", ("cdae",)),
        "masked_scores[d300]": ("masked_scores", ("spectralcf",)),
        "masked_scores[d32]": ("masked_scores", ("fpmc", "fpmc_bpr")),
        "masked_scores[d17,ml1m]": ("masked_scores", ("fossil",)),
        "masked_scores[d16,ml1m]": ("masked_scores", ("hrm",)),
        "masked_scores[d64,ml1m]": ("masked_scores", ("npe",)),
        "masked_scores[d50]": ("masked_scores", ("sasrec",)),
        "masked_scores[d100]": ("masked_scores", ("caser",)),
        "masked_scores[d101]": ("masked_scores", ("gru4rec", "gru4recplus", "eval_graph_gru4rec")),
        "plan_spmm": ("plan_spmm", ("serve", "train", "ngcf", "cut", "resume", "final_eval", "native",
                                    "native_device", "mesh1", "tp2", "tp2_item_shard", "eval_graph_northstar",
                                    "eval_graph_ngcf", "serve_graph")),
        "plan_spmm[bwd]": ("plan_spmm_t", ("train", "ngcf", "cut", "resume", "mesh1", "tp2")),
        "plan_spmm[block]": ("plan_spmm", ("dp2", "itemshard2", "itemshard2_rows")),
        "plan_spmm[bwd,block]": ("plan_spmm_t", ("dp2",)),
        "plan_spmm[bf16]": ("plan_spmm", ("bf16",)),
        "plan_spmm[bwd,bf16]": ("plan_spmm_t", ("bf16",)),
    }
    for pack in (2, 4):
        for dt, suffix in (("", ""), ("_bf16", ",bf16")):
            path = "pack%d%s" % (pack, dt)
            entry_paths["plan_spmm_packed[pack%d%s]" % (pack, suffix)] = (
                "plan_spmm_packed", (path,) + (("eval_graph_pack2",) if path == "pack2" else ()))
            entry_paths["plan_spmm_packed[bwd,pack%d%s]" % (pack, suffix)] = ("plan_spmm_packed_t", (path,))
    for rows in dma_rate.ROWS_LIST:
        for mode in dma_rate.MODES:
            entry_paths["dma_rate[%s,%dB]" % (mode, rows * 512)] = ("dma_rate_" + mode, ("probe",))
    require(set(entry_paths) == set(records), "kernel records %s" % sorted(set(records) ^ set(entry_paths)))
    for name, (key, on) in entry_paths.items():
        rec = records[name]
        rec["launches_by_path"] = {p: paths[p][key] for p in on}
        rec["launches"] = sum(rec["launches_by_path"].values())
        require(rec["launches"] > 0 or not on, "%s was launched on no path: %s" % (name, rec["launches_by_path"]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path")
    # device times where they were taken (the SpMM kernels), None elsewhere
    extra_keys = ("path", "mesh", "device_ms", "host_ms", "library_device_ms", "bound_f32_ms", "max_scaled_err",
                  "err_vs_f64", "plain_err_vs_f64", "err_over_f32_bound", "err_over_split_bound", "matmul_ms",
                  "matmul_device_ms", "mask_build_ms", "kernel_ms", "chain_mismatches", "turns_ms",
                  "k1_over_matmul")
    emit({"kernels": [dict({k: records[n][k] for k in keys}, **{k: records[n].get(k) for k in extra_keys})
                      for n in entry_paths]})
    stack.close()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
