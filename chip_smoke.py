#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``veles_tpu_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. build — every kernel under ``veles_tpu_torch/csrc/`` with ``nvcc``
   (one compiler per source, all started together);
2. kernels — each kernel wrapper on the card at the shapes of its path,
   held against its plain PyTorch version on the same inputs, then
   timed beside the plain version and one library call: paged
   attention at the serving shapes and at the split kernel's edges
   (ATTEND_EDGES: live blocks 1, one per rank, fewer than the ranks, a
   table not a multiple of the cluster, T 64; K1 1/5/9/16; f32, bf16 and
   int8 pools; head dims 64/128/256; the padding row; rows whose
   queries all lie before their table) and at the column kernel's
   cases (ATTEND_COLUMN: head rows off the 16-byte chunks, pools passed
   as offset views), each case on the kernel
   ``ops.paged_attend.plan`` names and run twice bit-equal, a planted
   lost rank failing its check by 5x, and timed at T 16 and T 64 as
   replays of a CUDA graph of one decode step's 8 launches as well as
   by an eager loop, and of one verify pass's at K1 5 and 9; the int8
   GEMM at the serving shapes (also at 13 and 136 rows, at ragged
   shapes and in f32, run twice bit-equal, a planted lost split failing
   its check by 5x, and timed as replays of a CUDA graph of one decode
   step's 24 launches as well as by an eager loop, and of one verify
   pass's at m 40 and 72); the general tiled GEMM (``pallas_matmul``,
   every kernel variant: MM_CASES — f32 and bf16 operands, int8 ``b``
   with ``col_scale``, the fused ReLU and an unfused callable, bf16
   output, shapes off the vector loads, the serving widths, and the
   edges of the TMA + ``wgmma``, split-K and ``cp.async`` ring variants
   (tiles one past and short, one k-tile, 16-byte and misaligned offset
   views) — each case held to the variant its launch plan must name,
   run twice bit-equal, planted faults (a zeroed last k-tile, a lost
   split-K rank) failing by 5x; its entry point driven once per
   MM_TIMED shape with its count zeroed just before and read just
   after, each result held against the plain version; timed there as
   CUDA-graph replays of one launch and of 20 back-to-back launches
   beside the library call, and split-K against ``wgmma`` over m across
   their crossover, each output checked); the three
   FlashAttention kernels
   (forward, dq, dk/dv) at the training shapes (b 4, s 2048, 16 heads
   of 128, bf16, causal), at hd 256 full length, and at small odd ones
   (f32 and bf16, sq != sk, non-causal, lengths one past a tile,
   one-row queries and keys), element by element; at the training
   shapes four planted faults must fail the same check by 5x and a
   second backward must be bit-equal to the first; each kernel timed
   with its TFLOP/s;
3. reference — a small float32 chain served through the kernels on the
   card, its prefill, decode and verify (K1 5) logits held against the
   same chain on the CPU (plain versions), and its verify logits
   against sequential decode steps on the card; then the serving
   surface on the same weights, card against CPU: greedy ``generate``
   with and without the kv cache (tokens equal), ``embed_pool``
   (within 1e-5) and ``slot_decode_step`` (tokens equal);
3b. reference (moe) — phase 3's chain with MoE FFNs (4 experts, top-2,
   dense dispatch): prefill, decode and verify logits card against CPU
   and verify against sequential steps, each pass launching
   ``int8_gemm`` once per layer (``wo``: the expert FFN stays off the
   int8 path, as in the reference);
4. train reference — a small float32 chain (d 256, 2 heads of 128, 2
   layers) takes 3 SGD-momentum steps from the same weights and
   minibatches on the card through the attention kernels, on the card
   through the dense core, and on the CPU through the plain versions:
   the kernel run must match the dense card run closely (losses, and
   each parameter relative to its update) and the CPU run loosely;
4b. train reference (moe) — phase 4 with MoE FFNs (4 experts, top-2),
   the same three runs and limits;
5. learns — ``samples/lm.train_lm`` on the Markov corpus (d 256, 2
   heads of 128, 2 blocks, seq 128, vocab 64, Adam + cosine, bf16):
   the validation cross-entropy must fall below the corpus' unigram
   entropy;
6. serve — the LM chain at the serving model's width (d=1024, 8 heads,
   vocab 32768, window 1024, depth cut to 8 layers, random weights
   from seed 0, bfloat16) through ``InferenceScheduler`` with int8 KV
   pools and ``int8_decode``: one warm-up request, then 8 concurrent
   128-token prompts x 32 greedy steps, speculative decoding and the
   prefix cache off (so its numbers compare with the earlier runs').
   The kernels' launch
   counts are zeroed just before and read just after: ``paged_attend``
   must launch once per layer per decode step, all on its split
   kernel, ``int8_gemm`` three times, the general matmul never; its
   ``metrics()`` must count the run's requests, tokens, prefill chunks
   and slot steps as the phase counts them and ``debug_requests()`` be
   empty after it; one request under a given trace id must record its
   ``req.*`` events in order (queue, admit, prefill chunks, first
   token, steps, retire); then the same configuration with request
   tracing on and off, alternated three times each (the decode-step
   median of each and their ratio, no limit);
6b. spec — ``bench.py``'s ``bench_spec`` on the card: the serving model
   at 8 layers trained 60 SGD steps (batch 16, bf16) to continue a
   12-token pattern, then served with int8 KV and ``int8_decode``,
   spec_k 8, a 64-token repetitive prompt and 256 greedy steps, at 1
   and 4 slots with speculative decoding off and on (one warm-up and
   one measured run each): every model pass (decode or verify) must
   launch ``paged_attend`` once per layer, all split, and ``int8_gemm``
   three times; the spec-on arms must verify and accept drafts; their
   streams must equal the spec-off arms' token for token (the prefix
   cache off, so every measured request admits cold as before);
6c. lifecycle — ``bench_spec``'s prefix part (``bench.py:1118``) and
   the request lifecycle, the prefix cache on: (a) on the serve phase's
   chain, one cold and 8 warm submits of an 896-token prompt (7/8 of
   the window, ``prefill_chunk`` 32), one step each — every warm one
   must hit and prefill one 16-token block — then one cold and one
   warm admission profiled; (b) the peak of concurrent streams a
   20-block pool holds on a shared 64-token prompt (16 steps each),
   sampled from ``metrics()["active_slots"]``, cold (prefix cache off,
   4 requests) and warm (20 after a seeding one), with the kernels'
   counts zeroed just before and read after:
   warm must exceed cold, and each model pass launch ``paged_attend``
   once per layer, all split, and ``int8_gemm`` three times; (c) on the
   spec phase's trained chain, a warm resubmit, preempt→resume by a
   high-class arrival at one slot, cancel and a deadline mid-decode,
   drain, and the watchdog over an injected 1.5 s hang (whose stuck
   requests ``debug_requests()`` must list while the hang holds): each
   stream must equal its uninterrupted run, each error be its kind, and
   ``check_kv()`` clean after each;
6d. surface — the serving surface, on the spec phase's trained chain
   unless named: (a) ``submit(stream=True)`` at 1 and 4 slots, spec off
   and on, SURF_STEPS greedy tokens after the pattern prompt, each
   stream iterated on a thread of its own: its tokens must equal its
   ``result()`` and the batch reply, every pass launch ``paged_attend``
   8 times (all split) and ``int8_gemm`` 24; at one slot a low-class
   stream preempted by a high-class arrival resumes without a repeated
   token and a cancelled stream leaves the pool clean; first-token
   times and token gaps printed beside the batch path's; (b) on the
   serve phase's chain, AUX_ROWS embed and score rows of AUX_LEN
   tokens, direct and as aux jobs alone and beside AUX_STREAMS
   decoding streams: equal to the direct results within 1e-5, unit
   norms within 1e-5, no launch of kernels 1-3, each job's ms and the
   streams' gaps printed; (c) greedy ``generate`` at batch 1 and
   GEN_BATCH, rescan and kv: FlashAttention forward once per layer per
   rescan step and no kernel on the kv form, every row equal to the
   scheduler's stream; a var-length batch, a stop token, and
   ``generate_beam`` (beam 1 = greedy, beam 0's score = its
   teacher-forced re-score within 1e-3), tokens/s per form; (d)
   ``kv="dense"`` against paged fp32 pools at SLOTS x PROMPT x STEPS:
   equal streams, no kernel launch on the dense run, each decode step's
   ms and cache bytes;
6e. rest — ``veles_tpu_torch.restful_api.RESTfulAPI`` in front of the
   scheduler on the spec phase's trained chain at the reference's REST
   defaults (spec on at spec_k 4, the prefix cache on, ``prefill_chunk``
   64), 4 slots, int8 KV pools, block 16, on 127.0.0.1: (a)
   REST_CLIENTS concurrent ``/generate`` clients of the pattern prompt x
   SURF_STEPS greedy steps, each reply equal to the direct
   ``scheduler_.submit`` result, then REST_CLIENTS sequential round
   trips against direct submits, one-token requests against direct
   ones, and ``/healthz`` (p50); (b) ``/generate`` and
   ``/v1/completions`` streamed over SSE at one client, the frames equal
   to the batch reply, first frame and gaps against a direct
   ``TokenStream``'s; (c) ``/v1/embeddings`` and ``/v1/classify`` of
   AUX_ROWS rows of AUX_LEN tokens within 1e-5 of the direct calls; (d)
   beam BEAM over HTTP equal to ``generate_beam``, and a
   ``serving=False`` server equal to ``generate``; (e)
   ``/serving/metrics`` and ``/metrics`` counting the phase's requests
   and tokens, ``/healthz`` 200; (f) an SSE client reset mid-stream
   (the pool clean, one more cancel); (g) ``/drain`` (``/healthz`` and a
   new ``/generate`` 503) and ``stop()`` (connections refused).
   ``paged_attend`` 8 and ``int8_gemm`` 24 launches per model pass on
   (a), (b) and (f), all split; none of kernels 1-3 on (c) and (d);
6f. tiers — the model drafter and the KV tiers, each part's kernel
   counts zeroed just before it and read just after: (a)
   ``bench_spec``'s held-out arm: a chain trained as the spec phase's
   (ORBIT_TRAIN steps) on the single-cycle orbit
   ``default_rng(0).permutation(VOCAB)`` (each FlashAttention kernel
   once per layer per step), served from a
   float32 copy (int8 KV, ``int8_decode``), a ``MedusaDraftHead`` of
   SPEC_K heads trained DRAFT_TRAIN steps on it (the FlashAttention
   forward once per layer per teacher step), and ``orbit[:64]`` x
   DRAFT_STEPS greedy steps at 1 and 4 slots with spec off, n-gram and
   model drafts: decode tokens/s, accept rate by drafter, tokens per
   verify pass, the ladder's widths; every pass 8 / 24 launches, all
   split; each spec-on stream equal to spec off or parting from it
   only at a near-tie (``same_or_near_tie``); (b)
   ``weight_quant_quality`` on a float32 copy with ``int8_decode`` off
   (refused on an int8 checkpoint; no kernel in the gate), the weight
   bytes before and after, the quantized chain served spec off and on;
   (c) ``kv_quant_quality`` at block 16 and 32 (ceil(block / 16)
   ``paged_attend`` launches per layer per int8 pass: fault C6), each
   within 0.05 nats; ``paged_attend`` at K1 16, 17 and 32, T 64, held
   against its plain version and timed as CUDA-graph replays beside its
   bound and SDPA after a gather; (d) the host tier on the spec phase's
   chain: pattern probes cold, device-warm and host-warm after two long
   prompts demote them (``kv_host_bytes`` 64 MB, a HOST_POOL-block
   pool), TTFT p95 per tier, promotions and demotions, every resubmit
   equal to its cold stream; (e) a prefill-role and a decode-role
   scheduler beside a colocated one: handoffs over the b64 JSON and
   VKV1 wires and through two ``RESTfulAPI`` servers, each stream equal
   to the colocated one, first token against colocated, the wire's
   MB/s;
6g. moe serve — the serve phase's chain with MoE FFNs (4 experts,
   top-2, hidden 4096, bf16, seed 0, int8 KV and ``int8_decode``): one
   warm-up request, then 8 concurrent 128-token random prompts x 32
   greedy steps, spec and the prefix cache off, with the counts zeroed
   just before and read just after — ``paged_attend`` once per layer
   per pass (split kernel), ``int8_gemm`` once per layer per pass (only
   ``wo``), the general matmul never; ``metrics()`` counting the run,
   every block back, ``check_kv()`` clean; TTFT p50, decode tokens/s
   and the device's idle share printed beside phase 6's; then a
   float32 copy spec off and on over 8 rotations of the spec phase's
   pattern prompt, the streams equal or parted at a near-tie
   (``same_or_near_tie``);
7. train — the LM trainer at ``bench.py``'s ``bench_lm`` configuration
   (d 2048, 8 layers, 16 heads of 128, seq 2048, batch 4, vocab 32768,
   bf16, SGD lr 0.01 momentum 0.9; random weights from seed 0 and
   random tokens): 2 warm-up steps, then 5 timed steps with the
   attention kernels' counts zeroed just before and read just after —
   each must launch once per layer per step — then one step under
   ``torch.profiler``;
8. LRN and uniform kernels — ``lrn_fwd``/``lrn_bwd`` against their
   plain versions element by element (LRN_TOL) in bf16 at AlexNet's two
   LRN shapes at batch 1024, in f32 at odd ones (7, 96 and 256
   channels, n 3/4/5, beta 0.5/0.75), at the row kernels' edges (C 8,
   96 and 264 × n 3/4/5/17 in both types, a ragged last warp tile) and
   at two offset views, each case's ``ops.lrn.plan`` logged and held to
   the variant that launched (row kernels for aligned C % 8 == 0, tile
   kernels for C 7 and the views), with two planted faults (the
   forward's window shifted by one channel, the backward's transposed
   window not mirrored for an even n) failing the same rule and the
   backward bit-equal across two runs; the ptxas report of each LRN
   kernel;
   ``uniform_fill`` bit-equal to its plain version over 4,000,003
   floats, once at index 0 and once across 2**32 (the count's high
   word); each timed beside its plain version and a library call (the
   fill as CUDA-graph replays and eager loops);
9. AlexNet witness — a narrow AlexNet-shaped chain (side 67, widths
   8/16/24/24/16, FC 32, 10 classes, dropout 0.5, f32) trains one span
   of 3 SGD steps on the card through the kernels and on the CPU
   through the plain versions from the same weights: the synthetic
   datasets and all six dropout masks bit-equal, the losses and weights
   within WITNESS_LOSS / WITNESS_W;
10. AlexNet — ``samples/alexnet.py`` at ``bench_alexnet``'s
   configuration (batch 1024, 227², 1000 classes, 4096 synthetic
   samples drawn on the card by ``uniform_fill``, bf16, SGD lr 0.01
   momentum 0.9 weights decay 0.0005, dropout 0.5; random weights from
   seed 0): 2 warm-up steps, then 5 timed steps with the counts zeroed
   just before and read just after — ``lrn_fwd``, ``lrn_bwd`` and
   ``uniform_fill`` must each launch twice per step, the LRN kernels as
   their row variants — then one step under ``torch.profiler``;
10b. s2d and VGG-A — AlexNet at full width with the ``space_to_depth=4``
   stem over the flat pre-blocked dataset and with the plain stem, from
   the same seed (equal logical weights), batch 128: the stems' outputs
   within S2D_TOL and the first step's losses within S2D_LOSS_TOL, each
   build and step launching ``uniform_fill`` 3 times and each LRN
   kernel twice; then VGG-A at full width (side 227, 1000 classes,
   minibatch 64) for 3 SGD steps, finite losses, ``uniform_fill``
   drawing the dataset and 2 masks per step, no LRN, the step times
   printed;
11. families — card against CPU in float32 at small widths: RNN, LSTM
   with ``LastTimestep``, RNN with ``MeanPoolSeq``, a stride-2
   ``Deconv`` and a conv autoencoder (conv, max pooling, ``Depooling``,
   ``Deconv``) forward and gradients, the autoencoder's 3 SGD steps
   under ``EvaluatorMSE``, 3 Kohonen steps and 3 RBM CD-1 steps (hidden
   samples bit-equal: the uniform fill against the plain draw);
12. workflow — the workflow runtime (``StandardWorkflow``: repeater →
   loader → trainer → ``DecisionGD`` → snapshotter, run by
   ``Workflow.run()``): (a) ``AlexNetWorkflow`` at the sample's defaults
   (227², 1000 classes, strided stem, minibatch 256, 2048 train and 256
   validation samples, bf16, SGD lr 0.01 momentum 0.9 weights decay
   0.0005, dropout 0.5) for 2 epochs beside ``build_alexnet`` +
   ``train_alexnet`` run twice from the same seed and sizes: the
   workflow's per-epoch losses and final weights within WF_RULE times
   the two direct runs' own difference (bit-equal where they are),
   ``lrn_fwd``, ``lrn_bwd`` and ``uniform_fill`` launching exactly as
   often as on a direct run; an ungated ``SnapshotterToFile`` (codec
   none) writes at the end of epoch 1, and ``import_file`` →
   ``initialize(device="cuda")`` → ``run()`` ends with the weights of
   the uninterrupted run under the same rule; per-epoch seconds, the
   workflow's time against the direct loop's, the units' ``timers``,
   peak memory and the snapshot's MB and seconds printed; (b)
   ``LMWorkflow`` at ``bench_lm``'s width (random tokens, WF_LM_TRAIN
   train sequences, one epoch, snapshotter off; the smoke's time is the
   chains' builds, so its train set is cut to 16 sequences) against ``build_lm`` +
   ``train_lm`` twice under the same rule, 8 launches of each
   FlashAttention kernel per train step; (c) ``MnistWorkflow``,
   ``CifarWorkflow`` (mean_disp), ``TransformerWorkflow`` at dim 512, 4
   heads (head dim 128: the FlashAttention kernels in f32) and
   ``KohonenWorkflow`` at small sizes for 2 epochs in float32 (CIFAR and
   the transformer with SGD in place of Adam, the transformer at lr
   1e-4), on the card against the
   CPU: epoch metrics and weights within WF_SMALL_TOL;
13. input — the input pipeline: (a) a tree of IN_TRAIN + IN_VALID
   uint8 ``.npy`` images at 227² in IN_CLASSES class directories,
   drawn from a seed, trained on by AlexNet at its full widths
   (IN_CLASSES outputs, bf16) through ``StandardWorkflow`` over
   ``FileImageLoader`` per minibatch at IN_BATCH for IN_EPOCHS epochs
   with IN_AUGMENT in the step, once at prefetch IN_DEPTH and once at
   0: the two arms bit-equal (losses, every parameter, the decision's
   gate Bools wave by wave), each launching ``lrn_fwd`` twice per wave,
   ``lrn_bwd`` twice per train step and ``uniform_fill`` three times
   per train step (two dropout masks and the flip); the mean input wait
   per wave by mode, the host decode per minibatch, the wall per train
   step, the prefetch occupancy at each pop and the peak memory
   printed; a small copy (two classes at 32², two convolutions, LRN,
   dropout) card against CPU within IN_SMALL_TOL; (b) a BPE vocabulary
   of IN_VOCAB ids trained on the first IN_CORPUS_CHARS characters of
   the port's own Python sources (IN_CORPUS, by sorted path) in a
   child process during phase 12, its encode/decode round trip exact,
   and ``LMWorkflow(text_path=...)`` at ``bench_lm``'s trunk widths for
   IN_LM_STEPS train steps (the window stride chosen for that many
   minibatches), 8 launches of each FlashAttention kernel per train
   step and of the forward per validation step; the same text at d 64,
   2 blocks card against CPU; (c) card against CPU: ``MnistWorkflow``
   on ``"glyphs"`` with a flat augment, ``CifarWorkflow`` on
   ``"scenes"`` with pad 4 (one flip draw per train step each), a
   ``SoundLoader`` MLP on a ``tones.generate`` tree, a ``PicklesLoader``
   MLP on pickles a ``Downloader`` unpacked from a local ``.tar.gz``
   (the archive kept), a ``MinibatchesSaver`` stream written from a
   prefetching loader and read back, and an ``InputJoiner``.
16. distributed — across processes (``distributed_check``): (a) fault
   C9: the serve phase's chain served by a scheduler built from
   ``root.common.serving`` alone (int8 KV, spec on, spec_k 4, block 16)
   and by one given those knobs, equal streams and launches of kernels
   1 and 2; (b) AlexNet at the config's width through the command
   line's master (in the background job's process) with ``-w 2``
   spawned workers
   sharing the card: every sample counted once by the master, kernels 4
   and 5 launched in each worker (its ``veles-worker-report`` line),
   the job frames' bytes and times; a ``-w 1`` run against the
   standalone run of the same weights and minibatches; (c) a gang of
   two processes of this script (``python3 chip_smoke.py --gang-worker
   ADDR N RANK``, gloo over the shared card, each on the card or
   failing), each one position of ``{"dp": 2}``, training
   ``bench_lm``'s widths cut to 4 layers, the pickled trainer resuming
   over the gang; then phase 15's ``{"pp": 2, "dp": 2}`` (2 positions a
   process, the stages in different processes) and ``{"sp": 2}`` (the
   ring's halves in different processes) over the same LM and its
   ``{"ep": 2, "dp": 2}`` over the MoE trunk (the expert slices in
   different processes), 2 steps each: every mesh's losses bit-equal
   across the processes and within phase 15's agreement of the
   unsharded run (process 0 trains it), kernel 3 launched in each
   process exactly for its own layers (``gang_flash_want``), and per
   process the step's ms, ``multihost.STATS`` per step (exchanges,
   point-to-point sends and receives, bytes, seconds) and peak memory,
   beside the card's name and power limit.
17. fleet — the serving fleet and its observability (``fleet_check``,
   run after phase 6f while the spec phase's trained chain lives):
   (a) a ``Router`` over a ``Fleet`` of ``LocalReplica``s (each a
   ``RESTfulAPI`` at the REST defaults, int8 KV, 4 slots, over its own
   copy of one numpy draw of the serve phase's chain) under
   ``bench_router``'s load at 1 and 2 replicas: no failed request,
   every reply FLEET_STEPS new tokens, kernels 1 and 2 at 8 and 24
   launches per model pass over the load and in each replica alone;
   aggregate tokens/s and the TTFT p95 of one-step probes, the 2-replica
   figures marked as one card and one interpreter shared; (b) 2 replicas
   of the trained chain: routed greedy replies equal to the direct
   scheduler's, a stream killed by ``router.stream.replica_death``
   spliced from the peer equal to the uninterrupted one (the
   kill-to-next-frame gap printed), a rolling restart under 8 clients
   with no failed request, kill/respawn cycles, every pool clean, and
   ``memory_allocated`` back to its value before the fleet within 1 %;
   (c) ``replica_unreachable`` firing after its hold-down with the
   respawn pinned failing (``fleet.replica.spawn``) and resolving,
   ``/metrics/fleet`` equal to the hand-summed replica scrapes,
   ``/metrics/history`` on the router and a replica, ``/dashboard``, a
   flight-recorder bundle's ``alerts`` and ``history``, the alert tick
   over the live registry, and one replica's decode rate with its store
   and engine on and off (3 runs each, printed, not gated); (d) an armed
   ``FleetController`` (1 to 2 replicas) growing under a burst and
   draining back when quiet with no failed request, a flooding tenant's
   429s with ``Retry-After`` while another tenant is served, and
   ``/tenants/usage`` equal to the clients' counts.
18. cli modes — the command line's fleet modes (``cli_modes_check``):
   (a) AlexNet at the config's width through the command line with
   ``--export-package``: the archive's manifest the reference's keys and
   class ids with no program, ``load_package(...).run`` on 8 validation
   samples equal to the workflow's forward on the same padded batch
   (CM_PKG_TOL) with 2 ``lrn_fwd`` launches a run; a transformer package
   (d 512, 4 heads of 128, 2 blocks) launching ``flash_attn_fwd`` once
   per block and equal to its workflow's forward; ``runtime/`` built from
   a temporary copy and its runner on an MNIST and a mini-AlexNet
   package of the port within ``tests/test_package_export.py``'s
   tolerances of "python" mode; (b) ``--ensemble-train 2 --train-ratio
   0.75`` of the AlexNet cut, members on the card one after another
   (seeds 4242, 4243, distinct snapshots and validation results, kernels
   4 and 5 in each member's profiler trace), then ``--ensemble-test``
   (each tester launching kernel 4); (c) ``--optimize`` on the TINY
   MNIST with a ``Range`` learning rate, individuals on the card,
   generation 0's genes equal to the port's ``Population`` drawn in
   process; (d) the AlexNet cut with ``-g`` and ``--web-status`` to an
   in-process ``WebStatusServer`` with a graphics subscriber: the status
   posts with the graph and the events, ``/``, ``/graph/<id>``,
   ``/alerts`` and ``/dashboard`` answering, the error curve equal to
   the decision's history, every payload received, and the run's
   weights and launches bit-equal to the run without them; (e) a form
   POSTed to ``--frontend`` composing an MNIST run whose results file
   equals the direct command line's.  (c) runs ``--optimize 2:2``
   (CM_POP, CM_GENS), cut from 4:2 for the run's time; (b) and (c) run
   in the background job and are checked here.
19. services — the last services (``services_check``): (a) a PUSH
   producer thread streams 64 samples at AlexNet's width into a
   ``ZeroMQLoader``; AlexNet's bf16 forward on the minibatch it serves
   equals the forward on the stacked samples (SV_Z_TOL), with 2
   ``lrn_fwd`` launches and nothing else; (b) ``AlexNetWorkflow`` at the
   sample's width trains 2 steps, an ``AvatarServer`` exposes its 16
   parameter arrays and an ``Avatar`` pulls them onto the card bit-equal,
   a second epoch moves them and a second pull equals the new weights
   (seconds and MB per pull printed); (c) a loopback WebHDFS serves 640
   MNIST-width text records to ``HDFSTextLoader`` in front of the MNIST
   MLP, whose epoch is bit-equal to the same records through a
   ``FullBatchLoader``; (d) the mini-AlexNet package through
   ``update_forge`` to a loopback ``ForgeServer`` and a checksum-verified
   fetch, its run bit-equal to the run before the upload with 2
   ``lrn_fwd``; (b)'s run published in all five backends (Confluence to
   a loopback fake; a line says when the HTML report's images were
   skipped); ``compare_snapshots`` exiting 1 on (b)'s two snapshots and
   0 on one against itself; (e) ``compile_summary()`` listing the six
   libraries once each, their calls equal to the kernels' launch
   counts, and ``/metrics`` of a live dashboard showing them.

Background work: once every kernel has been timed (after phase 11),
child processes start beside phases 12-15 of this process — phase
13 (b)'s vocabulary training, phase 16 (c)'s gang, and one job
(``python3 chip_smoke.py --job ...``) that runs phase 16 (b) (its
standalone run and checks included), then phase 18 (b)'s ensemble runs
and (c)'s optimizer run, one after another; phases 16 and 18 wait for
what they read and print the job's records then.  Each process counts
its own launches, so the counts each phase of this process zeroes and
reads stay its own.

Output, last lines: a ``{"kernels": [...]}`` JSON line, the card's
name and power limit from ``nvidia-smi``, and the
``{"ok": true, "device": {...}}`` line.  In the kernels line, the two
serving kernels' (``paged_attend``, ``int8_gemm``) ``ms`` and
``library_ms`` are device times of CUDA-graph replays of a decode
step's launches (their launches are shorter than the host's dispatch of
one), with the host-paced eager loops under ``eager_ms`` and
``library_eager_ms``, the verify widths' graph times under ``verify``
and the spec, lifecycle, surface and REST phases' launches under
``spec_launches``, ``lifecycle_launches``, ``surface_launches``,
``rest_launches`` and ``tiers_launches`` (phase 6f's, with the
FlashAttention kernels' there too), phase 6g's under ``moe_launches``,
and ``paged_attend``'s graph times at K1 16, 17 and 32 under ``wide``;
the FlashAttention kernels' phase 4b launches under
``moe_train_launches``, the LRN and uniform kernels' phase 10b launches
under ``s2d_vgg_launches``, the uniform fill's phase 11 launches
under ``families_launches``, the launches of phase 12's workflow runs
(AlexNet's, the LM's and the transformer's) under
``workflow_launches``, phase 13's card runs under ``input_launches``,
phase 16's (its workers' and gang processes' included) under
``distributed_launches``, phase 17's (a) and (b) under
``fleet_launches``, phase 18's (this process's and the kernel events
of the ensemble's members and testers) under ``cli_modes_launches``,
and phase 19's under ``services_launches``
(``flash_attn_fwd``'s ``surface_launches`` are the rescan ``generate``
runs');
``uniform_fill``'s ``ms`` and ``library_ms`` are graph replays too,
and so are ``matmul``'s (one launch per replay, at bf16 4096^3, the
other timed shapes under ``shapes``; graphs of 20 back-to-back launches
divided by 20 under ``ms_20`` and ``library_ms_20``, since a graph of
one launch of a few microseconds times the host's replay rate; the
split-K / ``wgmma`` crossover under ``crossover``; its ``launches`` are
its entry point's at the timed shapes, as no other path calls it);
every other kernel's ``ms`` and ``library_ms``, and every ``plain_ms``,
are eager loops timed by CUDA events.
"""

import contextlib
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy

#: the serving model of the smoke (``bench.py``'s serving width)
VOCAB, DIM, LAYERS, HEADS, WINDOW, BLOCK, SLOTS = 32768, 1024, 8, 8, 1024, 16, 8
PROMPT, STEPS, CHUNK = 128, 32, 64
#: kernel-vs-plain tolerances: both sides sum in f32, in another order
TOL = {"bfloat16": 2e-3, "float32": 1e-5}
#: int8 GEMM checks: the serving model's (k, n) of wo, ffn_w1 and ffn_w2;
#: ragged ones (n off the 64-column tiles and the 8-byte loads, k off the
#: 16-row steps); the rows m (decode buckets, one 8-row tile past 8, a
#: verify step's B x (spec_k + 1)); and how far a planted lost split
#: must fail TOL
GEMM_SHAPES = ((DIM, DIM), (DIM, 4 * DIM), (4 * DIM, DIM))
GEMM_RAGGED = ((100, 70), (100, 1001), (1000, 70), (1000, 1001))
GEMM_ROWS = (1, 2, 4, 8, 13, 136)
GEMM_FAULT_MIN = 5.0

#: the general tiled GEMM (``pallas_matmul`` without ``col_scale`` as
#: well as with it), each case with the variant its plan must name
#: (``ops.gemm.matmul_plan``): (m, k, n, a type, b — "same" (a's type),
#: "int8" (with col_scale) or "scaled" (a's type with col_scale) —,
#: epilogue, out type, offset of both operands into their buffers in
#: elements, variant, planted fault — None, "k_tile" (b's last k-tile
#: zeroed) or "rank" (the last split-K rank's k rows of b zeroed)).  Every
#: case passes ``block_*`` equal to its dims, so it tiles.  The CPU tests'
#: shapes (the JAX tests' 128 x 256 x 128, 128^3 with ReLU, 8 x 64 x
#: 128), shapes that tile only by min(block, dim) (m 100, k 50) and off
#: the 8-element loads, int8 b, a bf16 output, a callable the kernel does
#: not fuse, the serving widths (m 1/8/9/16/40/72/136 x 1024 x 4096,
#: bf16) and the large tiles; then each new variant's edges: wgmma at m
#: one past and one short of its 128-row tile, n and k 8 past and 8 short
#: of its tiles (64-column boxes, 64-deep k-tiles) at each of its three
#: tile widths, one k-tile; split_k at k one half step past and short of
#: 1024, n 8 past and short of its 64 columns, one k16 step, n under 64
#: at m 100 (its 32-row tiles); simt_pipe past and short of its 128- and
#: 32-row tiles and its 16-deep stages, one stage; for each a bf16 output
#: with ReLU and col_scale, a 16-byte offset view (the new variant) and a
#: 2- or 4-byte one (the register-staged kernels); and the two timed
#: squares, bf16 4096^3 (wgmma's persistent CTAs, each walking 3-4
#: tiles with the ring running on) and f32 2048^3; each run twice
#: bit-equal
MM_CASES = [
    (128, 256, 128, "float32", "same", None, "float32", 0, "simt_pipe", None),
    (128, 128, 128, "float32", "same", "relu", "float32", 0, "simt_pipe",
     None),
    (8, 64, 128, "float32", "same", None, "float32", 0, "simt_pipe", None),
    (100, 50, 64, "float32", "same", None, "float32", 0, "simt_pipe", None),
    (100, 50, 72, "bfloat16", "int8", "relu", "float32", 0, "tc_small",
     None),
    (64, 128, 96, "bfloat16", "same", None, "bfloat16", 0, "wgmma", None),
    (24, 40, 32, "float32", "same", "tanh", "float32", 0, "simt_pipe", None),
    (24, 40, 32, "bfloat16", "same", "tanh", "bfloat16", 0, "split_k", None),
    (8, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 0, "split_k",
     "rank"),
    (40, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 0, "wgmma",
     None),
    (72, DIM, 4 * DIM, "bfloat16", "same", "relu", "float32", 0, "wgmma",
     "k_tile"),
    (72, DIM, 4 * DIM, "bfloat16", "int8", None, "bfloat16", 0, "tc_small",
     None),
    (512, 384, 512, "bfloat16", "same", "relu", "float32", 0, "wgmma", None),
    (256, 258, 256, "float32", "int8", None, "bfloat16", 0, "simt_big", None),
    (256, 500, 512, "bfloat16", "same", "tanh", "bfloat16", 0, "tc_big",
     None),
    (1024, 1024, 1024, "float32", "same", None, "float32", 0, "simt_pipe",
     "k_tile"),
    # wgmma: m past / short of 128, n and k past / short of their tiles,
    # at the 64-, 128- and 256-column tiles; one k-tile
    (129, 136, 264, "bfloat16", "same", None, "float32", 0, "wgmma", None),
    (127, 120, 248, "bfloat16", "same", None, "float32", 0, "wgmma", None),
    (1023, 1016, 2040, "bfloat16", "same", None, "float32", 0, "wgmma",
     "k_tile"),
    (1537, 520, 2824, "bfloat16", "same", None, "float32", 0, "wgmma", None),
    (256, 64, 512, "bfloat16", "same", None, "float32", 0, "wgmma", None),
    (384, 256, 512, "bfloat16", "scaled", "relu", "bfloat16", 0, "wgmma",
     None),
    (384, 256, 512, "bfloat16", "same", None, "float32", 8, "wgmma", None),
    (384, 256, 512, "bfloat16", "same", None, "float32", 1, "tc_big", None),
    # split_k: the serving rows, k a half step past / short of 1024, n 8
    # past / short of its 64 columns, one k16 step, n under 64
    (1, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 0, "split_k",
     None),
    (9, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 0, "split_k",
     None),
    (16, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 0, "split_k",
     "k_tile"),
    (136, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 0, "wgmma",
     None),
    (8, DIM + 8, 4 * DIM + 8, "bfloat16", "same", None, "float32", 0,
     "split_k", None),
    (9, DIM - 8, 4 * DIM - 8, "bfloat16", "same", None, "float32", 0,
     "split_k", "rank"),
    (8, 16, 4 * DIM, "bfloat16", "same", None, "float32", 0, "split_k",
     None),
    (100, 72, 56, "bfloat16", "same", None, "float32", 0, "split_k", None),
    (8, DIM, 4 * DIM, "bfloat16", "scaled", "relu", "bfloat16", 0,
     "split_k", None),
    (8, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 8, "split_k",
     None),
    (8, DIM, 4 * DIM, "bfloat16", "same", None, "float32", 1, "tc_small",
     None),
    # simt_pipe: past / short of its 128- and 32-row tiles and 16-deep
    # stages, one stage
    (257, 264, 264, "float32", "same", None, "float32", 0, "simt_pipe",
     None),
    (255, 248, 248, "float32", "same", None, "float32", 0, "simt_pipe",
     None),
    (64, 16, 128, "float32", "same", None, "float32", 0, "simt_pipe", None),
    (8, DIM, 4 * DIM, "float32", "same", None, "float32", 0, "simt_pipe",
     "k_tile"),
    (256, 128, 256, "float32", "scaled", "relu", "bfloat16", 0, "simt_pipe",
     None),
    (256, 128, 256, "float32", "same", None, "float32", 4, "simt_pipe",
     None),
    (256, 128, 256, "float32", "same", None, "float32", 1, "simt_big",
     None),
    # the timed squares
    (4096, 4096, 4096, "bfloat16", "same", None, "float32", 0, "wgmma",
     "k_tile"),
    (2048, 2048, 2048, "float32", "same", None, "float32", 0, "simt_pipe",
     None)]
#: the timed shapes: (label, m, k, n, type) — the operations-bound
#: squares, the serving width, which the weight bytes bound, and the
#: verify widths on each side of the split_k / wgmma crossover
MM_TIMED = (("bf16 4096^3", 4096, 4096, 4096, "bfloat16"),
            ("f32 2048^3", 2048, 2048, 2048, "float32"),
            ("bf16 8x1024x4096", 8, DIM, 4 * DIM, "bfloat16"),
            ("bf16 72x1024x4096", 72, DIM, 4 * DIM, "bfloat16"),
            ("bf16 136x1024x4096", 136, DIM, 4 * DIM, "bfloat16"))
#: the rows at which split_k and wgmma (``gemm.matmul_variant``) are
#: timed against each other at 1024 x 4096 (bf16): their crossover
MM_CROSSOVER_M = (8, 16, 24, 40, 72, 136)
#: how far the kernel run on a planted fault must fail
MM_FAULT_MIN = 5.0
#: launches per CUDA graph in the matmul's ``ms_20`` timings (its ``ms``
#: replays a graph of one launch, which for a launch of a few
#: microseconds measures the host's replay rate)
MM_GRAPH_CALLS = 20

#: the spec phase (``bench.py``'s ``bench_spec`` on a chip: the serving
#: model above at full depth, trained to continue the 12-token pattern
#: ``arange(12) * 17 % vocab``): training steps at batch SPEC_BATCH over
#: 8 minibatches of window-long sequences, then SPEC_STEPS greedy tokens
#: per request after a SPEC_PROMPT-token prompt, drafts of up to SPEC_K,
#: at 1 and 4 slots (SPEC_STEPS: ``bench_spec``'s 512 cut to 256 for the
#: smoke's time limit)
SPEC_TRAIN, SPEC_BATCH, SPEC_STEPS, SPEC_K, SPEC_PROMPT = 60, 16, 256, 8, 64
#: the spec phase's trainer: ``bench_spec``'s SGD with momentum 0.9, but
#: at lr 0.001, not 0.05 — at this width 0.05 diverges within 8 steps in
#: the port's trainer (as the JAX trainer does on the same data at d 64
#: and batch 4), and 0.005 still does
SPEC_TRAINER = {"solver": "sgd", "learning_rate": 0.001,
                "gradient_moment": 0.9}
SPEC_SLOTS = (1, 4)

#: the lifecycle phase (``bench.py``'s ``bench_spec`` prefix part, :1118):
#: a prompt of 7/8 of the window, cold then warm, block-wide cold-tail
#: chunks (``prefill_chunk`` = 2 blocks, as the bench), 4 slots, 8 warm
#: resubmits; then the streams a pool of 4 cold requests' blocks holds
#: on a shared 4-block prompt with a block of steps each
LIFE_PROMPT, LIFE_CHUNK, LIFE_SLOTS, LIFE_WARM = 7 * WINDOW // 8, 2 * BLOCK, 4, 8
SHARED_PROMPT, SHARED_STEPS = 4 * BLOCK, BLOCK
SHARED_POOL = 4 * -(-(SHARED_PROMPT + SHARED_STEPS) // BLOCK)
#: the lifecycle checks' watchdog and the hang it must catch (seconds)
LIFE_WATCHDOG, LIFE_HANG = 0.5, 1.5

#: the surface phase: streamed requests of SURF_STEPS greedy tokens after
#: the spec phase's SPEC_PROMPT-token pattern prompt (at SPEC_SLOTS, spec
#: off and on); AUX_ROWS embed and AUX_ROWS score rows of AUX_LEN tokens
#: while AUX_STREAMS streams decode; ``generate`` of GEN_STEPS tokens at
#: batch 1 and GEN_BATCH, a var-length batch of GEN_LENS, beam search of
#: width BEAM; the dense layout at the serve phase's SLOTS x PROMPT x STEPS
SURF_STEPS, AUX_ROWS, AUX_LEN, AUX_STREAMS = 128, 8, 128, 4
GEN_STEPS, GEN_BATCH, BEAM = 64, 8, 4
GEN_LENS = (64, 48, 33, 17, 64, 5, 40, 64)
#: the REST phase: concurrent /generate clients of the pattern prompt, then
#: as many sequential round trips; beam search and the serialized decode
#: over REST_BEAM_STEPS steps
REST_CLIENTS, REST_BEAM_STEPS = 8, 32
#: the steps of the REST phase's stream reset mid-stream: long enough
#: that it is still decoding when the reset lands
REST_RESET_STEPS = 512
#: the drafter and KV-tier phase: the orbit chain's training steps (the
#: spec phase's 60 cut to 20: at 60 it learns nothing of the orbit
#: either), the draft head's training steps (300 cut to 150, then to 50)
#: and the held-out arms' greedy steps (``bench_spec``'s 512 cut to 256,
#: then to 128, then to 64: the smoke's whole run must stay inside its
#: time limit); the
#: quality gates' sequence length; the quantized chain's served steps;
#: the host tier's probes (HOST_PROBES pattern prompts of HOST_PROMPT
#: tokens, HOST_STEPS steps, demoted by two HOST_LONG-token prompts in a
#: pool of HOST_POOL blocks); the handoff's prompt, steps and repeats
ORBIT_TRAIN = 20
DRAFT_TRAIN, DRAFT_STEPS, QUALITY_LEN, W8_STEPS = 50, 64, 256, 64
#: how far below its row's largest logit (nats) a token of a spec-on
#: stream that parted from spec off at a near-tie may lie on the decode
#: path: int8 KV rows quantized by a verify pass and by a decode step
#: differ by a step here and there; a wrongly accepted draft lies whole
#: nats below
NEAR_TIE = 0.05
HOST_PROBES, HOST_PROMPT, HOST_STEPS, HOST_LONG, HOST_POOL = 6, 128, 4, 512, 64
DISAGG_PROMPT, DISAGG_STEPS, DISAGG_REPS = 256, 16, 8
#: the MoE phases (3b, 4b, 6g): the ``MoE`` unit's defaults, 4 experts
#: and top-2 routing with dense dispatch; phase 6g's chain is the serve
#: phase's with MoE FFNs (hidden 4 * DIM)
MOE_EXPERTS, MOE_TOP_K = 4, 2

#: the training model of the smoke (``bench.py``'s ``bench_lm``)
T_VOCAB, T_DIM, T_LAYERS, T_HEADS, T_SEQ, T_BATCH = 32768, 2048, 8, 16, 2048, 4
T_WARM, T_STEPS = 2, 5
#: FlashAttention kernel-vs-plain tolerance (tol, floor) by the
#: compared tensor's type, held element by element: |got - want| <=
#: tol * (|want| + rms(want)) + floor.  bf16 2e-2 is five half-steps of
#: bf16 (both sides round their f32 result once; the kernel rounds P
#: and ds at each tile's running max, the plain version once per row);
#: f32 (the LSE always) 1e-4 (sums in another order).  The floor covers
#: gradients that are rounding noise of both sides (a row of one key
#: has ds = P·(dP - delta) = 0 but for the order of dP's and delta's
#: sums)
FLASH_TOL = {"bfloat16": (2e-2, 1e-4), "float32": (1e-4, 1e-5)}
#: the kernel-path training run against the dense-core one on the card:
#: losses (relative) and each parameter's distance (relative to its
#: update over the run)
TRAIN_REF_LOSS, TRAIN_REF_STEP = 1e-6, 1e-4
#: a planted fault must exceed its limit this many times over
FLASH_FAULT_MIN = 5.0
#: phase 18 (a)'s transformer package: the transformer sample at d 512,
#: 4 heads of 128, 2 blocks
CM_T_DIM, CM_T_HEADS, CM_T_BLOCKS, CM_T_SEQ, CM_T_BATCH = 512, 4, 2, 64, 64
#: (b, sq, sk, h, d, dtype, causal): the training shapes; small odd f32
#: ones (the SIMT kernels); bf16 off the tensor-core tiles (64-row CTA
#: tiles, key tiles of 64 at hd 128 and 32/16 at hd 256, dk/dv query
#: tiles of 32 and 16): sq != sk both ways, non-causal, lengths one past
#: a tile, one-row queries and keys; hd 256 at full length
FLASH_CASES = [(T_BATCH, T_SEQ, T_SEQ, T_HEADS, T_DIM // T_HEADS,
                "bfloat16", True),
               (2, 100, 77, 3, 128, "float32", False),
               (1, 130, 200, 2, 128, "float32", True),
               (1, 77, 50, 2, 128, "float32", True),
               (2, 100, 77, 3, 128, "bfloat16", False),
               (1, 130, 200, 2, 128, "bfloat16", True),
               (1, 65, 33, 2, 128, "bfloat16", True),
               (1, 33, 65, 2, 128, "bfloat16", False),
               (3, 1, 1, 2, 128, "bfloat16", True),
               (1, 1, 129, 2, 128, "bfloat16", False),
               (1, 129, 1, 2, 128, "bfloat16", True),
               (2, T_SEQ, T_SEQ, 8, 256, "bfloat16", True),
               (1, 17, 90, 2, 256, "bfloat16", False),
               (1, 70, 33, 2, 256, "bfloat16", True),
               # phase 18 (a)'s transformer package: bf16, non-causal
               (CM_T_BATCH, CM_T_SEQ, CM_T_SEQ, CM_T_HEADS,
                CM_T_DIM // CM_T_HEADS, "bfloat16", False)]

#: AlexNet at ``bench.py``'s ``bench_alexnet`` configuration
A_BATCH, A_SIDE, A_CLASSES, A_TRAIN, A_FC = 1024, 227, 1000, 4096, 4096
#: AlexNet's two LRN layers at batch 1024 (NHWC)
LRN_SHAPES = ((A_BATCH, 55, 55, 96), (A_BATCH, 27, 27, 256))
#: LRN kernel-vs-plain limits (tol, floor), held element by element as
#: FLASH_TOL is: bf16 one step (both sides round their f32 result once;
#: a value within rounding of a step boundary may land one step apart),
#: f32 1e-5 (the card's rsqrt and pow against the plain version's, a few
#: ulps)
LRN_TOL = {"bfloat16": (2.0 ** -7, 1e-7), "float32": (1e-5, 1e-7)}
#: LRN check inputs: scale 50 with alpha 1e-4 makes the window sum as
#: large as k, so a kernel that sums the wrong window fails the check
#: (at unit scale k dominates and a window fault moves y by ~1e-5)
LRN_SCALE = 50.0
#: channel counts at the row kernels' edges: one 8-channel chunk per row,
#: AlexNet's first layer, and 33 chunks per row (a row longer than a
#: warp's 32)
LRN_EDGE_C = (8, 96, 264)
#: 32-bit integer operations per uniform element: the index split (2),
#: the initial key add (2), 20 rounds of add, rotate and xor (60), 5 key
#: injections (10), the final xor, shift, or and float subtract (4)
THREEFRY_OPS = 78
#: the narrow AlexNet-shaped witness chain (card against CPU)
W_SIDE, W_WIDTHS, W_CLASSES, W_TRAIN, W_BATCH = 67, (8, 16, 24, 24, 16,
                                                     32), 10, 12, 4
#: card-vs-CPU limits of the witness after its 3 steps: loss sum
#: (relative) and weights (absolute).  Measured on an H100: 8.2e-8 and
#: 3.0e-8 (f32 sums in another order; softplus has no kink to flip)
WITNESS_LOSS, WITNESS_W = 1e-6, 1e-6
#: phase 10b: AlexNet's space-to-depth stem against the plain stem at
#: batch S2D_BATCH (cut from ``bench_alexnet``'s 1024 for the phase's
#: time), and VGG-A at full width (side 227, 1000 classes) at minibatch
#: V_BATCH (cut from the reference's 256 for the phase's time) for
#: V_STEPS SGD steps.  The blocked stem sums its taps in another order
#: than the strided one (both in f32, rounded once to bf16), so an
#: output near a rounding edge lands a bf16 step apart: its stem output
#: is held to S2D_TOL of the largest magnitude and its first step's
#: loss to S2D_LOSS_TOL relative
S2D_BATCH, V_BATCH, V_STEPS = 128, 64, 3
S2D_TOL, S2D_LOSS_TOL = 1e-2, 1e-2
#: phase 11: the layer families card against CPU in float32 (f32 sums in
#: another order): outputs, gradients and parameters, relative and
#: absolute
FAMILY_TOL = 1e-4
#: phase 12: AlexNetWorkflow at the sample's defaults (227², 1000
#: classes, minibatch 256, 2048 train + 256 validation, bf16, 2 epochs);
#: LMWorkflow at bench_lm's width over WF_LM_TRAIN random sequences for
#: one epoch (16, not 32: the phase's time is the three chains' builds,
#: and a step is 0.55 s); a workflow's number may differ from the direct run's by at
#: most WF_RULE times the two direct runs' own difference (bit-equal
#: where they are); the small samples card against CPU within WF_SMALL_TOL
WF_BATCH, WF_TRAIN, WF_VALID, WF_EPOCHS = 256, 2048, 256, 2
WF_SIDE, WF_CLASSES = 227, 1000
WF_WIDTHS = (96, 256, 384, 384, 256, 4096)
WF_LM_TRAIN = 16
WF_RULE = 2.0
WF_SMALL_TOL = 1e-3

#: device-memory rate (bytes/s) by card name (NVIDIA data sheets)
HBM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
            ("H100", 3.35e12))
#: dense peak (operations/s) of the inputs' type (NVIDIA's H100 SXM
#: data sheet): bf16 tensor cores, f32 outside them; int32 from the same
#: f32 figure (67e12 = 128 lanes x 2 flops of a fused multiply-add per
#: SM and clock) as the issue limit: an SM issues at most 4 warp
#: instructions (128 lanes) per clock, whichever pipe runs them, so
#: 32-bit integer operations cannot exceed half the f32 flop rate
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int32": 67e12 / 2}


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_rate(name):
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    raise SystemExit("no memory rate known for card %r" % name)


def time_ms(torch, fn, reps=20):
    """Mean milliseconds of ``fn()`` on the card (CUDA events around
    ``reps`` calls after 3 warm-up calls)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, dtype, rate):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak of ``dtype``."""
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels ---------------------------------------------------------

def _offset_view(torch, x, offset):
    """``x`` copied into a view ``offset`` elements into a flat buffer:
    contiguous, off the 16-byte boundary a fresh tensor starts on."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    return view


def _attend_inputs(torch, rng, dev, b, t, k1, pool, nb, lo, hi, heads=HEADS,
                   first=None, d=DIM, offset=0):
    """Pools of ``nb`` blocks of width ``d`` (views ``offset`` elements
    into a buffer when it is given), a [b, t] table whose last row is
    occupancy padding (all trash block 0, position 0) and whose other
    rows, at first positions drawn from [lo, hi] (or given as ``first``,
    the padding row's last), own distinct blocks up to their deepest
    query (every block of the table for a row before it, at negative
    positions), trash past it."""
    from veles_tpu_torch.ops.paged_attention import quantize_kv_rows
    qdt = torch.float32 if pool == "float32" else torch.bfloat16
    q = torch.as_tensor(rng.standard_normal((b, k1, d)),
                        dtype=torch.float32).to(dev, qdt)
    tables = numpy.zeros((b, t), numpy.int32)
    qpos = numpy.zeros((b, k1), numpy.int32)
    free = list(rng.permutation(numpy.arange(1, nb)))
    for r in range(b - 1 if b > 1 else b):
        p = int(rng.integers(lo, hi + 1)) if first is None else first[r]
        live = t if p < 0 else (p + k1 - 1) // BLOCK + 1
        tables[r, :live] = [free.pop() for _ in range(live)]
        qpos[r] = p + numpy.arange(k1)
    kv = [torch.as_tensor(rng.standard_normal((nb, BLOCK, d)),
                          dtype=torch.float32).to(dev) for _ in range(2)]
    extra = {}
    if pool == "int8":
        (pk, sk), (pv, sv) = (quantize_kv_rows(x) for x in kv)
        kv = [pk, pv]
        extra = dict(scale_k=sk, scale_v=sv)
    else:
        kv = [x.to(getattr(torch, pool)) for x in kv]
    if offset:
        kv = [_offset_view(torch, x, offset) for x in kv]
    args = (q, kv[0], kv[1], torch.as_tensor(tables).to(dev),
            torch.as_tensor(qpos).to(dev), heads)
    return args, extra


def _attend_bytes_ops(args, extra):
    """Bytes the paged attention must move and operations it must do
    for these inputs: each row reads its table's blocks up to its
    deepest query, once."""
    q, pk, _, tables, qpos, _ = args
    b, k1, d = q.shape
    rows = ((qpos.max(dim=1).values // BLOCK + 1) * BLOCK).cpu()
    row_bytes = 2 * d * pk.element_size() + (8 if extra else 0)
    nbytes = (int(rows.sum()) * row_bytes + q.numel() * q.element_size()
              + b * k1 * d * 4 + tables.numel() * 4 + qpos.numel() * 4)
    ops = 4 * d * k1 * int(rows.sum())
    return nbytes, ops


def attend_excess(got, want):
    """The largest ratio, over the elements, of ``|got - want|`` to
    ``TOL * (1 + |want|)`` (``torch.allclose``'s rule at rtol = atol =
    TOL of the queries' type, here the bf16 one): at most 1 passes."""
    return float(((got - want).abs() / (TOL["bfloat16"]
                                        * (1.0 + want.abs()))).max())


def lost_rank_qpos(torch, pa, args):
    """Positions that make the plain version compute what a split kernel
    whose merge left out each row's last busy rank would give: that
    rank's keys (rows ``lo`` on) dropped, i.e. every query clipped to
    ``lo - 1`` (rows whose keys all sit in one rank keep theirs)."""
    q, pk, _, tables, qpos, heads = args
    b, k1, d = q.shape
    nt = tables.shape[1]
    cluster = pa.plan(b, k1, d, heads, BLOCK, nt, pk.dtype)["cluster"]
    out = qpos.clone()
    for r, row in enumerate(qpos.cpu().tolist()):
        live = min(nt, max(row) // BLOCK + 1)
        share = -(-live // cluster)
        lo = (-(-live // share) - 1) * share * BLOCK
        if min(row) >= 0 and lo > 0:
            out[r] = torch.clamp(qpos[r], max=lo - 1)
    return out


#: (case, pool, K1, heads, T, first positions of the rows, padding row
#: last) at the split kernel's edges: one live block; exactly one block
#: per rank (T 8, cluster 8); fewer live blocks than ranks; T 13, not a
#: multiple of the cluster (the last busy rank's share short, one rank
#: empty); T 64 full (the serving window); K1 5, 9 (a verify pass at
#: spec_k 8, at the window's end) and 16; f32 and bf16
#: pools; head dims 64 and 256; a row whose queries all lie before its
#: table (every key masked: the mean of all T x bs V rows)
ATTEND_EDGES = (("live 1", "int8", 1, 8, 16, [3, 15, 0]),
                ("one block per rank", "int8", 1, 8, 8, [127, 113, 0]),
                ("fewer than the ranks", "int8", 1, 8, 16, [40, 70, 0]),
                ("T 13", "int8", 1, 8, 13, [207, 150, 0]),
                ("T 64 full", "int8", 1, 8, 64, [1023, 960, 0]),
                ("K1 5", "int8", 5, 8, 16, [200, 33, 0]),
                ("K1 9 T 64", "int8", 9, 8, 64, [1015, 500, 0]),
                ("K1 16", "int8", 16, 8, 16, [240, 7, 0]),
                ("f32 K1 5", "float32", 5, 8, 13, [190, 60, 0]),
                ("f32 K1 16", "float32", 16, 8, 16, [230, 3, 0]),
                ("bf16", "bfloat16", 1, 8, 16, [250, 100, 0]),
                ("hd 64", "int8", 1, 16, 16, [255, 17, 0]),
                ("hd 256 f32", "float32", 1, 4, 16, [130, 31, 0]),
                ("hd 256 K1 16", "bfloat16", 16, 4, 13, [180, 9, 0]),
                ("all-negative row", "int8", 1, 8, 3, [-7, 20, 0]),
                ("all-negative rows K1 3", "int8", 3, 8, 5, [-9, -3, 0]))
#: (case, pool, K1, d, heads, T, first positions, pool offset in
#: elements) that ``plan`` sends to the column kernel: head rows off the
#: 16-byte chunks (d 1000 over 8 heads: 125 int8, 250 bf16 or 500 f32
#: bytes), and pools passed as views off the 16-byte boundary; each with
#: a row whose queries lie before its table (all, or in the last case
#: the first of three: positions -1, 0, 1)
ATTEND_COLUMN = (
    ("hd 125 K1 1", "int8", 1, 1000, 8, 16, [200, -3, 0], 0),
    ("hd 125 K1 2", "int8", 2, 1000, 8, 13, [97, 15, -9, 0], 0),
    ("hd 125 f32 K1 5", "float32", 5, 1000, 8, 16, [150, -6, 0], 0),
    ("hd 125 bf16 K1 16", "bfloat16", 16, 1000, 8, 8, [90, -20, 0], 0),
    ("offset view", "int8", 1, DIM, HEADS, 16, [140, -5, 0], 1),
    ("offset view bf16 K1 3", "bfloat16", 3, DIM, HEADS, 16,
     [130, 20, -1, 0], 1))
#: how far a planted lost rank must fail the check
ATTEND_FAULT_MIN = 5.0


def paged_ptxas(report):
    """(kernel, registers, static shared memory, spill stores) of each
    kernel in ``paged_attend.cu``'s ``-Xptxas -v`` report, the kernel
    as ``paged_split_kernel<int8, KMAX 1>`` from its mangled name."""
    out = []
    # (a substitution, S<n>_, repeats a type named before it: bf16 here)
    types = {"a": "int8", "f": "f32", "13__nv_bfloat16": "bf16"}
    for entry in report.split("Compiling entry function '")[1:]:
        mangled = entry.split("'", 1)[0]
        name = re.search(r"paged_(?:split|column)_kernel", mangled)
        args = re.search(r"kernelI((?:13__nv_bfloat16|S\d*_|a|f)+)Lb",
                         mangled)
        kmax = re.search(r"Li(\d+)E", mangled)
        label = "%s<%s, KMAX %s>" % (
            name.group(0) if name else mangled,
            ", ".join(types.get(t, "bf16") for t in re.findall(
                r"13__nv_bfloat16|S\d*_|a|f", args.group(1))) if args else "?",
            kmax.group(1) if kmax else "?")
        regs = re.search(r"Used (\d+) registers", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        out.append((label, int(regs.group(1)) if regs else -1,
                    int(smem.group(1)) if smem else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def check_attend(torch, dev, nb):
    """``paged_attend`` against its plain version at the serving shapes
    (int8, B 1 and 8, T 4 and 64; f32 K1 1 and 5; bf16), at
    ATTEND_EDGES (split kernel) and at ATTEND_COLUMN (column kernel), by
    ``torch.allclose``'s rule at TOL, each case on the kernel ``plan``
    names (logged), which must be the kernel its table holds, and run
    twice bit-equal; at the serving depths a planted lost rank
    (:func:`lost_rank_qpos`) must fail the check by ATTEND_FAULT_MIN.
    Returns the largest error."""
    from veles_tpu_torch.ops import paged_attend as pa
    rng = numpy.random.default_rng(1)
    cases = [("serving", "int8", 1, DIM, HEADS, t, b, None, 0, "split")
             for b in (1, 8) for t in (4, 16, 64)]
    cases += [("serving", "float32", 1, DIM, HEADS, 16, 8, None, 0, "split"),
              ("serving", "float32", 5, DIM, HEADS, 16, 8, None, 0, "split"),
              ("serving", "bfloat16", 1, DIM, HEADS, 16, 8, None, 0,
               "split")]
    cases += [(name, pool, k1, DIM, heads, t, len(first), first, 0, "split")
              for name, pool, k1, heads, t, first in ATTEND_EDGES]
    cases += [(name, pool, k1, d, heads, t, len(first), first, offset,
               "column")
              for name, pool, k1, d, heads, t, first, offset in ATTEND_COLUMN]
    worst = 0.0
    for name, pool, k1, d, heads, t, b, first, offset, kernel in cases:
        args, extra = _attend_inputs(torch, rng, dev, b, t, k1, pool, nb,
                                     0, t * BLOCK - k1, heads, first, d,
                                     offset)
        how = pa.plan(b, k1, d, heads, BLOCK, t, args[1].dtype,
                      args[1].data_ptr() % 16 == 0
                      and args[2].data_ptr() % 16 == 0)
        if how["kernel"] != kernel:
            raise SystemExit("paged_attend %s: plan names %s, the case "
                             "holds the %s kernel" % (name, how, kernel))
        before = dict(pa.variant_launches)
        got = pa.paged_attend(*args, **extra)
        again = pa.paged_attend(*args, **extra)
        want = pa.paged_attend_plain(*args, **extra)
        torch.cuda.synchronize()
        ran = {k: pa.variant_launches[k] - before[k] for k in before}
        err = float((got - want).abs().max())
        same = torch.equal(got, again)
        tol = TOL["float32" if pool == "float32" else "bfloat16"]
        line = ("paged_attend %s: pool=%s%s B=%d T=%d K1=%d hd=%d plan %s, "
                "max_abs_err=%.3g, run twice bit-equal %s"
                % (name, pool, " (offset %d)" % offset if offset else "", b,
                   t, k1, d // heads, how, err, same))
        if name == "serving" and b == 8 and pool == "int8" and t > 4:
            bad = pa.paged_attend_plain(*args[:4],
                                        lost_rank_qpos(torch, pa, args),
                                        heads, **extra)
            fault = attend_excess(bad, want)
            line += ("; planted fault (each row's last busy rank left out "
                     "of the merge) at %.3g of the limit" % fault)
            if not fault >= ATTEND_FAULT_MIN:
                raise SystemExit(line + ": the check would not see it")
        log(line)
        if ran != {k: 2 * (k == how["kernel"]) for k in ran}:
            raise SystemExit("paged_attend ran %s, its plan says %s"
                             % (ran, how["kernel"]))
        if not same:
            raise SystemExit("paged_attend is not deterministic (%s)" % name)
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise SystemExit("paged_attend disagrees with its plain "
                             "version (%s): %g" % (name, err))
        worst = max(worst, err)
    log("paged_attend: %d cases within TOL" % len(cases))
    return worst


def check_kernels(torch, dev, rate):
    """Every kernel against its plain version at the serving shapes,
    then timed.  Returns the measured fields of each kernel."""
    from veles_tpu_torch import _build
    nb = SLOTS * (WINDOW // BLOCK) + 1      # the smoke's pool: 512 + trash
    for entry in paged_ptxas(_build.ptxas_reports.get("paged_attend", "")):
        log("ptxas paged_attend %s: %d registers, %d bytes smem, %d bytes "
            "spilled" % entry)
    err = check_attend(torch, dev, nb)
    rng = numpy.random.default_rng(1)
    gemm_err = check_gemm(torch, dev, rng)
    return {"paged_attend": time_attend(torch, dev, rng, nb, rate, err),
            "int8_gemm": time_gemm(torch, dev, rng, rate, gemm_err)}


def _gemm_inputs(torch, dev, rng, m, k, n, dtype):
    from veles_tpu_torch.ops import gemm
    a = torch.as_tensor(rng.standard_normal((m, k)),
                        dtype=torch.float32).to(dev, dtype)
    wq, scale = gemm.int8_weight_quantize(torch.as_tensor(
        rng.standard_normal((k, n)) * 0.02, dtype=torch.float32).to(dev))
    return a, wq, scale


def gemm_excess(got, want, dtype):
    """The largest ratio, over the elements, of ``|got - want|`` to
    ``TOL * (1 + |want|)`` (``torch.allclose``'s rule at rtol = atol =
    TOL of the activations' type): at most 1 passes."""
    tol = TOL[str(dtype).rsplit(".", 1)[-1]]
    return float(((got - want).abs() / (tol * (1.0 + want.abs()))).max())


def check_gemm(torch, dev, rng):
    """``int8_gemm`` against its plain version at m in GEMM_ROWS x the
    three decode shapes and the ragged GEMM_RAGGED ones, bf16 and f32;
    at the decode shapes (m 8, bf16) a second run must be bit-equal and
    the kernel run on ``wq`` with its last cluster rank's rows zeroed (a
    lost split) must fail the check by GEMM_FAULT_MIN.  Prints each
    shape's launch plan and the compiler's report of the source.
    Returns the largest error."""
    from veles_tpu_torch import _build
    from veles_tpu_torch.ops import gemm
    log("ptxas int8_gemm:\n" + _build.ptxas_reports.get(
        "int8_gemm", "(built before this process)").strip())
    worst = 0.0
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for k, n in GEMM_SHAPES + GEMM_RAGGED:
            for m in GEMM_ROWS:
                a, wq, scale = _gemm_inputs(torch, dev, rng, m, k, n, dtype)
                got = gemm.int8_matmul(a, wq, scale)
                want = gemm.int8_matmul_plain(a, wq, scale)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                excess = gemm_excess(got, want, dtype)
                if m in (1, 8, 136) or excess > 0.5:
                    log("int8_gemm %s m=%d k=%d n=%d max_abs_err=%.3g, "
                        "%.3g of the limit, plan %s"
                        % (dt, m, k, n, err, excess,
                           gemm.plan(m, k, n, dtype)))
                if not excess <= 1.0:
                    raise SystemExit("int8_gemm disagrees with its plain "
                                     "version (%s m=%d k=%d n=%d): %.3g of "
                                     "the limit" % (dt, m, k, n, excess))
                worst = max(worst, err)
    for k, n in GEMM_SHAPES:
        a, wq, scale = _gemm_inputs(torch, dev, rng, SLOTS, k, n,
                                    torch.bfloat16)
        plan = gemm.plan(SLOTS, k, n, torch.bfloat16)
        first = gemm.int8_matmul(a, wq, scale)
        second = gemm.int8_matmul(a, wq, scale)
        lost = wq.clone()
        lost[(plan["cluster"] - 1) * plan["k_per_rank"]:] = 0
        bad = gemm.int8_matmul(a, lost, scale)
        want = gemm.int8_matmul_plain(a, wq, scale)
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        excess = gemm_excess(bad, want, torch.bfloat16)
        log("int8_gemm k=%d n=%d: run twice bit-equal %s; planted fault "
            "(rows %d.. of the last of %d ranks zeroed) at %.3g of the "
            "limit" % (k, n, same, (plan["cluster"] - 1)
                       * plan["k_per_rank"], plan["cluster"], excess))
        if not same:
            raise SystemExit("int8_gemm is not deterministic")
        if not excess >= GEMM_FAULT_MIN:
            raise SystemExit("int8_gemm: a lost split fails the check by "
                             "only %.3g" % excess)
    log("int8_gemm: %d cases within TOL"
        % (2 * len(GEMM_ROWS) * len(GEMM_SHAPES + GEMM_RAGGED)))
    return worst


def _mm_inputs(torch, dev, rng, m, k, n, dt, b_kind="same", offset=0):
    """Operands of a matmul case: a [m, k] of ``dt``, b [k, n] of
    ``dt`` or int8, col_scale [n] f32 for "int8" and "scaled" b (else
    None); with ``offset``, a and b lie that many elements into their
    buffers."""
    dtype = getattr(torch, dt)
    a = torch.as_tensor(rng.standard_normal((m, k)),
                        dtype=torch.float32).to(dev, dtype)
    if b_kind == "int8":
        b = torch.as_tensor(rng.integers(-127, 128, (k, n)),
                            dtype=torch.int8).to(dev)
    else:
        b = torch.as_tensor(rng.standard_normal((k, n)),
                            dtype=torch.float32).to(dev, dtype)
    scale = None if b_kind == "same" else torch.as_tensor(
        rng.random(n) * 0.01, dtype=torch.float32).to(dev)
    if offset:
        a, b = _offset_view(torch, a, offset), _offset_view(torch, b, offset)
    return a, b, scale


def mm_excess(got, want):
    """The largest ratio of ``|got - want|`` to its limit: 1e-5 of the
    largest magnitude (the f32 sums run in another order), plus for a
    bf16 output one bf16 step of the element (both sides round an f32
    sum that differs in its last bits).  At most 1 passes."""
    want = want.float()
    diff = (got.float() - want).abs()
    floor = 1e-5 * want.abs().max()
    if str(got.dtype) == "torch.float32":
        return float(diff.max() / floor)
    return float((diff / (2.0 ** -7 * want.abs() + floor)).max())


def _mm_fault(b, plan, fault):
    """``b`` with a planted fault: its last k-tile (the plan's k per
    tile) or its last split-K rank's k rows zeroed."""
    lost = b.clone()
    k = b.shape[0]
    if fault == "k_tile":
        lost[k - plan["bk"]:] = 0
    else:
        lost[(plan["cluster"] - 1) * plan["k_per_rank"]:] = 0
    return lost


def check_matmul(torch, dev, rng):
    """``pallas_matmul`` against ``pallas_matmul_plain`` (TF32 off) at
    MM_CASES: each case on the variant its plan must name (printed), two
    runs bit-equal, the error within ``mm_excess``'s limit, and each
    planted fault failing by MM_FAULT_MIN.  Returns the largest error
    and the cases run per variant."""
    from veles_tpu_torch import _build
    from veles_tpu_torch.ops import gemm
    torch.backends.cuda.matmul.allow_tf32 = False
    log("ptxas matmul:\n" + _build.ptxas_reports.get(
        "matmul", "(built before this process)").strip())
    eps = {None: None, "relu": torch.relu, "tanh": torch.tanh}
    worst, per_variant = 0.0, {}
    for m, k, n, dt, b_kind, ep, out_dt, offset, variant, fault in MM_CASES:
        a, b, scale = _mm_inputs(torch, dev, rng, m, k, n, dt, b_kind,
                                 offset)
        kw = dict(block_m=m, block_n=n, block_k=k, epilogue=eps[ep],
                  out_dtype=getattr(torch, out_dt), col_scale=scale)
        plan = gemm.matmul_plan(a, b)
        if plan["variant"] != variant:
            raise SystemExit("matmul (%s m=%d k=%d n=%d, offset %d): plan "
                             "names %s, not %s" % (dt, m, k, n, offset,
                                                   plan["variant"], variant))
        first = gemm.pallas_matmul(a, b, **kw)
        second = gemm.pallas_matmul(a, b, **kw)
        want = gemm.pallas_matmul_plain(a, b, **kw)
        bad = None if fault is None else mm_excess(
            gemm.pallas_matmul(a, _mm_fault(b, plan, fault), **kw), want)
        torch.cuda.synchronize()
        err = float((first.float() - want.float()).abs().max())
        excess = mm_excess(first, want)
        same = torch.equal(first, second)
        log("matmul %s x %s m=%d k=%d n=%d offset %d epilogue %s out %s: "
            "max_abs_err %.3g, %.3g of the limit, twice bit-equal %s, plan "
            "%s%s" % (dt, b_kind, m, k, n, offset, ep, out_dt, err, excess,
                      same, plan, "" if bad is None else
                      "; planted %s: %.3g of the limit" % (fault, bad)))
        if not excess <= 1.0:
            raise SystemExit("matmul disagrees with its plain version (%s "
                             "m=%d k=%d n=%d, %s): %.3g of the limit"
                             % (dt, m, k, n, variant, excess))
        if not same:
            raise SystemExit("matmul is not deterministic (%s)" % variant)
        if bad is not None and not bad >= MM_FAULT_MIN:
            raise SystemExit("matmul (%s): a planted %s fails the check by "
                             "only %.3g" % (variant, fault, bad))
        worst = max(worst, err)
        per_variant[variant] = per_variant.get(variant, 0) + 1
    log("matmul: %d cases within their limits, by variant %s"
        % (len(MM_CASES), per_variant))
    return worst, per_variant


def matmul_library(torch):
    """The library call timed beside the kernel, and its name: for bf16
    ``torch.mm(a, b, out_dtype=torch.float32)`` where this torch has it
    (else ``torch.mm(a, b).float()``, which rounds to bf16 first); for
    f32 ``torch.mm`` with TF32 off."""
    x = torch.ones((16, 16), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(x, x, out_dtype=torch.float32)
    except TypeError:
        return (lambda a, b: torch.mm(a, b).float()
                if a.dtype == torch.bfloat16 else torch.mm(a, b),
                "torch.mm(a, b).float() (bf16), torch.mm (f32)")
    return (lambda a, b: torch.mm(a, b, out_dtype=torch.float32)
            if a.dtype == torch.bfloat16 else torch.mm(a, b),
            "torch.mm(a, b, out_dtype=torch.float32) (bf16), torch.mm (f32)")


def matmul_path(torch, dev, rng):
    """The kernel's path: its public entry point ``pallas_matmul`` called
    once at each MM_TIMED shape with its count zeroed just before and
    read just after (nothing else in the port calls it), each result
    then held against the plain version within ``mm_excess``'s limit.
    Returns the count and the largest error."""
    from veles_tpu_torch.ops import gemm
    work = [_mm_inputs(torch, dev, rng, m, k, n, dt)[:2]
            for _, m, k, n, dt in MM_TIMED]
    torch.cuda.synchronize()
    gemm.matmul_launches = 0
    outs = [gemm.pallas_matmul(a, b) for a, b in work]
    torch.cuda.synchronize()
    count = gemm.matmul_launches
    if count != len(MM_TIMED):
        raise SystemExit("matmul path: %d launches for %d calls"
                         % (count, len(MM_TIMED)))
    worst = 0.0
    for (label, *_), (a, b), out in zip(MM_TIMED, work, outs):
        want = gemm.pallas_matmul_plain(a, b)
        excess = mm_excess(out, want)
        err = float((out - want).abs().max())
        log("matmul path %s: max_abs_err %.3g, %.3g of the limit"
            % (label, err, excess))
        if not excess <= 1.0:
            raise SystemExit("matmul path %s disagrees with its plain "
                             "version: %.3g of the limit" % (label, excess))
        worst = max(worst, err)
    return count, worst


def time_matmul(torch, dev, rng, rate, checked):
    """Each MM_TIMED shape as CUDA-graph replays of one launch (``ms``)
    and of MM_GRAPH_CALLS back-to-back launches (``ms_20``) beside the
    library call replayed the same ways, the plain version by an eager
    loop, and the bound (bytes: each operand read once and the f32
    output written once; operations: 2 m k n at the operands' type);
    then split_k against wgmma at MM_CROSSOVER_M rows, each output held
    against the plain version first.  Returns the kernels line's
    fields: the first shape's at the top, every shape under
    ``shapes``."""
    from veles_tpu_torch.ops import gemm
    err, per_variant = checked
    library, lib_name = matmul_library(torch)
    before = gemm.matmul_launches
    shapes = {}
    for label, m, k, n, dt in MM_TIMED:
        a, b, _ = _mm_inputs(torch, dev, rng, m, k, n, dt)
        size = 2 if dt == "bfloat16" else 4
        nbytes = m * k * size + k * n * size + m * n * 4
        b_ms, b_by = bound(nbytes, 2 * m * k * n, dt, rate)
        f = {"ms": graph_ms(torch, lambda: gemm.pallas_matmul(a, b)),
             "library_ms": graph_ms(torch, lambda: library(a, b)),
             "ms_20": graph_ms(torch, _repeat(
                 MM_GRAPH_CALLS, lambda: gemm.pallas_matmul(a, b)))
             / MM_GRAPH_CALLS,
             "library_ms_20": graph_ms(torch, _repeat(
                 MM_GRAPH_CALLS, lambda: library(a, b))) / MM_GRAPH_CALLS,
             "plain_ms": time_ms(torch,
                                 lambda: gemm.pallas_matmul_plain(a, b),
                                 reps=5),
             "bound_ms": b_ms, "bound_by": b_by,
             "plan": gemm.matmul_plan(a, b)}
        f["tflops"] = 2 * m * k * n / f["ms"] / 1e9
        log("matmul %s (plan %s): graph-replayed, one launch per replay "
            "%.4f ms (%.1f TFLOP/s, %.1f %% of the %.4f ms bound by %s), "
            "library %.4f ms (%s); %d launches per replay %.4f ms, library "
            "%.4f ms; plain %.4f ms"
            % (label, f["plan"], f["ms"], f["tflops"], 100 * b_ms / f["ms"],
               b_ms, b_by, f["library_ms"], lib_name, MM_GRAPH_CALLS,
               f["ms_20"], f["library_ms_20"], f["plain_ms"]))
        shapes[label] = f
    crossover = {}
    for m in MM_CROSSOVER_M:
        a, b, _ = _mm_inputs(torch, dev, rng, m, DIM, 4 * DIM, "bfloat16")
        want = gemm.pallas_matmul_plain(a, b)
        row = {}
        for variant in ("split_k", "wgmma"):
            plan = gemm.matmul_plan(a, b, variant)
            excess = mm_excess(gemm.matmul_variant(a, b, variant), want)
            if not excess <= 1.0:
                raise SystemExit("matmul %s at m %d disagrees with its "
                                 "plain version: %.3g of the limit"
                                 % (variant, m, excess))
            row[variant] = graph_ms(torch, _repeat(
                MM_GRAPH_CALLS, lambda: gemm.matmul_variant(a, b, variant))) \
                / MM_GRAPH_CALLS
            log("matmul %s at %dx1024x4096 (plan %s): %.3g of the limit, "
                "%d launches per replay %.4f ms"
                % (variant, m, plan, excess, MM_GRAPH_CALLS, row[variant]))
        crossover[m] = row
    gemm.matmul_launches = before
    faster = [m for m in MM_CROSSOVER_M
              if crossover[m]["split_k"] > crossover[m]["wgmma"]]
    log("matmul crossover at k 1024, n 4096: wgmma is faster than split_k "
        "from m %s (the plan switches past m %d)"
        % (faster[0] if faster else "> %d" % MM_CROSSOVER_M[-1],
           split_max_m(torch)))
    first = dict(shapes[MM_TIMED[0][0]])
    first.update(max_abs_err=err, library=lib_name, shapes=shapes,
                 crossover=crossover, cases_by_variant=per_variant)
    return first


def _repeat(count, fn):
    """``fn`` called ``count`` times in a row (one graph of back-to-back
    launches)."""
    def run():
        for _ in range(count):
            fn()
    return run


def split_max_m(torch):
    """The largest m the matmul plan sends to split_k at 1024 x 4096
    (bf16, aligned): read from the plans, not restated."""
    from veles_tpu_torch.ops import gemm
    b = torch.empty((DIM, 4 * DIM), dtype=torch.bfloat16, device="cuda")
    return max(m for m in range(1, 257) if gemm.matmul_plan(
        torch.empty((m, DIM), dtype=torch.bfloat16, device="cuda"),
        b)["variant"] == "split_k")


def graph_ms(torch, fn, reps=50):
    """Mean milliseconds of ``fn()`` captured once in a CUDA graph and
    replayed ``reps`` times between two events: the device's time for
    its launches, without the host's dispatch of each (as long as the
    host replays a graph faster than the device runs it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_attend_at(torch, dev, rng, nb, rate, t, lo, hi, k1, eager):
    """One model pass's attention at a block bucket ``t``: 8 layers'
    int8 pools (134 MB together, so they do not sit in the 50 MB L2 as
    one layer's would), B=8 rows (7 requests, first positions drawn
    from [lo, hi], and one padding row), ``k1`` queries each; every
    layer gets the same table and positions, as in a real pass.  Per
    launch: the kernel's and the library yardstick's device times as
    replays of a CUDA graph of the 8 launches (``ms``, ``library_ms``),
    the bound for these inputs and, with ``eager``, the host-paced
    eager loops and the plain version."""
    from veles_tpu_torch.ops import paged_attend as pa
    layers = [_attend_inputs(torch, rng, dev, 8, t, k1, "int8", nb, lo, hi)
              for _ in range(LAYERS)]
    for args, _ in layers[1:]:
        args[3].copy_(layers[0][0][3])
        args[4].copy_(layers[0][0][4])

    def kernel():
        for args, extra in layers:
            pa.paged_attend(*args, **extra)

    def plain():
        for args, extra in layers:
            pa.paged_attend_plain(*args, **extra)

    def library():
        # gather + dequantize the table's blocks, then one
        # scaled_dot_product_attention call with the causal mask
        for (q, pk, pv, tables, qpos, heads), ex in layers:
            b, k1, d = q.shape
            idx = tables.long()
            hd = d // heads
            length = idx.shape[1] * BLOCK
            k = (pk[idx].to(q.dtype) * ex["scale_k"][idx][..., None]
                 .to(q.dtype)).reshape(b, length, heads, hd).transpose(1, 2)
            v = (pv[idx].to(q.dtype) * ex["scale_v"][idx][..., None]
                 .to(q.dtype)).reshape(b, length, heads, hd).transpose(1, 2)
            keep = (torch.arange(length, device=q.device)[None, None, :]
                    <= qpos.long()[:, :, None])[:, None]
            torch.nn.functional.scaled_dot_product_attention(
                q.reshape(b, k1, heads, hd).transpose(1, 2), k, v,
                attn_mask=keep).float()

    nbytes, ops = _attend_bytes_ops(*layers[0])
    b_ms, b_by = bound(nbytes, ops, "bfloat16", rate)
    before = pa.launches, dict(pa.variant_launches)
    f = {"ms": graph_ms(torch, kernel) / LAYERS,
         "library_ms": graph_ms(torch, library) / LAYERS,
         "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
         "plan": pa.plan(8, min(k1, pa.MAX_K1), DIM, HEADS, BLOCK, t,
                         torch.int8)}
    if eager:
        f.update(eager_ms=time_ms(torch, kernel) / LAYERS,
                 plain_ms=time_ms(torch, plain) / LAYERS,
                 library_eager_ms=time_ms(torch, library) / LAYERS)
    pa.launches = before[0]           # timing launches are not the path's
    pa.variant_launches.update(before[1])
    line = ("paged_attend per launch at T=%d, K1=%d (first positions %d..%d, "
            "plan %s): graph-replayed %.4f ms (%.1f %% of the %.5f ms bound "
            "by %s), library graph-replayed %.4f ms"
            % (t, k1, lo, hi, f["plan"], f["ms"], 100 * b_ms / f["ms"], b_ms,
               b_by, f["library_ms"]))
    if eager:
        line += ("; host-paced eager loop: kernel %.4f ms, library %.4f ms; "
                 "plain %.4f ms" % (f["eager_ms"], f["library_eager_ms"],
                                    f["plain_ms"]))
    log(line)
    return f


def time_attend(torch, dev, rng, nb, rate, err):
    """One decode step's attention (K1 = 1) at two depths: positions
    128..159, the smoke's decode range (T=16, its block bucket), and
    960..1023, the serving window's end (T=64); then one verify pass's
    (K1 = 5 and 9: spec_k 4, the scheduler's default, and 8, the spec
    phase's) at both buckets.  A launch (a few us) is shorter than the
    host's dispatch of one through the wrapper, so every ``ms`` and
    ``library_ms`` comes from CUDA-graph replays (:func:`_time_attend_at`);
    the decode ones keep the eager loops beside them as ``eager_ms`` and
    ``library_eager_ms``.  Times are per launch; the returned fields are
    the decode step's at T=16, with T=64 under ``deep`` and the verify
    passes under ``verify``."""
    deep = WINDOW // BLOCK
    spans = {16: (PROMPT, PROMPT + STEPS - 1), deep: (WINDOW - 64, WINDOW - 1)}
    depths = {t: _time_attend_at(torch, dev, rng, nb, rate, t, lo, hi, 1,
                                 True)
              for t, (lo, hi) in spans.items()}
    verify = {}
    for k1 in (5, 9):
        for t, (lo, hi) in spans.items():
            verify["K1 %d T %d" % (k1, t)] = _time_attend_at(
                torch, dev, rng, nb, rate, t, lo, min(hi, t * BLOCK - k1),
                k1, False)
    return dict(depths[16], max_abs_err=err, deep=depths[deep],
                verify=verify)


def _time_gemm_at(torch, dev, rng, rate, m, eager):
    """One model pass's int8 GEMMs per layer (wo, ffn_w1, ffn_w2 at ``m``
    rows), over 8 layers' distinct weights (72 MB of int8, more than
    the L2 holds).  Times are per layer (three launches): the kernel's
    and the library yardstick's device times as replays of a CUDA graph
    of the 24 launches (``ms``, ``library_ms``; a launch of ~3 us is
    shorter than the host's dispatch of one), the bound and, with
    ``eager``, the host-paced eager loops and the plain version."""
    from veles_tpu_torch.ops import gemm
    work = [_gemm_inputs(torch, dev, rng, m, k, n, torch.bfloat16)
            for _ in range(LAYERS) for k, n in GEMM_SHAPES]

    def kernel():
        for a, wq, scale in work:
            gemm.int8_matmul(a, wq, scale)

    def plain():
        for a, wq, scale in work:
            gemm.int8_matmul_plain(a, wq, scale)

    def library():
        for a, wq, scale in work:
            torch.matmul(a, wq.to(a.dtype)) * scale

    nbytes = sum(m * k * 2 + k * n + n * 4 + m * n * 4 for k, n in GEMM_SHAPES)
    ops = sum(2 * m * k * n for k, n in GEMM_SHAPES)
    b_ms, b_by = bound(nbytes, ops, "bfloat16", rate)
    before = gemm.launches
    f = {"ms": graph_ms(torch, kernel) / LAYERS,
         "library_ms": graph_ms(torch, library) / LAYERS,
         "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
    if eager:
        f.update(eager_ms=time_ms(torch, kernel) / LAYERS,
                 plain_ms=time_ms(torch, plain) / LAYERS,
                 library_eager_ms=time_ms(torch, library) / LAYERS)
    gemm.launches = before
    line = ("int8_gemm per layer (3 launches, m=%d): graph-replayed %.4f ms "
            "(%.1f %% of the %.5f ms bound by %s), library graph-replayed "
            "%.4f ms" % (m, f["ms"], 100 * b_ms / f["ms"], b_ms, b_by,
                         f["library_ms"]))
    if eager:
        line += ("; host-paced eager loop: kernel %.4f ms, library %.4f ms; "
                 "plain %.4f ms" % (f["eager_ms"], f["library_eager_ms"],
                                    f["plain_ms"]))
    log(line)
    return f


def time_gemm(torch, dev, rng, rate, err):
    """One decode step's int8 GEMMs (m = 8, with the eager loops), then
    one verify pass's at 8 rows of K1 = 5 and 9 (m 40 and 72) under
    ``verify``, all by :func:`_time_gemm_at`."""
    fields = _time_gemm_at(torch, dev, rng, rate, SLOTS, True)
    fields.update(max_abs_err=err, verify={
        "m %d" % m: _time_gemm_at(torch, dev, rng, rate, m, False)
        for m in (SLOTS * 5, SLOTS * 9)})
    return fields


# -- phase 2: FlashAttention kernels ------------------------------------------

def _flash_inputs(torch, dev, case, seed):
    b, sq, sk, h, d, dt, _ = case
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dt)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
               for s in (sq, sk, sk))
    return q, k, v, torch.randn((b, sq, h, d), generator=gen).to(dev, dtype)


def flash_excess(got, want):
    """The largest ratio, over the elements, of ``|got - want|`` to its
    limit ``tol * (|want| + rms(want)) + floor`` (FLASH_TOL by
    ``want``'s type): at most 1 passes."""
    tol, floor = FLASH_TOL[str(want.dtype).rsplit(".", 1)[-1]]
    got, want = got.float(), want.float()
    lim = tol * (want.abs() + want.square().mean().sqrt()) + floor
    return float(((got - want).abs() / lim).max())


def planted_faults(fa, q, k, v, do, o, lse, delta, causal):
    """What the plain versions give for three kernel faults, to show
    that the check of FLASH_TOL rejects them at the training shapes:
    the forward and dq without their last key tile (the rows of the
    last query tile lose 64 of their ~2000 keys), the forward with the
    scale 10% off, and dk/dv without their last query tile."""
    t = 64
    scale = fa.default_scale(q.shape[-1])
    o_short, lse_short = fa.flash_fwd_plain(q, k[:, :-t], v[:, :-t], causal)
    o_scaled, lse_scaled = fa.flash_fwd_plain(q, k, v, causal, 1.1 * scale)
    dk_short, dv_short = fa.flash_bwd_dkv_plain(
        q[:, :-t], k, v, do[:, :-t], lse[..., :-t], delta[..., :-t], causal)
    return {
        "flash_attn_fwd": {"last key tile dropped": (o_short, lse_short),
                           "scale x1.1": (o_scaled, lse_scaled)},
        "flash_attn_dq": {"last key tile dropped": fa.flash_bwd_dq_plain(
            q, k[:, :-t], v[:, :-t], do, o, lse, causal)},
        "flash_attn_dkv": {"last query tile dropped": (dk_short, dv_short)}}


def score_ulps(torch, fa, q, k, lse):
    """(mean, max) over batch and heads of the f32 ulps between row 0's
    LSE from a causal forward, which is its one kept score times the
    scale, and the score summed exactly (f64), rounded to f32, scaled."""
    x = torch.einsum("bhd,bhd->bh", q[:, 0].double(),
                     k[:, 0].double()).float() * fa.default_scale(q.shape[-1])
    ulp = torch.finfo(torch.float32).eps * torch.exp2(
        torch.floor(torch.log2(x.abs())))
    ulps = (lse[:, :, 0] - x).abs() / ulp
    return float(ulps.mean()), float(ulps.max())


def check_flash(torch, dev, rate):
    """The forward, dq and dk/dv kernels against their plain versions
    on every case of FLASH_CASES (the backward ones from the kernel's
    O, LSE and delta), element by element (:func:`flash_excess`); at
    the training shapes, planted faults must fail the same check by
    FLASH_FAULT_MIN and a second backward must be bit-equal to the
    first.  Then timed at the training shapes."""
    from veles_tpu_torch.ops import flash_attention as fa
    errs = dict.fromkeys(fa.launches, 0.0)
    for n, case in enumerate(FLASH_CASES):
        causal = case[-1]
        q, k, v, do = _flash_inputs(torch, dev, case, n)
        o, lse = fa.flash_fwd(q, k, v, causal)
        dq, delta = fa.flash_bwd_dq(q, k, v, do, o, lse, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        got = {"flash_attn_fwd": (o, lse), "flash_attn_dq": (dq, delta),
               "flash_attn_dkv": (dk, dv)}
        want = {"flash_attn_fwd": fa.flash_fwd_plain(q, k, v, causal),
                "flash_attn_dq": fa.flash_bwd_dq_plain(
                    q, k, v, do, o, lse, causal),
                "flash_attn_dkv": fa.flash_bwd_dkv_plain(
                    q, k, v, do, lse, delta, causal)}
        faults = planted_faults(fa, q, k, v, do, o, lse, delta, causal) \
            if n == 0 else {}
        if n == 0:
            log("flash_attn_fwd %s: row 0's LSE (its one score, scaled) is "
                "%.3g f32 ulps from the exact sum's on average, %.3g at "
                "most" % ((case,) + score_ulps(torch, fa, q, k, lse)))
            dq2, delta2 = fa.flash_bwd_dq(q, k, v, do, o, lse, causal)
            again = (dq2, delta2,
                     *fa.flash_bwd_dkv(q, k, v, do, lse, delta2, causal))
            same = [torch.equal(a, b)
                    for a, b in zip(again, (dq, delta, dk, dv))]
            log("flash backward run twice at %s: dq, delta, dk, dv "
                "bit-equal %s" % (case, same))
            if not all(same):
                raise SystemExit("the FlashAttention backward is not "
                                 "deterministic")
        torch.cuda.synchronize()
        for name in got:
            for g, w in zip(got[name], want[name]):
                err = float((g.float() - w.float()).abs().max())
                excess = flash_excess(g, w)
                log("%s %s max_abs_err=%.3g, %.3g of the limit"
                    % (name, case, err, excess))
                if not excess <= 1.0:
                    raise SystemExit("%s disagrees with its plain version "
                                     "at %s: %.3g of the limit"
                                     % (name, case, excess))
                errs[name] = max(errs[name], err)
            for fault, bad in faults.get(name, {}).items():
                excess = max(flash_excess(b, w)
                             for b, w in zip(bad, want[name]))
                err = max(float((b.float() - w.float()).abs().max())
                          for b, w in zip(bad, want[name]))
                log("%s %s planted fault (%s): max_abs_err=%.3g, %.3g of "
                    "the limit" % (name, case, fault, err, excess))
                if not excess >= FLASH_FAULT_MIN:
                    raise SystemExit("%s: a planted fault (%s) fails the "
                                     "check by only %.3g" % (name, fault,
                                                             excess))
        del q, k, v, do, o, lse, dq, delta, dk, dv, got, want, faults
    return time_flash(torch, dev, rate, errs)


def time_flash(torch, dev, rate, errs):
    """Each kernel at the training shapes beside its plain version and
    the library's ``scaled_dot_product_attention`` (forward; its
    backward through autograd computes dq, dk and dv together and is
    the yardstick of both backward kernels); then the kernels and the
    library alone at head dim 256 (the full-length hd 256 case).
    Bounds count the kept (row, col) pairs of the causal mask: 4, 6 and
    8 flops per pair and head dim for the forward, dq and dk/dv (two,
    three and four products), and each input read once, each output
    written once."""
    out = flash_times(torch, dev, rate, FLASH_CASES[0], plain=True)
    for name in out:
        out[name]["max_abs_err"] = errs[name]
    flash_times(torch, dev, rate, next(c for c in FLASH_CASES
                                       if c[4] == 256 and c[1] >= 1024))
    return out


def flash_times(torch, dev, rate, case, plain=False):
    """The fields of :func:`time_flash` for one case (the plain
    versions' times only if ``plain``), each logged with its achieved
    TFLOP/s beside the bound's."""
    from veles_tpu_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, sq, sk, h, d, dt, causal = case
    q, k, v, do = _flash_inputs(torch, dev, case, 100)
    o, lse = fa.flash_fwd(q, k, v, causal)
    _, delta = fa.flash_bwd_dq(q, k, v, do, o, lse, causal)
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ldo = do.transpose(1, 2).contiguous()
    lo = sdpa(lq, lk, lv, is_causal=causal)

    def lib_fwd():
        with torch.no_grad():
            sdpa(lq, lk, lv, is_causal=causal)

    def lib_bwd():
        torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    pairs = b * h * sum(min(r + 1, sk) if causal else sk for r in range(sq))
    row = b * h * d * q.element_size()           # one sequence position
    stat = b * h * sq * 4                         # the lse or delta
    work = {
        "flash_attn_fwd": (                       # q, k, v -> o, lse
            (2 * sq + 2 * sk) * row + stat, 4 * d * pairs,
            lambda: fa.flash_fwd(q, k, v, causal),
            lambda: fa.flash_fwd_plain(q, k, v, causal), lib_fwd),
        "flash_attn_dq": (                        # q, k, v, do, o, lse
            (4 * sq + 2 * sk) * row + 2 * stat,   # -> dq, delta
            6 * d * pairs,
            lambda: fa.flash_bwd_dq(q, k, v, do, o, lse, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, o, lse, causal),
            lib_bwd),
        "flash_attn_dkv": (                       # q, k, v, do, lse, delta
            (2 * sq + 4 * sk) * row + 2 * stat,   # -> dk, dv
            8 * d * pairs,
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal),
            lib_bwd)}
    before = dict(fa.launches)
    out = {}
    for name, (nbytes, ops, kernel, plain_fn, library) in work.items():
        b_ms, b_by = bound(nbytes, ops, dt, rate)
        got = {"ms": time_ms(torch, kernel, reps=10),
               "library_ms": time_ms(torch, library, reps=10),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": ops}
        if plain:
            got["plain_ms"] = time_ms(torch, plain_fn, reps=5)
        got["tflops"] = ops / got["ms"] / 1e9
        log("%s %s: %.4f ms, %.1f TFLOP/s (bound %.4f ms by %s, %.1f "
            "TFLOP/s); plain %s; library %.4f ms, %.1f TFLOP/s"
            % (name, case, got["ms"], got["tflops"], b_ms, b_by,
               ops / b_ms / 1e9, "%.3f ms" % got["plain_ms"] if plain
               else "not timed", got["library_ms"],
               ops / got["library_ms"] / 1e9))
        out[name] = got
    fa.launches.update(before)        # timing launches are not the path's
    return out


# -- phase 3: small reference -------------------------------------------------

def reference_check(torch, dev, moe=False):
    """A small float32 chain (d=256, 2 heads of 128, 2 layers, vocab
    512) with int8 pools and ``int8_decode``, on the card through the
    kernels and on the CPU through the plain versions, same weights
    and tokens: prefill logits and 4 decode steps' logits must agree
    to 1e-3 (f32 sums in another order; an int8 K/V or weight value
    that lands on a rounding edge may quantize one step apart).  Then
    one verify pass at K1 = 5 over two rows — the decoded row with 5
    real positions (its pending token and 4 drafts) and a second prompt
    in the cache's second slot with 3 — whose logits must agree to
    1e-3 with the CPU's and, on the card, with 5 sequential decode
    steps on a copy of the cache fed the same tokens.  ``moe`` (phase
    3b) gives the blocks MoE FFNs (MOE_EXPERTS, top MOE_TOP_K): a pass
    then launches ``int8_gemm`` once per layer (``wo``), not three
    times, and the serving surface's checks are left to phase 3."""
    import copy
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.serving import (
        PagedKVCache, paged_decode_logits, prefill, verify_logits)
    what = "reference (moe)" if moe else "reference"
    ffn = dict(n_experts=MOE_EXPERTS, top_k=MOE_TOP_K) if moe else {}
    gemms = 1 if moe else 3
    spec = [{"type": "embedding", "vocab": 512, "dim": 256}]
    spec += [dict({"type": "transformer_block", "heads": 2,
                   "int8_decode": True}, **ffn) for _ in range(2)]
    spec += [{"type": "token_logits", "vocab": 512}]
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    prompt = numpy.random.default_rng(2).integers(0, 512, (1, 40))
    second = numpy.random.default_rng(3).integers(0, 512, (1, 23))
    drafts = numpy.random.default_rng(5).integers(0, 512, (2, 4))
    vpos, vlens = numpy.asarray([44, 23]), numpy.asarray([5, 3])
    valid = [(n, j) for n in range(2) for j in range(vlens[n])]
    # the CPU run picks the greedy tokens; the card is fed the same ones
    toks = []
    vtoks = numpy.zeros((2, 5), numpy.int64)
    runs, verify = {}, {}
    for d in ("cpu", dev):
        chain = init_params(spec, 3, 128, device=d, dtype="float32")
        cache = PagedKVCache(chain, 2, 128, block_size=BLOCK,
                             kv_dtype="int8")
        slot = cache.alloc(64)
        caches, last = prefill(chain, prompt, window=48)
        cache.insert(slot, caches, 40)
        tables = cache.table_rows([slot], 4)
        logits = [last]
        launches = (pa.launches, gemm.launches)
        for step in range(4):
            if d == "cpu":
                toks.append(int(logits[-1].argmax()))
            logits.append(paged_decode_logits(chain, cache, [[toks[step]]],
                                              [40 + step], tables))
        decoded = (pa.launches - launches[0], gemm.launches - launches[1])
        runs[str(d)] = torch.stack([x[0] for x in logits]).cpu()
        slot2 = cache.alloc(32)
        caches, last2 = prefill(chain, second, window=32)
        cache.insert(slot2, caches, 23)
        if d == "cpu":
            vtoks[0] = [int(logits[-1].argmax())] + drafts[0].tolist()
            vtoks[1, :3] = [int(last2.argmax())] + drafts[1, :2].tolist()
        vtables = cache.table_rows([slot, slot2], 4)
        twin = copy.copy(cache)
        twin.pools = {i: {n: t.clone() for n, t in pool.items()}
                      for i, pool in cache.pools.items()}
        launches = (pa.launches, gemm.launches)
        verify[str(d)] = verify_logits(chain, cache, vtoks, vpos, vlens,
                                       vtables).cpu()
        verified = (pa.launches - launches[0], gemm.launches - launches[1])
    if decoded != (8, 8 * gemms) or verified != (2, 2 * gemms):
        raise SystemExit("%s: the card's decode (%s launches) or verify "
                         "(%s) did not run through the kernels"
                         % (what, decoded, verified))
    err = float((runs["cpu"] - runs[str(dev)]).abs().max())
    scale = float(runs["cpu"].abs().max())
    log("%s: prefill + 4 decode steps, logits max_abs_err=%.3g "
        "(|logits| <= %.3g)" % (what, err, scale))
    if not torch.allclose(runs[str(dev)], runs["cpu"], rtol=1e-3,
                          atol=1e-3) or not torch.isfinite(
                              runs[str(dev)]).all():
        raise SystemExit("%s: card and CPU logits disagree: %g"
                         % (what, err))
    # the same run as sequential decode steps on the card's copy
    steps = torch.zeros_like(verify[str(dev)])
    for j in range(5):
        rows = [n for n in range(2) if j < vlens[n]]
        out = paged_decode_logits(chain, twin, vtoks[rows, j:j + 1],
                                  vpos[rows] + j, vtables[rows]).cpu()
        for r, n in enumerate(rows):
            steps[n, j] = out[r]
    card, cpu = (torch.stack([verify[k][n, j] for n, j in valid])
                 for k in (str(dev), "cpu"))
    seq = torch.stack([steps[n, j] for n, j in valid])
    errs = (float((card - cpu).abs().max()), float((card - seq).abs().max()))
    log("%s: verify pass at K1=5 (rows of 5 and 3 real positions), "
        "logits max_abs_err=%.3g against the CPU, %.3g against 5 "
        "sequential decode steps on the card" % ((what,) + errs))
    if not torch.isfinite(card).all() \
            or not torch.allclose(card, cpu, rtol=1e-3, atol=1e-3) \
            or not torch.allclose(card, seq, rtol=1e-3, atol=1e-3):
        raise SystemExit("%s: the card's verify logits disagree: %g (CPU), "
                         "%g (sequential)" % ((what,) + errs))
    if not moe:
        reference_surface(torch, dev, spec)


def reference_surface(torch, dev, spec):
    """Phase 3's checks of the serving surface on the same small chain
    (weights from seed 3), card against CPU: greedy ``generate`` with
    and without the kv cache (16 steps after two 24-token prompts; the
    tokens equal across both forms and both devices), ``embed_pool``
    of three ragged rows within 1e-5, and ``slot_decode_step`` (3 steps
    over a greedy and a seeded slot beside a free one, the tokens
    equal)."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.models.generate import generate
    from veles_tpu_torch.serving import SlotKVCache, prefill, slot_decode_step
    from veles_tpu_torch.serving.openai_api import embed_pool
    rng = numpy.random.default_rng(7)
    prompts = rng.integers(0, 512, (2, 24))
    rows, lens = rng.integers(0, 512, (3, 32)), [32, 17, 5]
    temps = numpy.asarray([0.0, 0.9, 0.0], numpy.float32)
    topks = numpy.asarray([0, 0, 0], numpy.int32)
    seeds = numpy.asarray([0, 77, 0], numpy.uint32)
    got = {}
    for d in ("cpu", dev):
        chain = init_params(spec, 3, 128, device=d, dtype="float32")
        gen = [generate(chain, prompts, 16, kv_cache=kv).cpu()
               for kv in (False, True)]
        emb = embed_pool(chain, rows, lens).cpu()
        cache = SlotKVCache(chain, 3, 128)
        for n in range(2):
            caches, _ = prefill(chain, prompts[n:n + 1], window=32)
            cache.insert(cache.alloc(24), caches, 24)
        toks = numpy.zeros((3, 1), numpy.int32)
        toks[:2, 0] = prompts[:, -1]
        pos = numpy.asarray([23, 23, 0], numpy.int32)
        steps = []
        for step in range(3):
            nxt = slot_decode_step(chain, cache, toks, pos, temps, topks,
                                   seeds, numpy.full(3, step, numpy.int32))
            steps.append(nxt[:2].tolist())
            toks[:2, 0] = nxt[:2]
            pos[:2] += 1
        got[str(d)] = (gen, emb, steps)
    (cgen, cemb, csteps), (dgen, demb, dsteps) = got["cpu"], got[str(dev)]
    err = float((demb - cemb).abs().max())
    log("reference: generate (rescan and kv) %s, embed_pool max_abs_err="
        "%.3g, slot_decode_step tokens %s card against CPU"
        % ("equal" if all(torch.equal(a, b) for a in cgen + dgen
                          for b in cgen) else "DIFFER", err,
           "equal" if csteps == dsteps else "DIFFER"))
    if not all(torch.equal(a, cgen[0]) for a in cgen + dgen) \
            or not torch.isfinite(demb).all() or err > 1e-5 \
            or csteps != dsteps:
        raise SystemExit("reference: the serving surface disagrees card "
                         "against CPU")


# -- phase 4: train reference -------------------------------------------------

def _span_steps(torch, gd, loader, rows):
    """Train minibatches ``rows`` of the loader's current span one at a
    time (``GradientDescent.run_minibatch``, the samples' labels as the
    targets); returns their losses."""
    from veles_tpu_torch.loader import TRAIN
    idx = torch.as_tensor(loader.span_indices_).long().to(gd.device)
    losses = []
    for k in rows:
        loss, _, _ = gd.run_minibatch(
            loader.dataset_dev[idx[k]], loader.labels_dev[idx[k]],
            int(loader.span_sizes_[k]), TRAIN)
        losses.append(loss)
    return losses


def train_reference(torch, dev, moe=False):
    """A small float32 LM chain (d 256, 2 heads of 128, 2 layers, vocab
    256, seq 64, minibatch 4) takes 3 SGD-momentum steps from the same
    weights and minibatches three times: on the card through the
    FlashAttention kernels, on the card through the dense core
    (``attn_impl="dense"``), and on the CPU through the kernels' plain
    versions.  The kernel run is held to the dense card run: losses to
    TRAIN_REF_LOSS relative, and each parameter's distance from the
    dense run's to TRAIN_REF_STEP of the dense run's own update (the
    other matmuls are the card's same calls on the same inputs, so only
    the attention core differs).  The CPU run is a loose second
    witness: losses to 1e-4 relative, weights to 5e-4 (f32 sums in
    another order; a ReLU input that rounds to the other side of 0
    moves its whole gradient).  ``moe`` (phase 4b) gives the blocks MoE
    FFNs (MOE_EXPERTS, top MOE_TOP_K), dense dispatch; the limits stay.
    Returns the FlashAttention kernels' launches of the kernel run."""
    from veles_tpu_torch.convert import init_params, params_to_numpy
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.samples.lm import lm_spec
    what = "train reference (moe)" if moe else "train reference"
    ffn = dict(n_experts=MOE_EXPERTS, top_k=MOE_TOP_K) if moe else {}
    toks = numpy.random.default_rng(4).integers(0, 256, (12, 64)).astype(
        numpy.int32)
    runs, launched = {}, {}
    for name, d, impl in (("kernels", dev, None), ("dense", dev, "dense"),
                          ("cpu", "cpu", "pallas")):
        chain = init_params(lm_spec(256, 256, 2, 2, attn_impl=impl, **ffn),
                            5, 64, device=d, dtype="float32")
        start = params_to_numpy(chain)
        loader = FullBatchLoader(toks, None, [0, 0, 12], minibatch_size=4,
                                 seed=6, device=d)
        gd = GradientDescent(chain, EvaluatorNextToken(), solver="sgd",
                             learning_rate=0.01, gradient_moment=0.9)
        loader.serve_span()
        before = dict(fa.launches)
        losses = torch.stack(_span_steps(torch, gd, loader, range(3)))
        launched[name] = {n: fa.launches[n] - before[n] for n in before}
        runs[name] = (losses.cpu().double(), params_to_numpy(chain))
    if launched["kernels"] != dict.fromkeys(fa.launches, 6) or any(
            launched["dense"].values()):
        raise SystemExit("%s: launched %s (want 6 of each in the kernel "
                         "run: 2 layers x 3 steps, none in the dense run)"
                         % (what, launched))
    (k_loss, k_p), (d_loss, d_p), (c_loss, c_p) = (
        runs[n] for n in ("kernels", "dense", "cpu"))
    step = {}
    for i in d_p:
        for n in d_p[i]:
            moved = numpy.linalg.norm((d_p[i][n] - start[i][n]).ravel())
            step["%d.%s" % (i, n)] = float(numpy.linalg.norm(
                (k_p[i][n] - d_p[i][n]).ravel()) / max(moved, 1e-30))
    worst = max(step, key=step.get)
    loss_err = float(((k_loss - d_loss).abs() / d_loss.abs()).max())
    cpu_err = max(float(numpy.abs(k_p[i][n] - c_p[i][n]).max())
                  for i in c_p for n in c_p[i])
    log("%s: losses %s (kernels) vs %s (dense, card) vs %s (CPU); kernels "
        "vs dense: losses %.3g relative, parameters <= %.3g of their update "
        "(%s); kernels vs CPU weights max_abs_err=%.3g"
        % (what, k_loss.tolist(), d_loss.tolist(), c_loss.tolist(),
           loss_err, step[worst], worst, cpu_err))
    if not loss_err <= TRAIN_REF_LOSS or not step[worst] <= TRAIN_REF_STEP:
        raise SystemExit("%s: the kernel run and the dense run disagree"
                         % what)
    if not torch.allclose(k_loss, c_loss, rtol=1e-4, atol=0) \
            or cpu_err > 5e-4:
        raise SystemExit("%s: card and CPU training disagree" % what)
    return launched["kernels"]


# -- phase 5: learns ----------------------------------------------------------

def learns(torch, dev):
    """``train_lm`` on the Markov corpus through the kernels: 9 epochs of
    32 Adam steps (cosine over 256 steps, 20 warm-up steps); the
    validation span that opens the ninth epoch (after 256 steps) must
    score a per-token cross-entropy below the corpus' unigram entropy
    (``tests/test_lm.py``'s check of the JAX sample)."""
    from veles_tpu_torch.samples.lm import build_lm, train_lm
    t0 = time.perf_counter()
    lm = build_lm(vocab=64, dim=256, blocks=2, heads=2, seq=128,
                  n_train=4096, n_valid=512, minibatch_size=128,
                  learning_rate=2e-3,
                  lr_schedule_params={"total_steps": 256, "floor": 0.1,
                                      "warmup": 20},
                  device=dev, dtype="bfloat16")
    history = train_lm(lm, 9)
    torch.cuda.synchronize()
    curve = [round(r["validation_loss"], 4) for r in history]
    h_uni = lm.loader.h_unigram_
    log(json.dumps({"learns": {
        "validation_loss_by_epoch": curve, "h_unigram": h_uni,
        "h_bigram": lm.loader.h_bigram_, "steps": lm.trainer.global_step,
        "seconds": time.perf_counter() - t0}}))
    if not 0.0 < curve[-1] < h_uni:
        raise SystemExit("learns: validation CE %.4f is not below the "
                         "unigram entropy %.4f" % (curve[-1], h_uni))


# -- phase 6: serve -----------------------------------------------------------

def serve_check(torch, dev):
    """The main path at the serving width, the prefix cache off (the
    warm-up request repeats ``prompts[0]``, which would admit the
    measured one warm); returns the launch counts of the measured run
    and the chain, and prints its serving numbers."""
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import InferenceScheduler
    t0 = time.perf_counter()
    chain = init_params(serve_spec(), 0, WINDOW, device=dev,
                        dtype="bfloat16")
    sch = InferenceScheduler(chain, max_slots=SLOTS, window=WINDOW,
                             block_size=BLOCK, kv_dtype="int8",
                             prefill_chunk=CHUNK, spec=False,
                             prefix_cache=False, device=dev).start()
    log("serve: chain and scheduler up in %.1f s"
        % (time.perf_counter() - t0))
    rng = numpy.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(SLOTS)]
    try:
        warm = sch.submit(prompts[0], STEPS).result(600)
        if len(warm) != PROMPT + STEPS:
            raise SystemExit("serve: warm-up returned %d tokens"
                             % len(warm))
        steps0, toks0 = sch.decode_steps, sch.decode_tokens
        secs0, done0 = sch.decode_seconds, len(sch.completed)
        snap0, total0 = sch.metrics(), sch.stats.slot_total_steps
        torch.cuda.synchronize()
        pa.launches = 0
        pa.variant_launches.update(split=0, column=0)
        gemm.launches = 0
        gemm.matmul_launches = 0
        t0 = time.perf_counter()
        futs = [sch.submit(p, STEPS) for p in prompts]
        outs = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"paged_attend": pa.launches,
                    "int8_gemm": gemm.launches}
        variants = dict(pa.variant_launches)
        others = {"matmul": gemm.matmul_launches}
        steps = sch.decode_steps - steps0
        dtoks = sch.decode_tokens - toks0
        dsecs = sch.decode_seconds - secs0
        times = sch.completed[done0:]
        snap, total = sch.metrics(), sch.stats.slot_total_steps - total0
        left = sch.debug_requests()
        traced = traced_request(sch, prompts[1])
        prof = profile_window(torch, sch, prompts)
    finally:
        sch.close()
    sch.check_kv()
    cache = sch.cache_
    if cache.free_slots != SLOTS or cache.free_blocks \
            != cache.capacity_blocks:
        raise SystemExit("serve: slots or blocks leaked after close()")
    for p, out in zip(prompts, outs):
        if len(out) != PROMPT + STEPS or out[:PROMPT] != p \
                or not all(0 <= t < VOCAB for t in out[PROMPT:]):
            raise SystemExit("serve: a result is malformed")
    if steps < 1 or launches["paged_attend"] != LAYERS * steps \
            or launches["int8_gemm"] != 3 * LAYERS * steps \
            or variants["split"] != launches["paged_attend"]:
        raise SystemExit("serve: %d decode steps but launches %s, "
                         "paged_attend by kernel %s (want %d and %d per "
                         "step, all paged_attend on the split kernel)"
                         % (steps, launches, variants, LAYERS, 3 * LAYERS))
    ttft = sorted(t for t, _ in times)
    got = {k: snap[k] - snap0[k] for k in (
        "requests_completed", "tokens_generated", "slot_busy_steps",
        "prefill_chunks")}
    want = {"requests_completed": len(outs),
            "tokens_generated": len(outs) * STEPS,
            "slot_busy_steps": dtoks,
            "prefill_chunks": len(outs) * -(-PROMPT // CHUNK)}
    if got != want or not dtoks <= total <= SLOTS * steps or left:
        raise SystemExit("serve: metrics() counted %s over %d slot steps "
                         "(want %s over %d decode steps of at most %d rows),"
                         " %d requests still in flight"
                         % (got, total, want, steps, SLOTS, len(left)))
    if others["matmul"]:
        raise SystemExit("serve: the general matmul launched %d times on "
                         "the serving path" % others["matmul"])
    log(json.dumps({"serve": {
        "requests": len(outs), "prompt": PROMPT, "steps": STEPS,
        "decode_steps": steps, "launches": launches,
        "other_launches": others,
        "paged_attend_launches_by_kernel": variants,
        "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
        "ttft_ms_max": 1e3 * ttft[-1],
        "decode_tokens_per_s": dtoks / dsecs,
        "decode_step_ms": 1e3 * dsecs / steps,
        "wall_s": wall,
        "tokens_per_s": len(outs) * STEPS / wall,
        "metrics": dict(got, slot_steps=total, **{k: snap[k] for k in (
            "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99", "slot_occupancy",
            "goodput_tokens_per_sec", "bucket_padding_efficiency",
            "kv_bytes_per_token")})}}))
    log(json.dumps({"traced_request": traced}))
    log(json.dumps({"profile": prof}))
    log(json.dumps({"tracing_cost": tracing_cost(torch, dev, chain,
                                                 prompts)}))
    numbers = {"ttft_ms_p50": snap["ttft_ms_p50"],
               "decode_tokens_per_s": dtoks / dsecs,
               "device_idle_share": prof["device_idle_share"]}
    return {"launches": launches, "chain": chain, "numbers": numbers}


#: a traced request's phase events, in order (``+``: one or more)
TRACE_ORDER = ("req.queue", "req.admit", "req.prefill_chunk+",
               "req.first_token", "req.step+", "req.retire")


def traced_request(sch, prompt, trace="smoke-trace-1"):
    """One request under a given trace id: its ``req.*`` events, each
    carrying the id (a ``req.step`` in its ``traces`` map), must come
    in TRACE_ORDER on the request's timeline — ordered by when each
    phase began (an event with a ``duration`` ends the phase it
    measures, as ``trace_export`` draws it; the last step's event is
    recorded after the retire it caused).  Returns the names and
    counts."""
    from veles_tpu_torch.logger import events
    out = sch.submit(prompt, STEPS, trace=trace).result(600)
    mine = [ev for ev in list(events.ring) if ev["name"].startswith("req.")
            and (ev.get("trace") == trace
                 or trace in (ev.get("traces") or {}))]
    mine.sort(key=lambda ev: ev["time"] - ev.get("duration", 0.0))
    names = []
    for ev in mine:
        if not names or names[-1] != ev["name"] \
                or ev["name"] not in ("req.prefill_chunk", "req.step"):
            names.append(ev["name"])
    want = [n.rstrip("+") for n in TRACE_ORDER]
    if names != want or len(out) != PROMPT + STEPS:
        raise SystemExit("serve: the traced request's events came as %s, "
                         "not %s" % (names, want))
    counts = {n: sum(1 for ev in mine if ev["name"] == n) for n in want}
    return {"trace": trace, "order": names, "events": counts}


def tracing_cost(torch, dev, chain, prompts, runs=3):
    """The serve phase's configuration with request tracing on and off:
    two schedulers over the same chain, the measured run (8 prompts x
    STEPS) alternated on, off, on, ... ``runs`` times each after a
    warm-up of each.  Returns each arm's median decode-step ms (host
    seconds of the decode steps) and their ratio; no limit is held (the
    host-paced step moves by a quarter between calls)."""
    from veles_tpu_torch.serving import InferenceScheduler
    arms = {}
    for on in (True, False):
        arms[on] = InferenceScheduler(
            chain, max_slots=SLOTS, window=WINDOW, block_size=BLOCK,
            kv_dtype="int8", prefill_chunk=CHUNK, spec=False,
            prefix_cache=False, reqtrace=on, device=dev).start()
    per = {True: [], False: []}
    try:
        for sch in arms.values():
            sch.submit(prompts[0], STEPS).result(600)
        for _ in range(runs):
            for on, sch in arms.items():
                s0, t0 = sch.decode_steps, sch.decode_seconds
                for f in [sch.submit(p, STEPS) for p in prompts]:
                    f.result(600)
                per[on].append(1e3 * (sch.decode_seconds - t0)
                               / (sch.decode_steps - s0))
    finally:
        for sch in arms.values():
            sch.close()
    on, off = (float(numpy.median(per[k])) for k in (True, False))
    return {"decode_step_ms_on": per[True], "decode_step_ms_off": per[False],
            "median_on": on, "median_off": off, "ratio_on_off": on / off}


def profile_window(torch, sch, prompts, steps=8):
    """Where the serving time goes: ``prompts`` for ``steps`` tokens
    each under ``torch.profiler`` (after the measured run, so its cost
    stays out of the serving numbers).  Returns the window's wall
    time, the device's busy time (kernels' self time summed) and idle
    share, the kernels with the most device time, and the port's two
    serving kernels' launches and device ms by kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [sch.submit(p, steps) for p in prompts]
        for f in futs:
            f.result(600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    port = {}
    for e in events:
        name = re.search(r"paged_(?:split|column)_kernel|int8_gemm_kernel",
                         e.key)
        if name:
            n, ms = port.get(name.group(0), (0, 0.0))
            port[name.group(0)] = (n + e.count,
                                   ms + e.self_device_time_total / 1e3)
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_kernels": [[e.key[:60], e.count,
                             e.self_device_time_total / 1e3]
                            for e in top],
            "port_kernels": port}


# -- phase 6b: speculative decoding -------------------------------------------

def spec_chain(torch, dev, pattern=None, steps=SPEC_TRAIN):
    """``bench_spec``'s chain trained on the card through the port's
    trainer: bf16, SGD (SPEC_TRAINER), ``steps`` steps at batch
    SPEC_BATCH over 8 minibatches of WINDOW-long sequences cut from the
    tiled ``pattern`` (default the 12-token ``arange(12)·17``) at
    offsets drawn by ``default_rng(0)``.  Returns the chain, the pattern
    and the losses."""
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.samples.lm import build_lm
    if pattern is None:
        pattern = (numpy.arange(12) * 17 % VOCAB).tolist()
    n = SPEC_BATCH * 8
    tiled = numpy.tile(pattern, WINDOW // len(pattern) + 2)
    data = numpy.stack([
        tiled[o:o + WINDOW]
        for o in numpy.random.default_rng(0).integers(0, len(pattern), n)
    ]).astype(numpy.int32)
    loader = FullBatchLoader(data, None, [0, 0, n], minibatch_size=SPEC_BATCH,
                             seed=0, device=dev)
    lm = build_lm(vocab=VOCAB, dim=DIM, blocks=LAYERS, heads=HEADS,
                  seq=WINDOW, loader=loader, lr_schedule="constant",
                  device=dev, dtype="bfloat16", **SPEC_TRAINER)
    losses = []
    while len(losses) < steps:
        loader.serve_span()
        k = min(len(loader.span_sizes_), steps - len(losses))
        losses += _span_steps(torch, lm.trainer, loader, range(k))
    torch.cuda.synchronize()
    return lm.chain, pattern, [float(x) for x in losses]


#: the scheduler's counters a spec arm reads before and after its run
SPEC_COUNTERS = ("decode_steps", "verify_steps", "decode_tokens",
                 "decode_seconds", "verify_tokens", "spec_drafted_tokens",
                 "spec_accepted_tokens")


def zero_serving_counts():
    """Set the two serving kernels' launch counts to 0."""
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    pa.launches = 0
    pa.variant_launches.update(split=0, column=0)
    gemm.launches = 0


def read_serving_counts():
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    return {"paged_attend": pa.launches,
            "paged_attend_by_kernel": dict(pa.variant_launches),
            "int8_gemm": gemm.launches}


def check_pass_launches(what, passes, launches):
    """Fail unless every model pass (decode or verify) launched
    ``paged_attend`` once per layer, all on its split kernel, and
    ``int8_gemm`` three times per layer."""
    if passes < 1 or launches["paged_attend"] != LAYERS * passes \
            or launches["int8_gemm"] != 3 * LAYERS * passes \
            or launches["paged_attend_by_kernel"]["split"] \
            != launches["paged_attend"]:
        raise SystemExit("%s: %d model passes but launches %s (want %d "
                         "and %d per pass, all paged_attend on the split "
                         "kernel)" % (what, passes, launches, LAYERS,
                                      3 * LAYERS))


def spec_arm(torch, dev, chain, prompt, slots, spec):
    """One arm: a scheduler over the trained chain (int8 KV pools and
    ``int8_decode``, block 16, one-shot prefill, spec_k SPEC_K, spec on
    or off, the prefix cache off so the measured requests repeat the
    warm-up's cold admission) serves one warm-up request, then
    ``slots`` concurrent greedy requests of SPEC_STEPS tokens with the
    kernels' counts zeroed just before and read just after.  Returns the
    streams and the arm's numbers."""
    from veles_tpu_torch.serving import InferenceScheduler
    sch = InferenceScheduler(chain, max_slots=slots, window=WINDOW,
                             max_queue=4 * slots, block_size=BLOCK,
                             kv_dtype="int8", prefill_chunk=0, spec=spec,
                             spec_k=SPEC_K, prefix_cache=False,
                             device=dev).start()
    try:
        sch.submit(prompt, SPEC_STEPS).result(600)
        base = {n: getattr(sch, n) for n in SPEC_COUNTERS}
        torch.cuda.synchronize()
        zero_serving_counts()
        t0 = time.perf_counter()
        futs = [sch.submit(prompt, SPEC_STEPS) for _ in range(slots)]
        outs = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_serving_counts()
        got = {n: getattr(sch, n) - base[n] for n in SPEC_COUNTERS}
    finally:
        sch.close()
    sch.check_kv()
    passes = got["decode_steps"] + got["verify_steps"]
    arm = {"slots": slots, "spec": spec,
           "decode_tokens_per_s": got["decode_tokens"] / got["decode_seconds"],
           "tokens_per_s": sum(len(o) - len(prompt) for o in outs) / wall,
           "decode_steps": got["decode_steps"],
           "verify_steps": got["verify_steps"],
           "drafted_tokens": got["spec_drafted_tokens"],
           "accepted_tokens": got["spec_accepted_tokens"],
           "accept_rate": (got["spec_accepted_tokens"]
                           / got["spec_drafted_tokens"]
                           if got["spec_drafted_tokens"] else None),
           "tokens_per_verify_step": (got["verify_tokens"]
                                      / got["verify_steps"]
                                      if got["verify_steps"] else None),
           "launches": launches, "wall_s": wall}
    log(json.dumps({"spec_arm": arm}))
    for out in outs:
        if len(out) != len(prompt) + SPEC_STEPS \
                or out[:len(prompt)] != prompt \
                or not all(0 <= t < VOCAB for t in out[len(prompt):]):
            raise SystemExit("spec: a result of the %d-slot arm (spec %s) is "
                             "malformed" % (slots, spec))
    check_pass_launches("spec", passes, launches)
    if spec and not (got["verify_steps"] > 0
                     and got["spec_accepted_tokens"] > 0):
        raise SystemExit("spec: the spec-on arm verified %d times and "
                         "accepted %d drafts" % (got["verify_steps"],
                                                 got["spec_accepted_tokens"]))
    return outs, arm


def spec_check(torch, dev):
    """Speculative decoding on the serving path at ``bench_spec``'s
    configuration: the chain trained on the card (:func:`spec_chain`),
    then four arms (:func:`spec_arm`): 1 and 4 slots, spec off and on.
    Each model pass (decode or verify) must launch ``paged_attend`` once
    per layer, all on its split kernel, and ``int8_gemm`` three times;
    the spec-off streams must continue the prompt's pattern (the chain
    learned it); the spec-on arms must verify and accept drafts; and
    their greedy streams must equal the spec-off arms' token for token.
    Returns the kernels' launches over the four measured runs, and the
    trained chain (``int8_decode`` on) and its pattern."""
    t0 = time.perf_counter()
    chain, pattern, losses = spec_chain(torch, dev)
    train_s = time.perf_counter() - t0
    if not all(numpy.isfinite(losses)):
        raise SystemExit("spec: non-finite training losses %s" % losses)
    for u in chain:
        if hasattr(u, "int8_decode"):
            u.int8_decode = True
    prompt = (pattern * 8)[:SPEC_PROMPT]
    learned = [pattern[(SPEC_PROMPT + i) % len(pattern)]
               for i in range(SPEC_STEPS)]
    arms, total = [], {"paged_attend": 0, "int8_gemm": 0}
    for slots in SPEC_SLOTS:
        streams = {}
        for spec in (False, True):
            streams[spec], arm = spec_arm(torch, dev, chain, prompt, slots,
                                          spec)
            arms.append(arm)
            for n in total:
                total[n] += arm["launches"][n]
        for off in streams[False]:
            if off[SPEC_PROMPT:] != learned:
                raise SystemExit(
                    "spec: the trained chain's greedy stream leaves the "
                    "pattern at position %d (losses %s)"
                    % (next(i for i, (a, b) in enumerate(
                        zip(off[SPEC_PROMPT:], learned)) if a != b),
                       losses[::10]))
        for off, on in zip(streams[False], streams[True]):
            if off != on:
                at = next(i for i, (a, b) in enumerate(zip(off, on))
                          if a != b)
                raise SystemExit(
                    "spec: at %d slots the spec-on stream differs from the "
                    "spec-off one first at position %d (%d against %d)"
                    % (slots, at, on[at], off[at]))
    log(json.dumps({"spec": {
        "train_steps": SPEC_TRAIN, "trainer": SPEC_TRAINER,
        "train_s": train_s,
        "losses_first_last": [losses[0], losses[-1]],
        "prompt": SPEC_PROMPT, "steps": SPEC_STEPS, "spec_k": SPEC_K,
        "streams_identical": True, "arms": arms,
        "seconds": time.perf_counter() - t0}}))
    return total, chain, pattern


# -- phase 6c: the request lifecycle ------------------------------------------

def _passes(sch):
    return sch.decode_steps + sch.verify_steps


def _wait_for(cond, what, limit=120.0):
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit("lifecycle: timed out waiting for " + what)
        time.sleep(0.002)


def _check_kv(sch, what):
    """The paged cache's invariant sweep with the trie's residents, and
    every slot free — after each lifecycle event."""
    try:
        sch.check_kv()
    except AssertionError as e:
        raise SystemExit("lifecycle: %s left the KV pool unclean: %s"
                         % (what, e))
    cache = sch.cache_
    if cache.free_slots != cache.max_slots \
            or cache.used_blocks != sch.prefix_cache_blocks_resident:
        raise SystemExit("lifecycle: %s left %d slots and %d blocks held "
                         "(%d resident)" % (
                             what, cache.max_slots - cache.free_slots,
                             cache.used_blocks,
                             sch.prefix_cache_blocks_resident))


def warm_ttft(torch, dev, chain):
    """Part (a), ``bench.py:1118-1150`` on the card: after two warm-ups
    on an unrelated prompt (one cold, one warm), one cold submit of a
    LIFE_PROMPT-token prompt and LIFE_WARM warm resubmits of it, one
    step each, timed on the host from submit to result, then one cold
    (a fresh prompt) and one warm admission under the profiler.  Each
    warm resubmit must hit the prefix cache and prefill only its cold
    tail (55 of the prompt's 56 full blocks match: one block).  The
    chain is
    untrained, so its argmax may sit near a tie that the warm tail's
    other order of sums (over dequantized int8 rows) tips: whether the
    warm tokens equal the cold one is printed, not held (part (c) holds
    stream identity on a trained chain)."""
    from veles_tpu_torch.serving import InferenceScheduler
    rng = numpy.random.default_rng(0)
    long_p, other, fresh = (rng.integers(0, VOCAB, LIFE_PROMPT).tolist()
                            for _ in range(3))
    sch = InferenceScheduler(chain, max_slots=LIFE_SLOTS, window=WINDOW,
                             max_queue=64, block_size=BLOCK,
                             kv_dtype="int8", prefill_chunk=LIFE_CHUNK,
                             prefix_cache=True, device=dev).start()
    try:
        for _ in range(2):
            sch.submit(other, 1, seed=0).result(600)
        hits0, misses0 = sch.prefix_cache_hits, sch.prefix_cache_misses
        work0 = sch.prefill_chunk_tokens
        t0 = time.perf_counter()
        cold_out = sch.submit(long_p, 1, seed=0).result(600)
        cold = (time.perf_counter() - t0) * 1e3
        cold_work = sch.prefill_chunk_tokens - work0
        lat, work, same = [], [], 0
        for i in range(LIFE_WARM):
            w0 = sch.prefill_chunk_tokens
            t0 = time.perf_counter()
            out = sch.submit(long_p, 1, seed=i).result(600)
            lat.append((time.perf_counter() - t0) * 1e3)
            work.append(sch.prefill_chunk_tokens - w0)
            same += out == cold_out
            if len(out) != LIFE_PROMPT + 1 or not 0 <= out[-1] < VOCAB:
                raise SystemExit("lifecycle (a): a warm result is malformed")
        hits = sch.prefix_cache_hits - hits0
        misses = sch.prefix_cache_misses - misses0
        # where each kind of admission spends its time, after the
        # timed runs: a cold one (a fresh prompt) and a warm one
        prof = {"cold": profile_window(torch, sch, [fresh], steps=1),
                "warm": profile_window(torch, sch, [long_p], steps=1)}
    finally:
        sch.close()
    _check_kv(sch, "part (a)")
    p95 = sorted(lat)[max(0, int(len(lat) * 0.95) - 1)]   # as the bench
    out = {"prompt": LIFE_PROMPT, "prefill_chunk": LIFE_CHUNK,
           "cold_ttft_ms": cold, "warm_ttft_ms": lat,
           "warm_ttft_ms_p95": p95, "warm_over_cold": p95 / cold,
           "prefix_cache_hits": hits, "prefix_cache_misses": misses,
           "cold_prefill_chunk_tokens": cold_work,
           "warm_prefill_chunk_tokens": work,
           "warm_tokens_equal_cold": same}
    log(json.dumps({"lifecycle_warm_ttft": out}))
    log(json.dumps({"lifecycle_ttft_profile": prof}))
    if hits != LIFE_WARM or misses != 1 or cold_work != LIFE_PROMPT \
            or any(not 0 < w <= BLOCK for w in work):
        raise SystemExit("lifecycle (a): %d warm hits and %d misses (want "
                         "%d and 1), cold prefill %d tokens, warm prefills "
                         "%s (want <= %d each)" % (hits, misses, LIFE_WARM,
                                                   cold_work, work, BLOCK))
    return out


def peak_streams(torch, dev, chain, prefix):
    """Part (b), ``bench.py:1152-1180``: a pool of SHARED_POOL blocks
    (4 cold requests' budgets) and as many slots; cold, 4 submits with
    the prefix cache off; warm, the trie seeded by one request, then
    SHARED_POOL submits.  Every submit is the same SHARED_PROMPT-token
    prompt for SHARED_STEPS greedy steps; ``active_slots`` is sampled
    every 5 ms from ``metrics()`` (as ``bench.py:1180`` reads it).  The
    kernels' counts are zeroed just before the
    measured submits and read after.  Speculative decoding is off: on
    an untrained chain a degenerate repeating stream would accept
    drafts and finish before the last warm stream joined."""
    from veles_tpu_torch.serving import InferenceScheduler
    shared = numpy.random.default_rng(1).integers(
        0, VOCAB, SHARED_PROMPT).tolist()
    sch = InferenceScheduler(chain, max_slots=SHARED_POOL, window=WINDOW,
                             max_queue=256, block_size=BLOCK,
                             kv_blocks=SHARED_POOL, kv_dtype="int8",
                             prefill_chunk=LIFE_CHUNK, spec=False,
                             shed_block_factor=0, prefix_cache=prefix,
                             device=dev).start()
    try:
        if prefix:
            sch.submit(shared, SHARED_STEPS, seed=0).result(600)
        n = SHARED_POOL if prefix else 4
        passes0 = _passes(sch)
        torch.cuda.synchronize()
        zero_serving_counts()
        futs = [sch.submit(shared, SHARED_STEPS, seed=i) for i in range(n)]
        peak = 0
        while not all(f.done() for f in futs):
            peak = max(peak, sch.metrics()["active_slots"])
            time.sleep(0.005)
        outs = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        launches = read_serving_counts()
        passes = _passes(sch) - passes0
        hits = sch.prefix_cache_hits
    finally:
        sch.close()
    _check_kv(sch, "part (b)")
    if any(len(o) != SHARED_PROMPT + SHARED_STEPS or o[:SHARED_PROMPT]
           != shared or not all(0 <= t < VOCAB for t in o) for o in outs):
        raise SystemExit("lifecycle (b): a result is malformed")
    check_pass_launches("lifecycle (b)", passes, launches)
    return {"peak_streams": peak, "requests": n, "passes": passes,
            "prefix_cache_hits": hits, "launches": launches}


def lifecycle_events(torch, dev, chain, pattern):
    """Part (c), on the spec phase's trained chain (int8 KV,
    ``int8_decode``, spec_k SPEC_K, the prefix cache on): a warm
    resubmit, preempt→resume by a higher class at one slot, cancel and
    deadline mid-decode, drain, and the watchdog over an injected hang.
    Each stream must equal its uninterrupted run and the pool must be
    clean after each event.  Returns the counters of each check."""
    from veles_tpu_torch import faults
    from veles_tpu_torch.serving import (
        DeadlineExceededError, DrainingError, InferenceScheduler,
        RequestCancelledError, SchedulerError)

    def make(slots, **kw):
        return InferenceScheduler(chain, max_slots=slots, window=WINDOW,
                                  block_size=BLOCK, kv_dtype="int8",
                                  prefill_chunk=CHUNK, spec_k=SPEC_K,
                                  device=dev, **kw).start()

    def counters(sch):
        return {n: getattr(sch, n) for n in (
            "prefix_cache_hits", "prefix_cache_misses",
            "prefix_cache_blocks_resident", "prefill_chunk_tokens",
            "requests_expired", "requests_cancelled", "requests_rejected",
            "preempts", "preempt_resumes", "watchdog_trips")}

    prompt = (pattern * 8)[:SPEC_PROMPT]
    other = (pattern * 8)[5:5 + SPEC_PROMPT]
    out = {}
    # warm resubmit: the same greedy stream, one hit
    sch = make(1)
    try:
        cold = sch.submit(prompt, 64).result(600)
        warm = sch.submit(prompt, 64).result(600)
        learned = [pattern[(SPEC_PROMPT + i) % len(pattern)]
                   for i in range(64)]
        if cold != warm or cold[SPEC_PROMPT:] != learned \
                or sch.prefix_cache_hits != 1:
            raise SystemExit("lifecycle (c): the warm resubmit's stream "
                             "differs or left the pattern (%d hits)"
                             % sch.prefix_cache_hits)
        out["warm_resubmit"] = counters(sch)
    finally:
        sch.close()
    _check_kv(sch, "the warm resubmit")
    # preempt→resume: a high-class arrival at one slot evicts the low
    sch = make(1, prefix_cache=False)
    try:
        alone = sch.submit(other, 384).result(600)
    finally:
        sch.close()
    sch = make(1)
    try:
        low = sch.submit(other, 384, priority="low")
        _wait_for(lambda: _passes(sch) >= 2, "the low request to decode")
        high = sch.submit(prompt, 64, priority="high")
        got_high, got_low = high.result(600), low.result(600)
        if got_low != alone or got_high != cold \
                or sch.preempts < 1 or sch.preempt_resumes < 1:
            raise SystemExit("lifecycle (c): preempt→resume: %d preempts, "
                             "%d resumes, resumed stream equal %s, high "
                             "stream equal %s" % (
                                 sch.preempts, sch.preempt_resumes,
                                 got_low == alone, got_high == cold))
        out["preempt_resume"] = counters(sch)
    finally:
        sch.close()
    _check_kv(sch, "preempt→resume")
    # cancel and deadline mid-decode (each step slowed by 10 ms)
    sch = make(2)
    try:
        faults.inject("serving.scheduler.step", "delay", arg=0.01)
        gone = sch.submit(prompt, 896)
        late = sch.submit(other, 896, timeout=0.5)
        _wait_for(lambda: _passes(sch) >= 3, "both requests to decode")
        sch.cancel(gone)
        try:
            gone.result(600)
            raise SystemExit("lifecycle (c): the cancelled request finished")
        except RequestCancelledError:
            pass
        try:
            late.result(600)
            raise SystemExit("lifecycle (c): the late request finished")
        except DeadlineExceededError as e:
            if e.tokens_generated < 1:
                raise SystemExit("lifecycle (c): the deadline expired "
                                 "before any token")
            expired_after = e.tokens_generated
        faults.clear()
        _wait_for(lambda: sch.in_flight == 0, "the reap")
        out["cancel_deadline"] = dict(counters(sch),
                                      tokens_before_expiry=expired_after)
        _check_kv(sch, "cancel and deadline")
    finally:
        faults.clear()
        sch.close()
    # drain: the request in flight completes, a new submit is refused
    sch = make(2)
    try:
        fut = sch.submit(prompt, 64)
        if sch.drain():
            raise SystemExit("lifecycle (c): drained with work in flight")
        try:
            sch.submit(prompt, 8)
            raise SystemExit("lifecycle (c): a submit passed the drain")
        except DrainingError:
            pass
        if fut.result(600) != cold or not sch.drain(timeout=60):
            raise SystemExit("lifecycle (c): the drain lost the request "
                             "in flight")
        out["drain"] = counters(sch)
    finally:
        sch.close()
    _check_kv(sch, "the drain")
    # watchdog: a hung step fails the pending clients, the loop recovers
    sch = make(2, watchdog=LIFE_WATCHDOG)
    try:
        sch.submit(other, 8).result(600)
        faults.load("serving.scheduler.step=hang:%gx1" % LIFE_HANG)
        futs = [sch.submit(prompt, 64, trace="hung-0"),
                sch.submit(other, 64, trace="hung-1")]
        t0 = time.perf_counter()
        for f in futs:
            try:
                f.result(600)
                raise SystemExit("lifecycle (c): a request outlived the "
                                 "hang")
            except SchedulerError as e:
                if "stalled" not in str(e):
                    raise
        failed_after = time.perf_counter() - t0
        # the loop is still held by the hang: its table lists both
        stuck = [r for r in sch.debug_requests()
                 if r["trace"] in ("hung-0", "hung-1")]
        held = time.perf_counter() - t0 < LIFE_HANG
        if len(stuck) != 2 or not held:
            raise SystemExit("lifecycle (c): while the hang held (%s), "
                             "debug_requests() listed %s, not both stuck "
                             "requests" % (held, stuck))
        faults.clear()
        _wait_for(lambda: sch.in_flight == 0, "the watchdog's zombies")
        after = sch.submit(prompt, 64).result(600)
        if failed_after > LIFE_HANG or after != cold \
                or sch.watchdog_trips != 1:
            raise SystemExit("lifecycle (c): watchdog: failed after %.2f s "
                             "(hang %.1f), %d trips, the next stream equal "
                             "%s" % (failed_after, LIFE_HANG,
                                     sch.watchdog_trips, after == cold))
        out["watchdog"] = dict(counters(sch), failed_after_s=failed_after,
                               stuck_rows=[(r["trace"], r["phase"])
                                           for r in stuck])
    finally:
        faults.clear()
        sch.close()
    _check_kv(sch, "the watchdog")
    return out


def lifecycle_check(torch, dev, serve_chain, spec_chain_, pattern):
    """The request lifecycle of the default serving path: parts (a) and
    (b) on the serve phase's untrained chain, part (c) on the spec
    phase's trained one.  Returns part (b)'s warm launches."""
    t0 = time.perf_counter()
    ttft = warm_ttft(torch, dev, serve_chain)
    cold = peak_streams(torch, dev, serve_chain, False)
    warm = peak_streams(torch, dev, serve_chain, True)
    log(json.dumps({"lifecycle_streams": {
        "pool_blocks": SHARED_POOL, "prompt": SHARED_PROMPT,
        "steps": SHARED_STEPS, "cold": cold, "warm": warm}}))
    if warm["peak_streams"] <= cold["peak_streams"]:
        raise SystemExit("lifecycle (b): %d warm streams at peak, not more "
                         "than %d cold" % (warm["peak_streams"],
                                           cold["peak_streams"]))
    t1 = time.perf_counter()
    events = lifecycle_events(torch, dev, spec_chain_, pattern)
    log(json.dumps({"lifecycle_events": events,
                    "events_s": time.perf_counter() - t1,
                    "seconds": time.perf_counter() - t0}))
    total = {n: cold["launches"][n] + warm["launches"][n]
             for n in ("paged_attend", "int8_gemm")}
    return total


# -- phase 6d: the serving surface --------------------------------------------

def zero_all_counts():
    """Set every count the surface phase reads to 0: the two serving
    kernels', the general matmul's and the FlashAttention forward's."""
    from veles_tpu_torch.ops import flash_attention as fa, gemm
    zero_serving_counts()
    gemm.matmul_launches = 0
    fa.launches["flash_attn_fwd"] = 0


def read_all_counts():
    from veles_tpu_torch.ops import flash_attention as fa, gemm
    return dict(read_serving_counts(), matmul=gemm.matmul_launches,
                flash_attn_fwd=fa.launches["flash_attn_fwd"])


def check_no_kernels(what, launches):
    """Fail unless ``launches`` (a :func:`read_all_counts`) holds no
    launch of kernels 1-3 (nor of the general matmul)."""
    if any(launches[n] for n in ("paged_attend", "int8_gemm", "matmul",
                                 "flash_attn_fwd")):
        raise SystemExit("%s: launched %s (want no kernel)"
                         % (what, launches))


def _quantiles(xs):
    xs = sorted(xs)
    if not xs:
        return {"p50": None, "p95": None, "max": None}
    return {"p50": xs[len(xs) // 2],
            "p95": xs[max(0, int(len(xs) * 0.95) - 1)], "max": xs[-1]}


def consume_streams(streams, during=None):
    """Iterate every stream on a thread of its own, stamping each
    token's arrival (``during()``, if given, runs on this thread once
    the consumers are started); returns each stream's arrival stamps
    (``time.perf_counter()``) and its iterated tokens."""
    stamps = [[] for _ in streams]
    toks = [[] for _ in streams]
    errors = []

    def run(i, ts):
        try:
            for tok in ts:
                stamps[i].append(time.perf_counter())
                toks[i].append(tok)
        except Exception as e:  # surfaced below, with the stream's index
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i, ts))
               for i, ts in enumerate(streams)]
    for t in threads:
        t.start()
    if during is not None:
        during()
    for t in threads:
        t.join()
    if errors:
        raise SystemExit("surface: stream %d raised %r" % errors[0])
    return stamps, toks


def token_gaps(stamps, after=None):
    """The gaps between consecutive tokens of each stream, in ms; with
    ``after``, only gaps that start at or after that stamp."""
    return [(b - a) * 1e3 for s in stamps for a, b in zip(s, s[1:])
            if after is None or a >= after]


def stream_arm(torch, dev, chain, prompt, slots, spec, events=False):
    """Part (a), one arm: a scheduler over the spec phase's trained
    chain (as :func:`spec_arm`'s) serves ``slots`` batch requests of
    SURF_STEPS greedy tokens, then the same as streams iterated on
    threads of their own, the kernels' counts zeroed just before the
    streams and read after.  Returns the streams and the arm's
    numbers.  With ``events`` (one slot, spec off) a low-class stream
    is then preempted by a high-class arrival and resumed, and another
    is cancelled mid-way."""
    from veles_tpu_torch.serving import (
        InferenceScheduler, RequestCancelledError)
    sch = InferenceScheduler(chain, max_slots=slots, window=WINDOW,
                             max_queue=4 * slots, block_size=BLOCK,
                             kv_dtype="int8", prefill_chunk=0, spec=spec,
                             spec_k=SPEC_K, prefix_cache=False,
                             device=dev).start()
    try:
        done0 = len(sch.completed)
        t0 = time.perf_counter()
        futs = [sch.submit(prompt, SURF_STEPS) for _ in range(slots)]
        batch = [f.result(600) for f in futs]
        batch_wall = (time.perf_counter() - t0) * 1e3
        batch_ttft = [1e3 * t for t, _ in sch.completed[done0:]]
        passes0 = _passes(sch)
        torch.cuda.synchronize()
        zero_serving_counts()
        t0 = time.perf_counter()
        streams = [sch.submit(prompt, SURF_STEPS, stream=True)
                   for _ in range(slots)]
        stamps, toks = consume_streams(streams)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_serving_counts()
        passes = _passes(sch) - passes0
        for ts, got in zip(streams, toks):
            if got != ts.tokens or ts.result(60) != prompt + got \
                    or prompt + got != batch[0]:
                raise SystemExit("surface (a): at %d slots (spec %s) a "
                                 "stream's tokens differ from its result or "
                                 "the batch reply" % (slots, spec))
        check_pass_launches("surface (a)", passes, launches)
        ev = lifecycle_streams(sch, prompt, batch[0]) if events else None
    finally:
        sch.close()
    sch.check_kv()
    if sch.cache_.free_blocks != sch.cache_.capacity_blocks:
        raise SystemExit("surface (a): blocks held after close()")
    arm = {"slots": slots, "spec": spec, "passes": passes,
           "launches": launches,
           "stream_first_token_ms": _quantiles([(s[0] - t0) * 1e3
                                                for s in stamps]),
           "stream_gap_ms": _quantiles(token_gaps(stamps)),
           "stream_wall_ms": wall,
           "batch_first_token_server_ttft_ms": _quantiles(batch_ttft),
           "batch_reply_ms": batch_wall}
    if ev is not None:
        arm["events"] = ev
    log(json.dumps({"surface_stream_arm": arm}))
    return batch[0], arm


def lifecycle_streams(sch, prompt, alone):
    """On a one-slot spec-off scheduler: a low-class stream is preempted
    by a high-class arrival after 8 tokens and resumes (no token twice:
    its tokens equal its uninterrupted run ``alone``); another stream
    is cancelled after 8 tokens (the pool clean after the reap)."""
    from veles_tpu_torch.serving import RequestCancelledError
    other = prompt[5:] + prompt[:5]
    want_high = sch.submit(other, 16).result(600)
    p0, r0 = sch.preempts, sch.preempt_resumes
    low = sch.submit(prompt, SURF_STEPS, priority="low", stream=True)
    it = iter(low)
    head = [next(it) for _ in range(8)]
    high = sch.submit(other, 16, priority="high")
    rest = list(it)
    got_high = high.result(600)
    if prompt + head + rest != alone or got_high != want_high \
            or sch.preempts - p0 != 1 or sch.preempt_resumes - r0 != 1:
        raise SystemExit("surface (a): preempt→resume of a stream: %d "
                         "preempts, %d resumes, stream equal %s, high "
                         "equal %s" % (sch.preempts - p0,
                                       sch.preempt_resumes - r0,
                                       prompt + head + rest == alone,
                                       got_high == want_high))
    gone = sch.submit(prompt, SURF_STEPS, stream=True)
    it = iter(gone)
    head = [next(it) for _ in range(8)]
    gone.cancel()
    try:
        for _ in it:
            pass
        raise SystemExit("surface (a): the cancelled stream ran to its end")
    except RequestCancelledError:
        pass
    _wait_for(lambda: sch.in_flight == 0, "the cancelled stream's reap")
    try:
        sch.check_kv()
    except AssertionError as e:
        raise SystemExit("surface (a): the cancel left the pool unclean: %s"
                         % e)
    cache = sch.cache_
    if cache.free_blocks != cache.capacity_blocks \
            or cache.free_slots != cache.max_slots:
        raise SystemExit("surface (a): the cancel left blocks or slots held")
    return {"preempts": 1, "resumed_stream_equal": True,
            "cancelled_after_tokens": len(gone.tokens),
            "cancel_pool_clean": True}


def streams_check(torch, dev, chain, pattern):
    """Part (a): the four arms; every stream must equal its batch reply
    and the spec phase's learned pattern.  Returns the spec-off 1-slot
    stream (prompt + SURF_STEPS tokens) and the arms' launches."""
    prompt = (pattern * 8)[:SPEC_PROMPT]
    learned = [pattern[(SPEC_PROMPT + i) % len(pattern)]
               for i in range(SURF_STEPS)]
    total, ref = {"paged_attend": 0, "int8_gemm": 0}, None
    for slots in SPEC_SLOTS:
        for spec in (False, True):
            out, arm = stream_arm(torch, dev, chain, prompt, slots, spec,
                                  events=slots == 1 and not spec)
            ref = ref or out
            if out != ref or out[SPEC_PROMPT:] != learned:
                raise SystemExit("surface (a): the %d-slot arm (spec %s) "
                                 "streamed another stream than the pattern"
                                 % (slots, spec))
            for n in total:
                total[n] += arm["launches"][n]
    return ref, total


def aux_check(torch, dev, chain):
    """Part (b), on the serve phase's chain: AUX_ROWS embed and score
    rows of AUX_LEN tokens, first called directly on the card (the
    reference values, each job's ms, no kernel launch), then as
    ``submit_embed``/``submit_score`` jobs on an idle scheduler (no
    kernel launch) and while AUX_STREAMS streams decode, joining once
    every stream is active: every result must equal the direct one
    within 1e-5 and every embedding's norm be 1 within 1e-5.  The
    streams' gaps are read from the moment every stream had its first
    token (before that, prefill chunks sit between the steps), with
    the jobs and in a run without them.  Each job delays one boundary,
    which every stream sees: the first stream's two largest gaps with
    the jobs, less its p50 gap without them, are the delays the two
    jobs add."""
    from veles_tpu_torch.serving import InferenceScheduler
    from veles_tpu_torch.serving.openai_api import (
        pooled_embeddings, score_rows)
    rng = numpy.random.default_rng(5)
    rows = [rng.integers(0, VOCAB, AUX_LEN).tolist()
            for _ in range(AUX_ROWS)]
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist()
               for _ in range(AUX_STREAMS)]
    pooled_embeddings(chain, rows, WINDOW)          # warm-up
    score_rows(chain, rows, WINDOW)
    torch.cuda.synchronize()
    zero_all_counts()
    ms = {}
    t0 = time.perf_counter()
    want_e = numpy.asarray(pooled_embeddings(chain, rows, WINDOW))
    ms["embed"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want_s = score_rows(chain, rows, WINDOW)
    ms["score"] = (time.perf_counter() - t0) * 1e3
    check_no_kernels("surface (b): the direct embed/score", read_all_counts())

    def held(what, e, s):
        e = numpy.asarray(e)
        errs = (float(numpy.abs(e - want_e).max()),
                float(numpy.abs(s - want_s).max()),
                float(numpy.abs(numpy.linalg.norm(e, axis=-1) - 1).max()))
        if e.shape != (AUX_ROWS, DIM) or s.shape != (AUX_ROWS, VOCAB) \
                or not all(numpy.isfinite(x) for x in errs) \
                or max(errs) > 1e-5:
            raise SystemExit("surface (b): %s: embed err %g, score err %g, "
                             "|norm - 1| %g" % ((what,) + errs))
        return errs

    sch = InferenceScheduler(chain, max_slots=AUX_STREAMS, window=WINDOW,
                             block_size=BLOCK, kv_dtype="int8",
                             prefill_chunk=CHUNK, spec=False,
                             prefix_cache=False, device=dev).start()
    try:
        sch.submit(prompts[0], 4).result(600)
        torch.cuda.synchronize()
        zero_all_counts()
        alone = (sch.submit_embed(rows).result(600),
                 sch.submit_score(rows).result(600))
        torch.cuda.synchronize()
        check_no_kernels("surface (b): the aux jobs", read_all_counts())
        errs = held("jobs alone", *alone)
        runs = {}
        for with_aux in (False, True):
            streams = [sch.submit(p, SURF_STEPS, stream=True)
                       for p in prompts]
            jobs = []

            def join_jobs():
                # the jobs join once every stream decodes
                _wait_for(lambda: sch.active_slots == AUX_STREAMS,
                          "the streams")
                jobs.extend([sch.submit_embed(rows), sch.submit_score(rows)])

            stamps, _ = consume_streams(streams,
                                        join_jobs if with_aux else None)
            if jobs:
                errs = tuple(map(max, errs, held(
                    "jobs beside streams", *(j.result(600) for j in jobs))))
            after = max(s[0] for s in stamps)
            runs[with_aux] = (sorted(token_gaps(stamps, after)),
                              sorted(token_gaps(stamps[:1], after)))
    finally:
        sch.close()
    sch.check_kv()
    first = _quantiles(runs[False][1])
    out = {"rows": AUX_ROWS, "row_tokens": AUX_LEN, "job_ms": ms,
           "max_err": errs, "streams": AUX_STREAMS,
           "steady_gap_ms_without_jobs": _quantiles(runs[False][0]),
           "steady_gap_ms_with_jobs": _quantiles(runs[True][0]),
           "first_stream_largest_gaps_with_jobs_ms": runs[True][1][-2:],
           "decode_step_delay_ms": [g - first["p50"]
                                    for g in runs[True][1][-2:]]}
    log(json.dumps({"surface_aux": out}))
    return out


def generate_check(torch, dev, chain, pattern, served):
    """Part (c), on the spec phase's trained chain: greedy ``generate``
    of GEN_STEPS tokens after the pattern prompt at batch 1 and
    GEN_BATCH, rescan and kv (each after a short warm-up, the counts
    zeroed just before and read after): every rescan step launches the
    FlashAttention forward once per layer and nothing else of kernels
    1-3, the kv form none; every row equals the scheduler's spec-off
    stream ``served``.  Then a var-length batch (GEN_LENS, both forms
    equal, each row continuing its pattern), a stop token, and
    ``generate_beam`` at BEAM (beam 1 = greedy, beam 0's score = its
    teacher-forced re-score on the kv path within 1e-3, no kernel
    launch; the full forward's re-score is printed beside it).  Returns the rescan launches and the numbers."""
    from veles_tpu_torch.models.generate import (
        _chain_logits, _chain_step, _fill_caches, _init_caches, generate,
        generate_beam)
    prompt = (pattern * 8)[:SPEC_PROMPT]
    want = served[:SPEC_PROMPT + GEN_STEPS]
    out, flash = {}, 0

    def timed(what, fn, flash_want, steps, tokens, warm=False):
        if warm:
            fn(2)
        torch.cuda.synchronize()
        zero_all_counts()
        t0 = time.perf_counter()
        res = fn(steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_all_counts()
        if flash_want:
            if launches["flash_attn_fwd"] != flash_want \
                    or any(launches[n] for n in ("paged_attend",
                                                 "int8_gemm", "matmul")):
                raise SystemExit("surface (c): %s launched %s (want %d "
                                 "flash_attn_fwd and nothing else)"
                                 % (what, launches, flash_want))
        else:
            check_no_kernels("surface (c): " + what, launches)
        out[what] = {"tokens_per_s": tokens / dt, "ms": dt * 1e3,
                     "flash_attn_fwd": launches["flash_attn_fwd"]}
        return res, launches["flash_attn_fwd"]

    for b in (1, GEN_BATCH):
        for kv in (False, True):
            what = "%s_batch%d" % ("kv" if kv else "rescan", b)
            toks, n = timed(what, lambda s: generate(
                chain, [prompt] * b, s, kv_cache=kv).cpu(),
                0 if kv else LAYERS * GEN_STEPS, GEN_STEPS, b * GEN_STEPS,
                warm=b == 1)
            flash += n
            if any(row != want for row in toks.tolist()):
                raise SystemExit("surface (c): %s differs from the "
                                 "scheduler's stream" % what)
    offs = numpy.arange(len(GEN_LENS)) * 5 % len(pattern)
    width = max(GEN_LENS)
    var = numpy.zeros((len(GEN_LENS), width), numpy.int64)
    for n, (o, ln) in enumerate(zip(offs, GEN_LENS)):
        var[n, :ln] = (pattern * 12)[o:o + ln]
    total = width + GEN_STEPS
    forms = {}
    for kv in (False, True):
        forms[kv], n = timed(
            "varlen_%s" % ("kv" if kv else "rescan"),
            lambda s: generate(chain, var, s, kv_cache=kv,
                               prompt_lens=GEN_LENS).cpu(),
            0 if kv else LAYERS * (total - min(GEN_LENS)), GEN_STEPS,
            sum(total - ln for ln in GEN_LENS))
        flash += n
    for n, (o, ln) in enumerate(zip(offs, GEN_LENS)):
        cont = [pattern[(o + ln + i) % len(pattern)]
                for i in range(total - ln)]
        if forms[False][n].tolist() != forms[True][n].tolist() \
                or forms[True][n, ln:].tolist() != cont:
            raise SystemExit("surface (c): var-length row %d (prompt %d): "
                             "forms equal %s" % (n, ln, forms[False][n]
                                                 .tolist() == forms[True][n]
                                                 .tolist()))
    stop = want[SPEC_PROMPT + 10]
    got = generate(chain, [prompt], GEN_STEPS, kv_cache=True,
                   stop_token=stop)[0, SPEC_PROMPT:].tolist()
    first = want[SPEC_PROMPT:].index(stop)
    if got != want[SPEC_PROMPT:SPEC_PROMPT + first + 1] \
            + [stop] * (GEN_STEPS - first - 1):
        raise SystemExit("surface (c): the stop token did not freeze the "
                         "row at its first generation")
    (beams, scores), _ = timed(
        "beam%d" % BEAM, lambda s: generate_beam(chain, [prompt], s, BEAM),
        0, GEN_STEPS, BEAM * GEN_STEPS)
    one, _ = generate_beam(chain, [prompt], GEN_STEPS, 1)
    best = beams[0, :1]
    span = range(SPEC_PROMPT - 1, SPEC_PROMPT - 1 + GEN_STEPS)
    with torch.no_grad():
        # teacher-forced on the kv path (the beam's own arithmetic, so
        # the two agree to the order of the sum), and by the full
        # forward (the FlashAttention kernel in bf16: printed only)
        caches = _init_caches(chain, 1, best.shape[1])
        _fill_caches(chain, best, SPEC_PROMPT, caches)
        kv_lp = sum(float(torch.log_softmax(_chain_step(
            chain, best[:, t:t + 1], t, caches)[0, 0].float(), -1)[
                best[0, t + 1]]) for t in span)
        full = torch.log_softmax(_chain_logits(chain, best).float(), -1)[0]
        full_lp = sum(float(full[t, best[0, t + 1]]) for t in span)
    err = abs(kv_lp - float(scores[0, 0]))
    if one[0, 0].tolist() != want or err > 1e-3 \
            or not torch.isfinite(scores).all() \
            or (scores[0, 1:] > scores[0, :-1] + 1e-6).any():
        raise SystemExit("surface (c): beam 1 equal greedy %s, beam 0 "
                         "score %g against its teacher-forced re-score %g"
                         % (one[0, 0].tolist() == want,
                            float(scores[0, 0]), kv_lp))
    # where a batch-1 step of each form spends its time: 8 steps under
    # the profiler
    out["profile_8_steps"] = {
        name: profile_step(torch, lambda: generate(chain, [prompt], 8,
                                                   kv_cache=kv))
        for name, kv in (("rescan", False), ("kv", True))}
    out["beam"] = {"scores": scores[0].tolist(), "rescore_err": err,
                   "full_forward_rescore_err":
                       abs(full_lp - float(scores[0, 0])),
                   "beam0_is_greedy": beams[0, 0].tolist() == want}
    log(json.dumps({"surface_generate": out}))
    return flash, out


def dense_check(torch, dev, chain, pattern):
    """Part (d): ``kv="dense"`` against the paged layout over fp32
    (compute-dtype) pools on the spec phase's trained chain, its
    ``int8_decode`` off for the part (the dense steps never take the
    int8 path): SLOTS requests of PROMPT-token pattern prompts x STEPS
    greedy steps after one warm-up, the counts zeroed just before and
    read after.  The streams must be equal and the dense run launch
    none of kernels 1-3."""
    from veles_tpu_torch.serving import InferenceScheduler
    blocks = [u for u in chain if hasattr(u, "int8_decode")]
    for u in blocks:
        u.int8_decode = False
    prompts = [(pattern * 16)[o:o + PROMPT] for o in range(SLOTS)]
    runs = {}
    try:
        for kv in ("paged", "dense"):
            sch = InferenceScheduler(chain, max_slots=SLOTS, window=WINDOW,
                                     kv=kv, block_size=BLOCK,
                                     prefill_chunk=CHUNK, spec=False,
                                     prefix_cache=False, device=dev).start()
            try:
                sch.submit(prompts[0], STEPS).result(600)
                steps0, secs0 = sch.decode_steps, sch.decode_seconds
                torch.cuda.synchronize()
                zero_all_counts()
                outs = [f.result(600) for f in
                        [sch.submit(p, STEPS) for p in prompts]]
                torch.cuda.synchronize()
                launches = read_all_counts()
                steps = sch.decode_steps - steps0
                nbytes = sum(t.numel() * t.element_size()
                             for layer in (sch.cache_.caches if kv == "dense"
                                           else sch.cache_.pools).values()
                             for t in layer.values())
            finally:
                sch.close()
            runs[kv] = {"outs": outs, "launches": launches,
                        "decode_steps": steps,
                        "decode_step_ms": 1e3 * (sch.decode_seconds - secs0)
                        / steps, "cache_bytes": nbytes}
    finally:
        for u in blocks:
            u.int8_decode = True
    check_no_kernels("surface (d): the dense run", runs["dense"]["launches"])
    if runs["dense"]["outs"] != runs["paged"]["outs"] or any(
            o[PROMPT:] != [pattern[(i + PROMPT + j) % len(pattern)]
                           for j in range(STEPS)]
            for i, o in enumerate(runs["dense"]["outs"])):
        raise SystemExit("surface (d): the dense streams differ from the "
                         "paged ones or leave the pattern")
    out = {kv: {k: v for k, v in r.items() if k != "outs"}
           for kv, r in runs.items()}
    log(json.dumps({"surface_dense": out}))
    return out


def surface_check(torch, dev, serve_chain, spec_chain_, pattern):
    """Phase 6d, the serving surface: (a) token streams, (b) the aux
    lane, (c) decoding outside the scheduler, (d) the dense layout.
    Returns the launches of kernels 1-3 on the surface paths."""
    t0 = time.perf_counter()
    served, launches = streams_check(torch, dev, spec_chain_, pattern)
    aux_check(torch, dev, serve_chain)
    flash, _ = generate_check(torch, dev, spec_chain_, pattern, served)
    dense_check(torch, dev, spec_chain_, pattern)
    log(json.dumps({"surface_seconds": time.perf_counter() - t0}))
    return dict(launches, flash_attn_fwd=flash)


# -- phase 6e: the REST server ------------------------------------------------

def _http(port, path, body=None, timeout=600):
    """One request to the phase's server: (status, headers, JSON body).
    Error statuses are returned, not raised."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        resp = e
    raw = resp.read()
    code = resp.status if hasattr(resp, "status") else resp.code
    return code, resp.headers, json.loads(raw) if raw.startswith(b"{") \
        else raw


def sse_client(port, path, body):
    """POST ``body`` to an SSE route and read its frames as they arrive:
    returns the perf_counter stamp before sending, each frame's payload
    and arrival stamp, and whether ``data: [DONE]`` ended it."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise SystemExit("rest: %s answered %d: %r"
                             % (path, resp.status, resp.read()))
        frames, done = [], False
        while True:
            line = resp.readline()
            if not line:
                break
            if line.strip() == b"data: [DONE]":
                done = True
                break
            if line.startswith(b"data: "):
                frames.append((time.perf_counter(), json.loads(line[6:])))
    finally:
        conn.close()
    return t0, frames, done


def prometheus(port):
    """``GET /metrics`` parsed: its family names and each sample's value
    (by its name and labels).  Fails on a reply that does not parse."""
    code, headers, text = _http(port, "/metrics")
    if code != 200 or not headers["Content-Type"].startswith("text/plain"):
        raise SystemExit("rest: /metrics answered %d %s"
                         % (code, headers["Content-Type"]))
    families, values = set(), {}
    for line in text.decode().splitlines():
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            values[name] = float(value)
    return families, values


def rest_counts(sch):
    return {"passes": _passes(sch), **read_serving_counts()}


def rest_launches(what, sch, before, launches):
    """Fail unless the serving kernels ran 8 and 24 times per model pass
    of ``sch`` since ``before`` (a :func:`rest_counts`), all split; adds
    them to ``launches``."""
    now = rest_counts(sch)
    passes = now["passes"] - before["passes"]
    got = {"paged_attend": now["paged_attend"] - before["paged_attend"],
           "int8_gemm": now["int8_gemm"] - before["int8_gemm"],
           "paged_attend_by_kernel": {
               k: now["paged_attend_by_kernel"][k]
               - before["paged_attend_by_kernel"][k]
               for k in now["paged_attend_by_kernel"]}}
    check_pass_launches(what, passes, got)
    for n in launches:
        launches[n] += got[n]
    return passes


def rest_check(torch, dev, chain, pattern):
    """Phase 6e: ``veles_tpu_torch.restful_api.RESTfulAPI`` on the spec
    phase's trained chain at the reference's REST defaults (spec on at
    spec_k 4, the prefix cache on, ``prefill_chunk`` 64) with 4 slots,
    int8 KV pools and block 16, on 127.0.0.1.  (a) REST_CLIENTS
    concurrent ``/generate`` clients of the SPEC_PROMPT-token pattern
    prompt x SURF_STEPS greedy steps, each reply equal to the prompt's
    direct ``scheduler_.submit`` result; then one client at a time,
    REST_CLIENTS times, the round trip against the direct submit; (b)
    ``/generate`` and ``/v1/completions`` with ``"stream": true``, the
    frames' tokens equal to the batch reply, the first frame against a
    direct ``TokenStream``'s first token and the gaps; (c)
    ``/v1/embeddings`` and ``/v1/classify`` of AUX_ROWS rows of AUX_LEN
    tokens within 1e-5 of ``pooled_embeddings``/``score_rows`` called
    directly; (d) ``beam`` BEAM over HTTP equal to ``generate_beam`` and
    a second server (``serving=False``) equal to ``generate``; (e)
    ``/serving/metrics`` counting the phase's requests and tokens,
    ``/metrics`` parsing with its ``veles_serving_*`` families and
    ``/healthz`` 200; (f) an SSE client reset mid-stream, the pool clean
    and one more cancel; (g) ``/drain``, then ``/healthz`` and a new
    ``/generate`` 503, and ``stop()`` leaving the port refusing
    connections.  Kernels 1 and 2 must run 8 and 24 times per model pass
    on (a), (b) and (f), all split, and none of kernels 1-3 on (c) and
    (d).  Returns (a), (b) and (f)'s launches."""
    import http.client
    import socket
    import struct
    from veles_tpu_torch.models.generate import generate, generate_beam
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.serving import openai_api
    from veles_tpu_torch.serving.openai_api import (
        pooled_embeddings, score_rows)
    t_phase = time.perf_counter()
    prompt = (pattern * 8)[:SPEC_PROMPT]
    learned = [pattern[(SPEC_PROMPT + i) % len(pattern)]
               for i in range(SURF_STEPS)]
    api = RESTfulAPI(forwards=chain, max_slots=4, serving_kv_dtype="int8",
                     serving_block_size=BLOCK, device=dev)
    api.initialize()
    sch = api.scheduler_
    out, launches = {"port": api.port}, {"paged_attend": 0, "int8_gemm": 0}
    served = {"requests": 0, "tokens": 0}

    def count(tokens):
        served["requests"] += 1
        served["tokens"] += tokens

    try:
        if not (sch.spec and sch.spec_k == 4 and sch.prefix_cache
                and sch.prefill_chunk == 64 and sch.kv_dtype == "int8"):
            raise SystemExit("rest: the server's scheduler is not at the "
                             "REST defaults: %s" % sch.metrics())
        base = sch.metrics()
        prom0 = prometheus(api.port)[1]
        want = sch.submit(prompt, SURF_STEPS).result(600)
        count(SURF_STEPS)
        if want[SPEC_PROMPT:] != learned:
            raise SystemExit("rest: the direct submit leaves the pattern")
        body = {"prompt": prompt, "steps": SURF_STEPS}
        # (a) concurrent clients, then one at a time against the direct
        torch.cuda.synchronize()
        before = rest_counts(sch)
        results = [None] * REST_CLIENTS

        def client(i):
            results[i] = _http(api.port, "/generate", body)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(REST_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        concurrent_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        passes = rest_launches("rest (a)", sch, before, launches)
        if any(r is None or r[0] != 200 or r[2]["tokens"] != want
               for r in results):
            raise SystemExit("rest (a): a concurrent reply differs from the "
                             "direct submit: %s"
                             % [r and (r[0], r[2] == want) for r in results])
        for _ in results:
            count(SURF_STEPS)
        # one at a time, interleaved: the whole request, a one-token
        # request (its prefill and first token, so the server's share is
        # not lost in a long decode's spread) and /healthz (HTTP and JSON
        # alone)
        ms = {k: [] for k in ("generate", "direct", "generate_1",
                              "direct_1", "healthz")}

        def timed(key, fn):
            t0 = time.perf_counter()
            got = fn()
            ms[key].append((time.perf_counter() - t0) * 1e3)
            return got

        short = {"prompt": prompt, "steps": 1}
        before = rest_counts(sch)
        for _ in range(REST_CLIENTS):
            code, _, reply = timed("generate", lambda: _http(
                api.port, "/generate", body))
            again = timed("direct", lambda: sch.submit(
                prompt, SURF_STEPS).result(600))
            if code != 200 or reply["tokens"] != want or again != want:
                raise SystemExit("rest (a): a sequential reply differs")
            count(SURF_STEPS)
            count(SURF_STEPS)
            for _ in range(2):
                code, _, reply = timed("generate_1", lambda: _http(
                    api.port, "/generate", short))
                again = timed("direct_1", lambda: sch.submit(
                    prompt, 1).result(600))
                if code != 200 or reply["tokens"] != want[:SPEC_PROMPT + 1] \
                        or again != reply["tokens"]:
                    raise SystemExit("rest (a): a one-token reply differs")
                count(1)
                count(1)
                if timed("healthz", lambda: _http(api.port,
                                                  "/healthz"))[0] != 200:
                    raise SystemExit("rest (a): /healthz failed")
        torch.cuda.synchronize()
        passes += rest_launches("rest (a) sequential", sch, before, launches)
        q = {k: _quantiles(v) for k, v in ms.items()}
        out["a"] = {"clients": REST_CLIENTS, "steps": SURF_STEPS,
                    "passes": passes, "concurrent_wall_ms": concurrent_ms,
                    "generate_ms": q["generate"],
                    "direct_submit_ms": q["direct"],
                    "overhead_ms_p50": q["generate"]["p50"]
                    - q["direct"]["p50"],
                    "generate_1_token_ms": q["generate_1"],
                    "direct_1_token_ms": q["direct_1"],
                    "overhead_1_token_ms_p50": q["generate_1"]["p50"]
                    - q["direct_1"]["p50"],
                    "healthz_ms": q["healthz"]}
        # (b) SSE at one client, against a direct stream
        before = rest_counts(sch)
        t0 = time.perf_counter()
        ts = sch.submit(prompt, SURF_STEPS, stream=True)
        stamps = []
        for _ in ts:
            stamps.append(time.perf_counter())
        if prompt + ts.tokens != want:
            raise SystemExit("rest (b): the direct stream differs")
        count(SURF_STEPS)
        direct_first = (stamps[0] - t0) * 1e3
        direct_gaps = token_gaps([stamps])
        t0, frames, done = sse_client(api.port, "/generate",
                                      dict(body, stream=True))
        toks = [f["token"] for _, f in frames if "token" in f]
        final = frames[-1][1] if frames else {}
        if not done or prompt + toks != want or final.get("tokens") != want \
                or final.get("usage", {}).get("completion_tokens") \
                != SURF_STEPS:
            raise SystemExit("rest (b): the /generate SSE frames differ from "
                             "the batch reply (done %s)" % done)
        count(SURF_STEPS)
        sse_stamps = [t for t, f in frames if "token" in f]
        c0, cframes, cdone = sse_client(
            api.port, "/v1/completions",
            {"prompt": prompt, "max_tokens": SURF_STEPS, "stream": True})
        ctoks = [t for _, f in cframes for t in f["choices"][0]["tokens"]]
        if not cdone or ctoks != want[SPEC_PROMPT:] \
                or cframes[-1][1]["choices"][0]["finish_reason"] != "length" \
                or cframes[-1][1]["usage"]["completion_tokens"] != SURF_STEPS:
            raise SystemExit("rest (b): the /v1/completions SSE chunks differ "
                             "from the batch reply")
        count(SURF_STEPS)
        code, _, batch = _http(api.port, "/v1/completions",
                               {"prompt": prompt, "max_tokens": SURF_STEPS})
        if code != 200 or batch["choices"][0]["tokens"] \
                != want[SPEC_PROMPT:]:
            raise SystemExit("rest (b): /v1/completions differs")
        count(SURF_STEPS)
        c_stamps = [t for t, f in cframes if f["choices"][0]["tokens"]]
        torch.cuda.synchronize()
        passes = rest_launches("rest (b)", sch, before, launches)
        out["b"] = {"passes": passes,
                    "direct_first_token_ms": direct_first,
                    "sse_first_frame_ms": (sse_stamps[0] - t0) * 1e3,
                    "completions_first_chunk_ms": (c_stamps[0] - c0) * 1e3,
                    "direct_gap_ms": _quantiles(direct_gaps),
                    "sse_gap_ms": _quantiles(token_gaps([sse_stamps])),
                    "completions_gap_ms": _quantiles(token_gaps([c_stamps]))}
        # (c) the aux lane over HTTP, against the direct calls
        rng = numpy.random.default_rng(5)
        rows = [rng.integers(0, VOCAB, AUX_LEN).tolist()
                for _ in range(AUX_ROWS)]
        want_e = numpy.asarray(pooled_embeddings(chain, rows, WINDOW))
        want_s = score_rows(chain, rows, WINDOW)
        torch.cuda.synchronize()
        zero_all_counts()
        ms = {}
        t0 = time.perf_counter()
        code_e, _, emb = _http(api.port, "/v1/embeddings", {"input": rows})
        ms["embeddings"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        code_s, _, cls = _http(api.port, "/v1/classify",
                               {"input": rows, "top": 3})
        ms["classify"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        check_no_kernels("rest (c)", read_all_counts())
        if code_e != 200 or code_s != 200:
            raise SystemExit("rest (c): %d / %d" % (code_e, code_s))
        e = numpy.asarray([d["embedding"] for d in emb["data"]])
        lp = numpy.asarray([d["logprobs"] for d in cls["data"]])
        errs = (float(numpy.abs(e - want_e).max()),
                float(numpy.abs(lp - want_s).max()),
                float(numpy.abs(numpy.linalg.norm(e, axis=-1) - 1).max()))
        if e.shape != (AUX_ROWS, DIM) or lp.shape != (AUX_ROWS, VOCAB) \
                or not all(numpy.isfinite(errs)) or max(errs) > 1e-5:
            raise SystemExit("rest (c): embed err %g, classify err %g, "
                             "|norm - 1| %g" % errs)
        # the replies' shaping and JSON on the host alone (the server's
        # part of each request besides the job)
        for key, fn in (
                ("embeddings_reply",
                 lambda: openai_api.embeddings_reply("m", want_e, rows)),
                ("classify_reply",
                 lambda: openai_api.classify_reply("m", want_s, rows, 3))):
            t0 = time.perf_counter()
            blob = json.dumps(fn()).encode()
            ms[key + "_and_json"] = (time.perf_counter() - t0) * 1e3
            ms[key + "_bytes"] = len(blob)
        out["c"] = {"rows": AUX_ROWS, "row_tokens": AUX_LEN, "ms": ms,
                    "max_err": errs}
        # (d) beam search over HTTP, and the serialized decode
        zero_all_counts()
        t0 = time.perf_counter()
        code, _, beam = _http(api.port, "/generate",
                              {"prompt": prompt, "steps": REST_BEAM_STEPS,
                               "beam": BEAM})
        beam_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        check_no_kernels("rest (d) beam", read_all_counts())
        btoks, bscores = generate_beam(chain, [prompt], REST_BEAM_STEPS, BEAM)
        if code != 200 or beam["beams"] != btoks[0].tolist() \
                or not numpy.allclose(beam["scores"], bscores[0].tolist(),
                                      rtol=0, atol=1e-5):
            raise SystemExit("rest (d): beam %d over HTTP differs from "
                             "generate_beam" % BEAM)
        legacy = RESTfulAPI(forwards=chain, serving=False, device=dev)
        legacy.initialize()
        try:
            zero_all_counts()
            t0 = time.perf_counter()
            code, _, lreply = _http(
                legacy.port, "/generate",
                {"prompt": [prompt, prompt[5:] + prompt[:5]],
                 "steps": REST_BEAM_STEPS})
            legacy_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            check_no_kernels("rest (d) serialized decode", read_all_counts())
        finally:
            legacy.stop()
        gen = generate(chain, [prompt, prompt[5:] + prompt[:5]],
                       REST_BEAM_STEPS, kv_cache=True).cpu().tolist()
        if code != 200 or lreply["tokens"] != gen \
                or lreply["tokens"][0] != want[:SPEC_PROMPT + REST_BEAM_STEPS]:
            raise SystemExit("rest (d): the serialized decode differs from "
                             "generate")
        out["d"] = {"beam": BEAM, "steps": REST_BEAM_STEPS,
                    "beam_ms": beam_ms, "serialized_decode_ms": legacy_ms}
        # (e) the metrics surfaces
        code, _, snap = _http(api.port, "/serving/metrics")
        got = {"requests": snap["requests_completed"]
               - base["requests_completed"],
               "submitted": snap["requests_submitted"]
               - base["requests_submitted"],
               "tokens": snap["tokens_generated"] - base["tokens_generated"]}
        if code != 200 or got != dict(served, submitted=served["requests"]):
            raise SystemExit("rest (e): /serving/metrics counted %s, the "
                             "phase %s" % (got, served))
        families, values = prometheus(api.port)
        # the process-wide counters: every scheduler of the smoke adds
        prom = {"requests": values["veles_serving_requests_completed_total"]
                - prom0["veles_serving_requests_completed_total"],
                "tokens": values["veles_serving_tokens_generated_total"]
                - prom0["veles_serving_tokens_generated_total"]}
        if prom != {"requests": served["requests"],
                    "tokens": served["tokens"]} \
                or not {"veles_serving_requests_completed_total",
                        "veles_serving_tokens_generated_total",
                        "veles_serving_ttft_ms"} <= families:
            raise SystemExit("rest (e): /metrics counted %s, the phase %s "
                             "(%d families)" % (prom, served, len(families)))
        code, _, health = _http(api.port, "/healthz")
        if code != 200 or health["status"] not in ("ok", "degraded"):
            raise SystemExit("rest (e): /healthz %d %s" % (code, health))
        out["e"] = {"counted": got, "families": len(
            [f for f in families if f.startswith("veles_serving_")])}
        # (f) an SSE client resets its socket mid-stream
        cancelled = sch.metrics()["requests_cancelled"]
        before = rest_counts(sch)
        s = socket.create_connection(("127.0.0.1", api.port), timeout=60)
        # a long request, so it is still decoding when the reset lands
        blob = json.dumps({"prompt": prompt, "steps": REST_RESET_STEPS,
                           "stream": True}).encode()
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: "
                  b"application/json\r\nContent-Length: %d\r\n\r\n"
                  % len(blob) + blob)
        got_bytes = b""
        while got_bytes.count(b"data: ") < 8:
            chunk = s.recv(4096)
            if not chunk:
                raise SystemExit("rest (f): the stream ended early")
            got_bytes += chunk
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
        s.close()
        _wait_for(lambda: sch.in_flight == 0, "the reset stream's reap")
        torch.cuda.synchronize()
        passes = rest_launches("rest (f)", sch, before, launches)
        try:
            sch.check_kv()
        except AssertionError as e:
            raise SystemExit("rest (f): the reset left the pool unclean: %s"
                             % e)
        if sch.metrics()["requests_cancelled"] != cancelled + 1:
            raise SystemExit("rest (f): the reset was not counted as a "
                             "cancel")
        out["f"] = {"passes": passes, "frames_before_reset":
                    got_bytes.count(b"data: ")}
        # (g) drain, then stop
        code, _, reply = _http(api.port, "/drain", {})
        hcode, _, health = _http(api.port, "/healthz")
        gcode, gheaders, gen_reply = _http(api.port, "/generate", body)
        if code != 202 or hcode != 503 or health["status"] != "draining" \
                or gcode != 503 or not gen_reply["error"].get("draining") \
                or gheaders["Retry-After"] is None:
            raise SystemExit("rest (g): drain %d, healthz %d %s, generate %d"
                             % (code, hcode, health.get("status"), gcode))
    finally:
        api.stop()
    # The probe comes from 127.0.0.2, an address no client of the phase
    # used: the server's closed connections sit in TIME_WAIT keyed by
    # the clients' 127.0.0.1 source ports, and where the kernel picks
    # source ports at random and keeps TIME_WAIT against RSTs
    # (tcp_rfc1337), a probe from a reused port gets neither a RST nor
    # a SYN-ACK and times out although nothing listens.
    probe = http.client.HTTPConnection(
        "127.0.0.1", out["port"], timeout=5,
        source_address=("127.0.0.2", 0))
    try:
        probe.request("GET", "/healthz")
        probe.getresponse()
        raise SystemExit("rest (g): the stopped server still answers")
    except ConnectionRefusedError:
        pass
    except OSError as e:
        raise SystemExit("rest (g): after stop() %r" % (e,))
    finally:
        probe.close()
    out["g"] = {"drained": reply.get("drained"), "refused_after_stop": True}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"rest": out}))
    return launches


# -- phase 6f: the model drafter and the KV tiers ------------------------------

def zero_tier_counts():
    """Set every count phase 6f reads to 0: the serving kernels' and the
    three FlashAttention kernels'."""
    from veles_tpu_torch.ops import flash_attention as fa
    zero_serving_counts()
    for name in fa.launches:
        fa.launches[name] = 0


def read_tier_counts():
    from veles_tpu_torch.ops import flash_attention as fa
    return dict(read_serving_counts(), **fa.launches)


def _add_counts(total, got):
    for name in total:
        total[name] += got[name]


def orbit_chain(torch, dev):
    """``bench_spec``'s held-out chain: :func:`spec_chain`'s training on
    the single-cycle successor orbit ``default_rng(0).permutation(VOCAB)``
    (within a window no token repeats, so prompt lookup has nothing to
    draft).  The training steps must launch each FlashAttention kernel
    once per layer.  Returns the chain, the orbit, the losses and the
    launches."""
    order = numpy.random.default_rng(0).permutation(VOCAB).astype(numpy.int32)
    zero_tier_counts()
    chain, _, losses = spec_chain(torch, dev, pattern=order.tolist(),
                                  steps=ORBIT_TRAIN)
    launches = read_tier_counts()
    for name in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        if launches[name] != LAYERS * ORBIT_TRAIN:
            raise SystemExit("tiers (a): %d training steps launched %s %d "
                             "times (want %d)" % (ORBIT_TRAIN, name,
                                                  launches[name],
                                                  LAYERS * ORBIT_TRAIN))
    if not all(numpy.isfinite(losses)):
        raise SystemExit("tiers (a): non-finite training losses %s" % losses)
    return chain, order, losses, launches


def draft_head_fit(torch, dev, chain, order):
    """``MedusaDraftHead.from_chain(chain, SPEC_K)`` trained DRAFT_TRAIN
    steps (batch 8, window 32) on the orbit tiled 8 times; its teacher
    forwards must launch the FlashAttention forward once per layer per
    step and nothing of the backward."""
    from veles_tpu_torch.serving import MedusaDraftHead
    t0 = time.perf_counter()
    head = MedusaDraftHead.from_chain(chain, SPEC_K)
    zero_tier_counts()
    losses = head.train(chain, numpy.tile(order, 8), steps=DRAFT_TRAIN,
                        batch=8, window=32)
    torch.cuda.synchronize()
    launches = read_tier_counts()
    if launches["flash_attn_fwd"] != LAYERS * DRAFT_TRAIN \
            or launches["flash_attn_dq"] or launches["flash_attn_dkv"]:
        raise SystemExit("tiers (a): the head's %d teacher forwards "
                         "launched %s" % (DRAFT_TRAIN, launches))
    if not all(numpy.isfinite(losses)):
        raise SystemExit("tiers (a): non-finite head losses")
    return head, {"train_s": time.perf_counter() - t0,
                  "losses_first_last": [losses[0], losses[-1]]}, launches


def drafter_arm(torch, dev, chain, prompt, slots, spec, head=None):
    """One arm of (a): a scheduler over the orbit chain (int8 KV and
    ``int8_decode``, block 16, one-shot prefill, spec_k SPEC_K, the
    prefix cache off) serves a warm-up request, then ``slots``
    concurrent greedy requests of DRAFT_STEPS tokens with the counts
    zeroed just before and read just after.  Every model pass must
    launch ``paged_attend`` once per layer (the ladder's widths stay
    under 16 queries) and ``int8_gemm`` three times.  Returns the
    streams and the arm's numbers."""
    from veles_tpu_torch.serving import InferenceScheduler
    kw = dict(drafter="model", draft_head=head) if head is not None else {}
    sch = InferenceScheduler(chain, max_slots=slots, window=WINDOW,
                             max_queue=4 * slots, block_size=BLOCK,
                             kv_dtype="int8", prefill_chunk=0, spec=spec,
                             spec_k=SPEC_K, prefix_cache=False, device=dev,
                             **kw).start()
    try:
        sch.submit(prompt, DRAFT_STEPS).result(600)
        base = {n: getattr(sch, n) for n in SPEC_COUNTERS}
        widths0 = dict(sch.verify_widths)
        by0 = {d: list(v) for d, v in sch.stats.spec_by_drafter.items()}
        torch.cuda.synchronize()
        zero_tier_counts()
        t0 = time.perf_counter()
        futs = [sch.submit(prompt, DRAFT_STEPS) for _ in range(slots)]
        outs = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_tier_counts()
        got = {n: getattr(sch, n) - base[n] for n in SPEC_COUNTERS}
        widths = {w: n - widths0.get(w, 0)
                  for w, n in sch.verify_widths.items()
                  if n - widths0.get(w, 0)}
        by = {d: [v[0] - by0.get(d, [0, 0])[0], v[1] - by0.get(d, [0, 0])[1]]
              for d, v in sch.stats.spec_by_drafter.items()}
    finally:
        sch.close()
    try:
        sch.check_kv()
    except AssertionError as e:
        raise SystemExit("tiers (a): the pool leaked a block: %s" % e)
    if sch.cache_.free_blocks != sch.cache_.capacity_blocks:
        raise SystemExit("tiers (a): %d blocks held after close"
                         % sch.cache_.used_blocks)
    passes = got["decode_steps"] + got["verify_steps"]
    check_pass_launches("tiers (a)", passes, launches)
    arm = {"slots": slots, "spec": spec,
           "drafter": sch.drafter if spec else None,
           "decode_tokens_per_s": got["decode_tokens"] / got["decode_seconds"],
           "tokens_per_s": sum(len(o) - len(prompt) for o in outs) / wall,
           "decode_steps": got["decode_steps"],
           "verify_steps": got["verify_steps"],
           "tokens_per_verify_pass": (got["verify_tokens"]
                                      / got["verify_steps"]
                                      if got["verify_steps"] else None),
           "accept_rate_by_drafter": {d: (a / n if n else None)
                                      for d, (n, a) in by.items()},
           "drafted_by_drafter": {d: v for d, v in by.items()},
           "verify_widths": widths,
           "paged_attend_launches_by_k1": dict(
               {"1": LAYERS * got["decode_steps"]},
               **{str(w): LAYERS * n for w, n in widths.items()}),
           "launches": launches, "wall_s": wall}
    log(json.dumps({"tiers_drafter_arm": arm}))
    for out in outs:
        if len(out) != len(prompt) + DRAFT_STEPS or out[:len(prompt)] \
                != prompt:
            raise SystemExit("tiers (a): a result is malformed")
    return outs, arm


def decode_gaps(torch, dev, chain, stream, p):
    """Teacher-force ``stream`` (a ``p``-token prompt and its tokens)
    through the decode path at batch 1 (one-shot prefill into int8 KV
    pools, then one ``paged_decode_logits`` step per token): for each
    emitted token, how far its logit lies below the row's largest.  A
    greedy stream's tokens are the argmax (0) on the path that drew
    them; on another path, rounding moves near-ties."""
    from veles_tpu_torch.serving import (
        PagedKVCache, paged_decode_logits, prefill)
    cache = PagedKVCache(chain, 1, WINDOW, block_size=BLOCK,
                         kv_dtype="int8")
    slot = cache.alloc(len(stream))
    width = -(-p // BLOCK) * BLOCK
    caches, last = prefill(chain, numpy.asarray([stream[:p]]), window=width)
    cache.insert(slot, caches, p)
    tables = cache.table_rows([slot], cache.blocks_per_slot)
    gaps = []
    for pos in range(p, len(stream)):
        row = last[0].float()
        gaps.append(float(row.max() - row[stream[pos]]))
        if pos + 1 < len(stream):
            last = paged_decode_logits(chain, cache, [[stream[pos]]], [pos],
                                       tables)
    return gaps


def same_or_near_tie(torch, dev, chain, off, on, p, what):
    """``on`` equals ``off`` (lists of streams), or each stream that
    differs parts from its spec-off twin at a near-tie and stays on
    near-argmax tokens: with int8 KV a verify pass and a decode step
    quantize their K/V rows apart, so a chain with near-ties (one that
    has not learned the orbit) may resolve one differently.  Every
    token of a differing stream must then lie within NEAR_TIE of the
    largest logit of the decode path given its own prefix, which a
    wrongly accepted draft would not.  Returns what was found."""
    parted = []
    for a, b in zip(off, on):
        if a == b:
            continue
        at = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gaps_on = decode_gaps(torch, dev, chain, b, p)
        gaps_off = decode_gaps(torch, dev, chain, a, p)
        worst = max(max(gaps_on), max(gaps_off))
        parted.append({"at": at, "off_gap_there": gaps_off[at - p],
                       "on_gap_there": gaps_on[at - p],
                       "max_gap": worst})
        if worst > NEAR_TIE:
            raise SystemExit("%s: a stream parts from spec off at %d and "
                             "holds a token %.4f below its row's largest "
                             "logit (near-tie bound %.3f)"
                             % (what, at, worst, NEAR_TIE))
    return {"equal": not parted, "parted": parted}


def drafter_part(torch, dev):
    """(a) ``bench_spec``'s held-out arm: the orbit chain trained in bf16
    as the spec phase's, served from a float32 copy of its weights
    (``int8_decode`` on), its draft head trained on that copy, and
    ``orbit[:64]`` served DRAFT_STEPS greedy steps at 1 and 4 slots with
    spec off, n-gram and model drafts; every stream must equal the
    spec-off one or part from it only at a near-tie
    (:func:`same_or_near_tie`: a chain that has not learned the orbit
    holds near-ties that a verify pass and a decode step, or batches of
    1 and 4 rows, resolve apart, in bf16 and in float32 alike).  Returns
    the copy, the orbit and the part's launches."""
    t0 = time.perf_counter()
    trained, order, losses, train_launches = orbit_chain(torch, dev)
    chain = _copy_chain(trained, dev, "float32", int8_decode=True)
    del trained
    head, head_out, head_launches = draft_head_fit(torch, dev, chain, order)
    prompt = order[:SPEC_PROMPT].tolist()
    learned = [int(order[(SPEC_PROMPT + i) % VOCAB])
               for i in range(DRAFT_STEPS)]
    arms, checks, offs = [], {}, {}
    total = {"paged_attend": 0, "int8_gemm": 0}
    for slots in SPEC_SLOTS:
        off, arm = drafter_arm(torch, dev, chain, prompt, slots, False)
        offs[slots] = off
        arms.append(arm)
        _add_counts(total, arm["launches"])
        for spec_arm_, h in (("ngram", None), ("model", head)):
            on, arm = drafter_arm(torch, dev, chain, prompt, slots, True, h)
            arms.append(arm)
            _add_counts(total, arm["launches"])
            checks["%s at %d slots" % (spec_arm_, slots)] = same_or_near_tie(
                torch, dev, chain, off, on, SPEC_PROMPT,
                "tiers (a) %s at %d slots" % (spec_arm_, slots))
    follows = sum(a == b for a, b in zip(off[0][SPEC_PROMPT:], learned))
    log(json.dumps({"tiers_drafter": {
        "train_losses_first_last": [losses[0], losses[-1]],
        "head": head_out, "steps": DRAFT_STEPS,
        "stream_follows_orbit": follows, "against_spec_off": checks,
        "spec_off_1_equals_4_slots": offs[1][0] == offs[4][0],
        "seconds": time.perf_counter() - t0}}))
    total.update({n: train_launches[n] + head_launches[n]
                  for n in ("flash_attn_fwd", "flash_attn_dq",
                            "flash_attn_dkv")})
    return chain, order, total


def _copy_chain(chain, dev, dtype, **block):
    """A chain's weights in a new chain of compute dtype ``dtype`` on
    the card (``block``: the blocks' options)."""
    from veles_tpu_torch.convert import params_from_numpy, params_to_numpy
    from veles_tpu_torch.samples.lm import lm_spec
    return params_from_numpy(lm_spec(VOCAB, DIM, LAYERS, HEADS, **block),
                             params_to_numpy(chain), device=dev, dtype=dtype)


def weights_part(torch, dev, chain, order):
    """(b) ``weight_quant_quality`` on a float32 copy of the orbit chain
    with ``int8_decode`` off (the port refuses it on an int8
    checkpoint): the
    CE delta against 0.05, the weight bytes before and after, then the
    quantized chain served with spec off and on (n-gram), 1 slot, int8
    KV: equal streams, ``paged_attend`` once per layer per pass, no
    ``int8_gemm``."""
    from veles_tpu_torch.serving import (
        InferenceScheduler, per_chip_bytes, weight_quant_quality)
    from veles_tpu_torch.serving.tp import chain_params
    t0 = time.perf_counter()
    copy = _copy_chain(chain, dev, "float32")

    def block_bytes():
        return per_chip_bytes([u.params for u in copy
                               if hasattr(u, "quantize_weights")])

    before = (per_chip_bytes(chain_params(copy)), block_bytes())
    seqs = [order[o:o + QUALITY_LEN].tolist() for o in (0, VOCAB // 8)]
    zero_tier_counts()
    rec = weight_quant_quality(copy, seqs, block_size=BLOCK)
    gate_launches = read_tier_counts()
    after = (per_chip_bytes(chain_params(copy)), block_bytes())
    try:
        copy[1].int8_decode = True
        raise SystemExit("tiers (b): int8_decode was accepted on an int8 "
                         "checkpoint")
    except ValueError:
        pass
    prompt = order[:SPEC_PROMPT].tolist()
    streams, launches = {}, {"paged_attend": 0, "int8_gemm": 0}
    for spec in (False, True):
        sch = InferenceScheduler(copy, max_slots=1, window=WINDOW,
                                 block_size=BLOCK, kv_dtype="int8",
                                 prefill_chunk=0, spec=spec, spec_k=SPEC_K,
                                 prefix_cache=False, device=dev).start()
        try:
            zero_tier_counts()
            streams[spec] = sch.submit(prompt, W8_STEPS).result(600)
            torch.cuda.synchronize()
            got = read_tier_counts()
            passes = _passes(sch)
        finally:
            sch.close()
        sch.check_kv()
        if got["paged_attend"] != LAYERS * passes or got["int8_gemm"] \
                or got["paged_attend_by_kernel"]["split"] \
                != got["paged_attend"]:
            raise SystemExit("tiers (b): %d passes launched %s"
                             % (passes, got))
        _add_counts(launches, got)
    against = same_or_near_tie(torch, dev, copy, [streams[False]],
                               [streams[True]], SPEC_PROMPT, "tiers (b)")
    out = {"record": rec, "bytes_before": before[0],
           "bytes_after": after[0], "block_bytes_before": before[1],
           "block_bytes_after": after[1],
           "block_ratio": after[1] / before[1],
           "gate_launches": gate_launches, "serve_launches": launches,
           "against_spec_off": against, "seconds": time.perf_counter() - t0}
    log(json.dumps({"tiers_weights": out}))
    if gate_launches["paged_attend"] or gate_launches["int8_gemm"]:
        raise SystemExit("tiers (b): the bf16-pool gate launched %s"
                         % gate_launches)
    del copy
    return launches


def quality_part(torch, dev, rate, chain, order):
    """(c) ``kv_quant_quality`` on the orbit chain at block 16 and 32:
    each int8 pass is a verify pass of ``block`` queries per row, so
    ``paged_attend`` must launch ceil(block / 16) times per layer per
    int8 pass (K1 32: fault C6) and ``int8_gemm`` three times per layer
    per pass of both halves; the CE delta must be within 0.05.  Then
    kernel 1 alone at K1 16, 17 and 32, T 64, each result held against
    the plain version, timed as CUDA-graph replays beside its bound and
    SDPA after a gather."""
    from veles_tpu_torch.ops import paged_attend as pa
    from veles_tpu_torch.serving import kv_quant_quality
    t0 = time.perf_counter()
    seqs = [order[o:o + QUALITY_LEN].tolist() for o in (0, VOCAB // 8)]
    records, launches = {}, {"paged_attend": 0, "int8_gemm": 0}
    for bs in (BLOCK, 2 * BLOCK):
        zero_tier_counts()
        rec = kv_quant_quality(chain, seqs, block_size=bs)
        torch.cuda.synchronize()
        got = read_tier_counts()
        passes = sum(len(s) // bs for s in seqs)
        want = (LAYERS * passes * -(-bs // pa.MAX_K1),
                3 * LAYERS * 2 * passes)
        if (got["paged_attend"], got["int8_gemm"]) != want \
                or got["paged_attend_by_kernel"]["split"] \
                != got["paged_attend"]:
            raise SystemExit("tiers (c): the block-%d gate launched %s "
                             "(want %s)" % (bs, got, want))
        if not rec["kv_quant_within_tolerance"]:
            raise SystemExit("tiers (c): block %d CE delta %s over %s"
                             % (bs, rec["kv_quant_ce_delta"],
                                rec["kv_quant_ce_tolerance"]))
        records[bs] = dict(rec, launches=got)
        _add_counts(launches, got)
    rng = numpy.random.default_rng(15)
    deep = WINDOW // BLOCK
    nb = 8 * deep + 1
    wide, err = {}, 0.0
    for k1 in (16, 17, 32):
        args, extra = _attend_inputs(torch, rng, dev, 8, deep, k1, "int8",
                                     nb, WINDOW - 64, WINDOW - k1)
        e = attend_excess(pa.paged_attend(*args, **extra),
                          pa.paged_attend_plain(*args, **extra))
        if e > 1.0:
            raise SystemExit("tiers (c): paged_attend at K1 %d off its plain "
                             "version by %.2fx the tolerance" % (k1, e))
        err = max(err, e)
        wide["K1 %d T %d" % (k1, deep)] = dict(
            _time_attend_at(torch, dev, rng, nb, rate, deep, WINDOW - 64,
                            WINDOW - k1, k1, True),
            launches_per_call=-(-k1 // pa.MAX_K1), excess=e)
    out = {"records": records, "wide": wide,
           "seconds": time.perf_counter() - t0}
    log(json.dumps({"tiers_quality": out}))
    return launches, wide


def _p95(xs):
    return sorted(xs)[int(0.95 * (len(xs) - 1))]


def host_part(torch, dev, chain, pattern):
    """(d) ``bench_tiered_kv``'s scheduler part at the serving width on
    the spec phase's trained chain (int8 KV, ``int8_decode``), the
    prefix cache on, ``kv_host_bytes`` 64 MB and a pool of HOST_POOL
    blocks: HOST_PROBES pattern prompts of HOST_PROMPT tokens served
    cold, then resubmitted while device-resident, then again after two
    long random prompts demote them to the host tier; each request's
    first token (TTFT, submit to the stream's first token) by tier, the
    blocks each host-warm admission promoted and the tokens it
    prefilled.  Every resubmit's stream must equal its cold stream,
    each pass launch the serving kernels, and ``check_kv()`` be
    clean."""
    from veles_tpu_torch.serving import InferenceScheduler
    t0 = time.perf_counter()
    rng = numpy.random.default_rng(21)
    probes = [(pattern * (HOST_PROMPT // len(pattern) + 2))[o:o + HOST_PROMPT]
              for o in range(HOST_PROBES)]
    sch = InferenceScheduler(chain, max_slots=2, window=WINDOW,
                             block_size=BLOCK, kv_blocks=HOST_POOL,
                             kv_dtype="int8", prefill_chunk=CHUNK,
                             spec=False, prefix_cache=True,
                             kv_host_bytes=64 << 20, request_timeout=600.0,
                             device=dev).start()

    def probe(p):
        return _first_token_ms(sch.submit(p, HOST_STEPS, stream=True),
                               time.perf_counter())

    try:
        sch.submit(rng.integers(0, VOCAB, (HOST_PROMPT,)).tolist(),
                   1).result(600)                         # warm-up
        zero_tier_counts()
        p0 = _passes(sch)
        ttft = {"cold": [], "device": [], "host": []}
        promoted, prefilled, cold = [], {"device": [], "host": []}, []
        for p in probes:
            ms, stream = probe(p)
            ttft["cold"].append(ms)
            cold.append(stream)
        for tier in ("device", "host"):
            if tier == "host":
                for _ in range(2):
                    sch.submit(rng.integers(0, VOCAB, (HOST_LONG,)).tolist(),
                               HOST_STEPS).result(600)
                demoted = sch.metrics().get("kv_host_blocks", 0)
            for p, want in zip(probes, cold):
                before = sch.metrics()
                ms, got = probe(p)
                after = sch.metrics()
                ttft[tier].append(ms)
                prefilled[tier].append(after["prefill_chunk_tokens"]
                                       - before["prefill_chunk_tokens"])
                if tier == "host":
                    promoted.append(after["kv_host_promotions"]
                                    - before["kv_host_promotions"])
                if got != want:
                    raise SystemExit("tiers (d): a %s-resident resubmit's "
                                     "stream differs from its cold one"
                                     % tier)
        torch.cuda.synchronize()
        launches = read_tier_counts()
        check_pass_launches("tiers (d)", _passes(sch) - p0, launches)
        snap = sch.metrics()
        sch.check_kv()
    finally:
        sch.close()
    sch.check_kv()
    if not demoted or snap["kv_host_promotions"] < 1:
        raise SystemExit("tiers (d): %d host blocks, %d promotions"
                         % (demoted, snap["kv_host_promotions"]))
    out = {"ttft_ms": {k: {"p50": float(numpy.median(v)), "p95": _p95(v),
                           "all": v} for k, v in ttft.items()},
           "promoted_per_probe": promoted,
           "prefill_tokens_per_probe": prefilled,
           "host_blocks_after_churn": demoted,
           "promotions": snap["kv_host_promotions"],
           "demotions": snap["kv_host_demotions"],
           "host_evictions": snap["kv_host_evictions"],
           "prefix_hits": snap["prefix_cache_hits"],
           "streams_equal": True, "launches": launches,
           "seconds": time.perf_counter() - t0}
    log(json.dumps({"tiers_host": out}))
    return launches


def _mbps(nbytes, fn, reps=5):
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return nbytes * reps / (time.perf_counter() - t) / 1e6, out


def _first_token_ms(ts, t0):
    next(iter(ts))
    ms = (time.perf_counter() - t0) * 1e3
    return ms, ts.future.result(600)


def disagg_part(torch, dev, chain, pattern):
    """(e) ``bench.py``'s disaggregated arm at the serving width on the
    spec phase's trained chain (int8 KV, ``int8_decode``): a
    ``role="prefill"`` and a ``role="decode"`` scheduler in one process
    hand a prompt off through ``submit_prefill`` → ``kv_export`` → the
    b64 JSON or the VKV1 wire → ``submit_imported``, then two
    ``RESTfulAPI`` servers through ``/serving/prefill`` →
    ``/serving/kv_export/<h>`` → ``/serving/kv_import``; each stream must
    equal a colocated scheduler's.  The wire's encode and decode MB/s,
    and the first token against the colocated one (p50 of DISAGG_REPS)."""
    import urllib.request
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.serving import InferenceScheduler, disagg
    t0 = time.perf_counter()
    prompt = (pattern * (DISAGG_PROMPT // len(pattern) + 1))[:DISAGG_PROMPT]
    kw = dict(max_slots=2, window=WINDOW, block_size=BLOCK, kv_dtype="int8",
              prefill_chunk=CHUNK, spec=False, prefix_cache=False,
              device=dev)
    colo = InferenceScheduler(chain, **kw).start()
    pre = InferenceScheduler(chain, role="prefill", **kw).start()
    dec = InferenceScheduler(chain, role="decode", **kw).start()
    scheds = (colo, pre, dec)
    launches = {"paged_attend": 0, "int8_gemm": 0}
    forms = {"json": (lambda r: json.dumps(disagg.encode_export(r)).encode(),
                      lambda b: disagg.decode_export(json.loads(b))),
             "binary": (disagg.encode_export_binary,
                        lambda b: disagg.decode_export_binary(b)[0])}
    try:
        want = colo.submit(prompt, DISAGG_STEPS).result(600)   # warm-up
        h = pre.submit_prefill(prompt).result(600)
        dec.submit_imported(pre.kv_export(h["handle"]),
                            DISAGG_STEPS).result(600)
        torch.cuda.synchronize()
        zero_tier_counts()
        p0 = sum(_passes(s) for s in scheds)
        ttft = {"colocated": [], "json": [], "binary": []}
        wire = {}
        for _ in range(DISAGG_REPS):
            ms, got = _first_token_ms(colo.submit(prompt, DISAGG_STEPS,
                                                  stream=True),
                                      time.perf_counter())
            ttft["colocated"].append(ms)
            if got != want:
                raise SystemExit("tiers (e): the colocated stream moved")
            for form, (enc, dec_) in forms.items():
                t = time.perf_counter()
                h = pre.submit_prefill(prompt).result(600)
                rec = pre.kv_export(h["handle"])
                back = dec_(enc(rec))
                ms, got = _first_token_ms(
                    dec.submit_imported(back, DISAGG_STEPS, stream=True), t)
                ttft[form].append(ms)
                if got != want:
                    raise SystemExit("tiers (e): the %s handoff's stream "
                                     "differs from the colocated one" % form)
        for form, (enc, dec_) in forms.items():
            nbytes = disagg.record_nbytes(rec)
            e_mbps, blob = _mbps(nbytes, lambda: enc(rec))
            d_mbps, _ = _mbps(nbytes, lambda: dec_(blob))
            wire[form] = {"record_bytes": nbytes, "wire_bytes": len(blob),
                          "encode_mbps": e_mbps, "decode_mbps": d_mbps}
        torch.cuda.synchronize()
        launches = read_tier_counts()
        check_pass_launches("tiers (e)",
                            sum(_passes(s) for s in scheds) - p0, launches)
    finally:
        for s in scheds:
            s.close()
    for s in scheds:
        s.check_kv()
    apis = [RESTfulAPI(forwards=chain, max_slots=2, serving_kv_dtype="int8",
                       serving_block_size=BLOCK, serving_spec=False,
                       serving_prefix_cache=False, serving_role=role,
                       device=dev) for role in ("prefill", "decode")]
    rest = []
    try:
        for api in apis:
            api.initialize()
        for _ in range(2):
            t = time.perf_counter()
            code, _, h = _http(apis[0].port, "/serving/prefill",
                               {"prompt": prompt})
            if code != 200:
                raise SystemExit("tiers (e): /serving/prefill %d %s"
                                 % (code, h))
            req = urllib.request.Request(
                "http://127.0.0.1:%d/serving/kv_export/%s"
                % (apis[0].port, h["handle"]),
                headers={"Accept": disagg.WIRE_CONTENT_TYPE})
            blob = urllib.request.urlopen(req, timeout=600).read()
            rec, _ = disagg.decode_export_binary(blob)
            req = urllib.request.Request(
                "http://127.0.0.1:%d/serving/kv_import" % apis[1].port,
                data=disagg.encode_export_binary(
                    rec, extra={"steps": DISAGG_STEPS}),
                headers={"Content-Type": disagg.WIRE_CONTENT_TYPE})
            got = json.loads(urllib.request.urlopen(req, timeout=600).read())
            rest.append((time.perf_counter() - t) * 1e3)
            if got["tokens"] != want:
                raise SystemExit("tiers (e): the REST handoff's stream "
                                 "differs from the colocated one")
        for api in apis:
            api.scheduler_.check_kv()
    finally:
        for api in apis:
            api.stop()
    out = {"ttft_p50_ms": {k: float(numpy.median(v))
                           for k, v in ttft.items()},
           "wire": wire, "rest_round_trip_ms": rest,
           "streams_equal": True, "launches": launches,
           "seconds": time.perf_counter() - t0}
    log(json.dumps({"tiers_disagg": out}))
    return launches


def tiers_check(torch, dev, rate, spec_chain_, pattern):
    """Phase 6f: (a) the model drafter on the held-out orbit, (b) int8
    weight checkpoints, (c) the KV quality gate and kernel 1 past 16
    queries, (d) the host-RAM tier, (e) disaggregation.  Returns the
    launches of each kernel over the phase's parts and kernel 1's wide
    times."""
    t0 = time.perf_counter()
    chain, order, launches = drafter_part(torch, dev)
    _add_counts(launches, dict(weights_part(torch, dev, chain, order),
                               flash_attn_fwd=0, flash_attn_dq=0,
                               flash_attn_dkv=0))
    got, wide = quality_part(torch, dev, rate, chain, order)
    del chain
    for part in (got, host_part(torch, dev, spec_chain_, pattern),
                 disagg_part(torch, dev, spec_chain_, pattern)):
        _add_counts(launches, dict({"flash_attn_fwd": 0, "flash_attn_dq": 0,
                                    "flash_attn_dkv": 0}, **{
                                        n: part[n] for n in
                                        ("paged_attend", "int8_gemm")}))
    log(json.dumps({"tiers_seconds": time.perf_counter() - t0,
                    "tiers_launches": launches}))
    return launches, wide


# -- phase 6g: MoE serving at full width --------------------------------------

def check_moe_launches(what, passes, launches):
    """Fail unless every model pass (decode or verify) launched
    ``paged_attend`` once per layer, all on its split kernel, and
    ``int8_gemm`` once per layer: ``wo`` alone, since a MoE FFN stays on
    the policy products (the reference's ``_ffn`` returns the MoE result
    before it looks at the int8 path)."""
    if passes < 1 or launches["paged_attend"] != LAYERS * passes \
            or launches["int8_gemm"] != LAYERS * passes \
            or launches["paged_attend_by_kernel"]["split"] \
            != launches["paged_attend"]:
        raise SystemExit("%s: %d model passes but launches %s (want %d of "
                         "each per pass, all paged_attend on the split "
                         "kernel)" % (what, passes, launches, LAYERS))


def moe_arm(torch, dev, chain, prompts, spec, profile=False):
    """One scheduler over the MoE chain (int8 KV pools, ``int8_decode``,
    block 16, chunked prefill, spec_k SPEC_K, the prefix cache off): one
    warm-up request, then ``prompts`` concurrently for STEPS greedy
    tokens each with the kernels' counts zeroed just before and read
    just after; the run's ``metrics()`` must count its requests and
    tokens, every block must come back and ``check_kv()`` pass.
    ``profile`` adds :func:`profile_window` after the measured run.
    Returns the streams and the arm's numbers."""
    from veles_tpu_torch.ops import gemm
    from veles_tpu_torch.serving import InferenceScheduler
    sch = InferenceScheduler(chain, max_slots=SLOTS, window=WINDOW,
                             block_size=BLOCK, kv_dtype="int8",
                             prefill_chunk=CHUNK, spec=spec, spec_k=SPEC_K,
                             prefix_cache=False, device=dev).start()
    try:
        warm = sch.submit(prompts[0], STEPS).result(600)
        if len(warm) != PROMPT + STEPS:
            raise SystemExit("moe serve: warm-up returned %d tokens"
                             % len(warm))
        base = {n: getattr(sch, n) for n in SPEC_COUNTERS}
        snap0, done0 = sch.metrics(), len(sch.completed)
        torch.cuda.synchronize()
        zero_serving_counts()
        gemm.matmul_launches = 0
        t0 = time.perf_counter()
        futs = [sch.submit(p, STEPS) for p in prompts]
        outs = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_serving_counts()
        matmuls = gemm.matmul_launches
        got = {n: getattr(sch, n) - base[n] for n in SPEC_COUNTERS}
        snap, times = sch.metrics(), sch.completed[done0:]
        prof = profile_window(torch, sch, prompts) if profile else None
    finally:
        sch.close()
    sch.check_kv()
    cache = sch.cache_
    if cache.free_slots != SLOTS \
            or cache.free_blocks != cache.capacity_blocks:
        raise SystemExit("moe serve: slots or blocks leaked after close()")
    for p, out in zip(prompts, outs):
        if len(out) != PROMPT + STEPS or out[:PROMPT] != p \
                or not all(0 <= t < VOCAB for t in out[PROMPT:]):
            raise SystemExit("moe serve: a result is malformed")
    passes = got["decode_steps"] + got["verify_steps"]
    check_moe_launches("moe serve (spec %s)" % spec, passes, launches)
    if matmuls:
        raise SystemExit("moe serve: the general matmul launched %d times"
                         % matmuls)
    counted = {k: snap[k] - snap0[k]
               for k in ("requests_completed", "tokens_generated")}
    if counted != {"requests_completed": len(prompts),
                   "tokens_generated": len(prompts) * STEPS}:
        raise SystemExit("moe serve: metrics() counted %s for %d requests "
                         "of %d tokens" % (counted, len(prompts), STEPS))
    ttft = sorted(1e3 * t for t, _ in times)
    arm = {"spec": spec, "requests": len(prompts),
           "ttft_ms_p50": ttft[len(ttft) // 2],
           "decode_tokens_per_s": got["decode_tokens"] / got["decode_seconds"],
           "tokens_per_s": len(prompts) * STEPS / wall, "wall_s": wall,
           "decode_steps": got["decode_steps"],
           "verify_steps": got["verify_steps"],
           "drafted_tokens": got["spec_drafted_tokens"],
           "accepted_tokens": got["spec_accepted_tokens"],
           "launches": launches, "metrics": counted}
    if prof is not None:
        arm["device_idle_share"] = prof["device_idle_share"]
        arm["profile"] = prof
    log(json.dumps({"moe_arm": arm}))
    return outs, arm


def moe_serve_check(torch, dev, dense):
    """Phase 6g: the serve phase's chain (d 1024, 8 heads of 128, vocab
    32768, window 1024, 8 layers, bf16, weights from seed 0) with MoE
    FFNs of MOE_EXPERTS experts, top MOE_TOP_K, hidden 4 * DIM, int8 KV
    pools and ``int8_decode``: 8 concurrent PROMPT-token random prompts
    x STEPS greedy steps, spec off (its TTFT p50, decode tokens/s and the
    device's idle share printed beside the dense serve phase's
    ``dense``), then the spec phase's pattern prompt (8 rotations) spec
    off and on, whose streams must be equal or part at a near-tie
    (:func:`same_or_near_tie`).  The spec arms serve a float32 copy of
    the chain, as phase 6f (a) does: in bfloat16 a verify pass and a
    decode step round a position's hidden state apart, the gate's
    bfloat16 logits can then route a token to another expert, and the
    logits move by more than a near-tie (in this phase's first run on
    the card the bf16 streams parted at position 130 with a token 0.061
    nats below its row's largest logit).  Returns the kernels' launches
    summed over the three measured runs."""
    from veles_tpu_torch.convert import init_params
    t_phase = time.perf_counter()
    spec = [{"type": "embedding", "vocab": VOCAB, "dim": DIM}]
    spec += [{"type": "transformer_block", "heads": HEADS,
              "int8_decode": True, "n_experts": MOE_EXPERTS,
              "top_k": MOE_TOP_K} for _ in range(LAYERS)]
    spec += [{"type": "token_logits", "vocab": VOCAB}]
    chain = init_params(spec, 0, WINDOW, device=dev, dtype="bfloat16")
    n_params = sum(t.numel() for u in chain for t in u.params.values())
    rng = numpy.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(SLOTS)]
    _, arm = moe_arm(torch, dev, chain, prompts, False, profile=True)
    pattern = (numpy.arange(12) * 17 % VOCAB).tolist()
    rotated = [(pattern * (PROMPT // 12 + 2))[o:o + PROMPT]
               for o in range(SLOTS)]
    chain = _copy_chain(chain, dev, "float32", int8_decode=True,
                        n_experts=MOE_EXPERTS, top_k=MOE_TOP_K)
    off, arm_off = moe_arm(torch, dev, chain, rotated, False)
    on, arm_on = moe_arm(torch, dev, chain, rotated, True)
    streams = same_or_near_tie(torch, dev, chain, off, on, PROMPT,
                               "moe serve")
    total = {n: sum(a["launches"][n] for a in (arm, arm_off, arm_on))
             for n in ("paged_attend", "int8_gemm")}
    log(json.dumps({"moe_serve": {
        "experts": MOE_EXPERTS, "top_k": MOE_TOP_K, "parameters": n_params,
        "moe": {k: arm[k] for k in ("ttft_ms_p50", "decode_tokens_per_s",
                                    "device_idle_share")},
        "dense": dense, "spec_streams": streams,
        "seconds": time.perf_counter() - t_phase}}))
    return total


# -- phase 7: train -----------------------------------------------------------

def train_check(torch, dev):
    """The trainer's main path at ``bench_lm``'s configuration; returns
    the attention kernels' launch counts of the timed steps and prints
    the training numbers."""
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.samples.lm import build_lm
    t0 = time.perf_counter()
    n_train = T_BATCH * 8
    toks = numpy.random.default_rng(0).integers(
        0, T_VOCAB, (n_train, T_SEQ)).astype(numpy.int32)
    loader = FullBatchLoader(toks, None, [0, 0, n_train],
                             minibatch_size=T_BATCH, seed=0, device=dev)
    lm = build_lm(vocab=T_VOCAB, dim=T_DIM, blocks=T_LAYERS, heads=T_HEADS,
                  seq=T_SEQ, loader=loader, solver="sgd", learning_rate=0.01,
                  gradient_moment=0.9, lr_schedule="constant", device=dev,
                  dtype="bfloat16")
    gd = lm.trainer
    n_params = sum(t.numel() for u in lm.chain for t in u.params.values())
    log("train: %d parameters, chain and trainer up in %.1f s"
        % (n_params, time.perf_counter() - t0))
    loader.serve_span()
    torch.cuda.reset_peak_memory_stats()
    warm = _span_steps(torch, gd, loader, range(T_WARM))
    torch.cuda.synchronize()
    for name in fa.launches:
        fa.launches[name] = 0
    t0 = time.perf_counter()
    losses = _span_steps(torch, gd, loader, range(T_WARM, T_WARM + T_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in warm + losses]
    if not all(numpy.isfinite(losses)):
        raise SystemExit("train: non-finite losses %s" % losses)
    if launches != dict.fromkeys(launches, T_LAYERS * T_STEPS):
        raise SystemExit("train: %d steps launched %s (want %d of each)"
                         % (T_STEPS, launches, T_LAYERS * T_STEPS))
    k = T_WARM + T_STEPS
    prof = profile_step(torch, lambda: _span_steps(torch, gd, loader,
                                                   range(k, k + 1)))
    log(json.dumps({"train": {
        "steps": T_STEPS, "step_ms": 1e3 * wall / T_STEPS,
        "tokens_per_s": T_STEPS * T_BATCH * T_SEQ / wall,
        "max_memory_allocated_gb": peak / 1e9, "losses": losses,
        "launches": launches, "parameters": n_params}}))
    log(json.dumps({"train_profile": prof}))
    return {"launches": launches}


def profile_step(torch, step):
    """One more training step (``step()``) under ``torch.profiler``:
    wall time, device busy time (kernels' self time summed), idle
    share, top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "top_kernels": [[e.key[:60], e.count,
                             e.self_device_time_total / 1e3]
                            for e in top]}


# -- phase 8: LRN and uniform kernels -----------------------------------------

def lrn_excess(got, want):
    """:func:`flash_excess` with LRN_TOL's limits."""
    tol, floor = LRN_TOL[str(want.dtype).rsplit(".", 1)[-1]]
    got, want = got.float(), want.float()
    lim = tol * (want.abs() + want.square().mean().sqrt()) + floor
    return float(((got - want).abs() / lim).max())


def lrn_faults(mod, x, dy, kw):
    """What the plain versions give for two kernel faults: the forward
    with its window shifted one channel up, and the backward summing
    ``t`` over the forward window instead of its mirror image (the same
    for odd n, another window for even n)."""
    alpha, beta, n, k = kw["alpha"], kw["beta"], kw["n"], kw["k"]
    half = n // 2
    s = k + alpha * mod._window_sum((x * x).float(), half - 1, n - half)
    shifted = (x.float() * mod._power(s, beta)).to(x.dtype)
    s = mod._denominator(x, alpha, n, k)
    p = mod._power(s, beta)
    xf, dyf = x.float(), dy.float()
    t = (dyf * xf * (p / s)).to(x.dtype).float()
    u = mod._window_sum(t, half, n - 1 - half)
    unmirrored = (dyf * p - (2.0 * alpha * beta) * xf * u).to(x.dtype)
    return {"lrn_fwd": ("window shifted by one", shifted),
            "lrn_bwd": ("transposed window not mirrored", unmirrored)}


def lrn_cases():
    """(shape, dtype, n, beta, faults, offset view) of :func:`check_lrn`:
    bf16 at AlexNet's two shapes; f32 at 18 odd ones; the row kernels'
    edges (C 8, 96 and 264 × n 3, 4, 5 and 17 in both types, 429 rows:
    a ragged last warp tile); two offset views for the tile kernels."""
    cases = [(shape, "bfloat16", 5, 0.75, True, False)
             for shape in LRN_SHAPES]
    cases += [((3, 13, 11, c), "float32", n, beta, True, False)
              for c in (7, 96, 256) for n in (3, 4, 5) for beta in (0.5, 0.75)]
    cases += [((3, 13, 11, c), dt, n, 0.75 if n % 2 else 0.5, False, False)
              for dt in ("bfloat16", "float32") for c in LRN_EDGE_C
              for n in (3, 4, 5, 17)]
    cases += [((3, 13, 11, 96), dt, 5, 0.75, False, True)
              for dt in ("bfloat16", "float32")]
    return cases


def lrn_ptxas(report):
    """(kernel, registers, static shared memory, spill stores) of each
    kernel in ``lrn.cu``'s ``-Xptxas -v`` report; the kernel as
    ``lrn_fwd_rows<bf16, R=2>`` from its mangled name."""
    out = []
    for entry in report.split("Compiling entry function '")[1:]:
        mangled = entry.split("'", 1)[0]
        name = re.search(r"lrn_(?:fwd|bwd)_(?:rows|kernel)", mangled)
        reach = re.search(r"Li(\d+)E", mangled)
        label = "%s<%s%s>" % (name.group(0) if name else mangled,
                              "bf16" if "bfloat16" in mangled else "f32",
                              ", R=" + reach.group(1) if reach else "")
        regs = re.search(r"Used (\d+) registers", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        out.append((label, int(regs.group(1)) if regs else -1,
                    int(smem.group(1)) if smem else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def check_lrn(torch, dev, rate):
    """Both LRN kernels against their plain versions at :func:`lrn_cases`,
    each case's ``plan`` logged and held to the variant that launched
    (f32 at 7 channels and the offset views: the tile kernels; every
    aligned C % 8 == 0 case: the row kernels); the planted faults of
    :func:`lrn_faults` must fail the rule where they change the result
    (the shifted window at the bf16 shapes, the unmirrored window at the
    even-n f32 shapes); the backward run twice at AlexNet's first shape
    must be bit-equal.  Then timed at AlexNet's shapes."""
    from veles_tpu_torch.ops import lrn as mod
    gen = torch.Generator(device=dev).manual_seed(8)
    errs = {"lrn_fwd": 0.0, "lrn_bwd": 0.0}
    cases = lrn_cases()
    for shape, dt, n, beta, planted, view in cases:
        dtype = getattr(torch, dt)
        numel = int(numpy.prod(shape))
        if view:        # flat[1:] of a buffer: contiguous, 2 or 4 bytes off
            x = (torch.randn(numel + 1, device=dev, generator=gen)
                 * LRN_SCALE).to(dtype)[1:].view(shape)
        else:
            x = (torch.randn(shape, device=dev, generator=gen)
                 * LRN_SCALE).to(dtype)
        dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
        kw = dict(alpha=1e-4, beta=beta, n=n, k=2.0)
        plan = mod.plan(shape, n, dtype, mod.alignment(x, dy))
        want_kernel = ("tile" if view or shape[-1] % 8 else "rows")
        before = {k: dict(v) for k, v in mod.variant_launches.items()}
        got = {"lrn_fwd": mod.lrn_fwd(x, **kw),
               "lrn_bwd": mod.lrn_bwd(x, dy, **kw)}
        ran = {k: [v for v in mod.variant_launches[k]
                   if mod.variant_launches[k][v] != before[k][v]]
               for k in before}
        if plan["kernel"] != want_kernel or ran != {
                "lrn_fwd": [want_kernel], "lrn_bwd": [want_kernel]}:
            raise SystemExit("lrn: %s %s n=%d%s planned %s and ran %s "
                             "(want %s)" % (shape, dt, n,
                                            " (offset view)" if view else "",
                                            plan, ran, want_kernel))
        want = {"lrn_fwd": mod.lrn_plain(x, **kw),
                "lrn_bwd": mod.lrn_bwd_plain(x, dy, **kw)}
        faults = lrn_faults(mod, x, dy, kw) if planted else {}
        if dt == "float32":
            faults.pop("lrn_fwd", None)
            if n % 2:
                faults.pop("lrn_bwd", None)
        else:
            faults.pop("lrn_bwd", None)
        torch.cuda.synchronize()
        line = []
        for name in got:
            err = float((got[name].float() - want[name].float()).abs().max())
            excess = lrn_excess(got[name], want[name])
            line.append("%s max_abs_err=%.3g (%.3g of the limit)"
                        % (name, err, excess))
            if not excess <= 1.0:
                raise SystemExit("%s disagrees with its plain version at "
                                 "%s %s n=%d beta=%g: %.3g of the limit"
                                 % (name, shape, dt, n, beta, excess))
            errs[name] = max(errs[name], err)
            if name in faults:
                fault, bad = faults[name]
                excess = lrn_excess(bad, want[name])
                line.append("planted fault (%s) %.3g of the limit"
                            % (fault, excess))
                if not excess > 1.0:
                    raise SystemExit("%s: the check passes a planted fault "
                                     "(%s) at %s" % (name, fault, shape))
        log("lrn %s %s n=%d beta=%g%s: plan %s; %s"
            % (shape, dt, n, beta, " offset view" if view else "", plan,
               "; ".join(line)))
        del x, dy, got, want, faults
    x = (torch.randn(LRN_SHAPES[0], device=dev, generator=gen)
         * LRN_SCALE).to(torch.bfloat16)
    dy = torch.randn(LRN_SHAPES[0], device=dev, generator=gen).to(
        torch.bfloat16)
    kw = dict(alpha=1e-4, beta=0.75, n=5, k=2.0)
    if not torch.equal(mod.lrn_bwd(x, dy, **kw), mod.lrn_bwd(x, dy, **kw)):
        raise SystemExit("lrn_bwd: two runs at %s differ" % (LRN_SHAPES[0],))
    del x, dy
    log("lrn: %d cases within LRN_TOL; lrn_bwd bit-equal across two runs"
        % len(cases))
    return time_lrn(torch, dev, rate, errs)


def time_lrn(torch, dev, rate, errs):
    """Each LRN kernel at AlexNet's two shapes (bf16, batch 1024) beside
    its plain version and ``F.local_response_norm`` on the channels-last
    view (alpha scaled by n: torch divides the window sum by its size;
    its backward through autograd).  Times and bounds are per training
    step: both layers' launches summed.  Bounds: each input read once,
    each output written once; a few f32 operations per element."""
    from veles_tpu_torch.ops import lrn as mod
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(9)
    kw = dict(alpha=1e-4, beta=0.75, n=5, k=2.0)
    out = {"lrn_fwd": dict.fromkeys(("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bytes"), 0.0),
           "lrn_bwd": dict.fromkeys(("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bytes"), 0.0)}
    before = dict(mod.launches)
    before_variant = {k: dict(v) for k, v in mod.variant_launches.items()}
    for shape in LRN_SHAPES:
        x = (torch.randn(shape, device=dev, generator=gen)
             * LRN_SCALE).to(torch.bfloat16)
        dy = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        lx = x.permute(0, 3, 1, 2).requires_grad_(True)
        ly = F.local_response_norm(lx, kw["n"], kw["alpha"] * kw["n"],
                                   kw["beta"], kw["k"])
        ldy = dy.permute(0, 3, 1, 2)

        def lib_fwd():
            with torch.no_grad():
                F.local_response_norm(lx, kw["n"], kw["alpha"] * kw["n"],
                                      kw["beta"], kw["k"])

        def lib_bwd():
            torch.autograd.grad(ly, lx, ldy, retain_graph=True)

        numel, es = x.numel(), x.element_size()
        work = {"lrn_fwd": (2 * numel * es, (kw["n"] + 7) * numel,
                            lambda: mod.lrn_fwd(x, **kw),
                            lambda: mod.lrn_plain(x, **kw), lib_fwd),
                "lrn_bwd": (3 * numel * es, (2 * kw["n"] + 15) * numel,
                            lambda: mod.lrn_bwd(x, dy, **kw),
                            lambda: mod.lrn_bwd_plain(x, dy, **kw), lib_bwd)}
        for name, (nbytes, ops, kernel, plain, library) in work.items():
            b_ms, b_by = bound(nbytes, ops, "float32", rate)
            got = {"ms": time_ms(torch, kernel, reps=10),
                   "plain_ms": time_ms(torch, plain, reps=3),
                   "library_ms": time_ms(torch, library, reps=5),
                   "bound_ms": b_ms, "bytes": nbytes}
            log("%s %s bf16: %.4f ms (bound %.4f ms by %s, plain %.3f ms, "
                "library %.3f ms)" % (name, shape, got["ms"], b_ms, b_by,
                                      got["plain_ms"], got["library_ms"]))
            for key, v in got.items():
                out[name][key] += v
            out[name]["bound_by"] = b_by
        del x, dy, lx, ly, ldy
    mod.launches.update(before)        # timing launches are not the path's
    mod.variant_launches.update(before_variant)
    for name in out:
        out[name]["max_abs_err"] = errs[name]
    return out


def check_uniform(torch, dev, rate):
    """``uniform_fill`` bit-equal to its plain version over 4,000,003
    floats from index 0 and from 2**32 - 10**6 (the count's high word
    turns 1 inside the draw); then timed at a dropout mask's shape
    [1024, 4096] (the fields of the kernels line: the shape the training
    step launches it at) beside the plain version and ``torch.rand``,
    and at the synthetic dataset's shape [4096, 227, 227, 3] beside
    ``torch.rand`` — ``ms`` and ``library_ms`` as CUDA-graph replays,
    the eager loops as ``eager_ms`` and ``library_eager_ms``.
    ``torch.rand`` draws Philox, not this function's Threefry stream.
    Bound: THREEFRY_OPS int32 operations per element against the float
    written."""
    from veles_tpu_torch.ops import random as mod
    from veles_tpu_torch.prng import threefry
    k = threefry.fold_in(threefry.key(42), 3)
    n = 4_000_003
    for offset in (0, 2 ** 32 - 10 ** 6):
        got = mod.uniform_fill(k, (n,), dev, offset=offset)
        want = mod.uniform_plain(k.to(dev), (n,), offset=offset)
        torch.cuda.synchronize()
        same = int((got.view(torch.int32) == want.view(torch.int32)).sum())
        log("uniform_fill n=%d offset=%d: %d of %d floats bit-equal"
            % (n, offset, same, n))
        if same != n:
            raise SystemExit("uniform_fill disagrees with its plain version "
                             "(offset %d)" % offset)
    del got, want
    before = mod.launches
    mask = (A_BATCH, A_FC)
    data = (A_TRAIN, A_SIDE, A_SIDE, 3)

    def fields(shape, plain):
        numel = 1
        for d in shape:
            numel *= d
        b_ms, b_by = bound(4 * numel, THREEFRY_OPS * numel, "int32", rate)

        def fill():
            mod.uniform_fill(k, shape, dev)

        def library():
            torch.rand(shape, device=dev)

        # a launch is ~10 us at the mask's shape, about what the host
        # takes to dispatch one through the wrapper: the device time
        # comes from CUDA-graph replays, the eager loops stay beside it
        out = {"ms": graph_ms(torch, fill, reps=20),
               "library_ms": graph_ms(torch, library, reps=20),
               "eager_ms": time_ms(torch, fill, reps=5),
               "library_eager_ms": time_ms(torch, library, reps=5),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": 4 * numel,
               "ops": THREEFRY_OPS * numel}
        if plain:
            kd = k.to(dev)
            out["plain_ms"] = time_ms(
                torch, lambda: mod.uniform_plain(kd, shape), reps=3)
        return out

    out = fields(mask, True)
    ds = fields(data, False)
    mod.launches = before
    out.update(max_abs_err=0.0, dataset_ms=ds["ms"],
               dataset_library_ms=ds["library_ms"],
               dataset_eager_ms=ds["eager_ms"],
               dataset_library_eager_ms=ds["library_eager_ms"],
               dataset_bound_ms=ds["bound_ms"])
    log("uniform_fill %s: graph-replayed %.4f ms (bound %.4f ms by %s; "
        "torch.rand, another stream, %.4f ms), eager loop %.4f ms "
        "(torch.rand %.4f ms), plain %.3f ms; %s: graph-replayed %.3f ms "
        "(bound %.3f ms by %s, torch.rand %.3f ms), eager loop %.3f ms "
        "(torch.rand %.3f ms)"
        % (mask, out["ms"], out["bound_ms"], out["bound_by"],
           out["library_ms"], out["eager_ms"], out["library_eager_ms"],
           out["plain_ms"], data, ds["ms"], ds["bound_ms"], ds["bound_by"],
           ds["library_ms"], ds["eager_ms"], ds["library_eager_ms"]))
    return {"uniform_fill": out}


# -- phase 9: AlexNet witness -------------------------------------------------

def _record_masks(net):
    """Keep every dropout mask the chain draws (on the host) in a list."""
    import types
    from veles_tpu_torch.models.dropout import DropoutForward
    masks = []

    def mask(self, x, key):
        m = DropoutForward.mask(self, x, key)
        masks.append(m.cpu())
        return m

    for u in net.chain:
        if isinstance(u, DropoutForward):
            u.mask = types.MethodType(mask, u)
    return masks


def alexnet_witness(torch, dev):
    """The narrow AlexNet-shaped chain trains one span of 3 steps on the
    card (kernels) and on the CPU (plain versions) from the same weights
    (seed 3) and trainer seed: the datasets (drawn by ``uniform_fill`` on
    the card) and the six dropout masks must be bit-equal, the loss sum
    of the span within WITNESS_LOSS relative and the weights within
    WITNESS_W."""
    from veles_tpu_torch.convert import params_to_numpy
    from veles_tpu_torch.ops import lrn as lrn_mod, random as rnd
    from veles_tpu_torch.samples.alexnet import build_alexnet
    runs = {}
    for d in (dev, "cpu"):
        launched = (dict(lrn_mod.launches), rnd.launches)
        net = build_alexnet(minibatch_size=W_BATCH, side=W_SIDE,
                            classes=W_CLASSES, n_train=W_TRAIN, n_valid=0,
                            widths=W_WIDTHS, seed=3, device=d,
                            dtype="float32")
        masks = _record_masks(net)
        net.loader.serve_span()
        _, _, health = net.trainer.run_span(net.loader)
        acc = net.trainer.read_epoch_acc()[2]
        runs[str(d)] = dict(
            data=net.loader.dataset_dev.cpu(), masks=masks, acc=acc,
            health=health.cpu().double(), params=params_to_numpy(net.chain),
            launches={n: lrn_mod.launches[n] - launched[0][n]
                      for n in launched[0]})
        runs[str(d)]["launches"]["uniform_fill"] = rnd.launches - launched[1]
    card, cpu = runs[str(dev)], runs["cpu"]
    want = {"lrn_fwd": 6, "lrn_bwd": 6, "uniform_fill": 7}
    if card["launches"] != want or any(cpu["launches"].values()):
        raise SystemExit("witness: launched %s on the card, %s on the CPU "
                         "(want %s and none)" % (card["launches"],
                                                 cpu["launches"], want))
    if not torch.equal(card["data"].view(torch.int16),
                       cpu["data"].view(torch.int16)):
        raise SystemExit("witness: the card's synthetic dataset differs")
    if len(card["masks"]) != 6 or not all(
            torch.equal(a, b) for a, b in zip(card["masks"], cpu["masks"])):
        raise SystemExit("witness: the dropout masks differ")
    loss_err = abs(card["acc"][1] - cpu["acc"][1]) / abs(cpu["acc"][1])
    w_err = max(float(numpy.abs(card["params"][i][n]
                                - cpu["params"][i][n]).max())
                for i in cpu["params"] for n in cpu["params"][i])
    log("witness: datasets and 6 dropout masks bit-equal; span loss sum "
        "%.9g (card) vs %.9g (CPU), %.3g relative; weights max_abs_err="
        "%.3g; health %s vs %s" % (card["acc"][1], cpu["acc"][1], loss_err,
                                    w_err, card["health"].tolist(),
                                    cpu["health"].tolist()))
    if not loss_err <= WITNESS_LOSS or not w_err <= WITNESS_W:
        raise SystemExit("witness: card and CPU training disagree")


# -- phase 10: AlexNet --------------------------------------------------------

def _minibatches(torch, loader, device):
    """(x, labels, size) of the loader's train minibatches, span after
    span."""
    while True:
        loader.serve_span()
        idx = torch.as_tensor(loader.span_indices_).long().to(device)
        idx = idx.clamp(0, loader.dataset_dev.shape[0] - 1)
        for k, size in enumerate(loader.span_sizes_):
            yield (loader.dataset_dev[idx[k]], loader.labels_dev[idx[k]],
                   int(size))


def alexnet_check(torch, dev):
    """``bench_alexnet``'s configuration through ``samples/alexnet.py``:
    the dataset drawn on the card (its first sample held bit-equal to
    the plain draw), 2 warm-up and 5 timed SGD steps
    (``run_minibatch``) with the kernels' counts zeroed just before and
    read just after, then one profiled step.  Returns the counts."""
    from veles_tpu_torch.loader import TRAIN
    from veles_tpu_torch.ops import lrn as lrn_mod, random as rnd
    from veles_tpu_torch.prng import threefry
    from veles_tpu_torch.samples.alexnet import ImagenetLoader, build_alexnet
    torch.cuda.synchronize()
    before = rnd.launches
    t0 = time.perf_counter()
    loader = ImagenetLoader(A_SIDE, A_CLASSES, A_TRAIN, 0,
                            minibatch_size=A_BATCH, device=dev)
    torch.cuda.synchronize()
    synth_ms = 1e3 * (time.perf_counter() - t0)
    ds = loader.dataset_dev
    label = torch.tensor(float(numpy.random.default_rng(42).integers(
        0, A_CLASSES)), dtype=torch.float32, device=dev)
    first = (threefry.uniform(threefry.key(42).to(dev),
                              (1, A_SIDE, A_SIDE, 3))
             + label / A_CLASSES).to(torch.bfloat16)
    if rnd.launches - before != 1 or tuple(ds.shape) != (
            A_TRAIN, A_SIDE, A_SIDE, 3) or ds.dtype != torch.bfloat16 \
            or not torch.equal(ds[:1].view(torch.int16),
                               first.view(torch.int16)):
        raise SystemExit("alexnet: the synthetic dataset is not the plain "
                         "draw's (%d launches, %s %s)"
                         % (rnd.launches - before, tuple(ds.shape), ds.dtype))
    net = build_alexnet(minibatch_size=A_BATCH, side=A_SIDE,
                        classes=A_CLASSES, n_train=A_TRAIN, loader=loader,
                        device=dev, dtype="bfloat16")
    gd = net.trainer
    n_params = sum(t.numel() for u in net.chain for t in u.params.values())
    log("alexnet: %d parameters, dataset %s bf16 drawn in %.1f ms"
        % (n_params, tuple(ds.shape), synth_ms))
    batches = _minibatches(torch, loader, dev)

    def steps(n):
        out = []
        for _ in range(n):
            x, labels, size = next(batches)
            loss, _, health = gd.run_minibatch(x, labels, size, TRAIN)
            out.append((loss, health))
        return out

    torch.cuda.reset_peak_memory_stats()
    warm = steps(T_WARM)
    torch.cuda.synchronize()
    for name in lrn_mod.launches:
        lrn_mod.launches[name] = 0
        lrn_mod.variant_launches[name] = {"rows": 0, "tile": 0}
    rnd.launches = 0
    t0 = time.perf_counter()
    timed = steps(T_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lrn_mod.launches, uniform_fill=rnd.launches)
    variants = {n: dict(v) for n, v in lrn_mod.variant_launches.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(loss) for loss, _ in warm + timed]
    health = timed[-1][1].cpu().tolist()
    if not all(numpy.isfinite(losses)) or not all(numpy.isfinite(health)):
        raise SystemExit("alexnet: non-finite losses %s or health %s"
                         % (losses, health))
    if launches != dict.fromkeys(launches, 2 * T_STEPS):
        raise SystemExit("alexnet: %d steps launched %s (want %d of each)"
                         % (T_STEPS, launches, 2 * T_STEPS))
    if any(v != {"rows": 2 * T_STEPS, "tile": 0} for v in variants.values()):
        raise SystemExit("alexnet: the LRN launches by variant were %s "
                         "(want the row kernels only)" % variants)
    prof = profile_step(torch, lambda: steps(1))
    log(json.dumps({"alexnet": {
        "steps": T_STEPS, "batch": A_BATCH, "step_ms": 1e3 * wall / T_STEPS,
        "samples_per_s": T_STEPS * A_BATCH / wall,
        "max_memory_allocated_gb": peak / 1e9,
        "dataset_synthesis_ms": synth_ms, "losses": losses,
        "health": health,
        "launches_per_step": {n: v / T_STEPS for n, v in launches.items()},
        "lrn_launches_by_variant": variants,
        "parameters": n_params}}))
    log(json.dumps({"alexnet_profile": prof}))
    return {"launches": launches}


# -- phase 10b: the space-to-depth stem and VGG-A -----------------------------

def _zero_conv_counts():
    from veles_tpu_torch.ops import lrn as lrn_mod, random as rnd
    for name in lrn_mod.launches:
        lrn_mod.launches[name] = 0
        lrn_mod.variant_launches[name] = {"rows": 0, "tile": 0}
    rnd.launches = 0


def _read_conv_counts():
    from veles_tpu_torch.ops import lrn as lrn_mod, random as rnd
    return dict(lrn_mod.launches, uniform_fill=rnd.launches)


def s2d_vgg_check(torch, dev):
    """Phase 10b.  (a) AlexNet at full width with the ``space_to_depth=4``
    stem (the flat pre-blocked dataset drawn by ``uniform_fill``) and
    with the plain stem, both built from seed 0 (the same draws: the
    stem's logical weights must be equal), at batch S2D_BATCH: the
    stems' outputs on the same first minibatch within S2D_TOL of the
    largest magnitude, then one SGD step each from there (the same
    dropout keys), the losses within S2D_LOSS_TOL; each build and step
    launches the dataset's fill, ``lrn_fwd`` and ``lrn_bwd`` twice and
    two dropout masks.  (b) VGG-A at full width (side 227, 1000
    classes, minibatch V_BATCH): V_STEPS SGD steps, finite losses, the
    dataset and the two dropout masks per step drawn by ``uniform_fill``
    and no LRN launch; the step time printed.  Returns the launches of
    both parts."""
    from veles_tpu_torch.loader import TRAIN
    from veles_tpu_torch.samples.alexnet import build_alexnet
    t_phase = time.perf_counter()
    kw = dict(minibatch_size=S2D_BATCH, side=A_SIDE, classes=A_CLASSES,
              n_train=S2D_BATCH, device=dev, dtype="bfloat16")
    runs = {}
    want = {"lrn_fwd": 2, "lrn_bwd": 2, "uniform_fill": 3}
    total = dict.fromkeys(want, 0)
    for s2d in (0, 4):
        torch.cuda.synchronize()
        _zero_conv_counts()
        net = build_alexnet(space_to_depth=s2d, **kw)
        x = net.loader.dataset_dev[:S2D_BATCH]
        labels = net.loader.labels_dev[:S2D_BATCH]
        with torch.no_grad():
            stem = net.chain[0].apply(x).float()
        weights = {n: t.detach().clone()
                   for n, t in net.chain[0].params.items()}
        t0 = time.perf_counter()
        loss, _, _ = net.trainer.run_minibatch(x, labels, S2D_BATCH, TRAIN)
        loss = float(loss)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        counts = _read_conv_counts()
        if counts != want:
            raise SystemExit("s2d: the %s stem's build and step launched %s "
                             "(want %s)" % ("blocked" if s2d else "plain",
                                            counts, want))
        for n in total:
            total[n] += counts[n]
        runs[s2d] = (stem, weights, loss, step_ms, tuple(x.shape))
        del net, x
    (stem, weights, loss, ms, shape), (bstem, bweights, bloss, bms, bshape) \
        = runs[0], runs[4]
    same_w = all(torch.equal(weights[n], bweights[n]) for n in weights)
    err = float((bstem - stem).abs().max()) / float(stem.abs().max())
    loss_err = abs(bloss - loss) / abs(loss)
    log(json.dumps({"s2d": {
        "batch": S2D_BATCH, "input": shape, "blocked_input": bshape,
        "stem_weights_equal": same_w, "stem_max_err_rel": err,
        "losses": [loss, bloss], "loss_err_rel": loss_err,
        "first_step_ms": [ms, bms]}}))
    if not same_w or not torch.isfinite(bstem).all() or err > S2D_TOL \
            or not loss_err <= S2D_LOSS_TOL:
        raise SystemExit("s2d: the blocked stem disagrees with the plain one "
                         "(weights equal %s, stem %.3g, loss %.3g)"
                         % (same_w, err, loss_err))
    torch.cuda.synchronize()
    _zero_conv_counts()
    t0 = time.perf_counter()
    net = build_alexnet(model="vgg_a", minibatch_size=V_BATCH, side=A_SIDE,
                        classes=A_CLASSES, n_train=V_BATCH * V_STEPS,
                        device=dev, dtype="bfloat16")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for u in net.chain for t in u.params.values())
    batches = _minibatches(torch, net.loader, dev)
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(V_STEPS):
        x, labels, size = next(batches)
        t0 = time.perf_counter()
        loss, _, _ = net.trainer.run_minibatch(x, labels, size, TRAIN)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = _read_conv_counts()
    peak = torch.cuda.max_memory_allocated()
    want_vgg = {"lrn_fwd": 0, "lrn_bwd": 0, "uniform_fill": 1 + 2 * V_STEPS}
    log(json.dumps({"vgg_a": {
        "side": A_SIDE, "classes": A_CLASSES, "batch": V_BATCH,
        "parameters": n_params, "build_s": build_s, "losses": losses,
        "step_ms": times, "launches": counts,
        "max_memory_allocated_gb": peak / 1e9,
        "seconds": time.perf_counter() - t_phase}}))
    if not all(numpy.isfinite(losses)) or counts != want_vgg:
        raise SystemExit("vgg_a: losses %s, launches %s (want %s)"
                         % (losses, counts, want_vgg))
    del net
    return {n: total[n] + counts[n] for n in total}


# -- phase 11: the layer families ---------------------------------------------

def _close_all(torch, got, want):
    return all(torch.allclose(g.detach().cpu(), w.detach().cpu(),
                              rtol=FAMILY_TOL, atol=FAMILY_TOL)
               for g, w in zip(got, want))


def families_check(torch, dev):
    """Phase 11: the layer families card against CPU in float32 at small
    widths, from the same seeds: forward and parameter gradients of RNN,
    LSTM + ``LastTimestep``, RNN + ``MeanPoolSeq``, a stride-2
    ``Deconv`` and a conv autoencoder (conv, max pooling,
    ``Depooling``, ``Deconv``); the autoencoder's 3 SGD steps under
    ``EvaluatorMSE``; 3 Kohonen steps; 3 RBM CD-1 steps, whose hidden
    samples (the uniform fill on the card, the plain draw on the CPU)
    must be bit-equal.  Everything within FAMILY_TOL.  Returns the
    uniform fill's launches."""
    from veles_tpu_torch.convert import init_params, params_to_numpy
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.models.evaluator import EvaluatorMSE
    from veles_tpu_torch.models.gd import GradientDescent
    from veles_tpu_torch.models.kohonen import KohonenTrainer
    from veles_tpu_torch.models.rbm import BernoulliRBM
    from veles_tpu_torch.ops import random as rnd
    t_phase = time.perf_counter()
    rng = numpy.random.default_rng(11)
    ae = [{"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3},
          {"type": "max_pooling", "kx": 2, "ky": 2},
          {"type": "depooling", "kx": 2, "ky": 2},
          {"type": "deconv", "n_kernels": 3, "kx": 3, "ky": 3,
           "activation": "sigmoid"}]
    seqs = rng.standard_normal((4, 12, 16)).astype(numpy.float32)
    imgs = rng.random((8, 16, 16, 3)).astype(numpy.float32)
    cases = [("rnn", [{"type": "rnn", "hidden": 32}], seqs),
             ("lstm_last", [{"type": "lstm", "hidden": 32},
                            {"type": "last_timestep"}], seqs),
             ("rnn_meanpool", [{"type": "rnn", "hidden": 32},
                               {"type": "mean_pool_seq"}], seqs),
             ("deconv_s2", [{"type": "deconv", "n_kernels": 6, "kx": 4,
                             "ky": 3, "sliding": (2, 2)}], imgs),
             ("conv_ae", ae, imgs)]
    report = {}
    for name, spec, x in cases:
        got = {}
        for d in ("cpu", dev):
            chain = init_params(spec, 7, device=d, dtype="float32",
                                in_shape=x.shape[1:])
            params = [t.requires_grad_(True) for u in chain
                      for t in u.params.values()]
            h = torch.as_tensor(x).to(d)
            for u in chain:
                h = u.apply(h)
            g = torch.as_tensor(numpy.random.default_rng(1).standard_normal(
                tuple(h.shape)).astype(numpy.float32)).to(d)
            (h * g).sum().backward()
            got[str(d)] = [h] + [p.grad for p in params]
        ok = _close_all(torch, got[str(dev)], got["cpu"])
        err = max(float((a.detach().cpu() - b.detach().cpu()).abs().max())
                  for a, b in zip(got[str(dev)], got["cpu"]))
        report[name] = err
        if not ok or not torch.isfinite(got[str(dev)][0]).all():
            raise SystemExit("families: %s disagrees card against CPU "
                             "(max_abs_err %.3g)" % (name, err))
    data = rng.random((24, 16, 16, 3)).astype(numpy.float32)
    trained = {}
    for d in ("cpu", dev):
        chain = init_params(ae, 7, device=d, dtype="float32",
                            in_shape=data.shape[1:])
        loader = FullBatchLoader(data, None, [0, 0, 24], minibatch_size=8,
                                 seed=3, device=d, targets=data)
        gd = GradientDescent(chain, EvaluatorMSE(), solver="sgd",
                             learning_rate=0.5, gradient_moment=0.9)
        loader.serve_span()
        gd.run_span(loader)
        trained[str(d)] = (float(gd.loss), int(gd.global_step),
                           params_to_numpy(chain))
    (c_loss, c_steps, c_p), (k_loss, k_steps, k_p) = (
        trained["cpu"], trained[str(dev)])
    ae_err = max(float(numpy.abs(k_p[i][n] - c_p[i][n]).max())
                 for i in c_p for n in c_p[i])
    report["conv_ae_mse_steps"] = {"losses": [k_loss, c_loss],
                                   "weights_max_abs_err": ae_err}
    if k_steps != c_steps or c_steps != 3 or ae_err > FAMILY_TOL \
            or abs(k_loss - c_loss) > FAMILY_TOL * max(abs(c_loss), 1.0):
        raise SystemExit("families: the MSE autoencoder's steps disagree "
                         "(%s)" % report["conv_ae_mse_steps"])
    maps = [KohonenTrainer(48, shape=(4, 4), seed=3, device=d)
            for d in ("cpu", dev)]
    rbms = [BernoulliRBM(64, hidden=32, learning_rate=0.5, seed=5, device=d)
            for d in ("cpu", dev)]
    torch.cuda.synchronize()
    rnd.launches = 0
    samples_equal = True
    for _ in range(3):
        x = torch.as_tensor(rng.random((16, 48)).astype(numpy.float32))
        v = torch.as_tensor((rng.random((16, 64)) < 0.4).astype(
            numpy.float32))
        q = [m.step(x.to(m.device)) for m in maps]
        for r in rbms:
            r.step(v.to(r.device))
        samples_equal &= torch.equal(rbms[0].samples[0],
                                     rbms[1].samples[0].cpu())
        if not _close_all(torch, [q[1]], [q[0]]):
            raise SystemExit("families: Kohonen quantization errors %s"
                             % [float(t) for t in q])
    launched = rnd.launches
    som_err = float((maps[1].weights.cpu() - maps[0].weights).abs().max())
    rbm_err = float((rbms[1].weights.cpu() - rbms[0].weights).abs().max())
    report.update(kohonen_weights_err=som_err, rbm_weights_err=rbm_err,
                  rbm_samples_equal=samples_equal,
                  uniform_fill_launches=launched,
                  seconds=time.perf_counter() - t_phase)
    log(json.dumps({"families": report}))
    if not samples_equal or launched != 3 or som_err > FAMILY_TOL \
            or rbm_err > FAMILY_TOL:
        raise SystemExit("families: Kohonen or RBM disagree card against "
                         "CPU (%s)" % report)
    return {"uniform_fill": launched}


# -- phase 12: the workflow runtime ---------------------------------------------

def _zero_train_counts():
    from veles_tpu_torch.ops import flash_attention as fa, lrn as lrn_mod
    from veles_tpu_torch.ops import random as rnd
    for mod in (fa, lrn_mod):
        for name in mod.launches:
            mod.launches[name] = 0
    rnd.launches = 0


def _read_train_counts():
    from veles_tpu_torch.ops import flash_attention as fa, lrn as lrn_mod
    from veles_tpu_torch.ops import random as rnd
    return dict(fa.launches, **lrn_mod.launches, uniform_fill=rnd.launches)


def _host_params(chain):
    return [{n: t.detach().float().cpu() for n, t in u.params.items()}
            for u in chain]


def _max_diff(torch, a, b):
    """Per tensor, max |a - b| (lists of name → tensor dicts)."""
    return [{n: float((x[n] - y[n]).abs().max()) for n in x}
            for x, y in zip(a, b)]


def wf_rule(torch, what, got, refs, a, b):
    """``got`` (params, losses) against the runs ``refs``, with the
    direct runs ``a`` and ``b`` as the noise: each tensor and loss
    bit-equal to the nearest ref where ``a`` and ``b`` are bit-equal,
    else within WF_RULE times their difference of it.  Returns the
    largest ratio seen."""
    worst = 0.0
    pa, la = a
    pb, lb = b
    pg, lg = got
    noise = _max_diff(torch, pa, pb)
    diffs = [_max_diff(torch, pg, ref[0]) for ref in refs]
    rows = [(("param", i, n), noise[i][n], min(d[i][n] for d in diffs))
            for i in range(len(pa)) for n in pa[i]]
    rows += [(("loss", k), abs(la[k] - lb[k]),
              min(abs(lg[k] - ref[1][k]) for ref in refs))
             for k in range(len(la))]
    if len(lg) != len(la):
        raise SystemExit("%s: %d losses, the direct runs' %d"
                         % (what, len(lg), len(la)))
    for key, nz, d in rows:
        if nz == 0.0:
            if d != 0.0:
                raise SystemExit("%s: %s differs by %g where the direct "
                                 "runs are bit-equal" % (what, key, d))
            continue
        worst = max(worst, d / nz)
        if d > WF_RULE * nz:
            raise SystemExit("%s: %s differs by %g, more than %g x the "
                             "direct runs' own %g" % (what, key, d,
                                                      WF_RULE, nz))
    return worst


def _losses(history):
    return [row[k] for row in history for k in sorted(row)
            if k.endswith("_loss")]


def _epoch_seconds(t0, runs_per_epoch):
    """Seconds of each epoch since ``t0`` (``time.time()``), from the
    decision's ``unit:DecisionGD`` end events: it runs once per class
    span and reads the epoch accumulator back each time, so its end
    follows the span's device work."""
    from veles_tpu_torch.logger import events
    ends = [e["time"] for e in events.ring
            if e["name"] == "unit:DecisionGD" and e["kind"] == "end"
            and e["time"] >= t0][runs_per_epoch - 1::runs_per_epoch]
    return [b - a for a, b in zip([t0] + ends[:-1], ends)]


def _snapshot_seconds():
    from veles_tpu_torch.logger import events
    begins = [e["time"] for e in events.ring
              if e["name"] == "snapshot" and e["kind"] == "begin"]
    ends = [e["time"] for e in events.ring
            if e["name"] == "snapshot" and e["kind"] == "end"]
    return [e - b for b, e in zip(begins, ends)]


def workflow_alexnet(torch, dev, snapdir):
    """Phase 12 (a); returns the workflow run's launches."""
    import os
    from veles_tpu_torch.samples.alexnet import (
        AlexNetWorkflow, build_alexnet, train_alexnet)
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    direct = []
    for run in range(2):
        torch.cuda.synchronize()
        _zero_train_counts()
        t0 = time.perf_counter()
        net = build_alexnet(minibatch_size=WF_BATCH, side=WF_SIDE,
                            classes=WF_CLASSES, n_train=WF_TRAIN,
                            n_valid=WF_VALID, widths=WF_WIDTHS, device=dev,
                            dtype="bfloat16")
        history = train_alexnet(net, WF_EPOCHS)
        torch.cuda.synchronize()
        direct.append({"wall": time.perf_counter() - t0,
                       "launches": _read_train_counts(),
                       "run": (_host_params(net.chain), _losses(history)),
                       "history": history})
        del net
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    t_build = time.perf_counter()
    wf = AlexNetWorkflow(side=WF_SIDE, classes=WF_CLASSES, widths=WF_WIDTHS,
                         minibatch_size=WF_BATCH, synthetic_train=WF_TRAIN,
                         synthetic_valid=WF_VALID, max_epochs=WF_EPOCHS,
                         snapshot_compression=None,
                         snapshot_time_interval=0.0,
                         snapshotter_config={"directory": snapdir})
    # ungated, every second decision run: the end of epoch 1 (the
    # fourth run ends the workflow before the snapshotter runs again)
    wf.snapshotter.decision = None
    wf.snapshotter.interval = 2
    wf.initialize(device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    t_wall = time.time()
    wf.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    epoch_s = _epoch_seconds(t_wall, 2)
    launches = _read_train_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {n: direct[0]["launches"][n]
            for n in ("lrn_fwd", "lrn_bwd", "uniform_fill")}
    got_l = {n: launches[n] for n in want}
    if got_l != want or direct[1]["launches"] != direct[0]["launches"]:
        raise SystemExit("workflow (alexnet): launches %s, the direct runs' "
                         "%s and %s" % (got_l, direct[0]["launches"],
                                        direct[1]["launches"]))
    run = (_host_params(wf.gd.forwards), _losses(wf.decision.history))
    ratio = wf_rule(torch, "workflow (alexnet)", run,
                    [direct[0]["run"], direct[1]["run"]], direct[0]["run"],
                    direct[1]["run"])
    path = wf.snapshotter.destination
    size_mb = os.path.getsize(path) / 1e6
    snap_s = _snapshot_seconds()
    t0 = time.perf_counter()
    resumed = SnapshotterToFile.import_file(path)
    load_s = time.perf_counter() - t0
    if resumed.gd.global_step != WF_TRAIN // WF_BATCH:
        raise SystemExit("workflow (alexnet): the snapshot is at step %d, "
                         "not the end of epoch 1" % resumed.gd.global_step)
    resumed.snapshotter.directory = os.path.join(snapdir, "resumed")
    resumed.initialize(device=dev)
    resumed.run()
    torch.cuda.synchronize()
    back = (_host_params(resumed.gd.forwards),
            _losses(resumed.decision.history))
    r_ratio = wf_rule(torch, "workflow (alexnet resume)", back, [run],
                      direct[0]["run"], direct[1]["run"])
    resume_diff = max(v for d in _max_diff(torch, back[0], run[0])
                      for v in d.values())
    log(json.dumps({"workflow_alexnet": {
        "epochs": WF_EPOCHS, "batch": WF_BATCH, "train": WF_TRAIN,
        "valid": WF_VALID, "history": wf.decision.history,
        "direct_history": direct[0]["history"],
        "epoch_s": epoch_s,
        "workflow_run_s": t_end - t_run,
        "workflow_with_build_s": t_end - t_build,
        "direct_s": [d["wall"] for d in direct],
        "unit_timers": {u.name: dict(u.timers) for u in wf.units},
        "max_memory_allocated_gb": peak / 1e9,
        "snapshot_mb": size_mb, "snapshot_write_s": snap_s,
        "snapshot_load_s": load_s, "launches": got_l,
        "direct_launches": direct[0]["launches"],
        "rule_ratio": ratio, "resume_rule_ratio": r_ratio,
        "resume_max_abs_diff": resume_diff}}))
    del wf, resumed
    torch.cuda.empty_cache()
    return got_l


def workflow_lm(torch, dev):
    """Phase 12 (b); returns the workflow run's launches."""
    from veles_tpu_torch.loader import FullBatchLoader
    from veles_tpu_torch.samples.lm import LMWorkflow, build_lm, train_lm
    toks = numpy.random.default_rng(0).integers(
        0, T_VOCAB, (WF_LM_TRAIN, T_SEQ)).astype(numpy.int32)
    direct = []
    steps = WF_LM_TRAIN // T_BATCH
    for run in range(2):
        torch.cuda.synchronize()
        _zero_train_counts()
        t0 = time.perf_counter()
        loader = FullBatchLoader(toks, None, [0, 0, WF_LM_TRAIN],
                                 minibatch_size=T_BATCH, device=dev)
        lm = build_lm(vocab=T_VOCAB, dim=T_DIM, blocks=T_LAYERS,
                      heads=T_HEADS, seq=T_SEQ, loader=loader, solver="sgd",
                      learning_rate=0.01, gradient_moment=0.9,
                      lr_schedule="constant", device=dev, dtype="bfloat16")
        history = train_lm(lm, 1)
        torch.cuda.synchronize()
        direct.append({"wall": time.perf_counter() - t0,
                       "launches": _read_train_counts(),
                       "run": (_host_params(lm.chain), _losses(history))})
        del lm, loader
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    t0 = time.perf_counter()
    wf = LMWorkflow(corpus="random", vocab=T_VOCAB, dim=T_DIM,
                    blocks=T_LAYERS, heads=T_HEADS, seq=T_SEQ,
                    synthetic_train=WF_LM_TRAIN, synthetic_valid=0,
                    minibatch_size=T_BATCH, solver="sgd",
                    learning_rate=0.01, gradient_moment=0.9,
                    lr_schedule="constant", max_epochs=1,
                    dtype="bfloat16", snapshotter_config={"enabled": False})
    wf.initialize(device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {n: v for n, v in _read_train_counts().items()
                if n.startswith("flash_attn_")}
    if launches != dict.fromkeys(launches, T_LAYERS * steps) or any(
            {n: d["launches"][n] for n in launches} != launches
            for d in direct):
        raise SystemExit("workflow (lm): %d steps launched %s (want %d of "
                         "each, as the direct runs' %s)"
                         % (steps, launches, T_LAYERS * steps,
                            [d["launches"] for d in direct]))
    run = (_host_params(wf.gd.forwards), _losses(wf.decision.history))
    ratio = wf_rule(torch, "workflow (lm)", run,
                    [direct[0]["run"], direct[1]["run"]], direct[0]["run"],
                    direct[1]["run"])
    log(json.dumps({"workflow_lm": {
        "steps": steps, "history": wf.decision.history,
        "workflow_run_s": t_end - t_run,
        "workflow_with_build_s": t_end - t0,
        "direct_s": [d["wall"] for d in direct],
        "unit_timers": {u.name: dict(u.timers) for u in wf.units},
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "rule_ratio": ratio}}))
    del wf
    torch.cuda.empty_cache()
    return launches


def workflow_small(torch, dev, snapdir):
    """Phase 12 (c); returns the transformer's card-run launches."""
    from veles_tpu_torch.samples.cifar import CifarWorkflow
    from veles_tpu_torch.samples.kohonen import KohonenWorkflow
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    from veles_tpu_torch.samples.transformer import TransformerWorkflow
    snap = {"enabled": False}
    # SGD in place of the CIFAR and transformer samples' Adam: Adam
    # divides a near-zero gradient by its own running RMS, so a rounding-
    # level difference between card and CPU can flip that coordinate's
    # step by 2 lr; SGD's steps differ as the gradients do (the
    # transformer at lr 1e-4: at 0.01 this width diverges on the CPU too)
    sgd = {"solver": "sgd", "learning_rate": 0.01, "gradient_moment": 0.9}
    samples = {
        "mnist": lambda: MnistWorkflow(
            synthetic_train=512, synthetic_valid=128, minibatch_size=128,
            max_epochs=2, dtype="float32", snapshotter_config=snap),
        "cifar": lambda: CifarWorkflow(
            synthetic_train=256, synthetic_valid=128, minibatch_size=128,
            max_epochs=2, dtype="float32", snapshotter_config=snap, **sgd),
        "transformer": lambda: TransformerWorkflow(
            dim=512, heads=4, blocks=2, vocab=16, seq=64,
            synthetic_train=128, synthetic_valid=64, minibatch_size=64,
            max_epochs=2, dtype="float32", snapshotter_config=snap,
            **dict(sgd, learning_rate=1e-4)),
        "kohonen": lambda: KohonenWorkflow(samples=1024, max_epochs=2),
    }
    out, launches = {}, {}
    for name, make in samples.items():
        runs = {}
        for where in ("card", "cpu"):
            wf = make()
            wf.initialize(device=dev if where == "card" else "cpu")
            _zero_train_counts()
            t0 = time.perf_counter()
            wf.run()
            if where == "card":
                torch.cuda.synchronize()
                if name == "transformer":
                    launches = {n: v for n, v in _read_train_counts().items()
                                if n.startswith("flash_attn_")}
            wall = time.perf_counter() - t0
            if name == "kohonen":
                metrics = list(wf.decision.epoch_qerror)
                params = [{"weights": wf.trainer.weights.detach().cpu()}]
            else:
                metrics = _losses(wf.decision.history)
                params = _host_params(wf.gd.forwards)
            runs[where] = (metrics, params, wall)
        (mc, pc, wc), (mh, ph, wh) = runs["card"], runs["cpu"]
        if len(mc) != len(mh) or not mc or not numpy.allclose(
                mc, mh, rtol=WF_SMALL_TOL, atol=WF_SMALL_TOL):
            raise SystemExit("workflow (%s): card metrics %s, CPU %s"
                             % (name, mc, mh))
        worst = max(v for d in _max_diff(torch, pc, ph) for v in d.values())
        scale = max(float(t.abs().max()) for d in ph for t in d.values())
        if worst > WF_SMALL_TOL * max(scale, 1.0):
            raise SystemExit("workflow (%s): weights differ by %g card vs "
                             "CPU (limit %g)" % (name, worst,
                                                 WF_SMALL_TOL * scale))
        out[name] = {"metrics": mc, "max_abs_weight_diff": worst,
                     "card_s": wc, "cpu_s": wh}
    # 2 blocks, 2 epochs: the forward on every minibatch, the backward
    # on the train ones (128 / 64 train and 64 / 64 validation per epoch)
    want = {"flash_attn_fwd": 2 * 2 * (2 + 1), "flash_attn_dq": 2 * 2 * 2,
            "flash_attn_dkv": 2 * 2 * 2}
    if launches != want:
        raise SystemExit("workflow (transformer): FlashAttention launches "
                         "%s, want %s" % (launches, want))
    log(json.dumps({"workflow_small": dict(out, transformer_launches=
                                           launches)}))
    return launches


def workflow_check(torch, dev):
    """Phase 12: (a) AlexNet, (b) the LM, (c) the small samples; returns
    the workflow runs' launches by kernel."""
    import os
    import shutil
    snapdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_workflow_snapshots")
    t_phase = time.perf_counter()
    try:
        got = {}
        for part in (workflow_alexnet(torch, dev, snapdir),
                     workflow_lm(torch, dev),
                     workflow_small(torch, dev, snapdir)):
            for n, v in part.items():
                got[n] = got.get(n, 0) + v
    finally:
        shutil.rmtree(snapdir, ignore_errors=True)
    log("workflow: %.1f s" % (time.perf_counter() - t_phase))
    return got


# -- phase 13: the input pipeline ---------------------------------------------

#: (a): AlexNet at full width from a tree of .npy images
IN_SIDE, IN_CLASSES, IN_TRAIN, IN_VALID, IN_BATCH = 227, 8, 1024, 256, 256
IN_EPOCHS, IN_DEPTH = 2, 2
IN_AUGMENT = {"kind": "image", "flip": True, "pad": 4, "cutout": 16}
#: (b): the LM on a BPE vocabulary of the port's own sources, which any
#: checkout that can run this script holds (its Markdown may be absent)
IN_VOCAB, IN_LM_STEPS = 4096, 4
IN_CORPUS, IN_CORPUS_CHARS = "veles_tpu_torch", 184000
#: card against CPU in float32 (the small copies), as WF_SMALL_TOL
IN_SMALL_TOL = 1e-3
IN_DIR = "_input_data"
#: (c): the sound loader's feature tree (a cut of the GTZAN one)
IN_SOUND_XML = """<features><transform name="Mix" condition="channels==2">
<transform name="Window" parameters="type=hamming,length=512,step=256">
<transform name="ZeroCrossings"><transform name="Merge">
<transform name="Stats" parameters="interval=100">
<feature name="ZeroCrossings"/></transform></transform></transform>
<transform name="Energy"><transform name="Merge">
<transform name="Stats" parameters="interval=100">
<feature name="Energy"/></transform></transform></transform>
<transform name="RDFT"><transform name="ComplexMagnitude">
<transform name="Centroid"><transform name="Merge">
<transform name="Stats" parameters="interval=100">
<feature name="Centroid"/></transform></transform></transform>
<transform name="Rolloff"><transform name="Merge">
<transform name="Stats" parameters="interval=100">
<feature name="Rolloff"/></transform></transform></transform>
</transform></transform></transform></transform></features>"""


def _input_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), IN_DIR)


def start_vocab():
    """Phase 13 (b)'s corpus (the first IN_CORPUS_CHARS characters of
    the ``.py`` files under IN_CORPUS, by sorted path) and its BPE
    vocabulary, trained in a child process while phase 12 runs.
    Returns (process, corpus path, vocabulary path)."""
    here = os.path.dirname(os.path.abspath(__file__))
    d = _input_dir()
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    paths = []
    for root, dirs, files in os.walk(os.path.join(here, IN_CORPUS)):
        dirs[:] = [n for n in dirs if not n.startswith((".", "_"))]
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    parts, size = [], 0
    for path in sorted(os.path.relpath(p, here) for p in paths):
        with open(os.path.join(here, path), encoding="utf-8") as f:
            parts.append(f.read())
        size += len(parts[-1])
        if size >= IN_CORPUS_CHARS:
            break
    text = "".join(parts)[:IN_CORPUS_CHARS]
    if len(text) < IN_CORPUS_CHARS:
        raise SystemExit("input (b): the port's sources hold %d characters,"
                         " fewer than %d" % (len(text), IN_CORPUS_CHARS))
    corpus = os.path.join(d, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as out:
        out.write(text)
    vocab = os.path.join(d, "vocab.json")
    code = ("import sys, time\n"
            "t0 = time.perf_counter()\n"
            "from veles_tpu_torch.loader.text import BytePairVocab\n"
            "with open(sys.argv[1], encoding='utf-8') as f:\n"
            "    text = f.read()\n"
            "BytePairVocab.train(text, int(sys.argv[3]),\n"
            "                    specials=('<eos>',)).save(sys.argv[2])\n"
            "print(time.perf_counter() - t0)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, corpus, vocab, str(IN_VOCAB)],
        cwd=here, stdout=subprocess.PIPE, text=True)
    return proc, corpus, vocab


def _write_images(d, n_train, n_valid, classes, side, seed):
    """A class tree ``d/{train,valid}/class<k>/<i>.npy`` of uint8
    images drawn from ``default_rng(seed)``; returns (bytes, seconds)."""
    rng = numpy.random.default_rng(seed)
    t0 = time.perf_counter()
    nbytes = 0
    for split, n in (("train", n_train), ("valid", n_valid)):
        for i in range(n):
            sub = os.path.join(d, split, "class%d" % (i % classes))
            os.makedirs(sub, exist_ok=True)
            img = rng.integers(0, 256, (side, side, 3), dtype=numpy.uint8)
            numpy.save(os.path.join(sub, "%05d.npy" % i), img)
            nbytes += img.nbytes
    return nbytes, time.perf_counter() - t0


def _image_workflow(d, prefetch, layers, batch, dtype, epochs, name):
    from veles_tpu_torch.loader.image import FileImageLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    return StandardWorkflow(
        name=name, loader_factory=FileImageLoader,
        loader_config={"train_paths": [os.path.join(d, "train")],
                       "validation_paths": [os.path.join(d, "valid")],
                       "minibatch_size": batch, "prefetch": prefetch,
                       "name": "%s-prefetch-%d" % (name, prefetch)},
        layers=layers, dtype=dtype, solver="sgd", learning_rate=0.01,
        gradient_moment=0.9, weights_decay=0.0005,
        augment=dict(IN_AUGMENT), decision_config={"max_epochs": epochs},
        snapshotter_config={"enabled": False})


def _record_waves(wf, occupancy=None):
    """Wrap the decision's run: each wave's gate Bools (and the
    prefetch occupancy the pop read) as the decision sees them."""
    loader, run = wf.loader, wf.decision.run
    waves, occ, stamps = [], [], []

    def record():
        stamps.append(time.perf_counter())
        waves.append((loader.minibatch_class, loader.minibatch_size,
                      bool(loader.last_minibatch), bool(loader.epoch_ended),
                      bool(loader.train_ended)))
        if occupancy is not None:
            occ.append(occupancy.value)
        run()
    wf.decision.run = record
    return waves, occ, stamps


def _input_arm(torch, dev, d, prefetch):
    """One arm of phase 13 (a): AlexNet at full width from the files at
    ``prefetch`` depth; returns its results and timings."""
    from veles_tpu_torch import telemetry
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    wf = _image_workflow(d, prefetch, alexnet_layers(IN_CLASSES, 0.5,
                                                     side=IN_SIDE),
                         IN_BATCH, "bfloat16", IN_EPOCHS, "files")
    wf.initialize(device=dev)
    loader = wf.loader
    metrics = telemetry.metrics
    occupancy = metrics.gauge("veles_prefetch_occupancy",
                              labelnames=("loader",)).labels(loader.name)
    waves, occ, stamps = _record_waves(wf,
                                       occupancy if prefetch else None)
    wait = metrics.histogram(
        "veles_input_wait_seconds", labelnames=("loader", "mode")).labels(
        loader.name, "prefetch" if prefetch else "sync")
    w0, c0 = wait.sum, wait.count
    # the decode where it runs (the main thread, or the fill thread)
    from veles_tpu_torch.loader.image import FileImageLoader
    fill, fills = FileImageLoader.fill_minibatch, []

    def timed_fill(self):
        t = time.perf_counter()
        fill(self)
        fills.append(time.perf_counter() - t)
    FileImageLoader.fill_minibatch = timed_fill
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    t0 = time.perf_counter()
    try:
        wf.run()
        torch.cuda.synchronize()
    finally:
        FileImageLoader.fill_minibatch = fill
    wall = time.perf_counter() - t0
    launches = {n: v for n, v in _read_train_counts().items()
                if not n.startswith("flash_attn_")}
    peak = torch.cuda.max_memory_allocated()
    pipeline = loader.prefetch_
    wf.stop()
    if prefetch and (pipeline in (None, False) or pipeline.alive):
        raise SystemExit("input (a): prefetch %d did not run through a "
                         "pipeline that stop() closed" % prefetch)
    if not prefetch and pipeline is not False:
        raise SystemExit("input (a): prefetch 0 made a pipeline")
    keys = loader._all_keys[:IN_BATCH]
    t1 = time.perf_counter()
    for k in keys:
        loader.pipeline(loader.pipeline.decode(k))
    decode_ms = 1e3 * (time.perf_counter() - t1)
    steps = wf.gd.global_step
    out = {"prefetch": prefetch, "waves": len(waves), "train_steps": steps,
           "wall_s": wall, "wall_ms_per_train_step": 1e3 * wall / steps,
           # the steady wave: the median gap between the decision's
           # runs past the first epoch (cuDNN's first plans excluded)
           "wave_ms_median": 1e3 * float(numpy.median(numpy.diff(
               stamps[len(stamps) // IN_EPOCHS - 1:]))),
           "input_wait_ms_per_wave": 1e3 * (wait.sum - w0)
           / max(wait.count - c0, 1),
           "input_waits": wait.count - c0,
           "decode_ms_per_minibatch": decode_ms,
           "fill_ms_median": 1e3 * float(numpy.median(fills)),
           "unit_ms_per_wave": {u.name: 1e3 * u.timers["run"]
                                / max(u.timers["runs"], 1)
                                for u in (loader, wf.gd)},
           "max_memory_allocated_gb": peak / 1e9,
           "history": wf.decision.history, "launches": launches}
    if prefetch:
        out["occupancy_mean"] = float(numpy.mean(occ))
        out["occupancy"] = occ
    run = {"params": _host_params(wf.gd.forwards),
           "losses": _losses(wf.decision.history), "waves": waves}
    del wf, loader
    torch.cuda.empty_cache()
    return out, run


def _small_image_layers():
    return [{"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
             "padding": 1},
            {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0},
            {"type": "max_pooling", "kx": 2, "ky": 2, "sliding": (2, 2)},
            {"type": "conv_str", "n_kernels": 16, "kx": 3, "ky": 3,
             "padding": 1},
            {"type": "max_pooling", "kx": 2, "ky": 2, "sliding": (2, 2)},
            {"type": "all2all_tanh", "output_sample_shape": (32,)},
            {"type": "dropout", "dropout_ratio": 0.5},
            {"type": "softmax", "output_sample_shape": (2,)}]


def _card_vs_cpu(torch, what, make, dev, extra=None):
    """``make()`` built and run on the card and on the CPU (float32):
    epoch metrics and weights within IN_SMALL_TOL; returns the card
    run's launches and a summary."""
    runs, launches = {}, None
    for where in ("card", "cpu"):
        wf = make()
        wf.initialize(device=dev if where == "card" else "cpu")
        _zero_train_counts()
        t0 = time.perf_counter()
        wf.run()
        if where == "card":
            torch.cuda.synchronize()
            launches = _read_train_counts()
        wall = time.perf_counter() - t0
        wf.stop()
        runs[where] = (_losses(wf.decision.history),
                       _host_params(wf.gd.forwards), wall,
                       wf.gd.global_step,
                       extra(wf) if extra is not None else None)
    (mc, pc, wc, sc, xc), (mh, ph, wh, sh, xh) = runs["card"], runs["cpu"]
    if sc != sh or len(mc) != len(mh) or not mc or not numpy.allclose(
            mc, mh, rtol=IN_SMALL_TOL, atol=IN_SMALL_TOL):
        raise SystemExit("input (%s): card losses %s after %d steps, CPU "
                         "%s after %d" % (what, mc, sc, mh, sh))
    worst = max(v for d in _max_diff(torch, pc, ph) for v in d.values())
    scale = max(float(t.abs().max()) for d in ph for t in d.values())
    if worst > IN_SMALL_TOL * max(scale, 1.0):
        raise SystemExit("input (%s): weights differ by %g card vs CPU "
                         "(limit %g)" % (what, worst,
                                         IN_SMALL_TOL * max(scale, 1.0)))
    if xc != xh:
        raise SystemExit("input (%s): card %s, CPU %s" % (what, xc, xh))
    return launches, {"losses": mc, "max_abs_weight_diff": worst,
                      "train_steps": sc, "card_s": wc, "cpu_s": wh}


def input_images(torch, dev):
    """Phase 13 (a); returns the launches of both arms."""
    d = os.path.join(_input_dir(), "images")
    nbytes, write_s = _write_images(d, IN_TRAIN, IN_VALID, IN_CLASSES,
                                    IN_SIDE, 13)
    arms = {}
    for prefetch in (IN_DEPTH, 0):
        arms[prefetch] = _input_arm(torch, dev, d, prefetch)
    (on, ron), (off, roff) = arms[IN_DEPTH], arms[0]
    if ron["waves"] != roff["waves"] or ron["losses"] != roff["losses"]:
        raise SystemExit("input (a): prefetch %d and 0 differ: waves %s / "
                         "%s, losses %s / %s" % (IN_DEPTH, ron["waves"],
                                                 roff["waves"],
                                                 ron["losses"],
                                                 roff["losses"]))
    for i, (a, b) in enumerate(zip(ron["params"], roff["params"])):
        for n in a:
            if not torch.equal(a[n], b[n]):
                raise SystemExit(
                    "input (a): layer %d %s differs by %g between prefetch "
                    "%d and 0" % (i, n, float((a[n] - b[n]).abs().max()),
                                  IN_DEPTH))
    waves, steps = on["waves"], on["train_steps"]
    # two LRN layers on every forward, their backward on train steps;
    # two dropout masks and one flip draw per train step
    want = {"lrn_fwd": 2 * waves, "lrn_bwd": 2 * steps,
            "uniform_fill": 3 * steps}
    for arm in (on, off):
        if arm["launches"] != want:
            raise SystemExit("input (a): prefetch %d launched %s over %d "
                             "waves / %d train steps (want %s)"
                             % (arm["prefetch"], arm["launches"], waves,
                                steps, want))
    want_waves = IN_EPOCHS * (-(-IN_TRAIN // IN_BATCH)
                              + -(-IN_VALID // IN_BATCH))
    if waves != want_waves or not all(numpy.isfinite(ron["losses"])):
        raise SystemExit("input (a): %d waves (want %d), losses %s"
                         % (waves, want_waves, ron["losses"]))
    small = os.path.join(_input_dir(), "small_images")
    _write_images(small, 64, 32, 2, 32, 14)
    small_launches, small_out = _card_vs_cpu(
        torch, "small images", lambda: _image_workflow(
            small, IN_DEPTH, _small_image_layers(), 32, "float32", 2,
            "small"), dev)
    for k in ("history",):
        on.pop(k)
        off.pop(k)
    log(json.dumps({"input_images": {
        "dataset_mb": nbytes / 1e6, "write_s": write_s,
        "prefetch": on, "sync": off, "bit_equal": True,
        "small_card_vs_cpu": small_out}}))
    total = {n: on["launches"][n] + off["launches"][n] for n in want}
    for n, v in small_launches.items():
        total[n] = total.get(n, 0) + v
    return total


def _lm_stride(bpe, text, valid_fraction=0.1):
    """The window stride that makes FullBatchTextLM cut exactly
    IN_LM_STEPS minibatches of T_BATCH train windows of T_SEQ tokens
    (the loader validates on the stream's last max(seq, round(n/10))
    tokens and windows the rest)."""
    n = len(bpe.encode(text))
    n_train = n - max(T_SEQ, int(round(n * valid_fraction)))
    stride = (n_train - T_SEQ) // (IN_LM_STEPS * T_BATCH - 1)
    if stride < 16:
        raise SystemExit("input (b): a %d-token corpus is too short for "
                         "%d windows of %d" % (n, IN_LM_STEPS * T_BATCH,
                                               T_SEQ))
    return stride, n


def input_lm(torch, dev, vocab_job):
    """Phase 13 (b); returns the card runs' launches."""
    from veles_tpu_torch.loader.text import BytePairVocab
    from veles_tpu_torch.samples.lm import LMWorkflow
    proc, corpus, vocab_path = vocab_job
    out, _ = proc.communicate(timeout=900)
    if proc.returncode:
        raise SystemExit("input (b): the vocabulary's training exited %d"
                         % proc.returncode)
    train_s = float(out.strip().splitlines()[-1])
    bpe = BytePairVocab.load(vocab_path)
    with open(corpus, encoding="utf-8") as f:
        text = f.read()
    t0 = time.perf_counter()
    ids = bpe.encode(text)
    encode_s = time.perf_counter() - t0
    if bpe.decode(ids) != text or max(ids) >= bpe.size:
        raise SystemExit("input (b): the vocabulary's round trip is not "
                         "exact")
    stride, n_tokens = _lm_stride(bpe, text)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf = LMWorkflow(text_path=corpus, vocab_path=vocab_path, dim=T_DIM,
                    blocks=T_LAYERS, heads=T_HEADS, seq=T_SEQ,
                    stride=stride, minibatch_size=T_BATCH, solver="sgd",
                    learning_rate=0.01, gradient_moment=0.9,
                    lr_schedule="constant", max_epochs=1,
                    dtype="bfloat16", snapshotter_config={"enabled": False})
    wf.initialize(device=dev)
    lengths = list(wf.loader.class_lengths)
    if lengths[2] != IN_LM_STEPS * T_BATCH \
            or wf.forwards[0].vocab != bpe.size:
        raise SystemExit("input (b): windows %s, embedding %d wide (vocab "
                         "%d)" % (lengths, wf.forwards[0].vocab, bpe.size))
    valid_steps = -(-lengths[1] // T_BATCH)
    torch.cuda.synchronize()
    _zero_train_counts()
    t_run = time.perf_counter()
    wf.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {n: v for n, v in _read_train_counts().items()
                if n.startswith("flash_attn_")}
    want = {"flash_attn_fwd": T_LAYERS * (IN_LM_STEPS + valid_steps),
            "flash_attn_dq": T_LAYERS * IN_LM_STEPS,
            "flash_attn_dkv": T_LAYERS * IN_LM_STEPS}
    losses = _losses(wf.decision.history)
    if launches != want or wf.gd.global_step != IN_LM_STEPS \
            or not losses or not all(numpy.isfinite(losses)):
        raise SystemExit("input (b): %d steps launched %s (want %s), "
                         "losses %s" % (wf.gd.global_step, launches, want,
                                        losses))
    peak = torch.cuda.max_memory_allocated()
    wf.stop()
    del wf
    torch.cuda.empty_cache()
    small_launches, small = _card_vs_cpu(
        torch, "small lm", lambda: LMWorkflow(
            text_path=corpus, vocab_path=vocab_path, dim=64, blocks=2,
            heads=2, seq=128, stride=512, minibatch_size=32, solver="sgd",
            learning_rate=0.01, gradient_moment=0.9,
            lr_schedule="constant", max_epochs=1, dtype="float32",
            snapshotter_config={"enabled": False}), dev)
    log(json.dumps({"input_lm": {
        "vocab": bpe.size, "merges": len(bpe.merges),
        "corpus_chars": len(text), "tokens": n_tokens,
        "vocab_train_s": train_s, "encode_s": encode_s, "stride": stride,
        "windows": lengths, "steps": IN_LM_STEPS, "losses": losses,
        "launches": launches, "with_build_s": t_end - t0,
        "run_s": t_end - t_run,
        "max_memory_allocated_gb": peak / 1e9,
        "small_card_vs_cpu": small}}))
    for n, v in small_launches.items():
        if n.startswith("flash_attn_"):
            launches[n] += v
    return launches


def _tar_pickles(d):
    """Pickled train/validation sets packed into a .tar.gz; returns the
    archive's path."""
    import pickle
    import tarfile
    rng = numpy.random.default_rng(15)
    src = os.path.join(d, "pickles_src")
    os.makedirs(src, exist_ok=True)
    for name, n in (("train", 192), ("valid", 64)):
        x = rng.normal(size=(n, 24)).astype(numpy.float32)
        y = (x[:, :4].argmax(axis=1)).tolist()
        with open(os.path.join(src, name + ".pickle"), "wb") as f:
            pickle.dump((x, y), f)
    archive = os.path.join(d, "pickles.tar.gz")
    with tarfile.open(archive, "w:gz") as t:
        for name in ("train", "valid"):
            t.add(os.path.join(src, name + ".pickle"),
                  arcname=name + ".pickle")
    return archive


def _mlp(classes):
    return [{"type": "all2all_tanh", "output_sample_shape": (32,)},
            {"type": "softmax", "output_sample_shape": (classes,)}]


def input_small(torch, dev):
    """Phase 13 (c); returns the card runs' launches."""
    from veles_tpu_torch.datasets import tones
    from veles_tpu_torch.downloader import Downloader
    from veles_tpu_torch.loader.pickles import PicklesLoader
    from veles_tpu_torch.loader.sound import SoundLoader
    from veles_tpu_torch.models.standard import StandardWorkflow
    from veles_tpu_torch.samples.cifar import CifarWorkflow
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    d = os.path.join(_input_dir(), "small")
    os.makedirs(d, exist_ok=True)
    snap = {"enabled": False}
    sgd = {"solver": "sgd", "learning_rate": 0.01, "gradient_moment": 0.9}
    out, total = {}, {}

    def add(launches):
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v

    launches, out["mnist_glyphs"] = _card_vs_cpu(
        torch, "mnist glyphs", lambda: MnistWorkflow(
            synthetic_kind="glyphs", synthetic_train=512,
            synthetic_valid=128, minibatch_size=128, max_epochs=2,
            dtype="float32", snapshotter_config=snap,
            augment={"kind": "image", "pad": 2, "cutout": 8,
                     "shape": (28, 28, 1)}), dev)
    if launches["uniform_fill"] != out["mnist_glyphs"]["train_steps"]:
        raise SystemExit("input (mnist glyphs): %d flip draws over %d "
                         "train steps" % (launches["uniform_fill"],
                                          out["mnist_glyphs"]["train_steps"]))
    add(launches)
    launches, out["cifar_scenes"] = _card_vs_cpu(
        torch, "cifar scenes", lambda: CifarWorkflow(
            synthetic_kind="scenes", synthetic_train=256,
            synthetic_valid=128, minibatch_size=128, max_epochs=2,
            dtype="float32", snapshotter_config=snap,
            augment={"kind": "image", "pad": 4}, **sgd), dev)
    if launches["uniform_fill"] != out["cifar_scenes"]["train_steps"]:
        raise SystemExit("input (cifar scenes): %d flip draws over %d "
                         "train steps" % (launches["uniform_fill"],
                                          out["cifar_scenes"]["train_steps"]))
    add(launches)

    t0 = time.perf_counter()
    tree = tones.generate(os.path.join(d, "tones"), tracks_per_genre=2,
                          seconds=3.0, rate=8000, seed=4242)
    tones_s = time.perf_counter() - t0
    launches, out["sound"] = _card_vs_cpu(
        torch, "sound", lambda: StandardWorkflow(
            loader_factory=SoundLoader, loader_config={
                "features_xml": IN_SOUND_XML, "train_paths": [tree],
                "minibatch_size": 8},
            layers=_mlp(len(tones.GENRES)), decision_config={
                "max_epochs": 2}, snapshotter_config=snap,
            dtype="float32", **sgd), dev,
        extra=lambda wf: (list(wf.loader.class_lengths),
                          tuple(wf.loader.original_data.shape)))
    out["sound"]["tones_s"] = tones_s
    add(launches)

    archive = _tar_pickles(d)
    dest = os.path.join(d, "pickles")
    Downloader(url="file://" + archive, directory=dest,
               files=["train.pickle", "valid.pickle"]).initialize()
    if not os.path.isfile(archive):
        raise SystemExit("input (downloader): the local archive is gone")
    launches, out["pickles"] = _card_vs_cpu(
        torch, "pickles", lambda: StandardWorkflow(
            loader_factory=PicklesLoader, loader_config={
                "train_path": os.path.join(dest, "train.pickle"),
                "validation_path": os.path.join(dest, "valid.pickle"),
                "minibatch_size": 32},
            layers=_mlp(4), decision_config={"max_epochs": 2},
            snapshotter_config=snap, dtype="float32", **sgd), dev)
    add(launches)
    out["saver"] = _saver_check(torch, dev, dest, d)
    out["joiner"] = _joiner_check(torch, dev)
    log(json.dumps({"input_small": out}))
    return total


def _saver_check(torch, dev, src, d):
    """A PicklesLoader's per-minibatch stream (prefetching on the card)
    saved by MinibatchesSaver and read back by MinibatchesLoader, on the
    card and on the CPU: the same minibatches."""
    from veles_tpu_torch.loader.pickles import PicklesLoader
    from veles_tpu_torch.loader.saver import (
        MinibatchesLoader, MinibatchesSaver)
    replays = {}
    for where in ("card", "cpu"):
        device = dev if where == "card" else "cpu"
        loader = PicklesLoader(
            None, train_path=os.path.join(src, "train.pickle"),
            validation_path=os.path.join(src, "valid.pickle"),
            minibatch_size=48)
        loader.initialize(device=device)
        path = os.path.join(d, "stream-%s.pickle.gz" % where)
        saver = MinibatchesSaver(None, path=path)
        saver.loader = loader
        saver.initialize()
        served = []
        for _ in range(6):
            loader.run()
            saver.run()
            served.append(loader.minibatch_data.map_read().mem[
                :loader.minibatch_size].copy())
        if where == "card" and loader.prefetch_ in (None, False):
            raise SystemExit("input (saver): the card's loader did not "
                             "prefetch")
        saver.stop()
        loader.stop()
        replay = MinibatchesLoader(None, path=path, shuffle_limit=0)
        replay.initialize(device=device)
        # served valid first, then train: the replay's class order
        rows = numpy.concatenate(served)
        if replay.total_samples != len(rows) \
                or not numpy.array_equal(replay._data, rows):
            raise SystemExit("input (saver): the %s stream did not read "
                             "back" % where)
        replays[where] = (replay._data, replay._labels)
    if not all(numpy.array_equal(a, b) for a, b in zip(replays["card"],
                                                       replays["cpu"])):
        raise SystemExit("input (saver): card and CPU streams differ")
    return {"rows": int(len(replays["card"][0]))}


def _joiner_check(torch, dev):
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.ops.join import InputJoiner
    rng = numpy.random.default_rng(16)
    parts = [rng.normal(size=s).astype(numpy.float32)
             for s in ((256, 3), (256, 2, 5), (256, 4, 4, 3))]
    got = {}
    for where in ("card", "cpu"):
        j = InputJoiner(None, inputs=[Array(p) for p in parts])
        j.initialize(device=dev if where == "card" else "cpu")
        j.run()
        got[where] = j.output.map_read().mem.copy()
    want = numpy.concatenate([p.reshape(256, -1) for p in parts], axis=1)
    if not (numpy.array_equal(got["card"], want)
            and numpy.array_equal(got["cpu"], want)):
        raise SystemExit("input (joiner): the joined rows differ")
    return {"shape": list(want.shape)}


def input_check(torch, dev, vocab_job):
    """Phase 13: (a) AlexNet from image files, (b) the LM from BPE text,
    (c) the small parts; returns the phase's card launches by kernel."""
    t_phase = time.perf_counter()
    try:
        got = {}
        for part in (input_images(torch, dev),
                     input_lm(torch, dev, vocab_job),
                     input_small(torch, dev)):
            for n, v in part.items():
                got[n] = got.get(n, 0) + v
    finally:
        shutil.rmtree(_input_dir(), ignore_errors=True)
    log("input: %.1f s" % (time.perf_counter() - t_phase))
    return got


# -- phase 14: the command line -------------------------------------------------

#: (a) AlexNet through ``samples/alexnet.py`` + its config at full width
#: (227², 1000 classes, minibatch 256), cut to 1 epoch of a small stand-in
CLI_A_TRAIN, CLI_A_VALID = 512, 256
CLI_A_SIDE, CLI_A_CLASSES, CLI_A_BATCH, CLI_A_WIDTHS = 227, 1000, 256, None
#: (b) the LM sample at bench_lm's width (d 2048, 16 heads of 128, seq
#: 2048, vocab 32768; the random corpus), cut to 2 blocks and 3 epochs
#: of 2 steps; SGD, an uncompressed snapshot
CLI_LM_BLOCKS, CLI_LM_TRAIN, CLI_LM_VALID, CLI_LM_EPOCHS = 2, 8, 4, 3
CLI_GEN_PROMPT, CLI_GEN_STEPS = 16, 16
#: (c)/(d) the small runs, card against CPU
CLI_SMALL_TOL = 1e-3
CLI_DIR = "_cli_runs"
CLI_F32 = "root.common.precision.compute_dtype = 'float32'"


def _cli_dir():
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), CLI_DIR)


def _sample(name):
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "veles_tpu_torch", "samples", name)


def _tree_vars(node, out):
    from veles_tpu_torch.config import Config
    out.append((node, dict(vars(node))))
    for v in list(vars(node).values()):
        if isinstance(v, Config):
            _tree_vars(v, out)
    return out


class _CliRun:
    """``veles_tpu_torch.__main__.Main(argv)``, in process (so the launch
    counts can be read), with the config tree restored after it; on a
    thread when ``thread`` (a server: :meth:`wait` joins it)."""

    def __init__(self, argv, thread=False):
        import threading
        from veles_tpu_torch.__main__ import Main
        self.argv = list(argv)
        self.main = Main(self.argv)
        self.rc = self.error = None
        self.t0 = time.perf_counter()
        if thread:
            self.thread = threading.Thread(target=self._run, daemon=True)
            self.thread.start()
        else:
            self.thread = None
            self._run()
            self._check()

    def _run(self):
        from veles_tpu_torch.config import root
        saved = _tree_vars(root, [])
        try:
            self.rc = self.main.run()
        except BaseException as e:  # reported by _check
            self.error = e
        finally:
            for node, d in saved:
                vars(node).clear()
                vars(node).update(d)
            self.wall = time.perf_counter() - self.t0

    def _check(self):
        if self.error is not None:
            raise self.error
        if self.rc != 0:
            raise SystemExit("cli: %s returned %r" % (self.argv, self.rc))

    def wait_for_api(self, limit=300.0):
        t_end = time.time() + limit
        while time.time() < t_end:
            wf = self.main.workflow
            api = getattr(wf, "api", None) if wf is not None else None
            if api is not None and api._server_ is not None:
                return api.port
            if not self.thread.is_alive():
                self._check()
                raise SystemExit("cli: the server run ended before serving")
            time.sleep(0.05)
        raise SystemExit("cli: the server did not come up in %.0f s" % limit)

    def wait(self, limit=300.0):
        self.thread.join(limit)
        if self.thread.is_alive():
            raise SystemExit("cli: the server run did not end after "
                             "/shutdown")
        self._check()

    @property
    def workflow(self):
        return self.main.workflow


def _results(path):
    with open(path) as f:
        return json.load(f)


def _same_results(what, got, want, tol):
    skip = ("elapsed_sec", "Snapshot")
    keys = sorted(k for k in want if k not in skip)
    if sorted(k for k in got if k not in skip) != keys:
        raise SystemExit("%s: results keys %s, want %s"
                         % (what, sorted(got), keys))
    for k in keys:
        a, b = got[k], want[k]
        if isinstance(b, float):
            if not abs(a - b) <= tol * max(1.0, abs(b)):
                raise SystemExit("%s: %s %r, want %r" % (what, k, a, b))
        elif a != b:
            raise SystemExit("%s: %s %r, want %r" % (what, k, a, b))


def cli_alexnet(torch, dev, d):
    """Phase 14 (a); returns the CLI run's launches."""
    import os
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples.alexnet import AlexNetWorkflow
    from veles_tpu_torch.telemetry import trace_export
    widths = {"widths": CLI_A_WIDTHS} if CLI_A_WIDTHS else {}
    direct = []
    for run in range(2):
        torch.cuda.synchronize()
        _zero_train_counts()
        prng.get().seed(42)
        t0 = time.perf_counter()
        wf = AlexNetWorkflow(side=CLI_A_SIDE, classes=CLI_A_CLASSES,
                             minibatch_size=CLI_A_BATCH,
                             synthetic_train=CLI_A_TRAIN,
                             synthetic_valid=CLI_A_VALID, max_epochs=1,
                             solver="sgd", learning_rate=0.01,
                             gradient_moment=0.9, weights_decay=0.0005,
                             fail_iterations=10, dtype="bfloat16",
                             weights_seed=None,
                             snapshotter_config={"enabled": False},
                             **widths)
        wf.initialize(device=dev)
        wf.run()
        torch.cuda.synchronize()
        direct.append({"wall": time.perf_counter() - t0,
                       "launches": _read_train_counts(),
                       "run": (_host_params(wf.gd.forwards),
                               _losses(wf.decision.history))})
        wf.stop()
        del wf
        torch.cuda.empty_cache()
    events_log = os.path.join(d, "alexnet.jsonl")
    profile = os.path.join(d, "profile")
    result = os.path.join(d, "alexnet.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    run = _CliRun([
        _sample("alexnet.py"), _sample("alexnet_config.py"),
        "-c", "root.alexnet_tpu.update(%r)" % dict(
            synthetic_train=CLI_A_TRAIN, synthetic_valid=CLI_A_VALID,
            max_epochs=1, side=CLI_A_SIDE, classes=CLI_A_CLASSES,
            minibatch_size=CLI_A_BATCH, **widths),
        "-c", "root.common.dirs.snapshots = %r" % os.path.join(d, "snaps"),
        "--events-log", events_log, "--profile", profile,
        "--result-file", result])
    torch.cuda.synchronize()
    launches = _read_train_counts()
    peak = torch.cuda.max_memory_allocated()
    wf = run.workflow
    want = {n: direct[0]["launches"][n]
            for n in ("lrn_fwd", "lrn_bwd", "uniform_fill")}
    got = {n: launches[n] for n in want}
    if got != want or not all(got.values()):
        raise SystemExit("cli (alexnet): launches %s, the direct run's %s"
                         % (got, want))
    mine = (_host_params(wf.gd.forwards), _losses(wf.decision.history))
    ratio = wf_rule(torch, "cli (alexnet)", mine,
                    [direct[0]["run"], direct[1]["run"]], direct[0]["run"],
                    direct[1]["run"])
    bit_equal = max(v for dd in _max_diff(torch, mine[0], direct[0]["run"][0])
                    for v in dd.values()) == 0.0
    # the profiler's Chrome trace names the kernels
    with open(run.main.launcher.profile_path) as f:
        trace = json.load(f)
    kernels = {e.get("name", "") for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"}
    named = {n: sum(n in k for k in kernels)
             for n in ("lrn_fwd", "lrn_bwd", "uniform_fill")}
    if dev.type == "cuda" and not all(named.values()):
        raise SystemExit("cli (alexnet): the profiler's trace names %s of "
                         "the kernels (%d kernel events)"
                         % (named, len(kernels)))
    units = {e["name"] for e in trace.get("traceEvents", [])
             if str(e.get("name", "")).startswith("unit:")}
    # the exporter turns the events log into a Chrome trace with a span
    # for every unit of the graph
    exported = os.path.join(d, "alexnet-trace.json")
    n_events = trace_export.export(events_log, exported)
    with open(exported) as f:
        spans = {e["name"] for e in json.load(f)["traceEvents"]
                 if e["ph"] == "B"}
    # every unit of the graph ran (the end point aside: the decision
    # that completes the run stops the wave before it) and has its span
    idle = [u.name for u in wf.units
            if not u.timers["runs"] and u is not wf.end_point]
    missing = ["unit:%s" % u.name for u in wf.units if u.timers["runs"]
               and "unit:%s" % u.name not in spans]
    if idle or missing or "workflow run" not in spans:
        raise SystemExit("cli (alexnet): units %s never ran; the exported "
                         "trace lacks %s" % (idle, missing))
    res = _results(result)
    metrics = wf.decision.get_metric_values()
    if not metrics or any(res.get(k) != v for k, v in metrics.items()):
        raise SystemExit("cli (alexnet): the results file %s lacks the "
                         "decision's metrics %s" % (res, metrics))
    log(json.dumps({"cli_alexnet": {
        "train": CLI_A_TRAIN, "valid": CLI_A_VALID, "batch": CLI_A_BATCH,
        "cli_wall_s": run.wall, "direct_wall_s": [r["wall"] for r in direct],
        "max_memory_allocated_gb": peak / 1e9, "launches": got,
        "rule_ratio": ratio, "bit_equal_to_direct": bit_equal,
        "profile_kernel_events": len(kernels),
        "profile_unit_ranges": len(units), "profile_named": named,
        "exported_events": n_events, "results": res}}))
    wf.stop()
    del wf, run
    torch.cuda.empty_cache()
    return got


def _lm_argv(d, epochs, extra=()):
    import os
    keys = ("root.lm_tpu.update({'dim': %d, 'heads': %d, 'seq': %d, "
            "'vocab': %d, 'blocks': %d, 'corpus': 'random', "
            "'synthetic_train': %d, 'synthetic_valid': %d, "
            "'minibatch_size': %d, 'solver': 'sgd', 'learning_rate': 0.01, "
            "'lr_schedule': 'constant', 'max_epochs': %d, "
            "'fail_iterations': 100, 'snapshot_time_interval': 0.0, "
            "'snapshotter_config': {'compression': None}})"
            % (T_DIM, T_HEADS, T_SEQ, T_VOCAB, CLI_LM_BLOCKS, CLI_LM_TRAIN,
               CLI_LM_VALID, T_BATCH, epochs))
    return [_sample("lm.py"), "-c", keys,
            "-c", "root.common.dirs.snapshots = %r" % os.path.join(d, "lm")
            ] + list(extra)


def cli_lm(torch, dev, d):
    """Phase 14 (b): the LM through the CLI, interrupted and resumed from
    its ``_current`` snapshot against an uninterrupted run; returns (the
    launches of the interrupted and resumed runs, the snapshot)."""
    import os
    import shutil
    from veles_tpu_torch.ops import flash_attention as fa
    torch.cuda.synchronize()
    _zero_train_counts()
    whole = _CliRun(_lm_argv(d, CLI_LM_EPOCHS))
    torch.cuda.synchronize()
    whole_launches = dict(fa.launches)
    want = (_host_params(whole.workflow.gd.forwards),
            list(whole.workflow.decision.history))
    whole.workflow.stop()
    del whole
    shutil.rmtree(os.path.join(d, "lm"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_train_counts()
    first = _CliRun(_lm_argv(d, CLI_LM_EPOCHS - 1))
    first.workflow.stop()
    snap = os.path.join(d, "lm", "lm_current.pickle")
    step = first.workflow.gd.global_step
    del first
    torch.cuda.empty_cache()
    resumed = _CliRun(_lm_argv(d, CLI_LM_EPOCHS - 1, [
        "-s", snap, "--decision", "max_epochs=%d" % CLI_LM_EPOCHS]))
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    got = (_host_params(resumed.workflow.gd.forwards),
           list(resumed.workflow.decision.history))
    if not resumed.main.restored:
        raise SystemExit("cli (lm): -s did not resume")
    diff = max(v for dd in _max_diff(torch, got[0], want[0])
               for v in dd.values())
    if diff != 0.0 or got[1] != want[1]:
        raise SystemExit("cli (lm): the resumed run differs from the "
                         "uninterrupted one by %g (histories equal: %s)"
                         % (diff, got[1] == want[1]))
    if not all(launches[n] for n in ("flash_attn_fwd", "flash_attn_dq",
                                     "flash_attn_dkv")):
        raise SystemExit("cli (lm): FlashAttention launches %s" % launches)
    log(json.dumps({"cli_lm": {
        "dim": T_DIM, "heads": T_HEADS, "seq": T_SEQ, "vocab": T_VOCAB,
        "blocks": CLI_LM_BLOCKS, "epochs": CLI_LM_EPOCHS,
        "snapshot_step": step, "snapshot_mb": os.path.getsize(snap) / 1e6,
        "resumed_wall_s": resumed.wall,
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches, "uninterrupted_launches": whole_launches,
        "history": got[1]}}))
    resumed.workflow.stop()
    del resumed
    torch.cuda.empty_cache()
    return launches, snap


def _post(port, path, body):
    import urllib.request
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read() or b"{}")


def cli_serve(torch, dev, d, lm_snap):
    """Phase 14 (c): MNIST trained through the CLI, ``mnist_forward`` on
    its snapshot and ``serve.py`` on it (``/api``), then the LM snapshot
    of (b) served with int8 KV (``/generate``); returns the serving
    runs' launches."""
    import contextlib
    import io
    import os
    from veles_tpu_torch.models.generate import generate
    from veles_tpu_torch.samples import mnist_forward
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    snaps = os.path.join(d, "mnist")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train = _CliRun([
        _sample("mnist.py"), _sample("mnist_config.py"),
        "-c", "root.mnist_tpu.update({'synthetic_train': 1024, "
        "'synthetic_valid': 256, 'max_epochs': 2, 'layers': [100, 10], "
        "'snapshot_time_interval': 0.0})", "-c", CLI_F32,
        "-c", "root.common.dirs.snapshots = %r" % snaps])
    train.workflow.stop()
    snap = os.path.join(snaps, "mnist_current.pickle.gz")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mnist_forward.main([snap, "8", "--device", str(dev)])
    lines = [l for l in out.getvalue().splitlines() if l.startswith("sample")]
    if rc != 0 or len(lines) != 8:
        raise SystemExit("cli (c): mnist_forward printed %r" % out.getvalue())
    # the chain's own forward on the card
    chain = SnapshotterToFile.import_file(snap).gd.forwards
    rng = numpy.random.default_rng(5)
    xs = rng.random((6, 784)).astype(numpy.float32)
    with torch.no_grad():
        h = torch.as_tensor(xs, device=dev)
        for u in chain:
            u.to_device(dev)
            h = u.apply(h)
    want = h.float().cpu().numpy()
    server = _CliRun([_sample("serve.py"),
                      "-c", "root.serve.update({'snapshot': %r, "
                      "'max_wait': 0.05})" % snap, "-c", CLI_F32],
                     thread=True)
    port = server.wait_for_api()
    try:
        t0 = time.perf_counter()
        got = [_post(port, "/api", {"input": x.tolist()}) for x in xs]
        api_ms = (time.perf_counter() - t0) * 1e3 / len(xs)
    finally:
        _post(port, "/shutdown", {})
        server.wait()
    err = max(float(numpy.abs(numpy.asarray(r["result"]) - w).max())
              for (c, r), w in zip(got, want))
    if any(c != 200 for c, _ in got) or err > 1e-5:
        raise SystemExit("cli (c): /api replies differ from the chain's "
                         "forward by %g" % err)
    # the LM snapshot of (b), int8 KV pools
    zero_serving_counts()
    server = _CliRun([_sample("serve.py"),
                      "-c", "root.serve.update({'snapshot': %r, "
                      "'max_wait': 0.05})" % lm_snap,
                      "-c", "root.common.serving.kv_dtype = 'int8'"],
                     thread=True)
    port = server.wait_for_api()
    prompt = [int(t) for t in numpy.random.default_rng(6).integers(
        0, T_VOCAB, CLI_GEN_PROMPT)]
    try:
        t0 = time.perf_counter()
        code, reply = _post(port, "/generate",
                            {"prompt": prompt, "steps": CLI_GEN_STEPS})
        gen_ms = (time.perf_counter() - t0) * 1e3
        lm_chain = server.workflow.forwards
        sch = server.workflow.api.scheduler_
        kv_dtype = sch.kv_dtype if sch is not None else None
    finally:
        _post(port, "/shutdown", {})
        server.wait()
    torch.cuda.synchronize()
    launches = read_serving_counts()
    if code != 200 or kv_dtype != "int8" or not launches["paged_attend"]:
        raise SystemExit("cli (c): /generate %d on kv %s with %s launches"
                         % (code, kv_dtype, launches))
    direct = generate(lm_chain, [prompt], CLI_GEN_STEPS,
                      kv_cache=True)[0].cpu().tolist()
    tie = same_or_near_tie(torch, dev, lm_chain, [direct], [reply["tokens"]],
                           len(prompt), "cli (c) /generate")
    log(json.dumps({"cli_serve": {
        "api_ms_per_request": api_ms, "api_max_abs_err": err,
        "generate_ms": gen_ms, "generate_vs_direct": tie,
        "mnist_train_wall_s": train.wall,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}}))
    del lm_chain, server
    torch.cuda.empty_cache()
    return {"paged_attend": launches["paged_attend"]}


def cli_small(torch, dev, d):
    """Phase 14 (d): ``mnist_ae`` (FC, conv) and ``gtzan`` card against
    CPU through the CLI, and one ``python -m veles_tpu_torch``
    subprocess."""
    import os
    from veles_tpu_torch.cli_exec import run_cli_collect_results
    from veles_tpu_torch.datasets import tones
    tree = tones.generate(os.path.join(d, "tones"), tracks_per_genre=2,
                          seconds=1.0, rate=8000)
    sgd = "'solver': 'sgd', 'learning_rate': 0.01"
    runs = {
        "mnist_ae_fc": [_sample("mnist_ae.py"), "-c",
                        "root.mnist_tpu.update({'synthetic_train': 512, "
                        "'synthetic_valid': 128})", "-c",
                        "root.mnist_ae_tpu.update({'max_epochs': 2, "
                        "'conv': False, %s})" % sgd],
        "mnist_ae_conv": [_sample("mnist_ae.py"), "-c",
                          "root.mnist_tpu.update({'synthetic_train': 256, "
                          "'synthetic_valid': 64})", "-c",
                          "root.mnist_ae_tpu.update({'max_epochs': 2, "
                          "'conv': True, 'minibatch_size': 64, %s})" % sgd],
        "gtzan": [_sample("gtzan.py"), "-c",
                  "root.gtzan_tpu.update({'dataset_dir': %r, "
                  "'max_seconds': 1.0, 'max_epochs': 3, "
                  "'minibatch_size': 8, %s})" % (tree, sgd)],
    }
    out = {}
    for name, argv in runs.items():
        res = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for where in ("card", "cpu"):
            path = os.path.join(d, "%s-%s.json" % (name, where))
            run = _CliRun(argv + [
                "-c", CLI_F32, "-c", "root.common.dirs.snapshots = %r"
                % os.path.join(d, "small"), "--result-file", path]
                + (["-a", "cpu"] if where == "cpu" else []))
            run.workflow.stop()
            res[where] = (_results(path), run.wall)
        _same_results("cli (d) %s" % name, res["card"][0], res["cpu"][0],
                      CLI_SMALL_TOL)
        out[name] = {"card_s": res["card"][1], "cpu_s": res["cpu"][1],
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "results": res["card"][0]}
    t0 = time.perf_counter()
    sub = run_cli_collect_results(
        [_sample("mnist.py"), "-c", "root.mnist_tpu.update({"
         "'synthetic_train': 256, 'synthetic_valid': 64, "
         "'max_epochs': 1})", "-c", "root.common.dirs.snapshots = %r"
         % os.path.join(d, "sub")], timeout=300)
    if sub is None or sub.get("Total epochs") != 1:
        raise SystemExit("cli (d): python -m veles_tpu_torch gave %r"
                         % (sub,))
    out["subprocess"] = {"wall_s": time.perf_counter() - t0, "results": sub}
    log(json.dumps({"cli_small": out}))


def cli_check(torch, dev):
    """Phase 14: the command line — (a) AlexNet, (b) the LM and its
    resume, (c) serving, (d) the small samples and the module entry;
    returns the phase's card launches by kernel."""
    import os
    import shutil
    d = _cli_dir()
    os.makedirs(d, exist_ok=True)
    t_phase = time.perf_counter()
    try:
        got = dict(cli_alexnet(torch, dev, d))
        lm_launches, lm_snap = cli_lm(torch, dev, d)
        got.update(lm_launches)
        got.update(cli_serve(torch, dev, d, lm_snap))
        cli_small(torch, dev, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log("cli: %.1f s" % (time.perf_counter() - t_phase))
    return got


# -- phase 15: meshes in one process --------------------------------------------

#: phase 15 (``parallel_check``): tensor-parallel serving at the serve
#: phase's width (tp P_TP over P_TP positions sharing the card, int8 KV
#: pools with ``int8_decode`` off, spec off and on at P_SPEC_K, then fp32
#: pools with spec on); the trainer over P_MESHES and the MoE
#: trunk over P_MOE_MESH at ``bench_lm``'s widths cut to P_LAYERS layers
#: and P_STEPS steps per mesh; AlexNet over {"dp": 2} at P_A_BATCH.
#: Each mesh run is held against the same model unsharded on the card
#: in f32 compute: every loss within P_LOSS_TOL relative and every
#: parameter within P_W_TOL absolute (both runs sum the same products
#: in another order, and the dp groups' matmuls run at another batch).
#: (b) prints each run's peak device memory above what was allocated
#: before it; the positions share the card, so a mesh's peak is that of
#: all its positions together.  Under fsdp and dp x tp the trainer
#: gathers a unit's parameters only while it runs (the per-unit
#: gather), so the fsdp peak must stay within the unsharded step's and
#: the dp x tp peak within dp's, each plus twice the largest unit's
#: parameter and gradient bytes
P_TP, P_SPEC_K = 2, 4
P_LAYERS, P_STEPS = 4, 2
P_DP, P_DP_TP, P_FSDP = {"dp": 2}, {"dp": 2, "tp": 2}, {"fsdp": 2}
P_PP_DP, P_SP = {"pp": 2, "dp": 2}, {"sp": 2}
P_MESHES = (P_DP, P_DP_TP, P_FSDP, P_PP_DP, P_SP)
P_MOE_MESH = {"ep": 2, "dp": 2}
P_A_BATCH = 256
P_LOSS_TOL, P_W_TOL = 1e-5, 1e-5
#: Megatron's layout, which (a) holds each block's placement to: the
#: column-parallel weights (and the up-projection's bias) cut on their
#: last axis, the row-parallel ones on their first; every other
#: parameter (LN, output-side biases) whole on every position
P_TP_COLUMNS = ("wq", "wk", "wv", "ffn_w1", "ffn_b1")
P_TP_ROWS = ("wo", "ffn_w2")


def _positions(n):
    """Let the card offer ``n`` mesh positions; returns the old
    setting."""
    from veles_tpu_torch.parallel.mesh import set_positions_per_device
    return set_positions_per_device(n)


def tp_arm(torch, dev, chain, prompts, tp, kv_dtype, spec):
    """The serve phase's requests through ``InferenceScheduler(tp=)``:
    streams, per-pass launches, bytes and rates."""
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import InferenceScheduler, per_chip_bytes
    from veles_tpu_torch.serving.tp import chain_params
    sch = InferenceScheduler(chain, max_slots=SLOTS, window=WINDOW,
                             block_size=BLOCK, kv_dtype=kv_dtype,
                             prefill_chunk=CHUNK, spec=spec, spec_k=P_SPEC_K,
                             prefix_cache=False, tp=tp, device=dev).start()
    try:
        if sch.tp != tp:
            raise SystemExit("parallel (a): the scheduler serves tp=%d, "
                             "asked for %d" % (sch.tp, tp))
        sch.submit(prompts[0], 4).result(600)
        passes0 = _passes(sch)
        toks0, secs0 = sch.decode_tokens, sch.decode_seconds
        torch.cuda.synchronize()
        pa.launches = 0
        pa.variant_launches.update(split=0, column=0)
        gemm.launches = 0
        futs = [sch.submit(p, STEPS) for p in prompts]
        outs = [list(f.result(600)) for f in futs]
        torch.cuda.synchronize()
        got = {"passes": _passes(sch) - passes0,
               "paged_attend": pa.launches, "split": pa.variant_launches[
                   "split"], "int8_gemm": gemm.launches,
               "decode_tokens": sch.decode_tokens - toks0,
               "decode_seconds": sch.decode_seconds - secs0}
        snap = sch.metrics()
        got["kv_bytes_per_token"] = snap["kv_bytes_per_token"]
        got["bytes"] = per_chip_bytes({"params": chain_params(chain, sch.tp_),
                                       "pools": sch.cache_.pools})
        got["tp"] = snap["tp"]
        if sch.tp_ is not None:
            _megatron_check(torch, chain, sch.tp_.device_params(chain), tp)
    finally:
        sch.close()
    sch.check_kv()
    return outs, got


def _megatron_check(torch, chain, placed, tp):
    """Every block's per-position tensors are its whole parameters cut
    by P_TP_COLUMNS / P_TP_ROWS (position ``p`` holding the ``p``-th
    slice), or whole."""
    for i, u in enumerate(chain):
        if not hasattr(u, "init_cache"):
            continue
        for name, whole in u.params.items():
            for p in range(tp):
                if name in P_TP_COLUMNS:
                    want = torch.chunk(whole, tp, dim=-1)[p]
                elif name in P_TP_ROWS:
                    want = torch.chunk(whole, tp, dim=0)[p]
                else:
                    want = whole
                got = placed[p][i][name]
                if got.shape != want.shape or not torch.equal(
                        got, want.to(got.device)):
                    raise SystemExit(
                        "parallel (a): unit %d %s on position %d is %s, "
                        "not Megatron's %s" % (i, name, p, tuple(got.shape),
                                               tuple(want.shape)))


def _tp_bytes_want(chain, cache_blocks, kv_dtype, tp):
    """The bytes one position holds at ``tp``: the blocks' Megatron
    shards (P_TP_COLUMNS and P_TP_ROWS cut by tp, the rest whole), the
    embedding and the head whole (they declare no layout), and each
    pool's K/V cut by tp beside its whole row scales."""
    total = 0
    for u in chain:
        block = hasattr(u, "init_cache")
        for name, t in u.params.items():
            cut = tp if tp and block and name in P_TP_COLUMNS + P_TP_ROWS \
                else 1
            total += t.numel() * t.element_size() // cut
        if block:
            d = u.d_model
            item = 1 if kv_dtype == "int8" else u.dtype.itemsize
            rows = cache_blocks * BLOCK
            total += 2 * rows * d * item // max(tp, 1)
            if kv_dtype == "int8":
                total += 2 * rows * 4
    return total


def tp_serve_part(torch, dev):
    """(a): the serving chain (int8_decode off) at tp 0 and tp P_TP."""
    from veles_tpu_torch.convert import init_params
    spec = [{"type": "embedding", "vocab": VOCAB, "dim": DIM}]
    spec += [{"type": "transformer_block", "heads": HEADS}
             for _ in range(LAYERS)]
    spec += [{"type": "token_logits", "vocab": VOCAB}]
    chain = init_params(spec, 0, WINDOW, device=dev, dtype="bfloat16")
    rng = numpy.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist() for _ in range(SLOTS)]
    blocks = SLOTS * -(-WINDOW // BLOCK) + 1
    report, launches = {}, 0
    for kv_dtype, spec_on in (("int8", False), ("int8", True),
                              ("fp32", True)):
        what = "parallel (a) %s spec %s" % (kv_dtype, spec_on)
        base, g0 = tp_arm(torch, dev, chain, prompts, 0, kv_dtype, spec_on)
        outs, g2 = tp_arm(torch, dev, chain, prompts, P_TP, kv_dtype,
                          spec_on)
        ties = same_or_near_tie(torch, dev, chain, base, outs, PROMPT, what)
        per_layer = P_TP if kv_dtype == "int8" else 0
        if g2["paged_attend"] != per_layer * LAYERS * g2["passes"] \
                or g2["split"] != g2["paged_attend"] or g2["int8_gemm"] \
                or g0["paged_attend"] != (per_layer // P_TP) * LAYERS \
                * g0["passes"]:
            raise SystemExit("%s: launches tp 0 %s, tp %d %s (want %d "
                             "paged_attend per pass at tp %d, all split, "
                             "no int8_gemm)" % (what, g0, P_TP, g2,
                                                per_layer * LAYERS, P_TP))
        item = 1 if kv_dtype == "int8" else 2
        scale = 4 if kv_dtype == "int8" else 0
        want_bpt = (LAYERS * 2 * (DIM * item + scale),
                    LAYERS * 2 * (DIM * item // P_TP + scale))
        want_bytes = (_tp_bytes_want(chain, blocks, kv_dtype, 0),
                      _tp_bytes_want(chain, blocks, kv_dtype, P_TP))
        if (g0["kv_bytes_per_token"], g2["kv_bytes_per_token"]) != want_bpt \
                or (g0["bytes"], g2["bytes"]) != want_bytes \
                or (g0["tp"], g2["tp"]) != (0, P_TP):
            raise SystemExit("%s: kv_bytes_per_token %s, per-position bytes "
                             "%s, tp %s (want %s, %s, (0, %d))"
                             % (what, (g0["kv_bytes_per_token"],
                                       g2["kv_bytes_per_token"]),
                                (g0["bytes"], g2["bytes"]),
                                (g0["tp"], g2["tp"]), want_bpt, want_bytes,
                                P_TP))
        launches += g2["paged_attend"]
        report["%s spec %s" % (kv_dtype, "on" if spec_on else "off")] = {
            "equal": ties, "passes": (g0["passes"], g2["passes"]),
            "paged_attend_tp": g2["paged_attend"],
            "kv_bytes_per_token": want_bpt, "position_bytes": want_bytes,
            "decode_tokens_per_s": [g["decode_tokens"] / g["decode_seconds"]
                                    for g in (g0, g2)],
            "step_ms": [1e3 * g["decode_seconds"] / g["passes"]
                        for g in (g0, g2)]}
    log(json.dumps({"parallel_serve": report}))
    return {"paged_attend": launches}


def _mesh_lm(torch, dev, spec, params, mesh):
    """A trainer over ``params`` (host arrays) on ``mesh`` (None: one
    device), f32 compute, ``bench_lm``'s solver."""
    from veles_tpu_torch.convert import params_from_numpy
    from veles_tpu_torch.models.evaluator import EvaluatorNextToken
    from veles_tpu_torch.models.gd import GradientDescent
    chain = params_from_numpy(spec, params, device=dev, dtype="float32")
    shape = (T_SEQ,)
    for u in chain:
        u.in_shape = shape
        shape = tuple(u.out_shape(shape))
    return chain, GradientDescent(chain, EvaluatorNextToken(), solver="sgd",
                                  learning_rate=0.01, gradient_moment=0.9,
                                  mesh=mesh)


def _mesh_steps(torch, gd, batches):
    from veles_tpu_torch.loader import TRAIN
    return [float(gd.run_minibatch(x, x, x.shape[0], TRAIN)[0])
            for x in batches]


def _max_param_err(torch, chain, ref):
    return max(float((u.params[n] - r.params[n]).detach().abs().max())
               for u, r in zip(chain, ref) for n in r.params)


def _peak_from(torch):
    """Starts a peak reading: returns the bytes allocated now, which
    the reading's ``max_memory_allocated`` is taken above.  A mesh
    trainer and its units refer to each other, so the last run's
    tensors go only with a collection."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _losses_err(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def mesh_lm_part(torch, dev):
    """(b): the LM (and the MoE trunk) over each mesh against the
    unsharded run on the card."""
    import math
    from veles_tpu_torch.convert import init_params, params_to_numpy
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.samples.lm import lm_spec
    toks = numpy.random.default_rng(0).integers(
        0, T_VOCAB, (T_BATCH * P_STEPS, T_SEQ))
    batches = [torch.as_tensor(toks[k * T_BATCH:(k + 1) * T_BATCH],
                               device=dev) for k in range(P_STEPS)]
    report, total = {}, dict.fromkeys(fa.launches, 0)
    for moe in (False, True):
        block = {"n_experts": MOE_EXPERTS, "top_k": MOE_TOP_K} if moe else {}
        spec = lm_spec(T_VOCAB, T_DIM, P_LAYERS, T_HEADS, **block)
        params = params_to_numpy(init_params(spec, 0, window=T_SEQ,
                                             device="cpu", dtype="float32"))
        if not moe:
            # the largest unit's parameter bytes (f32)
            unit = max(sum(a.nbytes for a in layer.values())
                       for layer in params.values())
        ref, gd = _mesh_lm(torch, dev, spec, params, None)
        _mesh_steps(torch, gd, batches[:1])     # warm-up, then the state
        del ref, gd
        base = _peak_from(torch)
        ref, gd = _mesh_lm(torch, dev, spec, params, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = _mesh_steps(torch, gd, batches)
        torch.cuda.synchronize()
        report["unsharded%s" % (" moe" if moe else "")] = {
            "losses": want, "step_ms": 1e3 * (time.perf_counter() - t0)
            / P_STEPS,
            "peak_bytes": torch.cuda.max_memory_allocated() - base}
        del gd
        for axes in ((P_MOE_MESH,) if moe else P_MESHES):
            n = math.prod(axes.values())
            old = _positions(n)
            try:
                base = _peak_from(torch)
                chain, gd = _mesh_lm(torch, dev, spec, params, dict(axes))
                torch.cuda.synchronize()
                for name in fa.launches:
                    fa.launches[name] = 0
                t0 = time.perf_counter()
                losses = _mesh_steps(torch, gd, batches)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                got = dict(fa.launches)
            finally:
                _positions(old)
            what = "parallel (b) %s%s" % (axes, " moe" if moe else "")
            groups = axes.get("dp", 1) * axes.get("fsdp", 1)
            per = 0 if axes.get("sp", 1) > 1 else P_LAYERS * groups * (
                axes.get("pp", 1) if "pp" in axes else 1)
            if got != dict.fromkeys(got, per * P_STEPS):
                raise SystemExit("%s: %d steps launched %s (want %d of each)"
                                 % (what, P_STEPS, got, per * P_STEPS))
            l_err = _losses_err(losses, want)
            w_err = _max_param_err(torch, chain, ref)
            if not (numpy.isfinite(losses).all() and l_err <= P_LOSS_TOL
                    and w_err <= P_W_TOL):
                raise SystemExit("%s: losses %s vs %s (%.3g relative), "
                                 "parameters %.3g apart (want %g and %g)"
                                 % (what, losses, want, l_err, w_err,
                                    P_LOSS_TOL, P_W_TOL))
            pos = gd.plan_.position_bytes()
            report[what] = {"losses": losses, "loss_rel_err": l_err,
                            "param_max_abs_err": w_err,
                            "step_ms": 1e3 * wall / P_STEPS,
                            "launches": got,
                            "position_bytes_max": max(pos),
                            "peak_bytes_all_positions": peak,
                            "unsharded_bytes": sum(
                                a.nbytes for layer in params.values()
                                for a in layer.values()) * 2}
            report[what]["gather_peak_bytes"] = gd.plan_.gather_peak_bytes
            for name in total:
                total[name] += got[name]
            del chain, gd
        del ref
        torch.cuda.empty_cache()
    log(json.dumps({"parallel_train": report}))
    # the per-unit gather: under fsdp and tp a group holds one unit's
    # gathered parameters at a time and each slice's gradient is folded
    # as the groups' parts come in, so the step's peak stays within the
    # unsharded step's (dp's for dp x tp) plus twice the largest unit's
    # parameter and gradient bytes
    slack = 2 * 2 * unit
    for axes, over in ((P_FSDP, "unsharded"), (P_DP_TP, str(P_DP))):
        peak = report["parallel (b) %s" % (axes,)][
            "peak_bytes_all_positions"]
        base = report[over]["peak_bytes"] if over == "unsharded" else \
            report["parallel (b) %s" % over]["peak_bytes_all_positions"]
        log("parallel (b) %s: peak %.3f GB, bound %.3f GB (%s's %.3f + %.3f)"
            % (axes, peak / 1e9, (base + slack) / 1e9, over, base / 1e9,
               slack / 1e9))
        if peak > base + slack:
            raise SystemExit("parallel (b) %s: peak %d bytes above %s's %d "
                             "+ %d" % (axes, peak, over, base, slack))
    return total


def mesh_alexnet_part(torch, dev):
    """(c): AlexNet over {"dp": 2} against the unsharded run, f32, from
    one loader's minibatches; the dropout masks must be equal."""
    from veles_tpu_torch.loader import TRAIN
    from veles_tpu_torch.models.dropout import DropoutForward
    from veles_tpu_torch.ops import lrn as lrn_mod, random as rnd
    from veles_tpu_torch.samples.alexnet import ImagenetLoader, build_alexnet
    loader = ImagenetLoader(A_SIDE, A_CLASSES, P_A_BATCH * P_STEPS, 0,
                            minibatch_size=P_A_BATCH, device=dev)
    batches = _minibatches(torch, loader, dev)
    data = [next(batches) for _ in range(P_STEPS)]
    # a throwaway step first: the process's first convolutions pay
    # cuDNN's set-up, which would land on whichever run is timed first
    warm = build_alexnet(minibatch_size=P_A_BATCH, side=A_SIDE,
                         classes=A_CLASSES, n_train=P_A_BATCH * P_STEPS,
                         loader=loader, device=dev, dtype="float32")
    warm.trainer.run_minibatch(*data[0], TRAIN)
    del warm
    runs = {}
    for axes in (None, {"dp": 2}):
        old = _positions(2)
        try:
            net = build_alexnet(minibatch_size=P_A_BATCH, side=A_SIDE,
                                classes=A_CLASSES, n_train=P_A_BATCH
                                * P_STEPS, loader=loader, device=dev,
                                dtype="float32", mesh=axes)
            masks = []
            for u in net.chain:
                if isinstance(u, DropoutForward):
                    draw = u.mask_of

                    def mask_of(shape, key, device, draw=draw):
                        m = draw(shape, key, device)
                        masks.append(m.cpu())
                        return m
                    u.mask_of = mask_of
            torch.cuda.synchronize()
            for name in lrn_mod.launches:
                lrn_mod.launches[name] = 0
            rnd.launches = 0
            t0 = time.perf_counter()
            losses = [float(net.trainer.run_minibatch(x, y, s, TRAIN)[0])
                      for x, y, s in data]
            torch.cuda.synchronize()
            runs[str(axes)] = dict(
                net=net, losses=losses, masks=masks,
                step_ms=1e3 * (time.perf_counter() - t0) / P_STEPS,
                launches=dict(lrn_mod.launches, uniform_fill=rnd.launches))
        finally:
            _positions(old)
    ref, got = runs["None"], runs[str({"dp": 2})]
    want = {"lrn_fwd": 2 * 2 * P_STEPS, "lrn_bwd": 2 * 2 * P_STEPS,
            "uniform_fill": ref["launches"]["uniform_fill"]}
    if got["launches"] != want or want["uniform_fill"] != 2 * P_STEPS:
        raise SystemExit("parallel (c): launched %s (want %s)"
                         % (got["launches"], want))
    if len(got["masks"]) != len(ref["masks"]) or not all(
            torch.equal(a, b) for a, b in zip(got["masks"], ref["masks"])):
        raise SystemExit("parallel (c): the dropout masks differ")
    l_err = _losses_err(got["losses"], ref["losses"])
    w_err = _max_param_err(torch, got["net"].chain, ref["net"].chain)
    log(json.dumps({"parallel_alexnet": {
        "losses": got["losses"], "unsharded": ref["losses"],
        "loss_rel_err": l_err, "param_max_abs_err": w_err,
        "step_ms": got["step_ms"], "unsharded_step_ms": ref["step_ms"],
        "masks_equal": len(got["masks"]), "launches": got["launches"]}}))
    if not l_err <= P_LOSS_TOL or not w_err <= P_W_TOL:
        raise SystemExit("parallel (c): losses %.3g relative, parameters "
                         "%.3g apart (want %g and %g)"
                         % (l_err, w_err, P_LOSS_TOL, P_W_TOL))
    return got["launches"]


def parallel_check(torch, dev):
    """Phase 15: (a) tensor-parallel serving, (b) the trainer over
    meshes, (c) AlexNet over dp, each at full width on positions that
    share the card; returns the kernels' launch counts of the mesh
    runs."""
    t0 = time.perf_counter()
    old = _positions(P_TP)
    try:
        launches = tp_serve_part(torch, dev)
    finally:
        _positions(old)
    log("parallel (a): %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    launches.update(mesh_lm_part(torch, dev))
    log("parallel (b): %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    launches.update(mesh_alexnet_part(torch, dev))
    log("parallel (c): %.1f s" % (time.perf_counter() - t0))
    return launches


# -- phase 16: across processes ---------------------------------------------------

#: phase 16 (``distributed_check``): (a) fault C9 — the serve phase's
#: chain served by a scheduler built from ``root.common.serving`` alone
#: and by one given the same knobs, D_PROMPTS prompts of PROMPT tokens x
#: D_STEPS greedy steps each; (b) AlexNet through the command line's
#: master with D_A_WORKERS spawned workers sharing the card (``-d 0``), at
#: the config's full width, cut to 1 epoch of D_A_TRAIN + D_A_VALID
#: synthetic samples (a job ships the whole model both ways, gzip'd, as
#: the reference's does: ~25 s a job on the card's host, so the epoch is
#: cut to 3 jobs, and the ``-w 1`` run to 2), and a ``-w 1`` run of
#: D_A1_TRAIN + D_A_VALID held against the standalone run
#: of the same weights and minibatches (per minibatch): parameters within
#: D_A_W_TOL absolute, the epoch's validation and train losses within
#: D_A_LOSS_TOL relative.
#: The master adds each worker's delta (new - old, in f32 on the host) to
#: its own parameters: where new and old are within a factor 2 of each
#: other the difference and the sum are exact, elsewhere the sum is one
#: f32 rounding off; and a weight one f32 step away lies across a bf16
#: rounding boundary for about 2^-15 of the weights, moving its bf16 cast
#: by one bf16 step in the next job's products.  D_A_W_TOL bounds that at
#: ~100x an f32 step of AlexNet's largest weights.  (c) a gang of
#: D_GANG processes sharing the card (gloo, staged through the host),
#: each one position of {"dp": D_GANG}, trains ``bench_lm``'s widths cut
#: to P_LAYERS layers for P_STEPS steps in f32 compute, then resumes its
#: pickled trainer over the gang for one more step; then phase 15's
#: pp x dp and sp over the same LM and its ep x dp over the MoE trunk
#: (D_GANG_MESHES), each with its axis across the processes, P_STEPS
#: steps each.  Process 0 trains the unsharded LM and MoE trunk on the
#: same weights and batches first, and holds every mesh's losses to
#: P_LOSS_TOL relative and its parameters to D_GANG_W_TOL absolute
D_PROMPTS, D_STEPS = 4, 16
D_A_WORKERS, D_A_TRAIN, D_A_VALID, D_A_BATCH = 2, 512, 256, 256
#: the ``-w 1`` agreement run's train samples: one train job after the
#: validation job, whose delta the master adds on the host
D_A1_TRAIN = 256
D_A_W_TOL, D_A_LOSS_TOL = 1e-5, 1e-4
#: more ``root.alexnet_tpu`` keys of (b)'s runs (none: the config's
#: width; a rehearsal on the CPU narrows the model here)
D_A_EXTRA = {}
D_GANG = 2
#: (c)'s meshes after {"dp": D_GANG}: (name, axes, MoE trunk, positions
#: per process, the axis laid across the processes — None: the
#: process-major layout, which puts pp across —, given to the trainer
#: in its mesh setting's "__mesh_across__")
D_GANG_MESHES = (("pp", P_PP_DP, False, 2, None), ("sp", P_SP, False, 1, None),
                 ("ep", P_MOE_MESH, True, 2, "ep"))
D_DIR = "_dist_runs"


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def c9_part(torch, dev):
    """(a): two schedulers, one from the tree alone; equal streams and
    launches of kernels 1 and 2."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.ops import gemm, paged_attend as pa
    from veles_tpu_torch.serving import InferenceScheduler
    spec = [{"type": "embedding", "vocab": VOCAB, "dim": DIM}]
    spec += [{"type": "transformer_block", "heads": HEADS,
              "int8_decode": True} for _ in range(LAYERS)]
    spec += [{"type": "token_logits", "vocab": VOCAB}]
    chain = init_params(spec, 0, WINDOW, device=dev, dtype="bfloat16")
    knobs = {"kv_dtype": "int8", "spec": True, "spec_k": 4, "block_size": 16}
    keys = ("kv", "block_size", "kv_blocks", "kv_dtype", "prefill_chunk",
            "warm_buckets", "request_timeout", "watchdog",
            "shed_block_factor", "spec", "spec_k", "drafter", "draft_k_min",
            "draft_ema", "draft_shrink", "draft_grow", "prefix_cache",
            "prefix_evict", "role", "kv_host_bytes", "kv_export_bytes", "tp")
    rng = numpy.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT).tolist()
               for _ in range(D_PROMPTS)]
    tree = root.common.serving
    saved = dict(vars(tree))
    runs = {}
    try:
        tree.update(knobs)
        for name, kw in (("tree", {}), ("explicit", knobs)):
            sch = InferenceScheduler(chain, max_slots=D_PROMPTS,
                                     window=WINDOW, device=dev, **kw)
            read = {k: getattr(sch, k) for k in keys}
            sch.start()
            try:
                sch.submit(prompts[0][:16], 2).result(600)    # warm-up
                torch.cuda.synchronize()
                pa.launches = gemm.launches = 0
                t0 = time.perf_counter()
                futs = [sch.submit(p, D_STEPS) for p in prompts]
                outs = [f.result(600) for f in futs]
                torch.cuda.synchronize()
                runs[name] = dict(read=read, outs=outs,
                                  wall=time.perf_counter() - t0,
                                  launches={"paged_attend": pa.launches,
                                            "int8_gemm": gemm.launches})
            finally:
                sch.close()
            sch.check_kv()
    finally:
        vars(tree).clear()
        vars(tree).update(saved)
    a, b = runs["tree"], runs["explicit"]
    log(json.dumps({"dist_c9": {
        name: {"read": r["read"], "launches": r["launches"],
               "wall_s": r["wall"]} for name, r in runs.items()}}))
    wrong = {k: a["read"][k] for k in knobs if a["read"][k] != knobs[k]}
    if wrong or a["read"] != b["read"]:
        raise SystemExit("dist (a): the tree's scheduler read %s (want %s; "
                         "the explicit one read %s)"
                         % (a["read"], knobs, b["read"]))
    if a["outs"] != b["outs"] or any(
            len(o) != PROMPT + D_STEPS for o in a["outs"]):
        raise SystemExit("dist (a): the streams differ")
    if a["launches"] != b["launches"] or not all(a["launches"].values()):
        raise SystemExit("dist (a): launches %s vs %s"
                         % (a["launches"], b["launches"]))
    del chain
    torch.cuda.empty_cache()
    return a["launches"]


def _alexnet_keys(train):
    return "root.alexnet_tpu.update(%r)" % dict(
        synthetic_train=train, synthetic_valid=D_A_VALID, max_epochs=1,
        minibatch_size=D_A_BATCH, snapshot_time_interval=1e9, **D_A_EXTRA)


def _master_run(torch, dev, d, workers, train):
    """The command line's master (in process) with ``workers`` spawned
    workers; returns (the run, its results, the epoch rows the master's
    decision closed)."""
    import os
    from veles_tpu_torch.models.gd import GradientDescent
    closed = []
    read = GradientDescent.read_epoch_acc

    def recording(self, reset_classes=(), as_array=False):
        got = read(self, reset_classes, as_array)
        if self.is_master and len(reset_classes):
            rows = got if as_array else numpy.array(
                [got[c] for c in range(3)])
            closed.append({int(c): float(rows[c][2])
                           for c in reset_classes})
        return got

    result = os.path.join(d, "master%d.json" % workers)
    argv = [_sample("alexnet.py"), _sample("alexnet_config.py"),
            "-c", _alexnet_keys(train),
            "-c", "root.common.dirs.snapshots = %r"
            % os.path.join(d, "snaps%d" % workers),
            "-l", "127.0.0.1:%d" % _free_port(), "-w", str(workers),
            "--result-file", result]
    if dev.type == "cpu":
        argv += ["-a", "cpu"]
    GradientDescent.read_epoch_acc = recording
    try:
        run = _CliRun(argv)
    finally:
        GradientDescent.read_epoch_acc = read
    return run, _results(result), closed


def master_worker_part(torch, dev):
    """(b): AlexNet through the master and its workers."""
    import os
    import shutil
    from veles_tpu_torch import prng
    from veles_tpu_torch.samples.alexnet import AlexNetWorkflow
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), D_DIR)
    os.makedirs(d, exist_ok=True)
    try:
        # the standalone run, per minibatch as a worker runs its jobs
        torch.cuda.synchronize()
        prng.get().seed(42)
        t0 = time.perf_counter()
        wf = AlexNetWorkflow(synthetic_train=D_A1_TRAIN,
                             synthetic_valid=D_A_VALID, max_epochs=1,
                             minibatch_size=D_A_BATCH, weights_seed=None,
                             snapshotter_config={"enabled": False},
                             **D_A_EXTRA)
        wf.loader.span_serving = False
        wf.initialize(device=dev)
        wf.run()
        torch.cuda.synchronize()
        alone = {"wall": time.perf_counter() - t0,
                 "params": _host_params(wf.gd.forwards),
                 "history": list(wf.decision.history)}
        wf.stop()
        del wf
        torch.cuda.empty_cache()
        runs = {}
        for workers, train in ((1, D_A1_TRAIN), (D_A_WORKERS, D_A_TRAIN)):
            torch.cuda.synchronize()
            run, res, closed = _master_run(torch, dev, d, workers, train)
            runs[workers] = dict(
                wall=run.wall, res=res, closed=closed, train=train,
                params=_host_params(run.workflow.gd.forwards),
                history=list(run.workflow.decision.history))
            del run
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    report = {"standalone_wall_s": alone["wall"]}
    for workers, r in runs.items():
        res = r["res"]
        counted = {c: sum(row.get(c, 0.0) for row in r["closed"])
                   for c in (1, 2)}
        reports = res.get("Workers", [])
        report["w%d" % workers] = {
            "wall_s": r["wall"], "coordinator": res.get("Coordinator"),
            "workers": reports, "samples_counted": counted,
            "closed": r["closed"],
            "history": r["history"]}
        # the epoch's closes: its validation, then its train span (an
        # idle worker may take the next epoch's first jobs meanwhile,
        # as in the reference: their closes come after, and are shown)
        evals = [row[1] for row in r["closed"] if 1 in row]
        trains = [row[2] for row in r["closed"] if 2 in row]
        if not evals or not trains or evals[0] != D_A_VALID \
                or trains[0] != r["train"]:
            raise SystemExit("dist (b) -w %d: the master closed %s (want "
                             "each of the %d samples once)"
                             % (workers, r["closed"], r["train"] + D_A_VALID))
        stats = res["Coordinator"]
        if stats["updates"] < (r["train"] + D_A_VALID) // D_A_BATCH:
            raise SystemExit("dist (b) -w %d: %s" % (workers, stats))
    one = runs[1]
    w_err = max(v for dd in _max_diff(torch, one["params"], alone["params"])
                for v in dd.values())
    keys = ("validation_loss", "train_loss")
    want = [h[k] for h in alone["history"] for k in keys]
    got = [h[k] for h in one["history"] for k in keys]
    l_err = max(abs(a - b) / abs(b) for a, b in zip(got, want)) \
        if len(got) == len(want) and want else float("inf")
    report["w1_vs_standalone"] = {"param_max_abs_err": w_err,
                                  "loss_rel_err": l_err,
                                  "losses": [got, want]}
    log(json.dumps({"dist_master_worker": report}))
    if not (w_err <= D_A_W_TOL and l_err <= D_A_LOSS_TOL):
        raise SystemExit("dist (b): -w 1 parameters %.3g from the "
                         "standalone run, losses %.3g relative "
                         "(want %g and %g)" % (w_err, l_err, D_A_W_TOL,
                                               D_A_LOSS_TOL))
    for workers, r in runs.items():
        reports = r["res"]["Workers"]
        if len(reports) != workers or any(
                w["rc"] != 0 or not all(w["launches"][k] for k in (
                    "lrn_fwd", "lrn_bwd", "uniform_fill"))
                for w in reports):
            raise SystemExit("dist (b) -w %d: the workers reported %s"
                             % (workers, reports))
    launches = {}
    for name in ("lrn_fwd", "lrn_bwd", "uniform_fill"):
        launches[name] = sum(w["launches"][name]
                             for r in runs.values()
                             for w in r["res"]["Workers"])
    return launches


def _gang_sizes():
    return {"vocab": T_VOCAB, "dim": T_DIM, "heads": T_HEADS,
            "seq": T_SEQ, "batch": T_BATCH, "layers": P_LAYERS,
            "steps": P_STEPS, "experts": MOE_EXPERTS, "top_k": MOE_TOP_K}


def gang_flash_want(name, rank):
    """Kernel 3's launches per step (of each of its three kernels) in
    gang process ``rank`` under mesh ``name``: {"dp": 2}: its group's
    P_LAYERS layers; pp x dp: its stage's P_LAYERS / 2 layers in both
    groups, 2 microbatches each (both homes and stage 0 are process 0's,
    stage 1 process 1's); sp: none (the ring replaces the kernel, as in
    the reference); ep x dp: both groups' P_LAYERS attention layers in
    process 0, which holds their homes, none in process 1 (its positions
    hold expert slices)."""
    return {"dp": P_LAYERS, "pp": P_LAYERS // 2 * 2 * 2, "sp": 0,
            "ep": 2 * P_LAYERS if rank == 0 else 0}[name]


def _gang_mesh(torch, dev, spec, params, batches, name, axes, per, across):
    """One mesh of (c) over the gang: its crossing, losses (hex), step
    ms, the gang's traffic per step, peak memory and kernel 3 launches,
    and its parameters gathered on the host."""
    from veles_tpu_torch.loader import TRAIN
    from veles_tpu_torch.ops import flash_attention as fa
    from veles_tpu_torch.parallel import multihost
    old = _positions(per)
    try:
        # the trainer's mesh setting, as root.common.mesh gives it
        chain, gd = _mesh_lm(torch, dev, spec, params, {
            "__mesh_axes__": axes, "__mesh_across__": across} if across
            else axes)
        mesh = gd.mesh
        axis = name if name in axes else "dp"
        crossing = sorted({mesh.process(p) for p in mesh.along(0, axis)})
        if crossing != list(range(D_GANG)):
            raise SystemExit("dist (c) %s: the %s axis lies in processes %s"
                             % (name, axis, crossing))
        if not gd.plan_.gang:
            raise SystemExit("the trainer's mesh spans one process")
        # both processes start the timed steps together
        multihost.sync_global_devices(name)
        base = _peak_from(torch) if dev.type == "cuda" else 0
        for k in fa.launches:
            fa.launches[k] = 0
        before = dict(multihost.STATS)
        t0 = time.perf_counter()
        losses = [float(gd.run_minibatch(x, x, x.shape[0], TRAIN)[0])
                  for x in batches[:P_STEPS]]
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        got = {"mesh": axes, "positions_per_process": per,
               "losses": [v.hex() for v in losses],
               "step_ms": 1e3 * wall / P_STEPS,
               "launches": dict(fa.launches),
               "stats_per_step": {k: (multihost.STATS[k] - before[k])
                                  / P_STEPS for k in before},
               "peak_bytes": (torch.cuda.max_memory_allocated() - base
                              if dev.type == "cuda" else None)}
        # every process reads the parameters whole (a gather may cross
        # the gang); process 0 compares them
        gathered = [{n: t.detach().cpu() for n, t in u.params.items()}
                    for u in chain]
        return got, gathered, gd
    finally:
        _positions(old)


def _gang_compare(torch, got, gathered, want, ref):
    got["loss_rel_err"] = _losses_err(
        [float.fromhex(h) for h in got["losses"]], want)
    got["param_max_abs_err"] = max(
        float((g[n] - r[n]).abs().max())
        for g, r in zip(gathered, ref) for n in r)


def gang_worker(address, nproc, rank, sizes):
    """One process of (c) at ``sizes`` (the parent's widths, as JSON), on
    the card (no card: it fails); prints a ``GANG {json}`` line."""
    import torch
    return gang_run(torch.device("cuda"), address, nproc, rank, sizes)


def gang_run(dev, address, nproc, rank, sizes):
    """(c)'s process ``rank`` on ``dev``."""
    import gc
    import pickle
    import torch
    from veles_tpu_torch.convert import init_params, params_to_numpy
    from veles_tpu_torch.loader import TRAIN
    from veles_tpu_torch.parallel import multihost
    from veles_tpu_torch.samples.lm import lm_spec
    global T_VOCAB, T_DIM, T_HEADS, T_SEQ, T_BATCH, P_LAYERS, P_STEPS
    global MOE_EXPERTS, MOE_TOP_K
    z = json.loads(sizes)
    T_VOCAB, T_DIM, T_HEADS, T_SEQ, T_BATCH = (
        z["vocab"], z["dim"], z["heads"], z["seq"], z["batch"])
    P_LAYERS, P_STEPS = z["layers"], z["steps"]
    MOE_EXPERTS, MOE_TOP_K = z["experts"], z["top_k"]
    nproc, rank = int(nproc), int(rank)
    gang = multihost.initialize(address, nproc, rank, device=dev)
    out = {"rank": rank, "transport": gang.transport, "card": card_line()
           if dev.type == "cuda" else None, "meshes": {}}
    try:
        specs, params = {}, {}
        for moe in (False, True):
            block = {"n_experts": MOE_EXPERTS, "top_k": MOE_TOP_K} \
                if moe else {}
            specs[moe] = lm_spec(T_VOCAB, T_DIM, P_LAYERS, T_HEADS, **block)
            params[moe] = params_to_numpy(init_params(
                specs[moe], 0, window=T_SEQ, device="cpu", dtype="float32"))
        toks = numpy.random.default_rng(0).integers(
            0, T_VOCAB, (T_BATCH * (P_STEPS + 1), T_SEQ))
        batches = [torch.as_tensor(toks[k * T_BATCH:(k + 1) * T_BATCH],
                                   device=dev) for k in range(P_STEPS + 1)]
        refs = {}
        if rank == 0:
            # the unsharded runs on the same weights and batches
            for moe in (False, True):
                ref, rgd = _mesh_lm(torch, dev, specs[moe], params[moe],
                                    None)
                want = [float(rgd.run_minibatch(x, x, x.shape[0],
                                                TRAIN)[0])
                        for x in batches[:P_STEPS]]
                refs[moe] = (want, [{n: t.detach().cpu()
                                     for n, t in u.params.items()}
                                    for u in ref])
                del ref, rgd
            gc.collect()
            _empty_cache(torch, dev)
        got, gathered, gd = _gang_mesh(torch, dev, specs[False],
                                       params[False], batches, "dp",
                                       {"dp": nproc}, 1, None)
        if rank == 0:
            _gang_compare(torch, got, gathered, *refs[False])
        # the pickled trainer resumes over the gang
        gd2 = pickle.loads(pickle.dumps(gd))
        if gd2.mesh != {"__mesh_axes__": {"dp": nproc}}:
            raise SystemExit("the mesh pickled as %r" % (gd2.mesh,))
        for u in gd2.forwards:
            u.to_device(dev)
        gd2._setup()
        if not gd2.mesh.spans_processes:
            raise SystemExit("the resumed mesh spans one process")
        if any(not torch.equal(u.params[n].cpu(), g[n])
               for u, g in zip(gd2.forwards, gathered) for n in g):
            raise SystemExit("the resumed parameters differ")
        x = batches[P_STEPS]
        got["resumed_loss"] = float(gd2.run_minibatch(
            x, x, x.shape[0], TRAIN)[0]).hex()
        out["meshes"]["dp"] = got
        del gd, gd2, gathered
        for name, axes, moe, per, across in D_GANG_MESHES:
            gc.collect()
            _empty_cache(torch, dev)
            got, gathered, gd = _gang_mesh(torch, dev, specs[moe],
                                           params[moe], batches, name,
                                           axes, per, across)
            if rank == 0:
                _gang_compare(torch, got, gathered, *refs[moe])
            out["meshes"][name] = got
            del gd, gathered
        multihost.sync_global_devices("done")
    finally:
        multihost.shutdown()
    print("GANG " + json.dumps(out), flush=True)
    return 0


def _empty_cache(torch, dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def start_gang():
    """(c)'s D_GANG processes of this script, started in the background
    (from phase 12 on) and read by :func:`gang_part`."""
    address = "127.0.0.1:%d" % _free_port()
    here = os.path.abspath(__file__)
    return [subprocess.Popen(
        [sys.executable, here, "--gang-worker", address, str(D_GANG),
         str(r), json.dumps(_gang_sizes())], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=os.path.dirname(here))
        for r in range(D_GANG)]


def gang_part(torch, dev, procs):
    """(c): the gang's processes (:func:`start_gang`); returns their
    kernel 3 launches."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        lines = [l for l in text.splitlines() if l.startswith("GANG ")]
        if p.returncode != 0 or len(lines) != 1:
            raise SystemExit("dist (c): process %d rc=%s:\n%s"
                             % (r, p.returncode, text[-3000:]))
        got.append(json.loads(lines[0][5:]))
    log(json.dumps({"dist_gang": got}))
    first = got[0]
    # the processes share one card: NCCL refuses that, so gloo
    if first["transport"] != "gloo":
        raise SystemExit("dist (c): transport %s" % first["transport"])
    if any(g["meshes"]["dp"]["resumed_loss"]
           != first["meshes"]["dp"]["resumed_loss"] for g in got):
        raise SystemExit("dist (c): the processes' resumed losses differ")
    total = {}
    for name in ["dp"] + [m[0] for m in D_GANG_MESHES]:
        mine = first["meshes"][name]
        if any(g["meshes"][name]["losses"] != mine["losses"] for g in got):
            raise SystemExit("dist (c) %s: the processes' losses differ"
                             % name)
        if not (mine["loss_rel_err"] <= P_LOSS_TOL
                and mine["param_max_abs_err"] <= D_GANG_W_TOL):
            raise SystemExit("dist (c) %s: %.3g relative on the losses, "
                             "parameters %.3g apart (want %g and %g)"
                             % (name, mine["loss_rel_err"],
                                mine["param_max_abs_err"], P_LOSS_TOL,
                                D_GANG_W_TOL))
        for g in got:
            per = gang_flash_want(name, g["rank"]) * P_STEPS
            launches = g["meshes"][name]["launches"]
            if launches != dict.fromkeys(launches, per):
                raise SystemExit("dist (c) %s: process %d launched %s (want "
                                 "%d of each)" % (name, g["rank"], launches,
                                                  per))
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        log("dist (c) %s: %s" % (name, json.dumps([{
            "rank": g["rank"], "step_ms": g["meshes"][name]["step_ms"],
            "stats_per_step": g["meshes"][name]["stats_per_step"],
            "peak_bytes": g["meshes"][name]["peak_bytes"],
            "card": g["card"]} for g in got])))
    return total


#: (c)'s agreement with the unsharded run: phase 15's
D_GANG_W_TOL = 1e-6


def distributed_check(torch, dev, gang, job):
    """Phase 16: (a) fault C9, (b) the master and its workers (run by
    the background job), (c) the gang (started by :func:`start_gang`);
    returns the kernels' launch counts of its runs."""
    t0 = time.perf_counter()
    launches = c9_part(torch, dev)
    log("dist (a): %.1f s" % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    got = job.wait("dist")
    launches.update(got["launches"])
    log("dist (b): %.1f s in the background, %.1f s waited"
        % (got["seconds"], time.perf_counter() - t0))
    t0 = time.perf_counter()
    launches.update(gang_part(torch, dev, gang))
    log("dist (c): %.1f s waited" % (time.perf_counter() - t0))
    return launches


# -- phase 17: the serving fleet and its observability -------------------------

#: the fleet phase (``bench.py``'s ``bench_router``): FLEET_PROMPT-token
#: prompts x FLEET_STEPS greedy steps from 2·n·FLEET_SLOTS clients of
#: FLEET_REQUESTS requests each, at n in FLEET_COUNTS replicas of
#: FLEET_SLOTS slots; FLEET_PROBES one-step TTFT probes; (b)'s
#: FLEET_ROUTED prompts and FLEET_KILLS kill/respawn cycles; (c)'s
#: FLEET_RATE_RUNS on/off runs of FLEET_RATE_REQUESTS requests of
#: FLEET_RATE_STEPS steps and FLEET_TICKS timed alert ticks; (d)'s burst
#: of FLEET_BURST clients
#: (FLEET_REQUESTS cut from 4 to 2 and FLEET_RATE_STEPS from 256 to 128
#: for the smoke's time limit)
FLEET_PROMPT, FLEET_STEPS, FLEET_SLOTS, FLEET_REQUESTS = 128, 64, 4, 2
FLEET_COUNTS, FLEET_PROBES = (1, 2), 12
FLEET_ROUTED, FLEET_KILLS = 8, 3
FLEET_RATE_RUNS, FLEET_RATE_REQUESTS, FLEET_RATE_STEPS = 3, 4, 128
#: the on-arm's store and engine tick at 4 Hz, four times the shipped
#: 1 s cadence, so each sub-second run holds several ticks
FLEET_RATE_INTERVAL = 0.25
FLEET_TICKS, FLEET_BURST = 200, 16
#: memory after the fleet stops, against before it started
FLEET_MEMORY_TOL = 0.01
#: a shared card and one interpreter: what every fleet rate measures
FLEET_SHARED = ("replicas share one card and one interpreter: each pass's "
                "host sync waits on the other replicas' work and the "
                "scheduler threads contend for the GIL, so rates measure "
                "shared host and card, not fleet scaling")


def serve_spec():
    """The serve phase's layer spec (``int8_decode`` on)."""
    spec = [{"type": "embedding", "vocab": VOCAB, "dim": DIM}]
    spec += [{"type": "transformer_block", "heads": HEADS,
              "int8_decode": True} for _ in range(LAYERS)]
    spec += [{"type": "token_logits", "vocab": VOCAB}]
    return spec


def _fleet_chain(dev, spec, params):
    """A replica's own copy of one numpy draw of the weights (the port's
    weight carry-across), bf16, ``int8_decode`` on every block."""
    from veles_tpu_torch.convert import params_from_numpy
    chain = params_from_numpy(spec, params, device=dev, dtype="bfloat16")
    for u in chain:
        if hasattr(u, "int8_decode"):
            u.int8_decode = True
    return chain


def _fleet_spawner(dev, spec, params, made):
    """``Fleet``'s spawn: a ``LocalReplica`` around a ``RESTfulAPI`` at
    the REST defaults (int8 KV, block 16, spec and the prefix cache as
    ``root.common.serving`` has them) over its own copy of the
    weights."""
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.serving import LocalReplica

    def spawn(index, role=None):
        api = RESTfulAPI(forwards=_fleet_chain(dev, spec, params),
                         max_slots=FLEET_SLOTS, max_queue=256,
                         request_timeout=600.0, serving_kv_dtype="int8",
                         serving_block_size=BLOCK, device=dev)
        api.initialize()
        made.append(api.replica_id)
        return LocalReplica(api)
    return spawn


def _url_call(url, path, body=None, headers=None, timeout=600):
    """One request through the router: (status, headers, JSON body);
    error statuses are returned."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        resp = e
    raw = resp.read()
    code = resp.status if hasattr(resp, "status") else resp.code
    try:
        return code, resp.headers, json.loads(raw)
    except ValueError:
        return code, resp.headers, raw


def _router_sse(url, body):
    """An SSE ``/generate`` through the router: each frame's payload and
    arrival stamp, and the X-Veles-Replica it was pinned to."""
    import urllib.request
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=600)
    frames = []
    try:
        pinned = resp.headers["X-Veles-Replica"]
        for line in resp:
            if line.strip() == b"data: [DONE]":
                break
            if line.startswith(b"data: "):
                frames.append((time.perf_counter(), json.loads(line[6:])))
    finally:
        resp.close()
    return frames, pinned


def _fleet_wait(what, cond, limit=120.0):
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit("fleet: timed out waiting for " + what)
        time.sleep(0.05)


def _fleet_live(router):
    return [r for r in router.replica_state()["replicas"] if r["healthy"]]


def _replica_launches(torch, handle, body):
    """One request sent to the replica itself with the serving kernels'
    counts zeroed just before and read just after (every other replica
    idle): its launches and its scheduler's model passes."""
    sch = handle.api.scheduler_
    torch.cuda.synchronize()
    passes0 = _passes(sch)
    zero_serving_counts()
    code, _, reply = _http(handle.port, "/generate", body)
    torch.cuda.synchronize()
    got = read_serving_counts()
    if code != 200:
        raise SystemExit("fleet (a): replica %s answered %d"
                         % (handle.replica_id, code))
    return got, _passes(sch) - passes0


def fleet_load(torch, dev, spec, params, n, prompt):
    """Part (a) at ``n`` replicas: a Router over a Fleet of LocalReplicas,
    FLEET_PROBES one-step probes (TTFT through the router), then 2·n·
    FLEET_SLOTS clients of FLEET_REQUESTS requests with the serving
    kernels' counts zeroed just before and read just after: no failed
    request, every reply FLEET_STEPS new tokens, the launches 8 and 24
    per model pass of the fleet; then each replica alone, its launches
    above 0 and 8/24 per its own passes.  Returns the numbers and the
    launches."""
    from veles_tpu_torch.serving import Fleet, Router
    made = []
    router = Router(health_interval=0.5, request_timeout=600.0).start()
    fleet = Fleet(_fleet_spawner(dev, spec, params, made), n,
                  router=router).start()
    try:
        _fleet_wait("%d healthy replicas" % n,
                    lambda: len(_fleet_live(router)) >= n)
        url = router.url
        body = {"prompt": prompt, "steps": FLEET_STEPS}
        for h in fleet.handles().values():   # warm each replica
            if _http(h.port, "/generate", body)[0] != 200:
                raise SystemExit("fleet (a): a warm-up request failed")
        probes = []
        for _ in range(FLEET_PROBES):
            t0 = time.perf_counter()
            code, _, _ = _url_call(url, "/generate",
                                   {"prompt": prompt, "steps": 1})
            probes.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                raise SystemExit("fleet (a): a probe answered %d" % code)
        clients = 2 * n * FLEET_SLOTS
        replies, fails = [], []

        def client(c):
            for k in range(FLEET_REQUESTS):
                code, _, out = _url_call(url, "/generate",
                                         dict(body, seed=k))
                if code != 200:
                    fails.append(code)
                else:
                    replies.append(out["tokens"])

        handles = fleet.handles()
        passes0 = {i: _passes(h.api.scheduler_) for i, h in handles.items()}
        torch.cuda.synchronize()
        zero_serving_counts()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_serving_counts()
        passes = {i: _passes(h.api.scheduler_) - passes0[i]
                  for i, h in handles.items()}
        if fails or len(replies) != clients * FLEET_REQUESTS \
                or any(len(r) != FLEET_PROMPT + FLEET_STEPS
                       or r[:FLEET_PROMPT] != prompt for r in replies):
            raise SystemExit("fleet (a): %d failed requests (%s), %d "
                             "replies of %d" % (len(fails), fails[:5],
                                                len(replies),
                                                clients * FLEET_REQUESTS))
        check_pass_launches("fleet (a) n=%d" % n, sum(passes.values()), got)
        per = {}
        for i, h in sorted(handles.items()):
            own, own_passes = _replica_launches(torch, h, body)
            check_pass_launches("fleet (a) replica %d alone" % i,
                                own_passes, own)
            per[h.replica_id] = {"paged_attend": own["paged_attend"],
                                 "int8_gemm": own["int8_gemm"],
                                 "passes": own_passes,
                                 "load_passes": passes[i]}
        state = router.replica_state()["router"]
    finally:
        fleet.stop()
        router.stop()
    probes.sort()
    numbers = {
        "replicas": n, "clients": clients, "requests": len(replies),
        "failed": len(fails),
        "aggregate_tokens_per_s": len(replies) * FLEET_STEPS / wall,
        "wall_s": wall,
        "ttft_p95_ms": probes[int(0.95 * (len(probes) - 1))],
        "ttft_p50_ms": probes[len(probes) // 2],
        "passes": sum(passes.values()),
        "launches": {k: got[k] for k in ("paged_attend", "int8_gemm")},
        "per_replica_alone": per,
        "router_request_ms_p95": state.get("request_ms_p95")}
    if n > 1:
        numbers["note"] = FLEET_SHARED
    return numbers, {k: got[k] for k in ("paged_attend", "int8_gemm")}


def fleet_failover(torch, dev, trained, pattern, launches):
    """Part (b) and (c), on the spec phase's trained chain with 2
    replicas (each its own copy of one numpy draw): FLEET_ROUTED greedy
    prompts through the router, concurrently, equal to the direct
    scheduler's; a 64-token greedy stream killed mid-stream by
    ``router.stream.replica_death`` and spliced from the peer, equal to
    the uninterrupted one with no error frame; ``rolling_restart``
    under 8 clients with no failed request; FLEET_KILLS kill/respawn
    cycles; each survivor's pool clean; then (c) the observability
    checks; after the fleet stops, ``memory_allocated`` back within
    FLEET_MEMORY_TOL of its value before."""
    import gc
    from veles_tpu_torch import faults
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import params_to_numpy
    from veles_tpu_torch.samples.lm import lm_spec
    from veles_tpu_torch.serving import Fleet, InferenceScheduler, Router
    out = {}
    spec = lm_spec(VOCAB, DIM, LAYERS, HEADS)
    params = params_to_numpy(trained)
    prompts = [(pattern * 12)[i:i + SPEC_PROMPT]
               for i in range(FLEET_ROUTED)]
    steps = FLEET_STEPS
    sch = InferenceScheduler(trained, max_slots=FLEET_SLOTS, window=WINDOW,
                             block_size=BLOCK, kv_dtype="int8",
                             device=dev).start()
    try:
        direct = [f.result(600) for f in
                  [sch.submit(p, steps) for p in prompts]]
    finally:
        sch.close()
    del sch
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    threads0 = {t.ident for t in threading.enumerate()}
    saved = {"interval": root.common.alerts.get("interval", 1.0)}
    root.common.alerts.interval = 0.1
    made = []
    router = Router(health_interval=0.1, health_timeout=5.0,
                    request_timeout=600.0, retries=4, retry_delay=0.02,
                    retry_cap=0.2).start()
    fleet = Fleet(_fleet_spawner(dev, spec, params, made), 2,
                  router=router, monitor_interval=0.25, spawn_retries=2,
                  spawn_delay=0.05).start()
    url = router.url
    try:
        _fleet_wait("2 healthy replicas", lambda: len(_fleet_live(router)) == 2)
        mem = out["memory_allocated_by_step"] = [
            ("2 replicas up", torch.cuda.memory_allocated())]
        passes0 = sum(_passes(h.api.scheduler_)
                      for h in fleet.handles().values())
        torch.cuda.synchronize()
        zero_serving_counts()
        results = [None] * len(prompts)

        def routed(i):
            results[i] = _url_call(url, "/generate",
                                   {"prompt": prompts[i], "steps": steps})

        threads = [threading.Thread(target=routed, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        torch.cuda.synchronize()
        got = read_serving_counts()
        check_pass_launches("fleet (b)", sum(
            _passes(h.api.scheduler_) for h in fleet.handles().values())
            - passes0, got)
        for k in launches:
            launches[k] += got[k]
        if any(r is None or r[0] != 200 or r[2]["tokens"] != d
               for r, d in zip(results, direct)):
            raise SystemExit("fleet (b): a routed greedy reply differs from "
                             "the direct scheduler's: %s"
                             % [r and (r[0], r[2].get("tokens") == d)
                                for r, d in zip(results, direct)])
        out["routed_equal_direct"] = len(prompts)
        # the replayable stream killed mid-way and spliced from the peer
        faults.inject("router.stream.replica_death", "drop", after=2,
                      times=1)
        frames, pinned = _router_sse(url, {"prompt": prompts[0],
                                           "steps": steps})
        faults.clear("router.stream.replica_death")
        toks = [f["token"] for _, f in frames if "token" in f]
        final = frames[-1][1] if frames else {}
        errors = [f for _, f in frames if "error" in f]
        resumed = router.stats.snapshot()["stream_failovers"].get(
            "resumed", 0)
        if errors or prompts[0] + toks != direct[0] \
                or final.get("tokens") != direct[0] or resumed != 1:
            raise SystemExit("fleet (b): the failed-over stream differs "
                             "(errors %s, resumed %d)" % (errors, resumed))
        stamps = [t for t, f in frames if "token" in f]
        gaps = token_gaps([stamps])
        out["failover_stream_resume_ms"] = (stamps[2] - stamps[1]) * 1e3
        out["stream_gap_ms_median"] = sorted(gaps)[len(gaps) // 2]
        # a rolling restart under 8 clients
        stop, fails, served = threading.Event(), [], [0]

        def client(i):
            k = 0
            while not stop.is_set():
                code, _, r = _url_call(url, "/generate", {
                    "prompt": prompts[(i + k) % len(prompts)],
                    "steps": 16})
                if code != 200:
                    fails.append(code)
                else:
                    served[0] += 1
                k += 1

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        report = fleet.rolling_restart(drain_timeout=120)
        out["rolling_restart_s"] = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(600)
        if fails or len(report) != 2:
            raise SystemExit("fleet (b): the rolling restart failed %d "
                             "requests (%s)" % (len(fails), fails[:5]))
        out["rolling_restart_served"] = served[0]
        gc.collect()
        mem.append(("rolling restart", torch.cuda.memory_allocated()))
        # kill/respawn cycles
        t_respawn = []
        for c in range(FLEET_KILLS):
            idx = c % 2
            old = fleet.replica_id(idx)
            t0 = time.perf_counter()
            fleet.handles()[idx].stop()
            _fleet_wait("the respawn of replica %d" % idx, lambda: (
                fleet.replica_id(idx) != old
                and fleet.handles().get(idx) is not None
                and fleet.handles()[idx].alive()
                and len(_fleet_live(router)) == 2))
            t_respawn.append(time.perf_counter() - t0)
            gc.collect()
            mem.append(("kill %d" % c, torch.cuda.memory_allocated()))
        out["respawn_s"] = t_respawn
        _fleet_pools_clean(fleet)
        code, _, r = _url_call(url, "/generate", {"prompt": prompts[1],
                                                  "steps": steps})
        if code != 200 or r["tokens"] != direct[1]:
            raise SystemExit("fleet (b): a respawned fleet's reply differs")
        out["c"] = fleet_observability(torch, router, fleet)
    finally:
        faults.clear()
        fleet.stop()
        router.stop()
        root.common.alerts.interval = saved["interval"]
    del fleet, router
    _fleet_wait("the replicas' threads to end", lambda: not [
        t for t in threading.enumerate() if t.ident not in threads0
        and t.name.startswith(("serving-scheduler", "serving-watchdog",
                               "restful-api", "tsdb-", "alerts-"))],
        limit=60)
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    out["memory_allocated_before_after"] = [mem0, mem1]
    out["replicas_made"] = len(made)
    if abs(mem1 - mem0) > FLEET_MEMORY_TOL * mem0:
        raise SystemExit("fleet (b): memory_allocated %d after the fleet "
                         "stopped, %d before it started (%d replicas "
                         "made); still alive: %s"
                         % (mem1, mem0, len(made), _fleet_survivors()))
    return out


def _fleet_survivors():
    """What keeps a stopped replica's objects alive: each live
    RESTfulAPI and InferenceScheduler with its referrers' types, and
    the live threads' names."""
    import gc
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.serving import InferenceScheduler
    gc.collect()
    rows = []
    for obj in gc.get_objects():
        if isinstance(obj, (RESTfulAPI, InferenceScheduler)):
            refs = []
            for r in gc.get_referrers(obj):
                if isinstance(r, dict):
                    owners = [type(o).__name__ for o in gc.get_referrers(r)
                              if not isinstance(o, list)][:3]
                    refs.append("dict(%s) of %s" % (sorted(r)[:4], owners))
                else:
                    refs.append(type(r).__name__)
            rows.append((type(obj).__name__, refs[:6]))
    return {"objects": rows[:12],
            "threads": sorted(t.name for t in threading.enumerate())}


def _fleet_pools_clean(fleet):
    """Every live replica's KV pool swept clean: no block held beyond the
    prefix cache's residents (a function of its own, so no local keeps
    a replica alive past the fleet's stop)."""
    for handle in fleet.handles().values():
        sch = handle.api.scheduler_
        sch.check_kv()
        if sch.cache_.used_blocks != sch.prefix_cache_blocks_resident:
            raise SystemExit("fleet (b): replica %s's pool leaked blocks"
                             % handle.replica_id)


def _hand_summed(texts):
    """The fleet view of in-process replicas' scrapes, summed by hand:
    every unlabeled ``veles_serving_*_total`` counter's value summed
    over the scrapes."""
    total = {}
    for text in texts:
        kinds = {}
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, kind = line.split()
                kinds[name] = kind
            elif line and not line.startswith("#") and "{" not in line:
                name, value = line.rsplit(" ", 1)
                if name.startswith("veles_serving_") \
                        and kinds.get(name) == "counter":
                    total[name] = total.get(name, 0.0) + float(value)
    return total


def fleet_observability(torch, router, fleet):
    """Part (c) on (b)'s fleet: one replica killed with its respawn
    pinned failing (``fleet.replica.spawn``) and the supervisor's
    monitor slowed past the rule's hold-down: the router's
    ``replica_unreachable`` fires after its hold-down and resolves, and
    the replica comes back; ``/metrics/fleet`` equal to the hand-summed
    replica scrapes; ``/metrics/history`` on the router and a replica;
    ``/dashboard``; a flight-recorder bundle's ``alerts`` and
    ``history``; the alert engine's tick over the live registry."""
    from veles_tpu_torch import faults
    from veles_tpu_torch.telemetry.alerts import AlertEngine, default_rules
    from veles_tpu_torch.telemetry.flight_recorder import recorder
    url, out = router.url, {}
    rule = next(r for r in default_rules() if r.name == "replica_unreachable")
    idx = 0
    victim = fleet.replica_id(idx)
    # the supervisor's next look comes after the rule's hold-down
    fleet.monitor_interval = 4.0
    time.sleep(0.5)
    faults.inject("fleet.replica.spawn", "exception", times=2, key=str(idx))
    t_kill = time.perf_counter()
    fleet.handles()[idx].stop()

    def alert_rows(kind):
        return [a for a in _url_call(url, "/alerts")[2][kind]
                if a["rule"] == "replica_unreachable"
                and a["labels"].get("replica") == victim]

    _fleet_wait("replica_unreachable to fire", lambda: alert_rows("firing"),
                limit=30)
    t_fire = time.perf_counter() - t_kill
    _fleet_wait("replica_unreachable to resolve",
                lambda: alert_rows("recent_resolved"), limit=60)
    t_resolve = time.perf_counter() - t_kill
    fleet.monitor_interval = 0.25
    _fleet_wait("the pinned respawn", lambda: (
        fleet.replica_id(idx) not in (None, victim)
        and fleet.handles().get(idx) is not None
        and len(_fleet_live(router)) == 2), limit=120)
    t_up = time.perf_counter() - t_kill
    faults.clear("fleet.replica.spawn")
    if t_fire < rule.for_seconds:
        raise SystemExit("fleet (c): replica_unreachable fired %.2f s after "
                         "the kill, inside its %.1f s hold-down"
                         % (t_fire, rule.for_seconds))
    out["alert"] = {"hold_down_s": rule.for_seconds, "fired_s": t_fire,
                    "resolved_s": t_resolve, "respawned_s": t_up,
                    "resolved_by": "deregistration of the dead replica "
                                   "(its series is forgotten)"}
    # federation: quiesced, two health polls past the last request
    time.sleep(0.5)
    handles = list(fleet.handles().values())
    texts = [_http(h.port, "/metrics")[2].decode() for h in handles]
    code, _, fleet_text = _url_call(url, "/metrics/fleet")
    fleet_text = fleet_text.decode()
    want = _hand_summed(texts)
    got = _hand_summed([fleet_text])
    if code != 200 or not want or got != want:
        raise SystemExit("fleet (c): /metrics/fleet differs from the "
                         "hand-summed scrapes: %s"
                         % {k: (got.get(k), v) for k, v in want.items()
                            if got.get(k) != v})
    out["fleet_counters_equal"] = len(want)
    # the replica the kill spared: its store has sampled for a while
    spared = fleet.handles()[1]
    _fleet_wait("the spared replica's history", lambda: (
        spared.api.tsdb_ is not None and spared.api.tsdb_.samples >= 2),
        limit=30)
    for where, base in (("router", url),
                        ("replica", "http://127.0.0.1:%d" % spared.port)):
        code, _, cat = _url_call(base, "/metrics/history")
        series = "veles_serving_tokens_generated_total"
        c2, _, ans = _url_call(base, "/metrics/history?series=%s&window=60"
                               "&agg=rate" % series)
        if code != 200 or c2 != 200 or not cat.get("samples") \
                or ans.get("value") is None:
            raise SystemExit("fleet (c): /metrics/history on the %s answered "
                             "%d %s / %d %s" % (where, code, cat, c2, ans))
        out["history_%s" % where] = {"samples": cat["samples"],
                                     "tokens_per_s_60s": ans["value"]}
    code, _, page = _url_call(url, "/dashboard")
    if code != 200 or not all(h.replica_id.encode() in page
                              for h in handles):
        raise SystemExit("fleet (c): /dashboard did not render the fleet")
    bundle = recorder.bundle("fleet phase")
    if not isinstance(bundle.get("alerts"), list) \
            or "router" not in bundle.get("history", {}):
        raise SystemExit("fleet (c): the bundle lacks alerts or history: %s"
                         % {k: type(bundle.get(k)).__name__
                            for k in ("alerts", "history")})
    out["bundle"] = {"alerts": len(bundle["alerts"]),
                     "history_stores": sorted(bundle["history"])}
    engine = AlertEngine(name="fleet-tick", interval=3600)
    engine.tick()
    t0 = time.perf_counter()
    for _ in range(FLEET_TICKS):
        engine.tick()
    out["alert_eval_overhead_us"] = \
        (time.perf_counter() - t0) / FLEET_TICKS * 1e6
    out["alert_eval_rules"] = len(engine.rules)
    return out


def fleet_rates(torch, dev, trained, pattern):
    """Part (c): one replica's REST decode rate with its history store
    and alert engine running (ticking every FLEET_RATE_INTERVAL s) and
    without them, FLEET_RATE_RUNS runs each, alternated:
    FLEET_RATE_REQUESTS concurrent requests of FLEET_RATE_STEPS greedy
    steps; median and range, and the ticks and samples of each on-run
    (the reference's < 5 % contract, printed, not gated)."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.restful_api import RESTfulAPI
    from veles_tpu_torch.telemetry.alerts import AlertEngine
    from veles_tpu_torch.telemetry.tsdb import TimeSeriesStore
    saved = (root.common.tsdb.get("enabled", True),
             root.common.alerts.get("enabled", True))
    root.common.tsdb.enabled = root.common.alerts.enabled = False
    try:
        api = RESTfulAPI(forwards=trained, max_slots=FLEET_SLOTS,
                         serving_kv_dtype="int8", serving_block_size=BLOCK,
                         serving_prefix_cache=False, device=dev)
        api.initialize()
    finally:
        root.common.tsdb.enabled, root.common.alerts.enabled = saved
    prompts = [(pattern * 12)[i:i + SPEC_PROMPT]
               for i in range(FLEET_RATE_REQUESTS)]
    rates, ticks = {"on": [], "off": []}, []
    try:
        sch = api.scheduler_
        _http(api.port, "/generate", {"prompt": prompts[0], "steps": 8})
        for run in range(2 * FLEET_RATE_RUNS):
            arm = "on" if run % 2 == 0 else "off"
            if arm == "on":
                api.tsdb_ = TimeSeriesStore(
                    name=api.replica_id, interval=FLEET_RATE_INTERVAL,
                    tiers=((FLEET_RATE_INTERVAL, 600.0),)).start()
                api.alerts_ = AlertEngine(name=api.replica_id,
                                          interval=FLEET_RATE_INTERVAL,
                                          tsdb=api.tsdb_).start()
            toks0, secs0 = sch.decode_tokens, sch.decode_seconds
            results = [None] * len(prompts)

            def client(i):
                results[i] = _http(api.port, "/generate", {
                    "prompt": prompts[i], "steps": FLEET_RATE_STEPS})

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            if any(r is None or r[0] != 200 for r in results):
                raise SystemExit("fleet (c): a rate request failed")
            rates[arm].append((sch.decode_tokens - toks0)
                              / (sch.decode_seconds - secs0))
            if arm == "on":
                api.alerts_.stop()
                api.tsdb_.stop()
                ticks.append((api.alerts_.ticks, api.tsdb_.samples))
                api.alerts_ = api.tsdb_ = None
    finally:
        api.stop()
    out = {}
    for arm, xs in rates.items():
        xs.sort()
        out[arm] = {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}
    out["on_over_off"] = out["on"]["median"] / out["off"]["median"]
    out["on_runs_ticks_samples"] = ticks
    if not all(t > 0 and n > 0 for t, n in ticks):
        raise SystemExit("fleet (c): an on-run's engines did not tick: %s"
                         % ticks)
    return out


def fleet_control(torch, dev, trained, pattern):
    """Part (d): an armed ``FleetController`` (min 1, max 2) over a fleet
    of one replica of the trained chain grows it to 2 under a burst of
    FLEET_BURST clients and drains it back to 1 when quiet, no request
    failing; then, tenant admission on: a flooding tenant
    (``X-Veles-Tenant``) gets 429s with ``Retry-After`` while another
    tenant is served, and ``/tenants/usage`` counts the served tokens
    exactly (one replica: its scrape is the process registry), its
    KV-block-seconds above 0."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import params_to_numpy
    from veles_tpu_torch.samples.lm import lm_spec
    from veles_tpu_torch.serving import Fleet, Router
    from veles_tpu_torch.serving.controller import FleetController
    spec = lm_spec(VOCAB, DIM, LAYERS, HEADS)
    params = params_to_numpy(trained)
    saved = {s: getattr(root.common, s).__content__()
             for s in ("controller", "tenant")}
    root.common.controller.update({
        "enabled": True, "interval": 0.5, "min_replicas": 1,
        "max_replicas": 2, "queue_high": 2.0, "occupancy_low": 0.3,
        "quiet_ticks": 3, "scale_up_cooldown": 0.0,
        "scale_down_cooldown": 0.0})
    made, out = [], {}
    router = Router(health_interval=0.2, health_timeout=5.0,
                    request_timeout=600.0, retries=4, retry_delay=0.02,
                    retry_cap=0.2).start()
    fleet = Fleet(_fleet_spawner(dev, spec, params, made), 1,
                  router=router, monitor_interval=0.25).start()
    ctl = FleetController(router, fleet)
    url = router.url
    prompts = [(pattern * 12)[i:i + SPEC_PROMPT] for i in range(8)]
    try:
        _fleet_wait("1 healthy replica", lambda: len(_fleet_live(router)) == 1)
        if not FleetController.enabled() or ctl.start()._thread is None:
            raise SystemExit("fleet (d): the controller did not arm")
        fails, done, sizes = [], [0], []
        stop = threading.Event()

        def client(i):
            k = 0
            while not stop.is_set():
                code, _, _ = _url_call(url, "/generate", {
                    "prompt": prompts[(i + k) % len(prompts)],
                    "steps": FLEET_STEPS})
                if code != 200:
                    fails.append(code)
                else:
                    done[0] += 1
                k += 1

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(FLEET_BURST)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        _fleet_wait("the scale-up", lambda: len(fleet.handles()) == 2
                    and len(_fleet_live(router)) == 2, limit=120)
        out["scaled_up_s"] = time.perf_counter() - t0
        time.sleep(2.0)   # the grown replica takes traffic
        stop.set()
        for t in threads:
            t.join(600)
        t1 = time.perf_counter()
        _fleet_wait("the drain back to 1", lambda: len(fleet.handles()) == 1
                    and any(d["action"] == "scale_down"
                            for d in ctl.audit()), limit=120)
        out["scaled_down_s"] = time.perf_counter() - t1
        if fails:
            raise SystemExit("fleet (d): %d requests failed during the "
                             "controller's scaling (%s)"
                             % (len(fails), fails[:5]))
        out["burst_requests"] = done[0]
        out["decisions"] = [{k: d.get(k) for k in (
            "action", "reason", "replica", "index", "replicas")}
            for d in ctl.audit()]
        ctl.stop()
        actions = [d["action"] for d in out["decisions"]]
        if "scale_up" not in actions or "scale_down" not in actions:
            raise SystemExit("fleet (d): decisions %s" % actions)
        # tenants
        root.common.tenant.update({"enabled": True, "rate": 0.5,
                                   "burst": 2.0, "max_concurrent": 0})
        flood, calm = "p17-flood", "p17-calm"
        codes, retry_after = [], []
        sent = {flood: [0, 0], calm: [0, 0]}
        body = {"prompt": prompts[0], "steps": 8}
        for k in range(8):
            code, hdr, _ = _url_call(url, "/generate", body,
                                     headers={"X-Veles-Tenant": flood})
            codes.append(code)
            if code == 429:
                retry_after.append(float(hdr["Retry-After"]))
            elif code == 200:
                sent[flood][0] += len(body["prompt"])
                sent[flood][1] += body["steps"]
            if k % 4 == 0:
                code, _, _ = _url_call(url, "/generate", body,
                                       headers={"X-Veles-Tenant": calm})
                if code != 200:
                    raise SystemExit("fleet (d): the calm tenant got %d"
                                     % code)
                sent[calm][0] += len(body["prompt"])
                sent[calm][1] += body["steps"]
        if codes.count(429) < 1 or not all(r > 0 for r in retry_after):
            raise SystemExit("fleet (d): the flood was not throttled: %s"
                             % codes)
        time.sleep(0.6)   # past the next health poll's scrape

        def usage():
            return _url_call(url, "/tenants/usage")[2]["tenants"]

        _fleet_wait("the usage rollup", lambda: all(
            usage().get(t, {}).get("generated_tokens") == g
            for t, (_, g) in sent.items()), limit=30)
        rows = usage()
        for t, (p, g) in sent.items():
            if rows[t]["prompt_tokens"] != p \
                    or rows[t]["generated_tokens"] != g \
                    or not rows[t]["kv_block_seconds"] > 0:
                raise SystemExit("fleet (d): /tenants/usage %s for %s, the "
                                 "clients counted %d prompt and %d "
                                 "generated tokens" % (rows[t], t, p, g))
        out["tenants"] = {"flood_codes": codes, "retry_after_s": retry_after,
                          "usage": {t: rows[t] for t in sent}}
    finally:
        ctl.stop()
        fleet.stop()
        router.stop()
        for s, content in saved.items():
            getattr(root.common, s).update(content)
    out["replicas_made"] = len(made)
    return out


def fleet_check(torch, dev, serve_chain, trained, pattern):
    """Phase 17: the serving fleet and its observability (see the module
    docstring).  Returns kernels 1 and 2's launches over (a) and (b)."""
    from veles_tpu_torch.convert import params_to_numpy
    t_phase = time.perf_counter()
    spec = serve_spec()
    params = params_to_numpy(serve_chain)
    prompt = numpy.random.default_rng(0).integers(
        0, VOCAB, FLEET_PROMPT).tolist()
    launches = {"paged_attend": 0, "int8_gemm": 0}
    out = {"a": {}}
    for n in FLEET_COUNTS:
        numbers, got = fleet_load(torch, dev, spec, params, n, prompt)
        out["a"][str(n)] = numbers
        log(json.dumps({"fleet (a)": numbers}))
        for k in launches:
            launches[k] += got[k]
    del params
    t0 = time.perf_counter()
    out["b"] = fleet_failover(torch, dev, trained, pattern, launches)
    out["c"] = out["b"].pop("c")
    out["c"]["decode_rate_tsdb_alerts"] = fleet_rates(torch, dev, trained,
                                                      pattern)
    out["bc_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["d"] = fleet_control(torch, dev, trained, pattern)
    out["d_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    log(json.dumps({"fleet": out}))
    return launches


# -- phase 18: the command line's fleet modes ---------------------------------

#: (a), (b), (d) AlexNet through ``samples/alexnet.py`` + its config at
#: full width (227², 1000 classes, minibatch 256, bf16, dropout 0.5), cut
#: as phase 14 (a) cuts it: 1 epoch over 512 + 256 synthetic samples
CM_A_TRAIN, CM_A_VALID = 512, 256
CM_A_SIDE, CM_A_CLASSES, CM_A_BATCH, CM_A_WIDTHS = 227, 1000, 256, None
#: (a) the package's outputs against the workflow's forward on the same
#: padded batch: bit-equal is expected (the same kernels on the same
#: shapes); this is the bound the phase holds them to
CM_PKG_TOL = 0.0
CM_PKG_SAMPLES = 8
#: (a) the transformer package: CM_T_* (with FLASH_CASES, which holds
#: kernel 3's forward at its shape)
#: (a) the C++ runner against "python" mode (f32 on the card), at
#: ``tests/test_package_export.py``'s tolerances for these chains
CM_RUNNER_TOL = {"mnist": 5e-3, "alexnet_mini": 2e-2}
#: the JAX package's class ids (``veles_tpu.<module>.<Class>.__id__``),
#: held against the ids the port's archives carry
CM_REFERENCE_IDS = {
    "ConvRELU": "50aa724b-71c2-5576-984f-2e11b4908c84",
    "LRNormalizerForward": "acb1cba8-6030-5968-962f-6d40313a58b0",
    "MaxPooling": "4f20b0e8-2bf5-5b64-9036-b8e1080de8eb",
    "DropoutForward": "7d3c8efe-0612-5753-b32b-d15d029fdb2c",
    "All2AllRELU": "0dc80ff5-7f62-542d-b78e-c56541be21ee",
    "All2AllSoftmax": "2ecfc194-18e0-5211-89d2-846953565b72",
    "All2AllTanh": "90409ed5-bdea-5294-b142-5fb2b66a9200",
    "Embedding": "c1b7bb9f-cc10-5598-a7ca-247524286738",
    "TransformerBlock": "18530faf-1608-534c-8c0d-40bdf81f43c2",
    "MeanPoolSeq": "e05b78c7-813a-59d8-91f8-ba5a2b160b61",
}
CM_MANIFEST_KEYS = ["checksum", "format", "format_version", "input",
                    "stablehlo", "units", "workflow"]
#: (b) ensemble members; (c) the optimizer's population and generations
#: over ``tests/test_genetics_ensemble.py:123``'s TINY MNIST (a population
#: of 2, cut from 4: each individual is a child process on the card,
#: 10-15 s of start-up for 0.1 s of training, and the smoke's whole run
#: must stay inside its time limit)
CM_MEMBERS, CM_RATIO = 2, 0.75
CM_POP, CM_GENS = 2, 2
CM_TINY = ("root.mnist_tpu.update({'max_epochs':1,'synthetic_train':512,"
           "'synthetic_valid':128,'snapshot_time_interval':0.0,"
           "'minibatch_size':128})")
CM_RANGE = "root.mnist_tpu.learning_rate = Range(0.02, 0.001, 0.5)"
CM_DIR = "_cli_modes"
CM_TIMEOUT = 300


def _cm_flags(dev):
    """The device flags every command line of the phase takes (its
    children get them too): the card, or ``-a cpu`` in a rehearsal."""
    return ["-a", "cpu"] if dev.type == "cpu" else ["-d", "0"]


def _cm_alexnet_argv(d, dev, extra=()):
    """The AlexNet cut's command line, a snapshot after each validation
    span into ``d``, uncompressed (a member's 0.5 GB of weights and
    momenta)."""
    import os
    widths = {"widths": CM_A_WIDTHS} if CM_A_WIDTHS else {}
    return [_sample("alexnet.py"), _sample("alexnet_config.py"),
            "-c", "root.alexnet_tpu.update(%r)" % dict(
                synthetic_train=CM_A_TRAIN, synthetic_valid=CM_A_VALID,
                max_epochs=1, side=CM_A_SIDE, classes=CM_A_CLASSES,
                minibatch_size=CM_A_BATCH, snapshot_compression=None,
                snapshot_time_interval=0.0, **widths),
            "-c", "root.common.dirs.snapshots = %r"
            % os.path.join(d, "snaps")] + _cm_flags(dev) + list(extra)


def _forward_padded(torch, chain, x, batch):
    """The chain's output for ``x`` padded with zero rows to ``batch``
    (the package's baked batch), the padding cut."""
    pad = torch.zeros((batch - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with torch.no_grad():
        h = torch.cat([x, pad])
        for u in chain:
            h = u.apply(h)
    return h[:x.shape[0]].float().cpu().numpy()


def _archive_manifest(path):
    import tarfile
    with tarfile.open(path, "r:gz") as tar:
        return json.loads(tar.extractfile("contents.json").read())


def _check_manifest(what, path, want_units):
    """The reference's keys, the reference's class ids, no program."""
    man = _archive_manifest(path)
    if sorted(man) != CM_MANIFEST_KEYS or man["stablehlo"] is not None \
            or man["format"] != "veles_tpu":
        raise SystemExit("cli modes (%s): manifest %s" % (what, sorted(man)))
    classes = [u["class"] for u in man["units"]]
    bad = [(u["class"], u["uuid"]) for u in man["units"]
           if u["uuid"] != CM_REFERENCE_IDS.get(u["class"])
           or sorted(u) != ["class", "config", "name", "params", "uuid"]]
    if bad or classes != want_units:
        raise SystemExit("cli modes (%s): units %s (want %s); ids off the "
                         "reference's: %s" % (what, classes, want_units, bad))
    return man


def _build_runner(d):
    """``runtime/`` built from a copy in ``d`` (nothing is written under
    the checkout); the build failing fails the phase."""
    import os
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runtime")
    dst = os.path.join(d, "runtime")
    os.makedirs(dst)
    for f in os.listdir(src):
        if f.endswith((".cc", ".h")) or f == "Makefile":
            shutil.copy(os.path.join(src, f), dst)
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-j8", "-C", dst], capture_output=True,
                       text=True, timeout=CM_TIMEOUT)
    binary = os.path.join(dst, "veles_runner")
    if r.returncode != 0 or not os.path.exists(binary):
        raise SystemExit("cli modes: the C++ runner did not build: %s"
                         % r.stderr[-800:])
    return binary, time.perf_counter() - t0


def _run_runner(binary, path, x, d):
    import os
    inp, out = os.path.join(d, "in.npy"), os.path.join(d, "out.npy")
    numpy.save(inp, x)
    r = subprocess.run([binary, path, inp, out], capture_output=True,
                       text=True, timeout=CM_TIMEOUT)
    if r.returncode != 0:
        raise SystemExit("cli modes: the runner failed on %s: %s"
                         % (path, r.stderr[-800:]))
    return json.loads(r.stdout), numpy.load(out)


def cm_package(torch, dev, d):
    """Phase 18 (a): package export at full width and its consumers;
    returns the part's launches."""
    import os
    from veles_tpu_torch import package_export
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    from veles_tpu_torch.samples.mnist import MnistWorkflow
    from veles_tpu_torch.samples.transformer import TransformerWorkflow
    out, launches = {}, {}
    # the CLI run with --export-package, its export timed in place
    path = os.path.join(d, "alexnet.tar.gz")
    timed = {}
    orig = package_export.export_package

    def export_timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            timed["export_s"] = time.perf_counter() - t0
    package_export.export_package = export_timed
    torch.cuda.synchronize()
    _zero_train_counts()
    try:
        run = _CliRun(_cm_alexnet_argv(d, dev, ["--export-package", path]))
    finally:
        package_export.export_package = orig
    torch.cuda.synchronize()
    launches["run"] = _read_train_counts()
    wf = run.workflow
    want_units = [type(u).__name__ for u in wf.forwards]
    man = _check_manifest("alexnet", path, want_units)
    shape = [CM_A_BATCH, CM_A_SIDE, CM_A_SIDE, 3]
    if man["input"] != {"shape": shape, "dtype": "float32"} \
            or man["workflow"] != "AlexNetWorkflow":
        raise SystemExit("cli modes (a): input %s" % (man["input"],))
    t0 = time.perf_counter()
    pkg = package_export.load_package(path, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    # validation samples: the walk is [test | validation | train], no test
    x = torch.as_tensor(wf.loader.original_data[:CM_PKG_SAMPLES]).to(
        dev, torch.float32).reshape([CM_PKG_SAMPLES] + shape[1:])
    want = _forward_padded(torch, wf.forwards, x, CM_A_BATCH)
    _zero_train_counts()
    got = pkg.run(x.cpu().numpy())
    torch.cuda.synchronize()
    launches["package"] = _read_train_counts()
    err = float(numpy.abs(got - want).max())
    if err > CM_PKG_TOL or got.shape != (CM_PKG_SAMPLES, CM_A_CLASSES):
        raise SystemExit("cli modes (a): the package's outputs %s differ "
                         "from the workflow's by %g (bound %g)"
                         % (got.shape, err, CM_PKG_TOL))
    pl = launches["package"]
    if pl["lrn_fwd"] != 2 or pl["lrn_bwd"] or pl["uniform_fill"]:
        raise SystemExit("cli modes (a): a package run launched %s, want "
                         "lrn_fwd 2 only" % pl)
    if not all(launches["run"][n] for n in
               ("lrn_fwd", "lrn_bwd", "uniform_fill")):
        raise SystemExit("cli modes (a): the CLI run launched %s"
                         % launches["run"])
    out["alexnet"] = {"archive_mb": os.path.getsize(path) / 2 ** 20,
                      "export_s": timed.get("export_s"), "load_s": load_s,
                      "cli_wall_s": run.wall, "max_abs_err": err,
                      "units": len(man["units"]),
                      "run_launches": launches["run"],
                      "package_launches": pl}
    wf.stop()
    del wf, run, pkg
    torch.cuda.empty_cache()
    # the transformer package: kernel 3's forward once per block
    twf = TransformerWorkflow(dim=CM_T_DIM, heads=CM_T_HEADS,
                              blocks=CM_T_BLOCKS, vocab=16, seq=CM_T_SEQ,
                              synthetic_train=128, synthetic_valid=64,
                              minibatch_size=CM_T_BATCH, max_epochs=1,
                              dtype="bfloat16",
                              snapshotter_config={"enabled": False})
    twf.initialize(device=dev)
    tpath = twf.package_export(os.path.join(d, "transformer.tar.gz"))
    _check_manifest("transformer", tpath,
                    ["Embedding"] + ["TransformerBlock"] * CM_T_BLOCKS
                    + ["MeanPoolSeq", "All2AllSoftmax"])
    tokens = numpy.asarray(twf.loader.original_data[:CM_T_BATCH])
    tx = torch.as_tensor(tokens, device=dev)
    twant = _forward_padded(torch, twf.forwards, tx, CM_T_BATCH)
    # each package's units are built in the compute dtype of the config
    # tree, as the JAX package's load_package builds them
    precision = root.common.precision
    saved_dtype = precision.get("compute_dtype", "bfloat16")
    precision.compute_dtype = "bfloat16"
    tpkg = package_export.load_package(tpath, device=dev)
    _zero_train_counts()
    tgot = tpkg.run(tokens.astype(numpy.float32))
    torch.cuda.synchronize()
    launches["transformer"] = _read_train_counts()
    terr = float(numpy.abs(tgot - twant).max())
    if terr > CM_PKG_TOL or launches["transformer"]["flash_attn_fwd"] \
            != CM_T_BLOCKS:
        raise SystemExit("cli modes (a): the transformer package differs "
                         "by %g; launches %s (want %d flash_attn_fwd)"
                         % (terr, launches["transformer"], CM_T_BLOCKS))
    out["transformer"] = {"max_abs_err": terr,
                          "launches": launches["transformer"]}
    twf.stop()
    del twf, tpkg
    # the C++ runner on an MNIST and a mini-AlexNet package of the port
    binary, build_s = _build_runner(d)
    mwf = MnistWorkflow(synthetic_train=256, synthetic_valid=64,
                        minibatch_size=64,
                        snapshotter_config={"enabled": False})
    mwf.initialize(device=dev)
    mpath = mwf.package_export(os.path.join(d, "mnist.tar.gz"), batch=8)
    _check_manifest("mnist", mpath, ["All2AllTanh", "All2AllSoftmax"])
    mx = numpy.asarray(mwf.loader.original_data[:8], numpy.float32)
    mwf.stop()
    spec = alexnet_layers(classes=7, space_to_depth=0)
    chain = init_params(spec, 9, in_shape=(67, 67, 3), device=dev)
    apath = package_export.export_package(
        chain, os.path.join(d, "axmini.tar.gz"), (2, 67, 67, 3),
        name="axmini")
    ax = numpy.random.default_rng(9).random((2, 67, 67, 3)).astype(
        numpy.float32)
    runner = {"build_s": build_s}
    precision.compute_dtype = "float32"
    for name, p, x in (("mnist", mpath, mx), ("alexnet_mini", apath, ax)):
        status, y = _run_runner(binary, p, x, d)
        py = package_export.load_package(p, device=dev).run(x)
        rerr = float(numpy.abs(y - py).max())
        if y.shape != py.shape or rerr > CM_RUNNER_TOL[name]:
            raise SystemExit("cli modes (a): the runner on %s: %s vs %s, "
                             "off by %g (tolerance %g)" % (
                                 name, y.shape, py.shape, rerr,
                                 CM_RUNNER_TOL[name]))
        runner[name] = {"max_abs_err": rerr, "units": status["units"],
                        "tolerance": CM_RUNNER_TOL[name]}
    out["runner"] = runner
    precision.compute_dtype = saved_dtype
    del chain
    torch.cuda.empty_cache()
    log(json.dumps({"cli_modes_package": out}))
    return list(launches.values())


def _trace_kernels(directory):
    """Per Chrome trace the profiler wrote into ``directory`` (one per
    child process): the kernel events of kernels 3–5, counted under
    their wrappers' names by their ``__global__`` functions' names."""
    import glob
    globals_of = {"lrn_fwd": "lrn_fwd_", "lrn_bwd": "lrn_bwd_",
                  "uniform_fill": "uniform_fill_kernel",
                  "flash_attn_fwd": "flash_fwd_"}
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "trace-*.json"))):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        names = [e.get("name", "") for e in events
                 if e.get("cat") == "kernel"]
        out.append({n: sum(g in k for k in names)
                    for n, g in globals_of.items()})
    return out


def ensemble_job(torch, dev, d):
    """Phase 18 (b)'s runs, in a background job (:func:`start_job`):
    ``--ensemble-train`` of the AlexNet cut with its members on the
    card, each profiled into ``d``/ens-prof, then ``--ensemble-test``
    with each tester profiled into ``d``/ens-test-prof."""
    prof = os.path.join(d, "ens-prof")
    test_prof = os.path.join(d, "ens-test-prof")
    summary = os.path.join(d, "ensemble.json")
    argv = _cm_alexnet_argv(d, dev, [
        "-c", "root.common.trace.profiler_dir = %r" % prof,
        "--ensemble-train", str(CM_MEMBERS), "--train-ratio",
        str(CM_RATIO), "-d", "0", "--result-file", summary])
    run = _CliRun(argv)
    s = _results(summary)
    # the tester runs each snapshot again, profiled into its own dir
    s["base_overrides"] = [
        ov.replace(repr(prof), repr(test_prof)) for ov in
        s["base_overrides"]]
    with open(summary, "w") as f:
        json.dump(s, f)
    t0 = time.perf_counter()
    _CliRun(["--ensemble-test", summary, "--result-file",
             os.path.join(d, "ensemble-test.json")] + _cm_flags(dev))
    return {"train_wall_s": run.wall,
            "test_wall_s": time.perf_counter() - t0}


def cm_ensemble(torch, dev, job):
    """Phase 18 (b): the ensemble's runs (:func:`ensemble_job`) checked:
    the members' seeds, snapshots, results and kernel events, then the
    testers'; returns the members' and testers' kernel events."""
    walls, d = job.wait("ensemble"), job.dir("ensemble")
    s = _results(os.path.join(d, "ensemble.json"))
    inst = s["instances"]
    seeds = [i["seed"] for i in inst]
    snaps = [i["snapshot"] for i in inst]
    # a member's validation error and loss: 1,000 classes of random
    # pixels leave the error near 100 % after two steps, so the members
    # must differ in the pair (their losses, at least)
    errs = [tuple((i["results"] or {}).get(k) for k in (
        "validation_error_pct", "validation_loss")) for i in inst]
    members = _trace_kernels(os.path.join(d, "ens-prof"))
    if s["succeeded"] != CM_MEMBERS or seeds != [4242, 4243] \
            or len(set(snaps)) != CM_MEMBERS \
            or not all(os.path.isfile(p) for p in snaps) \
            or len(set(errs)) != CM_MEMBERS \
            or None in sum(errs, ()):
        raise SystemExit("cli modes (b): summary %s" % json.dumps(s)[:2000])
    if len(members) != CM_MEMBERS or not all(
            m["lrn_fwd"] and m["lrn_bwd"] and m["uniform_fill"]
            for m in members):
        raise SystemExit("cli modes (b): the members' kernel events %s"
                         % members)
    t = _results(os.path.join(d, "ensemble-test.json"))
    testers = _trace_kernels(os.path.join(d, "ens-test-prof"))
    if len(t["tests"]) != CM_MEMBERS or not all(
            x.get("results") for x in t["tests"]) \
            or len(testers) != CM_MEMBERS \
            or not all(m["lrn_fwd"] for m in testers):
        raise SystemExit("cli modes (b): the tester gave %s, kernel "
                         "events %s" % (json.dumps(t)[:2000], testers))
    log(json.dumps({"cli_modes_ensemble": {
        "members": CM_MEMBERS, "train_ratio": CM_RATIO, "seeds": seeds,
        "validation_error_pct_and_loss": errs,
        "member_elapsed_s": [i["results"]["elapsed_sec"] for i in inst],
        "train_wall_s": walls["train_wall_s"],
        "s_per_member": walls["train_wall_s"] / CM_MEMBERS,
        "test_wall_s": walls["test_wall_s"],
        "member_kernel_events": members, "tester_kernel_events": testers,
        "snapshot_mb": [os.path.getsize(p) / 2 ** 20 for p in snaps]}}))
    return members + testers


def optimize_job(torch, dev, d):
    """Phase 18 (c)'s run, in a background job (:func:`start_job`):
    ``--optimize`` on the TINY MNIST, individuals on the card, each
    evaluation's overrides, seed, fitness and seconds recorded."""
    from veles_tpu_torch.genetics import SubprocessEvaluator
    calls = []
    orig = SubprocessEvaluator.__call__

    def timed(self, overrides, seed):
        t0 = time.perf_counter()
        fit = orig(self, overrides, seed)
        calls.append({"overrides": list(overrides), "seed": seed,
                      "fitness": fit, "s": time.perf_counter() - t0})
        return fit
    SubprocessEvaluator.__call__ = timed
    try:
        run = _CliRun([
            _sample("mnist.py"), _sample("mnist_config.py"), "-c",
            CM_RANGE, "-c", CM_TINY, "-c", "root.common.dirs.snapshots = "
            "%r" % os.path.join(d, "opt-snaps"), "--optimize",
            "%d:%d" % (CM_POP, CM_GENS), "--result-file",
            os.path.join(d, "optimize.json")] + _cm_flags(dev))
    finally:
        SubprocessEvaluator.__call__ = orig
    return {"calls": calls, "wall_s": run.wall}


def cm_optimize(torch, dev, job):
    """Phase 18 (c): the optimizer's run (:func:`optimize_job`) checked:
    generation 0 against the port's ``Population`` drawn here."""
    from veles_tpu_torch.config import Config, Range
    from veles_tpu_torch.genetics import Population, collect_tuneables
    got, d = job.wait("optimize"), job.dir("optimize")
    calls = got["calls"]
    o = _results(os.path.join(d, "optimize.json"))
    cfg = Config("t")
    cfg.mnist_tpu.learning_rate = Range(0.02, 0.001, 0.5)
    pop = Population(collect_tuneables(cfg), size=CM_POP, seed=42)
    want = [["root.mnist_tpu.learning_rate = %r" % c.genes[0]]
            for c in pop.individuals]
    gen0 = [c["overrides"] for c in calls[:CM_POP]]
    if gen0 != want or len(calls) != CM_POP * CM_GENS \
            or None in [c["fitness"] for c in calls] \
            or o.get("best_fitness") is None \
            or list(o.get("best_genes", {})) != \
            ["root.mnist_tpu.learning_rate"]:
        raise SystemExit("cli modes (c): generation 0 %s, the population's "
                         "%s; outcome %s; %d evaluations"
                         % (gen0, want, o, len(calls)))
    log(json.dumps({"cli_modes_optimize": {
        "population": CM_POP, "generations": CM_GENS,
        "best_fitness": o["best_fitness"], "best_genes": o["best_genes"],
        "history": o["history"], "generation0_match": True,
        "s_per_evaluation": [c["s"] for c in calls],
        "wall_s": got["wall_s"]}}))
    return []


#: the runs whose work is their children's — phase 16 (b)'s master and
#: its workers, phase 18 (b)'s ensemble members and testers and (c)'s
#: optimizer individuals, each a command line that spends 10-25 s on
#: the card before its first step — run one after another in the
#: background from phase 12 on, in one process of this script (``--job
#: DIR DEVICE SIZES NAME...``, given the constants JOB_SIZES), each in
#: JOB_DIR/NAME; phases 16 and 18 wait for each at most JOB_TIMEOUT
#: seconds from the job's start and check what it left
JOB_SIZES = ("D_A_WORKERS", "D_A_TRAIN", "D_A_VALID", "D_A_BATCH",
             "D_A1_TRAIN", "D_A_EXTRA", "CM_A_TRAIN", "CM_A_VALID",
             "CM_A_SIDE", "CM_A_CLASSES", "CM_A_BATCH", "CM_A_WIDTHS",
             "CM_MEMBERS", "CM_RATIO", "CM_POP", "CM_GENS", "CM_TINY",
             "CM_RANGE")
JOB_DIR, JOB_TIMEOUT = "_cli_jobs", 900


def dist_job(torch, dev, d):
    """Phase 16 (b) (:func:`master_worker_part`, its checks included)."""
    t0 = time.perf_counter()
    launches = master_worker_part(torch, dev)
    return {"launches": launches, "seconds": time.perf_counter() - t0}


JOBS = {"dist": dist_job, "ensemble": ensemble_job,
        "optimize": optimize_job}


class Job:
    """The background job: ``JOBS[name]`` for each of ``names`` in turn,
    in a process of its own (a session of its own, so :meth:`stop` ends
    its children too), its output in JOB_DIR/job.log."""

    def __init__(self, names, dev):
        here = os.path.abspath(__file__)
        self.root = os.path.join(os.path.dirname(here), JOB_DIR)
        shutil.rmtree(self.root, ignore_errors=True)
        os.makedirs(self.root)
        self.log, self.logged = os.path.join(self.root, "job.log"), 0
        sizes = json.dumps({k: globals()[k] for k in JOB_SIZES})
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, here, "--job", self.root, dev.type, sizes]
                + list(names), stdout=out, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(here), start_new_session=True)
        self.t_end = time.time() + JOB_TIMEOUT

    def dir(self, name):
        return os.path.join(self.root, name)

    def wait(self, name):
        """``name``'s ``JOB`` line once the job has printed it (fatal if
        the job ended without it or ran past JOB_TIMEOUT); the JSON
        records the job printed so far go to this process's output."""
        while True:
            done = self.proc.poll() is not None
            with open(self.log) as f:
                lines = f.read().split("\n")[:-1]     # whole lines only
            for line in lines[self.logged:]:
                if line.startswith("{"):
                    log(line)
            self.logged = len(lines)
            got = [l for l in lines if l.startswith("JOB %s " % name)]
            if got:
                return json.loads(got[-1].split(" ", 2)[2])
            if done or time.time() > self.t_end:
                self.stop()
                raise SystemExit("the background job (%s): rc=%s:\n%s" % (
                    name, self.proc.returncode, "\n".join(lines)[-3000:]))
            time.sleep(0.5)

    def stop(self):
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()


def job_main(root, device, sizes, *names):
    """``--job``: the background job at the parent's ``sizes``; prints a
    ``JOB NAME {json}`` line after each of ``names``."""
    import torch
    globals().update(json.loads(sizes))
    for name in names:
        d = os.path.join(root, name)
        os.makedirs(d)
        out = JOBS[name](torch, torch.device(device), d)
        print("JOB %s %s" % (name, json.dumps(out)), flush=True)
    return 0


def _status_get(port, path):
    import urllib.request
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=30) as r:
        return r.status, r.read().decode()


def cm_services(torch, dev, d):
    """Phase 18 (d): the AlexNet cut with ``-g`` and ``--web-status``
    against the same run without them; returns the observed run's
    launches."""
    import urllib.parse
    from veles_tpu_torch.graphics_server import HAS_ZMQ
    from veles_tpu_torch.web_status import WebStatusServer
    server = WebStatusServer(port=0, host="127.0.0.1")
    server.start()
    gport = _free_port()
    got, stop = [], threading.Event()
    sub = listener = None
    if HAS_ZMQ:
        import gzip
        import zmq
        from veles_tpu_torch.safe_pickle import safe_loads
        sub = zmq.Context.instance().socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        sub.setsockopt(zmq.LINGER, 0)
        # the run's server binds later: retry every 10 ms (not zmq's
        # 100 ms), so the subscription is up before the first payload
        sub.setsockopt(zmq.RECONNECT_IVL, 10)
        sub.connect("tcp://127.0.0.1:%d" % gport)

        def listen():
            while not stop.is_set():
                if sub.poll(100):
                    got.append(safe_loads(gzip.decompress(sub.recv())))
        listener = threading.Thread(target=listen, daemon=True)
        listener.start()
    else:
        log("cli modes (d): pyzmq is not installed here, so the graphics "
            "transport is absent; the plotters' payloads are checked "
            "through payload() on the card")
    observed = ["--web-status", "http://127.0.0.1:%d" % server.port]
    if HAS_ZMQ:
        observed += ["-g", "-c", "root.common.graphics.port = %d" % gport]
    runs = {}
    try:
        for arm, extra in (("observed", observed), ("plain", [])):
            torch.cuda.synchronize()
            _zero_train_counts()
            run = _CliRun(_cm_alexnet_argv(d, dev, extra))
            torch.cuda.synchronize()
            wf = run.workflow
            runs[arm] = {"launches": _read_train_counts(),
                         "params": _host_params(wf.gd.forwards),
                         "history": list(wf.decision.history),
                         "wall": run.wall}
            if arm == "observed":
                launcher = run.main.launcher
                plots = {p.name: p for p in wf.plotters}
                if not HAS_ZMQ:     # one payload each, read on the card
                    for p in wf.plotters:
                        p.collect = True
                        p.run()
            wf.stop()
            del wf, run
    finally:
        stop.set()
        if listener is not None:
            listener.join(5)
            sub.close(0)
    hist = runs["observed"]["history"]
    curve = plots["error_curve"].last_payload["series"]["validation error"]
    want = [h["validation_error_pct"] for h in hist]
    if not hist or curve != (want if HAS_ZMQ else want[-1:]):
        raise SystemExit("cli modes (d): the error curve %s, the history "
                         "%s" % (curve, hist))
    losses = plots["loss_curve"].last_payload["series"]["train loss"]
    if HAS_ZMQ and not all(h["validation_loss"] in losses for h in hist):
        raise SystemExit("cli modes (d): the loss curve %s lacks the "
                         "history's %s" % (losses, hist))
    if HAS_ZMQ:
        last = {p["name"]: p for p in got}
        for name, p in plots.items():
            if name not in last or last[name]["series"] != \
                    p.last_payload["series"]:
                raise SystemExit("cli modes (d): the subscriber's last %s "
                                 "was %s" % (name, last.get(name)))
        if launcher.graphics_server.sent != len(got):
            raise SystemExit("cli modes (d): %d payloads published, %d "
                             "received" % (launcher.graphics_server.sent,
                                           len(got)))
    try:
        rid, status = next(iter(server.runs.items()))
        names = [n["label"] for n in status.get("graph", {}).get(
            "nodes", [])]
        if len(server.runs) != 1 or not status.get("events") \
                or "error_curve" not in names \
                or launcher.status_notifier.posted < 1 \
                or status["metrics"].get("Total epochs") != 1:
            raise SystemExit("cli modes (d): status %s"
                             % json.dumps(status)[:1500])
        pages = {}
        for path in ("/", "/graph/" + urllib.parse.quote(rid), "/alerts",
                     "/dashboard"):
            code, body = _status_get(server.port, path)
            if code != 200 or not body:
                raise SystemExit("cli modes (d): %s answered %d"
                                 % (path, code))
            pages[path] = len(body)
    finally:
        server.stop()
    a, b = runs["observed"], runs["plain"]
    diff = max(v for dd in _max_diff(torch, a["params"], b["params"])
               for v in dd.values())
    if diff != 0.0 or a["launches"] != b["launches"]:
        raise SystemExit("cli modes (d): the observed run differs from the "
                         "plain one by %g; launches %s vs %s"
                         % (diff, a["launches"], b["launches"]))
    log(json.dumps({"cli_modes_services": {
        "zmq": HAS_ZMQ, "payloads_received": len(got),
        "status_posts": launcher.status_notifier.posted,
        "pages_bytes": pages, "graph_units": len(names),
        "events": len(status["events"]), "error_curve": curve,
        "observed_wall_s": a["wall"], "plain_wall_s": b["wall"],
        "launches": a["launches"], "max_abs_weight_diff": diff}}))
    return [a["launches"]]


def cm_frontend(torch, dev, d):
    """Phase 18 (e): a form POSTed to ``--frontend`` composes an MNIST
    run, which runs; its results file equals the direct command line's
    with the same argv."""
    import os
    import urllib.parse
    import urllib.request
    from veles_tpu_torch.cmdline import build_parser
    from veles_tpu_torch.frontend import compose_argv
    port = _free_port()
    keys = ("root.mnist_tpu.update({'synthetic_train': 512, "
            "'synthetic_valid': 128, 'max_epochs': 2})")
    form = {"workflow": _sample("mnist.py"),
            "config": _sample("mnist_config.py"),
            "config_override": "%s;;root.common.dirs.snapshots = %r"
            % (keys, os.path.join(d, "fe-snaps")),
            "result_file": os.path.join(d, "frontend.json")}
    if dev.type == "cpu":
        form["backend"] = "cpu"
    run = _CliRun(["--frontend", "--frontend-port", str(port)],
                  thread=True)
    body = urllib.parse.urlencode(form).encode()
    t_end = time.time() + 60
    while True:
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    "http://127.0.0.1:%d/compose" % port, data=body),
                    timeout=30) as r:
                argv = json.loads(r.read())["argv"]
            break
        except OSError:
            if time.time() > t_end or not run.thread.is_alive():
                raise SystemExit("cli modes (e): the frontend never "
                                 "answered")
            time.sleep(0.1)
    run.wait(CM_TIMEOUT)
    if argv != compose_argv(build_parser(), form):
        raise SystemExit("cli modes (e): composed %s" % argv)
    fe = _results(form["result_file"])
    direct = list(argv)
    direct[direct.index("--result-file") + 1] = os.path.join(d, "direct.json")
    _CliRun(direct + _cm_flags(dev)).workflow.stop()
    _same_results("cli modes (e)", fe, _results(os.path.join(
        d, "direct.json")), 0.0)
    log(json.dumps({"cli_modes_frontend": {
        "argv": argv, "frontend_wall_s": run.wall, "results": fe}}))
    return []


def cli_modes_check(torch, dev, job):
    """Phase 18: the command line's fleet modes — (a) package export and
    its consumers, (b) ensembles and (c) the genetic optimizer (run by
    the background job and checked here), (d) plots and
    status, (e) the frontend; returns the phase's launches by kernel
    (this process's, plus the kernel events of the ensemble's child
    processes)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), CM_DIR)
    os.makedirs(d, exist_ok=True)
    t_phase = time.perf_counter()
    totals, parts = {}, {}
    try:
        for name, fn, arg in (("package", cm_package, d),
                              ("ensemble", cm_ensemble, job),
                              ("optimize", cm_optimize, job),
                              ("services", cm_services, d),
                              ("frontend", cm_frontend, d)):
            t0 = time.perf_counter()
            for counts in fn(torch, dev, arg):
                for k, v in counts.items():
                    totals[k] = totals.get(k, 0) + v
            parts[name] = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log("cli modes: %.1f s (%s)" % (time.perf_counter() - t_phase, ", ".join(
        "%s %.1f" % kv for kv in parts.items())))
    return totals


# -- phase 19: the last services (item 11.3) ----------------------------------

#: (a): samples a producer pushes at AlexNet's full width, the batch
SV_Z_SAMPLES, SV_Z_SIDE, SV_Z_CLASSES = 64, 227, 1000
#: (a): the loader-fed forward against the stacked one (same kernels,
#: same inputs, same order: bit-equal)
SV_Z_TOL = 0.0
#: (b): AlexNet at full width, a 2-step epoch, then a second one
SV_A_BATCH, SV_A_TRAIN, SV_A_VALID = 64, 128, 64
SV_A_SIDE, SV_A_CLASSES = 227, 1000
#: (c): MNIST-width text records served by a loopback WebHDFS
SV_H_TRAIN, SV_H_VALID, SV_H_BATCH = 512, 128, 64
#: (d): the mini-AlexNet package (``tests/test_package_export.py``'s)
SV_P_SHAPE, SV_P_CLASSES = (2, 67, 67, 3), 7
SV_DIR = "_services"
SV_TIMEOUT = 120


def _zero_every_count():
    zero_all_counts()
    _zero_train_counts()


def _read_every_count():
    """Every kernel's launches since :func:`_zero_every_count`."""
    got = dict(read_all_counts(), **_read_train_counts())
    return {k: v for k, v in got.items() if isinstance(v, int)}


def _stop_http(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(SV_TIMEOUT)


def _serve_http(handler):
    import http.server
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def sv_ingest(torch, dev, d):
    """Phase 19 (a): a PUSH producer thread streams SV_Z_SAMPLES samples
    at AlexNet's width into a ZeroMQLoader in front of AlexNet's forward
    chain (bf16) on the card; returns the loader-fed forward's
    launches."""
    import zmq
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    from veles_tpu_torch.zmq_loader import ZeroMQLoader
    shape = (SV_Z_SIDE, SV_Z_SIDE, 3)
    chain = init_params(alexnet_layers(SV_Z_CLASSES), 19, device=dev,
                        dtype="bfloat16", in_shape=shape)
    loader = ZeroMQLoader(None, sample_shape=shape,
                          minibatch_size=SV_Z_SAMPLES, max_wait=SV_TIMEOUT)
    loader.initialize(device=dev)
    rng = numpy.random.default_rng(19)
    samples = rng.random((SV_Z_SAMPLES,) + shape, dtype=numpy.float32)
    sent = {}

    def produce():
        push = zmq.Context.instance().socket(zmq.PUSH)
        push.connect(loader.endpoint)
        t0 = time.perf_counter()
        for s_ in samples:
            push.send_pyobj(s_)
        sent["s"] = time.perf_counter() - t0
        push.close(linger=SV_TIMEOUT * 1000)
    producer = threading.Thread(target=produce, daemon=True)
    try:
        t0 = time.perf_counter()
        producer.start()
        deadline = time.time() + SV_TIMEOUT
        while loader._queue_.qsize() < SV_Z_SAMPLES \
                and time.time() < deadline:
            time.sleep(0.01)
        producer.join(SV_TIMEOUT)
        arrive_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _zero_every_count()
        t0 = time.perf_counter()
        loader.run()
        with torch.no_grad():
            h = loader.minibatch_data.devmem[:loader.minibatch_size]
            for u in chain:
                h = u.apply(h)
        got = h.float().cpu().numpy()
        forward_s = time.perf_counter() - t0
        launches = _read_every_count()
    finally:
        loader.stop()
    if loader.minibatch_size != SV_Z_SAMPLES:
        raise SystemExit("services (a): the loader served %d of %d samples"
                         % (loader.minibatch_size, SV_Z_SAMPLES))
    with torch.no_grad():
        h = torch.as_tensor(samples).to(dev)
        for u in chain:
            h = u.apply(h)
    want = h.float().cpu().numpy()
    err = float(numpy.abs(got - want).max())
    if err > SV_Z_TOL or not numpy.isfinite(got).all() \
            or got.shape != (SV_Z_SAMPLES, SV_Z_CLASSES):
        raise SystemExit("services (a): the loader-fed forward %s is off "
                         "the stacked one by %g (bound %g)"
                         % (got.shape, err, SV_Z_TOL))
    if dev.type == "cuda" and (launches["lrn_fwd"] != 2
                               or launches["lrn_bwd"]
                               or launches["uniform_fill"]):
        raise SystemExit("services (a): launched %s, want lrn_fwd 2 only"
                         % launches)
    log(json.dumps({"services_ingest": {
        "samples": SV_Z_SAMPLES, "mb": samples.nbytes / 2 ** 20,
        "send_s": sent.get("s"), "arrive_s": arrive_s,
        "serve_and_forward_s": forward_s, "max_abs_err": err,
        "launches": {k: v for k, v in launches.items() if v}}}))
    del chain
    torch.cuda.empty_cache()
    return launches


def _avatar_arrays(torch, dev, chain):
    """Every forward unit's parameters as Arrays adopting the live
    tensors (marked newer on the device, so a request reads each home
    once)."""
    from veles_tpu_torch.memory import Array
    out = {}
    for i, u in enumerate(chain):
        for n, t in u.params.items():
            a = Array()
            a.initialize(dev)
            a.devmem = t.detach()
            out["%d/%s" % (i, n)] = a
    return out


def _pull(torch, server, avatar):
    t = threading.Thread(target=server.serve_once,
                         kwargs={"timeout": SV_TIMEOUT * 1000}, daemon=True)
    t0 = time.perf_counter()
    t.start()
    avatar.run()
    t.join(SV_TIMEOUT)
    mirrors = {n: m.devmem for n, m in avatar.mirrors.items()}
    torch.cuda.synchronize()
    return time.perf_counter() - t0, mirrors


def _same_as_source(torch, what, mirrors, chain):
    for i, u in enumerate(chain):
        for n, t in u.params.items():
            m = mirrors.get("%d/%s" % (i, n))
            if m is None or m.device != t.device \
                    or not torch.equal(m, t.detach().float()):
                raise SystemExit("services (b): %s: mirror %d/%s differs "
                                 "from the source" % (what, i, n))


def sv_avatar(torch, dev, d):
    """Phase 19 (b): AlexNet's workflow trains 2 steps on the card; an
    AvatarServer exposes every forward unit's parameters, an Avatar
    pulls them onto the card (bit-equal), the workflow trains a second
    epoch and a second pull equals the new weights.  Returns (the
    workflow, its two snapshots, the training runs' launches)."""
    import os
    from veles_tpu_torch.avatar import Avatar, AvatarServer
    from veles_tpu_torch.samples.alexnet import AlexNetWorkflow
    wf = AlexNetWorkflow(side=SV_A_SIDE, classes=SV_A_CLASSES,
                         minibatch_size=SV_A_BATCH,
                         synthetic_train=SV_A_TRAIN,
                         synthetic_valid=SV_A_VALID, max_epochs=1,
                         snapshot_compression=None,
                         snapshot_time_interval=1e9,
                         snapshotter_config={"directory": d})
    for p in wf.plotters:     # payloads for (d)'s reports
        p.collect = True
    wf.initialize(device=dev)
    torch.cuda.synchronize()
    _zero_every_count()
    wf.run()
    torch.cuda.synchronize()
    launches = [_read_every_count()]
    if wf.gd.global_step != SV_A_TRAIN // SV_A_BATCH:
        raise SystemExit("services (b): %d steps, want %d"
                         % (wf.gd.global_step, SV_A_TRAIN // SV_A_BATCH))
    snaps = []
    wf.snapshotter.suffix = "epoch1"
    wf.snapshotter.export()
    snaps.append(wf.snapshotter.destination)
    chain = wf.gd.forwards
    server = AvatarServer(_avatar_arrays(torch, dev, chain))
    avatar = Avatar(None, endpoint=server.endpoint, timeout=SV_TIMEOUT,
                    names=sorted(server.arrays))
    avatar.initialize(device=dev)
    pulls = []
    try:
        secs, mirrors = _pull(torch, server, avatar)
        _same_as_source(torch, "first pull", mirrors, chain)
        mb = sum(m.numel() * 4 for m in mirrors.values()) / 2 ** 20
        pulls.append(secs)
        wf.decision.max_epochs = 2
        wf.decision.complete.set(False)
        _zero_every_count()
        wf.run()
        torch.cuda.synchronize()
        launches.append(_read_every_count())
        server.arrays = _avatar_arrays(torch, dev, chain)
        secs, mirrors2 = _pull(torch, server, avatar)
        _same_as_source(torch, "second pull", mirrors2, chain)
        pulls.append(secs)
        moved = max(float((mirrors2[n] - mirrors[n]).abs().max())
                    for n in mirrors)
        if moved == 0.0:
            raise SystemExit("services (b): the second epoch moved no "
                             "weight")
    finally:
        avatar.close()
        server.close()
    wf.snapshotter.suffix = "epoch2"
    wf.snapshotter.export()
    snaps.append(wf.snapshotter.destination)
    for got in launches:
        if dev.type == "cuda" and not all(
                got[n] for n in ("lrn_fwd", "lrn_bwd", "uniform_fill")):
            raise SystemExit("services (b): the training launched %s"
                             % got)
    log(json.dumps({"services_avatar": {
        "arrays": len(mirrors), "mb_per_pull": mb, "pull_s": pulls,
        "second_epoch_max_move": moved, "steps": wf.gd.global_step,
        "snapshot_mb": [os.path.getsize(p) / 2 ** 20 for p in snaps],
        "launches": launches}}))
    del mirrors, mirrors2
    return wf, snaps, launches


def _hdfs_handler(files):
    import http.server
    import urllib.parse

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            path = url.path[len("/webhdfs/v1"):]
            if q.get("op") == "LISTSTATUS":
                names = sorted({f[len(path):].lstrip("/").split("/")[0]
                                for f in files if f.startswith(path)})
                body = json.dumps({"FileStatuses": {"FileStatus": [
                    {"pathSuffix": n, "type": "FILE"
                     if path.rstrip("/") + "/" + n in files
                     else "DIRECTORY"} for n in names]}}).encode()
            else:
                body = files[path]
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
    return Handler


def _mnist_mlp(loader_factory, loader_config, dtype):
    from veles_tpu_torch.models.standard import StandardWorkflow
    return StandardWorkflow(
        loader_factory=loader_factory,
        loader_config=dict(loader_config, minibatch_size=SV_H_BATCH),
        layers=[{"type": "all2all_tanh", "output_sample_shape": (100,)},
                {"type": "softmax", "output_sample_shape": (10,)}],
        decision_config={"max_epochs": 1, "fail_iterations": 25},
        snapshotter_config={"enabled": False}, plotters=False,
        dtype=dtype, solver="sgd", learning_rate=0.1,
        gradient_moment=0.9)


def sv_hdfs(torch, dev, d):
    """Phase 19 (c): a loopback WebHDFS serves MNIST-width text records;
    ``HDFSTextLoader`` feeds the MNIST MLP for one epoch on the card,
    bit-equal to the same records from numpy through a FullBatchLoader;
    returns the HDFS run's launches."""
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.loader.hdfs_loader import HDFSTextLoader
    rng = numpy.random.default_rng(23)
    n = SV_H_TRAIN + SV_H_VALID
    data = (rng.integers(0, 256, (n, 784)) / 255.0).astype(numpy.float32)
    labels = [str(v) for v in rng.integers(0, 10, n)]
    files, rows = {}, {}
    for part, lo, hi in (("valid", 0, SV_H_VALID), ("train", SV_H_VALID, n)):
        for k, (a, b) in enumerate(((lo, (lo + hi) // 2),
                                    ((lo + hi) // 2, hi))):
            lines = ["%s %s" % (" ".join("%.9g" % v for v in data[i]),
                                labels[i]) for i in range(a, b)]
            files["/mnist/%s/part-%d" % (part, k)] = \
                ("\n".join(lines) + "\n").encode()
        rows[part] = (lo, hi)
    srv, t = _serve_http(_hdfs_handler(files))

    class FromNumpy(FullBatchLoader):
        def load_data(self):
            self.class_lengths[:] = [0, SV_H_VALID, SV_H_TRAIN]
            self.original_data = data.copy()
            self.original_labels = list(labels)
            self.labels_mapping = {l: i for i, l in
                                   enumerate(sorted(set(labels)))}

    out = {}
    try:
        for arm, factory, cfg in (
                ("hdfs", HDFSTextLoader, {
                    "namenode": "127.0.0.1:%d" % srv.server_address[1],
                    "train_path": "/mnist/train",
                    "validation_path": "/mnist/valid"}),
                ("numpy", FromNumpy, {})):
            wf = _mnist_mlp(factory, cfg, "bfloat16")
            t0 = time.perf_counter()
            wf.initialize(device=dev)
            load_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            _zero_every_count()
            wf.run()
            torch.cuda.synchronize()
            out[arm] = {"params": _host_params(wf.gd.forwards),
                        "history": list(wf.decision.history),
                        "launches": _read_every_count(), "load_s": load_s,
                        "lengths": list(wf.loader.class_lengths)}
            wf.stop()
            del wf
    finally:
        _stop_http(srv, t)
    a, b = out["hdfs"], out["numpy"]
    diff = max(v for dd in _max_diff(torch, a["params"], b["params"])
               for v in dd.values())
    if diff != 0.0 or a["lengths"] != [0, SV_H_VALID, SV_H_TRAIN] \
            or a["history"] != b["history"]:
        raise SystemExit("services (c): the HDFS run is off the numpy run "
                         "by %g; lengths %s; histories %s / %s"
                         % (diff, a["lengths"], a["history"], b["history"]))
    log(json.dumps({"services_hdfs": {
        "records": n, "text_mb": sum(map(len, files.values())) / 2 ** 20,
        "hdfs_load_s": a["load_s"], "numpy_load_s": b["load_s"],
        "history": a["history"], "max_abs_weight_diff": diff}}))
    return a["launches"]


def _confluence_handler(captured):
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            captured.append(json.loads(self.rfile.read(length)))
            body = json.dumps({"id": str(len(captured)), "_links": {
                "base": "http://wiki.local",
                "webui": "/pages/%d" % len(captured)}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
    return Handler


def sv_forge_publish(torch, dev, d, wf, snaps):
    """Phase 19 (d): the mini-AlexNet package through update_forge to a
    loopback ForgeServer and back (checksum-verified), run on the card;
    (b)'s run published in all five backends; compare_snapshots on
    (b)'s snapshots.  Returns the fetched package run's launches."""
    import contextlib
    import io
    import os
    from veles_tpu_torch import package_export
    from veles_tpu_torch.convert import init_params
    from veles_tpu_torch.forge import ForgeServer, fetch
    from veles_tpu_torch.publishing import BACKENDS, Publisher
    from veles_tpu_torch.samples.alexnet import alexnet_layers
    from veles_tpu_torch.scripts import compare_snapshots, update_forge
    chain = init_params(alexnet_layers(classes=SV_P_CLASSES), 9,
                        in_shape=SV_P_SHAPE[1:], device=dev)
    pkg_dir = os.path.join(d, "forge_tree", "axmini")
    os.makedirs(pkg_dir)
    path = package_export.export_package(
        chain, os.path.join(pkg_dir, "axmini.tar.gz"), SV_P_SHAPE,
        name="axmini")
    with open(os.path.join(pkg_dir, "forge.json"), "w") as f:
        json.dump({"name": "axmini", "version": "1.0",
                   "description": "mini-AlexNet", "package":
                   "axmini.tar.gz"}, f)
    x = numpy.random.default_rng(9).random(SV_P_SHAPE).astype(
        numpy.float32)
    before = package_export.load_package(path, device=dev).run(x)
    server = ForgeServer(os.path.join(d, "forge_store")).start()
    try:
        rc = update_forge.main(["--server", server.url,
                                "--root", os.path.join(d, "forge_tree")])
        if rc != 0:
            raise SystemExit("services (d): update_forge exited %d" % rc)
        fetched_dir = os.path.join(d, "fetched")
        os.makedirs(fetched_dir)
        fetched, version = fetch(server.url, "axmini", fetched_dir)
    finally:
        server.stop()
    pkg = package_export.load_package(fetched, device=dev)
    torch.cuda.synchronize()
    _zero_every_count()
    after = pkg.run(x)
    torch.cuda.synchronize()
    launches = _read_every_count()
    err = float(numpy.abs(after - before).max())
    if err != 0.0 or version != "1.0" \
            or (dev.type == "cuda" and launches["lrn_fwd"] != 2):
        raise SystemExit("services (d): the fetched package (%s) is off by "
                         "%g; launches %s" % (version, err, launches))
    del chain, pkg
    # publishing (b)'s run in every backend; Confluence to a fake
    captured = []
    csrv, ct = _serve_http(_confluence_handler(captured))
    reports = {}
    try:
        for name in sorted(BACKENDS):
            cfg = {"server": "http://127.0.0.1:%d" % csrv.server_address[1],
                   "space": "ML", "token": "t"} if name == "confluence" \
                else None
            pub = Publisher(wf, backend=name, backend_config=cfg,
                            output_dir=os.path.join(d, "reports"))
            t0 = time.perf_counter()
            pub.run()
            reports[name] = {"file": os.path.basename(pub.destination),
                             "bytes": os.path.getsize(pub.destination),
                             "s": time.perf_counter() - t0}
            if name == "html":
                reports[name]["images"] = len(pub.backend.images)
                if pub.backend.images_skipped:
                    log("services (d): the HTML report's plot images "
                        "were skipped: %s" % pub.backend.images_skipped)
                    reports[name]["images_skipped"] = \
                        pub.backend.images_skipped
            if name == "confluence":
                reports[name]["url"] = pub.backend.url
    finally:
        _stop_http(csrv, ct)
    if len(captured) != 1 or "<h2>Metrics</h2>" not in \
            captured[0]["body"]["storage"]["value"]:
        raise SystemExit("services (d): the fake Confluence got %d pages"
                         % len(captured))
    verdicts = {}
    for pair, want in ((snaps, 1), ((snaps[0], snaps[0]), 0)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = compare_snapshots.main(list(pair))
        line = [l for l in buf.getvalue().splitlines()
                if l.startswith("VERDICT")]
        verdicts["differ" if want else "same"] = {
            "rc": rc, "verdict": line[-1] if line else None,
            "s": time.perf_counter() - t0}
        if rc != want:
            raise SystemExit("services (d): compare_snapshots %s exited %d,"
                             " want %d: %s" % (pair, rc, want,
                                               buf.getvalue()[-800:]))
    log(json.dumps({"services_forge_publish": {
        "package_mb": os.path.getsize(path) / 2 ** 20, "max_abs_err": err,
        "launches": {k: v for k, v in launches.items() if v},
        "reports": reports, "compare_snapshots": verdicts}}))
    return launches


def sv_builds(torch, dev):
    """Phase 19 (e): ``compile_summary()`` lists every kernel library
    with this run's ``cold``/``hit`` and calls equal to the kernels'
    launch counts; ``/metrics`` of a live dashboard shows the family."""
    import urllib.request
    from veles_tpu_torch import _build
    from veles_tpu_torch.ops import kernel_launches
    from veles_tpu_torch.telemetry import compile_summary, cost_summary
    from veles_tpu_torch.telemetry.compile_tracker import KERNEL_LIBRARY
    from veles_tpu_torch.web_status import WebStatusServer
    summ = compile_summary()
    sums = {}
    for kernel, n in kernel_launches().items():
        lib = "kernels." + KERNEL_LIBRARY[kernel]
        sums[lib] = sums.get(lib, 0) + n
    libs = {"kernels." + n for n in _build.SOURCES}
    bad = [n for n in libs if n not in summ or summ[n]["compiles"] != 1
           or summ[n]["calls"] != sums.get(n, 0)]
    if bad:
        raise SystemExit("services (e): compile_summary %s (launches %s)"
                         % ({n: summ.get(n) for n in bad}, sums))
    server = WebStatusServer(port=0, host="127.0.0.1")
    server.start()
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d/metrics"
                                    % server.port, timeout=30) as r:
            text = r.read().decode()
    finally:
        server.stop()
    shown = [l for l in text.splitlines()
             if l.startswith("veles_jit_compiles_total{")
             and 'fn="kernels.' in l]
    if len(shown) != len(libs):
        raise SystemExit("services (e): /metrics shows %s" % shown)
    costs = cost_summary()
    log(json.dumps({"services_builds": {
        n: {"cache": "hit" if summ[n]["compiles_persistent_hit"] else "cold",
            "first_compile_s": summ[n]["first_compile_s"],
            "calls": summ[n]["calls"],
            "library_bytes": (costs.get(n) or {}).get(
                "generated_code_bytes")} for n in sorted(libs)}}))


def services_check(torch, dev):
    """Phase 19: the last services — (a) ZeroMQ ingest into AlexNet's
    forward, (b) the Avatar, (c) WebHDFS into the MNIST MLP, (d) forge,
    publishing and compare_snapshots, (e) the kernel builds; returns the
    phase's launches by kernel."""
    import os
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), SV_DIR)
    os.makedirs(d, exist_ok=True)
    t_phase = time.perf_counter()
    totals, parts = {}, {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    wf = None
    try:
        t0 = time.perf_counter()
        add(sv_ingest(torch, dev, d))
        parts["ingest"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wf, snaps, runs = sv_avatar(torch, dev, d)
        for counts in runs:
            add(counts)
        parts["avatar"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        add(sv_hdfs(torch, dev, d))
        parts["hdfs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        add(sv_forge_publish(torch, dev, d, wf, snaps))
        parts["forge_publish"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sv_builds(torch, dev)
        parts["builds"] = time.perf_counter() - t0
    finally:
        if wf is not None:
            wf.stop()
        del wf
        torch.cuda.empty_cache()
        shutil.rmtree(d, ignore_errors=True)
    log("services: %.1f s (%s)" % (time.perf_counter() - t_phase, ", ".join(
        "%s %.1f" % kv for kv in parts.items())))
    return totals


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from veles_tpu_torch import _build
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def lap(phase):
        log("timeline: %s done at %.1f s" % (phase,
                                             time.perf_counter() - t_start))
    card = card_line()
    rate = hbm_rate(card)
    log("card: %s" % card)

    t0 = time.perf_counter()
    _build.build_all()
    log("build: %.1f s (%s)" % (time.perf_counter() - t0,
                                ", ".join(sorted(_build.SOURCES))))
    lap("build")
    for name, report in sorted(_build.ptxas_reports.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(b) for b in
                     re.findall(r"(\d+) bytes spill stores", report))
        log("ptxas %s: %d kernels, <= %d registers, %d bytes spilled"
            % (name, len(regs), max(regs, default=0), spills))
    for entry in lrn_ptxas(_build.ptxas_reports.get("lrn", "")):
        log("ptxas lrn %s: %d registers, %d bytes smem, %d bytes spilled"
            % entry)

    measured = check_kernels(torch, dev, rate)
    lap("kernels")
    measured.update(check_flash(torch, dev, rate))
    lap("flash")
    rng = numpy.random.default_rng(2)
    measured["matmul"] = time_matmul(torch, dev, rng, rate,
                                     check_matmul(torch, dev, rng))
    mm_launches, mm_err = matmul_path(torch, dev, rng)
    measured["matmul"]["max_abs_err"] = max(
        measured["matmul"]["max_abs_err"], mm_err)
    lap("matmul")
    reference_check(torch, dev)
    t0 = time.perf_counter()
    reference_check(torch, dev, moe=True)
    log("reference (moe): %.1f s" % (time.perf_counter() - t0))
    lap("reference")
    train_reference(torch, dev)
    t0 = time.perf_counter()
    moe_train_launches = train_reference(torch, dev, moe=True)
    log("train reference (moe): %.1f s" % (time.perf_counter() - t0))
    lap("train reference")
    learns(torch, dev)
    lap("learns")
    served = serve_check(torch, dev)
    lap("serve")
    dense_numbers = served.pop("numbers")
    launches = dict(served["launches"], matmul=mm_launches)
    spec_launches, trained, pattern = spec_check(torch, dev)
    lap("spec")
    serve_chain = served.pop("chain")
    life_launches = lifecycle_check(torch, dev, serve_chain, trained,
                                    pattern)
    lap("lifecycle")
    surface_launches = surface_check(torch, dev, serve_chain, trained,
                                     pattern)
    lap("surface")
    rest_launches_ = rest_check(torch, dev, trained, pattern)
    lap("rest")
    tier_launches, wide = tiers_check(torch, dev, rate, trained, pattern)
    measured["paged_attend"]["wide"] = wide
    lap("tiers")
    fleet_launches = fleet_check(torch, dev, serve_chain, trained, pattern)
    lap("fleet")
    del served, trained, serve_chain
    moe_launches = moe_serve_check(torch, dev, dense_numbers)
    lap("moe serve")
    launches.update(train_check(torch, dev)["launches"])
    lap("train")
    measured.update(check_lrn(torch, dev, rate))
    measured.update(check_uniform(torch, dev, rate))
    lap("lrn and uniform")
    alexnet_witness(torch, dev)
    launches.update(alexnet_check(torch, dev)["launches"])
    lap("alexnet")
    s2d_launches = s2d_vgg_check(torch, dev)
    lap("s2d and vgg")
    family_launches = families_check(torch, dev)
    lap("families")
    # the background work of phases 13, 16 and 18 starts here, after
    # every kernel's timing, beside phases 12-15 in this process
    gc.collect()
    torch.cuda.empty_cache()
    job, gang, vocab_job = None, [], None
    try:
        job = Job(JOBS, dev)
        gang = start_gang()
        vocab_job = start_vocab()
        wf_launches = workflow_check(torch, dev)
        input_launches = input_check(torch, dev, vocab_job)
        lap("workflow and input")
        cli_launches = cli_check(torch, dev)
        lap("cli")
        parallel_launches = parallel_check(torch, dev)
        lap("parallel")
        dist_launches = distributed_check(torch, dev, gang, job)
        lap("distributed")
        cli_modes_launches = cli_modes_check(torch, dev, job)
        lap("cli modes")
    finally:
        for p in gang + ([vocab_job[0]] if vocab_job else []):
            if p.poll() is None:
                p.kill()
                p.wait()
        if job is not None:
            job.stop()
            shutil.rmtree(job.root, ignore_errors=True)
    services_launches = services_check(torch, dev)
    lap("services")

    replaces = {
        "paged_attend": ("paged_attend.cu", "pallas_paged.py:112"),
        "int8_gemm": ("int8_gemm.cu", "gemm.py:131"),
        "matmul": ("matmul.cu", "gemm.py:131"),
        "flash_attn_fwd": ("flash_attention.cu", "pallas_attention.py:179"),
        "flash_attn_dq": ("flash_attention.cu", "pallas_attention.py:330"),
        "flash_attn_dkv": ("flash_attention.cu", "pallas_attention.py:352"),
        "lrn_fwd": ("lrn.cu", "lrn.py:200"),
        "lrn_bwd": ("lrn.cu", "lrn.py:217"),
        "uniform_fill": ("uniform.cu", "random.py:41"),
    }
    kernels = [dict(name=name, route="cuda",
                    source="veles_tpu_torch/csrc/" + src,
                    replaces="veles_tpu/ops/" + tpu,
                    launches=launches[name], **measured[name])
               for name, (src, tpu) in replaces.items()]
    for k in kernels:
        k["kernel_ms"] = k["ms"]
        if k["name"] in spec_launches:
            k["spec_launches"] = spec_launches[k["name"]]
            k["lifecycle_launches"] = life_launches[k["name"]]
        if k["name"] in surface_launches:
            k["surface_launches"] = surface_launches[k["name"]]
        if k["name"] in rest_launches_:
            k["rest_launches"] = rest_launches_[k["name"]]
        if k["name"] in tier_launches:
            k["tiers_launches"] = tier_launches[k["name"]]
        for key, got in (("moe_launches", moe_launches),
                         ("moe_train_launches", moe_train_launches),
                         ("s2d_vgg_launches", s2d_launches),
                         ("families_launches", family_launches),
                         ("workflow_launches", wf_launches),
                         ("input_launches", input_launches),
                         ("cli_launches", cli_launches),
                         ("parallel_launches", parallel_launches),
                         ("distributed_launches", dist_launches),
                         ("fleet_launches", fleet_launches),
                         ("cli_modes_launches", cli_modes_launches),
                         ("services_launches", services_launches)):
            if k["name"] in got:
                k[key] = got[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gang-worker"]:
        sys.exit(gang_worker(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--job"]:
        sys.exit(job_main(*sys.argv[2:]))
    sys.exit(main())
