#!/usr/bin/env python3
"""Drive the PyTorch port of Parsa on one NVIDIA GPU and hold every CUDA
kernel to its plain PyTorch version: the partitioner's paths and the LM
serving paths of every model family (qwen3-14b, whisper-medium,
xlstm-350m and zamba2-2.7b, and mixtral-8x22b, deepseek-v2-236b and
internvl2-76b cut in depth, at full width).

    python3 chip_smoke.py                 # all phases, one card

Run it from the root of a checkout (it imports ``src/repro_torch``).  It
needs a CUDA card and ``nvcc`` (``$CUDA_HOME/bin``, ``PATH`` or
``/usr/local/cuda/bin``); it builds the kernels from ``src/`` at first use.
Phases, in order; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each kernel against its plain version on the card, bit for bit, across
   shape sweeps (tolerance: 0, the program is integer; the cost tile of
   parsa_cost and parsa_select_tile at K of 1 to 1,024, W of 1 to 2,048, U
   not a multiple of a CTA's rows, all-zero and all-ones rows, the K = 1
   down-date against its almost all-ones complement mask; the merge of a
   super-step at 1, 2, 4 and 8 workers with odd k * W, its union, count,
   merged sizes and every worker's written-back copy; sketch_select on
   row lists it builds and on lists passed in; parsa_scan's parts, sets and
   sizes at 64, 2,048 and 4,096 words, B of 8, 40 and 128, k of 1, 2, 3
   and 16, 1, 4 and 8 workers, with truncated rows, padding blocks, bit-31
   words, entering sets and unequal sizes, at the elastic grow's k = 2, B
   = 256 and 1,536 words, and at the sketch path's B of 512 and 1,024
   (more than 32 rows a CTA); the one-launch refine over
   chunks and sweeps, in place and not); flash attention within
   float tolerances (float32 3e-5 with TF32 off, bfloat16 2e-2), across
   dtypes, GQA and MHA, masks, Sq < Skv, ragged lengths, head dims, the
   tensor-core route's 128-row and 128-key tile edges and the prefill's
   full-width shape; what ``-Xptxas -v`` says of the kernels
   redesigned for Hopper (registers, shared memory, spills), and HGMMA and
   UTMALDG instructions in the flash library's SASS (``cuobjdump``), and
   parsa_scan's global loads (S only by strong loads); silu_stepwise and
   gelu_stepwise (the port's elementwise kernel, every operation rounded
   to the dtype as ``jax.nn.silu`` and ``jax.nn.gelu`` round it) bit for
   bit against their plain chains of ATen ops on 64 M bfloat16 and 16 M
   float32 values, the special values (±0, ±inf, NaN, ±88, ±90,
   subnormals) ahead, on a view off 16-byte alignment with an odd tail
   and on a transposed view (its layout kept);
   the MoE dispatch's ordered backward (``moe._SlotGather``) at
   mixtral-8x22b's width run twice, bit for bit;
3. the main path at full size: ``text_like(100_000, 65_536, mean_len=20,
   seed=0)`` through ``partition(..., ParsaConfig(k=16,
   backend="device_scan", refine_backend="device", sweeps=2))`` on cuda,
   with its launch counts (one parsa_scan, one refine_sweep), held to the
   numpy oracles and to the host_blocked_oracle backend on the card; its
   embedding placement (``placement=True``) equal to
   ``placement_from_parts`` on the oracles' parts, its gather traffic
   against a random placement, and the refusal of a compressing sketch; the
   per-round route of the scan (tiles past parsa_scan's shared memory) on
   the same graph at B=1,024, k=64 exact and k=56 sketched, held to the
   numpy oracles;
4. cpu against cuda on a reduced graph, both backends, every output equal;
   flash attention with a query offset against its plain version on both
   routes, and context parallel's row slices at their offsets bit for bit
   the whole prompt's rows (phase ``parity``);
5. the sketch path (``set_repr="sketch"``): the acceptance geometry of
   ``benchmarks/bench_sketch.py`` (``ctr_like(1_000_000, 100_000_000,
   nnz_per_row=10, seed=11)``, k=16, B=1024, 65,536 hot and 65,536 bucket
   bits, so 4,096 words) with its launch counts (one parsa_scan, one
   refine_sweep), held to the numpy oracles
   on the sketched graph; the exact collapse on the main graph, equal to
   phase 3; the quality band of the sketch against the exact run, scored
   on the true graph (reported); cpu against cuda on a reduced sketched
   graph, both backends;
6. Algorithm 4 on the card (``backend="parallel_device"``): the acceptance
   configuration of ``benchmarks/bench_fig10_scalability.py`` (8 workers,
   B=128, an OR-merge every 12 blocks) on the main graph, with its launch
   counts (a parsa_scan and a merge a super-step, one refine_sweep) and
   traffic, held to the numpy oracles; one worker, equal to
   phase 3 in every output; its quality against phase 3, gated at 5%;
   the host simulation ``parallel_sim`` at full size (reported); cpu
   against cuda on the reduced graph at 4 and 8 workers, with global
   initialization and sketched; then Algorithm 4 across processes (phase
   ``dist``, one worker a rank of a torch.distributed group, B=128, an
   OR-merge every 12 blocks): a real NCCL group of one rank in this
   process, equal to the ungrouped route and to device_scan in every
   output, with a parsa_scan and a merge a super-step; 4 gloo ranks
   started with spawn on this one card, each equal to the in-process
   route at 4 workers (17 parsa_scan and 17 packed_union_delta launches a
   rank) and one grouped stream feed equal to the in-process feed; NCCL
   at 4 ranks, one card each, where 4 cards are visible; each rank's scan
   time a super-step and gather time a merge; and elastic Parsa over the
   group (part (d)): phase elastic's chaos script (12 feeds, k 8 -> 12)
   at ``parallel_device``, B=256, the straggler bias on, in the same
   ranks at 4 workers, each rank equal to the in-process session bit for
   bit (every feed's state, the ops, the final state and traffic,
   ``result()``, its launches by dispatch phase), within 5% of the
   one-shot scan; at one worker over the NCCL group of one rank, equal to
   the ungrouped session (no block shuffle);
7. the online stream (phase ``stream``, ``repro_torch.stream``): the main
   graph fed as one chunk, equal to phase 3; the acceptance stream of
   ``benchmarks/bench_stream.py`` (the main graph in 16 chunks, k=16,
   B=256) with one parsa_scan launch and one scan and one metrics dispatch
   a feed, its live sets equal to the packed need words, its result (one
   refine_sweep) equal to the numpy oracles, its traffic_max within 5% of
   the one-shot scan, its feed seconds by phase against from-scratch
   partitions of each prefix, and a profile window of one feed; the same
   chunks at 8 workers (one parsa_scan and one packed_union_delta a
   super-step; feed 8 against the plain route); a drifting stream with
   repair at the defaults, and one explicit ``repartition()`` equal to
   ``plan_migration`` of the scan on the plain route; a snapshot after 8
   feeds resumed on the card (feed 8 against the plain route); the sketch
   graph in 8 chunks, sketched, and again with the JAX package's padded
   truncated-row width; cpu against cuda on reduced streams (drift repair,
   growing V, sketched, 4 workers), their trace exports byte-identical;
8. elastic Parsa and the parameter server (phase ``elastic``,
   ``repro_torch.elastic``, ``repro_torch.ml``): the chaos acceptance run
   of ``benchmarks/bench_chaos.py`` (``text_like(60_000, 49_152,
   mean_len=20, seed=0)`` in 12 chunks, k 8 -> 12 by four adds and two
   seeded kills under ``ChaosSchedule(seed=0)``) replayed twice, bit for
   bit, with one parsa_scan a feed, a grow and a warm repair and none a
   shrink, its first 6 feeds held to the same feeds on the plain route;
   warm repair
   against a cold ``repartition()`` on clones of one snapshot (seconds and
   ratio reported), a shrink and a ``ThresholdPolicy``-gated grow; the
   final traffic_max within 5% of a one-shot partition at k=12; the same
   script at 8 workers with the straggler bias (the straggled lane's EWMA
   weight lowest until its recovery, one parsa_scan and one
   packed_union_delta a super-step), its first 6 feeds held to the plain
   route; cpu against
   cuda on a reduced replay and a reduced sketched session; the PS
   cluster of the paper's Tables 3/4 (DBPG l1-LR, 45 iterations) on phase
   3's partition against a random placement, two card runs identical,
   its first 5 iterations held to the CPU's, and the chaos replay's final
   placement pushed into a cluster over its graph (``sync_cluster``);
9. the PS serving loop (phase ``serving``, ``repro_torch.serving`` and
   ``repro_torch.elastic.autoscaler``): the closed-loop SLO acceptance of
   ``benchmarks/bench_slo.py`` (``ctr_like(6_000, 8_000)``, k0=8, 3,072
   slots, burst, kill, straggle; the overload calibrated from two pilots)
   against its static baseline, gated as the bench gates it (hold >= 0.95,
   baseline < 0.95, shed <= 5%, a grow, one repair), replayed twice bit for
   bit (signature, trace, flight recorder), every violated window
   attributed by ``explain()``, one parsa_scan a feed, a grow and a warm
   repair, printed beside the JAX package's recorded run; open-loop
   serving on the main graph at k=16 (512 requests sync and async, Parsa
   against random_parts: examples/s, p50/p99, blocked against wire, the
   inter-machine bytes a request), a kill under load repaired warm with
   one parsa_scan, and a profile window of served requests; cpu against
   cuda on the reduced traced loop of ``tests/test_obs.py``;
10. the LM serving path (phase ``lm``): qwen3-14b at full width and depth
   with random bf16 weights drawn on the card, ``make_prefill_step`` at
   B=2, S=4,096 (one flash_attention launch per layer, against the plain
   route), layer 0's attention kernel against plain, greedy decode through
   the serving engine (``decode_loop_engine``, batch 4, prompt 32, 16 new
   tokens) bit-identical to ``decode_loop``, teacher forcing, cpu against
   cuda on the reduced config, peak device memory and a profile window of
   one prefill and one decode step;
11. the MoE serving path (phase ``moe``): mixtral-8x22b at full width
   cut to 8 of 56 layers (40.9 GB of random bf16 weights drawn on the card
   after phase lm's are freed), phase lm's checks on it: the prefill at
   B=2, S=8,192, twice the sliding window of 4,096 (8 windowed
   flash_attention launches, against the plain route; the share of
   (token, slot) expert choices the two routes agree on, the capacity
   drops by layer), layer 0's windowed attention kernel against
   ``flash_attention_ref``, ``decode_loop_engine`` bit-identical to
   ``decode_loop``, teacher forcing against a prefill at capacity factor
   E / top-k (no drop), cpu against cuda on the reduced config with a
   window of 8; and its own: one ``apply_moe`` at decode's and at a prefill
   slice's shape under ``torch.cuda.set_sync_debug_mode("error")`` (no
   device-to-host sync), the SWA ring cache (the first 2 layers of the
   same weights, the window cut to 256, 320 decode steps through
   ``init_cache(1, 256, ring=True)`` against a 320-slot cache, every
   step's logits within 5e-2, its ``kpos``), and layer 0's routing counts
   over 32 groups of 512 prefill tokens placed by
   ``build_expert_placement`` at k=4 (one parsa_scan and one
   refine_sweep; the all-to-all crossing tokens reported);
11b. the MoE family over a (data x model) mesh (phase ``moe_ep``):
   mixtral-8x22b at full width cut to 1 layer (5.81 GB of random bf16
   weights), ``fsdp``, through ``make_prefill_step`` and
   ``make_serve_step`` with ``mesh=``: (a) a real NCCL group of one rank,
   mesh (1, 1), equal to the no-mesh route bit for bit; (b) 4 gloo ranks
   on this card, mesh (2, 2) (4 experts a model rank, F split over data;
   each rank's expert blocks, and since phase tp its 24/4 attention heads
   and 16,384 vocab rows, and since FSDP of the dense weights its embed,
   attention and router over data too, gathered a layer at a time, cut by
   ``launch.sharding.shard_params``): a
   prefill at B=2, S=4,096 (the token path), one at B=2, S=32,768 (the
   weight path) and 8 greedy decode steps at batch 4 (the token path),
   each rank's logits, cache digests and tokens bit for bit equal to its
   place of the in-process emulation (``launch.mesh.emulate_mesh``), the
   ranks' tokens equal, the logits at capacity factor 4 (no drop) within
   5e-2 relative L2 of the no-mesh route (at the config's 1.25
   reported); the branch and gathered bytes of every MoE call, every
   gather's bytes by kind a prefill and a decode step (the FSDP gathers
   apart), prefill seconds, gather and sum milliseconds, decode p50, peak
   memory and launches a rank; (c) NCCL at 4 ranks where 4 cards are
   visible;
11c. dense tensor parallelism over a (data x model) mesh (phase ``tp``):
   (a) qwen3-14b at full width cut to 4 layers on mesh (1, 4) over 4 gloo
   ranks on this card (a rank's 10 of 40 q heads, 2 of 8 kv heads, 4,352
   of 17,408 MLP columns, 38,016 of 152,064 vocab rows, cut by
   ``launch.sharding.shard_params``): the prefill at B=2, S=4,096 (a flash
   launch a layer at the rank's 10/2 heads) and 8 greedy decode steps at
   batch 4 after a 64-token prompt; (b) the same model on mesh (1, 1)
   over one NCCL rank, its prefill and a decode step bit for bit the
   no-mesh route's; (c) context parallel: qwen3-14b x 2 on mesh (1, 3)
   over 3 gloo ranks, the prefill at B=2, S=3,072 (40 heads do not divide
   3), rank r's flash launch on its 1,024 query rows at q_offset r x 1,024
   against all 3,072 keys.  (a) and (c): each rank's logits, cache
   digests, tokens and flash shapes bit for bit its place of the
   in-process emulation, the tokens equal on every rank, the prefill
   logits within 5e-2 relative L2 of the no-mesh route; the bytes a rank
   gathers a call, prefill seconds, decode p50 / p99, peak memory, gather
   times and flash launches by shape, logged;
11d. the rest of the serving path over a mesh (phase ``tp_all``), 4 gloo
   ranks on this card that run three parts in turn, each rank's blocks
   drawn a leaf at a time, every rank at once (``draw_blocks``): (a)
   deepseek-v2-236b x 1 layer on mesh (1, 4), a rank's 32 of 128 heads,
   128 of 512 latent dims, 16 of 64 rope dims and 40 of 160 experts, the
   prefill at B=2, S=4,096 (one flash launch at (192, 128) on the rank's
   heads) and 8 greedy decode steps at batch 4 after a 16-token prompt
   against the rank's latent block; (b) xlstm-350m x 1 group on mesh (2,
   2) and (c) zamba2-2.7b x 1 group on mesh (1, 4): the prefill step's
   loss over the global batch at S=1,024 and 4,096, then decode from the
   rank's block of zero states over a 16-token prompt and 8 greedy
   steps.  Each
   rank bit for bit its place of the in-process emulation, the tokens
   equal on every rank, the prefill logits or the loss within 5e-2 of
   the no-mesh route; the bytes gathered a call, prefill or loss
   seconds, decode p50 / p99, each rank's peak and the card's memory in
   use, and the flash launches by shape, logged;
12. the MLA serving path (phase ``mla``): deepseek-v2-236b at full width
   (128 heads, q/k head dim 128 + 64 rotary, v 128, kv_lora 512, q_lora
   1,536, 160 experts top-6 with 2 shared) cut to 6 of 60 layers (49.8 GB
   of random bf16 weights drawn on the card after phase moe's are freed),
   phase lm's checks on it through ``phase_lm(dev, MLA, extra=...)``: the
   prefill at B=2, S=4,096 (6 flash_attention launches at (Dqk, Dv) =
   (192, 128) on the tensor-core route, against the plain route's absorbed
   attention over query chunks), layer 0's kernel against
   ``flash_attention_ref``, ``decode_loop_engine`` bit-identical to
   ``decode_loop``, teacher forcing at capacity factor 27 (>= E / top-k:
   no drop) under shared expert choices, cpu against cuda on the reduced
   config; phase moe's route agreement, drops and layer 0's expert
   placement (32 groups of 256 tokens at k=8, one parsa_scan and one
   refine_sweep); the latent cache's bytes, measured; one decode step's
   ``mla_block`` under ``set_sync_debug_mode("error")``; and the serving
   CLI (``launch.serve.main``, ``--layers 6``) on the card;
13. the encoder-decoder serving path (phase ``encdec``): whisper-medium at
   full width and depth (24 encoder and 24 decoder layers, 16/16 x 64
   heads, 811,790,336 parameters, 1.62 GB of random bf16 weights), frames
   (8, 1,500, 1,024) ``normal(0, 0.1)`` from the stub front end, phase
   lm's checks on it through ``phase_lm(dev, ENCDEC, extra=...)``: the
   prefill of a 224-token prompt at B=8 into a 448-slot self cache (72
   flash_attention launches: 24 non-causal at the encoder, 24 causal at
   the decoder's self-attention, 24 non-causal at the cross-attention,
   against the plain route, logits and both caches within 5e-2), layer 0's
   causal kernel against plain, ``decode_loop_engine`` bit-identical to
   ``decode_loop`` (the zero cross cache of the reference's serving CLI),
   teacher forcing (the prompt's second half decoded from a prefill of its
   first), cpu against cuda on the reduced config; and its own: the
   prefill's bf16 bound and its flash launches by role in a profile, the
   kernel at the encoder's (8, 1,500, 16, 64) and the cross's (8, 224)
   against (8, 1,500) non-causal shapes on the tensor-core route (the
   cross k/v views of the stacked cross cache) against its plain version,
   timed beside its bound and SDPA, greedy decode of 64 tokens at B=8
   from the prefill's cache (p50 and p99 a step, no host sync in a step,
   a profiled step), and the serving CLI on the card, its engine tokens
   equal to ``decode_loop``'s;
14. the VLM serving path (phase ``vlm``): internvl2-76b at full width
   (64/8 x 128 heads, d_ff 28,672) cut to 24 of 80 layers (22.6 B
   parameters, 45.3 GB of random bf16 weights drawn after phase encdec's
   are freed), phase lm's checks on it through ``phase_lm(dev, VLM,
   extra=...)``: the text prefill at B=2, S=4,096 (24 flash_attention
   launches, all at (causal, 4,096, 4,096) by ``LAUNCH_SHAPES``, against
   the plain route), layer 0's kernel against plain, ``decode_loop_engine``
   bit-identical to ``decode_loop``, teacher forcing, cpu against cuda on
   the reduced config; and its own: the prefill's bf16 bound, a decode
   step's weight bytes and bound, and the loss with patches through
   ``make_eval_step`` (B=2, 256 patches ahead of 768 text tokens: 1,536
   tokens counted, finite, moved by other patches).  Prefill and decode
   read no patches, as the reference's do;
15. the xLSTM path (phase ``xlstm``): xlstm-350m at full width and depth
   (3 groups of 7 mLSTM + 1 sLSTM, random weights): ``decode_loop_engine``
   at batch 4 (the prompt warmed step by step) bit-identical to
   ``decode_loop``, a profiled decode step (its kernels, busy time, idle
   share) beside its bound, teacher forcing (the parallel form's logits
   against 32 decode steps at batch 2): the served bf16 model's
   reported (a per-head RMS norm after a sum near 0 flips that head with
   a rounding, in the reference's two forms as in the port's), and a
   float32 model's within relative L2 5e-2; layer
   0's mLSTM at 2,048 tokens (two chunks of 1,024) against its
   recurrence, cpu against cuda on the reduced config, and
   ``launch.train --arch xlstm-350m`` at batch 8 x 256 for one step (2
   microbatches, remat "full": the sLSTM's backward loop on the card),
   its losses and grad norms finite, step time, tokens/s, peak memory;
16. the hybrid path (phase ``hybrid``): zamba2-2.7b at full width and depth
   (9 groups of 5 Mamba2 blocks and the one weight-tied attention layer,
   random bf16 weights, bf16 SSM state): ``decode_loop_engine`` at batch 4
   bit-identical to ``decode_loop`` (a KV cache a group), a profiled
   decode step beside its bound, teacher forcing over 32 tokens as
   xLSTM's (bf16 reported, float32 within 5e-2), layer 0's Mamba2 at
   1,024 tokens (the SSD's four chunks of 256)
   against its recurrence, the parallel forward (``make_prefill_step``'s
   loss) at B=2 x 4,096 timed with its peak memory, cpu against cuda on
   the reduced config;
17. LM training (phase ``train``): qwen3-14b at full width cut to 2 layers
   (float32 master parameters, remat "full", 2 microbatches), 8 steps at
   batch 8 x sequence 1,024 of ``SyntheticLMData`` staged by
   ``prefetch_batches``: the step time (median of steps 2-8), tokens/s,
   peak device memory, the share of the dense bf16 peak and a profiled
   step's idle share, no flash_attention launch (training attention is
   the plain route); the reduced config's 3 steps on the card twice
   (bitwise) and against the CPU (relative L2 within 1e-5), and its run
   through ``TrainLoop`` with a failure at step 6 and a checkpoint every 2
   steps, resumed bitwise (the full-width resume, a 26.6 GB checkpoint,
   is cut for the script's time, as phase ``train_moe`` holds its resume
   on the reduced config);
17b. MoE training (phase ``train_moe``): mixtral-8x22b at full width cut
   to 1 layer (2.91 B float32 master parameters; parameters, gradients, m
   and v 46.5 GB), its own remat "full" and 8 microbatches, 3 steps at
   batch 8 x 1,024 of ``SyntheticLMData`` twice from the same
   ``init_state(seed)``: the parameters, m and v of the two runs bit for
   bit equal (the first run's copied to the host), the losses finite, the
   step time (median of steps 2-3), tokens/s, peak memory, the route's
   capacity drops and the share of the dense bf16 peak from
   ``launch.roofline.model_flops`` and ``count_params``; the reduced
   mixtral's 3 steps on the card twice (bitwise) and against the CPU
   (within 1e-5), and its failure at step 6 with a checkpoint every 2
   steps, resumed bitwise (a full-width checkpoint, 34.9 GB, would not fit
   the disk writes a call has left after phase train's);
17c. training over a (data x model) mesh (phase ``train_tp``,
   ``launch.steps.make_train_step(mesh=)``): ``TRAIN_TP``'s four parts,
   qwen3-14b x 1 on (1, 4), xlstm-350m x 8 and zamba2-2.7b x 6 on (2, 2),
   2 steps at batch 8 x 1,024, and (d) FSDP of the dense weights,
   command-r-35b x 1 on (2, 2) with ``fsdp=True`` (its blocks cut over
   data too, drawn a leaf at a time: a bf16 prefill at B=2 x 4,096 with
   flash at a rank's 32/4 heads and 2 greedy decode steps, then 2 train
   steps at batch 2 x 1,024), over 4 gloo ranks on the card spawned once,
   each part after the no-mesh route's in this process: each rank's
   losses, grad norms, sampled blocks (and (d)'s prefill and decode
   logits) against the no-mesh route's (within 5e-2), every replicated
   leaf equal on its ranks after every step, silu_stepwise launched and
   flash not in training; a step's seconds, the forward, FSDP, backward
   and remat bytes and gathers apart, and the peak a rank ((d): at most
   16 GB after the cut); first, that two threads' backward passes cannot
   meet on the card (an emulated mesh trains on the CPU only);
18. each kernel timed at the shapes its path launches (CUDA events, median
   of 21 samples after warm-up; ``ms`` from launches replayed in a CUDA
   graph, ``eager_ms`` from launches made one by one from Python) beside
   its bound, its plain version and its launches on the path
   (``parsa_cost`` at B=256, W=2,048 for K=1, host_blocked_oracle's
   down-date against a real block's complement mask, 100,000 of its
   100,391 launches, and for K=16, its block tile; ``parsa_select_tile``
   at the per-round route's B=1,024, k=64 and at the main shape; the merge
   of a super-step at the parallel path's 8 workers and at one worker;
   ``parsa_scan`` over the main path's whole scan,
   one launch, and its time a round, and over its first
   ``SCAN_PLAIN_BLOCKS`` blocks beside its plain version once, bit for
   bit;
   ``refine_sweep`` at one chunk and sweep and over the main path's whole
   refine, with its chain of dependent steps; ``sketch_select`` on the
   scan's row lists at the sketch path's shape and at the main path's,
   beside the bound of those compact inputs and the dense contract's,
   ``flash_attention`` at the prefill's shape beside
   ``scaled_dot_product_attention``, and at phase moe's windowed shape
   beside it with the window's mask, and at phase mla's (Dqk, Dv) = (192,
   128) shape beside ``scaled_dot_product_attention`` on the same q, k and
   v, naming the backend it picked, phase encdec's non-causal times at
   (64, 64), and at phase vlm's 64/8-head causal shape beside it, and at
   phase tp's rank shape (B=2, S=4,096, 10/2 x 128) and its
   context-parallel shape (1,024 query rows against 3,072 keys, 40/8 x
   128, q_offset 2,048) beside ``scaled_dot_product_attention`` (with the
   explicit mask at the offset), and at phase tp_all's MLA rank shape
   (B=2, S=4,096, 32/32 heads, (192, 128)) beside it, and at phase
   train_tp (d)'s FSDP serving rank shape (B=1, S=4,096, 32/4 x 128)
   beside it;
   ``silu_stepwise`` at a qwen3-14b decode step's (4, 1, 17,408) and its
   prefill's (2, 4,096, 17,408) bfloat16 shapes, ``gelu_stepwise`` at
   whisper-medium's decoder step (8, 1, 4,096) and encoder (8, 1,500,
   4,096), each beside its plain chain and the one-rounding ``F.silu`` or
   ``F.gelu``; these LM times are taken last), the main, the sketched
   and the parallel scan and the whole refine under ``torch.profiler``,
   in a spawned process of their own (``times_windows``: late in a whole
   run this process's profiler lost whole windows), what had
   accumulated in each process before them logged: device time per
   round, the device's idle share, and a parallel super-step's kernels
   (one parsa_scan and one merge, no PyTorch kernel); and the sketched
   scan's first blocks against ``parsa_scan_ref``.

``--phases build,kernels,sketch``, ``--phases build,kernels,parallel``,
``--phases build,dist``, ``--phases build,moe_ep``, ``--phases build,tp``,
``--phases build,tp_all``, ``--phases build,kernels,stream``,
``--phases build,kernels,elastic``,
``--phases build,kernels,serving``, ``--phases build,kernels,lm``,
``--phases build,kernels,moe``, ``--phases build,kernels,mla``,
``--phases build,kernels,encdec``, ``--phases build,kernels,vlm``,
``--phases build,kernels,xlstm``, ``--phases build,kernels,hybrid``,
``--phases build,kernels,train``, ``--phases build,kernels,train_moe`` and
``--phases build,train_tp`` are short checks of one path (they print no result and exit 1).

The last lines are the card, one ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
PROFILE_DIAG = 0    # --profile-diag N
# the spin ahead of a profile window's recorded call (profile_window):
# about 50 ms at the H100's 1.98 GHz boost clock
LEAD_SPIN_CYCLES = 100_000_000
PHASES = ("build", "kernels", "main", "parity", "sketch", "parallel",
          "dist", "stream", "elastic", "serving", "lm", "moe", "moe_ep", "tp",
          "tp_all", "mla", "encdec", "vlm", "xlstm", "hybrid", "train", "train_moe",
          "train_tp", "times")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor fp32
# rate, the only CUDA-core rate in that sheet; int32 and popcount work is
# counted against it one operation per instruction.
# what accumulates in the script's process ahead of phase times' profile
# windows (ROADMAP Queue 3 item 5): torch.profiler sessions, CUDA graphs
# captured and replayed, and the port's kernel launches on the paths
# (each phase's counts at its end, summed: timing launches excluded)
ACCUMULATED = {"profiler_sessions": 0, "cuda_graph_captures": 0,
               "cuda_graph_replays": 0, "port_launches_on_paths": 0}
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# dense bf16 tensor-core rate (same sheet): the bound of flash attention's
# bf16 products
TENSOR_BF16_FLOPS = 989e12

MAIN_GRAPH = dict(num_docs=100_000, vocab=65_536, mean_len=20, seed=0)
SMALL_GRAPH = dict(num_docs=4_000, vocab=8_192, mean_len=20, seed=1)
K = 16
BLOCK = 256
# the per-round route: B=1,024 on the main graph at k=64 (parsa_select) and
# k=56 (sketch_select), both past parsa_scan's shared memory
PER_ROUND_BLOCK = 1024

# the sketch path: bench_sketch.py's acceptance geometry (10^8 features,
# 2^17 sketched bits), its quality-band graph and a reduced graph for cpu
# against cuda.  Only num_impressions of SKETCH_GRAPH may be cut to fit
# the time limit; |V| and the hot and bucket bits stay.
SKETCH_GRAPH = dict(num_impressions=1_000_000, num_features=100_000_000,
                    nnz_per_row=10, seed=11)
SKETCH_BITS = 65_536         # hot bits = bucket bits
SKETCH_BLOCK = 1024
# blocks of the sketched scan held to parsa_scan_ref in phase times
SKETCH_REF_BLOCKS = 8
BAND_GRAPH = dict(num_impressions=20_000, num_features=100_000,
                  nnz_per_row=25, seed=7)
BAND_BITS = 8192
SKETCH_SMALL_GRAPH = dict(num_impressions=4_000, num_features=200_000,
                          nnz_per_row=25, seed=1)
SKETCH_SMALL_BITS = 2048
# the sketch's true-graph traffic_max may exceed the exact run's by at most
# this percentage at the band geometry: SKETCH_MAX_QUALITY_PCT of
# benchmarks/common.py:40.  Reported here, not gated.
SKETCH_MAX_QUALITY_PCT = 5.0

# Algorithm 4 on the card: the acceptance configuration of
# benchmarks/bench_fig10_scalability.py:187-189 on the main graph, gated
# at its 5% traffic_max slack against the sequential scan
# (bench_fig10_scalability.py:206-209), and the host simulation it is
# measured against (:196-197)
PAR = dict(workers=8, block_size=128, merge_every=12)
PAR_MAX_QUALITY_PCT = 5.0
SIM = dict(workers=8, blocks=64, tau=None)
# Algorithm 4 across processes (phase dist): one worker a rank of a
# torch.distributed group, the main graph at B=128, an OR-merge every 12
# blocks; ranks are started with spawn and joined by a deadline, each group
# made with a timeout
DIST = dict(block_size=128, merge_every=12)
DIST_WORKERS = 4
DIST_GROUP_TIMEOUT_S = 60
DIST_DEADLINE_S = 240

# the stream path: the acceptance stream of benchmarks/bench_stream.py:54-65
# (the main graph in 16 np.linspace chunks, k=16, B=256,
# repartition="never"), gated at its max_quality_pct of 5% traffic_max
# against the one-shot scan; its parallel feeds at PAR; a drifting stream
# at half the main graph's documents (its vocabulary whole; 100,000 until
# phase tp needed the time: the explicit repartition's plain-route scan
# took 36-40 s of it) with drift repair at the defaults; the sketch graph
# in 8 chunks; and reduced streams for cpu against cuda
STREAM_CHUNKS = 16
STREAM_MAX_QUALITY_PCT = 5.0
DRIFT_STREAM = dict(num_docs=50_000, vocab=65_536, chunks=16, mean_len=20,
                    drift=0.5, seed=0)
SKETCH_STREAM_CHUNKS = 8
STREAM_SMALL = dict(n=4_000, vocab=8_192, features=16_384,
                    sketch_features=200_000, chunks=4)

# the elastic path: the chaos acceptance run of
# benchmarks/bench_chaos.py:112-121 (text_like(60_000, 49_152, mean_len=20,
# seed=0) in 12 np.linspace chunks, k0=8, B=256, device_scan,
# repartition="never") under its disaster script (_EVENTS, :48-57) and
# ChaosSchedule(seed=0): four adds and two seeded kills, k 8 -> 12; gated
# at CHAOS_MAX_QUALITY_PCT (benchmarks/common.py:25) against a one-shot
# partition at k=12; the warm repair's speed over a cold repartition
# reported beside CHAOS_MIN_REPAIR_SPEEDUP (:24), not gated (host wall
# clock, as run() leaves it off).  The same script at PAR with the
# straggler bias on; for cpu against cuda, run(scale=0.1)'s geometry
# (:102-109) and a reduced sketched session
CHAOS = dict(num_docs=60_000, vocab=49_152, k0=8, chunks=12, block=256)
CHAOS_EVENTS = ((2, "add", None, 4.0), (3, "add", None, 4.0),
                (4, "straggle", 1, 4.0), (5, "kill", None, 4.0),
                (6, "add", None, 4.0), (7, "add", None, 4.0),
                (8, "recover", 1, 4.0), (9, "kill", None, 4.0))
CHAOS_MAX_QUALITY_PCT = 5.0
CHAOS_MIN_REPAIR_SPEEDUP = 3.0
# the plain route replays the chaos script's first 6 of 12 feeds (two
# adds, the straggle and the first kill), against the kernels over the
# same feeds: the depth cut for the script's time limit (the two plain
# replays of all 12 feeds take most of phase elastic)
CHAOS_PLAIN_FEEDS = 6
CHAOS_SMALL = dict(num_docs=1_200, vocab=1_638, chunks=12, block=128)
ELASTIC_SKETCH = dict(n=4_000, features=200_000, chunks=4, bits=2048)
# the PS serving path (phase serving).  (a) The closed-loop SLO acceptance
# of benchmarks/bench_slo.py run_acceptance (:439-453): ctr_like(6_000,
# 8_000, nnz_per_row=16, clusters=24, locality=0.85, seed=0), labels +-1
# from default_rng(0), k0=8, 3,072 slots, burst 2.5, service 2 ms a slot,
# visit_over 1.06 (:251-254); the placement a stream feed at B=128 and
# partition_v(sweeps=2) (:258-268); the two-tenant mix (:72-80); the
# disaster script (:102-112); the overload calibrated from two 160-slot
# pilots (:115-159); the SLOConfig and ServingConfig of :290-308 with
# RetryPolicy(timeout_s=0.006, retries=0).  Gated as the bench gates it:
# SLO_MIN_HOLD_FRAC and SLO_MAX_SHED_FRAC (benchmarks/common.py:33-34).
# (b) Open-loop serving on the main graph at full size: one stream feed at
# k=16, B=256, partition_v(sweeps=2), 1 GbE links, bench_slo's mix and
# DBPG config, 512 requests sync and async, against random_parts; then a
# kill at slot 128 with the session attached.  (c) cpu against cuda on the
# traced closed loop of tests/test_obs.py:32-96 (600 x 1,200, K=4, 96
# slots, its chaos script), losses within SERVE_LOSS_REL.
SLO = dict(n_u=6_000, n_v=8_000, nnz=16, clusters=24, k0=8, n_slots=3072,
           burst=2.5, service_model_s=2e-3, visit_over=1.06, pilot_slots=160,
           pilot_warm=32, block=128)
SLO_MIN_HOLD_FRAC = 0.95
SLO_MAX_SHED_FRAC = 0.05
SERVE_OPEN = dict(k=16, block=256, requests=512, warmup=16, kill_at=128,
                  bandwidth=125e6)
SERVE_SMALL = dict(n_u=600, n_v=1_200, nnz=12, clusters=8, k=4, slots=96,
                   bandwidth=6e4)
SERVE_LOSS_REL = 1e-5

# the PS cluster of the paper's Tables 3/4 (benchmarks/bench_table34_dbpg.py
# :21-56): DBPG l1-LR on phase main's partition against a random placement
# (random_parts seeds 0 and 1), PAPER.dbpg_passes iterations; the card's
# first cpu_iters iterations held to the CPU's (meters within
# PS_METER_REL, objectives within PS_OBJ_REL: the card sums the gradient
# in another fixed order); the chaos replay's placement pushed into a
# cluster over its graph for sync_steps steps
PS = dict(lam=0.3, lr=0.005, max_delay=1, flops_rate=50e9, bandwidth=125e6,
          seed=1, label_seed=5, cpu_iters=5, sync_steps=3)
PS_METER_REL = 1e-3
PS_OBJ_REL = 1e-4

# which TPU kernel each CUDA kernel replaces (repro/ file:line of the
# pallas_call wrapper), and its source in this repository
KERNELS = {
    "parsa_cost": ("src/repro/kernels/parsa_cost/parsa_cost.py:55",
                   "src/repro_torch/kernels/parsa_cost/csrc/parsa_cost.cu"),
    "parsa_select_tile": ("src/repro/kernels/parsa_cost/select.py:327",
                          "src/repro_torch/kernels/parsa_cost/csrc/parsa_select.cu"),
    "parsa_select_reduce": ("src/repro/kernels/parsa_cost/select.py:327",
                            "src/repro_torch/kernels/parsa_cost/csrc/parsa_select.cu"),
    "parsa_scan": ("src/repro/kernels/parsa_cost/select.py:327",
                   "src/repro_torch/kernels/parsa_cost/csrc/parsa_scan.cu"),
    "refine_sweep": ("src/repro/kernels/parsa_cost/select.py:263",
                     "src/repro_torch/kernels/parsa_cost/csrc/refine_sweep.cu"),
    "sketch_select": ("src/repro/kernels/parsa_cost/select.py:186",
                      "src/repro_torch/kernels/parsa_cost/csrc/sketch_select.cu"),
    "packed_union_delta": ("src/repro/kernels/parsa_cost/select.py:292",
                           "src/repro_torch/kernels/parsa_cost/csrc/union_delta.cu"),
    "flash_attention": ("src/repro/kernels/flash_attention/flash_attention.py:86",
                        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
}
# the port's own kernels, which replace no TPU kernel: the reference's
# activations as XLA rounds them (no pallas_call; the call sites named are
# the JAX package's MLP)
PORT_KERNELS = {
    "silu_stepwise": ("no TPU kernel: jax.nn.silu as XLA rounds it, "
                      "models/layers.py:356 of the JAX package",
                      "src/repro_torch/kernels/elementwise/csrc/silu_stepwise.cu"),
    "gelu_stepwise": ("no TPU kernel: jax.nn.gelu as XLA rounds it, "
                      "models/layers.py:364 of the JAX package",
                      "src/repro_torch/kernels/elementwise/csrc/silu_stepwise.cu"),
}

# the LM serving path: qwen3-14b at full width and depth (40 layers,
# d_model 5,120, 40 query heads over 8 KV heads, head dim 128, d_ff 17,408,
# vocab 151,936 padded to 152,064), random bf16 weights from SEED; the
# prefill at B=2, S=4,096 into a 4,128-slot cache, the decode loop at
# batch 4, a 32-token prompt and 16 new tokens (64 and 32 until phase
# train_tp needed the time; phases moe, mla, encdec and vlm take them
# too).  Only num_layers may be cut to fit the time limit, never a width.
LM = dict(arch="qwen3-14b", num_layers=None, seed=0, prefill_batch=2,
          prefill_seq=4096, cache_seq=4128, serve_batch=4, prompt=32, gen=16)
LM_MAX_REL_L2 = 5e-2        # kernel route against plain route, and teacher forcing

# the MoE serving path (phase moe): mixtral-8x22b at full width (d_model
# 6,144, 48 query heads over 8 KV heads, head dim 128, d_ff 16,384, 8
# experts, top-2, vocab 32,768, a sliding window of 4,096, rope theta 1e6),
# depth cut to 8 of 56 layers (2,504,060,928 parameters a layer, 20.44 B in
# all, 40.9 GB of random bf16 weights from SEED; 56 layers would be 281 GB
# and 12 about 61 GB before the prefill's transients).  The prefill at
# B=2, S=8,192 (twice the window) into an 8,224-slot cache, the decode
# loop at batch 4, a 32-token prompt and 16 new tokens, as phase lm.  The
# ring cache runs the first 2 layers of the same weights with the window
# cut to 256 (the one cut of a width: 320 decode steps wrap the 256-slot
# ring), against a 320-slot full cache, teacher-forced at batch 1.  Layer
# 0's routing over 32 groups of 512 prefill tokens is placed by Parsa at
# k=4 (device_scan, device refine).  The reduced config's window is 8.
# Teacher forcing holds decode to a prefill at capacity factor 4 = E /
# top-k, whose capacity is its token count: at the config's 1.25 the
# prompt's 256-token prefill may drop assignments that decode keeps.
MOE = dict(LM, arch="mixtral-8x22b", num_layers=8, prefill_seq=8192,
           cache_seq=8224, phase="moe", reduced=dict(swa_window=8),
           teacher_forcing=dict(moe_capacity_factor=4.0), ring_layers=2,
           ring_window=256, ring_steps=320, groups=32, group_tokens=512,
           placement_k=4)

# the MLA serving path (phase mla): deepseek-v2-236b at full width (d_model
# 5,120, 128 heads, q_lora 1,536, kv_lora 512, q/k head dim 128 + 64 rotary,
# v 128, 160 experts top-6 of d_ff 1,536 with 2 shared, vocab 102,400,
# rope theta 1e4), depth cut to 6 of 60 layers (3,972,116,480 parameters a
# layer: 149.2 M MLA, 3,774.9 M routed experts, 47.2 M shared, 0.8 M
# router; the embedding and the untied head 1,048.6 M; 24.88 B in all,
# 49.8 GB of random bf16 weights from SEED; 60 layers would be 239.4 B
# (479 GB), 8 about 65.7 GB before the prefill's transients).  The prefill
# at B=2, S=4,096 into a 4,128-slot cache (C = 384 at T = 8,192), decode as
# phase lm's.  Teacher forcing holds decode to a prefill at capacity factor
# 27 >= E / top-k = 26.7 (C >= T: no drop).  Layer 0's routing over 32
# groups of 256 prefill tokens is placed by Parsa at k=8.
MLA = dict(LM, arch="deepseek-v2-236b", num_layers=6, phase="mla",
           teacher_forcing=dict(moe_capacity_factor=27.0), groups=32,
           group_tokens=256, placement_k=8, cli=dict(batch=4, prompt=16,
                                                     gen=8))
# the encoder-decoder serving path (phase encdec): whisper-medium at full
# width and depth (24 encoder and 24 decoder layers, d_model 1,024, 16/16 x
# 64 heads, d_ff 4,096, GELU, LayerNorm and biases, vocab 51,865 padded to
# 51,968, untied head: 811,790,336 parameters, 1.62 GB of random bf16
# weights from SEED), nothing cut.  The stub front end's frames (B, 1,500,
# 1,024) normal(0, 0.1) from default_rng(SEED); the prefill at B=8 of a
# 224-token decoder prompt (Whisper's previous-text prompt limit, half its
# 448-token decoder context) into a 448-slot self cache, the cross cache
# (24, 8, 1,500, 16, 64) twice (1.18 GB); greedy decode of 64 tokens at
# B=8 from the prefill's cache; phase lm's decode loop at batch 4 (its
# zero cross cache, as the reference's serving CLI) and teacher forcing
# (the prompt's second half decoded from a prefill of its first); the
# serving CLI on the card.
ENCDEC = dict(LM, arch="whisper-medium", phase="encdec", prefill_batch=8,
              prefill_seq=224, cache_seq=448, decode_gen=64,
              cli=dict(batch=4, prompt=16, gen=8))
# the VLM serving path (phase vlm): internvl2-76b at full width (d_model
# 8,192, 64 query heads over 8 KV heads, head dim 128, d_ff 28,672, vocab
# 128,256, rope theta 1e6, 256 patches), depth cut to 24 of its 80 layers
# (855,703,552 parameters a layer, 2,101,346,304 of embedding and untied
# head: 22.64 B in all, 45.3 GB of random bf16 weights from SEED; 80 layers
# would be 141 GB).  Phase lm's prefill at B=2, S=4,096 of text (the
# reference's prefill reads no patches), decode at batch 4 (prompt 32, 16
# new tokens) and teacher forcing; the loss with patches at full width:
# B=2, 256 patches normal(0, 0.1) ahead of 768 text tokens.
VLM = dict(LM, arch="internvl2-76b", num_layers=24, phase="vlm",
           patch_batch=2, patch_text=768)
# the xLSTM path (phase xlstm): xlstm-350m at full width and depth (24
# blocks, 3 groups of 7 mLSTM + 1 sLSTM, d_model 1,024, 4 heads of 256,
# vocab 50,304 padded to 50,432, attn_chunk 1,024), random weights from
# SEED (matrices bf16, gates and recurrent weights float32).  Decode at
# batch 4 (prompt 32 warmed step by step, 16 new tokens; 64 and 32 until
# phase train_tp needed the time); teacher forcing over 32 tokens at
# batch 2 (128 until phase tp_all, 64 until phase train_tp), bf16
# (reported) and float32 (another draw of weights, gated); layer 0's mLSTM at 2,048 tokens (two chunks
# of 1,024) against its recurrence; launch.train at batch 8 x 256, one
# step (depth cuts for the script's time limit: 4 steps until phases
# dist and moe_ep, 2 until phase tp needed the time; sequence 1,024, 16-21
# s a step, until phase train_tp, whose no-mesh route trains the same
# model at 8 x 1,024), the config's 2 microbatches and remat "full"
# (float32 masters).
XLSTM = dict(arch="xlstm-350m", seed=0, serve_batch=4, prompt=32, gen=16,
             tf_batch=2, tf_tokens=32, block_tokens=2048,
             train=dict(batch=8, seq=256, steps=1))
# the hybrid path (phase hybrid): zamba2-2.7b at full width and depth (54
# layers = 9 groups of 5 Mamba2 blocks and the one weight-tied attention
# layer; d_model 2,560, 80 SSM heads of 64, state 64, conv 4; attention 32
# heads of 80, d_ff 10,240; vocab 32,000), random bf16 weights from SEED,
# the SSM state and conv window bf16 as in the reference.  Decode at batch
# 4 (prompt 32 warmed step by step, 16 new tokens, a KV cache a group;
# cut as xLSTM's); teacher forcing over 32 tokens at batch 2 as xLSTM's;
# layer 0's Mamba2
# at 1,024 tokens (the SSD's four chunks of 256) against its recurrence; the
# parallel forward (make_prefill_step's loss) at B=2 x S=4,096.
HYBRID = dict(arch="zamba2-2.7b", seed=0, serve_batch=4, prompt=32, gen=16,
              tf_batch=2, tf_tokens=32, block_tokens=1024, prefill_batch=2,
              prefill_seq=4096)
FLASH_TOL = {"float32": 3e-5, "bfloat16": 2e-2}

# LM training (phase train): qwen3-14b at full width (d_model 5,120, d_ff
# 17,408, 40/8 x 128 heads, padded vocab 152,064, untied head), remat
# "full", 2 microbatches, depth cut to 2 layers (2.218 B float32 master
# parameters; parameter, gradient, m and v 35.5 GB; 4 layers until the
# script's phases vlm, xlstm and hybrid needed the time).  8 steps at batch 8 x
# sequence 1,024 of SyntheticLMData(seed 0), staged by prefetch_batches.
# The failure injected at step 6, resumed through TrainLoop and held
# bitwise to an uninterrupted run, runs on the reduced config with a
# checkpoint every 2 steps: the full-width run's one checkpoint (26.6 GB,
# written and read in 75-85 s) is cut for the script's time.  The
# reduced config's 3 steps on the card are
# held to the CPU's within TRAIN_REL_L2 (float32, TF32 off, sums in
# another order) and to a second card run bitwise.
TRAIN = dict(arch="qwen3-14b", num_layers=2, batch=8, seq=1024, steps=8,
             fail_at=6, seed=0, lr=3e-4, reduced_steps=3,
             reduced_ckpt_every=2, reduced_batch=4, reduced_seq=16)
TRAIN_REL_L2 = 1e-5
# MoE training (phase train_moe): mixtral-8x22b at full width (phase moe's
# widths), depth cut to 1 layer: 2,504,060,928 parameters in the layer and
# 402,653,184 in the embedding and untied head, 2.91 B float32 masters, so
# parameters, gradients, m and v take 46.5 GB; its own remat "full" and 8
# microbatches; 3 steps at batch 8 x sequence 1,024 of
# SyntheticLMData(seed 0), run twice from init_state(seed).  Its checkpoint
# would be 34.9 GB, more than a call's disk writes leave after phase
# train's 26.6 GB, so the resume is held on the reduced config.
TRAIN_MOE = dict(arch="mixtral-8x22b", num_layers=1, batch=8, seq=1024,
                 steps=3, seed=0, lr=3e-4, fail_at=6, reduced_steps=3,
                 reduced_ckpt_every=2, reduced_batch=4, reduced_seq=16,
                 reduced_resume_steps=8)
# the MoE family over a (data x model) mesh (phase moe_ep): mixtral-8x22b
# at full width (phase moe's widths) cut to 1 layer, fsdp (the config's
# own), bf16, random weights from SEED, on mesh (2, 2): 4 experts a model
# rank, F sharded 2 ways over data, and (since FSDP of the dense weights)
# the embed, attention and router cut over data and gathered a layer at a
# time in every prefill and decode step.  The reference's token-path rule puts
# T_loc < 16,384 on the token path: a prefill at B=2, S=4,096 (T_loc
# 4,096) and decode take it, a prefill at B=2, S=32,768 (T_loc 32,768)
# the weight path.  Decode: a 64-token prompt at batch 4, 8 greedy steps.
# The ranks are held to the in-process emulation of the mesh bit for bit,
# and at capacity factor 4 = E / top-k (no drop) to the no-mesh route
# within LM_MAX_REL_L2.
MOE_EP = dict(arch="mixtral-8x22b", num_layers=1, seed=0, mesh=(2, 2),
              token=(2, 4096), weight=(2, 32768), decode=(4, 64, 8),
              no_drop=4.0)
MOE_EP_DEADLINE_S = 300
# the launch.mesh.GATHERED keys phase moe_ep logs a prefill and a decode
# step: the gathers of activations and experts, and of the dense weights
# cut over data (FSDP)
MOE_EP_GATHERED = ("bytes", "calls", "fsdp_bytes", "fsdp_calls")
# dense tensor parallelism over a (data x model) mesh (phase tp).  (a)
# qwen3-14b at full width cut to 4 of 40 layers, bf16, random weights from
# SEED, on mesh (1, 4) over 4 gloo ranks on the one card (NCCL refuses two
# ranks a card): a rank holds 10 of 40 q heads, 2 of 8 kv heads, 4,352 of
# 17,408 MLP columns and 38,016 of 152,064 vocab rows; the prefill at
# B=2, S=4,096 (a flash launch a layer at the rank's 10/2 heads), then a
# 64-token prompt at batch 4 and 8 greedy decode steps.  (b) the same
# model on mesh (1, 1) over one NCCL rank, bit for bit the no-mesh route.
# (c) context parallel: qwen3-14b x 2 layers on mesh (1, 3) over 3 gloo
# ranks, the prefill at B=2, S=3,072 (40 heads do not divide 3): a rank's
# flash launch on its 1,024 query rows at q_offset 0, 1,024 or 2,048
# against all 3,072 keys.  Each rank is held to its place of the
# in-process emulation bit for bit, and the prefill logits to the no-mesh
# route within LM_MAX_REL_L2.
TP = dict(arch="qwen3-14b", num_layers=4, seed=0, mesh=(1, 4),
          prefill=(2, 4096), decode=(4, 64, 8))
TP_CP = dict(arch="qwen3-14b", num_layers=2, seed=0, mesh=(1, 3),
             prefill=(2, 3072), decode=None)
TP_DEADLINE_S = 300
# the rest of the serving path over a mesh (phase tp_all), every part over
# 4 gloo ranks on the one card at full width, bf16, random weights from
# SEED, each rank's blocks cut from a tree drawn one rank at a time (the
# card holds one whole tree beside the blocks): (a) deepseek-v2-236b x 1
# layer on mesh (1, 4), 5.02 B parameters, a rank 32 of 128 heads, 128 of
# 512 latent dims, 16 of 64 rope dims and 40 of 160 experts; the prefill
# at B=2, S=4,096 (one flash launch at (192, 128) on a rank's 32 heads),
# then a 16-token prompt at batch 4 and 8 greedy decode steps against the
# rank's block of the latent cache (a 64-token prompt until phase
# train_tp needed the time: the parts' emulation bounds the phase).  (b) xlstm-350m x 1 group (7 mLSTM +
# 1 sLSTM) on mesh (2, 2): the prefill step's loss at B=4, S=1,024 (4,096
# until phase train_tp needed the time: its emulation, GIL-bound, took
# 35-46 s of the phase) over
# the global batch, then decode from zero states over a 16-token prompt at
# batch 4 and 8 greedy steps.  (c) zamba2-2.7b x 1 group (5 Mamba2 + the
# shared attention layer) on mesh (1, 4), a rank 20 of 80 SSM heads and 8
# of 32 attention heads: the loss at B=2, S=4,096, then the same decode.
# Each rank is held to its place of the in-process emulation bit for bit,
# and the prefill logits (a) or the loss (b, c) to the no-mesh route within
# LM_MAX_REL_L2.
TP_ALL = {
    "mla": dict(arch="deepseek-v2-236b", num_layers=1, seed=0, mesh=(1, 4),
                prefill=(2, 4096), decode=(4, 16, 8)),
    "xlstm": dict(arch="xlstm-350m", num_layers=8, seed=0, mesh=(2, 2),
                  loss=(4, 1024), decode=(4, 16, 8)),
    "hybrid": dict(arch="zamba2-2.7b", num_layers=6, seed=0, mesh=(1, 4),
                   loss=(2, 4096), decode=(4, 16, 8)),
}
TP_ALL_DEADLINE_S = 300
# training over a (data x model) mesh (phase train_tp): make_train_step
# with mesh= at full width, float32 masters cast to bf16 at every product,
# each config's own microbatches and remat, 2 steps at batch 8 x sequence
# 1,024 of SyntheticLMData(seed 0), the second timed; 4 gloo ranks on the
# one card, spawned once for the four parts, each rank's blocks drawn a
# leaf at a time, every rank at once (draw_blocks).  (a) qwen3-14b x 1
# layer on (1, 4):
# 1.89 B parameters, 30 GB of state at 16 B a parameter (master,
# gradient, m, v), 7.6 GB a rank; (2, 2) would hold 15 GB a rank.  (b)
# xlstm-350m x 8 layers (one group: 7 mLSTM + 1 sLSTM) on (2, 2): the
# value-dim cut and the gradient sum over data.  (c) zamba2-2.7b x 6
# layers (one group: 5 Mamba2 + the shared attention) on (2, 2).  (b) and
# (c) compute in float32 (their masters' dtype): in bf16 the recurrent
# families' gradients move by O(1) a leaf under a 1e-3 change of the
# weights (a CPU run of the reduced configs on an emulated (2, 2):
# xlstm-350m's grad norm 2.46 over the mesh against 5.35 without it,
# within what the perturbation alone moves it), so no tolerance would
# hold another order of bf16 sums to them; (a) is bf16.  Before the
# ranks, the script's process runs the no-mesh train step from the same
# masters and batches and frees it.  Each rank's losses and
# grad_norms are held to the no-mesh route's within LM_MAX_REL_L2
# (relative), and its blocks after the steps within LM_MAX_REL_L2
# (relative L2 over every TRAIN_TP_SAMPLE-th element of each leaf block:
# the whole blocks would be 7.6 GB to carry across); every leaf that
# several ranks hold is equal on them bit for bit after every step (an
# exact int64 checksum of its bits on the card).  (d) FSDP of the dense
# weights (ROADMAP Queue 1 item 3b): command-r-35b x 1 layer at full
# width (2.80 B parameters: the tied embed 2.10 B, a layer 0.70 B) with
# its fsdp=True on (2, 2), every dim its spec names "data" cut over data:
# a rank holds a quarter of the tree (11.2 GB of float32 state), against
# half without the cut (22.4 GB a rank, 89.7 GB for 4: more than the
# card).  First a bf16 prefill at B=2 x 4,096 (flash at a rank's 32/4
# heads x 128) and 2 greedy decode steps fed the no-mesh route's tokens,
# then 2 train steps at batch 2 x 1,024 (one microbatch at dp 2),
# float32 masters, bf16 compute, remat "full".  Every part's steps 3 -> 2
# since (d) (its time).
TRAIN_TP = {
    "a": dict(arch="qwen3-14b", num_layers=1, mesh=(1, 4)),
    "b": dict(arch="xlstm-350m", num_layers=8, mesh=(2, 2),
              dtype="float32"),
    "c": dict(arch="zamba2-2.7b", num_layers=6, mesh=(2, 2),
              dtype="float32"),
    "d": dict(arch="command-r-35b", num_layers=1, mesh=(2, 2),
              remat="full", run=dict(batch=2, seq=1024),
              serve=dict(prefill=(2, 4096), decode=2)),
}
TRAIN_TP_RUN = dict(batch=8, seq=1024, steps=2, seed=0, lr=3e-4)
TRAIN_TP_SAMPLE = 97
TRAIN_TP_DEADLINE_S = 480
# part (d)'s gate: a rank's peak after the cut, its blocks and optimizer
# state (11.2 GB) beside one layer's and the embedding's gathered weights
TRAIN_TP_FSDP_PEAK_GB = 16.0
# the elementwise kernels' checks and times (phases kernels and times)
ELEMENTWISE_N = {"bfloat16": 64 << 20, "float32": 16 << 20}
ELEMENTWISE_SHAPES = {
    "silu_stepwise": (("qwen3-14b decode step", (4, 1, 17408)),
                      ("qwen3-14b prefill", (2, 4096, 17408))),
    "gelu_stepwise": (("whisper-medium decoder step", (8, 1, 4096)),
                      ("whisper-medium encoder", (8, 1500, 4096))),
}
# arithmetic operations an element, each counted once against the CUDA
# cores' rate: silu's negation, exp, add, reciprocal and product; gelu's
# square, cube, two products, add, product, tanh, add, half and product
ELEMENTWISE_OPS = {"silu_stepwise": 5, "gelu_stepwise": 10}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- inputs
def rand_words(rng, shape, density=None):
    """int32 words: full-range random bits (bit 31 included), or each bit
    set with probability ``density``."""
    import numpy as np

    if density is None:
        return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.int32)[..., 0]


def sparse_rows(rng, n, num_v, max_len=60):
    from repro_torch.kernels.parsa_cost import pack_bitmask

    return pack_bitmask([rng.choice(num_v, size=int(rng.integers(0, max_len)),
                                    replace=False) for _ in range(n)], num_v)


def consistent_prev(rng, words, frac=0.6):
    """A previous assignment that only ever names a needer."""
    import numpy as np

    k, cw = words.shape
    bits = ((words.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32))
            & 1).reshape(k, 32 * cw)
    prev = np.full(32 * cw, -1, np.int32)
    for j in range(32 * cw):
        nz = np.flatnonzero(bits[:, j])
        if nz.size and rng.random() < frac:
            prev[j] = rng.choice(nz)
    return prev


def scan_case(rng, nw, nb, B, W, k, cap, *, pad_block=False, init=False,
              unequal=False, dup=False):
    """A worker-sharded block stack for parsa_scan, packed by the scan's
    own packer from a random graph on 32 W columns: (nw, nb, B, ...) lists
    and side channel, every 7th row's columns on bit 31 (negative words),
    a short last real block, then ``nw`` blocks of padding rows only if
    ``pad_block``; with ``dup`` every row repeats one of 3 rows (ties
    everywhere: the greedy slots collide on the same rows).  Also the
    entering (nw, k, W) sets (random sparse words if ``init``) and (nw, k)
    sizes (unequal by one if ``unequal``)."""
    import numpy as np

    from repro_torch.core.bipartite import BipartiteGraph
    from repro_torch.core.partition import _pad_block_stack, pack_graph_blocks

    real = max(1, nw * nb - (nw if pad_block else 0))
    n = max(1, real * B - B // 3)
    num_v = 32 * W
    lens = rng.integers(0, 3 * cap, n)
    rows = []
    for u, m in enumerate(lens):
        if dup and u >= 3:
            rows.append(rows[u % 3])
            continue
        cols = rng.choice(num_v, size=min(int(m), num_v), replace=False)
        if u % 7 == 0:
            cols = np.unique(cols | 31)
        rows.append(np.sort(cols))
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    g = BipartiteGraph(n, num_v, indptr.astype(np.int64),
                       np.concatenate(rows).astype(np.int32))
    pk = _pad_block_stack(pack_graph_blocks(g, B, cap=cap), nw * nb)

    def shard(a):
        return np.ascontiguousarray(a.reshape((nw, nb) + a.shape[1:]))

    s = (rand_words(rng, (nw, k, W), 0.05) if init
         else np.zeros((nw, k, W), np.int32))
    sizes = np.full((nw, k), 3, np.int32)
    if unequal:
        sizes += (rng.random((nw, k)) < 0.5).astype(np.int32)
    return ([shard(x) for x in (pk.widx, pk.vals, pk.tr_ids, pk.tr_masks,
                                pk.valid)], s, sizes,
            int(pk.trunc.sum()))


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.parsa_cost import (
        compact_rows, merge_worker_sets_ref, ops, packed_union_delta_ref,
        parsa_cost_ref, refine_sweep_ref, select_from_cost,
        select_greedy_from_cost, sketch_select_ref)

    rng = np.random.default_rng(0)
    res = {name: {"cases": 0, "max_abs_err": 0} for name in KERNELS}

    def compare(name, got, want, case):
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {case}: shape/dtype {g.shape} {g.dtype} vs "
                  f"{w.shape} {w.dtype}")
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            check(torch.equal(g, w), f"{name} {case}: differs from plain "
                  f"version (max abs err {err})")
        res[name]["cases"] += 1

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def check_sketch_select(nbr, s, retired, order, enabled, greedy, case):
        """sketch_cost_select against sketch_select_ref, twice: on lists
        the wrapper builds from the dense block (cap ROW_CAP) and on lists
        of cap 6 passed in (most rows truncated, read densely), as the scan
        passes its own; and the route each took: sketch_select inside the
        guard, parsa_select past it."""
        kw = dict(order=order, enabled=enabled) if greedy else {}
        u, c = sketch_select_ref(nbr, s, retired, *kw.values(),
                                 greedy=greedy)
        want = (u[0], c[0]) if greedy else (c[0], u[0])
        B, k = nbr.shape[0], s.shape[0]
        out = None
        for rows in (None, compact_rows(nbr, 6)):
            before = dict(ops.LAUNCHES)
            got = ops.sketch_cost_select(nbr, s, retired, rows=rows, **kw)
            moved = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES
                     if ops.LAUNCHES[n] != before[n]}
            compare("sketch_select", got, want,
                    case + ("built lists" if rows is None else "cap 6",))
            if ops.sketch_select_fits(B, k):
                check(moved == {"sketch_select": 1},
                      f"sketch_select {case}: launched {moved}")
            else:
                check(moved == {"parsa_select_tile": 1,
                                "parsa_select_reduce": 1},
                      f"sketch_select {case} past the guard: launched {moved}")
                res["sketch_select"]["routed_past_guard"] += 1
            out = got if out is None else out
        return out

    # the cost tile: U of 7, 256, 259 and 1,001 (259 and 1,001 not a
    # multiple of the 2, 4 or 8 rows a CTA takes), K of 1 to 1,024, and for
    # parsa_cost 1,025 and 2,100 below (K of 1,024 and more only at small U:
    # the plain version's (U, K, W) intermediate), W of 1 to 2,048 (16-byte
    # loads at W % 4 == 0, 4-byte loads else); full-range words and sparse
    # rows, each block with an all-zero and an all-ones row; the K = 1
    # down-date of host_blocked_oracle against its complement mask ~(N(u) &
    # ~S_i) (almost all ones); parsa_select_tile on the same inputs (the
    # transposed store); and a block 4 bytes off 16-byte alignment
    res["parsa_cost"]["down_dates"] = 0
    for W in (1, 2, 33, 2047, 2048):
        for U, Ks in ((7, (1, 3, 16, 17, 64, 1024)), (256, (1, 16, 17, 64)),
                      (259, (1024,)), (1001, (1, 3, 17, 64))):
            for kind in ("full", "sparse"):
                nbr = (rand_words(rng, (U, W)) if kind == "full"
                       else sparse_rows(rng, U, 32 * W,
                                        max_len=min(60, 32 * W)))
                nbr[0], nbr[-1] = 0, -1
                nbr = T(nbr)
                for Kc in Ks:
                    s = T(rand_words(rng, (Kc, W), 0.3))
                    want = parsa_cost_ref(nbr, s)
                    compare("parsa_cost", [ops.parsa_cost(nbr, s)], [want],
                            (U, Kc, W, kind))
                    compare("parsa_select_tile",
                            [ops.parsa_select_tile(nbr, s)],
                            [want.T.contiguous()], (U, Kc, W, kind))
                comp = ~(nbr[U // 2: U // 2 + 1] & ~s[:1])
                compare("parsa_cost", [ops.parsa_cost(nbr, comp)],
                        [parsa_cost_ref(nbr, comp)], (U, 1, W, kind, "down"))
                res["parsa_cost"]["down_dates"] += 1
    off = torch.empty(256 * 2048 + 1, dtype=torch.int32, device=dev)
    shifted = off[1:].view(256, 2048)
    shifted.copy_(nbr[:256, :2048])
    compare("parsa_cost", [ops.parsa_cost(shifted, s)],
            [parsa_cost_ref(shifted, s)], (256, s.shape[0], 2048, "offset"))
    # K past 1,024 (parsa_cost only): the tile reads a row again for each
    # further group of 1,024 partitions
    for U, Kc, W, kind in ((7, 2100, 33, "full"), (131, 2100, 2048, "sparse"),
                           (33, 1025, 2047, "full")):
        nbr = (rand_words(rng, (U, W)) if kind == "full"
               else sparse_rows(rng, U, 32 * W, max_len=60))
        nbr[0], nbr[-1] = 0, -1
        nbr, s = T(nbr), T(rand_words(rng, (Kc, W), 0.3))
        compare("parsa_cost", [ops.parsa_cost(nbr, s)],
                [parsa_cost_ref(nbr, s)], (U, Kc, W, kind, "groups"))
    torch.cuda.synchronize()

    W = 2048
    num_v = 32 * W
    # B x k sweep, plus the largest k the wrapper takes
    shapes = [(B, k) for B in (256, 1024) for k in (8, 16, 64)]
    for B, k in shapes + [(256, ops.SELECT_MAX_K)]:
        for dense in (False, True):
            nbr = T(rand_words(rng, (B, W)) if dense
                    else sparse_rows(rng, B, num_v))
            s = T(rand_words(rng, (k, W), 0.25))
            retired = T(rng.random(B) < 0.3)
            order = T(rng.permutation(k).astype(np.int32))
            enabled = T(rng.random(k) < 0.8)
            tile = ops.parsa_select_tile(nbr, s)
            compare("parsa_select_tile", [tile],
                    [parsa_cost_ref(nbr, s).T.contiguous()], (B, k, dense))
            plain = tile.clone()
            compare("parsa_select_reduce",
                    ops.parsa_select_reduce(tile, retired),
                    select_from_cost(plain.T, retired), (B, k, "indep"))
            compare("parsa_select_reduce",
                    ops.parsa_select_reduce(tile, retired, order, enabled),
                    select_greedy_from_cost(plain.T, retired, order,
                                            enabled), (B, k, "greedy"))
    # all-identical columns: the worst-case collision cascade
    B, k = 1024, 64
    nbr = T(sparse_rows(rng, B, num_v, max_len=25))
    s = torch.zeros((k, W), dtype=torch.int32, device=dev)
    retired = torch.zeros(B, dtype=torch.bool, device=dev)
    order = torch.arange(k, dtype=torch.int32, device=dev)
    enabled = torch.ones(k, dtype=torch.bool, device=dev)
    u, c = ops.parsa_cost_select(nbr, s, retired, order=order, enabled=enabled)
    compare("parsa_select_reduce", [u, c], select_greedy_from_cost(
        parsa_cost_ref(nbr, s), retired, order, enabled), "cascade")
    check(len(set(u.tolist())) == k and bool((c < 2**30).all()),
          "cascade: picks are not k distinct active rows")
    torch.cuda.synchronize()

    # sketch_select: one launch per round inside its shared-memory guard,
    # the two parsa_select launches past it (B=1024, k=64), same bits
    res["sketch_select"]["routed_past_guard"] = 0
    words = {"sparse": lambda B, W: sparse_rows(rng, B, 32 * W, max_len=30),
             "full": lambda B, W: rand_words(rng, (B, W)),
             "bit31": lambda B, W: rand_words(rng, (B, W), 0.1)
             | np.int32(-2**31)}
    for B in (8, 256, 1024):
        for k in (1, 8, 16, 64):
            for W, kind in ((12, "sparse"), (37, "bit31"), (131, "full"),
                            (4096, "sparse")):
                if W == 4096 and k > 16:
                    continue
                nbr = T(words[kind](B, W))
                s = T(rand_words(rng, (k, W), 0.2)
                      | (np.int32(-2**31) if kind == "bit31" else 0))
                retired = T(rng.random(B) < 0.3)
                order = T(rng.permutation(k).astype(np.int32))
                enabled = T(rng.random(k) < 0.8)
                for greedy in (False, True):
                    case = (B, k, W, kind, "greedy" if greedy else "indep")
                    check_sketch_select(nbr, s, retired, order, enabled,
                                        greedy, case)
    # the all-identical-columns cascade, inside and past the guard
    for B, k in ((1024, 16), (256, 64), (1024, 64)):
        nbr = T(sparse_rows(rng, B, 32 * 4096, max_len=25))
        s = torch.zeros((k, 4096), dtype=torch.int32, device=dev)
        retired = torch.zeros(B, dtype=torch.bool, device=dev)
        order = torch.arange(k, dtype=torch.int32, device=dev)
        enabled = torch.ones(k, dtype=torch.bool, device=dev)
        u, c = check_sketch_select(nbr, s, retired, order, enabled, True,
                                   (B, k, "cascade"))
        check(len(set(u.tolist())) == k and bool((c < 2**30).all()),
              f"sketch_select cascade {B, k}: picks are not k distinct rows")
    check(res["sketch_select"]["routed_past_guard"] > 0,
          "no sketch_select case past the guard")
    torch.cuda.synchronize()

    # parsa_scan against its plain version, bit for bit: parts, sets and
    # sizes, at W of 64, 2,048 and 4,096 words, B of 8, 40 and 128, k of
    # 1, 3 and 16, with 1, 4 and 8 workers; truncated rows (cap 6 or 12),
    # all-padding blocks, bit-31 words, entering sets, entering sizes
    # unequal by one (the catch-up round); and a sub-range of blocks, as a
    # super-step scans it
    from repro_torch.kernels.parsa_cost import parsa_scan_ref

    res["parsa_scan"].update(truncated_rows=0, rounds_max=0)
    flags = [dict(), dict(pad_block=True, unequal=True),
             dict(init=True, unequal=True), dict(pad_block=True, init=True),
             dict(dup=True, unequal=True)]
    n_case = 0
    # k = 2 is the elastic grow's split (at the chaos arena's 1,536 words
    # and B of 256 too); past the epilogue's 32 candidates a slot (k of 33
    # and 64) and k = 16 with every row tied, beside the sweep; then the
    # sketch path's shape,
    # more than 32 rows a CTA (B of 512 and 1,024 at 4,096 words, k = 16:
    # the cost pass at 8 lanes a row), at 1 and 8 workers with truncated
    # rows
    shapes = ([(W, B, k, None) for W in (64, 2048, 4096)
               for B in (8, 40, 128) for k in (1, 2, 3, 16)]
              + [(1536, 256, 2, None)]
              + [(64, 40, 33, None), (64, 128, 64, None),
                 (2048, 128, 64, None)]
              + [(4096, B, 16, nw) for B in (512, 1024) for nw in (1, 8)])
    for W, B, k, nw in shapes:
        wide = nw is not None
        nw = nw or (1, 4, 8)[n_case % 3]
        nb = 3 if nw == 1 else 2
        cap = (6, 12)[n_case % 2] if wide else (6, 12, 48)[n_case % 3]
        fl = flags[n_case % 5]
        n_case += 1
        arrays, s0, sz0, n_tr = scan_case(rng, nw, nb, B, W, k, cap,
                                          **fl)
        check(not wide or n_tr > 0, f"parsa_scan {W, B, k, nw}: no "
              "truncated row")
        res["parsa_scan"]["truncated_rows"] += n_tr
        res["parsa_scan"]["rows_a_cta_max"] = max(
            res["parsa_scan"].get("rows_a_cta_max", 0), -(-B // 8))
        res["parsa_scan"]["rounds_max"] = max(
            res["parsa_scan"]["rounds_max"], 1 + -(-(B - 1) // k))
        args = [T(a) for a in arrays]
        ranges = [(0, nb)] + ([(1, nb - 1)] if nb > 2 else [])
        for b0, nblk in ranges:
            out = []
            for fn in (ops.parsa_scan, parsa_scan_ref):
                st = [T(s0.copy()), T(sz0.copy()),
                      torch.full((nw, nb, B), -1,
                                 dtype=torch.int32, device=dev)]
                if fn is ops.parsa_scan:
                    fn(*args, *st, b0=b0, nblk=nblk)
                else:
                    fn(*args, *st, b0, nblk)
                out.append(st)
            compare("parsa_scan", out[0], out[1],
                    (W, B, k, nw, cap, b0, nblk, tuple(fl)))
    torch.cuda.synchronize()

    # refine: one chunk and one sweep (refine_sweep_chunk) at the main
    # path's chunk width and the largest k the wrapper takes; then the
    # one-launch refine (refine_scan) over chunks and sweeps against
    # refine_scan_ref, in place and not, with costs near and past the
    # packed key's range (kSat = 2^22 - 1) and negative ones, which take
    # the exact min
    from repro_torch.kernels.parsa_cost import refine_scan_ref

    for k, cw in ((16, 32), (64, 32), (ops.REFINE_MAX_K, 4)):
        for sweep in (1, 2):
            words = rand_words(rng, (k, cw), 0.2)
            words[:, -1] &= 0xFFFF  # some empty parameters
            prev = (np.full(32 * cw, -1, np.int32) if sweep == 1
                    else consistent_prev(rng, words))
            cost = rng.integers(0, 3000, k).astype(np.int32)
            w_t, p_t, c_t = T(words), T(prev), T(cost)
            compare("refine_sweep", ops.refine_sweep_chunk(w_t, p_t, c_t),
                    refine_sweep_ref(w_t, p_t, c_t), (k, cw, sweep))
    for k in (1, 16, 33):
        for sweeps in (1, 2, 3):
            for n, cw in ((1, 1), (3, 4), (2, 32)):
                words = rand_words(rng, (n, k, cw), 0.3)
                words[:, :, -1] &= 0xFFFF
                prev = np.stack([consistent_prev(rng, words[c], 0.3)
                                 for c in range(n)])
                cost = rng.integers(0, 3000, k).astype(np.int32)
                if sweeps == 2:
                    cost[::2] += (1 << 22) - 40   # near and past kSat
                if sweeps == 3:
                    cost[1::3] -= 4000            # negative costs
                w_t, p_t, c_t = T(words), T(prev), T(cost)
                want = refine_scan_ref(w_t, p_t, c_t, sweeps)
                compare("refine_sweep", ops.refine_scan(w_t, p_t, c_t,
                                                        sweeps),
                        want, (k, sweeps, n, cw))
                inplace = p_t.clone()
                got_c, got_p = ops.refine_scan(w_t, inplace, c_t, sweeps,
                                               out=inplace)
                compare("refine_sweep", [got_c, got_p], want,
                        (k, sweeps, n, cw, "in place"))
                check(got_p.data_ptr() == inplace.data_ptr(),
                      "refine_scan(out=prev) did not write in place")
    torch.cuda.synchronize()

    # packed_union_delta: the TPU contract (n = 1, with delta) over the
    # k x W sweep, the parallel path's width and ragged widths; then the
    # n-worker merge with its pushed-word count, at the acceptance shape
    # (n = 8, k = 16, W = 2,048) among them.  Words with bit 31 set in all.
    for k in (1, 3, 8, 16):
        for W in (1, 37, 512, 1000, 2048, 2049, 3001):
            new = rand_words(rng, (k, W))
            new[:, 0] |= np.int32(-2**31)
            old = rand_words(rng, (k, W), 0.3)
            n_t, o_t = T(new), T(old)
            compare("packed_union_delta", ops.packed_union_delta(n_t, o_t),
                    packed_union_delta_ref(n_t, o_t), (k, W))
    # the merge of a super-step: union, count, merged sizes and every
    # worker's written-back sets and sizes against merge_worker_sets_ref,
    # at odd k * W (4-byte loads) and at the acceptance shape (n = 8, k =
    # 16, W = 2,048), and once on copies 4 bytes off 16-byte alignment
    for n in (1, 2, 4, 8):
        for k, W, offset in ((1, 1, 0), (3, 37, 0), (5, 2047, 0),
                             (16, 2048, 0), (16, 2049, 0), (8, 1000, 0),
                             (16, 2048, 1)):
            old = rand_words(rng, (k, W), 0.3)
            old[:, 0] |= np.int32(-2**31)
            local = old | rand_words(rng, (n, k, W), 0.02)
            sz_old = rng.integers(0, 2**31 - 64, k).astype(np.int32)
            sz_loc = sz_old + rng.integers(0, 40, (n, k)).astype(np.int32)
            l_t, o_t, z_t, zo_t = T(local), T(old), T(sz_loc), T(sz_old)
            if offset:
                buf = torch.empty(l_t.numel() + 1, dtype=torch.int32,
                                  device=dev)
                l_t = buf[1:].view(l_t.shape).copy_(l_t)
            l_ref, z_ref = l_t.clone(), z_t.clone()
            pushed = torch.full((1,), 5, dtype=torch.int64, device=dev)
            merged, sizes = ops.merge_worker_sets(l_t, o_t, z_t, zo_t, pushed)
            want, want_sz, n_words = merge_worker_sets_ref(l_ref, o_t, z_ref,
                                                           zo_t)
            compare("packed_union_delta",
                    [merged, sizes, pushed - 5, l_t, z_t],
                    [want, want_sz, n_words.view(1), l_ref, z_ref],
                    ("merge", n, k, W, offset))
    torch.cuda.synchronize()
    res["flash_attention"] = check_flash(dev)
    res.update(check_elementwise(dev))
    res["moe_slot_gather"] = check_slot_gather(dev)
    return res


def same_bits(got, want) -> tuple[bool, bool]:
    """(NaN where NaN and every other bit equal, every bit equal with the
    NaNs' payloads too) of two float tensors of one dtype."""
    import torch

    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    nan = torch.isnan(want)
    same = bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(
        got.view(bits)[~nan], want.view(bits)[~nan]))
    return same, bool(torch.equal(got.view(bits), want.view(bits)))


def check_elementwise(dev) -> dict:
    """silu_stepwise and gelu_stepwise against their plain chains on the
    card, bit for bit (tolerance 0; NaN payloads reported): ELEMENTWISE_N
    values of normal(0, 4) in bfloat16 and float32 with the special values
    ahead, whole, as a view one element past the start (off 16-byte
    alignment: the kernel's one-element loop) with an odd length (the
    tail), and transposed (a dense layout, kept without a copy); one
    launch a call."""
    import torch

    from repro_torch.kernels import elementwise as EW

    specials = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), -90.0,
                90.0, -88.0, 88.0, 1e-30, -1e-30, 5e-39, -5e-39, 3.0e38]
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, kern, plain in (
            ("silu_stepwise", EW.silu_stepwise, EW.silu_stepwise_ref),
            ("gelu_stepwise", EW.gelu_stepwise, EW.gelu_stepwise_ref)):
        res = {"cases": 0, "max_abs_err": 0.0, "nan_payloads_equal": True,
               "elements": {}}
        for dtype, n in ELEMENTWISE_N.items():
            dt = getattr(torch, dtype)
            x = torch.randn(n, generator=gen, device=dev).mul_(4).to(dt)
            x[:len(specials)] = torch.tensor(specials, device=dev).to(dt)
            for case, v in (("whole", x), ("offset, odd length",
                                           x[1:n - 2]),
                             ("transposed", x.view(4, -1).t())):
                EW.reset_launch_counts()
                got = kern(v)
                check(EW.LAUNCHES[name] == 1,
                      f"{name} {dtype} {case}: {EW.LAUNCHES} launches")
                want = plain(v)
                check(got.stride() == v.stride(),
                      f"{name} {dtype} {case}: strides {got.stride()}, the "
                      f"input's {v.stride()}")
                same, payloads = same_bits(got, want)
                fin = torch.isfinite(want)
                err = float((got.float() - want.float())[fin].abs().max())
                check(same, f"{name} {dtype} {case}: differs from the plain "
                      f"chain (max abs err {err:.3e})")
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["nan_payloads_equal"] &= payloads
                res["cases"] += 1
            res["elements"][dtype] = n
            del x, got, want
        log(f"{name}: bit for bit equal to its plain chain on "
            f"{res['elements']} elements ({res['cases']} cases; NaN payloads "
            f"equal: {res['nan_payloads_equal']})")
        out[name] = res
    EW.reset_launch_counts()
    torch.cuda.empty_cache()
    return out


def check_slot_gather(dev) -> dict:
    """The MoE dispatch's gather (``moe._gather_slots``) at
    mixtral-8x22b's width, T = 8,192 tokens top-2 over 8 experts in bf16:
    its ordered backward twice, bit for bit, and within bf16 rounding of
    the default index backward (reported)."""
    import torch

    from repro_torch.models import moe as M

    T, D, E, K = 8192, 6144, 8, 2
    gen = torch.Generator(device=dev).manual_seed(6)
    top_e = torch.rand((T, E), generator=gen, device=dev).argsort(
        dim=1)[:, :K]
    order = torch.argsort(top_e.reshape(-1), stable=True)
    st = (torch.arange(T * K, device=dev) // K)[order]
    x = torch.randn((T, D), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((T * K, D), generator=gen, device=dev).to(torch.bfloat16)
    grads = []
    for gather in (M._gather_slots, M._gather_slots,
                   lambda a, i, k: a[i]):
        a = x.clone().requires_grad_()
        gather(a, st, K).backward(g)
        grads.append(a.grad)
    check(torch.equal(grads[0], grads[1]),
          "the MoE slot gather's ordered backward differs between two runs")
    out = {"shape": [T, D, K], "bitwise_twice": True,
           "max_abs_err_index_backward": float(
               (grads[0].float() - grads[2].float()).abs().max())}
    log(f"moe slot gather backward: two runs bit for bit equal at T={T}, "
        f"D={D}, K={K} bf16; against the index backward max abs err "
        f"{out['max_abs_err_index_backward']:.3e}")
    return out


def elementwise_launches(fn) -> dict:
    """The elementwise kernels' launches of one call of ``fn``, counted
    from 0 (the counts are left at them)."""
    import torch

    from repro_torch.kernels import elementwise as EW

    EW.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return dict(EW.LAUNCHES)


def check_flash(dev, full=(2, 4096, 40, 8, 128),
                vlm_full=(2, 4096, 64, 8, 128)) -> dict:
    """flash_attention against its plain version on the card, within
    FLASH_TOL (|got - want| <= tol + tol * |want|): float32 with TF32 off
    in the plain version's products, bfloat16; GQA and MHA; causal,
    non-causal, causal with a window whose first tile lies outside some
    rows' window; Sq < Skv (left-aligned); S=100; D in {32, 64, 128, 256};
    K and V as strided views of a longer cache; the prefill's full-width
    shape and the VLM prefill's (64/8 heads); the tensor-core route's tile edges (Sq of 127, 129, 255, a
    window of 100 across 128-key tiles, Sq < Skv, strided views, D of 64
    and 128); v at its own head dim Dv < Dqk (MLA's (192, 128) on both
    routes at a ragged S of 300, causal and not; (24, 16), the reduced
    config's, on the FMA route).  Both kernel routes (TMA + wgmma for bf16
    at (Dqk, Dv) in ``WGMMA_DIMS``, FMA otherwise) are run, every bf16 case
    at those head dims on the first."""
    import torch

    from repro_torch.kernels.flash_attention import (
        WGMMA_DIMS, flash_attention, flash_attention_ref, uses_tensor_cores)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"cases": 0, "max_abs_err": 0.0, "max_abs_err_full_shape": None,
           "max_abs_err_vlm_shape": None, "tolerance": dict(FLASH_TOL),
           "wgmma_cases": 0, "fma_cases": 0}
    cases = []
    for dt in ("float32", "bfloat16"):
        for (B, Sq, Skv, H, KV, D, causal, window) in (
                (2, 128, 128, 8, 2, 64, True, None),     # GQA
                (2, 128, 128, 4, 4, 128, True, None),    # MHA
                (1, 192, 192, 4, 2, 128, False, None),   # non-causal
                (1, 256, 256, 4, 2, 64, True, 64),       # window, tiles of 64
                (1, 256, 256, 2, 1, 128, True, 100),     # window, no tile multiple
                (2, 64, 192, 4, 2, 64, True, None),      # Sq < Skv
                (1, 64, 192, 4, 1, 128, False, None),    # Sq < Skv, non-causal
                (2, 100, 100, 4, 2, 128, True, None),    # ragged length
                (1, 100, 100, 4, 4, 64, False, 30),
                (1, 96, 96, 4, 2, 32, True, None),       # FMA route for bf16
                (1, 80, 80, 2, 1, 256, True, None),
                # the tensor-core route's 128-row query and 128-key tiles:
                (2, 127, 127, 4, 2, 128, True, None),    # a row short
                (2, 129, 129, 4, 2, 64, True, None),     # a row past
                (1, 255, 255, 4, 1, 128, True, None),
                (1, 300, 300, 2, 2, 128, True, 100),     # window across tiles
                (1, 300, 300, 4, 2, 64, True, 100),
                (2, 100, 260, 4, 2, 128, True, None),    # Sq < Skv
                (1, 129, 333, 4, 2, 64, False, None)):
            cases.append((dt, B, Sq, Skv, H, KV, D, causal, window, False, D))
        cases.append((dt, 2, 200, 200, 8, 2, 128, True, None, True, 128))
        cases.append((dt, 2, 255, 255, 4, 2, 64, False, None, True, 64))
        # MLA: v at its own head dim
        for causal in (True, False):
            cases.append((dt, 2, 300, 300, 4, 4, 192, causal, None, False,
                          128))
        cases.append((dt, 2, 100, 100, 4, 2, 24, True, None, False, 16))
    for fb, fs, fh, fkv, fd in (full, vlm_full):   # the prefills' shapes
        cases.append(("bfloat16", fb, fs, fs, fh, fkv, fd, True, None, False,
                      fd))
    for dt, B, Sq, Skv, H, KV, D, causal, window, strided, Dv in cases:
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q = rnd(B, Sq, H, D)
        if strided:  # views of a longer cache, as the prefill hands them
            k = rnd(B, Skv + 56, KV, D)[:, :Skv]
            v = rnd(B, Skv + 56, KV, Dv)[:, :Skv]
        else:
            k, v = rnd(B, Skv, KV, D), rnd(B, Skv, KV, Dv)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        tol = FLASH_TOL[dt]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        case = (dt, B, Sq, Skv, H, KV, D, causal, window, strided, Dv)
        check(bool(torch.isfinite(got.float()).all()), f"flash {case}: not finite")
        check(bool((diff <= tol + tol * want.float().abs()).all()),
              f"flash_attention {case}: max abs err {err} past tolerance {tol}")
        out["cases"] += 1
        out["max_abs_err"] = max(out["max_abs_err"], err)
        wgmma = uses_tensor_cores(q, k, v)
        check(wgmma == (dt == "bfloat16" and (D, Dv) in WGMMA_DIMS),
              f"flash_attention {case}: tensor-core route {wgmma}")
        out["wgmma_cases" if wgmma else "fma_cases"] += 1
        if Dv != D:
            route = "wgmma" if wgmma else "fma"
            key = f"max_abs_err_dv_{route}_{dt}"
            out[key] = max(out.get(key, 0.0), err)
        if (B, Sq, H, KV, D) == full:
            out["max_abs_err_full_shape"] = err
        if (B, Sq, H, KV, D) == vlm_full:
            out["max_abs_err_vlm_shape"] = err
        del q, k, v, got, want, diff
    check(out["wgmma_cases"] > 0 and out["fma_cases"] > 0,
          f"flash routes not both run: {out}")
    torch.cuda.empty_cache()
    return out


def kernel_resources(libs: dict) -> dict:
    """What ``nvcc -Xptxas -v`` said of the kernels redesigned for Hopper
    (registers, static shared memory, spills of each entry, and any
    setmaxnreg or wgmma warning), whether the flash library's SASS holds
    HGMMA (wgmma) and UTMALDG (TMA load) instructions, and which global
    loads parsa_scan's SASS holds, by ``cuobjdump -sass``.  The dynamic
    shared memory is the kernels' own: 160 KB + 1 KB a CTA for
    flash_wgmma at D=128 and 208 KB + 1 KB at (Dqk, Dv) = (192, 128), B * k * 4 bytes for sketch_select,
    ``ops.scan_smem_bytes`` for parsa_scan, rows * ((k | 1) * 4 + 2,048)
    bytes for cost_tile_kernel (2, 4 or 8 rows)."""
    import re
    import shutil

    from repro_torch.kernels import nvcc
    from repro_torch.kernels.elementwise import build as ew_build
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.parsa_cost import build as pc_build

    logs = {**pc_build.FAMILY.logs, **fa_build.FAMILY.logs,
            **ew_build.FAMILY.logs}
    tool = pathlib.Path(nvcc._nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found: the SASS is not checked")
    out = {}
    for lib, kern in (("flash_attention", "flash_wgmma"),
                      ("sketch_select", "sketch_select_kernel"),
                      ("parsa_scan", "parsa_scan_kernel"),
                      ("refine_sweep", "refine_sweep_kernel"),
                      ("parsa_cost", "cost_tile_kernel"),
                      ("union_delta", "union_delta_kernel"),
                      ("silu_stepwise", "elementwise_kernel")):
        entries, cur, notes = [], None, []
        if lib not in logs:  # built by an earlier process
            res = subprocess.run([tool, "--dump-resource-usage",
                                  str(libs[lib])], capture_output=True,
                                 text=True, check=True).stdout
            entries = [line.strip() for line in res.splitlines()
                       if kern in line or "REG:" in line]
        for line in logs.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = {"entry": m.group(1)} if kern in m.group(1) else None
                if cur is not None:
                    entries.append(cur)
                continue
            if re.search(r"setmaxnreg|[Pp]erformance|[Ww]arning", line):
                notes.append(line.strip())
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(m.group(1)) if m else 0
        out[kern] = {"ptxas": entries, "notes": notes}
        log(f"ptxas {kern}: " + json.dumps(out[kern]))
    # parsa_scan writes S during its launch: its S loads must be strong
    # loads (LDG.E.STRONG.*), never the read-only path (LDG.E.CONSTANT,
    # which the lists and the side channel may use)
    scan_sass = subprocess.run([tool, "-sass", str(libs["parsa_scan"])],
                               capture_output=True, text=True,
                               check=True).stdout
    loads = {}
    for m in re.finditer(r"\b(LDG\.E[.A-Z0-9]*)", scan_sass):
        loads[m.group(1)] = loads.get(m.group(1), 0) + 1
    out["parsa_scan_sass_loads"] = loads
    log(f"parsa_scan SASS global loads: {loads}")
    check(any("STRONG" in op for op in loads),
          f"parsa_scan reads S by no strong load: {loads}")
    sass = subprocess.run([tool, "-sass", str(libs["flash_attention"])],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG", "HMMA")}
    out["flash_sass"] = counts
    log(f"flash_attention SASS: {counts['HGMMA']} HGMMA, "
        f"{counts['UTMALDG']} UTMALDG, {counts['HMMA']} HMMA instructions")
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
          f"the flash library holds no wgmma or TMA instruction: {counts}")
    return out


# ---------------------------------------------------------------- phase 3
def phase_main(dev) -> dict:
    import numpy as np

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.costs import evaluate, need_matrix
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.core.partition_v import partition_v
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops, pack_bitmask

    t0 = time.perf_counter()
    g = text_like(**MAIN_GRAPH)
    W = (g.num_v + 31) // 32
    log(f"main graph: |U|={g.num_u} |V|={g.num_v} |E|={g.num_edges} W={W} "
        f"(generated in {time.perf_counter() - t0:.2f} s)")
    cfg = ParsaConfig(k=K, backend="device_scan", block_size=BLOCK,
                      refine_backend="device", sweeps=2)
    partition(g, cfg, device=dev)  # warm-up: allocator and library loads
    ops.reset_launch_counts()
    with dispatch_counter() as counts:
        res = partition(g, cfg, device=dev)
    launches = dict(ops.LAUNCHES)
    log(f"main path dispatches: {dict(counts)}")
    log(f"main path kernel launches per phase: {counts.launches}")
    log("main path timings (s): " + json.dumps(res.timings))
    n_blocks = -(-g.num_u // BLOCK)
    rounds = n_blocks * (1 + -(-(BLOCK - 1) // K))
    want = {"parsa_scan": 1, "refine_sweep": 1}
    check(launches == {n: want.get(n, 0) for n in launches},
          f"main path launches {launches}, want one parsa_scan, one "
          "refine_sweep and nothing else")
    per_phase = {n: v for n, v in counts.launches.items() if v}
    check(per_phase == {"partition_scan": {"parsa_scan": 1},
                        "refine_scan": {"refine_sweep": 1}},
          f"launches per phase {counts.launches}")

    sizes = np.bincount(res.parts_u, minlength=K)
    check(int(sizes.max() - sizes.min()) <= 1, f"unbalanced sizes {sizes}")
    need = need_matrix(g, res.parts_u, K)
    check(np.array_equal(res.s_masks, pack_bitmask(need, g.num_v)),
          "s_masks != packed N(U_i) (cold-start invariant)")
    t0 = time.perf_counter()
    want_v = partition_v(g, res.parts_u, K, sweeps=2, need=need)
    check(np.array_equal(res.parts_v, want_v), "parts_v != numpy partition_v")
    mh = evaluate(g, res.parts_u, res.parts_v, K)
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(mh, f), getattr(res.metrics, f)),
              f"metrics.{f} != numpy evaluate")
    log(f"main path oracles (balance, S_i = N(U_i), partition_v, evaluate) "
        f"agree ({time.perf_counter() - t0:.2f} s); metrics "
        f"{res.metrics.as_dict()}")
    # the parsa_cost kernel's path: the host_blocked_oracle backend, one
    # cost tile per block and one down-date per vertex
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    hbo = partition(g, cfg.replace(backend="host_blocked_oracle"), device=dev)
    hbo_launches = dict(ops.LAUNCHES)
    check(np.array_equal(hbo.parts_u, res.parts_u)
          and np.array_equal(hbo.s_masks, res.s_masks),
          "device_scan != host_blocked_oracle at full size")
    check(hbo_launches["parsa_cost"] == n_blocks + g.num_u,
          f"parsa_cost launches {hbo_launches['parsa_cost']} != "
          f"{n_blocks + g.num_u}")
    log(f"host_blocked_oracle on {dev} agrees at full size "
        f"({time.perf_counter() - t0:.2f} s); launches {hbo_launches}; "
        f"timings (s) {json.dumps(hbo.timings)}")
    launches["parsa_cost"] = hbo_launches["parsa_cost"]
    out = {"graph": g, "result": res, "launches": launches,
           "timings": res.timings, "rounds": rounds,
           "placement": main_placement(dev, g, cfg, res, want_v),
           "per_round": per_round_route(dev, g)}
    return out


def main_placement(dev, g, cfg, res, want_v) -> dict:
    """The embedding placement of the main path (``placement=True``) at
    full size: equal to ``placement_from_parts`` on the parts held to the
    numpy oracles (``res.parts_u``, equal to host_blocked_oracle's, and
    numpy partition_v's ``want_v``), its gather traffic against a random
    placement (reported), and the refusal of a compressing sketch."""
    import numpy as np

    from repro_torch.api import partition
    from repro_torch.core.placement import (
        build_placement, gather_traffic, placement_from_parts)

    t0 = time.perf_counter()
    pr = partition(g, cfg.replace(placement=True), device=dev)
    check(np.array_equal(pr.parts_u, res.parts_u)
          and np.array_equal(pr.parts_v, res.parts_v),
          "placement=True changed the partition")
    want = placement_from_parts(res.parts_u, want_v, g.num_v, K)
    for f in ("doc_to_shard", "vocab_to_shard", "vocab_perm",
              "vocab_unperm", "shard_row_counts"):
        check(np.array_equal(getattr(pr.placement, f), getattr(want, f)),
              f"placement.{f} != placement_from_parts on the oracles' parts")
    parsa = gather_traffic(g, pr.placement)
    rand = gather_traffic(g, build_placement(g, K, method="random",
                                             device=dev))
    check(parsa["remote_rows_sum"] < rand["remote_rows_sum"],
          f"placement gathers {parsa} not below random {rand}")
    refused = False
    try:
        partition(g, cfg.replace(placement=True, set_repr="sketch",
                                 sketch_hot_bits=1024,
                                 sketch_bucket_bits=1024), device=dev)
    except ValueError as e:
        refused = "exact parameter identities" in str(e)
    check(refused, "placement with a compressing sketch was not refused")
    log(f"main path placement: equals placement_from_parts on the oracles' "
        f"parts; timings (s) {json.dumps(pr.timings)}; gather traffic "
        f"parsa {parsa} vs random {rand}; a compressing sketch is refused "
        f"({time.perf_counter() - t0:.2f} s)")
    return {"timings": pr.timings, "parsa": parsa, "random": rand}


def hold_to_oracles(g, res, k: int, what: str) -> None:
    """A partition() result of ``g`` against the numpy oracles: balance,
    S_i = N(U_i) packed, partition_v (2 sweeps) and evaluate."""
    import numpy as np

    from repro_torch.core.costs import evaluate, need_matrix
    from repro_torch.core.partition_v import partition_v
    from repro_torch.kernels.parsa_cost import pack_bitmask

    sizes = np.bincount(res.parts_u, minlength=k)
    check(int(sizes.max() - sizes.min()) <= 1,
          f"{what}: unbalanced sizes {sizes}")
    need = need_matrix(g, res.parts_u, k)
    check(np.array_equal(res.s_masks, pack_bitmask(need, g.num_v)),
          f"{what}: s_masks != packed N(U_i)")
    check(np.array_equal(res.parts_v,
                         partition_v(g, res.parts_u, k, sweeps=2, need=need)),
          f"{what}: parts_v != numpy partition_v")
    mh = evaluate(g, res.parts_u, res.parts_v, k)
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(mh, f), getattr(res.metrics, f)),
              f"{what}: metrics.{f} != numpy evaluate")


def per_round_route(dev, g) -> dict:
    """The per-round route of the scan, for tiles past parsa_scan's shared
    memory, chosen by shape: the main graph at B=1,024 through the facade,
    (a) exact at k=64 (a 256 KiB tile: one parsa_select_tile and one
    parsa_select_reduce a round), (b) the exact collapse of the sketch at
    k=56 (a 224 KiB tile, within sketch_select's guard but not
    parsa_scan's: one sketch_select a round); each path's launches counted
    from 0 and held to the numpy oracles."""
    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.partition import _scan_route
    from repro_torch.kernels.parsa_cost import ops

    out = {}
    for name, k, kw, kern in (
            ("exact k=64", 64, {}, ("parsa_select_tile",
                                    "parsa_select_reduce")),
            ("sketch collapse k=56", 56,
             dict(set_repr="sketch", sketch_hot_bits=SKETCH_BITS),
             ("sketch_select",))):
        check(_scan_route(dev, PER_ROUND_BLOCK, k) == "per_round",
              f"per-round {name}: the shape rule picks parsa_scan")
        cfg = ParsaConfig(k=k, backend="device_scan",
                          block_size=PER_ROUND_BLOCK,
                          refine_backend="device", sweeps=2, **kw)
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        res = partition(g, cfg, device=dev)
        launches = dict(ops.LAUNCHES)
        rounds = -(-g.num_u // PER_ROUND_BLOCK) * (
            1 + -(-(PER_ROUND_BLOCK - 1) // k))
        want = dict({n: rounds for n in kern}, refine_sweep=1)
        check(launches == {n: want.get(n, 0) for n in launches},
              f"per-round {name}: launches {launches}, want {want}")
        hold_to_oracles(g, res, k, f"per-round {name}")
        out[name] = {"launches": launches, "rounds": rounds,
                     "timings": res.timings, "s_masks": res.s_masks}
        log(f"per-round route {name}, B={PER_ROUND_BLOCK}: launches "
            f"{launches}; oracles agree; timings (s) "
            f"{json.dumps(res.timings)} ({time.perf_counter() - t0:.2f} s)")
    return out


# ---------------------------------------------------------------- phase 4
def same_result(a, b, what: str) -> None:
    """Every output of two partition() results equal, bit for bit."""
    import numpy as np

    for name in ("parts_u", "s_masks", "parts_v"):
        check(np.array_equal(getattr(a, name), getattr(b, name)),
              f"{what}: {name} differs")
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(a.metrics, f), getattr(b.metrics, f)),
              f"{what}: metrics.{f} differs")


def check_flash_offset(dev) -> dict:
    """flash_attention with a query offset (row i at position q_offset + i)
    against its plain version on the card, within FLASH_TOL: both routes
    (TMA + wgmma for bf16 at D of 64 and 128, FMA for float32 and for bf16
    at D = 32), causal, windowed and non-causal, offsets that are and are
    not multiples of the tiles, rows past the last key.  Then context
    parallel's slices: the rows of a whole prompt's call equal, bit for
    bit, the call on those rows alone at their offset (the query tiles
    line up, so each tile's work is the same), at the mesh (1, 3) shape of
    phase tp on the tensor-core route and at a float32 shape on the FMA
    route, the whole prompt's call itself within FLASH_TOL of the plain
    version (so each slice at its offset is too); and ``q_offset=0``
    gives the call's bits without it."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref, uses_tensor_cores)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"cases": 0, "wgmma_cases": 0, "fma_cases": 0, "max_abs_err": 0.0,
           "slices_bitwise": 0, "max_abs_err_slices": 0.0}

    def rnd(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = []
    for dt in ("bfloat16", "float32"):
        cases += [(dt, 2, 256, 768, 8, 2, 128, True, None, 512),
                  (dt, 1, 200, 700, 4, 2, 128, True, None, 300),
                  (dt, 1, 128, 640, 4, 1, 64, True, 100, 384),
                  (dt, 1, 100, 500, 4, 2, 128, False, None, 400),
                  (dt, 1, 64, 256, 2, 1, 64, True, None, 300),
                  (dt, 2, 130, 400, 4, 2, 64, True, 77, 129)]
    cases.append(("bfloat16", 1, 96, 300, 4, 2, 32, True, None, 150))
    for dt, B, Sq, Skv, H, KV, D, causal, window, off in cases:
        dtype = getattr(torch, dt)
        q, k, v = rnd(dtype, B, Sq, H, D), rnd(dtype, B, Skv, KV, D), \
            rnd(dtype, B, Skv, KV, D)
        got = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=off)
        want = flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=off)
        diff = (got.float() - want.float()).abs()
        tol = FLASH_TOL[dt]
        case = (dt, B, Sq, Skv, H, KV, D, causal, window, off)
        check(bool(torch.isfinite(got.float()).all())
              and bool((diff <= tol + tol * want.float().abs()).all()),
              f"flash q_offset {case}: max abs err {float(diff.max())} past "
              f"tolerance {tol}")
        out["cases"] += 1
        out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
        out["wgmma_cases" if uses_tensor_cores(q, k, v) else "fma_cases"] += 1
    check(out["wgmma_cases"] > 0 and out["fma_cases"] > 0,
          f"flash q_offset: routes not both run: {out}")
    for dt, B, S, H, KV, D, n in (("bfloat16",) + TP_CP["prefill"]
                                  + (40, 8, 128, 3),
                                  ("float32", 1, 512, 4, 2, 64, 4)):
        dtype = getattr(torch, dt)
        q, k, v = rnd(dtype, B, S, H, D), rnd(dtype, B, S, KV, D), \
            rnd(dtype, B, S, KV, D)
        whole = flash_attention(q, k, v)
        check(torch.equal(flash_attention(q, k, v, q_offset=0), whole),
              f"flash {dt} S={S}: q_offset=0 changed the bits")
        want = flash_attention_ref(q, k, v).float()
        diff = (whole.float() - want).abs()
        tol = FLASH_TOL[dt]
        check(bool(torch.isfinite(whole.float()).all())
              and bool((diff <= tol + tol * want.abs()).all()),
              f"flash {dt} S={S}: the whole prompt's call, max abs err "
              f"{float(diff.max())} past tolerance {tol}")
        out["max_abs_err_slices"] = max(out["max_abs_err_slices"],
                                        float(diff.max()))
        del want, diff
        m = S // n
        for r in range(n):
            part = flash_attention(q[:, r * m:(r + 1) * m].contiguous(), k, v,
                                   q_offset=r * m)
            check(torch.equal(part, whole[:, r * m:(r + 1) * m]),
                  f"flash {dt} S={S}: rows {r * m}.. at q_offset {r * m} "
                  f"differ from the whole prompt's")
            out["slices_bitwise"] += 1
        del q, k, v, whole, part
    torch.cuda.empty_cache()
    return out


def phase_parity(dev) -> None:
    import numpy as np

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops

    g = text_like(**SMALL_GRAPH)
    hbo_launches = None
    ref = None
    for backend in ("device_scan", "host_blocked_oracle"):
        cfg = ParsaConfig(k=K, backend=backend, block_size=BLOCK,
                          refine_backend="device", sweeps=2)
        t0 = time.perf_counter()
        rc = partition(g, cfg, device="cpu")
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        rg = partition(g, cfg, device=dev)
        if backend == "host_blocked_oracle":
            hbo_launches = dict(ops.LAUNCHES)
        t2 = time.perf_counter()
        same_result(rc, rg, f"{backend}: cpu vs cuda")
        if ref is not None:
            check(np.array_equal(ref.parts_u, rg.parts_u),
                  "host_blocked_oracle != device_scan on the reduced graph")
        ref = rg
        log(f"reduced graph {backend}: cpu == cuda (cpu {t1 - t0:.2f} s, "
            f"cuda {t2 - t1:.2f} s)")
    check(hbo_launches["parsa_cost"] > 0,
          "host_blocked_oracle never launched parsa_cost")
    t0 = time.perf_counter()
    got = check_flash_offset(dev)
    log(f"flash q_offset: {json.dumps(got)} within {json.dumps(FLASH_TOL)} "
        f"of the plain version; context-parallel slices bit for bit the "
        f"whole prompt's rows ({time.perf_counter() - t0:.2f} s)")


# ---------------------------------------------------------------- phase 5
def phase_sketch(dev, main: dict) -> dict:
    import numpy as np

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.costs import evaluate, need_matrix
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.core.partition_v import partition_v
    from repro_torch.graphs import ctr_like, text_like
    from repro_torch.kernels.parsa_cost import ops, pack_bitmask

    def rounds_of(num_u, block):
        return -(-num_u // block) * (1 + -(-(block - 1) // K))

    # 1. the acceptance geometry: 10^8 features, 4,096 sketched words
    t0 = time.perf_counter()
    g = ctr_like(**SKETCH_GRAPH)
    log(f"sketch graph: |U|={g.num_u} |V|={g.num_v} |E|={g.num_edges} "
        f"(generated in {time.perf_counter() - t0:.2f} s)")
    cfg = ParsaConfig(k=K, backend="device_scan", block_size=SKETCH_BLOCK,
                      refine_backend="device", sweeps=2, set_repr="sketch",
                      sketch_hot_bits=SKETCH_BITS,
                      sketch_bucket_bits=SKETCH_BITS)
    ops.reset_launch_counts()
    with dispatch_counter() as counts:
        res = partition(g, cfg, device=dev)
    launches = dict(ops.LAUNCHES)
    built = ops.ROWS_BUILT["sketch_select"]
    sk = res.sketch
    log(f"sketch path: width {sk.width_bits} bits = {sk.width_words} words "
        f"({sk.compression:.1f}x narrower than {(g.num_v + 31) // 32}); "
        f"dispatches {dict(counts)}; kernel launches per phase "
        f"{counts.launches}; sketch_select calls that built their own row "
        f"lists: {built}")
    log("sketch path timings (s): " + json.dumps(res.timings))
    rounds = rounds_of(g.num_u, SKETCH_BLOCK)
    want = {"parsa_scan": 1, "refine_sweep": 1}
    check(launches == {n: want.get(n, 0) for n in launches},
          f"sketch path launches {launches}, want one parsa_scan, one "
          "refine_sweep and nothing else")
    check(built == 0, f"{built} sketch_select calls built their own row "
          "lists")
    check(dict(counts) == {"partition_scan": 1, "refine_scan": 1,
                           "metrics": 1}, f"dispatches {dict(counts)}")
    t0 = time.perf_counter()
    sizes = np.bincount(res.parts_u, minlength=K)
    check(int(sizes.max() - sizes.min()) <= 1, f"unbalanced sizes {sizes}")
    run_graph = sk.sketch_graph(g)
    need = need_matrix(run_graph, res.parts_u, K)
    check(np.array_equal(res.s_masks, pack_bitmask(need, run_graph.num_v)),
          "sketch s_masks != packed N(U_i) of the sketched graph")
    want_v = partition_v(run_graph, res.parts_u, K, sweeps=2, need=need)
    check(res.parts_v.shape == (g.num_v,),
          f"expanded parts_v has shape {res.parts_v.shape}")
    check(np.array_equal(res.parts_v[sk.hot_ids], want_v[:sk.hot_bits]),
          "parts_v[hot_ids] != sketch-space partition_v of the hot slots")
    check(np.array_equal(res.parts_v, sk.expand_parts_v(want_v)),
          "expanded parts_v != expanded numpy partition_v")
    mh = evaluate(run_graph, res.parts_u, want_v, K)
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(mh, f), getattr(res.metrics, f)),
              f"sketch metrics.{f} != numpy evaluate on the sketched graph")
    log(f"sketch path oracles (balance, S_i = N(U_i), partition_v, expand, "
        f"evaluate) agree ({time.perf_counter() - t0:.2f} s); sketch-space "
        f"metrics {res.metrics.as_dict()}")
    out = {"graph": run_graph, "true_graph": g, "result": res,
           "launches": launches, "rounds": rounds}

    # 2. the exact collapse (hot bits >= |V|) equals the exact main path
    gm = main["graph"] if "graph" in main else text_like(**MAIN_GRAPH)
    base = ParsaConfig(k=K, backend="device_scan", block_size=BLOCK,
                       refine_backend="device", sweeps=2)
    exact = (main["result"] if "result" in main
             else partition(gm, base, device=dev))
    ops.reset_launch_counts()
    col = partition(gm, base.replace(set_repr="sketch",
                                     sketch_hot_bits=SKETCH_BITS),
                    device=dev)
    cl = dict(ops.LAUNCHES)
    check(col.sketch.is_exact, "main graph sketch is not the exact collapse")
    same_result(col, exact, "exact collapse vs exact main path")
    check(cl == {n: want.get(n, 0) for n in cl},
          f"exact collapse launches {cl}, want one parsa_scan")
    log(f"exact collapse on the main graph equals the exact run; launches "
        f"{cl}; timings (s) {json.dumps(col.timings)}")

    # 3. the quality band, scored on the true graph (reported, not gated)
    t0 = time.perf_counter()
    gb = ctr_like(**BAND_GRAPH)
    cb = ParsaConfig(k=K, backend="device_scan", block_size=SKETCH_BLOCK,
                     refine_v=False)
    band = {}
    for name, c in (("exact", cb),
                    ("sketch", cb.replace(set_repr="sketch",
                                          sketch_hot_bits=BAND_BITS,
                                          sketch_bucket_bits=BAND_BITS))):
        r = partition(gb, c, device=dev)
        pv = partition_v(gb, r.parts_u, K, sweeps=2)
        band[name] = int(evaluate(gb, r.parts_u, pv, K).traffic_max)
    pct = (band["sketch"] / band["exact"] - 1.0) * 100.0
    out["band"] = dict(band, delta_pct=pct)
    log(f"quality band: true-graph traffic_max sketch {band['sketch']} vs "
        f"exact {band['exact']} ({pct:+.2f}%; band "
        f"{SKETCH_MAX_QUALITY_PCT}%, "
        f"{'inside' if pct <= SKETCH_MAX_QUALITY_PCT else 'OUTSIDE'}; "
        f"reported, not gated) ({time.perf_counter() - t0:.2f} s)")

    # 4. cpu against cuda on a reduced sketched graph, both backends
    gs = ctr_like(**SKETCH_SMALL_GRAPH)
    for backend in ("device_scan", "host_blocked_oracle"):
        c = ParsaConfig(k=K, backend=backend, block_size=BLOCK,
                        refine_backend="device", sweeps=2, set_repr="sketch",
                        sketch_hot_bits=SKETCH_SMALL_BITS,
                        sketch_bucket_bits=SKETCH_SMALL_BITS)
        t0 = time.perf_counter()
        rc = partition(gs, c, device="cpu")
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        rg = partition(gs, c, device=dev)
        t2 = time.perf_counter()
        same_result(rc, rg, f"sketched {backend}: cpu vs cuda")
        check(rc.parts_v.shape == (gs.num_v,) and set(rc.timings)
              == set(rg.timings), f"sketched {backend}: shapes or timings")
        for f in ("num_v", "hot_bits", "bucket_bits", "seed"):
            check(getattr(rc.sketch, f) == getattr(rg.sketch, f),
                  f"sketched {backend}: sketch.{f} differs")
        check(np.array_equal(rc.sketch.hot_ids, rg.sketch.hot_ids),
              f"sketched {backend}: hot_ids differ")
        kern = "parsa_scan" if backend == "device_scan" else "parsa_cost"
        check(ops.LAUNCHES[kern] > 0, f"sketched {backend} never launched "
              f"{kern}")
        log(f"reduced sketched graph {backend}: cpu == cuda (cpu "
            f"{t1 - t0:.2f} s, cuda {t2 - t1:.2f} s)")
    return out


# ---------------------------------------------------------------- phase 6
def phase_parallel(dev, main: dict) -> dict:
    import numpy as np

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.costs import evaluate, need_matrix
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.core.partition_v import partition_v
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops, pack_bitmask

    g = main["graph"] if "graph" in main else text_like(**MAIN_GRAPH)
    base = ParsaConfig(k=K, backend="device_scan", block_size=BLOCK,
                       refine_backend="device", sweeps=2)
    exact = (main["result"] if "result" in main
             else partition(g, base, device=dev))

    def rounds_of(n_blocks, block):
        return n_blocks * (1 + -(-(block - 1) // K))

    def padded_blocks(block, workers, merge_every):
        nb_per = -(-(-(-g.num_u // block)) // workers)
        return -(-nb_per // merge_every) * merge_every * workers

    # (a) the acceptance configuration of bench_fig10_scalability.py
    cfg = base.replace(backend="parallel_device", **PAR)
    ops.reset_launch_counts()
    with dispatch_counter() as counts:
        res = partition(g, cfg, device=dev)
    launches = dict(ops.LAUNCHES)
    log(f"parallel path: dispatches {dict(counts)}; kernel launches per "
        f"phase {counts.launches}")
    log("parallel path timings (s): " + json.dumps(res.timings))
    log(f"parallel path traffic: {res.traffic}")
    n_tot = padded_blocks(PAR["block_size"], PAR["workers"],
                          PAR["merge_every"])
    n_real = -(-g.num_u // PAR["block_size"])
    rounds = rounds_of(n_tot, PAR["block_size"])
    merges = n_tot // PAR["workers"] // PAR["merge_every"]
    want = {"parsa_scan": merges, "packed_union_delta": merges,
            "refine_sweep": 1}
    want_launches = {n: want.get(n, 0) for n in launches}
    check(launches == want_launches,
          f"parallel launches {launches} != {want_launches}")
    log(f"parallel path: {n_tot} blocks ({n_tot - n_real} of them padding, "
        f"skipped on the card) x {rounds // n_tot} rounds = {rounds} rounds "
        f"at most, in {merges} parsa_scan launches and {merges} merges")
    t0 = time.perf_counter()
    check(bool(((res.parts_u >= 0) & (res.parts_u < K)).all()),
          "parts_u outside [0, k)")
    sizes = np.bincount(res.parts_u, minlength=K)
    check(int(sizes.max() - sizes.min()) <= PAR["workers"],
          f"sizes {sizes} spread more than workers")
    need = need_matrix(g, res.parts_u, K)
    check(np.array_equal(res.s_masks, pack_bitmask(need, g.num_v)),
          "parallel s_masks != packed N(U_i)")
    want_v = partition_v(g, res.parts_u, K, sweeps=2, need=need)
    check(np.array_equal(res.parts_v, want_v),
          "parallel parts_v != numpy partition_v")
    mh = evaluate(g, res.parts_u, res.parts_v, K)
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(mh, f), getattr(res.metrics, f)),
              f"parallel metrics.{f} != numpy evaluate")
    W = (g.num_v + 31) // 32
    tr = res.traffic
    check(tr.pulled_bytes == 4 * PAR["workers"] * merges * K * W
          and tr.tasks == PAR["workers"] * merges
          and tr.stale_pushes_missed
          == merges * PAR["workers"] * (PAR["workers"] - 1)
          and tr.pushed_bytes > 0 and tr.migration_bytes == 0,
          f"parallel traffic {tr}")
    log(f"parallel path oracles (parts in range, sizes {int(sizes.min())}.."
        f"{int(sizes.max())}, S_i = N(U_i), partition_v, evaluate, traffic) "
        f"agree ({time.perf_counter() - t0:.2f} s); metrics "
        f"{res.metrics.as_dict()}")
    out = {"result": res, "launches": launches, "rounds": rounds,
           "merges": merges, "blocks": n_tot, "real_blocks": n_real}

    # (b) one worker collapses to the sequential scan of phase main
    c1 = base.replace(backend="parallel_device", workers=1,
                      merge_every=PAR["merge_every"])
    ops.reset_launch_counts()
    r1 = partition(g, c1, device=dev)
    l1 = dict(ops.LAUNCHES)
    same_result(r1, exact, "parallel_device W=1 vs device_scan")
    n1 = padded_blocks(BLOCK, 1, PAR["merge_every"])
    want1 = {n: 0 for n in l1}
    want1.update(parsa_scan=n1 // PAR["merge_every"],
                 packed_union_delta=n1 // PAR["merge_every"], refine_sweep=1)
    check(l1 == want1, f"W=1 launches {l1} != {want1}")
    check(r1.traffic.stale_pushes_missed == 0, f"W=1 traffic {r1.traffic}")
    out["w1_merges"] = want1["packed_union_delta"]
    log(f"parallel_device W=1 equals device_scan in every output; launches "
        f"{l1}; timings (s) {json.dumps(r1.timings)}")

    # (c) quality against the sequential scan, bench_fig10's 5% gate
    pct = (res.metrics.traffic_max / exact.metrics.traffic_max - 1) * 100
    out["quality_pct"] = pct
    log(f"parallel quality: traffic_max {res.metrics.traffic_max} vs "
        f"device_scan {exact.metrics.traffic_max} ({pct:+.2f}%, gate "
        f"{PAR_MAX_QUALITY_PCT}%)")
    check(pct <= PAR_MAX_QUALITY_PCT,
          f"parallel quality {pct:+.2f}% past {PAR_MAX_QUALITY_PCT}%")

    # (d) the host simulation of Algorithm 4 at full size (not gated)
    t0 = time.perf_counter()
    sim = partition(g, base.replace(backend="parallel_sim", **SIM),
                    device=dev)
    pct_sim = (sim.metrics.traffic_max / exact.metrics.traffic_max - 1) * 100
    out["sim"] = {"timings": sim.timings, "quality_pct": pct_sim}
    log(f"parallel_sim {SIM} on the host: {time.perf_counter() - t0:.2f} s; "
        f"timings (s) {json.dumps(sim.timings)}; traffic {sim.traffic}; "
        f"traffic_max {sim.metrics.traffic_max} ({pct_sim:+.2f}% vs "
        f"device_scan; reported, not gated)")

    # (e) cpu against cuda on the reduced graph
    gs = text_like(**SMALL_GRAPH)
    small = base.replace(backend="parallel_device",
                         block_size=PAR["block_size"])
    for name, c in (("W=4 m=1", small.replace(workers=4, merge_every=1)),
                    ("W=8 m=2", small.replace(workers=8, merge_every=2)),
                    ("W=4 m=2 global init", small.replace(
                        workers=4, merge_every=2, global_init_frac=0.05)),
                    ("W=4 m=1 sketch", small.replace(
                        workers=4, merge_every=1, set_repr="sketch",
                        sketch_hot_bits=SKETCH_SMALL_BITS,
                        sketch_bucket_bits=SKETCH_SMALL_BITS))):
        t0 = time.perf_counter()
        rc = partition(gs, c, device="cpu")
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        rg = partition(gs, c, device=dev)
        t2 = time.perf_counter()
        same_result(rc, rg, f"parallel_device {name}: cpu vs cuda")
        check(rc.traffic == rg.traffic, f"{name}: traffic differs")
        check(ops.LAUNCHES["packed_union_delta"] > 0,
              f"{name}: no packed_union_delta launch on the card")
        log(f"reduced graph parallel_device {name}: cpu == cuda (cpu "
            f"{t1 - t0:.2f} s, cuda {t2 - t1:.2f} s)")
    return out


# ---------------------------------------------------------------- dist
@contextlib.contextmanager
def group_timers():
    """CUDA events around every ``_scan`` (one a super-step) and every
    ``_gather_flat`` of the group route, on the current stream (an NCCL
    gather is ordered on it both ways, a gloo one blocks the host).
    Yields a dict that holds, once the ``with`` block ends, ``scan_ms``
    (a super-step each) and ``merge_gather_ms`` (the sets' and the
    sizes' gathers of a merge together, a merge each: the route gathers
    the plan's digest first, then sets and sizes a merge, the parts
    last)."""
    import torch

    from repro_torch.core import partition as tp

    scans, gathers, out = [], [], {}
    scan, gather = tp._scan, tp._gather_flat

    def timed(fn, into):
        def run(*args):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(*args)
            b.record()
            into.append((a, b))
        return run

    tp._scan, tp._gather_flat = timed(scan, scans), timed(gather, gathers)
    try:
        yield out
    finally:
        tp._scan, tp._gather_flat = scan, gather
    torch.cuda.synchronize()
    out["scan_ms"] = [a.elapsed_time(b) for a, b in scans]
    per = [a.elapsed_time(b) for a, b in gathers][1:-1]
    out["merge_gather_ms"] = [x + y for x, y in zip(per[0::2], per[1::2])]


def spread(xs) -> str:
    """n, median, min, max and sum of a list of milliseconds, short."""
    if not xs:
        return "n=0"
    return (f"n={len(xs)} median {statistics.median(xs) * 1e3:.1f} us, min "
            f"{min(xs) * 1e3:.1f}, max {max(xs) * 1e3:.1f}, sum "
            f"{sum(xs):.2f} ms")


def dist_result_arrays(res) -> dict:
    out = {f: getattr(res, f) for f in ("parts_u", "s_masks", "parts_v")}
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        out["m_" + f] = getattr(res.metrics, f)
    for f in ("pushed_bytes", "pulled_bytes", "tasks", "stale_pushes_missed",
              "migration_bytes"):
        out["t_" + f] = getattr(res.traffic, f)
    return out


def dist_same(got: dict, want: dict, what: str) -> None:
    import numpy as np

    for f, v in want.items():
        check(np.array_equal(got[f], v), f"{what}: {f} differs")


def dist_stream_feed(g, dev, group=None):
    """One parallel StreamSession feed at DIST_WORKERS workers (shuffled
    blocks) of the main graph's first sixteenth; its parts, live sets and
    sizes, traffic and launches."""
    import numpy as np

    from repro_torch.api import ParsaConfig
    from repro_torch.kernels.parsa_cost import ops
    from repro_torch.stream import ParsaStreamConfig, StreamSession

    cfg = ParsaStreamConfig(base=ParsaConfig(
        k=K, backend="parallel_device", workers=DIST_WORKERS, **DIST),
        repartition="never")
    sess = StreamSession(cfg, g.num_v, device=dev, group=group)
    ops.reset_launch_counts()
    upd = sess.feed(stream_chunks(g, STREAM_CHUNKS)[0])
    launches = dict(ops.LAUNCHES)
    return {"parts": upd.parts, "s_masks": sess.arena.masks_np(),
            "sizes": sess.arena.sizes.cpu().numpy(),
            "traffic": np.asarray([upd.traffic.pushed_bytes,
                                   upd.traffic.pulled_bytes,
                                   upd.traffic.tasks,
                                   upd.traffic.stale_pushes_missed])}, launches


def dist_elastic(dev, group=None, workers: int = DIST_WORKERS,
                 shuffle: bool = True) -> dict:
    """Phase dist (d): the CHAOS script (phase elastic's acceptance replay)
    through an ``ElasticSession`` at ``parallel_device`` with ``workers``
    workers, B = CHAOS["block"] and the straggler bias on, over ``group``
    where one is given (one worker a rank), then ``result(refine_v=True)``;
    the final state, every op, the result and a digest of every feed's
    state as arrays, with the launches by dispatch phase and the seconds."""
    import dataclasses

    import numpy as np

    from repro_torch.api import ParsaConfig
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops
    from repro_torch.stream import ParsaStreamConfig

    g = text_like(CHAOS["num_docs"], CHAOS["vocab"], mean_len=20, seed=0)
    chunks = stream_chunks(g, CHAOS["chunks"])
    scfg = ParsaStreamConfig(base=ParsaConfig(
        k=CHAOS["k0"], backend="parallel_device", workers=workers,
        block_size=CHAOS["block"], refine_v=False, seed=0),
        repartition="never", shuffle_blocks=shuffle)
    by_phase: dict = {}
    t0 = time.perf_counter()
    sess, rows = chaos_replay(dev, g, chunks, scfg, group=group,
                              by_phase=by_phase)
    replay_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    res = sess.result(refine_v=True)
    by_phase["result"] = {n: v for n, v in ops.LAUNCHES.items() if v}
    out = {f"result/{f}": v for f, v in dist_result_arrays(res).items()
           if not f.startswith("t_")}
    out.update(parts=sess.parts.copy(),
        sizes=sess.stream.arena.sizes.cpu().numpy().copy(),
        masks=sess.stream.arena.masks_np(logical=False),
        traffic=np.asarray(dataclasses.astuple(sess.traffic)),
        ops=np.asarray(json.dumps([elastic_op_fields(o) for o in sess.ops])),
        feeds=np.asarray(json.dumps([r["digest"] for r in rows])),
        feed_traffic=np.asarray([r["traffic"] for r in rows]),
        k=np.int64(sess.k),
        by_phase=np.asarray(json.dumps(by_phase)),
        replay_s=np.float64(replay_s),
        feed_s=np.asarray([r["feed_s"] for r in rows]),
        traffic_max=np.int64(res.metrics.traffic_max))
    return out


def dist_rank(rank: int, world: int, backend: str, store: str, out_dir: str,
              device: str) -> None:
    """One rank of phase dist (started with spawn): a warm-up partition of
    the reduced graph over the group, then the main graph's
    ``parallel_device`` at ``world`` workers with its launches, scan and
    gather times, then one parallel stream feed; everything it returns
    goes to ``rank<r>.npz`` in ``out_dir``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    group = dist.group.WORLD
    cfg = ParsaConfig(k=K, backend="parallel_device", refine_backend="device",
                      sweeps=2, workers=world, **DIST)
    partition(text_like(**SMALL_GRAPH), cfg, device=dev, group=group)
    g = text_like(**MAIN_GRAPH)
    ops.reset_launch_counts()
    with dispatch_counter() as counts, group_timers() as times:
        res = partition(g, cfg, device=dev, group=group)
    launches = dict(ops.LAUNCHES)
    out = {"r/" + k: v for k, v in dist_result_arrays(res).items()}
    feed, feed_launches = dist_stream_feed(g, dev, group)
    out.update({"feed/" + k: v for k, v in feed.items()})
    out.update({"el/" + k: v for k, v in dist_elastic(dev, group).items()})
    dist.barrier()
    dist.destroy_process_group()
    out["launches"] = np.asarray(json.dumps(launches))
    out["feed_launches"] = np.asarray(json.dumps(feed_launches))
    out["gather_bytes"] = np.int64(
        counts.bytes_by_phase()["parallel_merge_gather"])
    out["partition_u_s"] = np.float64(res.timings["partition_u"])
    out["scan_ms"] = np.asarray(times["scan_ms"])
    out["merge_gather_ms"] = np.asarray(times["merge_gather_ms"])
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def run_ranks(target, world: int, backend: str, out_dir: pathlib.Path,
              device_of, deadline_s: float, what: str, *extra) -> list[dict]:
    """Start ``world`` processes of ``target(rank, world, backend, store,
    out_dir, device_of(rank), *extra)`` with spawn (CUDA is live in this
    process) over a ``file://`` store in ``out_dir``, join them by
    ``deadline_s``, kill any still running, and fail unless every rank
    exited 0; returns each rank's ``rank<r>.npz`` arrays."""
    import multiprocessing

    import numpy as np

    ctx = multiprocessing.get_context("spawn")
    out_dir.mkdir()
    store = f"file://{out_dir / 'store'}"
    procs = [ctx.Process(target=target, args=(
        r, world, backend, store, str(out_dir), device_of(r), *extra))
        for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(not hung, f"{what} {backend} x{world}: ranks {hung} still ran "
          f"after {deadline_s} s (killed)")
    codes = [p.exitcode for p in procs]
    check(not any(codes), f"{what} {backend} x{world}: rank exit codes "
          f"{codes}")
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def hold_dist_ranks(ranks: list[dict], want: dict, want_feed: dict,
                    want_launches: dict, want_feed_launches: dict,
                    what: str) -> None:
    """Every rank's result and stream feed against the in-process route's,
    and its launches against the super-step count; logs each rank's
    times on short lines."""
    for r, got in enumerate(ranks):
        dist_same({k[2:]: v for k, v in got.items() if k.startswith("r/")},
                  want, f"{what} rank {r} vs in process")
        dist_same({k[5:]: v for k, v in got.items()
                   if k.startswith("feed/")}, want_feed,
                  f"{what} rank {r} stream feed vs in process")
        launches = json.loads(str(got["launches"]))
        check(launches == {n: want_launches.get(n, 0) for n in launches},
              f"{what} rank {r}: launches {launches}, want {want_launches}")
        fl = json.loads(str(got["feed_launches"]))
        check(fl == {n: want_feed_launches.get(n, 0) for n in fl},
              f"{what} rank {r}: feed launches {fl}, want "
              f"{want_feed_launches}")
        log(f"{what} rank {r}: partition_u {float(got['partition_u_s']):.3f}"
            f" s; gathered {int(got['gather_bytes']):,} bytes")
        log(f"{what} rank {r}: scan a super-step "
            f"{spread(list(got['scan_ms']))}")
        log(f"{what} rank {r}: gather a merge "
            f"{spread(list(got['merge_gather_ms']))}")


def chaos_oracle_tmax(dev) -> int:
    """traffic_max of a one-shot device_scan partition of the chaos graph
    at the chaos replay's final k (phase elastic's quality oracle)."""
    from repro_torch.api import ParsaConfig, partition
    from repro_torch.graphs import text_like

    adds = sum(e[1] == "add" for e in CHAOS_EVENTS)
    g = text_like(CHAOS["num_docs"], CHAOS["vocab"], mean_len=20, seed=0)
    res = partition(g, ParsaConfig(
        k=CHAOS["k0"] + adds, backend="device_scan",
        block_size=CHAOS["block"], refine_v=True, refine_backend="device",
        seed=0), device=dev)
    return int(res.metrics.traffic_max)


def hold_dist_elastic(ranks: list[dict], want: dict, oracle_tmax: int,
                      what: str) -> dict:
    """Phase dist (d): every rank's chaos replay against the in-process
    session's, bit for bit (each feed's state, the final state and
    traffic, every op, ``result()``, the launches by dispatch phase); the
    op count of the one-card run; the quality gate against the one-shot
    oracle.  Logs each rank's replay and feed seconds on short lines."""
    skip = ("replay_s", "feed_s")
    adds = sum(e[1] == "add" for e in CHAOS_EVENTS)
    kills = sum(e[1] == "kill" for e in CHAOS_EVENTS)
    for r, got in enumerate(ranks):
        el = {k[3:]: v for k, v in got.items() if k.startswith("el/")}
        dist_same({k: v for k, v in el.items() if k not in skip},
                  {k: v for k, v in want.items() if k not in skip},
                  f"{what} rank {r} elastic vs in process")
        fs = [float(x) for x in el["feed_s"]]
        log(f"{what} rank {r}: chaos replay {float(el['replay_s']):.2f} s, "
            f"a feed median {statistics.median(fs):.3f} s, max "
            f"{max(fs):.3f} s")
    n_ops = len(json.loads(str(want["ops"])))
    check(n_ops == adds + kills and int(want["k"]) == CHAOS["k0"] + adds,
          f"{what}: {n_ops} ops, k {int(want['k'])}")
    pct = (int(want["traffic_max"]) / oracle_tmax - 1) * 100
    check(pct <= CHAOS_MAX_QUALITY_PCT,
          f"{what}: quality {pct:+.2f}% past {CHAOS_MAX_QUALITY_PCT}%")
    by_phase = json.loads(str(want["by_phase"]))
    log(f"{what}: every rank equals the in-process session at "
        f"{DIST_WORKERS} workers (k {CHAOS['k0']} -> {int(want['k'])}, "
        f"{n_ops} ops, each feed's state, result()); traffic_max "
        f"{int(want['traffic_max'])} vs one-shot {oracle_tmax} ({pct:+.2f}%,"
        f" gate {CHAOS_MAX_QUALITY_PCT}%); a rank's launches by phase "
        f"{json.dumps(by_phase)}")
    return {"by_phase": by_phase, "quality_pct": pct,
            "replay_s": [float(x["el/replay_s"]) for x in ranks],
            "in_process_replay_s": float(want["replay_s"])}


def phase_dist(dev, main: dict) -> dict:
    """Algorithm 4 with one worker a rank of a torch.distributed group:
    (a) a real NCCL group of one rank in this process, against the
    ungrouped route and device_scan; (b) DIST_WORKERS ranks on this one
    card over gloo (NCCL refuses two ranks on one card), against the
    in-process route at as many workers; (c) DIST_WORKERS NCCL ranks, one
    card each, where that many cards are visible."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.api import ParsaConfig, partition
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops

    check(dist.is_available() and dist.is_nccl_available(),
          "torch.distributed with NCCL is not available")
    g = main["graph"] if "graph" in main else text_like(**MAIN_GRAPH)
    base = ParsaConfig(k=K, backend="parallel_device", refine_backend="device",
                       sweeps=2, **DIST)
    nb = -(-g.num_u // DIST["block_size"])

    def merges_at(workers):
        nb_per = -(-nb // workers)
        return -(-nb_per // DIST["merge_every"])

    out = {}
    tmp = tempfile.TemporaryDirectory()
    # (a) NCCL at world size 1, in this process
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp.name}/store_nccl1", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S),
        device_id=dev)
    try:
        one = base.replace(workers=1)
        group = dist.group.WORLD
        partition(text_like(**SMALL_GRAPH), one, device=dev, group=group)
        ops.reset_launch_counts()
        with dispatch_counter() as counts, group_timers() as times:
            r1 = partition(g, one, device=dev, group=group)
        l1 = dict(ops.LAUNCHES)
        # (d) the chaos script at one worker over the NCCL group
        el1 = dist_elastic(dev, group, workers=1, shuffle=False)
    finally:
        dist.destroy_process_group()
    m1 = merges_at(1)
    want1 = {"parsa_scan": m1, "packed_union_delta": m1, "refine_sweep": 1}
    check(l1 == {n: want1.get(n, 0) for n in l1},
          f"dist nccl x1 launches {l1} != {want1}")
    check(counts.get("parallel_merge_gather") == 1,
          f"dist nccl x1: dispatches {dict(counts)}")
    ungrouped = partition(g, one, device=dev)
    scan = partition(g, base.replace(backend="device_scan"), device=dev)
    same_result(r1, ungrouped, "dist nccl x1 vs ungrouped parallel_device")
    check(r1.traffic == ungrouped.traffic,
          f"dist nccl x1 traffic {r1.traffic} != {ungrouped.traffic}")
    same_result(r1, scan, "dist nccl x1 vs device_scan B=128")
    out["nccl1"] = {"launches": l1, "merges": m1,
                    "partition_u_s": r1.timings["partition_u"],
                    "ungrouped_partition_u_s":
                        ungrouped.timings["partition_u"],
                    "scan_ms": times["scan_ms"],
                    "merge_gather_ms": times["merge_gather_ms"],
                    "gather_bytes":
                        counts.bytes_by_phase()["parallel_merge_gather"]}
    log(f"dist nccl x1: equal to the ungrouped route and to device_scan "
        f"B=128 in every output; launches {l1}; partition_u "
        f"{r1.timings['partition_u']:.3f} s (ungrouped "
        f"{ungrouped.timings['partition_u']:.3f} s)")
    log(f"dist nccl x1: scan a super-step {spread(times['scan_ms'])}")
    log(f"dist nccl x1: gather a merge {spread(times['merge_gather_ms'])}")

    # (d) against the ungrouped one-worker session (no block shuffle: the
    # group route draws a block permutation even at one worker, the
    # one-worker feed does not); the steady-state traffic differs (the
    # group route meters Algorithm 4's merges), and so do the launches
    # (a merge a super-step)
    el1_ref = dist_elastic(dev, None, workers=1, shuffle=False)
    skip = ("traffic", "feed_traffic", "by_phase", "replay_s", "feed_s")
    dist_same({k: v for k, v in el1.items() if k not in skip},
              {k: v for k, v in el1_ref.items() if k not in skip},
              "dist (d) nccl x1 elastic vs the ungrouped session")
    out["elastic_nccl1"] = {"replay_s": float(el1["replay_s"]),
                            "ungrouped_replay_s": float(el1_ref["replay_s"]),
                            "by_phase": json.loads(str(el1["by_phase"]))}
    log(f"dist (d) nccl x1: the chaos replay at one worker (k "
        f"{CHAOS['k0']} -> {int(el1['k'])}, {len(json.loads(str(el1['ops'])))}"
        f" ops) equals the ungrouped session: every feed's state, the ops "
        f"and result(); replay {float(el1['replay_s']):.2f} s (ungrouped "
        f"{float(el1_ref['replay_s']):.2f} s)")

    # the in-process route at DIST_WORKERS workers: what the ranks must equal
    cw = base.replace(workers=DIST_WORKERS)
    ref = partition(g, cw, device=dev)
    want = dist_result_arrays(ref)
    want_feed, want_feed_launches = dist_stream_feed(g, dev)
    want_el = dist_elastic(dev)
    oracle_tmax = chaos_oracle_tmax(dev)
    mw = merges_at(DIST_WORKERS)
    want_w = {"parsa_scan": mw, "packed_union_delta": mw, "refine_sweep": 1}
    out["in_process_partition_u_s"] = ref.timings["partition_u"]
    log(f"dist: in-process parallel_device x{DIST_WORKERS}: partition_u "
        f"{ref.timings['partition_u']:.3f} s, {mw} merges; its stream feed "
        f"launches {want_feed_launches}")

    # (b) DIST_WORKERS ranks on this card, over gloo
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, DIST_WORKERS, "gloo",
                      pathlib.Path(tmp.name) / f"gloo{DIST_WORKERS}",
                      lambda r: str(dev), DIST_DEADLINE_S, "dist")
    hold_dist_ranks(ranks, want, want_feed, want_w, want_feed_launches,
                    f"dist gloo x{DIST_WORKERS}")
    out["elastic_gloo"] = hold_dist_elastic(ranks, want_el, oracle_tmax,
                                            f"dist (d) gloo x{DIST_WORKERS}")
    out[f"gloo{DIST_WORKERS}"] = {
        "launches": json.loads(str(ranks[0]["launches"])), "merges": mw,
        "partition_u_s": [float(x["partition_u_s"]) for x in ranks],
        "scan_ms": [list(map(float, x["scan_ms"])) for x in ranks],
        "merge_gather_ms": [list(map(float, x["merge_gather_ms"]))
                            for x in ranks],
        "seconds": time.perf_counter() - t0}
    log(f"dist gloo x{DIST_WORKERS} on one card: every rank equals the "
        f"in-process route and its stream feed, {mw} parsa_scan and {mw} "
        f"packed_union_delta launches a rank "
        f"({time.perf_counter() - t0:.2f} s with the ranks' start)")

    # (c) DIST_WORKERS NCCL ranks, one card each
    n_cards = torch.cuda.device_count()
    if n_cards >= DIST_WORKERS:
        t0 = time.perf_counter()
        ranks = run_ranks(dist_rank, DIST_WORKERS, "nccl",
                          pathlib.Path(tmp.name) / f"nccl{DIST_WORKERS}",
                          lambda r: f"cuda:{r}", DIST_DEADLINE_S, "dist")
        hold_dist_ranks(ranks, want, want_feed, want_w, want_feed_launches,
                        f"dist nccl x{DIST_WORKERS}")
        hold_dist_elastic(ranks, want_el, oracle_tmax,
                          f"dist (d) nccl x{DIST_WORKERS}")
        out[f"nccl{DIST_WORKERS}"] = {
            "partition_u_s": [float(x["partition_u_s"]) for x in ranks],
            "seconds": time.perf_counter() - t0}
    else:
        log(f"dist nccl x{DIST_WORKERS}: not run ({n_cards} card(s) "
            f"visible)")
    tmp.cleanup()
    return out


# ---------------------------------------------------------------- stream
def stream_chunks(g, n: int) -> list:
    """``g`` in ``n`` row ranges at ``np.linspace`` bounds, as
    bench_stream.py cuts it."""
    import numpy as np

    bounds = np.linspace(0, g.num_u, n + 1).astype(int)
    return [g.slice_u(int(bounds[i]), int(bounds[i + 1])) for i in range(n)]


def counted(fn, want: dict, what: str, tally: dict | None = None):
    """Call ``fn`` with every kernel's launch count from 0; its launches
    must be ``want`` (every other kernel none).  The counts read are added
    into ``tally`` (kernel name -> launches), where one is given."""
    from repro_torch.kernels.parsa_cost import ops

    ops.reset_launch_counts()
    out = fn()
    launches = dict(ops.LAUNCHES)
    check(launches == {n: want.get(n, 0) for n in launches},
          f"{what}: launches {launches}, want {want}")
    if tally is not None:
        add_launches(tally, launches)
    return out


@contextlib.contextmanager
def plain_route():
    """Every parsa_cost wrapper runs its plain PyTorch version, here on the
    card's own tensors: the reference for a scan at full size, which the
    plain version on the CPU takes minutes over (4.6 s a block of 256)."""
    from repro_torch.kernels.parsa_cost import ops

    on_cuda = ops._on_cuda
    ops._on_cuda = lambda device: False
    try:
        yield
    finally:
        ops._on_cuda = on_cuda


def add_launches(tally: dict, launches: dict) -> None:
    for n, v in launches.items():
        if v:
            tally[n] = tally.get(n, 0) + v


def hold_stream(sess, g, k: int, what: str, balance: int = 1):
    """A stream's live sets against the numpy oracles of the graph fed so
    far: balance, S_i = N(U_i) packed.  Returns the need matrix."""
    import numpy as np

    from repro_torch.core.costs import need_matrix
    from repro_torch.kernels.parsa_cost import pack_bitmask

    sizes = np.bincount(sess.parts, minlength=k)
    check(int(sizes.max() - sizes.min()) <= balance,
          f"{what}: sizes {sizes} spread more than {balance}")
    check(np.array_equal(sess.arena.sizes.cpu().numpy(), sizes),
          f"{what}: live sizes != bincount of parts")
    need = need_matrix(g, sess.parts, k)
    check(np.array_equal(sess.arena.masks_np(), pack_bitmask(need, g.num_v)),
          f"{what}: live sets != packed N(U_i)")
    return need


def hold_stream_result(sess, g, k: int, need, what: str, tally: dict):
    """``result(refine_v=True)``: one refine_sweep launch (added into
    ``tally``), parts_v and metrics equal to numpy partition_v (2 sweeps)
    and evaluate."""
    import numpy as np

    from repro_torch.core.costs import evaluate
    from repro_torch.core.partition_v import partition_v

    res = counted(lambda: sess.result(refine_v=True), {"refine_sweep": 1},
                  f"{what} result", tally)
    want_v = partition_v(g, sess.parts, k, sweeps=2, need=need)
    check(np.array_equal(res.parts_v, want_v),
          f"{what}: parts_v != numpy partition_v")
    mh = evaluate(g, sess.parts, want_v, k)
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(mh, f), getattr(res.metrics, f)),
              f"{what}: metrics.{f} != numpy evaluate")
    return res


def same_stream(a, b, what: str) -> None:
    """Two sessions fed the same chunks: every piece of live state equal."""
    import dataclasses

    import numpy as np

    check(np.array_equal(a.parts, b.parts), f"{what}: parts differ")
    check(np.array_equal(a.arena.masks_np(logical=False),
                         b.arena.masks_np(logical=False)),
          f"{what}: live sets differ")
    check(np.array_equal(a.arena.sizes.cpu().numpy(),
                         b.arena.sizes.cpu().numpy()),
          f"{what}: sizes differ")
    check(dataclasses.astuple(a.traffic) == dataclasses.astuple(b.traffic),
          f"{what}: traffic {a.traffic} != {b.traffic}")


def same_update(a, b, what: str) -> None:
    import dataclasses

    import numpy as np

    check(np.array_equal(a.parts, b.parts), f"{what}: parts differ")
    for f in ("sizes", "footprint", "traffic", "worker_recv", "server_send"):
        check(np.array_equal(getattr(a.metrics, f), getattr(b.metrics, f)),
              f"{what}: metrics.{f} differs")
    check(a.dispatches == b.dispatches and a.repartitioned
          == b.repartitioned and a.traffic == b.traffic,
          f"{what}: dispatches, repair or traffic differ")
    if a.migration is not None:
        for f in dataclasses.fields(a.migration):
            x, y = getattr(a.migration, f.name), getattr(b.migration, f.name)
            check(np.array_equal(x, y) if isinstance(x, np.ndarray)
                  else x == y, f"{what}: migration.{f.name} differs")


def phase_stream(dev, main: dict) -> dict:
    """The online stream on the card (``repro_torch.stream``): the one-chunk
    feed against device_scan, the acceptance stream of bench_stream.py
    with its launches a feed, its oracles, its quality gate and its feed
    seconds against from-scratch partitions, parallel feeds, drift repair,
    a snapshot resumed on the card, the sketched stream, and cpu against
    cuda on reduced streams with their traces.  Scans that start from
    live sets are held to the plain route on the same card: an acceptance
    feed and a parallel feed resumed from snapshots, and the explicit
    repartition.

    Returns, under ``launches``, each stream's kernel launches as counted
    from 0 around each of its feeds, results and repairs (the warm-up
    session and the profiled feed are not counted)."""
    import statistics as st
    import tempfile

    import numpy as np
    import torch

    from repro_torch.api import (
        Observability, ParsaConfig, ParsaStreamConfig, StreamSession,
        chrome_trace_json, partition)
    from repro_torch.core.bipartite import BipartiteGraph
    from repro_torch.core.costs import need_matrix
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.core.parallel import global_initialization
    from repro_torch.core.partition import (
        blocked_partition_u_impl, pack_graph_blocks)
    from repro_torch.graphs import (
        ctr_like, ctr_like_stream, social_like_stream, text_like,
        text_like_stream)
    from repro_torch.kernels.parsa_cost import (
        coerce_packed_sets, ops, pack_bitmask)
    from repro_torch.stream import plan_migration

    g = main["graph"] if "graph" in main else text_like(**MAIN_GRAPH)
    base = ParsaConfig(k=K, backend="device_scan", block_size=BLOCK,
                       refine_backend="device", sweeps=2)
    exact = (main["result"] if "result" in main
             else partition(g, base, device=dev))
    scfg = ParsaStreamConfig(base=base, repartition="never")
    scan1 = {"parsa_scan": 1}
    feed_dispatches = {"stream_feed_scan": 1, "stream_metrics": 1}
    launches = {s: {} for s in ("one_chunk", "acceptance", "parallel",
                                "drift", "snapshot", "sketched",
                                "sketched_tb_pad")}
    out = {"launches": launches}
    tmp = tempfile.TemporaryDirectory()

    # 1. the whole graph as one chunk is device_scan
    t0 = time.perf_counter()
    one = StreamSession(scfg, num_v=g.num_v, device=dev)
    counted(lambda: one.feed(g), scan1, "one-chunk feed",
            launches["one_chunk"])
    check(np.array_equal(one.parts, exact.parts_u)
          and np.array_equal(one.arena.masks_np(), exact.s_masks),
          "one-chunk feed != device_scan (parts or sets)")
    r1 = counted(lambda: one.result(refine_v=True), {"refine_sweep": 1},
                 "one-chunk result", launches["one_chunk"])
    same_result(r1, exact, "one-chunk stream result vs device_scan")
    log(f"stream: one-chunk feed equals device_scan in parts, sets, parts_v "
        f"and metrics ({time.perf_counter() - t0:.2f} s)")

    # 2. the acceptance stream: 16 chunks, one parsa_scan a feed
    chunks = stream_chunks(g, STREAM_CHUNKS)
    warm = StreamSession(scfg, num_v=g.num_v, device=dev)
    for c in chunks:
        warm.feed(c)
    sess = StreamSession(scfg, num_v=g.num_v, device=dev)
    feeds = []
    for i, c in enumerate(chunks):
        with dispatch_counter() as counts:
            upd = counted(lambda: sess.feed(c), scan1, f"stream feed {i}",
                          launches["acceptance"])
        check(upd.dispatches == feed_dispatches,
              f"stream feed {i}: dispatches {upd.dispatches}")
        check({n: v for n, v in counts.launches.items() if v}
              == {"stream_feed_scan": scan1},
              f"stream feed {i}: launches per phase {counts.launches}")
        feeds.append(upd)
    t0 = time.perf_counter()
    need = hold_stream(sess, g, K, "acceptance stream")
    res = hold_stream_result(sess, g, K, need, "acceptance stream",
                             launches["acceptance"])
    pct = (res.metrics.traffic_max / exact.metrics.traffic_max - 1) * 100
    log(f"stream: 16 feeds, one parsa_scan and dispatches "
        f"{feed_dispatches} each; live sets = N(U_i), balance <= 1, result "
        f"(one refine_sweep) = numpy partition_v and evaluate "
        f"({time.perf_counter() - t0:.2f} s); traffic_max "
        f"{res.metrics.traffic_max} vs one-shot {exact.metrics.traffic_max} "
        f"({pct:+.2f}%, gate {STREAM_MAX_QUALITY_PCT}%)")
    check(pct <= STREAM_MAX_QUALITY_PCT,
          f"stream quality {pct:+.2f}% past {STREAM_MAX_QUALITY_PCT}%")
    phases = {p: [u.timings[p] for u in feeds]
              for p in ("pack", "partition_u", "metrics", "total")}
    log("stream feed timings (s) by phase: " + json.dumps(phases))
    # from-scratch partitions of every prefix, scope-equal (pack + scan)
    scratch = []
    bounds = np.linspace(0, g.num_u, STREAM_CHUNKS + 1).astype(int)
    for i in range(STREAM_CHUNKS):
        r = partition(g.slice_u(0, int(bounds[i + 1])),
                      base.replace(refine_v=False), device=dev)
        scratch.append(r.timings["pack"] + r.timings["partition_u"])
    feed_s = [u.timings["pack"] + u.timings["partition_u"] for u in feeds]
    mean_feed, mean_scratch = st.mean(feed_s), st.mean(scratch)
    log(f"stream: mean feed {mean_feed:.4f} s (pack + scan) vs mean "
        f"from-scratch partition of each prefix {mean_scratch:.4f} s "
        f"({mean_scratch / mean_feed:.1f}x); from-scratch (s) "
        f"{json.dumps(scratch)}")
    it = iter(chunks)
    prof_sess = StreamSession(scfg, num_v=g.num_v, device=dev)
    prof = profile_window(lambda: prof_sess.feed(next(it)))
    log("profile one stream feed (the third chunk): " + json.dumps(prof))
    out.update(quality_pct=pct, feed_timings=phases, mean_feed_s=mean_feed,
               mean_scratch_s=mean_scratch, profile=prof)

    # 3. parallel feeds: 8 workers, one parsa_scan and one merge a
    # super-step
    pcfg = ParsaStreamConfig(base=base.replace(backend="parallel_device",
                                               **PAR), repartition="never")
    psess = StreamSession(pcfg, num_v=g.num_v, device=dev)
    merges, pfeeds = 0, []
    for i, c in enumerate(chunks):
        nb_per = -(-(-(-c.num_u // PAR["block_size"])) // PAR["workers"])
        n_super = -(-nb_per // PAR["merge_every"])
        upd = counted(lambda: psess.feed(c),
                      {"parsa_scan": n_super, "packed_union_delta": n_super},
                      f"parallel stream feed {i}", launches["parallel"])
        check(upd.dispatches == feed_dispatches,
              f"parallel stream feed {i}: dispatches {upd.dispatches}")
        merges += n_super
        pfeeds.append(upd)
        if i == 7:          # the plain route resumes the stream at feed 8
            path = pathlib.Path(tmp.name) / "parallel.npz"
            psess.save(path)
            pplain = StreamSession.load(path, pcfg, device=dev)
        if i == 8:
            t0 = time.perf_counter()
            with plain_route():
                pu = counted(lambda: pplain.feed(c), {},
                             "parallel feed 8, plain route")
            same_update(pu, upd, "parallel feed 8: plain route vs kernels")
            same_stream(pplain, psess, "parallel feed 8: plain vs kernels")
            log(f"stream: parallel feed 8, resumed from feed 7's snapshot on "
                f"the plain route, equals the kernels' "
                f"({time.perf_counter() - t0:.2f} s)")
    pneed = hold_stream(psess, g, K, "parallel stream",
                        balance=PAR["workers"])
    pres = hold_stream_result(psess, g, K, pneed, "parallel stream",
                              launches["parallel"])
    ppct = (pres.metrics.traffic_max / res.metrics.traffic_max - 1) * 100
    log(f"stream: parallel feeds ({PAR}) make one parsa_scan and one "
        f"packed_union_delta a super-step ({merges} of each over 16 feeds); "
        f"traffic {psess.traffic}; traffic_max {pres.metrics.traffic_max} "
        f"vs the sequential stream's {res.metrics.traffic_max} "
        f"({ppct:+.2f}%, reported); feed timings (s) "
        f"{json.dumps({p: [u.timings[p] for u in pfeeds] for p in phases})}")
    out.update(parallel_quality_pct=ppct, parallel_traffic=str(psess.traffic))

    # 4. drift repair at the defaults, then one explicit repartition
    t0 = time.perf_counter()
    dchunks = text_like_stream(**DRIFT_STREAM)
    dcfg = ParsaStreamConfig(base=base, repartition="drift",
                             repartition_frac=0.02)
    dsess = StreamSession(dcfg, num_v=dchunks[0].num_v, device=dev)
    repairs = []
    for i, c in enumerate(dchunks):
        ops.reset_launch_counts()
        upd = dsess.feed(c)
        n_scan = 1 + upd.repartitioned
        check(ops.LAUNCHES["parsa_scan"] == n_scan
              and sum(ops.LAUNCHES.values()) == n_scan,
              f"drift feed {i}: launches {dict(ops.LAUNCHES)}")
        add_launches(launches["drift"], ops.LAUNCHES)
        if upd.repartitioned:
            m = upd.migration
            repairs.append({"feed": i, "drift": upd.drift.drift,
                            "baseline": upd.drift.baseline,
                            "migration_bytes": m.traffic.migration_bytes,
                            "moved_u": m.moved_u,
                            "repartition_s": upd.timings["repartition"]})
    log(f"stream: drift stream {DRIFT_STREAM}, repairs {json.dumps(repairs)}"
        f"; session traffic {dsess.traffic} "
        f"({time.perf_counter() - t0:.2f} s)")
    gd = dsess.arena.graph()
    old_parts = dsess.parts.copy()
    old_masks = dsess.arena.masks_np(logical=False)
    dense = global_initialization(gd, K, sample_frac=0.02, theta=base.theta,
                                  select=base.select, seed=base.seed)
    packed0 = coerce_packed_sets(dense, gd.num_v)
    init = np.pad(packed0, [(0, 0),
                            (0, dsess.arena.W_cap - packed0.shape[1])])
    g_cap = BipartiteGraph(gd.num_u, dsess.arena.capacity_v, gd.u_indptr,
                           gd.u_indices)
    # the scan on the plain route, then plan_migration; the result is also
    # held to the numpy oracles: balance, and live sets that hold N(U_i)
    # (and the warm start's sample sets)
    t0 = time.perf_counter()
    with plain_route():
        np_parts, np_masks = counted(
            lambda: blocked_partition_u_impl(
                g_cap, K, block=BLOCK, init_sets=init, seed=base.seed,
                cap=base.cap, device=dev), {}, "repartition, plain route")
    plain_s = time.perf_counter() - t0
    want_plan = plan_migration(np_parts.cpu().numpy(),
                               np_masks.cpu().numpy(), old_parts, old_masks,
                               degrees=gd.degree_u())
    plan = counted(dsess.repartition, scan1, "explicit repartition",
                   launches["drift"])
    check(np.array_equal(plan.parts_u, want_plan.parts_u)
          and np.array_equal(dsess.parts, want_plan.parts_u)
          and np.array_equal(dsess.arena.masks_np(logical=False),
                             want_plan.s_masks),
          "repartition() != plan_migration of blocked_partition_u_impl")
    check(np.array_equal(dsess.arena.sizes.cpu().numpy(),
                         np.bincount(want_plan.parts_u, minlength=K)),
          "repartition() sizes != bincount of its parts")
    rsizes = np.bincount(dsess.parts, minlength=K)
    need_w = pack_bitmask(need_matrix(gd, dsess.parts, K), gd.num_v)
    check(int(rsizes.max() - rsizes.min()) <= 1
          and not (need_w & ~dsess.arena.masks_np()).any(),
          f"repartition(): sizes {rsizes} spread more than 1, or live sets "
          f"miss N(U_i)")
    log(f"stream: explicit repartition() equals plan_migration of "
        f"blocked_partition_u_impl on the plain route ({plain_s:.2f} s), "
        f"balance <= 1, live sets hold N(U_i); "
        f"moved_u {plan.moved_u}, migration "
        f"bytes {plan.traffic.migration_bytes} (acquired "
        f"{plan.acquired_bytes}, retired {plan.retired_bytes})")
    out["drift"] = {"repairs": repairs,
                    "explicit_migration_bytes": plan.traffic.migration_bytes}

    # 5. a snapshot after 8 feeds, resumed on the card; feed 8 also
    # resumed on the plain route, the plain scan from the live sets
    path = pathlib.Path(tmp.name) / "stream.npz"
    s8 = StreamSession(scfg, num_v=g.num_v, device=dev)
    for i, c in enumerate(chunks[:8]):
        counted(lambda: s8.feed(c), scan1, f"snapshot feed {i}",
                launches["snapshot"])
    s8.save(path)
    resumed = StreamSession.load(path, scfg, device=dev)
    plain8 = StreamSession.load(path, scfg, device=dev)
    for i, c in enumerate(chunks[8:]):
        upd = counted(lambda: resumed.feed(c), scan1, f"resumed feed {8 + i}",
                      launches["snapshot"])
        if i == 0:
            t0 = time.perf_counter()
            with plain_route():
                pu = counted(lambda: plain8.feed(c), {},
                             "acceptance feed 8, plain route")
            same_update(pu, upd, "acceptance feed 8: plain route vs kernels")
            same_stream(plain8, resumed, "acceptance feed 8: plain vs kernels")
            plain_s = time.perf_counter() - t0
    same_stream(resumed, sess, "snapshot resumed vs uninterrupted stream")
    log(f"stream: a snapshot after 8 feeds, loaded on the card, feeds the "
        f"other 8 to the uninterrupted session's parts, sets, sizes and "
        f"traffic; feed 8 on the plain route equals the kernels' "
        f"({plain_s:.2f} s)")
    tmp.cleanup()

    # 6. the sketched stream: the sketch graph in 8 chunks
    t0 = time.perf_counter()
    gs = (main["sketch"]["true_graph"] if "sketch" in main
          else ctr_like(**SKETCH_GRAPH))
    kcfg = ParsaStreamConfig(base=base.replace(
        block_size=SKETCH_BLOCK, set_repr="sketch",
        sketch_hot_bits=SKETCH_BITS, sketch_bucket_bits=SKETCH_BITS),
        repartition="never")
    # beside it the same chunks with each feed's truncated-row width TB
    # padded as the JAX package pads it (a power of two >= 8, for its jit
    # cache; the pad's rows are dropped rows): the bits must not move, and
    # the feed times show what the pad would cost here.  The pad is a copy
    # of the packed arrays, so its `pack` holds one copy more than JAX's.
    from repro_torch.stream import online

    tbs = []

    def jax_tb_pad(*a, **kw):
        pb = pack_graph_blocks(*a, **kw)
        tb = pb.tr_ids.shape[1]
        extra = (1 << (max(tb, 8) - 1).bit_length()) - tb
        tbs.append((tb, tb + extra))
        return pb._replace(
            tr_ids=np.pad(pb.tr_ids, [(0, 0), (0, extra)],
                          constant_values=pb.valid.shape[1]),
            tr_masks=np.pad(pb.tr_masks, [(0, 0), (0, extra), (0, 0)]))

    ksess = StreamSession(kcfg, num_v=gs.num_v, device=dev)
    kpad = StreamSession(kcfg, num_v=gs.num_v, device=dev)
    kfeeds, kpfeeds = [], []
    for i, c in enumerate(stream_chunks(gs, SKETCH_STREAM_CHUNKS)):
        kfeeds.append(counted(lambda: ksess.feed(c), scan1,
                              f"sketched feed {i}", launches["sketched"]))
        online.pack_graph_blocks = jax_tb_pad
        try:
            kpfeeds.append(counted(lambda: kpad.feed(c), scan1,
                                   f"sketched feed {i}, TB padded",
                                   launches["sketched_tb_pad"]))
        finally:
            online.pack_graph_blocks = pack_graph_blocks
        same_update(kpfeeds[-1], kfeeds[-1], f"sketched feed {i}: TB padded")
    same_stream(kpad, ksess, "sketched stream: TB padded")
    run = ksess.sketch.sketch_graph(gs)
    hold_stream(ksess, run, K, "sketched stream")
    kphases = {p: [u.timings[p] for u in kfeeds]
               for p in ("pack", "partition_u", "metrics", "total")}
    kpphases = {p: [u.timings[p] for u in kpfeeds] for p in kphases}
    log(f"stream: sketched stream ({SKETCH_STREAM_CHUNKS} chunks of the "
        f"sketch graph, {ksess.sketch.width_words} words): one parsa_scan a "
        f"feed, live sets = N(U_i) of the sketched graph; feed timings (s) "
        f"{json.dumps(kphases)} ({time.perf_counter() - t0:.2f} s)")
    log(f"stream: the same feeds with TB padded as JAX pads it (TB, padded "
        f"TB) {tbs}: equal updates and live state; feed timings (s) "
        f"{json.dumps(kpphases)}")
    out["sketch_feed_timings"] = kphases
    out["sketch_tb_pad_feed_timings"] = kpphases

    # 7. cpu against cuda on reduced streams, traced
    n, ch = STREAM_SMALL["n"], STREAM_SMALL["chunks"]
    small = base.replace(block_size=128)
    cases = (
        ("exact, drift repair",
         ctr_like_stream(n, STREAM_SMALL["features"], chunks=ch,
                         nnz_per_row=20, churn=0.7, seed=1),
         small, dict(drift_threshold=1.0, drift_min_feeds=1,
                     repartition_frac=0.02), None),
        ("growing V, cap 4", social_like_stream(n, chunks=ch, m=5, seed=2),
         small.replace(cap=4), {}, None),
        ("sketched", ctr_like_stream(n, STREAM_SMALL["sketch_features"],
                                     chunks=ch, nnz_per_row=25, seed=1),
         small.replace(set_repr="sketch", sketch_hot_bits=SKETCH_SMALL_BITS,
                       sketch_bucket_bits=SKETCH_SMALL_BITS), {}, None),
        ("4 workers", text_like_stream(n, STREAM_SMALL["vocab"], chunks=ch,
                                       mean_len=20, seed=1),
         small.replace(backend="parallel_device", workers=4, merge_every=2),
         {}, [1.0, 2.0, 0.5, 3.0]))
    for name, cks, cb, skw, weights in cases:
        cfg = ParsaStreamConfig(base=cb, **skw)
        runs = []
        for device in ("cpu", dev):
            t0 = time.perf_counter()
            ob = Observability()
            ss = StreamSession(cfg, num_v=cks[0].num_v, obs=ob,
                               device=device)
            ops.reset_launch_counts()
            with ob.tracer.installed():
                ups = [ss.feed(c, worker_weights=weights) for c in cks]
                r = ss.result(refine_v=True)
            runs.append((ss, ups, r, chrome_trace_json(ob.tracer),
                         dict(ops.LAUNCHES), time.perf_counter() - t0))
        (sc, uc, rc, tc, _, s_cpu), (sg, ug, rg, tg_, lg, s_gpu) = runs
        for i, (a, b) in enumerate(zip(uc, ug)):
            same_update(a, b, f"{name} feed {i}: cpu vs cuda")
        same_stream(sc, sg, f"{name}: cpu vs cuda")
        same_result(rc, rg, f"{name} result: cpu vs cuda")
        check(tc == tg_, f"{name}: trace exports differ")
        check(lg["parsa_scan"] > 0 and (weights is None
                                        or lg["packed_union_delta"] > 0),
              f"{name}: kernels not launched on the card ({lg})")
        launches[f"reduced {name}"] = {n: v for n, v in lg.items() if v}
        log(f"stream cpu == cuda, {name}: updates, live state, result and "
            f"trace ({len(tc)} bytes) equal; repairs {sc.repartitions}; "
            f"launches {lg} (cpu {s_cpu:.2f} s, cuda {s_gpu:.2f} s)")
        if name.startswith("growing V"):
            check(sg.arena.W_cap > -(-cks[0].num_v // 32),
                  "growing V: the capacity never grew")
            last = pack_graph_blocks(sg.arena.capacity_graph(cks[-1]), 128,
                                     cap=4)
            tm = torch.from_numpy(last.tr_masks)
            check(bool((last.tr_ids != 128).any()),
                  "growing V: no truncated rows at cap 4")
            a_cpu = ops.truncated_lists(tm)
            a_gpu = ops.truncated_lists(tm.to(dev))
            check(all(np.array_equal(x.numpy(), y.cpu().numpy())
                      for x, y in zip(a_cpu, a_gpu)),
                  "truncated_lists differ on the card at the grown width")
            log(f"stream growing V: W_cap {sg.arena.W_cap} words; "
                f"parsa_scan's truncated-row lists at that width equal on "
                f"the card and the CPU")
    return out


# ---------------------------------------------------------------- elastic
def elastic_op_fields(op) -> dict:
    """Every ``ElasticOp`` field but the wall-clock ``seconds``; a closed
    loop's triggering snapshot by its deterministic projection."""
    import dataclasses

    d = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)
         if f.name != "seconds"}
    d["traffic"] = dataclasses.astuple(d["traffic"])
    if d["telemetry"] is not None:
        d["telemetry"] = det_snap(d["telemetry"])
    return d


def same_elastic(a, b, what: str) -> None:
    """Two elastic sessions: live state, traffic and every op equal."""
    check(a.k == b.k, f"{what}: k {a.k} != {b.k}")
    same_stream(a.stream, b.stream, what)
    check([elastic_op_fields(o) for o in a.ops]
          == [elastic_op_fields(o) for o in b.ops], f"{what}: ops differ")


def elastic_digest(sess) -> str:
    """A digest of an elastic session's live state: k, parts, sets, sizes
    and the straggler weights."""
    import hashlib

    import numpy as np

    h = hashlib.blake2b(digest_size=8)
    for a in (np.int64(sess.k), sess.parts,
              sess.stream.arena.masks_np(logical=False),
              sess.stream.arena.sizes.cpu().numpy(), sess.ewma.weights()):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def chaos_replay(dev, g, chunks, scfg, tally: dict | None = None,
                 kernels: bool = True, group=None,
                 by_phase: dict | None = None):
    """One run of CHAOS_EVENTS (``ChaosSchedule(seed=0)``) over ``chunks``
    through an ``ElasticSession`` on ``dev`` (over ``group`` where one is
    given: one worker a rank).  Every feed is counted from 0:
    one ``stream_feed_scan``, one ``elastic_grow_scan`` an add and one
    ``elastic_repair_scan`` a kill, and with ``kernels`` exactly one
    ``parsa_scan`` a sequential feed (one and one ``packed_union_delta`` a
    parallel feed's super-step), grow and warm repair, attributed to
    their phases (no launch at all on the plain route or the CPU).
    Launches are added into ``tally``, and by dispatch phase into
    ``by_phase``.  Returns (session, rows)."""
    import dataclasses

    from repro_torch.api import (
        ChaosEvent, ChaosSchedule, ElasticConfig, ElasticSession)
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.kernels.parsa_cost import ops

    chaos = ChaosSchedule([ChaosEvent(*e) for e in CHAOS_EVENTS], seed=0)
    sess = ElasticSession(ElasticConfig(stream=scfg), num_v=g.num_v,
                          chaos=chaos, device=dev, group=group)
    workers = scfg.workers
    rows = []
    for i, c in enumerate(chunks):
        due = [e[1] for e in CHAOS_EVENTS if e[0] == i]
        adds, kills = due.count("add"), due.count("kill")
        n_ops = len(sess.ops)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with dispatch_counter() as counts:
            upd = sess.feed(c)
        feed_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        check(counts.get("stream_feed_scan") == 1
              and counts.get("elastic_grow_scan", 0) == adds
              and counts.get("elastic_repair_scan", 0) == kills,
              f"chaos feed {i}: dispatches {dict(counts)}")
        n_super = (upd.traffic.tasks // workers
                   if workers > 1 or group is not None else 0)
        want_phase = {}
        if kernels:
            want_phase["stream_feed_scan"] = (
                {"parsa_scan": n_super, "packed_union_delta": n_super}
                if n_super else {"parsa_scan": 1})
            if adds:
                want_phase["elastic_grow_scan"] = {"parsa_scan": adds}
            if kills:
                want_phase["elastic_repair_scan"] = {"parsa_scan": kills}
        want = {}
        for per in want_phase.values():
            for n, v in per.items():
                want[n] = want.get(n, 0) + v
        check(launches == {n: want.get(n, 0) for n in launches},
              f"chaos feed {i}: launches {launches}, want {want}")
        check({n: v for n, v in counts.launches.items() if v} == want_phase,
              f"chaos feed {i}: launches per phase {counts.launches}")
        if tally is not None:
            add_launches(tally, launches)
        if by_phase is not None:
            for ph, per in counts.launches.items():
                add_launches(by_phase.setdefault(ph, {}), per)
        new_ops = sess.ops[n_ops:]
        rows.append({"feed": i, "k": sess.k, "events": due,
                     "digest": elastic_digest(sess),
                     "traffic": dataclasses.astuple(sess.traffic),
                     "feed_s": feed_s,
                     "partition_u_s": upd.timings["partition_u"],
                     "op_s": [o.seconds for o in new_ops],
                     "weights": sess.ewma.weights().tolist()})
    later = sum(e[0] >= len(chunks) for e in CHAOS_EVENTS)
    check(chaos.remaining == later, "chaos events never delivered")
    return sess, rows


def phase_elastic(dev, main: dict) -> dict:
    """Elastic Parsa and the DBPG parameter server on the card
    (``repro_torch.elastic``, ``repro_torch.ml``): the chaos acceptance
    replay of bench_chaos.py twice (bit-deterministic) and on the plain
    route, its warm repair against a cold repartition on clones of one
    snapshot, a shrink and a policy-gated grow, its quality against a
    one-shot partition at the final k; the same script at 8 workers with
    the straggler bias; cpu against cuda on a reduced replay and a
    reduced sketched session; the PS cluster of the paper's Tables 3/4 on
    the main graph's partition against a random placement, twice on the
    card and its first iterations on the CPU, and the chaos replay's
    final placement pushed into a cluster over its graph.

    Returns, under ``launches``, each replay's kernel launches as counted
    from 0 around its feeds, ops and result (the second replay and the
    plain route's are not counted)."""
    import tempfile

    import numpy as np

    from repro_torch.api import (
        ElasticConfig, ElasticSession, ParsaConfig, ParsaStreamConfig,
        StreamSession, partition)
    from repro_torch.configs.parsa_paper import PAPER
    from repro_torch.core.costs import need_matrix, random_parts
    from repro_torch.graphs import ctr_like_stream, text_like
    from repro_torch.ml import DBPGConfig, PSCluster, make_problem

    launches = {s: {} for s in ("acceptance", "clones", "parallel",
                                "reduced", "sketched")}
    out = {"launches": launches}
    t_phase = time.perf_counter()

    # 1. the chaos acceptance replay, twice, and on the plain route
    t0 = time.perf_counter()
    g = text_like(CHAOS["num_docs"], CHAOS["vocab"], mean_len=20, seed=0)
    chunks = stream_chunks(g, CHAOS["chunks"])
    base = ParsaConfig(k=CHAOS["k0"], backend="device_scan",
                       block_size=CHAOS["block"], refine_v=False, seed=0)
    scfg = ParsaStreamConfig(base=base, repartition="never")
    log(f"elastic: chaos graph |U|={g.num_u} |V|={g.num_v} "
        f"|E|={g.num_edges} ({time.perf_counter() - t0:.2f} s)")
    warm, _ = chaos_replay(dev, g, chunks, scfg)
    t0 = time.perf_counter()
    sess, rows = chaos_replay(dev, g, chunks, scfg, launches["acceptance"])
    replay_s = time.perf_counter() - t0
    check(np.array_equal(warm.parts, sess.parts)
          and np.array_equal(warm.stream.arena.masks_np(),
                             sess.stream.arena.masks_np()),
          "chaos replay is not bit-deterministic")
    same_elastic(warm, sess, "chaos replay: run 1 vs run 2")
    adds = sum(e[1] == "add" for e in CHAOS_EVENTS)
    check(sess.k == CHAOS["k0"] + adds, f"chaos replay ends at k={sess.k}")
    # the plain route over the first CHAOS_PLAIN_FEEDS feeds, against the
    # kernels over the same feeds
    head, _ = chaos_replay(dev, g, chunks[:CHAOS_PLAIN_FEEDS], scfg)
    t0 = time.perf_counter()
    with plain_route():
        plain, _ = chaos_replay(dev, g, chunks[:CHAOS_PLAIN_FEEDS], scfg,
                                kernels=False)
    plain_s = time.perf_counter() - t0
    same_elastic(plain, head, "chaos replay: plain route vs kernels")
    grow_s = [o.seconds for o in sess.ops if o.kind == "grow"]
    repair_s = [o.seconds for o in sess.ops if o.kind == "repair"]
    log(f"elastic: chaos replay k {CHAOS['k0']} -> {sess.k} "
        f"({[(o.kind, o.machine) for o in sess.ops]}), bit-deterministic "
        f"and equal to the plain route in parts, sets, sizes, traffic and "
        f"every op over its first {CHAOS_PLAIN_FEEDS} feeds ({plain_s:.2f} "
        f"s plain); migration bytes "
        f"{sess.traffic.migration_bytes}; replay {replay_s:.3f} s, feed "
        f"seconds {json.dumps([r['feed_s'] for r in rows])}, grow op "
        f"seconds {json.dumps(grow_s)}, repair op seconds "
        f"{json.dumps(repair_s)}; launches {launches['acceptance']}")
    out.update(replay_s=replay_s, feed_s=[r["feed_s"] for r in rows],
               grow_s=grow_s, repair_s=repair_s, plain_replay_s=plain_s,
               migration_bytes=sess.traffic.migration_bytes)

    # 2. warm repair against cold repartition, on clones of one snapshot
    tmp = tempfile.TemporaryDirectory()
    snap = pathlib.Path(tmp.name) / "chaos.npz"
    sess.stream.save(snap)
    scfg_final = scfg.replace(base=base.replace(k=sess.k))

    def clone():
        es = ElasticSession(ElasticConfig(stream=scfg_final), num_v=g.num_v,
                            device=dev)
        es.stream = StreamSession.load(snap, scfg_final, device=dev)
        return es

    lost = int(np.argmax(np.bincount(sess.parts, minlength=sess.k)))
    clone().repair(lost, mode="warm")                       # warm-up
    es_w = clone()
    warm_op = counted(lambda: es_w.repair(lost, mode="warm"),
                      {"parsa_scan": 1}, "warm repair", launches["clones"])
    es_p = clone()
    with plain_route():
        counted(lambda: es_p.repair(lost, mode="warm"), {},
                "warm repair, plain route")
    same_elastic(es_p, es_w, "warm repair: plain route vs kernels")
    clone().stream.repartition()                            # warm-up
    es_c = clone()
    t0 = time.perf_counter()
    counted(es_c.stream.repartition, {"parsa_scan": 1}, "cold repartition",
            launches["clones"])
    cold_s = time.perf_counter() - t0
    speedup = cold_s / warm_op.seconds
    log(f"elastic: repair of machine {lost} ({warm_op.moved_u} rows): warm "
        f"{warm_op.seconds:.4f} s (one parsa_scan, equal to the plain "
        f"route) vs cold repartition {cold_s:.4f} s = {speedup:.2f}x "
        f"(bench_chaos.py's bar {CHAOS_MIN_REPAIR_SPEEDUP}x, reported)")
    es_s, es_sp = clone(), clone()
    counted(lambda: es_s.shrink_k(force=True), {}, "shrink")
    with plain_route():
        es_sp.shrink_k(force=True)
    same_elastic(es_sp, es_s, "shrink: plain route vs kernels")
    check(es_s.k == sess.k - 1, "shrink did not commit")
    es_g = clone()
    before = (es_g.parts.copy(), es_g.stream.arena.masks_np(logical=False),
              es_g.traffic)
    gop = counted(es_g.grow_k, {"parsa_scan": 1}, "gated grow",
                  launches["clones"])
    if gop.committed:
        check(es_g.k == sess.k + 1, "a committed grow left k")
    else:
        check(es_g.k == sess.k and np.array_equal(es_g.parts, before[0])
              and np.array_equal(es_g.stream.arena.masks_np(logical=False),
                                 before[1]) and es_g.traffic == before[2],
              "a vetoed grow touched the state")
    log(f"elastic: shrink_k(force=True) {sess.k} -> {es_s.k}, no launch, "
        f"equal to the plain route; ThresholdPolicy grow "
        f"{'committed' if gop.committed else 'vetoed'} (migration "
        f"{gop.traffic.migration_bytes} B against {gop.projected_savings} "
        f"B a feed over 32 feeds)")
    tmp.cleanup()
    out.update(warm_repair_s=warm_op.seconds, cold_repartition_s=cold_s,
               repair_speedup=speedup, gated_grow=gop.committed)

    # 3. quality against a one-shot partition at the final k
    t0 = time.perf_counter()
    res = hold_stream_result(sess.stream, g, sess.k,
                             need_matrix(g, sess.parts, sess.k),
                             "chaos replay", launches["acceptance"])
    oracle = partition(g, base.replace(k=sess.k, refine_v=True,
                                       refine_backend="device"), device=dev)
    pct = (res.metrics.traffic_max / oracle.metrics.traffic_max - 1) * 100
    log(f"elastic: final traffic_max {res.metrics.traffic_max} vs one-shot "
        f"device_scan at k={sess.k} {oracle.metrics.traffic_max} "
        f"({pct:+.2f}%, gate {CHAOS_MAX_QUALITY_PCT}%) "
        f"({time.perf_counter() - t0:.2f} s)")
    check(pct <= CHAOS_MAX_QUALITY_PCT,
          f"elastic quality {pct:+.2f}% past {CHAOS_MAX_QUALITY_PCT}%")
    out["quality_pct"] = pct

    # 4. the parallel chaos replay: 8 workers, straggler bias on
    t0 = time.perf_counter()
    pcfg = ParsaStreamConfig(base=base.replace(backend="parallel_device",
                                               **PAR), repartition="never")
    psess, prows = chaos_replay(dev, g, chunks, pcfg, launches["parallel"])
    par_s = time.perf_counter() - t0
    lane = next(e[2] for e in CHAOS_EVENTS if e[1] == "straggle")
    back = next(e[0] for e in CHAOS_EVENTS if e[1] == "recover")
    start = next(e[0] for e in CHAOS_EVENTS if e[1] == "straggle")
    for r in prows:
        w = np.asarray(r["weights"])
        if r["feed"] < start:
            check(np.all(w == 1.0), f"feed {r['feed']}: weights {w}")
        elif r["feed"] < back:
            check(int(np.argmin(w)) == lane
                  and np.sum(w == w.min()) == 1,
                  f"feed {r['feed']}: lane {lane} not the slowest, {w}")
        else:
            check(w[lane] > prows[r["feed"] - 1]["weights"][lane],
                  f"feed {r['feed']}: lane {lane} did not recover, {w}")
    phead, _ = chaos_replay(dev, g, chunks[:CHAOS_PLAIN_FEEDS], pcfg)
    t0 = time.perf_counter()
    with plain_route():
        pplain, _ = chaos_replay(dev, g, chunks[:CHAOS_PLAIN_FEEDS], pcfg,
                                 kernels=False)
    same_elastic(pplain, phead, "parallel chaos replay: plain vs kernels")
    log(f"elastic: parallel chaos replay ({PAR}, straggler bias on) k "
        f"{CHAOS['k0']} -> {psess.k}, equal to the plain route over its "
        f"first {CHAOS_PLAIN_FEEDS} feeds "
        f"({time.perf_counter() - t0:.2f} s plain); lane {lane} weights by "
        f"feed {json.dumps([round(r['weights'][lane], 4) for r in prows])}; "
        f"feed seconds {json.dumps([r['feed_s'] for r in prows])}; "
        f"launches {launches['parallel']} ({par_s:.2f} s)")
    out.update(parallel_feed_s=[r["feed_s"] for r in prows],
               straggler_weights=[r["weights"][lane] for r in prows])

    # 5. cpu against cuda: the reduced replay and a reduced sketched session
    t0 = time.perf_counter()
    gs = text_like(CHAOS_SMALL["num_docs"], CHAOS_SMALL["vocab"],
                   mean_len=20, seed=0)
    scs = stream_chunks(gs, CHAOS_SMALL["chunks"])
    sbase = base.replace(block_size=CHAOS_SMALL["block"])
    small = ParsaStreamConfig(base=sbase, repartition="never")
    rc, _ = chaos_replay("cpu", gs, scs, small, kernels=False)
    rg, _ = chaos_replay(dev, gs, scs, small, launches["reduced"])
    same_elastic(rc, rg, "reduced chaos replay: cpu vs cuda")
    kb = sbase.replace(k=4, set_repr="sketch",
                       sketch_hot_bits=ELASTIC_SKETCH["bits"],
                       sketch_bucket_bits=ELASTIC_SKETCH["bits"])
    kcfg = ElasticConfig(stream=ParsaStreamConfig(base=kb,
                                                  repartition="never"))
    kch = ctr_like_stream(ELASTIC_SKETCH["n"], ELASTIC_SKETCH["features"],
                          chunks=ELASTIC_SKETCH["chunks"], nnz_per_row=25,
                          seed=1)
    ks = []
    for device in ("cpu", dev):
        es = ElasticSession(kcfg, num_v=kch[0].num_v, device=device)
        one = {} if device == "cpu" else {"parsa_scan": 1}
        tally = None if device == "cpu" else launches["sketched"]
        for c in kch:
            counted(lambda: es.feed(c), one, f"sketched feed on {device}",
                    tally)
        counted(lambda: es.grow_k(force=True), one,
                f"sketched grow on {device}", tally)
        counted(lambda: es.repair(1), one, f"sketched repair on {device}",
                tally)
        ks.append(es)
    check(ks[1].stream.sketch is not None, "the session is not sketched")
    same_elastic(ks[0], ks[1], "sketched elastic: cpu vs cuda")
    log(f"elastic cpu == cuda: the reduced replay ({CHAOS_SMALL}, k "
        f"{CHAOS['k0']} -> {rg.k}) and a sketched session "
        f"({ELASTIC_SKETCH}, grow and repair one parsa_scan each): live "
        f"state and ops equal ({time.perf_counter() - t0:.2f} s)")

    # 6. the PS cluster: the paper's Tables 3/4 on the main partition
    t0 = time.perf_counter()
    gm = main["graph"] if "graph" in main else text_like(**MAIN_GRAPH)
    rm = (main["result"] if "result" in main else partition(
        gm, ParsaConfig(k=K, backend="device_scan", block_size=BLOCK,
                        refine_backend="device", sweeps=2), device=dev))
    _, labels = make_problem(gm, seed=PS["label_seed"])
    dcfg = DBPGConfig(lam=PS["lam"], lr=PS["lr"], max_delay=PS["max_delay"])
    kw = dict(flops_rate=PS["flops_rate"], bandwidth=PS["bandwidth"],
              seed=PS["seed"])
    iters = PAPER.dbpg_passes
    log(f"elastic: PS labels and batches ready "
        f"({time.perf_counter() - t0:.2f} s)")

    def ps_run(pu, pv, device, n, every):
        cl = PSCluster(gm, labels, pu, pv, K, dcfg, device=device, **kw)
        _ = cl.batches, cl.full_batch          # built outside the timing
        t1 = time.perf_counter()
        r = cl.run(n, log_every=every)      # every step reads w back
        return cl, r, (time.perf_counter() - t1) / n

    c1, r1, step1 = ps_run(rm.parts_u, rm.parts_v, dev, iters, iters - 1)
    c2, r2, step2 = ps_run(rm.parts_u, rm.parts_v, dev, iters, iters - 1)
    check(r1 == r2 and np.array_equal(c1.w.cpu().numpy(), c2.w.cpu().numpy())
          and np.array_equal(c1.meter.per_machine, c2.meter.per_machine),
          "PS cluster: two runs on the card differ")
    cr, rr, stepr = ps_run(random_parts(gm.num_u, K, 0),
                           random_parts(gm.num_v, K, 1), dev, iters,
                           iters - 1)
    reduction = 100 * (1 - r1["inter_bytes"] / max(rr["inter_bytes"], 1))
    n = PS["cpu_iters"]
    cc5, rc5, stepc = ps_run(rm.parts_u, rm.parts_v, "cpu", n, 1)
    cg5, rg5, _ = ps_run(rm.parts_u, rm.parts_v, dev, n, 1)
    meter_rel = max(
        abs(a - b) / max(abs(b), 1) for a, b in zip(
            [rg5["inner_bytes"], rg5["inter_bytes"],
             *cg5.meter.per_machine.tolist()],
            [rc5["inner_bytes"], rc5["inter_bytes"],
             *cc5.meter.per_machine.tolist()]))
    check(meter_rel <= PS_METER_REL,
          f"PS meters: cuda {rg5} vs cpu {rc5} ({meter_rel:.2e})")
    obj_rel = max(abs(a - b) / abs(b) for a, b in zip(rg5["objective"],
                                                     rc5["objective"]))
    check(len(rg5["objective"]) == n and obj_rel <= PS_OBJ_REL,
          f"PS objective: cuda {rg5['objective']} vs cpu "
          f"{rc5['objective']}")
    check(np.isfinite(r1["objective"] + rr["objective"]).all(),
          f"PS objectives not finite: {r1['objective']}, {rr['objective']}")
    for name, r, step in (("parsa", r1, step1), ("random", rr, stepr)):
        log(f"elastic PS {name}: inner {r['inner_bytes'] / 1e6:.3f} MB, "
            f"inter {r['inter_bytes'] / 1e6:.3f} MB, inner_fraction "
            f"{r['inner_fraction']:.4f}, modeled {r['modeled_time_s']:.4f} s"
            f", objective {r['objective'][0]:.3f} -> "
            f"{r['objective'][-1]:.3f}, nnz_w {r['nnz_w']}, {step:.4f} s a "
            f"step ({iters} steps, k={K})")
    log(f"elastic PS: Parsa cuts inter-machine bytes {reduction:.2f}% "
        f"against random (paper: >90%); two card runs identical; "
        f"{n} steps on the CPU ({stepc:.3f} s a step): meters within "
        f"{meter_rel:.2e} (limit {PS_METER_REL}), objective within "
        f"{obj_rel:.2e} (limit {PS_OBJ_REL})")
    out["ps"] = {"parsa": r1, "random": rr, "step_s": step1,
                 "random_step_s": stepr, "cpu_step_s": stepc,
                 "inter_reduction_pct": reduction, "meter_rel": meter_rel,
                 "objective_rel": obj_rel}

    # the chaos replay's final placement (k 8 -> 12) pushed into a cluster
    # over its graph, then a few steps
    t0 = time.perf_counter()
    r8 = partition(g, base.replace(refine_v=True, refine_backend="device"),
                   device=dev)
    _, lc = make_problem(g, seed=PS["label_seed"])
    ps = PSCluster.from_partition(g, lc, r8, dcfg, device=dev, **kw)
    rep = sess.sync_cluster(ps)
    check(ps.k == sess.k and np.array_equal(ps.parts_u, sess.parts)
          and rep["reshard_bytes"] > 0, f"sync_cluster: {rep}")
    rs = ps.run(PS["sync_steps"], log_every=1)
    check(np.isfinite(rs["objective"]).all() and rs["inter_bytes"] > 0,
          f"synced cluster run: {rs}")
    log(f"elastic PS: sync_cluster k {CHAOS['k0']} -> {ps.k}: moved rows "
        f"{rep['moved_rows']}, moved weights {rep['moved_weights']}, "
        f"reshard {rep['reshard_bytes'] / 1e6:.3f} MB; then "
        f"{PS['sync_steps']} steps, objective {rs['objective']} "
        f"({time.perf_counter() - t0:.2f} s)")
    out["sync"] = rep
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------ phase serving
def slo_mix():
    """bench_slo.py's two tenants (:72-80): a 3:1 weight split, so the
    light tenant's backlog bound is a third of the heavy one's."""
    from repro_torch.serving import RequestMix, ZipfWorkload

    return RequestMix((
        ZipfWorkload("checkout", batch=72, zipf_s=1.1, weight=3.0),
        ZipfWorkload("reco", batch=48, zipf_s=1.3, hot_offset=777,
                     weight=1.0),
    ))


def obs_mix():
    """tests/test_obs.py's two tenants (:41-46)."""
    from repro_torch.serving import RequestMix, ZipfWorkload

    return RequestMix((
        ZipfWorkload("heavy", batch=24, zipf_s=1.1, weight=3.0),
        ZipfWorkload("light", batch=16, zipf_s=1.3, hot_offset=7,
                     weight=1.0),
    ))


def serve_dbpg():
    from repro_torch.ml import DBPGConfig

    return DBPGConfig(lam=0.05, lr=0.1, kkt_eps=0.0, compress=False,
                      error_feedback=False)


def serve_labels(n_u: int):
    import numpy as np

    return np.where(np.random.default_rng(0).random(n_u) < 0.5, 1.0,
                    -1.0).astype(np.float32)


def serve_cluster(dev, g, labels, parts_u, parts_v, k, bandwidth):
    """A PS cluster on ``dev`` with bench_slo's DBPG and ``w`` drawn from
    seed 1 (``_fresh_cluster``, :162-168)."""
    import numpy as np

    from repro_torch.ml import PSCluster

    cl = PSCluster(g, labels, np.asarray(parts_u).copy(),
                   np.asarray(parts_v).copy(), k, serve_dbpg(),
                   bandwidth=bandwidth, device=dev)
    cl.commit_weights(np.random.default_rng(1).normal(
        0, 0.1, g.num_v).astype(np.float32))
    return cl


def det_snap(snap) -> tuple:
    """A snapshot's deterministic projection (bench_slo.py:171-177)."""
    return (snap.step, snap.k, snap.window, snap.p50_ms, snap.p99_ms,
            snap.mean_ms, snap.occupancy, snap.footprint, snap.sizes,
            snap.speeds, snap.shed, snap.served, snap.open_circuits,
            snap.load_factor)


def slo_signature(run: dict) -> dict:
    """Everything a replay must reproduce (bench_slo.py:180-193)."""
    asc, src, sess = run["asc"], run["src"], run["sess"]
    return {
        "ops": tuple((op.kind, op.k_before, op.k_after, op.machine,
                      op.partner, op.committed, op.moved_u,
                      int(op.traffic.migration_bytes)) for op in sess.ops),
        "decisions": tuple((det_snap(s), d.action, d.target)
                           for s, d in asc.decisions),
        "repairs": tuple((det_snap(s), m) for s, m in asc.repairs),
        "shed": tuple(sorted(src.telemetry.shed.items())),
        "events": tuple(src.events),
    }


def split_losses(trace_json: str) -> tuple[str, list]:
    """A trace export with the compute spans' ``loss`` taken out, and the
    losses in span order: the only float of the trace that the device's
    summation order reaches."""
    doc = json.loads(trace_json)
    losses = [ev["args"].pop("loss") for ev in doc["traceEvents"]
              if "loss" in ev.get("args", {})]
    return json.dumps(doc, sort_keys=True, separators=(",", ":")), losses


def closed_loop(dev, g, labels, parts_v, scfg, slo_cfg, serve_cfg, events,
                mix, n_slots: int, bandwidth: float,
                want_parts=None) -> dict:
    """One traced closed-loop run on fresh state on ``dev``
    (bench_slo.py's ``_closed_loop_run``, :196-224): an autoscaler-owned
    ``ElasticSession`` fed ``g`` once, a cluster on its placement, the
    seeded chaos.  Every kernel's launch count runs from 0 around the feed
    and the run.  ``want_parts``: the placement the feed must give."""
    import dataclasses

    import numpy as np

    from repro_torch.api import (ChaosEvent, ChaosSchedule, ElasticConfig,
                                 ElasticSession, Observability,
                                 PSRequestSource, SLOAutoscaler,
                                 ServingEngine)
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.kernels.parsa_cost import ops

    obs = Observability()
    asc = SLOAutoscaler(dataclasses.replace(slo_cfg, obs=obs))
    ops.reset_launch_counts()
    with dispatch_counter() as counts:
        sess = ElasticSession(
            ElasticConfig(stream=scfg, min_k=slo_cfg.min_k,
                          max_k=slo_cfg.max_k),
            num_v=g.num_v, policy=asc, device=dev)
        sess.feed(g)
        check(want_parts is None or np.array_equal(sess.parts, want_parts),
              "the loop's stream placement drifted from the serving one")
        cluster = serve_cluster(dev, g, labels, sess.parts, parts_v,
                                scfg.base.k, bandwidth)
        src = PSRequestSource(
            cluster, mix, dataclasses.replace(serve_cfg, obs=obs),
            chaos=ChaosSchedule([ChaosEvent(*e) for e in events], seed=0),
            elastic=sess, autoscaler=asc)
        engine = ServingEngine(src)
        t0 = time.perf_counter()
        summary = engine.run(n_slots)
        run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    losses = [sp.attrs["loss"] for sp in obs.tracer.spans
              if sp.name == "compute"]
    check(np.isfinite(losses).all()
          and len(losses) == len(engine.recorder.records),
          f"closed loop on {dev}: {len(losses)} losses, not all finite")
    return dict(asc=asc, src=src, sess=sess, engine=engine, obs=obs,
                summary=summary, counts=counts, launches=launches,
                run_s=run_s, losses=losses)


def check_loop_launches(run: dict, dev, what: str,
                        kernels: bool = True) -> None:
    """One stream_feed_scan, one elastic_grow_scan a grow op and one
    elastic_repair_scan a repair op; on the card one parsa_scan each and
    no other kernel, on the CPU or the plain route (``kernels=False``)
    none at all."""
    counts, ops_ = run["counts"], run["sess"].ops
    grows = sum(op.kind == "grow" for op in ops_)
    repairs = sum(op.kind == "repair" for op in ops_)
    check(counts.get("stream_feed_scan") == 1
          and counts.get("elastic_grow_scan", 0) == grows
          and counts.get("elastic_repair_scan", 0) == repairs,
          f"{what}: dispatches {dict(counts)} for {grows} grows and "
          f"{repairs} repairs")
    kernels = kernels and str(dev) != "cpu"
    want = {"parsa_scan": 1 + grows + repairs} if kernels else {}
    got = run["launches"]
    check(got == {n: want.get(n, 0) for n in got},
          f"{what}: launches {got}, want {want}")
    per = {"stream_feed_scan": {"parsa_scan": 1}}
    if grows:
        per["elastic_grow_scan"] = {"parsa_scan": grows}
    if repairs:
        per["elastic_repair_scan"] = {"parsa_scan": repairs}
    if kernels:
        check({n: v for n, v in counts.launches.items() if v} == per,
              f"{what}: launches per phase {counts.launches}")


def hold_frac(decisions, warmup_windows: int, slo_ms: float) -> float:
    post = decisions[warmup_windows:]
    if not post:
        return 1.0
    return sum(1 for snap, _ in post if snap.p99_ms <= slo_ms) / len(post)


def pilot_bytes(dev, g, labels, parts_u, parts_v, k0, load_factor: float):
    """bench_slo.py's ``_pilot_bytes`` (:115-135): the steady-state mean
    (pull, push) inter-machine bytes a request at one load factor, on an
    effectively infinite NIC."""
    import numpy as np

    from repro_torch.serving import (PSRequestSource, ServingConfig,
                                     ServingEngine)

    cluster = serve_cluster(dev, g, labels, parts_u, parts_v, k0, 1e12)
    cfg = ServingConfig(prefetch=True, warmup=SLO["pilot_warm"], seed=0,
                        pad_multiple=512,
                        service_model_s=SLO["service_model_s"])
    src = PSRequestSource(cluster, slo_mix(), cfg)
    src.load_factor = load_factor
    engine = ServingEngine(src)
    engine.run(SLO["pilot_slots"])
    recs = [r for r in engine.recorder.records if not r.warmup]
    return (float(np.mean([r.pull_inter_bytes for r in recs])),
            float(np.mean([r.push_inter_bytes for r in recs])))


def slo_record() -> dict | None:
    """The JAX package's recorded acceptance run (``BENCH_system.json``
    ``slo_meta``), where the checkout has it: a reference, not a gate."""
    path = ROOT / "BENCH_system.json"
    if not path.is_file():
        return None
    return json.loads(path.read_text()).get("slo_meta")


def slo_acceptance(dev, out: dict) -> None:
    """(a) bench_slo.py's closed-loop acceptance on the card, gated as the
    bench gates it, twice for a bit-identical replay, beside its static
    baseline."""
    import dataclasses

    import numpy as np

    from repro_torch.api import (ChaosEvent, ChaosSchedule, ElasticConfig,
                                 ElasticSession, ParsaConfig,
                                 ParsaStreamConfig, SLOConfig)
    from repro_torch.core.partition_v import partition_v
    from repro_torch.elastic import AutoscaleDecision
    from repro_torch.graphs import ctr_like
    from repro_torch.kernels.parsa_cost import ops
    from repro_torch.obs import CAUSE_KINDS, chrome_trace_json
    from repro_torch.runtime import RetryPolicy
    from repro_torch.serving import (PSRequestSource, ServingConfig,
                                     ServingEngine)

    t0 = time.perf_counter()
    k0, n_slots, svc = SLO["k0"], SLO["n_slots"], SLO["service_model_s"]
    g = ctr_like(num_impressions=SLO["n_u"], num_features=SLO["n_v"],
                 nnz_per_row=SLO["nnz"], clusters=SLO["clusters"],
                 locality=0.85, seed=0)
    labels = serve_labels(g.num_u)
    base = ParsaConfig(k=k0, backend="device_scan", block_size=SLO["block"],
                       refine_v=False, seed=0)
    scfg = ParsaStreamConfig(base=base, repartition="never")
    seed_sess = ElasticSession(ElasticConfig(stream=scfg), num_v=g.num_v,
                               device=dev)
    counted(lambda: seed_sess.feed(g), {"parsa_scan": 1},
            "serving: the placement's stream feed")
    parts_u = np.asarray(seed_sess.parts).copy()
    parts_v = np.asarray(partition_v(g, parts_u, k0, sweeps=2)).copy()
    pull_b, push_b = pilot_bytes(dev, g, labels, parts_u, parts_v, k0,
                                 SLO["burst"])
    pull_0, push_0 = pilot_bytes(dev, g, labels, parts_u, parts_v, k0, 1.0)
    cadence = k0 * svc
    bandwidth = (pull_b + push_b) / (SLO["visit_over"] * cadence)
    visit_base = (pull_0 + push_0) / bandwidth
    visit_burst = SLO["visit_over"] * cadence
    f_eff = (pull_b + push_b) / max(pull_0 + push_0, 1.0)
    check(f_eff >= 1.25, f"burst moves delta traffic only x{f_eff:.2f}")
    slo_ms = 2.6e3 * visit_base
    log(f"serving (a): ctr_like({g.num_u}x{g.num_v}, |E|={g.num_edges}); "
        f"pilots pull/push bytes a request {pull_0:.1f}/{push_0:.1f} at "
        f"load 1, {pull_b:.1f}/{push_b:.1f} at {SLO['burst']}; calibrated "
        f"bandwidth {bandwidth:.6g} B/s, visit {visit_base * 1e3:.4f} -> "
        f"{visit_burst * 1e3:.4f} ms vs cadence {cadence * 1e3:.1f} ms, SLO "
        f"{slo_ms:.4f} ms ({time.perf_counter() - t0:.2f} s)")
    slo_cfg = SLOConfig(
        slo_ms=slo_ms, window_requests=16, decide_every=16,
        warmup_windows=2, patience=1, shrink_patience=3,
        cooldown_windows=0, shrink_p99_frac=0.5,
        shrink_occupancy_s=0.9 * visit_burst,
        min_k=k0, max_k=k0 + 6, drift_ratio=2.0, tau_escalation=4)
    retry = RetryPolicy(timeout_s=0.006, retries=0)
    serve_cfg = ServingConfig(
        prefetch=True, warmup=slo_cfg.decide_every, seed=0,
        pad_multiple=512, retry=retry, service_model_s=svc,
        max_backlog_s=0.85 * slo_ms * 1e-3,
        tau_escalation=slo_cfg.tau_escalation,
        window_requests=slo_cfg.window_requests)
    base_cfg = dataclasses.replace(serve_cfg, max_backlog_s=None,
                                   tau_escalation=0)
    at = lambda frac: int(n_slots * frac)  # noqa: E731
    events = ((at(0.06), "burst", None, SLO["burst"]),
              (at(0.30), "burst", None, 1.0), (at(0.45), "kill", None, 4.0),
              (at(0.60), "straggle", 1, 4.0), (at(0.80), "recover", 1, 4.0))

    # the static baseline: the same windows, every decision "hold"
    class WindowMonitor:
        def __init__(self, config):
            self.config = config
            self.decisions = []

        def decide(self, snap):
            d = AutoscaleDecision("hold", reason="static baseline")
            self.decisions.append((snap, d))
            return d

    t0 = time.perf_counter()
    mon = WindowMonitor(slo_cfg)
    ops.reset_launch_counts()
    base_src = PSRequestSource(
        serve_cluster(dev, g, labels, parts_u, parts_v, k0, bandwidth),
        slo_mix(), base_cfg,
        chaos=ChaosSchedule([ChaosEvent(*e) for e in events], seed=0),
        autoscaler=mon)
    base_summary = ServingEngine(base_src).run(n_slots)
    check(not any(ops.LAUNCHES.values()),
          f"static baseline launched {dict(ops.LAUNCHES)}")
    base_s = time.perf_counter() - t0
    base_hold = hold_frac(mon.decisions, slo_cfg.warmup_windows, slo_ms)
    base_peak = max(s.p99_ms for s, _ in mon.decisions)

    runs = [closed_loop(dev, g, labels, parts_v, scfg, slo_cfg, serve_cfg,
                        events, slo_mix(), n_slots, bandwidth,
                        want_parts=parts_u)
            for _ in range(2)]
    run = runs[0]
    for key, val in slo_signature(run).items():
        check(val == slo_signature(runs[1])[key],
              f"closed-loop replay is not bit-deterministic ({key})")
    check(chrome_trace_json(run["obs"].tracer)
          == chrome_trace_json(runs[1]["obs"].tracer),
          "seeded replays exported different traces")
    check(run["obs"].recorder.to_json() == runs[1]["obs"].recorder.to_json(),
          "seeded replays recorded different event streams")
    for r in runs:
        check_loop_launches(r, dev, "closed loop")
    # the same run on the plain route, on the card's own tensors: its feed
    # (k=8, W=250), its grows (k=2) and its warm repair from surviving
    # sets are the reference the kernel runs above are held to
    t_plain = time.perf_counter()
    with plain_route():
        plain = closed_loop(dev, g, labels, parts_v, scfg, slo_cfg,
                            serve_cfg, events, slo_mix(), n_slots, bandwidth,
                            want_parts=parts_u)
    plain_s = time.perf_counter() - t_plain
    check_loop_launches(plain, dev, "closed loop, plain route",
                        kernels=False)
    check(slo_signature(plain) == slo_signature(run),
          "closed loop: the plain route's signature differs")
    same_elastic(plain["sess"], run["sess"],
                 "closed loop: plain route vs kernels")
    check(chrome_trace_json(plain["obs"].tracer)
          == chrome_trace_json(run["obs"].tracer)
          and plain["obs"].recorder.to_json()
          == run["obs"].recorder.to_json(),
          "closed loop: the plain route's trace or recorder differs")
    asc, src, sess, counts = run["asc"], run["src"], run["sess"], \
        run["counts"]
    explained = 0
    for i, (snap, _) in enumerate(asc.decisions):
        if i < slo_cfg.warmup_windows or snap.p99_ms <= slo_ms:
            continue
        ex = run["obs"].explain(i)
        check(ex.attributed and all(c["kind"] in CAUSE_KINDS
                                    for c in ex.causes),
              f"window {i} violated the SLO unattributed: {ex}")
        explained += 1
    hold = hold_frac(asc.decisions, slo_cfg.warmup_windows, slo_ms)
    shed = src.telemetry.shed_total
    committed = [op for op in sess.ops if op.committed]
    kinds = {k: sum(op.kind == k for op in committed)
             for k in ("grow", "shrink", "repair")}
    k_traj = [int(s.k) for s, _ in asc.decisions]
    check(counts["serving_pull"] == counts["serving_compute"]
          == n_slots - shed, f"serving dispatches {dict(counts)}, shed {shed}")
    check(src.dead == set(), "the loop left a dead machine unrepaired")
    check(kinds["repair"] == 1, f"repairs {kinds}")
    check(kinds["grow"] >= 1, "the loop never grew under the burst")
    check(hold >= SLO_MIN_HOLD_FRAC,
          f"closed loop held the SLO {hold:.4f} < {SLO_MIN_HOLD_FRAC}")
    check(base_hold < SLO_MIN_HOLD_FRAC,
          f"static baseline held {base_hold:.4f}: the script never "
          "stressed it")
    check(shed / n_slots <= SLO_MAX_SHED_FRAC,
          f"shed {shed / n_slots:.4f} > {SLO_MAX_SHED_FRAC}")
    ops_s = [f"{op.kind}(k{op.k_before}->{op.k_after}, m{op.machine})"
             for op in committed]
    shed_t = dict(sorted(src.telemetry.shed.items()))
    log(f"serving (a) closed loop on {dev}: hold {hold:.6f} (gate >= "
        f"{SLO_MIN_HOLD_FRAC}) vs static baseline {base_hold:.6f} (peak "
        f"window p99 {base_peak:.4f} ms vs SLO {slo_ms:.4f} ms); shed "
        f"{shed} ({shed / n_slots:.6f}, gate {SLO_MAX_SHED_FRAC}) "
        f"{shed_t}; ops {ops_s}; k {k0} -> {max(k_traj)} -> {k_traj[-1]}; "
        f"{explained} violated windows, all attributed; replay "
        f"bit-identical (signature, trace, recorder) and equal to the "
        f"plain route's run (signature, trace, recorder, parts, sets, "
        f"sizes, every op; {plain_s:.2f} s); launches "
        f"{run['launches']}; {len(run['obs'].tracer.spans)} spans, "
        f"{len(run['obs'].recorder)} events")
    op_s = {kind: [op.seconds for op in sess.ops if op.kind == kind]
            for kind in ("grow", "repair")}
    log(f"serving (a) seconds: baseline {base_s:.3f}, closed loop "
        f"{runs[0]['run_s']:.3f} / {runs[1]['run_s']:.3f} ({n_slots} slots; "
        f"examples/s {run['summary']['examples_s']:.1f} vs baseline "
        f"{base_summary['examples_s']:.1f}); grow op seconds "
        f"{json.dumps(op_s['grow'])}, repair {json.dumps(op_s['repair'])}")
    rec = slo_record()
    if rec is None:
        log("serving (a): BENCH_system.json slo_meta not in the checkout")
    else:
        first = next((i for i, (a, b) in enumerate(
            zip(k_traj, rec["k_trajectory"])) if a != b), None)
        log(f"serving (a) against the JAX package's recorded run "
            f"(BENCH_system.json slo_meta, JAX on a CPU, an older tree): "
            f"ops {rec['ops']} vs {ops_s}; shed {rec['shed_per_tenant']} "
            f"vs {shed_t}; hold {rec['hold_frac']:.6f} vs {hold:.6f}; "
            f"baseline {rec['baseline_hold_frac']:.6f} vs "
            f"{base_hold:.6f}; bandwidth {rec['bandwidth']:.6g} vs "
            f"{bandwidth:.6g}; slo_ms {rec['slo_ms']:.6f} vs {slo_ms:.6f}; "
            f"k trajectories equal: {k_traj == rec['k_trajectory']}, first "
            f"differing window {first}")
    out["acceptance"] = dict(
        hold=hold, baseline_hold=base_hold, shed=shed, shed_per_tenant=shed_t,
        ops=ops_s, k_trajectory=k_traj, bandwidth=bandwidth, slo_ms=slo_ms,
        run_s=[r["run_s"] for r in runs], baseline_s=base_s,
        plain_run_s=plain_s,
        examples_s=run["summary"]["examples_s"])
    out["launches"]["acceptance"] = {n: v for n, v in run["launches"].items()
                                     if v}


def open_loop(dev, main: dict, out: dict) -> None:
    """(b) Open-loop PS serving on the main graph at full size, sync and
    async, on Parsa's placement and on random_parts; a kill under load
    with the session attached; a profile window over served requests."""
    import tempfile

    import numpy as np

    from repro_torch.api import (ChaosEvent, ChaosSchedule, ElasticConfig,
                                 ElasticSession, ParsaConfig,
                                 ParsaStreamConfig, StreamSession)
    from repro_torch.core.costs import random_parts
    from repro_torch.core.dispatch import dispatch_counter
    from repro_torch.core.partition_v import partition_v
    from repro_torch.graphs import text_like
    from repro_torch.kernels.parsa_cost import ops
    from repro_torch.serving import (PSRequestSource, ServingConfig,
                                     ServingEngine)

    t0 = time.perf_counter()
    k, n = SERVE_OPEN["k"], SERVE_OPEN["requests"]
    g = main["graph"] if "graph" in main else text_like(**MAIN_GRAPH)
    labels = serve_labels(g.num_u)
    scfg = ParsaStreamConfig(base=ParsaConfig(
        k=k, backend="device_scan", block_size=SERVE_OPEN["block"],
        refine_v=False, seed=0), repartition="never")
    sess = ElasticSession(ElasticConfig(stream=scfg), num_v=g.num_v,
                          device=dev)
    counted(lambda: sess.feed(g), {"parsa_scan": 1},
            "serving (b): the stream feed", out["launches"]["open_loop"])
    parts_u = np.asarray(sess.parts).copy()
    parts_v = np.asarray(partition_v(g, parts_u, k, sweeps=2)).copy()
    placements = {"parsa": (parts_u, parts_v),
                  "random": (random_parts(g.num_u, k, 0),
                             random_parts(g.num_v, k, 1))}
    log(f"serving (b): main graph fed at k={k}, B={SERVE_OPEN['block']}, "
        f"partition_v ({time.perf_counter() - t0:.2f} s)")

    def serve(pu, pv, prefetch, chaos=None, elastic=None):
        cl = serve_cluster(dev, g, labels, pu, pv, k,
                           SERVE_OPEN["bandwidth"])
        cfg = ServingConfig(prefetch=prefetch, warmup=SERVE_OPEN["warmup"],
                            seed=0, pad_multiple=512)
        src = PSRequestSource(cl, slo_mix(), cfg, chaos=chaos,
                              elastic=elastic)
        return ServingEngine(src), src, cl

    rows = {}
    for name, (pu, pv) in placements.items():
        for prefetch in (False, True):
            engine, src, cl = serve(pu, pv, prefetch)
            ops.reset_launch_counts()
            s = engine.run(n)
            check(not any(ops.LAUNCHES.values()),
                  f"open loop launched {dict(ops.LAUNCHES)}")
            check(s["requests"] == n - SERVE_OPEN["warmup"]
                  and s["stale_entries"] == 0,
                  f"open loop {name}: {s['requests']} requests")
            mode = "async" if prefetch else "sync"
            ov = s["overlap"]
            wire = ov["wire_s"] + ov["wait_s"]
            row = dict(examples_s=s["examples_s"], p50_ms=s["p50_ms"],
                       p99_ms=s["p99_ms"], wall_s=s["wall_s"],
                       blocked_s=ov["blocked_s"], wire_s=wire,
                       compute_s=ov["compute_s"],
                       blocked_share=ov["blocked_s"] / s["wall_s"],
                       wire_share=wire / s["wall_s"],
                       pull_bytes=s["pull_inter_bytes"] / s["requests"],
                       push_bytes=s["push_inter_bytes"] / s["requests"])
            rows[f"{name}_{mode}"] = row
            log(f"serving (b) {name} {mode}: {row['examples_s']:.1f} "
                f"examples/s, engine p50 {row['p50_ms']:.4f} / p99 "
                f"{row['p99_ms']:.4f} ms, blocked {row['blocked_s']:.4f} s "
                f"({row['blocked_share']:.4f} of wall) vs wire "
                f"{row['wire_s']:.4f} s ({row['wire_share']:.4f}), compute "
                f"{row['compute_s']:.4f} s; inter-machine bytes a request: "
                f"pull {row['pull_bytes']:.1f}, push {row['push_bytes']:.1f}")
    cut = 1 - (rows["parsa_async"]["pull_bytes"]
               + rows["parsa_async"]["push_bytes"]) / max(
        rows["random_async"]["pull_bytes"]
        + rows["random_async"]["push_bytes"], 1.0)
    speed = (rows["parsa_async"]["examples_s"]
             / rows["random_async"]["examples_s"])
    log(f"serving (b): Parsa cuts inter-machine bytes a served request "
        f"{cut * 100:.2f}% against random_parts (async); examples/s "
        f"{speed:.4f}x")
    out["open_loop"] = dict(rows=rows, bytes_cut=cut)

    # a kill under load with the session attached: one warm repair, then
    # the same run from a clone of the fed session on the plain route
    tmp = tempfile.TemporaryDirectory()
    snap = pathlib.Path(tmp.name) / "open_loop.npz"
    sess.stream.save(snap)
    clone = ElasticSession(ElasticConfig(stream=scfg), num_v=g.num_v,
                           device=dev)
    clone.stream = StreamSession.load(snap, scfg, device=dev)
    tmp.cleanup()

    def kill_run(es):
        engine, src, cl = serve(parts_u, parts_v, True, chaos=ChaosSchedule(
            [ChaosEvent(feed=SERVE_OPEN["kill_at"], kind="kill")], seed=0),
            elastic=es)
        return engine, src, cl, cl.placement_version

    engine, src, cl, v0 = kill_run(sess)
    ops.reset_launch_counts()
    with dispatch_counter() as counts:
        s = engine.run(n)
    launches = dict(ops.LAUNCHES)
    p_engine, p_src, p_cl, _ = kill_run(clone)
    t_plain = time.perf_counter()
    with plain_route():
        counted(lambda: p_engine.run(n), {}, "kill under load, plain route")
    plain_s = time.perf_counter() - t_plain
    same_elastic(clone, sess, "kill under load: plain route vs kernels")
    fields = ("tenant", "step", "home", "examples", "pull_inter_bytes",
              "push_inter_bytes", "modeled_s")
    check([tuple(getattr(r, f) for f in fields)
           for r in p_engine.recorder.records]
          == [tuple(getattr(r, f) for f in fields)
              for r in engine.recorder.records]
          and np.array_equal(p_cl.owner, cl.owner)
          and p_cl.placement_version == cl.placement_version
          and p_src.events == src.events,
          "kill under load: the plain route served differently")
    repairs = [op for op in sess.ops if op.kind == "repair"]
    check(len(sess.ops) == 1 and len(repairs) == 1 and repairs[0].committed,
          f"kill under load: ops {sess.ops}")
    check(launches == {x: (1 if x == "parsa_scan" else 0) for x in launches}
          and counts.get("elastic_repair_scan") == 1,
          f"kill under load: launches {launches}, dispatches {dict(counts)}")
    check(cl.placement_version > v0
          and src.router.version == cl.placement_version,
          "kill under load: the repair never reached the router")
    check(s["requests"] == n - SERVE_OPEN["warmup"] and src.dead == set(),
          f"kill under load: {s['requests']} requests, dead {src.dead}")
    add_launches(out["launches"]["open_loop"], launches)
    log(f"serving (b) kill at slot {SERVE_OPEN['kill_at']}: machine "
        f"{repairs[0].machine} repaired warm ({repairs[0].moved_u} rows, "
        f"{repairs[0].seconds:.4f} s, one parsa_scan; the plain route's "
        f"run from a clone gives the same parts, sets, sizes, op, owners "
        f"and request records, {plain_s:.2f} s), placement_version "
        f"{v0} -> {cl.placement_version} seen by the router; all "
        f"{s['requests']} requests served, {s['examples_s']:.1f} "
        f"examples/s, p99 {s['p99_ms']:.4f} ms")
    out["open_loop"]["kill"] = dict(repair_s=repairs[0].seconds,
                                    moved_u=repairs[0].moved_u,
                                    examples_s=s["examples_s"],
                                    p99_ms=s["p99_ms"])

    # one profile window over served requests (sync, so each request's
    # wire, compute and push sit inside the window)
    engine, src, cl = serve(parts_u, parts_v, False)
    state = {"t": 0}

    def serve_four():
        for _ in range(4):
            t = state["t"]
            cur = engine._produce(t)
            engine._serve_one(*cur, t, engine.recorder, engine.overlap)
            state["t"] = t + 1

    prof = profile_window(serve_four)
    log("serving (b) profile window, 4 sync requests: " + json.dumps(
        {k_: v for k_, v in prof.items() if k_ != "top"})
        + f"; top kernels {prof.get('top')}")
    out["open_loop"]["profile"] = {k_: v for k_, v in prof.items()
                                   if k_ != "top"}


def reduced_cpu_vs_cuda(dev, out: dict) -> None:
    """(c) tests/test_obs.py's traced closed loop on the CPU and on the
    card: the same signature, trace and recorder bytes (the compute spans'
    losses within SERVE_LOSS_REL), the same request records."""
    import numpy as np

    from repro_torch.api import ParsaConfig, ParsaStreamConfig, SLOConfig
    from repro_torch.core.costs import random_parts
    from repro_torch.graphs import ctr_like
    from repro_torch.obs import chrome_trace_json
    from repro_torch.runtime import RetryPolicy
    from repro_torch.serving import ServingConfig

    t0 = time.perf_counter()
    k = SERVE_SMALL["k"]
    g = ctr_like(SERVE_SMALL["n_u"], SERVE_SMALL["n_v"],
                 nnz_per_row=SERVE_SMALL["nnz"],
                 clusters=SERVE_SMALL["clusters"], locality=0.85, seed=0)
    labels = serve_labels(g.num_u)
    scfg = ParsaStreamConfig(base=ParsaConfig(k=k, backend="device_scan",
                                              refine_v=False, seed=0))
    slo_cfg = SLOConfig(slo_ms=16.0, window_requests=8, decide_every=8,
                        warmup_windows=1, patience=1, cooldown_windows=0,
                        min_k=k, max_k=k + 3)
    serve_cfg = ServingConfig(
        prefetch=True, warmup=2, seed=0, pad_multiple=512,
        retry=RetryPolicy(timeout_s=0.004, retries=0), service_model_s=2e-3,
        max_backlog_s=0.1, window_requests=slo_cfg.window_requests)
    events = ((8, "burst", None, 2.5), (40, "burst", None, 1.0),
              (48, "kill", None, 4.0), (64, "straggle", 1, 4.0),
              (80, "recover", 1, 4.0))
    runs = {d: closed_loop(d, g, labels, random_parts(g.num_v, k, 1), scfg,
                           slo_cfg, serve_cfg, events, obs_mix(),
                           SERVE_SMALL["slots"], SERVE_SMALL["bandwidth"])
            for d in ("cpu", dev)}
    cpu, gpu = runs["cpu"], runs[dev]
    check_loop_launches(cpu, "cpu", "reduced loop on the CPU")
    check_loop_launches(gpu, dev, "reduced loop on the card")
    check(slo_signature(cpu) == slo_signature(gpu),
          "reduced closed loop: cpu and cuda signatures differ")
    fields = ("tenant", "step", "home", "examples", "tokens",
              "fresh_entries", "stale_entries", "pull_inter_bytes",
              "push_inter_bytes", "wire_s", "wait_s", "modeled_s")
    recs = [[tuple(getattr(r, f) for f in fields)
             for r in run["engine"].recorder.records] for run in (cpu, gpu)]
    check(recs[0] == recs[1], "reduced closed loop: request records differ")
    tc, lc = split_losses(chrome_trace_json(cpu["obs"].tracer))
    tg, lg = split_losses(chrome_trace_json(gpu["obs"].tracer))
    check(tc == tg, "reduced closed loop: cpu and cuda traces differ")
    check(cpu["obs"].recorder.to_json() == gpu["obs"].recorder.to_json(),
          "reduced closed loop: cpu and cuda recorders differ")
    rel = float(np.max(np.abs(np.asarray(lg) - np.asarray(lc))
                       / np.abs(np.asarray(lc))))
    check(len(lc) == len(lg) and rel <= SERVE_LOSS_REL,
          f"reduced closed loop: losses {rel:.3e} apart")
    bitwise = sum(a == b for a, b in zip(lc, lg))
    log(f"serving (c) cpu == cuda on the reduced traced loop "
        f"({SERVE_SMALL}): signature, request records, trace (but the "
        f"losses) and recorder bytes equal; {len(lc)} losses within "
        f"{rel:.3e} relative ({bitwise} bit-equal); ops "
        f"{[(op.kind, op.k_after) for op in gpu['sess'].ops]}; launches "
        f"{gpu['launches']} ({time.perf_counter() - t0:.2f} s)")
    out["reduced"] = dict(loss_rel=rel, losses_bit_equal=bitwise,
                          n_losses=len(lc))
    out["launches"]["reduced"] = {n: v for n, v in gpu["launches"].items()
                                  if v}


def phase_serving(dev, main: dict) -> dict:
    """The PS serving loop on the card (``repro_torch.serving``,
    ``repro_torch.elastic.autoscaler``): (a) bench_slo.py's closed-loop
    SLO acceptance; (b) open-loop serving at the main graph's size and a
    kill under load; (c) cpu against cuda on the reduced traced loop.

    Returns, under ``launches``, each part's kernel launches as counted
    from 0 around its feeds, runs and repairs."""
    out = {"launches": {"acceptance": {}, "open_loop": {}, "reduced": {}}}
    t0 = time.perf_counter()
    slo_acceptance(dev, out)
    log(f"serving (a) {time.perf_counter() - t0:.2f} s")
    t1 = time.perf_counter()
    open_loop(dev, main, out)
    log(f"serving (b) {time.perf_counter() - t1:.2f} s")
    t1 = time.perf_counter()
    reduced_cpu_vs_cuda(dev, out)
    log(f"serving (c) {time.perf_counter() - t1:.2f} s")
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------- phase 7
def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def moe_routes(seen: list, pinned=None, tally: dict | None = None):
    """Record the expert ids (T, K) of every ``apply_moe`` call in
    ``seen``.  With ``pinned`` (an iterable of (T, K) ids, one a call in
    call order), route each call by the next pinned ids instead, weighted
    as ``_route`` weights its own (the probabilities at those ids,
    renormalised), and count in ``tally`` the (token, slot) choices where
    the call's own ids differ ("flips").  A flip is discrete: one choice
    that two routes round to different experts moves a token's output by
    the difference of two experts, so logits are held to each other under
    the same choices, and the flips are reported."""
    import torch

    from repro_torch.models import moe as M

    route, it = M._route, None if pinned is None else iter(pinned)

    def wrapped(p, xt, cfg):
        probs, top_w, top_e = route(p, xt, cfg)
        if it is not None:
            ids = next(it)
            tally["choices"] = tally.get("choices", 0) + ids.numel()
            tally["flips"] = tally.get("flips", 0) + int((top_e != ids).sum())
            top_w = probs.gather(1, ids)
            top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
            top_e = ids
        seen.append(top_e)
        return probs, top_w, top_e

    M._route = wrapped
    try:
        yield seen
    finally:
        M._route = route


def attention_ref_by_head(q, k, v, window):
    """``flash_attention_ref`` at q's shape, one call a (batch row, KV
    head): the same arithmetic a head at a time, so that its float32
    (Sq, Skv) scores fit beside the model's weights (48 heads at S = 8,192
    would take 26 GB a tensor at once)."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    B, _, H, _ = q.shape
    KV = k.shape[2]
    G = H // KV
    out = q.new_empty(q.shape[:3] + v.shape[3:])   # v's head dim
    for b in range(B):
        for j in range(KV):
            out[b:b + 1, :, j * G:(j + 1) * G] = FA.flash_attention_ref(
                q[b:b + 1, :, j * G:(j + 1) * G], k[b:b + 1, :, j:j + 1],
                v[b:b + 1, :, j:j + 1], causal=True, window=window)
    return out


def prefill_launches(cfg) -> int:
    """flash_attention launches of one prefill: one per layer; the
    encoder-decoder's encoder layers, decoder self-attention and
    cross-attention one each."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def cache_leaves(cfg, cache) -> dict:
    """The cache leaves a prefill's routes are compared on, layer-major:
    MLA's latent, the per-head keys, or the encoder-decoder's self keys
    and cross keys."""
    if cfg.family == "encdec":
        return {"self_k": cache["self"]["k"], "cross_k": cache["cross"][0]}
    ck = "c_kv" if cfg.mla else "k"
    return {ck: cache[ck]}


def encdec_frames(cfg, B: int, seed: int):
    """The stub front end's input, (B, encoder_seq, d_model) float32 frame
    embeddings ``normal(0, 0.1)`` from ``default_rng(seed)``, as
    tests/test_models.py:24-25 makes them."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))


def phase_lm(dev, lm: dict = LM, extra=None) -> dict:
    """The LM serving path on the card; see the module docstring, item 10.
    Phases moe, mla and encdec run it on ``MOE``, ``MLA`` and ``ENCDEC``
    and add their checks through ``extra``, called with the weights before
    they are freed.  The encoder-decoder's prefill batches carry frames
    (``encdec_frames``), and its teacher forcing decodes the prompt's
    second half from a prefill of its first (the cross cache the
    prefill's)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import (_init_cache, decode_loop,
                                          decode_loop_engine)
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import layers as LL

    tag = lm.get("phase", "lm")
    cfg = get_config(lm["arch"])
    if lm["num_layers"]:
        cfg = dataclasses.replace(cfg, num_layers=lm["num_layers"])
    heads = (f"{cfg.num_heads} MLA, q/k {cfg.head_dim}+{cfg.rope_head_dim}, "
             f"v {cfg.v_head_dim}, kv_lora {cfg.kv_lora_rank}, q_lora "
             f"{cfg.q_lora_rank}" if cfg.mla else
             f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim}")
    encdec = cfg.family == "encdec"
    want_launches = prefill_launches(cfg)
    out: dict = {"arch": cfg.name, "num_layers": cfg.num_layers,
                 "d_model": cfg.d_model, "d_ff": cfg.d_ff, "heads": heads,
                 "vocab": f"{cfg.vocab_size} (padded {cfg.padded_vocab})",
                 "experts": f"{cfg.num_experts} top-{cfg.num_experts_per_tok}",
                 "swa_window": cfg.swa_window}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, prefill = make_prefill_step(cfg, dev)
    _, prefill_plain = make_prefill_step(cfg, dev, flash=False)
    params = model.init(lm["seed"])
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = model.param_count(params)
    out["weights_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    log(f"{tag}: {cfg.name}, {cfg.num_layers} layers, {out['params']:,} "
        f"parameters ({out['weights_gb']:.2f} GB bf16) drawn in "
        f"{out['init_s']:.2f} s")

    # (a) the prefill: one flash_attention launch per layer
    rng = np.random.default_rng(lm["seed"])
    B, S = lm["prefill_batch"], lm["prefill_seq"]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    batch = {"tokens": tokens, "cache_seq": lm["cache_seq"]}
    if encdec:
        batch["frames"] = encdec_frames(cfg, B, lm["seed"]).to(dev)
    logits, cache = prefill(params, batch)           # warm-up
    del logits, cache
    torch.cuda.synchronize()
    FA.reset_launch_counts()
    EW.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    launches = FA.LAUNCHES["flash_attention"]
    out["prefill_flash_launches"] = launches
    act = "gelu_stepwise" if cfg.mlp == "gelu" else "silu_stepwise"
    out["prefill_elementwise_launches"] = dict(EW.LAUNCHES)
    check(EW.LAUNCHES[act] > 0, f"prefill made no {act} launch")
    check(launches == want_launches,
          f"prefill made {launches} flash_attention launches, want "
          f"{want_launches} (one per layer" +
          (", encoder, self and cross)" if encdec else ")"))
    if encdec:   # the same launches by role, told apart by (causal, Sq, Skv)
        Se = cfg.encoder_seq
        by_role = {r: FA.LAUNCH_SHAPES.get(key, 0) for r, key in (
            ("encoder", (False, Se, Se)), ("decoder_self", (True, S, S)),
            ("cross", (False, S, Se)))}
        out["prefill_flash_launches_by_role"] = by_role
        check(by_role == {"encoder": cfg.encoder_layers,
                          "decoder_self": cfg.num_layers,
                          "cross": cfg.num_layers},
              f"prefill flash launches by role {by_role}, by (causal, Sq, "
              f"Skv) {FA.LAUNCH_SHAPES}: want one a layer in each role")
    check(tuple(logits.shape) == (B, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    out["prefill_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    logits_p, cache_p = prefill_plain(params, batch)
    torch.cuda.synchronize()
    out["prefill_plain_s"] = time.perf_counter() - t0
    check(FA.LAUNCHES["flash_attention"] == launches,
          "the plain route launched the flash kernel")
    out["prefill_logits_max_abs_err"] = float(
        (logits.float() - logits_p.float()).abs().max())
    out["prefill_logits_rel_l2"] = rel_l2(logits, logits_p)
    plain_leaves = cache_leaves(cfg, cache_p)
    for name, leaf in cache_leaves(cfg, cache).items():
        key = f"prefill_last_layer_{name}_rel_l2"
        # the last layer's written slots (every slot of the cross cache)
        sl = (-1,) if name == "cross_k" else (-1, slice(None), slice(0, S))
        out[key] = rel_l2(leaf[sl], plain_leaves[name][sl])
        # the encoder-decoder's caches are held as its logits are
        check(not encdec or out[key] <= LM_MAX_REL_L2,
              f"prefill {name} cache, kernel route against plain route: "
              f"relative L2 {out[key]:.3e} > {LM_MAX_REL_L2}")
    check(out["prefill_logits_rel_l2"] <= LM_MAX_REL_L2,
          f"prefill logits, kernel route against plain route: relative L2 "
          f"{out['prefill_logits_rel_l2']:.3e} > {LM_MAX_REL_L2}")
    log(f"{tag} prefill B={B} S={S}: {out['prefill_s']:.3f} s with the kernel "
        f"({launches} launches), {out['prefill_plain_s']:.3f} s plain; "
        f"logits max abs err {out['prefill_logits_max_abs_err']:.3e}, "
        f"relative L2 {out['prefill_logits_rel_l2']:.3e}")
    del logits, cache, logits_p, cache_p

    # layer 0's attention (windowed where the config has a window):
    # kernel against plain on the same inputs
    p0, dt = params["stack"][0], getattr(torch, cfg.dtype)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    with torch.no_grad():
        x0 = model._embed(params, tokens)
        if encdec:   # the decoder's input: tokens and sinusoidal positions
            x0 = model._positions_added(x0)
        h = LL.apply_norm(p0["ln1"], x0, cfg.norm)
        if cfg.mla:   # the per-head q, k (dn + dr) and v (dv) of the prefill
            xq, xk, xv = LL.mla_qkv(p0["attn"], *LL.mla_projection(
                p0["attn"], h, cfg, positions, dt), dt)
        else:
            xq, xk, xv = LL.qkv_projection(p0["attn"], h, cfg, positions, dt)
        out["layer0_tensor_cores"] = FA.uses_tensor_cores(xq, xk, xv)
        check(out["layer0_tensor_cores"], f"layer 0's attention at "
              f"{tuple(xq.shape)}, v {tuple(xv.shape)} is off the "
              "tensor-core route")
        got = FA.flash_attention(xq, xk, xv, causal=True,
                                 window=cfg.swa_window)
        want = attention_ref_by_head(xq, xk, xv, cfg.swa_window)
        chunked = LL.attention(xq, xk, xv, q_positions=positions,
                               k_positions=positions, causal=True,
                               window=cfg.swa_window, impl=cfg.attn_impl,
                               chunk=cfg.attn_chunk, dtype=dt)
    tol = FLASH_TOL[cfg.dtype]
    for name, ref in (("plain", want), ("chunked", chunked)):
        d = (got.float() - ref.float()).abs()
        out[f"layer0_attn_max_abs_err_{name}"] = float(d.max())
        check(bool((d <= tol + tol * ref.float().abs()).all()),
              f"layer 0 attention, kernel against {name}: max abs err "
              f"{float(d.max()):.3e} past {tol}")
    # kept on the host for phase times (MLA's are 1.07 GB)
    out["layer0_qkv"] = tuple(t.cpu() for t in (xq, xk, xv))
    del got, want, chunked, h, x0, xq, xk, xv

    # (b) greedy decode through the serving engine, against decode_loop
    smodel, step = make_serve_step(cfg, dev)
    Bs, P, G = lm["serve_batch"], lm["prompt"], lm["gen"]
    prompt = rng.integers(0, cfg.vocab_size, (Bs, P))
    t0 = time.perf_counter()
    ref_tokens = decode_loop(smodel, step, params, prompt, G, P + G)
    out["decode_loop_s"] = time.perf_counter() - t0
    FA.reset_launch_counts()
    EW.reset_launch_counts()
    t0 = time.perf_counter()
    tokens_e, summary = decode_loop_engine(smodel, step, params, prompt, G,
                                           P + G, prefetch=True)
    wall = time.perf_counter() - t0
    check(FA.LAUNCHES["flash_attention"] == 0,
          "decode launched the flash kernel (it stays on the plain route)")
    out["engine_elementwise_launches"] = dict(EW.LAUNCHES)
    check(EW.LAUNCHES[act] > 0, f"the engine's decode made no {act} launch")
    check(np.array_equal(tokens_e, ref_tokens),
          "engine tokens differ from decode_loop's")
    check(bool(((tokens_e >= 0) & (tokens_e < cfg.vocab_size)).all()),
          "a generated token lies outside the vocabulary")
    check(summary["requests"] == P - 1 + G,
          f"engine served {summary['requests']} requests, want {P - 1 + G}")
    out["engine"] = {k: summary[k] for k in (
        "requests", "tokens", "wall_s", "tokens_s", "p50_ms", "p99_ms",
        "mean_ms", "compute_s")}
    out["engine"]["per_tenant"] = summary["per_tenant"]
    out["engine_s"] = wall
    out["generated_tok_s"] = Bs * G / wall
    log(f"{tag} serve B={Bs} prompt={P} gen={G}: {summary['requests']} engine "
        f"requests in {wall:.3f} s, {out['generated_tok_s']:.1f} generated "
        f"tok/s, {summary['tokens_s']:.1f} token-steps/s, p50 "
        f"{summary['p50_ms']:.2f} ms, p99 {summary['p99_ms']:.2f} ms per "
        f"token step; tokens equal decode_loop's ({out['decode_loop_s']:.3f} s)")

    # (c) teacher forcing: prefill's last logits against the last prompt
    # step of the decode (the padded columns are masked only in decode).
    # An MoE prefill of Bs * P tokens may drop assignments past its
    # capacity that decode (Bs tokens, capacity >= Bs * top-k) keeps, so
    # the held prefill runs at lm["teacher_forcing"]'s capacity factor,
    # E / top-k (capacity = its token count: no drop), and the one at the
    # config's factor is reported beside it
    pbatch = {"tokens": torch.from_numpy(prompt).to(dev), "cache_seq": P + G}
    toks = torch.from_numpy(prompt).to(dev)
    # the encoder-decoder decodes the prompt's second half from a prefill
    # of its first: its cross cache is the prefill's
    start = P // 2 if encdec else 0
    if encdec:
        pbatch["frames"] = batch["frames"][:Bs]

    def decode_prompt():
        if start:
            c = prefill(params, dict(pbatch, tokens=toks[:, :start]))[1]
        else:
            c = smodel.init_cache(Bs, P + G)
        for t in range(start, P):
            _, logits, c = step(params, {"token": toks[:, t:t + 1], "pos": t,
                                         "cache": c})
        return logits

    lp, _ = prefill(params, pbatch)
    ls = decode_prompt()
    V = cfg.vocab_size
    held = (ls, lp)
    if lm.get("teacher_forcing"):
        # the decode routed by the prefill's expert choices, token by
        # token and layer by layer
        seen: list = []
        with moe_routes(seen):
            lp_held, _ = make_prefill_step(dataclasses.replace(
                cfg, **lm["teacher_forcing"]), dev)[1](params, pbatch)
        K = cfg.num_experts_per_tok
        pins = [e.view(Bs, P, K)[:, t] for t in range(P) for e in seen]
        tally: dict = {}
        with moe_routes([], pins, tally):
            ls_pinned = decode_prompt()
        held = (ls_pinned, lp_held)
        out["teacher_forcing_over"] = dict(lm["teacher_forcing"])
        out["teacher_forcing_route_flips"] = tally
        out["teacher_forcing_rel_l2_own_routes"] = rel_l2(ls[:, :V],
                                                          lp_held[:, :V])
        out["teacher_forcing_rel_l2_config_capacity"] = rel_l2(
            ls[:, :V], lp[:, :V])
        log(f"{tag} teacher forcing at {lm['teacher_forcing']}: relative L2 "
            f"{rel_l2(ls_pinned[:, :V], lp_held[:, :V]):.3e} with the "
            f"prefill's expert choices ({tally['flips']} of "
            f"{tally['choices']} (token, slot) choices of the decode's own "
            f"differ), {out['teacher_forcing_rel_l2_own_routes']:.3e} on "
            f"its own; {out['teacher_forcing_rel_l2_config_capacity']:.3e} "
            f"against the prefill at the config's capacity (reported)")
        del lp_held, ls_pinned, seen, pins
    out["teacher_forcing_rel_l2"] = rel_l2(held[0][:, :V], held[1][:, :V])
    out["teacher_forcing_max_abs_err"] = float(
        (held[0][:, :V].float() - held[1][:, :V].float()).abs().max())
    check(out["teacher_forcing_rel_l2"] <= LM_MAX_REL_L2,
          f"teacher forcing: relative L2 {out['teacher_forcing_rel_l2']:.3e}")
    del lp, ls, held

    # where the time goes: one prefill and one decode step, profiled
    c = _init_cache(smodel, Bs, P + G)
    tok = toks[:, :1]
    out["profile_prefill"] = profile_window(lambda: prefill(params, batch))
    out["profile_decode_step"] = profile_window(
        lambda: step(params, {"token": tok, "pos": 0, "cache": c}))
    out["decode_step_elementwise_launches"] = elementwise_launches(
        lambda: step(params, {"token": tok, "pos": 0, "cache": c}))
    log(f"{tag} decode step: {out['profile_decode_step'].get('device_kernels')}"
        f" kernels, {out['decode_step_elementwise_launches'][act]} of them "
        f"{act}; busy {out['profile_decode_step'].get('busy_s')} s, idle "
        f"{out['profile_decode_step'].get('idle_share')}")
    del c
    if extra is not None:
        out.update(extra(cfg, model, params, prefill, prefill_plain, batch,
                         smodel, step))
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, model, smodel
    torch.cuda.empty_cache()

    # (d) cpu against cuda on the reduced config (float32, naive attention)
    rcfg = get_config(lm["arch"]).reduced(**lm.get("reduced", {}))
    rm_c, pre_c = make_prefill_step(rcfg, "cpu")
    rm_g, pre_g = make_prefill_step(rcfg, dev)
    _, step_c = make_serve_step(rcfg, "cpu")
    _, step_g = make_serve_step(rcfg, dev)
    rp_c = rm_c.init(lm["seed"])
    rp_g = _tree_to(rp_c, dev)
    rtoks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 12))
    rbatch = {"tokens": torch.from_numpy(rtoks), "cache_seq": 16}
    if encdec:
        rbatch["frames"] = encdec_frames(rcfg, 2, 1)
    FA.reset_launch_counts()
    lc, cc = pre_c(rp_c, rbatch)
    lg, cg = pre_g(rp_g, rbatch)
    check(FA.LAUNCHES["flash_attention"] == prefill_launches(rcfg),
          "reduced prefill on cuda: flash launches "
          f"{FA.LAUNCHES['flash_attention']} != {prefill_launches(rcfg)}")
    out["reduced_prefill_max_abs_err"] = float((lg.cpu() - lc).abs().max())
    pairs = [(cache_leaves(rcfg, cg)[n].cpu(), t)
             for n, t in cache_leaves(rcfg, cc).items()]
    out["reduced_cache_max_abs_err"] = max(float((g - c).abs().max())
                                           for g, c in pairs)
    check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
          and all(torch.allclose(g, c, atol=1e-4, rtol=1e-4)
                  for g, c in pairs),
          f"reduced prefill: cpu against cuda {out['reduced_prefill_max_abs_err']}")
    tc = decode_loop(rm_c, step_c, rp_c, rtoks, 6, 18)
    tg = decode_loop(rm_g, step_g, rp_g, rtoks, 6, 18)
    check(np.array_equal(tc, tg), "reduced decode: cpu tokens != cuda tokens")
    log(f"{tag} reduced {rcfg.name}: cpu == cuda (prefill logits max abs "
        f"err {out['reduced_prefill_max_abs_err']:.2e}, decode tokens equal)")
    log(f"{tag}: " + json.dumps({k: v for k, v in out.items()
                                  if k != "layer0_qkv"}))
    return out


def route_checks(dev, cfg, params, prefill, prefill_plain, batch,
                 lm: dict) -> dict:
    """Of an MoE prefill (phases moe and mla): the expert choices of the
    kernel and the plain route (the share of (token, slot) choices they
    agree on), the capacity drops by layer, and layer 0's routing counts
    over ``lm["groups"]`` groups of ``lm["group_tokens"]`` tokens placed by
    ``build_expert_placement`` at ``lm["placement_k"]`` (device_scan, device
    refine: one parsa_scan and one refine_sweep; the all-to-all crossing
    tokens reported, not gated)."""
    import numpy as np
    import torch

    from repro_torch.core.moe_placement import (
        alltoall_traffic, build_expert_placement)
    from repro_torch.kernels.parsa_cost import ops as PC
    from repro_torch.models import moe as MOE_

    tag = lm["phase"]
    out: dict = {}
    L, E, K = cfg.num_layers, cfg.num_experts, cfg.num_experts_per_tok
    B, S = batch["tokens"].shape
    T = B * S
    C = MOE_.capacity(cfg, T)
    # (a) the routes of the kernel and the plain prefill, and the drops
    with moe_routes([]) as kern:
        prefill(params, batch)
    with moe_routes([]) as plain:
        prefill_plain(params, batch)
    check(len(kern) == len(plain) == L, f"{len(kern)} MoE layers routed")
    agree = [float((a == b).float().mean()) for a, b in zip(kern, plain)]
    out["route_agreement"] = float(np.mean(agree))
    out["route_agreement_by_layer"] = agree
    counts = [torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, e.reshape(-1), torch.ones(T * K, dtype=torch.int64,
                                     device=dev)) for e in kern]
    out["capacity"] = C
    out["drops_by_layer"] = [int((c - C).clamp(min=0).sum())
                             for c in counts]
    out["expert_counts_layer0"] = counts[0].tolist()
    log(f"{tag} routes: kernel and plain prefill agree on "
        f"{out['route_agreement']:.6f} of (token, slot) choices "
        f"(by layer {[round(a, 6) for a in agree]}); C={C} at T={T}, "
        f"drops by layer {out['drops_by_layer']} of {T * K}")

    # expert placement from layer 0's routing over token groups
    ng, gt = lm["groups"], lm["group_tokens"]
    check(ng * gt == T, f"{ng} groups of {gt} tokens != T={T}")
    e0 = kern[0].reshape(ng, gt * K).cpu().numpy()
    rc = np.stack([np.bincount(g, minlength=E) for g in e0])
    PC.reset_launch_counts()
    t0 = time.perf_counter()
    pl = build_expert_placement(rc, lm["placement_k"],
                                backend="device_scan", device=dev,
                                refine_backend="device")
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in PC.LAUNCHES.items() if c}
    check(launches == {"parsa_scan": 1, "refine_sweep": 1},
          f"expert placement launches {launches}, want one parsa_scan "
          "and one refine_sweep")
    traffic = alltoall_traffic(rc, pl)
    out["placement"] = {
        "routing_counts_shape": list(rc.shape), "k": pl.k,
        "expert_to_shard": pl.expert_to_shard.tolist(),
        "launches": launches, "seconds": secs,
        "crossing_tokens_roundrobin": traffic[
            "crossing_tokens_roundrobin"],
        "crossing_tokens_parsa": traffic["crossing_tokens_parsa"],
        "reduction": traffic["reduction"]}
    log(f"{tag} placement of layer 0's {rc.shape} routing counts at k="
        f"{pl.k}: {launches} in {secs:.3f} s; all-to-all crossing "
        f"tokens round-robin {traffic['crossing_tokens_roundrobin']}, "
        f"Parsa {traffic['crossing_tokens_parsa']} (reduction "
        f"{traffic['reduction'] * 100:.2f}%, reported, not gated)")
    return out


def phase_moe(dev, moe: dict = MOE) -> dict:
    """The MoE serving path on the card (phase lm's checks on ``MOE``, and
    the MoE layer's, the ring cache's and the expert placement's); see the
    module docstring, item 11."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import layers as LL
    from repro_torch.models import moe as MOE_

    def checks(cfg, model, params, prefill, prefill_plain, batch, smodel,
               step) -> dict:
        out = route_checks(dev, cfg, params, prefill, prefill_plain, batch,
                           moe)
        K = cfg.num_experts_per_tok
        B, S = batch["tokens"].shape

        # (b) apply_moe makes no device-to-host sync, at decode's and at a
        # prefill slice's shape
        p0, dt = params["stack"][0], getattr(torch, cfg.dtype)
        for shape in ((moe["serve_batch"], 1), (B, min(S, 512))):
            with torch.no_grad():
                tok = batch["tokens"].reshape(-1)[:shape[0] * shape[1]]
                tok = tok.reshape(shape)
                h = LL.apply_norm(p0["ln2"], model._embed(params, tok),
                                  cfg.norm)
                want, _ = MOE_.apply_moe(p0["moe"], h, cfg, dtype=dt,
                                         return_aux=True)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got, info = MOE_.apply_moe(p0["moe"], h, cfg, dtype=dt,
                                               return_aux=True)
                except RuntimeError as err:
                    raise SmokeFailure(f"apply_moe at {shape} synchronised "
                                       f"with the host: {err}") from err
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            check(torch.equal(got, want), f"apply_moe at {shape}: two calls "
                  "differ")
            check(int(info["expert_counts"].sum()) == shape[0] * shape[1] * K,
                  "expert counts do not sum to T * K")
        out["apply_moe_host_syncs"] = 0
        log("moe: apply_moe at decode's (4, 1) and a (2, 512) slice made no "
            "device-to-host sync (set_sync_debug_mode error), two calls "
            "bitwise equal")

        # (c) the ring cache: the first layers of the same weights, the
        # window cut, against a full cache
        rcfg = dataclasses.replace(cfg, num_layers=moe["ring_layers"],
                                   swa_window=moe["ring_window"])
        rparams = dict(params, stack=params["stack"][:moe["ring_layers"]])
        rmodel, rstep = make_serve_step(rcfg, dev)
        W, n = moe["ring_window"], moe["ring_steps"]
        toks = torch.from_numpy(np.random.default_rng(moe["seed"] + 1)
                                .integers(0, cfg.vocab_size, (n, 1, 1))
                                ).to(dev)

        def decode(cache, pins=None, tally=None):
            """n teacher-forced steps: (next tokens, logits, cache, the
            expert ids of every layer and step)."""
            nxt, logits = [], []
            t0 = time.perf_counter()
            with moe_routes([], pins, tally) as ids:
                for t in range(n):
                    nt, lt, cache = rstep(rparams, {"token": toks[t],
                                                    "pos": t, "cache": cache})
                    nxt.append(nt)
                    logits.append(lt)
            return nxt, logits, cache, ids, time.perf_counter() - t0

        nf, lf, _, full_ids, full_s = decode(rmodel.init_cache(1, n))
        nr, lr_, ring, _, ring_s = decode(rmodel.init_cache(1, W, ring=True))
        tally: dict = {}
        npin, lpin, ring_p, _, _ = decode(rmodel.init_cache(1, W, ring=True),
                                          full_ids, tally)
        for t in range(n):
            check(bool(torch.isfinite(lr_[t]).all()), f"ring step {t}: not "
                  "finite")
        own = [rel_l2(a, b) for a, b in zip(lr_, lf)]
        rel = [rel_l2(a, b) for a, b in zip(lpin, lf)]
        # slot j holds the last position p < n with p % W == j
        want_kpos = torch.tensor([j + W * ((n - 1 - j) // W)
                                  for j in range(W)], dtype=torch.int32)
        check(all(torch.equal(c["kpos"][l].cpu(), want_kpos)
                  for c in (ring, ring_p) for l in range(rcfg.num_layers)),
              f"ring kpos {ring['kpos'][0].tolist()[:8]}...")
        out["ring"] = {
            "layers": rcfg.num_layers, "window": W, "steps": n,
            "max_rel_l2": max(rel), "mean_rel_l2": float(np.mean(rel)),
            "argmax_agreement": sum(map(torch.equal, npin, nf)) / n,
            "route_flips": tally,
            "own_routes_max_rel_l2": max(own),
            "own_routes_mean_rel_l2": float(np.mean(own)),
            "own_routes_argmax_agreement": sum(map(torch.equal, nr, nf)) / n,
            "full_s": full_s, "ring_s": ring_s}
        check(max(rel) <= LM_MAX_REL_L2,
              f"ring cache against full cache: relative L2 {max(rel):.3e} at "
              f"step {int(np.argmax(rel))} > {LM_MAX_REL_L2}")
        r = out["ring"]
        log(f"moe ring: {n} steps through {W} ring slots ({rcfg.num_layers} "
            f"layers, window {W}) against a {n}-slot cache, with the full "
            f"cache's expert choices: logits relative L2 max {max(rel):.3e}, "
            f"mean {r['mean_rel_l2']:.3e}, argmax equal on "
            f"{r['argmax_agreement'] * n:.0f}/{n} steps; on its own routes "
            f"({tally['flips']} of {tally['choices']} choices differ) max "
            f"{max(own):.3e}, mean {r['own_routes_mean_rel_l2']:.3e}, argmax "
            f"{r['own_routes_argmax_agreement'] * n:.0f}/{n}; {ring_s:.2f} s "
            f"ring, {full_s:.2f} s full")
        del ring, ring_p, rparams, lf, lr_, lpin, full_ids
        return out

    return phase_lm(dev, moe, extra=checks)


# ---------------------------------------------------------------- moe_ep
def tree_digest(tree) -> str:
    """A hash of every tensor's bytes of a tree, in its order."""
    import hashlib

    import torch

    from repro_torch.tree import tree_leaves

    h = hashlib.blake2b(digest_size=16)
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


MOE_EP_CALLS = threading.local()


@contextlib.contextmanager
def moe_call_spy():
    """Keep the branch and gathered bytes of every sharded MoE call in the
    calling thread's ``MOE_EP_CALLS.calls`` (the emulation's places are
    threads of one process)."""
    from repro_torch.models import moe as MOE_

    orig = MOE_._routed_sharded

    def spy(*a, info=None, **kw):
        d = {}
        y = orig(*a, info=d, **kw)
        MOE_EP_CALLS.calls.append(d)
        return y

    MOE_._routed_sharded = spy
    try:
        yield
    finally:
        MOE_._routed_sharded = orig


def moe_ep_program(dev, mesh, full=None, timers: dict | None = None) -> dict:
    """Phase moe_ep's work on one place of ``mesh`` (a rank, or a place of
    ``emulate_mesh``): mixtral-8x22b x 1 layer from SEED (``full``, the
    whole parameter tree, or drawn here), cut to its blocks
    (``shard_params``: its experts over both axes; with the config's
    fsdp=True its embed, attention and router over the data axis too,
    gathered a layer at a time in every prefill and decode step; its
    attention heads and vocab rows over the model axis); the token-path
    and the weight-path prefills at the config's capacity factor, the
    token-path prefill again at MOE_EP's no-drop factor, and decode.
    Returns the place's rows: logits, a digest of each cache, the global
    tokens, the branch and gathered bytes of every MoE call (under
    ``moe_call_spy``), the bytes and gathers of every prefill and decode
    step by kind (``launch.mesh.GATHERED``: the FSDP gathers apart), the
    flash and silu launches, the seconds."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import axis_group, gather_stack
    from repro_torch.launch.sharding import activation_rules, shard_params
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    def gathered():
        return np.asarray([M.GATHERED[k] for k in MOE_EP_GATHERED])

    cfg = dataclasses.replace(get_config(MOE_EP["arch"]),
                              num_layers=MOE_EP["num_layers"])
    if full is None:
        full = build_model(cfg, dev).init(MOE_EP["seed"])
    params = shard_params(cfg, full, mesh)
    del full
    rng = np.random.default_rng(MOE_EP["seed"])
    out = {}
    calls = MOE_EP_CALLS.calls = []

    def sync_s(t0):
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    FA.reset_launch_counts()
    EW.reset_launch_counts()
    # the token path's prompt is the one phase_moe_ep's no-mesh runs
    # take (the first draw), at both capacity factors
    prompts = {n: rng.integers(0, cfg.vocab_size, MOE_EP[n],
                               dtype=np.int32) for n in ("token", "weight")}
    for name in ("token", "weight", "no_drop"):
        tokens = prompts["weight" if name == "weight" else "token"]
        B, S = tokens.shape
        c = (cfg if name != "no_drop" else dataclasses.replace(
            cfg, moe_capacity_factor=MOE_EP["no_drop"]))
        _, prefill = make_prefill_step(c, dev, mesh=mesh)
        n0 = len(calls)
        M.reset_gathered()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens,
                                         "cache_seq": S})
        out[f"{name}/prefill_s"] = np.float64(sync_s(t0))
        out[f"{name}/mesh_gathered"] = gathered()
        out[f"{name}/logits"] = logits.float().cpu().numpy()
        out[f"{name}/cache"] = np.asarray(tree_digest(cache))
        out[f"{name}/calls"] = np.asarray(json.dumps(calls[n0:]))
        del logits, cache
        torch.cuda.empty_cache()
    B, P, steps = MOE_EP["decode"]
    tokens = rng.integers(0, cfg.vocab_size, (B, P), dtype=np.int32)
    _, prefill = make_prefill_step(cfg, dev, mesh=mesh)
    _, serve = make_serve_step(cfg, dev, mesh=mesh)
    n0 = len(calls)
    logits, cache = prefill(params, {"tokens": tokens,
                                     "cache_seq": P + steps})
    ax = activation_rules(cfg, mesh, B)["batch"]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    tok = gather_stack(tok, axis_group(mesh, ax)).reshape(-1)
    toks, step_s, step_logits = [tok.cpu().numpy()], [], []
    step_gathered = []
    for i in range(steps):
        M.reset_gathered()
        t0 = time.perf_counter()
        tok, lg, cache = serve(params, {"token": tok[:, None],
                                        "pos": P + i, "cache": cache})
        step_s.append(sync_s(t0))
        step_gathered.append(gathered())
        toks.append(tok.cpu().numpy())
        step_logits.append(lg.float().cpu().numpy())
    out["decode/tokens"] = np.stack(toks)
    out["decode/logits"] = np.stack(step_logits)
    out["decode/cache"] = np.asarray(tree_digest(cache))
    out["decode/calls"] = np.asarray(json.dumps(calls[n0:]))
    out["decode/step_s"] = np.asarray(step_s)
    out["decode/mesh_gathered"] = np.stack(step_gathered)
    out["launches"] = np.asarray(json.dumps(
        {**dict(FA.LAUNCHES), **dict(EW.LAUNCHES)}))
    if timers is not None:
        out["gather_ms"] = np.asarray(timers.get("gather_ms", []))
        out["sum_ms"] = np.asarray(timers.get("sum_ms", []))
    return out


def moe_ep_rank(rank: int, world: int, backend: str, store: str,
                out_dir: str, device: str) -> None:
    """One rank of phase moe_ep (started with spawn): a group over
    ``store``, a (2, 2) ``DeviceMesh`` (device type cpu on gloo: the mesh
    only holds the groups, and a gloo group copies card tensors through
    host memory), ``moe_ep_program`` with its gathers and sums timed; its
    arrays and peak memory go to ``rank<r>.npz``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import mesh as M

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            MOE_EP["mesh"], mesh_dim_names=("data", "model"))
    timers = {"gather_ms": [], "sum_ms": []}
    gather, osum = M.gather_stack, M.ordered_sum

    def timed(fn, into):
        def run(*a):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            y = fn(*a)
            torch.cuda.synchronize(dev)
            into.append((time.perf_counter() - t0) * 1e3)
            return y
        return run

    M.gather_stack = timed(gather, timers["gather_ms"])
    M.ordered_sum = timed(osum, timers["sum_ms"])
    try:
        with moe_call_spy():
            out = moe_ep_program(dev, mesh, timers=timers)
        dist.barrier()
    finally:
        M.gather_stack, M.ordered_sum = gather, osum
        dist.destroy_process_group()
    out["peak_gb"] = np.float64(torch.cuda.max_memory_allocated(dev) / 1e9)
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def hold_moe_ep_ranks(ranks: list[dict], emu: list[dict], what: str) -> None:
    """Every rank against its place of the emulation, bit for bit (logits,
    cache digests, tokens, branches and bytes, launches); the ranks'
    tokens against each other."""
    import numpy as np

    # launches and GATHERED are not compared: the emulation's places share
    # the counts
    skip = ("prefill_s", "step_s", "gather_ms", "sum_ms", "peak_gb",
            "launches", "mesh_gathered")
    for r, (got, want) in enumerate(zip(ranks, emu)):
        for k, v in want.items():
            if k.endswith(skip):
                continue
            check(np.array_equal(got[k], v),
                  f"{what} rank {r}: {k} differs from the emulation")
        check(np.array_equal(got["decode/tokens"], ranks[0]["decode/tokens"]),
              f"{what}: rank {r}'s tokens differ from rank 0's")


def phase_moe_ep(dev, ep: dict = MOE_EP) -> dict:
    """The MoE family over a (data x model) mesh (``models.moe``'s sharded
    route, ``launch.sharding``, ``launch.steps`` with ``mesh=``): (a) a
    real NCCL group of one rank in this process, mesh (1, 1), equal to the
    no-mesh route; (b) 4 gloo ranks on this card, mesh (2, 2), each equal
    to its place of the in-process emulation (``launch.mesh.emulate_mesh``)
    bit for bit, the no-drop prefill within LM_MAX_REL_L2 of the no-mesh
    route; (c) 4 NCCL ranks, one card each, where 4 cards are visible."""
    import dataclasses
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import emulate_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import build_model

    out = {}
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ep["arch"]),
                              num_layers=ep["num_layers"])
    torch.cuda.reset_peak_memory_stats(dev)
    full = build_model(cfg, dev).init(ep["seed"])
    B, S = ep["token"]
    tokens = np.random.default_rng(ep["seed"]).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)

    def no_mesh(c):
        _, prefill = make_prefill_step(c, dev)
        return prefill(full, {"tokens": tokens, "cache_seq": S})

    # (a) NCCL at world size 1, mesh (1, 1): tp = 1, the local route
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp.name}/store_moe1", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S),
        device_id=dev)
    try:
        mesh1 = init_device_mesh("cuda", (1, 1),
                                 mesh_dim_names=("data", "model"))
        _, prefill1 = make_prefill_step(cfg, dev, mesh=mesh1)
        l1, c1 = prefill1(full, {"tokens": tokens, "cache_seq": S})
    finally:
        dist.destroy_process_group()
    l0, c0 = no_mesh(cfg)
    check(torch.equal(l1, l0) and all(torch.equal(c1[k], c0[k]) for k in c0),
          "moe_ep nccl x1: the (1, 1) mesh differs from the no-mesh route")
    base_logits = l0.float()
    del l1, c1, c0, l0
    ln, _ = no_mesh(dataclasses.replace(cfg, moe_capacity_factor=ep["no_drop"]))
    nodrop_logits = ln.float()
    del ln
    torch.cuda.empty_cache()
    log(f"moe_ep nccl x1: mesh (1, 1) prefill B={B} S={S} equals the "
        f"no-mesh route bit for bit (logits, k, v) "
        f"({time.perf_counter() - t0:.2f} s with the no-mesh runs)")

    # (b) 4 gloo ranks on this card, mesh (2, 2)
    t0 = time.perf_counter()
    world = ep["mesh"][0] * ep["mesh"][1]
    ranks = run_ranks(moe_ep_rank, world, "gloo",
                      pathlib.Path(tmp.name) / f"moe_ep_gloo{world}",
                      lambda r: str(dev), MOE_EP_DEADLINE_S, "moe_ep")
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sizes = dict(zip(("data", "model"), ep["mesh"]))
    with moe_call_spy():
        emu = emulate_mesh(sizes, lambda m: moe_ep_program(dev, m, full))
    emu_s = time.perf_counter() - t0
    hold_moe_ep_ranks(ranks, emu, "moe_ep gloo x4")
    del emu
    torch.cuda.empty_cache()
    # the rows of each batch block against the no-mesh route, at the no-drop
    # factor (gated) and the config's (reported)
    m = ep["mesh"][1]
    dist_l2 = {}
    for name, ref in (("no_drop", nodrop_logits), ("token", base_logits)):
        got = np.concatenate([ranks[r][f"{name}/logits"]
                              for r in range(0, len(ranks), m)])
        dist_l2[name] = rel_l2(torch.from_numpy(got), ref.cpu())
    check(dist_l2["no_drop"] <= LM_MAX_REL_L2,
          f"moe_ep: no-drop logits {dist_l2['no_drop']:.3e} from the "
          f"no-mesh route, past {LM_MAX_REL_L2}")
    branches = {n: sorted({c["branch"] for c in json.loads(
        str(ranks[0][f"{n}/calls"]))}) for n in ("token", "weight", "decode")}
    check(branches == {"token": ["expert/token"],
                       "weight": ["expert/weight"],
                       "decode": ["expert/token"]},
          f"moe_ep: branches {branches}")
    per_rank = []
    for r, got in enumerate(ranks):
        gathered = {n: sum(c["gathered_bytes"] for c in json.loads(
            str(got[f"{n}/calls"]))) for n in ("token", "weight", "decode")}
        mesh_gathered = {
            **{n: dict(zip(MOE_EP_GATHERED, map(int, got[
                f"{n}/mesh_gathered"]))) for n in ("token", "weight",
                                                  "no_drop")},
            "decode_a_step": [dict(zip(MOE_EP_GATHERED, map(int, g)))
                              for g in got["decode/mesh_gathered"]]}
        row = {"peak_gb": float(got["peak_gb"]),
               "prefill_s": {n: float(got[f"{n}/prefill_s"])
                             for n in ("token", "weight", "no_drop")},
               "decode_p50_ms": statistics.median(
                   got["decode/step_s"].tolist()) * 1e3,
               "gathered_bytes": gathered,
               "mesh_gathered": mesh_gathered,
               "gather_ms": [float(x) for x in got["gather_ms"]],
               "sum_ms": [float(x) for x in got["sum_ms"]],
               "launches": json.loads(str(got["launches"]))}
        per_rank.append(row)
        log(f"moe_ep gloo x4 rank {r}: prefill token "
            f"{row['prefill_s']['token']:.2f} s, weight "
            f"{row['prefill_s']['weight']:.2f} s; decode p50 "
            f"{row['decode_p50_ms']:.1f} ms; peak {row['peak_gb']:.1f} GB")
        log(f"moe_ep gloo x4 rank {r}: gathered {json.dumps(gathered)} B")
        log(f"moe_ep gloo x4 rank {r}: every gather by kind, a prefill and "
            f"a decode step (the FSDP gathers apart) "
            f"{json.dumps(mesh_gathered)}")
        log(f"moe_ep gloo x4 rank {r}: gather {spread(row['gather_ms'])}")
        log(f"moe_ep gloo x4 rank {r}: sum {spread(row['sum_ms'])}")
        log(f"moe_ep gloo x4 rank {r}: launches {json.dumps(row['launches'])}")
    for r, row in enumerate(per_rank):
        check(row["launches"].get("flash_attention", 0) > 0
              and row["launches"].get("silu_stepwise", 0) > 0,
              f"moe_ep: rank {r}'s launches {row['launches']}")
    out["gloo4"] = {"per_rank": per_rank, "branches": branches,
                    "rel_l2_no_drop": dist_l2["no_drop"],
                    "rel_l2_config_capacity": dist_l2["token"],
                    "ranks_s": ranks_s, "emulation_s": emu_s}
    out["launches"] = per_rank[0]["launches"]
    log(f"moe_ep gloo x4 on one card: mesh {ep['mesh']}, every rank equals "
        f"its place of the emulation bit for bit (prefill logits and caches "
        f"at B={B} S={S} on the token path and B={ep['weight'][0]} "
        f"S={ep['weight'][1]} on the weight path, {ep['decode'][2]} decode "
        f"steps at batch {ep['decode'][0]}, tokens equal on every rank); "
        f"branches {json.dumps(branches)}; no-drop logits rel L2 "
        f"{dist_l2['no_drop']:.3e} from the no-mesh route (gate "
        f"{LM_MAX_REL_L2}), at capacity factor {cfg.moe_capacity_factor} "
        f"{dist_l2['token']:.3e} (reported); ranks {ranks_s:.2f} s, "
        f"emulation {emu_s:.2f} s")

    # (c) 4 NCCL ranks, one card each
    n_cards = torch.cuda.device_count()
    if n_cards >= world:
        t0 = time.perf_counter()
        nranks = run_ranks(moe_ep_rank, world, "nccl",
                           pathlib.Path(tmp.name) / f"moe_ep_nccl{world}",
                           lambda r: f"cuda:{r}", MOE_EP_DEADLINE_S,
                           "moe_ep")
        for r, got in enumerate(nranks):
            for k in ("token/logits", "weight/logits", "decode/tokens",
                      "token/cache", "weight/cache", "decode/cache"):
                check(np.array_equal(got[k], ranks[r][k]),
                      f"moe_ep nccl x{world} rank {r}: {k} differs from gloo")
        out[f"nccl{world}"] = {"seconds": time.perf_counter() - t0}
    else:
        log(f"moe_ep nccl x{world}: not run ({n_cards} card(s) visible)")
    del full
    torch.cuda.empty_cache()
    tmp.cleanup()
    out["peak_gb_parent"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["seconds"] = time.perf_counter() - t_phase
    return out


TP_CALLS = threading.local()


@contextlib.contextmanager
def flash_spy():
    """Keep the shape and query offset of every flash launch that
    ``models.layers`` makes in the calling thread's ``TP_CALLS.flash``
    (B, Sq, Skv, H, KV, D, causal, q_offset), when the thread set one."""
    from repro_torch.models import layers as LL_

    orig = LL_.flash_attention

    def spy(q, k, v, **kw):
        calls = getattr(TP_CALLS, "flash", None)
        if calls is not None:
            calls.append([*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                          q.shape[3], bool(kw.get("causal", True)),
                          int(kw.get("q_offset", 0))])
        return orig(q, k, v, **kw)

    LL_.flash_attention = spy
    try:
        yield
    finally:
        LL_.flash_attention = orig


def rank_start(dev, params) -> dict:
    """A rank's weights and its peak so far (the tree drawn and cut); the
    peak and the kernels' launch counts restart here."""
    import numpy as np
    import torch

    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    out = {"params_gb": np.float64(sum(
        t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9),
        "peak_gb_init": np.float64(torch.cuda.max_memory_allocated(dev)
                                   / 1e9)}
    torch.cuda.reset_peak_memory_stats(dev)
    FA.reset_launch_counts()
    EW.reset_launch_counts()
    return out


def rank_end(dev) -> dict:
    """A rank's kernel launches and peak since ``rank_start``, and the card's
    memory in use (every process's)."""
    import numpy as np
    import torch

    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA

    free, total = torch.cuda.mem_get_info(dev)
    return {"launches": np.asarray(json.dumps(
        {**dict(FA.LAUNCHES), **dict(EW.LAUNCHES)})),
        "peak_gb": np.float64(torch.cuda.max_memory_allocated(dev) / 1e9),
        "card_used_gb": np.float64((total - free) / 1e9)}


def draw_blocks(cfg, dev, mesh, seed: int, full=None, master=False):
    """The place's blocks (``shard_params``) of ``cfg``'s model drawn from
    ``seed`` (float32 masters with ``master``): cut from ``full`` where it
    is given (an emulated place), else drawn on the card a leaf at a time
    and cut right after each draw (``Model.init(keep=)``: the same blocks
    bit for bit), a rank's peak its blocks and one whole leaf.  The ranks
    of a phase draw at once: the largest draw, phase train_tp (d)'s, is
    4 x 11.5 GB."""
    from repro_torch.launch.sharding import keep_blocks, shard_params
    from repro_torch.models.model import build_model

    if full is not None:
        return shard_params(cfg, full, mesh)
    return build_model(cfg, dev).init(seed, master=master,
                                      keep=keep_blocks(cfg, mesh))


def tp_program(dev, mesh, spec: dict, full=None, rank: bool = False) -> dict:
    """Phase tp's work on one place of ``mesh`` (a rank, or a place of
    ``emulate_mesh``): ``spec``'s model from its seed (``full``, the whole
    tree, or drawn here), cut to the place's blocks (``shard_params``);
    the prefill at ``spec["prefill"]`` and, with ``spec["decode"]``, a
    prompt's prefill and greedy decode steps.  Returns the place's rows:
    logits, cache digests, the global tokens, its flash launches' shapes
    and offsets (under ``flash_spy``), and on a rank (``rank=True``) the
    bytes it gathered (``launch.mesh.GATHERED``), seconds, launches and
    peak memory after the cut."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.sharding import activation_rules
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_config(spec["arch"]),
                              num_layers=spec["num_layers"])
    params = draw_blocks(cfg, dev, mesh, spec["seed"], full)
    del full
    out = {}
    if rank:
        out.update(rank_start(dev, params))
    TP_CALLS.flash = []
    rng = np.random.default_rng(spec["seed"])
    B, S = spec["prefill"]
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    _, prefill = make_prefill_step(cfg, dev, mesh=mesh)
    ax = activation_rules(cfg, mesh, B)["batch"]

    def global_tokens(logits):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return M.gather_stack(tok, M.axis_group(mesh, ax)).reshape(-1) \
            if ax is not None else tok

    def sync_s(t0):
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    M.reset_gathered()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens, "cache_seq": S})
    out["prefill_s"] = np.float64(sync_s(t0))
    out["prefill/gathered"] = np.int64(M.GATHERED["bytes"])
    out["prefill/gathers"] = np.int64(M.GATHERED["calls"])
    out["prefill/logits"] = logits.float().cpu().numpy()
    out["prefill/cache"] = np.asarray(tree_digest(cache))
    out["prefill/tokens"] = global_tokens(logits).cpu().numpy()
    out["prefill/flash"] = np.asarray(json.dumps(TP_CALLS.flash))
    del logits, cache
    torch.cuda.empty_cache()
    if spec["decode"]:
        Bd, P, steps = spec["decode"]
        prompt = rng.integers(0, cfg.vocab_size, (Bd, P), dtype=np.int32)
        _, serve = make_serve_step(cfg, dev, mesh=mesh)
        ax = activation_rules(cfg, mesh, Bd)["batch"]
        logits, cache = prefill(params, {"tokens": prompt,
                                         "cache_seq": P + steps})
        tok = global_tokens(logits)
        toks, step_s, step_logits = [tok.cpu().numpy()], [], []
        M.reset_gathered()
        for i in range(steps):
            t0 = time.perf_counter()
            tok, lg, cache = serve(params, {"token": tok[:, None],
                                            "pos": P + i, "cache": cache})
            step_s.append(sync_s(t0))
            toks.append(tok.cpu().numpy())
            step_logits.append(lg.float().cpu().numpy())
        out["decode/gathered_a_step"] = np.int64(M.GATHERED["bytes"] // steps)
        out["decode/gathers_a_step"] = np.int64(M.GATHERED["calls"] // steps)
        out["decode/tokens"] = np.stack(toks)
        out["decode/logits"] = np.stack(step_logits)
        out["decode/cache"] = np.asarray(tree_digest(cache))
        out["decode/step_s"] = np.asarray(step_s)
        del logits, cache
    if rank:
        out.update(rank_end(dev))
    return out


def recurrent_program(dev, mesh, spec: dict, full=None,
                      rank: bool = False) -> dict:
    """Phase tp_all's work on one place of ``mesh`` for a recurrent family
    (xlstm, hybrid): ``spec``'s model from its seed cut to the place's
    blocks (``draw_blocks``); the prefill step's loss over the global batch
    at ``spec["loss"]`` (next-token labels of random tokens); then
    ``Model.init_cache`` under the rules (the place's block of zero
    states), the serve step over a prompt (teacher forced) and greedy
    steps (``spec["decode"]``).  The keys of ``tp_program`` (the loss as
    ``prefill/loss``, its seconds as ``prefill_s``); the decode's logits,
    times and gathers are the greedy steps'."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.sharding import (
        activation_rules,
        batch_rows,
        mesh_rules,
    )
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_config(spec["arch"]),
                              num_layers=spec["num_layers"])
    params = draw_blocks(cfg, dev, mesh, spec["seed"], full)
    del full
    out = {}
    if rank:
        out.update(rank_start(dev, params))
    TP_CALLS.flash = []
    rng = np.random.default_rng(spec["seed"])
    B, S = spec["loss"]
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    model, prefill = make_prefill_step(cfg, dev, mesh=mesh)

    def sync_s(t0):
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    M.reset_gathered()
    t0 = time.perf_counter()
    loss = prefill(params, {"tokens": tokens[:, :-1],
                            "labels": tokens[:, 1:]})
    out["prefill_s"] = np.float64(sync_s(t0))
    out["prefill/gathered"] = np.int64(M.GATHERED["bytes"])
    out["prefill/gathers"] = np.int64(M.GATHERED["calls"])
    out["prefill/loss"] = loss.float().cpu().numpy()
    out["prefill/flash"] = np.asarray(json.dumps(TP_CALLS.flash))
    torch.cuda.empty_cache()
    Bd, P, steps = spec["decode"]
    prompt = rng.integers(0, cfg.vocab_size, (Bd, P), dtype=np.int32)
    _, serve = make_serve_step(cfg, dev, mesh=mesh)
    rows = batch_rows(mesh, activation_rules(cfg, mesh, Bd), Bd)
    with mesh_rules(cfg, mesh, Bd):
        cache = model.init_cache(len(range(Bd)[rows]), P + steps)
    for i in range(P):
        tok, _, cache = serve(params, {"token": torch.as_tensor(
            prompt[:, i:i + 1], device=dev), "pos": i, "cache": cache})
    toks, step_s, step_logits = [tok.cpu().numpy()], [], []
    M.reset_gathered()
    for i in range(steps):
        t0 = time.perf_counter()
        tok, lg, cache = serve(params, {"token": tok[:, None], "pos": P + i,
                                        "cache": cache})
        step_s.append(sync_s(t0))
        toks.append(tok.cpu().numpy())
        step_logits.append(lg.float().cpu().numpy())
    out["decode/gathered_a_step"] = np.int64(M.GATHERED["bytes"] // steps)
    out["decode/gathers_a_step"] = np.int64(M.GATHERED["calls"] // steps)
    out["decode/tokens"] = np.stack(toks)
    out["decode/logits"] = np.stack(step_logits)
    out["decode/cache"] = np.asarray(tree_digest(cache))
    out["decode/step_s"] = np.asarray(step_s)
    if rank:
        out.update(rank_end(dev))
    return out


def tp_rank(rank: int, world: int, backend: str, store: str, out_dir: str,
            device: str, parts: dict) -> None:
    """One gloo rank of phases tp and tp_all (started with spawn): a group
    over ``store``; for each part of ``parts`` ({tag: spec}) in order, a
    ``DeviceMesh`` of ``spec["mesh"]`` (device type cpu: the mesh only
    holds the groups, and gloo copies card tensors through host memory)
    and ``tp_program``, or ``recurrent_program`` for a recurrent family,
    with every gather timed; its arrays go to ``rank<r>.npz``, each key
    under its part's tag."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S))
    gather_ms = []
    gather = M.gather_stack

    def timed(*a):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = gather(*a)
        torch.cuda.synchronize(dev)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        return y

    M.gather_stack = timed
    out = {}
    try:
        for tag, spec in parts.items():
            mesh = init_device_mesh("cpu", spec["mesh"],
                                    mesh_dim_names=("data", "model"))
            family = get_config(spec["arch"]).family
            program = (recurrent_program if family in ("xlstm", "hybrid")
                       else tp_program)
            gather_ms.clear()
            with flash_spy():
                got = program(dev, mesh, spec, rank=True)
            got["gather_ms"] = np.asarray(gather_ms)
            out.update({f"{tag}/{k}": v for k, v in got.items()})
            del got
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        M.gather_stack = gather
        dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def tp_all_emulation(rank: int, world: int, backend: str, store: str,
                     out_dir: str, device: str, parts: dict) -> None:
    """Phase tp_all's in-process emulation of its parts, in a process of
    its own (started with spawn, one of it): for each part of ``parts``
    ({tag: spec}) its tree drawn whole from its seed and every place of
    its mesh a thread (``emulate_mesh``); each place's arrays go to
    ``rank0.npz`` under ``<tag>/<place>/``.  A process of its own keeps
    the emulated places' launches (about 10⁶: four places' sLSTM and
    decode loops) out of the script's process, whose profile windows come
    later (phase times)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import emulate_mesh
    from repro_torch.models.model import build_model

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    out = {}
    for tag, spec in parts.items():
        cfg = dataclasses.replace(get_config(spec["arch"]),
                                  num_layers=spec["num_layers"])
        full = build_model(cfg, dev).init(spec["seed"])
        program = (recurrent_program if cfg.family in ("xlstm", "hybrid")
                   else tp_program)
        t0 = time.perf_counter()
        with flash_spy():
            emu = emulate_mesh(dict(zip(("data", "model"), spec["mesh"])),
                               lambda m: program(dev, m, spec, full))
        out[f"{tag}/seconds"] = np.float64(time.perf_counter() - t0)
        out.update({f"{tag}/{p}/{k}": v for p, e in enumerate(emu)
                    for k, v in e.items()})
        del full, emu
        torch.cuda.empty_cache()
    np.savez(pathlib.Path(out_dir) / "rank0.npz", **out)


def part_of(ranks: list[dict], tag: str) -> list[dict]:
    """Each rank's arrays of one part of ``tp_rank``'s ``parts``."""
    return [{k[len(tag) + 1:]: v for k, v in r.items()
             if k.startswith(tag + "/")} for r in ranks]


def hold_tp(ranks: list[dict], emu: list[dict], ref_logits, spec: dict,
            what: str) -> dict:
    """Every rank against its place of the emulation, bit for bit (logits,
    losses, cache digests, tokens, flash shapes); the tokens equal on every
    rank; the prefill logits (the batch rows of the model axis's first
    places), or the recurrent families' loss (the same on every rank),
    within LM_MAX_REL_L2 of the no-mesh route's ``ref_logits``."""
    import numpy as np
    import torch

    skip = ("_s", "gathered", "gathers", "gathers_a_step",
            "gathered_a_step", "launches", "peak_gb", "peak_gb_init",
            "params_gb", "gather_ms", "card_used_gb")
    for r, (got, want) in enumerate(zip(ranks, emu)):
        for k, v in want.items():
            if k.endswith(skip):
                continue
            check(np.array_equal(got[k], v),
                  f"{what} rank {r}: {k} differs from the emulation")
        for k in ("prefill/tokens", "decode/tokens"):
            if k in got:
                check(np.array_equal(got[k], ranks[0][k]),
                      f"{what}: rank {r}'s {k} differ from rank 0's")
    m = spec["mesh"][1]
    if "prefill/loss" in ranks[0]:
        # the recurrent families: the global loss, on every rank
        got = torch.from_numpy(ranks[0]["prefill/loss"]).reshape(1)
        for r in range(len(ranks)):
            check(np.array_equal(ranks[r]["prefill/loss"],
                                 ranks[0]["prefill/loss"]),
                  f"{what}: rank {r}'s loss differs from rank 0's")
    else:
        got = torch.from_numpy(np.concatenate(
            [ranks[r]["prefill/logits"] for r in range(0, len(ranks), m)]))
    l2 = rel_l2(got, ref_logits.float().cpu().reshape(got.shape))
    check(l2 <= LM_MAX_REL_L2, f"{what}: prefill {l2:.3e} from the "
          f"no-mesh route, past {LM_MAX_REL_L2}")
    return {"rel_l2_no_mesh": l2}


def tp_report(ranks: list[dict], what: str) -> list[dict]:
    """Each rank's bytes gathered a call, prefill seconds, decode p50 /
    p99, peak memory, gather times and flash launches by shape, logged
    and returned."""
    rows = []
    for r, got in enumerate(ranks):
        flash: dict = {}
        for c in json.loads(str(got["prefill/flash"])):
            key = (f"B={c[0]} Sq={c[1]} Skv={c[2]} {c[3]}/{c[4]}x{c[5]} "
                   f"{'causal' if c[6] else 'non-causal'} q_offset={c[7]}")
            flash[key] = flash.get(key, 0) + 1
        row = {"prefill_s": float(got["prefill_s"]),
               "prefill_gathered_bytes": int(got["prefill/gathered"]),
               "prefill_gathers": int(got["prefill/gathers"]),
               "params_gb": float(got["params_gb"]),
               "peak_gb": float(got["peak_gb"]),
               "peak_gb_init": float(got["peak_gb_init"]),
               "gather_ms": spread(got["gather_ms"].tolist()),
               "prefill_flash_by_shape": flash,
               "launches": json.loads(str(got["launches"]))}
        if "decode/step_s" in got:
            ms = sorted(x * 1e3 for x in got["decode/step_s"].tolist())
            row.update(decode_p50_ms=statistics.median(ms),
                       decode_p99_ms=ms[min(len(ms) - 1,
                                            int(0.99 * len(ms)))],
                       decode_gathered_bytes_a_step=int(
                           got["decode/gathered_a_step"]),
                       decode_gathers_a_step=int(got["decode/gathers_a_step"]))
        rows.append(row)
        log(f"{what} rank {r}: gathered {row['prefill_gathered_bytes']:,} B "
            f"in {row['prefill_gathers']} gathers a prefill"
            + (f", {row['decode_gathered_bytes_a_step']:,} B in "
               f"{row['decode_gathers_a_step']} a decode step"
               if "decode_p50_ms" in row else "")
            + f"; prefill {row['prefill_s']:.3f} s"
            + (f"; decode p50 {row['decode_p50_ms']:.1f} ms, p99 "
               f"{row['decode_p99_ms']:.1f} ms" if "decode_p50_ms" in row
               else "")
            + f"; holds {row['params_gb']:.2f} GB of weights, peak "
            f"{row['peak_gb']:.2f} GB after the cut ({row['peak_gb_init']:.2f}"
            f" GB with the whole tree drawn at init)")
        log(f"{what} rank {r}: gathers {row['gather_ms']}; flash by shape "
            f"{json.dumps(flash)}; launches {json.dumps(row['launches'])}")
    return rows


def phase_tp(dev, tp: dict = TP, cp: dict = TP_CP) -> dict:
    """Dense tensor parallelism and context-parallel attention over a
    (data x model) mesh (``launch.steps`` with ``mesh=``, ``launch.
    sharding.shard_params``, ``models.layers``' tensor-parallel attention
    and MLP, ``models.model``'s vocab-sharded embedding and head): (a) 4
    gloo ranks on this card, qwen3-14b x 4 on mesh (1, 4), each rank's 10
    q heads and 2 kv heads; (b) the same model on mesh (1, 1) over one
    NCCL rank in this process, bit for bit the no-mesh route; (c) 3 gloo
    ranks, qwen3-14b x 2 on mesh (1, 3), context-parallel attention with
    flash's query offset.  (a) and (c) hold each rank to its place of the
    in-process emulation bit for bit and the prefill logits to the no-mesh
    route within LM_MAX_REL_L2."""
    import dataclasses
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import emulate_mesh
    from repro_torch.launch.sharding import shard_params
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    out = {"card": card_line()}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()

    def setup(spec):
        cfg = dataclasses.replace(get_config(spec["arch"]),
                                  num_layers=spec["num_layers"])
        full = build_model(cfg, dev).init(spec["seed"])
        B, S = spec["prefill"]
        tokens = np.random.default_rng(spec["seed"]).integers(
            0, cfg.vocab_size, (B, S), dtype=np.int32)
        _, prefill = make_prefill_step(cfg, dev)
        t0 = time.perf_counter()
        logits, cache = prefill(full, {"tokens": tokens, "cache_seq": S})
        torch.cuda.synchronize(dev)
        return cfg, full, tokens, logits, cache, time.perf_counter() - t0

    def mesh_part(spec, full, ref_logits, tag):
        t0 = time.perf_counter()
        world = spec["mesh"][0] * spec["mesh"][1]
        ranks = part_of(run_ranks(
            tp_rank, world, "gloo",
            pathlib.Path(tmp.name) / tag.replace(" ", "_"),
            lambda r: str(dev), TP_DEADLINE_S, "tp", {"tp": spec}), "tp")
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sizes = dict(zip(("data", "model"), spec["mesh"]))
        with flash_spy():
            emu = emulate_mesh(sizes, lambda m: tp_program(dev, m, spec,
                                                           full))
        emu_s = time.perf_counter() - t0
        held = hold_tp(ranks, emu, ref_logits, spec, tag)
        del emu
        torch.cuda.empty_cache()
        rows = tp_report(ranks, tag)
        for r, row in enumerate(rows):
            check(row["launches"].get("flash_attention", 0) > 0
                  and row["launches"].get("silu_stepwise", 0) > 0,
                  f"{tag}: rank {r}'s launches {row['launches']}")
        return {"per_rank": rows, "ranks_s": ranks_s, "emulation_s": emu_s,
                **held}

    # (a) and (b): qwen3-14b x 4 layers
    cfg, full, tokens, l0, c0, nomesh_s = setup(tp)
    B, S = tp["prefill"]
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp.name}/store_tp1", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S),
        device_id=dev)
    try:
        mesh1 = init_device_mesh("cuda", (1, 1),
                                 mesh_dim_names=("data", "model"))
        mine = shard_params(cfg, full, mesh1)
        _, prefill1 = make_prefill_step(cfg, dev, mesh=mesh1)
        _, serve1 = make_serve_step(cfg, dev, mesh=mesh1)
        _, serve0 = make_serve_step(cfg, dev)
        l1, c1 = prefill1(mine, {"tokens": tokens, "cache_seq": S + 1})
        tok = torch.argmax(l1, dim=-1).to(torch.int32)[:, None]
        c0b = {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], dim=2)
               for k, v in c0.items()}
        n1, d1, _ = serve1(mine, {"token": tok, "pos": S, "cache": c1})
        n0, d0, _ = serve0(full, {"token": tok, "pos": S, "cache": c0b})
    finally:
        dist.destroy_process_group()
    check(torch.equal(l1, l0) and all(torch.equal(c1[k][:, :, :S], c0[k])
                                      for k in c0)
          and torch.equal(d1, d0) and torch.equal(n1, n0),
          "tp nccl x1: the (1, 1) mesh differs from the no-mesh route")
    out["nccl1"] = {"seconds": time.perf_counter() - t0}
    log(f"tp nccl x1: {cfg.name} x{cfg.num_layers} on mesh (1, 1), prefill "
        f"B={B} S={S} and a decode step equal the no-mesh route bit for bit "
        f"(logits, k, v, the next token) ({out['nccl1']['seconds']:.2f} s)")
    del l1, c1, c0b, d1, d0, mine, c0
    torch.cuda.empty_cache()
    out["gloo4"] = mesh_part(tp, full, l0, "tp gloo x4")
    out["gloo4"]["no_mesh_prefill_s"] = nomesh_s
    for r, row in enumerate(out["gloo4"]["per_rank"]):
        want = {f"B={B} Sq={S} Skv={S} {cfg.num_heads // 4}/"
                f"{cfg.num_kv_heads // 4}x{cfg.head_dim} causal q_offset=0":
                cfg.num_layers}
        check(row["prefill_flash_by_shape"] == want,
              f"tp gloo x4 rank {r}: flash {row['prefill_flash_by_shape']}")
    log(f"tp gloo x4 on one card: {cfg.name} x{cfg.num_layers} on mesh "
        f"{tp['mesh']}, every rank equals its place of the emulation bit for "
        f"bit (prefill B={B} S={S}, {tp['decode'][2]} decode steps at batch "
        f"{tp['decode'][0]}, tokens equal on every rank); prefill logits "
        f"rel L2 {out['gloo4']['rel_l2_no_mesh']:.3e} from the no-mesh route "
        f"(gate {LM_MAX_REL_L2}; no-mesh prefill {nomesh_s:.3f} s); ranks "
        f"{out['gloo4']['ranks_s']:.2f} s, emulation "
        f"{out['gloo4']['emulation_s']:.2f} s")
    del full, l0
    torch.cuda.empty_cache()

    # (c) context parallel: qwen3-14b x 2 layers on mesh (1, 3)
    cfg, full, tokens, l0, c0, nomesh_s = setup(cp)
    del c0
    B, S = cp["prefill"]
    n = cp["mesh"][1]
    check(cfg.num_heads % n != 0 and S % n == 0
          and cfg.attn_impl == "chunked", f"tp cp: not context parallel")
    out["cp3"] = mesh_part(cp, full, l0, "tp cp gloo x3")
    out["cp3"]["no_mesh_prefill_s"] = nomesh_s
    for r, row in enumerate(out["cp3"]["per_rank"]):
        want = {f"B={B} Sq={S // n} Skv={S} {cfg.num_heads}/"
                f"{cfg.num_kv_heads}x{cfg.head_dim} causal q_offset="
                f"{r * S // n}": cfg.num_layers}
        check(row["prefill_flash_by_shape"] == want,
              f"tp cp rank {r}: flash {row['prefill_flash_by_shape']}")
    log(f"tp cp gloo x3 on one card: {cfg.name} x{cfg.num_layers} on mesh "
        f"{cp['mesh']} ({cfg.num_heads} heads on 3 places: context "
        f"parallel), prefill B={B} S={S}: rank r's flash launches at "
        f"{S // n} query rows, q_offset r x {S // n}, against {S} keys; every "
        f"rank equals its place of the emulation bit for bit; logits rel L2 "
        f"{out['cp3']['rel_l2_no_mesh']:.3e} from the no-mesh route (gate "
        f"{LM_MAX_REL_L2}; no-mesh prefill {nomesh_s:.3f} s)")
    del full, l0
    torch.cuda.empty_cache()
    tmp.cleanup()
    out["launches"] = out["gloo4"]["per_rank"][0]["launches"]
    out["launches_cp"] = out["cp3"]["per_rank"][0]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_tp_all(dev, parts: dict = TP_ALL) -> dict:
    """The rest of the serving path over a (data x model) mesh (``launch.
    steps`` with ``mesh=``): MLA tensor parallelism (``layers.mla_block``
    on a rank's heads and latent block), the recurrent families
    (``models.xlstm``, ``models.ssm``, their states cut by
    ``cache_specs``) and the loss over the global batch; ``TP_ALL``'s
    three parts over 4 gloo ranks on this card, beside their in-process
    emulation in one process of its own (``tp_all_emulation``).  Each
    holds every rank to its place of the emulation bit for bit and the prefill
    logits or the loss to the no-mesh route within LM_MAX_REL_L2, and
    logs the bytes gathered a call, the prefill (or loss) seconds, decode
    p50 / p99, each rank's peak and the flash launches by shape."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.model import build_model

    out = {"card": card_line()}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    # the no-mesh route of every part first (the ranks' reference)
    setups = {}
    for tag, spec in parts.items():
        cfg = dataclasses.replace(get_config(spec["arch"]),
                                  num_layers=spec["num_layers"])
        recurrent = cfg.family in ("xlstm", "hybrid")
        full = build_model(cfg, dev).init(spec["seed"])
        rng = np.random.default_rng(spec["seed"])
        _, prefill = make_prefill_step(cfg, dev)
        t0 = time.perf_counter()
        if recurrent:
            B, S = spec["loss"]
            tokens = rng.integers(0, cfg.vocab_size, (B, S + 1),
                                  dtype=np.int32)
            ref = prefill(full, {"tokens": tokens[:, :-1],
                                 "labels": tokens[:, 1:]})
        else:
            B, S = spec["prefill"]
            tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
            ref, cache = prefill(full, {"tokens": tokens, "cache_seq": S})
            del cache
        torch.cuda.synchronize(dev)
        setups[tag] = (cfg, recurrent, ref, (B, S), time.perf_counter() - t0)
        del full
        torch.cuda.empty_cache()
    # the emulation's process runs beside the ranks, so that the whole
    # script fits its time limit on a slow host; the ranks' seconds are
    # measured beside it
    emu_box: dict = {}

    def emulate():
        t0 = time.perf_counter()
        try:
            emu_box["out"] = run_ranks(
                tp_all_emulation, 1, "none",
                pathlib.Path(tmp.name) / "emulation", lambda r: str(dev),
                TP_ALL_DEADLINE_S, "tp_all emulation", parts)
        except BaseException as err:     # noqa: BLE001 — re-raised below
            emu_box["err"] = err
        out["emulation_process_s"] = time.perf_counter() - t0

    emu_thread = threading.Thread(target=emulate)
    t0 = time.perf_counter()
    emu_thread.start()
    try:
        ranks_all = run_ranks(tp_rank, 4, "gloo",
                              pathlib.Path(tmp.name) / "ranks",
                              lambda r: str(dev), TP_ALL_DEADLINE_S,
                              "tp_all", parts)
        out["ranks_s"] = time.perf_counter() - t0
    finally:
        emu_thread.join()
    if "err" in emu_box:
        raise emu_box["err"]
    emu_all = emu_box["out"]
    for tag, spec in parts.items():
        cfg, recurrent, ref, (B, S), nomesh_s = setups.pop(tag)
        name = f"tp_all {tag} gloo x4"
        ranks = part_of(ranks_all, tag)
        emu_part = part_of(emu_all, tag)
        emu_s = float(emu_part[0]["seconds"])
        emu = [part_of(emu_part, str(p))[0] for p in range(len(ranks))]
        held = hold_tp(ranks, emu, ref, spec, name)
        del emu, ref
        rows = tp_report(ranks, name)
        want = {"silu_stepwise"} if recurrent else {"flash_attention",
                                                     "silu_stepwise"}
        for r, row in enumerate(rows):
            row["card_used_gb"] = float(ranks[r]["card_used_gb"])
            check(all(row["launches"].get(k, 0) > 0 for k in want),
                  f"{name}: rank {r}'s launches {row['launches']}")
        if not recurrent:
            n = spec["mesh"][1]
            d = cfg.head_dim + cfg.rope_head_dim
            want = {f"B={B} Sq={S} Skv={S} {cfg.num_heads // n}/"
                    f"{cfg.num_heads // n}x{d} causal q_offset=0":
                    cfg.num_layers}
            for r, row in enumerate(rows):
                check(row["prefill_flash_by_shape"] == want,
                      f"{name} rank {r}: flash "
                      f"{row['prefill_flash_by_shape']}")
        out[tag] = {"per_rank": rows, "emulation_s": emu_s,
                    "no_mesh_prefill_s": nomesh_s, **held}
        what = "loss" if recurrent else "prefill logits"
        log(f"{name} on one card: {cfg.name} x{cfg.num_layers} on mesh "
            f"{spec['mesh']}, every rank equals its place of the emulation "
            f"bit for bit ({'loss' if recurrent else 'prefill'} B={B} "
            f"S={S}, {spec['decode'][2]} decode steps at batch "
            f"{spec['decode'][0]} after a {spec['decode'][1]}-token prompt, "
            f"tokens equal on every rank); {what} rel L2 "
            f"{held['rel_l2_no_mesh']:.3e} from the no-mesh route (gate "
            f"{LM_MAX_REL_L2}; no-mesh {nomesh_s:.3f} s); emulation "
            f"{emu_s:.2f} s; card in use after a rank's decode "
            f"{[row['card_used_gb'] for row in rows]} GB")
    log(f"tp_all: the ranks ran the three parts in {out['ranks_s']:.2f} s, "
        f"the emulation's process in {out['emulation_process_s']:.2f} s")
    tmp.cleanup()
    out["launches"] = {tag: out[tag]["per_rank"][0]["launches"]
                       for tag in parts}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_mla(dev, mla: dict = MLA) -> dict:
    """The MLA serving path on the card (phase lm's checks on ``MLA``, phase
    moe's route checks and expert placement, the latent cache's bytes, an
    MLA decode step without a host sync, the serving CLI); see the module
    docstring, item 12."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import layers as LL

    def checks(cfg, model, params, prefill, prefill_plain, batch, smodel,
               step) -> dict:
        out = route_checks(dev, cfg, params, prefill, prefill_plain, batch,
                           mla)
        # the latent cache: its bytes on the device against a per-head
        # cache of the same shape (k at dn + dr, v at dv)
        B, cache_seq = batch["tokens"].shape[0], mla["cache_seq"]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        cache = model.init_cache(B, cache_seq)
        torch.cuda.synchronize()
        measured = torch.cuda.memory_allocated(dev) - before
        nbytes = sum(t.numel() * t.element_size() for t in cache.values())
        per_head = (cfg.num_layers * B * cache_seq * cfg.num_heads * 2 *
                    (cfg.head_dim + cfg.rope_head_dim + cfg.v_head_dim))
        check(sorted(cache) == ["c_kv", "k_rope"] and measured >= nbytes,
              f"latent cache {sorted(cache)}: {measured:,} bytes allocated "
              f"for {nbytes:,}")
        out["latent_cache"] = {
            "shapes": {n: list(t.shape) for n, t in cache.items()},
            "bytes": nbytes, "bytes_allocated": measured,
            "per_head_cache_bytes": per_head}
        log(f"mla latent cache (L={cfg.num_layers}, B={B}, {cache_seq} "
            f"slots): {measured:,} bytes allocated ({nbytes:,} in its "
            f"tensors); a per-head cache would take {per_head:,}")
        del cache

        # one decode step's MLA block makes no device-to-host sync
        Bs, P = mla["serve_batch"], mla["prompt"]
        p0, dt = params["stack"][0]["attn"], getattr(torch, cfg.dtype)
        c = smodel.init_cache(Bs, P + mla["gen"])
        layer = {n: t[0] for n, t in c.items()}
        gen = torch.Generator(device=dev).manual_seed(mla["seed"])
        h = torch.randn((Bs, 1, cfg.d_model), generator=gen, device=dev,
                        dtype=dt)
        pos = torch.full((Bs, 1), P, dtype=torch.int32, device=dev)
        with torch.no_grad():
            want = LL.mla_block(p0, h, cfg, pos, cache=layer, cache_len=P,
                                dtype=dt)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = LL.mla_block(p0, h, cfg, pos, cache=layer, cache_len=P,
                                   dtype=dt)
            except RuntimeError as err:
                raise SmokeFailure("mla_block at decode's shape synchronised "
                                   f"with the host: {err}") from err
            finally:
                torch.cuda.set_sync_debug_mode(0)
        check(torch.equal(got, want), "mla_block at decode: two calls differ")
        out["mla_block_host_syncs"] = 0
        log(f"mla: one decode step's mla_block at ({Bs}, 1) against a "
            f"{P + mla['gen']}-slot latent cache made no device-to-host sync "
            "(set_sync_debug_mode error), two calls bitwise equal")
        del c, layer
        return out

    out = phase_lm(dev, mla, extra=checks)
    # the serving CLI on the card at full width, cut to the phase's depth
    cli = mla["cli"]
    t0 = time.perf_counter()
    toks = serve.main(["--arch", mla["arch"], "--layers",
                       str(mla["num_layers"]), "--batch", str(cli["batch"]),
                       "--prompt-len", str(cli["prompt"]), "--gen",
                       str(cli["gen"]), "--device", str(dev)])
    out["cli_s"] = time.perf_counter() - t0
    check(toks.shape == (cli["batch"], cli["gen"]),
          f"serve CLI gave tokens {toks.shape}")
    torch.cuda.empty_cache()
    log(f"mla serve CLI ({mla['arch']} --layers {mla['num_layers']}, batch "
        f"{cli['batch']}, prompt {cli['prompt']}, gen {cli['gen']}) on the "
        f"card in {out['cli_s']:.2f} s, weights drawn included")
    return out


def encdec_prefill_flops(cfg, B: int, S: int) -> float:
    """The floating-point operations of one encoder-decoder prefill, 2 a
    multiply-add: the encoder over B x encoder_seq frames (projections,
    MLP, bidirectional attention), every decoder layer's cross k/v over
    those frames, the decoder over B x S tokens (self projections, cross
    q and o, MLP, causal attention over S (S + 1) / 2 pairs, cross
    attention over S x encoder_seq pairs), and the last position's
    logits."""
    D, F, H, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    KV, Se = cfg.num_kv_heads, cfg.encoder_seq
    qo, kv = 2 * D * H * hd * 2, 2 * D * KV * hd * 2
    Te, T = B * Se, B * S
    enc = (qo + kv + 2 * 2 * D * F) * Te + 4 * B * H * hd * Se * Se
    dec = ((qo + kv + qo + 2 * 2 * D * F) * T + kv * Te
           + 4 * B * H * hd * S * (S + 1) // 2 + 4 * B * H * hd * S * Se)
    return float(cfg.encoder_layers * enc + cfg.num_layers * dec
                 + 2 * B * D * cfg.padded_vocab)


def time_flash_noncausal(dev, q, k, v) -> dict:
    """flash_attention non-causal on these q, k, v: CUDA-graph and eager
    times, its plain version, and scaled_dot_product_attention on the same
    tensors (non-causal, K and V at the query heads) as the library
    yardstick.  The bound: 4 B H Sq Skv D FLOP at the bf16 tensor-core
    rate against q, k, v read and the output written once."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    saved = dict(FA.LAUNCHES)

    def kern():
        return FA.flash_attention(q, k, v, causal=False)

    ms = time_graph_ms(kern, 5, 11)
    eager_ms = time_ms(kern, 5, 11)
    plain_ms = time_ms(lambda: FA.flash_attention_ref(q, k, v, causal=False),
                       1, 3)
    FA.LAUNCHES.update(saved)   # timing launches are not path launches
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=KV != H), 5, 11)
    flops = 4 * B * H * Sq * Skv * D
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TENSOR_BF16_FLOPS * 1e3
    return {"shape": f"q (B={B}, Sq={Sq}, H={H}, D={D}), k/v (Skv={Skv}, "
                     f"KV={KV}), non-causal, {str(q.dtype).split('.')[-1]}",
            "tensor_cores": FA.uses_tensor_cores(q, k, v),
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes, "library_ms": library_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention"
                       "(non-causal)"}


def phase_encdec(dev, encdec: dict = ENCDEC) -> dict:
    """The encoder-decoder serving path on the card (phase lm's checks on
    ``ENCDEC``, with frames, 72 flash launches a prefill, its caches held
    to the plain route's, teacher forcing from a prefill's cross cache, the
    reduced config against the CPU; then its own): (a) the prefill's bf16
    bound and a profiled prefill's flash_wgmma launches by role (encoder,
    decoder self-attention, cross-attention); (b) the kernel at the
    encoder's (8, 1,500, 16, 64) and the cross-attention's (8, 224) x
    (8, 1,500) shapes against its plain version on the tensor-core route,
    the cross k/v views of the stacked cross cache, timed beside its bound
    and SDPA; (d) greedy decode of 64 tokens at batch 8 from the prefill's
    cache (a step's device time from CUDA events, p50 and p99; no host
    sync in a step; a profiled step); (e) the serving CLI on the card, its
    engine tokens equal to decode_loop's."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import layers as LL

    def checks(cfg, model, params, prefill, prefill_plain, batch, smodel,
               step) -> dict:
        out: dict = {}
        B, S = batch["tokens"].shape
        Le, L = cfg.encoder_layers, cfg.num_layers
        # (a) the prefill's bound, and its flash launches by role
        flops = encdec_prefill_flops(cfg, B, S)
        out["prefill_flops"] = flops
        out["prefill_bound_s"] = flops / TENSOR_BF16_FLOPS
        prof = profile_window(lambda: prefill(params, batch), order=True)
        times = prof.get("port_kernels_us", {}).get("flash_wgmma", [])
        if len(times) == Le + 2 * L:
            roles = {"encoder": times[:Le], "decoder_self": times[Le::2],
                     "cross": times[Le + 1::2]}
            out["prefill_flash_us_by_role"] = {
                r: {"mean": statistics.mean(v), "max": max(v), "n": len(v)}
                for r, v in roles.items()}
        else:   # the profiler dropped some: no split by role
            out["prefill_flash_us_by_role"] = (
                f"not measured ({len(times)} of {Le + 2 * L} recorded)")
        prof.pop("port_kernels_us", None)
        out["profile_prefill_by_role"] = prof
        log(f"encdec prefill B={B} S={S}: {flops:.4e} FLOP, bf16 bound "
            f"{out['prefill_bound_s'] * 1e3:.2f} ms; flash_wgmma by role "
            f"{out['prefill_flash_us_by_role']}")

        # (b) the kernel at the two non-causal shapes, on the path's inputs
        dt = getattr(torch, cfg.dtype)
        _, cache = prefill(params, batch)
        with torch.no_grad():
            x = model._positions_added(batch["frames"].to(dt))
            pos = torch.arange(cfg.encoder_seq, dtype=torch.int32,
                               device=dev).expand(B, cfg.encoder_seq)
            h = LL.apply_norm(params["enc"][0]["ln1"], x, cfg.norm)
            enc_qkv = LL.qkv_projection(params["enc"][0]["attn"], h, cfg,
                                        pos, dt)
            # layer 0's cross query: its input after the self-attention
            # and its residual, as apply_layer makes it
            p0 = params["stack"][0]
            x0 = model._positions_added(model._embed(params,
                                                     batch["tokens"]))
            dpos = torch.arange(S, dtype=torch.int32,
                                device=dev).expand(B, S)
            x0 = x0 + LL.attention_block(
                p0["attn"], LL.apply_norm(p0["ln1"], x0, cfg.norm), cfg,
                dpos, dtype=dt)
            hx = LL.apply_norm(p0["ln_x"], x0, cfg.norm)
            cross_qkv = (LL.q_projection(p0["xattn"], hx, cfg, dt),
                         cache["cross"][0][0], cache["cross"][1][0])
        tol = FLASH_TOL[cfg.dtype]
        flash_times = {}
        for role, (q, k, v) in (("encoder", enc_qkv),
                                ("cross", cross_qkv)):
            tc = FA.uses_tensor_cores(q, k, v)
            check(tc, f"encdec {role} attention at q {tuple(q.shape)}, k "
                  f"{tuple(k.shape)} strides {k.stride()} is off the "
                  "tensor-core route")
            saved = dict(FA.LAUNCHES)
            with torch.no_grad():
                got = FA.flash_attention(q, k, v, causal=False)
                want = FA.flash_attention_ref(q, k, v, causal=False)
            FA.LAUNCHES.update(saved)
            d = (got.float() - want.float()).abs()
            err = float(d.max())
            check(bool(torch.isfinite(got.float()).all()) and bool(
                (d <= tol + tol * want.float().abs()).all()),
                f"encdec {role} attention, kernel against plain: max abs "
                f"err {err:.3e} past {tol}")
            row = time_flash_noncausal(dev, q, k, v)
            row["max_abs_err"] = err
            flash_times[role] = row
            log(f"encdec flash {role} ({row['shape']}): max abs err "
                f"{err:.3e}; {row['ms'] * 1e3:.1f} us in a CUDA graph, "
                f"{row['eager_ms'] * 1e3:.1f} us eager, plain "
                f"{row['plain_ms'] * 1e3:.1f} us, sdpa "
                f"{row['library_ms'] * 1e3:.1f} us, bound "
                f"{row['bound_ms'] * 1e3:.1f} us by {row['bound_by']} "
                f"({row['flops']:.4e} FLOP)")
            del got, want, d
        out["flash_times"] = flash_times
        del enc_qkv, cross_qkv, h, hx, x, x0

        # (d) greedy decode from the prefill's cache at the prefill's batch
        n = encdec["decode_gen"]
        tok = torch.argmax(prefill(params, batch)[0], dim=-1).to(
            torch.int32)[:, None]
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        gen_tokens = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            starts[i].record()
            nxt, _, cache = step(params, {"token": tok, "pos": S + i,
                                          "cache": cache})
            ends[i].record()
            tok = nxt[:, None]
            gen_tokens.append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
        gen = torch.cat(gen_tokens, dim=1).cpu().numpy()
        check(gen.shape == (B, n) and bool(((gen >= 0) & (
            gen < cfg.vocab_size)).all()), f"greedy decode gave {gen.shape}")
        out["decode"] = {
            "batch": B, "steps": n, "wall_s": wall,
            "generated_tok_s": B * n / wall,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p99": float(np.percentile(step_ms, 99)),
            "step_ms_mean": statistics.mean(step_ms)}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(params, {"token": tok, "pos": S + n, "cache": cache})
        except RuntimeError as err:
            raise SmokeFailure("an encdec decode step synchronised with the "
                               f"host: {err}") from err
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out["decode_step_host_syncs"] = 0
        out["profile_decode_step_b8"] = profile_window(
            lambda: step(params, {"token": tok, "pos": S + n,
                                  "cache": cache}))
        d_ = out["decode"]
        log(f"encdec greedy decode B={B}, {n} tokens from the prefill's "
            f"cache: {wall:.3f} s, {d_['generated_tok_s']:.1f} tok/s, a step "
            f"p50 {d_['step_ms_p50']:.2f} ms p99 {d_['step_ms_p99']:.2f} ms "
            f"(CUDA events); no host sync in a step; profiled step "
            f"{out['profile_decode_step_b8'].get('device_kernels')} kernels, "
            f"busy {out['profile_decode_step_b8'].get('busy_s')} s, idle "
            f"{out['profile_decode_step_b8'].get('idle_share')}")
        del cache
        return out

    out = phase_lm(dev, encdec, extra=checks)
    for role, row in out["flash_times"].items():   # counted in phase lm
        row["launches"] = out["prefill_flash_launches_by_role"][role]
    # (e) the serving CLI on the card (its zero cross cache), then
    # decode_loop on the same weights and prompt
    cli = encdec["cli"]
    t0 = time.perf_counter()
    toks = serve.main(["--arch", encdec["arch"], "--batch",
                       str(cli["batch"]), "--prompt-len", str(cli["prompt"]),
                       "--gen", str(cli["gen"]), "--device", str(dev)])
    out["cli_s"] = time.perf_counter() - t0
    model, step = make_serve_step(serve.get_config(encdec["arch"]), dev)
    prompt = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, size=(cli["batch"], cli["prompt"]))
    ref = serve.decode_loop(model, step, model.init(0), prompt, cli["gen"],
                            cli["prompt"] + cli["gen"])
    check(np.array_equal(toks, ref), "serve CLI: engine tokens differ from "
          "decode_loop's")
    del model, step
    torch.cuda.empty_cache()
    log(f"encdec serve CLI ({encdec['arch']}, batch {cli['batch']}, prompt "
        f"{cli['prompt']}, gen {cli['gen']}) on the card in "
        f"{out['cli_s']:.2f} s, weights drawn included; engine tokens equal "
        "decode_loop's")
    return out


def vlm_prefill_flops(cfg, B: int, S: int) -> float:
    """The floating-point operations of one dense (VLM) prefill, 2 a
    multiply-add: every layer's projections (q, k, v, o) and SwiGLU MLP
    over B x S tokens, causal attention over S (S + 1) / 2 pairs a row,
    and the last position's logits."""
    D, F, H, KV, hd = (cfg.d_model, cfg.d_ff, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    per_token = 2 * D * (2 * H * hd + 2 * KV * hd) + 2 * 3 * D * F
    attn = 4 * B * H * hd * S * (S + 1) // 2
    return float(cfg.num_layers * (per_token * B * S + attn)
                 + 2 * B * D * cfg.padded_vocab)


def weight_bytes(params) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def decode_weight_bytes(cfg, params, batch: int) -> int:
    """The weight bytes one decode step at ``batch`` must read: every
    weight once, but of an untied input embedding table only the
    ``batch`` rows it gathers."""
    nbytes = weight_bytes(params)
    if not cfg.tie_embeddings:
        emb = params["embed"]
        nbytes -= (emb.shape[0] - batch) * emb.shape[1] * emb.element_size()
    return nbytes


def phase_vlm(dev, vlm: dict = VLM) -> dict:
    """The VLM serving path on the card (phase lm's checks on ``VLM``: the
    text prefill at B=2, S=4,096 with 24 flash launches at internvl2's
    64/8-head shape, counted by shape, against the plain route; decode
    through the engine equal to decode_loop's; teacher forcing; the
    reduced config against the CPU); and its own: the prefill's bf16
    bound, one decode step's weight bytes and bound, and the loss with
    patches at full width through ``make_eval_step`` (text tokens only
    counted, finite, moved by the patches).  The prefill and decode read
    no patches, as the reference's do."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_eval_step

    def checks(cfg, model, params, prefill, prefill_plain, batch, smodel,
               step) -> dict:
        out: dict = {}
        B, S = batch["tokens"].shape
        # (a) the prefill's launches by shape, and its bound
        FA.reset_launch_counts()
        prefill(params, batch)
        torch.cuda.synchronize()
        shapes = dict(FA.LAUNCH_SHAPES)
        out["prefill_flash_launches_by_shape"] = {
            f"causal={c}, Sq={q}, Skv={k}": n for (c, q, k), n in
            shapes.items()}
        check(shapes == {(True, S, S): cfg.num_layers},
              f"vlm prefill flash launches by (causal, Sq, Skv) {shapes}, "
              f"want {cfg.num_layers} at (True, {S}, {S})")
        FA.reset_launch_counts()
        flops = vlm_prefill_flops(cfg, B, S)
        out["prefill_flops"] = flops
        out["prefill_bound_s"] = flops / TENSOR_BF16_FLOPS
        # (b) a decode step reads every weight once (the head's rows too),
        # of the input embedding only the rows it gathers
        nbytes = decode_weight_bytes(cfg, params, vlm["serve_batch"])
        out["decode_step_weight_bytes"] = nbytes
        out["decode_step_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"vlm prefill B={B} S={S}: {flops:.4e} FLOP, bf16 bound "
            f"{out['prefill_bound_s'] * 1e3:.1f} ms; flash launches by shape "
            f"{out['prefill_flash_launches_by_shape']}; a decode step reads "
            f"{nbytes / 1e9:.2f} GB of weights, bound "
            f"{out['decode_step_bound_ms']:.2f} ms")
        # (c) the loss with patches at full width, bf16 weights
        _, eval_step = make_eval_step(cfg, dev)
        Bp, P, T_ = vlm["patch_batch"], cfg.num_patches, vlm["patch_text"]
        rng = np.random.default_rng(vlm["seed"] + 2)
        toks = rng.integers(0, cfg.vocab_size, (Bp, T_)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (Bp, T_)).astype(np.int32)
        patches = rng.normal(0, 0.1, (Bp, P, cfg.d_model)).astype(np.float32)
        t0 = time.perf_counter()
        met = eval_step(params, {"tokens": toks, "labels": labels,
                                 "patches": patches})
        loss = float(met["loss"])
        out["patch_loss_s"] = time.perf_counter() - t0
        met2 = eval_step(params, {"tokens": toks, "labels": labels,
                                  "patches": patches + np.float32(0.1)})
        out["patch_loss"] = loss
        out["patch_loss_shifted"] = float(met2["loss"])
        out["patch_tokens"] = float(met["tokens"])
        check(np.isfinite(loss) and out["patch_tokens"] == Bp * T_,
              f"vlm loss with patches {loss}, tokens {out['patch_tokens']} "
              f"(want {Bp * T_}: text only)")
        check(out["patch_loss_shifted"] != loss,
              "vlm loss: other patches gave the same loss")
        log(f"vlm loss with patches (B={Bp}, {P} patches + {T_} text "
            f"tokens, bf16 weights): {loss:.5f}, {out['patch_tokens']:.0f} "
            f"tokens counted (text only); patches + 0.1 give "
            f"{out['patch_loss_shifted']:.5f}; {out['patch_loss_s']:.3f} s")
        return out

    return phase_lm(dev, vlm, extra=checks)


def recurrent_serve(dev, cfg, params, rc: dict, tag: str) -> dict:
    """The serving loop of a recurrent family on the card (the prompt
    warmed step by step, as the reference does): ``decode_loop`` and
    ``decode_loop_engine`` at batch ``serve_batch``, their tokens equal;
    a profiled decode step (its kernels, busy time and idle share); a
    decode step's weight bytes and bound; no flash launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import (_init_cache, decode_loop,
                                          decode_loop_engine)
    from repro_torch.launch.steps import make_serve_step

    out: dict = {}
    smodel, step = make_serve_step(cfg, dev)
    Bs, P, G = rc["serve_batch"], rc["prompt"], rc["gen"]
    prompt = np.random.default_rng(rc["seed"]).integers(0, cfg.vocab_size,
                                                        (Bs, P))
    FA.reset_launch_counts()
    t0 = time.perf_counter()
    ref_tokens = decode_loop(smodel, step, params, prompt, G, P + G)
    out["decode_loop_s"] = time.perf_counter() - t0
    EW.reset_launch_counts()
    t0 = time.perf_counter()
    tokens_e, summary = decode_loop_engine(smodel, step, params, prompt, G,
                                           P + G, prefetch=True)
    wall = time.perf_counter() - t0
    check(FA.LAUNCHES["flash_attention"] == 0,
          f"{tag} decode launched the flash kernel")
    out["engine_elementwise_launches"] = dict(EW.LAUNCHES)
    check(EW.LAUNCHES["silu_stepwise"] > 0,
          f"{tag}: the engine's decode made no silu_stepwise launch")
    check(np.array_equal(tokens_e, ref_tokens),
          f"{tag}: engine tokens differ from decode_loop's")
    check(bool(((tokens_e >= 0) & (tokens_e < cfg.vocab_size)).all()),
          f"{tag}: a generated token lies outside the vocabulary")
    check(summary["requests"] == P - 1 + G,
          f"{tag} engine served {summary['requests']} requests")
    out["engine"] = {k: summary[k] for k in (
        "requests", "tokens", "wall_s", "tokens_s", "p50_ms", "p99_ms",
        "mean_ms", "compute_s")}
    out["engine_s"] = wall
    out["generated_tok_s"] = Bs * G / wall
    log(f"{tag} serve B={Bs} prompt={P} gen={G} (prompt warmed step by "
        f"step): {summary['requests']} engine requests in {wall:.3f} s, "
        f"{out['generated_tok_s']:.1f} generated tok/s, p50 "
        f"{summary['p50_ms']:.2f} ms, p99 {summary['p99_ms']:.2f} ms per "
        f"token step; tokens equal decode_loop's "
        f"({out['decode_loop_s']:.3f} s)")
    c = _init_cache(smodel, Bs, P + G)
    tok = torch.from_numpy(prompt[:, :1]).to(dev)
    out["profile_decode_step"] = profile_window(
        lambda: step(params, {"token": tok, "pos": 0, "cache": c}))
    out["decode_step_elementwise_launches"] = elementwise_launches(
        lambda: step(params, {"token": tok, "pos": 0, "cache": c}))
    nbytes = decode_weight_bytes(cfg, params, Bs)
    state_bytes = weight_bytes(c)
    out["decode_step_bytes"] = nbytes + 2 * state_bytes
    out["decode_step_bound_ms"] = (nbytes + 2 * state_bytes) \
        / HBM_BYTES_PER_S * 1e3
    prof = out["profile_decode_step"]
    log(f"{tag} decode step profiled: {prof.get('device_kernels')} kernels "
        f"({out['decode_step_elementwise_launches']['silu_stepwise']} of "
        f"them silu_stepwise), "
        f"busy {prof.get('busy_s')} s of {prof['wall_s']:.4f} s wall, idle "
        f"{prof.get('idle_share')}; it reads {nbytes / 1e9:.3f} GB of "
        f"weights and its {state_bytes / 1e6:.1f} MB of states twice, "
        f"bound {out['decode_step_bound_ms']:.3f} ms")
    del c
    return out


def teacher_forcing_recurrent(dev, cfg, model, params, rc: dict,
                              tag: str, gate: bool = True) -> dict:
    """The parallel form's logits (``_backbone`` and ``_logits``) against
    decode-stepped logits over the same ``tf_tokens`` tokens at batch
    ``tf_batch``: relative L2 over every position, the first position
    past LM_MAX_REL_L2 and the argmax agreement; with ``gate``, within
    LM_MAX_REL_L2, else reported only."""
    import numpy as np
    import torch

    B, T_ = rc["tf_batch"], rc["tf_tokens"]
    toks = torch.from_numpy(np.random.default_rng(rc["seed"] + 1).integers(
        0, cfg.vocab_size, (B, T_))).to(dev)
    V = cfg.vocab_size
    with torch.no_grad():
        pos = torch.arange(T_, dtype=torch.int32, device=dev).expand(B, T_)
        x, _, _ = model._backbone(params, model._embed(params, toks), pos)
        want = model._logits(params, x)[..., :V].float()
        cache = model.init_cache(B, T_)
        got = []
        t0 = time.perf_counter()
        for t in range(T_):
            lt, cache = model.decode_step(params, {"token": toks[:, t:t + 1],
                                                   "pos": t, "cache": cache})
            got.append(lt[:, :V].float())
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        got = torch.stack(got, dim=1)
    per_pos = [rel_l2(got[:, t], want[:, t]) for t in range(T_)]
    out = {"dtype": cfg.dtype, "gated": gate, "tokens": T_, "batch": B,
           "rel_l2": rel_l2(got, want), "max_pos_rel_l2": max(per_pos),
           "first_pos_past_bound": next(
               (t for t, e in enumerate(per_pos) if e > LM_MAX_REL_L2), None),
           "first_8_pos_rel_l2": per_pos[:8],
           "max_abs_err": float((got - want).abs().max()),
           "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
           "decode_steps_s": steps_s}
    log(f"{tag} teacher forcing over {T_} tokens at B={B}: parallel form "
        f"against decode steps, relative L2 {out['rel_l2']:.3e} (worst "
        f"position {out['max_pos_rel_l2']:.3e}, first past "
        f"{LM_MAX_REL_L2}: {out['first_pos_past_bound']}), argmax equal on "
        f"{out['argmax_agreement']:.4f}; {T_} decode steps in "
        f"{steps_s:.2f} s" + ("" if gate else " (reported, not gated)"))
    if gate:
        check(out["rel_l2"] <= LM_MAX_REL_L2,
              f"{tag} teacher forcing: relative L2 {out['rel_l2']:.3e} > "
              f"{LM_MAX_REL_L2}")
    return out


def float32_twin(dev, cfg, seed: int):
    """The same configuration in float32 with float32 weights
    (``init(master=True)``, another draw than the bf16 model's): (cfg,
    model, params)."""
    import dataclasses

    from repro_torch.models.model import build_model

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, dev)
    return cfg32, model, model.init(seed, master=True)


def block_parallel_vs_recurrent(tag: str, block, x) -> dict:
    """``block(x, None)`` (the parallel form) against ``block`` stepped
    token by token from empty states (the recurrence), on x (B, L, D):
    relative L2 within LM_MAX_REL_L2, and both times."""
    import torch

    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        par = block(x, None)
        torch.cuda.synchronize()
        par_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = block(x, True)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
    out = {"shape": list(x.shape), "rel_l2": rel_l2(rec, par),
           "max_abs_err": float((rec.float() - par.float()).abs().max()),
           "parallel_s": par_s, "recurrent_s": rec_s}
    log(f"{tag} layer 0 block at {tuple(x.shape)}: parallel form "
        f"{par_s * 1e3:.1f} ms against the recurrence ({x.shape[1]} steps, "
        f"{rec_s:.2f} s): relative L2 {out['rel_l2']:.3e}, max abs err "
        f"{out['max_abs_err']:.3e}")
    check(out["rel_l2"] <= LM_MAX_REL_L2,
          f"{tag} layer 0 block, parallel against recurrent: relative L2 "
          f"{out['rel_l2']:.3e} > {LM_MAX_REL_L2}")
    return out


def reduced_recurrent_cpu_vs_cuda(dev, arch: str, tag: str) -> dict:
    """The reduced config's greedy tokens (decode_loop, 12-token prompt, 6
    new) on the CPU and the card, equal, and the last step's logits
    within 1e-4."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import decode_loop
    from repro_torch.launch.steps import make_serve_step

    rcfg = get_config(arch).reduced()
    rm_c, step_c = make_serve_step(rcfg, "cpu")
    rm_g, step_g = make_serve_step(rcfg, dev)
    rp_c = rm_c.init(0)
    rp_g = _tree_to(rp_c, dev)
    rtoks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 12))
    tc = decode_loop(rm_c, step_c, rp_c, rtoks, 6, 18)
    tg = decode_loop(rm_g, step_g, rp_g, rtoks, 6, 18)
    check(np.array_equal(tc, tg), f"{tag} reduced decode: cpu tokens != "
          "cuda tokens")
    torch.backends.cuda.matmul.allow_tf32 = False
    tok = torch.from_numpy(rtoks[:, :1])
    lc, _ = rm_c.decode_step(rp_c, {"token": tok, "pos": 0,
                                    "cache": rm_c.init_cache(2, 4)})
    lg, _ = rm_g.decode_step(rp_g, {"token": tok.to(dev), "pos": 0,
                                    "cache": rm_g.init_cache(2, 4)})
    err = float((lg.cpu() - lc).abs().max())
    check(err <= 1e-4, f"{tag} reduced decode step: cpu against cuda {err}")
    log(f"{tag} reduced {rcfg.name}: cpu == cuda (decode tokens equal, a "
        f"step's logits max abs err {err:.2e})")
    return {"tokens_equal": True, "step_max_abs_err": err}


def phase_xlstm(dev, xl: dict = XLSTM) -> dict:
    """The xLSTM path on the card; see the module docstring, item 15."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import layers as LL
    from repro_torch.models import xlstm as XL

    cfg = get_config(xl["arch"])
    out: dict = {"arch": cfg.name, "num_layers": cfg.num_layers,
                 "d_model": cfg.d_model,
                 "heads": f"{cfg.num_heads}x{cfg.head_dim}",
                 "groups": f"{cfg.num_layers // cfg.xlstm_group} x "
                           f"({cfg.xlstm_group - 1} mLSTM + 1 sLSTM)"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, _ = make_serve_step(cfg, dev)
    params = model.init(xl["seed"])
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = model.param_count(params)
    out["weights_gb"] = weight_bytes(params) / 1e9
    log(f"xlstm: {cfg.name}, {out['groups']}, {out['params']:,} parameters "
        f"({out['weights_gb']:.3f} GB, matrices bf16, gates and recurrent "
        f"weights float32) drawn in {out['init_s']:.2f} s")

    out.update(recurrent_serve(dev, cfg, params, xl, "xlstm"))
    # the served bf16 model's two forms, reported: in bf16 they part in
    # the reference as in the port (tests/recurrent_bf16_witness.py: JAX
    # and the port on the CPU, per seed alike, 0.07-0.34 at one group);
    # a head's output normalised after a sum near 0 flips with a rounding.
    # The gate holds the two forms in float32 (another draw of weights).
    out["teacher_forcing_bf16"] = teacher_forcing_recurrent(
        dev, cfg, model, params, xl, "xlstm bf16", gate=False)
    out["teacher_forcing"] = teacher_forcing_recurrent(
        dev, *float32_twin(dev, cfg, xl["seed"]), xl, "xlstm float32")
    torch.cuda.empty_cache()

    # layer 0's mLSTM: two chunks of attn_chunk against its recurrence
    p0, dt = params["stack"]["mlstm"][0][0], getattr(torch, cfg.dtype)
    L = xl["block_tokens"]
    toks = torch.from_numpy(np.random.default_rng(xl["seed"] + 2).integers(
        0, cfg.vocab_size, (1, L))).to(dev)
    with torch.no_grad():
        x = LL.apply_norm(p0["ln"], model._embed(params, toks), cfg.norm)

    def mlstm(x, recurrent):
        if recurrent is None:
            return XL.mlstm_block(p0["cell"], x, cfg, chunk=cfg.attn_chunk,
                                  dtype=dt)[0]
        ys, st = [], None
        for t in range(x.shape[1]):
            y, st = XL.mlstm_block(p0["cell"], x[:, t:t + 1], cfg, state=st,
                                   dtype=dt)
            ys.append(y)
        return torch.cat(ys, dim=1)

    out["layer0_mlstm"] = block_parallel_vs_recurrent("xlstm", mlstm, x)
    out["layer0_mlstm"]["chunks"] = L // cfg.attn_chunk
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["reduced"] = reduced_recurrent_cpu_vs_cuda(dev, xl["arch"], "xlstm")
    del params, model, x
    torch.cuda.empty_cache()

    # training through the reference's own example, at full size
    tr = xl["train"]
    torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        hist = T.main(["--arch", xl["arch"], "--steps", str(tr["steps"]),
                       "--batch", str(tr["batch"]), "--seq", str(tr["seq"]),
                       "--ckpt-dir", str(ROOT / "chip_smoke_ckpt"),
                       "--log-every", "1"], device=dev)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    done = re.search(r"done: (\d+) steps, ([\d.]+)s, (\d+) tok/s", text)
    check(done is not None and len(hist) == tr["steps"],
          f"xlstm train: {text[-400:]}")
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"xlstm train: losses {losses}, grad norms {norms}")
    out["train"] = {"batch": tr["batch"], "seq": tr["seq"],
                    "steps": tr["steps"], "microbatches": cfg.microbatches,
                    "remat": cfg.remat, "losses": losses,
                    "grad_norms": norms, "loop_s": float(done.group(2)),
                    "step_s": float(done.group(2)) / tr["steps"],
                    "tokens_per_s": float(done.group(3)), "cli_s": wall,
                    "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    t_ = out["train"]
    log(f"xlstm train (launch.train --arch {xl['arch']}, B={tr['batch']} x "
        f"S={tr['seq']}, {cfg.microbatches} microbatches, remat "
        f"{cfg.remat}): {tr['steps']} steps in {t_['loop_s']:.1f} s "
        f"({t_['step_s']:.2f} s a step, first included; "
        f"{t_['tokens_per_s']:.0f} tok/s), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, grad norms {[round(n, 4) for n in norms]}, peak "
        f"{t_['peak_gb']:.2f} GB; the CLI {wall:.1f} s with the weights")
    torch.cuda.empty_cache()
    log("xlstm: " + json.dumps(out))
    return out


def phase_hybrid(dev, hy: dict = HYBRID) -> dict:
    """The Mamba2 hybrid on the card; see the module docstring, item 16."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import layers as LL
    from repro_torch.models import ssm as SSM

    cfg = get_config(hy["arch"])
    G = cfg.num_layers // cfg.hybrid_group
    out: dict = {"arch": cfg.name, "num_layers": cfg.num_layers,
                 "d_model": cfg.d_model,
                 "groups": f"{G} x ({cfg.hybrid_group - 1} Mamba2 + the "
                           "shared attention)",
                 "ssm": "heads {1}, head dim {2}, state {3}, d_inner "
                        "{0}".format(*SSM.ssm_dims(cfg))}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, _ = make_serve_step(cfg, dev)
    params = model.init(hy["seed"])
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = model.param_count(params)
    out["weights_gb"] = weight_bytes(params) / 1e9
    log(f"hybrid: {cfg.name}, {out['groups']}, {out['params']:,} parameters "
        f"({out['weights_gb']:.3f} GB) drawn in {out['init_s']:.2f} s")

    out.update(recurrent_serve(dev, cfg, params, hy, "hybrid"))
    c = model.init_cache(2, 8)
    check(tuple(c["attn"]["k"].shape)[:2] == (G, 2)
          and c["ssm"].dtype == torch.bfloat16,
          f"hybrid states: KV {tuple(c['attn']['k'].shape)}, SSM "
          f"{c['ssm'].dtype}")
    del c
    # as phase xlstm: the served bf16 model's two forms reported (the
    # gated per-head RMS norm; tests/recurrent_bf16_witness.py), the gate
    # in float32
    out["teacher_forcing_bf16"] = teacher_forcing_recurrent(
        dev, cfg, model, params, hy, "hybrid bf16", gate=False)
    out["teacher_forcing"] = teacher_forcing_recurrent(
        dev, *float32_twin(dev, cfg, hy["seed"]), hy, "hybrid float32")
    torch.cuda.empty_cache()

    # layer 0's Mamba2: the SSD's chunks against its recurrence
    p0, dt = params["stack"]["mamba"][0][0], getattr(torch, cfg.dtype)
    L, chunk = hy["block_tokens"], min(cfg.attn_chunk, 256)
    toks = torch.from_numpy(np.random.default_rng(hy["seed"] + 2).integers(
        0, cfg.vocab_size, (1, L))).to(dev)
    with torch.no_grad():
        x = LL.apply_norm(p0["ln"], model._embed(params, toks), cfg.norm)
    conv0 = SSM.init_conv_cache(cfg, 1, dev, dt)

    def mamba(x, recurrent):
        if recurrent is None:
            return SSM.mamba2_block(p0["cell"], x, cfg, chunk=chunk,
                                    dtype=dt)[0]
        ys, st, conv = [], None, conv0
        for t in range(x.shape[1]):
            y, st, conv = SSM.mamba2_block(p0["cell"], x[:, t:t + 1], cfg,
                                           state=st, conv_cache=conv,
                                           dtype=dt)
            ys.append(y)
        return torch.cat(ys, dim=1)

    out["layer0_mamba2"] = block_parallel_vs_recurrent("hybrid", mamba, x)
    out["layer0_mamba2"]["chunks"] = L // chunk
    del x

    # the parallel forward of make_prefill_step (the loss), at full size
    _, prefill = make_prefill_step(cfg, dev)
    B, S = hy["prefill_batch"], hy["prefill_seq"]
    rng = np.random.default_rng(hy["seed"] + 3)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (B, S))).to(dev),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, (B, S))).to(dev)}
    loss = prefill(params, batch)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    loss = float(prefill(params, batch))
    out["prefill_loss_s"] = time.perf_counter() - t0
    out["prefill_loss"] = loss
    out["prefill_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["prefill_transient_gb"] = (torch.cuda.max_memory_allocated(dev)
                                   - before) / 1e9
    check(np.isfinite(loss), f"hybrid parallel forward: loss {loss}")
    log(f"hybrid parallel forward (make_prefill_step, the loss) at B={B} "
        f"S={S}: {out['prefill_loss_s']:.3f} s, loss {loss:.4f}, peak "
        f"{out['prefill_peak_gb']:.2f} GB ({out['prefill_transient_gb']:.2f}"
        f" GB above the weights)")
    out["reduced"] = reduced_recurrent_cpu_vs_cuda(dev, hy["arch"], "hybrid")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, model
    torch.cuda.empty_cache()
    log("hybrid: " + json.dumps(out))
    return out


def _tree_to(tree, dev):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return [_tree_to(v, dev) for v in tree]


def train_flops(cfg, B: int, S: int) -> float:
    """The floating-point operations of one train step of the dense model:
    2 a multiply-add; the products of every layer and the head forward,
    twice that backward, the layers' forward once more under remat "full";
    attention's QK^T and PV over the whole (S, S) score matrix the plain
    route computes, at the same multiples."""
    D, H, KV, hd, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    T = B * S
    layer = 2 * T * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * Fd)
    layer += 2 * 2 * B * H * S * S * hd
    head = 2 * T * D * cfg.padded_vocab
    remat = 1 if cfg.remat == "full" else 0
    return float(cfg.num_layers * layer * (3 + remat) + head * 3)


def resume_bitwise(train_step, init_fn, batches, steps: int, fail_at: int,
                   ckpt_every: int, ckpt_dir, ref) -> dict:
    """``steps`` steps through ``TrainLoop`` from ``init_fn()``, checkpoints
    every ``ckpt_every`` steps in ``ckpt_dir``, a failure injected at step
    ``fail_at``, then a resume from the newest checkpoint to the end; the
    final parameters must equal ``ref`` (the uninterrupted run's, on the
    host) bit for bit.  The checkpoints are removed at the end."""
    import shutil

    import torch

    from repro_torch.runtime import FaultConfig, SimulatedFailure, TrainLoop
    from repro_torch.tree import tree_leaves

    out = {}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        loop = TrainLoop(train_step, FaultConfig(
            ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every,
            fail_at_step=fail_at))
        params, opt = init_fn()
        t0 = time.perf_counter()
        try:
            loop.run(params, opt, batches(0, steps))
            check(False, "train: the injected failure did not fire")
        except SimulatedFailure:
            pass
        out["failed_run_s"] = time.perf_counter() - t0
        out["checkpoints"] = sorted(p.name for p in ckpt_dir.iterdir())
        del params, opt
        torch.cuda.empty_cache()
        loop = TrainLoop(train_step, FaultConfig(ckpt_dir=str(ckpt_dir),
                                                 ckpt_every=ckpt_every))
        t0 = time.perf_counter()
        start, params, opt = loop.resume_or(init_fn)
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t0
        check(start == fail_at, f"train resumed at step {start}")
        t0 = time.perf_counter()
        params, opt, _ = loop.run(params, opt, batches(start, steps),
                                  start_step=start)
        out["resumed_run_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(all(torch.equal(a.cpu(), b)
              for a, b in zip(tree_leaves(params), ref)),
          "train: the resumed run's parameters differ from the "
          "uninterrupted run's")
    return out


def reduced_train(dev, tr: dict, ckpt_dir, steps: int, tag: str) -> dict:
    """The reduced config of ``tr["arch"]`` at 2 microbatches:
    ``reduced_steps`` steps on the CPU and twice on the card, the card runs
    bitwise equal and within TRAIN_REL_L2 of the CPU's; then ``steps``
    steps through ``TrainLoop`` with a failure at ``fail_at`` and a
    checkpoint every ``reduced_ckpt_every`` steps, resumed and held bitwise
    to the uninterrupted run on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    out = {}
    rcfg = dataclasses.replace(get_config(tr["arch"]).reduced(),
                               microbatches=2)
    rdata = SyntheticLMData(rcfg.vocab_size, tr["reduced_batch"],
                            tr["reduced_seq"], seed=1)
    _, _, rinit, _ = make_train_step(rcfg, "cpu")
    init = rinit(tr["seed"])

    def rinit_on(device):
        return tuple(tree_map(lambda x: x.to(device, copy=True), t)
                     for t in init)

    finals = []
    for device in ("cpu", dev, dev):
        _, rstep, _, _ = make_train_step(rcfg, device)
        p, o = rinit_on(device)
        for t in range(tr["reduced_steps"]):
            p, o, _ = rstep(p, o, rdata.batch_at(t))
        finals.append([x.cpu() for x in tree_leaves(p)])
    check(all(torch.equal(a, b) for a, b in zip(finals[1], finals[2])),
          f"{tag} reduced: two card runs differ")
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(finals[1], finals[0]))
    den = sum(float(b.double().square().sum()) for b in finals[0])
    out["reduced_cpu_rel_l2"] = (num / den) ** 0.5
    check(out["reduced_cpu_rel_l2"] <= TRAIN_REL_L2,
          f"{tag} reduced: card against cpu, relative L2 "
          f"{out['reduced_cpu_rel_l2']:.3e} > {TRAIN_REL_L2}")
    p, o = rinit_on(dev)
    for t in range(steps):
        p, o, _ = rstep(p, o, rdata.batch_at(t))
    out["reduced_resume"] = resume_bitwise(
        rstep, lambda: rinit_on(dev),
        lambda lo, hi: (rdata.batch_at(t) for t in range(lo, hi)), steps,
        tr["fail_at"], tr["reduced_ckpt_every"], ckpt_dir,
        [x.cpu() for x in tree_leaves(p)])
    log(f"{tag} reduced {rcfg.name}: {tr['reduced_steps']} steps, two card "
        f"runs equal, card against cpu relative L2 "
        f"{out['reduced_cpu_rel_l2']:.3e}; the failure at step "
        f"{tr['fail_at']} with a checkpoint every {tr['reduced_ckpt_every']} "
        f"steps resumed bitwise ({json.dumps(out['reduced_resume'])})")
    return out


def phase_train(dev, tr: dict = TRAIN) -> dict:
    """LM training on the card; see the module docstring, item 17."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as T
    from repro_torch.serving import prefetch_batches, stage_batch
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(tr["arch"]),
                              num_layers=tr["num_layers"])
    check(cfg.remat == "full" and cfg.microbatches == 2
          and not cfg.tie_embeddings, f"train config {cfg}")
    B, S, steps = tr["batch"], tr["seq"], tr["steps"]
    out: dict = {"arch": cfg.name, "num_layers": cfg.num_layers,
                 "batch": B, "seq": S, "remat": cfg.remat,
                 "microbatches": cfg.microbatches, "card": card_line()}
    model, train_step, init_state = T.build(cfg, dev, lr=tr["lr"])
    data = SyntheticLMData(cfg.vocab_size, B, S, seed=tr["seed"])

    def batches(lo, hi):
        return prefetch_batches((data.batch_at(t) for t in range(lo, hi)),
                                functools.partial(stage_batch, device=dev),
                                depth=2)

    ckpt_dir = ROOT / "chip_smoke_ckpt"
    FA.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) the uninterrupted run, each step timed
    params, opt = init_state(tr["seed"])
    out["params"] = model.param_count(params)
    state_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves((params, opt)))
    out["state_gb"] = state_bytes / 1e9
    times, losses = [], []
    EW.reset_launch_counts()
    for b in batches(0, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = train_step(params, opt, b)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)), f"train losses {losses}")
    out["silu_stepwise_launches_per_step"] = \
        EW.LAUNCHES["silu_stepwise"] / steps
    check(EW.LAUNCHES["silu_stepwise"] > 0,
          "training made no silu_stepwise launch")
    out["losses"] = losses
    out["step_s"] = times
    out["step_median_s"] = statistics.median(times[1:])
    out["tokens_per_s"] = B * S / out["step_median_s"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["flop_per_step"] = train_flops(cfg, B, S)
    out["bf16_peak_share"] = (out["flop_per_step"] / out["step_median_s"]
                              / TENSOR_BF16_FLOPS)
    check(FA.LAUNCHES["flash_attention"] == 0,
          "training launched the flash kernel (it runs the plain route)")
    log(f"train {cfg.name} x{cfg.num_layers} layers, {out['params']:,} "
        f"parameters, B={B} S={S}: step {out['step_median_s']:.3f} s "
        f"(median of steps 2-{steps}), {out['tokens_per_s']:.1f} tokens/s, "
        f"peak {out['peak_gb']:.2f} GB, {out['flop_per_step']:.3e} FLOP a "
        f"step = {out['bf16_peak_share']:.3f} of the dense bf16 peak; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; card {out['card']}")
    prof_batch = stage_batch(data.batch_at(steps), dev)
    out["profile_step"] = profile_window(
        lambda: train_step(params, opt, prof_batch))
    log(f"train profiled step: {json.dumps(out['profile_step'])}")
    del params, opt, met, prof_batch
    torch.cuda.empty_cache()

    # (b) the reduced config: the card twice, bitwise, and against the CPU;
    # the failure at step 6 with a checkpoint every 2 steps, resumed
    # through TrainLoop (the full-width resume, a 26.6 GB checkpoint
    # written and read in 75-85 s, is cut for the script's time)
    out.update(reduced_train(dev, tr, ckpt_dir, steps, "train"))
    log("train: " + json.dumps(out))
    return out


def moe_drops(cfg, seen: list) -> dict:
    """Capacity drops of the routes ``moe_routes`` recorded: assignments
    past their expert's ``capacity(cfg, T)`` of each call's T tokens."""
    import torch

    from repro_torch.models.moe import capacity

    dropped = total = 0
    for top_e in seen:
        T = top_e.shape[0]
        counts = torch.zeros(cfg.num_experts, dtype=torch.int64,
                             device=top_e.device).scatter_add_(
            0, top_e.reshape(-1), torch.ones_like(top_e.reshape(-1)))
        dropped += int((counts - capacity(cfg, T)).clamp(min=0).sum())
        total += top_e.numel()
    return {"calls": len(seen), "assignments": total, "dropped": dropped,
            "share": dropped / max(total, 1)}


def phase_train_moe(dev, tr: dict = TRAIN_MOE) -> dict:
    """MoE training on the card; see the module docstring, item 17b."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import roofline as RL
    from repro_torch.launch import train as T
    from repro_torch.serving import prefetch_batches, stage_batch
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(tr["arch"]),
                              num_layers=tr["num_layers"])
    check(cfg.remat == "full" and cfg.microbatches == 8
          and cfg.num_experts == 8 and cfg.num_experts_per_tok == 2,
          f"train_moe config {cfg}")
    B, S, steps = tr["batch"], tr["seq"], tr["steps"]
    out: dict = {"arch": cfg.name, "num_layers": cfg.num_layers,
                 "batch": B, "seq": S, "remat": cfg.remat,
                 "microbatches": cfg.microbatches, "card": card_line()}
    model, train_step, init_state = T.build(cfg, dev, lr=tr["lr"])
    data = SyntheticLMData(cfg.vocab_size, B, S, seed=tr["seed"])

    def batches():
        return prefetch_batches((data.batch_at(t) for t in range(steps)),
                                functools.partial(stage_batch, device=dev),
                                depth=2)

    def run(record: bool):
        """``steps`` steps from ``init_state(seed)``: (params, opt, step
        seconds, losses, the first step's routes)."""
        t0 = time.perf_counter()
        params, opt = init_state(tr["seed"])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        times, losses, seen = [], [], []
        for t, b in enumerate(batches()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with moe_routes(seen) if record and t == 0 else \
                    contextlib.nullcontext():
                params, opt, met = train_step(params, opt, b)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return params, opt, times, losses, seen, init_s

    FA.reset_launch_counts()
    EW.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, opt, times, losses, seen, out["init_s"] = run(True)
    out["silu_stepwise_launches_per_step"] = \
        EW.LAUNCHES["silu_stepwise"] / steps
    check(EW.LAUNCHES["silu_stepwise"] > 0,
          "train_moe made no silu_stepwise launch")
    check(FA.LAUNCHES["flash_attention"] == 0,
          "training launched the flash kernel (it runs the plain route)")
    check(all(np.isfinite(losses)), f"train_moe losses {losses}")
    out["params"] = model.param_count(params)
    out["state_gb"] = sum(x.numel() * x.element_size()
                          for x in tree_leaves((params, opt))) / 1e9
    out["losses"] = losses
    out["step_s"] = times
    out["step_median_s"] = statistics.median(times[1:])
    out["tokens_per_s"] = B * S / out["step_median_s"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["drops"] = moe_drops(cfg, seen)
    n_total, n_active = RL.count_params(cfg)
    out["count_params"] = [n_total, n_active]
    out["model_flops"] = RL.model_flops(
        cfg, dict(kind="train", batch=B, seq=S), n_total, n_active)
    out["bf16_peak_share"] = (out["model_flops"] / out["step_median_s"]
                              / RL.HW["peak_flops_bf16"])
    log(f"train_moe {cfg.name} x{cfg.num_layers} layer, {out['params']:,} "
        f"parameters ({out['state_gb']:.2f} GB of parameters, m and v; drawn "
        f"in {out['init_s']:.2f} s), B={B} S={S}, {cfg.microbatches} "
        f"microbatches, remat {cfg.remat}: step {out['step_median_s']:.3f} s "
        f"(median of steps 2-{steps}), {out['tokens_per_s']:.1f} tokens/s, "
        f"peak {out['peak_gb']:.2f} GB, {out['model_flops']:.3e} model FLOP "
        f"a step (6 x {n_active:.4e} active x {B * S} tokens) = "
        f"{out['bf16_peak_share']:.3f} of the dense bf16 peak; drops "
        f"{out['drops']['dropped']} of {out['drops']['assignments']} "
        f"assignments in {out['drops']['calls']} routings; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; card {out['card']}")

    # the same steps again from the same seed: bit for bit
    t0 = time.perf_counter()
    ref = [x.to("cpu", copy=True) for x in tree_leaves((params, opt))]
    out["host_copy_s"] = time.perf_counter() - t0
    del params, opt
    torch.cuda.empty_cache()
    params, opt, times2, losses2, _, _ = run(False)
    out["step_s_run2"] = times2
    check(losses2 == losses, f"train_moe: two runs' losses {losses} and "
          f"{losses2} differ")
    leaves = tree_leaves((params, opt))
    check(len(leaves) == len(ref) and all(
        torch.equal(a, b.to(dev)) for a, b in zip(leaves, ref)),
          "train_moe: two runs from the same seed end in different "
          "parameters, m or v")
    log(f"train_moe: two runs of {steps} steps from seed {tr['seed']} end "
        f"bit for bit equal ({len(leaves)} leaves: parameters, m, v; the "
        f"first copied to the host in {out['host_copy_s']:.1f} s)")
    del params, opt, leaves, ref
    torch.cuda.empty_cache()

    # the reduced config: the card twice, bitwise, and against the CPU;
    # the failure at step 6 with a checkpoint every 2 steps, resumed
    out.update(reduced_train(dev, tr, ROOT / "chip_smoke_ckpt",
                             tr["reduced_resume_steps"], "train_moe"))
    log("train_moe: " + json.dumps(out))
    return out


# ---------------------------------------------------------------- phase 8
def leaf_checksums(tree):
    """One exact int64 checksum of every leaf's float32 bits, on the card
    (the bits weighted by their position mod 65,521 and summed in int64,
    which wraps: integer sums in any order give the same value): equal
    leaves give equal checksums."""
    import torch

    from repro_torch.tree import tree_leaves

    sums = []
    for t in tree_leaves(tree):
        w = t.detach().reshape(-1).view(torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, w.numel(), 1 << 24):
            c = w[i:i + (1 << 24)].to(torch.int64)
            pos = torch.arange(i, i + c.numel(), dtype=torch.int64,
                               device=t.device) % 65521 + 1
            acc += (c * pos).sum()
        sums.append(acc)
    return torch.stack(sums).cpu().numpy()


def leaf_samples(tree) -> list:
    """Every TRAIN_TP_SAMPLE-th element of each leaf (float32, on the
    host), in tree order."""
    from repro_torch.tree import tree_leaves

    return [t.detach().reshape(-1)[::TRAIN_TP_SAMPLE].float().cpu().numpy()
            for t in tree_leaves(tree)]


def train_tp_cfg(spec: dict):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    return dataclasses.replace(cfg, num_layers=spec["num_layers"],
                               dtype=spec.get("dtype", cfg.dtype),
                               remat=spec.get("remat", cfg.remat))


def train_tp_run(run: dict, spec: dict) -> dict:
    """``run`` with a part's own batch, sequence or steps."""
    return dict(run, **spec.get("run", {}))


def fsdp_serve(cfg, dev, mesh, spec: dict, seed: int, feed=None) -> dict:
    """Phase train_tp (d)'s serving: the bf16 model from ``seed`` (a
    rank's blocks drawn a leaf at a time, ``draw_blocks``, over ``mesh``;
    the whole tree without one), the prefill at ``spec["serve"]
    ["prefill"]`` with flash, then ``spec["serve"]["decode"]`` greedy
    decode steps fed ``feed`` (the no-mesh route's tokens; its own greedy
    tokens where None).  Returns the place's rows of the prefill's and
    each step's logits (float32, on the host), the global tokens fed and
    picked, and over a mesh its flash launches' shapes, the bytes of each
    kind (``GATHERED``) and seconds of the prefill and a decode step, its
    peak and launches after the cut (``rank_start``, ``rank_end``)."""
    import numpy as np
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch.sharding import activation_rules
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import build_model

    B, S = spec["serve"]["prefill"]
    steps = spec["serve"]["decode"]
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                  dtype=np.int32)
    out = {}
    if mesh is None:
        params = build_model(cfg, dev).init(seed)
    else:
        params = draw_blocks(cfg, dev, mesh, seed)
        out.update({f"serve/{k}": v for k, v in rank_start(
            dev, params).items()})
    _, prefill = make_prefill_step(cfg, dev, mesh=mesh)
    _, serve = make_serve_step(cfg, dev, mesh=mesh)
    ax = None if mesh is None else activation_rules(cfg, mesh, B)["batch"]

    def global_tokens(logits):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return M.gather_stack(tok, M.axis_group(mesh, ax)).reshape(-1) \
            if ax is not None else tok

    def gathered():
        return np.asarray([M.GATHERED[k] for k in sorted(M.GATHERED)])

    TP_CALLS.flash = []
    M.reset_gathered()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens,
                                     "cache_seq": S + steps})
    torch.cuda.synchronize(dev)
    out["serve/prefill_s"] = np.float64(time.perf_counter() - t0)
    out["serve/prefill_gathered"] = gathered()
    out["serve/flash"] = np.asarray(json.dumps(TP_CALLS.flash))
    out["serve/prefill_logits"] = logits.float().cpu().numpy()
    tok = global_tokens(logits)
    fed, picked, step_s, step_logits, step_gathered = [], [], [], [], []
    for i in range(steps):
        if feed is not None:
            tok = torch.as_tensor(feed[i], device=dev)
        fed.append(tok.cpu().numpy())
        M.reset_gathered()
        t0 = time.perf_counter()
        tok, lg, cache = serve(params, {"token": tok[:, None],
                                        "pos": S + i, "cache": cache})
        torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        step_gathered.append(gathered())
        step_logits.append(lg.float().cpu().numpy())
        picked.append(tok.cpu().numpy())
    out.update({"serve/fed": np.stack(fed), "serve/picked": np.stack(picked),
                "serve/step_s": np.asarray(step_s),
                "serve/step_logits": np.stack(step_logits),
                "serve/step_gathered": np.stack(step_gathered),
                "serve/gathered_keys": np.asarray(json.dumps(
                    sorted(M.GATHERED)))})
    if mesh is not None:
        out.update({f"serve/{k}": v for k, v in rank_end(dev).items()})
    del params, logits, cache, lg
    torch.cuda.empty_cache()
    return out


def train_tp_rank(rank: int, world: int, backend: str, store: str,
                  out_dir: str, device: str, parts: dict, run: dict) -> None:
    """One gloo rank of phase train_tp (started with spawn): for each part
    of ``parts``, a ``DeviceMesh`` of its shape (device type cpu: it only
    holds the groups); a part with ``serve`` first runs ``fsdp_serve``
    on its bf16 blocks; then the rank's float32 blocks (``draw_blocks``,
    a leaf at a time), the part's ``run["steps"]`` steps of
    ``make_train_step(mesh=)`` on the global batches; each step's loss,
    grad_norm, seconds, bytes and gathers (forward, FSDP, backward,
    remat), the checksums of its blocks after it, its peak, launches and
    samples of its final blocks go to ``rank<r>.npz`` under the part's
    tag."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import GATHERED, reset_gathered
    from repro_torch.launch.sharding import replica_axes
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=DIST_GROUP_TIMEOUT_S))
    out = {}
    try:
        for tag, spec in parts.items():
            cfg, run_p = train_tp_cfg(spec), train_tp_run(run, spec)
            mesh = init_device_mesh("cpu", spec["mesh"],
                                    mesh_dim_names=("data", "model"))
            got, t_part = {}, time.perf_counter()
            if spec.get("serve"):
                torch.cuda.reset_peak_memory_stats(dev)
                with flash_spy():
                    got.update(fsdp_serve(cfg, dev, mesh, spec,
                                          run_p["seed"], spec["feed"]))
                dist.barrier()
            torch.cuda.reset_peak_memory_stats(dev)
            params = draw_blocks(cfg, dev, mesh, run_p["seed"], master=True)
            opt_cfg = AdamWConfig(lr=run_p["lr"],
                                  moment_dtype=cfg.opt_dtype)
            _, step, _, _ = make_train_step(cfg, dev, opt_cfg, mesh=mesh)
            opt = init_opt_state(params, opt_cfg)
            got.update(rank_start(dev, params))
            # the float32 bytes of the leaves whole over data: the
            # gradient sum over data moves these, the FSDP leaves' not
            shapes = Model(cfg, torch.device("meta")).init(master=True)
            reps = replica_axes(cfg, shapes, mesh)
            whole = 0
            for (path, _), t in zip(tree_leaves_with_path(shapes),
                                    tree_leaves(params)):
                rep = reps
                for k in path:
                    rep = rep[k]
                whole += t.numel() * 4 if "data" in rep else 0
            got["data_whole_gb"] = np.float64(whole / 1e9)
            data = SyntheticLMData(cfg.vocab_size, run_p["batch"],
                                   run_p["seq"], seed=run_p["seed"])
            rows = {k: [] for k in ("loss", "grad_norm", "step_s",
                                    "checksums")}
            rows.update({f"gathered_{k}": [] for k in GATHERED})
            for t in range(run_p["steps"]):
                batch = data.batch_at(t)
                reset_gathered()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize(dev)
                rows["step_s"].append(time.perf_counter() - t0)
                rows["loss"].append(float(met["loss"]))
                rows["grad_norm"].append(float(met["grad_norm"]))
                for k, v in GATHERED.items():
                    rows[f"gathered_{k}"].append(v)
                rows["checksums"].append(leaf_checksums(params))
            got.update(rank_end(dev))
            got["part_s"] = np.float64(time.perf_counter() - t_part)
            got.update({k: np.asarray(v) for k, v in rows.items()})
            for i, a in enumerate(leaf_samples(params)):
                got[f"sample/{i}"] = a
            out.update({f"{tag}/{k}": v for k, v in got.items()})
            del params, opt, step, got
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **out)


def emulated_backward_on_card(dev) -> dict:
    """Whether two threads' backward passes can meet in a collective on
    one card, as an emulated mesh's places would: each thread runs a
    backward through a function whose backward waits (at most 2 s) for
    the other thread's at a barrier.  PyTorch's autograd engine runs a
    card's backward nodes on one worker thread of that device, so the
    first node to wait holds the only thread that could run the other's."""
    import threading as th

    import torch

    barrier = th.Barrier(2, timeout=2)

    class Meet(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            barrier.wait()
            return g

    done, errors = [], []

    def place():
        x = torch.ones(4, device=dev, requires_grad=True)
        try:
            Meet.apply(x * 2).sum().backward()
        except th.BrokenBarrierError as e:
            errors.append(type(e).__name__)
            return
        done.append(True)

    t0 = time.perf_counter()
    threads = [th.Thread(target=place) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    check(not any(t.is_alive() for t in threads),
          "emulated backward on the card: a thread still ran after 30 s")
    return {"met": len(done) == 2, "errors": errors,
            "seconds": time.perf_counter() - t0}


def phase_train_tp(dev, parts: dict = TRAIN_TP,
                   run: dict = TRAIN_TP_RUN) -> dict:
    """Training over a (data x model) mesh (``launch.steps.
    make_train_step(mesh=)``): ``TRAIN_TP``'s four parts over 4 gloo
    ranks on this card, after the no-mesh route of each in the script's
    process (see ``TRAIN_TP``; part (d)'s serving first, ``fsdp_serve``).
    The emulated mesh does not run a backward on the card
    (``emulated_backward_on_card``): the ranks are held to the no-mesh
    route, to each other where they hold the same leaf, and on the CPU to
    the emulation bit for bit (``tests/test_torch_dist_train*``,
    ``tests/test_torch_dist_fsdp.py``)."""
    import tempfile
    import types

    import numpy as np
    import torch

    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.sharding import replica_axes, shard_params
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    out = {"card": card_line()}
    t_phase = time.perf_counter()
    out["emulated_backward"] = emulated_backward_on_card(dev)
    log(f"train_tp: two threads' backward meeting on the card: "
        f"{json.dumps(out['emulated_backward'])}")
    axes = ("data", "model")
    refs, parts = {}, {tag: dict(spec) for tag, spec in parts.items()}
    for tag, spec in parts.items():
        cfg, run_p = train_tp_cfg(spec), train_tp_run(run, spec)
        ref = {"loss": [], "grad_norm": [], "step_s": []}
        t_part = time.perf_counter()
        if spec.get("serve"):
            torch.cuda.reset_peak_memory_stats(dev)
            ref["serve"] = fsdp_serve(cfg, dev, None, spec, run_p["seed"])
            ref["serve_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            spec["feed"] = list(ref["serve"]["serve/fed"])
            log(f"train_tp {tag} no-mesh serving: {cfg.name} "
                f"x{cfg.num_layers} ({cfg.dtype}), prefill "
                f"{spec['serve']['prefill']} "
                f"{float(ref['serve']['serve/prefill_s']):.3f} s, decode "
                f"steps {[round(float(x), 4) for x in ref['serve']['serve/step_s']]} "
                f"s, peak {ref['serve_peak_gb']:.2f} GB")
        opt_cfg = AdamWConfig(lr=run_p["lr"], moment_dtype=cfg.opt_dtype)
        _, step, init, _ = make_train_step(cfg, dev, opt_cfg)
        data = SyntheticLMData(cfg.vocab_size, run_p["batch"], run_p["seq"],
                               seed=run_p["seed"])
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt = init(run_p["seed"])
        for t in range(run_p["steps"]):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, data.batch_at(t))
            torch.cuda.synchronize(dev)
            ref["step_s"].append(time.perf_counter() - t0)
            ref["loss"].append(float(met["loss"]))
            ref["grad_norm"].append(float(met["grad_norm"]))
        ref["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        ref["params"] = sum(t.numel() for t in tree_leaves(params))
        del opt, met, step
        torch.cuda.empty_cache()
        d, m = spec["mesh"]
        stand_in = types.SimpleNamespace(shape=dict(zip(axes, (d, m))),
                                         axis_names=axes)
        ref["samples"] = []
        for r in range(d * m):
            coords = {"data": r // m, "model": r % m}
            mine = shard_params(cfg, params, stand_in, coords=coords)
            ref["samples"].append(leaf_samples(mine))
            del mine
        shapes = Model(cfg, torch.device("meta")).init(master=True)
        reps = replica_axes(cfg, shapes, stand_in)
        ref["groups"] = []
        for path, _ in tree_leaves_with_path(shapes):
            rep = reps
            for k in path:
                rep = rep[k]
            cut = [a for a in axes if a not in rep]
            groups: dict = {}
            for r in range(d * m):
                c = {"data": r // m, "model": r % m}
                groups.setdefault(tuple(c[a] for a in cut), []).append(r)
            ref["groups"].append([g for g in groups.values() if len(g) > 1])
        del params
        torch.cuda.empty_cache()
        ref["no_mesh_s"] = time.perf_counter() - t_part
        refs[tag] = ref
        log(f"train_tp {tag} no-mesh: {cfg.name} x{cfg.num_layers} "
            f"({cfg.dtype}), "
            f"{ref['params']:,} parameters, losses {ref['loss']}, "
            f"grad_norms {ref['grad_norm']}, steps "
            f"{[round(x, 3) for x in ref['step_s']]} s, peak "
            f"{ref['peak_gb']:.2f} GB")
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    ranks_all = run_ranks(train_tp_rank, 4, "gloo",
                          pathlib.Path(tmp.name) / "ranks",
                          lambda r: str(dev), TRAIN_TP_DEADLINE_S,
                          "train_tp", parts, run)
    out["ranks_s"] = time.perf_counter() - t0
    tmp.cleanup()
    for tag, spec in parts.items():
        cfg, ref = train_tp_cfg(spec), refs.pop(tag)
        run_p = train_tp_run(run, spec)
        name = f"train_tp {tag} gloo x4"
        ranks = part_of(ranks_all, tag)
        rows = []
        for r, got in enumerate(ranks):
            check(np.all(np.isfinite(got["loss"])),
                  f"{name} rank {r}: losses {got['loss']}")
            for k in ("loss", "grad_norm"):
                check(np.array_equal(got[k], ranks[0][k]),
                      f"{name}: rank {r}'s {k} {got[k]} differ from rank "
                      f"0's {ranks[0][k]}")
            rel = {k: [abs(a - b) / abs(b) for a, b in zip(got[k], ref[k])]
                   for k in ("loss", "grad_norm")}
            for k, v in rel.items():
                check(max(v) <= LM_MAX_REL_L2,
                      f"{name} rank {r}: {k} {list(got[k])} against the "
                      f"no-mesh route's {ref[k]}: relative {v}")
            want = ref["samples"][r]
            num = sum(float(((got[f"sample/{i}"].astype(np.float64)
                              - w.astype(np.float64)) ** 2).sum())
                      for i, w in enumerate(want))
            den = sum(float((w.astype(np.float64) ** 2).sum()) for w in want)
            params_l2 = (num / den) ** 0.5
            check(params_l2 <= LM_MAX_REL_L2,
                  f"{name} rank {r}: blocks after {run_p['steps']} steps "
                  f"{params_l2:.3e} (relative L2, sampled) from the "
                  f"no-mesh route's")
            launches = json.loads(str(got["launches"]))
            check(launches.get("silu_stepwise", 0) > 0
                  and launches.get("flash_attention", 0) == 0,
                  f"{name} rank {r}: launches {launches}")
            rows.append({
                "step_s": [float(x) for x in got["step_s"]],
                "timed_step_s": float(np.mean(got["step_s"][1:])),
                "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
                "params_rel_l2_sampled": params_l2,
                **{f"{k}_a_step": [int(x) for x in got[f"gathered_{k}"]]
                   for k in ("bytes", "calls", "fsdp_bytes", "fsdp_calls",
                             "bwd_bytes", "bwd_calls", "fsdp_bwd_bytes",
                             "fsdp_bwd_calls", "remat_bytes",
                             "remat_calls")},
                # of "bytes": the float32 gradients' one sum over the
                # batch axes (data's d places) a step, of the leaves whole
                # over data (an FSDP leaf's gradient is complete already)
                "grad_sum_bytes_a_step": (spec["mesh"][0] * int(round(
                    float(got["data_whole_gb"]) * 1e9))
                    if spec["mesh"][0] > 1 else 0),
                "peak_gb": float(got["peak_gb"]),
                "peak_gb_init": float(got["peak_gb_init"]),
                "params_gb": float(got["params_gb"]),
                "launches": launches})
            if spec.get("serve"):
                rows[-1]["serve"] = hold_fsdp_serve(
                    got, ref["serve"], spec, cfg, r, name)
                check(max(rows[-1]["peak_gb"],
                          rows[-1]["serve"]["peak_gb"])
                      <= TRAIN_TP_FSDP_PEAK_GB,
                      f"{name} rank {r}: peak after the cut "
                      f"{rows[-1]['peak_gb']:.2f} GB training, "
                      f"{rows[-1]['serve']['peak_gb']:.2f} GB serving "
                      f"(gate {TRAIN_TP_FSDP_PEAK_GB} GB)")
        held = 0
        for step in range(run_p["steps"]):
            for i, groups in enumerate(ref["groups"]):
                for g in groups:
                    for r in g[1:]:
                        check(ranks[r]["checksums"][step][i]
                              == ranks[g[0]]["checksums"][step][i],
                              f"{name}: leaf {i} differs on ranks {g} "
                              f"after step {step}")
                        held += 1
        out[tag] = {"per_rank": rows, "no_mesh": {
            k: ref[k] for k in ("loss", "grad_norm", "step_s", "peak_gb",
                                "params", "no_mesh_s")},
            "ranks_part_s": max(float(g["part_s"]) for g in ranks),
            "replica_pairs_held": held}
        if spec.get("serve"):
            out[tag]["no_mesh"]["serve_peak_gb"] = ref["serve_peak_gb"]
        log(f"{name} on one card: {cfg.name} x{cfg.num_layers} on mesh "
            f"{spec['mesh']}, {run_p['steps']} steps at B={run_p['batch']} "
            f"S={run_p['seq']}, losses {[float(x) for x in ranks[0]['loss']]} "
            f"(no-mesh {ref['loss']}), grad_norms "
            f"{[float(x) for x in ranks[0]['grad_norm']]} "
            f"(no-mesh {ref['grad_norm']}); every replicated leaf equal on "
            f"its ranks after every step ({held} leaf-rank pairs); the "
            f"part {ref['no_mesh_s']:.2f} s without a mesh, "
            f"{out[tag]['ranks_part_s']:.2f} s on the ranks; "
            f"card {out['card']}")
        for r, row in enumerate(rows):
            log(f"  {name} rank {r}: " + json.dumps(row))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"train_tp: the ranks ran the {len(parts)} parts in "
        f"{out['ranks_s']:.2f} s; the phase {out['seconds']:.2f} s")
    return out


def hold_fsdp_serve(got: dict, ref: dict, spec: dict, cfg, r: int,
                    name: str) -> dict:
    """Phase train_tp (d)'s serving on rank ``r`` against the no-mesh
    route's: its rows of the prefill's and each decode step's logits
    within LM_MAX_REL_L2 (relative L2 over the real vocab), the tokens it
    was fed the no-mesh route's, one flash launch at its (B_loc, S, S,
    heads, kv heads, head dim) and no other; returns its bytes and
    seconds for the log."""
    import numpy as np

    d, m = spec["mesh"]
    B, S = spec["serve"]["prefill"]
    b = B // d
    rows = slice((r // m) * b, (r // m + 1) * b)
    V = cfg.vocab_size

    def rel_l2(a, w):
        a, w = a[..., :V].astype(np.float64), w[..., :V].astype(np.float64)
        return float(np.sqrt(((a - w) ** 2).sum() / (w ** 2).sum()))

    errs = [rel_l2(got["serve/prefill_logits"],
                   ref["serve/prefill_logits"][rows])]
    errs += [rel_l2(got["serve/step_logits"][i],
                    ref["serve/step_logits"][i][rows])
             for i in range(spec["serve"]["decode"])]
    check(max(errs) <= LM_MAX_REL_L2,
          f"{name} rank {r} serving: logits {errs} (relative L2) from the "
          f"no-mesh route's")
    check(np.array_equal(got["serve/fed"], ref["serve/fed"]),
          f"{name} rank {r} serving: fed other tokens than the no-mesh "
          f"route's")
    want = [[b, S, S, cfg.num_heads // m, cfg.num_kv_heads // m,
             cfg.head_dim, True, 0]]
    flash = json.loads(str(got["serve/flash"]))
    launches = json.loads(str(got["serve/launches"]))
    check(flash == want and launches.get("flash_attention", 0) == 1,
          f"{name} rank {r} serving: flash {flash}, launches {launches}, "
          f"want one at {want[0]}")
    keys = json.loads(str(got["serve/gathered_keys"]))
    return {"prefill_s": float(got["serve/prefill_s"]),
            "decode_step_s": [float(x) for x in got["serve/step_s"]],
            "prefill_gathered": dict(zip(keys, map(
                int, got["serve/prefill_gathered"]))),
            "decode_gathered_a_step": [dict(zip(keys, map(int, g)))
                                       for g in got["serve/step_gathered"]],
            "logits_rel_l2": errs,
            "greedy_as_no_mesh": bool(np.array_equal(
                got["serve/picked"], ref["serve/picked"])),
            "flash": flash, "launches": launches,
            "peak_gb": float(got["serve/peak_gb"]),
            "peak_gb_draw": float(got["serve/peak_gb_init"]),
            "params_gb": float(got["serve/params_gb"])}


def time_ms(fn, inner: int, samples: int = 21) -> float:
    """Median per-call time over ``samples`` CUDA-event windows of ``inner``
    calls each, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def time_graph_ms(fn, inner: int, samples: int = 21) -> float:
    """Median per-call device time of ``inner`` calls captured in one CUDA
    graph and replayed: the kernels' own time, without the host's cost of
    each launch, which ``time_ms`` includes once a kernel is shorter than
    that cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    ACCUMULATED["cuda_graph_captures"] += 1
    ACCUMULATED["cuda_graph_replays"] += samples + 1
    return time_ms(graph.replay, 1, samples) / inner


def profile_window(fn, warmup: bool = True, lead: bool = True,
                   order: bool = False) -> dict:
    """One warm call of ``fn`` timed on the host clock, then one under
    ``torch.profiler``: the device kernels it launched, their summed device
    time, and the device's idle share of the unprofiled wall time.  The
    profiled call is also bracketed by CUDA events on the stream
    (``event_span_s``: first event to last, every kernel and gap between);
    where the profiler records no kernel (it recorded none in some windows
    of one long launch on the H100), ``idle_share_events`` (1 - span /
    wall, floored at 0, a lower bound of the idle share) stands in, and
    busy_s says not measured.  The profiler runs a warm-up step (a call
    of ``fn`` whose records it drops) before the recorded one: on the
    H100 a first step lost its first 3 device activities in every window
    that ``--profile-diag 8`` took without it (24 of 24).  Whole windows
    are still lost at times (see ``phase_times``).  ``warmup=False``
    records the first step (only for ``--profile-diag``).  ``lead`` (the
    default) launches a ``torch.cuda._sleep`` of ``LEAD_SPIN_CYCLES``
    (``spin_kernel``, about 50 ms) ahead of the recorded call, counted
    apart as ``lead_kernels`` and left out of every other count: late in a
    long run the profiler drops the device activities that start within
    some milliseconds of its window's start (in a whole-script run on the
    H100, every try of phase times' one-super-step window lost its
    set-up kernels and its 10 ms parsa_scan and kept the merge after it,
    and the scan window lost its one 72 ms launch), and the spin moves the
    recorded call's kernels past that stretch.  ``order`` adds each port
    kernel's launch times in the order they started
    (``port_kernels_us``)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ACCUMULATED["profiler_sessions"] += 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=int(warmup), active=1,
                                   repeat=1)) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        if lead:
            torch.cuda._sleep(LEAD_SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        prof.step()
    span = a.elapsed_time(b) / 1e3
    # the device timeline also carries the step's own range
    # ("ProfilerStep*"), which is no kernel
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]
    out = {"wall_s": wall, "device_kernels": len(kern), "event_span_s": span}
    if lead:
        out["lead_kernels"] = sum("spin_kernel" in e.name for e in kern)
        kern = [e for e in kern if "spin_kernel" not in e.name]
        out["device_kernels"] = len(kern)
    if not kern:
        out["busy_s"] = out["idle_share"] = "not measured"
        out["idle_share_events"] = max(0.0, 1 - span / wall)
        return out
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    ours = collections.defaultdict(list)
    first_port = None   # the start of the window's first port kernel
    for e in sorted(kern, key=lambda e: e.time_range.start):
        for name in ("cost_tile_kernel", "select_reduce_kernel",
                     "sketch_select_kernel", "parsa_scan_kernel",
                     "refine_sweep_kernel",
                     "union_delta_kernel", "flash_wgmma", "flash_fma"):
            if name in e.name:
                ours[name].append(e.time_range.elapsed_us())
                if first_port is None or e.time_range.start < first_port:
                    first_port = e.time_range.start
    if first_port is not None:
        out["other_kernels_from_port"] = sum(
            e.time_range.start >= first_port for e in kern) - sum(
            len(v) for v in ours.values())
    out.update(busy_s=busy, idle_share=1 - busy / wall,
               port_kernels_mean_us={n: statistics.mean(v)
                                     for n, v in ours.items()},
               port_kernels_count={n: len(v) for n, v in ours.items()},
               **({"port_kernels_us": dict(ours)} if order else {}),
               top=collections.Counter(e.name[:60] for e in kern)
               .most_common(8))
    return out


def note_launches() -> None:
    """Add the port's kernel launches counted on the phase just run (its
    wrappers' counts, each phase resets them at its start) to
    ``ACCUMULATED``."""
    from repro_torch.kernels import elementwise as EW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.parsa_cost import ops

    ACCUMULATED["port_launches_on_paths"] += sum(
        sum(d.values()) for d in (ops.LAUNCHES, FA.LAUNCHES, EW.LAUNCHES))


def accumulated(dev) -> dict:
    """What the process holds or has done ahead of a profile window:
    ``ACCUMULATED``, the caching allocator's counts, the live threads;
    CUPTI's activity buffers are not visible from Python."""
    import torch

    stats = torch.cuda.memory_stats(dev)
    return {**ACCUMULATED, "threads": threading.active_count(),
            "allocations": stats.get("allocation.all.allocated", 0),
            "alloc_retries": stats.get("num_alloc_retries", 0),
            "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9,
            "reserved_gb": torch.cuda.memory_reserved(dev) / 1e9,
            "cupti_buffers": "not measured (not visible from Python)"}


def times_windows(rank: int, world: int, backend: str, store: str,
                  out_dir: str, device: str, payload: str,
                  diag: int) -> None:
    """Phase times' profile windows in a process of their own (started
    with spawn, one of it): a fresh CUDA context and a fresh profiler.
    Late in a whole-script run the profiler lost whole windows in the
    script's process (ROADMAP Queue 3 item 5); here nothing has
    accumulated.  ``payload`` holds the arrays the windows read, made by
    phase times from the main, sketch and parallel paths' inputs (the same
    work): the main graph's packed blocks, the sketch graph's, the
    parallel path's blocks by worker, and the main run's sets.  Each
    window is taken again while it lacks a port kernel its call launched,
    at most 6 tries, or 12 for the two the parent's check reads; the
    profiles, the tries, what had accumulated before the first window and
    the profiled sketched scan's sets go to ``rank0.npz``."""
    import numpy as np
    import torch

    from repro_torch.core.partition import _parallel_scan
    from repro_torch.kernels.parsa_cost import ops, popcount32

    global PROFILE_DIAG
    PROFILE_DIAG = diag
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    a = dict(np.load(payload))

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    main = [T(a[f"main/{k}"])[None] for k in PACKED_KEYS]
    sk = [T(a[f"sketch/{k}"])[None] for k in PACKED_KEYS]
    par = [T(a[f"par/{k}"]) for k in PACKED_KEYS]
    s = T(a["s_masks"])
    k_, W = s.shape
    nb_main, B = main[4].shape[1:]
    scan_s = torch.zeros((1, k_, W), dtype=torch.int32, device=dev)
    scan_sz = torch.zeros((1, k_), dtype=torch.int32, device=dev)
    scan_parts = torch.full((1, nb_main, B), -1, dtype=torch.int32,
                            device=dev)

    def scan_kernel():
        scan_s.zero_()
        scan_sz.zero_()
        scan_parts.fill_(-1)
        ops.parsa_scan(*main, scan_s, scan_sz, scan_parts)

    Ws_ = sk[3].shape[-1]
    sk_state = [torch.zeros((1, k_, Ws_), dtype=torch.int32, device=dev),
                torch.zeros((1, k_), dtype=torch.int32, device=dev),
                torch.full(sk[4].shape, -1, dtype=torch.int32, device=dev)]

    def sketch_scan():
        sk_state[0].zero_()
        sk_state[1].zero_()
        sk_state[2].fill_(-1)
        ops.parsa_scan(*sk, *sk_state)

    m = int(a["merge_every"])
    nb_per = par[4].shape[1]

    def parallel_scan(every=m):
        _parallel_scan(*par, torch.zeros((k_, W), dtype=torch.int32,
                                         device=dev),
                       torch.zeros(k_, dtype=torch.int32, device=dev), every)

    cw = 32
    n_ch = -(-W // cw)
    need_pad = torch.nn.functional.pad(s, (0, n_ch * cw - W))
    words_all = need_pad.view(k_, n_ch, cw).transpose(0, 1).contiguous()
    prev_all = torch.full((n_ch, 32 * cw), -1, dtype=torch.int32, device=dev)
    cost = popcount32(s).sum(dim=1, dtype=torch.int32)
    n_steps_par = nb_per // m
    windows = (
        ("scan", scan_kernel, {"parsa_scan_kernel": 1}),
        ("sketched scan", sketch_scan, {"parsa_scan_kernel": 1}),
        ("parallel scan", parallel_scan,
         {"parsa_scan_kernel": n_steps_par,
          "union_delta_kernel": n_steps_par}),
        ("parallel scan, one super-step", lambda: parallel_scan(nb_per),
         {"parsa_scan_kernel": 1, "union_delta_kernel": 1}),
        ("refine", lambda: ops.refine_scan(words_all, prev_all, cost, 2),
         {"refine_sweep_kernel": 1}))
    before = accumulated(dev)
    log(f"times windows process: accumulated before the first window "
        f"{json.dumps(before)}")
    if diag:
        profile_diag([(n, f, 0, w) for n, f, w in windows], diag)
    profiles = {}
    for name, fn, want in windows:
        for tries in range(1, 13 if name.startswith("parallel") else 7):
            prof = profile_window(fn)
            if prof.get("port_kernels_count") == want:
                break
        prof["tries"] = tries
        profiles[name] = prof
    np.savez(pathlib.Path(out_dir) / "rank0.npz",
             profiles=np.asarray(json.dumps(profiles)),
             accumulated=np.asarray(json.dumps(before)),
             sketch_sets=sk_state[0][0].cpu().numpy())


def profile_diag(windows, runs: int) -> None:
    """How often ``profile_window`` records every port kernel that a
    window launched, with and without its warm-up profiler step and with a
    lead kernel ahead of the recorded call: ``runs`` windows of each kind,
    the modes interleaved.  Logged only (``--profile-diag N``)."""
    modes = {"no warm-up": dict(warmup=False, lead=False),
             "warm-up": dict(warmup=True, lead=False),
             "warm-up, lead kernel": dict(warmup=True, lead=True)}
    for name, fn, _, want in windows:
        if name == "sketched scan":
            continue
        seen = {mode: [] for mode in modes}
        for _ in range(runs):
            for mode, kw in modes.items():
                prof = profile_window(fn, **kw)
                seen[mode].append((prof.get("port_kernels_count") == want,
                                   prof["device_kernels"],
                                   prof.get("lead_kernels")))
        log(f"profile diag {name} (want {want}): " + json.dumps({
            mode: {"whole": sum(w for w, _, _ in v), "runs": len(v),
                   "device_kernels": [d for _, d, _ in v],
                   "lead_kernels": [x for _, _, x in v]}
            for mode, v in seen.items()}))


PACKED_KEYS = ("widx", "vals", "tr_ids", "tr_masks", "valid")
# phase times: the main scan's blocks its plain version runs over (a
# quarter of the 391; the whole scan's plain version took 30-38 s)
SCAN_PLAIN_BLOCKS = 98


def bound_ms(nbytes: int, nops: int) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / CORE_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def scan_schedule(valid_counts, B: int, k: int) -> tuple[int, int]:
    """The rounds ``parsa_scan`` runs over blocks with ``valid_counts``
    real rows each, from equal sizes: a block's rounds stop once no
    unretired row is left (a block of padding rows runs none), and a
    round's enabled slots each pick a row while any is left.  Returns
    (rounds run, unretired rows summed over those rounds)."""
    sizes = [0] * k
    rounds = rows = 0
    for live in valid_counts:
        for r in range(1 + -(-(B - 1) // k) if live else 0):
            rounds += 1
            rows += live
            if r == 0:   # catch-up: the partitions at the minimum size
                m = min(sizes)
                picks = [i for i in range(k) if sizes[i] == m][:live]
            else:
                picks = list(range(min(k, live)))
            for i in picks:
                sizes[i] += 1
            live -= len(picks)
            if not live:
                break
    return rounds, rows


def time_once_ms(fn) -> float:
    """One call of ``fn`` between CUDA events (a plain version too slow to
    repeat)."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def phase_times(dev, main: dict) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core.partition import (
        _pad_block_stack, _trunc_flags, pack_graph_blocks)
    from repro_torch.kernels.parsa_cost import (
        merge_worker_sets_ref, ops, parsa_cost_ref, parsa_scan_ref,
        popcount32, rebuild_block, refine_sweep_ref, select_greedy_from_cost,
        sketch_select_rows_ref)

    g, res = main["graph"], main["result"]
    order = np.random.default_rng(0).permutation(g.num_u)
    packed = pack_graph_blocks(g, BLOCK, order=order)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def block0(pk, block):
        return rebuild_block(T(pk.widx[0]), T(pk.vals[0]), T(pk.tr_ids[0]),
                            T(pk.tr_masks[0]))[:block]

    # block 0 of the main run against the final sets: the select's shapes
    nbr = block0(packed, BLOCK)
    s = T(res.s_masks)
    B, W = nbr.shape
    retired = T(np.random.default_rng(1).random(B) < 0.5)
    order_k = torch.arange(K, dtype=torch.int32, device=dev)
    enabled = torch.ones(K, dtype=torch.bool, device=dev)
    tile = ops.parsa_select_tile(nbr, s)
    # refine: the first chunk of the main run's need words, second sweep
    cw = 32
    words = s[:, :cw].contiguous()
    prev = T(res.parts_v[: 32 * cw].astype(np.int32))
    cost = popcount32(s).sum(dim=1, dtype=torch.int32)

    def tile_work(nb_, k):
        """Bytes and operations of a (U, k) cost tile of ``nb_``: the block's
        words, the partition words under its nonzero columns and the
        output; 3 operations a (nonzero word, partition) pair."""
        nzm = nb_ != 0
        return (4 * (nb_.numel() + k * int(nzm.any(0).sum())
                     + k * nb_.shape[0]), 3 * int(nzm.sum()) * k)

    def measure(kern, plain, inner, plain_inner, nbytes, nops) -> dict:
        saved = dict(ops.LAUNCHES)
        ms = time_graph_ms(kern, inner)
        eager_ms = time_ms(kern, inner)
        plain_ms = time_ms(plain, plain_inner)
        ops.LAUNCHES.update(saved)  # timing launches are not path launches
        b_ms, b_by = bound_ms(nbytes, nops)
        return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by}

    def log_time(name, t, shape=""):
        log(f"time {name}{shape}: {t['ms'] * 1e3:.2f} us in a CUDA graph, "
            f"{t['eager_ms'] * 1e3:.2f} us per eager launch (plain "
            f"{t['plain_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.3f} "
            f"us by {t['bound_by']}); no single PyTorch call computes it, "
            f"so library_ms is null")

    def row(name, launches, path, **extra):
        return {"name": name, "route": "cuda", "source": KERNELS[name][1],
                "replaces": KERNELS[name][0], "launches": launches,
                "launches_path": path,
                "max_abs_err": main["checks"][name]["max_abs_err"],
                "cases": main["checks"][name]["cases"], **extra,
                "library_ms": None}

    def at_shapes(name, shapes) -> dict:
        """Time ``name`` at each of its path's shapes: (label, launches on
        the path, kernel call, plain call, inner, plain inner, bytes,
        operations).  The first shape is the row's own."""
        out = {}
        for (label, n_path, kern, plain, inner, plain_inner, nbytes,
             nops) in shapes:
            t = measure(kern, plain, inner, plain_inner, nbytes, nops)
            t.update(launches=n_path, bound_bytes=nbytes, bound_ops=nops)
            log_time(name, t, f" ({label}; {n_path} launches on its path)")
            out[label] = t
        return out

    def as_row(name, launches, path, shapes):
        first = next(iter(shapes.values()))
        top = {key: first[key] for key in ("ms", "eager_ms", "plain_ms",
                                           "bound_ms", "bound_by")}
        return row(name, launches, path, shape=next(iter(shapes)), **top,
                   shapes=shapes)

    rows = []
    launches = main["launches"]
    per_round = main["per_round"]
    pr_exact, pr_sketch = (per_round["exact k=64"],
                           per_round["sketch collapse k=56"])
    n_blocks = -(-g.num_u // BLOCK)
    # parsa_cost on host_blocked_oracle: one K = k tile a block and one
    # K = 1 down-date a vertex (100,000 of its 100,391 launches), against
    # the complement ~(N(u) & ~S_i) of row 0 and partition 0
    comp = ~(nbr[:1] & ~s[:1])
    rows.append(as_row(
        "parsa_cost", launches["parsa_cost"],
        "host_blocked_oracle, main graph", at_shapes("parsa_cost", [
            (f"K=1 down-date, B={B}, W={W}", g.num_u,
             lambda: ops.parsa_cost(nbr, comp),
             lambda: parsa_cost_ref(nbr, comp), 100, 5, *tile_work(nbr, 1)),
            (f"K={K} block tile, B={B}, W={W}", n_blocks,
             lambda: ops.parsa_cost(nbr, s),
             lambda: parsa_cost_ref(nbr, s), 100, 5, *tile_work(nbr, K))])))
    # parsa_select_tile at the per-round route's shape (block 0 of the main
    # graph packed at B = 1,024, against that route's final k = 64 sets)
    # and at the main shape
    nbr_pr = block0(pack_graph_blocks(g, PER_ROUND_BLOCK, order=order),
                    PER_ROUND_BLOCK)
    s_pr = T(pr_exact["s_masks"])
    k_pr = s_pr.shape[0]
    rows.append(as_row(
        "parsa_select_tile", pr_exact["launches"]["parsa_select_tile"],
        f"per-round route, device_scan k={k_pr} B={PER_ROUND_BLOCK}, main "
        "graph", at_shapes("parsa_select_tile", [
            (f"B={PER_ROUND_BLOCK}, W={W}, k={k_pr}",
             pr_exact["launches"]["parsa_select_tile"],
             lambda: ops.parsa_select_tile(nbr_pr, s_pr),
             lambda: parsa_cost_ref(nbr_pr, s_pr).T.contiguous(), 50, 2,
             *tile_work(nbr_pr, k_pr)),
            (f"B={B}, W={W}, k={K}", 0,
             lambda: ops.parsa_select_tile(nbr, s),
             lambda: parsa_cost_ref(nbr, s).T.contiguous(), 100, 5,
             *tile_work(nbr, K))])))
    t = measure(
        lambda: ops.parsa_select_reduce(tile, retired, order_k, enabled),
        lambda: select_greedy_from_cost(tile.T, retired, order_k, enabled),
        100, 2, 4 * K * B + B + 4 * K + K + 8 * K, 2 * K * B)
    rows.append(row(
        "parsa_select_reduce", pr_exact["launches"]["parsa_select_reduce"],
        f"per-round route, device_scan k=64 B={PER_ROUND_BLOCK}, main "
        "graph", shape=f"B={B}, W={W}, k={K}", **t))
    log_time("parsa_select_reduce", t, f" (B={B}, W={W}, k={K})")

    # parsa_scan: the main path's whole scan, one launch, against its plain
    # version once, on the same inputs.  The bound counts what the scan
    # needs of these inputs: bytes of each row's nonzero pairs and the pair
    # that ends its list, the valid flags, the side channel's ids and the
    # truncated rows' words, S read and written, sizes and parts; the
    # operations of every row's first cost (3 a nonzero pair and
    # partition) and of each round's k slot minima over its unretired rows
    # (2 a row and slot), for the rounds the scan runs (scan_schedule).
    arrays = [T(x)[None] for x in (packed.widx, packed.vals, packed.tr_ids,
                                   packed.tr_masks, packed.valid)]
    nb_main = packed.valid.shape[0]
    scan_s = torch.zeros((1, K, W), dtype=torch.int32, device=dev)
    scan_sz = torch.zeros((1, K), dtype=torch.int32, device=dev)
    scan_parts = torch.full((1, nb_main, B), -1, dtype=torch.int32,
                            device=dev)

    def scan_kernel():
        scan_s.zero_()
        scan_sz.zero_()
        scan_parts.fill_(-1)
        ops.parsa_scan(*arrays, scan_s, scan_sz, scan_parts)

    saved = dict(ops.LAUNCHES)
    scan_ms = time_ms(scan_kernel, 1, 5)
    check(np.array_equal(scan_s[0].cpu().numpy(), res.s_masks),
          "timed parsa_scan sets != the main path's")
    # the plain version over the scan's first SCAN_PLAIN_BLOCKS blocks,
    # against the kernel over the same blocks, bit for bit (the whole
    # scan's plain version took 30-38 s of the script: a depth cut for
    # its time limit)
    nb_p = min(SCAN_PLAIN_BLOCKS, nb_main)
    head_m = [x[:, :nb_p].contiguous() for x in arrays]
    states = [[torch.zeros_like(scan_s), torch.zeros_like(scan_sz),
               torch.full((1, nb_p, B), -1, dtype=torch.int32, device=dev)]
              for _ in range(2)]
    prefix_ms = time_once_ms(lambda: ops.parsa_scan(*head_m, *states[0]))
    plain_ms = time_once_ms(lambda: parsa_scan_ref(*head_m, *states[1]))
    check(all(torch.equal(a, b) for a, b in zip(*states)),
          f"parsa_scan != parsa_scan_ref on the main scan's first {nb_p} "
          "blocks")
    ops.LAUNCHES.update(saved)
    n_run, live_rows = scan_schedule(packed.valid.sum(1).tolist(), B, K)
    vals_np = packed.vals
    pairs = int((vals_np != 0).sum()) + int(packed.valid.sum())
    n_tr = int(packed.trunc.sum())
    nnz = int((vals_np[~packed.trunc] != 0).sum()) + int(
        (packed.tr_masks != 0).sum())
    scan_bytes = (8 * pairs + packed.valid.size + 4 * packed.tr_ids.size
                  + 4 * W * n_tr + 2 * 4 * K * W + 8 * K
                  + 4 * int(packed.valid.sum()))
    scan_ops = 3 * K * nnz + 2 * K * live_rows
    b_ms, b_by = bound_ms(scan_bytes, scan_ops)
    rows.append(row(
        "parsa_scan", launches["parsa_scan"],
        f"device_scan, main graph (1 a scan; "
        f"{main['sketch']['launches']['parsa_scan']} on the sketch path, "
        f"{main['parallel']['launches']['parsa_scan']} on the parallel path)",
        shape=f"the main scan: {nb_main} blocks, B={B}, W={W}, k={K}, "
              f"{n_tr} truncated rows",
        ms=scan_ms, plain_ms=plain_ms, plain_blocks=nb_p,
        prefix_ms=prefix_ms, bound_ms=b_ms, bound_by=b_by,
        bound_bytes=scan_bytes, bound_ops=scan_ops, rounds_run=n_run,
        rounds_nominal=main["rounds"], per_round_us=scan_ms * 1e3 / n_run))
    log(f"time parsa_scan (whole main scan, {n_run} rounds run of "
        f"{main['rounds']}): {scan_ms:.3f} ms, {scan_ms * 1e3 / n_run:.2f} "
        f"us a round; bound {b_ms * 1e3:.2f} us by {b_by} ({scan_bytes:,} "
        f"bytes, {scan_ops:,} operations); its first {nb_p} blocks "
        f"{prefix_ms:.3f} ms, plain {plain_ms:.1f} ms, bit for bit")

    # refine: one chunk and one sweep (as in earlier PRs), and the main
    # path's whole refine, one launch: sweeps x chunks x 1,024 dependent
    # steps
    t = measure(lambda: ops.refine_sweep_chunk(words, prev, cost),
                lambda: refine_sweep_ref(words, prev, cost), 20, 1,
                4 * (K * cw + 2 * 32 * cw + 2 * K), 6 * 32 * cw * K)
    n_ch = -(-W // cw)
    need_pad = torch.nn.functional.pad(s, (0, n_ch * cw - W))
    words_all = need_pad.view(K, n_ch, cw).transpose(0, 1).contiguous()
    prev_all = torch.full((n_ch, 32 * cw), -1, dtype=torch.int32, device=dev)
    saved = dict(ops.LAUNCHES)
    whole_ms = time_ms(lambda: ops.refine_scan(words_all, prev_all, cost, 2),
                       1, 11)
    _, parts_all = ops.refine_scan(words_all, prev_all, cost, 2)
    ops.LAUNCHES.update(saved)
    check(np.array_equal(parts_all.view(-1)[: g.num_v].cpu().numpy(),
                         res.parts_v), "timed refine parts != the main path's")
    steps = 2 * n_ch * 32 * cw
    wb_ms, wb_by = bound_ms(4 * (K * W + 2 * 32 * n_ch * cw + 2 * K),
                            2 * 6 * 32 * n_ch * cw * K)
    rows.append(row(
        "refine_sweep", launches["refine_sweep"],
        "device_scan, main graph: the whole refine, 2 sweeps x "
        f"{n_ch} chunks", shape=f"one chunk, one sweep: k={K}, cw={cw}",
        **t, whole_ms=whole_ms, whole_bound_ms=wb_ms, whole_bound_by=wb_by,
        chain_steps=steps, ns_per_step=whole_ms * 1e6 / steps))
    log_time("refine_sweep", t, f" (one chunk, one sweep, k={K}, cw={cw})")
    log(f"time refine (whole, one launch, {steps:,} dependent steps): "
        f"{whole_ms:.3f} ms, {whole_ms * 1e6 / steps:.1f} ns a step; bound "
        f"{wb_ms * 1e3:.3f} us by {wb_by}")
    wall = main["timings"]["partition_u"] + main["timings"]["partition_v"]
    busy = (scan_ms + whole_ms) / 1e3
    log(f"kernel time on the main path ~ {busy:.4f} s of {wall:.4f} s "
        f"scan+refine wall ({100 * busy / wall:.1f}%)")

    # sketch_select at the sketch path's shape (block 0 of the acceptance
    # run, B=1024, Ws=4096) and at the main path's (B=256, W=2048), on the
    # scan's own row lists.  Two bounds: the bytes of the compact inputs
    # the function needs (each row's nonzero pairs and the one padding
    # pair that ends it, the truncation flags, the dense words of truncated
    # rows, the set words at the block's nonzero columns), which the row's
    # share is against, and the dense contract's (the (B, Ws) block and the
    # (k, Ws) sets).  The padded lists the kernel reads, (B, cap) pairs,
    # are logged beside them.
    sk = main["sketch"]
    sg = sk["graph"]
    packed_s = pack_graph_blocks(sg, SKETCH_BLOCK, order=np.random.default_rng(
        0).permutation(sg.num_u))
    nbr_a = block0(packed_s, SKETCH_BLOCK)
    s_a = T(sk["result"].s_masks)
    ret_a = T(np.random.default_rng(1).random(SKETCH_BLOCK) < 0.5)
    timed = {}
    for shape, (pk, nb_, s_, r_) in (("acceptance", (packed_s, nbr_a, s_a,
                                                     ret_a)),
                                     ("main", (packed, nbr, s, retired))):
        Bs, Ws = nb_.shape
        rows_ = (T(pk.widx[0]), T(pk.vals[0]),
                 _trunc_flags(T(pk.tr_ids[0]), Bs))
        cap = rows_[0].shape[1]
        nzm = nb_ != 0
        nz, nz_cols = int(nzm.sum()), int(nzm.any(0).sum())
        n_trs = int(rows_[2].sum())
        live = ~rows_[2]
        pairs_s = int(torch.clamp((rows_[1][live] != 0).sum(1) + 1,
                                  max=cap).sum())
        nops = 3 * nz * K + 2 * K * Bs
        rest = Bs + 4 * Ws * n_trs + 4 * K * nz_cols + Bs + 8 * K
        compact, padded = 8 * pairs_s + rest, 8 * Bs * cap + rest
        dense = 4 * Bs * Ws + 4 * K * Ws + Bs + 8 * K
        t = measure(
            lambda: ops.sketch_cost_select(nb_, s_, r_, order=order_k,
                                           enabled=enabled, rows=rows_),
            lambda: sketch_select_rows_ref(nb_, *rows_, s_, r_, order_k,
                                           enabled, greedy=True),
            100, 2, compact, nops)
        d_ms, d_by = bound_ms(dense, nops)
        timed[shape] = dict(
            shape=f"B={Bs}, Ws={Ws}, k={K}, cap={cap}, {nz} nonzero words, "
                  f"{n_trs} truncated rows", **t, bound_bytes=compact,
            bound_bytes_padded=padded,
            bound_ms_dense=d_ms, bound_by_dense=d_by, bound_bytes_dense=dense,
            bound_of="the compact inputs of the list route")
        log_time("sketch_select", t, f" ({timed[shape]['shape']})")
        log(f"  sketch_select bounds: {compact:,} bytes of list pairs "
            f"({pairs_s:,} of the {Bs * cap:,} padded slots) and gathered "
            f"set words {t['bound_ms'] * 1e3:.3f} us (the row's); the padded "
            f"lists the kernel reads {padded:,} bytes "
            f"{bound_ms(padded, nops)[0] * 1e3:.3f} us; the dense "
            f"contract's {dense:,} bytes {d_ms * 1e3:.3f} us")
    rows.append(row(
        "sketch_select", pr_sketch["launches"]["sketch_select"],
        f"per-round route, device_scan set_repr=sketch (exact collapse) "
        f"k=56 B={PER_ROUND_BLOCK}, main graph; 0 on the scan paths",
        **timed["acceptance"], at_main_shape=timed["main"]))

    # the merge of a super-step at the parallel path's shape (n = 8 workers'
    # (k, W) sets and sizes against the pre-merge ones) and at one worker's
    # (n = 1, B = 256): the union, the pushed-word count, the sizes and the
    # write-back into every worker's copy, which makes every call after the
    # first see copies equal to the union (the same bytes).  The bound
    # counts the n + 1 copies of the sets and sizes read and written, the
    # union and the merged sizes written, and the count.
    par = main["parallel"]
    s_old = T(res.s_masks)
    sz_old = T(np.bincount(res.parts_u, minlength=K).astype(np.int32))
    k_, W_ = s_old.shape
    merge_shapes = []
    for n, n_path, what in ((PAR["workers"], par["launches"][
            "packed_union_delta"], "parallel_device W=8 B=128"),
                            (1, par["w1_merges"],
                             f"parallel_device W=1 B={BLOCK}")):
        rng_m = np.random.default_rng(2 + n)
        grow = T(rand_words(rng_m, (n, k_, W_), 0.02))
        dsz = T(rng_m.integers(0, 20, (n, k_)).astype(np.int32))
        def merge_this(local=s_old | grow, sz_loc=sz_old + dsz,
                       pushed=torch.zeros(1, dtype=torch.int64, device=dev)):
            return ops.merge_worker_sets(local, s_old, sz_loc, sz_old, pushed)

        def merge_plain(local=s_old | grow, sz_loc=sz_old + dsz):
            return merge_worker_sets_ref(local, s_old, sz_loc, sz_old)[:2]

        nbytes = 4 * (2 * (n + 1) * k_ * W_ + 2 * (n + 1) * k_) + 8
        merge_shapes.append((f"n={n}, k={k_}, W={W_} ({what})", n_path,
                             merge_this, merge_plain, 100, 20, nbytes,
                             3 * n * k_ * W_))
    rows.append(as_row(
        "packed_union_delta", par["launches"]["packed_union_delta"],
        "parallel_device W=8 B=128 merge_every=12, main graph; "
        f"{par['w1_merges']} at W=1 B={BLOCK}",
        at_shapes("packed_union_delta", merge_shapes)))

    # where the time goes, under torch.profiler: the main path's whole scan
    # (one launch), the sketch path's whole scan (one launch), the parallel
    # path's whole scan (its blocks in the acceptance run's order: a launch
    # and a merge a super-step) and the whole refine (one launch); taken in
    # a process of their own (times_windows): late in a whole-script run
    # the profiler lost whole windows in this one (ROADMAP Queue 3 item 5)
    import tempfile

    arrays_s = [T(x)[None] for x in (packed_s.widx, packed_s.vals,
                                     packed_s.tr_ids, packed_s.tr_masks,
                                     packed_s.valid)]
    Ws_ = packed_s.tr_masks.shape[-1]
    nw, m, bp = PAR["workers"], PAR["merge_every"], PAR["block_size"]
    pk_p = _pad_block_stack(pack_graph_blocks(g, bp, order=order),
                            par["blocks"])
    nb_per = par["blocks"] // nw
    n_sk, _ = scan_schedule(packed_s.valid.sum(1).tolist(), SKETCH_BLOCK, K)
    # a worker's rounds, from equal sizes at every merge (an upper bound
    # of the rounds its stale sizes let it run)
    par_rounds = sum(scan_schedule(v, bp, K)[0] for v in
                     pk_p.valid.reshape(nw, nb_per, -1).sum(-1).tolist())
    n_steps_par = nb_per // m
    payload = {"s_masks": res.s_masks, "merge_every": np.int64(m)}
    for key in PACKED_KEYS:
        payload[f"main/{key}"] = getattr(packed, key)
        payload[f"sketch/{key}"] = getattr(packed_s, key)
        x = getattr(pk_p, key)
        payload[f"par/{key}"] = x.reshape((nw, nb_per) + x.shape[1:])
    tmp = tempfile.TemporaryDirectory()
    np.savez(pathlib.Path(tmp.name) / "payload.npz", **payload)
    del payload
    log("times: accumulated in the script's process ahead of the profile "
        f"windows {json.dumps(accumulated(dev))}")
    t0 = time.perf_counter()
    got = run_ranks(times_windows, 1, "none",
                    pathlib.Path(tmp.name) / "windows", lambda r: str(dev),
                    300, "times windows",
                    str(pathlib.Path(tmp.name) / "payload.npz"),
                    PROFILE_DIAG)[0]
    tmp.cleanup()
    profiles = json.loads(str(got["profiles"]))
    n_steps = {"scan": n_run, "sketched scan": n_sk,
               "parallel scan": par_rounds,
               "parallel scan, one super-step": par_rounds,
               "refine": steps}
    for name, prof in profiles.items():
        if isinstance(prof["busy_s"], float):
            prof["device_us_per_step"] = prof["busy_s"] * 1e6 / n_steps[name]
        log(f"profile {name} ({n_steps[name]} rounds run, or dependent "
            f"steps; {prof['tries']} tries): " + json.dumps(prof))
    log(f"times: the windows' process in {time.perf_counter() - t0:.2f} s, "
        f"tries {json.dumps({n: p['tries'] for n, p in profiles.items()})}")
    # a super-step is one parsa_scan and one merge launch and no PyTorch
    # kernel: the window of the scan's super-steps holds one of each a
    # super-step, and fewer other device kernels from its first port
    # kernel on than one a super-step beyond those of the same scan in one
    # super-step.  The set-up's kernels all start before the first port
    # kernel, and they are not counted: the profiler drops a window's
    # first device activities at times (12 of the 18 set-up kernels of the
    # one-super-step window, in every try of two whole-script runs on the
    # H100, while it kept the 9-super-step window's)
    win, one = (profiles["parallel scan"],
                profiles["parallel scan, one super-step"])
    ours = win.get("port_kernels_count", {})
    others = [p_.get("other_kernels_from_port", 0) for p_ in (win, one)]
    check(ours == {"parsa_scan_kernel": n_steps_par,
                   "union_delta_kernel": n_steps_par}
          and one.get("port_kernels_count") == {"parsa_scan_kernel": 1,
                                                "union_delta_kernel": 1}
          and others[0] - others[1] < n_steps_par - 1,
          f"parallel scan window: port kernels {ours}, other device "
          f"kernels from the first port kernel on {others[0]} "
          f"({n_steps_par} super-steps) vs {others[1]} (one): want "
          f"{n_steps_par} parsa_scan and {n_steps_par} merges and no "
          "PyTorch kernel a super-step")
    log(f"parallel scan window: {ours}; other device kernels from the "
        f"first port kernel on {others[0]} in {n_steps_par} super-steps, "
        f"{others[1]} in one; in all {win['device_kernels']} and "
        f"{one['device_kernels']}")
    check(np.array_equal(got["sketch_sets"], sk["result"].s_masks),
          "the profiled sketched scan's sets != the sketch path's")
    # the sketched scan's first SKETCH_REF_BLOCKS blocks (B=1,024, Ws=4,096:
    # the cost pass at 8 lanes a row) against parsa_scan_ref, bit for bit,
    # on the sketch path's own lists; the whole scan's plain version would
    # take minutes
    saved = dict(ops.LAUNCHES)
    nb_ref = min(SKETCH_REF_BLOCKS, packed_s.valid.shape[0])
    head = [x[:, :nb_ref].contiguous() for x in arrays_s]
    ref_out = []
    for fn in (ops.parsa_scan, parsa_scan_ref):
        st = [torch.zeros((1, K, Ws_), dtype=torch.int32, device=dev),
              torch.zeros((1, K), dtype=torch.int32, device=dev),
              torch.full_like(head[4], -1, dtype=torch.int32)]
        fn(*head, *st)
        ref_out.append(st)
    check(all(torch.equal(a, b) for a, b in zip(*ref_out)),
          f"parsa_scan != parsa_scan_ref on the sketched scan's first "
          f"{nb_ref} blocks")
    log(f"parsa_scan == parsa_scan_ref on the sketched scan's first {nb_ref} "
        f"blocks (B={SKETCH_BLOCK}, Ws={Ws_}, k={K})")
    ops.LAUNCHES.update(saved)
    rows[3]["profile"] = profiles["scan"]
    rows[3]["sketched_blocks_equal_plain"] = nb_ref
    rows[3]["parallel_profile"] = profiles["parallel scan"]
    rows[3]["profile_windows_accumulated"] = json.loads(
        str(got["accumulated"]))
    psk = profiles["sketched scan"]
    rows[3]["sketch_scan"] = {
        "rounds_run": n_sk, "busy_s": psk["busy_s"],
        "event_span_s": psk["event_span_s"], "wall_s": psk["wall_s"],
        "per_round_us": psk["event_span_s"] * 1e6 / n_sk}
    # the LM kernels' times (many CUDA graph captures) come after the
    # profile windows, so that the windows run as early as they can: late
    # in a whole-script run the profiler loses whole windows
    if "lm" in main:
        rows.append(time_flash(dev, main["lm"], main["checks"],
                               main.get("moe"), main.get("mla"),
                               main.get("encdec"), main.get("vlm"),
                               main.get("tp"), main.get("tp_all"),
                               main.get("train_tp")))
        rows.extend(time_elementwise(dev, main))
    return rows


def time_flash_windowed(dev, moe: dict) -> dict:
    """flash_attention at the MoE prefill's windowed shape, on layer 0's q,
    k, v of phase moe (B=2, S=8,192, 48/8 x 128, window 4,096): CUDA-graph
    and eager times, its plain version (``attention_ref_by_head``), and
    scaled_dot_product_attention with the window's boolean mask (K and V
    expanded to the query heads outside the timed call) as the library
    yardstick.  The bound counts the admissible (query, key) pairs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    q, k, v = (t.to(dev) for t in moe["layer0_qkv"])
    B, S, H, D = q.shape
    KV, W = k.shape[2], moe["swa_window"]
    saved = dict(FA.LAUNCHES)
    ms = time_graph_ms(lambda: FA.flash_attention(q, k, v, window=W), 5, 11)
    eager_ms = time_ms(lambda: FA.flash_attention(q, k, v, window=W), 5, 11)
    plain_ms = time_ms(lambda: attention_ref_by_head(q, k, v, W), 1, 3)
    FA.LAUNCHES.update(saved)   # timing launches are not path launches
    mask = FA.admissible(S, S, causal=True, window=W, device=dev)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
              for t in (k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 3, 7)
    pairs = int(mask.sum())
    flops = 4 * D * B * H * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TENSOR_BF16_FLOPS * 1e3
    out = {"shape": f"B={B}, S={S}, H={H}, KV={KV}, D={D}, causal, window "
                    f"{W}, {str(q.dtype).split('.')[-1]}",
           "launches": moe["prefill_flash_launches"],
           "launches_path": f"make_prefill_step {moe['arch']} B={B} S={S} "
                            f"(one per layer of {moe['num_layers']})",
           "max_abs_err": moe["layer0_attn_max_abs_err_plain"],
           "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": nbytes, "library_ms": library_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention("
                      "attn_mask=the window's (S, S) bool mask; K, V "
                      "expanded to the query heads)"}
    out["prefill_kernel_ms"] = out["launches"] * ms
    log(f"time flash_attention ({out['shape']}): {ms * 1e3:.1f} us in a "
        f"CUDA graph, {eager_ms * 1e3:.1f} us eager, plain "
        f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, bound "
        f"{out['bound_ms'] * 1e3:.1f} us by {out['bound_by']} ({flops:.3e} "
        f"FLOP, {nbytes:,} bytes); {out['launches']} launches a prefill ~ "
        f"{out['prefill_kernel_ms']:.1f} ms of its "
        f"{moe['prefill_s'] * 1e3:.1f} ms")
    del kt, vt, mask
    return out


def time_flash_mla(dev, mla: dict) -> dict:
    """flash_attention at the MLA prefill's shape, on layer 0's q, k, v of
    phase mla (B=2, S=4,096, 128 heads, q/k 192, v 128, causal): CUDA-graph
    and eager times, its plain version (``attention_ref_by_head``), and
    scaled_dot_product_attention on the same q, k and v (the backend it
    picked named, or "no backend takes it").  The bound counts the
    admissible (query, key) pairs: B H S (S + 1) (Dqk + Dv) FLOP."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    q, k, v = (t.to(dev) for t in mla["layer0_qkv"])
    B, S, H, Dqk = q.shape
    Dv = v.shape[3]
    saved = dict(FA.LAUNCHES)
    ms = time_graph_ms(lambda: FA.flash_attention(q, k, v), 5, 11)
    eager_ms = time_ms(lambda: FA.flash_attention(q, k, v), 5, 11)
    plain_ms = time_ms(lambda: attention_ref_by_head(q, k, v, None), 1, 3)
    FA.LAUNCHES.update(saved)   # timing launches are not path launches
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, None, 0.0, True)).name
    except Exception as err:   # a private query; the time stands without it
        backend = f"not named ({type(err).__name__})"
    try:
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 5, 11)
    except RuntimeError as err:
        library_ms, backend = None, f"no backend takes it ({err})"[:200]
    pairs = S * (S + 1) // 2
    flops = 2 * (Dqk + Dv) * B * H * pairs
    nbytes = q.element_size() * (q.numel() + k.numel() + 2 * v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TENSOR_BF16_FLOPS * 1e3
    out = {"shape": f"B={B}, S={S}, H={H}, KV={k.shape[2]}, Dqk={Dqk}, "
                    f"Dv={Dv}, causal, {str(q.dtype).split('.')[-1]}",
           "tensor_cores": FA.uses_tensor_cores(q, k, v),
           "launches": mla["prefill_flash_launches"],
           "launches_path": f"make_prefill_step {mla['arch']} B={B} S={S} "
                            f"(one per layer of {mla['num_layers']})",
           "max_abs_err": mla["layer0_attn_max_abs_err_plain"],
           "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": nbytes, "library_ms": library_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention("
                      f"is_causal=True), backend {backend}"}
    out["prefill_kernel_ms"] = out["launches"] * ms
    log(f"time flash_attention ({out['shape']}): {ms * 1e3:.1f} us in a "
        f"CUDA graph, {eager_ms * 1e3:.1f} us eager, plain "
        f"{plain_ms * 1e3:.1f} us, sdpa ({backend}) "
        f"{'-' if library_ms is None else f'{library_ms * 1e3:.1f}'} us, "
        f"bound {out['bound_ms'] * 1e3:.1f} us by {out['bound_by']} "
        f"({flops:.3e} FLOP, {nbytes:,} bytes); {out['launches']} launches "
        f"a prefill ~ {out['prefill_kernel_ms']:.1f} ms of its "
        f"{mla['prefill_s'] * 1e3:.1f} ms")
    return out


def time_flash_causal(dev, state: dict, plain, plain_samples: int) -> dict:
    """flash_attention at a dense prefill's causal shape, on layer 0's q,
    k, v of a phase's state (``layer0_qkv``; its ``arch``,
    ``num_layers``, ``prefill_flash_launches`` and ``prefill_s``):
    CUDA-graph and eager times, the plain version ``plain(q, k, v)``, and
    scaled_dot_product_attention (top-left causal, GQA) on the same q, k
    and v as the library yardstick, which the port never calls.  The bound
    counts the FLOPs of the admissible (query, key) pairs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    q, k, v = (t.to(dev) for t in state["layer0_qkv"])
    B, S, H, D = q.shape
    KV = k.shape[2]
    saved = dict(FA.LAUNCHES)
    ms = time_graph_ms(lambda: FA.flash_attention(q, k, v), 5, 11)
    eager_ms = time_ms(lambda: FA.flash_attention(q, k, v), 5, 11)
    plain_ms = time_ms(lambda: plain(q, k, v), 1, plain_samples)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 5, 11)
    FA.LAUNCHES.update(saved)   # timing launches are not path launches
    pairs = int(FA.admissible(S, S, causal=True, window=None,
                              device=dev).sum())
    flops = 4 * D * B * H * pairs          # QK^T and PV, 2 FLOP a product
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TENSOR_BF16_FLOPS * 1e3
    out = {"shape": f"B={B}, S={S}, H={H}, KV={KV}, D={D}, causal, "
                    f"{str(q.dtype).split('.')[-1]}",
           "tensor_cores": FA.uses_tensor_cores(q, k, v),
           "launches": state["prefill_flash_launches"],
           "launches_path": f"make_prefill_step {state['arch']} B={B} "
                            f"S={S} (one per layer of "
                            f"{state['num_layers']})",
           "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": nbytes, "library_ms": library_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention"
                      "(is_causal=True, enable_gqa=True)"}
    out["prefill_kernel_ms"] = out["launches"] * ms
    log(f"time flash_attention ({out['shape']}): {ms * 1e3:.1f} us in a "
        f"CUDA graph, {eager_ms * 1e3:.1f} us eager, plain "
        f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, bound "
        f"{out['bound_ms'] * 1e3:.1f} us by {out['bound_by']} ({flops:.3e} "
        f"FLOP, {nbytes:,} bytes); {out['launches']} launches a prefill ~ "
        f"{out['prefill_kernel_ms']:.1f} ms of its "
        f"{state['prefill_s'] * 1e3:.1f} ms")
    return out


def time_elementwise(dev, state: dict) -> list[dict]:
    """The elementwise kernels' rows of the kernels line: each timed at its
    ELEMENTWISE_SHAPES in bfloat16 (a CUDA graph and eager launches)
    beside its plain chain, the one-rounding PyTorch call (``F.silu``,
    ``F.gelu(approximate="tanh")``: the library's, rounding once, so not
    the same bits) and its bound (4 bytes an element moved; the operations
    of ELEMENTWISE_OPS against the CUDA cores); ``launches`` is phase lm's
    prefill's for silu (qwen3-14b) and phase encdec's for gelu
    (whisper-medium), beside the launches a decode step and a training
    step that the phases counted."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import elementwise as EW

    fns = {"silu_stepwise": (EW.silu_stepwise, EW.silu_stepwise_ref, F.silu),
           "gelu_stepwise": (EW.gelu_stepwise, EW.gelu_stepwise_ref,
                             lambda x: F.gelu(x, approximate="tanh"))}
    path = {"silu_stepwise": ("lm", "prefill, qwen3-14b B=2 S=4,096"),
            "gelu_stepwise": ("encdec", "prefill, whisper-medium B=8 S=224, "
                              "1,500 frames")}
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, shapes in ELEMENTWISE_SHAPES.items():
        kern, plain, lib = fns[name]
        times = {}
        for label, shape in shapes:
            x = torch.randn(shape, generator=gen, device=dev).mul_(3).to(
                torch.bfloat16)
            n = x.numel()
            saved = dict(EW.LAUNCHES)
            t = {"ms": time_graph_ms(lambda: kern(x), 20),
                 "eager_ms": time_ms(lambda: kern(x), 20),
                 "plain_ms": time_ms(lambda: plain(x), 5),
                 "library_ms": time_ms(lambda: lib(x), 20)}
            EW.LAUNCHES.update(saved)  # timing launches are not path launches
            t["bound_ms"], t["bound_by"] = bound_ms(
                4 * n, ELEMENTWISE_OPS[name] * n)
            t.update(elements=n, bound_bytes=4 * n,
                     bound_ops=ELEMENTWISE_OPS[name] * n)
            log(f"time {name} ({label}, {tuple(shape)} bf16): "
                f"{t['ms'] * 1e3:.2f} us in a CUDA graph, "
                f"{t['eager_ms'] * 1e3:.2f} us eager, plain chain "
                f"{t['plain_ms'] * 1e3:.1f} us, one-rounding library call "
                f"{t['library_ms'] * 1e3:.2f} us, bound "
                f"{t['bound_ms'] * 1e3:.3f} us by {t['bound_by']}")
            times[label] = t
            del x
        phase, what = path[name]
        first = next(iter(times.values()))
        row = {"name": name, "route": "cuda",
               "source": PORT_KERNELS[name][1],
               "replaces": PORT_KERNELS[name][0],
               "launches": state.get(phase, {}).get(
                   "prefill_elementwise_launches", {}).get(name),
               "launches_path": what,
               "max_abs_err": state["checks"][name]["max_abs_err"],
               "cases": state["checks"][name]["cases"],
               "shape": next(iter(times)),
               **{k: first[k] for k in ("ms", "eager_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
               "shapes": times}
        per_step = {}
        for ph in ("lm", "moe", "mla", "encdec", "vlm", "xlstm", "hybrid"):
            got = state.get(ph, {}).get("decode_step_elementwise_launches")
            if got and got.get(name):
                per_step[state[ph].get("arch", ph)] = got[name]
        row["launches_decode_step"] = per_step
        if name == "silu_stepwise":
            row["launches_train_step"] = {
                state[ph]["arch"]: state[ph]["silu_stepwise_launches_per_step"]
                for ph in ("train", "train_moe") if ph in state}
        rows.append(row)
    return rows


def time_flash_at(dev, B, Sq, Skv, H, KV, D, q_offset: int, launches,
                  path: str) -> dict:
    """flash_attention, causal, at one shape of a path over a mesh (phases
    tp and train_tp) on random bf16 q, k, v (query row i at position
    q_offset + i): CUDA-graph and eager
    times, its plain version, and scaled_dot_product_attention on the same
    q, k, v (is_causal with GQA where the rows start at 0; else the
    explicit (Sq, Skv) bool mask of the admissible pairs, K and V expanded
    to the query heads outside the timed call); the max abs error against
    the plain version, which must be within FLASH_TOL["bfloat16"] at
    every output; the bound counts the admissible pairs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    saved = dict(FA.LAUNCHES)

    def kern():
        return FA.flash_attention(q, k, v, q_offset=q_offset)

    want = FA.flash_attention_ref(q, k, v, q_offset=q_offset).float()
    got = kern().float()
    diff = (got - want).abs()
    err, tol = float(diff.max()), FLASH_TOL["bfloat16"]
    check(bool(torch.isfinite(got).all())
          and bool((diff <= tol + tol * want.abs()).all()),
          f"flash at {path}'s shape B={B}, Sq={Sq}, Skv={Skv}, H={H}, "
          f"KV={KV}, D={D}, q_offset={q_offset}: max abs err {err} past "
          f"tolerance {tol}")
    del want, got, diff
    ms = time_graph_ms(kern, 5, 11)
    eager_ms = time_ms(kern, 5, 11)
    plain_ms = time_ms(lambda: FA.flash_attention_ref(
        q, k, v, q_offset=q_offset), 1, 3)
    FA.LAUNCHES.update(saved)   # timing launches are not path launches
    mask = FA.admissible(Sq, Skv, causal=True, window=None, device=dev,
                         q_offset=q_offset)
    qt = q.transpose(1, 2)
    if q_offset == 0 and Sq == Skv:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 5, 11)
        library = ("torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)")
    else:
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  for t in (k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 5, 11)
        library = ("torch.nn.functional.scaled_dot_product_attention("
                   "attn_mask=the (Sq, Skv) bool mask at the query offset; "
                   "K, V expanded to the query heads)")
    pairs = int(mask.sum())
    flops = 4 * D * B * H * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TENSOR_BF16_FLOPS * 1e3
    out = {"shape": f"B={B}, Sq={Sq}, Skv={Skv}, H={H}, KV={KV}, D={D}, "
                    f"causal, q_offset={q_offset}, bfloat16",
           "tensor_cores": FA.uses_tensor_cores(q, k, v),
           "launches": launches, "launches_path": path,
           "max_abs_err": err, "ms": ms, "eager_ms": eager_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": nbytes, "library_ms": library_ms,
           "library": library}
    log(f"time flash_attention ({out['shape']}): {ms * 1e3:.1f} us in a "
        f"CUDA graph, {eager_ms * 1e3:.1f} us eager, plain "
        f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us, bound "
        f"{out['bound_ms'] * 1e3:.1f} us by {out['bound_by']} ({flops:.3e} "
        f"FLOP, {nbytes:,} bytes); max abs err {err:.3e}; {launches} "
        f"launches ({path})")
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return out


def time_flash_tp(dev, tp: dict) -> dict:
    """flash_attention at phase tp's two new shapes: a rank's heads of
    qwen3-14b on mesh (1, 4) (B=2, S=4,096, 10/2 x 128) and a rank's query
    rows under context parallel on mesh (1, 3) (B=2, 1,024 rows against
    3,072 keys, 40/8 x 128, q_offset 2,048, the last rank's)."""
    (B, S), n = TP["prefill"], TP["mesh"][1]
    cfg_h, cfg_kv = 40, 8
    (Bc, Sc), nc = TP_CP["prefill"], TP_CP["mesh"][1]
    return {
        "rank_heads": time_flash_at(
            dev, B, S, S, cfg_h // n, cfg_kv // n, 128, 0,
            tp["launches"].get("flash_attention"),
            f"phase tp (a): a rank's prefill, qwen3-14b x{TP['num_layers']} "
            f"on mesh {TP['mesh']} (one a layer) and its decode prompt's"),
        "q_offset": time_flash_at(
            dev, Bc, Sc // nc, Sc, cfg_h, cfg_kv, 128, (nc - 1) * Sc // nc,
            tp["launches_cp"].get("flash_attention"),
            f"phase tp (c): a rank's prefill, qwen3-14b "
            f"x{TP_CP['num_layers']} on mesh {TP_CP['mesh']} (one a layer, "
            f"q_offset r x {Sc // nc})")}


def time_flash_fsdp(dev, train_tp: dict) -> dict:
    """flash_attention at phase train_tp (d)'s shape: a rank's rows and
    heads of command-r-35b's serving prefill on mesh (2, 2) with FSDP
    (B=1, S=4,096, 32/4 x 128, causal), by ``time_flash_at``."""
    from repro_torch.configs import get_config

    spec = TRAIN_TP["d"]
    cfg = get_config(spec["arch"])
    (B, S), (d, m) = spec["serve"]["prefill"], spec["mesh"]
    return time_flash_at(
        dev, B // d, S, S, cfg.num_heads // m, cfg.num_kv_heads // m,
        cfg.head_dim, 0,
        train_tp["d"]["per_rank"][0]["serve"]["launches"].get(
            "flash_attention"),
        f"phase train_tp (d): a rank's FSDP serving prefill, "
        f"{spec['arch']} x{spec['num_layers']} on mesh {spec['mesh']}")


def time_flash_mla_rank(dev, tp_all: dict) -> dict:
    """flash_attention at phase tp_all (a)'s shape: a rank's 32 of
    deepseek-v2-236b's 128 heads on mesh (1, 4), B=2, S=4,096, q/k 192, v
    128, causal, on random bf16 q, k, v: CUDA-graph and eager times, its
    plain version (``attention_ref_by_head``) and
    scaled_dot_product_attention on the same q, k, v (the backend it
    picked named, or "no backend takes it"); the max abs error against the
    plain version, within FLASH_TOL["bfloat16"] at every output.  The
    bound counts the admissible pairs: B H S (S + 1) (Dqk + Dv) FLOP."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA

    spec = TP_ALL["mla"]
    (B, S), n = spec["prefill"], spec["mesh"][1]
    cfg = get_config(spec["arch"])
    H, Dqk, Dv = (cfg.num_heads // n, cfg.head_dim + cfg.rope_head_dim,
                  cfg.v_head_dim)
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k = (torch.randn((B, S, H, Dqk), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn((B, S, H, Dv), generator=gen, device=dev).to(
        torch.bfloat16)
    saved = dict(FA.LAUNCHES)
    want = attention_ref_by_head(q, k, v, None).float()
    got = FA.flash_attention(q, k, v).float()
    diff = (got - want).abs()
    err, tol = float(diff.max()), FLASH_TOL["bfloat16"]
    check(bool(torch.isfinite(got).all())
          and bool((diff <= tol + tol * want.abs()).all()),
          f"flash at phase tp_all's MLA rank shape: max abs err {err} past "
          f"tolerance {tol}")
    del want, got, diff
    ms = time_graph_ms(lambda: FA.flash_attention(q, k, v), 5, 11)
    eager_ms = time_ms(lambda: FA.flash_attention(q, k, v), 5, 11)
    plain_ms = time_ms(lambda: attention_ref_by_head(q, k, v, None), 1, 3)
    FA.LAUNCHES.update(saved)   # timing launches are not path launches
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, None, 0.0, True)).name
    except Exception as err_:  # a private query; the time stands without it
        backend = f"not named ({type(err_).__name__})"
    try:
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 5, 11)
    except RuntimeError as err_:
        library_ms, backend = None, f"no backend takes it ({err_})"[:200]
    flops = (Dqk + Dv) * B * H * S * (S + 1)
    nbytes = q.element_size() * (q.numel() + k.numel() + 2 * v.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TENSOR_BF16_FLOPS * 1e3
    launches = tp_all["launches"]["mla"].get("flash_attention")
    out = {"shape": f"B={B}, S={S}, H={H}, KV={H}, Dqk={Dqk}, Dv={Dv}, "
                    f"causal, bfloat16",
           "tensor_cores": FA.uses_tensor_cores(q, k, v),
           "launches": launches,
           "launches_path": f"phase tp_all (a): a rank's prefill, "
                            f"{spec['arch']} x{spec['num_layers']} on mesh "
                            f"{spec['mesh']}, and its decode prompt's",
           "max_abs_err": err, "ms": ms, "eager_ms": eager_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": nbytes, "library_ms": library_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention("
                      f"is_causal=True), backend {backend}"}
    log(f"time flash_attention ({out['shape']}): {ms * 1e3:.1f} us in a "
        f"CUDA graph, {eager_ms * 1e3:.1f} us eager, plain "
        f"{plain_ms * 1e3:.1f} us, sdpa ({backend}) "
        f"{'-' if library_ms is None else f'{library_ms * 1e3:.1f}'} us, "
        f"bound {out['bound_ms'] * 1e3:.1f} us by {out['bound_by']} "
        f"({flops:.3e} FLOP, {nbytes:,} bytes); max abs err {err:.3e}; "
        f"{launches} launches a rank")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def time_flash(dev, lm: dict, checks: dict, moe: dict | None = None,
               mla: dict | None = None, encdec: dict | None = None,
               vlm: dict | None = None, tp: dict | None = None,
               tp_all: dict | None = None,
               train_tp: dict | None = None) -> dict:
    """flash_attention's row of the kernels line: its times at the lm
    phase's prefill shape (``time_flash_causal`` against
    ``flash_attention_ref``).  With phase moe's state, the same at its
    windowed shape (``windowed``); with phase mla's, at its (Dqk, Dv) =
    (192, 128) shape (``mla``); with phase encdec's, its times at the
    encoder's and the cross-attention's non-causal shapes (``encdec``,
    measured in that phase); with phase vlm's, at internvl2's 64/8-head
    causal shape (``vlm``, against the plain version a head at a time);
    with phase train_tp's, at part (d)'s FSDP serving shape
    (``train_tp``)."""
    from repro_torch.kernels import flash_attention as FA

    row = {
        "name": "flash_attention", "route": "cuda",
        "source": KERNELS["flash_attention"][1],
        "replaces": KERNELS["flash_attention"][0],
        "max_abs_err": checks["flash_attention"]["max_abs_err_full_shape"],
        "max_abs_err_all_cases": checks["flash_attention"]["max_abs_err"],
        "cases": checks["flash_attention"]["cases"],
    }
    row.update(time_flash_causal(dev, lm, FA.flash_attention_ref, 5))
    if moe is not None:
        row["windowed"] = time_flash_windowed(dev, moe)
        row["launches_moe"] = moe["prefill_flash_launches"]
    if mla is not None:
        row["mla"] = time_flash_mla(dev, mla)
        row["launches_mla"] = mla["prefill_flash_launches"]
    if encdec is not None:
        row["encdec"] = encdec["flash_times"]
        row["launches_encdec"] = encdec["prefill_flash_launches"]
    if vlm is not None:
        row["vlm"] = time_flash_causal(
            dev, vlm, lambda q, k, v: attention_ref_by_head(q, k, v, None), 3)
        row["vlm"]["max_abs_err"] = vlm["layer0_attn_max_abs_err_plain"]
        row["vlm"]["max_abs_err_check"] = \
            checks["flash_attention"]["max_abs_err_vlm_shape"]
        row["launches_vlm"] = vlm["prefill_flash_launches"]
    if tp_all is not None:
        row["tp_all"] = time_flash_mla_rank(dev, tp_all)
        row["launches_tp_all"] = {"mla gloo4 (a rank)": tp_all["launches"][
            "mla"].get("flash_attention")}
    if tp is not None:
        row["tp"] = time_flash_tp(dev, tp)
        row["launches_tp"] = {"gloo4 (a rank)": tp["launches"].get(
            "flash_attention"), "cp gloo3 (a rank)": tp["launches_cp"].get(
            "flash_attention")}
    if train_tp is not None and "d" in train_tp:
        row["train_tp"] = time_flash_fsdp(dev, train_tp)
    return row


# ---------------------------------------------------------------- entry point
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--profile-diag", type=int, default=0, metavar="N",
                    help="phase times: profile each window N times with "
                    "and without the warm-up step and with a lead kernel, "
                    "and log how many recorded every port kernel")
    args = ap.parse_args(argv)
    global PROFILE_DIAG
    PROFILE_DIAG = args.profile_diag
    phases = set(args.phases.split(","))
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    from repro_torch import kernels

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = kernels.build_all(verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        f"{sorted(p.name for p in libs.values())}")
    state: dict = {}
    if "kernels" in phases:
        t0 = time.perf_counter()
        resources = kernel_resources(libs)
        state["checks"] = phase_kernels(dev)
        state["checks"]["resources"] = resources
        log("kernel checks: " + json.dumps(state["checks"]) +
            f" ({time.perf_counter() - t0:.2f} s)")
    if "main" in phases:
        t0 = time.perf_counter()
        state.update(phase_main(dev))
        log(f"main phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "parity" in phases:
        t0 = time.perf_counter()
        phase_parity(dev)
        log(f"parity phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "sketch" in phases:
        t0 = time.perf_counter()
        state["sketch"] = phase_sketch(dev, state)
        log(f"sketch phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "parallel" in phases:
        t0 = time.perf_counter()
        state["parallel"] = phase_parallel(dev, state)
        log(f"parallel phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "dist" in phases:
        t0 = time.perf_counter()
        state["dist"] = phase_dist(dev, state)
        log(f"dist phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "stream" in phases:
        t0 = time.perf_counter()
        state["stream"] = phase_stream(dev, state)
        log(f"stream phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "elastic" in phases:
        t0 = time.perf_counter()
        state["elastic"] = phase_elastic(dev, state)
        log(f"elastic phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "serving" in phases:
        t0 = time.perf_counter()
        state["serving"] = phase_serving(dev, state)
        log(f"serving phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "lm" in phases:
        t0 = time.perf_counter()
        state["lm"] = phase_lm(dev)
        log(f"lm phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "moe" in phases:
        t0 = time.perf_counter()
        state["moe"] = phase_moe(dev)
        log(f"moe phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "moe_ep" in phases:
        t0 = time.perf_counter()
        state["moe_ep"] = phase_moe_ep(dev)
        log(f"moe_ep phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "tp" in phases:
        t0 = time.perf_counter()
        state["tp"] = phase_tp(dev)
        log(f"tp phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "tp_all" in phases:
        t0 = time.perf_counter()
        state["tp_all"] = phase_tp_all(dev)
        log(f"tp_all phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "mla" in phases:
        t0 = time.perf_counter()
        state["mla"] = phase_mla(dev)
        log(f"mla phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "encdec" in phases:
        t0 = time.perf_counter()
        state["encdec"] = phase_encdec(dev)
        log(f"encdec phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "vlm" in phases:
        t0 = time.perf_counter()
        state["vlm"] = phase_vlm(dev)
        log(f"vlm phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "xlstm" in phases:
        t0 = time.perf_counter()
        state["xlstm"] = phase_xlstm(dev)
        log(f"xlstm phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "hybrid" in phases:
        t0 = time.perf_counter()
        state["hybrid"] = phase_hybrid(dev)
        log(f"hybrid phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "train" in phases:
        t0 = time.perf_counter()
        state["train"] = phase_train(dev)
        log(f"train phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "train_moe" in phases:
        t0 = time.perf_counter()
        state["train_moe"] = phase_train_moe(dev)
        log(f"train_moe phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "train_tp" in phases:
        t0 = time.perf_counter()
        state["train_tp"] = phase_train_tp(dev)
        log(f"train_tp phase {time.perf_counter() - t0:.2f} s")
        note_launches()
    if "times" in phases:
        rows = phase_times(dev, state)
        for path in ("stream", "elastic", "serving"):
            counts = state.get(path, {}).get("launches", {})
            for r in rows:
                # launches on the stream, elastic and serving paths, per
                # stream, replay or run of the phase, as counted around its
                # feeds, ops, results and repairs
                per = {s: c[r["name"]] for s, c in counts.items()
                       if c.get(r["name"])}
                if per:
                    r[f"launches_{path}"] = per
        for r in rows:
            # a rank's launches on the group route (phase dist)
            per = {f"{tag} (a rank)": state["dist"][tag]["launches"][r["name"]]
                   for tag in ("nccl1", f"gloo{DIST_WORKERS}")
                   if "dist" in state
                   and state["dist"][tag]["launches"].get(r["name"])}
            for tag in ("elastic_nccl1", "elastic_gloo"):
                by = state.get("dist", {}).get(tag, {}).get("by_phase", {})
                got = {ph: c[r["name"]] for ph, c in by.items()
                       if c.get(r["name"])}
                if got:
                    per[f"{tag} (a rank, by phase)"] = got
            if per:
                r["launches_dist"] = per
            # a rank's launches on the mesh (phase moe_ep)
            got = state.get("moe_ep", {}).get("launches", {}).get(r["name"])
            if got:
                r["launches_moe_ep"] = {"gloo4 (a rank)": got}
            # a rank's launches under dense tensor parallelism (phase tp)
            got = {tag: state["tp"][key].get(r["name"])
                   for tag, key in (("gloo4 (a rank)", "launches"),
                                    ("cp gloo3 (a rank)", "launches_cp"))
                   if state.get("tp", {}).get(key, {}).get(r["name"])}
            if got:
                r["launches_tp"] = got
            # a rank's launches in the rest of the path over a mesh (phase
            # tp_all)
            got = {f"{tag} gloo4 (a rank)": c.get(r["name"]) for tag, c in
                   state.get("tp_all", {}).get("launches", {}).items()
                   if c.get(r["name"])}
            if got:
                r["launches_tp_all"] = got
            # a rank's launches in training over a mesh (phase train_tp)
            got = {f"{tag} gloo4 (a rank)": v["per_rank"][0]["launches"].get(
                r["name"]) for tag, v in state.get("train_tp", {}).items()
                if isinstance(v, dict) and "per_rank" in v
                and v["per_rank"][0]["launches"].get(r["name"])}
            if got:
                r["launches_train_tp"] = got
            # a rank's launches in (d)'s FSDP serving (phase train_tp)
            got = {f"{tag} serving gloo4 (a rank)":
                   v["per_rank"][0]["serve"]["launches"].get(r["name"])
                   for tag, v in state.get("train_tp", {}).items()
                   if isinstance(v, dict) and "per_rank" in v
                   and "serve" in v["per_rank"][0]
                   and v["per_rank"][0]["serve"]["launches"].get(r["name"])}
            if got:
                r["launches_train_tp_serving"] = got
        log(f"card: {card}")
        log(json.dumps({"kernels": rows}))
    if phases != set(PHASES):
        log(f"ran phases {sorted(phases)} only; no result")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
