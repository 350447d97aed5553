#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dllama_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

1. card and build — the card's name and power limit from nvidia-smi, TF32
   off for matmuls and cuDNN, the kernels built with nvcc from
   ``dllama_tpu_torch/ops/csrc`` (one process per source).
2. Q40 kernel against its plain version, after the tensor-core body's
   build report (each instantiation's registers and spills, any wgmma the
   assembler serialized, the build's block at each tile height against
   ``q40.MMA_SMEM``/``MMA_STAGES``), at the five Llama-2-7B matmul
   shapes (wqkv, wo, w13, w2 stacked; wcls flat) for t in {1, 2, 4, 5, 8,
   12, 16, 24, 32, 128}, both of its bodies (the decode body, with its
   plan, and the tensor-core body: the crossover that sets q40.T_MMA,
   printed a t; the tensor-core plan a t) checked and timed, the routed one
   reported, wcls also at t = 512 and 4096 (phase 20's scoring forward's
   rows, 8 x 512), and a ragged
   shape (n = 4128, n/32 odd; d = 1000; t = 17); stacked calls at layers 0
   and L-1, random packed planes made on the card from a seed:
   max|kernel - plain| <= KERNEL_TOL * max|plain|, and two launches of each
   body equal bit for bit (also in 2v, 9, 9b and 13).  Times the kernel, the
   plain version and torch.matmul on the pre-dequantized bf16 weight (a
   yardstick the port never calls), each the median of launches on a cold
   L2, and an empty kernel the same way (the timing's floor).  2b: a
   rank's shapes at tp = 2.  2c: the decode body as a decode token meets
   it, each stacked 7B site over 32 planes back to back, Q40 and Q80.
2v. the fma, folded and exact dequant bodies of kernels 1-2
   (DLLAMA_Q40_VARIANT) against their plain versions (``matmul_plain(...,
   variant=...)``) at the five 7B sites, stacked planes at layers 0 and
   L-1, t in {1, 4, 8, 9, 16, 128}, both bodies at every t, and the ragged
   shape at t = 17: max|kernel - plain| <= KERNEL_TOL * max|plain|.  At t =
   1, 16 and 128 each variant and classic timed side by side on the same
   inputs (the routed body, cold L2) beside the plain version, the bound
   and torch.matmul on the dequantized weight.
3. the main path at full width: a Llama-2-7B-shaped Q40 model synthesized
   from a seed (random nibbles, constant f16 scale 0.008; no weights needed),
   cut to 8 layers (CUT_LAYERS; 32 until the Q80 Hopper slice, which cut
   phases 3, 7, 20 and 23a for the script's time), ``inference
   --temperature 0 --steps 64 --chunk 16 --warmup 16`` on cuda through the
   CLI entry point, every decode step a replay of its captured CUDA graph;
   the Q40 counters must show exactly 4 * 8 + 1 = 33 kernel launches per
   forward and no plain call, a single-token forward's 33 all on the GEMV
   body (the 16-row prompt bucket's on the tensor-core body).
   Then torch.profiler over 8 decode steps (graph replays): device busy
   time per token, the idle share, and the kernels that take the time; then
   one greedy stream with the engine's graphs on and off: the same tokens
   byte for byte, the same launch counters, each pass's ms/token.  Phases
   10, 11 and 14 do the same.
3v. the dequant variants on the main path, each in a child process with
   ``DLLAMA_Q40_VARIANT`` set (read when ``ops.q40`` is imported):
   ``exact``, ``folded`` and ``fma`` on the 2-layer file of phases 4 and 5
   (8 layers, ``exact`` 32, until the Q80 Hopper slice cut them for the
   script's time), each as phase 3 (every
   Q40 launch under the variant, 4 L + 1 a forward, 0 plain; a
   single-token forward on the decode body, the 16-row prompt bucket on
   the tensor-core body; ms/token, the profile, graphs on and off, a greedy
   repeat byte for byte), then the phase-5 model's kernel path against its
   plain path under the variant.
4. a few requests: ``generate`` with three prompts, two greedy (each run
   twice, byte-identical) and one at temperature 0.8 seed 1; every run ends
   on finite logits.  On the phase-5 model (7B width, 2 layers): five
   loads of the 32-layer file took most of the script's time.
5. kernel path against plain path end to end: the same 7B-width model cut
   to 2 layers, prefill + 8 teacher-forced decode steps; logits agree within
   E2E_TOL * max|plain| and greedy tokens agree wherever the plain top-2
   margin exceeds twice the largest logit difference.
6. the paged-attention kernel against its plain version (the page-walk
   fold) at Llama-2-7B shape: B = 8 rows at ragged positions 0..4095,
   32 heads of 128, 16-token pages, 256 pages a row, layers 0 and L-1 of a
   3-layer pool, bf16 and int8 pools: max|kernel - plain| <=
   ATTN_TOL * max|plain|.  Times the kernel (cold L2), the plain version
   and torch's scaled_dot_product_attention on the K/V pre-gathered to
   contiguous bf16 with a per-row mask (a yardstick the port never calls);
   prints the bound, the kernel's share of it and the split plan; the same
   on an f16 pool with f16 queries (``--buffer-float-type f16``).  Then
   the bf16 and f16 pools at Mixtral's shape: 32 query heads on 8 kv heads
   (G = 4 query heads a block).  Then head dims 16, 32, 80, 96 and 256
   (ATTN_DH) on bf16 and int8 pools, f32 at 96, and G = 16 (32 query heads
   on 2 kv heads: two blocks of 8 heads a kv head), bf16 and int8, the
   same checks and times; the build's registers and spills of kernel 7.
6c. the prefill attention kernel (t > 1 query rows over the paged pool,
   the mixed slot step's read) against its plain version (the gather, then
   the one-shot per-row-ceiling attention) at the 7B shape (G = 1) and at
   Mixtral's (G = 4), bf16, int8, f32 and f16 pools, T in {2, 8, 16}, the widest
   step before the row cap went (128 query rows a kv head: T = 128 at G =
   1, 32 at G = 4) and one past it (256 rows, two row groups: T = 256, 64):
   B = 8 rows at position 0, mid-page, across a page edge and near 4095,
   the step's K/V written first as the slot step writes it (rows with
   n_valid < T send their padded tokens to scratch page 0; one row's table
   runs out into page 0): for each query row (row, head, token),
   max|kernel - plain| <= ATTN_TOL * max|plain| over that row, both in f32
   before their outputs round (PREFILL_F32_TOL = 1e-4 on an f32 pool), the
   main path's bf16 output that f32 output rounded, and two launches equal,
   bit for bit; then at the 7B shape on pages of 4, 24 and 100 positions
   (PREFILL_PAGES), bf16 and int8, T = 16 and 256, the same checks; then
   at head dims 16, 32, 80, 96 and 256 (bf16 and int8; f32 at 96) at T = 16
   and a step of two row groups (T = 256; 128 at Dh 256, where a block
   takes 64 query rows), the build's row group checked against the plan's;
   then G = 16 (32 query heads on 2 kv heads), bf16 and int8, T = 16.
   Prints each instantiation's registers and spills from the build, the
   plan (splits, row groups), the block's layout from the build (consumer
   warpgroups, threads, shared memory, ring stages, consumer registers
   after setmaxnreg), times the kernel (cold L2), the plain version
   and SDPA on K/V pre-gathered to the operand type with the boolean
   per-row mask (a yardstick the port never calls); prints the bound and
   the kernel's share of it.
6s. serving on the pools and widths the prefill kernel took no body for
   before: the API server (phase 7's arguments) at 7B width cut to 8
   layers (CUT_LAYERS) with ``--kv-cache-dtype f32 --kv-pages 257`` and
   with ``--sched-prefill-chunk 256``, and Mixtral cut to 4 layers with
   ``--sched-prefill-chunk 64`` (256 query rows a kv head): four greedy
   requests each, every answer 200, the prefill kernel n_layers times a
   mixed forward and 0 plain calls, a mixed step at the chunk's width; then
   three mixed steps at that width on a fresh paged engine of the same
   pool (warm-up, capture, replay) against an ``attn_impl="plain"``
   engine: logits within E2E_TOL of max|plain|; then 8 greedy single-token
   steps on each (kernel 7 n_layers times a step, 0 plain): the tokens
   equal, or first differ at a near tie (top-2 margin < NEAR_TIE of max).
   The same at 7B width, 8 layers, with ``--kv-cache-dtype f16`` (an f16
   pool under bf16 activations: at f16 ones the synthesized weights
   overflow f16's range, on the plain path too), and on a 2-layer model of
   Phi-3-mini's widths (DH96: 32 heads of 96).
24. a legacy-magic file (the reference's older converters: the 9-int
   header with no weights float type) written from the phase-5 file's
   bytes: ``generate --weights-float-type q40`` on it and on the v2 file,
   the same greedy bytes, every Q40 matmul on the kernels; then
   ``inference --dequantize`` on it: dense bf16 weights, no Q40 launch,
   finite logits.
7. the serving path at full width: the API server in-process on the
   phase-3 model (--batch-slots 8 --kv-pages 513 --kv-page-size 16
   --sched-prefill-chunk 16) answers 16 concurrent greedy requests (prompts
   of 8 to 512 tokens, max_tokens 32 to 64, 4 chats sharing a system
   prompt, 2 streamed; the first chat goes ahead until its prompt pages
   are cached).  Every answer is 200; the slot engine's last logits are
   finite; every single-token slot forward launched the attention kernel
   once per layer and no decode read ran the plain version; no Q40 matmul
   ran the plain version; the prefix cache hit; a request sent alone twice
   answers byte for byte; every mixed slot forward launched the prefill
   attention kernel once per layer, never its plain version.  Prints tok/s,
   TTFT and latency percentiles, peak memory and a torch.profiler split of
   an 8-slot decode step and of an 8-slot mixed prefill step (16 tokens a
   row), each replaying its captured graph, with its eager wall timed
   beside it; their Q40 matmuls (8 and 128 rows) run on the body q40.route
   names (the tensor-core body: launches > 0), the mixed step runs the
   prefill kernel once a layer and no cuBLAS GEMM (the plain attention's
   f32 einsums).  The scheduler's overlapped pipeline is on; then the first
   8 requests, queued in order while the scheduler is parked and released
   at once, run with overlap on, overlap off, and with the slot graphs off:
   every answer byte for byte, the dispatches, overlapped and discarded
   ones and tok/s of each.  Prints each captured key's capture seconds and
   memory-pool bytes.  Then a shorter pass with --kv-quant int8 (7b), with
   its profile.
8. slot path, kernels against plain versions: the phase-5 model through
   Engine.slot_step on a paged pool (bf16 and int8), a ragged mixed step
   (16 tokens a row; the prefill attention kernel, n_layers launches) + 8
   teacher-forced decode steps, kernels (``auto``) against
   ``quant_impl = attn_impl = "plain"``: logits within E2E_TOL and greedy
   agreement where the margin is decisive; the kernels' steps with the
   engine's graphs on and off give the same logits bit for bit.  Then
   contiguous slot rows (no pool) the same way, graphs on against off.
9. the Q80 kernel against its plain version as in phase 2, after its
   tensor-core body's build report (the ``wgmma_matmul<Q8, ...>``
   instantiations' registers and spills, any wgmma serialized, the block
   at each tile height against ``q8.MMA_SMEM``/``MMA_STAGES``), at t in
   {1, 4, 5, 8, 12, 16, 24, 32, 128}, both of its bodies (the decode and the
   tensor-core body: the crossover that sets q8.T_MMA) checked and timed,
   the routed one reported: the five 7B sites, Mixtral's wqkv and experts (up/gate
   4096->14336, down 14336->4096) in an (MIXTRAL_LAYERS, 8 experts) stack
   at flat indices 0 and its last, Grok-1's experts (6144->32768, 32768->6144) in a
   (2, 8) stack, a rank's 7B sites at tp = 2, and a ragged shape (n = 4128,
   n/32 odd; d = 1000; t = 9 and 17, the 16- and the 32-row tile) for the
   tensor-core body's masks and the producer's copies; the
   expert planes addressed by an int32 index on the card.  Then the Q40
   kernel at Mixtral's shapes through the same device index, both bodies,
   t in {1, 8, 16, 128}.
10. Q80 at Llama-2-7B width, cut to 8 layers (CUT_LAYERS; 32 until the
   fleet slice): ``inference`` as in phase 3 with an 84-token prompt (its
   prefill runs at t = 128); the Q80 counters show exactly 4 * 8 + 1 = 33
   kernel launches a forward, no plain call, and the prompt forward's 32
   matmuls on the tensor-core body; the profiler split and the peak
   memory; then torch.profiler over one 84-token prompt forward (device
   busy ms, the Q80 tensor-core body's ms and share) and a greedy decode
   twice, token for token.
11. Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1's published shape) in Q40,
   cut to 4 of its 32 layers (MIXTRAL_LAYERS; 8 until the dequant-variant
   slice), context cut to 4096: ``inference`` as in phase 3 with exactly
   8 * 4 + 1 = 33 Q40 launches a single-token forward
   (wqkv, wo, 2 experts x 3 a layer, wcls) and no plain call; the
   decode-route MoE FFN (1 and 3 tokens) under
   ``torch.cuda.set_sync_debug_mode("error")``, so the experts chosen on
   the card are never read by the host, against its plain version; then
   the API server as in phase 7 with 8 requests, on phase 11's weights
   (as 6s's Mixtral server: one read of the file).
12. MoE kernels against plain versions end to end: Mixtral width cut to 2
   layers, Q40 and Q80, the phase-5 and phase-8 checks (batch-1 and slot
   paths, both MoE routes: all experts for the prompt, the selected ones
   for decode), after a per-layer trace of where the kernel path leaves
   the plain path (each block's attention, FFN and residual, chained and
   alone; the logits' gap against max|logits| and against their spread).
13. kernel 3 (the Q40 matmul over tile-contiguous "blocked" planes)
   against its plain version (unblock the plane, then phase 2's plain
   version) at the five 7B sites in the default tiles (512, 2048) (stacked
   planes read at 0 and L-1 through an int32 on the card; wcls as an L = 1
   stack), t in {1, 4, 8, 16, 128}, two narrow shapes whose column tiles
   cut through a thread block (d = 320: td clamped to 384; d = 1000 in
   tiles (256, 384)), t in {1, 16, 128}, and the ragged shape in tiles
   (32, 100), t in {1, 17}; both bodies at every t.  Times kernel 3 (both
   bodies), kernels 1-2 on the same weights row-major, the plain version
   and torch.matmul on the dequantized bf16 weight, each launch on a cold
   L2, the bound from the stored (d padded to td) bytes; fails unless
   kernel 3 equals kernels 1-2 bit for bit under each body.
14. the blocked main path at Llama-2-7B width cut to 8 layers (CUT_LAYERS;
   32 until the fleet slice), the file of phases 17 and 23b with
   ``DLLAMA_Q40_LAYOUT=blocked``: ``inference`` as phase 3, with exactly
   4 * 8 + 1 = 33 kernel-3 launches a forward and no row-major launch or
   plain call, its profiler split and peak memory (the load included);
   ``batch`` of 8 prompts (8 to 200 characters) from a prompts file,
   greedy, ``--steps 48`` (kernel 3 at t = 8 in decode, the body
   q40.route names), run twice: the same bytes, every row finished, finite
   logits; then the batch with graphs on and off on the same engine: the
   same rows and counters; the API server as in phase 7b with 8 requests,
   kernel 3 on the slot path.
15. blocked and batch end to end against the plain path on the phase-5
   model: kernel 3 against ``quant_impl="plain"`` (and against kernels
   1-2: bit for bit), the lockstep batch of 4 ragged prompts against each
   prompt's single-stream run (prefill + 8 teacher-forced steps, the
   phase-5 margin rule), and ``chat`` over stdin on a copy whose wcls
   rows of two tokens dwarf the others with opposite signs, the chat EOS
   and a token whose piece is the tokenizer's chat stop string, so a
   reply ends within a token or two whatever the sign of the hidden
   state: two turns, the second starting where the first ended.

16. kernel 4 (the tensor-parallel all-reduce of f32 partial sums) against
   its plain version (the same adds in the TPU ring's order) with every
   rank on cuda:0, tp in {2, 4}, t in {1, 8, 128}, d in {4096, 6144}:
   max|kernel - plain| = 0 on every rank, and at tp = 2 the two ranks'
   sums equal bit for bit.  Times the kernel, the plain version and
   ``torch.stack(parts).sum(0)`` (a yardstick the port never calls), each
   launch on a cold L2.  With two or more cards it repeats the check with
   rank r on card r (peer reads); on one card it prints that it skipped
   this.
16b. kernel 4 across processes (its CUDA IPC body): two child processes
   on cuda:0 joined in a gloo group through 127.0.0.1, tp = 2 with one
   rank each, both ranks' partials made from one seed in each child, at
   d = 4096, t in {1, 16, 128}, and d = 4102 at t = 3 (the scalar path):
   each child's sum equal to ``tp_allreduce_plain`` bit for bit.  Times,
   each the median of calls on a cold L2: the cross-process call (one card
   that the two CUDA contexts share in time slices, no MPS: a rank waiting
   for its peer's flag holds the card until its slice ends), the
   one-process kernel on both partials, the plain version and
   ``torch.stack(parts).sum(0)``; and 50 cross-process calls back to back
   by the host clock; prints the bound.
17. tensor parallelism on the main path: a Llama-2-7B-width file cut to 8
   layers (CUT_LAYERS; 32 until the fleet slice), ``inference --workers
   tpu:2 --device cuda:0`` as phase 3 (both ranks on one card): exactly
   2 * (7 * 8 + 1) = 114 Q40 launches (unfused wq/wk/wv/wo/w1/w3/w2 a layer
   and the wcls slice, on each rank) and 2 * 8 = 16 kernel-4 launches a
   forward, no plain call; its profile and peak memory; the first
   forward's logits within E2E_TOL of max|logit| of a tp = 1 forward of the
   same file.
25. the worker path: two CLI processes on cuda:0 at ``--workers tpu:2``
   (one rank each; phase 17's 7B-width file of CUT_LAYERS layers), process
   0 the mode, process 1 ``worker --program`` of it, joined through
   ``--coordinator 127.0.0.1:P --nproc 2 --proc-id K``: ``inference``
   greedy with phase 17's prompt for WORKER_STEPS tokens (its pieces
   phase 17's single-process tp = 2 pieces byte for byte, process 0's
   ms/token beside phase 17's: one card in time slices), ``generate`` of
   the same prompt (process 0's text those pieces joined, up to its EOS),
   ``batch`` over phase 14b's 8 prompts (the streams those of the
   single-process tp = 2 batch, run in-process).  Both processes exit 0,
   process 1 prints nothing on stdout, and each process's counter line
   (stderr) shows 7 L + 1 Q40 launches (its rank) and 2 L cross-process
   kernel-4 launches a forward, 0 plain calls; each process's peak device
   memory and IPC region bytes.
18. the API server at ``--workers tpu:2`` on the phase-5 model (7B width,
   2 layers), 8 slots and a paged pool a rank: 8 greedy requests as phase
   7b, then the same 8 again, each answering byte for byte; kernel 7
   launched on both ranks' pools (2 L a single-token slot forward), kernel
   4 counted.
19. Q80 Llama-2-7B width and Mixtral-8x7B width (Q40), each cut to 2
   layers, at tp = 2 on cuda:0 (and, with two or more cards, on cards 0
   and 1): the kernel path against the plain path (plain matmuls and
   kernel 4's plain version) end to end, batch-1 and slot paths, as
   phases 5, 8 and 12.
20. the OpenAI surface at Llama-2-7B width (8 layers): phase 3's file
   served with ``--batch-slots 8 --kv-pages 0`` (the lockstep engine):
   a list of 8 greedy prompts twice (the same bytes), chat ``n = 4`` at
   temperature 0.8 seed 1 twice (four choices, their usage, the same
   bytes), ``logprobs = 5`` with ``echo`` on a ~500-token prompt (the
   tokens join to the text; the first log-prob null only without a BOS;
   every other finite and <= 0; five alternatives a position; each greedy
   token the top-1 where the top-2 margin exceeds 0.05 nats), the list
   streamed (joined per index = the non-stream texts), ``/metrics`` in
   both formats (this server's requests served, the TTFT count, the text
   parses, the HBM gauge within 1 % of ``memory_allocated``) and
   ``/debug/requests/<id>``, ``/debug/timeline``, ``/debug/trace``; the
   Q40 counters over those requests show wcls once on the tensor-core body
   (the logprobs request's scoring forward, at 8 x 512 rows) and no plain
   call.  Then the scoring forward alone at 8 x 512: wall, device
   busy time, peak memory, and its counters (4 L + 1 launches, all on the
   tensor-core body).
20b. on the phase-5 model: both layers of a scoring forward at 8 x 512
   rows, kernels against plain with every sub-block fed the plain run's
   input (attention and FFN outputs within E2E_TOL; layer 1's four Q40
   products at stacked plane 1 and wcls within KERNEL_TOL; a witness:
   layer 1's attention, plain against plain with its input one ulp away,
   printed); ``score_batch`` with the kernels against the
   plain versions at a 64 bucket (logits by the phase-5 rule, log-probs within twice the
   largest logit difference, top-5 ids where the margin decides), prefill
   + 8 teacher-forced steps on the contiguous int8 cache kernel against
   plain, and a greedy stream on the int8 cache with graphs on and off.
3q. ``inference --kv-cache-dtype q8`` at Llama-2-7B width cut to 8 layers
   (CUT_LAYERS; 32 until the dequant-variant slice), the file of phases 14,
   17 and 23b, as phase 3 (33 launches a forward, the profile, graphs on
   and off).

21. state off the card and back, at Llama-2-7B width cut to 8 layers
   (CUT_LAYERS; full depth until the dequant-variant slice), the file of
   phases 14, 17 and 23b, loaded once; every server of the phase has its
   own caches over those weights, phase 7's arguments:
   21a snapshots: on a bf16 and an int8 pool, a greedy chat, a drain with
   ``--snapshot-dir`` and a second server booted from it: its chat reuses
   the restored prefix (the prefill kernel and kernel 7 read the restored
   pages, plain 0) and answers the cold server's text byte for byte; the
   batch-1 engine (graphs on) restores in place between two turns of a
   conversation and repeats the second turn byte for byte with replays and
   no new capture.
   21b hand-off: two servers with ``--handoff``; a greedy 512-token request
   streams on A, A drains after the first chunk, ``GET
   /admin/export/<rid>`` (once: a second fetch is 404) and ``POST
   /admin/import?emitted_chars=N`` at B: the joined text equals B's
   undisturbed answer; ``/admin/checkpoint`` of a live slot, and an int8
   pool's record at a bf16 pool (409).  Prints the record's bytes, export
   and import ms, and a plain pinned ``copy_`` of the same bytes each way.
   21c QoS: 8 ``batch`` requests of 256 new tokens (equal-length prompts,
   released together), then one ``interactive`` request: at least one
   preemption, each victim's text equal to its solo run's after it
   resumes; the interactive TTFT beside its TTFT on an idle server, the
   export and preempt-to-resume ms; then ``--preempt-cap 0`` (a victim
   finishes ``preempted``) and ``--no-preempt`` (no preemption).
   21d KV tier: phase 7's 16 requests through ``--kv-reserve optimistic``
   on 129 pages with ``--kv-host-pool-mb 2048 --spill-headroom 0`` and through full
   reservation on 513 pages, both at prefill chunk 1 (every row's every
   position through the single-token step, so its bytes do not depend on
   which rows share a step): the same texts byte for byte.  Then both at
   phase 7's chunk 16 (optimistic on 121 pages), the requests queued
   together: each request's tokens before the first step only a pressed
   pool takes equal, every request finishes, the prefill kernel runs.
   Each optimistic pass: at least one spill and one page-in, no graph
   re-captured after it; tok/s of all four, spill and page-in ms a page.
   21b's import, 21c's resumes and 21a's restores capture no new graph.

22. speculative decoding and the roofline gauges at Llama-2-7B width cut
   to 8 layers (CUT_LAYERS; full depth until the dequant-variant slice;
   the 8-layer Q40 file, one load for the phase): 22a ``inference --pld 4
   --profile-split --profile-ops`` on a repetitive prompt (4 L + 1 Q40
   launches a forward, prompt-lookup windows replaying their captured
   graph; the profile of graph replays names the Q40 kernel), then on the
   same engine the PLD stream and plain greedy decode twice each in turns:
   the same tokens (or a divergence only where the plain run's top-2 margin
   is under KERNEL_TOL of max|logit|), tokens a verify window, ms/token
   both ways, no capture in the timed part.  22b the API server as in
   phase 7 with ``--spec off``, ``--spec pld`` and ``--spec draft`` (the
   draft: the target's own file, the best case): 8 repetitive greedy
   requests released together, a warm burst then a timed one (tok/s, TTFT,
   accept ratio, no capture; kernel 7 on every single-token forward, the
   prefill kernel n_layers times on every mixed and verify forward, 0
   plain), then the same prompts through the scheduler: the tokens equal
   ``--spec off``'s (or a recorded near tie).  22c ``/health``'s ``perf``
   block and ``/metrics``' ``mfu``/``mbu`` of each timed burst in (0, 1],
   source ``table``, the card's name and power limit.  22d ``POST
   /debug/profile`` names the Q40 kernel.

23. the fleet (``router/``, ``runtime/faults.py``, ``io/integrity.py``, the
   engine's step watchdog and numeric guard).  23a ``serve-pod --dp 2
   --device cuda:0 --batch-slots 8 --kv-pages 513 --handoff`` in this
   process at Llama-2-7B width, 8 layers (phase 3's file read once, the two
   replicas sharing its weights): phase 7's 16 greedy requests one at a
   time through the router, each byte for byte the same request straight to
   replica 1; TTFT of 8 short streams through the router and straight; the
   16 released together through the router (texts the solo ones', or a near
   tie printed with its margin; no capture), both replicas serving >= 4,
   ``router_dispatch`` summing to the requests sent, kernels 1-2, 7 and the
   prefill kernel launched (counters bumped under one lock), 0 plain; tok/s,
   peak memory, the federated ``/metrics`` replica labels.  23c on the same
   weights: a manifest written by the port, ``generate --verify-weights``
   (weights-read seconds with it and, from phase 3, without; the same
   greedy bytes as the pod's weights), ``io.read_tensor=corrupt`` raising
   ArtifactError naming the tensor, ``--numeric-checks`` with
   ``engine.numeric=nan@1x1`` (a 500, then the next request answers as the
   first), and the batch-1 engine's ms/token with the guard within 3 % of
   without, graphs on.  23b ``serve-pod --supervise --dp 2 --device cuda:0
   --handoff --checkpoint-interval 0.5 --step-timeout 5`` at 7B width, 8
   layers: SIGTERM child 0 with 4 greedy streams on it (each finishes
   through the hand-off splice with the uninterrupted bytes; child 0
   respawned and readmitted); SIGKILL child 1 with 2 greedy streams and a
   sampled one on it (the greedy ones resume on child 0 with the
   uninterrupted bytes, tier printed with the resume gap; the sampled one
   ends ``replica_lost``); child 1's replacement under
   ``DLLAMA_FAULTS=engine.device_step=delay:30x1``: a 500 (StepTimeout), the
   router's ejection, a ``hung`` respawn.  23d ``serve-pod --supervise
   --elastic --device cuda:0 --pod-devices 4 --max-replicas 2`` at 7B
   width, 8 layers, booting one tp = 1 child (the tp = 1 children's steps
   slowed by ``DLLAMA_FAULTS=engine.device_step=delay:0.15`` so streams
   outlive a retire): 8 greedy streams fill its slots and the policy
   scales up on load (a child on ordinal 1, admitted after its first
   healthy probe; decision-to-admission and boot seconds); ``POST
   /admin/scale?n=1`` with 4 greedy streams on each child (every stream
   ends with the uninterrupted bytes, the victim's through the hand-off
   splice; the victim not respawned, its ordinal back in the pool;
   ``pod_scale_events`` up/load and down/manual); back to 2×tp=1, then
   ``POST /admin/reshape?tp=2`` with greedy streams on the old children;
   as the first old child retires the other is SIGKILLed (its streams
   resume on a peer, its respawn is retired too) and the retiring one 0.3
   s into its drain (never respawned): converged
   to 2×tp=2 (``fleet_status``, the registry and ``pod_replicas_desired``
   agree), each stream the uninterrupted tp = 1 text or a divergence at a
   printed near tie (NEAR_TIE of max, from the batch-1 engine);
   ``reshape?tp=1`` back; ``pod_reshape_seconds`` each way, the longest
   window with no backend (the router's ``/health`` every 0.25 s), the
   card's peak memory (nvidia-smi); every child's counters
   (``/debug/launches``) read before it was retired, killed or stopped:
   kernels 1-2, 7 and the prefill kernel in each, kernel 4 in each tp = 2
   child, 0 plain calls (the kernel line's rows the children ran carry
   their sum as ``pod_children``, beside the main path's ``launches``).
   ``--only 23d`` runs it alone.

26. the mesh's other axes, every rank on cuda:0 (the ranks run one after
   another, so no time here is a speed result; each case prints its
   kernels' launches a single-token forward, 0 plain calls, eager ms/token
   and peak device memory beside the one-rank run's).  26a ``generate --sp
   2`` at Llama-2-7B width, CUT_LAYERS layers (2048 positions a shard): a
   64-token prompt through the ring prefill (one ring a layer), then on its
   engine a 20-token second turn (the window written over the shards at pos
   > 0, the one-round combine) and 32 tokens each turn (kernel 4 once a
   layer a forward, over the sp group); greedy bytes against sp = 1's
   (equal, or a divergence at a near tie: NEAR_TIE of max, printed).  26b
   Mixtral-8x7B Q40 at MIXTRAL_LAYERS layers: ``generate`` at ep = 1, ``--ep
   2`` and ``--ep 2 --workers tpu:2``: ep = 2's greedy bytes equal ep = 1's,
   a single-token forward launches the matmul kernel as often and at the
   same shapes as ep = 1's (a non-owner launches nothing; the shards share
   the attention) with 3·k·L kernel-4 sums, the ranks hold the model's
   expert bytes once and share every other leaf; ep = 2 x tp = 2 equal or
   a near tie; the 8-slot server at ``--ep 2`` (built on the CLI engine's
   weights) answers two released bursts of 8 greedy requests as the ep = 1
   server does, kernels 7 and 8 n_layers times a single-token and a mixed
   forward, 0 plain; then a 2-layer Mixtral-width Q80 file the same way
   (kernel 6 on the owners), without the server.  26c ``batch --dp 2`` of
   4 prompts at Llama-2-7B width, CUT_LAYERS layers, against dp = 1: each
   stream equal, or a divergence at a near tie.

They run in the order 1, 2, 2v, 13, 9, 6, 6c, 16, 16b, 3, 3v, 17, 25, 4, 24, 5, 8, 15, 20b,
18, 7, 20, 3q, 21, 22, 23 (a, c, b, d), 14, 6s (7B width), 26a, 26c, 6s (Dh 96), 10, 11,
6s (Mixtral), 26b, 12 (26b's Q80 case on its Q80 weights), 19.  The servers of phases 7,
7b and 20 share one read of the 7B-width file's weights, 6s's three 7B servers another,
and 11b and 6s's Mixtral server phase 11's (each server with caches of its own); each
synthesized model is deleted
when its phases end.  The script prints its whole time on its last line but
two.
``--only 1,6c`` runs a subset of the phases (for bring-up; it prints no
result lines; ``6`` includes ``6c``).  Phase 3 also prints each captured
key's capture seconds and memory-pool bytes.
Prints the kernel table as one JSON line before the last line; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import gc
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM data-sheet peaks (dense): HBM3 rate and bf16 tensor-core rate
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
# kernel vs plain: the same exact bf16 products, summed in another order
KERNEL_TOL = 1e-3
# end to end in bf16: each matmul output rounds to bf16, so a last-bit
# difference in an f32 sum becomes a bf16 ulp (2^-8) and travels two layers
E2E_TOL = 3e-2

LLAMA2_7B = dict(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
                 n_kv_heads=32, vocab_size=32000, seq_len=4096, rope_theta=10000.0)
# mistralai/Mixtral-8x7B-v0.1's published config; run cut to 4 of its 32
# layers (a ~3.5 GB file to write and load; 8 until the dequant-variant
# slice) and to a 4096-token context
MIXTRAL_8X7B = dict(dim=4096, hidden_dim=14336, n_layers=32, n_heads=32,
                    n_kv_heads=8, n_experts=8, n_active_experts=2,
                    vocab_size=32000, seq_len=32768, rope_theta=1e6)
MIXTRAL_LAYERS = 4
MIXTRAL_CTX = "4096"
# microsoft/Phi-3-mini-4k-instruct's published widths (32 heads of 96 on 32
# kv heads, hidden 8192), its vocab cut to the synthesized tokenizer's
# 32000 (it has 32064): phase 6s serves it at 2 layers, the head dim the
# paged kernels took no body for before
DH96 = dict(dim=3072, hidden_dim=8192, n_layers=32, n_heads=32, n_kv_heads=32,
            vocab_size=32000, seq_len=4096, rope_theta=10000.0)
SRC = "dllama_tpu_torch/ops/csrc/q40_matmul.cu"
Q8_SRC = "dllama_tpu_torch/ops/csrc/q8_matmul.cu"
# the tensor-core body of both codecs (a template each .cu instantiates)
WG_SRC = "dllama_tpu_torch/ops/csrc/wgmma_matmul.cuh"
# the TPU kernels replaced: (2-D plane, stacked planes)
Q40_REPLACES = ("dllama_tpu/ops/q40.py:330", "dllama_tpu/ops/q40.py:449")
Q8_REPLACES = ("dllama_tpu/ops/q8.py:192", "dllama_tpu/ops/q8.py:220")
STACK_L = 3
# (site, n, d, leading dims of the stacked planes): one stacked dim is a
# layer stack read at int layers 0 and L-1; two are a (layers, experts)
# stack read at flat indices 0 and L*E-1 given as an int32 on the card
LLAMA_SITES = [("wqkv", 4096, 12288, (STACK_L,)), ("wo", 4096, 4096, (STACK_L,)),
               ("w13", 4096, 22016, (STACK_L,)), ("w2", 11008, 4096, (STACK_L,)),
               ("wcls", 4096, 32000, ())]
MIXTRAL_SITES = [("mixtral.wqkv", 4096, 6144, (STACK_L,)),
                 ("mixtral.up", 4096, 14336, (MIXTRAL_LAYERS, 8)),
                 ("mixtral.down", 14336, 4096, (MIXTRAL_LAYERS, 8))]
GROK_SITES = [("grok.up", 6144, 32768, (2, 8)), ("grok.down", 32768, 6144, (2, 8))]
# a rank's slices of the 7B sites at tp = 2 (phase 17's shapes: wq/wk/wv,
# wo, w1/w3, w2 cut at the logical 5504 rows, unpadded, and wcls)
TP2_SITES = [("tp2.wq", 4096, 2048, (STACK_L,)), ("tp2.wo", 2048, 4096, (STACK_L,)),
             ("tp2.w1", 4096, 5504, (STACK_L,)), ("tp2.w2", 5504, 4096, (STACK_L,)),
             ("tp2.wcls", 4096, 16000, ())]
ROWS = (1, 16, 128)
# the 7B sites of both codecs (phases 2 and 9) also run t = 4 and 8: the
# crossover of the two bodies (GEMV and tensor core) that sets T_MMA; a
# ragged shape (d not a multiple of 128 nor of 16, n/32 odd, t not a
# multiple of 16) exercises the tensor-core body's masks
CROSS_ROWS = (1, 4, 8, 12, 16, 24, 32, 128)
# Q40's 7B sites (phase 2) also run t = 2 and 5
Q40_CROSS_ROWS = (1, 2, 4, 5, 8, 12, 16, 24, 32, 128)
# Q80's (phase 9) t = 5, its tensor-core body's narrowest call (q8.T_MMA)
Q8_CROSS_ROWS = (1, 4, 5, 8, 12, 16, 24, 32, 128)
RAGGED = [("ragged", 4128, 1000, (STACK_L,))]
RAGGED_ROWS = (17,)
# Q40 at Mixtral's shapes (phase 9b) adds t = 8, the 8-slot step's experts
MIX_ROWS = (1, 8, 16, 128)
# rows of the JSON line: the routed body at t = 1, 16 and 128 (the last two
# the tensor-core body, launched by the main paths' prefills)
JSON_ROWS = (1, 16, 128)
# the Q40 dequant variants of kernels 1-2 other than classic
# (DLLAMA_Q40_VARIANT; phases 2v and 3v), each held to its plain version
# at the 7B sites in both bodies at these rows (t = 8 the decode body's
# widest, 9 the tensor-core body's narrowest), and the ragged shape
VARIANTS = ("fma", "folded", "exact")
VARIANT_ROWS = (1, 4, 8, 9, 16, 128)
# phase 20's scoring forwards: 8 sequences in a 512-token bucket, so every
# matmul of the forward, wcls among them, runs at 4096 rows
SCORE_B, SCORE_T = 8, 512
# wcls also at 512 rows and at the scoring forward's width (phase 2): the
# main path launches wcls's tensor-core body at 4096 rows alone
WCLS_WIDE = (512, SCORE_B * SCORE_T)
# phase 10's prompt: 84 tokens of the synthesized tokenizer, a t = 128 prefill
Q8_PROMPT = "Once upon a time the capital of France is" * 2
Q8_PROMPT_TOKENS = 84
# kernel 3 (phase 13): the 7B sites in the default tiles, then two narrow
# shapes whose column tiles cut through a 512-column thread block: d = 320
# (td clamped to 384, one partial tile) and d = 1000 in tiles (256, 384);
# then the ragged shape in tiles (32, 100): every 64-row step of the
# tensor-core body spans two row tiles, each 128-column tile two or three
# column tiles, in 4-byte copies
BLOCKED_REPLACES = "dllama_tpu/ops/q40.py:840"
BLOCKED_SITES = [(site, n, d, lead, None, CROSS_ROWS) for site, n, d, lead in LLAMA_SITES] + [
    ("narrow.d320", 4096, 320, (STACK_L,), None, ROWS),
    ("narrow.d1000", 4096, 1000, (STACK_L,), (256, 384), ROWS),
    ("ragged.32x100", 4128, 1000, (STACK_L,), (32, 100), (1,) + RAGGED_ROWS)]
# paged attention (phase 6): kernel vs plain, the TPU kernel's own bar —
# the two fold the same bf16 operands in another summation order
ATTN_TOL = 1e-2
ATTN_SRC = "dllama_tpu_torch/ops/csrc/paged_attention.cu"
ATTN_REPLACES = "dllama_tpu/ops/attention.py:394"
ATTN_POS = (0, 15, 16, 700, 1500, 2047, 3001, 4095)  # ragged rows
# the prefill kernel (phase 6c): every width the scheduler emits at
# --sched-prefill-chunk 16 is a power of two; these rows sit at position 0,
# mid-page, across a page edge and near 4095 (clipped to 4096 - T)
PREFILL_SRC = "dllama_tpu_torch/ops/csrc/paged_prefill_attention.cuh"
PREFILL_REPLACES = "dllama_tpu/ops/attention.py:106 _rows_ceiling_attention"
PREFILL_T = (2, 8, 16)
# and the wide steps of each shape: the widest before the row cap went
# (128 query rows a kv head: t = 128 at G = 1, t = 32 at Mixtral's G = 4)
# and one past it (256 rows, two row groups: t = 256 at G = 1, 64 at G = 4)
PREFILL_T_WIDE = {1: (128, 256), 4: (32, 64)}
PREFILL_POS = (0, 7, 14, 300, 1000, 2040, 3001, 4095)
PAGE = 16
# row 5's table runs out into scratch page 0 at this position
PREFILL_PAGE0_POS = 640
# an f32 pool keeps f32 operands end to end, so its body is held closer than
# ATTN_TOL: a sound body reads under 3e-5 of a query row's max, one that ran
# single-pass TF32 or bf16 operands about 1e-3 or more
PREFILL_F32_TOL = 1e-4
# below this head dim phase 6c holds a query row to ATTN_TOL of its head's
# max over the step's rows (``_prefill_rows_agree``), not of its own max
PREFILL_NARROW_DH = 32
# the widths of phase 6c's head dims other than 128: the serving chunk,
# and a step of two row groups (256 query rows a kv head up to a padded Dh
# of 128; 128 above it, where a block takes 64 rows)
PREFILL_T_DH = {False: (16, 256), True: (16, 128)}
# page sizes whose TMA boxes differ from 16's (--kv-page-size): 4 (a tile
# is 8 pages of 8-row boxes, each reading past its page), 24 (a 32-row box
# reads 8 rows past the page) and 100 (two 64-row segments, the second
# short)
PREFILL_PAGES = (4, 24, 100)
# kernel 4, the TP all-reduce (phase 16): t rows a rank at decode, the
# lockstep batch and a prefill chunk; d of Llama-2-7B/Mixtral and Grok-1
TP_SRC = "dllama_tpu_torch/ops/csrc/tp_allreduce.cu"
TP_REPLACES = "dllama_tpu/ops/q40.py:923"
TP_SHAPES = [(tp, t, d) for tp in (2, 4) for d in (4096, 6144) for t in (1, 8, 128)]
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# serving (phase 7)
SERVE_ARGS = ["--batch-slots", "8", "--kv-pages", "513", "--kv-page-size", "16",
              "--sched-prefill-chunk", "16", "--temperature", "0",
              "--max-pending", "64", "--host", "127.0.0.1", "--port", "0"]
CHATML = "{% for message in messages %}<|im_start|>...{% endfor %}"


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def cold_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device ms of ``fn`` over ``iters`` launches, each on a cold L2
    (the decode step reads every weight once).  Before each launch the
    device spins ~1 ms while the host enqueues the flush and ``fn``, so the
    events time the device's work and not the host's enqueue; the flush
    reads 64 MB, which leaves L2 full of clean lines (a memset would leave
    dirty ones for the timed kernel to write back).  The median, as a host
    stall past the spin now and then leaves the device idle between the
    events (a single launch then reads many times the median)."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def warm_clocks(dev) -> None:
    """Half a second of f32 matmuls, so that the first timed launch of a
    phase does not meet a card still raising its clocks from idle (the
    first site's t = 1 read up to 1.7x its repeat otherwise)."""
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        for _ in range(20):
            a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
    del a


def bound(t: int, n: int, d: int, value_bytes: float = 0.5) -> tuple[float, str]:
    """Least time for the work: each input read once (x in bf16, the packed
    values at ``value_bytes`` a weight: 0.5 for Q40, 1 for Q80, and the f16
    block scales), the f32 output written once, against the HBM rate; the
    multiply-adds against the bf16 peak."""
    nbytes = t * n * 2 + n * d * value_bytes + (n // 32) * d * 2 + t * d * 4
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, 2.0 * t * n * d / BF16_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def random_planes(codec, lead: tuple, n: int, d: int, g: torch.Generator, dev,
                  pad: bool = True):
    """Random packed planes of ``codec`` (q40 or q8), logical (n, d) under
    leading dims ``lead``, made on the card from ``g``: random value bytes,
    f16 scales uniform in +-0.02 (Q40) or +-0.0005 (Q80: about the same
    weights), zero scales in the pack padding as the loader writes them
    (no padding with ``pad`` False: a tensor-parallel column slice)."""
    is_q8 = codec.__name__.endswith(".q8")
    np_ = codec.padded_n(n) if pad else n
    vals = torch.randint(0, 256, (*lead, np_ if is_q8 else np_ // 2, d),
                         dtype=torch.uint8, generator=g, device=dev)
    amp = 0.0005 if is_q8 else 0.02
    sc = ((torch.rand((*lead, np_ // 32, d), generator=g, device=dev) * 2 - 1) * amp)
    sc = sc.to(torch.float16)
    sc[..., n // 32:, :] = 0
    if is_q8:
        return codec.Q8Tensor(vals.view(torch.int8), sc, (n, d))
    return codec.QTensor(vals, sc, (n, d))


def check_sites(codec, sites, dev, seed: int, pad: bool = True, rows=ROWS,
                json_rows=JSON_ROWS) -> dict:
    """Phases 2, 9 and 9b: ``codec``'s kernel (q40 or q8) against its plain
    version at each site and row count, both of its bodies (the GEMV and
    the tensor-core body) at every t, checked and timed; the routed one is
    reported.  Prints, at each t, at how many sites the tensor-core body
    wins and the sum over a 7B layer's four matmuls: the crossover that
    sets ``T_MMA``.  Returns {(site, t): numbers} for the JSON line at
    ``json_rows``."""
    is_q8 = codec.__name__.endswith(".q8")
    kernel = codec.q8_matmul if is_q8 else codec.q40_matmul
    replaces = Q8_REPLACES if is_q8 else Q40_REPLACES
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    out, wins = {}, {}
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warm_clocks(dev)
    print(f"timing floor: an empty kernel reads "
          f"{cold_ms(lambda: torch.cuda._sleep(0), 20, flush):.4f} ms cold")
    print("site           t  route  kernel_ms  plain_ms  library_ms  bound_ms(by)  "
          "max_abs_err  rel   gemv_ms    mma_ms")
    for site, n, d, lead in sites:
        qt = random_planes(codec, lead, n, d, g, dev, pad)
        if len(lead) == 2:  # an expert stack: flat index on the card
            layers = tuple(torch.tensor([i], dtype=torch.int32, device=dev)
                           for i in (0, lead[0] * lead[1] - 1))
        else:
            layers = (0, lead[0] - 1) if lead else (None,)
        w_lib = codec.dequantize(qt, torch.bfloat16, layer=layers[-1])
        print(f"{site}: decode-body plan (splits, blocks a split) "
              f"{codec.gemv_plan(n, d, n_sms, 1 if is_q8 else 2)}; tensor-core plan "
              f"(bm, splits, steps a split) " + ", ".join(
                  f"t={t} {codec.mma_plan(t, n, d, n_sms)}" for t in rows if t >= codec.T_MMA))
        for t in rows:
            x = torch.randn((t, n), generator=g, device=dev).to(torch.bfloat16)
            err = 0.0
            for layer in layers:
                p = codec.matmul_plain(x, qt, layer)
                scale = float(p.abs().max())
                for body in ("gemv", "mma"):
                    k = kernel(x, qt.qpacked, qt.scales, n, layer, body=body)
                    k2 = kernel(x, qt.qpacked, qt.scales, n, layer, body=body)
                    torch.cuda.synchronize()
                    e = float((k - p).abs().max())
                    if not (torch.isfinite(k).all() and e <= KERNEL_TOL * scale):
                        raise AssertionError(f"{site} t={t} index={layer} body={body}: "
                                             f"max|kernel-plain| {e} > {KERNEL_TOL} * {scale}")
                    if not torch.equal(k, k2):
                        raise AssertionError(f"{site} t={t} index={layer} body={body}: two "
                                             f"launches differ")
                    if body == codec.route(t):
                        err = max(err, e)
            layer = layers[-1]
            times = {b: cold_ms(lambda: kernel(x, qt.qpacked, qt.scales, n, layer, body=b),
                                20, flush)
                     for b in ("gemv", "mma")}
            body = codec.route(t)
            k_ms = times[body]
            p_ms = cold_ms(lambda: codec.matmul_plain(x, qt, layer), 5, flush)
            l_ms = cold_ms(lambda: torch.matmul(x, w_lib), 20, flush)
            b_ms, by = bound(t, n, d, 1.0 if is_q8 else 0.5)
            print(f"{site:12s} {t:4d} {body:5s} {k_ms:10.4f} {p_ms:9.4f} "
                  f"{l_ms:11.4f} {b_ms:9.4f}({by[0]}) {err:12.6g} {err / scale:.2e}"
                  f" {times['gemv']:9.4f} {times['mma']:9.4f}")
            w = wins.setdefault(t, [0, 0, 0.0, 0.0])
            w[0] += times["mma"] < times["gemv"]
            w[1] += 1
            if site in ("wqkv", "wo", "w13", "w2"):  # a 7B layer's four matmuls
                w[2] += times["gemv"]
                w[3] += times["mma"]
            if t in json_rows:
                out[(site, t)] = dict(replaces=replaces[1 if lead else 0], max_abs_err=err,
                                      ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                                      library_ms=l_ms, gemv_ms=times["gemv"],
                                      mma_ms=times["mma"], n=n, d=d,
                                      key=(("mma",) if body == "mma" else ()) + (n, d))
        del qt, w_lib
    for t, (won, of, g_ms, m_ms) in wins.items():
        print(f"crossover, t = {t}: the tensor-core body is faster at {won} of {of} sites"
              + (f"; a 7B layer's four matmuls {g_ms:.4f} ms GEMV, {m_ms:.4f} ms tensor "
                 f"core" if g_ms else "") + f" (T_MMA = {codec.T_MMA})")
    del flush
    torch.cuda.empty_cache()
    return out


def decode_sequence(codec, dev, layers: int = 32) -> dict:
    """Phase 2c: each stacked 7B site's kernel as a decode token meets it,
    launched back to back over ``layers`` planes (a new plane every launch,
    on the body ``codec.route(1)`` names), with the host's enqueue hidden
    behind a device spin: device ms a launch, the best of 5 passes, from
    CUDA events around the pass.  ``codec`` is a q40 or q8 module (any
    tree's)."""
    is_q8 = codec.__name__.endswith(".q8")
    kernel = codec.q8_matmul if is_q8 else codec.q40_matmul
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    out = {}
    for site, n, d, lead in LLAMA_SITES[:4]:
        qt = random_planes(codec, (layers,), n, d, g, dev)
        x = torch.randn((1, n), generator=g, device=dev).to(torch.bfloat16)
        run = lambda: [kernel(x, qt.qpacked, qt.scales, n, i)  # noqa: E731
                       for i in range(layers)]
        run()
        best = float("inf")
        for _ in range(5):
            torch.cuda._sleep(20_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / layers)
        out[site] = best
        del qt
    torch.cuda.empty_cache()
    print(f"{codec.__name__.rsplit('.', 1)[1]} decode sequence ({layers} planes back to back, "
          f"ms a launch): " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
          + f"; a layer's four {sum(out.values()):.4f}")
    return out


def check_variants(q40, dev) -> dict:
    """Phase 2v: each dequant variant of kernels 1-2 (fma, folded, exact)
    against its plain version (``matmul_plain(variant=...)``) at the five 7B
    sites (stacked planes at layers 0 and L-1, wcls flat) for t in
    VARIANT_ROWS and at the ragged shape (t = 17), both bodies at every t:
    max|kernel - plain| <= KERNEL_TOL * max|plain|.  Then, at t in
    JSON_ROWS, each variant and classic timed side by side on the same
    inputs (the routed body, cold L2), beside the plain version, the bound
    and torch.matmul on the dequantized bf16 weight.  Returns {(variant,
    site, t): numbers} for the JSON line."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    warm_clocks(dev)
    out = {}
    print("site           t  variant  route  kernel_ms  plain_ms  library_ms  bound_ms(by)  "
          "max_abs_err  rel       gemv_rel  mma_rel")
    for site, n, d, lead in LLAMA_SITES + RAGGED:
        qt = random_planes(q40, lead, n, d, g, dev)
        layers = (0, lead[0] - 1) if lead else (None,)
        w_lib = q40.dequantize(qt, torch.bfloat16, layer=layers[-1])
        for t in RAGGED_ROWS if site == "ragged" else VARIANT_ROWS:
            x = torch.randn((t, n), generator=g, device=dev).to(torch.bfloat16)
            timed = t in JSON_ROWS and site != "ragged"
            l_ms = cold_ms(lambda: torch.matmul(x, w_lib), 20, flush) if timed else None
            b_ms, by = bound(t, n, d)
            for v in ("classic",) + VARIANTS:
                rel = {"gemv": 0.0, "mma": 0.0}
                err = scale = 0.0
                for layer in layers if v != "classic" else ():  # classic: phase 2
                    p = q40.matmul_plain(x, qt, layer, variant=v)
                    sc = float(p.abs().max())
                    for body in ("gemv", "mma"):
                        k = q40.q40_matmul(x, qt.qpacked, qt.scales, n, layer, body=body,
                                           variant=v)
                        k2 = q40.q40_matmul(x, qt.qpacked, qt.scales, n, layer, body=body,
                                            variant=v)
                        torch.cuda.synchronize()
                        e = float((k - p).abs().max())
                        if not (torch.isfinite(k).all() and e <= KERNEL_TOL * sc):
                            raise AssertionError(
                                f"{v} {site} t={t} index={layer} body={body}: "
                                f"max|kernel-plain| {e} > {KERNEL_TOL} * {sc}")
                        if not torch.equal(k, k2):
                            raise AssertionError(f"{v} {site} t={t} index={layer} body={body}: "
                                                 f"two launches differ")
                        rel[body] = max(rel[body], e / sc)
                        if body == q40.route(t) and e >= err:
                            err, scale = e, sc
                if not timed:
                    if v != "classic":
                        print(f"{site:12s} {t:4d} {v:8s} {q40.route(t):5s} {'':>10s} "
                              f"{'':>9s} {'':>11s} {'':>13s} {err:12.6g} "
                              f"{err / scale:.2e}  {rel['gemv']:.2e}  {rel['mma']:.2e}")
                    continue
                layer = layers[-1]
                k_ms = cold_ms(lambda: q40.q40_matmul(x, qt.qpacked, qt.scales, n, layer,
                                                      variant=v), 20, flush)
                p_ms = cold_ms(lambda: q40.matmul_plain(x, qt, layer, variant=v), 5, flush)
                print(f"{site:12s} {t:4d} {v:8s} {q40.route(t):5s} {k_ms:10.4f} {p_ms:9.4f} "
                      f"{l_ms:11.4f} {b_ms:9.4f}({by[0]}) {err:12.6g} "
                      f"{err / scale if scale else 0.0:.2e}  {rel['gemv']:.2e}  "
                      f"{rel['mma']:.2e}")
                key = (("mma",) if q40.route(t) == "mma" else ()) + (n, d)
                out[(v, site, t)] = dict(replaces=Q40_REPLACES[1 if lead else 0],
                                         max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                         bound_ms=b_ms, bound_by=by, library_ms=l_ms,
                                         key=key if v == "classic" else key + (v,))
        del qt, w_lib
    for t in JSON_ROWS:
        row = {v: sum(r["ms"] for (v_, s_, t_), r in out.items()
                      if v_ == v and t_ == t and s_ != "wcls")
               for v in ("classic",) + VARIANTS}
        print(f"a 7B layer's four matmuls at t = {t}: " + ", ".join(
            f"{v} {ms:.4f} ms" for v, ms in row.items()))
    del flush
    torch.cuda.empty_cache()
    return out


def variant_path(variant: str, m: str, t: str, n_layers: int, m2: str) -> dict:
    """Phase 3v: ``DLLAMA_Q40_VARIANT=variant`` in a child process (the
    variant is read when ``ops.q40`` is imported, as the JAX package reads
    it), which runs :func:`variant_child` on the Q40 file ``m`` of
    ``n_layers`` layers and the 2-layer file ``m2``.  Prints the child's
    report and returns its numbers; raises when it fails."""
    env = dict(os.environ, DLLAMA_Q40_VARIANT=variant)
    r = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                        "sys.exit(chip_smoke.variant_child(*sys.argv[1:]))",
                        m, t, str(n_layers), m2], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=900)
    lines = r.stdout.splitlines()
    print("\n".join(ln for ln in lines if not ln.startswith('{"variant_run"')))
    if r.returncode != 0:
        print(r.stderr[-6000:], file=sys.stderr)
        raise AssertionError(f"the {variant} path failed (exit {r.returncode})")
    res = json.loads(next(ln for ln in lines if ln.startswith('{"variant_run"')))
    res = res["variant_run"]
    res["counts"]["launches_by_shape"] = {tuple(k): n for k, n in
                                          res["counts"]["launches_by_shape"]}
    return res


def variant_child(m: str, t: str, n_layers: str, m2: str) -> int:
    """Phase 3v's child process, with ``DLLAMA_Q40_VARIANT`` set: the main
    path (``inference --temperature 0 --steps 64 --chunk 16`` through the
    CLI, graphs on) on ``m`` with exactly 4 * n_layers + 1 Q40 launches a
    forward, every one under the variant and none plain; a single-token
    forward all on the decode body, the 16-row prompt bucket's on the
    tensor-core body; ms/token, the profile, graphs on and off, a greedy
    repeat (phase 3's checks); then the 2-layer model's kernel path against
    its plain path under the variant (phase 5).  Prints a ``variant_run``
    JSON line last."""
    sys.path.insert(0, REPO)
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.io import mfile
    from dllama_tpu_torch.models import config, params as params_mod, transformer
    from dllama_tpu_torch.ops import _build, q40
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda", 0)
    v = q40.check_variant()
    per_fwd = 4 * int(n_layers) + 1
    print(f"DLLAMA_Q40_VARIANT={v}: q40.KERNEL_VARIANT = {q40.KERNEL_VARIANT}")
    run, eng = main_path(cli, q40, m, t, lambda e: per_fwd * e.forwards, keep=True)
    c = run["counts"]
    by_var = q40.launches_by_variant(c["launches_by_shape"])
    mma_keys = {k: n for k, n in c["launches_by_shape"].items() if k[0] == "mma"}
    if by_var != {v: c["kernel_launches"]} or c["plain_calls"] or not mma_keys \
            or any(k[-1] != v for k in mma_keys):
        raise AssertionError(f"the {v} path: launches by variant {by_var}, plain "
                             f"{c['plain_calls']}, tensor-core keys {mma_keys}")
    q40.reset_counters()
    eng.decode_one(5)
    one = q40.counters()
    if (one["kernel_launches"], one["mma_launches"], one["plain_calls"]) != (per_fwd, 0, 0) \
            or q40.launches_by_variant(one["launches_by_shape"]) != {v: per_fwd}:
        raise AssertionError(f"a single-token {v} forward: {one}")
    print(f"{v}: {c['kernel_launches']} Q40 launches over {eng.forwards} forwards "
          f"({per_fwd} a forward), all {v}, 0 plain; a single-token forward: {per_fwd} on "
          f"the decode body; the prompt forwards: {c['mma_launches']} on the tensor-core body")
    greedy_repeat(eng)
    del eng
    torch.cuda.empty_cache()
    small = load_bf16(mfile, params_mod, config, m2, dev)
    end_to_end(transformer, *small, dev, f"7B width, 2 layers, bf16, {v}")
    del small
    c["launches_by_shape"] = [[list(k), n] for k, n in c["launches_by_shape"].items()]
    print(json.dumps({"variant_run": dict(variant=v, layers=int(n_layers), counts=c,
                                          **{k: run[k] for k in ("tok_s", "ms_token",
                                                                 "peak_bytes", "busy_ms",
                                                                 "idle", "ms_on", "ms_off")
                                             if k in run})}))
    return 0


def synth_model(path_m: str, n_layers: int, mfile, quants, fresh: bool = False,
                dims: dict = LLAMA2_7B, ftype: int | None = None,
                boost_rows: dict | None = None) -> None:
    """A `.m` of ``dims``'s shape (Llama-2-7B, or Mixtral when ``dims`` has
    experts) at packed size in ``ftype`` (Q40 by default, or Q80): random
    value blocks with a constant small f16 scale (0.008 for Q40's nibbles,
    0.0005 for Q80's int8 values: weights of about the same spread; the
    MoE router is such a tensor too, so it routes at random).  By default
    the values tile a 4 MB random pattern from a random offset per tensor
    (fast to write at full size; wcls rows then repeat every 2048 rows, so
    logits tie); ``fresh`` draws every byte, so the logits have no ties.
    ``boost_rows`` {token: byte} fills those wcls rows (the tokens'
    logits) with the packed byte (0xFF: every weight +7, 0x11: every
    weight -7) at the scale 0.5, so their logits dwarf the others'."""
    ftype = quants.Q40 if ftype is None else ftype
    moe = dims.get("n_experts", 0) > 0
    spec = mfile.ModelSpec(arch=mfile.ARCH_MIXTRAL if moe else mfile.ARCH_LLAMA,
                           hidden_act=mfile.ACT_SILU, weights_ftype=ftype,
                           **{**dims, "n_layers": n_layers})
    rng = np.random.RandomState(0)
    block = quants.Q40_BLOCK_BYTES if ftype == quants.Q40 else quants.Q80_BLOCK_BYTES
    scale = np.frombuffer(np.float16(0.008 if ftype == quants.Q40 else 0.0005).tobytes(),
                          np.uint8)
    pool = rng.randint(0, 256, 1 << 22, dtype=np.uint8)
    with mfile.MFileWriter(path_m, spec) as w:
        for info in w.plan:
            n = int(np.prod(info.shape))
            if info.ftype == ftype:
                arr = np.empty((n // 32, block), np.uint8)
                arr[:, :2] = scale
                shape = (n // 32, block - 2)
                arr[:, 2:] = (np.frombuffer(rng.bytes(arr[:, 2:].size), np.uint8).reshape(shape)
                              if fresh else np.resize(np.roll(pool, rng.randint(1 << 22)),
                                                      shape))
                if info.name == "wcls":
                    per_row = info.shape[-1] // 32
                    for row, byte in (boost_rows or {}).items():
                        blocks = arr[row * per_row:(row + 1) * per_row]
                        blocks[:, :2] = np.frombuffer(np.float16(0.5).tobytes(), np.uint8)
                        blocks[:, 2:] = byte
                w.write_raw(info.name, arr)
            else:
                w.write_tensor(info.name,
                               (rng.randn(*info.shape) * 0.02).astype(np.float32)
                               if info.name == "token_embedding"
                               else np.ones(info.shape, np.float32))


def synth_tokenizer(path_t: str, tfile, chat_stop: str | None = None):
    """A 32000-piece `.t` (the vocab of Llama-2 and Mixtral): a few words,
    the byte pieces, ChatML markers and filler pieces; returns its data."""
    words = [b" ", b"a", b"e", b"o", b"t", b"he", b"the", b" the", b"on", b"ce",
             b" upon", b" time", b"Once", b" capital", b" of", b" France", b" is"]
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += words + [b"<|im_start|>", b"<|im_end|>"]
    vocab += [f"<extra_{i}>".encode() for i in range(len(vocab), LLAMA2_7B["vocab_size"])]
    data = tfile.TokenizerData(
        vocab=vocab, scores=[float(len(v)) if v in words else 0.0 for v in vocab],
        bos_id=1, eos_id=2, chat_eos_id=vocab.index(b"<|im_end|>"),
        chat_template=CHATML, chat_stop=chat_stop)
    tfile.write_tfile(path_t, data)
    return data


def run_cli(cli, argv: list[str]):
    """One CLI command in-process; returns (engine, captured stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        engine = cli.main(argv)
    torch.cuda.synchronize()
    return engine, buf.getvalue()


def main_path(cli, codec, m: str, t: str, want, extra: tuple = (),
              keep: bool = False, key: str = "kernel_launches"):
    """Phases 3, 10, 11, 14: ``inference`` through the CLI (its decode steps
    replaying captured CUDA graphs) with ``codec``'s (q40 or q8) counters
    set to 0 just before it and read just after; ``want(engine)`` is the
    run's exact launch count of counter ``key`` (``blocked_launches``:
    kernel 3, with no launch of kernels 1-2; else kernels 1-2 with no
    launch of kernel 3).  Then the decode profile and the graphs on/off
    pass (:func:`graphs_ab`).  Returns the run's numbers (and the engine,
    with ``keep``)."""
    # an earlier phase's server can linger in reference cycles: free it
    # before the peak-memory reading starts
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    codec.reset_counters()
    engine, out = run_cli(cli, ["inference", "--model", m, "--tokenizer", t,
                                "--temperature", "0", "--steps", "64",
                                "--chunk", "16", "--warmup", "16", *extra])
    c = codec.counters()
    peak = torch.cuda.max_memory_allocated()
    print("\n".join(out.splitlines()[-8:]))
    other = "kernel_launches" if key == "blocked_launches" else "blocked_launches"
    if c[key] != want(engine) or c.get(other, 0) or c["plain_calls"]:
        raise AssertionError(f"main path did not run every matmul through the kernel: "
                             f"{c} over {engine.forwards} forwards, want "
                             f"{want(engine)} {key}")
    tps = float(re.search(r"Avg tokens / second: ([\d.]+)", out).group(1))
    load_s = cli.last_read_s
    ms = float(re.search(r"Avg generation time: ([\d.]+) ms", out).group(1))
    if not torch.isfinite(engine.last_logits).all():
        raise AssertionError("main path ended on non-finite logits")
    print(f"main path: {tps} tok/s, {ms} ms/token, peak device memory "
          f"{peak / 2**30:.2f} GiB, {engine.forwards} forwards, "
          f"{c[key]} {key}")
    prof = profile_decode(engine, ms, codec)
    # tensor parallelism (phase 17) runs eagerly: no graphs to compare
    ab = graphs_ab(engine, codec, key) if engine.graphs is not None else {}
    run = dict(counts=c, tok_s=tps, ms_token=ms, peak_bytes=peak, load_s=load_s, **prof,
               **ab, pieces=token_pieces(out))
    if keep:
        return run, engine
    del engine
    torch.cuda.empty_cache()
    return run


def token_pieces(out: str) -> list[str]:
    """The token pieces an ``inference`` run printed, one a G/I/T line
    (their repr, as printed)."""
    return [ln.split("| ", 1)[1] for ln in out.splitlines() if ln.startswith("🔶")]


def matmul_kernel(name: str, codec_name: str) -> bool:
    """Is profiler kernel ``name`` one of the ``codec_name`` (q40 or q8)
    kernel's: its decode body (``gemv_kernel<(anonymous namespace)::Q4V<v>,
    ...>``, v the dequant variant; Q80's ``...::Q8, ...``), its tensor-core
    body (``wgmma_matmul<...::Q4V<v>, ...>``, ``wgmma_matmul<...::Q8,
    ...>``) and split reduce (``reduce_splits<...::Q4V<0> >``,
    ``reduce_splits<...::Q8>``), or a kernel named ``q40_...``/``q8_...``
    (an older tree's tensor-core body)?"""
    codec_tags = {"q40": ("::Q4V<",), "q8": ("::Q8,", "::Q8>")}[codec_name]
    return f"{codec_name}_" in name or any(tag in name for tag in codec_tags)


def tensor_core_kernel(name: str, codec_name: str) -> bool:
    """Is profiler kernel ``name`` the ``codec_name`` kernel's tensor-core
    body or its split reduce (any of its kernels but the decode body)?"""
    return matmul_kernel(name, codec_name) and "gemv_kernel" not in name


def device_rows(fn, n: int) -> list:
    """torch.profiler over ``fn()``, which makes ``n`` calls: (device ms a
    call, launches a call, name) of every kernel it recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / n / 1e3, e.count // n, e.key))
    return rows


def profile_decode(engine, ms_token: float | None, codec, steps: int = 8,
                   prompts: list[list[int]] | None = None) -> dict:
    """Where a decode token's time goes: torch.profiler over ``steps``
    greedy decode steps of the main path's engine through
    ``Engine.decode`` (each step a replay of its captured graph when the
    engine's graphs are on).  Device busy time per token is the sum of the
    kernels' device times (``codec``, q40 or q8, picks out the matmul
    kernel's); the idle share compares it with the unprofiled ms/token of
    the run above.  With ``prompts`` (a batch engine) the steps are
    lockstep steps of the ragged batch after ``prefill_ragged``, and the
    unprofiled wall (``ms_token`` None) is taken here: host clock around
    the same steps, synchronized.  The profiled steps' matmuls take the
    body ``codec.route`` names for the batch's rows: tensor-core launches
    there, and only there.  Should the profiler see no kernel inside the
    graphs, the steps are profiled again eagerly (the same kernels).
    Returns the busy ms and idle share (None: not measured)."""
    engine.reset()
    if prompts is None:
        engine.prefill([1, 2, 3, 4])
    else:
        engine.prefill_ragged(prompts)
    unit = "token" if engine.batch == 1 else "step"
    tok = torch.full((engine.batch,), 4, dtype=torch.int32, device=engine.device)
    p0 = engine.pos

    def run():
        engine.pos = p0
        engine.decode(tok, steps, temperature=0.0, topp=0.9)
        torch.cuda.synchronize()

    run()
    if ms_token is None:
        t0 = time.perf_counter()
        run()
        ms_token = (time.perf_counter() - t0) * 1e3 / steps
    saved, rows = engine.graphs, []
    for graphs in ((saved, None) if saved is not None else (None,)):
        engine.graphs = graphs
        codec.reset_counters()
        rows = device_rows(run, steps)
        if rows:
            how = "graph replays" if graphs is not None else "eager steps"
            if graphs is None and saved is not None:
                how += " (the profiler saw no kernel inside the graphs)"
            break
    engine.graphs = saved
    c = codec.counters()
    mm_launches = c["kernel_launches"] + c.get("blocked_launches", 0)
    if not mm_launches or bool(c["mma_launches"]) != (codec.route(engine.batch) == "mma"):
        raise AssertionError(f"{engine.batch}-row decode steps: {c}, want the "
                             f"{codec.route(engine.batch)} body")
    print(f"{codec.__name__.rsplit('.', 1)[1]} launches over the {steps} steps: "
          f"{mm_launches}, {c['mma_launches']} on the tensor-core body")
    kname = codec.__name__.rsplit(".", 1)[1]
    if not rows:
        print("decode profile: the profiler recorded no device time (not measured)")
        return dict(busy_ms=None, idle=None, ms=ms_token)
    busy = sum(r[0] for r in rows)
    mm_ms = sum(r[0] for r in rows if matmul_kernel(r[2], kname))
    ar_ms = sum(r[0] for r in rows if "tp_allreduce" in r[2])
    if ar_ms:
        print(f"kernel 4 (tp_allreduce): {ar_ms:.4f} ms/{unit}")
    split_reduce = [r[2] for r in rows if "reduce_splits" in r[2]]
    if codec.route(engine.batch) == "gemv":
        # the decode body is one launch a call: no split-reduce pass
        if split_reduce:
            raise AssertionError(f"decode-body steps launched {split_reduce}")
        print("no *_reduce_splits kernel in the decode steps (one launch a matmul)")
    print(f"decode profile ({steps} steps, {engine.batch} row(s), {how}): device busy "
          f"{busy:.3f} ms/{unit} of {ms_token:.3f} ms/{unit} unprofiled -> idle share "
          f"{1 - busy / ms_token:.3f}; {kname} kernels {mm_ms:.3f} ms/{unit}, other "
          f"kernels {busy - mm_ms:.3f} ms/{unit}, {sum(r[1] for r in rows)} kernel "
          f"launches/{unit}")
    for ms_, n, name in sorted(rows, reverse=True)[:10]:
        print(f"  {ms_:8.4f} ms/{unit} {n:5d}x  {name[:90]}")
    return dict(busy_ms=busy, idle=1 - busy / ms_token, ms=ms_token)


def prompt_profile(engine, codec, n_tokens: int) -> dict:
    """Phase 10: where a prompt forward's time goes.  torch.profiler over one
    ``Engine.prefill`` of ``n_tokens`` tokens (padded to its bucket; eager,
    after one unprofiled prefill), on a reset engine: device busy ms, the
    ``codec`` kernel's tensor-core body (and its split reduce) and its
    share, and the kernels that take the time.  Returns the numbers (None:
    not measured)."""
    ids = np.random.RandomState(6).randint(3, engine.cfg.vocab_size, n_tokens).tolist()

    def run():
        engine.reset()
        engine.prefill(ids)
        torch.cuda.synchronize()

    run()
    codec.reset_counters()
    rows = device_rows(run, 1)
    c = codec.counters()
    kname = codec.__name__.rsplit(".", 1)[1]
    if not rows:
        print("prompt-forward profile: the profiler recorded no device time (not measured)")
        return dict(prompt_busy_ms=None, prompt_tc_ms=None)
    busy = sum(r[0] for r in rows)
    tc = sum(r[0] for r in rows if tensor_core_kernel(r[2], kname))
    print(f"prompt forward ({n_tokens} tokens, one prefill): device busy {busy:.3f} ms; the "
          f"{kname} tensor-core body {tc:.3f} ms ({tc / busy:.3f} of busy), "
          f"{c['mma_launches']} of {c['kernel_launches']} {kname} launches on it")
    for ms_, n, name in sorted(rows, reverse=True)[:8]:
        print(f"  {ms_:8.4f} ms {n:5d}x  {name[:90]}")
    return dict(prompt_busy_ms=busy, prompt_tc_ms=tc)


def graphs_ab(engine, codec, key: str, steps: int = 48) -> dict:
    """Phases 3, 10, 11 and 14: one greedy stream on the main path's engine
    with its decode graphs on, then off (every step eager) on the same
    engine: byte for byte the same tokens, and the same launch counters
    over the same forwards (the graphs add a captured step's launches at
    every replay).  Prints and returns each pass's decode ms/token (the
    stream's own G, the prefill left out)."""
    prompt = np.random.RandomState(5).randint(3, engine.cfg.vocab_size, 5).tolist()
    saved = engine.graphs
    runs = {}
    for name, graphs in (("on", saved), ("off", None)):
        engine.graphs = graphs
        engine.reset()
        codec.reset_counters()
        f0 = engine.forwards
        toks, g = [], []
        for tok, st in engine.generate_stream(prompt, steps, temperature=0.0):
            toks.append(tok)
            if st.generation_ms > 0 and len(toks) > len(prompt):
                g.append(st.generation_ms)
        torch.cuda.synchronize()
        runs[name] = (toks, codec.counters(), engine.forwards - f0, float(np.mean(g)))
    engine.graphs = saved
    (t_on, c_on, f_on, ms_on), (t_off, c_off, f_off, ms_off) = runs["on"], runs["off"]
    if t_on != t_off:
        raise AssertionError(f"greedy stream differs with graphs on and off: {t_on} {t_off}")
    if c_on != c_off or f_on != f_off:
        raise AssertionError(f"launch counters differ with graphs on and off over "
                             f"{f_on}/{f_off} forwards: {c_on} / {c_off}")
    print(f"graphs on/off: the same {steps - len(prompt)} greedy tokens byte for byte, the "
          f"same launches ({c_on[key]} {key} over {f_on} forwards, {c_on[key] / f_on:g} a "
          f"forward; plain {c_on['plain_calls']}); decode wall {ms_on:.3f} ms/token with "
          f"graphs, {ms_off:.3f} without; {saved.captures} graphs captured, "
          f"{saved.replays} replays")
    return dict(ms_on=ms_on, ms_off=ms_off)


def greedy_repeat(engine, steps: int = 24) -> None:
    """Phases 3 and 10: the same greedy decode twice from position 0 (a 16-row
    prompt forward, then single-token forwards on the decode body) gives
    the same tokens."""
    prompt = np.random.RandomState(3).randint(3, LLAMA2_7B["vocab_size"], 5).tolist()
    runs = []
    for _ in range(2):
        engine.reset()
        runs.append([tok for tok, _ in engine.generate_stream(prompt, steps,
                                                              temperature=0.0)])
    if runs[0] != runs[1]:
        raise AssertionError(f"greedy decode differs between two runs: {runs}")
    print(f"greedy decode of {steps - len(prompt)} tokens repeats token for token")


def requests(cli, q40, m: str, t: str) -> None:
    """Phase 4."""
    base = ["generate", "--model", m, "--tokenizer", t, "--steps", "40"]
    runs = [("Once upon a time", ["--temperature", "0"], 2),
            ("The capital of France is", ["--temperature", "0"], 2),
            ("hello", ["--temperature", "0.8", "--seed", "1"], 1)]
    for prompt, extra, repeats in runs:
        outs = []
        for _ in range(repeats):
            q40.reset_counters()
            engine, out = run_cli(cli, base + ["--prompt", prompt] + extra)
            if not torch.isfinite(engine.last_logits).all():
                raise AssertionError(f"{prompt!r}: non-finite logits")
            outs.append(out)
            del engine
        if len(set(outs)) != 1:
            raise AssertionError(f"greedy {prompt!r} differs between two runs")
        text = [ln for ln in outs[0].splitlines() if not ln.startswith("💡")]
        print(f"{prompt!r} {' '.join(extra)}: {len(text[0])} chars"
              + (", repeats byte for byte" if repeats > 1 else ""))
    torch.cuda.empty_cache()


LEGACY_PROMPT = "Once upon a time"


def write_legacy(mfile, v2_path: str, path: str) -> None:
    """The legacy-magic twin of a v2 file, as the reference's older
    converters wrote it: the arch as the magic, the 9-int header (no
    weights float type), then the v2 file's tensor bytes."""
    spec = mfile.read_spec(v2_path)
    head = struct.pack("<10i", spec.arch, spec.dim, spec.hidden_dim, spec.n_layers,
                       spec.n_heads, spec.n_kv_heads, spec.n_experts, spec.n_active_experts,
                       spec.vocab_size, spec.seq_len)
    with open(v2_path, "rb") as src, open(path, "wb") as dst:
        dst.write(head)
        src.seek(spec.header_size)
        shutil.copyfileobj(src, dst, 16 << 20)


def legacy_and_dense(cli, q40, mfile, m2: str, t: str) -> None:
    """Phase 24: the same synthesized weights from a legacy-magic file (read
    with ``--weights-float-type q40``) and from the v2 file: ``generate``'s
    greedy bytes equal, every Q40 matmul on the kernels; then ``inference
    --dequantize`` on the legacy file: dense bf16 weights (their products
    plain matmuls: no Q40 launch), finite logits, its greedy text beside the
    kernels' (the dequantized weights round to bf16, so a near tie may go
    the other way)."""
    legacy = m2 + ".legacy"
    write_legacy(mfile, m2, legacy)
    base = ["--tokenizer", t, "--prompt", LEGACY_PROMPT, "--temperature", "0"]
    texts = {}
    try:
        for label, extra in (("v2", ["--model", m2]),
                             ("legacy", ["--model", legacy, "--weights-float-type", "q40"])):
            q40.reset_counters()
            eng, out = run_cli(cli, ["generate", "--steps", "48", *base, *extra])
            c = q40.counters()
            if c["plain_calls"] or not c["kernel_launches"] or not torch.isfinite(
                    eng.last_logits).all():
                raise AssertionError(f"{label}: Q40 counters {c}, finite logits "
                                     f"{bool(torch.isfinite(eng.last_logits).all())}")
            texts[label] = [ln for ln in out.splitlines() if not ln.startswith("💡")]
            del eng
        if texts["v2"] != texts["legacy"]:
            raise AssertionError(f"the legacy file's greedy text differs from its v2 twin's: "
                                 f"{texts['legacy']!r} vs {texts['v2']!r}")
        print(f"legacy-magic file (--weights-float-type q40) and its v2 twin: the same "
              f"{len(texts['v2'][0])} greedy chars, every Q40 matmul on the kernels")
        q40.reset_counters()
        eng, out = run_cli(cli, ["inference", "--steps", "32", "--model", legacy,
                                 "--weights-float-type", "q40", "--dequantize", *base])
        c = q40.counters()
        packed = [k for k, v in eng.params.items() if not isinstance(v, torch.Tensor)]
        if c["kernel_launches"] or c["plain_calls"] or packed or not torch.isfinite(
                eng.last_logits).all():
            raise AssertionError(f"--dequantize: Q40 counters {c}, packed weights {packed}")
        dense = {str(eng.params[k].dtype) for k in ("wq", "wo", "w1", "w2", "wcls")}
        rate = [ln for ln in out.splitlines() if ln.startswith("Avg tokens / second")]
        print(f"--dequantize inference on the legacy file: weights {sorted(dense)}, no Q40 "
              f"launch, finite logits; {rate[0] if rate else ''}")
        del eng
    finally:
        os.remove(legacy)
    torch.cuda.empty_cache()


@contextlib.contextmanager
def routing_log(transformer, cfg, log: list):
    """Record the experts each MoE layer selects during one run (phase
    12): the router's top-k wrapped for the run's duration.  A no-op for a
    dense model."""
    if not cfg.is_moe:
        yield log
        return
    real = transformer.top_k

    def rec(x, k):
        vals, idx = real(x, k)
        log.append(idx.sort(dim=-1).values)
        return vals, idx

    transformer.top_k = rec
    try:
        yield log
    finally:
        transformer.top_k = real


def routing_note(routes: dict) -> str:
    """How many token-layers chose another expert set in the kernel run
    than in the plain run: a near-tie of router probabilities that the two
    runs' f32 summation orders decide differently."""
    a, b = routes["auto"], routes["plain"]
    if not a:
        return ""
    flips = sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
    return (f"; expert sets differ at {flips} of {sum(x.shape[0] for x in a)} "
            f"token-layers")


def load_bf16(mfile, params_mod, config, path: str, dev, fuse: bool = True):
    """The model at ``path`` on the card with bf16 activations (phases 5,
    8, 12 load it once for both of their checks; phase 19 unfused, on the
    host, for the ranks' slices)."""
    with mfile.MFile(path) as mf:
        return params_mod.load_params(
            mf, config.ModelConfig.from_spec(mf.spec, dtype=torch.bfloat16), device=dev,
            fuse=fuse)


def new_cache(transformer, cfg, dev, mesh=None, quant: bool = False):
    """A batch-1 contiguous cache on ``dev`` (int8 with ``quant``), or one a
    rank of ``mesh``."""
    if mesh is None:
        return transformer.init_kv_cache(cfg, 1, quant=quant, device=dev)
    return transformer.ShardedKV(tuple(transformer.init_kv_cache(cfg, 1, device=d, tp=mesh.tp)
                                       for d in mesh.devices))


def end_to_end(transformer, cfg, params, dev, label: str = "2 layers, bf16",
               mesh=None, quant: bool = False) -> None:
    """Phases 5, 12, 19 and 20b: prefill + 8 teacher-forced decode steps at
    batch 1, the kernels (``auto``) against ``quant_impl="plain"`` (params
    placed over ``mesh`` when given: kernel 4 against its plain version
    too; ``quant``: on the contiguous int8 cache)."""
    rng = np.random.RandomState(1)
    prompt = torch.from_numpy(rng.randint(3, cfg.vocab_size, (1, 12))).to(dev)
    forced = rng.randint(3, cfg.vocab_size, 8).tolist()
    logits, routes = {}, {"auto": [], "plain": []}
    for impl in ("auto", "plain"):
        c = cfg.with_(quant_impl=impl)
        cache = new_cache(transformer, c, dev, mesh, quant)
        with routing_log(transformer, cfg, routes[impl]):
            steps = [transformer.forward_last(params, c, prompt, cache, 0, 11)[0]]
            for i, tok in enumerate(forced):
                x = torch.tensor([[tok]], device=dev)
                steps.append(transformer.forward_last(params, c, x, cache, 12 + i, 0)[0])
        logits[impl] = torch.stack(steps).float()
    k, p = logits["auto"], logits["plain"]
    err, scale = float((k - p).abs().max()), float(p.abs().max())
    if not (torch.isfinite(k).all() and err <= E2E_TOL * scale):
        raise AssertionError(f"kernel vs plain logits: {err} > {E2E_TOL} * {scale}")
    # a top-2 margin above twice the largest logit difference cannot flip
    # the argmax: there the greedy tokens must agree
    top2 = p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = k.argmax(-1) == p.argmax(-1)
    if not bool(agree[decided].all()):
        raise AssertionError("greedy tokens differ where the margin is decisive")
    print(f"end to end ({label}): max|kernel-plain| {err:.4g} of max|plain| "
          f"{scale:.4g} ({err / scale:.2e}, limit {E2E_TOL:g}); greedy agrees at "
          f"{int(decided.sum())}/9 steps whose top-2 margin exceeds 2x that "
          f"({int(agree.sum())}/9 overall){routing_note(routes)}")


def layer_gaps(transformer, cfg, params, dev, label: str) -> None:
    """Phase 12: where the kernel path's logits leave the plain path's.  A
    12-token prefill through the layer loop written out, kernels (``auto``)
    and ``quant_impl="plain"``: after each block the largest difference
    of the two runs' attention output, FFN output and residual stream, each
    against the plain run's largest value ("chained": each run on its own
    stream); then each block of the kernel path fed the plain run's input
    of that block ("alone": the block's own difference, a fresh cache for
    attention).  The last token's residual is given with its mean and
    spread and how many of its normed values differ, and the logits' gap
    also against their spread about their mean: the synthesized weights'
    codes have a mean of -0.5 (Q40 nibbles less 8, Q80 bytes) times the
    scale, 16x larger for Q40, which puts a common offset on the residual
    stream whose bf16 ulp can swallow a last-bit difference."""
    rng = np.random.RandomState(1)
    prompt = torch.from_numpy(rng.randint(3, cfg.vocab_size, (1, 12))).to(dev)

    def ffn(c, x, layer):
        xb = transformer.rmsnorm(x, params["rms_ffn"][layer])
        if c.is_moe:
            return transformer.moe_ffn(xb.reshape(-1, c.dim), params, layer, c).reshape(x.shape)
        return transformer._dense_ffn(xb, params, layer, c)

    runs = {}
    for impl in ("auto", "plain"):
        c = cfg.with_(quant_impl=impl)
        cache = new_cache(transformer, c, dev)
        x, cos, sin = transformer._embed(params, c, prompt, 0)
        rec = []
        for layer in range(c.n_layers):
            x_in = x
            att = transformer._attention_block(x, params, layer, c, cache, cos, sin, 0)
            x = x + att
            ff = ffn(c, x, layer)
            rec.append((x_in, att, x, ff))
            x = x + ff
        runs[impl] = (rec, x, transformer._head(params, c, x[:, -1]), cos, sin)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())

    auto, plain = runs["auto"], runs["plain"]
    ca = cfg.with_(quant_impl="auto")
    for layer, ((_, att_a, mid_a, ff_a), (x_in, att_p, mid_p, ff_p)) in enumerate(
            zip(auto[0], plain[0])):
        att_alone = transformer._attention_block(x_in, params, layer, ca,
                                                 new_cache(transformer, ca, dev),
                                                 plain[3], plain[4], 0)
        ff_alone = ffn(ca, mid_p, layer)
        print(f"{label}: layer {layer}: chained attention {rel(att_a, att_p):.2e}, "
              f"residual after it {rel(mid_a, mid_p):.2e}, FFN {rel(ff_a, ff_p):.2e}; alone "
              f"attention {rel(att_alone, att_p):.2e}, FFN {rel(ff_alone, ff_p):.2e}")
    la, lp = auto[2].float(), plain[2].float()
    centred = float((lp - lp.mean()).abs().max())
    xa, xp = auto[1][0, -1], plain[1][0, -1]
    na, nq = (transformer.rmsnorm(x, params["rms_final"]) for x in (xa, xp))
    print(f"{label}: final residual {rel(auto[1], plain[1]):.2e}; the last token's residual "
          f"{rel(xa, xp):.2e} (plain: mean {float(xp.float().mean()):.4g}, std "
          f"{float(xp.float().std()):.4g}), its normed {na.dtype} values differ at "
          f"{int((na != nq).sum())} of {na.numel()}; last-token logits {rel(la, lp):.2e} of "
          f"max|plain| {float(lp.abs().max()):.4g} (mean {float(lp.mean()):.4g}, std "
          f"{float(lp.std()):.4g}), {float((la - lp).abs().max()) / centred:.2e} of "
          f"max|plain - mean|")


def moe_decode_checks(engine, transformer, q40, dev) -> None:
    """Phase 11, on the main path's engine: one single-token forward
    launches exactly (2 + 3k) * L + 1 Q40 kernels (wqkv, wo, k experts'
    gate/up/down a layer, wcls); the decode-route MoE FFN of the last layer
    (1 and 3 tokens) runs under sync-debug "error" (the expert ids of the
    top-k on the card reach the kernels as device indices, never through
    the host) and agrees with its plain version within E2E_TOL."""
    cfg, params = engine.cfg, engine.params
    want = (2 + 3 * cfg.n_active_experts) * cfg.n_layers + 1
    q40.reset_counters()
    engine.decode_one(5)
    c = q40.counters()
    if c["kernel_launches"] != want or c["plain_calls"]:
        raise AssertionError(f"a single-token Mixtral forward: {c}, want {want} launches")
    print(f"one single-token forward: {c['kernel_launches']} Q40 kernel launches, "
          f"0 plain ({c['launches_by_shape']})")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    layer = cfg.n_layers - 1
    for n in (1, 3):
        x = torch.randn((n, cfg.dim), generator=g, device=dev).to(cfg.dtype)
        torch.cuda.synchronize()
        q40.reset_counters()
        torch.cuda.set_sync_debug_mode("error")
        try:
            k = transformer.moe_ffn(x, params, layer, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = q40.counters()["kernel_launches"]
        p = transformer.moe_ffn(x, params, layer, cfg.with_(quant_impl="plain"))
        err, scale = float((k.float() - p.float()).abs().max()), float(p.float().abs().max())
        if launches != 3 * cfg.n_active_experts * n or not (
                torch.isfinite(k).all() and err <= E2E_TOL * scale):
            raise AssertionError(f"decode-route moe_ffn, {n} tokens: {launches} launches, "
                                 f"max|kernel-plain| {err} of {scale}")
        print(f"decode-route moe_ffn, {n} token(s), layer {layer}: no host sync, "
              f"{launches} kernel launches, max|kernel-plain| {err:.4g} of {scale:.4g}")


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else float("nan")


def attn_bound(pos, hkv: int, dh: int, hq: int, kv_bytes: float,
               q_bytes: int = 2) -> tuple[float, str]:
    """Least time for one paged decode read: the live K/V positions
    (pos_b + 1 per row, K and V, ``kv_bytes`` per element plus 4-byte
    scales for int8) read once, q read and the output written once
    (``q_bytes`` an element), against the HBM rate; 4 flops per K/V
    element (QK and PV) against the bf16 peak."""
    live = sum(int(p) + 1 for p in pos)
    nbytes = live * hkv * 2 * (dh * kv_bytes + (4 if kv_bytes == 1 else 0))
    nbytes += len(pos) * hq * dh * q_bytes * 2 + len(pos) * 4
    b_ms = nbytes / HBM_BYTES_S * 1e3
    o_ms = 4.0 * live * hq * dh / BF16_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# a pool codec's (pool dtype, q dtype) in phases 6 and 6c: an int8 pool's
# operand is bf16; an f16 pool takes f16 queries (--buffer-float-type f16;
# phase 6s serves it under bf16 ones), an f32 pool f32 ones
ATTN_CODECS = {"bf16": (torch.bfloat16, torch.bfloat16), "int8": (torch.int8, torch.bfloat16),
               "f16": (torch.float16, torch.float16), "f32": (torch.float32, torch.float32)}
# head dims other than 128 (phases 6 and 6c): the widths the kernels took
# no body for before (16 and 32 whole 64-column slabs of zeros for the
# tensor cores; 80 and 96 a partial slab; 256 one consumer warpgroup a
# block), on the bf16 and int8 pools, and f32 at 96 (kernel 8's FFMA body)
ATTN_DH = (16, 32, 80, 96, 256)
ATTN_DH_F32 = 96
# query heads on kv heads past kernel 7's 8 a block (G = 16: two head
# groups of 8 a kv head)
ATTN_G16_HKV = 2


def _pools(attention, codec: str, shape, g) -> tuple:
    """Random K and V pools of ``codec`` (values 0.5·N(0, 1); int8 with its
    scale planes) on the card: (pk, pv, scales, bytes an element)."""
    dev = g.device
    if codec == "int8":
        pk, sk = attention.quantize_kv(torch.randn(shape, generator=g, device=dev) * 0.5)
        pv, sv = attention.quantize_kv(torch.randn(shape, generator=g, device=dev) * 0.5)
        return pk, pv, (sk, sv), 1
    dt = ATTN_CODECS[codec][0]
    pk = (torch.randn(shape, generator=g, device=dev) * 0.5).to(dt)
    pv = (torch.randn(shape, generator=g, device=dev) * 0.5).to(dt)
    return pk, pv, None, pk.element_size()


def check_paged_attention(attention, dev, hkv: int = LLAMA2_7B["n_kv_heads"],
                          codecs=("bf16", "int8"), dh: int = 128) -> dict:
    """Phase 6, 32 query heads on ``hkv`` kv heads of ``dh``; returns
    {codec: numbers} for the JSON line."""
    B, H, DH, L = 8, LLAMA2_7B["n_heads"], dh, 3
    maxp = LLAMA2_7B["seq_len"] // PAGE
    n_pages = 1 + B * maxp
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rng = np.random.RandomState(6)
    # each row owns its own pages, in a random physical order
    table = torch.from_numpy((1 + rng.permutation(B * maxp)).reshape(B, maxp)
                             .astype(np.int32)).to(dev)
    pos = torch.tensor(ATTN_POS, dtype=torch.int32, device=dev)
    q32 = torch.randn((B, H, 1, DH), generator=g, device=dev)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    shape = (L, n_pages, hkv, PAGE, DH)
    out = {}
    n_hg, gb = attention.head_groups(H // hkv)
    splits, pps = attention.split_plan(maxp, B, hkv * n_hg,
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"{H} query heads on {hkv} kv heads of {DH} ({n_hg} block(s) of {gb} a kv head); "
          f"split page walk: {splits} splits of {pps} pages, "
          f"{attention.stage_pages(PAGE, pps)} pages a ring stage")
    print("codec  kernel_ms  plain_ms  sdpa_ms  bound_ms(by)  share  max_abs_err  rel")
    for codec in codecs:
        q = q32.to(ATTN_CODECS[codec][1])
        pk, pv, scales, kv_bytes = _pools(attention, codec, shape, g)
        err = 0.0
        for layer in (0, L - 1):
            k = attention.paged_attention(q, pk, pv, layer, table, pos, scales)
            p = attention.paged_decode_attention(q, pk, pv, layer, table, pos, scales)
            torch.cuda.synchronize()
            e = float((k.float() - p.float()).abs().max())
            scale = float(p.float().abs().max())
            if not (torch.isfinite(k).all() and e <= ATTN_TOL * scale):
                raise AssertionError(f"paged attention {codec} layer {layer}: "
                                     f"max|kernel-plain| {e} > {ATTN_TOL} * {scale}")
            err = max(err, e)
        layer = L - 1
        k_ms = cold_ms(lambda: attention.paged_attention(q, pk, pv, layer, table, pos,
                                                         scales), 20, flush)
        p_ms = cold_ms(lambda: attention.paged_decode_attention(q, pk, pv, layer, table,
                                                                pos, scales), 3, flush)
        ks, vs = scales if scales is not None else (None, None)
        kg = attention.paged_gather_layer(pk, layer, table, ks).to(q.dtype)
        vg = attention.paged_gather_layer(pv, layer, table, vs).to(q.dtype)
        mask = (torch.arange(kg.shape[2], device=dev)[None, :] <= pos[:, None].long())
        mask = mask[:, None, None, :]
        l_ms = cold_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask, enable_gqa=H != hkv), 20, flush)
        b_ms, by = attn_bound(ATTN_POS, hkv, DH, H, kv_bytes, q.element_size())
        print(f"{codec:5s} {k_ms:10.4f} {p_ms:9.4f} {l_ms:8.4f} {b_ms:9.4f}({by[0]}) "
              f"{b_ms / k_ms:6.1%} {err:12.6g} {err / scale:.2e}")
        out[codec] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=by, library_ms=l_ms)
        del pk, pv, scales, kg, vg
    del flush
    torch.cuda.empty_cache()
    return out


def prefill_bound(pos, t: int, hkv: int, dh: int, hq: int, kv_bytes: float,
                  ceiling: int) -> tuple[float, str]:
    """Least time for one mixed-step attention read of ``t`` query tokens a
    row: each row's live K/V positions (0..pos_b + t - 1, at most
    ``ceiling``; K and V, ``kv_bytes`` an element plus 4-byte scales for
    int8) read once, q read and the output written once (in the operand
    type: f32 for an f32 pool, else bf16), against the HBM rate; 4 flops a
    visible (query, key) pair an element (QK and PV; token i of row b sees
    pos_b + i + 1 keys) against the bf16 tensor-core peak, or the f32 peak
    outside the tensor cores for an f32 pool (its body runs FFMA)."""
    live = sum(min(int(p) + t, ceiling) for p in pos)
    nbytes = live * hkv * 2 * (dh * kv_bytes + (4 if kv_bytes == 1 else 0))
    nbytes += len(pos) * hq * t * dh * (8 if kv_bytes == 4 else 4) + len(pos) * 4
    pairs = sum(min(int(p) + i + 1, ceiling) for p in pos for i in range(t))
    b_ms = nbytes / HBM_BYTES_S * 1e3
    o_ms = 4.0 * pairs * hq * dh / (F32_FLOPS if kv_bytes == 4 else BF16_FLOPS) * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def build_report(tag, what: str) -> None:
    """The instantiations of kernels whose mangled name holds ``tag`` (a
    string, or a tuple of strings that must all be there), from this
    process's nvcc run (``-Xptxas -v``): registers, spills and shared
    memory of each (``what`` names them)."""
    from dllama_tpu_torch.ops import _build
    tags = (tag,) if isinstance(tag, str) else tag
    lines = _build.build_log.splitlines()
    hits = [i for i, ln in enumerate(lines)
            if "Compiling entry function" in ln and all(t in ln for t in tags)]
    if not hits:
        print(f"{what} build report: the library was built before this process")
    for i in hits:
        name = re.search(r"'(_Z[^']*)'", lines[i])
        notes = [ln.split("ptxas info    :")[-1].strip() for ln in lines[i + 1:i + 5]
                 if "ptxas info" in ln and "Compiling" not in ln and "Function properties" not in ln]
        spills = [ln.strip() for ln in lines[i + 1:i + 5] if "spill" in ln]
        print(f"  {name.group(1) if name else lines[i]}: {'; '.join(notes + spills)}")


def prefill_build_report() -> None:
    """The prefill kernel's instantiations from this process's nvcc run."""
    build_report("prefill", "prefill kernel")


def body_report(codec) -> None:
    """Phases 2 and 9's head: the tensor-core body's instantiations for
    ``codec`` (q40 or q8: ``wgmma_matmul<Q4V<v>, ...>`` or ``<Q8, ...>``)
    from the build (registers and spills of each, and any wgmma the
    assembler serialized), and its block at each tile height as the build
    reports it against the plan's numbers (the codec's MMA_SMEM,
    MMA_STAGES)."""
    from dllama_tpu_torch.ops import _build
    is_q8 = codec.__name__.endswith(".q8")
    tags = ("wgmma_matmul", "2Q8E" if is_q8 else "Q4V")
    what = "Q80 tensor-core body" if is_q8 else "Q40 tensor-core body"
    build_report(tags, what)
    serial = [ln for ln in _build.build_log.splitlines() if "wgmma" in ln and "serializ" in ln]
    mine = [ln for ln in serial if all(t in ln for t in tags)]
    print(f"wgmma serialized by ptxas: {len(mine)} warning(s) in the {what}, {len(serial)} in "
          f"the build" + "".join(f"\n  {ln.strip()}" for ln in serial))
    for bm in codec.MMA_BMS:
        lay = codec.mma_layout(bm)
        print(f"{what} block, bm = {bm}: {lay}")
        if lay["smem"] != codec.MMA_SMEM[bm] or lay["stages"] != codec.MMA_STAGES[bm]:
            raise AssertionError(f"bm = {bm}: the build's block {lay} is not the plan's "
                                 f"(smem {codec.MMA_SMEM[bm]}, stages {codec.MMA_STAGES[bm]})")


def _prefill_rows_agree(attention, args, tol: float, label: str, pos_np,
                        head_max: bool = False):
    """Launch the prefill kernel twice on ``args`` (q of the main path's
    type) and once on an f32 q, whose output is f32 (the same operands:
    q rounds to the pool's operand either way); run the plain version on
    the f32 q.  Raise unless the two launches are equal bit for bit, the
    main path's output is the f32 one rounded, bit for bit, everything is
    finite, and each query row (row, head, token) of the f32 output is
    within ``tol`` of its own max|plain| (a long row averages over
    thousands of keys, and its outputs are far smaller than those of a row
    at position 0).  The two f32 outputs are compared before either rounds
    to bf16: that rounding alone moves a bf16 row up to one ulp (2^-7 of
    its max), and two roundings of answers that each sit within 0.7 % of
    the exact one (f64) can land 1.15e-2 of the max apart.  ``head_max``
    (head dims below 32: PREFILL_NARROW_DH): a query row's yardstick is the
    max|plain| over its (row, head)'s T query rows, since the max of a
    16-wide row is too small a scale for the probabilities' bf16 rounding
    (a row of 1000 keys at Dh 16 read 1.05e-2 of its own max).  Returns
    (max|kernel - plain|, max|plain|, each query row's relative error, and
    the same of the two outputs rounded to q's type)."""
    q, rest = args[0], args[1:]
    k = attention.prefill_attention(q, *rest)
    k2 = attention.prefill_attention(q, *rest)
    kf = attention.prefill_attention(q.float(), *rest)
    p = attention.paged_rows_attention(q.float(), *rest)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(k, k2)) and bool(torch.equal(k, kf.to(k.dtype)))
    diff = (kf - p).abs().amax(-1)  # (B, H, T): a query row each
    mag = p.abs().amax(-1)
    if head_max:
        mag = mag.amax(-1, keepdim=True).expand_as(mag)
    bad = diff > tol * mag
    if not torch.isfinite(kf).all() or bool(bad.any()) or not repeat:
        b_, h_, i_ = (int(x) for x in bad.nonzero()[0]) if bad.any() else (0, 0, 0)
        raise AssertionError(
            f"{label}: row {b_} (position {pos_np[b_]}) head {h_} token {i_}: "
            f"max|kernel-plain| {float(diff[b_, h_, i_])} > {tol} * {float(mag[b_, h_, i_])}; "
            f"finite {bool(torch.isfinite(kf).all())}, two launches equal and the output the "
            f"f32 one rounded {repeat}")
    tiny = torch.finfo(torch.float32).tiny
    rel = diff / mag.clamp_min(tiny)
    pr = p.to(k.dtype).float()
    rel_q = (k.float() - pr).abs().amax(-1) / pr.abs().amax(-1).clamp_min(tiny)
    return float(diff.max()), float(mag.max()), rel, rel_q


def check_prefill_pages(attention, dev) -> None:
    """Phase 6c at the page sizes of PREFILL_PAGES (7B shape, B = 8 rows at
    PREFILL_POS, 4096 positions a row, bf16 and int8 pools of 2 layers, T =
    16 and 256): the boxes of other sizes than 16's, boxes read past a
    short page and masked, pages of several segments.  The checks of
    ``_prefill_rows_agree`` at ATTN_TOL; prints the plan and the errors."""
    B, H, DH, L = 8, LLAMA2_7B["n_heads"], 128, 2
    hkv, seq = LLAMA2_7B["n_kv_heads"], LLAMA2_7B["seq_len"]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    rng = np.random.RandomState(17)
    print("page codec    t  splits x pages  groups  max_abs_err  rel  row_rel  bf16_row_rel  "
          "repeat")
    for ps in PREFILL_PAGES:
        maxp = -(-seq // ps)
        table_np = (1 + rng.permutation(B * maxp)).reshape(B, maxp).astype(np.int32)
        table_np[5, PREFILL_PAGE0_POS // ps:] = 0  # this row's table runs out into page 0
        table = torch.from_numpy(table_np).to(dev)
        shape = (L, 1 + B * maxp, hkv, ps, DH)
        for codec in ("bf16", "int8"):
            if codec == "int8":
                pk, sk = attention.quantize_kv(torch.randn(shape, generator=g, device=dev) * 0.5)
                pv, sv = attention.quantize_kv(torch.randn(shape, generator=g, device=dev) * 0.5)
                scales, kv_bytes = (sk, sv), 1
            else:
                pk = (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
                pv = (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
                scales, kv_bytes = None, 2
            for t in (16, 256):
                pos_np = np.array([min(p, seq - t) for p in PREFILL_POS], np.int32)
                pos = torch.from_numpy(pos_np).to(dev)
                q = torch.randn((B, H, t, DH), generator=g, device=dev).to(torch.bfloat16)
                err = row_err = abs_err = q_err = 0.0
                for layer in (0, L - 1):
                    e, scale, rel, rel_q = _prefill_rows_agree(
                        attention, (q, pk, pv, layer, table, pos, scales), ATTN_TOL,
                        f"prefill attention, pages of {ps}, {codec} t={t} layer {layer}", pos_np)
                    err, abs_err = max(err, e / scale), max(abs_err, e)
                    row_err = max(row_err, float(rel.max()))
                    q_err = max(q_err, float(rel_q.max()))
                plan = attention.prefill_plan(B, H, hkv, t, ps, DH, maxp, kv_bytes, n_sms)
                print(f"{ps:4d} {codec:5s} {t:4d} {plan.splits:4d} x {plan.pps:4d} "
                      f"{plan.groups:7d} {abs_err:12.6g} {err:.2e} {row_err:.2e} {q_err:.2e}  "
                      "True")
                del q
            del pk, pv, scales
            torch.cuda.empty_cache()


def check_prefill_attention(attention, dev, hkv: int, codecs=("bf16", "int8", "f32"),
                            dh: int = 128, widths=None) -> dict:
    """Phase 6c: the prefill kernel (t > 1 query rows over the paged pool)
    against its plain version (the gather, then the one-shot per-row-ceiling
    attention), 32 query heads on ``hkv`` kv heads, B = 8 rows at
    PREFILL_POS (position 0, mid-page, across a page edge, near 4095), 256
    pages of 16 a row, layers 0 and L-1 of a 3-layer pool, bf16, int8 and
    f32 pools.  Before each read the step's K/V is written as the slot step
    writes it (``paged_write_indices``): rows 1, 3 and 6 have n_valid < T,
    so their padded tokens go to scratch page 0; row 5's table runs out
    after 40 pages (its later positions read page 0).  The widths are
    PREFILL_T and the shape's wide steps (PREFILL_T_WIDE: 128 query rows a
    kv head, and 256 in two row groups).  Each query row (row, head, token)
    of the kernel's f32 output is held to ATTN_TOL of its own max|plain|
    (an f32 pool to PREFILL_F32_TOL), the main path's output must be that
    output rounded, and a second launch must equal the first, bit for bit
    (``_prefill_rows_agree``).
    Prints the plan (splits of pages, row groups) and the block's layout as
    the build reports it (consumer warpgroups, threads, shared memory, ring
    stages, consumer registers), max|kernel -
    plain| / max|plain| over the case, the worst query row's relative
    error, and the worst among the rows at positions >= 300, the kernel's
    time (cold L2, median of 20), the plain version's, the bound and SDPA's
    on K/V pre-gathered to the operand type with the boolean per-row mask
    (a yardstick the port never calls).  ``dh`` and ``widths`` (default
    PREFILL_T and the shape's wide steps) vary the head dim and the steps.
    Returns {(codec, t): numbers}."""
    B, H, DH, L = 8, LLAMA2_7B["n_heads"], dh, 3
    maxp = LLAMA2_7B["seq_len"] // PAGE
    n_pages = 1 + B * maxp
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    rng = np.random.RandomState(16)
    table_np = (1 + rng.permutation(B * maxp)).reshape(B, maxp).astype(np.int32)
    table_np[5, PREFILL_PAGE0_POS // PAGE:] = 0  # this row's table runs out into page 0
    table = torch.from_numpy(table_np).to(dev)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    shape = (L, n_pages, hkv, PAGE, DH)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    widths = widths or PREFILL_T + PREFILL_T_WIDE[H // hkv]
    out = {}
    print(f"{H} query heads on {hkv} kv heads of {DH}, 256 pages of {PAGE} a row, tiles of "
          f"{attention.PREFILL_KEYS} keys; the block's layout as the build reports it "
          "(consumer warpgroups, threads, shared memory, ring stages, consumer registers "
          "after setmaxnreg, 0: unchanged)")
    print("codec    t  splits x pages  groups wgs thr  smem_B stg regs  kernel_ms  plain_ms  "
          "sdpa_ms  bound_ms(by)  share  max_abs_err  rel  row_rel  long_row_rel  "
          "bf16_row_rel  repeat")
    for codec in codecs:
        q_dt = ATTN_CODECS[codec][1]
        tol = PREFILL_F32_TOL if codec == "f32" else ATTN_TOL
        pk, pv, scales, kv_bytes = _pools(attention, codec, shape, g)
        for t in widths:
            pos_np = np.array([min(p, LLAMA2_7B["seq_len"] - t) for p in PREFILL_POS], np.int32)
            pos = torch.from_numpy(pos_np).to(dev)
            n_valid = torch.from_numpy(np.array([t, max(1, t // 2), t, 1, t, t, t - 1, t],
                                                np.int32)).to(dev)
            q = torch.randn((B, H, t, DH), generator=g, device=dev).to(q_dt)
            err = row_err = long_err = abs_err = q_err = 0.0
            for layer in (0, L - 1):
                kn = torch.randn((B, hkv, t, DH), generator=g, device=dev).to(q_dt)
                vn = torch.randn((B, hkv, t, DH), generator=g, device=dev).to(q_dt)
                pidx, oidx = attention.paged_write_indices(table, pos, n_valid, t, PAGE)
                if scales is None:
                    attention.paged_update_kv_rows(pk, pv, kn, vn, layer, pidx, oidx)
                else:
                    (qk, s_k), (qv, s_v) = attention.quantize_kv(kn), attention.quantize_kv(vn)
                    attention.paged_update_kv_rows(pk, pv, qk, qv, layer, pidx, oidx)
                    attention.paged_update_kv_rows(*scales, s_k, s_v, layer, pidx, oidx)
                e, scale, rel, rel_q = _prefill_rows_agree(
                    attention, (q, pk, pv, layer, table, pos, scales), tol,
                    f"prefill attention {codec} t={t} layer {layer}", pos_np,
                    head_max=DH < PREFILL_NARROW_DH)
                err, abs_err = max(err, e / scale), max(abs_err, e)
                row_err = max(row_err, float(rel.max()))
                q_err = max(q_err, float(rel_q.max()))
                long_err = max(long_err, float(rel[torch.from_numpy(pos_np >= 300).to(dev)].max()))
            layer = L - 1
            k_ms = cold_ms(lambda: attention.prefill_attention(q, pk, pv, layer, table, pos,
                                                               scales), 20, flush)
            p_ms = cold_ms(lambda: attention.paged_rows_attention(q, pk, pv, layer, table, pos,
                                                                  scales), 3, flush)
            ks, vs = scales if scales is not None else (None, None)
            kg = attention.paged_gather_layer(pk, layer, table, ks).to(q_dt)
            vg = attention.paged_gather_layer(pv, layer, table, vs).to(q_dt)
            s_idx = torch.arange(kg.shape[2], device=dev)
            mask = s_idx[None, None, :] <= (pos.long()[:, None, None]
                                            + torch.arange(t, device=dev)[None, :, None])
            mask = mask[:, None]  # (B, 1, T, S)
            l_ms = cold_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask, enable_gqa=H != hkv), 20, flush)
            del kg, vg, mask
            b_ms, by = prefill_bound(pos_np, t, hkv, DH, H, kv_bytes, maxp * PAGE)
            plan = attention.prefill_plan(B, H, hkv, t, PAGE, DH, maxp, kv_bytes, n_sms)
            lay = attention.prefill_layout(pk.dtype, DH, H // hkv * t)
            if lay["group_rows"] != attention.prefill_group_rows(DH):
                raise AssertionError(f"the build's row group {lay} is not the plan's "
                                     f"{attention.prefill_group_rows(DH)} rows at Dh {DH}")
            print(f"{codec:5s} {t:4d} {plan.splits:4d} x {plan.pps:4d} {plan.groups:7d} "
                  f"{lay['warpgroups']:3d} {lay['threads']:3d} {lay['smem']:7d} "
                  f"{lay['stages']:3d} {lay['consumer_regs']:4d} {k_ms:10.4f} "
                  f"{p_ms:9.4f} {l_ms:8.4f} {b_ms:9.4f}({by[0]}) {b_ms / k_ms:6.1%} "
                  f"{abs_err:12.6g} {err:.2e} {row_err:.2e} {long_err:.2e} {q_err:.2e}  True")
            out[(codec, t)] = dict(max_abs_err=abs_err, rel_err=err, row_rel_err=row_err,
                                   long_row_rel_err=long_err, ms=k_ms, plain_ms=p_ms,
                                   bound_ms=b_ms, bound_by=by, library_ms=l_ms)
            del q
        del pk, pv, scales
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return out


def _request(base: str, path: str, body: dict | None = None, headers: dict | None = None):
    """(status, headers, body text) of one request; GET without ``body``."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _post(base: str, path: str, body: dict) -> tuple[int, dict | str]:
    """(status, answer): the JSON of a 200 non-stream answer, else the text."""
    code, _, raw = _request(base, path, body)
    return code, json.loads(raw) if code == 200 and not body.get("stream") else raw


def _answer_text(path: str, body: dict, ans) -> str:
    """The completion text of a JSON or SSE answer."""
    if body.get("stream"):
        text = ""
        for line in ans.splitlines():
            if line.startswith("data: {"):
                ch = json.loads(line[6:])["choices"][0]
                text += ch.get("text") or ch.get("delta", {}).get("content") or ""
        return text
    ch = ans["choices"][0]
    return ch["text"] if path == "/v1/completions" else ch["message"]["content"]


def serving_requests(n: int, seed: int = 7) -> list[tuple[str, dict]]:
    """``n`` greedy requests: prompts of 8 to 512 characters (about a token
    each with this tokenizer), max_tokens 32 to 64, four chats sharing a
    system prompt (the first first, the rest last), two streamed."""
    rng = np.random.RandomState(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz  ")

    def text(k):
        return "".join(rng.choice(letters, k))

    system = "You are a terse assistant. " + text(200)
    lens = np.linspace(8, 512, n - 4).astype(int)
    reqs = [("/v1/completions", {"prompt": text(int(k)),
                                 "max_tokens": int(rng.randint(32, 65)),
                                 "temperature": 0}) for k in lens]
    chats = [("/v1/chat/completions", {
        "messages": [{"role": "system", "content": system},
                     {"role": "user", "content": text(int(rng.randint(8, 64)))}],
        "max_tokens": int(rng.randint(32, 65)), "temperature": 0}) for _ in range(4)]
    reqs[1][1]["stream"] = True
    chats[2][1]["stream"] = True
    return chats[:1] + reqs + chats[1:]


def graph_costs(engine, label: str) -> dict:
    """Phases 3 and 7: each captured key's capture seconds and the bytes
    its private memory pool reserved (``DecodeGraphs.cost``), and their
    sums against the card's memory."""
    cost = engine.graphs.cost
    total_s = sum(c[0] for c in cost.values())
    total_b = sum(c[1] for c in cost.values())
    card = torch.cuda.get_device_properties(engine.device).total_memory
    print(f"graph costs ({label}, seq_len {engine.seq_len}): " + "; ".join(
        f"{k.path}/{k.batch}/{'greedy' if k.greedy else 'sampled'}/{k.walk}: {c[0]:.3f} s "
        f"{c[1] / 2**20:.1f} MiB" for k, c in cost.items()))
    print(f"graph costs ({label}): {len(cost)} keys, {total_s:.3f} s of capture, pools "
          f"{total_b / 2**20:.1f} MiB = {total_b / card:.2%} of the card's "
          f"{card / 2**30:.1f} GiB")
    return dict(keys=len(cost), capture_s=total_s, pool_bytes=total_b)


def profile_slot_step(engine, scheduler, q40, attention, steps: int = 4) -> dict:
    """Where an 8-slot step's time goes: torch.profiler over ``steps``
    single-token decode steps, then over ``steps`` mixed prefill steps (16
    tokens a row), each a replay of its captured graph, on the serving
    engine with the scheduler parked; rows at positions 300..1000 on
    private pages.  The idle share compares device busy time with the
    unprofiled step wall; each step's eager wall (graphs off) is timed too.
    The Q40 matmuls of a step (8 or 128 rows) take the body ``q40.route``
    names: tensor-core launches there, and only there.  A mixed step
    launches the prefill attention kernel once a layer and never its plain
    version (the gather and the f32 einsums): no cuBLAS GEMM runs in a
    dense model's mixed step."""
    b = engine.batch
    L = engine.cfg.n_layers
    per = 64  # pages a row: 1024 positions
    ptab = np.zeros((b, engine.max_pages_per_slot), np.int32)
    for r in range(b):
        ptab[r, :per] = 1 + r * per + np.arange(per, dtype=np.int32)
    pos = np.linspace(300, 1000, b).astype(np.int32)
    zeros = np.zeros(b, np.float32)

    def step(t):
        return engine.slot_step(np.full((b, t), 5, np.int32), pos, np.full(b, t, np.int32),
                                temps_np=zeros, topps_np=zeros + 0.9, page_tables_np=ptab)

    out = {}
    with scheduler.exclusive():
        saved = engine.graphs
        for t in (1, 16):
            engine.graphs = None  # the step's eager wall, for the record
            step(t)
            t0 = time.perf_counter()
            for _ in range(steps):
                step(t)
            out[f"ms_off_{t}"] = (time.perf_counter() - t0) * 1e3 / steps
            engine.graphs = saved
            step(t)  # the key's warm-up and capture
            q40.reset_counters()
            attention.reset_counters()
            t0 = time.perf_counter()
            for _ in range(steps):
                step(t)
            wall = (time.perf_counter() - t0) * 1e3 / steps
            c, ac = q40.counters(), attention.counters()
            mm = c["kernel_launches"] + c["blocked_launches"]
            want = q40.route(b * t)
            if not mm or bool(c["mma_launches"]) != (want == "mma"):
                raise AssertionError(f"8-slot step of {t} token(s) a row: Q40 {c}, want "
                                     f"the {want} body at {b * t} rows")
            k_attn, p_attn = (("kernel_launches", "plain_calls") if t == 1 else
                              ("prefill_launches", "prefill_plain_calls"))
            if ac[k_attn] != L * steps or ac[p_attn]:
                raise AssertionError(f"8-slot step of {t} token(s) a row: attention {ac}, "
                                     f"want {L} {k_attn} a step and no plain call")
            rows = device_rows(lambda: [step(t) for _ in range(steps)], steps)
            how = "graph replays"
            if not rows:
                engine.graphs = None
                rows = device_rows(lambda: [step(t) for _ in range(steps)], steps)
                engine.graphs = saved
                how = "eager (the profiler saw no kernel inside the graph)"
            if not rows:
                print(f"8-slot {t}-token step profile: the profiler recorded no device "
                      "time (not measured)")
                continue
            busy = sum(r[0] for r in rows)
            attn = sum(r[0] for r in rows if "paged_attention" in r[2] or "prefill_" in r[2])
            k8 = sum(r[0] for r in rows if "prefill_" in r[2])  # kernel 8's passes
            q40k = sum(r[0] for r in rows if matmul_kernel(r[2], "q40"))
            gemm = [r for r in rows if "gemm" in r[2].lower() and not matmul_kernel(r[2], "q40")]
            if t > 1 and not engine.cfg.is_moe and gemm:
                raise AssertionError(f"the mixed step ran cuBLAS GEMMs (the plain attention's "
                                     f"f32 einsums?): {gemm}")
            what = "decode step" if t == 1 else f"mixed step ({t} tokens a row)"
            key = "step" if t == 1 else "mixed"
            out.update({f"{key}_ms": wall, f"{key}_busy_ms": busy,
                        f"{key}_idle": 1 - busy / wall, f"{key}_ms_off": out[f"ms_off_{t}"]})
            if t > 1:
                out["mixed_k8_ms"] = k8
            print(f"8-slot {what}: wall {wall:.3f} ms replaying its graph, "
                  f"{out[f'ms_off_{t}']:.3f} ms eager")
            print(f"8-slot {what}, {steps} profiled ({how}): device busy {busy:.3f} ms -> "
                  f"idle share {1 - busy / wall:.3f}; attention kernel {attn:.3f} ms "
                  f"({ac[k_attn] // steps} {k_attn} a step, {ac[p_attn]} plain), q40 "
                  f"{q40k:.3f} ms, other {busy - attn - q40k:.3f} ms; "
                  f"{sum(r[1] for r in rows)} kernel launches a step, Q40 {mm // steps} "
                  f"({c['mma_launches'] // steps} on the tensor-core body)"
                  + (f"; kernel 8 (the prefill attention kernel) {k8:.4f} ms a step"
                     if t > 1 else ""))
            for ms_, k, name in sorted(rows, reverse=True)[:8]:
                print(f"  {ms_:8.4f} ms/step {k:5d}x  {name[:90]}")
    return out


def controlled_burst(sched, state, base: str, reqs: list, overlap: bool) -> dict:
    """``reqs`` (at most the slot count) queued one by one, in order, while
    the scheduler is parked, then released at once with its overlapped
    pipeline ``overlap``: every request is admitted in the same round and
    finds the same prefix-cache pages (the burst before cached them), so
    the dispatch sequence, and with it each row's kernel bodies, is the
    same with overlap on and off, and greedy answers must be equal.
    Returns the answers, tok/s and the dispatch counts that moved."""
    answers: list = [None] * len(reqs)
    st0 = dict(sched.stats)
    sched.overlap = overlap
    threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
        i, _post(base, *reqs[i]))) for i in range(len(reqs))]
    with sched.exclusive():
        for i, th in enumerate(threads):
            th.start()
            while sched.occupancy()["queued"] < i + 1:
                time.sleep(0.002)
        t0 = time.perf_counter()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    sched.overlap = True
    if any(code != 200 for code, _ in answers):
        raise AssertionError(f"a released request failed: {str(answers)[:800]}")
    n_tok = sum(r["completion_tokens"] for r in list(state.finished)[-len(reqs):])
    st1 = sched.stats
    return dict(texts=[_answer_text(p, b, ans) for (p, b), (_, ans) in zip(reqs, answers)],
                tok_s=n_tok / wall,
                moved={k: st1[k] - st0[k] for k in ("dispatches", "overlapped", "discarded")})


def serve_path(api, attention, q40, m: str, t: str, n_requests: int,
               extra: list[str], profile: bool, blocked: bool = False,
               tp: int = 1, repeat: bool = False, stack=None) -> dict:
    """Phase 7, one pass; returns its numbers.  ``blocked``: the weights are
    in the blocked layout, so every Q40 launch must be kernel 3's.  ``tp``
    > 1 (phase 18, ``--workers`` in ``extra``): kernel 7 runs on every
    rank's pool and kernel 4 sums the partials.  With ``repeat`` (phases 7,
    11b, 18) the first slot-count requests run again twice through
    :func:`controlled_burst`, overlap on then off: every answer byte for
    byte, both passes' dispatch counts and tok/s printed.  (The staggered
    burst's co-scheduling depends on timing, and a decode row that rides
    a mixed prefill step takes the tensor-core body, whose sums differ in
    the last bits from the decode body's: a burst repeated with other
    timing may pick another greedy token at a near tie.)  ``stack``, an
    ``(engine, tokenizer)`` of ``m`` loaded before, gives the server its
    weights (``api.start``) instead of a read of its own."""
    # a previous pass's server can linger in reference cycles: free it
    # before the peak-memory reading starts
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_load = time.perf_counter()
    server = api.start(["--model", m, "--tokenizer", t, *SERVE_ARGS, *extra], stack=stack)
    print(f"server up in {time.perf_counter() - t_load:.1f} s")
    try:
        state = server.state
        eng, sched = state.batch_engine, state.scheduler
        if eng.tp != tp or (eng.params is not state.engine.params if tp > 1 else
                            eng.params["wqkv"].qpacked.data_ptr()
                            != state.engine.params["wqkv"].qpacked.data_ptr()):
            raise AssertionError("the slot engine holds its own copy of the weights")
        base = f"http://127.0.0.1:{server.server_address[1]}"
        reqs = serving_requests(n_requests)
        attention.reset_counters()
        q40.reset_counters()
        f0, fwd0 = eng.slot_decode_forwards, eng.forwards
        st0 = dict(sched.stats)
        if not sched.overlap:
            raise AssertionError("the server's scheduler runs without its overlapped pipeline")
        results: list = [None] * len(reqs)

        def run(i):
            results[i] = _post(base, *reqs[i])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
        # the first chat goes ahead until its prompt pages are in the prefix
        # cache: the other chats can share only a finished prefill (on the
        # card, handler threads contend for the GIL with the dispatch loop,
        # so arrival order alone does not guarantee it)
        threads[0].start()
        while sched.occupancy()["prefix_nodes"] == 0 and threads[0].is_alive():
            time.sleep(0.01)
        for th in threads[1:]:
            th.start()
            time.sleep(0.01)
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        ac, qc = attention.counters(), q40.counters()
        n_dec = eng.slot_decode_forwards - f0
        n_mix = eng.forwards - fwd0 - n_dec
        bad = [(reqs[i][0], code, ans) for i, (code, ans) in enumerate(results) if code != 200]
        if bad:
            raise AssertionError(f"{len(bad)} requests failed: {str(bad)[:800]}")
        if not torch.isfinite(eng.last_logits).all():
            raise AssertionError("the slot engine ended on non-finite logits")
        L = eng.cfg.n_layers
        if n_dec == 0 or ac["kernel_launches"] != tp * L * n_dec or ac["plain_calls"]:
            raise AssertionError(f"paged attention counters {ac} over {n_dec} "
                                 f"single-token slot forwards (want {tp * L} launches each)")
        if (n_mix == 0 or ac["prefill_launches"] != tp * L * n_mix
                or ac["prefill_plain_calls"]):
            raise AssertionError(f"prefill attention counters {ac} over {n_mix} mixed "
                                 f"slot forwards (want {tp * L} launches each)")
        if qc["plain_calls"] or qc["allreduce_plain_calls"]:
            raise AssertionError(f"a Q40 matmul or all-reduce left its kernel: {qc}")
        if bool(qc["allreduce_launches"]) != (tp > 1):
            raise AssertionError(f"kernel 4 launches {qc['allreduce_launches']} at tp={tp}")
        mine, other = (("blocked_launches", "kernel_launches") if blocked
                       else ("kernel_launches", "blocked_launches"))
        if not qc[mine] or qc[other]:
            raise AssertionError(f"Q40 launches {qc}: want only {mine}")
        occ = sched.occupancy()
        if not occ["prefix_hits"]:
            raise AssertionError(f"the chats sharing a system prompt never hit the prefix "
                                 f"cache: {occ}")
        recs = list(state.finished)[-len(reqs):]
        n_tok = sum(r["completion_tokens"] for r in recs)
        if any(r["completion_tokens"] == 0 for r in recs):
            raise AssertionError("a request produced no tokens")
        ttft = [r["ttft_s"] * 1e3 for r in recs if r["ttft_s"] is not None]
        lat = [r["latency_s"] * 1e3 for r in recs]
        peak = torch.cuda.max_memory_allocated()
        print(f"{len(reqs)} requests in {wall:.2f} s: {n_tok} completion tokens, "
              f"{n_tok / wall:.2f} tok/s aggregate; TTFT p50 {_percentile(ttft, 50):.1f} "
              f"p99 {_percentile(ttft, 99):.1f} ms; latency p50 {_percentile(lat, 50):.1f} "
              f"p99 {_percentile(lat, 99):.1f} max {max(lat):.1f} ms; peak device memory "
              f"{peak / 2**30:.2f} GiB")
        print(f"prompt tokens {sum(r['prompt_tokens'] for r in recs)}; scheduler {occ}; "
              f"{n_dec} single-token slot forwards, attention kernel launches "
              f"{ac['kernel_launches']} ({tp * L} each), plain {ac['plain_calls']}; "
              f"{n_mix} mixed slot forwards, prefill attention kernel launches "
              f"{ac['prefill_launches']} ({tp * L} each), plain {ac['prefill_plain_calls']}; "
              f"q40 kernels 1-2 {qc['kernel_launches']}, kernel 3 "
              f"{qc['blocked_launches']}, plain {qc['plain_calls']}")
        print("latency ms by request: " + " ".join(f"{x:.0f}" for x in lat))
        if tp > 1:
            print(f"tp={tp}: kernel 4 launches {qc['allreduce_launches']}, kernel 7 on "
                  f"{tp} pools of {eng.cache.k.shape[2]} kv heads")
        out = dict(tok_s=n_tok / wall)
        if repeat:
            on, off = (controlled_burst(sched, state, base, reqs[:eng.batch], overlap)
                       for overlap in (True, False))
            if on["texts"] != off["texts"]:
                raise AssertionError("a greedy request answered differently with the "
                                     "overlapped pipeline off")
            if not on["moved"]["overlapped"] or off["moved"]["overlapped"]:
                raise AssertionError(f"overlapped dispatches: {on['moved']} with overlap "
                                     f"on, {off['moved']} off")
            out.update(tok_s_on=on["tok_s"], tok_s_off=off["tok_s"], on=on["moved"],
                       off=off["moved"])
            print(f"the first {len(on['texts'])} requests released at once, overlap on "
                  f"then off: every answer byte for byte; on {on['tok_s']:.2f} tok/s, "
                  f"dispatches {on['moved']}; off {off['tok_s']:.2f} tok/s, dispatches "
                  f"{off['moved']}")
            if eng.graphs is not None:
                # the same burst with every slot step eager: mixed and decode
                # steps replay graphs above, so the answers must not move
                with sched.exclusive():
                    saved, eng.graphs = eng.graphs, None
                try:
                    eager = controlled_burst(sched, state, base, reqs[:eng.batch], True)
                finally:
                    with sched.exclusive():
                        eng.graphs = saved
                if eager["texts"] != on["texts"]:
                    raise AssertionError("a greedy request answered differently with the "
                                         "slot graphs off")
                out.update(tok_s_eager=eager["tok_s"])
                print(f"the same burst with graphs off (every mixed and decode step eager): "
                      f"every answer byte for byte; {eager['tok_s']:.2f} tok/s")
        # one request alone, twice: byte for byte (the second run finds its
        # prompt's pages in the prefix cache)
        path, body = reqs[5]
        texts = [_answer_text(path, body, _post(base, path, body)[1]) for _ in range(2)]
        if texts[0] != texts[1] or not texts[0]:
            raise AssertionError(f"a request alone twice differs: {texts!r}")
        hits = sched.occupancy()["prefix_hits"]
        print(f"one request alone twice: {len(texts[0])} chars, byte for byte; "
              f"prefix cache hits {occ['prefix_hits']} in the burst, {hits} in all")
        if profile:
            out.update(profile_slot_step(eng, sched, q40, attention))
        if eng.graphs is not None:
            out.update(graph_costs(eng, "slot engine"))
        return dict(out, attn_launches=ac["kernel_launches"],
                    prefill_launches=ac["prefill_launches"],
                    ttft_p50=_percentile(ttft, 50), ttft_p99=_percentile(ttft, 99),
                    peak_bytes=peak, allreduce_launches=qc["allreduce_launches"])
    finally:
        api.stop(server)
        del server
        torch.cuda.empty_cache()


# phase 6s: serving on the pools and at the widths the prefill kernel took
# no body for before (an f32 pool; steps past 128 query rows a kv head)
WIDE_PROMPTS = (600, 300, 90, 20)  # characters, about a token each
WIDE_NEW = 16
# single-token greedy steps each engine of 6s decodes after its mixed steps
WIDE_GREEDY = 8


def wide_serving(api, engine_mod, attention, m: str, t: str, extra: list[str], width: int,
                 label: str, stack=None) -> dict:
    """Phase 6s, one configuration: the API server on ``m`` with phase 7's
    arguments and ``extra`` answers four greedy requests released together
    (prompts of WIDE_PROMPTS characters): every answer 200, every mixed
    slot forward launches the prefill kernel once a layer and no forward
    its plain version, and a mixed step of ``width`` tokens a row ran.
    Then, on the server's weights and pool type, a fresh paged engine with
    its graphs on runs three mixed steps of ``width`` tokens a row (4 rows
    at n_valid width, 3/4, 1/2 and 1/4 of it, positions 0, width, 2·width:
    the first warms the key, the second captures its graph, the third
    replays it) beside an ``attn_impl="plain"`` engine on the same inputs:
    each step's logits within E2E_TOL of max|plain|, the kernel engine
    ``n_layers`` prefill launches a step and 0 plain calls, the plain one
    none.  Then each engine decodes WIDE_GREEDY single-token greedy steps
    from its own tokens (the kernel engine's kernel 7, ``n_layers`` launches
    a step): its greedy tokens equal the plain engine's, or first differ
    where the plain run's top-2 margin is a near tie (< NEAR_TIE of max)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    server = api.start(["--model", m, "--tokenizer", t, *SERVE_ARGS, *extra], stack=stack)
    out = {}
    try:
        state = server.state
        eng, sched = state.batch_engine, state.scheduler
        L = eng.cfg.n_layers
        pool = "int8" if eng.cache.quantized else str(eng.cache.k.dtype).split(".")[-1]
        print(f"{label}: server up in {time.perf_counter() - t0:.1f} s, a {pool} pool of "
              f"{eng.kv_pages} pages, prefill chunk {sched.prefill_chunk}")
        widths = []
        real = eng.slot_step_async

        def spy(*a, **kw):
            toks = a[0] if a else kw.get("tokens_np")
            if toks is not None:
                widths.append(np.asarray(toks).shape[1])
            return real(*a, **kw)

        eng.slot_step_async = spy
        base = f"http://127.0.0.1:{server.server_address[1]}"
        rng = np.random.RandomState(24)
        reqs = [("/v1/completions", {"prompt": "".join(rng.choice(list("abcdefgh  "), k)),
                                     "max_tokens": WIDE_NEW, "temperature": 0})
                for k in WIDE_PROMPTS]
        attention.reset_counters()
        f0, fwd0 = eng.slot_decode_forwards, eng.forwards
        results: list = [None] * len(reqs)
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _post(base, *reqs[i]))) for i in range(len(reqs))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        eng.slot_step_async = real
        ac = attention.counters()
        n_dec = eng.slot_decode_forwards - f0
        n_mix = eng.forwards - fwd0 - n_dec
        if any(code != 200 for code, _ in results):
            raise AssertionError(f"{label}: a request failed: {str(results)[:600]}")
        if (not n_mix or ac["prefill_launches"] != L * n_mix or ac["prefill_plain_calls"]
                or ac["kernel_launches"] != L * n_dec or ac["plain_calls"]):
            raise AssertionError(f"{label}: attention counters {ac} over {n_mix} mixed and "
                                 f"{n_dec} single-token forwards (want {L} launches each)")
        if max(widths) != width:
            raise AssertionError(f"{label}: the widest mixed step was {max(widths)} tokens a "
                                 f"row, not {width}")
        print(f"{label}: {len(reqs)} requests in {wall:.2f} s, every answer 200; {n_mix} mixed "
              f"forwards ({ac['prefill_launches']} prefill launches, {L} each, plain "
              f"{ac['prefill_plain_calls']}), widths {sorted(set(widths))}; {n_dec} "
              f"single-token forwards ({ac['kernel_launches']} kernel-7 launches)")
        out["prefill_launches"] = ac["prefill_launches"]
        out["attn_launches"] = ac["kernel_launches"]
        # the first mixed forwards against the plain read, on a fresh pair
        b = 4
        kv = "q8" if eng.cache.quantized else eng.cache.k.dtype
        pages = 3 * width // PAGE + 1  # a row's pages: the three steps, the greedy ones
        n_valid = np.array([width, 3 * width // 4, width // 2, width // 4], np.int32)
        toks = np.random.RandomState(25).randint(3, eng.cfg.vocab_size, (3, b, width))
        zeros = np.zeros(b, np.float32)
        logits, greedy = {}, {}
        with sched.exclusive():
            for impl in ("auto", "plain"):
                e2 = engine_mod.Engine(eng.cfg.with_(attn_impl=impl), eng.params,
                                       device=eng.device, batch=b, kv_dtype=kv,
                                       kv_pages=1 + b * pages, kv_page_size=PAGE,
                                       graphs=impl == "auto")
                ptab = np.zeros((b, e2.max_pages_per_slot), np.int32)
                ptab[:, :pages] = 1 + np.arange(b * pages, dtype=np.int32).reshape(b, pages)
                steps = []
                for i in range(3):
                    attention.reset_counters()
                    e2.slot_step(toks[i].astype(np.int32), np.full(b, i * width, np.int32),
                                 n_valid, temps_np=zeros, topps_np=zeros + 0.9,
                                 page_tables_np=ptab)
                    steps.append(e2.last_logits.float())
                    ac = attention.counters()
                    want = (L, 0) if impl == "auto" else (0, L)
                    if (ac["prefill_launches"], ac["prefill_plain_calls"]) != want:
                        raise AssertionError(f"{label}: {impl} mixed step {i}: {ac}")
                logits[impl] = torch.stack(steps)
                tok, run = steps[-1].argmax(-1), [steps[-1]]
                for j in range(WIDE_GREEDY):
                    attention.reset_counters()
                    e2.slot_step(tok.cpu().numpy().astype(np.int32)[:, None],
                                 2 * width + n_valid + j, np.ones(b, np.int32),
                                 temps_np=zeros, topps_np=zeros + 0.9, page_tables_np=ptab)
                    ac = attention.counters()
                    want = (L, 0) if impl == "auto" else (0, L)
                    if (ac["kernel_launches"], ac["plain_calls"]) != want:
                        raise AssertionError(f"{label}: {impl} greedy step {j}: {ac}")
                    run.append(e2.last_logits.float())
                    tok = run[-1].argmax(-1)
                greedy[impl] = torch.stack(run, 1)  # (B, steps, V)
                if impl == "auto":
                    mixed = [k for k in e2.graphs.cost if k.path == "mixed" and k.walk == width]
                    if not mixed:
                        raise AssertionError(f"{label}: no mixed graph captured at width "
                                             f"{width}: {list(e2.graphs.cost)}")
                del e2
                torch.cuda.empty_cache()
        k, p = logits["auto"], logits["plain"]
        err, scale = float((k - p).abs().max()), float(p.abs().max())
        if not (torch.isfinite(k).all() and err <= E2E_TOL * scale):
            raise AssertionError(f"{label}: mixed-step logits kernel vs plain {err} > "
                                 f"{E2E_TOL} * {scale}")
        print(f"{label}: three mixed steps of {width} tokens a row (warm-up, capture, replay) "
              f"against attn_impl='plain': max|kernel-plain| {err:.4g} of max|plain| "
              f"{scale:.4g} ({err / scale:.2e}, limit {E2E_TOL:g}); {L} prefill launches a "
              f"step, 0 plain")
        out["logit_rel_err"] = err / scale
        kt, pt = greedy["auto"].argmax(-1), greedy["plain"].argmax(-1)
        ties = []
        for r in range(b):
            diff = (kt[r] != pt[r]).nonzero()
            if len(diff):
                j = int(diff[0])
                top2 = greedy["plain"][r, j].topk(2).values
                margin = float(top2[0] - top2[1])
                big = float(greedy["plain"][r, j].abs().max())
                if margin >= NEAR_TIE * big:
                    raise AssertionError(f"{label}: greedy row {r} differs from the plain "
                                         f"engine's at step {j}, top-2 margin {margin:.4g} of "
                                         f"{big:.4g}: not a near tie")
                ties.append((r, j, margin / big))
        print(f"{label}: {WIDE_GREEDY + 1} greedy tokens a row, kernels against plain: "
              + ("equal" if not ties else f"first differ at near ties {ties}") + "; kernel "
              f"7 {L} launches a single-token step, 0 plain")
        out["greedy_near_ties"] = len(ties)
        return out
    finally:
        api.stop(server)
        del server
        gc.collect()
        torch.cuda.empty_cache()


# phase 20: the OpenAI surface on contiguous slot rows (the lockstep engine)
SURFACE_ARGS = ["--batch-slots", "8", "--kv-pages", "0", "--temperature", "0",
                "--max-pending", "64", "--host", "127.0.0.1", "--port", "0"]
# Prometheus text 0.0.4: a sample line
PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_]+="[^"]*",?)*\})? '
                         r'(-?[0-9.]+(e[-+]?[0-9]+)?|\+Inf)$')


def _sse_texts(raw: str) -> dict[int, str]:
    """An SSE completions body's text joined per choice index."""
    if not raw.rstrip().endswith("data: [DONE]"):
        raise AssertionError(f"a stream did not end with [DONE]: {raw[-300:]!r}")
    out: dict[int, str] = {}
    for line in raw.splitlines():
        if line.startswith("data: {"):
            ch = json.loads(line[6:])["choices"][0]
            out[ch["index"]] = out.get(ch["index"], "") + (ch.get("text") or "")
    return out


def scoring_forward(eng, q40, seed: int = 20) -> dict:
    """Phase 20: ``Engine.score_batch`` at 8 x 512 (B x bucket) on the
    server's slot engine, the scheduler parked: wall (host clock to a
    synchronize), device busy time (torch.profiler), peak memory above the
    engine's resident bytes, and the Q40 counters of one forward: 4 L + 1
    launches, every one on the tensor-core body (t = 4096 rows), wcls
    among them, no plain call."""
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(3, eng.cfg.vocab_size, SCORE_T).tolist() for _ in range(SCORE_B)]
    eng.score_batch(seqs, top_k=5)  # first call: any lazy setup
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    q40.reset_counters()
    t0 = time.perf_counter()
    tok_lp, _, top_lp = eng.score_batch(seqs, top_k=5)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    c = q40.counters()
    per = 4 * eng.cfg.n_layers + 1
    n, d = eng.cfg.dim, eng.cfg.vocab_size
    if (c["kernel_launches"], c["mma_launches"], c["plain_calls"]) != (per, per, 0) \
            or c["launches_by_shape"].get(("mma", n, d)) != 1:
        raise AssertionError(f"scoring forward counters {c}: want {per} launches on the "
                             f"tensor-core body, wcls among them, no plain call")
    real = np.concatenate([tok_lp[r, -SCORE_T:-1] for r in range(SCORE_B)])
    if not (np.isfinite(real).all() and (real <= 0).all() and np.isfinite(top_lp).all()):
        raise AssertionError("scoring forward: non-finite or positive log-probs")
    rows = device_rows(lambda: eng.score_batch(seqs, top_k=5), 1)
    busy = sum(r[0] for r in rows)
    q40_ms = sum(r[0] for r in rows if matmul_kernel(r[2], "q40"))
    top = sorted(rows, reverse=True)[:6]
    n_sms = torch.cuda.get_device_properties(eng.device).multi_processor_count
    print(f"scoring forward {SCORE_B} x {SCORE_T} (t = {SCORE_B * SCORE_T} rows): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms (Q40 bodies {q40_ms:.3f} ms), peak "
          f"{peak / 2**30:.2f} GiB ({(peak - resident) / 2**30:.2f} GiB above the "
          f"{resident / 2**30:.2f} GiB resident); Q40 launches {c['kernel_launches']} "
          f"({per} a forward), tensor-core {c['mma_launches']}, plain {c['plain_calls']}; "
          f"wcls plan (bm, splits, steps) {q40.mma_plan(SCORE_B * SCORE_T, n, d, n_sms)}")
    print("scoring forward, top kernels (ms, launches, name): "
          + "; ".join(f"{ms:.3f} {k} {name[:60]}" for ms, k, name in top))
    return dict(score_wall_ms=wall, score_busy_ms=busy, score_q40_ms=q40_ms,
                score_peak_bytes=peak, score_extra_bytes=peak - resident)


def openai_surface(api, q40, m: str, t: str, stack=None) -> dict:
    """Phase 20: the API server at Llama-2-7B width on contiguous
    slot rows (``--batch-slots 8 --kv-pages 0``): list prompts, chat
    ``n = 4``, ``logprobs`` with ``echo``, a streamed list prompt,
    ``/metrics`` in both formats and the ``/debug`` routes, with the Q40
    counters set to 0 before the requests and read after them; then the
    scoring forward alone (:func:`scoring_forward`).  ``stack`` as
    :func:`serve_path`'s."""
    from dllama_tpu_torch.tokenizer.chat import ChatItem
    gc.collect()
    torch.cuda.empty_cache()
    t_load = time.perf_counter()
    server = api.start(["--model", m, "--tokenizer", t, *SURFACE_ARGS], stack=stack)
    print(f"server up in {time.perf_counter() - t_load:.1f} s")
    try:
        state = server.state
        eng = state.batch_engine
        if state.scheduler is None or eng.paged or eng.batch != 8:
            raise AssertionError("the surface server runs no contiguous 8-slot scheduler")
        base = f"http://127.0.0.1:{server.server_address[1]}"
        rng = np.random.RandomState(20)
        letters = list("abcdefghijklmnopqrstuvwxyz  ")

        def text(k):
            return "".join(rng.choice(letters, int(k))).strip() or "a"

        ttft0 = json.loads(_request(base, "/metrics")[2])["ttft_seconds"]["count"]
        served0 = state.metrics.requests_served
        q40.reset_counters()
        sent = 0
        t0 = time.perf_counter()
        # 1. a list of 8 greedy prompts, twice: the same bytes
        batch = {"prompt": [text(k) for k in np.linspace(16, 200, 8)], "max_tokens": 32,
                 "temperature": 0}
        answers = [_request(base, "/v1/completions", batch) for _ in range(2)]
        sent += 2
        if any(a[0] != 200 for a in answers) or \
                json.loads(answers[0][2])["choices"] != json.loads(answers[1][2])["choices"]:
            raise AssertionError(f"list prompt: {[a[0] for a in answers]} or the two "
                                 f"answers differ")
        first = json.loads(answers[0][2])
        texts = {c["index"]: c["text"] for c in first["choices"]}
        if len(texts) != 8 or first["usage"]["completion_tokens"] < 8:
            raise AssertionError(f"list prompt: {first['usage']}, {len(texts)} choices")
        # 2. chat n = 4 sampled, seeded: four choices, usage, and the same
        # bytes when repeated with the seed
        chat = {"messages": [{"role": "system", "content": "You are terse. " + text(60)},
                             {"role": "user", "content": text(40)}],
                "n": 4, "temperature": 0.8, "seed": 1, "max_tokens": 24}
        chats = [_request(base, "/v1/chat/completions", chat) for _ in range(2)]
        sent += 2
        bodies = [json.loads(c[2]) for c in chats]
        if any(c[0] != 200 for c in chats) or bodies[0]["choices"] != bodies[1]["choices"]:
            raise AssertionError(f"chat n=4: {[c[0] for c in chats]}, or the seeded "
                                 f"repeat differs")
        u = bodies[0]["usage"]
        n_words = len(state.tokenizer.encode(state.template.generate(
            [ChatItem(x["role"], x["content"]) for x in chat["messages"]], True),
            add_bos=True))
        if (len(bodies[0]["choices"]) != 4 or u["prompt_tokens"] != n_words
                or not 0 < u["completion_tokens"] <= 4 * 24
                or u["total_tokens"] != u["prompt_tokens"] + u["completion_tokens"]):
            raise AssertionError(f"chat n=4 usage {u} ({n_words} prompt tokens)")
        distinct = len({c["message"]["content"] for c in bodies[0]["choices"]})
        # 3. logprobs = 5 with echo on a ~500-token prompt, greedy, 16
        # tokens: prompt and completion fill one SCORE_T bucket, so its
        # scoring forward runs wcls at SCORE_B x SCORE_T rows (8 engine rows)
        lp_text = text(500)
        while len(state.tokenizer.encode(lp_text, add_bos=True)) + 16 > SCORE_T:
            lp_text = lp_text[:-4]
        lp_body = {"prompt": lp_text, "max_tokens": 16, "logprobs": 5, "echo": True,
                   "temperature": 0}
        code, hdr, raw = _request(base, "/v1/completions", lp_body,
                                  headers={"X-Request-Id": "surface-3"})
        sent += 1
        if code != 200 or hdr.get("X-Request-Id") != "surface-3":
            raise AssertionError(f"logprobs request: {code} {raw[:300]}")
        ch = json.loads(raw)["choices"][0]
        lp = ch["logprobs"]
        n_prompt = len(state.tokenizer.encode(lp_body["prompt"], add_bos=True))
        if not SCORE_T // 2 < n_prompt <= SCORE_T - 16:
            raise AssertionError(f"logprobs: {n_prompt} prompt tokens fill no {SCORE_T} bucket")
        if "".join(lp["tokens"]) != ch["text"]:
            raise AssertionError("logprobs: the tokens do not join to the text")
        # a leading BOS is skipped, so the first shown token has a real
        # conditional (on BOS); only a prompt without BOS starts with null
        bos = state.tokenizer.encode(lp_body["prompt"], add_bos=True)[0] == \
            state.tokenizer.bos_id
        vals = lp["token_logprobs"]
        if (vals[0] is None) == bos or len(vals) != len(lp["tokens"]):
            raise AssertionError(f"logprobs: first {vals[0]!r} with BOS {bos}")
        rest = [v for v in vals if v is not None]
        if not all(np.isfinite(v) and v <= 0 for v in rest):
            raise AssertionError("logprobs: a log-prob is non-finite or positive")
        tops = [x for x in lp["top_logprobs"] if x is not None]
        if len(tops) != len(rest) or any(len(x) != 5 for x in tops):
            raise AssertionError(f"logprobs: {sum(len(x) != 5 for x in tops)} of {len(tops)} "
                                 f"positions lack 5 top_logprobs entries")
        # the completion's tokens (greedy) are the top-1 where the top-2
        # margin exceeds 0.05 nats, and within 0.05 nats of it where it
        # does not (the synthesized wcls rows repeat every 2048 rows: many
        # top-2 are exact ties); the echoed prompt's tokens are the
        # prompt's, not the model's choice
        shown = n_prompt - (1 if bos else 0)
        checked, decisive, flips = 0, 0, []
        for tok, top in zip(lp["tokens"][shown:], lp["top_logprobs"][shown:]):
            ranked = sorted(top.items(), key=lambda kv: -kv[1])
            checked += 1
            if ranked[0][1] - ranked[1][1] > 0.05:
                decisive += 1
                if tok != ranked[0][0]:
                    flips.append((tok, ranked[:2], top.get(tok)))
            elif top.get(tok, -np.inf) < ranked[0][1] - 0.05:
                flips.append((tok, ranked[:2], top.get(tok)))
        # 4. the list prompt streamed: chunks joined per index = the texts
        code, _, raw = _request(base, "/v1/completions", dict(batch, stream=True))
        sent += 1
        if code != 200 or _sse_texts(raw) != texts:
            raise AssertionError("the streamed list prompt differs from the non-stream one")
        wall = time.perf_counter() - t0
        qc = q40.counters()
        # 5. /metrics in both formats
        code, hdr, raw = _request(base, "/metrics")
        mj = json.loads(raw)
        alloc = torch.cuda.memory_allocated(0)
        hbm = mj["hbm_bytes_in_use"].get("0", 0.0)
        ttft_n = mj["ttft_seconds"]["count"] - ttft0
        recs = list(state.finished)[-sent:]
        want_ttft = sum(r["ttft_s"] is not None for r in recs)
        if (mj["requests_served"] - served0 != sent or ttft_n != want_ttft
                or abs(hbm - alloc) > 0.01 * alloc):
            raise AssertionError(f"/metrics: served {mj['requests_served']} (want {sent}), "
                                 f"TTFT count {ttft_n} (want {want_ttft}), HBM {hbm} against "
                                 f"memory_allocated {alloc}")
        code, hdr, prom = _request(base, "/metrics?format=prometheus")
        bad = [ln for ln in prom.splitlines()
               if not (ln.startswith(("# HELP ", "# TYPE ")) or PROM_SAMPLE.match(ln))]
        if code != 200 or bad or "dllama_ttft_seconds_count" not in prom:
            raise AssertionError(f"Prometheus text: {code}, unparsed lines {bad[:5]}")
        mm = [ln for ln in prom.splitlines() if ln.startswith("dllama_matmul_dispatch_total{")]
        # 6. the debug routes
        rec = json.loads(_request(base, "/debug/requests/surface-3")[2])
        tl = json.loads(_request(base, "/debug/timeline")[2])
        tr = json.loads(_request(base, "/debug/trace?last=50")[2])["traceEvents"]
        if (rec.get("finish") != "served" or rec.get("path") != "/v1/completions"
                or tl["slots"] != 8 or "components_ms" not in tl
                or not any(e["name"] == "request" and
                           e.get("args", {}).get("request_id") == "surface-3" for e in tr)):
            raise AssertionError(f"/debug: record {rec}, timeline keys {list(tl)}")
        wcls_mma = ("mma", eng.cfg.dim, eng.cfg.vocab_size)
        if qc["plain_calls"] or qc["launches_by_shape"].get(wcls_mma) != 1:
            raise AssertionError(f"the surface requests' Q40 counters {qc}: want wcls once on "
                                 f"the tensor-core body (the logprobs request's scoring "
                                 f"forward) and no plain call")
        print(f"surface: {sent} requests in {wall:.2f} s, all 200; list prompt of 8 twice "
              f"byte for byte ({first['usage']['completion_tokens']} tokens); chat n=4 "
              f"sampled seed 1: {distinct} distinct choices, repeat byte for byte, usage "
              f"{u}; logprobs=5 echo: {len(lp['tokens'])} tokens ({n_prompt} prompt), first "
              f"log-prob {vals[0]!r}, {checked} completion tokens the top-1 or within 0.05 "
              f"nats of it ({decisive} at a decisive top-2 margin); streamed list = "
              f"non-stream; /metrics served {sent}, TTFT count +{ttft_n}, HBM {hbm:.0f} vs "
              f"allocated {alloc} ({abs(hbm - alloc) / alloc:.2e}); {len(prom.splitlines())} "
              f"Prometheus lines parse; {mm}; /debug/requests/surface-3 {rec['finish']}, "
              f"timeline {len(tl['steps'])} steps, trace {len(tr)} events")
        print(f"surface Q40 counters: {qc['kernel_launches']} launches, tensor-core "
              f"{qc['mma_launches']}, plain {qc['plain_calls']}; wcls tensor-core "
              f"{qc['launches_by_shape'].get(wcls_mma)} (at {SCORE_B} x {SCORE_T} rows)")
        if flips:
            raise AssertionError(f"logprobs: {len(flips)} of {checked} completion tokens are "
                                 f"not the scoring forward's top-1: {flips}")
        with state.exclusive():
            out = scoring_forward(eng, q40)
        return dict(out, counts=qc)
    finally:
        api.stop(server)
        del server
        torch.cuda.empty_cache()


def score_layers(transformer, q40, cfg, params, dev, b: int = SCORE_B,
                 t: int = SCORE_T) -> str:
    """Phase 20b: both layers of a scoring forward at B x T rows, kernels
    against ``quant_impl="plain"``, every sub-block fed the plain run's
    own input: layer 0's attention (the embedding) and FFN, layer 1's
    attention (plain layer 0's output) and FFN; each output within E2E_TOL
    of the plain output's max at every position.  Then layer 1's four Q40
    products and wcls (on the final hidden state), each on the plain run's
    own activations at B x T rows and stacked plane 1, kernel against
    ``matmul_plain`` within KERNEL_TOL.  The witness: layer 1's attention,
    plain against plain with its input moved by one bf16 ulp everywhere
    (the last mantissa bit flipped), shows how far a last-bit change of
    the input moves it on these weights (printed)."""
    rng = np.random.RandomState(22)
    toks = torch.from_numpy(rng.randint(3, cfg.vocab_size, (b, t))).to(dev)
    act = transformer.ACTIVATIONS[cfg.hidden_act]
    rms = transformer.rmsnorm

    def sub_blocks(c):
        """The four sub-blocks' outputs under ``c``, each on its plain
        input: ``x0`` and ``ins`` (x0 + att0, x1, x1 + att1, x2)."""
        cache = transformer.init_kv_cache(c, b, t, device=dev)
        outs = []
        for layer, (xa, xf) in enumerate(((x0, ins[0]), (ins[1], ins[2]))):
            outs.append(transformer._attention_block(xa, params, layer, c, cache, cos, sin, 0))
            outs.append(transformer._dense_ffn(rms(xf, params["rms_ffn"][layer]), params,
                                               layer, c))
        return outs

    plain = cfg.with_(quant_impl="plain")
    x0, cos, sin = transformer._embed(params, plain, toks, 0)
    # the plain run, keeping each sub-block's input
    cache = transformer.init_kv_cache(plain, b, t, device=dev)
    ins, x = [], x0
    for layer in (0, 1):
        att = transformer._attention_block(x, params, layer, plain, cache, cos, sin, 0)
        ins.append(x + att)
        ffn = transformer._dense_ffn(rms(x + att, params["rms_ffn"][layer]), params, layer,
                                     plain)
        x = x + att + ffn
        ins.append(x)
    x1 = ins[1]
    # layer 1's products on the plain activations (they are the plain
    # run's, recomputed here up to each product's input)
    xb = rms(x1, params["rms_att"][1])
    att_in = transformer._attend(x1, params, 1, plain, cache, cos, sin, 0)
    h1, h3 = torch.chunk(transformer._mm(rms(ins[2], params["rms_ffn"][1]), params["w13"],
                                         plain, 1), 2, dim=-1)
    final = rms(x, params["rms_final"])
    products = [("wqkv", xb, 1), ("wo", att_in, 1),
                ("w13", rms(ins[2], params["rms_ffn"][1]), 1), ("w2", act(h1) * h3, 1),
                ("wcls", final, None)]
    notes = []
    for name, xin, layer in products:
        qt = params[name]
        n = qt.logical_nd[0]
        x2 = xin.reshape(-1, n)
        p = q40.matmul_plain(x2, qt, layer)
        k = q40.q40_matmul(x2, qt.qpacked, qt.scales, n, layer)
        torch.cuda.synchronize()
        err, scale = float((k - p).abs().max()), float(p.abs().max())
        if not (torch.isfinite(k).all() and err <= KERNEL_TOL * scale):
            raise AssertionError(f"scoring width, {name} at {x2.shape[0]} rows, plane {layer}: "
                                 f"{err} > {KERNEL_TOL} * {scale}")
        notes.append(f"{name} {err / scale:.2e}")
    del p, k
    # each sub-block, kernels against plain, on the plain inputs
    got = {impl: sub_blocks(cfg.with_(quant_impl=impl)) for impl in ("auto", "plain")}
    held = []
    for name, k, p in zip(("layer 0 attention", "layer 0 FFN", "layer 1 attention",
                           "layer 1 FFN"), got["auto"], got["plain"]):
        k, p = k.float(), p.float()
        err, scale = float((k - p).abs().max()), float(p.abs().max())
        if not (torch.isfinite(k).all() and err <= E2E_TOL * scale):
            raise AssertionError(f"scoring width, {name}: {err} > {E2E_TOL} * {scale}")
        held.append(f"{name} {err:.4g} of {scale:.4g} ({err / scale:.2e})")
    # the witness: plain against plain, layer 1's input one ulp away
    moved = (x1.view(torch.int16) ^ 1).view(x1.dtype)
    w_cache = transformer.init_kv_cache(plain, b, t, device=dev)
    w = transformer._attention_block(moved, params, 1, plain, w_cache, cos, sin, 0).float()
    p = got["plain"][2].float()
    w_err, scale = float((w - p).abs().max()), float(p.abs().max())
    return (f"{b} x {t} rows, kernels vs plain on the plain inputs (limit {E2E_TOL:g}): "
            + ", ".join(held) + f"; the products at stacked plane 1 and wcls, kernel vs "
            f"plain (limit {KERNEL_TOL:g}): " + ", ".join(notes) + f"; witness, layer 1 "
            f"attention, plain vs plain with its input one ulp away: {w_err:.4g} of "
            f"{scale:.4g} ({w_err / scale:.2e})")


def score_end_to_end(transformer, engine_mod, q40, cfg, params, dev) -> None:
    """Phase 20b on the phase-5 model (7B width, 2 layers): both layers of
    the 8 x 512 scoring forward (:func:`score_layers`), then ``score_batch`` of
    8 ragged sequences in a 64 bucket (t = 512 rows, the same tensor-core
    plan: 128-row tiles, one split) with the kernels against
    ``quant_impl="plain"``: logits by the phase-5 rule, ``token_lp``
    within twice the largest logit difference (a log-prob is a logit less
    a logsumexp, which moves by at most that much), the top-5 ids equal
    at every rank whose plain margin exceeds twice it.  Then the
    contiguous int8 cache: prefill + 8 teacher-forced decode steps kernel
    against plain, and greedy bytes with the engine's graphs on and off."""
    print(score_layers(transformer, q40, cfg, params, dev))
    rng = np.random.RandomState(21)
    seqs = [rng.randint(3, cfg.vocab_size, int(k)).tolist()
            for k in (64, 50, 37, 5, 60, 28, 64, 33)]
    bucket = 64
    toks = torch.zeros((len(seqs), bucket), dtype=torch.long, device=dev)
    offs = torch.tensor([bucket - len(s) for s in seqs], device=dev)
    for r, s in enumerate(seqs):
        toks[r, bucket - len(s):] = torch.tensor(s, device=dev)
    logits, scores = {}, {}
    for impl in ("auto", "plain"):
        c = cfg.with_(quant_impl=impl)
        eng = engine_mod.Engine(c, params, device=dev, batch=len(seqs), graphs=False,
                                seq_len=bucket)
        scores[impl] = eng.score_batch(seqs, top_k=5)
        cache = transformer.init_kv_cache(c, len(seqs), bucket, device=dev)
        lg = transformer.forward(params, c, toks, cache, 0, offsets=offs)[0]
        logits[impl] = torch.cat([lg[r, bucket - len(s):] for r, s in enumerate(seqs)])
        del eng, cache, lg
    note = margin_check(logits["auto"], logits["plain"], "scoring logits")
    err = float((logits["auto"] - logits["plain"]).abs().max())
    (k_lp, k_ti, k_tl), (p_lp, p_ti, p_tl) = scores["auto"], scores["plain"]
    lp_err = top_err = 0.0
    decided = agree = 0
    for r, s in enumerate(seqs):
        cols = slice(bucket - len(s), bucket - 1)
        lp_err = max(lp_err, float(np.abs(k_lp[r, cols] - p_lp[r, cols]).max()))
        top_err = max(top_err, float(np.abs(k_tl[r, cols] - p_tl[r, cols]).max()))
        for c in range(bucket - len(s), bucket - 1):
            v = p_tl[r, c]
            # the last rank's margin to the sixth is unknown: never decided
            for i in range(4):
                if (i == 0 or v[i - 1] - v[i] > 2 * err) and v[i] - v[i + 1] > 2 * err:
                    decided += 1
                    agree += int(k_ti[r, c, i] == p_ti[r, c, i])
    if lp_err > 2 * err or top_err > 2 * err or agree != decided:
        raise AssertionError(f"score_batch kernel vs plain: token_lp {lp_err}, top_lp "
                             f"{top_err} (limit {2 * err}), top ids {agree}/{decided}")
    print(f"score_batch, 8 ragged sequences (5-64 tokens) in a 64 bucket, kernels vs "
          f"plain: logits {note}; token_lp max diff {lp_err:.4g}, top-5 log-probs "
          f"{top_err:.4g} (limit 2 x {err:.4g}); top-5 ids equal at {decided} decisive ranks")
    end_to_end(transformer, cfg, params, dev, "int8 contiguous cache, 2 layers, bf16",
               quant=True)
    streams = []
    for graphs in (True, False):
        eng = engine_mod.Engine(cfg, params, device=dev, kv_dtype="q8", graphs=graphs)
        streams.append([tok for tok, _ in eng.generate_stream(seqs[2], 37 + 48,
                                                               temperature=0.0)])
        if graphs and not (eng.cache.quantized and eng.graphs.replays):
            raise AssertionError("the int8 engine replayed no graph")
        del eng
    if streams[0] != streams[1]:
        raise AssertionError("int8 cache: greedy tokens differ with graphs on and off")
    print(f"int8 contiguous cache: greedy {len(streams[0]) - 37} tokens, graphs on = off "
          f"token for token")


def slot_end_to_end(engine_mod, transformer, attention, cfg, params, dev,
                    pools=(None, "q8"), label: str = "2 layers", mesh=None) -> None:
    """Phases 8, 12 and 19: the slot path over a paged pool (bf16, or int8
    for ``"q8"``; one a rank over ``mesh``), kernels against plain
    versions: a mixed step (16 tokens a row, n_valid 16, 9, 12, 5; the
    prefill attention kernel, ``n_layers`` launches a rank, against its
    plain version) and 8 teacher-forced decode steps.  At tp = 1 the
    kernels' steps replay graphs; the same steps with the engine's graphs
    off give the same logits bit for bit."""
    rng = np.random.RandomState(8)
    b, t = 4, 16
    prompt = rng.randint(3, cfg.vocab_size, (b, t)).astype(np.int32)
    n_valid = np.array([16, 9, 12, 5], np.int32)
    forced = rng.randint(3, cfg.vocab_size, (8, b)).astype(np.int32)
    pages = cfg.seq_len // PAGE
    ptab = (1 + np.arange(b * pages, dtype=np.int32)).reshape(b, pages)
    zeros = np.zeros(b, np.float32)
    tp = 1 if mesh is None else mesh.tp
    # (name, impl, graphs): the plain versions run eagerly (the plain page
    # walk reads the rows' furthest position on the host)
    runs = [("auto", "auto", None), ("plain", "plain", False)]
    if mesh is None:
        runs.append(("eager", "auto", False))
    for kv in pools:
        logits, routes = {}, {name: [] for name, _, _ in runs}
        for name, impl, graphs in runs:
            c = cfg.with_(quant_impl=impl, attn_impl=impl)
            eng = engine_mod.Engine(c, params, device=dev, batch=b, kv_dtype=kv,
                                    kv_pages=1 + b * pages, kv_page_size=PAGE, mesh=mesh,
                                    graphs=graphs)
            pos = np.zeros(b, np.int32)
            attention.reset_counters()
            with routing_log(transformer, cfg, routes[name]):
                eng.slot_step(prompt, pos, n_valid, temps_np=zeros, topps_np=zeros + 0.9,
                              page_tables_np=ptab)
                ac = attention.counters()
                steps = [eng.last_logits.float()]
                pos = pos + n_valid
                for i in range(len(forced)):
                    eng.slot_step(forced[i][:, None], pos, np.ones(b, np.int32),
                                  temps_np=zeros, topps_np=zeros + 0.9, page_tables_np=ptab)
                    steps.append(eng.last_logits.float())
                    pos = pos + 1
            key = "prefill_plain_calls" if impl == "plain" else "prefill_launches"
            if ac[key] != tp * cfg.n_layers:
                raise AssertionError(f"{name} mixed step: attention counters {ac}, want "
                                     f"{tp * cfg.n_layers} {key}")
            logits[name] = torch.stack(steps)
            del eng
        k, p = logits["auto"], logits["plain"]
        err, scale = float((k - p).abs().max()), float(p.abs().max())
        if not (torch.isfinite(k).all() and err <= E2E_TOL * scale):
            raise AssertionError(f"slot path kernel vs plain logits ({kv or 'bf16'} pool): "
                                 f"{err} > {E2E_TOL} * {scale}")
        top2 = p.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > 2 * err
        agree = k.argmax(-1) == p.argmax(-1)
        if not bool(agree[decided].all()):
            raise AssertionError("slot path greedy tokens differ where the margin is decisive")
        # a replayed graph calls no Python: the kernels' expert choices are
        # read from the run with the graphs off
        routes["auto"] = routes.get("eager", routes["auto"])
        if "eager" in logits and not torch.equal(logits["eager"], k):
            raise AssertionError(f"slot path ({kv or 'bf16'} pool): logits differ with the "
                                 f"graphs on and off")
        print(f"slot path ({kv or 'bf16'} pool, {label}): max|kernel-plain| {err:.4g} of "
              f"max|plain| {scale:.4g} ({err / scale:.2e}, limit {E2E_TOL:g}); greedy agrees "
              f"at {int(decided.sum())}/{decided.numel()} row-steps whose margin exceeds 2x "
              f"that ({int(agree.sum())}/{agree.numel()} overall){routing_note(routes)}; the "
              f"mixed step {tp * cfg.n_layers} prefill-kernel launches"
              + ("; graphs on = off bit for bit" if "eager" in logits else ""))


def contiguous_slot_graphs(engine_mod, cfg, params, dev) -> None:
    """Phase 8: contiguous slot rows (no page pool; the read stays the
    plain per-row-ceiling op): a mixed step of 16 tokens a row and 8
    decode steps with the engine's graphs on (the mixed step replays its
    ``mixed`` key's graph) and off, the same logits bit for bit."""
    rng = np.random.RandomState(9)
    b, t = 4, 16
    prompt = rng.randint(3, cfg.vocab_size, (b, t)).astype(np.int32)
    n_valid = np.array([16, 3, 11, 7], np.int32)
    forced = rng.randint(3, cfg.vocab_size, (8, b)).astype(np.int32)
    zeros = np.zeros(b, np.float32)
    logits = {}
    for graphs in (None, False):
        eng = engine_mod.Engine(cfg, params, device=dev, batch=b, graphs=graphs)
        pos = np.zeros(b, np.int32)
        for i in range(2):  # the second pass replays what the first captured
            eng.slot_step(prompt, pos, n_valid, temps_np=zeros, topps_np=zeros + 0.9)
        steps = [eng.last_logits.float()]
        pos = pos + n_valid
        for i in range(len(forced)):
            eng.slot_step(forced[i][:, None], pos, np.ones(b, np.int32), temps_np=zeros,
                          topps_np=zeros + 0.9)
            steps.append(eng.last_logits.float())
            pos = pos + 1
        logits[graphs] = torch.stack(steps)
        if graphs is None:
            keys = sorted({k.path for k in eng.graphs.graphs})
            if eng.graphs.capture and (keys != ["mixed", "slot"] or not eng.graphs.replays):
                raise AssertionError(f"contiguous slot engine: graphs {keys}, "
                                     f"{eng.graphs.replays} replays")
        del eng
    if not torch.equal(logits[None], logits[False]):
        raise AssertionError("contiguous slot rows: logits differ with the graphs on and off")
    print(f"contiguous slot rows: a mixed step (16 tokens a row) and 8 decode steps replay "
          f"their graphs (mixed, slot); the logits equal the eager steps' bit for bit")


@contextlib.contextmanager
def blocked_layout():
    """``DLLAMA_Q40_LAYOUT=blocked`` for the block: engines made inside it
    load their Q40 weights in the tile-contiguous layout (kernel 3)."""
    old = os.environ.get("DLLAMA_Q40_LAYOUT")
    os.environ["DLLAMA_Q40_LAYOUT"] = "blocked"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DLLAMA_Q40_LAYOUT"]
        else:
            os.environ["DLLAMA_Q40_LAYOUT"] = old


def blocked_bound(t: int, n: int, d: int, dp: int) -> tuple[float, str]:
    """Kernel 3's least time: as :func:`bound`, with the weight planes'
    stored width ``dp`` (d padded to a td multiple) in place of d."""
    nbytes = t * n * 2 + n * dp * 0.5 + (n // 32) * dp * 2 + t * d * 4
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, 2.0 * t * n * d / BF16_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def check_blocked(q40, dev, seed: int = 13) -> dict:
    """Phase 13: kernel 3 against its plain version at every site and row
    count, both bodies, and against kernels 1-2 on the same weights
    row-major under the same body (bit for bit); returns {(site, t):
    numbers of the routed body} for the 7B sites at JSON_ROWS."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    out, k12_diff = {}, 0.0
    warm_clocks(dev)
    print("site           t  tiles       route    k3_ms  k12_ms  plain_ms  library_ms  "
          "bound_ms(by)  max_abs_err  rel       |k3-k12|  k3_gemv  k3_mma")
    for site, n, d, lead, tiles, rows in BLOCKED_SITES:
        qt = random_planes(q40, lead, n, d, g, dev)
        bqt = q40.to_blocked(qt, *(tiles or (None, None)))
        dp = bqt.qpacked.shape[2] * bqt.qpacked.shape[4]
        if lead:
            layers = (torch.tensor([0], dtype=torch.int32, device=dev),
                      torch.tensor([lead[0] - 1], dtype=torch.int32, device=dev))
        else:
            layers = (None,)
        w_lib = q40.dequantize(qt, torch.bfloat16, layer=(lead[0] - 1) if lead else None)
        for t in rows:
            x = torch.randn((t, n), generator=g, device=dev).to(torch.bfloat16)
            err = 0.0
            for layer in layers:
                p = q40.matmul_plain(x, bqt, layer)
                scale = float(p.abs().max())
                for body in ("gemv", "mma"):
                    k = q40.q40_blocked_matmul(x, bqt.qpacked, bqt.scales, (n, d), layer,
                                               body=body)
                    k2 = q40.q40_blocked_matmul(x, bqt.qpacked, bqt.scales, (n, d), layer,
                                                body=body)
                    k12 = q40.q40_matmul(x, qt.qpacked, qt.scales, n, layer, body=body)
                    torch.cuda.synchronize()
                    if not torch.equal(k, k2):
                        raise AssertionError(f"kernel 3 {site} t={t} plane={layer} "
                                             f"body={body}: two launches differ")
                    e = float((k - p).abs().max())
                    if not (k.shape == (t, d) and torch.isfinite(k).all()
                            and e <= KERNEL_TOL * scale):
                        raise AssertionError(f"kernel 3 {site} t={t} plane={layer} "
                                             f"body={body}: max|kernel-plain| {e} > "
                                             f"{KERNEL_TOL} * {scale}")
                    if body == q40.route(t):
                        err = max(err, e)
                    k12_diff = max(k12_diff, float((k - k12).abs().max()))
            layer = layers[-1]
            body = q40.route(t)
            times = {b: cold_ms(lambda: q40.q40_blocked_matmul(x, bqt.qpacked, bqt.scales,
                                                               (n, d), layer, body=b),
                                20, flush)
                     for b in ("gemv", "mma")}
            k_ms = times[body]
            r_ms = cold_ms(lambda: q40.q40_matmul(x, qt.qpacked, qt.scales, n, layer),
                           20, flush)
            p_ms = cold_ms(lambda: q40.matmul_plain(x, bqt, layer), 5, flush)
            l_ms = cold_ms(lambda: torch.matmul(x, w_lib), 20, flush)
            b_ms, by = blocked_bound(t, n, d, dp)
            print(f"{site:12s} {t:4d} {str(bqt.tiles):11s} {body:5s} {k_ms:8.4f} {r_ms:7.4f} "
                  f"{p_ms:9.4f} {l_ms:11.4f} {b_ms:9.4f}({by[0]}) {err:12.6g} "
                  f"{err / scale:.2e} {k12_diff:g} {times['gemv']:8.4f} {times['mma']:8.4f}")
            if t in JSON_ROWS and site in {s_ for s_, *_ in LLAMA_SITES} and (
                    t == 1 or site != "wcls"):
                out[(site, t)] = dict(replaces=BLOCKED_REPLACES, max_abs_err=err, ms=k_ms,
                                      plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                                      library_ms=l_ms, n=n, d=d, rowmajor_ms=r_ms,
                                      key=("blocked-mma" if body == "mma" else "blocked",
                                           n, d))
        del qt, bqt, w_lib
    print(f"max|kernel 3 - kernels 1-2| over every site, row count, plane and body: "
          f"{k12_diff:g} ({'bit for bit' if k12_diff == 0 else 'NOT bit for bit'})")
    if k12_diff != 0:
        raise AssertionError(f"kernel 3 differs from kernels 1-2 by {k12_diff}")
    del flush
    torch.cuda.empty_cache()
    return out


def batch_prompts(n: int = 8, seed: int = 14) -> list[str]:
    """``n`` prompts of 8 to 200 characters (about a token each)."""
    rng = np.random.RandomState(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz  ")
    return ["".join(rng.choice(letters, int(k))).strip() or "a"
            for k in np.linspace(8, 200, n)]


def batch_path(cli, q40, m: str, t: str, tfile, steps: int = 48) -> dict:
    """Phase 14's lockstep batch: ``batch`` of 8 ragged prompts through the
    CLI, greedy, run twice.  The one prefill (8 x 256 rows) runs kernel 3's
    tensor-core body for the 4 L layer matmuls at 2048 rows and for wcls
    at its 8 last rows; every decode forward launches kernel 3 4 L + 1
    times (129 at 32 layers) at t = 8.  Then the profile
    of 8 lockstep decode steps of the batch."""
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer
    prompts = batch_prompts()
    pf = os.path.join(WORK, "prompts.txt")
    with open(pf, "w", encoding="utf-8") as f:
        f.write("\n".join(prompts) + "\n")
    tok = Tokenizer(tfile.read_tfile(t))
    want_tokens = sum(max(0, steps - len(tok.encode(p, add_bos=True))) for p in prompts)
    outs, run = [], None
    for _ in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        q40.reset_counters()
        t0 = time.perf_counter()
        engine, out = run_cli(cli, ["batch", "--model", m, "--tokenizer", t,
                                    "--prompts-file", pf, "--steps", str(steps),
                                    "--temperature", "0"])
        wall = time.perf_counter() - t0
        c = q40.counters()
        decode = engine.forwards - 1
        per = 4 * engine.cfg.n_layers
        if not torch.isfinite(engine.last_logits).all():
            raise AssertionError("batch ended on non-finite logits")
        if (c["kernel_launches"] or c["plain_calls"] or decode < 1
                or c["blocked_launches"] != (per + 1) * engine.forwards):
            raise AssertionError(f"batch counters {c} over {engine.forwards} forwards: "
                                 f"want {per + 1} kernel-3 launches a forward")
        got = int(re.search(r"Generated tokens: +(\d+) over 8 streams", out).group(1))
        if got != want_tokens:
            raise AssertionError(f"batch generated {got} tokens, every row finishing "
                                 f"at {steps} needs {want_tokens}")
        tps = float(re.search(r"Batched throughput: +([\d.]+) tok/s", out).group(1))
        outs.append([ln for ln in out.splitlines()
                     if not ln.startswith(("Batched throughput", "💡"))])
        run = dict(counts=c, tok_s=tps, wall_s=wall, decode_forwards=decode,
                   tokens=got)
        if len(outs) == 2:  # a lockstep step at t = 8 on the second run's engine
            ids = [tok.encode(p, add_bos=True) for p in prompts]
            run.update(profile_decode(engine, None, q40, prompts=ids))
            run.update(batch_graphs_ab(engine, q40, ids, steps))
        del engine
    if outs[0] != outs[1]:
        raise AssertionError("the greedy batch differs between two runs")
    print(f"batch: 8 prompts of {min(map(len, prompts))}-{max(map(len, prompts))} chars, "
          f"{run['tokens']} tokens over {run['decode_forwards']} lockstep decode "
          f"forwards, every row finished; {run['tok_s']} tok/s batched "
          f"({run['wall_s']:.1f} s with the load); kernel-3 launches "
          f"{run['counts']['blocked_launches']}; repeats byte for byte")
    torch.cuda.empty_cache()
    return run


def batch_graphs_ab(engine, q40, ids: list[list[int]], steps: int) -> dict:
    """Phase 14b: the greedy lockstep batch on the CLI's engine with its
    graphs on, then off: the same rows byte for byte and the same launch
    counters over the same forwards; prints each pass's wall a step."""
    saved, runs = engine.graphs, {}
    for name, graphs in (("on", saved), ("off", None)):
        engine.graphs = graphs
        engine.reset()
        q40.reset_counters()
        f0 = engine.forwards
        t0 = time.perf_counter()
        rows = engine.generate_batch(ids, steps, temperature=0.0)
        torch.cuda.synchronize()
        n = engine.forwards - f0
        runs[name] = (rows, q40.counters(), n, (time.perf_counter() - t0) * 1e3 / n)
    engine.graphs = saved
    (r_on, c_on, n_on, ms_on), (r_off, c_off, n_off, ms_off) = runs["on"], runs["off"]
    if r_on != r_off or c_on != c_off or n_on != n_off:
        raise AssertionError(f"the lockstep batch differs with graphs on and off: "
                             f"{c_on} / {c_off} over {n_on}/{n_off} forwards")
    print(f"batch graphs on/off: the same 8 rows byte for byte and the same launches "
          f"({c_on['blocked_launches']} kernel 3 over {n_on} forwards); wall "
          f"{ms_on:.3f} ms a forward with graphs, {ms_off:.3f} without (the prefill "
          f"included)")
    return dict(ms_on=ms_on, ms_off=ms_off)


def teacher_forced(transformer, decode_chunk, engine_mod, cfg, params, dev, prompts,
                   forced) -> torch.Tensor:
    """Logits (B, 1 + steps, V) of a lockstep ragged batch (a single-stream
    run for one prompt): the prefill, then ``forced`` (steps, B) fed one
    step at a time (decode_chunk with one step per call teacher-forces its
    input)."""
    eng = engine_mod.Engine(cfg, params, device=dev, batch=len(prompts))
    if len(prompts) > 1:
        eng.prefill_ragged(prompts)
    else:  # the single-stream run
        eng.prefill(prompts[0])
    steps = [eng.last_logits.float()]
    gen = torch.Generator(device=dev)
    for row in forced:
        tok = torch.tensor(row, device=dev)
        _, eng.cache, _, _, logits = decode_chunk(
            params, cfg, eng.cache, tok, eng.pos, gen, steps=1, temperature=0.0,
            topp=0.9, offsets=eng.offsets)
        eng.pos += 1
        steps.append(logits.float())
    return torch.stack(steps, 1)


def margin_check(k: torch.Tensor, p: torch.Tensor, what: str) -> str:
    """The phase-5 rule: logits within E2E_TOL of max|p|, greedy agreement
    where p's top-2 margin exceeds twice the largest difference."""
    err, scale = float((k - p).abs().max()), float(p.abs().max())
    if not (torch.isfinite(k).all() and err <= E2E_TOL * scale):
        raise AssertionError(f"{what}: logits {err} > {E2E_TOL} * {scale}")
    top2 = p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = k.argmax(-1) == p.argmax(-1)
    if not bool(agree[decided].all()):
        raise AssertionError(f"{what}: greedy tokens differ where the margin is decisive")
    return (f"max diff {err:.4g} of max {scale:.4g} ({err / scale:.2e}, limit "
            f"{E2E_TOL:g}); greedy agrees at {int(decided.sum())}/{decided.numel()} "
            f"decisive steps ({int(agree.sum())}/{agree.numel()} overall)")


def blocked_and_batch_end_to_end(q40, transformer, engine_mod, cfg, params, dev) -> None:
    """Phase 15, first two checks, on the phase-5 model: the blocked kernel
    path against the plain path (and against kernels 1-2), then the
    lockstep ragged batch against single-stream runs."""
    from dllama_tpu_torch.runtime.decode_loop import decode_chunk
    bparams = q40.blocked_params(params)
    end_to_end(transformer, cfg, bparams, dev, "kernel 3, 2 layers, bf16")
    rng = np.random.RandomState(15)
    prompt = torch.from_numpy(rng.randint(3, cfg.vocab_size, (1, 12))).to(dev)
    rows = []
    for p in (params, bparams):
        cache = transformer.init_kv_cache(cfg, 1, device=dev)
        rows.append(transformer.forward_last(p, cfg, prompt, cache, 0, 11)[0])
    diff = float((rows[0] - rows[1]).abs().max())
    print(f"prefill logits, kernel 3 against kernels 1-2: max diff {diff:g} "
          f"({'bit for bit' if diff == 0 else 'NOT bit for bit'})")
    prompts = [rng.randint(3, cfg.vocab_size, n).tolist() for n in (12, 3, 7, 1)]
    forced = rng.randint(3, cfg.vocab_size, (8, len(prompts))).tolist()
    q40.reset_counters()
    batched = teacher_forced(transformer, decode_chunk, engine_mod, cfg, bparams, dev,
                             prompts, forced)
    c = q40.counters()
    if c["kernel_launches"] or c["plain_calls"] or not c["blocked_launches"]:
        raise AssertionError(f"lockstep batch counters {c}: want kernel 3 only")
    single = torch.cat([teacher_forced(transformer, decode_chunk, engine_mod, cfg,
                                       bparams, dev, [p], [[f[r]] for f in forced])
                        for r, p in enumerate(prompts)])
    print("lockstep batch of 4 ragged prompts (12, 3, 7, 1 tokens) against single "
          "streams, prefill + 8 forced steps: " + margin_check(batched, single, "batch"))


def chat_path(cli, engine_mod, q40, m: str, t: str) -> None:
    """Phase 15's chat: two user turns on stdin through the CLI under the
    blocked layout; both turns answer, the second starts at the position
    where the first ended, and only kernel 3 ran the matmuls."""
    starts, ends = [], []
    real_stream, real_drain = engine_mod.Engine.generate_stream, cli.drain_generation

    def stream(self, prompt_tokens, *a, **kw):
        starts.append(self.pos)
        return real_stream(self, prompt_tokens, *a, **kw)

    def drain(engine, *a, **kw):
        res = real_drain(engine, *a, **kw)
        ends.append(engine.pos)
        return res

    stdin = sys.stdin
    engine_mod.Engine.generate_stream, cli.drain_generation = stream, drain
    sys.stdin = io.StringIO("You are terse.\nOnce upon a time\nthe capital of France\n")
    try:
        q40.reset_counters()
        _, out = run_cli(cli, ["chat", "--model", m, "--tokenizer", t, "--temperature",
                               "0", "--max-seq-len", "512"])
    finally:
        engine_mod.Engine.generate_stream, cli.drain_generation = real_stream, real_drain
        sys.stdin = stdin
    c = q40.counters()
    turns = out.count("🤖 Assistant")
    if turns != 2 or "context window is full" in out or len(ends) != 2:
        raise AssertionError(f"chat: {turns} assistant turns, want 2:\n{out[-1500:]}")
    if starts[0] != 0 or starts[1] != ends[0]:
        raise AssertionError(f"chat turn 2 starts at {starts[1]}, turn 1 ended at {ends[0]}")
    if c["kernel_launches"] or c["plain_calls"] or not c["blocked_launches"]:
        raise AssertionError(f"chat counters {c}: want kernel 3 only")
    print(f"chat: 2 turns; turn 1 at positions 0-{ends[0]}, turn 2 from {starts[1]} to "
          f"{ends[1]}; kernel-3 launches {c['blocked_launches']}")


def allreduce_bound(tp: int, t: int, d: int) -> tuple[float, str]:
    """Kernel 4's least time: the tp partials read once and the tp sums
    written once (t * d f32 each) against the HBM rate; the tp * (tp - 1)
    * t * d f32 adds against the card's f32 rate."""
    b_ms = 2 * tp * t * d * 4 / HBM_BYTES_S * 1e3
    o_ms = tp * (tp - 1) * t * d / F32_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def check_allreduce(q40, dev, seed: int = 16) -> dict:
    """Phase 16: kernel 4 against its plain version, every rank on ``dev``
    (and, with enough cards, rank r on card r); returns {(tp, d, t):
    numbers} of the one-card runs.  Two more shapes check the ring order
    at tp = 3 (the ranks' sums differ in the last bits, as on the TPU) and
    the scalar path (a half row not a multiple of 4 columns)."""
    g = torch.Generator()
    g.manual_seed(seed)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    n_cards = torch.cuda.device_count()
    out = {}
    print("tp    t     d   kernel_ms  plain_ms  stack_sum_ms  bound_ms(by)  max_abs_err")
    for tp, t, d in TP_SHAPES + [(3, 8, 4096), (2, 3, 4102)]:
        # partials of mixed magnitudes, so the order of the adds shows
        host = [torch.randn((t, d), generator=g)
                * 10 ** (torch.rand((t, d), generator=g) * 4 - 2) for _ in range(tp)]
        places = [("cuda:0", [dev] * tp)]
        if n_cards >= tp:
            places.append((f"cards 0..{tp - 1}", [torch.device("cuda", r) for r in range(tp)]))
        for where, devs in places:
            parts = [h.to(x) for h, x in zip(host, devs)]
            k = q40.tp_allreduce_kernel(parts)
            p = q40.tp_allreduce_plain(parts)
            for x in set(devs):
                torch.cuda.synchronize(x)
            err = max(float((a - b).abs().max()) for a, b in zip(k, p))
            if err != 0 or not all(torch.isfinite(a).all() for a in k):
                raise AssertionError(f"kernel 4 tp={tp} t={t} d={d} on {where}: "
                                     f"max|kernel-plain| {err}, want 0")
            if tp == 2 and not torch.equal(k[0], k[1].to(k[0].device)):
                raise AssertionError(f"kernel 4 tp=2 t={t} d={d} on {where}: the ranks differ")
            if where != "cuda:0":
                # the launches span cards: a host clock around synchronized runs
                t0 = time.perf_counter()
                for _ in range(50):
                    q40.tp_allreduce_kernel(parts)
                for x in devs:
                    torch.cuda.synchronize(x)
                host_ms = (time.perf_counter() - t0) * 1e3 / 50
                print(f"{tp:2d} {t:4d} {d:5d}  on {where}: kernel = plain bit for bit; "
                      f"{host_ms:.4f} ms a call by the host clock")
                continue
            if (tp, t, d) not in TP_SHAPES:
                spread = max(float((a - k[0]).abs().max()) for a in k)
                print(f"{tp:2d} {t:4d} {d:5d}  kernel = plain bit for bit; the ranks' "
                      f"sums differ by up to {spread:g}")
                continue
            k_ms = cold_ms(lambda: q40.tp_allreduce_kernel(parts), 50, flush)
            p_ms = cold_ms(lambda: q40.tp_allreduce_plain(parts), 20, flush)
            l_ms = cold_ms(lambda: torch.stack(parts).sum(0), 50, flush)
            b_ms, by = allreduce_bound(tp, t, d)
            print(f"{tp:2d} {t:4d} {d:5d} {k_ms:10.4f} {p_ms:9.4f} {l_ms:13.4f} "
                  f"{b_ms:9.5f}({by[0]}) {err:12.6g}")
            out[(tp, d, t)] = dict(replaces=TP_REPLACES, max_abs_err=err, ms=k_ms,
                                   plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                                   library_ms=l_ms)
    if n_cards < 2:
        print(f"ranks on distinct cards: skipped, this machine has {n_cards} card "
              "(peer reads need two or more)")
    del flush
    torch.cuda.empty_cache()
    return out


def first_logits(engine) -> np.ndarray:
    """The logits (1, V) of phase 17's first forward: a fixed 12-token
    prompt from position 0."""
    prompt = np.random.RandomState(17).randint(3, LLAMA2_7B["vocab_size"], 12).tolist()
    engine.reset()
    return engine.prefill(prompt)[0]


def tp_main_path(cli, q40, engine_mod, params_mod, config, mfile, m: str, t: str,
                 dev, ref: np.ndarray | None, L: int = LLAMA2_7B["n_layers"]) -> dict:
    """Phase 17: ``inference --workers tpu:2 --device cuda:0`` on the 7B-width
    file ``m`` of ``L`` layers through :func:`main_path` (2 (7 L + 1) Q40
    launches a forward), kernel 4's 2 L launches a forward, a single-token
    forward's counts, and the first forward's logits against ``ref``, a
    tp = 1 forward of the same file (loaded here when ``ref`` is None)."""
    per_fwd, ar_fwd = 2 * (7 * L + 1), 2 * L
    run, eng = main_path(cli, q40, m, t, lambda e: per_fwd * e.forwards,
                         ("--workers", "tpu:2", "--device", "cuda:0"), keep=True)
    c = run["counts"]  # main_path held kernel_launches to per_fwd a forward
    if eng.tp != 2 or c["allreduce_launches"] * per_fwd != c["kernel_launches"] * ar_fwd \
            or c["allreduce_plain_calls"]:
        raise AssertionError(f"tp=2 main path: {c}, want {ar_fwd} kernel-4 launches a "
                             f"forward")
    q40.reset_counters()
    eng.decode_one(5)
    one = q40.counters()
    if (one["kernel_launches"], one["allreduce_launches"], one["plain_calls"],
            one["allreduce_plain_calls"]) != (per_fwd, ar_fwd, 0, 0):
        raise AssertionError(f"a single-token tp=2 forward: {one}")
    print(f"one single-token forward: {one['kernel_launches']} Q40 launches, "
          f"{one['allreduce_launches']} kernel-4 launches, 0 plain "
          f"({one['launches_by_shape']})")
    l2 = first_logits(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    l1 = ref
    if l1 is None:
        with mfile.MFile(m) as mf:
            cfg, params = params_mod.load_params(
                mf, config.ModelConfig.from_spec(mf.spec, dtype=torch.bfloat16))
        e1 = engine_mod.Engine(cfg, params, device=dev)
        l1 = first_logits(e1)
        del e1, params
        torch.cuda.empty_cache()
    err, scale = float(np.abs(l2 - l1).max()), float(np.abs(l1).max())
    if not (np.isfinite(l2).all() and err <= E2E_TOL * scale):
        raise AssertionError(f"tp=2 vs tp=1 logits: {err} > {E2E_TOL} * {scale}")
    print(f"first forward (12-token prompt), tp=2 against tp=1: max diff {err:.4g} of "
          f"max|logit| {scale:.4g} ({err / scale:.2e}, limit {E2E_TOL:g}); argmax "
          f"{int(l2.argmax())} / {int(l1.argmax())}")
    run["allreduce_launches"] = c["allreduce_launches"]
    return run


def tp_end_to_end(mfile, params_mod, config, transformer, engine_mod, q40, attention,
                  sharding, path: str, mesh, label: str) -> None:
    """Phase 19: one model at tp = 2 over ``mesh``, the kernels (matmuls
    and kernel 4) against the plain path, batch-1 and slot paths."""
    cfg, params = load_bf16(mfile, params_mod, config, path, "cpu", fuse=False)
    dev = mesh.device
    placed = sharding.place_params(params, cfg, mesh)
    del params
    q40.reset_counters()
    end_to_end(transformer, cfg, placed, dev, label, mesh=mesh)
    slot_end_to_end(engine_mod, transformer, attention, cfg, placed, dev, (None,), label,
                    mesh=mesh)
    c = q40.counters()
    if not c["allreduce_launches"] or not c["allreduce_plain_calls"]:
        raise AssertionError(f"{label}: kernel 4 {c['allreduce_launches']} launches, "
                             f"plain {c['allreduce_plain_calls']}: want both runs")
    print(f"{label}: kernel 4 launches {c['allreduce_launches']} (kernel runs), plain "
          f"{c['allreduce_plain_calls']} (plain runs)")
    del placed
    torch.cuda.empty_cache()


# phases 16b and 25: one process a rank group, both processes on cuda:0
GROUP_SHAPES = [(2, t, 4096) for t in (1, 16, 128)] + [(2, 3, 4102)]
GROUP_TIMEOUT = "300"   # DLLAMA_GROUP_TIMEOUT of the children (seconds)
WORKER_STEPS = 32        # phase 25's generated tokens (inference, generate)
WORKER_BATCH_STEPS = 48  # phase 25's batch: tokens a stream, prompt included (14b's)


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def allreduce_group_child(proc: str, port: str, out_path: str) -> int:
    """Phase 16b's child process ``proc`` of two, joined through
    ``127.0.0.1:port``, one rank of tp = 2 on cuda:0: for each of
    GROUP_SHAPES both ranks' partials made from one seed (the same on both
    processes), kernel 4's cross-process body on its rank's, held to
    ``tp_allreduce_plain`` of both bit for bit, then timed (cold L2, the
    median of 30 calls; both processes make the same calls).  Process 0
    also times the plain version, the one-process kernel on both partials
    and ``torch.stack(parts).sum(0)``, and writes the numbers to
    ``out_path``; both time 50 calls back to back by the host clock."""
    sys.path.insert(0, REPO)
    from dllama_tpu_torch.ops import _build, q40
    from dllama_tpu_torch.parallel import distributed
    from dllama_tpu_torch.parallel.mesh import make_mesh
    proc = int(proc)
    dev = torch.device("cuda", 0)
    _build.load()
    distributed.init_distributed(f"127.0.0.1:{port}", 2, proc, max_retries=0)
    group = distributed.current_group()
    group.reserve_rows(max(t for _, t, _ in GROUP_SHAPES))
    mesh = make_mesh(2, "cuda:0", group)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    out = {}
    for tp, t, d in GROUP_SHAPES:
        # process 0 times more than process 1 a shape: meet on the host
        # before the first call of the next, so no rank waits on the card
        group.barrier()
        g = torch.Generator()
        g.manual_seed(160 + t)
        parts = [(torch.randn((t, d), generator=g)
                  * 10 ** (torch.rand((t, d), generator=g) * 4 - 2)).to(dev) for _ in range(tp)]
        mine = [parts[r] for r in mesh.ranks]
        q40.reset_counters()
        got = q40.tp_allreduce(mine, mesh=mesh)[0]
        want = q40.tp_allreduce_plain(parts)[proc]
        torch.cuda.synchronize()
        c = q40.counters()
        err = float((got - want).abs().max())
        if err != 0 or (c["allreduce_ipc_launches"], c["allreduce_plain_calls"]) != (1, 0):
            raise AssertionError(f"process {proc}: kernel 4 across processes at t={t} d={d}: "
                                 f"max|kernel-plain| {err}, counters {c}")
        row = dict(max_abs_err=err,
                   ms=cold_ms(lambda: q40.tp_allreduce(mine, mesh=mesh), 30, flush))
        # back to back, as a forward's calls come: the host clock over 50
        group.barrier()
        t0 = time.perf_counter()
        for _ in range(50):
            q40.tp_allreduce(mine, mesh=mesh)
        torch.cuda.synchronize()
        row["warm_ms"] = (time.perf_counter() - t0) * 1e3 / 50
        if proc == 0:
            row.update(plain_ms=cold_ms(lambda: q40.tp_allreduce_plain(parts), 20, flush),
                       one_ms=cold_ms(lambda: q40.tp_allreduce_kernel(parts), 30, flush),
                       library_ms=cold_ms(lambda: torch.stack(parts).sum(0), 30, flush))
        out[f"{tp},{t},{d}"] = row
    group.agree(sorted(out), "phase 16b's shapes")
    if proc == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return 0


def _children(argvs: list[list[str]], timeout: float, env: dict | None = None) -> list:
    """Start the commands together (process 1 first), wait for all;
    returns their CompletedProcess-like (returncode, stdout, stderr), every
    child killed if the wait runs out."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               DLLAMA_GROUP_TIMEOUT=GROUP_TIMEOUT, **(env or {}))
    procs = [subprocess.Popen(a, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in reversed(argvs)]
    procs.reverse()
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def allreduce_across_processes() -> dict:
    """Phase 16b: kernel 4's cross-process body in two child processes on
    cuda:0 (:func:`allreduce_group_child`); prints and returns {(tp, d, t):
    numbers}.  Its times are of one card that the two processes' CUDA
    contexts share in time slices (no MPS): a rank waiting on its peer's
    flag holds the card until its slice ends."""
    path = os.path.join(WORK, "allreduce16b.json")
    port = str(free_port())
    code = "import sys, chip_smoke; sys.exit(chip_smoke.allreduce_group_child(*sys.argv[1:]))"
    res = _children([[sys.executable, "-c", code, str(k), port, path] for k in (0, 1)], 600)
    for k, (rc, o, e) in enumerate(res):
        if rc != 0:
            print(o[-3000:], e[-6000:], sep="\n", file=sys.stderr)
            raise AssertionError(f"phase 16b: process {k} exited {rc}")
    with open(path) as f:
        rows = json.load(f)
    os.remove(path)
    print("one card, two processes in time slices: kernel 4's cross-process body against "
          "tp_allreduce_plain (bit for bit on both ranks)")
    print("tp    t     d   ipc_ms(1 card, sliced)  back_to_back_ms  one_process_ms  plain_ms  "
          "stack_sum_ms  bound_ms(by)  max_abs_err")
    out = {}
    for tp, t, d in GROUP_SHAPES:
        r = rows[f"{tp},{t},{d}"]
        b_ms, by = allreduce_bound(tp, t, d)
        print(f"{tp:2d} {t:4d} {d:5d} {r['ms']:22.4f} {r['warm_ms']:16.4f} {r['one_ms']:15.4f} "
              f"{r['plain_ms']:9.4f} {r['library_ms']:13.4f} {b_ms:9.5f}({by[0]}) "
              f"{r['max_abs_err']:12.6g}")
        out[(tp, d, t)] = dict(replaces=TP_REPLACES, max_abs_err=r["max_abs_err"],
                               ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b_ms,
                               bound_by=by, library_ms=r["library_ms"],
                               one_process_ms=r["one_ms"])
    return out


def _group_run(mode: str, args: list[str], label: str, per_fwd: int, ar_fwd: int) -> dict:
    """One worker group on cuda:0: process 1 ``worker --program mode``,
    process 0 ``mode``, both with ``args`` and their coordinates.  Both
    must exit 0, process 1 print no stream, and each process's counter line
    (stderr) show ``per_fwd`` Q40 launches and ``ar_fwd`` cross-process
    kernel-4 launches a forward and no plain call.  Returns process 0's
    stdout, both counter lines and the wall seconds."""
    coords = ["--coordinator", f"127.0.0.1:{free_port()}", "--nproc", "2"]
    base = [sys.executable, "-m", "dllama_tpu_torch"]
    t0 = time.perf_counter()
    res = _children([base + [mode, *args, *coords, "--proc-id", "0"],
                     base + ["worker", "--program", mode, *args, *coords, "--proc-id", "1"]],
                    900)
    wall = time.perf_counter() - t0
    lines = []
    for k, (rc, o, e) in enumerate(res):
        if rc != 0:
            print(o[-3000:], e[-6000:], sep="\n", file=sys.stderr)
            raise AssertionError(f"{label}: process {k} exited {rc}")
        got = [json.loads(ln) for ln in e.splitlines() if ln.startswith('{"process"')]
        if len(got) != 1:
            raise AssertionError(f"{label}: process {k} printed {len(got)} counter lines")
        c, n = got[0]["q40"], got[0]["forwards"]
        if (c["kernel_launches"], c["allreduce_ipc_launches"], c["allreduce_launches"],
                c["plain_calls"], c["allreduce_plain_calls"]) != (
                    per_fwd * n, ar_fwd * n, ar_fwd * n, 0, 0):
            raise AssertionError(f"{label}: process {k}'s counters {c} over {n} forwards, "
                                 f"want {per_fwd} Q40 and {ar_fwd} cross-process kernel-4 "
                                 "launches a forward, 0 plain")
        lines.append(got[0])
    if res[1][1].strip():
        raise AssertionError(f"{label}: process 1 printed {res[1][1][:200]!r}")
    f0, f1 = (x["forwards"] for x in lines)
    print(f"{label}: both processes exit 0 in {wall:.1f} s; process 0 {f0}, process 1 {f1} "
          f"forwards; each {per_fwd} Q40 and {ar_fwd} cross-process kernel-4 launches a "
          f"forward, 0 plain; peak device memory (PyTorch) {lines[0]['peak_bytes'] / 2**30:.2f}"
          f" / {lines[1]['peak_bytes'] / 2**30:.2f} GiB, IPC regions "
          f"{lines[0]['ipc_bytes'] / 2**20:.1f} / {lines[1]['ipc_bytes'] / 2**20:.1f} MiB")
    return dict(stdout=res[0][1], counters=lines, wall_s=wall)


def worker_path(cli, m: str, t: str, run_tp: dict | None, L: int) -> dict:
    """Phase 25: the worker path, two processes of one rank each (tp = 2)
    on cuda:0, at 7B width and ``L`` layers (phase 17's file): ``inference``
    with phase 17's prompt, greedy, against phase 17's single-process tp = 2
    pieces (its first WORKER_STEPS tokens) and its ms/token; ``generate``
    of the same prompt, whose text must be those pieces joined; ``batch``
    over phase 14b's prompts against the single-process tp = 2 batch (run
    here in-process).  Each process: 7 L + 1 Q40 launches (its rank) and
    2 L cross-process kernel-4 launches a forward, 0 plain."""
    per_fwd, ar_fwd = 7 * L + 1, 2 * L
    dev_args = ["--model", m, "--tokenizer", t, "--temperature", "0", "--workers", "tpu:2",
                "--device", "cuda:0"]
    out = {"ipc_launches": 0}
    inf = _group_run("inference", [*dev_args, "--steps", str(WORKER_STEPS), "--chunk", "16"],
                     "inference over 2 processes", per_fwd, ar_fwd)
    pieces = token_pieces(inf["stdout"])
    ms = float(re.search(r"Avg generation time: ([\d.]+) ms", inf["stdout"]).group(1))
    out.update(ms_token=ms, peak_bytes=[c["peak_bytes"] for c in inf["counters"]],
               ipc_bytes=[c["ipc_bytes"] for c in inf["counters"]])
    if run_tp is not None:
        ref = run_tp["pieces"][:len(pieces)]
        if pieces != ref:
            gap = next(i for i, (a, b) in enumerate(zip(pieces, ref)) if a != b)
            raise AssertionError(f"inference over 2 processes: token {gap} is {pieces[gap]} "
                                 f"where one process's tp = 2 run has {ref[gap]}")
        print(f"inference over 2 processes: {len(pieces)} tokens, the single-process tp = 2 "
              f"run's (phase 17) byte for byte; process 0 {ms} ms/token (one card, two "
              f"processes in time slices) against phase 17's {run_tp['ms_token']} ms/token")
    text = "".join(ast.literal_eval(p.strip()) for p in pieces)
    n_prompt = len(cli.Tokenizer(cli.tfile.read_tfile(t)).encode("Hello world",
                                                                 add_bos=True))
    gen = _group_run("generate", [*dev_args, "--prompt", "Hello world", "--steps",
                                  str(len(pieces))], "generate over 2 processes",
                     per_fwd, ar_fwd)
    body = "\n".join(ln for ln in gen["stdout"].split("\n")
                     if not ln.startswith(("💡", "⚠️"))).rstrip("\n")
    # generate stops at the tokenizer's EOS, inference runs on: the text is
    # the inference run's pieces up to where generate stopped
    upto = [i for i in range(n_prompt + 1, len(pieces) + 1)
            if "".join(ast.literal_eval(p.strip()) for p in pieces[:i]).rstrip("\n") == body]
    if not upto:
        raise AssertionError(f"generate over 2 processes: {body!r} is not the inference "
                             f"run's text {text!r}")
    print(f"generate over 2 processes: the inference run's text ({n_prompt} prompt + "
          f"{upto[-1] - n_prompt} generated tokens of {len(pieces) - n_prompt}) byte for "
          "byte")
    prompts = batch_prompts()
    pf = os.path.join(WORK, "prompts25.txt")
    with open(pf, "w", encoding="utf-8") as f:
        f.write("\n".join(prompts) + "\n")
    batch_args = [*dev_args, "--prompts-file", pf, "--steps", str(WORKER_BATCH_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    eng, one = run_cli(cli, ["batch", *batch_args])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    bat = _group_run("batch", batch_args, "batch over 2 processes", per_fwd, ar_fwd)

    def streams(o):
        return [ln for ln in o.splitlines()
                if not ln.startswith(("💡", "⚠️", "Batched throughput"))]

    if streams(bat["stdout"]) != streams(one):
        raise AssertionError("batch over 2 processes differs from the single-process tp = 2 "
                             "batch")
    print(f"batch over 2 processes: {len(prompts)} streams, the single-process tp = 2 "
          "batch's byte for byte")
    out["ipc_launches"] = sum(c["q40"]["allreduce_ipc_launches"]
                              for r in (inf, gen, bat) for c in r["counters"])
    return out


# phase 21: state off the card and back (snapshots, hand-off, QoS, KV tier)
QOS_PROMPT_TOKENS = 192   # each batch request's prompt (equal lengths: see qos_round)
QOS_NEW = 256             # each batch request's budget
HANDOFF_PROMPT = 512      # the hand-off request's prompt, in characters (~tokens)
# headroom 0: admission binds the prompt's pages alone, so decode growth meets
# a pool that admissions keep full (with 16 the mix ran dry without a spill
# in a CPU rehearsal at the same token counts)
TIER_ARGS = ["--kv-reserve", "optimistic", "--kv-host-pool-mb", "2048", "--spill-headroom", "0"]
# the optimistic pools: 129 pages at chunk 1; at chunk 16, with the requests
# queued together, 129 pages never spill (admission waits, radix eviction
# covers every growth), and 121 spill twice (the scheduler's decisions
# depend on token counts alone: a CPU run of this pass at the card's token
# counts repeats the card's stats at 129)
TIER_PAGES, TIER16_PAGES = "129", "121"


def _start(api, m: str, t: str, stack, extra=()):
    """An API server over the already loaded ``stack`` (its own engines'
    caches, the stack's weights) with phase 7's arguments and ``extra``."""
    srv = api.start(["--model", m, "--tokenizer", t, *SERVE_ARGS, *extra], stack=stack)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _ask(base: str, path: str, body: dict, rid: str | None = None):
    """(text, answer: the JSON, or the SSE text of a streamed request) of one
    request that must answer 200."""
    code, _, raw = _request(base, path, body, {"X-Request-Id": rid} if rid else None)
    if code != 200:
        raise AssertionError(f"{path} answered {code}: {raw[:400]}")
    ans = raw if body.get("stream") else json.loads(raw)
    return _answer_text(path, body, ans), ans


def _flight(base: str, rid: str) -> dict:
    return json.loads(_request(base, f"/debug/requests/{rid}")[2])


def _texts(n: int, k: int, seed: int) -> list[str]:
    rng = np.random.RandomState(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz  ")
    return ["".join(rng.choice(letters, k)) for _ in range(n)]


def _equal_token_prompts(tok, n: int, n_tokens: int, seed: int) -> list[str]:
    """``n`` random texts that encode to exactly ``n_tokens`` tokens each."""
    rng = np.random.RandomState(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz  ")
    out = []
    while len(out) < n:
        text = "".join(rng.choice(letters, n_tokens + 64))
        while len(tok.encode(text, add_bos=True)) > n_tokens:
            text = text[:-1]
        if len(tok.encode(text, add_bos=True)) == n_tokens:
            out.append(text)
    return out


def _moved(attention, label: str) -> dict:
    """The attention counters of a window that read moved pages: kernel 7
    launched, no plain call; returns them."""
    c = attention.counters()
    if not c["kernel_launches"] or c["plain_calls"] or c["prefill_plain_calls"]:
        raise AssertionError(f"{label}: attention counters {c}")
    print(f"{label}: kernel 7 launches {c['kernel_launches']}, plain {c['plain_calls']}; "
          f"prefill kernel launches {c['prefill_launches']}, plain "
          f"{c['prefill_plain_calls']}")
    return c


def pinned_copy_ms(nbytes: int, dev) -> dict:
    """The yardstick of a move: one plain ``copy_`` of ``nbytes`` between
    pinned host memory and the card, each way, the median of 5."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = {}
    for name, dst, src in (("d2h", host, card), ("h2d", card, host)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(ts))
    del host, card
    return out


def _chat_for_prefill(state) -> list[dict]:
    """A system prompt and a user turn whose templated prompt ends 8 to 15
    tokens past a page edge: the warm server's prefix hit then leaves a
    suffix of that many tokens, fed as a mixed step whose prefill kernel
    reads the restored pages (a 1-token suffix would be a decode step)."""
    from dllama_tpu_torch.tokenizer.chat import ChatItem
    system = "You are a terse assistant. " + _texts(1, 300, 21)[0]
    for user in (_texts(1, 24 + i, 22 + i)[0] for i in range(64)):
        msgs = [{"role": "system", "content": system}, {"role": "user", "content": user}]
        text = state.template.generate([ChatItem(x["role"], x["content"]) for x in msgs], True)
        if 8 <= len(state.tokenizer.encode(text, add_bos=True)) % 16:
            return msgs
    raise AssertionError("no user turn ends 8 to 15 tokens past a page edge")


def snapshot_warm_boot(api, attention, m, t, stack, work: str, codec: str) -> dict:
    """21a: a greedy chat on a fresh server (bf16 or int8 pool, graphs on),
    a drain that saves its snapshot, a second server that boots from it:
    the same chat reuses the restored prefix pages (the prefill kernel reads
    them, then kernel 7) and answers byte for byte.  Returns the counters
    and times."""
    extra = ["--snapshot-dir", os.path.join(work, f"snap-{codec}")]
    if codec == "int8":
        extra += ["--kv-quant", "int8"]
    cold, base = _start(api, m, t, stack, extra)
    out = {}
    try:
        chat = ("/v1/chat/completions", {"messages": _chat_for_prefill(cold.state),
                                         "max_tokens": 48, "temperature": 0})
        want, _ = _ask(base, *chat)
        if cold.state.scheduler.occupancy()["prefix_nodes"] == 0:
            raise AssertionError("the cold chat cached no prompt page")
        if codec == "int8":
            # a live int8 request's record: phase 21b's geometry refusal
            sched = cold.state.scheduler
            tk = sched.submit(stack[1].encode("hello " * 40, add_bos=True), 64)
            it = tk.tokens()
            next(it)
            out["int8_record"] = sched.checkpoint_export(tk.rid)
            tk.cancel()
            list(it)
            if out["int8_record"] is None:
                raise AssertionError("no live int8 slot to checkpoint")
        cold.state.begin_drain()
    finally:
        t0 = time.perf_counter()
        api.stop(cold)
        save_s = time.perf_counter() - t0
    snap_dir = extra[1]
    sizes = {f: os.path.getsize(os.path.join(snap_dir, f)) for f in sorted(os.listdir(snap_dir))}
    t0 = time.perf_counter()
    warm, base = _start(api, m, t, stack, extra)
    boot_s = time.perf_counter() - t0
    try:
        sched = warm.state.scheduler
        if sched.occupancy()["prefix_nodes"] == 0 or os.listdir(snap_dir):
            raise AssertionError(f"the warm boot restored no prefix: {sched.occupancy()}, "
                                 f"left {os.listdir(snap_dir)}")
        attention.reset_counters()
        got, _ = _ask(base, *chat)
        c = _moved(attention, f"21a {codec}: the warm chat over restored pages")
        if not c["prefill_launches"]:
            raise AssertionError("the warm chat's suffix never ran the prefill kernel")
        reused = sched.stats["prefix_tokens_reused"]
        if got != want or not reused:
            raise AssertionError(f"warm boot ({codec}): reused {reused} prompt tokens; "
                                 f"texts equal: {got == want}")
        print(f"21a {codec} pool: snapshot {sizes} bytes, drain + save {save_s:.2f} s, "
              f"boot + restore {boot_s:.2f} s; the warm chat reused {reused} prompt "
              f"tokens and answered the cold server's {len(got)} characters byte for byte")
    finally:
        api.stop(warm)
    return dict(out, attn=c, save_s=save_s, boot_s=boot_s, snap_bytes=sum(sizes.values()))


def engine_snapshot_mid_conversation(eng, work: str) -> None:
    """21a: the batch-1 engine (graphs on) snapshots after a first turn;
    the second turn's greedy bytes after a restore (in place) equal the
    uninterrupted second turn's, with replays and no new capture."""
    p1, p2 = ([int(x) for x in np.random.RandomState(s).randint(5, eng.cfg.vocab_size, n)]
              for s, n in ((23, 100), (24, 20)))
    eng.reset()
    list(eng.generate_stream(p1, len(p1) + 48, temperature=0.0, chunk=16))
    path = os.path.join(work, "engine.snap")
    t0 = time.perf_counter()
    eng.snapshot(path)
    save_s = time.perf_counter() - t0
    want = [tk for tk, _ in eng.generate_stream(p2, len(p2) + 64, temperature=0.0,
                                                seed=None, chunk=16)]
    caps, reps = _graph_counts(eng)
    t0 = time.perf_counter()
    eng.restore(path)
    restore_s = time.perf_counter() - t0
    got = [tk for tk, _ in eng.generate_stream(p2, len(p2) + 64, temperature=0.0,
                                               seed=None, chunk=16)]
    os.remove(path)
    caps2, reps2 = _graph_counts(eng)
    if got != want or caps2 != caps or reps2 <= reps:
        raise AssertionError(f"engine restore: tokens equal {got == want}, captures "
                             f"{caps} -> {caps2}, replays {reps} -> {reps2}")
    print(f"21a batch-1 engine: snapshot {save_s:.2f} s, restore in place {restore_s:.2f} s; "
          f"the second turn's {len(got) - len(p2)} tokens byte for byte, "
          f"{reps2 - reps} replays, no new capture")


def _graph_counts(eng) -> tuple[int, int]:
    """(captures, replays) of the engine's decode graphs."""
    return eng.graphs.captures, eng.graphs.replays


def _graph_state(eng) -> tuple[int, int, set]:
    """(captures, replays, the keys captured) of the engine's graphs."""
    return (*_graph_counts(eng), set(eng.graphs.graphs))


def _fetch(base: str, path: str, data: bytes | None = None) -> tuple[int, bytes]:
    """(status, body bytes) of a GET, or of a POST of ``data``."""
    req = urllib.request.Request(base + path, data, headers={
        "Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sse_text(raw: bytes) -> tuple[str, list]:
    text, fins = "", []
    for line in raw.decode().splitlines():
        if line.startswith("data: {"):
            for ch in json.loads(line[6:]).get("choices", []):
                text += ch.get("text") or ""
                if ch.get("finish_reason"):
                    fins.append(ch["finish_reason"])
    return text, fins


def move_breakdown(sched, snapfmt, n_pages: int) -> list[dict]:
    """Where a record's time goes: the same number of free pages read off
    the card (gather, pinned copy), encoded (crc32, join), decoded and
    written back in place, timed apart, twice (the first pass allocates
    the pinned buffers, the second finds them in PyTorch's host cache)."""
    eng = sched.engine
    out = []
    with sched.exclusive():
        with sched._cond:
            pages = sched.pool.alloc(n_pages)
        try:
            for _ in range(2):
                t = [time.perf_counter()]
                arrays = eng.read_pool_pages(pages)
                t.append(time.perf_counter())
                blob = snapfmt.dumps_request(fingerprint="x", pos=0, chunk_counter=0,
                                             arrays=arrays, extra={})
                t.append(time.perf_counter())
                _, back = snapfmt.loads_request(blob)
                t.append(time.perf_counter())
                eng.write_pool_pages(pages, back)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                out.append({k: (b - a) * 1e3 for k, a, b in
                            zip(("read", "encode", "decode", "write"), t, t[1:])})
        finally:
            with sched._cond:
                sched.pool.decref(pages)
    print(f"21b a record's parts, {n_pages} pages, ms: " + "; then ".join(
        ", ".join(f"{k} {v:.2f}" for k, v in p.items()) for p in out))
    return out


def handoff_path(api, attention, snapfmt, m, t, stack, dev, int8_record) -> dict:
    """21b: two servers in one process with --handoff.  A greedy 512-token
    request streams on A; A drains after the first chunk (the export);
    the record is fetched once from A and imported into B past the
    characters the client has: the joined text equals B's undisturbed
    answer.  Then /admin/checkpoint on a live slot, and an int8 pool's
    record at B: 409."""
    a, base_a = _start(api, m, t, stack, ["--handoff"])
    b, base_b = _start(api, m, t, stack, ["--handoff"])
    try:
        body = {"prompt": _texts(1, HANDOFF_PROMPT, 25)[0], "max_tokens": 64,
                "temperature": 0}
        want, _ = _ask(base_b, "/v1/completions", body)
        sched_b = b.state.scheduler
        import_ms = []
        orig = sched_b.import_request

        def timed_import(blob):
            t0 = time.perf_counter()
            r = orig(blob)
            import_ms.append((time.perf_counter() - t0) * 1e3)
            return r
        sched_b.import_request = timed_import
        req = urllib.request.Request(base_a + "/v1/completions",
                                     json.dumps(dict(body, stream=True)).encode(),
                                     headers={"Content-Type": "application/json",
                                              "X-Request-Id": "handoff-7b"})
        got, fins, drain = "", [], {}

        def drain_a():
            t0 = time.perf_counter()
            a.state.begin_drain()
            drain["ms"] = (time.perf_counter() - t0) * 1e3
        th = None
        with urllib.request.urlopen(req, timeout=900) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: {"):
                    continue
                ch = json.loads(line[6:])["choices"][0]
                got += ch["text"]
                if ch["finish_reason"]:
                    fins.append(ch["finish_reason"])
                if th is None and got:
                    th = threading.Thread(target=drain_a)
                    th.start()
        th.join()
        code, rec = _fetch(base_a, "/admin/export/handoff-7b")
        again, _ = _fetch(base_a, "/admin/export/handoff-7b")
        if fins != ["handoff"] or code != 200 or again != 404:
            raise AssertionError(f"A's stream finished {fins}; export {code}, again {again}")
        meta, arrays = snapfmt.loads_request(rec)
        pos = int(meta["pos"])
        attention.reset_counters()
        # B served this request at these positions already: its decode
        # after the import only replays
        caps, reps = _graph_counts(b.state.batch_engine)
        code, raw = _fetch(base_b, f"/admin/import?emitted_chars={len(got)}", rec)
        caps2, reps2 = _graph_counts(b.state.batch_engine)
        rest, fins = _sse_text(raw)
        c = _moved(attention, "21b the imported request's decode over the moved pages")
        if code != 200 or got + rest != want or fins != ["length"]:
            raise AssertionError(f"import {code} {fins}: joined text equals the undisturbed "
                                 f"one: {got + rest == want}")
        if caps2 != caps or reps2 <= reps:
            raise AssertionError(f"21b import: captures {caps} -> {caps2}, replays {reps} -> "
                                 f"{reps2}")
        yard = pinned_copy_ms(len(rec), dev)
        print(f"21b hand-off of a {len(want)}-character request at position {pos} "
              f"({-(-pos // 16)} pages): record {len(rec)} bytes; export (drain, one slot) "
              f"{drain['ms']:.2f} ms, import {import_ms[0]:.2f} ms; pinned copy_ of the same "
              f"bytes d2h {yard['d2h']:.2f} ms, h2d {yard['h2d']:.2f} ms; the client's "
              f"{len(got)} characters from A and {len(rest)} from B join byte for byte; "
              f"B's slot graphs after the import: {reps2 - reps} replays, no new capture")
        parts = move_breakdown(sched_b, snapfmt, -(-pos // 16))
        # a checkpoint of a live slot: the request keeps decoding
        box = {}
        live = threading.Thread(target=lambda: box.update(ans=_ask(
            base_b, "/v1/completions", dict(body, max_tokens=128), rid="ckpt-7b")))
        live.start()
        deadline = time.monotonic() + 120
        code = 404
        while code != 200 and time.monotonic() < deadline:
            code, ck = _fetch(base_b, "/admin/checkpoint/ckpt-7b")
            time.sleep(0.01)
        live.join()
        ck_meta, _ = snapfmt.loads_request(ck)
        if code != 200 or box["ans"][1]["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"checkpoint {code}, live answer {box['ans'][1]}")
        code, raw = _fetch(base_b, "/admin/import", int8_record)
        if code != 409:
            raise AssertionError(f"an int8 pool's record answered {code} at a bf16 pool")
        print(f"21b /admin/checkpoint of a live slot at position {ck_meta['pos']}: 200, the "
              f"request went on to finish; an int8 pool's record at a bf16 pool: 409")
        return dict(attn=c, record_bytes=len(rec), export_ms=drain["ms"],
                    import_ms=import_ms[0], yard=yard, pos=pos, parts=parts)
    finally:
        api.stop(a)
        api.stop(b)


def qos_round(api, attention, m, t, stack, extra, new: int, label: str) -> dict:
    """8 batch requests (prompts of QOS_PROMPT_TOKENS tokens each, released
    together, so they prefill in the same steps and then only decode), then
    one interactive request once every batch request decodes.  Returns the
    answers, the interactive TTFT, the victims and the counters."""
    tok = stack[1]
    srv, base = _start(api, m, t, stack, extra)
    sched = srv.state.scheduler
    eng = srv.state.batch_engine
    at_resume = []
    unpark = sched._unpark_locked

    def unpark_seen(*a, **k):
        if not at_resume:
            at_resume.append(_graph_counts(eng))
        return unpark(*a, **k)
    sched._unpark_locked = unpark_seen
    try:
        prompts = _equal_token_prompts(tok, 8, QOS_PROMPT_TOKENS, 26)
        inter = {"prompt": _equal_token_prompts(tok, 2, 64, 27)[0], "max_tokens": 16,
                 "temperature": 0, "priority": "interactive"}
        answers: list = [None] * 8
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(i, _ask(
            base, "/v1/completions", {"prompt": prompts[i], "max_tokens": new,
                                      "temperature": 0, "priority": "batch"},
            rid=f"{label}-b{i}"))) for i in range(8)]
        st0 = dict(sched.stats)
        attention.reset_counters()
        with sched.exclusive():
            for i, th in enumerate(threads):
                th.start()
                while sched.occupancy()["queued"] < i + 1:
                    time.sleep(0.002)
        deadline = time.monotonic() + 300
        while sched.stats["prefill_tokens"] - st0["prefill_tokens"] < 8 * QOS_PROMPT_TOKENS:
            if time.monotonic() > deadline:
                raise AssertionError("the batch requests never finished their prefill")
            time.sleep(0.002)
        time.sleep(0.05)
        _ask(base, "/v1/completions", inter, rid=f"{label}-i")
        ttft = _flight(base, f"{label}-i")["ttft_s"] * 1e3
        for th in threads:
            th.join()
        graphs = (at_resume[0] if at_resume else None, _graph_counts(eng))
        c = attention.counters()
        recs = [_flight(base, f"{label}-b{i}") for i in range(8)]
        victims = [i for i, r in enumerate(recs) if r.get("preempt_count")]
        parked = [p["parked_ms"] for r in recs for p in r["phases"] if p["kind"] == "resumed"]
        export = [p["export_ms"] for r in recs for p in r["phases"]
                  if p["kind"] == "preempted"]
        return dict(answers=answers, prompts=prompts, ttft=ttft, victims=victims,
                    parked_ms=parked, export_ms=export, counters=c, graphs=graphs,
                    preemptions=sched.stats["preemptions"] - st0["preemptions"],
                    srv=srv, base=base)
    except BaseException:
        api.stop(srv)
        raise


def qos_path(api, attention, m, t, stack) -> dict:
    """21c: the interactive request preempts a batch slot; each victim's
    text equals its solo run's after it resumes; the interactive TTFT
    beside its TTFT on an idle server; --preempt-cap 0 finishes the victim
    ``preempted``; --no-preempt preempts nothing."""
    r = qos_round(api, attention, m, t, stack, [], QOS_NEW, "qos")
    srv, base = r["srv"], r["base"]
    try:
        if r["preemptions"] < 1 or not r["victims"]:
            raise AssertionError(f"no preemption: {r['preemptions']}, victims {r['victims']}")
        c = r["counters"]
        if not c["kernel_launches"] or c["plain_calls"] or c["prefill_plain_calls"]:
            raise AssertionError(f"21c attention counters {c}")
        # from the first unpark on, the batch requests only decode (the
        # interactive prefill ran before it): replays, no new capture
        at, end = r["graphs"]
        if at is None or end[0] != at[0] or end[1] <= at[1]:
            raise AssertionError(f"21c graphs at the first resume {at}, at the end {end}")
        for i in r["victims"]:
            text, ans = _ask(base, "/v1/completions", {"prompt": r["prompts"][i],
                                                       "max_tokens": QOS_NEW,
                                                       "temperature": 0})
            if (text != r["answers"][i][0] or ans["choices"][0]["finish_reason"]
                    != r["answers"][i][1]["choices"][0]["finish_reason"]):
                raise AssertionError(f"victim {i} resumed to another text than its solo run's")
        # the interactive request on the idle server (another prompt of the
        # same length: the first one's pages are in the prefix cache)
        idle = {"prompt": _equal_token_prompts(stack[1], 2, 64, 27)[1], "max_tokens": 16,
                "temperature": 0, "priority": "interactive"}
        _ask(base, "/v1/completions", idle, rid="qos-idle")
        idle_ttft = _flight(base, "qos-idle")["ttft_s"] * 1e3
        print(f"21c {r['preemptions']} preemption(s), victims {r['victims']}: each resumed to "
              f"its solo run's text byte for byte; preempt export "
              f"{', '.join(f'{x:.2f}' for x in r['export_ms'])} ms, preempt to resume "
              f"{', '.join(f'{x:.1f}' for x in r['parked_ms'])} ms; interactive TTFT "
              f"{r['ttft']:.1f} ms among 8 batch requests, {idle_ttft:.1f} ms on an idle "
              f"server; kernel 7 launches {c['kernel_launches']}, prefill kernel "
              f"{c['prefill_launches']}, plain 0; from the first resume on {end[1] - at[1]} "
              f"replays, no new capture")
    finally:
        api.stop(srv)
    out = dict(preemptions=r["preemptions"], parked_ms=r["parked_ms"], ttft=r["ttft"],
               idle_ttft=idle_ttft, export_ms=r["export_ms"], attn=r["counters"])
    for extra, label in ((["--preempt-cap", "0"], "cap0"), (["--no-preempt"], "nopre")):
        q = qos_round(api, attention, m, t, stack, extra, 64, label)
        api.stop(q["srv"])
        fins = [a[1]["choices"][0]["finish_reason"] for a in q["answers"]]
        if label == "cap0" and "preempted" not in fins:
            raise AssertionError(f"--preempt-cap 0: finishes {fins}")
        if label == "nopre" and (q["preemptions"] or not set(fins) <= {"length", "stop"}):
            raise AssertionError(f"--no-preempt: {q['preemptions']} preemptions, {fins}")
        print(f"21c {' '.join(extra)}: {q['preemptions']} preemption(s), finishes {fins}, "
              f"interactive TTFT {q['ttft']:.1f} ms")
        out[label] = dict(preemptions=q["preemptions"], fins=fins, ttft=q["ttft"])
    return out


def _tier_run(api, attention, m, t, stack, reqs, name: str, extra: list[str],
              together: bool) -> dict:
    """One pass of 21d: ``reqs`` through a fresh server with ``extra``.
    ``together``: every request is queued before the first admission (in
    order, under ``exclusive()``), so the dispatch sequence is a function
    of the scheduler's state alone; else the first request goes first (its
    prompt pages enter the prefix cache) and the rest follow 10 ms apart.
    Returns the texts, finish reasons, completion tokens, tok/s, stats,
    the spill and page-in phases, the attention counters, each request's
    emitted count at the first step that only a pool under pressure takes
    (a spill, a preemption or a radix eviction: until then a run's
    dispatches are those of an unpressed pool), and the graph counts at
    the first page-in and at the end."""
    srv, base = _start(api, m, t, stack, extra)
    try:
        sched = srv.state.scheduler
        eng = srv.state.batch_engine
        tickets, first = {}, {}
        submit = sched.submit

        def submit_kept(*a, **k):
            tk = submit(*a, **k)
            tickets[tk.rid] = tk
            return tk

        def first_pressure(fn, took=lambda out: True):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                if took(out):
                    first.setdefault("pressure",
                                     {r: len(tk.emitted) for r, tk in tickets.items()})
                return out
            return wrapped
        page_in = sched._try_page_in_locked

        def page_in_seen():
            n0 = sched.stats["pages_paged_in"]
            page_in()
            if "graphs" not in first and sched.stats["pages_paged_in"] > n0:
                first["graphs"] = _graph_state(eng)
                first["attn"] = attention.counters()
        sched.submit = submit_kept
        sched._spill_one_locked = first_pressure(sched._spill_one_locked, bool)
        sched._preempt_locked = first_pressure(sched._preempt_locked)
        if sched.prefix_cache is not None:
            sched.prefix_cache.evict = first_pressure(sched.prefix_cache.evict, bool)
        sched._try_page_in_locked = page_in_seen
        results: list = [None] * len(reqs)
        attention.reset_counters()

        def run(i):
            results[i] = _ask(base, *reqs[i], rid=f"tier-{name}-{i}")
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
        t0 = time.perf_counter()
        if together:
            with sched.exclusive():
                for i, th in enumerate(threads):
                    th.start()
                    while sched.occupancy()["queued"] < i + 1:
                        time.sleep(0.002)
        else:
            threads[0].start()
            while sched.occupancy()["prefix_nodes"] == 0 and threads[0].is_alive():
                time.sleep(0.01)
            for th in threads[1:]:
                th.start()
                time.sleep(0.01)
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        n_tok = sum(r["completion_tokens"] for r in list(srv.state.finished)[-len(reqs):])
        phases = [p for i in range(len(reqs))
                  for p in _flight(base, f"tier-{name}-{i}")["phases"]]
        rids = [f"tier-{name}-{i}" for i in range(len(reqs))]
        if sorted(tickets) != sorted(rids):
            raise AssertionError(f"21d {name}: requests off the scheduler: {sorted(tickets)}")
        fins = [_sse_text(a[1].encode())[1][-1] if reqs[i][1].get("stream")
                else a[1]["choices"][0]["finish_reason"] for i, a in enumerate(results)]
        return dict(texts=[a[0] for a in results], fins=fins, tok_s=n_tok / wall,
                    tokens=[list(tickets[r].emitted) for r in rids],
                    pressure=[first.get("pressure", {}).get(r) for r in rids],
                    stats=dict(sched.stats),
                    spill=[(p["ms"], p["pages"]) for p in phases if p["kind"] == "kv_spill"],
                    pagein=[(p["ms"], p["pages"]) for p in phases if p["kind"] == "kv_pagein"],
                    attn=_moved(attention, f"21d {name}"), attn_at_pagein=first.get("attn"),
                    graphs_at_pagein=first.get("graphs"),
                    graphs_end=_graph_state(eng))
    finally:
        api.stop(srv)


def _no_capture_since_pagein(run: dict, label: str) -> str:
    """A page-in writes the pool in place: since the first one, every
    capture is of a key never seen before (none re-captured), and the
    graphs kept replaying.  Returns the counts as text."""
    if run["graphs_at_pagein"] is None:
        raise AssertionError(f"{label}: no page-in")
    caps, reps, keys = run["graphs_at_pagein"]
    caps2, reps2, keys2 = run["graphs_end"]
    if caps2 - caps != len(keys2 - keys) or reps2 <= reps:
        raise AssertionError(f"{label}: since the first page-in captures {caps} -> {caps2} "
                             f"(new keys {len(keys2 - keys)}), replays {reps} -> {reps2}")
    return (f"since the first page-in {reps2 - reps} replays, {caps2 - caps} captures "
            f"(of keys first met then)")


def tier_path(api, attention, m, t, stack) -> dict:
    """21d: phase 7's request mix through --kv-reserve optimistic on a pool
    cut to 129 pages (121 at chunk 16; --kv-host-pool-mb 2048) and through
    full reservation on 513 pages, in two pairs of passes.

    At --sched-prefill-chunk 1 every position of every row goes through the
    single-token slot step, so a row's bytes depend on its tokens alone,
    whatever the spill pattern (a mixed step's rows take the tensor-core
    body, whose last bits differ from the decode body's): greedy texts
    equal byte for byte.  At phase 7's chunk 16 (the server's default) the
    requests are queued together, bursts unclamped by the step-time
    estimate (--sched-max-wait-ms) and aging off, so both passes dispatch
    alike until the optimistic pool first comes under pressure: each
    request's tokens up to then equal, every request finishes, growth runs
    before 16-wide writes and the prefill kernel reads paged-in pages.
    Both pairs: at least one spill and one page-in, kernel 7 (and at chunk
    16 the prefill kernel) with 0 plain calls, no graph re-captured after
    a page-in; tok/s of every pass and the spill and page-in ms a page."""
    reqs = serving_requests(16)
    runs = {}
    fixed = ["--sched-max-wait-ms", "1e9", "--preempt-age-ms", "0"]
    for name, extra, together in (
            ("full", ["--sched-prefill-chunk", "1"], False),
            ("optimistic", ["--sched-prefill-chunk", "1", "--kv-pages", TIER_PAGES,
                            *TIER_ARGS], False),
            ("full16", fixed, True),
            ("optimistic16", [*fixed, "--kv-pages", TIER16_PAGES, *TIER_ARGS], True)):
        runs[name] = _tier_run(api, attention, m, t, stack, reqs, name, extra, together)
    opt, full = runs["optimistic"], runs["full"]
    opt16, full16 = runs["optimistic16"], runs["full16"]
    for r, label in ((opt, "chunk 1"), (opt16, "chunk 16")):
        if not r["stats"]["pages_spilled"] or not r["stats"]["pages_paged_in"]:
            raise AssertionError(f"21d {label}: no spill or page-in: {r['stats']}")
    if opt["texts"] != full["texts"]:
        bad = [i for i, (x, y) in enumerate(zip(opt["texts"], full["texts"])) if x != y]
        raise AssertionError(f"21d: greedy texts differ from full reservation's at {bad}")
    for r, label in ((full, "full"), (full16, "full16")):
        if r["stats"]["pages_spilled"]:
            raise AssertionError(f"21d: {label} reservation spilled")
    if not opt16["attn"]["prefill_launches"]:
        raise AssertionError("21d chunk 16: the prefill kernel never ran")
    if not set(opt16["fins"]) <= {"length", "stop"}:
        raise AssertionError(f"21d chunk 16: finishes {opt16['fins']}")
    # each request's tokens before the first step an unpressed pool would
    # not take (the full pass's own evictions count too): equal
    cut = [min(x if x is not None else 1 << 30, y if y is not None else 1 << 30)
           for x, y in zip(opt16["pressure"], full16["pressure"])]
    bad = [i for i, (n, a, b) in enumerate(zip(cut, opt16["tokens"], full16["tokens"]))
           if a[:n] != b[:n]]
    if bad:
        raise AssertionError(f"21d chunk 16: tokens before the first pressure differ at {bad}")
    held = sum(min(n, len(a)) for n, a in zip(cut, opt16["tokens"]))
    graphs1 = _no_capture_since_pagein(opt, "21d chunk 1")
    graphs16 = _no_capture_since_pagein(opt16, "21d chunk 16")
    after = {k: opt16["attn"][k] - opt16["attn_at_pagein"][k]
             for k in ("kernel_launches", "prefill_launches")}
    per = {k: sum(ms for ms, _ in opt[k] + opt16[k]) / sum(n for _, n in opt[k] + opt16[k])
           for k in ("spill", "pagein")}
    print(f"21d 16 requests, prefill chunk 1: optimistic on 129 pages {opt['tok_s']:.2f} tok/s, "
          f"{opt['stats']['pages_spilled']} pages spilled in {len(opt['spill'])} spills, "
          f"{opt['stats']['pages_paged_in']} paged in, {opt['stats']['preemptions']} "
          f"preemptions; full on 513 pages {full['tok_s']:.2f} tok/s; every text byte for "
          f"byte; {graphs1}")
    print(f"21d 16 requests queued together, prefill chunk 16: optimistic on "
          f"{TIER16_PAGES} pages "
          f"{opt16['tok_s']:.2f} tok/s, {opt16['stats']['pages_spilled']} pages spilled in "
          f"{len(opt16['spill'])} spills, {opt16['stats']['pages_paged_in']} paged in, "
          f"{opt16['stats']['preemptions']} preemptions; full on 513 pages "
          f"{full16['tok_s']:.2f} tok/s; finishes {sorted(set(opt16['fins']))}; {held} "
          f"tokens before the first pressure equal the full pass's; after the first "
          f"page-in kernel 7 launches {after['kernel_launches']}, prefill kernel "
          f"{after['prefill_launches']}; {graphs16}")
    print(f"21d spill {per['spill']:.3f} ms a page, page-in {per['pagein']:.3f} ms a page "
          f"(8 MiB pages, both optimistic passes)")
    return dict(tok_s_opt=opt["tok_s"], tok_s_full=full["tok_s"], tok_s_opt16=opt16["tok_s"],
                tok_s_full16=full16["tok_s"], stats=opt["stats"], stats16=opt16["stats"],
                spill_ms_page=per["spill"], pagein_ms_page=per["pagein"],
                attn=[r["attn"] for r in runs.values()])


def state_movement(api, cli, attention, q40, snapfmt, m: str, t: str, dev) -> dict:
    """Phase 21 at Llama-2-7B width (the CUT_LAYERS Q40 file), 8 slots,
    513 pages of 16, prefill chunk 16 (phase 7's arguments): 21a snapshots
    and the warm boot, 21b hand-off, 21c QoS, 21d the KV tier.  One model
    load serves every server of the phase.  Returns the numbers and the
    launches for the kernel line."""
    work = os.path.join(WORK, "state")
    os.makedirs(work, exist_ok=True)
    stack = cli.load_stack(api.parse_args(["--model", m, "--tokenizer", t, *SERVE_ARGS]))
    q40.reset_counters()
    out = {}
    try:
        for codec in ("bf16", "int8"):
            out[f"snap_{codec}"] = snapshot_warm_boot(api, attention, m, t, stack, work, codec)
        engine_snapshot_mid_conversation(stack[0], work)
        out["handoff"] = handoff_path(api, attention, snapfmt, m, t, stack, dev,
                                      out["snap_int8"].pop("int8_record"))
        out["qos"] = qos_path(api, attention, m, t, stack)
        out["tier"] = tier_path(api, attention, m, t, stack)
    finally:
        del stack
        gc.collect()
        torch.cuda.empty_cache()
    qc = q40.counters()
    if qc["plain_calls"]:
        raise AssertionError(f"phase 21: a Q40 matmul left its kernel: {qc}")
    out["q40"] = qc
    bf16 = [out["snap_bf16"]["attn"], out["handoff"]["attn"], out["qos"]["attn"],
            *out["tier"]["attn"]]
    out["launches"] = {
        "bf16": sum(c["kernel_launches"] for c in bf16),
        "bf16_prefill": sum(c["prefill_launches"] for c in bf16),
        "int8": out["snap_int8"]["attn"]["kernel_launches"],
        "int8_prefill": out["snap_int8"]["attn"]["prefill_launches"]}
    return out


# -- phase 22: speculative decoding and the roofline gauges ---------------

PLD_PROMPT = " ".join(["the quick brown fox jumps over the lazy dog"] * 8)
PLD_K = 4
SPEC_NEW = 64
# a divergence of a speculative stream from the plain one is recorded as a
# deliberate difference only where the plain run's top-2 margin is under the
# matmul tolerance (the verify window's matmuls take another kernel body)
NEAR_TIE = KERNEL_TOL


def spec_prompts(n: int = 8, seed: int = 23) -> list[str]:
    """``n`` repetitive prompts (a random six-word phrase, eight times):
    prompt lookup finds drafts in them."""
    rng = np.random.RandomState(seed)
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.randint(2, 7)))
             for _ in range(64)]
    return [" ".join([" ".join(rng.choice(words, 6))] * 8) for _ in range(n)]


def first_gap(eng, ids: list[int], want: list[int], got: list[int], label: str) -> str:
    """Where a speculative stream ``got`` leaves the plain one ``want``
    (both after the prompt ``ids``): the position and the plain run's top-2
    logit margin there, against max|logit| (from a prefill of the plain
    prefix on the batch-1 engine ``eng``).  Raises unless the margin is a
    near tie (NEAR_TIE of max); '' when they are equal."""
    if got == want:
        return ""
    p = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b) \
        if any(a != b for a, b in zip(want, got)) else min(len(want), len(got))
    eng.reset()
    logits, _ = eng.prefill(ids + want[:p])
    top = np.sort(np.asarray(logits[0], np.float64))[::-1]
    rel = (top[0] - top[1]) / max(np.abs(top).max(), 1e-30)
    eng.reset()
    msg = (f"{label}: leaves the plain stream at generated token {p} "
           f"(plain {want[p] if p < len(want) else None}, speculative "
           f"{got[p] if p < len(got) else None}); the plain run's top-2 margin there "
           f"{top[0] - top[1]:.4g} = {rel:.3g} of max|logit|")
    if rel >= NEAR_TIE:
        raise AssertionError(msg + f" >= {NEAR_TIE}: not a near tie")
    return msg + " (a near tie: recorded)"


def pld_path(cli, q40, tok, m: str, t: str) -> tuple:
    """22a: ``inference --pld 4 --profile-split --profile-ops`` at Llama-2-7B
    width on a repetitive prompt (every Q40 matmul on its kernel,
    the windows replaying their captured graph), then on the same engine the
    PLD stream against plain greedy decode, each twice in turns after a
    warm pass: the same tokens (or a recorded near tie), ms/token both
    ways, and no capture in the timed part.  Returns (numbers, engine)."""
    q40.reset_counters()
    eng, out = run_cli(cli, ["inference", "--model", m, "--tokenizer", t, "--prompt",
                             PLD_PROMPT, "--temperature", "0", "--steps", "96", "--chunk",
                             "16", "--pld", str(PLD_K), "--profile-split", "--profile-ops"])
    qc = q40.counters()
    lines = out.splitlines()
    print("\n".join([ln for ln in lines if not ln.startswith("🔶")][-24:]))
    per_fwd = 4 * eng.cfg.n_layers + 1
    # the CLI's forwards: the prompt, the windows, the tail's single steps
    # and the profile's warm and traced steps: 4 L + 1 launches each
    if qc["plain_calls"] or qc["kernel_launches"] != per_fwd * eng.forwards:
        raise AssertionError(f"--pld: Q40 counters {qc} over {eng.forwards} forwards")
    split = [ln for ln in lines if ln.startswith("Profiled decode step")]
    tops = [ln for ln in lines if ln.startswith("  top op")]
    if not split or "graph replays" not in split[0] or not any(
            matmul_kernel(ln, "q40") for ln in tops):
        raise AssertionError(f"--profile-split/--profile-ops: {split} {tops}")
    m_pld = re.search(r"💡 pld: (\d+) verify windows of k=\d+, (\d+) of (\d+) drafts "
                      r"accepted, ([\d.]+) tokens a window", out)
    ids = tok.encode(PLD_PROMPT, add_bos=True)
    n = len(ids) + 96

    def timed(pld: bool):
        eng.reset()
        stream = eng.generate_pld_stream(ids, n, k=PLD_K) if pld else \
            (tk for tk, _ in eng.generate_stream(ids, n, temperature=0.0, chunk=16))
        toks, t1 = [], None
        for tk in stream:
            toks.append(tk)
            if len(toks) == len(ids) + 1:
                t1 = time.perf_counter()  # the prefill's token is out
        torch.cuda.synchronize()
        return (toks[len(ids):], (time.perf_counter() - t1) * 1e3 / (len(toks) - len(ids) - 1),
                dict(eng.pld_stats))

    timed(True)
    timed(False)  # warm: every key captured
    cap0, rep0 = eng.graphs.captures, eng.graphs.replays
    runs = {"plain": [], "pld": []}
    for pld in (False, True, True, False):
        toks, ms, stats = timed(pld)
        runs["pld" if pld else "plain"].append((toks, ms))
        if pld:
            w = stats
    if eng.graphs.captures != cap0 or eng.graphs.replays <= rep0:
        raise AssertionError(f"a capture in the timed part: {eng.graphs.captures} "
                             f"against {cap0}")
    want, got = runs["plain"][0][0], runs["pld"][0][0]
    if runs["plain"][1][0] != want or runs["pld"][1][0] != got:
        raise AssertionError("a stream did not repeat itself")
    gap = first_gap(eng, ids, want, got, "--pld 4")
    per = (w["accepted"] + w["windows"]) / max(w["windows"], 1)
    ms_plain = [ms for _, ms in runs["plain"]]
    ms_pld = [ms for _, ms in runs["pld"]]
    print(f"22a --pld {PLD_K}: greedy bytes {'equal' if not gap else gap} over "
          f"{len(want)} tokens; {per:.2f} tokens a verify window ({w['accepted']} of "
          f"{w['proposed']} drafts accepted); ms/token plain {ms_plain[0]:.3f}, "
          f"{ms_plain[1]:.3f}, pld {ms_pld[0]:.3f}, {ms_pld[1]:.3f}; "
          f"{eng.graphs.captures} graphs captured, {eng.graphs.replays} replays "
          f"({eng.graphs.replays - rep0} in the timed part, 0 captures); CLI run: "
          f"{m_pld.group(0) if m_pld else 'no pld line'}")
    return dict(tokens_per_window=per, ms_plain=ms_plain, ms_pld=ms_pld, gap=gap,
                cli_windows=m_pld.group(0) if m_pld else None, q40=qc), eng


def spec_serving(api, attention, q40, tok, m: str, t: str, stack) -> dict:
    """22b-d: the API server over phase 3's weights, 8 slots, 513 pages of
    16 (phase 7's arguments), with ``--spec off``, ``--spec pld`` and
    ``--spec draft`` (the draft the target's own file: the best case).
    Each: a warm burst of 8 repetitive greedy requests released together
    (captures), a timed burst (tok/s, TTFT; no capture; the attention
    kernels on every forward: kernel 7 on single-token ones, the prefill
    kernel n_layers times on every mixed and verify forward, 0 plain), and
    a token pass (the same prompts submitted to the scheduler together):
    the tokens equal ``--spec off``'s, or leave them only at a recorded
    near tie.  22c: ``/health``'s ``perf`` block and the ``mfu``/``mbu``
    gauges of each timed burst in (0, 1], source ``table``, the card's
    name.  22d: ``POST /debug/profile`` names the port's kernels."""
    from dllama_tpu_torch.obs import dispatch as obs_dispatch
    prompts = spec_prompts()
    reqs = [("/v1/completions", {"prompt": p, "max_tokens": SPEC_NEW, "temperature": 0})
            for p in prompts]
    ids = [tok.encode(p, add_bos=True) for p in prompts]
    modes = (("off", []), ("pld", ["--spec", "pld", "--spec-k", str(PLD_K)]),
             ("draft", ["--spec", "draft", "--spec-k", str(PLD_K), "--draft-model", m]))
    out, ref = {}, None
    for mode, extra in modes:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv, base = _start(api, m, t, stack, extra)
        load_s = time.perf_counter() - t0
        try:
            state = srv.state
            eng, sched = state.batch_engine, state.scheduler
            engines = [eng] + ([sched.spec.engine] if mode == "draft" else [])
            controlled_burst(sched, state, base, reqs, True)  # warm: captures
            caps = [e.graphs.captures for e in engines]
            obs_dispatch.reset()
            attention.reset_counters()
            q40.reset_counters()
            f0, d0, v0 = eng.forwards, eng.slot_decode_forwards, eng.verify_forwards
            st0 = dict(sched.stats)
            burst = controlled_burst(sched, state, base, reqs, True)
            ac, qc = attention.counters(), q40.counters()
            n_dec, n_ver = eng.slot_decode_forwards - d0, eng.verify_forwards - v0
            n_mix = eng.forwards - f0 - n_dec - n_ver
            L = eng.cfg.n_layers
            if [e.graphs.captures for e in engines] != caps:
                raise AssertionError(f"{mode}: a capture in the timed burst")
            if (ac["kernel_launches"] != L * n_dec or ac["plain_calls"]
                    or ac["prefill_launches"] != L * (n_mix + n_ver)
                    or ac["prefill_plain_calls"] or qc["plain_calls"]):
                raise AssertionError(f"{mode}: attention {ac}, Q40 {qc} over {n_dec} "
                                     f"single-token, {n_mix} mixed, {n_ver} verify forwards")
            if mode != "off" and n_ver == 0:
                raise AssertionError(f"{mode}: no verify step ran")
            recs = list(state.finished)[-len(reqs):]
            ttft = [r["ttft_s"] * 1e3 for r in recs if r["ttft_s"] is not None]
            health = json.loads(_request(base, "/health")[2])
            perf = health["perf"]
            st1 = sched.stats
            prop = st1["spec_proposed"] - st0["spec_proposed"]
            acc = st1["spec_accepted"] - st0["spec_accepted"]
            name = torch.cuda.get_device_name(0)
            if not (0 < perf["mfu"] <= 1 and 0 < perf["mbu"] <= 1
                    and perf["peaks"]["source"] == "table" and perf["card"]["name"] == name):
                raise AssertionError(f"{mode}: /health perf {perf}")
            metrics = json.loads(_request(base, "/metrics")[2])
            if not (0 < metrics["mfu"] <= 1 and 0 < metrics["mbu"] <= 1
                    and metrics["dispatch_flops"]):
                raise AssertionError(f"{mode}: /metrics gauges {metrics['mfu']}, "
                                     f"{metrics['mbu']}")
            # the token pass: the prompts queued in order while parked, then
            # released together
            with sched.exclusive():
                tickets = [sched.submit(i, SPEC_NEW, temperature=0.0) for i in ids]
            toks = [list(tk.tokens()) for tk in tickets]
            peak = torch.cuda.max_memory_allocated()
            row = dict(tok_s=burst["tok_s"], ttft_p50=_percentile(ttft, 50),
                       ttft_p99=_percentile(ttft, 99), accept=acc / prop if prop else None,
                       proposed=prop, accepted=acc, verify=n_ver, mixed=n_mix,
                       decode=n_dec, prefill_launches=ac["prefill_launches"],
                       attn_launches=ac["kernel_launches"], q40=qc, mfu=perf["mfu"],
                       mbu=perf["mbu"], peak=peak, load_s=load_s,
                       launches_by_shape=qc["launches_by_shape"])
            if mode == "off":
                ref = toks
                code, _, raw = _request(base, "/debug/profile?steps=4&top=10", {})
                prof = json.loads(raw)
                if code != 200 or not any(matmul_kernel(o["op"], "q40") for o in prof["ops"]):
                    raise AssertionError(f"POST /debug/profile: {code} {raw[:600]}")
                print(f"22d POST /debug/profile ({prof['how']}): compute "
                      f"{prof['compute_ms']} ms a step, collectives {prof['collective_ms']} ms; "
                      f"top ops:")
                for o in prof["ops"]:
                    print(f"  {o['ms']:8.4f} ms  {o['op'][:90]}")
                row["profile"] = prof
            else:
                gaps = [first_gap(stack[0], ids[i], ref[i], toks[i], f"{mode} request {i}")
                        for i in range(len(ids))]
                row["gaps"] = [g for g in gaps if g]
                for g in row["gaps"]:
                    print(g)
            print(f"22b --spec {mode}: {row['tok_s']:.2f} tok/s, TTFT p50 "
                  f"{row['ttft_p50']:.1f} p99 {row['ttft_p99']:.1f} ms; greedy tokens "
                  f"{'(the reference)' if mode == 'off' else ('equal to off' if not row['gaps'] else str(len(row['gaps'])) + ' near-tie divergences')}; "
                  f"accept ratio {row['accept']}, {prop} drafts, {n_ver} verify / {n_mix} mixed "
                  f"/ {n_dec} single-token forwards; prefill kernel {ac['prefill_launches']} "
                  f"launches ({L} a mixed or verify forward), plain "
                  f"{ac['prefill_plain_calls']}; kernel 7 {ac['kernel_launches']}, plain "
                  f"{ac['plain_calls']}; peak memory {peak / 2**30:.2f} GiB; server up in "
                  f"{load_s:.1f} s")
            print(f"22c --spec {mode}: /health perf mfu {perf['mfu']:.4g} mbu "
                  f"{perf['mbu']:.4g} (peaks {perf['peaks']['source']}: "
                  f"{perf['peaks']['flops']:.4g} FLOP/s, {perf['peaks']['bytes_per_s']:.4g} "
                  f"B/s, {perf['card']['name']}, {perf['card']['power_limit']}); "
                  f"{perf['flops_total']:.4g} FLOP, {perf['hbm_bytes_total']:.4g} B over "
                  f"{perf['chip_wall_ms']} ms of dispatch wall")
            out[mode] = row
        finally:
            api.stop(srv)
            del srv
    return out


def spec_and_gauges(api, cli, attention, q40, tfile, m: str, t: str) -> dict:
    """Phase 22 at Llama-2-7B width (the CUT_LAYERS Q40 file): 22a
    prompt lookup and the profiler on the CLI, then 22b-d the server's
    speculation, the gauges and ``/debug/profile`` over the same weights.
    Returns the numbers and the launches for the kernel line."""
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer
    tok = Tokenizer(tfile.read_tfile(t))
    out = {}
    pld, eng = pld_path(cli, q40, tok, m, t)
    out["pld"] = pld
    try:
        out["serve"] = spec_serving(api, attention, q40, tok, m, t, (eng, tok))
    finally:
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    runs = out["serve"].values()
    out["launches"] = {"bf16": sum(r["attn_launches"] for r in runs),
                       "bf16_prefill": sum(r["prefill_launches"] for r in runs)}
    shapes: dict = {}
    for r in [*runs, {"launches_by_shape": pld["q40"]["launches_by_shape"]}]:
        for key, n in r["launches_by_shape"].items():
            shapes[key] = shapes.get(key, 0) + n
    out["launches_by_shape"] = shapes
    return out


# phase 23: the fleet — the router and serve-pod in front of replicas on the
# card, the fault points, checksum manifests, the step watchdog and the
# numeric guard
FLEET_ARGS = ["--batch-slots", "8", "--kv-pages", "513", "--kv-page-size", "16",
              "--sched-prefill-chunk", "16", "--temperature", "0", "--max-pending", "64",
              "--handoff", "--host", "127.0.0.1", "--port", "0", "--probe-interval", "0.5"]
# the depth of the 7B-width paths: every one but the 2-layer checks (phase 3
# and the ones that serve its file, 17 (tp = 2), 10 (Q80), 14 (the blocked
# layout), 21, 22, 23)
CUT_LAYERS = 8
# 23b: the children's pod (7B width, CUT_LAYERS layers); 65-token prompts are
# four whole pages plus one token, so once a child cached them a request
# feeds one token and every step it rides is a single-token step
SUPERVISED_ARGS = ["--supervise", "--dp", "2", "--device", "cuda:0", "--handoff",
                   "--checkpoint-interval", "0.5", "--batch-slots", "8", "--kv-pages", "257",
                   "--kv-page-size", "16", "--sched-prefill-chunk", "16", "--temperature", "0",
                   "--max-pending", "64", "--host", "127.0.0.1", "--port", "0",
                   "--probe-interval", "0.5", "--eject-after", "2", "--readmit-after", "1",
                   "--step-timeout", "5"]
DRILL_PROMPT_TOKENS = 65
# 23c: --numeric-checks may cost at most this share of a decode token
NUMERIC_CHECKS_TOL = 0.03


class _Stream:
    """One streamed request on a thread: its text, finish reasons and the
    host clock of each chunk (TTFT and the longest gap, a resume's)."""

    def __init__(self, base: str, path: str, body: dict, rid: str):
        self.text, self.fins, self.times, self.error = "", [], [], None
        self.t0 = time.perf_counter()
        self._req = urllib.request.Request(
            base + path, json.dumps(dict(body, stream=True)).encode(),
            headers={"Content-Type": "application/json", "X-Request-Id": rid})
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            with urllib.request.urlopen(self._req, timeout=600) as r:
                for line in r:
                    line = line.decode().strip()
                    if not line.startswith("data: {"):
                        continue
                    ch = json.loads(line[6:])["choices"][0]
                    self.times.append(time.perf_counter())
                    self.text += ch.get("text") or (ch.get("delta") or {}).get("content") or ""
                    if ch.get("finish_reason"):
                        self.fins.append(ch["finish_reason"])
        except Exception as e:  # noqa: BLE001 — re-raised on join
            self.error = e

    def join(self) -> "_Stream":
        self.thread.join(600)
        if self.thread.is_alive() or self.error is not None:
            raise AssertionError(f"a stream failed: {self.error!r}")
        return self

    @property
    def ttft_ms(self) -> float:
        return (self.times[0] - self.t0) * 1e3

    @property
    def max_gap_ms(self) -> float:
        return max((b - a for a, b in zip(self.times, self.times[1:])), default=0.0) * 1e3


def _until(cond, timeout: float, what: str) -> float:
    """Poll ``cond`` until it holds; returns the seconds it took."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def fleet_in_process(cli, pod_mod, obs_metrics, attention, q40, m: str, t: str):
    """23a: ``serve-pod --dp 2 --device cuda:0`` at Llama-2-7B width
    (CUT_LAYERS), in this process (the file read once, the replicas sharing its
    weights).  Phase 7's requests one at a time through the router, each
    equal byte for byte to the same request straight to replica 1; 8 short
    streams each way for TTFT; then the 16 released together through the
    router (every text the solo text's, or a recorded near tie), both
    replicas serving, ``router_dispatch`` summing to the requests sent, the
    kernels (1-2, 7, the prefill kernel) launched with no plain call, no
    capture in the timed burst.  Returns the pod (23c reuses its weights)
    and the numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = cli.build_parser().parse_args(["serve-pod", "--model", m, "--tokenizer", t,
                                          "--dp", "2", "--device", "cuda:0", *FLEET_ARGS])
    t0 = time.perf_counter()
    pod = pod_mod.start(args)
    try:
        base = f"http://127.0.0.1:{pod.port}"
        states = [s.state for s in pod.servers]
        addrs = [f"127.0.0.1:{s.server_address[1]}" for s in pod.servers]
        direct = f"http://{addrs[1]}"
        e0, e1 = (s.engine for s in states)
        if e0.params["wqkv"].qpacked.data_ptr() != e1.params["wqkv"].qpacked.data_ptr():
            raise AssertionError("the replicas hold two copies of the weights")
        _until(lambda: pod.rstate.registry.snapshot()["available"] == 2, 30,
               "the router to admit both replicas")
        print(f"pod up in {time.perf_counter() - t0:.1f} s: router :{pod.port} in front "
              f"of {addrs}, one copy of the weights")
        # every ticket the replicas take, by request ID (the tokens of a
        # burst answer against its solo run)
        tickets = {}
        for st in states:
            def record(*a, _submit=st.sched_submit, **k):
                tk = _submit(*a, **k)
                tickets[tk.rid] = tk
                return tk
            st.sched_submit = record
        reqs = serving_requests(16)
        attention.reset_counters()
        q40.reset_counters()
        slot0 = [(s.batch_engine.slot_decode_forwards, s.batch_engine.forwards,
                  s.batch_engine.graphs.replays) for s in states]
        disp0 = [obs_metrics.ROUTER_DISPATCH.get(a) for a in addrs]
        sent = 0
        for i, (path, body) in enumerate(reqs):
            via, _ = _ask(base, path, body, f"solo-r{i}")
            straight, _ = _ask(direct, path, body, f"solo-d{i}")
            sent += 1
            if via != straight or not via:
                raise AssertionError(f"request {i} through the router differs from the "
                                     f"same request straight to a replica: {via!r} / "
                                     f"{straight!r}")
        print(f"{len(reqs)} requests one at a time: through the router = straight to "
              f"{addrs[1]}, byte for byte")
        ttft = {"router": [], "direct": []}
        for i in range(8):
            path, body = reqs[1 + i]
            for name, where in (("router", base), ("direct", direct)):
                s = _Stream(where, path, dict(body, max_tokens=4), f"ttft-{name}{i}").join()
                ttft[name].append(s.ttft_ms)
            sent += 1
        caps0 = [s.batch_engine.graphs.captures for s in states]
        burst0 = [obs_metrics.ROUTER_DISPATCH.get(a) for a in addrs]
        results: list = [None] * len(reqs)

        def run(i):
            path, body = reqs[i]
            results[i] = _request(base, path, body, {"X-Request-Id": f"burst{i}"})

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        sent += len(reqs)
        bad = [(i, code, raw[:300]) for i, (code, _, raw) in enumerate(results) if code != 200]
        if bad:
            raise AssertionError(f"burst requests failed: {bad}")
        caps1 = [s.batch_engine.graphs.captures for s in states]
        if caps1 != caps0:
            raise AssertionError(f"a graph was captured in the timed burst: {caps0} -> {caps1}")
        gaps = []
        for i, (path, body) in enumerate(reqs):
            want, got = tickets[f"solo-r{i}"], tickets[f"burst{i}"]
            gap = first_gap(states[0].engine, list(want.prompt), list(want.emitted),
                            list(got.emitted), f"burst request {i}")
            if gap:
                gaps.append(gap)
        for gap in gaps:
            print(gap)
        n_tok = sum(len(tickets[f"burst{i}"].emitted) for i in range(len(reqs)))
        served = [obs_metrics.ROUTER_DISPATCH.get(a) - b for a, b in zip(addrs, burst0)]
        total = sum(obs_metrics.ROUTER_DISPATCH.get(a) - b for a, b in zip(addrs, disp0))
        if min(served) < 4 or total != sent:
            raise AssertionError(f"router dispatch: burst {served} (want >= 4 each), "
                                 f"{total} in all for {sent} requests sent")
        ac, qc = attention.counters(), q40.counters()
        if (not qc["kernel_launches"] or qc["plain_calls"] or not ac["kernel_launches"]
                or ac["plain_calls"] or not ac["prefill_launches"]
                or ac["prefill_plain_calls"]):
            raise AssertionError(f"the pod left a kernel: q40 {qc}, attention {ac}")
        per = []
        for (d0, f0, r0), s in zip(slot0, states):
            eng = s.batch_engine
            per.append((eng.slot_decode_forwards - d0, eng.forwards - f0,
                        eng.graphs.replays - r0))
            if not all(per[-1]):
                raise AssertionError(f"a replica ran no slot step through its graphs: {per}")
        peak = torch.cuda.max_memory_allocated()
        code, _, prom = _request(base, "/metrics?format=prometheus")
        labels = sorted(set(re.findall(r'\breplica="([^"]+)"', prom)))
        if code != 200 or not set(addrs) <= set(labels):
            raise AssertionError(f"the federated /metrics lacks a replica: {labels}")
        print(f"burst: {len(reqs)} requests released together through the router in "
              f"{wall:.2f} s, {n_tok} completion tokens, {n_tok / wall:.2f} tok/s; "
              f"dispatched {served} to {addrs}; every text the solo text's"
              + (f" but {len(gaps)} near ties" if gaps else "")
              + f"; router_dispatch {total} for {sent} requests sent")
        print(f"TTFT of a 4-token stream, 8 each way: through the router p50 "
              f"{_percentile(ttft['router'], 50):.1f} p99 {_percentile(ttft['router'], 99):.1f}"
              f" ms; straight to a replica p50 {_percentile(ttft['direct'], 50):.1f} p99 "
              f"{_percentile(ttft['direct'], 99):.1f} ms")
        print(f"kernels over the phase (both replicas, counters bumped under one lock): "
              f"q40 kernels 1-2 {qc['kernel_launches']} (tensor-core body "
              f"{qc['mma_launches']}), plain {qc['plain_calls']}; kernel 7 "
              f"{ac['kernel_launches']}, plain {ac['plain_calls']}; prefill kernel "
              f"{ac['prefill_launches']}, plain {ac['prefill_plain_calls']}; per replica "
              f"(single-token slot forwards, slot forwards, graph replays): {per}")
        print(f"peak device memory {peak / 2**30:.2f} GiB (both replicas, one card); "
              f"federated /metrics replica labels {labels}")
        return pod, dict(tok_s=n_tok / wall, ttft=ttft, peak_bytes=peak, near_ties=len(gaps),
                         launches_by_shape=dict(qc["launches_by_shape"]),
                         attn_launches=ac["kernel_launches"],
                         prefill_launches=ac["prefill_launches"])
    except BaseException:
        pod.stop()
        raise


def fleet_integrity(cli, api, engine_mod, obs_metrics, faults, integrity, pod,
                    m: str, t: str, load_s: float | None) -> dict:
    """23c on the 7B file: a manifest written by the port; ``generate
    --verify-weights`` (its weights-read seconds beside phase 3's, without)
    answers the greedy bytes of the pod's weights; ``io.read_tensor=corrupt``
    under verification raises ArtifactError naming the tensor; under
    ``--numeric-checks`` an ``engine.numeric`` NaN gets a 500 and the next
    request answers as before it; the batch-1 engine's ms/token with the
    guard within NUMERIC_CHECKS_TOL of without (graphs on)."""
    from dllama_tpu_torch.io.integrity import ArtifactError
    base_eng, tok = pod.servers[0].state.engine, pod.servers[0].state.tokenizer
    t0 = time.perf_counter()
    integrity.write_manifest(m)
    write_s = time.perf_counter() - t0
    prompt, steps = "Once upon a time", 48
    eng, out = run_cli(cli, ["generate", "--model", m, "--tokenizer", t, "--prompt", prompt,
                             "--steps", str(steps), "--temperature", "0", "--verify-weights"])
    verified_s = cli.last_read_s
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the same greedy stream on the pod's weights, printed as generate prints it
    shared = engine_mod.Engine(base_eng.cfg, base_eng.params, device=base_eng.device)
    ids = tok.encode(prompt, add_bos=shared.cfg.add_bos)
    prev, text = tok.bos_id, ""
    for token, _ in shared.generate_stream(ids, steps, temperature=0.0,
                                           eos_ids=(tok.eos_id,), chunk=16):
        text += tok.decode_piece(prev, token).decode("utf-8", errors="replace")
        prev = token
    if text not in out:
        raise AssertionError("generate --verify-weights answered other greedy bytes than "
                             "the same weights unverified")
    n_regions = len(integrity.load_manifest_for(m)["tensors"]) + 1
    print(f"manifest of {os.path.getsize(m) / 1e9:.2f} GB ({n_regions} regions) written in "
          f"{write_s:.2f} s; weights read in {verified_s:.2f} s with --verify-weights, "
          + (f"{load_s:.2f} s without (phase 3)" if load_s is not None else
             "without: not measured (phase 3 did not run)")
          + f"; the greedy bytes equal ({len(text)} chars)")
    try:
        with faults.injected("io.read_tensor=corrupt@4x1"):
            run_cli(cli, ["generate", "--model", m, "--tokenizer", t, "--prompt", prompt,
                          "--steps", "4", "--verify-weights"])
    except ArtifactError as e:
        if not e.field.startswith("tensor '") or e.field[8:-1] not in str(e):
            raise AssertionError(f"the corruption's error names no tensor: {e}") from e
        print(f"io.read_tensor=corrupt@4x1 under --verify-weights: ArtifactError at "
              f"{e.field}, byte {e.offset}")
    else:
        raise AssertionError("a corrupted tensor read was not caught by its checksum")
    srv, base = _start(api, m, t, (base_eng, tok), ["--numeric-checks"])
    try:
        body = {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 16,
                "temperature": 0.8, "seed": 5}
        faults_before = obs_metrics.NUMERIC_FAULTS.value
        with faults.injected("engine.numeric=nan@1x1"):
            first, _ = _ask(base, "/v1/chat/completions", body)
            code, _, raw = _request(base, "/v1/chat/completions", body)
            again, _ = _ask(base, "/v1/chat/completions", body)
        if code != 500 or "non-finite logits" not in raw or again != first:
            raise AssertionError(f"numeric fault: {code} {raw[:300]}; next request "
                                 f"{again!r} against {first!r}")
        if obs_metrics.NUMERIC_FAULTS.value != faults_before + 1:
            raise AssertionError("numeric_faults did not count the poisoned request")
        print(f"--numeric-checks with engine.numeric=nan@1x1: the poisoned request 500 "
              f"({raw[:120]!r}), the next one answered the first one's {len(first)} chars")
    finally:
        api.stop(srv)

    def ms_token() -> float:
        stats = engine_mod.RunStats()
        shared.reset()
        for _, st in shared.generate_stream(ids, len(ids) + 64, temperature=0.0, chunk=16):
            if st.generation_ms > 0:
                stats.add(st)
        return stats.avg_generation_ms

    ms_token()  # the graphs were captured above; one more warm pass
    runs = {False: [], True: []}
    for on in (False, True, True, False, False, True):
        shared.numeric_checks = on
        runs[on].append(ms_token())
    off, on = (float(np.median(runs[k])) for k in (False, True))
    if on > off * (1 + NUMERIC_CHECKS_TOL):
        raise AssertionError(f"--numeric-checks costs {on:.3f} ms/token against {off:.3f}")
    print(f"graphs on, 64 greedy tokens, 3 runs each way in turns (medians): {off:.3f} "
          f"ms/token without the numeric guard, "
          f"{on:.3f} with ({(on / off - 1) * 100:+.2f} %, limit "
          f"{NUMERIC_CHECKS_TOL * 100:.0f} %): runs {runs}")
    del shared
    return dict(write_s=write_s, verified_s=verified_s, ms_off=off, ms_on=on)


def fleet_supervised(cli, pod_mod, obs_metrics, tok, m8: str, t: str) -> dict:
    """23b: ``serve-pod --supervise --dp 2 --device cuda:0 --handoff
    --checkpoint-interval 0.5`` at 7B width, CUT_LAYERS layers: two child
    processes behind the router.  (i) SIGTERM child 0 with 4 greedy streams
    on it: each finishes through the hand-off splice with the uninterrupted
    bytes, child 0 is respawned and readmitted.  (ii) SIGKILL child 1 with
    2 greedy and 1 sampled stream on it: the greedy ones resume on child 0
    with the uninterrupted bytes (tier 1 or 2, printed, with the resume's
    gap), the sampled one ends ``replica_lost``.  (iii) child 1 respawns
    with ``DLLAMA_FAULTS=engine.device_step=delay:30x1`` under
    ``--step-timeout 5``: its first request answers 500 (StepTimeout), the
    router ejects it, the supervisor counts a ``hung`` respawn."""
    import signal
    os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    args = cli.build_parser().parse_args(["serve-pod", "--model", m8, "--tokenizer", t,
                                          *SUPERVISED_ARGS])
    t0 = time.perf_counter()
    pod = pod_mod.start(args)
    try:
        sup, reg = pod.supervisor, pod.rstate.registry
        reps = sup.replicas
        addrs = [f"127.0.0.1:{r.port}" for r in reps]
        children = [f"http://{a}" for a in addrs]
        base = f"http://127.0.0.1:{pod.port}"
        up_s = _until(lambda: all(r.ready for r in reps)
                      and reg.snapshot()["available"] == 2, 300, "both children")
        print(f"supervised pod up in {time.perf_counter() - t0:.1f} s ({up_s:.1f} s to "
              f"ready after the spawn): children {addrs}, pids "
              f"{[r.proc.pid for r in reps]}")
        prompts = _equal_token_prompts(tok, 7, DRILL_PROMPT_TOKENS, 31)

        def body(i, n=384, temperature=0):
            return {"prompt": prompts[i], "max_tokens": n, "temperature": temperature}

        def respawns(idx):
            return {r: obs_metrics.POD_RESPAWNS.get(str(idx), r) for r in ("exit", "hung")}

        def respawned(idx, before):
            """A respawn of child ``idx`` since ``before`` (its ``respawns``),
            now ready and admitted."""
            return lambda: (respawns(idx) != before and reps[idx].ready
                            and not reg.backends[idx].ejected
                            and (reg.backends[idx].last_health or {}).get("status") == "ok")

        # (i) the hand-off: refs on child 0 (solo, which also caches the
        # prompts' pages there), then 4 streams on it, SIGTERM
        want = [_ask(children[0], "/v1/completions", body(i))[0] for i in range(4)]
        handoffs0 = obs_metrics.ROUTER_HANDOFFS.value
        exits0 = respawns(0)
        readmits0 = obs_metrics.ROUTER_READMITS.get(addrs[0])
        reg.retire(addrs[1])
        streams = [_Stream(base, "/v1/completions", body(i), f"handoff{i}") for i in range(4)]
        _until(lambda: all(s.times for s in streams), 60, "the 4 streams' first chunks")
        reg.backends[1].retiring = False
        pid0 = reps[0].proc.pid
        os.kill(pid0, signal.SIGTERM)
        for s in streams:
            s.join()
        texts = [s.text for s in streams]
        moved = obs_metrics.ROUTER_HANDOFFS.value - handoffs0
        if texts != want or moved < 1 or any(s.fins[-1:] not in (["length"], ["stop"])
                                             for s in streams):
            raise AssertionError(f"hand-off: {moved} hand-offs, finishes "
                                 f"{[s.fins for s in streams]}, texts equal "
                                 f"{[a == b for a, b in zip(texts, want)]}")
        back_s = _until(respawned(0, exits0), 300, "child 0's replacement")
        # a drained child exits on its own; if its teardown outlasts the
        # supervisor's hang probes first, it is killed and counted "hung"
        why = [r for r, n in respawns(0).items() if n > exits0[r]]
        print(f"(i) SIGTERM child 0 (pid {pid0}) with 4 greedy streams on it: router_handoffs "
              f"+{moved}, every stream finished with the uninterrupted bytes "
              f"({[len(x) for x in texts]} chars); child 0 respawned (pid "
              f"{reps[0].proc.pid}, counted {why}) and admitted {back_s:.1f} s later (readmits "
              f"+{obs_metrics.ROUTER_READMITS.get(addrs[0]) - readmits0})")
        # (ii) SIGKILL: refs on child 1 and on child 0 (the resume peer, so a
        # re-run also finds the prompts cached), then 2 greedy streams and a
        # sampled one on child 1
        want = [_ask(children[1], "/v1/completions", body(i, 1024))[0] for i in (4, 5)]
        again = [_ask(children[0], "/v1/completions", body(i, 1024))[0] for i in (4, 5)]
        if again != want:
            raise AssertionError("the two children answer a greedy request differently")
        resumes0 = {k: obs_metrics.ROUTER_RESUMES.get(k) for k in ("checkpoint", "rerun")}
        lost0 = obs_metrics.ROUTER_REPLICA_LOST.value
        exits1 = respawns(1)
        reg.retire(addrs[0])
        greedy = [_Stream(base, "/v1/completions", body(i, 1024), f"kill{i}") for i in (4, 5)]
        sampled = _Stream(base, "/v1/completions", body(6, 1024, 0.8), "kill-sampled")
        _until(lambda: all(s.times for s in greedy + [sampled]), 60, "the streams' chunks")
        time.sleep(0.8)  # a checkpoint of each greedy stream lands (every 0.5 s)
        reg.backends[0].retiring = False
        # child 1's replacement comes up armed for (iii)
        reps[1].env["DLLAMA_FAULTS"] = "engine.device_step=delay:30x1"
        pid1 = reps[1].proc.pid
        t_kill = time.perf_counter()
        os.kill(pid1, signal.SIGKILL)
        for s in greedy + [sampled]:
            s.join()
        tiers = {k: obs_metrics.ROUTER_RESUMES.get(k) - v for k, v in resumes0.items()}
        if [s.text for s in greedy] != want or sampled.fins[-1:] != ["replica_lost"] \
                or sum(tiers.values()) < 2:
            raise AssertionError(f"SIGKILL: resumes {tiers}, greedy equal "
                                 f"{[s.text == w for s, w in zip(greedy, want)]}, sampled "
                                 f"finishes {sampled.fins}")
        gap = max(s.max_gap_ms for s in greedy)
        print(f"(ii) SIGKILL child 1 (pid {pid1}) mid-stream: both greedy streams resumed on "
              f"child 0 with the uninterrupted bytes (tier 1 checkpoint {tiers['checkpoint']}, "
              f"tier 2 re-run {tiers['rerun']}; the resume gap {gap:.1f} ms at the client); "
              f"the sampled stream ended replica_lost (router_replica_lost "
              f"+{obs_metrics.ROUTER_REPLICA_LOST.value - lost0})")
        # (iii) the step watchdog on the armed replacement
        _until(respawned(1, exits1), 300, "child 1's replacement")
        hung0 = obs_metrics.POD_RESPAWNS.get("1", "hung")
        ejected0 = obs_metrics.ROUTER_EJECTIONS.get(addrs[1])
        t0 = time.perf_counter()
        code, _, raw = _request(children[1], "/v1/completions",
                                {"prompt": "hello", "max_tokens": 8, "temperature": 0})
        timeout_s = time.perf_counter() - t0
        reps[1].env.pop("DLLAMA_FAULTS")
        if code != 500 or "did not become ready" not in raw:
            raise AssertionError(f"the delayed step answered {code}: {raw[:300]}")
        out_s = _until(lambda: obs_metrics.ROUTER_EJECTIONS.get(addrs[1]) > ejected0
                       and obs_metrics.POD_RESPAWNS.get("1", "hung") > hung0, 60,
                       "the ejection and the hung respawn")
        print(f"(iii) child 1 under engine.device_step=delay:30x1 and --step-timeout 5: its "
              f"request answered 500 after {timeout_s:.1f} s ({raw[:100]!r}); ejected by the "
              f"router and respawned as hung {out_s:.1f} s later (pod_respawns{{replica=1,"
              f"reason=hung}} +1)")
        code, _, raw = _request(children[0], "/health")
        launches = json.loads(raw)["launches"] if code == 200 else None
        print(f"child 0's own launch counters (its process): {launches}")
        return dict(handoffs=moved, resume_tiers=tiers, resume_gap_ms=gap,
                    timeout_s=timeout_s)
    finally:
        pod.stop()


# 23d: the elastic pod (serve-pod --supervise --elastic --device cuda:0): dp 1
# at boot over a 4-ordinal budget (bookkeeping on cuda:0, every child on it),
# the policy acting on load only (a 3-sample window at 0.5 s, a 2 s cooldown,
# --scale-down-util -1, --reshape-kv-low -1 as tools/chaos_drill.py), the
# /admin commands the rest.  The tp = 1 children's steps are slowed by
# ELASTIC_DELAY (a fault point, each burst of up to 16 tokens) so a stream is
# still on a child when the controller retires it; the tp = 2 children,
# spawned after it is unset, run eagerly at speed (~53 ms a token)
ELASTIC_ARGS = ["--supervise", "--elastic", "--dp", "1", "--device", "cuda:0", "--handoff",
                "--checkpoint-interval", "0.5", "--pod-devices", "4", "--min-replicas", "1",
                "--max-replicas", "2", "--batch-slots", "8", "--kv-pages", "513",
                "--kv-page-size", "16", "--sched-prefill-chunk", "16", "--temperature", "0",
                "--max-pending", "64", "--host", "127.0.0.1", "--port", "0",
                "--probe-interval", "0.5", "--eject-after", "2", "--readmit-after", "1",
                "--elastic-interval", "0.5", "--elastic-window", "3", "--elastic-cooldown", "2",
                "--scale-down-util", "-1", "--reshape-kv-low", "-1"]
ELASTIC_DELAY = "engine.device_step=delay:0.15"
# tokens a stream: the load (8, no queue: a queue shrinks the bursts to one
# token), the scale-down (tp = 1 throughout), and the reshape's, whose tail
# runs on an eager tp = 2 child
LOAD_NEW, ELASTIC_NEW, RESHAPE_NEW = 384, 256, 160


class _PodWatch:
    """Samples an elastic pod on a thread: the router's ``/health``
    ``available`` every 0.25 s (tools/chaos_drill.py's AvailabilitySampler),
    the card's memory as nvidia-smi sees it and the children alive every
    0.5 s, and when each
    backend was first admitted (a healthy probe), with its server's uptime
    then (the rest of its boot is the interpreter, torch and the weights)."""

    def __init__(self, base: str, reg, sup):
        self.base, self.reg, self.sup = base, reg, sup
        self.avail: list[tuple[float, bool]] = []
        self.peak_mib = self.max_alive = 0
        self.admitted: dict[str, float] = {}
        self.uptime: dict[str, float] = {}
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._health, self._memory, self._admission)]
        for th in self._threads:
            th.start()

    def _health(self):
        while not self._stop.wait(0.25):
            try:
                ok = json.loads(_request(self.base, "/health")[2])["available"] >= 1
            except (OSError, ValueError, KeyError):
                ok = False
            self.avail.append((time.perf_counter(), ok))

    def _memory(self):
        while not self._stop.wait(0.5):
            self.max_alive = max(self.max_alive, sum(
                1 for r in self.sup.snapshot() if r.proc is not None and r.proc.poll() is None))
            try:
                out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                      "--format=csv,noheader,nounits", "-i", "0"],
                                     capture_output=True, text=True).stdout.strip()
            except OSError:
                return
            if out.isdigit():
                self.peak_mib = max(self.peak_mib, int(out))

    def _admission(self):
        while not self._stop.wait(0.05):
            for b in self.reg.eligible_backends():
                if b.addr not in self.admitted:
                    self.admitted[b.addr] = time.perf_counter()
                    self.uptime[b.addr] = (b.last_health or {}).get("uptime_s", float("nan"))

    def longest_gap(self, t0: float, t1: float) -> float:
        """The longest run of samples in [t0, t1] with no backend available."""
        out, start = 0.0, None
        for t, ok in self.avail:
            if t < t0 or t > t1:
                continue
            if not ok and start is None:
                start = t
            elif ok and start is not None:
                out, start = max(out, t - start), None
        if start is not None:
            out = max(out, t1 - start)
        return out

    def stop(self):
        self._stop.set()
        for th in self._threads:
            th.join(5)


def text_gap(engine, tok, prompt: str, want: str, got: str, label: str) -> str:
    """Where a stream's text ``got`` leaves the uninterrupted ``want``: the
    batch-1 engine (``engine()``) re-runs ``prompt`` greedily and gives
    the top-2 logit margin of the token that covers the first differing
    character, against max|logit|.  Raises unless it is a near tie
    (NEAR_TIE of max, phase 22's rule); '' when the texts are equal."""
    if got == want:
        return ""
    c = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), min(len(want), len(got)))
    eng = engine()
    ids = tok.encode(prompt, add_bos=True)
    eng.reset()
    logits, _ = eng.prefill(ids)
    text, prev = b"", ids[-1]
    while True:
        lg = np.asarray(logits[0], np.float64)
        nxt = int(lg.argmax())
        piece = tok.decode_piece(prev, nxt)
        if len((text + piece).decode("utf-8", "replace")) > c or len(text) > 4 * len(want):
            break
        text, prev = text + piece, nxt
        logits, _ = eng.decode_one(nxt)
    eng.reset()
    top = np.sort(lg)[::-1]
    rel = (top[0] - top[1]) / max(np.abs(lg).max(), 1e-30)
    msg = (f"{label}: leaves the uninterrupted text at character {c} ({want[c:c + 8]!r} / "
           f"{got[c:c + 8]!r}); the batch-1 engine's top-2 margin at the token there "
           f"{top[0] - top[1]:.4g} = {rel:.3g} of max|logit|")
    if text.decode("utf-8", "replace") != want[:len(text.decode('utf-8', 'replace'))] \
            or rel >= NEAR_TIE:
        raise AssertionError(msg + f" (limit {NEAR_TIE}; the engine's own text "
                                   f"{text.decode('utf-8', 'replace')[-40:]!r})")
    return msg + " (a near tie: recorded)"


def _ask_all(base: str, bodies: list[dict]) -> list[str]:
    """The texts of ``bodies`` sent together (greedy, prompts whose pages
    the child caches: every step they ride is a single-token one, so
    together they give the bytes each gives alone)."""
    out: list = [None] * len(bodies)

    def one(i):
        out[i] = _ask(base, "/v1/completions", bodies[i])[0]
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if any(o is None for o in out):
        raise AssertionError(f"{base}: a request failed")
    return out


def _healthy(port: int) -> bool:
    try:
        return _request(f"http://127.0.0.1:{port}", "/health")[0] == 200
    except OSError:
        return False


def _launch_block(port: int) -> dict:
    code, _, raw = _request(f"http://127.0.0.1:{port}", "/debug/launches")
    if code != 200:
        raise AssertionError(f"child :{port} /debug/launches answered {code}")
    return json.loads(raw)


def _check_child_launches(seen: dict) -> str:
    """Each child's counters (read before it was retired, killed or
    stopped; a respawn retired during its boot served nothing and has
    none): kernels 1-2, 7 and 8 launched, kernel 4 at tp = 2, 0 plain."""
    lines = []
    for (idx, pid), (tp, lb) in sorted(seen.items()):
        if lb is None:
            lines.append(f"child {idx} (pid {pid}) retired during its boot")
            continue
        q, a = lb["q40"], lb["paged_attention"]
        plain = (q["plain_calls"], q["allreduce_plain_calls"], a["plain_calls"],
                 a["prefill_plain_calls"])
        if not q["kernel_launches"] or not a["kernel_launches"] \
                or not a["prefill_launches"] or any(plain) \
                or (tp > 1) != bool(q["allreduce_launches"]):
            raise AssertionError(f"child {idx} (pid {pid}, tp={tp}): q40 {q}, attention {a}")
        lines.append(f"child {idx} tp={tp}: kernels 1-2 {q['kernel_launches']} (tensor-core "
                     f"{q['mma_launches']}), 7 {a['kernel_launches']}, 8 "
                     f"{a['prefill_launches']}, 4 {q['allreduce_launches']}, plain 0")
    return "; ".join(lines)


def fleet_elastic(cli, pod_mod, obs_metrics, tok, m8: str, t: str, card: str) -> dict:
    """23d: ``serve-pod --supervise --elastic --device cuda:0`` at 7B width,
    CUT_LAYERS layers, booting dp = 1 over ``--pod-devices 4``.  (i) Greedy
    streams fill the child's 8 slots: the policy scales up on load (a second
    child on ordinal 1, taking traffic only after its first healthy probe);
    the decision-to-admission seconds and the child's boot.  (ii) ``POST
    /admin/scale?n=1`` with 4 greedy streams on each child: every stream ends
    with the uninterrupted bytes (the victim's through the hand-off splice),
    the victim is not respawned, its ordinal returns to the pool,
    ``pod_scale_events`` read up/load and down/manual.  (iii) back to
    2×tp=1, then ``POST /admin/reshape?tp=2`` with greedy streams on the old
    children; as the first old child retires, the other is SIGKILLed (its
    streams resume on a peer; its respawn is retired too) and the retiring
    one 0.3 s into its drain (never respawned): the reshape converges to
    2×tp=2 (``fleet_status``, the registry and ``pod_replicas_desired``
    agree), each stream's text the uninterrupted tp = 1 text or a
    divergence at a printed near tie; then ``reshape?tp=1`` back.
    ``pod_reshape_seconds`` each way, the longest window in which the
    router had no backend, the card's peak memory.  (iv) every child's
    launch counters (``/debug/launches``): kernels 1-2, 7 and 8 in each,
    kernel 4 in each tp = 2 child, 0 plain calls.  Returns each child's ``(tp, launch block)`` by
    ``(idx, pid)``."""
    import signal
    os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    os.environ["DLLAMA_FAULTS"] = ELASTIC_DELAY
    args = cli.build_parser().parse_args(["serve-pod", "--model", m8, "--tokenizer", t,
                                          *ELASTIC_ARGS])
    t_start = time.perf_counter()
    pod = pod_mod.start(args)
    watch = None
    seen: dict = {}        # (idx, pid) -> (tp, launch block)
    spawned: dict = {}     # idx -> perf_counter of its spawn
    try:
        ctl, reg, sup = pod.rstate.elastic, pod.rstate.registry, pod.supervisor
        base = f"http://127.0.0.1:{pod.port}"
        watch = _PodWatch(base, reg, sup)
        ops = ctl.ops
        spawn0, retire0, kill_next, killed = ops.spawn, ops.retire, [], []

        def spawn(tp, ordinals):
            rep = spawn0(tp, ordinals)
            spawned[rep.idx] = time.perf_counter()
            return rep

        def retire(rep, *, grace):
            # the counters of the child's whole life (none for a respawn
            # still booting); then, at the reshape's first retire, the
            # chaos: every other old child SIGKILLed at once (not retiring:
            # its streams resume on a peer, the supervisor respawns it and
            # the reshape retires the replacement) and this one 0.3 s into
            # its drain (retiring: it only ends sooner)
            if rep.proc is not None and rep.proc.poll() is None:
                seen[(rep.idx, rep.proc.pid)] = (
                    rep.tp, _launch_block(rep.port) if _healthy(rep.port) else None)
            if kill_next and rep.tp == 1:
                kill_next.pop()
                for other in ops.live_replicas():
                    if other is rep or other.tp != 1 or other.retiring \
                            or other.proc is None or other.proc.poll() is not None:
                        continue
                    seen[(other.idx, other.proc.pid)] = (
                        other.tp, _launch_block(other.port) if _healthy(other.port) else None)
                    os.kill(other.proc.pid, signal.SIGKILL)
                    killed.append(other.idx)
                    print(f"SIGKILL of old child {other.idx} (pid {other.proc.pid}) as child "
                          f"{rep.idx} retires")
                threading.Timer(0.3, lambda p=rep.proc: p.poll() is None
                                and os.kill(p.pid, signal.SIGKILL)).start()
                killed.append(rep.idx)
                print(f"SIGKILL of child {rep.idx} (pid {rep.proc.pid}, retiring) 0.3 s into "
                      f"its drain")
            return retire0(rep, grace=grace)

        wait0, placing = ctl._wait_admitted, []

        def wait_admitted(addr):
            # the reshape's streams go out as its first tp = 2 child is
            # admitted, fenced until they are dispatched: they ride the old
            # children, which the controller retires next
            if placing:
                reg.retire(addr)
            ok = wait0(addr)
            if placing:
                placing.pop()()
                reg.get(addr).retiring = False
            return ok

        ops.spawn, ops.retire, ctl._wait_admitted = spawn, retire, wait_admitted
        spawned[0] = t_start
        addr0 = f"127.0.0.1:{sup.replicas[0].port}"
        _until(lambda: addr0 in watch.admitted, 300, "the first child")
        print(f"elastic pod up: child 0 admitted {watch.admitted[addr0] - t_start:.1f} s after "
              f"the start ({card})")

        def body(p, n):
            return {"prompt": p, "max_tokens": n, "temperature": 0}

        def events():
            return {k: obs_metrics.POD_SCALE_EVENTS.get(*k)
                    for k in (("up", "load"), ("up", "manual"), ("down", "manual"),
                              ("reshape", "manual"))}

        ev0 = events()
        # (i) scale up on load: 8 streams on 8 slots
        prompts = _equal_token_prompts(tok, 20, DRILL_PROMPT_TOKENS, 37)
        t_load = time.perf_counter()
        load = [_Stream(base, "/v1/completions", body(prompts[i], LOAD_NEW), f"load{i}")
                for i in range(8)]
        _until(lambda: len(ops.live_replicas()) == 2, 120, "the policy's scale-up")
        t_decide = max(spawned.values())
        (new,) = [r for r in ops.live_replicas() if r.idx != 0]
        addr1 = f"127.0.0.1:{new.port}"
        _until(lambda: addr1 in watch.admitted, 300, "the new child's admission")
        for s in load:
            s.join()
        up = obs_metrics.POD_SCALE_EVENTS.get("up", "load") - ev0[("up", "load")]
        boot = watch.admitted[addr1] - spawned[new.idx]
        if up != 1 or new.ordinals != [1]:
            raise AssertionError(f"scale-up on load: pod_scale_events up/load +{up}, the new "
                                 f"child's ordinals {new.ordinals}")
        print(f"(i) 8 greedy streams on child 0's 8 slots: the policy scaled up after "
              f"{t_decide - t_load:.1f} s of load (up/load +1); child {new.idx} on ordinal 1 "
              f"admitted {watch.admitted[addr1] - t_decide:.1f} s after the decision (boot "
              f"{boot:.1f} s spawn to first healthy probe, {boot - watch.uptime[addr1]:.1f} s of it "
              f"before its server existed: interpreter, torch, the card, the weights; {card})")
        # the manual phases: the policy stops acting on load
        ctl.policy.up_util, ctl.policy.up_queue = 2.0, 1e9

        # (ii) scale down with 4 greedy streams on each child
        children = {r.idx: f"http://127.0.0.1:{r.port}" for r in ops.live_replicas()}
        down_p = prompts[8:16]
        for u in children.values():   # cache the prompts' pages: each then feeds one token
            _ask_all(u, [body(p, 1) for p in down_p])
        want = _ask_all(children[0], [body(p, ELASTIC_NEW) for p in down_p])
        handoffs0 = obs_metrics.ROUTER_HANDOFFS.value
        streams = []
        for k, idx in enumerate(sorted(children)):
            other = [f"127.0.0.1:{r.port}" for r in ops.live_replicas() if r.idx != idx]
            for a in other:
                reg.retire(a)
            streams += [_Stream(base, "/v1/completions", body(down_p[4 * k + i], ELASTIC_NEW),
                                f"down{4 * k + i}") for i in range(4)]
            _until(lambda: all(s.times for s in streams), 60, "the streams' first chunks")
            for a in other:
                reg.get(a).retiring = False
        before = {r.idx: r for r in ops.live_replicas()}
        free0 = ctl.pool.free
        t0 = time.perf_counter()
        code, _, raw = _request(base, "/admin/scale?n=1", {})
        if code != 202:
            raise AssertionError(f"/admin/scale?n=1 answered {code}: {raw}")
        texts = [s.join().text for s in streams]
        _until(lambda: len(ops.live_replicas()) == 1 and ctl.fleet_status()["busy"] is None,
               120, "the scale-down")
        (victim,) = [r for i, r in before.items() if i not in {x.idx for x in ops.live_replicas()}]
        moved = obs_metrics.ROUTER_HANDOFFS.value - handoffs0
        ev = {k: v - ev0[k] for k, v in events().items()}
        if texts != want or moved < 1 or victim.proc.poll() is None or victim in sup.snapshot() \
                or ctl.pool.free != free0 + 1 or ev[("down", "manual")] != 1:
            raise AssertionError(f"scale-down: texts equal {[a == b for a, b in zip(texts, want)]}"
                                 f", hand-offs {moved}, victim {victim.idx} exit "
                                 f"{victim.proc.poll()}, pool free {ctl.pool.free}, events {ev}")
        print(f"(ii) POST /admin/scale?n=1 with 4 greedy streams on each child: child "
              f"{victim.idx} retired in {time.perf_counter() - t0:.1f} s, not respawned, ordinal "
              f"{victim.ordinals} back in the pool ({ctl.pool.free} free); router_handoffs "
              f"+{moved}; all 8 streams ended with the uninterrupted bytes; pod_scale_events "
              f"up/load +{ev[('up', 'load')]}, down/manual +{ev[('down', 'manual')]}")

        # (iii) back to 2 x tp=1, then the live reshape to tp = 2 under a SIGKILL
        _request(base, "/admin/scale?n=2", {})
        _until(lambda: len(reg.eligible_backends()) == 2 and ctl.fleet_status()["busy"] is None,
               300, "2 x tp=1 again")
        old = {r.idx: r for r in ops.live_replicas()}
        re_p = prompts[16:20]
        for r in old.values():
            _ask_all(f"http://127.0.0.1:{r.port}", [body(p, 1) for p in re_p])
        want = _ask_all(f"http://127.0.0.1:{next(iter(old.values())).port}",
                        [body(p, RESHAPE_NEW) for p in re_p])
        del os.environ["DLLAMA_FAULTS"]          # the tp = 2 children at speed
        resumes0 = {k: obs_metrics.ROUTER_RESUMES.get(k) for k in ("checkpoint", "rerun")}
        handoffs0 = obs_metrics.ROUTER_HANDOFFS.value
        respawns0 = {r.idx: obs_metrics.POD_RESPAWNS.get(str(r.idx), "exit") for r in old.values()}
        hist0 = obs_metrics.POD_RESHAPE_SECONDS.snapshot()[1]
        kill_next.append(True)
        streams = []

        def place():
            streams.extend(_Stream(base, "/v1/completions", body(p, RESHAPE_NEW), f"reshape{i}")
                           for i, p in enumerate(re_p))
            _until(lambda: all(s.times for s in streams), 60, "the reshape streams' chunks")
        placing.append(place)
        t0 = time.perf_counter()
        code, _, raw = _request(base, "/admin/reshape?tp=2", {})
        if code != 202 or json.loads(raw) != {"accepted": True, "target_tp": 2}:
            raise AssertionError(f"/admin/reshape?tp=2 answered {code}: {raw}")
        _until(lambda: len(streams) == len(re_p), 300, "the first tp=2 child's admission")

        def converged(tp):
            fs, snap = ctl.fleet_status(), reg.snapshot()
            return (fs["busy"] is None and fs["tp"] == tp and fs["n_replicas"] == 2
                    and all(r["tp"] == tp and not r["retiring"] for r in fs["replicas"])
                    and snap["total"] == 2 and snap["available"] == 2
                    and obs_metrics.POD_REPLICAS_DESIRED.value == 2)

        texts = [s.join().text for s in streams]
        _until(lambda: converged(2), 600, "the reshape to 2 x tp=2")
        wide_s = obs_metrics.POD_RESHAPE_SECONDS.snapshot()[1] - hist0
        t_wide = time.perf_counter()
        gap_wide = watch.longest_gap(t0, t_wide)
        loaded: list = []

        def engine():   # loaded on a divergence only
            if not loaded:
                loaded.append(cli.load_stack(cli.build_parser().parse_args(
                    ["inference", "--model", m8, "--tokenizer", t, "--device", args.device]))[0])
            return loaded[0]
        gaps = [g for g in (text_gap(engine, tok, p, w, x, f"reshape stream {i}")
                            for i, (p, w, x) in enumerate(zip(re_p, want, texts))) if g]
        loaded.clear()
        tiers = {k: obs_metrics.ROUTER_RESUMES.get(k) - v for k, v in resumes0.items()}
        moved = obs_metrics.ROUTER_HANDOFFS.value - handoffs0
        respawned = {i: obs_metrics.POD_RESPAWNS.get(str(i), "exit") - n
                     for i, n in respawns0.items()}
        # the retiring child killed mid-drain is never respawned; the other
        # (killed while serving) may be, and then the reshape retired it
        if moved + sum(tiers.values()) < 1 or len(killed) != 2 or respawned[killed[-1]] \
                or set(old) & {r.idx for r in ops.live_replicas()}:
            raise AssertionError(f"reshape: hand-offs {moved}, resumes {tiers}, killed "
                                 f"{killed}, respawns of the old children {respawned}")
        print(f"(iii) POST /admin/reshape?tp=2 with {len(streams)} greedy streams on the old "
              f"children: converged to 2 x tp=2 (fleet_status, registry, pod_replicas_desired "
              f"agree) in {t_wide - t0:.1f} s, pod_reshape_seconds {wide_s:.2f}; "
              f"router_handoffs +{moved}, resumes {tiers}; the child killed mid-drain "
              f"{killed[-1]} not respawned, the one killed serving {killed[0]} respawned "
              f"{respawned[killed[0]]} time(s) and retired; "
              f"the longest window with no backend {gap_wide:.2f} s; streams' bytes against the "
              f"uninterrupted tp = 1 run: {sum(a == b for a, b in zip(texts, want))}/"
              f"{len(texts)} equal ({[len(x) for x in texts]} chars)")
        for g in gaps:
            print(f"  {g}")
        wide = {r.idx: r for r in ops.live_replicas()}
        for i, r in enumerate(wide.values()):   # every tp = 2 child prefills and decodes
            _ask(f"http://127.0.0.1:{r.port}", "/v1/completions", body(prompts[i], 8))
        for r in wide.values():
            seen[(r.idx, r.proc.pid)] = (r.tp, _launch_block(r.port))
        hist0 = obs_metrics.POD_RESHAPE_SECONDS.snapshot()[1]
        t1 = time.perf_counter()
        code, _, raw = _request(base, "/admin/reshape?tp=1", {})
        if code != 202:
            raise AssertionError(f"/admin/reshape?tp=1 answered {code}: {raw}")
        _until(lambda: converged(1), 600, "the reshape back to 2 x tp=1")
        narrow_s = obs_metrics.POD_RESHAPE_SECONDS.snapshot()[1] - hist0
        gap_narrow = watch.longest_gap(t1, time.perf_counter())
        for i, r in enumerate(ops.live_replicas()):
            _ask(f"http://127.0.0.1:{r.port}", "/v1/completions", body(prompts[i], 8))
            seen[(r.idx, r.proc.pid)] = (r.tp, _launch_block(r.port))
        ev = {k: v - ev0[k] for k, v in events().items()}
        print(f"POST /admin/reshape?tp=1: back to 2 x tp=1 in {time.perf_counter() - t1:.1f} s, "
              f"pod_reshape_seconds {narrow_s:.2f}, the longest window with no backend "
              f"{gap_narrow:.2f} s; pod_scale_events {ev}")
        # (iv) the children's launches
        print(f"(iv) {len(seen)} children: {_check_child_launches(seen)}")
        total = time.perf_counter() - t_start
        print(f"23d: {total:.1f} s; peak card memory {watch.peak_mib} MiB (nvidia-smi; "
              f"{len(seen)} children in all, at most {watch.max_alive} alive at once, all on "
              f"cuda:0); {card}")
        return seen
    finally:
        os.environ.pop("DLLAMA_FAULTS", None)
        if watch is not None:
            watch.stop()
        pod.stop()


# phase 26: the mesh's sequence-, expert- and data-parallel axes, every rank
# on cuda:0 (the ranks run one after another: no speed result)
SP_PROMPT = 64     # 26a's first turn, in tokens (BOS included): the ring prefill
SP_TURN = 20       # its second turn: the continuation at pos > 0
SP_NEW = 32        # tokens each turn generates
AXES_TIMED = 8     # eager single-token forwards timed a case
AXES_DEVICE = "cuda:0"  # every rank's card
EP_PROMPT_TOKENS = 24
EP_NEW = 32


def _axes_counters(q40, q8, attention) -> dict:
    return {"q40": q40.counters(), "q8": q8.counters(), "attn": attention.counters()}


def axes_run(cli, q40, q8, attention, argv: list[str], label: str) -> dict:
    """One CLI command of phase 26 in-process, every counter 0 just before
    it and read just after: its engine, text (the lines that are not 💡 or
    ⚠️), counters, the peak device memory it added (above what the runs
    before it still hold) and seconds.  Raises on a plain call
    of any kernel (matmuls, kernel 4, kernels 7 and 8)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for mod in (q40, q8, attention):
        mod.reset_counters()
    t0 = time.perf_counter()
    eng, out = run_cli(cli, argv)
    secs = time.perf_counter() - t0
    c = _axes_counters(q40, q8, attention)
    plain = (c["q40"]["plain_calls"], c["q8"]["plain_calls"], c["q40"]["allreduce_plain_calls"],
             c["attn"]["plain_calls"], c["attn"]["prefill_plain_calls"])
    if any(plain):
        raise AssertionError(f"{label}: plain calls on the card {plain}: {c}")
    if not torch.isfinite(eng.last_logits).all():
        raise AssertionError(f"{label}: non-finite logits")
    text = [ln for ln in out.splitlines() if not ln.startswith(("💡", "⚠️"))]
    peak = torch.cuda.max_memory_allocated() - base
    print(f"{label}: {secs:.1f} s, peak device memory {peak / 2**30:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB held before; {out.splitlines()[-1]}")
    return dict(engine=eng, text=text, counts=c, peak=peak, s=secs,
                mesh=next(ln for ln in out.splitlines() if ln.startswith("💡 mesh")))


def forward_launches(eng, codec, q40, label: str) -> dict:
    """A single-token forward's launches (the matmul codec's by shape,
    kernel 4), 0 plain calls, then the eager ms of ``AXES_TIMED`` more."""
    codec.reset_counters()
    q40.reset_counters()
    eng.decode_one(5)
    torch.cuda.synchronize()
    c, a = codec.counters(), q40.counters()
    if c["plain_calls"] or a["allreduce_plain_calls"]:
        raise AssertionError(f"{label}: a single-token forward left a kernel: {c} {a}")
    t0 = time.perf_counter()
    for _ in range(AXES_TIMED):
        eng.decode_one(5)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / AXES_TIMED
    out = dict(kernel=c["kernel_launches"], mma=c["mma_launches"],
               allreduce=a["allreduce_launches"], plain=0,
               by_shape=dict(c["launches_by_shape"]), ms=ms)
    print(f"{label}: a single-token forward {out['kernel']} matmul launches "
          f"({out['mma']} tensor-core), {out['allreduce']} kernel-4 launches, 0 plain; "
          f"{ms:.2f} ms a token (eager, {eng.batch} row(s))")
    return out


def _tally(total: dict, c: dict) -> None:
    """Add a run's launches to phase 26's totals (the kernel line's
    ``mesh_axes``)."""
    for codec in ("q40", "q8"):
        for key, n in c[codec]["launches_by_shape"].items():
            total[codec][key] = total[codec].get(key, 0) + n
    total["allreduce"] += c["q40"]["allreduce_launches"]
    total["attn"] += c["attn"]["kernel_launches"]
    total["prefill"] += c["attn"]["prefill_launches"]


def _spy(module, name: str, calls: list):
    """Count calls of ``module.name`` (restored by the returned undo)."""
    real = getattr(module, name)
    setattr(module, name, lambda *a, **k: calls.append(name) or real(*a, **k))
    return lambda: setattr(module, name, real)


def _greedy_ids(eng, ids: list[int], new: int, eos: tuple) -> list[int]:
    """The generated ids of a greedy stream of ``ids`` from position 0 (the
    CLI's ``generate`` run again on its engine)."""
    eng.reset()
    return [tk for tk, _ in eng.generate_stream(ids, len(ids) + new, temperature=0.0,
                                                eos_ids=eos)][len(ids):]


def sp_path(cli, transformer, q40, q8, attention, tok, m: str, t: str, total: dict) -> dict:
    """26a: ``generate --sp 2 --device cuda:0`` at Llama-2-7B width,
    CUT_LAYERS layers: a SP_PROMPT-token prompt (the ring prefill, one
    ring a layer), then on the same engine a SP_TURN-token second turn (the
    window written over the shards at pos > 0, the one-round combine) and
    its SP_NEW tokens (the combine, kernel 4 once a layer); greedy bytes
    and tokens against the sp = 1 run of the same file (equal, or a
    divergence at a near tie, printed)."""
    L = CUT_LAYERS
    prompt = _equal_token_prompts(tok, 1, SP_PROMPT, seed=26)[0]
    ids = tok.encode(prompt, add_bos=True)
    turn = tok.encode(_equal_token_prompts(tok, 1, SP_TURN + 1, seed=27)[0], add_bos=True)[1:]
    eos = (tok.eos_id,)
    runs = {}
    for sp in (1, 2):
        calls: list = []
        undo = [_spy(transformer, n, calls) for n in ("ring_attention", "sp_gqa_attention")]
        try:
            r = axes_run(cli, q40, q8, attention,
                         ["generate", "--model", m, "--tokenizer", t, "--prompt", prompt,
                          "--steps", str(SP_PROMPT + SP_NEW), "--temperature", "0",
                          "--device", AXES_DEVICE, "--sp", str(sp)], f"26a sp={sp} generate")
            eng = r["engine"]
            rings, combines, fwd = calls.count("ring_attention"), len(calls), eng.forwards
            r["gen"] = _greedy_ids(eng, ids, SP_NEW, eos)  # the CLI's stream, as ids
            q40.reset_counters()
            p0 = eng.pos
            r["turn"] = [tk for tk, _ in eng.generate_stream(
                turn, len(turn) + SP_NEW, temperature=0.0, seed=None)][len(turn):]
            torch.cuda.synchronize()
            turn_ar = q40.counters()["allreduce_launches"]
            _tally(total, r["counts"])
        finally:
            for u in undo:
                u()
        if sp > 1:
            # the prompt: a ring a layer; every later forward: a combine a layer
            if eng.sp != 2 or rings != L or combines - rings != L * (fwd - 1):
                raise AssertionError(f"26a: {rings} rings and {combines - rings} combines "
                                     f"over {fwd} forwards, want {L} and {L * (fwd - 1)}")
            shards = [c.k.shape[3] for c in eng.cache.ranks]
            if shards != [LLAMA2_7B["seq_len"] // 2] * 2:
                raise AssertionError(f"26a: the shards' caches hold {shards} positions")
            if turn_ar != L * SP_NEW:
                raise AssertionError(f"26a: kernel 4 launched {turn_ar} times in the second "
                                     f"turn, want {L * SP_NEW} (a combine a layer a forward)")
            print(f"26a sp=2: the {SP_PROMPT}-token prompt took the ring ({rings} rings), "
                  f"{combines - rings} one-round combines after it over {fwd - 1} forwards; "
                  f"the second turn's window of {len(turn)} written over the shards at pos "
                  f"{p0}; kernel 4 {turn_ar} launches in that turn ({L} a forward)")
        r["fwd"] = forward_launches(eng, q40, q40, f"26a sp={sp}")
        runs[sp] = r
    one, two = runs[1], runs[2]
    if two["fwd"]["kernel"] != one["fwd"]["kernel"] or two["fwd"]["allreduce"] != L:
        raise AssertionError(f"26a: a decode forward's launches {two['fwd']} against sp=1's "
                             f"{one['fwd']} (want the same matmuls, {L} kernel-4 launches)")
    e1 = one["engine"]
    gaps = [first_gap(e1, ids, one["gen"], two["gen"], "26a first turn")]
    if two["gen"] == one["gen"]:
        gaps.append(first_gap(e1, ids + one["gen"] + turn, one["turn"], two["turn"],
                              "26a second turn"))
    if (two["text"] == one["text"]) != (two["gen"] == one["gen"]):
        raise AssertionError(f"26a: the CLI's texts and the repeated streams disagree: "
                             f"{one['text']!r} {two['text']!r}")
    for g in filter(None, gaps):
        print(g)
    print(f"26a sp=2 against sp=1 (7B width, {L} layers): greedy bytes "
          f"{'equal' if not any(gaps) else 'equal up to a near tie'} over both turns "
          f"({SP_NEW} + {SP_NEW} tokens); ms/token {two['fwd']['ms']:.2f} against "
          f"{one['fwd']['ms']:.2f} (eager, two ranks on one card in turn); peak device "
          f"memory {two['peak'] / 2**30:.2f} GiB against {one['peak'] / 2**30:.2f} GiB")
    out = {f"sp{sp}": {k: v for k, v in r.items() if k not in ("engine", "counts")}
           for sp, r in runs.items()}
    out["gaps"] = [g for g in gaps if g]
    del runs, one, two, e1
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _distinct_bytes(placed, keys) -> int:
    """The bytes of the distinct tensors the ranks of ``placed`` hold
    under ``keys`` (a tensor two ranks share counts once)."""
    seen = {}
    for p in placed.ranks:
        for k in keys:
            v = p[k]
            for a in ((v.qpacked, v.scales) if hasattr(v, "qpacked") else (v,)):
                seen[a.data_ptr()] = a.numel() * a.element_size()
    return sum(seen.values())


def ep_serving(api, attention, q40, tok, m: str, t: str, stack, label: str) -> dict:
    """26b's server: 8 greedy requests (phase 7's mix) released at once on
    8 slots: every answer 200, kernel 7 n_layers times a single-token slot forward,
    kernel 8 n_layers times a mixed one, 0 plain calls."""
    gc.collect()
    torch.cuda.empty_cache()
    server = api.start(["--model", m, "--tokenizer", t, *SERVE_ARGS,
                        "--max-seq-len", MIXTRAL_CTX], stack=(stack, tok))
    try:
        state = server.state
        eng, sched = state.batch_engine, state.scheduler
        base = f"http://127.0.0.1:{server.server_address[1]}"
        reqs = serving_requests(eng.batch, seed=26)
        attention.reset_counters()
        q40.reset_counters()
        f0, fwd0 = eng.slot_decode_forwards, eng.forwards
        bursts = [controlled_burst(sched, state, base, reqs, True)]
        ac, qc = attention.counters(), q40.counters()
        n_dec = eng.slot_decode_forwards - f0
        n_mix = eng.forwards - fwd0 - n_dec
        L = eng.cfg.n_layers
        if (n_dec == 0 or ac["kernel_launches"] != L * n_dec or n_mix == 0
                or ac["prefill_launches"] != L * n_mix or ac["plain_calls"]
                or ac["prefill_plain_calls"] or qc["plain_calls"]
                or qc["allreduce_plain_calls"]):
            raise AssertionError(f"{label}: attention {ac} over {n_dec} single-token and "
                                 f"{n_mix} mixed slot forwards; q40 {qc}")
        if (eng.ep > 1) != bool(qc["allreduce_launches"]):
            raise AssertionError(f"{label}: kernel 4 launches {qc['allreduce_launches']} at "
                                 f"ep={eng.ep}")
        print(f"{label}: 8 requests released at once, {bursts[0]['tok_s']:.2f} tok/s; "
              f"kernel 7 {ac['kernel_launches']} launches "
              f"over {n_dec} single-token slot forwards ({L} each), kernel 8 "
              f"{ac['prefill_launches']} over {n_mix} mixed ones ({L} each), kernel 4 "
              f"{qc['allreduce_launches']}, 0 plain")
        return dict(texts=[b["texts"] for b in bursts],
                    counts={"q40": qc, "q8": {"launches_by_shape": {}}, "attn": ac},
                    tok_s=[b["tok_s"] for b in bursts])
    finally:
        api.stop(server)
        del server
        gc.collect()
        torch.cuda.empty_cache()


def built_run(make, ids: list[int], new: int, eos: tuple, q40, q8, attention,
              label: str) -> dict:
    """A comparison run of phase 26 on an Engine built from params read
    before (``make()``), counters 0 just before it: its greedy ids,
    counters, the peak device memory it added and its seconds."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for mod in (q40, q8, attention):
        mod.reset_counters()
    t0 = time.perf_counter()
    eng = make()
    gen = _greedy_ids(eng, ids, new, eos)
    torch.cuda.synchronize()
    c = _axes_counters(q40, q8, attention)
    if c["q40"]["plain_calls"] or c["q8"]["plain_calls"] or c["q40"]["allreduce_plain_calls"]:
        raise AssertionError(f"{label}: plain calls on the card: {c}")
    out = dict(engine=eng, gen=gen, counts=c, peak=torch.cuda.max_memory_allocated() - base,
               s=time.perf_counter() - t0)
    print(f"{label}: {out['s']:.1f} s, peak device memory {out['peak'] / 2**30:.2f} GiB "
          f"above the {base / 2**30:.2f} GiB held before")
    return out


def _joined_experts(placed, sharding) -> dict:
    """The whole params of an ep mesh's tp = 1 engine: its expert shards
    joined on the card (the file's stacks, byte for byte), every other
    leaf the one the ranks share."""
    mesh = placed.mesh
    out = dict(placed.ranks[0])
    for key in sharding.EXPERT_KEYS:
        shards = [placed.ranks[mesh.local(mesh.rank(e=e))][key] for e in range(mesh.ep)]
        v = shards[0]
        out[key] = (type(v)(torch.cat([x.qpacked for x in shards], 1),
                            torch.cat([x.scales for x in shards], 1), v.logical_nd)
                    if hasattr(v, "qpacked") else torch.cat(shards, 1))
    return out


def ep_path(cli, api, sharding, engine_mod, mesh_mod, q40, q8, attention, tok, m: str,
            t: str, total: dict, label: str, codec, loaded=None) -> dict:
    """26b on the Mixtral-width file ``m``.  Without ``loaded``: ``generate
    --ep 2 --device cuda:0`` through the CLI, then on the same weights (its
    expert shards joined on the card) an ep = 1 engine and an ep = 2 x tp =
    2 one, and the 8-slot servers at ep = 1 and ep = 2.  With ``loaded``,
    ``(cfg, params)`` of ``m`` another phase read: engines at ep = 1 and ep
    = 2 on them.  ep = 2's greedy ids equal ep = 1's (the owner's product
    plus exact zeros is the owner's product); its single-token forward
    launches the matmul kernel exactly as often, at the same shapes, as ep
    = 1's (the shards share the attention; a non-owner launches nothing),
    with 3·k·L kernel-4 sums; its ranks hold the model's expert bytes once
    and share every other leaf; ep = 2 x tp = 2 equal or a divergence at a
    near tie; the ep = 2 server answers the ep = 1 server's text."""
    prompt = _equal_token_prompts(tok, 1, EP_PROMPT_TOKENS, seed=28)[0]
    ids, eos = tok.encode(prompt, add_bos=True), (tok.eos_id,)
    seq = int(MIXTRAL_CTX)

    def engine(params, cfg, **kw):
        return lambda: engine_mod.Engine(cfg, params, seq_len=seq, device=AXES_DEVICE, **kw)

    runs = {}
    if loaded is None:
        argv = ["generate", "--model", m, "--tokenizer", t, "--prompt", prompt,
                "--steps", str(EP_PROMPT_TOKENS + EP_NEW), "--temperature", "0",
                "--device", AXES_DEVICE, "--max-seq-len", MIXTRAL_CTX, "--ep", "2"]
        runs["ep2"] = axes_run(cli, q40, q8, attention, argv, f"26b {label} ep2 (CLI)")
        e2 = runs["ep2"]["engine"]
        runs["ep2"]["gen"] = _greedy_ids(e2, ids, EP_NEW, eos)  # the CLI's stream, as ids
        cfg, params = e2.cfg, _joined_experts(e2.params, sharding)
        runs["ep1"] = built_run(engine(params, cfg), ids, EP_NEW, eos, q40, q8, attention,
                                f"26b {label} ep1")
        runs["ep2tp2"] = built_run(engine(params, cfg,
                                          mesh=mesh_mod.make_mesh(2, AXES_DEVICE, ep=2)),
                                   ids, EP_NEW, eos, q40, q8, attention,
                                   f"26b {label} ep2 x tp2")
    else:
        cfg, params = loaded
        runs["ep1"] = built_run(engine(params, cfg), ids, EP_NEW, eos, q40, q8, attention,
                                f"26b {label} ep1")
        runs["ep2"] = built_run(engine(params, cfg,
                                       mesh=mesh_mod.make_mesh(1, AXES_DEVICE, ep=2)),
                                ids, EP_NEW, eos, q40, q8, attention, f"26b {label} ep2")
        e2 = runs["ep2"]["engine"]
    del params
    for name, r in runs.items():
        _tally(total, r["counts"])
        r["fwd"] = forward_launches(r["engine"], codec, q40, f"26b {label} {name}")
    e1 = runs["ep1"]["engine"]
    L, k = e1.cfg.n_layers, e1.cfg.n_active_experts
    if runs["ep2"]["gen"] != runs["ep1"]["gen"]:
        raise AssertionError(f"26b {label}: ep=2's greedy ids {runs['ep2']['gen']} != ep=1's "
                             f"{runs['ep1']['gen']}")
    f1, f2 = runs["ep1"]["fwd"], runs["ep2"]["fwd"]
    if f2["kernel"] != f1["kernel"] or f2["by_shape"] != f1["by_shape"] \
            or f2["allreduce"] != 3 * k * L:
        raise AssertionError(f"26b {label}: a decode forward at ep=2 {f2} against ep=1's "
                             f"{f1}: want the same launches by shape and {3 * k * L} "
                             f"kernel-4 sums")
    experts = _distinct_bytes(e2.params, sharding.EXPERT_KEYS)
    whole = sum(a.numel() * a.element_size() for key in sharding.EXPERT_KEYS
                for a in (e1.params[key].qpacked, e1.params[key].scales))
    if experts != whole or any(p[key] is not e2.params.ranks[0][key]
                               for p in e2.params.ranks for key in p
                               if key not in sharding.EXPERT_KEYS):
        raise AssertionError(f"26b {label}: the ep=2 ranks hold {experts} expert bytes "
                             f"against ep=1's {whole}, or a copy of a shared leaf")
    gap = ""
    if "ep2tp2" in runs:
        gap = first_gap(e1, ids, runs["ep1"]["gen"], runs["ep2tp2"]["gen"],
                        f"26b {label} ep=2 x tp=2")
        if gap:
            print(gap)
        runs["ep2tp2"].pop("engine")
        gc.collect()
        torch.cuda.empty_cache()
    tp2 = "ep2tp2" in runs
    print(f"26b {label}: ep=2 greedy bytes equal ep=1's ({EP_NEW} tokens); a decode forward "
          f"{f2['kernel']} matmul launches at ep=2 and at ep=1 ({f2['allreduce']} kernel-4 "
          f"sums at ep=2); ms/token ep=1 {f1['ms']:.2f}, ep=2 {f2['ms']:.2f}"
          + (f", ep=2 x tp=2 {runs['ep2tp2']['fwd']['ms']:.2f}" if tp2 else "")
          + f" (eager); peak device memory ep=1 {runs['ep1']['peak'] / 2**30:.2f}, ep=2 "
          f"{runs['ep2']['peak'] / 2**30:.2f}"
          + (f", ep=2 x tp=2 {runs['ep2tp2']['peak'] / 2**30:.2f}" if tp2 else "")
          + f" GiB (each above what the runs before it held); expert bytes "
          f"{experts / 2**30:.2f} GiB at both")
    out = {n: {key: v for key, v in r.items() if key not in ("engine", "counts")}
           for n, r in runs.items()}
    out["ep2tp2_gap"] = gap
    if loaded is None:
        served = {}
        for name, eng in (("ep1", e1), ("ep2", e2)):
            served[name] = ep_serving(api, attention, q40, tok, m, t, eng,
                                      f"26b {label} server {name}")
            _tally(total, served[name]["counts"])
        if served["ep2"]["texts"] != served["ep1"]["texts"]:
            raise AssertionError(f"26b {label}: the ep=2 server answered otherwise than ep=1's")
        print(f"26b {label}: the ep=2 server's greedy answers equal the ep=1 server's")
        out["served"] = {n: s_["tok_s"] for n, s_ in served.items()}
    del runs, e1, e2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_path(cli, q40, q8, attention, tok, m: str, t: str, total: dict) -> dict:
    """26c: ``batch`` of 4 distinct prompts at Llama-2-7B width, CUT_LAYERS
    layers, at dp = 1 and ``--dp 2`` (two rows a data group): each stream
    equal, or diverging only at a near tie (phase 22's rule on the dp = 1
    engine)."""
    prompts = batch_prompts(4, seed=29)
    pf = os.path.join(WORK, "dp_prompts.txt")
    with open(pf, "w") as f:
        f.write("\n".join(prompts) + "\n")
    argv = ["batch", "--model", m, "--tokenizer", t, "--prompts-file", pf, "--steps", "48",
            "--temperature", "0", "--device", AXES_DEVICE]
    runs = {}
    for dp in (1, 2):
        r = axes_run(cli, q40, q8, attention, argv + ["--dp", str(dp)], f"26c dp={dp} batch")
        _tally(total, r["counts"])
        if r["engine"].dp != dp or (dp > 1 and r["mesh"] != "💡 mesh: dp=2"):
            raise AssertionError(f"26c: {r['mesh']} at dp={dp}")
        r["streams"] = [ln for ln in r["text"] if not ln.startswith(("Generated", "Batched"))]
        r["fwd"] = forward_launches(r["engine"], q40, q40, f"26c dp={dp}")
        runs[dp] = r
    one, two = runs[1], runs[2]
    gaps = []
    if two["streams"] != one["streams"]:
        ids = [tok.encode(p, add_bos=True) for p in prompts]
        want = one["engine"].generate_batch(ids, 48)
        got = two["engine"].generate_batch(ids, 48)
        one["engine"].reset()
        solo = cli.Engine(one["engine"].cfg, one["engine"].params, device=one["engine"].device)
        for r_, (i, w, g) in enumerate(zip(ids, want, got)):
            gaps.append(first_gap(solo, i, w[len(i):], g[len(i):], f"26c stream {r_}"))
        del solo
        for g in gaps:
            if g:
                print(g)
    print(f"26c dp=2 against dp=1 (7B width, {CUT_LAYERS} layers, 4 prompts): streams "
          f"{'equal byte for byte' if not any(gaps) else 'equal up to near ties'}; a "
          f"single-token forward {two['fwd']['kernel']} matmul launches (two groups) against "
          f"{one['fwd']['kernel']}; ms/token {two['fwd']['ms']:.2f} against "
          f"{one['fwd']['ms']:.2f} (eager, 4 rows); peak device memory "
          f"{two['peak'] / 2**30:.2f} GiB against {one['peak'] / 2**30:.2f} GiB")
    out = {f"dp{dp}": {k: v for k, v in r.items() if k not in ("engine", "counts")}
           for dp, r in runs.items()}
    del runs, one, two
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pod_children(seen: dict) -> dict:
    """Phase 23d's children's launches, summed: the Q40 matmuls by shape
    for each tp, kernels 7, 8 and 4.  Each child's counters run from its
    boot (warm-up and graph capture included), in another process."""
    out = {"q40": {}, "attn": 0, "prefill": 0, "allreduce": 0}
    for tp, lb in seen.values():
        if lb is None:      # a respawn retired during its boot
            continue
        shapes = out["q40"].setdefault(tp, {})
        for *key, n in lb["q40"]["by_shape"]:
            shapes[tuple(key)] = shapes.get(tuple(key), 0) + n
        out["attn"] += lb["paged_attention"]["kernel_launches"]
        out["prefill"] += lb["paged_attention"]["prefill_launches"]
        out["allreduce"] += lb["q40"]["allreduce_launches"]
    return out


def kernel_entries(run, run_tp, run_mix, run_blocked, run_q8, run_score, served, table,
                   tp_table, mix_table, blocked_table, q8_table, attn, attn_g4, ar_table,
                   prefill, prefill_g4, var_table, var_runs, served_wide, attn_dh, attn_g16,
                   prefill_dh, pod, prefill_g16, ar_group, p25, axes) -> list:
    """The ``kernels`` JSON line's entries: each kernel at the shapes of the
    phase that checked it, with the launches of the main path that ran it;
    raises when a kernel of a path was never launched there.  The rows the
    elastic pod's children ran (23d) carry their launches apart, as
    ``pod_children``: ``pod_children(seen)``; the rows phase 26's paths ran
    (sp, ep, dp on one card) carry theirs as ``mesh_axes`` (``axes``: its
    launches by kernel and shape)."""
    def entries(name, src, sites, counts, mma_name=None, children=None, by_axes=None):
        # a tensor-core row's source is the body both codecs share
        def label(r):
            return mma_name if mma_name and r["key"][0] == "mma" else name
        return [dict(name=f"{label(r)}[{site}]" if t == 1 else f"{label(r)}[{site},t={t}]",
                     route="cuda",
                     source=WG_SRC if r["key"][0] in ("mma", "blocked-mma") else src,
                     replaces=r["replaces"],
                     launches=counts.get(r["key"], 0),
                     max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     library_ms=r["library_ms"],
                     **({} if children is None
                        else {"pod_children": children.get(r["key"], 0)}),
                     **({} if by_axes is None else {"mesh_axes": by_axes.get(r["key"], 0)}))
                for (site, t), r in sites.items()]

    # each kernel at the shapes of the path that ran it, with that path's
    # launches: Q40 on the 7B path (phase 3) and Mixtral's (phase 11; its
    # up/gate count holds both), kernel 3 on the blocked 7B path (phase
    # 14), Q80 on the Q80 7B path (phase 10), kernel 7 in the serving runs
    # (phases 7, 11b).  The 7B sites of Q40 (both layouts) and Q80 also at
    # t = 16 and 128: the tensor-core body, launched by the paths' prefills
    # (Q40: the 16-row bucket; Q80: t = 128).  wcls's tensor-core rows:
    # phase 20's requests launch it at SCORE_B x SCORE_T rows alone (their
    # one scoring forward); no path launches it at the other rows, which
    # phase 2 holds and times (launches 0)
    wide = {k: r for k, r in table.items() if k[0] == "wcls" and k[1] > 1}
    score_t = SCORE_B * SCORE_T
    tp1, tp2 = pod["q40"].get(1, {}), pod["q40"].get(2, {})
    kernels = entries("q40_matmul", SRC, {k: r for k, r in table.items() if k not in wide},
                      run["counts"]["launches_by_shape"], children=tp1, by_axes=axes["q40"])
    kernels += entries("q40_matmul", SRC, {k: r for k, r in wide.items() if k[1] == score_t},
                       run_score["counts"]["launches_by_shape"], children=tp1)
    held_only = entries("q40_matmul", SRC, {k: r for k, r in wide.items() if k[1] != score_t},
                        {})
    kernels += held_only
    # the fma, folded and exact bodies of kernels 1-2 (phase 2v) with the
    # launches of their paths (phase 3v, at CUT_LAYERS); wcls at 16 and 128 rows runs on no variant path (a
    # prompt's logits are its last row's)
    for v in VARIANTS:
        rows = {(s_, t_): r for (v_, s_, t_), r in var_table.items() if v_ == v}
        var_wide = {k: r for k, r in rows.items() if k[0] == "wcls" and k[1] > 1}
        kernels += entries(f"q40_matmul.{v}", SRC,
                           {k: r for k, r in rows.items() if k not in var_wide},
                           var_runs[v]["counts"]["launches_by_shape"])
        var_held = entries(f"q40_matmul.{v}", SRC, var_wide, {})
        held_only += var_held
        kernels += var_held
    kernels += entries("q40_matmul", SRC, tp_table, run_tp["counts"]["launches_by_shape"],
                       children=tp2)
    kernels += entries("q40_matmul", SRC, mix_table, run_mix["counts"]["launches_by_shape"],
                       by_axes=axes["q40"])
    kernels += entries("q40_matmul_blocked", SRC, blocked_table,
                       run_blocked["counts"]["launches_by_shape"])
    # Q80's wcls runs one row a sequence on the Q80 path (no scoring there)
    kernels += entries("q8_matmul", Q8_SRC,
                       {k: r for k, r in q8_table.items()
                        if k[0] in {s for s, *_ in LLAMA_SITES}
                        and not (k[0] == "wcls" and k[1] > 1)},
                       run_q8["counts"]["launches_by_shape"], mma_name="q8_matmul.wgmma",
                       by_axes=axes["q8"])
    # kernel 7's bodies no path runs (Mixtral's shape on an f16 pool, the
    # head dims and G no served model has) are held and timed in phase 6
    # alone: launches 0
    none = {"attn_launches": 0, "prefill_launches": 0}
    attn_rows = [(c, r, served[c]) for c, r in attn.items() if c != "f16"]
    attn_rows += [("bf16,G=4", attn_g4["bf16"], served["g4"]),
                  ("f16", attn["f16"], served_wide["f16"]),
                  ("f16,G=4", attn_g4["f16"], none)]
    attn_rows += [(f"{c},dh={dh}", r, served_wide["dh96"] if (c, dh) == ("bf16", 96) else none)
                  for (c, dh), r in attn_dh.items()]
    attn_rows += [(f"{c},G=16", r, none) for c, r in attn_g16.items()]
    attn_k = [dict(name=f"paged_attention[{label}]", route="cuda", source=ATTN_SRC,
                   replaces=ATTN_REPLACES, launches=run_["attn_launches"],
                   max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                   bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   library_ms=r["library_ms"],
                   **({"pod_children": pod["attn"]} if label == "bf16" else {}),
                   **({"mesh_axes": axes["attn"]} if label == "bf16,G=4" else {}))
              for label, r, run_ in attn_rows]
    held_only += [k for (_, _, run_), k in zip(attn_rows, attn_k) if run_ is none]
    kernels += attn_k
    # the prefill kernel (the port's own: no Pallas counterpart) at the
    # serving paths' width T = 16, with the mixed steps' launches of the
    # run on that pool (phases 7, 7b, 11b); the f32 pool at T = 16 and the
    # steps past 128 query rows a kv head (T = 256 at G = 1, 64 at G = 4)
    # with phase 6s's servers' launches
    pre_rows = [("bf16,t=16", prefill[("bf16", 16)], served["bf16"]),
                ("int8,t=16", prefill[("int8", 16)], served["int8"]),
                ("bf16,G=4,t=16", prefill_g4[("bf16", 16)], served["g4"]),
                ("f32,t=16", prefill[("f32", 16)], served_wide["f32"]),
                ("bf16,t=256", prefill[("bf16", 256)], served_wide["t256"]),
                ("bf16,G=4,t=64", prefill_g4[("bf16", 64)], served_wide["g4_t64"]),
                ("f16,t=16", prefill[("f16", 16)], served_wide["f16"]),
                ("f16,G=4,t=16", prefill_g4[("f16", 16)], none)]
    # the new head dims at the serving chunk (T = 16) and at two row groups;
    # phase 6s serves Dh 96 on a bf16 pool at T = 16
    pre_rows += [(f"{c},dh={dh},t={t}", r,
                  served_wide["dh96"] if (c, t, dh) == ("bf16", 16, 96) else none)
                 for (c, t, dh), r in prefill_dh.items()]
    # G = 16 (32 query heads on 2 kv heads) at T = 16: no served model has it
    pre_rows += [(f"{c},G=16,t={t}", r, none) for (c, t), r in prefill_g16.items()]
    pre_k = [dict(name=f"paged_prefill_attention[{label}]", route="cuda",
                  source=PREFILL_SRC, replaces=PREFILL_REPLACES,
                  launches=run_["prefill_launches"], max_abs_err=r["max_abs_err"],
                  ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                  bound_by=r["bound_by"], library_ms=r["library_ms"],
                  **({"pod_children": pod["prefill"]} if label == "bf16,t=16" else {}),
                  **({"mesh_axes": axes["prefill"]} if label == "bf16,G=4,t=16" else {}))
             for label, r, run_ in pre_rows]
    held_only += [k for (_, _, run_), k in zip(pre_rows, pre_k) if run_ is none]
    kernels += pre_k
    # kernel 4 on the tp = 2 7B path (phase 17), at its decode shape
    kernels.append(dict(name="tp_allreduce[tp=2,t=1,d=4096]", route="cuda", source=TP_SRC,
                        launches=run_tp["allreduce_launches"],
                        **{k: v for k, v in ar_table[(2, 4096, 1)].items()},
                        pod_children=pod["allreduce"], mesh_axes=axes["allreduce"]))
    # its cross-process body (phase 16b, one card in time slices) with the
    # launches of the worker path's processes (phase 25), each counted from
    # its start in its own process
    kernels.append(dict(name="tp_allreduce_ipc[tp=2,t=1,d=4096]", route="cuda",
                        source=TP_SRC, launches=p25["ipc_launches"],
                        **{k: v for k, v in ar_group[(2, 4096, 1)].items()
                           if k != "one_process_ms"}))
    idle = [k["name"] for k in kernels if k["launches"] == 0 and k not in held_only]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    return kernels


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="chip smoke of dllama_tpu_torch")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (bring-up; no result lines)")
    only = ap.parse_args().only
    run_phase = (lambda n: True) if only is None else \
        (lambda n: str(n) in only.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dllama_tpu_torch import cli, quants
    from dllama_tpu_torch.io import mfile, tfile
    from dllama_tpu_torch.models import config, params as params_mod, transformer
    from dllama_tpu_torch.ops import _build, attention, q8, q40
    from dllama_tpu_torch.parallel import mesh as mesh_mod, sharding
    from dllama_tpu_torch.io import integrity
    from dllama_tpu_torch.obs import metrics as obs_metrics
    from dllama_tpu_torch.router import pod as pod_mod
    from dllama_tpu_torch.runtime import engine as engine_mod, faults, snapshot as snapfmt
    from dllama_tpu_torch.server import api
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    dev = torch.device("cuda", 0)
    with phase("1 card and build"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[0]
        print(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
              "torch.backends.cudnn.allow_tf32 = False")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
              f"{torch.cuda.get_device_name(0)}")
        _build.load()
        print(_build.build_log.strip() or f"kernel library {_build.library_path()}")
    if run_phase(2):
        with phase("2 kernel vs plain at the 7B shapes"):
            body_report(q40)
            table = check_sites(q40, LLAMA_SITES, dev, seed=0, rows=Q40_CROSS_ROWS)
            table.update(check_sites(q40, LLAMA_SITES[-1:], dev, seed=4, rows=WCLS_WIDE,
                                     json_rows=WCLS_WIDE))
            check_sites(q40, RAGGED, dev, seed=3, rows=RAGGED_ROWS)
        with phase("2b kernel vs plain at a rank's 7B shapes at tp = 2 (unpadded)"):
            tp_table = check_sites(q40, TP2_SITES, dev, seed=2, pad=False, json_rows=(1,))
        with phase("2c the decode body as a decode token meets it, Q40 and Q80"):
            decode_sequence(q40, dev)
            decode_sequence(q8, dev)
    if run_phase(2) or run_phase("2v"):
        with phase("2v the fma, folded and exact bodies of kernels 1-2 vs plain at the "
                   "7B shapes, both bodies"):
            var_table = check_variants(q40, dev)
    if run_phase(13):
        with phase("13 kernel 3 (blocked planes) vs plain at the 7B shapes"):
            blocked_table = check_blocked(q40, dev)
    if run_phase(9):
        with phase("9 Q80 kernel vs plain at the 7B, Mixtral and Grok-1 shapes"):
            body_report(q8)
            q8_table = check_sites(q8, LLAMA_SITES + MIXTRAL_SITES + GROK_SITES, dev, seed=9,
                                   rows=Q8_CROSS_ROWS)
            check_sites(q8, TP2_SITES, dev, seed=11, pad=False, rows=Q8_CROSS_ROWS)
            check_sites(q8, RAGGED, dev, seed=12, rows=(9,) + RAGGED_ROWS)
        with phase("9b Q40 kernel vs plain at Mixtral's shapes, experts by device index"):
            mix_table = check_sites(q40, MIXTRAL_SITES, dev, seed=10, rows=MIX_ROWS,
                                    json_rows=(1,))
    if run_phase(6):
        with phase("6 paged attention kernel vs plain at the 7B shape"):
            build_report("paged_attention_split", "kernel 7")
            attn = check_paged_attention(attention, dev, codecs=("bf16", "int8", "f16"))
        with phase("6b paged attention kernel vs plain at Mixtral's shape (G = 4)"):
            attn_g4 = check_paged_attention(attention, dev, MIXTRAL_8X7B["n_kv_heads"],
                                            ("bf16", "f16"))
        with phase(f"6 paged attention kernel vs plain at head dims {ATTN_DH} and at G = 16"):
            attn_dh = {}
            for dh in ATTN_DH:
                codecs = ("bf16", "int8") + (("f32",) if dh == ATTN_DH_F32 else ())
                for c, r in check_paged_attention(attention, dev, codecs=codecs, dh=dh).items():
                    attn_dh[(c, dh)] = r
            attn_g16 = check_paged_attention(attention, dev, ATTN_G16_HKV, ("bf16", "int8"))
    if run_phase(6) or run_phase("6c"):
        with phase("6c prefill attention kernel (t > 1) vs plain at the 7B shape"):
            prefill_build_report()
            prefill = check_prefill_attention(attention, dev, LLAMA2_7B["n_kv_heads"],
                                              ("bf16", "int8", "f32", "f16"))
        with phase("6c prefill attention kernel (t > 1) vs plain at Mixtral's shape (G = 4)"):
            prefill_g4 = check_prefill_attention(attention, dev, MIXTRAL_8X7B["n_kv_heads"],
                                                 ("bf16", "int8", "f32", "f16"))
        with phase("6c prefill attention kernel (t > 1) vs plain at other page sizes"):
            check_prefill_pages(attention, dev)
        with phase(f"6c prefill attention kernel (t > 1) vs plain at head dims {ATTN_DH}"):
            prefill_dh = {}
            for dh in ATTN_DH:
                codecs = ("bf16", "int8") + (("f32",) if dh == ATTN_DH_F32 else ())
                widths = PREFILL_T_DH[dh > 128]
                for k, r in check_prefill_attention(attention, dev, LLAMA2_7B["n_kv_heads"],
                                                    codecs, dh=dh, widths=widths).items():
                    prefill_dh[(*k, dh)] = r
        with phase("6c prefill attention kernel (t > 1) vs plain at G = 16 (2 kv heads)"):
            prefill_g16 = check_prefill_attention(attention, dev, ATTN_G16_HKV,
                                                  ("bf16", "int8"), widths=(16,))
    if run_phase(16):
        with phase("16 kernel 4 (TP all-reduce) vs plain, every rank on cuda:0"):
            ar_table = check_allreduce(q40, dev)
    os.makedirs(WORK, exist_ok=True)
    if run_phase(16) or run_phase("16b"):
        with phase("16b kernel 4 across two processes on cuda:0 (CUDA IPC) vs plain"):
            ar_group = allreduce_across_processes()
    served, wide = {}, {}
    # phase 26's results and its launches (the kernel line's ``mesh_axes``)
    p26 = {"launches": {"q40": {}, "q8": {}, "allreduce": 0, "attn": 0, "prefill": 0}}
    try:
        m, t, m2, m3, t3, m8 = (os.path.join(WORK, f) for f in (
            "llama2-7b.m", "32k.t", "l2.m", "l2-chat.m", "32k-chat.t", "l8.m"))
        synth_tokenizer(t, tfile)
        # the Q40 7B-width file of every path but the 2-layer checks (the
        # main path, serving, the OpenAI surface and the fleet ran at 32
        # layers until the Q80 Hopper slice cut them for the script's time)
        per_fwd = 4 * CUT_LAYERS + 1
        if any(map(run_phase, (3, 7, 20, 23, "23d", 14, 17, 25, "3q", 21, 22, "6s", 26))):
            synth_model(m8, CUT_LAYERS, mfile, quants)
            print(f"synthesized {os.path.getsize(m8) / 1e9:.2f} GB (7B width, "
                  f"{CUT_LAYERS} layers)")
        shared8: dict = {}

        def stack8():
            """The 7B-width file's weights, read once for the servers of
            phases 7, 7b and 20, and once for 6s's (each server with caches
            of its own)."""
            if not shared8:
                shared8["s"] = cli.load_stack(api.parse_args(["--model", m8, "--tokenizer", t,
                                                              *SERVE_ARGS]))
            return shared8["s"]

        if any(map(run_phase, (4, 5, 8, 15, 18, "20b", "3v", 24))):
            synth_model(m2, 2, mfile, quants, fresh=True)
        if run_phase(3):
            with phase(f"3 main path: inference at Llama-2-7B width, {CUT_LAYERS} layers"):
                run, eng = main_path(cli, q40, m8, t, lambda e: per_fwd * e.forwards,
                                     keep=True)
                q40.reset_counters()
                eng.decode_one(5)
                one = q40.counters()
                if (one["kernel_launches"], one["mma_launches"], one["plain_calls"]) != (
                        per_fwd, 0, 0):
                    raise AssertionError(f"a single-token forward: {one}, want {per_fwd} "
                                         f"GEMV-body launches")
                print(f"one single-token forward: {per_fwd} Q40 launches, all on the GEMV "
                      f"body; the run's prompt forwards (16-row bucket): "
                      f"{run['counts']['mma_launches']} on the tensor-core body")
                greedy_repeat(eng)
                run.update(graph_costs(eng, "batch-1 engine"))
                del eng
                torch.cuda.empty_cache()
        if run_phase("3v"):
            var_runs = {}
            for v in ("exact", "folded", "fma"):
                with phase(f"3v the {v} path: DLLAMA_Q40_VARIANT={v} inference at Llama-2-7B "
                           f"width, 2 layers, in a child process; its kernels vs plain"):
                    var_runs[v] = variant_path(v, m2, t, 2, m2)
        if run_phase(17):
            with phase(f"17 tensor parallelism: inference --workers tpu:2 at Llama-2-7B "
                       f"width, {CUT_LAYERS} layers, both ranks on cuda:0"):
                run_tp = tp_main_path(cli, q40, engine_mod, params_mod, config, mfile,
                                      m8, t, dev, None, CUT_LAYERS)
        if run_phase(25):
            with phase(f"25 the worker path: two processes of one rank each (tp = 2) on "
                       f"cuda:0, inference, generate and batch at Llama-2-7B width, "
                       f"{CUT_LAYERS} layers"):
                p25 = worker_path(cli, m8, t, run_tp if run_phase(17) else None, CUT_LAYERS)
        if run_phase(4):
            with phase("4 requests: generate (7B width, 2 layers)"):
                requests(cli, q40, m2, t)
        if run_phase(24):
            with phase("24 a legacy-magic file with --weights-float-type, and --dequantize "
                       "(7B width, 2 layers)"):
                legacy_and_dense(cli, q40, mfile, m2, t)
        if any(map(run_phase, (5, 8, 15, "20b"))):
            # the 2-layer model is freed before phase 7's peak-memory reading
            small = load_bf16(mfile, params_mod, config, m2, dev)
            if run_phase(5):
                with phase("5 kernel path vs plain path end to end"):
                    end_to_end(transformer, *small, dev)
            if run_phase(8):
                with phase("8 slot path: kernels vs plain versions end to end"):
                    slot_end_to_end(engine_mod, transformer, attention, *small, dev)
                    contiguous_slot_graphs(engine_mod, *small, dev)
            if run_phase(15):
                with phase("15 blocked and lockstep batch vs plain and single streams"):
                    blocked_and_batch_end_to_end(q40, transformer, engine_mod, *small, dev)
            if run_phase("20b"):
                with phase("20b scoring and the int8 contiguous cache: kernels vs plain "
                           "(7B width, 2 layers)"):
                    score_end_to_end(transformer, engine_mod, q40, *small, dev)
            del small
            torch.cuda.empty_cache()
        if run_phase(15):
            with phase("15b chat (7B width, 2 layers, blocked), two turns"):
                # replies end on the chat EOS (its logit > 0) or on the stop
                # string's token (its logit, the negative of EOS's, > 0)
                tdata = synth_tokenizer(t3, tfile, chat_stop="<|im_start|>")
                stop_id = tdata.vocab.index(b"<|im_start|>")
                synth_model(m3, 2, mfile, quants, fresh=True,
                            boost_rows={tdata.chat_eos_id: 0xFF, stop_id: 0x11})
                with blocked_layout():
                    chat_path(cli, engine_mod, q40, m3, t3)
                os.remove(m3)
        if run_phase(18):
            with phase("18 serving at --workers tpu:2 (7B width, 2 layers), cuda:0"):
                served["tp2"] = serve_path(api, attention, q40, m2, t, 8,
                                           ["--workers", "tpu:2", "--device", "cuda:0"],
                                           False, tp=2, repeat=True)
        if run_phase(7):
            with phase(f"7 serving: API server, slot scheduler, paged KV at 7B width, "
                       f"{CUT_LAYERS} layers"):
                served["bf16"] = serve_path(api, attention, q40, m8, t, 16, [], True,
                                            repeat=True, stack=stack8())
            with phase("7b serving with --kv-quant int8"):
                served["int8"] = serve_path(api, attention, q40, m8, t, 8,
                                            ["--kv-quant", "int8"], True, stack=stack8())
        if run_phase(20):
            with phase(f"20 the OpenAI surface at Llama-2-7B width, {CUT_LAYERS} layers: list "
                       f"prompts, n, logprobs, echo, /metrics, /debug"):
                run_score = openai_surface(api, q40, m8, t, stack=stack8())
        # the later phases read their own peak memory: free the shared weights
        shared8.clear()
        gc.collect()
        torch.cuda.empty_cache()
        if run_phase("3q"):
            with phase(f"3q main path on the int8 contiguous cache: inference "
                       f"--kv-cache-dtype q8 at Llama-2-7B width, {CUT_LAYERS} layers"):
                per8 = 4 * CUT_LAYERS + 1
                run_q8kv, eng = main_path(cli, q40, m8, t, lambda e: per8 * e.forwards,
                                          ("--kv-cache-dtype", "q8"), keep=True)
                if not eng.cache.quantized:
                    raise AssertionError("inference --kv-cache-dtype q8 ran a dense cache")
                q40.reset_counters()
                eng.decode_one(5)
                one = q40.counters()
                if (one["kernel_launches"], one["plain_calls"]) != (per8, 0):
                    raise AssertionError(f"an int8-cache single-token forward: {one}")
                print(f"int8 contiguous cache ({CUT_LAYERS} layers): {run_q8kv['ms_token']} "
                      f"ms/token; {per8} Q40 launches a forward")
                del eng
                torch.cuda.empty_cache()
        if run_phase(21):
            with phase(f"21 state off the card and back: snapshots, hand-off, QoS, KV tier "
                       f"(Llama-2-7B width, {CUT_LAYERS} layers)"):
                p21 = state_movement(api, cli, attention, q40, snapfmt, m8, t, dev)
        if run_phase(22):
            with phase(f"22 speculative decoding and the roofline gauges at Llama-2-7B "
                       f"width, {CUT_LAYERS} layers"):
                p22 = spec_and_gauges(api, cli, attention, q40, tfile, m8, t)
        if run_phase(23):
            with phase(f"23a the fleet in one process: serve-pod --dp 2 --device cuda:0 at "
                       f"Llama-2-7B width, {CUT_LAYERS} layers"):
                pod, p23 = fleet_in_process(cli, pod_mod, obs_metrics, attention, q40, m8, t)
            try:
                with phase("23c checksum manifests, --verify-weights, the corrupt and NaN "
                           "drills, --numeric-checks (Llama-2-7B)"):
                    fleet_integrity(cli, api, engine_mod, obs_metrics, faults, integrity, pod,
                                    m8, t, run["load_s"] if run_phase(3) else None)
            finally:
                pod.stop()
                del pod
                gc.collect()
                torch.cuda.empty_cache()
            with phase(f"23b the supervised pod: two child processes on cuda:0 (7B width, "
                       f"{CUT_LAYERS} layers): hand-off, SIGKILL resume, step timeout"):
                fleet_supervised(cli, pod_mod, obs_metrics, Tokenizer(tfile.read_tfile(t)),
                                 m8, t)
        if run_phase(23) or run_phase("23d"):
            with phase(f"23d the elastic pod: serve-pod --supervise --elastic on cuda:0 (7B "
                       f"width, {CUT_LAYERS} layers): scale up on load, down with live "
                       f"streams, reshape to tp=2 under a SIGKILL and back"):
                p23d = fleet_elastic(cli, pod_mod, obs_metrics, Tokenizer(tfile.read_tfile(t)),
                                     m8, t, card)
        if run_phase(14):
            with blocked_layout():
                with phase(f"14 blocked main path: inference at Llama-2-7B width, "
                           f"{CUT_LAYERS} layers"):
                    run_blocked = main_path(cli, q40, m8, t,
                                            lambda e: (4 * CUT_LAYERS + 1) * e.forwards,
                                            key="blocked_launches")
                with phase(f"14b blocked lockstep batch: 8 prompts, twice (7B width, "
                           f"{CUT_LAYERS} layers)"):
                    batch_path(cli, q40, m8, t, tfile)
                with phase(f"14c blocked serving, --kv-quant int8 (7B width, {CUT_LAYERS} "
                           f"layers)"):
                    served["blocked"] = serve_path(api, attention, q40, m8, t, 8,
                                                   ["--kv-quant", "int8"], False,
                                                   blocked=True)
        if run_phase("6s"):
            with phase(f"6s serving on an f32 pool and at a 256-token chunk (7B width, "
                       f"{CUT_LAYERS} layers)"):
                wide["f32"] = wide_serving(api, engine_mod, attention, m8, t,
                                           ["--kv-cache-dtype", "f32", "--kv-pages", "257"],
                                           16, "f32 pool", stack=stack8())
                wide["t256"] = wide_serving(api, engine_mod, attention, m8, t,
                                            ["--sched-prefill-chunk", "256"], 256, "chunk 256",
                                            stack=stack8())
            # bf16 activations: at f16 ones the synthesized weights'
            # activations overflow f16's range (NaN logits on the kernel
            # and the plain engines alike)
            with phase(f"6s serving on an f16 pool (7B width, {CUT_LAYERS} layers)"):
                wide["f16"] = wide_serving(api, engine_mod, attention, m8, t,
                                           ["--kv-cache-dtype", "f16"], 16, "f16 pool",
                                           stack=stack8())
        shared8.clear()
        gc.collect()
        torch.cuda.empty_cache()
        if run_phase(26):
            tok32k = Tokenizer(tfile.read_tfile(t))
            with phase(f"26a sequence parallelism: generate --sp 2 at Llama-2-7B width, "
                       f"{CUT_LAYERS} layers, both ranks on cuda:0"):
                p26["sp"] = sp_path(cli, transformer, q40, q8, attention, tok32k, m8, t,
                                    p26["launches"])
            with phase(f"26c data parallelism: batch --dp 2 of 4 prompts at Llama-2-7B "
                       f"width, {CUT_LAYERS} layers, both ranks on cuda:0"):
                p26["dp"] = dp_path(cli, q40, q8, attention, tok32k, m8, t, p26["launches"])
        for f in (m, m2, m8, m8 + ".sum"):
            if os.path.exists(f):
                os.remove(f)
        if run_phase("6s"):
            with phase(f"6s serving at head dim 96 ({DH96['dim'] // DH96['n_heads']}: "
                       f"Phi-3-mini's widths, 2 layers)"):
                synth_model(m, 2, mfile, quants, fresh=True, dims=DH96)
                wide["dh96"] = wide_serving(api, engine_mod, attention, m, t, [], 16,
                                            "head dim 96")
                os.remove(m)
        if run_phase(10):
            with phase(f"10 Q80 Llama-2-7B width, {CUT_LAYERS} layers: inference"):
                synth_model(m, CUT_LAYERS, mfile, quants, ftype=quants.Q80)
                print(f"synthesized {os.path.getsize(m) / 1e9:.2f} GB (Q80, {CUT_LAYERS} "
                      f"layers)")
                # an 84-token prompt: its prefill runs at t = 128 (the padded
                # bucket) on the tensor-core body
                q8_fwd = 4 * CUT_LAYERS + 1
                run_q8, eng = main_path(cli, q8, m, t, lambda e: q8_fwd * e.forwards,
                                        ("--prompt", Q8_PROMPT), keep=True)
                if run_q8["counts"]["mma_launches"] < 4 * CUT_LAYERS:
                    raise AssertionError(f"the Q80 prompt forward did not take the "
                                         f"tensor-core body: {run_q8['counts']}")
                print(f"Q80 bodies: {run_q8['counts']['mma_launches']} tensor-core "
                      f"launches, {run_q8['counts']['kernel_launches'] - run_q8['counts']['mma_launches']} GEMV")
                run_q8.update(prompt_profile(eng, q8, Q8_PROMPT_TOKENS))
                greedy_repeat(eng)
                del eng
                torch.cuda.empty_cache()
                os.remove(m)
        mix = {**MIXTRAL_8X7B, "n_layers": MIXTRAL_LAYERS}
        if run_phase(11) or run_phase("6s") or run_phase(26):
            L, E, k = MIXTRAL_LAYERS, mix["n_experts"], mix["n_active_experts"]
            per_tok, per_prefill = (2 + 3 * k) * L + 1, (2 + 3 * E) * L + 1
            synth_model(m, L, mfile, quants, dims=mix)
            print(f"synthesized {os.path.getsize(m) / 1e9:.2f} GB (Mixtral-8x7B, Q40, "
                  f"{L} layers)")
        mix_stack = None  # phase 11's weights, which 11b and 6s serve (one read of the file)
        if run_phase(11):
            with phase(f"11 Mixtral-8x7B Q40 ({MIXTRAL_LAYERS} layers): inference"):
                # two prefills (warmup, then the timed run) take the
                # all-experts route; every other forward is a single token
                run_mix, eng = main_path(
                    cli, q40, m, t,
                    lambda e: per_tok * (e.forwards - 2) + 2 * per_prefill,
                    ("--max-seq-len", MIXTRAL_CTX), keep=True)
                moe_decode_checks(eng, transformer, q40, dev)
                mix_stack = (eng, Tokenizer(tfile.read_tfile(t)))
                del eng
            with phase(f"11b Mixtral-8x7B Q40 ({MIXTRAL_LAYERS} layers): serving"):
                served["g4"] = serve_path(api, attention, q40, m, t, 8,
                                          ["--max-seq-len", MIXTRAL_CTX], True, repeat=True,
                                          stack=mix_stack)
        if run_phase("6s"):
            with phase(f"6s serving Mixtral-8x7B ({MIXTRAL_LAYERS} layers) at a 64-token chunk "
                       f"(256 query rows a kv head)"):
                wide["g4_t64"] = wide_serving(api, engine_mod, attention, m, t,
                                              ["--max-seq-len", MIXTRAL_CTX,
                                               "--sched-prefill-chunk", "64"], 64,
                                              "Mixtral, chunk 64", stack=mix_stack)
        mix_stack = None
        gc.collect()
        torch.cuda.empty_cache()
        if run_phase(26):
            tok32k = Tokenizer(tfile.read_tfile(t))
            with phase(f"26b expert parallelism: generate --ep 2 (and x tp=2) and the "
                       f"8-slot server at --ep 2, Mixtral-8x7B Q40 ({MIXTRAL_LAYERS} layers), "
                       f"cuda:0"):
                p26["ep"] = ep_path(cli, api, sharding, engine_mod, mesh_mod, q40, q8,
                                    attention, tok32k, m, t, p26["launches"], "Q40", q40)
        if os.path.exists(m):
            os.remove(m)
        q80_ep = ("26b expert parallelism: ep = 2 against ep = 1, Mixtral-8x7B width in "
                  "Q80 (2 layers, phase 12's weights), cuda:0")
        if run_phase(26) and not run_phase(12):
            with phase(q80_ep):
                synth_model(m2, 2, mfile, quants, fresh=True,
                            dims={**mix, "seq_len": LLAMA2_7B["seq_len"]}, ftype=quants.Q80)
                p26["ep_q8"] = ep_path(cli, api, sharding, engine_mod, mesh_mod, q40, q8,
                                       attention, tok32k, m2, t, p26["launches"], "Q80", q8,
                                       loaded=load_bf16(mfile, params_mod, config, m2, dev))
                os.remove(m2)
        if run_phase(12):
            for name, ftype in (("Q40", quants.Q40), ("Q80", quants.Q80)):
                with phase(f"12 Mixtral width, 2 layers, {name}: kernels vs plain end to end"):
                    synth_model(m2, 2, mfile, quants, fresh=True,
                                dims={**mix, "seq_len": LLAMA2_7B["seq_len"]}, ftype=ftype)
                    label = f"Mixtral width, 2 layers, {name}"
                    small = load_bf16(mfile, params_mod, config, m2, dev)
                    layer_gaps(transformer, *small, dev, label)
                    end_to_end(transformer, *small, dev, label)
                    slot_end_to_end(engine_mod, transformer, attention, *small, dev, (None,),
                                    label)
                if name == "Q80" and run_phase(26):
                    # on phase 12's Q80 weights: no synthesis and no read of its own
                    with phase(q80_ep):
                        p26["ep_q8"] = ep_path(cli, api, sharding, engine_mod, mesh_mod, q40,
                                               q8, attention, Tokenizer(tfile.read_tfile(t)),
                                               m2, t, p26["launches"], "Q80", q8, loaded=small)
                del small
                torch.cuda.empty_cache()
                os.remove(m2)
        if run_phase(19):
            # both ranks on cuda:0; with two or more cards, rank r on card r too
            meshes = [("cuda:0", mesh_mod.make_mesh(2, dev))]
            if torch.cuda.device_count() >= 2:
                meshes.append(("cards 0 and 1", mesh_mod.make_mesh(2, "cuda")))
            for name, ftype, dims in (
                    ("Q80 Llama-2-7B width", quants.Q80, LLAMA2_7B),
                    ("Mixtral-8x7B width, Q40", quants.Q40,
                     {**mix, "seq_len": LLAMA2_7B["seq_len"]})):
                with phase(f"19 tp = 2, {name}, 2 layers: kernels vs plain end to end"):
                    synth_model(m2, 2, mfile, quants, fresh=True, dims=dims, ftype=ftype)
                    for where, tp_mesh in meshes:
                        tp_end_to_end(mfile, params_mod, config, transformer, engine_mod,
                                      q40, attention, sharding, m2, tp_mesh,
                                      f"tp=2 on {where}, {name}, 2 layers")
                    os.remove(m2)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    if only is not None:
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all (--only {only})")
        return 0

    # phase 21's launches join the rows of the sites it ran: the Q40 matmuls
    # of the 7B path, kernel 7 and the prefill kernel on bf16 and int8 pools
    by_shape = run["counts"]["launches_by_shape"]
    for key, n in p21["q40"]["launches_by_shape"].items():
        by_shape[key] = by_shape.get(key, 0) + n
    for pool in ("bf16", "int8"):
        served[pool]["attn_launches"] += p21["launches"][pool]
        served[pool]["prefill_launches"] += p21["launches"][f"{pool}_prefill"]
    # phase 22's too: the verify and PLD forwards' Q40 matmuls, kernel 7 on
    # the no-proposal rows' decode steps, the prefill kernel on every paged
    # verify forward (bf16 pool)
    for key, n in p22["launches_by_shape"].items():
        by_shape[key] = by_shape.get(key, 0) + n
    served["bf16"]["attn_launches"] += p22["launches"]["bf16"]
    served["bf16"]["prefill_launches"] += p22["launches"]["bf16_prefill"]
    # and phase 23a's: both replicas of the in-process pod (7B, bf16 pool)
    for key, n in p23["launches_by_shape"].items():
        by_shape[key] = by_shape.get(key, 0) + n
    served["bf16"]["attn_launches"] += p23["attn_launches"]
    served["bf16"]["prefill_launches"] += p23["prefill_launches"]
    # phase 23d's children are processes of their own, counted from their
    # boot: their launches stand beside the rows they ran, not in them
    kernels = kernel_entries(run, run_tp, run_mix, run_blocked, run_q8, run_score, served,
                             table, tp_table, mix_table, blocked_table, q8_table, attn,
                             attn_g4, ar_table, prefill, prefill_g4, var_table, var_runs,
                             wide, attn_dh, attn_g16, prefill_dh, pod_children(p23d),
                             prefill_g16, ar_group, p25, p26["launches"])
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
