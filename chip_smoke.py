#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build   — compile every CUDA source of ``repro_torch/kernels/csrc`` with
             nvcc for sm_90a (one nvcc per source, started together).
2. kernels — at the serving path's shapes (internlm2-1.8b: H=16, Hkv=8,
             D=128, bf16, 8 rows, ragged lengths up to 1024, bs=16) and one
             long row set up to 4096, hold each kernel against its plain
             PyTorch version and time kernel, plain version, one PyTorch
             library call, and the bound (bytes / 3.35 TB/s or operations /
             peak rate, the larger).  ``Timer`` takes the median of 30
             CUDA-event times, each after a 256 MB write that flushes the
             L2 and a 1 ms device sleep, so the host has issued the whole
             call before its start event fires.
             The split-K decode kernels print their split plan beside each
             timed row and are also held, untimed, where splitting is risky
             (DECODE_EDGE_CASES): lengths at chunk edges, at S, 1 and 0; a
             window that cuts a chunk and skips whole ones; G 1, 4, 8 at D
             64 and 80; float32 and bf16 at odd D (element loads); G 3; G 4
             and 5 at D 128 (minitron-8b's and qwen2.5-32b's decode, G 5
             with the one-position-shorter fault); G 7 at D 128
             (qwen2-vl-7b's); G 6 at D 128 (dbrx-132b's, with the
             same fault); whisper-tiny's cross-attention over 1500
             positions at and below the stripe; a plan of one split; the paged entry at bs 1 to 64, bf16 (or
             float32) and int8; zamba2-2.7b's shared-block shape (H = Hkv
             = 32, D 80, the main lengths, bs 16), also timed in bf16 and
             int8 against SDPA on the gathered view.  gemma3-4b's decode
             (GEMMA_ATTN: 8 rows, H 8, Hkv 4, D 256, lengths 1-2048) is
             timed without a window and in its 1024 window, contiguous
             and paged (bf16, int8), against SDPA on the masked stripe,
             and the D 256 instance is held untimed at chunk edges, G 1
             and 2, the window, float32, element loads (D 250), with the
             one-position-shorter fault shown to fail.  FRONTEND_ATTN is
             timed the same way: qwen2-vl-7b's decode (8 rows, H 28, Hkv
             4, D 128, lengths 257-1024; contiguous, paged bf16 and
             int8), whisper-tiny's self-attention (H = Hkv = 6, D 64; the
             three layouts) and its cross-attention (every length 1500,
             contiguous), dbrx-132b's decode (8 rows, H 48, Hkv 8, D
             128, lengths 33-576; the three layouts), each against SDPA.  Their limits
             (DECODE_EDGE_TOL) are tighter
             than the timed rows' 2e-2: float32 noise, and one bf16
             rounding step; the smoke shows they catch a row that lost one
             position.
             Greedy sampling (each row over a cluster of CTAs, 8 at every
             row count up to 16, so that a row's logprob rounds alike at
             every slot count up to 16)
             is held and timed at the served models' vocabularies (92544,
             65536, 32000, gemma3's 262144, minitron's 256000, qwen's
             152064, whisper's 51865, dbrx's 100352), 8 rows with ties
             planted
             across every edge of the cluster's slices, across the last
             edge alone, between an early column and the last, across the
             1024/2048 edges of a one-CTA-a-row kernel, and a row of equal
             entries (token 0); tokens equal to the plain version's and
             the planted ones, logprobs within 1e-4; untimed at one row,
             at 16 and at 24 (a cluster of 4) and at V 50001 (element loads, a
             short last slice); the plain version with the slice that holds
             a row's maximum dropped is shown to change its token; at 8 x
             92544 it is also timed with clusters of 8 and of 16.
             The rwkv6 scan kernel is held against its plain version at
             the rwkv6-7b prefill's widths (B 1, H 64, Dk = Dv = 64,
             r/k/v bf16): at S 512 and S 200 with the model's weak decays
             (w0 = -6, so the state carries across every chunk), at S 512
             with the JAX kernel test's decays and with strong ones (log_w
             down to -8 per step), at one float32 shape with odd Dk and Dv
             80, and at Dk 96, Dv 128; untimed at the edges of its
             chunk-parallel design (SCAN_EDGE_CASES: S 1, 15, 16, 17, 63,
             64, 65 and 129 in float32; B 2 at a ragged S; decays of -1 to
             -21 a step, cl near -700 inside a chunk and across its edges;
             float32 at the main shape with weak decays; Dk 33 in float32;
             Dv 128), y and state within 1e-3 in float32 (y 2e-2 in bf16);
             the plain scan with the state passing dropped is shown to miss
             the tolerance by a printed multiple.  Times of kernel and
             plain version, and the bound: the bytes, with the products
             counted at the tf32 rate as the kernel issues them (3xTF32)
             and the rest at the float32 rate (the count of the
             one-chunk-at-a-time algorithm at the float32 rate, the bound
             stated before, is printed beside it).  No single PyTorch call
             computes the recurrence, so it has no library time.
             The Mamba2 SSD scan kernel is held against its plain version
             (y and state within 1e-3 in float32, y within 2e-2 in bf16)
             at zamba2-2.7b's prefill widths (B 1, H 80, N = hd = 64, r/k
             bf16 broadcasts of one (B, S, 1, N) slice, v float32): at S 512
             and S 200 with the model's decays (-exp(A_log) softplus(dt)
             of a seeded dt), at S 512 with weak decays (about -1e-3, so
             the state carries across all eight chunks) and with the JAX
             kernel test's decays, at one all-float32 shape with a partial
             value block, and at N = hd = 128 with v bf16; untimed at the
             edges of its chunk-parallel design (MAMBA_EDGE_CASES: S 1,
             63, 64, 65, 129; B 2 at a ragged S; H 13, not a multiple of
             the head group; r/k per head; decays down to -21 a step, cl
             near -700 inside a chunk; float32 r/k per head; N 128 with v
             float32; float32 r/k at N = hd = 128).  The plain version with
             the state passing dropped (every chunk from zero) is shown to
             miss the tolerance by a printed multiple.  The bound counts the
             products at the bf16 rate as often as the kernel issues them
             (its float32 operands in exact bf16 parts) and the rest at the
             float32 rate; no library time.
             Top-k (values and mask) is held bit for bit against its plain
             version at the greedy kernel's shape (8 x 92544 float32) for
             k 1, 50, 64 and 1024, with rows tied at the top and at the
             k-th value and one whose k-th value is a zero of either sign
             (the values compared with -0.0 read as +0.0: the two are one
             value to ``torch.sort``, which fixes no order between them);
             untimed at TOPK_EDGE_CASES (V 65536, 32000 and 50001, k above
             one CTA's slice of the row, B 1 and 16, ties straddling the
             slice edges, a row of equal entries, a zero threshold, and V
             420000, whose slices are read from device memory in every
             pass); the plain version with one slice's candidates dropped
             is shown to fail the bit check; timed against ``torch.topk``.
             No entry point calls it (the JAX engine samples the whole
             vocabulary).
3. flash   — the flash-attention kernel against its plain version,
             output and log-sum-exp, untimed at the edge cases of
             FLASH_EDGE_CASES in bf16 and float32 (S 1, 63, 64, 65, 130;
             windows 5, 64, 100; G 1, 2, 4; every compiled D from 16 to
             128, and 256; the internlm2, minitron-8b and qwen2.5-32b
             prefills' S 512 at G 2, 4 and 5, dbrx-132b's at G 6 (also
             timed against SDPA); the long-S tiles
             from S 1024), bidirectional (``causal=False``) at S 1, 65,
             130, 300 (G 7), 1030 and whisper's encoder's S 1500 at D 64
             (FLASH_BIDIR_CASES), and on strided q, k, v views, the bf16 output held
             element by element to one bf16 rounding of each p and of the
             output (shown to see one key missing from P V); then at the
             training shape (16 rows, S 143, H 16, Hkv 8, D 128, bf16), at
             S 4096 (2 rows) and at zamba2's shared-attention shape (1 row,
             S 512, H = Hkv = 32, D 80) and at gemma3's prefill (1 row, S
             1900, H 8, Hkv 4, D 256, with and without its 1024 window;
             SDPA with the window's mask), qwen2-vl-7b's prefill (1 row,
             S 512, H 28, Hkv 4, D 128) and whisper-tiny's encoder (1 row,
             S 1500, H = Hkv = 6, D 64, bidirectional), with the gradients of
             ``FlashAttentionFn`` against autograd through the plain
             version; times of the kernel, the plain version,
             ``scaled_dot_product_attention`` and the bound, and of the
             kernel and SDPA at twice the rows (a time that barely grows
             says the kernel waits on its longest CTA, not on the card's
             rates).  The D 192 / Dv 128 instance (deepseek-v2's MLA
             prefill) at MLA_FLASH_EDGE (S 1, 65, 130, 300 with a window,
             1030; G 1 and 2) and at its prefill's (1 row, S 512, H = Hkv
             = 128) in bf16 and float32, a key missing from P V shown to
             fail the bf16 limit, the backward's refusal of Dv != D, and
             the kernel, plain and SDPA times (SDPA's first backend that
             takes Dv != D, named) beside the bound.
4. serve   — internlm2-1.8b at full width (24 layers, d_model 2048, vocab
             92544) in bf16 with seeded random weights: 16 requests with
             prompts of 32-512 token ids, 8 slots, 128 new tokens, through
             ``serve_continuous`` for contiguous, paged and paged-int8 KV.
             Kernel launch counts are zeroed before and read after each
             run; every decode kernel must have run layers x decode steps
             times, greedy sampling once per decode step, flash attention
             once per layer and prefill.  Each tick's decode block is one
             CUDA graph replay (the engine's first tick runs it eagerly);
             each run prints its ms per decode step, captures and their
             seconds.
   serve-static — ``serve_batch`` (the static entry point) on the same
             weights: 8 prompts x 32 new tokens in one batch, one prefill
             and 32 decode steps of every row, at temperature 0 (launches
             exact: flash 24, decode attention 24 x 32, greedy 32) and at
             the launcher's 0.8; tokens equal to ``generate``'s on the same
             encoded prompts and generator seed; tok/s beside the card.
   graph   — the CUDA graph against the engine's eager block
             (``eager_engine``), both on engines of the serve shape with
             the first GRAPH_REQ prompts at GRAPH_NEW new tokens: tokens
             and log-probabilities bit for bit at temperature 0 on
             contiguous, paged and paged-int8 KV, at temperature 1 (seed
             0) tokens; the same launch counts (a replay adds what its
             capture recorded); one capture.  Then ``reset(params=...)``
             to another seed's weights captures again and serves what a
             new engine on them serves.
   trace   — ``run_trace(realtime=True)`` over the 16 serve prompts at 128
             new tokens, contiguous, 8 slots, Poisson arrivals from
             ``RandomState(0)`` at half the closed-loop contiguous run's
             request rate: throughput, TTFT and latency (mean, p50, p95,
             p99), every request's stamps in order.
   elastic — ``serve_elastic``: the 16 serve prompts arriving ELASTIC_GAP
             apart through ``run_trace(realtime=False)`` with an
             ``ElasticController`` on the ladder ELASTIC_LADDER (paged
             bf16, starting on its first rung), against a static engine of
             8 slots: tokens bit for bit, no shed, at least one resize, the
             capacity log the resize log's, every engine warm with no
             capture before its first tick and one capture after it, the
             time per decode step within ELASTIC_TPT_GATE of the static
             engine's, device memory after the run within one pool of a
             single 8-slot engine's; each resize's host seconds (suspend,
             build, resume); ms per decode step by rung, each engine's
             first tick apart from its replays.  Then admission armed at
             the launcher's 2 s deadline with arrivals ELASTIC_CALM_GAP
             apart, which the ladder absorbs: no shed, no degrade, tokens
             bit for bit.  Then admission armed with a deadline of 0.6 x
             MAX_NEW static decode steps at ELASTIC_GAP: at least one
             degrade, each degraded request an exact prefix of the static
             run, every shed recorded.  Then a 2 + 6 router resized to
             3 + 8 mid-run, bit for bit with a 6-slot monolithic engine.
             Between the grow run and the armed runs, a second ladder,
             ELASTIC_LADDER_16 (4/8/16, arrivals ELASTIC_GAP_16 apart, so
             that it reaches 16 slots), and a static engine of 16 slots,
             each held to the static 8-slot engine: tokens and logprobs
             bit for bit (the decode step runs its products, norms and
             logits on 16 rows at every slot count up to 16, and greedy
             sampling one cluster size), the divergent requests and their
             top-2 gaps printed; ms per decode step by rung and of both
             static engines.
   suspend — the 16 serve prompts, 8 slots, 128 new tokens, on
             contiguous, paged and paged-int8 KV at block sizes 1 and 4:
             each request's stop token is the first token its
             uninterrupted run emits new at position 40 or later (at block
             size 4 even rids at a block's last step, odd rids inside a
             block); each handle waits HOLD_TICKS ticks, its pinned blocks
             are then held to their contents at suspension, and it is
             resumed with no tool tokens.  Tokens identical to the
             uninterrupted run; logprobs bit for bit where the boundary
             logits were carried (INT8_TOL on int8), within REPLAY_TOL
             where the boundary was replayed at batch 1; launches exact
             (the layout's decode kernel once a layer per forced token
             too); one decode capture per engine across every cycle;
             host ms of a suspend and a resume beside the tick's.  Paged:
             dropped handles keep conservation and leave the pool clean.
             A planted fault (one handle resumed with its index off by
             one) must fail the check.  float32 (weights upcast, 4
             requests, contiguous and paged): 16 tool tokens injected at
             resume, the log-softmax after them held to a prefill of
             history + tool within INJECT_TOL, argmax equal.
   agentic — ``run_episodes`` on a paged pool of 8 slots: 32 episodes of
             32-128 ids, ``CountdownToolEnv`` (each prompt's third greedy
             token a boundary, 2 tool calls of 16 tokens), 128 new tokens
             an episode, tool latency 16 ticks; the suspend, hold and ideal
             arms token-identical, suspend's ticks at most hold's; ticks,
             wall, tok/s and the reclaimed fraction (hold - suspend) /
             (hold - ideal); launches exact.
   carry   — ``reset(params2, carry_live=True)`` after 16 ticks of 8
             requests: tokens before the swap the old weights' run bit for
             bit, versions {0, 1} monotone per row, two runs identical,
             one capture after the reset; then ``run_streaming`` with a
             carry job (what ``run_training(mux="stream", carry=True)``
             runs), staleness 1, a weight sync after every group: tokens
             older than their iteration's newest weights.
   static  — ``generate`` (greedy) over 16 prompts of 128 ids x 128
             tokens against the engine's contiguous run: first tokens
             identical, on the agreeing prefix mean exp(diff) within 1e-2
             of 1 and max |diff| within REPLAY_TOL; exact launches; then
             two GRPO iterations with ``rollout="static"`` (rollout and
             train seconds).
   prefix  — radix prefix sharing, 8 paged slots, 128 new tokens:
             GRPO-shaped traffic (the first 4 serve prompts x GROUP 4) on
             bf16 and int8 pools against the same engine with sharing off,
             tokens and log-probabilities bit for bit, misses 4, hits 12,
             partial 0, 4 model prefills (flash layers x 4), the tree's
             blocks after the first tick re-read unchanged after the run;
             preamble-shaped traffic (a PREAMBLE-id preamble, distinct
             suffixes: 1 miss, 15 partial hits) bit for bit or, past a
             first divergence, within PARTIAL_TOL before it, and in
             float32 (4 requests) tokens identical within PARTIAL32_TOL;
             16 distinct prompts on a pool of two requests' need (nodes
             evicted, ``check(extra_pins=)`` after the run, a clean pool
             after ``reset``); a planted exact hit with its tail block
             left unseeded must leave the unshared run.  One decode
             capture an engine; launches exact; blocks_saved, wall, tok/s,
             mean TTFT and the host ms of a share-admit both ways.
   disagg  — a ``DisaggRouter`` of PD_PREFILL prefill and PD_DECODE
             decode slots on contiguous, paged and paged-int8 KV, sharing
             off (the 16 serve prompts) and on (GRPO-shaped), against a
             monolithic engine of PD_DECODE slots bit for bit: transfers,
             host ms per adoption, ``transfer_overhead_frac``, tok/s and
             mean TTFT both ways; the int8 run again through the JAX
             package's dequantized handle (reported); two prefill engines
             under ``kv_aware`` routing, the group leaders first: every
             member on its prefix's engine.  One decode capture per decode
             engine, every handle released, both pools clean after
             ``reset``.
   train-prefix — two GRPO iterations (batch 4 x group 4, temperature 1,
             engine rollout, paged) from the same initial weights with
             sharing on and off: losses, rewards and the trained weights'
             ``fingerprint`` bit for bit; model prefills per iteration
             (the task batch's distinct prompts against 16); rollout
             seconds both ways.
5. train   — two GRPO iterations at full width through ``run_training``
             (batch 4 x group 4, 128 new tokens, temperature 1, engine
             rollout, ``--mux off``): decode attention layers x decode
             steps times, flash attention layers x (prefills + 2) times per
             iteration (the forward and its recompute under remat), greedy
             sampling never (``rollout="engine"`` given: the default is
             the static batch); finite loss and gradient norm; the trainer's
             log-probabilities of the sampled tokens match the engine's
             (mean ratio within 1e-2 of 1); the weights move.
   roofline — the cost walk (``launch/cost.py``) of the same GRPO train
             step (16 rows x 143 positions, remat, AdamW), one decode step
             of 8 slots at position 512 with its greedy sampling, and one
             S 512 prefill, on meta tensors, each beside the same step on
             the card (the train step on a copy of the weights): the
             walk's FLOPs and bytes, the compute and memory terms at the
             H100's rates (``launch.roofline``), ``model_flops_for``, the
             step's CUDA-event seconds and ``mfu = model_flops / (s x
             989e12)``, with the train and serve phases' own seconds
             beside; the walk's kernel launches must equal the card's
             counters for each step (48 flash a train step: the forward
             and remat's recompute).
   sync    — weight sync and sharding on one card (``repro_torch.sync``,
             ``models.sharding``, ``launch.mesh``), after the train phase
             while its trained weights and the initial ones are both
             held: a one-rank NCCL (1, 1) ("data", "model") mesh;
             ``shard_params`` of the trained weights by the model's
             logical specs, every local tensor bit for bit, the graph
             phase's 4 requests served from the local views bit for bit
             with the weights' own (decode attention, greedy and flash
             launches exact); an engine on the initial weights, then the
             trained weights through ``flatten_params``,
             ``unflatten_params`` into a rollout tree and
             ``sync_params_between_jobs``, the engine reset with them bit
             for bit with the trained weights' run; flatten and unflatten
             timed by CUDA events against one read and one write of the
             model's bytes; the modelled sync of the model's bytes
             (``sync_collective_bytes`` at 2 x 8 and 2 x 16, hierarchical
             and flat; ``ClusterTopology``'s speedups: the paper's link
             model, not card times); the process group destroyed.  The
             hierarchical transfer needs a card on each side of the
             cluster boundary, so it runs only on the CPU tests' gloo
             worlds.
6. mux     — the phase-multiplexing executors at the train phase's full
             width and shape, each from a copy of its initial weights:
             ``run_sequential`` (2 iterations) as the reference;
             ``run_pipelined`` at staleness 0 (2 iterations), whose
             iteration 0 must give the reference's completions and
             behaviour log-probabilities bit for bit and its loss within
             1e-4 relative (iteration 1 is printed beside the
             reference's);
             at staleness 1 (3 iterations), every rollout's staleness in
             {0, 1}; the pinned host cache alone: a round trip of a
             2 GB tree (bf16 and float32, odd shapes, 0-d and empty
             leaves) bit for bit on one stream and across two (an offload
             issued at once after a restore queued on another stream must
             wait for it) and from a cache collected while the restore
             was still queued, one buffer for every offload of the key,
             its pinned bytes the tree's plus alignment, a new layout a
             new buffer, nothing pinned after ``evict``;
             ``run_coexec`` with jobs of seeds 0 and 1 (2
             iterations each; job0 from the sequential run's weights)
             through that cache: each pool's intervals disjoint and its
             jobs alternating, no cold start, every later offload of a key
             into its first pinned buffer, job0's iteration 0 (its
             rollout weights back through the cache) the sequential run's
             bit for bit; each copy's event time, bytes and GB/s per kind
             and pool, and the host memory available before and after;
             the port's planner on coexec's measured phase profiles, each
             phase's time less its restore's copy (``to_job``,
             ``simulate_profiles`` with the mean restore as the warm
             switch beside each job's measured seconds per
             iteration, ``InterGroupScheduler`` admitting both at SLO 2.0,
             its ``slo_contract`` and ``SLOPolicy.from_contract`` with the
             job's measured decode step), its keys the job ids and its
             times finite and positive (predicted against measured is
             printed, not gated); ``run_coexec`` again, 1 iteration a
             job, without ``runtime=`` (it builds its own and drops it,
             cache and all): each returned state, by :func:`fingerprint`,
             the job's last train phase's bit for bit, no cold start,
             job0's iteration 0 the sequential run's; ``run_streaming`` at
             staleness 1 with 2
             reward workers (2 iterations).  Every run's ratio
             diagnostics are finite and its launch counts, zeroed before
             and read after it, exact across its threads: decode attention
             layers x decode steps, flash attention layers x (prefills + 2
             per train step).  Prints each run's rollout and train busy
             time, overlap, back-to-back bubble and reclaimed fraction,
             ms per decode step and its engines' CUDA graph captures; for
             coexec the pinned bytes, each phase's runs and run time and
             the peak device memory; for stream the reward pool's timeline.
7. serve-rwkv6 — internlm2's weights freed, rwkv6-7b at full width (32
             layers, d_model 4096, 64 heads of 64, vocab 65536) in bf16 with
             seeded random weights: the same 16 prompt lengths, 8 slots, 128
             new tokens, contiguous, greedy.  The scan kernel must have run
             32 times per prefill, greedy sampling once per decode step, no
             attention kernel at all.  Prefill and decode are held to each
             other: for 4 requests, ``prompt + completion[:n]`` is prefilled
             again at n = 0, 31, 63, 127 and the log-probability of
             ``completion[n]`` compared with the engine's.  In bf16 the
             rounding of 32 recurrent layers moves these by up to ~0.3 (the
             plain scan in place of the kernel does the same), so the bf16
             mean of exp(diff) is held within 0.1 of 1 and the 1e-2 measure
             of the train phase is held on a float32 run of 4 requests with
             the same weights upcast.  The CUDA graph is held against the
             eager block as in the graph phase (temperature 0).  4
             requests x 32 tokens suspended and resumed at block size 1
             equal the uninterrupted run bit for bit; block size 4 with
             stop tokens is refused.
8. serve-zamba2 — rwkv6's weights freed, zamba2-2.7b at full width (54
             Mamba2 layers, d_model 2560, 80 SSD heads of 64, the shared
             attention block after every 6th layer, vocab 32000) in bf16
             with seeded random weights: the same 16 prompt lengths, 8
             slots, 128 new tokens, contiguous, greedy.  The SSD scan
             kernel must have run 54 times per prefill, flash attention 9
             times per prefill, greedy sampling once per decode step, no
             decode attention kernel.  Prefill and decode are held to each
             other as for rwkv6: bf16 within 0.1 (with the plain scan's
             numbers beside it), float32 (4 requests, weights upcast)
             within 1e-2; the CUDA graph against the eager block; suspend
             and resume at block size 1 as for rwkv6.
   serve-rwkv6-paged, serve-zamba2-paged — the same serve shape on paged
             KV (zamba2 bf16 and int8): launches exact (the scan once a
             layer per prefill; zamba2's flash and paged decode attention
             once a shared-block use per prefill and per decode step,
             greedy once a step), one capture.  rwkv6 bit for bit with
             its contiguous run (the same decode step; no block used).
             zamba2 against its contiguous run, which decodes the shared
             block with the plain ``gqa_decode_step``: first tokens and
             logprobs identical, mean exp(diff) of the logprobs before a
             request's first divergence within PAGED_BF16_TOL of 1, each
             divergent request reported with the top-2 logit gap there;
             float32 (4 requests) tokens identical and logprobs within
             PAGED32_TOL; the paged kernel on the run's pools against its
             plain version.  zamba2 also suspends and resumes 4 requests
             at block size 1 on paged KV, and serves through a 2 + 6
             router, bit for bit with a 6-slot monolithic paged engine.
   prefix-ssm-hybrid — GRPO-shaped traffic (4 serve prompts x GROUP) on
             paged zamba2 (bf16, int8) and rwkv6, sharing on against off:
             bit for bit, 4 model prefills against 16, misses 4, hits 12,
             rwkv6's blocks_saved 0 (its block is MAX_SEQ long: with no
             paged leaf the block size only keys the radix tree, and a
             prompt shorter than a block is a root snapshot).

9. serve-gemma3 — zamba2's weights freed, gemma3-4b at full width (34
             layers, 5 local layers windowed at 1024 : 1 global, D 256,
             vocab 262144, tied embeddings) in bf16: 16 prompts of 600-1900
             ids (``gemma_prompts``: at least 8 longer than the window and
             4 decoding across position 1024, counted and printed), 8
             slots, 128 new tokens, MAX_SEQ 2048, on contiguous, paged and
             paged-int8 KV: launches exact (the layout's decode kernel 34
             times a step, flash 34 a prefill, greedy once a step), ms per
             decode step against the weight-bytes bound, peak memory;
             paged against contiguous as zamba2's paged run; the graph
             against the eager block on every layout; GRPO-shaped traffic
             (4 prompts x group 4) with sharing on against off bit for bit
             (4 model prefills against 16); a 2 + 6 router bit for bit
             with a 6-slot monolithic engine; float32 (4 requests, the
             weights upcast) prefill against decode within DENSE32_TOL.
   ring-gemma3 — every layer windowed (``local_global_ratio=0``), 2 rows:
             960 ids prefilled into a ring cache (1024 slots) and a full
             cache of 1280, 256 teacher-forced decode steps (the ring wraps
             after 64): float32 logits within RING32_TOL of the full
             cache's, relative to the largest |logit|; in bf16 the largest
             difference and the greedy tokens that differ, with their top-2
             gaps (reported).
10. serve-minitron-8b, serve-qwen2.5-32b — at full width and depth (qwen's
             65.5 GB of weights last, after every other phase's tensors
             are freed): 8 requests of 32-512 ids, 4 slots, 64 new tokens,
             contiguous and paged, launches exact, paged against
             contiguous, ms per step against the bound, peak memory;
             minitron-8b also in float32 (its weights upcast, 8 requests
             on 4 slots, 128 new tokens) prefill against decode within
             DENSE32_TOL (qwen's float32 copy, 131 GB, does not fit).
             Before them, after gemma3:
   serve-qwen2-vl-7b — the vlm family at full width and depth (28 layers,
             d_model 3584, 28/4 heads of 128, QKV biases, M-RoPE, vocab
             152064; 7.62 B), seeded biases: VLM_REQ prompts of 264-512
             ids, each with its own seeded 256 vision embeddings over its
             first positions, 8 slots, 128 new tokens, on contiguous,
             paged and paged-int8 KV: launches exact (the layout's decode
             kernel 28 a step, flash 28 a prefill, greedy once a step), ms
             per decode step against the weight-bytes bound, peak memory;
             paged bf16 bit for bit with contiguous, int8 against it as
             zamba2's paged run; the graph against the eager block on
             every layout; radix sharing on: no hit, nothing registered,
             bit for bit with it off; one prompt under two frontends:
             other tokens; a 2 + 6 router bit for bit with a 6-slot
             monolithic engine; request 0 suspended after SUSPEND_AT
             ticks and resumed, bit for bit; float32 (4 requests, weights
             upcast) prefill against decode within DENSE32_TOL.
   serve-whisper-tiny — the audio family at full width and depth (4
             encoder and 4 decoder layers, d_model 384, 6 heads of 64,
             vocab 51865, tied embeddings; 39.4 M), seeded biases: the
             16 serve prompts, each with its own seeded 1500 frames,
             through the same checks (flash 8 a prefill: 4 encoder layers
             bidirectional, 4 decoder; a decode step runs the layout's
             kernel 4 times and the contiguous one 4 more, over each
             slot's cross K/V); then the kernel decode step of 8 slots at
             position 300 under ``torch.profiler``
             (``profile_step.profile_calls``): device events a step and
             device-busy ms beside the weight-bytes bound.
11. serve-dbrx-132b-cut — the MoE family on a cut of dbrx-132b: full
             width (d_model 6144, 48/8 heads of 128, 16 experts top 4 of
             10752, vocab 100352), 8 of its 40 layers (27.3 B, 54.6 GB in
             bf16), after every other phase's tensors are freed.  The 16
             serve prompts on 8 slots (an expert takes 4 of a decode
             step's 8 rows: decode drops), 64 new tokens, on contiguous,
             paged and paged-int8 KV: launches exact (the layout's decode
             kernel 8 a step, flash 8 a prefill, greedy once a step), ms
             per decode step against the weight-bytes bound, peak memory,
             the assignments each MoE layer dropped over the decode steps
             and over the prefills (the router's own ``keep``, counted on
             the device); paged bf16 bit for bit with contiguous, int8
             against it as zamba2's paged run; the graph against the
             eager block on every layout; then a 2-layer full-width copy
             in float32 (31.0 GB) at capacity_factor 4.0 = E/k, where
             nothing drops, prefill against decode within DENSE32_TOL.
12. serve-deepseek-v2-cut — deepseek-v2's MLA on a cut: full width
             (d_model 5120, 128 heads, MLA with kv_lora_rank 512, q_lora
             1536, rope 64; 160 experts top 6 of 1536 with 2 shared; vocab
             102400), 8 of its 60 layers (1 dense of 12288, 7 MoE; 29.19 B,
             58.4 GB in bf16), last.  The 16 serve prompts on 8 slots, 64
             new tokens, on contiguous, paged and paged-int8 KV: launches
             exact (flash's D 192 / Dv 128 instance 8 a prefill, greedy
             once a step, no decode kernel: the absorbed decode is plain
             PyTorch), ms per decode step against the weight-bytes bound,
             peak memory, the assignments each MoE layer dropped over the
             prefills, and none over the decode steps (the engine routes
             each slot alone, as the reference engine's batch=1 step);
             paged bf16 bit for bit with contiguous, int8 against it as
             zamba2's paged run; the graph against the eager block on
             every layout; 4 and 16 slots against 8 on contiguous
             (reported: bit for bit, or the largest logprob gap and the
             first divergent token); then a 2-layer copy in float32 (21.4
             GB) at capacity_factor 27.0, above E/k = 26.67, where nothing
             drops, prefill against decode within DENSE32_TOL.  Phase 3
             holds flash's D 192 / Dv 128 instance at this prefill's
             shape (and greedy at V 102400).
13. train-<arch> — training of every family, last: two GRPO iterations
             (``run_training``, engine rollout, 4 prompts x 4 samples, 32
             new tokens at temperature 1, remat on) of gemma3-4b and
             zamba2-2.7b at full width and of full-width cuts of
             qwen2-vl-7b (14 of 28 layers; then one step with 256 seeded
             vision embeddings a row), rwkv6-7b (16 of 32), dbrx-132b (1
             of 40) and deepseek-v2-236b (2 of 60: its dense layer and
             one MoE layer), and two ``make_train_step`` steps of
             whisper-tiny on 1500 seeded frames a row (no GRPO loop
             carries frames).  Each step's forward, backward and AdamW
             by CUDA events, peak memory, launches exact (a layer's
             prefill kernel once a prefill and twice a train step, the
             decode kernel once an attention layer a decode step on the
             GQA stacks), finite losses and gradient norms, ratio_mean
             within TRAIN_RATIO_TOL (printed for the MoE cuts), every
             TRAIN_WATCH leaf moved; then a 2-layer float32 copy at small
             widths with the model's head dims, its gradients on the card
             (kernels, remat) against the CPU's (plain, no remat) within
             1e-3 of each leaf's norm.  Phase 3 and the scan checks hold
             FlashAttentionFn at D 192 / Dv 128, Rwkv6ScanFn and
             Mamba2ScanFn (r/k broadcasts) against autograd through their
             plain versions in float32 and bf16, each with a planted fault
             (the backward's delta dropped; the state passing dropped)
             that must fail.

In the float32 runs of phases 7 to 12 the engine's tokens are also held to
the re-prefill's argmax (log-probability gap within the run's limit); in
bf16 the gap is reported.

Prints the card's name and power limit, a JSON line with every kernel's
numbers, and as its last line ``{"ok": true, "device": {...}}``.  Needs a
CUDA card; there is no CPU path.

    python3 chip_smoke.py --kernels-only [--src DIR]

builds, checks and times the kernels only (phases 1-3, no result line),
with ``--src`` the kernels of another checkout's ``src`` (an unpacked
parent commit) on this script's timer; it writes
``chiprun_out/kernels_{tree,parent}.json``.

    python3 chip_smoke.py --only serve-static,roofline
    python3 chip_smoke.py --only kernels,elastic,serve-qwen2-vl-7b
    python3 chip_smoke.py --only sync
    python3 chip_smoke.py --only serve-dbrx-132b-cut
    python3 chip_smoke.py --only kernels,serve-deepseek-v2-cut
    python3 chip_smoke.py --only train-gemma3-4b,train-whisper-tiny

runs the named phases alone (ONLY_PHASES; no result line) and writes
``chiprun_out/chip_smoke_only.json``; ``--only sync`` runs no train phase
and syncs seed 1's weights into an engine on seed 0's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the H100's rates and the kernels' work formulas: one copy, in the package
from repro_torch.kernels.work import (decode_attention_work,  # noqa: E402
                                      flash_attention_work,
                                      greedy_sample_work, mamba2_scan_work,
                                      rwkv6_scan_work, scan_ops, topk_work)
from repro_torch.launch.roofline import HBM_BPS, PEAK  # noqa: E402
ATTN_TOL = dict(atol=2e-2, rtol=2e-2)
ARCH, SLOTS, MAX_NEW, MAX_SEQ, N_REQ = "internlm2-1.8b", 8, 128, 1024, 16
RWKV_ARCH = "rwkv6-7b"
ZAMBA_ARCH = "zamba2-2.7b"
SCAN_CHUNK = 64
LAYOUT_ATTN = {"contiguous": "decode_attention",   # a KV layout's decode
               "paged": "paged_decode_attention"}  # kernel


def add_counts(total, counts):
    """Add the launch counts ``counts`` into ``total``, key by key."""
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def bound(n_bytes: float, n_ops, dtype: str = None):
    """The larger of the bytes' time and the operations' time, in ms.
    ``n_ops`` is a count at ``dtype``'s peak rate, or a ``{dtype: count}``
    of work whose parts run at different rates."""
    by_type = n_ops if isinstance(n_ops, dict) else {dtype: n_ops}
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = sum(n / PEAK[t] for t, n in by_type.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each.

    After the flush the device sleeps about 1 ms (``torch.cuda._sleep``)
    before the start event, so the host has issued the whole call while
    the device still sleeps: a wrapper's host work (a ctypes launch, its
    allocations) stays out of the interval unless it takes longer."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device=dev)          # 256 MB > 50 MB L2
        n = 10 ** 6           # the sleep's cycles per ms on this card
        torch.cuda._sleep(n)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(n)
        e.record()
        e.synchronize()
        self.cycles = int(n / s.elapsed_time(e))

    def __call__(self, fn, iters: int = 30) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))


# gemma3-4b's decode (8 rows, H 8, Hkv 4, D 256, bf16, MAX_SEQ 2048):
# lengths across its 1024 window, attended without a window (the global
# layers) and with it (the local ones)
GEMMA_ATTN = (np.asarray([1, 100, 600, 1023, 1024, 1025, 1500, 2048],
                         np.int32), 2048, 8, 4, 256)

# (label, lengths, S, H, Hkv, D, paged too): qwen2-vl-7b's decode (G 7,
# lengths past its 256 image positions), whisper-tiny's self-attention (H =
# Hkv = 6, D 64) and its cross-attention over the encoder's 1500 positions
# at every row (contiguous only: the cross leaves are per slot), and
# dbrx-132b's decode (H 48, Hkv 8: G 6, lengths of the serve prompts' 32-512
# ids and their 64 new tokens)
FRONTEND_ATTN = (
    ("qwen2-vl", [257, 300, 400, 512, 640, 777, 900, 1024], 1024, 28, 4, 128,
     True),
    ("whisper", [1, 17, 100, 255, 300, 400, 512, 640], 1024, 6, 6, 64, True),
    ("whisper-cross", [1500] * 8, 1500, 6, 6, 64, False),
    ("dbrx", [33, 100, 200, 255, 300, 400, 512, 576], 1024, 48, 8, 128,
     True))

# (label, ragged lengths, stripe length S): the serving shape, a long set
ATTN_CASES = (
    ("main", np.asarray([1, 17, 100, 255, 512, 640, 900, 1024], np.int32),
     1024),
    ("long", np.asarray([4096, 3000, 2048, 1500, 1024, 777, 300, 64],
                        np.int32), 4096))

# (label, lengths, S, H, Hkv, D, dtype, window, paged block sizes): the
# cases split-K makes risky, held against the plain versions untimed.
# Chunk edges (C - 1, C, C + 1 for C 128, and S), a row of length 1 and one
# of 0; a window that cuts through a chunk and skips whole ones; G 1, 4, 8
# at D 64 and 80; float32 and bf16 at odd D (the element-load path); a plan
# of one split (S 128); minitron-8b's G 4 and qwen2.5-32b's G 5 at D 128;
# the paged entry at bs 1 and 64, bf16 and int8 in every case.
EDGES = [0, 1, 127, 128, 129, 1024, 257, 640]
DECODE_EDGE_CASES = (
    ("edges", EDGES, 1024, 16, 8, 128, "bfloat16", None, (1, 16, 64)),
    ("one-split", [0, 1, 127, 128], 128, 16, 8, 128, "bfloat16", 100,
     (1, 16)),
    ("window", [1024, 1000, 700, 300, 129, 128, 60, 1], 1024, 16, 8, 128,
     "bfloat16", 200, (16,)),
    ("window-long", [4096, 2000, 1023], 4096, 16, 8, 128, "bfloat16", 700,
     (64,)),
    ("G1-D64", EDGES, 1024, 8, 8, 64, "bfloat16", None, (16,)),
    ("G4-D64", EDGES, 1024, 16, 4, 64, "bfloat16", None, (16,)),
    ("G8-D64", EDGES, 1024, 16, 2, 64, "bfloat16", None, (16,)),
    ("G1-D80", EDGES, 1024, 8, 8, 80, "bfloat16", None, (16,)),
    ("G4-D80", EDGES, 1024, 16, 4, 80, "bfloat16", None, (16,)),
    ("G8-D80", EDGES, 1024, 16, 2, 80, "bfloat16", None, (16,)),
    ("f32-D33", [1, 5, 128, 129, 300], 300, 6, 2, 33, "float32", None,
     (1, 16)),
    ("f32-D128", [1, 130, 255, 256], 256, 6, 3, 128, "float32", 100, (16,)),
    ("bf16-D35", [2, 128, 129, 200], 200, 6, 3, 35, "bfloat16", None,
     (8,)),
    ("G3-D128", [64, 384, 385], 512, 9, 3, 128, "bfloat16", None, (32,)),
    # the dense serve phases' own shapes: minitron-8b (H 32, Hkv 8: G 4)
    # and qwen2.5-32b (H 40, Hkv 8: G 5) at D 128
    ("G4-D128", EDGES, 1024, 32, 8, 128, "bfloat16", None, (16,)),
    ("G5-D128", [0, 1, 127, 128, 129, 257, 511, 512], 512, 40, 8, 128,
     "bfloat16", None, (16,)),
    ("zamba2", [1, 17, 100, 255, 512, 640, 900, 1024], 1024, 32, 32, 80,
     "bfloat16", None, (16,)),
    # qwen2-vl-7b's G 7 at D 128, and whisper-tiny's cross-attention (G 1,
    # D 64) over its 1500 encoder positions at and just below the stripe
    ("G7-D128", EDGES, 1024, 28, 4, 128, "bfloat16", None, (16,)),
    # dbrx-132b's G 6 at D 128 (H 48, Hkv 8)
    ("G6-D128", EDGES, 1024, 48, 8, 128, "bfloat16", None, (16,)),
    ("cross-S1500", [1500, 1500, 1499, 1280, 1281, 1], 1500, 6, 6, 64,
     "bfloat16", None, ()),
    # the head-dim-256 instance (gemma3-4b: H 8, Hkv 4): chunk edges and
    # S, G 1 and 2, gemma3's 1024 window cutting chunks and skipping whole
    # ones, float32, element loads at D 250
    ("G2-D256", EDGES + [2047, 2048], 2048, 8, 4, 256, "bfloat16", None,
     (1, 16, 64)),
    ("G1-D256", EDGES, 1024, 4, 4, 256, "bfloat16", None, (16,)),
    ("window-D256", [2048, 2000, 1500, 1100, 1025, 1024, 600, 1], 2048, 8,
     4, 256, "bfloat16", 1024, (16,)),
    ("f32-D256", [1, 130, 255, 256, 0], 256, 4, 2, 256, "float32", 100,
     (1, 16)),
    ("bf16-D250", [2, 128, 129, 200], 200, 4, 2, 250, "bfloat16", None,
     (8,)))
# Their limits, by the dtype of q and the output: float32 noise of the
# summation order, and in bf16 one rounding step of the output (2^-7 of
# it) above that.  Tight enough that dropping one position, the error a
# chunk-edge slip makes, fails them even on a row of 1024 (checked on the
# "edges" case against the plain version with each row one shorter).
DECODE_EDGE_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
                   "bfloat16": dict(atol=1e-3, rtol=2 ** -7)}


def paged_tables(rs, lengths_np, S, bs):
    """Shuffled block tables (B, MB = ceil(S / bs)) with null-block (0)
    tails over a pool of B * MB + 1 blocks; returns (tables, NB)."""
    B, MB = len(lengths_np), -(-S // bs)
    NB = B * MB + 1
    ids = rs.permutation(np.arange(1, NB))
    tables = np.zeros((B, MB), np.int32)
    nxt = 0
    for b, n in enumerate(lengths_np):
        nb = -(-int(n) // bs)
        tables[b, :nb] = ids[nxt:nxt + nb]
        nxt += nb
    return tables, NB


def decode_edge_cases(torch, dev) -> dict:
    """Every DECODE_EDGE_CASES case through both kernels (contiguous; paged
    bf16 or float32, and int8, at each block size) against their plain
    versions; returns the largest error of each wrapper."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.kvcache import quantize_kv

    g = torch.Generator(device=dev).manual_seed(7)
    rs = np.random.RandomState(7)
    errs = {"decode_attention": 0.0, "paged_decode_attention": 0.0}
    for label, lens, S, H, Hkv, D, dtype, window, sizes in DECODE_EDGE_CASES:
        tol = DECODE_EDGE_TOL[dtype]
        kw = dict(dtype=getattr(torch, dtype), device=dev)
        lengths_np = np.asarray(lens, np.int32)
        B = len(lengths_np)
        lengths = torch.from_numpy(lengths_np).to(dev)
        q = torch.randn(B, H, D, generator=g, device=dev).to(kw["dtype"])
        k, v = (torch.randn(B, S, Hkv, D, generator=g, device=dev).to(
            kw["dtype"]) for _ in range(2))
        out = da.decode_attention(q, k, v, lengths, window=window)
        ref = da.decode_attention_plain(q, k, v, lengths, window=window)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"decode_attention {label}: non-finite")
        e = check_close(torch, f"decode_attention {label}", out, ref, tol)
        errs["decode_attention"] = max(errs["decode_attention"], e)
        msg = [f"contiguous {e:.2e}"]
        if label in ("edges", "zamba2", "G5-D128", "G2-D256", "G7-D128",
                     "G6-D128", "cross-S1500"):
            # the limit sees one position go missing
            short = da.decode_attention_plain(
                q, k, v, (lengths - 1).clamp_min(0), window=window)
            for b in np.flatnonzero(lengths_np > 0):
                if torch.allclose(out[b].float(), short[b].float(), **tol):
                    raise AssertionError(
                        f"decode edge {label}: the limit {tol} does not "
                        f"tell row {b} from the same row one shorter")
            msg.append("every row told apart from itself one position shorter")
        del k, v
        for bs in sizes:
            tables_np, NB = paged_tables(rs, lengths_np, S, bs)
            tables = torch.from_numpy(tables_np).to(dev)
            kp, vp = (torch.randn(NB, bs, Hkv, D, generator=g,
                                  device=dev).to(kw["dtype"])
                      for _ in range(2))
            kq, ks = quantize_kv(kp, 2)
            vq, vs = quantize_kv(vp, 2)
            for mode, args, skw in (("", (kp, vp), {}),
                                    ("-int8", (kq, vq),
                                     dict(k_scale=ks, v_scale=vs))):
                out = da.paged_decode_attention(q, *args, tables, lengths,
                                                window=window, **skw)
                ref = da.paged_decode_attention_plain(
                    q, *args, tables, lengths, window=window, **skw)
                if not torch.isfinite(out.float()).all():
                    raise AssertionError(f"paged_decode_attention{mode} "
                                         f"{label} bs {bs}: non-finite")
                e = check_close(torch, f"paged_decode_attention{mode} "
                                f"{label} bs {bs}", out, ref, tol)
                errs["paged_decode_attention"] = max(
                    errs["paged_decode_attention"], e)
                msg.append(f"paged{mode} bs {bs} {e:.2e}")
            del kp, vp, kq, vq, ks, vs
        C, n = da.split_plan(S)
        print(f"[kernels] decode edge {label} (lengths {lens}, S={S}, "
              f"H={H}, Hkv={Hkv}, D={D}, {dtype}, window {window}; plan "
              f"chunk={C} n_split={n} CTAs={B * Hkv * n}): max_abs_err "
              + ", ".join(msg))
    return errs


def check_close(torch, name, got, ref, tol) -> float:
    err = float((got.float() - ref.float()).abs().max())
    if not torch.allclose(got.float(), ref.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# |gradient - reference| over the reference's largest |entry|: float32
# sums in other orders (flash: the kernel's output and log-sum-exp feed
# the plain backward), and in bf16 a few roundings of the inputs' dtype
GRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}


def grads_of(torch, f, leaves, gys):
    """Gradients with respect to ``leaves`` of the sum over f's outputs of
    ``out * gy`` (an output whose gy is None is left out, as training
    leaves out a scan's final state)."""
    outs = f(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * gy).sum() for o, gy in zip(outs, gys)
               if gy is not None)
    return torch.autograd.grad(loss, leaves)


def check_grads(torch, label, fn, plain, planted, leaves, gys,
                dtype) -> dict:
    """An autograd Function ``fn`` (the kernel forward, the plain
    backward) against autograd through its plain version: each gradient
    within GRAD_TOL of the reference's largest entry, all finite; the
    planted fault (a faulty function, or its gradients) must miss the
    tolerance."""
    tol = GRAD_TOL[dtype]

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())
    want = grads_of(torch, plain, leaves, gys)
    got = grads_of(torch, fn, leaves, gys)
    bad = (planted if isinstance(planted, tuple)
           else grads_of(torch, planted, leaves, gys))
    errs = [rel(a, b) for a, b in zip(got, want)]
    miss = max(rel(a, b) for a, b in zip(bad, want))
    if not all(torch.isfinite(g.float()).all() for g in got):
        raise AssertionError(f"{label}: non-finite gradients")
    if max(errs) > tol:
        raise AssertionError(f"{label}: gradients off autograd through the "
                             f"plain version by {errs} (limit {tol})")
    if not miss > tol:
        raise AssertionError(f"{label}: the gradient check does not see the "
                             f"planted fault ({miss:.2e} <= {tol})")
    print(f"[grad] {label}: relative max_abs_err {[f'{e:.2e}' for e in errs]}"
          f" (limit {tol}); planted fault {miss:.2e}")
    return {"rel_err": errs, "planted_rel_err": miss, "tol": tol}


def phase_kernels(torch, dev, timer):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import sampling
    from repro_torch.models.kvcache import quantize_kv

    rs = np.random.RandomState(0)
    H, Hkv, D, bs = 16, 8, 128, 16
    bf = dict(dtype=torch.bfloat16, device=dev)
    rows = {}

    def sdpa(q, k, v, lengths, window=None):
        """F.scaled_dot_product_attention on a (B, S, Hkv, D) view."""
        S = k.shape[1]
        pos = torch.arange(S, device=dev)[None, :]
        mask = pos < lengths[:, None].long()
        if window is not None:
            mask &= pos >= lengths[:, None].long() - window
        mask = mask[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)

    def record(key, label, err, ms, plain_ms, lib_ms, n_bytes, n_ops,
               dtype="bfloat16", note=""):
        b_ms, b_by = bound(n_bytes, n_ops, dtype)
        print(f"[kernels] {key} {label}: max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
              f"{ms / b_ms:.1f}x){note}")
        r = rows.setdefault(key, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by)
        if label == "main":
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by)

    def live_positions(lengths_np, S, window):
        n = np.minimum(lengths_np, S)
        return int((n if window is None else np.minimum(n, window)).sum())

    def paged(label, lengths_np, S, Hkv, D, q, plan, window=None):
        """The paged kernel, bf16 and int8, over shuffled tables with
        null-block tails, against its plain version, the bound and SDPA on
        the gathered view."""
        B, H = q.shape[:2]
        lengths = torch.from_numpy(lengths_np).to(dev)
        live = live_positions(lengths_np, S, window)
        tables_np, NB = paged_tables(rs, lengths_np, S, bs)
        tables = torch.from_numpy(tables_np).to(dev)
        kp = torch.randn(NB, bs, Hkv, D, **bf)
        vp = torch.randn(NB, bs, Hkv, D, **bf)
        kq, ks = quantize_kv(kp, 2)
        vq, vs = quantize_kv(vp, 2)
        for mode, args, kw, elem in (
                ("bf16", (kp, vp), {}, 2),
                ("int8", (kq, vq), dict(k_scale=ks, v_scale=vs), 1)):
            def kern():
                return da.paged_decode_attention(q, *args, tables, lengths,
                                                 window=window, **kw)

            def plain():
                return da.paged_decode_attention_plain(
                    q, *args, tables, lengths, window=window, **kw)
            err = check_close(torch, f"paged_decode_attention[{mode}]",
                              kern(), plain(), ATTN_TOL)
            kg = da.gather_view(args[0], tables, kw.get("k_scale"))
            vg = da.gather_view(args[1], tables, kw.get("v_scale"))
            record("paged_decode_attention", f"{label}" if mode == "bf16"
                   else f"{label}-int8", err, timer(kern), timer(plain),
                   timer(sdpa(q, kg.to(torch.bfloat16),
                              vg.to(torch.bfloat16), lengths, window)),
                   *decode_attention_work(
                       B, H, Hkv, D, live, kv_elem=elem,
                       quantized=mode == "int8",
                       table_entries=int((tables_np > 0).sum()))[::-1],
                   note=plan)
            del kg, vg

    for label, lengths_np, S in ATTN_CASES:
        B = len(lengths_np)
        lengths = torch.from_numpy(lengths_np).to(dev)
        live = int(np.minimum(lengths_np, S).sum())
        q = torch.randn(B, H, D, **bf)
        C, n = da.split_plan(S)
        plan = (f"; plan chunk={C} n_split={n} CTAs={B * Hkv * n}, live "
                f"{Hkv * int(np.minimum(-(-lengths_np // C), n).sum())}, "
                f"merge CTAs={B * H if n > 1 else 0}")
        # contiguous
        k = torch.randn(B, S, Hkv, D, **bf)
        v = torch.randn(B, S, Hkv, D, **bf)
        out = da.decode_attention(q, k, v, lengths)
        err = check_close(torch, "decode_attention", out,
                          da.decode_attention_plain(q, k, v, lengths),
                          ATTN_TOL)
        record("decode_attention", label, err,
               timer(lambda: da.decode_attention(q, k, v, lengths)),
               timer(lambda: da.decode_attention_plain(q, k, v, lengths)),
               timer(sdpa(q, k, v, lengths)),
               *decode_attention_work(B, H, Hkv, D, live)[::-1],
               note=plan)
        del k, v
        paged(label, lengths_np, S, Hkv, D, q, plan)
    # zamba2-2.7b's shared attention block over its paged pool: H = Hkv =
    # 32, D 80 (G 1), the main case's lengths
    lengths_np, S = ATTN_CASES[0][1], ATTN_CASES[0][2]
    C, n = da.split_plan(S)
    paged("zamba2", lengths_np, S, 32, 80,
          torch.randn(len(lengths_np), 32, 80, **bf),
          f"; plan chunk={C} n_split={n} CTAs={len(lengths_np) * 32 * n}")
    # gemma3-4b (D 256, the wide instance): no window (its global layers)
    # and its 1024 window (the local ones), contiguous and paged
    lengths_np, S, Hg, Hkvg, Dg = GEMMA_ATTN
    B = len(lengths_np)
    lengths = torch.from_numpy(lengths_np).to(dev)
    C, n = da.split_plan(S)
    q = torch.randn(B, Hg, Dg, **bf)
    k = torch.randn(B, S, Hkvg, Dg, **bf)
    v = torch.randn(B, S, Hkvg, Dg, **bf)
    for window in (None, 1024):
        label = "gemma3" + ("" if window is None else f"-w{window}")
        live = live_positions(lengths_np, S, window)
        plan = (f"; plan chunk={C} n_split={n} CTAs={B * Hkvg * n}, live "
                f"positions {live}")
        err = check_close(
            torch, f"decode_attention {label}",
            da.decode_attention(q, k, v, lengths, window=window),
            da.decode_attention_plain(q, k, v, lengths, window=window),
            ATTN_TOL)
        record("decode_attention", label, err,
               timer(lambda: da.decode_attention(q, k, v, lengths,
                                                 window=window)),
               timer(lambda: da.decode_attention_plain(q, k, v, lengths,
                                                       window=window)),
               timer(sdpa(q, k, v, lengths, window)),
               *decode_attention_work(B, Hg, Hkvg, Dg, live)[::-1],
               note=plan)
        paged(label, lengths_np, S, Hkvg, Dg, q, plan, window)
    del q, k, v
    for label, lens, S, Hf, Hkvf, Df, with_paged in FRONTEND_ATTN:
        lengths_np = np.asarray(lens, np.int32)
        B = len(lengths_np)
        lengths = torch.from_numpy(lengths_np).to(dev)
        live = live_positions(lengths_np, S, None)
        C, n = da.split_plan(S)
        plan = (f"; plan chunk={C} n_split={n} CTAs={B * Hkvf * n}, live "
                f"positions {live}")
        q = torch.randn(B, Hf, Df, **bf)
        k = torch.randn(B, S, Hkvf, Df, **bf)
        v = torch.randn(B, S, Hkvf, Df, **bf)
        err = check_close(torch, f"decode_attention {label}",
                          da.decode_attention(q, k, v, lengths),
                          da.decode_attention_plain(q, k, v, lengths),
                          ATTN_TOL)
        record("decode_attention", label, err,
               timer(lambda: da.decode_attention(q, k, v, lengths)),
               timer(lambda: da.decode_attention_plain(q, k, v, lengths)),
               timer(sdpa(q, k, v, lengths)),
               *decode_attention_work(B, Hf, Hkvf, Df, live)[::-1],
               note=plan)
        del k, v
        if with_paged:
            paged(label, lengths_np, S, Hkvf, Df, q, plan)
        del q
    for key, e in decode_edge_cases(torch, dev).items():
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], e)

    phase_greedy(torch, dev, timer, record, rows)
    return rows


# (label, B, V): greedy sampling untimed at one row and at 16 (8 CTAs a
# row at every row count up to 16), at 24 (4 CTAs), and at a vocabulary
# that is not a multiple of 4 nor of the cluster (element loads, a short
# last slice)
GREEDY_EDGE_CASES = (("B1", 1, 92544), ("B16", 16, 92544),
                     ("B24", 24, 92544), ("V50001", 8, 50001))


def greedy_logits(torch, g, dev, B, V):
    """Seeded rows with planted ties: row 0 tied across every edge of the
    kernel's cluster slices (token: the first slice's last entry), row 1
    across the last edge inside the row, row 2 all equal (token 0), row 3
    between an early entry and the row's last, row 4 across the 1024- and
    2048-entry edges of a one-CTA-a-row kernel; the rest
    random.  Returns the logits and the planted rows' tokens."""
    from repro_torch.kernels import sampling

    x = torch.randn(B, V, generator=g, device=dev)
    sl = sampling.greedy_slice(V, sampling.greedy_cluster(B))
    edges = [i for e in range(sl, V, sl) for i in (e - 1, e)]
    plants = [(edges, 60.0, edges[0]), (edges[-2:], 55.0, edges[-2]),
              (None, 0.5, 0), ([7, V - 1], 30.0, 7),
              ([2047, 2048, 4096], 45.0, 2047)]
    want = []
    for b, (cols, val, tok) in enumerate(plants[:B]):
        if cols is None:
            x[b] = val
        else:
            x[b, cols] = val
        want.append(tok)
    return x, want


def check_greedy(torch, label, x, want) -> float:
    """Tokens equal to the plain version's and to the planted ones,
    logprobs within 1e-4; returns the logprobs' error."""
    from repro_torch.kernels import sampling

    t_k, lp_k = sampling.greedy_sample(x)
    t_p, lp_p = sampling.greedy_sample_plain(x)
    if not torch.equal(t_k, t_p) or t_k[:len(want)].tolist() != want:
        raise AssertionError(f"greedy_sample {label}: tokens "
                             f"{t_k.tolist()} != plain {t_p.tolist()} "
                             f"(planted {want})")
    return check_close(torch, f"greedy_sample {label}", lp_k, lp_p,
                       dict(atol=1e-4, rtol=0))


def greedy_planted(torch, x) -> int:
    """The plain version with the cluster slice that holds row 5's maximum
    dropped (set to NEG_INF): the row's token must change, or the token
    check would not see a lost slice; returns the changed token."""
    from repro_torch.kernels import sampling

    B, V = x.shape
    sl = sampling.greedy_slice(V, sampling.greedy_cluster(B))
    want = int(sampling.greedy_sample_plain(x)[0][5])
    bad = x.clone()
    bad[5, want // sl * sl:(want // sl + 1) * sl] = sampling.NEG_INF
    got = int(sampling.greedy_sample_plain(bad)[0][5])
    if got == want:
        raise AssertionError("greedy_sample: the token check does not see "
                             "one slice dropped")
    return got


def phase_greedy(torch, dev, timer, record, rows):
    """Greedy sampling at the vocabularies of the served models, 8 rows
    (internlm2's timed as the main row, and there also with clusters of 8
    and of 16 CTAs a row), with the ties of :func:`greedy_logits`; the
    edge cases untimed; the planted fault."""
    from repro_torch.kernels import sampling

    g = torch.Generator(device=dev).manual_seed(7)
    B = 8
    for label, V in (("main", 92544), ("rwkv6", 65536), ("zamba2", 32000),
                     ("gemma3", 262144), ("minitron8b", 256000),
                     ("qwen2.5-32b", 152064), ("whisper", 51865),
                     ("dbrx", 100352), ("deepseek-v2", 102400)):
        x, want = greedy_logits(torch, g, dev, B, V)
        err = check_greedy(torch, f"V={V}", x, want)
        note = f"; cluster {sampling.greedy_cluster(B)}"
        if label == "main":
            by_cluster = {c: timer(lambda: sampling._greedy_launch(x, c))
                          for c in (8, 16)}
            note += "; kernel_ms by cluster size " + ", ".join(
                f"{c}: {t:.4f}" for c, t in by_cluster.items())
            token = greedy_planted(torch, x)
            note += (f"; row 5's maximum slice dropped: token "
                     f"{token} != {int(x[5].argmax())}")
        record("greedy_sample", label, err,
               timer(lambda: sampling.greedy_sample(x)),
               timer(lambda: sampling.greedy_sample_plain(x)),
               timer(lambda: (torch.argmax(x, -1), torch.logsumexp(x, -1))),
               *greedy_sample_work(B, V)[::-1], note=note)
    row = rows["greedy_sample"]
    row.update(cluster_ms=by_cluster, planted_slice_dropped=token)
    for label, Be, Ve in GREEDY_EDGE_CASES:
        x, want = greedy_logits(torch, g, dev, Be, Ve)
        err = check_greedy(torch, label, x, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"[kernels] greedy_sample edge {label} (B={Be}, V={Ve}, "
              f"cluster {sampling.greedy_cluster(Be)}, slice "
              f"{sampling.greedy_slice(Ve, sampling.greedy_cluster(Be))}): "
              f"tokens equal, planted {want}; max_abs_err {err:.3e}")


# (label, B, S, H, Dk, Dv, r/k/v dtype, decays): rwkv6-7b's prefill widths
# at the smoke's longest prompt and a ragged one with the model's decays,
# the JAX kernel test's decays, strong decays, a float32 shape with odd Dk
# and Dv above 64, and head dims past 64 (the kernel's 128-wide tiles)
SCAN_CASES = (
    ("main", 1, 512, 64, 64, 64, "bfloat16", "weak"),
    ("ragged", 1, 200, 64, 64, 64, "bfloat16", "weak"),
    ("jax-test", 1, 512, 64, 64, 64, "bfloat16", "normal"),
    ("strong", 1, 512, 64, 64, 64, "bfloat16", "strong"),
    ("f32", 2, 100, 3, 33, 80, "float32", "normal"),
    ("wide", 2, 150, 2, 96, 128, "bfloat16", "normal"))
# the cases the chunk-parallel design makes risky, untimed: one position,
# the edges of a 16-row sub-block and of a chunk, three chunks and one past
# (float32, held to 1e-3), B 2 at a ragged S, decays of -1 to -21 a step
# (cl near -700 inside a chunk and across its edges), float32 at the main
# shape with the model's weak decays (the state carries across all eight
# chunks; the bf16 main case's 2e-2 cannot see a split that is too short),
# Dk 33 in float32 (element loads, zero-padded channels) and Dv 128
SCAN_EDGE_CASES = (
    ("S1", 1, 1, 64, 64, 64, "float32", "weak"),
    ("S15", 1, 15, 64, 64, 64, "float32", "weak"),
    ("S16", 1, 16, 64, 64, 64, "float32", "weak"),
    ("S17", 1, 17, 64, 64, 64, "float32", "weak"),
    ("S63", 1, 63, 64, 64, 64, "float32", "weak"),
    ("S64", 1, 64, 64, 64, 64, "float32", "weak"),
    ("S65", 1, 65, 64, 64, 64, "float32", "weak"),
    ("S129", 1, 129, 64, 64, 64, "float32", "normal"),
    ("B2-ragged", 2, 300, 64, 64, 64, "bfloat16", "weak"),
    ("cl-700", 1, 200, 64, 64, 64, "float32", "very-strong"),
    ("f32-main", 1, 512, 64, 64, 64, "float32", "weak"),
    ("Dk33-f32", 1, 130, 4, 33, 64, "float32", "weak"),
    ("Dv128", 1, 200, 8, 64, 128, "bfloat16", "weak"))
SCAN_F32_TOL = dict(atol=1e-3, rtol=1e-3)


def scan_inputs(torch, dev, B, S, H, Dk, Dv, dtype, decay, seed=3):
    """Seeded scan inputs: r, k, v in ``dtype``, log_w with the model's
    weak decays (-exp(w0 + ...), w0 = -6), the JAX kernel test's
    (-exp(N(0, 1))), strong ones (down to -8 a step) or very strong ones
    (-1 to -21 a step, cl near -700 in a chunk), and u."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    r, k = (torch.randn(B, S, H, Dk, generator=g, device=dev).to(dt)
            for _ in range(2))
    v = torch.randn(B, S, H, Dv, generator=g, device=dev).to(dt)
    shape = (B, S, H, Dk)
    if decay == "weak":
        lw = -torch.exp(-6 + 0.5 * torch.randn(*shape, generator=g,
                                               device=dev))
    elif decay == "normal":
        lw = -torch.exp(torch.randn(*shape, generator=g, device=dev))
    elif decay == "strong":
        lw = -(torch.rand(*shape, generator=g, device=dev) * 8 + 1e-3)
    else:
        lw = -(torch.rand(*shape, generator=g, device=dev) * 20 + 1)
    u = torch.randn(H, Dk, generator=g, device=dev)
    return r, k, v, lw, u


def check_scan(torch, label, r, k, v, lw, u) -> tuple:
    """The kernel against its plain version: y within 1e-3 (ATTN_TOL for
    bf16), the state within 1e-3, both finite; returns the errors, y's
    largest share of its limit (|y - y0| / (atol + rtol |y0|)) and the
    plain version's y."""
    from repro_torch.kernels import rwkv6_scan as rs

    y, st = rs.rwkv6_scan(r, k, v, lw, u)
    y0, st0 = rs.rwkv6_scan_plain(r, k, v, lw, u)
    y_tol = ATTN_TOL if v.dtype == torch.bfloat16 else SCAN_F32_TOL
    err = check_close(torch, f"rwkv6_scan {label} y", y, y0, y_tol)
    st_err = check_close(torch, f"rwkv6_scan {label} state", st, st0,
                         SCAN_F32_TOL)
    if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
        raise AssertionError(f"rwkv6_scan {label}: non-finite output")
    share = float(((y.float() - y0.float()).abs() / (
        y_tol["atol"] + y_tol["rtol"] * y0.float().abs())).max())
    return err, st_err, share, y0


def scan_planted(torch, r, k, v, lw, u, y0) -> float:
    """The plain scan with the state passing dropped (every chunk from a
    zero state) against the plain scan: the largest multiple of the
    float32 tolerance; raises unless the check would see it."""
    from repro_torch.kernels import rwkv6_scan as rs

    S = r.shape[1]
    bad = torch.cat([rs.rwkv6_scan_plain(*(t[:, c:c + SCAN_CHUNK]
                                           for t in (r, k, v, lw)), u)[0]
                     for c in range(0, S, SCAN_CHUNK)], dim=1)
    tol = SCAN_F32_TOL
    share = float(((bad - y0).abs() / (tol["atol"] + tol["rtol"]
                                       * y0.abs())).max())
    if not share > 1.0:
        raise AssertionError(f"rwkv6_scan: the check does not see the "
                             f"state passing dropped ({share:.2f})")
    return share


def scan_grad_checks(torch, dev) -> dict:
    """Rwkv6ScanFn at the rwkv6-7b prefill's widths (B 1, S 512, H 64, Dk
    = Dv = 64, the model's weak decays), float32 with the final state's
    gradient and bf16 r/k/v without it, against autograd through the plain
    scan; the planted fault drops the state passing (every chunk from
    zero)."""
    from repro_torch.kernels import rwkv6_scan as rs

    def from_zero(r, k, v, lw, u):
        return (torch.cat([rs.rwkv6_scan_plain(
            *(t[:, c:c + SCAN_CHUNK] for t in (r, k, v, lw)), u)[0]
            for c in range(0, r.shape[1], SCAN_CHUNK)], dim=1),)
    res = {}
    for dtype, with_state in (("float32", True), ("bfloat16", False)):
        leaves = [t.requires_grad_() for t in scan_inputs(
            torch, dev, 1, 512, 64, 64, 64, dtype, "weak", seed=13)]
        g = torch.Generator(device=dev).manual_seed(14)
        gys = (torch.randn(1, 512, 64, 64, generator=g, device=dev),
               torch.randn(1, 64, 64, 64, generator=g, device=dev)
               if with_state else None)
        res[dtype] = check_grads(
            torch, f"Rwkv6ScanFn {dtype} (B 1, S 512, H 64, Dk = Dv = 64"
            f"{', with the state' if with_state else ''})",
            rs.Rwkv6ScanFn.apply, rs.rwkv6_scan_plain, from_zero, leaves,
            gys, dtype)
    return res


def phase_scan(torch, dev, timer):
    from repro_torch.kernels import rwkv6_scan as rs

    row = {"max_abs_err": 0.0}
    for label, B, S, H, Dk, Dv, dtype, decay in SCAN_CASES:
        r, k, v, lw, u = scan_inputs(torch, dev, B, S, H, Dk, Dv, dtype,
                                     decay)
        err, st_err, share, _ = check_scan(torch, label, r, k, v, lw, u)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        ms = timer(lambda: rs.rwkv6_scan(r, k, v, lw, u))
        plain_ms = timer(lambda: rs.rwkv6_scan_plain(r, k, v, lw, u),
                         iters=10)
        n_ops, n_bytes = rwkv6_scan_work(B, S, H, Dk, Dv, dtype,
                                         rkv_elem=r.element_size())
        b_ms, b_by = bound(n_bytes, n_ops)
        old_ms, old_by = bound(n_bytes, scan_ops(B, S, H, Dk, Dv),
                               "float32")
        print(f"[kernels] rwkv6_scan {label} (B={B}, S={S}, H={H}, "
              f"Dk={Dk}, Dv={Dv}, {dtype}, {decay} decays): "
              f"max_abs_err y={err:.3e} ({share:.2f} of the limit) "
              f"state={st_err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}; one-chunk-at-a-time count "
              f"{old_ms:.4f}, {old_by})")
        row[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, bound_old_ms=old_ms,
                          state_err=st_err)
        if label == "main":
            row.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by, bound_old_ms=old_ms)
        del r, k, v, lw, u
    for label, B, S, H, Dk, Dv, dtype, decay in SCAN_EDGE_CASES:
        r, k, v, lw, u = scan_inputs(torch, dev, B, S, H, Dk, Dv, dtype,
                                     decay, seed=11)
        err, st_err, share, y0 = check_scan(torch, f"edge {label}", r, k,
                                            v, lw, u)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        note = ""
        if label == "f32-main":
            dropped = scan_planted(torch, r, k, v, lw, u, y0)
            row["planted_state_dropped"] = dropped
            note = (f"; state passing dropped: {dropped:.1f} times the "
                    f"tolerance")
        print(f"[kernels] rwkv6_scan edge {label} (B={B}, S={S}, H={H}, "
              f"Dk={Dk}, Dv={Dv}, {dtype}, {decay} decays): max_abs_err "
              f"y={err:.3e} ({share:.2f} of the limit) "
              f"state={st_err:.3e}{note}")
        del r, k, v, lw, u, y0
    row["grads"] = scan_grad_checks(torch, dev)
    return row


# (label, B, S, H, N, hd, r/k dtype, v dtype, decays): zamba2-2.7b's
# prefill widths at the smoke's longest prompt and a ragged one with the
# model's decays, weak decays, the JAX kernel test's decays, an all-float32
# shape with a partial 64-column value block, and N = hd = 128 with v bf16
MAMBA_CASES = (
    ("main", 1, 512, 80, 64, 64, "bfloat16", "float32", "model"),
    ("ragged", 1, 200, 80, 64, 64, "bfloat16", "float32", "model"),
    ("weak", 1, 512, 80, 64, 64, "bfloat16", "float32", "weak"),
    ("jax-test", 1, 512, 80, 64, 64, "bfloat16", "float32", "normal"),
    ("f32", 2, 130, 4, 16, 40, "float32", "float32", "normal"),
    ("wide", 1, 100, 4, 128, 128, "bfloat16", "bfloat16", "normal"))
# the cases the chunk-parallel design makes risky, untimed (label, B, S, H,
# N, hd, r/k dtype, v dtype, decays, r/k broadcast over the heads): chunk
# edges and a single chunk (S 1, 63, 64, 65, 129), B 2 at a ragged S, H
# that is not a multiple of the head group, r and k per head (R K^T not
# shared), strong decays (cl near -700 inside a chunk and across its
# edges), float32 r/k per head with a partial value block, N 128 with
# float32 v and two value blocks, and float32 r/k at N = hd = 128 (three
# bf16 parts of r and k beside S_in's); the state carries (weak decays) in
# most
MAMBA_EDGE_CASES = (
    ("S1", 1, 1, 80, 64, 64, "bfloat16", "float32", "weak", True),
    ("S63", 1, 63, 80, 64, 64, "bfloat16", "float32", "weak", True),
    ("S64", 1, 64, 80, 64, 64, "bfloat16", "float32", "weak", True),
    ("S65", 1, 65, 80, 64, 64, "bfloat16", "float32", "weak", True),
    ("S129", 1, 129, 80, 64, 64, "bfloat16", "float32", "model", True),
    ("B2-ragged", 2, 300, 80, 64, 64, "bfloat16", "float32", "weak", True),
    ("H13", 1, 200, 13, 64, 64, "bfloat16", "float32", "weak", True),
    ("per-head-rk", 2, 150, 6, 64, 64, "bfloat16", "float32", "weak",
     False),
    ("strong", 1, 512, 80, 64, 64, "bfloat16", "float32", "strong", True),
    ("f32-per-head", 1, 130, 3, 32, 48, "float32", "float32", "weak",
     False),
    ("N128-f32", 1, 200, 3, 128, 96, "bfloat16", "float32", "weak", True),
    ("N128-f32-rk", 1, 200, 4, 128, 128, "float32", "float32", "weak",
     True))
MAMBA_F32_TOL = dict(atol=1e-3, rtol=1e-3)


def mamba2_inputs(torch, dev, B, S, H, N, hd, rk_dt, v_dt, decay,
                  shared=True, seed=4):
    """Seeded scan inputs as the model makes them: r and k of one dtype
    (broadcasts of one (B, S, 1, N) slice over the heads, or per head), v
    and log_w (the block's -exp(A_log) softplus(dt), weak decays of about
    -1e-3, the JAX test's -exp(N(0, 1)), or strong ones of -1 to -21 a
    step).  Returns (r, k, v, log_w, the tensors r and k are read from)."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    rkt, vt = getattr(torch, rk_dt), getattr(torch, v_dt)
    r1, k1 = (torch.randn(B, S, 1 if shared else H, N, generator=g,
                          device=dev).to(rkt) for _ in range(2))
    r, k = r1.expand(B, S, H, N), k1.expand(B, S, H, N)
    x = torch.randn(B, S, H, hd, generator=g, device=dev)
    if decay == "model":
        a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
        dt = F.softplus(torch.randn(B, S, H, generator=g, device=dev))
        return r, k, (x.to(rkt).float() * dt[..., None]).to(vt), \
            (-torch.exp(a_log) * dt)[..., None], (r1, k1)
    if decay == "weak":
        lw = -1e-3 * torch.exp(0.1 * torch.randn(B, S, H, 1, generator=g,
                                                 device=dev))
    elif decay == "normal":
        lw = -torch.exp(torch.randn(B, S, H, 1, generator=g, device=dev))
    else:
        lw = -(torch.rand(B, S, H, 1, generator=g, device=dev) * 20 + 1)
    return r, k, x.to(vt), lw, (r1, k1)


def check_mamba2(torch, label, r, k, v, lw) -> tuple:
    """The kernel against its plain version: y within 1e-3 (ATTN_TOL for
    bf16 v), the state within 1e-3, both finite; returns the errors and
    the plain version's y."""
    from repro_torch.kernels import mamba2_scan as ms

    y, st = ms.mamba2_scan(r, k, v, lw)
    y0, st0 = ms.mamba2_scan_plain(r, k, v, lw)
    y_tol = ATTN_TOL if v.dtype == torch.bfloat16 else MAMBA_F32_TOL
    err = check_close(torch, f"mamba2_scan {label} y", y, y0, y_tol)
    st_err = check_close(torch, f"mamba2_scan {label} state", st, st0,
                         MAMBA_F32_TOL)
    if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
        raise AssertionError(f"mamba2_scan {label}: non-finite output")
    return err, st_err, y0


def mamba2_planted(torch, r, k, v, lw, y0) -> float:
    """The plain version with the state passing dropped (every chunk from
    a zero state) against the plain version: the largest multiple of the
    float32 tolerance; raises unless the check would see it."""
    from repro_torch.kernels import mamba2_scan as ms

    S = r.shape[1]
    bad = torch.cat([ms.mamba2_scan_plain(*(t[:, c:c + SCAN_CHUNK]
                                            for t in (r, k, v, lw)))[0]
                     for c in range(0, S, SCAN_CHUNK)], dim=1)
    tol = MAMBA_F32_TOL
    share = float(((bad - y0).abs() / (tol["atol"] + tol["rtol"]
                                       * y0.abs())).max())
    if not share > 1.0:
        raise AssertionError(f"mamba2_scan: the check does not see the "
                             f"state passing dropped ({share:.2f})")
    return share


def mamba2_grad_checks(torch, dev) -> dict:
    """Mamba2ScanFn at zamba2-2.7b's prefill widths (B 1, S 512, H 80, N
    = hd = 64), r and k stride-0 broadcasts of one (B, S, 1, N) slice as
    the model passes them (their gradients summed over the heads through
    the expand): bf16 r/k with float32 v (the model's) and the final
    state's gradient, and all float32 without it, against autograd
    through the plain scan; the planted fault drops the state passing."""
    from repro_torch.kernels import mamba2_scan as ms

    def expand(f):
        def run(r1, k1, v, lw):
            shape = v.shape[:3] + (r1.shape[3],)
            return f(r1.expand(shape), k1.expand(shape), v, lw)
        return run

    def from_zero(r, k, v, lw):
        return (torch.cat([ms.mamba2_scan_plain(
            *(t[:, c:c + SCAN_CHUNK] for t in (r, k, v, lw)))[0]
            for c in range(0, r.shape[1], SCAN_CHUNK)], dim=1),)
    res = {}
    for rk_dt, with_state in (("bfloat16", True), ("float32", False)):
        _, _, v, lw, (r1, k1) = mamba2_inputs(torch, dev, 1, 512, 80, 64, 64,
                                              rk_dt, "float32", "model",
                                              seed=13)
        leaves = [t.detach().requires_grad_() for t in (r1, k1, v, lw)]
        g = torch.Generator(device=dev).manual_seed(14)
        gys = (torch.randn(1, 512, 80, 64, generator=g, device=dev),
               torch.randn(1, 80, 64, 64, generator=g, device=dev)
               if with_state else None)
        res[rk_dt] = check_grads(
            torch, f"Mamba2ScanFn r/k {rk_dt} broadcasts, v float32 (B 1, "
            f"S 512, H 80, N = hd = 64{', with the state' if with_state else ''})",
            expand(ms.Mamba2ScanFn.apply), expand(ms.mamba2_scan_plain),
            expand(from_zero), leaves, gys, rk_dt)
    return res


def phase_mamba2_scan(torch, dev, timer):
    from repro_torch.kernels import mamba2_scan as ms

    row = {"max_abs_err": 0.0}
    for label, B, S, H, N, hd, rk_dt, v_dt, decay in MAMBA_CASES:
        r, k, v, lw, (r1, k1) = mamba2_inputs(torch, dev, B, S, H, N, hd,
                                              rk_dt, v_dt, decay)
        err, st_err, y0 = check_mamba2(torch, label, r, k, v, lw)
        note = ""
        if label == "weak":
            share = mamba2_planted(torch, r, k, v, lw, y0)
            row["planted_state_dropped"] = share
            note = (f"; state passing dropped: {share:.1f} times the "
                    f"tolerance")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        ms_ = timer(lambda: ms.mamba2_scan(r, k, v, lw))
        plain_ms = timer(lambda: ms.mamba2_scan_plain(r, k, v, lw), iters=10)
        # each input read once: r and k are one (B, S, 1, N) slice each
        b_ms, b_by = bound(*mamba2_scan_work(B, S, H, N, hd, rk_dt,
                                             v_dt)[::-1])
        print(f"[kernels] mamba2_scan {label} (B={B}, S={S}, H={H}, N={N}, "
              f"hd={hd}, r/k {rk_dt}, v {v_dt}, {decay} decays): "
              f"max_abs_err y={err:.3e} state={st_err:.3e} "
              f"kernel_ms={ms_:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}){note}")
        row[label] = dict(ms=ms_, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, state_err=st_err)
        if label == "main":
            row.update(ms=ms_, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by)
        del r, k, r1, k1, v, lw, y0
    for label, B, S, H, N, hd, rk_dt, v_dt, decay, shared in \
            MAMBA_EDGE_CASES:
        r, k, v, lw, _ = mamba2_inputs(torch, dev, B, S, H, N, hd, rk_dt,
                                       v_dt, decay, shared, seed=11)
        err, st_err, _ = check_mamba2(torch, f"edge {label}", r, k, v, lw)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        print(f"[kernels] mamba2_scan edge {label} (B={B}, S={S}, H={H}, "
              f"N={N}, hd={hd}, r/k {rk_dt} "
              f"{'broadcast' if shared else 'per head'}, v {v_dt}, {decay} "
              f"decays): max_abs_err y={err:.3e} state={st_err:.3e}")
    row["grads"] = mamba2_grad_checks(torch, dev)
    return row


TOPK_KS, TOPK_MAIN = (1, 50, 64, 1024), 50
# (label, B, V, ks): the vocabularies of the served models, one that is not
# a multiple of the cluster (nor of 4: element loads), k above one slice,
# one row and 16 rows, and one whose slices do not fit in shared memory (read
# from device memory in every pass)
TOPK_EDGE_CASES = (
    ("V65536", 8, 65536, (50, 1024)),
    ("V32000", 8, 32000, (50, 1024)),
    ("V50001", 8, 50001, (1, 50, 1024)),
    ("k>slice", 4, 1000, (130, 600, 1000)),
    ("B1", 1, 92544, (50,)),
    ("B16", 16, 92544, (50, 1024)),
    ("V420000", 2, 420000, (50, 1024)))


def topk_logits(torch, g, dev, B, V):
    """Seeded rows with ties straddling the kernel's slice edges (at the
    top, and at the row's maximum), a row of equal entries, and a row whose
    k-th value is a zero of either sign for k from 31 up to thousands."""
    from repro_torch.kernels import sampling

    x = torch.randn(B, V, generator=g, device=dev)
    sl = sampling.topk_slice(V)
    edges = [i for e in range(sl, V, sl) for i in (e - 1, e)]
    x[0, edges] = 6.0
    x[0, edges[:3]] = 7.0
    if B > 1:
        x[1] = 1.5
    if B > 2:
        x[2] = -x[2].abs() - 1.0
        x[2, edges[:2]] = 5.0
        x[2, 100:128] = 5.0
        x[2, 0::7] = 0.0
        x[2, 3::7] = -0.0
    if B > 3:
        x[3, edges] = float(x[3].max())
    return x


def check_topk(torch, label, x, k) -> list:
    """Values and mask against the plain version, bit for bit (values with
    -0.0 read as +0.0); returns the entries kept per row."""
    from repro_torch.kernels import sampling

    def bits(t):
        return (t + 0.0).view(torch.int32)
    got, want = sampling.topk_values(x, k), sampling.topk_values_plain(x, k)
    m_got, m_want = sampling.topk_mask(x, k), sampling.topk_mask_plain(x, k)
    if not (torch.equal(bits(got), bits(want))
            and torch.equal(m_got.view(torch.int32),
                            m_want.view(torch.int32))):
        raise AssertionError(f"topk {label} k={k}: kernel differs from its "
                             f"plain version")
    return (m_got > sampling.NEG_INF).sum(1).tolist()


def topk_planted(torch, x, k) -> int:
    """The plain version with one slice's candidates dropped (row 0's
    entries above its k-th value in the slice of its maximum) against the
    plain version: the places that differ; raises if the bit check would
    not see it."""
    from repro_torch.kernels import sampling

    sl = sampling.topk_slice(x.shape[1])
    want = sampling.topk_values_plain(x, k)
    r = int(x[0].argmax()) // sl
    bad = x.clone()
    part = bad[0, r * sl:(r + 1) * sl]
    part[part > want[0, k - 1]] = sampling.NEG_INF
    got = sampling.topk_values_plain(bad, k)
    n = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if n == 0:
        raise AssertionError("topk: the bit check does not see one slice's "
                             "candidates dropped")
    return n


def phase_topk(torch, dev, timer):
    """Top-k at the greedy kernel's shape and the edge cases, bit for bit
    against the plain version; k 50 (a common top-k sampling setting) at
    8 x 92544 is the timed case."""
    from repro_torch.kernels import sampling

    B, V = 8, 92544
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(B, V, generator=g, device=dev)
    x[0, 5:20] = 20.0                # 15 tied at the top ...
    x[0, 1000:1100:2] = 10.0         # ... above 50 tied at the 50th value
    x[1, [1023, 1024, V - 1]] = 9.0  # a tie across a 1024 edge and the end
    x[2] = -x[2].abs() - 1.0         # 30 above zero, then 20 + 0.0 and
    x[2, 10:40] = 5.0                # 20 -0.0: the k-th value is a zero
    x[2, 40:60] = 0.0
    x[2, 60:80] = -0.0
    row = {"max_abs_err": 0.0}
    for k in TOPK_KS:
        kept = check_topk(torch, "main", x, k)
        print(f"[kernels] topk k={k}: values and mask bit-identical to the "
              f"plain version (a zero's sign aside); entries kept per row "
              f"{kept}")
    for label, Be, Ve, ks in TOPK_EDGE_CASES:
        xe = topk_logits(torch, g, dev, Be, Ve)
        kept = [check_topk(torch, label, xe, k) for k in ks]
        print(f"[kernels] topk edge {label} (B={Be}, V={Ve}, slice "
              f"{sampling.topk_slice(Ve)}): k {ks} bit-identical; entries "
              f"kept in rows 0-3 {[kp[:4] for kp in kept]}")
    n_bad = topk_planted(torch, x, TOPK_MAIN)
    row["planted_slice_dropped"] = n_bad
    print(f"[kernels] topk: one slice's candidates dropped from row 0 "
          f"changes {n_bad} of its {TOPK_MAIN} values: the bit check sees "
          f"it")
    k = TOPK_MAIN
    ms = timer(lambda: sampling.topk_values(x, k))
    plain_ms = timer(lambda: sampling.topk_values_plain(x, k))
    lib_ms = timer(lambda: torch.topk(x, k, dim=-1))
    mask_ms = timer(lambda: sampling.topk_mask(x, k))
    mask_plain_ms = timer(lambda: sampling.topk_mask_plain(x, k))
    b_ms, b_by = bound(topk_work(B, V, k)[1], 0, "float32")
    mb_ms, _ = bound(topk_work(B, V, k, with_mask=True)[1], 0, "float32")
    print(f"[kernels] topk k={k} (B={B}, V={V}): kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (torch.topk) "
          f"bound_ms={b_ms:.4f} ({b_by}); mask: kernel_ms={mask_ms:.4f} "
          f"plain_ms={mask_plain_ms:.4f} bound_ms={mb_ms:.4f}")
    row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, mask=dict(ms=mask_ms, plain_ms=mask_plain_ms,
                                        bound_ms=mb_ms))
    return row


# (label, rows, positions, H, Hkv, D): internlm2's training shape, a long
# one, and zamba2's shared attention at the smoke's longest prompt
# (label, B, S, H, Hkv, D, window): the training shape, a long one,
# zamba2's shared attention, gemma3-4b's longest prefill at D 256 without
# and with its 1024 window
# (label, rows, positions, H, Hkv, D, window, causal): the timed shapes;
# qwen2-vl-7b's prefill (G 7), whisper-tiny's encoder (bidirectional
# over its 1500 frames, D 64) and dbrx-132b's longest prefill (G 6)
FLASH_CASES = (("main", 16, 16 + MAX_NEW - 1, 16, 8, 128, None, True),
               ("long", 2, 4096, 16, 8, 128, None, True),
               ("zamba2", 1, 512, 32, 32, 80, None, True),
               ("gemma3", 1, 1900, 8, 4, 256, None, True),
               ("gemma3-w1024", 1, 1900, 8, 4, 256, 1024, True),
               ("qwen2-vl", 1, 512, 28, 4, 128, None, True),
               ("whisper-encoder", 1, 1500, 6, 6, 64, None, False),
               ("dbrx", 1, 512, 48, 8, 128, None, True))


# (label, rows, positions, H, Hkv, D, window): held against the plain
# version untimed, in bf16 and float32.  S at key-tile edges and a ragged
# last tile; windows that end on a tile edge (64) and that empty a query
# tile's leading key tiles (5, 100); G 1, 2, 4; every compiled D (16 to
# 128 in steps of 16) at 32-key tiles (below S 256) and 64-key ones; the
# internlm2, minitron-8b, qwen2.5-32b and dbrx-132b prefills' own shapes (S
# 512, Hkv 8, D 128, H 16, 32, 40 and 48: G 2, 4, 5 and 6); from S 1024
# at D 128 the warpgroup-MMA path (S 1030 leaves the last tile's second
# warpgroup without a row).
FLASH_EDGE_CASES = (
    ("S1", 2, 1, 8, 4, 128, None),
    ("S63", 2, 63, 8, 4, 128, None),
    ("S64", 2, 64, 8, 4, 128, None),
    ("S65", 2, 65, 8, 4, 128, None),
    ("S130", 2, 130, 8, 4, 128, None),
    ("window5", 1, 300, 8, 4, 128, 5),
    ("window64", 1, 300, 8, 4, 128, 64),
    ("window100", 1, 300, 8, 4, 128, 100),
    ("prefill-S512", 1, 512, 16, 8, 128, None),
    ("minitron-S512", 1, 512, 32, 8, 128, None),
    ("qwen-S512", 1, 512, 40, 8, 128, None),
    ("dbrx-S512", 1, 512, 48, 8, 128, None),
    ("G1-D64", 2, 130, 4, 4, 64, None),
    ("G4-D80", 2, 130, 8, 2, 80, 100),
    ("G1-D80-S512", 1, 512, 4, 4, 80, 64),
    ("D16", 2, 130, 4, 2, 16, None),
    ("D16-S300", 1, 300, 4, 2, 16, 100),
    ("D32", 2, 130, 4, 2, 32, None),
    ("D32-S300", 1, 300, 4, 2, 32, None),
    ("D48", 2, 130, 4, 2, 48, 64),
    ("D48-S300", 1, 300, 4, 2, 48, None),
    ("D96", 2, 130, 4, 2, 96, None),
    ("D96-S300", 1, 300, 4, 2, 96, 100),
    ("D112", 2, 130, 4, 2, 112, None),
    ("D112-S300", 1, 300, 4, 2, 112, None),
    ("long-window100", 1, 1100, 8, 4, 128, 100),
    ("long-G4-S1030", 1, 1030, 8, 2, 128, None),
    ("long-G1-D80", 1, 1500, 4, 4, 80, 64),
    ("long-G2-D64", 1, 1030, 4, 2, 64, None),
    ("D256", 2, 130, 4, 2, 256, None),
    ("D256-G1-S65", 2, 65, 4, 4, 256, 5),
    ("D256-S300-w100", 1, 300, 8, 4, 256, 100),
    ("D256-S1030", 1, 1030, 8, 4, 256, None),
    ("D256-S1500-w1024", 1, 1500, 8, 4, 256, 1024),
)
# Output limits, element by element.  float32: summation-order noise.
# bf16: the kernel rounds each p to bf16 before P V (relative error at
# most 2^-8, so the sum moves by at most 2^-8 sum_j w_j |v_j|) and both
# outputs round to bf16 (one step, at most 2^-7 of the value); 1 % over
# both for the rounding of these terms themselves, 1e-5 for float32 noise.
# On a row of 1000 keys, where outputs are about 0.05, the limit is about
# 3.5e-3.  Log-sum-exp: absolute, by dtype.
FLASH_LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-5}
# (label, rows, positions, H, Hkv, D): bidirectional (``causal=False``,
# the whisper encoder's) at key-tile edges, a ragged last tile, G 7 at D
# 128 (qwen2-vl's widths), the encoder's own S 1500 at D 64, and the
# long-S tiles of D 128, held untimed in bf16 and float32
FLASH_BIDIR_CASES = (
    ("bidir-S1", 2, 1, 6, 6, 64),
    ("bidir-S65", 2, 65, 6, 6, 64),
    ("bidir-S130", 2, 130, 8, 4, 128),
    ("bidir-G7-S300", 1, 300, 28, 4, 128),
    ("bidir-S1500-D64", 1, 1500, 6, 6, 64),
    ("bidir-S1030-D128", 1, 1030, 8, 2, 128),
)
# the cases, and the key, at which the smoke shows that the bf16 limit sees
# one key go missing from P V on rows of 512 to 1030 keys
FLASH_PLANTED = {"long-G4-S1030": 512, "D256-S1030": 512}


def flash_limit(torch, q, k, v, ref, window=None, causal=True):
    """The elementwise limit on |kernel - plain| for ``ref``, the plain
    version's output on q, k, v (see the comment above FLASH_LSE_TOL)."""
    from repro_torch.kernels import flash_attention as fa

    if q.dtype == torch.float32:
        return 1e-4 + 1e-4 * ref.float().abs()
    wv = fa.flash_attention_plain(q, k, v.abs(), window=window,
                                  causal=causal).float()
    return 1.01 * (2 ** -8 * wv + 2 ** -7 * ref.float().abs()) + 1e-5


def check_flash(torch, label, q, k, v, window=None, causal=True) -> tuple:
    """The kernel against the plain version on q, k, v: output within
    flash_limit and log-sum-exp within FLASH_LSE_TOL; raises on a miss,
    returns (output error, its largest share of the limit, log-sum-exp
    error)."""
    from repro_torch.kernels import flash_attention as fa

    out, lse = fa.flash_attention(q, k, v, window=window, causal=causal,
                                  return_lse=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, window=window,
                                            causal=causal, return_lse=True)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"flash_attention {label}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    share = float((diff / flash_limit(torch, q, k, v, ref, window,
                                      causal)).max())
    if not share <= 1.0:
        raise AssertionError(f"flash_attention {label}: kernel disagrees "
                             f"with its plain version (max abs err "
                             f"{err:.3e}, {share:.2f} of the limit)")
    lse_err = float((lse - ref_lse).abs().max())
    lse_tol = FLASH_LSE_TOL[str(q.dtype).split(".")[-1]]
    if not lse_err <= lse_tol:
        raise AssertionError(f"flash_attention {label}: log-sum-exp off by "
                             f"{lse_err:.3e} (limit {lse_tol})")
    return err, share, lse_err


def planted_miss(torch, q, k, v, key) -> float:
    """The plain version with ``key`` dropped from P V (its v zeroed, its
    weight kept in the sum) against the plain version: the largest share
    of the bf16 limit; raises unless it exceeds the limit."""
    from repro_torch.kernels import flash_attention as fa

    ref = fa.flash_attention_plain(q, k, v)
    v0 = v.clone()
    v0[:, key] = 0
    bad = fa.flash_attention_plain(q, k, v0)
    share = float(((bad.float() - ref.float()).abs()
                   / flash_limit(torch, q, k, v, ref)).max())
    if not share > 1.0:
        raise AssertionError(f"flash edge: the bf16 limit does not see key "
                             f"{key} go missing from P V ({share:.2f})")
    return share


def flash_edge_cases(torch, dev) -> dict:
    """Every FLASH_EDGE_CASES case in bf16 and float32, and q, k, v as
    strided views (one fused (B, S, (H + 2 Hkv) D) projection, and a
    (B, H, S, D) tensor transposed) at the training shape, against the
    plain version; returns the largest errors by dtype: output, share of
    the limit, log-sum-exp."""
    g = torch.Generator(device=dev).manual_seed(5)
    worst = {}

    def note(dt, *errs):
        w = worst.setdefault(dt, [0.0, 0.0, 0.0])
        w[:] = [max(a, b) for a, b in zip(w, errs)]

    for label, B, S, H, Hkv, D, window in FLASH_EDGE_CASES:
        msg = []
        for dt in ("bfloat16", "float32"):
            q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(
                getattr(torch, dt)) for h in (H, Hkv, Hkv))
            e, sh, el = check_flash(torch, f"edge {label} {dt}", q, k, v,
                                    window)
            note(dt, e, sh, el)
            msg.append(f"{dt} {e:.2e} ({sh:.2f} of the limit; lse "
                       f"{el:.2e})")
            if label in FLASH_PLANTED and dt == "bfloat16":
                key = FLASH_PLANTED[label]
                msg.append(f"key {key} missing from P V: "
                           f"{planted_miss(torch, q, k, v, key):.1f} of the "
                           f"limit")
        print(f"[flash] edge {label} (B={B}, S={S}, H={H}, Hkv={Hkv}, "
              f"D={D}, window {window}): max_abs_err " + ", ".join(msg))
    for label, B, S, H, Hkv, D in FLASH_BIDIR_CASES:
        msg = []
        for dt in ("bfloat16", "float32"):
            q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev).to(
                getattr(torch, dt)) for h in (H, Hkv, Hkv))
            e, sh, el = check_flash(torch, f"edge {label} {dt}", q, k, v,
                                    causal=False)
            note(dt, e, sh, el)
            msg.append(f"{dt} {e:.2e} ({sh:.2f} of the limit; lse "
                       f"{el:.2e})")
        print(f"[flash] edge {label} (B={B}, S={S}, H={H}, Hkv={Hkv}, "
              f"D={D}, causal=False): max_abs_err " + ", ".join(msg))
    B, S, H, Hkv, D = 2, 16 + MAX_NEW - 1, 16, 8, 128
    qkv = torch.randn(B, S, (H + 2 * Hkv) * D, generator=g,
                      device=dev).to(torch.bfloat16)
    views = {"fused-qkv": (qkv[..., :H * D].view(B, S, H, D),
                           qkv[..., H * D:(H + Hkv) * D].view(B, S, Hkv, D),
                           qkv[..., (H + Hkv) * D:].view(B, S, Hkv, D))}
    bhsd = [torch.randn(B, h, S, D, generator=g, device=dev).to(
        torch.bfloat16) for h in (H, Hkv, Hkv)]
    views["transposed"] = tuple(t.transpose(1, 2) for t in bhsd)
    for label, (q, k, v) in views.items():
        assert not q.is_contiguous()
        e, sh, el = check_flash(torch, f"strided {label}", q, k, v)
        note("bfloat16", e, sh, el)
        print(f"[flash] strided {label} q {tuple(q.stride())}: max_abs_err "
              f"{e:.2e} ({sh:.2f} of the limit; lse {el:.2e})")
    return worst


# deepseek-v2's MLA prefill through flash's D 192 / Dv 128 instance:
# (label, rows, positions, H, Hkv) timed at its longest prompt, and (label,
# rows, positions, H, Hkv, window) untimed at key-tile edges (S 1, 65, 130
# at 32-key tiles; 300, 1030 at 64-key ones), G 2 and a window, each held
# against the plain version in bf16 and float32; the key dropped from P V
# at the timed shape must fail the bf16 limit
MLA_FLASH = ("deepseek-v2", 1, 512, 128, 128)
MLA_FLASH_EDGE = (("S1", 2, 1, 8, 8, None), ("S65", 2, 65, 8, 8, None),
                  ("S130-G2", 2, 130, 8, 4, None),
                  ("S300-w100", 1, 300, 8, 8, 100),
                  ("S1030", 1, 1030, 8, 8, None))
MLA_FLASH_PLANTED = 300


def sdpa_first_backend(torch, q, k, v):
    """SDPA, causal, on (B, H, S, ·) views of q, k, v through the first of
    its backends that takes them: ``(backend name, fn)``, or ``(None,
    error)`` when none does."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    errors = []
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fn(be=be):
            with sdpa_kernel([be]):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            errors.append(f"{be.name}: {str(e).splitlines()[0][:120]}")
            continue
        return be.name, fn
    return None, "; ".join(errors)


def flash_grad_check(torch, g, dt, q, k, v) -> dict:
    """FlashAttentionFn's gradients at deepseek-v2's MLA prefill shape (D
    192, Dv 128) against autograd through ``flash_attention_plain``; the
    planted fault is the backward with ``delta = rowsum(dout * out)``
    dropped (``out`` passed as zeros)."""
    from repro_torch.kernels import flash_attention as fa

    gy = torch.randn(v.shape[:2] + (q.shape[2], v.shape[3]), generator=g,
                     device=q.device)
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    bad = fa.flash_attention_backward_plain(q, k, v, torch.zeros_like(out),
                                            lse, gy.to(dt))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return check_grads(
        torch, f"FlashAttentionFn D 192 / Dv 128 {str(dt)[6:]} (B "
        f"{q.shape[0]}, S {q.shape[1]}, H {q.shape[2]})",
        lambda q, k, v: fa.FlashAttentionFn.apply(q, k, v, True, None),
        fa.flash_attention_plain, bad, leaves, (gy,), str(dt)[6:])


def flash_mla(torch, dev, timer) -> dict:
    """Flash's D 192 / Dv 128 instance (deepseek-v2's MLA prefill): the
    MLA_FLASH_EDGE cases and the MLA_FLASH shape against the plain
    version in bf16 and float32, the planted key in bf16, the kernel,
    plain and SDPA times with the bound at MLA_FLASH, and the gradients of
    FlashAttentionFn (its plain backward at Dv != D) in both dtypes
    (:func:`flash_grad_check`)."""
    from repro_torch.kernels import flash_attention as fa

    D, Dv = fa.MLA_HEAD_DIMS
    g = torch.Generator(device=dev).manual_seed(11)

    def qkv(B, S, H, Hkv, dt):
        return tuple(torch.randn(B, S, h, d, generator=g, device=dev).to(dt)
                     for h, d in ((H, D), (Hkv, D), (Hkv, Dv)))

    worst = {}
    for label, B, S, H, Hkv, window in MLA_FLASH_EDGE:
        msg = []
        for dt in (torch.bfloat16, torch.float32):
            e, sh, el = check_flash(torch, f"mla {label} {dt}",
                                    *qkv(B, S, H, Hkv, dt), window)
            w = worst.setdefault(str(dt), [0.0, 0.0, 0.0])
            w[:] = [max(a, b) for a, b in zip(w, (e, sh, el))]
            msg.append(f"{str(dt)[6:]} {e:.2e} ({sh:.2f} of the limit; "
                       f"lse {el:.2e})")
        print(f"[flash] mla edge {label} (B={B}, S={S}, H={H}, Hkv={Hkv}, "
              f"D={D}, Dv={Dv}, window {window}): max_abs_err "
              + ", ".join(msg))
    label, B, S, H, Hkv = MLA_FLASH
    q32, k32, v32 = qkv(B, S, H, Hkv, torch.float32)
    err32, share32, lse32 = check_flash(torch, f"{label} float32", q32, k32,
                                        v32)
    del q32, k32, v32
    q, k, v = qkv(B, S, H, Hkv, torch.bfloat16)
    err, share, lse_err = check_flash(torch, label, q, k, v)
    planted = planted_miss(torch, q, k, v, MLA_FLASH_PLANTED)
    grads = {str(dt)[6:]: flash_grad_check(torch, g, dt, *qkv(B, S, H, Hkv,
                                                                dt))
             for dt in (torch.float32, torch.bfloat16)}
    ms = timer(lambda: fa.flash_attention(q, k, v, return_lse=True))
    plain_ms = timer(lambda: fa.flash_attention_plain(q, k, v,
                                                      return_lse=True),
                     iters=10)
    backend, fn = sdpa_first_backend(torch, q, k, v)
    lib_ms = timer(fn) if backend else None
    n_ops, n_bytes = flash_attention_work(B, S, H, Hkv, D, Dv)
    b_ms, b_by = bound(n_bytes, n_ops)
    n_ops = n_ops["bfloat16"]
    print(f"[flash] {label} (B={B}, S={S}, H={H}, Hkv={Hkv}, D={D}, "
          f"Dv={Dv}): max_abs_err={err:.3e} ({share:.2f} of the limit; lse "
          f"{lse_err:.2e}), float32 {err32:.3e} ({share32:.2f}; lse "
          f"{lse32:.2e}); key {MLA_FLASH_PLANTED} missing from P V: "
          f"{planted:.1f} of the limit; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          + (f"{lib_ms:.4f} (SDPA {backend})" if backend else
             f"null (SDPA refused: {fn})")
          + f" bound_ms={b_ms:.4f} ({b_by}; {n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.2f} GFLOP)")
    del q, k, v
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_backend=backend if backend else fn, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, limit_share=share,
                lse_err=lse_err, float32_err=err32, planted_share=planted,
                edge_max_err=worst, grads=grads)


def phase_flash(torch, dev, timer):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    row = {"max_abs_err": 0.0, "edge_max_err": flash_edge_cases(torch, dev)}
    for label, B, S, H, Hkv, D, window, causal in FLASH_CASES:
        g = torch.Generator(device=dev).manual_seed(2)
        q, k, v = (torch.randn(B, S, h, D, generator=g, device=dev,
                               dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
        err, share, lse_err = check_flash(torch, label, q, k, v, window,
                                          causal)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        # gradients: FlashAttentionFn against autograd through the plain
        dout = torch.randn(B, S, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16)
        got = [t.detach().requires_grad_() for t in (q, k, v)]
        fa.FlashAttentionFn.apply(*got, causal, window).backward(dout)
        ref = [t.detach().requires_grad_() for t in (q, k, v)]
        fa.flash_attention_plain(*ref, window=window,
                                 causal=causal).backward(dout)
        g_err = {n: check_close(torch, f"flash_attention {label} {n}",
                                a.grad, b.grad, ATTN_TOL)
                 for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        del got, ref
        out, lse = fa.flash_attention(q, k, v, window=window, causal=causal,
                                      return_lse=True)

        def sdpa(q, k, v):
            """SDPA on (B, H, S, D) views: causal or bidirectional, or the
            window's mask."""
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=wmask, enable_gqa=True)
        pos = torch.arange(S, device=dev)
        wmask = fa._mask(pos, pos, True, window)
        ms = timer(lambda: fa.flash_attention(q, k, v, window=window,
                                              causal=causal, return_lse=True))
        plain_ms = timer(lambda: fa.flash_attention_plain(
            q, k, v, window=window, causal=causal, return_lse=True),
            iters=10)
        lib_ms = timer(lambda: sdpa(q, k, v))
        bwd_ms = timer(lambda: fa.flash_attention_backward_plain(
            q, k, v, out, lse, dout, window=window, causal=causal), iters=10)
        q2, k2, v2 = (torch.cat([t, t]) for t in (q, k, v))
        ms_2x = timer(lambda: fa.flash_attention(q2, k2, v2, window=window,
                                                 causal=causal,
                                                 return_lse=True))
        lib_ms_2x = timer(lambda: sdpa(q2, k2, v2))
        del q2, k2, v2, wmask
        b_ms, b_by = bound(*flash_attention_work(
            B, S, H, Hkv, D, D, causal=causal, window=window)[::-1])
        print(f"[flash] {label} (B={B}, S={S}, H={H}, Hkv={Hkv}, D={D}, "
              f"window {window}, causal={causal}): "
              f"max_abs_err={err:.3e} ({share:.2f} of the limit; lse "
              f"{lse_err:.2e}) "
              f"grad max_abs_err {g_err} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}); plain backward {bwd_ms:.4f} "
              f"ms; at {2 * B} rows kernel {ms_2x:.4f} ms, library "
              f"{lib_ms_2x:.4f} ms")
        row[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          backward_plain_ms=bwd_ms, grad_err=g_err,
                          limit_share=share, lse_err=lse_err, ms_2x=ms_2x,
                          library_ms_2x=lib_ms_2x)
        if label == "main":
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
        del q, k, v, out, lse, dout
    row[MLA_FLASH[0]] = flash_mla(torch, dev, timer)
    row["max_abs_err"] = max(row["max_abs_err"],
                             row[MLA_FLASH[0]]["max_abs_err"])
    return row


def wrappers():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.kernels import rwkv6_scan as rs
    from repro_torch.kernels import sampling
    return {"decode_attention": da.decode_attention,
            "paged_decode_attention": da.paged_decode_attention,
            "greedy_sample": sampling.greedy_sample,
            "flash_attention": fa.flash_attention,
            "topk_values": sampling.topk_values,
            "topk_mask": sampling.topk_mask,
            "rwkv6_scan": rs.rwkv6_scan,
            "mamba2_scan": ms.mamba2_scan}


def build(torch, dev, arch=ARCH):
    """The model of ``arch`` (an id, or a config such as a cut) and its
    random weights from seed 0 on ``dev``."""
    from repro_torch.models import build_model

    model = build_model(arch)
    cfg = model.cfg
    arch = cfg.name
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model},"
          f" vocab {cfg.vocab_size}, {n_params / 1e9:.3f}B params "
          f"({cfg.dtype}) initialised in {time.perf_counter() - t0:.1f}s")
    return model, params


def serve_prompts(vocab_size: int):
    """N_REQ prompts of 32-512 token ids from ``RandomState(0)``."""
    rs = np.random.RandomState(0)
    lens = rs.randint(32, 513, size=N_REQ)
    return [rs.randint(0, vocab_size, size=n).astype(np.int32)
            for n in lens]


def check_outputs(run, outs, n_req=N_REQ, max_new=MAX_NEW):
    """Every request finished, with 1..max_new tokens and finite
    log-probabilities <= 0."""
    if len(outs) != n_req or any(o.finish_reason not in ("length", "eos")
                                 for o in outs):
        raise AssertionError(f"{run}: unfinished requests")
    for o in outs:
        lp = np.asarray(o.logprobs)
        if not (1 <= o.num_tokens <= max_new and np.isfinite(lp).all()
                and (lp <= 1e-6).all()):
            raise AssertionError(f"{run}: rid {o.rid} output malformed")


def frontend_of(frontends, i, dev=None):
    """Request ``i``'s frontend from ``frontends`` (None when there are
    none), on ``dev`` when given."""
    if frontends is None:
        return None
    f = frontends[i]
    return f if dev is None else f.to(dev)


def phase_serve(torch, dev, model, params):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.serve import serve_continuous

    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    launches = {k: 0 for k in wrappers()}
    firsts, tokens, reports = {}, {}, {}
    for kv, kv_dtype in (("contiguous", None), ("paged", None),
                         ("paged", "int8")):
        run = kv + ("-int8" if kv_dtype else "")
        fns = wrappers()
        for f in fns.values():
            f.launches = 0
        rep = serve_continuous(ARCH, prompts, model=model, params=params,
                               max_new=MAX_NEW, num_slots=SLOTS, kv=kv,
                               kv_dtype=kv_dtype, max_seq_len=MAX_SEQ,
                               device=dev)
        counts = {k: f.launches for k, f in fns.items()}
        steps = rep["decode_steps"]
        outs = rep["outputs"]
        check_outputs(run, outs)
        want = serve_launches(cfg, counts, LAYOUT_ATTN[kv], steps,
                              rep["prefills"])
        if counts != want:
            raise AssertionError(f"{run}: launches {counts} != {want}")
        for k in launches:
            launches[k] += counts[k]
        firsts[run] = [o.tokens[0] for o in outs]
        tokens[run] = [o.tokens for o in outs]
        step_ms = rep["decode_time_s"] / max(steps, 1) * 1e3
        print(f"[serve] {run}: {N_REQ} requests, {rep['tokens']} tokens, "
              f"{steps} decode steps in {rep['wall_s']:.2f}s = "
              f"{rep['tok_per_s']:.1f} tok/s; {step_ms:.3f} ms per decode "
              f"step, {rep['wall_s'] - rep['decode_time_s']:.2f}s outside "
              f"decode (prefill, admission, {rep['captures']} CUDA graph "
              f"capture(s) in {rep['capture_s']:.3f}s); launches {counts}")
        if kv == "paged":
            recheck_pool(torch, dev, da, rep["engine"], run)
        reports[run] = {"tokens": rep["tokens"], "decode_steps": steps,
                        "wall_s": rep["wall_s"],
                        "decode_time_s": rep["decode_time_s"],
                        "ms_per_decode_step": step_ms,
                        "captures": rep["captures"],
                        "capture_s": rep["capture_s"],
                        "tok_per_s": rep["tok_per_s"], "launches": counts}
        del rep
    if not firsts["contiguous"] == firsts["paged"] == firsts["paged-int8"]:
        raise AssertionError(f"first generated tokens differ: {firsts}")
    for run in ("paged", "paged-int8"):
        same = total = 0
        for a, b in zip(tokens["contiguous"], tokens[run]):
            n = min(len(a), len(b))
            same += sum(x == y for x, y in zip(a[:n], b[:n]))
            total += n
        print(f"[serve] {run} agrees with contiguous on {same}/{total} "
              f"tokens ({same / max(total, 1):.4f})")
        reports[run]["token_agreement_with_contiguous"] = same / max(total,
                                                                    1)
    return launches, reports


GRAPH_REQ, GRAPH_NEW = 4, 32     # the graph-against-eager workload


def eager_engine(*args, **kw):
    """An engine whose ticks all run the decode block eagerly (its
    private ``_decode_block``): the reference a CUDA graph replay is held
    to.  A subclass made here, not a switch of the engine."""
    from repro_torch.serve.engine import Engine

    class EagerEngine(Engine):
        def _graph_for_tick(self):
            return None
    return EagerEngine(*args, **kw)


def serve_short(torch, dev, model, params, *, eager=False, kv="contiguous",
                kv_dtype=None, temperature=0.0, seed=0, engine=None,
                prompts=None, max_seq=MAX_SEQ, frontends=None):
    """The first GRAPH_REQ serve prompts (or of ``prompts``, with
    ``frontends``) at GRAPH_NEW new tokens through an engine of the serve
    phase's shape (``engine``, reset with ``params``, or a new one, eager
    or not); returns the outputs, the engine, the launch counts, ms per
    decode step and the wall time."""
    from repro_torch.rl.rollout import run_requests
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = EngineConfig(num_slots=SLOTS, max_seq_len=max_seq,
                       temperature=temperature, kv_layout=kv,
                       kv_dtype=kv_dtype)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if temperature > 0 else None)
    if engine is None:
        engine = (eager_engine if eager else Engine)(
            model, params, cfg, device=dev, generator=gen)
    else:
        engine.reset(params, gen)
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    if prompts is None:
        prompts = serve_prompts(model.cfg.vocab_size)
    prompts = prompts[:GRAPH_REQ]
    t0 = time.perf_counter()
    outs = run_requests(engine, (Request(rid=i, prompt=p,
                                         max_new_tokens=GRAPH_NEW,
                                         frontend=frontend_of(frontends, i))
                                 for i, p in enumerate(prompts)))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = engine.metrics()
    return {"outputs": outs, "engine": engine, "wall_s": wall,
            "launches": {k: f.launches for k, f in fns.items()},
            "steps": m.steps,
            "ms_per_step": m.decode_time_s / max(m.steps, 1) * 1e3}


def same_outputs(a, b, logprobs=True) -> bool:
    """Tokens (and log-probabilities) of two runs equal bit for bit."""
    return len(a) == len(b) and all(
        x.tokens == y.tokens and (not logprobs or np.array_equal(
            np.asarray(x.logprobs, np.float32),
            np.asarray(y.logprobs, np.float32)))
        for x, y in zip(a, b))


def graph_vs_eager(torch, dev, model, params, phase, run, **kw) -> dict:
    """The engine's CUDA-graph decode block against its eager block on the
    same workload: at temperature 0 tokens and log-probabilities equal
    bit for bit, above it (same seed) tokens; the same kernel launches
    (a replay adds what its capture recorded); one capture, none eager."""
    g = serve_short(torch, dev, model, params, **kw)
    e = serve_short(torch, dev, model, params, eager=True, **kw)
    sampled = kw.get("temperature", 0.0) > 0
    lp_equal = same_outputs(g["outputs"], e["outputs"])
    if not same_outputs(g["outputs"], e["outputs"], logprobs=not sampled):
        raise AssertionError(f"{phase} {run}: the CUDA graph's outputs "
                             f"differ from the eager block's")
    if g["launches"] != e["launches"] or g["steps"] != e["steps"]:
        raise AssertionError(f"{phase} {run}: launches {g['launches']} "
                             f"(graph) != {e['launches']} (eager)")
    ge, ee = g["engine"], e["engine"]
    if ge.captures != 1 or ee.captures != 0:
        raise AssertionError(f"{phase} {run}: {ge.captures} captures "
                             f"(graph), {ee.captures} (eager)")
    print(f"[{phase}] {run} graph vs eager ({GRAPH_REQ} requests, "
          f"{GRAPH_NEW} new tokens, {g['steps']} decode steps): "
          f"{'tokens and logprobs' if lp_equal else 'tokens'} identical; "
          f"{g['ms_per_step']:.3f} ms per decode step (graph; 1 capture in "
          f"{ge.capture_s:.3f}s) against {e['ms_per_step']:.3f} (eager); "
          f"launches {g['launches']}")
    res = {"identical_logprobs": lp_equal, "steps": g["steps"],
           "graph_ms_per_step": g["ms_per_step"],
           "eager_ms_per_step": e["ms_per_step"],
           "capture_s": ge.capture_s, "graph_wall_s": g["wall_s"],
           "eager_wall_s": e["wall_s"], "launches": g["launches"]}
    del g, e, ge, ee
    return res


def phase_graph(torch, dev, model, params) -> dict:
    """internlm2 through the CUDA graph against the eager block: greedy on
    contiguous, paged and paged-int8 KV, sampled (temperature 1, seed 0)
    on contiguous; then ``reset(params=...)`` to another seed's weights
    must serve what a new engine on those weights serves."""
    res = {}
    for kv, kv_dtype in (("contiguous", None), ("paged", None),
                         ("paged", "int8")):
        run = kv + ("-int8" if kv_dtype else "")
        res[run] = graph_vs_eager(torch, dev, model, params, "graph", run,
                                  kv=kv, kv_dtype=kv_dtype)
    res["contiguous-t1"] = graph_vs_eager(
        torch, dev, model, params, "graph", "contiguous, temperature 1",
        temperature=1.0)
    other = model.init(torch.Generator(device=dev).manual_seed(1))
    a = serve_short(torch, dev, model, params)
    eng = a["engine"]
    b = serve_short(torch, dev, model, other, engine=eng)
    fresh = serve_short(torch, dev, model, other)
    if not same_outputs(b["outputs"], fresh["outputs"]):
        raise AssertionError("graph: after reset(params=...) the engine "
                             "does not serve what a new engine on those "
                             "weights serves")
    if same_outputs(a["outputs"], b["outputs"], logprobs=False) \
            or eng.captures != 2:
        raise AssertionError(f"graph: reset(params=...) did not swap the "
                             f"weights into a new capture ({eng.captures} "
                             f"captures)")
    print(f"[graph] reset(params=<seed 1>): a new capture "
          f"({eng.captures} in {eng.capture_s:.3f}s), outputs identical to "
          f"a new engine's on those weights")
    res["reset"] = {"captures": eng.captures, "capture_s": eng.capture_s}
    del a, b, fresh, eng, other
    return res


def phase_trace(torch, dev, model, params, closed_rate: float) -> dict:
    """``run_trace`` in real time: the serve prompts at MAX_NEW new tokens
    through a contiguous engine of SLOTS slots, arriving as a Poisson
    process (``RandomState(0)``) at half ``closed_rate``, the request rate
    of the closed-loop contiguous serve run.  Every request finishes
    well formed with ``0 <= arrival < first token <= finish``; prints
    throughput, TTFT and latency (p50 and p99 computed here)."""
    from repro_torch.serve import Engine, EngineConfig, Request, run_trace

    rate = closed_rate / 2
    rs = np.random.RandomState(0)
    arrivals = np.cumsum(rs.exponential(1 / rate, N_REQ))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                    arrival_time=float(t))
            for i, (p, t) in enumerate(zip(serve_prompts(model.cfg.vocab_size),
                                           arrivals))]
    eng = Engine(model, params, EngineConfig(num_slots=SLOTS,
                                             max_seq_len=MAX_SEQ),
                 device=dev)
    rep = run_trace(eng, reqs, realtime=True)
    outs = rep["outputs"]
    check_outputs("trace", outs)
    for o in outs:
        if not 0 <= o.arrival_time < o.first_token_time <= o.finish_time:
            raise AssertionError(f"trace: rid {o.rid} stamps out of order")
    lat = np.array([o.finish_time - o.arrival_time for o in outs])
    ttft = np.array([o.first_token_time - o.arrival_time for o in outs])
    m = eng.metrics()
    res = {k: rep[k] for k in ("makespan_s", "tokens", "tok_per_s",
                               "ttft_mean_s", "latency_mean_s",
                               "latency_p95_s", "slot_utilization",
                               "peak_active")}
    res.update(rate_per_s=rate, arrivals=arrivals.tolist(),
               latency_p50_s=float(np.quantile(lat, 0.5)),
               latency_p99_s=float(np.quantile(lat, 0.99)),
               ttft_p50_s=float(np.quantile(ttft, 0.5)),
               ttft_p99_s=float(np.quantile(ttft, 0.99)),
               ms_per_step=m.decode_time_s / max(m.steps, 1) * 1e3,
               captures=eng.captures, capture_s=eng.capture_s)
    print(f"[trace] {ARCH} contiguous, {SLOTS} slots: {N_REQ} requests at "
          f"{rate:.3f}/s (half the closed loop's {closed_rate:.3f}/s), "
          f"{MAX_NEW} new tokens: {res['tokens']} tokens in "
          f"{res['makespan_s']:.2f}s = {res['tok_per_s']:.1f} tok/s; TTFT "
          f"mean {res['ttft_mean_s'] * 1e3:.1f} ms (p50 "
          f"{res['ttft_p50_s'] * 1e3:.1f}, p99 {res['ttft_p99_s'] * 1e3:.1f});"
          f" latency mean {res['latency_mean_s']:.3f}s, p50 "
          f"{res['latency_p50_s']:.3f}, p95 {res['latency_p95_s']:.3f}, p99 "
          f"{res['latency_p99_s']:.3f}; {res['ms_per_step']:.3f} ms per "
          f"decode step, {eng.captures} capture(s) in {eng.capture_s:.3f}s")
    del eng, rep, outs
    return res


ELASTIC_LADDER = (2, 4, 8)     # the elastic phase's slot ladder
ELASTIC_LADDER_16 = (4, 8, 16)  # its second ladder, across 16 slots
ELASTIC_GAP_16 = 0.02          # arrivals that push that ladder to 16
ELASTIC_GAP = 0.05             # seconds between its requests' arrivals
ELASTIC_CALM_GAP = 0.3         # arrivals the ladder absorbs (sub-saturation)
ELASTIC_TPT_GATE = 1.2         # elastic time per token over the static one


def pool_bytes(eng) -> int:
    """The bytes of an engine's cache leaves."""
    return sum(t.numel() * t.element_size() for t in eng.slots.cache.values())


def tick_split(ticks) -> dict:
    """ms per decode step by rung from ``(slots, first, seconds, steps)``
    ticks: ``{slots: {"first": (ms, steps), "replays": (ms, steps)}}``,
    ``first`` the engines' first ticks with work (their capture precedes
    the timed window)."""
    acc: dict = {}
    for slots, first, dt, n in ticks:
        d = acc.setdefault(slots, {"first": [0.0, 0], "replays": [0.0, 0]})
        d["first" if first else "replays"][0] += dt
        d["first" if first else "replays"][1] += n
    return {slots: {k: (t / n * 1e3 if n else None, n)
                    for k, (t, n) in d.items()}
            for slots, d in sorted(acc.items())}


def split_line(split: dict) -> str:
    return "; ".join(
        f"{slots} slots: replays " + (f"{r[0]:.3f} ({r[1]} steps)" if r[1]
                                      else "none")
        + ", first ticks " + (f"{f[0]:.3f} ({f[1]})" if f[1] else "none")
        for slots, d in split.items()
        for r, f in [(d["replays"], d["first"])])


def phase_elastic(torch, dev, model, params) -> tuple:
    """Elastic serving at full width: the serve prompts arriving
    ELASTIC_GAP apart through ``serve_elastic`` (``run_trace(realtime=
    False)`` with an ``ElasticController`` on the ladder ELASTIC_LADDER,
    paged bf16, starting on its first rung) against a static engine of
    SLOTS slots: tokens bit for bit, no shed, at least one resize, the
    capacity log the resize log's; each resize's host seconds (suspend
    all, build, resume), each engine's one capture, warm before its first
    tick; device memory after the run within one pool of a single engine
    of the last rung; each tick's decode time by rung, first ticks apart.
    Then admission armed at the launcher's 2 s deadline on arrivals
    ELASTIC_CALM_GAP apart: no shed, no degrade, tokens bit for bit.  Then
    the first trace with admission armed and a deadline that degrades:
    degraded requests exact prefixes of the static run, every shed
    recorded.  Then a router of PD_PREFILL + PD_DECODE
    slots resized mid-run against a monolithic engine of PD_DECODE
    slots, bit for bit."""
    from repro_torch.launch.serve import serve_elastic
    from repro_torch.serve import (DisaggConfig, DisaggRouter, Engine,
                                   EngineConfig, Request, RolloutSpec)
    from repro_torch.serve import elastic

    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    spec = RolloutSpec(kv_layout="paged")
    fns = wrappers()
    total = {k: 0 for k in fns}
    res = {}
    gc.collect()
    base = torch.cuda.memory_allocated()
    static = Engine(model, params, EngineConfig(
        num_slots=SLOTS, max_seq_len=MAX_SEQ, kv_layout="paged"), device=dev)
    static.warm_up()        # its time per token counts replays only too
    for f in fns.values():
        f.launches = 0
    ref, swall, _ = drive(torch, static, prompts)
    sm = static.metrics()
    static_tpt = sm.decode_time_s / max(sm.steps, 1)
    single = torch.cuda.memory_allocated() - base
    pool = pool_bytes(static)
    for k, f in fns.items():
        total[k] += f.launches
    del static
    gc.collect()
    resizes, retired, ticks = [], [], []
    original = elastic.resize_engine
    step = Engine.step

    def timed_step(engine):
        """Engine.step, recording each tick's slots, whether it is its
        engine's first with work, its decode seconds and steps."""
        s = engine._stats
        t, n = s.decode_time_s, s.steps
        first = engine._graph is None       # it captures on this tick
        done = step(engine)
        if s.steps > n:
            ticks.append((engine.config.num_slots, first,
                          s.decode_time_s - t, s.steps - n))
        return done

    def timed_resize(engine, num_slots, **kw):
        t = {}
        retired.append((engine.config.num_slots, engine.captures,
                        engine.capture_s))
        t0 = time.perf_counter()
        new = original(engine, num_slots, timings=t, **kw)
        t.update(total_s=time.perf_counter() - t0,
                 slots=(engine.config.num_slots, num_slots),
                 live=new.num_active)
        if new._warm != (dev.type == "cuda") or new.captures:
            raise AssertionError("elastic: a resized engine must be warm, "
                                 "with no capture, before its first tick")
        resizes.append(t)
        return new

    def run(shed=False, deadline_s=2.0, gap=ELASTIC_GAP,
            ladder=ELASTIC_LADDER):
        resizes.clear()
        retired.clear()
        ticks.clear()
        for f in fns.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        elastic.resize_engine = timed_resize
        Engine.step = timed_step
        try:
            rep = serve_elastic(ARCH, prompts, model=model, params=params,
                                max_new=MAX_NEW, spec=spec,
                                ladder=ladder, shed=shed,
                                deadline_s=deadline_s, arrival_gap_s=gap,
                                max_seq_len=MAX_SEQ, device=dev)
        finally:
            elastic.resize_engine = original
            Engine.step = step
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in fns.items()}
        for k in total:
            total[k] += counts[k]
        eng = rep["engine"]
        m = eng.metrics()
        # each engine's warm-up runs the block once on its empty pool (on
        # the card; elsewhere it is a no-op)
        warm = (1 + len(resizes)) * int(dev.type == "cuda")
        want = serve_launches(cfg, counts, "paged_decode_attention",
                              m.steps + warm, m.prefills - m.adoptions)
        if counts != want:
            raise AssertionError(f"elastic: launches {counts} != {want}")
        retired.append((eng.config.num_slots, eng.captures, eng.capture_s))
        if any(c != int(dev.type == "cuda") for _, c, _ in retired):
            raise AssertionError(f"elastic: captures per engine {retired}")
        return rep, eng, counts, torch.cuda.max_memory_allocated() - base

    rep, eng, counts, peak = run()
    e = rep["elastic"]
    outs = rep["outputs"]
    check_outputs("elastic", outs)
    if not same_outputs(outs, ref, logprobs=False):
        bad = [o.rid for o, r in zip(outs, ref) if o.tokens != r.tokens]
        raise AssertionError(f"elastic: tokens differ from the static "
                             f"engine's for rids {bad}")
    lp_same = same_outputs(outs, ref)
    lp_diff = max(float(np.abs(np.asarray(o.logprobs)
                               - np.asarray(r.logprobs)).max())
                  for o, r in zip(outs, ref))
    if e["sheds"] or e["resizes"] < 1 or \
            [c[1] for c in e["capacity_log"][1:]] != \
            [r[2] for r in e["resize_log"]] or \
            e["capacity_log"][0][1] != ELASTIC_LADDER[0]:
        raise AssertionError(f"elastic: sheds {e['sheds']}, resize log "
                             f"{e['resize_log']}, capacity log "
                             f"{e['capacity_log']}")
    m = eng.metrics()
    tpt = m.decode_time_s / max(m.steps, 1)
    if tpt > ELASTIC_TPT_GATE * static_tpt:
        raise AssertionError(f"elastic: {tpt * 1e3:.3f} ms per decode step "
                             f"against the static {static_tpt * 1e3:.3f}")
    gc.collect()
    held = torch.cuda.memory_allocated() - base
    if held > single + pool_bytes(eng):
        raise AssertionError(
            f"elastic: {held / 2 ** 30:.2f} GiB held after "
            f"{len(resizes)} resizes, a single engine of {SLOTS} slots "
            f"{single / 2 ** 30:.2f} GiB (+ one pool "
            f"{pool_bytes(eng) / 2 ** 30:.2f})")
    for r in resizes:
        print(f"[elastic] resize {r['slots'][0]} -> {r['slots'][1]} slots "
              f"({r['live']} live): host s suspend {r['suspend_s']:.4f}, "
              f"build {r['build_s']:.4f}, resume {r['resume_s']:.4f}, "
              f"total {r['total_s']:.4f}")
    print(f"[elastic] {ARCH} paged bf16, ladder {ELASTIC_LADDER}, arrivals "
          f"{ELASTIC_GAP}s apart: tokens bit for bit with a static engine "
          f"of {SLOTS} slots (logprobs "
          f"{'bit for bit' if lp_same else f'max |diff| {lp_diff:.3e}'}); "
          f"sheds 0; {e['resizes']} resizes {e['resize_log']}; "
          f"capacity_seconds_ratio {e['capacity_seconds_ratio']:.4f} "
          f"({e['capacity_seconds']:.3f} of {e['static_capacity_seconds']:.3f}"
          f" slot-s); {rep['tok_per_s']:.1f} tok/s in "
          f"{rep['makespan_s']:.2f}s (static {swall:.2f}s); "
          f"{tpt * 1e3:.3f} ms per decode step (static "
          f"{static_tpt * 1e3:.3f}); captures per engine (slots, n, host s) "
          f"{retired}; peak memory {peak / 2 ** 30:.2f} GiB over the "
          f"weights, {held / 2 ** 30:.2f} GiB held after the run (a single "
          f"{SLOTS}-slot engine {single / 2 ** 30:.2f}, its pool "
          f"{pool / 2 ** 30:.2f}); launches {counts}")
    split = tick_split(ticks)
    print(f"[elastic] ms per decode step by rung, each engine's first tick "
          f"apart: {split_line(split)} (static {SLOTS} slots "
          f"{static_tpt * 1e3:.3f})")
    res["grow"] = {
        "elastic": {k: v for k, v in e.items() if k not in (
            "shed_records", "degrade_records")},
        "resizes": list(resizes), "captures": list(retired),
        "tok_per_s": rep["tok_per_s"], "makespan_s": rep["makespan_s"],
        "static_wall_s": swall, "ms_per_step": tpt * 1e3,
        "static_ms_per_step": static_tpt * 1e3, "logprobs_identical": lp_same,
        "max_logprob_diff": lp_diff, "peak_bytes": peak,
        "held_bytes": held, "single_engine_bytes": single,
        "pool_bytes": pool, "launches": counts, "by_rung": split}
    del rep, eng, outs
    res["grow16"] = ladder16(torch, dev, model, params, prompts, ref,
                             static_tpt, run, resizes, ticks, total)
    # admission armed at the launcher's deadline, at arrivals the ladder
    # absorbs: a warm or resized engine's time per token must not shed
    rep, eng, counts, _ = run(shed=True, deadline_s=2.0,
                              gap=ELASTIC_CALM_GAP)
    e = rep["elastic"]
    outs = rep["outputs"]
    check_outputs("elastic calm", outs)
    if e["sheds"] or e["degrades"] or not same_outputs(outs, ref,
                                                       logprobs=False):
        raise AssertionError(f"elastic calm: {e['sheds']} sheds, "
                             f"{e['degrades']} degrades at arrivals "
                             f"{ELASTIC_CALM_GAP}s apart, or tokens differ "
                             f"from the static run")
    m = eng.metrics()
    split = tick_split(ticks)
    print(f"[elastic] admission armed, deadline 2.0s after arrival, "
          f"arrivals {ELASTIC_CALM_GAP}s apart: 0 shed, 0 degraded, tokens "
          f"bit for bit with the static run; {e['resizes']} resizes "
          f"{e['resize_log']}; capacity_seconds_ratio "
          f"{e['capacity_seconds_ratio']:.4f}; "
          f"{m.decode_time_s / max(m.steps, 1) * 1e3:.3f} ms per decode "
          f"step ({split_line(split)})")
    res["calm"] = {"gap_s": ELASTIC_CALM_GAP, "resizes": e["resizes"],
                   "resize_log": e["resize_log"],
                   "capacity_seconds_ratio": e["capacity_seconds_ratio"],
                   "by_rung": split, "launches": counts}
    del rep, eng, outs
    # admission armed, a deadline that degrades at the static time per token
    deadline_s = 0.6 * MAX_NEW * static_tpt
    rep, eng, counts, peak = run(shed=True, deadline_s=deadline_s)
    e = rep["elastic"]
    done = {o.rid: o for o in rep["outputs"]}
    shed = {r["rid"] for r in e["shed_records"]}
    clamp = {r["rid"]: r["to"] for r in e["degrade_records"]}
    if e["degrades"] < 1 or shed & set(done) or \
            shed | set(done) != set(range(N_REQ)) or e["sheds"] != len(shed):
        raise AssertionError(f"elastic shed: {e['degrades']} degrades, sheds "
                             f"{sorted(shed)}, served {sorted(done)}")
    for rid, o in done.items():
        n = clamp.get(rid, MAX_NEW)
        if o.tokens != ref[rid].tokens[:n]:
            raise AssertionError(f"elastic shed: rid {rid} (budget {n}) is "
                                 f"not a prefix of the static run")
    print(f"[elastic] admission armed, deadline {deadline_s:.3f}s after "
          f"arrival: {e['degrades']} degraded (budgets "
          f"{sorted(clamp.values())}), each an exact prefix of the static "
          f"run; {e['sheds']} shed, each recorded; {len(done)} served; "
          f"{e['resizes']} resizes; class counts {e['class_counts']}")
    res["shed"] = {"deadline_s": deadline_s, "degrades": e["degrades"],
                   "sheds": e["sheds"], "budgets": clamp,
                   "resizes": e["resizes"], "launches": counts}
    del rep, eng, done
    # a router resized in the middle of its run
    mono = Engine(model, params, EngineConfig(
        num_slots=PD_DECODE, max_seq_len=MAX_SEQ, kv_layout="paged"),
        device=dev)
    for f in fns.values():
        f.launches = 0
    mref, _, _ = drive(torch, mono, prompts)
    del mono
    router = DisaggRouter(model, params, DisaggConfig(
        prefill_slots=PD_PREFILL, decode_slots=PD_DECODE,
        max_seq_len=MAX_SEQ, kv_layout="paged"), device=dev)
    for i, p in enumerate(prompts):
        router.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    for _ in range(MAX_NEW // 2):
        router.step()
    live = router.decode.num_active
    t0 = time.perf_counter()
    router = elastic.resize_router(router, decode_slots=SLOTS,
                                   prefill_slots=PD_PREFILL + 1)
    rs_s = time.perf_counter() - t0
    outs = router.run()
    torch.cuda.synchronize()
    for k, f in fns.items():
        total[k] += f.launches
    if not same_outputs(outs, mref):
        raise AssertionError("elastic: the resized router differs from the "
                             "monolithic engine")
    print(f"[elastic] router {PD_PREFILL}+{PD_DECODE} resized to "
          f"{PD_PREFILL + 1}+{SLOTS} after {MAX_NEW // 2} ticks ({live} "
          f"live) in {rs_s:.4f} host s: bit for bit with a monolithic "
          f"engine of {PD_DECODE} slots; {router.decode.captures} decode "
          f"capture(s)")
    res["router"] = {"resize_s": rs_s, "live": live}
    router.reset()
    del router, outs
    return total, res


def ladder16(torch, dev, model, params, prompts, ref, static_tpt, run,
             resizes, ticks, total) -> dict:
    """The elastic phase's second ladder, ELASTIC_LADDER_16 (paged bf16,
    arrivals ELASTIC_GAP_16 apart, so that it reaches 16 slots), and a
    static engine of 16 slots, each against the static engine of SLOTS
    slots (``ref``): the divergent requests (tokens, and logprobs bit for
    bit) and their top-2 gaps; every run must equal ``ref`` bit for bit.
    ms per decode step by rung and of both static engines."""
    from repro_torch.serve import Engine, EngineConfig

    static = Engine(model, params, EngineConfig(
        num_slots=16, max_seq_len=MAX_SEQ, kv_layout="paged"), device=dev)
    static.warm_up()
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    ref16, _, _ = drive(torch, static, prompts)
    add_counts(total, {k: f.launches for k, f in fns.items()})
    sm = static.metrics()
    tpt16 = sm.decode_time_s / max(sm.steps, 1)
    del static
    rep, eng, counts, _ = run(gap=ELASTIC_GAP_16, ladder=ELASTIC_LADDER_16)
    e = rep["elastic"]
    outs = rep["outputs"]
    check_outputs("elastic 16", outs)
    top = max(c[1] for c in e["capacity_log"])
    res = {"ladder": ELASTIC_LADDER_16, "gap_s": ELASTIC_GAP_16,
           "resize_log": e["resize_log"], "largest_rung": top,
           "by_rung": tick_split(ticks), "resizes": list(resizes),
           "static16_ms_per_step": tpt16 * 1e3,
           "static_ms_per_step": static_tpt * 1e3}
    bad = []
    for name, got in (("static 16", ref16), ("elastic 4/8/16", outs)):
        tok = [o.rid for o, r in zip(got, ref) if o.tokens != r.tokens]
        lp = [o.rid for o, r in zip(got, ref) if not np.array_equal(
            np.asarray(o.logprobs, np.float32),
            np.asarray(r.logprobs, np.float32))]
        d = divergence(torch, dev, model, params, got, ref)
        res[name] = {"tokens_differ": tok, "logprobs_differ": lp,
                     "diverged": d["diverged"],
                     "max_abs_diff": d["max_abs_diff"]}
        print(f"[elastic] {name} against the static {SLOTS}-slot engine: "
              f"{len(tok)} of {N_REQ} requests with other tokens {tok}, "
              f"{len(lp)} with other logprobs; (rid: position, top-2 gap) "
              + (", ".join(f"{k}: {v['at']}, {v['top2_gap']:.4f}"
                           for k, v in d["diverged"].items()) or "none")
              + f"; max |logprob diff| before any divergence "
              f"{d['max_abs_diff']:.4e}")
        if tok or lp:
            bad.append(name)
    print(f"[elastic] ladder {ELASTIC_LADDER_16}, arrivals {ELASTIC_GAP_16}s "
          f"apart: largest rung {top}, {e['resizes']} resizes "
          f"{e['resize_log']}; ms per decode step by rung: "
          f"{split_line(res['by_rung'])}; static 16 slots "
          f"{tpt16 * 1e3:.3f}, static {SLOTS} {static_tpt * 1e3:.3f}")
    if bad or top != ELASTIC_LADDER_16[-1]:
        raise AssertionError(f"elastic 16: {bad} not bit for bit with the "
                             f"static {SLOTS}-slot engine, or the ladder "
                             f"topped at {top}")
    del rep, eng, outs, ref16
    return res


def token_share_reward(vocab_size: int):
    """Row-wise verifier for the train phase: the share of a row's
    recorded tokens in the lower half of the vocabulary.  A randomly
    initialised full-vocabulary model earns 0 from the arithmetic verifier
    on every row (its samples are almost never byte tokens), which makes
    every GRPO advantage, and so every gradient, exactly 0; this reward
    differs from row to row, so the step has something to learn."""
    def reward(completions, mask, answers):
        comp, m = np.asarray(completions), np.asarray(mask)
        low = ((comp < vocab_size // 2) * m).sum(1)
        return (low / np.maximum(m.sum(1), 1)).astype(np.float32)
    return reward


def phase_train(torch, dev, model, params):
    from repro_torch.launch.train import run_training

    cfg = model.cfg
    watch = {"embed": params["embed"], "lm_head": params["lm_head"],
             "layer0.wq": params["layers"][0]["attn"]["wq"],
             "layer23.mlp.wo": params["layers"][-1]["mlp"]["wo"]}
    before = {n: t.clone() for n, t in watch.items()}
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist, report = run_training(
        ARCH, model=model, params=params, steps=2, batch=4, group=4,
        max_new=MAX_NEW, temperature=1.0, rollout="engine",
        reward_fn=token_share_reward(cfg.vocab_size),
        device=dev, log_every=1, return_report=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    steps = sum(r["decode_steps"] for r in hist)
    prefills = sum(r["prefills"] for r in hist)
    want = {k: 0 for k in counts}
    want["decode_attention"] = cfg.num_layers * steps
    want["flash_attention"] = cfg.num_layers * (prefills + 2 * len(hist))
    if len(hist) != 2 or prefills != 2 * 16 or counts != want:
        raise AssertionError(f"train: launches {counts} != {want} "
                             f"({len(hist)} iterations, {prefills} "
                             f"prefills)")
    for r in hist:
        if not all(np.isfinite(r[k]) for k in ("loss", "grad_norm",
                                                "entropy", "reward")) \
                or r["grad_norm"] <= 0 or r["tokens"] < 1:
            raise AssertionError(f"train: iteration {r['step']} malformed: "
                                 f"{r}")
        # the trainer's forward (flash attention) and the engine's decode
        # (decode attention) score the sampled tokens alike: the masked
        # mean of exp(logp - behaviour logp) is 1 up to bf16 rounding
        if abs(r["ratio_mean"] - 1) > 1e-2:
            raise AssertionError(f"train: iteration {r['step']}: policy and "
                                 f"behaviour logprobs disagree, ratio_mean "
                                 f"{r['ratio_mean']}")
    moved = {n: not torch.equal(before[n], t) for n, t in watch.items()}
    if not all(moved.values()):
        raise AssertionError(f"train: weights did not move: {moved}")
    if not all(torch.isfinite(t).all() for t in watch.values()):
        raise AssertionError("train: non-finite weights after the step")
    s = report.summary()
    roll = [t1 - t0_ for _, t0_, t1 in report.timelines["rollout"]]
    train = [t1 - t0_ for _, t0_, t1 in report.timelines["train"]]
    positions = 4 * 4 * (16 + MAX_NEW - 1)      # rows x trained positions
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] {ARCH}: 2 GRPO iterations in {wall:.2f}s; rollout "
          f"busy {s['total_rollout_s']:.2f}s {roll}, train busy "
          f"{s['total_train_s']:.2f}s {train}; {positions} positions per "
          f"step, {positions * len(train) / s['total_train_s']:.1f} "
          f"training tokens/s; peak memory {peak / 2 ** 30:.2f} GiB; "
          f"launches {counts}")
    for r in hist:
        print(f"[train] iteration {r['step']}: loss={r['loss']:.6f} "
              f"grad_norm={r['grad_norm']:.4f} entropy={r['entropy']:.4f} "
              f"reward={r['reward']:.4f} ratio_mean={r['ratio_mean']:.6f} "
              f"ratio_max={r['ratio_max']:.4f} tokens={r['tokens']} "
              f"decode_steps={r['decode_steps']}")
    del state
    return counts, {"wall_s": wall, "rollout_s": roll, "train_s": train,
                    "positions_per_step": positions,
                    "train_tokens_per_s": positions * len(train)
                    / s["total_train_s"],
                    "max_memory_allocated": peak, "history": hist,
                    "launches": counts}


STATIC_REQ, STATIC_NEW = 8, 32     # the serve-static phase's batch
ROOF_ROWS = 16                     # the GRPO train step's rows (4 x 4)
ROOF_PREFILL = 512                 # the roofline phase's prefill length


def phase_serve_static(torch, dev, model, params):
    """``serve_batch`` (the static entry point) on the serve phase's
    weights: STATIC_REQ prompts x STATIC_NEW new tokens, at temperature 0
    (launches exact: flash once a layer for the one prefill, decode
    attention once a layer a step, greedy once a step) and at the
    launcher's 0.8; each run's tokens equal to ``generate``'s on the same
    encoded prompts with the same generator seed."""
    from repro_torch.launch.serve import _encode_prompts, serve_batch
    from repro_torch.rl import SamplerConfig, generate

    cfg = model.cfg
    texts = [f"{37 * i}+{11 * i + 5}=" for i in range(STATIC_REQ)]
    fns = wrappers()
    total = {k: 0 for k in fns}
    res = {}
    for temp in (0.0, 0.8):
        for f in fns.values():
            f.launches = 0
        rep = serve_batch(ARCH, texts, max_new=STATIC_NEW, temperature=temp,
                          seed=0, device=dev, model=model, params=params)
        counts = {k: f.launches for k, f in fns.items()}
        want = {k: 0 for k in counts}
        want["flash_attention"] = cfg.num_layers
        want["decode_attention"] = cfg.num_layers * STATIC_NEW
        want["greedy_sample"] = STATIC_NEW if temp == 0 else 0
        if counts != want:
            raise AssertionError(f"serve-static at temperature {temp}: "
                                 f"launches {counts} != {want}")
        add_counts(total, counts)
        prompts, _ = _encode_prompts(model, texts, dev)
        ref = generate(model, params, prompts,
                       SamplerConfig(max_new_tokens=STATIC_NEW,
                                     temperature=temp),
                       generator=torch.Generator(device=dev).manual_seed(0))
        if not (torch.equal(rep["completions"], ref["completions"].cpu())
                and torch.equal(rep["mask"], ref["mask"].cpu())):
            raise AssertionError(f"serve-static at temperature {temp}: "
                                 f"tokens differ from generate's")
        lp = float((rep["logprobs"] - ref["behavior_logp"].cpu()).abs()
                   .max())
        print(f"[serve-static] temperature {temp}: {STATIC_REQ} requests x "
              f"{STATIC_NEW} tokens, {rep['tokens']} tokens in "
              f"{rep['wall_s']:.3f}s = {rep['tok_per_s']:.1f} tok/s "
              f"({card_line()}); tokens equal to generate's (max |logprob "
              f"diff| {lp:.3e}); launches {counts}")
        res[f"temperature_{temp}"] = {
            "tokens": rep["tokens"], "wall_s": rep["wall_s"],
            "tok_per_s": rep["tok_per_s"], "logprob_diff": lp,
            "launches": counts}
        del rep, ref
    return total, res


def _event_s(torch, fn, reps: int) -> float:
    """Median CUDA-event seconds of ``fn()`` over ``reps`` runs, after one
    unmeasured run."""
    fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 1e3)
    return float(np.median(times))


def phase_roofline(torch, dev, model, params, train=None, serve=None):
    """The cost walk (``launch/cost.py``) of three internlm2 steps on meta
    tensors, each beside the same step on the card: the GRPO train step
    (ROOF_ROWS rows x 16 + MAX_NEW - 1 positions, remat, AdamW, on a copy
    of the weights), one decode step of SLOTS slots at position MAX_SEQ / 2
    with its greedy sampling, one prefill of ROOF_PREFILL ids.  For each:
    the walk's FLOPs and bytes, its compute and memory terms at the H100's
    rates (``launch.roofline``), ``model_flops_for``, the card's
    CUDA-event seconds of the step and ``mfu = model_flops / (seconds x
    989e12)``; the walk's kernel launches must equal the card's launch
    counters for the step.  The train and serve phases' own seconds
    (``train``, ``serve``), where given, are printed beside."""
    from repro_torch.configs import InputShape
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.launch.cost import analyze_step
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops_for
    from repro_torch.rl.train_step import make_train_step
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             warmup_cosine)

    cfg = model.cfg
    fns = wrappers()
    abstract = model.init_abstract()
    S = 16 + MAX_NEW - 1
    opt_cfg = AdamWConfig(lr=3e-4)
    step = make_train_step(model, opt_cfg,
                           lr_schedule=warmup_cosine(opt_cfg.lr, 10, 2))

    def train_batch(device):
        g = torch.Generator(device=device).manual_seed(5) \
            if device != "meta" else None

        def ids():
            if g is None:
                return torch.empty((ROOF_ROWS, S), dtype=torch.int32,
                                   device=device)
            return torch.randint(0, cfg.vocab_size, (ROOF_ROWS, S),
                                 generator=g, device=device,
                                 dtype=torch.int32)

        def f32(fill):
            return torch.full((ROOF_ROWS, S), fill, dtype=torch.float32,
                              device=device)
        return {"tokens": ids(), "labels": ids(), "loss_mask": f32(1.0),
                "advantages": f32(0.5), "behavior_logp": f32(-3.0)}

    def decode(p, token, cache):
        logits, _ = model.kernel_decode_step(p, token, cache)
        return greedy_sample(logits)

    def decode_args(p, device):
        cache = model.init_cache(SLOTS, MAX_SEQ, device=device)
        cache["index"] = torch.full((SLOTS,), MAX_SEQ // 2,
                                    dtype=torch.int32, device=device)
        return (p, torch.zeros((SLOTS, 1), dtype=torch.int32,
                               device=device), cache)

    def prefill_args(p, device):
        return (p, torch.zeros((1, ROOF_PREFILL), dtype=torch.int32,
                               device=device),
                model.init_cache(1, ROOF_PREFILL, device=device))

    cases = {
        "train": (lambda st, b: step(st, b),
                  ({"params": abstract, "opt": adamw_init(abstract)},
                   train_batch("meta")),
                  InputShape("grpo", S, ROOF_ROWS, "train")),
        "decode": (decode, decode_args(abstract, "meta"),
                   InputShape("decode", MAX_SEQ, SLOTS, "decode")),
        "prefill": (model.prefill, prefill_args(abstract, "meta"),
                    InputShape("prefill", ROOF_PREFILL, 1, "prefill")),
    }
    res, total = {}, {k: 0 for k in fns}
    for name, (fn, meta_args, shape) in cases.items():
        t0 = time.perf_counter()
        costs = analyze_step(fn, *meta_args)
        walk_s = time.perf_counter() - t0
        # the same step on the card, its launches counted
        if name == "train":
            copy = _tree_map(lambda t: t.clone(), params)
            state = {"params": copy, "opt": adamw_init(copy)}
            batch = train_batch(dev)
            args = (state, batch)
            reps = 2
        elif name == "decode":
            args, reps = decode_args(params, dev), 10
        else:
            args, reps = prefill_args(params, dev), 5
        torch.cuda.synchronize()
        for f in fns.values():
            f.launches = 0
        with torch.no_grad() if name != "train" \
                else contextlib.nullcontext():
            fn(*args)
            torch.cuda.synchronize()
            card = {k: f.launches for k, f in fns.items()}
            secs = _event_s(torch, lambda: fn(*args), reps)
        add_counts(total, {k: f.launches for k, f in fns.items()})
        walked = {k: costs.kernel_launches.get(k, 0) for k in card}
        if walked != card:
            raise AssertionError(f"roofline {name}: the walk's launches "
                                 f"{walked} != the card's {card}")
        mf = model_flops_for(cfg, shape)
        compute_s = costs.flops / PEAK_FLOPS
        memory_s = costs.bytes / HBM_BPS
        mfu = mf / (secs * PEAK_FLOPS)
        beside = ""
        if name == "train" and train:
            phase_s = float(np.mean(train["train_s"]))
            beside = (f"; the train phase's train seconds per iteration "
                      f"{phase_s:.4f} (mfu {mf / (phase_s * PEAK_FLOPS):.4f})")
        if name == "decode" and serve:
            phase_s = serve["contiguous"]["ms_per_decode_step"] / 1e3
            beside = (f"; the serve phase's CUDA-graph decode step "
                      f"{phase_s * 1e3:.4f} ms (mfu "
                      f"{mf / (phase_s * PEAK_FLOPS):.4f})")
        print(f"[roofline] {name} {shape.global_batch} x {shape.seq_len}: "
              f"walk flops={costs.flops:.4e} (products "
              f"{costs.product_flops:.4e}, kernels {costs.kernel_flops:.4e})"
              f" bytes={costs.bytes:.4e} peak live={costs.peak_bytes:.4e}; "
              f"compute_s={compute_s:.4e} memory_s={memory_s:.4e} "
              f"(bound {max(compute_s, memory_s):.4e}); model_flops="
              f"{mf:.4e}; measured_s={secs:.4e} "
              f"({max(compute_s, memory_s) / secs:.3f} of the bound); "
              f"mfu={mfu:.4f}{beside}; launches walk {walked} == card; "
              f"walk {walk_s:.1f}s ({card_line()})")
        res[name] = {"flops": costs.flops, "bytes": costs.bytes,
                     "product_flops": costs.product_flops,
                     "kernel_flops": costs.kernel_flops,
                     "peak_bytes": costs.peak_bytes, "compute_s": compute_s,
                     "memory_s": memory_s, "model_flops": mf,
                     "measured_s": secs, "mfu": mfu, "launches": card,
                     "walk_s": walk_s}
        del args
    return total, res


# ---------------------------------------------------------------------------
# suspend/resume, agentic episodes, partial-rollout carry, static generate
# ---------------------------------------------------------------------------
STOP_FROM = 40         # a request's stop token: new in its run from here on
HOLD_TICKS = 8         # ticks a handle stays suspended before its resume
TOOL_LEN = 16          # tokens of a tool's reply
REPLAY_TOL = 5e-2      # |logprob| drift of a tail resumed from a replayed
#                        boundary (batch-1 products round unlike batch 8's)
INT8_TOL = 2e-3        # int8: the tail block quantized again
INJECT_TOL = 1e-3      # float32: logits after injection against a prefill
AGENT_EPISODES, AGENT_TURNS = 32, 2
CARRY_REQ, CARRY_NEW, CARRY_TICKS = 8, 64, 16
RECURRENT_REQ, RECURRENT_NEW = 4, 32


def timed_engine(*args, **kw):
    """An engine that records the host seconds of each suspension in
    ``suspend_s`` (a subclass made here, as :func:`eager_engine`)."""
    from repro_torch.serve.engine import Engine

    class TimedEngine(Engine):
        def _suspend_slot(self, slot, **kws):
            t0 = time.perf_counter()
            try:
                return super()._suspend_slot(slot, **kws)
            finally:
                self.suspend_s.append(time.perf_counter() - t0)
    eng = TimedEngine(*args, **kw)
    eng.suspend_s = []
    return eng


def pick_stops(outs, block_size, start=None):
    """Per rid, ``(token, position)``: the first token at ``position >=
    start`` that the request's uninterrupted run has not emitted before
    (so the suspension fires there), with a token after it.  At
    ``block_size > 1`` even rids stop at a decode block's last step (the
    boundary logits are carried) and odd rids inside a block (they are
    replayed at resume)."""
    start = STOP_FROM if start is None else start
    stops = {}
    for o in outs:
        for j in range(start, o.num_tokens - 1):
            t = o.tokens[j]
            if t in o.tokens[:j]:
                continue
            if block_size > 1 and ((j + 1) % block_size == 0) != \
                    (o.rid % 2 == 0):
                continue
            stops[o.rid] = (t, j)
            break
    return stops


def pinned_copy(torch, eng, sreq):
    """The contents of a paged handle's pinned blocks (and int8 scales)."""
    return blocks_copy(torch, eng, sreq.block_ids)


def drive_suspended(torch, eng, reqs, *, tool=None, plant=None,
                    max_new=None):
    """Serve ``reqs`` (with stop tokens) through ``eng``: each suspended
    handle sits HOLD_TICKS loop passes (engine ticks while work is live), its
    pinned blocks are then held to their contents at suspension, and it is
    resumed with ``tool(sreq)`` tokens (none by default), no stop tokens
    and the rest of its budget, as rid ``1000 + rid``.  ``plant`` names a
    rid whose handle is resumed with its index off by one (the planted
    fault).  Returns ``{rid: (tokens, logprobs, logits_valid or None)}``
    over both turns, the resume host seconds and ``(logits after
    injection, history + tool)`` per resumed rid."""
    from collections import deque

    max_new = MAX_NEW if max_new is None else max_new
    pending = deque(reqs)
    held, first, done, resume_s, injected = [], {}, {}, [], {}
    moved = []
    while pending or not eng.idle or held:
        while pending and eng.submit(pending[0]):
            pending.popleft()
        if not eng.idle:
            eng.step()
        for h in eng.harvest_suspended():
            snap = pinned_copy(torch, eng, h) if eng.paged else None
            held.append([HOLD_TICKS, h, snap])
        for o in eng.harvest():
            done[o.rid] = o
        still = []
        for item in held:
            item[0] -= 1
            h, snap = item[1], item[2]
            n0 = len(h.out.tokens)
            tt = np.zeros((0,), np.int32) if tool is None else tool(h)
            if item[0] > 0 or not eng.can_resume(
                    h, tt, max_new_tokens=max_new - n0):
                still.append(item)
                continue
            if snap is not None:
                now = pinned_copy(torch, eng, h)
                moved += [name for name in snap
                          if not torch.equal(snap[name], now[name])]
            if h.req.rid == plant:
                h.index -= 1
            rid = h.req.rid
            first[rid] = (h.out.tokens, h.out.logprobs, h.logits_valid,
                          h.history)
            t0 = time.perf_counter()
            slot = eng.resume(h, tt, max_new_tokens=max_new - n0,
                              rid=1000 + rid, stop_tokens=())
            resume_s.append(time.perf_counter() - t0)
            if tool is not None:
                injected[rid] = (eng._last_logits[slot].clone(),
                                 np.concatenate([first[rid][3], tt]))
        held = still
    if moved:
        raise AssertionError(f"suspend: pinned blocks of suspended handles "
                             f"changed while they waited: {moved}")
    outs = {}
    for rid, o in done.items():
        if rid >= 1000:
            toks, lps, valid, _ = first[rid - 1000]
            outs[rid - 1000] = (toks + o.tokens, list(lps) + o.logprobs,
                                valid)
        elif rid not in first:
            outs[rid] = (o.tokens, o.logprobs, None)
    return outs, resume_s, injected


def resume_mismatches(ref, outs, int8) -> tuple:
    """Hold each request's two turns to its uninterrupted run: tokens
    identical; logprobs bit for bit where the boundary logits were carried
    on a float pool, within INT8_TOL on int8, within REPLAY_TOL where the
    boundary was replayed.  Returns (the rids that fail, max |diff| over
    the replayed and the carried requests)."""
    bad, worst = [], {"replayed": 0.0, "carried": 0.0}
    for rid, (toks, lps, valid) in outs.items():
        r = ref[rid]
        a = np.asarray(lps, np.float32)
        b = np.asarray(r.logprobs, np.float32)
        if toks != r.tokens or len(a) != len(b):
            n = next((i for i, (x, y) in enumerate(zip(toks, r.tokens))
                      if x != y), min(len(toks), len(r.tokens)))
            print(f"  rid {rid} ({'replayed' if valid is False else 'carried'}"
                  f"): tokens differ from position {n}")
            bad.append(rid)
            continue
        d = float(np.abs(a - b).max()) if len(a) else 0.0
        kind = "replayed" if valid is False else "carried"
        worst[kind] = max(worst[kind], d)
        tol = (REPLAY_TOL if valid is False else
               INT8_TOL if int8 else 0.0)
        if d > tol:
            print(f"  rid {rid} ({kind}): max |diff| {d:.3e} at position "
                  f"{int(np.abs(a - b).argmax())} (held to {tol})")
            bad.append(rid)
    return bad, worst


def stop_requests(prompts, stops, max_new=None):
    from repro_torch.serve import Request
    max_new = MAX_NEW if max_new is None else max_new
    return [Request(rid=i, prompt=p, max_new_tokens=max_new,
                    stop_tokens=(stops[i][0],) if i in stops else ())
            for i, p in enumerate(prompts)]


def expected_launches(cfg, counts, m, kv, replays, injected_tokens=0):
    """What a suspended run must have launched: its layout's decode kernel
    once a layer per decode step and per forced token at batch 1 (a
    replayed boundary token, a tool's reply: on a paged pool in the slot,
    on a contiguous one on the cache before it is adopted), greedy once a
    decode step, flash once a layer per prefill (an adoption runs none)."""
    want = {k: 0 for k in counts}
    attn = "decode_attention" if kv == "contiguous" \
        else "paged_decode_attention"
    want[attn] = cfg.num_layers * (m.steps + replays + injected_tokens)
    want["greedy_sample"] = m.steps
    want["flash_attention"] = cfg.num_layers * (m.prefills - m.adoptions)
    return want


def phase_suspend(torch, dev, model, params):
    """internlm2 at full width: the 16 serve prompts suspended near
    position 40 and resumed, on contiguous, paged and paged-int8 KV at
    block sizes 1 and 4, held to the uninterrupted runs; a planted
    off-by-one resume; tool injection in float32 against a prefill;
    dropped handles and conservation; captures across cycles."""
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    fns = wrappers()
    total = {k: 0 for k in fns}
    res = {}
    planted = None
    for kv, kv_dtype in (("contiguous", None), ("paged", None),
                         ("paged", "int8")):
        for K in (1, 4):
            run = kv + ("-int8" if kv_dtype else "") + f" block {K}"
            ecfg = EngineConfig(num_slots=SLOTS, max_seq_len=MAX_SEQ,
                                kv_layout=kv, kv_dtype=kv_dtype,
                                block_size=K)
            ref_eng = Engine(model, params, ecfg, device=dev)
            for i, p in enumerate(prompts):
                ref_eng.submit(Request(rid=i, prompt=p,
                                       max_new_tokens=MAX_NEW))
            ref = {o.rid: o for o in ref_eng.run()}
            del ref_eng
            stops = pick_stops(ref.values(), K)
            if len(stops) < N_REQ - 4:
                raise AssertionError(f"suspend {run}: only {len(stops)} "
                                     f"requests have a stop token")
            for f in fns.values():
                f.launches = 0
            eng = timed_engine(model, params, ecfg, device=dev)
            t0 = time.perf_counter()
            outs, resume_s, _ = drive_suspended(
                torch, eng, stop_requests(prompts, stops))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: f.launches for k, f in fns.items()}
            m = eng.metrics()
            replays = sum(v[2] is False for v in outs.values())
            want = expected_launches(cfg, counts, m, kv, replays)
            if counts != want:
                raise AssertionError(f"suspend {run}: launches {counts} != "
                                     f"{want}")
            for k in total:
                total[k] += counts[k]
            bad, worst = resume_mismatches(ref, outs, kv_dtype == "int8")
            if bad or sorted(outs) != list(range(N_REQ)):
                raise AssertionError(f"suspend {run}: rids {bad} resumed "
                                     f"unlike the uninterrupted run "
                                     f"(max |diff| {worst})")
            if m.suspends != len(stops) or m.resumes != len(stops) \
                    or m.suspended:
                raise AssertionError(f"suspend {run}: {m.suspends} "
                                     f"suspends, {m.resumes} resumes for "
                                     f"{len(stops)} stops")
            if eng.captures != int(dev.type == "cuda"):
                raise AssertionError(f"suspend {run}: {eng.captures} "
                                     f"decode-block captures across "
                                     f"suspend/resume cycles (want 1)")
            if eng.paged:
                eng.slots.check()
                eng.slots.alloc.assert_clean(context=f"suspend {run}")
            sus_ms = 1e3 * np.asarray(eng.suspend_s)
            res_ms = 1e3 * np.asarray(resume_s)
            tick_ms = 1e3 * m.decode_time_s / max(m.steps // K, 1)
            carried = sum(v[2] is True for v in outs.values())
            print(f"[suspend] {run}: {len(stops)} of {N_REQ} requests "
                  f"suspended near position {STOP_FROM} and resumed "
                  f"({carried} with carried logits, {replays} replayed) "
                  f"after {HOLD_TICKS} ticks: tokens identical to the "
                  f"uninterrupted run, logprobs max |diff| carried "
                  f"{worst['carried']:.3e}, replayed "
                  f"{worst['replayed']:.3e}; suspend host ms mean "
                  f"{sus_ms.mean():.3f} max {sus_ms.max():.3f}, resume "
                  f"host ms mean {res_ms.mean():.3f} max "
                  f"{res_ms.max():.3f}, tick {tick_ms:.3f} ms; "
                  f"{eng.captures} decode capture(s), "
                  f"{eng.inject_captures} injection capture(s); wall "
                  f"{wall:.2f}s; launches {counts}")
            res[run] = {"stops": len(stops), "carried": carried,
                        "replayed": replays, "max_diff": worst,
                        "suspend_ms": sus_ms.tolist(),
                        "resume_ms": res_ms.tolist(), "tick_ms": tick_ms,
                        "captures": eng.captures,
                        "inject_captures": eng.inject_captures,
                        "wall_s": wall, "launches": counts}
            if kv == "paged":
                drop_check(torch, eng, prompts, stops, run)
            if run == "contiguous block 1":
                planted = (ref, stops, ecfg)
            del eng, outs
    # the planted fault: one handle resumed with its index off by one
    ref, stops, ecfg = planted
    rid = min(r for r in stops if r < GRAPH_REQ)
    eng = Engine(model, params, ecfg, device=dev)
    outs, _, _ = drive_suspended(
        torch, eng, stop_requests(prompts[:GRAPH_REQ], stops), plant=rid)
    bad, _ = resume_mismatches(ref, outs, False)
    if bad != [rid]:
        raise AssertionError(f"suspend: the planted off-by-one resume of "
                             f"rid {rid} was not caught (failing rids "
                             f"{bad})")
    print(f"[suspend] planted fault: rid {rid} resumed with its index off "
          f"by one fails the check (failing rids {bad})")
    del eng, outs
    # tool injection in float32: logits after 16 injected tokens against
    # a fresh prefill of history + tool
    params32 = _tree_map(lambda t: t.float(), params)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    torch.cuda.empty_cache()
    res["inject"] = {}
    for kv in ("contiguous", "paged"):
        for f in fns.values():
            f.launches = 0
        ecfg = EngineConfig(num_slots=GRAPH_REQ, max_seq_len=MAX_SEQ,
                            kv_layout=kv)
        eng = Engine(model32, params32, ecfg, device=dev)
        for i, p in enumerate(prompts[:GRAPH_REQ]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=STOP_FROM + 8))
        ref = {o.rid: o for o in eng.run()}
        stops = pick_stops(ref.values(), 1)
        rs = np.random.RandomState(5)
        tools = {rid: rs.randint(0, cfg.vocab_size, size=TOOL_LEN).astype(
            np.int32) for rid in stops}
        eng = Engine(model32, params32, ecfg, device=dev)
        outs, _, injected = drive_suspended(
            torch, eng, stop_requests(prompts[:GRAPH_REQ], stops,
                                      STOP_FROM + 8),
            tool=lambda h: tools[h.req.rid], max_new=STOP_FROM + 8)
        gaps = []
        for rid, (logits, seq) in injected.items():
            pre, _ = model32.prefill(
                params32, torch.from_numpy(seq).to(dev)[None],
                model32.init_cache(1, MAX_SEQ, device=dev))
            a = torch.log_softmax(logits.float(), -1)
            b = torch.log_softmax(pre[0].float(), -1)
            gaps.append(float((a - b).abs().max()))
            if int(a.argmax()) != int(b.argmax()):
                raise AssertionError(f"suspend inject {kv}: rid {rid}'s "
                                     f"next token after injection differs "
                                     f"from the prefill's")
        counts = {k: f.launches for k, f in fns.items()}
        for k in total:
            total[k] += counts[k]
        if len(injected) < 2 or max(gaps) > INJECT_TOL:
            raise AssertionError(f"suspend inject {kv}: {len(injected)} "
                                 f"injections, max |log-softmax diff| "
                                 f"{gaps} (held to {INJECT_TOL})")
        print(f"[suspend] float32 {kv}: {len(injected)} requests resumed "
              f"with {TOOL_LEN} tool tokens; log-softmax after injection "
              f"against a prefill of history + tool: max |diff| "
              f"{max(gaps):.3e} (held to {INJECT_TOL}), argmax equal; "
              f"{eng.inject_captures} injection capture(s)")
        res["inject"][kv] = {"requests": len(injected), "max_diff": gaps}
        del eng
    del params32, model32
    torch.cuda.empty_cache()
    return total, res


def drop_check(torch, eng, prompts, stops, run):
    """Handles dropped instead of resumed: conservation holds with their
    pins, and once released the pool is clean."""
    eng.reset()
    reqs = stop_requests(prompts[:GRAPH_REQ], stops)
    for r in reqs:
        eng.submit(r)
    handles = []
    while not eng.idle:
        eng.step()
        handles += eng.harvest_suspended()
    pins = [b for h in handles for b in h.block_ids]
    eng.slots.check(extra_pins=pins)
    if eng.metrics().suspended != len(handles) or not handles:
        raise AssertionError(f"suspend {run}: {len(handles)} handles")
    for h in handles:
        h.release()
    eng.slots.check()
    eng.slots.alloc.assert_clean(context=f"suspend {run}, dropped handles")
    print(f"[suspend] {run}: {len(handles)} handles dropped ({len(pins)} "
          f"pinned blocks): conservation held, the pool is clean")


def phase_agentic(torch, dev, model, params):
    """``run_episodes`` at full width on a paged pool of 8 slots: 32
    episodes, 2 tool calls each of 16 tokens at 16 ticks' latency, 128
    new tokens a budget; the suspend, hold and ideal arms of the JAX
    package's bench (``benchmarks/train_mux.py``)."""
    from repro_torch.rl import CountdownToolEnv, run_episodes
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = model.cfg
    rs = np.random.RandomState(1)
    lens = rs.randint(32, 129, size=AGENT_EPISODES)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    ecfg = EngineConfig(num_slots=SLOTS, max_seq_len=MAX_SEQ,
                        kv_layout="paged")
    # the tool-call boundary: each prompt's third greedy token
    probe = Engine(model, params, ecfg, device=dev)
    for i, p in enumerate(prompts):
        probe.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    stops = sorted({o.tokens[2] for o in probe.run() if o.num_tokens > 2}
                   - {probe.config.eos_id})
    del probe
    env = CountdownToolEnv(tuple(stops), vocab=cfg.vocab_size,
                           turns=AGENT_TURNS, tool_len=TOOL_LEN)
    fns = wrappers()
    total = {k: 0 for k in fns}
    runs = {}
    for name, latency, hold in (("suspend", TOOL_LEN, False),
                                ("hold", TOOL_LEN, True),
                                ("ideal", 0, False)):
        for f in fns.values():
            f.launches = 0
        eng = Engine(model, params, ecfg, device=dev)
        t0 = time.perf_counter()
        eps, stats = run_episodes(eng, env, prompts, max_new_tokens=MAX_NEW,
                                  tool_latency_ticks=latency,
                                  hold_slots=hold)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: f.launches for k, f in fns.items()}
        m = eng.metrics()
        want = expected_launches(cfg, counts, m, "paged", 0,
                                 stats["tool_calls"] * TOOL_LEN)
        if counts != want:
            raise AssertionError(f"agentic {name}: launches {counts} != "
                                 f"{want}")
        for k in total:
            total[k] += counts[k]
        eng.slots.alloc.assert_clean(context=f"agentic {name}")
        gen = sum(len(e.gen_tokens) for e in eps)
        runs[name] = {"episodes": eps, "ticks": stats["ticks"],
                      "turns": stats["turns"],
                      "tool_calls": stats["tool_calls"], "wall_s": wall,
                      "gen_tokens": gen, "tok_per_s": gen / wall,
                      "captures": eng.captures,
                      "inject_captures": eng.inject_captures,
                      "launches": counts}
        print(f"[agentic] {name}: {AGENT_EPISODES} episodes, "
              f"{stats['turns']} turns, {stats['tool_calls']} tool calls, "
              f"{stats['ticks']} ticks in {wall:.2f}s, {gen} generated "
              f"tokens = {gen / wall:.1f} tok/s; {eng.captures} decode "
              f"capture(s), {eng.inject_captures} injection capture(s); "
              f"launches {counts}")
        del eng
    for other in ("hold", "ideal"):
        for a, b in zip(runs["suspend"]["episodes"],
                        runs[other]["episodes"]):
            if a.full_completion != b.full_completion \
                    or a.action_mask != b.action_mask \
                    or a.finish_reason != b.finish_reason:
                raise AssertionError(f"agentic: episode {a.index} differs "
                                     f"between suspend and {other}")
    sus, hol, ide = (runs[k]["ticks"] for k in ("suspend", "hold", "ideal"))
    if runs["suspend"]["tool_calls"] < AGENT_EPISODES // 2 or sus > hol:
        raise AssertionError(f"agentic: {runs['suspend']['tool_calls']} "
                             f"tool calls, ticks suspend {sus} hold {hol}")
    frac = (hol - sus) / max(hol - ide, 1)
    print(f"[agentic] tokens identical across the three arms; ticks "
          f"suspend {sus}, hold {hol}, ideal {ide}: reclaimed fraction "
          f"(hold - suspend) / (hold - ideal) = {frac:.4f}")
    for r in runs.values():
        del r["episodes"]
    return total, {"arms": runs, "reclaimed_frac": frac,
                   "stop_tokens": len(stops)}


def phase_carry(torch, dev, model, params, init_params):
    """Partial-rollout carry at full width: ``reset(params2,
    carry_live=True)`` on 8 live requests (held to the old weights' run
    and to itself), then the streaming executor with a carry job (what
    ``run_training(mux="stream", carry=True)`` runs) at staleness 1 with a
    weight sync after every group, so that syncs land mid-rollout."""
    from repro_torch.rl.coexec import GRPOJob
    from repro_torch.rl.stream import run_streaming
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = model.cfg
    params2 = model.init(torch.Generator(device=dev).manual_seed(1))
    prompts = serve_prompts(cfg.vocab_size)[:CARRY_REQ]
    fns = wrappers()
    total = {k: 0 for k in fns}

    def run(new_params):
        eng = Engine(model, params, EngineConfig(
            num_slots=SLOTS, max_seq_len=MAX_SEQ, kv_layout="paged"),
            device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=CARRY_NEW))
        for _ in range(CARRY_TICKS):
            eng.step()
        before = eng.captures
        if new_params is not None:
            eng.reset(new_params, carry_live=True)
        outs = {o.rid: o for o in eng.run()}
        return outs, eng.captures - before

    for f in fns.values():
        f.launches = 0
    ref, _ = run(None)
    a, caps = run(params2)
    b, _ = run(params2)
    for k, f in fns.items():
        total[k] += f.launches
    n_old = []
    for rid, o in a.items():
        vers = list(o.token_versions)
        n = vers.count(0)
        n_old.append(n)
        if set(vers) != {0, 1} or vers != sorted(vers):
            raise AssertionError(f"carry: rid {rid} versions {vers}")
        r = ref[rid]
        if o.tokens[:n] != r.tokens[:n] or not np.array_equal(
                np.asarray(o.logprobs[:n], np.float32),
                np.asarray(r.logprobs[:n], np.float32)):
            raise AssertionError(f"carry: rid {rid}'s tokens before the "
                                 f"swap differ from the old weights' run")
        if (o.tokens, o.logprobs, o.token_versions) != (
                b[rid].tokens, b[rid].logprobs, b[rid].token_versions):
            raise AssertionError(f"carry: rid {rid} differs between two "
                                 f"runs")
    if caps != int(dev.type == "cuda"):
        raise AssertionError(f"carry: {caps} captures followed the reset")
    print(f"[carry] reset(params2, carry_live=True) after {CARRY_TICKS} "
          f"ticks on {CARRY_REQ} live requests: tokens before the swap the "
          f"old weights' bit for bit ({min(n_old)}-{max(n_old)} per row), "
          f"versions {{0, 1}} monotone, two runs identical, one capture "
          f"after the reset")
    del ref, a, b, params2
    torch.cuda.empty_cache()

    class VersionJob(GRPOJob):
        """Keeps each streamed group's token versions, by iteration."""
        def reward_group(self, b, gout):
            self.versions.setdefault(id(b), []).append(
                (gout["token_versions"].copy(), gout["mask"].copy()))
            return super().reward_group(b, gout)
    job = VersionJob("job0", model=model, seed=0, steps=3, batch=4,
                     group=4, max_new=MAX_NEW, temperature=1.0,
                     rollout="engine", carry=True,
                     reward_fn=token_share_reward(cfg.vocab_size),
                     params=_tree_map(lambda t: t.clone(), init_params),
                     device=dev)
    job.versions = {}
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    state, hist, report = run_streaming(job, max_staleness=1,
                                        micro_groups=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, f in fns.items():
        total[k] += f.launches
    del state
    if not all(np.isfinite(r["loss"]) for r in hist):
        raise AssertionError(f"carry: non-finite loss {hist}")
    stale, tokens = [], []
    for groups in job.versions.values():
        v = np.concatenate([g[0][g[1] > 0] for g in groups])
        stale.append(int((v < v.max()).sum()))
        tokens.append(int(v.size))
    del job
    carried = [r["carried_rows"] for r in hist]
    s = report.summary()
    print(f"[carry] run_streaming(carry=True, max_staleness=1, "
          f"micro_groups=1), 3 iterations in {wall:.2f}s: tokens of a "
          f"version older than the iteration's newest {stale} of "
          f"{tokens}, rows mixing versions {carried}, behaviour versions "
          f"{[r['behavior_versions'] for r in hist]}; rollout busy "
          f"{s['total_rollout_s']:.2f}s, train busy "
          f"{s['total_train_s']:.2f}s")
    return total, {"tokens_before_swap": n_old, "captures_after": caps,
                   "stream": {"wall_s": wall, "carried_rows": carried,
                              "stale_tokens": stale, "tokens": tokens,
                              "history": hist}}


def phase_static(torch, dev, model, params, init_params):
    """Static ``generate`` at full width: 16 equal-length prompts x 128
    tokens, greedy, against the engine's contiguous run; then two GRPO
    iterations with ``rollout="static"``."""
    from repro_torch.launch.train import run_training
    from repro_torch.rl import SamplerConfig, generate, generate_continuous

    cfg = model.cfg
    rs = np.random.RandomState(2)
    prompts = rs.randint(0, cfg.vocab_size, size=(N_REQ, 128)).astype(
        np.int32)
    sampler = SamplerConfig(max_new_tokens=MAX_NEW)
    fns = wrappers()
    total = {k: 0 for k in fns}
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = generate(model, params, prompts, sampler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    want = {k: 0 for k in counts}
    want["decode_attention"] = cfg.num_layers * MAX_NEW
    want["greedy_sample"] = MAX_NEW
    want["flash_attention"] = cfg.num_layers
    if counts != want:
        raise AssertionError(f"static: launches {counts} != {want}")
    for k in total:
        total[k] += counts[k]
    t1 = time.perf_counter()
    eng = generate_continuous(model, params, prompts, sampler,
                              num_slots=N_REQ, device=dev)
    torch.cuda.synchronize()
    eng_wall = time.perf_counter() - t1
    for k, f in fns.items():
        total[k] += f.launches - counts[k]
    st, et = out["completions"].cpu().numpy(), eng["completions"].cpu().numpy()
    sl, el = (out["behavior_logp"].cpu().numpy(),
              eng["behavior_logp"].cpu().numpy())
    agree = st == et
    prefix = np.cumprod(agree, axis=1).astype(bool)   # before a divergence
    diff = np.abs(sl - el)[prefix]
    ratio = float(np.exp(sl[prefix] - el[prefix]).mean())
    if not agree[:, 0].all() or abs(ratio - 1) > 1e-2 \
            or diff.max() > REPLAY_TOL:
        raise AssertionError(f"static: against the engine first tokens "
                             f"{agree[:, 0].sum()}/{N_REQ}, mean exp(diff) "
                             f"{ratio}, max |diff| {diff.max()}")
    print(f"[static] generate, {N_REQ} prompts of 128 ids x {MAX_NEW} "
          f"tokens greedy: {wall:.2f}s ({N_REQ * MAX_NEW / wall:.1f} tok/s) "
          f"against the engine's contiguous run {eng_wall:.2f}s; tokens "
          f"agree {agree.mean():.4f}, first tokens all; on the agreeing "
          f"prefix mean exp(diff) {ratio:.6f} (held within 1e-2 of 1), max "
          f"|diff| {diff.max():.3e} (held to {REPLAY_TOL}); launches "
          f"{counts}")
    del out, eng
    job_params = _tree_map(lambda t: t.clone(), init_params)
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    state, hist, report = run_training(
        ARCH, model=model, params=job_params, steps=2, batch=4, group=4,
        max_new=MAX_NEW, temperature=1.0, rollout="static",
        reward_fn=token_share_reward(cfg.vocab_size), device=dev,
        log_every=0, return_report=True)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in fns.items()}
    want = {k: 0 for k in counts}
    want["decode_attention"] = cfg.num_layers * MAX_NEW * 2
    want["flash_attention"] = cfg.num_layers * 3 * 2
    if counts != want:
        raise AssertionError(f"static GRPO: launches {counts} != {want}")
    for k in total:
        total[k] += counts[k]
    for r in hist:
        if not np.isfinite(r["loss"]) or r["grad_norm"] <= 0 \
                or abs(r["ratio_mean"] - 1) > 1e-2:
            raise AssertionError(f"static GRPO: iteration {r}")
    roll = [t1_ - t0_ for _, t0_, t1_ in report.timelines["rollout"]]
    train = [t1_ - t0_ for _, t0_, t1_ in report.timelines["train"]]
    print(f"[static] 2 GRPO iterations with rollout='static' in "
          f"{train_wall:.2f}s: rollout s {[round(x, 3) for x in roll]}, "
          f"train s {[round(x, 3) for x in train]}, ratio_mean "
          f"{[round(r['ratio_mean'], 6) for r in hist]}; launches {counts}")
    del state, job_params
    return total, {"generate_s": wall, "engine_s": eng_wall,
                   "token_agreement": float(agree.mean()),
                   "ratio_mean": ratio, "max_diff": float(diff.max()),
                   "grpo": {"wall_s": train_wall, "rollout_s": roll,
                            "train_s": train, "history": hist}}


# ---------------------------------------------------------------------------
# radix prefix sharing, disaggregated prefill/decode, GRPO with sharing
# ---------------------------------------------------------------------------
GROUP = 4              # GRPO group size of the sharing phases
PREAMBLE = 256         # ids of the preamble-shaped traffic's common prefix
PARTIAL_TOL = 2e-2     # |logprob| of a partial hit off the unshared run, bf16
PARTIAL32_TOL = 1e-4   # the same in float32
PD_PREFILL, PD_DECODE = 2, 6    # the router's prefill and decode slots


def grpo_prompts(vocab_size):
    """GROUP copies of each of the first N_REQ / GROUP serve prompts,
    group by group: GRPO's rollout shape."""
    return [p for p in serve_prompts(vocab_size)[:N_REQ // GROUP]
            for _ in range(GROUP)]


def preamble_prompts(vocab_size, n=N_REQ):
    """``n`` prompts sharing one PREAMBLE-id preamble (16 full blocks),
    each with a distinct suffix of 32-256 ids, from ``RandomState(1)``."""
    rs = np.random.RandomState(1)
    pre = rs.randint(0, vocab_size, size=PREAMBLE)
    return [np.concatenate([pre, rs.randint(
        0, vocab_size, size=rs.randint(32, 257))]).astype(np.int32)
        for _ in range(n)]


def blocks_copy(torch, eng, ids):
    """The contents of pool blocks ``ids`` of a paged engine (and their
    int8 scales)."""
    from repro_torch.models.kvcache import SCALE_SUFFIX

    ids = torch.as_tensor(list(ids), dtype=torch.long, device=eng.device)
    return {name: leaf.index_select(1, ids).clone()
            for name, leaf in eng.slots.cache.items()
            if name in eng.slots.paged_names or name.endswith(SCALE_SUFFIX)}


def drive(torch, eng, prompts, *, max_new=None, after_first=None,
          frontends=None):
    """``prompts`` (with ``frontends``) through ``eng`` (an engine or a
    router), all arriving at the start, ``max_new`` (default MAX_NEW)
    tokens each;
    ``after_first(eng)`` runs after the first tick.  Returns the outputs
    in rid order, the wall seconds and the mean TTFT (the engine's clock
    stamps first tokens)."""
    from collections import deque

    from repro_torch.serve import Request
    max_new = MAX_NEW if max_new is None else max_new
    pending = deque(Request(rid=i, prompt=p, max_new_tokens=max_new,
                            frontend=frontend_of(frontends, i))
                    for i, p in enumerate(prompts))
    t0 = time.perf_counter()
    eng.clock = lambda: time.perf_counter() - t0
    ticks = 0
    while pending or not eng.idle:
        while pending and eng.submit(pending[0]):
            pending.popleft()
        if not eng.idle:
            eng.step()
            ticks += 1
            if ticks == 1 and after_first is not None:
                after_first(eng)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.clock = None
    outs = [eng.finished[r] for r in sorted(eng.finished)]
    return outs, wall, float(np.mean([o.first_token_time for o in outs]))


def timed_share_engine(*args, **kw):
    """An engine that records the host seconds of each exact-hit admit in
    ``share_s`` and of each registration in ``register_s`` (a subclass
    made here, as :func:`eager_engine`)."""
    from repro_torch.serve.engine import Engine

    class TimedShareEngine(Engine):
        def _admit_shared_exact(self, req, m):
            t0 = time.perf_counter()
            try:
                return super()._admit_shared_exact(req, m)
            finally:
                self.share_s.append(time.perf_counter() - t0)

        def _register_prefix(self, req, slot):
            t0 = time.perf_counter()
            try:
                return super()._register_prefix(req, slot)
            finally:
                self.register_s.append(time.perf_counter() - t0)
    eng = TimedShareEngine(*args, **kw)
    eng.share_s, eng.register_s = [], []
    return eng


def serve_launches(cfg, counts, attn, steps, model_prefills):
    """What a serving run must have launched: greedy once a decode step;
    per model prefill (an exact radix hit and an adoption run none) a
    recurrent model's scan once a layer and flash once an attention layer
    (every layer of a dense model, each shared-block use of zamba2's, none
    of rwkv6's; whisper's decoder and encoder layers); the layout's decode
    kernel ``attn`` once an attention layer per decode step (none for MLA,
    whose absorbed decode is plain PyTorch), and for whisper the
    contiguous kernel once a layer more (its cross-attention)."""
    want = {k: 0 for k in counts}
    if cfg.family == "audio":
        want["flash_attention"] = (cfg.num_layers + cfg.encoder_layers) \
            * model_prefills
        want[attn] += cfg.num_layers * steps
        want["decode_attention"] += cfg.num_layers * steps
        want["greedy_sample"] = steps
        return want
    if cfg.family == "hybrid":
        uses = cfg.num_layers // cfg.hybrid_attn_every
        want["mamba2_scan"] = cfg.num_layers * model_prefills
    elif cfg.family == "ssm":
        uses = 0
        want["rwkv6_scan"] = cfg.num_layers * model_prefills
    else:
        uses = cfg.num_layers
    want["flash_attention"] = uses * model_prefills
    want[attn] = 0 if cfg.attention == "mla" else uses * steps
    want["greedy_sample"] = steps
    return want


def partial_check(a, b, tol) -> dict:
    """Requests of run ``a`` against run ``b``: bit for bit, or tokens equal
    up to a first divergence with logprobs within ``tol`` before it.
    Returns the count bit for bit, the divergences (rid, position) and the
    max |logprob diff| on the agreeing prefixes; raises past ``tol``."""
    exact, diverged, worst = 0, [], 0.0
    for x, y in zip(a, b):
        n = next((i for i, (s, t) in enumerate(zip(x.tokens, y.tokens))
                  if s != t), min(len(x.tokens), len(y.tokens)))
        d = np.abs(np.asarray(x.logprobs[:n], np.float32)
                   - np.asarray(y.logprobs[:n], np.float32))
        worst = max(worst, float(d.max()) if n else 0.0)
        if x.tokens == y.tokens and not d.any():
            exact += 1
        elif x.tokens != y.tokens:
            diverged.append((x.rid, n))
    if worst > tol:
        raise AssertionError(f"partial hits: max |logprob diff| {worst:.3e} "
                             f"on the agreeing prefixes (held to {tol})")
    return {"bit_for_bit": exact, "diverged": diverged, "max_diff": worst}


def phase_prefix(torch, dev, model, params):
    """Radix prefix sharing at full width: GRPO-shaped traffic (4 prompts x
    group 4) on paged bf16 and int8 against the same engine with sharing
    off, bit for bit; preamble-shaped traffic (partial hits) in bf16 and
    float32; eviction on a pool of two requests' need; a planted unseeded
    tail; shared blocks re-read unchanged; one decode capture an engine."""
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.blocks import blocks_for

    cfg = model.cfg
    L = cfg.num_layers
    fns = wrappers()
    total = {k: 0 for k in fns}
    res = {}

    def serve(prompts, share, kv_dtype=None, max_new=MAX_NEW, m=model,
              p=params, slots=SLOTS, after_first=None, **kw):
        for f in fns.values():
            f.launches = 0
        eng = timed_share_engine(m, p, EngineConfig(
            num_slots=slots, max_seq_len=MAX_SEQ, kv_layout="paged",
            kv_dtype=kv_dtype, prefix_share=share, **kw), device=dev)
        outs, wall, ttft = drive(torch, eng, prompts, max_new=max_new,
                                 after_first=after_first)
        counts = {k: f.launches for k, f in fns.items()}
        mt = eng.metrics()
        want = serve_launches(cfg, counts, "paged_decode_attention",
                              mt.steps, mt.prefills - mt.prefix_hits)
        if counts != want:
            raise AssertionError(f"prefix: launches {counts} != {want}")
        if eng.captures != int(dev.type == "cuda"):
            raise AssertionError(f"prefix: {eng.captures} decode captures "
                                 f"in one engine (want 1)")
        for k in total:
            total[k] += counts[k]
        tok = sum(o.num_tokens for o in outs)
        return eng, outs, {"wall_s": wall, "ttft_mean_s": ttft,
                           "tok_per_s": tok / wall, "steps": mt.steps,
                           "model_prefills": mt.prefills - mt.prefix_hits,
                           "blocks_saved": mt.blocks_saved,
                           "launches": counts}

    # GRPO-shaped: every member after the first of its group is an exact
    # hit; the prompt's full blocks are re-read after the group finishes
    grpo = grpo_prompts(cfg.vocab_size)
    for kv_dtype in (None, "int8"):
        run = "paged" + ("-int8" if kv_dtype else "")
        _, base, rb = serve(grpo, False, kv_dtype)
        held = {}

        def keep(e):
            held["ids"] = e.radix.pinned_blocks()
            held["blocks"] = blocks_copy(torch, e, held["ids"])
        eng, shared, rs_ = serve(grpo, True, kv_dtype, after_first=keep)
        r = eng.radix
        if (r.misses, r.hits, r.partial_hits) != (N_REQ // GROUP,
                                                   N_REQ - N_REQ // GROUP, 0) \
                or rs_["model_prefills"] != N_REQ // GROUP:
            raise AssertionError(f"prefix {run}: misses/hits/partial "
                                 f"{r.misses}/{r.hits}/{r.partial_hits}, "
                                 f"{rs_['model_prefills']} model prefills")
        if not same_outputs(shared, base):
            raise AssertionError(f"prefix {run}: shared run differs from "
                                 f"the unshared one")
        now = blocks_copy(torch, eng, held["ids"])
        moved = [k for k in now if not torch.equal(now[k],
                                                   held["blocks"][k])]
        if not held["ids"] or moved:
            raise AssertionError(f"prefix {run}: shared blocks "
                                 f"{held['ids']} changed: {moved}")
        eng.slots.check(extra_pins=r.pinned_blocks())
        share_ms = 1e3 * np.asarray(eng.share_s)
        reg_ms = 1e3 * np.asarray(eng.register_s)
        eng.reset()                      # flushes and asserts a clean pool
        print(f"[prefix] {run} GRPO {N_REQ // GROUP} prompts x group "
              f"{GROUP}: bit for bit with sharing off; misses {r.misses} "
              f"hits {r.hits} partial {r.partial_hits}; model prefills "
              f"{rs_['model_prefills']} vs {rb['model_prefills']} (flash "
              f"launches {rs_['launches']['flash_attention']} = {L} x "
              f"{rs_['model_prefills']}); blocks_saved "
              f"{rs_['blocks_saved']}; {len(held['ids'])} shared blocks "
              f"re-read unchanged; wall {rs_['wall_s']:.2f}s vs "
              f"{rb['wall_s']:.2f}s, {rs_['tok_per_s']:.1f} vs "
              f"{rb['tok_per_s']:.1f} tok/s, mean TTFT "
              f"{rs_['ttft_mean_s'] * 1e3:.1f} vs "
              f"{rb['ttft_mean_s'] * 1e3:.1f} ms; share-admit host ms mean "
              f"{share_ms.mean():.3f} max {share_ms.max():.3f}, register "
              f"host ms mean {reg_ms.mean():.3f}; 1 decode capture each")
        res[f"grpo {run}"] = {"shared": rs_, "unshared": rb,
                              "share_admit_ms": share_ms.tolist(),
                              "register_ms": reg_ms.tolist(),
                              "shared_blocks_checked": len(held["ids"])}
        del eng, base, shared
    # preamble-shaped: a miss, then partial hits on the 16 preamble blocks
    pre = preamble_prompts(cfg.vocab_size)
    _, base, rb = serve(pre, False)
    eng, shared, rs_ = serve(pre, True)
    r = eng.radix
    if (r.misses, r.hits, r.partial_hits) != (1, 0, N_REQ - 1):
        raise AssertionError(f"prefix preamble: misses/hits/partial "
                             f"{r.misses}/{r.hits}/{r.partial_hits}")
    pc = partial_check(shared, base, PARTIAL_TOL)
    eng.slots.check(extra_pins=r.pinned_blocks())
    eng.reset()
    print(f"[prefix] preamble {PREAMBLE} ids + distinct suffixes, bf16: "
          f"misses {r.misses} partial {r.partial_hits}; "
          f"{pc['bit_for_bit']}/{N_REQ} bit for bit with sharing off, "
          f"diverged (rid, position) {pc['diverged']}, max |logprob diff| "
          f"before a divergence {pc['max_diff']:.3e} (held to "
          f"{PARTIAL_TOL}); blocks_saved {rs_['blocks_saved']}; wall "
          f"{rs_['wall_s']:.2f}s vs {rb['wall_s']:.2f}s, mean TTFT "
          f"{rs_['ttft_mean_s'] * 1e3:.1f} vs {rb['ttft_mean_s'] * 1e3:.1f}"
          f" ms")
    res["preamble bf16"] = {"shared": rs_, "unshared": rb, **pc}
    del eng, base, shared
    params32 = _tree_map(lambda t: t.float(), params)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    torch.cuda.empty_cache()
    _, base, _ = serve(pre[:GRAPH_REQ], False, m=model32, p=params32,
                       slots=GRAPH_REQ, max_new=GRAPH_NEW)
    eng, shared, _ = serve(pre[:GRAPH_REQ], True, m=model32, p=params32,
                           slots=GRAPH_REQ, max_new=GRAPH_NEW)
    worst = 0.0
    for x, y in zip(shared, base):
        if x.tokens != y.tokens:
            raise AssertionError(f"prefix preamble float32: rid {x.rid}'s "
                                 f"tokens differ from the unshared run's")
        worst = max(worst, float(np.abs(np.subtract(x.logprobs,
                                                    y.logprobs)).max()))
    if worst > PARTIAL32_TOL or eng.radix.partial_hits != GRAPH_REQ - 1:
        raise AssertionError(f"prefix preamble float32: max |diff| {worst} "
                             f"(held to {PARTIAL32_TOL}), "
                             f"{eng.radix.partial_hits} partial hits")
    print(f"[prefix] preamble float32, {GRAPH_REQ} requests x {GRAPH_NEW} "
          f"tokens: tokens identical, max |logprob diff| {worst:.3e} (held "
          f"to {PARTIAL32_TOL})")
    res["preamble float32"] = {"max_diff": worst}
    del eng, base, shared, params32, model32
    torch.cuda.empty_cache()
    # eviction: distinct prompts on a pool of two requests' need
    prompts = serve_prompts(cfg.vocab_size)
    need = sorted(blocks_for(len(p) + MAX_NEW, 16) for p in prompts)
    nb = need[-1] + need[-2] + 1
    eng, outs, re_ = serve(prompts, True, num_kv_blocks=nb)
    check_outputs("prefix eviction", outs)
    r = eng.radix
    if not r.evictions:
        raise AssertionError("prefix eviction: no radix node was evicted")
    eng.slots.check(extra_pins=r.pinned_blocks())
    peak = eng.metrics().peak_active
    eng.reset()
    print(f"[prefix] eviction: {N_REQ} distinct prompts on {nb} blocks (two "
          f"largest requests' need + 1): {r.evictions} nodes evicted, peak "
          f"{peak} live; check(extra_pins=tree pins) held after the run, "
          f"the pool clean after reset")
    res["eviction"] = {"num_kv_blocks": nb, "evictions": r.evictions,
                       "wall_s": re_["wall_s"]}
    del eng, outs
    # planted: an exact hit whose private tail block is left unseeded
    p = next(x for x in prompts if len(x) % 16)
    q = max(prompts, key=len)
    trio = [p, q, p]
    _, base, _ = serve(trio, False, slots=1, max_new=GRAPH_NEW)
    eng = timed_share_engine(model, params, EngineConfig(
        num_slots=1, max_seq_len=MAX_SEQ, kv_layout="paged",
        prefix_share=True), device=dev)
    eng.slots.seed_block = lambda pid, blk: None
    planted, _, _ = drive(torch, eng, trio, max_new=GRAPH_NEW)
    if eng.radix.hits != 1 or same_outputs(planted[2:], base[2:]):
        raise AssertionError("prefix: the planted unseeded tail block was "
                             "not caught")
    print(f"[prefix] planted fault: an exact hit with its tail block "
          f"unseeded leaves the unshared run (first tokens "
          f"{planted[2].tokens[:4]} vs {base[2].tokens[:4]})")
    del eng, base, planted
    return total, res


def phase_disagg(torch, dev, model, params):
    """Disaggregated prefill/decode at full width: a router of PD_PREFILL
    prefill and PD_DECODE decode slots on contiguous, paged and paged-int8
    KV, sharing off (the 16 serve prompts) and on (GRPO-shaped), against a
    monolithic engine of PD_DECODE slots bit for bit; the int8 handle
    through the JAX package's dequantized interchange, measured; two
    prefill engines under kv_aware routing."""
    from repro_torch.serve import (DisaggConfig, DisaggRouter, Engine,
                                   EngineConfig)

    cfg = model.cfg
    L = cfg.num_layers
    fns = wrappers()
    total = {k: 0 for k in fns}
    res = {}
    mono_outs = {}

    def router_for(kv, kv_dtype, share, **kw):
        return DisaggRouter(model, params, DisaggConfig(
            prefill_slots=PD_PREFILL, decode_slots=PD_DECODE,
            max_seq_len=MAX_SEQ, kv_layout=kv, kv_dtype=kv_dtype,
            prefix_share=share, **kw), device=dev)

    def model_prefills(router):
        return sum(pe.stats.prefills - pe.stats.prefix_hits
                   for pe in router.prefills)

    def finish(router, label):
        """Handles all released, one decode capture, both pools clean."""
        if router.pending_transfer or any(pe.resident
                                          for pe in router.prefills):
            raise AssertionError(f"disagg {label}: handles left unreleased")
        if router.decode.captures != int(dev.type == "cuda"):
            raise AssertionError(f"disagg {label}: "
                                 f"{router.decode.captures} decode captures")
        router.reset()                   # asserts both pools clean

    for kv, kv_dtype, share in (("contiguous", None, False),
                                ("paged", None, False),
                                ("paged", "int8", False),
                                ("paged", None, True),
                                ("paged", "int8", True)):
        run = (kv + ("-int8" if kv_dtype else "")
               + (" sharing" if share else ""))
        prompts = (grpo_prompts if share else serve_prompts)(cfg.vocab_size)
        mono = Engine(model, params, EngineConfig(
            num_slots=PD_DECODE, max_seq_len=MAX_SEQ, kv_layout=kv,
            kv_dtype=kv_dtype), device=dev)
        for f in fns.values():
            f.launches = 0
        ref, mwall, mttft = drive(torch, mono, prompts)
        mono_outs[run] = ref
        for k, f in fns.items():
            total[k] += f.launches
            f.launches = 0
        del mono
        router = router_for(kv, kv_dtype, share)
        outs, wall, ttft = drive(torch, router, prompts)
        counts = {k: f.launches for k, f in fns.items()}
        m = router.metrics()
        want = serve_launches(
            cfg, counts, "decode_attention" if kv == "contiguous"
            else "paged_decode_attention", m.steps, model_prefills(router))
        if counts != want:
            raise AssertionError(f"disagg {run}: launches {counts} != {want}")
        for k in total:
            total[k] += counts[k]
        if not same_outputs(outs, ref) or m.transfers != N_REQ:
            raise AssertionError(f"disagg {run}: router differs from the "
                                 f"monolithic engine ({m.transfers} "
                                 f"transfers)")
        if share and (router.radix.misses, router.radix.hits) != (
                N_REQ // GROUP, N_REQ - N_REQ // GROUP):
            raise AssertionError(f"disagg {run}: misses/hits "
                                 f"{router.radix.misses}/"
                                 f"{router.radix.hits}")
        xfer_ms = 1e3 * np.asarray([t1 - t0 for _, t0, t1
                                    in router.transfer_timeline])
        tok = sum(o.num_tokens for o in outs)
        print(f"[disagg] {run}: bit for bit with a monolithic engine of "
              f"{PD_DECODE} slots; {m.transfers} transfers "
              f"({m.transferred_blocks} blocks), host ms per adoption mean "
              f"{xfer_ms.mean():.3f} max {xfer_ms.max():.3f}, "
              f"transfer_overhead_frac {m.transfer_overhead_frac:.4f}; "
              f"model prefills {model_prefills(router)}; "
              f"{tok / wall:.1f} vs {tok / mwall:.1f} tok/s, mean TTFT "
              f"{ttft * 1e3:.1f} vs {mttft * 1e3:.1f} ms; wall {wall:.2f}s"
              f" vs {mwall:.2f}s; launches {counts}")
        res[run] = {"transfers": m.transfers,
                    "transferred_blocks": m.transferred_blocks,
                    "adoption_ms": xfer_ms.tolist(),
                    "transfer_overhead_frac": m.transfer_overhead_frac,
                    "tok_per_s": tok / wall, "mono_tok_per_s": tok / mwall,
                    "ttft_mean_s": ttft, "mono_ttft_mean_s": mttft,
                    "wall_s": wall, "mono_wall_s": mwall,
                    "model_prefills": model_prefills(router),
                    "launches": counts}
        finish(router, run)
        del router, outs
    # the JAX package's int8 interchange (dequantize out, quantize in),
    # measured against the monolithic int8 engine
    from repro_torch.models.common import torch_dtype
    from repro_torch.models.kvcache import SCALE_SUFFIX, dequantize_kv
    from repro_torch.serve import PrefillEngine

    def dequantized(one):
        dt = torch_dtype(cfg.dtype)
        return {name: (dequantize_kv(t, one[name + SCALE_SUFFIX], dt)
                       if name + SCALE_SUFFIX in one else t)
                for name, t in one.items()
                if not name.endswith(SCALE_SUFFIX)}
    router = router_for("paged", "int8", False)
    for f in fns.values():
        f.launches = 0
    for pe in router.prefills:
        pe.export_cache = (lambda h, pe=pe: dequantized(
            PrefillEngine.export_cache(pe, h)))
    outs, _, _ = drive(torch, router, serve_prompts(cfg.vocab_size))
    for k, f in fns.items():
        total[k] += f.launches
        f.launches = 0
    pc = partial_check(outs, mono_outs["paged-int8"], PARTIAL_TOL)
    print(f"[disagg] paged-int8 through a dequantized handle (the JAX "
          f"package's interchange, for comparison): {pc['bit_for_bit']}/"
          f"{N_REQ} bit for bit, diverged {pc['diverged']}, max |logprob "
          f"diff| before a divergence {pc['max_diff']:.3e}")
    res["paged-int8 dequantized handle"] = pc
    finish(router, "dequantized")
    del router, outs
    # two prefill engines, kv_aware: the group leaders prefill first, the
    # members then land on the engine holding their prefix
    from repro_torch.serve import Request
    grpo = grpo_prompts(cfg.vocab_size)
    router = router_for("paged", None, True, prefill_engines=2,
                        kv_routing="kv_aware")
    for f in fns.values():
        f.launches = 0
    leaders = range(0, N_REQ, GROUP)
    for i in leaders:
        router.submit(Request(rid=i, prompt=grpo[i], max_new_tokens=MAX_NEW))
    while any(pe.queue for pe in router.prefills):
        router.step()
    for i in range(N_REQ):
        if i not in leaders:
            router.submit(Request(rid=i, prompt=grpo[i],
                                  max_new_tokens=MAX_NEW))
    outs = router.run()
    for k, f in fns.items():
        total[k] += f.launches
        f.launches = 0
    per = [(pe.radix.misses, pe.radix.hits) for pe in router.prefills]
    if router.metrics().kv_routed != N_REQ - len(leaders) or any(
            h != (GROUP - 1) * mi for mi, h in per) or sum(
            mi for mi, _ in per) != len(leaders) or not same_outputs(
            outs, mono_outs["paged sharing"]):
        raise AssertionError(f"disagg kv_aware: per-engine misses/hits "
                             f"{per}, kv_routed "
                             f"{router.metrics().kv_routed}")
    print(f"[disagg] 2 prefill engines, kv_aware: {len(leaders)} group "
          f"leaders then {N_REQ - len(leaders)} members, every member on "
          f"its prefix's engine (kv_routed {router.metrics().kv_routed}); "
          f"per engine (misses, hits) {per}; bit for bit with the "
          f"monolithic engine")
    res["kv_aware"] = {"per_engine_misses_hits": per,
                       "kv_routed": router.metrics().kv_routed}
    finish(router, "kv_aware")
    del router, outs
    return total, res


SYNC_SIZES = (8, 16)        # GPUs a pool of the modelled sync: 2 x n


def same_bits(torch, a, b) -> bool:
    """Two tensors of one dtype and shape, equal bit for bit."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase_sync(torch, dev, model, params, init_params):
    """Weight sync and sharding on one card, after the train phase:
    ``params`` hold two GRPO iterations' updates, ``init_params`` the
    weights the rollout engines started from.  (a) A one-rank NCCL (1, 1)
    ("data", "model") mesh (``make_local_mesh``).  (b) ``shard_params`` of
    ``params`` by the model's logical specs: every local tensor equals its
    leaf bit for bit, and the serve_short requests served from the local
    views equal those served on ``params`` bit for bit.  (c) An engine on
    ``init_params`` serves the requests (other tokens); then
    ``flatten_params(params)``, ``unflatten_params`` into a rollout tree
    like ``init_params`` and ``sync_params_between_jobs``; the engine,
    reset with the synced weights, serves (b)'s reference outputs bit for
    bit.  Flatten and unflatten are timed by CUDA events against one read
    and one write of the model's bytes.  (d) The modelled sync of these
    weights: ``sync_collective_bytes`` at 2 x 8 and 2 x 16 and
    ``ClusterTopology``'s speedups, the paper's link model, not card
    times.  (e) The process group is destroyed.  The hierarchical
    transfer itself needs a rank a card on each side; it runs on gloo
    worlds in the CPU tests."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.sharding import ShardingRules, shard_params
    from repro_torch.sync import (ClusterTopology, flatten_params,
                                  sync_collective_bytes,
                                  sync_params_between_jobs, unflatten_params)

    cfg = model.cfg
    total = {k: 0 for k in wrappers()}
    res = {}

    def served(run, r):
        want = serve_launches(cfg, r["launches"], "decode_attention",
                              r["steps"], GRAPH_REQ)
        if r["launches"] != want:
            raise AssertionError(f"sync {run}: launches {r['launches']} != "
                                 f"{want}")
        add_counts(total, r["launches"])
        return r

    t0 = time.perf_counter()
    mesh = make_local_mesh(dev)
    try:
        res["mesh_s"] = time.perf_counter() - t0
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if (tuple(mesh.shape) != (1, 1) or mesh.device_type != dev.type
                or dist.get_backend() != backend):
            raise AssertionError(f"sync: mesh {mesh}, backend "
                                 f"{dist.get_backend()}")
        # (b) sharded parameters serve through the kernels
        t0 = time.perf_counter()
        sharded = shard_params(params, model.logical_specs(), mesh,
                               ShardingRules())
        torch.cuda.synchronize()
        res["shard_s"] = time.perf_counter() - t0
        pairs = list(zip(_leaves(sharded), _leaves(params)))
        n_leaves = len(pairs)
        n_shard = sum(any(pl.is_shard() for pl in d.placements)
                      for d, _ in pairs)
        if not all(same_bits(torch, d.to_local(), t) for d, t in pairs):
            raise AssertionError("sync: a local shard differs from its leaf")
        local = _tree_map(lambda d: d.to_local(), sharded)
        ref = served("reference", serve_short(torch, dev, model, params))
        got = served("sharded", serve_short(torch, dev, model, local))
        if not same_outputs(got["outputs"], ref["outputs"]):
            raise AssertionError("sync: the sharded weights serve other "
                                 "tokens or logprobs")
        print(f"[sync] (1, 1) ('data', 'model') mesh on {backend} in "
              f"{res['mesh_s']:.2f}s; {len(pairs)} leaves sharded by their "
              f"logical specs ({n_shard} with a Shard placement) in "
              f"{res['shard_s']:.2f}s, every local tensor bit for bit; "
              f"{GRAPH_REQ} requests from the local views bit for bit "
              f"with the weights' own; launches {got['launches']}")
        del sharded, local, pairs, got
        # (c) the flat buffer a sync carries lands in a rollout engine
        pre = served("stale", serve_short(torch, dev, model, init_params))
        eng = pre["engine"]
        if same_outputs(pre["outputs"], ref["outputs"]):
            raise AssertionError("sync: the engine's starting weights serve "
                                 "the trained weights' tokens")
        flat = flatten_params(params)
        landed = unflatten_params(flat, init_params)
        synced = sync_params_between_jobs(landed, init_params)
        if not all(a is b for a, b in zip(_leaves(synced),
                                          _leaves(landed))):
            raise AssertionError("sync: sync_params_between_jobs copied")
        post = served("synced", serve_short(torch, dev, model, synced,
                                            engine=eng))
        if not same_outputs(post["outputs"], ref["outputs"]) \
                or eng.captures != 2 * (dev.type == "cuda"):
            raise AssertionError(f"sync: the synced engine differs from the "
                                 f"trained weights' run ({eng.captures} "
                                 f"captures)")
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        fbytes = flat.numel() * flat.element_size()
        timer = Timer(torch, dev)
        f_ms = timer(lambda: flatten_params(params), iters=10)
        u_ms = timer(lambda: unflatten_params(flat, init_params), iters=10)
        del timer
        b_ms, _ = bound(nbytes + fbytes, 0, "bfloat16")
        print(f"[sync] an engine on the starting weights, then "
              f"flatten_params ({flat.numel()} {flat.dtype} elements, "
              f"{nbytes / 1e9:.3f} GB) -> unflatten_params -> "
              f"sync_params_between_jobs -> reset: bit for bit with the "
              f"trained weights' run ({eng.captures} captures); flatten "
              f"{f_ms:.3f} ms, unflatten {u_ms:.3f} ms against {b_ms:.3f} "
              f"ms (one read and one write at {HBM_BPS / 1e12:.2f} TB/s)")
        res.update(leaves=n_leaves, sharded_leaves=n_shard,
                   model_bytes=nbytes, flatten_ms=f_ms, unflatten_ms=u_ms,
                   bound_ms=b_ms, captures=eng.captures)
        del flat, landed, synced, eng, pre, post, ref
    finally:
        dist.destroy_process_group()
    # (d) the modelled sync of these weights (the paper's link model)
    topo = ClusterTopology()
    modelled = {}
    for n in SYNC_SIZES:
        modelled[f"2x{n}"] = {
            mode: sync_collective_bytes(n, nbytes, mode=mode)
            for mode in ("hierarchical", "flat")}
        h, f = (modelled[f"2x{n}"][m] for m in ("hierarchical", "flat"))
        print(f"[sync] modelled 2 x {n}: hierarchical moves "
              f"{h['p2p']['cross_cluster']} B across the cluster boundary "
              f"(point to point) and "
              f"{h['all_gather']['intra_cluster']} B inside the rows; the "
              f"flat all-gather {f['all_gather']['cross_cluster']} B across "
              f"and {f['all_gather']['intra_cluster']} B inside "
              f"({f['all_gather']['cross_cluster'] / h['p2p']['cross_cluster']:.0f}x"
              f" across)")
    res["collective_bytes"] = modelled
    res["modelled_speedup"] = {
        "single_node_8": topo.speedup_single_node(nbytes, 8),
        "multi_node_16": topo.speedup_multi_node(nbytes, 16),
        "hierarchical_8_s": topo.hierarchical_time_s(nbytes, 8, 8),
        "flat_fetch_8_s": topo.flat_fetch_time_s(nbytes, 8)}
    ms = res["modelled_speedup"]
    print(f"[sync] modelled link times (ClusterTopology: 20 Gbps across, "
          f"400 Gbps inside; not card times) of {nbytes} B: hierarchical "
          f"{ms['hierarchical_8_s']:.3f} s against the flat fetch "
          f"{ms['flat_fetch_8_s']:.3f} s at 8 GPUs a pool, speedup "
          f"{ms['single_node_8']:.2f}x single-node, "
          f"{ms['multi_node_16']:.2f}x multi-node (16 a pool); "
          f"({card_line()})")
    res["launches"] = total
    return total, res


def phase_train_prefix(torch, dev, model, init_params):
    """Two GRPO iterations through the paged engine rollout with sharing
    on and off, from the same initial weights: losses, rewards and the
    trained weights' fingerprint bit for bit; model prefills per
    iteration (GROUP's share) and rollout seconds both ways."""
    from repro_torch.data import ArithmeticTask
    from repro_torch.launch.train import run_training

    cfg = model.cfg
    fns = wrappers()
    total = {k: 0 for k in fns}
    runs = {}
    # the job's task batches (seed 0), drawn in the job's order: its
    # distinct prompts are what a sharing rollout prefills
    task = ArithmeticTask(seed=0)
    distinct = [len({p.tobytes() for p in task.sample_batch(4).prompts})
                for _ in range(2)]
    for share in (False, True):
        params = _tree_map(lambda t: t.clone(), init_params)
        for f in fns.values():
            f.launches = 0
        state, hist, report = run_training(
            ARCH, model=model, params=params, steps=2, batch=4, group=GROUP,
            max_new=MAX_NEW, temperature=1.0, rollout="engine", kv="paged",
            prefix_share=share, reward_fn=token_share_reward(cfg.vocab_size),
            device=dev, log_every=0, return_report=True)
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in fns.items()}
        prefills = [r["prefills"] - r["prefix_hits"] for r in hist]
        want = {k: 0 for k in counts}
        want["paged_decode_attention"] = cfg.num_layers * sum(
            r["decode_steps"] for r in hist)
        want["flash_attention"] = cfg.num_layers * (sum(prefills)
                                                    + 2 * len(hist))
        if counts != want:
            raise AssertionError(f"train prefix_share={share}: launches "
                                 f"{counts} != {want}")
        for k in total:
            total[k] += counts[k]
        runs[share] = {
            "loss": [r["loss"] for r in hist],
            "reward": [r["reward"] for r in hist],
            "fingerprint": fingerprint(state["params"]),
            "model_prefills": prefills,
            "rollout_s": [t1 - t0 for _, t0, t1
                          in report.timelines["rollout"]]}
        del state, params, hist
        torch.cuda.empty_cache()
    a, b = runs[False], runs[True]
    if (a["loss"], a["reward"], a["fingerprint"]) != (
            b["loss"], b["reward"], b["fingerprint"]) \
            or b["model_prefills"] != distinct \
            or a["model_prefills"] != [4 * GROUP] * 2:
        raise AssertionError(f"train prefix_share: losses {a['loss']} vs "
                             f"{b['loss']}, rewards {a['reward']} vs "
                             f"{b['reward']}, prefills "
                             f"{a['model_prefills']} vs "
                             f"{b['model_prefills']}")
    print(f"[train] prefix_share, 2 GRPO iterations (batch 4 x group "
          f"{GROUP}, temperature 1): losses {b['loss']}, rewards "
          f"{b['reward']} and the weights' fingerprint bit for bit with "
          f"sharing off; model prefills per iteration {b['model_prefills']}"
          f" vs {a['model_prefills']}; rollout s "
          f"{[round(x, 3) for x in b['rollout_s']]} vs "
          f"{[round(x, 3) for x in a['rollout_s']]}")
    for r in runs.values():
        del r["fingerprint"]
    return total, {"shared": b, "unshared": a}


def recurrent_suspend_check(torch, dev, model, params, phase,
                            kv="contiguous") -> dict:
    """4 requests x 32 tokens at block size 1 on ``kv``: suspended and
    resumed equal to the uninterrupted run, bit for bit; block size 4 with
    stop tokens refused."""
    from repro_torch.serve import Engine, EngineConfig, Request

    prompts = serve_prompts(model.cfg.vocab_size)[:RECURRENT_REQ]
    ecfg = EngineConfig(num_slots=RECURRENT_REQ, max_seq_len=MAX_SEQ,
                        kv_layout=kv)
    eng = Engine(model, params, ecfg, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=RECURRENT_NEW))
    ref = {o.rid: o for o in eng.run()}
    stops = pick_stops(ref.values(), 1, start=4)
    eng = Engine(model, params, ecfg, device=dev)
    outs, resume_s, _ = drive_suspended(
        torch, eng, stop_requests(prompts, stops, RECURRENT_NEW),
        max_new=RECURRENT_NEW)
    bad, _ = resume_mismatches(ref, outs, False)
    if bad or not stops or eng.metrics().resumes != len(stops):
        raise AssertionError(f"{phase}: suspend/resume at block 1: rids "
                             f"{bad} differ ({len(stops)} stops)")
    fused = Engine(model, params, dataclasses.replace(ecfg, block_size=4),
                   device=dev)
    stop = next(iter(stops.values()))[0]
    try:
        fused.submit(Request(rid=0, prompt=prompts[0],
                             max_new_tokens=RECURRENT_NEW,
                             stop_tokens=(stop,)))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{phase}: stop tokens at block_size 4 were "
                             f"accepted")
    print(f"[{phase}] {kv}: {len(stops)} of {RECURRENT_REQ} requests "
          f"suspended and resumed at block size 1: tokens and logprobs the "
          f"uninterrupted run's bit for bit; resume host ms mean "
          f"{1e3 * np.mean(resume_s):.3f}; block size 4 refused "
          f"({refused[:60]}...)")
    return {"stops": len(stops), "resume_ms": (1e3 * np.asarray(
        resume_s)).tolist()}


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def mux_job(model, dev, init_params=None, jid="job0", seed=0, steps=2):
    """A full-width GRPO job of the train phase's shape, from a copy of
    ``init_params`` (the executors train their weights in place; None:
    the model's init from ``seed``), that keeps each train step's rollout
    arrays in ``job.seen`` and, where ``job.fingerprints`` is a list, the
    :func:`fingerprint` of each train step's new state.  A subclass, not a
    patched method: a closure
    over the job stored on the job would make a reference cycle that keeps
    its weights on the card until the garbage collector runs."""
    from repro_torch.rl.coexec import GRPOJob

    class RecordingJob(GRPOJob):
        def train_phase(self, state, b, out, rewards=None):
            self.seen.append({k: out[k].detach().cpu() for k in
                              ("completions", "behavior_logp", "mask")})
            stats = out.get("engine_stats")   # the streaming run has none
            if stats is not None:
                self.decode.append((stats.decode_time_s, stats.steps))
            state, rec = super().train_phase(state, b, out, rewards)
            if self.fingerprints is not None:
                self.fingerprints.append(fingerprint(state))
            return state, rec

    params = None if init_params is None else _tree_map(
        lambda t: t.clone(), init_params)
    job = RecordingJob(jid, model=model, seed=seed, steps=steps, batch=4,
                       group=4, max_new=MAX_NEW, temperature=1.0,
                       rollout="engine",
                       reward_fn=token_share_reward(model.cfg.vocab_size),
                       params=params, device=dev)
    job.seen, job.decode, job.fingerprints = [], [], None
    return job


def fingerprint(tree) -> list:
    """Per leaf: its shape, dtype and two int64 sums of its bits (plain and
    weighted by position), exact and independent of the order of addition,
    so that two states on the card can be held bit for bit without a
    second copy of either.  Runs on the current stream."""
    import torch
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for x in _leaves(tree):
        bits = x.detach().reshape(-1).view(ints[x.element_size()])
        sums = torch.zeros(2, dtype=torch.int64, device=x.device)
        for i in range(0, bits.numel(), 1 << 26):
            c = bits[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=x.device) % 65521 + 1
            sums[0] += c.sum()
            sums[1] += (c * w).sum()
        out.append((tuple(x.shape), str(x.dtype), sums.tolist()))
    return out


def mux_launches(cfg, hists, counts, label):
    """Every kernel's launches in a mux run must be what its histories
    say, across the executor's threads: decode attention layers x decode
    steps, flash layers x (prefills + 2 per train step), nothing else."""
    want = {k: 0 for k in counts}
    want["decode_attention"] = cfg.num_layers * sum(
        r["decode_steps"] for h in hists for r in h)
    want["flash_attention"] = cfg.num_layers * sum(
        r["prefills"] + 2 * r.get("micro_steps", 1) for h in hists for r in h)
    if counts != want:
        raise AssertionError(f"mux {label}: launches {counts} != {want}")


def mux_check_records(hists, label, stale=(0,)):
    for h in hists:
        for r in h:
            diag = [r[k] for k in ("loss", "grad_norm", "entropy",
                                   "ratio_mean", "ratio_max", "clip_frac")]
            if not np.isfinite(diag).all() or r["tokens"] < 1:
                raise AssertionError(f"mux {label}: iteration {r['step']} "
                                     f"malformed: {r}")
            if r["rollout_staleness"] not in stale:
                raise AssertionError(f"mux {label}: iteration {r['step']} "
                                     f"at staleness "
                                     f"{r['rollout_staleness']}, not in "
                                     f"{stale}")


def mux_summary(report) -> dict:
    s = report.summary()
    s["timelines"] = report.timelines
    return s


def host_mem_available() -> int:
    """The machine's available host memory in bytes (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                return int(ln.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def recording_cache(capacity_bytes: int):
    """A host cache that keeps every CUDA copy's key, kind, bytes and
    timing events, and each offload's buffer address and pinned state.  A
    subclass, as ``mux_job``'s job is."""
    from repro_torch.train.checkpoints import HostStateCache

    class RecordingCache(HostStateCache):
        def __init__(self, capacity):
            super().__init__(capacity)
            self.copies, self.offload_s = [], []

        def offload(self, key, tree):
            first = not self.resident(key)
            s = super().offload(key, tree)
            self.offload_s.append({"key": key, "first": first, "s": s})
            return s

        def _copied(self, key, kind, nbytes, start, end):
            rec = {"key": key, "kind": kind, "bytes": nbytes,
                   "events": (start, end)}
            if kind == "offload":
                with self._lock:
                    leaves = self._store[key].leaves
                rec["ptr"] = leaves[0].data_ptr()
                rec["pinned"] = all(h.is_pinned() for h in leaves)
            self.copies.append(rec)

        def timings(self) -> list:
            """The copies with seconds and GB/s (their events must have
            completed)."""
            out = []
            for c in self.copies:
                start, end = c["events"]
                s = start.elapsed_time(end) / 1e3
                out.append({**{k: v for k, v in c.items() if k != "events"},
                            "s": s, "gb_s": c["bytes"] / max(s, 1e-12) / 1e9})
            return out

    return RecordingCache(capacity_bytes)


def copy_summary(copies) -> dict:
    """Per kind and pool: count, bytes, mean and max seconds, GB/s."""
    out = {}
    for c in copies:
        pool = c["key"].split("/")[-1]
        out.setdefault(f"{c['kind']} {pool}", []).append(c)
    return {k: {"n": len(v), "bytes": v[0]["bytes"],
                "mean_s": float(np.mean([c["s"] for c in v])),
                "max_s": max(c["s"] for c in v),
                "mean_gb_s": float(np.mean([c["gb_s"] for c in v]))}
            for k, v in sorted(out.items())}


def phase_host_cache(torch, dev) -> dict:
    """A standalone round trip through the pinned host cache: a tree of
    about 2 GB (bf16 and float32 leaves, odd shapes, a 0-d and an empty
    leaf) offloaded on one stream and restored on it and on another, bit
    for bit; an offload that follows at once a restore still queued on
    another stream waits for it; every offload of the key reuses its
    buffer; a new layout under the key gets a buffer of its own size; a
    cache collected while a restore from it is still queued leaves that
    restore whole."""
    g = torch.Generator(device=dev).manual_seed(7)
    tree = {"w": torch.randn(512 << 20, generator=g, device=dev,
                             dtype=torch.bfloat16),
            "m": {"a": torch.randn(256 << 20, generator=g, device=dev),
                  "b": torch.randn(3, 5, 7, generator=g, device=dev)},
            "layers": [{"k": torch.randn(1000, 333, generator=g, device=dev,
                                         dtype=torch.bfloat16)}
                       for _ in range(3)],
            "step": torch.tensor(11, dtype=torch.int32, device=dev),
            "empty": torch.empty(0, 4, device=dev)}
    want = _tree_map(lambda x: x.clone(), tree)
    nbytes = sum(x.numel() * x.element_size() for x in _leaves(tree))
    cache = recording_cache(1 << 40)
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    issue = []                              # each restore's host seconds

    def check(label, got):
        torch.cuda.synchronize()
        for a, b in zip(_leaves(got), _leaves(want)):
            if a.dtype != b.dtype or a.shape != b.shape or \
                    not torch.equal(a, b):
                raise AssertionError(f"host cache round trip {label}: a "
                                     f"leaf of shape {tuple(b.shape)} "
                                     f"differs")

    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        cache.offload("rt/train", tree)
        got, s = cache.restore("rt/train")
        issue.append(s)
    check("same stream", got)
    del got
    with torch.cuda.stream(s1):            # change the state, offload again
        for x in _leaves(tree):
            x.mul_(2)
        cache.offload("rt/train", tree)
    want = _tree_map(lambda x: x.clone(), tree)
    with torch.cuda.stream(s2):
        got, s = cache.restore("rt/train")
        issue.append(s)
    check("restored on another stream", got)
    used = cache.used_bytes()
    del got
    # a restore held back on s2, then at once an offload of the key on s1:
    # the offload must wait for the restore's copy before it overwrites the
    # buffer that copy reads
    with torch.cuda.stream(s2):
        torch.cuda._sleep(100_000_000)     # about 50 ms of the card's clock
        got, s = cache.restore("rt/train")
        issue.append(s)
    with torch.cuda.stream(s1):
        new = _tree_map(lambda x: x.neg(), tree)
        cache.offload("rt/train", new)
    check("restored on s2 while s1 offloaded over it", got)
    want = _tree_map(lambda x: x.clone(), new)
    with torch.cuda.stream(s1):
        back, s = cache.restore("rt/train")
        issue.append(s)
    check("the offload after it", back)
    del got, back, new
    offs = [c for c in cache.copies if c["kind"] == "offload"]
    if len({c["ptr"] for c in offs}) != 1 or not all(c["pinned"]
                                                       for c in offs):
        raise AssertionError(f"host cache: offloads of one key did not "
                             f"reuse one pinned buffer: {offs}")
    if not nbytes <= used < nbytes + 256 * len(list(_leaves(tree))):
        raise AssertionError(f"host cache: {used} bytes pinned for a "
                             f"{nbytes}-byte state")
    small = {"w": torch.ones(1000, device=dev)}
    cache.offload("rt/train", small)       # a new layout: a new buffer
    if cache.used_bytes() != 4096:
        raise AssertionError(f"host cache: {cache.used_bytes()} bytes after "
                             f"a 4000-byte state replaced the key")
    torch.cuda.synchronize()
    copies = cache.timings()
    cache.evict("rt/train")
    if cache.used_bytes() != 0:
        raise AssertionError("host cache: evict left bytes pinned")
    # a cache dropped with a restore still queued behind a sleep: its
    # buffer may be unpinned and freed only once the copy has read it
    lost = recording_cache(1 << 40)
    with torch.cuda.stream(s1):
        lost.offload("rt/train", tree)
    want = _tree_map(lambda x: x.clone(), tree)
    with torch.cuda.stream(s2):
        torch.cuda._sleep(100_000_000)
        got, _ = lost.restore("rt/train")
    del lost
    gc.collect()
    check("restored while its cache was collected", got)
    del tree, want, cache, small, got
    torch.cuda.empty_cache()
    big = [c for c in copies if c["bytes"] == used]
    res = {"bytes": nbytes, "pinned_bytes": used, "copies": big,
           "summary": copy_summary(big), "restore_issue_s": issue}
    print(f"[mux] host cache round trip: {nbytes} bytes ({used} pinned), "
          f"bit for bit on one stream, across two and from a cache "
          f"collected with the restore in flight, one buffer for "
          f"{len(offs)} offloads; "
          + "; ".join(f"{c['kind']} {c['s']:.4f}s {c['gb_s']:.2f} GB/s"
                      for c in big)
          + f"; each restore returned after {max(issue) * 1e3:.2f} ms at most")
    return res


def measured_iteration_s(report, jid: str) -> float:
    """A job's seconds per iteration in a mux run: from the start of its
    first rollout to the end of its last train step, over its
    iterations."""
    roll = [iv for iv in report.timelines["rollout"]
            if iv[0].startswith(f"{jid}:")]
    train = [iv for iv in report.timelines["train"]
             if iv[0].startswith(f"{jid}:")]
    return (max(t1 for _, _, t1 in train)
            - min(t0 for _, t0, _ in roll)) / len(train)


def plan_on_profiles(report, jobs, copies) -> dict:
    """The port's planner on the phase profiles coexec measured on the
    card: each profile's ``RLJob``, the intra-group DES with the measured
    warm-start time, the inter-group scheduler admitting both jobs at SLO
    2.0, its contract and the engine policy it gives each job.

    A restore returns once its copies are queued, so each copy's device
    time lies inside its phase's measured run time.  The planner is given
    the phase times less their restores' copies, and the mean of those
    copies as the warm switch, so that it charges each switch once."""
    from repro_torch.core import (GPUS_PER_NODE, InterGroupScheduler,
                                  NodeAllocator, SwitchCosts,
                                  simulate_profiles)
    from repro_torch.serve.sched import SLOPolicy

    restores = {}
    for c in copies:
        if c["kind"] == "restore":
            restores.setdefault(c["key"], []).append(c["s"])
    profiles, switches = {}, []
    for jid, p in report.profiles.items():
        less = {}
        for pool, xs in (("rollout", p.rollout_s), ("train", p.train_s)):
            r = restores.get(f"{jid}/{pool}", [])[:len(xs)]
            if len(r) != len(xs):
                raise AssertionError(f"planner: {jid} has {len(xs)} {pool} "
                                     f"phases but {len(r)} restores")
            less[f"{pool}_s"] = tuple(x - y for x, y in zip(xs, r))
            switches += r
        profiles[jid] = dataclasses.replace(p, **less)
    warm = float(np.mean(switches))
    rl_jobs = {jid: p.to_job() for jid, p in profiles.items()}
    sim = simulate_profiles(list(profiles.values()),
                            switch=SwitchCosts(warm_s=warm))
    measured = {jid: measured_iteration_s(report, jid) for jid in profiles}
    sched = InterGroupScheduler(NodeAllocator(n_rollout_gpus=GPUS_PER_NODE,
                                              n_train_gpus=GPUS_PER_NODE))
    decisions = {}
    for jid, p in profiles.items():
        d = sched.schedule(p.to_job(slo=2.0))
        decisions[jid] = {"group": d.group.gid, "strategy": d.strategy,
                          "delta_cost": d.delta_cost,
                          "rollout_nodes": list(d.placement.rollout_node_ids),
                          "latency_s": d.latency_s}
    contract = sched.slo_contract()
    policies = {}
    for job in jobs:
        dt, steps = map(sum, zip(*job.decode))
        policy = SLOPolicy.from_contract(contract, job.job_id,
                                         time_per_token=dt / steps)
        policies[job.job_id] = {"slowdown": policy.slowdown,
                                "time_per_token": policy.time_per_token}
    keys = set(profiles)
    for name, d in (("to_job", rl_jobs), ("iter_time", sim.iter_time),
                    ("decisions", decisions), ("contract", contract),
                    ("policies", policies)):
        if set(d) != keys:
            raise AssertionError(f"planner: {name} keys {sorted(d)} are not "
                                 f"the jobs {sorted(keys)}")
    nums = [warm, *sim.iter_time.values(), *contract.values(),
            *(p["time_per_token"] for p in policies.values()),
            *(p["slowdown"] for p in policies.values()),
            *(j.t_roll for j in rl_jobs.values()),
            *(p.t_roll - profiles[jid].t_roll
              for jid, p in report.profiles.items()),
            *(j.t_train for j in rl_jobs.values())]
    if not all(np.isfinite(x) and x > 0 for x in nums):
        raise AssertionError(f"planner: a time is not finite and positive: "
                             f"{nums}")
    for jid, j in rl_jobs.items():
        raw = report.profiles[jid]
        print(f"[plan] {jid}.to_job() on its phases less their restores: "
              f"t_roll {j.t_roll:.3f}s (measured {raw.t_roll:.3f}s), "
              f"t_train {j.t_train:.3f}s (measured {raw.t_train:.3f}s), "
              f"runtime_scale "
              f"({j.runtime_scale[0]:.3f}, 1.0); simulated iteration "
              f"{sim.iter_time[jid]:.3f}s with warm_s {warm:.3f}s, measured "
              f"{measured[jid]:.3f}s; decision {decisions[jid]}; contract "
              f"{contract[jid]:.4f}; SLOPolicy slowdown "
              f"{policies[jid]['slowdown']:.4f}, time_per_token "
              f"{policies[jid]['time_per_token'] * 1e3:.2f} ms")
    print(f"[plan] simulated utilisation: rollout {sim.rollout_util:.3f}, "
          f"train {sim.train_util:.3f}, makespan {sim.makespan:.3f}s")
    return {"warm_s": warm,
            "to_job": {k: dataclasses.asdict(v) for k, v in rl_jobs.items()},
            "sim": dataclasses.asdict(sim), "measured_iter_s": measured,
            "decisions": decisions, "contract": contract,
            "policies": policies}


def phase_mux(torch, dev, model, init_params):
    """The mux executors at full width from ``init_params`` (the train
    phase's initial weights): a sequential reference, the pipeline at
    staleness 0 and 1, two co-executed jobs and the streaming executor.
    Each run's launch counts are zeroed before it and read after it."""
    from repro_torch.core import RollMuxRuntime
    from repro_torch.rl.coexec import (run_coexec, run_pipelined,
                                       run_sequential)
    from repro_torch.rl.stream import run_streaming

    cfg = model.cfg
    card = card_line()
    fns = wrappers()
    total = {k: 0 for k in fns}
    results = {}

    def counted(run):
        """``run()``'s histories and report (its final states dropped at
        once, so that they hold no device memory into the next run), its
        launch counts and its wall time."""
        for f in fns.values():
            f.launches = 0
        t0 = time.perf_counter()
        _, hist, report = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: f.launches for k, f in fns.items()}
        for k in total:
            total[k] += counts[k]
        return (hist, report), counts, wall

    def line(label, report, wall, counts, jobs):
        """Print a run's numbers; returns its jobs' decode-block CUDA
        graph captures: count, host seconds, ms per decode step."""
        s = report.summary()
        engines = [e for j in jobs for e in j._engines.values()]
        caps = {"captures": sum(e.captures for e in engines),
                "capture_s": sum(e.capture_s for e in engines),
                "ms_per_decode_step": 1e3 * sum(t for j in jobs
                                                for t, _ in j.decode)
                / max(sum(n for j in jobs for _, n in j.decode), 1)}
        print(f"[mux] {label}: wall {wall:.2f}s; rollout busy "
              f"{s['total_rollout_s']:.3f}s, train busy "
              f"{s['total_train_s']:.3f}s, reward busy "
              f"{s['total_reward_s']:.3f}s; overlap {s['overlap_s']:.3f}s "
              f"of a back-to-back bubble {s['bubble_back_to_back_s']:.3f}s "
              f"(reclaimed {s['reclaimed_bubble_frac']:.4f}); "
              f"{caps['ms_per_decode_step']:.3f} ms per decode step, "
              f"{caps['captures']} CUDA graph captures in "
              f"{caps['capture_s']:.3f}s; launches {counts} ({card})")
        return caps

    # sequential reference and the pipeline at staleness 0, one seed
    seq = mux_job(model, dev, init_params)
    (h_seq, r_seq), c_seq, w_seq = counted(
        lambda: run_sequential(seq))
    mux_launches(cfg, [h_seq], c_seq, "off")
    mux_check_records([h_seq], "off")
    g_seq = line("off", r_seq, w_seq, c_seq, [seq])
    pipe0 = mux_job(model, dev, init_params)
    (h_p0, r_p0), c_p0, w_p0 = counted(
        lambda: run_pipelined(pipe0, max_staleness=0))
    mux_launches(cfg, [h_p0], c_p0, "pipeline-0")
    mux_check_records([h_p0], "pipeline-0")
    g_p0 = line("pipeline staleness 0", r_p0, w_p0, c_p0, [pipe0])
    # nothing overlaps at staleness 0: iteration 0 must be the sequential
    # run's, token for token; a difference points at a stream hand-off
    a, b = seq.seen[0], pipe0.seen[0]
    for k in ("completions", "behavior_logp", "mask"):
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"mux pipeline-0: iteration 0 {k} differs "
                                 f"from the sequential run's")
    rel = abs(h_p0[0]["loss"] - h_seq[0]["loss"]) / max(
        abs(h_seq[0]["loss"]), 1e-30)
    if rel > 1e-4:
        raise AssertionError(f"mux pipeline-0: iteration 0 loss "
                             f"{h_p0[0]['loss']} vs {h_seq[0]['loss']} "
                             f"(relative {rel:.3e} > 1e-4)")
    same1 = {k: bool(torch.equal(seq.seen[1][k], pipe0.seen[1][k]))
             for k in ("completions", "behavior_logp")}
    for k, (r0, r1) in enumerate(zip(h_seq, h_p0)):
        print(f"[mux] iteration {k}: sequential loss={r0['loss']:.8f} "
              f"ratio_mean={r0['ratio_mean']:.6f} tokens={r0['tokens']} | "
              f"pipeline-0 loss={r1['loss']:.8f} "
              f"ratio_mean={r1['ratio_mean']:.6f} tokens={r1['tokens']}")
    print(f"[mux] pipeline-0 iteration 0 identical to the sequential run "
          f"(loss relative difference {rel:.3e}); iteration 1 identical: "
          f"{same1}")
    results["off"] = dict(mux_summary(r_seq), wall=w_seq, history=h_seq,
                          launches=c_seq, graph=g_seq)
    results["pipeline-0"] = dict(mux_summary(r_p0), wall=w_p0, history=h_p0,
                                 launches=c_p0, iteration0_loss_rel=rel,
                                 iteration1_identical=same1, graph=g_p0)
    seq_seen0 = seq.seen[0]
    del seq, pipe0

    pipe1 = mux_job(model, dev, init_params, steps=3)
    (h_p1, r_p1), c_p1, w_p1 = counted(
        lambda: run_pipelined(pipe1, max_staleness=1))
    mux_launches(cfg, [h_p1], c_p1, "pipeline-1")
    mux_check_records([h_p1], "pipeline-1", stale=(0, 1))
    g_p1 = line("pipeline staleness 1", r_p1, w_p1, c_p1, [pipe1])
    print(f"[mux] pipeline-1 staleness "
          f"{[r['rollout_staleness'] for r in h_p1]}, ratio_mean "
          f"{[round(r['ratio_mean'], 6) for r in h_p1]}, clip_frac "
          f"{[r['clip_frac'] for r in h_p1]}")
    results["pipeline-1"] = dict(mux_summary(r_p1), wall=w_p1, history=h_p1,
                                 launches=c_p1, graph=g_p1)
    del pipe1

    # the pinned host cache alone, then two jobs through it, each from its
    # own seed's weights (job0's are init_params, as the sequential run's)
    round_trip = phase_host_cache(torch, dev)
    rt = RollMuxRuntime(host_cache_gb=64.0)
    rt.cache = recording_cache(rt.cache.capacity)
    jobs = [mux_job(model, dev, init_params if seed == 0 else None,
                    f"job{seed}", seed) for seed in (0, 1)]
    mem_before = host_mem_available()
    print(f"[mux] coexec: host memory available {mem_before} bytes "
          f"({mem_before / 2 ** 30:.2f} GiB)")
    torch.cuda.reset_peak_memory_stats()
    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    stats0 = torch.cuda.memory_stats()
    (h_co, r_co), c_co, w_co = counted(
        lambda: run_coexec(jobs, runtime=rt))
    peak = torch.cuda.max_memory_allocated()
    stats1 = torch.cuda.memory_stats()
    allocs = {k: stats1.get(k, 0) - stats0.get(k, 0) for k in alloc_keys}
    allocs["peak_reserved"] = torch.cuda.max_memory_reserved()
    cache_bytes = rt.cache.used_bytes()
    mem_after = host_mem_available()
    mux_launches(cfg, list(h_co.values()), c_co, "coexec")
    mux_check_records(list(h_co.values()), "coexec")
    for pool in ("rollout", "train"):
        tl = sorted(r_co.timelines[pool], key=lambda e: e[1])
        for (_, _, t1), (_, t0, _) in zip(tl, tl[1:]):
            if t0 < t1:
                raise AssertionError(f"mux coexec: {pool} intervals "
                                     f"overlap: {tl}")
        users = [who.split(":")[0] for who, _, _ in tl]
        if len(tl) != 4 or any(u == v for u, v in zip(users[1:],
                                                      users[2:])):
            raise AssertionError(f"mux coexec: {pool} does not alternate: "
                                 f"{users}")
    if r_co.cache_stats["cold_misses"] != 0:
        raise AssertionError(f"mux coexec: cold misses "
                             f"{r_co.cache_stats}")
    # job0's first rollout ran on weights that came back through the
    # pinned cache: it must be the sequential run's, bit for bit
    for k in ("completions", "behavior_logp", "mask"):
        if not torch.equal(jobs[0].seen[0][k], seq_seen0[k]):
            raise AssertionError(f"mux coexec: job0 iteration 0 {k} differs "
                                 f"from the sequential run's")
    copies = rt.cache.timings()
    reuse = {}
    for c in copies:
        if c["kind"] == "offload":
            reuse.setdefault(c["key"], []).append(c)
    for key, offs in reuse.items():
        if len({c["ptr"] for c in offs}) != 1 or not all(
                c["pinned"] for c in offs):
            raise AssertionError(f"mux coexec: offloads of {key} did not "
                                 f"reuse one pinned buffer")
    phases = {k: {"run_time": st.run_time, "runs": st.runs,
                  "warm_starts": st.warm_starts}
              for k, st in sorted(rt.stats.items())}
    summary = copy_summary(copies)
    firsts = {}
    for o in rt.cache.offload_s:
        firsts.setdefault((o["key"].split("/")[-1], o["first"]),
                          []).append(o["s"])
    g_co = line("coexec (2 jobs)", r_co, w_co, c_co, jobs)
    print(f"[mux] coexec: executor wall {r_co.wall_s:.2f}s (the rest of "
          f"{w_co:.2f}s: seeding the cache, the jobs' initial states and "
          f"the final restores); offload host seconds, first into a new "
          f"pinned buffer / later: "
          + "; ".join(f"{pool} {'first' if first else 'later'} "
                      f"{np.mean(v):.3f}s (n {len(v)})"
                      for (pool, first), v in sorted(firsts.items()))
          + f"; device allocator during the run {allocs}")
    print(f"[mux] coexec: host cache {cache_bytes} bytes pinned "
          f"({cache_bytes / 2 ** 30:.2f} GiB; host memory available "
          f"{mem_before} -> {mem_after} bytes after the run), cache "
          f"{r_co.cache_stats}, every later offload of a key into its "
          f"first buffer ({len(reuse)} keys), peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; job0 iteration 0 identical to the "
          f"sequential run's; per phase "
          + "; ".join(f"{k}: {v['runs']} runs, run {v['run_time']:.3f}s"
                      for k, v in phases.items()))
    for k, v in summary.items():
        print(f"[mux] coexec {k}: {v['n']} copies of {v['bytes']} bytes, "
              f"mean {v['mean_s']:.4f}s (max {v['max_s']:.4f}s), "
              f"{v['mean_gb_s']:.2f} GB/s ({card})")
    plan = plan_on_profiles(r_co, jobs, copies)
    results["coexec"] = dict(mux_summary(r_co), wall=w_co, history=h_co,
                             launches=c_co, graph=g_co,
                             host_cache_bytes=cache_bytes,
                             host_mem_available=[mem_before, mem_after],
                             max_memory_allocated=peak, phases=phases,
                             copies=copies, copy_summary=summary,
                             offload_host_s=rt.cache.offload_s,
                             allocator=allocs,
                             iteration0_identical=True)
    results["host_cache"] = round_trip
    results["plan"] = plan
    for key in reuse:                      # unpin the two jobs' states
        rt.cache.evict(key)
    del jobs, rt

    # run_coexec as a user calls it, without a runtime: it makes its own
    # and drops it on return, the host cache with it.  The states it
    # returns must be those the jobs' last train phases gave, bit for bit,
    # also once that cache has been collected.
    jobs = [mux_job(model, dev, init_params if seed == 0 else None,
                    f"job{seed}", seed, steps=1) for seed in (0, 1)]
    for job in jobs:
        job.fingerprints = []
    finals = {}

    def own_runtime():
        states, hist, report = run_coexec(jobs, host_cache_gb=64.0)
        gc.collect()
        finals.update({k: fingerprint(v) for k, v in states.items()})
        return None, hist, report

    (h_own, r_own), c_own, w_own = counted(own_runtime)
    mux_launches(cfg, list(h_own.values()), c_own, "coexec, own runtime")
    mux_check_records(list(h_own.values()), "coexec, own runtime")
    if r_own.cache_stats["cold_misses"] != 0:
        raise AssertionError(f"mux coexec, own runtime: cold misses "
                             f"{r_own.cache_stats}")
    for job in jobs:
        if finals[job.job_id] != job.fingerprints[-1]:
            raise AssertionError(f"mux coexec, own runtime: {job.job_id}'s "
                                 f"returned state is not its last train "
                                 f"phase's")
    for k in ("completions", "behavior_logp", "mask"):
        if not torch.equal(jobs[0].seen[0][k], seq_seen0[k]):
            raise AssertionError(f"mux coexec, own runtime: job0 iteration "
                                 f"0 {k} differs from the sequential run's")
    g_own = line("coexec (2 jobs, 1 iteration, its own runtime)", r_own,
                 w_own, c_own, jobs)
    print(f"[mux] coexec, own runtime: each job's returned state is its "
          f"last train phase's bit for bit "
          f"({len(finals['job0'])} leaves each) after the runtime's cache "
          f"was collected; job0 iteration 0 identical to the sequential "
          f"run's")
    results["coexec_own_runtime"] = dict(
        mux_summary(r_own), wall=w_own, history=h_own, launches=c_own,
        final_state_identical=True, graph=g_own)
    del jobs, finals

    stream = mux_job(model, dev, init_params)
    (h_st, r_st), c_st, w_st = counted(
        lambda: run_streaming(stream, max_staleness=1, reward_workers=2))
    mux_launches(cfg, [h_st], c_st, "stream")
    mux_check_records([h_st], "stream", stale=(0, 1))
    g_st = line("stream staleness 1, 2 reward workers", r_st, w_st, c_st,
                [stream])
    print(f"[mux] stream reward pool: "
          + ", ".join(f"({t0:.3f}, {t1:.3f})"
                      for _, t0, t1 in r_st.timelines["reward"]))
    results["stream"] = dict(mux_summary(r_st), wall=w_st, history=h_st,
                             launches=c_st, graph=g_st)
    del stream
    results["card"] = card
    return total, results


# completion positions re-prefilled by the serve-rwkv6 phase
RECHECK_AT = (0, 31, 63, 127)


def phase_serve_rwkv6(torch, dev):
    """rwkv6-7b at full width through the continuous engine: the scan
    kernel in every prefill, plain decode steps, greedy sampling."""
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models import build_model

    model, params = build(torch, dev, RWKV_ARCH)
    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rep = serve_continuous(RWKV_ARCH, prompts, model=model, params=params,
                           max_new=MAX_NEW, num_slots=SLOTS,
                           kv="contiguous", max_seq_len=MAX_SEQ, device=dev)
    counts = {k: f.launches for k, f in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    steps, outs = rep["decode_steps"], rep["outputs"]
    check_outputs("serve-rwkv6", outs)
    want = {k: 0 for k in counts}
    want["rwkv6_scan"] = cfg.num_layers * rep["prefills"]
    want["greedy_sample"] = steps
    if counts != want or rep["prefills"] != N_REQ:
        raise AssertionError(f"serve-rwkv6: launches {counts} != {want} "
                             f"({rep['prefills']} prefills)")
    step_ms = rep["decode_time_s"] / max(steps, 1) * 1e3
    print(f"[serve-rwkv6] {RWKV_ARCH}: {N_REQ} requests, {rep['tokens']} "
          f"tokens, {steps} decode steps in {rep['wall_s']:.2f}s = "
          f"{rep['tok_per_s']:.1f} tok/s; {step_ms:.3f} ms per decode "
          f"step, {rep['wall_s'] - rep['decode_time_s']:.2f}s outside decode "
          f"(prefill, admission, {rep['captures']} CUDA graph capture(s) "
          f"in {rep['capture_s']:.3f}s); peak memory {peak / 2 ** 30:.2f} "
          f"GiB; launches {counts}")
    graph = graph_vs_eager(torch, dev, model, params, "serve-rwkv6",
                           "contiguous")
    for f in fns.values():
        f.launches = 0
    suspend = recurrent_suspend_check(torch, dev, model, params,
                                      "serve-rwkv6")
    for k, f in fns.items():
        counts[k] += f.launches
    from repro_torch.kernels import rwkv6_scan as rs

    bf = prefill_decode_check(torch, dev, model, params, outs, "serve-rwkv6",
                              "bf16", 0.1,
                              plain=(rs, "rwkv6_scan", rs.rwkv6_scan_plain))
    paged_counts, paged = phase_serve_paged(torch, dev, model, params,
                                            RWKV_ARCH, outs,
                                            "serve-rwkv6-paged")
    prefix_counts, prefix = phase_prefix_sharing(
        torch, dev, model, params, "prefix-ssm-hybrid rwkv6")
    for part in (paged_counts, prefix_counts):
        for k, n in part.items():
            counts[k] += n
    # float32: the same weights upcast, 4 requests
    del rep["engine"]
    params = _tree_map(lambda t: t.float(), params)
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    torch.cuda.empty_cache()
    rep32 = serve_continuous(RWKV_ARCH, prompts[:4], model=model,
                             params=params, max_new=MAX_NEW, num_slots=4,
                             kv="contiguous", max_seq_len=MAX_SEQ, device=dev)
    f32 = prefill_decode_check(torch, dev, model, params, rep32["outputs"],
                               "serve-rwkv6", "float32", 1e-2)
    report = {"tokens": rep["tokens"], "decode_steps": steps,
              "prefills": rep["prefills"], "wall_s": rep["wall_s"],
              "decode_time_s": rep["decode_time_s"],
              "tok_per_s": rep["tok_per_s"], "ms_per_decode_step": step_ms,
              "captures": rep["captures"], "capture_s": rep["capture_s"],
              "graph_vs_eager": graph, "suspend": suspend,
              "max_memory_allocated": peak, "launches": counts,
              "prefill_decode_bf16": bf, "prefill_decode_float32": f32,
              "paged": paged, "prefix": prefix}
    del rep, rep32, model, params
    return counts, report


def prefill_decode_check(torch, dev, model, params, outs, phase, label,
                         tol, *, plain=None, max_seq=MAX_SEQ,
                         frontends=None):
    """Prefill ``prompt + completion[:n]`` again for 4 full completions at
    n in RECHECK_AT and compare the log-probability of ``completion[n]``
    with the engine's (decode) one: the mean of exp(diff) must lie within
    ``tol`` of 1.  The engine's token must also be the prefill's argmax up
    to rounding: its log-probability below the prefill's largest by at most
    ``tol`` in float32 (a wrong argmax of the greedy kernel at this
    vocabulary shows here); in bf16, where rounding moves log-probabilities
    by more, the gap is reported.  ``plain = (module, name, plain_fn)``
    repeats the
    prefills with ``module.name`` (the scan kernel's wrapper) swapped for
    its plain version, as a yardstick of the rounding noise."""
    full = [o for o in outs if o.num_tokens == MAX_NEW][:4]
    if len(full) < 4:
        raise AssertionError(f"{phase} {label}: fewer than 4 full "
                             f"completions")

    def diffs():
        out, gaps = [], []
        for o in full:
            for n in RECHECK_AT:
                seq = np.concatenate([o.prompt, np.asarray(o.tokens[:n],
                                                           np.int32)])
                tokens = torch.from_numpy(seq).to(dev)[None]
                logits, _ = model.prefill(
                    params, tokens, model.init_cache(1, max_seq, device=dev),
                    frontend=frontend_of(frontends, o.rid, dev))
                lps = torch.log_softmax(logits[0], -1)
                lp = float(lps[o.tokens[n]])
                out.append(lp - o.logprobs[n])
                gaps.append(float(lps.max()) - lp)
        return np.asarray(out), np.asarray(gaps)

    deltas, gaps = diffs()
    ratio = float(np.exp(deltas).mean())
    res = {"ratio_mean": ratio, "max_abs_diff": float(np.abs(deltas).max()),
           "max_argmax_gap": float(gaps.max()), "diffs": deltas.tolist()}
    note = ""
    if plain is not None:
        module, name, plain_fn = plain
        kernel = getattr(module, name)
        setattr(module, name, plain_fn)
        try:
            yard, _ = diffs()
        finally:
            setattr(module, name, kernel)
        res.update(plain_ratio_mean=float(np.exp(yard).mean()),
                   plain_max_abs_diff=float(np.abs(yard).max()))
        note = (f"; through the plain scan instead: mean exp(diff) "
                f"{res['plain_ratio_mean']:.6f}, max |diff| "
                f"{res['plain_max_abs_diff']:.4e}")
    print(f"[{phase}] {label}: prefill vs decode log-probabilities at "
          f"n = {RECHECK_AT} for rids {[o.rid for o in full]}: mean "
          f"exp(diff) {ratio:.6f} (held within {tol} of 1), max |diff| "
          f"{res['max_abs_diff']:.4e}; engine's token below the prefill's "
          f"argmax by at most {res['max_argmax_gap']:.4e}{note}")
    if abs(ratio - 1) > tol:
        raise AssertionError(f"{phase} {label}: prefill and decode "
                             f"disagree, mean exp(diff) {ratio}")
    if label == "float32" and res["max_argmax_gap"] > tol:
        raise AssertionError(f"{phase} {label}: the engine's token is not "
                             f"the prefill's argmax (gap "
                             f"{res['max_argmax_gap']})")
    return res


def phase_serve_zamba2(torch, dev):
    """zamba2-2.7b at full width through the continuous engine: the SSD
    scan kernel in every Mamba2 layer and flash attention in every shared
    block of every prefill, plain decode steps, greedy sampling."""
    from repro_torch.kernels import mamba2_scan as ms
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models import build_model

    model, params = build(torch, dev, ZAMBA_ARCH)
    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rep = serve_continuous(ZAMBA_ARCH, prompts, model=model, params=params,
                           max_new=MAX_NEW, num_slots=SLOTS,
                           kv="contiguous", max_seq_len=MAX_SEQ, device=dev)
    counts = {k: f.launches for k, f in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    steps, outs = rep["decode_steps"], rep["outputs"]
    check_outputs("serve-zamba2", outs)
    uses = cfg.num_layers // cfg.hybrid_attn_every
    want = {k: 0 for k in counts}
    want["mamba2_scan"] = cfg.num_layers * rep["prefills"]
    want["flash_attention"] = uses * rep["prefills"]
    want["greedy_sample"] = steps
    if counts != want or rep["prefills"] != N_REQ:
        raise AssertionError(f"serve-zamba2: launches {counts} != {want} "
                             f"({rep['prefills']} prefills)")
    step_ms = rep["decode_time_s"] / max(steps, 1) * 1e3
    print(f"[serve-zamba2] {ZAMBA_ARCH}: {N_REQ} requests, {rep['tokens']} "
          f"tokens, {steps} decode steps in {rep['wall_s']:.2f}s = "
          f"{rep['tok_per_s']:.1f} tok/s; {step_ms:.3f} ms per decode "
          f"step, {rep['wall_s'] - rep['decode_time_s']:.2f}s outside decode "
          f"(prefill, admission, {rep['captures']} CUDA graph capture(s) "
          f"in {rep['capture_s']:.3f}s); peak memory {peak / 2 ** 30:.2f} "
          f"GiB; launches {counts}")
    graph = graph_vs_eager(torch, dev, model, params, "serve-zamba2",
                           "contiguous")
    for f in fns.values():
        f.launches = 0
    suspend = recurrent_suspend_check(torch, dev, model, params,
                                      "serve-zamba2")
    for k, f in fns.items():
        counts[k] += f.launches
    bf = prefill_decode_check(torch, dev, model, params, outs,
                              "serve-zamba2", "bf16", 0.1,
                              plain=(ms, "mamba2_scan", ms.mamba2_scan_plain))
    paged_counts, paged = phase_serve_paged(torch, dev, model, params,
                                            ZAMBA_ARCH, outs,
                                            "serve-zamba2-paged")
    prefix_counts, prefix = phase_prefix_sharing(
        torch, dev, model, params, "prefix-ssm-hybrid zamba2")
    for f in fns.values():
        f.launches = 0
    paged["suspend"] = recurrent_suspend_check(
        torch, dev, model, params, "serve-zamba2-paged", kv="paged")
    for k, f in fns.items():
        counts[k] += f.launches
    disagg_counts, paged["disagg"] = phase_router(
        torch, dev, model, params, "serve-zamba2-paged")
    for part in (paged_counts, prefix_counts, disagg_counts):
        for k, n in part.items():
            counts[k] += n
    # float32: the same weights upcast, 4 requests
    del rep["engine"]
    params = _tree_map(lambda t: t.float(), params)
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    torch.cuda.empty_cache()
    rep32 = serve_continuous(ZAMBA_ARCH, prompts[:4], model=model,
                             params=params, max_new=MAX_NEW, num_slots=4,
                             kv="contiguous", max_seq_len=MAX_SEQ, device=dev)
    f32 = prefill_decode_check(torch, dev, model, params, rep32["outputs"],
                               "serve-zamba2", "float32", 1e-2)
    for f in fns.values():
        f.launches = 0
    p32 = serve_continuous(ZAMBA_ARCH, prompts[:4], model=model,
                           params=params, max_new=MAX_NEW, num_slots=4,
                           kv="paged", max_seq_len=MAX_SEQ, device=dev)
    for k, f in fns.items():
        counts[k] += f.launches
    d32 = divergence(torch, dev, model, params, p32["outputs"],
                     rep32["outputs"])
    if d32["diverged"] or d32["max_abs_diff"] > PAGED32_TOL:
        raise AssertionError(f"serve-zamba2-paged float32: against "
                             f"contiguous {d32}")
    print(f"[serve-zamba2-paged] float32, 4 requests: tokens the "
          f"contiguous run's, logprobs max |diff| "
          f"{d32['max_abs_diff']:.3e} (held within {PAGED32_TOL})")
    paged["float32"] = d32
    report = {"tokens": rep["tokens"], "decode_steps": steps,
              "prefills": rep["prefills"], "wall_s": rep["wall_s"],
              "decode_time_s": rep["decode_time_s"],
              "tok_per_s": rep["tok_per_s"], "ms_per_decode_step": step_ms,
              "captures": rep["captures"], "capture_s": rep["capture_s"],
              "graph_vs_eager": graph, "suspend": suspend,
              "max_memory_allocated": peak, "launches": counts,
              "prefill_decode_bf16": bf,
              "prefill_decode_float32": f32,
              "paged": paged, "prefix": prefix}
    del rep, rep32, p32, model, params
    return counts, report


PAGED_BF16_TOL = 0.1   # zamba2 paged against contiguous, bf16: mean
#                        exp(diff) of the agreeing positions' logprobs
PAGED32_TOL = 1e-4     # the same in float32, every logprob


def divergence(torch, dev, model, params, outs, ref,
               max_seq=MAX_SEQ, frontends=None) -> dict:
    """Where each request of ``outs`` first leaves ``ref`` (a run on the
    contiguous layout): the logprob differences before that point and, for
    each divergent request, the top-2 gap of ``ref``'s logits there (a
    prefill of prompt + ``ref``'s tokens before it, with the request's
    frontend)."""
    diffs, diverged = [], {}
    for o, r in zip(outs, ref):
        n = next((i for i, (a, b) in enumerate(zip(o.tokens, r.tokens))
                  if a != b), min(len(o.tokens), len(r.tokens)))
        diffs += (np.asarray(o.logprobs[:n]) - np.asarray(r.logprobs[:n])
                  ).tolist()
        if n < min(len(o.tokens), len(r.tokens)):
            seq = np.concatenate([r.prompt, np.asarray(r.tokens[:n],
                                                       np.int32)])
            logits, _ = model.prefill(
                params, torch.from_numpy(seq).to(dev)[None],
                model.init_cache(1, max_seq, device=dev),
                frontend=frontend_of(frontends, o.rid, dev))
            top = torch.topk(logits[0].float(), 2).values
            diverged[o.rid] = {"at": n, "top2_gap": float(top[0] - top[1])}
    diffs = np.asarray(diffs)
    return {"ratio_mean": float(np.exp(diffs).mean()),
            "max_abs_diff": float(np.abs(diffs).max()),
            "diverged": diverged}


def recheck_hybrid_pool(torch, dev, engine, run) -> float:
    """The paged kernel against its plain version on each shared-block
    use's pool and the tables the run left."""
    from repro_torch.kernels import decode_attention as da

    cache, cfg = engine.slots.cache, engine.model.cfg
    tables, lengths = engine.slots._tables_dev, cache["index"]
    q = torch.randn(SLOTS, cfg.num_heads, cfg.resolved_head_dim,
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev, dtype=engine.params["embed"].dtype)
    err = 0.0
    for occ in range(cache["attn_k"].shape[0]):
        kw = {}
        if "attn_k_scale" in cache:
            kw = dict(k_scale=cache["attn_k_scale"][occ],
                      v_scale=cache["attn_v_scale"][occ])
        args = (q, cache["attn_k"][occ], cache["attn_v"][occ], tables,
                lengths)
        err = max(err, check_close(
            torch, f"{run} pool use {occ}",
            da.paged_decode_attention(*args, **kw),
            da.paged_decode_attention_plain(*args, **kw), ATTN_TOL))
    return err


def phase_serve_paged(torch, dev, model, params, arch, contiguous,
                      phase) -> tuple:
    """The serve shape on paged KV for a recurrent model: bf16 (zamba2
    also int8), held to the contiguous run ``contiguous`` (rwkv6 bit for
    bit: the same decode step; zamba2 within PAGED_BF16_TOL, divergent
    requests reported with their top-2 gap), exact launches, one decode
    capture; zamba2's paged kernel on the run's pools against its plain
    version."""
    from repro_torch.launch.serve import serve_continuous

    cfg = model.cfg
    hybrid = cfg.family == "hybrid"
    prompts = serve_prompts(cfg.vocab_size)
    fns = wrappers()
    total = {k: 0 for k in fns}
    res = {}
    for kv_dtype in ((None, "int8") if hybrid else (None,)):
        run = "paged" + ("-int8" if kv_dtype else "")
        for f in fns.values():
            f.launches = 0
        rep = serve_continuous(arch, prompts, model=model, params=params,
                               max_new=MAX_NEW, num_slots=SLOTS, kv="paged",
                               kv_dtype=kv_dtype, max_seq_len=MAX_SEQ,
                               device=dev)
        counts = {k: f.launches for k, f in fns.items()}
        steps, outs = rep["decode_steps"], rep["outputs"]
        check_outputs(f"{phase} {run}", outs)
        want = serve_launches(cfg, counts, "paged_decode_attention", steps,
                              rep["prefills"])
        if counts != want or rep["prefills"] != N_REQ \
                or rep["captures"] != int(dev.type == "cuda"):
            raise AssertionError(f"{phase} {run}: launches {counts} != "
                                 f"{want} ({rep['prefills']} prefills, "
                                 f"{rep['captures']} captures)")
        for k in total:
            total[k] += counts[k]
        step_ms = rep["decode_time_s"] / max(steps, 1) * 1e3
        r = {"tokens": rep["tokens"], "decode_steps": steps,
             "wall_s": rep["wall_s"], "tok_per_s": rep["tok_per_s"],
             "ms_per_decode_step": step_ms, "captures": rep["captures"],
             "capture_s": rep["capture_s"], "launches": counts,
             "peak_kv_blocks": rep["peak_kv_blocks"]}
        if hybrid:
            d = divergence(torch, dev, model, params, outs, contiguous)
            first = all(o.tokens[0] == c.tokens[0] and o.logprobs[0]
                        == c.logprobs[0] for o, c in zip(outs, contiguous))
            if not first or abs(d["ratio_mean"] - 1) > PAGED_BF16_TOL:
                raise AssertionError(f"{phase} {run}: against contiguous, "
                                     f"first tokens equal {first}, mean "
                                     f"exp(diff) {d['ratio_mean']}")
            r.update(d, kernel_on_pool_err=recheck_hybrid_pool(
                torch, dev, rep["engine"], f"{phase} {run}"))
            cmp = (f"against contiguous (plain gqa_decode_step): first "
                   f"tokens identical, mean exp(diff) "
                   f"{d['ratio_mean']:.6f} (held within {PAGED_BF16_TOL} of "
                   f"1), max |diff| {d['max_abs_diff']:.4e} before any "
                   f"divergence; {len(d['diverged'])} of {N_REQ} diverge "
                   f"(rid: position, top-2 gap) "
                   + ", ".join(f"{k}: {v['at']}, {v['top2_gap']:.4f}"
                               for k, v in d["diverged"].items())
                   + f"; paged kernel on the run's pools max_abs_err "
                   f"{r['kernel_on_pool_err']:.3e}")
        else:
            if not same_outputs(outs, contiguous) \
                    or rep["peak_kv_blocks"] != 0:
                raise AssertionError(f"{phase} {run}: differs from the "
                                     f"contiguous run")
            cmp = "tokens and logprobs the contiguous run's bit for bit"
        print(f"[{phase}] {run}: {N_REQ} requests, {rep['tokens']} tokens, "
              f"{steps} decode steps in {rep['wall_s']:.2f}s = "
              f"{rep['tok_per_s']:.1f} tok/s; {step_ms:.3f} ms per decode "
              f"step; 1 capture in {rep['capture_s']:.3f}s; peak KV blocks "
              f"{rep['peak_kv_blocks']}; {cmp}; launches {counts}")
        res[run] = r
        del rep, outs
    return total, res


def phase_prefix_sharing(torch, dev, model, params, phase, *, prompts=None,
                         max_seq=MAX_SEQ) -> tuple:
    """GRPO-shaped traffic (the first N_REQ / GROUP serve prompts x GROUP,
    or ``prompts``, GROUP copies of each) on paged pools with radix sharing
    on against off: bit for bit, model prefills (the launches of the
    prefill's layer kernel over the layers: a recurrent model's scan, a
    dense model's flash) one a group against one a request, misses and
    hits, one capture an engine; zamba2 on bf16 and int8 (full blocks
    shared), a dense model on bf16, rwkv6 with one block of MAX_SEQ (no
    paged leaf: the block size only keys the tree, and a prompt shorter
    than a block registers as a root snapshot, blocks_saved 0)."""
    from repro_torch.serve import Engine, EngineConfig

    cfg = model.cfg
    ssm = cfg.family == "ssm"
    prefill = {"hybrid": "mamba2_scan", "ssm": "rwkv6_scan"}.get(
        cfg.family, "flash_attention")
    if prompts is None:
        prompts = grpo_prompts(cfg.vocab_size)
    fns = wrappers()
    total = {k: 0 for k in fns}
    res = {}
    runs = {"hybrid": ((None, 16), ("int8", 16)),
            "ssm": ((None, MAX_SEQ),)}.get(cfg.family, ((None, 16),))
    for kv_dtype, bs in runs:
        run = "paged" + ("-int8" if kv_dtype else "")
        got = {}
        for share in (False, True):
            eng = Engine(model, params, EngineConfig(
                num_slots=SLOTS, max_seq_len=max_seq, kv_layout="paged",
                kv_block_size=bs, kv_dtype=kv_dtype, prefix_share=share),
                device=dev)
            for f in fns.values():
                f.launches = 0
            outs, wall, ttft = drive(torch, eng, prompts)
            counts = {k: f.launches for k, f in fns.items()}
            add_counts(total, counts)
            m = eng.metrics()
            got[share] = dict(outs=outs, wall=wall, ttft=ttft,
                              prefills=counts[prefill] // cfg.num_layers,
                              hits=m.prefix_hits, misses=m.prefix_misses,
                              saved=m.blocks_saved, captures=eng.captures)
            del eng
        off, on = got[False], got[True]
        n_req = len(prompts)
        n_groups = n_req // GROUP
        if not same_outputs(on["outs"], off["outs"]) or \
                (on["prefills"], off["prefills"]) != (n_groups, n_req) or \
                (on["misses"], on["hits"]) != (n_groups, n_req - n_groups) \
                or (ssm and on["saved"]) or \
                {on["captures"], off["captures"]} != {int(dev.type == "cuda")}:
            raise AssertionError(
                f"{phase} {run}: sharing on {on['prefills']} prefills, "
                f"misses/hits {on['misses']}/{on['hits']}, blocks_saved "
                f"{on['saved']}, captures {on['captures']}/"
                f"{off['captures']}, outputs identical "
                f"{same_outputs(on['outs'], off['outs'])}")
        tok = sum(o.num_tokens for o in on["outs"])
        print(f"[{phase}] {run} (block {bs}), {n_groups} prompts x group "
              f"{GROUP}: sharing on bit for bit with off; model prefills "
              f"{on['prefills']} vs {off['prefills']}; misses "
              f"{on['misses']}, hits {on['hits']}, blocks_saved "
              f"{on['saved']}; wall {on['wall']:.2f} vs {off['wall']:.2f}s, "
              f"{tok / on['wall']:.1f} vs {tok / off['wall']:.1f} tok/s, "
              f"mean TTFT {on['ttft'] * 1e3:.1f} vs {off['ttft'] * 1e3:.1f} "
              f"ms; one capture an engine")
        res[run] = {k: {kk: vv for kk, vv in v.items() if kk != "outs"}
                    for k, v in (("off", off), ("on", on))}
    return total, res


def phase_router(torch, dev, model, params, phase, *, prompts=None,
                 max_seq=MAX_SEQ, frontends=None) -> tuple:
    """A router of PD_PREFILL prefill and PD_DECODE decode slots on paged
    KV against a monolithic paged engine of PD_DECODE slots, bit for bit,
    over the serve prompts (or ``prompts``, with ``frontends``); every
    handle released, both pools clean."""
    from repro_torch.serve import (DisaggConfig, DisaggRouter, Engine,
                                   EngineConfig)

    if prompts is None:
        prompts = serve_prompts(model.cfg.vocab_size)
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    mono = Engine(model, params, EngineConfig(
        num_slots=PD_DECODE, max_seq_len=max_seq, kv_layout="paged"),
        device=dev)
    ref, mwall, _ = drive(torch, mono, prompts, frontends=frontends)
    del mono
    router = DisaggRouter(model, params, DisaggConfig(
        prefill_slots=PD_PREFILL, decode_slots=PD_DECODE,
        max_seq_len=max_seq, kv_layout="paged"), device=dev)
    outs, wall, _ = drive(torch, router, prompts, frontends=frontends)
    m = router.metrics()
    if not same_outputs(outs, ref) or m.transfers != len(prompts) \
            or router.decode.captures != int(dev.type == "cuda"):
        raise AssertionError(f"{phase}: the router differs from the "
                             f"monolithic paged engine ({m.transfers} "
                             f"transfers, {router.decode.captures} "
                             f"captures)")
    xfer_ms = 1e3 * np.asarray([t1 - t0 for _, t0, t1
                                in router.transfer_timeline])
    print(f"[{phase}] router {PD_PREFILL}+{PD_DECODE} on paged KV: bit for "
          f"bit with a monolithic paged engine of {PD_DECODE} slots; "
          f"{m.transfers} transfers ({m.transferred_blocks} blocks), host "
          f"ms per adoption mean {xfer_ms.mean():.3f}; wall {wall:.2f} vs "
          f"{mwall:.2f}s")
    router.reset()
    counts = {k: f.launches for k, f in fns.items()}
    del router, outs
    return counts, {"transfers": m.transfers, "adoption_ms":
                    xfer_ms.tolist(), "wall_s": wall, "mono_wall_s": mwall}


GEMMA_ARCH, GEMMA_SEQ, GEMMA_WINDOW = "gemma3-4b", 2048, 1024
DENSE32_TOL = 1e-3     # float32 prefill against decode, gemma3, minitron
RING_STEPS, RING_PROMPT, RING_FULL = 256, 960, 1280
RING32_TOL = 1e-4      # ring against full cache, float32, of max |logit|
DENSE_ARCHS = ("minitron-8b", "qwen2.5-32b")
DENSE_REQ, DENSE_SLOTS, DENSE_NEW = 8, 4, 64
DENSE_F32 = ("minitron-8b",)   # qwen2.5-32b's float32 copy does not fit


def gemma_prompts(vocab_size, n=N_REQ):
    """``n`` prompts of 600-1900 ids from ``RandomState(0)``, made so that
    gemma3's 1024 window bites: a quarter end below position 1024 and
    decode across it (900-1023 ids), half are longer than the window
    (1025-1900), the rest anywhere in 600-1900; shuffled."""
    rs = np.random.RandomState(0)
    q = n // 4
    lens = np.concatenate([rs.randint(900, GEMMA_WINDOW, size=q),
                           rs.randint(GEMMA_WINDOW + 1, 1901, size=2 * q),
                           rs.randint(600, 1901, size=n - 3 * q)])
    return [rs.randint(0, vocab_size, size=int(k)).astype(np.int32)
            for k in rs.permutation(lens)]


def weight_bound_ms(params) -> float:
    """A decode step's least time: every weight read once at HBM_BPS."""
    return sum(t.numel() * t.element_size() for t in _leaves(params)) \
        / HBM_BPS * 1e3


def serve_layouts(torch, dev, model, params, arch, prompts, phase, *,
                  layouts, slots, max_new, max_seq, frontends=None,
                  per_run=None) -> tuple:
    """``prompts`` through ``serve_continuous`` on each layout: exact
    launches, finished outputs; tok/s, ms per decode step against the
    weight-bytes bound, peak memory.  Every layout after the first is held
    to the first (contiguous) as ``phase_serve_paged`` holds zamba2's:
    first tokens and logprobs identical, mean exp(diff) before a request's
    first divergence within PAGED_BF16_TOL of 1, divergent requests
    reported with their top-2 gap.  ``per_run(run, report)``, when given,
    is called right after each layout's serve run, before anything else
    runs the model, and returns more of its report.  Returns the launch
    totals, the reports and the first layout's outputs."""
    from repro_torch.launch.serve import serve_continuous

    cfg = model.cfg
    fns = wrappers()
    total = {k: 0 for k in fns}
    bound_ms = weight_bound_ms(params)
    res, base = {}, None
    for kv, kv_dtype in layouts:
        run = kv + ("-int8" if kv_dtype else "")
        for f in fns.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rep = serve_continuous(arch, prompts, model=model, params=params,
                               max_new=max_new, num_slots=slots, kv=kv,
                               kv_dtype=kv_dtype, max_seq_len=max_seq,
                               device=dev, frontends=frontends)
        counts = {k: f.launches for k, f in fns.items()}
        peak = torch.cuda.max_memory_allocated()
        steps, outs = rep["decode_steps"], rep["outputs"]
        check_outputs(f"{phase} {run}", outs, len(prompts), max_new)
        want = serve_launches(cfg, counts, LAYOUT_ATTN[kv], steps,
                              rep["prefills"])
        if counts != want or rep["prefills"] != len(prompts) \
                or rep["captures"] != int(dev.type == "cuda"):
            raise AssertionError(f"{phase} {run}: launches {counts} != "
                                 f"{want} ({rep['prefills']} prefills, "
                                 f"{rep['captures']} captures)")
        add_counts(total, counts)
        # before the comparison below, whose prefills run the model again
        extra = {} if per_run is None else per_run(run, rep)
        step_ms = rep["decode_time_s"] / max(steps, 1) * 1e3
        r = {"tokens": rep["tokens"], "decode_steps": steps,
             "wall_s": rep["wall_s"], "tok_per_s": rep["tok_per_s"],
             "ms_per_decode_step": step_ms, "weight_bound_ms": bound_ms,
             "captures": rep["captures"], "capture_s": rep["capture_s"],
             "max_memory_allocated": peak, "launches": counts}
        cmp = ""
        if base is None:
            base = outs
        else:
            d = divergence(torch, dev, model, params, outs, base, max_seq,
                           frontends)
            first = all(o.tokens[0] == c.tokens[0] and o.logprobs[0]
                        == c.logprobs[0] for o, c in zip(outs, base))
            if not first or abs(d["ratio_mean"] - 1) > PAGED_BF16_TOL:
                raise AssertionError(f"{phase} {run}: against contiguous, "
                                     f"first tokens equal {first}, mean "
                                     f"exp(diff) {d['ratio_mean']}")
            r.update(d, bit_for_bit=same_outputs(outs, base))
            cmp = (f"; against contiguous: first tokens identical, "
                   f"{'bit for bit' if r['bit_for_bit'] else 'not bit for bit'}"
                   f", mean exp(diff) {d['ratio_mean']:.6f} (held within "
                   f"{PAGED_BF16_TOL} of 1), max |diff| "
                   f"{d['max_abs_diff']:.4e} before any divergence; "
                   f"{len(d['diverged'])} of {len(prompts)} diverge "
                   f"(rid: position, top-2 gap) "
                   + ", ".join(f"{k}: {v['at']}, {v['top2_gap']:.4f}"
                               for k, v in d["diverged"].items()))
        print(f"[{phase}] {run}: {len(prompts)} requests, {rep['tokens']} "
              f"tokens, {steps} decode steps in {rep['wall_s']:.2f}s = "
              f"{rep['tok_per_s']:.1f} tok/s; {step_ms:.3f} ms per decode "
              f"step (weight-bytes bound {bound_ms:.3f} ms, "
              f"{step_ms / bound_ms:.2f}x), "
              f"{rep['wall_s'] - rep['decode_time_s']:.2f}s outside decode "
              f"(1 capture in "
              f"{rep['capture_s']:.3f}s); peak memory {peak / 2 ** 30:.2f} "
              f"GiB; launches {counts}{cmp}")
        r.update(extra)
        res[run] = r
        del rep
    return total, res, base


def phase_serve_gemma3(torch, dev):
    """gemma3-4b at full width and depth (34 layers, 5 local windowed at
    1024 : 1 global, D 256, vocab 262144, tied embeddings) through the
    continuous engine: the D 256 decode and flash instances, greedy at V
    262144, graph against eager, float32 prefill against decode, radix
    sharing and a router."""
    model, params = build(torch, dev, GEMMA_ARCH)
    cfg = model.cfg
    prompts = gemma_prompts(cfg.vocab_size)
    lens = np.asarray([len(p) for p in prompts])
    longer = int((lens > GEMMA_WINDOW).sum())
    across = int(((lens < GEMMA_WINDOW)
                  & (lens + MAX_NEW > GEMMA_WINDOW)).sum())
    print(f"[serve-gemma3] {N_REQ} prompts of {lens.min()}-{lens.max()} "
          f"ids: {longer} longer than the {GEMMA_WINDOW} window, {across} "
          f"ending below position {GEMMA_WINDOW} and decoding across it")
    if longer < 8 or across < 4:
        raise AssertionError("serve-gemma3: the window does not bite")
    counts, layouts, base = serve_layouts(
        torch, dev, model, params, GEMMA_ARCH, prompts, "serve-gemma3",
        layouts=(("contiguous", None), ("paged", None), ("paged", "int8")),
        slots=SLOTS, max_new=MAX_NEW, max_seq=GEMMA_SEQ)
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    graph = {run: graph_vs_eager(torch, dev, model, params, "serve-gemma3",
                                 run, kv=kv, kv_dtype=kv_dtype,
                                 prompts=prompts, max_seq=GEMMA_SEQ)
             for run, kv, kv_dtype in (("contiguous", "contiguous", None),
                                       ("paged", "paged", None),
                                       ("paged-int8", "paged", "int8"))}
    add_counts(counts, {k: f.launches for k, f in fns.items()})
    share_counts, share = phase_prefix_sharing(
        torch, dev, model, params, "serve-gemma3", max_seq=GEMMA_SEQ,
        prompts=[p for p in prompts[:N_REQ // GROUP] for _ in range(GROUP)])
    add_counts(counts, share_counts)
    router_counts, router = phase_router(
        torch, dev, model, params, "serve-gemma3", prompts=prompts,
        max_seq=GEMMA_SEQ)
    add_counts(counts, router_counts)
    f32_counts, f32 = float32_check(torch, dev, model, params, GEMMA_ARCH,
                                    prompts[:4], "serve-gemma3",
                                    max_seq=GEMMA_SEQ)
    add_counts(counts, f32_counts)
    ring_counts, ring = ring_check(torch, dev, model, params)
    add_counts(counts, ring_counts)
    report = {"prompt_lengths": lens.tolist(), "longer_than_window": longer,
              "across_window": across, "layouts": layouts,
              "graph_vs_eager": graph, "sharing": share, "router": router,
              "prefill_decode_float32": f32, "ring": ring,
              "launches": counts}
    del model, params, base
    return counts, report


def float32_check(torch, dev, model, params, arch, prompts, phase, *,
                  max_seq, frontends=None) -> tuple:
    """The same weights upcast to float32: ``prompts`` (with
    ``frontends``) served on contiguous KV (4 slots, MAX_NEW new tokens),
    decode held to prefill by ``prefill_decode_check`` within DENSE32_TOL.
    Returns the launch counts and its report."""
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models import build_model

    p32 = _tree_map(lambda t: t.float(), params)
    m32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    torch.cuda.empty_cache()
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    rep32 = serve_continuous(arch, prompts, model=m32, params=p32,
                             max_new=MAX_NEW, num_slots=4, kv="contiguous",
                             max_seq_len=max_seq, device=dev,
                             frontends=frontends)
    check_outputs(f"{phase} float32", rep32["outputs"], len(prompts))
    res = prefill_decode_check(torch, dev, m32, p32, rep32["outputs"],
                               phase, "float32", DENSE32_TOL,
                               max_seq=max_seq, frontends=frontends)
    counts = {k: f.launches for k, f in fns.items()}
    del rep32, p32, m32
    torch.cuda.empty_cache()
    return counts, res


def ring_check(torch, dev, model, params) -> tuple:
    """ring-gemma3: every layer windowed (``local_global_ratio=0``, the
    ring carve), 2 rows: RING_PROMPT ids prefilled into a ring cache of
    ``min(RING_FULL, window)`` slots and into a full cache of RING_FULL,
    then RING_STEPS teacher-forced decode steps through both (the ring
    wraps after window - RING_PROMPT steps).  float32: the logits within
    RING32_TOL of the full cache's, relative to the largest |logit|; bf16:
    the largest difference, and the greedy tokens that differ with their
    top-2 gaps (reported)."""
    from repro_torch.models.model import Model

    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    rs = np.random.RandomState(2)
    B, w = 2, model.cfg.sliding_window
    ids = torch.from_numpy(rs.randint(
        0, model.cfg.vocab_size, size=(B, RING_PROMPT + RING_STEPS)).astype(
            np.int32)).to(dev)
    res = {}
    for dtype in ("float32", "bfloat16"):
        m = Model(dataclasses.replace(model.cfg, local_global_ratio=0,
                                      dtype=dtype))
        p = params if dtype == "bfloat16" else _tree_map(
            lambda t: t.float(), params)
        ring = m.init_cache(B, RING_FULL, ring=True, device=dev)
        full = m.init_cache(B, RING_FULL, device=dev)
        if ring["k"].shape[2] != w:
            raise AssertionError(f"ring cache of {ring['k'].shape[2]} slots")
        diffs, scales, flips = [], [], []

        def compare(t, lr, lf):
            diffs.append((lr - lf).abs().max())
            scales.append(lf.abs().max())
            if dtype == "bfloat16":
                for row in torch.nonzero(lr.argmax(-1) != lf.argmax(-1)
                                         ).flatten().tolist():
                    top = torch.topk(lf[row], 2).values
                    flips.append((t, row, float(top[0] - top[1])))

        compare(-1, m.prefill(p, ids[:, :RING_PROMPT], ring)[0],
                m.prefill(p, ids[:, :RING_PROMPT], full)[0])
        for t in range(RING_STEPS):
            tok = ids[:, RING_PROMPT + t:RING_PROMPT + t + 1]
            compare(t, m.decode_step(p, tok, ring, ring=True)[0],
                    m.decode_step(p, tok, full)[0])
        worst = float(torch.stack(diffs).max())
        scale = float(torch.stack(scales).max())
        rel = worst / scale
        res[dtype] = {"max_abs_diff": worst, "max_abs_logit": scale,
                      "relative": rel, "greedy_flips": flips}
        print(f"[ring-gemma3] {dtype}: {B} rows, {RING_PROMPT} ids "
              f"prefilled, {RING_STEPS} decode steps on a ring of {w} "
              f"slots (wraps after {w - RING_PROMPT}) against a full cache of "
              f"{RING_FULL}: max |diff| {worst:.4e}, {rel:.3e} of the "
              f"largest |logit| {scale:.3f} (step -1: the prefill)"
              + (f" (held within {RING32_TOL})" if dtype == "float32" else
                 f"; greedy tokens differing at {len(flips)} of "
                 f"{B * RING_STEPS} (step, row, top-2 gap) {flips[:8]}"))
        if dtype == "float32" and not rel <= RING32_TOL:
            raise AssertionError(f"ring-gemma3: float32 ring decode off the "
                                 f"full cache by {rel:.3e} of the largest "
                                 f"logit")
        del ring, full, p
        torch.cuda.empty_cache()
    counts = {k: f.launches for k, f in fns.items()}
    want = {k: 0 for k in counts}
    want["decode_attention"] = 2 * 2 * RING_STEPS * model.cfg.num_layers
    want["flash_attention"] = 2 * 2 * model.cfg.num_layers
    if counts != want:
        raise AssertionError(f"ring-gemma3: launches {counts} != {want}")
    return counts, res


def phase_serve_dense(torch, dev, arch) -> tuple:
    """minitron-8b or qwen2.5-32b at full width and depth: DENSE_REQ
    requests of 32-512 ids on DENSE_SLOTS slots, DENSE_NEW new tokens,
    contiguous and paged, exact launches, paged held to contiguous; the
    DENSE_F32 models also in float32, prefill against decode."""
    model, params = build(torch, dev, arch)
    prompts = serve_prompts(model.cfg.vocab_size)[:DENSE_REQ]
    counts, res, _ = serve_layouts(
        torch, dev, model, params, arch, prompts, f"serve-{arch}",
        layouts=(("contiguous", None), ("paged", None)), slots=DENSE_SLOTS,
        max_new=DENSE_NEW, max_seq=MAX_SEQ)
    if arch in DENSE_F32:
        f32_counts, res["prefill_decode_float32"] = float32_check(
            torch, dev, model, params, arch, prompts, f"serve-{arch}",
            max_seq=MAX_SEQ)
        add_counts(counts, f32_counts)
    del model, params
    return counts, res


MOE_ARCH = "dbrx-132b"
MOE_PHASE = f"serve-{MOE_ARCH}-cut"
MLA_ARCH = "deepseek-v2-236b"
MLA_PHASE = "serve-deepseek-v2-cut"
MOE_LAYERS = 8         # a cut: full width, 8 layers (dbrx 40, deepseek 60)
MOE_SLOTS, MOE_NEW = 8, 64
MOE_F32_LAYERS = 2     # the float32 copy: 7.75 B (dbrx), 5.36 B (deepseek)
MLA_SLOT_COUNTS = (4, 16)  # served on contiguous KV against MOE_SLOTS


def drop_counter(torch, dev, params, slots):
    """Count the assignments each MoE layer drops, on the device: while
    ``on()``, ``moe.moe_route`` also adds its ``~keep`` count into
    ``drops[kind, layer]`` (kind 0: a decode step, a call over ``slots``
    rows or one given a capacity, the MLA engine's per-slot routing; 1:
    any other, a prefill), the layer found by its router's
    address.  The add is a device op, so a CUDA graph capture records it
    and each replay repeats it; nothing is read on the host until
    ``take()``.  Returns ``(on, off, take)``; ``take()`` returns the counts
    since the last take as ``{"decode": [...], "prefill": [...]}`` lists
    by MoE layer and zeroes them."""
    from repro_torch.models import moe

    at = {lp["moe"]["router"].data_ptr(): i
          for i, lp in enumerate(params["layers"])}
    drops = torch.zeros((2, len(at)), dtype=torch.int64, device=dev)
    route = moe.moe_route

    def counting(p, cfg, xf, capacity=None):
        r = route(p, cfg, xf, capacity)
        kind = 0 if xf.shape[0] == slots or capacity is not None else 1
        drops[kind, at[p["router"].data_ptr()]] += (~r["keep"]).sum()
        return r

    def on():
        moe.moe_route = counting

    def off():
        moe.moe_route = route

    def take():
        d = drops.tolist()
        drops.zero_()
        return {"decode": d[0], "prefill": d[1]}
    return on, off, take


def slot_count_check(torch, dev, model, params, arch, prompts, base,
                     phase, counts, max_new) -> dict:
    """``prompts`` on contiguous KV at each of ``counts`` slots against
    ``base``, the MOE_SLOTS-slot run's outputs: bit for bit, or the
    largest logprob gap before each request's first divergent token and
    the first such token (reported, not raised: ROADMAP §3 records it)."""
    from repro_torch.launch.serve import serve_continuous

    res = {}
    for n in counts:
        rep = serve_continuous(arch, prompts, model=model, params=params,
                               max_new=max_new, num_slots=n,
                               kv="contiguous", max_seq_len=MAX_SEQ,
                               device=dev)
        outs = rep["outputs"]
        check_outputs(f"{phase} {n} slots", outs, len(prompts), max_new)
        gap, first = 0.0, None
        for o, b in zip(outs, base):
            k = next((i for i, (x, y) in enumerate(zip(o.tokens, b.tokens))
                      if x != y), len(o.tokens))
            if k < len(o.tokens) and (first is None or k < first[1]):
                first = (o.rid, k)
            gap = max([gap] + [abs(x - y) for x, y in
                               zip(o.logprobs[:k], b.logprobs[:k])])
        same = same_outputs(outs, base)
        print(f"[{phase}] {n} slots against {MOE_SLOTS}: "
              + ("bit for bit (tokens and logprobs)" if same else
                 f"not bit for bit: largest |logprob gap| {gap:.4e} before "
                 f"any divergence, first divergent token (rid, position) "
                 f"{first}")
              + f"; {rep['decode_time_s'] / max(rep['decode_steps'], 1) * 1e3:.3f}"
              f" ms per decode step")
        res[n] = {"bit_for_bit": same, "max_logprob_gap": gap,
                  "first_divergence": first,
                  "ms_per_decode_step": rep["decode_time_s"]
                  / max(rep["decode_steps"], 1) * 1e3}
        del rep, outs
    return res


def phase_serve_moe(torch, dev, arch) -> tuple:
    """An MoE model on a cut: full width, MOE_LAYERS of its layers (dbrx
    40, deepseek-v2 60); the 16 serve prompts on MOE_SLOTS slots, MOE_NEW
    new tokens, on every layout: exact launches (flash once a layer a
    prefill, greedy once a step, the layout's decode kernel once a layer a
    step for GQA and never for MLA, whose absorbed decode is plain
    PyTorch), ms per decode step against the weight-bytes bound, peak
    memory and the assignments each MoE layer dropped over the prefills
    and over the decode steps.  dbrx's engine routes a step's slots
    together (capacity 4 of 8 rows: its decode must drop); deepseek-v2's
    routes each slot alone (its decode must drop nothing), so it also
    serves MLA_SLOT_COUNTS slots against MOE_SLOTS.  Paged bf16 bit for
    bit with contiguous, int8 held to it as zamba2's paged run; the graph
    against the eager block on every layout.  Then, the cut freed, a
    MOE_F32_LAYERS-layer copy in float32 at capacity_factor ceil(E / k),
    where an expert takes every row and nothing drops: prefill against
    decode within DENSE32_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    phase = {MOE_ARCH: MOE_PHASE, MLA_ARCH: MLA_PHASE}[arch]
    full = get_config(arch)
    model, params = build(torch, dev, dataclasses.replace(
        full, num_layers=MOE_LAYERS))
    cfg = model.cfg
    per_slot = cfg.attention == "mla"
    prompts = serve_prompts(cfg.vocab_size)
    lens = [len(p) for p in prompts]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    n_par = sum(t.numel() for t in _leaves(params))
    decode = ("decode routes each slot alone" if per_slot else
              f"capacity {moe.capacity_for(cfg, MOE_SLOTS)} of a decode "
              f"step's {MOE_SLOTS} rows")
    print(f"[{phase}] cut of {arch}: {cfg.num_layers} of "
          f"{full.num_layers} layers (reduced: num_layers {full.num_layers} "
          f"-> {cfg.num_layers}; {cfg.first_dense_layers} dense), "
          f"{n_par / 1e9:.2f} B parameters ({n_par * 2 / 1e9:.2f} GB); {E} "
          f"experts top {k} + {cfg.num_shared_experts} shared; {decode}; a "
          f"prefill's capacity {moe.capacity_for(cfg, min(lens))}-"
          f"{moe.capacity_for(cfg, max(lens))} of its {min(lens)}-"
          f"{max(lens)} rows")
    on, off, take = drop_counter(torch, dev, params, MOE_SLOTS)

    def drops(run, rep):
        d = take()
        steps = rep["decode_steps"] + 1      # and serve's warm-up block
        per = {"decode": steps * MOE_SLOTS * k, "prefill": sum(lens) * k}
        print(f"[{phase}] {run}: assignments dropped per MoE layer, "
              f"decode (of {per['decode']} each, the warm-up block's "
              f"included) {d['decode']}, prefill (of {per['prefill']} "
              f"each) {d['prefill']}")
        if bool(sum(d["decode"])) == per_slot:
            raise AssertionError(
                f"{phase} {run}: decode dropped {sum(d['decode'])} "
                f"assignments; the engine's routing "
                f"{'drops none' if per_slot else 'must drop'}")
        return {"dropped": d, "assignments_per_layer": per}
    on()
    try:
        counts, layouts, base = serve_layouts(
            torch, dev, model, params, arch, prompts, phase,
            layouts=(("contiguous", None), ("paged", None),
                     ("paged", "int8")),
            slots=MOE_SLOTS, max_new=MOE_NEW, max_seq=MAX_SEQ,
            per_run=drops)
    finally:
        off()
    if not layouts["paged"]["bit_for_bit"]:
        raise AssertionError(f"{phase}: paged bf16 is not bit for bit "
                             f"with contiguous")
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    graph = {run: graph_vs_eager(torch, dev, model, params, phase, run,
                                 kv=kv, kv_dtype=kv_dtype, prompts=prompts)
             for run, kv, kv_dtype in (("contiguous", "contiguous", None),
                                       ("paged", "paged", None),
                                       ("paged-int8", "paged", "int8"))}
    slot_counts = (slot_count_check(torch, dev, model, params, arch,
                                    prompts, base, phase, MLA_SLOT_COUNTS,
                                    MOE_NEW) if per_slot else {})
    add_counts(counts, {k: f.launches for k, f in fns.items()})
    del model, params, base
    gc.collect()
    torch.cuda.empty_cache()
    model, params = build(torch, dev, dataclasses.replace(
        full, num_layers=MOE_F32_LAYERS, capacity_factor=float(-(-E // k))))
    f32_counts, f32 = float32_check(torch, dev, model, params, arch,
                                    prompts[:4], phase, max_seq=MAX_SEQ)
    add_counts(counts, f32_counts)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"layers": MOE_LAYERS, "slots": MOE_SLOTS,
                    "parameters": n_par, "layouts": layouts,
                    "graph_vs_eager": graph, "slot_counts": slot_counts,
                    "prefill_decode_float32": f32, "launches": counts}


VLM_ARCH, WHISPER_ARCH = "qwen2-vl-7b", "whisper-tiny"
VLM_REQ = 8            # qwen2-vl requests, each prompt past its 256 images
FRONTEND_NEW = MAX_NEW
SUSPEND_AT = 16        # ticks before the frontend phases' suspension


def vlm_prompts(vocab_size, n=VLM_REQ):
    """``n`` prompts of 264-512 ids from ``RandomState(0)``: each longer
    than qwen2-vl's 256 image positions, so that text follows the grid."""
    rs = np.random.RandomState(0)
    return [rs.randint(0, vocab_size, size=int(k)).astype(np.int32)
            for k in rs.randint(264, 513, size=n)]


def seeded_frontends(torch, dev, cfg, n, seed):
    """``n`` frontends ``(1, F, d_model)`` of N(0, 1) from a generator
    seeded with ``seed``, in the model dtype: a vlm's
    ``num_frontend_tokens`` vision embeddings, an audio model's
    ``max_source_len`` frames."""
    from repro_torch.models.common import torch_dtype

    g = torch.Generator(device=dev).manual_seed(seed)
    F = (cfg.max_source_len if cfg.frontend == "audio"
         else cfg.num_frontend_tokens)
    return [torch.randn(1, F, cfg.d_model, generator=g, device=dev).to(
        torch_dtype(cfg.dtype)) for _ in range(n)]


def seed_biases(torch, dev, params, seed):
    """Seeded N(0, 0.02) values in every bias of ``params`` (QKV, MLP and
    LayerNorm biases, which the init zeroes), in place: random weights
    whose biases move the output as trained ones do."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def walk(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v)
            elif k in ("bq", "bk", "bv", "bi", "bo", "b"):
                v.copy_(0.02 * torch.randn(v.shape, generator=g,
                                           device=dev))
    walk(params)


def frontend_suspend_check(torch, dev, model, params, prompts, frontends,
                           ref, phase) -> dict:
    """The paged run again with request 0 suspended after SUSPEND_AT ticks,
    held SUSPEND_AT ticks while the others decode, then resumed: every
    request bit for bit with ``ref`` (the uninterrupted contiguous run,
    which the paged one equals bit for bit)."""
    from repro_torch.serve import Engine, EngineConfig, Request

    eng = Engine(model, params, EngineConfig(
        num_slots=SLOTS, max_seq_len=MAX_SEQ, kv_layout="paged"), device=dev)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=FRONTEND_NEW,
                           frontend=frontends[i]))
    for _ in range(SUSPEND_AT):
        eng.step()
    sreq = eng.suspend(0)
    for _ in range(SUSPEND_AT):
        eng.step()
    while not eng.can_resume(sreq):
        eng.step()
    eng.resume(sreq, (), continue_output=True)
    eng.run()
    outs = [eng.finished[r] for r in sorted(eng.finished)]
    if not same_outputs(outs, ref):
        raise AssertionError(f"{phase}: a suspended and resumed frontend "
                             f"request differs from the uninterrupted run")
    eng.slots.check()
    print(f"[{phase}] rid 0 suspended after {SUSPEND_AT} ticks, held "
          f"{SUSPEND_AT}, resumed (paged, its frontend's KV carried): every "
          f"request bit for bit with the uninterrupted run; "
          f"{eng.captures} capture(s)")
    return {"suspended_at_tick": SUSPEND_AT, "captures": eng.captures}


def phase_serve_frontend(torch, dev, arch) -> tuple:
    """qwen2-vl-7b (VLM_REQ prompts of 264-512 ids, each with its own
    seeded 256 vision embeddings) or whisper-tiny (the N_REQ serve
    prompts, each with its own seeded 1500 frames) at full width and
    depth, seeded biases: every layout through the engine (exact launches;
    paged bf16 bit for bit with contiguous, int8 reported), the graph
    against eager on every layout, radix sharing on (no hit, tokens equal
    to off), one prompt under two frontends (tokens differ), a router bit
    for bit, one suspend and resume bit for bit, float32 prefill against
    decode; whisper's device events a decode step (``profile_step``)."""
    from repro_torch.launch.serve import serve_continuous

    phase = f"serve-{arch}"
    model, params = build(torch, dev, arch)
    seed_biases(torch, dev, params, 3)
    cfg = model.cfg
    audio = cfg.family == "audio"
    prompts = (serve_prompts(cfg.vocab_size) if audio
               else vlm_prompts(cfg.vocab_size))
    frontends = seeded_frontends(torch, dev, cfg, len(prompts), 4)
    counts, layouts, base = serve_layouts(
        torch, dev, model, params, arch, prompts, phase,
        layouts=(("contiguous", None), ("paged", None), ("paged", "int8")),
        slots=SLOTS, max_new=FRONTEND_NEW, max_seq=MAX_SEQ,
        frontends=frontends)
    if not layouts["paged"]["bit_for_bit"]:
        raise AssertionError(f"{phase}: paged bf16 differs from contiguous")
    if all(len(set(o.tokens)) == 1 for o in base):
        raise AssertionError(f"{phase}: every request repeats one token")
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    graph = {run: graph_vs_eager(torch, dev, model, params, phase, run,
                                 kv=kv, kv_dtype=kv_dtype, prompts=prompts,
                                 frontends=frontends)
             for run, kv, kv_dtype in (("contiguous", "contiguous", None),
                                       ("paged", "paged", None),
                                       ("paged-int8", "paged", "int8"))}
    add_counts(counts, {k: f.launches for k, f in fns.items()})
    # radix sharing on: frontend requests bypass the tree
    for f in fns.values():
        f.launches = 0
    rep = serve_continuous(arch, prompts, model=model, params=params,
                           max_new=FRONTEND_NEW, num_slots=SLOTS, kv="paged",
                           prefix_share=True, max_seq_len=MAX_SEQ,
                           device=dev, frontends=frontends)
    add_counts(counts, {k: f.launches for k, f in fns.items()})
    tree = len(rep["engine"].radix)
    if (rep["prefix_hits"], rep["prefix_partial_hits"], tree) != (0, 0, 0) \
            or not same_outputs(rep["outputs"], base):
        raise AssertionError(f"{phase}: radix on: {rep['prefix_hits']} "
                             f"hits, {rep['prefix_partial_hits']} partial, "
                             f"{tree} entries, or tokens differ from off")
    print(f"[{phase}] radix sharing on (paged): 0 hits, 0 partial, nothing "
          f"registered; bit for bit with sharing off")
    del rep
    # one prompt under two frontends
    for f in fns.values():
        f.launches = 0
    pair = serve_continuous(arch, [prompts[0], prompts[0]], model=model,
                            params=params, max_new=FRONTEND_NEW,
                            num_slots=2, max_seq_len=MAX_SEQ, device=dev,
                            frontends=frontends[:2])["outputs"]
    add_counts(counts, {k: f.launches for k, f in fns.items()})
    if pair[0].tokens == pair[1].tokens or pair[0].tokens != base[0].tokens:
        raise AssertionError(f"{phase}: one prompt under two frontends gives "
                             f"the same tokens, or not the served ones")
    differ = sum(a != b for a, b in zip(pair[0].tokens, pair[1].tokens))
    print(f"[{phase}] rid 0's prompt under frontends 0 and 1: {differ} of "
          f"{len(pair[0].tokens)} tokens differ; frontend 0's are the "
          f"served ones")
    router_counts, router = phase_router(torch, dev, model, params, phase,
                                         prompts=prompts, frontends=frontends)
    add_counts(counts, router_counts)
    for f in fns.values():
        f.launches = 0
    suspend = frontend_suspend_check(torch, dev, model, params, prompts,
                                     frontends, base, phase)
    add_counts(counts, {k: f.launches for k, f in fns.items()})
    f32_counts, f32 = float32_check(torch, dev, model, params, arch,
                                    prompts[:4], phase, max_seq=MAX_SEQ,
                                    frontends=frontends)
    add_counts(counts, f32_counts)
    report = {"prompt_lengths": [len(p) for p in prompts],
              "layouts": layouts, "graph_vs_eager": graph,
              "frontend_pair_tokens_differing": differ, "router": router,
              "suspend": suspend, "prefill_decode_float32": f32,
              "launches": counts}
    if audio:
        report["decode_step_profile"] = whisper_step_profile(
            torch, dev, model, params, layouts)
    del model, params, base
    return counts, report


def whisper_step_profile(torch, dev, model, params, layouts) -> dict:
    """whisper-tiny's kernel decode step of SLOTS slots at position 300
    (contiguous, cross leaves over 1500 frames) under ``torch.profiler``
    (``profile_step.profile_calls``): device events a step and device-busy
    ms, against the weight-bytes bound and the served ms a step."""
    import profile_step

    pool = model.init_cache(SLOTS, MAX_SEQ, device=dev)
    pool["index"] = torch.full((SLOTS,), 300, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    tok = torch.randint(0, model.cfg.vocab_size, (SLOTS, 1), device=dev,
                        generator=g)

    def step():
        pool["index"].fill_(300)
        return model.kernel_decode_step(params, tok, pool)
    res = profile_step.profile_calls(torch, step)
    bound_ms = weight_bound_ms(params)
    cross = sum(pool[n].numel() * pool[n].element_size()
                for n in ("cross_k", "cross_v")) / SLOTS
    served = layouts["contiguous"]["ms_per_decode_step"]
    ev = res["device_events"]
    print(f"[serve-{WHISPER_ARCH}] eager decode step of {SLOTS} slots at "
          f"position 300: {ev if ev is None else f'{ev:.0f}'} device events "
          f"a step, device-busy "
          + ("not measured" if res["device_busy_ms"] is None else
             f"{res['device_busy_ms']:.3f} ms")
          + f" in {res['wall_ms']:.3f} ms wall; served (graph) "
          f"{served:.3f} ms a step against the {bound_ms:.4f} ms weight-bytes "
          f"bound ({served / bound_ms:.1f}x); cross K/V "
          f"{cross / 1e6:.2f} MB a slot; decode attention "
          f"{res['matched']['decode attention'] if res['matched'] else None}")
    del pool
    return dict(res, weight_bound_ms=bound_ms, cross_bytes_per_slot=cross,
                served_ms_per_step=served)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def recheck_pool(torch, dev, da, engine, run):
    """The paged kernel against its plain version on the pool and tables
    the run left (the tables of its last decode step)."""
    cache = engine.slots.cache
    tables = engine.slots._tables_dev          # last uploaded tables
    lengths = cache["index"]
    cfg = engine.model.cfg
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(SLOTS, cfg.num_heads, cfg.resolved_head_dim, generator=g,
                    device=dev, dtype=engine.params["embed"].dtype)
    for li in (0, cfg.num_layers // 2, cfg.num_layers - 1):
        kw = {}
        if "k_scale" in cache:
            kw = dict(k_scale=cache["k_scale"][li],
                      v_scale=cache["v_scale"][li])
        args = (q, cache["k"][li], cache["v"][li], tables, lengths)
        err = check_close(torch, f"{run} pool layer {li}",
                          da.paged_decode_attention(*args, **kw),
                          da.paged_decode_attention_plain(*args, **kw),
                          ATTN_TOL)
        print(f"[serve] {run}: paged kernel on the run's pool, layer {li}: "
              f"max_abs_err={err:.3e}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# training of every family: GRPO at full width or as a full-width cut
# ---------------------------------------------------------------------------
TRAIN_NEW = MAX_NEW    # tokens a GRPO rollout samples in the family phases
TRAIN_BATCH, TRAIN_GROUP = 4, 4
# the step at a realistic GRPO length that splits a train step's time:
# TRAIN_LONG_ROWS rows of TRAIN_LONG_S positions (prompt and completion;
# whisper's decoder context is 448); 2 rows keep the largest cut,
# deepseek-v2's, under about 72 GiB beside its float32 logits
TRAIN_LONG_ROWS, TRAIN_LONG_S = 2, {"whisper-tiny": 448}
TRAIN_LONG_S_DEFAULT = 1024
# layers kept of each model (None: all); every width is the model's own
TRAIN_CUTS = {"whisper-tiny": None, "gemma3-4b": None, "zamba2-2.7b": None,
              "qwen2-vl-7b": 14, "rwkv6-7b": 16, "dbrx-132b": 1,
              "deepseek-v2-236b": 2}
TRAIN_PHASES = tuple(f"train-{a}" for a in TRAIN_CUTS)
# |ratio_mean - 1|: the trainer's forward against the engine's decode on
# the sampled tokens, at the limit each family's serving already holds
# (internlm2's train phase 1e-2; the recurrent serve phases' prefill
# against decode 0.1).  The MoE capacity couples other rows in training
# (all B·S) than in decode, so there it is printed, not gated.
TRAIN_RATIO_TOL = {"gemma3-4b": 1e-2, "qwen2-vl-7b": 1e-2, "rwkv6-7b": 0.1,
                   "zamba2-2.7b": 0.1}
# leaves that must move in a train step: the embedding and, in the first
# and the last layer, the attention or mixer and the MLP or experts
TRAIN_WATCH = {
    "whisper-tiny": ("embed", "encoder.layers.0.attn.wq", "cross.0.attn.wq",
                     "layers.-1.mlp.wo"),
    "gemma3-4b": ("embed", "layers.0.attn.wq", "layers.-1.mlp.wo"),
    "zamba2-2.7b": ("embed", "layers.0.mamba.in_proj",
                    "layers.-1.mamba.A_log", "shared_attn.attn.wq",
                    "shared_attn.mlp.wo"),
    "qwen2-vl-7b": ("embed", "lm_head", "layers.0.attn.bq",
                    "layers.-1.mlp.wo"),
    "rwkv6-7b": ("embed", "layers.0.mix.wr", "layers.0.mix.u",
                 "layers.-1.mix.cm_wv"),
    "dbrx-132b": ("embed", "layers.0.attn.wq", "layers.0.moe.router",
                  "layers.0.moe.wo"),
    "deepseek-v2-236b": ("embed", "dense_layers.0.attn.wkv_a",
                         "layers.-1.attn.wq_b", "layers.-1.moe.router",
                         "layers.-1.moe.wi_gate", "layers.-1.moe.shared.wo")}
# the float32 copy of each family: 2 layers (deepseek: its dense layer and
# one MoE layer) at a small width that keeps the model's attention and scan
# head dims (gemma3 256, qwen2-vl and dbrx 128, deepseek's MLA 128 + 64 /
# 128, zamba2's shared block 80 and SSD 64, rwkv6 64, whisper 64), its
# expert count and top-k (at a capacity where nothing drops), a window
# that the sequence crosses
F32_COPY = {
    "whisper-tiny": dict(num_layers=2, encoder_layers=2, vocab_size=4096),
    "gemma3-4b": dict(num_layers=2, d_model=256, num_heads=2, num_kv_heads=1,
                      d_ff=512, vocab_size=4096, sliding_window=48,
                      local_global_ratio=1),
    "zamba2-2.7b": dict(num_layers=2, d_model=320, num_heads=4,
                        num_kv_heads=4, d_ff=640, vocab_size=4096,
                        hybrid_attn_every=2),
    "qwen2-vl-7b": dict(num_layers=2, d_model=256, num_heads=7,
                        num_kv_heads=1, d_ff=512, vocab_size=4096,
                        num_frontend_tokens=64),
    "rwkv6-7b": dict(num_layers=2, d_model=256, num_heads=4, d_ff=512,
                     vocab_size=4096),
    "dbrx-132b": dict(num_layers=2, d_model=256, num_heads=6, num_kv_heads=1,
                      head_dim=128, d_ff=256, moe_d_ff=256, vocab_size=4096,
                      capacity_factor=4.0),
    "deepseek-v2-236b": dict(num_layers=2, d_model=256, num_heads=4,
                             d_ff=512, moe_d_ff=128, kv_lora_rank=64,
                             q_lora_rank=96, vocab_size=4096,
                             capacity_factor=27.0)}
F32_S = 130            # positions of the float32 copies' batch
F32_GRAD_TOL = 1e-3    # |g_card - g_cpu| over |g_cpu|, leaf by leaf
# the leaves whose exact gradient is 0, by the end of their path: the key
# biases of attention without RoPE (whisper's self- and cross-attention),
# to which the softmax is invariant; they are held instead to float32
# noise below F32_ZERO_TOL of the whole gradient's norm on both sides
F32_ZERO_GRAD = {"whisper-tiny": "attn.bk"}
F32_ZERO_TOL = 1e-6


def leaf_at(tree, path: str):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def named_leaves(tree, prefix=""):
    """(path, tensor) pairs in the tree's order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


class StepSplit:
    """The train step's forward, backward and AdamW split by CUDA events:
    :meth:`model` wraps a model so that its ``forward`` (the training
    forward; the engine never calls it) records an event before and after,
    and while the split is entered the train step's ``adamw_update`` does
    the same.  Per step: forward from its first event to the logits,
    backward from there to AdamW's start (the loss and autograd's pass),
    AdamW to its end."""

    def __init__(self, torch):
        self.torch, self.marks = torch, []

    def mark(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append(e)

    def model(self, model):
        from repro_torch.models.model import Model
        split = self

        class Timed(Model):
            def forward(self, *a, **kw):
                split.mark()
                out = super().forward(*a, **kw)
                split.mark()
                return out
        return Timed(model.cfg)

    def __enter__(self):
        from repro_torch.rl import train_step as ts
        self._adamw = adamw = ts.adamw_update

        def timed(*a, **kw):
            self.mark()
            out = adamw(*a, **kw)
            self.mark()
            return out
        ts.adamw_update = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.rl import train_step as ts
        ts.adamw_update = self._adamw

    def steps(self) -> list:
        """Seconds of each step's forward, backward and AdamW; clears the
        marks."""
        self.torch.cuda.synchronize()
        m, self.marks = self.marks, []
        if len(m) % 4:
            raise AssertionError(f"train split: {len(m)} events, not four a "
                                 f"step")
        return [{"forward_s": m[i].elapsed_time(m[i + 1]) / 1e3,
                 "backward_s": m[i + 1].elapsed_time(m[i + 2]) / 1e3,
                 "adamw_s": m[i + 2].elapsed_time(m[i + 3]) / 1e3}
                for i in range(0, len(m), 4)]


def train_split_line(split) -> str:
    return "; ".join(f"step {i}: forward {s['forward_s']:.3f}s, backward "
                     f"{s['backward_s']:.3f}s, AdamW {s['adamw_s']:.3f}s"
                     for i, s in enumerate(split))


class KernelBackwards:
    """While entered, the backward of each kernel's autograd Function
    (flash's chunked plain backward, the scans' plain recompute under
    autograd) records a CUDA event before and after it; :meth:`seconds`
    gives each one's calls and summed seconds and clears them.  These are
    the parts of a train step that hand-written backward kernels would
    replace."""

    def __init__(self, torch):
        from repro_torch.kernels.flash_attention import FlashAttentionFn
        from repro_torch.kernels.mamba2_scan import Mamba2ScanFn
        from repro_torch.kernels.rwkv6_scan import Rwkv6ScanFn
        self.torch = torch
        self.fns = {"flash_attention": FlashAttentionFn,
                    "rwkv6_scan": Rwkv6ScanFn, "mamba2_scan": Mamba2ScanFn}
        self.marks = {k: [] for k in self.fns}

    def _timed(self, name, backward):
        marks, torch = self.marks[name], self.torch

        def timed(ctx, *grads):
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            out = backward(ctx, *grads)
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            marks.append((a, b))
            return out
        return staticmethod(timed)

    def __enter__(self):
        self._orig = {k: f.__dict__["backward"] for k, f in self.fns.items()}
        for k, f in self.fns.items():
            f.backward = self._timed(k, self._orig[k].__func__)
        return self

    def __exit__(self, *exc):
        for k, f in self.fns.items():
            f.backward = self._orig[k]

    def seconds(self) -> dict:
        self.torch.cuda.synchronize()
        out = {k: {"calls": len(m),
                   "s": sum(a.elapsed_time(b) for a, b in m) / 1e3}
               for k, m in self.marks.items() if m}
        self.marks = {k: [] for k in self.fns}
        return out


def train_launches(cfg, hist, train_steps) -> dict:
    """Launches of a family's train phase: a layer's prefill kernel (flash
    for attention, the scan for rwkv6 and Mamba2 layers) once a prefill
    and twice a train step (the forward, and remat's recompute in the
    backward; whisper's encoder, outside the checkpointed layers, once);
    the decode kernel once an attention layer a decode step where the
    engine decodes through it (GQA stacks; zamba2's contiguous shared
    block and deepseek-v2's absorbed decode are plain); nothing else."""
    from repro_torch.models.stacks_infer import kernel_supported

    want = {k: 0 for k in wrappers()}
    L = cfg.num_layers
    n = sum(r.get("prefills", 0) for r in hist) + 2 * train_steps
    if cfg.family == "ssm":
        want["rwkv6_scan"] = L * n
    elif cfg.family == "hybrid":
        want["mamba2_scan"] = L * n
        want["flash_attention"] = L // cfg.hybrid_attn_every * n
    else:
        want["flash_attention"] = L * n + cfg.encoder_layers * train_steps
    if kernel_supported(cfg):
        want["decode_attention"] = L * sum(r.get("decode_steps", 0)
                                           for r in hist)
    return want


def train_batch(torch, dev, cfg, B, S, seed, frontend=None) -> dict:
    """A seeded GRPO-shaped batch on ``dev``: token ids, next-token labels,
    a loss mask over the last 3/4 of the positions, one advantage a row of
    either sign, and ``frontend`` (F positions of seeded vision embeddings
    or audio frames) when given."""
    from repro_torch.models.common import torch_dtype

    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int64)
    mask = np.zeros((B, S), np.float32)
    mask[:, S // 4:] = 1
    adv = np.repeat(rs.randn(B, 1), S, 1).astype(np.float32) * mask
    b = {"tokens": ids[:, :-1], "labels": ids[:, 1:], "loss_mask": mask,
         "advantages": adv}
    if frontend:
        b["frontend"] = rs.randn(B, frontend, cfg.d_model).astype(
            np.float32)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in b.items()}
    if frontend:
        out["frontend"] = out["frontend"].to(torch_dtype(cfg.dtype))
    return out


def record_of(i, metrics) -> dict:
    return {"step": i, **{k: float(metrics[k]) for k in
                          ("loss", "grad_norm", "entropy", "ratio_mean")}}


def make_steps(torch, dev, model, state, n, *, S, frontend, seed=0,
               rows=TRAIN_BATCH * TRAIN_GROUP):
    """``n`` ``make_train_step`` steps (remat on, as GRPO's) of ``rows``
    rows on seeded batches; returns the records."""
    from repro_torch.rl.train_step import make_train_step
    from repro_torch.train.optimizer import AdamWConfig

    step = make_train_step(model, AdamWConfig(lr=3e-4))
    hist = []
    for i in range(n):
        batch = train_batch(torch, dev, model.cfg, rows, S, seed + i,
                            frontend)
        state, metrics = step(state, batch)
        hist.append(record_of(i, metrics))
    return hist


def check_train_records(arch, label, hist, ratio_tol=None):
    for r in hist:
        if not all(np.isfinite(r[k]) for k in ("loss", "grad_norm",
                                                "entropy")) \
                or r["grad_norm"] <= 0:
            raise AssertionError(f"{label}: step {r['step']} malformed: {r}")
        if ratio_tol is not None and abs(r["ratio_mean"] - 1) > ratio_tol:
            raise AssertionError(f"{label}: step {r['step']}: policy and "
                                 f"behaviour logprobs disagree, ratio_mean "
                                 f"{r['ratio_mean']} (limit {ratio_tol})")


def phase_train_family(torch, dev, arch) -> tuple:
    """Training of one family on the card.  GRPO (every family but audio):
    two iterations through ``run_training`` on the engine rollout (TRAIN_
    BATCH prompts x TRAIN_GROUP samples, TRAIN_NEW new tokens, temperature
    1, a reward that differs from row to row), at full width (the depth
    TRAIN_CUTS keeps); whisper-tiny, which no GRPO loop trains (its
    forward needs frames), two ``make_train_step`` steps on batches of
    ``max_source_len`` seeded frames a row; qwen2-vl, after its GRPO, one
    step on a batch with seeded vision embeddings (the overlay in
    training).  Each step's forward / backward / AdamW split by CUDA
    events, the peak memory, exact launches (:func:`train_launches`),
    finite losses and gradient norms, ``ratio_mean`` within
    TRAIN_RATIO_TOL, every TRAIN_WATCH leaf moved; then one step at a
    realistic length (:func:`long_step`); then, the model freed, the
    family's float32 copy (:func:`f32_grad_copy`)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_training
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    phase = f"train-{arch}"
    full = get_config(arch)
    n = TRAIN_CUTS[arch]
    model, params = build(torch, dev, full if n is None
                          else dataclasses.replace(full, num_layers=n))
    cfg = model.cfg
    n_par = sum(t.numel() for t in _leaves(params))
    cut = ("all layers" if n is None else
           f"a cut of {n} of {full.num_layers} layers")
    print(f"[{phase}] {arch} at full width, {cut}: {n_par / 1e9:.2f} B "
          f"parameters, {n_par * 12 / 1e9:.1f} GB of weights, gradients "
          f"and AdamW moments at 12 bytes a parameter")
    watch = {p: leaf_at(params, p) for p in TRAIN_WATCH[arch]}
    before = {p: fingerprint([t]) for p, t in watch.items()}
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepSplit(torch) as split:
        timed = split.model(model)
        if cfg.family == "audio":
            state = {"params": params, "opt": adamw_init(
                params, AdamWConfig(lr=3e-4))}
            hist = make_steps(torch, dev, timed, state, 2,
                              S=16 + TRAIN_NEW - 1,
                              frontend=cfg.max_source_len)
            steps_of, roll = 2, None
        else:
            state, hist, report = run_training(
                cfg.name, model=timed, params=params, steps=2,
                batch=TRAIN_BATCH, group=TRAIN_GROUP, max_new=TRAIN_NEW,
                temperature=1.0, rollout="engine",
                reward_fn=token_share_reward(cfg.vocab_size), device=dev,
                log_every=1, return_report=True)
            steps_of = len(hist)
            roll = [t1 - t0_ for _, t0_, t1 in report.timelines["rollout"]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = split.steps()
    peak = torch.cuda.max_memory_allocated()
    counts = {k: f.launches for k, f in fns.items()}
    want = train_launches(cfg, hist, steps_of)
    if counts != want or len(hist) != 2:
        raise AssertionError(f"{phase}: launches {counts} != {want} "
                             f"({len(hist)} steps)")
    check_train_records(arch, phase, hist, TRAIN_RATIO_TOL.get(arch))
    moved = {p: fingerprint([t]) != before[p] for p, t in watch.items()}
    if not all(moved.values()):
        raise AssertionError(f"{phase}: weights did not move: {moved}")
    if not all(torch.isfinite(t).all() for t in watch.values()):
        raise AssertionError(f"{phase}: non-finite weights after training")
    print(f"[{phase}] 2 train steps in {wall:.2f}s"
          + (f" (rollouts {[round(x, 3) for x in roll]} s)" if roll else "")
          + f"; {train_split_line(steps)}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {counts} (expected); "
          f"{card_line()}")
    for r in hist:
        print(f"[{phase}] step {r['step']}: loss={r['loss']:.6f} grad_norm="
              f"{r['grad_norm']:.4f} entropy={r['entropy']:.4f} ratio_mean="
              f"{r['ratio_mean']:.6f}"
              + (f" decode_steps={r['decode_steps']} prefills="
                 f"{r['prefills']}" if "prefills" in r else ""))
    res = {"layers": cfg.num_layers, "params": n_par, "wall_s": wall,
           "rollout_s": roll, "steps": steps, "max_memory_allocated": peak,
           "launches": counts, "history": hist}
    if cfg.family == "vlm":
        res["overlay"] = vlm_overlay_step(torch, dev, split, timed, state)
    res["long"] = long_step(torch, dev, split, timed, state)
    del state, params, model, watch, timed
    gc.collect()
    torch.cuda.empty_cache()
    res["float32"] = f32_grad_copy(torch, dev, arch)
    return counts, res


def vlm_overlay_step(torch, dev, split, model, state) -> dict:
    """One ``make_train_step`` step of qwen2-vl on a batch whose first
    ``num_frontend_tokens`` positions are seeded vision embeddings (the
    overlay the GRPO loop, which carries no frontend, does not train):
    flash twice a layer, finite loss and gradient norm, the embedding's
    text rows and the last layer moved."""
    cfg = model.cfg
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    before = fingerprint([state["params"]["layers"][-1]["mlp"]["wo"]])
    with split:
        hist = make_steps(torch, dev, model, state, 1,
                          S=cfg.num_frontend_tokens + 64,
                          frontend=cfg.num_frontend_tokens, seed=7)
        steps = split.steps()
    counts = {k: f.launches for k, f in fns.items()}
    want = train_launches(cfg, [], 1)
    if counts != want:
        raise AssertionError(f"train-qwen2-vl overlay: launches {counts} != "
                             f"{want}")
    check_train_records(cfg.name, "train-qwen2-vl overlay", hist)
    if fingerprint([state["params"]["layers"][-1]["mlp"]["wo"]]) == before:
        raise AssertionError("train-qwen2-vl overlay: weights did not move")
    print(f"[train-{cfg.name}] a step with {cfg.num_frontend_tokens} seeded "
          f"vision embeddings a row ({TRAIN_BATCH * TRAIN_GROUP} rows, S "
          f"{cfg.num_frontend_tokens + 64}): loss={hist[0]['loss']:.6f} "
          f"grad_norm={hist[0]['grad_norm']:.4f}; {train_split_line(steps)}; "
          f"launches {counts} (expected)")
    return {"history": hist, "steps": steps, "launches": counts}


def long_step(torch, dev, split, model, state) -> dict:
    """One ``make_train_step`` step (remat on) at a realistic GRPO length,
    TRAIN_LONG_ROWS rows of TRAIN_LONG_S positions (with ``max_source_len``
    seeded frames a row for audio; no vision embeddings for vlm, as in
    GRPO): the forward / backward / AdamW split, and within the backward
    each kernel Function's backward (:class:`KernelBackwards`), the peak
    memory, exact launches, a finite loss and gradient norm."""
    cfg = model.cfg
    S = TRAIN_LONG_S.get(cfg.name, TRAIN_LONG_S_DEFAULT)
    fns = wrappers()
    for f in fns.values():
        f.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with split, KernelBackwards(torch) as kb:
        hist = make_steps(torch, dev, model, state, 1, S=S,
                          frontend=cfg.max_source_len
                          if cfg.family == "audio" else None,
                          seed=9, rows=TRAIN_LONG_ROWS)
        steps = split.steps()
        kernel_bwd = kb.seconds()
    peak = torch.cuda.max_memory_allocated()
    counts = {k: f.launches for k, f in fns.items()}
    want = train_launches(cfg, [], 1)
    if counts != want:
        raise AssertionError(f"train-{cfg.name} at length {S}: launches "
                             f"{counts} != {want}")
    check_train_records(cfg.name, f"train-{cfg.name} at length {S}", hist)
    parts = ", ".join(f"{k} {v['s']:.3f}s over {v['calls']} calls"
                      for k, v in kernel_bwd.items())
    print(f"[train-{cfg.name}] a step at a realistic length "
          f"({TRAIN_LONG_ROWS} rows x {S} positions): loss="
          f"{hist[0]['loss']:.6f} grad_norm={hist[0]['grad_norm']:.4f}; "
          f"{train_split_line(steps)}; of the backward, the kernels' "
          f"backwards: {parts}; peak memory {peak / 2 ** 30:.2f} GiB; "
          f"launches {counts} (expected)")
    return {"rows": TRAIN_LONG_ROWS, "S": S, "history": hist,
            "steps": steps, "kernel_backward": kernel_bwd,
            "max_memory_allocated": peak, "launches": counts}


def port_grads(torch, model, params, batch, remat):
    """The loss and its gradients, leaf by leaf in ``named_leaves``
    order, through ``make_loss_fn``."""
    from repro_torch.rl.train_step import make_loss_fn

    leaves = []

    def alias(t):
        leaves.append(t.detach().requires_grad_())
        return leaves[-1]
    loss, _ = make_loss_fn(model, remat=remat)(_tree_map(alias, params),
                                               batch)
    return float(loss), torch.autograd.grad(loss, leaves)


def f32_grad_copy(torch, dev, arch) -> dict:
    """The family's F32_COPY model in float32, seeded weights, one GRPO
    batch of 2 rows x F32_S positions (and a frontend where the family
    takes one): the loss and every gradient leaf through ``make_loss_fn``
    on the card (kernels, remat on) against the same port on the CPU
    (plain versions, remat off), each leaf within F32_GRAD_TOL of its norm
    but the F32_ZERO_GRAD leaves, whose exact gradient is 0: those, card
    and CPU and their difference, within F32_ZERO_TOL of the whole
    gradient's norm."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 products must not run in TF32 here")
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              **F32_COPY[arch])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    frontend = {"vlm": cfg.num_frontend_tokens,
                "audio": cfg.max_source_len}.get(cfg.family)
    batch = train_batch(torch, "cpu", cfg, 2, F32_S, 11, frontend)
    t0 = time.perf_counter()
    l_cpu, g_cpu = port_grads(torch, model, params, batch, remat=False)
    cpu_s = time.perf_counter() - t0
    on = {k: v.to(dev) for k, v in batch.items()}
    l_dev, g_dev = port_grads(torch, model, _tree_map(lambda t: t.to(dev),
                                                      params), on, remat=True)
    names = [n for n, _ in named_leaves(params)]
    total = float(sum(g.square().sum() for g in g_cpu).sqrt())
    zero = F32_ZERO_GRAD.get(arch)
    worst, worst_name, floored = -1.0, None, []
    for name, a, b in zip(names, g_dev, g_cpu):
        a = a.cpu()
        err = float((a - b).norm())
        if zero and name.endswith(zero):
            if not max(float(a.norm()), float(b.norm()), err) \
                    <= F32_ZERO_TOL * total:
                raise AssertionError(
                    f"train-{arch} float32: gradient {name}, exactly 0, "
                    f"has norm {float(a.norm()):.3e} on the card and "
                    f"{float(b.norm()):.3e} on the CPU (whole gradient "
                    f"{total:.3e})")
            floored.append(name)
            continue
        share = err / (F32_GRAD_TOL * float(b.norm()))
        if not share <= 1.0:
            raise AssertionError(f"train-{arch} float32: gradient {name} "
                                 f"off the CPU's by {err:.3e} (norm "
                                 f"{float(b.norm()):.3e})")
        if share > worst:
            worst, worst_name = share, name
    if bool(floored) != bool(zero):
        raise AssertionError(f"train-{arch} float32: no leaf ends in "
                             f"{zero!r}")
    if abs(l_dev - l_cpu) > 1e-5 * abs(l_cpu):
        raise AssertionError(f"train-{arch} float32: loss {l_dev} on the "
                             f"card, {l_cpu} on the CPU")
    print(f"[train-{arch}] float32 copy ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, head dims kept; 2 x {F32_S} positions): loss "
          f"{l_dev:.7f} on the card, {l_cpu:.7f} on the CPU; {len(names)} "
          f"gradient leaves, the worst ({worst_name}) at {worst:.3f} of its "
          f"limit ({F32_GRAD_TOL} of its norm)"
          + (f"; {len(floored)} leaves of exact gradient 0 ({zero}) within "
             f"{F32_ZERO_TOL} of the whole norm" if floored else "")
          + f"; CPU side {cpu_s:.1f}s")
    return {"loss_card": l_dev, "loss_cpu": l_cpu, "worst_share": worst,
            "worst_leaf": worst_name, "leaves": len(names),
            "zero_leaves": floored}


SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:44"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:138"),
    "greedy_sample": ("src/repro_torch/kernels/csrc/greedy_sample.cu",
                      "src/repro/kernels/sampling.py:34"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:24"),
    "topk": ("src/repro_torch/kernels/csrc/topk.cu",
             "src/repro/kernels/sampling.py:98"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:22"),
    "mamba2_scan": ("src/repro_torch/kernels/csrc/mamba2_scan.cu",
                    "src/repro/kernels/mamba2_scan.py:20"),
}


ONLY_PHASES = ("kernels", "serve-static", "roofline", "elastic", "sync",
               f"serve-{VLM_ARCH}",
               f"serve-{WHISPER_ARCH}", MOE_PHASE, MLA_PHASE) + TRAIN_PHASES


def run_only(torch, dev, phases, t0) -> int:
    """``--only``: the named phases of ONLY_PHASES, in that order, and
    their numbers in ``chiprun_out/chip_smoke_only.json``; no result
    line."""
    bad = sorted(set(phases) - set(ONLY_PHASES))
    if bad:
        raise SystemExit(f"chip_smoke: unknown phases {bad}; choose from "
                         f"{ONLY_PHASES}")
    res = {}
    if "kernels" in phases:
        timer = Timer(torch, dev)
        res["kernels"] = phase_kernels(torch, dev, timer)
        res["rwkv6_scan"] = phase_scan(torch, dev, timer)
        res["mamba2_scan"] = phase_mamba2_scan(torch, dev, timer)
        res["flash"] = phase_flash(torch, dev, timer)
        del timer
    if "serve-static" in phases or "roofline" in phases:
        model, params = build(torch, dev)
        if "serve-static" in phases:
            res["serve-static"] = phase_serve_static(torch, dev, model,
                                                     params)[1]
        if "roofline" in phases:
            res["roofline"] = phase_roofline(torch, dev, model, params)[1]
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if "elastic" in phases:
        model, params = build(torch, dev)
        res["elastic"] = phase_elastic(torch, dev, model, params)[1]
        del model, params
    if "sync" in phases:
        # no train phase here: seed 1's weights stand for the trained ones
        gc.collect()
        torch.cuda.empty_cache()
        model, params = build(torch, dev)
        trained = model.init(torch.Generator(device=dev).manual_seed(1))
        res["sync"] = phase_sync(torch, dev, model, trained, params)[1]
        del model, params, trained
    for arch in (VLM_ARCH, WHISPER_ARCH):
        if f"serve-{arch}" in phases:
            gc.collect()
            torch.cuda.empty_cache()
            res[arch] = phase_serve_frontend(torch, dev, arch)[1]
    for arch, phase in ((MOE_ARCH, MOE_PHASE), (MLA_ARCH, MLA_PHASE)):
        if phase in phases:
            gc.collect()
            torch.cuda.empty_cache()
            res[phase] = phase_serve_moe(torch, dev, arch)[1]
    for arch in TRAIN_CUTS:
        if f"train-{arch}" in phases:
            gc.collect()
            torch.cuda.empty_cache()
            res[f"train-{arch}"] = phase_train_family(torch, dev, arch)[1]
    smi = card_line()
    print(f"[smoke] phases {phases} passed in "
          f"{time.perf_counter() - t0:.1f}s ({smi})")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_only.json"), "w") as f:
        json.dump({"card": smi, **res}, f, indent=1, default=str)
    print(smi)
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke of the port.")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, check and time the kernels, then stop "
                         "(no model phases, no result line)")
    ap.add_argument("--src", default=None,
                    help="with --kernels-only: the src directory whose "
                         "repro_torch to time (another checkout's)")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the build, "
                         "of " + ", ".join(ONLY_PHASES) + " (no result "
                         "line): a quicker check of a few phases")
    args = ap.parse_args(argv)
    if args.src:
        if not args.kernels_only:
            ap.error("--src needs --kernels-only")
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_s = {}
    last = [t0]

    def lap(name):
        """Print the host seconds since the previous lap; keep them in
        ``phase_s`` under ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        print(f"[smoke] {name} took {phase_s[name]:.1f}s", flush=True)

    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel libraries built for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s from {_build.CSRC}")
    if args.only:
        return run_only(torch, dev, args.only.split(","), t0)
    lap("build_all")
    timer = Timer(torch, dev)
    rows = phase_kernels(torch, dev, timer)
    lap("phase_kernels")
    rows["rwkv6_scan"] = phase_scan(torch, dev, timer)
    lap("phase_scan")
    rows["mamba2_scan"] = phase_mamba2_scan(torch, dev, timer)
    lap("phase_mamba2_scan")
    rows["topk"] = phase_topk(torch, dev, timer)
    lap("phase_topk")
    rows["flash_attention"] = phase_flash(torch, dev, timer)
    lap("phase_flash")
    del timer
    if args.kernels_only:
        smi = card_line()
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        tag = "parent" if args.src else "tree"
        with open(os.path.join(out_dir, f"kernels_{tag}.json"), "w") as f:
            json.dump({"card": smi, "src": str(_build.CSRC), "rows": rows},
                      f, indent=1, default=str)
        print(smi)
        return 0
    torch.cuda.empty_cache()
    model, params = build(torch, dev)
    lap("build internlm2")
    init_params = _tree_map(lambda t: t.clone(), params)
    launches, serve = phase_serve(torch, dev, model, params)
    lap("phase_serve")
    static_serve_launches, serve_static = phase_serve_static(
        torch, dev, model, params)
    lap("phase_serve_static")
    graph = phase_graph(torch, dev, model, params)
    lap("phase_graph")
    trace = phase_trace(torch, dev, model, params,
                        N_REQ / serve["contiguous"]["wall_s"])
    lap("phase_trace")
    torch.cuda.empty_cache()
    elastic_launches, elastic = phase_elastic(torch, dev, model, params)
    lap("phase_elastic")
    torch.cuda.empty_cache()
    suspend_launches, suspend = phase_suspend(torch, dev, model, params)
    lap("phase_suspend")
    agentic_launches, agentic = phase_agentic(torch, dev, model, params)
    lap("phase_agentic")
    torch.cuda.empty_cache()
    carry_launches, carry = phase_carry(torch, dev, model, params,
                                        init_params)
    lap("phase_carry")
    torch.cuda.empty_cache()
    static_launches, static = phase_static(torch, dev, model, params,
                                           init_params)
    lap("phase_static")
    torch.cuda.empty_cache()
    prefix_launches, prefix = phase_prefix(torch, dev, model, params)
    lap("phase_prefix")
    torch.cuda.empty_cache()
    disagg_launches, disagg = phase_disagg(torch, dev, model, params)
    lap("phase_disagg")
    torch.cuda.empty_cache()
    train_prefix_launches, train_prefix = phase_train_prefix(
        torch, dev, model, init_params)
    lap("phase_train_prefix")
    torch.cuda.empty_cache()
    train_launches, train = phase_train(torch, dev, model, params)
    lap("phase_train")
    torch.cuda.empty_cache()
    roofline_launches, roofline = phase_roofline(torch, dev, model, params,
                                                 train=train, serve=serve)
    lap("phase_roofline")
    torch.cuda.empty_cache()
    sync_launches, sync = phase_sync(torch, dev, model, params, init_params)
    lap("phase_sync")
    del params
    torch.cuda.empty_cache()
    mux_launches_, mux = phase_mux(torch, dev, model, init_params)
    lap("phase_mux")
    del model, init_params
    torch.cuda.empty_cache()
    rwkv_launches, serve_rwkv6 = phase_serve_rwkv6(torch, dev)
    lap("phase_serve_rwkv6")
    torch.cuda.empty_cache()
    zamba_launches, serve_zamba2 = phase_serve_zamba2(torch, dev)
    lap("phase_serve_zamba2")
    gc.collect()
    torch.cuda.empty_cache()
    gemma_launches, serve_gemma3 = phase_serve_gemma3(torch, dev)
    lap("phase_serve_gemma3")
    frontend_counts, serve_frontend = {}, {}
    for arch in (VLM_ARCH, WHISPER_ARCH):
        gc.collect()
        torch.cuda.empty_cache()
        counts, serve_frontend[arch] = phase_serve_frontend(torch, dev, arch)
        lap(f"phase_serve_frontend {arch}")
        add_counts(frontend_counts, counts)
    dense_counts, serve_dense = {}, {}
    for arch in DENSE_ARCHS:        # qwen2.5-32b last: 65.5 GB of weights
        gc.collect()
        torch.cuda.empty_cache()
        counts, serve_dense[arch] = phase_serve_dense(torch, dev, arch)
        lap(f"phase_serve_dense {arch}")
        add_counts(dense_counts, counts)
    gc.collect()
    torch.cuda.empty_cache()
    moe_counts, serve_moe = phase_serve_moe(torch, dev, MOE_ARCH)
    lap(f"phase_serve_moe {MOE_ARCH}")
    gc.collect()
    torch.cuda.empty_cache()
    mla_counts, serve_mla = phase_serve_moe(torch, dev, MLA_ARCH)
    lap(f"phase_serve_moe {MLA_ARCH}")
    train_counts, train_families = {}, {}
    for arch in TRAIN_CUTS:
        gc.collect()
        torch.cuda.empty_cache()
        counts, train_families[arch] = phase_train_family(torch, dev, arch)
        lap(f"phase_train_family {arch}")
        add_counts(train_counts, counts)
    for counts in (static_serve_launches, roofline_launches,
                   elastic_launches, suspend_launches, agentic_launches,
                   carry_launches, static_launches, prefix_launches,
                   disagg_launches, train_prefix_launches, train_launches,
                   sync_launches, mux_launches_, rwkv_launches, zamba_launches,
                   gemma_launches, frontend_counts, dense_counts,
                   moe_counts, mla_counts, train_counts):
        add_counts(launches, counts)
    launches["topk"] = launches["topk_values"] + launches["topk_mask"]
    smi = card_line()
    total_s = time.perf_counter() - t0
    print(f"[smoke] every phase passed in {total_s:.1f}s ({smi})")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "serve": serve,
                   "decode_attention": rows["decode_attention"],
                   "paged_decode_attention": rows["paged_decode_attention"],
                   "flash": rows["flash_attention"],
                   "rwkv6_scan": rows["rwkv6_scan"],
                   "mamba2_scan": rows["mamba2_scan"], "topk": rows["topk"],
                   "graph": graph, "trace": trace, "elastic": elastic,
                   "suspend": suspend, "agentic": agentic, "carry": carry,
                   "static": static, "prefix": prefix, "disagg": disagg,
                   "train_prefix": train_prefix, "total_s": total_s,
                   "train": train, "sync": sync, "mux": mux,
                   "serve_static": serve_static, "roofline": roofline,
                   "serve_rwkv6": serve_rwkv6,
                   "serve_zamba2": serve_zamba2,
                   "serve_gemma3": serve_gemma3,
                   "serve_frontend": serve_frontend, "phase_s": phase_s,
                   "serve_dense": serve_dense, "serve_moe": serve_moe,
                   "serve_mla": serve_mla, "train_families": train_families},
                  f, indent=1, default=str)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
