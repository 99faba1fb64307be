#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases, in order; any exception, mismatch or NaN exits non-zero, and so
does a run still going after ``WATCHDOG_S`` seconds, with every thread's
stack printed:

1. Device and toolchain: the card's name and power limit, CUDA and nvcc
   versions; the CUDA kernels are built from ``production_stack_tpu_torch/
   ops/csrc`` (one nvcc per source, in parallel) and the build time
   printed, with ptxas's spills and the registers of each wgmma prefill,
   split-KV decode, int4 CUDA-core, CUDA-core decode and CUDA-core prefill
   instantiation; a CUDA-core prefill instantiation that spills fails.
2. Each kernel against its plain PyTorch version, with bf16 q over a bf16
   and over an e4m3 cache (``kv_cache_dtype="float8_e4m3fn"``): the
   split-KV decode and decode-write kernels at Llama-3-8B attention shapes
   (H=32, KH=8, hd=128, bs=32) over ragged lengths (0 to 4096: short rows
   get empty splits), at one sequence of 4096 (the most splits), at every
   head-group size G = 1 to 8 (G = 7 at qwen2-7b's H=28, KH=4) with a
   window that starts mid-page and a softcap, with a write 5 positions
   before a row's end and a dropped write (the caches bit for bit equal to
   the plain version's; over e4m3, a K value of 500 writes the NaN byte
   JAX's cast writes), and two launches bit for bit equal; the wgmma
   prefill kernel at every G with a window and a softcap, a ragged T,
   three sequences at different starts with a kv_len 0 row, T=2048 fresh
   and T=512 at start 3584; the CUDA-core kernels in fp32 (and bf16) at
   head_dim 16 (the tiny presets), 32, 64 and 128, over their own type and
   e4m3; the W4A16 int4 kernels at every Llama-3-8B projection shape:
   the decode route at N in {1, 2, 8, 16} and every decode bucket up to
   its boundary, the wgmma route at N in {17, 64, 300, 512, 2048}; the
   decode route also at a ragged dout (208), an odd dout (201), a group
   size wgmma refuses (48, up to 300 rows) and unaligned x and packed
   pointers, two of its launches bit for bit equal, and the resident
   blocks its plan counts on (the occupancy calculator); small shapes in
   fp32 against float64. Negative controls show the checks reject a
   decode missing a key (bf16 and e4m3), a prefill whose rows each miss
   one key and an int4 product with swapped nibbles (on both bf16 int4
   routes); on CUDA tensors a wrapper refuses what its kernel does not
   take. The int4 CUDA-core route (fp32, or bf16 with groups under 16)
   at the tiny engine's w_gate, a split over a cluster, ragged rows and
   columns, 512 groups of 8 and a Llama projection in fp32, each two
   launches bit for bit. A decode over an e4m3 cache whose bytes run
   through all 256 codes, at head_dim 128 and 256 (the NaN codes' heads
   NaN as in the plain version). At head_dim 256 (the Gemma family), over a bf16 and an e4m3
   cache: the split-KV decode and decode-write and the wgmma prefill at
   gemma2-9b's heads (H=16, KH=8, scale 1/16, softcap 50) and gemma-7b's
   (H=KH=16), over ragged lengths 0 to 4096, one sequence of 4096, a
   window of 4096 at kv_len 5000 starting mid-page, G = 1 to 8, the
   decode-write's caches bit for bit (a write 5 positions before a row's
   end, a dropped write) and two launches bit for bit, prefill at a ragged
   T, T=2048 fresh and T=512 at 3584, with the two negative controls; the
   CUDA-core kernels at head_dim 256 in fp32 at 1e-4. The bf16 head_dim-256
   decode and decode-write at G 1, 2 and 8, each at its planned split count
   and at one more forced, with a window of 1000, the softcap of 50, ragged
   lengths, a kv_len 0 row and a NaN key (two launches bit for bit). The
   CUDA-core decode and decode-write at every head dim and q type they
   serve, over q's type and e4m3, at the planned split count, at 1 and at
   3 (two launches bit for bit); the CUDA-core prefill the same way, at
   every head dim and q type, a chunk continuing at 700 with a window of
   300 and a softcap, a kv_len 0 row and a fresh chunk shorter than T (two
   launches bit for bit). The sampler's seeded draw on the card against
   the CPU's: the threefry words bit for bit, the Gumbel values within
   1e-6, and ``sample_tokens``' tokens equal.
2s. The prefill kernels at the speculative verify step's shapes: B = 1,
   8 and 64 rows of T = 5 at contexts 512 and 4096 (rows whose kv_len
   falls 3 short of their last position, padding rows, a window of 1000
   at 4096), the wgmma kernel at Llama-3-8B's and gemma2-9b's heads over
   bf16 and e4m3 caches, the CUDA-core kernel at the tiny presets' heads
   over fp32 and e4m3, against their plain versions; each launch equal bit
   for bit over a table 64 columns wider (the split plan follows the
   cache's page count, never the table's width).
2x. CUDA graphs: one launch each of the split-KV decode (bf16 cache; e4m3
   cache with the fused write), the wgmma prefill and the int4 wgmma and
   decode kernels captured into a CUDA graph; its inputs redrawn in
   place, the replay must equal an eager launch bit for bit (and the
   fused write's cache bytes) and differ from the first inputs' output.
3. The full-width 32-layer Llama-3-8B (random bf16 weights from a seed):
   one 512-token prefill and 8 decode steps through the kernels and again
   through the gather path; the logits must agree, and every decode
   launch must have taken the split-KV kernel. 3c: the same over an e4m3
   cache, with the unfused and with the fused write, against the gather
   path over an e4m3 cache, and the page counts the engine's budget gives
   in e4m3 and bf16. A decode step, a seeded draw (its seeds on the card)
   and a prefill chunk then run under CUDA's sync debug mode set to raise
   (no host sync), and
   the unembed is held to a float32 product. 3s: a verify step's logits
   (T = 5 after the 512-token prompt, ``all_logits``, the wgmma prefill
   once a layer) against 5 decode steps over the same prefix. 3x: the
   runner's steps eager
   against replayed from their CUDA graphs, each from the same KV cache
   (restored from a clone): a decode step at B=8 x 4096 (seeded draws,
   logprobs), a fresh 512-token chunk and a 4-step seeded burst with
   penalties; the packed rows and the cache bytes bit for bit; the host
   wall, device busy and idle share of both. 3y: pipelined bursts at B=8 x
   ~4096 (greedy, seeded with logprobs and penalized rows, 4 tokens a
   burst): ``burst_start``, three ``burst_continue`` (their dispatch under
   CUDA's sync debug mode set to raise) and ``burst_drain`` against four
   synchronous bursts from a clone of the same cache, rows and cache bytes
   bit for bit; the host wall, device busy and idle share a burst of each
   loop (again in int4 with the fused write, after 3b). 3w: KV swap at
   B=8 x ~2000 greedy rows over a bf16 and an e4m3 cache: after two
   4-token bursts one row is swapped out through the engine's swapper
   (committed pages left in place, the tail copied to pinned host memory)
   and back in (the tail uploaded into another page, its old one
   overwritten), both under CUDA's sync debug mode set to raise; two more
   bursts; rows, tokens and the row's pages equal an uninterrupted run's
   bit for bit; a page's size and its device-to-host and host-to-device
   device times.
4. Serving: the port's OpenAI server on localhost, configured by its own
   flags (``--warmup lazy``: ``/ready`` must answer 503 ``"warming"``,
   ``/health`` 200 ``"warming"`` and a completion 503 with
   ``X-PST-Warming: 1`` while the warmup is held, then ``/ready`` 200 with
   its summary), answers completions (streamed, chunked-prefill,
   concurrent); the kernels' launch counters are zeroed just before and
   must have grown by its end, counting each graph replay's launches; the
   engine must have replayed graphs and captured each key it ran eagerly
   (so in every server). 4c: a second server with ``--kv-cache-dtype float8_e4m3fn``
   and ``PST_FUSED_KV_WRITE=1``: the e4m3 decode-write and prefill
   counters must grow, and its page count is printed beside the bf16
   one.
4f. The engine's metrics and admin routes on a fresh bf16 server of the
   same flags (the phase 4 server shut down and its memory returned
   first): a greedy chat completion streamed and not gives the same
   tokens, its prompt is ``/tokenize`` of its messages and
   ``/detokenize`` gives the rendered text back; ``/metrics``, read by the
   script's own parser, carries the names the router's scraper reads and
   the host-gap histogram, counts the requests, their generated tokens
   and the step captures, and has an MFU above 0; ``/drain`` makes
   ``/is_draining`` true, ``/ready`` 503 ``"draining"`` and a completion
   503 with ``X-PST-Draining: 1`` until ``/undrain``. A prompt P runs
   fresh and then as a prefix-cache hit; after a level-1 sleep and wake it
   hits again with the hit's tokens, capturing nothing new. A level-2
   sleep frees at least the KV cache's bytes (printed) and answers
   ``/ready`` 503 ``"sleeping"`` and a completion 503; after the wake
   ``/ready`` answers 503 ``"warming"`` while the warmup is held, then
   200, and P runs fresh again with its first run's tokens, bit for bit,
   from graphs captured anew (every graph of before the sleep dropped),
   launching only the split-KV decode and the wgmma prefill; the free
   memory comes back to within the graph pool's bytes.
4g. A pipelining server (phase 4's flags, ``--adaptive-decode-steps 8
   --adaptive-decode-quiet-s 0``), the same with ``--no-overlap-decode``
   and the pipelining one with its diagnostics off (``--no-tracing
   --no-cost-attribution --flight-buffer 0``): 8 concurrent greedy
   streams of 128 tokens, admitted together, once to capture and once
   timed; equal tokens, ``pst:pipelined_bursts`` and
   ``pst:adaptive_deep_bursts`` above 0 and 0-valued host gaps on the
   pipelining servers, the launch counters grown; the servers' output
   tok/s and host-gap p50 (one run each). With the diagnostics on (the
   defaults) the streams' ``usage.pst_cost.device_s`` sum to within 0.90
   and 1.10 of the growth of ``pst_engine_device_busy_seconds`` (the
   fraction printed), ``pst_request_device_seconds_count{phase="decode"}``
   grows by the requests, and ``/debug/flight`` holds one row for each
   live step in the lattice's buckets; off, nothing is billed or
   recorded.
4h. A bf16 server of phase 4's flags with ``--num-kv-blocks 160`` (five
   1024-token prompts' pages): 16 requests of 1024-token prompts at once,
   6 streamed from a batch tenant and 6 from an interactive one (128
   tokens), 2 whose ``X-PST-Deadline-Ms`` is spent on arrival (504,
   ``X-PST-Deadline-Exceeded: 1``) and a second interactive tenant's 2
   whose 2 s run out mid-decode (a tagged 504; streamed, a last frame with
   ``finish_reason`` ``"deadline"``). ``/metrics``: 2 sheds at admission, 2 queued or
   running, swaps out above 0 and every one back (resumed or recomputed);
   the interactive TTFT p50 at most the batch one. Then n=4 candidates of
   a prompt just served (its pages prefix hits for each), best_of=4 with
   n=2 ranked by mean logprob, an echo with logprobs and a batch of three
   prompts. Then the same pool with ``--no-kv-swap`` (ROADMAP fault 3.6):
   the wave's 12 streamed requests all finish with their 128 tokens
   through at least one recompute preemption.
4i. Diagnostics on a bf16 server of phase 4's flags with ``--profiling``:
   a completion with a fixed ``traceparent``, ``X-Request-Id`` and
   tenant is found at ``/debug/requests?request_id=``, joined to the
   caller's trace under its span, with the spans ``engine_request``,
   ``engine_admission``, ``engine_queue``, ``prefill`` and ``decode``
   (the last three within the root's wall plus 1 ms) and the ``compile``
   events of its graph captures; ``X-PST-Cost`` equals its
   ``usage.pst_cost``, a streamed chat's final usage carries one, a spent
   deadline's 504 echoes its ``X-Request-Id`` with a ``deadline_shed``
   event, and ``pst_stage_duration_seconds_count`` counts the requests by
   stage. ``POST /debug/profile`` of 500 ms during a stream writes a
   ``torch.profiler`` trace that names ``decode_split_kernel`` (a second
   POST meanwhile answers 409).
4j. KV tiers on served paths. (a) A server with ``--num-kv-blocks 160
   --cpu-offload-blocks 512``: a 2070-token prompt A cold, as a device
   prefix hit (its 64 full pages copied to the host), and after three
   other prompts evicted every page of A as a host-tier hit (its 64
   pages faulted up, counted in ``kv_offload_host_hit_blocks`` and the
   ``kv_fetch_host`` stage, equal to the copies bit for bit; the prefill
   and decode kernels launched); its tokens equal the device hit's bit
   for bit; the three TTFTs printed. 4h's first wave again over a
   1024-page host tier: every swap resumes, none recomputes. (b) The
   port's kvserver and cache controller in threads of the script; a
   producer and a consumer server (512 pages each, one param tree): a
   2070-token prompt with the router's producer stamp (``max_tokens`` 1),
   then with the consumer stamp: 64 pages prefetched, no fallback, the
   consumer's pages equal the producer's bit for bit, its tokens equal
   the producer's device hit; ``drop_manifest`` then a second prompt:
   one fallback, a 200, the same tokens; the kvserver's ``/stats``, the
   producer's leg and the prefetch's seconds printed. (c) One
   registration of the producer's chunk hashes; ``/lookup`` of a
   2048-token prompt's returns 2048 tokens for its URL. (d) Fault 3.8: a
   2040-token prefix hit's 32 greedy tokens, decoded across the table's
   64-page bucket, and its committed pages equal the synchronous loop's
   bit for bit with the overlapped decode engaged from engine step 0, 4,
   7 or 10. Prompts of 2070 tokens keep a partial last block, so that a
   prefix hit's recomputed tail is not a block whose commit adopts
   another run's page; no check depends on when the pipeline engages.
4k. Fault 3.9: one default bf16 server, 8 greedy streams of 96-124
   tokens with top-2 logprobs after a warm-up round: the synchronous
   loop, the pipeline forced to engage after decode pass 0, 1, 5 or 37,
   and two rounds on the default arrival gate give every stream the same
   tokens and logprobs bit for bit; each run's pipelined bursts, and what
   a row's rounding follows on the card (cuBLAS products by row count,
   the split-KV decode's splits by rows), printed.
4l. The chart's argv: two port kvservers from the chart's cache-server
   args (``--sweep-interval-s 1``) and the engine server through
   ``parse_engine_args`` on the chart's default engine args (at
   ``--tensor-parallel-size 1``, ``--warmup lazy``) with ``--api-key``:
   the chart's served name, 401 without the key and 200 with it,
   ``/metrics`` and ``/ready`` open, ``/sleep`` guarded; the served
   prompt's pages published to the ring, one shard wiped, and the other
   shard's sweep backfills it with the digests kept.
4s. N-gram speculative decoding: a bf16 server with ``--speculative-ngram
   4`` (its verify buckets captured before traffic, their pool logged)
   and the same server without, 8 greedy streams of 128 tokens over
   multi-round chat prompts that re-quote an earlier turn: each stream's
   tokens equal the plain server's up to its first near-tie (a top-2
   logit gap in the plain run within 3s's tolerance; where, is logged),
   the /metrics speculation counters grow, every verify step launched the
   wgmma prefill once a layer, both size the same KV pool; acceptance
   and tok/s logged (one run each).
4m. LoRA: three PEFT adapters written by the script (rank 16, alpha 32,
   q/k/v/o, bf16, B not zero) under ``build/``. (a) A bank of two parsed
   by the port's ``LoraManager``, rows on slots 0, 1 and 2 of one batch:
   a 512-token prefill and 8 decode steps through the kernels against the
   gather path, each adapter row against a merged-weights forward (``W +
   s * A @ B`` in fp32, cast once), the split-KV decode and wgmma prefill
   launched. (e) 3x's decode step and T=512 chunk with every row on an
   adapter (8 slots), eager against replayed, beside 3x's: host wall,
   device busy, kernels a step, the bank's bytes and KV pages. (c) The
   default bf16 server with ``--enable-lora --max-loras 2``: after a base
   round, ``ad1`` and ``ad2`` load over HTTP and ``/v1/models`` lists
   them; 8 greedy streams mixed over base and adapters with top-2
   logprobs, warm rounds bit-equal with every decode step replaying a
   graph captured before the load and the adapter streams apart from the
   base ones; ``ad1`` unloaded while its streams run leaves them
   bit-equal, its slot freed after the drain, a request naming it served
   by the base model, ``ad3`` loaded into the slot. (d) The same with
   ``--speculative-ngram 4``: verify steps hold adapter rows, tokens as
   (c)'s under 4s's rule. (b), after 3b: (a) in int4 with the fused
   write against the dequantized gather path.
4n. The encode path and the cross-encoder. (a) ``Llama.encode`` at full
   width in bf16 at buckets 128, 512 and 4096: each vector finite with
   unit norm within 1e-3, its time and peak memory above what was
   allocated before it, at 128 and 4096 a ``torch.profiler`` breakdown;
   after 3b, in int4 with the fused write at 16,
   128, 512 and 4096, the kernels' run against the same encode through
   the plain ``int4_matmul`` (within 5e-2 of max|v|, its ratio to
   ``_agree``'s rule printed) and each launch against its plain version
   on the same x (7 launches a layer of the decode route at 16, of the
   wgmma route above), and the wgmma
   route's plan, check and time at N = 4096 x 4096 x 14336. (b) The
   default bf16 server: three rounds of 8 greedy streams of 128 tokens,
   the third while six embedding requests arrive once a pipelined burst
   is in flight; its tokens equal the second's bit for bit, encode flight
   rows lie between decode steps; a string, a token-id list and a batch
   of three equal ``runner.encode`` bit for bit; past ``max_model_len``
   400; ``/rerank`` says ``embedding_cosine_similarity``. (d) The same
   engine behind a second app with ``--scoring-model bge-reranker-base``
   (random fp32 weights): the five rerank and score routes answer with
   ``CrossEncoder.score_pairs``'s scores, a pair alone as in a batch
   within 1e-4, descending, ``top_n`` kept. (e) Two server subprocesses
   on ``tiny-llama-debug`` with one fresh ``--compile-cache-dir``: the
   first misses and builds the kernel library (beside (b) and (d)), the
   second hits with ``last_build_seconds`` 0 (``/metrics``,
   ``/debug/state``). (c), after 3b: the int4 server with the fused
   write, ``/v1/embeddings`` at 12 and 300 tokens launching the int4
   decode and wgmma routes 7 x 32 times each.
3b. The same model int4-quantized on the card (streamed from the seed, the
   bf16 tree freed first), under ``PST_FUSED_KV_WRITE=1``: the same steps
   through the int4 and decode-write kernels, against the gather path on a
   copy whose int4 weights were dequantized to bf16 beforehand; every
   decode-row projection on the decode route, with no split-sum pass;
   3x's decode step through the int4 and fused-write kernels, eager
   against replayed.
4b. Serving int4 with ``PST_FUSED_KV_WRITE=1``: a third server; the int4,
   decode-write and prefill counters must grow; split-sum passes follow
   only wgmma launches. 4t: 4s in int4 with the fused write; verify steps
   of 8 rows run the int4 wgmma route (N = 40).
3d. The same model int8-quantized, against the gather path on its weights
   dequantized to bf16 beforehand.
4o. Mixture-of-experts: mixtral-8x7b in int4 at full width and depth (32
   layers, 8 experts, top 2; served in int4 only: its bf16 tree is about
   93 GB), the Llama trees freed first. (a) The tree drawn and quantized
   on the card a slice at a time from a seed: its bytes split into expert
   banks, attention, int8 embed/lm_head and the rest, within 24-26 GB,
   and the peak allocated while drawing. (b) A 512-token prefill and 8
   decode steps (every ``moe_impl`` name runs ``_moe_mlp``'s one body)
   through the kernels, each int4 launch also held to its
   plain version on the
   same x (phase 2's per-row rule), and against the same forward through
   the plain versions (``int4_matmul_plain``, which dequantizes one expert
   slice a call, and the plain attention) on the kernel run's expert
   choices (the router wrapped): the logits within ``MODEL_REL_ATOL`` of
   max|logit| (phase 3b's rule). The kernels and the plain versions round
   differently, so near-ties in a router's top 2 go either way and a
   random 32-layer model carries such a flip on through attention: the
   share of (token, layer) choices an unforced plain run makes otherwise,
   by layer, is printed, not held. int4 launches 28 a layer a step (4
   attention projections, 3 x 8 expert products), prefill and decode one
   a layer a step; a negative control
   whose kernels read layer 0's ``w_gate`` bank with its nibble planes
   swapped fails the check. (c) Through the runner: a decode step at
   B=8 x 4096 and a fresh T=512 chunk run eagerly, then replayed, under
   CUDA's sync debug mode set to raise, and held eager against replayed
   bit for bit (``graph_vs_eager``: rows and cache bytes; wall, device
   busy, idle share); the expert products' FLOPs a step beside those of
   the routed pairs alone; the decode step's byte bound with every
   expert read, and with only the experts its rows routed to (their
   count by layer recorded in the eager step). (d) The
   server with ``--model mixtral-8x7b --quantization int4 --moe-impl
   auto`` (prefix caching off, so both rounds prefill alike): 4
   concurrent greedy completions of 32 tokens (one streamed),
   a round to capture, then a timed round that must replay every step
   (no eager step, no capture) with tokens equal to the first round's;
   its int4 and attention counters grow from 0; TTFT (mean, from
   ``/metrics``), output tok/s and the steps' share of the wall
   (``pst_engine_device_busy_seconds``). (e) ``tiny-mixtral-debug`` (fp32,
   head_dim 16) on the card: the CUDA-core attention kernels and the fp32
   experts (``torch.matmul``), no int4 launch.
3z. A checkpoint written and served: Llama-3-8B's widths at 4 of its 32
   layers (depth cut to bound the disk written, about 3.9 GB), random
   bf16 weights from a seed in HF names and ``[out, in]`` layout, two
   shards with ``model.safetensors.index.json`` and a config.json of the
   preset's fields (with Llama-3.1's llama3 rope scaling), under
   ``build/``: ``load_hf_params`` in bf16 equals the source tensors bit for
   bit, in int4 the card's leaves equal the CPU loader's, a prefill and a
   burst through the runner equal the in-memory tree's, the load's
   seconds and GB/s are printed, and a server started with ``--model
   <dir>`` answers a greedy completion with the in-process engine's
   tokens. The directory is removed afterwards.
3e. qwen2-7b at full width and 4 of its 28 layers (G = 7, QKV biases):
   prefill and decode through the kernels over a bf16 and an e4m3 cache,
   against the gather path.
4d. ``EngineConfig(device="cuda")``, the default tiny preset (fp32,
   head_dim 16), answers a completion on the CUDA-core kernels; so do the
   same over an e4m3 cache and both with the fused write. A tiny engine
   with ``warmup="full"`` captures every lattice bucket; traffic that
   spans the lattice then captures nothing (a penalized prefill at most
   once).
3f. gemma2-9b at full width and depth (42 layers, 9.24B random bf16
   parameters, its (1 + w) norms drawn as N(0, 0.1) around w = 0 since a
   random model at the JAX init's w = 1 amplifies rounding with depth (see
   ``drift`` below), the Llama tree freed first): a 4608-token prompt in
   512-token chunks (past its window of 4096) and 8 decode steps through
   the head_dim-256 kernels against the gather path, over a bf16 cache
   (unfused; beside it, as a witness of how far two correct paths differ,
   the kernels' plain versions against the gather path) and an e4m3 cache
   (unfused and fused); then its int4 form (4
   layers, fused write) against its dequantized gather path, with the
   int4 route of each projection.
4e. A server with ``--model gemma2-9b`` and ``PST_FUSED_KV_WRITE=1``
   answers a chunked, a streamed and two concurrent completions; its
   head_dim-256 decode-write and prefill counters must grow.
3g. gemma-7b (G = 1 at head_dim 256) and qwen3-8b (q/k norms on the
   head_dim-128 kernels) at full width, 4 layers each: kernels against
   the gather path.
5. Times of each kernel at the slice's shapes beside its plain version, a
   PyTorch call as a yardstick where one computes the same function, and
   its bound: decode and decode-write at B=8, 1 and 64 at kv_len 4096 and
   at B=64 x 512 (with the split count of each); prefill at
   T=512 fresh, T=512 at start 3584, T=2048 fresh and the verify step's
   B=8 x T=5 ending at 4096, each over a bf16 and
   an e4m3 cache (bound at the cache's bytes; the e4m3 yardstick is SDPA
   on K/V up-cast to bf16 beforehand); the CUDA-core kernels at
   tiny-llama-debug's heads and (decode, decode-write) at fp32 Llama-3-8B
   heads, B=8 x 4096, beside an empty kernel queued the same way, and the
   CUDA-core prefill also at fp32 Llama-3-8B heads (a fresh 512-token
   chunk and one at 3584) and gemma2-9b's (fresh, no softcap); the int4
   wgmma route at N=512 for the four
   projection shapes and at N=2048; the int4 decode route at N in {1, 8,
   16} (and the decode buckets up to its boundary) for the four projection
   shapes; both bf16 int4 routes at N in {1, 8, 16, 32, 64} on the four
   shapes (the route boundary's crossover); the head_dim-256 kernels at
   gemma2-9b's heads over both caches: decode and decode-write at B=8, 1
   and 64 x 4096 and B=64 x 512, prefill at T=512 fresh, at 3584 and
   T=2048 fresh (SDPA, the yardstick, takes no softcap and runs without
   one);
   the int4 CUDA-core route in fp32 at N=8 on the tiny engine's w_gate
   (128 x 256) and on Llama-3-8B's (4096 x 14336, not a served shape).

Before the last line come a JSON ``graphs`` summary (the step rows of
3x, the serving phases' graph counts, pool bytes and warmup summary, the
tiny full warmup) and a JSON ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
package beside it, the script exits non-zero and prints no result.

    python3 chip_smoke.py drift

builds the kernels and runs only the drift sweep: gemma2-9b at 4, 12 and
42 layers with its (1 + w) norms at w = 1, 0.5 and 0, through the
kernels, the gather path and the kernels' plain versions (``drift``).

    python3 chip_smoke.py rounds

builds the kernels and runs only the rounds sweep (``rounds_sweep``):
five rounds of 4s's streams on the default server and on the
synchronous one, where each stream first parts from the second round;
it fails unless each server's warm rounds agree token for token.

    python3 chip_smoke.py engagement

builds the kernels and runs phase 4k four times (``engagement_sweep``):
with fault 3.9's two causes put back, each alone and both; it fails
unless 4k fails with either and passes with neither.

    python3 chip_smoke.py lora

builds the kernels and runs phase 4m alone (``lora_only``), with 3s and
3x for what it reads of them.

    python3 chip_smoke.py encode

builds the kernels and runs phase 4n alone (``encode_only``), with the
int4 tree drawn on the card in place of phase 3b.

    python3 chip_smoke.py moe

builds the kernels and runs phase 4o alone (``phase_moe``).

    python3 chip_smoke.py tp

builds the kernels and runs phase 4p alone (``tp_only``): tensor
parallelism at 2 ranks that share the card over gloo (NCCL refuses two
ranks on one device; the NCCL path, a card a rank, is not run on a
one-card machine, and the phase says so). (a) Llama-3-8B bf16 from seed
0: a tp-2 runner (this process and one spawned follower, each drawing
its shard) against the whole tree at tp 1 through the 512-token prompt
and 8 teacher-forced decode steps, every position's logits under
``agree``, the prefill and decode kernels' launches on both ranks; (b)
the int4 tree with the fused write the same way (the int4 kernels at
the shard shapes, ``decode_split_kernel<..., true, ...>``), and each
shard shape's int4 route and time; (c) ``python -m
production_stack_tpu_torch.engine.server --tensor-parallel-size 2``
through its ``main``: greedy, streamed and seeded sampled completions,
``/metrics``, ``/debug/state``, each rank's report at shutdown, SIGTERM
leaving no rank alive, and its greedy tokens against a tp-1 server's.
The step times it prints measure gloo's transport through the host on
one card, not tensor parallelism.

    python3 chip_smoke.py pp

builds the kernels and runs phase 4q alone (``pp_only``): pipeline and
data parallelism, every rank sharing the card over gloo (the NCCL path
is not run on a one-card machine, and the phase says so). (a)
Llama-3-8B bf16 from seed 0 at pp 2 (each stage draws its 16 layers)
against the whole tree at one rank through the 512-token prompt and 8
teacher-forced decode steps under ``agree``, each stage's prefill and
decode launches for its own 16 layers, its peak memory and its
hand-off's bytes and time; (b) the int4 tree with the fused write at dp
2: a prefill of 8 rows and 8 decode steps of them, split 4 and 4, under
``agree`` against one rank, the int4 decode route at N=4 and
``decode_split_kernel<128, 4, true, false>`` on both replicas, the int4
kernel at N=4 against its plain version at the four Llama shapes, both
replicas' caches equal bit for bit on every written page and the K/V
exchange's bytes and time; (c) ``python -m
production_stack_tpu_torch.engine.server --pipeline-parallel-size 2
--data-parallel-size 2 --quantization int4`` (four ranks) through its
``main``: greedy, streamed and seeded sampled completions, ``/metrics``,
``/debug/state``'s ranks, each rank's report at shutdown, SIGTERM leaving
no rank alive, and 48 greedy tokens against a one-rank int4 server's.
Its step times measure gloo's transport through the host on one card,
not pipeline or data parallel speed.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import faulthandler
import functools
import gc
import http.client
import itertools
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA GPU is available")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine  # noqa: E402
from production_stack_tpu_torch.engine.cache_tiering import (  # noqa: E402
    TieredAllocator,
    wait_landed,
)
from production_stack_tpu_torch.engine.config import (  # noqa: E402
    EngineConfig,
    resolve_num_kv_blocks,
)
from production_stack_tpu_torch.engine.engine import LLMEngine  # noqa: E402
from production_stack_tpu_torch.engine.kv_manager import BlockAllocator  # noqa: E402
from production_stack_tpu_torch.engine.lora import LoraManager  # noqa: E402
from production_stack_tpu_torch.engine.multihost import (  # noqa: E402
    Ranks,
    start_ranks,
)
from production_stack_tpu_torch.engine.runner import (  # noqa: E402
    ModelRunner,
    capture,
    on_stream,
)
from production_stack_tpu_torch.engine.scheduler import PrefillItem  # noqa: E402
from production_stack_tpu_torch.engine.sequence import (  # noqa: E402
    SamplingParams,
    Sequence,
)
from production_stack_tpu_torch.engine.tokenizer import ChatMessage  # noqa: E402
from production_stack_tpu_torch.engine.precompile import enumerate_lattice  # noqa: E402
from production_stack_tpu_torch.engine.server import (  # noqa: E402
    app_options_from_args,
    cross_encoder_from_args,
    engine_config_from_args,
    parse_engine_args,
    register_with_controller,
    serve_in_thread,
)
from production_stack_tpu_torch.engine.swap import KVSwapper  # noqa: E402
from production_stack_tpu_torch.kvcache.hashing import (  # noqa: E402
    block_hashes,
    chunk_hashes,
)
from production_stack_tpu_torch.kvserver.controller import ControllerServer  # noqa: E402
from production_stack_tpu_torch.kvserver.server import (  # noqa: E402
    KVServer,
    server_from_args,
    start_in_thread,
    unpack_blocks_ex,
)
from production_stack_tpu_torch.models import llama as llama_mod  # noqa: E402
from production_stack_tpu_torch.models.llama import (  # noqa: E402
    QUANT_SUFFIX,
    Llama,
    quantize_leaf_int4,
    unembed_logits,
)
from production_stack_tpu_torch.models.registry import get_model_config  # noqa: E402
from production_stack_tpu_torch.models.safetensors import INDEX_FILE  # noqa: E402
from production_stack_tpu_torch.ops import _build  # noqa: E402
from production_stack_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from production_stack_tpu_torch.ops import paged_attention_cuda as pac  # noqa: E402
from production_stack_tpu_torch.ops.attention import gather_pages  # noqa: E402
from production_stack_tpu_torch.ops.fp8 import E4M3, raw, to_cache_dtype  # noqa: E402
from production_stack_tpu_torch.ops import sampling as sampler  # noqa: E402
from production_stack_tpu_torch.ops.sampling import (  # noqa: E402
    apply_logit_bias,
    sample_tokens_packed,
)
from production_stack_tpu_torch.tools.profile_step import (  # noqa: E402
    profile,
    step_inputs,
)

DEV = torch.device("cuda")
MODEL = "llama-3-8b"
H, KH, HD, BS = 32, 8, 128, 32  # Llama-3-8B attention shapes
SCALE = HD ** -0.5

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # off the tensor cores: the CUDA-core kernels

# bf16 keeps about 3 significant decimal digits and the kernel sums in a
# different order than the plain version: 2e-2 of the largest magnitude of
# the same output row (one head of one query), so a row over 4000 keys is
# held to its own small scale and not to that of a one-key row.
BF16_REL_ATOL = 2e-2
# fp32 inputs, fp32 accumulation in both, only the summation order differs.
FP32_ATOL = 1e-4
# The int4 kernel in fp32 against the float64 product: the TPU kernel's own
# rule (tests/test_int4_matmul.py), a share of the largest |ref|.
INT4_FP32_REL = 1e-5
# Logits of 32 bf16 layers computed in a different order (kernel vs gather).
MODEL_REL_ATOL = 5e-2

SOURCE = "production_stack_tpu_torch/ops/csrc/decode_splitkv.cuh"
PREFILL_SOURCE = "production_stack_tpu_torch/ops/csrc/prefill_wgmma.cuh"
SIMT_SOURCE = "production_stack_tpu_torch/ops/csrc/paged_attention.cuh"
PALLAS = "production_stack_tpu/ops/paged_attention_pallas.py"
# One row per kernel, cache form and head dim. Its launches are the count
# of the kernel's route (ROUTE_OF) over the path that runs it: the bf16
# server (decode, prefill), the int4 server (decode_write, int4,
# int4_wgmma), the fp8 server (decode_write_e4m3, prefill_e4m3), the fp8
# model's unfused steps (decode_e4m3), the default tiny engine (the
# CUDA-core rows), the gemma2-9b server (decode_write_hd256,
# prefill_hd256) and gemma2-9b's model steps (the other hd256 rows).
KERNELS = {
    "decode": dict(
        name="paged_attention_decode", route="cuda", source=SOURCE,
        replaces=f"{PALLAS}:218",
    ),
    "prefill": dict(
        name="paged_attention_prefill", route="cuda", source=PREFILL_SOURCE,
        replaces=f"{PALLAS}:430",
    ),
    "decode_write": dict(
        name="paged_attention_decode_write", route="cuda", source=SOURCE,
        replaces=f"{PALLAS}:301",
    ),
    "decode_e4m3": dict(
        name="paged_attention_decode[e4m3 cache]", route="cuda",
        source=SOURCE, replaces=f"{PALLAS}:218",
    ),
    "prefill_e4m3": dict(
        name="paged_attention_prefill[e4m3 cache]", route="cuda",
        source=PREFILL_SOURCE, replaces=f"{PALLAS}:430",
    ),
    "decode_write_e4m3": dict(
        name="paged_attention_decode_write[e4m3 cache]", route="cuda",
        source=SOURCE, replaces=f"{PALLAS}:301",
    ),
    "decode_simt": dict(
        name="paged_attention_decode[CUDA cores]", route="cuda",
        source=SIMT_SOURCE, replaces=f"{PALLAS}:218",
    ),
    "prefill_simt": dict(
        name="paged_attention_prefill[CUDA cores]", route="cuda",
        source=SIMT_SOURCE, replaces=f"{PALLAS}:430",
    ),
    "decode_write_simt": dict(
        name="paged_attention_decode_write[CUDA cores]", route="cuda",
        source=SIMT_SOURCE, replaces=f"{PALLAS}:301",
    ),
    "decode_simt_e4m3": dict(
        name="paged_attention_decode[CUDA cores, e4m3 cache]", route="cuda",
        source=SIMT_SOURCE, replaces=f"{PALLAS}:218",
    ),
    "prefill_simt_e4m3": dict(
        name="paged_attention_prefill[CUDA cores, e4m3 cache]", route="cuda",
        source=SIMT_SOURCE, replaces=f"{PALLAS}:430",
    ),
    "decode_write_simt_e4m3": dict(
        name="paged_attention_decode_write[CUDA cores, e4m3 cache]",
        route="cuda", source=SIMT_SOURCE, replaces=f"{PALLAS}:301",
    ),
    "int4": dict(
        name="int4_matmul", route="cuda",
        source="production_stack_tpu_torch/ops/csrc/int4_decode.cu",
        replaces="production_stack_tpu/ops/int4_matmul.py:73",
    ),
    "int4_wgmma": dict(
        name="int4_matmul_wgmma", route="cuda",
        source="production_stack_tpu_torch/ops/csrc/int4_matmul.cu",
        replaces="production_stack_tpu/ops/int4_matmul.py:73",
    ),
    "int4_simt": dict(
        name="int4_matmul[CUDA cores]", route="cuda",
        source="production_stack_tpu_torch/ops/csrc/int4_matmul.cu",
        replaces="production_stack_tpu/ops/int4_matmul.py:73",
    ),
    # head_dim 256 (gemma-7b, gemma2-9b): the same kernels' HD = 256 builds.
    "decode_hd256": dict(
        name="paged_attention_decode[head_dim 256]", route="cuda",
        source=SOURCE, replaces=f"{PALLAS}:218",
    ),
    "prefill_hd256": dict(
        name="paged_attention_prefill[head_dim 256]", route="cuda",
        source=PREFILL_SOURCE, replaces=f"{PALLAS}:430",
    ),
    "decode_write_hd256": dict(
        name="paged_attention_decode_write[head_dim 256]", route="cuda",
        source=SOURCE, replaces=f"{PALLAS}:301",
    ),
    "decode_e4m3_hd256": dict(
        name="paged_attention_decode[head_dim 256, e4m3 cache]",
        route="cuda", source=SOURCE, replaces=f"{PALLAS}:218",
    ),
    "prefill_e4m3_hd256": dict(
        name="paged_attention_prefill[head_dim 256, e4m3 cache]",
        route="cuda", source=PREFILL_SOURCE, replaces=f"{PALLAS}:430",
    ),
    "decode_write_e4m3_hd256": dict(
        name="paged_attention_decode_write[head_dim 256, e4m3 cache]",
        route="cuda", source=SOURCE, replaces=f"{PALLAS}:301",
    ),
}
# Which launch counter of a path belongs to each row: the route of the
# kernel the row times (the int4 wrapper's two bf16 routes are two
# kernels).
ROUTE_OF = {"prefill": "prefill_wgmma", "int4": "decode", "int4_wgmma": "wgmma",
            "decode": "decode_split", "decode_write": "decode_write_split",
            "decode_e4m3": "decode_split_e4m3",
            "prefill_e4m3": "prefill_wgmma_e4m3",
            "decode_write_e4m3": "decode_write_split_e4m3",
            **{k: k for k in KERNELS if "simt" in k}}
ROUTE_OF.update({k + "_hd256": ROUTE_OF[k] + "_hd256" for k in (
    "decode", "prefill", "decode_write", "decode_e4m3", "prefill_e4m3",
    "decode_write_e4m3")})
max_err = {k: 0.0 for k in KERNELS}

# Llama-3-8B projections: (din, dout) of wq/wo, wk/wv, w_gate/w_up, w_down.
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
# The seven projections of a layer, in that order: wq, wk, wv, wo, w_gate,
# w_up, w_down.
LAYER_SHAPES = ((4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                (4096, 14336), (4096, 14336), (14336, 4096))
# The engine's decode buckets (powers of two up to max_num_seqs = 64).
DECODE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# The Gemma family's attention at head_dim 256: gemma2-9b's H=16 over KH=8
# (G=2) with scale 1/sqrt(query_pre_attn_scalar = 256), softcap 50 and a
# window of 4096 on alternate layers; gemma-7b's H=KH=16 (G=1), scale
# 1/sqrt(256), no softcap.
GEMMA = "gemma2-9b"
HD256, HD256_SCALE = 256, 256 ** -0.5
GEMMA2_HEADS = dict(h=16, kh=8, softcap=50.0)
GEMMA1_HEADS = dict(h=16, kh=16, softcap=0.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Phase 1: device and toolchain
# ---------------------------------------------------------------------------


def phase_toolchain() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log("nvcc: " + nvcc[-1])
    t0 = time.perf_counter()
    _build.load()
    log(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.last_build_seconds:.1f}s) -> {_build.library_path()}")
    # ptxas's report, one entry per kernel: registers and spill stores.
    entries = []
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append([m.group(1), 0, 0])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entries:
            entries[-1][2] = max(entries[-1][2], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entries:
            entries[-1][1] = int(m.group(1))
    spilled = [e for e in entries if e[2]]
    names = [e[0] for e in spilled]
    filt = os.path.join(os.path.dirname(_build.nvcc_path()), "cu++filt")
    if names and os.path.exists(filt):
        names = subprocess.run([filt, *names], capture_output=True, text=True,
                               check=True).stdout.splitlines()
    log(f"  ptxas: {len(entries)} kernels, at most "
        f"{max((e[1] for e in entries), default=0)} registers; "
        f"{len(spilled)} spill:")
    for name, e in zip(names, spilled):
        log(f"    {e[2]} bytes of spill stores, {e[1]} registers: {name}")
    # The wgmma prefill's instantiations, HD/G/cache: registers (+ spill).
    prefill = []
    for name, regs, spill in entries:
        m = re.search(r"paged_prefill_wgmma_kernelILi(\d+)ELi(\d)ELb(\d)", name)
        if m:
            prefill.append(f"{m[1]}/{m[2]}/{'e4m3' if m[3] == '1' else 'bf16'}"
                           f":{regs}" + (f"+{spill}B spill" if spill else ""))
    log("  ptxas, paged_prefill_wgmma_kernel<HD, G, cache> registers: "
        + " ".join(sorted(prefill, key=lambda x: [int(v) if v.isdigit() else v
                                                   for v in re.split(r"[/:]", x)])))
    # The split-KV decode's, HD/G/decode or write/cache, and the int4
    # CUDA-core kernel's, x type/vector loads.
    split, simt = [], []
    for name, regs, spill in entries:
        tail = f":{regs}" + (f"+{spill}B spill" if spill else "")
        m = re.search(r"decode_split_kernelILi(\d+)ELi(\d)ELb(\d)ELb(\d)",
                      name)
        if m:
            split.append(f"{m[1]}/{m[2]}/{'write' if m[3] == '1' else 'decode'}"
                         f"/{'e4m3' if m[4] == '1' else 'bf16'}" + tail)
        m = re.search(r"int4_simt_kernelI(f|13__nv_bfloat16)Lb(\d)", name)
        if m:
            simt.append(f"{'fp32' if m[1] == 'f' else 'bf16'}/"
                        f"{'vec' if m[2] == '1' else 'bytes'}" + tail)
    log("  ptxas, decode_split_kernel<HD, G, kind, cache> registers: "
        + " ".join(sorted(split, key=lambda x: [int(v) if v.isdigit() else v
                                                for v in re.split(r"[/:]", x)])))
    log("  ptxas, int4_simt_kernel<x, loads> registers: " + " ".join(simt))
    short = {"float": "fp32", "__nv_bfloat16": "bf16",
             "__nv_fp8_e4m3": "e4m3"}
    # The CUDA-core decode's, q/cache/GM/HD/decode or write, demangled.
    cuda_core = [(n, r, sp) for n, r, sp in entries
                 if "paged_decode_kernel" in n]
    if cuda_core and os.path.exists(filt):
        names = subprocess.run([filt, *(n for n, _, _ in cuda_core)],
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        regs = []
        for name, (_, r, sp) in zip(names, cuda_core):
            m = re.search(r"paged_decode_kernel<([\w:]+), ([\w:]+), "
                          r"(?:\(int\))?(\d+), (?:\(int\))?(\d+), "
                          r"(?:\(bool\))?(\w+)>", name)
            if m:
                regs.append(f"{short.get(m[1], m[1])}/{short.get(m[2], m[2])}"
                            f"/{m[3]}/{m[4]}/"
                            f"{'write' if m[5] in ('true', '1') else 'decode'}"
                            f":{r}" + (f"+{sp}B spill" if sp else ""))
        log("  ptxas, paged_decode_kernel<q, cache, GM, HD, kind> registers: "
            + " ".join(sorted(regs)))
    # The CUDA-core prefill's, q/cache/HD: none may spill.
    cuda_core = [(n, r, sp) for n, r, sp in entries
                 if "paged_prefill_kernel" in n]
    if cuda_core and os.path.exists(filt):
        names = subprocess.run([filt, *(n for n, _, _ in cuda_core)],
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        regs = []
        for name, (_, r, sp) in zip(names, cuda_core):
            m = re.search(r"paged_prefill_kernel<([\w:]+), ([\w:]+), "
                          r"(?:\(int\))?(\d+)>", name)
            if m:
                regs.append(f"{short.get(m[1], m[1])}/{short.get(m[2], m[2])}"
                            f"/{m[3]}:{r}" + (f"+{sp}B spill" if sp else ""))
        log("  ptxas, paged_prefill_kernel<q, cache, HD> registers: "
            + " ".join(sorted(regs)))
    check(all(not sp for n, _, sp in entries if "paged_prefill_kernel" in n),
          "a CUDA-core prefill instantiation spills")
    return smi


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_case(gen, *, B, T, kv_lens, starts=None, dtype=torch.bfloat16,
              h=H, kh=KH, layers=2, extra_pages=3, cache_dtype=None, hd=HD):
    """Random q and a paged cache (``cache_dtype``, default q's; e4m3 is
    drawn in fp32 and cast by ``cast_e4m3``) whose pages each row reaches
    through a shuffled block table. Returns q [B,T,h,hd], cache, tables,
    kv_lens, starts (all on the card)."""
    W = max(-(-max(kv_lens) // BS), 1)
    nb = B * W + extra_pages
    q = torch.randn((B, T, h, hd), generator=gen, device=DEV).to(dtype)
    cache = torch.randn((layers, nb, 2, BS, kh * hd), generator=gen,
                        device=DEV)
    cache = to_cache_dtype(cache, cache_dtype or dtype)
    perm = torch.randperm(nb, generator=gen, device=DEV)[: B * W]
    tables = perm.reshape(B, W).to(torch.int32).contiguous()
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=DEV)
    st = torch.tensor(starts if starts is not None else [0] * B,
                      dtype=torch.int32, device=DEV)
    return q, cache, tables, lens, st


def bf16_row_check(got: torch.Tensor, ref: torch.Tensor):
    """One tolerance per output row (the last axis): 2e-2 of that row's
    largest |ref|, so a row with no live key must be exactly 0. Returns
    (all rows within, worst err / row tol, smallest nonzero row tol)."""
    diff = (got.float() - ref.float()).abs()
    tol = BF16_REL_ATOL * ref.float().abs().amax(-1, keepdim=True)
    ratio = float((diff / tol.clamp_min(1e-30)).max())
    return bool((diff <= tol).all()), ratio, float(tol[tol > 0].min())


def compare(kind: str, got: torch.Tensor, ref: torch.Tensor,
            label: str, rows: bool = False) -> float:
    """bf16 outputs (or ``rows``: fp32 outputs of bf16 inputs) are held to
    the per-row tolerance; other fp32 outputs to FP32_ATOL."""
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    if got.dtype == torch.bfloat16 or rows:
        ok, ratio, smallest = bf16_row_check(got, ref)
        log(f"  {label}: max|err| {err:.3e}, worst err / row tol "
            f"{ratio:.3f} (row tol 2e-2·max|ref row|, smallest {smallest:.3e})")
        max_err[kind] = max(max_err[kind], err)
        check(ok, f"{label}: kernel disagrees with its plain version")
    else:
        log(f"  {label}: max|err| {err:.3e} (tol {FP32_ATOL:.1e})")
        max_err[kind] = max(max_err[kind], err)
        check(err <= FP32_ATOL,
              f"{label}: kernel disagrees with its plain version")
    return err


def form(kind: str, cache_dtype, hd: int = HD) -> str:
    """The row of KERNELS (and the route counter's suffixes) for a wrapper,
    a cache type and a head dim."""
    return (kind + ("_e4m3" if cache_dtype == E4M3 else "")
            + ("_hd256" if hd == 256 else ""))


def run_decode(q3, cache, tables, lens, layer, scale=SCALE, **kw):
    got = pac.paged_attention_decode(q3, cache, tables, lens, layer,
                                     scale=scale, **kw)
    ref = pac.paged_attention_decode_plain(q3, cache, tables, lens, layer,
                                           scale=scale, **kw)
    torch.cuda.synchronize()
    return got, ref


def run_prefill(q, cache, tables, lens, starts, layer, scale=SCALE, **kw):
    got = pac.paged_attention_prefill(q, cache, tables, lens, starts, layer,
                                      scale=scale, **kw)
    ref = pac.paged_attention_prefill_plain(q, cache, tables, lens, starts,
                                            layer, scale=scale, **kw)
    torch.cuda.synchronize()
    return got, ref


# Head groups G = H / KH from 1 to 8: Llama-3-8B's KH=8 with H = 8 .. 64,
# and KH=4 for G = 5, 6 and 7 (qwen2-7b's 28 heads over 4).
GROUP_SHAPES = ((8, 8), (16, 8), (24, 8), (H, KH), (20, 4), (24, 4), (28, 4),
                (16, 2))


def phase_kernels(cache_dtype=torch.bfloat16) -> None:
    """bf16 q over a bf16 or an e4m3 cache: the split-KV decode and the
    wgmma prefill kernels; with a bf16 cache also the fp32 kernels and the
    wrappers' refusals."""
    pac.reset_launch_counts()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    tag = str(cache_dtype)[6:]
    dec, pre = form("decode", cache_dtype), form("prefill", cache_dtype)
    case = functools.partial(make_case, cache_dtype=cache_dtype)

    # Decode, bf16 q: lengths 0 (padding row), 1, a page minus/at/plus one,
    # about 4k.
    lens = [0, 1, 31, 32, 33, 4096, 4000, 777]
    q, cache, tables, kl, _ = case(gen, B=8, T=1, kv_lens=lens)
    got, ref = run_decode(q[:, 0], cache, tables, kl, 1)
    check(bool((got[0] == 0).all()), "decode: kv_len 0 row must be zeros")
    compare(dec, got, ref, f"decode {tag} B=8 kv_lens={lens}")
    # The check has teeth: the plain version with the last key of each long
    # row dropped (a kernel that misses one key of 4096 or 4000) fails it.
    wrong = pac.paged_attention_decode_plain(q[:, 0], cache, tables, kl - 1, 1,
                                             scale=SCALE)
    ok, ratio, _ = bf16_row_check(wrong[5:7], ref[5:7])
    log(f"  a {tag} decode that drops the last of 4096/4000 keys: worst err "
        f"/ row tol {ratio:.3f}")
    check(not ok, f"the row check passes a {tag} decode that drops a key")
    check(torch.equal(got, pac.paged_attention_decode(q[:, 0], cache, tables,
                                                      kl, 1, scale=SCALE)),
          "decode: two launches on the same inputs differ")
    # One sequence at 4096 (the most splits the plan gives), and every
    # head-group size with a window that starts mid-page and a softcap,
    # over the same ragged lengths (short rows get empty splits).
    q, cache, tables, kl, _ = case(gen, B=1, T=1, kv_lens=[4096])
    got, ref = run_decode(q[:, 0], cache, tables, kl, 1)
    compare(dec, got, ref, f"decode {tag} B=1 kv_len 4096 "
            f"({splits_of(q, cache, tables)} splits)")
    for h, kh in GROUP_SHAPES:
        q, cache, tables, kl, _ = case(gen, B=8, T=1, kv_lens=lens, h=h,
                                       kh=kh)
        got, ref = run_decode(q[:, 0], cache, tables, kl, 0, window=45,
                              softcap=30.0)
        check(bool((got[0] == 0).all()), "decode: kv_len 0 row must be zeros")
        compare(dec, got, ref,
                f"decode {tag} G={h // kh} (H={h}, KH={kh}) window=45 "
                f"softcap=30 ({splits_of(q, cache, tables)} splits)")
    check(sum(n for k, n in pac.route_counts.items() if "simt" in k) == 0,
          "a bf16 decode took a CUDA-core kernel")

    # Prefill (the wgmma kernel): T=512 fresh, T=512 continuing at 1000 and
    # at 3584, T=300 ragged, T=2048 fresh.
    for T, start in ((512, 0), (512, 1000), (512, 3584), (300, 77),
                     (2048, 0)):
        q, cache, tables, kl, st = case(
            gen, B=2, T=T, kv_lens=[start + T, start + T],
            starts=[start, start])
        got, ref = run_prefill(q, cache, tables, kl, st, 1)
        compare(pre, got, ref, f"prefill {tag} B=2 T={T} start={start}")
        if T == 512 and start == 0:
            # The check has teeth: the plain version with every row's last
            # key dropped (each row one position earlier) fails it, on the
            # rows that keep a key.
            wrong = pac.paged_attention_prefill_plain(
                q, cache, tables, kl, st - 1, 1, scale=SCALE)
            ok, ratio, _ = bf16_row_check(got[:, 1:], wrong[:, 1:])
            log(f"  a {tag} prefill whose rows each miss their last key: "
                f"worst err / row tol {ratio:.3f}")
            check(not ok, "the row check passes a prefill that drops a key")
    # Three sequences at different starts, the middle one with kv_len 0:
    # its rows see no key and must be exactly zero.
    q, cache, tables, kl, st = case(
        gen, B=3, T=100, kv_lens=[100, 0, 1100], starts=[0, 300, 1000])
    got, ref = run_prefill(q, cache, tables, kl, st, 1)
    check(bool((got[1] == 0).all()), "prefill: kv_len 0 rows must be zeros")
    compare(pre, got, ref,
            f"prefill {tag} B=3 T=100 starts=[0, 300, 1000] kv_lens=[100, 0, "
            "1100]")
    # Every head-group size, with a window that starts mid-page and a
    # softcap: at G = 3, 5, 6, 7 the tile's last rows are padding.
    for h, kh in GROUP_SHAPES:
        q, cache, tables, kl, st = case(
            gen, B=2, T=70, kv_lens=[270, 70], starts=[200, 0], h=h, kh=kh)
        got, ref = run_prefill(q, cache, tables, kl, st, 0, window=45,
                               softcap=30.0)
        compare(pre, got, ref,
                f"prefill {tag} G={h // kh} (H={h}, KH={kh}) T=70 window=45 "
                "softcap=30")
    check(sum(n for k, n in pac.route_counts.items() if "simt" in k) == 0,
          "a bf16 prefill took a CUDA-core kernel")
    if cache_dtype == E4M3:
        return

    # fp32 with a window that starts mid-page and a softcap, and every head
    # group size.
    for h, kh in ((H, KH), (8, 8), (16, 2), (4, 2), (28, 4), (24, 8)):
        lens = [0, 50, 300, 1000]
        q, cache, tables, kl, _ = make_case(
            gen, B=4, T=1, kv_lens=lens, dtype=torch.float32, h=h, kh=kh)
        got, ref = run_decode(q[:, 0], cache, tables, kl, 0, window=100,
                              softcap=30.0)
        compare("decode_simt", got, ref,
                f"decode fp32 H={h} KH={kh} window=100 softcap=30")
        q, cache, tables, kl, st = make_case(
            gen, B=2, T=70, kv_lens=[270, 70], starts=[200, 0],
            dtype=torch.float32, h=h, kh=kh)
        got, ref = run_prefill(q, cache, tables, kl, st, 0, window=45,
                               softcap=30.0)
        compare("prefill_simt", got, ref,
                f"prefill fp32 H={h} KH={kh} T=70 window=45 softcap=30")
        got, ref = run_prefill(q, cache, tables, kl, st, 1)
        compare("prefill_simt", got, ref, f"prefill fp32 H={h} KH={kh} T=70")

    # On the card a wrapper launches its kernel or raises: never the plain
    # version.
    q, cache, tables, kl, _ = make_case(gen, B=2, T=1, kv_lens=[5, 9])
    refused = (
        (TypeError, (q[:, 0], cache.to(torch.float8_e5m2))),
        (ValueError, (q[:, 0][..., :96].contiguous(),
                      cache[..., :KH * 96].contiguous())),  # head_dim 96
        (ValueError, (q[:, 0].transpose(0, 1).contiguous().transpose(0, 1), cache)),
    )
    for err, (qq, cc) in refused:
        try:
            pac.paged_attention_decode(qq, cc, tables, kl, 0, scale=SCALE)
        except err:
            continue
        raise AssertionError(f"decode wrapper accepted what it must refuse ({err})")
    log("  wrappers refuse e5m2 caches, head_dim 96 and non-contiguous q")


def phase_simt_geometries() -> None:
    """The CUDA-core kernels at head_dim 16 (the tiny presets), 32 and 64,
    with fp32 and bf16 q, over a cache in q's type and in e4m3: decode,
    decode-write and prefill against their plain versions."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2468)
    lens = [0, 1, 17, 300, 1000, 64]
    for dt, cdt, h, kh, hd in (
            (torch.float32, torch.float32, 8, 8, 16),
            (torch.bfloat16, torch.bfloat16, 8, 2, 16),
            (torch.float32, E4M3, 8, 8, 16),
            (torch.bfloat16, E4M3, 28, 4, 32),
            (torch.float32, E4M3, H, KH, HD),
            (torch.bfloat16, torch.bfloat16, 24, 8, 64)):
        tag = f"{str(dt)[6:]} q, {str(cdt)[6:]} cache, H={h} KH={kh} hd={hd}"
        pac.reset_launch_counts()
        q, cache, tables, kl, _ = make_case(
            gen, B=6, T=1, kv_lens=lens, dtype=dt, h=h, kh=kh, hd=hd,
            cache_dtype=cdt)
        got, ref = run_decode(q[:, 0], cache, tables, kl, 1, window=100,
                              softcap=30.0)
        compare(form("decode_simt", cdt), got, ref,
                f"decode {tag} window=100 softcap=30")
        pos = [max(n - 1, 0) for n in lens]
        pos[4] -= 5
        wf = write_slots(tables, pos, [0], cache.shape[1])
        k_new = torch.randn((6, kh * hd), generator=gen, device=DEV).to(dt)
        v_new = torch.randn((6, kh * hd), generator=gen, device=DEV).to(dt)
        if cdt == E4M3:  # row 1 reads its own write: a NaN K, edge V values
            k_new[1, 0] = -470.0
            v_new[2, :3] = torch.tensor([452.0, -460.0, 464.0])
        got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new,
                                    v_new, wf)
        if cdt == E4M3:
            got, ref, nan_rows = same_nan(got, ref, f"decode_write {tag}")
            check(nan_rows == h // kh, f"decode_write {tag}: {nan_rows} NaN "
                  f"heads, expected row 1's {h // kh}")
        compare(form("decode_write_simt", cdt), got, ref,
                f"decode_write {tag} (row 0 dropped"
                + (", row 1's K of -470 cast to NaN as by cast_e4m3"
                   if cdt == E4M3 else "") + "): caches equal;")
        q, cache, tables, kl, st = make_case(
            gen, B=2, T=70, kv_lens=[270, 70], starts=[200, 0], dtype=dt,
            h=h, kh=kh, hd=hd, cache_dtype=cdt)
        got, ref = run_prefill(q, cache, tables, kl, st, 0, window=45,
                               softcap=30.0)
        compare(form("prefill_simt", cdt), got, ref,
                f"prefill {tag} T=70 window=45 softcap=30")
        want = {k: 0 for k in pac.route_counts}
        for kind in ("decode", "decode_write", "prefill"):
            want[form(kind + "_simt", cdt)] = 1
        check(pac.route_counts == want,
              f"{tag}: routes {pac.route_counts}, expected the CUDA-core "
              "kernels")


def phase_e4m3_all_codes() -> None:
    """Decode over an e4m3 cache whose K and V bytes run through all 256
    codes (a shuffled order, over and over), at both head dims, against the
    plain version: row 0 with q = 0 (every key weighs the same, so every V
    code reaches the output), row 1 with a small q (every K code reaches a
    score), both without the two NaN codes; row 2 with them, whose heads
    must all be NaN."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(256)
    for hd, h, kh, scale, cap in ((HD, H, KH, SCALE, 0.0),
                                  (HD256, GEMMA2_HEADS["h"],
                                   GEMMA2_HEADS["kh"], HD256_SCALE,
                                   GEMMA2_HEADS["softcap"])):
        n = 777
        q, cache, tables, kl, _ = make_case(gen, B=3, T=1, kv_lens=[n] * 3,
                                            h=h, kh=kh, hd=hd,
                                            cache_dtype=E4M3)
        q3 = (q[:, 0].float() * torch.tensor([0.0, 1e-2, 1e-2], device=DEV)
              .view(3, 1, 1)).bfloat16()
        flat = raw(cache)[1]  # layer 1: [nb, 2, BS, kh * hd]
        for b in range(3):
            pages = tables[b].long()
            size = pages.numel() * flat[0].numel()
            codes = torch.randperm(256, generator=gen, device=DEV).repeat(
                -(-size // 256))[:size]
            if b < 2:
                codes[(codes == 0x7F) | (codes == 0xFF)] = 0
            flat[pages] = codes.to(torch.uint8).view(-1, *flat.shape[1:])
        got, ref = run_decode(q3, cache, tables, kl, 1, scale=scale,
                              softcap=cap)
        label = f"decode e4m3 hd={hd}, all 256 codes"
        got, ref, nan_rows = same_nan(got, ref, label)
        check(nan_rows == h, f"{label}: {nan_rows} NaN heads, expected row "
              f"2's {h}")
        compare(form("decode", E4M3, hd), got, ref,
                f"{label} (q = 0 and q ~ 1e-2 N(0, 1); row 2's {nan_rows} "
                f"heads NaN as in the plain version; "
                f"{splits_of(q, cache, tables)} splits)")


def write_slots(tables, positions, drop_rows, nb):
    """Flat write slot of each row's position (``nb * BS``: dropped)."""
    slots = [int(tables[i, p // BS]) * BS + p % BS
             for i, p in enumerate(positions)]
    for i in drop_rows:
        slots[i] = nb * BS
    return torch.tensor(slots, dtype=torch.int32, device=DEV)


@contextlib.contextmanager
def forced_splits(n: int, plans=("decode_plan", "simt_decode_plan")):
    """The wrappers' ``plans`` (by default the decodes', split-KV and
    CUDA-core) replaced by a fixed split count ``n`` inside the block."""
    saved = {name: getattr(pac, name) for name in plans}
    for name in plans:
        setattr(pac, name, lambda *a, **k: n)
    try:
        yield
    finally:
        for name, plan in saved.items():
            setattr(pac, name, plan)


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def splits_of(q, cache, tables) -> int:
    """The split count the decode wrapper's plan gives these inputs."""
    hd = q.shape[-1]
    kh = cache.shape[-1] // hd
    q3 = q.reshape(q.shape[0], -1, hd)
    route = pac.kernel_route("decode", q.dtype, cache.dtype, q3.shape[1], kh,
                             hd)
    return pac.decode_launch_splits(route, q3, cache, tables, sm_count())


def prefill_splits_of(q, cache, tables) -> int:
    """The split count the prefill wrapper's plan gives these inputs (at
    the cache's page count: ``tables`` does not enter)."""
    return pac.prefill_launch_splits("wgmma", q, cache, sm_count())


def same_nan(got, ref, label):
    """The rows a K/V value past e4m3's range turned NaN: the kernel's NaNs
    must be the plain version's. Returns both with those rows zeroed, for
    the value check of the others."""
    gn, rn = torch.isnan(got), torch.isnan(ref)
    check(torch.equal(gn, rn), f"{label}: the kernel's NaNs are not the "
          "plain version's")
    rows = rn.any(-1, keepdim=True)
    return got.masked_fill(rows, 0), ref.masked_fill(rows, 0), int(rows.sum())


def run_decode_write(q3, cache, tables, lens, layer, k_new, v_new, wf,
                     scale=SCALE, **kw):
    """Kernel and plain version, each on its own copy of the cache; the
    caches must come out bit for bit equal, and the rows must have landed."""
    got_cache, ref_cache = cache.clone(), cache.clone()
    got = pac.paged_attention_decode_write(q3, got_cache, tables, lens, layer,
                                           k_new, v_new, wf, scale=scale, **kw)
    ref = pac.paged_attention_decode_write_plain(
        q3, ref_cache, tables, lens, layer, k_new, v_new, wf, scale=scale, **kw)
    torch.cuda.synchronize()
    # Bit patterns: a cache may hold a NaN key.
    bits = functools.partial(torch.Tensor.view, dtype=torch.uint8)
    check(torch.equal(bits(got_cache), bits(ref_cache)),
          "decode_write: the kernel's cache differs from its plain version's")
    check(not torch.equal(bits(got_cache), bits(cache)),
          "decode_write: nothing written")
    return got, ref


def phase_decode_write_kernels(cache_dtype=torch.bfloat16) -> None:
    pac.reset_launch_counts()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4321)
    tag = str(cache_dtype)[6:]
    kind = form("decode_write", cache_dtype)
    case = functools.partial(make_case, cache_dtype=cache_dtype)
    # bf16 q at the decode shapes: lengths 1, 33, ~4k; row 3 drops its
    # write (and reads its cache as it was), row 2 writes 5 positions
    # before its end (the kernel reads the row back from the cache, wherever
    # it is).
    lens = [1, 33, 4096, 4000, 777, 31, 32, 100]
    q, cache, tables, kl, _ = case(gen, B=8, T=1, kv_lens=lens)
    pos = [n - 1 for n in lens]
    pos[2] -= 5
    wf = write_slots(tables, pos, [3], cache.shape[1])
    k_new = torch.randn((8, KH * HD), generator=gen, device=DEV).bfloat16()
    v_new = torch.randn((8, KH * HD), generator=gen, device=DEV).bfloat16()
    if cache_dtype == E4M3:
        # The kernel casts the rows it writes; the plain version by
        # cast_e4m3 (JAX's cast). A K value past e4m3's range is NaN: row 4
        # reads the row it writes, so its 4 heads over kv head 3 turn NaN,
        # in the kernel as in the plain version. V values at the range's
        # edge round to +-448.
        k_new[4, 3 * HD + 7] = 500.0
        v_new[1, :3] = torch.tensor([452.0, -460.0, 464.0])
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 1, k_new, v_new, wf)
    nan_rows = 0
    if cache_dtype == E4M3:
        got, ref, nan_rows = same_nan(got, ref, f"decode_write {tag}")
        check(nan_rows == H // KH,
              f"decode_write {tag}: {nan_rows} NaN heads, expected row 4's "
              f"{H // KH}")
    compare(kind, got, ref,
            f"decode_write {tag} B=8 kv_lens={lens} (row 3 dropped"
            + (", a K value of 500 -> NaN in the cache and in row 4's "
               f"{nan_rows} heads, as in the plain version"
               if nan_rows else "") + "): caches equal;")
    again = pac.paged_attention_decode_write(
        q[:, 0], cache.clone(), tables, kl, 1, k_new, v_new, wf, scale=SCALE)
    if nan_rows:
        again = again.masked_fill(torch.isnan(again).any(-1, keepdim=True), 0)
    check(torch.equal(got, again),
          "decode_write: two launches on the same inputs differ")
    # The ragged lengths of the decode checks (the kv_len 0 row drops its
    # write, row 5 writes 5 positions before its end) at every head-group
    # size with a window that starts mid-page and a softcap; one sequence
    # at 4096 with the most splits.
    lens = [0, 1, 31, 32, 33, 4096, 4000, 777]
    for h, kh in GROUP_SHAPES:
        q, cache, tables, kl, _ = case(gen, B=8, T=1, kv_lens=lens, h=h,
                                       kh=kh)
        pos = [max(n - 1, 0) for n in lens]
        pos[5] -= 5
        wf = write_slots(tables, pos, [0], cache.shape[1])
        k_new = torch.randn((8, kh * HD), generator=gen, device=DEV).bfloat16()
        v_new = torch.randn((8, kh * HD), generator=gen, device=DEV).bfloat16()
        got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new,
                                    v_new, wf, window=45, softcap=30.0)
        check(bool((got[0] == 0).all()),
              "decode_write: kv_len 0 row must be zeros")
        compare(kind, got, ref,
                f"decode_write {tag} G={h // kh} (H={h}, KH={kh}) window=45 "
                f"softcap=30 (row 0 dropped, {splits_of(q, cache, tables)} "
                "splits): caches equal;")
    q, cache, tables, kl, _ = case(gen, B=1, T=1, kv_lens=[4096])
    wf = write_slots(tables, [4095], [], cache.shape[1])
    k_new = torch.randn((1, KH * HD), generator=gen, device=DEV).bfloat16()
    v_new = torch.randn((1, KH * HD), generator=gen, device=DEV).bfloat16()
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 1, k_new, v_new, wf)
    compare(kind, got, ref,
            f"decode_write {tag} B=1 kv_len 4096 "
            f"({splits_of(q, cache, tables)} splits): caches equal;")
    check(sum(n for k, n in pac.route_counts.items() if "simt" in k) == 0,
          "a bf16 decode-write took a CUDA-core kernel")
    if cache_dtype == E4M3:
        return
    # fp32 with a window that starts mid-page and a softcap.
    lens = [50, 300, 1000, 7]
    q, cache, tables, kl, _ = make_case(gen, B=4, T=1, kv_lens=lens,
                                        dtype=torch.float32)
    wf = write_slots(tables, [n - 1 for n in lens], [1], cache.shape[1])
    k_new = torch.randn((4, KH * HD), generator=gen, device=DEV)
    v_new = torch.randn((4, KH * HD), generator=gen, device=DEV)
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new, v_new,
                                wf, window=100, softcap=30.0)
    compare("decode_write_simt", got, ref,
            "decode_write fp32 window=100 softcap=30 (row 1 dropped): caches "
            "equal;")


def phase_hd256_kernels(cache_dtype=torch.bfloat16) -> None:
    """The split-KV decode, decode-write and wgmma prefill kernels at
    head_dim 256, bf16 q over a ``cache_dtype`` cache, against their plain
    versions: at gemma2-9b's heads and at gemma-7b's, over ragged lengths
    (0 to 4096), one sequence of 4096, a window of 4096 at kv_len 5000
    (starting mid-page), every head group G 1 to 8 at a small B, the
    decode-write's caches bit for bit and two launches bit for bit; the
    prefill where each q-tile's keys take more than one split (B=1 and 3),
    with a window that starts inside a q-tile's second run, ragged T,
    mixed starts and a NaN key, each launched twice, bit for bit; with
    negative controls. With a bf16 cache also the CUDA-core kernels at
    head_dim 256 in fp32, over fp32 and e4m3 caches, at 1e-4."""
    pac.reset_launch_counts()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2560)
    tag = f"{str(cache_dtype)[6:]} hd256"
    dec, dw, pre = (form(k, cache_dtype, HD256)
                    for k in ("decode", "decode_write", "prefill"))
    case = functools.partial(make_case, cache_dtype=cache_dtype, hd=HD256)
    sc = HD256_SCALE
    g2 = dict(h=GEMMA2_HEADS["h"], kh=GEMMA2_HEADS["kh"])
    cap = GEMMA2_HEADS["softcap"]

    # Decode: ragged lengths at both presets' heads.
    lens = [0, 1, 31, 32, 33, 4096, 4000, 777]
    for name, heads in ((GEMMA, GEMMA2_HEADS), ("gemma-7b", GEMMA1_HEADS)):
        q, cache, tables, kl, _ = case(gen, B=8, T=1, kv_lens=lens,
                                       h=heads["h"], kh=heads["kh"])
        got, ref = run_decode(q[:, 0], cache, tables, kl, 1, scale=sc,
                              softcap=heads["softcap"])
        check(bool((got[0] == 0).all()), "decode: kv_len 0 row must be zeros")
        compare(dec, got, ref, f"decode {tag} {name}'s heads B=8 "
                f"kv_lens={lens} ({splits_of(q, cache, tables)} splits)")
    # The check has teeth: a decode that drops the last of 4096/4000 keys.
    wrong = pac.paged_attention_decode_plain(q[:, 0], cache, tables, kl - 1,
                                             1, scale=sc)
    ok, ratio, _ = bf16_row_check(wrong[5:7], ref[5:7])
    log(f"  a {tag} decode that drops the last of 4096/4000 keys: worst err "
        f"/ row tol {ratio:.3f}")
    check(not ok, f"the row check passes a {tag} decode that drops a key")
    check(torch.equal(got, pac.paged_attention_decode(
        q[:, 0], cache, tables, kl, 1, scale=sc)),
        "decode hd256: two launches on the same inputs differ")
    q, cache, tables, kl, _ = case(gen, B=1, T=1, kv_lens=[4096], **g2)
    got, ref = run_decode(q[:, 0], cache, tables, kl, 1, scale=sc,
                          softcap=cap)
    compare(dec, got, ref, f"decode {tag} B=1 kv_len 4096 "
            f"({splits_of(q, cache, tables)} splits)")
    # gemma2-9b's local layers: a window of 4096 at kv_len 5000 starts at
    # key 904, mid-page.
    q, cache, tables, kl, _ = case(gen, B=2, T=1, kv_lens=[5000, 4500], **g2)
    got, ref = run_decode(q[:, 0], cache, tables, kl, 0, scale=sc,
                          window=4096, softcap=cap)
    compare(dec, got, ref, f"decode {tag} kv_lens=[5000, 4500] window=4096 "
            f"softcap=50 ({splits_of(q, cache, tables)} splits)")
    small = [0, 33, 300, 1000]
    for h, kh in GROUP_SHAPES:
        q, cache, tables, kl, _ = case(gen, B=4, T=1, kv_lens=small, h=h,
                                       kh=kh)
        got, ref = run_decode(q[:, 0], cache, tables, kl, 0, scale=sc,
                              window=45, softcap=30.0)
        check(bool((got[0] == 0).all()), "decode: kv_len 0 row must be zeros")
        compare(dec, got, ref, f"decode {tag} G={h // kh} (H={h}, KH={kh}) "
                f"window=45 softcap=30 ({splits_of(q, cache, tables)} splits)")

    # Decode-write: row 2 writes 5 positions before its end, row 3 drops
    # its write; over e4m3 a K value of 500 turns row 4's heads over kv
    # head 3 NaN (as JAX's cast writes), V values at the range's edge round
    # to +-448.
    lens = [1, 33, 4096, 4000, 777, 31, 32, 100]
    q, cache, tables, kl, _ = case(gen, B=8, T=1, kv_lens=lens, **g2)
    pos = [n - 1 for n in lens]
    pos[2] -= 5
    wf = write_slots(tables, pos, [3], cache.shape[1])
    lanes = g2["kh"] * HD256
    k_new = torch.randn((8, lanes), generator=gen, device=DEV).bfloat16()
    v_new = torch.randn((8, lanes), generator=gen, device=DEV).bfloat16()
    if cache_dtype == E4M3:
        k_new[4, 3 * HD256 + 7] = 500.0
        v_new[1, :3] = torch.tensor([452.0, -460.0, 464.0])
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 1, k_new, v_new,
                                wf, scale=sc, softcap=cap)
    nan_rows = 0
    if cache_dtype == E4M3:
        got, ref, nan_rows = same_nan(got, ref, f"decode_write {tag}")
        check(nan_rows == g2["h"] // g2["kh"],
              f"decode_write {tag}: {nan_rows} NaN heads, expected 2")
    compare(dw, got, ref, f"decode_write {tag} B=8 kv_lens={lens} (row 3 "
            "dropped, row 2 five before its end"
            + (f", a K of 500 -> NaN in row 4's {nan_rows} heads"
               if nan_rows else "") + "): caches equal;")
    again = pac.paged_attention_decode_write(
        q[:, 0], cache.clone(), tables, kl, 1, k_new, v_new, wf, scale=sc,
        softcap=cap)
    if nan_rows:
        again = again.masked_fill(torch.isnan(again).any(-1, keepdim=True), 0)
    check(torch.equal(got, again),
          "decode_write hd256: two launches on the same inputs differ")
    q, cache, tables, kl, _ = case(gen, B=2, T=1, kv_lens=[5000, 4096], **g2)
    wf = write_slots(tables, [4999, 4095], [], cache.shape[1])
    k_new = torch.randn((2, lanes), generator=gen, device=DEV).bfloat16()
    v_new = torch.randn((2, lanes), generator=gen, device=DEV).bfloat16()
    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new, v_new,
                                wf, scale=sc, window=4096, softcap=cap)
    compare(dw, got, ref, f"decode_write {tag} kv_lens=[5000, 4096] "
            "window=4096: caches equal;")
    for h, kh in GROUP_SHAPES:
        q, cache, tables, kl, _ = case(gen, B=4, T=1, kv_lens=small, h=h,
                                       kh=kh)
        pos = [max(n - 1, 0) for n in small]
        pos[3] -= 5
        wf = write_slots(tables, pos, [0], cache.shape[1])
        k_new = torch.randn((4, kh * HD256), generator=gen,
                            device=DEV).bfloat16()
        v_new = torch.randn((4, kh * HD256), generator=gen,
                            device=DEV).bfloat16()
        got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new,
                                    v_new, wf, scale=sc, window=45,
                                    softcap=30.0)
        compare(dw, got, ref, f"decode_write {tag} G={h // kh} (H={h}, "
                f"KH={kh}) window=45 softcap=30 (row 0 dropped): caches "
                "equal;")

    # Prefill: a ragged T, T=2048 fresh, T=512 at 3584, and T=512 at 4488
    # under a window of 4096 (row 0's first key 393, mid-page).
    for T, start, window in ((300, 77, 0), (2048, 0, 0), (512, 3584, 0),
                             (512, 4488, 4096)):
        q, cache, tables, kl, st = case(
            gen, B=2, T=T, kv_lens=[start + T] * 2, starts=[start] * 2, **g2)
        got, ref = run_prefill(q, cache, tables, kl, st, 1, scale=sc,
                               window=window, softcap=cap)
        compare(pre, got, ref, f"prefill {tag} B=2 T={T} start={start} "
                f"window={window} softcap=50")
        if T == 2048:
            # The check has teeth: every row one position earlier (its
            # last key dropped) fails it, on the rows that keep a key.
            wrong = pac.paged_attention_prefill_plain(
                q, cache, tables, kl, st - 1, 1, scale=sc, softcap=cap)
            ok, ratio, _ = bf16_row_check(got[:, 1:], wrong[:, 1:])
            log(f"  a {tag} prefill whose rows each miss their last key: "
                f"worst err / row tol {ratio:.3f}")
            check(not ok, "the row check passes a prefill that drops a key")
    # Prefill with each q-tile's keys in more than one split (the plan's
    # S at B=1 and 3): continuing 512-token chunks at 3584 whose window of
    # 45 starts, for a q-tile's last rows, inside its second run (so the
    # first run holds no key of theirs), fresh chunks, a ragged T=509 and
    # three sequences at mixed starts with a kv_len 0 row, at gemma2-9b's
    # heads (G 2) and gemma-7b's (G 1); each launched twice, bit for bit.
    g1 = dict(h=GEMMA1_HEADS["h"], kh=GEMMA1_HEADS["kh"])
    for name, heads, cap_, T, starts, lens, window in (
            (GEMMA, g2, cap, 512, [3584], [4096], 45),
            (GEMMA, g2, cap, 512, [0], [512], 0),
            (GEMMA, g2, cap, 509, [0], [509], 0),
            ("gemma-7b", g1, 0.0, 512, [3584], [4096], 45),
            ("gemma-7b", g1, 0.0, 512, [0], [512], 0),
            (GEMMA, g2, cap, 100, [0, 300, 1000], [100, 0, 1100], 0),
            ("gemma-7b", g1, 0.0, 100, [0, 300, 1000], [100, 0, 1100], 0)):
        q, cache, tables, kl, st = case(gen, B=len(lens), T=T, kv_lens=lens,
                                        starts=starts, **heads)
        kw = dict(scale=sc, window=window, softcap=cap_)
        got, ref = run_prefill(q, cache, tables, kl, st, 1, **kw)
        splits = prefill_splits_of(q, cache, tables)
        check(splits > 1, f"prefill {tag}: {splits} split at B={len(lens)} "
              f"T={T}")
        if 0 in lens:
            check(bool((got[lens.index(0)] == 0).all()),
                  "prefill: kv_len 0 rows must be zeros")
        compare(pre, got, ref, f"prefill {tag} {name}'s heads B={len(lens)} "
                f"T={T} starts={starts} kv_lens={lens} window={window} "
                f"softcap={cap_:g} ({splits} splits)")
        again = pac.paged_attention_prefill(q, cache, tables, kl, st, 1, **kw)
        check(torch.equal(got.view(torch.int16), again.view(torch.int16)),
              f"prefill {tag}: two launches on the same inputs differ")
    # A NaN key (over e4m3 a K value of 500, as JAX's cast writes it) at
    # position 3884 of kv head 3, inside the second run of the q-tiles that
    # reach it: every row at or past it in heads 6 and 7 must be NaN, the
    # others as the plain version's.
    q, cache, tables, kl, st = case(gen, B=1, T=512, kv_lens=[4096],
                                    starts=[3584], **g2)
    bad = to_cache_dtype(torch.tensor(
        [500.0 if cache_dtype == E4M3 else float("nan")], device=DEV),
        cache_dtype)
    raw(cache)[1, int(tables[0, 3884 // BS]), 0, 3884 % BS,
               3 * HD256 + 7] = raw(bad)[0]
    got, ref = run_prefill(q, cache, tables, kl, st, 1, scale=sc, softcap=cap)
    again = pac.paged_attention_prefill(q, cache, tables, kl, st, 1, scale=sc,
                                        softcap=cap)
    check(torch.equal(got.view(torch.int16), again.view(torch.int16)),
          f"prefill {tag}: two launches with a NaN key differ")
    got, ref, nan_rows = same_nan(got, ref, f"prefill {tag}")
    check(nan_rows == 2 * (4096 - 3884),
          f"prefill {tag}: {nan_rows} NaN rows, expected {2 * (4096 - 3884)}")
    compare(pre, got, ref, f"prefill {tag} B=1 T=512 start=3584, a NaN K at "
            f"3884 -> NaN in {nan_rows} rows ({prefill_splits_of(q, cache, tables)}"
            " splits)")
    for h, kh in GROUP_SHAPES:
        q, cache, tables, kl, st = case(
            gen, B=2, T=70, kv_lens=[270, 70], starts=[200, 0], h=h, kh=kh)
        got, ref = run_prefill(q, cache, tables, kl, st, 0, scale=sc,
                               window=45, softcap=30.0)
        compare(pre, got, ref, f"prefill {tag} G={h // kh} (H={h}, KH={kh}) "
                "T=70 window=45 softcap=30")
    hd256 = sum(n for k, n in pac.route_counts.items() if k.endswith("_hd256"))
    check(hd256 > 0 and hd256 == sum(pac.route_counts.values()),
          f"hd256 checks took other kernels: {pac.route_counts}")
    if cache_dtype == E4M3:
        return

    # fp32 q at head_dim 256: the CUDA-core kernels, over fp32 and e4m3.
    for cdt in (torch.float32, E4M3):
        ctag = f"fp32 q, {str(cdt)[6:]} cache, hd256"
        q, cache, tables, kl, _ = make_case(
            gen, B=4, T=1, kv_lens=[0, 50, 300, 1000], dtype=torch.float32,
            hd=HD256, cache_dtype=cdt, **g2)
        got, ref = run_decode(q[:, 0], cache, tables, kl, 0, scale=sc,
                              window=100, softcap=cap)
        compare(form("decode_simt", cdt), got, ref,
                f"decode {ctag} window=100 softcap=50")
        wf = write_slots(tables, [0, 49, 299, 994], [0], cache.shape[1])
        k_new = torch.randn((4, lanes), generator=gen, device=DEV)
        v_new = torch.randn((4, lanes), generator=gen, device=DEV)
        got, ref = run_decode_write(q[:, 0], cache, tables, kl, 0, k_new,
                                    v_new, wf, scale=sc, window=100,
                                    softcap=cap)
        compare(form("decode_write_simt", cdt), got, ref,
                f"decode_write {ctag} window=100 (row 0 dropped): caches "
                "equal;")
        q, cache, tables, kl, st = make_case(
            gen, B=2, T=70, kv_lens=[270, 70], starts=[200, 0],
            dtype=torch.float32, hd=HD256, cache_dtype=cdt, **g2)
        got, ref = run_prefill(q, cache, tables, kl, st, 0, scale=sc,
                               window=45, softcap=cap)
        compare(form("prefill_simt", cdt), got, ref,
                f"prefill {ctag} T=70 window=45 softcap=50")
    check(pac.route_counts["decode_simt_hd256"] > 0
          and pac.route_counts["prefill_simt_e4m3_hd256"] > 0,
          f"fp32 hd256 routes {pac.route_counts}")


def phase_hd256_splits() -> None:
    """The bf16 head_dim-256 split-KV decode and decode-write (a warp owns
    8 keys of a tile and all 256 dims of Oᵀ) at G 1 (gemma-7b's heads), 2
    (gemma2-9b's) and 8, each at the split count its plan picks and at one
    more forced: ragged kv_lens with a kv_len 0 row, a window of 1000, the
    softcap of 50 and a NaN key (the heads of its kv head NaN in that row,
    as in the plain version); two launches bit for bit, and the
    decode-write's cache bit for bit against the plain write."""
    pac.reset_launch_counts()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2561)
    lens = [0, 1, 33, 777, 4000, 4096, 2500, 64]
    sc, cap, window = HD256_SCALE, GEMMA2_HEADS["softcap"], 1000
    for name, h, kh in (("gemma-7b", 16, 16), (GEMMA, 16, 8), ("G 8", 64, 8)):
        G = h // kh
        q, cache, tables, kl, _ = make_case(gen, B=8, T=1, kv_lens=lens, h=h,
                                            kh=kh, hd=HD256)
        # A NaN K value at position 3700 of row 4 (kv_len 4000, inside its
        # window), kv head kh - 1.
        raw(cache)[1, int(tables[4, 3700 // BS]), 0, 3700 % BS,
                   (kh - 1) * HD256 + 7] = raw(torch.tensor(
                       [float("nan")], device=DEV).bfloat16())[0]
        pos = [max(n - 1, 0) for n in lens]
        pos[5] -= 5
        wf = write_slots(tables, pos, [0], cache.shape[1])
        k_new = torch.randn((8, kh * HD256), generator=gen,
                            device=DEV).bfloat16()
        v_new = torch.randn((8, kh * HD256), generator=gen,
                            device=DEV).bfloat16()
        kw = dict(scale=sc, window=window, softcap=cap)
        planned = splits_of(q, cache, tables)
        for forced in (None, planned + 3):
            with (forced_splits(forced) if forced
                  else contextlib.nullcontext()):
                splits = splits_of(q, cache, tables)
                label = (f"bf16 hd256 {name}'s heads (G {G}) B=8 "
                         f"kv_lens={lens} window={window} softcap=50, "
                         f"{splits} splits" + (" (forced)" if forced else ""))
                got, ref = run_decode(q[:, 0], cache, tables, kl, 1, **kw)
                again = pac.paged_attention_decode(q[:, 0], cache, tables, kl,
                                                   1, **kw)
                check(torch.equal(got.view(torch.int16),
                                  again.view(torch.int16)),
                      f"decode {label}: two launches differ")
                check(bool((got[0] == 0).all()),
                      "decode: kv_len 0 row must be zeros")
                got, ref, nan_rows = same_nan(got, ref, f"decode {label}")
                check(nan_rows == G, f"decode {label}: {nan_rows} NaN heads, "
                      f"expected {G}")
                compare("decode_hd256", got, ref, f"decode {label}, a NaN key "
                        f"-> {nan_rows} NaN heads as in the plain version")
                got, ref = run_decode_write(q[:, 0], cache, tables, kl, 1,
                                            k_new, v_new, wf, **kw)
                again = pac.paged_attention_decode_write(
                    q[:, 0], cache.clone(), tables, kl, 1, k_new, v_new, wf,
                    **kw)
                check(torch.equal(got.view(torch.int16),
                                  again.view(torch.int16)),
                      f"decode_write {label}: two launches differ")
                got, ref, nan_rows = same_nan(got, ref,
                                              f"decode_write {label}")
                check(nan_rows == G, f"decode_write {label}: {nan_rows} NaN "
                      f"heads, expected {G}")
                compare("decode_write_hd256", got, ref,
                        f"decode_write {label} (row 0 dropped, row 5 five "
                        "before its end): caches equal;")
    want = pac.route_counts["decode_split_hd256"] + pac.route_counts[
        "decode_write_split_hd256"]
    check(want > 0 and want == sum(pac.route_counts.values()),
          f"bf16 hd256 split checks took other kernels: {pac.route_counts}")


# The CUDA-core decode's head dims and q types: fp32 q at every head dim,
# bf16 q up to 64 (bf16 q at 128 and 256 takes the split-KV kernel).
SIMT_GEOMETRIES = ((torch.float32, 8, 8, 16), (torch.bfloat16, 8, 2, 16),
                   (torch.float32, 28, 4, 32), (torch.bfloat16, 28, 4, 32),
                   (torch.float32, 24, 8, 64), (torch.bfloat16, 24, 8, 64),
                   (torch.float32, H, KH, HD),
                   (torch.float32, 16, 8, HD256))


def phase_simt_splits() -> None:
    """The CUDA-core decode and decode-write over splits of each row's keys
    (S > 1, merged in the launch) at every head dim and q type they serve,
    over a cache in q's type and in e4m3: at the split count the plan picks
    and at 1 and 3 forced; a kv_len 0 row, ragged lengths,
    a window of 300 and a softcap; two launches bit for bit; the
    decode-write's cache bit for bit against the plain write, with a write
    5 before a row's end and a dropped write."""
    pac.reset_launch_counts()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1357)
    lens = [0, 50, 1000, 777]
    for dt, h, kh, hd in SIMT_GEOMETRIES:
        for cdt in (dt, E4M3):
            tag = (f"{str(dt)[6:]} q, {str(cdt)[6:]} cache, H={h} KH={kh} "
                   f"hd={hd}")
            q, cache, tables, kl, _ = make_case(
                gen, B=4, T=1, kv_lens=lens, dtype=dt, h=h, kh=kh, hd=hd,
                cache_dtype=cdt)
            pos = [max(n - 1, 0) for n in lens]
            pos[2] -= 5
            wf = write_slots(tables, pos, [0], cache.shape[1])
            k_new = torch.randn((4, kh * hd), generator=gen, device=DEV).to(dt)
            v_new = torch.randn((4, kh * hd), generator=gen, device=DEV).to(dt)
            kw = dict(window=300, softcap=30.0)
            for forced in (None, 1, 3):
                with (forced_splits(forced) if forced
                      else contextlib.nullcontext()):
                    splits = splits_of(q, cache, tables)
                    label = (f"{tag} window=300 softcap=30, {splits} splits"
                             + (" (forced)" if forced else ""))
                    got, ref = run_decode(q[:, 0], cache, tables, kl, 1, **kw)
                    check(bool((got[0] == 0).all()),
                          "decode: kv_len 0 row must be zeros")
                    compare(form("decode_simt", cdt), got, ref,
                            f"decode {label}")
                    check(torch.equal(got, pac.paged_attention_decode(
                        q[:, 0], cache, tables, kl, 1, scale=SCALE, **kw)),
                          f"decode {label}: two launches differ")
                    got, ref = run_decode_write(q[:, 0], cache, tables, kl, 1,
                                                k_new, v_new, wf, **kw)
                    compare(form("decode_write_simt", cdt), got, ref,
                            f"decode_write {label} (row 0 dropped): caches "
                            "equal;")
                    check(torch.equal(got, pac.paged_attention_decode_write(
                        q[:, 0], cache.clone(), tables, kl, 1, k_new, v_new,
                        wf, scale=SCALE, **kw)),
                          f"decode_write {label}: two launches differ")
    simt = sum(n for k, n in pac.route_counts.items() if "simt" in k)
    check(simt > 0 and simt == sum(pac.route_counts.values()),
          f"CUDA-core split checks took other kernels: {pac.route_counts}")


def simt_prefill_splits_of(q, cache, tables) -> int:
    """The split count the CUDA-core prefill's plan gives these inputs (at
    the cache's page count: ``tables`` does not enter)."""
    return pac.prefill_launch_splits("simt", q, cache, sm_count())


def phase_simt_prefill_splits() -> None:
    """The CUDA-core prefill over splits of each q-tile's keys (S > 1,
    merged in the launch) at every head dim and q type it serves, over a
    cache in q's type and in e4m3: at the split count the plan picks and at
    1 and 3 forced; a chunk continuing at 700 (two q-tiles at G = 1, the
    second ragged), a kv_len 0 row and a fresh chunk shorter than T, a
    window of 300 and a softcap; two launches bit for bit."""
    pac.reset_launch_counts()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2024)
    T, starts, lens = 150, [700, 0, 0], [850, 0, 141]
    for dt, h, kh, hd in SIMT_GEOMETRIES:
        for cdt in (dt, E4M3):
            tag = (f"{str(dt)[6:]} q, {str(cdt)[6:]} cache, H={h} KH={kh} "
                   f"hd={hd}")
            q, cache, tables, kl, st = make_case(
                gen, B=3, T=T, kv_lens=lens, starts=starts, dtype=dt, h=h,
                kh=kh, hd=hd, cache_dtype=cdt)
            kw = dict(window=300, softcap=30.0)
            for forced in (None, 1, 3):
                with (forced_splits(forced, ("simt_prefill_plan",)) if forced
                      else contextlib.nullcontext()):
                    splits = simt_prefill_splits_of(q, cache, tables)
                    label = (f"prefill {tag} T={T} window=300 softcap=30, "
                             f"{splits} splits" + (" (forced)" if forced
                                                   else ""))
                    got, ref = run_prefill(q, cache, tables, kl, st, 1, **kw)
                    check(bool((got[1] == 0).all()),
                          "prefill: kv_len 0 row must be zeros")
                    compare(form("prefill_simt", cdt), got, ref, label)
                    check(torch.equal(got, pac.paged_attention_prefill(
                        q, cache, tables, kl, st, 1, scale=SCALE, **kw)),
                          f"{label}: two launches differ")
    simt = sum(n for k, n in pac.route_counts.items()
               if k.startswith("prefill_simt"))
    check(simt > 0 and simt == sum(pac.route_counts.values()),
          f"CUDA-core prefill split checks took other kernels: "
          f"{pac.route_counts}")


# Phase 2s: the prefill kernels at the speculative verify step's shapes.
# A verify step under --speculative-ngram 4 scores K + 1 = 5 positions a
# row; the engine's row buckets run to 64.
VERIFY_T = 5
VERIFY_GEOS = (
    ("wgmma", "Llama-3-8B heads", dict(h=H, kh=KH, hd=HD), SCALE, 0.0),
    ("wgmma", "gemma2-9b heads", dict(h=GEMMA2_HEADS["h"],
                                      kh=GEMMA2_HEADS["kh"], hd=HD256),
     HD256_SCALE, GEMMA2_HEADS["softcap"]),
    ("simt", "tiny-llama-debug heads, fp32 q", dict(h=8, kh=8, hd=16),
     16 ** -0.5, 0.0),
)


def verify_rows(B: int, ctx: int) -> tuple:
    """(kv_lens, starts) of B verify rows at context ``ctx``: each row's 5
    positions end at ``ctx`` - 1, except that with B > 1 every fourth row
    from the second has kv_len ``ctx`` - 3 (a draftless row short of
    pages: its last three positions lie past its keys) and every fourth
    from the fourth is padding (kv_len 0 at start 0)."""
    lens, starts = [], []
    for i in range(B):
        kind = i % 4 if B > 1 else 0
        lens.append(0 if kind == 3 else ctx - 3 if kind == 1 else ctx)
        starts.append(0 if kind == 3 else ctx - VERIFY_T)
    return lens, starts


def phase_verify_kernels() -> dict:
    """Phase 2s: the prefill kernels at the verify step's shapes, B = 1, 8
    and 64 rows of T = 5 at contexts 512 and 4096 (``verify_rows``: rows
    short of their keys, padding rows), against their plain versions: the
    wgmma kernel at Llama-3-8B's and gemma2-9b's heads (its softcap of
    50) over bf16 and e4m3 caches, the CUDA-core kernel at the tiny
    presets' heads in fp32 over fp32 and e4m3; a window of 1000 at 4096.
    Every launch is repeated over the same block table padded to 64 more
    columns, bit for bit: a row's split count, and so its rounding, does
    not follow the table's width. Returns the split counts by shape."""
    log("[phase 2s] prefill kernels at the verify step's shapes "
        f"(T={VERIFY_T})")
    pac.reset_launch_counts()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(4321)
    splits = {}
    for route, name, heads, scale, cap in VERIFY_GEOS:
        dt = torch.float32 if route == "simt" else torch.bfloat16
        kind = "prefill_simt" if route == "simt" else "prefill"
        for cdt in (dt, E4M3):
            for B in (1, 8, 64):
                for ctx in (512, 4096):
                    lens, starts = verify_rows(B, ctx)
                    q, cache, tables, kl, st = make_case(
                        gen, B=B, T=VERIFY_T, kv_lens=lens, starts=starts,
                        dtype=dt, cache_dtype=cdt, **heads)
                    kw = dict(scale=scale, softcap=cap,
                              window=1000 if ctx == 4096 else 0)
                    got, ref = run_prefill(q, cache, tables, kl, st, 1, **kw)
                    pad = [i for i, n in enumerate(lens) if n == 0]
                    check(bool((got[pad] == 0).all()),
                          "verify: kv_len 0 rows must be zeros")
                    n = pac.prefill_launch_splits(route, q, cache,
                                                  sm_count())
                    compare(form(kind, cdt, heads["hd"]), got, ref,
                            f"verify {route} {name}, {str(cdt)[6:]} cache, "
                            f"B={B} x T={VERIFY_T} at {ctx}, window "
                            f"{kw['window']} ({n} splits)")
                    wide = torch.cat([tables, torch.zeros(
                        (B, 64), dtype=torch.int32, device=DEV)], 1)
                    again = pac.paged_attention_prefill(
                        q, cache, wide.contiguous(), kl, st, 1, **kw)
                    check(same_bits(got, again),
                          f"verify B={B} at {ctx}: a table 64 columns wider "
                          "changed the output")
                    splits[f"{route} hd{heads['hd']} {str(cdt)[6:]} "
                           f"B={B} ctx={ctx}"] = n
                    del q, cache, tables, got, ref, again
                    torch.cuda.empty_cache()
    wg = sum(n for k, n in pac.route_counts.items()
             if k.startswith("prefill_wgmma"))
    simt = sum(n for k, n in pac.route_counts.items()
               if k.startswith("prefill_simt"))
    check(wg > 0 and simt > 0 and wg + simt == sum(pac.route_counts.values()),
          f"verify shapes took other kernels: {pac.route_counts}")
    log(f"  split counts (planned at the cache's pages, equal over a wider "
        f"table): {splits}")
    return splits


# The seeds of the seeded-draw checks: the JAX sampler's draw is checked
# against jax.random on the CPU by tests/test_torch_seeded_draw.py.
DRAW_SEEDS = (0, 1, 7, 12345, 2**31 - 1, 2**31, 2**31 + 2)


def phase_device_draw() -> None:
    """The sampler's seeded draw on the card against the same code on the
    CPU: threefry2x32's 32-bit words and the uniforms built from them bit
    for bit, the Gumbel values (two ``log`` implementations) within 1e-6;
    then ``sample_tokens`` on seeded logits gives the CPU's tokens."""
    seeds = torch.tensor(DRAW_SEEDS, dtype=torch.int64)
    for k in (256, 300):
        got = sampler.threefry_bits(seeds.to(DEV), k).cpu()
        want = sampler.threefry_bits(seeds, k)
        check(torch.equal(got, want), f"threefry words, K={k}: the card's "
              "differ from the CPU's")
        g_dev = sampler.gumbel_noise(seeds.to(DEV), k).cpu()
        g_cpu = sampler.gumbel_noise(seeds, k)
        err = float((g_dev - g_cpu).abs().max())
        log(f"  seeded draw K={k}, seeds {list(DRAW_SEEDS)}: words bit for "
            f"bit; Gumbel max|card - CPU| {err:.3e} "
            f"({int((g_dev != g_cpu).sum())} of {g_dev.numel()} differ; tol "
            "1e-6)")
        check(err <= 1e-6, f"Gumbel draw, K={k}: the card's differ")
    gen = torch.Generator()
    gen.manual_seed(11)
    B, V = len(DRAW_SEEDS), 4096
    logits = torch.randn((B, V), generator=gen) * 3
    args = (torch.full((B,), 0.8), torch.full((B,), 0.95),
            torch.full((B,), 50, dtype=torch.int32), torch.full((B,), 0.02),
            seeds)
    want = sampler.sample_tokens(logits, *args)
    got = sampler.sample_tokens(logits.to(DEV),
                                 *(a.to(DEV) for a in args)).cpu()
    check(torch.equal(got, want), f"sampled tokens: card {got.tolist()} "
          f"against CPU {want.tolist()}")
    log(f"  sample_tokens on the card = on the CPU: {got.tolist()}")


def int4_case(gen, N, din, dout, dtype=torch.bfloat16):
    """x [N, din] and a random [din, dout] weight quantized on the card."""
    w = torch.randn((din, dout), generator=gen, device=DEV) * 0.02
    packed, scales = quantize_leaf_int4(w)
    x = torch.randn((N, din), generator=gen, device=DEV).to(dtype)
    return x, packed, scales


def int4_weights(gen, din, dout, G=None, offset=0):
    """packed [din/2, dout] and scales: quantized from a random weight, or
    (G given) random bytes and scales at group size G; ``offset`` bytes
    into their buffer, so the packed pointer is unaligned."""
    if G is None:
        w = torch.randn((din, dout), generator=gen, device=DEV) * 0.02
        packed, scales = quantize_leaf_int4(w)
    else:
        packed = torch.randint(-128, 128, (din // 2, dout), generator=gen,
                               device=DEV, dtype=torch.int8)
        scales = torch.rand((din // G, dout), generator=gen, device=DEV) * 0.01
    if offset:
        buf = torch.empty(packed.numel() + offset, dtype=torch.int8, device=DEV)
        packed = buf[offset:].view(packed.shape).copy_(packed)
    return packed, scales


def int4_check(x, packed, scales, label, want_route):
    route = i4.route(x, packed, scales)
    check(route == want_route, f"{label}: route {route}, expected {want_route}")
    got = i4.int4_matmul(x, packed, scales)
    ref = i4.int4_matmul_plain(x, packed, scales)
    torch.cuda.synchronize()
    N, dout = x.shape[0], packed.shape[1]
    check(got.dtype == torch.float32 and got.shape == (N, dout),
          f"int4: output {got.dtype} {tuple(got.shape)}")
    err = compare("int4_wgmma" if route == "wgmma" else "int4", got, ref,
                  f"{label} ({route})", rows=True)
    return err, bf16_row_check(got, ref)[1]


def phase_int4_kernels() -> None:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(777)
    # bf16 (tensor-core routes): every projection shape at decode rows (1, 2
    # and every bucket up to the decode route's boundary) and at 17, 64,
    # 300, 512 and 2048 rows (the wgmma kernel above the boundary).
    edge = i4._DECODE_MAX_ROWS
    decode_rows = sorted({1, 2, 8, 16} | {b for b in DECODE_BUCKETS if b <= edge})
    for din, dout in INT4_SHAPES:
        packed, scales = int4_weights(gen, din, dout)
        for N in decode_rows + [17, 64, 300, 512, 2048]:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            int4_check(x, packed, scales, f"int4 bf16 N={N} din={din} dout={dout}",
                       "decode" if N <= edge else "wgmma")
    # The decode route's other calls: a ragged dout (208: both routes), an
    # odd dout and a group of 48 (wgmma refuses both, at any N), unaligned x
    # and packed pointers (wgmma needs 16 bytes).
    for din, dout, G, rows, poff, xoff in (
            (256, 208, None, (1, 8, 16, 40, 300), 0, 0),
            (256, 201, None, (3, 8, 16, 40), 0, 0),
            (4608, 256, 48, (8, 40, 300), 0, 0),
            (1024, 256, None, (8, 40), 1, 1)):
        packed, scales = int4_weights(gen, din, dout, G, poff)
        for N in rows:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            if xoff:
                buf = torch.empty(x.numel() + xoff, dtype=torch.bfloat16, device=DEV)
                x = buf[xoff:].view(x.shape).copy_(x)
            tag = f" G={G}" if G else ""
            tag += " unaligned x, packed" if xoff else ""
            wgmma_ok = (dout % 16 == 0 and G is None and not xoff and N > edge)
            int4_check(x, packed, scales,
                       f"int4 bf16 N={N} din={din} dout={dout}{tag}",
                       "wgmma" if wgmma_ok else "decode")
    # Determinism (the splits add up in split order) and the resident
    # blocks the plan counts on.
    for din, dout in INT4_SHAPES:
        packed, scales = int4_weights(gen, din, dout)
        for N in (1, 8, 16):
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            a = i4.int4_matmul(x, packed, scales)
            b = i4.int4_matmul(x, packed, scales)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"int4 decode N={N} {din}x{dout}: two "
                  "launches differ")
            nt, mt = i4.decode_tile(N, din, dout, 128)
            p = i4.plan("decode", N, din, dout, 128)
            held = i4.decode_occupancy(nt, mt, p.per_split)
            want = i4._DECODE_BLOCKS_PER_SM[(nt, mt)]
            check(held >= want, f"int4 decode ({nt}, {mt}): an SM holds {held} "
                  f"blocks, the plan counts on {want}")
            log(f"  int4 decode N={N} {din}x{dout}: tile ({nt}, {mt}), grid "
                f"{p.grid}, {p.per_split} groups a split; an SM holds {held} "
                f"blocks (plan: {want}); two launches bit for bit equal")
    # The check has teeth on both routes: the kernel's product against a
    # plain version with the two nibble planes of every byte swapped fails.
    x64 = torch.randn((64, 4096), generator=gen, device=DEV).bfloat16()
    _, packed, scales = int4_case(gen, 1, 4096, 4096)
    swapped = torch.bitwise_left_shift(packed, 4) | ((packed >> 4) & 0x0F)
    for x in (x64[:8].contiguous(), x64):
        got = i4.int4_matmul(x, packed, scales)
        ok, ratio, _ = bf16_row_check(got, i4.int4_matmul_plain(x, swapped,
                                                                scales))
        log(f"  int4 N={x.shape[0]} ({i4.route(x, packed, scales)}) against a "
            f"product with swapped nibble planes: worst err / row tol "
            f"{ratio:.3f}")
        check(not ok, "the int4 row check passes swapped nibbles")

    # fp32 (CUDA-core route) against the float64 product: 128-row groups,
    # and a group-16 tiny shape; bf16 with group 8 and a ragged dout takes
    # the CUDA-core route too.
    # The tiny engine's w_gate (one group: 32 blocks of 8 columns), a split
    # over a cluster of blocks, ragged rows and columns, 512 groups of 8,
    # and a Llama projection in fp32; two launches bit for bit.
    for N, din, dout, dtype, G in ((8, 128, 256, torch.float32, None),
                                   (5, 1024, 256, torch.float32, None),
                                   (3, 48, 16, torch.float32, None),
                                   (3, 24, 40, torch.bfloat16, None),
                                   (11, 4096, 37, torch.bfloat16, 8),
                                   (8, 4096, 14336, torch.float32, None)):
        if G is None:
            x, packed, scales = int4_case(gen, N, din, dout, dtype)
        else:
            packed, scales = int4_weights(gen, din, dout, G)
            x = torch.randn((N, din), generator=gen, device=DEV).to(dtype)
        check(i4.route(x, packed, scales) == "simt", "int4: not the simt route")
        got = i4.int4_matmul(x, packed, scales)
        again = i4.int4_matmul(x, packed, scales)
        ref = x.double() @ i4.dequant_int4(packed, scales, torch.float64)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "int4: non-finite output")
        check(torch.equal(got, again), "int4 simt: two launches differ")
        err = float((got.double() - ref).abs().max())
        tol = INT4_FP32_REL * float(ref.abs().max())
        G = din // scales.shape[0]
        p = i4.plan("simt", N, din, dout, G)
        max_err["int4_simt"] = max(max_err["int4_simt"], err)
        log(f"  int4 {str(dtype)[6:]} N={N} din={din} dout={dout} G={G} "
            f"(simt: grid {p.grid}, {p.cols} columns a block, {p.kslices} "
            f"runs a group) vs float64: max|err| {err:.3e} (tol {tol:.3e}); "
            "two launches bit for bit equal")
        check(err <= tol, "int4 kernel disagrees with the float64 product")

    x, packed, scales = int4_case(gen, 4, 256, 128)
    refused = (
        (TypeError, (x.half(), packed, scales)),
        (ValueError, (x.t().contiguous().t(), packed, scales)),
        (ValueError, (x, packed, scales[:, :64].contiguous())),
    )
    for err, args in refused:
        try:
            i4.int4_matmul(*args)
        except err:
            continue
        raise AssertionError(f"int4 wrapper accepted what it must refuse ({err})")
    log("  int4 wrapper refuses fp16 x, non-contiguous x and mismatched scales")


# ---------------------------------------------------------------------------
# Phase 3: the full-width model, kernels vs gather
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 2x / 3x: CUDA graphs
# ---------------------------------------------------------------------------


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a NaN equals the same NaN)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def replay_vs_eager(label: str, fn, refill, state=()) -> None:
    """``fn`` (one kernel launch) run once eagerly on a side stream, then
    captured into a CUDA graph; ``refill()`` redraws its inputs in place;
    the replay and an eager ``fn()`` on the redrawn inputs, each from the
    same ``state`` (tensors the launch writes, e.g. a cache), must agree
    bit for bit, and the replay must differ from the first inputs'
    output (it ran, on the new inputs)."""
    stream = torch.cuda.Stream()
    with on_stream(stream):
        first = fn().clone()
    graph = torch.cuda.CUDAGraph()
    with on_stream(stream):
        out = capture(graph, fn)
    refill()
    saved = [t.clone() for t in state]
    graph.replay()
    got, got_state = out.clone(), [t.clone() for t in state]
    for t, v in zip(state, saved):
        t.copy_(v)
    ref = fn()
    torch.cuda.synchronize()
    check(same_bits(got, ref) and all(
        same_bits(a, b) for a, b in zip(got_state, state)),
        f"{label}: the replayed launch differs from an eager launch")
    check(not same_bits(got, first), f"{label}: the replay read stale inputs")
    log(f"  {label}: replay equals an eager launch bit for bit"
        + (" (output and cache)" if state else ""))


def phase_capture_kernels() -> None:
    """One launch of each kernel family captured into a CUDA graph (the
    library links the CUDA runtime statically; the launches go to
    PyTorch's current stream as a raw handle) and replayed on new inputs
    against an eager launch, bit for bit."""
    log("[phase 2x] kernels under CUDA graph capture")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2024)
    B, T = 8, 512
    lens = [4096, 3000, 1, 0, 517, 2048, 4096, 33]
    # Tickets for the largest launch here, before any capture.
    pac.reserve_tickets(DEV, pac.ticket_count(
        torch.bfloat16, torch.bfloat16, H, KH, HD, 2, T))

    def redraw(*ts):
        def refill():
            for t in ts:
                t.copy_(torch.randn(t.shape, generator=gen, device=DEV))
        return refill

    q, cache, tables, kl, _ = make_case(gen, B=B, T=1, kv_lens=lens)
    q3 = q[:, 0].contiguous()
    check(splits_of(q3, cache, tables) > 1, "capture: the decode must split")
    replay_vs_eager(
        "decode_split_kernel (bf16 cache, B=8 ragged to 4096, split)",
        lambda: pac.paged_attention_decode(q3, cache, tables, kl, 1,
                                           scale=SCALE), redraw(q3))

    q, cache, tables, kl, _ = make_case(gen, B=B, T=1, kv_lens=lens,
                                        cache_dtype=E4M3)
    q3 = q[:, 0].contiguous()
    k_new = torch.randn((B, KH * HD), generator=gen, device=DEV).to(
        torch.bfloat16)
    v_new = torch.randn_like(k_new)
    wf = write_slots(tables, [max(n - 1, 0) for n in lens], [3],
                     cache.shape[1])
    replay_vs_eager(
        "decode_split_kernel (e4m3 cache, fused write)",
        lambda: pac.paged_attention_decode_write(
            q3, cache, tables, kl, 1, k_new, v_new, wf, scale=SCALE),
        redraw(q3, k_new, v_new), state=(cache,))

    q, cache, tables, kl, st = make_case(gen, B=2, T=T, kv_lens=[T, 3584 + T],
                                         starts=[0, 3584])
    replay_vs_eager(
        "paged_prefill_wgmma_kernel (T=512 fresh and at 3584)",
        lambda: pac.paged_attention_prefill(q, cache, tables, kl, st, 1,
                                            scale=SCALE), redraw(q))

    for N, route in ((64, "wgmma"), (8, "decode")):
        x, packed, scales = int4_case(gen, N, 4096, 14336)
        check(i4.route(x, packed, scales) == route,
              f"capture: int4 N={N} takes {i4.route(x, packed, scales)}")
        replay_vs_eager(
            f"int4_{route}_kernel (N={N}, 4096 x 14336)",
            lambda: i4.int4_matmul(x, packed, scales), redraw(x))


# The model phases' graphed steps: B=8 rows at 4096 (a burst of 4 ending
# there), a fresh 512-token chunk.
GRAPH_B, GRAPH_CTX, GRAPH_T, GRAPH_N = 8, 4096, 512, 4


def graph_runner(params, quantization=None, model=MODEL) -> ModelRunner:
    """A runner of the full-width ``model`` over ``params`` with pages for
    ``GRAPH_B`` sequences of ``GRAPH_CTX`` tokens, filled with random
    keys and values (every step reads all of them)."""
    W = GRAPH_CTX // BS
    cfg = EngineConfig(
        model=model, device=DEV.type, max_num_seqs=GRAPH_B,
        max_prefill_tokens=GRAPH_T, max_model_len=GRAPH_CTX,
        num_decode_steps=GRAPH_N, num_kv_blocks=GRAPH_B * W + 1,
        quantization=quantization)
    runner = ModelRunner(cfg, get_model_config(model), params)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(11)
    runner.kv_cache.normal_(generator=gen)
    return runner


def graph_batches(runner) -> dict:
    """The runner's numpy batches of four steps: a decode step at 4096
    (seeded draws, logprobs), a fresh 512-token chunk in row 0's pages,
    a 4-step seeded burst with penalties (the dense form) ending at 4096,
    and a verify step of every row's last 5 positions before 4096 (the
    argmax of each, position 0 seeded)."""
    rng = np.random.default_rng(5)
    B, ctx, T, n = GRAPH_B, GRAPH_CTX, GRAPH_T, GRAPH_N
    V = runner.model_cfg.vocab_size
    i32, f32 = np.int32, np.float32
    tables = np.arange(B * (ctx // BS), dtype=i32).reshape(B, -1)

    def sampling(rows):
        return dict(temps=np.full(rows, 0.8, f32), top_ps=np.full(rows, 0.9, f32),
                    top_ks=np.full(rows, 50, i32), min_ps=np.zeros(rows, f32),
                    seeds=np.arange(rows, dtype=np.int64) + 1000)

    def slots(rows, pos):
        return tables[rows, pos // BS] * BS + pos % BS

    pos = ctx - 1
    decode = dict(tokens=rng.integers(0, V, (B, 1)).astype(i32),
                  positions=np.full((B, 1), pos, i32),
                  write_idx=slots(np.arange(B), np.full(B, pos))[:, None]
                  .astype(i32),
                  block_tables=tables, kv_lens=np.full(B, ctx, i32),
                  last_idx=np.zeros(B, i32), **sampling(B))
    p = np.arange(T)
    chunk = dict(tokens=rng.integers(0, V, (1, T)).astype(i32),
                 positions=p[None].astype(i32),
                 write_idx=slots(np.zeros(T, int), p)[None].astype(i32),
                 block_tables=tables[:1], kv_lens=np.array([T], i32),
                 last_idx=np.array([T - 1], i32), **sampling(1))
    start = ctx - n  # positions start .. ctx - 1
    burst = dict(tokens=rng.integers(0, V, B).astype(i32),
                 positions=np.full(B, start, i32), block_tables=tables,
                 kv_lens=np.full(B, start + 1, i32), **sampling(B),
                 penalty_seen=rng.random((B, V)) < 0.01,
                 presence=np.full(B, 0.5, f32), frequency=np.full(B, 0.3, f32),
                 repetition=np.full(B, 1.2, f32),
                 pen_counts=rng.poisson(0.01, (B, V)).astype(f32))
    vp = np.arange(ctx - VERIFY_T, ctx)
    verify = dict(tokens=rng.integers(0, V, (B, VERIFY_T)).astype(i32),
                  positions=np.tile(vp, (B, 1)).astype(i32),
                  write_idx=slots(np.arange(B)[:, None], vp[None])
                  .astype(i32),
                  block_tables=tables, kv_lens=np.full(B, ctx, i32),
                  last_idx=np.zeros(B, i32), **sampling(B))
    return {"decode": decode, "chunk": chunk, "burst": burst,
            "verify": verify}


def graph_vs_eager(runner, label: str, batch: dict, want_lp: bool,
                   greedy: bool, n_steps: int = 0, spec: bool = False) -> dict:
    """One step run eagerly through the runner's own method, then (from
    the same KV cache, restored from a clone) through its graph path:
    first use (eager on the capture stream, then the capture), and, the
    cache restored again, the replay. The replay's packed rows and the
    cache bytes must equal the eager step's. Returns the host wall, device
    busy and idle share of both (``profile_step.profile``)."""
    if n_steps:
        # A burst returns its rows beside its carry: the rows are compared.
        def eager():
            return runner.eager_multi_step(runner._put(batch), n_steps,
                                           want_lp, greedy)["rows"]

        def graphed():
            return runner._multi_step(batch, n_steps, want_lp,
                                      greedy)["rows"]
    elif spec:
        # A verify step's packed argmax ids and sampled position 0.
        def eager():
            return runner.eager_spec_verify(runner._put(batch))

        def graphed():
            return runner._spec_verify(batch)
    else:
        def eager():
            return runner.eager_step(runner._put(batch), want_lp, greedy)

        def graphed():
            return runner._step(batch, want_lp, greedy)
    saved = runner.kv_cache.clone()
    ref = eager().clone()
    ref_cache = runner.kv_cache.clone()
    before = dict(runner.graph_counts)
    runner.kv_cache.copy_(saved)
    graphed()
    runner.kv_cache.copy_(saved)
    got = graphed().clone()
    torch.cuda.synchronize()
    after = runner.graph_counts
    check(after["captured"] == before["captured"] + 1
          and after["replayed"] == before["replayed"] + 1,
          f"{label}: graph counts {before} -> {after}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite rows")
    rows_equal = same_bits(got, ref)
    cache_equal = same_bits(runner.kv_cache, ref_cache)
    if not rows_equal:
        tok = (got[..., 0] == ref[..., 0]).float().mean()
        log(f"  {label}: replayed rows differ from eager ones: tokens equal "
            f"{float(tok):.3f}, max|diff| {float((got - ref).abs().max()):.3e}")
    check(rows_equal and cache_equal,
          f"{label}: replay differs from the eager step (rows equal "
          f"{rows_equal}, cache bytes equal {cache_equal})")
    del saved, ref_cache
    times = {"eager": profile(eager, 5, 3), "replayed": profile(graphed, 5, 3)}
    out = {"step": label, "fused_kv_write":
           os.environ.get("PST_FUSED_KV_WRITE") == "1"}
    for how, r in times.items():
        out[how] = {k: r[k] for k in ("wall_ms", "device_busy_ms",
                                      "idle_share", "kernels_per_step",
                                      "top")}
    log(f"  {label}: packed rows {tuple(got.shape)} and cache bytes equal the "
        f"eager step's; " + "; ".join(
            f"{how} wall {r['wall_ms']:.2f} ms, device busy "
            f"{r['device_busy_ms']:.2f} ms, idle {r['idle_share']:.1%}, "
            f"{r['kernels_per_step']:.0f} kernels" for how, r in times.items()))
    return out


def phase_step_graphs(params, quantization=None) -> list:
    """Phase 3x: full-width Llama-3-8B steps through the runner, eager
    against replayed: bf16 — a decode step at B=8 x 4096, a fresh T=512
    chunk, a 4-step seeded burst with penalties and a verify step of
    B=8 x T=5 ending at 4096; int4 (under
    ``PST_FUSED_KV_WRITE=1``) — the decode step."""
    runner = graph_runner(params, quantization)
    batches = graph_batches(runner)
    tag = quantization or "bf16"
    log(f"[phase 3x] {MODEL} {tag} steps, eager against replayed "
        f"(PST_FUSED_KV_WRITE={os.environ.get('PST_FUSED_KV_WRITE')})")
    rows = [graph_vs_eager(runner, f"{tag} decode B={GRAPH_B} x {GRAPH_CTX}",
                           batches["decode"], True, False)]
    if quantization is None:
        rows.append(graph_vs_eager(runner, f"bf16 prefill T={GRAPH_T} fresh",
                                   batches["chunk"], True, True))
        rows.append(graph_vs_eager(
            runner, f"bf16 {GRAPH_N}-step seeded burst with penalties",
            batches["burst"], False, False, n_steps=GRAPH_N))
        rows.append(graph_vs_eager(
            runner, f"bf16 verify B={GRAPH_B} x T={VERIFY_T} at {GRAPH_CTX}",
            batches["verify"], False, False, spec=True))
    log(f"  graphs {runner.graph_counts}, their pool "
        f"{runner.graph_pool_bytes / 2**20:.1f} MiB")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# Phase 3y: pipelined bursts at full width.


def burst_seqs(runner) -> list:
    """``GRAPH_B`` sequences over the graph runner's pages, each with
    about ``GRAPH_CTX - 200`` tokens of random ids (its pages hold random
    keys and values) and five output tokens so far: greedy rows, seeded
    sampled rows with logprobs, and penalized seeded rows, in turn."""
    rng = np.random.default_rng(21)
    V = runner.model_cfg.vocab_size
    W = GRAPH_CTX // BS
    kinds = (dict(temperature=0.0),
             dict(temperature=0.8, top_p=0.9, top_k=50, logprobs=2),
             dict(temperature=0.7, repetition_penalty=1.2,
                  presence_penalty=0.5, frequency_penalty=0.3))
    seqs = []
    for i in range(GRAPH_B):
        sp = dict(kinds[i % 3], max_tokens=GRAPH_CTX, ignore_eos=True)
        if i % 3:
            sp["seed"] = 1000 + i
        s = Sequence(f"b{i}", rng.integers(0, V, GRAPH_CTX - 200 - 8 * i)
                     .tolist(), SamplingParams(**sp))
        s.output_token_ids = rng.integers(0, V, 5).tolist()
        s.block_ids = list(range(i * W, (i + 1) * W))
        s.num_computed_tokens = s.num_tokens - 1
        seqs.append(s)
    return seqs


def apply_rows(seqs, rows) -> None:
    """The host's part of a burst: each row's tokens appended."""
    for s, r in zip(seqs, rows):
        for row in r:
            s.output_token_ids.append(int(row[0]))
            s.num_computed_tokens += 1


@contextlib.contextmanager
def no_host_sync_until_fetch(runner, reached: list):
    """CUDA's sync debug mode set to raise from here until the runner
    waits for the previous burst's rows (its ``_fetch``): the dispatch
    half of ``burst_continue`` must not sync with the card."""
    fetch = runner._fetch

    def fetch_after_dispatch(pending):
        torch.cuda.set_sync_debug_mode(0)
        reached.append(True)
        return fetch(pending)

    runner._fetch = fetch_after_dispatch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del runner._fetch


def phase_pipelined_bursts(params, quantization=None) -> dict:
    """Phase 3y: ``burst_start``, three ``burst_continue`` and a
    ``burst_drain`` of 4-token bursts at B=8 x ~4096 (greedy, seeded with
    logprobs, penalized rows), against four synchronous
    ``execute_decode_multi`` bursts from a clone of the same cache: rows
    and cache bytes bit for bit; each continuation's dispatch half under
    the sync debug mode set to raise. Then the host wall, device busy and
    idle share per burst of a run of each loop (its host part: the rows
    appended)."""
    runner = graph_runner(params, quantization)
    tag = quantization or "bf16"
    n = GRAPH_N
    log(f"[phase 3y] {MODEL} {tag} pipelined {n}-token bursts at "
        f"B={GRAPH_B} x ~{GRAPH_CTX} (PST_FUSED_KV_WRITE="
        f"{os.environ.get('PST_FUSED_KV_WRITE')})")
    saved = runner.kv_cache.clone()
    seqs = burst_seqs(runner)
    runner.burst_start(seqs, n)
    pipe, reached = [], []
    for _ in range(3):
        with no_host_sync_until_fetch(runner, reached):
            rows = runner.burst_continue(seqs)
        pipe.append(rows)
        apply_rows(seqs, rows)
    rows = runner.burst_drain()
    pipe.append(rows)
    apply_rows(seqs, rows)
    check(len(reached) == 3, "a continuation never fetched its rows")
    torch.cuda.synchronize()
    pipe_cache = runner.kv_cache.clone()
    runner.kv_cache.copy_(saved)
    del saved
    seqs = burst_seqs(runner)
    sync = []
    for _ in range(4):
        rows = runner.execute_decode_multi(seqs, n)
        sync.append(rows)
        apply_rows(seqs, rows)
    torch.cuda.synchronize()
    rows_equal = all(a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32)) for a, b in zip(pipe, sync))
    cache_equal = same_bits(pipe_cache, runner.kv_cache)
    check(rows_equal and cache_equal,
          f"3y {tag}: pipelined bursts differ from synchronous ones (rows "
          f"equal {rows_equal}, cache bytes equal {cache_equal})")
    del pipe_cache
    log(f"  {tag}: 4 pipelined bursts' rows {pipe[0].shape} and the cache "
        f"bytes equal 4 synchronous bursts' bit for bit; the continuations' "
        f"dispatch ran with no host sync")

    def sync_burst():
        apply_rows(sync_seqs, runner.execute_decode_multi(sync_seqs, n))

    def pipelined_burst():
        apply_rows(pipe_seqs, runner.burst_continue(pipe_seqs))

    sync_seqs = burst_seqs(runner)
    times = {"synchronous": profile(sync_burst, 5, 3)}
    pipe_seqs = burst_seqs(runner)
    runner.burst_start(pipe_seqs, n)
    times["pipelined"] = profile(pipelined_burst, 5, 3)
    apply_rows(pipe_seqs, runner.burst_drain())
    out = {"step": f"{tag} {n}-token burst B={GRAPH_B} x {GRAPH_CTX}, "
                   "synchronous vs pipelined",
           "fused_kv_write": os.environ.get("PST_FUSED_KV_WRITE") == "1"}
    for how, r in times.items():
        out[how] = {k: r[k] for k in ("wall_ms", "device_busy_ms",
                                      "idle_share", "kernels_per_step",
                                      "top")}
    log(f"  {tag} per {n}-token burst: " + "; ".join(
        f"{how} host wall {r['wall_ms']:.3f} ms, device busy "
        f"{r['device_busy_ms']:.3f} ms, idle {r['idle_share']:.2%}"
        for how, r in times.items()))
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 3w: a sequence swapped out and back in at full width.

SWAP_B, SWAP_CTX, SWAP_N = 8, 2000, 4
SWAP_BEFORE, SWAP_AFTER = 2, 2  # bursts before the swap and after it


def swap_seqs(runner, alloc) -> list:
    """``SWAP_B`` greedy sequences of about ``SWAP_CTX`` tokens of random
    ids (their pages hold random keys and values) with three output tokens
    so far, pages for the whole run taken from ``alloc`` and their full
    pages committed, as the engine leaves them after a prefill."""
    rng = np.random.default_rng(31)
    V = runner.model_cfg.vocab_size
    grow = SWAP_N * (SWAP_BEFORE + SWAP_AFTER)
    seqs = []
    for i in range(SWAP_B):
        s = Sequence(f"w{i}", rng.integers(0, V, SWAP_CTX - 16 * i).tolist(),
                     SamplingParams(temperature=0.0, max_tokens=4096,
                                    ignore_eos=True))
        s.output_token_ids = rng.integers(0, V, 3).tolist()
        s.num_computed_tokens = s.num_tokens - 1
        s.block_ids = [alloc.allocate()
                       for _ in range(-(-(s.num_tokens + grow) // BS))]
        s.commit_full_blocks(alloc)
        seqs.append(s)
    return seqs


def swap_bursts(runner, alloc, seqs, n_bursts: int) -> list:
    """``n_bursts`` synchronous bursts of every row, in the rows' order;
    the host's part: the tokens appended and the filled pages committed."""
    out = []
    for _ in range(n_bursts):
        rows = runner.execute_decode_multi(seqs, SWAP_N)
        apply_rows(seqs, rows)
        for s in seqs:
            s.commit_full_blocks(alloc)
        out.append(rows)
    return out


def phase_swap(params, kv_cache_dtype=None) -> dict:
    """Phase 3w: ``SWAP_B`` greedy rows at about ``SWAP_CTX`` tokens; after
    ``SWAP_BEFORE`` bursts, row 3 is swapped out through the engine's
    swapper (its committed pages stay addressed, its tail goes to pinned
    host memory), the freed tail page is taken and overwritten, and the
    row is swapped back in (its tail uploaded into another page) before
    ``SWAP_AFTER`` more bursts; swap-out and swap-in run under CUDA's sync
    debug mode set to raise. Rows and the row's pages against an
    uninterrupted run from the same cache, bit for bit (the batch keeps its
    rows' order). Then the device time of a page's download and upload."""
    tag = kv_cache_dtype or "bf16"
    dtype = E4M3 if kv_cache_dtype else torch.bfloat16
    grow = SWAP_N * (SWAP_BEFORE + SWAP_AFTER)
    per_row = -(-(SWAP_CTX + 3 + grow) // BS)
    cfg = EngineConfig(model=MODEL, device=DEV.type, max_num_seqs=SWAP_B,
                       max_model_len=4096, num_decode_steps=SWAP_N,
                       num_kv_blocks=SWAP_B * per_row + 8,
                       kv_cache_dtype=kv_cache_dtype)
    runner = ModelRunner(cfg, get_model_config(MODEL), params)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    for layer in range(runner.kv_cache.shape[0]):  # a layer's bf16 at a time
        noise = torch.empty(runner.kv_cache.shape[1:], dtype=torch.bfloat16,
                            device=DEV).normal_(generator=gen)
        runner.kv_cache[layer].copy_(to_cache_dtype(noise, dtype))
    del noise
    saved = runner.kv_cache.clone()
    row = 3

    def run(swap: bool) -> tuple:
        runner.kv_cache.copy_(saved)
        alloc = BlockAllocator(runner.num_blocks, BS, True)
        seqs = swap_seqs(runner, alloc)
        rows = swap_bursts(runner, alloc, seqs, SWAP_BEFORE)
        info = {}
        if swap:
            s = seqs[row]
            used = -(-s.num_computed_tokens // BS)
            tail_ids = s.block_ids[s._committed_blocks:used]
            swapper = KVSwapper(runner)
            torch.cuda.set_sync_debug_mode("error")
            try:
                swapper.swap_out(s, alloc)
                # The freed tail pages go to another owner, which writes them.
                taken = [alloc.allocate() for _ in tail_ids]
                for blk in taken:
                    raw(runner.kv_cache)[:, blk].fill_(0x42)
                back = swapper.swap_in(s, alloc)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(back and swapper.swap_in_total == 1
                  and swapper.fallback_recompute_total == 0,
                  f"3w {tag}: the row did not come back intact")
            moved = s.block_ids[used - len(tail_ids):used]
            check(set(moved).isdisjoint(taken),
                  f"3w {tag}: the tail came back into the pages it left")
            # The pages its next bursts write (the engine's scheduler
            # reserves them).
            want = -(-(s.num_tokens + SWAP_N * SWAP_AFTER) // BS)
            s.block_ids += [alloc.allocate()
                            for _ in range(want - len(s.block_ids))]
            info = {"tail_pages": len(tail_ids),
                    "committed_pages": s._committed_blocks}
        rows += swap_bursts(runner, alloc, seqs, SWAP_AFTER)
        torch.cuda.synchronize()
        s = seqs[row]
        used = -(-s.num_computed_tokens // BS)
        pages = raw(runner.kv_cache)[:, s.block_ids[:used]].clone()
        return rows, [list(q.output_token_ids) for q in seqs], pages, info

    want_rows, want_toks, want_pages = run(False)[:3]
    got_rows, got_toks, got_pages, info = run(True)
    rows_equal = all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                     for a, b in zip(got_rows, want_rows))
    check(rows_equal and got_toks == want_toks
          and same_bits(got_pages, want_pages),
          f"3w {tag}: the swapped run differs from the uninterrupted one "
          f"(rows {rows_equal}, tokens {got_toks == want_toks}, pages "
          f"{same_bits(got_pages, want_pages)})")
    del saved, got_pages, want_pages
    # A page's bytes (K and V of every layer) and its device time each way.
    mc = runner.model_cfg
    page_bytes = (2 * mc.num_layers * BS * mc.num_kv_heads * mc.head_dim
                  * runner.kv_cache.element_size())
    k, v = runner.download_page(5)
    d2h = cuda_ms(lambda: runner.download_page(5))
    h2d = cuda_ms(lambda: runner.upload_page(9, k, v))
    log(f"[phase 3w] {MODEL} {tag} cache: {SWAP_B} greedy rows at ~{SWAP_CTX} "
        f"tokens, row {row} swapped out after burst {SWAP_BEFORE} "
        f"({info['committed_pages']} committed pages left in place, "
        f"{info['tail_pages']} tail page(s) moved, no host sync) and back "
        f"in: {SWAP_BEFORE + SWAP_AFTER} bursts' rows, every row's tokens "
        f"and the row's pages equal the uninterrupted run's bit for bit; "
        f"page {page_bytes / 2**20:.1f} MiB, device-to-host {d2h:.4f} ms "
        f"({page_bytes / d2h / 1e6:.1f} GB/s), host-to-device {h2d:.4f} ms "
        f"({page_bytes / h2d / 1e6:.1f} GB/s)")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return {"cache": tag, "page_bytes": page_bytes, "d2h_ms": d2h,
            "h2d_ms": h2d, **info}


def build_model(seed: int = 0):
    cfg = get_model_config(MODEL)
    model = Llama(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init_params(gen, DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[phase 3] {MODEL}: {cfg.num_layers} layers, {n / 1e9:.2f}B params "
        f"{cfg.dtype} on {DEV} in {time.perf_counter() - t0:.1f}s")
    return model, params


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def drive_model(model, params, impl: str, prompt, decode_tokens,
                kv_dtype=None, chunk=None):
    """The prefill of ``prompt`` (in chunks of ``chunk`` tokens; default
    one) then one decode step per token of ``decode_tokens``, on a cache
    of ``kv_dtype`` (default the model's), through ``impl``: ``"cuda"``,
    ``"gather"`` or ``"plain"`` (the kernels' plain versions); returns the
    logits of the prefill's last chunk and of every decode step [1 + n,
    V], and the cache."""
    if impl == "plain":
        saved = llama_mod.paged_attention
        llama_mod.paged_attention = plain_attention
        try:  # as "gather", so that the fused decode-write never runs
            return drive_model(model, params, "gather", prompt,
                               decode_tokens, kv_dtype, chunk)
        finally:
            llama_mod.paged_attention = saved
    T = len(prompt)
    nb = -(-(T + len(decode_tokens)) // BS) + 1
    cache = model.make_kv_cache(nb, BS, dtype=kv_dtype, device=DEV)
    tables = torch.arange(nb - 1, dtype=torch.int32, device=DEV)[None].flip(1)
    tables = tables.contiguous()  # pages in reverse: a real indirection
    drop = nb * BS

    def slot(p):
        return int(tables[0, p // BS]) * BS + p % BS

    out = []
    chunk = chunk or T
    for c0 in range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        toks = torch.tensor([prompt[c0:c1]], dtype=torch.int32, device=DEV)
        pos = torch.arange(c0, c1, dtype=torch.int32, device=DEV)[None]
        widx = torch.tensor([[slot(p) for p in range(c0, c1)]],
                            dtype=torch.int32, device=DEV)
        logits, cache = model.forward(
            params, toks, pos, widx, tables,
            torch.tensor([c1], dtype=torch.int32, device=DEV),
            torch.tensor([c1 - c0 - 1], dtype=torch.int32, device=DEV), cache,
            attn_impl=impl)
    out.append(logits[0])
    for i, tok in enumerate(decode_tokens):
        p = T + i
        # Row 1 is a padding row: kv_len 0, write dropped.
        logits, cache = model.forward(
            params,
            torch.tensor([[tok], [0]], dtype=torch.int32, device=DEV),
            torch.tensor([[p], [0]], dtype=torch.int32, device=DEV),
            torch.tensor([[slot(p)], [drop]], dtype=torch.int32, device=DEV),
            torch.cat([tables, torch.zeros_like(tables)]),
            torch.tensor([p + 1, 0], dtype=torch.int32, device=DEV),
            torch.zeros(2, dtype=torch.int32, device=DEV), cache,
            attn_impl=impl)
        out.append(logits[0])
    torch.cuda.synchronize()
    return torch.stack(out), cache


def plain_attention(q, kv, tables, lens, positions, layer=0, *, scale,
                    impl="auto", window=0, softcap=0.0):
    """``ops.attention.paged_attention`` through the kernels' plain
    versions, which keep P in fp32."""
    if q.shape[1] == 1:
        return pac.paged_attention_decode_plain(
            q[:, 0], kv, tables, lens, layer, scale=scale, window=window,
            softcap=softcap)[:, None]
    return pac.paged_attention_prefill_plain(
        q, kv, tables, lens, positions[:, 0].to(torch.int32).contiguous(),
        layer, scale=scale, window=window, softcap=softcap)


def model_prompt(cfg, n: int = 512):
    """The model phases' ``n``-token prompt and 8 decode tokens (seed 7)."""
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    decode_tokens = torch.randint(1, cfg.vocab_size, (8,), generator=gen).tolist()
    return prompt, decode_tokens


def differ(got, ref, label: str = "cuda") -> str:
    """max|got - ref| of two paths' logits and their argmax agreement."""
    err = float((got - ref).abs().max())
    agreed = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return (f"max|{label} - gather| {err:.4f}, argmax agreement "
            f"{agreed:.2f}")


def agree(got, ref, label) -> str:
    """Kernel-path logits against the gather path's: finite, of the
    expected shape, within MODEL_REL_ATOL of max|ref|. Returns a summary."""
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits (cuda)")
    check(bool(torch.isfinite(ref).all()), f"{label}: non-finite logits (gather)")
    check(got.shape == ref.shape, f"{label}: logits shape {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    tol = MODEL_REL_ATOL * float(ref.abs().max())
    agreed = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    check(err <= tol, f"{label}: the kernel path disagrees with the gather "
          f"path ({err:.4f} > {tol:.4f})")
    return (f"max|logit| {float(ref.abs().max()):.3f}, max|cuda - gather| "
            f"{err:.4f} (tol {tol:.4f}), argmax agreement {agreed:.2f}")


def phase_model(model, params) -> dict:
    cfg = model.cfg
    prompt, decode_tokens = model_prompt(cfg)

    pac.reset_launch_counts()
    t0 = time.perf_counter()
    got, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    t_cuda = time.perf_counter() - t0
    counts = dict(pac.launch_counts)
    check(counts == {"prefill": cfg.num_layers,
                     "decode": cfg.num_layers * len(decode_tokens),
                     "decode_write": 0},
          f"launch counts {counts}: expected one per layer per step")
    want = {k: 0 for k in pac.route_counts}
    want.update(prefill_wgmma=cfg.num_layers,
                decode_split=cfg.num_layers * len(decode_tokens))
    check(pac.route_counts == want,
          f"routes {pac.route_counts}: expected the wgmma prefill and the "
          "split-KV decode")
    t0 = time.perf_counter()
    ref, _ = drive_model(model, params, "gather", prompt, decode_tokens)
    t_gather = time.perf_counter() - t0

    check(got.shape == (1 + len(decode_tokens), cfg.vocab_size),
          f"model: logits shape {tuple(got.shape)}")
    log(f"  512-token prefill + 8 decode steps: {agree(got, ref, 'model')}; "
        f"cuda {t_cuda:.2f}s, gather {t_gather:.2f}s (first calls)")
    return {"prefill_chunk": counts["prefill"],
            "decode_step": counts["decode"] // len(decode_tokens)}


def phase_verify_logits(model, params) -> float:
    """Phase 3s: a verify step's logits against T = 1 decode steps over the
    same prefix. The model phases' 512-token prompt is prefilled, then
    its first 5 decode tokens go through one forward of T = 5 with every
    position's logits (``all_logits=True``: the wgmma prefill, once a
    layer), and, on a fresh cache, through 5 decode steps (the split-KV
    decode): position j's logits agree under ``agree``. Returns the logit
    tolerance, ``MODEL_REL_ATOL`` of the decode steps' largest |logit|,
    that the served phases' near-tie rule uses."""
    cfg = model.cfg
    prompt, decode_tokens = model_prompt(cfg)
    toks = decode_tokens[:VERIFY_T]
    ref, _ = drive_model(model, params, "cuda", prompt, toks)
    ref = ref[1:]  # the logits after each decode token
    T = len(prompt)
    nb = -(-(T + VERIFY_T) // BS) + 1
    cache = model.make_kv_cache(nb, BS, device=DEV)
    tables = torch.arange(nb - 1, dtype=torch.int32,
                          device=DEV)[None].flip(1).contiguous()

    def slots(p0, n):
        return torch.tensor([[int(tables[0, p // BS]) * BS + p % BS
                              for p in range(p0, p0 + n)]],
                            dtype=torch.int32, device=DEV)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=DEV)

    _, cache = model.forward(
        params, i32([prompt]), torch.arange(T, dtype=torch.int32,
                                            device=DEV)[None],
        slots(0, T), tables, i32([T]), i32([T - 1]), cache, attn_impl="cuda")
    pac.reset_launch_counts()
    got, cache = model.forward(
        params, i32([toks]),
        torch.arange(T, T + VERIFY_T, dtype=torch.int32, device=DEV)[None],
        slots(T, VERIFY_T), tables, i32([T + VERIFY_T]), i32([0]), cache,
        attn_impl="cuda", all_logits=True)
    torch.cuda.synchronize()
    expect_routes({"prefill_wgmma": cfg.num_layers}, "verify step")
    check(got.shape == (1, VERIFY_T, cfg.vocab_size),
          f"verify: logits shape {tuple(got.shape)}")
    log(f"[phase 3s] a verify step (T={VERIFY_T} after the 512-token "
        f"prompt, all_logits) against {VERIFY_T} decode steps: "
        f"{agree(got[0], ref, 'verify vs decode')}; argmax equal at "
        f"{(got[0].argmax(-1) == ref.argmax(-1)).tolist()}")
    return MODEL_REL_ATOL * float(ref.abs().max())


def expect_routes(want: dict, label: str) -> None:
    """The attention routes launched since the last reset are ``want``'s
    counts, every other route none."""
    full = {k: 0 for k in pac.route_counts}
    full.update(want)
    check(pac.route_counts == full,
          f"{label}: routes {pac.route_counts}, expected {want}")


def phase_fp8_model(model, params) -> dict:
    """The full-width model's steps over an e4m3 cache: through the
    kernels with the unfused and the fused write, each against the gather
    path over an e4m3 cache. Returns the e4m3 kernels' launches a step,
    and their launches over this path (by row)."""
    cfg = model.cfg
    L = cfg.num_layers
    prompt, decode_tokens = model_prompt(cfg)
    n = len(decode_tokens)
    pages = {dt: resolve_num_kv_blocks(EngineConfig(model=MODEL,
                                                    kv_cache_dtype=dt), cfg, DEV)
             for dt in (None, "float8_e4m3fn")}
    log(f"[phase 3c] {MODEL} over an e4m3 cache: the engine's budget holds "
        f"{pages['float8_e4m3fn']} e4m3 pages beside the bf16 weights "
        f"({pages[None]} bf16 pages), {BS} tokens each")
    ref, ref_cache = drive_model(model, params, "gather", prompt,
                                 decode_tokens, E4M3)
    check(ref_cache.dtype == E4M3, "gather path: the cache is not e4m3")
    per_step, path = {}, {}
    for fused in (False, True):
        if fused:
            os.environ["PST_FUSED_KV_WRITE"] = "1"
        pac.reset_launch_counts()
        got, cache = drive_model(model, params, "cuda", prompt,
                                 decode_tokens, E4M3)
        os.environ.pop("PST_FUSED_KV_WRITE", None)
        dec = "decode_write_split_e4m3" if fused else "decode_split_e4m3"
        expect_routes({"prefill_wgmma_e4m3": L, dec: L * n},
                      f"e4m3 model (fused write: {fused})")
        check(cache.dtype == E4M3, "kernel path: the cache is not e4m3")
        log(f"  e4m3 cache, {'fused' if fused else 'unfused'} write: 512-token "
            f"prefill + {n} decode steps, {L} e4m3 prefill and {L * n} "
            f"{'decode-write' if fused else 'decode'} launches: "
            f"{agree(got, ref, 'e4m3 model')}")
        kind = form("decode_write" if fused else "decode", E4M3)
        per_step[kind] = L
        path[kind] = pac.route_counts[dec]
    per_step["prefill_e4m3"] = L
    return per_step, path


def phase_int8_model(model) -> None:
    """The full-width model with int8 weights drawn on the card: one
    512-token prefill and 8 decode steps through the attention kernels,
    against the gather path on a copy whose int8 weights were dequantized
    to bf16 beforehand."""
    cfg = model.cfg
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_params(gen, DEV, quantization="int8")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[phase 3d] {MODEL} int8 on {DEV} in {time.perf_counter() - t0:.1f}s: "
        f"resident weights {nbytes / 1e9:.3f} GB")
    prompt, decode_tokens = model_prompt(cfg)
    pac.reset_launch_counts()
    got, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    L, n = cfg.num_layers, len(decode_tokens)
    expect_routes({"prefill_wgmma": L, "decode_split": L * n}, "int8 model")
    ref_params = dequantized_copy(params)
    del params
    ref, _ = drive_model(model, ref_params, "gather", prompt, decode_tokens)
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  int8: 512-token prefill + {n} decode steps against the "
        f"dequantized gather path: {agree(got, ref, 'int8 model')}")


def phase_qwen2(layers: int = 4) -> dict:
    """qwen2-7b at full width (H=28 over KH=4: G=7; QKV biases, drawn
    non-zero here) and ``layers`` of its 28 layers: one 512-token prefill
    and 8 decode steps through the kernels, over a bf16 and an e4m3 cache,
    against the gather path."""
    cfg = dataclasses.replace(get_model_config("qwen2-7b"), num_layers=layers)
    model = Llama(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = model.init_params(gen, DEV)
    for name in ("bq", "bk", "bv"):
        b = params["layers"][name]
        b.copy_(torch.randn(b.shape, generator=gen, device=DEV) * 0.5)
    log(f"[phase 3e] qwen2-7b at full width, {layers} of its 28 layers: "
        f"H={cfg.num_heads}, KH={cfg.num_kv_heads} (G="
        f"{cfg.num_heads // cfg.num_kv_heads}), hd={cfg.head_dim}, vocab "
        f"{cfg.vocab_size}")
    prompt, decode_tokens = model_prompt(cfg)
    L, n = layers, len(decode_tokens)
    counts = {}
    for kv in (None, E4M3):
        ref, _ = drive_model(model, params, "gather", prompt, decode_tokens, kv)
        pac.reset_launch_counts()
        got, _ = drive_model(model, params, "cuda", prompt, decode_tokens, kv)
        want = {form("prefill_wgmma", kv): L, form("decode_split", kv): L * n}
        expect_routes(want, f"qwen2-7b ({kv or 'bf16'} cache)")
        counts.update(want)
        log(f"  {kv or 'bf16'} cache: {agree(got, ref, 'qwen2-7b')}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# gemma2-9b's model phases: a prompt longer than its window of 4096, in
# chunks of the engine's 512, so that the local layers cut their keys.
GEMMA_PROMPT, GEMMA_CHUNK = 4608, 512


def set_norms(cfg, params, gen=None, noise: float = 0.0,
              w: float = 0.0) -> None:
    """Every Gemma ``(1 + w)`` norm weight at ``w`` (0: the identity, HF's
    Gemma init), any other norm weight at 1; plus N(0, ``noise``) when
    ``gen`` is given. ``init_params`` draws the JAX package's w = 1, which
    doubles every Gemma norm's output and sharpens the attention scores 4x.
    A random gemma2-9b at w = 1 amplifies rounding differences with depth:
    at 42 layers two correct attention paths (the kernels' plain versions,
    with an fp32 P, and the gather path) differ by 7.53 of a max|logit| of
    9.55 on an H100, against 0.12 at w = 0 (``python3 chip_smoke.py
    drift`` measures it; PERF.md). So the Gemma model phases draw their
    norms around w = 0."""
    base = w if cfg.norm_unit_offset else 1.0
    for tree in (params, params["layers"]):
        for k, w in tree.items():
            if "norm" in k:
                w.fill_(base)
                if gen is not None:
                    w.add_(torch.randn(w.shape, generator=gen, device=DEV)
                           .to(w.dtype) * noise)


def phase_gemma2() -> tuple:
    """gemma2-9b at full width and depth (42 layers, random bf16 weights
    from seed 0, norms drawn by ``set_norms`` around w = 0): a 4608-token
    prompt in 512-token chunks and 8 decode steps through the head_dim-256
    kernels, against the gather path: over a bf16 cache (unfused write;
    the kernels' plain versions beside them as a witness of how far two
    correct paths differ), and over an e4m3 cache with the unfused and
    with the fused write (against the gather path over an e4m3 cache, so
    the e4m3 rows' own error is not counted). Returns (model, params,
    each e4m3/bf16 unfused row's launches a step, and its launches on
    this path)."""
    cfg = get_model_config(GEMMA)
    model = Llama(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_params(gen, DEV)
    set_norms(cfg, params, gen, noise=0.1)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[phase 3f] {GEMMA}: {cfg.num_layers} layers, {n / 1e9:.2f}B params "
        f"({nbytes / 1e9:.2f} GB {cfg.dtype}) on {DEV} in "
        f"{time.perf_counter() - t0:.1f}s; H={cfg.num_heads}, "
        f"KH={cfg.num_kv_heads}, hd={cfg.head_dim}, window "
        f"{cfg.sliding_window} on alternate layers, softcaps "
        f"{cfg.attn_logit_softcap} / {cfg.final_logit_softcap}, tied "
        f"{cfg.vocab_size}-row unembed; (1 + w) norms at w ~ N(0, 0.1)")
    prompt, decode_tokens = model_prompt(cfg, GEMMA_PROMPT)
    L, nd = cfg.num_layers, len(decode_tokens)
    chunks = -(-GEMMA_PROMPT // GEMMA_CHUNK)
    per_step, path = {}, {}
    for kv, fused in ((None, False), (E4M3, False), (E4M3, True)):
        if not fused:
            ref, _ = drive_model(model, params, "gather", prompt,
                                 decode_tokens, kv, GEMMA_CHUNK)
        if fused:
            os.environ["PST_FUSED_KV_WRITE"] = "1"
        pac.reset_launch_counts()
        got, cache = drive_model(model, params, "cuda", prompt, decode_tokens,
                                 kv, GEMMA_CHUNK)
        os.environ.pop("PST_FUSED_KV_WRITE", None)
        dec = form("decode_write_split" if fused else "decode_split", kv, 256)
        pre = form("prefill_wgmma", kv, 256)
        expect_routes({pre: L * chunks, dec: L * nd},
                      f"{GEMMA} ({kv or 'bf16'} cache, fused write: {fused})")
        check(got.shape == (1 + nd, cfg.vocab_size),
              f"{GEMMA}: logits shape {tuple(got.shape)}")
        log(f"  {kv or 'bf16'} cache, {'fused' if fused else 'unfused'} "
            f"write: {GEMMA_PROMPT}-token prompt in {chunks} chunks + {nd} "
            f"decode steps, {L * chunks} {pre} and {L * nd} {dec} launches: "
            f"{agree(got, ref, GEMMA)}")
        if kv is None:
            plain, _ = drive_model(model, params, "plain", prompt,
                                   decode_tokens, kv, GEMMA_CHUNK)
            log(f"  witness, the plain versions (fp32 P) against the gather "
                f"path: {differ(plain, ref, 'plain')}")
            del plain
        kind = form("decode_write" if fused else "decode", kv, 256)
        per_step[kind] = L
        path[kind] = pac.route_counts[dec]
        if not fused:
            per_step[form("prefill", kv, 256)] = L
            path[form("prefill", kv, 256)] = pac.route_counts[pre]
        del got, cache
    return model, params, per_step, path


GEMMA2_PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def phase_gemma2_int4(layers: int = 4) -> None:
    """gemma2-9b int4 at full width and ``layers`` of its 42 layers, drawn
    and quantized on the card, under ``PST_FUSED_KV_WRITE=1``: the prompt
    of phase 3f and 8 decode steps through the int4 and head_dim-256
    kernels, against the gather path on a copy whose int4 weights were
    dequantized to bf16 beforehand. D = 3584 is not a multiple of 1024, so
    the JAX package sends five projections to its XLA fallback; the port's
    routes take every shape (printed per projection)."""
    cfg = dataclasses.replace(get_model_config(GEMMA), num_layers=layers)
    model = Llama(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = model.init_params(gen, DEV, quantization="int4")
    set_norms(cfg, params, gen, noise=0.1)
    lp = params["layers"]
    routes = {}
    for name in GEMMA2_PROJ:
        packed, scales = lp[name][0], lp[name + "_q4s"][0]
        din = 2 * packed.shape[0]
        routes[name] = (din, packed.shape[1], *(
            i4.route(torch.empty((N, din), dtype=torch.bfloat16, device=DEV),
                     packed, scales) for N in (2, GEMMA_CHUNK)))
    log(f"[phase 3f] {GEMMA} int4, {layers} of its {get_model_config(GEMMA).num_layers} "
        "layers, PST_FUSED_KV_WRITE=1; int4 route per projection (din x dout: "
        "2 decode rows, a 512-token chunk): " + ", ".join(
            f"{k} {d}x{o}: {a}, {b}" for k, (d, o, a, b) in routes.items()))
    check(all(r[2] == "decode" and r[3] == "wgmma" for r in routes.values()),
          f"{GEMMA} int4 routes {routes}")
    prompt, decode_tokens = model_prompt(cfg, GEMMA_PROMPT)
    chunks = -(-GEMMA_PROMPT // GEMMA_CHUNK)
    nd = len(decode_tokens)
    os.environ["PST_FUSED_KV_WRITE"] = "1"
    reset_launch_counts()
    got, _ = drive_model(model, params, "cuda", prompt, decode_tokens,
                         chunk=GEMMA_CHUNK)
    os.environ.pop("PST_FUSED_KV_WRITE", None)
    expect_routes({"prefill_wgmma_hd256": layers * chunks,
                   "decode_write_split_hd256": layers * nd},
                  f"{GEMMA} int4")
    want = {"wgmma": 7 * layers * chunks, "decode": 7 * layers * nd}
    got_routes = {k: i4.route_counts[k] for k in want}
    check(got_routes == want and i4.route_counts["simt"] == 0,
          f"{GEMMA} int4 routes {i4.route_counts}, expected {want}")
    ref_params = dequantized_copy(params)
    del params
    ref, _ = drive_model(model, ref_params, "gather", prompt, decode_tokens,
                         chunk=GEMMA_CHUNK)
    del ref_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  int4, fused write: int4 launches {got_routes} (split sums "
        f"{i4.route_counts['sum']}); against the dequantized gather path: "
        f"{agree(got, ref, GEMMA + ' int4')}")


# The drift sweep's depths of gemma2-9b and Gemma norm weights w (1 is the
# JAX init's).
DRIFT_LAYERS, DRIFT_W = (4, 12, 42), (1.0, 0.5, 0.0)


def drift() -> None:
    """``python3 chip_smoke.py drift``: how far two correct attention paths
    drift apart with depth and with the Gemma norm weight w. gemma2-9b
    (random weights from seed 0) cut to each of DRIFT_LAYERS, every
    ``(1 + w)`` norm at each of DRIFT_W, runs phase 3f's prompt and decode
    steps over a bf16 cache through the kernels, the gather path and the
    kernels' plain versions. Where the plain versions differ from the
    gather path as much as the kernels do, the model amplifies rounding,
    whatever computes the attention. One line per depth and w, then one
    JSON line."""
    results = []
    for layers in DRIFT_LAYERS:
        cfg = dataclasses.replace(get_model_config(GEMMA), num_layers=layers)
        model = Llama(cfg)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(0)
        params = model.init_params(gen, DEV)
        prompt, decode_tokens = model_prompt(cfg, GEMMA_PROMPT)
        for w in DRIFT_W:
            set_norms(cfg, params, w=w)
            out = {impl: drive_model(model, params, impl, prompt,
                                     decode_tokens, chunk=GEMMA_CHUNK)[0]
                   for impl in ("cuda", "gather", "plain")}
            ref = out["gather"]
            r = {"layers": layers, "norm_w": w,
                 "max_abs_logit": float(ref.abs().max()),
                 "cuda_vs_gather": float((out["cuda"] - ref).abs().max()),
                 "plain_vs_gather": float((out["plain"] - ref).abs().max()),
                 "cuda_vs_plain": float((out["cuda"] - out["plain"])
                                        .abs().max())}
            results.append(r)
            log(f"[drift] {GEMMA} {layers} layers, norms at w = {w:g}: "
                f"max|logit| {r['max_abs_logit']:.3f}; "
                f"{differ(out['cuda'], ref)}; {differ(out['plain'], ref, 'plain')}; "
                f"max|cuda - plain| {r['cuda_vs_plain']:.4f}")
            del out, ref
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"drift": results}), flush=True)


def phase_gemma_qwen3(layers: int = 4) -> dict:
    """gemma-7b (head_dim 256, G = 1, GeGLU, (1 + w) norms, scaled
    embeddings) and qwen3-8b (per-head q/k norms on the head_dim-128
    kernels) at full width and ``layers`` layers each, norm weights drawn
    around ``set_norms``' values: a 512-token prefill and 8 decode steps
    through the kernels against the gather path. Returns the routes they
    launched."""
    counts = {}
    for name, hd in (("gemma-7b", 256), ("qwen3-8b", 128)):
        cfg = dataclasses.replace(get_model_config(name), num_layers=layers)
        model = Llama(cfg)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(0)
        params = model.init_params(gen, DEV)
        set_norms(cfg, params, gen, noise=0.1)
        prompt, decode_tokens = model_prompt(cfg)
        ref, _ = drive_model(model, params, "gather", prompt, decode_tokens)
        pac.reset_launch_counts()
        got, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
        want = {form("prefill_wgmma", None, hd): layers,
                form("decode_split", None, hd): layers * len(decode_tokens)}
        expect_routes(want, name)
        counts.update(want)
        log(f"[phase 3g] {name} at full width, {layers} of its "
            f"{get_model_config(name).num_layers} layers (H={cfg.num_heads}, "
            f"KH={cfg.num_kv_heads}, hd={cfg.head_dim}): "
            f"{agree(got, ref, name)}")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def phase_tiny_engines() -> dict:
    """The default engine, ``EngineConfig(device="cuda")`` (the fp32
    tiny-llama-debug, head_dim 16), answers a completion on the CUDA-core
    kernels; then the same over an e4m3 cache, both with the fused write,
    and with int4 weights (fp32 x: the int4 kernel's CUDA-core route).
    Each path's launches are counted from zero; returns them by route."""
    prompt = list(range(5, 300))
    counts = {}
    for kv, fused, quant in ((None, False, None), (None, True, None),
                             ("float8_e4m3fn", False, None),
                             ("float8_e4m3fn", True, None),
                             (None, False, "int4")):
        if fused:
            os.environ["PST_FUSED_KV_WRITE"] = "1"
        cfg = (EngineConfig(device="cuda") if kv is None and quant is None
               else EngineConfig(device="cuda", kv_cache_dtype=kv,
                                 quantization=quant))
        engine = LLMEngine(cfg)
        reset_launch_counts()
        out = engine.generate([prompt], SamplingParams(
            max_tokens=16, temperature=0.0, ignore_eos=True))[0]
        torch.cuda.synchronize()
        os.environ.pop("PST_FUSED_KV_WRITE", None)
        cdt = engine.runner.kv_cache.dtype
        dec = form("decode_write_simt" if fused else "decode_simt", cdt)
        pre = form("prefill_simt", cdt)
        check(len(out["token_ids"]) == 16 and out["finish_reason"] == "length",
              f"tiny engine: {out}")
        check(pac.route_counts[dec] > 0 and pac.route_counts[pre] > 0 and
              sum(pac.route_counts.values()) == pac.route_counts[dec]
              + pac.route_counts[pre],
              f"tiny engine ({kv}, fused {fused}): routes {pac.route_counts}")
        check((i4.route_counts["simt"] > 0) == (quant == "int4") and
              i4.route_counts["simt"] == i4.launch_counts["int4"] and
              i4.route_counts["sum"] == 0,
              f"tiny engine ({quant}): int4 routes {i4.route_counts}")
        counts[dec] = pac.route_counts[dec]
        counts[pre] = pac.route_counts[pre]
        if quant:
            counts["int4_simt"] = i4.route_counts["simt"]
        args = [f"kv_cache_dtype={kv!r}"] * bool(kv) + [f"quantization={quant!r}"] * bool(quant)
        log(f"[phase 4d] EngineConfig(device='cuda'{''.join(', ' + a for a in args)})"
            f"{' with PST_FUSED_KV_WRITE=1' if fused else ''}: "
            f"{engine.model_cfg.name} ({engine.model_cfg.dtype}, hd "
            f"{engine.model_cfg.head_dim}), a {len(prompt)}-token prompt -> "
            f"16 tokens; launches {dec} {counts[dec]}, {pre} {counts[pre]}"
            + (f", int4 (CUDA cores) {counts['int4_simt']}" if quant else ""))
        del engine
        gc.collect()  # its KV cache, before the next engine sizes its own
        torch.cuda.empty_cache()
    return counts


def drain(engine, requests) -> dict:
    """Add ``requests`` ((prompt ids, SamplingParams kwargs) pairs) and
    step the engine until they finish; returns each one's token count and
    finish reason by request id."""
    done = {}
    for ids, sp in requests:
        engine.add_request(f"r{ids[0]}-{len(ids)}", prompt_token_ids=ids,
                           sampling=SamplingParams(ignore_eos=True, **sp))
    for _ in range(400):
        if not engine.has_work():
            return done
        for out in engine.step():
            if out.finished:
                done[out.request_id] = (out.num_output_tokens,
                                        out.finish_reason)
    raise AssertionError("the engine did not drain")


def phase_tiny_warmup() -> dict:
    """Phase 4d: a tiny engine (the JAX precompile test's: two decode row
    buckets, one table bucket, four chunk buckets, a 2-step burst) on the
    card with ``warmup="full"``: every lattice bucket captured, then
    traffic that spans the lattice (greedy, sampled and mixed rows,
    chunked prefills, one-row tails) replays and captures nothing; a
    penalized request's bursts replay the dense-penalty graphs and its
    prefill (pow2 penalty ids) captures at most once. The counterpart of
    ``tests/test_precompile.py::test_full_warmup_then_zero_compiles_on_spanning_traffic``."""
    cfg = EngineConfig(device="cuda", warmup="full", max_model_len=64,
                       block_size=16, num_kv_blocks=16, max_num_seqs=2,
                       max_prefill_tokens=8, num_decode_steps=2)
    engine = LLMEngine(cfg)
    runner = engine.runner
    summary = engine.precompile()
    warm = dict(runner.graph_counts)
    check(summary["buckets_compiled"] == summary["buckets_total"] > 0
          and warm["captured"] == warm["eager"] == len(runner._graphs),
          f"tiny full warmup: {summary}, graphs {warm}")
    reset_launch_counts()
    traffic = [
        [(list(range(2, 12)), dict(max_tokens=3, temperature=0.0))],
        [(list(range(20, 26)), dict(max_tokens=4, temperature=1.0, seed=7)),
         (list(range(30, 42)), dict(max_tokens=2, temperature=0.0))],
        [(list(range(2, 9)), dict(max_tokens=2, temperature=0.9, seed=1)),
         (list(range(9, 16)), dict(max_tokens=2, temperature=0.8, seed=2))],
    ]
    for reqs in traffic:
        done = drain(engine, reqs)
        check(sorted(n for n, _ in done.values())
              == sorted(sp["max_tokens"] for _, sp in reqs)
              and all(r == "length" for _, r in done.values()),
              f"tiny warmed engine: {done}")
    torch.cuda.synchronize()
    after = dict(runner.graph_counts)
    check(after["captured"] == warm["captured"]
          and after["eager"] == warm["eager"]
          and after["replayed"] > warm["replayed"],
          f"spanning traffic after a full warmup: graphs {warm} -> {after}")
    check(pac.route_counts["decode_simt"] > 0
          and pac.route_counts["prefill_simt"] > 0,
          f"tiny warmed engine: routes {pac.route_counts}")
    drain(engine, [(list(range(4, 11)), dict(
        max_tokens=3, temperature=0.0, repetition_penalty=1.3,
        presence_penalty=0.5))])
    pen = dict(runner.graph_counts)
    check(pen["captured"] <= after["captured"] + 1,
          f"penalized request after a full warmup: graphs {after} -> {pen}")
    log(f"[phase 4d] {engine.model_cfg.name} on {DEV} with warmup='full': "
        f"{summary['buckets_compiled']}/{summary['buckets_total']} buckets, "
        f"{warm['captured']} graphs ({runner.graph_pool_bytes / 2**20:.1f} MiB "
        f"pool) in {summary['seconds']}s; spanning traffic: "
        f"{after['replayed'] - warm['replayed']} replays, 0 captures, launches "
        f"decode {pac.route_counts['decode_simt']}, prefill "
        f"{pac.route_counts['prefill_simt']}; a penalized request: "
        f"{pen['captured'] - after['captured']} capture")
    out = {"warmup": summary, "after_warmup": warm, "after_traffic": after,
           "after_penalized": pen, "pool_bytes": runner.graph_pool_bytes}
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_no_host_sync(model, params) -> None:
    """One decode step (with a padding row whose write is dropped), a
    seeded draw (its seeds on the card) with a logit bias, and one prefill
    chunk (with dropped
    tail writes), under CUDA's sync debug mode set to raise: the forward
    and the sampler never make the host wait for the card, so a decode
    burst chains its steps on the device. Also holds the bf16 unembed to
    a float32 product of the same operands (its accumulator is kept)."""
    cfg = model.cfg
    B, V = 4, cfg.vocab_size
    cache, dec, pre = step_inputs(model, B, 256, 64, BS, DEV)
    drop = cache.shape[1] * BS
    dec, pre = [t.clone() for t in dec], [t.clone() for t in pre]
    dec[2][B - 1] = drop  # write_idx of a padding row ...
    dec[4][B - 1] = 0  # ... with no live key
    pre[2][0, -8:] = drop  # a padded tail
    f32 = dict(dtype=torch.float32, device=DEV)
    sampling = (torch.full((B,), 0.8, **f32), torch.full((B,), 0.9, **f32),
                torch.full((B,), 50, dtype=torch.int32, device=DEV),
                torch.zeros(B, **f32), torch.arange(B, device=DEV))
    bias_ids = torch.tensor([[5, V]] * B, dtype=torch.int32, device=DEV)
    bias_vals = torch.tensor([[3.0, 1.0]] * B, **f32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.forward(params, *dec, cache)
        packed = sample_tokens_packed(
            apply_logit_bias(logits, bias_ids, bias_vals), *sampling)
        model.forward(params, *pre, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(packed.shape == (B, 1) and bool(torch.isfinite(logits).all()),
          "no-sync step: bad output")
    log("  decode step, sampling with a logit bias and a prefill chunk ran "
        "with no host sync (CUDA sync debug mode 'error')")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    x = torch.randn((8, cfg.hidden_size), generator=gen, device=DEV).to(
        cfg.torch_dtype)
    w = params["lm_head"] if "lm_head" in params else params["embed"]
    got = unembed_logits(x, w)
    ref = x.float() @ w.float().t()
    err = float((got - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())  # one bf16 rounding would be ~2e-3
    log(f"  unembed {tuple(w.shape)} {w.dtype}: {got.dtype} out, max|err| vs "
        f"float32 product {err:.3e} (tol {tol:.3e})")
    check(got.dtype == torch.float32 and err <= tol,
          "unembed: logits lost their float32 accumulator")


def phase_step_times(model, params, tag: str = "",
                     impls=("cuda", "gather"), kv_dtype=None) -> dict:
    """Device time of one whole-model step at the timed kernels' shapes
    (decode: 8 rows at position 4095; prefill: one fresh 512-token chunk),
    through the kernels and through the gather path."""
    cfg = model.cfg
    B, ctx, T = 8, 4096, 512
    cache, dec, pre = step_inputs(model, B, ctx, T, BS, DEV, kv_dtype)
    out = {}
    for impl in impls:
        for name, args in (("decode_step", dec), ("prefill_step", pre)):
            out[f"{tag}{name}_{impl}_ms"] = step_ms(
                lambda: model.forward(params, *args, cache, attn_impl=impl))
    log(f"[phase 3{'b' if tag else ''}] one {cfg.num_layers}-layer {tag}step "
        f"(B={B} decode at {ctx} ctx; T={T} fresh prefill): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def dequantized_copy(params):
    """The tree with its int4 and per-layer int8 leaves dequantized to bf16
    beforehand (a layer at a time): the function the JAX package's XLA
    fallback computes. embed/lm_head keep their per-row int8."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {}
    for k, v in params["layers"].items():
        if k.endswith(("_q4s", QUANT_SUFFIX)):
            continue
        s4 = params["layers"].get(k + "_q4s")
        s8 = params["layers"].get(k + QUANT_SUFFIX)
        if s4 is None and s8 is None:
            layers[k] = v
            continue
        rows = 2 * v.shape[1] if s4 is not None else v.shape[1]
        w = torch.empty((v.shape[0], rows, v.shape[2]),
                        dtype=torch.bfloat16, device=DEV)
        for i in range(v.shape[0]):
            w[i] = (i4.dequant_int4(v[i], s4[i], torch.bfloat16)
                    if s4 is not None else
                    (v[i].float() * s8[i][None, :]).bfloat16())
        layers[k] = w
    out["layers"] = layers
    return out


def phase_int4_model(model):
    """Llama-3-8B int4, streamed on the card; one 512-token prefill and 8
    decode steps through the int4 and decode-write kernels, against the
    gather path on the dequantized tree."""
    cfg = model.cfg
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init_params(gen, DEV, quantization="int4")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    proj = sum(v.numel() * v.element_size() for k, v in params["layers"].items()
               if k.startswith("w"))
    top = sum(params[k].numel() + params[k + "_qs"].numel() * 4
              for k in ("embed", "lm_head"))
    log(f"[phase 3b] {MODEL} int4 on {DEV} in {time.perf_counter() - t0:.1f}s: "
        f"resident weights {nbytes / 1e9:.3f} GB (projections + group scales "
        f"{proj / 1e9:.3f} GB, int8 embed/lm_head + scales {top / 1e9:.3f} GB); "
        f"peak allocated while drawing {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
    check(4.3e9 < nbytes < 5.3e9, f"int4 tree holds {nbytes} bytes")

    os.environ["PST_FUSED_KV_WRITE"] = "1"
    prompt, decode_tokens = model_prompt(cfg)
    reset_launch_counts()
    got, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    counts = launch_counts()
    L, n = cfg.num_layers, len(decode_tokens)
    want = {"prefill": L, "decode": 0, "decode_write": L * n,
            "int4": 7 * L * (1 + n)}
    check(counts == want, f"launch counts {counts}, expected {want}")
    # The 512-token prefill's projections take the wgmma kernel (and a
    # split-sum pass where its plan splits), the decode steps' (2 rows) the
    # decode route, whose splits add up in the same launch: no sum pass.
    routes = dict(i4.route_counts)
    sums = L * sum(i4.plan("wgmma", len(prompt), din, dout, 128).splits > 1
                   for din, dout in LAYER_SHAPES)
    want = {"wgmma": 7 * L, "decode": 7 * L * n, "simt": 0, "sum": sums}
    check(routes == want, f"int4 routes {routes}, expected {want}")
    check(pac.route_counts["decode_write_split"] == L * n,
          f"decode-write routes {pac.route_counts}: expected the split kernel")
    ref_params = dequantized_copy(params)
    ref, _ = drive_model(model, ref_params, "gather", prompt, decode_tokens)
    del ref_params
    torch.cuda.empty_cache()
    check(got.shape == (1 + n, cfg.vocab_size),
          f"int4 model: logits shape {tuple(got.shape)}")
    log(f"  int4, PST_FUSED_KV_WRITE=1: 512-token prefill + {n} decode steps, "
        f"launches {counts}; against the dequantized gather path: "
        f"{agree(got, ref, 'int4 model')}")

    # The fused int4 decode step makes the host wait for nothing either.
    cache, dec, _ = step_inputs(model, 4, 256, 64, BS, DEV)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.forward(params, *dec, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(logits).all()), "int4 no-sync step: bad output")
    log("  int4 fused decode step ran with no host sync")
    return params, {"decode": routes["decode"] // n, "wgmma": routes["wgmma"],
                    "decode_write": counts["decode_write"] // n}


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------


def _call(port: int, method: str, path: str, body=None,
          timeout: float = 300.0, headers=None):
    """One request: its status, its body (parsed when JSON) and headers."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    headers = dict(resp.getheaders())
    if headers.get("Content-Type", "").startswith("application/json"):
        return resp.status, json.loads(raw), headers
    return resp.status, raw.decode(), headers


def _sse(port: int, path: str, body: dict) -> list:
    """The JSON frames of a streamed answer (the last with its usage)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(
        {**body, "stream": True, "stream_options": {"include_usage": True}}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    check(resp.status == 200, f"{path} stream: HTTP {resp.status}")
    frames = [ln[len(b"data: "):].strip() for ln in resp.read().split(b"\n")
              if ln.startswith(b"data: ")]
    conn.close()
    check(frames and frames[-1] == b"[DONE]", f"{path} stream: no [DONE]")
    return [json.loads(f) for f in frames[:-1]]


def _completion(port: int, body: dict, want_tokens: int) -> dict:
    status, out, _ = _call(port, "POST", "/v1/completions", body)
    check(status == 200, f"completion: HTTP {status}: {out}")
    ch = out["choices"][0]
    check(out["usage"]["completion_tokens"] == want_tokens,
          f"completion: {out['usage']} != {want_tokens} tokens")
    check(ch["finish_reason"] == "length",
          f"completion: finish_reason {ch['finish_reason']!r}")
    return out


def _stream(port: int, body: dict, want_tokens: int) -> dict:
    """A streamed completion of ``want_tokens`` frames; returns its final
    usage chunk."""
    chunks = _sse(port, "/v1/completions", body)
    check(len(chunks) == want_tokens,
          f"stream: {len(chunks)} frames for {want_tokens} tokens")
    check(chunks[-1]["choices"][0]["finish_reason"] == "length",
          "stream: last frame has no finish_reason 'length'")
    return chunks[-1].get("usage") or {}


def launch_counts() -> dict:
    return {**pac.launch_counts, **i4.launch_counts}


def route_counts() -> dict:
    """Launches by kernel; the int4 wrapper's routes carry an ``int4_``
    prefix (its ``decode`` route is not the attention wrapper's)."""
    return {**pac.route_counts,
            **{f"int4_{k}": n for k, n in i4.route_counts.items()}}


def reset_launch_counts() -> None:
    pac.reset_launch_counts()
    i4.reset_launch_counts()


def wait_ready(port: int, limit: float = 600.0) -> dict:
    """Poll ``/ready`` until it answers 200 (503 ``"warming"`` meanwhile);
    returns its body."""
    t0 = time.perf_counter()
    while True:
        status, body, _ = _call(port, "GET", "/ready")
        if status == 200:
            return body
        check(status == 503 and body["reason"] == "warming"
              and time.perf_counter() - t0 < limit,
              f"/ready: {status} {body}")
        time.sleep(0.1)


def phase_serving(params, label: str, quantization=None, kv_cache_dtype=None,
                  used=("decode", "decode_split", "prefill",
                        "prefill_wgmma"), model=MODEL, warmup="off") -> dict:
    """Four completions through the server of ``model``, configured by the
    server's own flags; the kernels in ``used`` (by wrapper, and by route)
    must have launched while serving and no other kernel may have. Steps
    replay CUDA graphs: each key captured on first use (or at warmup) and
    replayed after, the launch counts added by the replays. With
    ``warmup``, the warmup is held until ``/ready``, ``/health`` and a
    completion have answered as warming, then ``/ready`` must answer 200
    with its summary. Returns both counts, the engine's page count (as
    ``"pages"``), its graph counts, pool bytes and warmup summary."""
    argv = ["--model", model, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--num-decode-steps", "4",
            "--max-num-seqs", "16", "--warmup", warmup]
    if quantization:
        argv += ["--quantization", quantization]
    if kv_cache_dtype:
        argv += ["--kv-cache-dtype", kv_cache_dtype]
    cfg = engine_config_from_args(parse_engine_args(argv))
    t0 = time.perf_counter()
    engine = AsyncLLMEngine(cfg, params=params)
    runner = engine.engine.runner
    gate = threading.Event()
    if warmup != "off":
        precompile = engine.engine.precompile

        def held_precompile():
            check(gate.wait(timeout=300), "the warmup gate never opened")
            return precompile()

        engine.engine.precompile = held_precompile
    log(f"[phase {label}] {model} engine up in "
        f"{time.perf_counter() - t0:.1f}s "
        f"({quantization or 'bf16'} weights, {runner.param_bytes / 1e9:.3f} "
        f"GB; PST_FUSED_KV_WRITE={os.environ.get('PST_FUSED_KV_WRITE')}): "
        f"{runner.num_blocks} KV pages x {cfg.block_size} tokens in "
        f"{runner.kv_cache.dtype}, "
        f"max_prefill_tokens {cfg.max_prefill_tokens}, "
        f"num_decode_steps {cfg.num_decode_steps}")
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    summary = None
    try:
        if warmup != "off":
            status, body, _ = _call(port, "GET", "/ready")
            check(status == 503 and body["reason"] == "warming",
                  f"/ready while warming: {status} {body}")
            status, health, _ = _call(port, "GET", "/health")
            check(status == 200 and health["status"] == "warming",
                  f"/health while warming: {status} {health}")
            status, _, headers = _call(port, "POST", "/v1/completions",
                                       {"prompt": "hi", "max_tokens": 1})
            check(status == 503 and headers.get("X-PST-Warming") == "1",
                  f"completion while warming: {status}")
            gate.set()
            t1 = time.perf_counter()
            summary = wait_ready(port)["warmup"]
            check(summary["mode"] == warmup
                  and summary["buckets_compiled"] > 0
                  and "error" not in summary
                  and engine.warmup_error is None,
                  f"warmup: {summary} ({engine.warmup_error})")
            log(f"  /ready 503 'warming' (health 200 'warming', completion "
                f"503 X-PST-Warming: 1), then 200 after "
                f"{time.perf_counter() - t1:.1f}s: {summary}; graphs "
                f"{runner.graph_counts}, pool "
                f"{runner.graph_pool_bytes / 2**20:.1f} MiB")
        status, health, _ = _call(port, "GET", "/health")
        check(status == 200, f"/health: {status} {health}")
        status, models, _ = _call(port, "GET", "/v1/models")
        check(status == 200 and models["data"][0]["id"] == model,
              f"/v1/models: {status} {models}")

        reset_launch_counts()
        t0 = time.perf_counter()
        n_req = 0
        long_prompt = ("The quick brown fox jumps over the lazy dog. " * 40)[:1500]
        out = _completion(port, {"prompt": long_prompt, "max_tokens": 24,
                                 "temperature": 0.0, "ignore_eos": True}, 24)
        check(out["usage"]["prompt_tokens"] == 1500
              and 1500 > cfg.max_prefill_tokens,
              "long prompt must be chunked over several prefill steps")
        n_req += 1
        _stream(port, {"prompt": "Once upon a time", "max_tokens": 20,
                       "temperature": 0.0, "ignore_eos": True}, 20)
        n_req += 1
        results: dict = {}

        def worker(i: int) -> None:
            try:
                results[i] = _completion(port, {
                    "prompt": f"Request {i}: tell me about paged attention.",
                    "max_tokens": 16 + 4 * i, "temperature": 0.8,
                    "top_p": 0.9, "top_k": 50, "seed": 100 + i,
                    "ignore_eos": True}, 16 + 4 * i)
            except BaseException as e:  # re-raised on the main thread
                results[i] = e

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(2):
            if isinstance(results[i], BaseException):
                raise results[i]
        n_req += 2
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**launch_counts(), **route_counts()}
        check(engine.is_healthy(), f"engine failed: {engine.step_error}")
        pages = runner.num_blocks
        graphs = dict(runner.graph_counts)
        pool = runner.graph_pool_bytes
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    log(f"  {n_req} completions served in {wall:.2f}s; kernel launches "
        f"during serving: {counts}; graphs {graphs}, pool "
        f"{pool / 2**20:.1f} MiB")
    check(n_req >= 4, "fewer than 4 completions served")
    check(graphs["replayed"] > 0 and graphs["eager"] == graphs["captured"],
          f"serving: graph counts {graphs}")
    for k, n in counts.items():
        if k in used:
            check(n > 0, f"serving never launched the {k} kernel")
        else:
            check(n == 0, f"serving launched the {k} kernel {n} times")
    del engine, runner
    return {**counts, "pages": pages, "graphs": graphs,
            "graph_pool_bytes": pool, "warmup": summary}


# Phase 3z: a checkpoint written and served.

CKPT_LAYERS = 4
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "hf_checkpoint_smoke")
# Llama-3.1-8B's rope scaling, which the llama-3-8b preset lacks: written
# into config.json so the loaded config takes the llama3 path.
LLAMA31_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192}


def write_safetensors(tensors: dict, path: str) -> None:
    """bf16 ``tensors`` (on any device) as one safetensors file: the
    header's length (8 bytes, little-endian), the JSON header padded to 8
    bytes, then the buffers back to back in name order."""
    header, offset = {}, 0
    for k in sorted(tensors):
        n = tensors[k].numel() * 2
        header[k] = {"dtype": "BF16", "shape": list(tensors[k].shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in sorted(tensors):
            f.write(tensors[k].contiguous().cpu().view(torch.int16)
                    .numpy().data)


def write_checkpoint(cfg, gen) -> dict:
    """``CKPT_DIR``: an HF Llama checkpoint of ``cfg``'s widths and
    ``CKPT_LAYERS`` layers, random bf16 weights from ``gen`` in HF names
    and ``[out, in]`` layout, in two shards with an index, and its
    config.json. Returns the source tensors (on the card) by HF name."""
    os.makedirs(CKPT_DIR, exist_ok=True)
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def w(out, inp):
        return (torch.randn(out, inp, generator=gen, device=DEV)
                / inp ** 0.5).to(torch.bfloat16)

    def norm(n):
        return (1 + 0.05 * torch.randn(n, generator=gen, device=DEV)).to(
            torch.bfloat16)

    src = {"model.embed_tokens.weight": w(V, D)}
    for i in range(CKPT_LAYERS):
        p = f"model.layers.{i}."
        src[p + "input_layernorm.weight"] = norm(D)
        src[p + "self_attn.q_proj.weight"] = w(cfg.q_size, D)
        src[p + "self_attn.k_proj.weight"] = w(cfg.kv_size, D)
        src[p + "self_attn.v_proj.weight"] = w(cfg.kv_size, D)
        src[p + "self_attn.o_proj.weight"] = w(D, cfg.q_size)
        src[p + "post_attention_layernorm.weight"] = norm(D)
        src[p + "mlp.gate_proj.weight"] = w(Fi, D)
        src[p + "mlp.up_proj.weight"] = w(Fi, D)
        src[p + "mlp.down_proj.weight"] = w(D, Fi)
    src["model.norm.weight"] = norm(D)
    src["lm_head.weight"] = w(V, D)
    names = list(src)
    half = len(names) // 2
    weight_map = {}
    for k, part in enumerate((names[:half], names[half:])):
        f = f"model-{k + 1:05d}-of-00002.safetensors"
        write_safetensors({n: src[n] for n in part},
                          os.path.join(CKPT_DIR, f))
        weight_map.update({n: f for n in part})
    with open(os.path.join(CKPT_DIR, INDEX_FILE), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    hf = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
          "vocab_size": V, "hidden_size": D, "intermediate_size": Fi,
          "num_hidden_layers": CKPT_LAYERS,
          "num_attention_heads": cfg.num_heads,
          "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
          "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
          "max_position_embeddings": cfg.max_position_embeddings,
          "tie_word_embeddings": cfg.tie_word_embeddings,
          "hidden_act": cfg.hidden_act, "rope_scaling": LLAMA31_ROPE,
          "eos_token_id": list(cfg.eos_token_ids),
          "bos_token_id": cfg.bos_token_id, "torch_dtype": "bfloat16"}
    with open(os.path.join(CKPT_DIR, "config.json"), "w") as f:
        json.dump(hf, f)
    return src


def source_tree(cfg, src) -> dict:
    """The port's parameter tree of the source tensors, built in memory:
    ``[out, in]`` transposed, layers stacked."""
    layer = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj", "attn_norm": "input_layernorm",
             "mlp_norm": "post_attention_layernorm"}
    tree = {"embed": src["model.embed_tokens.weight"],
            "final_norm": src["model.norm.weight"],
            "lm_head": src["lm_head.weight"], "layers": {}}
    for ours, hf in layer.items():
        parts = [src[f"model.layers.{i}.{hf}.weight"]
                 for i in range(cfg.num_layers)]
        tree["layers"][ours] = torch.stack(
            [t.T if t.dim() == 2 else t for t in parts]).contiguous()
    return tree


def tree_mismatch(got: dict, want: dict, prefix: str = "") -> list:
    """Leaves of two trees that differ in name, shape, type or bits."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        if isinstance(want[k], dict):
            bad += tree_mismatch(got[k], want[k], prefix + k + ".")
        elif not same_bits(got[k].to(DEV), want[k].to(DEV)):
            bad.append(prefix + k)
    return bad


def runner_rows(runner, prompt) -> tuple:
    """A 512-token prefill and a 4-token decode burst through the runner's
    entry points; (the rows of both, the KV cache after them)."""
    seq = Sequence("z", prompt, SamplingParams(temperature=0.0,
                                               ignore_eos=True))
    seq.block_ids = list(range(-(-len(prompt) // BS) + 1))
    first = runner.execute_prefill_batch([PrefillItem(seq, 0, len(prompt))])
    seq.num_computed_tokens = len(prompt)
    seq.output_token_ids.append(int(first[0][0]))
    burst = runner.execute_decode_multi([seq], 4)
    torch.cuda.synchronize()
    return first, burst, runner.kv_cache.clone()


def phase_checkpoint(card: str) -> dict:
    """Phase 3z: a Llama-3-8B-shaped HF checkpoint (full width, depth cut
    to ``CKPT_LAYERS`` layers to bound the disk written) written from a
    seed, loaded in bf16 (bit for bit the source tensors) and int4 (the
    card's leaves bit for bit the CPU loader's), run through the runner
    against the in-memory source tree, and served by a server started with
    ``--model <dir>``. The directory is removed afterwards."""
    base = get_model_config(MODEL)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(31)
    t0 = time.perf_counter()
    src = write_checkpoint(base, gen)
    nbytes = sum(os.path.getsize(os.path.join(CKPT_DIR, f))
                 for f in os.listdir(CKPT_DIR))
    log(f"[phase 3z] {MODEL}-shaped HF checkpoint: {CKPT_LAYERS} of "
        f"{base.num_layers} layers (depth cut to bound the disk written), "
        f"{nbytes / 1e9:.3f} GB in 2 safetensors shards + index, written in "
        f"{time.perf_counter() - t0:.1f}s; config.json from the preset's "
        f"fields with Llama-3.1's llama3 rope scaling (factor 8)")
    try:
        cfg = get_model_config(CKPT_DIR)
        check(cfg == dataclasses.replace(
            base, num_layers=CKPT_LAYERS, name=CKPT_DIR,
            rope_scaling_factor=8.0, rope_original_max_position=8192),
            f"3z: config from config.json {cfg}")
        want = source_tree(cfg, src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = llama_mod.load_hf_params(cfg, CKPT_DIR, device=DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = tree_mismatch(loaded, want)
        check(not bad, f"3z: bf16 leaves differ from the source: {bad}")
        del loaded
        log(f"  bf16 load: {load_s:.2f}s, {nbytes / load_s / 1e9:.2f} GB/s "
            f"(files in the page cache the write left); every leaf equals "
            f"the source tensors bit for bit")
        t0 = time.perf_counter()
        q_card = llama_mod.load_hf_params(cfg, CKPT_DIR, quantize="int4",
                                          device=DEV)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        q_cpu = llama_mod.load_hf_params(
            dataclasses.replace(cfg, num_layers=1), CKPT_DIR,
            quantize="int4", device="cpu")
        cpu_s = time.perf_counter() - t0
        first_layer = dict(q_card, layers={k: v[:1] for k, v in
                                           q_card["layers"].items()})
        bad = tree_mismatch(first_layer, q_cpu)
        check(not bad, f"3z: int4 leaves on the card differ from the CPU "
                       f"loader's: {bad}")
        del q_card, q_cpu, first_layer
        log(f"  int4 load on the card {q_s:.2f}s; the CPU loader's leaves "
            f"(embed, lm_head, norm and layer 0; {cpu_s:.1f}s) equal the "
            f"card's bit for bit")

        ecfg = EngineConfig(model=CKPT_DIR, device=DEV.type, max_num_seqs=1,
                            max_prefill_tokens=512, max_model_len=1024,
                            num_decode_steps=4, num_kv_blocks=40)
        prompt = np.random.default_rng(8).integers(
            0, cfg.vocab_size, 512).tolist()
        runner = ModelRunner(ecfg)
        got = runner_rows(runner, prompt)
        del runner
        ref = runner_rows(ModelRunner(ecfg, params=want), prompt)
        check(np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
              and same_bits(got[2], ref[2]),
              "3z: the runner on the loaded weights differs from the "
              "in-memory source tree")
        del got, ref, want, src
        gc.collect()
        torch.cuda.empty_cache()
        log("  a 512-token prefill and a 4-token burst through the runner "
            "on the loaded weights equal the in-memory tree's (rows and "
            "cache bytes)")

        # The directory has no tokenizer files; the card's machine has
        # transformers, whose AutoTokenizer builds one from config.json
        # alone, so the byte tokenizer is named.
        argv = ["--model", CKPT_DIR, "--tokenizer", "byte",
                "--device", DEV.type, "--max-model-len", "1024",
                "--num-kv-blocks", "64", "--max-num-seqs", "4",
                "--num-decode-steps", "4"]
        scfg = engine_config_from_args(parse_engine_args(argv))
        body = {"prompt": "The checkpoint says", "max_tokens": 12,
                "temperature": 0.0, "ignore_eos": True}
        local = LLMEngine(scfg)
        check(type(local.tokenizer).__name__ == "ByteTokenizer",
              f"3z: tokenizer {type(local.tokenizer).__name__}")
        want_ids = local.generate([body["prompt"]], SamplingParams(
            max_tokens=12, temperature=0.0, ignore_eos=True))[0]["token_ids"]
        del local
        gc.collect()
        torch.cuda.empty_cache()
        engine = AsyncLLMEngine(scfg)
        seen = []
        generate = engine.generate

        def recording_generate(*args, **kw):
            for out in generate(*args, **kw):
                seen.extend(out.new_token_ids)
                yield out

        engine.generate = recording_generate
        server, thread = serve_in_thread(engine)
        port = server.server_address[1]
        try:
            status, models, _ = _call(port, "GET", "/v1/models")
            check(status == 200 and models["data"][0]["id"] == CKPT_DIR,
                  f"3z /v1/models: {status} {models}")
            _completion(port, body, 12)
        finally:
            server.shutdown()
            server.server_close()
            engine.shutdown()
            thread.join(timeout=10)
        check(seen == want_ids, f"3z: the server's tokens {seen} differ from "
                                f"the in-process engine's {want_ids}")
        log(f"  a server started with --model {CKPT_DIR} --tokenizer byte "
            f"answered a greedy completion with the in-process engine's "
            f"{len(want_ids)} tokens")
        del engine
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": card, "layers": CKPT_LAYERS, "bytes": nbytes,
            "bf16_load_s": load_s, "bf16_load_gb_per_s": nbytes / load_s / 1e9,
            "int4_load_s": q_s}


# Phase 4g: a pipelining server at full width.


def serve_streams(params, argv: list, n_req: int, n_tok: int,
                  streamed=None) -> dict:
    """One server of ``argv`` over ``params``: ``n_req`` concurrent greedy
    requests of ``n_tok`` tokens (streamed, or those whose index is in
    ``streamed``), once to capture the graphs and once timed. In each
    round the step loop waits until all the round's requests are in, so
    both servers step the same batches (a random bf16 model's greedy
    tokens turn on the batch shapes' rounding). Returns the timed round's
    tokens by prompt, wall, host gaps, launch counts, scraped /metrics
    (and before it), the requests' costs (a stream's final usage chunk's
    ``pst_cost``), ``/debug/flight`` of the whole ring and graph counts;
    the first round's tokens and the graph counts after it as
    ``warm_tokens`` and ``warm_graphs``."""
    args = parse_engine_args(argv)
    engine = AsyncLLMEngine(engine_config_from_args(args), params=params)
    llm = engine.engine
    seen: dict = {}
    generate, add, step = engine.generate, llm.add_request, llm.step
    all_in = threading.Event()

    def recording_generate(*args, prompt_token_ids=None, **kw):
        rec = seen[tuple(prompt_token_ids)] = []
        for o in generate(*args, prompt_token_ids=prompt_token_ids, **kw):
            rec.extend(o.new_token_ids)
            yield o

    def counting_add(*args, **kw):
        seq = add(*args, **kw)
        if llm.scheduler.num_waiting + llm.scheduler.num_running >= n_req:
            all_in.set()
        return seq

    def gated_step():
        if not all_in.wait(timeout=0.01):
            return []
        return step()

    engine.generate = recording_generate
    llm.add_request, llm.step = counting_add, gated_step
    gaps = []
    record_gap = llm.runner.telemetry.record_host_gap

    def spy_gap(bucket, seconds):
        gaps.append(seconds)
        record_gap(bucket, seconds)

    llm.runner.telemetry.record_host_gap = spy_gap
    server, thread = serve_in_thread(engine, **app_options_from_args(args))
    port = server.server_address[1]
    costs = []

    def one(i, errors):
        body = {"prompt": f"Request {i}: a story about "
                          f"{'paged ' * i}attention.",
                "max_tokens": n_tok, "temperature": 0.0, "ignore_eos": True}
        try:
            if streamed is None or i in streamed:
                usage = _stream(port, body, n_tok)
            else:
                usage = _completion(port, body, n_tok)["usage"]
            costs.append(usage.get("pst_cost"))
        except BaseException as e:  # re-raised below
            errors.append(e)

    def traffic():
        all_in.clear()
        errors = []
        threads = [threading.Thread(target=one, args=(i, errors))
                   for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    try:
        traffic()  # captures this traffic's graphs
        warm = ({k: list(v) for k, v in seen.items()},
                dict(llm.runner.graph_counts))
        reset_launch_counts()
        gaps.clear()
        costs.clear()
        before = scrape(port)
        t0 = time.perf_counter()
        traffic()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**launch_counts(), **route_counts()}
        samples = scrape(port)
        status, flight, _ = _call(port, "GET", "/debug/flight?n=100000")
        check(status == 200, f"4g /debug/flight: {status}")
        check(engine.is_healthy(), f"4g: {engine.step_error}")
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    return {"tokens": dict(seen), "wall": wall, "gaps": list(gaps),
            "counts": counts, "samples": samples, "before": before,
            "costs": list(costs), "flight": flight,
            "lattice": {b.label for b in enumerate_lattice(llm.cfg)},
            "graphs": dict(llm.runner.graph_counts),
            "warm_tokens": warm[0], "warm_graphs": warm[1]}


def audit_diagnostics(label: str, r: dict, n_req: int) -> dict:
    """Phase 4g's audit of one server's timed round: the streams' costs
    sum to within 0.90-1.10 of the growth of
    ``pst_engine_device_busy_seconds`` (the JAX cost-parity bounds; a
    wall segment charged twice reads well above 1.0), each request
    observed one decode cost, and the flight ring holds one row for each
    live step (every step of a server without warmup), up to its size,
    in the lattice's buckets."""
    m, before = r["samples"], r["before"]
    busy = (m["pst_engine_device_busy_seconds_total"]
            - before["pst_engine_device_busy_seconds_total"])
    check(len(r["costs"]) == n_req and all(r["costs"]),
          f"4g {label}: streams without usage.pst_cost: {r['costs']}")
    cost = sum(c["device_s"] for c in r["costs"])
    frac = cost / busy
    check(0.90 <= frac <= 1.10,
          f"4g {label}: request costs {cost:.6f}s over device busy "
          f"{busy:.6f}s = {frac:.4f}, outside 0.90-1.10")
    key = 'pst_request_device_seconds_count{phase="decode"}'
    decoded = m.get(key, 0.0) - before.get(key, 0.0)
    check(decoded == n_req,
          f"4g {label}: {decoded} decode costs observed for {n_req} requests")
    flight = r["flight"]
    live = (m.get("pst_engine_step_duration_seconds_count", 0.0)
            + m.get("pst_engine_compile_total", 0.0))
    rows = flight["records"]
    check(flight["total_steps"] == live
          and len(rows) == min(live, flight["capacity"])
          and {row["bucket"] for row in rows} <= r["lattice"],
          f"4g {label}: flight ring {flight['total_steps']} steps, "
          f"{len(rows)} rows of {flight['capacity']}, against {live:.0f} "
          f"live steps; buckets {sorted({row['bucket'] for row in rows})}")
    log(f"  4g {label}: request costs {cost:.6f}s over device busy "
        f"{busy:.6f}s = {frac:.4f}; {decoded:.0f} decode costs observed; "
        f"flight ring {len(rows)} rows of {flight['total_steps']:.0f} live "
        f"steps (capacity {flight['capacity']}), "
        f"{len({row['bucket'] for row in rows})} buckets, all in the lattice")
    return {"cost_over_busy": frac, "cost_s": cost, "busy_s": busy,
            "flight_rows": len(rows)}


def phase_pipelined_serving(params, card: str) -> dict:
    """Phase 4g: the bf16 Llama-3-8B server of phase 4's flags with
    ``--adaptive-decode-quiet-s 0 --adaptive-decode-steps 8``, then the
    same with ``--no-overlap-decode``, then the pipelined one again with
    its diagnostics off (``--no-tracing --no-cost-attribution
    --flight-buffer 0``): 8 concurrent greedy streamed requests of 128
    tokens, once to capture the graphs and once timed (one run each).
    Tokens equal between the three servers; the pipelined ones count
    pipelined and adaptive deep bursts in /metrics and record 0-valued
    host gaps; the kernels' launch counters grow; the first two pass the
    diagnostics audit (``audit_diagnostics``), the third bills and records
    nothing."""
    n_req, n_tok = 8, 128
    out, tokens = {}, {}
    for label, extra in (("pipelined", []),
                         ("synchronous", ["--no-overlap-decode"]),
                         ("diagnostics_off", ["--no-tracing",
                                              "--no-cost-attribution",
                                              "--flight-buffer", "0"])):
        argv = ["--model", MODEL, "--device", DEV.type,
                "--max-num-batched-tokens", "512", "--num-decode-steps", "4",
                "--max-num-seqs", "16", "--adaptive-decode-quiet-s", "0",
                "--adaptive-decode-steps", "8", *extra]
        r = serve_streams(params, argv, n_req, n_tok)
        gc.collect()  # the server's engine and KV cache, before the next
        torch.cuda.empty_cache()
        tokens[label] = r["tokens"]
        counts, samples, gaps = r["counts"], r["samples"], r["gaps"]
        check(counts.get("decode_split", 0) > 0
              and counts.get("prefill_wgmma", 0) > 0,
              f"4g {label}: launch counters did not grow: {counts}")
        pipelined = samples.get("pst:pipelined_bursts_total", 0.0)
        deep = samples.get("pst:adaptive_deep_bursts_total", 0.0)
        zeros = sum(1 for g in gaps if g == 0.0)
        out[label] = {
            "output_tok_per_s": n_req * n_tok / r["wall"], "wall_s": r["wall"],
            "host_gap_p50_ms": (statistics.median(gaps) * 1e3
                                if gaps else None),
            "host_gaps": len(gaps), "zero_host_gaps": zeros,
            "pipelined_bursts": pipelined, "adaptive_deep_bursts": deep,
            "graphs": r["graphs"]}
        log(f"[phase 4g] {label} server (one run): {n_req} x {n_tok} "
            f"streamed tokens in {r['wall']:.3f}s, "
            f"{out[label]['output_tok_per_s']:.1f} output tok/s, host gap "
            f"p50 {out[label]['host_gap_p50_ms']} ms over {len(gaps)} gaps "
            f"({zeros} of them 0); pst:pipelined_bursts {pipelined:.0f}, "
            f"pst:adaptive_deep_bursts {deep:.0f}; {card}")
        if label == "diagnostics_off":
            check(r["costs"] == [None] * n_req
                  and r["flight"]["total_steps"] == 0
                  and r["flight"]["records"] == [],
                  f"4g {label}: billed {r['costs']} or recorded "
                  f"{r['flight']['total_steps']} flight steps")
        else:
            out[label]["diagnostics"] = audit_diagnostics(label, r, n_req)
    for label in ("pipelined", "diagnostics_off"):
        p = out[label]
        check(p["pipelined_bursts"] > 0 and p["adaptive_deep_bursts"] > 0,
              f"4g: {label} server counters {p}")
        check(p["zero_host_gaps"] > 0,
              f"4g: {label}: no 0-valued host gap recorded")
    check(out["synchronous"]["pipelined_bursts"] == 0,
          "4g: the --no-overlap-decode server pipelined")
    check(len(tokens["pipelined"]) == n_req
          and tokens["pipelined"] == tokens["synchronous"]
          == tokens["diagnostics_off"],
          "4g: the three servers' tokens differ")
    log(f"  4g: the three servers' {n_req} x {n_tok} tokens equal; output "
        f"tok/s with the diagnostics on (the defaults) "
        f"{out['pipelined']['output_tok_per_s']:.1f}, off "
        f"{out['diagnostics_off']['output_tok_per_s']:.1f} (one run each); "
        f"{card}")
    return out


# Phase 4s: n-gram speculative decoding on a served path.


def chat_prompt(i: int) -> str:
    """A multi-round chat whose last user turn re-quotes the assistant's
    earlier answer, as multi-round QA traffic re-quotes its history."""
    answer = (f"Paged attention keeps conversation {i}'s keys and values "
              f"in fixed-size blocks of {8 * (i + 1)} tokens, so memory is "
              "allocated as the context grows.")
    return (f"User: conversation {i}. What is paged attention?\n"
            f"Assistant: {answer}\n"
            f"User: You said: \"{answer}\" Say it again, word for word.\n"
            "Assistant:")


def serve_rounds(params, argv: list, n_req: int, n_tok, rounds: tuple,
                 setup=None, logprobs: bool = False, during=None,
                 after=None) -> tuple:
    """One server of ``argv`` over ``params``: a round per entry of
    ``rounds`` (``"capture"``, ``"timed"`` or ``"logprobs"``, or any name
    ``setup`` knows), each ``n_req`` concurrent greedy streams over
    ``chat_prompt``s, stream i of ``n_tok[i]`` tokens (``n_tok`` an int:
    all alike), the step loop gated until all of a round's requests are
    in. ``setup(kind, llm)`` runs before each round, ``during(kind, port,
    llm)`` on a thread of its own while the round's streams run, and
    ``after(port, engine)`` once the rounds are done, before the server
    stops (its result is the info's ``"after"``). A ``logprobs`` round
    (every round with ``logprobs``) asks for the top 2 and keeps each
    position's top 2 and their gap, which is the gap of the logits. For
    each round: tokens (gaps and tops) by prompt, wall, launch counts,
    the verify steps (rows, and the prefill and int4 launches inside
    them), the pipelined bursts, /metrics before and after. Also the
    engine's pages and the pages the budget gave just before it was built
    (``"sized"``), its graph counts and pool bytes, and the pool and
    reserved bytes its verify buckets took when captured before
    traffic."""
    n_toks = [n_tok] * n_req if isinstance(n_tok, int) else list(n_tok)
    args = parse_engine_args(argv)
    cfg = engine_config_from_args(args)
    gc.collect()  # the engine sizes its KV pool from the free memory
    torch.cuda.empty_cache()
    sized = resolve_num_kv_blocks(cfg, get_model_config(cfg.model), DEV)
    engine = AsyncLLMEngine(cfg, params=params)
    llm = engine.engine
    runner = llm.runner
    pool = {}
    spec = [b for b in enumerate_lattice(llm.cfg) if b.kind == "spec_verify"]
    if spec:
        before = (runner.graph_pool_bytes, runner._reserved_bytes())
        for b in spec:
            runner.warmup_bucket(b)
        pool = {"buckets": [b.label for b in spec],
                "graph_pool_bytes": runner.graph_pool_bytes - before[0],
                "reserved_bytes": runner._reserved_bytes() - before[1]}
    seen, gaps, tops = {}, {}, {}
    generate, add, step = engine.generate, llm.add_request, llm.step
    all_in = threading.Event()

    def recording_generate(*a, prompt_token_ids=None, **kw):
        key = tuple(prompt_token_ids)
        toks, gap, top = seen[key], gaps[key], tops[key] = [], [], []
        for o in generate(*a, prompt_token_ids=prompt_token_ids, **kw):
            toks.extend(o.new_token_ids)
            for e in o.logprobs or ():
                gap.append(e["top"][0][1] - e["top"][1][1])
                top.append(list(e["top"]))
            yield o

    def counting_add(*a, **kw):
        seq = add(*a, **kw)
        if llm.scheduler.num_waiting + llm.scheduler.num_running >= n_req:
            all_in.set()
        return seq

    def gated_step():
        if not all_in.wait(timeout=0.01):
            return []
        return step()

    verify = []
    execute = runner.execute_spec_verify

    def spy_verify(seqs, drafts):
        c0 = route_counts()
        out = execute(seqs, drafts)
        c1 = route_counts()
        verify.append((len(seqs), {k: n - c0[k] for k, n in c1.items()
                                   if n != c0[k]}))
        return out

    engine.generate = recording_generate
    llm.add_request, llm.step = counting_add, gated_step
    runner.execute_spec_verify = spy_verify
    server, thread = serve_in_thread(engine, **app_options_from_args(args))
    port = server.server_address[1]

    def one(i, lp, errors):
        body = {"prompt": chat_prompt(i), "max_tokens": n_toks[i],
                "temperature": 0.0, "ignore_eos": True}
        if lp:
            body["logprobs"] = 2
        try:
            _stream(port, body, n_toks[i])
        except BaseException as e:  # re-raised below
            errors.append(e)

    out = []
    try:
        for kind in rounds:
            if setup is not None:
                setup(kind, llm)
            all_in.clear()
            seen.clear()
            gaps.clear()
            tops.clear()
            verify.clear()
            reset_launch_counts()
            before = scrape(port)
            bursts = llm.pipelined_bursts_total
            errors = []
            lp = logprobs or kind == "logprobs"
            threads = [threading.Thread(target=one, args=(i, lp, errors))
                       for i in range(n_req)]
            if during is not None:
                def side(kind=kind):
                    try:
                        during(kind, port, llm)
                    except BaseException as e:  # re-raised below
                        errors.append(e)

                threads.append(threading.Thread(target=side))
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if errors:
                raise errors[0]
            out.append({"kind": kind, "tokens": dict(seen),
                        "gaps": dict(gaps), "tops": dict(tops),
                        "bursts": llm.pipelined_bursts_total - bursts,
                        "wall": wall,
                        "counts": {**launch_counts(), **route_counts()},
                        "verify": list(verify), "before": before,
                        "samples": scrape(port)})
        check(engine.is_healthy(), f"4s: {engine.step_error}")
        info = {"pages": runner.num_blocks, "sized": sized,
                "verify_pool": pool,
                "graphs": dict(runner.graph_counts),
                "graph_pool_bytes": runner.graph_pool_bytes}
        if after is not None:
            info["after"] = after(port, engine)
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    return out, info


def first_parting(got: dict, want: dict) -> dict:
    """Each stream's first position whose token (or top-2 logprobs, where
    both runs kept them) differs between two runs' records, by stream
    index; streams that agree are left out."""
    out = {}
    for key in want["tokens"]:
        pairs = [zip(got["tokens"][key], want["tokens"][key])]
        if want["tops"].get(key) and got["tops"].get(key):
            pairs.append(zip(got["tops"][key], want["tops"][key]))
        firsts = [next((j for j, (a, b) in enumerate(p) if a != b), None)
                  for p in pairs]
        firsts = [f for f in firsts if f is not None]
        if firsts or got["tokens"][key] != want["tokens"][key]:
            out[sorted(want["tokens"]).index(key)] = min(firsts, default=-1)
    return out


def rounds_sweep(params, card: str) -> None:
    """``python3 chip_smoke.py rounds``: the bf16 Llama-3-8B server of 4s
    with its defaults (the overlapped decode on its arrival gate) and with
    ``--no-overlap-decode``, five rounds each of 4s's 8 greedy streams
    (the first cold, the third and fifth with top-2 logprobs): for each
    round, each stream's first position whose token differs from the
    second round's, the top-2 logit gap there and the round's pipelined
    bursts. Fails unless each server's warm rounds (the second to the
    fifth) give every stream the same tokens (ROADMAP fault 3.9). The cold
    round prefills its prompts in other chunks, so it may part at a near
    tie."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--max-num-seqs", "16"]
    for extra in ([], ["--no-overlap-decode"]):
        rounds, _ = serve_rounds(params, argv + extra, 8, 128,
                                 ("capture", "timed", "logprobs", "timed",
                                  "logprobs"))
        base, gaps = rounds[1], rounds[2]["gaps"]
        label = " ".join(extra) or "defaults"
        for r in rounds:
            diffs = {i: (d, round(gaps[sorted(gaps)[i]][d], 4))
                     for i, d in first_parting(dict(r, tops={}),
                                               dict(base, tops={})).items()}
            log(f"[rounds] {label}: {r['kind']} round, {r['wall']:.3f} s, "
                f"pipelined bursts {r['bursts']}; (stream: first "
                f"difference from the second round, top-2 gap there) "
                f"{diffs}; {card}")
        parted = {i: first_parting(dict(r, tops={}), dict(base, tops={}))
                  for i, r in enumerate(rounds) if i > 1}
        check(not any(parted.values()),
              f"rounds ({label}): warm rounds part from the second round "
              f"(round: stream: first differing token) {parted}")
        gc.collect()
        torch.cuda.empty_cache()


# Decode passes after which 4k opens the pipeline's arrival gate.
ENGAGE_4K = (0, 1, 5, 37)


def rows_rounding(params, runner) -> dict:
    """What a decode row's rounding follows (ROADMAP fault 3.9), on the
    card: for layer 0's q, down and the lm_head projections, the row
    counts (of 1, 2, 4, 8, 16) at which one row's product through cuBLAS
    differs bit-wise from its product among 8 rows; and the split-KV
    decode's split count for each row count over ``runner``'s cache."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(41)
    out = {}
    lp = params["layers"]
    for name, w in (("wq", lp["wq"][0]), ("w_down", lp["w_down"][0]),
                    ("lm_head", params.get("lm_head",
                                           params["embed"]).t())):
        x = torch.randn(16, w.shape[0], device=DEV, generator=gen).to(w.dtype)
        ref = i4.mm_f32(x[:8], w)[0]
        out[name] = [m for m in (1, 2, 4, 8, 16)
                     if not torch.equal(i4.mm_f32(x[:m], w)[0], ref)]
    mc = runner.model_cfg
    cache, n_sm = runner.kv_cache, sm_count()
    tables = torch.zeros((1, 64), dtype=torch.int32, device=DEV)
    out["decode_splits"] = {
        B: pac.decode_launch_splits(
            "split", torch.empty((B, mc.num_heads, mc.head_dim),
                                 dtype=torch.bfloat16, device=DEV),
            cache, tables.expand(B, -1), n_sm)
        for B in (1, 2, 4, 8, 16)}
    return out


def phase_overlap_engagement(params, card: str) -> dict:
    """Phase 4k, fault 3.9: a row's greedy tokens must not depend on when
    the overlapped decode engages. One default bf16 Llama-3-8B server
    (its arrival gate's 0.5 s), 8 greedy streams of 96-124 tokens (rows
    finish one by one, so the batch crosses its row buckets) with top-2
    logprobs: a warm-up round (every later run sees its prefix hits),
    then the synchronous loop (``overlap_decode`` switched off), the
    pipeline forced to engage after decode pass k for k in ``ENGAGE_4K``
    (``_arrival_safe`` wrapped), and two rounds on the default gate. Every
    stream's tokens and top-2 logprobs equal the synchronous run's bit
    for bit; within one server, since the server's page count sets the
    decode's split plans. Prints each run's pipelined bursts, and what a
    row's rounding follows on the card (``rows_rounding``)."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--max-num-seqs", "16"]
    n_tok = tuple(96 + 4 * i for i in range(8))
    runs = ("warm-up", "sync", *(f"k{k}" for k in ENGAGE_4K), "gate",
            "gate")
    probe = {}

    def setup(kind, llm):
        llm.cfg.overlap_decode = kind != "sync"
        llm.__dict__.pop("_arrival_safe", None)  # the default gate
        if kind.startswith("k"):
            passes, k = itertools.count(), int(kind[1:])
            llm._arrival_safe = lambda: next(passes) >= k
        if not probe:
            probe.update(rows_rounding(params, llm.runner))

    rounds, info = serve_rounds(params, argv, 8, n_tok, runs, setup=setup,
                                logprobs=True)
    ref = rounds[1]
    parted = {r["kind"] + f"#{i}": first_parting(r, ref)
              for i, r in enumerate(rounds) if i > 1}
    bursts = {f"{r['kind']}#{i}": r["bursts"]
              for i, r in enumerate(rounds)}
    log(f"[phase 4k] engagement: 8 streams of {n_tok[0]}-{n_tok[-1]} "
        f"tokens with top-2 logprobs; pipelined bursts by run {bursts}; "
        f"first parting from the synchronous run (stream: position) "
        f"{parted}; rows whose product differs from its 8-row product "
        f"{ {k: v for k, v in probe.items() if k != 'decode_splits'} }, "
        f"decode splits by rows {probe['decode_splits']}; "
        f"{info['pages']} pages; {card}")
    check(not any(parted.values()),
          f"4k: tokens or top-2 logprobs part from the synchronous run by "
          f"the pipeline's engagement (run: stream: position) {parted}")
    check(all(r["bursts"] > 0 for r in rounds[2:]) and rounds[1]["bursts"]
          == 0, f"4k: pipelined bursts by run {bursts}")
    return {"bursts": bursts, "rows_rounding": probe,
            "n_tok": list(n_tok)}


def engagement_sweep(params, card: str) -> None:
    """``python3 chip_smoke.py engagement``: phase 4k with each half of
    fault 3.9's fix taken back (ROADMAP fault 3.9): the decoded pages'
    dedup swap between bursts (``LLMEngine._commit`` as it was) and the
    row bucket that shrinks as rows finish (``ModelRunner._decode_rows``
    as it was), one, the other, neither. Fails unless 4k fails with
    either half taken back and passes with neither."""
    fixed = LLMEngine._commit, ModelRunner._decode_rows

    def swap_between_bursts(self, seq, decoded=False):
        seq.commit_full_blocks(self.allocator, allow_swap=not (
            decoded and self.runner.burst_in_flight))

    def bucket_by_rows(self, seqs):
        return self._row_bucket(len(seqs))

    passed = {}
    for label, commit, rows in (
            ("both halves back", swap_between_bursts, bucket_by_rows),
            ("dedup swap back", swap_between_bursts, fixed[1]),
            ("row bucket back", fixed[0], bucket_by_rows),
            ("fixed", *fixed)):
        LLMEngine._commit, ModelRunner._decode_rows = commit, rows
        try:
            phase_overlap_engagement(params, card)
            passed[label] = True
        except AssertionError as e:
            log(f"[engagement] {label}: {str(e)[:600]}")
            passed[label] = False
        finally:
            LLMEngine._commit, ModelRunner._decode_rows = fixed
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[engagement] 4k passes {passed}; {card}")
    check(passed == {"both halves back": False, "dedup swap back": False,
                     "row bucket back": False, "fixed": True},
          f"engagement: 4k passes {passed}")


def phase_spec_serving(params, card: str, gap_tol: float, label: str,
                       quantization=None) -> dict:
    """Phase 4s (bf16) / 4t (int4, under ``PST_FUSED_KV_WRITE=1``): the
    Llama-3-8B server with ``--speculative-ngram 4`` (its verify buckets
    captured before traffic: the pool they take is logged) and the same
    server without it and with ``--no-overlap-decode`` (neither
    pipelines; the server's other defaults on both): 8
    concurrent greedy streams of 128 tokens over multi-round chat prompts
    that re-quote an earlier turn, once to capture the graphs and once
    timed; the plain server once more with top-2 logprobs. Each stream's
    speculative tokens equal the plain server's up to the first position
    whose top-2 logit gap in the plain run is within ``gap_tol`` (a
    near-tie, where the verify step's prefill kernel and the decode
    kernel may round apart; where it is, is logged). Both /metrics
    speculation counters grow; in every verify step the wgmma prefill
    launched once a layer (its launch counter grows during decode), and
    in int4 the wgmma int4 route ran inside verify steps of 8 rows (N =
    40). Each server's KV pool is what the memory budget gives just
    before it is built: speculation takes no page. Acceptance and tok/s with
    and without speculation are logged: one run each, no claim."""
    n_req, n_tok = 8, 128
    layers = get_model_config(MODEL).num_layers
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--max-num-seqs", "16"]
    if quantization:
        argv += ["--quantization", quantization]
    spec_rounds, spec_info = serve_rounds(
        params, argv + ["--speculative-ngram", "4"], n_req, n_tok,
        ("capture", "timed"))
    gc.collect()
    torch.cuda.empty_cache()
    # The reference runs the synchronous loop, as the speculative server
    # never pipelines.
    plain_rounds, plain_info = serve_rounds(
        params, argv + ["--no-overlap-decode"], n_req, n_tok,
        ("capture", "timed", "logprobs"))
    gc.collect()
    torch.cuda.empty_cache()
    spec, plain, ref = spec_rounds[1], plain_rounds[1], plain_rounds[2]
    check(plain["tokens"] == ref["tokens"],
          f"4s {label}: the plain server's logprobs round changed tokens")
    for tag, info in (("with", spec_info), ("without", plain_info)):
        check(info["pages"] == info["sized"],
              f"4s {label}: {info['pages']} KV pages {tag} speculation, the "
              f"budget gave {info['sized']} just before")
    check(len(spec["tokens"]) == n_req
          and set(spec["tokens"]) == set(ref["tokens"]),
          f"4s {label}: the two servers served other prompts")
    agree_to = []
    for key, want in ref["tokens"].items():
        got, gap = spec["tokens"][key], ref["gaps"][key]
        check(len(got) == len(want) == len(gap) == n_tok,
              f"4s {label}: {len(got)} / {len(want)} tokens, {len(gap)} gaps")
        near = next((j for j, g in enumerate(gap) if g <= gap_tol), n_tok)
        first_diff = next((j for j, (a, b) in enumerate(zip(got, want))
                           if a != b), n_tok)
        check(first_diff >= near,
              f"4s {label}: speculative tokens part from the plain server's "
              f"at {first_diff}, before the first near-tie at {near} "
              f"(gap {gap[min(first_diff, n_tok - 1)]:.4f} > "
              f"{gap_tol:.4f})")
        agree_to.append((near, first_diff))
    d = {k: spec["samples"].get(f"vllm:spec_decode_num_{k}_tokens_total", 0.0)
         - spec["before"].get(f"vllm:spec_decode_num_{k}_tokens_total", 0.0)
         for k in ("draft", "accepted")}
    check(d["draft"] > 0 and d["accepted"] > 0,
          f"4s {label}: /metrics speculation counters grew by {d}")
    check(not plain["samples"].get(
        "vllm:spec_decode_num_draft_tokens_total", 0.0),
        f"4s {label}: the plain server drafted")
    steps = spec["verify"]
    pre = "prefill_wgmma"
    check(steps and all(c.get(pre, 0) == layers for _, c in steps),
          f"4s {label}: verify steps' prefill launches "
          f"{[c.get(pre, 0) for _, c in steps][:8]} (want {layers} each)")
    inside = sum(c.get(pre, 0) for _, c in steps)
    if quantization == "int4":
        wide = [c for rows, c in steps if rows > 4]
        check(wide and all(c.get("int4_wgmma", 0) > 0 for c in wide),
              f"4t: verify steps of more than 4 rows without the int4 "
              f"wgmma route: {wide[:2]}")
    rate = d["accepted"] / d["draft"]
    out = {
        "spec_tok_per_s": n_req * n_tok / spec["wall"],
        "plain_tok_per_s": n_req * n_tok / plain["wall"],
        "spec_wall_s": spec["wall"], "plain_wall_s": plain["wall"],
        "draft_tokens": d["draft"], "accepted_tokens": d["accepted"],
        "acceptance": rate, "verify_steps": len(steps),
        "verify_rows": sorted({rows for rows, _ in steps}),
        "prefill_launches_in_verify": inside,
        "prefill_launches": spec["counts"].get(pre, 0),
        "agree_to": agree_to, "gap_tol": gap_tol,
        "pages": spec_info["pages"], "plain_pages": plain_info["pages"],
        "verify_pool": spec_info["verify_pool"],
        "spec_graphs": spec_info["graphs"],
        "spec_graph_pool_bytes": spec_info["graph_pool_bytes"],
        "plain_graph_pool_bytes": plain_info["graph_pool_bytes"],
        "spec_counts": {k: n for k, n in spec["counts"].items() if n},
    }
    vp = spec_info["verify_pool"]
    log(f"[phase {label}] {quantization or 'bf16'} {MODEL} server with "
        f"--speculative-ngram 4 against the same server without (one run "
        f"each): {n_req} x {n_tok} streamed greedy tokens, "
        f"{out['spec_tok_per_s']:.1f} against {out['plain_tok_per_s']:.1f} "
        f"output tok/s; {d['draft']:.0f} draft tokens, {d['accepted']:.0f} "
        f"accepted ({rate:.1%}); {len(steps)} verify steps of "
        f"{out['verify_rows']} rows, {inside} prefill launches inside them "
        f"of {out['prefill_launches']} in the round; tokens equal up to "
        f"(first near-tie, first difference) {agree_to} with gap tol "
        f"{gap_tol:.4f}; KV pages as the budget sized them, "
        f"{out['pages']} with speculation, {out['plain_pages']} without; "
        f"{len(vp.get('buckets', ()))} verify buckets "
        f"{sorted(set(vp.get('buckets', ())))} took "
        f"{vp.get('graph_pool_bytes', 0) / 2**20:.1f} "
        f"MiB of graph pool ({vp.get('reserved_bytes', 0) / 2**20:.1f} MiB "
        f"reserved); {card}")
    return out


# Phase 4h: a server with a small pool, deadlines and two tenants.


def _timed_request(port: int, body: dict, headers: dict) -> dict:
    """One completion with ``headers``: its status and headers, its body
    (JSON) or its frames (streamed), and for a stream the wall from the
    request to the first token's frame (TTFT)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json", **headers})
    resp = conn.getresponse()
    out = {"status": resp.status, "headers": dict(resp.getheaders())}
    if not body.get("stream") or resp.status != 200:
        out["body"] = json.loads(resp.read())
        conn.close()
        return out
    frames, ttft = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: {"):
            frames.append(json.loads(line[6:]))
            if ttft is None:
                ttft = time.perf_counter() - t0
        elif line.startswith(b"data: [DONE]"):
            frames.append("[DONE]")
    conn.close()
    out.update(frames=frames, ttft=ttft)
    return out


def phase_tenancy_serving(params, card: str, extra_argv=(),
                          first_wave_only: bool = False) -> dict:
    """Phase 4h: the bf16 Llama-3-8B server of phase 4's flags with
    ``--num-kv-blocks 160`` (five 1024-token prompts' pages) and
    ``--max-num-seqs 16``: 16 requests of 1024-token prompts at once,
    from a batch tenant (6, streamed, 128 tokens) and an interactive one
    (6 the same; 2 whose ``X-PST-Deadline-Ms`` is spent on arrival), and a
    second interactive tenant's 2 whose budget of 2 s runs out mid-decode
    (512 tokens asked, one streamed). Every status and
    finish reason; ``/metrics``' sheds (2 at admission, 2 queued or
    running) and swaps (every sequence swapped out came back, resumed or
    recomputed); the interactive TTFT p50 at most the batch one. Then n=4
    candidates of a prompt just served (its pages counted as prefix hits),
    best_of=4 with n=2 ranked by mean logprob, an echo and a batch of
    prompts (not with ``first_wave_only``). ``extra_argv`` adds flags (4j:
    ``--cpu-offload-blocks``)."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--num-decode-steps", "4",
            "--max-num-seqs", "16", "--num-kv-blocks", "160", *extra_argv]
    engine = AsyncLLMEngine(engine_config_from_args(parse_engine_args(argv)),
                            params=params)
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    rng = np.random.default_rng(41)
    V = engine.engine.model_cfg.vocab_size
    prompts = [rng.integers(1, V, 1024).tolist() for _ in range(16)]
    batch = {"X-PST-Tenant": "bulk", "X-PST-Tenant-Class": "batch"}
    chat = {"X-PST-Tenant": "chat", "X-PST-Tenant-Class": "interactive"}
    # A second interactive tenant, whose turn (deficit round robin) comes
    # among chat's first: its requests decode before their 2 s run out.
    ops = {"X-PST-Tenant": "ops", "X-PST-Tenant-Class": "interactive"}
    # (kind, headers, stream, max_tokens) a request, batch tenant first.
    plan = ([("batch", batch, True, 128)] * 6
            + [("interactive", chat, True, 128)] * 6
            + [("spent", {**chat, "X-PST-Deadline-Ms": "0"}, False, 128)] * 2
            + [("mid", {**ops, "X-PST-Deadline-Ms": "2000"}, s, 512)
               for s in (False, True)])
    results: dict = {}

    def one(i):
        kind, headers, stream, max_tokens = plan[i]
        try:
            results[i] = _timed_request(port, {
                "prompt": prompts[i], "max_tokens": max_tokens,
                "temperature": 0.0, "ignore_eos": True, "stream": stream},
                headers)
        except BaseException as e:  # re-raised on the main thread
            results[i] = e

    try:
        before = scrape(port)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(plan))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        for r in results.values():
            if isinstance(r, BaseException):
                raise r
        ttft = {"batch": [], "interactive": []}
        for i, (kind, _, stream, max_tokens) in enumerate(plan):
            r = results[i]
            tagged = r["headers"].get("X-PST-Deadline-Exceeded") == "1"
            if kind in ("batch", "interactive"):
                fr = r["frames"]
                check(r["status"] == 200 and fr[-1] == "[DONE]"
                      and len(fr) == 129
                      and fr[-2]["choices"][0]["finish_reason"] == "length",
                      f"4h {kind} request {i}: {r['status']}, {len(fr)} "
                      f"frames")
                ttft[kind].append(r["ttft"])
            elif kind == "spent" or not stream:
                check(r["status"] == 504 and tagged,
                      f"4h {kind} request {i}: {r['status']} {r['body']}")
            else:
                fr = r["frames"]
                check(r["status"] == 200 and fr[-1] == "[DONE]"
                      and fr[-2]["choices"][0]["finish_reason"] == "deadline"
                      and len(fr) - 2 < max_tokens,
                      f"4h streamed mid-decode shed: {r['status']}, "
                      f"{len(fr)} frames, last {fr[-2:]}")
        m = scrape(port)

        def grew(name):
            return m.get(name, 0.0) - before.get(name, 0.0)

        shed_adm = grew("pst:deadline_shed_admission_total")
        shed_q = grew("pst:deadline_shed_queued_total")
        shed_r = grew("pst:deadline_shed_running_total")
        out_, in_ = grew("pst:kv_swap_out_total"), grew("pst:kv_swap_in_total")
        fallback = grew("pst:kv_swap_fallback_recompute_total")
        check(shed_adm == 2 and shed_q + shed_r == 2,
              f"4h sheds: admission {shed_adm}, queued {shed_q}, running "
              f"{shed_r}")
        check(out_ > 0 and in_ + fallback == out_
              and m.get("vllm:num_requests_swapped", 0.0) == 0
              and grew("pst_engine_swap_out_total") == out_
              and grew("pst_engine_swap_in_total") == in_,
              f"4h swaps: out {out_}, in {in_}, fallback {fallback}")
        p50 = {k: statistics.median(v) for k, v in ttft.items()}
        check(p50["interactive"] <= p50["batch"],
              f"4h TTFT p50: interactive {p50['interactive']:.3f}s over "
              f"batch {p50['batch']:.3f}s")
        label = "4j" if extra_argv else "4h"
        log(f"[phase {label}] {MODEL}, 160 KV pages"
            f"{''.join(' ' + a for a in extra_argv)}, 16 requests of 1024-token "
            f"prompts in {wall:.2f}s: statuses and finish reasons as sent; "
            f"sheds at admission {shed_adm:.0f}, queued {shed_q:.0f}, "
            f"running {shed_r:.0f}; swaps out {out_:.0f}, in {in_:.0f}, "
            f"recomputed {fallback:.0f} (tail pages "
            f"{grew('pst:kv_swap_tail_pages_total'):.0f}); batch-tier "
            f"preemptions {grew('pst:tenant_batch_preemptions_total'):.0f}; "
            f"TTFT p50 interactive {p50['interactive']:.3f}s, batch "
            f"{p50['batch']:.3f}s; {card}")
        host_hits = engine.engine.stats().get("kv_offload_host_hit_blocks",
                                              0.0)
        if first_wave_only:
            check(engine.is_healthy(), f"{label}: {engine.step_error}")
            return {"wall_s": wall, "ttft_p50_s": p50, "swaps": {
                "out": out_, "in": in_, "recomputed": fallback},
                "host_hit_blocks": host_hits}

        # n=4 candidates of a prompt just served: its pages are hits.
        base = {"prompt": prompts[6], "max_tokens": 16, "temperature": 0.8,
                "seed": 7, "logprobs": 1, "ignore_eos": True}
        _completion(port, {"prompt": prompts[6], "max_tokens": 4,
                           "temperature": 0.0, "ignore_eos": True}, 4)
        hits = scrape(port)["vllm:gpu_prefix_cache_hits_total"]
        status, out, _ = _call(port, "POST", "/v1/completions", {**base, "n": 4})
        hit = scrape(port)["vllm:gpu_prefix_cache_hits_total"] - hits
        full = (1024 - 1) // BS * BS  # the prompt's pages a match can take
        check(status == 200 and len(out["choices"]) == 4
              and out["usage"]["completion_tokens"] == 64
              and out["usage"]["prompt_tokens"] == 1024 and hit >= 4 * full,
              f"4h n=4: {status}, {out.get('usage')}, prefix hit tokens {hit}")
        status, out, _ = _call(port, "POST", "/v1/completions",
                               {**base, "n": 2, "best_of": 4})
        means = [statistics.mean(c["logprobs"]["token_logprobs"])
                 for c in out.get("choices", ())]
        check(status == 200 and len(means) == 2
              and means == sorted(means, reverse=True)
              and out["usage"]["completion_tokens"] == 64,
              f"4h best_of=4 n=2: {status}, means {means}, {out.get('usage')}")
        status, out, _ = _call(port, "POST", "/v1/completions", {
            "prompt": "Echo this prompt.", "max_tokens": 8, "echo": True,
            "logprobs": 1, "temperature": 0.0, "ignore_eos": True})
        lp = out["choices"][0]["logprobs"] if status == 200 else {}
        n_in = out.get("usage", {}).get("prompt_tokens", 0)
        check(status == 200
              and out["choices"][0]["text"].startswith("Echo this prompt.")
              and lp["token_logprobs"][:n_in] == [None] * n_in
              and len(lp["tokens"]) == n_in + 8,
              f"4h echo: {status} {out}")
        status, out, _ = _call(port, "POST", "/v1/completions", {
            "prompt": ["One", "Two, longer", "Three"], "max_tokens": 8,
            "temperature": 0.0, "ignore_eos": True})
        check(status == 200 and [c["index"] for c in out["choices"]]
              == [0, 1, 2] and out["usage"]["completion_tokens"] == 24,
              f"4h batched prompts: {status} {out}")
        log(f"  n=4: 4 choices, 64 tokens billed, {hit:.0f} prefix-hit "
            f"tokens (4 x {full}); best_of=4 n=2: mean logprobs "
            f"{[round(x, 4) for x in means]}; echo and a batch of 3 prompts "
            f"served")
        check(engine.is_healthy(), f"4h: {engine.step_error}")
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    del engine
    return {"wall_s": wall, "ttft_p50_s": p50, "sheds": {
        "admission": shed_adm, "queued": shed_q, "running": shed_r},
        "swaps": {"out": out_, "in": in_, "recomputed": fallback}}


def phase_recompute_serving(params, card: str) -> dict:
    """Phase 4h with ``--no-kv-swap`` (ROADMAP fault 3.6 on the card): the
    first wave's 12 streamed requests of 1024-token prompts, 6 from a
    batch tenant and 6 from an interactive one, 128 tokens each, at once
    over 160 pages. Out of pages, sequences are preempted and recompute
    their prompt and output; every request must finish with its 128
    tokens and the preemptions be at least 1, with no swap."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--num-decode-steps", "4",
            "--max-num-seqs", "16", "--num-kv-blocks", "160", "--no-kv-swap"]
    engine = AsyncLLMEngine(engine_config_from_args(parse_engine_args(argv)),
                            params=params)
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    rng = np.random.default_rng(41)
    V = engine.engine.model_cfg.vocab_size
    tiers = [("bulk", "batch")] * 6 + [("chat", "interactive")] * 6
    results: dict = {}

    def one(i):
        tenant, tier = tiers[i]
        try:
            results[i] = _timed_request(port, {
                "prompt": rng_prompts[i], "max_tokens": 128,
                "temperature": 0.0, "ignore_eos": True, "stream": True},
                {"X-PST-Tenant": tenant, "X-PST-Tenant-Class": tier})
        except BaseException as e:  # re-raised on the main thread
            results[i] = e

    rng_prompts = [rng.integers(1, V, 1024).tolist() for _ in tiers]
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(tiers))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        for i, r in sorted(results.items()):
            if isinstance(r, BaseException):
                raise r
            fr = r["frames"]
            check(r["status"] == 200 and fr[-1] == "[DONE]" and len(fr) == 129
                  and fr[-2]["choices"][0]["finish_reason"] == "length",
                  f"4h no-swap request {i}: {r['status']}, {len(fr)} frames")
        m = scrape(port)
        preempted = m.get("vllm:num_preemptions_total", 0.0)
        check(preempted >= 1 and m.get("pst:kv_swap_out_total", 0.0) == 0
              and engine.engine.swapper is None,
              f"4h no-swap: preemptions {preempted}, swaps "
              f"{m.get('pst:kv_swap_out_total')}")
        check(engine.is_healthy(), f"4h no-swap: {engine.step_error}")
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    log(f"[phase 4h] --no-kv-swap, 160 KV pages: 12 streamed requests of "
        f"1024-token prompts finished with their 128 tokens in {wall:.2f}s; "
        f"recompute preemptions {preempted:.0f}, no swap; {card}")
    del engine
    return {"wall_s": wall, "preemptions": preempted}


# Phase 4j: KV tiers, the remote store, the disaggregated handoff and the
# cache controller on a served path.


def _recording(engine) -> list:
    """Each request's token ids, in submission order, as the server
    collects them (greedy answers compared bit for bit)."""
    seen, generate = [], engine.generate

    def recording(*args, **kw):
        toks = []
        seen.append(toks)
        for out in generate(*args, **kw):
            toks.extend(out.new_token_ids)
            yield out

    engine.generate = recording
    return seen


def _tier_server(params, argv: list):
    engine = AsyncLLMEngine(engine_config_from_args(parse_engine_args(argv)),
                            params=params)
    seen = _recording(engine)
    server, thread = serve_in_thread(engine)
    return engine, server, thread, seen


def _stop_server(engine, server, thread) -> None:
    if server.controller_reports is not None:
        server.controller_reports.set()
    server.shutdown()
    server.server_close()
    engine.shutdown()
    thread.join(timeout=10)


def _engine_stats(port: int) -> dict:
    status, body, _ = _call(port, "GET", "/debug/state")
    check(status == 200, f"/debug/state: {status}")
    return body["stats"]


def _stage(m: dict, stage: str, part: str = "count") -> float:
    return m.get(f'pst_stage_duration_seconds_{part}{{component="engine",'
                 f'stage="{stage}"}}', 0.0)


def _greedy(port: int, prompt: list, seen: list, max_tokens: int = 32,
            extra=None) -> dict:
    """One greedy streamed completion: its TTFT and token ids."""
    r = _timed_request(port, {"prompt": prompt, "max_tokens": max_tokens,
                              "temperature": 0.0, "ignore_eos": True,
                              "stream": True, **(extra or {})}, {})
    fr = r.get("frames", [])
    check(r["status"] == 200 and fr[-1] == "[DONE]"
          and len(fr) == max_tokens + 1, f"4j stream: {r['status']}, "
          f"{len(fr)} frames")
    return {"ttft": r["ttft"], "tokens": list(seen[-1])}


def _leg(port: int, prompt: list, seen: list, rid=None, role=None,
         max_tokens: int = 32) -> list:
    """One collected greedy completion, with the router's handoff stamp
    when ``rid`` is given; its token ids."""
    body = {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0.0,
            "ignore_eos": True}
    if rid is not None:
        body["kv_transfer_params"] = {"request_id": rid, "role": role,
                                      "pool": role}
    status, out, _ = _call(port, "POST", "/v1/completions", body)
    check(status == 200 and out["usage"]["completion_tokens"] == max_tokens,
          f"4j {role or 'plain'} leg: {status} {out}")
    return list(seen[-1])


# Engine steps from which 4j(d) opens the pipeline's arrival gate.
ENGAGE_STEPS = (0, 4, 7, 10)


def phase_bucket_rounding(params, card: str) -> dict:
    """Phase 4j(d), fault 3.8: one request's tokens must not depend on when
    the overlapped decode engages. Llama-3-8B (``num_kv_blocks`` 256), a
    2040-token prompt served for 1 token and then as a prefix hit for 32
    greedy tokens, whose decode crosses the block table's 64-page bucket
    at position 2048; the overlapped decode reserves the next page a step
    earlier than the synchronous loop, so its table reaches the 128-page
    bucket one step sooner. With the pipeline's arrival gate opened from
    engine step k on (k in ``ENGAGE_STEPS``, on both sides of the step
    whose burst starts on the row before the boundary), the tokens and
    every committed page equal the synchronous loop's bit for bit, and
    the split-KV decode ran."""
    prompt = np.random.default_rng(60).integers(1, 128256, 2040).tolist()

    def run(engage_at=None):
        eng = LLMEngine(EngineConfig(model=MODEL, device=DEV.type,
                                     num_kv_blocks=256,
                                     overlap_decode=engage_at is not None),
                        params=params)
        calls = {"n": 0}

        def gate():
            calls["n"] += 1
            return calls["n"] > engage_at

        if engage_at is not None:
            eng._arrival_safe = gate
        toks = []
        for rid, n in (("w", 1), ("r", 32)):
            eng.add_request(rid, prompt_token_ids=prompt,
                            sampling=SamplingParams(max_tokens=n,
                                                    temperature=0.0,
                                                    ignore_eos=True))
            while eng.has_work():
                for o in eng.step():
                    toks += o.new_token_ids
        torch.cuda.synchronize()
        pages = {h: eng.runner.kv_cache[:, b].view(torch.uint8).cpu()
                 for h, b in eng.allocator._block_of_hash.items()}
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return toks, pages

    reset_launch_counts()
    ref_toks, ref_pages = run()
    parted = {}
    for k in ENGAGE_STEPS:
        toks, pages = run(k)
        differ = sum(1 for h, page in pages.items()
                     if h in ref_pages and not torch.equal(page, ref_pages[h]))
        first = next((i for i, (a, b) in enumerate(zip(toks, ref_toks))
                      if a != b), None)
        parted[k] = (first, differ)
    counts = {**launch_counts(), **route_counts()}
    check(all(v == (None, 0) for v in parted.values())
          and len(ref_toks) == 33,
          f"4j(d): tokens part from the synchronous loop's by engagement "
          f"step (first differing token, pages differing): {parted}")
    check(counts.get("decode_split", 0) > 0,
          f"4j(d): the split-KV decode did not run: {counts}")
    log(f"[phase 4j] decode rounding across the 64 -> 128-page table bucket: "
        f"a 2040-token prefix hit's 32 greedy tokens and {len(ref_pages)} "
        f"committed pages equal the synchronous loop's with the overlapped "
        f"decode engaged from step {list(ENGAGE_STEPS)}; launches decode "
        f"{counts['decode_split']}; {card}")
    return {"engage_steps": list(ENGAGE_STEPS), "parted": parted}


def phase_tier_serving(params, card: str) -> dict:
    """Phase 4j(a): the host tier. A bf16 server with ``--num-kv-blocks
    160 --cpu-offload-blocks 512``; prompt A (2070 tokens, greedy, 32
    output tokens) cold, then as a device prefix hit, whose 64 full pages
    are copied to the host; then three 2048-token prompts evict every
    page of A, and A once more: its 64 pages fault up from host memory
    (``kv_offload_host_hit_blocks`` and the ``kv_fetch_host`` stage count
    64), equal the copies bit for bit, the prefill and decode kernels run,
    and its tokens equal the device hit's bit for bit. 2070 tokens, not
    2048: a prefix hit recomputes the tail after its last full block, and
    with a full last block that tail is the block itself, whose commit
    adopts the resident page of its hash: the device hit would read the
    cold run's 2048-token prefill's page and the host hit its own
    32-token chunk's, rounded otherwise. The three TTFTs (cold, device
    hit, host hit)."""
    argv = ["--model", MODEL, "--device", DEV.type, "--num-kv-blocks", "160",
            "--cpu-offload-blocks", "512"]
    engine, server, thread, seen = _tier_server(params, argv)
    port = server.server_address[1]
    llm = engine.engine
    rng = np.random.default_rng(47)
    V = llm.model_cfg.vocab_size
    warm, a = (rng.integers(1, V, 2070).tolist() for _ in range(2))
    others = [rng.integers(1, V, 2048).tolist() for _ in range(3)]
    full = (2070 - 1) // BS  # the pages a match of A can take
    a_hashes = block_hashes(a[:full * BS], BS)
    try:
        alloc = llm.allocator
        check(isinstance(alloc, TieredAllocator) and llm.remote is None
              and alloc.host_pool.max_blocks == 512,
              f"4j(a): allocator {type(alloc).__name__}")
        # The shapes' graphs first: a cold prompt and its prefix hit.
        _greedy(port, warm, seen)
        _greedy(port, warm, seen)
        cold = _greedy(port, a, seen)
        hbm = _greedy(port, a, seen)
        torch.cuda.synchronize()
        before = {h: llm.runner.kv_cache[:, alloc._block_of_hash[h]]
                  .view(torch.uint8).cpu() for h in a_hashes}
        s0 = _engine_stats(port)
        for p in others:
            _greedy(port, p, seen, max_tokens=8)
        check(not any(h in alloc._block_of_hash for h in a_hashes),
              "4j(a): A's pages were not all evicted")
        s1, m1 = _engine_stats(port), scrape(port)
        pooled = len(alloc.host_pool)
        reset_launch_counts()
        host = _greedy(port, a, seen)
        counts = {**launch_counts(), **route_counts()}
        s2, m2 = _engine_stats(port), scrape(port)
        torch.cuda.synchronize()
        differ = [h for h in a_hashes if not torch.equal(
            llm.runner.kv_cache[:, alloc._block_of_hash[h]]
            .view(torch.uint8).cpu(), before[h])]
        spilled = s1["kv_offload_spilled_blocks"] - s0[
            "kv_offload_spilled_blocks"]
        hits = s2["kv_offload_host_hit_blocks"] - s1[
            "kv_offload_host_hit_blocks"]
        fetch_host = _stage(m2, "kv_fetch_host") - _stage(m1, "kv_fetch_host")
        check(spilled >= full and hits == full and fetch_host == full,
              f"4j(a): spilled {spilled}, host hits {hits}, kv_fetch_host "
              f"{fetch_host} (want {full})")
        check(s2["prefix_cache_hits_total"] - s1["prefix_cache_hits_total"]
              == full * BS, "4j(a): prefix hit tokens")
        check(not differ, f"4j(a): {len(differ)} of A's {full} pages "
              f"faulted up from host memory differ from their device copies")
        check(host["tokens"] == hbm["tokens"],
              f"4j(a): host-hit tokens {host['tokens'][:8]} != device-hit "
              f"{hbm['tokens'][:8]}")
        check(counts.get("prefill_wgmma", 0) > 0
              and counts.get("decode_split", 0) > 0,
              f"4j(a): kernels not launched: {counts}")
        check(engine.is_healthy(), f"4j(a): {engine.step_error}")
    finally:
        _stop_server(engine, server, thread)
    ttft = {"cold": cold["ttft"], "hbm_hit": hbm["ttft"],
            "host_hit": host["ttft"]}
    log(f"[phase 4j] host tier, 160 pages + 512 host pages ({pooled} "
        f"held when A came back): A's {full} "
        f"pages faulted up from host memory after {spilled:.0f} spills, "
        f"equal to their device copies; tokens equal the device hit's; TTFT "
        f"cold {ttft['cold']:.4f}s, device hit {ttft['hbm_hit']:.4f}s, host "
        f"hit {ttft['host_hit']:.4f}s; launches prefill "
        f"{counts['prefill_wgmma']}, decode {counts['decode_split']}; {card}")
    del engine
    return {"ttft_s": ttft, "spilled": spilled, "host_hits": hits,
            "host_pages_held": pooled}


def phase_disagg_serving(params, card: str) -> dict:
    """Phase 4j(b) and (c): the port's kvserver and cache controller in
    threads of this script; a producer and a consumer bf16 server
    (``--remote-kv-url`` to the kvserver, ``--num-kv-blocks 512``, one
    param tree; the producer also ``--cache-controller-url``). A
    2070-token prompt goes to the producer with the router's producer
    stamp and ``max_tokens`` 1, then to the consumer with the consumer
    stamp: the consumer prefetches all 64 full pages (no fallback), they
    equal the producer's bit for bit, and its tokens equal the
    producer's answer to the prompt asked again (a device hit over the
    pages it published). 2070 tokens, a partial last block: with a full
    one the producer's hit adopts the page its own prefill computed for
    it and the consumer keeps the one its chunk computed, rounded
    otherwise. Then ``drop_manifest`` on
    the kvserver and a second prompt: the consumer waits out its 5 s,
    falls back to the fused path (one fallback, a 200; its pages from the
    store's blocks) and matches again. The kvserver's ``/stats``, the
    producer's two legs (a prefill and the downloads of its pages for
    the publisher, the first with the server's first step captures) and
    the prefetch's seconds are printed. (c): a 2048-token prompt on the
    producer, one registration of its chunk hashes, called directly;
    ``/lookup`` of that prompt's chunk hashes returns 2048 tokens for the
    producer's URL."""
    kv = KVServer(("127.0.0.1", 0), 8 << 30)
    kv_thread = start_in_thread(kv)
    ctrl = ControllerServer(("127.0.0.1", 0))
    ctrl_thread = start_in_thread(ctrl)
    common = ["--model", MODEL, "--device", DEV.type, "--num-kv-blocks",
              "512", "--remote-kv-url", kv.url]
    engine_url = "http://producer-4j:8000"
    servers = []
    try:
        servers.append(_tier_server(params, common + [
            "--kv-role", "producer", "--cache-controller-url", ctrl.url,
            "--engine-url", engine_url]))
        servers.append(_tier_server(params, common + [
            "--kv-role", "consumer", "--kv-transfer-timeout-s", "5"]))
        (peng, pserver, _, pseen), (ceng, cserver, _, cseen) = servers
        pport, cport = (s.server_address[1] for _, s, _, _ in servers)
        rng = np.random.default_rng(53)
        V = peng.engine.model_cfg.vocab_size
        p1, p2 = (rng.integers(1, V, 2070).tolist() for _ in range(2))
        pages = full = 2070 // BS
        m0 = scrape(cport)
        reset_launch_counts()
        t0 = time.perf_counter()
        _leg(pport, p1, pseen, "xfer-1", "producer", max_tokens=1)
        producer_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        consumer = _leg(cport, p1, cseen, "xfer-1", "consumer")
        leg_s = time.perf_counter() - t0
        counts = {**launch_counts(), **route_counts()}
        # The consumer's pages are the producer's, bit for bit.
        torch.cuda.synchronize()
        differ_pages = [
            h for h in block_hashes(p1, BS)
            if not torch.equal(*(
                e.engine.runner.kv_cache[:, e.engine.allocator
                                         ._block_of_hash[h]]
                .view(torch.uint8) for e in (peng, ceng)))]
        check(not differ_pages, f"4j(b): {len(differ_pages)} of the "
              f"consumer's {full} pages differ from the producer's")
        ref = _leg(pport, p1, pseen)
        m1, s1 = scrape(cport), _engine_stats(cport)
        prefetched = m1["pst:kv_prefetched_blocks_total"] - m0.get(
            "pst:kv_prefetched_blocks_total", 0.0)
        prefetch_s = (_stage(m1, "kv_prefetch", "sum")
                      - _stage(m0, "kv_prefetch", "sum"))
        check(prefetched == pages
              and m1["pst:kv_transfer_fallbacks_total"] == 0
              and _stage(m1, "kv_prefetch") == 1
              and s1["kv_offload_host_hit_blocks"] == full,
              f"4j(b): prefetched {prefetched}, fallbacks "
              f"{m1['pst:kv_transfer_fallbacks_total']}, host hits "
              f"{s1['kv_offload_host_hit_blocks']}")
        check(m1.get("pst_kv_integrity_failures_total") == 0
              and "pst_kv_read_repairs_total" in m1,
              "4j(b): the remote tier's audit counters are not exported")
        check(consumer == ref, f"4j(b): consumer tokens {consumer[:8]} != "
              f"the producer's device hit {ref[:8]}")
        check(counts.get("prefill_wgmma", 0) > 0
              and counts.get("decode_split", 0) > 0,
              f"4j(b): kernels not launched: {counts}")
        # A lost manifest: the fused path, one fallback, a 200.
        status, _, _ = _call(kv.server_address[1], "POST", "/admin/fail",
                             {"mode": "drop_manifest"})
        check(status == 200, f"4j(b) /admin/fail: {status}")
        t0 = time.perf_counter()
        _leg(pport, p2, pseen, "xfer-2", "producer", max_tokens=1)
        producer2_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused = _leg(cport, p2, cseen, "xfer-2", "consumer")
        fused_s = time.perf_counter() - t0
        _call(kv.server_address[1], "POST", "/admin/heal")
        ref2 = _leg(pport, p2, pseen)
        m2, s2 = scrape(cport), _engine_stats(cport)
        check(m2["pst:kv_transfer_fallbacks_total"] == 1
              and m2["pst:kv_prefetched_blocks_total"] == prefetched
              and fused == ref2,
              f"4j(b) dropped manifest: fallbacks "
              f"{m2['pst:kv_transfer_fallbacks_total']}, tokens equal "
              f"{fused == ref2}")
        published = scrape(pport)["pst:kv_published_blocks_total"]
        check(published == 2 * pages, f"4j(b): published {published}")
        stats = _call(kv.server_address[1], "GET", "/stats")[1]
        page_mib = stats["bytes_used"] / stats["num_blocks"] / 2**20
        log(f"[phase 4j] disaggregated handoff over the port's kvserver: "
            f"{prefetched:.0f} pages of {page_mib:.3f} MiB prefetched in "
            f"{prefetch_s:.3f}s (the producer's leg {producer_s:.3f}s, its "
            f"first request; the consumer's {leg_s:.3f}s), no "
            f"fallback, tokens equal the producer's device hit; dropped "
            f"manifest: the producer's leg {producer2_s:.3f}s, 1 "
            f"fallback, a 200 in {fused_s:.3f}s, "
            f"{s2['kv_offload_remote_hit_blocks']:.0f} pages from the "
            f"store, tokens equal; kvserver /stats {json.dumps(stats)}; "
            f"launches prefill {counts['prefill_wgmma']}, decode "
            f"{counts['decode_split']}; {card}")
        # (c) The controller: a 2048-token prompt on the producer, one
        # registration, then a lookup of its chunk hashes.
        p3 = rng.integers(1, V, 2048).tolist()
        _leg(pport, p3, pseen, max_tokens=1)
        check(register_with_controller(peng, ctrl.url, engine_url),
              "4j(c): registration refused")
        status, found, _ = _call(ctrl.server_address[1], "POST", "/lookup", {
            "model": peng.engine.model_name, "hashes": chunk_hashes(p3)})
        check(status == 200 and found["matches"].get(engine_url) == 2048,
              f"4j(c) /lookup: {status} {found}")
        log(f"[phase 4j] cache controller: /lookup of a 2048-token prompt's "
            f"{len(chunk_hashes(p3))} chunk hashes -> {found['matches']}")
        for eng, _, _, _ in servers:
            check(eng.is_healthy(), f"4j: {eng.step_error}")
    finally:
        for eng, server, thread, _ in servers:
            _stop_server(eng, server, thread)
        for srv, th in ((kv, kv_thread), (ctrl, ctrl_thread)):
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
    return {"prefetched_blocks": prefetched, "prefetch_s": prefetch_s,
            "producer_leg_s": [producer_s, producer2_s],
            "consumer_leg_s": leg_s, "fused_fallback_leg_s": fused_s,
            "kvserver": stats, "lookup": found["matches"]}


# Phase 4i: tracing, cost and the profiler on a served path.

TRACE_ID, TRACE_PARENT = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profiles_smoke")


# Phase 4l: the port started from the repo's own deployment argv.

# The chart's engine args at its default values (helm/values.yaml's first
# modelSpec through helm/templates/deployment-engine.yaml, for a release
# named "pst"), written out.
CHART_ENGINE_ARGV = (
    "--model", "llama-3-8b",
    "--served-model-name", "meta-llama/Llama-3-8B-Instruct",
    "--host", "0.0.0.0", "--port", "8000",
    "--max-model-len", "8192", "--max-num-seqs", "64",
    "--max-num-batched-tokens", "2048", "--tensor-parallel-size", "8",
    "--pipeline-parallel-size", "1", "--data-parallel-size", "1",
    "--block-size", "32", "--gpu-memory-utilization", "0.9",
    "--attn-impl", "pallas", "--num-decode-steps", "8",
    "--warmup", "full", "--debug-requests-buffer", "256",
    "--log-format", "text", "--flight-buffer", "512",
    "--cpu-offload-blocks", "4096",
    "--remote-kv-url", "http://pst-cache-server-0.pst-cache-server:8100",
    "--kv-replication", "2", "--kv-prefetch-depth", "64",
    "--kv-transfer-timeout-s", "10", "--cache-controller-url",
    "http://pst-kv-controller:9000",
)
# The chart's cache-server args (helm/templates/cache-server.yaml).
CHART_CACHE_ARGV = (
    "--host", "0.0.0.0", "--port", "8100", "--max-bytes", "64000000000",
    "--self-url", "http://pst-cache-server-0.pst-cache-server:8100",
    "--peers", "http://pst-cache-server-0.pst-cache-server:8100",
    "--replication", "2", "--sweep-interval-s", "30",
)
API_KEY = "chart-key"


def with_args(argv, **values) -> list:
    """``argv`` with the value after each ``--flag`` (``flag`` with
    underscores) replaced."""
    out = list(argv)
    for flag, value in values.items():
        out[out.index("--" + flag.replace("_", "-")) + 1] = str(value)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_chart_serving(params, card: str) -> dict:
    """Phase 4l: the port started from the chart's argv. Two port
    kvservers from the chart's cache-server argv (a ring of 2 on
    localhost, ``--sweep-interval-s 1``), the cache controller, and the
    engine server through ``parse_engine_args`` on the chart's default
    engine argv with ``--api-key`` added; one card, so
    ``--tensor-parallel-size 1`` (the chart's 8 parses into the config;
    its eight ranks are not started on one card: 4p serves tp 2), and
    ``--warmup lazy`` in place of ``full`` (the phase's time). Checks:
    ``/v1/models`` serves the chart's name; a completion without the key
    gets 401 and one with it 200; ``/metrics`` and ``/ready`` stay open;
    ``/sleep`` is guarded. Then the served prompt's pages are published
    to the ring, one shard is wiped, and the other's sweep backfills it
    within a few intervals: a ``GET /blocks`` there returns every page
    with the digest the other shard holds."""
    tp = engine_config_from_args(parse_engine_args(
        list(CHART_ENGINE_ARGV))).tensor_parallel_size
    check(tp == 8, f"4l: the chart's --tensor-parallel-size parsed as {tp}")
    urls = [f"http://127.0.0.1:{free_port()}" for _ in range(2)]
    shards = [server_from_args(with_args(
        CHART_CACHE_ARGV, host="127.0.0.1", port=u.rsplit(":", 1)[1],
        self_url=u, peers=",".join(urls), sweep_interval_s=1))
        for u in urls]
    threads = [start_in_thread(sh) for sh in shards]
    ctrl = ControllerServer(("127.0.0.1", 0))
    ctrl_thread = start_in_thread(ctrl)
    args = parse_engine_args(with_args(
        CHART_ENGINE_ARGV, host="127.0.0.1", port=0, tensor_parallel_size=1,
        warmup="lazy", remote_kv_url=",".join(urls),
        cache_controller_url=ctrl.url) + ["--api-key", API_KEY])
    engine = AsyncLLMEngine(engine_config_from_args(args), params=params)
    server, thread = serve_in_thread(engine, args.host, args.port,
                                     **app_options_from_args(args))
    port = server.server_address[1]
    key = {"Authorization": f"Bearer {API_KEY}"}
    body = {"prompt": chat_prompt(9) * 4, "max_tokens": 16,
            "temperature": 0.0, "ignore_eos": True}
    try:
        wait_ready(port)
        status, models, _ = _call(port, "GET", "/v1/models", headers=key)
        check(status == 200 and [m["id"] for m in models["data"]]
              == ["meta-llama/Llama-3-8B-Instruct"], f"4l models: {models}")
        statuses = {
            "models, no key": _call(port, "GET", "/v1/models")[0],
            "completion, no key": _call(port, "POST", "/v1/completions",
                                        body)[0],
            "completion, wrong key": _call(
                port, "POST", "/v1/completions", body,
                headers={"Authorization": "Bearer wrong"})[0],
            "completion, key": _call(port, "POST", "/v1/completions", body,
                                     headers=key)[0],
            "metrics, no key": _call(port, "GET", "/metrics")[0],
            "ready, no key": _call(port, "GET", "/ready")[0],
            "sleep, no key": _call(port, "POST", "/sleep?level=1")[0],
        }
        want = {k: 401 for k in statuses}
        want.update({"completion, key": 200, "metrics, no key": 200,
                     "ready, no key": 200})
        check(statuses == want and not engine.sleeping,
              f"4l auth: {statuses}")
        # Publish the prompt's committed pages to the ring.
        llm = engine.engine
        pages = []

        def publish():
            pages.extend((h, *llm.runner.download_page(b)) for h, b in
                         llm.allocator._block_of_hash.items())
            wait_landed(llm.runner.page_event())
            check(llm.remote.put_blocks(pages), "4l: put_blocks failed")

        engine.on_step_thread(publish)
        hashes = [h for h, _, _ in pages]
        wiped, other = shards
        with wiped.lock:
            gone = wiped.store.quarantine(hashes)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 10.0:
            with wiped.lock:
                if all(wiped.store.contains(h) for h in hashes):
                    break
            time.sleep(0.05)
        backfill_s = time.perf_counter() - t0

        def frames(shard):
            conn = http.client.HTTPConnection(*shard.server_address[:2],
                                              timeout=60)
            conn.request("GET", "/blocks?hashes=" + ",".join(map(str,
                                                                hashes)))
            resp = conn.getresponse()
            raw = resp.read()
            conn.close()
            check(resp.status == 200, f"4l GET /blocks: {resp.status}")
            return unpack_blocks_ex(raw)

        got, held = frames(wiped), frames(other)
        stats = [sh.stats() for sh in shards]
        check(gone == len(hashes) > 0 and sorted(got) == sorted(held)
              and len(got) == len(hashes)
              and stats[1]["anti_entropy_pushes"] >= len(hashes),
              f"4l: {len(hashes)} pages, {gone} wiped, {len(got)} back "
              f"after {backfill_s:.2f} s; stats {stats}")
        ring = _call(int(wiped.url.rsplit(":", 1)[1]), "GET", "/ring")[1]
        check(ring == {"peers": urls, "self": urls[0], "replication": 2,
                       "sweep_interval_s": 1.0}, f"4l /ring: {ring}")
        check(engine.is_healthy(), f"4l: {engine.step_error}")
    finally:
        _stop_server(engine, server, thread)
        for sh, t in zip(shards, threads):
            sh.shutdown()
            sh.server_close()
            t.join(timeout=10)
        ctrl.shutdown()
        ctrl.server_close()
        ctrl_thread.join(timeout=10)
    log(f"[phase 4l] the chart's argv (tp 1, warmup lazy): /v1/models "
        f"serves the chart's name; auth {statuses}; {len(hashes)} pages "
        f"published to a ring of 2 port kvservers, one wiped and "
        f"backfilled by the sweep in {backfill_s:.2f} s with the digests "
        f"kept (pushes {stats[1]['anti_entropy_pushes']}, sweeps "
        f"{stats[1]['anti_entropy_sweeps']}); {card}")
    del engine
    return {"auth": statuses, "pages": len(hashes),
            "backfill_s": backfill_s}


def _post(port: int, path: str, body: dict, headers: dict) -> tuple:
    """One POST with ``headers``: status, parsed body, headers."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **headers})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw), dict(resp.getheaders())


def _timeline(port: int, request_id: str) -> dict:
    status, ring, _ = _call(port, "GET",
                            f"/debug/requests?request_id={request_id}")
    check(status == 200 and len(ring["requests"]) == 1,
          f"4i /debug/requests?request_id={request_id}: {status} {ring}")
    return ring["requests"][0]


def phase_traced_serving(params, card: str) -> dict:
    """Phase 4i: a bf16 Llama-3-8B server of phase 4's flags with
    ``--profiling``. A completion carrying a fixed ``traceparent``,
    ``X-Request-Id`` and ``X-PST-Tenant`` (the server's first, so its
    steps capture graph keys): its timeline under the id joins the
    caller's trace under the caller's span, holds ``engine_request``,
    ``engine_admission``, ``engine_queue``, ``prefill`` and ``decode``
    (the last three together no longer than the root plus 1 ms) and
    ``compile`` events; ``X-PST-Cost`` equals ``usage.pst_cost``. A
    streamed chat's final usage carries ``pst_cost``. A spent deadline's
    504 echoes its ``X-Request-Id`` and its timeline holds a
    ``deadline_shed`` event. ``pst_stage_duration_seconds_count`` counts
    the traced requests by stage. ``POST /debug/profile`` of 500 ms during
    a stream writes a trace that names ``decode_split_kernel``, and a
    second POST meanwhile answers 409."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--num-decode-steps", "4",
            "--max-num-seqs", "16", "--profiling", "--profile-dir",
            PROFILE_DIR]
    args = parse_engine_args(argv)
    engine = AsyncLLMEngine(engine_config_from_args(args), params=params)
    server, thread = serve_in_thread(engine, **app_options_from_args(args))
    port = server.server_address[1]
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    try:
        long_prompt = ("The quick brown fox jumps over the lazy dog. " * 40)[:900]
        status, out, headers = _post(port, "/v1/completions", {
            "prompt": long_prompt, "max_tokens": 16, "temperature": 0.0,
            "ignore_eos": True}, {
            "traceparent": f"00-{TRACE_ID}-{TRACE_PARENT}-01",
            "X-Request-Id": "smoke-4i-1", "X-PST-Tenant": "acme"})
        check(status == 200, f"4i traced completion: {status} {out}")
        cost = json.loads(headers.get("X-PST-Cost", "null"))
        check(cost is not None and cost == out["usage"].get("pst_cost")
              and cost["device_s"] > 0,
              f"4i X-PST-Cost {headers.get('X-PST-Cost')} against usage "
              f"{out['usage']}")
        tl = _timeline(port, "smoke-4i-1")
        spans = {sp["name"]: sp for sp in tl["spans"]}
        root = tl["spans"][0]
        check(tl["trace_id"] == TRACE_ID and root["name"] == "engine_request"
              and root["parent_id"] == TRACE_PARENT
              and [sp["name"] for sp in tl["spans"]]
              == ["engine_request", "engine_admission", "engine_queue",
                  "prefill", "decode"]
              and all(sp["parent_id"] == root["span_id"]
                      for sp in tl["spans"][1:]),
              f"4i timeline: {tl}")
        stages_ms = sum(spans[k]["duration_ms"]
                        for k in ("engine_queue", "prefill", "decode"))
        check(stages_ms <= root["duration_ms"] + 1.0,
              f"4i: queue + prefill + decode {stages_ms} ms over the root's "
              f"{root['duration_ms']} ms")
        compiles = [e for e in root["events"] if e["name"] == "compile"]
        check(compiles, f"4i: the first request carries no compile event: "
                        f"{root['events']}")
        log(f"  4i: traced completion and its timeline checked")

        chat = _sse(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Hello there."}],
            "max_tokens": 8, "temperature": 0.0, "ignore_eos": True})
        chat_cost = (chat[-1].get("usage") or {}).get("pst_cost")
        check(chat_cost is not None and chat_cost["device_s"] > 0,
              f"4i streamed chat: final usage {chat[-1].get('usage')}")

        status, shed, headers = _post(port, "/v1/completions", {
            "prompt": "late", "max_tokens": 4}, {
            "X-PST-Deadline-Ms": "0", "X-Request-Id": "smoke-4i-shed"})
        check(status == 504 and headers.get("X-Request-Id") == "smoke-4i-shed"
              and headers.get("X-PST-Deadline-Exceeded") == "1",
              f"4i spent deadline: {status} {headers}")
        events = [e["name"] for e in
                  _timeline(port, "smoke-4i-shed")["spans"][0]["events"]]
        check(events == ["deadline_shed"], f"4i 504 events: {events}")
        m = scrape(port)

        def stage(name):
            return m.get(f'pst_stage_duration_seconds_count{{component='
                         f'"engine",stage="{name}"}}', 0.0)

        counted = {k: stage(k) for k in ("engine_request", "engine_admission",
                                          "engine_queue", "prefill",
                                          "decode")}
        check(counted == {"engine_request": 3, "engine_admission": 2,
                          "engine_queue": 2, "prefill": 2, "decode": 2},
              f"4i stage counts: {counted}")
        log("  4i: chat cost, the 504's id and events, stage counts checked")

        # A profile during a stream; a second capture meanwhile is refused.
        first_frame, answers = threading.Event(), {}

        def streamed():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            conn.request("POST", "/v1/completions", json.dumps({
                "prompt": "A long story:", "max_tokens": 512,
                "temperature": 0.0, "ignore_eos": True, "stream": True}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            n = 0
            while True:
                line = resp.readline()
                if not line:
                    break
                if line.startswith(b"data: {"):
                    n += 1
                    first_frame.set()
            conn.close()
            answers["frames"] = n

        def profile(key):
            answers[key] = _post(port, "/debug/profile",
                                 {"duration_ms": 500}, {})

        reader = threading.Thread(target=streamed)
        reader.start()
        check(first_frame.wait(timeout=120), "4i: the stream never started")
        capture = threading.Thread(target=profile, args=("first",))
        capture.start()
        time.sleep(0.15)
        profile("second")
        capture.join()
        reader.join()
        status, body, _ = answers["first"]
        check(status == 200 and body["status"] == "ok",
              f"4i /debug/profile: {status} {body}")
        check(answers["second"][0] == 409,
              f"4i second /debug/profile during a capture: {answers['second']}")
        check(answers.get("frames") == 512,
              f"4i profiled stream: {answers.get('frames')} frames")
        with open(body["trace"]) as f:
            trace = json.load(f)
        kernels = [e for e in trace.get("traceEvents", [])
                   if e.get("cat") == "kernel"]
        split = [e for e in kernels if "decode_split_kernel" in e["name"]]
        check(split, f"4i: the profile names no decode_split_kernel "
                     f"({len(kernels)} kernel events; categories "
                     f"{sorted({str(e.get('cat')) for e in trace.get('traceEvents', [])})})")
        busy_ms = sum(e.get("dur", 0) for e in kernels) / 1e3
        log(f"[phase 4i] {MODEL} traced: trace {TRACE_ID} joined under "
            f"{TRACE_PARENT}, spans {[sp['name'] for sp in tl['spans']]} "
            f"(queue + prefill + decode {stages_ms:.3f} of "
            f"{root['duration_ms']:.3f} ms), {len(compiles)} compile "
            f"events, X-PST-Cost {cost}; chat usage pst_cost {chat_cost}; "
            f"504 X-Request-Id echoed with deadline_shed; stage counts "
            f"{counted}; /debug/profile 500 ms: {len(kernels)} kernel events "
            f"({len(split)} decode_split_kernel), kernel time {busy_ms:.1f} "
            f"ms, second capture 409; {card}")
        check(engine.is_healthy(), f"4i: {engine.step_error}")
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
        shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    del engine
    return {"stages_ms": stages_ms, "root_ms": root["duration_ms"],
            "compile_events": len(compiles), "cost": cost,
            "profile_kernel_events": len(kernels),
            "profile_decode_split_events": len(split),
            "profile_kernel_ms": busy_ms}


# The names of the router's scraper (router/stats/engine_stats.py,
# _METRIC_FIELDS) that the port exports without a remote KV tier; the
# tier's integrity counter comes with one (phase 4j checks it).
ROUTER_METRICS = (
    "vllm:num_requests_running", "vllm:num_requests_waiting",
    "vllm:gpu_prefix_cache_hit_rate", "vllm:gpu_prefix_cache_hits_total",
    "vllm:gpu_prefix_cache_queries_total", "vllm:gpu_cache_usage_perc",
    "pst_engine_compile_total", "pst_engine_mfu",
    "pst_engine_kv_page_occupancy", "pst_engine_kv_page_high_watermark",
    "pst_engine_warmup_coverage", "pst:kv_transfer_fallbacks_total",
)


def scrape(port: int) -> dict:
    """``/metrics`` read by a few lines of this script (the card's machine
    has no prometheus_client): each sample name's sum over its label
    sets, and each labelled sample under its full ``name{labels}``."""
    status, text, headers = _call(port, "GET", "/metrics")
    check(status == 200 and headers.get("Content-Type", "").startswith(
        "text/plain; version=0.0.4"), f"/metrics: {status} {headers}")
    samples: dict = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            name = head.partition("{")[0]
            samples[name] = samples.get(name, 0.0) + float(value)
            if head != name:
                samples[head] = float(value)
    return samples


def phase_admin(params, card: str) -> dict:
    """Phase 4f: the metrics and admin routes of a bf16 Llama-3-8B server
    of phase 4's flags, sleep level 1 and 2 with their wakes (see the
    module docstring). Returns its numbers for the ``graphs`` line."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--num-decode-steps", "4",
            "--max-num-seqs", "16", "--warmup", "lazy"]
    cfg = engine_config_from_args(parse_engine_args(argv))
    engine = AsyncLLMEngine(cfg, params=params)
    runner = engine.engine.runner
    # Prompt and token ids of each answer, by its id: the HTTP answers
    # carry text, and most tokens of a random model decode to none.
    seen: dict = {}
    generate = engine.generate

    def recording_generate(*args, request_id=None, prompt_token_ids=None,
                           **kw):
        rec = seen[request_id] = {"prompt": list(prompt_token_ids),
                                  "tokens": []}
        for out in generate(*args, request_id=request_id,
                            prompt_token_ids=prompt_token_ids, **kw):
            rec["tokens"].extend(out.new_token_ids)
            yield out

    engine.generate = recording_generate
    # The wake's warmup (the second) is held until /ready has answered
    # "warming".
    gate, warmups = threading.Event(), []
    precompile = engine.engine.precompile

    def gated_precompile():
        warmups.append(1)
        if len(warmups) > 1 and not gate.wait(timeout=300):
            raise RuntimeError("the wake's warmup gate never opened")
        return precompile()

    engine.engine.precompile = gated_precompile
    server, thread = serve_in_thread(engine)
    port = server.server_address[1]
    try:
        wait_ready(port)
        status, body, _ = _call(port, "GET", "/version")
        check(status == 200 and body["version"], f"/version: {body}")
        n_req = n_gen = 0

        # A greedy chat, whole and streamed; its prompt (27 tokens) fills
        # no page, so both runs are fresh prefills.
        messages = [{"role": "user", "content": "Hi!"}]
        rendered = engine.engine.tokenizer.apply_chat_template(
            [ChatMessage.from_dict(m) for m in messages])
        chat = {"model": MODEL, "messages": messages, "max_tokens": 16,
                "temperature": 0.0, "ignore_eos": True}
        status, whole, _ = _call(port, "POST", "/v1/chat/completions", chat)
        check(status == 200 and whole["object"] == "chat.completion"
              and whole["choices"][0]["message"]["role"] == "assistant"
              and whole["choices"][0]["finish_reason"] == "length"
              and whole["usage"]["completion_tokens"] == 16,
              f"chat: {status} {whole}")
        frames = _sse(port, "/v1/chat/completions", chat)
        check(frames[0]["choices"][0]["delta"] == {"role": "assistant"}
              and all(f["object"] == "chat.completion.chunk" for f in frames)
              and frames[-1]["choices"][0]["finish_reason"] == "length"
              and frames[-1]["usage"]["completion_tokens"] == 16,
              f"chat stream: {frames[0]} ... {frames[-1]}")
        streamed = "".join(f["choices"][0]["delta"].get("content", "")
                           for f in frames[1:])
        a, b = seen[whole["id"]], seen[frames[0]["id"]]
        check(a["tokens"] == b["tokens"] and len(a["tokens"]) == 16
              and streamed == whole["choices"][0]["message"]["content"],
              f"chat: streamed tokens {b['tokens']} != {a['tokens']}")
        status, tk, _ = _call(port, "POST", "/tokenize",
                              {"messages": messages})
        check(status == 200 and tk["tokens"] == a["prompt"] == b["prompt"]
              and tk["count"] == whole["usage"]["prompt_tokens"]
              and tk["max_model_len"] == cfg.max_model_len
              and tk["count"] < cfg.block_size,
              f"/tokenize: {tk} against the chat's prompt {a['prompt']}")
        status, dt, _ = _call(port, "POST", "/detokenize",
                              {"tokens": tk["tokens"]})
        check(status == 200 and dt["prompt"] == rendered,
              f"/detokenize: {dt} != {rendered!r}")
        n_req, n_gen = n_req + 2, n_gen + 32
        log(f"[phase 4f] chat whole and streamed: the same 16 tokens; "
            f"/tokenize = its {tk['count']}-token prompt, /detokenize gives "
            f"the rendered text back")

        # P fresh, then as a prefix-cache hit.
        P = {"model": MODEL, "max_tokens": 24, "temperature": 0.0,
             "ignore_eos": True, "prompt": (
                 "Paged attention keeps each sequence's keys and values in "
                 "fixed-size pages. " * 6)[:320]}

        def run_p():
            hits0 = engine.engine.stats()["prefix_cache_hits_total"]
            status, body, _ = _call(port, "POST", "/v1/completions", P)
            check(status == 200 and body["usage"]["completion_tokens"] == 24,
                  f"P: {status} {body}")
            hits = engine.engine.stats()["prefix_cache_hits_total"] - hits0
            return seen[body["id"]]["tokens"], hits

        fresh, hits = run_p()
        check(hits == 0, f"P's first run hit {hits} cached tokens")
        hit, hits = run_p()
        check(hits > 0, "P's second run hit no cached page")
        n_req, n_gen = n_req + 2, n_gen + 48

        m = scrape(port)
        missing = [k for k in ROUTER_METRICS
                   + ("pst_engine_host_gap_seconds_bucket",) if k not in m]
        check(not missing, f"/metrics lacks {missing}")
        status, state, _ = _call(port, "GET", "/debug/state")
        captured = state["stats"]["graphs_captured"]
        check(status == 200 and state["ready"] and state["in_flight"] == 0
              and state["flight"]["capacity"] == 512
              and state["flight"]["total_steps"] > 0
              and state["compiles_total"] == captured,
              f"/debug/state: {state}")
        check(m["vllm:request_success_total"] == n_req
              and m["vllm:generation_tokens_total"] == n_gen
              and m["vllm:prompt_tokens_total"] == sum(
                  len(r["prompt"]) for r in seen.values())
              and m["pst_engine_compile_total"] == captured
              and m["pst_engine_mfu"] > 0,
              f"/metrics: success {m['vllm:request_success_total']} of "
              f"{n_req}, generated {m['vllm:generation_tokens_total']} of "
              f"{n_gen}, compiles {m['pst_engine_compile_total']} against "
              f"{captured} captures, mfu {m['pst_engine_mfu']}")
        log(f"  /metrics: {n_req} requests, {n_gen} tokens, "
            f"{captured:.0f} captures counted as compiles, mfu "
            f"{m['pst_engine_mfu']:.3g}, host-gap samples "
            f"{m['pst_engine_host_gap_seconds_count']:.0f}; the router's "
            f"{len(ROUTER_METRICS)} names present")

        # Drain: out of rotation until undrained.
        status, body, _ = _call(port, "POST", "/drain")
        check(status == 200 and body == {"status": "draining",
                                         "in_flight": 0}, f"/drain: {body}")
        check(_call(port, "GET", "/is_draining")[1] == {
            "is_draining": True, "in_flight": 0}, "/is_draining after /drain")
        status, body, _ = _call(port, "GET", "/ready")
        check(status == 503 and body["reason"] == "draining",
              f"/ready while draining: {status} {body}")
        status, body, headers = _call(port, "POST", "/v1/completions", P)
        check(status == 503 and headers.get("X-PST-Draining") == "1",
              f"completion while draining: {status} {headers}")
        status, body, _ = _call(port, "POST", "/undrain")
        check(status == 200 and body["status"] == "accepting", f"{body}")
        check(_call(port, "GET", "/is_draining")[1]["is_draining"] is False,
              "/is_draining after /undrain")
        check(_call(port, "GET", "/ready")[0] == 200, "/ready after /undrain")
        status, body, _ = _call(port, "POST", "/v1/completions", {
            "prompt": "ok", "max_tokens": 2, "temperature": 0.0})
        check(status == 200, f"completion after /undrain: {status}")

        def asleep(level: int) -> None:
            status, body, _ = _call(port, "POST", f"/sleep?level={level}")
            check(status == 200 and body == {"status": "sleeping",
                                             "level": level}, f"{body}")
            check(_call(port, "GET", "/is_sleeping")[1] == {
                "is_sleeping": True}, "/is_sleeping")
            status, body, _ = _call(port, "GET", "/ready")
            check(status == 503 and body["reason"] == "sleeping",
                  f"/ready asleep: {status} {body}")
            status, body, _ = _call(port, "POST", "/v1/completions", P)
            check(status == 503
                  and body["error"]["message"] == "engine is sleeping",
                  f"completion asleep: {status} {body}")

        # Level 1 pauses the loop and keeps the cache and the graphs.
        g0 = dict(runner.graph_counts)
        asleep(1)
        status, body, _ = _call(port, "POST", "/wake_up")
        check(status == 200 and body == {"status": "awake"}, f"{body}")
        check(_call(port, "GET", "/ready")[0] == 200, "/ready after level 1")
        again, hits = run_p()
        g1 = dict(runner.graph_counts)
        check(hits > 0 and again == hit,
              f"P after level 1: hits {hits}, {again} != {hit}")
        check(g1["captured"] == g0["captured"]
              and g1["replayed"] > g0["replayed"],
              f"level 1: graphs {g0} -> {g1}")

        # Level 2 frees the cache and every graph; the wake restores a
        # zeroed cache and warms up again.
        torch.cuda.synchronize()
        kv_bytes = runner.kv_cache.numel() * runner.kv_cache.element_size()
        pool0, live = runner.graph_pool_bytes, len(runner._graphs)
        free0 = torch.cuda.mem_get_info()[0]
        asleep(2)
        freed = torch.cuda.mem_get_info()[0] - free0
        check(freed >= kv_bytes,
              f"level 2 freed {freed} B, less than the cache's {kv_bytes}")
        check(engine.engine.stats()["graphs_dropped"] == live
              == g1["captured"], f"level 2 dropped "
              f"{runner.graph_counts['dropped']} of {live} graphs")
        reset_launch_counts()
        t_wake = time.perf_counter()
        status, body, _ = _call(port, "POST", "/wake_up")
        check(status == 200, f"/wake_up: {status} {body}")
        status, body, _ = _call(port, "GET", "/ready")
        check(status == 503 and body["reason"] == "warming",
              f"/ready after the wake: {status} {body}")
        gate.set()
        summary = wait_ready(port)["warmup"]
        wake_s = time.perf_counter() - t_wake
        check("error" not in summary and summary["buckets_compiled"] > 0,
              f"the wake's warmup: {summary}")
        after, hits = run_p()
        torch.cuda.synchronize()
        counts = {**launch_counts(), **route_counts()}
        g2 = dict(runner.graph_counts)
        pool2 = runner.graph_pool_bytes
        free2 = torch.cuda.mem_get_info()[0]
        check(hits == 0 and after == fresh,
              f"P after level 2: hits {hits}, {after} != its fresh {fresh}")
        check(g2["captured"] > g1["captured"]
              and g2["replayed"] > g1["replayed"],
              f"level 2: graphs {g1} -> {g2}")
        used = ("decode", "decode_split", "prefill", "prefill_wgmma")
        for k, n in counts.items():
            check(n > 0 if k in used else n == 0,
                  f"after the wake the {k} kernel launched {n} times")
        check(abs(free2 - free0) <= max(pool0, pool2),
              f"free memory {free0} before the sleep, {free2} after the "
              f"wake: more apart than the pools ({pool0}, {pool2} B)")
        check(engine.is_healthy(), f"engine failed: {engine.step_error}")
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(timeout=10)
    log(f"  level 1: P hit the cache again with the hit's tokens; graphs "
        f"{g0} -> {g1}")
    log(f"  level 2 ({card}): freed {freed / 1e9:.3f} GB "
        f"(KV cache {kv_bytes / 1e9:.3f} GB = {runner.num_blocks} pages, "
        f"{live} graphs in a {pool0 / 2**20:.1f} MiB pool); /wake_up to "
        f"/ready 200 in {wake_s:.2f}s; P fresh again with its first run's "
        f"tokens; graphs {g1} -> {g2}, pool {pool2 / 2**20:.1f} MiB; free "
        f"memory {(free2 - free0) / 2**20:+.1f} MiB against before the "
        f"sleep; launches after the wake {counts}")
    del engine, runner
    return {"kv_bytes": kv_bytes, "freed_bytes": freed,
            "wake_to_ready_s": round(wake_s, 3), "graphs_level1": g1,
            "graphs_after_wake": g2, "graph_pool_bytes": [pool0, pool2],
            "free_delta_bytes": free2 - free0}


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------


# Cycles of the spin kernel that keeps the card busy while the host queues
# a batch of timed launches (about 50 ms at the H100's clock).
# ---------------------------------------------------------------------------
# Phase 4m: LoRA serving
# ---------------------------------------------------------------------------

LORA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "lora_smoke")
LORA_RANK, LORA_ALPHA = 16, 32.0
LORA_NAMES = ("ad1", "ad2", "ad3")


def write_adapters(cfg) -> dict:
    """``LORA_DIR/<name>``: a PEFT directory per name of ``LORA_NAMES`` for
    ``cfg``'s widths, rank 16 and alpha 32 over q, k, v and o of every
    layer, bf16 tensors from seed 100 + i: A ``[r, in]`` ~ N(0, 1/in) and
    B ``[out, r]`` ~ N(0, 1/(16 r)), so that a row's delta is about half
    its projection (scale 2) and moves most greedy streams. B is not
    PEFT's zero init."""
    dims = {"q_proj": (cfg.hidden_size, cfg.q_size),
            "k_proj": (cfg.hidden_size, cfg.kv_size),
            "v_proj": (cfg.hidden_size, cfg.kv_size),
            "o_proj": (cfg.q_size, cfg.hidden_size)}
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    gen = torch.Generator(device=DEV)
    paths = {}
    for i, name in enumerate(LORA_NAMES):
        gen.manual_seed(100 + i)
        path = os.path.join(LORA_DIR, name)
        os.makedirs(path)
        tensors = {}
        for li in range(cfg.num_layers):
            for t, (din, dout) in dims.items():
                key = f"base_model.model.model.layers.{li}.self_attn.{t}"
                tensors[f"{key}.lora_A.weight"] = (torch.randn(
                    (LORA_RANK, din), generator=gen, device=DEV)
                    / math.sqrt(din)).bfloat16()
                tensors[f"{key}.lora_B.weight"] = (torch.randn(
                    (dout, LORA_RANK), generator=gen, device=DEV)
                    * (0.25 / math.sqrt(LORA_RANK))).bfloat16()
        write_safetensors(tensors, os.path.join(path,
                                                "adapter_model.safetensors"))
        with open(os.path.join(path, "adapter_config.json"), "w") as f:
            json.dump({"r": LORA_RANK, "lora_alpha": LORA_ALPHA,
                       "peft_type": "LORA",
                       "target_modules": list(dims)}, f)
        paths[name] = path
    return paths


def drive_rows(model, params, impl: str, prompt, decode_tokens, idx,
               scale):
    """``drive_model`` for ``len(idx)`` rows of one prompt in one batch,
    each on its own pages (in reverse order), row r under LoRA slot
    ``idx[r]`` with scale ``scale[r]``: the prefill in one chunk, then a
    decode step per token; returns the logits [rows, 1 + n, V]."""
    B, T = len(idx), len(prompt)
    per = -(-(T + len(decode_tokens)) // BS)
    cache = model.make_kv_cache(B * per + 1, BS, device=DEV)
    tables = torch.arange(B * per, dtype=torch.int32, device=DEV).flip(0)
    tables = tables.view(B, per).contiguous()
    lora = dict(lora_idx=torch.tensor(idx, dtype=torch.int32, device=DEV),
                lora_scale=torch.tensor(scale, dtype=torch.float32,
                                        device=DEV))

    def i32(v):
        return torch.full((B,), v, dtype=torch.int32, device=DEV)

    def slots(pos):
        blk = tables.gather(1, (pos // BS).long())
        return (blk * BS + pos % BS).to(torch.int32).contiguous()

    pos = torch.arange(T, dtype=torch.int32, device=DEV).expand(B, T)
    toks = torch.tensor(prompt, dtype=torch.int32, device=DEV).expand(B, T)
    logits, cache = model.forward(
        params, toks.contiguous(), pos.contiguous(), slots(pos), tables,
        i32(T), i32(T - 1), cache, attn_impl=impl, **lora)
    out = [logits]
    for i, tok in enumerate(decode_tokens):
        p = torch.full((B, 1), T + i, dtype=torch.int32, device=DEV)
        logits, cache = model.forward(
            params, torch.full((B, 1), tok, dtype=torch.int32, device=DEV),
            p, slots(p), tables, i32(T + i + 1), i32(0), cache,
            attn_impl=impl, **lora)
        out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1)


def lora_bank(model, loaded):
    """A bank of 2 slots (rank 16) holding the ``(adapter, arrays)`` of
    ``LoraManager.load``, written as ``ModelRunner.install_adapter``
    writes them."""
    bank = model.init_lora_bank(2, LORA_RANK, DEV)
    for ad, arrays in loaded:
        for t, (a, b) in arrays.items():
            bank[f"lora_a_{t}"][:, ad.slot].copy_(torch.from_numpy(a))
            bank[f"lora_b_{t}"][:, ad.slot].copy_(torch.from_numpy(b))
    return bank


def merged_tree(params, arrays, scaling: float):
    """``params`` with q, k, v and o merged with one adapter, a layer at a
    time: ``W + s * A @ B`` in fp32, then one cast to bf16."""
    layers = dict(params["layers"])
    for t, (a, b) in arrays.items():
        w = params["layers"][t]
        m = torch.empty_like(w)
        for li in range(w.shape[0]):
            delta = (torch.from_numpy(a[li]).to(DEV)
                     @ torch.from_numpy(b[li]).to(DEV))
            m[li] = (w[li].float() + scaling * delta).to(w.dtype)
        layers[t] = m
    return {**params, "layers": layers}


def phase_lora_model(model, params, paths: dict, label: str) -> dict:
    """Phase 4m(a) (bf16) and (b) (int4, ``PST_FUSED_KV_WRITE=1``): a bank
    of two adapters parsed from their PEFT directories by the port's
    ``LoraManager``, three rows of the model phases' prompt on slots 0,
    1 and 2 in one batch, a 512-token prefill chunk and 8 decode steps.
    Through the kernels against the gather path (the dequantized tree in
    int4) under ``agree``, every row; the launch counters show the
    kernels of the path; the adapter rows move the argmax. bf16: each
    adapter row against a merged-weights forward through the kernels,
    under the same tolerance."""
    cfg = model.cfg
    quant = llama_mod.quant_mode(params)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "4m: fp32 products would run in TF32")
    mgr = LoraManager(cfg, 2, LORA_RANK, LORA_DIR)
    t0 = time.perf_counter()
    loaded = [mgr.load(n, paths[n]) for n in ("ad1", "ad2")]
    parse_s = time.perf_counter() - t0
    bank = lora_bank(model, loaded)
    tree = {**params, "layers": {**params["layers"], **bank}}
    idx = [0] + [ad.slot for ad, _ in loaded]
    scale = [0.0] + [ad.scaling for ad, _ in loaded]
    prompt, dec = model_prompt(cfg)
    L, n = cfg.num_layers, len(dec)
    reset_launch_counts()
    got = drive_rows(model, tree, "cuda", prompt, dec, idx, scale)
    routes = {k: v for k, v in route_counts().items() if v}
    want = {"prefill_wgmma": L}
    if quant == "int4":
        want.update(decode_write_split=L * n, int4_decode=7 * L * n,
                    int4_wgmma=7 * L)
    else:
        want["decode_split"] = L * n
    check(all(routes.get(k) == v for k, v in want.items()),
          f"{label}: routes {routes}, expected at least {want}")
    ref_tree = tree
    if quant:
        deq = dequantized_copy(params)
        ref_tree = {**deq, "layers": {**deq["layers"], **bank}}
    ref = drive_rows(model, ref_tree, "gather", prompt, dec, idx, scale)
    del ref_tree
    check(got.shape == (3, 1 + n, cfg.vocab_size),
          f"{label}: logits shape {tuple(got.shape)}")
    rows = [agree(got[r], ref[r], f"{label} row {r} (slot {idx[r]})")
            for r in range(3)]
    moved = [float((got[r].argmax(-1) != got[0].argmax(-1)).float().mean())
             for r in (1, 2)]
    check(min(moved) > 0, f"{label}: an adapter row's argmax equals the "
          f"base row's at every position ({moved})")
    out = {"routes": routes, "argmax_moved": moved, "parse_s": parse_s,
           "bank_bytes": sum(t.numel() * t.element_size()
                             for t in bank.values())}
    merged = []
    if not quant:
        for ad, arrays in loaded:
            m = drive_rows(model, merged_tree(params, arrays, ad.scaling),
                           "cuda", prompt, dec, [0], [0.0])[0]
            err = float((got[ad.slot] - m).abs().max())
            tol = MODEL_REL_ATOL * float(m.abs().max())
            check(bool(torch.isfinite(m).all()) and err <= tol,
                  f"{label}: slot {ad.slot} against its merged weights "
                  f"{err:.4f} > {tol:.4f}")
            merged.append({"slot": ad.slot, "err": err, "tol": tol,
                           "argmax_agree": float(
                               (got[ad.slot].argmax(-1) == m.argmax(-1))
                               .float().mean())})
            del m
            gc.collect()
            torch.cuda.empty_cache()
        out["merged"] = merged
    del bank, tree
    torch.cuda.empty_cache()
    log(f"[phase {label}] {quant or 'bf16'} {MODEL}, a bank of 2 rank-16 "
        f"adapters (parsed in {parse_s:.2f}s, bank "
        f"{out['bank_bytes'] / 2**20:.1f} MiB), rows on slots {idx}: "
        f"512-token prefill + {n} decode steps through the kernels against "
        f"the gather path: {'; '.join(rows)}; adapter rows' argmax moved "
        f"at {moved} of positions; routes {routes}"
        + (f"; against merged weights {merged}" if merged else ""))
    return out


def _lora_stream(port: int, model: str, i: int, n_tok: int,
                 logprobs: bool, errors: list) -> None:
    body = {"model": model, "prompt": chat_prompt(i), "max_tokens": n_tok,
            "temperature": 0.0, "ignore_eos": True}
    if logprobs:
        body["logprobs"] = 2
    try:
        _stream(port, body, n_tok)
    except BaseException as e:  # re-raised by the caller
        errors.append(e)


class LoraServer:
    """A server of ``argv`` over ``params`` whose step loop waits until
    ``gate`` requests are in (so a round's streams share their steps), and
    which records each request's tokens and top-2 logprobs by (model,
    prompt ids), the verify steps' LoRA rows, and the runner's graph
    keys."""

    def __init__(self, params, argv: list):
        args = parse_engine_args(argv)
        cfg = engine_config_from_args(args)
        gc.collect()
        torch.cuda.empty_cache()
        self.engine = AsyncLLMEngine(cfg, params=params)
        self.llm = llm = self.engine.engine
        self.runner = llm.runner
        self.gate, self.all_in = 1, threading.Event()
        self.tokens, self.tops, self.gaps = {}, {}, {}
        self.verify = []
        generate, add, step = self.engine.generate, llm.add_request, llm.step
        execute = self.runner.execute_spec_verify

        def recording_generate(*a, prompt_token_ids=None, lora_name=None,
                               **kw):
            key = (lora_name or MODEL, tuple(prompt_token_ids))
            toks, top, gap = self.tokens[key], self.tops[key], \
                self.gaps[key] = [], [], []
            for o in generate(*a, prompt_token_ids=prompt_token_ids,
                              lora_name=lora_name, **kw):
                toks.extend(o.new_token_ids)
                for e in o.logprobs or ():
                    top.append(list(e["top"]))
                    gap.append(e["top"][0][1] - e["top"][1][1])
                yield o

        def counting_add(*a, **kw):
            seq = add(*a, **kw)
            if llm.scheduler.num_waiting + llm.scheduler.num_running \
                    >= self.gate:
                self.all_in.set()
            return seq

        def gated_step():
            if not self.all_in.wait(timeout=0.01):
                return []
            return step()

        def spy_verify(seqs, drafts):
            self.verify.append((len(seqs), sum(s.lora_idx > 0 for s in seqs)))
            return execute(seqs, drafts)

        self.engine.generate = recording_generate
        llm.add_request, llm.step = counting_add, gated_step
        self.runner.execute_spec_verify = spy_verify
        self.server, self.thread = serve_in_thread(
            self.engine, **app_options_from_args(args))
        self.port = self.server.server_address[1]

    def round(self, streams: list, n_tok: int, logprobs: bool,
              during=None) -> dict:
        """``streams`` [(model, prompt index)] admitted together, each
        ``n_tok`` greedy tokens; ``during(self)`` runs on a thread of its
        own meanwhile. Returns the streams' tokens, tops and gaps by
        stream, and the graph counts before and after."""
        self.gate = len(streams)
        self.all_in.clear()
        for d in (self.tokens, self.tops, self.gaps):
            d.clear()
        errors = []
        before = dict(self.runner.graph_counts)
        keys = set(self.runner._graphs)
        threads = [threading.Thread(target=_lora_stream, args=(
            self.port, m, i, n_tok, logprobs, errors)) for m, i in streams]
        if during is not None:
            threads.append(threading.Thread(target=during, args=(self,)))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        ids = {tuple(self.engine.engine.tokenizer.encode(chat_prompt(i))): i
               for _, i in streams}
        by = {(m, ids[p]): k for k in self.tokens for m, p in [k]}
        return {"tokens": {s: self.tokens[by[s]] for s in streams},
                "tops": {s: self.tops[by[s]] for s in streams},
                "gaps": {s: self.gaps[by[s]] for s in streams},
                "graphs": (before, dict(self.runner.graph_counts)),
                "new_keys": set(self.runner._graphs) - keys, "wall": wall}

    def one(self, model: str, i: int, n_tok: int) -> dict:
        """A lone greedy completion."""
        self.gate = 1
        self.all_in.clear()
        for d in (self.tokens, self.tops, self.gaps):
            d.clear()
        status, out, _ = _call(self.port, "POST", "/v1/completions", {
            "model": model, "prompt": chat_prompt(i), "max_tokens": n_tok,
            "temperature": 0.0, "ignore_eos": True})
        check(status == 200, f"4m: a lone completion: {status} {out}")
        key = next(iter(self.tokens))
        return {"model": out["model"], "tokens": self.tokens.pop(key)}

    def lora(self, route: str, body: dict) -> tuple:
        t0 = time.perf_counter()
        status, out, _ = _call(self.port, "POST", route, body)
        return status, out, time.perf_counter() - t0

    def close(self) -> dict:
        check(self.engine.is_healthy(), f"4m: {self.engine.step_error}")
        info = {"pages": self.runner.num_blocks,
                "graphs": dict(self.runner.graph_counts),
                "bank_bytes": self.runner.lora_bank_bytes}
        self.server.shutdown()
        self.server.server_close()
        self.engine.shutdown()
        self.thread.join(timeout=10)
        return info


# 8 streams: three prompts under the base model and each adapter (the
# last prompt without ad2), and a capture round of 8 other prompts.
LORA_STREAMS = [(m, i) for i in range(3) for m in (MODEL, "ad1", "ad2")][:8]
LORA_TOKENS = 64


def _load_both(srv: "LoraServer", paths: dict) -> list:
    seconds = []
    for slot, name in enumerate(("ad1", "ad2"), 1):
        status, body, dt = srv.lora("/v1/load_lora_adapter",
                                    {"lora_name": name,
                                     "lora_path": paths[name]})
        check(status == 200 and body == {"status": "ok", "name": name,
                                         "rank": LORA_RANK, "slot": slot},
              f"4m: load {name}: {status} {body}")
        seconds.append(dt)
    status, models, _ = _call(srv.port, "GET", "/v1/models")
    check([(m["id"], m["parent"]) for m in models["data"]]
          == [(MODEL, None), ("ad1", MODEL), ("ad2", MODEL)],
          f"4m: /v1/models {models}")
    return seconds


def phase_lora_serving(params, card: str, paths: dict, gap_tol: float
                       ) -> dict:
    """Phase 4m(c): the default bf16 server with ``--enable-lora
    --max-loras 2 --max-lora-rank 16 --lora-dir``. After two base rounds
    of 8 streams (the synchronous loop's decode keys captured, then the
    pipelined loop's), ``ad1`` and ``ad2`` load
    through ``POST /v1/load_lora_adapter`` and ``/v1/models`` lists them.
    Then rounds of ``LORA_STREAMS`` (64 greedy tokens, top-2 logprobs): a
    cold one, two warm ones equal bit for bit, in which every decode step
    replays a graph captured before the adapters were loaded, the
    adapters' streams parting from the base streams of their prompts; a
    third warm one in which ``ad1`` is unloaded while its streams run,
    equal to the second bit for bit. Then its slot is released (the
    engine's stats), a lone request naming ``ad1`` gets the base model's
    tokens (the JAX server's answer: an unknown name resolves to the
    base), and ``ad3`` loads into the freed slot. 4m(d): the same server
    with ``--speculative-ngram 4`` (no logprobs: they turn speculation
    off): adapter rows draft and verify with their adapter; each stream's
    warm tokens equal (c)'s up to the first top-2 gap of (c) within
    ``gap_tol`` (4s's rule)."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--max-num-seqs", "16",
            "--enable-lora", "--max-loras", "2", "--max-lora-rank",
            str(LORA_RANK), "--lora-dir", LORA_DIR]
    capture = [(MODEL, 10 + i) for i in range(8)]
    srv = LoraServer(params, argv)
    try:
        # The decode keys of both loops before the load: the synchronous
        # step's, then the pipelined burst's (a round long enough for the
        # arrival gate to open). Which loop a later round's step takes
        # follows the wall clock.
        srv.llm.cfg.overlap_decode = False
        srv.round(capture, LORA_TOKENS, True)
        srv.llm.cfg.overlap_decode = True
        srv.round(capture, 2 * LORA_TOKENS, True)
        check(srv.llm.pipelined_bursts_total > 0,
              "4m: the capture round never pipelined")
        load_s = _load_both(srv, paths)
        cold = srv.round(LORA_STREAMS, LORA_TOKENS, True)
        warm = [srv.round(LORA_STREAMS, LORA_TOKENS, True) for _ in range(2)]
        unloaded = {}

        def unload_ad1(s):
            key = ("ad1", tuple(s.engine.engine.tokenizer.encode(
                chat_prompt(0))))
            t0 = time.perf_counter()
            while len(s.tokens.get(key, ())) < 16:
                check(time.perf_counter() - t0 < 60, "4m: ad1 never ran")
                time.sleep(0.002)
            status, body, dt = s.lora("/v1/unload_lora_adapter",
                                      {"lora_name": "ad1"})
            unloaded.update(status=status, body=body, seconds=dt,
                            at=len(s.tokens[key]),
                            retiring=sorted(s.llm._retiring_slots),
                            running=s.llm.scheduler.num_running)

        during = srv.round(LORA_STREAMS, LORA_TOKENS, True, unload_ad1)
        check(unloaded.get("status") == 200 and unloaded["body"] == {
            "status": "ok", "removed": True},
              f"4m: unload while streams run: {unloaded}")
        check(unloaded["retiring"] == [1] and unloaded["running"] > 0,
              f"4m: ad1's slot not retiring while its streams ran "
              f"{unloaded}")
        t0 = time.perf_counter()
        while srv.llm.stats()["lora_retiring_slots"]:
            check(time.perf_counter() - t0 < 10, "4m: ad1's slot never freed")
            time.sleep(0.01)
        status, state, _ = _call(srv.port, "GET", "/debug/state")
        check(state["stats"]["lora_free_slots"] == 1.0
              and state["stats"]["lora_adapters_loaded"] == 1.0,
              f"4m: /debug/state after the drain {state['stats']}")
        gone = srv.one("ad1", 0, 16)
        base = srv.one(MODEL, 0, 16)
        status, body, load3 = srv.lora("/v1/load_lora_adapter",
                                       {"lora_name": "ad3",
                                        "lora_path": paths["ad3"]})
        check(status == 200 and body["slot"] == 1,
              f"4m: ad3 into the freed slot: {status} {body}")
        ad3 = srv.one("ad3", 0, 16)
        info = srv.close()
    except BaseException:
        srv.close()
        raise
    # The warm rounds, and the unload round, bit for bit.
    for name, r in (("second warm round", warm[1]),
                    ("round with the unload", during)):
        parted = {s: next((j for j, (a, b) in enumerate(zip(
            r["tokens"][s] + r["tops"][s],
            warm[0]["tokens"][s] + warm[0]["tops"][s])) if a != b), None)
            for s in LORA_STREAMS}
        parted = {s: j for s, j in parted.items() if j is not None}
        check(not parted, f"4m: the {name} parts from the first warm round "
              f"(stream: position) {parted}")
    # Adapters loaded after the decode buckets were captured: their
    # decode steps replay those graphs, and their tokens part from the
    # base model's on the same prompts.
    for r in [cold] + warm:
        decode_keys = [k for k in r["new_keys"] if k[0] == "burst" or dict(
            k[1])["tokens"][1:] == (1,)]
        check(not decode_keys and r["graphs"][1]["replayed"]
              > r["graphs"][0]["replayed"],
              f"4m: decode keys captured after the load {decode_keys}, "
              f"graphs {r['graphs']}")
    w = warm[0]["tokens"]
    differs = {s: w[s] != w[(MODEL, s[1])] for s in LORA_STREAMS
               if s[0] != MODEL}
    check(sum(differs.values()) >= len(differs) - 1,
          f"4m: adapter streams equal to the base streams of their "
          f"prompts {differs}")
    check(gone["tokens"] == base["tokens"] and gone["model"] == "ad1",
          f"4m: a request naming the unloaded ad1 {gone} against the base "
          f"model's {base}")
    check(ad3["tokens"] != base["tokens"], "4m: ad3 served the base tokens")

    # 4m(d): speculation with the adapters.
    srv = LoraServer(params, argv + ["--speculative-ngram", "4"])
    try:
        srv.round(capture, 2 * LORA_TOKENS, False)
        _load_both(srv, paths)
        srv.round(LORA_STREAMS, LORA_TOKENS, False)
        spec = srv.round(LORA_STREAMS, LORA_TOKENS, False)
        verify = list(srv.verify)
        samples = scrape(srv.port)
        spec_info = srv.close()
    except BaseException:
        srv.close()
        raise
    agree_to, base_to = {}, {}
    for s in LORA_STREAMS:
        got, want, gap = spec["tokens"][s], w[s], warm[0]["gaps"][s]
        near = next((j for j, g in enumerate(gap) if g <= gap_tol),
                    LORA_TOKENS)
        first = next((j for j, (a, b) in enumerate(zip(got, want))
                      if a != b), LORA_TOKENS)
        check(len(got) == LORA_TOKENS and first >= near,
              f"4m(d): stream {s} parts from (c)'s at {first}, before the "
              f"first near-tie at {near}")
        agree_to[f"{s[0]}:{s[1]}"] = (near, first)
        if s[0] != MODEL:  # how far it follows the base model's stream
            base_to[f"{s[0]}:{s[1]}"] = next(
                (j for j, (a, b) in enumerate(zip(got, w[(MODEL, s[1])]))
                 if a != b), LORA_TOKENS)
    lora_steps = sum(1 for _, n in verify if n)
    check(lora_steps > 0, f"4m(d): no verify step held an adapter row "
          f"({len(verify)} verify steps)")
    check(samples.get("vllm:spec_decode_num_accepted_tokens_total", 0) > 0,
          "4m(d): nothing accepted")
    out = {"load_s": load_s, "load3_s": load3, "unload": unloaded,
           "differs": sum(differs.values()), "of": len(differs),
           "graphs": info["graphs"], "pages": info["pages"],
           "bank_bytes": info["bank_bytes"], "warm_wall_s": warm[0]["wall"],
           "verify_steps": len(verify), "verify_steps_with_lora": lora_steps,
           "verify_lora_rows": sum(n for _, n in verify),
           "spec_agree_to": agree_to, "spec_base_to": base_to,
           "spec_pages": spec_info["pages"]}
    log(f"[phase 4m(c)] LoRA server (--max-loras 2, rank {LORA_RANK}): "
        f"loads {[f'{s:.3f}' for s in load_s]} s, ad3 {load3:.3f} s; "
        f"{len(LORA_STREAMS)} streams x {LORA_TOKENS} tokens, warm rounds "
        f"and the unload round bit-equal; adapter streams apart from the "
        f"base on {out['differs']} of {out['of']}; no decode key captured "
        f"after the load; unload at token {unloaded['at']} "
        f"({unloaded['seconds']:.3f} s, slot retiring until the drain); "
        f"warm round {warm[0]['wall']:.3f} s; {info['pages']} pages, bank "
        f"{info['bank_bytes'] / 2**20:.1f} MiB; graphs {info['graphs']}; "
        f"{card}")
    log(f"[phase 4m(d)] with --speculative-ngram 4: {len(verify)} verify "
        f"steps, {lora_steps} with adapter rows ({out['verify_lora_rows']} "
        f"rows); (first near-tie, first difference) by stream {agree_to}; "
        f"gap tol {gap_tol:.4f}; an adapter stream's first difference from "
        f"(c)'s base stream of its prompt {base_to}")
    return out


def phase_lora_step_costs(params, card: str, paths: dict,
                          base_rows: list) -> dict:
    """Phase 4m(e): 3x's decode step (B=8 x 4096) and fresh T=512 chunk on
    a runner with ``enable_lora`` (8 slots of rank 16, the JAX config's
    defaults) and ``ad1`` and ``ad2`` installed, every row on an adapter
    (alternating), eager against replayed; beside 3x's rows of the same
    steps without LoRA (``base_rows``, this run). The bank's bytes and the
    KV pages they take."""
    W = GRAPH_CTX // BS
    cfg = EngineConfig(
        model=MODEL, device=DEV.type, max_num_seqs=GRAPH_B,
        max_prefill_tokens=GRAPH_T, max_model_len=GRAPH_CTX,
        num_decode_steps=GRAPH_N, num_kv_blocks=GRAPH_B * W + 1,
        enable_lora=True, max_loras=8, max_lora_rank=LORA_RANK)
    runner = ModelRunner(cfg, get_model_config(MODEL), params)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(11)
    runner.kv_cache.normal_(generator=gen)
    mgr = LoraManager(runner.model_cfg, 8, LORA_RANK, LORA_DIR)
    install = []
    for name in ("ad1", "ad2"):
        ad, arrays = mgr.load(name, paths[name])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.install_adapter(ad.slot, arrays)
        torch.cuda.synchronize()
        install.append(time.perf_counter() - t0)
    batches = graph_batches(runner)
    scale = np.float32(LORA_ALPHA / LORA_RANK)
    for name, b in batches.items():
        rows = b["kv_lens"].shape[0]
        b["lora_idx"] = (np.arange(rows) % 2 + 1).astype(np.int32)
        b["lora_scale"] = np.full(rows, scale, np.float32)
    log(f"[phase 4m(e)] {MODEL} bf16 steps with every row on an adapter "
        f"(slots 1 and 2 of 8), eager against replayed")
    rows = [graph_vs_eager(runner, f"bf16+LoRA decode B={GRAPH_B} x "
                           f"{GRAPH_CTX}", batches["decode"], True, False),
            graph_vs_eager(runner, f"bf16+LoRA prefill T={GRAPH_T} fresh",
                           batches["chunk"], True, True)]
    mc = runner.model_cfg
    page = 2 * mc.num_layers * BS * mc.kv_size * 2
    out = {"bank_bytes": runner.lora_bank_bytes,
           "pages_lost": -(-runner.lora_bank_bytes // page),
           "install_s": install, "rows": rows}
    for lora, base in zip(rows, base_rows[:2]):
        d = {how: {k: lora[how][k] - base[how][k]
                   for k in ("wall_ms", "device_busy_ms", "kernels_per_step")}
             for how in ("eager", "replayed")}
        lora["delta"] = d
        log(f"  {lora['step']}: against {base['step']} (3x, this run): "
            + "; ".join(f"{how} +{v['wall_ms']:.2f} ms wall, "
                        f"+{v['device_busy_ms']:.2f} ms busy, "
                        f"+{v['kernels_per_step']:.0f} kernels"
                        for how, v in d.items()))
    log(f"  bank (8 slots, rank {LORA_RANK}): "
        f"{out['bank_bytes'] / 2**20:.1f} MiB = {out['pages_lost']} KV "
        f"pages of {page / 2**20:.0f} MiB; installs "
        f"{[f'{s:.4f}' for s in install]} s; {card}")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# Phase 4n: the encode path (/v1/embeddings) and the cross-encoder
# ---------------------------------------------------------------------------

ENCODE_BUCKETS = (128, 512, 4096)
SCORING_MODEL = "bge-reranker-base"
# 4n(b)'s embedding requests during the streams: a string, token ids, and
# texts of a few hundred to a few thousand tokens.
ENCODE_TEXTS = [" ".join(f"block {i} of conversation {j}." for i in range(n))
                for j, n in enumerate((10, 35, 70, 120))]


def encode_tokens(cfg, T: int, seed: int) -> torch.Tensor:
    """A [1, T] prompt of random ids on the card."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return torch.randint(1, cfg.vocab_size, (1, T), generator=gen).to(DEV)


@contextlib.contextmanager
def plain_int4():
    """The model's int4 projections through the kernels' plain version
    (``int4_matmul_plain``: the weight dequantized to bf16, then cuBLAS)."""
    kernel = llama_mod.int4_matmul
    llama_mod.int4_matmul = i4.int4_matmul_plain
    try:
        yield
    finally:
        llama_mod.int4_matmul = kernel


@contextlib.contextmanager
def checked_int4(worst: list):
    """Each int4 projection of the model run through the kernel and, on
    the same x, through its plain version, held to the per-row rule of
    phase 2's int4 checks (``bf16_row_check``); each launch's worst
    err / row tol goes to ``worst``. The plain calls launch nothing."""
    kernel = llama_mod.int4_matmul

    def both(x, packed, scales):
        got = kernel(x, packed, scales)
        ok, ratio, _ = bf16_row_check(got, i4.int4_matmul_plain(
            x, packed, scales))
        worst.append(ratio)
        check(ok, f"int4 N={x.shape[0]} din={x.shape[1]} dout="
              f"{packed.shape[1]} inside the model: the kernel disagrees "
              "with its plain version")
        return got

    llama_mod.int4_matmul = both
    try:
        yield
    finally:
        llama_mod.int4_matmul = kernel


def encode_agree(got, want, label: str) -> dict:
    """Two encodes' vectors: the kernels' against the plain versions'.
    Held to ``MODEL_REL_ATOL`` of max|want|, the rule of this script's
    other whole-model kernel-against-plain checks (32 random bf16 layers
    carry a flipped rounding of one projection on to the vector); their
    ratio to ``_agree``'s numeric rule (``tests/test_numerics_oracle.py``:
    atol 2e-3 * max|want|, rtol 2e-3) is reported beside it."""
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite vector")
    err = (got - want).abs()
    scale = float(want.abs().max())
    worst = float(err.max())
    agree_ratio = float((err / (2e-3 * scale + 2e-3 * want.abs())).max())
    check(worst <= MODEL_REL_ATOL * scale,
          f"{label}: max|kernel - plain| {worst:.3e} is past "
          f"{MODEL_REL_ATOL} of max|plain| {scale:.3e}")
    return {"max_abs_err": worst, "max_abs": scale,
            "agree_rule_ratio": agree_ratio}


def phase_encode_model(model, params, card: str, quantized: bool = False
                       ) -> dict:
    """Phase 4n(a): ``Llama.encode`` at full width at buckets 128, 512 and
    4096 (and 16 in int4): each vector finite and of unit norm within
    1e-3; its time (the second call; the first loads what loads lazily)
    and the peak memory above what was allocated before it; at 128 and
    4096 in bf16, a ``torch.profiler`` breakdown. In int4 (with
    the fused write set, which an encode does not reach) each bucket
    launches the int4 route of its rows 7 times a layer; the kernels' run
    is held to the same encode through the plain ``int4_matmul``
    (``encode_agree``), and every launch of a third encode to its plain
    version on the same x (``checked_int4``); and the wgmma route's plan
    and time at N = 4096 on w_gate's shape, its first served N past
    2048."""
    cfg, L = model.cfg, model.cfg.num_layers
    out = {}
    tag = "int4" if quantized else cfg.dtype
    for T in ((16,) + ENCODE_BUCKETS if quantized else ENCODE_BUCKETS):
        toks, lens = encode_tokens(cfg, T, T), torch.tensor([T], device=DEV)
        model.encode(params, toks, lens)
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        vec = model.encode(params, toks, lens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        routes = route_counts()
        norm = float(vec.norm())
        check(vec.shape == (1, cfg.hidden_size)
              and bool(torch.isfinite(vec).all()) and abs(norm - 1) <= 1e-3,
              f"4n(a) {tag} T={T}: shape {tuple(vec.shape)}, norm {norm}")
        row = {"T": T, "ms": ms, "peak_bytes": peak, "norm": norm}
        msg = ""
        if quantized:
            want = "int4_decode" if T <= i4._DECODE_MAX_ROWS else "int4_wgmma"
            other = "int4_wgmma" if want == "int4_decode" else "int4_decode"
            check(routes[want] == 7 * L and routes[other] == 0
                  and routes["int4_simt"] == 0,
                  f"4n(a) int4 T={T}: routes {routes}, expected {7 * L} "
                  f"{want} launches")
            with plain_int4():
                ref = model.encode(params, toks, lens)
            row.update(encode_agree(vec, ref, f"4n(a) int4 T={T}"))
            launches: list = []
            with checked_int4(launches):
                model.encode(params, toks, lens)
            row["launch_worst_ratio"] = max(launches)
            row["routes"] = {want: routes[want],
                             "int4_sum": routes["int4_sum"]}
            msg = (f", {routes[want]} {want} launches; max|kernel - plain "
                   f"int4_matmul| {row['max_abs_err']:.3e} of max "
                   f"{row['max_abs']:.3e} ({row['agree_rule_ratio']:.2f} x "
                   f"_agree's rule); each launch against its plain version "
                   f"on the same x: worst err / row tol "
                   f"{row['launch_worst_ratio']:.3f}")
        log(f"[phase 4n(a)] {MODEL} {tag} encode T={T}: {ms:.2f} ms, peak "
            f"{peak / 2**20:.1f} MiB above the {base / 2**30:.2f} GiB "
            f"allocated before, |v| {norm:.6f}{msg}; {card}")
        if not quantized and T in (ENCODE_BUCKETS[0], ENCODE_BUCKETS[-1]):
            # Where the encode's time goes (torch.profiler, 2 encodes).
            prof = row["profile"] = profile(
                lambda: model.encode(params, toks, lens), 2, 6)
            log(f"  T={T} profiled: wall {prof['wall_ms']:.2f} ms, device "
                f"busy {prof['device_busy_ms']:.2f} ms (idle "
                f"{prof['idle_share']:.1%}), {prof['kernels_per_step']:.0f} "
                f"kernels; top: " + "; ".join(
                    f"{k['kernel'][:60]} {k['ms_per_step']:.2f} ms x "
                    f"{k['launches_per_step']:.0f}" for k in prof["top"]))
        out[f"t{T}"] = row
    if quantized:
        N, din, dout = 4096, cfg.hidden_size, cfg.intermediate_size
        layers = params["layers"]
        w = [(layers["w_gate"][li], layers["w_gate_q4s"][li]) for li in (0, 1)]
        G = din // w[0][1].shape[0]
        p = i4.plan("wgmma", N, din, dout, G)
        rows_t, cols_t = i4._TILES["wgmma"]
        check(p.grid == (N // rows_t, -(-dout // cols_t), 1) and p.splits == 1,
              f"4n(a) int4 N={N}: wgmma plan {p}")
        gen = torch.Generator(device=DEV)
        gen.manual_seed(4096)
        x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
        check(i4.route(x, *w[0]) == "wgmma", "4n(a) N=4096: not the wgmma "
              "route")
        dense = [i4.dequant_int4(pk, sc, torch.bfloat16) for pk, sc in w]
        got = i4.int4_matmul(x, *w[0])
        compare("int4_wgmma", got, torch.matmul(x.float(), dense[0].float()),
                f"int4 bf16 N={N} din={din} dout={dout} vs fp32 product of "
                "the bf16-dequantized weight", rows=True)
        turn = itertools.cycle((0, 1))
        ms = cuda_ms(lambda: i4.int4_matmul(x, *w[next(turn)]), iters=10)
        plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(x, *w[next(turn)]),
                           iters=3)
        lib_ms = cuda_ms(lambda: torch.matmul(x, dense[next(turn)]), iters=10)
        flops = 2 * N * din * dout
        nbytes = din * dout // 2 + (din // G) * dout * 4 + N * din * 2 \
            + N * dout * 4
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        out["wgmma_n4096"] = {
            "shape": f"N={N} din={din} dout={dout} G={G} bf16 x",
            "grid": list(p.grid), "splits": p.splits, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": "operations"}
        log(f"  int4_wgmma_kernel at N={N} x {din} x {dout}: grid {p.grid}, "
            f"{p.splits} split, {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"torch.matmul on the dequantized weight {lib_ms:.4f}, bound "
            f"{bound:.4f} ms by operations; {bound / ms:.1%} of it); {card}")
        del x, dense, got
    return out


def _embed(port: int, inp, model: str = MODEL) -> tuple:
    status, body, _ = _call(port, "POST", "/v1/embeddings",
                            {"model": model, "input": inp})
    return status, body


def _vectors(body: dict) -> list:
    return [np.asarray(d["embedding"], np.float32) for d in body["data"]]


def encode_during_streams(record: dict):
    """4n(b)'s ``during`` hook: in the ``embed`` round, once a pipelined
    burst is in flight, six embedding requests at once (four texts of
    about 60 to 2000 tokens, a token-id list and a batch of two)."""

    def during(kind, port, llm):
        if kind != "embed":
            return
        bursts = llm.pipelined_bursts_total
        deadline = time.perf_counter() + 30
        while (llm.pipelined_bursts_total == bursts
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        record["bursts_before"] = llm.pipelined_bursts_total - bursts
        inputs = ENCODE_TEXTS + [[(7 * i) % 500 + 1 for i in range(1000)],
                                 ENCODE_TEXTS[:2]]
        answers = [None] * len(inputs)

        def one(i):
            answers[i] = _embed(port, inputs[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(inputs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        record["seconds"] = time.perf_counter() - t0
        record["answers"] = answers
        record["inputs"] = inputs

    return during


def check_encode_server(port: int, engine, record: dict, card: str) -> dict:
    """4n(b)'s checks on the default bf16 server, then 4n(d)'s second app
    over the same engine with ``--scoring-model``."""
    runner = engine.engine.runner
    tok = engine.engine.tokenizer
    for (status, body), inp in zip(record["answers"], record["inputs"]):
        check(status == 200, f"4n(b) embeddings during the streams: {status}")
        items = inp if isinstance(inp, list) and isinstance(inp[0], str) \
            else [inp]
        for vec, item in zip(_vectors(body), items):
            ids = item if isinstance(item, list) else tok.encode(item)
            check(np.array_equal(vec, engine.encode(ids)),
                  "4n(b): a vector served during the streams differs from "
                  "runner.encode")
    # A string, a token-id list and a batch of three, each vector equal to
    # runner.encode on the same ids bit for bit.
    cases = {"string": ENCODE_TEXTS[1], "ids": list(range(7, 300)),
             "batch": ENCODE_TEXTS[:3]}
    sizes = {}
    for name, inp in cases.items():
        t0 = time.perf_counter()
        status, body = _embed(port, inp)
        sizes[name] = time.perf_counter() - t0
        check(status == 200, f"4n(b) {name}: {status} {body}")
        items = inp if name == "batch" else [inp]
        vecs = _vectors(body)
        check(len(vecs) == len(items) and body["usage"]["prompt_tokens"]
              == sum(len(x if isinstance(x, list) else tok.encode(x))
                     for x in items), f"4n(b) {name}: {body['usage']}")
        for vec, item in zip(vecs, items):
            ids = item if isinstance(item, list) else tok.encode(item)
            got = engine.encode(ids)
            check(np.array_equal(vec, got) and abs(np.linalg.norm(got) - 1)
                  <= 1e-3, f"4n(b) {name}: the served vector differs from "
                  "runner.encode")
    long_ids = list(range(1, engine.engine.cfg.max_model_len + 2))
    status, body = _embed(port, long_ids)
    check(status == 400, f"4n(b) past max_model_len: {status} {body}")
    status, flight, _ = _call(port, "GET", "/debug/flight?n=100000")
    rows = flight["records"]
    enc = [i for i, r in enumerate(rows) if r["kind"] == "encode"]
    between = [i for i in enc
               if any(r["kind"] == "decode" for r in rows[:i])
               and any(r["kind"] == "decode" for r in rows[i + 1:])]
    check(len(enc) >= 6 + 3 + 1 and between,
          f"4n(b): {len(enc)} encode flight rows, {len(between)} between "
          "decode steps")
    status, body, _ = _call(port, "POST", "/rerank", {
        "model": MODEL, "query": "q", "documents": ["a b", "c d"]})
    check(status == 200 and body["scoring_method"]
          == "embedding_cosine_similarity", f"4n(b) /rerank: {status} {body}")
    out = {"during_streams_s": record["seconds"],
           "bursts_before_embeddings": record["bursts_before"],
           "encode_flight_rows": len(enc),
           "encode_rows_between_decode_steps": len(between),
           "request_s": sizes}
    log(f"[phase 4n(b)] bf16 server: 6 embedding requests during the "
        f"embed round in {record['seconds']:.3f} s; {len(enc)} encode flight "
        f"rows, {len(between)} between decode steps; vectors equal "
        f"runner.encode bit for bit; past max_model_len 400; {card}")
    out["scoring_4n_d"] = phase_scoring_serving(engine, card)
    return out


def phase_scoring_serving(engine, card: str) -> dict:
    """Phase 4n(d): the same bf16 engine behind a second app with
    ``--scoring-model bge-reranker-base`` (random fp32 weights from a
    generator seeded 0, on the card): the five rerank and score routes
    answer, their scores equal ``CrossEncoder.score_pairs`` called
    directly, a pair alone scores as in a batch within 1e-4, the ranking
    is descending and ``top_n`` holds, ``scoring_method`` is
    ``cross_encoder``."""
    args = parse_engine_args(["--model", MODEL, "--device", DEV.type,
                              "--scoring-model", SCORING_MODEL])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ce = cross_encoder_from_args(args)
    load_s = time.perf_counter() - t0
    ce_bytes = torch.cuda.memory_allocated() - before
    server, thread = serve_in_thread(engine, cross_encoder=ce)
    port = server.server_address[1]
    docs = [f"document {i}: " + ENCODE_TEXTS[i % 4][: 40 * (i + 1)]
            for i in range(16)]
    query = "which block of the conversation?"
    try:
        direct = ce.score_pairs([(query, d) for d in docs])
        answers = {}
        for path in ("/rerank", "/v1/rerank", "/v2/rerank"):
            t1 = time.perf_counter()
            status, body, _ = _call(port, "POST", path, {
                "model": MODEL, "query": query, "documents": docs,
                "top_n": 5})
            answers[path] = time.perf_counter() - t1
            check(status == 200 and body["scoring_method"] == "cross_encoder",
                  f"4n(d) {path}: {status} {body}")
            res = body["results"]
            scores = [r["relevance_score"] for r in res]
            check(len(res) == 5 and scores == sorted(scores, reverse=True)
                  and scores == sorted(direct, reverse=True)[:5]
                  and all(direct[r["index"]] == r["relevance_score"]
                          for r in res), f"4n(d) {path}: {res}")
        pairs4 = ce.score_pairs([(query, d) for d in docs[:4]])
        for path in ("/score", "/v1/score"):
            status, body, _ = _call(port, "POST", path, {
                "model": MODEL, "text_1": query, "text_2": docs[:4]})
            check(status == 200 and body["scoring_method"] == "cross_encoder"
                  and [d["score"] for d in body["data"]] == pairs4,
                  f"4n(d) {path}: {status} {body}")
        alone = [ce.score_pairs([(query, d)])[0] for d in docs[:4]]
        gap = max(abs(a - b) for a, b in zip(alone, direct))
        check(gap <= 1e-4, f"4n(d): a pair alone against in a batch {gap}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    out = {"load_s": load_s, "weights_bytes": ce_bytes,
           "rerank_16_docs_s": answers, "alone_vs_batch": gap}
    log(f"[phase 4n(d)] {SCORING_MODEL} (random fp32, "
        f"{ce_bytes / 1e9:.2f} GB on the card, loaded in {load_s:.2f} s) "
        f"beside the bf16 engine: /rerank, /v1/rerank, /v2/rerank, /score, "
        f"/v1/score answer; scores equal score_pairs; a pair alone against "
        f"in a batch {gap:.2e}; a 16-document rerank "
        f"{min(answers.values()) * 1e3:.1f} ms; {card}")
    del ce
    return out


def phase_encode_serving(params, card: str) -> dict:
    """Phase 4n(b) and (d): the default bf16 server (the overlapped decode
    on its arrival gate). Three rounds of 8 greedy streams of 128 tokens:
    one to capture, one plain, one while six embedding requests arrive
    once a pipelined burst is in flight. The two warm rounds' tokens are
    equal bit for bit: an encode between steps disturbs no graph and no
    burst. Then ``check_encode_server`` and 4n(d)."""
    argv = ["--model", MODEL, "--device", DEV.type,
            "--max-num-batched-tokens", "512", "--max-num-seqs", "16"]
    record: dict = {}
    out = {}
    rounds, info = serve_rounds(
        params, argv, 8, 128, ("capture", "plain", "embed"),
        during=encode_during_streams(record),
        after=lambda port, engine: check_encode_server(port, engine, record,
                                                       card))
    plain, embed = rounds[1], rounds[2]
    check(embed["bursts"] > 0 and record["bursts_before"] > 0,
          f"4n(b): pipelined bursts {embed['bursts']}, "
          f"{record['bursts_before']} before the embeddings")
    parted = first_parting(dict(embed, tops={}), dict(plain, tops={}))
    check(len(plain["tokens"]) == 8 and not parted,
          f"4n(b): streams part from the plain round when embeddings arrive "
          f"(stream: first differing token) {parted}")
    log(f"[phase 4n(b)] 8 x 128 greedy tokens equal bit for bit with and "
        f"without the embeddings; pipelined bursts {plain['bursts']} and "
        f"{embed['bursts']}, rounds {plain['wall']:.3f} s and "
        f"{embed['wall']:.3f} s; {card}")
    out.update(info["after"])
    out["rounds_s"] = [r["wall"] for r in rounds]
    out["bursts"] = [r["bursts"] for r in rounds]
    return out


def phase_encode_int4_serving(q_params, card: str) -> dict:
    """Phase 4n(c): the int4 server with the fused write answers
    /v1/embeddings at T <= 16 and at T > 16, and each encode launches the
    int4 decode route (T <= 16) or the wgmma route 7 times a layer."""
    argv = ["--model", MODEL, "--device", DEV.type, "--quantization",
            "int4", "--max-num-batched-tokens", "512", "--max-num-seqs", "16"]
    engine, server, thread, _ = _tier_server(q_params, argv)
    port = server.server_address[1]
    L = get_model_config(MODEL).num_layers
    out = {}
    try:
        for n, want in ((12, "int4_decode"), (300, "int4_wgmma")):
            ids = list(range(5, 5 + n))
            reset_launch_counts()
            status, body = _embed(port, ids)
            counts = route_counts()
            vec = _vectors(body)[0] if status == 200 else None
            check(status == 200 and abs(np.linalg.norm(vec) - 1) <= 1e-3
                  and np.array_equal(vec, engine.encode(ids)),
                  f"4n(c) {n} tokens: {status}")
            other = "int4_wgmma" if want == "int4_decode" else "int4_decode"
            check(counts[want] == 7 * L and counts[other] == 0,
                  f"4n(c) {n} tokens: routes {counts}")
            out[f"n{n}"] = {want: counts[want], "int4_sum": counts["int4_sum"]}
        log(f"[phase 4n(c)] int4 server (fused write): /v1/embeddings of 12 "
            f"tokens launched {out['n12']['int4_decode']} int4_decode, of 300 "
            f"{out['n300']['int4_wgmma']} int4_wgmma (7 x {L} each); {card}")
    finally:
        _stop_server(engine, server, thread)
    return out


class CacheServer:
    """4n(e): a server subprocess on ``tiny-llama-debug`` on the card with
    ``--compile-cache-dir``, its output in a log file."""

    def __init__(self, cache_dir: str, log_path: str):
        self.port = free_port()
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.t0 = time.perf_counter()
        # Stopped at exit too, when a phase fails before ``finish``.
        atexit.register(self.stop)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
             "--model", "tiny-llama-debug", "--device", DEV.type, "--host",
             "127.0.0.1", "--port", str(self.port), "--num-kv-blocks", "64",
             "--compile-cache-dir", cache_dir],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=self.log, stderr=subprocess.STDOUT)

    def finish(self, limit: float = 400.0) -> dict:
        """Wait for ``/ready``; read ``/metrics`` and ``/debug/state``;
        stop the process."""
        try:
            while True:
                check(self.proc.poll() is None, "4n(e): the server exited: "
                      + open(self.log_path).read()[-2000:])
                check(time.perf_counter() - self.t0 < limit,
                      "4n(e): no /ready in time")
                try:
                    if _call(self.port, "GET", "/ready", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            ready_s = time.perf_counter() - self.t0
            m = scrape(self.port)
            stats = _call(self.port, "GET", "/debug/state")[1]["stats"]
        finally:
            self.stop()
        return {"ready_s": ready_s,
                "hits": m.get("pst_engine_compile_cache_hits_total", -1.0),
                "misses": m.get("pst_engine_compile_cache_misses_total", -1.0),
                "last_build_seconds": stats["kernel_build_seconds"]}


    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def phase_compile_cache(first: "CacheServer", cache_dir: str, card: str
                        ) -> dict:
    """Phase 4n(e): two server subprocesses on one fresh
    ``--compile-cache-dir``. The first (started earlier, beside other
    phases) misses and builds the kernel library; the second hits, with
    ``last_build_seconds == 0``; both read from ``/metrics`` and
    ``/debug/state``."""
    try:
        cold = first.finish()
        warm = CacheServer(cache_dir, first.log_path + ".2").finish()
        check(cold["misses"] == 1 and cold["hits"] == 0
              and cold["last_build_seconds"] > 0,
              f"4n(e) first start: {cold}")
        check(warm["hits"] == 1 and warm["misses"] == 0
              and warm["last_build_seconds"] == 0,
              f"4n(e) second start: {warm}")
        keyed = [d for d in os.listdir(cache_dir)
                 if os.path.isdir(os.path.join(cache_dir, d))]
        check(len(keyed) == 1 and os.listdir(os.path.join(cache_dir,
                                                           keyed[0])),
              f"4n(e): {cache_dir} holds {keyed}")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        for path in (first.log_path, first.log_path + ".2"):
            with contextlib.suppress(OSError):
                os.remove(path)
    log(f"[phase 4n(e)] --compile-cache-dir: first start built the kernel "
        f"library in {cold['last_build_seconds']:.1f} s (miss), /ready after "
        f"{cold['ready_s']:.1f} s; the second loaded it (hit, "
        f"last_build_seconds 0), /ready after {warm['ready_s']:.1f} s; {card}")
    return {"cold": cold, "warm": warm, "key": keyed[0]}


def start_compile_cache() -> tuple:
    """4n(e)'s first server, started in a fresh temp directory: its
    library builds beside the phases that run meanwhile."""
    cache_dir = tempfile.mkdtemp(prefix="pst_compile_cache_")
    return CacheServer(cache_dir, cache_dir + ".log"), cache_dir


# ---------------------------------------------------------------------------
# Phase 4o: mixture-of-experts (mixtral-8x7b in int4)
# ---------------------------------------------------------------------------

MOE_MODEL = "mixtral-8x7b"
MOE_TINY = "tiny-mixtral-debug"
# mixtral-8x7b in int4, from the shapes: the expert banks' packed nibbles
# 22.5 GB and their fp32 group scales 1.4 GB, attention 0.7 GB, the int8
# embed and lm_head 0.26 GB.
MOE_TREE_BYTES = (24.0e9, 26.0e9)
# The kernels and their plain versions round differently, so a near-tie
# in a router's top 2 can send a token to other experts in one run and not
# in the other, and a random 32-layer model carries such a flip on to
# other tokens (through attention) and later layers. The plain run held
# to the kernels' therefore takes the kernel run's expert choices; an
# unforced plain run gives the share of choices that differ.


def moe_tree(model) -> tuple:
    """4o(a): the int4 tree drawn and quantized on the card a slice at a
    time; its bytes by part and the peak allocated while drawing."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init_params(gen, DEV, quantization="int4")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base

    def nbytes(items):
        return sum(v.numel() * v.element_size() for _, v in items)

    layers = params["layers"].items()
    split = {
        "expert_banks": nbytes((k, v) for k, v in layers
                               if k.startswith(("w_gate", "w_up", "w_down"))),
        "attention": nbytes((k, v) for k, v in layers
                            if k.startswith(("wq", "wk", "wv", "wo"))),
        "embed_lm_head": nbytes((k, params[k]) for k in
                                ("embed", "embed_qs", "lm_head", "lm_head_qs")),
    }
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    split["router_and_norms"] = total - sum(split.values())
    log(f"[phase 4o] {MOE_MODEL} int4 on {DEV} in {secs:.1f}s: "
        f"{total / 1e9:.3f} GB resident ("
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in split.items())
        + f"); peak allocated while drawing {peak / 1e9:.2f} GB")
    check(MOE_TREE_BYTES[0] < total < MOE_TREE_BYTES[1],
          f"4o: the int4 tree holds {total} bytes")
    return params, {**split, "total": total, "peak_while_drawing": peak,
                    "seconds": secs}


@contextlib.contextmanager
def recorded_routes(calls: list, forced=None):
    """Each router call's expert ids ([N, k], one call a layer a step)
    appended to ``calls``. With ``forced`` (another run's ``calls``) each
    call takes that run's ids in turn instead of its own top k, weighted
    by its own router's probabilities of them, renormalized."""
    route = llama_mod.moe_route
    given = iter(forced) if forced is not None else None

    def recording(cfg, lp, x):
        if given is None:
            weights, ids = route(cfg, lp, x)
        else:
            ids = next(given)
            probs = torch.softmax(llama_mod.mm_f32(
                x.float(), lp["w_router"].float()), dim=-1)
            weights = probs.gather(-1, ids)
            weights = weights / weights.sum(dim=-1, keepdim=True)
        calls.append(ids.clone())
        return weights, ids

    llama_mod.moe_route = recording
    try:
        yield
    finally:
        llama_mod.moe_route = route


def route_flips(a_calls: list, b_calls: list, layers: int) -> dict:
    """The (token, layer) expert choices that differ between two runs of
    ``drive_model`` (the prompt's rows, then each decode step's live row;
    a decode step's row 1 pads), in all and by layer."""
    by_layer, choices = [0] * layers, 0
    for c, (a, b) in enumerate(zip(a_calls, b_calls)):
        step, layer = divmod(c, layers)
        live = a.shape[0] if step == 0 else 1
        diff = (a[:live].sort(-1).values != b[:live].sort(-1).values).any(-1)
        by_layer[layer] += int(diff.sum())
        choices += live
    return {"share": sum(by_layer) / max(choices, 1),
            "flipped": sum(by_layer), "choices": choices,
            "by_layer": by_layer}


def moe_int4_routes(cfg, N: int, steps: int) -> dict:
    """The int4 routes a run of one N-token prefill and ``steps`` decode
    steps (two rows) takes: every projection of the prefill on the wgmma
    route (a split-sum pass where its plan splits), every decode one on
    the decode route."""
    D, F, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    shapes = ([(D, cfg.q_size), (D, cfg.kv_size), (D, cfg.kv_size),
               (cfg.q_size, D)] + E * [(D, F), (D, F), (F, D)])
    L = cfg.num_layers
    sums = L * sum(i4.plan("wgmma", N, din, dout, 128).splits > 1
                   for din, dout in shapes)
    return {"wgmma": len(shapes) * L, "decode": len(shapes) * L * steps,
            "simt": 0, "sum": sums}


def phase_moe_model(model, params) -> dict:
    """4o(b): the forward through the kernels (each int4 launch also held
    to its plain version on the same x) against the plain versions on
    the kernel run's expert choices, the launch counts, the share of
    choices an unforced plain run makes otherwise, and a negative
    control."""
    cfg = model.cfg
    L = cfg.num_layers
    prompt, decode_tokens = model_prompt(cfg)
    n = len(decode_tokens)
    per_layer = 4 + 3 * cfg.num_experts
    got_routes, forced_routes, free_routes, worst = [], [], [], []
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_routes(got_routes), checked_int4(worst):
        got, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    t_cuda = time.perf_counter() - t0
    counts, routes = launch_counts(), dict(i4.route_counts)
    want = {"prefill": L, "decode": L * n, "decode_write": 0,
            "int4": per_layer * L * (1 + n)}
    check(counts == want, f"4o: launch counts {counts}, expected {want}")
    want = moe_int4_routes(cfg, len(prompt), n)
    check(routes == want, f"4o: int4 routes {routes}, expected {want}")
    with plain_int4():
        with recorded_routes(forced_routes, forced=got_routes):
            ref, _ = drive_model(model, params, "plain", prompt,
                                 decode_tokens)
        with recorded_routes(free_routes):
            free, _ = drive_model(model, params, "plain", prompt,
                                  decode_tokens)
    check(launch_counts() == counts,
          "4o: the plain versions launched a kernel")
    check(len(forced_routes) == len(got_routes) == L * (1 + n) and all(
        torch.equal(a, b) for a, b in zip(forced_routes, got_routes)),
        "4o: the forced plain run took other experts")
    summary = agree(got, ref, "4o")
    flips = route_flips(got_routes, free_routes, L)
    free_err = float((got - free).abs().max())
    log(f"  4o(b) 512-token prefill + {n} decode steps, launches "
        f"{counts} (int4 {per_layer} a layer a step), each int4 launch "
        f"within {max(worst):.3f} of its row tolerance against its plain "
        f"version on the same x; against the plain versions on the same "
        f"expert choices: {summary}; an unforced plain run chose other "
        f"experts for {flips['flipped']} of {flips['choices']} (token, "
        f"layer) choices ({flips['share']:.4%}; by layer "
        f"{flips['by_layer']}), its logits max|diff| {free_err:.4f}; "
        f"kernels {t_cuda:.2f}s (with the per-launch checks)")
    out = {"agree": summary, "flips": flips,
           "unforced_max_abs_err": free_err,
           "worst_launch_ratio": max(worst), "launches": counts,
           "int4_routes": routes}

    # The negative control: layer 0's w_gate bank (every expert) read with
    # its two nibble planes swapped by the kernels must fail the check
    # against the plain versions on the true bank.
    bank = params["layers"]["w_gate"][0]
    saved = bank.clone()
    bank.copy_(torch.bitwise_left_shift(saved, 4) | ((saved >> 4) & 0x0F))
    bad_routes = []
    try:
        with recorded_routes(bad_routes):
            bad, _ = drive_model(model, params, "cuda", prompt,
                                 decode_tokens)
    finally:
        bank.copy_(saved)
    with plain_int4(), recorded_routes([], forced=bad_routes):
        ref, _ = drive_model(model, params, "plain", prompt, decode_tokens)
    err = float((bad - ref).abs().max())
    tol = MODEL_REL_ATOL * float(ref.abs().max())
    log(f"  4o(b) negative control (layer 0's w_gate nibbles swapped): "
        f"max|logit - plain| {err:.4f} against the tolerance {tol:.4f}")
    check(err > tol, "4o: the check passes a bank with swapped nibbles")
    out["negative_control"] = {"max_abs_err": err, "tol": tol}
    return out


def moe_step_flops(cfg, N: int) -> tuple:
    """The expert products' FLOPs of an N-token step in the port (every
    expert over N rows), and of the routed pairs alone."""
    each = 2 * 3 * cfg.hidden_size * cfg.intermediate_size
    full = cfg.num_layers * cfg.num_experts * N * each
    return full, full * cfg.num_experts_per_tok // cfg.num_experts


def phase_moe_steps(params) -> list:
    """4o(c): a decode step at B=8 x 4096 and a fresh T=512 chunk through
    the runner, eagerly and replayed under CUDA's sync debug mode set to
    raise, and eager against replayed (``graph_vs_eager``); the decode
    step's byte bound over every expert and over the experts its rows
    routed to."""
    cfg = get_model_config(MOE_MODEL)
    L, E = cfg.num_layers, cfg.num_experts
    runner = graph_runner(params, "int4", MOE_MODEL)
    check(runner.moe_impl == "ragged", f"4o(c): runner form {runner.moe_impl}")
    batches = graph_batches(runner)
    rows, calls = [], []
    for label, key, want_lp, greedy, N in (
            (f"decode B={GRAPH_B} x {GRAPH_CTX}", "decode", True, False,
             GRAPH_B),
            (f"prefill T={GRAPH_T} fresh", "chunk", True, True, GRAPH_T)):
        batch = batches[key]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with recorded_routes(calls if key == "decode" else []):
                runner.eager_step(runner._put(batch), want_lp, greedy)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        row = graph_vs_eager(runner, f"mixtral int4 {label}", batch,
                             want_lp, greedy)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner._step(batch, want_lp, greedy)  # a replay
        finally:
            torch.cuda.set_sync_debug_mode(0)
        full, routed = moe_step_flops(cfg, N)
        row.update(expert_flops=full, routed_expert_flops=routed)
        top = "; ".join(
            f"{t['kernel'][:60]} {t['ms_per_step']:.3f} ms "
            f"({t['launches_per_step']:.0f})"
            for t in row["replayed"]["top"])
        log(f"  4o(c) {label}: eager and replayed ran with no host sync; "
            f"expert products {full / 1e12:.3f} TFLOP a step (the routed "
            f"pairs alone {routed / 1e12:.3f}); replayed, the top kernels "
            f"a step: {top}")
        rows.append(row)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    # The decode step's byte bound: every weight read once, and every
    # row's keys and values; then with only the experts that the step's
    # rows routed to in each layer (one router call a layer).
    check(len(calls) == L, f"4o(c): {len(calls)} router calls, expected {L}")
    touched = [int(c[:GRAPH_B].unique().numel()) for c in calls]
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    banks = sum(v.numel() * v.element_size()
                for k, v in params["layers"].items()
                if k.startswith(("w_gate", "w_up", "w_down")))
    expert_bytes = banks // (L * E)  # one expert's three slices in a layer
    routed_weights = weights - banks + sum(touched) * expert_bytes
    kv = (2 * GRAPH_B * GRAPH_CTX * L * cfg.kv_size
          * torch.bfloat16.itemsize)
    bound_ms = (weights + kv) / PEAK_BYTES_PER_S * 1e3
    routed_ms = (routed_weights + kv) / PEAK_BYTES_PER_S * 1e3
    log(f"  4o(c) decode step byte bound: {weights / 1e9:.2f} GB of weights "
        f"+ {kv / 1e9:.2f} GB of KV at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s = "
        f"{bound_ms:.2f} ms; the {GRAPH_B} rows routed to {sum(touched)} of "
        f"{L * E} (layer, expert) pairs (by layer {touched}): "
        f"{routed_weights / 1e9:.2f} GB of weights, {routed_ms:.2f} ms")
    rows.append({"decode_bound_ms": bound_ms, "weight_bytes": weights,
                 "kv_bytes": kv, "routed_bound_ms": routed_ms,
                 "routed_weight_bytes": routed_weights,
                 "experts_touched_by_layer": touched})
    return rows


def phase_moe_serving(params, card: str) -> dict:
    """4o(d): the server of ``--model mixtral-8x7b --quantization int4
    --moe-impl auto``, a warm round then a timed one. Prefix caching is
    off, so the timed round's prefills compute what the warm round's did
    (a cached prompt prefills only its tail: other shapes, other
    rounding, and a random model's greedy tokens turn on it)."""
    n_req, n_tok = 4, 32
    argv = ["--model", MOE_MODEL, "--device", DEV.type, "--quantization",
            "int4", "--moe-impl", "auto", "--max-num-batched-tokens", "512",
            "--num-decode-steps", "4", "--max-num-seqs", "16",
            "--no-enable-prefix-caching"]
    check(engine_config_from_args(parse_engine_args(argv)).moe_impl == "auto",
          "4o(d): --moe-impl did not reach the config")
    r = serve_streams(params, argv, n_req, n_tok, streamed={0})
    gc.collect()
    torch.cuda.empty_cache()
    warm, graphs = r["warm_graphs"], r["graphs"]
    counts, m, before = r["counts"], r["samples"], r["before"]
    parted = {i: next((j for j, (a, b) in enumerate(zip(
        r["tokens"][k], r["warm_tokens"].get(k, []))) if a != b), -1)
        for i, k in enumerate(sorted(r["tokens"]))
        if r["tokens"][k] != r["warm_tokens"].get(k)}
    check(len(r["tokens"]) == n_req
          and all(len(t) == n_tok for t in r["tokens"].values())
          and not parted,
          f"4o(d): the timed round's tokens differ from the warm round's "
          f"(stream: first differing position) {parted}")
    check(graphs["eager"] == warm["eager"]
          and graphs["captured"] == warm["captured"]
          and graphs["replayed"] > warm["replayed"],
          f"4o(d): after the warm round {warm}, then {graphs}: a step of "
          "the timed round did not replay")
    for k in ("int4", "int4_wgmma", "int4_decode", "prefill",
              "prefill_wgmma"):
        check(counts.get(k, 0) > 0, f"4o(d): the {k} counter did not grow: "
              f"{counts}")
    check(counts.get("decode", 0) + counts.get("decode_write", 0) > 0,
          f"4o(d): no decode attention launched: {counts}")

    def grew(name):
        return m.get(name, 0.0) - before.get(name, 0.0)

    ttft = (grew("vllm:time_to_first_token_seconds_sum")
            / max(grew("vllm:time_to_first_token_seconds_count"), 1.0))
    busy = grew("pst_engine_device_busy_seconds_total")
    out = {"ttft_mean_s": ttft, "wall_s": r["wall"],
           "output_tok_per_s": n_req * n_tok / r["wall"],
           "steps_share_of_wall": busy / r["wall"],
           "idle_share": max(0.0, 1.0 - busy / r["wall"]),
           "graphs_warm": warm, "graphs": graphs, "launches": counts}
    log(f"[phase 4o(d)] {MOE_MODEL} int4 server (--moe-impl auto): {n_req} "
        f"concurrent greedy completions of {n_tok} tokens (one streamed), "
        f"timed round equal to the warm one, every step replayed "
        f"(graphs {warm} -> {graphs}); TTFT mean {ttft * 1e3:.1f} ms, "
        f"{out['output_tok_per_s']:.1f} output tok/s, wall "
        f"{r['wall']:.3f}s, steps busy {busy:.3f}s (idle share "
        f"{out['idle_share']:.1%}); launches {counts}; {card}")
    return out


def phase_moe_tiny() -> dict:
    """4o(e): tiny-mixtral-debug (fp32, head_dim 16) served on the card:
    the CUDA-core attention kernels and the fp32 experts."""
    prompt = list(range(5, 300))
    engine = LLMEngine(EngineConfig(device="cuda", model=MOE_TINY))
    reset_launch_counts()
    got = engine.generate([prompt], SamplingParams(
        max_tokens=16, temperature=0.0, ignore_eos=True))[0]
    torch.cuda.synchronize()
    out = {k: pac.route_counts[k] for k in ("decode_simt", "prefill_simt")}
    check(len(got["token_ids"]) == 16 and all(out.values())
          and sum(pac.route_counts.values()) == sum(out.values())
          and i4.launch_counts["int4"] == 0,
          f"4o(e): {got}, routes {pac.route_counts}, int4 "
          f"{i4.launch_counts}")
    log(f"[phase 4o(e)] {MOE_TINY} on {DEV}: a {len(prompt)}-token prompt "
        f"-> 16 tokens; launches {out}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe(card: str) -> dict:
    """Phase 4o, (a) to (e). The caller has freed the other models."""
    model = Llama(get_model_config(MOE_MODEL))
    params, tree = moe_tree(model)
    out = {"tree_4o_a": tree, "model_4o_b": phase_moe_model(model, params)}
    gc.collect()
    torch.cuda.empty_cache()
    out["steps_4o_c"] = phase_moe_steps(params)
    out["serving_4o_d"] = phase_moe_serving(params, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["tiny_4o_e"] = phase_moe_tiny()
    return out


# ---------------------------------------------------------------------------
# Phase 4p: tensor parallelism, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

TP_SIZE = 2
TP_LABEL = "gloo on one card"
# Llama-3-8B's projections at tp 2, one rank's (din, dout).
TP_SHARD_SHAPES = (("wq", 4096, 2048), ("wk", 4096, 512), ("wv", 4096, 512),
                   ("wo", 2048, 4096), ("w_gate", 4096, 7168),
                   ("w_up", 4096, 7168), ("w_down", 7168, 4096))
TP_REPORT = re.compile(r"rank report (\{.*\})")


def tp_ranks() -> "Ranks":
    """Two ranks on ``cuda:0``: this process and one spawned follower
    (which inherits ``PST_FUSED_KV_WRITE`` as it stands)."""
    ranks = start_ranks(EngineConfig(model=MODEL, tensor_parallel_size=TP_SIZE))
    check(ranks.ctx.backend == "gloo" and ranks.ctx.devices == [
        "0/cuda:0"] * TP_SIZE, f"4p: ranks {ranks.ctx.devices}, device group "
        f"{ranks.ctx.backend}: expected gloo on one card")
    log(f"  4p ranks: control group gloo, device group {ranks.ctx.backend}, "
        f"devices {ranks.ctx.devices}, follower pids {ranks.pids}")
    return ranks


def tp_batches(prompt, decode_tokens, nb: int) -> list:
    """``drive_model``'s steps as runner batches: the prompt's prefill into
    pages in reverse, then one decode step a token beside a padding row."""
    T = len(prompt)
    tables = np.arange(nb - 1, dtype=np.int32)[None, ::-1].copy()
    drop = nb * BS

    def slot(p):
        return int(tables[0, p // BS]) * BS + p % BS

    out = [{"tokens": np.array([prompt], np.int32),
            "positions": np.arange(T, dtype=np.int32)[None],
            "write_idx": np.array([[slot(p) for p in range(T)]], np.int32),
            "block_tables": tables, "kv_lens": np.array([T], np.int32),
            "last_idx": np.array([T - 1], np.int32)}]
    for i, tok in enumerate(decode_tokens):
        p = T + i
        out.append({"tokens": np.array([[tok], [0]], np.int32),
                    "positions": np.array([[p], [0]], np.int32),
                    "write_idx": np.array([[slot(p)], [drop]], np.int32),
                    "block_tables": np.concatenate(
                        [tables, np.zeros_like(tables)]),
                    "kv_lens": np.array([p + 1, 0], np.int32),
                    "last_idx": np.zeros(2, np.int32)})
    return out


def tp_rank_rows(label: str, before: list, after: list, want: dict,
                 phase: str = "4p") -> list:
    """Each rank's launches in a phase (its counters' change), checked
    against ``want``, with its device, graph counts, peak memory and KV
    blocks; logged."""
    rows = []
    for b, a in zip(before, after):
        d = {k: n - b["launches"].get(k, 0) for k, n in a["launches"].items()
             if n != b["launches"].get(k, 0)}
        check({k: d.get(k, 0) for k in want} == want,
              f"{phase} {label}: rank {a['rank']} launched {d}, expected "
              f"{want}")
        row = {"rank": a["rank"], "device": a["device"],
               "backend": a["backend"], "graph_counts": a["graph_counts"],
               "launches": d, "peak_memory_gb": a["peak_memory_bytes"] / 1e9,
               "num_blocks": a["num_blocks"]}
        log(f"  {phase} {label} rank {row['rank']} on {row['device']} "
            f"({row['backend']}): graphs {row['graph_counts']}, launches "
            f"{d}, peak memory {row['peak_memory_gb']:.2f} GB, "
            f"{row['num_blocks']} KV blocks")
        rows.append(row)
    return rows


def tp_model(ranks, model, params, quant, label: str) -> dict:
    """4p(a) and (b): the whole tree at tp 1 on the card (``drive_model``)
    against a tp-2 runner on ``ranks`` (each rank draws its shard of the
    same seed) through the same 512-token prefill and 8 teacher-forced
    decode steps (``forward_logits``); every position's logits under
    ``agree``, and both ranks' kernel launches."""
    cfg = model.cfg
    prompt, decode_tokens = model_prompt(cfg)
    ref, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    nb = -(-(len(prompt) + len(decode_tokens)) // BS) + 1
    ecfg = EngineConfig(model=MODEL, tensor_parallel_size=TP_SIZE,
                        num_kv_blocks=nb, block_size=BS, max_model_len=1024,
                        max_num_seqs=2, max_prefill_tokens=len(prompt),
                        quantization=quant)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = ranks.build_runner(ecfg)
    t_build = time.perf_counter() - t0
    try:
        before = runner.rank_reports()
        rows, times = [], []
        for batch in tp_batches(prompt, decode_tokens, nb):
            t0 = time.perf_counter()
            logits = runner.forward_logits(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rows.append(logits[0])
        got = torch.stack(rows)
        after = runner.rank_reports()
    finally:
        ranks.publisher.shutdown()
    L, n = cfg.num_layers, len(decode_tokens)
    fused = os.environ.get("PST_FUSED_KV_WRITE") == "1"
    want = {"prefill": L, "decode_write" if fused else "decode": L * n,
            "decode_write_split" if fused else "decode_split": L * n,
            "prefill_wgmma": L}
    if quant:
        want["int4"] = 7 * L * (1 + n)
    per_rank = tp_rank_rows(label, before, after, want)
    summary = agree(got, ref, f"4p {label}")
    decode_ms = statistics.median(times[1:]) * 1e3
    log(f"  4p {label}: tp 2 against tp 1, 512-token prefill + {n} decode "
        f"steps: {summary}; runner built in {t_build:.1f}s; step times "
        f"({TP_LABEL}): prefill {times[0] * 1e3:.1f} ms, decode median "
        f"{decode_ms:.1f} ms")
    return {"agree": summary, "ranks": per_rank,
            "prefill_ms_gloo_one_card": times[0] * 1e3,
            "decode_ms_gloo_one_card": decode_ms}


def tp_int4_shapes(card: str) -> list:
    """Each tp-2 shard shape at a decode step's 2 rows and a prefill's 512:
    the int4 kernel held against ``int4_matmul_plain`` on the route the
    main path takes there (decode, wgmma), then timed (the
    ``int4_crossover`` way)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    rows = []
    for name, din, dout in TP_SHARD_SHAPES:
        packed, scales = int4_weights(gen, din, dout)
        for N in (2, 512):
            x = torch.randn((N, din), generator=gen, device=DEV,
                            dtype=torch.bfloat16)
            want = "decode" if N <= i4._DECODE_MAX_ROWS else "wgmma"
            err, ratio = int4_check(x, packed, scales,
                                    f"4p int4 shard {name} N={N} din={din} "
                                    f"dout={dout}", want)
            ms = cuda_ms(lambda: i4.int4_matmul(x, packed, scales))
            rows.append({"name": name, "N": N, "din": din, "dout": dout,
                         "route": want, "ms": ms, "max_abs_err": err,
                         "err_over_row_tol": ratio})
            log(f"  4p int4 shard {name} {din}x{dout} N={N}: {want}, "
                f"{ms * 1e3:.1f} us ({card}); against the plain version: "
                f"worst err / row tol {ratio:.2e}")
    return rows


def _tp_children(pid: int) -> list:
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        return [int(p) for p in f.read().split()]


def _tp_gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def tp_greedy(port: int, prompts: list, n: int) -> list:
    """Greedy completions of ``n`` tokens; each one's chosen logprobs."""
    out = []
    for p in prompts:
        status, body, _ = _call(port, "POST", "/v1/completions", {
            "prompt": p, "max_tokens": n, "temperature": 0.0,
            "ignore_eos": True, "logprobs": 1})
        check(status == 200 and body["usage"]["completion_tokens"] == n,
              f"4p greedy: {status} {body}")
        out.append(body["choices"][0]["logprobs"]["token_logprobs"])
    return out


def tp_server(card: str, params) -> dict:
    """4p(c): ``python -m production_stack_tpu_torch.engine.server --model
    llama-3-8b --tensor-parallel-size 2`` through its ``main``: greedy,
    streamed and seeded sampled completions, ``/metrics`` and
    ``/debug/state``; SIGTERM stops every rank. Its greedy tokens against
    a tp-1 server's on the same weights (seed 0), by their chosen
    logprobs (the byte tokenizer names no id above 256)."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PST_FUSED_KV_WRITE"}
    log_path = os.path.join(tempfile.mkdtemp(), "tp_server.log")
    argv = [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
            "--model", MODEL, "--tensor-parallel-size", str(TP_SIZE),
            "--host", "127.0.0.1", "--port", str(port),
            "--gpu-memory-utilization", "0.6", "--max-model-len", "2048",
            "--max-num-seqs", "8"]
    prompts = [model_prompt(get_model_config(MODEL), 48 + 16 * i)[0]
               for i in range(3)]
    n_tok = 16
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(argv, cwd=os.path.dirname(
            os.path.abspath(__file__)), stdout=logf, stderr=subprocess.STDOUT,
            env=env)
    pids = [proc.pid]
    try:
        while True:
            check(proc.poll() is None and time.perf_counter() - t0 < 300,
                  f"4p server did not come up: {open(log_path).read()[-3000:]}")
            try:
                if _call(port, "GET", "/ready", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        t_up = time.perf_counter() - t0
        pids += _tp_children(proc.pid)
        check(len(pids) >= TP_SIZE, f"4p server: pids {pids}")
        t0 = time.perf_counter()
        tp2 = tp_greedy(port, prompts, n_tok)
        t_greedy = time.perf_counter() - t0
        t0 = time.perf_counter()
        usage = _stream(port, {"prompt": prompts[0], "max_tokens": 32,
                               "temperature": 0.0, "ignore_eos": True}, 32)
        t_stream = time.perf_counter() - t0
        sampled = {"prompt": prompts[1], "max_tokens": n_tok,
                   "temperature": 0.8, "seed": 11, "ignore_eos": True}
        a = _completion(port, sampled, n_tok)
        b = _completion(port, sampled, n_tok)
        check(a["choices"] == b["choices"], "4p seeded sampling differs")
        status, text, _ = _call(port, "GET", "/metrics")
        check(status == 200 and "pst" in text, f"4p /metrics: {status}")
        status, state, _ = _call(port, "GET", "/debug/state")
        stats = state["stats"]
        check(stats["tensor_parallel_size"] == TP_SIZE
              and stats["tp_device_backend"] == "gloo",
              f"4p /debug/state: {stats}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    deadline = time.perf_counter() + 30
    while not all(_tp_gone(p) for p in pids) and time.perf_counter() < deadline:
        time.sleep(0.2)
    left = [p for p in pids if not _tp_gone(p)]
    check(not left, f"4p: rank pids {left} still alive after SIGTERM")
    with open(log_path) as f:
        out = f.read()
    reports = sorted((json.loads(m) for m in TP_REPORT.findall(out)),
                     key=lambda r: r["rank"])
    check([r["rank"] for r in reports] == list(range(TP_SIZE)),
          f"4p server: rank reports {reports}; log tail {out[-3000:]}")
    check(len({r["num_blocks"] for r in reports}) == 1
          and len({r["rows_digest"] for r in reports}) == 1,
          f"4p server: ranks disagree: {reports}")
    for r in reports:
        check(r["launches"].get("prefill", 0) > 0
              and r["launches"].get("decode", 0) > 0,
              f"4p server: rank {r['rank']} launched {r['launches']}")
        log(f"  4p(c) rank {r['rank']} on {r['device']} ({r['backend']}): "
            f"graphs {r['graph_counts']}, launches {r['launches']}, peak "
            f"memory {r['peak_memory_bytes'] / 1e9:.2f} GB")
    log(f"  4p(c) server up in {t_up:.1f}s; {reports[0]['num_blocks']} KV "
        f"blocks agreed; {len(prompts)} greedy x {n_tok} tokens in "
        f"{t_greedy:.2f}s, a 32-token stream in {t_stream:.2f}s "
        f"({TP_LABEL}; usage {usage}); stopped by SIGTERM, {len(pids)} pids "
        f"gone ({card})")

    # The tp-1 server on the same weights.
    engine = AsyncLLMEngine(EngineConfig(model=MODEL, num_kv_blocks=512,
                                         max_model_len=2048, max_num_seqs=8),
                            params=params)
    server, thread = serve_in_thread(engine)
    try:
        tp1 = tp_greedy(server.server_address[1], prompts, n_tok)
    finally:
        server.shutdown()
        engine.shutdown()
    agreed = 0
    for x, y in zip(tp2, tp1):
        for lx, ly in zip(x, y):
            if abs(lx - ly) > 0.05 * max(1.0, abs(ly)):
                break
            agreed += 1
    log(f"  4p(c) greedy tokens agreeing with the tp-1 server (by chosen "
        f"logprob, up to the first parting): {agreed} of "
        f"{len(prompts) * n_tok}")
    return {"num_blocks": reports[0]["num_blocks"], "ranks": reports,
            "up_s": t_up, "greedy_s_gloo_one_card": t_greedy,
            "stream32_s_gloo_one_card": t_stream,
            "agreed_with_tp1": agreed, "tokens": len(prompts) * n_tok}


def phase_tp(card: str, model, params) -> dict:
    """Phase 4p, (a) to (c), on one card: two ranks share ``cuda:0`` over
    gloo (NCCL refuses two ranks on one device). The NCCL path, a card a
    rank, is not run here."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[phase 4p] tensor parallelism, {TP_SIZE} ranks on one card "
        f"({card}; compute mode {mode}); the NCCL path (a card a rank) is "
        "not run on a one-card machine")
    check(mode.splitlines()[0] == "Default",
          f"4p: compute mode {mode!r} forbids two processes on the card")
    out = {"card": card, "compute_mode": mode, "nccl": "not run"}
    t0 = time.perf_counter()
    os.environ.pop("PST_FUSED_KV_WRITE", None)
    ranks = tp_ranks()
    try:
        out["model_4p_a"] = tp_model(ranks, model, params, None, "(a) bf16")
    finally:
        ranks.close()
    os.environ["PST_FUSED_KV_WRITE"] = "1"
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    q_params = model.init_params(gen, DEV, quantization="int4")
    ranks = tp_ranks()
    try:
        out["model_4p_b"] = tp_model(ranks, model, q_params, "int4",
                                     "(b) int4, fused write")
    finally:
        ranks.close()
        os.environ.pop("PST_FUSED_KV_WRITE")
    del q_params
    gc.collect()
    torch.cuda.empty_cache()
    out["int4_shards_4p_b"] = tp_int4_shapes(card)
    out["server_4p_c"] = tp_server(card, params)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 4p] passed in {time.perf_counter() - t0:.1f}s")
    return out


def tp_only(card: str) -> None:
    """``python3 chip_smoke.py tp``: phase 4p alone."""
    model, params = build_model()
    print(json.dumps({"tp_4p": phase_tp(card, model, params)}, default=str),
          flush=True)


# Phase 4q: pipeline and data parallelism on one card. Every rank of a
# layout shares cuda:0 over gloo, as 4p's do, so its step times are
# gloo's transport through the host, not pipeline or data parallel speed.
PP_LABEL = "gloo on one card"
PP_LAYOUT = dict(pipeline_parallel_size=2)
DP_LAYOUT = dict(data_parallel_size=2)
GRID_LAYOUT = dict(pipeline_parallel_size=2, data_parallel_size=2)
# The four distinct int4 projection shapes of Llama-3-8B (din, dout):
# wq and wo, wk and wv, w_gate and w_up, w_down.
LLAMA_INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096))
DP_ROWS = 8  # the 4q(b) decode batch, split 4 and 4


def pp_ranks(layout: dict) -> "Ranks":
    """The ranks of ``layout`` on ``cuda:0``: this process and spawned
    followers (which inherit ``PST_FUSED_KV_WRITE`` as it stands)."""
    ranks = start_ranks(EngineConfig(model=MODEL, **layout))
    n = ranks.ctx.world_size
    check(set(ranks.ctx.backends.values()) == {"gloo"}
          and ranks.ctx.devices == ["0/cuda:0"] * n,
          f"4q: ranks {ranks.ctx.devices}, device groups "
          f"{ranks.ctx.backends}: expected gloo on one card")
    log(f"  4q ranks {layout}: control group gloo, device groups "
        f"{ranks.ctx.backends}, devices {ranks.ctx.devices}, follower pids "
        f"{ranks.pids}")
    return ranks


def traffic_since(before: dict, after: dict) -> dict:
    """A rank report's hand-off and dp-exchange traffic in a phase."""
    return {kind: {k: after["traffic"][kind][k] - before["traffic"][kind][k]
                   for k in ("calls", "bytes", "seconds")}
            for kind in ("handoff", "dp_share")}


def pp_model(ranks, model, params) -> dict:
    """4q(a): the whole bf16 tree at one rank on the card
    (``drive_model``) against a pp-2 runner on ``ranks`` (each stage draws
    its 16 layers of the same seed) through the 512-token prefill and 8
    teacher-forced decode steps; every position's logits under ``agree``,
    each stage's launches for its own layers, its peak memory and its
    hand-off's bytes and time."""
    cfg = model.cfg
    prompt, decode_tokens = model_prompt(cfg)
    ref, _ = drive_model(model, params, "cuda", prompt, decode_tokens)
    nb = -(-(len(prompt) + len(decode_tokens)) // BS) + 1
    ecfg = EngineConfig(model=MODEL, **PP_LAYOUT, num_kv_blocks=nb,
                        block_size=BS, max_model_len=1024, max_num_seqs=2,
                        max_prefill_tokens=len(prompt))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = ranks.build_runner(ecfg)
    t_build = time.perf_counter() - t0
    try:
        before = runner.rank_reports()
        rows, times = [], []
        for batch in tp_batches(prompt, decode_tokens, nb):
            t0 = time.perf_counter()
            logits = runner.forward_logits(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rows.append(logits[0])
        got = torch.stack(rows)
        after = runner.rank_reports()
    finally:
        ranks.publisher.shutdown()
    Ls, n = cfg.num_layers // 2, len(decode_tokens)
    want = {"prefill": Ls, "decode": Ls * n, "decode_split": Ls * n,
            "prefill_wgmma": Ls}
    per_rank = tp_rank_rows("(a) bf16 pp 2", before, after, want, "4q")
    D, isz = cfg.hidden_size, cfg.torch_dtype.itemsize
    for row, b, a in zip(per_rank, before, after):
        t = traffic_since(b, a)["handoff"]
        # Two hops a forward (stage 0 -> 1, then 1 -> 0): [1, 512, D] for
        # the prefill, [2, 1, D] for a decode step beside its padding row.
        want_bytes = 2 * isz * D * (len(prompt) + 2 * n)
        check(t["calls"] == 2 * (1 + n) and t["bytes"] == want_bytes,
              f"4q(a) rank {row['rank']}: hand-off {t}, expected "
              f"{2 * (1 + n)} calls of {want_bytes} bytes")
        row["handoff"] = t
        log(f"  4q(a) rank {row['rank']} (stage {a['coords']['pp']}, "
            f"{a['layers']} layers): hand-off {t['calls']} calls, "
            f"{t['bytes'] / 2**20:.3f} MiB (prefill hop "
            f"{isz * len(prompt) * D / 2**20:.3f} MiB, decode hop "
            f"{isz * 2 * D / 2**10:.1f} KiB), {t['seconds'] * 1e3:.1f} ms in "
            f"the calls ({PP_LABEL}), peak memory "
            f"{row['peak_memory_gb']:.2f} GB")
    summary = agree(got, ref, "4q(a) pp 2")
    decode_ms = statistics.median(times[1:]) * 1e3
    log(f"  4q(a): pp 2 against one rank, 512-token prefill + {n} decode "
        f"steps: {summary}; runner built in {t_build:.1f}s; step times "
        f"({PP_LABEL}): prefill {times[0] * 1e3:.1f} ms, decode median "
        f"{decode_ms:.1f} ms")
    return {"agree": summary, "ranks": per_rank,
            "prefill_ms_gloo_one_card": times[0] * 1e3,
            "decode_ms_gloo_one_card": decode_ms}


def dp_batches(cfg, nb: int) -> tuple:
    """``DP_ROWS`` prompts of 64 + 8i tokens (seed 7), each in its own
    pages, as one prefill step padded to 128, then 8 teacher-forced
    decode steps of the ``DP_ROWS`` rows; and the pages written."""
    gen = torch.Generator().manual_seed(7)
    lens = [64 + 8 * i for i in range(DP_ROWS)]
    T, n = 128, 8
    W = -(-(T + n) // BS)
    tables = np.arange(DP_ROWS * W, dtype=np.int32).reshape(DP_ROWS, W)
    check(DP_ROWS * W < nb, f"4q(b): {DP_ROWS * W} pages of {nb}")
    drop = nb * BS

    def slot(i, p):
        return int(tables[i, p // BS]) * BS + p % BS

    tokens = np.zeros((DP_ROWS, T), np.int32)
    positions = np.zeros((DP_ROWS, T), np.int32)
    write = np.full((DP_ROWS, T), drop, np.int32)
    for i, m in enumerate(lens):
        tokens[i, :m] = torch.randint(1, cfg.vocab_size, (m,),
                                      generator=gen).numpy()
        positions[i, :m] = np.arange(m)
        positions[i, m:] = m - 1
        write[i, :m] = [slot(i, p) for p in range(m)]
    out = [{"tokens": tokens, "positions": positions, "write_idx": write,
            "block_tables": tables, "kv_lens": np.array(lens, np.int32),
            "last_idx": np.array(lens, np.int32) - 1}]
    for j in range(n):
        pos = np.array(lens, np.int32) + j
        out.append({
            "tokens": torch.randint(1, cfg.vocab_size, (DP_ROWS, 1),
                                    generator=gen).numpy().astype(np.int32),
            "positions": pos[:, None],
            "write_idx": np.array([[slot(i, p)] for i, p in enumerate(pos)],
                                  np.int32),
            "block_tables": tables, "kv_lens": pos + 1,
            "last_idx": np.zeros(DP_ROWS, np.int32)})
    return out, sorted({int(b) for b in tables.reshape(-1)})


def dp_model(ranks, q_params, card: str) -> dict:
    """4q(b): int4 with the fused write at dp 2: a prefill of
    ``DP_ROWS`` rows and 8 decode steps of them, each split 4 and 4
    between the replicas, against one rank on the whole int4 tree
    (``agree``: a replica's 4-row launches plan their splits and GEMMs
    unlike one rank's 8); both replicas' launches (the int4 decode route
    at N=4, the fused decode-write), their caches equal bit for bit on
    every written page, and the exchange's bytes and time. The int4
    kernel at N=4 held against its plain version at the four Llama
    shapes, route asserted."""
    cfg = get_model_config(MODEL)
    nb = DP_ROWS * (-(-(128 + 8) // BS)) + 2
    kw = dict(model=MODEL, quantization="int4", num_kv_blocks=nb,
              block_size=BS, max_model_len=1024, max_num_seqs=DP_ROWS,
              max_prefill_tokens=128 * DP_ROWS)
    batches, pages = dp_batches(cfg, nb)
    one = ModelRunner(EngineConfig(**kw), params=q_params)
    ref = torch.cat([one.forward_logits(b) for b in batches])
    del one
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner = ranks.build_runner(EngineConfig(**kw, **DP_LAYOUT))
    try:
        before = runner.rank_reports()
        rows, times = [], []
        for batch in batches:
            t0 = time.perf_counter()
            rows.append(runner.forward_logits(batch))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        after = runner.rank_reports()
        parts = runner.page_replicas(pages)
    finally:
        ranks.publisher.shutdown()
    got = torch.cat(rows)
    L, n = cfg.num_layers, len(batches) - 1
    want = {"prefill": L, "prefill_wgmma": L, "decode_write": L * n,
            "decode_write_split": L * n, "int4": 7 * L * (1 + n),
            "int4_decode": 7 * L * n}
    per_rank = tp_rank_rows("(b) int4 fused dp 2", before, after, want, "4q")
    check(torch.equal(parts[0], parts[1]),
          f"4q(b): the replicas' caches differ on "
          f"{int((parts[0] != parts[1]).any(-1).sum())} rows of "
          f"{len(pages)} written pages")
    page_mib = parts[0].numel() / 2**20
    for row, b, a in zip(per_rank, before, after):
        t = traffic_since(b, a)["dp_share"]
        row["dp_share"] = t
        log(f"  4q(b) rank {row['rank']} (replica {a['coords']['dp']}): "
            f"K/V exchange {t['calls']} calls, {t['bytes'] / 2**20:.3f} MiB "
            f"gathered ({t['bytes'] / max(t['calls'], 1) / 2**20:.3f} MiB a "
            f"step), {t['seconds'] * 1e3:.1f} ms in the calls ({PP_LABEL})")
    summary = agree(got, ref, "4q(b) dp 2")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    shapes = []
    for din, dout in LLAMA_INT4_SHAPES:
        packed, scales = int4_weights(gen, din, dout)
        x = torch.randn((DP_ROWS // 2, din), generator=gen, device=DEV,
                        dtype=torch.bfloat16)
        err, ratio = int4_check(x, packed, scales,
                                f"4q int4 {din}x{dout} N={DP_ROWS // 2}",
                                "decode")
        shapes.append({"din": din, "dout": dout, "N": DP_ROWS // 2,
                       "route": "decode", "max_abs_err": err,
                       "err_over_row_tol": ratio})
        log(f"  4q(b) int4 {din}x{dout} N={DP_ROWS // 2}: decode route, "
            f"against the plain version: worst err / row tol {ratio:.2e}")
    decode_ms = statistics.median(times[1:]) * 1e3
    log(f"  4q(b): dp 2 against one rank, {DP_ROWS}-row prefill + {n} "
        f"decode steps: {summary}; replicas' caches equal on {len(pages)} "
        f"written pages ({page_mib:.1f} MiB a replica); step times "
        f"({PP_LABEL}): prefill {times[0] * 1e3:.1f} ms, decode median "
        f"{decode_ms:.1f} ms ({card})")
    return {"agree": summary, "ranks": per_rank, "int4_shapes": shapes,
            "pages_equal": len(pages),
            "prefill_ms_gloo_one_card": times[0] * 1e3,
            "decode_ms_gloo_one_card": decode_ms}


def grid_server(card: str) -> dict:
    """4q(c): ``python -m production_stack_tpu_torch.engine.server --model
    llama-3-8b --pipeline-parallel-size 2 --data-parallel-size 2
    --quantization int4`` (four ranks) through its ``main``: greedy,
    streamed and seeded sampled completions, ``/metrics``,
    ``/debug/state``'s ranks; SIGTERM stops every rank, whose reports
    agree. Its greedy tokens against a one-rank int4 server's (the same
    seed), by their chosen logprobs."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PST_FUSED_KV_WRITE"}
    log_path = os.path.join(tempfile.mkdtemp(), "grid_server.log")
    argv = [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
            "--model", MODEL, "--pipeline-parallel-size", "2",
            "--data-parallel-size", "2", "--quantization", "int4",
            "--host", "127.0.0.1", "--port", str(port),
            "--gpu-memory-utilization", "0.6", "--max-model-len", "2048",
            "--max-num-seqs", "8"]
    prompts = [model_prompt(get_model_config(MODEL), 48 + 16 * i)[0]
               for i in range(3)]
    n_tok, world = 16, 4
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(argv, cwd=os.path.dirname(
            os.path.abspath(__file__)), stdout=logf, stderr=subprocess.STDOUT,
            env=env)
    pids = [proc.pid]
    try:
        while True:
            check(proc.poll() is None and time.perf_counter() - t0 < 300,
                  f"4q server did not come up: {open(log_path).read()[-3000:]}")
            try:
                if _call(port, "GET", "/ready", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        t_up = time.perf_counter() - t0
        pids += _tp_children(proc.pid)
        check(len(pids) >= world, f"4q server: pids {pids}")
        t0 = time.perf_counter()
        grid = tp_greedy(port, prompts, n_tok)
        t_greedy = time.perf_counter() - t0
        t0 = time.perf_counter()
        usage = _stream(port, {"prompt": prompts[0], "max_tokens": 32,
                               "temperature": 0.0, "ignore_eos": True}, 32)
        t_stream = time.perf_counter() - t0
        sampled = {"prompt": prompts[1], "max_tokens": n_tok,
                   "temperature": 0.8, "seed": 11, "ignore_eos": True}
        a = _completion(port, sampled, n_tok)
        b = _completion(port, sampled, n_tok)
        check(a["choices"] == b["choices"], "4q seeded sampling differs")
        status, text, _ = _call(port, "GET", "/metrics")
        check(status == 200 and "pst" in text, f"4q /metrics: {status}")
        status, state, _ = _call(port, "GET", "/debug/state")
        layout = [(r["rank"], r["dp"], r["pp"], r["tp"], r["device"])
                  for r in state["ranks"]]
        check(layout == [(r, r // 2, r % 2, 0, "0/cuda:0")
                         for r in range(world)],
              f"4q /debug/state ranks: {state['ranks']}")
        check(state["stats"]["pipeline_parallel_size"] == 2
              and state["stats"]["data_parallel_size"] == 2,
              f"4q /debug/state: {state['stats']}")
        log(f"  4q(c) /debug/state ranks (rank, dp, pp, tp, device): "
            f"{layout}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    deadline = time.perf_counter() + 30
    while not all(_tp_gone(p) for p in pids) and time.perf_counter() < deadline:
        time.sleep(0.2)
    left = [p for p in pids if not _tp_gone(p)]
    check(not left, f"4q: rank pids {left} still alive after SIGTERM")
    with open(log_path) as f:
        out = f.read()
    reports = sorted((json.loads(m) for m in TP_REPORT.findall(out)),
                     key=lambda r: r["rank"])
    check([r["rank"] for r in reports] == list(range(world)),
          f"4q server: rank reports {reports}; log tail {out[-3000:]}")
    check(len({r["num_blocks"] for r in reports}) == 1
          and len({r["rows_digest"] for r in reports}) == 1,
          f"4q server: ranks disagree: {reports}")
    for r in reports:
        check(r["layers"] == 16 and r["launches"].get("prefill", 0) > 0
              and r["launches"].get("decode", 0) > 0
              and r["launches"].get("int4", 0) > 0,
              f"4q server: rank {r['rank']} ran {r['layers']} layers, "
              f"launched {r['launches']}")
        log(f"  4q(c) rank {r['rank']} {r['coords']} on {r['device']} "
            f"({r['backends']}): graphs {r['graph_counts']}, launches "
            f"{r['launches']}, peak memory "
            f"{r['peak_memory_bytes'] / 1e9:.2f} GB, traffic {r['traffic']}")
    log(f"  4q(c) server up in {t_up:.1f}s; {reports[0]['num_blocks']} KV "
        f"blocks agreed; {len(prompts)} greedy x {n_tok} tokens in "
        f"{t_greedy:.2f}s, a 32-token stream in {t_stream:.2f}s "
        f"({PP_LABEL}; usage {usage}); stopped by SIGTERM, {len(pids)} pids "
        f"gone ({card})")

    # The one-rank int4 server, its tree drawn from the same seed.
    engine = AsyncLLMEngine(EngineConfig(model=MODEL, quantization="int4",
                                         num_kv_blocks=512,
                                         max_model_len=2048, max_num_seqs=8))
    server, thread = serve_in_thread(engine)
    try:
        one = tp_greedy(server.server_address[1], prompts, n_tok)
    finally:
        server.shutdown()
        engine.shutdown()
    agreed = 0
    for x, y in zip(grid, one):
        for lx, ly in zip(x, y):
            if abs(lx - ly) > 0.05 * max(1.0, abs(ly)):
                break
            agreed += 1
    log(f"  4q(c) greedy tokens agreeing with the one-rank server (by "
        f"chosen logprob, up to the first parting): {agreed} of "
        f"{len(prompts) * n_tok}")
    return {"num_blocks": reports[0]["num_blocks"], "ranks": reports,
            "up_s": t_up, "greedy_s_gloo_one_card": t_greedy,
            "stream32_s_gloo_one_card": t_stream,
            "agreed_with_one_rank": agreed, "tokens": len(prompts) * n_tok}


def phase_pp(card: str, model, params) -> dict:
    """Phase 4q, (a) to (c), on one card: every rank shares ``cuda:0``
    over gloo. The NCCL path (a card a rank) is not run here."""
    log(f"[phase 4q] pipeline and data parallelism on one card ({card}); "
        "every rank shares it over gloo, so step times are gloo's transport "
        "through the host, and the NCCL path (a card a rank) is not run")
    out = {"card": card, "nccl": "not run"}
    t0 = time.perf_counter()
    os.environ.pop("PST_FUSED_KV_WRITE", None)
    ranks = pp_ranks(PP_LAYOUT)
    try:
        out["model_4q_a"] = pp_model(ranks, model, params)
    finally:
        ranks.close()
    log(f"  4q(a) done at {time.perf_counter() - t0:.1f}s")
    os.environ["PST_FUSED_KV_WRITE"] = "1"
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    q_params = model.init_params(gen, DEV, quantization="int4")
    ranks = pp_ranks(DP_LAYOUT)
    try:
        out["model_4q_b"] = dp_model(ranks, q_params, card)
    finally:
        ranks.close()
        os.environ.pop("PST_FUSED_KV_WRITE")
    del q_params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  4q(b) done at {time.perf_counter() - t0:.1f}s")
    out["server_4q_c"] = grid_server(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 4q] passed in {out['seconds']:.1f}s")
    return out


def pp_only(card: str) -> None:
    """``python3 chip_smoke.py pp``: phase 4q alone."""
    model, params = build_model()
    print(json.dumps({"pp_4q": phase_pp(card, model, params)}, default=str),
          flush=True)


SPIN_CYCLES = 100_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls back to back
    between two CUDA events, queued behind a spin kernel so that the host's
    dispatch time is not counted (a version that makes the host wait for
    the card, as the plain decode-write does, still counts its stalls);
    the median over ``reps`` batches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def step_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Time of one call from its dispatch on an idle card: CUDA events
    around each call, so a host-bound step counts its host time; the
    median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gathered_kv(cache, tables, layer, kv_len, hd=HD, dtype=None):
    """K/V of one layer gathered into [B, KH, kv_len, hd] and cast to
    ``dtype`` (default the cache's): the yardstick's input, made before
    timing."""
    B, W = tables.shape
    kh = cache.shape[-1] // hd
    kv = gather_pages(cache, layer, tables).to(dtype or cache.dtype)
    k = kv[:, :, 0].reshape(B, W * BS, kh, hd)[:, :kv_len].transpose(1, 2)
    v = kv[:, :, 1].reshape(B, W * BS, kh, hd)[:, :kv_len].transpose(1, 2)
    return k.contiguous(), v.contiguous()


def sdpa(q, k, v, causal, scale=SCALE):
    # Yardstick only: one PyTorch call computing the same attention.
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale, enable_gqa=True)


# The heads the attention rows are timed at: Llama-3-8B's, and gemma2-9b's
# (head_dim 256, its softcap of 50 on the kernel and the plain version;
# SDPA takes no softcap, so the yardstick runs without one).
LLAMA_GEO = dict(h=H, kh=KH, hd=HD, scale=SCALE, softcap=0.0,
                 decode=((8, 4096), (1, 4096), (64, 4096), (64, 512)))
GEMMA2_GEO = dict(h=GEMMA2_HEADS["h"], kh=GEMMA2_HEADS["kh"], hd=HD256,
                  scale=HD256_SCALE, softcap=GEMMA2_HEADS["softcap"],
                  decode=((8, 4096), (1, 4096), (64, 4096), (64, 512)))


def phase_times(per_step: dict, launches: dict, card: str,
                cache_dtype=torch.bfloat16, geo=LLAMA_GEO) -> list:
    """Rows of the attention kernels at ``geo``'s heads (Llama-3-8B's by
    default; decode, prefill, decode-write) over a ``cache_dtype`` cache
    with bf16 q. ``per_step`` and ``launches`` hold each row's launches a
    step and on its path. The bound counts the K/V at the cache's
    itemsize; an e4m3 cache's yardstick is SDPA on K/V gathered and
    up-cast to bf16 beforehand. With a softcap (gemma2-9b) the kernel and
    its plain version are timed with it, SDPA without, and the kernel is
    held to SDPA without it."""
    h, kh, hd, scale, cap = (geo[k] for k in
                             ("h", "kh", "hd", "scale", "softcap"))
    tag = str(cache_dtype)[6:]
    heads = f"H={h} KH={kh} hd={hd}" + (f" softcap={cap:g}" if cap else "")
    log(f"[phase 5] kernel times at {heads}, {tag} cache ({card})")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(99)
    rows = []
    item = cache_dtype.itemsize
    dec_kind, dw_kind, pre_kind = (form(k, cache_dtype, hd) for k in
                                   ("decode", "decode_write", "prefill"))
    up = " and up-cast to bf16" if cache_dtype == E4M3 else ""
    nocap = ", without the softcap (SDPA takes none)" if cap else ""
    case = functools.partial(make_case, h=h, kh=kh, hd=hd, layers=4,
                             cache_dtype=cache_dtype)

    # Decode and decode-write: B=8, every row at kv_len 4096 (the profiled
    # step's shape), then one interactive user (B=1) and a large batch
    # (B=64) at 4096 and at 512. Four layers of cache (537 MB at B=8 in
    # bf16 at Llama's heads), each launch reads another layer, so the 50 MB
    # L2 never holds the KV. The decode-write writes its row each launch
    # (the same slot every time: kv_len counts it); no single PyTorch call
    # computes it, so the unfused pair it replaces (the rows cast to the
    # cache's type and index_copy_'d, then the decode kernel) is timed
    # beside it.
    decode, decode_write = [], []
    for B, kvl in geo["decode"]:
        q, cache, tables, kl, _ = case(gen, B=B, T=1, kv_lens=[kvl] * B)
        q3 = q[:, 0].contiguous()
        state = {"layer": 0}

        def turn():
            state["layer"] = (state["layer"] + 1) % 4
            return state["layer"]

        ms = cuda_ms(lambda: pac.paged_attention_decode(
            q3, cache, tables, kl, turn(), scale=scale, softcap=cap))
        plain_ms = cuda_ms(lambda: pac.paged_attention_decode_plain(
            q3, cache, tables, kl, 1, scale=scale, softcap=cap), iters=5)
        k, v = gathered_kv(cache, tables, 1, kvl, hd=hd, dtype=torch.bfloat16)
        qs = q3[:, :, None]  # [B, H, 1, hd]
        lib_ms = cuda_ms(lambda: sdpa(qs, k, v, False, scale))
        ref = sdpa(qs, k, v, False, scale)[:, :, 0]
        got = pac.paged_attention_decode(q3, cache, tables, kl, 1,
                                         scale=scale)
        splits = splits_of(q, cache, tables)
        compare(dec_kind, got, ref,
                f"decode {tag} B={B} kv_len {kvl} ({splits} splits) vs sdpa")
        del k, v, ref, got
        kv_bytes = B * kvl * 2 * kh * hd * item
        io_bytes = 2 * B * h * hd * 2 + tables.numel() * 4 + B * 4
        flops = 4 * B * h * hd * kvl
        shape = f"B={B} kv_len={kvl} {heads} bs={BS} bf16 q, {tag} cache"
        r = _row(dec_kind, ms, plain_ms, lib_ms, kv_bytes + io_bytes, flops,
                 PEAK_BF16_FLOPS, per_step[dec_kind], launches[dec_kind],
                 card, f"{shape}, {splits} splits",
                 library="torch.nn.functional.scaled_dot_product_attention "
                         f"on K/V gathered{up} beforehand{nocap}")
        r["splits"] = splits
        decode.append(r)

        k_new = torch.randn((B, kh * hd), generator=gen, device=DEV).bfloat16()
        v_new = torch.randn((B, kh * hd), generator=gen, device=DEV).bfloat16()
        wf = write_slots(tables, [kvl - 1] * B, [], cache.shape[1])
        ms = cuda_ms(lambda: pac.paged_attention_decode_write(
            q3, cache, tables, kl, turn(), k_new, v_new, wf, scale=scale,
            softcap=cap))
        plain_ms = cuda_ms(lambda: pac.paged_attention_decode_write_plain(
            q3, cache, tables, kl, 1, k_new, v_new, wf, scale=scale,
            softcap=cap), iters=5)
        flat = raw(cache.view(-1, kh * hd))
        nb = cache.shape[1]
        rows_k = ((nb + wf.long() // BS) * 2 * BS + wf.long() % BS)  # layer 1

        def pair():
            flat.index_copy_(0, rows_k, raw(to_cache_dtype(k_new, cache_dtype)))
            flat.index_copy_(0, rows_k + BS,
                             raw(to_cache_dtype(v_new, cache_dtype)))
            return pac.paged_attention_decode(q3, cache, tables, kl, 1,
                                              scale=scale, softcap=cap)

        pair_ms = cuda_ms(pair)
        # k_new/v_new read in bf16, their rows written in the cache's type.
        row_bytes = 2 * B * kh * hd * (2 + item)
        r = _row(dw_kind, ms, plain_ms, None, kv_bytes + io_bytes + row_bytes,
                 flops, PEAK_BF16_FLOPS, per_step[dw_kind], launches[dw_kind],
                 card, f"{shape}, one K/V row written per sequence, {splits} "
                       "splits",
                 library="none: no single PyTorch call computes it")
        r["splits"] = splits
        r["unfused_pair_ms"] = pair_ms
        r["unfused_pair"] = ("the rows cast to the cache's type and "
                             "index_copy_'d + paged_attention_decode")
        log(f"  unfused pair (cast + index_copy_ + paged_attention_decode): "
            f"{pair_ms:.4f} ms")
        decode_write.append(r)
        del q, q3, cache
        torch.cuda.empty_cache()
    rows.append(with_points(decode))
    rows.append(with_points(decode_write))

    # Prefill, one sequence: a fresh 512-token chunk, a 512-token chunk at
    # start 3584 (the last chunk of a 4096-token prompt) and a fresh
    # 2048-token chunk (the engine's default max_prefill_tokens); then the
    # verify step's shape, B=8 rows of T=5 ending at 4096.
    prefill = []
    for B, T, start in ((1, 512, 0), (1, 512, 3584), (1, 2048, 0),
                        (8, VERIFY_T, 4096 - VERIFY_T)):
        q, cache, tables, kl, st = case(gen, B=B, T=T,
                                        kv_lens=[start + T] * B,
                                        starts=[start] * B)
        ms = cuda_ms(lambda: pac.paged_attention_prefill(
            q, cache, tables, kl, st, 1, scale=scale, softcap=cap))
        plain_ms = cuda_ms(lambda: pac.paged_attention_prefill_plain(
            q, cache, tables, kl, st, 1, scale=scale, softcap=cap), iters=5)
        k, v = gathered_kv(cache, tables, 1, start + T, hd=hd,
                           dtype=torch.bfloat16)
        qs = q.transpose(1, 2).contiguous()  # [1, H, T, hd]
        yard = sdpa_chunk(qs, k, v, scale)
        lib_ms = cuda_ms(lambda: yard(qs, k, v))
        ref = yard(qs, k, v).transpose(1, 2)
        got = pac.paged_attention_prefill(q, cache, tables, kl, st, 1,
                                          scale=scale)
        splits = prefill_splits_of(q, cache, tables)
        compare(pre_kind, got, ref, f"prefill {tag} T={T} start={start} "
                f"({splits} splits) vs sdpa ({yard.__doc__})")
        pairs = B * (T * start + T * (T + 1) // 2)  # (query, live key) pairs
        nbytes = B * (2 * T * h * hd * 2 + (start + T) * 2 * kh * hd * item)
        r = _row(
            pre_kind, ms, plain_ms, lib_ms, nbytes, 4 * h * hd * pairs,
            PEAK_BF16_FLOPS, per_step[pre_kind], launches[pre_kind], card,
            f"B={B} T={T} start={start} {heads} bs={BS} bf16 q, {tag} "
            f"cache, {splits} splits" + (" (the verify step's shape)"
                                         if T == VERIFY_T else ""),
            library="torch.nn.functional.scaled_dot_product_attention on "
                    f"K/V gathered{up} beforehand, " + yard.__doc__ + nocap)
        r["splits"] = splits
        prefill.append(r)
    rows.append(with_points(prefill))
    return rows


def phase_times_simt(per_step: dict, launches: dict, card: str) -> list:
    """Rows of the CUDA-core kernels at the default engine's shapes
    (tiny-llama-debug: fp32, H=KH=8, hd=16), over an fp32 and an e4m3
    cache: decode and decode-write at B=8 x 1024, prefill of a fresh
    256-token chunk; decode and decode-write also where bytes dominate, at
    fp32 Llama-3-8B heads (H=32, KH=8, hd=128) over an fp32 cache, B=8 x
    4096. Bound: bytes, or fp32 operations off the tensor cores (67
    TFLOP/s). Beside each decode row, ``launch_floor_ms``: an empty kernel
    (``torch.cuda._sleep(0)``) queued the same way."""
    f32 = torch.float32
    scale = SCALE
    log(f"[phase 5] CUDA-core kernel times at tiny-llama-debug's heads and "
        f"fp32 Llama-3-8B heads ({card})")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(96)
    floor_ms = cuda_ms(lambda: torch.cuda._sleep(0))
    log(f"  an empty kernel queued the same way: {floor_ms:.4f} ms")
    rows = []
    for cdt in (f32, E4M3):
        tag = str(cdt)[6:]
        item = cdt.itemsize
        dec, dw = [], []
        points = ((8, 8, 16, 8, 1024),) + (((32, 8, HD, 8, 4096),)
                                           if cdt == f32 else ())
        for h, kh, hd, B, kvl in points:
            q, cache, tables, kl, _ = make_case(
                gen, B=B, T=1, kv_lens=[kvl] * B, dtype=f32, h=h, kh=kh,
                hd=hd, layers=4, cache_dtype=cdt)
            q3 = q[:, 0].contiguous()
            k, v = gathered_kv(cache, tables, 1, kvl, hd=hd, dtype=f32)
            qs = q3[:, :, None]
            state = {"layer": 0}

            def turn():
                state["layer"] = (state["layer"] + 1) % 4
                return state["layer"]

            splits = splits_of(q, cache, tables)
            kind = form("decode_simt", cdt)
            ms = cuda_ms(lambda: pac.paged_attention_decode(
                q3, cache, tables, kl, turn(), scale=scale))
            plain_ms = cuda_ms(lambda: pac.paged_attention_decode_plain(
                q3, cache, tables, kl, 1, scale=scale), iters=5)
            lib_ms = cuda_ms(lambda: sdpa(qs, k, v, False))
            compare(kind, pac.paged_attention_decode(q3, cache, tables, kl, 1,
                                                     scale=scale),
                    sdpa(qs, k, v, False)[:, :, 0],
                    f"decode fp32 q {tag} cache H={h} KH={kh} hd={hd} B={B} "
                    f"kv_len {kvl} ({splits} splits) vs sdpa")
            del k, v
            kv_bytes = B * kvl * 2 * kh * hd * item
            io_bytes = 2 * B * h * hd * 4 + tables.numel() * 4 + B * 4
            flops = 4 * B * h * hd * kvl
            shape = (f"B={B} kv_len={kvl} H={h} KH={kh} hd={hd} bs={BS} fp32 "
                     f"q, {tag} cache, {splits} splits")
            r = _row(kind, ms, plain_ms, lib_ms, kv_bytes + io_bytes, flops,
                     PEAK_FP32_FLOPS, per_step[kind], launches[kind], card,
                     shape,
                     library="torch.nn.functional.scaled_dot_product_"
                             "attention on K/V gathered (fp32) beforehand")
            r["splits"], r["launch_floor_ms"] = splits, floor_ms
            dec.append(r)
            k_new = torch.randn((B, kh * hd), generator=gen, device=DEV)
            v_new = torch.randn((B, kh * hd), generator=gen, device=DEV)
            wf = write_slots(tables, [kvl - 1] * B, [], cache.shape[1])
            kind = form("decode_write_simt", cdt)
            ms = cuda_ms(lambda: pac.paged_attention_decode_write(
                q3, cache, tables, kl, turn(), k_new, v_new, wf, scale=scale))
            plain_ms = cuda_ms(lambda: pac.paged_attention_decode_write_plain(
                q3, cache, tables, kl, 1, k_new, v_new, wf, scale=scale),
                iters=5)
            r = _row(kind, ms, plain_ms, None,
                     kv_bytes + io_bytes + 2 * B * kh * hd * (4 + item),
                     flops, PEAK_FP32_FLOPS, per_step[kind], launches[kind],
                     card, shape + ", one K/V row written per sequence",
                     library="none: no single PyTorch call computes it")
            r["splits"], r["launch_floor_ms"] = splits, floor_ms
            dw.append(r)
            del q, q3, cache
            torch.cuda.empty_cache()
        rows += [with_points(dec), with_points(dw)]
        # Prefill: a fresh 256-token chunk at tiny-llama-debug's heads; over
        # an fp32 cache also fp32 Llama-3-8B heads on a fresh 512-token chunk
        # and one at 3584, where operations dominate, and gemma2-9b's (no
        # softcap: SDPA takes none) on a fresh 512-token chunk
        # (tools/prefill_times.py --parts simt's points).
        pre = []
        points = ((8, 8, 16, 256, 0),) + ((
            (H, KH, HD, 512, 0), (H, KH, HD, 512, 3584),
            (GEMMA2_HEADS["h"], GEMMA2_HEADS["kh"], HD256, 512, 0))
            if cdt == f32 else ())
        for h, kh, hd, T, start in points:
            q, cache, tables, kl, st = make_case(
                gen, B=1, T=T, kv_lens=[start + T], starts=[start], dtype=f32,
                h=h, kh=kh, hd=hd, layers=2, cache_dtype=cdt)
            S = start + T
            k, v = gathered_kv(cache, tables, 1, S, hd=hd, dtype=f32)
            qs = q.transpose(1, 2).contiguous()
            lib = sdpa_chunk(qs, k, v, hd ** -0.5)
            kind = form("prefill_simt", cdt)
            splits = simt_prefill_splits_of(q, cache, tables)
            ms = cuda_ms(lambda: pac.paged_attention_prefill(
                q, cache, tables, kl, st, 1, scale=hd ** -0.5))
            plain_ms = cuda_ms(lambda: pac.paged_attention_prefill_plain(
                q, cache, tables, kl, st, 1, scale=hd ** -0.5), iters=5)
            lib_ms = cuda_ms(lambda: lib(qs, k, v))
            compare(kind, pac.paged_attention_prefill(
                q, cache, tables, kl, st, 1, scale=hd ** -0.5),
                lib(qs, k, v).transpose(1, 2),
                f"prefill fp32 q {tag} cache H={h} KH={kh} hd={hd} T={T} "
                f"at {start} ({splits} splits) vs sdpa")
            keys = T * start + T * (T + 1) // 2  # each row's keys, summed
            r = _row(
                kind, ms, plain_ms, lib_ms,
                2 * T * h * hd * 4 + S * 2 * kh * hd * item,
                4 * h * hd * keys, PEAK_FP32_FLOPS, per_step[kind],
                launches[kind], card,
                f"B=1 T={T} start={start} H={h} KH={kh} hd={hd} bs={BS} "
                f"fp32 q, {tag} cache, {splits} splits",
                library="torch.nn.functional.scaled_dot_product_attention "
                        f"on K/V gathered (fp32) beforehand, {lib.__doc__}")
            r["splits"] = splits
            pre.append(r)
            del q, cache, k, v, qs
            torch.cuda.empty_cache()
        rows.append(with_points(pre))

    # The int4 kernel's CUDA-core route at the tiny engine's w_gate (fp32
    # x, 8 decode rows, din 128 -> dout 256, one group of 128), and at
    # Llama-3-8B's w_gate in fp32 (not a served shape: it gives the kernel
    # a bound that means something), four weights in turn (117 MB, more
    # than the 50 MB L2).
    simt = []
    for N, din, dout, n_w, note in ((8, 128, 256, 1, ""),
                                    (8, 4096, 14336, 4,
                                     ", not a served shape")):
        weights = [int4_case(gen, N, din, dout, f32)[1:] for _ in range(n_w)]
        x = torch.randn((N, din), generator=gen, device=DEV)
        packed, scales = weights[0]
        check(i4.route(x, packed, scales) == "simt",
              "int4 fp32: not the simt route")
        dense = [i4.dequant_int4(p, s, f32) for p, s in weights]
        turn = {"i": 0}

        def nxt():
            turn["i"] = (turn["i"] + 1) % n_w
            return turn["i"]

        ms = cuda_ms(lambda: i4.int4_matmul(x, *weights[nxt()]))
        plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(x, *weights[nxt()]),
                           iters=5)
        lib_ms = cuda_ms(lambda: torch.matmul(x, dense[nxt()]))
        compare("int4_simt", i4.int4_matmul(x, packed, scales), x @ dense[0],
                f"int4 fp32 N={N} din={din} dout={dout} vs fp32 product of "
                "the dequantized weight")
        G = din // scales.shape[0]
        simt.append(_row(
            "int4_simt", ms, plain_ms, lib_ms,
            din * dout // 2 + (din // G) * dout * 4 + N * din * 4
            + N * dout * 4,
            2 * N * din * dout, PEAK_FP32_FLOPS, per_step["int4_simt"],
            launches["int4_simt"], card,
            f"N={N} din={din} dout={dout} G={G} fp32 x{note}",
            library="torch.matmul on the weight dequantized to fp32 "
                    "beforehand"))
        del weights, dense
    rows.append(with_points(simt))
    return rows


def sdpa_chunk(q, k, v, scale=SCALE):
    """The yardstick for a chunk of T queries at the end of S keys: SDPA,
    causal from the upper left when T == S, else lower-right causal (as a
    CausalBias, or as an explicit boolean mask where the bias does not
    combine with enable_gqa). Timing only, never on the path."""
    T, S = q.shape[2], k.shape[2]
    F = torch.nn.functional
    if T == S:
        def fresh(q, k, v):
            """causal"""
            return sdpa(q, k, v, True, scale)
        return fresh
    from torch.nn.attention.bias import causal_lower_right

    def bias(q, k, v):
        """lower-right causal bias"""
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_lower_right(T, S), scale=scale,
            enable_gqa=True)
    try:
        bias(q, k, v)
        return bias
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
        log(f"  SDPA's lower-right causal bias with enable_gqa: {e!r}")
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)

    def explicit(q, k, v):
        """lower-right causal boolean mask"""
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
    return explicit


def with_points(rows: list) -> dict:
    """The first row, with every row's shape and numbers under
    ``points``."""
    keys = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "splits", "unfused_pair_ms", "launch_floor_ms")
    main = dict(rows[0])
    main["points"] = [{k: r[k] for k in keys if k in r} for r in rows]
    return main


def phase_int4_times(per_step: dict, served: dict, card: str):
    """Rows of the int4 kernels: the decode route at the four projection
    shapes with 1, 8 and 16 rows (and the decode buckets up to its
    boundary), the wgmma route at 512 rows for the four shapes and at 2048
    rows for w_gate; and the crossover of the two bf16 routes at N in {1,
    8, 16, 32, 64} on the four shapes. Four weights of each shape in turn
    (117 MB of packed weights for w_gate, more than the 50 MB L2), as a
    step finds each layer's weights cold. The yardstick is torch.matmul on
    the weight dequantized to bf16 beforehand: it reads 4x the bytes.
    Returns (rows, crossover)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(98)
    edge = i4._DECODE_MAX_ROWS
    decode_rows = sorted({1, 8, 16} | {b for b in DECODE_BUCKETS if 16 <= b <= edge})
    # w_gate's shape first: its N = 8 row heads the decode route's points.
    shapes = ((4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024))
    wgmma_cases = {(4096, 14336): (512, 2048)}
    rows = {"int4": [], "int4_wgmma": []}
    crossover = []
    for din, dout in shapes:
        weights = [int4_case(gen, 1, din, dout)[1:] for _ in range(4)]
        dense = [i4.dequant_int4(p, s, torch.bfloat16) for p, s in weights]
        G = din // weights[0][1].shape[0]
        turn = {"i": 0}

        def nxt():
            turn["i"] = (turn["i"] + 1) % 4
            return turn["i"]

        cases = [("int4", N) for N in decode_rows]
        cases += [("int4_wgmma", N) for N in wgmma_cases.get((din, dout), (512,))]
        for kind, N in cases:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            check(i4.route(x, *weights[0]) == ROUTE_OF[kind],
                  f"int4 N={N}: not the {ROUTE_OF[kind]} route")
            ms = cuda_ms(lambda: i4.int4_matmul(x, *weights[nxt()]))
            plain_ms = cuda_ms(lambda: i4.int4_matmul_plain(x, *weights[nxt()]),
                               iters=5)
            lib_ms = cuda_ms(lambda: torch.matmul(x, dense[nxt()]))
            got = i4.int4_matmul(x, *weights[0])
            compare(kind, got, torch.matmul(x.float(), dense[0].float()),
                    f"int4 bf16 N={N} din={din} dout={dout} vs fp32 product "
                    "of the bf16-dequantized weight", rows=True)
            nbytes = (din * dout // 2 + (din // G) * dout * 4 + N * din * 2
                      + N * dout * 4)
            rows[kind].append(_row(
                kind, ms, plain_ms, lib_ms, nbytes, 2 * N * din * dout,
                PEAK_BF16_FLOPS, per_step[ROUTE_OF[kind]],
                served["int4_" + ROUTE_OF[kind]], card,
                f"N={N} din={din} dout={dout} G={G} bf16 x",
                library="torch.matmul on the weight dequantized to bf16 "
                        "beforehand (reads 4x the bytes)"))
        # Both bf16 routes at every decode bucket: where the boundary goes.
        for N in DECODE_BUCKETS:
            x = torch.randn((N, din), generator=gen, device=DEV).bfloat16()
            point = {"shape": f"N={N} din={din} dout={dout}"}
            for name in ("decode", "wgmma"):
                point[f"{name}_ms"] = cuda_ms(
                    lambda: i4._launch(name, x, *weights[nxt()]))
            crossover.append(point)
            log(f"  crossover {point['shape']}: decode route "
                f"{point['decode_ms']:.4f} ms, wgmma route "
                f"{point['wgmma_ms']:.4f} ms")
        del weights, dense
    main = [r for r in rows["int4"] if r["shape"].startswith("N=8 ")]
    rows["int4"].remove(main[0])
    return ([with_points(main[:1] + rows["int4"]), with_points(
        sorted(rows["int4_wgmma"], key=lambda r: "N=2048" in r["shape"]))],
            crossover)


def _row(kind, ms, plain_ms, lib_ms, nbytes, flops, peak, per_step, launches,
         card, shape,
         library="torch.nn.functional.scaled_dot_product_attention"):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    row = dict(KERNELS[kind])
    row.update(
        launches=launches, launches_per_step=per_step,
        max_abs_err=max_err[kind], ms=ms, kernel_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms, library=library, shape=shape, card=card,
    )
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"  {row['name']} [{shape}]: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"library {lib}, bound {bound_ms:.4f} ms by {row['bound_by']}; "
        f"{bound_ms / ms:.1%} of bound); {per_step} launches per step, "
        f"{launches} while serving")
    return row


# A hang anywhere prints every thread's stack and fails the run before
# the 1200 s the run is given.
WATCHDOG_S = 1140


def lora_only(card: str) -> None:
    """``python3 chip_smoke.py lora``: phase 4m alone, with what it reads
    of earlier phases (3s's gap tolerance, 3x's steps without LoRA)."""
    model, params = build_model()
    gap_tol = phase_verify_logits(model, params)
    paths = write_adapters(model.cfg)
    out = {"model_4m_a": phase_lora_model(model, params, paths, "4m(a)"),
           "steps_4m_e": phase_lora_step_costs(
               params, card, paths, phase_step_graphs(params)[:2])}
    out["serving_4m_cd"] = phase_lora_serving(params, card, paths, gap_tol)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    q_params, _ = phase_int4_model(model)
    out["model_4m_b"] = phase_lora_model(model, q_params, paths, "4m(b)")
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    print(json.dumps({"lora_4m": out}, default=str), flush=True)


def encode_only(card: str) -> None:
    """``python3 chip_smoke.py encode``: phase 4n alone, (a) to (e), with
    the int4 tree drawn on the card in place of phase 3b."""
    model, params = build_model()
    out = {"model_4n_a": {"bf16": phase_encode_model(model, params, card)}}
    first, cache_dir = start_compile_cache()
    out["serving_4n_bd"] = phase_encode_serving(params, card)
    out["cache_4n_e"] = phase_compile_cache(first, cache_dir, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["PST_FUSED_KV_WRITE"] = "1"
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    q_params = model.init_params(gen, DEV, quantization="int4")
    out["model_4n_a"]["int4"] = phase_encode_model(model, q_params, card,
                                                   quantized=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["serving_4n_c"] = phase_encode_int4_serving(q_params, card)
    print(json.dumps({"encode_4n": out}, default=str), flush=True)


def main() -> None:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    os.environ.pop("PST_FUSED_KV_WRITE", None)  # bf16 phases: unfused path
    if sys.argv[1:] not in ([], ["drift"], ["rounds"], ["engagement"],
                            ["lora"], ["encode"], ["moe"], ["tp"], ["pp"]):
        sys.exit("usage: python3 chip_smoke.py "
                 "[drift|rounds|engagement|lora|encode|moe|tp|pp]")
    card = phase_toolchain()
    if sys.argv[1:] == ["drift"]:
        drift()
        return
    if sys.argv[1:] == ["rounds"]:
        rounds_sweep(build_model()[1], card)
        return
    if sys.argv[1:] == ["engagement"]:
        engagement_sweep(build_model()[1], card)
        return
    if sys.argv[1:] == ["lora"]:
        lora_only(card)
        return
    if sys.argv[1:] == ["encode"]:
        encode_only(card)
        return
    if sys.argv[1:] == ["moe"]:
        print(json.dumps({"moe_4o": phase_moe(card)}, default=str),
              flush=True)
        return
    if sys.argv[1:] == ["tp"]:
        tp_only(card)
        return
    if sys.argv[1:] == ["pp"]:
        pp_only(card)
        return
    log("[phase 2] kernels vs plain versions")
    for cache_dtype in (torch.bfloat16, E4M3):
        phase_kernels(cache_dtype)
        phase_decode_write_kernels(cache_dtype)
        phase_hd256_kernels(cache_dtype)
    phase_hd256_splits()
    phase_e4m3_all_codes()
    phase_simt_geometries()
    phase_simt_splits()
    phase_simt_prefill_splits()
    verify_splits = phase_verify_kernels()
    phase_device_draw()
    phase_int4_kernels()
    phase_capture_kernels()
    model, params = build_model()
    per_step = phase_model(model, params)
    gap_tol = phase_verify_logits(model, params)
    fp8_per_step, fp8_path = phase_fp8_model(model, params)
    phase_no_host_sync(model, params)
    graph_steps = phase_step_graphs(params)
    graph_steps.append(phase_pipelined_bursts(params))
    swaps = [phase_swap(params), phase_swap(params, "float8_e4m3fn")]
    steps = phase_step_times(model, params)
    steps.update(phase_step_times(model, params, tag="e4m3_", impls=("cuda",),
                                  kv_dtype=E4M3))
    torch.cuda.empty_cache()  # the engine sizes its KV cache from free memory
    served = phase_serving(params, "4", warmup="lazy")
    gc.collect()  # the first engine's KV cache, before the next sizes its own
    torch.cuda.empty_cache()
    admin = phase_admin(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    pipelined_serving = phase_pipelined_serving(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    spec_serving = {"bf16": phase_spec_serving(params, card, gap_tol, "4s")}
    tenancy = phase_tenancy_serving(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    recompute = phase_recompute_serving(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    traced = phase_traced_serving(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    tiers = {"host": phase_tier_serving(params, card)}
    gc.collect()
    torch.cuda.empty_cache()
    tiers["bucket"] = phase_bucket_rounding(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    # 4h's first wave over a host tier: a parked chain's evicted pages
    # fault back up, so no resume recomputes.
    tiers["wave_4h"] = phase_tenancy_serving(
        params, card, extra_argv=("--cpu-offload-blocks", "1024"),
        first_wave_only=True)
    sw, base = tiers["wave_4h"]["swaps"], tenancy["swaps"]
    check(sw["recomputed"] == 0 and sw["in"] == sw["out"],
          f"4j 4h wave over a host tier: swaps {sw}")
    log(f"  4h's wave: swapped out {sw['out']:.0f}, in {sw['in']:.0f}, "
        f"recomputed {sw['recomputed']:.0f}, host-hit pages "
        f"{tiers['wave_4h']['host_hit_blocks']:.0f}; without the tier in "
        f"this run out {base['out']:.0f}, in {base['in']:.0f}, recomputed "
        f"{base['recomputed']:.0f} (PR 15: out 1, recomputed 1)")
    gc.collect()
    torch.cuda.empty_cache()
    tiers["disagg"] = phase_disagg_serving(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    engagement = phase_overlap_engagement(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    chart = phase_chart_serving(params, card)
    gc.collect()
    torch.cuda.empty_cache()
    lora_paths = write_adapters(model.cfg)
    lora = {"model_4m_a": phase_lora_model(model, params, lora_paths,
                                           "4m(a)"),
            "steps_4m_e": phase_lora_step_costs(params, card, lora_paths,
                                                graph_steps[:2])}
    lora["serving_4m_cd"] = phase_lora_serving(params, card, lora_paths,
                                               gap_tol)
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 4n: the encode path and the cross-encoder; 4n(e)'s first
    # server builds its kernel library beside 4n(b) and (d).
    encode = {"model_4n_a": {"bf16": phase_encode_model(model, params,
                                                        card)}}
    cache_first, cache_dir = start_compile_cache()
    encode["serving_4n_bd"] = phase_encode_serving(params, card)
    encode["cache_4n_e"] = phase_compile_cache(cache_first, cache_dir, card)
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["PST_FUSED_KV_WRITE"] = "1"
    fp8_served = phase_serving(
        params, "4c", kv_cache_dtype="float8_e4m3fn",
        used=("decode_write", "decode_write_split_e4m3", "prefill",
              "prefill_wgmma_e4m3"))
    os.environ.pop("PST_FUSED_KV_WRITE")
    log(f"  KV pages beside the bf16 weights: {fp8_served['pages']} e4m3 "
        f"against {served['pages']} bf16")
    gc.collect()
    torch.cuda.empty_cache()
    tp = phase_tp(card, model, params)  # tensor parallelism, on one card
    pp = phase_pp(card, model, params)  # pipeline and data, on one card
    del params
    gc.collect()  # the engine's KV cache and the bf16 tree, cycles included
    torch.cuda.empty_cache()
    log(f"[phase 3b] bf16 tree and engines freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")

    q_params, q_per_step = phase_int4_model(model)  # sets PST_FUSED_KV_WRITE=1
    lora["model_4m_b"] = phase_lora_model(model, q_params, lora_paths, "4m(b)")
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    steps.update(phase_step_times(model, q_params, tag="int4_", impls=("cuda",)))
    graph_steps += phase_step_graphs(q_params, quantization="int4")
    graph_steps.append(phase_pipelined_bursts(q_params, quantization="int4"))
    per_step["decode_write_step"] = q_per_step["decode_write"]
    torch.cuda.empty_cache()
    q_served = phase_serving(
        q_params, "4b", quantization="int4",
        used=("decode_write", "decode_write_split", "int4", "prefill",
              "prefill_wgmma", "int4_wgmma", "int4_decode", "int4_sum"))
    # Split-sum passes follow only wgmma launches.
    check(q_served["int4_sum"] <= q_served["int4_wgmma"],
          f"int4 serving: {q_served['int4_sum']} sum passes for "
          f"{q_served['int4_wgmma']} wgmma launches")
    gc.collect()
    torch.cuda.empty_cache()
    encode["model_4n_a"]["int4"] = phase_encode_model(model, q_params, card,
                                                      quantized=True)
    gc.collect()
    torch.cuda.empty_cache()
    encode["serving_4n_c"] = phase_encode_int4_serving(q_params, card)
    gc.collect()
    torch.cuda.empty_cache()
    spec_serving["int4"] = phase_spec_serving(q_params, card, gap_tol, "4t",
                                              quantization="int4")
    del q_params
    gc.collect()
    torch.cuda.empty_cache()
    os.environ.pop("PST_FUSED_KV_WRITE", None)
    phase_int8_model(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(card)  # every Llama-3-8B tree and cache freed
    checkpoint = phase_checkpoint(card)
    phase_qwen2()
    tiny = phase_tiny_engines()
    tiny_warm = phase_tiny_warmup()

    # The Gemma family: gemma2-9b at full depth, its server with the fused
    # write, its int4 form; gemma-7b and qwen3-8b cut in depth.
    g_model, g_params, g_per_step, g_path = phase_gemma2()
    torch.cuda.empty_cache()
    os.environ["PST_FUSED_KV_WRITE"] = "1"
    g_served = phase_serving(
        g_params, "4e", model=GEMMA,
        used=("decode_write", "decode_write_split_hd256", "prefill",
              "prefill_wgmma_hd256"))
    os.environ.pop("PST_FUSED_KV_WRITE")
    g_layers = g_model.cfg.num_layers
    del g_model, g_params
    gc.collect()
    torch.cuda.empty_cache()
    phase_gemma2_int4()
    phase_gemma_qwen3()

    # Each row's launches a step (from the model phases) and on its path:
    # the bf16, int4 and fp8 servers, the fp8 model's unfused steps and the
    # tiny engines.
    row_steps = {"decode": per_step["decode_step"],
                 "prefill": per_step["prefill_chunk"],
                 "decode_write": per_step["decode_write_step"],
                 **fp8_per_step}
    row_launches = {"decode": served["decode_split"],
                    "prefill": served["prefill_wgmma"],
                    "decode_write": q_served["decode_write_split"],
                    "decode_e4m3": fp8_path["decode_e4m3"],
                    "prefill_e4m3": fp8_served["prefill_wgmma_e4m3"],
                    "decode_write_e4m3": fp8_served["decode_write_split_e4m3"]}
    rows = phase_times(row_steps, row_launches, card)
    rows += phase_times(row_steps, row_launches, card, E4M3)
    # head_dim 256 at gemma2-9b's heads: launches a step from phase 3f (one
    # a layer), on a path from the gemma2-9b server (bf16 cache, fused
    # write: decode-write and prefill) and phase 3f's steps (the rest).
    g_steps = {**g_per_step, "decode_write_hd256": g_layers}
    g_launches = {**g_path,
                  "decode_write_hd256": g_served["decode_write_split_hd256"],
                  "prefill_hd256": g_served["prefill_wgmma_hd256"]}
    for cdt in (torch.bfloat16, E4M3):
        rows += phase_times(g_steps, g_launches, card, cdt, GEMMA2_GEO)
    tiny_layers = get_model_config(EngineConfig().model).num_layers
    tiny_steps = {k: tiny_layers for k in tiny}
    tiny_steps["int4_simt"] = 7 * tiny_layers  # the seven projections
    rows += phase_times_simt(tiny_steps, tiny, card)
    int4_rows, crossover = phase_int4_times(q_per_step, q_served, card)
    rows += int4_rows
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"graphs": {
        "card": card, "steps": graph_steps, "tiny_full_warmup": tiny_warm,
        "serving": {label: {k: d[k] for k in ("graphs", "graph_pool_bytes",
                                              "warmup")}
                    for label, d in (("4", served), ("4b", q_served),
                                     ("4c", fp8_served), ("4e", g_served))},
        "sleep_4f": admin, "pipelined_serving_4g": pipelined_serving,
        "checkpoint_3z": checkpoint, "swap_3w": swaps,
        "tenancy_serving_4h": tenancy, "recompute_serving_4h": recompute,
        "traced_serving_4i": traced, "tiers_4j": tiers,
        "verify_splits_2s": verify_splits, "verify_gap_tol_3s": gap_tol,
        "spec_serving_4s": spec_serving, "engagement_4k": engagement,
        "chart_serving_4l": chart, "lora_4m": lora, "encode_4n": encode,
        "moe_4o": moe, "tp_4p": tp, "pp_4q": pp,
    }}, default=str), flush=True)
    print(json.dumps({"kernels": rows, "steps": steps, "int4_crossover": crossover}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
